"""Shared styling for the diagnostic plots.

Design notes (original to this package; the reference's matplotlib glue
is not reused):

* One fixed, colorblind-safe categorical order (Okabe-Ito).  Hues are
  assigned in this order and never cycled past it — when more series
  exist than hues, the bulk is drawn in a single muted ink and only a
  top-k subset is highlighted and direct-labeled.
* Recessive axes: top/right spines dropped, light dotted grid behind the
  data, thin marks.
* The x-axis shows lambda itself on a reversed log scale (reading left
  to right = shrinking lambda = growing model), rather than the
  -log(lambda) transform: the tick labels stay in the units the user
  passed in.
"""

import numpy as np

# Okabe-Ito (fixed assignment order, CVD-safe).
PALETTE = (
    "#0072B2",  # blue
    "#E69F00",  # orange
    "#009E73",  # green
    "#CC79A7",  # pink
    "#56B4E9",  # sky
    "#D55E00",  # vermillion
    "#8C8C00",  # olive (darkened yellow for contrast on white)
    "#555555",  # charcoal
)
# series hues for multi-line plots: PALETTE minus the reserved alert hue,
# so an ordinary series can never wear the failure color
SERIES = tuple(c for c in PALETTE if c != "#D55E00")
INK = "#2b2b2b"        # primary text / single-series mark
MUTED = "#b0b6bd"      # bulk series, de-emphasized
GRID = "#d9dde2"
ALERT = "#D55E00"      # reserved status hue: failures only


def styled_axes(title, xlabel, ylabel, figsize=(7.5, 4.5)):
    """A figure + axes with the package's recessive base style."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize, layout="constrained")
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=INK, labelsize=9)
    ax.grid(True, linestyle=":", linewidth=0.6, color=GRID, zorder=0)
    ax.set_axisbelow(True)
    ax.set_title(title, color=INK, fontsize=11, loc="left")
    ax.set_xlabel(xlabel, color=INK, fontsize=10)
    ax.set_ylabel(ylabel, color=INK, fontsize=10)
    return fig, ax


def lambda_axis(ax, lmdas):
    """Reversed log-scale lambda axis (model grows left to right)."""
    lmdas = np.asarray(lmdas, dtype=float)
    if lmdas.size and np.all(lmdas > 0):
        ax.set_xscale("log")
    if lmdas.size >= 2 and lmdas[0] > lmdas[-1]:
        ax.invert_xaxis()
    return lmdas


def legend(ax):
    ax.legend(frameon=False, fontsize=9, labelcolor=INK)
