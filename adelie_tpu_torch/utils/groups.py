"""Per-group sums in a fixed order.

``group_sum`` serves the group norms of the solver's gradients and the
tie-group sums of the Cox loss; it holds no solver logic.
"""

import numpy as np
import torch


class GroupIndex:
    """The column indices of the groups, bucketed by size for ``group_sum``.

    Each group's size is rounded up to a power of 2, Q_b; the groups of one
    bucket form one (G_b, Q_b) int64 block of their columns, padded with
    ``p`` (a zero entry that ``group_sum`` appends).  ``inverse`` takes the
    buckets' concatenated sums back to group order.  Every Q_b is below
    twice its groups' sizes, so the blocks hold fewer than 2p entries
    (``size``).  ``singletons``: every group is one column, and group g is
    column g."""

    def __init__(self, groups, group_sizes, p, device):
        groups = np.asarray(groups, np.int64)
        group_sizes = np.asarray(group_sizes, np.int64)
        self.singletons = bool(np.all(group_sizes == 1))
        self.blocks = []
        self.inverse = None
        self.size = 0
        if self.singletons:
            return
        # each size rounded up to a power of 2 (log2 is exact on powers)
        Qg = np.left_shift(1, np.ceil(np.log2(np.maximum(group_sizes, 1)))
                           .astype(np.int64))
        order = []
        for Q in np.unique(Qg):
            gids = np.flatnonzero(Qg == Q)
            lane = np.arange(Q)
            cols = np.where(lane[None, :] < group_sizes[gids, None],
                            groups[gids, None] + lane[None, :], p)
            self.blocks.append(torch.as_tensor(cols, device=device))
            self.size += cols.size
            order.append(gids)
        order = np.concatenate(order)
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        self.inverse = torch.as_tensor(inverse, device=device)

    def to(self, device):
        out = GroupIndex.__new__(GroupIndex)
        out.singletons, out.size = self.singletons, self.size
        out.blocks = [b.to(device) for b in self.blocks]
        out.inverse = None if self.inverse is None else self.inverse.to(device)
        return out


def group_sum(x, index):
    """Per-group sums of ``x`` (p,) or (p, C) over the groups of ``index``
    (a ``GroupIndex``), in a fixed order: each bucket's (G_b, Q_b) gather,
    zero-padded, is folded in halves, ``x[:, :Q/2] + x[:, Q/2:]`` and so
    on, and the sums go back to group order by a permutation.  So the sums
    do not depend on the device or the run (``index_add_`` on the card
    adds by atomics, in no fixed order), and a group of one is its entry.
    Padding adds exact zeros, so a bucket's fold gives the bits of a fold
    padded to any larger power of 2 (the sums of squares it serves are
    never -0)."""
    if index.singletons:
        return x
    pad = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([x, pad])
    sums = []
    for cols in index.blocks:
        g = xp[cols]
        h = g.shape[1] // 2
        while h:
            g = g[:, :h] + g[:, h:2 * h]
            h //= 2
        sums.append(g[:, 0])
    return torch.cat(sums)[index.inverse]
