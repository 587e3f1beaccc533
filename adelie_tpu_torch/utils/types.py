"""String options validated at the API boundary (reference
adelie_core/util/types.hpp), so a typo'd ``screen_rule`` fails at
``grpnet(...)`` with the list of valid values.  Copied from
``adelie_tpu/utils/types.py``, keeping the options the port uses."""

from __future__ import annotations

__all__ = ["Option", "bcd_solver", "binomial_link", "css_loss",
           "css_method", "matrix_method", "newton_method", "read_mode",
           "screen_rule", "tie_method"]


class Option:
    """A named, closed set of string options.

    Calling the option validates (and canonicalizes) a value::

        rule = types.screen_rule(user_value)     # -> canonical str
        types.screen_rule("pivto")               # -> ValueError listing options

    ``aliases`` maps accepted spellings onto canonical values (e.g. the
    ``auto`` read mode resolving to ``mmap``).
    """

    def __init__(self, name, values, aliases=None):
        self.name = str(name)
        self.values = tuple(values)
        self._aliases = dict(aliases or {})
        self._set = frozenset(self.values) | frozenset(self._aliases)

    def __call__(self, value, *, param=None, canonical=True):
        param = param or self.name
        if not isinstance(value, str) or value not in self._set:
            raise ValueError(
                f"{param} must be one of {sorted(self._set)}, got {value!r}"
            )
        if canonical:
            return self._aliases.get(value, value)
        return value

    def __contains__(self, value):
        return value in self._set

    def __iter__(self):
        return iter(self.values)

    def __repr__(self):
        return f"Option({self.name!r}, {list(self.values)!r})"


# --- solver knobs (reference util/types.hpp screen_rule_type) ---
screen_rule = Option("screen_rule", ("strong", "pivot"))

# --- cox ties (reference util/types.hpp tie_method_type) ---
tie_method = Option("tie_method", ("efron", "breslow"))

# --- column subset selection (reference solver.py:1274 css_cov) ---
css_method = Option("method", ("greedy", "swapping"))
css_loss = Option("loss", ("least_squares", "subset_factor", "min_det"))

# --- binomial links (reference glm.py:83-199) ---
binomial_link = Option("link", ("logit", "probit"))

# --- block-update solvers (reference util/types.hpp, bcd.py:40-49) ---
newton_method = Option(
    "method", ("newton", "newton_abs", "newton_brent", "brent")
)
bcd_solver = Option(
    "solver",
    ("newton", "newton_abs", "newton_brent", "brent",
     "ista", "fista", "fista_adares"),
)

# --- SNP IO read mode (reference io/io_snp_base.hpp read_mode_type) ---
read_mode = Option("read_mode", ("file", "mmap"), aliases={"auto": "mmap"})

# --- matrix factory dispatch (reference matrix.py factories) ---
matrix_method = Option("method", ("naive", "cov", "constraint"))
