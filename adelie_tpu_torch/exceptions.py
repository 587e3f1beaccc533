"""Exception taxonomy (reference: adelie/src/include/adelie_core/util/exceptions.hpp:8-49)."""


class AdelieError(Exception):
    """Base error for adelie_tpu_torch (reference: adelie_core_error)."""


class SolverError(AdelieError):
    """Generic solver failure (reference: adelie_core_solver_error)."""


class MaxCDsError(SolverError):
    """Maximum coordinate descents reached (reference: max_cds_error)."""

    def __init__(self, lmda_idx: int = -1):
        super().__init__(
            f"Coordinate descent max iterations reached at lambda index {lmda_idx}! "
            "Try increasing max_iters."
        )
        self.lmda_idx = lmda_idx


class MaxScreenSetError(SolverError):
    """Max screen set size reached (reference: max_screen_set_error)."""

    def __init__(self):
        super().__init__(
            "Maximum screen set size reached! Try increasing max_screen_size."
        )

