#!/usr/bin/env python3
"""Where the time goes in chip_smoke.py's structured-matrix cells.

    python3 tools/profile_structured.py

Runs phases S1a-S6 of ``chip_smoke.py`` as its ``main()`` runs them (each
cell's warm-up, two timed fits, KKT check and dense-equivalent fit), and
after each cell one more fit under ``torch.profiler``
(``chip_smoke.profile_fit``): its wall, the kernels' busy time, the idle
share and the four busiest kernels.  S1b runs on phase 9's GWAS panel,
made here by ``snp_problem``.  Needs one CUDA device; exits 1 without
one.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: profile_structured.py needs one GPU",
              file=sys.stderr)
        return 1
    import adelie_tpu_torch as ad
    from adelie_tpu_torch import _build
    from adelie_tpu_torch.matrix import snp_kernels as sk
    from adelie_tpu_torch.solver import pin_group_kernels as pg
    from adelie_tpu_torch.solver import pin_kernels as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    _build.load()
    cell = cs.struct_cell

    def profiled_cell(ad_, card_, what, Xm, y, counters, groups=None, **kw):
        out = cell(ad_, card_, what, Xm, y, counters, groups=groups, **kw)
        prof = cs.profile_fit(ad_, Xm, y, groups=groups, **kw)
        cs.phase(what, f"{cs.profile_line(prof)} | {card_}")
        return out

    cs.struct_cell = profiled_cell
    pins = (tk.launches, pg.launches)
    X, y = cs.headline_problem(40000, 2000, 60, seed=0)
    cs.standardize_dense_phase(ad, card, pins, y)
    cs.wrappers_phase(ad, card, pins, X, y)
    cs.user_matrix_phase(ad, card, pins, X, y)
    del X
    for run in (cs.sparse_phase, cs.glinternet_phase, cs.relu_phase):
        torch.cuda.empty_cache()
        run(ad, card, pins)
    io9, y9 = cs.snp_problem(cs.GWAS_P, cs.GWAS_N, 40, seed=7,
                             lut=cs.code_lut(False))
    Xm9 = ad.matrix.snp_unphased(io9, dtype=np.float32, device="cuda")
    cs.standardize_snp_phase(ad, card, (tk.launches, sk.launches,
                                        pg.launches), Xm9, y9)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
