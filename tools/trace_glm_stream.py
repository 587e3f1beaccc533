#!/usr/bin/env python3
"""Trace the streamed case-control GWAS at the north star, a chunk at a time.

    python3 tools/trace_glm_stream.py [DEADLINE_S]

Builds ``chip_smoke.py``'s north-star panel (1,000,000 SNPs x 100,000
samples, 25 GB packed in host memory) and G6's binary response, then fits
the logistic path of 50 lambdas to 5e-2 with the solver's default chunks
(no ``exit_cond``), printing a line per chunk: its lambdas and where they
start (a share of lambda_max), its seconds and those of its Gram
refreshes (``ScreenCache.rebuild_weighted``, timed between two device
synchronizations), its IRLS iterations, the screen's size and capacity
after it, the lambdas solved so far and the peak device memory.  The fit
is stopped after the first chunk that ends DEADLINE_S (default 600)
seconds after it began; a chunk that does not end is cut only by the
command's own time limit, so its line never prints.  Run from the repo
root; needs one CUDA device and about 30 GB of host memory.
"""

import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
import adelie_tpu_torch as ad  # noqa: E402
from adelie_tpu_torch import _build  # noqa: E402
from adelie_tpu_torch.solver import state_core, streamed  # noqa: E402


def main():
    deadline = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    _build.load()
    print(f"build {time.perf_counter() - t_start:.1f} s | {cs.nvidia_smi()}",
          flush=True)

    gram = {"s": 0.0}
    rebuild = state_core.ScreenCache.rebuild_weighted

    def timed_rebuild(self, weights, intercept):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = rebuild(self, weights, intercept)
        torch.cuda.synchronize()
        gram["s"] += time.perf_counter() - t
        return out

    fit_t0 = [0.0]
    run_chunk = streamed.StreamedGlmDriver._run_chunk

    def traced_chunk(self, lmdas, record):
        s = self.s
        t, g0 = time.perf_counter(), gram["s"]
        n_it = len(s.benchmark["irls_iters"])
        out = run_chunk(self, lmdas, record)
        torch.cuda.synchronize()
        its = s.benchmark["irls_iters"][n_it:]
        lm0 = s.lmda_max or float("nan")
        print(f"chunk at {time.perf_counter() - fit_t0[0]:.1f} s: "
              f"{len(lmdas)} lambdas from {lmdas[0] / lm0:.4f} lmda_max, "
              f"{time.perf_counter() - t:.2f} s (Gram refreshes "
              f"{gram['s'] - g0:.2f} s), IRLS iterations {sum(its)} in "
              f"{len(its)} fits, screen {len(s.screen_set)} (S_cap "
              f"{s._cache.S_cap}), lambdas solved {len(s.lmdas)}, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"(accepted, early exit, KKT clean) {out}", flush=True)
        if time.perf_counter() - fit_t0[0] > deadline:
            raise TimeoutError(f"past the {deadline:.0f} s deadline")
        return out

    state_core.ScreenCache.rebuild_weighted = timed_rebuild
    streamed.StreamedGlmDriver._run_chunk = traced_chunk

    t0 = time.perf_counter()
    io, _, _ = cs.north_star_panel(cs.NS_P, cs.NS_N)
    Xm = ad.matrix.snp_unphased(io, streaming=True, dtype=np.float32,
                                device="cuda")
    torch.cuda.synchronize()
    print(f"panel {time.perf_counter() - t0:.1f} s", flush=True)
    y = cs.case_control(cs.standardized(io.signal), seed=26)
    torch.cuda.reset_peak_memory_stats()
    fit_t0[0] = time.perf_counter()
    try:
        st = ad.grpnet(Xm, ad.glm.binomial(y), lmda_path_size=50,
                       min_ratio=5e-2, device="cuda")
        print(f"done: {len(st.lmdas)} lambdas, error {st.error!r}, wall "
              f"{time.perf_counter() - fit_t0[0]:.1f} s", flush=True)
    except TimeoutError as exc:
        print(f"stopped: {exc}", flush=True)
    print(f"Gram refreshes {gram['s']:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
