#!/usr/bin/env python3
"""How far apart the in-device and streamed drivers leave a multigaussian
path, in both packages, on the CPU in float64.

    python3 tools/multi_driver_gap.py [N P LAMBDAS TILE [TOL]]

(defaults 600 200 20 64 1e-7).  The panel is ``data.snp_unphased(N, P,
K=4, glm="multigaussian", missing_ratio=0.1, seed=11)`` of the JAX
package, written to a ``.snpdat`` file in a temporary directory.  Each
package fits it on the panel in memory and streamed in tiles of TILE
SNPs with the speculative union off (which keeps the in-device screens),
``lmda_path_size=LAMBDAS`` and ``tol=TOL``.  Printed: each fit's wall,
and the largest gaps in lambda (relative), beta and the intercepts
between the two drivers of each package and between the packages'
drivers of one kind.  The flattened problem's intercepts are coordinates
beside the panel's uncentered columns, so coordinate descent converges
slowly there and its stopping rule leaves two drivers' paths apart by
what the rule lets through; the packages agree with each other to
rounding.  It imports both packages: run it from the repo root with the
JAX package's CPU settings (``JAX_PLATFORMS=cpu``).
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def gaps(a, b):
    return (f"lambda {np.max(np.abs(np.asarray(a.lmdas) / np.asarray(b.lmdas) - 1)):.1e}, "
            f"beta {np.abs(a.betas.toarray() - b.betas.toarray()).max():.3e}, "
            f"intercepts {np.abs(np.asarray(a.intercepts) - np.asarray(b.intercepts)).max():.3e} "
            f"({len(a.lmdas)} and {len(b.lmdas)} lambdas)")


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import adelie_tpu as ja
    import adelie_tpu_torch as ta
    from adelie_tpu.configs import set_configs as jset
    from adelie_tpu_torch.configs import set_configs as tset

    n, p, L, tile = (int(a) for a in (argv[1:5] or (600, 200, 20, 64)))
    tol = float(argv[5]) if len(argv) > 5 else 1e-7
    d = ja.data.snp_unphased(n, p, K=4, glm="multigaussian",
                             missing_ratio=0.1, seed=11)
    with tempfile.TemporaryDirectory() as tmp:
        f = os.path.join(tmp, "panel.snpdat")
        ja.io.snp_unphased(f).write(d["X"])
        jio, tio = ja.io.snp_unphased(f).read(), ta.io.snp_unphased(f).read()
    y = np.asarray(d["glm"].y)
    kw = dict(lmda_path_size=L, tol=tol)
    fits, walls = {}, {}

    def run(key, fn):
        t0 = time.perf_counter()
        fits[key] = fn()
        walls[key] = time.perf_counter() - t0
        if fits[key].error:
            raise SystemExit(f"{key}: {fits[key].error}")

    run("jax in-device", lambda: ja.grpnet(
        ja.matrix.snp_unphased(jio, dtype=np.float64),
        ja.glm.multigaussian(y), **kw))
    run("port in-device", lambda: ta.grpnet(
        ta.matrix.snp_unphased(tio, device="cpu"), ta.glm.multigaussian(y),
        device="cpu", **kw))
    jset("stream_speculative_union", False)
    tset("stream_speculative_union", False)
    run("jax streamed", lambda: ja.grpnet(
        ja.matrix.snp_unphased(jio, streaming=True, tile_snps=tile,
                               dtype=np.float64),
        ja.glm.multigaussian(y), **kw))
    run("port streamed", lambda: ta.grpnet(
        ta.matrix.snp_unphased(tio, streaming=True, tile_snps=tile,
                               dtype=np.float64, device="cpu"),
        ta.glm.multigaussian(y), device="cpu", **kw))
    print(f"n={n} p={p} K=4, {L} lambdas, tol {tol:g}, tiles of {tile}; "
          "walls " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    for a, b in (("jax in-device", "jax streamed"),
                 ("port in-device", "port streamed"),
                 ("port in-device", "jax in-device"),
                 ("port streamed", "jax streamed")):
        print(f"{a} against {b}: {gaps(fits[a], fits[b])}")


if __name__ == "__main__":
    main(sys.argv)
