"""The host-streamed SNP path of adelie_tpu_torch against adelie_tpu, on
the CPU.

The same ``.snpdat`` files go through both packages' streamed matrices
(``tile_snps=16`` on p = 40: three tiles, the last ragged) and through
``grpnet`` with ``configs.screen_all_max = 0`` set in both packages, so
that BASIL screens, the chunk KKT fails and the certify/rollback and the
speculative union run.  Bars: float64 products at atol 1e-12; float64 paths
at 1e-9 in coefficients, intercepts, deviances and lambdas (the bar of
``tests/test_snp_stream.py``), with the same number of streamed passes;
float32 paths at 5e-6 (its ``test_streamed_f32_matches_inhbm``).  Groups are
of size 1 here (``tests/test_torch_grouped.py`` holds the grouped streamed
path, ``tests/test_torch_glm.py`` the streamed binomial one).  The port runs
K5's twin here.
"""

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu.configs import set_configs as ja_set_configs
from adelie_tpu_torch.configs import configs, set_configs
from adelie_tpu_torch.matrix import snp_kernels as sk
from adelie_tpu_torch.solver import pin_kernels as tk
from adelie_tpu_torch.state import state_from_numpy
from test_torch_grpnet import _WS_KEYS, _assert_same_path

torch.set_num_threads(1)


@pytest.fixture
def basil():
    """``screen_all_max = 0`` in both packages: real BASIL screening."""
    ja_set_configs("screen_all_max", 0)
    set_configs("screen_all_max", 0)
    yield
    ja_set_configs("screen_all_max", None)
    set_configs("screen_all_max", None)


@pytest.fixture(autouse=True)
def _reset_union():
    yield
    ja_set_configs("stream_speculative_union", None)
    set_configs("stream_speculative_union", None)


def _io(tmp_path, n, p, seed, name="s.snpdat"):
    d = ja.data.snp_unphased(n, p, missing_ratio=0.1, seed=seed)
    f = str(tmp_path / name)
    ja.io.snp_unphased(f).write(d["X"])
    return ja.io.snp_unphased(f).read(), ta.io.snp_unphased(f).read(), d


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The path tests' panel, n = 300, p = 120 (four tiles of 32): one
    shape, so the JAX package compiles its streamed programs once."""
    return _io(tmp_path_factory.mktemp("panel"), 300, 120, seed=13)


def _streamed(jio, tio, dtype=np.float64, tile_snps=16):
    jm = ja.matrix.snp_unphased(jio, streaming=True, tile_snps=tile_snps,
                                dtype=dtype)
    tm = ta.matrix.snp_unphased(tio, streaming=True, tile_snps=tile_snps,
                                dtype=dtype, device="cpu")
    return jm, tm


def _assert_paths(ts, js, tol):
    assert js.error == "" and ts.error == "", (js.error, ts.error)
    assert len(ts.lmdas) == len(js.lmdas)
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=tol)
    B = js.betas.toarray()
    assert (B != 0).sum() > 0
    np.testing.assert_allclose(ts.betas.toarray(), B, atol=tol)
    np.testing.assert_allclose(ts.intercepts, js.intercepts, atol=tol)
    np.testing.assert_allclose(ts.devs, js.devs, atol=tol)


# --------------------------------------------------------------------------- #
# the matrix                                                                  #
# --------------------------------------------------------------------------- #


def test_streamed_matrix_ops_match_jax(tmp_path):
    jio, tio, _ = _io(tmp_path, 70, 40, seed=3)
    jm, tm = _streamed(jio, tio)
    assert tm._ntiles == jm._ntiles == 3 and tm.is_streaming
    rng = np.random.default_rng(3)
    v, w = rng.standard_normal(70), rng.uniform(0.1, 1, 70)
    U = rng.standard_normal((5, 70))
    beta = np.zeros(40)
    beta[[1, 17, 39]] = [1.5, -2.0, 0.5]
    idx = np.array([0, 13, 25, 39])
    t = torch.from_numpy

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-12)

    before = dict(sk.launches)
    close(tm.mul(t(v), t(w)), jm.mul(v, w))
    close(tm.mul_many(t(U)), jm.mul_many(U))
    close(tm.sq_mul(t(w)), jm.sq_mul(w))
    close(tm.tmul(beta), jm.tmul(beta))
    close(tm.gather(idx), jm.gather(idx))
    close(tm.gather(torch.as_tensor(idx)), jm.gather(idx))
    assert tm.sweeps == jm.sweeps == 3
    assert sk.launches == before
    # tmul also takes a (p, L) block, over the tiles it touches only
    B = np.zeros((40, 2))
    B[[2, 5], 0], B[7, 1] = [1.0, -1.0], 2.0
    close(tm.tmul(B), np.stack([jm.tmul(B[:, 0]), jm.tmul(B[:, 1])], 1))
    with pytest.raises(NotImplementedError):
        tm.mul_spec()
    with pytest.raises(ValueError, match="U must be"):
        tm.mul_many(t(U[:, :60]))


def test_streamed_matrix_tiles_are_views_on_the_cpu(tmp_path):
    """No copies on the CPU: the tiles are views of the host array, and
    mul_many over them is X^T U of the dense matrix."""
    jio, tio, _ = _io(tmp_path, 30, 600, seed=4)
    tm = ta.matrix.snp_unphased(tio, streaming=True, tile_snps=256,
                                dtype=np.float64, device="cpu")
    tiles = list(tm._tiles())
    assert [(s, e) for s, e, _ in tiles] == [(0, 256), (256, 512),
                                             (512, 600)]
    assert all(tile.data_ptr() == tm._host[s].data_ptr()
               for s, _, tile in tiles)
    U = np.random.default_rng(4).standard_normal((3, 30))
    X = ja.matrix.snp_unphased(jio, streaming=False,
                              dtype=np.float64).to_dense()
    np.testing.assert_allclose(tm.mul_many(torch.from_numpy(U)).numpy(),
                               (U @ np.asarray(X)).T, rtol=0, atol=1e-12)


# --------------------------------------------------------------------------- #
# grpnet                                                                      #
# --------------------------------------------------------------------------- #


_PATH = dict(lmda_path_size=20, min_ratio=0.02)


@pytest.fixture(scope="module")
def jax_fits():
    """adelie_tpu's streamed fits on the panel, one a setting, shared by the
    tests that compare with them: each JAX fit traces its own programs."""
    return {}


def _jax_fit(jax_fits, panel, union, **kw):
    key = (union,) + tuple(sorted(kw.items()))
    if key not in jax_fits:
        jio, _, d = panel
        ja_set_configs("stream_speculative_union", union)
        jm = ja.matrix.snp_unphased(jio, streaming=True, tile_snps=32,
                                    dtype=np.float64)
        jax_fits[key] = (ja.grpnet(jm, ja.glm.gaussian(d["y"]), **kw), jm)
    return jax_fits[key]


def _port_fit(panel, union, **kw):
    _, tio, d = panel
    set_configs("stream_speculative_union", union)
    tm = ta.matrix.snp_unphased(tio, streaming=True, tile_snps=32,
                                dtype=np.float64, device="cpu")
    return ta.grpnet(tm, ta.glm.gaussian(d["y"]), **kw), tm


@pytest.mark.parametrize("union", [False, True])
def test_streamed_grpnet_matches_jax(union, basil, panel, jax_fits):
    """BASIL with KKT failures, rollbacks and, with the union on, the
    speculative violators: the same path and the same number of passes."""
    js, jm = _jax_fit(jax_fits, panel, union, **_PATH)
    ts, tm = _port_fit(panel, union, **_PATH)
    _assert_paths(ts, js, 1e-9)
    assert len(ts.benchmark["kkt"]) == len(js.benchmark["kkt"]) > 2
    assert tm.sweeps == jm.sweeps
    assert list(ts.screen_sizes) == list(js.screen_sizes)


def test_streamed_elastic_net_no_intercept(basil, panel, jax_fits):
    kw = dict(alpha=0.7, intercept=False, **_PATH)
    js, jm = _jax_fit(jax_fits, panel, True, **kw)
    ts, tm = _port_fit(panel, True, **kw)
    _assert_paths(ts, js, 1e-9)
    assert len(ts.benchmark["kkt"]) == len(js.benchmark["kkt"])
    assert tm.sweeps == jm.sweeps


def test_streamed_matches_inhbm_in_the_port(basil, panel):
    """With the union off the streamed driver takes the in-device driver's
    screening decisions: the same path at 1e-9."""
    _, tio, d = panel
    ts, _ = _port_fit(panel, False, device="cpu", **_PATH)
    th = ta.grpnet(ta.matrix.snp_unphased(tio, streaming=False,
                                          device="cpu"),
                   ta.glm.gaussian(d["y"]), device="cpu", **_PATH)
    _assert_paths(ts, th, 1e-9)


def test_streamed_f32_matches_jax_f32(basil, panel):
    jio, tio, d = panel
    jm, tm = _streamed(jio, tio, dtype=np.float32, tile_snps=32)
    y = np.asarray(d["y"], np.float32)
    kw = dict(lmda_path_size=12, min_ratio=0.05)
    js = ja.grpnet(jm, ja.glm.gaussian(y, dtype=np.float32), **kw)
    ts = ta.grpnet(tm, ta.glm.gaussian(y, dtype=np.float32), **kw)
    assert ts.betas.dtype == np.float32
    _assert_paths(ts, js, 5e-6)


@pytest.mark.parametrize("option", ["unpenalized", "offsets"])
def test_streamed_unpenalized_groups_and_offsets(option, basil, panel):
    """Unpenalized groups (penalty 0: screened and active from the start)
    and ``offsets`` through both packages' streamed drivers under BASIL:
    the bars of tests/test_torch_grpnet.py's
    test_unpenalized_groups_and_offsets and the same number of passes."""
    jio, tio, d = panel
    n, p = 300, 120
    kw = dict(lmda_path_size=12)
    if option == "unpenalized":
        pen = np.random.default_rng(6).uniform(0.5, 1.5, p)
        pen[[2, 7]] = 0.0
        kw["penalty"] = pen
    else:
        kw["offsets"] = np.random.default_rng(7).uniform(-0.5, 0.5, n)
    jm, tm = _streamed(jio, tio, tile_snps=32)
    js = ja.grpnet(jm, ja.glm.gaussian(d["y"]), **kw)
    ts = ta.grpnet(tm, ta.glm.gaussian(d["y"]), **kw)
    _assert_same_path(js, ts)
    assert tm.sweeps == jm.sweeps
    if option == "unpenalized":
        assert (ts.betas.toarray()[:, [2, 7]] != 0).all()


def _assert_same_path_at_tie(js, ts):
    """``_assert_same_path`` with one exception: when the path starts at
    ``lmda_max``, the group that sets it ties its threshold there.  The
    streamed gradient sets ``lmda_max`` and the screen gradient starts the
    positioning fit: two sums in different orders, whose last bits decide
    whether that fit moves the group by a rounding step (on this panel the
    port's screen gradient is two ulps larger in magnitude than its
    streamed one, with or without ``offsets``, and the JAX package's two
    are equal); its flag then stays set while its coefficient returns to
    0.  So at that lambda, and only there, the port may count that one
    group."""
    assert list(ts.active_sizes[1:]) == list(js.active_sizes[1:])
    assert ts.active_sizes[0] - js.active_sizes[0] in (0, 1)
    if ts.active_sizes[0] != js.active_sizes[0]:
        assert not ts.betas.toarray()[0].any()
        assert not js.betas.toarray()[0].any()
    ts.active_sizes[0] = js.active_sizes[0]
    _assert_same_path(js, ts)


def test_streamed_screen_all_with_offsets(panel):
    """``offsets`` with the whole p = 120 screened up front (the default
    ``screen_all_max``): the same path, the same active count at every
    lambda past ``lmda_max`` and the same number of passes."""
    jio, tio, d = panel
    kw = dict(lmda_path_size=12,
              offsets=np.random.default_rng(7).uniform(-0.5, 0.5, 300))
    jm, tm = _streamed(jio, tio, tile_snps=32)
    js = ja.grpnet(jm, ja.glm.gaussian(d["y"]), **kw)
    ts = ta.grpnet(tm, ta.glm.gaussian(d["y"]), **kw)
    _assert_same_path_at_tie(js, ts)
    assert tm.sweeps == jm.sweeps


@pytest.mark.parametrize("option", ["lmda_path", "max_active_size",
                                    "ddev_tol", "exit_cond"])
def test_streamed_options_match_jax(option, panel):
    """The streamed driver under screen-all with a user lambda path (which
    starts below ``lmda_max``, so no tie), ``max_active_size``,
    ``ddev_tol`` and ``exit_cond`` (one lambda a chunk, stopped after
    three): the JAX package's path and passes."""
    jio, tio, d = panel
    kw = {"lmda_path": dict(lmda_path=np.geomspace(0.5, 0.02, 8)),
          "max_active_size": dict(lmda_path_size=12, max_active_size=6),
          "ddev_tol": dict(lmda_path_size=12, ddev_tol=1e-2),
          "exit_cond": dict(lmda_path_size=6,
                            exit_cond=lambda s: len(s.lmdas) >= 3)}[option]
    jm, tm = _streamed(jio, tio, tile_snps=32)
    js = ja.grpnet(jm, ja.glm.gaussian(d["y"]), **kw)
    ts = ta.grpnet(tm, ta.glm.gaussian(d["y"]), **kw)
    if option == "lmda_path":
        _assert_same_path(js, ts)
    else:
        _assert_same_path_at_tie(js, ts)
    assert tm.sweeps == jm.sweeps
    if option == "exit_cond":
        assert len(ts.lmdas) == 3


def test_warm_start_from_jax_streamed_fit(basil, panel, jax_fits):
    """Lambdas 0-4 of the shared path fitted by adelie_tpu's streamed
    driver, carried over with state_from_numpy, and lambdas 5-11 finished
    by the port's: adelie_tpu's own continuation to 1e-9, with no kernel
    launch on the CPU."""
    jio, tio, d = panel
    full, _ = _jax_fit(jax_fits, panel, True, **_PATH)
    jm, tm = _streamed(jio, tio, tile_snps=32)
    half = ja.grpnet(jm, ja.glm.gaussian(d["y"]), lmda_path=full.lmdas[:5])
    ws = state_from_numpy({k: np.asarray(getattr(half, k)) for k in _WS_KEYS},
                          device="cpu")
    rest = full.lmdas[5:12]
    before = dict(sk.launches), dict(tk.launches)
    ts = ta.grpnet(tm, ta.glm.gaussian(d["y"]), lmda_path=rest,
                   warm_start=ws)
    assert (dict(sk.launches), dict(tk.launches)) == before
    js = ja.grpnet(jm, ja.glm.gaussian(d["y"]), lmda_path=rest,
                   warm_start=half)
    _assert_paths(ts, js, 1e-9)


# --------------------------------------------------------------------------- #
# the factory                                                                 #
# --------------------------------------------------------------------------- #


def test_streamed_factory(tmp_path, monkeypatch):
    _, tio, _ = _io(tmp_path, 60, 30, seed=1)
    Streamed = ta.matrix.MatrixNaiveSNPUnphasedStreamed
    m = ta.matrix.snp_unphased(tio, device="cpu")
    assert isinstance(m, ta.matrix.MatrixNaiveSNPUnphased)
    assert m.dtype == np.float64
    set_configs("snp_hbm_budget", tio.packed.nbytes - 1)
    try:
        m = ta.matrix.snp_unphased(tio, n_threads=4, device="cpu")
    finally:
        set_configs("snp_hbm_budget")
    assert configs.snp_hbm_budget == 40 * 10**9
    assert isinstance(m, Streamed) and m.dtype == np.float32
    assert m._tile == 256 and m._ntiles == 1
    m = ta.matrix.snp_unphased(tio, streaming=True, tile_snps=7,
                               dtype=np.float64, device="cpu")
    assert m._tile == 7 and m._ntiles == 5 and m.dtype == np.float64
    assert ta.matrix.snp_phased_ancestry(
        type("IO", (), {"packed": np.zeros((6, 5), np.uint8),
                        "rows": lambda self: 20, "cols": lambda self: 6})(),
        n_threads=2, device="cpu").shape == (20, 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.matrix.snp_unphased(tio, streaming=True, device="cuda")


_WRAPPERS = {
    "standardize": lambda pkg, m: pkg.matrix.standardize(m),
    "column_subset": lambda pkg, m: pkg.matrix.subset(m, np.arange(10),
                                                      axis=1),
    "row_subset": lambda pkg, m: pkg.matrix.subset(m, np.arange(30), axis=0),
    "row_concatenate": lambda pkg, m: pkg.matrix.concatenate([m, m], axis=0),
    "block_diag": lambda pkg, m: pkg.matrix.block_diag([m, m]),
}


@pytest.mark.parametrize("wrapper", list(_WRAPPERS))
def test_wrapped_streamed_panel_is_refused_as_in_jax(tmp_path, wrapper):
    """``standardize``, ``subset`` (either axis), ``concatenate(axis=0)``
    and the naive ``block_diag`` of a streamed panel report
    ``is_streaming``, and ``grpnet`` refuses them up front, as the JAX
    package does (its ``mul_spec``); a column concatenation and
    ``kronecker_eye`` of the panel keep fitting."""
    jio, tio, _ = _io(tmp_path, 60, 40, seed=17)
    jm, tm = _streamed(jio, tio)
    jw, tw = _WRAPPERS[wrapper](ja, jm), _WRAPPERS[wrapper](ta, tm)
    assert tw.is_streaming
    y = np.random.default_rng(3).standard_normal(tw.rows())
    with pytest.raises(NotImplementedError):
        ja.grpnet(jw, ja.glm.gaussian(y), lmda_path_size=3)
    with pytest.raises(NotImplementedError,
                       match=f"{type(tw).__name__} over a host-streamed"):
        ta.grpnet(tw, ta.glm.gaussian(y), lmda_path_size=3)
    # inside a column concatenation, the wrapper is still found
    cc = ta.matrix.concatenate([tw, tw])
    with pytest.raises(NotImplementedError, match="bare panel"):
        ta.grpnet(cc, ta.glm.gaussian(np.zeros(cc.rows())),
                  lmda_path_size=3)
    ok = ta.matrix.concatenate([tm, ta.matrix.dense(
        np.ones((60, 1)), device="cpu")])
    assert ok.is_streaming
    ta.matrix.wrappers.refuse_wrapped_stream(ok)
    ta.matrix.wrappers.refuse_wrapped_stream(ta.matrix.kronecker_eye(ok, 2))
    s = ta.grpnet(ok, ta.glm.gaussian(np.random.default_rng(4)
                                      .standard_normal(60)),
                  lmda_path_size=3)
    assert s.error == "" and len(s.benchmark["kkt"]) > 0
