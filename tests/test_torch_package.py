"""Package-level contracts of adelie_tpu_torch that hold without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import adelie_tpu_torch as ta
from adelie_tpu_torch import _build
from adelie_tpu_torch.configs import configs, matmul_precision, set_configs
from adelie_tpu_torch.solver import pin_kernels as tk

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_import_does_not_load_jax():
    code = ("import sys, adelie_tpu_torch, adelie_tpu_torch.io; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'adelie_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.ones((4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.grpnet(X, ta.glm.gaussian(np.ones(4)), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.matrix.dense(X, device="cuda:0")
    # the default is the card, so without one it raises too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.grpnet(X, ta.glm.gaussian(np.ones(4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.matrix.dense(X)
    assert ta.matrix.dense(X, device="cpu").mat.device == torch.device("cpu")


def test_nvcc_command_targets_sm90a_and_csrc_only():
    out = Path("/tmp/out.so")
    compiles, link = _build.nvcc_commands("/x/nvcc", out)
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    # one source a compile, each in csrc/, each into its own object file
    srcs = [Path(c[-1]) for c in compiles]
    assert all(s.parent == _build.CSRC_DIR and s.is_file() for s in srcs)
    objs = [c[c.index("-o") + 1] for c in compiles]
    assert len(set(objs)) == len(objs) and link[-len(objs):] == objs
    assert link[link.index("-o") + 1] == str(out) and "-shared" in link
    assert _build.library_path().parent == REPO / "build" / "adelie_tpu_torch"


def test_nvcc_command_names_both_kernel_sources():
    compiles, _ = _build.nvcc_commands("/x/nvcc", Path("/tmp/out.so"))
    names = sorted(Path(c[-1]).name for c in compiles)
    assert names == ["pin_group_kernels.cu", "pin_kernels.cu",
                     "screened_cd_kernels.cu", "snp_kernels.cu"]
    # snp_kernels.cu holds K3, K4 and K5; pin_group_kernels.cu K6;
    # screened_cd_kernels.cu K7
    src = (_build.CSRC_DIR / "snp_kernels.cu").read_text()
    assert all(f"adelie_{k}_f32(" in src
               for k in ("snp_mul", "snp_mul_no_na", "snp_mul_many"))
    src = (_build.CSRC_DIR / "pin_group_kernels.cu").read_text()
    assert all(f"adelie_pin_group_solve_{s}(" in src for s in ("f32", "f64"))
    src = (_build.CSRC_DIR / "screened_cd_kernels.cu").read_text()
    assert all(f"adelie_screened_cd_solve_{s}(" in src
               for s in ("f32", "f64"))
    assert all("-fmad=false" in c and "-c" in c for c in compiles)


def test_library_name_covers_the_shared_header(tmp_path, monkeypatch):
    """The K1/K2 and K3-K5 sources include csrc/async_copy.cuh (the
    mbarrier and bulk-copy helpers), so an edit of it must name a new
    library: a stale one would otherwise be loaded."""
    header = _build.CSRC_DIR / "async_copy.cuh"
    assert _build.HEADERS == (header,)
    for name in ("pin_kernels.cu", "snp_kernels.cu"):
        src = _build.CSRC_DIR / name
        assert src in _build.SOURCES
        assert '#include "async_copy.cuh"' in src.read_text()
    before = _build.library_path()
    edited = tmp_path / header.name
    edited.write_text(header.read_text() + "// an edit\n")
    monkeypatch.setattr(_build, "HEADERS", (edited,))
    assert _build.library_path() != before


def test_bind_declares_k5_with_64_bit_and_pointer_arguments():
    """K5's entry points take (packed, ut, impute, out) as pointers, then
    (p, nb, C, Cp) as 64-bit ints and the stream as a pointer: a pointer
    passed as a c_int would be cut to 32 bits."""
    from ctypes import c_int, c_int64, c_void_p

    class _Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = _Lib()
    _build._bind(lib)
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"adelie_snp_mul_many_{suffix}")
        assert fn.argtypes == [c_void_p] * 4 + [c_int64] * 4 + [c_void_p]
        assert fn.restype is c_int
        source = (_build.CSRC_DIR / "snp_kernels.cu").read_text()
        assert f"int adelie_snp_mul_many_{suffix}(" in source
    assert lib.adelie_snp_mul_many_cols.argtypes == [c_int64]
    assert lib.adelie_snp_mul_many_cols.restype is c_int64
    assert _build.CSRC_DIR / "snp_kernels.cu" in _build.SOURCES


def test_bind_declares_k2_with_its_list_scratch():
    """K2's entry points take 16 pointers (inputs, outputs and the scratch
    buffers, the pass list's among them), then (S, G), four scalars of the
    dtype, max_iters and the stream, as the source declares them."""
    from ctypes import c_double, c_float, c_int, c_void_p

    class _Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = _Lib()
    _build._bind(lib)
    source = (_build.CSRC_DIR / "pin_kernels.cu").read_text()
    for suffix, real in (("f32", c_float), ("f64", c_double)):
        fn = getattr(lib, f"adelie_pin_lasso_solve_rows_{suffix}")
        assert fn.argtypes == ([c_void_p] * 16 + [c_int, c_int]
                               + [real] * 4 + [c_int, c_void_p])
        assert fn.restype is c_int
        head = source[source.index(
            f"int adelie_pin_lasso_solve_rows_{suffix}("):]
        head = head[:head.index(")")]
        assert head.count("void*") == 17 and "void* plan, int S, int G" in head


def test_codec_build_command_and_place():
    out = _build.snpio_library_path()
    cmd = _build.cxx_command("/x/c++", out)
    srcs = [a for a in cmd if a.endswith((".cpp", ".cc", ".cu"))]
    assert srcs == [str(_build.CSRC_DIR / "snpio.cpp")]
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert out.parent == REPO / "build" / "adelie_tpu_torch"
    assert out.name.startswith("snpio_") and out.suffix == ".so"


def test_missing_host_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_snpio", None)
    with pytest.raises(_build.KernelBuildError, match="C\\+\\+ compiler"):
        _build.load_snpio()
    assert not (tmp_path / "build").exists()


def test_missing_nvcc_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA gets no twin."""
    A = torch.empty((4, 4), device="meta")
    v = torch.empty(4, device="meta")
    b = torch.empty(4, dtype=torch.bool, device="meta")
    slots = (torch.empty(4, dtype=torch.int64, device="meta"),
             torch.empty(4, dtype=torch.int32, device="meta"), v[:, None], v,
             b)
    for solve in (tk.pin_lasso_solve, tk.pin_lasso_solve_rows):
        with pytest.raises(ValueError, match="no kernel or twin"):
            solve(A, v, v, *slots, 0.1, 1.0, 1e-7, 10, 0.0)


@pytest.mark.parametrize("name,tf32", [("highest", False), ("float32", False),
                                       ("default", True), ("x3", True)])
def test_matmul_precision_maps_to_tf32(name, tf32):
    before = torch.backends.cuda.matmul.allow_tf32
    set_configs("matmul_precision", name)
    try:
        with matmul_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        set_configs("matmul_precision")
    assert configs.matmul_precision == "highest"
    set_configs("matmul_precision", "bogus")
    try:
        with pytest.raises(ValueError, match="bogus"):
            with matmul_precision():
                pass
    finally:
        set_configs("matmul_precision")


def test_unported_inputs_raise():
    """Groups of size > 1 are ported: ``groups=[0, 2, 4]`` fits as the JAX
    package does (the bars of test_torch_grpnet.py), and so are
    multi-response GLMs: the multigaussian of two responses in the same
    groups, at the bars of test_torch_multi.py.  Constraints raise."""
    import adelie_tpu as ja
    from test_torch_grpnet import _assert_same_path

    rng = np.random.default_rng(0)
    X = rng.standard_normal((20, 6))
    y = X[:, :3] @ np.array([1.0, -0.5, 0.3]) + 0.1 * rng.standard_normal(20)
    kw = dict(groups=[0, 2, 4], lmda_path_size=10)
    js = ja.grpnet(X, ja.glm.gaussian(y), **kw)
    ts = ta.grpnet(X, ta.glm.gaussian(y), device="cpu", **kw)
    _assert_same_path(js, ts)
    Y = np.stack([y, X[:, 4] - y], 1)
    js = ja.grpnet(X, ja.glm.multigaussian(Y), **kw)
    ts = ta.grpnet(X, ta.glm.multigaussian(Y), device="cpu", **kw)
    assert js.error == ts.error == "" and len(ts.lmdas) == len(js.lmdas)
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-10)
    np.testing.assert_allclose(ts.betas.toarray(), js.betas.toarray(),
                               atol=1e-6)
    np.testing.assert_allclose(ts.intercepts, js.intercepts, atol=1e-6)
    with pytest.raises(NotImplementedError, match="constraints"):
        ta.grpnet(X, ta.glm.multigaussian(Y), constraints=[object()] * 3,
                  device="cpu")


def test_dense_matrix_products_match_numpy():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((30, 7))
    v, w = rng.standard_normal(30), rng.uniform(0.5, 1.5, 30)
    U = rng.standard_normal((3, 30))
    b = rng.standard_normal(7)
    M = ta.matrix.dense(X, device="cpu")
    t = torch.from_numpy
    assert M.shape == (30, 7) and M.dtype == np.float64
    np.testing.assert_allclose(M.mul(t(v), t(w)).numpy(), X.T @ (v * w))
    np.testing.assert_allclose(M.mul_many(t(U)).numpy(), X.T @ U.T)
    np.testing.assert_allclose(M.gather([4, 1]).numpy(), X[:, [4, 1]])
    np.testing.assert_allclose(M.tmul(b).numpy(), X @ b)
    np.testing.assert_allclose(M.sq_mul(t(w)).numpy(), (X * X).T @ w)
    np.testing.assert_array_equal(M.to_dense(), X)


def test_grpnet_accepts_the_jax_keywords():
    """``n_threads``, ``irls_*`` and ``newton_*`` are accepted and change
    nothing here (a gaussian fit in covariance form runs no IRLS, and
    groups of size 1 take no Newton step); ``check_state=True`` audits the
    finished state, which passes, and changes nothing either."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((30, 5))
    y = X[:, 0] + 0.1 * rng.standard_normal(30)
    kw = dict(lmda_path_size=5, device="cpu")
    a = ta.grpnet(X, ta.glm.gaussian(y), **kw)
    b = ta.grpnet(X, ta.glm.gaussian(y), n_threads=2, irls_max_iters=10,
                  irls_tol=1e-7, newton_tol=1e-12, newton_max_iters=5,
                  check_state=False, **kw)
    assert a.error == b.error == ""
    np.testing.assert_array_equal(a.betas.toarray(), b.betas.toarray())
    c = ta.grpnet(X, ta.glm.gaussian(y), check_state=True, **kw)
    assert c.error == "" and ta.state.check_state(c) == []
    np.testing.assert_array_equal(a.betas.toarray(), c.betas.toarray())


def test_dense_copy_and_n_threads():
    """``copy=False`` lets a CPU matrix share a numpy array of its dtype;
    ``copy=True`` never does; ``n_threads`` is accepted."""
    X = np.arange(12.0).reshape(4, 3)
    shared = ta.matrix.dense(X, n_threads=4, device="cpu")
    copied = ta.matrix.dense(X, copy=True, device="cpu")
    X[0, 0] = 100.0
    assert shared.mat[0, 0].item() == 100.0
    assert copied.mat[0, 0].item() == 0.0
