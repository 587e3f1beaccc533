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
    assert ta.matrix.dense(X).device == torch.device("cpu")


def test_nvcc_command_targets_sm90a_and_csrc_only():
    cmd = _build.nvcc_command("/x/nvcc", Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    srcs = [Path(a) for a in cmd if a.endswith((".cu", ".cuh", ".cpp"))]
    assert srcs, cmd
    assert all(s.parent == _build.CSRC_DIR and s.is_file() for s in srcs)
    assert _build.library_path().parent == REPO / "build" / "adelie_tpu_torch"


def test_nvcc_command_names_both_kernel_sources():
    cmd = _build.nvcc_command("/x/nvcc", Path("/tmp/out.so"))
    names = sorted(Path(a).name for a in cmd if a.endswith(".cu"))
    assert names == ["pin_kernels.cu", "snp_kernels.cu"]
    # snp_kernels.cu holds K3, K4 and K5
    src = (_build.CSRC_DIR / "snp_kernels.cu").read_text()
    assert all(f"adelie_{k}_f32(" in src
               for k in ("snp_mul", "snp_mul_no_na", "snp_mul_many"))
    assert "-fmad=false" in cmd


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
    with pytest.raises(ValueError, match="no kernel or twin"):
        tk.pin_lasso_solve(A, v, v, v, b, b, v, 0.1, 1.0, 1e-7, 10, 0.0)
    with pytest.raises(ValueError, match="no kernel or twin"):
        tk.cd_sweep_rows(A, v, v, torch.empty(2, dtype=torch.int32,
                                               device="meta"),
                         v[:2], v[:2], torch.empty(1, dtype=torch.int32,
                                                   device="meta"),
                         0.1, 0.0, 0.0)


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
    X = np.random.default_rng(0).standard_normal((20, 6))
    y = np.ones(20)
    with pytest.raises(NotImplementedError, match="queue 3"):
        ta.grpnet(X, ta.glm.gaussian(y), groups=[0, 2, 4], device="cpu")
    glm = ta.glm.gaussian(y)
    glm.name = "binomial"
    with pytest.raises(NotImplementedError, match="queue 5"):
        ta.grpnet(X, glm, device="cpu")


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
