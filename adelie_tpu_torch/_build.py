"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At the first CUDA call
they are compiled by ``nvcc`` into one shared library under
``build/adelie_tpu_torch/`` beside the package, named by a hash of the
sources and the flags, and loaded with ``ctypes``.  A later process with the
same sources and flags loads the existing library.  A failed build raises:
nothing falls back to the plain PyTorch versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "adelie_tpu_torch"
SOURCES = (CSRC_DIR / "pin_kernels.cu",)
# -fmad=false: no contraction of a*b+c into one rounding, so every
# operation of the kernels rounds as in their twins, and a kernel and its
# twin take the same Gauss-Seidel path (same sweeps, same stops).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# where the CUDA toolkit is looked for after $CUDA_HOME and $PATH
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_lib = None
build_log = ""        # the compiler's output of the build that made the library
build_seconds = 0.0   # 0.0 when an existing library was loaded


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"adelie_kernels_{source_hash()}.so"


def nvcc_command(nvcc: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(s) for s in SOURCES)]


def _compile(out: Path) -> None:
    global build_log, build_seconds
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_command(nvcc, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed with code {proc.returncode}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def _bind(lib) -> None:
    from ctypes import c_double, c_float, c_int, c_void_p

    ptr = c_void_p
    for suffix, real in (("f32", c_float), ("f64", c_double)):
        f = getattr(lib, f"adelie_pin_lasso_solve_{suffix}")
        f.argtypes = [ptr] * 11 + [c_int, real, real, real, real, c_int, ptr]
        f.restype = c_int
        f = getattr(lib, f"adelie_cd_sweep_rows_{suffix}")
        f.argtypes = [ptr] * 9 + [c_int, c_int, real, real, real, ptr]
        f.restype = c_int
    lib.adelie_cuda_error_string.argtypes = [c_int]
    lib.adelie_cuda_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path}: {exc}") from exc
            _bind(lib)
            _lib = lib
        return _lib


def check(lib, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.adelie_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
