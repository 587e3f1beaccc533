"""Build and load the package's native libraries.

The sources in ``csrc/`` have a plain C interface.  Each library is built
at its first use into ``build/adelie_tpu_torch/`` beside the package, named
by a hash of its sources and flags, and loaded with ``ctypes``:

* the CUDA kernels (``*.cu``), by ``nvcc``, into one library, at the first
  CUDA call;
* the ``.snpdat`` codec (``snpio.cpp``, host code), by the host C++
  compiler, at the first SNP file read or write.

A later process with the same sources and flags loads the existing library.
A build writes a temporary file and renames it into place, so processes
that build at the same time never load a partial library.  A failed build
raises: nothing falls back to the plain PyTorch versions.
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
SOURCES = (CSRC_DIR / "pin_kernels.cu", CSRC_DIR / "snp_kernels.cu")
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

SNPIO_SOURCE = CSRC_DIR / "snpio.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_snpio = None
build_log = ""        # the compiler's output of the build that made the library
build_seconds = 0.0   # 0.0 when an existing library was loaded


class KernelBuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


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


def find_cxx() -> str:
    """``$CXX``, else ``c++`` or ``g++`` on ``$PATH``."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for name in names + ["c++", "g++"]:
        found = shutil.which(name)
        if found:
            return found
    raise KernelBuildError(
        "no host C++ compiler (looked for $CXX, c++ and g++ on $PATH): the "
        ".snpdat codec cannot be built"
    )


def _hash(sources, flags) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def source_hash() -> str:
    return _hash(SOURCES, NVCC_FLAGS)


def library_path() -> Path:
    return BUILD_DIR / f"adelie_kernels_{source_hash()}.so"


def snpio_library_path() -> Path:
    return BUILD_DIR / f"snpio_{_hash((SNPIO_SOURCE,), CXX_FLAGS)}.so"


def nvcc_command(nvcc: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(s) for s in SOURCES)]


def cxx_command(cxx: str, out: Path) -> list:
    return [cxx, *CXX_FLAGS, str(SNPIO_SOURCE), "-o", str(out)]


def _compile(command, out: Path) -> tuple:
    """Run ``command(tmp)`` into a temporary file beside ``out``, then
    rename it to ``out``; return (compiler output, seconds)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = command(Path(tmp))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"{cmd[0]} failed with code {proc.returncode}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr, time.perf_counter() - t0


def _open(path: Path):
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelBuildError(f"cannot load {path}: {exc}") from exc


def _bind(lib) -> None:
    from ctypes import c_double, c_float, c_int, c_int64, c_void_p

    ptr = c_void_p
    for suffix, real in (("f32", c_float), ("f64", c_double)):
        f = getattr(lib, f"adelie_pin_lasso_solve_{suffix}")
        f.argtypes = [ptr] * 11 + [c_int, real, real, real, real, c_int, ptr]
        f.restype = c_int
        f = getattr(lib, f"adelie_cd_sweep_rows_{suffix}")
        f.argtypes = [ptr] * 9 + [c_int, c_int, real, real, real, ptr]
        f.restype = c_int
        # (packed, u_pad, [impute,] out, p, nb, stream)
        for name, n_ptr in (("snp_mul", 4), ("snp_mul_no_na", 3)):
            f = getattr(lib, f"adelie_{name}_{suffix}")
            f.argtypes = [ptr] * n_ptr + [c_int64, c_int64, ptr]
            f.restype = c_int
    lib.adelie_cuda_error_string.argtypes = [c_int]
    lib.adelie_cuda_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, built first if needed."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                nvcc = find_nvcc()
                build_log, build_seconds = _compile(
                    lambda out: nvcc_command(nvcc, out), path)
            lib = _open(path)
            _bind(lib)
            _lib = lib
        return _lib


def load_snpio():
    """The loaded ``.snpdat`` codec, built first if needed (``io.py``
    declares its entry points)."""
    global _snpio
    with _lock:
        if _snpio is None:
            path = snpio_library_path()
            if not path.exists():
                cxx = find_cxx()
                _compile(lambda out: cxx_command(cxx, out), path)
            _snpio = _open(path)
        return _snpio


def check(lib, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.adelie_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
