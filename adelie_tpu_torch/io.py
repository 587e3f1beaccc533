"""SNP file IO (reference adelie/io.py, io_snp_unphased.{hpp,ipp},
io_snp_phased_ancestry.{hpp,ipp}).

Counterpart of ``adelie_tpu/io.py``, with its own copy of the codec: the
chunked-sparse ``.snpdat`` encoding (256-element chunks) in
``csrc/snpio.cpp``, host C++ built at first use into
``build/adelie_tpu_torch/`` (``_build.load_snpio``) and driven through
ctypes.  ``read`` decodes straight into the 2-bit packed layout that the SNP
matrix classes place on the device; ``snp_bed`` reads PLINK ``.bed`` files
into the same layout.  The handlers hold numpy arrays only.
"""

import ctypes
import os
import threading

import numpy as np

from .utils import Stopwatch, types

__all__ = ["snp_bed", "snp_phased_ancestry", "snp_unphased",
           "unpack_to_dense"]

_LIB = None
_LOCK = threading.Lock()

# reference io_snp_base.hpp:130-134: "auto" resolves to mmap
_READ_MODES = {"file": 0, "mmap": 1}


def _get_lib():
    """The codec library with its entry points declared."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from ._build import load_snpio

        lib = load_snpio()
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.snpio_set_read_mode.restype = None
        lib.snpio_set_read_mode.argtypes = [ctypes.c_int]
        lib.snpio_unphased_write.restype = ctypes.c_uint64
        lib.snpio_unphased_write.argtypes = [
            ctypes.c_char_p, i8p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int, f64p,
        ]
        lib.snpio_unphased_header.restype = ctypes.c_int
        lib.snpio_unphased_header.argtypes = [ctypes.c_char_p, u64p, u64p]
        lib.snpio_unphased_read_packed.restype = ctypes.c_int
        lib.snpio_unphased_read_packed.argtypes = [
            ctypes.c_char_p, u8p, u64p, u64p, f64p,
        ]
        lib.snpio_unphased_read_dense.restype = ctypes.c_int
        lib.snpio_unphased_read_dense.argtypes = [ctypes.c_char_p, i8p]
        lib.snpio_phased_write.restype = ctypes.c_uint64
        lib.snpio_phased_write.argtypes = [
            ctypes.c_char_p, i8p, i8p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.snpio_phased_header.restype = ctypes.c_int
        lib.snpio_phased_header.argtypes = [ctypes.c_char_p, u64p, u64p, u64p]
        lib.snpio_phased_read_packed.restype = ctypes.c_int
        lib.snpio_phased_read_packed.argtypes = [
            ctypes.c_char_p, u8p, u64p, u64p,
        ]
        _LIB = lib
        return _LIB


def _lib_for(read_mode):
    """The codec library with the read mode applied (reference
    io_snp_base.hpp read_mode_type: file | mmap)."""
    lib = _get_lib()
    lib.snpio_set_read_mode(_READ_MODES[types.read_mode(read_mode)])
    return lib


def _i8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _f64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class snp_unphased:
    """IO handler for SNP unphased matrices (reference io.py:114).

    Values in {0, 1, 2, NA} (any negative value is NA).
    """

    def __init__(self, filename, read_mode: str = "file"):
        self.filename = str(filename)
        self.read_mode = types.read_mode(read_mode)
        self._read = False

    def write(self, calldata, impute_method: str = "mean", n_threads: int = 1):
        """Write dense (n, p) int8 calldata to ``.snpdat``; returns
        (total_bytes, benchmark)."""
        sw = Stopwatch().start()
        calldata = np.asarray(calldata, np.int8)
        n, p = calldata.shape
        if np.any(calldata > 2):
            raise ValueError(
                "Detected a value greater than > 2. Make sure calldata "
                "only contains values <= 2."
            )
        method = {"mean": 0, "zero": 1}[impute_method]
        callf = np.asfortranarray(calldata)
        impute = np.zeros(p, np.float64)
        total = _get_lib().snpio_unphased_write(
            self.filename.encode(), _i8p(callf), n, p, method, _f64p(impute)
        )
        if total == 0:
            raise RuntimeError("snp_unphased write failed")
        return int(total), {"total": sw.elapsed()}

    def read(self):
        """Load the file; populates rows/snps/impute/nnz/nnm/packed."""
        lib = _lib_for(self.read_mode)
        n = np.zeros(1, np.uint64)
        p = np.zeros(1, np.uint64)
        if not lib.snpio_unphased_header(self.filename.encode(), _u64p(n),
                                         _u64p(p)):
            raise RuntimeError(f"cannot read {self.filename}")
        n, p = int(n[0]), int(p[0])
        # plausibility guard: a corrupt/truncated file yields garbage dims
        # (the format has no magic); cap by what the file could encode
        fsize = os.path.getsize(self.filename)
        # the per-column outer index alone needs 8*p bytes
        if n <= 0 or p <= 0 or n > (1 << 40) or 8 * p > fsize:
            raise RuntimeError(
                f"corrupt or truncated snpdat file {self.filename}: "
                f"header claims n={n}, p={p} (file is {fsize} bytes)"
            )
        nb = (n + 3) // 4
        packed = np.zeros((p, nb), np.uint8)  # row j = column j's bytes
        nnz = np.zeros(p, np.uint64)
        nnm = np.zeros(p, np.uint64)
        impute = np.zeros(p, np.float64)
        ok = lib.snpio_unphased_read_packed(
            self.filename.encode(), _u8p(packed), _u64p(nnz), _u64p(nnm),
            _f64p(impute),
        )
        if not ok:
            raise RuntimeError(f"decode failed for {self.filename}")
        self._rows, self._snps = n, p
        self.nnz = nnz.astype(np.int64)
        self.nnm = nnm.astype(np.int64)
        self.impute = impute
        self.packed = packed  # (p, ceil(n/4)) uint8, 2-bit entries, 3 = NA
        self._read = True
        return self

    def rows(self):
        self._ensure()
        return self._rows

    def snps(self):
        self._ensure()
        return self._snps

    def cols(self):
        return self.snps()

    def _ensure(self):
        if not self._read:
            self.read()

    def to_dense(self, n_threads: int = 1):
        """Dense int8 (n, p) with NA = -9 (reference to_dense)."""
        self._ensure()
        lib = _lib_for(self.read_mode)
        out = np.zeros((self._snps, self._rows), np.int8)  # col-major via T
        ok = lib.snpio_unphased_read_dense(self.filename.encode(), _i8p(out))
        if not ok:
            raise RuntimeError("decode failed")
        return out.T


class snp_bed:
    """PLINK 1.x ``.bed`` reader (SNP-major, 2-bit packed).

    PLINK codes per 2-bit entry: 0 = hom A1 (dosage 2), 1 = missing,
    2 = het (dosage 1), 3 = hom A2 (dosage 0).  ``read()`` remaps bytes via
    a 256-entry LUT straight into the packed layout the device matrices
    take ({0, 1, 2, 3 = NA}): one vectorized table lookup, no per-entry
    host decode.
    """

    _MAGIC = bytes([0x6C, 0x1B, 0x01])

    def __init__(self, filename, n_samples=None, n_snps=None):
        self.filename = str(filename)
        self._n = n_samples
        self._p = n_snps
        self._read = False

    @staticmethod
    def _byte_lut():
        # remap each byte's four 2-bit PLINK codes to our codes
        code_map = np.array([2, 3, 1, 0], np.uint8)  # PLINK -> ours
        lut = np.empty(256, np.uint8)
        for b in range(256):
            out = 0
            for k in range(4):
                out |= int(code_map[(b >> (2 * k)) & 3]) << (2 * k)
            lut[b] = out
        return lut

    def write(self, calldata):
        """Write dense (n, p) int8 {0,1,2,-9} as a PLINK .bed (testing aid)."""
        X = np.asarray(calldata)
        n, p = X.shape
        nb = (n + 3) // 4
        inv = {0: 3, 1: 2, 2: 0}
        out = np.zeros((p, nb), np.uint8)
        for j in range(p):
            for i in range(n):
                v = int(X[i, j])
                code = 1 if v < 0 else inv[v]
                out[j, i // 4] |= code << (2 * (i % 4))
        with open(self.filename, "wb") as f:
            f.write(self._MAGIC)
            f.write(out.tobytes())
        self._n, self._p = n, p
        return 3 + out.nbytes

    def read(self):
        raw = np.fromfile(self.filename, np.uint8)
        if raw[:3].tobytes() != self._MAGIC:
            raise RuntimeError(
                f"{self.filename} is not a SNP-major PLINK .bed file"
            )
        body = raw[3:]
        if self._n is None:
            raise ValueError("n_samples is required to read a .bed file "
                             "(PLINK stores it in the .fam file)")
        n = int(self._n)
        nb = (n + 3) // 4
        if self._p is None:
            if len(body) % nb:
                raise RuntimeError("truncated .bed body")
            self._p = len(body) // nb
        p = int(self._p)
        lut = self._byte_lut()
        packed = lut[body.reshape(p, nb)]
        # mask tail entries beyond n to 0
        rem = n % 4
        if rem:
            keep = (1 << (2 * rem)) - 1
            packed[:, -1] &= keep
        self.packed = packed
        self._rows, self._snps = n, p
        # impute means over non-missing (device matrices need them)
        dense = unpack_to_dense(packed, n)
        na = dense == 3
        vals = np.where(na, 0, dense).astype(np.float64)
        nnm = (~na).sum(axis=0)
        self.nnm = nnm.astype(np.int64)
        self.nnz = (dense != 0).sum(axis=0).astype(np.int64)
        with np.errstate(invalid="ignore"):
            self.impute = np.where(nnm > 0,
                                   vals.sum(axis=0) / np.maximum(nnm, 1), 0.0)
        self._read = True
        return self

    def rows(self):
        self._ensure()
        return self._rows

    def snps(self):
        self._ensure()
        return self._snps

    def cols(self):
        return self.snps()

    def _ensure(self):
        if not self._read:
            self.read()

    def to_dense(self, n_threads: int = 1):
        self._ensure()
        dense = unpack_to_dense(self.packed, self._rows)
        return np.where(dense == 3, -9, dense).astype(np.int8)


def unpack_to_dense(packed, n):
    """(p, nb) 2-bit packed -> (n, p) uint8 codes."""
    p, nb = packed.shape
    out = np.zeros((p, nb * 4), np.uint8)
    for k in range(4):
        out[:, k::4] = (packed >> (2 * k)) & 3
    return out[:, :n].T


class snp_phased_ancestry:
    """IO handler for phased calldata x local ancestry (reference io.py:6).

    Matrix semantics: (n, s*A); column s*A + a sums haplotype calls with
    ancestry a (values 0/1/2).
    """

    def __init__(self, filename, read_mode: str = "file"):
        self.filename = str(filename)
        self.read_mode = types.read_mode(read_mode)
        self._read = False

    def write(self, calldata, ancestries, A: int, n_threads: int = 1):
        sw = Stopwatch().start()
        calldata = np.asarray(calldata, np.int8)
        ancestries = np.asarray(ancestries, np.int8)
        if calldata.shape != ancestries.shape or calldata.shape[1] % 2:
            raise ValueError(
                "calldata and ancestries must have shape (n, 2*s)."
            )
        if np.any((calldata < 0) | (calldata > 1)):
            raise ValueError("calldata must only contain 0/1.")
        if np.any((ancestries < 0) | (ancestries >= A)):
            raise ValueError("ancestries must be in {0, ..., A-1}.")
        n, s2 = calldata.shape
        callf = np.asfortranarray(calldata)
        ancf = np.asfortranarray(ancestries)
        total = _get_lib().snpio_phased_write(
            self.filename.encode(), _i8p(callf), _i8p(ancf), n, s2, A
        )
        if total == 0:
            raise RuntimeError("snp_phased_ancestry write failed")
        return int(total), {"total": sw.elapsed()}

    def read(self):
        lib = _lib_for(self.read_mode)
        n = np.zeros(1, np.uint64)
        s = np.zeros(1, np.uint64)
        A = np.zeros(1, np.uint64)
        if not lib.snpio_phased_header(self.filename.encode(), _u64p(n),
                                       _u64p(s), _u64p(A)):
            raise RuntimeError(f"cannot read {self.filename}")
        n, s, A = int(n[0]), int(s[0]), int(A[0])
        fsize = os.path.getsize(self.filename)
        if (n <= 0 or s <= 0 or A <= 0 or n > (1 << 40)
                or 8 * s > fsize or A > 64):
            raise RuntimeError(
                f"corrupt or truncated snpdat file {self.filename}: "
                f"header claims n={n}, snps={s}, ancestries={A} "
                f"(file is {fsize} bytes)"
            )
        nb = (n + 3) // 4
        packed = np.zeros((s * A, nb), np.uint8)
        nnz0 = np.zeros(s * A, np.uint64)
        nnz1 = np.zeros(s * A, np.uint64)
        ok = lib.snpio_phased_read_packed(
            self.filename.encode(), _u8p(packed), _u64p(nnz0), _u64p(nnz1)
        )
        if not ok:
            raise RuntimeError(f"decode failed for {self.filename}")
        self._rows, self._snps, self._ancestries = n, s, A
        self.nnz0 = nnz0.astype(np.int64)
        self.nnz1 = nnz1.astype(np.int64)
        self.packed = packed  # (s*A, ceil(n/4)) 2-bit values 0..2
        self._read = True
        return self

    def rows(self):
        self._ensure()
        return self._rows

    def snps(self):
        self._ensure()
        return self._snps

    def ancestries(self):
        self._ensure()
        return self._ancestries

    def cols(self):
        self._ensure()
        return self._snps * self._ancestries

    def _ensure(self):
        if not self._read:
            self.read()

    def to_dense(self, n_threads: int = 1):
        """Dense int8 (n, s*A) of haplotype-sum counts."""
        self._ensure()
        return unpack_to_dense(self.packed, self._rows).astype(np.int8)
