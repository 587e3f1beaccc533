"""Host-streamed packed SNP matrix: the out-of-HBM GWAS path.

Counterpart of ``adelie_tpu/matrix/_snp_stream.py``.  The packed bytes
(p, ceil(n/4)) uint8 stay in host memory and every full-matrix product
sweeps tiles of ``tile_snps`` SNP rows through the device.  ``mul_many``
computes ``X^T U_c`` for all C rows of ``U`` in one pass, one K5 launch
(``snp_kernels.snp_mul_many``) a tile on the kernel's operand, built once
a pass, so a whole lambda chunk's KKT gradients cost one pass over the
bytes (``solver/streamed.py``).
``sq_mul`` and ``tmul`` decode each tile with plain tensor code, as the JAX
package leaves them to XLA; ``tmul`` visits only the tiles that hold a
nonzero coefficient.  ``gather`` takes the rows on the host and decodes
them on the device.  ``sweeps`` counts full passes (``mul_many``,
``sq_mul``).

Copies.  On a CUDA device, tile k + 1 is copied on a stream of its own
into one of two device buffers while K5 runs on tile k; events order the
two streams, so a buffer is rewritten only after the kernels that read
it have finished.  The JAX package's ``stream_h2d_overlap`` switch, which
serialises the copies for relayed TPU transports, is left out: the card's
copies run over PCIe on their own stream.  A copy
overlaps compute only from page-locked memory, and at the north star the
panel is 25 GB: a second, pinned host copy would double the host memory,
and a per-tile memcpy into pinned staging buffers would run at host
memcpy speed beside the PCIe copy.  So the matrix page-locks the io's own
buffer in place (``cudaHostRegister``) for its lifetime; a registration
that fails raises with the CUDA error, and nothing falls back to pageable
copies.  On the CPU the tiles are views of the host array: no copies.

Left out, as the port needs neither: the JAX package pads C to a power of
two and the last tile to a full tile to bound XLA compiles; K5 takes any
C >= 1 and the tile's real row count.  Not ported: ``mesh`` sharding
(ROADMAP.md: scale-out) and ``mul_spec``, which raises as in the JAX package.
"""

import warnings
import weakref

import numpy as np
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from . import snp_kernels
from .base import MatrixNaiveBase
from .snp_kernels import unpack_cols

__all__ = ["MatrixNaiveSNPUnphasedStreamed"]

# cudaHostRegister flags (cuda_runtime_api.h)
_REGISTER_DEFAULT = 0
_REGISTER_READ_ONLY = 8

# host buffers page-locked by streamed matrices: data pointer -> [matrices
# using it, bytes].  CUDA keeps one registration a buffer per process, and
# a second cudaHostRegister of it fails, so two matrices over one io share
# the registration; the buffer is unregistered when its last matrix goes.
_registered = {}


def _register(arr):
    ptr, nbytes = arr.ctypes.data, arr.nbytes
    entry = _registered.get(ptr)
    if entry is not None and entry[1] == nbytes:
        entry[0] += 1
        return
    flags = _REGISTER_DEFAULT if arr.flags.writeable else _REGISTER_READ_ONLY
    err = int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, flags))
    if err != 0:
        raise RuntimeError(
            f"cudaHostRegister of the {nbytes / 1e9:.2f} GB packed panel "
            f"failed with CUDA error {err}: the streamed matrix copies tiles "
            "only from page-locked memory")
    _registered[ptr] = [1, nbytes]


def _unregister(ptr, arr):
    """Drop one matrix's use of the buffer at ``ptr``; ``arr`` is passed so
    that the buffer outlives its registration."""
    entry = _registered[ptr]
    entry[0] -= 1
    if entry[0] == 0:
        del _registered[ptr]
        torch.cuda.cudart().cudaHostUnregister(ptr)


class MatrixNaiveSNPUnphasedStreamed(MatrixNaiveBase):
    """SNP unphased matrix streamed from host memory in SNP tiles, over an
    IO handler with ``packed``, ``impute``, ``rows()`` and ``snps()``."""

    is_streaming = True
    _CHUNK = 2048   # rows decoded at once by sq_mul and tmul

    def __init__(self, io, *, dtype=None, device=None, tile_snps=65536):
        if hasattr(io, "_ensure"):
            io._ensure()
        self.dtype = np.dtype(dtype or np.float32)
        if self.dtype not in TORCH_DTYPE:
            raise TypeError(f"SNP matrices are float32 or float64, not "
                            f"{self.dtype}")
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = resolve_device(device)
        self._rows = int(io.rows())
        self._cols = int(io.snps())
        packed = np.ascontiguousarray(np.asarray(io.packed), np.uint8)
        self._nb = (self._rows + 3) // 4
        if packed.shape != (self._cols, self._nb):
            raise ValueError(f"packed must be ({self._cols}, {self._nb}) for "
                             f"{self._rows} rows, got {packed.shape}")
        if int(tile_snps) < 1:
            raise ValueError(f"tile_snps must be >= 1, got {tile_snps}")
        self._packed_host = packed
        with warnings.catch_warnings():
            # a read-only panel (a memmap opened "r") is only ever read
            warnings.simplefilter("ignore", UserWarning)
            self._host = torch.from_numpy(packed)
        self._impute = torch.as_tensor(
            np.asarray(io.impute, self.dtype), device=self.device)
        self._tile = int(min(int(tile_snps), max(256, self._cols)))
        self._ntiles = (self._cols + self._tile - 1) // self._tile
        self._bufs = []
        self._copy_stream = None
        self.sweeps = 0
        if self.device.type == "cuda" and packed.nbytes:
            _register(packed)
            fin = weakref.finalize(self, _unregister, packed.ctypes.data,
                                   packed)
            fin.atexit = False   # the process's exit releases the pages

    # ------------------------------------------------------------------ #
    # tiles                                                               #
    # ------------------------------------------------------------------ #

    def _bounds(self, k):
        s = k * self._tile
        return s, min(s + self._tile, self._cols)

    def _buffer(self, i):
        while len(self._bufs) <= i:
            buf = torch.empty((self._tile, self._nb), dtype=torch.uint8,
                              device=self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            # the copy stream writes it: the allocator must not hand its
            # memory out again before those copies have run
            buf.record_stream(self._copy_stream)
            self._bufs.append(buf)
        return self._bufs[i]

    def _tiles(self, ks=None):
        """Yield ``(s, e, tile)`` for the tiles ``ks`` (all by default) in
        order: rows ``s:e`` of the panel as a (e - s, nb) uint8 tensor on
        the device.  The consumer enqueues its kernels on the tile before
        it asks for the next one."""
        ks = list(range(self._ntiles) if ks is None else ks)
        if self.device.type == "cpu":
            for k in ks:
                s, e = self._bounds(k)
                yield s, e, self._host[s:e]
            return
        compute = torch.cuda.current_stream(self.device)
        bufs = [self._buffer(0), self._buffer(1)]
        copy = self._copy_stream
        # the first copies wait for whatever earlier work reads the buffers
        copy.wait_stream(compute)
        ready = [torch.cuda.Event(), torch.cuda.Event()]
        free = [None, None]

        def put(i):
            b = i % 2
            s, e = self._bounds(ks[i])
            with torch.cuda.stream(copy):
                if free[b] is not None:
                    copy.wait_event(free[b])
                bufs[b][:e - s].copy_(self._host[s:e], non_blocking=True)
                ready[b].record(copy)

        if ks:
            put(0)
        for i, k in enumerate(ks):
            if i + 1 < len(ks):
                put(i + 1)
            b = i % 2
            compute.wait_event(ready[b])
            s, e = self._bounds(k)
            yield s, e, bufs[b][:e - s]
            # the kernels the consumer enqueued on tile i read buffer b
            free[b] = torch.cuda.Event()
            free[b].record(compute)

    def _decode(self, rows, imp):
        """(n, k) dense block of the k device rows ``rows``, whose impute
        values are ``imp``."""
        codes = unpack_cols(rows, self._rows, self.torch_dtype)
        return torch.where(codes == 3, imp[None, :], codes)

    def _chunks(self, ks=None):
        for s, e, tile in self._tiles(ks):
            for a in range(0, e - s, self._CHUNK):
                b = min(a + self._CHUNK, e - s)
                yield s + a, s + b, self._decode(
                    tile[a:b], self._impute[s + a:s + b])

    # ------------------------------------------------------------------ #
    # protocol                                                            #
    # ------------------------------------------------------------------ #

    def mul_spec(self):
        raise NotImplementedError(
            "streamed SNP matrices keep their bytes on the host; the gaussian "
            "driver runs the streamed-KKT path instead (solver/streamed.py)")

    def gather(self, indices):
        """Decode the columns ``indices``: host take, device decode."""
        if isinstance(indices, torch.Tensor):
            indices = indices.cpu().numpy()
        idx = np.asarray(indices, np.int64)
        rows = torch.from_numpy(self._packed_host[idx]).to(self.device)
        return self._decode(
            rows, self._impute[torch.as_tensor(idx, device=self.device)])

    def mul(self, v, w):
        like = dict(dtype=self.torch_dtype, device=self.device)
        v, w = torch.as_tensor(v, **like), torch.as_tensor(w, **like)
        return self.mul_many((v * w)[None, :])[:, 0]

    def mul_many(self, U):
        """``X^T U_c`` for every row of ``U`` (C, n), already weighted, in
        one pass over the packed bytes; (p, C) on the device."""
        U = torch.as_tensor(U, dtype=self.torch_dtype,
                            device=self.device).contiguous()
        if U.dim() != 2 or U.shape[1] != self._rows:
            raise ValueError(f"U must be (C, {self._rows}), got "
                             f"{tuple(U.shape)}")
        out = torch.empty((self._cols, U.shape[0]), dtype=self.torch_dtype,
                          device=self.device)
        # the tiles share n: K5's padded U^T is made once a pass
        op = (snp_kernels.many_operand(U, self._nb)
              if self.device.type == "cuda" else None)
        for s, e, tile in self._tiles():
            out[s:e] = snp_kernels.snp_mul_many(tile, U, self._impute[s:e],
                                                operand=op)
        self.sweeps += 1
        return out

    def sq_mul(self, w):
        w = torch.as_tensor(w, dtype=self.torch_dtype, device=self.device)
        out = torch.empty(self._cols, dtype=self.torch_dtype,
                          device=self.device)
        with matmul_precision():
            for s, e, blk in self._chunks():
                out[s:e] = w @ (blk * blk)
        self.sweeps += 1
        return out

    def tmul(self, beta):
        """``X @ beta`` for ``beta`` (p,) or (p, L), over the tiles that
        hold a nonzero coefficient only."""
        beta = torch.as_tensor(beta, dtype=self.torch_dtype,
                               device=self.device)
        rows_nz = torch.nonzero((beta.reshape(self._cols, -1) != 0)
                                .any(dim=1))[:, 0]
        ks = torch.unique(rows_nz // self._tile).tolist()
        out = torch.zeros((self._rows,) + tuple(beta.shape[1:]),
                          dtype=self.torch_dtype, device=self.device)
        with matmul_precision():
            for s, e, blk in self._chunks(ks):
                out = out + blk @ beta[s:e]
        return out
