"""The three packed-SNP decode-matmul kernels, their plain twins and counters.

Counterpart of ``adelie_tpu/matrix/_snp_pallas.py``:

* ``snp_mul`` (K3): ``out[j] = sum_i x(j, i) u[i]`` over the 2-bit codes of
  row j of ``packed``, a code 3 (NA) reading ``impute[j]``;
* ``snp_mul_no_na`` (K4): the same for codes 0..2 (phased ancestry), with
  no NA select;
* ``snp_mul_many`` (K5): ``out[j, c] = sum_i x(j, i) U[c, i]`` for C
  residuals in one pass over the bytes (the host-streamed matrix's
  products, ``_snp_stream.py``), NA as in K3.

``packed`` is (p, nb) uint8: row j holds sample i in byte ``i // 4``, bits
``2 (i % 4)``.  For a CUDA tensor each wrapper launches its kernel from
``csrc/snp_kernels.cu`` (built at first use, see ``_build.py``), or raises.
K3 and K4 read a copy of ``u`` zero-padded to ``16 ceil(nb / 4)`` entries (a
whole 4-byte word of every row), K5 a copy of ``U^T`` padded the same way
in samples and to its block's column width in residuals, so the tail
codes past ``n`` contribute nothing; ``packed`` is never copied.  For a CPU
tensor each wrapper runs its twin, ``snp_mul_ref``, ``snp_mul_no_na_ref``
or ``snp_mul_many_ref``: blocks of ``REF_BLOCK`` rows decoded and
multiplied by one ``torch.matmul`` each, as the JAX package's XLA path
does.

``launches`` counts kernel launches (never twin runs), so that a run can
show that its main path went through the kernels.
"""

import torch

from ..configs import matmul_precision

# rows decoded per twin block (the JAX package's chunk)
REF_BLOCK = 2048

launches = {"snp_mul": 0, "snp_mul_no_na": 0, "snp_mul_many": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def unpack_cols(packed_rows, n, dtype):
    """(k, nb) uint8 packed rows -> (n, k) codes of ``dtype``."""
    k, nb = packed_rows.shape
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed_rows.device)
    vals = (packed_rows[:, :, None] >> shifts) & 3
    return vals.reshape(k, 4 * nb)[:, :n].T.to(dtype)


def _check(what, packed, u, impute, u_dims=1):
    """Raise unless the arguments are what the kernel takes; return
    ``(p, nb, n)``.  ``u`` is (n,) for K3/K4 and (C, n), C >= 1, for K5."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"{what}: packed must be a 2-D uint8 tensor, got "
                        f"{packed.dtype} of shape {tuple(packed.shape)}")
    name = "u" if u_dims == 1 else "U"
    if u.dtype not in _SUFFIX:
        raise TypeError(f"{what}: {name} must be float32 or float64, got "
                        f"{u.dtype}")
    p, nb = packed.shape
    n = u.shape[-1] if u.dim() else 0
    if u.dim() != u_dims or u.numel() == 0 or not 1 <= n <= 4 * nb:
        want = "(n,)" if u_dims == 1 else "(C, n) with C >= 1 and"
        raise ValueError(f"{what}: {name} must be {want} 1 <= n <= 4 nb = "
                         f"{4 * nb}, got {tuple(u.shape)}")
    tensors = {"packed": packed, name: u}
    if impute is not None:
        if impute.dtype != u.dtype or tuple(impute.shape) != (p,):
            raise TypeError(f"{what}: impute must be ({p},) of {u.dtype}, got "
                            f"{impute.dtype} {tuple(impute.shape)}")
        tensors["impute"] = impute
    for key, t in tensors.items():
        if t.device != packed.device:
            raise ValueError(f"{what}: {key} is on {t.device}, packed on "
                             f"{packed.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {key} is not contiguous")
    if packed.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel or twin for device "
                         f"{packed.device}")
    return p, nb, n


def _launch(name, packed, u, impute, p, nb, n):
    from .. import _build

    lib = _build.load()
    # the kernel reads 16 entries of u per 4-byte word of a row
    u_pad = torch.zeros(16 * ((nb + 3) // 4), dtype=u.dtype, device=u.device)
    u_pad[:n] = u
    out = torch.empty(p, dtype=u.dtype, device=u.device)
    fn = getattr(lib, f"adelie_{name}_{_SUFFIX[u.dtype]}")
    ptrs = [packed.data_ptr(), u_pad.data_ptr()]
    if impute is not None:
        ptrs.append(impute.data_ptr())
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*ptrs, out.data_ptr(), p, nb, stream)
    _build.check(lib, code, name)
    launches[name] += 1
    return out


def _launch_many(packed, U, impute, p, nb, n):
    from .. import _build

    lib = _build.load()
    C = U.shape[0]
    Cp = lib.adelie_snp_mul_many_cols(C)
    # U^T, sample-major: 16 rows per 4-byte word of a row, Cp columns (C
    # rounded up to the kernel's column width)
    ut = torch.zeros((16 * ((nb + 3) // 4), Cp), dtype=U.dtype,
                     device=U.device)
    ut[:n, :C] = U.T
    out = torch.empty((p, C), dtype=U.dtype, device=U.device)
    fn = getattr(lib, f"adelie_snp_mul_many_{_SUFFIX[U.dtype]}")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(packed.data_ptr(), ut.data_ptr(), impute.data_ptr(),
                  out.data_ptr(), p, nb, C, Cp, stream)
    _build.check(lib, code, "snp_mul_many")
    launches["snp_mul_many"] += 1
    return out


def snp_mul(packed, u, impute):
    """K3: ``decode(packed) @ u`` with code 3 -> ``impute[j]``; (p,)."""
    p, nb, n = _check("snp_mul", packed, u, impute)
    if packed.device.type == "cpu":
        return snp_mul_ref(packed, u, impute)
    return _launch("snp_mul", packed, u, impute, p, nb, n)


def snp_mul_no_na(packed, u):
    """K4: ``decode(packed) @ u`` for codes 0..2; (p,)."""
    p, nb, n = _check("snp_mul_no_na", packed, u, None)
    if packed.device.type == "cpu":
        return snp_mul_no_na_ref(packed, u)
    return _launch("snp_mul_no_na", packed, u, None, p, nb, n)


def snp_mul_many(packed, U, impute):
    """K5: ``decode(packed) @ U^T`` with code 3 -> ``impute[j]``; (p, C)."""
    if impute is None:
        raise TypeError("snp_mul_many: impute is required")
    p, nb, n = _check("snp_mul_many", packed, U, impute, u_dims=2)
    if packed.device.type == "cpu":
        return snp_mul_many_ref(packed, U, impute)
    return _launch_many(packed, U, impute, p, nb, n)


def snp_mul_ref(packed, u, impute):
    """Plain twin of ``snp_mul``: same arguments, same results up to the
    order of the sums; ``impute=None`` is the twin of ``snp_mul_no_na``."""
    p = packed.shape[0]
    n = u.shape[0]
    out = torch.empty(p, dtype=u.dtype, device=u.device)
    for s in range(0, p, REF_BLOCK):
        e = min(s + REF_BLOCK, p)
        blk = unpack_cols(packed[s:e], n, u.dtype)
        if impute is not None:
            blk = torch.where(blk == 3, impute[None, s:e], blk)
        with matmul_precision():
            out[s:e] = u @ blk
    return out


def snp_mul_no_na_ref(packed, u):
    """Plain twin of ``snp_mul_no_na``."""
    return snp_mul_ref(packed, u, None)


def snp_mul_many_ref(packed, U, impute):
    """Plain twin of ``snp_mul_many``: same arguments, same results up to
    the order of the sums.  Column c is ``U[c] @ blk``, K3's twin product,
    so it does not depend on C (as in the kernel, where one thread sums a
    column in one order): the streamed driver's dry fit (C = 1) and its
    chunk check (C = 20) then give the same gradient at the same residual,
    and the tie at ``lmda_max`` stays a tie."""
    p = packed.shape[0]
    C, n = U.shape
    out = torch.empty((p, C), dtype=U.dtype, device=U.device)
    for s in range(0, p, REF_BLOCK):
        e = min(s + REF_BLOCK, p)
        blk = unpack_cols(packed[s:e], n, U.dtype)
        blk = torch.where(blk == 3, impute[None, s:e], blk)
        with matmul_precision():
            for c in range(C):
                out[s:e, c] = U[c] @ blk
    return out
