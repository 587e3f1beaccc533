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
K3 and K4 read a copy of ``u`` zero-padded to ``256 ceil(nb / 64)`` entries
(whole stages of every row: a stage is 16, 32 or 64 bytes), K5 its
operand, ``U^T`` in column blocks padded to ``64 ceil(nb / 16)`` samples
and to the block's column width (``many_operand``), so the tail codes past
``n`` contribute nothing; ``packed`` is never copied.  For a CPU
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

# samples of a K5 stage: 16 bytes of every row (MANY_KS in
# csrc/snp_kernels.cu)
MANY_STAGE = 64

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
    # the kernel builds its tables from u a stage at a time, up to 256
    # samples (64 bytes of a row) a stage
    u_pad = torch.zeros(256 * ((nb + 63) // 64), dtype=u.dtype,
                        device=u.device)
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


def many_block_cols(C):
    """The column width of K5's blocks for C residuals (``many_cols`` in
    ``csrc/snp_kernels.cu``): 2, 8, 32, or 64 in column blocks."""
    return 2 if C <= 2 else 8 if C <= 8 else 32 if C <= 32 else 64


def _many_shape(C, nb):
    cn = many_block_cols(C)
    return (C + cn - 1) // cn, MANY_STAGE * ((nb + 15) // 16), cn


def many_operand(U, nb):
    """K5's operand for ``U`` (C, n) and packed rows of ``nb`` bytes: U^T
    cut into column blocks of ``many_block_cols(C)`` columns, each
    sample-major, padded with zeros to ``MANY_STAGE * ceil(nb / 16)``
    samples (whole 16-byte stages of every row) and to a whole block of
    columns.  Shape (Cp / CN, n_pad, CN), on U's device; it depends on
    ``packed`` only through ``nb``, so a streamed pass builds it once for
    all its tiles."""
    C, n = U.shape
    cn = many_block_cols(C)
    op = torch.zeros(_many_shape(C, nb), dtype=U.dtype, device=U.device)
    for b in range(op.shape[0]):
        blk = U[b * cn:(b + 1) * cn]
        op[b, :n, :blk.shape[0]] = blk.T
    return op


def _launch_many(packed, U, impute, operand, p, nb):
    from .. import _build

    lib = _build.load()
    C = U.shape[0]
    if operand is None:
        operand = many_operand(U, nb)
    else:
        want = _many_shape(C, nb)
        if (tuple(operand.shape) != want or operand.dtype != U.dtype
                or operand.device != packed.device
                or not operand.is_contiguous()):
            raise ValueError(
                f"snp_mul_many: operand must be many_operand(U, {nb}), "
                f"{want} of {U.dtype} on {packed.device}, contiguous; got "
                f"{tuple(operand.shape)} of {operand.dtype} on "
                f"{operand.device}")
    # the kernel refuses a Cp other than its own adelie_snp_mul_many_cols(C)
    Cp = operand.shape[0] * operand.shape[2]
    out = torch.empty((p, C), dtype=U.dtype, device=U.device)
    fn = getattr(lib, f"adelie_snp_mul_many_{_SUFFIX[U.dtype]}")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(packed.data_ptr(), operand.data_ptr(), impute.data_ptr(),
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


def snp_mul_many(packed, U, impute, operand=None):
    """K5: ``decode(packed) @ U^T`` with code 3 -> ``impute[j]``; (p, C).
    ``operand``, ``many_operand(U, nb)`` built by a caller that multiplies
    many tiles by one ``U``, saves the kernel's copy of it; the twin takes
    ``U`` and ignores it."""
    if impute is None:
        raise TypeError("snp_mul_many: impute is required")
    p, nb, _ = _check("snp_mul_many", packed, U, impute, u_dims=2)
    if packed.device.type == "cpu":
        return snp_mul_many_ref(packed, U, impute)
    return _launch_many(packed, U, impute, operand, p, nb)


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
