"""The two packed-SNP decode-matmul kernels, their plain twins and counters.

Counterpart of ``adelie_tpu/matrix/_snp_pallas.py``:

* ``snp_mul`` (K3): ``out[j] = sum_i x(j, i) u[i]`` over the 2-bit codes of
  row j of ``packed``, a code 3 (NA) reading ``impute[j]``;
* ``snp_mul_no_na`` (K4): the same for codes 0..2 (phased ancestry), with
  no NA select.

``packed`` is (p, nb) uint8: row j holds sample i in byte ``i // 4``, bits
``2 (i % 4)``.  For a CUDA tensor each wrapper launches its kernel from
``csrc/snp_kernels.cu`` (built at first use, see ``_build.py``) on a copy of
``u`` zero-padded to ``16 ceil(nb / 4)`` entries (a whole 4-byte word of
every row), so the tail codes past ``n`` contribute nothing, or raises;
for a CPU tensor it runs the twin, ``snp_mul_ref`` or
``snp_mul_no_na_ref``: blocks of ``REF_BLOCK`` rows decoded and
multiplied by one ``torch.matmul`` each, as the JAX package's XLA path
does.

``launches`` counts kernel launches (never twin runs), so that a run can
show that its main path went through the kernels.
"""

import torch

from ..configs import matmul_precision

# rows decoded per twin block (the JAX package's chunk)
REF_BLOCK = 2048

launches = {"snp_mul": 0, "snp_mul_no_na": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def unpack_cols(packed_rows, n, dtype):
    """(k, nb) uint8 packed rows -> (n, k) codes of ``dtype``."""
    k, nb = packed_rows.shape
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed_rows.device)
    vals = (packed_rows[:, :, None] >> shifts) & 3
    return vals.reshape(k, 4 * nb)[:, :n].T.to(dtype)


def _check(what, packed, u, impute):
    """Raise unless the arguments are what the kernel takes; return
    ``(p, nb, n)``."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"{what}: packed must be a 2-D uint8 tensor, got "
                        f"{packed.dtype} of shape {tuple(packed.shape)}")
    if u.dtype not in _SUFFIX:
        raise TypeError(f"{what}: u must be float32 or float64, got {u.dtype}")
    p, nb = packed.shape
    n = u.numel()
    if u.dim() != 1 or not 1 <= n <= 4 * nb:
        raise ValueError(f"{what}: u must be (n,) with 1 <= n <= 4 nb = "
                         f"{4 * nb}, got {tuple(u.shape)}")
    tensors = {"packed": packed, "u": u}
    if impute is not None:
        if impute.dtype != u.dtype or tuple(impute.shape) != (p,):
            raise TypeError(f"{what}: impute must be ({p},) of {u.dtype}, got "
                            f"{impute.dtype} {tuple(impute.shape)}")
        tensors["impute"] = impute
    for name, t in tensors.items():
        if t.device != packed.device:
            raise ValueError(f"{what}: {name} is on {t.device}, packed on "
                             f"{packed.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
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
