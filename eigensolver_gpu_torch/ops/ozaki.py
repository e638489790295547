"""Ozaki-style fp64-accurate matmul from exact integer-digit products (twin
of eigensolver_gpu_tpu/ops/ozaki.py).

The JAX package builds its fp64-class gemms this way because the TPU's
fp64 is emulated; the port keeps the function and its contract so the
refinement's ``gemm='ozaki'`` route can be held against the reference
(ops/refine.py, ops/refine_planar.py). The scheme:

1. scale row i of A (column j of B) by an exact power of two so its
   entries lie in (-1, 1];
2. split each scaled entry into ``nslice`` signed digits of ``dbits``
   bits (digit s weighs 2^{-(dbits-1) - dbits*s}) by round, subtract and
   scale-by-2^k only, so every digit is an integer that bf16 holds
   exactly;
3. multiply digit pairs (i, j) with i + j < nslice; a scalar product has
   at most 2*dbits significant bits and with k * 2^{2(dbits-1)} <= 2^24
   each k-term product is an EXACT fp32 integer sum;
4. combine the per-diagonal products in fp64 with their power-of-two
   weights and re-apply the row and column scales (exact multiplies).

Port differences:
  * exponents: ``_floor_log2`` reads the exponent of the value rounded to
    fp32 and rescales, as JAX does (it keeps JAX's result, which can sit
    one above floor(log2 x) for x just below a power of two), with
    ``torch.frexp`` in place of JAX's bit read; ``_pow2`` builds 2^e from
    the fp64 exponent field in two factors (exact on CPU and CUDA;
    ``torch.ldexp`` goes through ``pow``);
  * the digit gemms: digits are kept in bf16, as in JAX, and each pair
    product is a library gemm of those integers with an fp32 result
    (``_digit_dot``): on the CPU an fp32 product of the digits; on the
    card a bf16 product with an fp32 result (``torch.mm``'s
    ``out_dtype``). Both sums are exact, so both routes give JAX's bits;
  * every function takes leading batch axes (the k-point batches):
    slicings are ``(nslice, ..., rows, cols)``.

The only inexactness is the truncation after ``nslice`` digits
(~2^-(dbits*nslice) relative to the row and column maxima) and the fp64
combine's rounding. The combine runs in JAX's order (the highest-order
diagonal first), so the results are bit-identical to JAX wherever the
slicing is exact.
"""

from __future__ import annotations

import math

import torch


def digit_bits_for(k: int) -> int:
    """Largest digit width whose k-term fp32 accumulation stays exact:
    2(d-1) + ceil(log2 k) <= 24."""
    return max(2, min(7, (24 - max(0, math.ceil(math.log2(max(k, 1))))) // 2 + 1))


def nslice_for(dbits: int, bits: int = 48) -> int:
    """Digits needed so the truncation error is below 2^-bits (row-relative)."""
    return max(2, math.ceil(bits / dbits))


def _pow2_normal(e):
    """2^e as fp64 from the exponent field, for integer e in [-1022, 1023]."""
    return ((e.clamp(-1022, 1023) + 1023) << 52).view(torch.float64)


def _pow2(e):
    """Exact 2^e as fp64 for any integer tensor e: the product of two
    normal-range powers, so the result is exact down to the fp64
    denormals, 0 below them and inf above 2^1023 (JAX's ``_pow2``)."""
    e = torch.as_tensor(e).to(torch.int64)
    h = torch.div(e, 2, rounding_mode="floor")
    return _pow2_normal(h) * _pow2_normal(e - h)


def _floor_log2(x):
    """floor(log2(x)) for positive finite fp64 x, as JAX computes it: the
    exponent of x rounded to fp32 (clipped to [1e-37, 1e37]), then eight
    rescale-and-reread passes that reach the full fp64 range."""

    def f32_exp(v):
        return torch.frexp(v.clamp(1e-37, 1e37).float()).exponent.to(torch.int64) - 1

    e = f32_exp(x)
    for _ in range(8):  # ceil(1074 / 123) passes reach fp64 denormals
        e = e + f32_exp(x * _pow2(-e))
    return e


def ozaki_slice(a, axis, dbits, nslice):
    """Split fp64 ``a`` (..., rows, cols) into bf16 digit slices.

    axis=0: one scale a row (lhs operand); axis=1: one a column (rhs).
    Returns (digits (nslice, ..., rows, cols), e) with integer digits in
    [-2^{dbits-1}, 2^{dbits-1}] and 2^e the scale of each row (``e``
    (..., rows)) or column (``e`` (..., cols)), int32; the represented
    value is 2^e * sum_s digits[s] * 2^{-(dbits-1) - dbits*s}."""
    dim = -1 if axis == 0 else -2
    amax = a.abs().amax(dim=dim, keepdim=True)
    # scale = 2^(floor(log2 max)+1) >= max  ->  a/scale in [-1, 1]
    e = torch.where(amax > 0, _floor_log2(amax) + 1, 0)
    r = a * _pow2(-e) * float(2 ** (dbits - 1))
    digits = []
    for _ in range(nslice):
        d = torch.round(r)  # half to even, as jnp.round
        digits.append(d.to(torch.bfloat16))
        r = (r - d) * float(2**dbits)
    return torch.stack(digits), e.squeeze(dim).to(torch.int32)


def _digit_dot(x, y):
    """x @ y of bf16 digit matrices (leading axes a batch) as an fp32
    tensor holding the exact integer sums: a bf16 gemm with an fp32 result
    on the card, an fp32 gemm of the digits elsewhere (digits of at most 7
    bits are exact in any of these formats, TF32 included)."""
    if x.is_cuda:
        if x.dim() == 2:
            return torch.mm(x, y, out_dtype=torch.float32)
        lead = x.shape[:-2]
        out = torch.bmm(x.reshape((-1,) + x.shape[-2:]), y.reshape((-1,) + y.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(lead + out.shape[-2:])
    return x.float() @ y.float()


def _pair_dots(da, db, nslice, transpose_lhs=False):
    """All digit-pair gemms grouped by diagonal d = i + j < nslice: one fp32
    product a diagonal, the exact integer sum of its pair gemms (pairs of a
    diagonal are summed in fp32 in increasing i, as JAX does).

    transpose_lhs: contract the rows of the lhs digits (lhs^T @ rhs from
    untransposed slices), so one slicing of X serves X as the rhs and X^H
    as the lhs (X's column scales are X^T's row scales)."""
    prods = []
    for d in range(nslice):
        acc = None
        for i in range(max(0, d - (nslice - 1)), min(d, nslice - 1) + 1):
            lhs = da[i].mT if transpose_lhs else da[i]
            p = _digit_dot(lhs, db[d - i])
            acc = p if acc is None else acc + p
        prods.append(acc)
    return prods


def _combine(prods, ea, eb, dbits):
    """fp64 weighted combine of the per-diagonal exact fp32 products, the
    highest-order diagonal first, then the row and column scales."""
    out = None
    for d, p in enumerate(prods):
        w = 2.0 ** (-2 * (dbits - 1) - dbits * d)
        term = p.double() * w
        out = term if out is None else out + term
    return out * _pow2(ea)[..., :, None] * _pow2(eb)[..., None, :]


def ozaki_matmul_pre(pa, pb, dbits, transpose_lhs=False, negate=False):
    """Product from pre-computed slicings (see ozaki_slice): ``pa`` sliced
    with axis=0 (row scales), or with axis=1 under ``transpose_lhs`` (the
    transposed operand's row scales); ``pb`` sliced with axis=1."""
    da, ea = pa
    db, eb = pb
    out = _combine(_pair_dots(da, db, da.shape[0], transpose_lhs), ea, eb, dbits)
    return -out if negate else out


def ozaki_matmul(a, b, dbits=None, nslice=None, bits=48):
    """fp64-accurate ``a @ b`` via exact digit products; a (..., n, k),
    b (..., k, m) fp64. Accuracy ~2^-bits relative to rowmax(a) *
    colmax(b)."""
    k = a.shape[-1]
    if dbits is None:
        dbits = digit_bits_for(k)
    if nslice is None:
        nslice = nslice_for(dbits, bits)
    da, ea = ozaki_slice(a, 0, dbits, nslice)
    db, eb = ozaki_slice(b, 1, dbits, nslice)
    return _combine(_pair_dots(da, db, nslice), ea, eb, dbits)


def ozaki_pmatmul(x, y, dbits=None, nslice=None, bits=48):
    """Planar complex product via three Karatsuba ozaki gemms."""
    m1 = ozaki_matmul(x[0], y[0], dbits, nslice, bits)
    m2 = ozaki_matmul(x[1], y[1], dbits, nslice, bits)
    m3 = ozaki_matmul(x[0] + x[1], y[0] + y[1], dbits, nslice, bits)
    return (m1 - m2, m3 - m1 - m2)


def ozaki_matmul_chunked(a, b, chunk=None, bits=48):
    """ozaki_matmul with b's columns ``chunk`` at a time: the lhs is sliced
    once, and only one chunk's rhs slices and output are alive at once.
    A column's slicing does not depend on the chunk, so the result is the
    unchunked one."""
    m = b.shape[-1]
    if chunk is None or chunk >= m or m % chunk != 0:
        return ozaki_matmul(a, b, bits=bits)
    dbits = digit_bits_for(a.shape[-1])
    nslice = nslice_for(dbits, bits)
    da, ea = ozaki_slice(a, 0, dbits, nslice)
    parts = []
    for c in range(0, m, chunk):
        db, eb = ozaki_slice(b[..., c : c + chunk], 1, dbits, nslice)
        parts.append(_combine(_pair_dots(da, db, nslice), ea, eb, dbits))
    return torch.cat(parts, -1)


def ozaki_pmatmul_chunked(x, y, chunk=None, bits=48):
    """Chunked planar complex product via three Karatsuba ozaki gemms."""
    m1 = ozaki_matmul_chunked(x[0], y[0], chunk, bits)
    m2 = ozaki_matmul_chunked(x[1], y[1], chunk, bits)
    m3 = ozaki_matmul_chunked(x[0] + x[1], y[0] + y[1], chunk, bits)
    return (m1 - m2, m3 - m1 - m2)


def ozaki_planar_slices(p, axis, dbits, nslice, conj=False):
    """Slicings of the Karatsuba components (Re, Im, Re+Im) of a planar
    pair, or (Re, Im, Re-Im) with ``conj`` (a conjugated lhs, whose Im
    negation ozaki_pmatmul_pre's ``conj_lhs`` applies at combine time)."""
    third = p[0] - p[1] if conj else p[0] + p[1]
    return (
        ozaki_slice(p[0], axis, dbits, nslice),
        ozaki_slice(p[1], axis, dbits, nslice),
        ozaki_slice(third, axis, dbits, nslice),
    )


def ozaki_pmatmul_pre(lhs3, rhs3, dbits, transpose_lhs=False, conj_lhs=False):
    """Planar Karatsuba product from pre-computed component slicings (lhs
    axis=0, or axis=1 with ``transpose_lhs``; rhs axis=1). ``conj_lhs``
    computes conj(L)-style products: (u1 + i u2)(Yr + i Yi), u2 = -Im."""
    m1 = ozaki_matmul_pre(lhs3[0], rhs3[0], dbits, transpose_lhs)
    m2 = ozaki_matmul_pre(lhs3[1], rhs3[1], dbits, transpose_lhs, negate=conj_lhs)
    m3 = ozaki_matmul_pre(lhs3[2], rhs3[2], dbits, transpose_lhs)
    return (m1 - m2, m3 - m1 - m2)
