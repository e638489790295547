"""Hardware ceilings and per-stage roofline accounting (twin of
eigensolver_gpu_tpu/utils/roofline.py).

Each stage is reported as a share of the ceiling it is bound by. The
ceilings are the published peaks of one NVIDIA H100 SXM (80 GB HBM3) at
its full power limit of 700 W, dense rates without sparsity, from NVIDIA's
H100 data sheet; a card set to a lower power limit runs below them, so a
share is stated with the card's name and power limit beside it
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``):

  bf16    989e12 FLOP/s  tensor cores
  f32      67e12 FLOP/s  outside the tensor cores (the port's 'highest'
                         paths keep TF32 off)
  f64      67e12 FLOP/s  fp64 tensor cores
  ozaki   ~35.3e12 FLOP/s  effective fp64 of ops/ozaki.py's digit products
                         at the bf16 peak: 989e12 over the s (s + 1) / 2
                         digit products of one fp64-class product, with
                         s = nslice_for(digit_bits_for(OZAKI_K)) digits
                         (28 products at k = 4096; fewer digits, so a
                         higher ceiling, at smaller k)
  hbm     3.35e12 B/s    HBM3

The keys and the arithmetic are JAX's; the labels are the card's. JAX's
``MXU`` (the TPU's matrix unit) is ``compute`` here: ``stage_roofline``
returns (compute_pct, hbm_pct, bound) with bound ``"compute"`` or
``"HBM"``, and ``format_row`` prints ``compute(<prec>)`` where JAX prints
``MXU(<prec>)``.
"""

from __future__ import annotations

from eigensolver_gpu_torch.ops.ozaki import digit_bits_for, nslice_for

OZAKI_K = 4096  # the inner dimension the ozaki ceiling holds for
BF16_FLOP_PER_S = 989e12


def ozaki_products(k: int = OZAKI_K) -> int:
    """Digit products of one fp64-class ozaki product of inner dimension k:
    the pairs (i, j) with i + j < s of s digits."""
    s = nslice_for(digit_bits_for(k))
    return s * (s + 1) // 2


CEILINGS = {
    "bf16": BF16_FLOP_PER_S,
    "f32": 67e12,
    "f64": 67e12,
    "ozaki": BF16_FLOP_PER_S / ozaki_products(),
    "hbm": 3.35e12,
}


def stage_roofline(ms, flops=0.0, prec="f32", bytes_hbm=0.0):
    """Return (compute_pct, hbm_pct, bound) for a stage.

    flops: real floating-point operations executed at precision ``prec``
    (use the effective-f64 count with prec='ozaki' for ozaki gemms).
    bytes_hbm: HBM bytes moved (reads + writes) by the stage's
    bandwidth-bound part.
    """
    t = ms * 1e-3
    compute = 100.0 * flops / CEILINGS[prec] / t if flops else 0.0
    hbm = 100.0 * bytes_hbm / CEILINGS["hbm"] / t if bytes_hbm else 0.0
    bound = "compute" if compute >= hbm else "HBM"
    return compute, hbm, bound


def format_row(name, ms, flops=0.0, prec="f32", bytes_hbm=0.0):
    compute, hbm, bound = stage_roofline(ms, flops, prec, bytes_hbm)
    return (
        f"  {name:14s}: {ms:9.1f} ms  "
        f"compute({prec}) {compute:5.1f}%  HBM {hbm:5.1f}%  [{bound}-bound]"
    )
