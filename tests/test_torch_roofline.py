"""The port's roofline module (eigensolver_gpu_torch/utils/roofline.py)
against the JAX package's: the same keys and arithmetic, the H100's
published ceilings in place of the TPU's measured ones, and the card's
labels in place of the TPU's."""

import pytest

from eigensolver_gpu_tpu.utils import roofline as jax_roofline
from eigensolver_gpu_torch.ops.ozaki import digit_bits_for, nslice_for
from eigensolver_gpu_torch.utils import roofline

# NVIDIA H100 SXM data sheet, dense, 700 W: bf16 and fp32 (outside the tensor
# cores) FLOP/s, fp64 tensor-core FLOP/s, HBM3 bytes/s; the ozaki products run
# at the bf16 rate
PUBLISHED = {"bf16": 989e12, "f32": 67e12, "f64": 67e12, "ozaki": 989e12, "hbm": 3.35e12}

STAGES = [
    (12.5, 3e12, "f32", 0.0),
    (0.25, 0.0, "f32", 4e9),
    (40.0, 2e13, "bf16", 1e9),
    (3.0, 1e11, "f64", 2e11),
    (100.0, 1.1e12, "ozaki", 5e10),
    (7.0, 0.0, "f32", 0.0),
]


def test_ceilings_have_the_jax_keys():
    assert set(roofline.CEILINGS) == set(jax_roofline.CEILINGS)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_roofline_and_format_row_match_jax(stage, monkeypatch):
    """With JAX's ceilings set to the port's, the same shares and bound and
    the same row, JAX's MXU labels read as the card's compute labels."""
    for key, value in roofline.CEILINGS.items():
        monkeypatch.setitem(jax_roofline.CEILINGS, key, value)
    ms, flops, prec, nbytes = stage
    compute, hbm, bound = roofline.stage_roofline(ms, flops, prec, nbytes)
    mxu, jhbm, jbound = jax_roofline.stage_roofline(ms, flops, prec, nbytes)
    assert (compute, hbm) == (mxu, jhbm)
    assert bound == {"MXU": "compute", "HBM": "HBM"}[jbound]
    row = roofline.format_row("stage", ms, flops, prec, nbytes)
    jrow = jax_roofline.format_row("stage", ms, flops, prec, nbytes)
    assert row == jrow.replace("MXU(", "compute(").replace("[MXU-", "[compute-")


def test_ozaki_ceiling_is_bf16_over_its_digit_products():
    s = nslice_for(digit_bits_for(4096))
    assert s * (s + 1) // 2 == 28 == roofline.ozaki_products(4096)
    assert roofline.CEILINGS["ozaki"] == roofline.CEILINGS["bf16"] / 28


def test_no_ceiling_above_its_published_peak():
    for key, peak in PUBLISHED.items():
        assert 0 < roofline.CEILINGS[key] <= peak, key
