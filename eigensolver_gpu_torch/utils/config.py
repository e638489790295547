"""Solver configuration (twin of eigensolver_gpu_tpu/utils/config.py).

The same frozen dataclass, field names, defaults and checks as the JAX
package, so one configuration can drive either package and a test can
hold the two against each other. Options whose code path has not been
ported yet are accepted here and refused with ``NotImplementedError``
where the solver would take them:

  * ``planar_solve_mode='trinv'`` (full block-doubled ``inv(L)``);
  * ``gemm='ozaki'`` in the refinement (ops/refine.py, ops/refine_planar.py).

``use_pallas`` keeps its JAX name: it selects the hand-written latrd
panel kernel (ops/latrd.py) for the planar hetrd column loop, and the
upper-tile symv kernel (ops/symv.py) for the real sytrd column loop.
``mosaic_kernels`` keeps its JAX name too: on the two-stage paths, real
and planar, it selects the kernel wrappers for the QL panel, the bulge
chase and the replay (ops/ql_panel.py, ops/chase.py, ops/replay.py: the
CUDA kernels on the card, their plain versions on CPU tensors), and on the
planar path the Cholesky-block kernel of the fp32 factorization
(ops/pchol.py, through ``pcholesky_lower(block_kernel=...)``); False takes
the plain torch functions of ops/sbrd.py, ops/sb2st.py, their planar
twins and ops/planar.py.
``'auto'`` tridiagonalization follows the JAX rule: on real input
two-stage for fp64 compute at n >= ``two_stage_min_n`` and one-stage for
fp32 compute (models/syevdx.py); on the planar path one-stage at every n
(models/zhegvdx_planar.py): ``planar_two_stage_min_n`` is kept so that one
configuration drives both packages, and is not read here until a
benchmark on the card sets it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static tuning and policy knobs for the generalized eigensolver.

    See the JAX twin for the meaning of each field; the port reads
    nb_sygst, nb_tridiag, nb_back, stedc_leaf, stedc_backend,
    sygst_mode, compute_dtype, refine_iters, use_pallas, tridiag_mode,
    band, two_stage_min_n, replay_g, mosaic_kernels, refine_margin,
    refine_extra_max and planar_solve_mode.
    """

    nb_sygst: int = 512
    nb_tridiag: int = 32
    nb_back: int = 128
    stedc_leaf: int = 64
    stedc_backend: str = "dc"
    sygst_mode: str = "full"
    compute_dtype: Optional[str] = None
    refine_iters: int = 2
    use_pallas: bool = False
    tridiag_mode: str = "auto"
    band: int = 32
    two_stage_min_n: int = 4096
    planar_two_stage_min_n: int = 8192
    replay_g: int = 0
    refine_margin: int = 32
    refine_extra_max: int = 2
    planar_solve_mode: str = "blockinv"
    mosaic_kernels: bool = True

    def __post_init__(self):
        if self.planar_solve_mode not in ("blockinv", "trinv", "subst"):
            raise ValueError(
                f"unknown planar_solve_mode {self.planar_solve_mode!r}"
            )
        if self.stedc_backend not in ("dc", "xla"):
            raise ValueError(f"unknown stedc_backend {self.stedc_backend!r}")
        if self.sygst_mode not in ("blocked", "full", "inv", "trinv"):
            raise ValueError(f"unknown sygst_mode {self.sygst_mode!r}")
        if self.tridiag_mode not in ("one", "two", "auto"):
            raise ValueError(f"unknown tridiag_mode {self.tridiag_mode!r}")
        if self.nb_tridiag < 1 or self.nb_back < 1 or self.nb_sygst < 1:
            raise ValueError("block sizes must be positive")
        if self.band < 2:
            raise ValueError("band must be >= 2")


DEFAULT_CONFIG = SolverConfig()
