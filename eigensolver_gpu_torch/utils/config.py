"""Solver configuration (twin of eigensolver_gpu_tpu/utils/config.py).

The same frozen dataclass, field names, defaults and checks as the JAX
package, so one configuration can drive either package and a test can
hold the two against each other. Options whose code path has not been
ported yet are accepted here and refused with ``NotImplementedError``
where the solver would take them:

  * ``tridiag_mode='two'`` (planar two-stage reduction);
  * ``planar_solve_mode='trinv'`` (full block-doubled ``inv(L)``);
  * ``stedc_leaf`` solves in fp64, which need the Jacobi leaf.

``use_pallas`` keeps its JAX name: it selects the hand-written latrd
panel kernel (ops/latrd.py) for the hetrd column loop.
``mosaic_kernels`` is kept for parity and has no effect: the fp32
Cholesky always factors its diagonal blocks with kernel K1
(ops/pchol.py), which is the CUDA kernel on the card and its plain
version on CPU tensors.
``'auto'`` tridiagonalization stays one-stage, as the JAX package does
off-TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static tuning and policy knobs for the generalized eigensolver.

    See the JAX twin for the meaning of each field; the port reads
    nb_tridiag, nb_back, stedc_leaf, stedc_backend, compute_dtype,
    refine_iters, use_pallas, tridiag_mode, refine_margin,
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
