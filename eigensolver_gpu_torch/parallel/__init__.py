"""Batched solves (twin of eigensolver_gpu_tpu/parallel/).

``parallel.sharded.sygvdx_batched`` solves a batch of independent
(A_k, B_k) pairs on one card, one batched solve on either reduction
(``use_pallas=True`` alone goes item by item). The JAX package's meshes
and sharded solves (``make_mesh``, ``sygvdx_sharded``,
``sygvdx_batched_sharded``, ``zhegvdx_planar_batched_sharded``) are not
ported yet.
"""

from eigensolver_gpu_torch.parallel.sharded import sygvdx_batched

__all__ = ["sygvdx_batched"]
