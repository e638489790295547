"""Meshes, collectives, batched and sharded solves (twin of
eigensolver_gpu_tpu/parallel/).

* ``parallel.mesh``    -- ``make_mesh``: a ('dp', 'tp') DeviceMesh over the
                          ranks of the default torch.distributed group;
* ``parallel.comm``    -- the collectives the sharded stages call (no JAX
                          twin: there the SPMD partitioner inserts them);
* ``parallel.sharded`` -- ``sygvdx_batched`` (one card), the tensor-parallel
                          large-n solve ``sygvdx_sharded`` (BASELINE.md
                          config 5) and the data-parallel batched solves
                          ``sygvdx_batched_sharded`` and
                          ``zhegvdx_planar_batched_sharded`` (config 4);
* ``parallel.dryrun``  -- ``dryrun_multichip``: JAX's multi-chip dry run,
                          in a world of ranks it starts.

The names are loaded on first use, so that the stages under ``ops/`` can
import ``parallel.comm`` without importing the drivers.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "sygvdx_sharded": "sharded",
    "sygvdx_batched": "sharded",
    "sygvdx_batched_sharded": "sharded",
    "zhegvdx_planar_batched_sharded": "sharded",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
