"""Device meshes for the sharded solves (twin of
eigensolver_gpu_tpu/parallel/mesh.py).

The JAX function lays ``jax.devices()`` out as a ('dp', 'tp') mesh; here
the ranks of the default ``torch.distributed`` process group take the
place of the devices, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose two dimensions carry
JAX's names. The process group is the caller's to initialise (NCCL with
each rank on ``cuda:{LOCAL_RANK}`` on the card, gloo on the CPU); this
module never does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def make_mesh(n_devices=None, dp=1, device_type="cuda"):
    """A ('dp', 'tp') mesh over the first ``n_devices`` ranks.

    'tp' splits the matrix rows of a single large solve (tensor
    parallel); 'dp' splits a batch of independent solves (QE k-points).
    Defaults to all ranks on 'tp'. Every rank of the default group calls
    it (building the mesh's groups is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if n_devices % dp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by dp={dp}")
    from torch.distributed.device_mesh import DeviceMesh

    tp = n_devices // dp
    return DeviceMesh(device_type, torch.arange(n_devices).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))
