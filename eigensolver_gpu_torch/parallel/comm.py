"""The collectives of the sharded solves, on one dimension of a mesh
(``parallel/mesh.py``). No JAX twin: there the SPMD partitioner inserts
the collectives; here each sharded stage calls them itself.

Every function takes the mesh and the name of a dimension ('tp' by
default) and runs on that dimension's process group. Under NCCL the
tensors stay on the card. Under gloo a CUDA tensor is copied to a host
buffer, reduced or gathered there and copied back, in this module's own
code: gloo takes only some collectives on CUDA tensors. That is the route
of a world whose ranks share one card (NCCL refuses two ranks on one
device); CPU tensors go to gloo as they are. ``reduce_scatter`` under
gloo is an all-reduce of which each rank keeps its block.

``calls`` counts the calls by collective and ``stages`` by the stage
that made them (the ``what`` argument), for the tests and the smoke, as
the kernel wrappers count their launches; ``reset`` zeroes both.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

calls: collections.Counter = collections.Counter()
stages: collections.Counter = collections.Counter()


def reset() -> None:
    calls.clear()
    stages.clear()


def size(mesh, dim="tp") -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim))


def rank(mesh, dim="tp") -> int:
    return mesh.get_local_rank(dim)


def device(mesh) -> torch.device:
    """The device of this rank's tensors: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def row_range(n, mesh, dim="tp"):
    """(lo, hi): this rank's ``n / size`` contiguous rows of n; None when
    there is no mesh or the rows do not split evenly (the stage then runs
    whole on every rank, as JAX's ``_maybe_row_shard`` leaves such an
    operand as it is)."""
    if mesh is None:
        return None
    s = size(mesh, dim)
    if n % s != 0:
        return None
    r = rank(mesh, dim)
    return r * (n // s), (r + 1) * (n // s)


def row_block(x, mesh, dim="tp"):
    """This rank's rows of x (rows: the second-last axis), a view; x
    itself where ``row_range`` is None."""
    rows = row_range(x.shape[-2], mesh, dim)
    return x if rows is None else x[..., rows[0] : rows[1], :]


def _count(name, what):
    calls[name] += 1
    stages[what] += 1


def _staged(x, group):
    """Whether x goes through a host buffer (gloo with a CUDA tensor)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x, mesh, dim="tp", axis=-2, what=""):
    """Every rank's x concatenated along ``axis`` in rank order (row
    blocks into the whole matrix by default)."""
    _count("all_gather", what)
    group = mesh.get_group(dim)
    host = _staged(x, group)
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(size(mesh, dim))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, axis)
    return out.to(x.device) if host else out


def all_reduce(x, mesh, dim="tp", op=dist.ReduceOp.SUM, what=""):
    """The elementwise reduction (sum by default) of every rank's x."""
    _count("all_reduce", what)
    group = mesh.get_group(dim)
    host = _staged(x, group)
    out = x.cpu() if host else x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.device) if host else out


def reduce_scatter(x, mesh, dim="tp", what=""):
    """This rank's row block (``row_range``) of the sum of every rank's x
    (rows: the second-last axis, which the dimension's size divides)."""
    _count("reduce_scatter", what)
    group = mesh.get_group(dim)
    lo, hi = row_range(x.shape[-2], mesh, dim)
    if dist.get_backend(group) == "gloo":
        host = x.is_cuda
        out = x.cpu() if host else x.clone()
        dist.all_reduce(out, group=group)
        out = out[..., lo:hi, :].contiguous()
        return out.to(x.device) if host else out
    src = x.movedim(-2, 0).contiguous()
    out = torch.empty((hi - lo,) + src.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, -2)
