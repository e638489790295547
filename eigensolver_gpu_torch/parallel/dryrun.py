"""Worlds of ranks for the sharded solves, and the multi-chip dry run
(twin of ``dryrun_multichip`` in the JAX package's __graft_entry__.py).

``run_world(world, fn, args)`` starts ``world`` ranks with
``torch.multiprocessing`` (spawn), initialises their default process group
on a fresh TCP store on localhost (gloo on the CPU, NCCL on the card with
rank r on ``cuda:r``; the caller may name the backend), runs
``fn(*args)`` on every rank and returns rank 0's result. ``fn`` must be a
function of a module the ranks can import without the caller's own
modules: the child processes import this package, not the caller's.

``run_calls`` is such a function for tests and checks: it calls the
sharded entry points by name on arguments the caller made (numpy arrays,
configurations), each on a mesh of the given shape, and returns each
call's outputs as numpy arrays beside the collectives it made
(``parallel/comm.py``'s counters) and the kernels it launched (the
wrappers' counters), or the error it raised.

``dryrun_multichip(n_devices)`` runs JAX's five checks in a world of
``n_devices`` ranks at JAX's shapes (n = 64, ``stedc_leaf=16``, dp = 2
where the rank count is even): the tp solve, the dp batch, the planar
solve, the planar dp batch and the two-stage tp solve with band 8; each
must return ``info == 0`` everywhere.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device_type, backend, job, out):
    with open(job, "rb") as f:
        fn, args = pickle.load(f)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run_world(world, fn, args=(), device_type="cpu", backend=None):
    """Run ``fn(*args)`` on ``world`` ranks of a new process group; returns
    rank 0's result. A rank that raises fails the call (its traceback is
    in the exception)."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        # the job goes through a file: spawn writes its arguments to each
        # child's pipe, and large ones would hold each start until that
        # child has imported torch
        job, out = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "result.pt")
        with open(job, "wb") as f:
            pickle.dump((fn, args), f)
        mp.spawn(_rank_main, args=(world, _free_port(), device_type, backend, job, out),
                 nprocs=world, join=True)
        return torch.load(out, weights_only=False)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return tuple(_numpy(v) for v in x)
    return x


def _stedc(d, e, mesh=None, **kw):
    """stedc's eigenpairs, the number of its compact merges and the secular
    sweeps of each merge on every rank of the mesh's 'tp' dimension (one
    list a rank; the one list of this rank without a mesh)."""
    from eigensolver_gpu_torch.ops.stedc import stedc

    w, q = stedc(d, e, mesh=mesh, **kw)
    sweeps = [list(stedc.sweeps)]
    if mesh is not None:
        group = mesh.get_group("tp")
        sweeps = [None] * dist.get_world_size(group)
        dist.all_gather_object(sweeps, list(stedc.sweeps), group=group)
    return w, q, len(stedc.compact), sweeps


def _collectives(mesh):
    """Each collective of parallel/comm.py on rank-made data (rank r's
    tensors hold 100 r + their index): what rank 0 gets back."""
    from eigensolver_gpu_torch.parallel import comm

    r = comm.rank(mesh)
    x = torch.arange(6.0).reshape(2, 3) + 100 * r
    return (comm.all_gather(x, mesh), comm.all_gather(x, mesh, axis=-1), comm.all_reduce(x, mesh),
            comm.all_reduce(x, mesh, op=dist.ReduceOp.MAX),
            comm.reduce_scatter(torch.arange(24.0).reshape(2, 4, 3) + 100 * r, mesh),
            comm.row_block(torch.arange(12.0).reshape(4, 3), mesh),
            comm.row_block(torch.arange(15.0).reshape(5, 3), mesh),
            torch.tensor([comm.size(mesh, "dp"), comm.size(mesh), r]))


def _wrappers():
    """The kernel wrappers, each counting its launches."""
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel, bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel, ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, apply_q2_planar_kernel
    from eigensolver_gpu_torch.ops.symv import hemv_planar, symv

    return (pchol_block_planar, latrd_panel_planar, hemv_planar, symv, ql_panel,
            ql_panel_planar, bulge_chase_kernel, bulge_chase_planar_kernel, apply_q2_kernel,
            apply_q2_planar_kernel)


def _entries():
    from eigensolver_gpu_torch.ops.refine import refine_eigh
    from eigensolver_gpu_torch.parallel import sharded
    from eigensolver_gpu_torch.parallel.mesh import make_mesh

    return {
        "make_mesh": lambda *args, **kw: tuple(make_mesh(*args, **kw).mesh.shape),
        "collectives": _collectives,
        "sygvdx_sharded": sharded.sygvdx_sharded,
        "sygvdx_batched_sharded": sharded.sygvdx_batched_sharded,
        "zhegvdx_planar_batched_sharded": sharded.zhegvdx_planar_batched_sharded,
        "stedc": _stedc,
        "refine_eigh": refine_eigh,
    }


def run_calls(calls, device_type="cpu"):
    """On every rank, for each (entry, args, kwargs, mesh_shape) of
    ``calls``: make the mesh (n_devices, dp) when mesh_shape is given and
    pass it as ``mesh``, convert numpy arguments (keywords too) to tensors
    on the rank's device, call the entry and record {"out": outputs as numpy,
    "calls": collectives by name, "stages": collectives by stage,
    "launches": the kernels launched, by wrapper (none on the CPU)} or
    {"error": "Type: message"}; a rank outside the mesh records
    {"skipped": True}. Returns the records in order."""
    from eigensolver_gpu_torch.parallel import comm
    from eigensolver_gpu_torch.parallel.mesh import make_mesh

    entries = _entries()
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else "cpu"
    meshes = {}  # one mesh a shape: building one makes process groups, collectively
    records = []
    for entry, args, kwargs, mesh_shape in calls:
        kwargs = dict(kwargs)
        if mesh_shape is not None:
            try:
                if mesh_shape not in meshes:
                    meshes[mesh_shape] = make_mesh(*mesh_shape, device_type=device_type)
            except ValueError as exc:
                records.append({"error": f"{type(exc).__name__}: {exc}"})
                continue
            kwargs["mesh"] = meshes[mesh_shape]
            if kwargs["mesh"].get_coordinate() is None:
                records.append({"skipped": True})
                continue
        tensor = lambda x: torch.as_tensor(x, device=dev) if isinstance(x, np.ndarray) else x
        args = [tensor(x) for x in args]
        kwargs = {k: tensor(x) for k, x in kwargs.items()}
        comm.reset()
        for fn in _wrappers():
            fn.launches = 0
        try:
            out = entries[entry](*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 -- recorded for the caller
            records.append({"error": f"{type(exc).__name__}: {exc}"})
            continue
        records.append({"out": _numpy(tuple(out) if isinstance(out, tuple) else (out,)),
                        "calls": dict(comm.calls), "stages": dict(comm.stages),
                        "launches": {fn.__name__: fn.launches for fn in _wrappers()
                                     if fn.launches}})
    return records


def _dryrun_checks(n_devices, device_type):
    """JAX's five dry-run checks on this rank (see the module docstring)."""
    from eigensolver_gpu_torch.models.zhegvdx_planar import zhegvdx_planar
    from eigensolver_gpu_torch.parallel.mesh import make_mesh
    from eigensolver_gpu_torch.parallel.sharded import (
        sygvdx_batched_sharded,
        sygvdx_sharded,
        zhegvdx_planar_batched_sharded,
    )
    from eigensolver_gpu_torch.utils.config import SolverConfig

    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else "cpu"
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    cfg = SolverConfig(stedc_leaf=16)
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, dp=dp, device_type=device_type)

    n = 64
    rng = np.random.default_rng(1)
    g = rng.standard_normal((n, n))
    a = (g + g.T) / 2
    g2 = rng.standard_normal((n, n))
    b = g2 @ g2.T / n + np.eye(n)
    infos = {}

    # tensor-parallel single solve
    infos["tp"] = sygvdx_sharded(t(a), t(b), mesh, il=1, iu=16, cfg=cfg).info
    # data-parallel batched solve (QE k-point pattern)
    batch = n_devices
    ab = np.stack([a + 0.01 * k * np.eye(n) for k in range(batch)])
    bb = np.stack([b] * batch)
    infos["dp"] = sygvdx_batched_sharded(t(ab), t(bb), mesh, il=1, iu=8, cfg=cfg).info
    # the planar complex pipeline, unsharded
    gz = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    az = (gz + gz.conj().T) / 2
    bz = b.astype(complex)
    infos["planar"] = zhegvdx_planar(t(az.real), t(az.imag), t(bz.real), t(bz.imag),
                                     il=1, iu=8, cfg=cfg).info
    # data-parallel batched planar solves
    azb = np.stack([az + 0.01 * k * np.eye(n) for k in range(batch)])
    bzb = np.stack([bz] * batch)
    infos["planar dp"] = zhegvdx_planar_batched_sharded(
        t(azb.real), t(azb.imag), t(bzb.real), t(bzb.imag), mesh, il=1, iu=8, cfg=cfg).info
    # the tensor-parallel two-stage reduction at a small multiple of the band
    cfg2 = SolverConfig(stedc_leaf=16, tridiag_mode="two", band=8)
    infos["tp two-stage"] = sygvdx_sharded(t(a), t(b), mesh, il=1, iu=16, cfg=cfg2).info
    for name, info in infos.items():
        if not bool(torch.all(info == 0)):
            raise AssertionError(f"dryrun {name}: info {info.tolist()}")
    return {name: info.cpu().tolist() for name, info in infos.items()}


def dryrun_multichip(n_devices: int, device_type: str = "cpu") -> dict:
    """Run JAX's five sharded checks in a world of ``n_devices`` ranks
    (gloo on the CPU, NCCL on the cards); raises unless every ``info`` is
    0, and returns the infos by check."""
    return run_world(n_devices, _dryrun_checks, (n_devices, device_type), device_type)
