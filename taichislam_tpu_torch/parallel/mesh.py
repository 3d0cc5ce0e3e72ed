"""Process-group meshes for the multi-card compositions.

Counterpart of the JAX package's ``parallel/mesh.py``. One rank of a
``torch.distributed`` process group stands for one device of the JAX
``Mesh``: an SPMD function runs in every rank on this rank's shard and
inputs, and returns what ``shard_map`` returns on that device. The
collectives the package calls are the mesh's methods:

- :meth:`Mesh.all_gather` for ``jax.lax.all_gather(..., tiled=True)``
  (rank order is row order, along dim 0);
- :meth:`Mesh.psum` for ``jax.lax.psum``;
- :meth:`Mesh.any` for the psum-OR convergence flags and bitmaps;
- :meth:`Mesh.axis_index` for ``jax.lax.axis_index``.

The backend is always named by the caller: ``gloo`` on the CPU, ``nccl``
for one rank per card. Several ranks that share one card cannot use NCCL,
which refuses two ranks on one device; they take ``gloo``, which takes CUDA
tensors for every collective the mesh calls (``all_gather_into_tensor`` and
``all_reduce`` SUM / MAX, bool to f32, as measured on the H100 host with
torch 2.11) and moves them through host memory itself.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist

from taichislam_tpu_torch.core.device import resolve_device

BACKENDS = ("gloo", "nccl")


def default_backend(device) -> str:
    """``nccl`` for a CUDA device (one rank per card), ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """One rank's view of a one-axis mesh: ``size`` ranks, this one at
    ``rank``, its tensors on ``device``, collectives over ``group``."""

    def __init__(self, group, axis: str, device: torch.device, backend: str):
        self.group = group
        self.axis = axis
        self.device = device
        self.backend = backend
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.bytes_moved = 0   # payload bytes handed to collectives

    def axis_index(self) -> int:
        return self.rank

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order (the
        tiled all_gather); a new tensor on ``t``'s device."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self.bytes_moved += t.numel() * t.element_size()
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over ranks; a new tensor on ``t``'s device."""
        out = t.clone()
        self.bytes_moved += out.numel() * out.element_size()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def any(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise OR over ranks of a bool tensor."""
        out = t.to(torch.int32)
        self.bytes_moved += out.numel() * 4
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out > 0


def make_mesh(n_devices: int = None, axis: str = "drone", device=None,
              backend: str = None) -> Mesh:
    """A mesh over every rank of the default process group (``n_devices``,
    when given, must be its size), its tensors on ``device`` (the CUDA card
    unless given). ``backend`` (``gloo`` or ``nccl``; default
    :func:`default_backend` of the device) names the collectives' backend;
    a backend other than the default group's gets a group of its own.

    Without a default process group, ``make_mesh(1)`` starts a one-rank
    group in this process: the counterpart of a one-device JAX mesh."""
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend: want one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}): no process group; start the ranks "
                "with spawn_mesh or init_process_group first")
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the mesh spans every rank "
                         f"of the default group ({world})")
    group = dist.group.WORLD if dist.get_backend() == backend else \
        dist.new_group(ranks=list(range(world)), backend=backend)
    return Mesh(group, axis, device, backend)


def _rank_device(device, backend, rank):
    """Rank ``rank``'s device: with nccl, card ``rank``; with gloo, the
    given device for every rank (several ranks may share one card)."""
    dev = torch.device(device)
    if backend == "nccl" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _rank_main(rank, n, store_path, backend, device, axis, fn, args, out_q,
               threads):
    torch.set_num_threads(threads)
    dev = _rank_device(device, backend, rank)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        mesh = make_mesh(n, axis, dev, backend)
        out_q.put((rank, fn(mesh, *args)))
    finally:
        dist.destroy_process_group()


def spawn_mesh(fn, n: int, *, backend: str = None, device=None, args=(),
               axis: str = "drone", store_dir=None, threads: int = 1,
               timeout_s: float = 600.0):
    """Run ``fn(mesh, *args)`` in ``n`` new processes (the ``spawn``
    start method), rank ``r`` of a process group over a ``FileStore`` in
    ``store_dir`` (a new temporary directory when None); return the ranks'
    results in rank order. ``fn`` and ``args`` must be picklable, and ``fn``
    is best defined in a module that imports nothing heavy, since every
    child imports it. ``device`` is the CUDA card unless given; ``backend``
    defaults as in :func:`make_mesh`. A rank that fails (or the time limit)
    stops the others and raises."""
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend: want one of {BACKENDS}, got {backend!r}")
    store_dir = store_dir or tempfile.mkdtemp(prefix="mesh_store_")
    store_path = os.path.join(str(store_dir), f"store_{os.getpid()}_"
                              f"{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, store_path, backend, str(device), axis,
                               fn, args, out_q, threads),
                         name=f"mesh-rank-{r}") for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    t_end = time.monotonic() + timeout_s
    try:
        while len(results) < n:
            try:
                rank, res = out_q.get(timeout=0.2)
                results[rank] = res
                continue
            except queue.Empty:
                pass
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(
                    "mesh ranks failed: " + ", ".join(
                        f"{p.name} exit {p.exitcode}" for p in bad))
            if time.monotonic() > t_end:
                raise TimeoutError(f"spawn_mesh: ranks did not finish in "
                                   f"{timeout_s} s")
            if all(p.exitcode == 0 for p in procs) and out_q.empty():
                raise RuntimeError("mesh ranks exited without a result")
        for p in procs:
            p.join(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        out_q.close()
    return [results[r] for r in range(n)]
