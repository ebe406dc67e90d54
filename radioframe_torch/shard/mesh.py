"""The ("channel", "time") layout of ranks over ``torch.distributed``
(counterpart of ``radioframe/shard/mesh.py``), the split of a state tree
across it, and a launcher for the ranks of one host.

A mesh sits over an already initialised default process group: rank
``c * time + t`` holds channel slice c and time shard t, so time neighbours
are consecutive ranks. That is the locality ``make_hybrid_mesh`` builds
over hosts: the time axis, which carries the halos and scan completions,
stays inside a host; the channel axis needs no collective in the receive
chain.

The groups are plain ``new_group``s, one per row (time axis) and one per
column (channel axis), all made by every rank in one order. They inherit
the default group's backend, which is the caller's choice and is never
switched: gloo on the CPU and for several ranks on one card (NCCL refuses
two ranks on one GPU), NCCL for one rank per card. ``DeviceMesh`` is not
used: it ties the mesh to one device type, while the staging rule below
depends on the backend and the tensor.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from radioframe_torch.device import resolve


class P(tuple):
    """A state leaf's layout: one mesh-axis name (or None) per dimension, as
    the reference's ``PartitionSpec``."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __getnewargs__(self):  # pickle: rebuild from the names, not the tuple
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _real(t: torch.Tensor) -> torch.Tensor:
    """Complex tensors travel as float pairs (their memory layout)."""
    return torch.view_as_real(t) if t.is_complex() else t


class Axis:
    """One axis of the mesh as this rank sees it: its ``size``, this rank's
    ``index`` along it, and the collectives of the reference's ``lax`` calls
    over the group of ranks that share this rank's other coordinate.

    With a gloo group and CUDA tensors, ``ppermute_right`` (send/recv),
    ``all_gather`` and ``all_to_all`` stage through host memory, because gloo
    has no CUDA path for them; ``all_reduce`` takes CUDA tensors as they are.
    That staging is a transport, not a compute fallback: it happens here and
    nowhere else."""

    def __init__(self, name: str, ranks, index: int, group):
        self.name = name
        self.ranks = tuple(ranks)  # global ranks along the axis, in axis order
        self.size = len(self.ranks)
        self.index = int(index)
        self.group = group
        self._gloo = dist.get_backend(group) == "gloo"

    @property
    def right(self) -> int:
        """Global rank of the next shard along the axis (ring order)."""
        return self.ranks[(self.index + 1) % self.size]

    @property
    def left(self) -> int:
        return self.ranks[(self.index - 1) % self.size]

    def _staged(self, t: torch.Tensor) -> bool:
        return self._gloo and t.is_cuda

    def ppermute_right(self, x: torch.Tensor) -> torch.Tensor:
        """The ring shift ``lax.ppermute(x, axis, [(i, i+1 mod D)])``: every
        rank sends ``x`` to its right neighbour and returns what its left
        neighbour sent."""
        if self.size == 1:
            return x.clone()
        send = x.detach().contiguous()
        staged = self._staged(send)
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, _real(send), self.right, self.group),
               dist.P2POp(dist.irecv, _real(recv), self.left, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device) if staged else recv

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        out = x.detach().clone().contiguous()
        dist.all_reduce(_real(out), op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the elementwise sum over the axis, on every rank."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmin`` of a real tensor."""
        if x.is_complex():
            raise TypeError("pmin of a complex tensor")
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather``: (size, *x.shape), row i from the rank at index i."""
        if self.size == 1:
            return x[None]
        send = x.detach().contiguous()
        staged = self._staged(send)
        if staged:
            send = send.cpu()
        outs = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather([_real(o) for o in outs], _real(send), group=self.group)
        y = torch.stack(outs)
        return y.to(x.device) if staged else y

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``: dim
        ``split_dim`` is cut into ``size`` equal parts, part i goes to the rank
        at index i, and the parts received are joined along ``concat_dim`` in
        the order of their senders."""
        if self.size == 1:
            return x
        n = x.shape[split_dim]
        if n % self.size:
            raise ValueError(f"dim {split_dim} of {n} does not split over an axis of {self.size}")
        send = x.detach().movedim(split_dim, 0).contiguous()  # the parts, one after another
        staged = self._staged(send)
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(_real(recv), _real(send), group=self.group)
        parts = recv.reshape((self.size, n // self.size) + recv.shape[1:]).movedim(1, split_dim + 1)
        y = torch.cat(list(parts), dim=concat_dim)
        return y.to(x.device) if staged else y

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


class Mesh:
    """A (channel, time) mesh of the default group's ranks on ``device``."""

    def __init__(self, channel: int, time: int, device):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialised default process group")
        world, rank = dist.get_world_size(), dist.get_rank()
        if channel * time != world:
            raise ValueError(f"mesh {channel}x{time} needs {channel * time} ranks, "
                             f"the group has {world}")
        self.shape = {"channel": int(channel), "time": int(time)}
        self.rank = rank
        self.device = resolve(device)
        c, t = divmod(rank, time)
        rows = [[ci * time + ti for ti in range(time)] for ci in range(channel)]
        cols = [[ci * time + ti for ci in range(channel)] for ti in range(time)]
        # new_group's contract: every rank makes every group, in one order
        row_groups = [dist.new_group(r) for r in rows]
        col_groups = [dist.new_group(r) for r in cols]
        self._axes = {"time": Axis("time", rows[c], t, row_groups[c]),
                      "channel": Axis("channel", cols[t], c, col_groups[t])}

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def size(self, name: str) -> int:
        return self._axes[name].size

    def index(self, name: str) -> int:
        return self._axes[name].index


def make_mesh(channel: int = 1, time: int = 1, *, device) -> Mesh:
    """The ("channel", "time") mesh over the initialised default group,
    every rank's tensors on ``device``."""
    return Mesh(channel, time, device)


def make_hybrid_mesh(channel_per_host: int, time: int, *, device,
                     init_distributed: bool = True) -> Mesh:
    """The multi-host ("channel", "time") mesh: ``channel`` spans hosts,
    ``time`` stays inside each host, so the halos and scan completions never
    leave a host and only the channel axis, which needs no collective in the
    receive chain, crosses between hosts (``radioframe/shard/mesh.py:24``).

    One process per device, numbered host-major as torchrun numbers them
    (rank = host * LOCAL_WORLD_SIZE + LOCAL_RANK). With ``init_distributed``
    the default group is initialised from the ``env://`` variables (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) unless one is up already: gloo
    for ``device="cpu"``, NCCL for ``"cuda"``. The host count is the world
    size over LOCAL_WORLD_SIZE (the whole world when that is unset). The
    mesh is (hosts x ``channel_per_host``, ``time``) in host-major rank order:
    the reference's fallback layout (``mesh.py:58-62``), which the default
    numbering ``c * time + t`` already is. ``device="cuda"`` names card
    ``LOCAL_RANK % torch.cuda.device_count()``."""
    dev = resolve(device)
    if init_distributed and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs an initialised default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    if world % local_world or rank % local_world != local_rank:
        raise ValueError(f"rank {rank} of {world} is not host-major over hosts of "
                         f"{local_world} (LOCAL_RANK {local_rank})")
    n_hosts = world // local_world
    if world != n_hosts * channel_per_host * time:
        raise ValueError(f"hybrid mesh ({n_hosts} hosts x {channel_per_host}, {time}) needs "
                         f"{n_hosts * channel_per_host * time} ranks, the group has {world}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return Mesh(n_hosts * channel_per_host, time, dev)


# --- the state tree across the mesh -----------------------------------------------------------


def _map(fn, state, specs):
    """Apply fn(leaf, spec) over a state tree shaped like ``specs``; ``()``
    (a disabled feature) maps to itself."""
    if isinstance(specs, P):
        return fn(state, specs)
    if isinstance(specs, dict):
        if set(state) != set(specs):
            raise ValueError(f"state keys {sorted(state)} != spec keys {sorted(specs)}")
        return {k: _map(fn, state[k], specs[k]) for k in specs}
    if isinstance(specs, tuple):
        if not isinstance(state, tuple) or len(state) != len(specs):
            raise ValueError(f"state {type(state).__name__} of {len(state)} leaves does not "
                             f"match a spec tuple of {len(specs)}")
        return tuple(_map(fn, s, p) for s, p in zip(state, specs))
    raise TypeError(f"unexpected spec {specs!r}")


def shard_state(state, specs, mesh: Mesh):
    """The global state tree -> this rank's slice. Each leaf is cut along
    every dimension its spec names a mesh axis ("channel" for the RX chain's
    per-channel leaves, dim 1 for the (2, C) demod rows; the axis the
    channelizer shards for its split forms) and replicated across the axes
    it does not name."""

    def cut(leaf, spec):
        for dim, name in enumerate(spec):
            if name is None:
                continue
            n, i = mesh.size(name), mesh.index(name)
            C = leaf.shape[dim]
            if C % n:
                raise ValueError(f"{C} channels do not split over a {name} axis of {n}")
            leaf = leaf.narrow(dim, i * (C // n), C // n)
        return leaf.contiguous()

    return _map(cut, state, specs)


def gather_state(state, specs, mesh: Mesh):
    """This rank's slice -> the global state tree, on every rank (a
    collective over each axis a spec names)."""

    def join(leaf, spec):
        for dim, name in enumerate(spec):
            if name is not None:
                leaf = torch.cat(list(mesh.axis(name).all_gather(leaf)), dim=dim)
        return leaf

    return _map(join, state, specs)


# --- ranks on one host ------------------------------------------------------------------------


def _rank_main(fn, rank, nprocs, init_method, backend, timeout_s, results, args):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=nprocs, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, nprocs, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn, nprocs: int, *args, backend: str = "gloo", timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes (spawn
    start method) joined in one default process group; returns each rank's
    result, in rank order.

    Rendezvous goes through a file in a new temporary directory, never a
    fixed TCP port. ``fn`` and its arguments and results are pickled, so
    ``fn`` is a module-level function of a module that the children can
    import. A rank that raises fails the call with its traceback; if the
    ranks have not all returned within ``timeout_s`` (a hung collective),
    the call fails too. Either way every rank is killed before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rf-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nprocs, init, backend, timeout_s, results, args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)


FAILURE_GRACE_S = 2.0


def _collect(procs, results, timeout_s: float) -> list:
    """Each rank's result from the queue, draining it before any join.

    A failure raises with every failure reported within FAILURE_GRACE_S of
    the first: a rank that raises tears its group down, which fails the other
    ranks' pending collectives, and their reports may arrive before its own."""
    got = {}
    deadline = time.monotonic() + timeout_s
    exited_at = {}
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r not in got and p.exitcode is not None:
                    # a rank that exited may still have its result in the pipe
                    if now - exited_at.setdefault(r, now) > 5.0:
                        raise RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                           "without a result")
            if now > deadline:
                missing = sorted(set(range(len(procs))) - set(got))
                raise TimeoutError(f"ranks {missing} did not finish within {timeout_s} s")
            continue
        if not ok:
            _raise_failures({rank: payload}, got, len(procs), results)
        got[rank] = payload
    return [got[r] for r in range(len(procs))]


def _raise_failures(failed: dict, got: dict, nprocs: int, results):
    """Drain the queue for up to FAILURE_GRACE_S (or until every rank reported),
    then raise with each failed rank's traceback, in the order they came."""
    end = time.monotonic() + FAILURE_GRACE_S
    while len(got) + len(failed) < nprocs and time.monotonic() < end:
        try:
            rank, ok, payload = results.get(timeout=0.1)
        except queue.Empty:
            continue
        (got if ok else failed)[rank] = payload
    raise RuntimeError("\n".join(f"rank {r} failed:\n{p}" for r, p in failed.items()))
