"""Ranks, meshes and the collectives of the parallel package.

The JAX package runs its parallel programs as one process over a named
device mesh: ``shard_map`` gives each device its shard, and
``jax.lax.{ppermute, all_to_all, psum, axis_index}`` move data between
them. Here each shard is a process (a rank) of a ``torch.distributed``
process group, and this module is the counterpart of those primitives:

* :func:`init_ranks` joins the process group. The backend follows one
  rule, chosen before ``init_process_group`` (:func:`choose_backend`):
  NCCL when every rank has a card of its own, gloo when ranks share a
  card, gloo on the CPU. The store is a file (``FileStore``), so no port
  is fixed and parallel test runs do not collide, and every group has a
  timeout, so a mismatched collective fails instead of hanging.
* :class:`Mesh` names the axes of a 1D or 2D rank grid (row-major: the
  last axis varies fastest) and holds one process group per axis line.
* :func:`ppermute`, :func:`all_to_all`, :func:`gather`, :func:`shard`,
  :func:`psum_grad` and :func:`pmean` are differentiable;
  :func:`all_reduce_sum` runs outside autograd.

Transport. Gloo takes CPU tensors. Where ranks share a card (gloo on
CUDA tensors) every collective copies its payload explicitly to a pinned
host buffer, runs there, and copies the result back (a model's
gradients as one flat buffer): the ring's and the all-to-all's real
transport on one card. :class:`TransportStats` counts
the bytes and seconds of each kind, and the caller prints them. Nothing
switches backend or transport quietly: a combination the rule does not
cover raises.

Autograd across ranks. Every rank must reach the same collectives in
the same order, in the backward too. The differentiable collectives
here are ``torch.autograd.Function``s whose backward is a collective
itself (the inverse permutation, the inverse all-to-all), and the
callers keep one graph shape on every rank: a ring rotates k and v as
one stacked tensor, and a block a rank skips still feeds the output
(:func:`anchor`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from nvshare_tpu_torch.device import DeviceLike, resolve_device

# A group's collectives fail after this long instead of hanging.
TIMEOUT_S = 90.0


def choose_backend(world: int, device: torch.device, n_cards: int) -> str:
    """The process-group backend by the package's rule: ``nccl`` when
    every rank has a card of its own (ranks <= cards), ``gloo`` when the
    ranks share cards, ``gloo`` on the CPU. Raises for a CUDA run without
    a card and for any other device type."""
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no backend rule for device type {device.type!r}")
    if n_cards < 1:
        raise RuntimeError("a CUDA run needs a card; pass device='cpu' "
                           "explicitly to run on the CPU")
    return "nccl" if world <= n_cards else "gloo"


def world_size() -> int:
    """Ranks of the program's process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(rank: int, world: int, device: DeviceLike = None
                ) -> torch.device:
    """The device of ``rank``: the CPU when asked for, else its own card
    when every rank has one (``cuda:rank``), else the current card, which
    the ranks share."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if world <= torch.cuda.device_count():
        return torch.device("cuda", rank)
    return dev


def init_ranks(rank: int, world: int, init_file: str,
               device: DeviceLike = None,
               timeout_s: float = TIMEOUT_S) -> Tuple[torch.device, str]:
    """Join the process group of ``world`` ranks as ``rank``, through a
    ``FileStore`` at ``init_file`` (one fresh path per run, the same in
    every rank). Returns ``(device, backend)``. ``device`` defaults to
    ``cuda`` and raises without a card."""
    dev = rank_device(rank, world, device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(world, dev, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(init_file, world)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s), **kwargs)
    return dev, backend


def shutdown_ranks() -> None:
    """Leave the process group (no-op when there is none)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class TransportStats:
    """Bytes and seconds of each collective kind, and how many calls. On a
    mesh whose ``staged`` is set (gloo on a card) every byte counted went
    through pinned host buffers, and the seconds include the copies."""

    calls: Dict[str, int] = field(default_factory=dict)
    nbytes: Dict[str, int] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.nbytes[kind] = self.nbytes.get(kind, 0) + int(nbytes)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds

    def as_dict(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.nbytes[k],
                    "seconds": round(self.seconds[k], 6)}
                for k in sorted(self.calls)}


class Mesh:
    """A named grid of ranks: the counterpart of ``jax.sharding.Mesh``.

    ``shape`` and ``axis_names`` as in JAX; rank ``r`` sits at the
    row-major coordinates of ``r`` in ``shape``. A mesh of one rank needs
    no process group (every collective is the identity there); a larger
    one needs :func:`init_ranks` first, with a world of the mesh's size.
    Building a mesh creates its groups, in the same order on every rank.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: DeviceLike = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        self.size = math.prod(self.shape)
        initialised = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialised else 1
        if self.size != world:
            raise ValueError(
                f"a mesh of shape {self.shape} needs {self.size} ranks; "
                f"this program has {world}"
                + ("" if initialised else " (no process group: call "
                   "init_ranks in each rank first)"))
        self.rank = dist.get_rank() if initialised else 0
        self.device = (rank_device(self.rank, world, device)
                       if initialised else resolve_device(device))
        self.backend = dist.get_backend() if initialised else "none"
        # Gloo moves CPU tensors: on a card, payloads go through host.
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stats = TransportStats()
        self.coords = self._coords(self.rank)
        # One group per line of each axis (and per set of axes asked for
        # later), created on every rank in the same order.
        self._groups: Dict[Tuple[str, ...], Tuple[list, object]] = {}
        for axis in self.axis_names:
            self._make_groups((axis,))
        if len(self.axis_names) > 1:
            self._make_groups(self.axis_names)

    def _coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for s in reversed(self.shape):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def _rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.shape):
            r = r * s + c
        return r

    def _make_groups(self, axes: Tuple[str, ...]) -> None:
        dims = [self.axis_names.index(a) for a in axes]
        lines: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = self._coords(r)
            key = tuple(v for i, v in enumerate(c) if i not in dims)
            lines.setdefault(key, []).append(r)
        mine = None
        for key in sorted(lines):
            ranks = lines[key]
            group = None
            if self.size > 1:
                group = (dist.group.WORLD if len(ranks) == self.size
                         else dist.new_group(ranks, timeout=timedelta(
                             seconds=TIMEOUT_S)))
            if self.rank in ranks:
                mine = (ranks, group)
        self._groups[axes] = mine

    def _axes(self, axis) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                                 f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axis) -> Tuple[list, object]:
        """(global ranks of this rank's line along ``axis``, in axis
        order; its process group). ``axis`` may be a tuple of axes."""
        axes = self._axes(axis)
        if axes not in self._groups:
            raise ValueError(f"no group for axes {axes}: a mesh groups each "
                             "axis alone and all its axes together")
        return self._groups[axes]

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in self._axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (row-major over a tuple)."""
        idx = 0
        for a in self._axes(axis):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank}, {self.device}, {self.backend}"
                f"{', host-staged' if self.staged else ''})")


def axis_index(mesh: Mesh, axis) -> int:
    """``jax.lax.axis_index`` inside a rank."""
    return mesh.axis_index(axis)


def axis_size(mesh: Mesh, axis) -> int:
    """``jax.lax.psum(1, axis)`` inside a rank."""
    return mesh.axis_size(axis)


# -- transport ---------------------------------------------------------------

def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``x`` (synchronous)."""
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


class _Timed:
    def __init__(self, mesh: Mesh, kind: str, nbytes: int):
        self.mesh, self.kind, self.nbytes = mesh, kind, nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.mesh.stats.add(self.kind, self.nbytes,
                                time.perf_counter() - self.t0)


def _ppermute_raw(mesh: Mesh, axis, x: torch.Tensor,
                  perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    ranks, group = mesh.group(axis)
    me = mesh.axis_index(axis)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"ppermute takes a permutation; got {perm}")
    x = x.contiguous()
    if len(ranks) == 1:
        return x.clone() if srcs else torch.zeros_like(x)
    with _Timed(mesh, "ppermute", x.numel() * x.element_size()):
        send = _host(x) if mesh.staged else x
        recv = torch.empty_like(send)
        # One batch: NCCL sets up a pair's channel on its first use, so
        # a ring of separate sends would wait on itself.
        ops = []
        if dsts:
            ops.append(dist.P2POp(dist.isend, send, ranks[dsts[0]], group))
        if srcs:
            ops.append(dist.P2POp(dist.irecv, recv, ranks[srcs[0]], group))
        for w in (dist.batch_isend_irecv(ops) if ops else []):
            w.wait()
        if not srcs:
            recv.zero_()
        return recv.to(x.device) if mesh.staged else recv


def _all_to_all_raw(mesh: Mesh, axis, x: torch.Tensor, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    ranks, group = mesh.group(axis)
    n = len(ranks)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all splits dim {split_dim} of "
                         f"{tuple(x.shape)} into {n} equal parts: not "
                         "divisible")
    if n == 1:
        return x
    inp = torch.stack(x.chunk(n, split_dim))        # [n, ...] contiguous
    with _Timed(mesh, "all_to_all", inp.numel() * inp.element_size()):
        src = _host(inp) if mesh.staged else inp
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        if mesh.staged:
            out = out.to(x.device)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _all_gather_raw(mesh: Mesh, axis, x: torch.Tensor, dim: int
                    ) -> torch.Tensor:
    ranks, group = mesh.group(axis)
    if len(ranks) == 1:
        return x
    x = x.contiguous()
    with _Timed(mesh, "all_gather", x.numel() * x.element_size()):
        src = _host(x) if mesh.staged else x
        parts = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if mesh.staged else out


def _all_reduce_raw(mesh: Mesh, axis, x: torch.Tensor, kind: str
                    ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, in a new tensor on x's device."""
    ranks, group = mesh.group(axis)
    if len(ranks) == 1:
        return x.clone()
    with _Timed(mesh, kind, x.numel() * x.element_size()):
        buf = _host(x) if mesh.staged else x.clone()
        dist.all_reduce(buf, group=group)
        return buf.to(x.device) if mesh.staged else buf


def all_reduce_sum(mesh: Mesh, axis, tensors: Iterable[torch.Tensor]
                   ) -> None:
    """Sum each tensor over ``axis``, in place, outside autograd, as one
    flat buffer, so a model's gradients cross together in one collective
    (on a shared card, through one pinned host copy of the buffer).
    ``axis`` may be a tuple of axes. The tensors must be contiguous."""
    tensors = list(tensors)
    ranks, group = mesh.group(axis)
    if len(ranks) == 1 or not tensors:
        return
    dtype = tensors[0].dtype
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("all_reduce_sum takes tensors of one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all_reduce_sum sums contiguous tensors in place")
    flats = [t.view(-1) for t in tensors]
    total = sum(f.numel() for f in flats)
    with torch.no_grad(), _Timed(mesh, "all_reduce",
                                 total * tensors[0].element_size()):
        flat = torch.cat(flats)
        if mesh.staged:
            flat = _host(flat)
        dist.all_reduce(flat, group=group)
        off = 0
        for f in flats:
            f.copy_(flat[off:off + f.numel()])
            off += f.numel()


# -- differentiable collectives ---------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute_raw(mesh, axis, x, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _ppermute_raw(ctx.mesh, ctx.axis, g, inv), None, None, None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: index ``s`` of the axis sends x to index
    ``d`` for each ``(s, d)`` in ``perm``; a rank no one sends to gets
    zeros. Backward: the inverse permutation."""
    return _PPermute.apply(x, mesh, axis, [tuple(p) for p in perm])


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """Each index sends to the next, the last to the first."""
    return [(i, (i + 1) % n) for i in range(n)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _all_to_all_raw(mesh, axis, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (_all_to_all_raw(mesh, axis, g.contiguous(), concat_dim,
                                split_dim), None, None, None, None)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``split_dim`` into
    one part a rank of the axis, send part j to index j, and concatenate
    the parts received along ``concat_dim`` in index order. Backward: the
    inverse all-to-all."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return _all_gather_raw(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, n = ctx.args
        i = mesh.axis_index(axis)
        return g.narrow(dim, i * n, n), None, None, None


def gather(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """All-gather the shards of ``axis`` along ``dim`` into the whole
    tensor, the same on every rank of the axis. The whole tensor's
    consumer must be replicated (every rank computes the same thing from
    it), as a loss is: the backward then keeps this rank's slice of the
    gradient, with no collective."""
    return _Gather.apply(x, mesh, axis, dim)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"cannot shard dim {dim} of {tuple(x.shape)} "
                             f"over {n} ranks evenly")
        blk = x.shape[dim] // n
        return x.narrow(dim, i * blk, blk).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return (_all_gather_raw(mesh, axis, g.contiguous(), dim), None,
                None, None)


def shard(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """This rank's block of the replicated ``x`` along ``dim``. Backward:
    every rank's block of the gradient, gathered, so the replicated input
    gets the whole gradient on every rank."""
    return _Shard.apply(x, mesh, axis, dim)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_reduce_raw(mesh, axis, g.contiguous(),
                               "all_reduce"), None, None


def psum_grad(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Identity on a replicated tensor whose consumers differ by rank
    (each computes a part of the loss): the backward sums the parts'
    gradients over ``axis``."""
    if not x.requires_grad:
        return x
    return _PsumGrad.apply(x, mesh, axis)


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = mesh.axis_size(axis)
        return _all_reduce_raw(mesh, axis, x.contiguous(),
                               "all_reduce") / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def pmean(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The mean of each rank's ``x`` over ``axis``, replicated. Its
    consumer must be replicated: the backward gives each rank's x its
    share of the gradient, with no collective."""
    return _Pmean.apply(x, mesh, axis)


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *extra):
        ctx.extra = [(e.shape, e.dtype, e.device) for e in extra]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.extra))


def anchor(out: torch.Tensor, *extra: torch.Tensor) -> torch.Tensor:
    """``out``, with each tensor of ``extra`` made an input of it (zero
    gradient). A rank that skips a block still sends the block's
    gradient on: every rotated tensor of a ring reaches the output, so
    every rank walks the whole chain of ``ppermute`` backwards in the
    same order, whatever it skipped."""
    extra = tuple(e for e in extra if e.requires_grad)
    if not extra or not torch.is_grad_enabled():
        return out
    return _Anchor.apply(out, *extra)
