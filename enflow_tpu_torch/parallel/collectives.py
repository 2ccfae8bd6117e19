"""The collective interface of the sharded bodies: the port's counterpart of
``lax.psum``, ``lax.ppermute`` and a ``shard_map``'s in and out specs.

A per-shard body (the ring EGCL, the ring pair terms, the ``axis_name``
branches of the flow, the loss and the targets) is written once against an
axis object with these members:

- ``size``: the number of shards.
- ``psum(x)``: the sum of ``x`` over the shards, on every shard.
- ``ring_shift(x)``: shard ``i`` receives shard ``i + 1``'s ``x`` (the JAX
  package's ``perm = [(i, (i - 1) % n)]``).
- ``split(x, dim=1)``: this shard's block along ``dim`` of a tensor that
  every shard holds whole (an in_spec ``P(..., axis)``).
- ``gather(x, dim=1)``: the whole tensor from the shards' blocks (an
  out_spec ``P(..., axis)``).
- ``broadcast(x)``: a tensor that every shard holds whole, in the body's
  layout (an in_spec ``P()``).
- ``collapse(x)``: the value of a tensor of which every shard holds the same
  copy, such as a ``psum`` (an out_spec ``P()``).
- ``pvary(x)``: a replicated value (a ``psum``) that each shard goes on to
  use in its own way, such as a centre of mass in each shard's
  oscillator term: its cotangents are summed over the shards (JAX inserts
  this ``pvary`` by its types, its transpose a ``psum``).

Three implementations:

- :class:`VirtualAxis`: ``K`` virtual devices in one process, the
  counterpart of XLA's forced host device count. A per-shard tensor holds
  the K shards' blocks on its leading dimension, shard-major (``[K * b,
  ...]``), so a body runs all shards in one batched call: ``ring_shift`` is
  a roll of that dimension, ``psum`` a sum over it broadcast back, and
  autograd is torch's own.
- :class:`GroupAxis`: one rank a shard over a ``torch.distributed`` process
  group (NCCL on cards, gloo on the CPU). Each op is an autograd Function:
  ``psum`` is an ``all_reduce`` whose backward passes the cotangent on
  unchanged (every rank back-propagates the same replicated value: JAX's
  transpose of a psum with an invariant result; ``pvary`` all-reduces the
  cotangent where each rank uses the value its own way), ``ring_shift``
  is a ``batch_isend_irecv`` whose backward rotates the other way,
  ``split``'s backward gathers the blocks' cotangents and ``gather``'s
  takes this rank's block. A tensor that enters a body whole (the
  parameters) gets each rank's partial gradient; ``mesh.sum_grads`` sums
  them over the mesh.
- :class:`WholeAxis`: an axis of one shard, every op the identity. It is
  the in-process form's data axis: the process holds every molecule of the
  batch, so a sum over its rows is already the sum over the data axis.
"""

from __future__ import annotations

import torch


class WholeAxis:
    """An axis of one shard: every collective is the identity."""

    size, index = 1, 0

    def psum(self, x):
        return x

    def ring_shift(self, x):
        return x

    def split(self, x, dim=1):
        return x

    def gather(self, x, dim=1):
        return x

    def broadcast(self, x):
        return x

    def collapse(self, x):
        return x

    def pvary(self, x):
        return x


class VirtualAxis:
    """``size`` virtual devices in this process; a per-shard tensor is
    ``[size * b, ...]``, shard ``k``'s block at rows ``[k * b, (k+1) * b)``."""

    def __init__(self, size: int):
        self.size = int(size)

    def _shards(self, x):
        return x.reshape((self.size, -1) + tuple(x.shape[1:]))

    def psum(self, x):
        s = self._shards(x).sum(dim=0)
        return s.unsqueeze(0).expand((self.size,) + tuple(s.shape)).reshape(
            (-1,) + tuple(s.shape[1:]))

    def ring_shift(self, x):
        return torch.roll(self._shards(x), -1, dims=0).reshape(x.shape)

    def split(self, x, dim=1):
        """``[b, ..., K n, ...] -> [K b, ..., n, ...]`` (``dim >= 1``)."""
        shape = tuple(x.shape)
        y = x.reshape(shape[:dim] + (self.size, shape[dim] // self.size)
                      + shape[dim + 1:]).movedim(dim, 0)
        return y.reshape((self.size * shape[0],) + tuple(y.shape[2:]))

    def gather(self, x, dim=1):
        """The inverse of :meth:`split`."""
        y = self._shards(x).movedim(0, dim)
        shape = tuple(y.shape)
        return y.reshape(shape[:dim] + (shape[dim] * shape[dim + 1],)
                         + shape[dim + 2:])

    def broadcast(self, x):
        return x.unsqueeze(0).expand((self.size,) + tuple(x.shape)).reshape(
            (-1,) + tuple(x.shape[1:]))

    def collapse(self, x):
        return self._shards(x)[0]

    def pvary(self, x):
        # each shard holds its own copy: autograd sums their cotangents
        return x


def _dist():
    import torch.distributed as dist
    return dist


def _wire(x):
    """``x`` as a contiguous tensor a backend sends (gloo has no bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()


def _rotate(x, group, to: int, frm: int):
    dist = _dist()
    send = _wire(x)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return recv.to(x.dtype)


def _all_gather(x, group, size: int, dim: int):
    dist = _dist()
    send = _wire(x)
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim).to(x.dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        _dist().all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _rotate(x, axis.group, axis.prev, axis.next)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return _rotate(g, a.group, a.next, a.prev), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return _all_gather(g, a.group, a.size, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _all_gather(x, axis.group, axis.size, dim)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return g.narrow(ctx.dim, a.index * ctx.n, ctx.n).contiguous(), \
            None, None


class GroupAxis:
    """One rank a shard over the process group ``group`` of the global
    ``ranks`` (in axis order)."""

    def __init__(self, group, ranks):
        dist = _dist()
        self.group, self.ranks = group, list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.prev = self.ranks[(self.index - 1) % self.size]
        self.next = self.ranks[(self.index + 1) % self.size]

    def psum(self, x):
        if x.is_floating_point():
            return _PSum.apply(x, self.group)
        y = _wire(x).clone()
        _dist().all_reduce(y, group=self.group)
        return y

    def ring_shift(self, x):
        if x.is_floating_point():
            return _RingShift.apply(x, self)
        return _rotate(x, self.group, self.prev, self.next)

    def split(self, x, dim=1):
        return _Split.apply(x, self, dim)

    def gather(self, x, dim=1):
        return _Gather.apply(x, self, dim)

    def broadcast(self, x):
        return x

    def collapse(self, x):
        return x

    def pvary(self, x):
        return _PVary.apply(x, self.group)
