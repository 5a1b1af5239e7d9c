"""Collectives of the CP islands over an explicit ``torch.distributed``
process group (the port's counterparts of the reference's
``jax.lax.ppermute`` / ``all_gather`` and of their JAX transposes).

* The **ring hop** sends a tuple of tensors to rank r+1 and receives the
  same shapes from rank r-1 (``dist.batch_isend_irecv``).  It is split in
  two autograd Functions so the transfer overlaps compute:
  :func:`hop_start` starts it and returns at once; :func:`hop_wait`
  blocks only where the received buffer is read.  The backward of the
  hop sends each floating cotangent along the inverse permutation (to
  rank r-1, from rank r+1).
* The **tiled all-gather** along one axis: forward
  ``all_gather_into_tensor``, backward ``reduce_scatter_tensor``.
* The **tiled all-to-all** (the expert-parallel exchange of the MoE
  island, ``jax.lax.all_to_all(..., tiled=True)``): ``x`` split along one
  dim into N pieces, piece j sent to rank j, the received pieces
  concatenated along another dim in rank order
  (``all_to_all_single``); its backward is the inverse all-to-all.
* The **summing all-reduce** of a replicated statistic (the MoE aux
  loss's whole-batch routing fractions): backward, the cotangents summed
  over the ranks.

The backend is an explicit argument, ``"nccl"`` or ``"gloo"``, never
inferred.  With NCCL the transfers run on the process group's own NCCL
stream: starting a transfer orders that stream after the current one, and waiting
orders the current stream after the transfer, so the host never blocks.
NCCL refuses two ranks on one device, so where ranks share a card the
caller picks gloo: gloo moves host tensors only, and for CUDA tensors
this module copies each wire tensor to host memory before the send and
back to the card after the receive.  That exchange runs at host-copy
rates; it is not an NVLink measurement and is never reported as one.
Integer tensors (the buffers' doc/pos metadata) travel with the floating
ones and carry no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["CPComm", "hop_start", "hop_wait", "all_gather_tiled",
           "all_to_all_tiled", "all_reduce_sum", "all_reduce_",
           "broadcast_"]

BACKENDS = ("nccl", "gloo")


class CPComm:
    """The CP process group of one rank and its backend."""

    def __init__(self, backend: str, group=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use one of "
                             f"{BACKENDS}")
        self.backend = backend
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _global(self, r: int) -> int:
        r %= self.size
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)

    def _host_wire(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def start(self, xs, shift: int = 1) -> "_Transfer":
        """Send each of ``xs`` to rank r+shift and receive the same shapes
        from rank r-shift; returns the transfer in flight."""
        send, recv, ops = [], [], []
        to, frm = self._global(self.rank + shift), \
            self._global(self.rank - shift)
        for x in xs:
            wire = x.detach().contiguous()
            if self._host_wire(wire):
                wire = wire.cpu()
            buf = torch.empty_like(wire)
            send.append(wire)
            recv.append(buf)
            ops.append(dist.P2POp(dist.isend, wire, to, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.group))
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Transfer(works, send, recv, [x.device for x in xs])

    def exchange(self, xs, shift: int = 1) -> list[torch.Tensor]:
        """:meth:`start` and wait: the received tensors."""
        return self.start(xs, shift).wait()


class _Transfer:
    """One batch of sends and receives in flight."""

    def __init__(self, works, send, recv, devices):
        self.works, self.send, self.recv = works, send, recv
        self.devices = devices

    def wait(self) -> list[torch.Tensor]:
        for w in self.works:
            w.wait()
        self.works = []
        self.send = []              # the sends are done; free them
        return [b.to(d) for b, d in zip(self.recv, self.devices)]


class _Hop:
    """A ring hop's state between :func:`hop_start` and :func:`hop_wait`."""

    def __init__(self, comm: CPComm):
        self.comm = comm
        self.transfer = None


class _HopStart(torch.autograd.Function):
    """Start the hop; outputs are placeholders of the inputs' shapes that
    only :class:`_HopWait` reads."""

    @staticmethod
    def forward(ctx, hop, *xs):
        hop.transfer = hop.comm.start(xs)
        # one-element views of the inputs' shapes: the data arrives in
        # _HopWait
        outs = tuple(x.new_empty(()).expand_as(x) for x in xs)
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        # _HopWait's backward already moved each cotangent back one hop
        return (None, *grads)


class _HopWait(torch.autograd.Function):
    """Wait for the hop; backward sends the floating cotangents along the
    inverse permutation (to rank r-1) and receives this rank's from rank
    r+1."""

    @staticmethod
    def forward(ctx, hop, *placeholders):
        ctx.comm = hop.comm
        ctx.floating = [p.is_floating_point() for p in placeholders]
        outs = tuple(hop.transfer.wait())
        hop.transfer = None
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        idx = [i for i, f in enumerate(ctx.floating) if f]
        back = ctx.comm.exchange([grads[i] for i in idx], shift=-1)
        out = [None] * len(grads)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, *out)


def hop_start(comm: CPComm, xs) -> tuple:
    """Start one ring hop of the tensors ``xs`` (to rank r+1, from rank
    r-1).  Returns the handle for :func:`hop_wait`."""
    hop = _Hop(comm)
    return hop, _HopStart.apply(hop, *xs)


def hop_wait(handle) -> tuple:
    """The tensors rank r-1 sent in the hop ``handle``."""
    hop, placeholders = handle
    return _HopWait.apply(hop, *placeholders)


def _along(x, comm: CPComm, dim: int, gather: bool):
    """All-gather (``gather``) or reduce-scatter (sum) ``x`` along
    ``dim``, tiled in rank order."""
    xt = x.detach().movedim(dim, 0).contiguous()
    host = comm._host_wire(xt)
    wire = xt.cpu() if host else xt
    n = wire.shape[0] * comm.size if gather else wire.shape[0] // comm.size
    collective = dist.all_gather_into_tensor if gather \
        else dist.reduce_scatter_tensor
    out = wire.new_empty((n, *wire.shape[1:]))
    collective(out, wire, group=comm.group)
    if host:
        out = out.to(x.device)
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return _along(x, comm, dim, gather=True)

    @staticmethod
    def backward(ctx, g):
        return _along(g, ctx.comm, ctx.dim, gather=False), None, None


def all_gather_tiled(x: torch.Tensor, comm: CPComm, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    differentiable for floating ``x`` (backward: reduce-scatter)."""
    if not x.is_floating_point():
        return _along(x, comm, dim, gather=True)
    return _AllGather.apply(x, comm, dim)


def _a2a(x, comm: CPComm, split_dim: int, concat_dim: int):
    """The tiled all-to-all of ``x`` (no gradient)."""
    xs = x.detach().movedim(split_dim, 0).contiguous()
    host = comm._host_wire(xs)
    wire = xs.cpu() if host else xs
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=comm.group)
    if host:
        out = out.to(x.device)
    return torch.cat([p.movedim(0, split_dim)
                      for p in out.chunk(comm.size, 0)], concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.comm, ctx.dims = comm, (split_dim, concat_dim)
        return _a2a(x, comm, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, ctx.comm, concat_dim, split_dim), None, None, None


def all_to_all_tiled(x: torch.Tensor, comm: CPComm, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """``x`` split along ``split_dim`` into one piece per rank, piece j
    sent to rank j; returns the pieces this rank received, concatenated
    along ``concat_dim`` in rank order.  ``x.shape[split_dim]`` must
    divide by the group's size.  Differentiable: the backward sends each
    cotangent piece back where it came from."""
    if x.shape[split_dim] % comm.size:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {comm.size} ranks")
    return _AllToAll.apply(x, comm, split_dim, concat_dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        out = x.detach().clone()
        all_reduce_([out], comm)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_([g], ctx.comm)
        return g, None


def all_reduce_sum(x: torch.Tensor, comm: CPComm) -> torch.Tensor:
    """The sum of every rank's ``x`` (the same on each rank).
    Differentiable: each rank's ``x`` gets the sum of the ranks'
    cotangents, since every rank's output depends on it."""
    return _AllReduceSum.apply(x, comm)


def all_reduce_(tensors, comm: CPComm, op=dist.ReduceOp.SUM) -> None:
    """Reduce each of ``tensors`` over the group by ``op`` (a sum unless
    told otherwise), in place, as one flat collective per dtype (no
    gradient)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        wire = flat.cpu() if comm._host_wire(flat) else flat
        dist.all_reduce(wire, op=op, group=comm.group)
        flat = wire.to(flat.device)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def broadcast_(tensors, comm: CPComm, src: int = 0) -> None:
    """Overwrite each of ``tensors`` with rank ``src``'s, in place."""
    for t in tensors:
        wire = t.detach().cpu() if comm._host_wire(t) else t.detach()
        dist.broadcast(wire, comm._global(src), group=comm.group)
        if wire is not t:
            with torch.no_grad():
                t.copy_(wire)
