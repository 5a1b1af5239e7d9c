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

* The **int8 KV wire** (the reference's ``_quantized_ppermute`` and
  ``_quantized_gather``, ``RunConfig.kv_comm_dtype="int8"``): a hop
  started with ``int8=True``, and :func:`int8_all_gather`, send each
  floating tensor as int8 values with one f32 scale per row of its last
  axis (:func:`quantize_int8`) and dequantize on arrival to the sender's
  dtype.  Their backward is the full-precision one of the native wire
  (the inverse hop, the reduce-scatter): straight-through, so the
  gradients are exact at the dequantized values.

Each :class:`CPComm` counts the bytes of the floating and int8 tensors
this rank sends through its hops, all-gathers and reduce-scatters, by
pass (``wire_bytes["forward"]``, ``["backward"]``): a hop sends its
tensors once, an all-gather this rank's piece to the N-1 other ranks, a
reduce-scatter N-1 of its N pieces.  Integer metadata (doc/pos) is not
counted there.  A second counter, ``wire_bytes_by_kind``, keeps the
sends by collective kind (``"permute"``, ``"all_gather"``,
``"reduce_scatter"``, ``"all_to_all"``, ``"all_reduce"``), the int32
metadata included, for the wire audit
(:mod:`repro_torch.analysis.wire_audit`) and the dry run, with the
reference's per-kind wire formulas (``launch/roofline.py``): a hop its
tensors once, an all-gather its result x (g-1)/g, a reduce-scatter its
operand x (g-1)/g, an all-to-all (g-1)/g of its operand, an all-reduce
2(g-1)/g of its tensor; ``wire_peak_by_kind`` keeps the largest result
one call of each kind produced on this rank.

:class:`RecordingComm` has this interface without a process group: one
rank ``rank`` of ``size``, whose collectives move nothing and return
tensors of the right shapes (``meta`` tensors for ``meta`` inputs),
counting the same bytes.  The islands and ZeRO-3 run on it unchanged:
the dry run (``launch/dryrun.py``) traces one rank's step with it.

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

__all__ = ["CPComm", "RecordingComm", "hop_start", "hop_wait", "all_gather_tiled",
           "int8_all_gather", "quantize_int8", "dequantize_int8",
           "all_to_all_tiled", "all_reduce_sum", "all_reduce_",
           "broadcast_"]

BACKENDS = ("nccl", "gloo")
#: the collective kinds ``CPComm.wire_bytes_by_kind`` counts
KINDS = ("permute", "all_gather", "reduce_scatter", "all_to_all",
         "all_reduce")


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
        self.reset_wire()

    def reset_wire(self) -> None:
        """Zero every byte counter."""
        self.wire_bytes = {"forward": 0, "backward": 0}
        self.wire_bytes_by_kind = dict.fromkeys(KINDS, 0)
        self.wire_peak_by_kind = dict.fromkeys(KINDS, 0)

    def count(self, tag: str, xs, factor: float = 1.0) -> None:
        """Add ``factor`` x the bytes of the floating and int8 tensors of
        ``xs`` to ``wire_bytes[tag]``."""
        n = sum(x.numel() * x.element_size() for x in xs
                if x.is_floating_point() or x.dtype == torch.int8)
        self.wire_bytes[tag] += int(n * factor)

    def count_kind(self, kind: str, xs, factor: float = 1.0,
                   result: float = 1.0) -> None:
        """Add ``factor`` x the bytes of every tensor of ``xs`` to
        ``wire_bytes_by_kind[kind]``; ``result`` x those bytes is the
        call's result, kept in ``wire_peak_by_kind[kind]`` if largest."""
        n = sum(x.numel() * x.element_size() for x in xs)
        self.wire_bytes_by_kind[kind] += int(n * factor)
        self.wire_peak_by_kind[kind] = max(self.wire_peak_by_kind[kind],
                                           int(n * result))

    def _global(self, r: int) -> int:
        r %= self.size
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)

    def _host_wire(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def _run(self, kind: str, out, wire, op=None) -> None:
        """One collective over the group: ``all_gather`` /
        ``reduce_scatter`` / ``all_to_all`` of ``wire`` into ``out``,
        ``all_reduce`` of ``wire`` in place by ``op``, ``broadcast`` of
        ``wire`` from global rank ``op``."""
        if kind == "all_gather":
            dist.all_gather_into_tensor(out, wire, group=self.group)
        elif kind == "reduce_scatter":
            dist.reduce_scatter_tensor(out, wire, group=self.group)
        elif kind == "all_to_all":
            dist.all_to_all_single(out, wire, group=self.group)
        elif kind == "all_reduce":
            dist.all_reduce(wire, op=op, group=self.group)
        elif kind == "broadcast":
            dist.broadcast(wire, op, group=self.group)
        else:
            raise ValueError(f"unknown collective {kind!r}")

    def start(self, xs, shift: int = 1, tag: str = "forward"
              ) -> "_Transfer":
        """Send each of ``xs`` to rank r+shift and receive the same shapes
        from rank r-shift; returns the transfer in flight.  ``tag`` is
        the pass whose ``wire_bytes`` count it."""
        self.count(tag, xs)
        self.count_kind("permute", xs)
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

    def exchange(self, xs, shift: int = 1, tag: str = "forward"
                 ) -> list[torch.Tensor]:
        """:meth:`start` and wait: the received tensors."""
        return self.start(xs, shift, tag).wait()


class RecordingComm(CPComm):
    """:class:`CPComm`'s interface for rank ``rank`` of a group of
    ``size`` with no process group: every collective moves nothing and
    its results have the right shapes and dtypes (what a ``meta`` input
    gives, or uninitialized memory), while the byte counters count what
    the real exchange would send.  The dry run's communicator."""

    def __init__(self, rank: int, size: int):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.backend = "recording"
        self.group = None
        self.rank, self.size = rank, size
        self.reset_wire()

    def _global(self, r: int) -> int:
        return r % self.size

    def _host_wire(self, x: torch.Tensor) -> bool:
        return False

    def _run(self, kind: str, out, wire, op=None) -> None:
        pass

    def start(self, xs, shift: int = 1, tag: str = "forward"
              ) -> "_Transfer":
        self.count(tag, xs)
        self.count_kind("permute", xs)
        recv = [torch.empty_like(x.detach(),
                                 memory_format=torch.contiguous_format)
                for x in xs]
        return _Transfer([], [], recv, [x.device for x in xs])


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


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q8, scale)`` of ``x``, one scale per row of its last axis (per
    (batch, head, token) of a K/V tensor), computed in f32:
    ``scale = max|x| / 127`` floored at 1e-8, ``q8 = clamp(round(x /
    scale), -127, 127)`` (round half to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-8)
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q8, scale


def dequantize_int8(q8: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q8.float() * scale).to(dtype)


class _Hop:
    """A ring hop's state between :func:`hop_start` and :func:`hop_wait`."""

    def __init__(self, comm: CPComm, int8: bool):
        self.comm = comm
        self.int8 = int8
        self.transfer = None


class _HopStart(torch.autograd.Function):
    """Start the hop; outputs are placeholders of the inputs' shapes that
    only :class:`_HopWait` reads.  On the int8 wire each floating input
    goes as its ``(q8, scale)`` pair."""

    @staticmethod
    def forward(ctx, hop, *xs):
        wire = []
        for x in xs:
            if hop.int8 and x.is_floating_point():
                wire.extend(quantize_int8(x))
            else:
                wire.append(x)
        hop.transfer = hop.comm.start(wire)
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
        got = iter(hop.transfer.wait())
        hop.transfer = None
        outs = tuple(
            dequantize_int8(next(got), next(got), p.dtype)
            if hop.int8 and p.is_floating_point() else next(got)
            for p in placeholders)
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        idx = [i for i, f in enumerate(ctx.floating) if f]
        back = ctx.comm.exchange([grads[i] for i in idx], shift=-1,
                                 tag="backward")
        out = [None] * len(grads)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, *out)


def hop_start(comm: CPComm, xs, *, int8: bool = False) -> tuple:
    """Start one ring hop of the tensors ``xs`` (to rank r+1, from rank
    r-1); ``int8`` sends the floating ones on the int8 wire.  Returns
    the handle for :func:`hop_wait`."""
    hop = _Hop(comm, int8)
    return hop, _HopStart.apply(hop, *xs)


def hop_wait(handle) -> tuple:
    """The tensors rank r-1 sent in the hop ``handle``."""
    hop, placeholders = handle
    return _HopWait.apply(hop, *placeholders)


def _along(x, comm: CPComm, dim: int, gather: bool, tag: str = "forward"):
    """All-gather (``gather``) or reduce-scatter (sum) ``x`` along
    ``dim``, tiled in rank order."""
    n = comm.size
    comm.count(tag, (x,), (n - 1) if gather else (n - 1) / n)
    if gather:
        comm.count_kind("all_gather", (x,), n - 1, result=n)
    else:
        comm.count_kind("reduce_scatter", (x,), (n - 1) / n, result=1 / n)
    xt = x.detach().movedim(dim, 0).contiguous()
    host = comm._host_wire(xt)
    wire = xt.cpu() if host else xt
    n = wire.shape[0] * comm.size if gather else wire.shape[0] // comm.size
    out = wire.new_empty((n, *wire.shape[1:]))
    comm._run("all_gather" if gather else "reduce_scatter", out, wire)
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
        return _along(g, ctx.comm, ctx.dim, gather=False,
                      tag="backward"), None, None


class _Int8AllGather(_AllGather):
    """The all-gather on the int8 wire; the backward is the inherited
    full-precision reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        q8, scale = quantize_int8(x)
        return dequantize_int8(_along(q8, comm, dim, gather=True),
                               _along(scale, comm, dim, gather=True),
                               x.dtype)


def all_gather_tiled(x: torch.Tensor, comm: CPComm, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    differentiable for floating ``x`` (backward: reduce-scatter)."""
    if not x.is_floating_point():
        return _along(x, comm, dim, gather=True)
    return _AllGather.apply(x, comm, dim)


def int8_all_gather(x: torch.Tensor, comm: CPComm, dim: int) -> torch.Tensor:
    """:func:`all_gather_tiled` of a floating ``x`` on the int8 wire:
    every rank's ``x``, quantized per row of the last axis (which ``dim``
    must not be), dequantized to ``x.dtype``; the backward reduce-scatters
    the full-precision cotangent."""
    if dim in (-1, x.dim() - 1):
        raise ValueError("the int8 wire scales the last axis: gather "
                         "along another")
    return _Int8AllGather.apply(x, comm, dim)


def _a2a(x, comm: CPComm, split_dim: int, concat_dim: int):
    """The tiled all-to-all of ``x`` (no gradient)."""
    n = comm.size
    comm.count_kind("all_to_all", (x,), (n - 1) / n)
    xs = x.detach().movedim(split_dim, 0).contiguous()
    host = comm._host_wire(xs)
    wire = xs.cpu() if host else xs
    out = torch.empty_like(wire)
    comm._run("all_to_all", out, wire)
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
    n = comm.size
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        comm.count_kind("all_reduce", (flat,), 2 * (n - 1) / n)
        wire = flat.cpu() if comm._host_wire(flat) else flat
        comm._run("all_reduce", None, wire, op)
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
        comm._run("broadcast", None, wire, comm._global(src))
        if wire is not t:
            with torch.no_grad():
                t.copy_(wire)
