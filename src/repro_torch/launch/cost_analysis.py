"""A traced cost analysis of one rank's step (the port's counterpart of
the reference's ``launch/hlo_analysis.py``, which reads XLA's compiled
module).

:class:`CostMode` is a ``TorchDispatchMode``: run one rank's step on
``meta`` tensors inside it (nothing is computed or allocated) and it
records, op by op,

* **FLOPs**, with ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention; elementwise ops count none, as the
  reference's dot-only count);
* **bytes** read plus written: every tensor argument's and every
  result's bytes, view ops excepted.  Eager PyTorch runs every op
  through device memory, so this is the unfused upper bound of the
  step's traffic, above what the reference's post-fusion HLO count
  gives for the same program;
* the **peak of live bytes**: the storages alive before the step (its
  state and inputs, :meth:`CostMode.track`) plus every storage an op
  creates, until it is freed (a weak reference per storage);
* and, beside it, the same three with the **logits-shaped** intermediates
  left out (``logits_shapes``: the ``(shape, dtype)`` of the attention
  score and mask tensors, the counterpart of the reference's
  ``_logits_sized``; matched by shape, so that an activation of the same
  byte size is not taken for a score): the doc kernels keep those on
  chip, so the kernel-adjusted bytes and peak are what the card's kernel
  path moves and holds.

The collective wire bytes are not seen here: the recording communicator
(``core.comm.RecordingComm``) counts them.  A few ops have no ``meta``
kernel; :data:`META_SHAPES` gives their result shape where the step's
data bounds it (``bincount`` of expert ids with ``minlength`` = the
expert count).  The ``meta`` kernels of pointwise ops compute their
result's strides in Python (a third of a millisecond an op, most of a
full-width trace), so on ``meta`` inputs the mode makes a pointwise
op's result itself: the broadcast shape, contiguous, in the dtype the
op gives one-element tensors of the same dtypes and ranks (cached).
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["CostMode", "META_SHAPES", "tensor_bytes"]

aten = torch.ops.aten


def _bincount(x, weights=None, minlength=0):
    # ids below minlength (the router's expert ids): the result has
    # minlength entries
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.zeros((minlength,), dtype=dtype, device=x.device)


#: ops without a ``meta`` kernel: the result the step's data gives
META_SHAPES = {aten.bincount.default: _bincount}


def _leaves(args, kwargs) -> list:
    """The arguments, tensor lists opened (ops nest at most one deep)."""
    out = []
    for x in (*args, *kwargs.values()):
        if isinstance(x, (list, tuple)):
            out.extend(x)
        else:
            out.append(x)
    return out


def _broadcast(shapes) -> tuple:
    n = max((len(s) for s in shapes), default=0)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _probe(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros((1,) * min(x.dim(), 1), dtype=x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_probe(y) for y in x)
    return x


def _pointwise(func, args, kwargs, dtypes: dict):
    """The ``meta`` result of a pointwise op, or None where the fast
    rule does not apply (an input off ``meta`` that is not a 0-d
    scalar, an op with another result than one tensor); ``dtypes``
    caches the result dtype by op and argument dtypes."""
    if func._schema.is_mutable:
        return None
    shapes, key = [], [func, tuple(kwargs)]
    for x in _leaves(args, kwargs):
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta" and x.dim():
                return None
            shapes.append(x.shape)
            key.append((x.dtype, x.dim() == 0))
        else:
            key.append(type(x))
    key = tuple(key)
    dtype = dtypes.get(key)
    if dtype is None:
        out = func(*_probe(args), **{k: _probe(v) for k, v in kwargs.items()})
        dtype = dtypes[key] = out.dtype \
            if isinstance(out, torch.Tensor) else False
    if dtype is False:
        return None
    return torch.empty(_broadcast(shapes), dtype=dtype, device="meta")


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """FLOPs, bytes and peak live bytes of what runs inside it (see the
    module docstring); ``logits_shapes`` are the ``(shape, dtype)`` of
    the tensors left out of the kernel-adjusted figures."""

    def __init__(self, logits_shapes=frozenset()):
        super().__init__()
        self.logits_shapes = frozenset(logits_shapes)
        self.flops = 0
        self.bytes = 0
        self.excluded_bytes = 0
        self.ops = 0
        self.flops_by_op: dict[str, int] = {}
        self._dtypes: dict = {}
        self._live = WeakIdKeyDictionary()
        self.live_bytes = self.live_bytes_adj = 0
        self.peak_bytes = self.peak_bytes_adj = 0

    def on_chip(self, t: torch.Tensor) -> bool:
        return (tuple(t.shape), t.dtype) in self.logits_shapes

    # -------------------------------------------------------------- #
    # live storages
    # -------------------------------------------------------------- #
    def _freed(self, nbytes: int, on_chip: bool, _ref) -> None:
        self.live_bytes -= nbytes
        if not on_chip:
            self.live_bytes_adj -= nbytes

    def _hold(self, t: torch.Tensor, step: bool = True) -> None:
        """Count ``t``'s storage as live until it is freed; a storage the
        step made (``step``) of a logits shape is on chip for the
        kernel-adjusted peak."""
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        on_chip = step and self.on_chip(t)
        self._live[st] = weakref.ref(
            st, lambda r, n=n, c=on_chip: self._freed(n, c, r))
        self.live_bytes += n
        if not on_chip:
            self.live_bytes_adj += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self.peak_bytes_adj = max(self.peak_bytes_adj, self.live_bytes_adj)

    def track(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (the state and
        inputs made before the step) as live."""
        for tree in trees:
            for t in tree_flatten(tree)[0]:
                if isinstance(t, torch.Tensor):
                    self._hold(t, step=False)

    # -------------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        shim = META_SHAPES.get(func)
        ins = [t for t in _leaves(args, kwargs)
               if isinstance(t, torch.Tensor)]
        meta = any(t.device.type == "meta" for t in ins)
        out = None
        if shim is not None and meta:
            out = shim(*args, **kwargs)
        elif meta and torch.Tag.pointwise in func.tags:
            out = _pointwise(func, args, kwargs, self._dtypes)
        if out is None:
            out = func(*args, **kwargs)
        outs = [t for t in (out if isinstance(out, (list, tuple))
                            else (out,)) if isinstance(t, torch.Tensor)]
        self.ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            f = int(count(*args, **kwargs, out_val=out))
            self.flops += f
            name = str(func._overloadpacket)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + f
        if not func.is_view:
            moved = ins + outs
            self.bytes += sum(map(tensor_bytes, moved))
            self.excluded_bytes += sum(tensor_bytes(t) for t in moved
                                       if self.on_chip(t))
        for t in outs:
            self._hold(t)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_kernel_adjusted": self.bytes - self.excluded_bytes,
                "peak_bytes": self.peak_bytes,
                "peak_bytes_kernel_adjusted": self.peak_bytes_adj,
                "ops": self.ops,
                "flops_by_op": dict(sorted(self.flops_by_op.items()))}
