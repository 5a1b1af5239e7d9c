"""STEP104/STEP105 — the f64 and host-sync audit of one training step
(the port's counterparts of the reference's HLO104 and HLO105, which
read the compiled step's HLO for f64 values and host transfers).

:class:`StepAudit` is a ``TorchDispatchMode`` run around exactly one
call of ``train_step`` (:func:`audit_step`).  It records

* **f64** (STEP104): every op with a float64 argument or result, and
  every cast of a float32 tensor to float64;
* **host syncs** (STEP105): ``aten::_local_scalar_dense`` and the other
  ops whose result is data the host reads (``.item()``, ``int()``,
  ``float()``, ``bool()`` of a tensor); device-to-host copies (an op
  with a CUDA argument and a host result); and ops whose result's shape
  depends on the data (``nonzero``, boolean-mask indexing,
  ``bincount``), which the host must wait for on the card.

Each finding names its site, the innermost frame of the port's own code
(``repro_torch/...:line`` and the function).  A site is keyed by its
file, function and kind, so line moves do not change the lists.  Some
sites are there by design: :data:`EXPECTED_SITES` names them, one list
for the card's path (``cuda``, read on the card by ``chip_smoke.py``'s
``step_audit`` phase) and one for the CPU path (``cpu``: the kernels'
plain twins), each with its reason.  An unlisted site is an error, and
so is any f64.  :func:`audit_findings` turns a report into findings
(``analysis.findings``).
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

__all__ = ["StepAudit", "Site", "EXPECTED_SITES", "audit_step",
           "audit_findings", "unexpected_sites"]

aten = torch.ops.aten
_PKG = os.sep + "repro_torch" + os.sep
#: ops whose boolean index argument makes the result's shape the data's
_MASK_INDEXED = {aten.index.Tensor, aten.index_put.default,
                 aten.index_put_.default, aten._index_put_impl_.default}

#: (file, function, kind) -> why the site is on that device's path.
#: The card's list, as the card reads it (``chip_smoke.py``'s
#: ``step_audit`` phase on the full-width main-path step): empty.  The
#: visit tables arrive on the device with the batch, the kernels' run
#: starts are computed there (``kernels.doc_attention.run_starts``), and
#: the ``ctypes`` launches read no device value.
EXPECTED_SITES: dict[str, dict[tuple[str, str, str], str]] = {
    "cuda": {},
    "cpu": {
        ("repro_torch/kernels/doc_attention.py", "_row_visits",
         "data-dependent shape"):
            "the kernels' plain twins regroup the flat work queue by "
            "row: the visited (row, step) pairs (nonzero)",
        ("repro_torch/kernels/doc_attention.py", "_row_visits", "item"):
            "the twins size the per-row visit lists by the longest row "
            "(int(nvis.max()))",
    },
}


@dataclasses.dataclass(frozen=True)
class Site:
    """One finding's place: the port's innermost frame, and what ran."""
    file: str            # "repro_torch/..."
    line: int
    function: str
    kind: str            # "item" | "device-to-host copy" |
                         # "data-dependent shape" | "f64" | "f32->f64 cast"
    op: str

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.file, self.function, self.kind)

    def render(self) -> str:
        return f"{self.file}:{self.line} ({self.function}) {self.kind}: " \
               f"{self.op}"


def _frame() -> tuple[str, int, str]:
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename
        i = path.rfind(_PKG)
        if i >= 0 and not path.endswith(os.path.join("analysis",
                                                     "step_audit.py")):
            return path[i + 1:].replace(os.sep, "/"), fr.lineno, fr.name
    return "<outside the port>", 0, "?"


def _tensors(xs) -> list:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class StepAudit(TorchDispatchMode):
    """Records the f64 and host-sync sites of what runs inside it
    (``sites``, in order, one entry per op)."""

    def __init__(self):
        super().__init__()
        self.sites: list[Site] = []
        self.ops = 0

    def _add(self, kind: str, func) -> None:
        file, line, fn = _frame()
        self.sites.append(Site(file, line, fn, kind, str(func)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if torch.Tag.data_dependent_output in func.tags:
            self._add("item", func)
        if torch.Tag.dynamic_output_shape in func.tags and (
                func not in _MASK_INDEXED
                or any(t.dtype in (torch.bool, torch.uint8) for t in ins)):
            self._add("data-dependent shape", func)
        if any(t.device.type == "cuda" for t in ins) and \
                any(t.device.type == "cpu" for t in outs):
            self._add("device-to-host copy", func)
        if any(t.dtype == torch.float64 for t in outs) and \
                any(t.dtype == torch.float32 for t in ins):
            self._add("f32->f64 cast", func)
        elif any(t.dtype == torch.float64 for t in ins + outs):
            self._add("f64", func)
        return out


def audit_step(train_step, *args, **kwargs):
    """``(result, audit)``: one call of ``train_step(*args, **kwargs)``
    under a :class:`StepAudit`, and nothing else."""
    with StepAudit() as audit:
        result = train_step(*args, **kwargs)
    return result, audit


def unexpected_sites(sites, device_type: str) -> list[Site]:
    """The sites not named for ``device_type`` ("cuda" or "cpu"): every
    f64 site and every host sync the device's list does not give."""
    allowed = EXPECTED_SITES[device_type]
    return [s for s in sites
            if s.kind in ("f64", "f32->f64 cast") or s.key not in allowed]


def audit_findings(sites, device_type: str,
                   context: str = "train_step") -> list[Finding]:
    """STEP104 for each f64 site, STEP105 for each host sync not on
    ``device_type``'s list; one finding per distinct site."""
    out, seen = [], set()
    for s in unexpected_sites(sites, device_type):
        where = f"{s.file}:{s.line} ({s.function})"
        if (where, s.kind) in seen:
            continue
        seen.add((where, s.kind))
        if s.kind in ("f64", "f32->f64 cast"):
            out.append(Finding(
                "STEP104", "error", where,
                f"{s.kind} in {context}: {s.op}",
                hint="keep the step in f32/bf16: f64 doubles the bytes "
                     "and has no bf16 tensor-core path"))
        else:
            out.append(Finding(
                "STEP105", "error", where,
                f"host sync in {context} ({s.kind}): {s.op}",
                hint="keep the value on the device, or name the site in "
                     f"step_audit.EXPECTED_SITES[{device_type!r}] with "
                     "its reason"))
    return out
