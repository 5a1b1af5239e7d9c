"""Static plan and wire verification of the port (DESIGN.md
§Static-analysis; the port's copy of the reference's ``repro.analysis``).

Three layers:

* Layer 1 — :mod:`repro_torch.analysis.plan_check`: host-numpy
  structural checks over planner outputs (shard plans, encodings, visit
  tables, work queues) and serve block tables.
* Layer 2 — :mod:`repro_torch.analysis.wire_audit`: the K/V bytes each
  rank's :class:`~repro_torch.core.comm.CPComm` sent, by collective
  kind, against the plan's analytic comm budget (the reference audits
  the lowered HLO instead).
* Layer 3 — :mod:`repro_torch.analysis.lint`: AST rules for determinism
  and hygiene.

Each layer emits :class:`repro_torch.analysis.findings.Finding` records;
``scripts/flashcheck_torch.py`` is the command-line entry point.
"""

from repro_torch.analysis.findings import Finding, RULES, errors, format_findings

__all__ = ["Finding", "RULES", "errors", "format_findings"]
