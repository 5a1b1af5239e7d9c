"""Structured findings shared by all three analysis layers.

A :class:`Finding` is one violation (or advisory) tied to a rule id from
the :data:`RULES` registry.  Rule ids are stable and documented in
DESIGN.md §Static-analysis — tests and CI key on them, so adding a rule
means adding a registry entry (and a DESIGN.md row), never renaming one.

The port keeps every rule of the reference's registry that has a meaning
for a torch program, with the reference's text.  It leaves out the rules
that read XLA or Pallas program text: HLO101–HLO106 (collectives, f64,
host transfers and buffer donation in lowered HLO) and KER001 (traced
Python branches in Pallas kernel bodies).  In place of HLO101–HLO103 it
has WIRE101–WIRE103, the same budget rules over the bytes each rank's
``CPComm`` sent (:mod:`repro_torch.analysis.wire_audit`), and in place
of HLO104–HLO105 STEP104–STEP105, the f64 and host-transfer rules over
the ops of one eager training step (:mod:`repro_torch.analysis.
step_audit`).
"""

from __future__ import annotations

import dataclasses

__all__ = ["Finding", "RULES", "errors", "format_findings"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structural violation.

    ``location`` is a ``file:line`` reference for lint findings and a
    human-readable context string ("plan cp=4 arch=llama3_70b", "queue
    row 3") for plan/wire findings.
    """

    rule: str                 # registry key, e.g. "PLAN001"
    severity: str             # "error" | "warning"
    location: str
    message: str
    hint: str = ""            # one-line suggested fix

    def __post_init__(self) -> None:
        assert self.rule in RULES, f"unregistered rule id: {self.rule}"
        assert self.severity in ("error", "warning"), self.severity

    def render(self) -> str:
        sev = self.severity.upper()
        out = f"{sev} {self.rule} [{self.location}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


#: rule id -> one-line invariant.  The prose expansion (origin bug, fix
#: guidance) lives in DESIGN.md §Static-analysis.
RULES: dict[str, str] = {
    # --- Layer 1: shard plans -------------------------------------- #
    "PLAN001": "every document token is covered exactly once, in order",
    "PLAN002": "shard doc/worker ids and lengths are in range and positive",
    "PLAN003": "equal-token constraint (Eq.2): each rank holds C/N tokens",
    "PLAN004": "per-rank workload imbalance within the declared bound",
    # --- Layer 1: plan encodings ----------------------------------- #
    "ENC001": "perm is an exact permutation of packed token positions",
    "ENC002": "encoded doc/pos agree with the plan's shard layout",
    "ENC003": "causal closure: every KV a query attends to is local or gathered",
    "ENC004": "no redundant KV exchange: only non-last shard tokens are sent (Eq.5)",
    "ENC005": "every non-last shard token is sent (completeness of Eq.4/5)",
    # --- Layer 1: visit tables ------------------------------------- #
    "TAB001": "visit tables are sound vs. the dense per-token visibility oracle",
    "TAB002": "visit-table indices are in range with -1/-2 padding discipline",
    # --- Layer 1: work queues -------------------------------------- #
    "WQ001": "work-queue FIRST/LAST/VALID flags are well-formed per row",
    "WQ002": "work-queue rows are in LPT order (stable ties)",
    "WQ003": "flat queue visits exactly the rectangular grid's visit set",
    # --- Layer 1: serve block tables ------------------------------- #
    "SRV001": "no cross-request block aliasing without a prefix-trie entry",
    "SRV002": "block refcounts conserve against table uses + cache + free list",
    "SRV003": "block-table entries are valid pool block ids",
    # --- Layer 1: autotune search space ----------------------------- #
    "TUNE001": "candidate enumeration is deterministic, sorted, and deduplicated",
    "TUNE002": "every enumerated candidate passes its own admissibility predicate",
    # --- Layer 2: wire audit --------------------------------------- #
    "WIRE101": "no collective kind the plan's comm budget didn't predict",
    "WIRE102": "per-kind wire bytes within the analytic comm budget",
    "WIRE103": "no unintended full KV all-gather",
    # --- Layer 2: step audit --------------------------------------- #
    "STEP104": "no f64 values or f32->f64 upcasts in the step program",
    "STEP105": "no host syncs in the step (.item(), device-to-host copies, "
               "data-dependent shapes) but the device's named sites",
    # --- Layer 3: repo lint ---------------------------------------- #
    "RNG001": "no unseeded RNG in planner/, dispatch/, or autotune/ (replay purity)",
    "RNG002": "no set-iteration-order dependence in planner/dispatch/autotune",
    "DEP001": "no imports of deprecated repro.core.* shims outside the shims",
    "HYG001": "no unused imports",
    "HYG002": "no mutable default arguments",
    "HYG003": "no shadowed builtins in assignments or parameters",
}


def errors(findings: list[Finding]) -> list[Finding]:
    """The error-severity subset (what makes flashcheck exit nonzero)."""
    return [f for f in findings if f.severity == "error"]


def format_findings(findings: list[Finding]) -> str:
    if not findings:
        return "clean: no findings"
    lines = [f.render() for f in findings]
    n_err = len(errors(findings))
    n_warn = len(findings) - n_err
    lines.append(f"-- {n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)
