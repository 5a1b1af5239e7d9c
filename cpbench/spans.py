"""What the port records of itself in a traced window, for the per-layer
readers of its spans and counters (``metrics/*.py``).

The port's recorder (``repro_torch.obs``) records exactly while a torch
profiler runs, which in a run is the ``--trace 1`` window alone; the
readers run in the same process after the window.  Each helper gives
``None`` where the recorder holds nothing to read: a ``--trace 0`` run, a
port without the recorder, or device ms without CUDA.
"""

from __future__ import annotations

__all__ = ["recorded", "window_steps", "device_ms_per_step",
           "host_ms_per_step"]


def recorded() -> dict | None:
    """``repro_torch.obs.summary()``, or None where it holds nothing."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    s = obs.summary()
    return s if s["records"] or s["counters"] else None


def window_steps(run) -> set:
    """The step ids of the window's steps."""
    return {s["step"] for s in run.steps}


def device_ms_per_step(run, name: str) -> float | None:
    """Device ms between the entry and exit events of the spans ``name``
    of the window's steps, summed a step, the mean over those steps."""
    s = recorded()
    if s is None or not run.steps:
        return None
    steps = window_steps(run)
    ms = [r["device_ms"] for r in s["records"]
          if r["name"] == name and r["step"] in steps and "device_ms" in r]
    return sum(ms) / len(steps) if ms else None


def host_ms_per_step(run, name: str, *, empty: float | None = None
                     ) -> float | None:
    """Host ms of every span ``name`` recorded (on any thread, with or
    without a step id), over the window's steps; ``empty`` where the
    recorder holds records but none of the name."""
    s = recorded()
    if s is None or not run.steps:
        return None
    ms = [r["host_ms"] for r in s["records"] if r["name"] == name]
    return sum(ms) / len(run.steps) if ms else empty
