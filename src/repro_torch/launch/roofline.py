"""Roofline terms of one rank's step (the port of the reference's
``repro.launch.roofline``, without its HLO parsing).

Per (arch x shape x mesh) the dry run (:mod:`repro_torch.launch.dryrun`)
records, for one rank (all quantities per device):

  compute term    = FLOPs / peak_FLOP/s
  memory term     = bytes / HBM_bw
  collective term = wire bytes / interconnect bandwidth

The FLOPs, bytes and wire bytes come from a trace of the rank's step
(:mod:`repro_torch.launch.cost_analysis`), the wire bytes by collective
kind with the reference's formulas (all-gather result x (g-1)/g,
reduce-scatter operand x (g-1)/g, all-reduce 2(g-1)/g, all-to-all
(g-1)/g, a permute one hop; ``core.comm``).  The constants are the
H100's of :data:`repro_torch.autotune.cost_model.HW`, measured on the
card (``chip_smoke.py``'s ``cost_model`` phase, ``scripts/
nccl_allgather_bw.py``); they are a model, so the terms are a
prediction, not a measurement.  MODEL_FLOPS (6 N_active D for training,
2 N_active D for inference) over the traced FLOPs exposes remat and
redundancy.
"""

from __future__ import annotations

from repro_torch.autotune.cost_model import HW

__all__ = ["HW", "roofline_terms", "model_flops"]


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: dict = HW) -> dict:
    t_c = flops_per_dev / hw["peak_flops"]
    t_m = bytes_per_dev / hw["hbm_bw"]
    t_n = coll_bytes_per_dev / hw["ici_bw"]
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
                   key=lambda kv: kv[1])[0]
    bound = max(t_c, t_m, t_n)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dominant,
        # fraction of the step the compute roofline would occupy if the
        # dominant term were fully overlapped with compute
        "roofline_fraction": (t_c / bound) if bound > 0 else 0.0,
    }


def model_flops(cfg, shape, *, per_device_tokens: int | None = None,
                num_devices: int = 256) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference),
    per device."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    return mult * n_active * tokens / num_devices
