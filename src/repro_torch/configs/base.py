"""Model and serving configuration for the PyTorch port.

The port's own copy of the part of the JAX package's config system that
the ported families read: ``ModelConfig`` with the fields of the dense,
MoE, hybrid (Jamba), SSM (xLSTM), audio (frame embeddings in place of
tokens) and VLM (patch embeddings at masked positions) stacks, the
serving, training and dispatch fields of ``RunConfig``, the input shapes
of the dry run (``ShapeConfig``, ``SHAPES``) and ``reduce_for_smoke``.
Plain frozen dataclasses; the values of every configuration are the
same as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig", "RunConfig", "reduce_for_smoke"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mlp: Literal["glu", "gelu"] = "glu"   # silu-GLU (llama) vs plain gelu MLP
    # --- MoE ----------------------------------------------------------- #
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                # apply MoE FFN every k-th layer
    capacity_factor: float = 1.25
    # --- hybrid (jamba): 1 attention layer per `attn_every` layers ----- #
    attn_every: int = 0               # 0 -> attention everywhere
    attn_offset: int = 4              # which layer inside the period is attn
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- xLSTM --------------------------------------------------------- #
    slstm_every: int = 0              # 1 sLSTM block per k blocks (rest mLSTM)
    # --- modality frontend (precomputed embeddings from the batch) ---- #
    frontend: Literal["none", "audio_frames", "vit_patches"] = "none"
    num_patch_tokens: int = 256       # vlm: image tokens at sequence start
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500K-token decode (SSM/hybrid families)?"""
        return self.family in ("ssm", "hybrid")

    def _is_moe_layer(self, layer: int) -> bool:
        return self.num_experts > 0 \
            and layer % self.moe_every == self.moe_every - 1

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included): attention,
        Mamba, mLSTM or sLSTM mixers with dense or MoE FFNs."""
        d, dff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        ffn = (3 if self.mlp == "glu" else 2) * d * dff
        di = d * self.mamba_expand
        dt_rank = max(1, d // 16)
        mamba = (2 * d * di                               # in_proj
                 + self.mamba_d_conv * di + di            # conv
                 + di * (dt_rank + 2 * self.mamba_d_state)    # x_proj
                 + dt_rank * di + di                      # dt_proj
                 + di * self.mamba_d_state + di           # A_log, D
                 + di * d)                                # out_proj
        mlstm = 2 * d * di + 3 * di * di + 2 * di * self.num_heads + di * d
        slstm = 5 * d * d
        total = 0
        for layer in range(L):
            if self.family == "ssm":
                is_slstm = self.slstm_every and \
                    layer % self.slstm_every == self.slstm_every - 1
                total += slstm if is_slstm else mlstm
            elif self.attn_every == 0 \
                    or layer % self.attn_every == self.attn_offset:
                total += attn
            else:
                total += mamba
            if dff > 0:
                total += self.num_experts * ffn + d * self.num_experts \
                    if self._is_moe_layer(layer) else ffn
            total += 2 * d                                # norms
        total += self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if self.num_experts == 0:
            return self.param_count()
        ffn = (3 if self.mlp == "glu" else 2) * self.d_model * self.d_ff
        n_moe = sum(self._is_moe_layer(i) for i in range(self.num_layers))
        return self.param_count() - n_moe * (self.num_experts
                                             - self.top_k) * ffn


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


#: the assigned input-shape set (applies to every architecture)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Serving and training defaults shared by the engines and the CLIs.
    The training fields take the reference's defaults, except that
    ``attention_impl`` defaults to the kernels (``"flash"``, the
    reference's ``"pallas"``; ``"plain"`` is its ``"xla"``)."""
    arch: str = "starcoder2_3b"
    cp_strategy: Literal["flashcp", "llama3", "per_doc", "ring",
                         "contiguous"] = "flashcp"
    attention_impl: Literal["flash", "plain"] = "flash"
    # chunked = local-KV partial + N-1 merged hops (at one device: the
    # local partial); none = the monolithic islands
    cp_overlap: Literal["chunked", "none"] = "chunked"
    # kernel schedule: flat = work queue in LPT row order; rect = the
    # padded rectangular visit lists
    kernel_grid: Literal["flat", "rect"] = "flat"
    # adaptive DP x CP dispatch: "adaptive" re-tiles the mesh into CP
    # groups of a degree sized per batch and LPT-balances the documents
    # over them (ragged rows; the loss stays the global masked mean)
    dispatch: Literal["off", "adaptive"] = "off"
    dispatch_target_imbalance: float = 1.1
    dispatch_min_cp: int = 1
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    grad_compression: Literal["none", "topk", "int8"] = "none"
    # the CP islands' K/V wire: int8 values with one f32 scale per
    # (batch, head, token), straight-through gradients
    kv_comm_dtype: Literal["native", "int8"] = "native"
    # '' = no checkpoints (the reference writes /tmp/repro_ckpt; the port
    # writes only where its caller says)
    checkpoint_dir: str = ""
    remat: bool = True
    # decode attention: flash-decode kernel (default) vs the dense
    # softmax parity oracle (models/attention.py::attn_decode)
    decode_impl: Literal["flash", "dense"] = "flash"
    # "paged" = global block pool + per-request block tables + prefix
    # sharing; "dense" = per-slot stripes (parity oracle); "auto" = paged
    kv_layout: Literal["auto", "paged", "dense"] = "auto"
    serve_block_size: int = 16
    # tokens one engine step may spend across prefill chunks + decodes
    # (0 = num_slots + prefill_chunk)
    serve_token_budget: int = 0
    # DESIGN.md §Serving-resilience: queue bound (0 = unbounded),
    # overload policy, and how many requests may jump a blocked head
    serve_max_queue: int = 0
    serve_admission: Literal["fifo", "deadline"] = "fifo"
    serve_admit_lookahead: int = 4
    serve_stall_patience: int = 8
    seed: int = 0


def run_config_to_dict(run: RunConfig) -> dict:
    """JSON-serializable field dict of a :class:`RunConfig` (every field
    is a scalar, so ``asdict`` round-trips losslessly)."""
    return dataclasses.asdict(run)


def run_config_from_dict(d: dict) -> RunConfig:
    """Inverse of :func:`run_config_to_dict`.  Unknown keys are ignored so
    tuned configs written by a newer tuner still load (the autotuner's
    cache stores these dicts — DESIGN.md §Autotune)."""
    known = {f.name for f in dataclasses.fields(RunConfig)}
    return RunConfig(**{k: v for k, v in d.items() if k in known})


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size, keeping its GQA ratio, its
    MoE top-k (at most 4 experts, top-2), its hybrid interleave (one
    whole period of ``attn_every`` layers) and its frontend (at most 16
    patch tokens)."""
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv, min(cfg.num_heads, 4))
    heads = (heads // kv) * kv or kv
    return dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers,
                       4 if cfg.attn_every == 0 else cfg.attn_every),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        num_patch_tokens=min(cfg.num_patch_tokens, 16),
        mamba_d_state=8,
        dtype="float32",
    )
