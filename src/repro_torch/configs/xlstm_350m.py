"""xlstm-350m [ssm] — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

No attention, hence no KV exchange: FlashCP's technique is inapplicable
(DESIGN.md §Arch-applicability).  CP uses contiguous sequence sharding with
associative chunk-summary state exchange only.  One sLSTM block per 4
(the rest mLSTM); d_ff=0 means the recurrent blocks carry their own
up/down projections (expand factor 2) and there is no separate FFN.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    slstm_every=4,
    mamba_expand=2,
)
