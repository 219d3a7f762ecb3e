"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    hybrid_period=8,        # 1 attention layer per 8 (1:7)
    moe_every=2,            # MoE on every other layer
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    act="swiglu",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=128, num_experts=4, ssm_state=16, ssm_head_dim=16,
)
