"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    act="swiglu",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, num_experts=4, top_k=2,
)
