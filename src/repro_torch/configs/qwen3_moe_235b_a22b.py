"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-235B-A22B; hf]

The widths are those of Qwen/Qwen3-235B-A22B (d_model 4096, 64 query and
4 KV heads of 128, 128 experts of d_ff 1536, top-8, vocab 151936, 94
layers).  The model is the JAX package's MoE decoder: Qwen3's per-head
q/k RMSNorm is not part of it."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    act="swiglu",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, num_experts=8, top_k=2,
)
