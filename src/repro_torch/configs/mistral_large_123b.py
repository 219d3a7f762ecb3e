"""mistral-large-123b [dense] — GQA kv=8.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    act="swiglu",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
