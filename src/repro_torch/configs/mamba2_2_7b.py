"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, vocab_size=256, ssm_state=16, ssm_head_dim=16,
)
