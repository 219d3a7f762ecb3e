"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone; the conv
frame frontend is a STUB (the caller provides frame embeddings).
[arXiv:2106.07447; unverified]

The JAX package's config, field for field: 48 non-causal layers, d_model
1280, 16 heads of 80, a gelu MLP of d_ff 5120, vocab 504."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    act="gelu",
    frontend="audio_frames",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=32,
)
