"""gemma3-1b [dense] — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

The JAX package's gemma3 config, field for field: 26 layers, d_model
1152, 4 query heads over 1 KV head of 256, a gelu MLP of d_ff 6912, vocab
262144 with tied embeddings, window 512, every 6th layer global.  The
model is the JAX package's dense decoder, not Google's Gemma 3: no gated
GeGLU, no pre- and post-norms, no QK-norm, no sqrt(d) embedding scaling
and one RoPE theta for local and global layers."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    window=512,
    local_global_period=6,  # 5 local : 1 global
    act="gelu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=6, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=512, window=8, local_global_period=3,
)
