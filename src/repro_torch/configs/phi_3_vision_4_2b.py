"""phi-3-vision-4.2b [vlm] — phi3-mini backbone; the CLIP patch frontend is
a STUB (the caller provides patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The JAX package's config, field for field: 32 causal layers, d_model
3072, 32 heads of 96, a swiglu MLP of d_ff 8192, vocab 32064, 256 patch
embeddings in front of the text tokens."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    act="swiglu",
    frontend="vision_patches",
    num_patches=256,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, num_patches=8,
)
