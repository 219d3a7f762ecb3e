"""Model configuration for the dense, MoE, SSM (Mamba-2) and hybrid
(Jamba) decoder families, the audio encoder and the vision-prefix decoder
(port of ``repro.models.config``).

Field names, defaults and meanings are the JAX package's, for the fields
the ported families read (the local/global attention pattern of gemma3,
``causal``, the modality ``frontend`` stubs and the SSM / hybrid fields
included); ``torch_dtype`` replaces ``jnp_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sparse_linear import SparsityConfig

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int              # 0 for attn-free
    num_kv_heads: int
    d_ff: int                   # dense MLP or per-expert FFN width
    vocab_size: int
    head_dim: int = 128
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # expert execution: "gather" scatters a capacity of tokens per expert
    # into a dense tile; "spgemm" keeps the full token set and runs the
    # expert FFN as a sparse x sparse contraction (routing holes become
    # activation sparsity the masked kernels skip)
    moe_expert_path: str = "gather"
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # --- attention pattern ---
    causal: bool = True
    window: int = 0             # >0: sliding-window size for "local" layers
    local_global_period: int = 0  # e.g. 6 for gemma3's 5:1 (every 6th global)
    hybrid_period: int = 0      # jamba: 8 (1 attn layer per period)
    moe_every: int = 0          # jamba: 2 (MoE on every other layer)
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # --- modality frontend (a stub: the caller provides the embeddings) ---
    frontend: str = "none"      # none | audio_frames | vision_patches
    num_patches: int = 0        # vlm: image tokens per sample
    # --- sparsity (the paper's feature) ---
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    # --- numerics ---
    dtype: str = "bfloat16"
    attn_p_bf16: bool = False   # store attention probs bf16 (perf knob)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_is_global(self, i: int) -> bool:
        """gemma3-style local:global interleave (last of each period global)."""
        if self.local_global_period <= 0 or self.window <= 0:
            return True
        return (i % self.local_global_period) == self.local_global_period - 1

    def with_sparsity(self, sp: SparsityConfig) -> "ModelConfig":
        return dataclasses.replace(self, sparsity=sp)
