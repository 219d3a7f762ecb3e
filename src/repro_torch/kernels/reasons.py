"""The dispatch-reason catalog: every way the engine declines.

The port's copy of ``repro.kernels.reasons``.  Member names and their
string values are the same as the JAX package's (budget manifests and
audit JSON name codes by value); the rendered text names the torch
reference tier where the JAX package names the jnp tier.
"""

from __future__ import annotations

import enum
from typing import Any

import torch

__all__ = ["ReasonCode", "render", "dtype_name", "epilogue_annotation",
           "activation_annotation"]


class ReasonCode(str, enum.Enum):
    """Every structured reason the dispatch engine can report."""

    # --- reference tier (the decision routed off the kernels) ---
    SRSTE_TRAINING = "srste-training"
    BACKEND_JNP = "backend-jnp"
    AUTODIFF = "autodiff"
    NO_SHARD_SPEC = "no-shard-spec"
    EMPTY_BATCH = "empty-batch"
    SHARD_INDIVISIBLE = "shard-indivisible"
    META_AXIS_SPLIT = "meta-axis-split"
    NO_KERNEL_FITS = "no-kernel-fits"
    # --- kernel tier (blocks provenance; decision ran a kernel) ---
    BLOCKS_PINNED = "blocks-pinned"
    BLOCKS_TUNED = "blocks-tuned"
    BLOCKS_FITTED = "blocks-fitted"
    # --- epilogue fusion ---
    EPILOGUE_FUSED = "epilogue-fused"
    EPILOGUE_JNP_TIER = "epilogue-jnp-tier"
    EPILOGUE_SHARDED = "epilogue-sharded"
    EPILOGUE_NO_DUAL_KERNEL = "epilogue-no-dual-kernel"
    # --- activation-sparsity skip ---
    ACT_SKIP = "activation-skip"
    ACT_MASK_ONLY_JNP = "activation-mask-only-jnp"
    ACT_MASK_ONLY_SHARDED = "activation-mask-only-sharded"
    ACT_MASK_ONLY_DUAL = "activation-mask-only-dual"
    ACT_MASK_ONLY_ENTRY = "activation-mask-only-entry"
    # --- producer-side fused requantize ---
    REQUANT_FUSED = "requant-fused"
    REQUANT_NO_QUANT = "requant-no-quantized-consumer"
    REQUANT_DYNAMIC_SCALES = "requant-dynamic-scales"
    REQUANT_LAYOUT = "requant-layout"
    REQUANT_CONSUMER_FALLBACK = "requant-consumer-fallback"


_TEMPLATES = {
    ReasonCode.SRSTE_TRAINING: "SR-STE training path needs its custom VJP",
    ReasonCode.BACKEND_JNP: "backend=torch",
    ReasonCode.AUTODIFF: "under autograd: kernels carry no backward",
    ReasonCode.NO_SHARD_SPEC:
        "mesh env active with no use-site shard spec",
    ReasonCode.EMPTY_BATCH: "empty batch",
    ReasonCode.SHARD_INDIVISIBLE:
        "shard spec {shards} does not divide (b={b},ke={ke},o={o})",
    ReasonCode.META_AXIS_SPLIT:
        "shard spec slices the {n}:{m} metadata axis non-divisibly "
        "(ke={ke} over {ske} shards)",
    ReasonCode.NO_KERNEL_FITS:
        "no registered kernel fits {where}(b={b},ke={ke},o={o},"
        "{n}:{m},{dtype})",
    ReasonCode.BLOCKS_PINNED: "blocks pinned by config",
    ReasonCode.BLOCKS_TUNED: "autotuned blocks (cache)",
    ReasonCode.BLOCKS_FITTED: "fitted default blocks",
    ReasonCode.EPILOGUE_FUSED: "epilogue applied in the kernel flush",
    ReasonCode.EPILOGUE_JNP_TIER:
        "epilogue unfused: torch reference tier applies apply_reference",
    ReasonCode.EPILOGUE_SHARDED:
        "epilogue unfused: sharded partials reduce before the epilogue",
    ReasonCode.EPILOGUE_NO_DUAL_KERNEL:
        "epilogue unfused: selected entry carries no dual kernel",
    ReasonCode.ACT_SKIP: "dead K-blocks skipped in-kernel",
    ReasonCode.ACT_MASK_ONLY_JNP:
        "mask-only: torch reference contracts the masked operand",
    ReasonCode.ACT_MASK_ONLY_SHARDED:
        "mask-only: sharded bodies take no per-shard skip maps",
    ReasonCode.ACT_MASK_ONLY_DUAL: "mask-only: no masked dual (gate-up) kernels",
    ReasonCode.ACT_MASK_ONLY_ENTRY:
        "mask-only: selected entry carries no masked variant",
    ReasonCode.REQUANT_FUSED:
        "producer fuses requantize against the consumer's static scale",
    ReasonCode.REQUANT_NO_QUANT: "no fused requantize: consumer is not quantized",
    ReasonCode.REQUANT_DYNAMIC_SCALES:
        "no fused requantize: consumer has no calibrated static scale",
    ReasonCode.REQUANT_LAYOUT:
        "no fused requantize: consumer layout is not a plannable linear "
        "(e.g. rowwise tiers)",
    ReasonCode.REQUANT_CONSUMER_FALLBACK:
        "no fused requantize: consumer plans off the single-placement "
        "kernel tier",
}


def render(code: ReasonCode, **ctx: Any) -> str:
    """The display string for one reason code (THE reason-text factory)."""
    return _TEMPLATES[ReasonCode(code)].format(**ctx)


def epilogue_annotation(code) -> str:
    """``describe()``'s bracket suffix for an epilogue decision."""
    return "fused" if ReasonCode(code) is ReasonCode.EPILOGUE_FUSED else "torch"


def activation_annotation(code) -> str:
    """``describe()``'s bracket suffix for an activation decision."""
    code = ReasonCode(code)
    if code is ReasonCode.ACT_SKIP:
        return "skip"
    if code is ReasonCode.ACT_MASK_ONLY_JNP:
        return "torch"
    return "mask-only"


_DTYPE_ALIASES = {
    "fp8": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn",
    "fp32": "float32",
    "fp16": "float16",
    "bf16": "bfloat16",
}


def dtype_name(dtype) -> str:
    """Canonical short dtype name ("float32", "bfloat16", ...) for a
    torch dtype or a string (short aliases included)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    name = str(dtype).strip().lower().removeprefix("torch.")
    name = _DTYPE_ALIASES.get(name, name)
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return name
