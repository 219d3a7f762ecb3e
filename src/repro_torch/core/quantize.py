"""Low-precision weight quantization for serving layouts (port of
``repro.core.quantize``: the int8 and fp8 numerics, dynamic scales).

- ``int8``: symmetric integers in [-127, 127]; the kernels contract
  int8 x int8 into an exact int32 accumulator.
- ``fp8`` (``torch.float8_e4m3fn``): floats up to +-448.  Its numerics
  are ported here (pure torch); its kernels and its serving path are not
  yet, so the dispatch engine and ``ServingSpec`` refuse it.

Weights are quantized offline with per-output-channel symmetric scales,
``w ~= q.float() * scale`` with ``scale = max(absmax / qmax, tiny)``;
activations are quantized per row just before a quantized kernel runs
(:func:`quantize_rows`).  A quantized layout is an ordinary linear leaf
with one extra ``"scale"`` entry (``(..., O)`` float32); its value
leaf's dtype names the execution class (:func:`quant_dtype`).

Every formulation follows the JAX package operation for operation
(divide by the floored scale, never multiply by a reciprocal; clip
before the cast; int8 rounds half to even), so the int8 codes are
bitwise equal to the reference's.  Static activation scales
(``act_scale`` leaves, ``quantize_rows_static``, calibration) are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .sparse_linear import map_linear_leaves

__all__ = [
    "SCALE_KEY",
    "ACT_SCALE_KEY",
    "QUANT_DTYPES",
    "canonical_qdtype",
    "is_quantized",
    "is_quantized_dtype",
    "quant_dtype",
    "qmax",
    "has_static_scales",
    "quantize_per_channel",
    "dequantize",
    "quantize_rows",
    "quantize_linear",
    "quantize_tree",
]

SCALE_KEY = "scale"
ACT_SCALE_KEY = "act_scale"

# the quantized execution classes and their symmetric dynamic range:
# int8 keeps [-127, 127] (-128 unused); fp8 e4m3fn saturates at +-448
# (the format has no inf, so every quantizer clips BEFORE the cast)
QUANT_DTYPES: Dict[torch.dtype, float] = {
    torch.int8: 127.0,
    torch.float8_e4m3fn: 448.0,
}

_DTYPE_ALIASES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
    "float8_e4m3fn": torch.float8_e4m3fn,
}

_TINY = torch.finfo(torch.float32).tiny


def canonical_qdtype(dtype) -> torch.dtype:
    """Normalize a quantized-dtype spec ("int8" | "fp8" | a dtype) to the
    torch dtype, or raise ValueError for anything outside the table."""
    if isinstance(dtype, str):
        if dtype not in _DTYPE_ALIASES:
            raise ValueError(f"unknown quantize target {dtype!r} "
                             f"(expected one of {sorted(_DTYPE_ALIASES)})")
        dtype = _DTYPE_ALIASES[dtype]
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"{dtype} is not a quantized execution dtype (expected "
                         f"one of {sorted(str(d) for d in QUANT_DTYPES)})")
    return dtype


def is_quantized_dtype(dtype) -> bool:
    """True for the narrow storage dtypes the engine plans as quantized."""
    return dtype in QUANT_DTYPES


def qmax(dtype) -> float:
    """Symmetric dynamic range of one quantized dtype (127 / 448)."""
    return QUANT_DTYPES[canonical_qdtype(dtype)]


def is_quantized(params: Dict[str, Any]) -> bool:
    """Structural test: quantized layouts carry a per-channel scale leaf."""
    return isinstance(params, dict) and SCALE_KEY in params


def quant_dtype(params: Dict[str, Any]) -> Optional[torch.dtype]:
    """The quantized execution dtype of one layout (int8 | float8_e4m3fn),
    or ``None`` for float layouts: the dtype the engine plans on."""
    if not is_quantized(params):
        return None
    dt = params["w" if "w" in params else "values"].dtype
    return dt if dt in QUANT_DTYPES else None


def has_static_scales(params: Dict[str, Any]) -> bool:
    """True when the leaf carries a calibrated static activation scale."""
    return isinstance(params, dict) and ACT_SCALE_KEY in params


def _cast_quantized(x32: torch.Tensor, dtype) -> torch.Tensor:
    """f32 values (already divided by their scale) -> the narrow dtype:
    clip to +-qmax first, then int8 rounds half to even (``torch.round``)
    and fp8 relies on the cast's round-to-nearest-even."""
    dt = canonical_qdtype(dtype)
    q = torch.clamp(x32, -QUANT_DTYPES[dt], QUANT_DTYPES[dt])
    if dt == torch.int8:
        q = torch.round(q)
    return q.to(dt)


def quantize_per_channel(w: torch.Tensor, dtype=torch.int8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization along the contraction axis.

    ``w``: ``(..., K, O)`` float.  Returns ``(q, scale)``: ``q`` of the
    narrow dtype in ``w``'s shape, ``scale`` ``(..., O)`` float32."""
    dt = canonical_qdtype(dtype)
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2)                              # (..., O)
    # floor AFTER the division (tiny / qmax would be a denormal)
    scale = torch.clamp_min(absmax / QUANT_DTYPES[dt], _TINY)
    return _cast_quantized(w32 / scale[..., None, :], dt), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(..., K, O)`` narrow values + ``(..., O)`` scales -> f32 weights."""
    return q.float() * scale[..., None, :]


def quantize_rows(x: torch.Tensor, dtype=torch.int8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric quantization of activations.

    ``x``: ``(B, K)`` float -> ``(x_q (B, K) narrow, x_scale (B, 1) f32)``.
    All-zero rows (idle batch slots) get the floored scale, so the
    division is safe and they quantize to zero."""
    dt = canonical_qdtype(dtype)
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)                # (B, 1)
    scale = torch.clamp_min(absmax / QUANT_DTYPES[dt], _TINY)
    return _cast_quantized(x32 / scale, dt), scale


def quantize_linear(params: Dict[str, Any], dtype=torch.int8) -> Dict[str, Any]:
    """Quantize one dense ``{"w"}`` or compressed ``{"values",
    "meta_packed"}`` leaf: its float operand per output channel, metadata
    unchanged.  Idempotent: a quantized leaf is returned as it is."""
    if is_quantized(params):
        return params
    key = "w" if "w" in params else "values"
    q, scale = quantize_per_channel(params[key], dtype)
    out = dict(params)
    out[key] = q
    out[SCALE_KEY] = scale
    return out


def quantize_tree(tree, dtype=torch.int8):
    """Quantize every linear leaf of a params tree (embeddings, norms and
    other plain tensors are left as they are).  The JAX package's
    ``_quantize_tree``."""
    dt = canonical_qdtype(dtype)
    return map_linear_leaves(tree, lambda leaf: quantize_linear(leaf, dt))
