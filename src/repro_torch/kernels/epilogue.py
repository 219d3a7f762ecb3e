"""Epilogue lattice: what one kernel launch may fuse after its GEMM flush.

The port's copy of ``repro.kernels.epilogue``:

    (+ bias) -> (silu | gelu | silu*mul) -> (requant:<dtype>)

applied to the fp32 accumulator before the single cast and store.
``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults to
(``torch.nn.functional.gelu`` defaults to erf, so it is called with
``approximate="tanh"``).  ``requant:<dtype>`` quantizes the result
against the CONSUMER's calibrated static activation scale
(:func:`requant_rows`), so the next quantized linear contracts the
narrow rows directly.  Every quantized kernel fuses it
(``requant:int8`` and ``requant:float8_e4m3fn``): the gate-up duals after
silu*mul, the single GEMMs (``*_requant``, and the masked ones) after
bias and silu | gelu, as the gelu MLP's ``w_in`` needs; the float
kernels take no requant point.

:func:`flush_tile` is the formulation the CUDA flush implements and the
kernels' plain versions call; :func:`apply_reference` is the unfused
torch-tier path, which skips the requantize by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["EpilogueSpec", "Epilogue", "make", "flush_tile", "apply_reference",
           "requant_rows", "ACTIVATIONS"]

ACTIVATIONS = ("silu", "gelu", "silu_mul")


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """One static point of the epilogue lattice (hashable)."""

    act: Optional[str] = None
    bias: bool = False
    requant: Optional[str] = None

    def __post_init__(self):
        if self.act is not None and self.act not in ACTIVATIONS:
            raise ValueError(f"unknown epilogue activation {self.act!r} "
                             f"(expected one of {ACTIVATIONS})")

    @property
    def point(self) -> str:
        parts = []
        if self.bias:
            parts.append("bias")
        if self.act:
            parts.append(self.act)
        if self.requant:
            parts.append(f"requant:{self.requant}")
        return "+".join(parts) or "none"

    @property
    def is_identity(self) -> bool:
        return not (self.bias or self.act or self.requant)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """An :class:`EpilogueSpec` plus its runtime operands."""

    spec: EpilogueSpec
    bias: Optional[torch.Tensor] = None
    requant_scale: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.spec.bias != (self.bias is not None):
            raise ValueError("Epilogue bias operand must match spec.bias")
        if (self.spec.requant is not None) != (self.requant_scale is not None):
            raise ValueError("Epilogue requant_scale operand must match spec.requant")


def make(act: Optional[str] = None, bias: Optional[torch.Tensor] = None,
         requant: Optional[str] = None, requant_scale=None) -> Epilogue:
    """Convenience constructor: operands in, spec derived."""
    return Epilogue(EpilogueSpec(act=act, bias=bias is not None, requant=requant),
                    bias=bias, requant_scale=requant_scale)


def _act(y: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name is None:
        return y
    if name == "silu":
        return F.silu(y)
    if name == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"activation {name!r} needs the dual-tile flush")


def requant_rows(y32: torch.Tensor, scale: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """Static-scale requantization of an fp32 tile: ``clip(y32 / scale,
    +-qmax)``, then int8 rounds half to even, then the cast (for
    float8_e4m3fn: no rounding step, the cast itself rounds to nearest
    even after the clip to +-448, so nothing saturates to NaN).  The same
    clip-before-cast contract as ``quantize.quantize_rows_static``, so
    the fused and the unfused requantize give the same codes on the same
    fp32 input.  ``scale`` is a scalar tensor (it stays on the device)."""
    from ..core.quantize import QUANT_DTYPES, canonical_qdtype

    dt = canonical_qdtype(dtype_name)
    lim = QUANT_DTYPES[dt]
    q = torch.clamp(y32 / scale.float().reshape(()), -lim, lim)
    if dt == torch.int8:
        q = torch.round(q)
    return q.to(dt)


def flush_tile(acc32: torch.Tensor, spec: EpilogueSpec, out_dtype: torch.dtype,
               bias: Optional[torch.Tensor] = None,
               acc2_32: Optional[torch.Tensor] = None,
               rq_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one lattice point to an fp32 accumulator, then store once.

    Order: + bias -> silu | gelu, or ``silu(acc) * acc2`` for the dual
    (gate-up) point -> requantize against ``rq_scale`` when the spec
    asks for it (the result is then of the narrow dtype), else the cast
    to ``out_dtype``.  ``bias`` is an ``(O,)`` vector."""
    y = acc32
    if spec.bias:
        y = y + bias.float()
    if spec.act == "silu_mul":
        y = F.silu(y) * acc2_32
    else:
        y = _act(y, spec.act)
    if spec.requant is not None:
        return requant_rows(y, rq_scale, spec.requant)
    return y.to(out_dtype)


def apply_reference(y: torch.Tensor, epi: Optional[Epilogue],
                    requantize: bool = False) -> torch.Tensor:
    """The unfused torch formulation of one epilogue: ops in fp32, cast
    back to ``y``'s dtype.  The requantize step is skipped unless
    ``requantize``: the unfused contract emits the float activation and
    lets the consumer's own static-scale quantize produce the same
    narrow operands."""
    if epi is None or epi.spec.is_identity:
        return y
    spec = epi.spec
    if spec.act == "silu_mul":
        raise ValueError("silu_mul is a dual-GEMM epilogue; apply it via "
                         "the gate-up dispatcher, not apply_reference")
    y32 = y.float()
    if spec.bias:
        y32 = y32 + epi.bias.float()
    y32 = _act(y32, spec.act)
    if spec.requant is not None and requantize:
        return requant_rows(y32, epi.requant_scale, spec.requant)
    return y32.to(y.dtype)
