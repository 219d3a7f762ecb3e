"""Low-precision weight quantization for serving layouts (port of
``repro.core.quantize``: the int8 and fp8 numerics, dynamic scales).

- ``int8``: symmetric integers in [-127, 127]; the kernels contract
  int8 x int8 into an exact int32 accumulator.
- ``fp8`` (``torch.float8_e4m3fn``): floats up to +-448; the kernels
  contract e4m3 x e4m3 into an fp32 accumulator.

Weights are quantized offline with per-output-channel symmetric scales,
``w ~= q.float() * scale`` with ``scale = max(absmax / qmax, tiny)``;
activations are quantized per row just before a quantized kernel runs
(:func:`quantize_rows`).  A quantized layout is an ordinary linear leaf
with one extra ``"scale"`` entry (``(..., O)`` float32); its value
leaf's dtype names the execution class (:func:`quant_dtype`).

Every formulation follows the JAX package operation for operation
(divide by the floored scale, never multiply by a reciprocal; clip
before the cast; int8 rounds half to even), so the int8 codes are
bitwise equal to the reference's.

Static activation scales: :func:`_calibrate_activation_scales` runs one
representative forward while the dispatch engine reports each tagged
site's activation absmax (:func:`record_calibration`), then attaches a
scalar ``act_scale = absmax / qmax`` to every observed leaf; decode
quantizes against it (:func:`quantize_rows_static`) instead of running
the per-row absmax pass.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from .sparse_linear import is_linear_leaf, map_linear_leaves

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
    "quantize_rows_static",
    "quantize_linear",
    "quantize_tree",
    "calibration_active",
    "record_calibration",
]

SCALE_KEY = "scale"
ACT_SCALE_KEY = "act_scale"
# the per-site tag a leaf carries only while it is being calibrated
_CALIB_KEY = "calib_id"

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


def quantize_rows(x: torch.Tensor, dtype=torch.int8, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric quantization of activations.

    ``x``: ``(B, K)`` float -> ``(x_q (B, K) narrow, x_scale (B, 1) f32)``.
    All-zero rows (idle batch slots) get the floored scale, so the
    division is safe and they quantize to zero.  ``absmax`` (B, 1)
    overrides the per-row reduction: a row-parallel shard passes the
    global row absmax (the all-reduced MAX of the shards' local ones), so
    every shard quantizes against one scale."""
    dt = canonical_qdtype(dtype)
    x32 = x.float()
    if absmax is None:
        absmax = x32.abs().amax(dim=-1, keepdim=True)            # (B, 1)
    scale = torch.clamp_min(absmax / QUANT_DTYPES[dt], _TINY)
    return _cast_quantized(x32 / scale, dt), scale


def quantize_rows_static(x: torch.Tensor, act_scale: torch.Tensor, dtype=torch.int8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-scale quantization of activations (the decode fast path).

    ``act_scale`` is the scalar calibrated scale of the consuming leaf; no
    per-row reduction runs.  Values beyond the calibrated range saturate
    at +-qmax.  Returns ``(x_q, x_scale)`` with ``x_scale`` the scalar
    broadcast to the ``(B, 1)`` layout the kernels take.  The scale stays
    on the device: nothing here synchronises with the host."""
    dt = canonical_qdtype(dtype)
    x32 = x.float()
    scale = torch.clamp_min(act_scale.float().reshape(()), _TINY)
    xs = scale.reshape(1, 1).expand(x.shape[0], 1).contiguous()
    return _cast_quantized(x32 / scale, dt), xs


def quantize_linear(params: Dict[str, Any], dtype=torch.int8) -> Dict[str, Any]:
    """Quantize one dense ``{"w"}``, compressed ``{"values",
    "meta_packed"}`` or gather ``{"values", "gather_idx"}`` leaf: its float
    operand per output channel, metadata and indices unchanged.
    Idempotent: a quantized leaf is returned as it is."""
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


# ---------------------------------------------------------------------------
# static activation-scale calibration
# ---------------------------------------------------------------------------
#
# Each quantized leaf is tagged with a site number (``calib_id``) for one
# calibration forward; ``dispatch.sparse_matmul`` / ``gate_up_matmul``
# report the absmax of the activations each tagged site contracts.  The
# port runs eagerly, so the store is updated in place on the device (a
# running ``torch.maximum`` per site) and read back with ONE host sync at
# the end.
#
# A site is the JAX package's unit: one stacked leaf of one layout slot.
# There, ``wq`` of every layer of a slot is a single leaf, so every layer
# gets the same scale, the max over all of them.  The port keeps one dict
# per layer, so the tag is the leaf's path with the layer index replaced
# by the layer's slot (``layer_keys``), and the layers of a slot fold into
# one site.

_ACTIVE_STORE: list = [None]


def calibration_active() -> bool:
    return _ACTIVE_STORE[0] is not None


@contextlib.contextmanager
def _calibrating(store: Dict[int, torch.Tensor]):
    # one process-global slot: a second concurrent calibration would fold
    # its absmaxes into this store, so it fails loudly instead
    if _ACTIVE_STORE[0] is not None:
        raise RuntimeError("a calibration is already active in this process: "
                           "calibration passes cannot run concurrently")
    _ACTIVE_STORE[0] = store
    try:
        yield store
    finally:
        _ACTIVE_STORE[0] = None


def record_calibration(calib_id: int, x: torch.Tensor) -> None:
    """Fold ``absmax(x)`` into the running max of one tagged site (the
    engine hook).  No-op without an active calibration."""
    store = _ACTIVE_STORE[0]
    if store is None:
        return
    absmax = x.float().abs().amax()
    prev = store.get(calib_id)
    store[calib_id] = absmax if prev is None else torch.maximum(prev, absmax)


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        if is_linear_leaf(tree):
            return fn(path, tree)
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(v, fn, path + (i,)) for i, v in enumerate(tree))
    return tree


def _site_key(path: tuple, layer_keys: Optional[Sequence[Hashable]]) -> tuple:
    """A leaf's calibration site: its path, with the index into
    ``params["layers"]`` replaced by that layer's slot key."""
    if layer_keys is not None and len(path) > 1 and path[0] == "layers":
        return ("layers", ("slot", layer_keys[path[1]])) + path[2:]
    return path


def _calibrate_activation_scales(
    params,
    batch_fn: Callable[[Any], Any],
    layer_keys: Optional[Sequence[Hashable]] = None,
) -> Tuple[Any, int]:
    """Attach static activation scales to every quantized linear leaf.

    ``params`` is a serving tree whose linears are already quantized;
    ``batch_fn`` runs one representative forward over the calibration
    batch given a params tree (e.g. ``lambda p: forward(p, cfg,
    tokens=batch)``) while the engine records, per site, the max
    |activation| it contracts.  ``layer_keys[i]`` names the slot of
    ``params["layers"][i]`` (``models.transformer.layer_site_keys``), so
    that the layers of one slot share a site as the JAX package's
    stacked leaves do.

    Returns ``(params_with_scales, n_calibrated)``: every leaf of an
    observed site gains a scalar float32 ``act_scale = absmax / qmax``
    (``qmax`` of the leaf's own storage dtype), computed as the JAX
    package does, in Python floats from the float32 absmax and rounded
    once to float32; leaves of sites the batch never exercised keep the
    dynamic per-row path."""
    sites: Dict[tuple, int] = {}

    def _tag(path, leaf):
        if not is_quantized(leaf):
            return leaf
        key = _site_key(path, layer_keys)
        return {**leaf, _CALIB_KEY: sites.setdefault(key, len(sites))}

    tagged = _map_with_path(params, _tag)
    store: Dict[int, torch.Tensor] = {}
    with _calibrating(store), torch.inference_mode():
        batch_fn(tagged)
    ids = sorted(store)
    # the one host sync of the calibration
    absmax = (torch.stack([store[i].float().reshape(()) for i in ids]).cpu().tolist()
              if ids else [])
    observed = dict(zip(ids, absmax))

    def _attach(path, leaf):
        if not is_quantized(leaf):
            return leaf
        site = sites[_site_key(path, layer_keys)]
        if site not in observed:
            return leaf          # never exercised: stays dynamic
        dt = quant_dtype(leaf) or torch.int8
        scale = max(observed[site], 0.0) / QUANT_DTYPES[dt]
        dev = leaf["w" if "w" in leaf else "values"].device
        return {**leaf, ACT_SCALE_KEY: torch.tensor(scale, dtype=torch.float32,
                                                    device=dev)}

    return _map_with_path(params, _attach), len(observed)
