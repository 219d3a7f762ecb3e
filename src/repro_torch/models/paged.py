"""Paged-KV decode: block-table attention + chunked prefill for serving
(port of ``repro.models.paged``, float KV only).

KV lives in fixed-size blocks, one pool pair per attention layer shaped
``(num_blocks, block_len, Hkv, D)``; each request maps its logical
positions onto physical blocks through its row of the block table.
Writes are masked: idle slots and padding tokens write into the reserved
scratch block 0, which no table row references for a live position.
A Mamba layer (the ssm and hybrid families) keeps its per-request
recurrent state instead, slot-addressed: ``{"conv": (slots, W - 1, C),
"state": (slots, nh, ds, hd) fp32}``, as in the JAX package.

The pools and the SSM state are updated in place (``index_put_``; a
masked ``torch.where(..., out=)``, a row's ``copy_``) to avoid copying
them on every step; the functions still
return the caches, so callers read like the JAX package's functional
versions.  The attention itself
stays plain torch ops (the JAX package has no Pallas kernel here
either): q is scaled in its own dtype, both einsums accumulate in fp32,
masked scores are ``NEG_INF`` (keys after the query, and on a local layer
keys a window or more behind it), and the probabilities stay fp32 unless
``cfg.attn_p_bf16``.

A Mamba layer's prefill chunk is the JAX package's ``_prefill_mamba``, a
per-token scan of the decode step whose state and conv history advance
only for ``t < n_valid`` -- the same function, computed another way: the
row-wise work runs once over the chunk (``wz``, ``wx``, ``wB``, ``wC``,
``wdt`` and ``w_out`` over all C rows in one call each, the causal conv
over ``[cached history; chunk]``), and the state recurrence over the valid
rows is the chunked SSD scan (``models.ssm._ssd_scan``, one chunk of
``n_valid`` rows) from the cached state.  The engine discards a padding
row's (``t >= n_valid``) logits; its output here skips the scan term.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.sparse_linear import apply_linear
from .attention import NEG_INF, _grouped, _project_qkv
from .config import ModelConfig
from .layers import embed
from .ssm import (_causal_conv, _dt, _in_proj, _out, _split, _ssd_scan,
                  decode_mamba_block, init_ssm_cache)
from .transformer import cached_stack, layer_slots

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

__all__ = [
    "check_paged",
    "init_paged_caches",
    "paged_decode_step",
    "paged_prefill_chunk",
    "reset_slot_state",
]


def check_paged(cfg: ModelConfig) -> None:
    """The paged path embeds token ids and attends causally: it refuses a
    config that takes embeddings through a frontend (``audio_frames``,
    ``vision_patches``) or attends both ways.  Those run their prefill
    forward through ``models.make_prefill_step``."""
    if cfg.frontend != "none" or not cfg.causal:
        raise ValueError(
            f"{cfg.name}: the paged serving path takes token ids and attends causally; "
            f"frontend {cfg.frontend!r} / causal={cfg.causal} runs through "
            f"models.make_prefill_step")


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_len: int,
                      batch: int = 1, device=None) -> List[Cache]:
    """One cache per layer: an attention layer's ``{"k", "v"}`` pool pair
    (``num_blocks`` includes the scratch block 0; under an axis env the
    pools hold this rank's KV heads, KV / M), a Mamba layer's recurrent
    state for ``batch`` slots (``models.ssm.init_ssm_cache``)."""
    from .pjit_utils import axis_env
    check_paged(cfg)
    env = axis_env()
    heads = cfg.num_kv_heads // (env.model_size if env is not None else 1)
    shape = (num_blocks, block_len, heads, cfg.head_dim)
    return [init_ssm_cache(cfg, batch, device) if slot.mixer == "mamba" else
            {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
            for slot in layer_slots(cfg)]


def _write_kv(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
              phys: torch.Tensor, off: torch.Tensor) -> Cache:
    """Scatter N new (head, dim) vectors into the pools at (phys, off), in
    place."""
    cache["k"].index_put_((phys, off), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((phys, off), v_new.to(cache["v"].dtype))
    return cache


def _gather_kv(cache: Cache, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-table gather -> (B, W*block_len, Hkv, D) contiguous views."""
    k = cache["k"][table]                       # (B, W, BL, H, D)
    b, w, bl, h, d = k.shape
    return k.reshape(b, w * bl, h, d), cache["v"][table].reshape(b, w * bl, h, d)


def _scale(cfg: ModelConfig, dtype: torch.dtype) -> float:
    """``head_dim ** -0.5`` rounded to ``dtype`` first, as the JAX package
    scales q by ``jnp.asarray(scale, q.dtype)``; a Python float keeps the
    multiply free of a host-to-device copy."""
    return torch.tensor(cfg.head_dim ** -0.5, dtype=dtype).item()


def _paged_attention(p: Params, x: torch.Tensor, cache: Cache,
                     positions: torch.Tensor, table: torch.Tensor,
                     write_mask: torch.Tensor, cfg: ModelConfig, *, is_global: bool,
                     block_len: int) -> Tuple[torch.Tensor, Cache]:
    """x: (B, T, d); positions, write_mask: (B, T); table: (B, W).  A local
    layer (``is_global`` False, ``cfg.window`` > 0) also masks the keys
    ``window`` or more positions behind the query (its pool stays
    full-length, as in the JAX package)."""
    b, t, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    # positions past the table only occur on masked (padding) writes
    blk = (positions // block_len).clamp(max=table.shape[1] - 1)
    phys = torch.where(write_mask, torch.gather(table, 1, blk), 0).reshape(b * t)
    off = torch.where(write_mask, positions % block_len, 0).reshape(b * t)
    cache = _write_kv(cache, k_new.reshape(b * t, -1, cfg.head_dim),
                      v_new.reshape(b * t, -1, cfg.head_dim), phys, off)

    k, v = _gather_kv(cache, table)
    qg = _grouped(q, cfg)                                     # (B,Hkv,G,T,D)
    s = torch.einsum("bhgqd,bkhd->bhgqk", (qg * _scale(cfg, qg.dtype)).float(),
                     k.float())
    j = torch.arange(k.shape[1], device=x.device)
    valid = j[None, None, :] <= positions[:, :, None]         # (B, T, L)
    if not is_global and cfg.window > 0:
        valid = valid & (positions[:, :, None] - j[None, None, :] < cfg.window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    if cfg.attn_p_bf16:
        pr = pr.to(v.dtype).float()
    o = torch.einsum("bhgqk,bkhd->bhgqd", pr, v.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(b, t, -1).to(x.dtype)
    return apply_linear(p["wo"], o, cfg.sparsity, gather="row"), cache


def _masked_decode_mamba(p: Params, x: torch.Tensor, cache: Cache,
                         update_mask: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, Cache]:
    """One SSM decode step whose state update is kept only on the rows of
    ``update_mask`` (B,): idle and prefilling slots in a batched decode must
    not advance their recurrent state."""
    o, new = decode_mamba_block(p, x, cache, cfg)
    for key, value in new.items():
        m = update_mask.reshape((-1,) + (1,) * (value.ndim - 1))
        torch.where(m, value, cache[key], out=cache[key])
    return o, cache


def _prefill_mamba(p: Params, x: torch.Tensor, cache: Cache, n_valid: int,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """One request's chunk x (1, C, d) through a Mamba layer from its cache
    row ``{"conv": (1, W - 1, Ch), "state": (1, nh, ds, hd)}``: the JAX
    package's per-token scan of the decode step, whose state and history
    advance for ``t < n_valid`` only, with the row-wise work run once over
    the chunk and the recurrence as one scan chunk (module docstring).
    Returns (out (1, C, d), the new row)."""
    c = x.shape[1]
    nh, hd, w = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    z, xbc, dt_raw = _in_proj(p, x, cfg)
    xin, Bm, Cm = _split(_causal_conv(xbc, p["conv_w"], history=cache["conv"]), cfg)
    # the conv history after the valid rows: their last W - 1 inputs
    hist = torch.cat([cache["conv"], xbc], dim=1)[:, n_valid:n_valid + w - 1]
    xh = xin.reshape(1, c, nh, hd)
    y = torch.zeros(xh.shape, dtype=torch.float32, device=x.device)
    state = cache["state"]
    if n_valid:
        v = slice(0, n_valid)
        y[:, v], state = _ssd_scan(xh[:, v], _dt(p, dt_raw[:, v]), -torch.exp(p["A_log"]),
                                   Bm[:, v], Cm[:, v], chunk=n_valid, h0=state)
    return _out(p, y, xh.float(), z, cfg), {"conv": hist, "state": state}


def _prefill_mamba_slot(p: Params, x: torch.Tensor, cache: Cache, n_valid: int,
                        slot_idx: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """The prefill chunk of the request in slot ``slot_idx``: the chunk runs
    on that row of the slots-wide cache, and the new row is written back in
    place; every other slot's state is left as it is."""
    row = {key: value[slot_idx:slot_idx + 1] for key, value in cache.items()}
    o, new = _prefill_mamba(p, x, row, n_valid, cfg)
    for key, value in new.items():
        cache[key][slot_idx:slot_idx + 1].copy_(value)
    return o, cache


def paged_decode_step(params: Params, caches: List[Cache], tokens: torch.Tensor,
                      positions: torch.Tensor, table: torch.Tensor,
                      active: torch.Tensor, cfg: ModelConfig, block_len: int
                      ) -> Tuple[torch.Tensor, List[Cache]]:
    """Batched single-token decode against block tables.

    tokens (B, 1); positions (B,) per-slot index of the new token; table
    (B, W); active (B,) bool.  Inactive slots write to the scratch block
    and leave their SSM state as it is; their logits are garbage the
    scheduler discards."""
    x = embed(params["embed"], tokens)
    pos2 = positions.long()[:, None]
    wmask = active[:, None]

    def mixer(slot, lp, lc, h):
        if slot.mixer == "mamba":
            return _masked_decode_mamba(lp["mixer"]["mamba"], h, lc, active, cfg)
        return _paged_attention(lp["mixer"], h, lc, pos2, table.long(), wmask,
                                cfg, is_global=slot.mixer == "attn", block_len=block_len)

    return cached_stack(params, caches, x, cfg, mixer)


def paged_prefill_chunk(params: Params, caches: List[Cache], tokens: torch.Tensor,
                        pos0: int, table: torch.Tensor, n_valid: int,
                        cfg: ModelConfig, block_len: int, slot_idx: Optional[int] = None
                        ) -> Tuple[torch.Tensor, List[Cache]]:
    """One prefill chunk for one request: tokens (1, C) enter the pools in
    one forward (in-chunk causality through the position mask); returns
    logits for every chunk position.  ``table`` already selects the
    request's blocks; ``slot_idx``, the engine slot being prefilled,
    addresses the slot-wide SSM state, and a model with Mamba layers
    refuses to run without it."""
    c = tokens.shape[1]
    x = embed(params["embed"], tokens)
    ar = torch.arange(c, device=tokens.device)
    positions = (pos0 + ar)[None, :]
    wmask = (ar < n_valid)[None, :]

    def mixer(slot, lp, lc, h):
        if slot.mixer == "mamba":
            if slot_idx is None:
                raise ValueError(f"{cfg.name}: a Mamba layer's prefill needs slot_idx (the "
                                 f"row of the slots-wide SSM state it advances)")
            return _prefill_mamba_slot(lp["mixer"]["mamba"], h, lc, n_valid, slot_idx, cfg)
        return _paged_attention(lp["mixer"], h, lc, positions, table.long(), wmask,
                                cfg, is_global=slot.mixer == "attn", block_len=block_len)

    return cached_stack(params, caches, x, cfg, mixer)


def reset_slot_state(caches: List[Cache], slot_index: int) -> List[Cache]:
    """Zero one slot's row of every Mamba layer's ``conv`` and ``state``, in
    place: the SSM state is slot-addressed, so a request admitted into a
    recycled slot must start from zeros.  Attention pools are
    block-addressed and need no reset (freed blocks are rewritten before
    they are read again)."""
    for cache in caches:
        for key in ("conv", "state"):
            if key in cache:
                cache[key][slot_index].zero_()
    return caches
