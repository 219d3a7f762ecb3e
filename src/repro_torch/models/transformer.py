"""The dense, MoE, SSM (Mamba-2) and hybrid (Jamba) decoder stacks, the
audio encoder and the vision-prefix decoder (port of the serving and
prefill parts of ``repro.models.transformer``).

Parameter layout.  The JAX package stacks each layout slot's layers
under ``params["stages"][s]["slot{j}"]`` with leading ``(count, repeat)``
dims and scans over them.  The port runs eagerly and keeps one dict per
layer instead, in execution order (super-block ``i``, then slot ``j``,
then repeat ``r``)::

    {"embed": (V, d), "unembed": (d, V), "final_norm": {"gamma": (d,)},
     "layers": [{"norm1", "mixer": {wq, wk, wv, wo}, "norm2",
                 "ffn": {w_in, w_gate, w_out}}, ...]}

A MoE layer's ``ffn`` is ``{"router": (d, E) fp32, "w_in", "w_gate",
"w_out"}`` with every expert linear stacked along a leading E dim
(``models.moe``).  A Mamba layer's mixer is ``{"mamba": {wz, wx, wB, wC,
wdt, dt_bias, A_log, D, conv_w, w_out}}`` (``models.ssm``); a slot whose
``ffn`` is ``"none"`` (mamba2's) has no ``norm2`` and no ``ffn``.  An
audio encoder (``frontend="audio_frames"``) has a ``frame_proj`` (d, d)
in place of ``embed``.

``repro_torch.interop.params_from_numpy`` maps a JAX tree onto it.
:func:`layer_site_keys` names each layer's (stage, slot), the unit the
JAX package's stacked leaves share (calibration folds over it).

:func:`forward` is the full-sequence forward (logits for every position;
serving prepare runs it to calibrate static activation scales, and
``lm.make_prefill_step`` wraps it);
:func:`cached_stack` walks the same per-layer body with a cache-threading
mixer for the paged serving path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .attention import attention_block, init_attention
from .config import ModelConfig
from .layers import (apply_mlp, embed, init_embedding, init_mlp, init_rms_norm,
                     rms_norm)
from .moe import apply_moe, init_moe
from .ssm import init_mamba, mamba_block

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str            # attn | attn_local | mamba
    ffn: str              # mlp | moe | none
    repeat: int = 1


@dataclasses.dataclass(frozen=True)
class Stage:
    count: int
    slots: Tuple[Slot, ...]


def build_layout(cfg: ModelConfig) -> Tuple[Stage, ...]:
    """Stage/slot layout, the JAX package's: an ssm config (mamba2) is one
    Mamba slot with no FFN; a hybrid config (jamba) repeats a super-block
    of ``period - 1 - period / moe_every`` Mamba + MLP layers, then
    ``period / moe_every`` Mamba + MoE layers, then one attention + MLP
    layer; the dense and MoE families (an MoE config's FFN slot is
    ``"moe"``) and the audio and vlm families, which take the dense layout,
    are one attention slot.  A local/global config (gemma3) repeats
    ``period - 1`` local layers and one global layer per super-block, then
    the remaining local layers in a stage of their own."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.family == "ssm":
        return (Stage(cfg.num_layers, (Slot("mamba", "none"),)),)
    if cfg.family == "hybrid":
        period = cfg.hybrid_period
        if cfg.num_layers % period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a whole number "
                             f"of {period}-layer super-blocks")
        n_moe = period // max(cfg.moe_every, 1)
        return (Stage(cfg.num_layers // period, (Slot("mamba", "mlp", period - 1 - n_moe),
                                                 Slot("mamba", "moe", n_moe),
                                                 Slot("attn", "mlp", 1))),)
    if cfg.local_global_period > 0 and cfg.window > 0:
        p = cfg.local_global_period
        full, rem = divmod(cfg.num_layers, p)
        stages = [Stage(full, (Slot("attn_local", "mlp", p - 1), Slot("attn", "mlp", 1)))]
        if rem:
            stages.append(Stage(1, (Slot("attn_local", "mlp", rem),)))
        return tuple(stages)
    ffn = "moe" if cfg.num_experts > 0 else "mlp"
    return (Stage(cfg.num_layers, (Slot("attn", ffn),)),)


def layer_slots(cfg: ModelConfig) -> List[Slot]:
    """The slot of every layer, in execution order."""
    return [slot for st in build_layout(cfg) for _ in range(st.count)
            for slot in st.slots for _ in range(slot.repeat)]


def layer_site_keys(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """``(stage, slot)`` of every layer, in execution order: the layers
    one stacked leaf of the JAX package holds share a key (gemma3-1b: three
    keys, the super-blocks' local and global slots and the remainder's
    local slot)."""
    return [(s, j) for s, st in enumerate(build_layout(cfg)) for _ in range(st.count)
            for j, slot in enumerate(st.slots) for _ in range(slot.repeat)]


def _init_layer(gen: torch.Generator, slot: Slot, cfg: ModelConfig, device) -> Params:
    p: Params = {"norm1": init_rms_norm(cfg.d_model, device),
                 "mixer": ({"mamba": init_mamba(gen, cfg, device)} if slot.mixer == "mamba"
                           else init_attention(gen, cfg, device))}
    if slot.ffn != "none":
        p["norm2"] = init_rms_norm(cfg.d_model, device)
        p["ffn"] = (init_moe(gen, cfg, device) if slot.ffn == "moe" else
                    init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.sparsity,
                             cfg.torch_dtype, device))
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random weights from ``gen`` (which must live on ``device``), made
    directly in the layout ``cfg.sparsity`` names.  The numbers differ
    from ``jax.random``'s; parity tests carry the JAX package's params
    across with ``interop.params_from_numpy``."""
    dt = cfg.torch_dtype
    params: Params = {}
    if cfg.frontend != "audio_frames":
        params["embed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device)
    else:
        params["frame_proj"] = init_embedding(gen, cfg.d_model, cfg.d_model, dt, device)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                           device).T.contiguous()
    params["final_norm"] = init_rms_norm(cfg.d_model, device)
    params["layers"] = [_init_layer(gen, slot, cfg, device) for slot in layer_slots(cfg)]
    return params


MixerFn = Callable[[Slot, Params, Dict[str, torch.Tensor], torch.Tensor],
                   Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _layer(lp: Params, slot: Slot, x: torch.Tensor, cfg: ModelConfig, mixer):
    """One layer's body (the JAX package's ``_apply_slot``): ``rms_norm ->
    mixer -> residual``, then, unless the slot's ``ffn`` is ``"none"``,
    ``rms_norm -> MLP or MoE -> residual``.  ``mixer(lp, h) -> (out,
    aux)``; returns ``(x, aux)``."""
    h = rms_norm(x, lp["norm1"]["gamma"])
    o, aux = mixer(lp, h)
    x = x + o
    if slot.ffn == "none":
        return x, aux
    h = rms_norm(x, lp["norm2"]["gamma"])
    if slot.ffn == "moe":
        return x + apply_moe(lp["ffn"], h, cfg), aux
    return x + apply_mlp(lp["ffn"], h, cfg.act, cfg.sparsity), aux


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm, then the unembed (a plain matmul, as in the JAX package)."""
    x = rms_norm(x, params["final_norm"]["gamma"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ unembed.to(x.dtype)


def forward(params: Params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, T, V), with the JAX package's
    frontends: ``audio_frames`` projects frame embeddings ``embeds`` (B, T,
    d) through ``frame_proj`` (a plain matmul), ``vision_patches`` puts
    the patch embeddings ``embeds`` (B, P, d) in front of the embedded
    ``tokens`` (B, T - P), and the token frontend embeds ``tokens``.
    Attention runs through the dispatch engine (``flash_attention`` on
    the cuda backend, causal unless ``cfg.causal`` is off), a local
    layer's through the banded ``local_attention`` when its window is
    shorter than the sequence; a Mamba layer runs ``models.ssm.mamba_block``
    (the chunked scan: T a multiple of ``min(128, T)``)."""
    if cfg.frontend == "audio_frames":
        x = embeds @ params["frame_proj"].to(embeds.dtype)
    elif cfg.frontend == "vision_patches":
        tok_x = embed(params["embed"], tokens)
        x = torch.cat([embeds.to(tok_x.dtype), tok_x], dim=1)
    else:
        x = embed(params["embed"], tokens)
    def mixer(slot, lp, h):
        if slot.mixer == "mamba":
            return mamba_block(lp["mixer"]["mamba"], h, cfg), None
        return attention_block(lp["mixer"], h, cfg, is_global=slot.mixer == "attn"), None

    for slot, lp in zip(layer_slots(cfg), params["layers"]):
        x, _ = _layer(lp, slot, x, cfg, lambda lp_, h, slot=slot: mixer(slot, lp_, h))
    return _logits(params, x, cfg)


def cached_stack(params: Params, caches: List[Dict[str, torch.Tensor]],
                 x: torch.Tensor, cfg: ModelConfig, mixer_fn: MixerFn
                 ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Cache-threading stack walker: the per-layer body of :func:`forward`
    with ``mixer_fn`` as the attention, then the final norm and the
    unembed."""
    new_caches = []
    for slot, lp, lc in zip(layer_slots(cfg), params["layers"], caches):
        x, c = _layer(lp, slot, x, cfg,
                      lambda lp_, h, slot=slot, lc=lc: mixer_fn(slot, lp_, lc, h))
        new_caches.append(c)
    return _logits(params, x, cfg), new_caches
