"""Where the cuda and torch tiers of the SSM runs part, on one card.

    python3 tools/ssm_tier_probe.py [m0] [m1] [jamba]     # all three by default

The models and weights are ``chip_smoke.py``'s serving runs (seed 0):
``m0`` mamba2-2.7b bf16 compressed 2:4 at all 64 layers, ``m1`` static
int8 gather 2:4, ``jamba`` jamba's hybrid layout at ``chip_smoke.JAMBA_CUTS``.
For each it prints, as ``<run> <what> <json>`` lines:

- ``layer_study``: teacher-forced (every layer of the cuda tier takes the
  torch tier's input, the decode step the torch tier's caches), per layer
  the scaled gap of the mixer's output (``mix_*``) and of the layer's
  output less its input (``res_*``: the residual add's bf16 rounding
  included), over a 64-token prefill chunk (scaled by the chunk's max,
  ``*_global``, or each row's own, ``*_row_max``) and the decode row, and
  the stream's max over the mixer's (``*_x_over_mix``); ``layer_rows``
  gives every layer.  ``m1 fq`` holds the static run against a torch
  tier that quantizes its activations against the static scales,
  ``m1 plain`` against the plain one.
- ``projections`` (m0): at the decode row of the worst layers, wz, wx and
  w_out on the torch tier's inputs through the cuda kernel and the plain
  version, each against an fp64 product of the same bf16 operands.
- ``e2e``: cuda vs torch tier logits (prefill chunk, decode step) on the
  model cut to its first 8 / 16 / 32 / 64 layers, beside the torch tier's
  own gap under one bf16 ulp on 1% of the embedding table's entries
  (``ulp_*``); for m1 also against the fake-quantized torch tier.
- ``consistency`` (m0): ``models.forward`` vs four 64-token paged prefill
  chunks on one 256-token prompt, last position's logits, on the cut
  models, on each tier.

Without a card it runs the smoke configs on the CPU, the torch tier
standing in for both tiers: a check that the probe runs, nothing more.
"""

import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import (forward, init_paged_caches, init_params,  # noqa: E402
                                paged_decode_step, paged_prefill_chunk, ssm, transformer)
from repro_torch.models.layers import rms_norm  # noqa: E402

CUDA = torch.cuda.is_available()
DEV = "cuda" if CUDA else "cpu"
A = "cuda" if CUDA else "torch"          # the tier under test


def log(k, v):
    print(k, json.dumps(v, default=float), flush=True)


def prepared_of(base, layout, sparsity, qdtype, static, cuts=None, moe_path=None, depth=None):
    spec = serving.ServingSpec(layout=layout, sparsity=sparsity, qdtype=qdtype,
                               static_scales=static, slots=8, max_len=512, block_len=8,
                               prefill_chunk=64 if CUDA else 8,
                               **({} if CUDA else {"backend": "torch"}))
    cfg = spec.apply_to(dataclasses.replace(
        base, **{"num_layers": depth or base.num_layers, **(cuts or {})},
        **({"moe_expert_path": moe_path} if moe_path else {})))
    gen = torch.Generator(device=DEV).manual_seed(0)
    calib = None
    if static:
        calib = torch.randint(1, cfg.vocab_size, (spec.slots, min(spec.max_len, cs.CALIB_TOKENS)),
                              generator=torch.Generator(device=DEV).manual_seed(2), device=DEV)
    with torch.inference_mode():
        params = init_params(gen, cfg, device=DEV)
        prepared = serving.prepare(params, spec, cfg=cfg, calib_tokens=calib, device=DEV)
    return prepared, cfg, spec


def cut(prepared, cfg, d):
    return (dataclasses.replace(prepared, params={**prepared.params,
                                                  "layers": prepared.params["layers"][:d]}),
            dataclasses.replace(cfg, num_layers=d))


def traced(run, force=None):
    real, seen = transformer._layer, []

    def layer(lp, slot, x, cfg, mixer):
        if force is not None:
            x = force(len(seen)).to(x.dtype)
        got = {}

        def m(lp_, h):
            o, aux = mixer(lp_, h)
            got["o"] = o.float()
            return o, aux
        out = real(lp, slot, x, cfg, m)
        seen.append((x, got["o"], out[0].float() - x.float()))
        return out

    transformer._layer = layer
    try:
        result = run()
    finally:
        transformer._layer = real
    return result, seen


def copied(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def run_tier(prepared, cfg, spec, backend, tokens, want=None, start=None, fq=False):
    c = spec.prefill_chunk
    table = torch.arange(1, spec.table_width + 1, device=DEV)[None, :]
    ctx = cs.fake_quantized_activations() if fq else contextlib.nullcontext()
    with torch.inference_mode(), dispatch.use_dispatch(backend=backend), ctx:
        caches = init_paged_caches(cfg, spec.table_width + 1, spec.block_len, 1, device=DEV)
        (lp, _), pre = traced(lambda: paged_prefill_chunk(
            prepared.params, caches, tokens[:, :c], 0, table, c, cfg, spec.block_len, slot_idx=0),
            force=want and (lambda i: want[0][i][0]))
        left = copied(caches)
        (ld, _), dec = traced(lambda: paged_decode_step(
            prepared.params, caches if start is None else copied(start), tokens[:, c:],
            torch.tensor([c], device=DEV), table, torch.tensor([True], device=DEV), cfg,
            spec.block_len), force=want and (lambda i: want[1][i][0]))
    return pre, dec, left, lp[0].float(), ld[0].float()


def rowerrs(g, w):
    """Per-row scaled errors of (..., d) tensors, each row over its own max."""
    g, w = g.float().reshape(-1, g.shape[-1]), w.float().reshape(-1, w.shape[-1])
    return ((g - w).abs().amax(-1) / (w.abs().amax(-1) + 1e-6))


def layer_study(prepared, cfg, spec, tag, fq=False):
    c = spec.prefill_chunk
    tokens = torch.randint(1, cfg.vocab_size, (1, c + 1), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(2))
    want = run_tier(prepared, cfg, spec, "torch", tokens, fq=fq)
    got = run_tier(prepared, cfg, spec, A, tokens, want=(want[0], want[1]), start=want[2])
    rows = []
    for i, (gp, gd, wp, wd) in enumerate(zip(got[0], got[1], want[0], want[1])):
        r = {"layer": i,
             "mix_pre_global": cs.scaled_err(gp[1], wp[1]),
             "mix_pre_row_max": rowerrs(gp[1], wp[1]).max().item(),
             "mix_dec_row": rowerrs(gd[1], wd[1]).max().item(),
             "res_pre_global": cs.scaled_err(gp[2], wp[2]),
             "res_pre_row_max": rowerrs(gp[2], wp[2]).max().item(),
             "res_dec_row": rowerrs(gd[2], wd[2]).max().item(),
             "dec_x_over_mix": (wd[0].float().abs().max() / wd[1].abs().max()).item(),
             "pre_x_over_mix": (wp[0].float().abs().max() / wp[1].abs().max()).item()}
        rows.append(r)
    keys = [k for k in rows[0] if k != "layer"]
    summ = {k: {"max": max(r[k] for r in rows), "at": max(rows, key=lambda r: r[k])["layer"],
                "median": sorted(r[k] for r in rows)[len(rows) // 2]} for k in keys}
    log(f"{tag} layer_study", summ)
    log(f"{tag} layer_rows", [{k: round(v, 5) if isinstance(v, float) else v for k, v in r.items()}
                              for r in rows])
    return rows, want, got


def projection_study(prepared, cfg, spec, tag, want, layer):
    """At ``layer``'s decode row: wz, wx, w_out on the torch tier's inputs,
    tier A and torch tier against fp64."""
    from repro_torch.kernels.nm_spmm.ref import dense_weight
    lp = prepared.params["layers"][layer]
    x = want[1][layer][0]
    cache = copied(want[2])[layer]
    calls = []
    real = ssm.apply_linear

    def rec(p, xx, sp, gather=None, **k):
        calls.append((p, xx.clone(), sp, gather))
        return real(p, xx, sp, gather=gather, **k)

    ssm.apply_linear = rec
    try:
        with torch.inference_mode(), dispatch.use_dispatch(backend="torch"):
            h = rms_norm(x, lp["norm1"]["gamma"])
            ssm.decode_mamba_block(lp["mixer"]["mamba"], h, cache, cfg)
    finally:
        ssm.apply_linear = real
    res = []
    for name, (p, xx, sp, gather) in zip(("wz", "wx", "w_out"), calls):
        with torch.inference_mode():
            with dispatch.use_dispatch(backend=A):
                ya = real(p, xx, sp, gather=gather).float()
            with dispatch.use_dispatch(backend="torch"):
                yt = real(p, xx, sp, gather=gather).float()
            if "meta_packed" in p:
                w = dense_weight(p["values"], p["meta_packed"], sp.n).double()
                y64 = xx.reshape(-1, xx.shape[-1]).double() @ w
            else:
                y64 = None
        r = {"site": name, "rows": xx.reshape(-1, xx.shape[-1]).shape[0],
             "A_vs_torch": rowerrs(ya, yt).max().item(),
             "differing_share": (ya != yt).float().mean().item()}
        if y64 is not None:
            y64 = y64.reshape(ya.shape)
            r["A_vs_fp64"] = rowerrs(ya, y64).max().item()
            r["torch_vs_fp64"] = rowerrs(yt, y64).max().item()
        res.append(r)
    log(f"{tag} projections at layer {layer}'s decode row", res)


def e2e_vs_depth(prepared, cfg, spec, tag, depths, fq_too=False):
    c = spec.prefill_chunk
    tokens = torch.randint(1, cfg.vocab_size, (1, c + 1), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(2))
    out = []
    for d in depths:
        pd, cd = cut(prepared, cfg, d)
        ra = run_tier(pd, cd, spec, A, tokens)
        rt = run_tier(pd, cd, spec, "torch", tokens)
        emb = pd.params["embed"]
        nudged = torch.rand(emb.shape, generator=torch.Generator(device=DEV).manual_seed(7),
                            device=DEV) < 0.01
        bumped = torch.where(nudged, (emb.float() * (1 + 2.0 ** -7)).to(emb.dtype), emb)
        pb = dataclasses.replace(pd, params={**pd.params, "embed": bumped})
        rb = run_tier(pb, cd, spec, "torch", tokens)
        r = {"depth": d, "prefill": cs.scaled_err(ra[3], rt[3]), "decode": cs.scaled_err(ra[4], rt[4]),
             "ulp_prefill": cs.scaled_err(rb[3], rt[3]), "ulp_decode": cs.scaled_err(rb[4], rt[4]),
             "argmax_agree": (torch.cat([ra[3], ra[4]]).argmax(-1)
                              == torch.cat([rt[3], rt[4]]).argmax(-1)).float().mean().item()}
        if fq_too:
            rf = run_tier(pd, cd, spec, "torch", tokens, fq=True)
            r["vs_fakequant_prefill"] = cs.scaled_err(ra[3], rf[3])
            r["vs_fakequant_decode"] = cs.scaled_err(ra[4], rf[4])
        out.append(r)
        print(tag, "e2e", json.dumps(r), flush=True)
    log(f"{tag} e2e_vs_depth", out)


def consistency_vs_depth(prepared, cfg, spec, tag, depths, prompt=256):
    c = spec.prefill_chunk
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(5))
    table = torch.arange(1, spec.table_width + 1, device=DEV)[None, :]
    out = []
    for d in depths:
        pd, cd = cut(prepared, cfg, d)
        r = {"depth": d}
        for backend in (A, "torch"):
            with torch.inference_mode(), dispatch.use_dispatch(backend=backend):
                full = forward(pd.params, cd, tokens)[0, -1].float()
                caches = init_paged_caches(cd, spec.table_width + 1, spec.block_len, 1, device=DEV)
                for i in range(prompt // c):
                    lp, caches = paged_prefill_chunk(pd.params, caches, tokens[:, i * c:(i + 1) * c],
                                                     i * c, table, c, cd, spec.block_len, slot_idx=0)
                last = lp[0, -1].float()
            r[backend] = cs.scaled_err(last, full)
            r[backend + "_argmax"] = bool(last.argmax() == full.argmax())
        out.append(r)
        print(tag, "consistency", json.dumps(r), flush=True)
    log(f"{tag} consistency_vs_depth", out)


def main():
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    if CUDA:
        from repro_torch.kernels import _build
        print("build", json.dumps(_build.build_all()), flush=True)
        print(cs.card(), flush=True)
    which = sys.argv[1:] or ["m0", "m1", "jamba"]
    mamba, jamba = get_config("mamba2_2_7b"), get_config("jamba_1_5_large_398b")
    if not CUDA:
        from repro_torch.configs import get_smoke_config
        mamba, jamba = get_smoke_config("mamba2_2_7b"), get_smoke_config("jamba_1_5_large_398b")
    depths = (8, 16, 32, 64) if CUDA else (1, 2)
    if "m0" in which:
        t = time.perf_counter()
        prepared, cfg, spec = prepared_of(mamba, "compressed", (2, 4), None, False)
        rows, want, got = layer_study(prepared, cfg, spec, "m0")
        worst = max(rows, key=lambda r: r["res_dec_row"])["layer"]
        projection_study(prepared, cfg, spec, "m0", want, worst)
        worst2 = max(rows, key=lambda r: r["mix_dec_row"])["layer"]
        if worst2 != worst:
            projection_study(prepared, cfg, spec, "m0", want, worst2)
        e2e_vs_depth(prepared, cfg, spec, "m0", depths)
        consistency_vs_depth(prepared, cfg, spec, "m0", depths, prompt=256 if CUDA else 16)
        del prepared
        torch.cuda.empty_cache() if CUDA else None
        print("m0 seconds", time.perf_counter() - t, flush=True)
    if "m1" in which:
        t = time.perf_counter()
        prepared, cfg, spec = prepared_of(mamba, "gather", (2, 4), "int8", True)
        layer_study(prepared, cfg, spec, "m1 fq", fq=True)
        layer_study(prepared, cfg, spec, "m1 plain")
        e2e_vs_depth(prepared, cfg, spec, "m1", depths, fq_too=True)
        del prepared
        torch.cuda.empty_cache() if CUDA else None
        print("m1 seconds", time.perf_counter() - t, flush=True)
    if "jamba" in which:
        t = time.perf_counter()
        cuts = cs.JAMBA_CUTS if CUDA else {}
        prepared, cfg, spec = prepared_of(jamba, "compressed", (2, 4), None, False, cuts=cuts,
                                          moe_path="gather")
        layer_study(prepared, cfg, spec, "jamba")
        e2e_vs_depth(prepared, cfg, spec, "jamba", (cfg.num_layers,))
        if CUDA:
            cs.tier_check(prepared, cfg, spec, "jamba", cs.TIER_TOL, gate=False)
        print("jamba seconds", time.perf_counter() - t, flush=True)
    print("total seconds", time.perf_counter() - t0)


if __name__ == "__main__":
    main()
