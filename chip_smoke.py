"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on a miss:

1. build   — nvcc builds the port's CUDA kernels from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, started together).
2. kernels — each of tile_gemm, tile_gemm_dual, nm_spmm, nm_spmm_dual
             against its plain PyTorch version at the main path's
             shapes (B in {8, 64}; (K, O) of internlm2-1.8b's projections;
             n in {1, 2}), bf16, tolerance 1e-2 of max|plain| (the two
             sum in different orders).  One JSON line per shape with the
             kernel's, the plain version's and torch.matmul's times
             (CUDA-graph replays between CUDA events, weights rotated
             through > 100 MB so L2 is cold as in a real decode step) and
             the bandwidth bound.
3. serving — full-width internlm2-1.8b (24 layers, random bf16 weights
             from a seeded torch.Generator on the card) served by the
             port's Engine in the dense, 2:4 and 1:4 layouts: 16
             requests, prompts of 128-256 tokens, 32 new tokens, 8 slots,
             prefill chunks of 64, max_len 512.  Every linear site must
             plan a cuda kernel and every kernel of the layout must
             launch (counts are zeroed just before each run and read just
             after).
4. tiers   — one prefill chunk + one decode step under the cuda and the
             torch backends on the same params; logits must agree to
             3e-2 of max|torch| (bf16 rounding differs between tiers).

It then prints the kernels JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository beside it, it exits non-zero and prints no result.
TF32 is off for every fp32 product here (the plain versions' fp32
matmuls run in full fp32).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TOL = 1e-2                       # kernel vs plain, scaled by max|plain|
TIER_TOL = 3e-2                  # cuda tier vs torch tier logits, scaled
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"
REPLACES = {
    "tile_gemm": "src/repro/kernels/tile_gemm/kernel.py:82",
    "tile_gemm_dual": "src/repro/kernels/tile_gemm/kernel.py:382",
    "nm_spmm": "src/repro/kernels/nm_spmm/kernel.py:125",
    "nm_spmm_dual": "src/repro/kernels/nm_spmm/kernel.py:437",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1e-6)).item()


def time_ms(fn, operands, calls: int = 24, replays: int = 5) -> float:
    """Device ms per call: ``calls`` calls, cycling through ``operands`` so
    the weights come from device memory and not L2, are captured into one
    CUDA graph and replayed between CUDA events.  (Timed eagerly, every
    one of these calls is shorter than its Python launch path, so events
    around an eager loop would time the host.)"""
    calls = max(calls, len(operands))
    for ops in operands[:2]:
        fn(*ops)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*operands[i % len(operands)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(128e6 / nbytes))


def bound_ms(nbytes: int, flops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 2
def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def kernel_phase(cfg, gen, card_line: str):
    from repro_torch.core import nm
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm, nm_spmm_dual
    from repro_torch.kernels.tile_gemm.kernel import tile_gemm, tile_gemm_dual
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm.ref import (dense_weight, nm_spmm_dual_ref,
                                                 nm_spmm_ref)
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_ref, tile_gemm_ref

    dev = "cuda"
    d, ff = cfg.d_model, cfg.d_ff
    singles = [(d, cfg.attn_dim), (d, cfg.kv_dim), (ff, d)]
    rows = []

    def record(kernel, b, k, o, n, got, want, t_k, t_p, t_l, nbytes, flops):
        e = scaled_err(got, want)
        bmsv, by = bound_ms(nbytes, flops)
        row = {"kernel": kernel, "B": b, "K": k, "O": o, "n": n,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "scaled_err": e, "kernel_ms": t_k, "plain_ms": t_p, "library_ms": t_l,
               "bound_ms": bmsv, "bound_by": by, "card": card_line}
        rows.append(row)
        log(json.dumps(row))
        if not (e <= TOL):
            fail(f"{kernel} B={b} K={k} O={o} n={n}: error {e:.3e} > {TOL}")

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    for b in (8, 64):
        for k, o in singles:
            x = rand((b, k))
            ws = [rand((k, o), k ** -0.5) for _ in range(copies_for(2 * k * o))]
            y = tile_gemm(x, ws[0])
            torch.cuda.synchronize()
            ops = [(x, w) for w in ws]
            record("tile_gemm", b, k, o, 4, y, tile_gemm_ref(x, ws[0]),
                   time_ms(tile_gemm, ops), time_ms(tile_gemm_ref, ops),
                   time_ms(torch.matmul, ops),
                   2 * (b * k + k * o + b * o), 2 * b * k * o)
            for n in (1, 2):
                comp = []
                for i in range(copies_for(k * o * n // 2)):
                    w = ws[i] if i < len(ws) else rand((k, o), k ** -0.5)
                    c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
                    comp.append((x, c.values, nm.pack_meta(c.meta), n))
                y = nm_spmm(*comp[0])
                torch.cuda.synchronize()
                kc = k * n // 4
                dense_ops = [(x, dense_weight(v, m, n_))
                             for _, v, m, n_ in comp[:copies_for(2 * k * o)]]
                record("nm_spmm", b, k, o, n, y, nm_spmm_ref(*comp[0]),
                       time_ms(nm_spmm, comp), time_ms(nm_spmm_ref, comp),
                       time_ms(torch.matmul, dense_ops),
                       2 * (b * k + kc * o + b * o) + kc * o // 4, 2 * b * kc * o)
        # the gate-up pair at (d, ff)
        k, o = d, ff
        x = rand((b, k))
        pairs = [(rand((k, o), k ** -0.5), rand((k, o), k ** -0.5))
                 for _ in range(copies_for(4 * k * o))]
        ops = [(x, g, u) for g, u in pairs]
        y = tile_gemm_dual(*ops[0])
        torch.cuda.synchronize()
        cats = [(x, torch.cat([g, u], dim=1)) for g, u in pairs[:2]]
        record("tile_gemm_dual", b, k, o, 4, y, tile_gemm_dual_ref(*ops[0]),
               time_ms(tile_gemm_dual, ops), time_ms(tile_gemm_dual_ref, ops),
               time_ms(torch.matmul, cats),
               2 * (b * k + 2 * k * o + b * o), 4 * b * k * o)
        for n in (1, 2):
            comp = []
            for i in range(copies_for(k * o * n)):
                g, u = (pairs[i] if i < len(pairs)
                        else (rand((k, o), k ** -0.5), rand((k, o), k ** -0.5)))
                cg = nm.compress_nm(nm.prune_nm(g, n, 4)[0], n, 4)
                cu = nm.compress_nm(nm.prune_nm(u, n, 4)[0], n, 4)
                comp.append((x, cg.values, nm.pack_meta(cg.meta), cu.values,
                             nm.pack_meta(cu.meta), n))
            y = nm_spmm_dual(*comp[0])
            torch.cuda.synchronize()
            kc = k * n // 4
            cats = [(x, torch.cat([dense_weight(vg, mg, n_), dense_weight(vu, mu, n_)], 1))
                    for _, vg, mg, vu, mu, n_ in comp[:2]]
            record("nm_spmm_dual", b, k, o, n, y, nm_spmm_dual_ref(*comp[0]),
                   time_ms(nm_spmm_dual, comp), time_ms(nm_spmm_dual_ref, comp),
                   time_ms(torch.matmul, cats),
                   2 * (b * k + 2 * kc * o + b * o) + 2 * kc * o // 4, 4 * b * kc * o)

    # the flush's other lattice points (bias, silu, gelu) at one shape
    k, o = d, cfg.attn_dim
    x, w = rand((8, k)), rand((k, o), k ** -0.5)
    bias = torch.randn(o, generator=gen, device=dev)
    c = nm.compress_nm(nm.prune_nm(w, 2, 4)[0], 2, 4)
    pm = nm.pack_meta(c.meta)
    for act in ("silu", "gelu"):
        spec = EpilogueSpec(act=act, bias=True)
        for name, got, want in (
                ("tile_gemm", tile_gemm(x, w, epilogue=spec, bias=bias),
                 tile_gemm_ref(x, w, epilogue=spec, bias=bias)),
                ("nm_spmm", nm_spmm(x, c.values, pm, 2, epilogue=spec, bias=bias),
                 nm_spmm_ref(x, c.values, pm, 2, epilogue=spec, bias=bias))):
            e = scaled_err(got, want)
            log(f"epilogue {spec.point} {name}: scaled error {e:.3e}")
            if not (e <= TOL):
                fail(f"{name} epilogue {spec.point}: error {e:.3e} > {TOL}")
    torch.cuda.synchronize()
    return rows


# --------------------------------------------------------------- phase 3
LAYOUTS = (("dense", None), ("compressed", (2, 4)), ("compressed", (1, 4)))
LAYOUT_KERNELS = {"dense": ("tile_gemm", "tile_gemm_dual"),
                  "compressed": ("nm_spmm", "nm_spmm_dual")}


def serve_layout(base_cfg, layout, sparsity):
    from repro_torch import kernels, serving
    from repro_torch.models import init_params

    tag = f"{sparsity[0]}:{sparsity[1]}" if sparsity else "dense"
    spec = serving.ServingSpec(layout=layout, sparsity=sparsity, slots=8,
                               max_len=512, block_len=8, prefill_chunk=64)
    cfg = spec.apply_to(base_cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = init_params(gen, cfg, device="cuda")
        prepared = serving.prepare(params, spec, cfg=cfg)
    del params
    torch.cuda.synchronize()
    log(f"[{tag}] init + prepare {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    report = prepared.dispatch_report()
    log(f"[{tag}] dispatch engine plan:")
    for line in report:
        log(line)
    off = [line for line in report if "[cuda]" not in line]
    if off:
        fail(f"[{tag}] {len(off)} linear site(s) off the cuda kernels: {off[0]}")

    engine = serving.Engine(prepared)
    warm = serving.make_poisson_trace(seed=1, num_requests=2, vocab_size=cfg.vocab_size,
                                      prompt_mix=((64, 1.0),), new_mix=((2, 1.0),))
    engine.run(warm)
    trace = serving.make_poisson_trace(
        seed=0, num_requests=16, rate=1.0, vocab_size=cfg.vocab_size,
        prompt_mix=((128, 1.0), (192, 1.0), (256, 1.0)), new_mix=((32, 1.0),))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rep = engine.run(trace)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[{tag}] served {rep.describe()}")
    log(f"[{tag}] launches: {json.dumps(counts)}")
    for name in LAYOUT_KERNELS[layout]:
        if counts[name] == 0:
            fail(f"[{tag}] kernel {name} never launched on the main path")
    if rep.completed != len(trace):
        fail(f"[{tag}] {rep.completed}/{len(trace)} requests completed")
    for s in rep.stats:
        if len(s.tokens) != 32 or not all(0 <= t < cfg.vocab_size for t in s.tokens):
            fail(f"[{tag}] request {s.rid} produced {s.tokens}")
    result = {"layout": tag, "tokens_per_s": rep.tokens_per_s,
              "p50_latency_s": rep.p50_latency_s, "p99_latency_s": rep.p99_latency_s,
              "wall_s": rep.wall_s, "model_calls": rep.model_calls,
              "prefill_chunks": rep.prefill_chunks, "decode_calls": rep.decode_calls,
              "launches": counts}
    log(json.dumps(result))
    result["decode_profile"] = profile_decode(prepared, cfg, spec, tag)
    tiers = tier_check(prepared, cfg, spec, tag)
    return result, tiers


def profile_decode(prepared, cfg, spec, tag, steps: int = 3):
    """Where a decode step's time goes: ``steps`` batched decode steps (all
    slots active at position 255) under torch.profiler; device time by
    kernel, and the device's busy share of the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_paged_caches, paged_decode_step

    dev = "cuda"
    b, w = spec.slots, spec.table_width
    caches = init_paged_caches(cfg, b * w + 1, spec.block_len, device=dev)
    table = torch.arange(1, b * w + 1, device=dev).reshape(b, w)
    tokens = torch.ones((b, 1), dtype=torch.long, device=dev)
    positions = torch.full((b,), 255, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)

    def step():
        return paged_decode_step(prepared.params, caches, tokens, positions, table,
                                 active, cfg, spec.block_len)

    with torch.inference_mode(), prepared.activate():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    # None, not 0, when the profiler recorded no device activity at all
    busy_ms = (sum(e.self_device_time_total for e in kern) / 1e3 / steps
               if kern else None)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    res = {"layout": tag, "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
           "top_kernels": [{"name": e.key[:90], "ms_per_step":
                            e.self_device_time_total / 1e3 / steps,
                            "calls_per_step": e.count / steps} for e in top]}
    host = [e for e in prof.key_averages() if e not in kern]
    res["top_host_ops"] = [
        {"name": e.key[:60], "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
         "calls_per_step": e.count / steps}
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]]
    log(json.dumps(res))
    return res


# --------------------------------------------------------------- phase 4
def tier_check(prepared, cfg, spec, tag):
    from repro_torch.kernels import dispatch
    from repro_torch.models import (init_paged_caches, paged_decode_step,
                                    paged_prefill_chunk)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    c = spec.prefill_chunk
    tokens = torch.randint(1, cfg.vocab_size, (1, c), generator=gen, device=dev)
    table = torch.arange(1, spec.table_width + 1, device=dev)[None, :]
    out, nxt = {}, None
    for backend in ("cuda", "torch"):
        with torch.inference_mode(), dispatch.use_dispatch(backend=backend):
            caches = init_paged_caches(cfg, spec.table_width + 1, spec.block_len,
                                       device=dev)
            lp, caches = paged_prefill_chunk(prepared.params, caches, tokens, 0, table,
                                             c, cfg, spec.block_len)
            if nxt is None:
                nxt = torch.argmax(lp[0, -1]).view(1, 1)
            ld, _ = paged_decode_step(prepared.params, caches, nxt,
                                      torch.tensor([c], device=dev), table,
                                      torch.tensor([True], device=dev), cfg,
                                      spec.block_len)
        out[backend] = (lp[0].float(), ld[0].float())
    (pc, dc), (pt, dt) = out["cuda"], out["torch"]
    if not (torch.isfinite(pc).all() and torch.isfinite(dc).all()):
        fail(f"[{tag}] non-finite logits on the cuda tier")
    if pc.shape != (c, cfg.vocab_size) or dc.shape != (1, cfg.vocab_size):
        fail(f"[{tag}] logits shapes {tuple(pc.shape)} {tuple(dc.shape)}")
    e_p, e_d = scaled_err(pc, pt), scaled_err(dc, dt)
    agree = (torch.cat([pc, dc]).argmax(-1) == torch.cat([pt, dt]).argmax(-1))
    res = {"layout": tag, "prefill_scaled_err": e_p, "decode_scaled_err": e_d,
           "greedy_agreement": agree.float().mean().item(), "positions": agree.numel()}
    log(json.dumps(res))
    if not (e_p <= TIER_TOL and e_d <= TIER_TOL):
        fail(f"[{tag}] cuda vs torch tier logits differ: {e_p:.3e} / {e_d:.3e}")
    return res


# --------------------------------------------------------------- main
def layer_decode(rows, kernel, n, b, shapes):
    """Sum of one layer's decode-step launches of ``kernel`` at batch b."""
    tot = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    used = []
    for k, o in shapes:
        r = next(r for r in rows if (r["kernel"], r["B"], r["K"], r["O"], r["n"])
                 == (kernel, b, k, o, n))
        for key in tot:
            tot[key] += r[key]
        used.append(r)
    tot["bound_by"] = max(used, key=lambda r: r["bound_ms"])["bound_by"]
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["kernel"] == kernel)
    return tot


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke test needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    secs = _build.build_all()
    log(f"build: {json.dumps(secs)} seconds")
    for name, text in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"ptxas {name}: {len(regs)} kernels; " + "; ".join(sorted(set(regs))))

    cfg = get_config("internlm2_1_8b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    card_line = card()
    t0 = time.perf_counter()
    rows = kernel_phase(cfg, gen, card_line)
    log(f"kernel phase {time.perf_counter() - t0:.1f}s")

    served, tiers, launches = [], [], {}
    for layout, sparsity in LAYOUTS:
        t0 = time.perf_counter()
        res, tier = serve_layout(cfg, layout, sparsity)
        served.append(res)
        tiers.append(tier)
        for name, cnt in res["launches"].items():
            launches[name] = launches.get(name, 0) + cnt
        torch.cuda.empty_cache()
        log(f"[{res['layout']}] phase {time.perf_counter() - t0:.1f}s")

    d, ff = cfg.d_model, cfg.d_ff
    singles = [(d, cfg.attn_dim), (d, cfg.kv_dim), (d, cfg.kv_dim), (cfg.attn_dim, d), (ff, d)]
    entries = []
    for name, n, shapes in (("tile_gemm", 4, singles), ("tile_gemm_dual", 4, [(d, ff)]),
                            ("nm_spmm", 2, singles), ("nm_spmm_dual", 2, [(d, ff)])):
        tot = layer_decode(rows, name, n, 8, shapes)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["kernel_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
            "measured_as": f"one layer's decode launches at B=8 ({len(shapes)} "
                           f"shape(s)){', n=2 (2:4)' if n == 2 else ''}"})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
