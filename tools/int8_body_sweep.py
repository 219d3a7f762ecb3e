"""Time every body the redesigned int8 kernels can run, alone, on the card:
``tile_gemm_int8`` (``vg_tile_gemm_int8``) and K8 int8
(``vg_nm_spmm_gather_bk_int8``) at a grid of row counts and at the sites
of internlm2-1.8b, gemma3-1b's gelu w_in and hubert-xlarge's prefill; the
compressed gate-up dual ``nm_spmm_dual_int8`` (``vg_nm_spmm_dual_int8``)
at internlm2-1.8b's and qwen3-moe's expert gate-up, n in {2, 1}, 1-256
rows; K11 int8 ``nm_spmm_gather_int8`` (``vg_nm_spmm_gather_int8``, the
raw int32 (O, B) form a row-parallel site all-reduces) at the local sites
of internlm2-1.8b on a (1, 2) mesh (wo, w_out), n in {2, 1}, 32-1,024 rows;
the dense gate-up dual ``tile_gemm_dual_int8`` (``vg_tile_gemm_dual_int8``)
and the gathered gate-up dual K9 int8 ``nm_spmm_gather_dual_bk_int8``
(``vg_nm_spmm_gather_dual_bk_int8``, n in {2, 1}) at internlm2-1.8b's and
qwen3-moe's expert gate-up, 1-256 rows; the masked int8 singles
``tile_gemm_masked_int8`` (``vg_tile_gemm_masked_int8``) and
``nm_spmm_masked_int8`` (``vg_nm_spmm_masked_int8``, n in {2, 1}) and the
masked gathers, int8 ``nm_spmm_gather_bk_masked_int8``
(``vg_nm_spmm_gather_bk_masked_int8``) and, the one fp8 kernel of the
sweep, ``nm_spmm_gather_bk_masked_fp8`` (``vg_nm_spmm_gather_bk_masked_fp8``,
n in {2, 1}), at qwen3-moe's expert w_out and internlm2-1.8b's w_out, 1-256
rows, with 0, ~40% and all of the K steps of X live (whole steps zeroed: 64
columns, the gathers' 256 / n; the maps made at each body's row tile); and
(``dead``) the wholly dead launch (no step live) of every masked single of
``csrc/nm_spmm_sp_fp8.cuh`` (``tile_gemm_masked_int8`` / ``_fp8``,
``nm_spmm_masked_int8`` / ``_fp8`` at 2:4) at the expert's w_out, at its
plan and on the first body, a group that also runs against an older
checkout (``--tree``) whose entries take a plan.

    python3 tools/int8_body_sweep.py                      # one JSON line a shape
    python3 tools/int8_body_sweep.py --kernels tdual,gdual # some of them
    python3 tools/int8_body_sweep.py --kernels tmask,nmask # the masked singles
    python3 tools/int8_body_sweep.py --kernels gmask,gmask8 # the masked gathers
    python3 tools/int8_body_sweep.py --kernels dead --tree DIR   # another checkout

``--kernels`` keeps a call on the card to the kernels whose plans are being
set (the whole grid takes minutes of chip time, and each kernel's cases
stand alone).

Each body is launched through its C entry with an explicit (bm, body,
split): ``shared`` (gemm_int8.cu's first body at ``block_rows(b)`` rows,
split 1), ``s16`` / ``s64`` (the s8 stream of csrc/nm_spmm_sp_fp8.cuh over
16- / 64-row tiles, the K loop split by ``cluster_split`` at the blocks an
SM in the name: ``s16_3`` three, ``s64_1`` one; K9 int8's gathered dual
has 16-row tiles only; the fp8 gather adds ``k8_16`` / ``k8_64``, the
stream over 16- / 64-row tiles at K8 fp8's split, ``nm_spmm_gather/
kernel.py::fp8_plan``'s, where that plan streams).  Every int8 body's
output (bf16; K11's raw int32) must be the shared body's bit for bit
(int32 sums are exact in any order); every stream body of the fp8 gather
must be K8 fp8's (``vg_nm_spmm_gather_bk_fp8``'s stream) at the same tile
and split on the same masked X, bit for bit.  Times are ``chip_smoke.time_ms``'s (CUDA-graph
replays over enough weight copies to leave L2 cold), in ms, beside the
bodies the plans (``tile_gemm/kernel.py::int8_plan``,
``nm_spmm_gather/kernel.py::int8_plan``, ``nm_spmm/kernel.py::
int8_dual_plan``, ``nm_spmm_gather/kernel.py::kmajor_int8_plan``,
``tile_gemm/kernel.py::int8_dual_plan``, ``nm_spmm_gather/kernel.py::
int8_dual_plan``, ``tile_gemm/kernel.py::masked_int8_plan``,
``nm_spmm_gather/kernel.py::masked_int8_plan`` and ``::masked_fp8_plan``)
pick.  It needs a card and exits non-zero without one.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
chip_smoke = None   # the checkout's, imported by main()

TILE_ROWS = (8, 16, 17, 33, 64, 128, 255, 256, 512, 1024, 4000)
GATHER_ROWS = (8, 17, 33, 48, 64, 65, 128, 256, 1024, 4000)
DUAL_ROWS = (1, 8, 16, 17, 24, 32, 33, 48, 64, 65, 96, 128, 192, 256)
K11_ROWS = (32, 64, 128, 256, 512, 1024)   # multiples of 16 (KMAJOR_B)
K11_MESH = 2
MASK_ROWS = (1, 8, 16, 17, 33, 64, 65, 128, 256)
DEAD_ROWS = (8, 16, 64)
LIVE_SHARES = (0.0, 0.4, 1.0)
#: the fp8 kernels of the sweep (masked, timed beside the int8 ones)
FP8 = {"tile_gemm_masked_fp8", "nm_spmm_masked_fp8", "nm_spmm_gather_bk_masked_fp8"}


def bodies(b: int, kc: int, o: int, rows64: bool = True) -> dict:
    """name -> (bm, body, split) of every body at b rows over K (or K_c) =
    kc; ``rows64``: the stream has 64-row tiles too."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tile_gemm.kernel import cluster_split

    steps = kc // _build.BLOCK_K
    tiles = {bm: (o // _build.BLOCK_O) * -(-b // bm) for bm in _build.BLOCK_ROWS}
    out = {"shared": (_build.block_rows(b), 0, 1)}
    for bm, per_sm in ((16, 2), (16, 3), (64, 1), (64, 2)):
        if bm == 16 or rows64:
            out[f"s{bm}_{per_sm}"] = (bm, 1, cluster_split(tiles[bm], steps, per_sm))
    return out


def sweep_case(kernel, b, k, o, n, gen, lib, plan, share=None, only=None):
    """Time each body of one shape (the masked kernels: with ``share`` of
    X's K steps live); fail unless all give the same bits (the fp8 gather's
    stream bodies: K8 fp8's at their tile and split).  ``only``: the bodies
    to time, name -> (bm, body, split), instead of :func:`bodies`'."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels.actsparse import block_maps

    dev = "cuda"
    qd = torch.float8_e4m3fn if kernel in FP8 else torch.int8
    gathered = "gather_bk_masked" in kernel
    x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
    masked = share is not None
    step = 256 // n if gathered else _build.BLOCK_K   # X columns of one K step
    if masked:   # whole K steps zeroed
        steps = k // step
        live = torch.zeros(steps, dtype=torch.bool, device=dev)
        live[torch.randperm(steps, generator=gen, device=dev)[:round(share * steps)]] = True
        x = x * live.repeat_interleave(step).to(torch.bfloat16)
    xq, xs = quantize_rows(x, qd)
    # the masked stream reads kmask at its row tile: maps at each body's bm
    kmasks = {bm: block_maps(xq, bm, step)[1] for bm in _build.BLOCK_ROWS} if masked else {}
    kc = k * n // 4
    if kernel == "nm_spmm_gather_int8":     # K-major: x_t (K_eff, B), xs (1, B)
        xq, xs = xq.t().contiguous(), xs.reshape(1, -1)

    def leaf():
        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
        if kernel in ("tile_gemm_int8", "tile_gemm_masked_int8", "tile_gemm_masked_fp8"):
            lf = quantize_linear({"w": w}, qd)
            return (lf["w"], lf["scale"].reshape(1, -1))
        if kernel in ("tile_gemm_dual_int8", "nm_spmm_gather_dual_bk_int8"):
            lfs = []
            for _ in range(2):    # gate, then up: (w, scale) or (values, idx, scale)
                if kernel == "tile_gemm_dual_int8":
                    lf = quantize_linear({"w": w}, torch.int8)
                    lfs += [lf["w"], lf["scale"].reshape(1, -1)]
                else:
                    lf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"),
                                        "gather", quantize=torch.int8)
                    lfs += [lf["values"], lf["gather_idx"], lf["scale"].reshape(1, -1)]
                w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
            return tuple(lfs)
        if kernel in ("nm_spmm_masked_int8", "nm_spmm_masked_fp8"):
            c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
            lf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)}, qd)
            return (lf["values"], lf["meta_packed"], lf["scale"].reshape(1, -1))
        if kernel == "nm_spmm_dual_int8":
            lfs = []
            for _ in range(2):
                c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
                lf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)},
                                     torch.int8)
                lfs += [lf["values"], lf["meta_packed"], lf["scale"].reshape(1, -1)]
                w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
            return tuple(lfs)
        lf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                            quantize=qd)
        return (lf["values"], lf["gather_idx"], lf["scale"].reshape(1, -1))

    nbytes = {"tile_gemm_int8": kc * o + 4 * o, "tile_gemm_masked_int8": kc * o + 4 * o,
              "tile_gemm_masked_fp8": kc * o + 4 * o,
              "nm_spmm_masked_int8": kc * o * 5 // 4 + 4 * o,
              "nm_spmm_masked_fp8": kc * o * 5 // 4 + 4 * o,
              "tile_gemm_dual_int8": 2 * (kc * o + 4 * o),
              "nm_spmm_gather_dual_bk_int8": 2 * (kc * o + 4 * o + 4 * kc),
              "nm_spmm_dual_int8": 2 * (kc * o * 5 // 4 + 4 * o)}.get(kernel,
                                                                     kc * o + 4 * o + 4 * kc)
    leaves = [leaf() for _ in range(chip_smoke.copies_for(nbytes))]
    y = (torch.empty((o, b), dtype=torch.int32, device=dev) if kernel == "nm_spmm_gather_int8"
         else torch.empty((b, o), dtype=torch.bfloat16, device=dev))

    def launch(bm, body, split, y=y, twin=False):
        """A body of the kernel; ``twin``: the fp8 gather's unmasked twin, K8
        fp8 (``vg_nm_spmm_gather_bk_fp8``) at that body."""
        def call(*lf):
            stream = _build.stream_of(xq)   # the current one: a graph captures on its own
            if twin:
                v, idx, ws = lf
                rc = lib.vg_nm_spmm_gather_bk_fp8(
                    xq.data_ptr(), v.data_ptr(), idx.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                    None, None, y.data_ptr(), b, k, o, n, 0, 0, bm, body, _build.BLOCK_O,
                    split, None, stream)
            elif kernel in ("tile_gemm_masked_int8", "tile_gemm_masked_fp8"):
                w, ws = lf
                rc = getattr(lib, f"vg_{kernel}")(xq.data_ptr(), w.data_ptr(),
                                                  kmasks[bm].data_ptr(), xs.data_ptr(),
                                                  ws.data_ptr(), None, None, y.data_ptr(), b,
                                                  k, o, 0, 0, bm, body, split, stream)
            elif kernel in ("nm_spmm_masked_int8", "nm_spmm_masked_fp8"):
                v, m, ws = lf
                rc = getattr(lib, f"vg_{kernel}")(xq.data_ptr(), v.data_ptr(), m.data_ptr(),
                                                  kmasks[bm].data_ptr(), xs.data_ptr(),
                                                  ws.data_ptr(), None, None, y.data_ptr(), b,
                                                  k, o, n, 0, 0, bm, body, split, stream)
            elif gathered:
                v, idx, ws = lf
                rc = getattr(lib, f"vg_{kernel}")(xq.data_ptr(), v.data_ptr(), idx.data_ptr(),
                                                  kmasks[bm].data_ptr(), xs.data_ptr(),
                                                  ws.data_ptr(), None, None, y.data_ptr(), b,
                                                  k, o, n, 0, 0, bm, body, split, stream)
            elif kernel == "tile_gemm_int8":
                w, ws = lf
                rc = lib.vg_tile_gemm_int8(xq.data_ptr(), w.data_ptr(), xs.data_ptr(),
                                           ws.data_ptr(), None, None, y.data_ptr(), b, k, o,
                                           0, 0, bm, body, split, stream)
            elif kernel == "nm_spmm_dual_int8":
                vg, mg, sg, vu, mu, su = lf
                rc = lib.vg_nm_spmm_dual_int8(xq.data_ptr(), vg.data_ptr(), mg.data_ptr(),
                                              vu.data_ptr(), mu.data_ptr(), xs.data_ptr(),
                                              sg.data_ptr(), su.data_ptr(), None, y.data_ptr(),
                                              b, k, o, n, 0, bm, body, split, stream)
            elif kernel == "tile_gemm_dual_int8":
                wg, sg, wu, su = lf
                rc = lib.vg_tile_gemm_dual_int8(xq.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                                xs.data_ptr(), sg.data_ptr(), su.data_ptr(),
                                                None, y.data_ptr(), b, k, o, 0, bm, body, split,
                                                stream)
            elif kernel == "nm_spmm_gather_dual_bk_int8":
                vg, ig, sg, vu, iu, su = lf
                rc = lib.vg_nm_spmm_gather_dual_bk_int8(
                    xq.data_ptr(), vg.data_ptr(), ig.data_ptr(), vu.data_ptr(), iu.data_ptr(),
                    xs.data_ptr(), sg.data_ptr(), su.data_ptr(), None, y.data_ptr(), b, k, o, n,
                    0, bm, body, split, stream)
            elif kernel == "nm_spmm_gather_int8":     # the raw int32 (O, B) accumulator
                v, idx, _ = lf
                rc = lib.vg_nm_spmm_gather_int8(xq.data_ptr(), v.data_ptr(), idx.data_ptr(),
                                                None, None, y.data_ptr(), b, k, o, n,
                                                _build.OUT_RAW, bm, body, split, stream)
            else:
                v, idx, ws = lf
                rc = lib.vg_nm_spmm_gather_bk_int8(xq.data_ptr(), v.data_ptr(), idx.data_ptr(),
                                                   xs.data_ptr(), ws.data_ptr(), None, None,
                                                   y.data_ptr(), b, k, o, n, 0, 0, bm, body,
                                                   split, stream)
            _build.check(rc, kernel, lib)
        return call

    if only is not None:
        named = dict(only)
    elif kernel == "nm_spmm_gather_bk_masked_fp8":
        from repro_torch.kernels.nm_spmm_gather.kernel import fp8_plan
        twin = fp8_plan(b, k, o, n)
        named = {"shared": (_build.block_rows(b), 0, 1)}
        if twin["body"] == "stream":
            named.update({f"k8_{bm}": (bm, 1, twin["split"]) for bm in _build.BLOCK_ROWS})
    else:
        named = bodies(b, k if kernel in ("nm_spmm_dual_int8", "nm_spmm_masked_int8")
                       else kc, o, rows64=kernel != "nm_spmm_gather_dual_bk_int8")
    row = {"kernel": kernel, "B": b, "K": k, "O": o, "n": n, "plan": plan, "ms": {},
           **({"live_share": share} if masked else {}), "bodies": named}
    first = None
    for name, (bm, body, split) in named.items():
        call = launch(bm, body, split)
        call(*leaves[0])
        torch.cuda.synchronize()
        got = y.clone()
        if kernel == "nm_spmm_gather_bk_masked_fp8" and body == 1:
            # a stream body: K8 fp8's stream at its tile and split, bit for bit
            twin = torch.empty_like(y)
            launch(bm, 1, split, y=twin, twin=True)(*leaves[0])
            torch.cuda.synchronize()
            if not torch.equal(got, twin):
                chip_smoke.fail(f"{kernel} B={b} K={k} O={o} n={n}: body {name} is not K8 "
                                f"fp8's bits at its tile and split")
        elif kernel in FP8:
            pass   # e4m3 sums in another order: held to K8 fp8 above, or only timed
        elif first is None:
            first = got
        elif not torch.equal(got, first):
            chip_smoke.fail(f"{kernel} B={b} K={k} O={o} n={n}: body {name} is not the shared "
                            f"body's bits")
        row["ms"][name] = chip_smoke.time_ms(call, leaves, calls=8 if b >= 1024 else 24)
    row["fastest"] = min(row["ms"], key=row["ms"].get)
    chip_smoke.log(json.dumps(row))
    del leaves
    torch.cuda.empty_cache()


def main():
    global chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="tile,gather,dual,k11,tdual,gdual,tmask,nmask,gmask,"
                                          "gmask8",
                    help="comma-separated: tile (tile_gemm_int8), gather (K8 int8), dual "
                         "(nm_spmm_dual_int8), k11 (nm_spmm_gather_int8), tdual "
                         "(tile_gemm_dual_int8), gdual (K9 int8, "
                         "nm_spmm_gather_dual_bk_int8), tmask (tile_gemm_masked_int8), "
                         "nmask (nm_spmm_masked_int8), gmask (nm_spmm_gather_bk_masked_int8), "
                         "gmask8 (nm_spmm_gather_bk_masked_fp8), dead (the masked singles' "
                         "wholly dead launches, int8 and fp8)")
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout whose chip_smoke.py and kernels run")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke as smoke
    chip_smoke = smoke
    if not torch.cuda.is_available():
        chip_smoke.fail("no card: the sweep times CUDA kernels")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.nm_spmm.kernel import fp8_plan as nm_fp8_plan
    from repro_torch.kernels.nm_spmm.kernel import int8_plan as nm_plan
    from repro_torch.kernels.tile_gemm.kernel import masked_fp8_plan, masked_int8_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.log(f"int8 body sweep of {tree} on {chip_smoke.card()}")
    lib = _build.library("gemm_int8.cu")
    lib_fp8 = _build.library("gemm_fp8.cu")
    gen = torch.Generator(device="cuda").manual_seed(0)
    il, gm, hb, moe = (get_config(a) for a in ("internlm2_1_8b", "gemma3_1b", "hubert_xlarge",
                                                "qwen3_moe_235b_a22b"))
    w_outs = ((moe.d_ff, moe.d_model), (il.d_ff, il.d_model))
    if "dead" in which:   # the plan's body and the first, no step live
        k, o = w_outs[0]
        for kernel, n, plan_of in (
                ("tile_gemm_masked_int8", 4, lambda b: masked_int8_plan(b, k, o)),
                ("tile_gemm_masked_fp8", 4, lambda b: masked_fp8_plan(b, k, o)),
                ("nm_spmm_masked_int8", 2,
                 lambda b: {**nm_plan(b, k, o, 2), "rows": _build.block_rows(b)}),
                ("nm_spmm_masked_fp8", 2,
                 lambda b: {**nm_fp8_plan(b, k, o, 2), "rows": _build.block_rows(b)})):
            for b in DEAD_ROWS:
                p = plan_of(b)
                body = 0 if p["body"] == "shared" else 1
                sweep_case(kernel, b, k, o, n, gen, lib_fp8 if kernel in FP8 else lib, p, 0.0,
                           only={"plan": (p["rows"], body, p["split"]),
                                 "shared": (_build.block_rows(b), 0, 1)})
    if which & {"tile", "gather", "dual", "tdual", "gdual", "tmask", "nmask", "k11"}:
        sweep_int8(which, lib, gen, il, gm, hb, moe, w_outs)
    if which & {"gmask", "gmask8"}:
        from repro_torch.kernels.nm_spmm_gather.kernel import masked_fp8_plan as gmask8_plan
        from repro_torch.kernels.nm_spmm_gather.kernel import masked_int8_plan as gmask_plan
        for kernel, plan_of, lb in (("nm_spmm_gather_bk_masked_int8", gmask_plan, lib),
                                    ("nm_spmm_gather_bk_masked_fp8", gmask8_plan, lib_fp8)):
            if ("gmask8" if kernel in FP8 else "gmask") not in which:
                continue
            for k, o in w_outs:
                for n in (2, 1):
                    for b in MASK_ROWS:
                        for share in LIVE_SHARES:
                            sweep_case(kernel, b, k, o, n, gen, lb, plan_of(b, k, o, n), share)


def sweep_int8(which, lib, gen, il, gm, hb, moe, w_outs):
    """The int8 kernels' grids (every group but the masked gathers and
    ``dead``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.nm_spmm.kernel import int8_dual_plan
    from repro_torch.kernels.nm_spmm.kernel import int8_plan as nm_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import int8_dual_plan as gdual_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import int8_plan as gather_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import kmajor_int8_plan
    from repro_torch.kernels.tile_gemm.kernel import int8_dual_plan as tdual_plan
    from repro_torch.kernels.tile_gemm.kernel import int8_plan as tile_plan
    from repro_torch.kernels.tile_gemm.kernel import masked_int8_plan

    il_sites = [(il.d_model, il.attn_dim), (il.d_model, il.kv_dim), (il.d_ff, il.d_model)]
    if "tile" in which:
        for k, o in il_sites + [(gm.d_model, gm.d_ff)]:
            for b in TILE_ROWS:
                sweep_case("tile_gemm_int8", b, k, o, 4, gen, lib, tile_plan(b, k, o))
    hb_sites = [(hb.d_model, hb.attn_dim), (hb.d_ff, hb.d_model), (hb.d_model, hb.d_ff)]
    if "gather" in which:
        for n, sites in ((2, il_sites + [(gm.d_model, gm.d_ff)] + hb_sites), (1, il_sites)):
            for k, o in sites:
                for b in GATHER_ROWS:
                    sweep_case("nm_spmm_gather_bk_int8", b, k, o, n, gen, lib,
                               gather_plan(b, k, o, n))
    gate_ups = ((il.d_model, il.d_ff), (moe.d_model, moe.d_ff))
    if "dual" in which:
        for k, o in gate_ups:
            for n in (2, 1):
                for b in DUAL_ROWS:
                    sweep_case("nm_spmm_dual_int8", b, k, o, n, gen, lib,
                               int8_dual_plan(b, k, o, n))
    if "tdual" in which:
        for k, o in gate_ups:
            for b in DUAL_ROWS:
                sweep_case("tile_gemm_dual_int8", b, k, o, 4, gen, lib, tdual_plan(b, k, o))
    if "gdual" in which:
        for k, o in gate_ups:
            for n in (2, 1):
                for b in DUAL_ROWS:
                    sweep_case("nm_spmm_gather_dual_bk_int8", b, k, o, n, gen, lib,
                               gdual_plan(b, k, o, n))
    if "tmask" in which:
        for k, o in w_outs:
            for b in MASK_ROWS:
                for share in LIVE_SHARES:
                    sweep_case("tile_gemm_masked_int8", b, k, o, 4, gen, lib,
                               masked_int8_plan(b, k, o), share)
    if "nmask" in which:
        for k, o in w_outs:
            for n in (2, 1):
                for b in MASK_ROWS:
                    for share in LIVE_SHARES:
                        sweep_case("nm_spmm_masked_int8", b, k, o, n, gen, lib,
                                   {**nm_plan(b, k, o, n), "rows": _build.block_rows(b)},
                                   share)
    if "k11" in which:
        for k, o in ((il.attn_dim // K11_MESH, il.d_model), (il.d_ff // K11_MESH, il.d_model)):
            for n in (2, 1):
                for b in K11_ROWS:
                    sweep_case("nm_spmm_gather_int8", b, k, o, n, gen, lib,
                               kmajor_int8_plan(b, k, o, n))


if __name__ == "__main__":
    main()
