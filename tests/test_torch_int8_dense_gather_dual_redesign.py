"""The redesigned Hopper bodies of the int8 dense gate-up dual
tile_gemm_dual_int8 (with tile_gemm_dual_int8_requant) -- the s8 form of
csrc/nm_spmm_sp_fp8.cuh's dense DUAL stream (N = 4: both dense weights'
values tiles a stage beside one X tile, each warp's A registers of both read
with ldmatrix .trans + __byte_perm, two mma.sync m16n8k32 s8 -> s32 a step a
weight into two int32 accumulator sets, both partial planes summed in rank
order over a cluster's split, gemm_int8.cu's DualFlushI8T<false>) -- and of
the int8 gathered gate-up dual K9, nm_spmm_gather_dual_bk_int8 (with its
_requant form) at n in {1, 2}: the s8 form of that header's gathered DUAL
stream (one X span a step selected twice through each weight's indices,
both dense values tiles, DualFlushI8T<true>, ws first).

On the CPU: ``tile_gemm/kernel.py::int8_dual_plan`` and
``nm_spmm_gather/kernel.py::int8_dual_plan`` at internlm2-1.8b's and
qwen3-moe's gate-up over a grid of rows: splits powers of two up to min(8,
steps), their spans covering K (K_c); the (bm, body, split) each wrapper
hands its C entry (a recording stand-in, meta tensors) is its plan's; a
block's shared memory for S8 DUAL at N = 4, G in {0, 1, 2}, fits the blocks
an SM the plans assume; a numpy emulation of the s8 dense DUAL stream (the A
operand as the dense stream reads it, int32 partials over each rank's span
summed in rank order, DualFlushI8T<false>'s order) whose g and u sums are
bitwise the JAX package's raw ``tile_gemm_int8`` on each weight, whose bf16
/ fp32 output is within 1e-6 of JAX's int8 ``tile_gemm_dual`` (Pallas,
interpret mode) and whose requantized codes are JAX's but one step on at
most 0.1%; a numpy emulation of the s8 gathered DUAL stream (one span read
once, select16 through each weight's indices, +0 outside [0, 4), then
DualFlushI8T<true>) whose sums are bitwise the int64 product of the
gathered X and each values tile and whose output is held to JAX's int8
``nm_spmm_gather_dual_bk`` (interpret) as above.  On the card (``cuda``):
both duals on their plans' bodies bitwise the first body (bf16, fp32,
codes), the same bits on a second launch; the entries refuse the raw
accumulator, split != 1 on body 0, and body 1 at n = 4 for K9.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm_gather import kernel as gk
from repro_torch.kernels.nm_spmm_gather.kernel import fp8_dual_plan as gather_fp8_dual_plan
from repro_torch.kernels.nm_spmm_gather.kernel import int8_dual_plan as gather_dual_plan
from repro_torch.kernels.tile_gemm import kernel as tk
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  FP8_STREAM16_BLOCKS_PER_SM,
                                                  INT8_DENSE_DUAL_STREAM16_MAX_ROWS, SMS,
                                                  cluster_split)
from repro_torch.kernels.tile_gemm.kernel import int8_dual_plan as tile_dual_plan
from repro_torch.kernels.tile_gemm.kernel import int8_plan as tile_int8_plan
from test_torch_fp8_kmajor_dual_redesign import _dense_dual_stream_smem
from test_torch_fp8_sparse_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans,
                                            _silu)
from test_torch_gather_masked_fp8_dual_redesign import (_dual_select_e4m3,
                                                        _fp8_gather_dual_smem, _gather_idx)
from test_torch_int8_dense_gather_redesign import _int8_rows, _rank_sums, _s8_dense_steps
from test_torch_int8_stream_redesign import _i8_codes, _meta, rec  # noqa: F401
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

ARCHS = ["internlm2_1_8b", "qwen3_moe_235b_a22b"]
ROWS = [1, 8, 16, 17, 24, 32, 33, 48, 49, 64, 65, 128, 255, 256]


def _gate_up(arch):
    """The gate-up pair's (K, O): d_model x d_ff (qwen3-moe: an expert's)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.d_model, cfg.d_ff


def _split_ok(split, steps):
    assert split & (split - 1) == 0 and 1 <= split <= min(8, steps), (split, steps)


# ------------------------------------------------------------- the planners
def _tile_rule(b, k, o):
    """The dense int8 dual's tile and split: 16-row tiles split at three
    blocks an SM up to INT8_DENSE_DUAL_STREAM16_MAX_ROWS (48) rows; else
    64-row tiles at two."""
    steps, cols = k // 64, o // 64
    if b <= 48:
        return {"body": "stream", "rows": 16, "cols": 64,
                "split": cluster_split(cols * -(-b // 16), steps, FP8_STREAM16_BLOCKS_PER_SM)}
    return {"body": "stream", "rows": 64, "cols": 64,
            "split": cluster_split(cols * -(-b // 64), steps, BLOCKS_PER_SM)}


def _gather_rule(b, ke, o, n):
    """K9 int8's tile and split: 16-row tiles split at three blocks an SM at
    every row count, n in {1, 2}; n = 4 the shared body."""
    if n not in (1, 2):
        return {"body": "shared", "rows": _build.block_rows(b), "cols": 64, "split": 1}
    tiles = o // 64 * -(-b // 16)
    return {"body": "stream", "rows": 16, "cols": 64,
            "split": cluster_split(tiles, ke * n // 4 // 64, FP8_STREAM16_BLOCKS_PER_SM)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_tile_int8_dual_plan(arch, b):
    """The s8 dense DUAL stream at every row count, the rule's tile and
    split (up to 16 rows tile_gemm_int8's)."""
    k, o = _gate_up(arch)
    assert INT8_DENSE_DUAL_STREAM16_MAX_ROWS == 48
    p = tile_dual_plan(b, k, o)
    assert p == _tile_rule(b, k, o), p
    if b <= 16:
        assert p == tile_int8_plan(b, k, o)
    _split_ok(p["split"], k // 64)
    _assert_spans(k, p["split"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_gather_int8_dual_plan(arch, b):
    """n in {1, 2}: the rule's tile and split, K9 fp8's plan wherever that
    streams (up to 396 16-row tiles); n = 4 the shared body at
    block_rows(b), split 1."""
    ke, o = _gate_up(arch)
    for n in (1, 2, 4):
        p = gather_dual_plan(b, ke, o, n)
        assert p == _gather_rule(b, ke, o, n), (n, p)
        if n == 4:
            continue
        fp8 = gather_fp8_dual_plan(b, ke, o, n)
        if fp8["body"] == "stream":
            assert p == fp8
        else:
            assert o // 64 * -(-b // 16) > FP8_STREAM16_BLOCKS_PER_SM * SMS
        _split_ok(p["split"], ke * n // 4 // 64)
        _assert_spans(ke * n // 4, p["split"])


def test_int8_dual_plans_at_the_measured_shapes():
    """internlm2-1.8b's gate-up (2048, 8192) at B = 8: 128 16-row tiles,
    split 2, both duals (K9 at either n); at 64 rows the dense dual's 64-row
    tiles split 2, K9's 16-row tiles unsplit (where K9 fp8 takes its shared
    body).  qwen3-moe's expert (4096, 1536) at B = 8: 24 tiles, split 8,
    both duals; at 48 rows the dense dual's 72 16-row tiles split 4, at 64
    its 24 64-row tiles split 8."""
    s16 = {"body": "stream", "rows": 16, "cols": 64}
    assert tile_dual_plan(8, 2048, 8192) == {**s16, "split": 2}
    assert tile_dual_plan(8, 4096, 1536) == {**s16, "split": 8}
    assert tile_dual_plan(48, 4096, 1536) == {**s16, "split": 4}
    assert tile_dual_plan(64, 4096, 1536) == {**s16, "rows": 64, "split": 8}
    assert tile_dual_plan(64, 2048, 8192) == {**s16, "rows": 64, "split": 2}
    for n in (1, 2):
        assert gather_dual_plan(8, 2048, 8192, n) == {**s16, "split": 2}
        assert gather_dual_plan(8, 4096, 1536, n) == {**s16, "split": 8}
        assert gather_dual_plan(64, 2048, 8192, n) == {**s16, "split": 1}
        assert gather_fp8_dual_plan(64, 2048, 8192, n)["body"] == "shared"


@pytest.mark.parametrize("k", [192, 320, 1152, 2048, 4096, 8192])
@pytest.mark.parametrize("b", [1, 8, 16, 33, 64, 256, 1024])
def test_split_spans_are_whole_steps_covering_k(k, b):
    for o in (64, 1536, 8192):
        _assert_spans(k, tile_dual_plan(b, k, o)["split"])
        for n in (1, 2):
            if (k * n // 4) % 64 == 0:
                _assert_spans(k * n // 4, gather_dual_plan(b, k, o, n)["split"])


# -------------------------------------------- what the wrappers hand their entries
@pytest.mark.parametrize("b", [1, 8, 17, 64, 65, 256])
def test_tile_gemm_dual_int8_launches_its_plan(rec, b):
    """vg_tile_gemm_dual_int8 gets (.., out_kind, bm, body, split, stream) =
    int8_dual_plan's for bf16, fp32 and the requantized codes."""
    for k, o in ((2048, 8192), (4096, 1536), (1152, 6912)):
        xq, wg, wu = _meta(b, k), _meta(k, o), _meta(k, o)
        xs, sg, su, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), (1, o), ()))
        p = tile_dual_plan(b, k, o)
        want = (p["rows"], BODY_CODES[p["body"]], p["split"])
        rec.calls.clear()
        tk.tile_gemm_dual_int8(xq, wg, wu, xs, sg, su, out_dtype=torch.bfloat16)
        tk.tile_gemm_dual_int8(xq, wg, wu, xs, sg, su)
        tk.tile_gemm_dual_int8_requant(xq, wg, wu, xs, sg, su, rq)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_tile_gemm_dual_int8"
            assert args[-4:-1] == want, (args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [0, 1, _build.OUT_REQUANT]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", [1, 8, 17, 64, 65, 256])
def test_gather_dual_int8_launches_its_plan(rec, b, n):
    """vg_nm_spmm_gather_dual_bk_int8 gets (.., out_kind, bm, body, split,
    stream) = int8_dual_plan's for bf16, fp32 and the requantized codes."""
    for ke, o in ((2048, 8192), (4096, 1536)):
        kc = ke * n // 4
        xq, vg, vu = _meta(b, ke), _meta(kc, o), _meta(kc, o)
        ig, iu = _meta(kc, dtype=torch.int32), _meta(kc, dtype=torch.int32)
        xs, sg, su, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), (1, o), ()))
        p = gather_dual_plan(b, ke, o, n)
        want = (p["rows"], BODY_CODES[p["body"]], p["split"])
        rec.calls.clear()
        gk.nm_spmm_gather_dual_bk_int8(xq, vg, ig, vu, iu, n, xs, sg, su,
                                       out_dtype=torch.bfloat16)
        gk.nm_spmm_gather_dual_bk_int8(xq, vg, ig, vu, iu, n, xs, sg, su)
        gk.nm_spmm_gather_dual_bk_int8_requant(xq, vg, ig, vu, iu, n, xs, sg, su, rq)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_nm_spmm_gather_dual_bk_int8"
            assert args[-4:-1] == want, (args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [0, 1, _build.OUT_REQUANT]


# ------------------------------------------------- shared memory a block
def _plan_rows(plan_of):
    """The row tiles a plan streams at over ROWS at both gate-ups."""
    rows = set()
    for arch in ARCHS:
        for b in ROWS:
            p = plan_of(b, *_gate_up(arch))
            if p["body"] == "stream":
                rows.add(p["rows"])
    return sorted(rows)


@pytest.mark.parametrize("g", [0, 1, 2])
def test_s8_dual_streams_fit_the_blocks_an_sm(g):
    """S8 DUAL keeps the e4m3 DUAL layout byte for byte (its two int32
    partial planes and inbox take the fp32 ones' bytes): at each row tile
    the plans stream at, three 16-row blocks an SM (the splits'
    FP8_STREAM16_BLOCKS_PER_SM; the dense ~45 KB, the gathered ~54 KB at 2:4
    and ~62 KB at 1:4), two 64-row dense ones (cluster_split's default)."""
    if g == 0:
        rows = _plan_rows(tile_dual_plan)
        sizes = {bm: _dense_dual_stream_smem(bm) for bm in rows}
    else:
        rows = _plan_rows(lambda b, k, o: gather_dual_plan(b, k, o, g))
        assert rows == [16]           # K9's stream has 16-row tiles only
        sizes = {16: _fp8_gather_dual_smem(g)}
    for bm, total in sizes.items():
        per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else 2
        assert total <= SMEM_LIMIT
        assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (g, bm, total)


# --------------------------------------------- the s8 dense DUAL stream, emulated
def _dual_flush_i8(acc_g, acc_u, xs, sg, su, ws_first):
    """DualFlushI8T: t = float(acc) * xs * ws (WS_FIRST: float(acc) * ws *
    xs), one fp32 rounding each, on both sums, then silu(t_g) * t_u."""
    def deq(acc, ws):
        a, b = (ws, xs) if ws_first else (xs, ws)
        return ((acc.astype(np.float32) * a).astype(np.float32) * b).astype(np.float32)
    return (_silu(deq(acc_g, sg)) * deq(acc_u, su)).astype(np.float32)


def _int8_dense(rng, k, o):
    from repro_torch.core.quantize import quantize_linear
    leaf = quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)}, torch.int8)
    return leaf["w"].numpy(), leaf["scale"].reshape(1, -1).numpy()


def _hold_to_jax(got, j_dual, args, kw):
    """bf16 / fp32 within 1e-6 of JAX's dual (scaled), the requantized codes
    JAX's but one step on at most 0.1% (some saturate)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    want = np.asarray(j_dual(*args, out_dtype=jnp.float32, **kw))
    assert_scaled_close(got, want, 1e-6)
    want16 = np.asarray(j_dual(*args, out_dtype=jnp.bfloat16, **kw)).astype(np.float32)
    assert_scaled_close(torch.from_numpy(got).bfloat16().float().numpy(), want16, 1e-6)
    rq = np.float32(np.abs(want).max() / 300)
    want_q = np.asarray(j_dual(*args, epilogue=JSpec(act="silu_mul", requant="int8"),
                               requant_scale=jnp.asarray(rq), **kw))
    codes = _i8_codes(got, rq)
    assert want_q.dtype == np.int8 and (np.abs(codes) == 127).any()
    delta = np.abs(codes.astype(np.int32) - want_q.astype(np.int32))
    assert delta.max() <= 1 and (delta == 1).mean() <= 1e-3


@pytest.mark.parametrize("k,o", [(320, 128), (448, 64)])
def test_s8_dense_dual_stream_reproduces_pallas(k, o):
    """B = 8, K = 320 / 448 (five / seven 64-deep steps) at int8_dual_plan's
    split of 4 (uneven spans): each weight's emulated int32 sums (the A
    registers checked against the m16n8k32 fragment) are JAX's raw
    tile_gemm_int8 on that weight bit for bit (and the unsplit stream's);
    DualFlushI8T<false>'s bf16 / fp32 output is within 1e-6 of JAX's int8
    tile_gemm_dual (interpret), its codes JAX's but one step on <= 0.1%."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.tile_gemm.kernel import tile_gemm_dual as j_dual
    from repro.kernels.tile_gemm.kernel import tile_gemm_int8 as j_tile
    rng = np.random.default_rng(k + o)
    b = 8
    p = tile_dual_plan(b, k, o)
    assert p == {"body": "stream", "rows": 16, "cols": 64, "split": 4} and (k // 64) % 4
    xq, xs = _int8_rows(rng, b, k)
    (wg, sg), (wu, su) = _int8_dense(rng, k, o), _int8_dense(rng, k, o)
    jx = jnp.asarray(xq.numpy())
    accs = []
    for w in (wg, wu):
        steps = _s8_dense_steps(xq.numpy(), w)
        acc = _rank_sums(steps, p["split"])
        assert np.array_equal(acc, _rank_sums(steps, 1))
        raw = np.asarray(j_tile(jx, jnp.asarray(w), interpret=True))
        assert raw.dtype == np.int32 and np.array_equal(acc, raw)
        accs.append(acc)
    got = _dual_flush_i8(*accs, xs.numpy(), sg, su, ws_first=False)
    args = [jx] + [jnp.asarray(a) for a in (wg, wu, xs.numpy(), sg, su)]
    _hold_to_jax(got, j_dual, args, dict(acc_dtype=jnp.int32, interpret=True))


# --------------------------------------------- the s8 gathered DUAL stream, emulated
@pytest.mark.parametrize("n", [1, 2])
def test_s8_gathered_dual_stream_reproduces_pallas(n):
    """B = 8, K_c = 320 (five steps) at int8_dual_plan's split of 4 (uneven
    spans), O = 128, an index of each weight outside [0, 4): the select-twice
    pass gives each weight's plain gather with +0 there; each weight's
    emulated int32 sums are the int64 product of its gathered X and values
    (the masked product) bit for bit; DualFlushI8T<true> (t = float(acc) *
    ws * xs) is within 1e-6 of JAX's int8 nm_spmm_gather_dual_bk
    (interpret), its codes JAX's but one step on at most 0.1%."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_dual_bk as j_dual
    rng = np.random.default_rng(210 + n)
    b, kc, o = 8, 320, 128
    ke = kc * 4 // n
    p = gather_dual_plan(b, ke, o, n)
    assert p == {"body": "stream", "rows": 16, "cols": 64, "split": 4} and (kc // 64) % 4
    xq, xs = _int8_rows(rng, b, ke)
    weights = []
    for t in range(2):
        idx = _gather_idx(rng, kc, n)
        idx[7 + t], idx[kc - 3 - t] = (5, -2) if t else (-1, 4)   # outside [0, 4): +0
        weights.append((*_int8_dense(rng, kc, o), idx))
    xb = xq.numpy().view(np.uint8)
    sels = _dual_select_e4m3(xb, weights[0][2], weights[1][2], n)
    accs = []
    for sel, (v, _, idx) in zip(sels, weights):
        ok = (idx >= 0) & (idx < 4)
        cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
        xg = np.where(ok, xq.numpy()[:, cols], 0).astype(np.int8)
        assert np.array_equal(sel.view(np.int8), xg)
        xi, vi = xg.astype(np.int64), v.astype(np.int64)
        steps = [xi[:, 64 * s:64 * s + 32] @ vi[64 * s:64 * s + 32]
                 + xi[:, 64 * s + 32:64 * s + 64] @ vi[64 * s + 32:64 * s + 64]
                 for s in range(kc // 64)]
        acc = _rank_sums(steps, p["split"])
        assert np.array_equal(acc, xi @ vi)
        accs.append(acc)
    (vg, sg, ig), (vu, su, iu) = weights
    got = _dual_flush_i8(*accs, xs.numpy(), sg, su, ws_first=True)
    args = (jnp.asarray(xq.numpy()), jnp.asarray(vg), jnp.asarray(ig.reshape(-1, 1)),
            jnp.asarray(vu), jnp.asarray(iu.reshape(-1, 1)), n, jnp.asarray(xs.numpy()),
            jnp.asarray(sg), jnp.asarray(su))
    _hold_to_jax(got, j_dual, args,
                 dict(acc_dtype=jnp.int32, block_ke=256 // n, interpret=True))


# ----------------------------------------------------------- on the card
def _dense_case(dev, b, k, o, seed=0):
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = []
    for _ in range(2):
        lf = quantize_linear({"w": torch.randn(k, o, generator=g, device=dev) * k ** -0.5},
                             torch.int8)
        ws.append((lf["w"], lf["scale"].reshape(1, -1)))
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0                                  # an idle slot
    xq, xs = quantize_rows(x, torch.int8)
    (wg, sg), (wu, su) = ws
    return xq, wg, wu, xs, sg, su


def _gather_case(dev, b, ke, o, n, seed=0):
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = []
    for _ in range(2):
        w = torch.randn(ke, o, generator=g, device=dev) * ke ** -0.5
        lf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                            quantize=torch.int8)
        ws.append((lf["values"], lf["gather_idx"], lf["scale"].reshape(1, -1)))
    x = torch.randn(b, ke, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0
    xq, xs = quantize_rows(x, torch.int8)
    (vg, ig, sg), (vu, iu, su) = ws
    return xq, vg, ig, vu, iu, n, xs, sg, su


def _first(kernel, ptr_args, b, k, o, extra, out_dtype, rq):
    """Body 0 (gemm_int8.cu's first body) of ``vg_<kernel>`` at
    block_rows(b), split 1; ptr_args: its pointer operands up to rq, X
    first."""
    xq = ptr_args[0]
    y = torch.empty((b, o), dtype=torch.int8 if rq is not None else out_dtype,
                    device=xq.device)
    kind = _build.OUT_REQUANT if rq is not None else int(out_dtype == torch.float32)
    lib = _build.library("gemm_int8.cu")
    rc = getattr(lib, f"vg_{kernel}")(*(t.data_ptr() for t in ptr_args),
                                      None if rq is None else rq.data_ptr(), y.data_ptr(), b,
                                      k, o, *extra, kind, _build.block_rows(b), 0, 1,
                                      _build.stream_of(xq))
    _build.check(rc, kernel, lib)
    return y


def _hold_to_first_body(fn, fn_rq, first, ref, args):
    """bf16, fp32 and codes bitwise the first body and the same bits on a
    second launch; fp32 within 1e-2 of the plain version, the codes one step
    off it on at most 0.1%."""
    before = fn.launches
    y16 = fn(*args, out_dtype=torch.bfloat16)
    y32 = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    assert torch.equal(y32, again)
    assert torch.equal(y16, first(torch.bfloat16, None))
    assert torch.equal(y32, first(torch.float32, None))
    want = ref(*args)
    assert_scaled_close(y32, want, 1e-2)
    rq = (want.abs().amax() / 127).reshape(())
    codes = fn_rq(*args, rq)
    again = fn_rq(*args, rq)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int8 and torch.equal(codes, again)
    assert torch.equal(codes, first(None, rq))
    delta = (codes.int() - ref(*args, requant_scale=rq).int()).abs()
    assert delta.max().item() <= 1 and (delta == 1).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(2048, 8192), (4096, 1536), (320, 128)])
@pytest.mark.parametrize("b", [1, 8, 17, 33, 64, 65, 256])
def test_tile_gemm_dual_int8_bitwise_its_first_body_on_card(cuda_device, k, o, b):
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_quantized_ref as ref
    args = _dense_case(cuda_device, b, k, o, seed=b)
    _hold_to_first_body(
        tk.tile_gemm_dual_int8, tk.tile_gemm_dual_int8_requant,
        lambda dt, rq: _first("tile_gemm_dual_int8", args, b, k, o, (), dt, rq),
        ref, args)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ke,o", [(2048, 8192), (4096, 1536), (1280, 128)])
@pytest.mark.parametrize("b", [1, 8, 17, 33, 64, 256])
def test_gather_dual_int8_bitwise_its_first_body_on_card(cuda_device, n, ke, o, b):
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_dual_quantized_ref as ref
    args = _gather_case(cuda_device, b, ke, o, n, seed=b)
    xq, vg, ig, vu, iu, _, xs, sg, su = args
    _hold_to_first_body(
        gk.nm_spmm_gather_dual_bk_int8, gk.nm_spmm_gather_dual_bk_int8_requant,
        lambda dt, rq: _first("nm_spmm_gather_dual_bk_int8", (xq, vg, ig, vu, iu, xs, sg, su),
                              b, ke, o, (n,), dt, rq),
        ref, args)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_gather_dual_int8_index_outside_the_block_reads_zero_on_card(cuda_device, n):
    """An index outside [0, 4) selects +0 in the s8 gathered dual: bitwise
    the first body, which reads +0 there too."""
    xq, vg, ig, vu, iu, _, xs, sg, su = _gather_case(cuda_device, 8, 2048, 1024, n, seed=5)
    assert gather_dual_plan(8, 2048, 1024, n)["body"] == "stream"
    ig, iu = ig.clone(), iu.clone()
    ig[1], ig[-1], iu[70] = 9, -1, 4
    args = (xq, vg, ig, vu, iu, n, xs, sg, su)
    y = gk.nm_spmm_gather_dual_bk_int8(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, _first("nm_spmm_gather_dual_bk_int8",
                                 (xq, vg, ig, vu, iu, xs, sg, su), 8, 2048, 1024, (n,),
                                 torch.float32, None))


@pytest.mark.cuda
def test_refused_entries_raise_on_card(cuda_device):
    lib = _build.library("gemm_int8.cu")
    xq, wg, wu, xs, sg, su = _dense_case(cuda_device, 8, 256, 128)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    # (out_kind, bm, body, split): the s8 dense dual stream at bm 16 | 64, a
    # power of two up to min(8, K / 64) = 4; the first body split 1; no body
    # 2; never the raw accumulator
    for kind, bm, body, split in ((0, 16, 1, 3), (0, 16, 1, 8), (0, 32, 1, 1), (0, 16, 0, 2),
                                  (0, 16, 2, 1), (_build.OUT_RAW, 16, 1, 1),
                                  (_build.OUT_RAW, 16, 0, 1)):
        rc = lib.vg_tile_gemm_dual_int8(xq.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                        xs.data_ptr(), sg.data_ptr(), su.data_ptr(), None,
                                        y.data_ptr(), 8, 256, 128, kind, bm, body, split,
                                        _build.stream_of(xq))
        assert rc != 0, (kind, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm_dual_int8", lib)
    xq, vg, ig, vu, iu, _, xs, sg, su = _gather_case(cuda_device, 8, 512, 128, 2)
    # (n, out_kind, bm, body, split): K_eff 512 at 2:4 is K_c 256 (four
    # steps); the s8 gathered dual at n in {1, 2}, bm 16, split up to 4; the
    # first body split 1; never the raw accumulator
    for n, kind, bm, body, split in ((4, 0, 16, 1, 1), (2, 0, 64, 1, 1), (2, 0, 16, 1, 8),
                                     (2, 0, 16, 1, 3), (2, 0, 16, 0, 2), (2, 0, 16, 2, 1),
                                     (2, _build.OUT_RAW, 16, 1, 1),
                                     (2, _build.OUT_RAW, 16, 0, 1)):
        rc = lib.vg_nm_spmm_gather_dual_bk_int8(
            xq.data_ptr(), vg.data_ptr(), ig.data_ptr(), vu.data_ptr(), iu.data_ptr(),
            xs.data_ptr(), sg.data_ptr(), su.data_ptr(), None, y.data_ptr(), 8, 512, 128, n,
            kind, bm, body, split, _build.stream_of(xq))
        assert rc != 0, (n, kind, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_dual_bk_int8", lib)
    # the codes need rq, and only they take it
    rq = torch.ones((), device=cuda_device)
    for kind, r in ((_build.OUT_REQUANT, None), (0, rq)):
        rc = lib.vg_nm_spmm_gather_dual_bk_int8(
            xq.data_ptr(), vg.data_ptr(), ig.data_ptr(), vu.data_ptr(), iu.data_ptr(),
            xs.data_ptr(), sg.data_ptr(), su.data_ptr(), None if r is None else r.data_ptr(),
            y.data_ptr(), 8, 512, 128, 2, kind, 16, 1, 2, _build.stream_of(xq))
        assert rc != 0, kind
