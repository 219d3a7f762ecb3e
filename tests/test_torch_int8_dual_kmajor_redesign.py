"""The redesigned Hopper bodies of the int8 compressed gate-up dual
nm_spmm_dual_int8 (with nm_spmm_dual_int8_requant) at n in {1, 2} -- the s8
form of csrc/nm_spmm_sp_fp8.cuh's DUAL stream: both weights' values and meta
tiles a stage beside one X tile, each warp's byte transpose of both, one
mma.sp m16n8k64 s8 -> s32 a weight into two int32 accumulator sets, both
partial planes summed in rank order over a cluster's split, gemm_int8.cu's
DualFlushI8 -- and of K11 int8, nm_spmm_gather_int8 at n in {1, 2}: the s8
form of that header's K-major stream (the step's selected x_t rows landed
into swizzled slots, the byte transpose pass, two mma.sync m16n8k32 s8 ->
s32 a step, int32 partials, the ws-first flush into (O, B)).

On the CPU: ``nm_spmm/kernel.py::int8_dual_plan`` at the gate-up pairs and
``nm_spmm_gather/kernel.py::kmajor_int8_plan`` at the (1, 2) mesh's local
row-parallel sites of internlm2-1.8b, gemma3-1b and qwen3-moe, over a grid
of rows: splits powers of two up to min(8, steps), their spans covering K
(K_c); the (bm, body, split) each wrapper hands its C entry (a recording
stand-in, meta tensors) is its plan's; a block's shared memory for S8 DUAL
and S8 KM fits the blocks an SM the plans assume; a numpy emulation of the
s8 DUAL stream (each rank's int32 partials, summed in rank order, then
DualFlushI8's order) whose g and u sums are bitwise the JAX package's raw
``nm_spmm_int8`` on each weight, whose bf16 / fp32 output is within 1e-6 of
JAX's int8 ``nm_spmm_dual`` (Pallas, interpret mode) and whose requantized
codes are JAX's but one step on at most 0.1%; a numpy emulation of the s8
K-major stream bitwise JAX's ``nm_spmm_gather_int8`` (interpret), raw and
scaled, n in {1, 2}, an index outside [0, 4) reading +0 (the masked
product).  On the card (``cuda``): the entries refuse what they do not
take; the dual is bitwise its first body (bf16, fp32, codes) and K11 int8
bitwise its plain version (raw, scaled), the same bits on a second launch.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm import kernel as nk
from repro_torch.kernels.nm_spmm.kernel import fp8_dual_plan, int8_dual_plan
from repro_torch.kernels.nm_spmm_gather import kernel as gk
from repro_torch.kernels.nm_spmm_gather.kernel import (INT8_KMAJOR_STREAM16_MAX_STEPS,
                                                       KMAJOR_STREAM_MAX_ROWS, kmajor_int8_plan)
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  FP8_STREAM16_BLOCKS_PER_SM, cluster_split)
from test_torch_fp8_kmajor_dual_redesign import (_check_dense_fragments, _kmajor_stream_smem,
                                                 _kmajor_tile, _kmajor_transpose)
from test_torch_fp8_sparse_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans,
                                            _dual_stream_smem, _silu)
from test_torch_int8_stream_redesign import (_i8_codes, _i8_flush, _int8_weight, _meta,
                                             _s8_step_products, _s8_stream_acc,
                                             rec)  # noqa: F401
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

ARCHS = ["internlm2_1_8b", "gemma3_1b", "qwen3_moe_235b_a22b"]
DUAL_ROWS = [1, 8, 16, 17, 32, 33, 48, 49, 64, 65, 128, 255, 256]
K11_ROWS = [16, 32, 48, 64, 128, 256, 512, 1024]
MESH = 2


def _cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def _gate_up(arch):
    """The gate-up pair's (K, O): d_model x d_ff (qwen3-moe: an expert's)."""
    cfg = _cfg(arch)
    return cfg.d_model, cfg.d_ff


def _k11_sites(arch, n):
    """K11's two row-parallel sites on a (1, 2) mesh, wo and w_out's local
    (K_eff, O), where K_c = K_eff * n / 4 is a multiple of 64."""
    cfg = _cfg(arch)
    return [(k, cfg.d_model) for k in (cfg.attn_dim // MESH, cfg.d_ff // MESH)
            if (k * n // 4) % 64 == 0]


# ------------------------------------------------------------- the planners
def _dual_rule(b, k, o, n):
    """The s8 dual stream's tile and split: 16-row tiles up to 32 rows at
    2:4 and 48 at 1:4, split at two blocks an SM at 2:4 and three at 1:4;
    else 64-row tiles at two blocks an SM."""
    steps, cols = k // 64, o // 64
    if b <= {1: 48, 2: 32}[n]:
        per_sm = FP8_STREAM16_BLOCKS_PER_SM if n == 1 else BLOCKS_PER_SM
        return {"body": "sparse", "rows": 16, "cols": 64,
                "split": cluster_split(cols * -(-b // 16), steps, per_sm)}
    return {"body": "sparse", "rows": 64, "cols": 64,
            "split": cluster_split(cols * -(-b // 64), steps, BLOCKS_PER_SM)}


def _k11_rule(b, k, o, n):
    """K11 int8's tile and split: 16-row tiles split at three blocks an SM up
    to KMAJOR_STREAM_MAX_ROWS rows while a block walks at most
    INT8_KMAJOR_STREAM16_MAX_STEPS steps; else 64-row tiles at two."""
    steps, cols = k * n // 4 // 64, o // 64
    split16 = cluster_split(cols * -(-b // 16), steps, FP8_STREAM16_BLOCKS_PER_SM)
    if b <= KMAJOR_STREAM_MAX_ROWS and steps // split16 <= INT8_KMAJOR_STREAM16_MAX_STEPS:
        return {"body": "stream", "rows": 16, "cols": 64, "split": split16}
    return {"body": "stream", "rows": 64, "cols": 64,
            "split": cluster_split(cols * -(-b // 64), steps, BLOCKS_PER_SM)}


def _split_ok(split, steps):
    assert split & (split - 1) == 0 and 1 <= split <= min(8, steps), (split, steps)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", DUAL_ROWS)
def test_int8_dual_plan(arch, b):
    """n in {1, 2}: the s8 dual stream at every row count, the rule's tile
    and split (at decode rows at 2:4 the fp8 dual's); n = 4 the shared body
    at block_rows(b), split 1."""
    k, o = _gate_up(arch)
    for n in (1, 2):
        p = int8_dual_plan(b, k, o, n)
        assert p == _dual_rule(b, k, o, n), (n, p)
        if b <= 16 and n == 2:
            assert p == fp8_dual_plan(b, k, o, n)
        _split_ok(p["split"], k // 64)
        _assert_spans(k, p["split"])
    assert int8_dual_plan(b, k, o, 4) == {"body": "shared", "rows": _build.block_rows(b),
                                          "cols": 64, "split": 1}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", K11_ROWS)
def test_kmajor_int8_plan(arch, b):
    """n in {1, 2}: the s8 K-major stream at every row count, the rule's tile
    and split; n = 4 the shared body, split 1."""
    for n in (1, 2):
        for k, o in _k11_sites(arch, n):
            kc = k * n // 4
            p = kmajor_int8_plan(b, k, o, n)
            assert p == _k11_rule(b, k, o, n), (k, o, n, p)
            if p["rows"] == 16:
                assert kc // 64 // p["split"] <= INT8_KMAJOR_STREAM16_MAX_STEPS
            _split_ok(p["split"], kc // 64)
            _assert_spans(kc, p["split"])
    cfg = _cfg(arch)
    k = cfg.d_ff // MESH
    assert kmajor_int8_plan(b, k, cfg.d_model, 4) == {
        "body": "shared", "rows": _build.block_rows(b), "cols": 64, "split": 1}


def test_int8_plans_at_the_measured_shapes():
    """internlm2-1.8b's gate-up (2048, 8192) at B = 8: 128 16-row tiles,
    split 2; at 64 rows 64-row tiles, split 2.  qwen3-moe's expert (4096,
    1536) at B = 8: 24 16-row tiles, split 8; at 32 rows 48 tiles, split 4
    at 2:4 (two blocks an SM), 8 at 1:4 (three); at 64 rows 24 64-row tiles,
    split 8.  K11 int8 at internlm2-1.8b's local wo (1024, 2048) and w_out
    (4096, 2048) at B = 32: 2 x 32 tiles, split 4 at both n; w_out 2:4 at
    64 rows 64-row tiles split 8, wo 2:4 at 256 rows 16-row tiles unsplit."""
    s16 = {"body": "sparse", "rows": 16, "cols": 64}
    for n in (1, 2):
        assert int8_dual_plan(8, 2048, 8192, n) == {**s16, "split": 2}
        assert int8_dual_plan(8, 4096, 1536, n) == {**s16, "split": 8}
        assert int8_dual_plan(32, 4096, 1536, n) == {**s16, "split": 4 if n == 2 else 8}
        assert int8_dual_plan(64, 4096, 1536, n) == {**s16, "rows": 64, "split": 8}
        assert int8_dual_plan(64, 2048, 8192, n) == {**s16, "rows": 64, "split": 2}
        for k in (1024, 4096):
            assert kmajor_int8_plan(32, k, 2048, n) == {"body": "stream", "rows": 16,
                                                        "cols": 64, "split": 4}
    k64 = {"body": "stream", "rows": 64, "cols": 64}
    assert kmajor_int8_plan(64, 4096, 2048, 2) == {**k64, "split": 8}
    assert kmajor_int8_plan(256, 1024, 2048, 2) == {**k64, "rows": 16, "split": 1}
    assert kmajor_int8_plan(1024, 1024, 2048, 2) == {**k64, "split": 1}


@pytest.mark.parametrize("k", [192, 320, 1152, 1216, 2048, 4096, 8192])
@pytest.mark.parametrize("b", [1, 8, 16, 33, 64, 256, 1024])
def test_split_spans_are_whole_steps_covering_k(k, b):
    for o in (64, 1536, 2048, 8192):
        for n in (1, 2):
            _assert_spans(k, int8_dual_plan(b, k, o, n)["split"])
            if b % 16 == 0 and (k * n // 4) % 64 == 0:
                _assert_spans(k * n // 4, kmajor_int8_plan(b, k, o, n)["split"])


# -------------------------------------------- what the wrappers hand their entries
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", [1, 8, 17, 64, 65, 256])
def test_nm_spmm_dual_int8_launches_its_plan(rec, b, n):
    """vg_nm_spmm_dual_int8 gets (.., out_kind, bm, body, split, stream) =
    int8_dual_plan's for bf16, fp32 and the requantized codes."""
    for k, o in ((2048, 8192), (4096, 1536), (1152, 6912)):
        kc = k * n // 4
        xq = _meta(b, k)
        vg, vu = _meta(kc, o), _meta(kc, o)
        mg, mu = (_meta(kc // 4, o, dtype=torch.uint8) for _ in range(2))
        xs, sg, su, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), (1, o), ()))
        p = int8_dual_plan(b, k, o, n)
        want = (p["rows"], int(p["body"] == "sparse"), p["split"])
        rec.calls.clear()
        nk.nm_spmm_dual_int8(xq, vg, mg, vu, mu, n, xs, sg, su, out_dtype=torch.bfloat16)
        nk.nm_spmm_dual_int8(xq, vg, mg, vu, mu, n, xs, sg, su)
        nk.nm_spmm_dual_int8_requant(xq, vg, mg, vu, mu, n, xs, sg, su, rq)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_nm_spmm_dual_int8"
            assert args[-4:-1] == want, (args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [0, 1, _build.OUT_REQUANT]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", [16, 32, 256, 1024])
def test_nm_spmm_gather_int8_launches_its_plan(rec, b, n):
    """vg_nm_spmm_gather_int8 gets (.., out_kind, bm, body, split, stream) =
    kmajor_int8_plan's, raw and scaled."""
    for k, o in ((1024, 2048), (4096, 2048)):
        kc = k * n // 4
        x_t, values = _meta(k, b), _meta(kc, o)
        idx = _meta(kc, dtype=torch.int32)
        xs, ws = torch.empty((1, b), device="meta"), torch.empty((o, 1), device="meta")
        p = kmajor_int8_plan(b, k, o, n)
        want = (p["rows"], BODY_CODES[p["body"]], p["split"])
        rec.calls.clear()
        gk.nm_spmm_gather_int8(x_t, values, idx, None, None, n)
        gk.nm_spmm_gather_int8(x_t, values, idx, xs, ws, n, out_dtype=torch.bfloat16)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_nm_spmm_gather_int8"
            assert args[-4:-1] == want, (args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [_build.OUT_RAW, 0]


# ------------------------------------------------- shared memory a block
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_s8_dual_stream_fits_the_blocks_an_sm(n, bm):
    """The s8 DUAL stream keeps the e4m3 dual's layout byte for byte (its two
    int32 partial planes and inbox take the fp32 ones' bytes): three 16-row
    blocks an SM (FP8_STREAM16_BLOCKS_PER_SM, ~58 KB a block at 2:4), two
    64-row ones (BLOCKS_PER_SM, ~88 KB)."""
    total = _dual_stream_smem(n, bm)
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    assert total <= SMEM_LIMIT
    assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (n, bm, total)


@pytest.mark.parametrize("bm", [16, 64])
def test_s8_kmajor_stream_fits_the_blocks_an_sm(bm):
    """K11 int8's stream is K11 fp8's byte for byte; the largest block the
    plan launches at the local sites (the span's indices at its fewest
    splits) leaves room for three 16-row blocks an SM, two 64-row ones."""
    worst = 0
    for arch in ARCHS:
        for n in (1, 2):
            for k, o in _k11_sites(arch, n):
                for b in K11_ROWS:
                    p = kmajor_int8_plan(b, k, o, n)
                    if p["rows"] == bm:
                        worst = max(worst, _kmajor_stream_smem(bm, k * n // 4, p["split"]))
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    assert 0 < worst <= SMEM_LIMIT
    assert per_sm * (worst + BLOCK_RESERVED) <= SM_SMEM, (bm, worst)


# --------------------------------------------- the s8 DUAL stream, emulated
def _dual_flush_i8(acc_g, acc_u, xs, sg, su):
    """DualFlushI8: t = float(acc) * xs * ws (one fp32 rounding each), on
    both sums, then silu(t_g) * t_u in fp32."""
    t_g = _i8_flush(acc_g, xs, sg, np.float32(0))
    t_u = _i8_flush(acc_u, xs, su, np.float32(0))
    return (_silu(t_g) * t_u).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2])
def test_s8_dual_stream_reproduces_pallas(n):
    """B = 16, K = 320 (five 64-deep steps), O = 128 at int8_dual_plan's
    split of 4 (uneven spans): each weight's emulated int32 sums are JAX's
    raw nm_spmm_int8 on that weight bit for bit (and the unsplit stream's);
    DualFlushI8's bf16 / fp32 output is within 1e-6 of JAX's int8
    nm_spmm_dual (interpret), its requantized codes JAX's but one step on at
    most 0.1% of them (some saturate)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    from repro.kernels.nm_spmm.kernel import nm_spmm_dual as j_dual
    from repro.kernels.nm_spmm.kernel import nm_spmm_int8 as j_nm

    from repro_torch.core.quantize import quantize_rows
    rng = np.random.default_rng(190 + n)
    b, k, o = 16, 320, 128
    p = int8_dual_plan(b, k, o, n)
    assert p == {"body": "sparse", "rows": 16, "cols": 64, "split": 4} and (k // 64) % 4
    g, u = _int8_weight(rng, k, o, n), _int8_weight(rng, k, o, n)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0                                   # an idle slot
    xq, xs = quantize_rows(torch.from_numpy(x), torch.int8)
    xqn, xsn = xq.numpy(), xs.numpy()
    accs = []
    jx = jnp.asarray(xqn)
    for lf in (g, u):
        steps = _s8_step_products(xqn, lf["values"].numpy(), lf["meta_packed"].numpy(), n)
        acc = _s8_stream_acc(steps, p["split"])
        assert np.array_equal(acc, _s8_stream_acc(steps, 1))
        raw = np.asarray(j_nm(jx, jnp.asarray(lf["values"].numpy()),
                              jnp.asarray(lf["meta_packed"].numpy()), None, None, n,
                              interpret=True))
        assert raw.dtype == np.int32 and np.array_equal(acc, raw)
        accs.append(acc)
    sg, su = (lf["scale"].reshape(1, -1).numpy() for lf in (g, u))
    got = _dual_flush_i8(*accs, xsn, sg, su)
    args = [jx] + [jnp.asarray(lf[key].numpy()) for lf in (g, u)
                   for key in ("values", "meta_packed")]
    jscales = (n, jnp.asarray(xsn), jnp.asarray(sg), jnp.asarray(su))
    want = np.asarray(j_dual(*args, *jscales, acc_dtype=jnp.int32, out_dtype=jnp.float32,
                             interpret=True))
    assert_scaled_close(got, want, 1e-6)
    want16 = np.asarray(j_dual(*args, *jscales, acc_dtype=jnp.int32, out_dtype=jnp.bfloat16,
                               interpret=True)).astype(np.float32)
    got16 = torch.from_numpy(got).bfloat16().float().numpy()
    assert_scaled_close(got16, want16, 1e-6)
    rq = np.float32(np.abs(want).max() / 300)    # saturates a share of the codes
    want_q = np.asarray(j_dual(*args, *jscales, acc_dtype=jnp.int32, interpret=True,
                               epilogue=JSpec(act="silu_mul", requant="int8"),
                               requant_scale=jnp.asarray(rq)))
    codes = _i8_codes(got, rq)
    assert want_q.dtype == np.int8 and (np.abs(codes) == 127).any()
    delta = np.abs(codes.astype(np.int32) - want_q.astype(np.int32))
    assert delta.max() <= 1 and (delta == 1).mean() <= 1e-3


# --------------------------------------------- the s8 K-major stream, emulated
def _s8_kmajor_acc(xtb, idx, vq, n, bm, split):
    """K11 int8's stream sums, (B, O) int32: per row tile, block r of the
    split walks its span of 64-deep steps (the landed [64][bm] tile, the
    transpose pass, checked against the plain gather; the A operand read
    from the landed values tile as the dense stream reads it; the step's two
    k32 halves exact into int32), the blocks' int32 partials added in rank
    order."""
    ke, b = xtb.shape
    kc, o = vq.shape
    steps = kc // 64
    vi = vq.astype(np.int64)
    ok = (idx >= 0) & (idx < 4)
    cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
    plain = np.where(ok[:, None], xtb[cols], 0).astype(np.uint8)     # (kc, b)
    for s in range(steps):
        for n0 in range(0, o, 64):
            _check_dense_fragments(vq[64 * s:64 * s + 64, n0:n0 + 64].view(np.uint8))
    out = np.zeros((b, o), np.int64)
    for m0 in range(0, b, bm):
        acc = None
        for r in range(split):
            part = np.zeros((bm, o), np.int64)
            for s in range(r * steps // split, (r + 1) * steps // split):
                xg = _kmajor_transpose(_kmajor_tile(xtb, idx, n, s, m0, bm, b), bm)
                live = min(bm, b - m0)
                assert np.array_equal(xg[:live], plain[64 * s:64 * s + 64, m0:m0 + live].T)
                xi = xg.view(np.int8).astype(np.int64)
                part += (xi[:, :32] @ vi[64 * s:64 * s + 32]
                         + xi[:, 32:] @ vi[64 * s + 32:64 * s + 64])
            acc = part if acc is None else acc + part
        out[m0:m0 + bm] = acc[:min(bm, b - m0)]
    assert np.abs(out).max() < 2 ** 31
    return out.astype(np.int32)


@pytest.mark.parametrize("n", [1, 2])
def test_s8_kmajor_stage_reproduces_pallas_bitwise(n):
    """B = 48 (three 16-row tiles), K_c = 320 (five steps) at the plan's split
    of 4 (uneven spans), indices outside [0, 4) in three rows: the emulated
    load, transpose pass and int32 sums are the masked product and JAX's raw
    nm_spmm_gather_int8 (interpret) bit for bit in (O, B); the ws-first flush
    is JAX's scaled fp32 output bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_int8 as j_k11

    from repro_torch.core.quantize import quantize_linear, quantize_rows
    rng = np.random.default_rng(200 + n)
    b, kc, o = 48, 320, 64
    ke = kc * 4 // n
    p = kmajor_int8_plan(b, ke, o, n)
    assert p == {"body": "stream", "rows": 16, "cols": 64, "split": 4}
    idx = np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                  -1).reshape(-1).astype(np.int32)
    idx[3], idx[kc // 2 + 5], idx[kc - 2] = 7, -1, 4       # outside [0, 4): read +0
    x = rng.standard_normal((b, ke)).astype(np.float32)
    x[-1] = 0.0
    xq, xs = quantize_rows(torch.from_numpy(x), torch.int8)
    leaf = quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)}, torch.int8)
    vq, ws = leaf["w"].numpy(), leaf["scale"].reshape(-1, 1).numpy()
    xt = xq.numpy().T.copy()                               # x_t (K_eff, B)
    acc = _s8_kmajor_acc(xt.view(np.uint8), idx, vq, n, p["rows"], p["split"])
    ok = (idx >= 0) & (idx < 4)
    rows = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
    masked = (xt[rows].astype(np.int64) * ok[:, None]).T @ vq.astype(np.int64)
    assert np.array_equal(acc, masked)
    acc_t = acc.T                                          # the (O, B) store
    jargs = (jnp.asarray(xt), jnp.asarray(vq), jnp.asarray(idx.reshape(-1, 1)))
    raw = np.asarray(j_k11(*jargs, None, None, n, block_ke=ke, interpret=True))
    assert raw.dtype == np.int32 and np.array_equal(acc_t, raw)
    xs_t = xs.numpy().reshape(1, -1)
    got = ((acc_t.astype(np.float32) * ws).astype(np.float32) * xs_t).astype(np.float32)
    want = np.asarray(j_k11(*jargs, jnp.asarray(xs_t), jnp.asarray(ws), n, block_ke=ke,
                            out_dtype=jnp.float32, interpret=True))
    assert np.array_equal(got, want)


# ----------------------------------------------------------- on the card
def _dual_case(dev, b, k, o, n, seed=0):
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = []
    for _ in range(2):
        w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
        c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
        lf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)},
                             torch.int8)
        ws.append((lf["values"], lf["meta_packed"], lf["scale"].reshape(1, -1)))
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0                                  # an idle slot
    xq, xs = quantize_rows(x, torch.int8)
    (vg, mg, sg), (vu, mu, su) = ws
    return xq, vg, mg, vu, mu, n, xs, sg, su


def _first_dual(args, out_dtype, rq=None):
    """The int8 dual's first body (gemm_int8.cu, body 0, split 1) at
    block_rows(b)."""
    xq, vg, mg, vu, mu, n, xs, sg, su = args
    b, k = xq.shape
    o = vg.shape[1]
    y = torch.empty((b, o), dtype=torch.int8 if rq is not None else out_dtype,
                    device=xq.device)
    kind = _build.OUT_REQUANT if rq is not None else int(out_dtype == torch.float32)
    lib = _build.library("gemm_int8.cu")
    rc = lib.vg_nm_spmm_dual_int8(xq.data_ptr(), vg.data_ptr(), mg.data_ptr(), vu.data_ptr(),
                                  mu.data_ptr(), xs.data_ptr(), sg.data_ptr(), su.data_ptr(),
                                  None if rq is None else rq.data_ptr(), y.data_ptr(), b, k, o,
                                  n, kind, _build.block_rows(b), 0, 1, _build.stream_of(xq))
    _build.check(rc, "nm_spmm_dual_int8", lib)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(2048, 8192), (4096, 1536), (320, 128)])
@pytest.mark.parametrize("b", [1, 8, 17, 33, 64, 256])
def test_dual_int8_bitwise_its_first_body_on_card(cuda_device, n, k, o, b):
    """bf16, fp32 and requantized codes bitwise the first body, within 1e-2
    of the plain version (codes one step off on at most 0.1%), the same bits
    on a second launch."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_quantized_ref
    args = _dual_case(cuda_device, b, k, o, n, seed=b)
    before = nk.nm_spmm_dual_int8.launches
    y16 = nk.nm_spmm_dual_int8(*args, out_dtype=torch.bfloat16)
    y32 = nk.nm_spmm_dual_int8(*args)
    again = nk.nm_spmm_dual_int8(*args)
    torch.cuda.synchronize()
    assert nk.nm_spmm_dual_int8.launches == before + 3
    assert torch.equal(y32, again)
    assert torch.equal(y16, _first_dual(args, torch.bfloat16))
    assert torch.equal(y32, _first_dual(args, torch.float32))
    want = nm_spmm_dual_quantized_ref(*args)
    assert_scaled_close(y32, want, 1e-2)
    rq = (want.abs().amax() / 127).reshape(())
    codes = nk.nm_spmm_dual_int8_requant(*args, rq)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int8
    assert torch.equal(codes, _first_dual(args, None, rq))
    delta = (codes.int() - nm_spmm_dual_quantized_ref(*args, requant_scale=rq).int()).abs()
    assert delta.max().item() <= 1 and (delta == 1).float().mean().item() <= 1e-3


def _k11_case(dev, b, k, o, n, seed=0):
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                          quantize=torch.int8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    xq, xs = quantize_rows(x, torch.int8)
    return (xq.t().contiguous(), leaf["values"], leaf["gather_idx"], xs.reshape(1, -1),
            leaf["scale"].reshape(-1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(1024, 2048), (4096, 2048), (1280, 64), (4352, 512)])
@pytest.mark.parametrize("b", [16, 32, 256, 1024])
def test_kmajor_int8_bitwise_on_card(cuda_device, n, k, o, b):
    """Raw and scaled (bf16, fp32) bitwise the plain version, the same bits
    on a second launch; (1280, 64) and (4352, 512) split K_c unevenly."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_t_quantized_ref as ref
    if (k * n // 4) % 64:
        pytest.skip(f"K_c = {k * n // 4} is not a multiple of 64 at n = {n}")
    x_t, v, idx, xs, ws = _k11_case(cuda_device, b, k, o, n, seed=b)
    raw = gk.nm_spmm_gather_int8(x_t, v, idx, None, None, n)
    again = gk.nm_spmm_gather_int8(x_t, v, idx, None, None, n)
    y32 = gk.nm_spmm_gather_int8(x_t, v, idx, xs, ws, n)
    y16 = gk.nm_spmm_gather_int8(x_t, v, idx, xs, ws, n, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert raw.shape == (o, b) and raw.dtype == torch.int32
    assert torch.equal(raw, again)
    assert torch.equal(raw, ref(x_t, v, idx, None, None, n))
    assert torch.equal(y32, ref(x_t, v, idx, xs, ws, n))
    assert torch.equal(y16, ref(x_t, v, idx, xs, ws, n, out_dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [32, 256])
def test_kmajor_int8_index_outside_the_block_reads_zero_on_card(cuda_device, n, b):
    """An index outside [0, 4) loads +0 rows in the s8 K-major stream: the
    raw accumulator is the plain product on the zeroed rows, bit for bit."""
    x_t, v, idx, xs, ws = _k11_case(cuda_device, b, 2048, 1024, n, seed=3)
    assert kmajor_int8_plan(b, 2048, 1024, n)["body"] == "stream"
    idx = idx.clone()
    idx[1], idx[70], idx[-1] = 9, -1, 4
    got = gk.nm_spmm_gather_int8(x_t, v, idx, None, None, n)
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < 4)
    rows = torch.arange(idx.numel(), device=cuda_device) // n * 4 + idx.clamp(0, 3).long()
    want = ((x_t.long()[rows] * ok[:, None]).t().cpu() @ v.long().cpu()).t()
    assert torch.equal(got.long().cpu(), want)


@pytest.mark.cuda
def test_refused_entries_raise_on_card(cuda_device):
    lib = _build.library("gemm_int8.cu")
    xq, vg, mg, vu, mu, n, xs, sg, su = _dual_case(cuda_device, 8, 256, 128, 2)
    rq = torch.ones((), device=cuda_device)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    # (n, out_kind, bm, body, split): the s8 dual stream at n in {1, 2}, bm 16
    # | 64, a power of two up to min(8, K / 64) = 4, bf16 / fp32 / codes; the
    # first body split 1; no body 2; never the raw accumulator
    for nn, kind, bm, body, split in ((4, 0, 16, 1, 1), (2, 0, 16, 1, 3), (2, 0, 16, 1, 8),
                                      (2, 0, 32, 1, 1), (2, 0, 16, 0, 2), (2, 0, 16, 2, 1),
                                      (2, _build.OUT_RAW, 16, 1, 1),
                                      (2, _build.OUT_RAW, 16, 0, 1)):
        rc = lib.vg_nm_spmm_dual_int8(xq.data_ptr(), vg.data_ptr(), mg.data_ptr(),
                                      vu.data_ptr(), mu.data_ptr(), xs.data_ptr(),
                                      sg.data_ptr(), su.data_ptr(), None, y.data_ptr(), 8, 256,
                                      128, nn, kind, bm, body, split, _build.stream_of(xq))
        assert rc != 0, (nn, kind, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_dual_int8", lib)
    # the codes need rq, and only they take it
    for kind, r in ((_build.OUT_REQUANT, None), (0, rq)):
        rc = lib.vg_nm_spmm_dual_int8(xq.data_ptr(), vg.data_ptr(), mg.data_ptr(),
                                      vu.data_ptr(), mu.data_ptr(), xs.data_ptr(),
                                      sg.data_ptr(), su.data_ptr(),
                                      None if r is None else r.data_ptr(), y.data_ptr(), 8, 256,
                                      128, 2, kind, 16, 1, 2, _build.stream_of(xq))
        assert rc != 0, kind
    x_t, v, idx, xs_t, ws_t = _k11_case(cuda_device, 32, 512, 64, 2)
    y_t = torch.empty((64, 32), dtype=torch.int32, device=cuda_device)
    # (n, out_kind, bm, body, split, b): the s8 K-major stream at n in {1, 2},
    # bm 16 | 64, b a multiple of 16, K_c = 256 (four steps): split up to 4;
    # the first body split 1; never the requantized codes
    for nn, kind, bm, body, split, b in ((4, 2, 16, 1, 1, 32), (2, 2, 16, 1, 8, 32),
                                         (2, 2, 16, 1, 3, 32), (2, 2, 32, 1, 1, 32),
                                         (2, 2, 16, 0, 2, 32), (2, 2, 16, 2, 1, 32),
                                         (2, 2, 16, 1, 1, 24),
                                         (2, _build.OUT_REQUANT, 16, 1, 1, 32),
                                         (2, _build.OUT_REQUANT, 16, 0, 1, 32)):
        rc = lib.vg_nm_spmm_gather_int8(x_t.data_ptr(), v.data_ptr(), idx.data_ptr(), None,
                                        None, y_t.data_ptr(), b, 512, 64, nn, kind, bm, body,
                                        split, _build.stream_of(x_t))
        assert rc != 0, (nn, kind, bm, body, split, b)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_int8", lib)
