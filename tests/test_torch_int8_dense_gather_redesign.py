"""The redesigned Hopper bodies of tile_gemm_int8 (with tile_gemm_int8_requant)
and K8 int8, nm_spmm_gather_bk_int8 (with its _requant form), at n in {1, 2}:
the s8 forms of csrc/nm_spmm_sp_fp8.cuh's dense e4m3 stream (N = 4) and of
its gathered stream (G = n) -- the same stage, ldmatrix .trans + __byte_perm
A operand and select16 (+0 outside [0, 4)), two mma.sync m16n8k32 s8 -> s32
a step summed in place, int32 partials summed in rank order over a
cluster's split, gemm_int8.cu's flush (ws first for the gather).

On the CPU: ``tile_gemm/kernel.py::int8_plan`` and
``nm_spmm_gather/kernel.py::int8_plan`` at internlm2-1.8b's, gemma3-1b's and
qwen3-moe's shapes, their splits whole 64-steps covering K (K_c); the (bm,
body, split) each wrapper hands its C entry (a recording stand-in, meta
tensors) is its plan's (the masked dense int8 single's masked_int8_plan's;
the masked gather keeps the shared body's arguments); a block's shared
memory fits the blocks an SM the plans assume; numpy emulations of the s8 dense stream (the A registers as the dense e4m3
stream reads them, exact int32 partials over each rank's span summed in
rank order, gemm_int8.cu's flush and requantized store) and of the s8
gathered stream (the select pass, +0 outside [0, 4), the ws-first flush)
are bitwise the JAX package's ``tile_gemm_int8`` and int8
``nm_spmm_gather_bk`` (Pallas, interpret mode): raw, scaled and
requantized, n in {1, 2} for the gather; the probe's dense register
builder is the PTX m16n8k32 fragment map.  On the card (``cuda``): the
entries refuse what they do not take; the kernels are held to their plain
versions and first bodies by ``tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm_gather import kernel as gk
from repro_torch.kernels.nm_spmm_gather.kernel import fp8_plan as gather_fp8_plan
from repro_torch.kernels.nm_spmm_gather.kernel import int8_plan as gather_int8_plan
from repro_torch.kernels.tile_gemm import kernel as tk
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  FP8_STREAM16_BLOCKS_PER_SM,
                                                  INT8_STREAM16_MAX_STEPS, cluster_split,
                                                  stream_plan)
from repro_torch.kernels.tile_gemm.kernel import int8_plan as tile_int8_plan
from test_torch_fp8_kmajor_dual_redesign import _check_dense_fragments
from test_torch_fp8_sparse_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans,
                                            _gather_stream_smem, _stream_select)
from test_torch_int8_stream_redesign import (_dense_e4m3_smem, _i8_codes, _i8_flush, _meta,
                                             _sites, rec)  # noqa: F401
from test_torch_redesign import _spans
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

ARCHS = ["internlm2_1_8b", "gemma3_1b", "qwen3_moe_235b_a22b"]
ROWS = [1, 8, 16, 17, 33, 64, 65, 128, 255, 256, 1024, 4000]


def _gather_sites(arch, n):
    """(K_eff, O) of each single site whose K_c = K_eff * n / 4 the kernels
    take (a multiple of 64)."""
    return [(k, o) for k, o in _sites(arch) if (k * n // 4) % 64 == 0]


# ------------------------------------------------------------- the planners
def _int8_rule(b, k, o):
    """The s8 streams' tile and split: 16-row tiles (split at three blocks an
    SM) up to 16 rows, and up to 64 while a block walks at most
    INT8_STREAM16_MAX_STEPS steps; else 64-row tiles at two blocks an SM."""
    steps, cols = k // 64, o // 64
    split16 = cluster_split(cols * -(-b // 16), steps, FP8_STREAM16_BLOCKS_PER_SM)
    if b <= 16 or (b <= 64 and steps // split16 <= INT8_STREAM16_MAX_STEPS):
        return {"body": "stream", "rows": 16, "cols": 64, "split": split16}
    return {"body": "stream", "rows": 64, "cols": 64,
            "split": cluster_split(cols * -(-b // 64), steps, BLOCKS_PER_SM)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_tile_int8_plan(arch, b):
    """The s8 dense stream at every row count (it beat the first body at
    every swept shape), the rule's tile and split; at decode rows
    stream_plan's; splits whole steps covering K."""
    for k, o in _sites(arch):
        p = tile_int8_plan(b, k, o)
        assert p == _int8_rule(b, k, o), (k, o, p)
        if b <= 16:
            assert p == stream_plan(b, k, o)
        _assert_spans(k, p["split"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_gather_int8_plan(arch, b):
    """n in {1, 2}: tile_gemm_int8's plan over K_c (at decode rows K8 fp8's
    requantizing 16-row stream); n = 4 the shared body at block_rows(b),
    split 1."""
    for n in (1, 2):
        for k, o in _gather_sites(arch, n):
            kc = k * n // 4
            p = gather_int8_plan(b, k, o, n)
            assert p == tile_int8_plan(b, kc, o) == _int8_rule(b, kc, o), (k, o, n, p)
            if b <= 16:
                assert p == gather_fp8_plan(b, k, o, n, requant=True)
            _assert_spans(kc, p["split"])
    for k, o in _sites(arch):
        assert gather_int8_plan(b, k, o, 4) == {"body": "shared", "rows": _build.block_rows(b),
                                                "cols": 64, "split": 1}


def test_int8_plans_at_the_measured_shapes():
    """internlm2-1.8b at B = 8: tile_gemm_int8's w_out (8192, 2048) and q / o
    (2048, 2048) 32 tiles split 8, k / v 16 tiles split 8; K8 int8 at 2:4
    and 1:4 split 8 too.  At 64 rows w_out takes 64-row tiles (a 16-row
    block would walk 64 steps; 32 at K8 int8's 2:4) split 8, gemma3-1b's
    w_in 16-row tiles (18 steps), and 64-row tiles split at two blocks an
    SM from 65 rows: w_out at 256 rows split 2, at 4,000 split 1."""
    for k, o in ((8192, 2048), (2048, 2048), (2048, 1024)):
        assert tile_int8_plan(8, k, o) == {"body": "stream", "rows": 16, "cols": 64,
                                           "split": 8}
        for n in (1, 2):
            assert gather_int8_plan(8, k, o, n) == {"body": "stream", "rows": 16, "cols": 64,
                                                    "split": 8}
    w64 = {"body": "stream", "rows": 64, "cols": 64, "split": 8}
    assert tile_int8_plan(64, 8192, 2048) == gather_int8_plan(64, 8192, 2048, 2) == w64
    assert tile_int8_plan(64, 1152, 6912)["rows"] == 16
    assert gather_int8_plan(64, 8192, 2048, 1)["rows"] == 16
    assert tile_int8_plan(256, 8192, 2048) == {**w64, "split": 2}
    assert tile_int8_plan(4000, 8192, 2048) == {**w64, "split": 1}


# -------------------------------------------- what the wrappers hand their entries
@pytest.mark.parametrize("b", [1, 8, 17, 64, 65, 256, 1024])
def test_tile_gemm_int8_launches_its_plan(rec, b):
    """vg_tile_gemm_int8 gets (.., out_kind, bm, body, split, stream) =
    int8_plan's for bf16, fp32, the raw accumulator and the requantized
    codes; vg_tile_gemm_masked_int8 gets masked_int8_plan's (.., bm, body,
    split, stream), bm the maps' row block."""
    for k, o in ((2048, 2048), (8192, 2048), (1152, 6912)):
        xq, w = _meta(b, k), _meta(k, o)
        xs, ws, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), ()))
        p = tile_int8_plan(b, k, o)
        want = (p["rows"], BODY_CODES[p["body"]], p["split"])
        rec.calls.clear()
        tk.tile_gemm_int8(xq, w, xs, ws, out_dtype=torch.bfloat16)
        tk.tile_gemm_int8(xq, w, xs, ws, out_dtype=torch.float32)
        tk.tile_gemm_int8(xq, w)
        tk.tile_gemm_int8_requant(xq, w, xs, ws, rq)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_tile_gemm_int8"
            assert args[-4:-1] == want, (args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [0, 1, _build.OUT_RAW, _build.OUT_REQUANT]
        maps = torch.zeros(-(-b // _build.block_rows(b)), k // 64, dtype=torch.int32,
                           device="meta")
        rec.calls.clear()
        tk.tile_gemm_masked_int8(xq, w, maps, maps, xs, ws)
        (name, args), = rec.calls
        p = tk.masked_int8_plan(b, k, o)
        assert p["rows"] == _build.block_rows(b)
        assert name == "vg_tile_gemm_masked_int8"
        assert args[-4:-1] == (p["rows"], BODY_CODES[p["body"]], p["split"])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", [1, 8, 17, 64, 65, 256, 4000])
def test_gather_int8_launches_its_plan(rec, b, n):
    """vg_nm_spmm_gather_bk_int8 gets (.., out_kind, bm, body, split,
    stream) = int8_plan's (bm 16 past 16 rows where it runs the 16-row
    stream), for the scaled outputs, the raw accumulator and the codes; the
    masked int8 gather gets (.., out_kind, bm, body, split, stream) =
    masked_int8_plan's, bm the maps' row block."""
    for k, o in ((2048, 2048), (8192, 2048), (1280, 5120)):
        kc = k * n // 4
        xq, values = _meta(b, k), _meta(kc, o)
        idx = _meta(kc, dtype=torch.int32)
        xs, ws, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), ()))
        p = gather_int8_plan(b, k, o, n)
        want = (p["rows"], BODY_CODES[p["body"]], p["split"])
        rec.calls.clear()
        gk.nm_spmm_gather_bk_int8(xq, values, idx, xs, ws, n, out_dtype=torch.bfloat16)
        gk.nm_spmm_gather_bk_int8(xq, values, idx, None, None, n)
        gk.nm_spmm_gather_bk_int8_requant(xq, values, idx, xs, ws, n, rq)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_nm_spmm_gather_bk_int8"
            assert args[-4:-1] == want, (args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [0, _build.OUT_RAW, _build.OUT_REQUANT]
        maps = torch.zeros(-(-b // _build.block_rows(b)), kc // 64, dtype=torch.int32,
                           device="meta")
        rec.calls.clear()
        gk.nm_spmm_gather_bk_masked_int8(xq, values, idx, maps, maps, n, xs, ws)
        (name, args), = rec.calls
        q = gk.masked_int8_plan(b, k, o, n)
        assert name == "vg_nm_spmm_gather_bk_masked_int8"
        assert q["rows"] == _build.block_rows(b)
        assert args[-4:-1] == (q["rows"], BODY_CODES[q["body"]], q["split"])


# ------------------------------------------------- shared memory a block
@pytest.mark.parametrize("bm", [16, 64])
def test_s8_dense_stream_fits_the_blocks_an_sm(bm):
    """tile_gemm_int8's stream keeps the e4m3 dense single's layout byte for
    byte (its int32 partial tile and inbox take the fp32 ones' bytes): the
    plan's three 16-row blocks an SM, two 64-row ones."""
    total = _dense_e4m3_smem(bm)
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    assert total <= SMEM_LIMIT
    assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (bm, total)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_s8_gather_stream_fits_the_blocks_an_sm(n, bm):
    """K8 int8's stream is K8 fp8's byte for byte: three 16-row blocks an SM
    (the plan's FP8_STREAM16_BLOCKS_PER_SM), two 64-row ones
    (BLOCKS_PER_SM; ~106 KB a block at 1:4)."""
    total = _gather_stream_smem(n, bm)
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    assert total <= SMEM_LIMIT
    assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (n, bm, total)


# --------------------------------------------- the s8 streams, emulated
def _s8_dense_steps(xq: np.ndarray, w: np.ndarray) -> list:
    """Each 64-deep step's exact int8 products (B, O) of the dense stream:
    each warp tile's A registers read from the landed tile (checked against
    mma m16n8k32's A fragment, the e4m3 stream's map), the two k32 halves
    into the same int32 registers."""
    xi, wi = xq.astype(np.int64), w.astype(np.int64)
    out = []
    for s in range(w.shape[0] // 64):
        for n0 in range(0, w.shape[1], 64):
            _check_dense_fragments(w[64 * s:64 * s + 64, n0:n0 + 64].view(np.uint8))
        lo = xi[:, 64 * s:64 * s + 32] @ wi[64 * s:64 * s + 32]
        hi = xi[:, 64 * s + 32:64 * s + 64] @ wi[64 * s + 32:64 * s + 64]
        out.append(lo + hi)
    return out


def _rank_sums(steps: list, split: int) -> np.ndarray:
    """Block r's steps summed in its int32 registers, the blocks' int32
    partials added in rank order (exact: no rounding)."""
    acc = None
    for lo, hi in _spans(64 * len(steps), split):
        part = sum(steps[lo:hi], np.zeros_like(steps[0]))
        acc = part if acc is None else acc + part
    assert np.abs(acc).max() < 2 ** 31
    return acc.astype(np.int32)


def _ws_first_flush(acc, xs, ws):
    """SingleFlushI8<true>: float(acc) * ws * xs, one fp32 rounding each."""
    return ((acc.astype(np.float32) * ws).astype(np.float32) * xs).astype(np.float32)


def _int8_rows(rng, b, k):
    from repro_torch.core.quantize import quantize_rows
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0                                   # an idle slot
    return quantize_rows(torch.from_numpy(x), torch.int8)


def test_s8_dense_stream_reproduces_pallas_bitwise():
    """B = 16, K = 1024, O = 128 at int8_plan's split (8: two steps a rank):
    the emulated s8 dense stream's int32 sums are JAX's tile_gemm_int8 raw
    accumulator (interpret) bit for bit and the same at split 1; its flush
    and requantized codes are JAX's scaled fp32 output and int8 codes bit
    for bit (some codes saturate).  With a bias JAX's compiled flush may
    fuse the scale multiply and the bias add: within 2e-6, scaled."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    from repro.kernels.tile_gemm.kernel import tile_gemm_int8 as j_tile

    from repro_torch.core.quantize import quantize_linear
    rng = np.random.default_rng(160)
    b, k, o = 16, 1024, 128
    p = tile_int8_plan(b, k, o)
    assert p == {"body": "stream", "rows": 16, "cols": 64, "split": 8}
    leaf = quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)}, torch.int8)
    xq, xs = _int8_rows(rng, b, k)
    w, ws = leaf["w"].numpy(), leaf["scale"].reshape(1, -1).numpy()
    steps = _s8_dense_steps(xq.numpy(), w)
    acc = _rank_sums(steps, p["split"])
    assert np.array_equal(acc, _rank_sums(steps, 1))
    jx, jw, jxs, jws = (jnp.asarray(a) for a in (xq.numpy(), w, xs.numpy(), ws))
    raw = np.asarray(j_tile(jx, jw, interpret=True))
    assert raw.dtype == np.int32 and np.array_equal(acc, raw)
    got = _i8_flush(acc, xs.numpy(), ws, np.zeros(o, np.float32))
    want = np.asarray(j_tile(jx, jw, jxs, jws, out_dtype=jnp.float32, interpret=True))
    assert np.array_equal(got, want)
    rq = np.float32(np.abs(want).max() / 300)
    want_q = np.asarray(j_tile(jx, jw, jxs, jws, epilogue=JSpec(requant="int8"),
                               requant_scale=jnp.asarray(rq), interpret=True))
    codes = _i8_codes(got, rq)
    assert want_q.dtype == np.int8 and np.array_equal(codes, want_q)
    assert (np.abs(codes) == 127).any()
    bias = rng.standard_normal(o).astype(np.float32)
    want = np.asarray(j_tile(jx, jw, jxs, jws, out_dtype=jnp.float32,
                             epilogue=JSpec(bias=True), bias=jnp.asarray(bias),
                             interpret=True))
    assert_scaled_close(_i8_flush(acc, xs.numpy(), ws, bias), want, 2e-6)


@pytest.mark.parametrize("n", [1, 2])
def test_s8_gathered_stream_reproduces_pallas_bitwise(n):
    """B = 16, K_eff = 1024, O = 128 at int8_plan's split (the 16-row
    stream, split 4 / 8 at 1:4 / 2:4), indices outside [0, 4) in three
    columns: the select pass gives the plain gather with +0 there, the
    emulated int32 sums are JAX's raw accumulator (the K-major
    nm_spmm_gather_int8, interpret) bit for bit, the ws-first flush and its
    requantized codes are JAX's int8 nm_spmm_gather_bk (acc_dtype int32)
    bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk as j_gather
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_int8 as j_kmajor

    from repro_torch.core.quantize import quantize_linear
    rng = np.random.default_rng(170 + n)
    b, ke, o = 16, 1024, 128
    kc = ke * n // 4
    p = gather_int8_plan(b, ke, o, n)
    assert p["body"] == "stream" and p["rows"] == 16 and p["split"] == (8 if n == 2 else 4)
    idx = np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                  -1).reshape(-1).astype(np.int32)
    idx[3], idx[kc // 2 + 5], idx[kc - 2] = 7, -1, 4     # outside [0, 4): read +0
    xq, xs = _int8_rows(rng, b, ke)
    leaf = quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)}, torch.int8)
    v, ws = leaf["w"].numpy(), leaf["scale"].reshape(1, -1).numpy()
    xg = _stream_select(xq.numpy().view(np.uint8), idx, n).view(np.int8)
    cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
    assert np.array_equal(xg, np.where((idx >= 0) & (idx < 4), xq.numpy()[:, cols], 0))
    xi, vi = xg.astype(np.int64), v.astype(np.int64)
    steps = [xi[:, 64 * s:64 * s + 32] @ vi[64 * s:64 * s + 32]
             + xi[:, 64 * s + 32:64 * s + 64] @ vi[64 * s + 32:64 * s + 64]
             for s in range(kc // 64)]
    acc = _rank_sums(steps, p["split"])
    jx, jv, ji = jnp.asarray(xq.numpy()), jnp.asarray(v), jnp.asarray(idx.reshape(-1, 1))
    raw = np.asarray(j_kmajor(jx.T, jv, ji, None, None, n, interpret=True)).T
    assert raw.dtype == np.int32 and np.array_equal(acc, raw)
    jxs, jws = jnp.asarray(xs.numpy()), jnp.asarray(ws)
    got = _ws_first_flush(acc, xs.numpy(), ws)
    want = np.asarray(j_gather(jx, jv, ji, n, jxs, jws, acc_dtype=jnp.int32,
                               out_dtype=jnp.float32, interpret=True))
    assert np.array_equal(got, want)
    rq = np.float32(np.abs(want).max() / 300)
    want_q = np.asarray(j_gather(jx, jv, ji, n, jxs, jws, acc_dtype=jnp.int32,
                                 epilogue=JSpec(requant="int8"), requant_scale=jnp.asarray(rq),
                                 interpret=True))
    codes = _i8_codes(got, rq)
    assert want_q.dtype == np.int8 and np.array_equal(codes, want_q)
    assert (np.abs(codes) == 127).any()


def test_probe_dense_registers_are_the_ptx_fragment_map():
    """kernels/mma_sp_probe.py builds the dense m16n8k32 forms' registers
    from one A (16, 32) and B (32, 8): read back by the PTX ISA's 8-bit
    m16n8k32 map (A register r of lane 4g + t: row g + 8 (r & 1), columns
    4t + 16 (r >> 1) .. + 3; B register r: K rows 4t + 16r .. + 3 of column
    g), they give A and B again, for e4m3 and s8 alike."""
    from repro_torch.kernels import mma_sp_probe as mp
    rng = np.random.default_rng(180)
    a = rng.integers(-3, 4, (16, 32)).astype(np.float32)
    bm = rng.integers(-3, 4, (32, 8)).astype(np.float32)
    for form in mp.DENSE_FORMS:
        ar, br = mp._a_regs(a, form), mp._b_regs(bm, form)
        bits_a, bits_b = mp._bits(a, form.dtype), mp._bits(bm, form.dtype)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for r in range(4):
                row, c0 = g + 8 * (r & 1), 4 * t + 16 * (r >> 1)
                assert ar[lane, r] == mp._pack(bits_a[row, c0:c0 + 4], 4)
            for r in range(2):
                assert br[lane, r] == mp._pack(bits_b[4 * t + 16 * r:4 * t + 16 * r + 4, g], 4)
            assert not br[lane, 2:].any()


# ----------------------------------------------------------- on the card
@pytest.mark.cuda
def test_refused_entries_raise_on_card(cuda_device):
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=cuda_device).manual_seed(0)
    leaf = quantize_linear({"w": torch.randn(256, 128, generator=g, device=cuda_device)},
                           torch.int8)
    xq, xs = quantize_rows(torch.randn(8, 256, generator=g, device=cuda_device).bfloat16(),
                           torch.int8)
    w, ws = leaf["w"], leaf["scale"].reshape(1, -1)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library("gemm_int8.cu")
    # (bm, body, split): the s8 stream bm 16 | 64, a power of two up to
    # min(8, K / 64) = 4; the first body split 1; no body 2
    for bm, body, split in ((16, 1, 3), (16, 1, 8), (32, 1, 1), (16, 0, 2), (16, 2, 1)):
        rc = lib.vg_tile_gemm_int8(xq.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                                   None, None, y.data_ptr(), 8, 256, 128, 0, 0, bm, body, split,
                                   _build.stream_of(xq))
        assert rc != 0, (bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm_int8", lib)
    # the raw accumulator takes no scales; the codes need rq
    for scales, kind, rq in (((xs, ws), _build.OUT_RAW, None), ((None, None), 0, None),
                             ((xs, ws), _build.OUT_REQUANT, None)):
        rc = lib.vg_tile_gemm_int8(xq.data_ptr(), w.data_ptr(),
                                   *(None if t is None else t.data_ptr() for t in scales),
                                   None, rq, y.data_ptr(), 8, 256, 128, 0, kind, 16, 1, 2,
                                   _build.stream_of(xq))
        assert rc != 0, kind
    # K8 int8: K_eff 256 at 2:4 is K_c 128 (two steps): split up to 2; the
    # s8 stream at n in {1, 2} only
    idx = torch.zeros(128, dtype=torch.int32, device=cuda_device)
    vals = w[:128].contiguous()
    for n, bm, body, split in ((2, 16, 1, 4), (4, 16, 1, 1), (2, 32, 1, 1), (2, 16, 0, 2),
                               (2, 16, 2, 1)):
        rc = lib.vg_nm_spmm_gather_bk_int8(xq.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                           xs.data_ptr(), ws.data_ptr(), None, None,
                                           y.data_ptr(), 8, 256, 128, n, 0, 0, bm, body, split,
                                           _build.stream_of(xq))
        assert rc != 0, (n, bm, body, split)


@pytest.mark.cuda
def test_dense_probe_pins_s8_as_e4m3_on_card(cuda_device):
    """The dense m16n8k32 forms on the card: s8's A, B and D maps are
    e4m3's (the registers the dense stream builds give the plain product),
    s8 also at full range."""
    from repro_torch.kernels.mma_sp_probe import probe
    found = probe(str(cuda_device))
    assert found["dense_e4m3"]["ok"] and found["dense_s8"]["ok"], found
