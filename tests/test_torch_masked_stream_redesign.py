"""The redesigned Hopper bodies of the fp8 masked nm_spmm_masked_fp8 at n in
{1, 2} (nm_spmm_fp8's e4m3 sparse stream with MASKED: each block walks the
live steps of the span nm_spmm_fp8's split gives it; the shared body where
fp8_plan keeps nm_spmm_fp8's) and of the bf16 masked tile_gemm_masked below
256 rows (K1's dense stream with MASKED at K1's tile and split; the shared
body from 256 rows, where K1 runs its wgmma body).

On the CPU: the masked plans are their twins' (``tile_gemm/kernel.py::
masked_plan`` against ``plan``, ``nm_spmm/kernel.py::fp8_plan`` for both
e4m3 singles) at qwen3-moe's expert shapes, and each wrapper hands the C
entry its twin's row tile, body and split (a recording stand-in for the
library, meta tensors); the spans are whole 64-steps covering K; a block's
shared memory (with ``kmask.cuh``'s 128-byte bitmask) fits the blocks an
SM the plans assume; a numpy emulation of the masked e4m3 stream (the row
block's kmask row folded into ``kmask.cuh``'s bitmask, each rank walking
the live steps of its span, each warp's byte transpose and the operand
mma.sp reads, 64-deep partials from zero, the rank-order split sums,
``SingleFlush``'s order and the requantized store) is bitwise the unmasked
emulation at 0%, ~40% and 100% live, with rank 0's whole span dead and with
one rank live, and within 1e-6 (scaled) of JAX's ``nm_spmm_masked`` fp8
branch in interpret mode; the same for the dense bf16 stream against JAX's
``tile_gemm_masked``.  On the card (``cuda``): both kernels bitwise across
launches and bitwise their twins on the same masked X (bf16, fp32, the raw
accumulator and the requantized codes) at B in {1, 8, 33, 64}, at split
boundaries and with a dead row block flushing bias + act of zero; the
bf16 one from 256 rows on the shared body; refused plans raise."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm import kernel as nk
from repro_torch.kernels.nm_spmm.kernel import fp8_plan, split_k
from repro_torch.kernels.tile_gemm import kernel as tk
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  FP8_SHARED_TILES, FP8_STREAM16_BLOCKS_PER_SM,
                                                  WGMMA_MIN_ROWS, cluster_split, masked_plan,
                                                  plan, stream_plan)
from test_torch_fp8_sparse_redesign import _e4m3_f32, _j, _mma_sp_rows, _step_share, _warp_tile
from test_torch_nm_dual_masked_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT,
                                                _assert_spans, _bf16_bits, _emulate, _live_walk,
                                                _masked_x)
from test_torch_redesign import _spans
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

FP8 = torch.float8_e4m3fn
LIVE_BYTES = 128             # kmask.cuh's LiveSteps: MAX_K_STEPS / 32 words
MAX_K_STEPS = 1024
# qwen3-moe's expert shapes (K, O): w_out (the masked site) and the gate-up's
EXPERT = {"w_out": (1536, 4096), "gate_up": (4096, 1536)}
ROWS = [1, 8, 16, 17, 64, 255, 256]


def test_expert_shapes_are_the_config():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_moe_235b_a22b")
    assert EXPERT["w_out"] == (cfg.d_ff, cfg.d_model)
    assert EXPERT["gate_up"] == (cfg.d_model, cfg.d_ff)


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("b", ROWS)
def test_tile_gemm_masked_plan_is_k1s_below_wgmma_rows(b):
    """Below WGMMA_MIN_ROWS K1's stream plan, tile and split (w_out at
    decode: 64 tiles split 4; the gate-up shape 24 split 8); from it the
    shared body at block_rows(b), split 1 (K1 runs its wgmma body)."""
    for k, o in EXPERT.values():
        p, twin = masked_plan(b, k, o), plan(b, k, o)
        if b < WGMMA_MIN_ROWS:
            assert p == twin == stream_plan(b, k, o)
            assert p["body"] == "stream" and p["rows"] == _build.block_rows(b)
            _assert_spans(k, p["split"])
        else:
            assert twin["body"] == "wgmma"
            assert p == {"body": "shared", "rows": 64, "cols": 64, "split": 1}
    if b <= 16:
        assert masked_plan(b, *EXPERT["w_out"])["split"] == 4
        assert masked_plan(b, *EXPERT["gate_up"])["split"] == 8


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", ROWS)
def test_fp8_plan_at_the_expert_shapes(b, n):
    """The plan both e4m3 singles take: the sparse stream at decode rows and
    while the shared body's launch stays under FP8_SHARED_TILES (w_out: 64
    tiles from 17 rows, shared; the gate-up shape: 24 a row tile, sparse to
    64 rows), split by split_k; else shared, split 1."""
    for name, (k, o) in EXPERT.items():
        p = fp8_plan(b, k, o, n)
        tiles = (o // 64) * -(-b // _build.block_rows(b))
        if b <= 16 or tiles < FP8_SHARED_TILES:
            assert p == {"body": "sparse", "split": split_k(b, k, o, n)}, (name, p)
            _assert_spans(k, p["split"])
        else:
            assert p == {"body": "shared", "split": 1}, (name, p)
    assert fp8_plan(b, 1536, 4096, 4) == {"body": "shared", "split": 1}
    want = {1: "sparse", 8: "sparse", 16: "sparse", 17: "shared", 64: "shared", 255: "shared",
            256: "shared"}[b]
    assert fp8_plan(b, *EXPERT["w_out"], n)["body"] == want
    assert fp8_plan(b, *EXPERT["gate_up"], n)["body"] == ("sparse" if b <= 64 else "shared")


@pytest.mark.parametrize("k", [192, 320, 448, 1216, 1536, 4096])
@pytest.mark.parametrize("b", [1, 8, 33, 64, 100])
def test_masked_splits_are_whole_steps_covering_k(k, b):
    assert k // 64 <= MAX_K_STEPS
    for o in (64, 128, 1536, 4096):
        _assert_spans(k, masked_plan(b, k, o)["split"])
        for n in (1, 2):
            _assert_spans(k, fp8_plan(b, k, o, n)["split"])


class _Recorder:
    """A stand-in for a kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA path on meta tensors, the library recorded."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda *a, **kw: rec)
    monkeypatch.setattr(_build, "check_operands", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return rec


@pytest.mark.parametrize("b", ROWS)
def test_tile_gemm_masked_launches_k1s_tile_and_split(recorded, b):
    """vg_tile_gemm_masked's (.., act, bm, body, split, stream) against
    vg_tile_gemm's (.., act, out_f32, rows, cols, split, stream)."""
    for k, o in EXPERT.values():
        x = torch.empty(b, k, dtype=torch.bfloat16, device="meta")
        w = torch.empty(k, o, dtype=torch.bfloat16, device="meta")
        maps = torch.zeros(-(-b // _build.block_rows(b)), k // 64, dtype=torch.int32,
                           device="meta")
        recorded.calls.clear()
        tk.tile_gemm_masked(x, w, maps, maps)
        tk.tile_gemm(x, w)
        (name_m, m), (name_t, t) = recorded.calls
        assert (name_m, name_t) == ("vg_tile_gemm_masked", "vg_tile_gemm")
        bm, body, split = m[-4:-1]
        rows, _, twin_split = t[-4:-1]
        assert bm == _build.block_rows(b)
        if b < WGMMA_MIN_ROWS:
            assert (bm, body, split) == (rows, BODY_CODES["stream"], twin_split)
        else:
            assert (body, split) == (BODY_CODES["shared"], 1)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_nm_spmm_masked_fp8_launches_nm_spmm_fp8s_plan(recorded, b, n):
    """vg_nm_spmm_masked_fp8 gets nm_spmm_fp8's (out_kind, bm, body, split)
    in every form: bf16, fp32, the raw accumulator, the requantized codes."""
    for k, o in EXPERT.values():
        kc = k * n // 4
        xq = torch.empty(b, k, dtype=FP8, device="meta")
        values = torch.empty(kc, o, dtype=FP8, device="meta")
        meta = torch.empty(kc // 4, o, dtype=torch.uint8, device="meta")
        xs = torch.empty(b, 1, device="meta")
        ws = torch.empty(1, o, device="meta")
        rq = torch.empty((), device="meta")
        maps = torch.zeros(-(-b // _build.block_rows(b)), k // 64, dtype=torch.int32,
                           device="meta")
        p = fp8_plan(b, k, o, n)
        for scales, kw, twin in (
                ((xs, ws), {"out_dtype": torch.bfloat16}, nk.nm_spmm_fp8),
                ((xs, ws), {"out_dtype": torch.float32}, nk.nm_spmm_fp8),
                ((None, None), {}, nk.nm_spmm_fp8),
                ((xs, ws), {"requant_scale": rq}, None)):
            recorded.calls.clear()
            nk.nm_spmm_masked_fp8(xq, values, meta, maps, maps, n, *scales, **kw)
            if twin is None:
                nk.nm_spmm_fp8_requant(xq, values, meta, *scales, n, rq)
            else:
                twin(xq, values, meta, *scales, n, **kw)
            (name_m, m), (name_t, t) = recorded.calls
            assert (name_m, name_t) == ("vg_nm_spmm_masked_fp8", "vg_nm_spmm_fp8")
            assert m[-5:-1] == t[-5:-1], (kw, m[-5:-1], t[-5:-1])
            assert m[-3:-1] == (int(p["body"] == "sparse"), p["split"])


# ------------------------------------------------- shared memory a block
def _fp8_single_smem(n: int, bm: int) -> int:
    """nm_spmm_sp_fp8.cuh's Layout<n, bm> single: the ring of values (80-byte
    rows), meta and X tiles, one transposed A tile a warp's m16 tile, the
    inbox (dynamic shared memory)."""
    stages, mt = (6, 1) if bm == 16 else (4, 2)
    vrows = 16 * n
    stage = vrows * 80 + vrows // 4 * 64 + bm * 80
    ring = max(stages * stage, bm * 68 * 4)
    return ring + 4 * mt * 16 * 48 + bm * 64 * 4


def _dense_stream_smem(bm: int) -> int:
    """nm_spmm_sp.cuh's Layout<4, bm>: a 4-deep ring of the dense (64, 64)
    bf16 weight tile and the X tile (72-element pitches), the inbox."""
    stage = 64 * 72 * 2 + bm * 72 * 2
    return max(4 * stage, bm * 68 * 4) + bm * 64 * 4


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_masked_fp8_stream_fits_the_blocks_an_sm(n, bm):
    """The masked e4m3 single adds the 128-byte bitmask (static) to the
    single's layout: three 16-row blocks an SM (FP8_STREAM16_BLOCKS_PER_SM),
    two 64-row ones (split_k's BLOCKS_PER_SM)."""
    total = _fp8_single_smem(n, bm) + LIVE_BYTES
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    assert total <= SMEM_LIMIT
    assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (n, bm, total)
    if n == 2:      # 2:4: ~33 KB at 16 rows, ~54 KB at 64
        assert _fp8_single_smem(n, bm) == (33280 if bm == 16 else 55296)


@pytest.mark.parametrize("bm", [16, 64])
def test_masked_dense_stream_fits_two_blocks_an_sm(bm):
    """K1's stream over the dense bf16 weight with the bitmask: two blocks
    an SM at either tile (the plan puts one 64-row block an SM)."""
    total = _dense_stream_smem(bm) + LIVE_BYTES
    assert total <= SMEM_LIMIT
    assert BLOCKS_PER_SM * (total + BLOCK_RESERVED) <= SM_SMEM, (bm, total)
    assert _dense_stream_smem(bm) == (50176 if bm == 16 else 90112)


def test_expert_maps_fit_the_bitmask():
    for k, _ in EXPERT.values():
        assert k // 64 <= MAX_K_STEPS == LIVE_BYTES * 8


# --------------------------------------------- the masked e4m3 stream, emulated
def _step_operands(values: np.ndarray, meta: np.ndarray, n: int) -> list:
    """Each 64-deep step's dense e4m3 operand (64, O), fp64, as mma.sp
    multiplies it: every warp tile transposed from the landed values tile
    and spread by its metadata words."""
    o = values.shape[1]
    ops = []
    for s in range(values.shape[0] // (16 * n)):
        vs, ms = values[16 * n * s:16 * n * (s + 1)], meta[4 * n * s:4 * n * (s + 1)]
        dense = np.zeros((o, 64), np.uint8)
        for c in range(0, o, 16):
            dense[c:c + 16] = _mma_sp_rows(_warp_tile(vs, ms, c, n), ms, c, n)
        ops.append(_e4m3_f32(dense).astype(np.float64).T)
    return ops


def _fp8_stream(xf: np.ndarray, ops: list, split: int, walk) -> np.ndarray:
    """One row block's split sum: rank r's fp32 partial over walk(its span),
    each 64-deep product exact and rounded once (the tensor cores' 64
    products, promoted), the partials added in rank order."""
    total = None
    for lo, hi in _spans(64 * len(ops), split):
        part = np.zeros((xf.shape[0], ops[0].shape[1]), np.float32)
        for s in walk(lo, hi):
            part = (part + (xf[:, 64 * s:64 * s + 64] @ ops[s]).astype(np.float32)).astype(
                np.float32)
        total = part if total is None else (total + part).astype(np.float32)
    return total


def _fp8_emulate(xf, ops, kmask, bm, split, masked):
    rows = []
    for i in range(kmask.shape[0]):
        walk = _live_walk(kmask[i]) if masked else (lambda lo, hi: range(lo, hi))
        rows.append(_fp8_stream(xf[i * bm:(i + 1) * bm], ops, split, walk))
    return np.concatenate(rows)


def _silu(v: np.ndarray) -> np.ndarray:
    return (v / (np.float32(1) + np.exp(-v))).astype(np.float32)


def _single_flush(acc, xs, ws, bias):
    """SingleFlush: acc * xs * ws (one fp32 rounding each), + bias, silu."""
    v = ((acc * xs).astype(np.float32) * ws).astype(np.float32)
    return _silu((v + bias).astype(np.float32))


def _codes(v: np.ndarray, rq: np.float32) -> np.ndarray:
    """The requantized store: clip(v / rq, +-448), the RNE e4m3 cast."""
    q = np.clip((v / rq).astype(np.float32), -448, 448)
    return torch.from_numpy(q).to(FP8).view(torch.uint8).numpy()


def _fp8_weight(rng, k, o, n):
    """A compressed e4m3 weight as the port makes it (torch on the CPU):
    pruned and compressed, then quantized per channel."""
    from repro_torch.core import nm as tnm
    from repro_torch.core.quantize import quantize_linear

    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
    return quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)}, FP8)


def _fp8_rows(rng, b, k, live_rows, bm=16):
    """e4m3 rows of a masked X (row scales) and the maps over the codes."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels.actsparse import block_maps

    x, kmask = _masked_x(rng, b, k, bm, live_rows)
    xq, xs = quantize_rows(torch.from_numpy(x), FP8)
    kmap, kq = block_maps(xq, bm, 64)
    assert np.array_equal(kq.numpy() != 0, kmask != 0)
    return xq, xs, kmap, kq


def _fp8_cases(rng, steps):
    forty = sorted(rng.choice(steps, round(0.4 * steps), replace=False))
    return {"none": [[], []], "forty": [forty, sorted(rng.choice(steps, 7, replace=False))],
            "all": [range(steps), range(steps)], "rank0_dead": [range(2, steps), forty],
            "one_rank": [[9], range(10, 12)]}


@pytest.mark.parametrize("n", [1, 2])
def test_masked_fp8_walk_is_bitwise_the_unmasked_stream(n):
    """B = 32 over two 16-row blocks, K = 1024 (16 steps; the plan's split
    8: two steps a rank), O = 128: the walk visits exactly each span's live
    steps in order, and the sums, the flushed fp32 and the requantized codes
    are the unmasked stream's on the same masked rows, bit for bit, at 0%,
    ~40% and 100% live, with rank 0's span dead and with one rank live."""
    rng = np.random.default_rng(90 + n)
    b, k, o, bm = 32, 1024, 128, 16
    split = fp8_plan(16, k, o, n)["split"]
    assert fp8_plan(16, k, o, n) == {"body": "sparse", "split": 8} and split == 8
    leaf = _fp8_weight(rng, k, o, n)
    ops = _step_operands(leaf["values"].view(torch.uint8).numpy(), leaf["meta_packed"].numpy(),
                         n)
    ws, bias = leaf["scale"].reshape(1, -1).numpy(), np.float32(0.25)
    for name, live_rows in _fp8_cases(rng, k // 64).items():
        xq, xs, _, kmask = _fp8_rows(rng, b, k, live_rows)
        km = kmask.numpy()
        for i in range(km.shape[0]):
            walk = _live_walk(km[i])
            for lo, hi in _spans(k, split):
                assert walk(lo, hi) == [s for s in range(lo, hi) if km[i, s]], name
        xf = _e4m3_f32(xq.view(torch.uint8).numpy()).astype(np.float64)
        got = _fp8_emulate(xf, ops, km, bm, split, masked=True)
        full = _fp8_emulate(xf, ops, km, bm, split, masked=False)
        assert np.array_equal(got, full), name
        if name == "none":
            assert not got.any()
        flushed = _single_flush(got, xs.numpy(), ws, bias)
        assert np.array_equal(flushed, _single_flush(full, xs.numpy(), ws, bias))
        rq = np.float32(max(np.abs(flushed).max(), 1e-3) / 300)
        assert np.array_equal(_codes(flushed, rq), _codes(_single_flush(full, xs.numpy(), ws,
                                                                         bias), rq))


@pytest.mark.parametrize("n", [1, 2])
def test_masked_fp8_walk_matches_pallas(n):
    """The emulated masked e4m3 stream, SingleFlush with bias and silu in
    fp32, against JAX's nm_spmm_masked fp8 branch (interpret; maps at 16
    rows x 64 columns) within 1e-6, scaled, ~40% live with a dead rank span;
    its requantized codes one e4m3 step at most off JAX's on at most 0.1%."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import epilogue as jepi
    from repro.kernels.nm_spmm.kernel import nm_spmm_masked as j_masked

    rng = np.random.default_rng(100 + n)
    b, k, o, bm = 32, 1024, 128, 16
    split = fp8_plan(16, k, o, n)["split"]
    leaf = _fp8_weight(rng, k, o, n)
    xq, xs, kmap, kmask = _fp8_rows(rng, b, k, [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
    values, meta = leaf["values"], leaf["meta_packed"]
    ws = leaf["scale"].reshape(1, -1)
    ops = _step_operands(values.view(torch.uint8).numpy(), meta.numpy(), n)
    xf = _e4m3_f32(xq.view(torch.uint8).numpy()).astype(np.float64)
    acc = _fp8_emulate(xf, ops, kmask.numpy(), bm, split, masked=True)
    bias = rng.standard_normal(o).astype(np.float32)
    got = _single_flush(acc, xs.numpy(), ws.numpy(), bias)
    args = (_j(jnp, xq), _j(jnp, values), _j(jnp, meta), _j(jnp, kmap), _j(jnp, kmask), n,
            _j(jnp, xs), _j(jnp, ws))
    kw = dict(block_b=bm, block_o=128, block_ke=64, acc_dtype=jnp.float32, interpret=True,
              bias=jnp.asarray(bias))
    want = np.asarray(j_masked(*args, out_dtype=jnp.float32,
                               epilogue=jepi.EpilogueSpec(act="silu", bias=True), **kw))
    assert_scaled_close(got, want, 1e-6)
    rq = np.float32(np.abs(want).max() / 300)
    want_q = np.asarray(j_masked(*args, epilogue=jepi.EpilogueSpec(
        act="silu", bias=True, requant="float8_e4m3fn"), requant_scale=jnp.asarray(rq), **kw))
    assert _step_share(_codes(got, rq), want_q.view(np.uint8)) <= 1e-3


# ------------------------------------------- the masked dense bf16 stream, emulated
@pytest.mark.parametrize("share", ["none", "forty", "all", "rank0_dead", "one_rank"])
def test_masked_dense_walk_is_bitwise_the_unmasked_stream(share):
    """K1's stream over the dense bf16 weight at its plan's split (B = 16
    rows of K = 1024, O = 128: split 8) over two 16-row blocks: the walk's
    sums and the one bf16 cast are the unmasked stream's, bit for bit."""
    rng = np.random.default_rng(110)
    b, k, o, bm = 32, 1024, 128, 16
    split = stream_plan(16, k, o)["split"]
    assert masked_plan(16, k, o) == plan(16, k, o) and split == 8
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    w = w.bfloat16().float().numpy()
    x, kmask = _masked_x(rng, b, k, bm, _fp8_cases(rng, k // 64)[share])
    got = _emulate(x, w, kmask, bm, split, masked=True)
    full = _emulate(x, w, kmask, bm, split, masked=False)
    assert np.array_equal(got, full)
    assert np.array_equal(_bf16_bits(got), _bf16_bits(full))
    if share == "none":
        assert not got.any()


def test_masked_dense_walk_matches_pallas():
    """The emulated masked dense stream, bias and silu in fp32, against JAX's
    tile_gemm_masked (interpret; maps at 16 rows x 64 columns) within 1e-6,
    scaled, ~40% live with a dead rank span."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import actsparse as ja
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    from repro.kernels.tile_gemm.kernel import tile_gemm_masked as j_masked

    rng = np.random.default_rng(120)
    b, k, o, bm = 32, 1024, 128, 16
    split = masked_plan(16, k, o)["split"]
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    w = w.bfloat16().float().numpy()
    x, kmask = _masked_x(rng, b, k, bm, [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
    bias = rng.standard_normal(o).astype(np.float32)
    got = _silu((_emulate(x, w, kmask, bm, split, masked=True) + bias).astype(np.float32))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    kmap, jk = ja.block_maps(jx, bm, 64)
    assert np.array_equal(np.asarray(jk) != 0, kmask != 0)
    want = j_masked(jx, jnp.asarray(w).astype(jnp.bfloat16), kmap, jk, block_b=bm, block_o=128,
                    block_k=64, out_dtype=jnp.float32, interpret=True,
                    epilogue=JSpec(act="silu", bias=True), bias=jnp.asarray(bias))
    assert_scaled_close(got, np.asarray(want), 1e-6)


# ----------------------------------------------------------- on the card
def _live_mask(dev, b, k, share, g, dead_rank0_split=None):
    steps = k // 64
    live = torch.zeros(steps, dtype=torch.bool, device=dev)
    live[torch.randperm(steps, generator=g, device=dev)[:round(share * steps)]] = True
    if dead_rank0_split:                 # rank 0's whole span dead, the rest live
        live[:] = True
        live[:_spans(k, dead_rank0_split)[0][1]] = False
    return live.repeat_interleave(64)


def _dense_case(dev, b, k, o, share, seed=0, dead_rank0=False):
    from repro_torch.kernels.actsparse import block_maps
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    live = _live_mask(dev, b, k, share, g, masked_plan(b, k, o)["split"] if dead_rank0 else None)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16() * live.to(torch.bfloat16)
    return x, w, block_maps(x, _build.block_rows(b), 64)


def _fp8_case(dev, b, k, o, n, share, seed=0, dead_rank0=False, dead_from=None):
    """Masked e4m3 rows (rows from ``dead_from`` all zero), the compressed
    e4m3 weight's operands, both scales, the maps at block_rows(b)."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.kernels.actsparse import block_maps
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
    leaf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)}, FP8)
    live = _live_mask(dev, b, k, share, g, fp8_plan(b, k, o, n)["split"] if dead_rank0 else None)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16() * live.to(torch.bfloat16)
    if dead_from is not None:
        x[dead_from:] = 0
    xq, xs = quantize_rows(x, FP8)
    ws = leaf["scale"].reshape(1, -1)
    return (xq, (leaf["values"], leaf["meta_packed"]), xs, ws,
            block_maps(xq, _build.block_rows(b), 64))


CARD_SHARES = ((0.0, False), (0.4, False), (1.0, False), (1.0, True))
CARD_ROWS = [1, 8, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", list(EXPERT.values()))
@pytest.mark.parametrize("b", CARD_ROWS)
def test_tile_gemm_masked_bitwise_tile_gemm_on_card(cuda_device, b, k, o):
    """qwen3-moe's expert shapes at 0%, ~40% and 100% live and with rank 0's
    span dead, with and without bias + silu: bitwise tile_gemm (K1) on the
    same masked X and across launches, within 1e-2 of the plain version."""
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_masked_ref
    bias = torch.randn(o, generator=torch.Generator(device=cuda_device).manual_seed(1),
                       device=cuda_device)
    for share, dead in CARD_SHARES:
        x, w, maps = _dense_case(cuda_device, b, k, o, share, seed=b, dead_rank0=dead)
        for kw in ({}, {"epilogue": EpilogueSpec(act="silu", bias=True), "bias": bias}):
            before = tk.tile_gemm_masked.launches
            got = tk.tile_gemm_masked(x, w, *maps, **kw)
            again = tk.tile_gemm_masked(x, w, *maps, **kw)
            full = tk.tile_gemm(x, w, **kw)
            torch.cuda.synchronize()
            assert tk.tile_gemm_masked.launches == before + 2
            assert torch.equal(got, full), (share, dead, kw.keys())
            assert torch.equal(got, again)
            assert_scaled_close(got, tile_gemm_masked_ref(x, w, *maps,
                                                          block_b=_build.block_rows(b), **kw),
                                1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", list(EXPERT.values()))
def test_tile_gemm_masked_from_wgmma_rows_on_card(cuda_device, k, o):
    """256 rows: the shared body, bitwise itself with every tile live and
    within 1e-2 of K1's wgmma body."""
    x, w, maps = _dense_case(cuda_device, 256, k, o, 0.4, seed=3)
    assert masked_plan(256, k, o)["body"] == "shared"
    got = tk.tile_gemm_masked(x, w, *maps)
    same = tk.tile_gemm_masked(x, w, maps[0], torch.ones_like(maps[1]))
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    assert_scaled_close(got, tk.tile_gemm(x, w), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", list(EXPERT.values()))
@pytest.mark.parametrize("b", CARD_ROWS)
def test_nm_spmm_masked_fp8_bitwise_nm_spmm_fp8_on_card(cuda_device, b, k, o, n):
    """Bitwise nm_spmm_fp8 on the same masked rows in bf16, fp32 (with bias +
    silu) and the raw accumulator, its requantized codes bitwise
    nm_spmm_fp8_requant's, the same bits on a second launch, within 1e-2 of
    the plain version."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_masked_quantized_ref
    g = torch.Generator(device=cuda_device).manual_seed(2)
    bias = torch.randn(o, generator=g, device=cuda_device)
    silu = EpilogueSpec(act="silu", bias=True)
    for share, dead in CARD_SHARES:
        xq, ops, xs, ws, maps = _fp8_case(cuda_device, b, k, o, n, share, seed=b + n,
                                          dead_rank0=dead)
        for kw in ({"out_dtype": torch.bfloat16},
                   {"out_dtype": torch.float32, "epilogue": silu, "bias": bias}):
            got = nk.nm_spmm_masked_fp8(xq, *ops, *maps, n, xs, ws, **kw)
            again = nk.nm_spmm_masked_fp8(xq, *ops, *maps, n, xs, ws, **kw)
            full = nk.nm_spmm_fp8(xq, *ops, xs, ws, n, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, full), (share, dead, kw)
            assert torch.equal(got, again)
            assert_scaled_close(got, nm_spmm_masked_quantized_ref(
                xq, *ops, *maps, n, xs, ws, block_b=_build.block_rows(b), **kw), 1e-2)
        raw = nk.nm_spmm_masked_fp8(xq, *ops, *maps, n)
        assert torch.equal(raw, nk.nm_spmm_fp8(xq, *ops, None, None, n))
        rq = (full.abs().amax() / 300).reshape(())
        gelu = EpilogueSpec(act="gelu", bias=True)
        codes = nk.nm_spmm_masked_fp8(xq, *ops, *maps, n, xs, ws, epilogue=gelu, bias=bias,
                                      requant_scale=rq)
        want = nk.nm_spmm_fp8_requant(xq, *ops, xs, ws, n, rq, epilogue=gelu, bias=bias)
        torch.cuda.synchronize()
        assert codes.dtype == FP8
        assert torch.equal(codes.view(torch.uint8), want.view(torch.uint8)), (share, dead)


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(320, 64), (448, 128), (1216, 256)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_masked_streams_at_split_boundaries_on_card(cuda_device, b, k, o):
    """K = 64 x steps not divisible by the split: uneven spans; both kernels
    bitwise their twins at ~40% live."""
    x, w, maps = _dense_case(cuda_device, b, k, o, 0.4, seed=4)
    p = masked_plan(b, k, o)
    assert p["body"] == "stream" and p["split"] > 1 and (k // 64) % p["split"], p
    got = tk.tile_gemm_masked(x, w, *maps)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.tile_gemm(x, w))
    for n in (1, 2):
        xq, ops, xs, ws, qmaps = _fp8_case(cuda_device, b, k, o, n, 0.4, seed=5)
        p = fp8_plan(b, k, o, n)
        assert p["body"] == "sparse" and p["split"] > 1 and (k // 64) % p["split"], p
        got = nk.nm_spmm_masked_fp8(xq, *ops, *qmaps, n, xs, ws, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, nk.nm_spmm_fp8(xq, *ops, xs, ws, n, out_dtype=torch.bfloat16))


@pytest.mark.cuda
def test_dead_row_block_flushes_bias_and_act_on_card(cuda_device):
    """B = 80 over 64-row blocks at the gate-up shape (both kernels stream):
    block 1 (rows 64-79) all zero, so no step is live there; its rows are
    silu(0 + bias) (fp8: silu(0 * scales + bias)), the others the twin's."""
    from repro_torch.kernels.actsparse import block_maps
    k, o = EXPERT["gate_up"]
    g = torch.Generator(device=cuda_device).manual_seed(9)
    bias = torch.randn(o, generator=g, device=cuda_device)
    spec = EpilogueSpec(act="silu", bias=True)
    dead = torch.nn.functional.silu(bias).expand(16, o)
    x, w, _ = _dense_case(cuda_device, 80, k, o, 0.4, seed=9)
    x[64:] = 0
    maps = block_maps(x, 64, 64)
    assert not maps[1][1].any() and maps[1][0].any()
    assert masked_plan(80, k, o)["body"] == "stream"
    got = tk.tile_gemm_masked(x, w, *maps, epilogue=spec, bias=bias)
    full = tk.tile_gemm(x, w, epilogue=spec, bias=bias)
    torch.cuda.synchronize()
    assert torch.equal(got, full)
    assert_scaled_close(got[64:], dead.to(got.dtype), 1e-2)
    for n in (1, 2):
        xq, ops, xs, ws, qmaps = _fp8_case(cuda_device, 80, k, o, n, 0.4, seed=10, dead_from=64)
        assert not qmaps[1][1].any() and fp8_plan(80, k, o, n)["body"] == "sparse"
        got = nk.nm_spmm_masked_fp8(xq, *ops, *qmaps, n, xs, ws, epilogue=spec, bias=bias,
                                    out_dtype=torch.float32)
        full = nk.nm_spmm_fp8(xq, *ops, xs, ws, n, epilogue=spec, bias=bias,
                              out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, full)
        assert_scaled_close(got[64:], dead, 1e-6)


@pytest.mark.cuda
def test_refused_masked_plans_raise_on_card(cuda_device):
    x, w, (_, kmask) = _dense_case(cuda_device, 8, 256, 128, 0.5)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library()
    # (bm, body, split): the stream takes bm 16 | 64 and a power of two up to
    # min(8, K / 64) = 4; the shared body split 1; no body 2
    for bm, body, split in ((16, 1, 3), (16, 1, 8), (16, 1, 0), (32, 1, 1), (16, 0, 2),
                            (16, 2, 1)):
        rc = lib.vg_tile_gemm_masked(x.data_ptr(), w.data_ptr(), kmask.data_ptr(), None,
                                     y.data_ptr(), 8, 256, 128, 0, bm, body, split,
                                     _build.stream_of(x))
        assert rc != 0, (bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm_masked", lib)
    rc = lib.vg_tile_gemm_masked(x.data_ptr(), w.data_ptr(), None, None, y.data_ptr(), 8, 256,
                                 128, 0, 16, 1, 2, _build.stream_of(x))
    assert rc != 0
    xq, (values, meta), xs, ws, (_, qmask) = _fp8_case(cuda_device, 8, 256, 128, 2, 0.5)
    fp8 = _build.library("gemm_fp8.cu")
    # (n, body, split): the sparse stream at n in {1, 2} only, a power of two
    # up to 4; the shared body split 1
    for nn, body, split in ((4, 1, 1), (2, 1, 3), (2, 1, 8), (2, 0, 2), (2, 2, 1)):
        rc = fp8.vg_nm_spmm_masked_fp8(xq.data_ptr(), values.data_ptr(), meta.data_ptr(),
                                       qmask.data_ptr(), xs.data_ptr(), ws.data_ptr(), None,
                                       None, y.data_ptr(), 8, 256, 128, nn, 0, 0, 16, body,
                                       split, _build.stream_of(xq))
        assert rc != 0, (nn, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_masked_fp8", fp8)
