"""The redesigned Hopper bodies of nm_spmm_int8 (with nm_spmm_int8_requant)
at n in {1, 2} -- the s8 form of nm_spmm_fp8's sparse stream: the same
stage, per-warp byte transpose, 1:4-as-2:4 slots and metadata words,
mma.sp m16n8k64 s8 -> s32 summed in place, int32 partials summed in rank
order over a cluster's split, gemm_int8.cu's flush -- and of
tile_gemm_masked_fp8 (tile_gemm_fp8's dense e4m3 stream with MASKED, at
tile_gemm_fp8's tile and split).

On the CPU: ``nm_spmm/kernel.py::int8_plan`` (the stream at n in {1, 2}) and
``tile_gemm/kernel.py::masked_fp8_plan`` (fp8_plan's stream wherever it
streams) at internlm2-1.8b's, gemma3-1b's and qwen3-moe's shapes, their
splits whole 64-steps covering K; the (bm, body, split) each wrapper hands
its C entry (a recording stand-in, meta tensors) is its plan's, and the
masked one refuses maps at another row block; a block's shared memory fits
the blocks an SM the plans assume; a numpy emulation of the s8 stream
(each warp's transpose, the 1:4 +0 slots, the metadata words, exact int32
partials over each rank's span summed in rank order, gemm_int8.cu's flush
and requantized store) is bitwise the JAX package's ``nm_spmm_int8``
(Pallas, interpret mode): raw, scaled and requantized, n in {1, 2}; a
numpy emulation of the masked dense e4m3 walk is bitwise the unmasked
dense stream at none / ~40% / all live and with rank 0's span dead, and
within 1e-6 (scaled) of JAX's ``tile_gemm_masked`` fp8 (interpret).  On
the card (``cuda``): the entries refuse what they do not take; the two
kernels are held to their plain versions and twins by
``tests/test_torch_kernels.py``."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm import kernel as nk
from repro_torch.kernels.nm_spmm.kernel import fp8_plan, int8_plan, split_k
from repro_torch.kernels.tile_gemm import kernel as tk
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES, WGMMA_MIN_ROWS,
                                                  masked_fp8_plan)
from repro_torch.kernels.tile_gemm.kernel import fp8_plan as tile_fp8_plan
from test_torch_fp8_kmajor_dual_redesign import _check_dense_fragments
from test_torch_fp8_sparse_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans,
                                            _e4m3_f32, _j, _mma_sp_rows, _step_share, _warp_tile)
from test_torch_masked_stream_redesign import (LIVE_BYTES, _fp8_cases, _fp8_rows,
                                               _fp8_single_smem, _single_flush)
from test_torch_nm_dual_masked_redesign import _live_walk
from test_torch_redesign import _spans
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

FP8 = torch.float8_e4m3fn
ARCHS = ["internlm2_1_8b", "gemma3_1b", "qwen3_moe_235b_a22b"]
ROWS = [1, 8, 16, 17, 33, 64, 65, 128, 255, 256, 1024]


def _sites(arch):
    """(K, O) of each distinct single-GEMM site of a config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return list(dict.fromkeys([(cfg.d_model, cfg.attn_dim), (cfg.d_model, cfg.kv_dim),
                               (cfg.attn_dim, cfg.d_model), (cfg.d_ff, cfg.d_model),
                               (cfg.d_model, cfg.d_ff)]))


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_int8_plan_streams_at_every_row_count(arch, b):
    """The s8 stream at n in {1, 2} however wide the launch, over
    block_rows(b)-row tiles split by split_k; n = 4 the shared body, split
    1.  At decode rows that is fp8_plan's stream at the same split."""
    for k, o in _sites(arch):
        for n in (1, 2, 4):
            p = int8_plan(b, k, o, n)
            if n < 4:
                assert p == {"body": "sparse", "split": split_k(b, k, o, n)}, (k, o, n, p)
                _assert_spans(k, p["split"])
            else:
                assert p == {"body": "shared", "split": 1}, (k, o, n, p)
            if b <= 16:
                assert p == fp8_plan(b, k, o, n)


def test_int8_plan_at_the_measured_shapes():
    """internlm2-1.8b at B = 8: every site streams, w_out (8192, 2048) and
    the q / o sites (2048, 2048) 32 tiles split 8, k / v (2048, 1024) 16
    tiles split 8; at 64 rows split 8 too, at the calibration forward's 256
    (128 tiles) split 2 (k / v 4), at hubert-xlarge's 4,000 rows split 1.
    gemma3-1b's gelu w_in (1152, 6912) streams at a 64-row chunk (108
    tiles, split 2), where fp8_plan keeps e4m3 on the shared body."""
    for k, o in ((8192, 2048), (2048, 2048), (2048, 1024)):
        for n in (1, 2):
            assert int8_plan(8, k, o, n) == {"body": "sparse", "split": 8}
            assert int8_plan(64, k, o, n) == {"body": "sparse", "split": 8}
            assert int8_plan(256, k, o, n) == {"body": "sparse",
                                               "split": 2 if o == 2048 else 4}
            assert int8_plan(4000, k, o, n) == {"body": "sparse", "split": 1}
    assert int8_plan(8, 1152, 6912, 2) == {"body": "sparse", "split": 2}
    assert int8_plan(64, 1152, 6912, 2) == {"body": "sparse", "split": 2}
    assert fp8_plan(64, 1152, 6912, 2)["body"] == "shared"


@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("b", ROWS)
def test_masked_fp8_plan_is_tile_gemm_fp8s_stream(b, requant):
    """Wherever tile_gemm_fp8 streams, its tile and split; else the shared
    body at block_rows(b), split 1 (tile_gemm_fp8's wgmma rows and its
    64-row launches of FP8_SHARED_TILES tiles or more)."""
    for arch in ARCHS:
        for k, o in _sites(arch):
            p, twin = masked_fp8_plan(b, k, o, requant), tile_fp8_plan(b, k, o, requant)
            if twin["body"] == "stream":
                assert p == twin
                assert p["rows"] == _build.block_rows(b)
                _assert_spans(k, p["split"])
            else:
                assert p == {"body": "shared", "rows": _build.block_rows(b), "cols": 64,
                             "split": 1}
                assert twin["body"] == ("wgmma" if b >= WGMMA_MIN_ROWS and not requant
                                        else "shared")
    # qwen3-moe's expert w_out (1536, 4096) at decode: 64 tiles, split 4
    assert masked_fp8_plan(8, 1536, 4096) == {"body": "stream", "rows": 16, "cols": 64,
                                              "split": 4}
    assert masked_fp8_plan(64, 1536, 4096)["body"] == "shared"
    assert masked_fp8_plan(64, 4096, 1536)["body"] == "stream"


@pytest.mark.parametrize("k", [192, 320, 1216, 1536, 2048, 8192])
@pytest.mark.parametrize("b", [1, 8, 33, 64, 100])
def test_splits_are_whole_steps_covering_k(k, b):
    for o in (64, 1024, 2048, 4096):
        for n in (1, 2):
            _assert_spans(k, int8_plan(b, k, o, n)["split"])
        _assert_spans(k, masked_fp8_plan(b, k, o)["split"])


# -------------------------------------------- what the wrappers hand their entries
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
def rec(monkeypatch):
    """The wrappers' CUDA path on meta tensors, the library recorded."""
    r = _Recorder()
    monkeypatch.setattr(_build, "library", lambda *a, **kw: r)
    monkeypatch.setattr(_build, "check_operands", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return r


def _meta(*shape, dtype=torch.int8):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", [1, 8, 17, 64, 256])
def test_nm_spmm_int8_launches_its_plan(rec, b, n):
    """vg_nm_spmm_int8 gets (.., out_kind, bm, body, split, stream): bm =
    block_rows(b), body and split int8_plan's, for bf16, fp32, the raw
    accumulator and the requantized codes; vg_nm_spmm_masked_int8 the same
    (.., bm, body, split, stream), its maps' row block being bm."""
    for k, o in ((2048, 2048), (8192, 2048), (1152, 6912)):
        kc = k * n // 4
        xq, values = _meta(b, k), _meta(kc, o)
        meta = _meta(kc // 4, o, dtype=torch.uint8)
        xs, ws, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), ()))
        p = int8_plan(b, k, o, n)
        want = (_build.block_rows(b), int(p["body"] == "sparse"), p["split"])
        rec.calls.clear()
        nk.nm_spmm_int8(xq, values, meta, xs, ws, n, out_dtype=torch.bfloat16)
        nk.nm_spmm_int8(xq, values, meta, xs, ws, n, out_dtype=torch.float32)
        nk.nm_spmm_int8(xq, values, meta, None, None, n)
        nk.nm_spmm_int8_requant(xq, values, meta, xs, ws, n, rq)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_nm_spmm_int8"
            assert args[-4:-1] == want, (name, args[-4:-1], want)
            kinds.append(args[-5])
        assert kinds == [0, 1, _build.OUT_RAW, _build.OUT_REQUANT]
        maps = torch.zeros(-(-b // _build.block_rows(b)), k // 64, dtype=torch.int32,
                           device="meta")
        rec.calls.clear()
        nk.nm_spmm_masked_int8(xq, values, meta, maps, maps, n, xs, ws)
        (name, args), = rec.calls
        assert name == "vg_nm_spmm_masked_int8" and args[-4:-1] == want


@pytest.mark.parametrize("b", [1, 8, 17, 64, 100, 256])
def test_tile_gemm_masked_fp8_launches_its_plan(rec, b):
    """vg_tile_gemm_masked_fp8's (.., bm, body, split, stream) is
    masked_fp8_plan's, at tile_gemm_fp8's (.., bm, body, bn, split, stream)
    wherever that streams, for the scaled outputs, the raw accumulator and
    the requantized codes (against tile_gemm_fp8_requant's)."""
    for k, o in ((1536, 4096), (4096, 1536)):
        xq, w = _meta(b, k, dtype=FP8), _meta(k, o, dtype=FP8)
        xs, ws, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), ()))
        maps = torch.zeros(-(-b // _build.block_rows(b)), k // 64, dtype=torch.int32,
                           device="meta")
        for scales, kw, requant in (((xs, ws), {"out_dtype": torch.bfloat16}, False),
                                    ((None, None), {}, False),
                                    ((xs, ws), {"requant_scale": rq}, True)):
            rec.calls.clear()
            tk.tile_gemm_masked_fp8(xq, w, maps, maps, *scales, **kw)
            if requant:
                tk.tile_gemm_fp8_requant(xq, w, *scales, rq)
            else:
                tk.tile_gemm_fp8(xq, w, *scales, **kw)
            (name_m, m), (name_t, t) = rec.calls
            assert (name_m, name_t) == ("vg_tile_gemm_masked_fp8", "vg_tile_gemm_fp8")
            p = masked_fp8_plan(b, k, o, requant)
            assert m[-4:-1] == (p["rows"], BODY_CODES[p["body"]], p["split"])
            assert m[-5] == t[-6]                       # out_kind
            if p["body"] == "stream":
                assert (t[-5], t[-4], t[-2]) == m[-4:-1]   # bm, body, split
            else:
                assert t[-4] != BODY_CODES["stream"]


def test_tile_gemm_masked_fp8_refuses_maps_at_another_row_block(rec):
    """At 8 rows the plan's row block is 16: maps made at 64 rows are
    refused on a device tensor (the CPU path takes any block_b)."""
    xq, w = _meta(8, 1536, dtype=FP8), _meta(1536, 4096, dtype=FP8)
    maps = torch.zeros(1, 24, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="the plan's row block is 16"):
        tk.tile_gemm_masked_fp8(xq, w, maps, maps, block_b=64)
    assert not rec.calls


# ------------------------------------------------- shared memory a block
def _dense_e4m3_smem(bm: int) -> int:
    """nm_spmm_sp_fp8.cuh's Layout<4, bm> single: the unpadded 64 x 64
    values tile and the X tile (80-byte rows) a stage, 6 stages at 16 rows
    and 4 at 64, the partial tile aliasing the ring, the inbox."""
    stages = 6 if bm == 16 else 4
    ring = max(stages * (64 * 64 + bm * 80), bm * 68 * 4)
    return ring + bm * 64 * 4


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_s8_stream_fits_the_blocks_an_sm(n, bm):
    """The s8 form keeps the e4m3 single's layout byte for byte (its int32
    partial tile and inbox take the fp32 ones' bytes) and no bitmask:
    split_k's BLOCKS_PER_SM blocks an SM."""
    total = _fp8_single_smem(n, bm)
    assert total <= SMEM_LIMIT
    assert BLOCKS_PER_SM * (total + BLOCK_RESERVED) <= SM_SMEM, (n, bm, total)


@pytest.mark.parametrize("bm", [16, 64])
def test_masked_dense_e4m3_stream_fits_the_blocks_an_sm(bm):
    """tile_gemm_fp8's stream with the 128-byte bitmask: stream_plan's two
    blocks an SM at either tile."""
    total = _dense_e4m3_smem(bm) + LIVE_BYTES
    assert total <= SMEM_LIMIT
    assert BLOCKS_PER_SM * (total + BLOCK_RESERVED) <= SM_SMEM, (bm, total)
    assert _dense_e4m3_smem(bm) == (36352 if bm == 16 else 53248)


# --------------------------------------------- the s8 stream, emulated
def _s8_step_products(xq: np.ndarray, values: np.ndarray, meta: np.ndarray,
                      n: int) -> list:
    """Each 64-deep step's exact int8 products (B, O), as the s8 stream
    forms them: per warp tile the transposed bytes and the mma.sp rows (the
    e4m3 form's, read as int8)."""
    o = values.shape[1]
    vrows, mrows = 16 * n, 4 * n
    xi = xq.astype(np.int64)
    vb = values.view(np.uint8)
    out = []
    for s in range(xq.shape[1] // 64):
        vs, ms = vb[s * vrows:(s + 1) * vrows], meta[s * mrows:(s + 1) * mrows]
        dense = np.zeros((o, 64), np.uint8)
        for c in range(0, o, 16):
            dense[c:c + 16] = _mma_sp_rows(_warp_tile(vs, ms, c, n), ms, c, n)
        out.append(xi[:, 64 * s:64 * s + 64] @ dense.view(np.int8).astype(np.int64).T)
    return out


def _s8_stream_acc(steps: list, split: int) -> np.ndarray:
    """The s8 stream's sums: block r's steps summed in its int32 registers,
    the blocks' int32 partials added in rank order (exact: no rounding)."""
    acc = None
    for lo, hi in _spans(64 * len(steps), split):
        part = sum(steps[lo:hi], np.zeros_like(steps[0]))
        acc = part if acc is None else acc + part
    assert np.abs(acc).max() < 2 ** 31
    return acc.astype(np.int32)


def _i8_flush(acc, xs, ws, bias):
    """SingleFlushI8: float(acc) * xs * ws (one fp32 rounding each), + bias."""
    v = ((acc.astype(np.float32) * xs).astype(np.float32) * ws).astype(np.float32)
    return (v + bias).astype(np.float32)


def _i8_codes(v: np.ndarray, rq: np.float32) -> np.ndarray:
    """requant_int8: clip(v / rq, +-127), round half to even."""
    return np.rint(np.clip((v / rq).astype(np.float32), -127, 127)).astype(np.int8)


def _int8_weight(rng, k, o, n):
    from repro_torch.core import nm as tnm
    from repro_torch.core.quantize import quantize_linear
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
    return quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)},
                           torch.int8)


@pytest.mark.parametrize("n", [1, 2])
def test_s8_stream_reproduces_pallas_bitwise(n):
    """B = 16, K_eff = 1024, O = 128 at int8_plan's split (8: two steps a
    rank): the emulated s8 stream's int32 sums are JAX's nm_spmm_int8 raw
    accumulator (interpret) bit for bit and the same at split 1; its flush
    (the scales) and requantized codes are JAX's scaled fp32 output and
    int8 codes bit for bit.  With a bias JAX's compiled flush may fuse the
    scale multiply and the bias add (one rounding less): within 2e-6,
    scaled, and the codes one step apart on at most 0.1% of them."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    from repro.kernels.nm_spmm.kernel import nm_spmm_int8 as j_nm

    from repro_torch.core.quantize import quantize_rows
    rng = np.random.default_rng(130 + n)
    b, k, o = 16, 1024, 128
    split = int8_plan(b, k, o, n)["split"]
    assert int8_plan(b, k, o, n) == {"body": "sparse", "split": 8}
    leaf = _int8_weight(rng, k, o, n)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0                                   # an idle slot
    xq, xs = quantize_rows(torch.from_numpy(x), torch.int8)
    values, meta = leaf["values"].numpy(), leaf["meta_packed"].numpy()
    ws = leaf["scale"].reshape(1, -1).numpy()
    steps = _s8_step_products(xq.numpy(), values, meta, n)
    acc = _s8_stream_acc(steps, split)
    assert np.array_equal(acc, _s8_stream_acc(steps, 1))
    jargs = [jnp.asarray(a) for a in (xq.numpy(), values, meta)]
    raw = np.asarray(j_nm(*jargs, None, None, n, interpret=True))
    assert raw.dtype == np.int32 and np.array_equal(acc, raw)
    jscales = (jnp.asarray(xs.numpy()), jnp.asarray(ws), n)
    zero = np.zeros(o, np.float32)
    got = _i8_flush(acc, xs.numpy(), ws, zero)
    want = np.asarray(j_nm(*jargs, *jscales, out_dtype=jnp.float32, interpret=True))
    assert np.array_equal(got, want)
    rq = np.float32(np.abs(want).max() / 300)     # saturates a share of the codes
    want_q = np.asarray(j_nm(*jargs, *jscales, epilogue=JSpec(requant="int8"),
                             requant_scale=jnp.asarray(rq), interpret=True))
    codes = _i8_codes(got, rq)
    assert want_q.dtype == np.int8 and np.array_equal(codes, want_q)
    assert (np.abs(codes) == 127).any()
    bias = rng.standard_normal(o).astype(np.float32)
    kw = dict(interpret=True, bias=jnp.asarray(bias))
    got = _i8_flush(acc, xs.numpy(), ws, bias)
    want = np.asarray(j_nm(*jargs, *jscales, out_dtype=jnp.float32, epilogue=JSpec(bias=True),
                           **kw))
    assert_scaled_close(got, want, 2e-6)
    want_q = np.asarray(j_nm(*jargs, *jscales, epilogue=JSpec(bias=True, requant="int8"),
                             requant_scale=jnp.asarray(rq), **kw))
    delta = np.abs(_i8_codes(got, rq).astype(np.int32) - want_q.astype(np.int32))
    assert delta.max() <= 1 and (delta == 1).mean() <= 1e-3


# ------------------------------------------ the masked dense e4m3 stream, emulated
def _dense_walk_acc(xb: np.ndarray, wb: np.ndarray, split: int, walk=None) -> np.ndarray:
    """The dense e4m3 stream's sums for one row block: per 64-deep step of
    walk(lo, hi) (every step of the span without a walk), the two k32
    halves' exact sums added into one partial from zero, rounded to fp32,
    added in fp32 over the span, the ranks' partials added in rank order."""
    xf, wf = _e4m3_f32(xb).astype(np.float64), _e4m3_f32(wb).astype(np.float64)
    acc = None
    for lo, hi in _spans(wb.shape[0], split):
        part = np.zeros((xb.shape[0], wb.shape[1]), np.float32)
        for s in (walk(lo, hi) if walk else range(lo, hi)):
            p = (xf[:, 64 * s:64 * s + 32] @ wf[64 * s:64 * s + 32]
                 + xf[:, 64 * s + 32:64 * s + 64] @ wf[64 * s + 32:64 * s + 64])
            part = (part + p.astype(np.float32)).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def _dense_emulate(xb, wb, kmask, bm, split, masked):
    return np.concatenate([
        _dense_walk_acc(xb[i * bm:(i + 1) * bm], wb, split,
                        _live_walk(kmask[i]) if masked else None)
        for i in range(kmask.shape[0])])


def _fp8_dense_weight(rng, k, o):
    from repro_torch.core.quantize import quantize_linear
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    return quantize_linear({"w": w}, FP8)


def test_masked_dense_e4m3_reads_the_dense_streams_operand():
    """The masked walk reads its A registers as the unmasked dense stream
    does (ldmatrix .trans + __byte_perm from the swizzled landed tile)."""
    leaf = _fp8_dense_weight(np.random.default_rng(139), 64, 64)
    _check_dense_fragments(leaf["w"].view(torch.uint8).numpy())


@pytest.mark.parametrize("share", ["none", "forty", "all", "rank0_dead", "one_rank"])
def test_masked_dense_e4m3_walk_is_bitwise_the_unmasked_stream(share):
    """B = 32 over two 16-row blocks, K = 1024 (16 steps), O = 128 at
    tile_gemm_fp8's split (8): the walk visits each span's live steps in
    order, and the sums, SingleFlush's output and the requantized codes are
    the unmasked dense stream's, bit for bit."""
    rng = np.random.default_rng(140)
    b, k, o, bm = 32, 1024, 128, 16
    p = masked_fp8_plan(16, k, o)
    assert p == tile_fp8_plan(16, k, o) and p["body"] == "stream" and p["split"] == 8
    leaf = _fp8_dense_weight(rng, k, o)
    wb = leaf["w"].view(torch.uint8).numpy()
    ws, bias = leaf["scale"].reshape(1, -1).numpy(), np.float32(0.25)
    xq, xs, _, kmask = _fp8_rows(rng, b, k, _fp8_cases(rng, k // 64)[share])
    km = kmask.numpy()
    for i in range(km.shape[0]):
        walk = _live_walk(km[i])
        for lo, hi in _spans(k, p["split"]):
            assert walk(lo, hi) == [s for s in range(lo, hi) if km[i, s]]
    xb = xq.view(torch.uint8).numpy()
    got = _dense_emulate(xb, wb, km, bm, p["split"], masked=True)
    full = _dense_emulate(xb, wb, km, bm, p["split"], masked=False)
    assert np.array_equal(got, full)
    if share == "none":
        assert not got.any()
    flushed = _single_flush(got, xs.numpy(), ws, bias)
    assert np.array_equal(flushed, _single_flush(full, xs.numpy(), ws, bias))


def test_masked_dense_e4m3_walk_matches_pallas():
    """The emulated masked dense e4m3 stream, SingleFlush with bias and silu
    in fp32, against JAX's tile_gemm_masked fp8 branch (interpret; maps at
    16 rows x 64 columns) within 1e-6, scaled, ~40% live with a dead rank
    span; its requantized codes one e4m3 step at most off JAX's on at most
    0.1% of them."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import epilogue as jepi
    from repro.kernels.tile_gemm.kernel import tile_gemm_masked as j_masked

    from test_torch_masked_stream_redesign import _codes
    rng = np.random.default_rng(150)
    b, k, o, bm = 32, 1024, 128, 16
    split = masked_fp8_plan(16, k, o)["split"]
    leaf = _fp8_dense_weight(rng, k, o)
    xq, xs, kmap, kmask = _fp8_rows(rng, b, k, [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
    ws = leaf["scale"].reshape(1, -1)
    acc = _dense_emulate(xq.view(torch.uint8).numpy(), leaf["w"].view(torch.uint8).numpy(),
                         kmask.numpy(), bm, split, masked=True)
    bias = rng.standard_normal(o).astype(np.float32)
    got = _single_flush(acc, xs.numpy(), ws.numpy(), bias)
    args = (_j(jnp, xq), _j(jnp, leaf["w"]), _j(jnp, kmap), _j(jnp, kmask), _j(jnp, xs),
            _j(jnp, ws))
    kw = dict(block_b=bm, block_o=128, block_k=64, acc_dtype=jnp.float32, interpret=True,
              bias=jnp.asarray(bias))
    want = np.asarray(j_masked(*args, out_dtype=jnp.float32,
                               epilogue=jepi.EpilogueSpec(act="silu", bias=True), **kw))
    assert_scaled_close(got, want, 1e-6)
    rq = np.float32(np.abs(want).max() / 300)
    want_q = np.asarray(j_masked(*args, epilogue=jepi.EpilogueSpec(
        act="silu", bias=True, requant="float8_e4m3fn"), requant_scale=jnp.asarray(rq), **kw))
    assert _step_share(_codes(got, rq), want_q.view(np.uint8)) <= 1e-3


# ----------------------------------------------------------- on the card
def _int8_case(dev, b, k, o, n, seed=0):
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
    leaf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)}, torch.int8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    xq, xs = quantize_rows(x, torch.int8)
    return xq, (leaf["values"], leaf["meta_packed"]), xs, leaf["scale"].reshape(1, -1)


@pytest.mark.cuda
def test_refused_entries_raise_on_card(cuda_device):
    xq, (values, meta), xs, ws = _int8_case(cuda_device, 8, 256, 128, 2)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library("gemm_int8.cu")
    # (n, bm, body, split): the s8 stream at n in {1, 2}, bm 16 | 64, a power
    # of two up to min(8, K / 64) = 4; the first body split 1; no body 2
    for n, bm, body, split in ((4, 16, 1, 1), (2, 16, 1, 3), (2, 16, 1, 8), (2, 32, 1, 1),
                               (2, 16, 0, 2), (2, 16, 2, 1)):
        rc = lib.vg_nm_spmm_int8(xq.data_ptr(), values.data_ptr(), meta.data_ptr(),
                                 xs.data_ptr(), ws.data_ptr(), None, None, y.data_ptr(), 8, 256,
                                 128, n, 0, 0, bm, body, split, _build.stream_of(xq))
        assert rc != 0, (n, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_int8", lib)
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.kernels.actsparse import block_maps
    w = quantize_linear({"w": torch.randn(256, 128, device=cuda_device)}, FP8)["w"]
    x8, s8 = quantize_rows(torch.randn(8, 256, device=cuda_device).bfloat16(), FP8)
    _, kmask = block_maps(x8, 16, 64)
    fp8 = _build.library("gemm_fp8.cu")
    # (kmask, body, split): a kmask always; the stream a power of two up to
    # 4, the shared body split 1, no body 2
    for km, body, split in ((None, 1, 2), (kmask, 1, 3), (kmask, 1, 8), (kmask, 0, 2),
                            (kmask, 2, 1)):
        rc = fp8.vg_tile_gemm_masked_fp8(x8.data_ptr(), w.data_ptr(),
                                         None if km is None else km.data_ptr(), s8.data_ptr(),
                                         ws.data_ptr(), None, None, y.data_ptr(), 8, 256, 128,
                                         0, 0, 16, body, split, _build.stream_of(x8))
        assert rc != 0, (body, split)
