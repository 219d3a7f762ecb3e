"""The redesigned Hopper bodies of tile_gemm_fp8 (with tile_gemm_fp8_requant:
an e4m3 stream over the dense weight with split-K over a cluster for few
rows, a TMA + wgmma body whose weight tile is transposed on chip for many)
and of the float lane-aligned gather K8, nm_spmm_gather_bk at n in {1, 2}
(K1's stream over the dense values with the X side gathered for few rows,
a gather pass in front of K1's wgmma body for many).

On the CPU: both planners (the stream at internlm2-1.8b's and gemma3-1b's
decode sites, wgmma at hubert-xlarge's 4,000 and phi-3-vision's 1,024
prefill rows, split spans whole 64-steps covering K, K = 1152 included,
K8 at n = 4 on the shared body); every new body's shared memory fits a
block; a numpy emulation of the e4m3 dense operand of both bodies (the
stream's per-warp byte transpose with one fp32 partial per 64-deep step;
the wgmma body's transposer into the 128-byte-swizzled K-major tile with
one partial per 128-deep stage) reproduces the raw accumulator of the JAX
package's ``tile_gemm_fp8`` (Pallas, interpret mode) within 1e-6, scaled;
and an emulation of both gather selects (the stream's select pass over
the step's span; the many-row plan's gather pass over whole rows, in front
of K1's wgmma body), byte permutes included, an index outside [0, 4)
reading +0, reproduces the JAX package's ``nm_spmm_gather_bk``
(interpret) at n in {1, 2} within 1e-6, scaled.  On the card (``cuda``): both kernels bitwise
the same across launches and at every split boundary, at B in {1, 8, 33,
64, 256, 1024, 4000}; every out_kind of tile_gemm_fp8 (bf16 and fp32
scaled with bias / silu / gelu, the raw accumulator, the requantized
codes); K8's bias / silu / gelu epilogues and its fp32 store; refused
plans.  Tolerances: 1e-2 of max|plain| for the bf16 / fp32 outputs and
the raw fp8 accumulator (the sums run in another order), requantized e4m3
codes one step off on at most 0.1% of them."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk
from repro_torch.kernels.nm_spmm_gather.kernel import plan as gather_plan
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, FP8_SHARED_TILES,
                                                  FP8_WGMMA_COLS, MAX_SPLIT, SMS,
                                                  WGMMA_MIN_ROWS, WGMMA_ROWS, fp8_plan,
                                                  plan as tile_plan, tile_gemm_fp8,
                                                  tile_gemm_fp8_requant)
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into (H100)
SM_SMEM = 228 * 1024         # shared memory of an SM
FP8 = torch.float8_e4m3fn


def _sites(arch):
    """(K, O) of each distinct single-GEMM site of a config, from get_config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return list(dict.fromkeys([(cfg.d_model, cfg.attn_dim), (cfg.d_model, cfg.kv_dim),
                               (cfg.attn_dim, cfg.d_model), (cfg.d_ff, cfg.d_model),
                               (cfg.d_model, cfg.d_ff)]))


def _assert_spans(k: int, split: int):
    """Block r's 64-deep steps, as splitk.cuh's span computes them: whole,
    non-empty, contiguous, covering K."""
    steps = k // 64
    assert k % 64 == 0 and 1 <= split <= min(MAX_SPLIT, steps) and split & (split - 1) == 0
    spans = [(r * steps // split, (r + 1) * steps // split) for r in range(split)]
    assert spans[0][0] == 0 and spans[-1][1] == steps
    assert all(lo < hi for lo, hi in spans)
    assert all(spans[r][1] == spans[r + 1][0] for r in range(split - 1))


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "gemma3_1b"])
@pytest.mark.parametrize("b", [1, 8, 16, 33, 64])
def test_fp8_plan_streams_at_decode_and_chunk_rows(arch, b):
    for k, o in _sites(arch):
        p = fp8_plan(b, k, o)
        rows = 16 if b <= 16 else 64
        tiles = (o // 64) * -(-b // rows)
        # a 64-row launch as wide as FP8_SHARED_TILES keeps the shared body
        body = "shared" if rows == 64 and tiles >= FP8_SHARED_TILES else "stream"
        assert p["body"] == body and p["rows"] == rows and p["cols"] == 64, (k, o, p)
        _assert_spans(k, p["split"])
        assert tiles * p["split"] <= (2 if rows == 16 else 1) * SMS or p["split"] == 1
        assert fp8_plan(b, k, o, requant=True) == p
    # internlm2's q, k / v, o and w_out fill the card at decode
    for k, o in _sites("internlm2_1_8b")[:3]:
        assert 0.95 * SMS <= (o // 64) * fp8_plan(8, k, o)["split"] <= BLOCKS_PER_SM * SMS


@pytest.mark.parametrize("arch,rows", [("hubert_xlarge", 4000), ("phi_3_vision_4_2b", 1024),
                                       ("internlm2_1_8b", WGMMA_MIN_ROWS)])
def test_both_plans_take_wgmma_at_prefill_rows(arch, rows):
    for k, o in _sites(arch):
        assert fp8_plan(rows, k, o) == {"body": "wgmma", "rows": WGMMA_ROWS,
                                        "cols": FP8_WGMMA_COLS, "split": 1}
        # the requantized codes never come from wgmma's e4m3 sums
        assert fp8_plan(rows, k, o, requant=True)["body"] in ("stream", "shared")
        for n in (1, 2):     # the gather pass, then K1's body with K1's tile over K_c
            assert gather_plan(rows, k, o, n) == tile_plan(rows, k * n // 4, o)
            assert tile_plan(rows, k * n // 4, o)["body"] == "wgmma"
    for b in (1, 8, 64, WGMMA_MIN_ROWS - 1):
        assert all(fp8_plan(b, k, o)["body"] in ("stream", "shared") for k, o in _sites(arch))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "gemma3_1b"])
@pytest.mark.parametrize("b", [1, 8, 33, 64, 255])
def test_gather_plan_streams_over_the_compressed_k(arch, n, b):
    for k, o in _sites(arch):
        kc = k * n // 4
        if kc % 64:          # K_c not a multiple of 64 plans no-kernel-fits before the wrapper
            continue
        p = gather_plan(b, k, o, n)
        rows = 16 if b <= 16 else 64
        # 1:4 keeps the shared body at 64-row tiles below the wgmma plan's rows
        body = "shared" if n == 1 and rows == 64 else "stream"
        assert p["body"] == body and p["rows"] == rows, (k, o, p)
        _assert_spans(kc, p["split"])
    # n = 4 keeps the shared body (gemm.cu), split 1
    assert gather_plan(8, 2048, 2048, 4) == {"body": "shared", "rows": 16, "cols": 64,
                                             "split": 1}
    assert gather_plan(4000, 2048, 2048, 4)["body"] == "shared"


@pytest.mark.parametrize("k", [192, 320, 1152, 1216, 2048, 8192])
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_split_spans_are_whole_steps_covering_k(k, b):
    for o in (64, 256, 2048):
        _assert_spans(k, fp8_plan(b, k, o)["split"])
        for n in (1, 2):
            if (k * n // 4) % 64 == 0:
                _assert_spans(k * n // 4, gather_plan(b, k, o, n)["split"])


# -------------------------------------------------- every body fits a block
def _fp8_stream_smem(bm):
    """nm_spmm_sp_fp8.cuh at N = 4: the ring (the unpadded values tile, read
    by ldmatrix .trans, and the X tile), inbox."""
    stages = 6 if bm == 16 else 4
    stage = 64 * 64 + bm * 80
    return max(stages * stage, bm * 68 * 4) + bm * 64 * 4


def _fp8_wgmma_smem():
    """tile_gemm_sm90_fp8.cuh: 4 stages of X + K-major W + raw W, 12 mbarriers,
    two 64 x (32 + 4) fp32 epilogue tiles, 1 KB of alignment slack."""
    return 4 * 3 * 128 * 128 + 3 * 4 * 8 + 2 * 64 * 36 * 4 + 1024


def _gather_stream_smem(n, bm):
    """nm_spmm_sp.cuh with the gathered X: ring (values, indices, span),
    the compact X tile, inbox."""
    stages = 4 if bm == 16 else 3
    stage = 64 * 72 * 2 + 64 * 4 + bm * (256 // n + 8) * 2
    return max(stages * stage, bm * 68 * 4) + bm * 72 * 2 + bm * 64 * 4


@pytest.mark.parametrize("body,bytes_,per_sm", [
    *[(f"fp8 stream bm={bm}", _fp8_stream_smem(bm), 2 if bm == 16 else 1) for bm in (16, 64)],
    ("fp8 wgmma", _fp8_wgmma_smem(), 1),
    *[(f"gather stream n={n} bm={bm}", _gather_stream_smem(n, bm), 2 if bm == 16 else 1)
      for n in (1, 2) for bm in (16, 64)]])
def test_every_new_body_fits_a_block(body, bytes_, per_sm):
    assert bytes_ <= SMEM_LIMIT, body
    assert per_sm * bytes_ <= SM_SMEM, body          # the blocks an SM the plans assume


# ------------------------------------- the e4m3 dense operand, emulated
def _gather_byte(w, j):
    """spf8::gather_byte on uint32 arrays: byte j of each of four words."""
    return sum(((w[p] >> np.uint32(8 * j)) & np.uint32(0xFF)) << np.uint32(8 * p)
               for p in range(4)).astype(np.uint32)


def _word(byte_rows: np.ndarray) -> np.ndarray:
    """(4, ...) uint8 -> the little-endian uint32 they form."""
    return sum(byte_rows[p].astype(np.uint32) << np.uint32(8 * p) for p in range(4))


def _stream_step_operand(w8: np.ndarray, step: int) -> np.ndarray:
    """The stream body's A operand of one 64-deep step for every 16-channel
    warp tile: the values tile as cp.async lands it (swizzled 16-byte
    chunks), each lane's registers by ldmatrix .trans and __byte_perm (A row
    g = channel 2g, row g + 8 = channel 2g + 1 of the tile), mapped back to
    channels as the partial store does.  Returns (O, 64) bytes,
    channel-major."""
    from test_torch_fp8_kmajor_dual_redesign import _dense_a_fragments, _landed
    o = w8.shape[1]
    out = np.zeros((o, 64), np.uint8)
    for n0 in range(0, o, 64):
        tile = _landed(w8[64 * step:64 * step + 64, n0:n0 + 64])
        for jc in range(4):
            regs = _dense_a_fragments(tile, jc)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    for r, (ch, k0) in enumerate(((2 * g, 4 * t), (2 * g + 1, 4 * t),
                                                  (2 * g, 16 + 4 * t), (2 * g + 1, 16 + 4 * t))):
                        out[n0 + 16 * jc + ch, 32 * h + k0:32 * h + k0 + 4] = np.frombuffer(
                            np.uint32(regs[lane][4 * h + r]).tobytes(), np.uint8)
    return out


def _wgmma_stage_operand(w8: np.ndarray, kb: int, n0: int) -> np.ndarray:
    """The wgmma body's transposer over one 128 x 128 stage: the raw tile (K
    rows 128 kb .., channels n0 .., zeros past the ends), lane g of chunk c
    writing rows 4g + j, j rotated by g / 2, as 16-byte chunks c ^ (row % 8)
    of the swizzled [128][128] tile; read back through the wgmma
    descriptor's swizzle.  Returns (128 channels, 128 K) bytes."""
    k, o = w8.shape
    raw = np.zeros((128, 128), np.uint8)
    blk = w8[128 * kb:128 * kb + 128, n0:n0 + 128]
    raw[:blk.shape[0], :blk.shape[1]] = blk
    tile = np.zeros(128 * 128, np.uint8)
    for c in range(8):
        for g in range(32):
            w = [_word(raw[16 * c + r, 4 * g:4 * g + 4].reshape(4, 1))[0] for r in range(16)]
            for jj in range(4):
                j = (jj + (g >> 1)) & 3
                row = 4 * g + j
                chunk = np.array([_gather_byte(np.array(w[4 * s:4 * s + 4], np.uint32), j)
                                  for s in range(4)], np.uint32)
                at = row * 128 + ((c ^ (row & 7)) << 4)
                tile[at:at + 16] = np.frombuffer(chunk.tobytes(), np.uint8)
    rows = np.arange(128)[:, None]
    kk = np.arange(128)[None, :]
    return tile[rows * 128 + (((kk >> 4) ^ (rows & 7)) << 4) + (kk & 15)]


def _e4m3(values: np.ndarray):
    """(e4m3 bytes, the values as float32) through the JAX package's cast."""
    jnp = pytest.importorskip("jax.numpy")
    v8 = np.asarray(jnp.asarray(values).astype(jnp.float8_e4m3fn))
    return v8.view(np.uint8), v8.astype(np.float32), v8


def _fp32_partials(xf, wt_of_step, steps):
    """acc = fp32(acc + fp32(partial)), each partial summed exactly."""
    acc = np.zeros((xf.shape[0], wt_of_step(0)[1].shape[0]), np.float32)
    for s in range(steps):
        ks, wt = wt_of_step(s)
        part = xf[:, ks].astype(np.float64) @ wt.T.astype(np.float64)
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("body", ["stream", "wgmma"])
def test_e4m3_dense_operand_reproduces_the_raw_accumulator(body):
    """e4m3 inputs: each body's transposed weight operand and its promotion
    (64-deep partials in the stream, 128-deep in the wgmma body) reproduce
    JAX's tile_gemm_fp8 raw accumulator (Pallas, interpret mode) within
    1e-6, scaled; K = 192 ends the wgmma body's second stage past K."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.tile_gemm.kernel import tile_gemm_fp8 as j_tile_fp8

    rng = np.random.default_rng(11)
    b, k, o = 8, 192, 64 if body == "stream" else 192
    w8, wf, wj = _e4m3(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    _, xf, xj = _e4m3(rng.standard_normal((b, k)).astype(np.float32))
    if body == "stream":
        def step(s):
            wt = _stream_step_operand(w8, s).view(wj.dtype).astype(np.float32)
            return slice(64 * s, 64 * s + 64), wt
        got = _fp32_partials(xf, step, k // 64)
    else:
        got = np.zeros((b, o), np.float32)
        for n0 in range(0, o, 128):            # channels past O arrive as zeros
            xpad = np.zeros((b, 256), np.float32)
            xpad[:, :k] = xf

            def step(s, n0=n0):
                wt = _wgmma_stage_operand(w8, s, n0).view(wj.dtype).astype(np.float32)
                return slice(128 * s, 128 * s + 128), wt
            acc = _fp32_partials(xpad, step, 2)
            width = min(128, o - n0)
            got[:, n0:n0 + width] = acc[:, :width]
    want = np.asarray(j_tile_fp8(jnp.asarray(xj), jnp.asarray(wj), block_o=64, block_k=64,
                                 interpret=True))
    assert_scaled_close(got, want, 1e-6)
    assert_scaled_close(got, xf @ wf, 1e-6)


# ------------------------------------------- the gathered X, emulated
def _byte_perm(x, y, s):
    """__byte_perm(x, y, s) (default mode) on uint32 arrays."""
    x, y, s = (np.asarray(a, np.uint64) for a in (x, y, s))
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((src >> (sel * np.uint64(8))) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _pick_half(lo, hi, e, h):
    """sp::pick_half of nm_spmm_sp.cuh (the stream's select and gemm.cu's
    gather pass)."""
    e = np.asarray(e, np.int64)
    s = (2 * (e & 3)).astype(np.uint32)
    sel = (s << 8) | ((s + 1) << 12) if h else s | ((s + 1) << 4)
    keep = np.where((e >= 0) & (e < 4), np.uint32(0xFFFF0000 if h else 0xFFFF), np.uint32(0))
    return _byte_perm(lo, hi, sel) & keep


def _select_unit(words: np.ndarray, w0: int, e: np.ndarray, n: int) -> np.ndarray:
    """One unit of either select (the stream's pass over a step's span, the
    many-row gather pass over a whole row): eight compressed columns from
    the row words at w0 (the unit's first M-block), four words of pairs,
    as (rows, 8) bf16 bits.  2:4: pair q is M-block q (words 2q, 2q + 1);
    1:4: blocks 2q, 2q + 1 (words 4q .. + 3)."""
    out = np.zeros((words.shape[0], 8), np.uint16)
    for q in range(4):
        if n == 2:
            lo, hi = words[:, w0 + 2 * q], words[:, w0 + 2 * q + 1]
            v = _pick_half(lo, hi, e[2 * q], 0) | _pick_half(lo, hi, e[2 * q + 1], 1)
        else:
            v = _pick_half(words[:, w0 + 4 * q], words[:, w0 + 4 * q + 1], e[2 * q], 0) | \
                _pick_half(words[:, w0 + 4 * q + 2], words[:, w0 + 4 * q + 3], e[2 * q + 1], 1)
        out[:, 2 * q] = (v & 0xFFFF).astype(np.uint16)
        out[:, 2 * q + 1] = (v >> 16).astype(np.uint16)
    return out


def _stream_select(xb: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """The stream body's select pass: for each 64-deep step, unit (row,
    columns j0 .. + 7) reads the words of the row's span (the step's 256 /
    n X columns) from column j0 / n * 4.  Returns the gathered X as bf16
    bits."""
    b, ke = xb.shape
    kc = idx.shape[0]
    span = 256 // n
    out = np.zeros((b, kc), np.uint16)
    for s in range(kc // 64):
        words = np.ascontiguousarray(xb[:, s * span:(s + 1) * span]).view(np.uint32)
        for j0 in range(0, 64, 8):
            out[:, 64 * s + j0:64 * s + j0 + 8] = _select_unit(
                words, j0 // n * 2, idx[64 * s + j0:64 * s + j0 + 8], n)
    return out


def _pass_select(xb: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """The many-row plan's gather pass (gemm.cu::gather_columns_kernel):
    unit (row, columns j0 .. + 7 of K_c) reads the row's words from X column
    j0 / n * 4, 16-byte loads (two at 2:4, four at 1:4)."""
    b, ke = xb.shape
    kc = idx.shape[0]
    words = np.ascontiguousarray(xb).view(np.uint32)
    out = np.zeros((b, kc), np.uint16)
    for j0 in range(0, kc, 8):
        out[:, j0:j0 + 8] = _select_unit(words, j0 // n * 2, idx[j0:j0 + 8], n)
    return out


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("body", ["stream", "pass"])
def test_gather_select_reproduces_pallas(body, n):
    """bf16 X and values: each body's select (an index outside [0, 4) gives
    +0) followed by the fp32 contraction reproduces JAX's
    nm_spmm_gather_bk (Pallas, interpret mode) within 1e-6, scaled."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk as j_gather

    rng = np.random.default_rng(5 + n)
    b, ke, o = 8, 512, 64
    kc = ke * n // 4
    idx = np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                  -1).reshape(-1).astype(np.int32)
    idx[3] = 7                                   # outside [0, 4): reads +0
    idx[kc - 2] = -1
    xf = np.asarray(jnp.asarray(rng.standard_normal((b, ke)).astype(np.float32))
                    .astype(jnp.bfloat16))
    vf = np.asarray(jnp.asarray(rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)
                    .astype(jnp.bfloat16))
    bits = xf.view(np.uint16)
    gathered = (_stream_select if body == "stream" else _pass_select)(bits, idx, n)
    gf = (gathered.astype(np.uint32) << 16).view(np.float32)
    got = gf.astype(np.float64) @ vf.astype(np.float32).astype(np.float64)
    want = j_gather(jnp.asarray(xf), jnp.asarray(vf), jnp.asarray(idx.reshape(-1, 1)), n,
                    out_dtype=jnp.float32, interpret=True)
    assert_scaled_close(got.astype(np.float32), np.asarray(want), 1e-6)
    cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
    plain = np.where((idx >= 0) & (idx < 4), xf.astype(np.float32)[:, cols], 0)
    assert np.array_equal(gf, plain)


# ----------------------------------------------------------- on the card
def _fp8_case(dev, b, k, o, seed=0):
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    leaf = quantize_linear({"w": w}, FP8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0                                              # an idle slot
    xq, xs = quantize_rows(x, FP8)
    return xq, xs, leaf["w"], leaf["scale"].reshape(1, -1)


def _gather_case(dev, b, k, o, n, seed=0):
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather")
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    return x, leaf["values"], leaf["gather_idx"]


def _e4m3_step_share(got, want) -> float:
    def ordinal(t):
        b = t.view(torch.uint8).int()
        return torch.where(b >= 128, -(b - 128), b)
    d = (ordinal(got) - ordinal(want)).abs()
    assert d.max().item() <= 1
    return (d == 1).float().mean().item()


ROWS = [1, 8, 33, 64, 256, 1024, 4000]


def _shape(b):
    return {1024: (3072, 3072), 4000: (1280, 1280)}.get(b, (2048, 1024))


@pytest.mark.cuda
@pytest.mark.parametrize("b", ROWS)
def test_tile_gemm_fp8_bitwise_deterministic_on_card(cuda_device, b):
    k, o = _shape(b)
    xq, xs, w, ws = _fp8_case(cuda_device, b, k, o)
    first = tile_gemm_fp8(xq, w)
    again = [tile_gemm_fp8(xq, w) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in again)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", ROWS)
def test_gather_bitwise_deterministic_on_card(cuda_device, n, b):
    k, o = _shape(b)
    x, v, idx = _gather_case(cuda_device, b, k, o, n)
    first = nm_spmm_gather_bk(x, v, idx, n)
    again = [nm_spmm_gather_bk(x, v, idx, n) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in again)


SPLIT_SHAPES = [(192, 64), (320, 64), (448, 128), (1216, 256), (1088, 512), (1152, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", SPLIT_SHAPES)
@pytest.mark.parametrize("b", [1, 8, 64])
def test_tile_gemm_fp8_at_split_boundaries_on_card(cuda_device, k, o, b):
    """K = 64 x steps not divisible by the split: uneven spans per block."""
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_quantized_ref
    p = fp8_plan(b, k, o)
    xq, xs, w, ws = _fp8_case(cuda_device, b, k, o)
    got = tile_gemm_fp8(xq, w)
    torch.cuda.synchronize()
    assert_scaled_close(got, tile_gemm_quantized_ref(xq, w, None, None), 1e-2)
    if b <= 16:
        assert p["split"] > 1 and (k // 64) % p["split"], p
    assert torch.equal(got, tile_gemm_fp8(xq, w))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(768, 64), (1280, 64), (1792, 128), (4864, 256),
                                 (4352, 512)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_gather_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K_c = 64 x steps not divisible by the split."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_ref
    if (k * n // 4) % 64:
        pytest.skip(f"K_c = {k * n // 4} is not a multiple of 64 at n = {n}")
    p = gather_plan(b, k, o, n)
    x, v, idx = _gather_case(cuda_device, b, k, o, n)
    got = nm_spmm_gather_bk(x, v, idx, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_gather_ref(x, v, idx, n), 1e-2)
    if b <= 16 and p["split"] > 1:
        assert torch.equal(got, nm_spmm_gather_bk(x, v, idx, n))


@pytest.mark.cuda
@pytest.mark.parametrize("b", ROWS)
def test_tile_gemm_fp8_every_out_kind_on_card(cuda_device, b):
    from repro_torch.kernels.tile_gemm.ref import (tile_gemm_fp8_requant_ref,
                                                   tile_gemm_quantized_ref)
    k, o = _shape(b)
    xq, xs, w, ws = _fp8_case(cuda_device, b, k, o, seed=b)
    before = tile_gemm_fp8.launches
    raw = tile_gemm_fp8(xq, w)
    assert raw.dtype == torch.float32 and tile_gemm_fp8.launches == before + 1
    assert_scaled_close(raw, tile_gemm_quantized_ref(xq, w, None, None), 1e-2)
    bias = torch.randn(o, device=cuda_device) * 0.1
    for act, bv in ((None, None), (None, bias), ("silu", bias), ("gelu", bias)):
        spec = EpilogueSpec(act=act, bias=bv is not None)
        for dt in (torch.bfloat16, torch.float32):
            got = tile_gemm_fp8(xq, w, xs, ws, epilogue=spec, bias=bv, out_dtype=dt)
            want = tile_gemm_quantized_ref(xq, w, xs, ws, epilogue=spec, bias=bv, out_dtype=dt)
            assert got.dtype == dt
            assert_scaled_close(got, want, 1e-2)
    gelu = EpilogueSpec(act="gelu", bias=True)
    y = tile_gemm_fp8(xq, w, xs, ws, epilogue=gelu, bias=bias)
    rq = (y.abs().amax() / 300).reshape(())
    before = tile_gemm_fp8_requant.launches
    codes = tile_gemm_fp8_requant(xq, w, xs, ws, rq, epilogue=gelu, bias=bias)
    torch.cuda.synchronize()
    assert tile_gemm_fp8_requant.launches == before + 1 and codes.dtype == FP8
    want = tile_gemm_fp8_requant_ref(xq, w, xs, ws, rq, epilogue=gelu, bias=bias)
    assert _e4m3_step_share(codes, want) <= 1e-3
    assert torch.equal(codes, tile_gemm_fp8_requant(xq, w, xs, ws, rq, epilogue=gelu,
                                                    bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", ROWS)
def test_gather_epilogues_and_fp32_store_on_card(cuda_device, n, b):
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_ref
    k, o = _shape(b)
    x, v, idx = _gather_case(cuda_device, b, k, o, n, seed=b)
    bias = torch.randn(o, device=cuda_device)
    for act, bv in ((None, None), (None, bias), ("silu", bias), ("gelu", bias)):
        spec = EpilogueSpec(act=act, bias=bv is not None)
        before = nm_spmm_gather_bk.launches
        y16 = nm_spmm_gather_bk(x, v, idx, n, epilogue=spec, bias=bv)
        y32 = nm_spmm_gather_bk(x, v, idx, n, epilogue=spec, bias=bv, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert nm_spmm_gather_bk.launches == before + 2
        assert_scaled_close(y16, nm_spmm_gather_ref(x, v, idx, n, epilogue=spec, bias=bv), 1e-2)
        assert_scaled_close(y32, nm_spmm_gather_ref(x, v, idx, n, epilogue=spec, bias=bv,
                                                    out_dtype=torch.float32), 1e-2)
        assert torch.equal(y16, y32.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [8, 64, 1024])
def test_gather_index_outside_the_block_reads_zero_on_card(cuda_device, n, b):
    """An index outside [0, 4) selects +0 in every body (the TPU kernel's
    compare-and-select), against the plain product on the zeroed columns."""
    k, o = _shape(b)
    x, v, idx = _gather_case(cuda_device, b, k, o, n, seed=3)
    idx = idx.clone()
    idx[1], idx[70], idx[-1] = 9, -1, 4
    got = nm_spmm_gather_bk(x, v, idx, n, out_dtype=torch.float32)
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < 4)
    cols = torch.arange(idx.numel(), device=cuda_device) // n * 4 + idx.clamp(0, 3).long()
    want = (x.float()[:, cols] * ok) @ v.float()
    assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
def test_refused_plans_raise_on_card(cuda_device):
    xq, xs, w, ws = _fp8_case(cuda_device, 8, 128, 128)
    y = torch.empty((8, 128), dtype=torch.float32, device=cuda_device)
    lib8 = _build.library("gemm_fp8.cu")
    # (bm, body, bn, split): body 0 shared (bn 64, split 1), 1 stream (bn 64), 2 wgmma
    # (bm 128, bn 128, split 1)
    for bm, body, bn, split in ((16, 0, 64, 2), (16, 1, 64, 0), (16, 1, 64, 3), (16, 1, 128, 1),
                                (128, 2, 256, 1), (128, 2, 128, 2), (64, 2, 128, 1),
                                (16, 3, 64, 1)):
        rc = lib8.vg_tile_gemm_fp8(xq.data_ptr(), w.data_ptr(), None, None, None, None,
                                   y.data_ptr(), 8, 128, 128, 0, 2, bm, body, bn, split,
                                   _build.stream_of(xq))
        assert rc != 0, (bm, body, bn, split)
    x, v, idx = _gather_case(cuda_device, 8, 256, 64, 2)
    yb = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library()
    for n, bm, body, bn, split in ((2, 16, 0, 64, 2), (4, 16, 1, 64, 1), (2, 16, 1, 64, 3),
                                   (2, 128, 2, 64, 1), (4, 128, 2, 128, 1), (2, 16, 1, 128, 1)):
        rc = lib.vg_nm_spmm_gather_bk(x.data_ptr(), v.data_ptr(), idx.data_ptr(), None,
                                      yb.data_ptr(), 8, 256, 64, n, 0, 0, bm, body, bn, split,
                                      None, _build.stream_of(x))
        assert rc != 0, (n, bm, body, bn, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_bk", lib)
