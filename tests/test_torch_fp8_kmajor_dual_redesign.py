"""The redesigned Hopper bodies of the fp8 dense gate-up dual
tile_gemm_dual_fp8 (with tile_gemm_dual_fp8_requant: the e4m3 dual stream
of csrc/nm_spmm_sp_fp8.cuh over both dense weights at few rows, split-K over
a cluster; the dual form of csrc/tile_gemm_sm90_fp8.cuh from 256 rows,
never for the requantized codes) and of the fp8 K-major gather K11,
nm_spmm_gather_fp8 at n in {1, 2} (the same e4m3 stream with a K-major X
stage: the step's selected x_t rows landed by cp.async, a byte transpose
pass, the (O, B) output flushed acc * ws * xs).

On the CPU: both plans (``tile_gemm/kernel.py::fp8_dual_plan``,
``nm_spmm_gather/kernel.py::kmajor_fp8_plan``) at internlm2-1.8b's and
qwen3-moe's decode and chunk rows, at 256 and 1,024 rows, and at K11's
local shapes on a (1, 2) mesh at B in {32, 256}, n in {1, 2, 4}; split spans
whole 64-steps covering K; every new body's shared memory fits a block at
the blocks an SM the plans assume; a numpy emulation of the dense dual
stream (each warp's byte transpose of both 64-deep tiles, 64-deep partials
from zero as two k32 halves, the split spans summed in rank order, the dual
flush, with and without the requantized store) and of the wgmma form's
order (its transposers' K-major swizzled tiles, 128-deep partials in 128-row
x 64-channel tiles of each weight) reproduces the JAX package's
``tile_gemm_dual`` fp8 branch (Pallas, interpret mode) within 1e-6, scaled;
a numpy emulation of K11's K-major stage (the selected-row load into the
swizzled slots, an index outside [0, 4) reading +0, the byte transpose
pass, rank-order split sums, the ws-first flush into (O, B)) reproduces
JAX's ``nm_spmm_gather_fp8`` (interpret, raw and scaled) within 1e-6,
scaled.  The emulations model the order of the sums, not the tensor cores'
internal precision (each partial is exact, then rounded to fp32); the
card's gate is 1e-2.  On the card (``cuda``): both kernels bitwise the same
across launches at B in {1, 8, 16, 32, 64, 256, 1024} (K11 at multiples of
16) and at split boundaries, within 1e-2 of max|plain|, requantized codes
one e4m3 step off on at most 0.1%; an index outside [0, 4) reads +0 in
K11's new body; plans the C entries refuse raise."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm_gather.kernel import (KMAJOR_B, KMAJOR_STREAM64_MIN_STEPS,
                                                       KMAJOR_STREAM_MAX_ROWS, kmajor_fp8_plan,
                                                       nm_spmm_gather_fp8)
from repro_torch.kernels.tile_gemm.kernel import (DUAL_STREAM_MIN_SPLIT, FP8_DUAL_WGMMA_COLS,
                                                  FP8_STREAM16_BLOCKS_PER_SM,
                                                  SMS, WGMMA_MIN_ROWS, WGMMA_ROWS, cluster_split,
                                                  fp8_dual_plan, tile_gemm_dual_fp8,
                                                  tile_gemm_dual_fp8_requant)
from test_torch_fp8_sparse_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans,
                                            _byte_perm, _bytes_of, _e4m3_f32, _gather_byte, _j,
                                            _silu, _step_share, _word)
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

FP8 = torch.float8_e4m3fn
ARCHS = ["internlm2_1_8b", "qwen3_moe_235b_a22b"]
ROWS = [1, 8, 16, 17, 32, 33, 64, 65, 128, 255, 256, 1024]
K11_ROWS = [16, 32, 64, 256, 1024]
MESH = 2


def _cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def _k11_sites(arch):
    """K11's two row-parallel sites on a (1, 2) mesh: wo and w_out's local
    (K_eff, O)."""
    cfg = _cfg(arch)
    return [(cfg.attn_dim // MESH, cfg.d_model), (cfg.d_ff // MESH, cfg.d_model)]


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_fp8_dual_plan(arch, b):
    """The dense dual: the 16-row stream (split at FP8_STREAM16_BLOCKS_PER_SM
    blocks an SM) at decode rows and below WGMMA_MIN_ROWS where it splits K
    DUAL_STREAM_MIN_SPLIT ways, else wgmma (128 rows x FP8_DUAL_WGMMA_COLS
    channels of each weight, split 1); requant never wgmma: there the 16-row
    stream while its launch has at most FP8_STREAM16_BLOCKS_PER_SM x SMS
    tiles, else the shared body."""
    cfg = _cfg(arch)
    k, o = cfg.d_model, cfg.d_ff
    t16 = (o // 64) * -(-b // 16)
    s16 = cluster_split(t16, k // 64, FP8_STREAM16_BLOCKS_PER_SM)
    stream = {"body": "stream", "rows": 16, "cols": 64, "split": s16}
    for requant in (False, True):
        p = fp8_dual_plan(b, k, o, requant)
        if b <= 16 or (b < WGMMA_MIN_ROWS and s16 >= DUAL_STREAM_MIN_SPLIT):
            assert p == stream
            assert t16 * s16 <= FP8_STREAM16_BLOCKS_PER_SM * SMS or s16 == 1
        elif not requant:
            assert p == {"body": "wgmma", "rows": WGMMA_ROWS, "cols": FP8_DUAL_WGMMA_COLS,
                         "split": 1}
        elif t16 <= FP8_STREAM16_BLOCKS_PER_SM * SMS:
            assert p == stream
        else:
            assert p == {"body": "shared", "rows": 64, "cols": 64, "split": 1}
        _assert_spans(k, p["split"])
        assert not (requant and p["body"] == "wgmma")
    if b >= WGMMA_MIN_ROWS:
        assert fp8_dual_plan(b, k, o)["body"] == "wgmma"


def test_fp8_dual_plan_at_the_measured_shapes():
    """internlm2-1.8b's gate-up: the 16-row stream at split 2 at B = 8, wgmma
    from 17 rows (the requantizing form: the 16-row stream to 48 rows, the
    shared body from 49); qwen3-moe's expert gate-up: split 8 at B = 8 and
    17, the 16-row stream to 64 rows, wgmma from 65 (requant: the 16-row
    stream to 256 rows, the shared body from 265)."""
    stream16 = {"body": "stream", "rows": 16, "cols": 64}
    shared = {"body": "shared", "rows": 64, "cols": 64, "split": 1}
    assert fp8_dual_plan(8, 2048, 8192) == {**stream16, "split": 2}
    assert fp8_dual_plan(8, 2048, 8192, requant=True) == fp8_dual_plan(8, 2048, 8192)
    for b in (17, 33, 64, 128, 256):
        assert fp8_dual_plan(b, 2048, 8192)["body"] == "wgmma"
    assert fp8_dual_plan(48, 2048, 8192, requant=True) == {**stream16, "split": 1}
    assert fp8_dual_plan(49, 2048, 8192, requant=True) == shared
    assert fp8_dual_plan(8, 4096, 1536) == fp8_dual_plan(17, 4096, 1536) == \
        {**stream16, "split": 8}
    assert fp8_dual_plan(33, 4096, 1536) == fp8_dual_plan(64, 4096, 1536) == \
        {**stream16, "split": 4}
    assert fp8_dual_plan(128, 4096, 1536)["body"] == "wgmma"
    assert fp8_dual_plan(128, 4096, 1536, requant=True) == {**stream16, "split": 2}
    assert fp8_dual_plan(256, 4096, 1536, requant=True) == {**stream16, "split": 1}
    assert fp8_dual_plan(265, 4096, 1536, requant=True) == shared


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", K11_ROWS)
def test_kmajor_fp8_plan(arch, b):
    """K11 fp8 at n in {1, 2} up to KMAJOR_STREAM_MAX_ROWS rows: the K-major
    stream over 16-row tiles, split at FP8_STREAM16_BLOCKS_PER_SM blocks an
    SM; past that many x SMS tiles, over 64-row tiles at cluster_split's
    split where each block walks KMAJOR_STREAM64_MIN_STEPS steps or more;
    above those rows and at n = 4 shared."""
    for k, o in _k11_sites(arch):
        for n in (1, 2):
            steps = k * n // 4 // 64
            p = kmajor_fp8_plan(b, k, o, n)
            t16 = (o // 64) * (b // 16)
            s64 = cluster_split((o // 64) * -(-b // 64), steps)
            if b > KMAJOR_STREAM_MAX_ROWS:
                assert p == {"body": "shared", "rows": 64, "cols": 64, "split": 1}
            elif t16 > FP8_STREAM16_BLOCKS_PER_SM * SMS and \
                    steps // s64 >= KMAJOR_STREAM64_MIN_STEPS:
                assert p == {"body": "stream", "rows": 64, "cols": 64, "split": s64}
            else:
                assert p == {"body": "stream", "rows": 16, "cols": 64,
                             "split": cluster_split(t16, steps, FP8_STREAM16_BLOCKS_PER_SM)}
            _assert_spans(k * n // 4, p["split"])
        assert kmajor_fp8_plan(b, k, o, 4) == {"body": "shared", "rows": 16 if b <= 16 else 64,
                                               "cols": 64, "split": 1}


def test_kmajor_fp8_plan_at_the_measured_shapes():
    """internlm2-1.8b's local wo (1024, 2048) and w_out (4096, 2048) at B =
    32: 2 x 32 tiles, split 4 at both sites and both n; at B = 256 (the
    prefill chunks of a sharded run) w_out on the 64-row stream at split 2,
    wo on the 16-row one unsplit; at 1,024 rows the shared body."""
    for n in (1, 2):
        for k in (1024, 4096):
            assert kmajor_fp8_plan(32, k, 2048, n) == {"body": "stream", "rows": 16,
                                                       "cols": 64, "split": 4}
        assert kmajor_fp8_plan(256, 4096, 2048, n) == {"body": "stream", "rows": 64,
                                                       "cols": 64, "split": 2}
        assert kmajor_fp8_plan(256, 1024, 2048, n) == {"body": "stream", "rows": 16,
                                                       "cols": 64, "split": 1}
        assert kmajor_fp8_plan(1024, 4096, 2048, n)["body"] == "shared"


@pytest.mark.parametrize("k", [192, 320, 1152, 2048, 4096, 8192])
@pytest.mark.parametrize("b", [1, 8, 16, 32, 64, 256])
def test_split_spans_are_whole_steps_covering_k(k, b):
    for o in (64, 1536, 2048, 8192):
        _assert_spans(k, fp8_dual_plan(b, k, o)["split"])
        _assert_spans(k, fp8_dual_plan(b, k, o, requant=True)["split"])
        if b % KMAJOR_B == 0:
            for n in (1, 2):
                if (k * n // 4) % 64 == 0:
                    _assert_spans(k * n // 4, kmajor_fp8_plan(b, k, o, n)["split"])


# -------------------------------------------------- every body fits a block
def _dense_dual_stream_smem(bm):
    """nm_spmm_sp_fp8.cuh, DUAL at N = 4: a 4-deep ring of both weights'
    unpadded 64 x 64 values tiles and one X tile, a two-plane inbox (the A
    operand comes from the landed tiles: no private tiles)."""
    stage = 2 * 64 * 64 + bm * 80
    return max(4 * stage, 2 * bm * 68 * 4) + 2 * bm * 64 * 4


def _kmajor_stream_smem(bm, kc, split):
    """nm_spmm_sp_fp8.cuh, KM: the ring of the values tile and the [64][bm]
    X tile, the compact X tile, the span's indices, the inbox."""
    stages = 6 if bm == 16 else 4
    stage = 64 * 64 + 64 * bm
    ring = max(stages * stage, bm * 68 * 4)
    idx = -(-(kc // 64) // split) * 64 * 4
    return ring + bm * 80 + idx + bm * 64 * 4


def _wgmma_dual_smem():
    """tile_gemm_sm90_fp8.cuh, DUAL: four 48 KB stages (X, both K-major and
    both raw tiles), 3 x 4 mbarriers, two 64 x 36 fp32 epilogue tiles, 1 KB
    of slack: the single's bytes."""
    return 4 * (128 * 128 + 2 * 64 * 128 + 2 * 128 * 64) + 3 * 4 * 8 + 2 * 64 * 36 * 4 + 1024


def _kmajor_worst():
    """The largest K-major block the plans launch at K11's local shapes."""
    worst = {16: 0, 64: 0}
    for arch in ARCHS:
        for k, o in _k11_sites(arch):
            for n in (1, 2):
                for b in K11_ROWS:
                    p = kmajor_fp8_plan(b, k, o, n)
                    kc = k * n // 4
                    worst[p["rows"]] = max(worst[p["rows"]],
                                           _kmajor_stream_smem(p["rows"], kc, p["split"]))
    return worst


@pytest.mark.parametrize("body", ["dense dual stream 16", "dense dual stream 64",
                                  "kmajor stream 16", "kmajor stream 64", "wgmma dual"])
def test_every_new_body_fits_a_block(body):
    """At the blocks an SM the plans' splits assume: FP8_STREAM16_BLOCKS_PER_SM
    16-row blocks (the K-major span's indices at the plans' largest), two
    64-row blocks (cluster_split's default) and one wgmma block an SM."""
    bytes_, per_sm = {
        "dense dual stream 16": (_dense_dual_stream_smem(16), FP8_STREAM16_BLOCKS_PER_SM),
        "dense dual stream 64": (_dense_dual_stream_smem(64), 2),
        "kmajor stream 16": (_kmajor_worst()[16], FP8_STREAM16_BLOCKS_PER_SM),
        "kmajor stream 64": (_kmajor_worst()[64], 2),
        "wgmma dual": (_wgmma_dual_smem(), 1)}[body]
    assert 0 < bytes_ <= SMEM_LIMIT, body
    assert per_sm * (bytes_ + BLOCK_RESERVED) <= SM_SMEM, body


def test_the_dense_dual_stream_fits_three_blocks():
    """~45 KB a 16-row dense dual block (4 stages, no private tiles): three
    an SM, the split's assumption."""
    b16 = _dense_dual_stream_smem(16)
    assert 44 * 1024 < b16 < 46 * 1024
    assert FP8_STREAM16_BLOCKS_PER_SM * (b16 + BLOCK_RESERVED) <= SM_SMEM


# ------------------------------------------------- emulations of the bodies
def _vslot(r: int, j: int) -> int:
    """nm_spmm_sp_fp8.cuh::vslot: chunk j of K row r in the unpadded dense
    values tile, XORed with r's 4-row block mod 4."""
    return r * 64 + 16 * (j ^ ((r >> 2) & 3))


def _landed(vs: np.ndarray) -> np.ndarray:
    """The dense values tile (64 K rows x 64 channels) as cp.async lands it."""
    tile = np.zeros(64 * 64, np.uint8)
    for r in range(64):
        for j in range(4):
            tile[_vslot(r, j):_vslot(r, j) + 16] = vs[r, 16 * j:16 * j + 16]
    return tile


def _krow(lane: int) -> int:
    """The K row (of a 32-deep half) whose address lane 8m + i gives
    ldmatrix: matrix 0 rows 4i', 4i' + 1, matrix 1 rows 4i' + 2, 4i' + 3,
    matrices 2, 3 the same 16 rows on."""
    m, i = lane >> 3, lane & 7
    return 16 * (m >> 1) + 4 * (i >> 1) + 2 * (m & 1) + (i & 1)


def _dense_a_fragments(tile: np.ndarray, jc: int) -> list:
    """Each lane's A registers (two k32 halves x 4) for the warp tile of
    chunk jc: ldmatrix .x4 .trans on b16 (lane 4g + t gets, from matrix m,
    the channel pair 2g, 2g + 1 of the matrix's rows 2t and 2t + 1), then
    __byte_perm 0x6420 / 0x7531."""
    regs = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a = []
        for h in range(2):
            q = []
            for m in range(4):
                rows = [tile[_vslot(32 * h + _krow(8 * m + i), jc):][:16] for i in range(8)]
                q.append(_word(np.array([rows[2 * t][2 * g], rows[2 * t][2 * g + 1],
                                         rows[2 * t + 1][2 * g], rows[2 * t + 1][2 * g + 1]])))
            a += [_byte_perm(q[0], q[1], 0x6420), _byte_perm(q[0], q[1], 0x7531),
                  _byte_perm(q[2], q[3], 0x6420), _byte_perm(q[2], q[3], 0x7531)]
        regs.append(a)
    return regs


def _check_dense_fragments(vs: np.ndarray) -> None:
    """Every warp tile's A registers are mma m16n8k32's A fragment of its 16
    channels with A row g = channel 2g, row g + 8 = channel 2g + 1 (lane 4g
    + t: rows g, g + 8 at K bytes 4t .. + 3 and 16 + 4t .. + 3 of each
    32-deep half), the map the partial store undoes."""
    tile = _landed(vs)
    for jc in range(4):
        regs = _dense_a_fragments(tile, jc)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for h in range(2):
                for r, (ch, k0) in enumerate(((2 * g, 4 * t), (2 * g + 1, 4 * t),
                                              (2 * g, 16 + 4 * t), (2 * g + 1, 16 + 4 * t))):
                    want = vs[32 * h + k0:32 * h + k0 + 4, 16 * jc + ch]
                    assert _bytes_of(regs[lane][4 * h + r]) == list(want), (jc, lane, h, r)


def _dense_stream_acc(xb: np.ndarray, wb: np.ndarray, split: int) -> np.ndarray:
    """The dense stream's sums for one weight: per 64-deep step, each warp
    tile's A registers read from the landed tile (checked against the mma's
    A fragment), the two k32 halves' exact sums added into one partial from
    zero, rounded to fp32, added in fp32 over block r's span of steps, the
    blocks' partials added in rank order."""
    k, o = wb.shape
    steps = k // 64
    xf, wf = _e4m3_f32(xb).astype(np.float64), _e4m3_f32(wb).astype(np.float64)
    acc = None
    for r in range(split):
        part = np.zeros((xb.shape[0], o), np.float32)
        for s in range(r * steps // split, (r + 1) * steps // split):
            for n0 in range(0, o, 64):
                _check_dense_fragments(wb[64 * s:64 * s + 64, n0:n0 + 64])
            lo = xf[:, 64 * s:64 * s + 32] @ wf[64 * s:64 * s + 32]
            hi = xf[:, 64 * s + 32:64 * s + 64] @ wf[64 * s + 32:64 * s + 64]
            part = (part + (lo + hi).astype(np.float32)).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def _transpose_chunk(raw: np.ndarray, c: int, g: int, odd: int, wk: np.ndarray) -> None:
    """tile_gemm_sm90_fp8.cuh::transpose_chunk<RP> for lane g of one weight's
    raw [128][RP] tile: K rows 16c .. + 15 (read in pairs swapped when odd)
    of channels 4g .. + 3 into rows 4g + j of the K-major [RP][128] tile,
    chunk c at position c ^ (row & 7) (the 128-byte swizzle)."""
    v = [_word(raw[16 * c + (r ^ odd), 4 * g:4 * g + 4]) for r in range(16)]
    w = [v[r ^ odd] for r in range(16)]
    for jj in range(4):
        j = (jj + (g >> 1)) & 3
        row = 4 * g + j
        out = []
        for q in range(4):
            out += _bytes_of(_gather_byte(w[4 * q:4 * q + 4], j))
        pos = (c ^ (row & 7)) * 16
        wk[row, pos:pos + 16] = out


def _wgmma_dual_tiles(wb: np.ndarray, kb: int, n0: int, w: int) -> np.ndarray:
    """The dual wgmma body's K-major tile of weight w (lanes 16w .. 16w + 15
    of the three transposer warps) for K stage kb and channels n0 .. + 63,
    read back through the swizzle as wgmma does: (64 channels, 128 K)."""
    raw = wb[128 * kb:128 * kb + 128, n0:n0 + 64]
    wk = np.zeros((64, 128), np.uint8)
    for c in range(8):
        for g in range(16):
            _transpose_chunk(raw, c, g, w, wk)
    out = np.zeros_like(wk)
    for row in range(64):
        for c in range(8):
            pos = (c ^ (row & 7)) * 16
            out[row, 16 * c:16 * c + 16] = wk[row, pos:pos + 16]
    return out


def _wgmma_dual_acc(xb: np.ndarray, wgb: np.ndarray, wub: np.ndarray) -> tuple:
    """The dual wgmma body's sums: per 128-row x 64-channel tile and 128-deep
    stage, both weights' K-major tiles (checked against the plain transpose),
    each stage's exact partial rounded to fp32 and added in fp32 in stage
    order (the promotion every 128 K)."""
    b, k = xb.shape
    o = wgb.shape[1]
    xf = _e4m3_f32(xb).astype(np.float64)
    accs = [np.zeros((b, o), np.float32), np.zeros((b, o), np.float32)]
    for m0 in range(0, b, 128):
        for n0 in range(0, o, 64):
            for w, wb in enumerate((wgb, wub)):
                acc = np.zeros((min(128, b - m0), 64), np.float32)
                for kb in range(k // 128):
                    tile = _wgmma_dual_tiles(wb, kb, n0, w)
                    assert np.array_equal(tile, wb[128 * kb:128 * kb + 128, n0:n0 + 64].T)
                    p = xf[m0:m0 + 128, 128 * kb:128 * kb + 128] @ \
                        _e4m3_f32(tile).astype(np.float64).T
                    acc = (acc + p.astype(np.float32)).astype(np.float32)
                accs[w][m0:m0 + 128, n0:n0 + 64] = acc
    return accs


def _dense_inputs(seed, b, k, o):
    from repro_torch.core import quantize as tquant
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0
    xq, xs = tquant.quantize_rows(torch.from_numpy(x), FP8)
    ws = []
    for _ in range(2):
        leaf = tquant.quantize_linear({"w": torch.from_numpy(
            rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)}, FP8)
        ws.append((leaf["w"], leaf["scale"].reshape(1, -1)))
    return xq, xs, ws


def _dual_flush(acc_g, acc_u, xs, sg, su):
    t_g = ((acc_g * xs).astype(np.float32) * sg).astype(np.float32)
    t_u = ((acc_u * xs).astype(np.float32) * su).astype(np.float32)
    return (_silu(t_g) * t_u).astype(np.float32)


def _jax_dual(jnp, xq, xs, ws, requant=None):
    from repro.kernels import epilogue as jepi
    from repro.kernels.tile_gemm.kernel import tile_gemm_dual as j_dual
    (wg, sg), (wu, su) = ws
    args = [_j(jnp, t) for t in (xq, wg, wu, xs, sg, su)]
    if requant is None:
        return np.asarray(j_dual(*args, acc_dtype=jnp.float32, out_dtype=jnp.float32,
                                 interpret=True))
    return np.asarray(j_dual(*args, acc_dtype=jnp.float32, interpret=True,
                             epilogue=jepi.EpilogueSpec(act="silu_mul",
                                                        requant="float8_e4m3fn"),
                             requant_scale=jnp.asarray(requant)))


@pytest.mark.parametrize("k,o", [(320, 64), (448, 128)])
def test_dense_dual_stream_reproduces_pallas(k, o):
    """K = 320 / 448: five / seven 64-deep steps over the plan's split of 4
    (uneven spans), four / eight warp tiles of 16 channels: the emulated
    stream, dual flush and requantized store against JAX's tile_gemm_dual
    fp8 branch (interpret)."""
    jnp = pytest.importorskip("jax.numpy")
    b = 8
    p = fp8_dual_plan(b, k, o)
    assert p["body"] == "stream" and p["split"] == 4 and (k // 64) % p["split"]
    xq, xs, ws = _dense_inputs(k + o, b, k, o)
    xb = xq.view(torch.uint8).numpy()
    acc_g, acc_u = (_dense_stream_acc(xb, w.view(torch.uint8).numpy(), p["split"])
                    for w, _ in ws)
    got = _dual_flush(acc_g, acc_u, xs.numpy(), ws[0][1].numpy(), ws[1][1].numpy())
    want = _jax_dual(jnp, xq, xs, ws)
    assert_scaled_close(got, want, 1e-6)
    # the requantized store: clip(y / rq, +-448), the round-to-nearest-even cast
    rq = np.float32(np.abs(want).max() / 300)
    codes = np.asarray(jnp.asarray(np.clip(got / rq, -448, 448)).astype(jnp.float8_e4m3fn))
    want_q = _jax_dual(jnp, xq, xs, ws, requant=rq)
    assert _step_share(codes.view(np.uint8), want_q.view(np.uint8)) <= 1e-3


def test_wgmma_dual_order_reproduces_pallas():
    """256 rows (two 128-row tiles), K = 256 (two 128-deep stages), O = 128
    (two 64-channel tiles of each weight): the transposers' swizzled K-major
    tiles of both weights (the up lanes reading rows in swapped pairs), the
    128-deep partials promoted in order, the dual flush, against JAX's
    tile_gemm_dual fp8 branch (interpret)."""
    jnp = pytest.importorskip("jax.numpy")
    b, k, o = 256, 256, 128
    assert fp8_dual_plan(b, k, o)["body"] == "wgmma"
    xq, xs, ws = _dense_inputs(7, b, k, o)
    acc_g, acc_u = _wgmma_dual_acc(xq.view(torch.uint8).numpy(),
                                   *(w.view(torch.uint8).numpy() for w, _ in ws))
    got = _dual_flush(acc_g, acc_u, xs.numpy(), ws[0][1].numpy(), ws[1][1].numpy())
    assert_scaled_close(got, _jax_dual(jnp, xq, xs, ws), 1e-6)


def test_dense_a_operand_reads_distinct_bank_groups():
    """Each ldmatrix matrix's eight K rows of one 16-channel chunk sit in
    eight distinct 16-byte bank groups of the swizzled tile (one phase)."""
    for h in range(2):
        for jc in range(4):
            for m in range(4):
                groups = {(_vslot(32 * h + _krow(8 * m + i), jc) // 16) % 8 for i in range(8)}
                assert len(groups) == 8


def test_wgmma_dual_transposers_read_distinct_banks():
    """In each of a transposer warp's 16 loads, the gate's 16 lanes and the
    up's 16 (rows of opposite parity, the raw tiles 8 KB apart) read 32
    distinct banks."""
    for c in range(8):
        for r in range(16):
            banks = set()
            for lane in range(32):
                w, g = lane >> 4, lane & 15
                addr = w * 8192 + (16 * c + (r ^ w)) * 64 + 4 * g
                banks.add((addr // 4) % 32)
            assert len(banks) == 32


def _kslot(r: int, ch: int, cpr: int) -> int:
    """nm_spmm_sp_fp8.cuh::kslot."""
    return (r * cpr + ch) ^ ((r >> 2) & 7)


def _kmajor_tile(xtb, idx, n, s, m0, bm, b):
    """The K-major X stage of step s for the row tile at m0: compressed row
    r's x_t row (c / n) * 4 + idx[c] (c = 64 s + r), BM batch bytes in
    16-byte chunks at their swizzled slots; an index outside [0, 4) or
    columns at or past b land as zeros."""
    cpr = bm // 16
    tile = np.zeros(64 * bm, np.uint8)
    for r in range(64):
        c = 64 * s + r
        e = int(idx[c])
        for ch in range(cpr):
            col = m0 + 16 * ch
            slot = _kslot(r, ch, cpr)
            if 0 <= e < 4 and col < b:
                tile[16 * slot:16 * slot + 16] = xtb[c // n * 4 + e, col:col + 16]
    return tile


def _kmajor_transpose(tile: np.ndarray, bm: int) -> np.ndarray:
    """The transpose pass: unit u = (chunk u / 64, K block (u / 4) % 16, word
    u % 4) turns a 4 x 4 byte block into four batch rows' K words of the
    compact [bm][64] X tile."""
    cpr = bm // 16
    compact = np.zeros((bm, 64), np.uint8)
    for u in range(64 * cpr):
        w, q, ch = u & 3, (u >> 2) & 15, u >> 6
        wd = [_word(tile[16 * _kslot(4 * q + r, ch, cpr) + 4 * w:][:4]) for r in range(4)]
        for j in range(4):
            compact[16 * ch + 4 * w + j, 4 * q:4 * q + 4] = _bytes_of(_gather_byte(wd, j))
    return compact


def _kmajor_acc(xtb, idx, vb, n, bm, split):
    """K11's stream sums, (B, O): per row tile, block r of the split walks
    its span of 64-deep steps (the landed tile, the transpose pass, checked
    against the plain gather; each step's exact partial rounded to fp32 and
    added in fp32), the blocks' partials added in rank order."""
    ke, b = xtb.shape
    kc, o = vb.shape
    steps = kc // 64
    vf = _e4m3_f32(vb).astype(np.float64)
    cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
    plain = np.where(((idx >= 0) & (idx < 4))[:, None], xtb[cols], 0).astype(np.uint8)  # (kc, b)
    out = np.zeros((b, o), np.float32)
    for m0 in range(0, b, bm):
        acc = None
        for r in range(split):
            part = np.zeros((bm, o), np.float32)
            for s in range(r * steps // split, (r + 1) * steps // split):
                xg = _kmajor_transpose(_kmajor_tile(xtb, idx, n, s, m0, bm, b), bm)
                live = min(bm, b - m0)
                assert np.array_equal(xg[:live], plain[64 * s:64 * s + 64, m0:m0 + live].T)
                assert not xg[live:].any()
                p = _e4m3_f32(xg).astype(np.float64) @ vf[64 * s:64 * s + 64]
                part = (part + p.astype(np.float32)).astype(np.float32)
            acc = part if acc is None else (acc + part).astype(np.float32)
        out[m0:m0 + bm] = acc[:min(bm, b - m0)]
    return out


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [32, 48])
def test_kmajor_stage_reproduces_pallas(n, b):
    """K_c = 320: five 64-deep steps over the plan's split of 4 (uneven
    spans), row tiles of 16; indices outside [0, 4) read +0: the emulated
    load, transpose pass, sums and ws-first flush against JAX's
    nm_spmm_gather_fp8 (interpret), raw and scaled, in (O, B)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_fp8 as j_k11
    from repro_torch.core import quantize as tquant

    rng = np.random.default_rng(80 + n + b)
    kc, o = 320, 64
    ke = kc * 4 // n
    p = kmajor_fp8_plan(b, ke, o, n)
    assert p == {"body": "stream", "rows": 16, "cols": 64, "split": 4}
    idx = np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                  -1).reshape(-1).astype(np.int32)
    idx[3], idx[kc // 2 + 5], idx[kc - 2] = 7, -1, 4
    xq, xs = tquant.quantize_rows(torch.from_numpy(rng.standard_normal((b, ke))
                                                   .astype(np.float32)), FP8)
    leaf = tquant.quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)}, FP8)
    vq, ws = leaf["w"], leaf["scale"].reshape(-1, 1)
    xt = xq.view(torch.uint8).numpy().T.copy()          # x_t (K_eff, B)
    acc = _kmajor_acc(xt, idx, vq.view(torch.uint8).numpy(), n, p["rows"], p["split"])
    acc_t = acc.T                                        # the (O, B) store
    xt_t = torch.from_numpy(xt).view(FP8)
    xs_t = xs.reshape(1, -1)
    kw = dict(block_ke=ke, interpret=True)
    raw = np.asarray(j_k11(_j(jnp, xt_t), _j(jnp, vq), jnp.asarray(idx.reshape(-1, 1)), None,
                           None, n, **kw))
    assert_scaled_close(acc_t, raw, 1e-6)
    got = ((acc_t * ws.numpy()).astype(np.float32) * xs_t.numpy()).astype(np.float32)
    want = np.asarray(j_k11(_j(jnp, xt_t), _j(jnp, vq), jnp.asarray(idx.reshape(-1, 1)),
                            _j(jnp, xs_t), _j(jnp, ws), n, out_dtype=jnp.float32, **kw))
    assert_scaled_close(got, want, 1e-6)


@pytest.mark.parametrize("bm", [16, 64])
def test_kmajor_transpose_pass_reads_distinct_banks(bm):
    """For each of the four loads of the transpose pass, a warp's 32 lanes
    (eight K blocks x four words of one chunk) read 32 distinct banks of the
    swizzled [64][bm] tile."""
    cpr = bm // 16
    for warp_units in range(0, 64 * cpr, 32):
        for r in range(4):
            banks = set()
            for u in range(warp_units, warp_units + 32):
                w, q, ch = u & 3, (u >> 2) & 15, u >> 6
                banks.add((4 * _kslot(4 * q + r, ch, cpr) + w) % 32)
            assert len(banks) == 32


def test_kslot_is_a_permutation():
    for cpr in (1, 4):
        slots = [_kslot(r, ch, cpr) for r in range(64) for ch in range(cpr)]
        assert sorted(slots) == list(range(64 * cpr))


# ----------------------------------------------------------- on the card
def _dense_dual_case(dev, b, k, o, seed=0):
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    ws, scales = [], []
    for _ in range(2):
        leaf = quantize_linear({"w": torch.randn(k, o, generator=g, device=dev) * k ** -0.5},
                               FP8)
        ws.append(leaf["w"])
        scales.append(leaf["scale"].reshape(1, -1))
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0
    xq, xs = quantize_rows(x, FP8)
    return (xq, *ws, xs, *scales)


def _k11_case(dev, b, k, o, n, seed=0):
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                          quantize=FP8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    xq, xs = quantize_rows(x, FP8)
    x_t = xq.view(torch.uint8).t().contiguous().view(FP8)
    return x_t, leaf["values"], leaf["gather_idx"], xs.reshape(1, -1), leaf["scale"].reshape(-1, 1)


def _ordinal_steps(got, want):
    def ordinal(t):
        c = t.view(torch.uint8).int()
        return torch.where(c >= 128, -(c - 128), c)
    d = (ordinal(got) - ordinal(want)).abs()
    assert d.max().item() <= 1
    return (d == 1).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(2048, 8192), (4096, 1536)])
@pytest.mark.parametrize("b", [1, 8, 16, 32, 64, 256, 1024])
def test_dense_dual_fp8_bitwise_and_close_on_card(cuda_device, b, k, o):
    """internlm2-1.8b's and qwen3-moe's expert gate-up: bf16 and fp32 stores
    within 1e-2 of the plain version, the requantized codes one step off on
    at most 0.1%, the same bits on every launch."""
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_quantized_ref
    args = _dense_dual_case(cuda_device, b, k, o, seed=b)
    before = tile_gemm_dual_fp8.launches
    first = tile_gemm_dual_fp8(*args, out_dtype=torch.bfloat16)
    again = [tile_gemm_dual_fp8(*args, out_dtype=torch.bfloat16) for _ in range(2)]
    y32 = tile_gemm_dual_fp8(*args)
    torch.cuda.synchronize()
    assert tile_gemm_dual_fp8.launches == before + 4
    assert all(torch.equal(first, y) for y in again)
    assert_scaled_close(first, tile_gemm_dual_quantized_ref(*args, out_dtype=torch.bfloat16),
                        1e-2)
    want32 = tile_gemm_dual_quantized_ref(*args)
    assert_scaled_close(y32, want32, 1e-2)
    rq = (want32.abs().amax() / 448).reshape(())
    codes = tile_gemm_dual_fp8_requant(*args, rq)
    torch.cuda.synchronize()
    assert codes.dtype == FP8
    assert _ordinal_steps(codes, tile_gemm_dual_quantized_ref(*args, requant_scale=rq)) <= 1e-3
    assert torch.equal(codes, tile_gemm_dual_fp8_requant(*args, rq))


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(320, 64), (448, 128), (1216, 256), (1088, 512)])
@pytest.mark.parametrize("b", [1, 8, 300])
def test_dense_dual_fp8_at_split_boundaries_on_card(cuda_device, k, o, b):
    """K = 64 x steps not divisible by the split (uneven spans per block);
    at 300 rows the wgmma body's K tail past a 128-deep stage and a ragged
    row tile."""
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_quantized_ref
    args = _dense_dual_case(cuda_device, b, k, o)
    p = fp8_dual_plan(b, k, o)
    got = tile_gemm_dual_fp8(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, tile_gemm_dual_quantized_ref(*args), 1e-2)
    assert p["body"] == "wgmma" or (p["split"] > 1 and (k // 64) % p["split"]), p
    assert torch.equal(got, tile_gemm_dual_fp8(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", K11_ROWS)
def test_kmajor_fp8_bitwise_and_close_on_card(cuda_device, n, b):
    """internlm2-1.8b's local w_out (4096, 2048): the raw accumulator and the
    scaled bf16 store against the plain version, the same bits on every
    launch."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_t_quantized_ref
    x_t, v, idx, xs, ws = _k11_case(cuda_device, b, 4096, 2048, n, seed=b)
    before = nm_spmm_gather_fp8.launches
    raw = nm_spmm_gather_fp8(x_t, v, idx, None, None, n)
    again = [nm_spmm_gather_fp8(x_t, v, idx, None, None, n) for _ in range(2)]
    y = nm_spmm_gather_fp8(x_t, v, idx, xs, ws, n, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert nm_spmm_gather_fp8.launches == before + 4
    assert raw.shape == (2048, b) and raw.dtype == torch.float32
    assert all(torch.equal(raw, r) for r in again)
    assert_scaled_close(raw, nm_spmm_gather_t_quantized_ref(x_t, v, idx, None, None, n), 1e-2)
    assert_scaled_close(y, nm_spmm_gather_t_quantized_ref(x_t, v, idx, xs, ws, n,
                                                          out_dtype=torch.bfloat16), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(1280, 64), (1792, 128), (4864, 256), (4352, 512)])
@pytest.mark.parametrize("b", [16, 32, 256])
def test_kmajor_fp8_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K_c = 64 x steps not divisible by the split."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_t_quantized_ref
    if (k * n // 4) % 64:
        pytest.skip(f"K_c = {k * n // 4} is not a multiple of 64 at n = {n}")
    x_t, v, idx, xs, ws = _k11_case(cuda_device, b, k, o, n)
    got = nm_spmm_gather_fp8(x_t, v, idx, None, None, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_gather_t_quantized_ref(x_t, v, idx, None, None, n), 1e-2)
    assert torch.equal(got, nm_spmm_gather_fp8(x_t, v, idx, None, None, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [32, 256])
def test_kmajor_fp8_index_outside_the_block_reads_zero_on_card(cuda_device, n, b):
    """An index outside [0, 4) loads +0 rows in the K-major stream, against
    the plain product on the zeroed rows."""
    x_t, v, idx, xs, ws = _k11_case(cuda_device, b, 2048, 1024, n, seed=3)
    assert kmajor_fp8_plan(b, 2048, 1024, n)["body"] == "stream"
    idx = idx.clone()
    idx[1], idx[70], idx[-1] = 9, -1, 4
    got = nm_spmm_gather_fp8(x_t, v, idx, None, None, n)
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < 4)
    rows = torch.arange(idx.numel(), device=cuda_device) // n * 4 + idx.clamp(0, 3).long()
    want = ((x_t.float()[rows] * ok[:, None]).t() @ v.float()).t()
    assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
def test_refused_plans_raise_on_card(cuda_device):
    lib = _build.library("gemm_fp8.cu")
    xq, wg, wu, xs, sg, su = _dense_dual_case(cuda_device, 8, 256, 64)
    y = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda_device)
    rq = torch.ones((), device=cuda_device)
    # (out_kind, bm, body, bn, split): 0 shared (bn 64, split 1), 1 the stream
    # (bm 16 | 64, bn 64), 2 wgmma (bm 128, bn 64, split 1, no requant)
    for kind, bm, body, bn, split in ((0, 16, 0, 64, 2), (0, 16, 1, 128, 1), (0, 16, 1, 64, 3),
                                      (0, 32, 1, 64, 1), (0, 128, 2, 128, 1), (0, 128, 2, 64, 2),
                                      (0, 64, 2, 64, 1), (3, 128, 2, 64, 1), (0, 16, 3, 64, 1),
                                      (2, 16, 1, 64, 1)):
        rc = lib.vg_tile_gemm_dual_fp8(xq.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                       xs.data_ptr(), sg.data_ptr(), su.data_ptr(),
                                       rq.data_ptr() if kind == 3 else None, y.data_ptr(), 8,
                                       256, 64, kind, bm, body, bn, split, _build.stream_of(xq))
        assert rc != 0, (kind, bm, body, bn, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm_dual_fp8", lib)
    x_t, v, idx, xs, ws = _k11_case(cuda_device, 32, 512, 64, 2)
    y = torch.empty((64, 32), dtype=torch.float32, device=cuda_device)
    # (n, bm, body, split, b): 0 shared (split 1), 1 the stream (n in {1, 2},
    # bm 16 | 64, b a multiple of 16)
    for nn, bm, body, split, b in ((2, 16, 0, 2, 32), (4, 16, 1, 1, 32), (2, 16, 1, 3, 32),
                                   (2, 32, 1, 1, 32), (2, 16, 2, 1, 32), (2, 16, 1, 1, 24),
                                   (2, 16, 1, 16, 32)):
        rc = lib.vg_nm_spmm_gather_fp8(x_t.data_ptr(), v.data_ptr(), idx.data_ptr(), None, None,
                                       y.data_ptr(), b, 512, 64, nn, 2, bm, body, split,
                                       _build.stream_of(x_t))
        assert rc != 0, (nn, bm, body, split, b)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_fp8", lib)
