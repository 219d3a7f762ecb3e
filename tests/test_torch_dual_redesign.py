"""The redesigned Hopper bodies of the float gate-up duals: tile_gemm_dual
(a stream over both dense weights with split-K over a cluster for few
rows; K1's TMA + wgmma body in dual form, two weight tensor maps and a
paired silu(g) * u epilogue, for many) and K9, nm_spmm_gather_dual_bk at
n in {1, 2} (K8's stream landing one X span a step and selecting it twice
for few rows; one gather pass writing both compact X's, then the dual
wgmma body with two X tiles a stage, for many).

On the CPU: both ``dual_plan``s (the stream at internlm2-1.8b's and
qwen3-moe's decode rows and at qwen3-moe's expert chunks, wgmma at
internlm2's 64-row chunks, at the calibration forward's 256 and at
phi-3-vision's 1,024 prefill rows, K9 at n = 4 and at 1:4 over
internlm2's short K_c below 64 rows on the shared body, split spans whole
64-steps covering K); every new body's shared memory fits a block at the
blocks an SM the plans assume; a numpy emulation of both dual selects
(the stream's over a step's span, the many-row pass over whole rows: the
words read once, selected through each weight's indices, an index outside
[0, 4) reading +0) and of both accumulations (the stream's split spans
summed in rank order, the wgmma body's accumulator fragments paired
register by register) with the silu(g) * u epilogue reproduces the JAX
package's ``nm_spmm_gather_dual_bk`` and ``tile_gemm_dual`` (Pallas,
interpret mode) within 1e-6, scaled.  On the card (``cuda``): both duals
bitwise the same across launches at B in {1, 8, 33, 64, 256, 1024} and at
every split boundary, within 1e-2 of max|plain|; an index outside [0, 4)
reads +0 in every body; refused plans raise."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm_gather.kernel import DUAL_SHARED_MAX_KC
from repro_torch.kernels.nm_spmm_gather.kernel import dual_plan as gather_dual_plan
from repro_torch.kernels.nm_spmm_gather.kernel import nm_spmm_gather_dual_bk
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, DUAL_STREAM_MIN_SPLIT,
                                                  DUAL_WGMMA_COLS, MAX_SPLIT, SMS,
                                                  WGMMA_MIN_ROWS, WGMMA_ROWS, dual_plan,
                                                  stream_plan, tile_gemm_dual)
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into (H100)
SM_SMEM = 228 * 1024         # shared memory of an SM
BLOCK_RESERVED = 1024        # shared memory the system keeps for each resident block


def _gate_up(arch):
    """(K, O) of a config's gate-up pair, from get_config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.d_model, cfg.d_ff


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
WANT_WGMMA = {"body": "wgmma", "rows": WGMMA_ROWS, "cols": DUAL_WGMMA_COLS, "split": 1}


@pytest.mark.parametrize("b", [1, 8, 16])
def test_dual_plans_stream_at_decode_rows(b):
    """internlm2-1.8b's decode: 16-row tiles of 64 channels, split 2 (the
    launch fills the card with two blocks an SM: the rings and inbox fit
    twice, see below); qwen3-moe's expert gate-up split 8."""
    for arch, split in (("internlm2_1_8b", 2), ("qwen3_moe_235b_a22b", 8)):
        k, o = _gate_up(arch)
        p = dual_plan(b, k, o)
        assert p == {"body": "stream", "rows": 16, "cols": 64, "split": split}, (arch, p)
        assert (o // 64) * p["split"] <= BLOCKS_PER_SM * SMS
        _assert_spans(k, p["split"])
        for n in (1, 2):
            q = gather_dual_plan(b, k, o, n)
            assert q["body"] == "stream" and q["rows"] == 16 and q["cols"] == 64, (n, q)
            assert q == dual_plan(b, k * n // 4, o)
            _assert_spans(k * n // 4, q["split"])
    assert gather_dual_plan(8, *_gate_up("internlm2_1_8b"), 2)["split"] == 2


@pytest.mark.parametrize("b", [17, 33, 63, 64, 255])
def test_dual_plans_at_chunk_rows(b):
    """64-row tiles: wgmma where the stream would split K fewer than
    DUAL_STREAM_MIN_SPLIT ways (internlm2-1.8b's gate-up: 128 tiles, split
    1), the stream where it splits more (qwen3-moe's expert gate-up at up
    to 64 rows: split 4); K9 at 1:4 over a short K_c on the shared body."""
    k, o = _gate_up("internlm2_1_8b")
    assert stream_plan(b, k, o)["split"] < DUAL_STREAM_MIN_SPLIT
    assert dual_plan(b, k, o) == WANT_WGMMA
    assert gather_dual_plan(b, k, o, 2) == WANT_WGMMA
    # K9 at 1:4 over K_c = 512 keeps the shared body below 64 rows
    assert k // 4 <= DUAL_SHARED_MAX_KC
    want = WANT_WGMMA if b >= 64 else {"body": "shared", "rows": 64, "cols": 64, "split": 1}
    assert gather_dual_plan(b, k, o, 1) == want
    k, o = _gate_up("phi_3_vision_4_2b")      # K_c = 768 at 1:4: the wgmma body
    assert gather_dual_plan(b, k, o, 1) == WANT_WGMMA
    k, o = _gate_up("qwen3_moe_235b_a22b")
    p = dual_plan(b, k, o)
    if b <= 64:
        assert p == {"body": "stream", "rows": 64, "cols": 64, "split": 4}, p
        _assert_spans(k, p["split"])
    else:
        assert p == WANT_WGMMA


@pytest.mark.parametrize("arch,rows", [("phi_3_vision_4_2b", 1024),
                                       ("internlm2_1_8b", WGMMA_MIN_ROWS),
                                       ("internlm2_1_8b", 1024),
                                       ("qwen3_moe_235b_a22b", WGMMA_MIN_ROWS)])
def test_dual_plans_take_wgmma_at_prefill_rows(arch, rows):
    k, o = _gate_up(arch)
    assert dual_plan(rows, k, o) == WANT_WGMMA
    for n in (1, 2):        # the dual pass, then the dual body with its tile over K_c
        assert gather_dual_plan(rows, k, o, n) == dual_plan(rows, k * n // 4, o) == WANT_WGMMA


def test_gather_dual_at_n4_keeps_the_shared_body():
    for b in (1, 8, 64, 1024):
        p = gather_dual_plan(b, 2048, 8192, 4)
        assert p == {"body": "shared", "rows": 16 if b <= 16 else 64, "cols": 64, "split": 1}


@pytest.mark.parametrize("k", [192, 320, 1152, 1216, 2048, 3072, 8192])
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_dual_split_spans_are_whole_steps_covering_k(k, b):
    for o in (64, 1536, 8192):
        _assert_spans(k, dual_plan(b, k, o)["split"])
        for n in (1, 2):
            if (k * n // 4) % 64 == 0:
                _assert_spans(k * n // 4, gather_dual_plan(b, k, o, n)["split"])


# -------------------------------------------------- every body fits a block
def _dual_stream_smem(bm, g=0, stages=None):
    """nm_spmm_sp.cuh's dual form at N = 4: a ring of stages (both 64 x
    (64 + 8) weight tiles, both index slices and one X tile or span), the
    two compact X tiles (gathered), the inbox of both partials."""
    if stages is None:
        stages = 3 if (g == 1 and bm == 16) else (4 if bm == 16 or g == 0 else 3)
    sld = 256 // g + 8 if g else 72
    stage = 2 * 64 * 72 * 2 + (2 * 64 * 4 if g else 0) + bm * sld * 2
    ring = max(stages * stage, 2 * bm * 68 * 4)
    return ring + (2 * bm * 72 * 2 if g else 0) + 2 * bm * 64 * 4


def _dual_wgmma_smem(nx, stages=None, epc=32):
    """tile_gemm_sm90.cuh's dual form: STAGES stages of nx X tiles (128 x 64)
    and both weights' 64 x 128 tiles, the mbarriers, two 64 x (EPC + 4) fp32
    epilogue tiles, 1 KB of alignment slack."""
    stages = stages or (4 if nx == 1 else 3)
    return stages * (nx * 16384 + 32768) + 2 * stages * 8 + 2 * 64 * (epc + 4) * 4 + 1024


@pytest.mark.parametrize("body,bytes_,per_sm", [
    *[(f"dual stream bm={bm}", _dual_stream_smem(bm), 2 if bm == 16 else 1) for bm in (16, 64)],
    *[(f"gathered dual stream n={n} bm={bm}", _dual_stream_smem(bm, n), 2 if bm == 16 else 1)
      for n in (1, 2) for bm in (16, 64)],
    ("dual wgmma, one X", _dual_wgmma_smem(1), 1),
    ("dual wgmma, two X", _dual_wgmma_smem(2), 1)])
def test_every_new_body_fits_a_block(body, bytes_, per_sm):
    assert bytes_ <= SMEM_LIMIT, body
    assert per_sm * (bytes_ + BLOCK_RESERVED) <= SM_SMEM, body   # the blocks an SM planned


def test_the_gathered_dual_at_1of4_takes_a_shallower_ring():
    """Four stages of a 1:4 span (264 bf16 a row) would leave one block an
    SM at 16 rows: the body takes three."""
    assert 2 * (_dual_stream_smem(16, 1, stages=4) + BLOCK_RESERVED) > SM_SMEM
    assert 2 * (_dual_stream_smem(16, 1) + BLOCK_RESERVED) <= SM_SMEM
    # a 64-channel epilogue tile does not fit beside the dual wgmma rings,
    # nor a fourth stage beside two X tiles
    assert _dual_wgmma_smem(1, epc=64) > SMEM_LIMIT
    assert _dual_wgmma_smem(2, epc=64) > SMEM_LIMIT
    assert _dual_wgmma_smem(2, stages=4) > SMEM_LIMIT


# ------------------------------------------- the dual selects, emulated
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
    """sp::pick_half of nm_spmm_sp.cuh."""
    e = np.asarray(e, np.int64)
    s = (2 * (e & 3)).astype(np.uint32)
    sel = (s << 8) | ((s + 1) << 12) if h else s | ((s + 1) << 4)
    keep = np.where((e >= 0) & (e < 4), np.uint32(0xFFFF0000 if h else 0xFFFF), np.uint32(0))
    return _byte_perm(lo, hi, sel) & keep


def _select_unit(wd: np.ndarray, e: np.ndarray, n: int) -> np.ndarray:
    """One unit's eight compressed columns from the unit's words ``wd`` (rows,
    16 / n), read once: 2:4 pair q is M-block q (words 2q, 2q + 1), 1:4
    blocks 2q, 2q + 1 (words 4q .. + 3).  (rows, 8) bf16 bits."""
    out = np.zeros((wd.shape[0], 8), np.uint16)
    for q in range(4):
        if n == 2:
            lo, hi = wd[:, 2 * q], wd[:, 2 * q + 1]
            v = _pick_half(lo, hi, e[2 * q], 0) | _pick_half(lo, hi, e[2 * q + 1], 1)
        else:
            v = _pick_half(wd[:, 4 * q], wd[:, 4 * q + 1], e[2 * q], 0) | \
                _pick_half(wd[:, 4 * q + 2], wd[:, 4 * q + 3], e[2 * q + 1], 1)
        out[:, 2 * q] = (v & 0xFFFF).astype(np.uint16)
        out[:, 2 * q + 1] = (v >> 16).astype(np.uint16)
    return out


def _dual_stream_select(xb, idx_g, idx_u, n):
    """The dual stream's select pass: for each 64-deep step, unit (row,
    columns j0 .. + 7) reads its words of the step's span (256 / n X
    columns) once and selects them through each weight's indices into two
    compact tiles.  Returns both gathered X's, bf16 bits."""
    b = xb.shape[0]
    kc = idx_g.shape[0]
    span = 256 // n
    out = [np.zeros((b, kc), np.uint16) for _ in range(2)]
    for s in range(kc // 64):
        words = np.ascontiguousarray(xb[:, s * span:(s + 1) * span]).view(np.uint32)
        for j0 in range(0, 64, 8):
            wd = words[:, j0 // n * 2:j0 // n * 2 + 16 // n]        # the one read
            for t, idx in enumerate((idx_g, idx_u)):
                out[t][:, 64 * s + j0:64 * s + j0 + 8] = \
                    _select_unit(wd, idx[64 * s + j0:64 * s + j0 + 8], n)
    return out


def _dual_pass_select(xb, idx_g, idx_u, n):
    """The many-row plan's dual gather pass (gemm.cu::gather_columns_kernel,
    TWO): unit (row, columns j0 .. + 7 of K_c) reads its 16-byte chunks of
    X once and writes the gate's selection to column j0 and the up's to
    K_c + j0 of the (B, 2 K_c) scratch.  Returns the scratch, bf16 bits."""
    b = xb.shape[0]
    kc = idx_g.shape[0]
    words = np.ascontiguousarray(xb).view(np.uint32)
    scratch = np.zeros((b, 2 * kc), np.uint16)
    for j0 in range(0, kc, 8):
        wd = words[:, j0 // n * 2:j0 // n * 2 + 16 // n]            # the one read
        for t, idx in enumerate((idx_g, idx_u)):
            scratch[:, t * kc + j0:t * kc + j0 + 8] = _select_unit(wd, idx[j0:j0 + 8], n)
    return scratch


def _bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _silu(v: np.ndarray) -> np.ndarray:
    """The kernels' silu, v / (1 + exp(-v)), in fp32."""
    v = v.astype(np.float32)
    return (v / (np.float32(1) + np.exp(-v))).astype(np.float32)


def _split_sum(xf, w, split):
    """The stream's accumulation: block r of the cluster sums its span of
    64-deep steps in fp32, the owner adds the partials in rank order."""
    steps = xf.shape[1] // 64
    acc = None
    for r in range(split):
        lo, hi = 64 * (r * steps // split), 64 * ((r + 1) * steps // split)
        part = (xf[:, lo:hi].astype(np.float64) @ w[lo:hi].astype(np.float64)).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def _wgmma_paired(acc_g, acc_u):
    """The dual wgmma body's flush: each consumer warpgroup's register 4i + e
    of (warp, lane) is row 16 warp + lane / 4 (+ 8 for e >= 2), column 8i +
    2 (lane % 4) + (e & 1) of both accumulators; silu(g) * u is formed
    register by register and written back through the same map."""
    rows, cols = acc_g.shape
    out = np.zeros_like(acc_g)
    for r0 in range(0, rows, 64):
        for c0 in range(0, cols, 128):
            for warp in range(4):
                for lane in range(32):
                    for i in range(16):
                        for e in range(4):
                            r = r0 + 16 * warp + lane // 4 + 8 * (e >= 2)
                            c = c0 + 8 * i + 2 * (lane % 4) + (e & 1)
                            if r < rows and c < cols:
                                out[r, c] = _silu(acc_g[r, c]) * acc_u[r, c]
    return out


def _bf16(jnp, a):
    return np.asarray(jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16))


def _gather_case(rng, jnp, b, ke, o, n):
    kc = ke * n // 4
    idx = []
    for _ in range(2):
        i = np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                    -1).reshape(-1).astype(np.int32)
        idx.append(i)
    idx[0][3] = 7                                   # outside [0, 4): reads +0
    idx[1][kc - 2] = -1
    xf = _bf16(jnp, rng.standard_normal((b, ke)))
    vg = _bf16(jnp, rng.standard_normal((kc, o)) * kc ** -0.5)
    vu = _bf16(jnp, rng.standard_normal((kc, o)) * kc ** -0.5)
    return xf, vg, vu, idx


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("body", ["stream", "wgmma"])
def test_dual_gather_reproduces_pallas(body, n):
    """bf16 X and values: each body's dual select (one read, two selects; an
    index outside [0, 4) gives +0), its accumulation and the paired silu(g)
    * u reproduce JAX's nm_spmm_gather_dual_bk (Pallas, interpret mode)
    within 1e-6, scaled."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_dual_bk as j_dual

    rng = np.random.default_rng(17 + n)
    b, ke, o = (8, 512, 256) if body == "stream" else (256, 512, 256)
    kc = ke * n // 4
    xf, vg, vu, (ig, iu) = _gather_case(rng, jnp, b, ke, o, n)
    bits = xf.view(np.uint16)
    if body == "stream":
        sg, su = _dual_stream_select(bits, ig, iu, n)
        split = dual_plan(b, kc, o)["split"]
        acc_g = _split_sum(_bits_to_f32(sg), vg.astype(np.float32), split)
        acc_u = _split_sum(_bits_to_f32(su), vu.astype(np.float32), split)
        got = _silu(acc_g) * acc_u
    else:
        scratch = _bits_to_f32(_dual_pass_select(bits, ig, iu, n))
        acc_g = (scratch[:, :kc].astype(np.float64) @ vg.astype(np.float64)).astype(np.float32)
        acc_u = (scratch[:, kc:].astype(np.float64) @ vu.astype(np.float64)).astype(np.float32)
        got = _wgmma_paired(acc_g, acc_u)
    want = j_dual(jnp.asarray(xf), jnp.asarray(vg), jnp.asarray(ig.reshape(-1, 1)),
                  jnp.asarray(vu), jnp.asarray(iu.reshape(-1, 1)), n, out_dtype=jnp.float32,
                  interpret=True)
    assert_scaled_close(got, np.asarray(want), 1e-6)
    # the selects are the plain gathers, +0 where the index is outside [0, 4)
    for sel, idx in ((0, ig), (1, iu)):
        cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
        plain = np.where((idx >= 0) & (idx < 4), xf.astype(np.float32)[:, cols], 0)
        gathered = (_dual_stream_select(bits, ig, iu, n)[sel] if body == "stream"
                    else _dual_pass_select(bits, ig, iu, n)[:, sel * kc:(sel + 1) * kc])
        assert np.array_equal(_bits_to_f32(gathered), plain)


@pytest.mark.parametrize("body", ["stream", "wgmma"])
def test_dense_dual_reproduces_pallas(body):
    """bf16 X and weights: the stream's rank-order split sums (K = 320: five
    steps over a split of 2 or 4, uneven spans) or the wgmma body's paired
    fragments, then silu(g) * u, reproduce JAX's tile_gemm_dual (Pallas,
    interpret mode) within 1e-6, scaled; O = 192 ends a 128-channel tile
    past O."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.tile_gemm.kernel import tile_gemm_dual as j_dual

    rng = np.random.default_rng(23)
    b, k, o = (8, 320, 192) if body == "stream" else (256, 320, 192)
    xf = _bf16(jnp, rng.standard_normal((b, k)))
    wg = _bf16(jnp, rng.standard_normal((k, o)) * k ** -0.5)
    wu = _bf16(jnp, rng.standard_normal((k, o)) * k ** -0.5)
    x32, g32, u32 = (a.astype(np.float32) for a in (xf, wg, wu))
    p = dual_plan(b, k, o)
    assert p["body"] == body
    if body == "stream":
        assert p["split"] > 1 and (k // 64) % p["split"]
        got = _silu(_split_sum(x32, g32, p["split"])) * _split_sum(x32, u32, p["split"])
    else:
        acc_g = (x32.astype(np.float64) @ g32.astype(np.float64)).astype(np.float32)
        acc_u = (x32.astype(np.float64) @ u32.astype(np.float64)).astype(np.float32)
        got = _wgmma_paired(acc_g, acc_u)
    want = j_dual(jnp.asarray(xf), jnp.asarray(wg), jnp.asarray(wu), block_b=min(b, 128),
                  block_o=64, block_k=64, out_dtype=jnp.float32, interpret=True)
    assert_scaled_close(got, np.asarray(want), 1e-6)


# ----------------------------------------------------------- on the card
def _dense_case(dev, b, k, o, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0                                              # an idle slot
    wg = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    wu = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    return x, wg, wu


def _k9_case(dev, b, k, o, n, seed=0):
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = [convert_layout({"w": (torch.randn(k, o, generator=g, device=dev)
                                    * k ** -0.5).bfloat16()},
                             SparsityConfig(n=n, m=4, mode="gather"), "gather")
              for _ in range(2)]
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    return (x, leaves[0]["values"], leaves[0]["gather_idx"], leaves[1]["values"],
            leaves[1]["gather_idx"])


ROWS = [1, 8, 33, 64, 256, 1024]


def _shape(b):
    return (3072, 8192) if b == 1024 else (2048, 1536)


@pytest.mark.cuda
@pytest.mark.parametrize("b", ROWS)
def test_tile_gemm_dual_bitwise_deterministic_on_card(cuda_device, b):
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_ref
    x, wg, wu = _dense_case(cuda_device, b, *_shape(b))
    before = tile_gemm_dual.launches
    first = tile_gemm_dual(x, wg, wu)
    again = [tile_gemm_dual(x, wg, wu) for _ in range(3)]
    torch.cuda.synchronize()
    assert tile_gemm_dual.launches == before + 4
    assert all(torch.equal(first, y) for y in again)
    assert_scaled_close(first, tile_gemm_dual_ref(x, wg, wu), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", ROWS)
def test_gather_dual_bitwise_deterministic_on_card(cuda_device, n, b):
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_dual_ref
    ops = _k9_case(cuda_device, b, *_shape(b), n)
    first = nm_spmm_gather_dual_bk(*ops, n)
    again = [nm_spmm_gather_dual_bk(*ops, n) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in again)
    assert_scaled_close(first, nm_spmm_gather_dual_ref(*ops, n), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(192, 64), (320, 64), (448, 128), (1216, 256), (1088, 512),
                                 (1152, 1024)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_tile_gemm_dual_at_split_boundaries_on_card(cuda_device, k, o, b):
    """K = 64 x steps not divisible by the split: uneven spans per block."""
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_ref
    p = dual_plan(b, k, o)
    x, wg, wu = _dense_case(cuda_device, b, k, o)
    got = tile_gemm_dual(x, wg, wu)
    torch.cuda.synchronize()
    assert_scaled_close(got, tile_gemm_dual_ref(x, wg, wu), 1e-2)
    if b <= 16:
        assert p["split"] > 1 and (k // 64) % p["split"], p
    assert torch.equal(got, tile_gemm_dual(x, wg, wu))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(768, 64), (1280, 64), (1792, 128), (4864, 256),
                                 (4352, 512)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_gather_dual_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K_c = 64 x steps not divisible by the split."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_dual_ref
    if (k * n // 4) % 64:
        pytest.skip(f"K_c = {k * n // 4} is not a multiple of 64 at n = {n}")
    ops = _k9_case(cuda_device, b, k, o, n)
    got = nm_spmm_gather_dual_bk(*ops, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_gather_dual_ref(*ops, n), 1e-2)
    assert torch.equal(got, nm_spmm_gather_dual_bk(*ops, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [8, 64, 1024])
def test_gather_dual_index_outside_the_block_reads_zero_on_card(cuda_device, n, b):
    """An index outside [0, 4) selects +0 in every body, for each weight's
    own index stream, against the plain product on the zeroed columns."""
    k, o = _shape(b)
    x, vg, ig, vu, iu = _k9_case(cuda_device, b, k, o, n, seed=3)
    ig, iu = ig.clone(), iu.clone()
    ig[1], ig[70], iu[-1], iu[5] = 9, -1, 4, -7
    got = nm_spmm_gather_dual_bk(x, vg, ig, vu, iu, n)
    torch.cuda.synchronize()

    def gathered(idx):
        ok = (idx >= 0) & (idx < 4)
        cols = torch.arange(idx.numel(), device=cuda_device) // n * 4 + idx.clamp(0, 3).long()
        return x.float()[:, cols] * ok
    want = torch.nn.functional.silu(gathered(ig) @ vg.float()) * (gathered(iu) @ vu.float())
    assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
def test_refused_dual_plans_raise_on_card(cuda_device):
    x, wg, wu = _dense_case(cuda_device, 8, 256, 128)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library()
    # (bm, body, bn, split): body 0 shared (bn 64, split 1), 1 stream (bm 16 | 64, bn 64),
    # 2 wgmma (bm 128, bn 128, split 1)
    for bm, body, bn, split in ((16, 0, 64, 2), (16, 1, 64, 0), (16, 1, 64, 3), (16, 1, 128, 1),
                                (32, 1, 64, 1), (128, 2, 256, 1), (128, 2, 128, 2),
                                (64, 2, 128, 1), (16, 3, 64, 1)):
        rc = lib.vg_tile_gemm_dual(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), y.data_ptr(), 8,
                                   256, 128, bm, body, bn, split, _build.stream_of(x))
        assert rc != 0, (bm, body, bn, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm_dual", lib)
    xk, vg, ig, vu, iu = _k9_case(cuda_device, 8, 512, 128, 2)
    # n = 4 has no stream or wgmma form; the wgmma form needs its scratch
    for n, bm, body, bn, split, scratch in ((2, 16, 0, 64, 2, None), (4, 16, 1, 64, 1, None),
                                            (2, 16, 1, 64, 3, None), (2, 128, 2, 64, 1, y),
                                            (4, 128, 2, 128, 1, y), (2, 16, 1, 128, 1, None),
                                            (2, 128, 2, 128, 1, None)):
        rc = lib.vg_nm_spmm_gather_dual_bk(
            xk.data_ptr(), vg.data_ptr(), ig.data_ptr(), vu.data_ptr(), iu.data_ptr(),
            y.data_ptr(), 8, 512, 128, n, bm, body, bn, split,
            None if scratch is None else scratch.data_ptr(), _build.stream_of(xk))
        assert rc != 0, (n, bm, body, bn, split)
