"""The redesigned Hopper bodies of the bf16 masked gather
nm_spmm_gather_bk_masked at n in {1, 2} (K8's gathered stream with MASKED:
each block walks the live steps of the span K8's split gives it; the shared
body where K8 leaves its stream) and of the fp8 gather gate-up dual K9,
nm_spmm_gather_dual_bk_fp8 with its requantizing form at n in {1, 2} (the
e4m3 gathered stream in DUAL form: one X span a step selected twice, both
dense values tiles, two accumulators, split-K over a cluster, one ws-first
silu(g) * u flush; the shared body where the plan keeps it).

On the CPU: both plans against their twins' plans
(``nm_spmm_gather/kernel.py::masked_plan`` against K8's ``plan``,
``::fp8_dual_plan`` against ``tile_gemm/kernel.py::fp8_dual_plan`` over
K_c) at internlm2-1.8b's and qwen3-moe's shapes, B in {1, 8, 16, 17, 64,
255, 256}; each wrapper hands the C entry its plan's rows, body and split
(a recording stand-in for the library, meta tensors); a block's shared
memory fits the blocks an SM the plans assume; a numpy emulation of the
masked gathered stream (each rank walking the live steps of its span, the
select pass over a live step's span, rank-order split sums) is bitwise the
unmasked emulation at 0%, ~40% and 100% live, with rank 0's span dead and
with one rank live, and within 1e-6 (scaled) of JAX's
``nm_spmm_gather_bk_masked`` in interpret mode; a numpy emulation of the
e4m3 gathered dual (each unit's span words read once and selected twice,
64-deep partials, rank-order planes, ``DualFlushT<true>``'s order, the
requantized codes) within 1e-6 of JAX's fp8 ``nm_spmm_gather_dual_bk`` in
interpret mode, its codes one e4m3 step off on at most 0.1%.  On the card
(``cuda``): the masked kernel bitwise K8 on the same masked X wherever K8
streams (bitwise its all-live self elsewhere) and across launches, a dead
row block flushing bias + act of zero; K9 fp8 and ``_requant`` within 1e-2
of the plain version, codes one step off on at most 0.1%, the same bits on
every launch, at split boundaries, an index outside [0, 4) reading +0;
refused plans raise."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm_gather import kernel as gk
from repro_torch.kernels.nm_spmm_gather.kernel import (fp8_dual_plan, masked_plan,
                                                       nm_spmm_gather_bk,
                                                       nm_spmm_gather_bk_masked,
                                                       nm_spmm_gather_dual_bk_fp8,
                                                       nm_spmm_gather_dual_bk_fp8_requant, plan)
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  DUAL_STREAM_MIN_SPLIT,
                                                  FP8_STREAM16_BLOCKS_PER_SM, SMS,
                                                  WGMMA_MIN_ROWS, cluster_split)
from repro_torch.kernels.tile_gemm.kernel import fp8_dual_plan as tile_fp8_dual_plan
from test_torch_dual_redesign import _bits_to_f32, _dual_stream_select
from test_torch_fp8_sparse_redesign import _e4m3_f32, _j, _partials, _select16, _step_share
from test_torch_masked_stream_redesign import (LIVE_BYTES, MAX_K_STEPS, _codes, _fp8_cases,
                                               _Recorder, _silu, recorded)  # noqa: F401
from test_torch_nm_dual_masked_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT,
                                                _assert_spans, _bf16_bits, _live_walk, _stream)
from test_torch_redesign import _spans
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

FP8 = torch.float8_e4m3fn
# qwen3-moe's expert shapes (K_eff, O): w_out (the masked site), gate-up (K9's)
EXPERT = {"w_out": (1536, 4096), "gate_up": (4096, 1536)}
# internlm2-1.8b's gate-up and w_out
INTERNLM2 = {"gate_up": (2048, 8192), "w_out": (8192, 2048)}
ROWS = [1, 8, 16, 17, 64, 255, 256]


def test_shapes_are_the_configs():
    from repro_torch.configs import get_config
    moe, lm = get_config("qwen3_moe_235b_a22b"), get_config("internlm2_1_8b")
    assert EXPERT == {"w_out": (moe.d_ff, moe.d_model), "gate_up": (moe.d_model, moe.d_ff)}
    assert INTERNLM2 == {"gate_up": (lm.d_model, lm.d_ff), "w_out": (lm.d_ff, lm.d_model)}


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_masked_plan_is_k8s_where_k8_streams(b, n):
    """At 2:4 K8's stream plan, tile and split wherever K8 streams (below
    WGMMA_MIN_ROWS); the shared body at block_rows(b), split 1, elsewhere
    (K8's wgmma body, n = 4, and 1:4, where K8's own stream up to 16 rows
    lost to the shared body at the expert's w_out)."""
    for ke, o in (*EXPERT.values(), *INTERNLM2.values()):
        p, twin = masked_plan(b, ke, o, n), plan(b, ke, o, n)
        assert p["rows"] == _build.block_rows(b)
        if n == 2 and twin["body"] == "stream":
            assert p == twin
            _assert_spans(ke * n // 4, p["split"])
        else:
            assert p == {"body": "shared", "rows": _build.block_rows(b), "cols": 64, "split": 1}
        assert (p["body"] == "stream") == (n == 2 and b < WGMMA_MIN_ROWS), (ke, o, p)
    if b <= 16:   # qwen3-moe's w_out at decode: 64 tiles, split 4 (12 steps)
        assert masked_plan(b, *EXPERT["w_out"], 2)["split"] == 4


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_fp8_dual_plan_is_the_dense_duals_stream(b, n):
    """Where tile_gemm's fp8_dual_plan (its requantizing form: no wgmma)
    streams the dense e4m3 dual over K_c, K9 fp8 streams with the same tile
    and split: 16-row tiles, FP8_STREAM16_BLOCKS_PER_SM blocks an SM, while
    the launch has at most that many tiles an SM; else the shared body at
    block_rows(b), split 1; n = 4 always shared."""
    for ke, o in (EXPERT["gate_up"], INTERNLM2["gate_up"]):
        p = fp8_dual_plan(b, ke, o, n)
        twin = tile_fp8_dual_plan(b, ke * n // 4, o, requant=True) if n < 4 else None
        if twin is not None and twin["body"] == "stream":
            assert p == twin and p["rows"] == 16
            _assert_spans(ke * n // 4, p["split"])
        else:
            assert p == {"body": "shared", "rows": _build.block_rows(b), "cols": 64, "split": 1}
    if n == 4:
        return
    kc_moe = EXPERT["gate_up"][0] * n // 4
    moe = fp8_dual_plan(b, *EXPERT["gate_up"], n)
    lm = fp8_dual_plan(b, *INTERNLM2["gate_up"], n)
    # qwen3-moe's expert: 24 tiles a 16-row tile, at most 384 up to 256 rows
    assert moe == {"body": "stream", "rows": 16, "cols": 64,
                   "split": cluster_split(24 * -(-b // 16), kc_moe // 64,
                                          FP8_STREAM16_BLOCKS_PER_SM)}
    if b <= 16:   # internlm2-1.8b: 128 tiles, split 2; qwen3-moe: 24 tiles, split 8
        assert (lm["split"], moe["split"]) == (2, 8)
    if 17 <= b <= 64:
        assert moe["split"] >= DUAL_STREAM_MIN_SPLIT
    # internlm2-1.8b: 128 tiles a 16-row tile, 396 at most up to 48 rows
    assert lm["body"] == ("stream" if 128 * -(-b // 16) <= FP8_STREAM16_BLOCKS_PER_SM * SMS
                          else "shared")


@pytest.mark.parametrize("k", [512, 768, 1024, 2048])
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_split_spans_are_whole_steps_covering_k(k, b):
    assert k // 64 <= MAX_K_STEPS
    for o in (64, 1536, 4096, 8192):
        for n in (1, 2):
            ke = k * 4 // n
            _assert_spans(k, masked_plan(b, ke, o, n)["split"])
            _assert_spans(k, fp8_dual_plan(b, ke, o, n)["split"])


# ---------------------------------------------- the wrappers' C arguments
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_masked_gather_launches_k8s_tile_and_split(recorded, b, n):
    """vg_nm_spmm_gather_bk_masked's (.., act, bm, body, split, stream)
    against vg_nm_spmm_gather_bk's (.., rows, body, cols, split, scratch,
    stream) where K8 streams; body 0, split 1 elsewhere."""
    for ke, o in (*EXPERT.values(), *INTERNLM2.values()):
        kc = ke * n // 4
        x = torch.empty(b, ke, dtype=torch.bfloat16, device="meta")
        values = torch.empty(kc, o, dtype=torch.bfloat16, device="meta")
        idx = torch.empty(kc, dtype=torch.int32, device="meta")
        maps = torch.zeros(-(-b // _build.block_rows(b)), kc // 64, dtype=torch.int32,
                           device="meta")
        recorded.calls.clear()
        nm_spmm_gather_bk_masked(x, values, idx, maps, maps, n)
        nm_spmm_gather_bk(x, values, idx, n)
        (name_m, m), (name_t, t) = recorded.calls
        assert (name_m, name_t) == ("vg_nm_spmm_gather_bk_masked", "vg_nm_spmm_gather_bk")
        bm, body, split = m[-4:-1]
        rows, twin_body, _, twin_split = t[-6:-2]
        p = masked_plan(b, ke, o, n)
        assert (bm, body, split) == (p["rows"], BODY_CODES[p["body"]], p["split"])
        if n == 2 and twin_body == BODY_CODES["stream"]:
            assert (bm, body, split) == (rows, twin_body, twin_split)
        else:
            assert (bm, body, split) == (_build.block_rows(b), BODY_CODES["shared"], 1)


def test_masked_gather_refuses_maps_at_another_row_block(recorded):
    """At 8 rows the maps at 64 rows have the plan's shape (one row block)
    but not its row block: the launch is refused, not re-blocked."""
    ke, o = EXPERT["w_out"]
    x = torch.empty(8, ke, dtype=torch.bfloat16, device="meta")
    values = torch.empty(ke // 2, o, dtype=torch.bfloat16, device="meta")
    idx = torch.empty(ke // 2, dtype=torch.int32, device="meta")
    maps = torch.zeros(1, ke // 2 // 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="the plan's row block is 16"):
        nm_spmm_gather_bk_masked(x, values, idx, maps, maps, 2, block_b=64)
    assert not recorded.calls


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", ROWS)
def test_fp8_gather_dual_launches_its_plan(recorded, b, n):
    """vg_nm_spmm_gather_dual_bk_fp8 gets fp8_dual_plan's (out_kind, bm,
    body, split) in bf16, fp32 and the requantized codes; the int8 dual
    its own plan's (int8_dual_plan)."""
    for ke, o in (EXPERT["gate_up"], INTERNLM2["gate_up"]):
        kc = ke * n // 4
        xs = torch.empty(b, 1, device="meta")
        ws = torch.empty(1, o, device="meta")
        rq = torch.empty((), device="meta")
        idx = torch.empty(kc, dtype=torch.int32, device="meta")
        for storage, wrapper in ((FP8, None), (torch.int8, gk.nm_spmm_gather_dual_bk_int8)):
            xq = torch.empty(b, ke, dtype=storage, device="meta")
            v = torch.empty(kc, o, dtype=storage, device="meta")
            recorded.calls.clear()
            if wrapper is not None:
                wrapper(xq, v, idx, v, idx, n, xs, ws, ws)
                ((name, args),) = recorded.calls
                assert name == "vg_nm_spmm_gather_dual_bk_int8"
                q = gk.int8_dual_plan(b, ke, o, n)     # fp32 out
                assert args[-5:-1] == (1, q["rows"], BODY_CODES[q["body"]], q["split"])
                continue
            nm_spmm_gather_dual_bk_fp8(xq, v, idx, v, idx, n, xs, ws, ws,
                                       out_dtype=torch.bfloat16)
            nm_spmm_gather_dual_bk_fp8(xq, v, idx, v, idx, n, xs, ws, ws)
            nm_spmm_gather_dual_bk_fp8_requant(xq, v, idx, v, idx, n, xs, ws, ws, rq)
            p = fp8_dual_plan(b, ke, o, n)
            for (name, args), kind in zip(recorded.calls,
                                          (0, 1, _build.OUT_REQUANT)):   # bf16, fp32, codes
                assert name == "vg_nm_spmm_gather_dual_bk_fp8"
                assert args[-5:-1] == (kind, p["rows"], BODY_CODES[p["body"]], p["split"])


# ------------------------------------------------- shared memory a block
def _masked_gather_smem(g: int, bm: int) -> int:
    """nm_spmm_sp.cuh's Layout<4, bm, G>: a ring (4 deep at 16 rows, 3 at 64)
    of the dense (64, 64) bf16 values tile (72-element pitch), 64 int32
    indices and the X span (256 / G + 8 elements a row), the compact X tile,
    the inbox, and (MASKED) kmask.cuh's 128-byte bitmask."""
    stages = 4 if bm == 16 else 3
    stage = 64 * 72 * 2 + 64 * 4 + bm * (256 // g + 8) * 2
    ring = max(stages * stage, bm * 68 * 4)
    return ring + bm * 72 * 2 + bm * 64 * 4 + LIVE_BYTES


def _fp8_gather_dual_smem(g: int, stages: int = 4) -> int:
    """nm_spmm_sp_fp8.cuh's Layout<4, 16, G, DUAL>: a ring of both dense
    e4m3 values tiles (64 x 64, unpadded), both index slices and one X span
    (256 / G + 16 bytes a row), both compact X tiles (80-byte rows), the
    inbox of both partials."""
    stage = 2 * 64 * 64 + 2 * 64 * 4 + 16 * (256 // g + 16)
    ring = max(stages * stage, 2 * 16 * 68 * 4)
    return ring + 2 * 16 * 80 + 2 * 16 * 64 * 4


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_masked_gather_stream_fits_the_blocks_an_sm(g, bm):
    """K8's plan puts two 16-row blocks an SM and one 64-row block (the
    masked form adds the bitmask only)."""
    total = _masked_gather_smem(g, bm)
    per_sm = BLOCKS_PER_SM if bm == 16 else 1
    assert total <= SMEM_LIMIT
    assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (g, bm, total)


@pytest.mark.parametrize("g", [1, 2])
def test_fp8_gather_dual_fits_three_blocks_an_sm(g):
    """~54 KB at 2:4 and ~62 KB at 1:4: FP8_STREAM16_BLOCKS_PER_SM blocks an
    SM, as the plan's split assumes; a 6-deep ring at 1:4 would leave two."""
    total = _fp8_gather_dual_smem(g)
    assert total == (54784 if g == 2 else 62976)
    assert FP8_STREAM16_BLOCKS_PER_SM * (total + BLOCK_RESERVED) <= SM_SMEM
    if g == 1:
        assert FP8_STREAM16_BLOCKS_PER_SM * (_fp8_gather_dual_smem(g, 6) + BLOCK_RESERVED) \
            > SM_SMEM


# ------------------------------------- the masked gathered bf16 stream, emulated
def _gather_idx(rng, kc: int, n: int) -> np.ndarray:
    """Sorted, distinct in-block indices, as the gather layout keeps them."""
    return np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                   -1).reshape(-1).astype(np.int32)


def _masked_span_x(rng, b, ke, bm, span, live_rows):
    """bf16-valued X whose row block i is zero outside the steps (spans of
    ``span`` columns) live_rows[i] names, and its kmask (block_maps at (bm,
    span))."""
    x = torch.from_numpy(rng.standard_normal((b, ke)).astype(np.float32)).bfloat16()
    x = x.float().numpy()
    steps = ke // span
    kmask = np.zeros((-(-b // bm), steps), np.int32)
    for i, live in enumerate(live_rows):
        keep = np.zeros(steps, bool)
        keep[list(live)] = True
        x[i * bm:(i + 1) * bm] *= np.repeat(keep, span)
        kmask[i] = np.abs(x[i * bm:(i + 1) * bm]).reshape(-1, steps, span).max((0, 2)) > 0
    return x, kmask


def _gathered_stream(x, idx, values, kmask, bm, n, split, masked):
    """Each row block's K8 stream: the select pass over each walked step's
    span (the same select a dead step would give: +0 columns), the fp32
    split sums of the walked steps, the ranks in order."""
    bits = torch.from_numpy(x).bfloat16().view(torch.int16).numpy().view(np.uint16)
    xg = _bits_to_f32(_dual_stream_select(bits, idx, idx, n)[0])
    rows = []
    for i in range(kmask.shape[0]):
        walk = _live_walk(kmask[i]) if masked else (lambda lo, hi: range(lo, hi))
        rows.append(_stream(xg[i * bm:(i + 1) * bm], values, split, walk))
    return np.concatenate(rows)


def _bf16_weight(rng, kc, o):
    w = torch.from_numpy(rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)
    return w.bfloat16().float().numpy()


def test_masked_gather_walk_is_bitwise_the_unmasked_stream():
    """B = 32 over two 16-row blocks, 2:4, K_c = 1024 (16 steps of 128 X
    columns; K8's split 8 at O = 128: two steps a rank): the walk visits
    exactly each span's live steps, and the sums and the one bf16 cast are
    the unmasked stream's on the same masked X, bit for bit, at 0%, ~40%
    and 100% live, with rank 0's span dead and with one rank live."""
    n = 2
    rng = np.random.default_rng(132)
    b, kc, o, bm = 32, 1024, 128, 16
    ke, span = kc * 4 // n, 256 // n
    p = masked_plan(16, ke, o, n)
    assert p == plan(16, ke, o, n) and (p["body"], p["split"]) == ("stream", 8)
    idx, values = _gather_idx(rng, kc, n), _bf16_weight(rng, kc, o)
    for name, live_rows in _fp8_cases(rng, kc // 64).items():
        x, kmask = _masked_span_x(rng, b, ke, bm, span, live_rows)
        for i in range(kmask.shape[0]):
            walk = _live_walk(kmask[i])
            for lo, hi in _spans(kc, p["split"]):
                assert walk(lo, hi) == [s for s in range(lo, hi) if kmask[i, s]], name
        got = _gathered_stream(x, idx, values, kmask, bm, n, p["split"], masked=True)
        full = _gathered_stream(x, idx, values, kmask, bm, n, p["split"], masked=False)
        assert np.array_equal(got, full), name
        assert np.array_equal(_bf16_bits(got), _bf16_bits(full)), name
        if name == "none":
            assert not got.any()


def test_masked_gather_walk_matches_pallas():
    """The emulated masked gathered walk (2:4: K8's split 8; 1:4: the shared
    body's one span), bias and silu in fp32, against JAX's
    nm_spmm_gather_bk_masked (interpret; maps at 16 rows x 256 / n columns)
    within 1e-6, scaled: ~40% live with a dead rank span, an index outside
    [0, 4) reading +0."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import actsparse as ja
    from repro.kernels.epilogue import EpilogueSpec as JSpec
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk_masked as j_masked

    b, kc, o, bm = 32, 1024, 128, 16
    for n in (1, 2):
        rng = np.random.default_rng(140 + n)
        ke, span = kc * 4 // n, 256 // n
        idx, values = _gather_idx(rng, kc, n), _bf16_weight(rng, kc, o)
        idx[5], idx[kc - 3] = 6, -2
        split = masked_plan(16, ke, o, n)["split"]
        x, kmask = _masked_span_x(rng, b, ke, bm, span,
                                  [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
        bias = rng.standard_normal(o).astype(np.float32)
        acc = (_gathered_stream(x, idx, values, kmask, bm, n, split, masked=True)
               + bias).astype(np.float32)
        got = _silu(acc)
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        kmap, jk = ja.block_maps(jx, bm, span)
        assert np.array_equal(np.asarray(jk) != 0, kmask != 0)
        want = j_masked(jx, jnp.asarray(values).astype(jnp.bfloat16),
                        jnp.asarray(idx.reshape(-1, 1)), kmap, jk, n, block_b=bm, block_o=128,
                        block_ke=span, out_dtype=jnp.float32, interpret=True,
                        epilogue=JSpec(act="silu", bias=True), bias=jnp.asarray(bias))
        assert_scaled_close(got, np.asarray(want), 1e-6)


# --------------------------------------------- the e4m3 gathered dual, emulated
def _dual_select_e4m3(xb: np.ndarray, idx_g: np.ndarray, idx_u: np.ndarray, n: int):
    """The gathered dual's select pass: per 64-deep step, unit (row, columns
    j0 .. + 15) reads the words of its M-blocks in the step's span (256 / n
    bytes) once and selects them through each weight's indices (select16)
    into two compact tiles."""
    b = xb.shape[0]
    kc, span = idx_g.shape[0], 256 // n
    out = [np.zeros((b, kc), np.uint8) for _ in range(2)]
    for s in range(kc // 64):
        for r in range(b):
            words = np.ascontiguousarray(xb[r, s * span:(s + 1) * span]).view(np.uint32)
            for j0 in range(0, 64, 16):
                wd = words[j0 // n:j0 // n + 16 // n]           # the one read
                for t, idx in enumerate((idx_g, idx_u)):
                    out[t][r, 64 * s + j0:64 * s + j0 + 16] = _select16(
                        wd, idx[64 * s + j0:64 * s + j0 + 16], n)
    return out


def _fp8_gather_dual_inputs(seed, b, ke, o, n):
    """e4m3 rows and their scales, two gathered e4m3 weights and their
    scales, as the port makes them (torch on the CPU); an index of each
    weight outside [0, 4)."""
    from repro_torch.core import quantize as tquant
    rng = np.random.default_rng(seed)
    kc = ke * n // 4
    xq, xs = tquant.quantize_rows(torch.from_numpy(
        rng.standard_normal((b, ke)).astype(np.float32)), FP8)
    weights = []
    for t in range(2):
        idx = _gather_idx(rng, kc, n)
        idx[7 + t] = 5 if t else -1
        leaf = tquant.quantize_linear({"w": torch.from_numpy(
            rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)}, FP8)
        weights.append((leaf["w"], idx, leaf["scale"].reshape(1, -1)))
    return xq, xs, weights


@pytest.mark.parametrize("n", [1, 2])
def test_fp8_gather_dual_reproduces_pallas(n):
    """K_c = 320: five 64-deep steps over the plan's split of 4 (uneven
    spans), O = 128: the select-twice pass, each weight's 64-deep partials
    in rank order, DualFlushT<true> (t = acc * ws * xs, silu(t_g) * t_u) and
    the requantized store against JAX's nm_spmm_gather_dual_bk fp8 branch
    (interpret) within 1e-6, scaled; the codes one e4m3 step off on at most
    0.1%."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import epilogue as jepi
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_dual_bk as j_dual

    b, kc, o = 8, 320, 128
    ke = kc * 4 // n
    p = fp8_dual_plan(b, ke, o, n)
    assert (p["body"], p["rows"], p["split"]) == ("stream", 16, 4) and (kc // 64) % p["split"]
    xq, xs, [(vg, ig, sg), (vu, iu, su)] = _fp8_gather_dual_inputs(150 + n, b, ke, o, n)
    xb = xq.view(torch.uint8).numpy()
    sel_g, sel_u = _dual_select_e4m3(xb, ig, iu, n)
    for sel, idx in ((sel_g, ig), (sel_u, iu)):   # the plain gathers, +0 outside [0, 4)
        cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
        assert np.array_equal(sel, np.where((idx >= 0) & (idx < 4), xb[:, cols], 0))
    acc_g = _partials(_e4m3_f32(sel_g), vg.float().numpy(), 64, p["split"])
    acc_u = _partials(_e4m3_f32(sel_u), vu.float().numpy(), 64, p["split"])
    xsn = xs.numpy()
    t_g = ((acc_g * sg.numpy()).astype(np.float32) * xsn).astype(np.float32)
    t_u = ((acc_u * su.numpy()).astype(np.float32) * xsn).astype(np.float32)
    got = (_silu(t_g) * t_u).astype(np.float32)
    args = (_j(jnp, xq), _j(jnp, vg), jnp.asarray(ig.reshape(-1, 1)), _j(jnp, vu),
            jnp.asarray(iu.reshape(-1, 1)), n, _j(jnp, xs), _j(jnp, sg), _j(jnp, su))
    kw = dict(acc_dtype=jnp.float32, block_ke=256 // n, interpret=True)
    want = np.asarray(j_dual(*args, out_dtype=jnp.float32, **kw))
    assert_scaled_close(got, want, 1e-6)
    rq = np.float32(np.abs(want).max() / 300)
    want_q = np.asarray(j_dual(*args, epilogue=jepi.EpilogueSpec(
        act="silu_mul", requant="float8_e4m3fn"), requant_scale=jnp.asarray(rq), **kw))
    assert _step_share(_codes(got, rq), want_q.view(np.uint8)) <= 1e-3


def test_select16_reads_each_word_once_for_both_weights():
    """select16 on one set of words with two index vectors equals the byte
    gather of each: the dual pass needs no second read of the span."""
    rng = np.random.default_rng(160)
    for n in (1, 2):
        words = rng.integers(0, 2 ** 32, 16 // n, dtype=np.uint64).astype(np.uint32)
        raw = np.frombuffer(words.tobytes(), np.uint8)
        for _ in range(4):
            e = rng.integers(-1, 5, 16)
            want = [raw[(q // n) * 4 + e[q]] if 0 <= e[q] < 4 else 0 for q in range(16)]
            assert list(_select16(words, e, n)) == want


# ----------------------------------------------------------- on the card
def _masked_gather_case(dev, b, ke, o, n, share, seed=0, dead_rank0=False, dead_from=None):
    """Masked bf16 rows (whole 256 / n column steps; rows from ``dead_from``
    all zero), a gathered bf16 weight, the maps at block_rows(b)."""
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.actsparse import block_maps
    g = torch.Generator(device=dev).manual_seed(seed)
    leaf = convert_layout({"w": (torch.randn(ke, o, generator=g, device=dev)
                                 * ke ** -0.5).bfloat16()},
                          SparsityConfig(n=n, m=4, mode="gather"), "gather")
    span, kc = 256 // n, ke * n // 4
    steps = kc // 64
    live = torch.zeros(steps, dtype=torch.bool, device=dev)
    live[torch.randperm(steps, generator=g, device=dev)[:round(share * steps)]] = True
    if dead_rank0:                # rank 0's whole span dead, the rest live
        live[:] = True
        live[:_spans(kc, masked_plan(b, ke, o, n)["split"])[0][1]] = False
    x = torch.randn(b, ke, generator=g, device=dev).bfloat16()
    x = x * live.repeat_interleave(span).to(torch.bfloat16)
    if dead_from is not None:
        x[dead_from:] = 0
    return x, leaf["values"], leaf["gather_idx"], block_maps(x, _build.block_rows(b), span)


CARD_SHARES = ((0.0, False), (0.4, False), (1.0, False), (1.0, True))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ke,o", list(EXPERT.values()))
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_masked_gather_bitwise_k8_on_card(cuda_device, b, ke, o, n):
    """Where both plans' bodies agree (2:4: K8's stream; 1:4 at 64-row
    tiles: the shared body), the masked kernel is K8 on the same masked X
    bit for bit (bf16 with bias + silu too); at 1:4 up to 16 rows (K8's
    stream, the masked shared body) bitwise its all-live self and within
    1e-2 of K8; either way the same bits on every launch and within 1e-2
    of the plain version."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_masked_ref
    bias = torch.randn(o, device=cuda_device)
    silu = EpilogueSpec(act="silu", bias=True)
    for i, (share, dead_rank0) in enumerate(CARD_SHARES):
        x, v, idx, maps = _masked_gather_case(cuda_device, b, ke, o, n, share, seed=i,
                                              dead_rank0=dead_rank0)
        before = nm_spmm_gather_bk_masked.launches
        got = nm_spmm_gather_bk_masked(x, v, idx, *maps, n)
        again = nm_spmm_gather_bk_masked(x, v, idx, *maps, n)
        act = nm_spmm_gather_bk_masked(x, v, idx, *maps, n, epilogue=silu, bias=bias)
        torch.cuda.synchronize()
        assert nm_spmm_gather_bk_masked.launches == before + 3
        assert torch.equal(got, again)
        twin = nm_spmm_gather_bk(x, v, idx, n)
        if masked_plan(b, ke, o, n)["body"] == plan(b, ke, o, n)["body"]:
            assert torch.equal(got, twin), (share, dead_rank0)
            assert torch.equal(act, nm_spmm_gather_bk(x, v, idx, n, epilogue=silu, bias=bias))
        else:
            all_live = (maps[0], torch.ones_like(maps[1]))
            assert torch.equal(got, nm_spmm_gather_bk_masked(x, v, idx, *all_live, n))
            assert_scaled_close(got, twin, 1e-2)
        want = nm_spmm_gather_masked_ref(x.cpu(), v.cpu(), idx.cpu(), *(m.cpu() for m in maps),
                                         n, block_b=_build.block_rows(b))
        assert_scaled_close(got, want, 1e-2)
        if share == 0.0:
            assert not got.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ke,o", [(1280, 64), (1792, 128), (2304, 256), (4352, 512)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_masked_gather_at_split_boundaries_on_card(cuda_device, n, ke, o, b):
    """K_c = 64 x steps not divisible by the split, ~40% live."""
    if (ke * n // 4) % 64:
        pytest.skip(f"K_c = {ke * n // 4} is not a multiple of 64 at n = {n}")
    x, v, idx, maps = _masked_gather_case(cuda_device, b, ke, o, n, 0.4, seed=7)
    got = nm_spmm_gather_bk_masked(x, v, idx, *maps, n)
    torch.cuda.synchronize()
    if masked_plan(b, ke, o, n)["body"] == plan(b, ke, o, n)["body"]:
        assert torch.equal(got, nm_spmm_gather_bk(x, v, idx, n))
    else:
        all_live = (maps[0], torch.ones_like(maps[1]))
        assert torch.equal(got, nm_spmm_gather_bk_masked(x, v, idx, *all_live, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_masked_gather_dead_row_block_on_card(cuda_device, n):
    """B = 100 at 64-row tiles: row block 1 wholly dead flushes silu(bias),
    row block 0 is K8's (2:4 streams; 1:4 keeps the shared body)."""
    ke, o = EXPERT["w_out"]
    x, v, idx, maps = _masked_gather_case(cuda_device, 100, ke, o, n, 0.4, seed=9, dead_from=64)
    assert not maps[1][1].any()
    bias = torch.randn(o, device=cuda_device)
    silu = EpilogueSpec(act="silu", bias=True)
    got = nm_spmm_gather_bk_masked(x, v, idx, *maps, n, epilogue=silu, bias=bias)
    torch.cuda.synchronize()
    assert torch.equal(got, nm_spmm_gather_bk(x, v, idx, n, epilogue=silu, bias=bias))
    dead = torch.nn.functional.silu(bias).to(got.dtype).expand(36, o)
    assert_scaled_close(got[64:], dead, 1e-2)


def _fp8_gather_dual_case(dev, b, ke, o, n, seed=0):
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = [convert_layout({"w": torch.randn(ke, o, generator=g, device=dev) * ke ** -0.5},
                             SparsityConfig(n=n, m=4, mode="gather"), "gather", quantize=FP8)
              for _ in range(2)]
    x = torch.randn(b, ke, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0          # an idle slot
    xq, xs = quantize_rows(x, FP8)
    (vg, ig, sg), (vu, iu, su) = ((lf["values"], lf["gather_idx"], lf["scale"].reshape(1, -1))
                                  for lf in leaves)
    return xq, vg, ig, vu, iu, n, xs, sg, su


def _ordinal_steps(got, want):
    def ordinal(t):
        c = t.view(torch.uint8).int()
        return torch.where(c >= 128, -(c - 128), c)
    d = (ordinal(got) - ordinal(want)).abs()
    assert d.max().item() <= 1
    return (d == 1).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("ke,o", [INTERNLM2["gate_up"], EXPERT["gate_up"]])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 17, 33, 64, 256])
def test_fp8_gather_dual_bitwise_and_close_on_card(cuda_device, b, n, ke, o):
    """internlm2-1.8b's and qwen3-moe's expert gate-up: bf16 and fp32 stores
    within 1e-2 of the plain version, the requantized codes one step off on
    at most 0.1%, the same bits on every launch."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_dual_quantized_ref
    args = _fp8_gather_dual_case(cuda_device, b, ke, o, n, seed=b)
    before = nm_spmm_gather_dual_bk_fp8.launches
    first = nm_spmm_gather_dual_bk_fp8(*args, out_dtype=torch.bfloat16)
    again = [nm_spmm_gather_dual_bk_fp8(*args, out_dtype=torch.bfloat16) for _ in range(2)]
    y32 = nm_spmm_gather_dual_bk_fp8(*args)
    torch.cuda.synchronize()
    assert nm_spmm_gather_dual_bk_fp8.launches == before + 4
    assert all(torch.equal(first, y) for y in again)
    assert_scaled_close(first, nm_spmm_gather_dual_quantized_ref(*args,
                                                                 out_dtype=torch.bfloat16), 1e-2)
    want32 = nm_spmm_gather_dual_quantized_ref(*args)
    assert_scaled_close(y32, want32, 1e-2)
    rq = (want32.abs().amax() / 448).reshape(())
    codes = nm_spmm_gather_dual_bk_fp8_requant(*args, rq)
    torch.cuda.synchronize()
    assert codes.dtype == FP8
    assert _ordinal_steps(codes, nm_spmm_gather_dual_quantized_ref(*args,
                                                                   requant_scale=rq)) <= 1e-3
    assert torch.equal(codes.view(torch.uint8),
                       nm_spmm_gather_dual_bk_fp8_requant(*args, rq).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ke,o", [(768, 64), (1280, 64), (1792, 128), (4864, 256)])
@pytest.mark.parametrize("b", [1, 8])
def test_fp8_gather_dual_at_split_boundaries_on_card(cuda_device, n, ke, o, b):
    """K_c = 64 x steps not divisible by the split, an index of each weight
    outside [0, 4) reading +0: against the plain version with that row of
    the weight zeroed (any in-block index then)."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_dual_quantized_ref
    if (ke * n // 4) % 64:
        pytest.skip(f"K_c = {ke * n // 4} is not a multiple of 64 at n = {n}")
    xq, vg, ig, vu, iu, n, xs, sg, su = _fp8_gather_dual_case(cuda_device, b, ke, o, n)
    assert fp8_dual_plan(b, ke, o, n)["body"] == "stream"
    ig, iu = ig.clone(), iu.clone()
    ig[1], iu[-1] = 9, -1
    args = (xq, vg, ig, vu, iu, n, xs, sg, su)
    got = nm_spmm_gather_dual_bk_fp8(*args)
    torch.cuda.synchronize()
    zg, zu = vg.clone(), vu.clone()
    zg.view(torch.uint8)[1], zu.view(torch.uint8)[-1] = 0, 0
    want = nm_spmm_gather_dual_quantized_ref(xq, zg, ig.clamp(0, 3), zu, iu.clamp(0, 3), n,
                                             xs, sg, su)
    assert_scaled_close(got, want, 1e-2)
    assert torch.equal(got, nm_spmm_gather_dual_bk_fp8(*args))


@pytest.mark.cuda
def test_refused_plans_raise_on_card(cuda_device):
    gemm, fp8 = _build.library("gemm.cu"), _build.library("gemm_fp8.cu")
    x, v, idx, (kmap, kmask) = _masked_gather_case(cuda_device, 8, 1024, 64, 2, 0.5)
    y = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda_device)
    # (n, bm, body, split): 1 the masked stream (n = 2), 0 shared (split 1)
    for nn, bm, body, split in ((2, 16, 0, 2), (2, 16, 1, 3), (1, 16, 1, 1), (1, 64, 1, 1),
                                (4, 16, 1, 1), (2, 32, 1, 1), (2, 16, 2, 1), (2, 16, 1, 16)):
        rc = gemm.vg_nm_spmm_gather_bk_masked(x.data_ptr(), v.data_ptr(), idx.data_ptr(),
                                              kmask.data_ptr(), None, y.data_ptr(), 8, 1024, 64,
                                              nn, 0, bm, body, split, _build.stream_of(x))
        assert rc != 0, (nn, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_bk_masked", gemm)
    rc = gemm.vg_nm_spmm_gather_bk_masked(x.data_ptr(), v.data_ptr(), idx.data_ptr(), None,
                                          None, y.data_ptr(), 8, 1024, 64, 2, 0, 16, 1, 2,
                                          _build.stream_of(x))
    assert rc != 0
    with pytest.raises(ValueError, match="the plan's row block is 16"):
        nm_spmm_gather_bk_masked(x, v, idx, kmap, kmask, 2, block_b=64)
    xq, vg, ig, vu, iu, n, xs, sg, su = _fp8_gather_dual_case(cuda_device, 8, 1024, 64, 2)
    # (n, bm, body, split, out_kind): 1 the gathered dual stream (n in {1, 2}, bm 16)
    for nn, bm, body, split, kind in ((2, 16, 0, 2, 0), (2, 64, 1, 1, 0), (4, 16, 1, 1, 0),
                                      (2, 16, 1, 3, 0), (2, 16, 2, 1, 0), (2, 16, 1, 1, 2),
                                      (2, 16, 1, 16, 0)):
        rc = fp8.vg_nm_spmm_gather_dual_bk_fp8(
            xq.data_ptr(), vg.data_ptr(), ig.data_ptr(), vu.data_ptr(), iu.data_ptr(),
            xs.data_ptr(), sg.data_ptr(), su.data_ptr(), None, y.data_ptr(), 8, 1024, 64, nn,
            kind, bm, body, split, _build.stream_of(xq))
        assert rc != 0, (nn, bm, body, split, kind)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_dual_bk_fp8", fp8)
