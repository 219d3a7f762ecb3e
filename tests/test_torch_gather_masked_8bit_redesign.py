"""The redesigned Hopper bodies of the 8-bit masked gathers
nm_spmm_gather_bk_masked_int8 and nm_spmm_gather_bk_masked_fp8 at n in {1,
2}: K8 int8's s8 and K8 fp8's e4m3 gathered streams (csrc/nm_spmm_sp_fp8.cuh,
G = n) with MASKED.  Each block folds its row block's kmask row (one column a
step of 64 compressed rows, 256 / n activation columns) into kmask.cuh's
bitmask and walks only the live steps of the span its split gives it; a dead
step's index slice and X span are neither loaded nor selected.  A row block
with no live step at all skips the split's exchange and flushes zero sums
(splitk::finish_zero), as every MASKED form of that header does.

On the CPU: ``nm_spmm_gather/kernel.py::masked_int8_plan`` and
``::masked_fp8_plan`` tile at ``block_rows(b)`` (the maps' row block) at
qwen3-moe's expert w_out and internlm2-1.8b's w_out, B in {1, 8, 17, 33, 64,
65, 256}, n in {1, 2}, their splits legal powers of two whose spans are whole
64-steps covering K_c, the fp8 one at K8 fp8's split wherever K8 fp8 streams;
each masked wrapper hands its C entry the plan's (bm, body, split) (a
recording stand-in for the library, meta tensors) and refuses maps at
another row block; a block's shared memory, with the bitmask, fits the blocks
an SM the plans assume; a numpy emulation of the masked G = n walk (the byte
select of each walked step's span, exact s8 / fp32-rounded e4m3 step sums,
each rank's live steps, rank-order sums, the zero finish of a dead row
block, the ws-first flush and the requantized codes) is bitwise the unmasked
emulation at 0%, ~40% and 100% live, with rank 0's span dead, with one rank
live and with a wholly dead row block, and within 1e-6 (scaled) of JAX's
``nm_spmm_gather_bk_masked`` int8 and fp8 branches in interpret mode.  On
the card (``cuda``): both kernels bitwise across launches and bitwise their
twins (K8 int8, K8 fp8) at their plans, bf16, fp32, raw and codes; the int8
one also bitwise its first body and the plain version, the fp8 one within
1e-2 of the plain version; a dead row block at split 8; the refusals."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm_gather import kernel as gk
from repro_torch.kernels.nm_spmm_gather.kernel import (FP8_MASKED_STREAM64_MIN_KC, fp8_plan,
                                                       int8_plan, masked_fp8_plan,
                                                       masked_int8_plan)
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  FP8_STREAM16_BLOCKS_PER_SM)
from repro_torch.kernels.tile_gemm.kernel import masked_int8_plan as tile_masked_int8_plan
from test_torch_fp8_sparse_redesign import (BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans,
                                            _e4m3_f32, _gather_stream_smem, _j, _step_share,
                                            _stream_select)
from test_torch_gather_masked_fp8_dual_redesign import _gather_idx, _masked_span_x
from test_torch_int8_stream_redesign import _i8_codes, _meta, rec  # noqa: F401
from test_torch_masked_stream_redesign import (LIVE_BYTES, MAX_K_STEPS, _codes, _fp8_cases,
                                               _silu)
from test_torch_nm_dual_masked_redesign import _live_walk
from test_torch_redesign import _spans
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

FP8 = torch.float8_e4m3fn
# (K_eff, O): qwen3-moe's expert w_out (the masked site) and internlm2-1.8b's w_out
SHAPES = [(1536, 4096), (8192, 2048)]
ROWS = [1, 8, 17, 33, 64, 65, 256]


def test_shapes_are_the_configs():
    from repro_torch.configs import get_config
    moe, lm = get_config("qwen3_moe_235b_a22b"), get_config("internlm2_1_8b")
    assert SHAPES == [(moe.d_ff, moe.d_model), (lm.d_ff, lm.d_model)]
    assert all(ke // 64 <= MAX_K_STEPS for ke, _ in SHAPES)


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_masked_int8_plan_tiles_at_the_maps_row_block(b, n):
    """At n in {1, 2} tile_gemm's masked_int8_plan over K_c (the s8 stream
    over block_rows(b) rows): K8 int8's int8_plan wherever its tile is that
    row block; every split a legal power of two whose spans are whole
    64-steps covering K_c.  n = 4: the shared body, split 1."""
    rows = _build.block_rows(b)
    for ke, o in SHAPES:
        kc = ke * n // 4
        p = masked_int8_plan(b, ke, o, n)
        assert p["rows"] == rows
        if n == 4:
            assert p == {"body": "shared", "rows": rows, "cols": 64, "split": 1}
            continue
        assert p == tile_masked_int8_plan(b, kc, o)
        assert p["body"] == "stream" and p["cols"] == 64
        twin = int8_plan(b, ke, o, n)
        if twin["rows"] == rows:
            assert p == twin
        _assert_spans(kc, p["split"])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_masked_fp8_plan_tiles_at_the_maps_row_block(b, n):
    """Wherever K8 fp8's fp8_plan (requant as there) streams at the maps'
    row block (up to 16 rows, and its requantizing 64-row plans past 64):
    that plan; at 17-64 rows, where it streams 16-row tiles, its split over
    64-row tiles where K_c >= FP8_MASKED_STREAM64_MIN_KC (internlm2-1.8b's
    w_out), else the shared body; elsewhere (its wgmma rows, n = 4) the
    shared body at block_rows(b), split 1."""
    rows = _build.block_rows(b)
    for ke, o in SHAPES:
        kc = ke * n // 4
        for requant in (False, True):
            p = masked_fp8_plan(b, ke, o, n, requant=requant)
            twin = fp8_plan(b, ke, o, n, requant=requant)
            assert p["rows"] == rows
            shared = {"body": "shared", "rows": rows, "cols": 64, "split": 1}
            if n not in (1, 2) or twin["body"] != "stream":
                assert p == shared
            elif twin["rows"] == rows:
                assert p == twin and (b <= 16 or b > 64)
            elif kc >= FP8_MASKED_STREAM64_MIN_KC:
                assert 16 < b <= 64 and twin["rows"] == 16
                assert p == {**twin, "rows": 64}
            else:
                assert 16 < b <= 64 and p == shared
            if p["body"] == "stream":
                _assert_spans(kc, p["split"])
            if n in (1, 2) and (b <= 16 or (b <= 64 and ke == 8192)):
                assert p["body"] == "stream"


def test_plans_at_the_expert_w_out():
    """The expert w_out (1536 -> 4096) 2:4: at B = 8 both take 64 tiles of
    16 rows split 4 (K8 int8's and K8 fp8's plans); at B = 64 the int8 one
    64-row tiles split 4 (K8 int8: 16-row tiles unsplit), the fp8 one the
    shared body (K_c 768; K8 fp8's split over 64-row tiles would be 1);
    internlm2-1.8b's w_out (8192 -> 2048) 2:4 at B = 64: the fp8 one 64-row
    tiles at K8 fp8's split 2."""
    ke, o = SHAPES[0]
    at8 = {"body": "stream", "rows": 16, "cols": 64, "split": 4}
    assert masked_int8_plan(8, ke, o, 2) == int8_plan(8, ke, o, 2) == at8
    assert masked_fp8_plan(8, ke, o, 2) == fp8_plan(8, ke, o, 2) == at8
    assert int8_plan(64, ke, o, 2) == {"body": "stream", "rows": 16, "cols": 64, "split": 1}
    assert masked_int8_plan(64, ke, o, 2) == {"body": "stream", "rows": 64, "cols": 64,
                                              "split": 4}
    assert fp8_plan(64, ke, o, 2)["split"] == 1
    assert masked_fp8_plan(64, ke, o, 2) == {"body": "shared", "rows": 64, "cols": 64,
                                             "split": 1}
    assert fp8_plan(64, *SHAPES[1], 2) == {"body": "stream", "rows": 16, "cols": 64, "split": 2}
    assert masked_fp8_plan(64, *SHAPES[1], 2) == {"body": "stream", "rows": 64, "cols": 64,
                                                  "split": 2}


# -------------------------------------------- what the wrappers hand their entries
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b", ROWS)
def test_masked_gathers_launch_their_plans(rec, b, n):
    """vg_nm_spmm_gather_bk_masked_int8 / _fp8 get (.., out_kind, bm, body,
    split, stream) = their plans' (bm the maps' row block) for bf16, fp32,
    the raw accumulator and the requantized codes (the fp8 codes at the
    requantizing plan); where the plan streams, the split is the unmasked
    twin's on the same rows (K8 int8 at its tile where that is the maps'
    row block)."""
    bb = _build.block_rows(b)
    for ke, o in SHAPES:
        kc = ke * n // 4
        idx = _meta(kc, dtype=torch.int32)
        xs, ws, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), ()))
        maps = torch.zeros(-(-b // bb), kc // 64, dtype=torch.int32, device="meta")
        for storage, masked, twin in ((torch.int8, gk.nm_spmm_gather_bk_masked_int8,
                                       gk.nm_spmm_gather_bk_int8),
                                      (FP8, gk.nm_spmm_gather_bk_masked_fp8,
                                       gk.nm_spmm_gather_bk_fp8)):
            xq, values = _meta(b, ke, dtype=storage), _meta(kc, o, dtype=storage)
            rec.calls.clear()
            masked(xq, values, idx, maps, maps, n, xs, ws, out_dtype=torch.bfloat16)
            masked(xq, values, idx, maps, maps, n, xs, ws)
            masked(xq, values, idx, maps, maps, n)
            masked(xq, values, idx, maps, maps, n, xs, ws, requant_scale=rq)
            twin(xq, values, idx, xs, ws, n)
            *calls, (twin_name, twin_args) = rec.calls
            assert twin_name == f"vg_{twin.__name__}"
            kinds = []
            for (name, args), requant in zip(calls, (False, False, False, True)):
                assert name == f"vg_{masked.__name__}"
                p = (masked_fp8_plan(b, ke, o, n, requant=requant) if storage == FP8
                     else masked_int8_plan(b, ke, o, n))
                assert p["rows"] == bb
                assert args[-4:-1] == (bb, BODY_CODES[p["body"]], p["split"]), args[-4:-1]
                kinds.append(args[-5])
            assert kinds == [0, 1, _build.OUT_RAW, _build.OUT_REQUANT]
            p = calls[1][1][-4:-1]
            if storage == FP8 and p[1] == BODY_CODES["stream"]:
                assert p[2] == twin_args[-3]                # K8 fp8's split
            if storage == torch.int8 and twin_args[-4] == bb:
                assert p == twin_args[-4:-1]                # K8 int8's plan


@pytest.mark.parametrize("storage", [torch.int8, FP8])
def test_masked_gathers_refuse_maps_at_another_row_block(rec, storage):
    """At 8 rows the plan's row block is 16, at 64 rows 64 (though K8 int8
    and K8 fp8 tile at 16 there): maps at another block are refused on a
    device tensor."""
    ke, o = SHAPES[0]
    masked = (gk.nm_spmm_gather_bk_masked_int8 if storage == torch.int8
              else gk.nm_spmm_gather_bk_masked_fp8)
    for b, bb, want in ((8, 64, 16), (64, 16, 64)):
        maps = torch.zeros(-(-b // bb), ke // 2 // 64, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match=f"the plan's row block is {want}"):
            masked(_meta(b, ke, dtype=storage), _meta(ke // 2, o, dtype=storage),
                   _meta(ke // 2, dtype=torch.int32), maps, maps, 2, block_b=bb)
    assert not rec.calls


# ------------------------------------------------- shared memory a block
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_masked_gather_stream_fits_the_blocks_an_sm(n, bm):
    """The masked G = n stream is K8's byte for byte (e4m3 and s8: the same
    bytes, int32 partials in the fp32 ones' place) plus the 128-byte bitmask
    (static): three 16-row blocks an SM (the 16-row splits'), two 64-row
    ones (the 64-row splits')."""
    total = _gather_stream_smem(n, bm) + LIVE_BYTES
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    assert total <= SMEM_LIMIT
    assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (n, bm, total)


# --------------------------------------------- the masked G = n walk, emulated
KC, O = 1024, 128     # 16 steps of 64 compressed rows


def _owned(rank: int, split: int, bm: int, colmajor: bool = False) -> list:
    """splitk::owned_slice: the (r, c) of the BM x 64 tile block ``rank``
    owns (row-major, or column-major)."""
    slice_ = bm * 64 // split
    return [(q % bm, q // bm) if colmajor else (q // 64, q % 64)
            for q in range(rank * slice_, (rank + 1) * slice_)]


@pytest.mark.parametrize("bm", [16, 64])
def test_dead_finish_owners_cover_the_tile_once(bm):
    """finish_zero flushes through finish_planes' owners: over the ranks of
    every split the owned slices cover the tile, each element once."""
    for split in (1, 2, 4, 8):
        for colmajor in (False, True):
            owned = [rc for r in range(split) for rc in _owned(r, split, bm, colmajor)]
            assert sorted(owned) == [(r, c) for r in range(bm) for c in range(64)]


@functools.lru_cache(maxsize=None)
def _operands(cls: str, n: int) -> tuple:
    """A seeded gather leaf of the class (values (K_c, O) and indices, the
    per-channel scale), K_c = 1024, O = 128, as the port converts it."""
    from repro_torch.core.quantize import quantize_linear
    rng = np.random.default_rng(200 + n)
    idx = _gather_idx(rng, KC, n)
    leaf = quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((KC, O)).astype(np.float32) * KC ** -0.5)},
        FP8 if cls == "e4m3" else torch.int8)
    return idx, leaf["w"], leaf["scale"].reshape(1, -1)


def _rows(rng, cls, b, n, bm, live_rows):
    """Masked 8-bit rows (whole 256 / n column steps zeroed), their row
    scales and the maps over the codes at (bm, 256 / n)."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels.actsparse import block_maps
    x, kmask = _masked_span_x(rng, b, KC * 4 // n, bm, 256 // n, live_rows)
    xq, xs = quantize_rows(torch.from_numpy(x), FP8 if cls == "e4m3" else torch.int8)
    kmap, kq = block_maps(xq, bm, 256 // n)
    assert np.array_equal(kq.numpy() != 0, kmask != 0)
    return xq, xs, kmap, kq


def _step_sums(cls, xq, v, idx, n) -> list:
    """The select pass over each step's span (select16: an index outside
    [0, 4) gives +0), then each step's products (B, O): s8 exact (the two
    k32 halves into the same int32 registers), e4m3 exact then rounded to
    fp32 (the step's two k32 instructions from zero)."""
    xg = _stream_select(xq.view(torch.uint8).numpy(), idx, n)
    if cls == "s8":
        xi, vi = xg.view(np.int8).astype(np.int64), v.numpy().astype(np.int64)
        return [xi[:, 64 * s:64 * s + 64] @ vi[64 * s:64 * s + 64] for s in range(KC // 64)]
    xf, vf = _e4m3_f32(xg).astype(np.float64), v.float().numpy().astype(np.float64)
    return [(xf[:, 64 * s:64 * s + 64] @ vf[64 * s:64 * s + 64]).astype(np.float32)
            for s in range(KC // 64)]


def _walk(cls, steps, kmask, bm, split, masked) -> np.ndarray:
    """Each row block's sums: rank r's steps of its span (with MASKED the
    live ones, kmask.cuh's walk) summed in place (s8) or in fp32 (e4m3), the
    ranks' partials added in rank order; with MASKED a row block with no live
    step takes the zero finish (no partial, no exchange: zero sums)."""
    rows = []
    for i in range(kmask.shape[0]):
        blk = [st[i * bm:(i + 1) * bm] for st in steps]
        if masked and not kmask[i].any():
            rows.append(np.zeros_like(blk[0]))
            continue
        walk = _live_walk(kmask[i]) if masked else (lambda lo, hi: range(lo, hi))
        acc = None
        for lo, hi in _spans(KC, split):
            part = np.zeros_like(blk[0])
            for s in walk(lo, hi):
                part = part + blk[s] if cls == "s8" else (part + blk[s]).astype(np.float32)
            acc = part if acc is None else (acc + part if cls == "s8"
                                             else (acc + part).astype(np.float32))
        rows.append(acc)
    acc = np.concatenate(rows)
    if cls == "s8":
        assert np.abs(acc).max(initial=0) < 2 ** 31
        return acc.astype(np.int32)
    return acc


def _ws_first(acc, xs, ws, bias):
    """SingleFlushI8<true> / SingleFlushT<true>: acc * ws * xs (one fp32
    rounding each), + bias, silu."""
    v = ((acc.astype(np.float32) * ws).astype(np.float32) * xs).astype(np.float32)
    return _silu((v + bias).astype(np.float32))


def _plan_split(cls, b, n):
    p = (masked_fp8_plan if cls == "e4m3" else masked_int8_plan)(b, KC * 4 // n, O, n)
    assert p["body"] == "stream"
    return p["rows"], p["split"]


# (class, launch rows): two 16-row blocks of 32 rows, each at a 16-row
# launch's plan (the walk does not look at the tile's rows)
CLASSES = [("s8", 16), ("e4m3", 16)]


@pytest.mark.parametrize("share", ["none", "forty", "all", "rank0_dead", "one_rank"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("cls,rows", CLASSES)
def test_masked_gather_walk_is_bitwise_the_unmasked_stream(cls, rows, n, share):
    """K_c = 1024 (16 steps of 256 / n X columns; the plans' split 8: two
    steps a rank), O = 128: the walk visits exactly each span's live steps
    in order, and the sums, the ws-first flush's fp32 and the requantized
    codes are the unmasked G = n stream's on the same masked rows, bit for
    bit; a wholly dead row block's zero finish gives the bits of the
    exchange of zero partials (bias + act of zero)."""
    rng = np.random.default_rng(210 + n)
    bm, split = _plan_split(cls, rows, n)
    assert split == 8 and bm == 16
    idx, v, ws = _operands(cls, n)
    xq, xs, _, kmask = _rows(rng, cls, 2 * bm, n, bm, _fp8_cases(rng, KC // 64)[share])
    km = kmask.numpy()
    for i in range(km.shape[0]):
        walk = _live_walk(km[i])
        for lo, hi in _spans(KC, split):
            assert walk(lo, hi) == [s for s in range(lo, hi) if km[i, s]]
    steps = _step_sums(cls, xq, v, idx, n)
    got = _walk(cls, steps, km, bm, split, masked=True)
    full = _walk(cls, steps, km, bm, split, masked=False)
    assert np.array_equal(got, full) and np.array_equal(np.signbit(got), np.signbit(full))
    if cls == "s8":
        assert np.array_equal(got, _walk(cls, steps, km, bm, 1, masked=False))
    bias = rng.standard_normal(O).astype(np.float32)
    flushed = _ws_first(got, xs.numpy(), ws.numpy(), bias)
    assert np.array_equal(flushed, _ws_first(full, xs.numpy(), ws.numpy(), bias))
    rq = np.float32(np.abs(flushed).max() / 100)
    codes = _i8_codes if cls == "s8" else _codes
    assert np.array_equal(codes(flushed, rq),
                          codes(_ws_first(full, xs.numpy(), ws.numpy(), bias), rq))
    if share == "none":
        assert not got.any()
        assert np.array_equal(flushed, np.broadcast_to(_silu(bias), flushed.shape))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("cls,rows", CLASSES)
def test_masked_gather_walk_matches_pallas(cls, rows, n):
    """The emulated masked G = n walk, the ws-first flush with bias and silu
    in fp32, against JAX's nm_spmm_gather_bk_masked int8 (acc int32) / fp8
    (acc fp32) branch (interpret; maps at the block rows x 256 / n columns)
    within 1e-6, scaled, ~40% live with a dead rank span; the requantized
    codes one step at most off JAX's
    on at most 0.1% of them (JAX's compiled flush may fuse the bias add)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import epilogue as jepi
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk_masked as j_masked

    rng = np.random.default_rng(220 + n)
    bm, split = _plan_split(cls, rows, n)
    idx, v, ws = _operands(cls, n)
    xq, xs, kmap, kmask = _rows(rng, cls, 2 * bm, n, bm,
                                [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
    acc = _walk(cls, _step_sums(cls, xq, v, idx, n), kmask.numpy(), bm, split, masked=True)
    bias = rng.standard_normal(O).astype(np.float32)
    got = _ws_first(acc, xs.numpy(), ws.numpy(), bias)
    acc_dtype = jnp.int32 if cls == "s8" else jnp.float32
    args = (_j(jnp, xq), _j(jnp, v), jnp.asarray(idx.reshape(-1, 1)), _j(jnp, kmap),
            _j(jnp, kmask), n, _j(jnp, xs), _j(jnp, ws))
    kw = dict(acc_dtype=acc_dtype, block_b=bm, block_o=O, block_ke=256 // n, interpret=True,
              bias=jnp.asarray(bias))
    want = np.asarray(j_masked(*args, out_dtype=jnp.float32,
                               epilogue=jepi.EpilogueSpec(act="silu", bias=True), **kw))
    assert_scaled_close(got, want, 1e-6)
    rq = np.float32(np.abs(want).max() / 100)
    want_q = np.asarray(j_masked(*args, requant_scale=jnp.asarray(rq), **kw,
                                 epilogue=jepi.EpilogueSpec(
                                     act="silu", bias=True,
                                     requant="int8" if cls == "s8" else "float8_e4m3fn")))
    if cls == "s8":
        delta = np.abs(_i8_codes(got, rq).astype(np.int32) - want_q.astype(np.int32))
        assert want_q.dtype == np.int8 and delta.max() <= 1 and (delta == 1).mean() <= 1e-3
    else:
        assert _step_share(_codes(got, rq), want_q.view(np.uint8)) <= 1e-3


# ----------------------------------------------------------- on the card
@contextlib.contextmanager
def _first_body():
    """The int8 masked gather on gemm_int8.cu's first body (body 0, split
    1, at the maps' row block)."""
    lib = _build.library("gemm_int8.cu")

    class _Lib:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name != "vg_nm_spmm_gather_bk_masked_int8":
                return fn
            return lambda *a: fn(*a[:-3], 0, 1, a[-1])
    saved = _build._libs["gemm_int8.cu"]
    _build._libs["gemm_int8.cu"] = _Lib()
    try:
        yield
    finally:
        _build._libs["gemm_int8.cu"] = saved


def _card_case(dev, storage, b, ke, o, n, share, seed=0, dead_rank0=False, dead_from=None):
    """Masked rows of the class (whole 256 / n column steps zeroed; rows from
    ``dead_from`` zero), the gather leaf, both scales and the maps at
    block_rows(b)."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.actsparse import block_maps
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(ke, o, generator=g, device=dev) * ke ** -0.5
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                          quantize=storage)
    span, steps = 256 // n, ke * n // 4 // 64
    live = torch.zeros(steps, dtype=torch.bool, device=dev)
    live[torch.randperm(steps, generator=g, device=dev)[:round(share * steps)]] = True
    if dead_rank0:                       # rank 0's whole span dead, the rest live
        p = (masked_fp8_plan if storage == FP8 else masked_int8_plan)(b, ke, o, n)
        live[:] = True
        live[:_spans(ke * n // 4, p["split"])[0][1]] = False
    x = torch.randn(b, ke, generator=g, device=dev).bfloat16() * live.repeat_interleave(
        span).to(torch.bfloat16)
    if dead_from is not None:
        x[dead_from:] = 0
    xq, xs = quantize_rows(x, storage)
    return (xq, leaf["values"], leaf["gather_idx"], xs, leaf["scale"].reshape(1, -1),
            block_maps(xq, _build.block_rows(b), span))


def _held(dev, storage, b, ke, o, n, share, seed, dead_rank0=False):
    """bf16, fp32 with bias + silu, the raw accumulator and the gelu codes
    of the masked gather: the same bits on a second launch and its twin's
    (K8 int8 / K8 fp8) on the same rows; int8 also the first body's and
    (bf16, raw) the plain version's; fp8 within 1e-2 of the plain version.
    Where the fp8 plan keeps the shared body (the expert's w_out at 17-64
    rows) its twin sums in another order: there the masked kernel is held
    bitwise to itself with every tile live and within 1e-2 of the twin
    (codes one e4m3 step off on at most 0.1%)."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_masked_quantized_ref
    int8 = storage == torch.int8
    xq, v, idx, xs, ws, maps = _card_case(dev, storage, b, ke, o, n, share, seed=seed,
                                          dead_rank0=dead_rank0)
    masked, twin, twin_rq = (
        (gk.nm_spmm_gather_bk_masked_int8, gk.nm_spmm_gather_bk_int8,
         gk.nm_spmm_gather_bk_int8_requant) if int8 else
        (gk.nm_spmm_gather_bk_masked_fp8, gk.nm_spmm_gather_bk_fp8,
         gk.nm_spmm_gather_bk_fp8_requant))
    p = (masked_int8_plan if int8 else masked_fp8_plan)(b, ke, o, n)
    own = p["body"] != "stream"
    assert not (own and int8), p
    all_live = (maps[0], torch.ones_like(maps[1]))
    bias = torch.randn(o, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    silu = EpilogueSpec(act="silu", bias=True)
    for scales, kw in (((xs, ws), {"out_dtype": torch.bfloat16}),
                       ((xs, ws), {"out_dtype": torch.float32, "epilogue": silu, "bias": bias}),
                       ((None, None), {})):
        before = masked.launches
        got = masked(xq, v, idx, *maps, n, *scales, **kw)
        again = masked(xq, v, idx, *maps, n, *scales, **kw)
        full = twin(xq, v, idx, *scales, n, **kw)
        same = masked(xq, v, idx, *all_live, n, *scales, **kw) if own else full
        torch.cuda.synchronize()
        assert masked.launches == before + 2 + own
        assert torch.equal(got, same), (storage, b, share, kw.keys())
        assert torch.equal(got, again), (storage, b, share)
        if own:
            assert_scaled_close(got, full, 1e-2)
        want = nm_spmm_gather_masked_quantized_ref(xq, v, idx, *maps, n, *scales,
                                                   block_b=_build.block_rows(b), **kw)
        if int8:
            with _first_body():
                first = masked(xq, v, idx, *maps, n, *scales, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, first), (b, share)
        if int8 and "epilogue" not in kw:
            assert torch.equal(got, want)
        else:
            assert_scaled_close(got, want, 1e-2)
    rq = (full.float().abs().amax() / (127.0 if int8 else 448.0)).reshape(())
    gelu = EpilogueSpec(act="gelu", bias=True)
    codes = masked(xq, v, idx, *maps, n, xs, ws, epilogue=gelu, bias=bias, requant_scale=rq)
    want_codes = twin_rq(xq, v, idx, xs, ws, n, rq, epilogue=gelu, bias=bias)
    own_codes = masked_fp8_plan(b, ke, o, n, requant=True)["body"] != "stream" and not int8
    same = masked(xq, v, idx, *all_live, n, xs, ws, epilogue=gelu, bias=bias,
                  requant_scale=rq) if own_codes else want_codes
    torch.cuda.synchronize()
    assert codes.dtype == storage
    assert torch.equal(codes.view(torch.uint8), same.view(torch.uint8))
    if own_codes:
        assert _step_share(codes.view(torch.uint8).cpu().numpy(),
                           want_codes.view(torch.uint8).cpu().numpy()) <= 1e-3
    if int8:
        with _first_body():
            first = masked(xq, v, idx, *maps, n, xs, ws, epilogue=gelu, bias=bias,
                           requant_scale=rq)
        torch.cuda.synchronize()
        assert torch.equal(codes, first)


CARD_SHARES = ((0.0, False), (0.4, False), (1.0, False), (1.0, True))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, FP8])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ke,o", SHAPES)
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_masked_gathers_bitwise_their_twins_on_card(cuda_device, b, ke, o, n, storage):
    """Both w_outs at 0%, ~40% and 100% live and with rank 0's span dead:
    bitwise the twin (and for int8 the first body; the fp8 one on the shared
    body: its all-live self) and across launches, bf16, fp32, raw and
    codes."""
    for share, dead in CARD_SHARES:
        _held(cuda_device, storage, b, ke, o, n, share, seed=b + n, dead_rank0=dead)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, FP8])
@pytest.mark.parametrize("n", [1, 2])
def test_dead_row_block_at_split_8_on_card(cuda_device, storage, n):
    """A wholly dead row block under a split of 8: the int8 one at B = 80
    over 64-row blocks (rows 64-79 zero, block 0 ~40% live) at K_eff 4096
    -> O 1024 (2 x 16 tiles: split 8), the fp8 one at B = 8 with no step
    live at internlm2-1.8b's w_out; its rows are silu(0 * scales + bias), the
    others the twin's (and the first body's), bit for bit."""
    int8 = storage == torch.int8
    b, (ke, o), dead_from, share = ((80, (4096, 1024), 64, 0.4) if int8
                                    else (8, SHAPES[1], 0, 0.0))
    p = (masked_int8_plan if int8 else masked_fp8_plan)(b, ke, o, n)
    assert p["body"] == "stream" and p["split"] == 8, p
    xq, v, idx, xs, ws, maps = _card_case(cuda_device, storage, b, ke, o, n, share, seed=10,
                                          dead_from=dead_from)
    assert not maps[1][-1].any() and (not int8 or maps[1][0].any())
    bias = torch.randn(o, generator=torch.Generator(device=cuda_device).manual_seed(9),
                       device=cuda_device)
    kw = {"epilogue": EpilogueSpec(act="silu", bias=True), "bias": bias,
          "out_dtype": torch.float32}
    masked, twin = ((gk.nm_spmm_gather_bk_masked_int8, gk.nm_spmm_gather_bk_int8) if int8
                    else (gk.nm_spmm_gather_bk_masked_fp8, gk.nm_spmm_gather_bk_fp8))
    got = masked(xq, v, idx, *maps, n, xs, ws, **kw)
    full = twin(xq, v, idx, xs, ws, n, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, full)
    if int8:
        with _first_body():
            first = masked(xq, v, idx, *maps, n, xs, ws, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, first)
    dead = got[dead_from:]
    assert torch.equal(dead, torch.nn.functional.silu(bias).expand_as(dead))


@pytest.mark.cuda
def test_refused_masked_gather_entries_raise_on_card(cuda_device):
    ke, o = 1024, 128
    for storage, lib_name in ((torch.int8, "gemm_int8.cu"), (FP8, "gemm_fp8.cu")):
        xq, v, idx, xs, ws, (_, kmask) = _card_case(cuda_device, storage, 8, ke, o, 2, 0.5)
        y = torch.empty((8, o), dtype=torch.bfloat16, device=cuda_device)
        lib = _build.library(lib_name)
        entry = getattr(lib, "vg_nm_spmm_gather_bk_masked_"
                        + ("int8" if storage == torch.int8 else "fp8"))
        # (kmask, n, bm, body, split): a kmask always; the stream at n in {1,
        # 2}, bm 16 | 64, a power of two up to min(8, K_c / 64) = 8; the first
        # body split 1; no body 2
        for km, nn, bm, body, split in ((None, 2, 16, 1, 2), (kmask, 4, 16, 1, 1),
                                        (kmask, 2, 16, 1, 3), (kmask, 2, 16, 1, 16),
                                        (kmask, 2, 32, 1, 1), (kmask, 2, 16, 0, 2),
                                        (kmask, 2, 16, 2, 1)):
            rc = entry(xq.data_ptr(), v.data_ptr(), idx.data_ptr(),
                       None if km is None else km.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                       None, None, y.data_ptr(), 8, ke, o, nn, 0, 0, bm, body, split,
                       _build.stream_of(xq))
            assert rc != 0, (storage, nn, bm, body, split)
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                _build.check(rc, "nm_spmm_gather_bk_masked", lib)
