"""The redesigned Hopper bodies of the masked int8 singles: nm_spmm_masked_int8
at n in {1, 2} (nm_spmm_int8's s8 sparse stream with MASKED, at
nm_spmm/kernel.py::int8_plan's split over its maps' row block) and
tile_gemm_masked_int8 (tile_gemm_int8's s8 dense stream with MASKED, at
tile_gemm/kernel.py::masked_int8_plan): each block folds its row block's
kmask row into kmask.cuh's bitmask and walks only the live steps of the span
its split gives it; the int32 partials of its ranks are summed in rank
order, and gemm_int8.cu's SingleFlushI8 flushes the sum.

On the CPU: ``masked_int8_plan``'s and ``int8_plan``'s row tile is
``block_rows(b)`` (the maps' row block) at qwen3-moe's expert shapes and
internlm2-1.8b's w_out, their splits legal powers of two whose spans are
whole 64-steps covering K; each masked wrapper hands its C entry its plan's
(bm, body, split) (a recording stand-in for the library, meta tensors), and
the dense one refuses maps at another row block; a block's shared memory,
with the 128-byte bitmask, fits the blocks an SM the plans assume; a numpy
emulation of the masked s8 walk (the sparse stream's per-warp transpose and
metadata words, the dense stream's A registers, exact int32 products a step,
each rank's live steps, the rank-order sum, SingleFlushI8 and the
requantized store) is bitwise the unmasked s8 emulation at 0%, ~40% and
100% live, with rank 0's whole span dead and with one rank live, and within
1e-6 (scaled) of JAX's ``nm_spmm_masked`` / ``tile_gemm_masked`` int8
branches in interpret mode.  On the card (``cuda``): both kernels bitwise
across launches, bitwise their unmasked twins and bitwise their first
bodies (bf16, fp32, the raw int32 and the requantized codes) at B in {1, 8,
33, 64}, at split boundaries and with a dead row block flushing bias + act
of zero; the entries refuse what they do not take."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm import kernel as nk
from repro_torch.kernels.nm_spmm.kernel import int8_plan, split_k
from repro_torch.kernels.tile_gemm import kernel as tk
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, BODY_CODES,
                                                  FP8_STREAM16_BLOCKS_PER_SM, cluster_split,
                                                  masked_int8_plan)
from repro_torch.kernels.tile_gemm.kernel import int8_plan as tile_int8_plan
from test_torch_fp8_kmajor_dual_redesign import _check_dense_fragments
from test_torch_fp8_sparse_redesign import BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _assert_spans, _j
from test_torch_int8_stream_redesign import (_dense_e4m3_smem, _i8_codes, _i8_flush,
                                             _int8_weight, _meta, _s8_step_products,
                                             rec)  # noqa: F401
from test_torch_masked_stream_redesign import (EXPERT, LIVE_BYTES, MAX_K_STEPS, _fp8_cases,
                                               _fp8_single_smem, _silu)
from test_torch_nm_dual_masked_redesign import _live_walk, _masked_x
from test_torch_redesign import _spans
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

#: qwen3-moe's expert shapes and internlm2-1.8b's w_out (K, O)
SHAPES = [EXPERT["w_out"], EXPERT["gate_up"], (8192, 2048)]
ROWS = [1, 8, 17, 33, 64, 65, 256]


def test_internlm2_w_out_is_the_config():
    from repro_torch.configs import get_config
    cfg = get_config("internlm2_1_8b")
    assert SHAPES[2] == (cfg.d_ff, cfg.d_model)
    assert all(k // 64 <= MAX_K_STEPS for k, _ in SHAPES)


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("b", ROWS)
def test_plans_tile_at_the_maps_row_block(b):
    """masked_int8_plan: the s8 dense stream over block_rows(b) rows, which
    is int8_plan's plan wherever its tile is that row block, else the
    64-row stream split at BLOCKS_PER_SM blocks an SM.  nm_spmm's int8_plan
    (the masked compressed single's) splits over block_rows(b)-row tiles
    (split_k's) at n in {1, 2}.  Every split a legal power of two whose
    spans are whole 64-steps covering K."""
    rows = _build.block_rows(b)
    for k, o in SHAPES:
        p, twin = masked_int8_plan(b, k, o), tile_int8_plan(b, k, o)
        assert p["body"] == "stream" and p["rows"] == rows and p["cols"] == 64
        if twin["rows"] == rows:
            assert p == twin
        else:
            assert b > 16 and twin["rows"] == 16
            assert p["split"] == cluster_split((o // 64) * -(-b // 64), k // 64, BLOCKS_PER_SM)
        _assert_spans(k, p["split"])
        for n in (1, 2):
            q = int8_plan(b, k, o, n)
            assert q == {"body": "sparse", "split": split_k(b, k, o, n)}
            assert q["split"] == cluster_split((o // 64) * -(-b // rows), k // 64)
            _assert_spans(k, q["split"])
        assert int8_plan(b, k, o, 4) == {"body": "shared", "split": 1}


def test_plans_at_the_expert_w_out():
    """The expert w_out (1536, 4096): at B = 8 64 tiles of 16 rows split 4
    (both singles); at B = 64, where int8_plan tiles tile_gemm_int8 at 16
    rows (24 steps a block unsplit), the masked dense single takes 64-row
    tiles split 4 at two blocks an SM."""
    k, o = EXPERT["w_out"]
    assert masked_int8_plan(8, k, o) == {"body": "stream", "rows": 16, "cols": 64, "split": 4}
    assert int8_plan(8, k, o, 2) == {"body": "sparse", "split": 4}
    assert tile_int8_plan(64, k, o) == {"body": "stream", "rows": 16, "cols": 64, "split": 1}
    assert masked_int8_plan(64, k, o) == {"body": "stream", "rows": 64, "cols": 64, "split": 4}
    assert int8_plan(64, k, o, 2) == {"body": "sparse", "split": 4}


# -------------------------------------------- what the wrappers hand their entries
@pytest.mark.parametrize("b", ROWS)
def test_masked_wrappers_launch_their_plans(rec, b):
    """vg_tile_gemm_masked_int8 and vg_nm_spmm_masked_int8 get (.., bm,
    body, split, stream) = their plans' (bm the maps' row block), for bf16,
    fp32, the raw int32 and the requantized codes, as the unmasked twins
    get theirs."""
    bb = _build.block_rows(b)
    for k, o in SHAPES:
        xq = _meta(b, k)
        xs, ws, rq = (torch.empty(s, device="meta") for s in ((b, 1), (1, o), ()))
        maps = torch.zeros(-(-b // bb), k // 64, dtype=torch.int32, device="meta")
        calls = (((xs, ws), {"out_dtype": torch.bfloat16}), ((xs, ws), {}), ((None, None), {}),
                 ((xs, ws), {"requant_scale": rq}))
        p = masked_int8_plan(b, k, o)
        rec.calls.clear()
        for scales, kw in calls:
            tk.tile_gemm_masked_int8(xq, _meta(k, o), maps, maps, *scales, **kw)
        kinds = []
        for name, args in rec.calls:
            assert name == "vg_tile_gemm_masked_int8"
            assert args[-4:-1] == (bb, BODY_CODES["stream"], p["split"]), args[-4:-1]
            kinds.append(args[-5])
        assert kinds == [0, 1, _build.OUT_RAW, _build.OUT_REQUANT]
        for n in (1, 2, 4):
            kc = k * n // 4
            values, meta = _meta(kc, o), _meta(kc // 4, o, dtype=torch.uint8)
            q = int8_plan(b, k, o, n)
            rec.calls.clear()
            for scales, kw in calls:
                nk.nm_spmm_masked_int8(xq, values, meta, maps, maps, n, *scales, **kw)
            nk.nm_spmm_int8(xq, values, meta, xs, ws, n)
            *masked, (twin_name, twin) = rec.calls
            assert twin_name == "vg_nm_spmm_int8"
            for name, args in masked:
                assert name == "vg_nm_spmm_masked_int8"
                assert args[-4:-1] == (bb, int(q["body"] == "sparse"), q["split"])
                assert args[-4:-1] == twin[-4:-1]
            assert [a[-5] for _, a in masked] == kinds


def test_masked_dense_int8_refuses_maps_at_another_row_block(rec):
    """At 8 rows the plan's row block is 16 (and at 64 rows 64, though
    tile_gemm_int8 tiles at 16 there): maps at another block are refused on
    a device tensor."""
    k, o = EXPERT["w_out"]
    for b, bb, want in ((8, 64, 16), (64, 16, 64)):
        maps = torch.zeros(-(-b // bb), k // 64, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match=f"the plan's row block is {want}"):
            tk.tile_gemm_masked_int8(_meta(b, k), _meta(k, o), maps, maps, block_b=bb)
    assert not rec.calls


# ------------------------------------------------- shared memory a block
@pytest.mark.parametrize("bm", [16, 64])
def test_masked_s8_streams_fit_the_blocks_an_sm(bm):
    """The s8 singles keep the e4m3 layouts byte for byte (int32 partials and
    inbox in the fp32 ones' bytes); MASKED adds the 128-byte bitmask
    (static).  Three 16-row blocks an SM (masked_int8_plan's 16-row split),
    two 64-row ones (and split_k's two at either tile)."""
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM
    for total in (_fp8_single_smem(1, bm), _fp8_single_smem(2, bm), _dense_e4m3_smem(bm)):
        total += LIVE_BYTES
        assert total <= SMEM_LIMIT
        assert per_sm * (total + BLOCK_RESERVED) <= SM_SMEM, (bm, total)
        assert BLOCKS_PER_SM * (total + BLOCK_RESERVED) <= SM_SMEM


# --------------------------------------------- the masked s8 walks, emulated
B, K, O, BM = 128, 1024, 128, 64     # two 64-row blocks, 16 steps, the plans' split 8


def _int8_rows(rng, live_rows):
    """int8 rows of a masked X (row scales) and the maps over the codes."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels.actsparse import block_maps

    x, kmask = _masked_x(rng, B, K, BM, live_rows)
    xq, xs = quantize_rows(torch.from_numpy(x), torch.int8)
    kmap, kq = block_maps(xq, BM, 64)
    assert np.array_equal(kq.numpy() != 0, kmask != 0)
    return xq, xs, kmap, kq


@functools.lru_cache(maxsize=None)
def _operands(layout: str, n: int) -> tuple:
    """A seeded int8 weight leaf of ``layout`` and each 64-deep step's
    operand (64, O) as the s8 stream multiplies it: the dense weight's rows
    (the two k32 halves of mma.sync m16n8k32 s8 -> s32 summed in one int32
    partial), or the compressed tile transposed per warp and spread by its
    metadata words (mma.sp m16n8k64 s8 -> s32); the same for every case."""
    from repro_torch.core.quantize import quantize_linear
    rng = np.random.default_rng(160 + n)
    if layout == "dense":
        w = torch.from_numpy(rng.standard_normal((K, O)).astype(np.float32) * K ** -0.5)
        leaf = quantize_linear({"w": w}, torch.int8)
        wi = leaf["w"].numpy().astype(np.int64)
        return leaf, [wi[64 * s:64 * s + 64] for s in range(K // 64)]
    leaf = _int8_weight(rng, K, O, n)
    eye = np.eye(64, dtype=np.int8)
    ops = _s8_step_products(np.tile(eye, (1, K // 64)), leaf["values"].numpy(),
                            leaf["meta_packed"].numpy(), n)
    return leaf, ops


def _step_products(xq: np.ndarray, ops: list) -> list:
    """Each 64-deep step's exact int8 products (B, O)."""
    xi = xq.astype(np.int64)
    return [xi[:, 64 * s:64 * s + 64] @ op for s, op in enumerate(ops)]


def _walk_acc(steps: list, kmask: np.ndarray, split: int, masked: bool) -> np.ndarray:
    """Each row block's int32 sums: rank r's steps of its span (with MASKED
    the live ones, kmask.cuh's walk) summed in place, the ranks' partials
    added in rank order."""
    rows = []
    for i in range(kmask.shape[0]):
        walk = _live_walk(kmask[i]) if masked else (lambda lo, hi: range(lo, hi))
        acc = None
        for lo, hi in _spans(64 * len(steps), split):
            part = np.zeros_like(steps[0][i * BM:(i + 1) * BM])
            for s in walk(lo, hi):
                part = part + steps[s][i * BM:(i + 1) * BM]
            acc = part if acc is None else acc + part
        rows.append(acc)
    acc = np.concatenate(rows)
    assert np.abs(acc).max(initial=0) < 2 ** 31
    return acc.astype(np.int32)


def _flush(acc, xs, ws, bias):
    """SingleFlushI8 with bias and silu: float(acc) * xs * ws, + bias, silu."""
    return _silu(_i8_flush(acc, xs, ws, bias))


def _split(layout, n):
    p = masked_int8_plan(B, K, O) if layout == "dense" else int8_plan(B, K, O, n)
    assert p["split"] == 8 and (layout != "dense" or p["rows"] == BM)
    return p["split"]


LAYOUTS = [("dense", 4), ("compressed", 2), ("compressed", 1)]


def test_masked_dense_s8_reads_the_dense_streams_operand():
    """The masked dense s8 walk reads its A registers as the unmasked dense
    stream does (ldmatrix .trans + __byte_perm from the swizzled landed
    tile; the int8 bytes as they are)."""
    from repro_torch.core.quantize import quantize_linear
    w = torch.from_numpy(np.random.default_rng(170).standard_normal((64, 64)).astype(np.float32))
    _check_dense_fragments(quantize_linear({"w": w}, torch.int8)["w"].view(torch.uint8).numpy())


@pytest.mark.parametrize("share", ["none", "forty", "all", "rank0_dead", "one_rank"])
@pytest.mark.parametrize("layout,n", LAYOUTS)
def test_masked_s8_walk_is_bitwise_the_unmasked_stream(layout, n, share):
    """B = 128 over two 64-row blocks, K = 1024 (16 steps; the plans' split
    8: two steps a rank), O = 128: the walk visits exactly each span's live
    steps in order, and the int32 sums, SingleFlushI8's fp32 output and the
    requantized codes are the unmasked s8 stream's on the same masked rows,
    bit for bit; a row block with no live step flushes bias + act of
    zero."""
    rng = np.random.default_rng(170 + n)
    split = _split(layout, n)
    leaf, ops = _operands(layout, n)
    xq, xs, _, kmask = _int8_rows(rng, _fp8_cases(rng, K // 64)[share])
    km = kmask.numpy()
    for i in range(km.shape[0]):
        walk = _live_walk(km[i])
        for lo, hi in _spans(K, split):
            assert walk(lo, hi) == [s for s in range(lo, hi) if km[i, s]]
    steps = _step_products(xq.numpy(), ops)
    got = _walk_acc(steps, km, split, masked=True)
    full = _walk_acc(steps, km, split, masked=False)
    assert np.array_equal(got, full)
    assert np.array_equal(got, _walk_acc(steps, km, 1, masked=False))
    ws, bias = leaf["scale"].reshape(1, -1).numpy(), rng.standard_normal(O).astype(np.float32)
    flushed = _flush(got, xs.numpy(), ws, bias)
    assert np.array_equal(flushed, _flush(full, xs.numpy(), ws, bias))
    rq = np.float32(np.abs(flushed).max() / 100)
    assert np.array_equal(_i8_codes(flushed, rq), _i8_codes(_flush(full, xs.numpy(), ws, bias),
                                                            rq))
    if share == "none":
        assert not got.any()
        assert np.array_equal(flushed, np.broadcast_to(_silu(bias), flushed.shape))


@pytest.mark.parametrize("layout,n", LAYOUTS)
def test_masked_s8_walk_matches_pallas(layout, n):
    """The emulated masked s8 walk, SingleFlushI8 with bias and silu in fp32,
    against JAX's tile_gemm_masked / nm_spmm_masked int8 branch (interpret;
    acc int32, maps at 64 rows x 64 columns) within 1e-6, scaled, ~40% live
    with a dead rank span; the requantized codes one step at most off
    JAX's on at most 0.1% of them (JAX's compiled flush may fuse the bias
    add)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import epilogue as jepi
    from repro.kernels.nm_spmm.kernel import nm_spmm_masked as j_nm_masked
    from repro.kernels.tile_gemm.kernel import tile_gemm_masked as j_tile_masked

    rng = np.random.default_rng(180 + n)
    split = _split(layout, n)
    leaf, ops = _operands(layout, n)
    xq, xs, kmap, kmask = _int8_rows(rng, [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
    acc = _walk_acc(_step_products(xq.numpy(), ops), kmask.numpy(), split, masked=True)
    ws = leaf["scale"].reshape(1, -1)
    bias = rng.standard_normal(O).astype(np.float32)
    got = _flush(acc, xs.numpy(), ws.numpy(), bias)
    if layout == "dense":
        fn, ops, kw = j_tile_masked, (_j(jnp, leaf["w"]),), dict(block_k=64)
    else:
        fn, ops, kw = (j_nm_masked, (_j(jnp, leaf["values"]), _j(jnp, leaf["meta_packed"])),
                       dict(block_ke=64))
    nn = () if layout == "dense" else (n,)
    args = (_j(jnp, xq), *ops, _j(jnp, kmap), _j(jnp, kmask), *nn)
    kw.update(block_b=BM, block_o=128, acc_dtype=jnp.int32, interpret=True)
    scales = (_j(jnp, xs), _j(jnp, ws))
    want = np.asarray(fn(*args, *scales, out_dtype=jnp.float32, bias=jnp.asarray(bias),
                         epilogue=jepi.EpilogueSpec(act="silu", bias=True), **kw))
    assert_scaled_close(got, want, 1e-6)
    rq = np.float32(np.abs(want).max() / 100)
    want_q = np.asarray(fn(*args, *scales, bias=jnp.asarray(bias), requant_scale=jnp.asarray(rq),
                           epilogue=jepi.EpilogueSpec(act="silu", bias=True, requant="int8"),
                           **kw))
    delta = np.abs(_i8_codes(got, rq).astype(np.int32) - want_q.astype(np.int32))
    assert want_q.dtype == np.int8 and delta.max() <= 1 and (delta == 1).mean() <= 1e-3


# ----------------------------------------------------------- on the card
@contextlib.contextmanager
def _first_body():
    """The masked int8 wrappers on gemm_int8.cu's first body (body 0, split
    1, at the maps' row block)."""
    lib = _build.library("gemm_int8.cu")

    class _Lib:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in ("vg_nm_spmm_masked_int8", "vg_tile_gemm_masked_int8"):
                return fn
            return lambda *a: fn(*a[:-3], 0, 1, a[-1])
    saved = _build._libs["gemm_int8.cu"]
    _build._libs["gemm_int8.cu"] = _Lib()
    try:
        yield
    finally:
        _build._libs["gemm_int8.cu"] = saved


def _card_case(dev, layout, b, k, o, n, share, seed=0, dead_rank0=False, dead_from=None):
    """Masked int8 rows (rows from ``dead_from`` zero), the weight's operands
    (dense w, or values + meta), both scales, the maps at block_rows(b), and
    the masked and unmasked wrappers."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.kernels.actsparse import block_maps
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    steps = k // 64
    live = torch.zeros(steps, dtype=torch.bool, device=dev)
    live[torch.randperm(steps, generator=g, device=dev)[:round(share * steps)]] = True
    if dead_rank0:                       # rank 0's whole span dead, the rest live
        split = (masked_int8_plan(b, k, o) if layout == "dense" else int8_plan(b, k, o, n))
        live[:] = True
        live[:_spans(k, split["split"])[0][1]] = False
    x = torch.randn(b, k, generator=g, device=dev).bfloat16() * live.repeat_interleave(64).to(
        torch.bfloat16)
    if dead_from is not None:
        x[dead_from:] = 0
    xq, xs = quantize_rows(x, torch.int8)
    if layout == "dense":
        leaf = quantize_linear({"w": w}, torch.int8)
        ops, fns = (leaf["w"],), (tk.tile_gemm_masked_int8, tk.tile_gemm_int8,
                                  tk.tile_gemm_int8_requant)
    else:
        c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
        leaf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)},
                               torch.int8)
        ops, fns = (leaf["values"], leaf["meta_packed"]), (nk.nm_spmm_masked_int8,
                                                           nk.nm_spmm_int8,
                                                           nk.nm_spmm_int8_requant)
    return xq, ops, xs, leaf["scale"].reshape(1, -1), block_maps(xq, _build.block_rows(b), 64), \
        fns


def _held(dev, layout, b, k, o, n, share, seed, dead_rank0=False):
    """bf16, fp32 with bias + silu, the raw int32 and the gelu codes of the
    masked kernel: the same bits on a second launch, the unmasked twin's and
    the first body's; bf16 and raw also the plain version's."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_masked_quantized_ref
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_masked_quantized_ref
    xq, ops, xs, ws, maps, (masked, twin, twin_rq) = _card_case(
        dev, layout, b, k, o, n, share, seed=seed, dead_rank0=dead_rank0)
    nn = () if layout == "dense" else (n,)
    ref = tile_gemm_masked_quantized_ref if layout == "dense" else nm_spmm_masked_quantized_ref
    bias = torch.randn(o, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    silu = EpilogueSpec(act="silu", bias=True)
    for scales, kw in (((xs, ws), {"out_dtype": torch.bfloat16}),
                       ((xs, ws), {"out_dtype": torch.float32, "epilogue": silu, "bias": bias}),
                       ((None, None), {})):
        before = masked.launches
        got = masked(xq, *ops, *maps, *nn, *scales, **kw)
        again = masked(xq, *ops, *maps, *nn, *scales, **kw)
        full = twin(xq, *ops, *scales, *nn, **kw)
        with _first_body():
            first = masked(xq, *ops, *maps, *nn, *scales, **kw)
        torch.cuda.synchronize()
        assert masked.launches == before + 3
        assert torch.equal(got, full), (layout, b, share, kw.keys())
        assert torch.equal(got, again) and torch.equal(got, first), (layout, b, share)
        want = ref(xq, *ops, *maps, *nn, *scales, block_b=_build.block_rows(b), **kw)
        if "epilogue" in kw:
            assert_scaled_close(got, want, 1e-2)
        else:
            assert torch.equal(got, want)
    rq = (full.abs().amax() / 100).reshape(())
    gelu = EpilogueSpec(act="gelu", bias=True)
    codes = masked(xq, *ops, *maps, *nn, xs, ws, epilogue=gelu, bias=bias, requant_scale=rq)
    with _first_body():
        first = masked(xq, *ops, *maps, *nn, xs, ws, epilogue=gelu, bias=bias, requant_scale=rq)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int8
    assert torch.equal(codes, twin_rq(xq, *ops, xs, ws, *nn, rq, epilogue=gelu, bias=bias))
    assert torch.equal(codes, first)


CARD_SHARES = ((0.0, False), (0.4, False), (1.0, False), (1.0, True))
CARD_ROWS = [1, 8, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,n", LAYOUTS)
@pytest.mark.parametrize("k,o", list(EXPERT.values()))
@pytest.mark.parametrize("b", CARD_ROWS)
def test_masked_int8_bitwise_twin_and_first_body_on_card(cuda_device, b, k, o, layout, n):
    """qwen3-moe's expert shapes at 0%, ~40% and 100% live and with rank 0's
    span dead: bitwise the unmasked twin, the first body and across
    launches (bf16, fp32, raw int32, codes)."""
    for share, dead in CARD_SHARES:
        _held(cuda_device, layout, b, k, o, n, share, seed=b + n, dead_rank0=dead)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,n", LAYOUTS)
@pytest.mark.parametrize("k,o", [(320, 64), (448, 128), (1216, 256)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_masked_int8_at_split_boundaries_on_card(cuda_device, b, k, o, layout, n):
    """K = 64 x steps not divisible by the split: uneven spans, ~40% live."""
    p = masked_int8_plan(b, k, o) if layout == "dense" else int8_plan(b, k, o, n)
    assert p["split"] > 1 and (k // 64) % p["split"], p
    _held(cuda_device, layout, b, k, o, n, 0.4, seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,n", LAYOUTS)
def test_masked_int8_dead_row_block_flushes_bias_and_act_on_card(cuda_device, layout, n):
    """B = 80 over 64-row blocks at the gate-up shape: rows 64-79 all zero,
    so block 1 walks no step; its rows are silu(0 * scales + bias), the
    others the twin's and the first body's."""
    k, o = EXPERT["gate_up"]
    bias = torch.randn(o, generator=torch.Generator(device=cuda_device).manual_seed(9),
                       device=cuda_device)
    spec = EpilogueSpec(act="silu", bias=True)
    xq, ops, xs, ws, maps, (masked, twin, _) = _card_case(cuda_device, layout, 80, k, o, n, 0.4,
                                                           seed=10, dead_from=64)
    assert not maps[1][1].any() and maps[1][0].any()
    nn = () if layout == "dense" else (n,)
    kw = {"epilogue": spec, "bias": bias, "out_dtype": torch.float32}
    got = masked(xq, *ops, *maps, *nn, xs, ws, **kw)
    with _first_body():
        first = masked(xq, *ops, *maps, *nn, xs, ws, **kw)
    full = twin(xq, *ops, xs, ws, *nn, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, full) and torch.equal(got, first)
    assert_scaled_close(got[64:], torch.nn.functional.silu(bias).expand(16, o), 1e-6)


@pytest.mark.cuda
def test_refused_masked_int8_entries_raise_on_card(cuda_device):
    xq, (values, meta), xs, ws, (_, kmask), _ = _card_case(cuda_device, "compressed", 8, 256,
                                                           128, 2, 0.5)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library("gemm_int8.cu")
    # (kmask, n, bm, body, split): a kmask always; the stream at n in {1, 2},
    # bm 16 | 64, a power of two up to min(8, K / 64) = 4; the first body
    # split 1; no body 2
    for km, nn, bm, body, split in ((None, 2, 16, 1, 2), (kmask, 4, 16, 1, 1),
                                    (kmask, 2, 16, 1, 3), (kmask, 2, 16, 1, 8),
                                    (kmask, 2, 32, 1, 1), (kmask, 2, 16, 0, 2),
                                    (kmask, 2, 16, 2, 1)):
        rc = lib.vg_nm_spmm_masked_int8(xq.data_ptr(), values.data_ptr(), meta.data_ptr(),
                                        None if km is None else km.data_ptr(), xs.data_ptr(),
                                        ws.data_ptr(), None, None, y.data_ptr(), 8, 256, 128, nn,
                                        0, 0, bm, body, split, _build.stream_of(xq))
        assert rc != 0, (nn, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_masked_int8", lib)
    w = torch.zeros((256, 128), dtype=torch.int8, device=cuda_device)
    for km, bm, body, split in ((None, 16, 1, 2), (kmask, 16, 1, 3), (kmask, 16, 1, 8),
                                (kmask, 32, 1, 1), (kmask, 16, 0, 2), (kmask, 16, 2, 1)):
        rc = lib.vg_tile_gemm_masked_int8(xq.data_ptr(), w.data_ptr(),
                                          None if km is None else km.data_ptr(), xs.data_ptr(),
                                          ws.data_ptr(), None, None, y.data_ptr(), 8, 256, 128,
                                          0, 0, bm, body, split, _build.stream_of(xq))
        assert rc != 0, (bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm_masked_int8", lib)
