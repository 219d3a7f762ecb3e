"""The redesigned Hopper bodies of tile_gemm (K1, bf16: a streaming body
over the dense weight with split-K over a cluster for few rows, a
warp-specialised TMA + wgmma body for many) and nm_spmm_fp8 at n in {1, 2}
(the e4m3 sparse tensor cores, split-K over a cluster).

On the CPU: K1's planner (the streaming body covers the card at
internlm2-1.8b's decode sites, its split spans are whole 64-steps covering
K, the wgmma body is chosen at hubert-xlarge's 4,000 and phi-3-vision's
1,024 prefill rows); every body's shared memory fits a block; the e4m3
k64 metadata words the fp8 body builds from the JAX package's
``meta_packed`` (2:4 as stored, 1:4 spread) are the instruction's; and an
emulation of the fp8 body's operand (its per-warp transpose, 1:4 as 2:4
with a +0, one fp32 partial per 64-deep step) reproduces the raw
accumulator of the JAX package's ``nm_spmm_fp8`` (Pallas, interpret mode)
and its plain reference within 1e-6, scaled.  On the card (``cuda``):
both kernels bitwise the same across launches and at every split
boundary, K1 at B in {1, 8, 33, 64, 256, 1024, 4000} with the bias / silu
/ gelu epilogues and the fp32 store (the bf16 store its rounding),
nm_spmm_fp8 at n in {1, 2} and B in {1, 8, 33, 64, 256} in every
out_kind, the e4m3 probe, and refused splits.  Tolerances: 1e-2 of
max|plain| for K1 (bf16) and the scaled fp8 outputs, the raw fp8
accumulator 1e-2 (sums in another order), requantized e4m3 codes one step
off on at most 0.1% of them (as ``tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import nm as tnm
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.mma_sp_probe import expand_1of4, metadata_words_e4m3
from repro_torch.kernels.nm_spmm.kernel import (FP8_SHARED_TILES, fp8_plan, nm_spmm_fp8,
                                                nm_spmm_fp8_requant, split_k)
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, MAX_SPLIT, SMS, WGMMA_COLS,
                                                  WGMMA_MIN_ROWS, WGMMA_ROWS, WIDE_MIN_COLS,
                                                  WIDE_MIN_ROWS, plan, tile_gemm)
from repro_torch.kernels.tile_gemm.ref import tile_gemm_ref
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into (H100)
FP8 = torch.float8_e4m3fn


def _sites(arch):
    """(K, O) of each distinct single-GEMM site of a config, from get_config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return list(dict.fromkeys([(cfg.d_model, cfg.attn_dim), (cfg.d_model, cfg.kv_dim),
                               (cfg.attn_dim, cfg.d_model), (cfg.d_ff, cfg.d_model),
                               (cfg.d_model, cfg.d_ff)]))


def _spans(k: int, split: int):
    """Block r's K steps, as splitk.cuh's span computes them."""
    steps = k // 64
    return [(r * steps // split, (r + 1) * steps // split) for r in range(split)]


# ------------------------------------------------------------ K1's planner
@pytest.mark.parametrize("b", [1, 8, 16])
def test_stream_body_covers_the_card_at_decode(b):
    for k, o in _sites("internlm2_1_8b")[:3]:       # q / k / v / o, w_out
        p = plan(b, k, o)
        blocks = (o // 64) * p["split"]
        assert p["body"] == "stream" and p["rows"] == 16 and p["cols"] == 64
        assert 1 < p["split"] <= MAX_SPLIT and p["split"] & (p["split"] - 1) == 0
        assert 0.95 * SMS <= blocks <= BLOCKS_PER_SM * SMS, (k, o, p)


@pytest.mark.parametrize("k,o", [(64, 64), (192, 64), (320, 64), (448, 128), (1216, 256),
                                 (1152, 6912), (2048, 1024), (8192, 2048)])
@pytest.mark.parametrize("b", [1, 8, 33, 64, 192])
def test_stream_split_spans_are_whole_steps_covering_k(k, o, b):
    p = plan(b, k, o)
    assert p["body"] == "stream" and p["rows"] == _build.block_rows(b)
    spans = _spans(k, p["split"])
    assert p["split"] <= k // 64
    assert spans[0][0] == 0 and spans[-1][1] == k // 64
    assert all(lo < hi for lo, hi in spans)                    # no block without a step
    assert all(spans[r][1] == spans[r + 1][0] for r in range(p["split"] - 1))


@pytest.mark.parametrize("arch,rows", [("hubert_xlarge", 4000), ("phi_3_vision_4_2b", 1024)])
def test_wgmma_body_at_prefill_rows(arch, rows):
    for k, o in _sites(arch):
        p = plan(rows, k, o)
        wide = rows >= WIDE_MIN_ROWS and o >= WIDE_MIN_COLS
        assert p == {"body": "wgmma", "rows": WGMMA_ROWS, "cols": WGMMA_COLS[wide],
                     "split": 1}, (arch, k, o, p)
        assert p["cols"] == (128 if o == 1280 else 256)      # hubert's O = 1280 sites
        assert plan(WGMMA_MIN_ROWS, k, o)["cols"] == 128      # the calibration forward
    for b in (1, 8, 64, WGMMA_MIN_ROWS - 1):     # decode and the engine's prefill chunks
        assert all(plan(b, k, o)["body"] == "stream" for k, o in _sites(arch))


# ------------------------------------------------------ nm_spmm_fp8's plan
@pytest.mark.parametrize("n", [1, 2])
def test_fp8_plan_takes_the_sparse_body_where_it_won(n):
    sites = _sites("internlm2_1_8b")[:3]     # the single sites: q / k / v / o, w_out
    for b in (1, 8, 16, 33, 64):              # decode, and the engine's 64-row chunks
        for k, o in sites:
            assert fp8_plan(b, k, o, n) == {"body": "sparse", "split": split_k(b, k, o, n)}
    for k, o in sites:                        # the calibration forward's 256 rows
        tiles = (o // 64) * 4
        assert fp8_plan(256, k, o, n)["body"] == ("sparse" if tiles < FP8_SHARED_TILES
                                                  else "shared")
    k, o = 1152, 6912                         # gemma3-1b's w_in
    assert fp8_plan(8, k, o, n)["body"] == "sparse"
    assert fp8_plan(64, k, o, n) == {"body": "shared", "split": 1}
    assert fp8_plan(8, 2048, 2048, 4) == {"body": "shared", "split": 1}


# ------------------------------------------------- every body fits a block
def _stream_smem(n, bm):
    """nm_spmm_sp.cuh's ring + inbox (bf16; n = 4 is K1's dense stream)."""
    stages = 4 if (bm == 16 or n == 4) else 3
    vrows = 64 * n // 4
    stage = vrows * 72 * 2 + (0 if n == 4 else vrows // 4 * 64) + bm * 72 * 2
    return max(stages * stage, bm * 68 * 4) + bm * 64 * 4


def _fp8_smem(n, bm):
    """nm_spmm_sp_fp8.cuh's ring + transposed A tiles + inbox."""
    stages = 6 if bm == 16 else 4
    mt = 1 if bm == 16 else 2
    vrows = 64 * n // 4
    stage = vrows * 80 + vrows // 4 * 64 + bm * 80
    return max(stages * stage, bm * 68 * 4) + 4 * mt * 16 * 48 + bm * 64 * 4


def _wgmma_smem(bn):
    """tile_gemm_sm90.cuh's ring + mbarriers + two epilogue tiles + slack."""
    stages, epc = (5, 64) if bn == 128 else (4, 32)
    return (stages * (128 * 64 * 2 + 64 * bn * 2) + 2 * stages * 8 + 2 * 64 * (epc + 4) * 4
            + 1024)


@pytest.mark.parametrize("body,bytes_", [
    *[(f"stream n={n} bm={bm}", _stream_smem(n, bm)) for n in (1, 2, 4) for bm in (16, 64)],
    *[(f"fp8 n={n} bm={bm}", _fp8_smem(n, bm)) for n in (1, 2) for bm in (16, 64)],
    *[(f"wgmma bn={bn}", _wgmma_smem(bn)) for bn in (128, 256)]])
def test_every_body_fits_a_block(body, bytes_):
    assert bytes_ <= SMEM_LIMIT, body
    if body.startswith(("stream", "fp8")):      # two blocks an SM, as planned
        assert BLOCKS_PER_SM * bytes_ <= 228 * 1024, body


# ------------------------------- the e4m3 operand the sparse tensor core reads
def _jax_compressed_fp8(w: np.ndarray, n: int):
    """(values e4m3 bytes, meta_packed, values as float) from the JAX
    package's compressor, the kept values rounded to e4m3."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import nm

    pruned, _ = nm.prune_nm(jnp.asarray(w), n, 4)
    c = nm.compress_nm(pruned, n, 4)
    v8 = np.asarray(c.values.astype(jnp.float8_e4m3fn))
    return v8, np.array(nm.pack_meta(c.meta)), v8.astype(np.float32)


def _kernel_words(packed: np.ndarray, n: int, step: int, c: int) -> np.ndarray:
    """The metadata words nm_spmm_sp_fp8.cuh builds from meta_packed bytes
    for channels c .. c + 15 at 64-deep step ``step``, lane by lane: lane
    4g + t reads channel c + g + 8 (t & 1), groups 8 (t >> 1) .. + 7."""
    e = np.zeros(32, np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        ch, h = c + g + 8 * (t & 1), t >> 1
        if n == 2:   # meta rows 8 step + 4h .. + 3 of the channel, as stored
            rows = packed[8 * step + 4 * h:8 * step + 4 * h + 4, ch].astype(np.uint32)
            e[lane] = rows[0] | rows[1] << 8 | rows[2] << 16 | rows[3] << 24
        else:        # meta rows 4 step + 2h, + 1, spread from 1:4 to 2:4
            rows = packed[4 * step + 2 * h:4 * step + 2 * h + 2, ch].astype(np.uint32)
            e[lane] = expand_1of4(int(rows[0] | rows[1] << 8))
    return e


def _pairs(idx: np.ndarray, n: int, step: int, c: int) -> np.ndarray:
    """(16 channels, 16 groups, 2) kept indices of a 64-deep step: 2:4 as
    stored, 1:4 as (0, 1) for index 0, else (0, index)."""
    if n == 2:
        return idx[32 * step:32 * step + 32, c:c + 16].T.reshape(16, 16, 2)
    one = idx[16 * step:16 * step + 16, c:c + 16].T
    return np.stack([np.zeros_like(one), np.where(one == 0, 1, one)], -1)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_e4m3_metadata_words_come_from_meta_packed_as_it_is(n, seed):
    rng = np.random.default_rng(seed)
    k, o = 256, 64
    _, packed, _ = _jax_compressed_fp8(rng.standard_normal((k, o)).astype(np.float32), n)
    idx = tnm.unpack_meta(torch.from_numpy(packed)).numpy()        # (K_c, O)
    for step in range(k // 64):
        for c in (0, 16, 48):
            pairs = _pairs(idx, n, step, c)
            assert np.all(pairs[..., 0] < pairs[..., 1])              # sorted and distinct
            assert np.array_equal(_kernel_words(packed, n, step, c), metadata_words_e4m3(pairs))


def _transposed_step(vals: np.ndarray, packed: np.ndarray, n: int, step: int) -> np.ndarray:
    """The fp8 body's per-warp transposed A tile of one step for every
    channel: (O, 32) kept values, 2:4 as stored, 1:4 with the kept value in
    the slot of its index and a +0 in the other (pair8_1of4)."""
    if n == 2:
        return vals[32 * step:32 * step + 32].T.copy()
    rows = vals[16 * step:16 * step + 16]                        # (16, O): one per group
    idx = tnm.unpack_meta(torch.from_numpy(packed)).numpy()[16 * step:16 * step + 16]
    out = np.zeros((vals.shape[1], 32), np.float32)
    out[:, 0::2] = np.where(idx == 0, rows, 0).T
    out[:, 1::2] = np.where(idx == 0, 0, rows).T
    return out


def _emulate_raw(xq: np.ndarray, vals: np.ndarray, packed: np.ndarray, n: int) -> np.ndarray:
    """The raw fp32 accumulator as the fp8 body forms it: per 64-deep step
    the dense product of the transposed operand under its metadata words
    (one instruction from zero), added into an fp32 accumulator."""
    b, k = xq.shape
    o = vals.shape[1]
    idx = tnm.unpack_meta(torch.from_numpy(packed)).numpy()
    acc = np.zeros((b, o), np.float32)
    for step in range(k // 64):
        a = _transposed_step(vals, packed, n, step)               # (O, 32)
        dense = np.zeros((o, 64), np.float32)
        for c in range(0, o, 16):
            pairs = _pairs(idx, n, step, c)                        # what the words say
            for m in range(16):
                for j in range(16):
                    for s in range(2):
                        dense[c + m, 4 * j + pairs[m, j, s]] += a[c + m, 2 * j + s]
        part = (xq[:, 64 * step:64 * step + 64].astype(np.float64) @ dense.T.astype(np.float64))
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("n", [1, 2])
def test_e4m3_operand_reproduces_the_raw_accumulator(n):
    """e4m3 inputs: the body's operand (1:4 with its +0) and its per-step
    fp32 promotion reproduce JAX's nm_spmm_fp8 raw accumulator (Pallas,
    interpret mode) and its plain reference within 1e-6, scaled."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm.kernel import nm_spmm_fp8 as j_nm_fp8
    from repro.kernels.nm_spmm.ref import nm_spmm_ref as j_ref

    rng = np.random.default_rng(3 + n)
    b, k, o = 8, 256, 128
    w = rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5
    v8, packed, vals = _jax_compressed_fp8(w, n)
    x8 = np.asarray(jnp.asarray(rng.standard_normal((b, k)).astype(np.float32))
                    .astype(jnp.float8_e4m3fn))
    xf = x8.astype(np.float32)
    got = _emulate_raw(xf, vals, packed, n)
    want = j_nm_fp8(jnp.asarray(x8), jnp.asarray(v8), jnp.asarray(packed), None, None, n,
                    interpret=True)
    assert_scaled_close(got, np.asarray(want), 1e-6)
    assert_scaled_close(got, np.asarray(j_ref(jnp.asarray(xf), jnp.asarray(vals),
                                              jnp.asarray(packed), n)), 1e-6)


# ----------------------------------------------------------- on the card
def _dense_case(dev, b, k, o, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    return x, w


def _fp8_case(dev, b, k, o, n, seed=0):
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
    leaf = quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)}, FP8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0                                              # an idle slot
    xq, xs = quantize_rows(x, FP8)
    return xq, xs, leaf["values"], leaf["meta_packed"], leaf["scale"].reshape(1, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", [(8, 2048, 1024), (8, 8192, 2048), (64, 2048, 2048),
                                   (256, 2048, 2048), (1024, 3072, 3072), (4000, 1280, 1280)])
def test_tile_gemm_bitwise_deterministic_on_card(cuda_device, b, k, o):
    x, w = _dense_case(cuda_device, b, k, o)
    first = tile_gemm(x, w)
    again = [tile_gemm(x, w) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in again)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b,k,o", [(8, 2048, 1024), (8, 8192, 2048), (64, 2048, 2048)])
def test_nm_spmm_fp8_bitwise_deterministic_on_card(cuda_device, n, b, k, o):
    xq, xs, v, m, ws = _fp8_case(cuda_device, b, k, o, n)
    first = nm_spmm_fp8(xq, v, m, None, None, n)
    again = [nm_spmm_fp8(xq, v, m, None, None, n) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in again)


SPLIT_SHAPES = [(192, 64), (320, 64), (448, 128), (1216, 256), (1088, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", SPLIT_SHAPES)
@pytest.mark.parametrize("b", [1, 8])
def test_tile_gemm_at_split_boundaries_on_card(cuda_device, k, o, b):
    """K = 64 x steps not divisible by the split: uneven spans per block."""
    p = plan(b, k, o)
    assert p["split"] > 1 and (k // 64) % p["split"]
    x, w = _dense_case(cuda_device, b, k, o)
    got = tile_gemm(x, w)
    torch.cuda.synchronize()
    assert_scaled_close(got, tile_gemm_ref(x, w), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", SPLIT_SHAPES)
@pytest.mark.parametrize("b", [1, 8])
def test_nm_spmm_fp8_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_quantized_ref
    split = split_k(b, k, o, n)
    assert split > 1 and (k // 64) % split
    xq, xs, v, m, ws = _fp8_case(cuda_device, b, k, o, n)
    got = nm_spmm_fp8(xq, v, m, None, None, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_quantized_ref(xq, v, m, None, None, n), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 33, 64, 256, 1024, 4000])
@pytest.mark.parametrize("act,bias", [(None, False), (None, True), ("silu", False),
                                      ("gelu", True)])
def test_tile_gemm_epilogues_and_fp32_store_on_card(cuda_device, b, act, bias):
    k, o = {1024: (3072, 3072), 4000: (1280, 1280)}.get(b, (2048, 1024))
    x, w = _dense_case(cuda_device, b, k, o, seed=b)
    bv = torch.randn(o, device=cuda_device) if bias else None
    spec = EpilogueSpec(act=act, bias=bias)
    before = tile_gemm.launches
    y16 = tile_gemm(x, w, epilogue=spec, bias=bv)
    y32 = tile_gemm(x, w, epilogue=spec, bias=bv, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tile_gemm.launches == before + 2
    assert_scaled_close(y16, tile_gemm_ref(x, w, epilogue=spec, bias=bv), 1e-2)
    assert_scaled_close(y32, tile_gemm_ref(x, w, epilogue=spec, bias=bv,
                                           out_dtype=torch.float32), 1e-2)
    assert torch.equal(y16, y32.bfloat16())


def _e4m3_step_share(got, want) -> float:
    def ordinal(t):
        b = t.view(torch.uint8).int()
        return torch.where(b >= 128, -(b - 128), b)
    d = (ordinal(got) - ordinal(want)).abs()
    assert d.max().item() <= 1
    return (d == 1).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 33, 64, 256])
def test_nm_spmm_fp8_every_out_kind_on_card(cuda_device, n, b):
    from repro_torch.kernels.nm_spmm.ref import (nm_spmm_fp8_requant_ref,
                                                 nm_spmm_quantized_ref)
    k, o = 2048, 1024
    xq, xs, v, m, ws = _fp8_case(cuda_device, b, k, o, n, seed=b)
    raw = nm_spmm_fp8(xq, v, m, None, None, n)
    assert raw.dtype == torch.float32
    assert_scaled_close(raw, nm_spmm_quantized_ref(xq, v, m, None, None, n), 1e-2)
    bias = torch.randn(o, device=cuda_device) * 0.1
    for act, bv in ((None, None), ("silu", bias), ("gelu", bias)):
        spec = EpilogueSpec(act=act, bias=bv is not None)
        for dt in (torch.bfloat16, torch.float32):
            got = nm_spmm_fp8(xq, v, m, xs, ws, n, epilogue=spec, bias=bv, out_dtype=dt)
            want = nm_spmm_quantized_ref(xq, v, m, xs, ws, n, epilogue=spec, bias=bv,
                                         out_dtype=dt)
            assert got.dtype == dt
            assert_scaled_close(got, want, 1e-2)
    gelu = EpilogueSpec(act="gelu", bias=True)
    y = nm_spmm_fp8(xq, v, m, xs, ws, n, epilogue=gelu, bias=bias)
    rq = (y.abs().amax() / 300).reshape(())
    before = nm_spmm_fp8_requant.launches
    codes = nm_spmm_fp8_requant(xq, v, m, xs, ws, n, rq, epilogue=gelu, bias=bias)
    torch.cuda.synchronize()
    assert nm_spmm_fp8_requant.launches == before + 1 and codes.dtype == FP8
    want = nm_spmm_fp8_requant_ref(xq, v, m, xs, ws, n, rq, epilogue=gelu, bias=bias)
    assert _e4m3_step_share(codes, want) <= 1e-3


@pytest.mark.cuda
def test_e4m3_probe_pins_the_layout_on_card(cuda_device):
    from repro_torch.kernels.mma_sp_probe import probe
    found = probe(str(cuda_device))
    assert found["e4m3"]["ok"], found["e4m3"]


@pytest.mark.cuda
def test_refused_splits_raise_on_card(cuda_device):
    x, w = _dense_case(cuda_device, 8, 128, 64)
    y = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library()
    st = _build.stream_of(x)
    for bm, bn, split in ((16, 64, 0), (16, 64, 3 * MAX_SPLIT), (16, 64, 3), (128, 128, 2),
                          (16, 128, 1), (128, 64, 1)):
        rc = lib.vg_tile_gemm(x.data_ptr(), w.data_ptr(), None, y.data_ptr(), 8, 128, 64, 0,
                              0, bm, bn, split, st)
        assert rc != 0, (bm, bn, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "tile_gemm", lib)
    xq, xs, v, m, ws = _fp8_case(cuda_device, 8, 128, 64, 2)
    y32 = torch.empty((8, 64), dtype=torch.float32, device=cuda_device)
    lib8 = _build.library("gemm_fp8.cu")
    # (n, body, split): body 1 is the sparse body (n in {1, 2}), 0 the shared one (split 1)
    for n, body, split in ((2, 1, 0), (2, 1, 3), (2, 1, 4), (1, 1, 3 * MAX_SPLIT), (4, 1, 1),
                           (2, 0, 2), (2, 2, 1)):
        rc = lib8.vg_nm_spmm_fp8(xq.data_ptr(), v.data_ptr(), m.data_ptr(), None, None, None,
                                 None, y32.data_ptr(), 8, 128, 64, n, 0, 2, 16, body, split,
                                 _build.stream_of(xq))
        assert rc != 0, (n, body, split)
