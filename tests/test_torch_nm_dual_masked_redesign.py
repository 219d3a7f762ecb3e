"""The redesigned Hopper bodies of the float compressed gate-up dual
nm_spmm_dual at n in {1, 2} (K2's sparse stream in DUAL form: both
weights' values and meta tiles a stage, one X tile, one mma.sp a weight,
split-K over a cluster, one silu(g) * u flush) and of the bf16 masked
nm_spmm_masked at n in {1, 2} (K2's sparse stream walking only the live
steps of each block's split span).

On the CPU: ``nm_spmm/kernel.py::dual_plan`` at the gate-up pairs of
internlm2-1.8b, phi-3-vision and qwen3-moe's experts (16-row streams at
decode rows, 64-row streams above, the shared body at n = 4 and at 1:4
where a 64-row launch below 256 rows cannot split K; spans whole 64-steps
covering K); the compressed dual stream's shared memory (both meta tiles) fits two
blocks an SM; a numpy emulation of the dual stream (each weight's metadata
words built from ``meta_packed`` as the kernel builds them, 1:4 as 2:4,
the split's partials summed in rank order, silu(g) * u in fp32, one bf16
cast) reproduces the JAX package's ``nm_spmm_dual`` (Pallas, interpret
mode) within 1e-6, scaled; a numpy emulation of the masked stream (the
row block's kmask row folded into ``kmask.cuh``'s bitmask, each rank
walking the live steps of its span) is bitwise the unmasked emulation on
the same masked X at 0%, ~40% and 100% live and with one rank's whole span
dead, and within 1e-6 of JAX's ``nm_spmm_masked`` (interpret).  On the card
(``cuda``): both kernels bitwise across launches and within 1e-2 of
max|plain|, at split boundaries, the masked kernel bitwise ``nm_spmm`` on
the same masked X, a dead row block flushing bias + act of zero, refused
splits raising."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm.kernel import (DUAL_1OF4_SHARED_MAX_ROWS, dual_plan, nm_spmm,
                                                nm_spmm_dual, nm_spmm_masked, split_k)
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, MAX_SPLIT, SMS, cluster_split,
                                                  stream_plan)
from test_torch_redesign import _as_2of4, _kernel_words, _spans
from test_torch_dual_redesign import _silu
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into (H100)
SM_SMEM = 228 * 1024         # shared memory of an SM
BLOCK_RESERVED = 1024        # shared memory the system keeps for each resident block
GATE_UP = {"internlm2_1_8b": (2048, 8192), "phi_3_vision_4_2b": (3072, 8192),
           "qwen3_moe_235b_a22b": (4096, 1536)}


def test_gate_up_pairs_are_the_configs():
    from repro_torch.configs import get_config
    for arch, pair in GATE_UP.items():
        cfg = get_config(arch)
        assert pair == (cfg.d_model, cfg.d_ff), arch


def _assert_spans(k: int, split: int):
    """Block r's 64-deep steps (splitk.cuh's span): whole, non-empty,
    contiguous, covering K."""
    assert k % 64 == 0 and 1 <= split <= min(MAX_SPLIT, k // 64) and split & (split - 1) == 0
    spans = _spans(k, split)
    assert spans[0][0] == 0 and spans[-1][1] == k // 64
    assert all(lo < hi for lo, hi in spans)
    assert all(spans[r][1] == spans[r + 1][0] for r in range(split - 1))


# ------------------------------------------------------------- the planner
@pytest.mark.parametrize("b", [1, 8, 16])
def test_dual_plan_streams_at_decode_rows(b):
    """16-row tiles: internlm2-1.8b's gate-up 128 tiles split 2, phi-3's
    128 split 2, qwen3-moe's expert gate-up 24 tiles split 8, at 2:4 and
    1:4 (the stream's steps are 64 of K_eff either way)."""
    for arch, split in (("internlm2_1_8b", 2), ("phi_3_vision_4_2b", 2),
                        ("qwen3_moe_235b_a22b", 8)):
        k, o = GATE_UP[arch]
        for n in (1, 2):
            p = dual_plan(b, k, o, n)
            assert p == {"body": "stream", "rows": 16, "cols": 64, "split": split}, (arch, n, p)
            assert p == stream_plan(b, k, o)
            assert (o // 64) * split <= BLOCKS_PER_SM * SMS
            _assert_spans(k, split)


@pytest.mark.parametrize("b", [17, 33, 64, 96, 128, 192, 255, 256, 1024])
def test_dual_plan_at_chunk_and_prefill_rows(b):
    """64-row tiles past 16 rows, split at two blocks an SM: internlm2-1.8b's
    and phi-3's 128 channel tiles split 2 up to 64 rows, 1 above;
    qwen3-moe's 24 split 8 to 64 rows, then 4, 2, 1.  1:4 where the 64-row
    launch cannot split keeps the shared body up to 255 rows."""
    qwen3 = {17: 8, 33: 8, 64: 8, 96: 4, 128: 4, 192: 2, 255: 2, 256: 2, 1024: 1}
    for arch, (k, o) in GATE_UP.items():
        tiles = (o // 64) * -(-b // 64)
        split = cluster_split(tiles, k // 64, BLOCKS_PER_SM)
        want = qwen3[b] if arch == "qwen3_moe_235b_a22b" else 2 if b <= 64 else 1
        assert split == want, (arch, b, split)
        assert split == 1 or tiles * split <= BLOCKS_PER_SM * SMS
        for n in (1, 2):
            p = dual_plan(b, k, o, n)
            if n == 1 and split == 1 and b <= DUAL_1OF4_SHARED_MAX_ROWS:
                assert p == {"body": "shared", "rows": 64, "cols": 64, "split": 1}, (arch, b, p)
            else:
                assert p == {"body": "stream", "rows": 64, "cols": 64, "split": split}, p
                _assert_spans(k, split)


def test_dual_plan_at_n4_keeps_the_shared_body():
    for b in (1, 8, 64, 1024):
        for k, o in GATE_UP.values():
            assert dual_plan(b, k, o, 4) == {"body": "shared", "rows": 16 if b <= 16 else 64,
                                             "cols": 64, "split": 1}


@pytest.mark.parametrize("k", [192, 320, 1152, 1216, 2048, 4096])
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_dual_and_masked_splits_are_whole_steps_covering_k(k, b):
    for o in (64, 1536, 8192):
        for n in (1, 2):
            _assert_spans(k, dual_plan(b, k, o, n)["split"])
            _assert_spans(k, split_k(b, k, o, n))      # the masked kernel's split


# ------------------------------------------------- shared memory a block
def _stream_smem(n: int, bm: int, dual: bool):
    """nm_spmm_sp.cuh's Layout<N, BM, 0, DUAL> at N in {1, 2}: (stage bytes,
    ring + inbox bytes).  A stage is [values][values][meta][meta][X]."""
    nw = 2 if dual else 1
    stages = 4 if bm == 16 else 3
    vrows = 64 * n // 4
    v_bytes, m_bytes, x_bytes = vrows * (64 + 8) * 2, vrows // 4 * 64, bm * (64 + 8) * 2
    stage = nw * (v_bytes + m_bytes) + x_bytes
    ring = max(stages * stage, nw * bm * (64 + 4) * 4)
    return stage, ring + nw * bm * 64 * 4


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_compressed_dual_stream_fits_two_blocks_an_sm(n, bm):
    """Both weights' meta tiles in each stage; two blocks an SM (the plans'
    BLOCKS_PER_SM) at either tile.  The masked single adds kmask.cuh's
    128-byte bitmask to the single's layout."""
    stage, total = _stream_smem(n, bm, True)
    assert stage % 16 == 0 and total <= SMEM_LIMIT
    assert BLOCKS_PER_SM * (total + BLOCK_RESERVED) <= SM_SMEM, (n, bm, total)
    if n == 2:   # 2:4: ~12.5 KB a stage (~57 KB) at 16 rows, ~19 KB (~89 KB) at 64
        assert (stage, total) == ((12544, 58368) if bm == 16 else (19456, 91136))
    _, single = _stream_smem(n, bm, False)
    assert BLOCKS_PER_SM * (single + 128 + BLOCK_RESERVED) <= SM_SMEM


# --------------------------------------------- the dual stream, emulated
def _jax_compressed(rng, k, o, n):
    """(values, meta_packed, pruned dense) numpy from the JAX package's
    compressor, bf16 values."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import nm

    w = jnp.asarray((rng.standard_normal((k, o)) * k ** -0.5).astype(np.float32))
    pruned, _ = nm.prune_nm(w.astype(jnp.bfloat16), n, 4)
    c = nm.compress_nm(pruned, n, 4)
    return (np.asarray(c.values.astype(jnp.float32)), np.array(nm.pack_meta(c.meta)),
            np.asarray(pruned.astype(jnp.float32)))


def _operand_dense(values: np.ndarray, packed: np.ndarray, n: int) -> np.ndarray:
    """The dense (K, O) weight mma.sp multiplies, rebuilt from what the
    kernel hands it: per 32-K step and 16-channel tile, lane 4g + t (t in
    {0, 1}) holds the metadata word of channels c + g (low half) and c + g
    + 8 (high half) over K groups 4t .. 4t + 3 of the step, two 2-bit
    indices a group; kept value s of global group G lands at K 4G + index s
    (1:4 as 2:4: the value beside a +0)."""
    vals, _ = _as_2of4(torch.tensor(values), torch.tensor(packed), n)
    vals = vals.numpy()                                  # (K / 4, 2, O)
    k, o = vals.shape[0] * 4, vals.shape[2]
    dense = np.zeros((k, o), np.float32)
    for step in range(k // 32):
        for c in range(0, o, 16):
            e = _kernel_words(packed, n, step, c)
            for lane in range(32):
                g, t = divmod(lane, 4)
                if t > 1:
                    continue
                for h in range(2):
                    ch = c + g + 8 * h
                    for j in range(4):
                        grp = 8 * step + 4 * t + j
                        for s in range(2):
                            i = (int(e[lane]) >> (16 * h + 4 * j + 2 * s)) & 3
                            dense[4 * grp + i, ch] += vals[grp, s, ch]
    return dense


def _step_sums(x32: np.ndarray, w32: np.ndarray, steps) -> np.ndarray:
    """One block's fp32 accumulator over the 64-deep steps it walks."""
    acc = np.zeros((x32.shape[0], w32.shape[1]), np.float32)
    for s in steps:
        lo, hi = 64 * s, 64 * s + 64
        p = x32[:, lo:hi].astype(np.float64) @ w32[lo:hi].astype(np.float64)
        acc = (acc + p.astype(np.float32)).astype(np.float32)
    return acc


def _stream(x32, w32, split, walk=lambda lo, hi: range(lo, hi)):
    """The split's sum: block r's partial over walk(its span), the owners
    adding the partials in rank order."""
    total = None
    for lo, hi in _spans(x32.shape[1], split):
        part = _step_sums(x32, w32, walk(lo, hi))
        total = part if total is None else (total + part).astype(np.float32)
    return total


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """fp32 -> bf16, round to nearest even (the kernel's one cast), as int."""
    return torch.from_numpy(a.astype(np.float32)).bfloat16().view(torch.int16).numpy().astype(
        np.int32)


def _bf16_ulps(got_bits: np.ndarray, want_bits: np.ndarray) -> np.ndarray:
    def ordinal(v):
        return np.where(v < 0, -(v & 0x7FFF), v)
    return np.abs(ordinal(got_bits) - ordinal(want_bits))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [8, 24])
def test_dual_stream_reproduces_pallas(b, n):
    """K_eff = 256, O = 128: each weight's operand rebuilt from its own
    metadata words is its pruned weight; the plan's split (4: 16-row tiles
    at B = 8, 64-row at 24) summed in rank order, silu(g) * u in fp32,
    against JAX's nm_spmm_dual (interpret) within 1e-6; the one bf16 cast
    within one bf16 step of JAX's bf16 output on every element."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm.kernel import nm_spmm_dual as j_dual

    rng = np.random.default_rng(60 + 2 * b + n)
    k, o = 256, 128
    p = dual_plan(b, k, o, n)
    assert p["body"] == "stream" and p["split"] == 4 and p["rows"] == (16 if b <= 16 else 64)
    x = np.asarray(jnp.asarray(rng.standard_normal((b, k)).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    weights = [_jax_compressed(rng, k, o, n) for _ in range(2)]
    acc = []
    for values, packed, pruned in weights:
        dense = _operand_dense(values, packed, n)
        assert np.array_equal(dense, pruned)
        acc.append(_stream(x, dense, p["split"]))
    got = (_silu(acc[0]) * acc[1]).astype(np.float32)
    args = [jnp.asarray(x).astype(jnp.bfloat16)]
    for values, packed, _ in weights:
        args += [jnp.asarray(values).astype(jnp.bfloat16), jnp.asarray(packed)]
    want = j_dual(*args, n, out_dtype=jnp.float32, interpret=True)
    assert_scaled_close(got, np.asarray(want), 1e-6)
    want16 = j_dual(*args, n, out_dtype=jnp.bfloat16, interpret=True)
    want_bits = np.asarray(want16).view(np.int16).astype(np.int32)
    assert _bf16_ulps(_bf16_bits(got), want_bits).max() <= 1


# ------------------------------------------- the masked stream, emulated
class _LiveSteps:
    """kmask.cuh's LiveSteps over one row of kmask: the bitmask, count and
    next, operation for operation."""

    def __init__(self, row: np.ndarray):
        self.bits = [0] * (-(-len(row) // 32))
        for s, v in enumerate(row):
            if v != 0:
                self.bits[s >> 5] |= 1 << (s & 31)

    def count(self, s: int, e: int) -> int:
        c = 0
        while s < e:
            w = self.bits[s >> 5] >> (s & 31)
            if e - s < 32:
                w &= (1 << (e - s)) - 1
            c += bin(w).count("1")
            s = (s | 31) + 1
        return c

    def next(self, s: int, nk: int) -> int:
        while s < nk:
            w = self.bits[s >> 5] >> (s & 31)
            if w:
                return s + ((w & -w).bit_length() - 1)
            s = (s | 31) + 1
        return nk


def _live_walk(row: np.ndarray):
    """walk(lo, hi) of nm_spmm_sp.cuh's MASKED block: count the span's live
    steps, then at(i) returns the cursor and moves it to the next live
    step, once for each i in order."""
    live = _LiveSteps(row)

    def walk(lo, hi):
        ns, cur, out = live.count(lo, hi), live.next(lo, hi), []
        for _ in range(ns):
            out.append(cur)
            cur = live.next(cur + 1, hi)
        return out
    return walk


def _masked_x(rng, b, k, bm, live_rows):
    """bf16-valued X whose row block i is zero outside the 64-column steps
    live_rows[i] names, and its kmask (block_maps at (bm, 64))."""
    x = rng.standard_normal((b, k)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    kmask = np.zeros((-(-b // bm), k // 64), np.int32)
    for i, steps in enumerate(live_rows):
        keep = np.zeros(k // 64, bool)
        keep[list(steps)] = True
        x[i * bm:(i + 1) * bm] *= np.repeat(keep, 64)
        kmask[i] = np.abs(x[i * bm:(i + 1) * bm]).reshape(-1, k // 64, 64).max((0, 2)) > 0
    return x, kmask


def _emulate(x, w, kmask, bm, split, masked):
    rows = []
    for i in range(kmask.shape[0]):
        xr = x[i * bm:(i + 1) * bm]
        rows.append(_stream(xr, w, split, _live_walk(kmask[i])) if masked
                    else _stream(xr, w, split))
    return np.concatenate(rows)


@pytest.mark.parametrize("n", [1, 2])
def test_masked_walk_is_bitwise_the_unmasked_stream(n):
    """B = 32 over two 16-row blocks, K_eff = 1024 (16 steps, nm_spmm's
    split 8: two steps a rank): the walk visits exactly the span's live
    steps, in order, and its sums are the unmasked stream's on the same
    masked X, bit for bit, at 0%, ~40% and 100% live, with rank 0's whole
    span dead and with every rank but one dead."""
    rng = np.random.default_rng(70 + n)
    b, k, o, bm = 32, 1024, 128, 16
    split = split_k(b, k, o, n)
    assert split == 8
    values, packed, _ = _jax_compressed(rng, k, o, n)
    w = _operand_dense(values, packed, n)
    steps = k // 64
    forty = sorted(rng.choice(steps, round(0.4 * steps), replace=False))
    cases = {"none": [[], []], "forty": [forty, sorted(rng.choice(steps, 7, replace=False))],
             "all": [range(steps), range(steps)], "rank0_dead": [range(2, steps), forty],
             "one_rank": [[9], range(10, 12)]}
    for name, live_rows in cases.items():
        x, kmask = _masked_x(rng, b, k, bm, live_rows)
        for i in range(kmask.shape[0]):
            walk = _live_walk(kmask[i])
            for lo, hi in _spans(k, split):
                assert walk(lo, hi) == [s for s in range(lo, hi) if kmask[i, s]], name
        got = _emulate(x, w, kmask, bm, split, masked=True)
        assert np.array_equal(got, _emulate(x, w, kmask, bm, split, masked=False)), name
        if name == "none":
            assert not got.any()


def test_masked_walk_matches_pallas():
    """The masked stream's sums, bias and silu in fp32, against JAX's
    nm_spmm_masked (interpret; maps at 16 rows x 64 columns) within 1e-6:
    2:4 and 1:4, ~40% live with a dead rank span."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import actsparse as ja
    from repro.kernels.epilogue import EpilogueSpec
    from repro.kernels.nm_spmm.kernel import nm_spmm_masked as j_masked

    b, k, o, bm = 32, 1024, 128, 16
    for n in (1, 2):
        rng = np.random.default_rng(80 + n)
        values, packed, _ = _jax_compressed(rng, k, o, n)
        w = _operand_dense(values, packed, n)
        split = split_k(b, k, o, n)
        x, kmask = _masked_x(rng, b, k, bm, [[0, 1, 5, 6, 11], [3, 4, 8, 9, 12, 15]])
        bias = rng.standard_normal(o).astype(np.float32)
        acc = _emulate(x, w, kmask, bm, split, masked=True) + bias
        got = (acc / (np.float32(1) + np.exp(-acc))).astype(np.float32)
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        kmap, jk = ja.block_maps(jx, bm, 64)
        assert np.array_equal(np.asarray(jk) != 0, kmask != 0)
        want = j_masked(jx, jnp.asarray(values).astype(jnp.bfloat16), jnp.asarray(packed), kmap,
                        jk, n, block_b=bm, block_o=128, block_ke=64, out_dtype=jnp.float32,
                        interpret=True, epilogue=EpilogueSpec(act="silu", bias=True),
                        bias=jnp.asarray(bias))
        assert_scaled_close(got, np.asarray(want), 1e-6)


# ----------------------------------------------------------- on the card
def _compressed(dev, k, o, n, g):
    from repro_torch.core import nm
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
    return c.values, nm.pack_meta(c.meta)


def _dual_case(dev, b, k, o, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0                                          # an idle slot
    return (x, *_compressed(dev, k, o, n, g), *_compressed(dev, k, o, n, g), n)


CARD_ROWS = [1, 8, 33, 64, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(2048, 8192), (4096, 1536)])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", CARD_ROWS)
def test_nm_spmm_dual_bitwise_and_close_on_card(cuda_device, n, b, k, o):
    """internlm2-1.8b's and qwen3-moe's expert gate-up on the body of the
    plan: within 1e-2 of the plain version, the same bits on every launch,
    one launch counted a call."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_ref
    args = _dual_case(cuda_device, b, k, o, n, seed=b)
    before = nm_spmm_dual.launches
    first = nm_spmm_dual(*args)
    again = [nm_spmm_dual(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert nm_spmm_dual.launches == before + 3
    assert all(torch.equal(first, y) for y in again)
    assert_scaled_close(first, nm_spmm_dual_ref(*args), 1e-2)


def _dual_body(lib, args, body, bm, split):
    x, vg, mg, vu, mu, n = args
    b, k = x.shape
    y = torch.empty((b, vg.shape[1]), dtype=torch.bfloat16, device=x.device)
    rc = lib.vg_nm_spmm_dual(x.data_ptr(), vg.data_ptr(), mg.data_ptr(), vu.data_ptr(),
                             mu.data_ptr(), y.data_ptr(), b, k, vg.shape[1], n, bm, body, split,
                             _build.stream_of(x))
    _build.check(rc, "nm_spmm_dual", lib)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(320, 64), (448, 128), (1216, 256), (1088, 512)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_nm_spmm_dual_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K = 64 x steps not divisible by the split: uneven spans; both tiles
    of the stream at the plan's split, bitwise across launches."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_ref
    args = _dual_case(cuda_device, b, k, o, n)
    p = dual_plan(b, k, o, n)
    assert p["body"] == "stream" and p["split"] > 1 and (k // 64) % p["split"], p
    want = nm_spmm_dual_ref(*args)
    got = nm_spmm_dual(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, want, 1e-2)
    assert torch.equal(got, nm_spmm_dual(*args))
    lib = _build.library()
    for bm in (16, 64):
        y = _dual_body(lib, args, 1, bm, p["split"])
        torch.cuda.synchronize()
        assert_scaled_close(y, want, 1e-2)
        assert torch.equal(y, _dual_body(lib, args, 1, bm, p["split"]))


def _masked_case(dev, b, k, o, n, share, seed=0, dead_rank0=False):
    from repro_torch.kernels.actsparse import block_maps
    g = torch.Generator(device=dev).manual_seed(seed)
    values, meta = _compressed(dev, k, o, n, g)
    steps = k // 64
    live = torch.zeros(steps, dtype=torch.bool, device=dev)
    live[torch.randperm(steps, generator=g, device=dev)[:round(share * steps)]] = True
    if dead_rank0:                      # rank 0's whole span dead, the rest live
        live[:] = True
        live[:_spans(k, split_k(b, k, o, n))[0][1]] = False
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x = x * live.repeat_interleave(64).to(x.dtype)
    return x, values, meta, block_maps(x, _build.block_rows(b), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(1536, 4096), (4096, 1536)])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [8, 64])
def test_nm_spmm_masked_bitwise_nm_spmm_on_card(cuda_device, b, n, k, o):
    """qwen3-moe's expert w_out shapes at 0%, ~40% and 100% live and with
    rank 0's span dead, with and without bias + silu: bitwise nm_spmm on the
    same masked X and across launches, within 1e-2 of the plain version."""
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_masked_ref
    bias = torch.randn(o, generator=torch.Generator(device=cuda_device).manual_seed(1),
                       device=cuda_device)
    for share, dead in ((0.0, False), (0.4, False), (1.0, False), (1.0, True)):
        x, values, meta, maps = _masked_case(cuda_device, b, k, o, n, share, seed=b + n,
                                             dead_rank0=dead)
        for spec, bv in ((None, None), (EpilogueSpec(act="silu", bias=True), bias)):
            kw = {} if spec is None else {"epilogue": spec, "bias": bv}
            got = nm_spmm_masked(x, values, meta, *maps, n, **kw)
            again = nm_spmm_masked(x, values, meta, *maps, n, **kw)
            full = nm_spmm(x, values, meta, n, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, full), (share, dead, spec)
            assert torch.equal(got, again)
            assert_scaled_close(got, nm_spmm_masked_ref(x, values, meta, *maps, n,
                                                        block_b=_build.block_rows(b), **kw), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(320, 64), (448, 128), (1216, 256)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_nm_spmm_masked_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    x, values, meta, maps = _masked_case(cuda_device, b, k, o, n, 0.4, seed=3)
    assert (k // 64) % split_k(b, k, o, n)
    got = nm_spmm_masked(x, values, meta, *maps, n)
    torch.cuda.synchronize()
    assert torch.equal(got, nm_spmm(x, values, meta, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_nm_spmm_masked_dead_row_block_flushes_bias_and_act_on_card(cuda_device, n):
    """B = 40 over 16-row blocks: block 1 (rows 16-31) all zero, so no step
    is live there; its rows are silu(0 + bias), the others nm_spmm's."""
    from repro_torch.kernels.actsparse import block_maps
    from repro_torch.kernels.epilogue import EpilogueSpec
    k, o = 1536, 4096
    g = torch.Generator(device=cuda_device).manual_seed(9)
    values, meta = _compressed(cuda_device, k, o, n, g)
    x = torch.randn(40, k, generator=g, device=cuda_device).bfloat16()
    x[16:32] = 0
    maps = block_maps(x, 16, 64)
    assert not maps[1][1].any() and maps[1][0].all()
    bias = torch.randn(o, generator=g, device=cuda_device)
    spec = EpilogueSpec(act="silu", bias=True)
    got = nm_spmm_masked(x, values, meta, *maps, n, epilogue=spec, bias=bias, block_b=16)
    full = nm_spmm(x, values, meta, n, epilogue=spec, bias=bias, block_b=16)
    torch.cuda.synchronize()
    assert torch.equal(got, full)
    dead = torch.nn.functional.silu(bias).expand(16, o).to(got.dtype)
    assert_scaled_close(got[16:32], dead, 1e-2)


@pytest.mark.cuda
def test_refused_splits_and_bodies_raise_on_card(cuda_device):
    x, vg, mg, vu, mu, n = _dual_case(cuda_device, 8, 256, 128, 2)
    y = torch.empty((8, 128), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library()
    # (n, bm, body, split): the shared body takes split 1; the stream n in {1, 2},
    # bm 16 | 64, a power of two up to min(8, K / 64) = 4
    for nn, bm, body, split in ((2, 16, 0, 2), (2, 16, 1, 3), (2, 16, 1, 8), (2, 16, 1, 0),
                                (4, 16, 1, 1), (2, 32, 1, 1), (2, 16, 2, 1)):
        rc = lib.vg_nm_spmm_dual(x.data_ptr(), vg.data_ptr(), mg.data_ptr(), vu.data_ptr(),
                                 mu.data_ptr(), y.data_ptr(), 8, 256, 128, nn, bm, body, split,
                                 _build.stream_of(x))
        assert rc != 0, (nn, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_dual", lib)
    xm, values, meta, (_, kmask) = _masked_case(cuda_device, 8, 256, 128, 2, 0.5)
    for nn, split in ((2, 3), (2, 8), (2, 0), (4, 2)):
        rc = lib.vg_nm_spmm_masked(xm.data_ptr(), values.data_ptr(), meta.data_ptr(),
                                   kmask.data_ptr(), None, y.data_ptr(), 8, 256, 128, nn, 0, 16,
                                   split, _build.stream_of(xm))
        assert rc != 0, (nn, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_masked", lib)
