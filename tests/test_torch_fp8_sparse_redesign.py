"""The redesigned Hopper bodies of the fp8 compressed gate-up dual
nm_spmm_dual_fp8 (with nm_spmm_dual_fp8_requant: the dual form of
nm_spmm_fp8's e4m3 sparse stream, both weights' tiles a stage, two
accumulators, split-K over a cluster, one silu(g) * u flush) and of the
fp8 lane-aligned gather K8, nm_spmm_gather_bk_fp8 at n in {1, 2} (with
nm_spmm_gather_bk_fp8_requant: the dense e4m3 stream over the values with
a byte select pass for few rows; an e4m3 gather pass in front of
tile_gemm_fp8's wgmma body for many, never for the requantized codes).

On the CPU: both plans (``nm_spmm/kernel.py::fp8_dual_plan``,
``nm_spmm_gather/kernel.py::fp8_plan``) at internlm2-1.8b's, gemma3-1b's
and qwen3-moe's decode and chunk rows, at 256 and 1,024 rows, n in {1, 2,
4}; split spans whole 64-steps covering K; every new body's shared memory
fits a block at the blocks an SM the plans assume; a numpy emulation of the
e4m3 dual stream (each warp's byte transpose of both compressed tiles, the
metadata words, the sparse product as mma.sp reads its operands, 64-deep
partials from zero, the split spans summed in rank order, the dual flush,
with and without the requantized store) reproduces the JAX package's
``nm_spmm_dual`` fp8 branch (Pallas, interpret mode) within 1e-6, scaled,
its codes equal or one e4m3 step off on at most 0.1%; a numpy emulation of
the byte select (over a step's span, and over whole rows as the gather
pass does) with the ws-first flush reproduces JAX's ``nm_spmm_gather_bk``
fp8 branch (interpret) within 1e-6, scaled, an index outside [0, 4)
reading +0.  On the card (``cuda``): both kernels bitwise the same across
launches at B in {1, 8, 33, 64, 256, 1024} and at split boundaries, within
1e-2 of max|plain| and their requantized codes one e4m3 step off on at most
0.1%; an index outside [0, 4) reads +0 in every new K8 body; plans the C
entries refuse raise."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm.kernel import (FP8_DUAL_STREAM16_TILES, fp8_dual_plan,
                                                nm_spmm_dual_fp8, nm_spmm_dual_fp8_requant)
from repro_torch.kernels.nm_spmm_gather.kernel import fp8_plan as gather_fp8_plan
from repro_torch.kernels.nm_spmm_gather.kernel import (FP8_STREAM16_MAX_ROWS,
                                                       nm_spmm_gather_bk_fp8,
                                                       nm_spmm_gather_bk_fp8_requant)
from repro_torch.kernels.tile_gemm.kernel import (BLOCKS_PER_SM, DUAL_STREAM_MIN_SPLIT,
                                                  FP8_SHARED_TILES, FP8_STREAM16_BLOCKS_PER_SM,
                                                  FP8_WGMMA_COLS, MAX_SPLIT, SMS, WGMMA_ROWS,
                                                  cluster_split, fp8_plan as tile_fp8_plan)
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into (H100)
SM_SMEM = 228 * 1024         # shared memory of an SM
BLOCK_RESERVED = 1024        # shared memory the system keeps for each resident block
FP8 = torch.float8_e4m3fn
ARCHS = ["internlm2_1_8b", "gemma3_1b", "qwen3_moe_235b_a22b"]


def _cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def _sites(arch):
    """(K, O) of each distinct single-GEMM site of a config."""
    cfg = _cfg(arch)
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
ROWS = [1, 8, 16, 17, 32, 33, 64, 65, 128, 255, 256, 1024]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_fp8_dual_plan(arch, b):
    """n in {1, 2}: the sparse dual stream over 16-row tiles at decode rows
    and while the launch has at most FP8_DUAL_STREAM16_TILES of them (split
    at FP8_STREAM16_BLOCKS_PER_SM blocks an SM), else over 64-row tiles
    where it splits K DUAL_STREAM_MIN_SPLIT ways or more, else the shared
    body; n = 4 shared."""
    cfg = _cfg(arch)
    k, o = cfg.d_model, cfg.d_ff
    steps = k // 64
    for n in (1, 2):
        p = fp8_dual_plan(b, k, o, n)
        t16, t64 = (o // 64) * -(-b // 16), (o // 64) * -(-b // 64)
        if b <= 16 or t16 <= FP8_DUAL_STREAM16_TILES:
            want = {"body": "sparse", "rows": 16, "cols": 64,
                    "split": cluster_split(t16, steps, FP8_STREAM16_BLOCKS_PER_SM)}
            assert t16 * want["split"] <= FP8_STREAM16_BLOCKS_PER_SM * SMS or want["split"] == 1
        elif cluster_split(t64, steps) >= DUAL_STREAM_MIN_SPLIT:
            want = {"body": "sparse", "rows": 64, "cols": 64, "split": cluster_split(t64, steps)}
        else:
            want = {"body": "shared", "rows": 64, "cols": 64, "split": 1}
        assert p == want, (n, p)
        _assert_spans(k, p["split"])
    rows = 16 if b <= 16 else 64
    assert fp8_dual_plan(b, k, o, 4) == {"body": "shared", "rows": rows, "cols": 64, "split": 1}


def test_fp8_dual_plan_at_the_measured_shapes():
    """internlm2-1.8b's gate-up: split 2 at decode (two blocks an SM over 128
    tiles), the 16-row stream at 17-32 rows, the shared body from 33 rows;
    qwen3-moe's expert gate-up: split 8 at decode, the 16-row stream up to
    176 rows, the shared body from 177."""
    for n in (1, 2):
        assert fp8_dual_plan(8, 2048, 8192, n) == {"body": "sparse", "rows": 16, "cols": 64,
                                                   "split": 2}
        assert fp8_dual_plan(17, 2048, 8192, n)["rows"] == 16
        assert [fp8_dual_plan(b, 2048, 8192, n)["body"] for b in (33, 64, 128, 256)] == \
            ["shared"] * 4
        assert fp8_dual_plan(8, 4096, 1536, n)["split"] == 8
        assert [fp8_dual_plan(b, 4096, 1536, n)["rows"] for b in (33, 64, 128)] == [16] * 3
        assert fp8_dual_plan(256, 4096, 1536, n)["body"] == "shared"
    # a decode launch wider than FP8_DUAL_STREAM16_TILES still takes 16-row tiles
    assert fp8_dual_plan(8, 4096, 64 * (FP8_DUAL_STREAM16_TILES + 64), 2)["rows"] == 16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", ROWS)
def test_gather_fp8_plan(arch, b):
    """K8 fp8 at n in {1, 2}: the stream over 16-row tiles up to
    FP8_STREAM16_MAX_ROWS rows while the launch has at most
    FP8_STREAM16_BLOCKS_PER_SM x SMS tiles (always for requant), else
    wgmma, never for requant (tile_gemm_fp8's requant plan: the 64-row
    stream or the shared body); n = 4 shared."""
    for k, o in _sites(arch):
        for n in (1, 2):
            kc = k * n // 4
            if kc % 64:         # plans no-kernel-fits before the wrapper
                continue
            t16 = (o // 64) * -(-b // 16)
            for requant in (False, True):
                p = gather_fp8_plan(b, k, o, n, requant)
                if b <= FP8_STREAM16_MAX_ROWS and (requant or
                                                   t16 <= FP8_STREAM16_BLOCKS_PER_SM * SMS):
                    assert p == {"body": "stream", "rows": 16, "cols": 64,
                                 "split": cluster_split(t16, kc // 64,
                                                        FP8_STREAM16_BLOCKS_PER_SM)}, p
                elif requant:
                    assert p == tile_fp8_plan(b, kc, o, requant=True)
                    assert p["body"] in ("stream", "shared") and p["rows"] == 64
                else:
                    assert p == {"body": "wgmma", "rows": WGMMA_ROWS, "cols": FP8_WGMMA_COLS,
                                 "split": 1}
                _assert_spans(kc, p["split"])
                assert not (requant and p["body"] == "wgmma")
        rows = 16 if b <= 16 else 64
        assert gather_fp8_plan(b, k, o, 4) == {"body": "shared", "rows": rows, "cols": 64,
                                               "split": 1}
        assert gather_fp8_plan(b, k, o, 4, True)["body"] == "shared"


def test_gather_fp8_plan_at_the_measured_shapes():
    """internlm2-1.8b's decode sites stream and fill the card; the wgmma body
    from 65 rows (and gemma3-1b's wide w_in at 64); gemma3-1b's requantizing
    w_in streams up to 64 rows and keeps the shared body above."""
    for k, o in ((2048, 2048), (2048, 1024), (8192, 2048)):
        p = gather_fp8_plan(8, k, o, 2)
        assert p["body"] == "stream" and 0.95 * SMS <= (o // 64) * p["split"] \
            <= BLOCKS_PER_SM * SMS
        assert gather_fp8_plan(64, k, o, 2)["rows"] == 16
        assert gather_fp8_plan(65, k, o, 2)["body"] == "wgmma"
    assert gather_fp8_plan(8, 1152, 6912, 2, requant=True) == {
        "body": "stream", "rows": 16, "cols": 64, "split": 2}
    assert gather_fp8_plan(64, 1152, 6912, 2)["body"] == "wgmma"
    assert gather_fp8_plan(64, 1152, 6912, 2, requant=True)["body"] == "stream"
    assert gather_fp8_plan(256, 1152, 6912, 2, requant=True)["body"] == "shared"
    assert gather_fp8_plan(256, 8192, 2048, 2)["body"] == "wgmma"
    assert FP8_SHARED_TILES <= (6912 // 64) * 4


@pytest.mark.parametrize("k", [192, 320, 1152, 1216, 2048, 4096, 8192])
@pytest.mark.parametrize("b", [1, 8, 17, 33, 64, 256])
def test_fp8_split_spans_are_whole_steps_covering_k(k, b):
    for o in (64, 256, 1536, 8192):
        for n in (1, 2):
            _assert_spans(k, fp8_dual_plan(b, k, o, n)["split"])
            if (k * n // 4) % 64 == 0:
                _assert_spans(k * n // 4, gather_fp8_plan(b, k, o, n)["split"])


# -------------------------------------------------- every body fits a block
def _dual_stream_smem(n, bm):
    """nm_spmm_sp_fp8.cuh, DUAL: the ring of both weights' values and meta
    tiles and one X tile, two transposed A tiles a warp, a two-plane inbox."""
    stages, mt = (6, 1) if bm == 16 else (4, 2)
    vrows = 16 * n
    stage = 2 * vrows * 80 + 2 * (vrows // 4) * 64 + bm * 80
    ring = max(stages * stage, 2 * bm * 68 * 4)
    return ring + 4 * 2 * mt * 16 * 48 + 2 * bm * 64 * 4


def _gather_stream_smem(n, bm):
    """nm_spmm_sp_fp8.cuh, G = n: the ring of values (unpadded, read by
    ldmatrix .trans), indices and the X span, the compact X tile, the
    inbox."""
    stages = 6 if bm == 16 else 4
    stage = 64 * 64 + 64 * 4 + bm * (256 // n + 16)
    ring = max(stages * stage, bm * 68 * 4)
    return ring + bm * 80 + bm * 64 * 4


@pytest.mark.parametrize("body,bytes_,per_sm", [
    *[(f"dual stream n={n} bm={bm}", _dual_stream_smem(n, bm),
       FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else BLOCKS_PER_SM)
      for n in (1, 2) for bm in (16, 64)],
    *[(f"gather stream n={n} bm={bm}", _gather_stream_smem(n, bm),
       FP8_STREAM16_BLOCKS_PER_SM if bm == 16 else 1) for n in (1, 2) for bm in (16, 64)]])
def test_every_new_body_fits_a_block(body, bytes_, per_sm):
    """At the blocks an SM the plans' splits assume: three 16-row blocks
    (FP8_STREAM16_BLOCKS_PER_SM), two 64-row dual blocks (cluster_split's
    default), one 64-row gather block (stream_plan's, requant only)."""
    assert bytes_ <= SMEM_LIMIT, body
    assert per_sm * (bytes_ + BLOCK_RESERVED) <= SM_SMEM, body


def test_the_16_row_streams_fit_three_blocks():
    """The 16-row dual's ~58 KB and the 16-row gather's ~44-57 KB leave room
    for FP8_STREAM16_BLOCKS_PER_SM blocks an SM."""
    assert max(_dual_stream_smem(n, 16) for n in (1, 2)) < 60 * 1024
    assert max(_gather_stream_smem(n, 16) for n in (1, 2)) < 68 * 1024


# ------------------------------------------------- emulations of the bodies
def _word(bytes4: np.ndarray) -> int:
    return int(sum(int(bytes4[p]) << (8 * p) for p in range(4)))


def _bytes_of(word: int) -> list:
    return [(word >> (8 * p)) & 0xFF for p in range(4)]


def _gather_byte(w, j):
    """spf8::gather_byte: byte j of each of four words, w0's lowest."""
    return sum(((w[p] >> (8 * j)) & 0xFF) << (8 * p) for p in range(4))


def _byte_perm(x: int, y: int, s: int) -> int:
    """__byte_perm(x, y, s), default mode."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _expand_1of4(x: int) -> int:
    """splitk::expand_1of4."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    zero = ~(x | (x >> 1)) & 0x11111111
    return ((x | zero) << 2) & 0xFFFFFFFF


def _warp_tile(vs: np.ndarray, ms: np.ndarray, c: int, n: int) -> np.ndarray:
    """One warp's transposed A tile of a stage: channels c .. c + 15 x 32
    kept bytes (1:4: the 2:4 pair slots), as nm_spmm_sp_fp8.cuh's lanes
    write it from the landed values tile vs (K_c step rows, 64) and meta
    tile ms."""
    ta = np.zeros((16, 32), np.uint8)
    for p in range(4):
        for q in range(8):
            if n == 2:      # lane (p, q): kept rows 4q .. + 3 x channels 4p .. + 3
                w = [_word(vs[4 * q + r, c + 4 * p:c + 4 * p + 4]) for r in range(4)]
                for j in range(4):
                    ta[4 * p + j, 4 * q:4 * q + 4] = _bytes_of(_gather_byte(w, j))
                continue
            # 1:4, lane (p, q): kept rows 4 (q & 3) .. + 3 x channels 4p + 2 (q >> 2) .. + 1
            qq, j0 = q & 3, 2 * (q >> 2)
            w = [_word(vs[4 * qq + r, c + 4 * p:c + 4 * p + 4]) for r in range(4)]
            mw = _word(ms[qq, c + 4 * p:c + 4 * p + 4])
            for j in (j0, j0 + 1):
                mb = (mw >> (8 * j)) & 0xFF
                pr = []
                for r in range(4):
                    v, i = (w[r] >> (8 * j)) & 0xFF, (mb >> (2 * r)) & 3
                    pr.append(v if i == 0 else v << 8)
                ta[4 * p + j, 8 * qq:8 * qq + 8] = (_bytes_of(pr[0] | pr[1] << 16)
                                                     + _bytes_of(pr[2] | pr[3] << 16))
    return ta


def _meta_word(ms: np.ndarray, ch: int, h: int, n: int) -> int:
    """The metadata register of the lanes whose channel is ch and half h
    (K groups 8h .. 8h + 7): four meta_packed bytes at 2:4, two spread by
    expand_1of4 at 1:4."""
    if n == 2:
        return _word(ms[4 * h:4 * h + 4, ch])
    return _expand_1of4(int(ms[2 * h, ch]) | int(ms[2 * h + 1, ch]) << 8)


def _mma_sp_rows(ta: np.ndarray, ms: np.ndarray, c: int, n: int) -> np.ndarray:
    """The dense 64-K rows of channels c .. c + 15 that mma.sp m16n8k64
    multiplies: kept byte 2G + s of group G goes to K position 4G + the
    s-th 2-bit index of group G's nibble."""
    rows = np.zeros((16, 64), np.uint8)
    for ch in range(16):
        for h in range(2):
            e = _meta_word(ms, c + ch, h, n)
            for kk in range(8):
                grp, nib = 8 * h + kk, (e >> (4 * kk)) & 0xF
                for s in range(2):
                    rows[ch, 4 * grp + ((nib >> (2 * s)) & 3)] += ta[ch, 2 * grp + s]
    return rows


def _e4m3_f32(codes: np.ndarray) -> np.ndarray:
    return torch.from_numpy(codes.copy()).view(FP8).float().numpy()


def _stream_acc(xb, values, meta, n, split):
    """The dual stream's sums for one weight: per 64-deep step and warp
    tile, the transposed operand and the mma.sp rows, the step's partial
    summed exactly (the tensor cores' 64 products) and rounded to fp32, added
    in fp32 over block r's span of steps, the blocks' partials added in rank
    order."""
    b, k = xb.shape
    o = values.shape[1]
    steps, vrows, mrows = k // 64, 16 * n, 4 * n
    xf = _e4m3_f32(xb).astype(np.float64)
    acc = None
    for r in range(split):
        part = np.zeros((b, o), np.float32)
        for s in range(r * steps // split, (r + 1) * steps // split):
            vs = values[s * vrows:(s + 1) * vrows]
            ms = meta[s * mrows:(s + 1) * mrows]
            dense = np.zeros((o, 64), np.uint8)
            for c in range(0, o, 16):
                dense[c:c + 16] = _mma_sp_rows(_warp_tile(vs, ms, c, n), ms, c, n)
            p = (xf[:, 64 * s:64 * s + 64] @ _e4m3_f32(dense).astype(np.float64).T)
            part = (part + p.astype(np.float32)).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def _silu(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.float32)
    return (v / (np.float32(1) + np.exp(-v))).astype(np.float32)


def _dual_inputs(seed, b, k, o, n):
    """e4m3 operands as the port makes them (torch on the CPU): x_q, x_scale
    and two compressed weights with their scales, pruned and compressed
    before quantizing."""
    from repro_torch.core import nm as tnm
    from repro_torch.core import quantize as tquant
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0
    xq, xs = tquant.quantize_rows(torch.from_numpy(x), FP8)
    ws = []
    for _ in range(2):
        w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
        c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
        leaf = tquant.quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)},
                                      FP8)
        ws.append((leaf["values"], leaf["meta_packed"], leaf["scale"].reshape(1, -1)))
    return xq, xs, ws


def _j(jnp, t):
    if t.dtype == FP8:
        return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _step_share(got: np.ndarray, want: np.ndarray) -> float:
    """The share of e4m3 codes one step apart (none further)."""
    def ordinal(c):
        c = c.astype(np.int32)
        return np.where(c >= 128, -(c - 128), c)
    d = np.abs(ordinal(got) - ordinal(want))
    assert d.max() <= 1
    return float((d == 1).mean())


@pytest.mark.parametrize("n", [1, 2])
def test_dual_stream_reproduces_pallas(n):
    """K = 320: five 64-deep steps over the plan's split of 4 (uneven
    spans), two warp tiles of 16 channels: the emulated stream, flush and
    requantized store against JAX's nm_spmm_dual fp8 branch (interpret)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import epilogue as jepi
    from repro.kernels.nm_spmm.kernel import nm_spmm_dual as j_dual

    b, k, o = 8, 320, 64
    split = fp8_dual_plan(b, k, o, n)["split"]
    assert split == 4 and (k // 64) % split
    xq, xs, [(vg, mg, sg), (vu, mu, su)] = _dual_inputs(40 + n, b, k, o, n)
    xb = xq.view(torch.uint8).numpy()
    acc_g = _stream_acc(xb, vg.view(torch.uint8).numpy(), mg.numpy(), n, split)
    acc_u = _stream_acc(xb, vu.view(torch.uint8).numpy(), mu.numpy(), n, split)
    xsn, sgn, sun = xs.numpy(), sg.numpy(), su.numpy()
    t_g = ((acc_g * xsn).astype(np.float32) * sgn).astype(np.float32)
    t_u = ((acc_u * xsn).astype(np.float32) * sun).astype(np.float32)
    got = (_silu(t_g) * t_u).astype(np.float32)
    args = [_j(jnp, t) for t in (xq, vg, mg, vu, mu)] + [n] + [_j(jnp, t) for t in (xs, sg, su)]
    want = np.asarray(j_dual(*args, acc_dtype=jnp.float32, out_dtype=jnp.float32,
                             interpret=True))
    assert_scaled_close(got, want, 1e-6)
    # the requantized store: clip(y / rq, +-448), the round-to-nearest-even cast
    rq = np.float32(np.abs(want).max() / 300)
    codes = np.asarray(jnp.asarray(np.clip(got / rq, -448, 448)).astype(jnp.float8_e4m3fn))
    want_q = np.asarray(j_dual(*args, acc_dtype=jnp.float32, interpret=True,
                               epilogue=jepi.EpilogueSpec(act="silu_mul",
                                                          requant="float8_e4m3fn"),
                               requant_scale=jnp.asarray(rq)))
    assert _step_share(codes.view(np.uint8), want_q.view(np.uint8)) <= 1e-3


def _select16(words: np.ndarray, e, g: int) -> np.ndarray:
    """spf8::select16 on one row's words: 16 compressed columns, 2:4 from 8
    words (block q / 2), 1:4 from 16 (block q); +0 for an index outside [0,
    4)."""
    out = []
    for w in range(4):
        keep = sum(0xFF << (8 * j) for j in range(4) if 0 <= e[4 * w + j] < 4)
        s = [int(e[4 * w + j]) & 3 for j in range(4)]
        if g == 2:
            v = _byte_perm(int(words[2 * w]), int(words[2 * w + 1]),
                           s[0] | s[1] << 4 | (4 + s[2]) << 8 | (4 + s[3]) << 12)
        else:
            lo = _byte_perm(int(words[4 * w]), int(words[4 * w + 1]), s[0] | (4 + s[1]) << 4)
            hi = _byte_perm(int(words[4 * w + 2]), int(words[4 * w + 3]),
                            s[2] | (4 + s[3]) << 4)
            v = _byte_perm(lo, hi, 0x5410)
        out += _bytes_of(v & keep)
    return np.array(out, np.uint8)


def _stream_select(xb: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """The stream's select pass: per 64-deep step, unit (row, columns j0 ..
    + 15) reads the words of the row's span (256 / n bytes) from byte j0 /
    n * 4."""
    b = xb.shape[0]
    kc, span = idx.shape[0], 256 // n
    out = np.zeros((b, kc), np.uint8)
    for s in range(kc // 64):
        for r in range(b):
            words = np.ascontiguousarray(xb[r, s * span:(s + 1) * span]).view(np.uint32)
            for j0 in range(0, 64, 16):
                out[r, 64 * s + j0:64 * s + j0 + 16] = _select16(
                    words[j0 // n:], idx[64 * s + j0:64 * s + j0 + 16], n)
    return out


def _pass_select(xb: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """gemm_fp8.cu's gather pass: unit (row, columns j0 .. + 15 of K_c)
    reads the row's words from byte j0 / n * 4 of the whole row."""
    b = xb.shape[0]
    kc = idx.shape[0]
    out = np.zeros((b, kc), np.uint8)
    for r in range(b):
        words = np.ascontiguousarray(xb[r]).view(np.uint32)
        for j0 in range(0, kc, 16):
            out[r, j0:j0 + 16] = _select16(words[j0 // n:], idx[j0:j0 + 16], n)
    return out


def _partials(xg: np.ndarray, v: np.ndarray, depth: int, split: int = 1) -> np.ndarray:
    """fp32 sums of depth-deep partials (each exact, rounded to fp32), block
    r of the split summing its span of steps, the blocks in rank order."""
    steps = xg.shape[1] // depth
    xf, vf = xg.astype(np.float64), v.astype(np.float64)
    acc = None
    for r in range(split):
        part = np.zeros((xg.shape[0], v.shape[1]), np.float32)
        for s in range(r * steps // split, (r + 1) * steps // split):
            ks = slice(depth * s, depth * s + depth)
            part = (part + (xf[:, ks] @ vf[ks]).astype(np.float32)).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("body", ["stream", "wgmma"])
def test_gather_select_reproduces_pallas(body, n):
    """e4m3 X and values: each body's byte select (an index outside [0, 4)
    gives +0), its accumulation (the stream's 64-deep partials over the
    plan's split, the wgmma body's 128-deep ones) and the ws-first flush
    reproduce JAX's nm_spmm_gather_bk fp8 branch (interpret) within 1e-6,
    scaled."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk as j_gather
    from repro_torch.core import quantize as tquant

    rng = np.random.default_rng(60 + n)
    b, ke, o = 8, 1024, 64
    kc = ke * n // 4
    idx = np.sort(np.stack([rng.choice(4, n, replace=False) for _ in range(kc // n)]),
                  -1).reshape(-1).astype(np.int32)
    idx[3], idx[kc // 2 + 5], idx[kc - 2] = 7, -1, 4     # outside [0, 4): read +0
    xq, xs = tquant.quantize_rows(torch.from_numpy(rng.standard_normal((b, ke))
                                                   .astype(np.float32)), FP8)
    leaf = tquant.quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((kc, o)).astype(np.float32) * kc ** -0.5)}, FP8)
    vq, ws = leaf["w"], leaf["scale"].reshape(1, -1)
    xb = xq.view(torch.uint8).numpy()
    if body == "stream":
        split = gather_fp8_plan(b, ke, o, n)["split"]
        assert gather_fp8_plan(b, ke, o, n)["body"] == "stream" and split > 1
        xg = _stream_select(xb, idx, n)
        acc = _partials(_e4m3_f32(xg), vq.float().numpy(), 64, split)
    else:
        xg = _pass_select(xb, idx, n)
        acc = _partials(_e4m3_f32(xg), vq.float().numpy(), 128)
    cols = np.arange(kc) // n * 4 + np.clip(idx, 0, 3)
    plain = np.where((idx >= 0) & (idx < 4), xb[:, cols], 0).astype(np.uint8)
    assert np.array_equal(xg, plain)
    got = ((acc * ws.numpy()).astype(np.float32) * xs.numpy()).astype(np.float32)
    want = np.asarray(j_gather(_j(jnp, xq), _j(jnp, vq), jnp.asarray(idx.reshape(-1, 1)), n,
                               _j(jnp, xs), _j(jnp, ws), out_dtype=jnp.float32,
                               interpret=True))
    assert_scaled_close(got, want, 1e-6)
    raw = np.asarray(j_gather(_j(jnp, xq), _j(jnp, vq), jnp.asarray(idx.reshape(-1, 1)), n,
                              out_dtype=jnp.float32, interpret=True))
    assert_scaled_close(acc, raw, 1e-6)


# ----------------------------------------------------------- on the card
def _dual_case(dev, b, k, o, n, seed=0):
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = []
    for _ in range(2):
        w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
        c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
        leaf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)}, FP8)
        ws += [leaf["values"], leaf["meta_packed"]]
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    if b > 1:
        x[-1] = 0          # an idle slot (a single row stays live: its codes need a scale)
    xq, xs = quantize_rows(x, FP8)
    scales = [torch.rand(1, o, generator=g, device=dev) * 0.01 + 0.001 for _ in range(2)]
    return (xq, *ws, n, xs, *scales)


def _gather_case(dev, b, k, o, n, seed=0):
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                          quantize=FP8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    xq, xs = quantize_rows(x, FP8)
    return xq, leaf["values"], leaf["gather_idx"], xs, leaf["scale"].reshape(1, -1)


def _ordinal_steps(got, want):
    def ordinal(t):
        c = t.view(torch.uint8).int()
        return torch.where(c >= 128, -(c - 128), c)
    d = (ordinal(got) - ordinal(want)).abs()
    assert d.max().item() <= 1
    return (d == 1).float().mean().item()


CARD_ROWS = [1, 8, 33, 64, 256, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("k,o", [(2048, 8192), (4096, 1536)])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", CARD_ROWS)
def test_dual_fp8_bitwise_and_close_on_card(cuda_device, n, b, k, o):
    """internlm2-1.8b's and qwen3-moe's expert gate-up (the 16-row stream
    over several row tiles at 33 and 64 rows): bf16 and fp32 stores within
    1e-2 of the plain version, the requantized codes one step off on at
    most 0.1%, the same bits on every launch."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_quantized_ref
    args = _dual_case(cuda_device, b, k, o, n, seed=b)
    before = nm_spmm_dual_fp8.launches
    first = nm_spmm_dual_fp8(*args, out_dtype=torch.bfloat16)
    again = [nm_spmm_dual_fp8(*args, out_dtype=torch.bfloat16) for _ in range(2)]
    y32 = nm_spmm_dual_fp8(*args)
    torch.cuda.synchronize()
    assert nm_spmm_dual_fp8.launches == before + 4
    assert all(torch.equal(first, y) for y in again)
    assert_scaled_close(first, nm_spmm_dual_quantized_ref(*args, out_dtype=torch.bfloat16), 1e-2)
    want32 = nm_spmm_dual_quantized_ref(*args)
    assert_scaled_close(y32, want32, 1e-2)
    rq = (want32.abs().amax() / 448).reshape(())
    codes = nm_spmm_dual_fp8_requant(*args, rq)
    torch.cuda.synchronize()
    assert codes.dtype == FP8
    assert _ordinal_steps(codes, nm_spmm_dual_quantized_ref(*args, requant_scale=rq)) <= 1e-3
    assert torch.equal(codes, nm_spmm_dual_fp8_requant(*args, rq))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(320, 64), (448, 128), (1216, 256), (1088, 512)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_dual_fp8_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K = 64 x steps not divisible by the split: uneven spans per block."""
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_quantized_ref
    args = _dual_case(cuda_device, b, k, o, n)
    p = fp8_dual_plan(b, k, o, n)
    got = nm_spmm_dual_fp8(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_dual_quantized_ref(*args), 1e-2)
    assert p["split"] > 1 and (k // 64) % p["split"], p
    assert torch.equal(got, nm_spmm_dual_fp8(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", CARD_ROWS)
def test_gather_fp8_bitwise_and_close_on_card(cuda_device, n, b):
    """Each K8 fp8 site of internlm2-1.8b (w_out at 1,024 rows): the raw
    accumulator, bf16 with a bias and gelu, and the requantized codes
    against the plain version; the same bits on every launch."""
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm_gather.ref import (nm_spmm_gather_quantized_ref,
                                                        nm_spmm_gather_quantized_requant_ref)
    k, o = (8192, 2048) if b == 1024 else (2048, 1024)
    xq, v, idx, xs, ws = _gather_case(cuda_device, b, k, o, n, seed=b)
    raw = nm_spmm_gather_bk_fp8(xq, v, idx, None, None, n)
    again = [nm_spmm_gather_bk_fp8(xq, v, idx, None, None, n) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(raw, y) for y in again)
    assert_scaled_close(raw, nm_spmm_gather_quantized_ref(xq, v, idx, None, None, n), 1e-2)
    bias = torch.randn(o, device=cuda_device) * 0.1
    gelu = EpilogueSpec(act="gelu", bias=True)
    y = nm_spmm_gather_bk_fp8(xq, v, idx, xs, ws, n, epilogue=gelu, bias=bias,
                              out_dtype=torch.bfloat16)
    want = nm_spmm_gather_quantized_ref(xq, v, idx, xs, ws, n, epilogue=gelu, bias=bias,
                                        out_dtype=torch.bfloat16)
    assert_scaled_close(y, want, 1e-2)
    rq = (want.float().abs().amax() / 448).reshape(())
    codes = nm_spmm_gather_bk_fp8_requant(xq, v, idx, xs, ws, n, rq, epilogue=gelu, bias=bias)
    torch.cuda.synchronize()
    assert codes.dtype == FP8
    assert _ordinal_steps(codes, nm_spmm_gather_quantized_requant_ref(
        xq, v, idx, xs, ws, n, rq, epilogue=gelu, bias=bias)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(768, 64), (1280, 64), (1792, 128), (4864, 256),
                                 (4352, 512)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_gather_fp8_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K_c = 64 x steps not divisible by the split."""
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_quantized_ref
    if (k * n // 4) % 64:
        pytest.skip(f"K_c = {k * n // 4} is not a multiple of 64 at n = {n}")
    xq, v, idx, xs, ws = _gather_case(cuda_device, b, k, o, n)
    got = nm_spmm_gather_bk_fp8(xq, v, idx, None, None, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_gather_quantized_ref(xq, v, idx, None, None, n), 1e-2)
    assert torch.equal(got, nm_spmm_gather_bk_fp8(xq, v, idx, None, None, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [8, 64, 1024])
def test_gather_fp8_index_outside_the_block_reads_zero_on_card(cuda_device, n, b):
    """An index outside [0, 4) selects +0 in the stream's select pass and in
    the gather pass, against the plain product on the zeroed columns."""
    xq, v, idx, xs, ws = _gather_case(cuda_device, b, 2048, 1024, n, seed=3)
    assert gather_fp8_plan(b, 2048, 1024, n)["body"] in ("stream", "wgmma")
    idx = idx.clone()
    idx[1], idx[70], idx[-1] = 9, -1, 4
    got = nm_spmm_gather_bk_fp8(xq, v, idx, None, None, n)
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < 4)
    cols = torch.arange(idx.numel(), device=cuda_device) // n * 4 + idx.clamp(0, 3).long()
    want = (xq.float()[:, cols] * ok) @ v.float()
    assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
def test_refused_plans_raise_on_card(cuda_device):
    lib = _build.library("gemm_fp8.cu")
    xq, vg, mg, vu, mu, n, xs, sg, su = _dual_case(cuda_device, 8, 256, 64, 2)
    y = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda_device)
    # (n, bm, body, split): body 0 shared (split 1), 1 the sparse dual (n in {1, 2})
    for nn, bm, body, split in ((2, 16, 0, 2), (2, 16, 1, 0), (2, 16, 1, 3), (2, 32, 1, 1),
                                (2, 16, 2, 1), (2, 16, 1, 8)):
        rc = lib.vg_nm_spmm_dual_fp8(xq.data_ptr(), vg.data_ptr(), mg.data_ptr(), vu.data_ptr(),
                                     mu.data_ptr(), xs.data_ptr(), sg.data_ptr(), su.data_ptr(),
                                     None, y.data_ptr(), 8, 256, 64, nn, 0, bm, body, split,
                                     _build.stream_of(xq))
        assert rc != 0, (nn, bm, body, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_dual_fp8", lib)
    xq, v, idx, xs, ws = _gather_case(cuda_device, 8, 512, 64, 2)
    y = torch.empty((8, 64), dtype=torch.float32, device=cuda_device)
    # (n, bm, body, bn, split): 0 shared (bn 64, split 1), 1 stream (n in {1, 2}, bn
    # 64), 2 the gather pass then wgmma (bm 128, bn 128, split 1, a scratch)
    for nn, bm, body, bn, split in ((2, 16, 0, 64, 2), (4, 16, 1, 64, 1), (2, 16, 1, 64, 3),
                                    (2, 16, 1, 128, 1), (2, 64, 2, 128, 1), (2, 128, 2, 64, 1),
                                    (2, 128, 2, 128, 2), (4, 128, 2, 128, 1), (2, 16, 3, 64, 1)):
        rc = lib.vg_nm_spmm_gather_bk_fp8(xq.data_ptr(), v.data_ptr(), idx.data_ptr(), None,
                                          None, None, None, y.data_ptr(), 8, 512, 64, nn, 0, 2,
                                          bm, body, bn, split, None, _build.stream_of(xq))
        assert rc != 0, (nn, bm, body, bn, split)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.check(rc, "nm_spmm_gather_bk_fp8", lib)
