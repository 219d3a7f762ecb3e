"""The redesigned Hopper bodies of flash_attention (K4: FlashAttention-2,
register-resident) and nm_spmm at n in {1, 2} (K2: sparse tensor cores,
K split across a cluster).

On the CPU: the split planner (covers the card at internlm2-1.8b's decode
shapes, split 1 at 4,000 prefill rows, whole 64-steps per block); the
metadata words the kernel builds from the JAX package's ``meta_packed``
bytes are the instruction's (2:4 as stored, 1:4 spread); the 1:4-as-2:4 operand
(the kept value beside a +0) reproduces ``nm_spmm_ref`` and the JAX
package's dense product within 1e-6 on fp32 inputs; the 1:4 metadata bit
spread equals its definition on every input; every flash tile fits the
227 KB a block may use.  On the card (``cuda``): the probe of the sparse
instruction's operand layout, K2 bitwise deterministic, at every split
boundary and at n in {1, 2}, B in {1, 8, 33, 4000} with the epilogue and
fp32-store checks, K4 at T in {1, 63, 500, 1500} for each head_dim,
causal and not, and the flash tile's shared bytes as the kernel reports
them.  Tolerances as in ``tests/test_torch_kernels.py``: 1e-2 of max|plain|
for K2 (bf16), 2e-2 per row for K4 (p rounded to bf16, sums in another
order)."""

import numpy as np
import pytest
import torch

from repro_torch.core import nm as tnm
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, flash_attention, tile_config
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mma_sp_probe import expand_1of4, metadata_words
from repro_torch.kernels.nm_spmm.kernel import BLOCKS_PER_SM, MAX_SPLIT, SMS, nm_spmm, split_k
from repro_torch.kernels.nm_spmm.ref import nm_spmm_ref
from torch_parity import assert_scaled_close, cuda_device  # noqa: F401

SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into (H100)
# internlm2-1.8b's decode sites as (K, O): q, k / v, o, w_out
INTERNLM2_SITES = [(2048, 2048), (2048, 1024), (2048, 2048), (8192, 2048)]
# hubert-xlarge's prefill sites: q / k / v / o, w_in (gelu), w_out
HUBERT_SITES = [(1280, 1280), (1280, 5120), (5120, 1280)]


def _spans(k: int, split: int):
    """Block r's K steps, as nm_spmm_sp.cuh computes them."""
    steps = k // 64
    return [(r * steps // split, (r + 1) * steps // split) for r in range(split)]


# ------------------------------------------------------------ the split planner
def test_internlm2_sites_are_the_configs():
    from repro_torch.configs import get_config
    cfg = get_config("internlm2_1_8b")
    assert INTERNLM2_SITES == [(cfg.d_model, cfg.attn_dim), (cfg.d_model, cfg.kv_dim),
                               (cfg.attn_dim, cfg.d_model), (cfg.d_ff, cfg.d_model)]
    hub = get_config("hubert_xlarge")
    assert HUBERT_SITES == [(hub.d_model, hub.attn_dim), (hub.d_model, hub.d_ff),
                            (hub.d_ff, hub.d_model)]


@pytest.mark.parametrize("k,o", INTERNLM2_SITES)
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("n", [1, 2])
def test_split_covers_the_card_at_decode(k, o, b, n):
    split = split_k(b, k, o, n)
    blocks = (o // 64) * split
    assert 1 < split <= MAX_SPLIT and split & (split - 1) == 0
    assert 0.95 * SMS <= blocks <= BLOCKS_PER_SM * SMS, (k, o, split, blocks)
    assert split == MAX_SPLIT or 2 * blocks > BLOCKS_PER_SM * SMS


@pytest.mark.parametrize("k,o", HUBERT_SITES)
@pytest.mark.parametrize("n", [1, 2])
def test_split_is_one_when_the_rows_fill_the_card(k, o, n):
    assert split_k(4000, k, o, n) == 1


@pytest.mark.parametrize("k,o", [(64, 64), (192, 64), (320, 64), (448, 128), (1216, 256),
                                 (1152, 6912), (2048, 1024), (8192, 2048)])
@pytest.mark.parametrize("b", [1, 8, 33, 64])
def test_split_spans_are_whole_steps_covering_k(k, o, b):
    split = split_k(b, k, o, 2)
    spans = _spans(k, split)
    assert split <= k // 64
    assert spans[0][0] == 0 and spans[-1][1] == k // 64
    assert all(lo < hi for lo, hi in spans)                    # no block without a step
    assert all(spans[r][1] == spans[r + 1][0] for r in range(split - 1))


def test_split_is_one_for_the_shared_body():
    assert split_k(8, 2048, 2048, 4) == 1


# ---------------------------------------- the operand the sparse tensor core reads
def _jax_compressed(w: np.ndarray, n: int):
    """(values, meta_packed, dense) numpy from the JAX package's compressor."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import nm

    pruned, _ = nm.prune_nm(jnp.asarray(w), n, 4)
    c = nm.compress_nm(pruned, n, 4)
    return np.array(c.values), np.array(nm.pack_meta(c.meta)), np.array(pruned)


def _kernel_words(packed: np.ndarray, n: int, step: int, c: int) -> np.ndarray:
    """The metadata words nm_spmm_sp.cuh builds from meta_packed bytes for
    channels c .. c + 15 at mma K step ``step`` (32 K columns), lane by lane
    (0 on the lanes the instruction does not read)."""
    e = np.zeros(32, np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        if t > 1:
            continue
        if n == 2:   # meta rows 4 step + 2t, + 1 of channels c + g and c + g + 8
            rows = packed[4 * step + 2 * t:4 * step + 2 * t + 2].astype(np.uint32)
            e[lane] = (rows[0, c + g] | rows[1, c + g] << 8 | rows[0, c + g + 8] << 16
                       | rows[1, c + g + 8] << 24)
        else:        # meta row 2 step + t, spread from 1:4 to 2:4
            row = packed[2 * step + t].astype(np.uint32)
            e[lane] = expand_1of4(int(row[c + g] | row[c + g + 8] << 8))
    return e


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_metadata_words_come_from_meta_packed_as_it_is(n, seed):
    """The words the kernel reads from the JAX package's meta_packed bytes
    are the instruction's words (the probe-pinned map, ``metadata_words``)
    of the kept indices: 2:4 sorted and distinct as stored, 1:4 as the
    pair (0, 1) for index 0, else (0, index)."""
    rng = np.random.default_rng(seed)
    k, o = 256, 64
    _, packed, _ = _jax_compressed(rng.standard_normal((k, o)).astype(np.float32), n)
    idx = tnm.unpack_meta(torch.from_numpy(packed)).numpy()        # (K_c, O)
    for step in range(k // 32):
        for c in (0, 16, 48):
            if n == 2:
                pairs = idx[16 * step:16 * step + 16, c:c + 16].T.reshape(16, 8, 2)
                assert np.all(pairs[..., 0] < pairs[..., 1])          # sorted and distinct
            else:
                one = idx[8 * step:8 * step + 8, c:c + 16].T               # (16, 8)
                pairs = np.stack([np.zeros_like(one), np.where(one == 0, 1, one)], -1)
            assert np.array_equal(_kernel_words(packed, n, step, c), metadata_words(pairs))


def _expand_bits(x: int) -> int:
    """nm_spmm_sp.cuh's expand_1of4, operation for operation."""
    m = 0xFFFFFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    zero = ~(x | (x >> 1)) & 0x11111111
    return ((x | zero) << 2) & m


def test_1of4_metadata_spread_on_every_input():
    assert all(_expand_bits(v) == expand_1of4(v) for v in range(1 << 16))


def _as_2of4(values: torch.Tensor, meta_packed: torch.Tensor, n: int):
    """The 2:4 operand the kernel hands the tensor core: per K group of 4, two
    (value, index) slots.  2:4 as stored; 1:4 with the kept value in the
    slot of its index and a +0 in the other, the pair (0, 1) for index 0,
    else (0, index)."""
    idx = tnm.unpack_meta(meta_packed).long()                   # (K_c, O)
    kc, o = values.shape
    if n == 2:
        return values.reshape(kc // 2, 2, o), idx.reshape(kc // 2, 2, o)
    zero = torch.zeros_like(values)
    first = torch.where(idx == 0, values, zero)
    second = torch.where(idx == 0, zero, values)
    pair_idx = torch.stack([torch.zeros_like(idx), torch.where(idx == 0, 1, idx)], 1)
    return torch.stack([first, second], 1), pair_idx


def _dense_from_pairs(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    groups, _, o = vals.shape
    w = torch.zeros((groups, 4, o), dtype=vals.dtype)
    w.scatter_add_(1, idx, vals)
    return w.reshape(groups * 4, o)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_2of4_operand_reproduces_the_plain_version(n, seed):
    """fp32 inputs: the product through the operand the kernel reads equals
    nm_spmm_ref and the JAX package's pruned dense product within 1e-6."""
    rng = np.random.default_rng(seed)
    k, o, b = 256, 128, 8
    w = rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    values, packed, pruned = _jax_compressed(w, n)
    vals, pair_idx = _as_2of4(torch.from_numpy(values), torch.from_numpy(packed), n)
    assert torch.all(pair_idx[:, 0] < pair_idx[:, 1])
    y = x @ _dense_from_pairs(vals, pair_idx)
    assert_scaled_close(y, nm_spmm_ref(x, torch.from_numpy(values), torch.from_numpy(packed), n),
                        1e-6)
    assert_scaled_close(y, x.numpy() @ pruned, 1e-6)


# ----------------------------------------------------------- flash tiles
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_tile_fits_a_block(d):
    tc = tile_config(d)
    mq = tc["query_tiles_per_warp"]
    assert tc["smem_bytes"] <= SMEM_LIMIT
    assert tc["block_q"] == 64 * mq and tc["block_kv"] in (32, 64) and d % 16 == 0
    # what a thread holds across a KV step: O (d / 2 fp32 per query tile),
    # S (block_kv / 2 fp32 per query tile) and, unless re-read from shared
    # memory, Q (d / 4 words): under 255 registers with room for P
    held = mq * (d // 2 + tc["block_kv"] // 2) + (0 if tc["q_in_smem"] else d // 4)
    assert held <= 160


# ----------------------------------------------------------- on the card
def _leaf(dev, b, k, o, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    pruned, _ = tnm.prune_nm(w, n, 4)
    c = tnm.compress_nm(pruned, n, 4)
    return x, c.values, tnm.pack_meta(c.meta), pruned


@pytest.mark.cuda
def test_mma_sp_probe_pins_the_layout_on_card(cuda_device):
    from repro_torch.kernels.mma_sp_probe import probe
    found = probe(str(cuda_device))
    assert found["ok"], found


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b,k,o", [(8, 2048, 1024), (8, 8192, 2048), (64, 2048, 2048),
                                   (4000, 1280, 1280)])
def test_nm_spmm_bitwise_deterministic_on_card(cuda_device, n, b, k, o):
    x, values, pm, _ = _leaf(cuda_device, b, k, o, n)
    first = nm_spmm(x, values, pm, n)
    again = [nm_spmm(x, values, pm, n) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in again)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k,o", [(192, 64), (320, 64), (448, 128), (1216, 256), (1088, 512)])
@pytest.mark.parametrize("b", [1, 8])
def test_nm_spmm_at_split_boundaries_on_card(cuda_device, n, k, o, b):
    """K = 64 x steps not divisible by the split: uneven spans per block."""
    split = split_k(b, k, o, n)
    assert split > 1 and (k // 64) % split
    x, values, pm, pruned = _leaf(cuda_device, b, k, o, n)
    got = nm_spmm(x, values, pm, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_ref(x, values, pm, n), 1e-2)
    assert_scaled_close(got, x.float() @ pruned.float(), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 33, 4000])
@pytest.mark.parametrize("act,bias", [(None, False), (None, True), ("silu", False),
                                      ("gelu", True)])
def test_nm_spmm_epilogues_and_fp32_store_on_card(cuda_device, n, b, act, bias):
    k, o = (1280, 1280) if b == 4000 else (2048, 1024)
    x, values, pm, _ = _leaf(cuda_device, b, k, o, n)
    bv = torch.randn(o, device=cuda_device) if bias else None
    spec = EpilogueSpec(act=act, bias=bias)
    before = nm_spmm.launches
    y16 = nm_spmm(x, values, pm, n, epilogue=spec, bias=bv)
    y32 = nm_spmm(x, values, pm, n, epilogue=spec, bias=bv, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert nm_spmm.launches == before + 2
    assert_scaled_close(y16, nm_spmm_ref(x, values, pm, n, epilogue=spec, bias=bv), 1e-2)
    assert_scaled_close(y32, nm_spmm_ref(x, values, pm, n, epilogue=spec, bias=bv,
                                         out_dtype=torch.float32), 1e-2)
    assert torch.equal(y16, y32.bfloat16())


@pytest.mark.cuda
def test_nm_spmm_refuses_a_split_the_kernel_cannot_take(cuda_device):
    x, values, pm, _ = _leaf(cuda_device, 8, 128, 64, 2)
    y = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda_device)
    lib = _build.library()
    for split in (0, 3 * MAX_SPLIT, 3):    # 3 > K / 64 = 2 steps
        rc = lib.vg_nm_spmm(x.data_ptr(), values.data_ptr(), pm.data_ptr(), None, y.data_ptr(),
                            8, 128, 64, 2, 0, 0, 16, split, _build.stream_of(x))
        assert rc != 0, split


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 500, 1500])
def test_flash_attention_sweep_on_card(cuda_device, d, causal, t):
    b, hq, hkv = (2, 4, 2) if t < 1000 else (1, 4, 1)
    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=cuda_device).bfloat16()
               .transpose(1, 2) for h in (hq, hkv, hkv))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    row_err = (got.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1)
    assert row_err.max().item() <= 2e-2
    if t > 1:   # the other branch is another function
        other = flash_attention_ref(q, k, v, causal=not causal)
        assert (got.float() - other.float()).abs().max().item() > 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_tile_is_the_kernels_on_card(cuda_device, d):
    assert _build.library("flash_attention.cu").vg_flash_attention_smem(d) \
        == tile_config(d)["smem_bytes"]
