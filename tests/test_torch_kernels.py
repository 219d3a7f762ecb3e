"""The port's kernels against the JAX package's Pallas kernels.

On this CPU-only machine each wrapper, handed CPU tensors, runs its plain
version (fp32 accumulation, epilogue in fp32, one cast); that is held to
the JAX kernel executed in interpret mode on the same numpy inputs.
Tolerances, scaled by max |reference| as in tests/test_kernels.py:
fp32 <= 2e-6 (summation order only); bf16 inputs <= 1e-2 (one bf16
rounding of the output, in different places in the two frameworks).

The int8 kernels: raw int32 accumulators bitwise equal to the Pallas
interpret kernels; scaled outputs within 2e-6 (fp32) / 1e-2 (bf16) —
in practice bitwise too, since the flush repeats the same fp32 ops.

The ``cuda`` tests hold each CUDA kernel against its plain version on
the card and skip without one: int8 raw and scaled single-GEMM outputs
bitwise (the accumulator is exact, the flush the same fp32 ops), the
int8 duals within 1e-2 (silu's exp differs between the kernel and
torch); the requantizing int8 duals to equal codes except |delta| <= 1
on at most 0.1% of the elements (that ulp of silu can move a code whose
y / scale sits on a rounding boundary); flash_attention within 2e-2
scaled in bf16 (p rounded to bf16, sums in another order), each row
against its own max, causal and not, at head dims 64, 80, 96, 128 and
256 (the non-causal D = 80 and causal D = 96 cases at ragged T; their
CPU parity with the Pallas kernel is in ``tests/test_torch_encoder.py``).  The fp8
kernels: raw fp32 accumulators, scaled outputs and duals within 1e-2
(the sums run in another order), and the requantizing fp8 duals to
equal e4m3 codes except one step on at most 0.1% of them.  Their CPU
parity with the JAX package's Pallas fp8 kernels is in
``tests/test_torch_fp8.py``.  The lane-aligned gather kernels
(bf16, int8, fp8, duals and requantizing duals) are held to their plain
versions on the card under the same limits, with the int8 scaled
outputs at the identity and bias points bitwise; their CPU parity with
the Pallas gather kernels is in ``tests/test_torch_gather.py``.  The
masked kernels (K10, every class and loader) are held BITWISE to their
unmasked kernels on the same masked X (ragged B, a fully dead row block
whose bias still flushes) and to their plain versions under the same
limits; where the unmasked kernel runs a body of its own that the masked
one does not share (tile_gemm and tile_gemm_fp8 from 256 rows, the float
and fp8 nm_spmm_gather_bk where their plans say so), BITWISE to themselves
with every tile live and within 1e-2 of the unmasked kernel (requantized
fp8 codes: one e4m3 step on at most 0.1% of them); their CPU parity with
the Pallas masked kernels is in ``tests/test_torch_actsparse.py``.
nm_spmm_int8, tile_gemm_int8 and nm_spmm_gather_bk_int8 (the s8 streams
where their int8_plans pick them) are held BITWISE to their plain versions
and to their first bodies, raw, scaled and requantized, and
tile_gemm_masked_fp8 BITWISE to tile_gemm_fp8 (and tile_gemm_fp8_requant's
codes) at qwen3-moe's expert shapes below 256 rows.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import nm as tnm
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.core.quantize import quantize_linear, quantize_per_channel, quantize_rows
from repro_torch.kernels.nm_spmm.kernel import (nm_spmm, nm_spmm_dual, nm_spmm_dual_int8,
                                                nm_spmm_int8)
from repro_torch.kernels.nm_spmm.ref import (nm_spmm_dual_int8_ref, nm_spmm_dual_ref,
                                             nm_spmm_int8_ref, nm_spmm_ref)
from repro_torch.kernels.tile_gemm.kernel import (tile_gemm, tile_gemm_dual,
                                                  tile_gemm_dual_int8, tile_gemm_int8)
from repro_torch.kernels.tile_gemm.ref import (tile_gemm_dual_int8_ref, tile_gemm_dual_ref,
                                               tile_gemm_int8_ref, tile_gemm_ref)
from torch_parity import (assert_scaled_close, cuda_device, from_np,  # noqa: F401
                          jnp_dtype)

TOL = {"float32": 2e-6, "bfloat16": 1e-2}


@pytest.fixture
def ref():
    """The JAX package's kernels.  Imported per test, so that the
    ``cuda`` tests of this file also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import nm
    from repro.kernels import epilogue
    from repro.kernels.nm_spmm.kernel import nm_spmm, nm_spmm_dual
    from repro.kernels.tile_gemm.kernel import tile_gemm, tile_gemm_dual
    return types.SimpleNamespace(jnp=jnp, nm=nm, epilogue=epilogue, nm_spmm=nm_spmm,
                                 nm_spmm_dual=nm_spmm_dual, tile_gemm=tile_gemm,
                                 tile_gemm_dual=tile_gemm_dual)
B, K, O = 8, 128, 128
EPILOGUES = [(None, False), (None, True), ("silu", False), ("gelu", True)]


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * (s[0] ** -0.5 if i else 1.0)
            for i, s in enumerate(shapes)]


def _compressed(ref, w: np.ndarray, n: int):
    """(values, meta_packed) numpy, from the JAX package's compressor."""
    pruned, _ = ref.nm.prune_nm(ref.jnp.asarray(w), n, 4)
    c = ref.nm.compress_nm(pruned, n, 4)
    return np.array(c.values), np.array(ref.nm.pack_meta(c.meta))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_tile_gemm_plain_matches_pallas(ref, dtype, act, bias):
    x, w = _inputs(0, [(B, K), (K, O)])
    b = np.random.default_rng(1).standard_normal(O).astype(np.float32) if bias else None
    jd = jnp_dtype(dtype)
    want = ref.tile_gemm(ref.jnp.asarray(x).astype(jd), ref.jnp.asarray(w).astype(jd),
                       out_dtype=jd, interpret=True,
                       epilogue=ref.epilogue.EpilogueSpec(act=act, bias=bias),
                       bias=None if b is None else ref.jnp.asarray(b))
    got = tile_gemm(from_np(x, dtype), from_np(w, dtype),
                    epilogue=EpilogueSpec(act=act, bias=bias),
                    bias=None if b is None else torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    assert_scaled_close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_gemm_dual_plain_matches_pallas(ref, dtype):
    x, wg, wu = _inputs(2, [(B, K), (K, O), (K, O)])
    jd = jnp_dtype(dtype)
    want = ref.tile_gemm_dual(*(ref.jnp.asarray(a).astype(jd) for a in (x, wg, wu)),
                            out_dtype=jd, interpret=True)
    got = tile_gemm_dual(*(from_np(a, dtype) for a in (x, wg, wu)))
    assert_scaled_close(got, want, TOL[dtype])


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_nm_spmm_plain_matches_pallas(ref, n, dtype, act, bias):
    x, w = _inputs(3, [(B, K), (K, O)])
    jd = jnp_dtype(dtype)
    vals, pm = _compressed(ref, w, n)
    b = np.random.default_rng(4).standard_normal(O).astype(np.float32) if bias else None
    want = ref.nm_spmm(ref.jnp.asarray(x).astype(jd), ref.jnp.asarray(vals).astype(jd),
                     ref.jnp.asarray(pm), n, out_dtype=jd, interpret=True,
                     epilogue=ref.epilogue.EpilogueSpec(act=act, bias=bias),
                     bias=None if b is None else ref.jnp.asarray(b))
    got = nm_spmm(from_np(x, dtype), from_np(vals, dtype), torch.from_numpy(pm), n,
                  epilogue=EpilogueSpec(act=act, bias=bias),
                  bias=None if b is None else torch.from_numpy(b))
    assert_scaled_close(got, want, TOL[dtype])


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nm_spmm_dual_plain_matches_pallas(ref, n, dtype):
    x, wg, wu = _inputs(5, [(B, K), (K, O), (K, O)])
    jd = jnp_dtype(dtype)
    vg, mg = _compressed(ref, wg, n)
    vu, mu = _compressed(ref, wu, n)
    want = ref.nm_spmm_dual(ref.jnp.asarray(x).astype(jd), ref.jnp.asarray(vg).astype(jd),
                          ref.jnp.asarray(mg), ref.jnp.asarray(vu).astype(jd), ref.jnp.asarray(mu),
                          n, out_dtype=jd, interpret=True)
    got = nm_spmm_dual(from_np(x, dtype), from_np(vg, dtype), torch.from_numpy(mg),
                       from_np(vu, dtype), torch.from_numpy(mu), n)
    assert_scaled_close(got, want, TOL[dtype])


# ------------------------------------------------------------ int8 class
def _q_inputs(seed, b, k, o, n=4, pairs=1):
    """Quantized operands as numpy: x_q (B, K) int8 + x_scale (B, 1), and
    per weight either w_q (K, O) (n=4) or (values, meta) at n:4, plus its
    (1, O) scale.  Weights are pruned and compressed before quantizing,
    as ``convert_layout(..., quantize="int8")`` does."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0                       # an idle slot: the floored scale
    xq, xs = quantize_rows(torch.from_numpy(x))
    ws = []
    for _ in range(pairs):
        w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
        if n == 4:
            leaf = quantize_linear({"w": w})
            ws.append((leaf["w"].numpy(), None, leaf["scale"].reshape(1, -1).numpy()))
        else:
            c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
            leaf = quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)})
            ws.append((leaf["values"].numpy(), leaf["meta_packed"].numpy(),
                       leaf["scale"].reshape(1, -1).numpy()))
    return xq.numpy(), xs.numpy(), ws


def _j(ref, *arrays):
    return [None if a is None else ref.jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n", [4, 2, 1])
def test_int8_raw_accumulator_bitwise_equals_pallas(ref, n):
    from repro.kernels.nm_spmm.kernel import nm_spmm_int8 as j_nm
    from repro.kernels.tile_gemm.kernel import tile_gemm_int8 as j_tile
    xq, _, [(w, meta, _)] = _q_inputs(7, B, K, O, n)
    if n == 4:
        want = j_tile(*_j(ref, xq, w), interpret=True)
        got = tile_gemm_int8(*_t(xq, w))
    else:
        want = j_nm(*_j(ref, xq, w, meta), None, None, n, interpret=True)
        got = nm_spmm_int8(*_t(xq, w, meta), None, None, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [4, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_int8_scaled_plain_matches_pallas(ref, n, dtype, act, bias):
    from repro.kernels.nm_spmm.kernel import nm_spmm_int8 as j_nm
    from repro.kernels.tile_gemm.kernel import tile_gemm_int8 as j_tile
    xq, xs, [(w, meta, ws)] = _q_inputs(8, B, K, O, n)
    bv = np.random.default_rng(9).standard_normal(O).astype(np.float32) if bias else None
    jd, td = jnp_dtype(dtype), getattr(torch, dtype)
    jkw = dict(out_dtype=jd, interpret=True, bias=None if bv is None else ref.jnp.asarray(bv),
               epilogue=ref.epilogue.EpilogueSpec(act=act, bias=bias))
    tkw = dict(out_dtype=td, bias=None if bv is None else torch.from_numpy(bv),
               epilogue=EpilogueSpec(act=act, bias=bias))
    if n == 4:
        want = j_tile(*_j(ref, xq, w, xs, ws), **jkw)
        got = tile_gemm_int8(*_t(xq, w, xs, ws), **tkw)
    else:
        want = j_nm(*_j(ref, xq, w, meta, xs, ws), n, **jkw)
        got = nm_spmm_int8(*_t(xq, w, meta, xs, ws), n, **tkw)
    assert got.dtype == td
    assert_scaled_close(got, want, TOL[dtype])


@pytest.mark.parametrize("n", [4, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dual_plain_matches_pallas(ref, n, dtype):
    xq, xs, [(wg, mg, sg), (wu, mu, su)] = _q_inputs(10, B, K, O, n, pairs=2)
    jd, td = jnp_dtype(dtype), getattr(torch, dtype)
    if n == 4:
        want = ref.tile_gemm_dual(*_j(ref, xq, wg, wu, xs, sg, su), acc_dtype=ref.jnp.int32,
                                  out_dtype=jd, interpret=True)
        got = tile_gemm_dual(*_t(xq, wg, wu, xs, sg, su), out_dtype=td)
    else:
        want = ref.nm_spmm_dual(*_j(ref, xq, wg, mg, wu, mu), n, *_j(ref, xs, sg, su),
                                acc_dtype=ref.jnp.int32, out_dtype=jd, interpret=True)
        got = nm_spmm_dual(*_t(xq, wg, mg, wu, mu), n, *_t(xs, sg, su), out_dtype=td)
    assert got.dtype == td
    assert_scaled_close(got, want, TOL[dtype])


def test_int8_wrappers_refuse_what_the_kernels_do_not_take():
    xq, xs, [(w, _, ws)] = _q_inputs(11, B, K, O)
    xq, xs, w, ws = _t(xq, xs, w, ws)
    with pytest.raises(ValueError, match="every scale"):
        tile_gemm_int8(xq, w, xs, None)
    with pytest.raises(ValueError, match="no epilogue"):
        tile_gemm_int8(xq, w, epilogue=EpilogueSpec(act="silu"))
    with pytest.raises(ValueError, match="scales must be"):
        tile_gemm_int8(xq, w, xs.reshape(1, -1), ws)
    with pytest.raises(ValueError, match="int8"):
        tile_gemm_int8(xq.float(), w, xs, ws)
    with pytest.raises(ValueError, match="three scales"):
        tile_gemm_dual_int8(xq, w, w, None, None, None)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        _build.out_kind("tile_gemm_int8", torch.float16, False)
    assert _build.out_kind("tile_gemm_int8", torch.float16, True) == _build.OUT_RAW


def test_cpu_tensors_take_the_plain_version_and_never_count():
    kernels.reset_launch_counts()
    x, w = (torch.from_numpy(a) for a in _inputs(6, [(B, K), (K, O)]))
    c = tnm.compress_nm(tnm.prune_nm(w, 2, 4)[0], 2, 4)
    pm = tnm.pack_meta(c.meta)
    assert torch.equal(tile_gemm(x, w), tile_gemm_ref(x, w))
    assert torch.equal(tile_gemm_dual(x, w, w), tile_gemm_dual_ref(x, w, w))
    assert torch.equal(nm_spmm(x, c.values, pm, 2), nm_spmm_ref(x, c.values, pm, 2))
    assert torch.equal(nm_spmm_dual(x, c.values, pm, c.values, pm, 2),
                       nm_spmm_dual_ref(x, c.values, pm, c.values, pm, 2))
    xq, xs, [(wq, _, ws)] = _q_inputs(12, B, K, O)
    xq, xs, wq, ws = _t(xq, xs, wq, ws)
    assert torch.equal(tile_gemm_int8(xq, wq, xs, ws), tile_gemm_int8_ref(xq, wq, xs, ws))
    assert torch.equal(tile_gemm_dual_int8(xq, wq, wq, xs, ws, ws),
                       tile_gemm_dual_int8_ref(xq, wq, wq, xs, ws, ws))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w = torch.zeros(4, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="lattice point"):
        tile_gemm(x, w, epilogue=EpilogueSpec(act="silu_mul"))
    with pytest.raises(ValueError, match="bias"):
        tile_gemm(x, w, epilogue=EpilogueSpec(bias=True))
    with pytest.raises(ValueError, match="n must be"):
        nm_spmm(x, torch.zeros(48, 64), torch.zeros(12, 64, dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="K_c"):
        nm_spmm(x, torch.zeros(16, 64), torch.zeros(4, 64, dtype=torch.uint8), 2)
    # what only a launch checks: device, tiles, row tile
    with pytest.raises(ValueError, match="CUDA or CPU"):
        _build.check_operands("tile_gemm", torch.zeros(4, 64, device="meta"),
                              block_b=16)
    with pytest.raises(ValueError, match="multiples"):
        _build.check_tiles("tile_gemm", 100, 64)
    assert _build.block_rows(8) == 16 and _build.block_rows(17) == 64


# ----------------------------------------------------------- on the card
CUDA_SHAPES = [(8, 2048, 2048), (37, 2048, 1024), (64, 8192, 2048)]


def _cuda_inputs(dev, b, k, o):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5).bfloat16()
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", CUDA_SHAPES)
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_tile_gemm_kernel_matches_plain_on_card(cuda_device, b, k, o, act, bias):
    x, w = _cuda_inputs(cuda_device, b, k, o)
    bv = torch.randn(o, device=cuda_device) if bias else None
    spec = EpilogueSpec(act=act, bias=bias)
    before = tile_gemm.launches
    got = tile_gemm(x, w, epilogue=spec, bias=bv)
    torch.cuda.synchronize()
    assert tile_gemm.launches == before + 1
    assert_scaled_close(got, tile_gemm_ref(x, w, epilogue=spec, bias=bv), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", CUDA_SHAPES)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_nm_spmm_kernel_matches_plain_on_card(cuda_device, b, k, o, n):
    x, w = _cuda_inputs(cuda_device, b, k, o)
    pruned, _ = tnm.prune_nm(w, n, 4)
    c = tnm.compress_nm(pruned, n, 4)
    pm = tnm.pack_meta(c.meta)
    got = nm_spmm(x, c.values, pm, n)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_ref(x, c.values, pm, n), 1e-2)
    assert_scaled_close(got, x.float() @ pruned.float(), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("n", [None, 1, 2])
def test_dual_kernels_match_plain_on_card(cuda_device, b, n):
    x, wg = _cuda_inputs(cuda_device, b, 2048, 8192)
    wu = torch.flip(wg, dims=[1]).contiguous()
    if n is None:
        got, want = tile_gemm_dual(x, wg, wu), tile_gemm_dual_ref(x, wg, wu)
    else:
        cg = tnm.compress_nm(tnm.prune_nm(wg, n, 4)[0], n, 4)
        cu = tnm.compress_nm(tnm.prune_nm(wu, n, 4)[0], n, 4)
        args = (cg.values, tnm.pack_meta(cg.meta), cu.values, tnm.pack_meta(cu.meta), n)
        got, want = nm_spmm_dual(x, *args), nm_spmm_dual_ref(x, *args)
    torch.cuda.synchronize()
    assert_scaled_close(got, want, 1e-2)


def _cuda_int8(dev, b, k, o, n=4, seed=0):
    """Quantized CUDA operands: (x_q, x_scale) and the leaf of one weight
    (dense ``w`` or compressed ``values``/``meta_packed``, with ``scale``)."""
    x, w = _cuda_inputs(dev, b, k, o)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    w = (torch.randn(k, o, generator=g, device=dev) * k ** -0.5) if seed else w.float()
    if n == 4:
        leaf = quantize_linear({"w": w})
    else:
        c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
        leaf = quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)})
    x[-1] = 0                                    # an idle slot
    xq, xs = quantize_rows(x)
    return xq, xs, leaf


def _single_int8(leaf, n, xq, xs, ws, ref_=False, **kw):
    if n == 4:
        fn = tile_gemm_int8_ref if ref_ else tile_gemm_int8
        return fn(xq, leaf["w"], xs, ws, **kw)
    fn = nm_spmm_int8_ref if ref_ else nm_spmm_int8
    return fn(xq, leaf["values"], leaf["meta_packed"], xs, ws, n, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", CUDA_SHAPES)
@pytest.mark.parametrize("n", [4, 2, 1])
def test_int8_kernels_bitwise_equal_plain_on_card(cuda_device, b, k, o, n):
    xq, xs, leaf = _cuda_int8(cuda_device, b, k, o, n)
    ws = leaf["scale"].reshape(1, -1)
    name = "tile_gemm_int8" if n == 4 else "nm_spmm_int8"
    before = kernels.KERNELS[name].launches
    raw = _single_int8(leaf, n, xq, None, None)
    torch.cuda.synchronize()
    assert kernels.KERNELS[name].launches == before + 1
    assert torch.equal(raw, _single_int8(leaf, n, xq, None, None, ref_=True))
    bias = torch.randn(o, device=cuda_device)
    for dt in (torch.bfloat16, torch.float32):
        for kw in ({}, {"epilogue": EpilogueSpec(bias=True), "bias": bias}):
            got = _single_int8(leaf, n, xq, xs, ws, out_dtype=dt, **kw)
            want = _single_int8(leaf, n, xq, xs, ws, ref_=True, out_dtype=dt, **kw)
            torch.cuda.synchronize()
            assert got.dtype == dt and torch.equal(got, want), (dt, kw)
    spec = EpilogueSpec(act="gelu", bias=True)
    got = _single_int8(leaf, n, xq, xs, ws, out_dtype=torch.bfloat16, epilogue=spec,
                       bias=bias)
    want = _single_int8(leaf, n, xq, xs, ws, ref_=True, out_dtype=torch.bfloat16,
                        epilogue=spec, bias=bias)
    assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("n", [4, 2, 1])
def test_int8_dual_kernels_match_plain_on_card(cuda_device, b, n):
    xq, xs, lg = _cuda_int8(cuda_device, b, 2048, 8192, n)
    _, _, lu = _cuda_int8(cuda_device, b, 2048, 8192, n, seed=3)
    sg, su = lg["scale"].reshape(1, -1), lu["scale"].reshape(1, -1)
    if n == 4:
        args = (xq, lg["w"], lu["w"], xs, sg, su)
        got, want = tile_gemm_dual_int8(*args), tile_gemm_dual_int8_ref(*args)
    else:
        args = (xq, lg["values"], lg["meta_packed"], lu["values"], lu["meta_packed"], n,
                xs, sg, su)
        got, want = nm_spmm_dual_int8(*args), nm_spmm_dual_int8_ref(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, want, 1e-2)
    got = (tile_gemm_dual if n == 4 else nm_spmm_dual)(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
def test_int8_wrappers_raise_on_bad_cuda_operands(cuda_device):
    xq, xs, leaf = _cuda_int8(cuda_device, 8, 256, 128)
    ws = leaf["scale"].reshape(1, -1)
    with pytest.raises(ValueError, match="int8"):
        tile_gemm_int8(xq.float(), leaf["w"], xs, ws)
    with pytest.raises(ValueError, match="contiguous"):
        tile_gemm_int8(xq, leaf["w"].t().contiguous().t(), xs, ws)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tile_gemm_int8(xq, leaf["w"], xs, ws, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="multiples"):
        tile_gemm_int8(xq[:, :96].contiguous(), leaf["w"][:96].contiguous(), xs, ws)


def _requant_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of codes off by one; fails on any larger difference."""
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1
    return float((d == 1).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("n", [4, 2, 1])
def test_requant_dual_kernels_match_plain_on_card(cuda_device, b, n):
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_dual_int8_requant
    from repro_torch.kernels.tile_gemm.kernel import tile_gemm_dual_int8_requant

    xq, xs, lg = _cuda_int8(cuda_device, b, 2048, 8192, n)
    _, _, lu = _cuda_int8(cuda_device, b, 2048, 8192, n, seed=3)
    sg, su = lg["scale"].reshape(1, -1), lu["scale"].reshape(1, -1)
    if n == 4:
        args = (xq, lg["w"], lu["w"], xs, sg, su)
        fn, ref_ = tile_gemm_dual_int8_requant, tile_gemm_dual_int8_ref
    else:
        args = (xq, lg["values"], lg["meta_packed"], lu["values"], lu["meta_packed"], n,
                xs, sg, su)
        fn, ref_ = nm_spmm_dual_int8_requant, nm_spmm_dual_int8_ref
    # a scale that saturates a share of the codes, as a calibrated one may
    rq = ref_(*args).abs().amax() / 200
    before = fn.launches
    got = fn(*args, rq)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert _requant_share(got, ref_(*args, requant_scale=rq)) <= 1e-3
    with pytest.raises(ValueError, match="requant_scale"):
        fn(*args, rq.double())


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,t,d,causal", [
    (8, 16, 8, 32, 128, True), (1, 16, 8, 200, 128, True), (2, 4, 2, 128, 64, True),
    (1, 16, 8, 512, 128, True), (8, 4, 1, 32, 256, True), (1, 4, 1, 200, 256, True),
    (1, 4, 1, 512, 256, True),
    # hubert-xlarge's non-causal D = 80 and phi-3-vision's causal D = 96,
    # ragged in T but 512
    (8, 16, 16, 500, 80, False), (2, 16, 16, 200, 80, False), (2, 4, 2, 100, 96, False),
    (2, 32, 32, 200, 96, True), (1, 32, 32, 512, 96, True), (1, 4, 2, 100, 80, True),
    (1, 16, 8, 200, 128, False)])
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, b, hq, hkv, t, d, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # views of (B, T, H, D) projections, as the model passes them
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=cuda_device).bfloat16()
               .transpose(1, 2) for h in (hq, hkv, hkv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (b, hq, t, d) and got.dtype == torch.bfloat16
    want = flash_attention_ref(q, k, v, causal=causal)
    assert_scaled_close(got, want, 2e-2)
    # and each row against its own size: a late row averages ~T keys and is
    # far smaller than row 0, which sets the whole output's max
    row_err = (got.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1)
    assert row_err.max().item() <= 2e-2
    # the other branch is another function: it must not agree
    other = flash_attention_ref(q, k, v, causal=not causal)
    assert (got.float() - other.float()).abs().max().item() > 1e-1
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k, v, causal=causal)


@pytest.mark.cuda
def test_flash_attention_refuses_a_head_dim_outside_the_instantiations(cuda_device):
    q = torch.zeros((1, 2, 64, 32), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash_attention(q, q, q, causal=False)


# ------------------------------------------------------ fp8 on the card
FP8 = torch.float8_e4m3fn


def _cuda_fp8(dev, b, k, o, n=4, seed=0):
    """e4m3 CUDA operands: (x_q, x_scale) and the leaf of one weight."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    if n == 4:
        leaf = quantize_linear({"w": w}, FP8)
    else:
        c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
        leaf = quantize_linear({"values": c.values, "meta_packed": tnm.pack_meta(c.meta)},
                               FP8)
    x[-1] = 0                                    # an idle slot
    xq, xs = quantize_rows(x, FP8)
    return xq, xs, leaf


def _single_fp8(leaf, n, xq, xs, ws, ref_=False, **kw):
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_fp8
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_fp8_ref
    from repro_torch.kernels.tile_gemm.kernel import tile_gemm_fp8
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_fp8_ref
    if n == 4:
        return (tile_gemm_fp8_ref if ref_ else tile_gemm_fp8)(xq, leaf["w"], xs, ws, **kw)
    return (nm_spmm_fp8_ref if ref_ else nm_spmm_fp8)(xq, leaf["values"], leaf["meta_packed"],
                                                      xs, ws, n, **kw)


def _fp8_step_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of e4m3 codes one step off (adjacent magnitudes of one sign:
    the byte's low 7 bits differ by 1); fails on any larger difference."""
    assert got.dtype == want.dtype == FP8 and got.shape == want.shape
    def ordinal(t):
        b = t.view(torch.uint8).int()
        return torch.where(b >= 128, -(b - 128), b)
    d = (ordinal(got) - ordinal(want)).abs()
    assert int(d.max()) <= 1
    return float((d == 1).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", CUDA_SHAPES)
@pytest.mark.parametrize("n", [4, 2, 1])
def test_fp8_kernels_match_plain_on_card(cuda_device, b, k, o, n):
    """Raw fp32 accumulator and scaled outputs within 1e-2 of max|plain|
    (the sums run in another order; every product of two e4m3 is exact)."""
    xq, xs, leaf = _cuda_fp8(cuda_device, b, k, o, n)
    ws = leaf["scale"].reshape(1, -1)
    name = "tile_gemm_fp8" if n == 4 else "nm_spmm_fp8"
    before = kernels.KERNELS[name].launches
    raw = _single_fp8(leaf, n, xq, None, None)
    torch.cuda.synchronize()
    assert kernels.KERNELS[name].launches == before + 1
    assert raw.dtype == torch.float32
    assert_scaled_close(raw, _single_fp8(leaf, n, xq, None, None, ref_=True), 1e-2)
    bias = torch.randn(o, device=cuda_device)
    for dt in (torch.bfloat16, torch.float32):
        for kw in ({}, {"epilogue": EpilogueSpec(act="gelu", bias=True), "bias": bias}):
            got = _single_fp8(leaf, n, xq, xs, ws, out_dtype=dt, **kw)
            want = _single_fp8(leaf, n, xq, xs, ws, ref_=True, out_dtype=dt, **kw)
            torch.cuda.synchronize()
            assert got.dtype == dt
            assert_scaled_close(got, want, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64, 256])
@pytest.mark.parametrize("n", [4, 2, 1])
def test_fp8_dual_kernels_match_plain_on_card(cuda_device, b, n):
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_dual_fp8, nm_spmm_dual_fp8_requant
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_fp8_ref
    from repro_torch.kernels.tile_gemm.kernel import (tile_gemm_dual_fp8,
                                                      tile_gemm_dual_fp8_requant)
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_fp8_ref

    xq, xs, lg = _cuda_fp8(cuda_device, b, 2048, 8192, n)
    _, _, lu = _cuda_fp8(cuda_device, b, 2048, 8192, n, seed=3)
    sg, su = lg["scale"].reshape(1, -1), lu["scale"].reshape(1, -1)
    if n == 4:
        args = (xq, lg["w"], lu["w"], xs, sg, su)
        fn, fn_rq, ref_ = tile_gemm_dual_fp8, tile_gemm_dual_fp8_requant, tile_gemm_dual_fp8_ref
    else:
        args = (xq, lg["values"], lg["meta_packed"], lu["values"], lu["meta_packed"], n,
                xs, sg, su)
        fn, fn_rq, ref_ = nm_spmm_dual_fp8, nm_spmm_dual_fp8_requant, nm_spmm_dual_fp8_ref
    want = ref_(*args)
    got = fn(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, want, 1e-2)
    got = (tile_gemm_dual if n == 4 else nm_spmm_dual)(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_scaled_close(got, want, 1e-2)
    # the requantizing flush, against a scale that saturates a share of the codes
    rq = want.abs().amax() / 600
    before = fn_rq.launches
    codes = fn_rq(*args, rq)
    torch.cuda.synchronize()
    assert fn_rq.launches == before + 1
    assert _fp8_step_share(codes, ref_(*args, requant_scale=rq)) <= 1e-3
    with pytest.raises(ValueError, match="requant_scale"):
        fn_rq(*args, rq.double())


@pytest.mark.cuda
def test_fp8_wrappers_raise_on_bad_cuda_operands(cuda_device):
    from repro_torch.kernels.tile_gemm.kernel import tile_gemm_fp8
    xq, xs, leaf = _cuda_fp8(cuda_device, 8, 256, 128)
    ws = leaf["scale"].reshape(1, -1)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        tile_gemm_fp8(xq.view(torch.int8), leaf["w"], xs, ws)
    with pytest.raises(ValueError, match="contiguous"):
        tile_gemm_fp8(xq, leaf["w"].t().contiguous().t(), xs, ws)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tile_gemm_fp8(xq, leaf["w"], xs, ws, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="multiples"):
        tile_gemm_fp8(xq[:, :96].contiguous(), leaf["w"][:96].contiguous(), xs, ws)


# -------------------------------------------- lane-aligned gather on the card
def _cuda_gather(dev, b, k, o, n, qdtype=None, seed=0):
    """Gather operands on the card: x (bf16), its quantized rows when
    ``qdtype`` is given, and one gather leaf voted from a random weight."""
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    x[-1] = 0                                    # an idle slot
    leaf = convert_layout({"w": w if qdtype else w.bfloat16()},
                          SparsityConfig(n=n, m=4, mode="gather"), "gather", quantize=qdtype)
    if qdtype is None:
        return x, None, leaf
    return quantize_rows(x, leaf["values"].dtype) + (leaf,)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", CUDA_SHAPES)
@pytest.mark.parametrize("n", [1, 2])
def test_gather_kernels_match_plain_on_card(cuda_device, b, k, o, n):
    from repro_torch.kernels.nm_spmm_gather.kernel import (nm_spmm_gather_bk,
                                                           nm_spmm_gather_dual_bk)
    from repro_torch.kernels.nm_spmm_gather.ref import (nm_spmm_gather_dual_ref,
                                                        nm_spmm_gather_ref)
    x, _, leaf = _cuda_gather(cuda_device, b, k, o, n)
    v, idx = leaf["values"], leaf["gather_idx"]
    bias = torch.randn(o, device=cuda_device)
    for spec, bv in ((EpilogueSpec(), None), (EpilogueSpec(act="gelu", bias=True), bias)):
        before = nm_spmm_gather_bk.launches
        got = nm_spmm_gather_bk(x, v, idx, n, epilogue=spec, bias=bv)
        torch.cuda.synchronize()
        assert nm_spmm_gather_bk.launches == before + 1
        assert_scaled_close(got, nm_spmm_gather_ref(x, v, idx, n, epilogue=spec, bias=bv),
                            1e-2)
    _, _, up = _cuda_gather(cuda_device, b, k, o, n, seed=1)
    args = (x, v, idx, up["values"], up["gather_idx"], n)
    got = nm_spmm_gather_dual_bk(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, nm_spmm_gather_dual_ref(*args), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", CUDA_SHAPES)
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_gather_kernels_match_plain_on_card(cuda_device, b, k, o, n, qdtype):
    """int8: raw int32 accumulator and scaled outputs at the identity and
    bias points bitwise (the flush runs ws before xs, as the plain
    version); fp8 within 1e-2.  Duals within 1e-2; requantized codes
    equal but one step on at most 0.1% of them."""
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr
    xq, xs, leaf = _cuda_gather(cuda_device, b, k, o, n, qdtype)
    v, idx, ws = leaf["values"], leaf["gather_idx"], leaf["scale"].reshape(1, -1)
    single = getattr(gk, f"nm_spmm_gather_bk_{qdtype}")
    before = single.launches
    raw = single(xq, v, idx, None, None, n)
    torch.cuda.synchronize()
    assert single.launches == before + 1
    raw_ref = gr.nm_spmm_gather_quantized_ref(xq, v, idx, None, None, n)
    if qdtype == "int8":
        assert torch.equal(raw, raw_ref)
    else:
        assert_scaled_close(raw, raw_ref, 1e-2)
    bias = torch.randn(o, device=cuda_device)
    for dt in (torch.bfloat16, torch.float32):
        for kw in ({}, {"epilogue": EpilogueSpec(bias=True), "bias": bias},
                   {"epilogue": EpilogueSpec(act="silu", bias=True), "bias": bias}):
            got = single(xq, v, idx, xs, ws, n, out_dtype=dt, **kw)
            want = gr.nm_spmm_gather_quantized_ref(xq, v, idx, xs, ws, n, out_dtype=dt, **kw)
            torch.cuda.synchronize()
            assert got.dtype == dt
            if qdtype == "int8" and kw.get("epilogue", EpilogueSpec()).act is None:
                assert torch.equal(got, want), (dt, kw)
            else:
                assert_scaled_close(got, want, 1e-2)
    _, _, up = _cuda_gather(cuda_device, b, k, o, n, qdtype, seed=1)
    args = (xq, v, idx, up["values"], up["gather_idx"], n, xs, ws,
            up["scale"].reshape(1, -1))
    want = gr.nm_spmm_gather_dual_quantized_ref(*args)
    got = getattr(gk, f"nm_spmm_gather_dual_bk_{qdtype}")(*args)
    torch.cuda.synchronize()
    assert_scaled_close(got, want, 1e-2)
    rq = want.abs().amax() / (200 if qdtype == "int8" else 600)
    fn_rq = getattr(gk, f"nm_spmm_gather_dual_bk_{qdtype}_requant")
    before = fn_rq.launches
    codes = fn_rq(*args, rq)
    torch.cuda.synchronize()
    assert fn_rq.launches == before + 1
    ref_codes = gr.nm_spmm_gather_dual_quantized_ref(*args, requant_scale=rq)
    share = (_requant_share(codes, ref_codes) if qdtype == "int8"
             else _fp8_step_share(codes, ref_codes))
    assert share <= 1e-3


@pytest.mark.cuda
def test_gather_wrappers_raise_on_bad_cuda_operands(cuda_device):
    from repro_torch.kernels.nm_spmm_gather.kernel import nm_spmm_gather_bk
    x, _, leaf = _cuda_gather(cuda_device, 8, 256, 128, 2)
    with pytest.raises(ValueError, match="multiples"):    # K_c = 48
        nm_spmm_gather_bk(x[:, :96].contiguous(), leaf["values"][:48].contiguous(),
                          leaf["gather_idx"][:48].contiguous(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        nm_spmm_gather_bk(x, leaf["values"].t().contiguous().t(), leaf["gather_idx"], 2)
    with pytest.raises(ValueError, match="bfloat16"):
        nm_spmm_gather_bk(x.float(), leaf["values"], leaf["gather_idx"], 2)


# ------------------------------------------- K10: the masked kernels on the card
# the MoE expert shapes: w_out (K=1536, O=4096) and (4096, 1536); B = 24 is a
# ragged row block, B = 100 two row blocks of 64, the second one fully dead
MASKED_SHAPES = [(8, 1536, 4096), (24, 4096, 1536), (100, 1536, 4096)]
MASKED_LAYOUTS = [("dense", 4), ("compressed", 2), ("compressed", 1), ("gather", 2),
                  ("gather", 1)]


def _masked_case(dev, b, k, o, layout, n, qdtype, seed=0):
    """Masked activations (about half the (row block, K step) tiles zeroed,
    the first step of row block 0 and, for B > 64, all of row block 1), a
    weight leaf of ``layout``, the kernel's maps, and the masked and
    unmasked wrappers with their shared operands."""
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.actsparse import block_maps
    from repro_torch.kernels.nm_spmm import kernel as nk
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.tile_gemm import kernel as tk

    g = torch.Generator(device=dev).manual_seed(seed)
    bb = _build.block_rows(b)
    step = 256 // n if layout == "gather" else 64
    nb, ns = -(-b // bb), k // step
    live = torch.rand((nb, ns), generator=g, device=dev) < 0.5
    live[0, 0] = False
    if nb > 1:
        live[1] = False
    tiles = live.repeat_interleave(bb, 0)[:b].repeat_interleave(step, 1)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16() * tiles
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    mode = "gather" if layout == "gather" else "compressed"
    leaf = convert_layout({"w": w if qdtype else w.bfloat16()},
                          SparsityConfig(n=n, m=4, mode=mode), layout if n < 4 else "dense",
                          quantize=qdtype)
    xs = None
    if qdtype is not None:
        x, xs = quantize_rows(x, leaf["w" if "w" in leaf else "values"].dtype)
    kmap, kmask = block_maps(x, bb, step)
    sfx = f"_{qdtype}" if qdtype else ""
    mod, base, ops = {"dense": (tk, "tile_gemm", (leaf.get("w"),)),
                      "compressed": (nk, "nm_spmm", (leaf.get("values"),
                                                     leaf.get("meta_packed"))),
                      "gather": (gk, "nm_spmm_gather_bk", (leaf.get("values"),
                                                           leaf.get("gather_idx")))}[layout]
    masked = getattr(mod, f"{base}_masked{sfx}")
    plain = getattr(mod, f"{base}{sfx}")
    return types.SimpleNamespace(x=x, xs=xs, leaf=leaf, ops=ops, n=n, kmap=kmap, kmask=kmask,
                                 masked=masked, plain=plain, layout=layout, qdtype=qdtype)


def _own_body(layout, qdtype, b, k, o, n, requant=False):
    """Whether the unmasked kernel of a masked case runs a body of its own
    (summing in another order than the shared body the masked one keeps).
    The bf16 nm_spmm_masked, nm_spmm_masked_fp8, below 256 rows the bf16
    tile_gemm_masked, tile_gemm_masked_fp8 wherever tile_gemm_fp8 streams,
    at 2:4 below 256 rows the bf16 nm_spmm_gather_bk_masked, the int8
    nm_spmm_masked_int8 (n in {1, 2}, on nm_spmm_int8's s8 stream) and
    tile_gemm_masked_int8 (on tile_gemm_int8's s8 dense stream at its maps'
    row block), nm_spmm_gather_bk_masked_int8 (n in {1, 2}, on K8 int8's s8
    gathered stream at its maps' row block) and nm_spmm_gather_bk_masked_fp8
    wherever K8 fp8 streams (on its e4m3 gathered stream at its split) run
    their twins' streams at their twins' splits: never there; K1 from 256
    rows (its wgmma body), tile_gemm_fp8 there too, the bf16 K8 where its
    plan's body is not masked_plan's (wgmma from 256 rows, its 1:4 stream
    up to 16 rows), and K8 fp8 where its plan takes its wgmma body: yes."""
    from repro_torch.kernels.nm_spmm_gather.kernel import fp8_plan as gather_fp8_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import masked_fp8_plan as gather_masked_fp8
    from repro_torch.kernels.nm_spmm_gather.kernel import masked_plan as gather_masked_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import plan as gather_plan
    from repro_torch.kernels.tile_gemm.kernel import fp8_plan, masked_fp8_plan, plan
    if (layout, qdtype) == ("dense", None):
        return plan(b, k, o)["body"] == "wgmma"
    if (layout, qdtype) == ("gather", None):
        return gather_plan(b, k, o, n)["body"] != gather_masked_plan(b, k, o, n)["body"]
    if (layout, qdtype) == ("gather", "fp8"):
        return (gather_fp8_plan(b, k, o, n, requant=requant)["body"]
                != gather_masked_fp8(b, k, o, n, requant=requant)["body"])
    if (layout, qdtype) == ("dense", "fp8"):
        return (fp8_plan(b, k, o, requant=requant)["body"]
                != masked_fp8_plan(b, k, o, requant=requant)["body"])
    return False


def _call(case, fn, maps, **kw):
    """One wrapper call in the JAX argument order: x, weight operands, then
    masked: kmap, kmask, [n], [x_scale, w_scale]; unmasked: [x_scale,
    w_scale], [n]."""
    n = [] if case.layout == "dense" else [case.n]
    scales = [] if case.qdtype is None else [case.xs, case.leaf["scale"].reshape(1, -1)]
    if scales:
        kw.setdefault("out_dtype", torch.bfloat16)
    tail = [*maps, *n, *scales] if maps else [*scales, *n]
    return fn(case.x, *case.ops, *tail, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o", MASKED_SHAPES)
@pytest.mark.parametrize("layout,n", MASKED_LAYOUTS)
@pytest.mark.parametrize("qdtype", [None, "int8", "fp8"])
def test_masked_kernels_bitwise_unmasked_on_card(cuda_device, b, k, o, layout, n, qdtype):
    """Each K10 kernel BITWISE its unmasked kernel on the same masked X
    (dead tiles add exact zeros to the fp32 / int32 accumulator), within
    its class's tolerance of its plain version (int8 bitwise at the
    identity and bias points), and a fully dead row block still flushes
    its bias and activation."""
    case = _masked_case(cuda_device, b, k, o, layout, n, qdtype)
    maps = (case.kmap, case.kmask)
    # K1 and the fp8 dense single from 256 rows and, where their plans leave
    # the shared body, the float and fp8 gather K8 run their own bodies, whose
    # sums run in another order than the masked kernel's: the masked kernel
    # is held bitwise to itself with every tile live (the same invariant:
    # dead tiles add exact zeros), the unmasked kernel within 1e-2
    own_body = _own_body(layout, qdtype, b, k, o, n)
    bias = torch.randn(o, device=cuda_device)
    for spec, bv in ((EpilogueSpec(), None), (EpilogueSpec(bias=True), bias),
                     (EpilogueSpec(act="silu", bias=True), bias)):
        before = case.masked.launches
        got = _call(case, case.masked, maps, epilogue=spec, bias=bv)
        torch.cuda.synchronize()
        assert case.masked.launches == before + 1
        unmasked = _call(case, case.plain, (), epilogue=spec, bias=bv)
        if own_body:
            all_live = (case.kmap, torch.ones_like(case.kmask))
            assert torch.equal(got, _call(case, case.masked, all_live, epilogue=spec,
                                          bias=bv)), spec
            assert_scaled_close(got, unmasked, 1e-2)
        else:
            assert torch.equal(got, unmasked), spec
        want = _call(types.SimpleNamespace(**{**vars(case), "x": case.x.cpu(),
                                              "xs": None if case.xs is None else case.xs.cpu(),
                                              "ops": tuple(t.cpu() for t in case.ops),
                                              "leaf": {kk: v.cpu() for kk, v in
                                                       case.leaf.items()}}),
                     case.masked, tuple(t.cpu() for t in maps), epilogue=spec,
                     bias=None if bv is None else bv.cpu())
        if qdtype == "int8" and spec.act is None:
            assert torch.equal(got.cpu(), want), spec
        else:
            assert_scaled_close(got, want, 1e-2)
        if b > 64:   # row block 1 is dead: act(0 + bias) on each of its rows
            dead = torch.zeros((o,), device=cuda_device)
            if bv is not None:
                dead = dead + bv
            if spec.act == "silu":
                dead = torch.nn.functional.silu(dead)
            assert_scaled_close(got[64:], dead.expand(b - 64, o).to(got.dtype), 1e-2)
    if qdtype is not None:   # the raw accumulator too
        nn = () if layout == "dense" else (n,)
        got = case.masked(case.x, *case.ops, *maps, *nn)
        raw = case.plain(case.x, *case.ops, *((None, None) if nn else ()), *nn)
        torch.cuda.synchronize()
        if own_body:
            all_live = (case.kmap, torch.ones_like(case.kmask))
            assert torch.equal(got, case.masked(case.x, *case.ops, *all_live, *nn))
            assert_scaled_close(got, raw, 1e-2)
        else:
            assert torch.equal(got, raw)


@pytest.mark.cuda
def test_masked_kernels_skip_by_kmask_alone_on_card(cuda_device):
    """A live tile that kmask marks dead is skipped: the kernel computes
    with that tile zeroed (the plain version's definition), and a map made
    at another block is refused."""
    from repro_torch.kernels.tile_gemm.kernel import tile_gemm_masked
    case = _masked_case(cuda_device, 8, 1536, 4096, "dense", 4, None)
    x = torch.randn_like(case.x)                          # every tile live
    kmask = case.kmask.clone()
    got = tile_gemm_masked(x, case.ops[0], case.kmap, kmask)
    zeroed = x * kmask.bool().repeat_interleave(64, 1)[:, :1536].repeat(8, 1).to(x.dtype)
    # at 8 rows the masked kernel runs K1's stream at K1's split: bitwise
    # tile_gemm on the zeroed X, and the masked kernel there with every tile live
    want = tile_gemm_masked(zeroed, case.ops[0], case.kmap, torch.ones_like(kmask))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, tile_gemm(zeroed, case.ops[0]))
    with pytest.raises(ValueError, match="block_maps at the kernel's blocks"):
        tile_gemm_masked(x, case.ops[0], case.kmap[:, :12], kmask[:, :12])


# ------------------------------------- the single-GEMM requantize on the card
# gemma3-1b's w_in: (K, O) = (d_model, d_ff) = (1152, 6912), gelu (gather
# 1:4 contracts K * n / 4 = 288 rows, not a multiple of the kernels' 64)
REQUANT_LAYOUTS = [("dense", 4), ("compressed", 2), ("compressed", 1), ("gather", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64, 256])
@pytest.mark.parametrize("layout,n", REQUANT_LAYOUTS)
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_requant_single_kernels_match_plain_on_card(cuda_device, b, layout, n, qdtype):
    """Each ``*_requant`` single (K0's requant point on tile_gemm, nm_spmm
    and nm_spmm_gather_bk, int8 and e4m3) against its plain version, gelu
    with and without bias: codes equal except one code / one e4m3 step on
    at most 0.1% of them (gelu's tanhf may differ by an ulp); the masked
    kernel with the same flush bitwise the unmasked one on the same rows;
    the non-requant wrapper refuses the requant point."""
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.actsparse import block_maps
    from repro_torch.kernels.nm_spmm import kernel as nk
    from repro_torch.kernels.nm_spmm import ref as nr
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr
    from repro_torch.kernels.tile_gemm import kernel as tk
    from repro_torch.kernels.tile_gemm import ref as tr

    k, o = 1152, 6912
    g = torch.Generator(device=cuda_device).manual_seed(b + n)
    x = torch.randn(b, k, generator=g, device=cuda_device).bfloat16()
    x[-1] = 0                                              # an idle slot
    w = torch.randn(k, o, generator=g, device=cuda_device) * k ** -0.5
    mode = "gather" if layout == "gather" else "compressed"
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode=mode),
                          layout if n < 4 else "dense", quantize=qdtype)
    storage = leaf["w" if "w" in leaf else "values"].dtype
    xq, xs = quantize_rows(x, storage)
    ws = leaf["scale"].reshape(1, -1)
    mod, ref_mod, base, ops = {
        "dense": (tk, tr, "tile_gemm", (leaf.get("w"),)),
        "compressed": (nk, nr, "nm_spmm", (leaf.get("values"), leaf.get("meta_packed"))),
        "gather": (gk, gr, "nm_spmm_gather_bk", (leaf.get("values"), leaf.get("gather_idx")))
    }[layout]
    nn = () if layout == "dense" else (n,)
    fn = getattr(mod, f"{base}_{qdtype}_requant")
    ref_fn = getattr(ref_mod, {"tile_gemm": "tile_gemm", "nm_spmm": "nm_spmm",
                               "nm_spmm_gather_bk": "nm_spmm_gather"}[base]
                     + f"_{qdtype}_requant_ref")
    bias = torch.randn(o, generator=g, device=cuda_device) * 0.1
    y32 = getattr(mod, f"{base}_{qdtype}")(xq, *ops, xs, ws, *nn,
                                           epilogue=EpilogueSpec(act="gelu"))
    # a scale that saturates a share of the codes, as a calibrated one may
    rq = (y32.abs().amax() / (100 if qdtype == "int8" else 300)).reshape(())
    for spec, bv in ((EpilogueSpec(act="gelu"), None),
                     (EpilogueSpec(act="gelu", bias=True), bias)):
        before = fn.launches
        got = fn(xq, *ops, xs, ws, *nn, rq, epilogue=spec, bias=bv)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and got.dtype == storage
        want = ref_fn(xq, *ops, xs, ws, *nn, rq, epilogue=spec, bias=bv)
        share = (_requant_share(got, want) if qdtype == "int8" else _fp8_step_share(got, want))
        assert share <= 1e-3, (spec, share)
    # the masked kernel with the same flush, on rows with dead tiles
    bb = _build.block_rows(b)
    step = 256 // n if layout == "gather" else 64
    live = torch.rand((-(-b // bb), k // step), generator=g, device=cuda_device) < 0.5
    tiles = live.repeat_interleave(bb, 0)[:b].repeat_interleave(step, 1)
    xm, xms = quantize_rows(x * tiles, storage)
    maps = block_maps(xm, bb, step)
    masked = getattr(mod, f"{base}_masked_{qdtype}")
    spec = EpilogueSpec(act="gelu", bias=True)
    got = masked(xm, *ops, *maps, *nn, xms, ws, epilogue=spec, bias=bias, requant_scale=rq)
    unmasked = fn(xm, *ops, xms, ws, *nn, rq, epilogue=spec, bias=bias)
    if qdtype == "fp8" and _own_body(layout, qdtype, b, k, o, n, requant=True):
        # K8 fp8's own bodies sum in another order:
        # the masked kernel's codes are its all-live codes bitwise, one e4m3
        # step at most off the unmasked kernel's on at most 0.1% of them
        all_live = (maps[0], torch.ones_like(maps[1]))
        assert torch.equal(got, masked(xm, *ops, *all_live, *nn, xms, ws, epilogue=spec,
                                       bias=bias, requant_scale=rq))
        assert _fp8_step_share(got, unmasked) <= 1e-3
    else:
        assert torch.equal(got, unmasked)
    with pytest.raises(ValueError, match="requant_scale"):
        getattr(mod, f"{base}_{qdtype}")(xq, *ops, xs, ws, *nn,
                                         epilogue=EpilogueSpec(act="gelu", requant=qdtype))
    with pytest.raises(ValueError, match="requant_scale"):
        fn(xq, *ops, xs, ws, *nn, rq.double())


# ------------------------- the s8 stream of nm_spmm_int8, the masked e4m3 stream
def _int8_stream_case(dev, b, k, o, n, seed=0):
    from repro_torch.core import nm
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
    leaf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)},
                           torch.int8)
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    xq, xs = quantize_rows(x, torch.int8)
    return xq, (leaf["values"], leaf["meta_packed"]), xs, leaf["scale"].reshape(1, -1)


@contextlib.contextmanager
def _first_body():
    """The int8 singles' wrappers (nm_spmm_int8, tile_gemm_int8,
    nm_spmm_gather_bk_int8, each and _requant) on gemm_int8.cu's first body
    (body 0, split 1, at the plan's row block)."""
    lib = _build.library("gemm_int8.cu")

    class _Lib:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in ("vg_nm_spmm_int8", "vg_tile_gemm_int8", "vg_nm_spmm_gather_bk_int8"):
                return fn
            return lambda *a: fn(*a[:-3], 0, 1, a[-1])
    saved = _build._libs["gemm_int8.cu"]
    _build._libs["gemm_int8.cu"] = _Lib()
    try:
        yield
    finally:
        _build._libs["gemm_int8.cu"] = saved


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b,k,o", [(1, 2048, 1024), (8, 8192, 2048), (8, 2048, 2048),
                                   (33, 2048, 2048), (64, 8192, 2048), (256, 2048, 2048),
                                   (8, 1152, 6912)])
def test_nm_spmm_int8_bitwise_plain_and_first_body_on_card(cuda_device, b, k, o, n):
    """The plan's body (the s8 stream where int8_plan says so) is bitwise the
    plain version and the first body: the raw int32, bf16 / fp32 with bias
    and gelu, the requantized codes; the masked int8 single (the shared
    body) bitwise it on the same rows."""
    from repro_torch.kernels.actsparse import block_maps
    from repro_torch.kernels.nm_spmm import kernel as nk
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_int8_ref, nm_spmm_int8_requant_ref
    xq, ops, xs, ws = _int8_stream_case(cuda_device, b, k, o, n, seed=b + n)
    bias = torch.randn(o, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device)
    gelu = EpilogueSpec(act="gelu", bias=True)
    forms = [((None, None), {}),
             ((xs, ws), {"out_dtype": torch.bfloat16}),
             ((xs, ws), {"out_dtype": torch.float32, "epilogue": EpilogueSpec(bias=True),
                         "bias": bias}),
             ((xs, ws), {"out_dtype": torch.float32, "epilogue": gelu, "bias": bias})]
    for scales, kw in forms:
        before = nk.nm_spmm_int8.launches
        got = nk.nm_spmm_int8(xq, *ops, *scales, n, **kw)
        with _first_body():
            first = nk.nm_spmm_int8(xq, *ops, *scales, n, **kw)
        torch.cuda.synchronize()
        assert nk.nm_spmm_int8.launches == before + 2
        assert torch.equal(got, first), kw
        want = nm_spmm_int8_ref(xq, *ops, *scales, n, **kw)
        if kw.get("epilogue") is gelu:       # tanhf against torch's tanh
            assert_scaled_close(got, want, 1e-2)
        else:
            assert torch.equal(got, want), kw
    y = nk.nm_spmm_int8(xq, *ops, xs, ws, n, out_dtype=torch.float32)
    rq = (y.abs().amax() / 100).reshape(())
    spec = EpilogueSpec(bias=True)
    codes = nk.nm_spmm_int8_requant(xq, *ops, xs, ws, n, rq, epilogue=spec, bias=bias)
    with _first_body():
        first = nk.nm_spmm_int8_requant(xq, *ops, xs, ws, n, rq, epilogue=spec, bias=bias)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int8 and torch.equal(codes, first)
    assert torch.equal(codes, nm_spmm_int8_requant_ref(xq, *ops, xs, ws, n, rq, epilogue=spec,
                                                       bias=bias))
    live = torch.rand(k // 64, generator=torch.Generator(device=cuda_device).manual_seed(4),
                      device=cuda_device) < 0.4
    xm = xq * live.repeat_interleave(64).to(torch.int8)
    maps = block_maps(xm, _build.block_rows(b), 64)
    masked = nk.nm_spmm_masked_int8(xm, *ops, *maps, n, xs, ws, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(masked, nk.nm_spmm_int8(xm, *ops, xs, ws, n, out_dtype=torch.bfloat16))


def _int8_single(dev, layout, b, k, o, n, seed):
    """(wrapper, requant wrapper, plain, plain requant, weight operands, xq,
    xs, ws) of tile_gemm_int8 (layout "dense") or K8 int8 ("gather")."""
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr
    from repro_torch.kernels.tile_gemm import kernel as tk
    from repro_torch.kernels.tile_gemm import ref as tr
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    x = torch.randn(b, k, generator=g, device=dev).bfloat16()
    x[-1] = 0
    xq, xs = quantize_rows(x, torch.int8)
    if layout == "dense":
        leaf = quantize_linear({"w": w}, torch.int8)
        return (tk.tile_gemm_int8, tk.tile_gemm_int8_requant, tr.tile_gemm_int8_ref,
                tr.tile_gemm_int8_requant_ref, (leaf["w"],), (), xq, xs,
                leaf["scale"].reshape(1, -1))
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                          quantize=torch.int8)
    return (gk.nm_spmm_gather_bk_int8, gk.nm_spmm_gather_bk_int8_requant,
            gr.nm_spmm_gather_quantized_ref, gr.nm_spmm_gather_int8_requant_ref,
            (leaf["values"], leaf["gather_idx"]), (n,), xq, xs, leaf["scale"].reshape(1, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64, 256])
@pytest.mark.parametrize("layout,n,k,o", [("dense", 4, 2048, 1024), ("dense", 4, 8192, 2048),
                                          ("dense", 4, 1152, 6912), ("gather", 2, 2048, 2048),
                                          ("gather", 2, 8192, 2048), ("gather", 1, 8192, 2048),
                                          ("gather", 2, 1152, 6912)])
def test_int8_dense_and_gather_bitwise_plain_and_first_body_on_card(cuda_device, layout, n,
                                                                      k, o, b):
    """tile_gemm_int8 and K8 int8 on their plans' bodies (the s8 dense /
    gathered streams where int8_plan says so) bitwise the plain version and
    the first body: the raw int32, bf16 / fp32 with bias and gelu, the
    requantized codes (both _requant forms); the same bits on a second
    launch."""
    fn, fn_q, ref, ref_q, ops, nn, xq, xs, ws = _int8_single(cuda_device, layout, b, k, o, n,
                                                             seed=b + n + k)
    bias = torch.randn(o, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device)
    gelu = EpilogueSpec(act="gelu", bias=True)
    # the plain versions take (x, ops, xs, ws, n) for the gather, (x, w, xs, ws) dense
    forms = [((None, None), {}),
             ((xs, ws), {"out_dtype": torch.bfloat16}),
             ((xs, ws), {"out_dtype": torch.float32, "epilogue": EpilogueSpec(bias=True),
                         "bias": bias}),
             ((xs, ws), {"out_dtype": torch.float32, "epilogue": gelu, "bias": bias})]
    for scales, kw in forms:
        before = fn.launches
        got = fn(xq, *ops, *scales, *nn, **kw)
        again = fn(xq, *ops, *scales, *nn, **kw)
        with _first_body():
            first = fn(xq, *ops, *scales, *nn, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 3
        assert torch.equal(got, again) and torch.equal(got, first), kw
        want = ref(xq, *ops, *scales, *nn, **kw)
        if kw.get("epilogue") is gelu:       # tanhf against torch's tanh
            assert_scaled_close(got, want, 1e-2)
        else:
            assert torch.equal(got, want), kw
    y = fn(xq, *ops, xs, ws, *nn, out_dtype=torch.float32)
    rq = (y.abs().amax() / 100).reshape(())
    spec = EpilogueSpec(bias=True)
    codes = fn_q(xq, *ops, xs, ws, *nn, rq, epilogue=spec, bias=bias)
    again = fn_q(xq, *ops, xs, ws, *nn, rq, epilogue=spec, bias=bias)
    with _first_body():
        first = fn_q(xq, *ops, xs, ws, *nn, rq, epilogue=spec, bias=bias)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int8 and torch.equal(codes, first) and torch.equal(codes, again)
    assert (codes.abs() == 127).any()
    assert torch.equal(codes, ref_q(xq, *ops, xs, ws, *nn, rq, epilogue=spec, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("k,o", [(1536, 4096), (4096, 1536)])
@pytest.mark.parametrize("b", [1, 8, 64, 100])
def test_tile_gemm_masked_fp8_bitwise_tile_gemm_fp8_on_card(cuda_device, b, k, o, share):
    """qwen3-moe's expert shapes: bitwise tile_gemm_fp8 on the same masked
    rows (raw, bf16, fp32 with bias + silu) and its requantized codes
    bitwise tile_gemm_fp8_requant's, wherever both share a body (every
    point below 256 rows); the same bits on a second launch."""
    from repro_torch.kernels.actsparse import block_maps
    from repro_torch.kernels.tile_gemm import kernel as tk
    from repro_torch.kernels.tile_gemm.kernel import fp8_plan as tile_fp8_plan
    from repro_torch.kernels.tile_gemm.kernel import masked_fp8_plan
    g = torch.Generator(device=cuda_device).manual_seed(b)
    leaf = quantize_linear({"w": torch.randn(k, o, generator=g, device=cuda_device)
                            * k ** -0.5}, FP8)
    w, ws = leaf["w"], leaf["scale"].reshape(1, -1)
    live = torch.zeros(k // 64, dtype=torch.bool, device=cuda_device)
    live[torch.randperm(k // 64, generator=g, device=cuda_device)[:round(share * k // 64)]] = True
    x = torch.randn(b, k, generator=g, device=cuda_device).bfloat16() * live.repeat_interleave(
        64).to(torch.bfloat16)
    xq, xs = quantize_rows(x, FP8)
    maps = block_maps(xq, _build.block_rows(b), 64)
    bias = torch.randn(o, generator=g, device=cuda_device)
    silu = EpilogueSpec(act="silu", bias=True)
    assert masked_fp8_plan(b, k, o)["body"] == tile_fp8_plan(b, k, o)["body"]
    for scales, kw in (((None, None), {}), ((xs, ws), {"out_dtype": torch.bfloat16}),
                       ((xs, ws), {"out_dtype": torch.float32, "epilogue": silu,
                                   "bias": bias})):
        got = tk.tile_gemm_masked_fp8(xq, w, *maps, *scales, **kw)
        again = tk.tile_gemm_masked_fp8(xq, w, *maps, *scales, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.tile_gemm_fp8(xq, w, *scales, **kw)), (share, kw)
        assert torch.equal(got, again)
    y = tk.tile_gemm_fp8(xq, w, xs, ws, out_dtype=torch.float32)
    rq = (y.abs().amax() / 300 + 1e-6).reshape(())
    gelu = EpilogueSpec(act="gelu", bias=True)
    codes = tk.tile_gemm_masked_fp8(xq, w, *maps, xs, ws, epilogue=gelu, bias=bias,
                                    requant_scale=rq)
    want = tk.tile_gemm_fp8_requant(xq, w, xs, ws, rq, epilogue=gelu, bias=bias)
    torch.cuda.synchronize()
    assert codes.dtype == FP8 and torch.equal(codes.view(torch.uint8), want.view(torch.uint8))



# ------------------------------------------------ K11, the K-major gather
def _kmajor_leaf(dev, k, o, n, qdtype=None, seed=0):
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, o, generator=g, device=dev) * k ** -0.5
    return convert_layout({"w": w if qdtype else w.bfloat16()},
                          SparsityConfig(n=n, m=4, mode="gather"), "gather", quantize=qdtype)


def test_kmajor_gather_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels.nm_spmm_gather.kernel import nm_spmm_gather, nm_spmm_gather_int8
    leaf = _kmajor_leaf("cpu", 256, 64, 2, "int8")
    xq = torch.zeros(256, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 16"):
        nm_spmm_gather_int8(xq[:, :24], leaf["values"], leaf["gather_idx"], None, None, 2)
    with pytest.raises(ValueError, match="both scales"):
        nm_spmm_gather_int8(xq, leaf["values"], leaf["gather_idx"],
                            torch.ones(1, 32), None, 2)
    with pytest.raises(ValueError, match=r"\(1, 32\)"):
        nm_spmm_gather_int8(xq, leaf["values"], leaf["gather_idx"], torch.ones(32, 1),
                            leaf["scale"].reshape(-1, 1), 2)
    with pytest.raises(ValueError, match="int8"):
        nm_spmm_gather_int8(xq.float(), leaf["values"], leaf["gather_idx"], None, None, 2)
    with pytest.raises(ValueError, match="K_c"):
        nm_spmm_gather(torch.zeros(128, 32), leaf["values"].float(), leaf["gather_idx"], 2)
    # the JAX signature's (K_c, 1) index column is taken as it is
    raw = nm_spmm_gather_int8(xq, leaf["values"], leaf["gather_idx"].reshape(-1, 1),
                              None, None, 2)
    assert raw.dtype == torch.int32 and raw.shape == (64, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("b,k", [(32, 1024), (256, 4096)])
def test_kmajor_gather_kernels_match_plain_on_card(cuda_device, qdtype, n, b, k):
    """K11 against its plain version: int8 raw and scaled bitwise, fp8 and
    bf16 within 1e-2 of max|plain|; x_t K-major, Y_t (O, B)."""
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr
    o = 2048
    leaf = _kmajor_leaf(cuda_device, k, o, n, qdtype)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(b, k, generator=g, device=cuda_device)
    if qdtype is None:
        x_t = x.bfloat16().t().contiguous()
        for out in (torch.float32, torch.bfloat16):
            before = gk.nm_spmm_gather.launches
            got = gk.nm_spmm_gather(x_t, leaf["values"], leaf["gather_idx"], n, out_dtype=out)
            torch.cuda.synchronize()
            assert gk.nm_spmm_gather.launches == before + 1 and got.dtype == out
            want = gr.nm_spmm_gather_t_ref(x_t, leaf["values"], leaf["gather_idx"], n,
                                           out_dtype=out)
            assert_scaled_close(got, want, 1e-2)
        return
    storage = torch.int8 if qdtype == "int8" else torch.float8_e4m3fn
    fn = getattr(gk, f"nm_spmm_gather_{qdtype}")
    xq, xs = quantize_rows(x, storage)
    x_t, xs_t, ws_t = xq.t().contiguous(), xs.reshape(1, -1), leaf["scale"].reshape(-1, 1)
    before = fn.launches
    raw = fn(x_t, leaf["values"], leaf["gather_idx"], None, None, n)
    scaled = fn(x_t, leaf["values"], leaf["gather_idx"], xs_t, ws_t, n)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    raw_want = gr.nm_spmm_gather_t_quantized_ref(x_t, leaf["values"], leaf["gather_idx"],
                                                 None, None, n)
    want = gr.nm_spmm_gather_t_quantized_ref(x_t, leaf["values"], leaf["gather_idx"], xs_t,
                                             ws_t, n)
    assert raw.dtype == raw_want.dtype and raw.shape == (o, b)
    if qdtype == "int8":
        assert torch.equal(raw, raw_want) and torch.equal(scaled, want)
    else:
        assert_scaled_close(raw, raw_want, 1e-2)
        assert_scaled_close(scaled, want, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "compressed", "gather"])
def test_float_singles_store_fp32_on_card(cuda_device, layout):
    """The row-parallel float partials: tile_gemm / nm_spmm /
    nm_spmm_gather_bk with ``out_dtype=torch.float32`` against their plain
    versions (within 1e-2), and their bf16 store the fp32 one rounded."""
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr
    x, w = _cuda_inputs(cuda_device, 32, 2048, 2048)
    n = 4 if layout == "dense" else 2
    leaf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode=layout), layout)
    run, plain = {
        "dense": (lambda **kw: tile_gemm(x, leaf["w"], **kw),
                  lambda **kw: tile_gemm_ref(x, leaf["w"], **kw)),
        "compressed": (lambda **kw: nm_spmm(x, leaf["values"], leaf["meta_packed"], n, **kw),
                       lambda **kw: nm_spmm_ref(x, leaf["values"], leaf["meta_packed"], n,
                                                **kw)),
        "gather": (lambda **kw: gk.nm_spmm_gather_bk(x, leaf["values"], leaf["gather_idx"], n,
                                                     **kw),
                   lambda **kw: gr.nm_spmm_gather_ref(x, leaf["values"], leaf["gather_idx"],
                                                      n, **kw)),
    }[layout]
    y32, y16 = run(out_dtype=torch.float32), run()
    torch.cuda.synchronize()
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert_scaled_close(y32, plain(out_dtype=torch.float32), 1e-2)
    assert torch.equal(y16, y32.bfloat16())
