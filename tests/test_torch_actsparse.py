"""The port's activation-sparsity class against ``repro.kernels.actsparse``.

- ``apply_mask`` and ``block_maps`` bitwise the JAX package's (top-k with
  tied magnitudes, threshold, zeros; maps with dead first blocks and dead
  row blocks), fp32 and bf16; the port's maps also take a ragged last row
  block (the missing rows count as zeros), equal to JAX's on the
  zero-padded operand.
- The K10 plain versions (what each wrapper runs on CPU tensors) against
  the JAX package's ``tile_gemm_masked``, ``nm_spmm_masked`` and
  ``nm_spmm_gather_bk_masked`` in interpret mode, on the same operands
  and maps (including maps that mark live tiles dead: both skip by
  ``kmask``).  Tolerances as in ``tests/test_torch_gather.py``: fp32 1e-5
  of max|reference| (summation order), bf16 1e-2; int8 scaled outputs
  bitwise at the identity point and within 2e-6 with a bias (XLA's CPU
  compiler fuses the interpret flush's multiply and bias add into an
  FMA); fp8 1e-5 (fp32 out).  The masked plain versions equal the
  unmasked ones on the masked operand bitwise, the int8 raw accumulators
  included.
- Plans: the activation decision and reason codes (skip, mask-only on
  the dual, on the torch / jnp tier, on an entry without a masked
  variant) and the ``describe`` suffix equal the JAX package's, where the
  decline does not depend on the backend.
- ``apply_linear(activation=...)`` on both tiers against the JAX jnp tier.

The CUDA kernels are held bitwise to their unmasked kernels on the card
by the ``cuda`` tests of ``tests/test_torch_kernels.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparsityConfig as JSp
from repro.core import apply_linear as j_apply_linear
from repro.kernels import actsparse as ja
from repro.kernels import dispatch as jd
from repro.kernels import registry as jreg
from repro.kernels.nm_spmm import kernel as jn
from repro.kernels.nm_spmm_gather import kernel as jg
from repro.kernels.tile_gemm import kernel as jt
from repro_torch.core import nm as tnm
from repro_torch.core.quantize import quantize_linear, quantize_rows
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.core.sparse_linear import apply_linear, convert_layout
from repro_torch.kernels import actsparse as ta
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import registry as treg
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm import kernel as tn
from repro_torch.kernels.nm_spmm_gather import kernel as tg
from repro_torch.kernels.reasons import ReasonCode
from repro_torch.kernels.tile_gemm import kernel as tt
from torch_parity import assert_scaled_close, from_np, jnp_dtype, port_params

FP8, JFP8 = torch.float8_e4m3fn, jnp.float8_e4m3fn


def _j(t):
    """torch -> jnp, bf16 and e4m3 bit-exact."""
    if t.dtype == FP8:
        return jnp.asarray(t.view(torch.uint8).numpy().view(JFP8))
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ------------------------------------------------------------ mask + maps
def _tied_rows(seed, b=6, k=64):
    """Rows with repeated magnitudes (signs flipped) around the k-th largest."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[:, 1::4] = -x[:, ::4]
    x[0, :8] = 0.5 * np.array([1, -1, 1, -1, 1, -1, 1, -1], np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", [("topk", 8, 0.0), ("topk", 13, 0.0), ("topk", 100, 0.0),
                                  ("threshold", None, 0.7), ("zeros", None, 0.0)])
def test_apply_mask_is_bitwise_the_reference(dtype, spec):
    kind, k, thr = spec
    x = _tied_rows(0)
    want = ja.apply_mask(jnp.asarray(x).astype(jnp_dtype(dtype)),
                         ja.ActivationSpec(kind, k=k, threshold=thr))
    tspec = ta.ActivationSpec(kind, k=k, threshold=thr)
    got = ta.apply_mask(from_np(x, dtype), tspec)
    assert str(got.dtype).removeprefix("torch.") == dtype
    _eq(got, want)
    assert tspec.point == ja.ActivationSpec(kind, k=k, threshold=thr).point


def test_activation_spec_validates_as_the_reference():
    for bad in (dict(kind="nope"), dict(kind="topk"), dict(kind="topk", k=0)):
        with pytest.raises(ValueError):
            ja.ActivationSpec(**bad)
        with pytest.raises(ValueError):
            ta.ActivationSpec(**bad)


def _sparse_x(seed, b, k, bb, bk, live_share=0.5):
    """(b, k) with whole (bb x bk) tiles zero: the first tile of every row
    block dead, the last row block all dead, the rest live with
    probability ``live_share``; one live tile holds a single nonzero."""
    rng = np.random.default_rng(seed)
    nb, nk = -(-b // bb), k // bk
    live = rng.random((nb, nk)) < live_share
    live[:, 0] = False
    live[-1] = False
    live[0, 1] = True
    tiles = np.repeat(np.repeat(live, bb, 0)[:b], bk, 1)
    x = rng.standard_normal((b, k)).astype(np.float32) * tiles
    x[0, bk: 2 * bk] = 0.0
    x[min(3, b - 1), bk + 5] = 0.25                      # one nonzero keeps (0, 1) live
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,bb,bk", [(32, 256, 16, 64), (64, 512, 16, 128),
                                       (48, 128, 16, 32)])
def test_block_maps_are_bitwise_the_reference(dtype, b, k, bb, bk):
    x = _sparse_x(1, b, k, bb, bk)
    want = ja.block_maps(jnp.asarray(x).astype(jnp_dtype(dtype)), bb, bk)
    got = ta.block_maps(from_np(x, dtype), bb, bk)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32 and tuple(g_.shape) == tuple(w_.shape)
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert not got[1][:, 0].any() and not got[1][-1].any()


@pytest.mark.parametrize("b,bb", [(24, 64), (40, 16), (8, 16)])
def test_block_maps_ragged_rows_count_as_zeros(b, bb):
    """The Hopper kernels' last row block may be ragged: the port's maps
    equal JAX's over the operand zero-padded to whole row blocks."""
    x = _sparse_x(2, b, 256, bb, 64, live_share=0.7)
    pad = np.zeros((-(-b // bb) * bb, 256), np.float32)
    pad[:b] = x
    want = ja.block_maps(jnp.asarray(pad), bb, 64)
    got = ta.block_maps(torch.from_numpy(x), bb, 64)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    with pytest.raises(ValueError, match="K step"):
        ta.block_maps(torch.from_numpy(x[:, :200]), bb, 64)


def test_block_maps_of_narrow_rows():
    """int8 and e4m3 rows quantized from zeros are zero: the maps of the
    codes equal the maps of the float rows."""
    x = torch.from_numpy(_sparse_x(3, 32, 256, 16, 64))
    want = ta.block_maps(x, 16, 64)
    for dt in (torch.int8, FP8):
        xq, _ = quantize_rows(x, dt)
        for g_, w_ in zip(ta.block_maps(xq, 16, 64), want):
            assert torch.equal(g_, w_)


# ------------------------------------------------------- K10 plain versions
B, K, O = 32, 512, 128


def _weights(layout, n, qdtype, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((K, O)).astype(np.float32) * K ** -0.5)
    if layout == "dense":
        leaf = {"w": w}
    elif layout == "compressed":
        c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
        leaf = {"values": c.values, "meta_packed": tnm.pack_meta(c.meta)}
    else:
        leaf = convert_layout({"w": w}, TSp(n=n, m=4, mode="gather"), "gather")
    return quantize_linear(leaf, qdtype) if qdtype else leaf


def _operands(layout, n, dtype, qdtype, seed=0):
    """Masked activations (float or quantized rows), the leaf, the maps at
    the kernels' blocks (16 rows; 64 columns, or 256 / n for gather)."""
    step = 256 // n if layout == "gather" else 64
    x = torch.from_numpy(_sparse_x(seed, B, K, 16, step))
    leaf = _weights(layout, n, qdtype)
    if qdtype is None:
        x = x.to(getattr(torch, dtype))
        if dtype == "bfloat16":
            leaf = {k: v.bfloat16() if v.is_floating_point() else v for k, v in leaf.items()}
        xs = None
    else:
        x, xs = quantize_rows(x, leaf["w" if "w" in leaf else "values"].dtype)
    kmap, kmask = ta.block_maps(x, 16, step)
    return x, xs, leaf, kmap, kmask, step


def _port(layout, n, x, xs, leaf, kmap, kmask, qdtype, **kw):
    """The port's masked wrapper (its plain version: CPU tensors) at the
    maps' 16-row blocks."""
    kw.setdefault("block_b", 16)
    sfx = f"_{qdtype}" if qdtype else ""
    scales = () if xs is None else (xs, leaf["scale"].reshape(1, -1))
    if layout == "dense":
        return getattr(tt, f"tile_gemm_masked{sfx}")(x, leaf["w"], kmap, kmask, *scales, **kw)
    if layout == "compressed":
        return getattr(tn, f"nm_spmm_masked{sfx}")(x, leaf["values"], leaf["meta_packed"],
                                                   kmap, kmask, n, *scales, **kw)
    return getattr(tg, f"nm_spmm_gather_bk_masked{sfx}")(x, leaf["values"],
                                                          leaf["gather_idx"], kmap, kmask, n,
                                                          *scales, **kw)


def _unmasked(layout, n, x, xs, leaf, qdtype, **kw):
    sfx = f"_{qdtype}" if qdtype else ""
    tail = () if qdtype is None else (xs, leaf["scale"].reshape(1, -1))
    if layout == "dense":
        return getattr(tt, f"tile_gemm{sfx}")(x, leaf["w"], *tail, **kw)
    if layout == "compressed":
        return getattr(tn, f"nm_spmm{sfx}")(x, leaf["values"], leaf["meta_packed"], *tail, n,
                                            **kw)
    return getattr(tg, f"nm_spmm_gather_bk{sfx}")(x, leaf["values"], leaf["gather_idx"],
                                                  *tail, n, **kw)


def _reference(layout, n, x, xs, leaf, kmap, kmask, step, qdtype, out_dtype, epi=None,
               bias=None):
    """The JAX package's masked kernel in interpret mode, at the port's
    blocks (16 rows, 128 outputs, one K step)."""
    jepi = None
    if epi is not None:
        from repro.kernels.epilogue import EpilogueSpec as JSpec
        jepi = JSpec(act=epi.act, bias=epi.bias)
    kw = dict(block_b=16, block_o=128, out_dtype=out_dtype, interpret=True, epilogue=jepi,
              bias=None if bias is None else _j(bias))
    scales = () if xs is None else (_j(xs), _j(leaf["scale"].reshape(1, -1)))
    if qdtype is not None:
        kw["acc_dtype"] = jnp.int32 if qdtype == "int8" else jnp.float32
    jm, jk = _j(kmap), _j(kmask)
    if layout == "dense":
        return jt.tile_gemm_masked(_j(x), _j(leaf["w"]), jm, jk, *scales, block_k=step, **kw)
    if layout == "compressed":
        return jn.nm_spmm_masked(_j(x), _j(leaf["values"]), _j(leaf["meta_packed"]), jm, jk,
                                 n, *scales, block_ke=step, **kw)
    return jg.nm_spmm_gather_bk_masked(_j(x), _j(leaf["values"]),
                                       _j(leaf["gather_idx"]).reshape(-1, 1), jm, jk, n,
                                       *scales, block_ke=step, **kw)


LAYOUTS = [("dense", 4), ("compressed", 2), ("compressed", 1), ("gather", 2), ("gather", 1)]


@pytest.mark.parametrize("layout,n", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_masked_plain_versions_match_the_pallas_kernels(layout, n, dtype):
    x, _, leaf, kmap, kmask, step = _operands(layout, n, dtype, None)
    bias = torch.randn(O, generator=torch.Generator().manual_seed(5))
    tol = 1e-5 if dtype == "float32" else 1e-2
    out = jnp_dtype(dtype)
    for epi, bv in ((None, None), (EpilogueSpec(act="silu", bias=True), bias)):
        kw = {} if epi is None else {"epilogue": epi, "bias": bv}
        got = _port(layout, n, x, None, leaf, kmap, kmask, None, **kw)
        assert got.dtype == x.dtype
        assert_scaled_close(got, _reference(layout, n, x, None, leaf, kmap, kmask, step, None,
                                            out, epi, bv), tol)
        # bitwise the unmasked plain version on the already-masked operand
        assert torch.equal(got, _unmasked(layout, n, x, None, leaf, None, **kw))
    # maps that mark a live tile dead: both packages skip it
    kmask2 = kmask.clone()
    kmask2[0, 1] = 0
    kmap2 = torch.cummax(torch.where(kmask2 > 0, torch.arange(kmask2.shape[1],
                                                              dtype=torch.int32), 0), 1).values
    got = _port(layout, n, x, None, leaf, kmap2, kmask2, None)
    assert_scaled_close(got, _reference(layout, n, x, None, leaf, kmap2, kmask2, step, None,
                                        out), tol)
    assert not torch.equal(got, _unmasked(layout, n, x, None, leaf, None))


@pytest.mark.parametrize("layout,n", LAYOUTS)
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_masked_plain_versions_match_the_pallas_kernels(layout, n, qdtype):
    x, xs, leaf, kmap, kmask, step = _operands(layout, n, None, qdtype)
    bias = torch.randn(O, generator=torch.Generator().manual_seed(6))
    for out_t, out_j, epis in ((torch.float32, jnp.float32,
                                ((None, None), (EpilogueSpec(bias=True), bias))),
                               (torch.bfloat16, jnp.bfloat16, ((None, None),))):
        for epi, bv in epis:
            kw = {} if epi is None else {"epilogue": epi, "bias": bv}
            got = _port(layout, n, x, xs, leaf, kmap, kmask, qdtype, out_dtype=out_t, **kw)
            want = _reference(layout, n, x, xs, leaf, kmap, kmask, step, qdtype, out_j,
                              epi, bv)
            assert got.dtype == out_t
            if out_t == torch.bfloat16:
                assert_scaled_close(got, want, 1e-2)
            elif qdtype == "int8" and epi is None:
                _eq(got, want)                           # the same fp32 flush
            else:
                assert_scaled_close(got, want, 2e-6 if qdtype == "int8" else 1e-5)
            assert torch.equal(got, _unmasked(layout, n, x, xs, leaf, qdtype, out_dtype=out_t,
                                              **kw))
    # the raw accumulator: bitwise the unmasked kernel's
    raw = _port(layout, n, x, None, leaf, kmap, kmask, qdtype)
    assert raw.dtype == (torch.int32 if qdtype == "int8" else torch.float32)
    assert torch.equal(raw, _raw_unmasked(layout, n, x, leaf, qdtype))


def _raw_unmasked(layout, n, x, leaf, qdtype):
    if layout == "dense":
        return getattr(tt, f"tile_gemm_{qdtype}")(x, leaf["w"])
    if layout == "compressed":
        return getattr(tn, f"nm_spmm_{qdtype}")(x, leaf["values"], leaf["meta_packed"], None,
                                                None, n)
    return getattr(tg, f"nm_spmm_gather_bk_{qdtype}")(x, leaf["values"], leaf["gather_idx"],
                                                      None, None, n)


def test_maps_at_another_block_are_refused():
    """Maps made at another K step (64 columns for a 2:4 gather kernel,
    whose step is 128) or another row block (16 rows where B = 32 takes
    the 64-row tile) are refused, not re-blocked."""
    x, _, leaf, _, _, _ = _operands("gather", 2, "float32", None)
    with pytest.raises(ValueError, match="block_maps at the kernel's blocks"):
        tg.nm_spmm_gather_bk_masked(x, leaf["values"], leaf["gather_idx"],
                                    *ta.block_maps(x, 16, 64), 2, block_b=16)
    x, _, leaf, kmap, kmask, _ = _operands("dense", 4, "bfloat16", None)
    with pytest.raises(ValueError, match="block_maps at the kernel's blocks"):
        tt.tile_gemm_masked(x, leaf["w"], kmap, kmask)


# ------------------------------------------------------------------ plans
BACKENDS = {"interpret": "cuda", "jnp": "torch"}


def _both(mode, b, ke, o, n, dtype, backend, **extra):
    want = jd.plan(jd.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4, dtype=jnp_dtype(dtype),
                                  **extra), dispatch=jd.DispatchConfig(backend=backend))
    got = td.plan(td.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4, dtype=getattr(torch, dtype),
                                 **extra), dispatch=td.DispatchConfig(backend=BACKENDS[backend]))
    return want, got


def _norm(s):
    s = re.sub(r"\[(interpret|cuda)\] blocks=\([^)]*\)", "[k]", s)
    return s.replace("jnp-reference", "torch-reference").replace("backend=jnp", "backend=torch") \
        .replace("[jnp]", "[torch]").replace("jnp reference", "torch reference")


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2), ("gather", 2)])
@pytest.mark.parametrize("backend", ["interpret", "jnp"])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("point", ["zeros", "top16"])
def test_activation_plans_match_the_reference(mode, n, backend, dual, point):
    extra = dict(activation=point, dual=dual, epilogue="silu_mul" if dual else None)
    want, got = _both(mode, 8, 512, 256, n, "bfloat16", backend, **extra)
    assert got.activation == want.activation == point
    assert got.activation_skip == want.activation_skip
    assert got.activation_reason.value == want.activation_reason.value
    expect = (ReasonCode.ACT_MASK_ONLY_JNP if backend == "jnp" else
              ReasonCode.ACT_MASK_ONLY_DUAL if dual else ReasonCode.ACT_SKIP)
    assert got.activation_reason is expect
    assert _norm(td.describe(got)) == _norm(jd.describe(want))


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_activation_plans_match_the_reference(qdtype):
    want, got = _both("compressed", 8, 1024, 256, 2, {"int8": "int8", "fp8": "float8_e4m3fn"}[
        qdtype], "interpret", activation="zeros")
    assert got.kernel == want.kernel and got.activation_skip and want.activation_skip
    assert got.activation_reason.value == want.activation_reason.value == "activation-skip"
    assert _norm(td.describe(got)) == _norm(jd.describe(want))


def test_entry_without_a_masked_kernel_plans_mask_only():
    """ACT_MASK_ONLY_ENTRY: the same decline in both packages when the
    selected entry carries no masked variant."""
    import dataclasses
    j_entry = next(e for e in jreg.entries("dense") if e.name == "tile_gemm")
    t_entry = next(e for e in treg.entries("dense") if e.name == "tile_gemm")
    try:
        jreg.register(dataclasses.replace(j_entry, activation_skip=False))
        treg.register(dataclasses.replace(t_entry, activation_skip=False))
        want, got = _both("dense", 8, 512, 256, 4, "bfloat16", "interpret", activation="zeros")
        assert got.activation_reason is ReasonCode.ACT_MASK_ONLY_ENTRY
        assert want.activation_reason.value == got.activation_reason.value
        assert not got.activation_skip
        assert _norm(td.describe(got)) == _norm(jd.describe(want))
    finally:
        jreg.register(j_entry)
        treg.register(t_entry)


# ------------------------------------------------------- apply_linear
@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2), ("gather", 2)])
@pytest.mark.parametrize("spec", [("topk", 24, 0.0), ("threshold", None, 0.5),
                                  ("zeros", None, 0.0)])
def test_apply_linear_with_activation_matches_the_jnp_tier(mode, n, spec):
    """The torch tier and the cuda tier's plain versions (CPU tensors) on
    the masked operand, against the JAX jnp tier; the two port tiers
    within fp32 summation order of each other."""
    kind, k, thr = spec
    rng = np.random.default_rng(7)
    w = rng.standard_normal((256, 128)).astype(np.float32) / 16
    x = _sparse_x(8, 16, 256, 16, 64, live_share=0.8)
    jcfg, tcfg = JSp(n=n, m=4, mode=mode), TSp(n=n, m=4, mode=mode)
    from repro.core.sparse_linear import convert_layout as j_convert
    jleaf = j_convert({"w": jnp.asarray(w)}, jcfg, mode)
    leaf = port_params(jleaf)
    with jd.use_dispatch(backend="jnp"):
        want = j_apply_linear(jleaf, jnp.asarray(x), jcfg,
                              activation=ja.ActivationSpec(kind, k=k, threshold=thr))
    tspec = ta.ActivationSpec(kind, k=k, threshold=thr)
    with td.use_dispatch(backend="torch"):
        got = apply_linear(leaf, torch.from_numpy(x), tcfg, activation=tspec)
        ref16 = apply_linear({kk: v.bfloat16() if v.is_floating_point() else v
                              for kk, v in leaf.items()}, from_np(x, "bfloat16"), tcfg,
                             activation=tspec)
    assert_scaled_close(got, want, 1e-5)
    # bf16 on the cuda tier: the masked kernel's plain version (CPU tensors)
    with td.use_dispatch(backend="cuda"):
        leaf16 = {kk: v.bfloat16() if v.is_floating_point() else v for kk, v in leaf.items()}
        d = td.plan_for(leaf16, (16, 256), tcfg, dtype=torch.bfloat16)
        got16 = apply_linear(leaf16, from_np(x, "bfloat16"), tcfg, activation=tspec)
    assert d.uses_kernel
    assert_scaled_close(got16, ref16, 1e-2)
