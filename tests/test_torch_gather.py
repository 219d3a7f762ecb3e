"""The port's lane-aligned gather layout against the JAX package.

- ``convert_layout(..., "gather")``: ``values``, ``gather_idx`` and the
  quantized ``scale`` bitwise the JAX package's, fp32 and bf16 weights,
  n in {1, 2}, single and stacked leaves, float / int8 / fp8, on weights
  with tied M-blocks (rows of equal |w| sums: the stable sort keeps the
  lower rows in both packages).
- Kernels: each gather wrapper, handed CPU tensors, runs its plain
  version; that is held to the JAX package's Pallas gather kernel in
  interpret mode on the same numpy-seeded inputs.  Float: fp32 within
  1e-5 of max|reference| (summation order only), bf16 within 1e-2 (one
  bf16 rounding, in other places).  int8 scaled singles: bitwise at the
  identity point (the flush is the same fp32 ops, ws before xs); within
  2e-6 / 1e-2 at bias, silu and gelu (XLA's CPU compiler contracts the
  interpret-mode flush's multiply and bias add into one FMA: every
  element of the reference equals fma(acc * ws, xs, bias), where the
  port and the CUDA flush round the product first; and the two
  frameworks' exp and tanh may differ by an ulp); the raw int32
  accumulator bitwise the K-major Pallas kernel's.  fp8: within 1e-5 (fp32 out; every e4m3
  product is exact in fp32, the sums run in another order) / 1e-2
  (bf16).  Duals within 2e-6 / 1e-2 (int8), 1e-5 / 1e-2 (fp8).
  Requantized codes (int8 and e4m3) equal as bytes.
- Planning: gather plans, reason codes and report lines equal the JAX
  package's across the backend-independent cases (``interpret`` ->
  ``cuda``, ``jnp`` -> ``torch``, blocks aside); where the Hopper tiling
  (K_c = K * n / 4 and O multiples of 64, bf16 / int8 / e4m3 only)
  declines what the TPU kernels tile, the port plans NO_KERNEL_FITS,
  pinned below; ``requant_decision`` for a gather consumer.
- The torch tier against the jnp tier on one linear (gathered columns,
  dequantized weight), within 1e-5.

The model, artifact and launcher checks of the layout are in
``tests/test_torch_gather_model.py``.

The CUDA kernels themselves are held to their plain versions on the card
by the ``cuda`` tests of ``tests/test_torch_kernels.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparsityConfig as JSp
from repro.core.sparse_linear import apply_linear as j_apply_linear
from repro.core.sparse_linear import convert_layout as j_convert
from repro.kernels import dispatch as jd
from repro.kernels import epilogue as jepi
from repro.kernels.nm_spmm_gather import kernel as jg
from repro_torch import kernels
from repro_torch.core import quantize as tquant
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.core.sparse_linear import apply_linear, convert_layout, is_linear_leaf
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm_gather import kernel as tg
from repro_torch.kernels.reasons import ReasonCode
from torch_parity import assert_scaled_close, from_np, jnp_dtype, port_params

FP8, JFP8 = torch.float8_e4m3fn, jnp.float8_e4m3fn
QDT = {"int8": (torch.int8, jnp.int32), "fp8": (FP8, jnp.float32)}
B, K, O = 8, 256, 128
EPILOGUES = [(None, False), (None, True), ("silu", False), ("gelu", True)]


def _bytes(t) -> np.ndarray:
    """Any tensor or array as its raw bytes (bf16 and e4m3 included)."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def _j(*tensors):
    """torch -> jnp, e4m3 through its byte view (bit-exact)."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
        elif t.dtype == FP8:
            out.append(jnp.asarray(t.view(torch.uint8).numpy().view(JFP8)))
        elif t.dtype == torch.bfloat16:
            out.append(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


# -------------------------------------------------------------- conversion
def _tied(seed, k, o):
    """A weight whose M-blocks tie: in every third block rows 0 and 1 have
    equal |w| (signs flipped) and rows 2 and 3 too; block 1 has four rows
    of equal magnitude."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5
    for g in range(0, k // 4, 3):
        w[4 * g + 1] = -w[4 * g]
        w[4 * g + 3] = w[4 * g + 2]
    w[4:8] = w[4] * np.array([[1.0], [-1.0], [-1.0], [1.0]], np.float32)
    return w


@pytest.mark.parametrize("quantize", [None, "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_layout_gather_is_bitwise_the_reference(dtype, n, quantize):
    stacked = np.stack([_tied(s, 128, 64) for s in range(3)])
    jcfg, tcfg = JSp(n=n, m=4, mode="gather"), TSp(n=n, m=4, mode="gather")
    for w in (stacked[0], stacked):
        want = j_convert({"w": jnp.asarray(w).astype(jnp_dtype(dtype))}, jcfg, "gather",
                         quantize=quantize)
        got = convert_layout({"w": from_np(w, dtype)}, tcfg, "gather", quantize=quantize)
        assert sorted(got) == sorted(want) and is_linear_leaf(got)
        for key in want:
            a = np.asarray(want[key])
            assert str(got[key].dtype).removeprefix("torch.") == str(a.dtype), key
            assert list(got[key].shape) == list(a.shape), key
            np.testing.assert_array_equal(_bytes(got[key]), _bytes(a), err_msg=key)
        idx = got["gather_idx"].reshape(-1, n)
        assert idx.dtype == torch.int32 and bool((idx[..., 1:] > idx[..., :-1]).all())


def test_convert_keeps_the_lower_rows_of_tied_blocks():
    w = torch.from_numpy(_tied(0, 64, 32))
    got = convert_layout({"w": w}, TSp(n=2, m=4, mode="gather"), "gather")
    assert got["gather_idx"][2:4].tolist() == [0, 1]        # block 1: four equal rows
    one = convert_layout({"w": w}, TSp(n=1, m=4, mode="gather"), "gather")
    assert one["gather_idx"][1].item() == 0


# ------------------------------------------------------------------ kernels
def _leaf(seed, n, quantize=None, k=K, o=O):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
    return convert_layout({"w": w}, TSp(n=n, m=4, mode="gather"), "gather", quantize=quantize)


def _x(seed, b=B, k=K):
    x = np.random.default_rng(seed).standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0                       # an idle slot
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_gather_plain_matches_pallas(n, dtype, tol, act, bias):
    leaf, x = _leaf(0, n), _x(1)
    bv = torch.from_numpy(np.random.default_rng(2).standard_normal(O).astype(np.float32))
    bv = bv if bias else None
    td_ = getattr(torch, dtype)
    v, xt = leaf["values"].to(td_), x.to(td_)
    want = jg.nm_spmm_gather_bk(*_j(xt, v, leaf["gather_idx"].reshape(-1, 1)), n,
                                out_dtype=jnp_dtype(dtype), interpret=True,
                                epilogue=jepi.EpilogueSpec(act=act, bias=bias),
                                bias=None if bv is None else jnp.asarray(bv.numpy()))
    got = tg.nm_spmm_gather_bk(xt, v, leaf["gather_idx"], n,
                               epilogue=EpilogueSpec(act=act, bias=bias), bias=bv)
    assert got.dtype == td_
    assert_scaled_close(got, want, tol)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_gather_dual_plain_matches_pallas(n, dtype, tol):
    g, u, x = _leaf(3, n), _leaf(4, n), _x(5)
    assert not torch.equal(g["gather_idx"], u["gather_idx"])   # two index streams
    td_ = getattr(torch, dtype)
    args = (x.to(td_), g["values"].to(td_), g["gather_idx"], u["values"].to(td_),
            u["gather_idx"])
    xj, vgj, igj, vuj, iuj = _j(*args)
    want = jg.nm_spmm_gather_dual_bk(xj, vgj, igj.reshape(-1, 1), vuj, iuj.reshape(-1, 1), n,
                                     out_dtype=jnp_dtype(dtype), interpret=True)
    got = tg.nm_spmm_gather_dual_bk(*args, n)
    assert_scaled_close(got, want, tol)


def _q(seed, n, qdtype, pairs=1):
    """Quantized operands: x_q, x_scale (rows quantized over the full
    K_eff) and ``pairs`` gather leaves with their (1, O) scales."""
    dt = QDT[qdtype][0]
    xq, xs = tquant.quantize_rows(_x(seed), dt)
    leaves = [_leaf(seed + 1 + i, n, qdtype) for i in range(pairs)]
    return xq, xs, [(lf["values"], lf["gather_idx"], lf["scale"].reshape(1, -1))
                    for lf in leaves]


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("n", [1, 2])
def test_raw_accumulator_matches_the_k_major_pallas_kernel(n, qdtype):
    xq, _, [(v, idx, _)] = _q(6, n, qdtype)
    jfn = jg.nm_spmm_gather_int8 if qdtype == "int8" else jg.nm_spmm_gather_fp8
    xj, vj, ij = _j(xq, v, idx)
    want = np.asarray(jfn(xj.T, vj, ij.reshape(-1, 1), None, None, n, interpret=True)).T
    fn = tg.nm_spmm_gather_bk_int8 if qdtype == "int8" else tg.nm_spmm_gather_bk_fp8
    got = fn(xq, v, idx, None, None, n)
    if qdtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        assert_scaled_close(got, want, 1e-5)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_quantized_scaled_plain_matches_pallas(qdtype, n, dtype, act, bias):
    xq, xs, [(v, idx, ws)] = _q(7, n, qdtype)
    bv = np.random.default_rng(8).standard_normal(O).astype(np.float32) if bias else None
    jdt, tdt = jnp_dtype(dtype), getattr(torch, dtype)
    xj, vj, ij, xsj, wsj = _j(xq, v, idx, xs, ws)
    want = jg.nm_spmm_gather_bk(xj, vj, ij.reshape(-1, 1), n, xsj, wsj,
                                acc_dtype=QDT[qdtype][1], out_dtype=jdt, interpret=True,
                                epilogue=jepi.EpilogueSpec(act=act, bias=bias),
                                bias=None if bv is None else jnp.asarray(bv))
    fn = tg.nm_spmm_gather_bk_int8 if qdtype == "int8" else tg.nm_spmm_gather_bk_fp8
    got = fn(xq, v, idx, xs, ws, n, out_dtype=tdt, epilogue=EpilogueSpec(act=act, bias=bias),
             bias=None if bv is None else torch.from_numpy(bv))
    assert got.dtype == tdt
    if qdtype == "int8" and act is None and not bias:
        # the same fp32 flush ops, ws before xs: bitwise
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    else:
        assert_scaled_close(got, want, {"float32": 2e-6 if qdtype == "int8" else 1e-5,
                                        "bfloat16": 1e-2}[dtype])


def _dual(seed, n, qdtype):
    xq, xs, [(vg, ig, sg), (vu, iu, su)] = _q(seed, n, qdtype, pairs=2)
    args = (xq, vg, ig, vu, iu, n, xs, sg, su)
    xj, vgj, igj, vuj, iuj, xsj, sgj, suj = _j(xq, vg, ig, vu, iu, xs, sg, su)

    def jax_dual(**kw):
        return jg.nm_spmm_gather_dual_bk(xj, vgj, igj.reshape(-1, 1), vuj, iuj.reshape(-1, 1),
                                         n, xsj, sgj, suj, acc_dtype=QDT[qdtype][1],
                                         interpret=True, **kw)
    return args, jax_dual


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dual_plain_matches_pallas(qdtype, n, dtype):
    args, jax_dual = _dual(9, n, qdtype)
    want = jax_dual(out_dtype=jnp_dtype(dtype))
    fn = tg.nm_spmm_gather_dual_bk_int8 if qdtype == "int8" else tg.nm_spmm_gather_dual_bk_fp8
    got = fn(*args, out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_scaled_close(got, want, {"float32": 2e-6 if qdtype == "int8" else 1e-5,
                                    "bfloat16": 1e-2}[dtype])


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("n", [1, 2])
def test_requant_dual_codes_equal_pallas(qdtype, n):
    """The requant:<dtype> flush: codes equal as bytes, against a scale
    that saturates a share of them."""
    args, jax_dual = _dual(10, n, qdtype)
    dt = QDT[qdtype][0]
    y = (tg.nm_spmm_gather_dual_bk_int8 if qdtype == "int8"
         else tg.nm_spmm_gather_dual_bk_fp8)(*args)
    rq = np.float32(y.abs().max().item() / (200 if qdtype == "int8" else 600))
    name = "int8" if qdtype == "int8" else "float8_e4m3fn"
    want = jax_dual(epilogue=jepi.EpilogueSpec(act="silu_mul", requant=name),
                    requant_scale=jnp.asarray(rq))
    fn = (tg.nm_spmm_gather_dual_bk_int8_requant if qdtype == "int8"
          else tg.nm_spmm_gather_dual_bk_fp8_requant)
    got = fn(*args, torch.tensor(rq))
    assert got.dtype == dt
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    assert (got.float().abs() == tquant.qmax(dt)).any()     # some codes saturate


def test_wrappers_refuse_what_the_kernels_do_not_take():
    leaf, x = _leaf(11, 2), _x(12)
    v, idx = leaf["values"], leaf["gather_idx"]
    with pytest.raises(ValueError, match="K_c"):
        tg.nm_spmm_gather_bk(x[:, :128], v, idx, 2)
    with pytest.raises(ValueError, match="int32"):
        tg.nm_spmm_gather_bk(x, v, idx.long(), 2)
    with pytest.raises(ValueError, match="n must be"):
        tg.nm_spmm_gather_bk(x, v, idx, 3)
    with pytest.raises(ValueError, match="must match"):
        tg.nm_spmm_gather_dual_bk(x, v, idx, v[:, :64], idx, 2)
    xq, xs, [(vq, iq, ws)] = _q(13, 2, "int8")
    with pytest.raises(ValueError, match="int8"):
        tg.nm_spmm_gather_bk_int8(xq.float(), vq, iq, xs, ws, 2)
    with pytest.raises(ValueError, match="every scale"):
        tg.nm_spmm_gather_bk_int8(xq, vq, iq, xs, None, 2)
    with pytest.raises(ValueError, match="three scales"):
        tg.nm_spmm_gather_dual_bk_int8(xq, vq, iq, vq, iq, 2, None, None, None)
    with pytest.raises(ValueError, match="requant_scale"):
        tg.nm_spmm_gather_dual_bk_int8_requant(xq, vq, iq, vq, iq, 2, xs, ws, ws,
                                               torch.ones(2))
    kernels.reset_launch_counts()
    tg.nm_spmm_gather_bk(x, v, idx, 2)
    tg.nm_spmm_gather_bk_int8(xq, vq, iq, xs, ws, 2)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}   # CPU: none


# ----------------------------------------------------------------- planning
# (b, ke, o, n, dtype, extra GemmProblem fields, JAX backend)
PLAN_CASES = [
    (16, 256, 64, 2, "bfloat16", {}, "interpret"),
    (16, 256, 64, 1, "bfloat16", {}, "interpret"),
    (8, 2048, 1024, 2, "bfloat16", {}, "interpret"),
    (8, 256, 128, 2, "bfloat16", {"epilogue": "bias+gelu"}, "interpret"),
    (8, 256, 128, 1, "bfloat16", {"epilogue": "silu_mul", "dual": True}, "interpret"),
    (16, 256, 64, 2, "float32", {}, "jnp"),
    (16, 256, 64, 2, "bfloat16", {"differentiating": True}, "interpret"),
    (0, 256, 64, 2, "bfloat16", {}, "interpret"),
    (8, 256, 64, 2, "int8", {}, "interpret"),
    (37, 256, 128, 1, "int8", {}, "interpret"),
    (8, 256, 128, 2, "int8", {"epilogue": "silu_mul", "dual": True}, "interpret"),
    (8, 256, 128, 2, "int8", {"epilogue": "silu_mul+requant:int8", "dual": True,
                              "static_scales": True}, "interpret"),
    (32, 256, 64, 2, "float8_e4m3fn", {}, "interpret"),
    (8, 256, 128, 1, "float8_e4m3fn", {"epilogue": "silu_mul+requant:float8_e4m3fn",
                                       "dual": True, "static_scales": True}, "interpret"),
    (8, 256, 64, 2, "int8", {}, "jnp"),
]


def _plans(b, ke, o, n, dtype, extra, backend):
    want = jd.plan(jd.GemmProblem("gather", b=b, ke=ke, o=o, n=n, m=4,
                                  dtype=jnp_dtype(dtype), **extra),
                   dispatch=jd.DispatchConfig(backend=backend))
    got = td.plan(td.GemmProblem("gather", b=b, ke=ke, o=o, n=n, m=4,
                                 dtype=getattr(torch, dtype), **extra),
                  dispatch=td.DispatchConfig(backend={"interpret": "cuda",
                                                      "jnp": "torch"}[backend]))
    return want, got


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: f"{c[:5]}-{c[5].get('epilogue', '')}-{c[6]}")
def test_gather_plans_match_reference(case):
    want, got = _plans(*case)
    names = {jd.JNP_REFERENCE: td.TORCH_REFERENCE}
    assert got.kernel == names.get(want.kernel, want.kernel)
    assert got.mode == want.mode == "gather"
    assert got.reason_code.value == want.reason_code.value
    assert (got.epilogue_reason and got.epilogue_reason.value) == \
        (want.epilogue_reason and want.epilogue_reason.value)
    assert got.epilogue_fused == want.epilogue_fused
    assert got.dtype == want.dtype and got.act_scales == want.act_scales
    if got.uses_kernel:
        def norm(s):
            return re.sub(r"\[(interpret|cuda)\] blocks=\([^)]*\)", "[k]", s)
        assert norm(td.describe(got)) == norm(jd.describe(want))
        assert got.blocks[1] == 64 * 4 // case[3]     # one K step: 64 compressed rows


@pytest.mark.parametrize("b,ke,o,n,dtype", [
    (8, 256, 64, 2, "float32"),         # the CUDA kernels take bf16 only
    (8, 64, 32, 2, "bfloat16"),         # the smoke config's wk / wv: O = 32
    (8, 128, 64, 1, "bfloat16"),        # K_c = 32: 1:4 at the smoke width
    (32, 128, 64, 1, "float8_e4m3fn"),  # the same, fp8
])
def test_port_declines_what_its_gather_kernels_do_not_tile(b, ke, o, n, dtype):
    want, got = _plans(b, ke, o, n, dtype, {}, "interpret")
    assert want.uses_kernel                      # the TPU kernels fit these
    assert not got.uses_kernel
    assert got.reason_code is ReasonCode.NO_KERNEL_FITS


def _jleaf(n, quantize, seed=0, k=256, o=128):
    w = np.random.default_rng(seed).standard_normal((k, o)).astype(np.float32) * k ** -0.5
    jcfg = JSp(n=n, m=4, mode="gather")
    jleaf = j_convert({"w": jnp.asarray(w)}, jcfg, "gather", quantize=quantize)
    return jcfg, jleaf, TSp(n=n, m=4, mode="gather"), port_params(jleaf)


@pytest.mark.parametrize("quantize", ["int8", "fp8"])
def test_requant_decision_for_a_gather_consumer_matches_reference(quantize):
    jcfg, jq, tcfg, tq = _jleaf(2, quantize)
    s = np.float32(0.01)
    jstat, tstat = {**jq, "act_scale": jnp.asarray(s)}, {**tq, "act_scale": torch.tensor(s)}
    for jleaf, tleaf, jb, tb in ((jq, tq, "interpret", "cuda"),
                                 (jstat, tstat, "interpret", "cuda"),
                                 (jstat, tstat, "jnp", "torch")):
        jres, jcode = jd.requant_decision(jleaf, (8,), jcfg,
                                          dispatch=jd.DispatchConfig(backend=jb))
        tres, tcode = td.requant_decision(tleaf, (8,), tcfg,
                                          dispatch=td.DispatchConfig(backend=tb))
        assert tcode.value == jcode.value
        assert (tres is None) == (jres is None)
        if tres is not None:
            assert tres[0] == jres[0] and float(tres[1]) == float(jres[1])


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("n", [1, 2])
def test_gather_torch_tier_matches_the_jnp_tier(n, quantize):
    """The reference tiers: gathered columns, the dequantized weight."""
    jcfg, jl, tcfg, tl = _jleaf(n, quantize)
    x = np.random.default_rng(3).standard_normal((2, 3, 256)).astype(np.float32)
    with jd.use_dispatch(backend="jnp"):
        want = j_apply_linear(jl, jnp.asarray(x), jcfg)
    with td.use_dispatch(backend="torch"):
        got = apply_linear(tl, torch.from_numpy(x), tcfg)
    assert got.shape == (2, 3, 128)
    assert_scaled_close(got, want, 1e-5)


def test_gather_dispatch_report_fuses_the_gate_up_pair():
    from repro_torch.core.quantize import quantize_tree
    _, _, tcfg, tg_ = _jleaf(2, None, seed=1)
    _, _, _, tu = _jleaf(2, None, seed=2)
    tg_, tu = ({**p, "values": p["values"].bfloat16()} for p in (tg_, tu))   # bf16 kernels
    for q, name in ((None, "nm_spmm_gather[cuda]"), ("int8", "nm_spmm_gather_int8[cuda]")):
        tree = {"ffn": {"w_gate": tg_, "w_in": tu}}
        tree = quantize_tree(tree, q) if q else tree
        lines = td.dispatch_report(tree, (8,), tcfg, dispatch=td.DispatchConfig(backend="cuda"))
        assert len(lines) == 2 and all(name in ln for ln in lines)
        assert "gate-up" in lines[-1] and "silu_mul[fused]" in lines[-1]
