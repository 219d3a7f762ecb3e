"""The single-GEMM requantize (K0's ``requant:<dtype>`` point on a single
GEMM, the gelu MLP's ``w_in``) in the port against the JAX package.

- Kernels: the six ``*_requant`` singles (``tile_gemm``, ``nm_spmm`` and
  ``nm_spmm_gather_bk``, int8 and fp8), handed CPU tensors, run their
  plain versions; those are held to the JAX package's ``tile_gemm_int8`` /
  ``_fp8``, ``nm_spmm_int8`` / ``_fp8`` and ``nm_spmm_gather_bk`` with
  ``epilogue=make(act="gelu", requant=...)`` in interpret mode, on the
  same numpy-seeded codes and against a scale that saturates a share of
  them: codes equal except one code (int8) or one e4m3 step on at most
  0.1% of them (gelu's tanh may differ by an ulp between the two
  frameworks, and XLA contracts the gather flush's bias add into an FMA;
  measured here: 0 codes off in every case).  The masked kernels take the
  same flush, as the JAX package's do, with codes equal to the unmasked
  requant kernel's on the same masked rows.
- Dispatch: ``requant_decision`` for a gelu MLP's ``w_out`` gives the JAX
  package's reason codes and scale (fused, dynamic scales, no quantized
  consumer, consumer fallback) in int8 and fp8, dense / 2:4 / gather 2:4.
- The MoE expert FFN's gelu branch makes the JAX package's decision: on a
  gelu variant of the qwen3-moe smoke config (widened so that every
  expert linear fits the cuda kernels) with static int8 scales, each
  expert's ``w_in`` runs ``*_int8_requant`` (the masked kernel with the
  requant flush on the spgemm path) and every ``w_out`` contracts int8
  rows; the paged logits match the JAX interpret tier's within
  test_torch_static.py's fp32 limit (2e-3 scaled).

The CUDA kernels are held to these plain versions on the card by the
``cuda`` tests of ``tests/test_torch_kernels.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.core.sparse_linear import convert_layout as j_convert
from repro.kernels import dispatch as jd
from repro.kernels import epilogue as jepi
from repro.kernels.nm_spmm.kernel import nm_spmm_fp8 as j_nm_fp8
from repro.kernels.nm_spmm.kernel import nm_spmm_int8 as j_nm_int8
from repro.kernels.nm_spmm_gather import kernel as jg
from repro.kernels.tile_gemm.kernel import tile_gemm_fp8 as j_tile_fp8
from repro.kernels.tile_gemm.kernel import tile_gemm_int8 as j_tile_int8
from repro.models import init_params
from repro.models import paged as jpaged
from repro_torch import kernels
from repro_torch.core import quantize as tquant
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.core.sparse_linear import convert_layout
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.actsparse import block_maps
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm import kernel as tn
from repro_torch.kernels.nm_spmm_gather import kernel as tg
from repro_torch.kernels.reasons import ReasonCode
from repro_torch.kernels.tile_gemm import kernel as tt
from repro_torch.kernels.tile_gemm.ref import zero_dead_tiles
from repro_torch.models import paged as tpaged
from torch_parity import port_config, port_params

FP8 = torch.float8_e4m3fn
QDT = {"int8": (torch.int8, jnp.int32, "int8"), "fp8": (FP8, jnp.float32, "float8_e4m3fn")}
B, K, O = 8, 256, 128
LAYOUTS = [("dense", 4), ("compressed", 2), ("compressed", 1), ("gather", 2), ("gather", 1)]


def _j(*tensors):
    """torch -> jnp, e4m3 through its byte view (bit-exact)."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
        elif t.dtype == FP8:
            out.append(jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


def _to_torch(a, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if dtype == FP8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(FP8)
    return torch.from_numpy(a.copy())


def _case(layout, n, qdtype, seed=0):
    """Quantized rows (an idle zero row included) and one leaf of
    ``layout`` made by the port's ``convert_layout`` (bitwise the JAX
    package's, tests/test_torch_quantize.py and test_torch_gather.py)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    x[-1] = 0.0
    w = torch.from_numpy(rng.standard_normal((K, O)).astype(np.float32) * K ** -0.5)
    mode = "gather" if layout == "gather" else "compressed"
    leaf = convert_layout({"w": w}, TSp(n=n, m=4, mode=mode), layout if n < 4 else "dense",
                          quantize=qdtype)
    xq, xs = tquant.quantize_rows(x, QDT[qdtype][0])
    bias = torch.from_numpy(rng.standard_normal(O).astype(np.float32) * 0.1)
    return xq, xs, leaf, bias


def _ops(layout, leaf):
    if layout == "dense":
        return (leaf["w"],)
    return (leaf["values"], leaf["meta_packed" if layout == "compressed" else "gather_idx"])


def _pallas(layout, n, qdtype, xq, xs, leaf, spec, bias, rq):
    """The JAX package's Pallas kernel of the layout and class, interpret
    mode, on the same operands."""
    jspec = jepi.EpilogueSpec(act=spec.act, bias=spec.bias,
                              requant=None if rq is None else QDT[qdtype][2])
    kw = dict(interpret=True, epilogue=jspec, out_dtype=jnp.float32,
              bias=None if bias is None else jnp.asarray(bias.numpy()),
              requant_scale=None if rq is None else jnp.asarray(rq.numpy()))
    ws = leaf["scale"].reshape(1, -1)
    if layout == "dense":
        fn = j_tile_int8 if qdtype == "int8" else j_tile_fp8
        return fn(*_j(xq, leaf["w"], xs, ws), **kw)
    if layout == "compressed":
        fn = j_nm_int8 if qdtype == "int8" else j_nm_fp8
        xj, vj, mj, xsj, wsj = _j(xq, leaf["values"], leaf["meta_packed"], xs, ws)
        return fn(xj, vj, mj, xsj, wsj, n, **kw)
    xj, vj, ij, xsj, wsj = _j(xq, leaf["values"], leaf["gather_idx"], xs, ws)
    return jg.nm_spmm_gather_bk(xj, vj, ij.reshape(-1, 1), n, xsj, wsj,
                                acc_dtype=QDT[qdtype][1], **kw)


KERNELS = {"dense": (tt, "tile_gemm"), "compressed": (tn, "nm_spmm"),
           "gather": (tg, "nm_spmm_gather_bk")}


def _port(layout, qdtype, requant=False, masked=False):
    """The port's wrapper: ``<kernel>[_masked]_<class>[_requant]``."""
    mod, base = KERNELS[layout]
    return getattr(mod, f"{base}{'_masked' if masked else ''}_{qdtype}"
                        f"{'_requant' if requant else ''}")


def _steps_off(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|difference| in codes: int8 values, or e4m3 steps (codes of one sign
    ordered by their low 7 bits)."""
    def ordinal(t):
        if t.dtype == torch.int8:
            return t.int()
        b = t.view(torch.uint8).int()
        return torch.where(b >= 128, -(b - 128), b)
    return (ordinal(got) - ordinal(want)).abs()


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("layout,n", LAYOUTS)
@pytest.mark.parametrize("bias", [False, True])
def test_requant_single_codes_match_pallas(qdtype, layout, n, bias):
    xq, xs, leaf, bv = _case(layout, n, qdtype, seed=n + 3 * bias)
    bv = bv if bias else None
    spec = EpilogueSpec(act="gelu", bias=bias)
    nn = () if layout == "dense" else (n,)
    ws = leaf["scale"].reshape(1, -1)
    # the float rows the flush requantizes, and a scale that saturates a
    # share of the codes (as a calibrated one may)
    y = _port(layout, qdtype)(xq, *_ops(layout, leaf), xs, ws, *nn, epilogue=spec, bias=bv)
    rq = (y.abs().amax() / (200.0 if qdtype == "int8" else 600.0)).reshape(())
    fn = _port(layout, qdtype, True)
    before = fn.launches
    got = fn(xq, *_ops(layout, leaf), xs, ws, *nn, rq, epilogue=spec, bias=bv)
    assert fn.launches == before        # CPU tensors: the plain version, no launch
    want = _to_torch(_pallas(layout, n, qdtype, xq, xs, leaf, spec, bv, rq), QDT[qdtype][0])
    assert got.dtype == want.dtype == QDT[qdtype][0] and got.shape == (B, O)
    off = _steps_off(got, want)
    assert int(off.max()) <= 1 and float((off == 1).float().mean()) <= 1e-3
    qmax = 127.0 if qdtype == "int8" else 448.0
    assert (got.float().abs() == qmax).any()          # the scale saturates some codes
    # the masked kernel with the same flush, on rows with dead tiles: the
    # codes of the unmasked requant kernel on the same rows
    step = 256 // n if layout == "gather" else 64
    live = torch.from_numpy(np.random.default_rng(7).random((1, K // step)) < 0.5).int()
    xm = zero_dead_tiles(xq, live, 16, step)
    got_m = _port(layout, qdtype, masked=True)(xm, *_ops(layout, leaf), *block_maps(xm, 16, step),
                                               *nn, xs, ws, epilogue=spec, bias=bv,
                                               requant_scale=rq)
    want_m = _port(layout, qdtype, True)(xm, *_ops(layout, leaf), xs, ws, *nn, rq,
                                         epilogue=spec, bias=bv)
    assert got_m.dtype == want_m.dtype and int(_steps_off(got_m, want_m).max()) == 0


def test_requant_wrappers_refuse_what_the_kernels_do_not_take():
    xq, xs, leaf, _ = _case("dense", 4, "int8")
    ws, rq = leaf["scale"].reshape(1, -1), torch.tensor(0.05)
    with pytest.raises(ValueError, match="requant_scale"):     # the plain single
        tt.tile_gemm_int8(xq, leaf["w"], xs, ws, epilogue=EpilogueSpec(act="gelu",
                                                                       requant="int8"))
    with pytest.raises(ValueError, match="requantizes to int8 only"):
        tt.tile_gemm_int8_requant(xq, leaf["w"], xs, ws, rq,
                                  epilogue=EpilogueSpec(requant="float8_e4m3fn"))
    with pytest.raises(ValueError, match="one float32 value"):
        tt.tile_gemm_int8_requant(xq, leaf["w"], xs, ws, torch.ones(2))
    with pytest.raises(ValueError, match="raw accumulator"):
        tt.tile_gemm_int8_requant(xq, leaf["w"], None, None, rq)
    with pytest.raises(ValueError, match="requant_scale"):     # the float kernels
        tt.tile_gemm(xq.float(), leaf["w"].float(), epilogue=EpilogueSpec(requant="int8"))
    # the int8 class stores int8 codes; fp8 e4m3 ones
    out = tt.tile_gemm_int8_requant(xq, leaf["w"], xs, ws, rq, epilogue=EpilogueSpec("gelu"))
    assert out.dtype == torch.int8


# ------------------------------------------------------------------ dispatch
def _mlp_w_out(layout, n, qdtype, seed):
    """A gelu MLP's ``w_out`` (K = d_ff = 256, O = d_model = 128) quantized
    by both packages, with and without a static scale."""
    w = np.random.default_rng(seed).standard_normal((256, 128)).astype(np.float32) / 16
    mode = "gather" if layout == "gather" else "compressed"
    jcfg = JSp(n=n, m=4, mode=mode)
    target = layout if n < 4 else "dense"
    jq = j_convert({"w": jnp.asarray(w)}, jcfg, target, quantize=qdtype)
    jf = j_convert({"w": jnp.asarray(w)}, jcfg, target)
    return jcfg, TSp(n=n, m=4, mode=mode), jq, port_params(jq), jf, port_params(jf)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("layout,n", [("dense", 4), ("compressed", 2), ("gather", 2)])
def test_requant_decision_for_a_gelu_consumer_matches_reference(qdtype, layout, n,
                                                                monkeypatch):
    monkeypatch.setenv("REPRO_FP8_NATIVE", "1")
    jcfg, tcfg, jq, tq, jf, tf = _mlp_w_out(layout, n, qdtype, 0)
    s = np.float32(0.03)
    jstat, tstat = {**jq, "act_scale": jnp.asarray(s)}, {**tq, "act_scale": torch.tensor(s)}
    cases = [(jf, tf, "interpret", ReasonCode.REQUANT_NO_QUANT),
             (jq, tq, "interpret", ReasonCode.REQUANT_DYNAMIC_SCALES),
             (jstat, tstat, "interpret", ReasonCode.REQUANT_FUSED),
             (jstat, tstat, "jnp", ReasonCode.REQUANT_CONSUMER_FALLBACK)]
    for batch in ((8,), (2, 6)):
        for jleaf, tleaf, jb, code in cases:
            jres, jcode = jd.requant_decision(jleaf, batch, jcfg,
                                              dispatch=jd.DispatchConfig(backend=jb))
            tres, tcode = td.requant_decision(
                tleaf, batch, tcfg,
                dispatch=td.DispatchConfig(backend={"interpret": "cuda", "jnp": "torch"}[jb]))
            assert tcode is code and tcode.value == jcode.value, (batch, jb)
            assert (tres is None) == (jres is None)
            if tres is not None:
                assert tres[0] == jres[0] == QDT[qdtype][2]
                assert float(tres[1]) == float(jres[1]) == float(s)


def test_gelu_w_in_requantizes_and_w_out_takes_the_narrow_rows():
    """``apply_mlp`` with act="gelu" on the cuda tier: w_in runs
    ``*_requant`` (int8 out), w_out contracts those rows; the result
    equals the unfused path's (the same codes either way)."""
    from repro_torch.models.layers import apply_mlp
    _, tcfg, _, wo, _, _ = _mlp_w_out("compressed", 2, "int8", 1)
    rng = np.random.default_rng(2)
    w_in = convert_layout({"w": torch.from_numpy(rng.standard_normal((128, 256))
                                                 .astype(np.float32) / 12)},
                          tcfg, "compressed", quantize="int8")
    x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    p = {"w_in": {**w_in, "act_scale": torch.tensor(np.float32(0.03))},
         "w_out": {**wo, "act_scale": torch.tensor(np.float32(0.02))}}
    fed, calls = [], []
    real_mm, real_rq = td.sparse_matmul, tn.nm_spmm_int8_requant
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(td, "sparse_matmul", lambda xx, *a, **k: fed.append(xx.dtype)
                   or real_mm(xx, *a, **k))
        mp.setattr(tn, "nm_spmm_int8_requant", lambda *a, **k: calls.append(1)
                   or real_rq(*a, **k))
        with td.use_dispatch(backend="cuda"):
            got = apply_mlp(p, x, "gelu", tcfg)
    assert fed == [torch.float32, torch.int8] and calls == [1]
    with td.use_dispatch(backend="cuda"):
        h = td.sparse_matmul(x, p["w_in"], tcfg, epilogue=td.epilib.make(act="gelu"))
        want = td.sparse_matmul(h, p["w_out"], tcfg).to(x.dtype)
    assert torch.equal(got, want)


# --------------------------------------------------------- the MoE repair
BLOCK_LEN = 8


def _paged_moe(p, mod, params, cfg, asarray):
    """One prefill chunk of 6 tokens, then one decode step."""
    caches = (jpaged.init_paged_caches(cfg, 3, BLOCK_LEN, 1) if p == "jax"
              else tpaged.init_paged_caches(cfg, 3, BLOCK_LEN))
    table = asarray(np.array([[1, 2]], np.int32))
    tok = asarray(np.array([[3, 17, 9, 41, 5, 28]]))
    args = (tok, 0, table, 6) if p == "torch" else (tok, jnp.int32(0), table, jnp.int32(6),
                                                     jnp.int32(0))
    lp, caches = mod.paged_prefill_chunk(params, caches, *args, cfg, BLOCK_LEN)
    ld, _ = mod.paged_decode_step(params, caches, asarray(np.array([[42]])),
                                  asarray(np.array([6])), table,
                                  asarray(np.array([True])), cfg, BLOCK_LEN)
    return [np.asarray(lp[0], np.float32), np.asarray(ld[:, 0], np.float32)]


@pytest.mark.parametrize("path", ["gather", "spgemm"])
def test_gelu_moe_static_int8_matches_the_int8_pallas_kernels(path, monkeypatch):
    """The gelu expert FFN requantizes its w_in against w_out's static
    scale, as the JAX package's ``_expert_ffn`` decides, on both expert
    paths; fp32 logits within 2e-3 of the Pallas int8 kernels'."""
    spec_kw = dict(layout="compressed", sparsity=(2, 4), qdtype="int8", static_scales=True)
    jcfg = jserving.ServingSpec(**spec_kw).apply_to(dataclasses.replace(
        get_smoke_config("qwen3_moe_235b_a22b"), dtype="float32", act="gelu", d_ff=128,
        num_experts=4, num_heads=2, num_kv_heads=1, head_dim=64, num_layers=1,
        moe_expert_path=path, name=f"moe-gelu-static-{path}"))
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    calib = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jq = jserving.prepare(jp, jserving.ServingSpec(**spec_kw), cfg=jcfg,
                              calib_tokens=jnp.asarray(calib)).params
    tcfg, tq = port_config(jcfg), port_params(jq)
    rq_name = "nm_spmm_masked_int8" if path == "spgemm" else "nm_spmm_int8_requant"
    rq_calls, fed = [], []
    real = getattr(kernels._nm_spmm, rq_name)
    monkeypatch.setattr(kernels._nm_spmm, rq_name, lambda *a, **k: rq_calls.append(
        "requant_scale" in k or rq_name.endswith("_requant")) or real(*a, **k))
    real_mm = td.sparse_matmul
    monkeypatch.setattr(td, "sparse_matmul", lambda x, *a, **k:
                        fed.append((x.dtype, x.shape[-1])) or real_mm(x, *a, **k))
    with jd.use_dispatch(backend="interpret"):
        want = _paged_moe("jax", jpaged, jq, jcfg, jnp.asarray)
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = _paged_moe("torch", tpaged, tq, tcfg, lambda a: torch.from_numpy(np.array(a)))
    # every expert's w_in requantized: 2 calls (prefill, decode) x 4 experts
    assert sum(rq_calls) == 2 * jcfg.num_experts
    narrow = [k for dt, k in fed if dt == torch.int8]
    assert len(narrow) == 2 * jcfg.num_experts and set(narrow) == {jcfg.d_ff}
    for g, w in zip(got, want):
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err <= 2e-3, err
