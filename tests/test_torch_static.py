"""Static activation scales in the port against the JAX package.

- ``quantize_rows_static`` and ``requant_rows``: int8 codes bitwise
  equal to the JAX package's, including +-qmax saturation and exact .5
  ties (int8 rounds half to even in both).
- Calibration: the JAX package's ``serving.prepare(static_scales=True)``
  on its jnp tier and the port's ``prepare`` on its torch tier, from the
  same params and calibration tokens: the same number of calibrated sites
  (one per stacked leaf of a slot, 7 for the dense family), every layer
  of a slot carrying the same scale, and each scale within 1e-6 relative
  in fp32 (summation order over two layers) and 2e-2 in bf16 (bf16
  roundings of every activation, in other places in the two packages).
  On the kernel tiers (JAX interpret, the port's cuda tier on CPU
  tensors: the kernels' plain versions, flash_attention included) the
  calibration runs w8a8 with dynamic scales and is held to 2e-2.
- ``requant_decision``: the same reason codes as the JAX package's
  (fused, dynamic scales, no quantized consumer, consumer fallback) and
  the same fused scale.
- The static path on the kernel tiers: the port's cuda tier (plain
  versions on CPU tensors; the gate-up duals requantize in their flush
  and w_out contracts the int8 rows) against the JAX interpret tier (the
  Pallas int8 kernels with the fused requant), both on the JAX-calibrated
  params, over paged prefill and decode: fp32 <= 2e-3 scaled, as for the
  dynamic w8a8 path (tests/test_torch_model.py; measured here <= 4e-7:
  the same codes everywhere); bf16 <= 5e-2 (measured 2.2e-2 to 3.4e-2 on
  this head_dim-64 config: bf16 roundings of every activation in other
  places, each flip of a code moving its products by the per-tensor
  static scale, coarser than a per-row one).
- End to end: the JAX CLI writes a 2:4 int8 ``--static-scales``
  artifact from ``tests/fixtures/hf_tiny``; the JAX engine on its jnp
  tier and the port's engine on its torch tier serve the same token
  streams up to the one exact bf16 tie that ``test_torch_artifact.py``
  records for the same weights and trace.

The requantizing int8 duals are held to their plain versions on the card
by the ``cuda`` tests of ``tests/test_torch_kernels.py``.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.core import quantize as jquant
from repro.kernels import dispatch as jd
from repro.kernels import epilogue as jepi
from repro.launch import convert as convert_cli
from repro.models import init_params
from repro.models import paged as jpaged
from repro_torch import kernels
from repro_torch import serving as tserving
from repro_torch.core import quantize as tquant
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels.reasons import ReasonCode
from repro_torch.models import paged as tpaged
from torch_parity import assert_scaled_close, from_np, jnp_dtype, port_config, port_params

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "hf_tiny"
LAYOUTS = {"dense": JSp(mode="dense"), "2:4": JSp(n=2, m=4, mode="compressed")}
SITES = (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
         ("ffn", "w_in"), ("ffn", "w_gate"), ("ffn", "w_out"))
_jit_init = jax.jit(init_params, static_argnums=1)


def _codes_inputs():
    """Rows with exact .5 ties, values beyond +-qmax, a zero row and
    random values, against a power-of-two scale (every x / scale exact)."""
    rng = np.random.default_rng(0)
    scale = np.float32(2.0 ** -6)
    x = (rng.standard_normal((6, 64)) * 2).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]) * scale
    x[1, :6] = np.array([127.5, 128.0, 200.0, -127.5, -128.5, -1000.0]) * scale
    x[2] = 0.0
    return x, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_static_codes_are_bitwise_the_reference(dtype):
    x, scale = _codes_inputs()
    jq, js = jquant.quantize_rows_static(jnp.asarray(x).astype(jnp_dtype(dtype)),
                                         jnp.asarray(scale), jnp.int8)
    tq, ts = tquant.quantize_rows_static(from_np(x, dtype), torch.tensor(scale), torch.int8)
    assert tq.dtype == torch.int8 and ts.shape == (6, 1) and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert {127, -127} <= set(tq[1].tolist()) and (tq[2] == 0).all()
    # an arbitrary scale: the same division, the same rounding
    jq, _ = jquant.quantize_rows_static(jnp.asarray(x), jnp.asarray(np.float32(0.0371)))
    tq, _ = tquant.quantize_rows_static(torch.from_numpy(x), torch.tensor(np.float32(0.0371)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("scale", [2.0 ** -6, 0.0371])
def test_requant_rows_codes_are_bitwise_the_reference(scale):
    x, _ = _codes_inputs()
    s = np.float32(scale)
    want = jepi.requant_rows(jnp.asarray(x), jnp.asarray(s), "int8")
    got = tepi.requant_rows(torch.from_numpy(x), torch.tensor(s), "int8")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the lattice point through flush_tile and apply_reference
    spec = tepi.EpilogueSpec(act="silu", requant="int8")
    np.testing.assert_array_equal(
        tepi.flush_tile(torch.from_numpy(x), spec, torch.float32,
                        rq_scale=torch.tensor(s)).numpy(),
        np.asarray(jepi.flush_tile(jnp.asarray(x), jepi.EpilogueSpec(act="silu",
                                                                     requant="int8"),
                                   jnp.float32, rq_scale=jnp.asarray(s))))
    epi = tepi.make(act="silu", requant="int8", requant_scale=torch.tensor(s))
    assert tepi.apply_reference(torch.from_numpy(x), epi).dtype == torch.float32
    assert tepi.apply_reference(torch.from_numpy(x), epi, requantize=True).dtype == torch.int8


def _spec_kw(sp):
    return dict(layout=sp.mode, sparsity=None if sp.n == 4 else (sp.n, 4), qdtype="int8",
                static_scales=True)


def _scales(jprep, tprep):
    """Per site: the JAX stacked leaf's scales and the port's per-layer ones."""
    out = {}
    for grp, name in SITES:
        j = np.asarray(jprep.params["stages"][0]["slot0"][grp][name]["act_scale"])
        t = [float(layer[grp][name]["act_scale"]) for layer in tprep.params["layers"]]
        out[grp, name] = (j.reshape(-1), np.array(t))
    return out


WIDE = dict(d_model=128, num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256)


# (JAX backend, port backend, dtype, relative tolerance, config overrides)
CALIB_CASES = [
    ("jnp", "torch", "float32", 1e-6, {}),
    ("jnp", "torch", "bfloat16", 2e-2, {}),
    ("interpret", "cuda", "bfloat16", 2e-2, WIDE),
]


@pytest.mark.parametrize("jb,tb,dtype,rtol,over", CALIB_CASES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_calibrated_scales_match_the_reference(layout, jb, tb, dtype, rtol, over,
                                               monkeypatch):
    sp = LAYOUTS[layout]
    jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype=dtype, sparsity=sp,
                               name=f"calib-{layout}-{dtype}-{jb}", **over)
    jp = _jit_init(jax.random.PRNGKey(0), jcfg)
    calib = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend=jb):
        jprep = jserving.prepare(jp, jserving.ServingSpec(**_spec_kw(sp)), cfg=jcfg,
                                 calib_tokens=jnp.asarray(calib))
    flash = []
    real = kernels._flash_attention.flash_attention
    monkeypatch.setattr(kernels._flash_attention, "flash_attention",
                        lambda *a, **k: flash.append(1) or real(*a, **k))
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**_spec_kw(sp), backend=tb),
                             cfg=port_config(jcfg), calib_tokens=torch.from_numpy(calib),
                             device="cpu")
    assert tprep.calibrated_sites == jprep.calibrated_sites == len(SITES)
    # the flash_attention wrapper runs on the cuda tier (head_dim 64 fits)
    assert bool(flash) == (tb == "cuda")
    for site, (j, t) in _scales(jprep, tprep).items():
        assert len(t) == jcfg.num_layers and (t == t[0]).all(), site
        assert (j == j[0]).all(), site
        assert abs(t[0] - j[0]) <= rtol * j[0], (site, t[0], j[0])
    # every site that plans an int8 kernel now plans act-scales=static
    lines = td.dispatch_report(tprep.params, (2, 16), tprep.sp_cfg,
                               dispatch=td.DispatchConfig(backend="cuda"))
    assert any("act-scales=static" in ln for ln in lines)
    assert not any("act-scales=dynamic" in ln for ln in lines)


def _q_leaf(k, o, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, o)).astype(np.float32) * k ** -0.5
    jcfg = JSp(mode="dense") if n == 4 else JSp(n=n, m=4, mode="compressed")
    from repro.core.sparse_linear import convert_layout as j_convert
    jleaf = j_convert({"w": jnp.asarray(w)}, jcfg, jcfg.mode, quantize="int8")
    return jcfg, jleaf, TSp(n=jcfg.n, m=4, mode=jcfg.mode), port_params(jleaf)


@pytest.mark.parametrize("n", [4, 2])
def test_requant_decision_reason_codes_match_the_reference(n):
    jcfg, jq, tcfg, tq = _q_leaf(128, 128, n, 0)
    s = np.float32(0.05)
    jstat = {**jq, "act_scale": jnp.asarray(s)}
    tstat = {**tq, "act_scale": torch.tensor(s)}
    from repro.core.sparse_linear import convert_layout as j_convert
    w = np.random.default_rng(1).standard_normal((128, 128)).astype(np.float32)
    jfloat = j_convert({"w": jnp.asarray(w)}, jcfg, jcfg.mode)
    tfloat = port_params(jfloat)
    cases = [(jfloat, tfloat, "interpret", ReasonCode.REQUANT_NO_QUANT),
             (jq, tq, "interpret", ReasonCode.REQUANT_DYNAMIC_SCALES),
             (jstat, tstat, "interpret", ReasonCode.REQUANT_FUSED),
             (jstat, tstat, "jnp", ReasonCode.REQUANT_CONSUMER_FALLBACK)]
    for jleaf, tleaf, jb, code in cases:
        jres, jcode = jd.requant_decision(jleaf, (8,), jcfg,
                                          dispatch=jd.DispatchConfig(backend=jb))
        tres, tcode = td.requant_decision(
            tleaf, (8,), tcfg, dispatch=td.DispatchConfig(backend={"interpret": "cuda",
                                                                   "jnp": "torch"}[jb]))
        assert tcode is code and tcode.value == jcode.value
        assert (tres is None) == (jres is None)
        if tres is not None:
            assert tres[0] == jres[0] == "int8"
            assert float(tres[1]) == float(jres[1]) == float(s)
    assert td.requant_plan(tstat, (8,), tcfg,
                           dispatch=td.DispatchConfig(backend="cuda"))[0] == "int8"


def test_narrow_rows_are_contracted_as_they_are():
    """A w_out fed int8 rows: the kernel tier contracts them with the
    rebuilt (B, 1) scales and returns fp32; the torch tier dequantizes
    them first; with no act_scale they are refused."""
    _, _, tcfg, tq = _q_leaf(128, 64, 2, 2)
    s = torch.tensor(np.float32(0.03))
    leaf = {**tq, "act_scale": s}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32))
    xq, _ = tquant.quantize_rows_static(x, s)
    with td.use_dispatch(backend="cuda"):
        from_narrow = td.sparse_matmul(xq, leaf, tcfg)
        from_float = td.sparse_matmul(x, leaf, tcfg)
    assert from_narrow.dtype == torch.float32
    assert torch.equal(from_narrow, from_float)       # the same codes either way
    with td.use_dispatch(backend="torch"):
        ref = td.sparse_matmul(xq.float() * s, leaf, tcfg)
        assert torch.equal(td.sparse_matmul(xq, leaf, tcfg), ref)
    with pytest.raises(ValueError, match="act_scale"):
        td.sparse_matmul(xq, tq, tcfg, dispatch=td.DispatchConfig(backend="cuda"))


def test_static_scales_refuse_fp8_leaves_and_need_calibration_data():
    """Static scales over fp8 leaves are the fp8 class's own: an fp8 site
    calibrates to absmax / 448 (the leaf's own qmax), an int8 site in the
    same tree to absmax / 127, both as the JAX package's calibration
    gives them (tests/test_fp8.py); int8 leaves without scales still need
    ``cfg`` and ``calib_tokens``."""
    w = np.random.default_rng(4).standard_normal((128, 64)).astype(np.float32) * 128 ** -0.5
    x0 = np.random.default_rng(5).standard_normal((4, 128)).astype(np.float32)
    jcfg = JSp(n=2, m=4, mode="compressed")
    from repro.core.sparse_linear import convert_layout as j_convert
    jtree = {name: {"w_in": j_convert({"w": jnp.asarray(w)}, jcfg, "compressed", quantize=qd)}
             for name, qd in (("i8", "int8"), ("f8", "fp8"))}
    ttree = port_params(jtree)
    tcfg = TSp(n=2, m=4, mode="compressed")

    def jbatch(p):
        with jd.use_dispatch(backend="jnp"):
            return sum(j_apply(p[k]["w_in"], jnp.asarray(x0), jcfg) for k in ("i8", "f8"))

    def tbatch(p):
        with td.use_dispatch(backend="torch"):
            return sum(td.sparse_matmul(torch.from_numpy(x0), p[k]["w_in"], tcfg)
                       for k in ("i8", "f8"))

    from repro.core import apply_linear as j_apply
    jcal, jn = jquant._calibrate_activation_scales(jtree, jbatch)
    tcal, tn = tquant._calibrate_activation_scales(ttree, tbatch)
    assert tn == jn == 2
    absmax = float(np.abs(x0).max())
    for key, qmax in (("i8", 127.0), ("f8", 448.0)):
        t = float(tcal[key]["w_in"]["act_scale"])
        assert t == float(jcal[key]["w_in"]["act_scale"])
        assert abs(t - absmax / qmax) <= 1e-6 * t
    d = td.plan_for(tcal["f8"]["w_in"], (4, 128), tcfg, dispatch=td.DispatchConfig(backend="cuda"))
    assert d.kernel == "nm_spmm_fp8" and d.act_scales == "static"
    assert tserving.ServingSpec(qdtype="fp8", static_scales=True).static_scales
    _, _, _, tq = _q_leaf(128, 64, 2, 4)
    spec = tserving.ServingSpec(layout="compressed", sparsity=(2, 4), qdtype="int8",
                                static_scales=True)
    with pytest.raises(ValueError, match="calib_tokens"):
        tserving.prepare(tq, spec, device="cpu")
    with pytest.raises(ValueError, match="requires qdtype"):
        tserving.ServingSpec(static_scales=True)


BLOCK_LEN, WIDTH, CHUNK = 8, 4, 6
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])
DECODE_FEED = ([42, 7], [99, 0])


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _run_paged(p, mod, params, cfg, caches, asarray):
    """Prefill both prompts in chunks, then two batched decode steps fed
    fixed tokens; every call's logits as float32 numpy."""
    outs = []
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for s, prompt in enumerate(PROMPTS):
        for off in range(0, len(prompt), CHUNK):
            c = min(CHUNK, len(prompt) - off)
            tok = asarray(np.array([prompt[off:off + c]]))
            args = (tok, off, asarray(table[s:s + 1]), c) if p == "torch" else (
                tok, jnp.int32(off), asarray(table[s:s + 1]), jnp.int32(c), jnp.int32(s))
            logits, caches = mod.paged_prefill_chunk(params, caches, *args, cfg, BLOCK_LEN)
            outs.append(_f32(logits[0, :c]))
    pos = np.array([len(q) for q in PROMPTS])
    for feed, active in zip(DECODE_FEED, ([True, True], [True, False])):
        logits, caches = mod.paged_decode_step(
            params, caches, asarray(np.array(feed)[:, None]), asarray(pos),
            asarray(np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)),
            asarray(np.array(active)), cfg, BLOCK_LEN)
        outs.append(_f32(logits[:, 0]))
        pos = pos + np.array(active)
    return outs


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_static_w8a8_logits_match_the_int8_pallas_kernels(layout, dtype, tol, monkeypatch):
    sp = LAYOUTS[layout]
    jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype=dtype, sparsity=sp,
                               name=f"static-{layout}-{dtype}", **WIDE)
    calib = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jq = jserving.prepare(_jit_init(jax.random.PRNGKey(0), jcfg),
                              jserving.ServingSpec(**_spec_kw(sp)), cfg=jcfg,
                              calib_tokens=jnp.asarray(calib)).params
    tcfg, tq = port_config(jcfg), port_params(jq)
    lines = td.dispatch_report(tq, (2, CHUNK), tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    assert lines and all("_int8[cuda]" in ln and "act-scales=static" in ln for ln in lines)
    calls = []
    for mod, name in ((kernels._tile_gemm, "tile_gemm_int8"),
                      (kernels._tile_gemm, "tile_gemm_dual_int8"),
                      (kernels._tile_gemm, "tile_gemm_dual_int8_requant"),
                      (kernels._nm_spmm, "nm_spmm_int8"),
                      (kernels._nm_spmm, "nm_spmm_dual_int8"),
                      (kernels._nm_spmm, "nm_spmm_dual_int8_requant")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    fed = []      # (dtype, K) of the activations each linear receives
    real_mm = td.sparse_matmul
    monkeypatch.setattr(td, "sparse_matmul", lambda x, *a, **k:
                        fed.append((x.dtype, x.shape[-1])) or real_mm(x, *a, **k))
    nb = 2 * WIDTH + 1
    with jd.use_dispatch(backend="interpret"):
        want = _run_paged("jax", jpaged, jq, jcfg,
                          jpaged.init_paged_caches(jcfg, nb, BLOCK_LEN, 2), jnp.asarray)
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = _run_paged("torch", tpaged, tq, tcfg, tpaged.init_paged_caches(tcfg, nb, BLOCK_LEN),
                         lambda a: torch.from_numpy(np.array(a)))
    kind = "tile_gemm" if layout == "dense" else "nm_spmm"
    # every gate-up requantizes in its flush; the float-output dual never runs
    assert set(calls) == {f"{kind}_int8", f"{kind}_dual_int8_requant"}
    # w_out (and only w_out, K = d_ff) receives int8 rows: one per dual
    narrow = [k for dt, k in fed if dt == torch.int8]
    assert set(narrow) == {jcfg.d_ff}
    assert len(narrow) == calls.count(f"{kind}_dual_int8_requant") > 0
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_scaled_close(g, w, tol)


@pytest.fixture(scope="module")
def static_artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("static") / "art"
    rc = convert_cli.main(["--input", str(FIXTURE), "--output", str(out),
                           "--arch", "internlm2_1_8b", "--smoke", "--mode", "compressed",
                           "--sparsity", "2:4", "--quantize", "int8", "--static-scales"])
    assert rc == 0
    return out


TRACE_KW = dict(seed=0, num_requests=4, rate=1.0)
# the one exact bf16 tie of these weights and this trace (request 0, 7th
# generated token: tokens 103 and 152), see tests/test_torch_artifact.py
TIES = {"0": (6, (103, 152))}


def _tokens(engine_cls, prepared, trace):
    return {str(s.rid): [int(t) for t in s.tokens]
            for s in engine_cls(prepared).run(trace).stats}


def test_port_serves_the_static_scales_artifact_like_the_reference(static_artifact):
    with jd.use_dispatch(backend="jnp"):
        jprep = jserving.prepare_from_artifact(static_artifact)
        want = _tokens(jserving.Engine, jprep, jserving.make_poisson_trace(
            vocab_size=jprep.cfg.vocab_size, **TRACE_KW))
    tprep = tserving.prepare_from_artifact(static_artifact, backend="torch", device="cpu")
    assert tprep.spec.static_scales and tprep.spec.qdtype == "int8"
    assert tprep.calibrated_sites == jprep.calibrated_sites == len(SITES)
    for layer in tprep.params["layers"]:
        for grp, name in SITES:
            leaf = layer[grp][name]
            assert leaf["act_scale"].shape == () and "calib_id" not in leaf
    got = _tokens(tserving.Engine, tprep, tserving.make_poisson_trace(
        vocab_size=tprep.cfg.vocab_size, **TRACE_KW))
    assert sorted(got) == sorted(want)
    for rid, toks in want.items():
        at, pair = TIES.get(rid, (len(toks), ()))
        assert got[rid][:at] == toks[:at], rid
        if rid in TIES:
            assert toks[at] == min(pair) and got[rid][at] in pair
            assert len(got[rid]) == len(toks)


def test_static_artifact_serves_on_the_cuda_tier_on_cpu(static_artifact, monkeypatch):
    """The same artifact through the kernel tier's plain versions: every
    site on a kernel plans act-scales=static and every gate-up
    requantizes."""
    tprep = tserving.prepare_from_artifact(static_artifact, backend="cuda", device="cpu")
    for ln in tprep.dispatch_report():
        assert "act-scales=static" in ln or "torch-reference" in ln
    rq_dual = []
    real = kernels._nm_spmm.nm_spmm_dual_int8_requant
    monkeypatch.setattr(kernels._nm_spmm, "nm_spmm_dual_int8_requant",
                        lambda *a, **k: rq_dual.append(1) or real(*a, **k))
    rep = tserving.Engine(tprep).run(tserving.make_poisson_trace(
        vocab_size=tprep.cfg.vocab_size, **TRACE_KW))
    assert rep.completed == 4 and rq_dual
