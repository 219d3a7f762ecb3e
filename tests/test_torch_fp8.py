"""The port's fp8 (float8_e4m3fn) execution class against the JAX package.

- Kernels: each fp8 wrapper, handed CPU tensors, runs its plain version
  (``x_q.float() @ w.float()`` in fp32, N:M decompressed first, then
  ``* x_scale * w_scale``, the epilogue, one cast); that is held to the
  JAX package's Pallas fp8 kernel in interpret mode on the same
  numpy-seeded codes: raw fp32 accumulators and fp32 outputs within 1e-5
  of max|reference| (every product of two e4m3 values is exact in fp32,
  so only the summation order differs), bf16 outputs within 1e-2 (one
  bf16 rounding, in other places), requantized e4m3 codes equal as
  bytes.
- ``requant_rows`` / ``flush_tile`` give the JAX package's e4m3 codes:
  clip to +-448, no rounding step, the round-to-nearest-even cast.
- Planning: the fp8 cases of tests/test_fp8.py that do not depend on the
  backend (the dtype axis, the stricter tiling, the native-dot gate,
  requant reason codes) give the JAX package's kernels, reason codes and
  report lines (``interpret`` -> ``cuda``, ``tpu`` -> ``cuda`` on a CUDA
  device, blocks aside).
- ``prepare(qdtype="fp8", static_scales=True)``: the same 7 calibrated
  sites as the JAX package's ``prepare``, every scale within 1e-6
  relative (fp32; absmax / 448).
- Model: the smoke config widened to d_model 128 / head_dim 32 (so that
  the TPU fp8 kernels tile 1:4 too), prefill and decode logits of the
  port's cuda tier (the fp8 kernels' plain versions, on CPU tensors)
  against the JAX interpret tier (the Pallas fp8 kernels), dynamic and
  static scales, dense and 2:4, fp32 config: <= 2e-3 scaled, as for
  int8 (tests/test_torch_model.py): the codes agree until a one-ulp
  difference upstream (rope, softmax, summation order) moves one
  activation across an e4m3 rounding boundary; measured <= 3.2e-6 (no
  code moved).  The bf16 config is not compared here: there the two
  packages round activations to bf16 in different places, a bf16 ulp
  (2^-8 relative) moves an e4m3 code (steps of 2^-3) on about one
  activation in 32, and the logits differ by 3.3e-2 to 7.8e-2 (measured
  on this config), noise that would hide a fault as small as that.
- End to end: the JAX CLI writes a 2:4/fp8 artifact of
  ``tests/fixtures/hf_tiny``; the port's torch tier serves the JAX jnp
  tier's token streams on it, up to one exact bf16 tie in the JAX logits
  (request 0, 8th generated token: tokens 103 and 152, both 2.5625),
  which the port breaks the other way.

The CUDA kernels themselves are held to their plain versions on the card
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
from repro.kernels import dispatch as jd
from repro.kernels import epilogue as jepi
from repro.kernels.nm_spmm.kernel import nm_spmm_dual as j_nm_dual
from repro.kernels.nm_spmm.kernel import nm_spmm_fp8 as j_nm_fp8
from repro.kernels.tile_gemm.kernel import tile_gemm_dual as j_tile_dual
from repro.kernels.tile_gemm.kernel import tile_gemm_fp8 as j_tile_fp8
from repro.launch import convert as convert_cli
from repro.models import init_params
from repro.models import paged as jpaged
from repro_torch import kernels
from repro_torch import serving as tserving
from repro_torch.core import nm as tnm
from repro_torch.core import quantize as tquant
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.nm_spmm.kernel import (nm_spmm_dual, nm_spmm_dual_fp8_requant,
                                                nm_spmm_fp8)
from repro_torch.kernels.tile_gemm.kernel import (tile_gemm_dual, tile_gemm_dual_fp8_requant,
                                                  tile_gemm_fp8, tile_gemm_int8)
from repro_torch.models import paged as tpaged
from torch_parity import assert_scaled_close, jnp_dtype, port_config, port_params

FP8, JFP8 = torch.float8_e4m3fn, jnp.float8_e4m3fn
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
B, K, O = 8, 128, 128
EPILOGUES = [(None, False), (None, True), ("silu", False), ("gelu", True)]


def _inputs(seed, b, k, o, n=4, pairs=1):
    """e4m3 operands as the port makes them: x_q (B, K) + x_scale (B, 1),
    and per weight either w_q (K, O) (n=4) or (values, meta) at n:4, plus
    its (1, O) scale.  Weights are pruned and compressed before
    quantizing, as ``convert_layout(..., quantize="fp8")`` does."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    x[-1] = 0.0                       # an idle slot: the floored scale
    xq, xs = tquant.quantize_rows(torch.from_numpy(x), FP8)
    ws = []
    for _ in range(pairs):
        w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32) * k ** -0.5)
        if n == 4:
            leaf = tquant.quantize_linear({"w": w}, FP8)
            ws.append((leaf["w"], None, leaf["scale"].reshape(1, -1)))
        else:
            c = tnm.compress_nm(tnm.prune_nm(w, n, 4)[0], n, 4)
            leaf = tquant.quantize_linear(
                {"values": c.values, "meta_packed": tnm.pack_meta(c.meta)}, FP8)
            ws.append((leaf["values"], leaf["meta_packed"], leaf["scale"].reshape(1, -1)))
    return xq, xs, ws


def _j(*tensors):
    """torch -> jnp, e4m3 through its byte view (bit-exact)."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
        elif t.dtype == FP8:
            out.append(jnp.asarray(t.view(torch.uint8).numpy().view(JFP8)))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# ----------------------------------------------------------------- kernels
@pytest.mark.parametrize("n", [4, 2, 1])
def test_fp8_raw_accumulator_matches_pallas(n):
    xq, _, [(w, meta, _)] = _inputs(7, B, K, O, n)
    if n == 4:
        want = j_tile_fp8(*_j(xq, w), interpret=True)
        got = tile_gemm_fp8(xq, w)
    else:
        want = j_nm_fp8(*_j(xq, w, meta), None, None, n, interpret=True)
        got = nm_spmm_fp8(xq, w, meta, None, None, n)
    assert got.dtype == torch.float32
    assert_scaled_close(got, want, TOL["float32"])


@pytest.mark.parametrize("n", [4, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", EPILOGUES)
def test_fp8_scaled_plain_matches_pallas(n, dtype, act, bias):
    xq, xs, [(w, meta, ws)] = _inputs(8, B, K, O, n)
    bv = np.random.default_rng(9).standard_normal(O).astype(np.float32) if bias else None
    jdt, tdt = jnp_dtype(dtype), getattr(torch, dtype)
    jkw = dict(out_dtype=jdt, interpret=True, bias=None if bv is None else jnp.asarray(bv),
               epilogue=jepi.EpilogueSpec(act=act, bias=bias))
    tkw = dict(out_dtype=tdt, bias=None if bv is None else torch.from_numpy(bv),
               epilogue=EpilogueSpec(act=act, bias=bias))
    if n == 4:
        want = j_tile_fp8(*_j(xq, w, xs, ws), **jkw)
        got = tile_gemm_fp8(xq, w, xs, ws, **tkw)
    else:
        want = j_nm_fp8(*_j(xq, w, meta, xs, ws), n, **jkw)
        got = nm_spmm_fp8(xq, w, meta, xs, ws, n, **tkw)
    assert got.dtype == tdt
    assert_scaled_close(got, want, TOL[dtype])


def _duals(n, seed):
    xq, xs, [(wg, mg, sg), (wu, mu, su)] = _inputs(seed, B, K, O, n, pairs=2)
    if n == 4:
        return (xq, wg, wu, xs, sg, su), (lambda *a, **k: j_tile_dual(
            *_j(xq, wg, wu, xs, sg, su), acc_dtype=jnp.float32, interpret=True, **k))
    return ((xq, wg, mg, wu, mu, n, xs, sg, su),
            lambda **k: j_nm_dual(*_j(xq, wg, mg, wu, mu), n, *_j(xs, sg, su),
                                  acc_dtype=jnp.float32, interpret=True, **k))


@pytest.mark.parametrize("n", [4, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_dual_plain_matches_pallas(n, dtype):
    args, jax_dual = _duals(n, 10)
    want = jax_dual(out_dtype=jnp_dtype(dtype))
    got = (tile_gemm_dual if n == 4 else nm_spmm_dual)(*args, out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_scaled_close(got, want, TOL[dtype])


@pytest.mark.parametrize("n", [4, 2, 1])
def test_fp8_requant_dual_codes_equal_pallas(n):
    """The requant:float8_e4m3fn flush: e4m3 codes equal as bytes, against
    a scale that saturates a share of them."""
    args, jax_dual = _duals(n, 11)
    y = (tile_gemm_dual if n == 4 else nm_spmm_dual)(*args)
    rq = np.float32(y.abs().max().item() / 600)
    want = jax_dual(epilogue=jepi.EpilogueSpec(act="silu_mul", requant="float8_e4m3fn"),
                    requant_scale=jnp.asarray(rq))
    fn = tile_gemm_dual_fp8_requant if n == 4 else nm_spmm_dual_fp8_requant
    got = fn(*args, torch.tensor(rq))
    assert got.dtype == FP8 and np.asarray(want).dtype == JFP8
    codes = _bytes(got)
    np.testing.assert_array_equal(codes, _bytes(want))
    assert ((codes & 0x7f) == 0x7e).any()          # some codes saturate at +-448


def test_fp8_wrappers_refuse_what_the_kernels_do_not_take():
    xq, xs, [(w, _, ws)] = _inputs(12, B, K, O)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        tile_gemm_fp8(xq.float(), w, xs, ws)
    with pytest.raises(ValueError, match="int8"):
        tile_gemm_int8(xq, w, xs, ws)
    with pytest.raises(ValueError, match="no epilogue"):
        tile_gemm_fp8(xq, w, epilogue=EpilogueSpec(act="silu"))
    with pytest.raises(ValueError, match="every scale"):
        tile_gemm_dual(xq, w, w, xs, None, None)
    with pytest.raises(ValueError, match="requant_scale"):
        tile_gemm_dual_fp8_requant(xq, w, w, xs, ws, ws, torch.ones(2))
    kernels.reset_launch_counts()
    assert torch.equal(tile_gemm_fp8(xq, w), xq.float() @ w.float())
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def _codes_inputs():
    """e4m3 ties (midpoints between neighbours), values beyond +-448,
    subnormals, a zero row and random values, against a power-of-two
    scale (every y / scale exact)."""
    rng = np.random.default_rng(0)
    scale = np.float32(2.0 ** -4)
    x = (rng.standard_normal((5, 64)) * 50).astype(np.float32) * scale
    x[0, :8] = np.array([1.0625, 1.1875, 17.0, 19.0, 208.0, 240.0, -1.0625, -432.0]) * scale
    x[1, :6] = np.array([448.0, 464.0, 480.0, 1e6, -449.0, -1e9]) * scale
    x[2, :4] = np.array([2.0 ** -9, 3 * 2.0 ** -10, 2.0 ** -11, -2.0 ** -8]) * scale
    x[3] = 0.0
    return x, scale


@pytest.mark.parametrize("scale", [None, 0.0371])
def test_requant_rows_fp8_codes_are_bitwise_the_reference(scale):
    x, s = _codes_inputs()
    s = np.float32(s if scale is None else scale)
    want = jepi.requant_rows(jnp.asarray(x), jnp.asarray(s), "float8_e4m3fn")
    got = tepi.requant_rows(torch.from_numpy(x), torch.tensor(s), "float8_e4m3fn")
    assert got.dtype == FP8
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    assert not torch.isnan(got.float()).any()
    assert got.float().abs().max() == 448.0
    spec = tepi.EpilogueSpec(act="silu", requant="float8_e4m3fn")
    np.testing.assert_array_equal(
        _bytes(tepi.flush_tile(torch.from_numpy(x), spec, torch.float32,
                               rq_scale=torch.tensor(s))),
        _bytes(jepi.flush_tile(jnp.asarray(x), jepi.EpilogueSpec(act="silu",
                                                                 requant="float8_e4m3fn"),
                               jnp.float32, rq_scale=jnp.asarray(s))))


# ---------------------------------------------------------------- planning
def _plans(mode, b, ke, o, n, extra, jb, tb, **tkw):
    want = jd.plan(jd.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4, dtype=JFP8, **extra),
                   dispatch=jd.DispatchConfig(backend=jb))
    got = td.plan(td.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4, dtype=FP8, **extra, **tkw),
                  dispatch=td.DispatchConfig(backend=tb))
    return want, got


def _same_plan(want, got):
    names = {jd.JNP_REFERENCE: td.TORCH_REFERENCE}
    assert got.kernel == names.get(want.kernel, want.kernel)
    assert got.reason_code.value == want.reason_code.value
    assert (got.epilogue_reason and got.epilogue_reason.value) == \
        (want.epilogue_reason and want.epilogue_reason.value)
    assert got.epilogue_fused == want.epilogue_fused
    assert got.dtype == want.dtype == "float8_e4m3fn"
    assert got.act_scales == want.act_scales
    if got.uses_kernel:
        import re

        def norm(s):
            return re.sub(r"\[(interpret|cuda)\] blocks=\([^)]*\)", "[k]", s)
        assert norm(td.describe(got)) == norm(jd.describe(want))


PLAN_CASES = [
    ("dense", 32, 128, 64, 4, {}, "interpret"),
    ("compressed", 32, 128, 64, 2, {}, "interpret"),
    ("compressed", 32, 128, 64, 1, {}, "interpret"),
    ("compressed", 3, 256, 128, 2, {}, "interpret"),       # odd decode batch
    ("dense", 64, 2048, 2048, 4, {"epilogue": "bias+gelu"}, "interpret"),
    ("compressed", 8, 128, 128, 2, {"epilogue": "silu_mul", "dual": True}, "interpret"),
    ("dense", 8, 128, 128, 4, {"epilogue": "silu_mul+requant:float8_e4m3fn",
                               "dual": True, "static_scales": True}, "interpret"),
    ("compressed", 8, 128, 64, 2, {"static_scales": True}, "interpret"),
    ("compressed", 8, 128, 64, 2, {}, "jnp"),
    ("dense", 8, 128, 64, 4, {"differentiating": True}, "interpret"),
    ("compressed", 32, 40, 64, 2, {}, "interpret"),         # tiling: no kernel fits
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[0]}-{c[1:5]}-{c[6]}")
def test_fp8_plans_match_reference(case):
    mode, b, ke, o, n, extra, jb = case
    want, got = _plans(mode, b, ke, o, n, extra, jb, {"interpret": "cuda", "jnp": "torch"}[jb])
    _same_plan(want, got)
    if not got.uses_kernel and got.reason_code.value == "no-kernel-fits":
        assert "float8_e4m3fn" in got.reason


def test_fp8_native_dot_gate_matches_reference(monkeypatch):
    """The fp8 entries need a native fp8 dot on the device backend (the
    JAX package's ``tpu``, the port's ``cuda`` on a CUDA device: compute
    capability 8.9+); the kernels' plain versions on CPU tensors always
    run; ``REPRO_FP8_NATIVE`` overrides the probe; int8 is never gated."""
    from repro.kernels import registry as jreg
    from repro_torch.kernels import registry as treg

    cuda = torch.device("cuda")
    for flag, kernel in (("0", None), ("1", "nm_spmm_fp8")):
        monkeypatch.setenv("REPRO_FP8_NATIVE", flag)
        assert jreg.fp8_native_dot() == treg.fp8_native_dot() == (flag == "1")
        jsel = jreg.select("compressed", b=32, ke=128, o=64, n=2, m=4, dtype=JFP8,
                           backend="tpu")
        tsel = treg.select("compressed", b=32, ke=128, o=64, n=2, m=4, dtype=FP8,
                           backend="cuda", device=cuda)
        assert (jsel and jsel[0].name) == (tsel and tsel[0].name) == kernel
        want, got = _plans("compressed", 32, 128, 64, 2, {}, "tpu", "cuda", device=cuda)
        assert got.reason_code.value == want.reason_code.value
        # CPU operands: the plain versions, whatever the device probe says
        cpu = treg.select("compressed", b=32, ke=128, o=64, n=2, m=4, dtype=FP8,
                          backend="cuda", device=torch.device("cpu"))
        assert cpu[0].name == "nm_spmm_fp8"
        i8 = treg.select("compressed", b=32, ke=128, o=64, n=2, m=4, dtype=torch.int8,
                         backend="cuda", device=cuda)
        assert i8[0].name == "nm_spmm_int8"
    monkeypatch.delenv("REPRO_FP8_NATIVE")
    assert treg.supports_fp8("cuda", torch.device("cpu")) and treg.supports_fp8("torch")


def _q_leaf(n, seed=0, k=128, o=128):
    from repro.core.sparse_linear import convert_layout as j_convert
    w = np.random.default_rng(seed).standard_normal((k, o)).astype(np.float32) * k ** -0.5
    jcfg = JSp(mode="dense") if n == 4 else JSp(n=n, m=4, mode="compressed")
    jleaf = j_convert({"w": jnp.asarray(w)}, jcfg, jcfg.mode, quantize="fp8")
    return jcfg, jleaf, port_config_sp(jcfg), port_params(jleaf)


def port_config_sp(jcfg):
    from repro_torch.core.sparse_linear import SparsityConfig
    return SparsityConfig(n=jcfg.n, m=jcfg.m, mode=jcfg.mode)


@pytest.mark.parametrize("n", [4, 2])
def test_fp8_requant_decision_matches_reference(n):
    jcfg, jq, tcfg, tq = _q_leaf(n)
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
            assert tres[0] == jres[0] == "float8_e4m3fn"
            assert float(tres[1]) == float(jres[1]) == float(s)


# ----------------------------------------------------------- calibration
_jit_init = jax.jit(init_params, static_argnums=1)
LAYOUTS = {"dense": JSp(mode="dense"), "2:4": JSp(n=2, m=4, mode="compressed")}
SITES = (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
         ("ffn", "w_in"), ("ffn", "w_gate"), ("ffn", "w_out"))
WIDE = dict(d_model=128, head_dim=32)


def _spec_kw(sp, static):
    return dict(layout=sp.mode, sparsity=None if sp.n == 4 else (sp.n, 4), qdtype="fp8",
                static_scales=static)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fp8_calibrated_scales_match_the_reference(layout):
    sp = LAYOUTS[layout]
    jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype="float32",
                               sparsity=sp, name=f"fp8-calib-{layout}")
    jp = _jit_init(jax.random.PRNGKey(0), jcfg)
    calib = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jprep = jserving.prepare(jp, jserving.ServingSpec(**_spec_kw(sp, True)), cfg=jcfg,
                                 calib_tokens=jnp.asarray(calib))
    tprep = tserving.prepare(port_params(jp),
                             tserving.ServingSpec(**_spec_kw(sp, True), backend="torch"),
                             cfg=port_config(jcfg), calib_tokens=torch.from_numpy(calib),
                             device="cpu")
    assert tprep.calibrated_sites == jprep.calibrated_sites == len(SITES)
    for grp, name in SITES:
        j = np.asarray(jprep.params["stages"][0]["slot0"][grp][name]["act_scale"]).reshape(-1)
        t = np.array([float(layer[grp][name]["act_scale"])
                      for layer in tprep.params["layers"]])
        assert (t == t[0]).all() and (j == j[0]).all(), (grp, name)
        assert abs(t[0] - j[0]) <= 1e-6 * j[0], (grp, name, t[0], j[0])
        leaf = tprep.params["layers"][0][grp][name]
        assert leaf["values" if "values" in leaf else "w"].dtype == FP8


# ------------------------------------------------------------------ model
BLOCK_LEN, WIDTH, CHUNK = 8, 4, 6
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])
DECODE_FEED = ([42, 7], [99, 0])


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _run_paged(p, mod, params, cfg, caches, asarray):
    """Prefill both prompts in chunks, then two batched decode steps fed
    fixed tokens (the second with one slot idle); every call's logits."""
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
            params, caches, asarray(np.array(feed)[:, None]), asarray(pos), asarray(table),
            asarray(np.array(active)), cfg, BLOCK_LEN)
        outs.append(_f32(logits[:, 0])[np.array(active)])
        pos = pos + 1
    return outs


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fp8_logits_match_the_fp8_pallas_kernels(layout, static, monkeypatch):
    sp = LAYOUTS[layout]
    dtype, tol = "float32", 2e-3
    jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype=dtype, sparsity=sp,
                               name=f"fp8-{layout}-{static}-{dtype}", **WIDE)
    calib = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jq = jserving.prepare(_jit_init(jax.random.PRNGKey(0), jcfg),
                              jserving.ServingSpec(**_spec_kw(sp, static)), cfg=jcfg,
                              calib_tokens=jnp.asarray(calib) if static else None).params
    tcfg, tq = port_config(jcfg), port_params(jq)
    with jd.use_dispatch(backend="interpret"):
        assert not [ln for ln in jd.dispatch_report(jq, (2, CHUNK), jcfg.sparsity)
                    if " global " in ln and "_fp8[interpret]" not in ln]
    lines = td.dispatch_report(tq, (2, CHUNK), tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    acts = "act-scales=static" if static else "act-scales=dynamic"
    assert lines and all("_fp8[cuda]" in ln and acts in ln for ln in lines)
    calls, fed = [], []
    kind = "tile_gemm" if layout == "dense" else "nm_spmm"
    mod = kernels._tile_gemm if layout == "dense" else kernels._nm_spmm
    for name in (f"{kind}_fp8", f"{kind}_dual_fp8", f"{kind}_dual_fp8_requant"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
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
    dual = f"{kind}_dual_fp8_requant" if static else f"{kind}_dual_fp8"
    assert set(calls) == {f"{kind}_fp8", dual}
    # static: w_out (and only w_out, K = d_ff) receives e4m3 rows, one per dual
    narrow = [k for dt, k in fed if dt == FP8]
    assert len(narrow) == (calls.count(dual) if static else 0)
    assert set(narrow) <= {jcfg.d_ff}
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_scaled_close(g, w, tol)


# --------------------------------------------------------------- artifact
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "hf_tiny"
TRACE_KW = dict(seed=0, num_requests=4, rate=1.0)


@pytest.fixture(scope="module")
def fp8_artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("fp8") / "art"
    rc = convert_cli.main(["--input", str(FIXTURE), "--output", str(out),
                           "--arch", "internlm2_1_8b", "--smoke", "--mode", "compressed",
                           "--sparsity", "2:4", "--quantize", "fp8"])
    assert rc == 0
    return out


# request id -> (generated-token index, the two token ids exactly tied there
# in the JAX jnp tier's bf16 logits): the same pair as the int8 artifact's
# tie (tests/test_torch_artifact.py), one token later
TIES = {"0": (7, (103, 152))}


def _tokens(engine_cls, prepared):
    trace = (jserving if engine_cls is jserving.Engine else tserving).make_poisson_trace(
        vocab_size=prepared.cfg.vocab_size, **TRACE_KW)
    return {str(s.rid): [int(t) for t in s.tokens] for s in engine_cls(prepared).run(trace).stats}


def test_port_serves_the_fp8_artifact_like_the_reference(fp8_artifact, monkeypatch):
    """The port's torch tier serves the JAX jnp tier's token streams up to
    one exact bf16 tie in the JAX logits (top-2 gap 0.0, checked here):
    JAX's argmax takes the lower id, the port's logits (bf16 roundings in
    other places) may break the tie the other way."""
    seen = []
    real = jpaged.paged_decode_step

    def spy(params, caches, tokens, *rest, **kw):
        logits, caches = real(params, caches, tokens, *rest, **kw)
        seen.append(np.asarray(logits[:, 0].astype(jnp.float32)))
        return logits, caches

    monkeypatch.setattr(jpaged, "paged_decode_step", spy)
    with jd.use_dispatch(backend="jnp"):
        want = _tokens(jserving.Engine, jserving.prepare_from_artifact(fp8_artifact))
    tprep = tserving.prepare_from_artifact(fp8_artifact, backend="torch", device="cpu")
    assert tprep.spec.qdtype == "fp8" and tprep.cfg.num_layers == 2
    assert all("torch-reference" in ln for ln in tprep.dispatch_report())
    got = _tokens(tserving.Engine, tprep)
    assert sorted(got) == sorted(want)
    for rid, toks in want.items():
        at, pair = TIES.get(rid, (len(toks), ()))
        assert got[rid][:at] == toks[:at], rid
        if rid in TIES:
            assert toks[at] == min(pair) and got[rid][at] in pair
            assert len(got[rid]) == len(toks)
    (_, (_, (a, b))), = TIES.items()
    assert [row for logits in seen for row in logits
            if set(np.argsort(row)[-2:].tolist()) == {a, b} and row[a] == row[b]]


def test_fp8_artifact_serves_on_the_cuda_tier_on_cpu(fp8_artifact):
    """The same artifact through the fp8 kernels' plain versions: every
    site that fits plans an ``_fp8[cuda]`` kernel."""
    tprep = tserving.prepare_from_artifact(fp8_artifact, backend="cuda", device="cpu")
    lines = tprep.dispatch_report()
    assert any("_fp8[cuda]" in ln for ln in lines)
    assert all("_fp8[cuda]" in ln or "torch-reference" in ln for ln in lines)
    kernels.reset_launch_counts()
    rep = tserving.Engine(tprep).run(tserving.make_poisson_trace(
        vocab_size=tprep.cfg.vocab_size, **TRACE_KW))
    assert rep.completed == 4
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}   # CPU: no launch


def test_launcher_serves_fp8_with_static_scales(capsys):
    from repro_torch.launch import serve

    rep = serve.main(["--arch", "internlm2_1_8b", "--smoke", "--sparsity", "2:4",
                      "--quantize", "fp8", "--static-scales", "--device", "cpu",
                      "--kernel-backend", "cuda", "--requests", "2", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert rep.completed == 2
    assert "calibrated for 7 linear site(s)" in out and "/fp8)" in out
    assert "nm_spmm_fp8[cuda]" in out and "act-scales=static" in out
