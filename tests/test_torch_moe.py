"""The port's MoE family against ``repro.models.moe`` and the JAX Engine.

- ``apply_moe`` against the JAX package's on the qwen3-moe smoke config
  in fp32, both expert paths, within 1e-5 of max|reference| (the two
  frameworks' fp32 dots sum in other orders).  The routing is the same:
  every token's routed experts and every expert's capacity winners are
  equal, and the (T, E) combine weights agree to 1e-6 (an ulp or two:
  XLA's and torch's fp32 ``exp`` and router dot round differently, so
  they are not bitwise).
- bf16 on the kernel tiers: the port's cuda tier (the kernels' plain
  versions on CPU tensors: the gate-up dual and ``w_out``'s masked
  kernel) against the JAX package's Pallas kernels in interpret mode,
  spgemm path, within 3e-2; ``w_out`` plans ``ACT_SKIP`` and the gate-up
  ``ACT_MASK_ONLY_DUAL`` in both packages.
- The port's spgemm path bitwise equal to its gather path on fp32, dense
  and 2:4 compressed, with and without capacity drops (the FFN is
  row-independent and the combine the same scatter-add).
- The paged model (prefill chunks + decode) on the MoE smoke config
  against JAX's, and fp32 Engine token streams equal to the JAX Engine's
  on the jnp tier, both expert paths.
- ``params_from_numpy`` on a MoE tree (router fp32, expert stacks keep E),
  ``convert_layout`` + quantization of stacked expert leaves bitwise, and
  static-scale calibration with the expert stacks sharing one scale per
  site (7 sites) equal to JAX ``prepare``'s.
- ``build_layout`` takes the moe family, lays out the ssm and hybrid
  families as the JAX package does and refuses an unknown one; the
  launcher serves ``--arch qwen3_moe_235b_a22b --smoke`` on the CPU.
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
from repro.kernels import dispatch as jd
from repro.models import init_params
from repro.models import moe as jmoe
from repro.models import paged as jpaged
from repro_torch import serving as tserving
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.reasons import ReasonCode
from repro_torch.models import moe as tmoe
from repro_torch.models import paged as tpaged
from repro_torch.models import transformer as ttr
from torch_parity import assert_scaled_close, port_config, port_params

ARCH = "qwen3_moe_235b_a22b"


def _cfg(**kw):
    return dataclasses.replace(get_smoke_config(ARCH), **{"dtype": "float32", **kw})


_init = jax.jit(init_params, static_argnums=1)


def _x(seed, shape=(2, 16, 64), dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ------------------------------------------------------------- apply_moe
@pytest.mark.parametrize("path", ["gather", "spgemm"])
@pytest.mark.parametrize("capacity", [1.25, 16.0])
def test_apply_moe_matches_the_reference_fp32(path, capacity):
    jcfg = _cfg(moe_expert_path=path, moe_capacity_factor=capacity)
    tcfg = port_config(jcfg)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = port_params(jp)
    x = _x(1)
    with jd.use_dispatch(backend="jnp"):
        want = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with td.use_dispatch(backend="torch"):
        got = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert_scaled_close(got, want, 1e-5)


def test_routing_matches_the_reference():
    jcfg = _cfg()
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
    xf = _x(3, (32, 64))
    want = np.asarray(jmoe._route(jp["router"], jnp.asarray(xf), jcfg))
    got = tmoe._route(torch.from_numpy(np.array(jp["router"])), torch.from_numpy(xf),
                      port_config(jcfg)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)          # the same routed experts
    assert ((got > 0).sum(-1) == jcfg.top_k).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the capacity winners of every expert, -inf ties in index order
    cap = tmoe._capacity(32, port_config(jcfg))
    assert cap == jmoe._capacity(32, jcfg)
    for e in range(jcfg.num_experts):
        score = np.where(want[:, e] > 0, want[:, e], -np.inf).astype(np.float32)
        _, j_idx = jax.lax.top_k(jnp.asarray(score), cap)
        _, t_idx = tmoe._top_k(torch.from_numpy(score), cap)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_apply_moe_bf16_kernel_tiers_match_the_reference(monkeypatch):
    """spgemm on the kernel tiers: the port's plain versions of the dual
    and the masked w_out kernel against the Pallas kernels (interpret)."""
    from repro_torch.kernels.tile_gemm import kernel as tk
    jcfg = _cfg(dtype="bfloat16", d_ff=128, num_experts=4, moe_expert_path="spgemm")
    tcfg = port_config(jcfg)
    jp = jmoe.init_moe(jax.random.PRNGKey(4), jcfg)
    tp = port_params(jp)
    x = _x(5, (1, 8, 64))
    with jd.use_dispatch(backend="interpret"):
        want = jmoe.apply_moe(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    masked = []
    real = tk.tile_gemm_masked_ref
    monkeypatch.setattr(tk, "tile_gemm_masked_ref",
                        lambda *a, **k: masked.append(1) or real(*a, **k))
    with td.use_dispatch(backend="cuda"):
        got = tmoe.apply_moe(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert len(masked) == jcfg.num_experts                     # every expert's w_out
    assert_scaled_close(got, want, 3e-2)
    # the decisions: w_out skips, the dual contracts the masked rows
    for j_extra, t_extra, code in (
            ({}, {}, ReasonCode.ACT_SKIP),
            ({"dual": True, "epilogue": "silu_mul"}, {"dual": True, "epilogue": "silu_mul"},
             ReasonCode.ACT_MASK_ONLY_DUAL)):
        ke, o = (128, 64) if not j_extra else (64, 128)
        want_d = jd.plan(jd.GemmProblem("dense", b=8, ke=ke, o=o, dtype=jnp.bfloat16,
                                        activation="zeros", **j_extra),
                         dispatch=jd.DispatchConfig(backend="interpret"))
        got_d = td.plan(td.GemmProblem("dense", b=8, ke=ke, o=o, dtype=torch.bfloat16,
                                       activation="zeros", **t_extra),
                        dispatch=td.DispatchConfig(backend="cuda"))
        assert got_d.activation_reason is code
        assert want_d.activation_reason.value == code.value


@pytest.mark.parametrize("sparsity", [TSp(), TSp(n=2, m=4, mode="compressed"),
                                      TSp(n=2, m=4, mode="gather")])
@pytest.mark.parametrize("capacity", [1.0, 16.0])
def test_spgemm_is_bitwise_the_gather_path(sparsity, capacity):
    tcfg = port_config(_cfg(moe_capacity_factor=capacity))
    tcfg = dataclasses.replace(tcfg, sparsity=sparsity)
    p = tmoe.init_moe(torch.Generator().manual_seed(6), tcfg)
    x = torch.from_numpy(_x(7))
    with td.use_dispatch(backend="torch"):
        a = tmoe.apply_moe(p, x, tcfg)
        b = tmoe.apply_moe(p, x, dataclasses.replace(tcfg, moe_expert_path="spgemm"))
    assert torch.equal(a, b)
    if capacity == 1.0:   # 32 tokens x top-2 over 8 experts at capacity 8: drops
        w = tmoe._route(p["router"], x.reshape(-1, 64), tcfg)
        assert ((w > 0).sum(0) > tmoe._capacity(32, tcfg)).any()


# ------------------------------------------------------------ the model
def test_params_from_numpy_keeps_the_expert_stacks():
    jcfg = _cfg()
    jp = _init(jax.random.PRNGKey(8), jcfg)
    tp = port_params(jp)
    assert len(tp["layers"]) == jcfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        ffn = layer["ffn"]
        assert ffn["router"].dtype == torch.float32 and tuple(ffn["router"].shape) == (64, 8)
        assert tuple(ffn["w_gate"]["w"].shape) == (8, 64, 96)
        assert tuple(ffn["w_out"]["w"].shape) == (8, 96, 64)
        np.testing.assert_array_equal(
            ffn["w_out"]["w"].numpy(),
            np.asarray(jp["stages"][0]["slot0"]["ffn"]["w_out"]["w"][i, 0]))


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "jamba_1_5_large_398b"])
def test_build_layout_takes_moe_and_the_ssm_families_like_the_reference(arch):
    """The moe layout, and the ssm and hybrid layouts equal to the JAX
    package's (stage counts, slots and repeats; the full configs too); an
    unknown family still raises."""
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtr
    from repro_torch.configs import get_config as tget_config
    cfg = port_config(_cfg())
    assert [s.ffn for s in ttr.layer_slots(cfg)] == ["moe", "moe"]
    for jcfg, tcfg in ((get_smoke_config(arch), port_config(get_smoke_config(arch))),
                       (jget_config(arch), tget_config(arch))):
        want = [(st.count, [(sl.mixer, sl.ffn, sl.repeat) for sl in st.slots])
                for st in jtr.build_layout(jcfg)]
        assert [(st.count, [(sl.mixer, sl.ffn, sl.repeat) for sl in st.slots])
                for st in ttr.build_layout(tcfg)] == want
        assert len(ttr.layer_slots(tcfg)) == jtr.layout_num_layers(jcfg) == jcfg.num_layers
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ttr.build_layout(dataclasses.replace(cfg, family="diffusion"))


BLOCK_LEN = 8
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])


def _paged(p, mod, params, cfg, caches, asarray):
    """Prefill both prompts in chunks of 6, then one batched decode step."""
    outs = []
    table = np.array([[1, 2], [3, 4]], np.int32)
    for s, prompt in enumerate(PROMPTS):
        for off in range(0, len(prompt), 6):
            tok = asarray(np.array([prompt[off:off + 6]]))
            c = tok.shape[1]
            args = (tok, off, asarray(table[s:s + 1]), c) if p == "torch" else (
                tok, jnp.int32(off), asarray(table[s:s + 1]), jnp.int32(c), jnp.int32(s))
            logits, caches = mod.paged_prefill_chunk(params, caches, *args, cfg, BLOCK_LEN)
            outs.append(np.asarray(logits[0, :c], np.float32))
    logits, caches = mod.paged_decode_step(
        params, caches, asarray(np.array([[42], [7]])), asarray(np.array([12, 6])),
        asarray(table), asarray(np.array([True, True])), cfg, BLOCK_LEN)
    outs.append(np.asarray(logits[:, 0], np.float32))
    return outs


@pytest.mark.parametrize("path", ["gather", "spgemm"])
def test_paged_moe_logits_match_the_reference(path):
    jcfg = _cfg(moe_expert_path=path, name=f"moe-paged-{path}")
    jp = _init(jax.random.PRNGKey(9), jcfg)
    tcfg, tp = port_config(jcfg), port_params(jp)
    with jd.use_dispatch(backend="jnp"):
        want = _paged("jax", jpaged, jp, jcfg, jpaged.init_paged_caches(jcfg, 5, BLOCK_LEN, 2),
                      jnp.asarray)
    with td.use_dispatch(backend="torch"), torch.inference_mode():
        got = _paged("torch", tpaged, tp, tcfg, tpaged.init_paged_caches(tcfg, 5, BLOCK_LEN),
                     lambda a: torch.from_numpy(np.array(a)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_scaled_close(torch.from_numpy(g), w, 1e-4)


@pytest.mark.parametrize("path", ["gather", "spgemm"])
def test_engine_token_streams_equal_the_reference(path):
    base = dict(layout="dense", slots=4, max_len=64, block_len=8, prefill_chunk=8)
    jspec = jserving.ServingSpec(**base)
    # a config name per path: the JAX package's jitted steps are keyed by it
    jcfg = jspec.apply_to(_cfg(moe_expert_path=path, name=f"moe-engine-{path}"))
    jp = _init(jax.random.PRNGKey(10), jcfg)
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**base, backend="torch"),
                             cfg=port_config(jcfg), device="cpu")
    with jd.use_dispatch(backend="jnp"):
        jrep = jserving.Engine(jserving.prepare(jp, jspec, cfg=jcfg)).run(
            jserving.make_poisson_trace(seed=0, num_requests=4, vocab_size=jcfg.vocab_size))
    trep = tserving.Engine(tprep).run(
        tserving.make_poisson_trace(seed=0, num_requests=4, vocab_size=jcfg.vocab_size))
    assert [s.tokens for s in trep.stats] == [s.tokens for s in jrep.stats]
    assert trep.completed == jrep.completed == 4


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k, v in sorted(tree.items()) for kv in _flat(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, path + (i,))]
    return [(path, tree)]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.parametrize("layout,sparsity,qdtype", [("compressed", (2, 4), "int8"),
                                                    ("gather", (2, 4), "fp8"),
                                                    ("dense", None, "int8")])
def test_prepare_converts_expert_stacks_like_the_reference(layout, sparsity, qdtype):
    """Step 1 and 2 of prepare on the stacked (E, K, O) expert leaves:
    layout conversion and per-channel quantization bitwise the JAX
    package's (the stack's leading dims are kept)."""
    jspec = jserving.ServingSpec(layout=layout, sparsity=sparsity, qdtype=qdtype)
    jcfg = jspec.apply_to(_cfg(dtype="bfloat16"))
    jp = _init(jax.random.PRNGKey(11), dataclasses.replace(jcfg, sparsity=JSp()))
    want = port_params(jserving.prepare(jp, jspec, cfg=jcfg).params)
    got = tserving.prepare(port_params(jp), tserving.ServingSpec(
        layout=layout, sparsity=sparsity, qdtype=qdtype), cfg=port_config(jcfg),
        device="cpu").params
    fg, fw = _flat(got), _flat(want)
    assert [k for k, _ in fg] == [k for k, _ in fw]
    for (k, g), (_, w) in zip(fg, fw):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(_bytes(g), _bytes(w)), k
    assert tuple(got["layers"][0]["ffn"]["w_out"]["scale"].shape) == (8, 64)


def test_calibration_shares_one_scale_per_expert_stack():
    """Static scales: 7 sites (wq, wk, wv, wo and the three expert stacks),
    each the max over every layer and expert, equal to JAX prepare's."""
    spec_kw = dict(layout="compressed", sparsity=(2, 4), qdtype="int8", static_scales=True)
    jcfg = jserving.ServingSpec(**spec_kw).apply_to(_cfg(name="moe-calib"))
    jp = _init(jax.random.PRNGKey(12), jcfg)
    calib = np.random.default_rng(13).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jprep = jserving.prepare(jp, jserving.ServingSpec(**spec_kw), cfg=jcfg,
                                 calib_tokens=jnp.asarray(calib))
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**spec_kw, backend="torch"),
                             cfg=port_config(jcfg), calib_tokens=torch.from_numpy(calib),
                             device="cpu")
    assert tprep.calibrated_sites == jprep.calibrated_sites == 7
    slot = jprep.params["stages"][0]["slot0"]
    for grp, names in (("mixer", ("wq", "wk", "wv", "wo")),
                       ("ffn", ("w_gate", "w_in", "w_out"))):
        for name in names:
            j = np.asarray(slot[grp][name]["act_scale"]).reshape(-1)
            assert (j == j[0]).all()
            for layer in tprep.params["layers"]:
                t = float(layer[grp][name]["act_scale"])
                assert abs(t - j[0]) <= 1e-6 * j[0], (grp, name, t, j[0])


def test_launcher_serves_the_moe_smoke_config(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                      "--new-tokens", "2", "--max-len", "32", "--sparsity", "2:4",
                      "--mode", "gather"])
    out = capsys.readouterr().out
    assert rep.completed == 2
    assert "serving qwen3-moe-235b-a22b" in out and "dispatch engine plan:" in out
