"""The rest of the dense family in the port against the JAX package:
gemma3 (local/global attention, a gelu MLP, tied embeddings), starcoder2
(a gelu MLP) and mistral-large (its config only).

- ``local_attention`` against the JAX package's at the gemma3 smoke
  window (8), T = 16 and 32, fp32 within 1e-5 of max|reference| (the
  two frameworks' fp32 dots sum in other orders), with and without bf16
  probabilities.
- ``build_layout`` / ``layer_slots`` / ``layer_site_keys``: the JAX
  package's stage / slot / repeat order for gemma3 (smoke, with a
  remainder stage, and the full 26 layers: three site keys), and
  ``layer_is_global`` equal to the JAX config's for every layer.
- The whole model on the gemma3 smoke config, fp32, within 1e-4: the
  ``forward`` logits at T = 8 (the window covers the sequence: the
  dispatch engine's attention) and T = 16 (the banded local attention),
  the paged prefill and decode past the window (the band in the paged
  mask), dense / 2:4 / gather 2:4; and the Engine's greedy token streams
  equal to the JAX Engine's.
- Static int8 on the kernel tiers: the JAX package's calibration (jnp)
  and the port's (torch) give the same 18 sites for a gemma3 config with
  a remainder stage, scales within 1e-6; on the JAX-calibrated params,
  the port's cuda tier (plain versions on CPU tensors: every gelu
  ``w_in`` requantizes in its flush, every ``w_out`` contracts int8 rows)
  against the JAX interpret tier over paged prefill and decode, within
  5e-2, the limit tests/test_torch_static.py gives the static path where
  codes can flip.  Measured at these 4 layers: <= 5.7e-7 (the same codes
  everywhere).  The two frameworks' fp32 attention outputs differ by an
  ulp, and at 8 layers that moved one wo activation code by 1 (layer 1,
  position 8) against the per-tensor static scale, which the later
  layers carried to 1.6e-2 (every linear's output was bitwise equal on
  equal codes, the gelu MLP's on every call).
- starcoder2-3b and mistral-large-123b smoke logits, fp32 within 1e-4.
- The launcher serves gemma3 smoke on the CPU through the static gather
  2:4 kernels' plain versions, and refuses to run without a card unless
  told ``--device cpu``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.kernels import dispatch as jd
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_params
from repro.models import paged as jpaged
from repro.models import transformer as jtr
from repro_torch import kernels
from repro_torch import serving as tserving
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import dispatch as td
from repro_torch.models import attention as tattn
from repro_torch.models import forward as tforward
from repro_torch.models import paged as tpaged
from repro_torch.models import transformer as ttr
from torch_parity import assert_scaled_close, port_config, port_params

ARCH = "gemma3_1b"
_init = jax.jit(init_params, static_argnums=1)
LAYOUTS = {"dense": JSp(mode="dense"), "2:4": JSp(n=2, m=4, mode="compressed"),
           "gather-2:4": JSp(n=2, m=4, mode="gather")}


def _cfg(arch=ARCH, **kw):
    return dataclasses.replace(get_smoke_config(arch), **{"dtype": "float32", **kw})


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("t", [16, 32])
@pytest.mark.parametrize("p_bf16", [False, True])
def test_local_attention_matches_the_reference(t, p_bf16):
    rng = np.random.default_rng(t)
    b, hkv, g, d = 2, 1, 4, 16
    q = rng.standard_normal((b, hkv, g, t, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    want = jattn.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=8,
                                 p_bf16=p_bf16)
    got = tattn.local_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                window=8, p_bf16=p_bf16)
    assert got.shape == (b, hkv, g, t, d) and got.dtype == torch.float32
    assert_scaled_close(got, want, 1e-5)


def test_local_attention_is_banded_and_refuses_a_ragged_chunk():
    """Position t sees (t - window, t]: a key outside the band moves no
    output, one inside does; T must be a multiple of the query chunk."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 1, 1, 16, 8), (1, 16, 1, 8), (1, 16, 1, 8)))
    base = tattn.local_attention(q, k, v, window=8)
    v2 = v.clone()
    v2[0, 3] += 10.0                          # key 3: in the band of queries 3..10
    moved = (tattn.local_attention(q, k, v2, window=8) - base).abs().amax(-1)[0, 0, 0]
    assert (moved[3:11] > 0).all() and (moved[:3] == 0).all() and (moved[11:] == 0).all()
    with pytest.raises(ValueError, match="multiple"):
        tattn.local_attention(q[:, :, :, :12], k[:, :12], v[:, :12], window=8)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("num_layers", [None, 8, 26])
def test_layout_and_site_keys_follow_the_reference(num_layers):
    over = {} if num_layers is None else {"num_layers": num_layers}
    jcfg = _cfg(**over)
    tcfg = port_config(jcfg)
    want = jtr.build_layout(jcfg)
    got = ttr.build_layout(tcfg)
    assert [(st.count, [(s.mixer, s.ffn, s.repeat) for s in st.slots]) for st in got] == \
        [(st.count, [(s.mixer, s.ffn, s.repeat) for s in st.slots]) for st in want]
    order = [(si, j, slot.mixer) for si, st in enumerate(want) for _ in range(st.count)
             for j, slot in enumerate(st.slots) for _ in range(slot.repeat)]
    assert [(s, j) for s, j, _ in order] == ttr.layer_site_keys(tcfg)
    assert [m for _, _, m in order] == [s.mixer for s in ttr.layer_slots(tcfg)]
    assert len(order) == jcfg.num_layers
    for i in range(jcfg.num_layers):
        assert tcfg.layer_is_global(i) == jcfg.layer_is_global(i)
    # the last of each period is global; a remainder stage is all local
    assert [m == "attn" for _, _, m in order] == [
        i % jcfg.local_global_period == jcfg.local_global_period - 1 and
        i < jcfg.num_layers - jcfg.num_layers % jcfg.local_global_period
        for i in range(jcfg.num_layers)]


def test_full_gemma3_config_is_the_reference_config():
    tcfg, jcfg = t_get_config(ARCH), j_get_config(ARCH)
    assert port_config(jcfg) == tcfg
    assert len(set(ttr.layer_site_keys(tcfg))) == 3            # 3 keys x 6 leaves = 18 sites
    assert sum(tcfg.layer_is_global(i) for i in range(tcfg.num_layers)) == 4


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("t", [8, 16])
def test_forward_logits_match_the_reference(layout, t):
    jcfg = _cfg(sparsity=LAYOUTS[layout], name=f"local-fwd-{layout}")
    jp = _init(jax.random.PRNGKey(1), jcfg)
    tp = port_params(jp)
    assert "unembed" not in tp and len(tp["layers"]) == jcfg.num_layers   # tied
    tokens = np.random.default_rng(t).integers(0, jcfg.vocab_size, (2, t))
    with jd.use_dispatch(backend="jnp"):
        want = jforward(jp, jcfg, jnp.asarray(tokens))
    with td.use_dispatch(backend="torch"):
        got = tforward(tp, port_config(jcfg), torch.from_numpy(tokens))
    assert_scaled_close(got, want, 1e-4)


BLOCK_LEN, CHUNK = 8, 6
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])
DECODE_FEED = ([42, 7], [99, 0], [5, 6])


def _run_paged(p, mod, params, cfg, asarray):
    """Both prompts in chunks of 6, then three batched decode steps fed
    fixed tokens (prompt 0 decodes at positions 12-14, past the window of
    8); every call's logits as float32 numpy."""
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    caches = (jpaged.init_paged_caches(cfg, 9, BLOCK_LEN, 2) if p == "jax"
              else tpaged.init_paged_caches(cfg, 9, BLOCK_LEN))
    outs = []
    for s, prompt in enumerate(PROMPTS):
        for off in range(0, len(prompt), CHUNK):
            c = min(CHUNK, len(prompt) - off)
            tok = asarray(np.array([prompt[off:off + c]]))
            args = (tok, off, asarray(table[s:s + 1]), c) if p == "torch" else (
                tok, jnp.int32(off), asarray(table[s:s + 1]), jnp.int32(c), jnp.int32(s))
            logits, caches = mod.paged_prefill_chunk(params, caches, *args, cfg, BLOCK_LEN)
            outs.append(np.asarray(logits[0, :c], np.float32))
    pos = np.array([len(q) for q in PROMPTS])
    for feed in DECODE_FEED:
        logits, caches = mod.paged_decode_step(
            params, caches, asarray(np.array(feed)[:, None]), asarray(pos), asarray(table),
            asarray(np.array([True, True])), cfg, BLOCK_LEN)
        outs.append(np.asarray(logits[:, 0], np.float32))
        pos = pos + 1
    return outs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_paged_logits_past_the_window_match_the_reference(layout):
    jcfg = _cfg(sparsity=LAYOUTS[layout], name=f"local-paged-{layout}")
    jp = _init(jax.random.PRNGKey(2), jcfg)
    tcfg, tp = port_config(jcfg), port_params(jp)
    with jd.use_dispatch(backend="jnp"):
        want = _run_paged("jax", jpaged, jp, jcfg, jnp.asarray)
    with td.use_dispatch(backend="torch"), torch.inference_mode():
        got = _run_paged("torch", tpaged, tp, tcfg, lambda a: torch.from_numpy(np.array(a)))
    assert len(got) == len(want) == 3 + len(DECODE_FEED)
    for g, w in zip(got, want):
        assert_scaled_close(torch.from_numpy(g), w, 1e-4)
    # the band matters: without it the late decode logits move
    with td.use_dispatch(backend="torch"), torch.inference_mode():
        wide = _run_paged("torch", tpaged, tp, dataclasses.replace(tcfg, window=64),
                          lambda a: torch.from_numpy(np.array(a)))
    assert np.abs(wide[-1][0] - got[-1][0]).max() > 1e-3


@pytest.mark.parametrize("layout,sparsity", [("dense", None), ("compressed", (2, 4)),
                                             ("gather", (2, 4))])
def test_engine_token_streams_equal_the_reference(layout, sparsity):
    base = dict(layout=layout, sparsity=sparsity, slots=4, max_len=64, block_len=8,
                prefill_chunk=8)
    jspec = jserving.ServingSpec(**base)
    jcfg = jspec.apply_to(_cfg(name=f"local-engine-{layout}"))
    jp = _init(jax.random.PRNGKey(0), jcfg)
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**base, backend="torch"),
                             cfg=port_config(jcfg), device="cpu")
    trace = dict(seed=0, num_requests=6, vocab_size=jcfg.vocab_size)
    with jd.use_dispatch(backend="jnp"):
        jrep = jserving.Engine(jserving.prepare(jp, jspec, cfg=jcfg)).run(
            jserving.make_poisson_trace(**trace))
    trep = tserving.Engine(tprep).run(tserving.make_poisson_trace(**trace))
    assert [s.tokens for s in trep.stats] == [s.tokens for s in jrep.stats]
    assert trep.completed == jrep.completed == 6
    # some request decodes past the window
    assert max(s.prompt_len + len(s.tokens) for s in trep.stats) > jcfg.window


# ------------------------------------------------------------- static int8
WIDE = dict(d_model=128, num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256, num_layers=4)
STATIC = dict(qdtype="int8", static_scales=True)


def test_calibration_gives_the_reference_sites_and_scales():
    """Three (stage, slot) keys x six leaves (no w_gate): 18 sites, every
    layer of a key sharing its scale, equal to JAX prepare's."""
    spec_kw = dict(layout="compressed", sparsity=(2, 4), **STATIC)
    jcfg = jserving.ServingSpec(**spec_kw).apply_to(_cfg(name="local-calib", **WIDE))
    jp = _init(jax.random.PRNGKey(3), jcfg)
    calib = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jprep = jserving.prepare(jp, jserving.ServingSpec(**spec_kw), cfg=jcfg,
                                 calib_tokens=jnp.asarray(calib))
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**spec_kw, backend="torch"),
                             cfg=port_config(jcfg), calib_tokens=torch.from_numpy(calib),
                             device="cpu")
    assert tprep.calibrated_sites == jprep.calibrated_sites == 18
    want = port_params(jprep.params)
    for lw, lt in zip(want["layers"], tprep.params["layers"]):
        for grp, name in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
                          ("ffn", "w_in"), ("ffn", "w_out")):
            j, t = float(lw[grp][name]["act_scale"]), float(lt[grp][name]["act_scale"])
            assert abs(t - j) <= 1e-6 * j, (grp, name, t, j)


@pytest.mark.parametrize("layout,sparsity", [("compressed", (2, 4)), ("gather", (2, 4))])
def test_static_int8_logits_match_the_int8_pallas_kernels(layout, sparsity, monkeypatch):
    spec_kw = dict(layout=layout, sparsity=sparsity, **STATIC)
    jcfg = jserving.ServingSpec(**spec_kw).apply_to(_cfg(name=f"local-static-{layout}",
                                                         **WIDE))
    calib = np.random.default_rng(5).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jq = jserving.prepare(_init(jax.random.PRNGKey(6), jcfg),
                              jserving.ServingSpec(**spec_kw), cfg=jcfg,
                              calib_tokens=jnp.asarray(calib)).params
    tcfg, tq = port_config(jcfg), port_params(jq)
    lines = td.dispatch_report(tq, (2, CHUNK), tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    assert lines and all("_int8[cuda]" in ln and "act-scales=static" in ln for ln in lines)
    kind = "nm_spmm" if layout == "compressed" else "nm_spmm_gather_bk"
    mod = kernels._nm_spmm if layout == "compressed" else kernels._nm_spmm_gather
    calls, fed = [], []
    for name in (f"{kind}_int8", f"{kind}_int8_requant"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    real_mm = td.sparse_matmul
    monkeypatch.setattr(td, "sparse_matmul", lambda x, *a, **k:
                        fed.append((x.dtype, x.shape[-1])) or real_mm(x, *a, **k))
    with jd.use_dispatch(backend="interpret"):
        want = _run_paged("jax", jpaged, jq, jcfg, jnp.asarray)
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = _run_paged("torch", tpaged, tq, tcfg, lambda a: torch.from_numpy(np.array(a)))
    # every w_in requantizes in its flush; w_out (K = d_ff) takes int8 rows
    n_calls = 3 + len(DECODE_FEED)
    assert calls.count(f"{kind}_int8_requant") == n_calls * jcfg.num_layers
    narrow = [k for dt, k in fed if dt == torch.int8]
    assert len(narrow) == n_calls * jcfg.num_layers and set(narrow) == {jcfg.d_ff}
    for g, w in zip(got, want):
        assert_scaled_close(torch.from_numpy(g), w, 5e-2)


# ------------------------------------------------------- the other configs
@pytest.mark.parametrize("arch", ["starcoder2_3b", "mistral_large_123b"])
def test_other_dense_configs_match_the_reference(arch):
    jcfg = _cfg(arch, name=f"dense-{arch}")
    assert port_config(jcfg) == dataclasses.replace(
        tserving.config_from_manifest({"config": {"arch": arch}}), dtype="float32",
        name=f"dense-{arch}")
    jp = _init(jax.random.PRNGKey(7), jcfg)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        want = jforward(jp, jcfg, jnp.asarray(tokens))
    with td.use_dispatch(backend="torch"):
        got = tforward(port_params(jp), port_config(jcfg), torch.from_numpy(tokens))
    assert_scaled_close(got, want, 1e-4)


def test_launcher_serves_gemma3_static_gather_on_cpu(capsys):
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--smoke", "--sparsity", "2:4", "--mode", "gather", "--quantize",
            "int8", "--static-scales", "--kernel-backend", "cuda", "--requests", "2",
            "--new-tokens", "2"]
    rep = serve.main(argv + ["--device", "cpu"])
    assert rep.completed == 2 and all(len(s.tokens) == 2 for s in rep.stats)
    out = capsys.readouterr().out
    assert "serving gemma3-1b" in out and "calibrated for 12 linear site(s)" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(argv)
