"""The encoder and vision-prefix families in the port against the JAX
package: hubert-xlarge (a non-causal encoder over frame embeddings, head
dim 80, a gelu MLP) and phi-3-vision (a causal decoder with patch
embeddings in front of its text tokens, head dim 96, swiglu), through
``lm.make_prefill_step``.

- ``flash_attention``'s plain version, causal and not, against the Pallas
  kernel in interpret mode (``flash_attention_op``, GQA by repeat) at D in
  {80, 96}, T in {40, 64} (40 is not a multiple of the plain version's
  64-key block: a ragged last block), fp32 within 1e-5 and bf16 within
  2e-2 scaled, the limits of tests/test_torch_attention.py.
- ``chunked_attention(causal=False)`` against the JAX package's.
- The prefill logits on the smoke configs widened to the real head dims
  (hubert: 4 heads of 80, d_model 320; phi-3: 4 heads of 96, d_model 384;
  2 layers each): the port's torch tier against the JAX jnp tier in the
  dense, compressed 2:4 and gather 2:4 layouts, fp32 within 1e-4 and bf16
  within 3e-2 scaled (as tests/test_torch_model.py); dense bf16 also on the
  kernel tiers, the port's cuda tier (each kernel's plain version on CPU
  tensors, flash_attention's with the config's causal flag) against the
  JAX interpret tier (the Pallas kernels).
- w8a8 (dynamic) gather 2:4: the port's cuda tier against the JAX
  interpret tier (the Pallas int8 gather kernels), fp32 config within
  2e-3 scaled (tests/test_torch_gather_model.py's limit), on configs where
  every site tiles in both packages: hubert at d_model 128 with 8 heads of
  80 (the port's gather kernels need K * n / 4 multiples of 64, so
  d_model 320 would leave wq, wk, wv and wo on the torch tier), phi-3 at
  its widened d_model 384.
- ``init_params`` and ``interop.params_from_numpy`` on an audio tree
  (``frame_proj``, no ``embed``, the layers unstacked) and a vlm tree;
  ``build_layout`` gives both families the dense layout; ``prepare``
  refuses static scales for an embedding frontend.

The CUDA kernel is held to its plain version on the card (D 80 non-causal,
D 96 causal, ragged T) by the ``cuda`` tests of
tests/test_torch_kernels.py, which import no JAX.
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
from repro.kernels.flash_attention.ops import flash_attention_op
from repro.models import init_params
from repro.models import transformer as jtr
from repro.models.attention import chunked_attention as j_chunked
from repro.models.lm import make_prefill_step as j_prefill_step
from repro_torch import serving as tserving
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import init_paged_caches
from repro_torch.models import init_params as t_init_params
from repro_torch.models import make_prefill_step as t_prefill_step
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import chunked_attention as t_chunked
from torch_parity import (assert_scaled_close, from_np, jnp_dtype, port_config,
                          port_params)

ATTN_TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
WIDE = {"hubert_xlarge": dict(d_model=320, num_heads=4, num_kv_heads=4, head_dim=80),
        "phi_3_vision_4_2b": dict(d_model=384, num_heads=4, num_kv_heads=4, head_dim=96)}
# every site on a kernel in both packages (module docstring)
W8A8_WIDE = {"hubert_xlarge": dict(d_model=128, num_heads=8, num_kv_heads=8, head_dim=80),
             "phi_3_vision_4_2b": WIDE["phi_3_vision_4_2b"]}
LAYOUTS = {"dense": JSp(mode="dense"), "2:4": JSp(n=2, m=4, mode="compressed"),
           "gather-2:4": JSp(n=2, m=4, mode="gather")}
TIERS = [("jnp", "torch", "float32", 1e-4), ("jnp", "torch", "bfloat16", 3e-2)]
B, FRAMES, TEXT = 2, 40, 16
_jit_init = jax.jit(init_params, static_argnums=1)


def _qkv(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("t", [40, 64])
@pytest.mark.parametrize("d", [80, 96])
def test_flash_plain_matches_the_pallas_kernel(d, t, causal, dtype):
    q, k, v = _qkv(d + t, 2, 4, 2, t, d)                  # GQA: Hq / Hkv = 2
    jdt = jnp_dtype(dtype)
    want = flash_attention_op(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                              causal=causal, interpret=True)
    got = flash_attention_ref(*(from_np(a, dtype) for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    assert_scaled_close(got, want, ATTN_TOLS[dtype])


def test_noncausal_flash_differs_from_causal():
    """The flag reaches the plain version: row 0 of a causal run sees key 0
    alone (its output is v[0]), the non-causal run averages every key."""
    q, k, v = (from_np(a, "float32") for a in _qkv(5, 1, 2, 2, 40, 80))
    causal = tflash.flash_attention(q, k, v)
    full = tflash.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(causal[:, :, 0], v[:, :, 0])
    assert not torch.allclose(full[:, :, 0], v[:, :, 0], atol=1e-2)
    torch.testing.assert_close(full, flash_attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_chunked_attention_matches_the_reference(dtype):
    rng = np.random.default_rng(6)
    qg, k, v = (rng.standard_normal(s).astype(np.float32)
                for s in ((2, 2, 2, 48, 80), (2, 48, 2, 80), (2, 48, 2, 80)))
    jdt = jnp_dtype(dtype)
    want = j_chunked(*(jnp.asarray(a).astype(jdt) for a in (qg, k, v)), False, 16)
    got = t_chunked(*(from_np(a, dtype) for a in (qg, k, v)), causal=False)
    assert_scaled_close(got, want, 1e-5 if dtype == "float32" else 2e-2)
    causal = t_chunked(*(from_np(a, dtype) for a in (qg, k, v)))
    assert not torch.allclose(causal.float(), got.float(), atol=1e-2)


def _jax_cfg(arch, dtype, layout):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype, sparsity=LAYOUTS[layout],
                               **WIDE[arch])


_PARAMS = {}


def _jax_params(arch, dtype, layout):
    """JAX params of one (arch, layout), made once in fp32; a bf16 config
    gets them cast (the norms' gammas stay fp32, as JAX's init keeps them)."""
    if (arch, layout) not in _PARAMS:
        _PARAMS[arch, layout] = _jit_init(jax.random.PRNGKey(0),
                                          _jax_cfg(arch, "float32", layout))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if a.dtype != jnp.float32 or "gamma" in jax.tree_util.keystr(path)
        else a.astype(jnp_dtype(dtype)), _PARAMS[arch, layout])


def _batch(cfg, seed=7):
    """Seeded numpy inputs of one prefill batch: frames (B, 40, d), or 8
    patches (B, P, d) at the embedding table's scale and 16 text tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)}
    return {"patches": (rng.standard_normal((B, cfg.num_patches, cfg.d_model))
                        * cfg.d_model ** -0.5).astype(np.float32),
            "tokens": rng.integers(1, cfg.vocab_size, (B, TEXT))}


def _as_jax(batch, cfg):
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v).astype(cfg.jnp_dtype)
            for k, v in batch.items()}


def _as_torch(batch, cfg):
    return {k: torch.from_numpy(v) if k == "tokens" else from_np(v, cfg.dtype)
            for k, v in batch.items()}


def _seq_len(cfg):
    return FRAMES if cfg.frontend == "audio_frames" else cfg.num_patches + TEXT


@pytest.mark.parametrize("jax_backend,port_backend,dtype,tol", TIERS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", list(WIDE))
def test_prefill_logits_match_the_reference(arch, layout, jax_backend, port_backend, dtype,
                                            tol):
    jcfg = _jax_cfg(arch, dtype, layout)
    jp = _jax_params(arch, dtype, layout)
    batch = _batch(jcfg)
    with jd.use_dispatch(backend=jax_backend):
        want = j_prefill_step(jcfg)(jp, _as_jax(batch, jcfg))
    tcfg = port_config(jcfg)
    with td.use_dispatch(backend=port_backend), torch.inference_mode():
        got = t_prefill_step(tcfg)(port_params(jp), _as_torch(batch, jcfg))
    assert got.shape == (B, _seq_len(jcfg), jcfg.vocab_size)
    assert_scaled_close(got, want, tol)


@pytest.mark.parametrize("arch", list(WIDE))
def test_prefill_logits_match_the_pallas_kernels(arch, monkeypatch):
    """Dense bf16 on the kernel tiers: every layer's attention takes the
    flash kernel (its plain version here) with the config's causal flag."""
    jcfg = _jax_cfg(arch, "bfloat16", "dense")
    jp = _jax_params(arch, "bfloat16", "dense")
    batch = _batch(jcfg)
    with jd.use_dispatch(backend="interpret"):
        want = j_prefill_step(jcfg)(jp, _as_jax(batch, jcfg))
    flags = []
    real = tflash.flash_attention_ref
    monkeypatch.setattr(tflash, "flash_attention_ref",
                        lambda *a, causal=True: flags.append(causal) or real(*a, causal=causal))
    tcfg = port_config(jcfg)
    lines = td.dispatch_report(port_params(jp), (B * _seq_len(jcfg),), tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    assert lines and all("tile_gemm[cuda]" in ln for ln in lines)
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = t_prefill_step(tcfg)(port_params(jp), _as_torch(batch, jcfg))
    assert flags == [jcfg.causal] * jcfg.num_layers
    assert_scaled_close(got, want, 3e-2)


@pytest.mark.parametrize("arch", list(W8A8_WIDE))
def test_w8a8_gather_prefill_logits_match_the_pallas_int8_kernels(arch):
    dense = dataclasses.replace(get_smoke_config(arch), dtype="float32", **W8A8_WIDE[arch])
    jcfg = dataclasses.replace(dense, sparsity=LAYOUTS["gather-2:4"])
    spec = dict(layout="gather", sparsity=(2, 4), qdtype="int8")
    with jd.use_dispatch(backend="jnp"):
        jq = jserving.prepare(_jit_init(jax.random.PRNGKey(0), dense),
                              jserving.ServingSpec(**spec), cfg=jcfg).params
    rows = (B * _seq_len(jcfg),)
    with jd.use_dispatch(backend="interpret"):
        assert not [ln for ln in jd.dispatch_report(jq, rows, jcfg.sparsity)
                    if " global " in ln and "nm_spmm_gather_int8[interpret]" not in ln]
    tcfg, tq = port_config(jcfg), port_params(jq)
    lines = td.dispatch_report(tq, rows, tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    assert lines and all("nm_spmm_gather_int8[cuda]" in ln and "act-scales=dynamic" in ln
                         for ln in lines)
    batch = _batch(jcfg)
    with jd.use_dispatch(backend="interpret"):
        want = j_prefill_step(jcfg)(jq, _as_jax(batch, jcfg))
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = t_prefill_step(tcfg)(tq, _as_torch(batch, jcfg))
    assert_scaled_close(got, want, 2e-3)


@pytest.mark.parametrize("arch", list(WIDE))
def test_build_layout_gives_the_encoder_families_the_dense_layout(arch):
    jcfg = get_smoke_config(arch)
    tcfg = port_config(jcfg)
    assert tcfg.family in ("audio", "vlm") and tcfg.is_encoder == (not jcfg.causal)
    want = [(st.count, [(s.mixer, s.ffn, s.repeat) for s in st.slots])
            for st in jtr.build_layout(jcfg)]
    got = [(st.count, [(s.mixer, s.ffn, s.repeat) for s in st.slots])
           for st in ttr.build_layout(tcfg)]
    assert got == want == [(jcfg.num_layers, [("attn", "mlp", 1)])]


@pytest.mark.parametrize("arch", list(WIDE))
def test_init_and_interop_carry_the_frontend_trees(arch):
    jcfg = get_smoke_config(arch)
    tcfg = port_config(jcfg)
    audio = jcfg.frontend == "audio_frames"
    own = t_init_params(torch.Generator().manual_seed(0), tcfg)
    jp = _jit_init(jax.random.PRNGKey(0), jcfg)
    tp = port_params(jp)
    for tree in (own, tp):
        assert ("frame_proj" in tree) == audio and ("embed" in tree) == (not audio)
        assert "stages" not in tree and len(tree["layers"]) == jcfg.num_layers
        assert tuple(tree["unembed"].shape) == (jcfg.d_model, jcfg.vocab_size)
    if audio:
        assert tuple(own["frame_proj"].shape) == (jcfg.d_model, jcfg.d_model)
        np.testing.assert_array_equal(tp["frame_proj"].float().numpy(),
                                      np.asarray(jp["frame_proj"], np.float32))
    else:
        np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                      np.asarray(jp["embed"], np.float32))
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(
            layer["mixer"]["wq"]["w"].float().numpy(),
            np.asarray(jp["stages"][0]["slot0"]["mixer"]["wq"]["w"][i, 0], np.float32))
        assert set(layer["ffn"]) == ({"w_in", "w_out"} if audio else
                                     {"w_in", "w_gate", "w_out"})


def test_prepare_refuses_static_scales_for_an_embedding_frontend():
    cfg = port_config(get_smoke_config("hubert_xlarge"))
    params = t_init_params(torch.Generator().manual_seed(0), cfg)
    spec = tserving.ServingSpec(qdtype="int8", static_scales=True)
    with pytest.raises(ValueError, match="frontend='audio_frames'"):
        tserving.prepare(params, spec, cfg=cfg, calib_tokens=torch.ones((1, 8), dtype=torch.long),
                         device="cpu")
    # without static scales the encoder prepares (int8 weights, dynamic rows)
    prepared = tserving.prepare(params, tserving.ServingSpec(qdtype="int8"), cfg=cfg,
                                device="cpu")
    assert prepared.params["layers"][0]["mixer"]["wq"]["w"].dtype == torch.int8


@pytest.mark.parametrize("arch,causal", [("hubert_xlarge", False), ("phi_3_vision_4_2b", True),
                                         ("internlm2_1_8b", False)],
                         ids=["audio", "vlm", "noncausal-tokens"])
def test_paged_serving_refuses_frontends_and_noncausal_configs(arch, causal):
    """The paged path embeds token ids and attends causally: an embedding
    frontend or a non-causal config is refused where the Engine is built
    and where its caches are, not deep inside a step."""
    cfg = dataclasses.replace(port_config(get_smoke_config(arch)), causal=causal)
    params = t_init_params(torch.Generator().manual_seed(0), cfg)
    prepared = tserving.prepare(params, tserving.ServingSpec(), cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="make_prefill_step"):
        tserving.Engine(prepared)
    with pytest.raises(ValueError, match="make_prefill_step"):
        init_paged_caches(cfg, 4, 8)


def test_launcher_refuses_the_audio_encoder():
    with pytest.raises(ValueError, match="frontend 'audio_frames'"):
        t_serve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu",
                      "--requests", "1", "--new-tokens", "1"])
