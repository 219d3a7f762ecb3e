"""The port's paged model path against ``repro.models.paged``.

On internlm2's smoke config, in the dense, 2:4 and 1:4 layouts and the
gather layout at 2:4 and 1:4, with the
JAX package's params carried across by ``interop.params_from_numpy``:
two requests are prefilled in chunks (one request per call, as the
engine does), then two batched decode steps run, the second with one
slot idle.  The logits of every call are compared:

- port ``torch`` tier vs JAX ``jnp`` tier, fp32 config: <= 1e-4 scaled
  (summation order, libm differences in rope/softmax);
- port ``torch`` vs JAX ``jnp`` and port ``cuda`` (each kernel's plain
  version, on CPU tensors) vs JAX ``interpret`` (the Pallas kernels),
  bf16 config: <= 3e-2 scaled (bf16 roundings of every activation, in
  different places in the two frameworks, compounded over the stack).

w8a8 (int8 weights, activations quantized per row at every site): the
port's ``cuda`` tier (the int8 kernels' plain versions, on CPU tensors)
against the JAX ``interpret`` tier (the int8 Pallas kernels), on the
smoke config widened to head_dim 32 and d_model 128 so that every site
plans an int8 kernel in both packages (the TPU int8 kernels tile 1:4
only at K multiples of 128):

- fp32 config <= 2e-3 scaled: the accumulators are exact and the flush
  is the same fp32 ops, so the logits agree to ~3e-7 until a 1-ulp
  upstream difference (rope, softmax) flips one int8 activation code at
  a rounding boundary, which moves its products by x_scale * |w|; one
  such flip shows as 1.2e-3 (2:4, the third prefill chunk);
- bf16 config <= 3e-2 scaled, as for the float bf16 tiers.
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
from repro.models import paged as jpaged
from repro_torch import kernels
from repro_torch.kernels import dispatch as td
from repro_torch.models import paged as tpaged
from torch_parity import assert_scaled_close, port_config, port_params

LAYOUTS = {"dense": JSp(mode="dense"), "2:4": JSp(n=2, m=4, mode="compressed"),
           "1:4": JSp(n=1, m=4, mode="compressed"),
           "gather-2:4": JSp(n=2, m=4, mode="gather"),
           "gather-1:4": JSp(n=1, m=4, mode="gather")}
W8A8_LAYOUTS = ("dense", "2:4", "1:4")   # the gather layout's: test_torch_gather_model.py
TIERS = [("jnp", "torch", "float32", 1e-4), ("jnp", "torch", "bfloat16", 3e-2),
         ("interpret", "cuda", "bfloat16", 3e-2)]
BLOCK_LEN, WIDTH = 8, 4
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])
CHUNK = 6
DECODE_FEED = ([42, 7], [99, 0])


def _run(p, mod, params, cfg, caches, asarray):
    """Prefill both prompts in chunks, then two batched decode steps fed
    fixed tokens (so a near-tied argmax in one package cannot change the
    other's inputs); returns every call's logits as float32 numpy.  ``p``
    names the package; ``asarray`` builds that package's int arrays."""
    outs = []
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for s, prompt in enumerate(PROMPTS):
        for off in range(0, len(prompt), CHUNK):
            c = min(CHUNK, len(prompt) - off)
            tok = asarray(np.array([prompt[off:off + c]]))
            args = (tok, off, asarray(table[s:s + 1]), c) if p == "torch" else (
                tok, jnp.int32(off), asarray(table[s:s + 1]), jnp.int32(c),
                jnp.int32(s))
            logits, caches = mod.paged_prefill_chunk(params, caches, *args, cfg,
                                                     BLOCK_LEN)
            outs.append(_f32(logits[0, :c]))
    pos = np.array([len(q) for q in PROMPTS])
    for feed, active in zip(DECODE_FEED, ([True, True], [True, False])):
        logits, caches = mod.paged_decode_step(
            params, caches, asarray(np.array(feed)[:, None]), asarray(pos),
            asarray(table), asarray(np.array(active)), cfg, BLOCK_LEN)
        outs.append(_f32(logits[:, 0])[np.array(active)])
        pos = pos + 1
    return outs


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


_PARAMS = {}


def _params(layout: str, dtype: str):
    """JAX params for one (layout, dtype), shared by the tiers."""
    if (layout, dtype) not in _PARAMS:
        jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype=dtype,
                                   sparsity=LAYOUTS[layout])
        _PARAMS[layout, dtype] = jcfg, _jit_init(jax.random.PRNGKey(0), jcfg)
    return _PARAMS[layout, dtype]


_jit_init = jax.jit(init_params, static_argnums=1)


@pytest.mark.parametrize("jax_backend,port_backend,dtype,tol", TIERS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_paged_logits_match_reference(layout, jax_backend, port_backend, dtype, tol):
    jcfg, jp = _params(layout, dtype)
    tcfg, tp = port_config(jcfg), port_params(jp)
    nb = 2 * WIDTH + 1
    # the JAX package reads the dispatch backend while tracing its jitted
    # steps: a config named per backend keeps each backend's traces apart
    jcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-{jax_backend}")
    with jd.use_dispatch(backend=jax_backend):
        want = _run("jax", jpaged, jp, jcfg,
                    jpaged.init_paged_caches(jcfg, nb, BLOCK_LEN, 2), jnp.asarray)
    with td.use_dispatch(backend=port_backend), torch.inference_mode():
        got = _run("torch", tpaged, tp, tcfg,
                   tpaged.init_paged_caches(tcfg, nb, BLOCK_LEN),
                   lambda a: torch.from_numpy(np.array(a)))
    assert len(got) == len(want) == 5   # 3 prefill chunks + 2 decode steps
    for g, w in zip(got, want):
        assert_scaled_close(g, w, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("layout", W8A8_LAYOUTS)
def test_w8a8_logits_match_the_int8_pallas_kernels(layout, dtype, tol, monkeypatch):
    sp = LAYOUTS[layout]
    jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype=dtype,
                               head_dim=32, d_model=128, sparsity=sp,
                               name=f"w8a8-{layout}-{dtype}")
    spec = jserving.ServingSpec(layout=sp.mode, qdtype="int8",
                                sparsity=None if sp.n == 4 else (sp.n, 4))
    jq = jserving.prepare(_jit_init(jax.random.PRNGKey(0), jcfg), spec, cfg=jcfg).params
    tcfg, tq = port_config(jcfg), port_params(jq)
    with jd.use_dispatch(backend="interpret"):
        assert not [ln for ln in jd.dispatch_report(jq, (2, CHUNK), jcfg.sparsity)[:-1]
                    if "_int8[interpret]" not in ln]
    lines = td.dispatch_report(tq, (2, CHUNK), tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    assert lines and all("_int8[cuda]" in ln for ln in lines)
    # the int8 wrappers run (their plain versions, on CPU tensors)
    calls = []
    for name in ("tile_gemm_int8", "tile_gemm_dual_int8", "nm_spmm_int8",
                 "nm_spmm_dual_int8"):
        mod = kernels._tile_gemm if name.startswith("tile") else kernels._nm_spmm
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    nb = 2 * WIDTH + 1
    with jd.use_dispatch(backend="interpret"):
        want = _run("jax", jpaged, jq, jcfg,
                    jpaged.init_paged_caches(jcfg, nb, BLOCK_LEN, 2), jnp.asarray)
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = _run("torch", tpaged, tq, tcfg,
                   tpaged.init_paged_caches(tcfg, nb, BLOCK_LEN),
                   lambda a: torch.from_numpy(np.array(a)))
    kind = "tile_gemm" if layout == "dense" else "nm_spmm"
    assert {f"{kind}_int8", f"{kind}_dual_int8"} == set(calls)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_scaled_close(g, w, tol)


def test_params_from_numpy_unstacks_layers_in_scan_order():
    jcfg, jp = _params("dense", "bfloat16")
    tp = port_params(jp)
    assert len(tp["layers"]) == jcfg.num_layers
    stacked = np.asarray(jp["stages"][0]["slot0"]["mixer"]["wq"]["w"])  # (L, 1, K, O)
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(
            layer["mixer"]["wq"]["w"].view(torch.int16).numpy(),
            stacked[i, 0].view(np.int16))
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"]["gamma"].dtype == torch.float32
    assert tuple(tp["unembed"].shape) == (jcfg.d_model, jcfg.vocab_size)
