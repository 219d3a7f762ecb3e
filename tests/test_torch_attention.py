"""The port's attention path against the JAX package's.

- ``flash_attention``'s plain version (``kernels/flash_attention/ref.py``,
  the CUDA kernel's formulation: top-left causal mask, online softmax
  over 64-key blocks, p in the value dtype for the PV product) against
  the Pallas kernel in interpret mode (``flash_attention_op``, GQA by
  repeat) at Tq == Tk, where the two masks agree: fp32 <= 1e-5 scaled
  (summation order and block size), bf16 <= 2e-2 (p rounded to bf16 over
  blocks of another size, and the output's one bf16 rounding).
- ``dispatch.attention``'s decisions against ``repro.kernels.dispatch``:
  the same declines (autodiff, the reference tier, Tq != Tk, a query
  offset), and where the Hopper contract differs (bf16 only, head_dim in
  ``HEAD_DIMS``: 64, 80, 96, 128, 256) the port declines with
  NO_KERNEL_FITS, pinned below; non-causal, the same paths, and the
  kernel's plain version gives the Pallas kernel's output.
- ``chunked_attention`` and ``transformer.forward`` logits against the
  JAX package's on its jnp tier (the port's torch tier): fp32 <= 1e-4
  scaled, bf16 <= 3e-2, float dense and 2:4.

The CUDA kernel is held to its plain version on the card by the ``cuda``
tests of ``tests/test_torch_kernels.py`` (which import no JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.kernels import dispatch as jd
from repro.kernels.flash_attention.ops import flash_attention_op
from repro.models import forward as j_forward
from repro.models import init_params
from repro.models.attention import chunked_attention as j_chunked
from repro_torch import kernels
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.reasons import ReasonCode
from repro_torch.models import forward as t_forward
from repro_torch.models.attention import chunked_attention as t_chunked
from torch_parity import (assert_scaled_close, from_np, jnp_dtype, port_config,
                          port_params)

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [64, 128])
def test_flash_plain_matches_the_pallas_kernel(t, dtype):
    q, k, v = _qkv(0, 2, 4, 2, t, 64)                   # GQA: Hq / Hkv = 2
    jdt = jnp_dtype(dtype)
    want = flash_attention_op(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                              causal=True, interpret=True)
    got = flash_attention_ref(*(from_np(a, dtype) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype)
    assert_scaled_close(got, want, TOLS[dtype])


def test_flash_wrapper_takes_the_plain_version_on_cpu_and_never_counts():
    q, k, v = (from_np(a, "bfloat16") for a in _qkv(1, 1, 4, 2, 40, 64))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v)
    assert torch.equal(got, flash_attention_ref(q, k, v))
    assert kernels.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention(q, k[:, :, :8], v)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention(q[:, :3], k, v)              # Hq not a multiple of Hkv


def _grouped_inputs(seed, b, hkv, g, t, d, dtype):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((b, hkv, g, t, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    return qg, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset,tq", [(0, 64), (32, 32)])
def test_chunked_attention_matches_the_reference(dtype, q_offset, tq):
    qg, k, v = _grouped_inputs(2, 2, 2, 2, 64, 32, dtype)
    qg = qg[:, :, :, :tq]
    jdt = jnp_dtype(dtype)
    want = j_chunked(*(jnp.asarray(a).astype(jdt) for a in (qg, k, v)), True, 16, q_offset)
    got = t_chunked(*(from_np(a, dtype) for a in (qg, k, v)), q_offset=q_offset)
    assert_scaled_close(got, want, 1e-5 if dtype == "float32" else 2e-2)


# (B, Hkv, G, Tq, Tk, D, dtype, q_offset, differentiating, JAX backend)
ATTN_CASES = [
    (1, 2, 2, 64, 64, 64, "bfloat16", 0, False, "interpret"),     # the kernel
    (1, 2, 2, 40, 40, 128, "bfloat16", 0, False, "interpret"),    # ragged T
    (1, 2, 2, 32, 64, 64, "bfloat16", 32, False, "interpret"),    # query offset
    (1, 2, 2, 64, 64, 64, "bfloat16", 0, True, "interpret"),      # autodiff
    (1, 2, 2, 64, 64, 64, "bfloat16", 0, False, "jnp"),           # reference tier
    (1, 2, 2, 64, 64, 64, "float32", 0, False, "interpret"),      # Hopper: bf16 only
    (1, 2, 2, 64, 64, 32, "bfloat16", 0, False, "interpret"),     # Hopper: D in HEAD_DIMS
    (1, 2, 2, 40, 40, 80, "bfloat16", 0, False, "interpret"),     # hubert's D, ragged T
    (1, 2, 2, 64, 64, 96, "bfloat16", 0, False, "interpret"),     # phi-3-vision's D
]
BACKENDS = {"interpret": "cuda", "jnp": "torch"}


@pytest.mark.parametrize("b,hkv,g,tq,tk,d,dtype,q_offset,diff,jb", ATTN_CASES)
def test_attention_dispatch_declines_like_the_reference(b, hkv, g, tq, tk, d, dtype,
                                                        q_offset, diff, jb, monkeypatch):
    _dispatch_parity(b, hkv, g, tq, tk, d, dtype, q_offset, diff, jb, True, monkeypatch)


# (B, Hkv, G, Tq, Tk, D, dtype, q_offset, differentiating, JAX backend): the
# encoder's non-causal attention, on the kernel and on the reference tier
NONCAUSAL_CASES = [
    (2, 2, 2, 40, 40, 80, "bfloat16", 0, False, "interpret"),     # ragged T, GQA
    (1, 4, 1, 64, 64, 80, "bfloat16", 0, False, "jnp"),
]


@pytest.mark.parametrize("b,hkv,g,tq,tk,d,dtype,q_offset,diff,jb", NONCAUSAL_CASES)
def test_noncausal_attention_dispatch_matches_the_reference(b, hkv, g, tq, tk, d, dtype,
                                                            q_offset, diff, jb, monkeypatch):
    _dispatch_parity(b, hkv, g, tq, tk, d, dtype, q_offset, diff, jb, False, monkeypatch)


def _dispatch_parity(b, hkv, g, tq, tk, d, dtype, q_offset, diff, jb, causal, monkeypatch):
    """The two engines' plans and paths for one attention call; where the
    JAX package runs, its output within the bf16 limit of TOLS."""
    import repro.models.attention as jattn
    import repro_torch.models.attention as tattn

    jdec = jd.plan(jd.GemmProblem("attention", b=tq, ke=tk, o=d, dtype=jnp_dtype(dtype),
                                  differentiating=diff), dispatch=jd.DispatchConfig(backend=jb))
    tdec = td.plan(td.GemmProblem("attention", b=tq, ke=tk, o=d, dtype=getattr(torch, dtype),
                                  differentiating=diff),
                   dispatch=td.DispatchConfig(backend=BACKENDS[jb]))
    # where the Hopper kernel's contract differs from the TPU kernel's fit
    hopper = jb == "interpret" and not diff and (dtype != "bfloat16" or d not in HEAD_DIMS)
    if hopper:
        assert jdec.uses_kernel and tdec.reason_code is ReasonCode.NO_KERNEL_FITS
    else:
        assert tdec.reason_code.value == jdec.reason_code.value
        assert tdec.uses_kernel == jdec.uses_kernel
    # which path attention() takes: the chunked fallback or the kernel
    ran = {"jax": [], "torch": []}
    jreal, treal = jattn.chunked_attention, tattn.chunked_attention
    monkeypatch.setattr(jattn, "chunked_attention",
                        lambda *a, **kw: ran["jax"].append(1) or jreal(*a, **kw))
    monkeypatch.setattr(tattn, "chunked_attention",
                        lambda *a, **kw: ran["torch"].append(1) or treal(*a, **kw))
    qg, k, v = _grouped_inputs(3, b, hkv, g, tk, d, dtype)
    qg = qg[:, :, :, :tq]
    want = None
    if not diff:
        with jd.use_dispatch(backend=jb):
            want = jd.attention(*(jnp.asarray(a).astype(jnp_dtype(dtype)) for a in (qg, k, v)),
                                causal=causal, chunk=16, q_offset=q_offset)
    tq_, tk_, tv_ = (from_np(a, dtype) for a in (qg, k, v))
    if diff:
        tq_.requires_grad_(True)
    with td.use_dispatch(backend=BACKENDS[jb]):
        out = td.attention(tq_, tk_, tv_, causal=causal, q_offset=q_offset)
    assert out.shape == qg.shape
    want_chunked = not tdec.uses_kernel or tq != tk or q_offset != 0
    assert bool(ran["torch"]) == want_chunked
    if jb == "interpret" and not diff and not hopper:
        assert ran["jax"] == ran["torch"]
    if want is not None:
        assert_scaled_close(out.detach(), want, TOLS["bfloat16"])


LAYOUTS = {"dense": JSp(mode="dense"), "2:4": JSp(n=2, m=4, mode="compressed")}
_jit_init = jax.jit(init_params, static_argnums=1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_logits_match_the_reference(layout, dtype, tol):
    jcfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype=dtype,
                               sparsity=LAYOUTS[layout], attn_chunk=8)
    jp = _jit_init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 24))
    with jd.use_dispatch(backend="jnp"):
        want = j_forward(jp, jcfg, tokens=jnp.asarray(tokens))
    with td.use_dispatch(backend="torch"), torch.inference_mode():
        got = t_forward(port_params(jp), port_config(jcfg), torch.from_numpy(tokens))
    assert got.shape == (2, 24, jcfg.vocab_size)
    assert_scaled_close(got, want, tol)
