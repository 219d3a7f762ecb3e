"""The port's gather layout end to end against the JAX package.

- Model: w8a8 and fp8, dynamic and static scales, prefill and decode
  logits of the port's cuda tier (the gather kernels' plain versions on
  CPU tensors) against the JAX interpret tier (the Pallas gather
  kernels), fp32 config within 2e-3 scaled (as for the other quantized
  layouts, tests/test_torch_model.py: the codes agree until a one-ulp
  upstream difference moves one activation across a rounding boundary),
  on the smoke config widened so that every site tiles in both packages:
  d_model 128 / head_dim 32 at 2:4, d_model 256 / head_dim 64 / d_ff 256
  at 1:4 (the port's kernels need K * n / 4 multiples of 64).  Weights
  start dense and ``prepare`` votes each site's own indices, so gate and
  up gather through different index streams.  The float gather logits
  (fp32 and bf16) are cases of tests/test_torch_model.py.
- End to end: the JAX CLI writes a gather 2:4/int8 artifact of
  ``tests/fixtures/hf_tiny``; the port's torch tier serves the JAX jnp
  tier's token streams on it, every token equal.  The launcher serves
  ``--mode gather`` on the CPU.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.kernels import dispatch as jd
from repro.launch import convert as convert_cli
from repro.models import init_params
from repro.models import paged as jpaged
from repro_torch import kernels
from repro_torch import serving as tserving
from repro_torch.kernels import dispatch as td
from repro_torch.models import paged as tpaged
from torch_parity import assert_scaled_close, port_config, port_params

QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


BLOCK_LEN, WIDTH, CHUNK = 8, 4, 6
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])
DECODE_FEED = ([42, 7], [99, 0])
WIDE = {2: dict(d_model=128, head_dim=32), 1: dict(d_model=256, head_dim=64, d_ff=256)}
_jit_init = jax.jit(init_params, static_argnums=1)


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
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 1])
def test_quantized_gather_logits_match_the_pallas_gather_kernels(n, qdtype, static,
                                                                 monkeypatch):
    dense = dataclasses.replace(get_smoke_config("internlm2_1_8b"), dtype="float32",
                                name=f"gather-{n}-{qdtype}-{static}", **WIDE[n])
    jcfg = dataclasses.replace(dense, sparsity=JSp(n=n, m=4, mode="gather"))
    spec = dict(layout="gather", sparsity=(n, 4), qdtype=qdtype, static_scales=static)
    calib = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 16))
    with jd.use_dispatch(backend="jnp"):
        jq = jserving.prepare(_jit_init(jax.random.PRNGKey(0), dense),
                              jserving.ServingSpec(**spec), cfg=jcfg,
                              calib_tokens=jnp.asarray(calib) if static else None).params
    tcfg, tq = port_config(jcfg), port_params(jq)
    with jd.use_dispatch(backend="interpret"):
        assert not [ln for ln in jd.dispatch_report(jq, (2, CHUNK), jcfg.sparsity)
                    if " global " in ln and f"nm_spmm_gather_{qdtype}[interpret]" not in ln]
    lines = td.dispatch_report(tq, (2, CHUNK), tcfg.sparsity,
                               dispatch=td.DispatchConfig(backend="cuda"))
    acts = "act-scales=static" if static else "act-scales=dynamic"
    assert lines and all(f"nm_spmm_gather_{qdtype}[cuda]" in ln and acts in ln
                         for ln in lines)
    dual = f"nm_spmm_gather_dual_bk_{qdtype}" + ("_requant" if static else "")
    calls, fed = [], []
    for name in (f"nm_spmm_gather_bk_{qdtype}", dual):
        real = getattr(kernels._nm_spmm_gather, name)
        monkeypatch.setattr(kernels._nm_spmm_gather, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    real_mm = td.sparse_matmul
    monkeypatch.setattr(td, "sparse_matmul", lambda x, *a, **k:
                        fed.append((x.dtype, x.shape[-1])) or real_mm(x, *a, **k))
    nb = 2 * WIDTH + 1
    with jd.use_dispatch(backend="interpret"):
        want = _run_paged("jax", jpaged, jq, jcfg,
                          jpaged.init_paged_caches(jcfg, nb, BLOCK_LEN, 2), jnp.asarray)
    with td.use_dispatch(backend="cuda"), torch.inference_mode():
        got = _run_paged("torch", tpaged, tq, tcfg,
                         tpaged.init_paged_caches(tcfg, nb, BLOCK_LEN),
                         lambda a: torch.from_numpy(np.array(a)))
    assert set(calls) == {f"nm_spmm_gather_bk_{qdtype}", dual}
    # static: w_out (and only w_out, K = d_ff) receives narrow rows, one per dual
    narrow = [k for dt, k in fed if dt == QDT[qdtype]]
    assert len(narrow) == (calls.count(dual) if static else 0)
    assert set(narrow) <= {jcfg.d_ff}
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_scaled_close(g, w, 2e-3)


# --------------------------------------------------------------- artifact
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "hf_tiny"
TRACE_KW = dict(seed=0, num_requests=4, rate=1.0)


@pytest.fixture(scope="module")
def gather_artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("gather") / "art"
    rc = convert_cli.main(["--input", str(FIXTURE), "--output", str(out),
                           "--arch", "internlm2_1_8b", "--smoke", "--mode", "gather",
                           "--sparsity", "2:4", "--quantize", "int8"])
    assert rc == 0
    return out


def _tokens(engine_cls, prepared):
    trace = (jserving if engine_cls is jserving.Engine else tserving).make_poisson_trace(
        vocab_size=prepared.cfg.vocab_size, **TRACE_KW)
    return {str(s.rid): [int(t) for t in s.tokens] for s in engine_cls(prepared).run(trace).stats}


def test_port_serves_the_gather_artifact_like_the_reference(gather_artifact):
    with jd.use_dispatch(backend="jnp"):
        want = _tokens(jserving.Engine, jserving.prepare_from_artifact(gather_artifact))
    tprep = tserving.prepare_from_artifact(gather_artifact, backend="torch", device="cpu")
    assert tprep.spec.layout == "gather" and tprep.spec.qdtype == "int8"
    leaves = [lf for _, lf in td.iter_linear_items(tprep.params)]
    assert len(leaves) == 7 * tprep.cfg.num_layers
    assert all(lf["gather_idx"].dtype == torch.int32 and lf["values"].dtype == torch.int8
               for lf in leaves)
    assert all("gather: torch-reference" in ln for ln in tprep.dispatch_report())
    assert _tokens(tserving.Engine, tprep) == want


def test_launcher_serves_the_gather_layout(capsys):
    from repro_torch.launch import serve

    rep = serve.main(["--arch", "internlm2_1_8b", "--smoke", "--sparsity", "2:4",
                      "--mode", "gather", "--device", "cpu", "--kernel-backend", "cuda",
                      "--requests", "2", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert rep.completed == 2 and all(len(s.tokens) == 2 for s in rep.stats)
    assert "(2:4/gather)" in out and "nm_spmm_gather[cuda]" in out
    assert re.search(r"\[col\] 2:4 global \(B=\d+, K=64, O=32\) gather: torch-reference "
                     r"\(no registered kernel fits", out)
