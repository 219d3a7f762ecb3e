"""The port's serving stack against ``repro.serving``.

- ``PagedScheduler``: admit, preempt and retire decisions, block tables
  and free lists are bitwise equal to the JAX package's under a seeded
  script of operations, for both admission policies.
- ``Engine``: fp32 greedy token streams equal the JAX Engine's on
  ``make_poisson_trace(seed=0)``, dense, 2:4 and gather 2:4, and the run's counters
  (model calls, prefill chunks, evictions, peak blocks) agree; also
  under optimistic admission with a budget small enough to evict.
- The port imports neither ``jax`` nor ``repro``; its entry points run on
  CUDA unless the caller asks for the CPU, and raise without a card.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.models import init_params
from repro.serving.scheduler import PagedScheduler as JScheduler
from repro.serving.scheduler import Request as JRequest
from repro_torch import serving as tserving
from repro_torch.serving.scheduler import PagedScheduler as TScheduler
from repro_torch.serving.scheduler import Request as TRequest
from torch_parity import port_config, port_params

ROOT = Path(__file__).resolve().parents[1]


def _state(s):
    return (s.table.tolist(), list(s.free), [list(o) for o in s.owned],
            s.evictions, s.max_blocks_in_use, s.blocks_in_use, s.headroom(),
            [None if st is None else (st.req.rid, st.seq, st.state)
             for st in s.slots],
            [st.req.rid for st in s.waiting], [st.req.rid for st in s.preempted])


@pytest.mark.parametrize("admission", ["reserve", "optimistic"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decisions_bitwise_equal(admission, seed):
    rng = np.random.default_rng(seed)
    kw = dict(slots=4, table_width=8, num_blocks=12, block_len=4, admission=admission)
    js, ts = JScheduler(**kw), TScheduler(**kw)
    rid = 0
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            plen, new = int(rng.integers(1, 12)), int(rng.integers(1, 12))
            prompt = tuple(int(t) for t in rng.integers(1, 100, plen))
            out = []
            for s, R in ((js, JRequest), (ts, TRequest)):
                try:
                    s.enqueue(R(rid=rid, prompt=prompt, max_new_tokens=new))
                    out.append("ok")
                except ValueError as e:
                    out.append(str(e))
            assert out[0] == out[1]
            rid += 1
        elif op == 1:
            assert js.admit_ready() == ts.admit_ready()
        elif op == 2 and js.running:
            s = int(rng.choice(js.running))
            st = js.slots[s]
            upto = min(len(st.req.prompt) + st.pos + int(rng.integers(0, 6)),
                       kw["table_width"] * kw["block_len"] - 1)
            ts_st = ts.slots[s]
            ts_st.pos, st.pos = st.pos + 1, st.pos + 1
            assert js.ensure_blocks(s, upto) == ts.ensure_blocks(s, upto)
        elif op == 3 and js.running:
            s = int(rng.choice(js.running))
            assert js.retire(s).req.rid == ts.retire(s).req.rid
        assert _state(js) == _state(ts)


def _engines(layout, sparsity, **spec_kw):
    base = dict(layout=layout, sparsity=sparsity, slots=4, max_len=64, block_len=8,
                prefill_chunk=8)
    base.update(spec_kw)
    jspec = jserving.ServingSpec(**base)
    jcfg = jspec.apply_to(dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                                              dtype="float32"))
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    tspec = tserving.ServingSpec(**base)
    tprep = tserving.prepare(port_params(jp), tspec, cfg=port_config(jcfg),
                             device="cpu")
    return (jserving.Engine(jserving.prepare(jp, jspec, cfg=jcfg)),
            tserving.Engine(tprep), jcfg.vocab_size)


def _counters(rep):
    return (rep.total, rep.completed, rep.model_calls, rep.prefill_chunks,
            rep.decode_calls, rep.evictions, rep.max_blocks_in_use, rep.num_blocks,
            [(s.rid, s.prompt_len, s.new_tokens, s.done_iter) for s in rep.stats])


@pytest.mark.parametrize("layout,sparsity,spec_kw", [
    ("dense", None, {}),
    ("compressed", (2, 4), {}),
    ("gather", (2, 4), {}),
    ("dense", None, {"admission": "optimistic", "kv_blocks": 5}),
])
def test_engine_token_streams_equal_reference(layout, sparsity, spec_kw):
    jeng, teng, vocab = _engines(layout, sparsity, **spec_kw)
    n = 6 if spec_kw else 4
    jrep = jeng.run(jserving.make_poisson_trace(seed=0, num_requests=n, vocab_size=vocab))
    trep = teng.run(tserving.make_poisson_trace(seed=0, num_requests=n, vocab_size=vocab))
    assert [s.tokens for s in trep.stats] == [s.tokens for s in jrep.stats]
    assert _counters(trep) == _counters(jrep)
    if spec_kw:
        assert trep.evictions > 0          # the budget really forced preemption


@pytest.mark.parametrize("layout,sparsity", [("dense", None), ("compressed", (2, 4)),
                                             ("compressed", (1, 4))])
def test_prepare_quantizes_like_the_reference(layout, sparsity):
    """Step 2 of prepare: every linear leaf bitwise the JAX package's."""
    jspec = jserving.ServingSpec(layout=layout, sparsity=sparsity, qdtype="int8")
    jcfg = jspec.apply_to(get_smoke_config("internlm2_1_8b"))
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    want = port_params(jserving.prepare(jp, jspec, cfg=jcfg).params)
    got = tserving.prepare(port_params(jp), tserving.ServingSpec(
        layout=layout, sparsity=sparsity, qdtype="int8"), cfg=port_config(jcfg),
        device="cpu").params
    pairs = list(zip(_flat(got), _flat(want)))
    assert pairs and len(_flat(got)) == len(_flat(want))
    for (kg, g), (kw, w) in pairs:
        assert kg == kw and g.dtype == w.dtype, (kg, kw)
        assert torch.equal(g.view(torch.uint8) if g.element_size() == 1 else g,
                           w.view(torch.uint8) if w.element_size() == 1 else w), kg
    assert sum(g.dtype == torch.int8 for _, g in _flat(got)) == 7 * jcfg.num_layers


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def test_int8_engine_runs_through_the_int8_kernels_on_cpu():
    """The cuda backend on CPU tensors: every fitting site plans an int8
    kernel and the engine serves the trace (the wrappers run their plain
    versions)."""
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "internlm2_1_8b", "--smoke", "--sparsity", "2:4",
                      "--quantize", "int8", "--device", "cpu", "--kernel-backend", "cuda",
                      "--requests", "2", "--new-tokens", "2"])
    assert rep.completed == 2 and all(len(s.tokens) == 2 for s in rep.stats)


def test_traffic_is_the_reference_trace():
    for seed in (0, 3):
        j = jserving.make_poisson_trace(seed=seed, num_requests=16, vocab_size=256)
        t = tserving.make_poisson_trace(seed=seed, num_requests=16, vocab_size=256)
        assert [dataclasses.astuple(r) for r in t] == [dataclasses.astuple(r) for r in j]


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.launch.serve\n"
        "import repro_torch.serving, repro_torch.models, repro_torch.configs\n"
        "import repro_torch.kernels.dispatch, repro_torch.kernels._build\n"
        "import repro_torch.kernels.tile_gemm.kernel, repro_torch.kernels.nm_spmm.kernel\n"
        "import repro_torch.core.quantize, repro_torch.checkpoint.store\n"
        "import repro_torch.kernels.tile_gemm.ref, repro_torch.kernels.nm_spmm.ref\n"
        "import repro_torch.kernels.nm_spmm_gather.kernel, repro_torch.kernels.actsparse\n"
        "import repro_torch.models.moe, repro_torch.configs.qwen3_moe_235b_a22b\n"
        "import repro_torch.configs.dbrx_132b, repro_torch.configs.gemma3_1b\n"
        "import repro_torch.configs.starcoder2_3b, repro_torch.configs.mistral_large_123b\n"
        "import repro_torch.models.lm, repro_torch.configs.hubert_xlarge\n"
        "import repro_torch.configs.phi_3_vision_4_2b\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_default_to_cuda():
    spec = tserving.ServingSpec()
    leaf = {"w": torch.zeros(64, 64)}
    if torch.cuda.is_available():
        assert tserving.prepare(leaf, spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.prepare(leaf, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.resolve_device(None)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "internlm2_1_8b", "--smoke"])
    assert tserving.prepare(leaf, spec, device="cpu").device.type == "cpu"


def test_prepare_converts_dense_leaves_like_the_reference():
    from repro.core.sparse_linear import convert_layout as j_convert
    w = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    spec = tserving.ServingSpec(layout="compressed", sparsity=(2, 4))
    got = tserving.prepare({"w": torch.from_numpy(w)}, spec, device="cpu").params
    want = j_convert({"w": jax.numpy.asarray(w)}, JSp(n=2, m=4, mode="compressed"),
                     "compressed")
    for k in ("values", "meta_packed"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_servingspec_validation():
    with pytest.raises(ValueError):
        tserving.ServingSpec(layout="rowwise")      # not ported yet
    assert tserving.ServingSpec(layout="gather", sparsity=(1, 4)).layout == "gather"
    assert tserving.ServingSpec(qdtype="fp8", static_scales=True).qdtype == "fp8"
    with pytest.raises(ValueError, match="unknown quantize target"):
        tserving.ServingSpec(qdtype="int4")
    assert tserving.ServingSpec(qdtype="int8").qdtype == "int8"
    with pytest.raises(ValueError):
        tserving.ServingSpec(backend="interpret")
    with pytest.raises(ValueError):
        tserving.ServingSpec(max_len=4, block_len=8)
    assert tserving.ServingSpec(max_len=64, block_len=8).table_width == 8
