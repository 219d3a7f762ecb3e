"""Tensor-parallel serving (``ServingSpec.mesh = (1, 2)``) against the JAX
package's sharded dispatch.

One module-scoped setup runs three things, two of them at once:

- a JAX subprocess with two host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=2``) and an
  ``Auto``-typed ``(1, 2)`` mesh: jax 0.9's ``jax.make_mesh`` defaults to
  ``Explicit`` axes, which the reference's ``with_sharding_constraint``
  refuses, so the mesh is built as the JAX package's own serving cannot.
  It runs ``apply_linear(gather="row" | "col")`` under the mesh
  (backend ``interpret``: the Pallas kernels inside ``shard_map``), the
  raw per-shard partials of the int8 row sites (``_partial_*_q``), and
  the unsharded paged logits and Engine tokens of the widened model;
- a gloo world of two ranks (``launch.mesh.spawn_ranks``, a file
  rendezvous, no port) running the port's sharded path on the same
  inputs: every wrapper takes its plain version on these CPU tensors, K11
  (``nm_spmm_gather_int8`` / ``_fp8`` raw) included;
- the rest here, in-process.

Width: d_model 512, d_ff 1024, 4 heads of 128 over 2 KV heads, 2 layers,
vocab 256, so the local K of a 1:4 row site still tiles in both packages.
Tolerances, scaled by max|reference|: per linear, fp32 and int8 outputs
1e-5 and fp8 1e-4 (the partials sum in another order; int8 partials and
their sum bitwise); model logits, port sharded vs JAX unsharded fp32
1e-4 (as tests/test_torch_model.py), port sharded vs port unsharded int8
/ fp8 1e-5 (the same codes: the row absmax is all-reduced); fp32 Engine
tokens equal on both ranks, to the unsharded port's and to JAX's.
Plans and reason codes under a shard are held bitwise to JAX's
``plan`` (whose ``ShardSpec`` reads only ``mesh.shape``: no devices).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import SparsityConfig as JSp
from repro.core.sparse_linear import convert_layout as j_convert
from repro.kernels import autotune as jautotune
from repro.kernels import dispatch as jd
from repro.models import init_params as j_init_params
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.reasons import ReasonCode
from repro_torch.launch import shardings
from repro_torch.models.pjit_utils import AxisEnv
from torch_parity import assert_scaled_close, port_config, port_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, O, B = 512, 256, 16
QDT = {"int8": "int8", "fp8": "float8_e4m3fn"}
# (mode, n, qdtype, hint): every layout and class at a row site, a sample
# of each at a column site
LINEAR_CASES = ([(mode, n, q, "row") for mode, n in (("dense", 4), ("compressed", 2),
                                                      ("gather", 2))
                 for q in (None, "int8", "fp8")]
                + [("gather", 1, q, "row") for q in ("int8", "fp8")]
                + [("dense", 4, None, "col"), ("compressed", 2, "int8", "col"),
                   ("gather", 2, "fp8", "col"), ("gather", 1, "int8", "col")])
RAW_CASES = [c for c in LINEAR_CASES if c[2] == "int8" and c[3] == "row"]
FP32_MODEL = ("dense", "gather")          # port sharded vs JAX unsharded, fp32
# (layout, n, qdtype, static): port sharded vs port unsharded
QUANT_MODEL = [("gather", 2, "int8", False), ("gather", 1, "fp8", True),
               ("compressed", 2, "int8", True), ("dense", 4, "fp8", False)]
BLOCK_LEN, WIDTH = 8, 4
PROMPTS = ([3, 17, 9, 41, 5, 28, 7, 11, 60, 2, 33, 8], [250, 1, 77, 13, 4, 90])
CHUNK = 6
DECODE_FEED = ([42, 7], [99, 0])


def _case_id(c):
    return f"{c[0]}-{c[1]}:4-{c[2] or 'fp32'}-{c[3]}"


def model_config(layout: str = "dense", n: int = 4):
    """The widened internlm2 smoke config (JAX package)."""
    sp = JSp(n=n, m=4, mode=layout) if layout != "dense" else JSp(mode="dense")
    return dataclasses.replace(get_smoke_config("internlm2_1_8b"), d_model=512, d_ff=1024,
                               num_heads=4, num_kv_heads=2, head_dim=128, num_layers=2,
                               vocab_size=256, dtype="float32", sparsity=sp)


def _pack(a) -> tuple:
    """An array as (bytes view, dtype name), so e4m3 crosses without ml_dtypes."""
    a = np.asarray(a)
    return (a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a,
            str(a.dtype))


def _torch(packed) -> torch.Tensor:
    a, name = packed
    t = torch.from_numpy(np.array(a))
    return t.view(torch.float8_e4m3fn) if "float8" in name else t


def paged_run(p, mod, params, cfg, caches, asarray):
    """Prefill both prompts in chunks (one request per call), then two
    batched decode steps fed fixed tokens, the second with one slot idle;
    every call's logits as float32 numpy (tests/test_torch_model.py)."""
    outs = []
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    f32 = (lambda a: a.float().numpy()) if p == "torch" else (
        lambda a: np.asarray(a, np.float32))
    for s, prompt in enumerate(PROMPTS):
        for off in range(0, len(prompt), CHUNK):
            c = min(CHUNK, len(prompt) - off)
            tok = asarray(np.array([prompt[off:off + c]]))
            args = (tok, off, asarray(table[s:s + 1]), c) if p == "torch" else (
                tok, jnp.int32(off), asarray(table[s:s + 1]), jnp.int32(c), jnp.int32(s))
            logits, caches = mod.paged_prefill_chunk(params, caches, *args, cfg, BLOCK_LEN)
            outs.append(f32(logits[0, :c]))
    pos = np.array([len(q) for q in PROMPTS])
    for feed, active in zip(DECODE_FEED, ([True, True], [True, False])):
        logits, caches = mod.paged_decode_step(
            params, caches, asarray(np.array(feed)[:, None]), asarray(pos),
            asarray(table), asarray(np.array(active)), cfg, BLOCK_LEN)
        outs.append(f32(logits[:, 0])[np.array(active)])
        pos = pos + 1
    return outs


SPEC = dict(slots=4, max_len=64, block_len=8, prefill_chunk=8)
N_REQUESTS = 4

# ----------------------------------------------------------- the JAX side
JAX_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro import serving as js
    from repro.core import SparsityConfig, apply_linear
    from repro.core import quantize as jq
    from repro.kernels import dispatch as jd
    from repro.launch.mesh import make_axis_env
    from repro.models import init_params
    from repro.models import paged as jpaged
    from repro.models.pjit_utils import use_axis_env
    import test_torch_shard as T

    inputs = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    env = make_axis_env(mesh)
    dt = {"int8": jnp.int8, "float8_e4m3fn": jnp.float8_e4m3fn}
    def arr(p):
        a, name = p
        return jnp.asarray(a.view(dt[name]) if name in dt and name != "int8" else a)
    out = {}
    for case in T.LINEAR_CASES:
        mode, n, q, hint = case
        cfg = SparsityConfig(n=n, m=4, mode=mode)
        x = jnp.asarray(inputs["x"])
        leaf = {k: arr(v) for k, v in inputs[T._case_id(case)].items()}
        with use_axis_env(env), jd.use_dispatch(backend="interpret"):
            y = apply_linear(leaf, x, cfg, gather=hint)
            d = jd.plan_for(leaf, x.shape, cfg, dtype=leaf.get("values", leaf.get("w")).dtype,
                            shard=jd.shard_spec_from_env(hint))
        assert d.placement == "shard_map", (case, jd.describe(d))
        out[T._case_id(case)] = np.asarray(y, np.float32)
        if case in T.RAW_CASES:
            entry = jd._entry_by_name(mode, d.kernel)
            xq, _ = jq.quantize_rows(x, dtype=jnp.int8)
            half = x.shape[1] // 2
            for r in (0, 1):
                local = {}
                for k, v in leaf.items():
                    if k in ("w", "values", "meta_packed", "gather_idx"):
                        rows = v.shape[0] // 2
                        local[k] = v[r * rows:(r + 1) * rows]
                    else:
                        local[k] = v
                xr = xq[:, r * half:(r + 1) * half]
                xr = jnp.pad(xr, ((0, jd._q_padded_b(xr.shape[0]) - xr.shape[0]), (0, 0)))
                acc = entry.run_quantized(xr, local, cfg, d.blocks, True)
                out[T._case_id(case) + f"/partial{r}"] = np.asarray(acc)
    for layout in T.FP32_MODEL:
        jcfg = T.model_config(layout, 2 if layout != "dense" else 4)
        params = init_params(jax.random.PRNGKey(0), jcfg)
        nb = 2 * T.WIDTH + 1
        with jd.use_dispatch(backend="jnp"):
            out["model/" + layout] = T.paged_run(
                "jax", jpaged, params, jcfg, jpaged.init_paged_caches(jcfg, nb, T.BLOCK_LEN, 2),
                jnp.asarray)
    jcfg = T.model_config()
    spec = js.ServingSpec(layout="dense", **T.SPEC)
    eng = js.Engine(js.prepare(init_params(jax.random.PRNGKey(0), jcfg), spec, cfg=jcfg))
    rep = eng.run(js.make_poisson_trace(seed=0, num_requests=T.N_REQUESTS,
                                        vocab_size=jcfg.vocab_size))
    out["engine"] = [s.tokens for s in rep.stats]
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("OK")
""")


# ---------------------------------------------------------- the port side
def port_world(rank, world, dev, tmp):
    """One rank of the port's (1, 2) mesh: every linear case, the model
    logits and the Engine, all sharded; rank 0 writes the results."""
    import torch.distributed as dist

    from repro_torch import serving
    from repro_torch.core.sparse_linear import apply_linear
    from repro_torch.launch.mesh import make_axis_env
    from repro_torch.launch.shardings import shard_leaf
    from repro_torch.models import paged as tpaged
    from repro_torch.models.pjit_utils import use_axis_env

    torch.set_num_threads(2)    # two ranks beside the JAX subprocess
    inputs = pickle.load(open(os.path.join(tmp, "inputs.pkl"), "rb"))
    env = make_axis_env((1, world))
    out = {}
    x = torch.from_numpy(inputs["x"])
    for case in LINEAR_CASES:
        mode, n, q, hint = case
        leaf = shard_leaf({k: _torch(v) for k, v in inputs[_case_id(case)].items()}, hint,
                          env, n)
        xr = x if hint == "col" else x.chunk(world, dim=1)[rank].contiguous()
        with use_axis_env(env), td.use_dispatch(backend="cuda"):
            y = apply_linear(leaf, xr, TSp(n=n, m=4, mode=mode), gather=hint)
        if hint == "col":    # assemble the columns: each rank adds its own block
            full = torch.zeros(B, O)
            full[:, rank * (O // world):(rank + 1) * (O // world)] = y
            dist.all_reduce(full)
            y = full
        out[_case_id(case)] = y.float().numpy()

    params = torch.load(os.path.join(tmp, "params.pt"), weights_only=False)
    nb = 2 * WIDTH + 1

    def logits(prepared, tcfg):
        with prepared.activate(), torch.inference_mode():
            return paged_run("torch", tpaged, prepared.params, tcfg,
                             tpaged.init_paged_caches(tcfg, nb, BLOCK_LEN),
                             lambda a: torch.from_numpy(np.array(a)))

    for layout in FP32_MODEL:
        tcfg = port_config(model_config(layout, 2 if layout != "dense" else 4))
        spec = serving.ServingSpec(layout=layout, sparsity=None if layout == "dense"
                                   else (2, 4), mesh=(1, world), backend="torch", **SPEC)
        out["model/" + layout] = logits(
            serving.prepare(params[layout], spec, cfg=tcfg, device="cpu"), tcfg)
    calib = torch.randint(1, 256, (4, 16), generator=torch.Generator().manual_seed(2))
    for layout, n, q, static in QUANT_MODEL:
        tcfg = port_config(model_config()).with_sparsity(TSp(n=n, m=4, mode=layout))
        spec = serving.ServingSpec(layout=layout, sparsity=(n, 4), qdtype=q,
                                   static_scales=static, backend="cuda", **SPEC)
        for mesh in (None, (1, world)):
            prep = serving.prepare(params["dense"], dataclasses.replace(spec, mesh=mesh),
                                   cfg=tcfg, calib_tokens=calib, device="cpu")
            out[f"quant/{layout}-{n}-{q}-{static}/{mesh}"] = logits(prep, tcfg)
    tcfg = port_config(model_config())
    for mesh in (None, (1, world)):
        spec = serving.ServingSpec(layout="dense", mesh=mesh, backend="torch", **SPEC)
        rep = serving.Engine(serving.prepare(params["dense"], spec, cfg=tcfg,
                                             device="cpu")).run(
            serving.make_poisson_trace(seed=0, num_requests=N_REQUESTS,
                                       vocab_size=tcfg.vocab_size))
        out[f"engine/{mesh}"] = [s.tokens for s in rep.stats]
    if rank == 0:
        pickle.dump(out, open(os.path.join(tmp, "port.pkl"), "wb"))


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Inputs made here; the JAX subprocess started (not waited for: the
    in-process tests run meanwhile) and the port's gloo world run."""
    from repro_torch.launch.mesh import spawn_ranks

    tmp = str(tmp_path_factory.mktemp("shard"))
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, O)) * K ** -0.5).astype(np.float32)
    inputs = {"x": rng.standard_normal((B, K)).astype(np.float32)}
    for case in LINEAR_CASES:
        mode, n, q, _ = case
        leaf = j_convert({"w": jnp.asarray(w)}, JSp(n=n, m=4, mode=mode), mode, quantize=q)
        inputs[_case_id(case)] = {k: _pack(v) for k, v in leaf.items()}
    pickle.dump(inputs, open(os.path.join(tmp, "inputs.pkl"), "wb"))
    params = {layout: port_params(j_init_params(jax.random.PRNGKey(0),
                                                model_config(layout, 2 if layout != "dense"
                                                             else 4)))
              for layout in FP32_MODEL}
    torch.save(params, os.path.join(tmp, "params.pt"))

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    jax_out = os.path.join(tmp, "jax.pkl")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                             os.path.join(tmp, "inputs.pkl"), jax_out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    prev = os.environ.get("REPRO_FP8_NATIVE")
    os.environ["REPRO_FP8_NATIVE"] = "1"    # the fp8 entries plan on the CPU
    try:
        spawn_ranks(port_world, 2, tmp, device_type="cpu")
    except BaseException:
        proc.kill()
        raise
    finally:
        if prev is None:
            os.environ.pop("REPRO_FP8_NATIVE")
        else:
            os.environ["REPRO_FP8_NATIVE"] = prev
    yield types.SimpleNamespace(proc=proc, tmp=tmp, inputs=inputs, jax_out=jax_out)
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def results(world):
    """(inputs, the JAX subprocess's results, the port's)."""
    log, _ = world.proc.communicate(timeout=600)
    assert world.proc.returncode == 0 and "OK" in log, log[-4000:]
    return (world.inputs, pickle.load(open(world.jax_out, "rb")),
            pickle.load(open(os.path.join(world.tmp, "port.pkl"), "rb")))


# --------------------------------------- K11's plain versions vs Pallas
@pytest.mark.parametrize("qdtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("n", [2, 1])
def test_kmajor_plain_versions_match_the_pallas_kernels(qdtype, n):
    """K11's plain versions (float, scaled, raw) against the JAX package's
    ``nm_spmm_gather`` / ``_int8`` / ``_fp8`` in interpret mode on the same
    x_t (K_eff, B): int8 raw and scaled bitwise, fp32 and e4m3 within
    1e-5 scaled (sums in another order); and ``ops.nm_spmm_gather_op``
    against the JAX op."""
    from repro.core import quantize as jq
    from repro.kernels.nm_spmm_gather import kernel as jk
    from repro.kernels.nm_spmm_gather.ops import nm_spmm_gather_op as j_op
    from repro_torch.kernels.nm_spmm_gather import kernel as tk
    from repro_torch.kernels.nm_spmm_gather.ops import nm_spmm_gather_op

    rng = np.random.default_rng(5 + n)
    ke, b, o = 512, 32, 128
    w = (rng.standard_normal((ke, o)) * ke ** -0.5).astype(np.float32)
    x = rng.standard_normal((b, ke)).astype(np.float32)
    leaf = j_convert({"w": jnp.asarray(w)}, JSp(n=n, m=4, mode="gather"), "gather",
                     quantize=qdtype)
    idx = leaf["gather_idx"].reshape(-1, 1)
    t_leaf = {k: _torch(_pack(v)) for k, v in leaf.items()}
    if qdtype is None:
        want = jk.nm_spmm_gather(jnp.asarray(x.T), leaf["values"], idx, n, interpret=True)
        got = tk.nm_spmm_gather(torch.from_numpy(x.T.copy()), t_leaf["values"],
                                t_leaf["gather_idx"], n)
        assert_scaled_close(got, np.asarray(want), 1e-5)
        assert_scaled_close(nm_spmm_gather_op(torch.from_numpy(x), t_leaf["values"],
                                              t_leaf["gather_idx"], n=n),
                            np.asarray(j_op(jnp.asarray(x), leaf["values"],
                                            leaf["gather_idx"], n=n, interpret=True)), 1e-5)
        return
    xq, xs = jq.quantize_rows(jnp.asarray(x), dtype=jnp.dtype(QDT[qdtype]))
    ws = leaf["scale"].reshape(-1, 1)
    jfn, tfn = getattr(jk, f"nm_spmm_gather_{qdtype}"), getattr(tk, f"nm_spmm_gather_{qdtype}")
    x_t = _torch(_pack(np.asarray(xq).T.copy()))
    for scales in (None, (xs.reshape(1, -1), ws)):
        want = np.asarray(jfn(xq.T, leaf["values"], idx, *(scales or (None, None)), n,
                              interpret=True))
        got = tfn(x_t, t_leaf["values"], t_leaf["gather_idx"],
                  *((None, None) if scales is None else
                    (torch.from_numpy(np.asarray(scales[0])),
                     torch.from_numpy(np.asarray(scales[1])))), n)
        assert got.shape == want.shape == (o, b)
        if qdtype == "int8":
            assert got.dtype == (torch.int32 if scales is None else torch.float32)
            assert np.array_equal(got.numpy(), want)
        else:
            assert_scaled_close(got, want, 1e-5)


# ------------------------------------------------- plans under a shard
class _Mesh:
    """What a plan reads of a mesh: its axis sizes."""

    def __init__(self, model: int):
        self.shape = {"data": 1, "model": model}


# (mode, b, ke, o, n, dtype, hint, model size, extra GemmProblem fields)
PLAN_CASES = [
    ("gather", 8, 2048, 2048, 2, "int8", "row", 2, {}),
    ("gather", 32, 8192, 2048, 1, "float8_e4m3fn", "row", 2, {}),
    ("gather", 8, 2048, 2048, 2, "bfloat16", "row", 2, {}),
    ("gather", 8, 2048, 2048, 2, "int8", "col", 2, {}),
    ("dense", 8, 2048, 2048, 4, "int8", "row", 2, {}),
    ("compressed", 64, 8192, 2048, 2, "float8_e4m3fn", "row", 2, {}),
    ("dense", 8, 2048, 1024, 4, "bfloat16", "col", 2, {}),
    ("dense", 8, 2048, 2048, 4, "bfloat16", "col", 1, {}),                # trivial: single
    ("dense", 8, 2048, 2050, 4, "bfloat16", "col", 4, {}),                # SHARD_INDIVISIBLE
    ("compressed", 8, 2048, 2048, 2, "int8", "row", 3, {}),               # indivisible ke
    ("compressed", 8, 72, 256, 1, "bfloat16", "row", 2, {}),              # META_AXIS_SPLIT
    ("gather", 8, 1028, 256, 2, "bfloat16", "row", 2, {}),                # META_AXIS_SPLIT
    ("dense", 8, 2048, 2048, 4, "bfloat16", None, 2, {}),                 # NO_SHARD_SPEC
    ("dense", 8, 2048, 4096, 4, "bfloat16", "col", 2, {"epilogue": "gelu"}),
    ("gather", 8, 2048, 8192, 2, "int8", "col", 2, {"epilogue": "silu_mul", "dual": True}),
    ("dense", 8, 2048, 2048, 4, "bfloat16", "row", 2, {"activation": "zeros"}),
    ("dense", 0, 2048, 2048, 4, "bfloat16", "row", 2, {}),                # empty batch
]


@pytest.fixture
def _no_tuned_blocks(tmp_path, monkeypatch):
    """The JAX planner consults its autotune store; keep it empty.  The
    port's fp8 entries plan on the CPU."""
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_FP8_NATIVE", "1")
    jautotune.clear_memory_cache()
    yield
    jautotune.clear_memory_cache()


def _plan_pair(mode, b, ke, o, n, dtype, hint, m, extra):
    def spec(mod):
        if hint is None:
            return None
        axes = {"col": {"o": "model"}, "row": {"ke": "model"}}[hint]
        return mod.ShardSpec(mesh=_Mesh(m), batch="data", **axes)
    want = jd.plan(jd.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4, dtype=jnp.dtype(dtype),
                                  sharded=True, shard=spec(jd), **extra),
                   dispatch=jd.DispatchConfig(backend="interpret"))
    got = td.plan(td.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4, dtype=getattr(torch, dtype),
                                 sharded=True, shard=spec(td), **extra),
                  dispatch=td.DispatchConfig(backend="cuda"))
    return want, got


@pytest.mark.usefixtures("_no_tuned_blocks")
@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: f"{c[0]}-{c[6]}-m{c[7]}-{c[5]}-{c[1]}x{c[2]}x{c[3]}"
                         f"{'-' + '+'.join(c[8]) if c[8] else ''}")
def test_plans_under_a_shard_match_the_reference(case):
    import re
    want, got = _plan_pair(*case)
    assert got.kernel == (td.TORCH_REFERENCE if want.kernel == jd.JNP_REFERENCE
                          else want.kernel)
    assert got.reason_code.value == want.reason_code.value
    for field in ("placement", "local_dims", "shards", "collective", "epilogue_fused",
                  "activation_skip", "act_scales", "dtype"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.epilogue_reason and got.epilogue_reason.value) == \
        (want.epilogue_reason and want.epilogue_reason.value)
    assert (got.activation_reason and got.activation_reason.value) == \
        (want.activation_reason and want.activation_reason.value)

    def norm(s):   # the backend names and the (Hopper / TPU) blocks differ
        s = re.sub(r"\[(interpret|cuda)\] blocks=\([^)]*\)", "[k]", s)
        return s.replace("jnp-reference", "torch-reference").replace("[jnp]", "[torch]")
    if got.uses_kernel:
        assert norm(td.describe(got)) == norm(jd.describe(want))
    else:
        assert got.reason_code.value == want.reason_code.value


@pytest.mark.usefixtures("_no_tuned_blocks")
def test_every_shard_decline_code_is_covered():
    codes = set()
    for case in PLAN_CASES:
        want, got = _plan_pair(*case)
        codes |= {got.reason_code, got.epilogue_reason, got.activation_reason}
    assert {ReasonCode.SHARD_INDIVISIBLE, ReasonCode.META_AXIS_SPLIT,
            ReasonCode.NO_SHARD_SPEC, ReasonCode.EPILOGUE_SHARDED,
            ReasonCode.ACT_MASK_ONLY_SHARDED} <= codes


@pytest.mark.usefixtures("_no_tuned_blocks")
@pytest.mark.parametrize("static", [False, True])
def test_row_consumer_declines_the_producer_requant(static):
    """A row-parallel quantized consumer (w_out under the mesh) declines
    the producer's fused requantize, as the reference."""
    from repro.core import quantize as jq
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((1024, 512)) * 0.03).astype(np.float32)
    jleaf = j_convert({"w": jnp.asarray(w)}, JSp(n=2, m=4, mode="gather"), "gather",
                      quantize="int8")
    tleaf = {k: _torch(_pack(v)) for k, v in jleaf.items()}
    if static:
        jleaf = {**jleaf, jq.ACT_SCALE_KEY: jnp.float32(0.02)}
        tleaf = {**tleaf, "act_scale": torch.tensor(0.02)}
    jspec = jd.ShardSpec(mesh=_Mesh(2), batch="data", ke="model")
    tspec = td.ShardSpec(mesh=_Mesh(2), batch="data", ke="model")
    _, jcode = jd.requant_decision(jleaf, (8,), JSp(n=2, m=4, mode="gather"),
                                   dispatch=jd.DispatchConfig(backend="interpret"),
                                   shard=jspec)
    local = shardings.shard_leaf(tleaf, "row", AxisEnv(shape={"data": 1, "model": 2}), 2)
    _, tcode = td.requant_decision(local, (8,), TSp(n=2, m=4, mode="gather"),
                                   dispatch=td.DispatchConfig(backend="cuda"), shard=tspec)
    assert tcode.value == jcode.value
    assert tcode is (ReasonCode.REQUANT_CONSUMER_FALLBACK if static
                     else ReasonCode.REQUANT_DYNAMIC_SCALES)


# ------------------------------------------------------ parameter slicing
@pytest.mark.parametrize("mode,q,hint", [
    ("dense", None, "col"), ("dense", "int8", "row"), ("compressed", "fp8", "row"),
    ("compressed", None, "col"), ("gather", "int8", "row"), ("gather", "int8", "col")])
def test_param_slicing_follows_the_reference_specs(mode, q, hint):
    """The leaves each rank holds are the reference's ``_shard_param_specs``
    slices: the same PartitionSpec per key, and rank r's r-th block."""
    from repro.core import quantize as jq
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    n = 4 if mode == "dense" else 2
    jleaf = j_convert({"w": jnp.asarray(w)}, JSp(n=n, m=4, mode=mode), mode, quantize=q)
    if q is not None:
        jleaf = {**jleaf, jq.ACT_SCALE_KEY: jnp.float32(0.1)}
    axes = {"col": {"o": "model"}, "row": {"ke": "model"}}[hint]
    want = jd._shard_param_specs(mode, jd.ShardSpec(mesh=_Mesh(2), **axes), jleaf)
    got = shardings.shard_param_specs(mode, axes.get("ke"), axes.get("o"), jleaf)
    assert {k: tuple(v) for k, v in want.items()} == got
    tleaf = {k: _torch(_pack(v)) for k, v in jleaf.items()}
    for r in (0, 1):
        local = shardings.shard_leaf(tleaf, hint, AxisEnv(shape={"data": 1, "model": 2},
                                                          model_rank=r), n)
        for k, spec in got.items():
            full = np.asarray(jleaf[k])
            for dim, ax in enumerate(spec):
                if ax is not None:
                    size = full.shape[dim] // 2
                    full = np.take(full, range(r * size, (r + 1) * size), axis=dim)
            have = local[k]
            if have.dtype == torch.float8_e4m3fn:
                have, full = have.view(torch.uint8), full.view(np.uint8)
            assert np.array_equal(have.numpy(), full), k


# ------------------------------------------------------------ refusals
def test_mesh_refusals():
    from repro_torch import serving
    from repro_torch.launch.mesh import parse_mesh
    with pytest.raises(ValueError, match="data axis > 1 is not ported.*Queue 1 item 12"):
        serving.ServingSpec(mesh=(2, 1))
    with pytest.raises(ValueError, match="data axis"):
        parse_mesh("2x2")
    assert serving.ServingSpec(mesh=[1, 2]).mesh == (1, 2)
    cfg = port_config(model_config())
    with pytest.raises(ValueError, match="KV heads do not divide"):
        shardings.check_config(dataclasses.replace(cfg, num_heads=8, num_kv_heads=1), 2)
    with pytest.raises(ValueError, match="do not divide"):
        shardings.check_config(cfg, 3)
    with pytest.raises(ValueError, match="sharded MoE"):
        shardings.check_config(dataclasses.replace(cfg, num_experts=4, top_k=2), 2)


@pytest.mark.parametrize("layout,n,qdtype", [("dense", 4, None), ("gather", 2, "int8")])
def test_a_1x1_mesh_is_the_single_placement(layout, n, qdtype):
    """``mesh=(1, 1)`` installs no axis env: every site plans the kernel
    it plans with no mesh (the cuda backend plans; on these CPU tensors
    the wrappers take their plain versions), and the logits are the same."""
    from repro_torch import serving
    from repro_torch.models import forward, init_params
    cfg = port_config(dataclasses.replace(model_config(layout, n), dtype="bfloat16"))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(layout=layout, sparsity=None if layout == "dense" else (n, 4), qdtype=qdtype,
              backend="cuda")
    one = serving.prepare(params, serving.ServingSpec(mesh=(1, 1), **kw), cfg=cfg, device="cpu")
    none = serving.prepare(params, serving.ServingSpec(**kw), cfg=cfg, device="cpu")
    assert one.axis_env is None
    report = one.dispatch_report()
    assert report == none.dispatch_report()
    assert not any("torch-reference" in ln or "shard_map" in ln for ln in report), report
    tokens = torch.tensor([PROMPTS[0]])
    with torch.inference_mode(), one.activate():
        got = forward(one.params, cfg, tokens)
    with torch.inference_mode(), none.activate():
        want = forward(none.params, cfg, tokens)
    assert torch.equal(got, want)


def test_launcher_serves_a_1x2_mesh_on_the_cpu(capfd):
    from repro_torch.launch import serve
    serve.main(["--arch", "internlm2_1_8b", "--smoke", "--sparsity", "2:4", "--mode", "gather",
                "--quantize", "int8", "--device", "cpu", "--kernel-backend", "cuda",
                "--mesh", "1x2", "--requests", "2", "--new-tokens", "3"])
    out = capfd.readouterr().out
    assert "mesh 1x2: 2 ranks over torch.distributed (gloo;" in out
    assert "mesh installed: data=1 x model=2" in out
    assert "served 2/2 requests" in out and "token streams equal on all 2 ranks" in out
    assert "shards=(b/1,ke/2,o/1)" in out or "local shard" in out


def test_sharding_modules_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.launch.mesh, repro_torch.launch.shardings\n"
            "import repro_torch.models.pjit_utils, repro_torch.kernels.nm_spmm_gather.ops\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# ------------------------------------ against the subprocess and the world
@pytest.mark.parametrize("case", LINEAR_CASES, ids=_case_id)
def test_sharded_linear_matches_the_reference_shard_map(results, case):
    _, want, got = results
    assert_scaled_close(got[_case_id(case)], want[_case_id(case)],
                        1e-4 if case[2] == "fp8" else 1e-5)


@pytest.mark.parametrize("case", RAW_CASES, ids=_case_id)
def test_int8_raw_partials_and_their_sum_bitwise(results, case):
    """Each rank's raw int32 accumulator (K5 / K6 raw, K11 for gather) of
    the globally quantized, padded local rows, bitwise the reference's
    ``_partial_*_q``; and their sum."""
    from repro_torch.core.quantize import quantize_rows

    inputs, want, _ = results
    mode, n, _, _ = case
    cfg = TSp(n=n, m=4, mode=mode)
    leaf = {k: _torch(v) for k, v in inputs[_case_id(case)].items()}
    xq, _ = quantize_rows(torch.from_numpy(inputs["x"]), torch.int8)
    entry = td._entry_by_name(mode, {"dense": "tile_gemm_int8", "compressed": "nm_spmm_int8",
                                     "gather": "nm_spmm_gather_int8"}[mode])
    total = 0
    for r in (0, 1):
        env = AxisEnv(shape={"data": 1, "model": 2}, model_rank=r)
        local = shardings.shard_leaf(leaf, "row", env, n)
        xr = td._pad_rows(xq.chunk(2, dim=1)[r].contiguous(), td._q_padded_b(B))
        acc = entry.run_quantized(xr, local, cfg, None)
        ref = want[_case_id(case) + f"/partial{r}"]
        assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), ref)
        total = total + acc
    assert np.array_equal(total.numpy(), want[_case_id(case) + "/partial0"]
                          + want[_case_id(case) + "/partial1"])


@pytest.mark.parametrize("layout", FP32_MODEL)
def test_sharded_model_logits_match_jax_unsharded(results, layout):
    _, want, got = results
    assert len(got["model/" + layout]) == len(want["model/" + layout]) == 5
    for g, w in zip(got["model/" + layout], want["model/" + layout]):
        assert_scaled_close(g, w, 1e-4)


@pytest.mark.parametrize("case", QUANT_MODEL, ids=lambda c: f"{c[0]}-{c[1]}:4-{c[2]}"
                         f"{'-static' if c[3] else ''}")
def test_sharded_quantized_logits_match_unsharded(results, case):
    _, _, got = results
    key = "quant/{}-{}-{}-{}".format(*case)
    for g, w in zip(got[f"{key}/(1, 2)"], got[f"{key}/None"]):
        assert_scaled_close(g, w, 1e-5)


def test_sharded_engine_tokens_equal_unsharded_and_jax(results):
    _, want, got = results
    assert got["engine/(1, 2)"] == got["engine/None"] == [tuple(t) for t in want["engine"]]
