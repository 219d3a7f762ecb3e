"""The port's dispatch engine against ``repro.kernels.dispatch``.

``plan`` must give the same kernel (names mapped: the JAX package's
``jnp-reference`` is the port's ``torch-reference``), mode, reason codes
and epilogue decision as the JAX package's ``plan``, across the
backend-independent cases of tests/test_dispatch.py that the slice
covers.  Backends map ``interpret`` -> ``cuda`` (kernels; CPU tensors run
their plain versions) and ``jnp`` -> ``torch``.  Where the port's Hopper
tiling contract differs from the TPU kernels' (bf16 only; K and O
multiples of 64) the port declines with NO_KERNEL_FITS, pinned below.

Quantized (int8) leaves plan on their storage dtype in both packages:
the same int8 entries (``tile_gemm_int8``, ``nm_spmm_int8``), the same
``act-scales=dynamic`` annotation, and the torch tier dequantizes the
weight exactly as the jnp tier's ``_deq`` does.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparsityConfig as JSp
from repro.core import apply_linear as j_apply_linear
from repro.core import init_linear as j_init_linear
from repro.kernels import autotune as jautotune
from repro.kernels import dispatch as jd
from repro.kernels import registry as jreg
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.core.sparse_linear import apply_gate_up, apply_linear
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import registry as treg
from repro_torch.kernels.reasons import ReasonCode
from torch_parity import assert_scaled_close, jnp_dtype, port_params

BACKENDS = {"interpret": "cuda", "jnp": "torch"}
NAMES = {jd.JNP_REFERENCE: td.TORCH_REFERENCE, "tile_gemm": "tile_gemm",
         "nm_spmm": "nm_spmm", "tile_gemm_int8": "tile_gemm_int8",
         "nm_spmm_int8": "nm_spmm_int8"}

# (mode, b, ke, o, n, dtype, extra GemmProblem fields, JAX backend)
PLAN_CASES = [
    ("dense", 16, 128, 64, 4, "bfloat16", {}, "interpret"),
    ("compressed", 16, 128, 64, 2, "bfloat16", {}, "interpret"),
    ("compressed", 16, 128, 64, 1, "bfloat16", {}, "interpret"),
    ("compressed", 8, 2048, 1024, 2, "bfloat16", {}, "interpret"),
    ("compressed", 4, 100, 32, 1, "float32", {}, "interpret"),     # unfittable
    ("masked", 16, 128, 64, 2, "float32", {}, "interpret"),        # SR-STE
    ("compressed", 16, 128, 64, 2, "float32", {}, "jnp"),          # reference tier
    ("dense", 16, 128, 64, 4, "bfloat16", {"differentiating": True}, "interpret"),
    ("dense", 0, 128, 64, 4, "bfloat16", {}, "interpret"),         # empty batch
    ("dense", 16, 128, 64, 4, "bfloat16", {"epilogue": "bias+silu"}, "interpret"),
    ("compressed", 8, 128, 64, 2, "bfloat16", {"epilogue": "gelu"}, "interpret"),
    ("dense", 8, 128, 128, 4, "bfloat16", {"epilogue": "silu_mul", "dual": True},
     "interpret"),
    ("compressed", 64, 256, 128, 1, "bfloat16",
     {"epilogue": "silu_mul", "dual": True}, "interpret"),
    ("dense", 16, 128, 64, 4, "float32", {"epilogue": "silu"}, "jnp"),
    # the int8 class: planned on the leaf's storage dtype
    ("dense", 8, 128, 64, 4, "int8", {}, "interpret"),
    ("compressed", 8, 128, 64, 2, "int8", {}, "interpret"),
    ("compressed", 37, 256, 128, 1, "int8", {}, "interpret"),
    ("dense", 64, 2048, 2048, 4, "int8", {"epilogue": "bias+gelu"}, "interpret"),
    ("compressed", 8, 128, 128, 2, "int8", {"epilogue": "silu_mul", "dual": True},
     "interpret"),
    ("dense", 8, 128, 128, 4, "int8", {"epilogue": "silu_mul", "dual": True},
     "interpret"),
    ("compressed", 8, 128, 64, 2, "int8", {}, "jnp"),
    ("dense", 8, 128, 64, 4, "int8", {"differentiating": True}, "interpret"),
]


@pytest.fixture(autouse=True)
def _no_tuned_blocks(tmp_path, monkeypatch):
    """The JAX planner consults the autotune store; keep it empty."""
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(tmp_path))
    jautotune.clear_memory_cache()
    yield
    jautotune.clear_memory_cache()


def _plans(mode, b, ke, o, n, dtype, extra, backend):
    want = jd.plan(jd.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4,
                                  dtype=jnp_dtype(dtype), **extra),
                   dispatch=jd.DispatchConfig(backend=backend))
    got = td.plan(td.GemmProblem(mode, b=b, ke=ke, o=o, n=n, m=4,
                                 dtype=getattr(torch, dtype), **extra),
                  dispatch=td.DispatchConfig(backend=BACKENDS[backend]))
    return want, got


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[0]}-{c[1:5]}-{c[7]}")
def test_plan_matches_reference(case):
    want, got = _plans(*case)
    assert got.kernel == NAMES[want.kernel]
    assert got.mode == want.mode
    assert got.reason_code.value == want.reason_code.value
    assert (got.epilogue_reason and got.epilogue_reason.value) == \
        (want.epilogue_reason and want.epilogue_reason.value)
    assert got.epilogue_fused == want.epilogue_fused
    assert got.blocks_source == want.blocks_source
    assert got.dtype == want.dtype
    assert got.act_scales == want.act_scales
    if got.uses_kernel:
        assert got.backend == BACKENDS[want.backend]
        # same report line up to the backend name and the (Hopper) blocks
        def norm(s):
            return re.sub(r"\[(interpret|cuda)\] blocks=\([^)]*\)", "[k]", s)
        assert norm(td.describe(got)) == norm(jd.describe(want))


@pytest.mark.parametrize("mode,dtype,ke,o", [
    ("dense", "float32", 128, 64),       # the CUDA kernels take bf16 only
    ("dense", "bfloat16", 128, 32),      # O not a multiple of 64
    ("compressed", "bfloat16", 96, 64),  # K not a multiple of 64
])
def test_port_declines_what_its_kernels_do_not_tile(mode, dtype, ke, o):
    want, got = _plans(mode, 8, ke, o, 2, dtype, {}, "interpret")
    assert want.uses_kernel                      # the TPU kernels fit these
    assert not got.uses_kernel
    assert got.reason_code is ReasonCode.NO_KERNEL_FITS
    assert "no registered kernel fits" in got.reason


def test_registry_and_backend_detection(monkeypatch):
    sel = treg.select("compressed", b=16, ke=128, o=64, n=2, m=4,
                      dtype=torch.bfloat16, backend="cuda")
    assert sel is not None and sel[0].name == "nm_spmm" and sel[1] == (16, 64, 64)
    assert treg.select("dense", b=16, ke=128, o=64, n=4, m=4, dtype=torch.bfloat16,
                       backend="torch") is None
    monkeypatch.delenv("REPRO_KERNEL_BACKEND", raising=False)
    assert treg.detect_backend("cpu") == "torch"
    assert treg.detect_backend(torch.device("cuda", 0)) == "cuda"
    assert treg.resolve_backend("auto", "cpu") == "torch"
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "cuda")
    assert treg.detect_backend("cpu") == "cuda"
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "torch")
    assert treg.detect_backend("cuda") == "torch"
    assert treg.largest_fitting_block(192, 128) == jreg.largest_fitting_block(192, 128)
    with pytest.raises(ValueError):
        treg.resolve_backend("tpu")


def _linear(cfg_mode, n, k, o, dtype, seed=0):
    jcfg = JSp(n=n, m=4, mode=cfg_mode)
    p = j_init_linear(jax.random.PRNGKey(seed), k, o, jcfg, dtype=jnp_dtype(dtype))
    return jcfg, p, TSp(n=n, m=4, mode=cfg_mode), port_params(p)


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2), ("compressed", 1)])
@pytest.mark.parametrize("backend,dtype,tol", [
    ("jnp", "float32", 1e-5), ("interpret", "bfloat16", 1e-2)])
def test_apply_linear_matches_reference(mode, n, backend, dtype, tol):
    jcfg, jp, tcfg, tp = _linear(mode, n, 128, 64, dtype)
    x = np.random.default_rng(1).standard_normal((2, 3, 128)).astype(np.float32)
    with jd.use_dispatch(backend=backend):
        want = j_apply_linear(jp, jnp.asarray(x).astype(jnp_dtype(dtype)), jcfg)
    with td.use_dispatch(backend=BACKENDS[backend]):
        got = apply_linear(tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    assert got.shape == (2, 3, 64)
    assert_scaled_close(got, want, tol)


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2)])
@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_gate_up_matches_reference(mode, n, backend):
    from repro.core.sparse_linear import apply_gate_up as j_apply_gate_up
    jcfg, jg, tcfg, tg = _linear(mode, n, 128, 128, "bfloat16", seed=0)
    _, ju, _, tu = _linear(mode, n, 128, 128, "bfloat16", seed=1)
    x = np.random.default_rng(2).standard_normal((8, 128)).astype(np.float32)
    with jd.use_dispatch(backend=backend):
        want = j_apply_gate_up(jg, ju, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    with td.use_dispatch(backend=BACKENDS[backend]):
        got = apply_gate_up(tg, tu, torch.from_numpy(x).bfloat16(), tcfg)
    assert_scaled_close(got, want, 1e-2)


def test_cuda_backend_routes_cpu_tensors_through_the_kernel_wrapper(monkeypatch):
    """The engine must call the kernel wrapper (which, handed CPU tensors,
    runs the plain version), not just plan to."""
    import repro_torch.kernels.nm_spmm.kernel as nm_kernel

    calls = []
    real = nm_kernel.nm_spmm

    def spy(*args, **kwargs):
        calls.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(nm_kernel, "nm_spmm", spy)
    _, _, tcfg, tp = _linear("compressed", 2, 128, 64, "bfloat16")
    x = torch.randn(8, 128).bfloat16()
    with td.use_dispatch(backend="cuda"):
        apply_linear(tp, x, tcfg)
    assert calls == ["cpu"]
    calls.clear()
    with td.use_dispatch(backend="torch"):
        apply_linear(tp, x, tcfg)
    assert calls == []


def test_autograd_declines_to_the_reference_tier(monkeypatch):
    import repro_torch.kernels.tile_gemm.kernel as tg_kernel

    monkeypatch.setattr(tg_kernel, "tile_gemm",
                        lambda *a, **k: pytest.fail("kernel under autograd"))
    _, _, tcfg, tp = _linear("dense", 4, 128, 64, "bfloat16")
    w = tp["w"].float().requires_grad_()
    x = torch.randn(8, 128)
    with td.use_dispatch(backend="cuda"):
        y = apply_linear({"w": w}, x, tcfg)
    (y ** 2).sum().backward()
    assert w.grad is not None and bool((w.grad != 0).any())
    d = td.plan(td.GemmProblem("dense", b=8, ke=128, o=64, dtype=torch.bfloat16,
                               differentiating=True),
                dispatch=td.DispatchConfig(backend="cuda"))
    assert d.reason_code is ReasonCode.AUTODIFF


def test_dispatch_report_walks_the_same_sites():
    """Port and JAX reports list the same (hint, N:M, B, K, O) sites."""
    from repro.configs import get_smoke_config
    from repro.models import init_params
    from torch_parity import port_config

    jcfg = get_smoke_config("internlm2_1_8b").with_sparsity(
        JSp(n=2, m=4, mode="compressed"))
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_params(jp)
    with jd.use_dispatch(backend="jnp"):
        want = jd.dispatch_report(jp, (4, 8), jcfg.sparsity)[:-1]   # - autotune line
    got = td.dispatch_report(tp, (4, 8), port_config(jcfg).sparsity,
                             dispatch=td.DispatchConfig(backend="torch"))
    site = re.compile(r"^\s+(\[[^\]]+\] \d:\d global \([^)]*\))")
    assert [site.match(g).group(1) for g in got] == \
        [site.match(w).group(1) for w in want]
    assert all("torch-reference (backend=torch)" in g for g in got)


# ------------------------------------------------------------ int8 class
def _q_linear(mode, n, k, o, seed=0):
    """A JAX int8 leaf (convert_layout(..., quantize="int8")) and its port."""
    from repro.core.sparse_linear import convert_layout as j_convert
    jcfg, jp, tcfg, _ = _linear("dense", 4, k, o, "float32", seed)
    jcfg = JSp(n=n, m=4, mode=mode)
    jq = j_convert(jp, jcfg, mode, quantize="int8")
    return jcfg, jq, TSp(n=n, m=4, mode=mode), port_params(jq)


def test_float_entries_never_see_an_int8_leaf():
    for mode, n in (("dense", 4), ("compressed", 2)):
        sel = treg.select(mode, b=8, ke=128, o=64, n=n, m=4, dtype=torch.int8,
                          backend="cuda")
        assert sel is not None and sel[0].name.endswith("_int8") and sel[0].quantized
        sel = treg.select(mode, b=8, ke=128, o=64, n=n, m=4, dtype=torch.bfloat16,
                          backend="cuda")
        assert not sel[0].quantized


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2), ("compressed", 1)])
def test_int8_torch_tier_dequantizes_like_the_jnp_tier(mode, n):
    """The reference tiers: dequantized weight, float activations."""
    jcfg, jq, tcfg, tq = _q_linear(mode, n, 128, 64)
    assert tq[("w" if mode == "dense" else "values")].dtype == torch.int8
    x = np.random.default_rng(3).standard_normal((2, 3, 128)).astype(np.float32)
    with jd.use_dispatch(backend="jnp"):
        want = j_apply_linear(jq, jnp.asarray(x), jcfg)
    with td.use_dispatch(backend="torch"):
        got = apply_linear(tq, torch.from_numpy(x), tcfg)
    assert_scaled_close(got, want, 1e-5)
    key = "w" if mode == "dense" else "values"
    np.testing.assert_array_equal(td._deq(tq, tq[key]).numpy(),
                                  np.asarray(jd._deq(jq, jq[key])))


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2), ("compressed", 1)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 1e-2)])
def test_int8_kernel_path_matches_interpret(mode, n, dtype, tol):
    """w8a8 through the engine: quantize the rows, the int8 kernel (plain
    version on CPU tensors) against the JAX Pallas int8 kernel."""
    jcfg, jq, tcfg, tq = _q_linear(mode, n, 256, 128)
    x = np.random.default_rng(4).standard_normal((5, 256)).astype(np.float32)
    with jd.use_dispatch(backend="interpret"):
        want = j_apply_linear(jq, jnp.asarray(x).astype(jnp_dtype(dtype)), jcfg)
    with td.use_dispatch(backend="cuda"):
        got = apply_linear(tq, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    assert got.dtype == getattr(torch, dtype)
    assert_scaled_close(got, want, tol)


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2)])
def test_int8_gate_up_runs_one_dual_launch(mode, n, monkeypatch):
    from repro.core.sparse_linear import apply_gate_up as j_apply_gate_up
    import repro_torch.kernels.nm_spmm.kernel as nm_kernel
    import repro_torch.kernels.tile_gemm.kernel as tg_kernel

    jcfg, jg, tcfg, tg = _q_linear(mode, n, 128, 128, seed=0)
    _, ju, _, tu = _q_linear(mode, n, 128, 128, seed=1)
    x = np.random.default_rng(5).standard_normal((8, 128)).astype(np.float32)
    with jd.use_dispatch(backend="interpret"):
        want = j_apply_gate_up(jg, ju, jnp.asarray(x), jcfg)
    mod, name = ((tg_kernel, "tile_gemm_dual_int8") if mode == "dense"
                 else (nm_kernel, "nm_spmm_dual_int8"))
    calls, real = [], getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    with td.use_dispatch(backend="cuda"):
        got = apply_gate_up(tg, tu, torch.from_numpy(x), tcfg)
    assert calls == [1]
    assert_scaled_close(got, want, 2e-6)


def test_int8_refusals():
    """What the slice does not port raises instead of running quietly; what
    it does (an act_scale leaf; int8 rows requantized against it; an fp8
    leaf) runs, on the kernel tier as the JAX package's does."""
    jcfg, jq, tcfg, tq = _q_linear("compressed", 2, 128, 64)
    x = np.random.default_rng(7).standard_normal((4, 128)).astype(np.float32)
    s = np.float32(0.1)
    with jd.use_dispatch(backend="interpret"):
        want = j_apply_linear({**jq, "act_scale": jnp.asarray(s)}, jnp.asarray(x), jcfg)
    with td.use_dispatch(backend="cuda"):
        got = apply_linear({**tq, "act_scale": torch.tensor(s)}, torch.from_numpy(x), tcfg)
        assert_scaled_close(got, want, 2e-6)
        xq = torch.clamp(torch.round(torch.from_numpy(x) / s), -127, 127).to(torch.int8)
        narrow = apply_linear({**tq, "act_scale": torch.tensor(s)}, xq, tcfg)
        assert narrow.dtype == torch.float32
        assert torch.equal(narrow, got.float())
        with pytest.raises(ValueError, match="act_scale"):
            apply_linear(tq, xq, tcfg)
    # an fp8 leaf plans the fp8 class with the JAX package's reason codes
    jfp8 = {**jq, "values": jq["values"].astype(jnp.float32).astype(jnp.float8_e4m3fn)}
    fp8 = {**tq, "values": tq["values"].float().to(torch.float8_e4m3fn)}
    jdec = jd.plan_for(jfp8, (4, 128), jcfg, dtype=jnp.float8_e4m3fn,
                       dispatch=jd.DispatchConfig(backend="interpret"))
    tdec = td.plan_for(fp8, (4, 128), tcfg, dispatch=td.DispatchConfig(backend="cuda"))
    assert tdec.kernel == jdec.kernel == "nm_spmm_fp8"
    assert tdec.reason_code.value == jdec.reason_code.value
    assert tdec.dtype == jdec.dtype == "float8_e4m3fn"
    assert tdec.act_scales == jdec.act_scales == "dynamic"
    x = torch.from_numpy(x)
    with td.use_dispatch(backend="cuda"):      # the fp8 plain versions, on CPU tensors
        assert apply_linear(fp8, x, tcfg).shape == (4, 64)
    with td.use_dispatch(backend="torch"):      # the torch tier dequantizes fp8
        assert apply_linear(fp8, x, tcfg).shape == (4, 64)


def test_int8_dispatch_report_prints_the_storage_dtype():
    from repro_torch.core.quantize import quantize_tree
    _, _, tcfg, tp = _linear("compressed", 2, 128, 128, "bfloat16")
    _, _, _, tu = _linear("compressed", 2, 128, 128, "bfloat16", seed=1)
    tree = quantize_tree({"ffn": {"w_gate": tp, "w_in": tu}}, "int8")
    lines = td.dispatch_report(tree, (8,), tcfg, dispatch=td.DispatchConfig(backend="cuda"))
    assert len(lines) == 2 and all("nm_spmm_int8[cuda]" in ln and "dtype=int8" in ln
                                   and "act-scales=dynamic" in ln for ln in lines)
    assert "gate-up" in lines[-1] and "silu_mul[fused]" in lines[-1]
