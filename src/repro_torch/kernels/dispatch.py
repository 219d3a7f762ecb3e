"""Unified sparse-GEMM dispatch engine, single-device slice.

The port's counterpart of ``repro.kernels.dispatch``: models and the
serving engine call :func:`sparse_matmul` and :func:`gate_up_matmul`, and
one planning function, :func:`plan`, decides per (mode, shape, N:M,
dtype, backend) whether the product runs on a hand-written CUDA kernel
(``tile_gemm`` for dense 4:4, ``nm_spmm`` for compressed N:4,
``nm_spmm_gather`` for the lane-aligned gather layout, and their fused
gate-up forms) or on the plain torch reference formulation.

Quantized leaves (a ``"scale"`` beside int8 or float8_e4m3fn values,
``core.quantize``) plan on their storage dtype, never on the
activations': the int8 class runs ``tile_gemm_int8`` / ``nm_spmm_int8``
/ ``nm_spmm_gather_int8`` and the fp8 class ``tile_gemm_fp8`` /
``nm_spmm_fp8`` / ``nm_spmm_gather_fp8`` (each with its gate-up duals;
the fp8 entries only on a CUDA device of compute capability 8.9 or
later, ``registry.supports_fp8``).  Both quantize the
activations here into the leaf's own dtype (plain torch, as the JAX
package's is jnp): per row (``quantize_rows``), or against the leaf's
calibrated static scale (``quantize_rows_static``) when it carries an
``act_scale``; rows that arrive already narrow, requantized by the
producing kernel's flush (:func:`requant_decision`: the gate-up dual's,
or the gelu MLP's single ``w_in``), are contracted as they are.  The
torch tier dequantizes the weight and contracts float activations.
:func:`attention` routes full-sequence attention to the
``flash_attention`` kernel the same way.

Activation sparsity (``activation=`` an ``actsparse.ActivationSpec``):
the mask pass runs on every route, and on a single-GEMM kernel decision
the adapter runs the layout's masked kernel (``tile_gemm_masked``,
``nm_spmm_masked``, ``nm_spmm_gather_bk_masked`` and their int8 / fp8
twins) on ``actsparse.block_maps`` at the kernel's own blocks
(``ReasonCode.ACT_SKIP``); duals and the torch tier contract the masked
operand (``ACT_MASK_ONLY_DUAL`` / ``ACT_MASK_ONLY_JNP``).

What the slice leaves out, each still planned by the JAX package only:
shard_map placement, the rowwise layout and autotuning.  Blocks are
always fitted (``ReasonCode.BLOCKS_FITTED``).

The torch tier is the reference: it is what runs under autograd (the
kernels carry no backward), on CPU tensors by default, and when a shape
or dtype fails a kernel's tiling contract (bf16 activations, or int8 or
float8_e4m3fn leaves; K and O multiples of 64, for the gather layout
K_c = K * n / 4 and O).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import nm
from ..core import quantize as quant
from ..core.sparse_linear import gather_hint, is_linear_leaf
from . import _build, reasons, registry
from . import epilogue as epilib
from .actsparse import ActivationSpec, apply_mask, block_maps
from .epilogue import Epilogue
from .reasons import ReasonCode
from .registry import KernelEntry, dtype_name

__all__ = [
    "DispatchConfig",
    "DispatchDecision",
    "GemmProblem",
    "use_dispatch",
    "plan",
    "plan_for",
    "describe",
    "sparse_matmul",
    "gate_up_matmul",
    "attention",
    "requant_decision",
    "requant_plan",
    "input_features",
    "iter_linear_items",
    "dispatch_report",
    "TORCH_REFERENCE",
    "ReasonCode",
]

#: kernel name of a decision that runs the torch reference tier
TORCH_REFERENCE = "torch-reference"

Blocks = Tuple[int, int, int]  # (block_b, block_ke, block_o)


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Engine-wide knobs; override per call or through ``use_dispatch``."""

    backend: str = "auto"          # auto | cuda | torch


_DEFAULT = DispatchConfig()


@contextlib.contextmanager
def use_dispatch(**overrides):
    """Temporarily override the engine defaults (tests, serving flags)."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = dataclasses.replace(prev, **overrides)
    try:
        yield _DEFAULT
    finally:
        _DEFAULT = prev


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """ONE value object describing a GEMM the engine may plan.

    ``device`` is where the operands live: with ``backend="auto"`` it
    picks the tier (``cuda`` for CUDA tensors, ``torch`` otherwise).
    ``epilogue`` is the canonical lattice point string
    (``EpilogueSpec.point``); ``dual`` marks a fused gate-up pair.
    ``static_scales`` records whether the use site carries a calibrated
    activation scale; it only annotates the decision.  ``activation`` is
    the activation-sparsity point (``ActivationSpec.point``)."""

    mode: str
    b: int
    ke: int
    o: int
    n: int = 4
    m: int = 4
    dtype: Any = torch.float32
    differentiating: bool = False
    epilogue: Optional[str] = None
    dual: bool = False
    device: Any = None
    static_scales: bool = False
    activation: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """What the engine chose for one problem, and why."""

    mode: str
    backend: str
    kernel: str                    # registry entry name or TORCH_REFERENCE
    blocks: Optional[Blocks]
    reason: str
    blocks_source: str = "none"    # none | fitted
    dtype: Optional[str] = None
    epilogue: Optional[str] = None
    epilogue_fused: bool = False
    reason_code: Optional[ReasonCode] = None
    epilogue_reason: Optional[ReasonCode] = None
    act_scales: Optional[str] = None   # quantized kernels: dynamic | static
    activation: Optional[str] = None   # activation-sparsity point
    activation_skip: bool = False      # True: the masked kernel skips dead tiles
    activation_reason: Optional[ReasonCode] = None   # skip, or why mask-only

    @property
    def uses_kernel(self) -> bool:
        return self.kernel != TORCH_REFERENCE


def describe(d: DispatchDecision) -> str:
    epi = ""
    if d.epilogue is not None:
        ann = (reasons.epilogue_annotation(d.epilogue_reason)
               if d.epilogue_reason is not None else "torch")
        epi = f" epilogue={d.epilogue}[{ann}]"
    if d.activation is not None:
        epi += (f" activation={d.activation}"
                f"[{reasons.activation_annotation(d.activation_reason)}]")
    if not d.uses_kernel:
        return f"{d.mode}: {TORCH_REFERENCE} ({d.reason}){epi}"
    bb, bke, bo = d.blocks
    acts = f" act-scales={d.act_scales}" if d.act_scales is not None else ""
    return (f"{d.mode}: {d.kernel}[{d.backend}] blocks=(b={bb},ke={bke},o={bo})"
            f" dtype={d.dtype}{epi}{acts} ({d.reason})")


# ---------------------------------------------------------------------------
# torch reference formulations (the always-available fallback tier)
# ---------------------------------------------------------------------------

def _deq(params, w):
    """The float operand the kernel-free tier contracts against: a
    quantized leaf's values dequantized with its per-channel scale."""
    if quant.SCALE_KEY in params:
        return quant.dequantize(w, params[quant.SCALE_KEY])
    return w


def _torch_dense(x2, params, cfg):
    return x2 @ _deq(params, params["w"]).to(x2.dtype)


def _torch_compressed(x2, params, cfg):
    meta = nm.unpack_meta(params["meta_packed"])
    w = nm.decompress(_deq(params, params["values"]), meta, cfg.n, cfg.m)
    return x2 @ w.to(x2.dtype)


def _torch_gather(x2, params, cfg):
    from .nm_spmm_gather.ref import gather_columns
    x_g = gather_columns(x2, params["gather_idx"], cfg.n, cfg.m)
    return x_g @ _deq(params, params["values"]).to(x2.dtype)


_TORCH_IMPL = {"dense": _torch_dense, "compressed": _torch_compressed,
               "gather": _torch_gather}


# ---------------------------------------------------------------------------
# Kernel adapters + registry entries
# ---------------------------------------------------------------------------

def _fit(b, k, o, dtype, storage, ke_step=_build.BLOCK_K) -> Optional[Blocks]:
    """The kernels' tiling contract: the planned dtype is the kernel's own
    ``storage`` (bf16 activations for the float kernels; the leaf's int8
    or float8_e4m3fn values, with activations quantized to the same dtype,
    for the quantized ones), the contraction ``k`` the weight rows run over
    and O multiples of 64; the row tile covers any batch (the ragged edge
    is masked in-kernel).  ``ke_step``: the activation columns one K step
    spans (64, or 256 / n for the gather kernels' 64 compressed rows)."""
    if dtype_name(dtype) != dtype_name(storage):
        return None
    if k % _build.BLOCK_K or o % _build.BLOCK_O:
        return None
    return (_build.block_rows(b), ke_step, _build.BLOCK_O)


def _fit_tile_gemm(b, ke, o, n, m, dtype, storage=torch.bfloat16):
    return _fit(b, ke, o, dtype, storage)


def _fit_nm_spmm(b, ke, o, n, m, dtype, storage=torch.bfloat16):
    if m != 4 or n not in (1, 2, 4):
        return None   # the kernel fixes M=4 (the paper's detailed design)
    return _fit(b, ke, o, dtype, storage)


def _fit_nm_gather(b, ke, o, n, m, dtype, storage=torch.bfloat16):
    # the kernels contract K_c = ke * n / 4 compressed rows, 64 per step
    if m != 4 or n not in (1, 2, 4) or ke * n % 4:
        return None
    return _fit(b, ke * n // 4, o, dtype, storage, ke_step=_build.BLOCK_K * 4 // n)


def _epi_kwargs(epi: Optional[Epilogue]) -> Dict[str, Any]:
    if epi is None or epi.spec.is_identity:
        return {}
    return {"epilogue": epi.spec, "bias": epi.bias}


def _maps(x2, blocks):
    """``block_maps`` of the contracted operand at the kernel's blocks
    (``blocks[1]`` is its K step in activation columns)."""
    return block_maps(x2, blocks[0], blocks[1])


def _run_tile_gemm(x2, params, cfg, blocks, epilogue=None, out_dtype=None,
                   activation=None):
    from .tile_gemm.kernel import tile_gemm, tile_gemm_masked
    w = params["w"].to(x2.dtype)
    if activation is not None:
        # x2 is already masked (sparse_matmul's mask pass); the maps only
        # let the kernel skip the dead tiles
        return tile_gemm_masked(x2, w, *_maps(x2, blocks), block_b=blocks[0],
                                **_epi_kwargs(epilogue))
    return tile_gemm(x2, w, block_b=blocks[0], **_epi_kwargs(epilogue))


def _run_tile_gemm_dual(x2, pg, pu, cfg, blocks, epilogue=None, out_dtype=None):
    from .tile_gemm.kernel import tile_gemm_dual
    return tile_gemm_dual(x2, pg["w"].to(x2.dtype), pu["w"].to(x2.dtype),
                          block_b=blocks[0])


def _run_nm_spmm(x2, params, cfg, blocks, epilogue=None, out_dtype=None,
                 activation=None):
    from .nm_spmm.kernel import nm_spmm, nm_spmm_masked
    v = params["values"].to(x2.dtype)
    if activation is not None:
        return nm_spmm_masked(x2, v, params["meta_packed"], *_maps(x2, blocks), cfg.n,
                              block_b=blocks[0], **_epi_kwargs(epilogue))
    return nm_spmm(x2, v, params["meta_packed"], cfg.n, block_b=blocks[0],
                   **_epi_kwargs(epilogue))


def _run_nm_spmm_dual(x2, pg, pu, cfg, blocks, epilogue=None, out_dtype=None):
    from .nm_spmm.kernel import nm_spmm_dual
    return nm_spmm_dual(x2, pg["values"].to(x2.dtype), pg["meta_packed"],
                        pu["values"].to(x2.dtype), pu["meta_packed"], cfg.n,
                        block_b=blocks[0])


def _run_nm_gather(x2, params, cfg, blocks, epilogue=None, out_dtype=None,
                   activation=None):
    from .nm_spmm_gather.kernel import nm_spmm_gather_bk, nm_spmm_gather_bk_masked
    v = params["values"].to(x2.dtype)
    if activation is not None:
        return nm_spmm_gather_bk_masked(x2, v, params["gather_idx"], *_maps(x2, blocks),
                                        cfg.n, block_b=blocks[0], **_epi_kwargs(epilogue))
    return nm_spmm_gather_bk(x2, v, params["gather_idx"], cfg.n, block_b=blocks[0],
                             **_epi_kwargs(epilogue))


def _run_nm_gather_dual(x2, pg, pu, cfg, blocks, epilogue=None, out_dtype=None):
    from .nm_spmm_gather.kernel import nm_spmm_gather_dual_bk
    return nm_spmm_gather_dual_bk(x2, pg["values"].to(x2.dtype), pg["gather_idx"],
                                  pu["values"].to(x2.dtype), pu["gather_idx"], cfg.n,
                                  block_b=blocks[0])


registry.register(KernelEntry(
    name="tile_gemm", mode="dense", fit_blocks=_fit_tile_gemm,
    run=_run_tile_gemm, run_dual=_run_tile_gemm_dual, activation_skip=True))
registry.register(KernelEntry(
    name="nm_spmm", mode="compressed", fit_blocks=_fit_nm_spmm,
    run=_run_nm_spmm, run_dual=_run_nm_spmm_dual, activation_skip=True))
registry.register(KernelEntry(
    name="nm_spmm_gather", mode="gather", fit_blocks=_fit_nm_gather,
    run=_run_nm_gather, run_dual=_run_nm_gather_dual, activation_skip=True))


# --- the quantized classes: int8 (w8a8) and fp8 (e4m3 weights and
# activations).  Narrow leaves x narrow activations into the class's
# accumulator (exact int32 | fp32), dequantized once at the flush.  The
# fits accept only their own storage dtype, so float problems never land
# here, float entries never see a narrow leaf and the two classes never
# collide.

def _quantize_acts(x2, params, dtype):
    """Narrow activations + (B, 1) scales: static (calibrated) when the
    leaf carries an ``act_scale``, else the dynamic per-row absmax pass.
    ``dtype`` is the leaf's storage dtype (int8 | float8_e4m3fn):
    activations quantize to the class the weights live in.

    Activations that arrive ALREADY narrow were requantized by the
    producing kernel's fused epilogue against THIS leaf's static scale:
    they are used as they are, with the (B, 1) row scales rebuilt from
    that scalar (the quantize pass disappears)."""
    if x2.dtype == dtype:
        if quant.ACT_SCALE_KEY not in params:
            raise ValueError("pre-quantized activations need a calibrated act_scale "
                             "on the consuming leaf (the fused requant quantized "
                             "against it)")
        s = params[quant.ACT_SCALE_KEY].float().reshape(1, 1)
        return x2, s.expand(x2.shape[0], 1).contiguous()
    if quant.ACT_SCALE_KEY in params:
        return quant.quantize_rows_static(x2, params[quant.ACT_SCALE_KEY], dtype)
    return quant.quantize_rows(x2, dtype)


def _w_scale(params):
    return params[quant.SCALE_KEY].reshape(1, -1)


def _q_kernel(module, base: str, qdt, requant: bool = False):
    """The wrapper of one quantized kernel for the leaf's storage dtype,
    looked up at call time (``tile_gemm_dual_fp8_requant`` ...)."""
    _, suffix, _ = _build.QUANT_CLASSES[qdt]
    return getattr(module, f"{base}_{suffix}{'_requant' if requant else ''}")


def _requant(epilogue) -> bool:
    return epilogue is not None and epilogue.spec.requant is not None


def _q_single_kw(epilogue, out_dtype, blocks) -> Dict[str, Any]:
    """Keyword arguments of a quantized single kernel (plain, masked or
    ``*_requant``): a requantizing point passes the consumer's scale and
    the kernel stores its class's codes, else ``out_dtype`` rows."""
    kw = dict(block_b=blocks[0], **_epi_kwargs(epilogue))
    if _requant(epilogue):
        return dict(kw, requant_scale=epilogue.requant_scale)
    return dict(kw, out_dtype=out_dtype)


# No row padding in the adapters: the kernels mask the ragged edge.  The
# masked runs take their maps from the narrow rows the kernel contracts
# (zeros quantize to code 0, so dead tiles stay dead).

def _run_tile_gemm_q(x2, params, cfg, blocks, epilogue=None, out_dtype=None,
                     activation=None):
    from .tile_gemm import kernel as tk
    qdt = params["w"].dtype
    xq, xs = _quantize_acts(x2, params, qdt)
    kw = _q_single_kw(epilogue, out_dtype, blocks)
    if activation is not None:
        return _q_kernel(tk, "tile_gemm_masked", qdt)(xq, params["w"], *_maps(xq, blocks),
                                                      xs, _w_scale(params), **kw)
    return _q_kernel(tk, "tile_gemm", qdt, requant=_requant(epilogue))(
        xq, params["w"], xs, _w_scale(params), **kw)


def _run_tile_gemm_dual_q(x2, pg, pu, cfg, blocks, epilogue=None, out_dtype=None):
    from .tile_gemm import kernel as tk
    # one x read, one quantize pass: the activations are shared, and the
    # gate leaf's static scale (both sites calibrate on the same rows)
    # quantizes them
    qdt = pg["w"].dtype
    xq, xs = _quantize_acts(x2, pg, qdt)
    args = (xq, pg["w"], pu["w"], xs, _w_scale(pg), _w_scale(pu))
    if _requant(epilogue):
        return _q_kernel(tk, "tile_gemm_dual", qdt, requant=True)(
            *args, epilogue.requant_scale, block_b=blocks[0])
    return _q_kernel(tk, "tile_gemm_dual", qdt)(*args, out_dtype=out_dtype,
                                                block_b=blocks[0])


def _run_nm_spmm_q(x2, params, cfg, blocks, epilogue=None, out_dtype=None,
                   activation=None):
    from .nm_spmm import kernel as nk
    qdt = params["values"].dtype
    xq, xs = _quantize_acts(x2, params, qdt)
    kw = _q_single_kw(epilogue, out_dtype, blocks)
    if activation is not None:
        return _q_kernel(nk, "nm_spmm_masked", qdt)(
            xq, params["values"], params["meta_packed"], *_maps(xq, blocks), cfg.n, xs,
            _w_scale(params), **kw)
    return _q_kernel(nk, "nm_spmm", qdt, requant=_requant(epilogue))(
        xq, params["values"], params["meta_packed"], xs, _w_scale(params), cfg.n, **kw)


def _run_nm_spmm_dual_q(x2, pg, pu, cfg, blocks, epilogue=None, out_dtype=None):
    from .nm_spmm import kernel as nk
    qdt = pg["values"].dtype
    xq, xs = _quantize_acts(x2, pg, qdt)
    args = (xq, pg["values"], pg["meta_packed"], pu["values"], pu["meta_packed"], cfg.n,
            xs, _w_scale(pg), _w_scale(pu))
    if _requant(epilogue):
        return _q_kernel(nk, "nm_spmm_dual", qdt, requant=True)(
            *args, epilogue.requant_scale, block_b=blocks[0])
    return _q_kernel(nk, "nm_spmm_dual", qdt)(*args, out_dtype=out_dtype,
                                              block_b=blocks[0])


def _run_nm_gather_q(x2, params, cfg, blocks, epilogue=None, out_dtype=None,
                     activation=None):
    from .nm_spmm_gather import kernel as gk
    # the rows quantize over their full K_eff width; the kernel gathers codes
    qdt = params["values"].dtype
    xq, xs = _quantize_acts(x2, params, qdt)
    kw = _q_single_kw(epilogue, out_dtype, blocks)
    if activation is not None:
        return _q_kernel(gk, "nm_spmm_gather_bk_masked", qdt)(
            xq, params["values"], params["gather_idx"], *_maps(xq, blocks), cfg.n, xs,
            _w_scale(params), **kw)
    return _q_kernel(gk, "nm_spmm_gather_bk", qdt, requant=_requant(epilogue))(
        xq, params["values"], params["gather_idx"], xs, _w_scale(params), cfg.n, **kw)


def _run_nm_gather_dual_q(x2, pg, pu, cfg, blocks, epilogue=None, out_dtype=None):
    from .nm_spmm_gather import kernel as gk
    qdt = pg["values"].dtype
    xq, xs = _quantize_acts(x2, pg, qdt)
    args = (xq, pg["values"], pg["gather_idx"], pu["values"], pu["gather_idx"], cfg.n, xs,
            _w_scale(pg), _w_scale(pu))
    if _requant(epilogue):
        return _q_kernel(gk, "nm_spmm_gather_dual_bk", qdt, requant=True)(
            *args, epilogue.requant_scale, block_b=blocks[0])
    return _q_kernel(gk, "nm_spmm_gather_dual_bk", qdt)(*args, out_dtype=out_dtype,
                                                        block_b=blocks[0])


registry.register(KernelEntry(
    name="tile_gemm_int8", mode="dense",
    fit_blocks=functools.partial(_fit_tile_gemm, storage=torch.int8),
    run=_run_tile_gemm_q, run_dual=_run_tile_gemm_dual_q, quantized=True,
    activation_skip=True))
registry.register(KernelEntry(
    name="nm_spmm_int8", mode="compressed",
    fit_blocks=functools.partial(_fit_nm_spmm, storage=torch.int8),
    run=_run_nm_spmm_q, run_dual=_run_nm_spmm_dual_q, quantized=True,
    activation_skip=True))
registry.register(KernelEntry(
    name="tile_gemm_fp8", mode="dense",
    fit_blocks=functools.partial(_fit_tile_gemm, storage=torch.float8_e4m3fn),
    run=_run_tile_gemm_q, run_dual=_run_tile_gemm_dual_q, quantized=True,
    activation_skip=True, supported=registry.supports_fp8))
registry.register(KernelEntry(
    name="nm_spmm_fp8", mode="compressed",
    fit_blocks=functools.partial(_fit_nm_spmm, storage=torch.float8_e4m3fn),
    run=_run_nm_spmm_q, run_dual=_run_nm_spmm_dual_q, quantized=True,
    activation_skip=True, supported=registry.supports_fp8))
registry.register(KernelEntry(
    name="nm_spmm_gather_int8", mode="gather",
    fit_blocks=functools.partial(_fit_nm_gather, storage=torch.int8),
    run=_run_nm_gather_q, run_dual=_run_nm_gather_dual_q, quantized=True,
    activation_skip=True))
registry.register(KernelEntry(
    name="nm_spmm_gather_fp8", mode="gather",
    fit_blocks=functools.partial(_fit_nm_gather, storage=torch.float8_e4m3fn),
    run=_run_nm_gather_q, run_dual=_run_nm_gather_dual_q, quantized=True,
    activation_skip=True, supported=registry.supports_fp8))


# --- flash attention: mode "attention", dims mapped as (b, ke, o) =
# (T_q, T_k, head_dim), blocks = (query rows, keys, head_dim) of one
# kernel step.  The Hopper kernel's own contract, not the TPU blocks of
# the JAX package's _fit_flash: bf16, head_dim in ``HEAD_DIMS`` (64, 80,
# 96, 128, 256), any T (the ragged edge is masked in the kernel), causal or
# not (``cfg.causal`` of the run, as the JAX package passes it).

def _fit_flash(b, ke, o, n, m, dtype):
    from .flash_attention.kernel import HEAD_DIMS
    if dtype_name(dtype) != "bfloat16" or o not in HEAD_DIMS:
        return None
    return (64, 64, o)


def _run_flash(x2, params, cfg, blocks, epilogue=None):
    from .flash_attention.kernel import flash_attention
    return flash_attention(params["q"], params["k"], params["v"], causal=cfg.causal)


registry.register(KernelEntry(
    name="flash_attention", mode="attention", fit_blocks=_fit_flash, run=_run_flash))


# ---------------------------------------------------------------------------
# Planning + execution
# ---------------------------------------------------------------------------

def _mode_of(params: Dict[str, Any], cfg) -> str:
    if "w" in params:
        return "masked" if (cfg.mode == "masked" and cfg.is_sparse) else "dense"
    if "meta_packed" in params:
        return "compressed"
    if "gather_idx" in params:
        return "gather"
    raise ValueError(f"unrecognized linear params: {list(params)}")


def _problem_dims(mode: str, params: Dict[str, Any], ke: int) -> Tuple[int, int]:
    """(ke, o): the activation width the plan sees (K_eff; compressed and
    gather contract over x's trailing dim) and the out features."""
    if mode in ("dense", "masked"):
        return tuple(params["w"].shape)
    return ke, params["values"].shape[1]


def input_features(params: Dict[str, Any], cfg) -> int:
    """Expected trailing dim of ``x`` for these params (K_eff)."""
    if _mode_of(params, cfg) in ("dense", "masked"):
        return params["w"].shape[0]
    return params["values"].shape[0] * cfg.m // cfg.n


def _under_autodiff(*tensors: torch.Tensor) -> bool:
    """The counterpart of the JAX package's JVP-tracer check: autograd is
    recording and some operand requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _leaf_tensors(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [v for v in params.values() if isinstance(v, torch.Tensor)]


def plan(problem: GemmProblem, *,
         dispatch: Optional[DispatchConfig] = None) -> DispatchDecision:
    """Pure decision function: what would the engine run for this problem?"""
    p = problem
    dcfg = dispatch or _DEFAULT
    backend = registry.resolve_backend(dcfg.backend, p.device)
    dt_name = dtype_name(p.dtype)

    def _fallback(code, **ctx):
        return DispatchDecision(
            p.mode, registry.REFERENCE_BACKEND, TORCH_REFERENCE, None,
            reasons.render(code, **ctx), dtype=dt_name, epilogue=p.epilogue,
            reason_code=code,
            epilogue_reason=(ReasonCode.EPILOGUE_JNP_TIER
                             if p.epilogue is not None else None),
            activation=p.activation,
            activation_reason=(ReasonCode.ACT_MASK_ONLY_JNP
                               if p.activation is not None else None))

    if p.mode == "masked":
        return _fallback(ReasonCode.SRSTE_TRAINING)
    if backend == registry.REFERENCE_BACKEND:
        return _fallback(ReasonCode.BACKEND_JNP)
    if p.differentiating:
        return _fallback(ReasonCode.AUTODIFF)
    if p.b == 0:
        return _fallback(ReasonCode.EMPTY_BATCH)
    sel = registry.select(p.mode, b=p.b, ke=p.ke, o=p.o, n=p.n, m=p.m,
                          dtype=p.dtype, backend=backend, device=p.device)
    if sel is None:
        return _fallback(ReasonCode.NO_KERNEL_FITS, where="", b=p.b, ke=p.ke,
                         o=p.o, n=p.n, m=p.m, dtype=dt_name)
    entry, blocks = sel
    epi_code = None
    if p.epilogue is not None:
        epi_code = (ReasonCode.EPILOGUE_NO_DUAL_KERNEL
                    if p.dual and entry.run_dual is None
                    else ReasonCode.EPILOGUE_FUSED)
    # the in-kernel dead-tile skip: never on duals (no masked dual
    # kernels), and only on entries whose adapter carries a masked kernel
    # (ACT_MASK_ONLY_SHARDED waits for the sharded placement)
    act_code = None
    if p.activation is not None:
        if p.dual:
            act_code = ReasonCode.ACT_MASK_ONLY_DUAL
        elif not entry.activation_skip:
            act_code = ReasonCode.ACT_MASK_ONLY_ENTRY
        else:
            act_code = ReasonCode.ACT_SKIP
    return DispatchDecision(
        p.mode, backend, entry.name, blocks,
        reasons.render(ReasonCode.BLOCKS_FITTED), blocks_source="fitted",
        dtype=dt_name, epilogue=p.epilogue,
        epilogue_fused=epi_code is ReasonCode.EPILOGUE_FUSED,
        reason_code=ReasonCode.BLOCKS_FITTED, epilogue_reason=epi_code,
        act_scales=(("static" if p.static_scales else "dynamic")
                    if entry.quantized else None),
        activation=p.activation, activation_skip=act_code is ReasonCode.ACT_SKIP,
        activation_reason=act_code)


def plan_for(params: Dict[str, Any], x_shape: Sequence[int], cfg, dtype=torch.float32,
             dispatch: Optional[DispatchConfig] = None) -> DispatchDecision:
    """Planning convenience for launchers and reports: no execution.  A
    quantized leaf plans on its storage dtype, whatever ``dtype`` says."""
    mode = _mode_of(params, cfg)
    b = math.prod(x_shape[:-1]) if len(x_shape) > 1 else 1
    ke, o = _problem_dims(mode, params, x_shape[-1])
    device = _leaf_tensors(params)[0].device
    return plan(GemmProblem(mode, b=b, ke=ke, o=o, n=cfg.n, m=cfg.m,
                            dtype=quant.quant_dtype(params) or dtype, device=device,
                            static_scales=quant.has_static_scales(params)),
                dispatch=dispatch)


def _entry_by_name(mode: str, name: str) -> KernelEntry:
    for e in registry.entries(mode):
        if e.name == name:
            return e
    raise KeyError(f"kernel {name!r} not registered for mode {mode!r}")


def sparse_matmul(x: torch.Tensor, params: Dict[str, Any], cfg, *,
                  dispatch: Optional[DispatchConfig] = None,
                  epilogue: Optional[Epilogue] = None,
                  activation: Optional[ActivationSpec] = None,
                  local: bool = False) -> torch.Tensor:
    """``y = epilogue(x @ W)`` for a dense, compressed or gather
    SparseLinear layout, via the dispatch engine.  ``x``: (..., K_eff) -> (..., O).

    On a kernel decision the epilogue is applied in the kernel's flush;
    the torch tier applies :func:`epilogue.apply_reference` after the
    product.  ``x`` may arrive already quantized (the int8 or e4m3 rows a
    fused requantize emitted against this leaf's ``act_scale``): a kernel
    contracts them as they are and returns fp32; the torch tier first
    dequantizes them with that scale.

    ``activation`` opts the call into the activation-sparsity class: the
    mask (:func:`actsparse.apply_mask`, the identity for ``"zeros"``) is
    applied to ``x`` on every route, and on a kernel decision whose entry
    carries a masked kernel the dead (row block, K step) tiles are also
    skipped in the kernel, with bitwise the same output.  ``local=True``
    marks a call that runs inside a sharded body (the JAX package's MoE
    experts); the port has no mesh yet, so it changes nothing here."""
    dcfg = dispatch or _DEFAULT
    mode = _mode_of(params, cfg)
    if activation is not None:
        x = apply_mask(x, activation)
    if epilogue is not None and epilogue.spec.is_identity:
        epilogue = None
    if epilogue is not None and epilogue.spec.act == "silu_mul":
        raise ValueError("silu_mul is the dual gate-up lattice point — "
                         "route it through gate_up_matmul")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ke, o = _problem_dims(mode, params, x2.shape[-1])
    # the dtype axis of the plan: a quantized leaf's storage dtype (the
    # weight operand selects the kernel), else the activations'
    exec_dtype = quant.quant_dtype(params) or x2.dtype
    pre_q = quant.is_quantized_dtype(x2.dtype)
    if pre_q and x2.dtype != exec_dtype:
        raise ValueError(f"pre-quantized activations ({dtype_name(x2.dtype)}) do not "
                         f"match this leaf's storage dtype ({dtype_name(exec_dtype)})")
    # static-scale calibration: report this site's activation absmax (no-op
    # outside a calibration)
    if quant.calibration_active() and quant._CALIB_KEY in params and not pre_q:
        quant.record_calibration(params[quant._CALIB_KEY], x2)
    decision = plan(GemmProblem(
        mode, b=x2.shape[0], ke=ke, o=o, n=cfg.n, m=cfg.m, dtype=exec_dtype,
        differentiating=_under_autodiff(x2, *_leaf_tensors(params)),
        epilogue=epilogue.spec.point if epilogue is not None else None,
        device=x2.device, static_scales=quant.has_static_scales(params),
        activation=activation.point if activation is not None else None), dispatch=dcfg)
    if pre_q and not decision.uses_kernel:
        # the reference tier contracts float activations: undo the upstream
        # fused requantize with the leaf's own static scale
        x2 = x2.float() * params[quant.ACT_SCALE_KEY].float().reshape(())
    if not decision.uses_kernel:
        if mode not in _TORCH_IMPL:
            raise NotImplementedError(f"{mode!r} layouts are not ported yet")
        y2 = epilib.apply_reference(_TORCH_IMPL[mode](x2, params, cfg), epilogue)
        return y2.reshape(*lead, o)
    entry = _entry_by_name(mode, decision.kernel)
    # the masked kernel runs only where the plan granted the skip
    act_kw = {"activation": activation} if decision.activation_skip else {}
    y2 = entry.run(x2.contiguous(), params, cfg, decision.blocks,
                   epilogue=epilogue if decision.epilogue_fused else None,
                   out_dtype=torch.float32 if pre_q else x2.dtype, **act_kw)
    return y2.reshape(*lead, o)


def gate_up_matmul(x: torch.Tensor, params_g: Dict[str, Any],
                   params_u: Dict[str, Any], cfg, *,
                   dispatch: Optional[DispatchConfig] = None,
                   epilogue: Optional[Epilogue] = None,
                   activation: Optional[ActivationSpec] = None,
                   local: bool = False) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)`` as ONE engine call.

    ``epilogue`` must sit on the ``silu_mul`` lattice point, optionally
    extended with ``requant:<dtype>`` from :func:`requant_plan` on the
    next linear.  When both leaves share mode, shape, storage dtype and
    static-scale presence and the plan lands on a kernel, one dual launch
    reads each activation tile once (quantized: quantizes it once), applies
    silu*mul to the two accumulators in fp32 and, with the requant point,
    emits the narrow rows the next linear contracts.  Otherwise the torch
    tier runs two GEMMs and applies silu*mul to their results (rounded to
    the activation dtype first, as the JAX package's jnp tier does), and
    never the requant: the consumer's own static quantize gives the same
    codes from the float rows.  ``activation`` and ``local`` are as for
    :func:`sparse_matmul`; the dual never skips (``ACT_MASK_ONLY_DUAL``:
    there are no masked duals), it contracts the masked operand."""
    dcfg = dispatch or _DEFAULT
    if epilogue is None:
        epilogue = epilib.make(act="silu_mul")
    if epilogue.spec.act != "silu_mul" or epilogue.spec.bias:
        raise ValueError(f"gate_up_matmul epilogue must sit on the silu_mul "
                         f"lattice point (optionally +requant), got "
                         f"{epilogue.spec.point!r}")
    mode_g, mode_u = _mode_of(params_g, cfg), _mode_of(params_u, cfg)
    if activation is not None:
        x = apply_mask(x, activation)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ke, o = _problem_dims(mode_g, params_g, x2.shape[-1])
    # both sites see the same activations: record each calibration tag here
    if quant.calibration_active():
        for p in (params_g, params_u):
            if quant._CALIB_KEY in p:
                quant.record_calibration(p[quant._CALIB_KEY], x2)
    qdt = quant.quant_dtype(params_g)
    pair_ok = (mode_g == mode_u and mode_g in _TORCH_IMPL
               and _problem_dims(mode_u, params_u, x2.shape[-1]) == (ke, o)
               and quant.quant_dtype(params_u) == qdt
               and quant.has_static_scales(params_u) == quant.has_static_scales(params_g))
    if pair_ok:
        decision = plan(GemmProblem(
            mode_g, b=x2.shape[0], ke=ke, o=o, n=cfg.n, m=cfg.m, dtype=qdt or x2.dtype,
            differentiating=_under_autodiff(
                x2, *_leaf_tensors(params_g), *_leaf_tensors(params_u)),
            epilogue=epilogue.spec.point, dual=True, device=x2.device,
            static_scales=quant.has_static_scales(params_g),
            activation=activation.point if activation is not None else None),
            dispatch=dcfg)
        if decision.epilogue_fused:
            entry = _entry_by_name(mode_g, decision.kernel)
            pre_q = quant.is_quantized_dtype(x2.dtype)
            y2 = entry.run_dual(x2.contiguous(), params_g, params_u, cfg,
                                decision.blocks, epilogue=epilogue,
                                out_dtype=torch.float32 if pre_q else x2.dtype)
            return y2.reshape(*lead, o)
    y_g = sparse_matmul(x2, params_g, cfg, dispatch=dcfg, activation=activation, local=local)
    y_u = sparse_matmul(x2, params_u, cfg, dispatch=dcfg, activation=activation, local=local)
    h = F.silu(y_g.float()) * y_u.float()
    return h.to(y_g.dtype).reshape(*lead, o)


def requant_decision(consumer_params: Dict[str, Any], batch_shape: Sequence[int], cfg,
                     dispatch: Optional[DispatchConfig] = None
                     ) -> Tuple[Optional[Tuple[str, torch.Tensor]], ReasonCode]:
    """Should the PRODUCER of these activations fuse a requantize, and if
    not, the :class:`ReasonCode` saying why.

    A producing kernel may end its epilogue with ``requant:<dtype>``,
    emitting the narrow rows the next quantized linear contracts as they
    are, exactly when the CONSUMER leaf (a) quantizes against a
    calibrated static ``act_scale`` (the fused cast must hit the scale
    the consumer's own quantize would use) and (b) runs a kernel itself
    (the torch tier wants float rows).  ``batch_shape`` is the leading
    shape of the activations the producer will emit.  Returns
    ``((dtype_name, scalar_scale), code)`` on a fused plan, ``(None,
    code)`` on a decline; producer and consumer both derive the decision
    from this one function, so they cannot disagree."""
    qdt = quant.quant_dtype(consumer_params)
    if qdt is None:
        return None, ReasonCode.REQUANT_NO_QUANT
    if not quant.has_static_scales(consumer_params):
        return None, ReasonCode.REQUANT_DYNAMIC_SCALES
    try:
        ke = input_features(consumer_params, cfg)
        d = plan_for(consumer_params, tuple(batch_shape) + (ke,), cfg, dtype=qdt,
                     dispatch=dispatch)
    except ValueError:   # an unrecognized layout: no requant
        return None, ReasonCode.REQUANT_LAYOUT
    if not d.uses_kernel:
        return None, ReasonCode.REQUANT_CONSUMER_FALLBACK
    s = consumer_params[quant.ACT_SCALE_KEY].float().reshape(())
    return (dtype_name(qdt), s), ReasonCode.REQUANT_FUSED


def requant_plan(consumer_params: Dict[str, Any], batch_shape: Sequence[int], cfg,
                 dispatch: Optional[DispatchConfig] = None
                 ) -> Optional[Tuple[str, torch.Tensor]]:
    """:func:`requant_decision` minus the reason code: the execution paths
    (``layers.apply_mlp``) only need the operands."""
    result, _ = requant_decision(consumer_params, batch_shape, cfg, dispatch=dispatch)
    return result


def attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              q_offset: int = 0, p_bf16: bool = False,
              dispatch: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Full-sequence attention via the dispatch engine, causal or not
    (an encoder's ``cfg.causal = False``).

    qg (B, Hkv, G, Tq, D) grouped queries; k, v (B, Tk, Hkv, D) ->
    (B, Hkv, G, Tq, D).  On a kernel backend the registry's
    ``flash_attention`` entry runs (self-attention shapes only: Tq == Tk,
    no query offset); the chunked online-softmax formulation
    (``models.attention.chunked_attention``) is the reference and the
    fallback: under autograd, on the torch tier, or when a shape or
    dtype fails the kernel's contract."""
    from ..models.attention import chunked_attention   # local: avoid a cycle

    dcfg = dispatch or _DEFAULT
    b, hkv, grp, tq, d = qg.shape
    tk = k.shape[1]
    decision = plan(GemmProblem("attention", b=tq, ke=tk, o=d, n=4, m=4, dtype=qg.dtype,
                                differentiating=_under_autodiff(qg, k, v),
                                device=qg.device), dispatch=dcfg)
    if not decision.uses_kernel or tq != tk or q_offset != 0:
        return chunked_attention(qg, k, v, causal, q_offset, p_bf16)
    entry = _entry_by_name("attention", decision.kernel)
    # (B, Hkv, G, T, D) -> (B, Hq, T, D) and (B, T, Hkv, D) -> (B, Hkv, T, D):
    # views, no copies; the kernel maps query head h to KV head h // G
    out = entry.run(None, {"q": qg.reshape(b, hkv * grp, tq, d), "k": k.transpose(1, 2),
                           "v": v.transpose(1, 2)},
                    types.SimpleNamespace(causal=causal), decision.blocks)
    return out.reshape(b, hkv, grp, tq, d)


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def _first_slice(v, nd: int):
    """Strip leading stack dims off one leaf (the first slice)."""
    if not isinstance(v, torch.Tensor) or v.ndim <= nd:
        return v
    return v.reshape((-1,) + tuple(v.shape[v.ndim - nd:]))[0]


def iter_linear_items(tree, _names=()):
    """Yield ``(names, leaf)`` for every SparseLinear param dict in a
    params tree; ``names`` is the key path (list items as ``[i]``).  A
    stacked leaf (an MoE layer's experts, ``(E, K, O)``) is yielded as its
    first slice; linears beside a ``router`` key get an ``experts`` marker
    in their path, as in the JAX package."""
    if isinstance(tree, dict):
        if is_linear_leaf(tree):
            # static activation scales and calibration tags are 0-D per
            # layer, quantization scales and gather indices 1-D, the rest 2-D
            yield _names, {k: _first_slice(v, 0 if k in (quant.ACT_SCALE_KEY, quant._CALIB_KEY)
                                            else 1 if k in ("gather_idx", quant.SCALE_KEY)
                                            else 2)
                           for k, v in tree.items()}
            return
        mark = ("experts",) if "router" in tree else ()
        for k, v in tree.items():
            yield from iter_linear_items(v, _names + mark + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_linear_items(v, _names + (f"[{i}]",))


def _leaf_dtype(leaf: Dict[str, Any]) -> torch.dtype:
    return leaf.get("values", leaf.get("w")).dtype


def dispatch_report(params_tree, batches, cfg,
                    dispatch: Optional[DispatchConfig] = None) -> List[str]:
    """Distinct (shape -> engine decision) plan lines for a params tree,
    at each leading batch width the serving path runs (decode slots and
    the prefill chunk), followed by the fused gate-up pairs."""
    if isinstance(batches, int):
        batches = (batches,)
    dcfg = dispatch or _DEFAULT
    seen, dual_seen = {}, {}
    for batch in batches:
        pairs = {}
        for names, leaf in iter_linear_items(params_tree):
            ke = input_features(leaf, cfg)
            hint = gather_hint(names)
            d = plan_for(leaf, (batch, ke), cfg, dtype=_leaf_dtype(leaf),
                         dispatch=dcfg)
            o = leaf["w"].shape[-1] if "w" in leaf else leaf["values"].shape[-1]
            seen.setdefault((batch, d.mode, cfg.n, ke, o, str(hint)), d)
            if names and names[-1] in ("w_gate", "w_in"):
                pairs.setdefault(tuple(names[:-1]), {})[names[-1]] = (names, leaf)
        for found in pairs.values():
            if "w_gate" not in found or "w_in" not in found:
                continue
            gnames, gleaf = found["w_gate"]
            _, uleaf = found["w_in"]
            mode = _mode_of(gleaf, cfg)
            ke = input_features(gleaf, cfg)
            _, o = _problem_dims(mode, gleaf, ke)
            if (_mode_of(uleaf, cfg) != mode or _problem_dims(mode, uleaf, ke) != (ke, o)
                    or _leaf_dtype(uleaf) != _leaf_dtype(gleaf)):
                continue
            d = plan(GemmProblem(mode, b=batch, ke=ke, o=o, n=cfg.n, m=cfg.m,
                                 dtype=_leaf_dtype(gleaf), epilogue="silu_mul",
                                 dual=True, device=_leaf_tensors(gleaf)[0].device,
                                 static_scales=quant.has_static_scales(gleaf)),
                     dispatch=dcfg)
            dual_seen.setdefault(
                (batch, mode, cfg.n, ke, o, str(gather_hint(gnames))), d)
    lines = []
    for (batch, _, n, ke, o, hint), d in sorted(seen.items()):
        lines.append(f"  [{hint if hint != 'None' else 'rep'}] {n}:{cfg.m} "
                     f"global (B={batch}, K={ke}, O={o}) {describe(d)}")
    for (batch, _, n, ke, o, hint), d in sorted(dual_seen.items()):
        lines.append(f"  [gate-up {hint if hint != 'None' else 'rep'}] {n}:{cfg.m} "
                     f"global (B={batch}, K={ke}, O={o}) {describe(d)}")
    return lines
