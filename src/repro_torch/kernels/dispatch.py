"""Unified sparse-GEMM dispatch engine.

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

Tensor parallelism (the JAX package's ``shard_map`` execution class).
Under an installed :class:`~repro_torch.models.pjit_utils.AxisEnv` a
hinted use site (``apply_linear(gather="col" | "row")``) gets a
:class:`ShardSpec`, and :func:`plan` decides on the GLOBAL problem with
the reference's words: ``placement="shard_map"``, ``collective="psum"``
(row-parallel: the contraction is sliced) or ``"none"`` (column-parallel:
the out features are), ``local_dims`` the problem each rank's kernel
runs, and the reference's declines (``SHARD_INDIVISIBLE``,
``META_AXIS_SPLIT``, ``NO_SHARD_SPEC``, ``EPILOGUE_SHARDED``,
``ACT_MASK_ONLY_SHARDED``).  In torch there is no ``shard_map`` and no
``psum``: every rank holds its own shard of the weights
(``launch.shardings``) and the local activations, runs the kernel on
them, and a row-parallel site all-reduces (SUM over the model axis's
process group) what the reference psums: the raw int32 / fp32
accumulators of the quantized entries (K5 / K6 raw, K11 for gather), the
rows quantized against the all-reduced MAX of the shards' row absmax (or
the static scale), then one dequantize; fp32 partials for the float
entries and the torch tier.

What the slice leaves out, each still planned by the JAX package only:
the rowwise layout and autotuning.  Blocks are always fitted
(``ReasonCode.BLOCKS_FITTED``).

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
    "ShardSpec",
    "shard_spec_from_env",
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
class ShardSpec:
    """How the model axis slices one (b, ke, o) GEMM at its use site.

    Each field is a mesh axis name (or tuple of names) slicing that dim,
    or ``None`` for replicated.  ``mesh`` is anything with the mesh's
    ``.shape`` mapping (the installed ``AxisEnv``), the only part of a mesh
    a plan reads.  Column-parallel weights slice ``o`` (no collective),
    row-parallel ones ``ke`` (partial products all-reduced)."""

    mesh: Any
    batch: Any = None
    ke: Any = None
    o: Any = None

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.mesh.shape[a] for a in axes)

    @property
    def shards(self) -> Tuple[int, int, int]:
        return (self.axis_size(self.batch), self.axis_size(self.ke),
                self.axis_size(self.o))

    @property
    def collective(self) -> str:
        return "psum" if self.axis_size(self.ke) > 1 else "none"


def _axis_env():
    from ..models.pjit_utils import axis_env   # local: the models import this module
    return axis_env()


def _mesh_active() -> bool:
    return _axis_env() is not None


def shard_spec_from_env(gather: Optional[str] = None) -> Optional[ShardSpec]:
    """ShardSpec for the installed axis env, or ``None`` without one.
    ``gather`` is the use-site hint ("col" | "row" | None)."""
    from ..models.pjit_utils import BATCH_AXIS, MODEL_AXIS
    env = _axis_env()
    if env is None:
        return None
    if gather == "col":
        return ShardSpec(mesh=env, batch=BATCH_AXIS, o=MODEL_AXIS)
    if gather == "row":
        return ShardSpec(mesh=env, batch=BATCH_AXIS, ke=MODEL_AXIS)
    return ShardSpec(mesh=env, batch=BATCH_AXIS)


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """ONE value object describing a GEMM the engine may plan.

    ``device`` is where the operands live: with ``backend="auto"`` it
    picks the tier (``cuda`` for CUDA tensors, ``torch`` otherwise).
    ``epilogue`` is the canonical lattice point string
    (``EpilogueSpec.point``); ``dual`` marks a fused gate-up pair.
    ``static_scales`` records whether the use site carries a calibrated
    activation scale; it only annotates the decision.  ``activation`` is
    the activation-sparsity point (``ActivationSpec.point``).  ``sharded``:
    an axis env is installed (and the call is not ``local``); ``shard``:
    the use site's slicing, the dims above being the GLOBAL problem."""

    mode: str
    b: int
    ke: int
    o: int
    n: int = 4
    m: int = 4
    dtype: Any = torch.float32
    differentiating: bool = False
    sharded: bool = False
    shard: Optional[ShardSpec] = None
    epilogue: Optional[str] = None
    dual: bool = False
    device: Any = None
    static_scales: bool = False
    activation: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """What the engine chose for one problem, and why.  ``placement`` is
    "single" or "shard_map" (the reference's word: each rank runs the
    kernel on its shard, ``local_dims``, and ``collective`` "psum" means
    an all-reduce SUM of the partials over the model axis)."""

    mode: str
    backend: str
    kernel: str                    # registry entry name or TORCH_REFERENCE
    blocks: Optional[Blocks]
    reason: str
    blocks_source: str = "none"    # none | fitted
    placement: str = "single"      # single | shard_map
    local_dims: Optional[Tuple[int, int, int]] = None   # per-shard (b, ke, o)
    shards: Optional[Tuple[int, int, int]] = None       # mesh split of (b, ke, o)
    collective: Optional[str] = None                    # psum | none
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

    @property
    def uses_shard_map(self) -> bool:
        return self.placement == "shard_map"


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
    if d.uses_shard_map:
        (lb, lke, lo), (sb, ske, so) = d.local_dims, d.shards
        epi += (f" shard_map[{d.collective}] shards=(b/{sb},ke/{ske},o/{so})"
                f" local=(b={lb},ke={lke},o={lo})")
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
    return tile_gemm(x2, w, block_b=blocks[0], out_dtype=out_dtype, **_epi_kwargs(epilogue))


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
                   out_dtype=out_dtype, **_epi_kwargs(epilogue))


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
                             out_dtype=out_dtype, **_epi_kwargs(epilogue))


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


# --- raw partials (``KernelEntry.run_quantized``): the class's accumulator
# of rows already quantized and padded, no scales.  A row-parallel shard
# all-reduces it before the one dequantize.  The gather layout runs K11,
# the K-major nm_spmm_gather_{int8,fp8}, on xq.t() and hands back y_t.t(),
# as the JAX package's _partial_nm_gather_q does.

def _partial_tile_gemm_q(xq, params, cfg, blocks):
    from .tile_gemm import kernel as tk
    return _q_kernel(tk, "tile_gemm", params["w"].dtype)(xq, params["w"], None, None)


def _partial_nm_spmm_q(xq, params, cfg, blocks):
    from .nm_spmm import kernel as nk
    return _q_kernel(nk, "nm_spmm", params["values"].dtype)(
        xq, params["values"], params["meta_packed"], None, None, cfg.n)


def _partial_nm_gather_q(xq, params, cfg, blocks):
    from .nm_spmm_gather import kernel as gk
    y_t = _q_kernel(gk, "nm_spmm_gather", params["values"].dtype)(
        xq.t().contiguous(), params["values"], params["gather_idx"].reshape(-1, 1), None,
        None, cfg.n)
    return y_t.t()


registry.register(KernelEntry(
    name="tile_gemm_int8", mode="dense",
    fit_blocks=functools.partial(_fit_tile_gemm, storage=torch.int8),
    run=_run_tile_gemm_q, run_dual=_run_tile_gemm_dual_q, quantized=True,
    run_quantized=_partial_tile_gemm_q,
    activation_skip=True))
registry.register(KernelEntry(
    name="nm_spmm_int8", mode="compressed",
    fit_blocks=functools.partial(_fit_nm_spmm, storage=torch.int8),
    run=_run_nm_spmm_q, run_dual=_run_nm_spmm_dual_q, quantized=True,
    run_quantized=_partial_nm_spmm_q,
    activation_skip=True))
registry.register(KernelEntry(
    name="tile_gemm_fp8", mode="dense",
    fit_blocks=functools.partial(_fit_tile_gemm, storage=torch.float8_e4m3fn),
    run=_run_tile_gemm_q, run_dual=_run_tile_gemm_dual_q, quantized=True,
    run_quantized=_partial_tile_gemm_q,
    activation_skip=True, supported=registry.supports_fp8))
registry.register(KernelEntry(
    name="nm_spmm_fp8", mode="compressed",
    fit_blocks=functools.partial(_fit_nm_spmm, storage=torch.float8_e4m3fn),
    run=_run_nm_spmm_q, run_dual=_run_nm_spmm_dual_q, quantized=True,
    run_quantized=_partial_nm_spmm_q,
    activation_skip=True, supported=registry.supports_fp8))
registry.register(KernelEntry(
    name="nm_spmm_gather_int8", mode="gather",
    fit_blocks=functools.partial(_fit_nm_gather, storage=torch.int8),
    run=_run_nm_gather_q, run_dual=_run_nm_gather_dual_q, quantized=True,
    run_quantized=_partial_nm_gather_q,
    activation_skip=True))
registry.register(KernelEntry(
    name="nm_spmm_gather_fp8", mode="gather",
    fit_blocks=functools.partial(_fit_nm_gather, storage=torch.float8_e4m3fn),
    run=_run_nm_gather_q, run_dual=_run_nm_gather_dual_q, quantized=True,
    run_quantized=_partial_nm_gather_q,
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


def _meta_axis_sliceable(mode: str, ke: int, n: int, m: int, ske: int) -> bool:
    """Can the contraction be cut into ``ske`` shards without splitting N:M
    metadata?  compressed: each shard's values rows pack whole meta bytes,
    ``ke * n % (4 * m * ske) == 0``; gather: shard boundaries fall on
    M-blocks (local indices stay block-relative), ``ke % (m * ske) == 0``."""
    if ske <= 1:
        return True
    if mode == "compressed":
        return (ke * n) % (4 * m * ske) == 0
    if mode == "gather":
        return ke % (m * ske) == 0
    return ke % ske == 0


#: plans made while :func:`plan_cache` is active, by (problem, config)
_PLAN_CACHE: Optional[Dict[Tuple[GemmProblem, DispatchConfig], DispatchDecision]] = None


@contextlib.contextmanager
def plan_cache():
    """Memoize :func:`plan` while active (a serving loop, where the
    registry, the environment and the mesh stay as they are): a decode step
    asks the same few questions hundreds of times.  A problem with a
    ``shard`` (whose mesh is unhashable) is planned anew each time."""
    global _PLAN_CACHE
    prev = _PLAN_CACHE
    _PLAN_CACHE = {} if prev is None else prev
    try:
        yield
    finally:
        _PLAN_CACHE = prev


def plan(problem: GemmProblem, *,
         dispatch: Optional[DispatchConfig] = None) -> DispatchDecision:
    """Pure decision function: what would the engine run for this problem?

    With ``problem.shard`` (a hinted site under an axis env) the engine
    plans the sharded class on the GLOBAL problem: blocks are fitted to
    the per-rank ``local_dims``, the epilogue is never fused
    (``EPILOGUE_SHARDED``: it runs after the reduction) and the
    activation skip never granted (``ACT_MASK_ONLY_SHARDED``).
    ``sharded`` without a spec falls back (``NO_SHARD_SPEC``)."""
    dcfg = dispatch or _DEFAULT
    cache = _PLAN_CACHE
    if cache is None or problem.shard is not None:
        return _plan(problem, dcfg)
    key = (problem, dcfg)
    decision = cache.get(key)
    if decision is None:
        decision = cache[key] = _plan(problem, dcfg)
    return decision


def _plan(p: GemmProblem, dcfg: DispatchConfig) -> DispatchDecision:
    backend = registry.resolve_backend(dcfg.backend, p.device)
    dt_name = dtype_name(p.dtype)
    shard = p.shard

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
    if shard is not None and all(s == 1 for s in shard.shards):
        shard = None   # a trivial slicing: the single placement
    if p.sharded and shard is None:
        return _fallback(ReasonCode.NO_SHARD_SPEC)
    if p.b == 0:
        return _fallback(ReasonCode.EMPTY_BATCH)
    shards = (1, 1, 1)
    placement, local, collective = "single", None, None
    if shard is not None:
        shards = shard.shards
        local = registry.local_dims((p.b, p.ke, p.o), shards)
        if local is None:
            return _fallback(ReasonCode.SHARD_INDIVISIBLE, shards=shards, b=p.b, ke=p.ke,
                             o=p.o)
        if not _meta_axis_sliceable(p.mode, p.ke, p.n, p.m, shards[1]):
            return _fallback(ReasonCode.META_AXIS_SPLIT, n=p.n, m=p.m, ke=p.ke,
                             ske=shards[1])
        placement, collective = "shard_map", shard.collective
    sel = registry.select(p.mode, b=p.b, ke=p.ke, o=p.o, n=p.n, m=p.m,
                          dtype=p.dtype, backend=backend, device=p.device, shards=shards)
    if sel is None:
        dims = local if shard is not None else (p.b, p.ke, p.o)
        return _fallback(ReasonCode.NO_KERNEL_FITS,
                         where="local shard " if shard is not None else "",
                         b=dims[0], ke=dims[1], o=dims[2], n=p.n, m=p.m, dtype=dt_name)
    entry, blocks = sel
    epi_code = None
    if p.epilogue is not None:
        if placement != "single":
            epi_code = ReasonCode.EPILOGUE_SHARDED
        elif p.dual and entry.run_dual is None:
            epi_code = ReasonCode.EPILOGUE_NO_DUAL_KERNEL
        else:
            epi_code = ReasonCode.EPILOGUE_FUSED
    # the in-kernel dead-tile skip: single placement only, never on duals
    # (no masked dual kernels), and only on entries whose adapter carries a
    # masked kernel
    act_code = None
    if p.activation is not None:
        if placement != "single":
            act_code = ReasonCode.ACT_MASK_ONLY_SHARDED
        elif p.dual:
            act_code = ReasonCode.ACT_MASK_ONLY_DUAL
        elif not entry.activation_skip:
            act_code = ReasonCode.ACT_MASK_ONLY_ENTRY
        else:
            act_code = ReasonCode.ACT_SKIP
    return DispatchDecision(
        p.mode, backend, entry.name, blocks,
        reasons.render(ReasonCode.BLOCKS_FITTED), blocks_source="fitted",
        placement=placement, local_dims=local, shards=shards if shard else None,
        collective=collective, dtype=dt_name, epilogue=p.epilogue,
        epilogue_fused=epi_code is ReasonCode.EPILOGUE_FUSED,
        reason_code=ReasonCode.BLOCKS_FITTED, epilogue_reason=epi_code,
        act_scales=(("static" if p.static_scales else "dynamic")
                    if entry.quantized else None),
        activation=p.activation, activation_skip=act_code is ReasonCode.ACT_SKIP,
        activation_reason=act_code)


def _global_dims(ke: int, o: int, shard: Optional[ShardSpec]) -> Tuple[int, int]:
    """The global (ke, o) of a rank's local ones under ``shard``."""
    if shard is None:
        return ke, o
    _, ske, so = shard.shards
    return ke * ske, o * so


def plan_for(params: Dict[str, Any], x_shape: Sequence[int], cfg, dtype=torch.float32,
             dispatch: Optional[DispatchConfig] = None,
             shard: Optional[ShardSpec] = None) -> DispatchDecision:
    """Planning convenience for launchers and reports: no execution.  A
    quantized leaf plans on its storage dtype, whatever ``dtype`` says.
    Under ``shard``, ``params`` and ``x_shape`` are this rank's (its
    shard of the leaf, its local activations) and the plan's problem is
    the global one."""
    mode = _mode_of(params, cfg)
    b = math.prod(x_shape[:-1]) if len(x_shape) > 1 else 1
    ke, o = _global_dims(*_problem_dims(mode, params, x_shape[-1]), shard)
    device = _leaf_tensors(params)[0].device
    return plan(GemmProblem(mode, b=b, ke=ke, o=o, n=cfg.n, m=cfg.m,
                            dtype=quant.quant_dtype(params) or dtype, device=device,
                            sharded=_mesh_active(), shard=shard,
                            static_scales=quant.has_static_scales(params)),
                dispatch=dispatch)


def _entry_by_name(mode: str, name: str) -> KernelEntry:
    for e in registry.entries(mode):
        if e.name == name:
            return e
    raise KeyError(f"kernel {name!r} not registered for mode {mode!r}")


def _pad_rows(xq: torch.Tensor, b_pad: int) -> torch.Tensor:
    """Zero rows up to ``b_pad`` (they contract to zero and are sliced off)."""
    pad = b_pad - xq.shape[0]
    if pad == 0:
        return xq
    return torch.cat([xq, torch.zeros((pad, xq.shape[1]), dtype=xq.dtype, device=xq.device)])


#: the row quantum of the raw partials (the JAX package's _q_padded_b; K11
#: needs a multiple of 16)
Q_ROWS = 32


def _q_padded_b(b: int) -> int:
    return b + (-b) % Q_ROWS


def _run_sharded(x2, params, cfg, mode, decision, shard, out_dtype):
    """One rank's part of a sharded site, what the reference's
    ``_shard_map_runner`` body computes on its shard.  ``x2`` and
    ``params`` are this rank's (local rows of the contraction at a row
    site); a row site all-reduces over the model axis:

    - quantized kernel: rows quantized against the static scale, or
      against the all-reduced MAX of the shards' row absmax; padded to
      :data:`Q_ROWS`; the raw accumulator (K5 / K6 raw, K11 for gather)
      all-reduced in int32 / fp32, then ``acc * xs * ws`` once;
    - float kernel or the torch tier: fp32 partials all-reduced, one cast.
    """
    env = shard.mesh
    psum = shard.collective == "psum"
    entry = _entry_by_name(mode, decision.kernel) if decision.uses_kernel else None
    if psum and entry is not None and entry.run_quantized is not None:
        qdt = quant.quant_dtype(params)
        b = x2.shape[0]
        if quant.ACT_SCALE_KEY in params:
            xq, xs = quant.quantize_rows_static(x2, params[quant.ACT_SCALE_KEY], qdt)
        else:
            absmax = env.all_reduce(x2.float().abs().amax(dim=-1, keepdim=True), "max")
            xq, xs = quant.quantize_rows(x2, qdt, absmax=absmax)
        acc = entry.run_quantized(_pad_rows(xq, _q_padded_b(b)), params, cfg,
                                  decision.blocks).contiguous()
        env.all_reduce(acc, "sum")
        return (acc[:b].float() * xs * _w_scale(params)).to(out_dtype)
    if entry is not None:
        y = entry.run(x2.contiguous(), params, cfg, decision.blocks,
                      out_dtype=torch.float32 if psum else out_dtype)
    else:
        y = _TORCH_IMPL[mode](x2.float() if psum else x2, params, cfg)
    if psum:
        y = env.all_reduce(y.float().contiguous(), "sum")
    return y.to(out_dtype)


def sparse_matmul(x: torch.Tensor, params: Dict[str, Any], cfg, *,
                  dispatch: Optional[DispatchConfig] = None,
                  shard: Optional[ShardSpec] = None,
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
    experts): planning does not consult the axis env.

    ``shard`` (``shard_spec_from_env(hint)`` at a hinted site under an axis
    env) runs the sharded class: ``x`` and ``params`` are this rank's (its
    activations, its shard of the leaf), the plan is the global problem's,
    and the output is this rank's, all-reduced at a row-parallel site
    (:func:`_run_sharded`); the epilogue then runs unfused."""
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
    ke_l, o = _problem_dims(mode, params, x2.shape[-1])
    if local:
        shard = None
    ke, o_g = _global_dims(ke_l, o, shard)
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
        mode, b=x2.shape[0], ke=ke, o=o_g, n=cfg.n, m=cfg.m, dtype=exec_dtype,
        differentiating=_under_autodiff(x2, *_leaf_tensors(params)),
        sharded=False if local else _mesh_active(), shard=shard,
        epilogue=epilogue.spec.point if epilogue is not None else None,
        device=x2.device, static_scales=quant.has_static_scales(params),
        activation=activation.point if activation is not None else None), dispatch=dcfg)
    if pre_q and not (decision.uses_kernel and decision.placement == "single"):
        # the reference tier and the sharded bodies contract float
        # activations: undo the upstream fused requantize with the leaf's
        # own static scale
        x2 = x2.float() * params[quant.ACT_SCALE_KEY].float().reshape(())
    if shard is not None and any(s > 1 for s in shard.shards):
        # every rank holds its shard, so a declined plan (the torch tier)
        # runs sharded too: the same partials, the same reduction
        y2 = _run_sharded(x2, params, cfg, mode, decision, shard,
                          torch.float32 if pre_q else x2.dtype)
        return epilib.apply_reference(y2, epilogue).reshape(*lead, o)
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
                   shard: Optional[ShardSpec] = None,
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
    codes from the float rows.  ``activation``, ``local`` and ``shard`` are
    as for :func:`sparse_matmul`; the dual never skips
    (``ACT_MASK_ONLY_DUAL``: there are no masked duals), it contracts the
    masked operand.  Under a column shard the pair plans
    ``EPILOGUE_SHARDED``: two GEMMs over the rank's column slices of Wg
    and Wu (the rank's part of the reference's ``[Wg | Wu]`` concat, read
    once and not copied), and silu*mul after, on the rank."""
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
    if local:
        shard = None
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
        ke_g, o_g = _global_dims(ke, o, shard)
        decision = plan(GemmProblem(
            mode_g, b=x2.shape[0], ke=ke_g, o=o_g, n=cfg.n, m=cfg.m, dtype=qdt or x2.dtype,
            differentiating=_under_autodiff(
                x2, *_leaf_tensors(params_g), *_leaf_tensors(params_u)),
            sharded=False if local else _mesh_active(), shard=shard,
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
    y_g = sparse_matmul(x2, params_g, cfg, dispatch=dcfg, shard=shard, activation=activation,
                        local=local)
    y_u = sparse_matmul(x2, params_u, cfg, dispatch=dcfg, shard=shard, activation=activation,
                        local=local)
    h = F.silu(y_g.float()) * y_u.float()
    return h.to(y_g.dtype).reshape(*lead, o)


def requant_decision(consumer_params: Dict[str, Any], batch_shape: Sequence[int], cfg,
                     dispatch: Optional[DispatchConfig] = None,
                     shard: Optional[ShardSpec] = None
                     ) -> Tuple[Optional[Tuple[str, torch.Tensor]], ReasonCode]:
    """Should the PRODUCER of these activations fuse a requantize, and if
    not, the :class:`ReasonCode` saying why.

    A producing kernel may end its epilogue with ``requant:<dtype>``,
    emitting the narrow rows the next quantized linear contracts as they
    are, exactly when the CONSUMER leaf (a) quantizes against a
    calibrated static ``act_scale`` (the fused cast must hit the scale
    the consumer's own quantize would use) and (b) runs a single-placement
    kernel itself (the torch tier and the sharded class want float rows;
    ``shard`` is the consumer's use-site slicing).  ``batch_shape`` is the leading
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
                     dispatch=dispatch, shard=shard)
    except ValueError:   # an unrecognized layout: no requant
        return None, ReasonCode.REQUANT_LAYOUT
    if not (d.uses_kernel and d.placement == "single"):
        return None, ReasonCode.REQUANT_CONSUMER_FALLBACK
    s = consumer_params[quant.ACT_SCALE_KEY].float().reshape(())
    return (dtype_name(qdt), s), ReasonCode.REQUANT_FUSED


def requant_plan(consumer_params: Dict[str, Any], batch_shape: Sequence[int], cfg,
                 dispatch: Optional[DispatchConfig] = None,
                 shard: Optional[ShardSpec] = None
                 ) -> Optional[Tuple[str, torch.Tensor]]:
    """:func:`requant_decision` minus the reason code: the execution paths
    (``layers.apply_mlp``) only need the operands."""
    result, _ = requant_decision(consumer_params, batch_shape, cfg, dispatch=dispatch,
                                 shard=shard)
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
    fallback: under autograd, on the torch tier, under an axis env
    (``NO_SHARD_SPEC``, as in the JAX package: sharded attention is
    head-parallel, each rank attends over its own heads), or when a shape
    or dtype fails the kernel's contract."""
    from ..models.attention import chunked_attention   # local: avoid a cycle

    dcfg = dispatch or _DEFAULT
    b, hkv, grp, tq, d = qg.shape
    tk = k.shape[1]
    decision = plan(GemmProblem("attention", b=tq, ke=tk, o=d, n=4, m=4, dtype=qg.dtype,
                                differentiating=_under_autodiff(qg, k, v),
                                sharded=_mesh_active(), device=qg.device), dispatch=dcfg)
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


def leaf_shard_spec(names: Sequence[str]) -> Optional[ShardSpec]:
    """The use-site ShardSpec of one yielded linear leaf, as
    ``apply_linear`` builds it: none for an unhinted site."""
    hint = gather_hint(names)
    return None if hint is None else shard_spec_from_env(hint)


def dispatch_report(params_tree, batches, cfg,
                    dispatch: Optional[DispatchConfig] = None) -> List[str]:
    """Distinct (shape -> engine decision) plan lines for a params tree,
    at each leading batch width the serving path runs (decode slots and
    the prefill chunk), followed by the fused gate-up pairs.  Under an
    axis env the tree is this rank's shards and each line carries the
    global and the local problem."""
    if isinstance(batches, int):
        batches = (batches,)
    dcfg = dispatch or _DEFAULT
    seen, dual_seen = {}, {}
    for batch in batches:
        pairs = {}
        for names, leaf in iter_linear_items(params_tree):
            shard = leaf_shard_spec(names)
            ke, o = _global_dims(input_features(leaf, cfg),
                                 leaf["w"].shape[-1] if "w" in leaf
                                 else leaf["values"].shape[-1], shard)
            hint = gather_hint(names)
            d = plan_for(leaf, (batch, input_features(leaf, cfg)), cfg,
                         dtype=_leaf_dtype(leaf), dispatch=dcfg, shard=shard)
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
            shard = leaf_shard_spec(gnames)
            ke, o = _global_dims(ke, o, shard)
            d = plan(GemmProblem(mode, b=batch, ke=ke, o=o, n=cfg.n, m=cfg.m,
                                 dtype=_leaf_dtype(gleaf), sharded=_mesh_active(),
                                 shard=shard, epilogue="silu_mul",
                                 dual=True, device=_leaf_tensors(gleaf)[0].device,
                                 static_scales=quant.has_static_scales(gleaf)),
                     dispatch=dcfg)
            dual_seen.setdefault(
                (batch, mode, cfg.n, ke, o, str(gather_hint(gnames))), d)
    lines = []
    for (batch, _, n, ke, o, hint), d in sorted(seen.items()):
        loc = ""
        if d.uses_shard_map:
            lb, lke, lo = d.local_dims
            loc = f" -> local (B={lb}, K={lke}, O={lo})"
        lines.append(f"  [{hint if hint != 'None' else 'rep'}] {n}:{cfg.m} "
                     f"global (B={batch}, K={ke}, O={o}){loc} {describe(d)}")
    for (batch, _, n, ke, o, hint), d in sorted(dual_seen.items()):
        lines.append(f"  [gate-up {hint if hint != 'None' else 'rep'}] {n}:{cfg.m} "
                     f"global (B={batch}, K={ke}, O={o}) {describe(d)}")
    return lines
