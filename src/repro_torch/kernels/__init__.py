"""Hand-written Hopper kernels and the dispatch engine that routes every
linear layer to them (port of ``repro.kernels``).

``KERNELS`` names each wrapper; every wrapper counts the launches of its
kernel in a plain integer attribute, ``.launches``.
"""

from .flash_attention import kernel as _flash_attention
from .nm_spmm import kernel as _nm_spmm
from .nm_spmm_gather import kernel as _nm_spmm_gather
from .tile_gemm import kernel as _tile_gemm

KERNELS = {
    "tile_gemm": _tile_gemm.tile_gemm,
    "tile_gemm_dual": _tile_gemm.tile_gemm_dual,
    "nm_spmm": _nm_spmm.nm_spmm,
    "nm_spmm_dual": _nm_spmm.nm_spmm_dual,
    "tile_gemm_int8": _tile_gemm.tile_gemm_int8,
    "tile_gemm_dual_int8": _tile_gemm.tile_gemm_dual_int8,
    "nm_spmm_int8": _nm_spmm.nm_spmm_int8,
    "nm_spmm_dual_int8": _nm_spmm.nm_spmm_dual_int8,
    "tile_gemm_dual_int8_requant": _tile_gemm.tile_gemm_dual_int8_requant,
    "nm_spmm_dual_int8_requant": _nm_spmm.nm_spmm_dual_int8_requant,
    "tile_gemm_fp8": _tile_gemm.tile_gemm_fp8,
    "tile_gemm_dual_fp8": _tile_gemm.tile_gemm_dual_fp8,
    "nm_spmm_fp8": _nm_spmm.nm_spmm_fp8,
    "nm_spmm_dual_fp8": _nm_spmm.nm_spmm_dual_fp8,
    "tile_gemm_dual_fp8_requant": _tile_gemm.tile_gemm_dual_fp8_requant,
    "nm_spmm_dual_fp8_requant": _nm_spmm.nm_spmm_dual_fp8_requant,
    **{name: getattr(_tile_gemm, name) for name in
       ("tile_gemm_int8_requant", "tile_gemm_fp8_requant")},
    **{name: getattr(_nm_spmm, name) for name in
       ("nm_spmm_int8_requant", "nm_spmm_fp8_requant")},
    "flash_attention": _flash_attention.flash_attention,
    **{name: getattr(_tile_gemm, name) for name in
       ("tile_gemm_masked", "tile_gemm_masked_int8", "tile_gemm_masked_fp8")},
    **{name: getattr(_nm_spmm, name) for name in
       ("nm_spmm_masked", "nm_spmm_masked_int8", "nm_spmm_masked_fp8")},
    # the module's wrappers, not its planners and constants
    **{name: getattr(_nm_spmm_gather, name) for name in _nm_spmm_gather.__all__
       if hasattr(getattr(_nm_spmm_gather, name), "launches")},
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
