"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so ``nvcc`` builds them in seconds.  Each library is built at first use,
from the checkout's own sources, into ``build/repro_torch/`` at the root
of the checkout, named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags: an edited source builds anew, an
unchanged one is loaded as it is.  Nothing here
runs at import time; the CPU tests import every module without a
compiler present.

Pointers and the stream cross as ``ctypes.c_void_p`` (a plain
``c_int`` would cut a 64-bit pointer); every entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

__all__ = ["build_all", "library", "check", "stream_of", "build_dir", "BUILD_LOG",
           "out_kind", "QUANT_CLASSES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gemm.cu", "gemm_int8.cu", "gemm_fp8.cu", "flash_attention.cu",
           "flash_attention_wmma.cu", "mma_sp_probe.cu")
#: sources built as several libraries, one nvcc each with ``-DVG_PART=p``,
#: all started with the others (the build takes as long as its longest
#: nvcc); each part holds some of the source's entry points
PARTS = {"gemm_fp8.cu": (0, 1, 2)}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of each library's entry points (all return a cudaError_t)
_SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "gemm.cu": {
        "vg_tile_gemm": (_P,) * 4 + (_I,) * 8 + (_P,),
        "vg_tile_gemm_tiled": (_P,) * 4 + (_I,) * 6 + (_P,),
        "vg_tile_gemm_masked": (_P,) * 5 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_masked": (_P,) * 6 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_masked_tiled": (_P,) * 6 + (_I,) * 6 + (_P,),
        "vg_nm_spmm_gather_bk_masked": (_P,) * 6 + (_I,) * 8 + (_P,),
        "vg_tile_gemm_dual": (_P,) * 4 + (_I,) * 7 + (_P,),
        "vg_tile_gemm_dual_tiled": (_P,) * 4 + (_I,) * 4 + (_P,),
        "vg_nm_spmm": (_P,) * 5 + (_I,) * 8 + (_P,),
        "vg_nm_spmm_tiled": (_P,) * 5 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_dual": (_P,) * 6 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_dual_tiled": (_P,) * 6 + (_I,) * 5 + (_P,),
        "vg_nm_spmm_gather_bk": (_P,) * 5 + (_I,) * 10 + (_P, _P),
        "vg_nm_spmm_gather_bk_tiled": (_P,) * 5 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_gather": (_P,) * 4 + (_I,) * 6 + (_P,),
        "vg_nm_spmm_gather_dual_bk": (_P,) * 6 + (_I,) * 8 + (_P, _P),
        "vg_nm_spmm_gather_dual_bk_tiled": (_P,) * 6 + (_I,) * 5 + (_P,),
    },
    "gemm_int8.cu": {
        "vg_tile_gemm_int8": (_P,) * 7 + (_I,) * 8 + (_P,),
        "vg_tile_gemm_dual_int8": (_P,) * 8 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_int8": (_P,) * 8 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_dual_int8": (_P,) * 10 + (_I,) * 8 + (_P,),
        "vg_nm_spmm_gather_bk_int8": (_P,) * 8 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_gather_dual_bk_int8": (_P,) * 10 + (_I,) * 8 + (_P,),
        "vg_tile_gemm_masked_int8": (_P,) * 8 + (_I,) * 8 + (_P,),
        "vg_nm_spmm_masked_int8": (_P,) * 9 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_gather_bk_masked_int8": (_P,) * 9 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_gather_int8": (_P,) * 6 + (_I,) * 8 + (_P,),
    },
    "gemm_fp8.cu": {
        "vg_tile_gemm_fp8": (_P,) * 7 + (_I,) * 9 + (_P,),
        "vg_tile_gemm_fp8_tiled": (_P,) * 7 + (_I,) * 6 + (_P,),
        "vg_tile_gemm_dual_fp8": (_P,) * 8 + (_I,) * 8 + (_P,),
        "vg_tile_gemm_dual_fp8_tiled": (_P,) * 8 + (_I,) * 5 + (_P,),
        "vg_nm_spmm_fp8": (_P,) * 8 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_fp8_tiled": (_P,) * 8 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_dual_fp8": (_P,) * 10 + (_I,) * 8 + (_P,),
        "vg_nm_spmm_dual_fp8_tiled": (_P,) * 10 + (_I,) * 6 + (_P,),
        "vg_nm_spmm_gather_bk_fp8": (_P,) * 8 + (_I,) * 10 + (_P, _P),
        "vg_nm_spmm_gather_bk_fp8_tiled": (_P,) * 8 + (_I,) * 7 + (_P,),
        "vg_nm_spmm_gather_dual_bk_fp8": (_P,) * 10 + (_I,) * 8 + (_P,),
        "vg_tile_gemm_masked_fp8": (_P,) * 8 + (_I,) * 8 + (_P,),
        "vg_nm_spmm_masked_fp8": (_P,) * 9 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_gather_bk_masked_fp8": (_P,) * 9 + (_I,) * 9 + (_P,),
        "vg_nm_spmm_gather_fp8": (_P,) * 6 + (_I,) * 8 + (_P,),
        "vg_nm_spmm_gather_fp8_tiled": (_P,) * 6 + (_I,) * 6 + (_P,),
    },
    "flash_attention.cu": {
        "vg_flash_attention": (_P,) * 4 + (_I,) * 6 + (_L,) * 12 + (_F, _P),
        "vg_flash_attention_smem": (_I,),
    },
    # the first flash body, kept as the yardstick the current one is timed against
    "flash_attention_wmma.cu": {
        "vg_flash_attention_wmma": (_P,) * 4 + (_I,) * 6 + (_L,) * 12 + (_F, _P),
    },
    "mma_sp_probe.cu": {
        "vg_mma_sp_probe": (_P,) * 5,
        "vg_mma_sp_probe_e4m3": (_P,) * 5,
        "vg_mma_sp_probe_s8": (_P,) * 5,
        "vg_mma_probe_e4m3": (_P,) * 5,
        "vg_mma_probe_s8": (_P,) * 5,
    },
}

#: compiler output (ptxas register / shared-memory report) per source
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout (src/../build)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build from source at first use")
    return found


def _units(name: str) -> Tuple:
    """One source's build units: its ``PARTS``, or ``None`` (the whole
    source in one library)."""
    return PARTS.get(name, (None,))


def _target(name: str, part=None) -> Path:
    src = _CSRC / name
    flags = _flags(part)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    stem = src.stem if part is None else f"{src.stem}.{part}"
    return build_dir() / f"{stem}-{digest.hexdigest()[:16]}.so"


def _flags(part=None) -> Tuple[str, ...]:
    return NVCC_FLAGS if part is None else NVCC_FLAGS + (f"-DVG_PART={part}",)


def build_all() -> Dict[str, float]:
    """Build every missing library, one nvcc per source (per part of a
    source in ``PARTS``), all started together.  Returns the seconds each
    source's build took (0.0 when its libraries were already built).
    Raises with the compiler's output on failure."""
    pending = [(name, part, _target(name, part)) for name in SOURCES
               for part in _units(name) if not _target(name, part).exists()]
    seconds = {name: 0.0 for name in SOURCES}
    if not pending:
        return seconds
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name, part, out in pending:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(part), "-o", str(tmp), str(_CSRC / name)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True),
                      tmp, out))
    failed = []
    logs: Dict[str, list] = {}
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        logs.setdefault(name, []).append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {out.name} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    BUILD_LOG.update({name: "".join(parts) for name, parts in logs.items()})
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


class _Parts:
    """The libraries of one source built in ``PARTS``, as one: each entry
    point from the part that defines it (every part has
    ``vg_error_string``)."""

    def __init__(self, libs):
        self._libs = libs

    def __getattr__(self, fn):
        for lib in self._libs:
            try:
                f = getattr(lib, fn)
            except AttributeError:
                continue
            setattr(self, fn, f)
            return f
        raise AttributeError(fn)


def library(name: str = "gemm.cu"):
    """The loaded library for one source (a ``ctypes.CDLL``, or for a
    source in ``PARTS`` an object that holds its parts' entry points),
    built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            outs = [_target(name, part) for part in _units(name)]
            if not all(out.exists() for out in outs):
                build_all()
            libs = [ctypes.CDLL(str(out)) for out in outs]
            lib = libs[0] if len(libs) == 1 else _Parts(libs)
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            for part in libs:
                part.vg_error_string.argtypes = [ctypes.c_int]
                part.vg_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(code: int, kernel: str, lib: ctypes.CDLL) -> None:
    """Raise when a launch returned a CUDA error (refused launches never
    run, and a later synchronize would not report them)."""
    if code != 0:
        msg = lib.vg_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({code})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw pointer (read
    without building a ``torch.cuda.Stream``: a launch's host cost)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# --- the kernels' tiling contract (gemm.cu: BK, BN and the two BM values)
BLOCK_K = 64
BLOCK_O = 64
BLOCK_ROWS = (16, 64)


def block_rows(b: int) -> int:
    """Row tile for a batch of ``b`` rows: 16 for decode-sized batches, 64
    above (the ragged edge is masked in the kernel either way)."""
    return BLOCK_ROWS[0] if b <= BLOCK_ROWS[0] else BLOCK_ROWS[1]


def check_operands(kernel: str, x: torch.Tensor, *others: torch.Tensor,
                   block_b: int, x_dtype: torch.dtype = torch.bfloat16) -> None:
    """Everything a launch needs that the C side cannot see: one CUDA
    device, activations of ``x_dtype`` (bf16 for the float kernels, the
    storage dtype, int8 or float8_e4m3fn, for the quantized ones),
    contiguous 16-byte-aligned operands, a known row tile.  Shapes and the
    other operands' dtypes are checked by each wrapper."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: operands must be CUDA or CPU tensors, "
                         f"got {x.device}")
    if x.dtype != x_dtype:
        raise ValueError(f"{kernel}: the kernel takes {x_dtype} activations, "
                         f"got {x.dtype}")
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{kernel}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: operands must be 16-byte aligned")
    if block_b not in BLOCK_ROWS:
        raise ValueError(f"{kernel}: block_b must be one of {BLOCK_ROWS}, "
                         f"got {block_b}")


def check_tiles(kernel: str, k: int, o: int) -> None:
    """K and O multiples of the kernels' 64 x 64 tile (every class: the
    bf16 ones, and int8 and e4m3 leaves, one byte per value)."""
    if k % BLOCK_K or o % BLOCK_O:
        raise ValueError(f"{kernel}: K={k} and O={o} must be multiples of "
                         f"{BLOCK_K} and {BLOCK_O}")


#: the quantized classes: storage dtype -> (C source, suffix of its kernels'
#: names, dtype of the raw accumulator).  int8 sums into an exact int32,
#: e4m3 into fp32.
QUANT_CLASSES = {
    torch.int8: ("gemm_int8.cu", "int8", torch.int32),
    torch.float8_e4m3fn: ("gemm_fp8.cu", "fp8", torch.float32),
}

# the quantized kernels' out_kind argument (gemm_int8.cu, gemm_fp8.cu):
# what the flush stores.  OUT_RAW is the class's raw accumulator (int32 |
# fp32), OUT_REQUANT its narrow dtype (int8 | e4m3) against the consumer's
# static scale.
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1}
OUT_RAW = 2
OUT_REQUANT = 3


def out_kind(kernel: str, out_dtype: torch.dtype, raw: bool) -> int:
    """The quantized kernels store bf16 or fp32 scaled outputs, or the raw
    accumulator (raw mode); the requantizing kernels pass ``OUT_REQUANT``
    themselves."""
    if raw:
        return OUT_RAW
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"{kernel}: the kernel stores bfloat16 or float32, "
                         f"not {out_dtype}")
    return _OUT_KINDS[out_dtype]
