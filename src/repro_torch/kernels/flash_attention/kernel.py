"""Flash attention on Hopper, causal or not (CUDA source:
``kernels/csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention``
(:79, body ``_attn_kernel``) and the GQA repeat of its wrapper
(``flash_attention/ops.py``): the kernel reads KV head ``h // (Hq /
Hkv)`` itself.  On CUDA tensors the wrapper launches the kernel or
raises; on CPU tensors it returns the plain version from ``ref.py``.
Launches are counted in ``flash_attention.launches``.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS", "tile_config"]

#: the head_dims the kernel is compiled for
HEAD_DIMS = (64, 80, 96, 128, 256)


def tile_config(d: int) -> dict:
    """The kernel's tiles for head_dim ``d`` (``csrc/flash_attention.cu``,
    ``Tile<D>``): m16 query tiles a warp (2 at D <= 80, else 1) and so
    query rows a block of 4 warps, keys per KV step, whether Q's fragments
    are re-read from shared memory each step (two query tiles a warp, or D
    = 256, whose 128 fp32 of O a thread fill the registers), and the
    shared bytes of a block: Q plus two stages of K and V at a bf16 pitch
    of D + 8."""
    mq = 2 if d <= 80 else 1
    bq, bkv = 64 * mq, 32 if d > 128 else 64
    return {"query_tiles_per_warp": mq, "block_q": bq, "block_kv": bkv,
            "q_in_smem": d > 128 or mq > 1, "smem_bytes": 2 * (d + 8) * (bq + 4 * bkv)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``softmax(q k^T * D**-0.5 [+ causal mask]) v`` per query head (with
    ``causal`` the mask ``q_pos >= k_pos``, aligned top-left; without it
    every query scores every key, as an encoder does).

    q (B, Hq, T, D); k, v (B, Hkv, T, D) with Hq % Hkv == 0; any strides
    with the head_dim contiguous (the model passes views of its (B, T,
    H, D) projections).  Returns (B, Hq, T, D) in q's dtype, a view of a
    (B, T, Hq, D) tensor.  The kernel takes bf16 and D in ``HEAD_DIMS``;
    T may be ragged."""
    b, hq, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (t, d) or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    hkv = k.shape[1]
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: the kernel takes bfloat16, {name} is {x.dtype}")
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous head_dim, "
                             f"strides that are multiples of 8 and 16-byte alignment")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.library("flash_attention.cu")
    with torch.cuda.device(q.device):
        rc = lib.vg_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, t, d,
            int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            d ** -0.5, _build.stream_of(q))
    flash_attention.launches += 1
    _build.check(rc, "flash_attention", lib)
    return o


flash_attention.launches = 0
