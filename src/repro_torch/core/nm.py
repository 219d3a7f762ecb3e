"""N:M structured sparsity: pruning, compression, metadata packing.

The port's copy of ``repro.core.nm``; the formats are byte-identical.

Weights are stored ``(K, O)`` with the contraction dimension first
(``y = x @ w``).  Within every block of ``m`` consecutive K-rows each
output channel keeps at most ``n`` nonzeros.

- ``values``: ``(K*n/m, O)``, the kept entries, block-major along K.
- ``meta``: ``(K*n/m, O)`` uint8 in ``[0, m)``, each kept value's
  in-block position.  Kept indices are strictly increasing within a
  block: a stable descending sort by magnitude picks the top ``n``
  (ties keep the lower index), then the picked indices are sorted.
- ``pack_meta`` packs four consecutive ``K_c`` rows into one byte, two
  bits each, low bits first.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = [
    "NMCompressed",
    "nm_mask",
    "prune_nm",
    "compress_nm",
    "decompress",
    "pack_meta",
    "unpack_meta",
]


@dataclasses.dataclass(frozen=True)
class NMCompressed:
    """Compressed N:M matrix (values + in-block indices)."""

    values: torch.Tensor   # (K_c, O)
    meta: torch.Tensor     # (K_c, O) uint8, entries in [0, m)
    n: int
    m: int


def _block_view(w: torch.Tensor, m: int) -> torch.Tensor:
    k, o = w.shape
    if k % m:
        raise ValueError(f"K={k} not divisible by m={m}")
    return w.reshape(k // m, m, o)


def _ranks(blocks: torch.Tensor) -> torch.Tensor:
    """Each slot's place in its block's order by descending magnitude,
    ties by index (a stable sort's): the slots that beat it, counted with
    m comparisons (a sort along a short middle axis is slow on a card)."""
    mag = blocks.abs()
    ranks = torch.zeros(blocks.shape, dtype=torch.uint8, device=blocks.device)
    slot = torch.arange(blocks.shape[1], device=blocks.device)[None, :, None]
    for j in range(blocks.shape[1]):
        other = mag[:, j:j + 1]
        ranks += (other > mag) | ((other == mag) & (slot > j))
    return ranks


def nm_mask(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Boolean keep-mask: magnitude top-n per m-block, per column."""
    return (_ranks(_block_view(w, m)) < n).reshape(w.shape)


def prune_nm(w: torch.Tensor, n: int, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude-prune ``w`` to N:M along K. Returns (pruned, mask)."""
    mask = nm_mask(w, n, m)
    return w * mask.to(w.dtype), mask


def compress_nm(w: torch.Tensor, n: int, m: int) -> NMCompressed:
    """Compress an N:M sparse ``(K, O)`` matrix (keeps the top-n by
    magnitude per block when ``w`` is not already N:M)."""
    blocks = _block_view(w, m)
    kept = _ranks(blocks) < n                                    # (B, m, O)
    # the kept slots in ascending order: slot i goes to place cumsum - 1;
    # the dropped ones to a spare place n, cut off after the scatter
    place = torch.where(kept, kept.cumsum(dim=1) - 1, n)
    slots = torch.arange(m, device=w.device)[None, :, None].expand(blocks.shape)
    keep = torch.zeros((blocks.shape[0], n + 1, blocks.shape[2]), dtype=torch.long,
                       device=w.device).scatter_(1, place, slots)[:, :n]   # (B, n, O)
    vals = torch.gather(blocks, 1, keep)
    kc = blocks.shape[0] * n
    return NMCompressed(values=vals.reshape(kc, w.shape[1]),
                        meta=keep.reshape(kc, w.shape[1]).to(torch.uint8),
                        n=n, m=m)


def decompress(values: torch.Tensor, meta: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Expand ``(K_c, O)`` values/meta to the dense ``(K_eff, O)`` matrix:
    each kept value lands in its in-block slot, every other slot is 0."""
    if values.dtype == torch.float8_e4m3fn:
        # scatter has no float8 kernels: expand the bytes (0x00 is +0.0)
        return decompress(values.view(torch.uint8), meta, n, m).view(values.dtype)
    kc, o = values.shape
    b = kc // n
    idx = meta.reshape(b, n, o).long()
    dense = torch.zeros((b, m, o), dtype=values.dtype, device=values.device)
    dense.scatter_(1, idx, values.reshape(b, n, o))
    return dense.reshape(b * m, o)


def pack_meta(meta: torch.Tensor) -> torch.Tensor:
    """Pack 2-bit indices four per byte along axis 0 (low bits first)."""
    kc, o = meta.shape
    if kc % 4:
        raise ValueError(f"K_c={kc} not divisible by 4 for packing")
    m4 = meta.reshape(kc // 4, 4, o).to(torch.int32)
    shifts = (torch.arange(4, dtype=torch.int32, device=meta.device) * 2)[None, :, None]
    return (m4 << shifts).sum(dim=1).to(torch.uint8)


def unpack_meta(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_meta`: (K_c/4, O) uint8 -> (K_c, O) uint8."""
    kp, o = packed.shape
    p = packed.to(torch.int32)[:, None, :]
    shifts = (torch.arange(4, dtype=torch.int32, device=packed.device) * 2)[None, :, None]
    return ((p >> shifts) & 3).reshape(kp * 4, o).to(torch.uint8)
