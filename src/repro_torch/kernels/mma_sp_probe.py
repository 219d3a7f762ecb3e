"""Pin the operand layout of Hopper's sparse tensor-core instruction on the
card (CUDA source: ``kernels/csrc/mma_sp_probe.cu``).

    python -m repro_torch.kernels.mma_sp_probe      # prints one JSON line

``mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32`` multiplies a
16 x 32 A that is 2:4 sparse along K (held compressed, 16 x 16, with a
32-bit metadata word of 2-bit indices) by a dense 32 x 8 B.  The nm_spmm
sparse body (``csrc/nm_spmm_sp.cuh``) puts output channels on A's rows
and feeds the metadata straight from ``meta_packed``; it relies on the
maps below, which this probe checks with exact small-integer products:

- A (compressed) register r of lane L = 4g + t: row g (r even) or g + 8
  (r odd), compressed columns 2t, 2t + 1, plus 8 for r >= 2 (the dense
  m16n8k16 A map);
- B register r: K rows 2t + 8r and 2t + 8r + 1, column g;
- D register r: row g (r < 2) or g + 8, column 2t + (r & 1);
- metadata, selector 0: only lanes 4g and 4g + 1 are read.  Lane 4g + u
  (u in {0, 1}) holds K groups 4u .. 4u + 3 (columns 16u .. 16u + 15) of
  row g in nibbles 0-3 and of row g + 8 in nibbles 4-7; in a nibble the
  low 2 bits index the group's first kept value (compressed column 2j),
  the high 2 its second.  At 2:4 that is, for each row, two consecutive
  ``meta_packed`` bytes of its output channel (four 2-bit indices per
  byte, low bits first), so the sparse body reads the word from
  ``meta_packed`` as it is.

The metadata map is also *discovered*: from a word of (0, 1) everywhere,
each lane's nibble j in turn is set to (2, 3) and the product tells which
(row, group) it moved; the probe reports the map it found beside the one
assumed.  Everything here that is not the one launch runs on the host.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["probe", "ASSUMED_META_MAP", "metadata_words", "expand_1of4"]

#: (lane, nibble) -> (A row, K group) that the sparse body assumes
ASSUMED_META_MAP: Dict[Tuple[int, int], Tuple[int, int]] = {
    (lane, j): (lane // 4 + 8 * (j // 4), j % 4 + 4 * (lane % 4))
    for lane in range(32) if lane % 4 < 2 for j in range(8)}


def metadata_words(idx: np.ndarray) -> np.ndarray:
    """The 32 lanes' metadata words (``ASSUMED_META_MAP``) of a 16 x 32 A
    from its (16, 8, 2) kept indices (first, second per K group); 0 on the
    lanes that are not read."""
    e = np.zeros(32, np.uint32)
    for (lane, j), (row, grp) in ASSUMED_META_MAP.items():
        a, b = idx[row, grp]
        e[lane] |= np.uint32((int(a) | int(b) << 2) << (4 * j))
    return e


def expand_1of4(packed16: int) -> int:
    """A 1:4 row's word from its 8 packed 2-bit indices (16 bits, group j
    at bits 2j): each group becomes the pair (0, 1) when its index is 0,
    else (0, index), the kept value going to the slot of its index and a
    +0 to the other (the sparse body's ``expand_1of4``, in Python)."""
    word = 0
    for j in range(8):
        i = (packed16 >> (2 * j)) & 3
        word |= ((1 if i == 0 else i) << 2) << (4 * j)
    return word


def _bits(x: np.ndarray) -> np.ndarray:
    """float values (exact in bf16) -> their bf16 bit patterns as uint32."""
    return (torch.from_numpy(x.astype(np.float32)).bfloat16().view(torch.int16).numpy()
            .astype(np.int64) & 0xFFFF).astype(np.uint32)


def _a_regs(ac: np.ndarray) -> np.ndarray:
    """(16, 16) compressed A -> (32, 4) words, the dense m16n8k16 A map."""
    bits = _bits(ac)
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            row, col = g + 8 * (r & 1), 2 * t + 8 * (r >> 1)
            out[lane, r] = bits[row, col] | bits[row, col + 1] << 16
    return out


def _b_regs(bm: np.ndarray) -> np.ndarray:
    """(32, 8) B -> (32, 4) words: register r holds K rows 2t + 8r, + 1."""
    bits = _bits(bm)
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            k = 2 * t + 8 * r
            out[lane, r] = bits[k, g] | bits[k + 1, g] << 16
    return out


def _d_matrix(d: np.ndarray) -> np.ndarray:
    """(32, 4) fp32 per lane -> (16, 8) D."""
    out = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            out[g + 8 * (r >> 1), 2 * t + (r & 1)] = d[lane, r]
    return out


def _dense(ac: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(16, 16) compressed values and (16, 8, 2) indices -> dense (16, 32)."""
    a = np.zeros((16, 32), np.float32)
    for m in range(16):
        for j in range(8):
            for s in range(2):
                a[m, 4 * j + idx[m, j, s]] += ac[m, 2 * j + s]
    return a


class _Card:
    def __init__(self, device):
        self.dev = torch.device(device)
        self.lib = _build.library("mma_sp_probe.cu")
        self.d = torch.empty((32, 4), dtype=torch.float32, device=self.dev)

    def run(self, a: np.ndarray, b: np.ndarray, e: np.ndarray) -> np.ndarray:
        ta, tb, te = (torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(self.dev)
                      for v in (a, b, e))
        with torch.cuda.device(self.dev):
            rc = self.lib.vg_mma_sp_probe(ta.data_ptr(), tb.data_ptr(), te.data_ptr(),
                                          self.d.data_ptr(), _build.stream_of(ta))
        _build.check(rc, "mma_sp_probe", self.lib)
        return _d_matrix(self.d.cpu().numpy())


def probe(device: str = "cuda", seed: int = 0) -> dict:
    """Run the checks on one card; returns what was found (``ok`` True
    when every map is the assumed one)."""
    rng = np.random.default_rng(seed)
    card = _Card(device)
    mags = rng.integers(1, 4, (16, 16)) * rng.choice([-1, 1], (16, 16))
    ac = mags.astype(np.float32)
    bm = rng.integers(-3, 4, (32, 8)).astype(np.float32)
    a_regs, b_regs = _a_regs(ac), _b_regs(bm)

    # 1. fragments: every group at indices (0, 1), whichever lanes are read
    base_idx = np.tile(np.array([0, 1]), (16, 8, 1))
    base = card.run(a_regs, b_regs, np.full(32, 0x44444444, np.uint32))
    fragments_ok = bool(np.array_equal(base, _dense(ac, base_idx) @ bm))

    # 2. the metadata map, discovered one (lane, nibble) at a time
    found: Dict[Tuple[int, int], Optional[Tuple[int, int]]] = {}
    unexplained = []
    for lane in range(32):
        for j in range(8):
            e = np.full(32, 0x44444444, np.uint32)
            e[lane] ^= np.uint32(0xA << (4 * j))          # (0, 1) -> (2, 3)
            got = card.run(a_regs, b_regs, e)
            if np.array_equal(got, base):
                found[(lane, j)] = None
                continue
            hit = None
            for m in np.nonzero((got != base).any(axis=1))[0]:
                for grp in range(8):
                    idx = base_idx.copy()
                    idx[m, grp] = (2, 3)
                    if np.array_equal(got, _dense(ac, idx) @ bm):
                        hit = (int(m), grp)
            found[(lane, j)] = hit
            if hit is None:
                unexplained.append((lane, j))
    read = {k: v for k, v in found.items() if v is not None}
    map_ok = read == ASSUMED_META_MAP

    # 3. random 2:4 rows (sorted distinct indices, as the compressor keeps
    # them) and 1:4 rows run as 2:4 with a +0, under the assumed maps
    idx24 = np.sort(np.stack([rng.permutation(4)[:2] for _ in range(16 * 8)]), axis=1)
    idx24 = idx24.reshape(16, 8, 2)
    got = card.run(a_regs, b_regs, metadata_words(idx24))
    random_2of4_ok = bool(np.array_equal(got, _dense(ac, idx24) @ bm))
    one = rng.integers(0, 4, (16, 8))
    ac1 = np.zeros_like(ac)
    idx14 = np.zeros((16, 8, 2), np.int64)
    for m in range(16):
        for j in range(8):
            i = one[m, j]
            idx14[m, j] = (0, 1) if i == 0 else (0, i)
            ac1[m, 2 * j + (0 if i == 0 else 1)] = ac[m, 2 * j]
    got = card.run(_a_regs(ac1), b_regs, metadata_words(idx14))
    random_1of4_ok = bool(np.array_equal(got, _dense(ac1, idx14) @ bm))

    ok = fragments_ok and map_ok and random_2of4_ok and random_1of4_ok and not unexplained
    return {"ok": ok, "fragments_ok": fragments_ok, "metadata_map_ok": map_ok,
            "lanes_read": sorted({lane for lane, _ in read}),
            # lane: [(row, group) of nibble 0 .. 7]
            "map": {lane: [read.get((lane, j)) for j in range(8)]
                    for lane in sorted({lane for lane, _ in read})},
            "unexplained": unexplained, "random_2of4_ok": random_2of4_ok,
            "random_1of4_ok": random_1of4_ok,
            "device": torch.cuda.get_device_name(torch.device(device))}


if __name__ == "__main__":
    print(json.dumps(probe(), default=str))
