"""Pin the operand layouts of Hopper's tensor-core instructions that the
streaming bodies run on the card (CUDA source:
``kernels/csrc/mma_sp_probe.cu``).

    python -m repro_torch.kernels.mma_sp_probe      # prints one JSON line

Three sparse instructions, each multiplying a 16-row A that is 2:4 sparse along K
(held compressed, with 2-bit indices in 32-bit metadata words) by a dense
B of 8 columns:

- ``mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32`` (16 x 32 A,
  16 compressed bf16 a row), which the float nm_spmm sparse body
  (``csrc/nm_spmm_sp.cuh``) runs;
- ``mma.sp.sync.aligned.m16n8k64.row.col.f32.e4m3.e4m3.f32`` (16 x 64 A,
  32 compressed e4m3 bytes a row), which the fp8 sparse body
  (``csrc/nm_spmm_sp_fp8.cuh``) runs;
- ``mma.sp.sync.aligned.m16n8k64.row.col.s32.s8.s8.s32`` (16 x 64 A, 32
  compressed int8 bytes a row, int32 out), which the same body's s8 form
  (``nm_spmm_int8``) runs on the e4m3 form's registers and metadata words.

The bodies put output channels on A's rows and build the metadata from
``meta_packed`` in registers; they rely on the maps below, which this
probe checks with exact small-integer products.  With ``P`` elements a
32-bit word (2 bf16, 4 e4m3 or s8) and lane L = 4g + t:

- A (compressed) register r: row g (r even) or g + 8 (r odd), compressed
  columns P t .. P t + P - 1, plus 4 P for r >= 2 (the dense m16n8k16 /
  m16n8k32 A maps);
- B register r: K rows P t + 4 P r .. + P - 1, column g;
- D register r: row g (r < 2) or g + 8, column 2t + (r & 1);
- metadata, selector 0, in 4-bit nibbles, one per K group of 4 columns:
  the low 2 bits index the group's first kept value (compressed column
  2j), the high 2 its second.  bf16 (8 groups a row): only lanes 4g and
  4g + 1 are read; lane 4g + u holds groups 4u .. 4u + 3 of row g in
  nibbles 0-3 and of row g + 8 in nibbles 4-7.  e4m3 (16 groups a row):
  every lane is read; lane 4g + t holds groups 8 (t >> 1) .. + 7 of row
  g + 8 (t & 1), one row a lane (found by this probe on an H100; the
  bf16 form's two-rows-a-lane map does not carry over); s8 is assumed to
  share the e4m3 map, which the probe checks.  At 2:4 a lane's
  word is therefore consecutive ``meta_packed`` bytes of its output
  channels (four 2-bit indices per byte, low bits first): two bytes of
  each of two channels (bf16), four of one channel (e4m3, s8), so the
  sparse bodies read the word from ``meta_packed`` as it is.

The metadata map is also *discovered*: from a word of (0, 1) everywhere,
each lane's nibble j in turn is set to (2, 3) and the product tells which
(row, group) it moved; the probe reports the map it found beside the one
assumed.

Two dense instructions, 16 x 32 A by 32 x 8 B, which the dense stream
(N = 4 in ``csrc/nm_spmm_sp_fp8.cuh``: ``tile_gemm_fp8``, K8 fp8 and, in
its s8 form, ``tile_gemm_int8`` and K8 int8) issues twice a 64-deep step:
``mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32`` and
``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32``.  Their A registers
are the compressed A's map above over 32 dense columns, B registers 0 and
1 the B map (K rows 4 t + 16 r .. + 3 of column g), D the same.  The
probe builds both forms' registers by those maps from one integer A and
B and holds each product to the plain one (s8 also at full int8 range),
so s8's A, B and D maps are pinned as e4m3's.  Everything here that is
not a launch runs on the host.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["probe", "ASSUMED_META_MAP", "ASSUMED_META_MAP_E4M3", "metadata_words",
           "metadata_words_e4m3", "expand_1of4"]


#: (lane, nibble) -> (A row, K group) that the bf16 sparse body assumes
ASSUMED_META_MAP: Dict[Tuple[int, int], Tuple[int, int]] = {
    (lane, j): (lane // 4 + 8 * (j // 4), j % 4 + 4 * (lane % 4))
    for lane in range(32) if lane % 4 < 2 for j in range(8)}
#: the same for the e4m3 and s8 (m16n8k64) sparse bodies: every lane, one
#: row each
ASSUMED_META_MAP_E4M3: Dict[Tuple[int, int], Tuple[int, int]] = {
    (lane, j): (lane // 4 + 8 * (lane % 2), 8 * (lane % 4 // 2) + j)
    for lane in range(32) for j in range(8)}


def metadata_words(idx: np.ndarray, meta_map=None) -> np.ndarray:
    """The 32 lanes' metadata words (``meta_map``, by default
    ``ASSUMED_META_MAP``) of a 16-row A from its (16, groups, 2) kept
    indices (first, second per K group); 0 on the lanes that are not read."""
    e = np.zeros(32, np.uint32)
    for (lane, j), (row, grp) in (meta_map or ASSUMED_META_MAP).items():
        a, b = idx[row, grp]
        e[lane] |= np.uint32((int(a) | int(b) << 2) << (4 * j))
    return e


def metadata_words_e4m3(idx: np.ndarray) -> np.ndarray:
    """:func:`metadata_words` of a 16 x 64 e4m3 A ((16, 16, 2) indices)."""
    return metadata_words(idx, ASSUMED_META_MAP_E4M3)


def expand_1of4(packed16: int) -> int:
    """A 1:4 row's word from its 8 packed 2-bit indices (16 bits, group j
    at bits 2j): each group becomes the pair (0, 1) when its index is 0,
    else (0, index), the kept value going to the slot of its index and a
    +0 to the other (the sparse bodies' ``expand_1of4``, in Python)."""
    word = 0
    for j in range(8):
        i = (packed16 >> (2 * j)) & 3
        word |= ((1 if i == 0 else i) << 2) << (4 * j)
    return word


class _Form:
    """One instruction: its C entry point, element type and K groups a row
    (a dense form: ``meta_map`` None, K = 32)."""

    def __init__(self, name: str, entry: str, dtype: torch.dtype, groups: int, meta_map):
        self.name, self.entry, self.dtype, self.groups = name, entry, dtype, groups
        self.per = 4 // dtype.itemsize             # elements a 32-bit word
        self.meta_map = meta_map


FORMS = (_Form("bf16", "vg_mma_sp_probe", torch.bfloat16, 8, ASSUMED_META_MAP),
         _Form("e4m3", "vg_mma_sp_probe_e4m3", torch.float8_e4m3fn, 16, ASSUMED_META_MAP_E4M3),
         _Form("s8", "vg_mma_sp_probe_s8", torch.int8, 16, ASSUMED_META_MAP_E4M3))
DENSE_FORMS = (_Form("dense_e4m3", "vg_mma_probe_e4m3", torch.float8_e4m3fn, 8, None),
               _Form("dense_s8", "vg_mma_probe_s8", torch.int8, 8, None))


def _bits(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float values (exact in ``dtype``) -> their bit patterns as uint32."""
    t = torch.from_numpy(x.astype(np.float32)).to(dtype)
    raw = t.view(torch.int16 if dtype.itemsize == 2 else torch.uint8).numpy().astype(np.int64)
    return (raw & (0xFFFF if dtype.itemsize == 2 else 0xFF)).astype(np.uint32)


def _pack(bits: np.ndarray, per: int) -> np.uint32:
    w = 0
    for i, v in enumerate(bits):
        w |= int(v) << (32 // per * i)
    return np.uint32(w)


def _a_regs(ac: np.ndarray, form: _Form) -> np.ndarray:
    """(16, 2 groups) compressed A -> (32, 4) words: register r holds row
    g + 8 (r & 1), compressed columns P t + 4 P (r >> 1) .. + P - 1."""
    bits, per = _bits(ac, form.dtype), form.per
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            row, col = g + 8 * (r & 1), per * t + 4 * per * (r >> 1)
            out[lane, r] = _pack(bits[row, col:col + per], per)
    return out


def _b_regs(bm: np.ndarray, form: _Form) -> np.ndarray:
    """(4 groups, 8) B -> (32, 4) words: register r holds K rows P t + 4 P r
    .. + P - 1 of column g."""
    bits, per = _bits(bm, form.dtype), form.per
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            k = per * t + 4 * per * r
            out[lane, r] = _pack(bits[k:k + per, g], per)
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
    """(16, 2 G) compressed values and (16, G, 2) indices -> dense (16, 4 G)."""
    groups = idx.shape[1]
    a = np.zeros((16, 4 * groups), np.float32)
    for m in range(16):
        for j in range(groups):
            for s in range(2):
                a[m, 4 * j + idx[m, j, s]] += ac[m, 2 * j + s]
    return a


class _Card:
    def __init__(self, device):
        self.dev = torch.device(device)
        self.lib = _build.library("mma_sp_probe.cu")
        self.d = torch.empty((32, 4), dtype=torch.float32, device=self.dev)

    def run(self, form: _Form, a: np.ndarray, b: np.ndarray, e: np.ndarray) -> np.ndarray:
        ta, tb, te = (torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(self.dev)
                      for v in (a, b, e))
        with torch.cuda.device(self.dev):
            rc = getattr(self.lib, form.entry)(ta.data_ptr(), tb.data_ptr(), te.data_ptr(),
                                               self.d.data_ptr(), _build.stream_of(ta))
        _build.check(rc, f"mma_sp_probe ({form.name})", self.lib)
        # s8 stores its int32 results in the same buffer
        d = self.d.view(torch.int32) if form.dtype == torch.int8 else self.d
        return _d_matrix(d.cpu().numpy())


def _probe_form(card: _Card, form: _Form, rng) -> dict:
    """Every check of one instruction (``ok`` True when every map is the
    assumed one)."""
    groups = form.groups
    mags = rng.integers(1, 4, (16, 2 * groups)) * rng.choice([-1, 1], (16, 2 * groups))
    ac = mags.astype(np.float32)
    bm = rng.integers(-3, 4, (4 * groups, 8)).astype(np.float32)
    a_regs, b_regs = _a_regs(ac, form), _b_regs(bm, form)

    # 1. fragments: every group at indices (0, 1), whichever lanes are read
    base_idx = np.tile(np.array([0, 1]), (16, groups, 1))
    base = card.run(form, a_regs, b_regs, np.full(32, 0x44444444, np.uint32))
    fragments_ok = bool(np.array_equal(base, _dense(ac, base_idx) @ bm))

    # 2. the metadata map, discovered one (lane, nibble) at a time
    found: Dict[Tuple[int, int], Optional[Tuple[int, int]]] = {}
    unexplained = []
    for lane in range(32):
        for j in range(8):
            e = np.full(32, 0x44444444, np.uint32)
            e[lane] ^= np.uint32(0xA << (4 * j))          # (0, 1) -> (2, 3)
            got = card.run(form, a_regs, b_regs, e)
            if np.array_equal(got, base):
                found[(lane, j)] = None
                continue
            hit = None
            for m in np.nonzero((got != base).any(axis=1))[0]:
                for grp in range(groups):
                    idx = base_idx.copy()
                    idx[m, grp] = (2, 3)
                    if np.array_equal(got, _dense(ac, idx) @ bm):
                        hit = (int(m), grp)
            found[(lane, j)] = hit
            if hit is None:
                unexplained.append((lane, j))
    read = {k: v for k, v in found.items() if v is not None}
    map_ok = read == form.meta_map

    # 3. random 2:4 rows (sorted distinct indices, as the compressor keeps
    # them) and 1:4 rows run as 2:4 with a +0, under the assumed maps
    idx24 = np.sort(np.stack([rng.permutation(4)[:2] for _ in range(16 * groups)]), axis=1)
    idx24 = idx24.reshape(16, groups, 2)
    got = card.run(form, a_regs, b_regs, metadata_words(idx24, form.meta_map))
    random_2of4_ok = bool(np.array_equal(got, _dense(ac, idx24) @ bm))
    one = rng.integers(0, 4, (16, groups))
    ac1 = np.zeros_like(ac)
    idx14 = np.zeros((16, groups, 2), np.int64)
    for m in range(16):
        for j in range(groups):
            i = one[m, j]
            idx14[m, j] = (0, 1) if i == 0 else (0, i)
            ac1[m, 2 * j + (0 if i == 0 else 1)] = ac[m, 2 * j]
    got = card.run(form, _a_regs(ac1, form), b_regs, metadata_words(idx14, form.meta_map))
    random_1of4_ok = bool(np.array_equal(got, _dense(ac1, idx14) @ bm))

    ok = fragments_ok and map_ok and random_2of4_ok and random_1of4_ok and not unexplained
    return {"ok": ok, "fragments_ok": fragments_ok, "metadata_map_ok": map_ok,
            "lanes_read": sorted({lane for lane, _ in read}),
            # lane: [(row, group) of nibble 0 .. 7]
            "map": {lane: [read.get((lane, j)) for j in range(8)]
                    for lane in sorted({lane for lane, _ in read})},
            "unexplained": unexplained, "random_2of4_ok": random_2of4_ok,
            "random_1of4_ok": random_1of4_ok}


def _probe_dense(card: _Card, a: np.ndarray, b: np.ndarray, form: _Form) -> bool:
    """A (16, 32) and B (32, 8) of integers exact in the form's type,
    registers by the assumed maps: the product is the plain one."""
    got = card.run(form, _a_regs(a, form), _b_regs(b, form), np.zeros(32, np.uint32))
    return bool(np.array_equal(got, a.astype(np.float64) @ b.astype(np.float64)))


def probe(device: str = "cuda", seed: int = 0) -> dict:
    """Run the checks of every instruction on one card; returns what was
    found (``ok`` True when every map of each is the assumed one)."""
    rng = np.random.default_rng(seed)
    card = _Card(device)
    found = {form.name: _probe_form(card, form, rng) for form in FORMS}
    # the dense forms on one A and B of small integers (exact in e4m3), and
    # s8 at full range (|sums| < 2^19: exact in the fp32 compare)
    a = rng.integers(-3, 4, (16, 32)).astype(np.float32)
    b = rng.integers(-3, 4, (32, 8)).astype(np.float32)
    wide = (rng.integers(-127, 128, (16, 32)).astype(np.float32),
            rng.integers(-127, 128, (32, 8)).astype(np.float32))
    for form in DENSE_FORMS:
        checks = {"product_ok": _probe_dense(card, a, b, form)}
        if form.dtype == torch.int8:
            checks["full_range_ok"] = _probe_dense(card, *wide, form)
        found[form.name] = {"ok": all(checks.values()), **checks}
    return {"ok": all(f["ok"] for f in found.values()), **found,
            "device": torch.cuda.get_device_name(torch.device(device))}


if __name__ == "__main__":
    print(json.dumps(probe(), default=str))
