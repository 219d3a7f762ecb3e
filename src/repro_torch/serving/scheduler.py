"""Request scheduler: slot assignment and the KV block budget.

The port's copy of ``repro.serving.scheduler`` (host numpy only, so the
code is the JAX package's line for line; its decisions are held bitwise
equal to the reference in the tests).

Host-side, numpy-only state (the device never sees a Python branch):

- a **free list** of physical block ids (block 0 is the reserved scratch
  block that masked writes target — never allocatable);
- the **block table**, ``(slots, table_width)`` int32, row ``s`` mapping
  request ``s``'s logical block ``j`` to a physical block id (0 where
  unallocated — reads of those positions are always masked out by the
  ``j <= pos`` attention mask, so a stale or zero entry is harmless);
- per-slot :class:`SlotState` tracking prefill progress, decode
  position, and generated tokens — ragged lengths retire independently.

Admission policies:

- ``reserve``: a request is admitted only when its worst-case block
  count (``ceil((prompt + max_new - 1) / block_len)``) is free.  Nothing
  ever needs eviction.
- ``optimistic``: admitted on prompt-sized headroom; blocks allocate
  lazily as positions advance.  When the pool runs dry the scheduler
  preempts the most recently admitted running request (LIFO victim —
  the standard recompute-preemption choice: the youngest request has
  the least work to redo), frees its blocks, and requeues it.  Preempted
  requests are held until a retirement frees real capacity (prevents
  admit/evict thrash).  Greedy decoding makes recomputation reproduce
  the identical stream, so eviction is invisible in outputs.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from math import ceil
from typing import Deque, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "SlotState", "PagedScheduler"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``arrival`` is in scheduler iterations
    (the traffic harness emits Poisson arrival times on this axis)."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival: float = 0.0

    def blocks_needed(self, block_len: int) -> int:
        # positions ever written: the prompt plus every generated token
        # except the last (which is emitted but never re-fed)
        written = len(self.prompt) + self.max_new_tokens - 1
        return max(1, ceil(written / block_len))


@dataclasses.dataclass
class SlotState:
    req: Request
    seq: int                      # admission order (LIFO eviction key)
    state: str = "prefill"        # "prefill" | "decode"
    prefill_off: int = 0          # prompt tokens already prefilled
    pos: int = 0                  # decode: position of the next write
    out: List[int] = dataclasses.field(default_factory=list)
    enqueue_wall: float = 0.0
    enqueue_iter: float = 0.0


class PagedScheduler:
    def __init__(self, *, slots: int, table_width: int, num_blocks: int,
                 block_len: int, admission: str = "reserve"):
        self.nslots = slots
        self.table_width = table_width
        self.num_blocks = num_blocks
        self.block_len = block_len
        self.admission = admission
        self.free: Deque[int] = deque(range(1, num_blocks + 1))
        self.table = np.zeros((slots, table_width), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(slots)]
        # worst-case blocks promised to each running slot (reserve mode);
        # allocation itself is lazy, so admission must debit promises,
        # not the free list
        self._reserve: List[int] = [0] * slots
        self.slots: List[Optional[SlotState]] = [None] * slots
        self.waiting: Deque[SlotState] = deque()
        self.preempted: Deque[SlotState] = deque()
        self._seq = 0
        self._hold_preempted = False
        self.evictions = 0
        self.max_blocks_in_use = 0

    # ------------------------------------------------------------ queues
    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self.free)

    @property
    def running(self) -> List[int]:
        return [s for s in range(self.nslots) if self.slots[s] is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.running or self.waiting or self.preempted)

    def enqueue(self, req: Request, *, wall: float = 0.0,
                it: float = 0.0) -> None:
        if req.blocks_needed(self.block_len) > self.num_blocks:
            raise ValueError(
                f"request {req.rid} needs {req.blocks_needed(self.block_len)}"
                f" blocks but the budget is {self.num_blocks}")
        if len(req.prompt) + req.max_new_tokens - 1 > self.table_width * self.block_len:
            raise ValueError(
                f"request {req.rid} exceeds max_len "
                f"({self.table_width * self.block_len} positions)")
        self.waiting.append(SlotState(req=req, seq=-1, enqueue_wall=wall,
                                      enqueue_iter=it))

    def _admit_need(self, req: Request) -> int:
        if self.admission == "reserve":
            return req.blocks_needed(self.block_len)
        return max(1, ceil(len(req.prompt) / self.block_len))

    def headroom(self) -> int:
        """Free blocks not yet promised to a running slot — what
        admission may hand out.  Equals ``len(free)`` under
        ``optimistic`` (which promises nothing)."""
        pending = sum(max(0, self._reserve[s] - len(self.owned[s]))
                      for s in self.running)
        return len(self.free) - pending

    def _queue_head(self):
        if self.preempted and not (self._hold_preempted and self.running):
            return self.preempted
        if self.waiting:
            return self.waiting
        return None

    def admit_ready(self) -> List[int]:
        """Fill free slots from the queues (FIFO, no head-of-line bypass
        — determinism under a fixed seed is part of the test contract).
        Returns newly admitted slot indices (their per-slot recurrent
        state must be reset by the engine)."""
        admitted = []
        for s in range(self.nslots):
            if self.slots[s] is not None:
                continue
            q = self._queue_head()
            if q is None:
                break
            st = q[0]
            if self.headroom() < self._admit_need(st.req):
                break
            q.popleft()
            st.seq = self._seq
            self._seq += 1
            st.state = "prefill"
            st.prefill_off = 0
            st.pos = 0
            st.out = []
            self.slots[s] = st
            self.table[s, :] = 0
            self.owned[s] = []
            self._reserve[s] = (st.req.blocks_needed(self.block_len)
                                if self.admission == "reserve" else 0)
            admitted.append(s)
        return admitted

    # ------------------------------------------------------------ blocks
    def _pick_victim(self) -> Optional[int]:
        running = self.running
        if not running:
            return None
        return max(running, key=lambda s: self.slots[s].seq)

    def _evict(self, s: int) -> None:
        st = self.slots[s]
        for b in self.owned[s]:
            self.free.append(b)
        self.owned[s] = []
        self.table[s, :] = 0
        self.slots[s] = None
        self._reserve[s] = 0
        self.evictions += 1
        self._hold_preempted = True
        self.preempted.append(st)

    def ensure_blocks(self, s: int, upto_pos: int) -> bool:
        """Allocate until slot ``s`` covers position ``upto_pos``.

        Returns False when the slot cannot make progress this iteration —
        either the pool is dry with no victim, or the slot itself was the
        LIFO victim and has been preempted.
        """
        need = upto_pos // self.block_len + 1
        assert need <= self.table_width, (need, self.table_width)
        while len(self.owned[s]) < need:
            if not self.free:
                if self.admission == "reserve":
                    raise RuntimeError(
                        "block pool dry under reserve admission — "
                        "admission accounting is broken")
                victim = self._pick_victim()
                if victim is None:
                    return False
                self._evict(victim)
                if victim == s:
                    return False
                continue
            b = self.free.popleft()
            self.owned[s].append(b)
            self.table[s, len(self.owned[s]) - 1] = b
        self.max_blocks_in_use = max(self.max_blocks_in_use,
                                     self.blocks_in_use)
        return True

    def retire(self, s: int) -> SlotState:
        st = self.slots[s]
        for b in self.owned[s]:
            self.free.append(b)
        self.owned[s] = []
        self.table[s, :] = 0
        self.slots[s] = None
        self._reserve[s] = 0
        self._hold_preempted = False
        return st
