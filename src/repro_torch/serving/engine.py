"""Continuous-batching engine over the paged KV cache (port of
``repro.serving.engine``).

Each iteration of :meth:`Engine.run`: arrivals enter the waiting queue,
free slots admit under the block budget, the oldest prefilling request
advances by one prefill chunk, and one batched decode step advances every
decode-state slot at its own position.  Finished requests retire
independently and their blocks return to the pool.  The scheduler is the
JAX package's, line for line; the model calls run eagerly on the
prepared device under ``torch.inference_mode()``.

Under a mesh (``ServingSpec.mesh = (1, M)``) every rank runs this same
loop on the same trace (the scheduler is deterministic), each model call
on its own shard; at the end the ranks check that their token streams
are equal and raise if not.  Rank 0 is the one that reports.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from .scheduler import PagedScheduler, Request
from .spec import Prepared, resolve_device

__all__ = ["Engine", "RequestStats", "ServingReport", "percentile"]


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile."""
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


@dataclasses.dataclass
class RequestStats:
    rid: int
    prompt_len: int
    new_tokens: int
    tokens: tuple           # the generated token ids
    arrival: float          # scheduler-iteration timestamp
    done_iter: int
    latency_s: float        # wall: enqueue -> last token
    tokens_per_s: float     # generated tokens / latency


@dataclasses.dataclass
class ServingReport:
    """What a serving run did."""

    stats: List[RequestStats]
    total: int
    completed: int
    wall_s: float
    model_calls: int        # prefill chunks + decode steps
    prefill_chunks: int
    decode_calls: int
    evictions: int
    max_blocks_in_use: int
    num_blocks: int

    @property
    def p50_latency_s(self) -> float:
        return percentile([s.latency_s for s in self.stats], 50.0)

    @property
    def p99_latency_s(self) -> float:
        return percentile([s.latency_s for s in self.stats], 99.0)

    @property
    def generated_tokens(self) -> int:
        return sum(s.new_tokens for s in self.stats)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def completed_per_call(self) -> float:
        return self.completed / self.model_calls if self.model_calls else 0.0

    def describe(self) -> str:
        return (f"{self.completed}/{self.total} requests in "
                f"{self.wall_s:.2f}s over {self.model_calls} model calls "
                f"({self.tokens_per_s:.1f} tok/s, "
                f"p50 {self.p50_latency_s * 1e3:.0f}ms / "
                f"p99 {self.p99_latency_s * 1e3:.0f}ms, "
                f"{self.evictions} eviction(s), "
                f"peak {self.max_blocks_in_use}/{self.num_blocks} blocks)")


class Engine:
    """Continuous-batching serving engine:
    ``Engine(prepare(params, spec, cfg=cfg)).run(requests)``."""

    def __init__(self, prepared: Prepared):
        if prepared.cfg is None:
            raise ValueError("Engine needs a full model: prepare(..., cfg=cfg)")
        from ..models.paged import check_paged
        check_paged(prepared.cfg)
        self.prepared = prepared
        self.spec = prepared.spec
        self.cfg = prepared.cfg
        self.device = resolve_device(prepared.device)
        self.num_blocks = (self.spec.kv_blocks if self.spec.kv_blocks is not None
                           else self.spec.default_kv_blocks())

    def _fresh_caches(self):
        return self._caches(self.device)

    def _caches(self, device):
        from ..models.paged import init_paged_caches
        # +1: physical block 0 is the scratch target for masked writes; under
        # the mesh's env the pools hold this rank's KV heads; SSM state is
        # one row per slot
        with self.prepared.activate():
            return init_paged_caches(self.cfg, self.num_blocks + 1, self.spec.block_len,
                                     self.spec.slots, device=device)

    def kv_bytes(self) -> int:
        """Device bytes of this rank's caches (the attention layers' block
        pools and the Mamba layers' recurrent state), from the shapes alone:
        the caches are made on the meta device, which allocates nothing."""
        return sum(t.numel() * t.element_size()
                   for cache in self._caches("meta") for t in cache.values())

    def dispatch_report(self):
        return self.prepared.dispatch_report()

    def run(self, requests: Sequence[Request]) -> ServingReport:
        with torch.inference_mode():
            return self._run(requests)

    def _run(self, requests) -> ServingReport:
        from ..models.paged import (paged_decode_step, paged_prefill_chunk,
                                    reset_slot_state)

        spec, dev = self.spec, self.device
        params = self.prepared.params
        sched = PagedScheduler(slots=spec.slots, table_width=spec.table_width,
                               num_blocks=self.num_blocks, block_len=spec.block_len,
                               admission=spec.admission)
        caches = self._fresh_caches()
        arrivals = sorted(requests, key=lambda r: (r.arrival, r.rid))
        n = len(arrivals)
        # every token its own iteration plus slack: a livelock trips this
        max_iters = 64 + 16 * sum(len(r.prompt) + r.max_new_tokens for r in arrivals)
        stats: List[RequestStats] = []
        prefill_chunks = decode_calls = 0
        ai = it = work = 0
        t0 = time.perf_counter()

        def _retire(s: int):
            st = sched.retire(s)
            lat = time.perf_counter() - st.enqueue_wall
            stats.append(RequestStats(
                rid=st.req.rid, prompt_len=len(st.req.prompt),
                new_tokens=len(st.out),
                tokens=tuple(st.out),
                arrival=st.req.arrival, done_iter=it, latency_s=lat,
                tokens_per_s=len(st.out) / lat if lat > 0 else 0.0))

        with self.prepared.activate():
            while len(stats) < n:
                if work >= max_iters:
                    raise RuntimeError(f"engine made no progress after {max_iters} "
                                       f"iterations ({len(stats)}/{n} done)")
                while ai < n and arrivals[ai].arrival <= it:
                    sched.enqueue(arrivals[ai], wall=time.perf_counter(), it=float(it))
                    ai += 1
                if not sched.has_work:
                    it = max(it + 1, int(np.ceil(arrivals[ai].arrival)))
                    continue

                for s in sched.admit_ready():
                    caches = reset_slot_state(caches, s)

                # one prefill chunk for the oldest prefilling request
                pre = [s for s in sched.running if sched.slots[s].state == "prefill"]
                if pre:
                    s = min(pre, key=lambda s_: sched.slots[s_].seq)
                    st = sched.slots[s]
                    c = min(spec.prefill_chunk, len(st.req.prompt) - st.prefill_off)
                    if sched.ensure_blocks(s, st.prefill_off + c - 1):
                        tok = torch.tensor(
                            st.req.prompt[st.prefill_off:st.prefill_off + c],
                            dtype=torch.long, device=dev)[None, :]
                        logits, caches = paged_prefill_chunk(
                            params, caches, tok, st.prefill_off,
                            torch.from_numpy(sched.table[s:s + 1]).to(dev),
                            c, self.cfg, spec.block_len, slot_idx=s)
                        prefill_chunks += 1
                        st.prefill_off += c
                        if st.prefill_off == len(st.req.prompt):
                            st.state = "decode"
                            st.pos = len(st.req.prompt)
                            st.out.append(int(torch.argmax(logits[0, c - 1])))
                            if len(st.out) >= st.req.max_new_tokens:
                                _retire(s)

                # one batched decode step over every decode-state slot
                dec = [s for s in sched.running if sched.slots[s].state == "decode"]
                ready = []
                for s in dec:
                    st = sched.slots[s]
                    if st is None or st.state != "decode":
                        continue
                    if sched.ensure_blocks(s, st.pos):
                        ready.append(s)
                ready = [s for s in ready if sched.slots[s] is not None
                         and sched.slots[s].state == "decode"]
                if ready:
                    feed = np.zeros((spec.slots, 1), np.int64)
                    positions = np.zeros((spec.slots,), np.int64)
                    active = np.zeros((spec.slots,), bool)
                    for s in ready:
                        st = sched.slots[s]
                        feed[s, 0] = st.out[-1]
                        positions[s] = st.pos
                        active[s] = True
                    logits, caches = paged_decode_step(
                        params, caches, torch.from_numpy(feed).to(dev),
                        torch.from_numpy(positions).to(dev),
                        torch.from_numpy(sched.table).to(dev),
                        torch.from_numpy(active).to(dev), self.cfg, spec.block_len)
                    decode_calls += 1
                    nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
                    for s in ready:
                        st = sched.slots[s]
                        st.out.append(int(nxt[s]))
                        st.pos += 1
                        if len(st.out) >= st.req.max_new_tokens:
                            _retire(s)
                it += 1
                work += 1

        stats = sorted(stats, key=lambda s_: s_.rid)
        env = self.prepared.axis_env
        if env is not None and env.model_size > 1:
            _check_ranks_agree(stats, env, dev)
        return ServingReport(
            stats=stats, total=n, completed=len(stats),
            wall_s=time.perf_counter() - t0,
            model_calls=prefill_chunks + decode_calls,
            prefill_chunks=prefill_chunks, decode_calls=decode_calls,
            evictions=sched.evictions, max_blocks_in_use=sched.max_blocks_in_use,
            num_blocks=self.num_blocks)


def _check_ranks_agree(stats: List[RequestStats], env, dev) -> None:
    """Raise unless every rank generated rank 0's token streams: rank 0
    broadcasts its streams, each rank compares, and the ranks all-reduce
    (MAX) the mismatch flag, so all of them raise or none does."""
    import torch.distributed as dist

    mine = torch.tensor([v for s in stats for v in (s.rid, len(s.tokens), *s.tokens)],
                        dtype=torch.int64, device=dev)
    size = torch.tensor([mine.numel()], dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0, group=env.group)
    theirs = torch.empty(int(size.item()), dtype=torch.int64, device=dev)
    if env.model_rank == 0:
        theirs.copy_(mine)
    dist.broadcast(theirs, src=0, group=env.group)
    same = theirs.shape == mine.shape and torch.equal(theirs, mine)
    bad = torch.tensor([int(not same)], dtype=torch.int64, device=dev)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=env.group)
    if bad.item():
        raise RuntimeError(f"the {env.model_size} ranks generated different token streams "
                           f"(rank {env.model_rank}'s {'match' if same else 'differ from'} "
                           f"rank 0's)")
