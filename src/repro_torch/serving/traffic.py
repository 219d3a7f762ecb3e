"""Synthetic traffic: seeded Poisson arrivals + length mixtures (the port's
copy of ``repro.serving.traffic``).

The harness emits :class:`repro_torch.serving.Request` lists with exponential
interarrival gaps (rate = requests per scheduler iteration) and
categorical prompt/generation length mixtures, all driven by one
``numpy.random.RandomState`` seed — the same seed always produces the
same trace, which is what makes the interleaving-determinism and
engine-vs-lockstep comparisons in CI meaningful.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .scheduler import Request

__all__ = ["make_poisson_trace"]

# (value, probability) mixtures: mostly short prompts with a long tail,
# the shape real serving traces have
DEFAULT_PROMPT_MIX: Tuple[Tuple[int, float], ...] = (
    (4, 0.5), (8, 0.3), (12, 0.2))
DEFAULT_NEW_MIX: Tuple[Tuple[int, float], ...] = (
    (4, 0.4), (8, 0.4), (12, 0.2))


def _pick(rng: np.random.RandomState,
          mix: Sequence[Tuple[int, float]]) -> int:
    vals = [v for v, _ in mix]
    ps = np.asarray([p for _, p in mix], np.float64)
    return int(rng.choice(vals, p=ps / ps.sum()))


def make_poisson_trace(
    seed: int = 0,
    num_requests: int = 16,
    rate: float = 1.0,
    prompt_mix: Sequence[Tuple[int, float]] = DEFAULT_PROMPT_MIX,
    new_mix: Sequence[Tuple[int, float]] = DEFAULT_NEW_MIX,
    vocab_size: int = 256,
) -> list:
    """Seeded Poisson trace of ``num_requests`` requests.

    ``rate`` is arrivals per scheduler iteration; prompt token ids are
    uniform in ``[1, vocab_size)`` (0 is the idle-slot pad token).
    """
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for i in range(num_requests):
        t += float(rng.exponential(1.0 / rate))
        plen = _pick(rng, prompt_mix)
        nnew = _pick(rng, new_mix)
        prompt = tuple(int(x) for x in rng.randint(1, vocab_size, size=plen))
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=nnew,
                           arrival=t))
    return out
