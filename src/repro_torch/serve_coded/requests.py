"""Request model and synthetic workloads for the coded serving bridge.

A :class:`ServeRequest` is one user generation: a prompt, a target length,
an arrival instant in *simulation* time (milliseconds, the paper's unit)
and a deadline slack.  The slack is relative — the bridge turns it into an
absolute deadline ``t_arrive + slack × gen_len × t*_m`` with ``t*_m`` the
plan-predicted per-token completion of the request's master at arrival, so
"slack 2" means the same urgency on a fast and a slow tenant.

``synthetic_requests`` builds the mixed workload used by the example,
benchmark and CI smoke: per-master Poisson arrivals with a seeded mix of
tight- and loose-deadline requests (the mix is what separates EDF from
FIFO ordering).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ServeRequest", "synthetic_requests"]


@dataclasses.dataclass
class ServeRequest:
    """One generation request entering the coded server."""
    rid: int
    master: int                 # tenant / master index (plan row)
    prompt: np.ndarray          # (P,) int32 token ids
    gen_len: int                # tokens to generate
    t_arrive: float             # simulation ms
    slack: float = math.inf     # deadline = t_arrive + slack·gen_len·t*_m


def synthetic_requests(n: int, *, masters: int, vocab: int,
                       prompt_len: int = 16, gen_len: int = 8,
                       rate: float = 0.002, seed: int = 0,
                       slack_choices: Optional[Sequence[float]] = (1.5, 4.0),
                       ) -> List[ServeRequest]:
    """``n`` requests with per-master Poisson arrivals (rate per ms).

    Prompts are uniform random tokens of a fixed length (one jit shape).
    ``slack_choices`` draws each request's deadline slack uniformly from
    the given values (None → no deadlines).  Deterministic in ``seed``.
    """
    rng = np.random.default_rng((int(seed), 0x5EB7))
    arrivals: List[Tuple[float, int]] = []
    t = np.zeros(masters)
    per_master = [n // masters + (1 if m < n % masters else 0)
                  for m in range(masters)]
    for m in range(masters):
        for _ in range(per_master[m]):
            t[m] += rng.exponential(1.0 / rate)
            arrivals.append((float(t[m]), m))
    arrivals.sort()
    out: List[ServeRequest] = []
    for rid, (ta, m) in enumerate(arrivals):
        slack = math.inf if slack_choices is None else \
            float(rng.choice(np.asarray(slack_choices, dtype=np.float64)))
        out.append(ServeRequest(
            rid=rid, master=m,
            prompt=rng.integers(0, vocab, size=prompt_len).astype(np.int32),
            gen_len=int(gen_len), t_arrive=ta, slack=slack))
    return out
