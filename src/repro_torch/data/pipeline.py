"""Deterministic, resumable synthetic token pipeline.

Every batch is a pure function of ``(seed, step, host_set)``:
* exact resume after checkpoint restore — restore the step counter and the
  stream regenerates the identical remaining sequence;
* elastic re-sharding — when the host set changes, each surviving host's
  shard is recomputed from the same global sequence, so no examples are
  duplicated or dropped (DESIGN.md §6).

The synthetic distribution is a skewed Zipf-ish mixture with a Markov
bigram kick so that losses actually decrease during the example runs (a
uniform stream would pin CE at log V).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

__all__ = ["TokenStream", "make_batch_iterator"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = self.global_batch // self.n_hosts

    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Local shard of the global batch for ``step``."""
        rows = range(self.host_id * self.local_batch,
                     (self.host_id + 1) * self.local_batch)
        toks = np.empty((self.local_batch, self.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            rng = self._rng_for(step, r)
            # Zipf-skewed unigram base
            base = rng.zipf(1.3, size=self.seq_len + 1) % self.vocab
            # bigram kick: even positions follow (prev*7 + 11) mod V
            follow = (np.roll(base, 1) * 7 + 11) % self.vocab
            mask = rng.random(self.seq_len + 1) < 0.5
            toks[i] = np.where(mask, follow, base)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step,
                "n_hosts": self.n_hosts, "host_id": self.host_id}

    @classmethod
    def from_state(cls, state: dict, vocab: int, seq_len: int,
                   global_batch: int) -> "TokenStream":
        return cls(vocab=vocab, seq_len=seq_len, global_batch=global_batch,
                   seed=state["seed"], n_hosts=state["n_hosts"],
                   host_id=state["host_id"])

    def reshard(self, n_hosts: int, host_id: int) -> "TokenStream":
        """Elastic re-shard: same global stream, new host split."""
        return dataclasses.replace(self, n_hosts=n_hosts, host_id=host_id)


def make_batch_iterator(stream: TokenStream, start_step: int = 0,
                        extra_feats: Optional[dict] = None,
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Iterator of batches from ``start_step``; optionally attaches static
    modality-stub features (audio frames / vision patches)."""
    step = start_step
    while True:
        b = stream.batch(step)
        if extra_feats:
            b = {**b, **extra_feats}
        yield b
        step += 1
