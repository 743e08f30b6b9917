"""Deterministic tokenized data pipeline (mirrors ``repro.data.pipeline``).

Each data-parallel host reads its own slice by (host_index, num_hosts),
with a deterministic seed -> sequence mapping, so a restart resumes
mid-epoch without replaying (``state()`` / ``restore()`` round-trip
through the checkpoint's manifest).

The port keeps its own copy of the JAX package's numpy code: its token
stream is byte-identical to the JAX package's for every (seed, step,
host_index, num_hosts).  ``SyntheticCorpus.stream`` draws a unigram token
with ``rng.choice(vocab, p=unigram)``, O(vocab) host work per draw (about
30% of draws); that is the reference stream, so it stays.  The batches
are host numpy arrays; the training loop moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    """Markov-chain token stream with Zipf unigram marginals."""
    vocab: int
    seed: int = 0
    order_mix: float = 0.7        # prob of following the bigram chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse deterministic bigram successor table
        self.next_tok = rng.integers(0, self.vocab, size=(self.vocab, 4))

    def stream(self, seed: int) -> Iterator[int]:
        rng = np.random.default_rng(seed)
        tok = int(rng.integers(0, self.vocab))
        while True:
            yield tok
            if rng.random() < self.order_mix:
                tok = int(self.next_tok[tok, rng.integers(0, 4)])
            else:
                tok = int(rng.choice(self.vocab, p=self.unigram))


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    epoch_seed: int = 0


class DataPipeline:
    """Batches of (tokens, labels) for next-token training."""

    def __init__(self, corpus: SyntheticCorpus, batch: int, seq: int,
                 host_index: int = 0, num_hosts: int = 1):
        self.corpus = corpus
        self.batch = batch
        self.seq = seq
        self.host_index = host_index
        self.num_hosts = num_hosts
        self._state = PipelineState()

    def state(self) -> Dict:
        return dataclasses.asdict(self._state)

    def restore(self, st: Dict):
        self._state = PipelineState(**st)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic function of (host, step): restart-safe."""
        step = self._state.step
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        for b in range(self.batch):
            seed = (self._state.epoch_seed * 1_000_003 +
                    (step * self.num_hosts + self.host_index) * 65_537 + b)
            it = self.corpus.stream(seed)
            toks[b] = [next(it) for _ in range(self.seq + 1)]
        self._state.step += 1
        return toks[:, :-1], toks[:, 1:]
