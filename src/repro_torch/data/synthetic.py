"""Synthetic language-modeling data.

Counterpart of ``repro/data/synthetic.py``.  With no corpus, training
batches come from a Markov chain with a low-entropy transition table
(each token has ``branching`` plausible successors), so the loss has a
floor near ``log(branching)`` and a model that learns falls well below
``log(vocab)``.  ``SyntheticLMDataset`` is numpy alone and its batches
are bitwise the reference's for the same seed; ``make_lm_batch`` draws
uniform tokens from a ``torch.Generator`` on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMDataset:
    """Markov-chain token stream: ``tokens`` and ``labels`` (the tokens
    shifted by one), int32 ``(batch, seq_len)`` numpy arrays."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(
            0, self.vocab, size=(self.vocab, self.branching)).astype(np.int32)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """An endless stream of batches from ``seed + 1``."""
        rng = np.random.default_rng(self.seed + 1)
        while True:
            yield self.sample(rng)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One batch: a random first token, then a successor of each."""
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        choices = rng.integers(0, self.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_lm_batch(generator: torch.Generator, vocab: int, batch: int,
                  seq_len: int) -> Dict[str, torch.Tensor]:
    """Uniform int64 tokens in ``[0, vocab)`` on ``generator``'s device:
    ``tokens`` and ``labels`` ``(batch, seq_len)``, the labels shifted by
    one."""
    toks = torch.randint(0, vocab, (batch, seq_len + 1),
                         generator=generator, device=generator.device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
