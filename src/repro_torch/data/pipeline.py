"""Data pipeline: deterministic synthetic LM token streams and host
batching with device placement -- the port of ``repro.data.pipeline``,
used by the LM training driver (``launch/train.py``).

``SyntheticLMStream`` is the reference's numpy code, seeded by
``numpy.random.default_rng(seed)``, so both packages yield the same token
streams.  A block of rounds is stacked on the host in numpy and shipped
as one host-to-device copy per leaf (pinned, ``non_blocking``), which
returns before the copy lands: a driver stages block N + 1 while the card
runs block N.

Not ported yet: ``shard_batch`` (it waits for ``mesh=``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class SyntheticLMStream:
    """Markov-ish synthetic token stream: structured enough that a model can
    reduce loss, deterministic per seed."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        # low-rank transition structure => learnable bigram statistics
        rank = 8
        u = rng.standard_normal((self.vocab_size, rank))
        v = rng.standard_normal((rank, self.vocab_size))
        logits = (u @ v) / np.sqrt(rank)
        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        cumprobs = probs.cumsum(1)
        while True:
            toks = np.empty((self.batch_size, self.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, self.vocab_size, self.batch_size)
            r = rng.random((self.batch_size, self.seq_len))
            for t in range(self.seq_len):
                rows = cumprobs[toks[:, t]]
                toks[:, t + 1] = (rows < r[:, t:t + 1]).sum(1)
            # host (numpy) batches: consumers stack whole rounds or blocks
            # and ship ONE device transfer per leaf, so yielding device
            # arrays here would only add per-batch round-trips
            yield {"tokens": toks[:, :-1].copy(),
                   "labels": toks[:, 1:].copy()}


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy; from pinned memory and ``non_blocking`` on
    the card, so it returns before the copy lands."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def stack_block_batches(grid, device="cpu") -> dict:
    """``grid[m][e][k]`` per-(round, step, node) batch dicts of numpy
    arrays -> one dict of tensors on ``device`` with leading ``(M, E, K,
    ...)`` axes: stacked on the host, then one copy per leaf instead of
    M E K small ones."""
    keys = grid[0][0][0].keys()
    return {name: _to_device(np.stack([np.stack([np.stack(
        [np.asarray(b[name]) for b in nodes]) for nodes in rnd])
        for rnd in grid]), device) for name in keys}


@dataclass
class BlockStager:
    """Host-side staging for blocks of rounds: pulls M rounds x E steps from
    the K per-node streams and stacks them into ``(M, E, K, ...)`` tensors.
    Streams are consumed in (round, step, node) order, the per-round
    driver's order, so the data does not depend on the block size."""
    streams: list
    local_steps: int
    block_rounds: int
    device: object = "cpu"

    def next_block(self, m: Optional[int] = None) -> dict:
        m = self.block_rounds if m is None else m
        grid = [[[next(s) for s in self.streams]
                 for _ in range(self.local_steps)] for _ in range(m)]
        return stack_block_batches(grid, self.device)


def make_lm_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                  seq: int) -> dict:
    """Uniform random tokens from ``gen`` (on its device): ``{"tokens",
    "labels": (batch, seq) int32}``, labels the tokens shifted by one."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=gen.device, dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


__all__ = ["SyntheticLMStream", "stack_block_batches", "BlockStager",
           "make_lm_batch"]
