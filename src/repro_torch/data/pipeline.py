"""Data pipeline: deterministic synthetic LM token streams and host
batching with device placement -- the port of ``repro.data.pipeline``,
used by the LM training driver (``launch/train.py``).

``SyntheticLMStream`` is the reference's numpy code, seeded by
``numpy.random.default_rng(seed)``, so both packages yield the same token
streams.  A block of rounds is stacked on the host in numpy and shipped
as one host-to-device copy per leaf (pinned, ``non_blocking``), which
returns before the copy lands: a driver stages block N + 1 while the card
runs block N.

Under a mesh (``launch/mesh.py``; the reference's ``NamedSharding`` over
the batch axes) one process per device holds its own slice of the node
axis: ``shard_batch``, ``stack_block_batches(sharding=)`` and
``BlockStager(sharding=)`` put only the rank's node rows on the rank's
device (the stager reads only the rank's streams), the rows
``s K / R .. (s + 1) K / R`` of shard s of R, as the sharded round engine
holds them.
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


def _node_rows(k: int, mesh) -> slice:
    """The rows of a K-node axis that this rank of ``mesh`` holds."""
    from repro_torch.launch import mesh as mesh_mod
    n, s = mesh_mod.n_nodes(mesh), mesh_mod.shard_index(mesh)
    if k % n:
        raise ValueError(f"{k} nodes do not divide the {n} mesh batch "
                         f"slices")
    return slice(s * (k // n), (s + 1) * (k // n))


def shard_batch(batch: dict, sharding) -> dict:
    """A host batch whose leaves lead with the node axis -> this rank's
    rows of every leaf, on its device (``sharding``: the mesh whose batch
    axes split the nodes)."""
    from repro_torch.launch.mesh import mesh_device
    dev = mesh_device(sharding)
    return {name: _to_device(np.asarray(x)[_node_rows(len(x), sharding)],
                             dev) for name, x in batch.items()}


def stack_block_batches(grid, device="cpu", sharding=None) -> dict:
    """``grid[m][e][k]`` per-(round, step, node) batch dicts of numpy
    arrays -> one dict of tensors on ``device`` with leading ``(M, E, K,
    ...)`` axes: stacked on the host, then one copy per leaf instead of
    M E K small ones.  With ``sharding`` (a mesh) only this rank's node
    rows, on its device."""
    if sharding is not None:
        from repro_torch.launch.mesh import mesh_device
        rows = _node_rows(len(grid[0][0]), sharding)
        grid = [[nodes[rows] for nodes in rnd] for rnd in grid]
        device = mesh_device(sharding)
    keys = grid[0][0][0].keys()
    return {name: _to_device(np.stack([np.stack([np.stack(
        [np.asarray(b[name]) for b in nodes]) for nodes in rnd])
        for rnd in grid]), device) for name in keys}


@dataclass
class BlockStager:
    """Host-side staging for blocks of rounds: pulls M rounds x E steps from
    the K per-node streams and stacks them into ``(M, E, K, ...)`` tensors.
    Streams are consumed in (round, step, node) order, the per-round
    driver's order, so the data does not depend on the block size.  With
    ``sharding`` (a mesh) only this rank's streams are read, and their
    rows land on its device."""
    streams: list
    local_steps: int
    block_rounds: int
    device: object = "cpu"
    sharding: object = None

    def next_block(self, m: Optional[int] = None) -> dict:
        m = self.block_rounds if m is None else m
        streams, device = self.streams, self.device
        if self.sharding is not None:
            from repro_torch.launch.mesh import mesh_device
            streams = streams[_node_rows(len(streams), self.sharding)]
            device = mesh_device(self.sharding)
        grid = [[[next(s) for s in streams]
                 for _ in range(self.local_steps)] for _ in range(m)]
        return stack_block_batches(grid, device)


def make_lm_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                  seq: int) -> dict:
    """Uniform random tokens from ``gen`` (on its device): ``{"tokens",
    "labels": (batch, seq) int32}``, labels the tokens shifted by one."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=gen.device, dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


__all__ = ["SyntheticLMStream", "shard_batch", "stack_block_batches",
           "BlockStager", "make_lm_batch"]
