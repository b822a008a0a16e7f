"""Server-side aggregation (paper Eqs. 4-5): the port of the per-node
functions of ``repro.core.aggregation``.

``lora_A`` is frozen and the same on every node, so averaging the
``lora_B`` factors averages the low-rank updates exactly; with GeoDoRA the
averaged magnitude multiplies the averaged direction at apply time, so
averaging the shipped side-cars is the whole server step.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.lora import param_bytes
from repro_torch.tree import tree_map


def weighted_mean_trees(trees: Sequence,
                        weights: Optional[torch.Tensor] = None):
    """Weighted average of trees with one structure; ``weights`` (K,) sums
    to 1 (uniform when None).  Accumulates in float32 and casts back to
    each leaf's dtype; None leaves stay None."""
    k = len(trees)
    if weights is None:
        weights = torch.full((k,), 1.0 / k)

    def avg(*leaves):
        if leaves[0] is None:
            return None
        acc = torch.zeros_like(leaves[0], dtype=torch.float32)
        for i, leaf in enumerate(leaves):
            acc = acc + weights[i].to(acc.device) * leaf.float()
        return acc.to(leaves[0].dtype)

    return tree_map(avg, *trees)


def aggregate_geolora(node_trainables: Sequence,
                      weights: Optional[torch.Tensor] = None):
    """Eqs. 4 (+5): average the shipped side-car trees (lora_B, dora_m,
    shared heads)."""
    return weighted_mean_trees(node_trainables, weights)


def comm_bytes_per_round(trainable_tree, gram_side: int = 0) -> int:
    """Uplink bytes of one node per round: its shipped side-cars and its
    B x B f32 Gram."""
    return param_bytes(trainable_tree) + gram_side * gram_side * 4


__all__ = ["weighted_mean_trees", "aggregate_geolora", "comm_bytes_per_round"]
