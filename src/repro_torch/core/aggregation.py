"""Server-side aggregation (paper Eqs. 4-5): the port of
``repro.core.aggregation`` -- the per-node functions of the sequential
round, the node-stacked ones of the round engine
(``weighted_average_stacked`` and its bucketed halves, with a
participation mask), and the async report buffer's average
(``weighted_average_reports``).

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


def weighted_average_stacked(stacked, weights: torch.Tensor, shipped_mask):
    """The server step on one node-stacked tree: shipped leaves are
    weight-averaged along the leading node axis and broadcast back to every
    node; node-local leaves (the adapters) pass through.  The single-bucket
    case of ``weighted_average_bucketed``."""
    return weighted_average_bucketed((stacked,), weights, (shipped_mask,),
                                     (int(weights.shape[0]),))[0]


def bucketed_partial_sums(bucket_trees, weights: torch.Tensor, shipped_masks,
                          bucket_sizes):
    """The weighted sum over every node of each shipped leaf, in float32
    (None at non-shipped leaves): a partial sum per width bucket, then the
    buckets added.  ``weights`` (K,) is in bucket-concatenated row order;
    shipped leaves have the same shape in every bucket."""
    total, off = None, 0
    for tree, mask, kb in zip(bucket_trees, shipped_masks, bucket_sizes):
        w = weights[off:off + kb].float()
        off += kb
        part = tree_map(lambda leaf, m, w=w: None if leaf is None or not m
                        else torch.tensordot(w, leaf.float(), dims=1),
                        tree, mask)
        total = part if total is None else tree_map(
            lambda a, b: None if a is None else a + b, total, part)
    return total


def broadcast_into_buckets(bucket_trees, shipped_masks, total):
    """``total`` written onto every node row of every bucket (cast to each
    leaf's dtype); non-shipped leaves pass through."""
    def bcast(leaf, m, a):
        if leaf is None or not m:
            return leaf
        return a.to(leaf.dtype)[None].expand(leaf.shape).contiguous()
    return tuple(tree_map(bcast, tree, mask, total)
                 for tree, mask in zip(bucket_trees, shipped_masks))


def weighted_average_bucketed(bucket_trees, weights: torch.Tensor,
                              shipped_masks, bucket_sizes,
                              part_mask: torch.Tensor = None):
    """The server step across width buckets: ``bucket_trees[b]`` stacks
    bucket b's nodes on a leading axis and ``weights`` (K,) is in
    bucket-concatenated row order.  Shipped leaves are averaged over all
    buckets and broadcast back into each; node-local leaves, whose widths
    differ by bucket, pass through.  ``part_mask`` (K,) 0/1 zeroes the
    non-reporting rows out of the average and renormalises the weights
    over the reporters (Eqs. 4-5 over the cohort); None uses the weights
    as given."""
    if part_mask is not None:
        w = weights.float() * part_mask.float()
        weights = w / w.sum().clamp_min(1e-12)
    return broadcast_into_buckets(
        bucket_trees, shipped_masks,
        bucketed_partial_sums(bucket_trees, weights, shipped_masks,
                              bucket_sizes))


def weighted_average_reports(report_tree, weights: torch.Tensor):
    """Weighted sum over the async REPORT BUFFER: each leaf stacks the K
    nodes' buffered shipped side-cars on a leading axis; ``weights`` (K,)
    is already staleness-normalised (all zero on a round with no
    delivery, giving the zero tree: the caller keeps the previous value).
    Returns the float32 tree."""
    w = weights.float()
    return tree_map(lambda leaf: None if leaf is None
                    else torch.tensordot(w, leaf.float(), dims=1),
                    report_tree)


def comm_bytes_per_round(trainable_tree, gram_side: int = 0) -> int:
    """Uplink bytes of one node per round: its shipped side-cars and its
    B x B f32 Gram."""
    return param_bytes(trainable_tree) + gram_side * gram_side * 4


__all__ = ["weighted_mean_trees", "aggregate_geolora",
           "weighted_average_stacked", "bucketed_partial_sums",
           "broadcast_into_buckets", "weighted_average_bucketed",
           "weighted_average_reports", "comm_bytes_per_round"]
