"""GeoLoRA / GeoDoRA parameter management (paper Eqs. 3-5): the port of
``repro.core.lora``.

GeoLoRA gives every targeted linear a frozen Gaussian ``lora_A``, the same
on every node, and a zero-initialised trainable ``lora_B``, the only
factor communicated.  GeoDoRA adds the column magnitude ``dora_m``.  The
functions walk any parameter tree by name, so they attach to every
architecture; trees are nested dicts of tensors with ``None`` where a
leaf lives in the other half of a partition.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.common import add_dora, add_lora, dora_column_norm
from repro_torch.tree import tree_leaves, tree_map

# attention projections (every attention architecture) and the mixer in /
# out projections of SSM and RG-LRU blocks
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "in_proj", "out_proj",
                   "in_rec", "out", "wq_b", "w_dkv", "w_ukv")
# trained and shipped leaves; node-local subtrees (the W_mk adapters never
# leave the node); small heads trained and averaged
TRAINABLE_LEAVES = ("lora_B", "dora_m")
LOCAL_SUBTREES = ("adapter", "adapter2", "enc_adapter")
SHARED_SUBTREES = ("cls_head",)


@dataclass(frozen=True)
class LoRASpec:
    rank: int = 16
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    dora: bool = False
    a_std: float = 1.0


def _is_linear(node) -> bool:
    return isinstance(node, dict) and isinstance(node.get("w"), torch.Tensor)


def attach_lora(gen: torch.Generator, params: dict, spec: LoRASpec) -> dict:
    """A copy of ``params`` with side-cars on every linear named in
    ``spec.targets``; stacked (L, d_in, d_out) weights get stacked
    side-cars.  ``lora_A`` is drawn from ``gen`` in walk order."""
    def walk(node, name):
        if _is_linear(node):
            if name in spec.targets and node["w"].dim() >= 2:
                new = add_lora(gen, node, spec.rank, node["w"].dtype,
                               a_std=spec.a_std)
                return add_dora(new) if spec.dora else new
            return node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node

    return walk(params, "")


# ----------------------------------------------------------------------
# trainable / frozen partition
def trainable_mask(params) -> dict:
    """Bool tree: True where a leaf is node-trainable under the paper's
    protocol (lora_B, dora_m, adapters, small shared heads)."""
    marked = LOCAL_SUBTREES + SHARED_SUBTREES

    def walk(node, name, inside):
        inside = inside or name in marked
        if isinstance(node, dict):
            return {k: walk(v, k, inside) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name, inside) for v in node)
        return bool(inside or name in TRAINABLE_LEAVES)

    return walk(params, "", False)


def shipped_mask(trainable) -> dict:
    """Bool tree over a trainable tree: True for what a node ships each
    round (lora_B, dora_m, shared heads), False for node-local leaves (the
    adapters), None at None leaves."""
    def walk(node, name, local):
        local = local or name in LOCAL_SUBTREES
        if isinstance(node, dict):
            return {k: walk(v, k, local) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name, local) for v in node)
        return None if node is None else not local

    return walk(trainable, "", False)


def partition(params, mask):
    """(trainable, frozen) trees with None placeholders."""
    return (tree_map(lambda p, m: p if m else None, params, mask),
            tree_map(lambda p, m: None if m else p, params, mask))


def combine(train, frozen):
    return tree_map(lambda t, f: t if f is None else f, train, frozen)


def param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


# ----------------------------------------------------------------------
def merge_lora(params: dict, scale: float = 1.0) -> dict:
    """Fold Delta-W = scale A B (and the DoRA normalisation) into ``w`` and
    drop the side-cars (deployment export)."""
    def walk(node, name):
        if _is_linear(node) and "lora_A" in node:
            w = node["w"].float()
            new_w = w + scale * (node["lora_A"].float()
                                 @ node["lora_B"].float())
            if "dora_m" in node:
                norm = dora_column_norm(node["w"], node["lora_A"],
                                        scale * node["lora_B"])
                new_w = new_w * (node["dora_m"].float()
                                 / norm)[..., None, :]
            return {"w": new_w.to(node["w"].dtype)}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node

    return walk(params, "")


__all__ = ["LoRASpec", "DEFAULT_TARGETS", "attach_lora", "trainable_mask",
           "shipped_mask", "partition", "combine", "param_bytes",
           "merge_lora"]
