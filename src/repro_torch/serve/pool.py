"""Slot-stacked decode cache pool.

The pool holds S request slots whose per-layer caches are stacked on the
slot axis, with one position per slot (``len`` (S,)) instead of the
single-batch scalar, as in ``repro.serve.pool``.  Admitting a request is a
scatter of its prefilled single-request cache into a free slot; the
in-flight slots are not touched.  Layer-stacked leaves -- dense K/V/pos,
MLA's latent ``c_kv`` and rope key ``k_rope`` (DeepSeek-V2: (L, S, C,
kvr) and (L, S, C, rd), no ``pos`` leaf), ssm h/conv, the hybrid family's
``groups`` -- are (L, S, ...), so their slot axis is axis 1; the hybrid
family's ``tail`` blocks are unstacked (S, ...), slot axis 0
(``_batch_axis``); the audio family's ``cross_k`` / ``cross_v`` (L, S,
E, KV, dh) ride axis 1 like the causal K / V.  ``scatter_slot``, ``gather_slot`` and the serve
snapshots walk whatever leaves the cache holds, so the MLA pool rides
them as it is.  The port writes the slot in
place (the JAX package returns a new pool and donates the old one's
buffers).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map


def init_pool_cache(cfg: ModelConfig, n_slots: int, cache_len: int,
                    device=None, *, rt: Optional[T.Runtime] = None) -> dict:
    """A decode cache for S slots with PER-SLOT positions: identical to
    ``init_cache(cfg, batch=S, cache_len)`` except ``len`` is (S,).
    ``device`` defaults to ``cuda`` and raises without a GPU."""
    c = T.init_cache(cfg, n_slots, cache_len, device=device, rt=rt)
    c["len"] = torch.zeros((n_slots,), dtype=torch.int32,
                           device=c["len"].device)
    return c


def _batch_axis(name: str) -> int:
    """Hybrid tail blocks are unstacked (S, ...); every other leaf is
    layer-stacked (L, S, ...)."""
    return 0 if name == "tail" else 1


def scatter_slot(pool_cache: dict, req_cache: dict, slot: int) -> dict:
    """Write a prefilled single-request cache (batch axis of size 1) into
    slot ``slot`` of the pool, in place; returns the pool.  A request
    cache with a leaf that does not match the slot's shape raises
    ``RuntimeError`` and writes nothing, as the reference's
    ``dynamic_update_slice`` refuses it: a vlm prompt whose image + text
    outgrows ``cache_len`` (the engine's admission rule counts the text
    only, as the reference's does), a ring narrower than prefill's, or an
    audio request whose frame count is not the pool's ``encoder_seq_len``
    (the reference's ``dynamic_update_slice`` writes such a request into
    part of the slot instead)."""
    pairs = []
    for name, sub in pool_cache.items():
        if name != "len":
            ax = _batch_axis(name)
            pairs += [(name, d.select(ax, slot), s.select(ax, 0))
                      for d, s in zip(tree_leaves(sub),
                                      tree_leaves(req_cache[name]),
                                      strict=True)]
    for name, d, s in pairs:
        if d.shape != s.shape:
            raise RuntimeError(
                f"scatter_slot: the pool's slot holds {tuple(d.shape)} "
                f"({name}), the request's cache {tuple(s.shape)}: a prefill "
                f"longer than the pool's cache_len (an image + text prompt "
                f"past it), a ring of another width or another number of "
                f"encoder frames does not fit a slot")
    for _, d, s in pairs:
        d.copy_(s)
    pool_cache["len"][slot] = req_cache["len"].reshape(())
    return pool_cache


def gather_slot(pool_cache: dict, slot: int) -> dict:
    """Copy one slot back out as a single-request cache (test helper; the
    inverse of ``scatter_slot``)."""
    def take(ax):
        return lambda t: t.narrow(ax, slot, 1).clone()

    out = {name: tree_map(take(_batch_axis(name)), sub)
           for name, sub in pool_cache.items() if name != "len"}
    out["len"] = pool_cache["len"][slot].clone()
    return out


__all__ = ["init_pool_cache", "scatter_slot", "gather_slot"]
