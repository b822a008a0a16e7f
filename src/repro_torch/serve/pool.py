"""Slot-stacked decode cache pool.

The pool holds S request slots whose per-layer caches are stacked on the
slot axis, with one position per slot (``len`` (S,)) instead of the
single-batch scalar, as in ``repro.serve.pool``.  Admitting a request is a
scatter of its prefilled single-request cache into a free slot; the
in-flight slots are not touched.  Every cache leaf of the families the
port serves is layer-stacked (L, S, ...) -- dense K/V/pos, ssm h/conv --
so the slot axis is axis 1.  The port writes the slot in place (the JAX
package returns a new pool and donates the old one's buffers).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def init_pool_cache(cfg: ModelConfig, n_slots: int, cache_len: int,
                    device=None) -> dict:
    """A decode cache for S slots with PER-SLOT positions: identical to
    ``init_cache(cfg, batch=S, cache_len)`` except ``len`` is (S,).
    ``device`` defaults to ``cuda`` and raises without a GPU."""
    c = T.init_cache(cfg, n_slots, cache_len, device=device)
    c["len"] = torch.zeros((n_slots,), dtype=torch.int32,
                           device=c["len"].device)
    return c


def scatter_slot(pool_cache: dict, req_cache: dict, slot: int) -> dict:
    """Write a prefilled single-request cache (batch axis of size 1) into
    slot ``slot`` of the pool, in place; returns the pool."""
    for name, leaf in pool_cache.items():
        if name == "len":
            leaf[slot] = req_cache["len"].reshape(())
        else:
            leaf[:, slot] = req_cache[name][:, 0].to(leaf.dtype)
    return pool_cache


def gather_slot(pool_cache: dict, slot: int) -> dict:
    """Copy one slot back out as a single-request cache (test helper; the
    inverse of ``scatter_slot``)."""
    out = {name: leaf[:, slot:slot + 1].clone()
           for name, leaf in pool_cache.items() if name != "len"}
    out["len"] = pool_cache["len"][slot].clone()
    return out


__all__ = ["init_pool_cache", "scatter_slot", "gather_slot"]
