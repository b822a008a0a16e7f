"""AdamW on partitioned parameter trees: the port of
``repro.optim.adamw.AdamW``.

``None`` leaves (frozen parameters under GeoLoRA) pass through untouched,
so moments exist only for the trainable side-cars.  The state is
``{"m", "v": f32 trees, "step": int32}`` (plus ``"round"`` with a
``round_schedule``), as in the JAX package, so states carry across with
``bridge.params_from_numpy``.  Updates are functional: they return new
tensors and leave their inputs as they were.  Every scalar stays a tensor
on the parameters' device, so a step never waits for the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


def _map(fn, *trees):
    return tree_map(lambda *xs: None if xs[0] is None else fn(*xs), *trees)


@dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    # global-round schedule: multiplier keyed on the state's "round"
    # counter, which the round driver bumps once per federated round
    round_schedule: Optional[Callable] = None    # round tensor -> multiplier

    def init(self, params) -> dict:
        dev = tree_leaves(params)[0].device
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        state = {"m": _map(zeros, params), "v": _map(zeros, params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.round_schedule is not None:
            state["round"] = torch.zeros((), dtype=torch.int32, device=dev)
        return state

    def update(self, grads, state: dict, params):
        return self._update(grads, state, params, lambda t, like: t,
                            lambda g: (g.float() ** 2).sum())

    def update_stacked(self, grads, state: dict, params):
        """``update`` for K nodes stacked on a leading axis of every leaf,
        each node on its own: the clip norm, ``step`` and ``round`` are per
        node ((K,) in the state), as under the reference's ``vmap``."""
        return self._update(
            grads, state, params,
            lambda t, like: t.reshape((-1,) + (1,) * (like.dim() - 1)),
            lambda g: (g.float() ** 2).flatten(1).sum(1))

    def _update(self, grads, state: dict, params, node, sq):
        """``node(t, like)``: a per-node value shaped to broadcast over
        ``like``; ``sq(g)``: the squared norm of a gradient, per node."""
        step = state["step"] + 1
        if self.grad_clip > 0:
            gnorm = torch.sqrt(sum(sq(g) for g in tree_leaves(grads)))
            scale = (self.grad_clip / (gnorm + 1e-9)).clamp(max=1.0)
            grads = _map(lambda g: g.float() * node(scale, g), grads)
        b1, b2 = self.b1, self.b2
        m = _map(lambda mm, g: b1 * mm + (1 - b1) * g.float(),
                 state["m"], grads)
        v = _map(lambda vv, g: b2 * vv + (1 - b2) * g.float().square(),
                 state["v"], grads)
        stepf = step.float()
        mhat_scale = 1.0 / (1 - b1 ** stepf)
        vhat_scale = 1.0 / (1 - b2 ** stepf)
        lr = self.lr
        if self.round_schedule is not None and "round" in state:
            lr = lr * self.round_schedule(state["round"])

        def upd(p, mm, vv):
            u = (mm * node(mhat_scale, mm)) / (
                torch.sqrt(vv * node(vhat_scale, vv)) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            lr_p = node(lr, p) if isinstance(lr, torch.Tensor) else lr
            return (p.float() - lr_p * u).to(p.dtype)

        new_state = {"m": m, "v": v, "step": step}
        if "round" in state:
            new_state["round"] = state["round"]
        return _map(upd, params, m, v), new_state


def warmup_cosine(warmup: int, total: int, floor: float = 0.1) -> Callable:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``: step tensor -> f32 multiplier (a
    ``round_schedule`` on the tensor round counter, read inside a
    captured round without a host sync)."""
    def sched(step):
        step = step.float()
        warm = step / max(warmup, 1)
        prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return sched


__all__ = ["AdamW", "warmup_cosine"]
