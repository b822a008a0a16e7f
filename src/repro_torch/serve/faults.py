"""Deterministic chaos injection for the serving engine: the port of
``repro.serve.faults``.

A :class:`FaultPlan` is a seeded fault schedule, the same dataclass as
the JAX package's (``seeded_plan`` draws the same plan from the same seed
with the stdlib ``random.Random``):

  - ``nan_steps`` poisons the decode logits of the chosen slots with NaN
    on the chosen GLOBAL decode-step indices -- the engine carries a
    step counter ``t`` in its state, so the schedule is deterministic
    across blocks, retries and a snapshot / resume (``t`` rides the
    snapshot);
  - ``force_steps`` biases the logits so one fixed token wins -- finite
    values, so only the runaway-repetition guard can catch it;
  - ``freeze_steps`` silently halts the chosen slots (no token emitted,
    no cache advance, NOT stopped): the stuck slot the host watchdog must
    notice;
  - ``delay_blocks`` + ``delay_s`` sleep the HOST before the chosen
    block indices;
  - ``crash_after_block`` raises :class:`SimulatedCrash` after the
    results of that block index have been consumed (and after any due
    snapshot).

Where the JAX package bakes the plan's tuples into the compiled block as
constants, the port turns them into tensors once, on the engine's device
and before any capture (:meth:`FaultPlan.on_device`): inside a captured
block a ``torch.tensor(plan.nan_steps)`` would be a host-to-device copy,
which a CUDA graph cannot hold.  ``poison_logits`` and ``freeze_mask``
then read only those tensors and the device-side step ``t``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


class SimulatedCrash(RuntimeError):
    """The fault plan killed the engine mid-stream.  The serve loop has
    already written any due snapshot; recover with
    ``ServeEngine.resume(path, ...)`` + ``resume_serve()``."""


@dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule.  Step fields index the engine's GLOBAL
    decode-step counter; block fields index dispatched decode blocks
    within one serve run.  Empty slot tuples mean "every slot"."""
    nan_steps: Tuple[int, ...] = ()
    nan_slots: Tuple[int, ...] = ()
    force_steps: Tuple[int, ...] = ()
    force_slots: Tuple[int, ...] = ()
    force_token: int = 0
    freeze_steps: Tuple[int, ...] = ()
    freeze_slots: Tuple[int, ...] = ()
    delay_blocks: Tuple[int, ...] = ()
    delay_s: float = 0.0
    crash_after_block: int = -1

    @property
    def device_silent(self) -> bool:
        """True when the plan injects nothing into the decode block
        (host-side delays / crash only): the engine then runs the
        fault-free block."""
        return not (self.nan_steps or self.force_steps or self.freeze_steps)

    def on_device(self, n_slots: int, vocab_size: int,
                  device) -> "DevicePlan":
        """The plan's steps, slot masks and forced logits row as tensors on
        ``device``, made once before any capture."""
        def steps(ts):
            return (torch.tensor(ts, dtype=torch.int32, device=device)
                    if ts else None)

        def mask(slots):
            m = torch.zeros((n_slots,), dtype=torch.bool)
            m[[s for s in slots if -n_slots <= s < n_slots]] = True
            return (m if slots else ~m).to(device)

        forced = None
        if self.force_steps:
            forced = torch.full((vocab_size,), -1e9)
            forced[self.force_token] = 1e9
            forced = forced.to(device)
        return DevicePlan(steps(self.nan_steps), mask(self.nan_slots),
                          steps(self.force_steps), mask(self.force_slots),
                          forced, steps(self.freeze_steps),
                          mask(self.freeze_slots))


@dataclass(frozen=True)
class DevicePlan:
    """A plan's device-side tensors (see :meth:`FaultPlan.on_device`);
    ``None`` where the plan has no such fault."""
    nan_steps: Optional[torch.Tensor]
    nan_mask: torch.Tensor
    force_steps: Optional[torch.Tensor]
    force_mask: torch.Tensor
    forced: Optional[torch.Tensor]        # (V,) f32: 1e9 at the token
    freeze_steps: Optional[torch.Tensor]
    freeze_mask: torch.Tensor


def seeded_plan(seed: int, *, n_steps: int, n_slots: int,
                nan_rate: float = 0.0, freeze_rate: float = 0.0,
                freeze_span: int = 2, delay_rate: float = 0.0,
                delay_s: float = 0.0,
                crash_after_block: int = -1) -> FaultPlan:
    """A deterministic seeded schedule over ``n_steps`` decode steps:
    each step is NaN-poisoned with ``nan_rate`` (one victim slot drawn
    per event), starts a ``freeze_span``-step freeze with
    ``freeze_rate``, and each block is host-delayed with
    ``delay_rate``."""
    rng = random.Random(seed)
    nan_steps, nan_slots = [], set()
    freeze_steps = []
    for t in range(n_steps):
        if nan_rate > 0 and rng.random() < nan_rate:
            nan_steps.append(t)
            nan_slots.add(rng.randrange(n_slots))
        if freeze_rate > 0 and rng.random() < freeze_rate:
            freeze_steps.extend(range(t, t + freeze_span))
    delay_blocks = tuple(b for b in range(max(1, n_steps))
                         if delay_rate > 0 and rng.random() < delay_rate)
    return FaultPlan(
        nan_steps=tuple(nan_steps), nan_slots=tuple(sorted(nan_slots)),
        freeze_steps=tuple(sorted(set(freeze_steps))),
        freeze_slots=tuple(sorted(nan_slots)) or (0,),
        delay_blocks=delay_blocks, delay_s=delay_s,
        crash_after_block=crash_after_block)


def device_key(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """What the decode block sees of ``plan``: None when there is none or
    it is device-silent, else the plan without its host-side fields.  The
    engine captures one graph per key."""
    if plan is None or plan.device_silent:
        return None
    return replace(plan, delay_blocks=(), delay_s=0.0, crash_after_block=-1)


def _step_hit(t: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """() bool: is the device-side global step ``t`` one of ``steps``?"""
    return (t == steps).any()


def poison_logits(plan: Optional[DevicePlan], t: torch.Tensor,
                  logits: torch.Tensor) -> torch.Tensor:
    """Apply the plan's logit faults at global step ``t`` to (S, V)
    decode logits (identity when the plan is None)."""
    if plan is None:
        return logits
    if plan.nan_steps is not None:
        mask = _step_hit(t, plan.nan_steps) & plan.nan_mask
        logits = torch.where(mask[:, None], float("nan"), logits)
    if plan.force_steps is not None:
        mask = _step_hit(t, plan.force_steps) & plan.force_mask
        logits = torch.where(mask[:, None], plan.forced.to(logits.dtype),
                             logits)
    return logits


def freeze_mask(plan: Optional[DevicePlan],
                t: torch.Tensor) -> Optional[torch.Tensor]:
    """(S,) bool mask of slots silently frozen at global step ``t`` (None
    when the plan never freezes)."""
    if plan is None or plan.freeze_steps is None:
        return None
    return _step_hit(t, plan.freeze_steps) & plan.freeze_mask


__all__ = ["FaultPlan", "DevicePlan", "SimulatedCrash", "seeded_plan",
           "device_key", "poison_logits", "freeze_mask"]
