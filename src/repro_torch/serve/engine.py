"""Continuous-batching decode engine over a slot-stacked cache pool.

The port of ``repro.serve.engine.ServeEngine`` for the dense and ssm
families:

  - the S request slots live in ONE device-resident cache pool
    (``serve.pool``) with per-slot positions, ``active`` / ``stopped``
    masks, per-slot token budgets and the last sampled token;
  - ``M = block_steps`` decode steps form one block: sampling, stop and
    budget accounting and the output guards (non-finite logits, runaway
    repetition) all run on the device, tokens gather into an (M, S)
    buffer, and the host reads back ONCE per block -- one packed tensor
    with the tokens, the emission mask and the stop and fault flags;
  - new requests are admitted between blocks: prefill (through the flash
    kernel, or the selective-scan kernel for ssm), first-token sampling
    and a scatter into a free slot, with no host readback;
  - stopped slots keep riding the batched step at a frozen position
    (``step_mask``), so no gather / compact is needed;
  - the host side -- deadlines, load shedding, the stall watchdog and the
    retry lane -- is the scheduler's, unchanged from the JAX package.

On the card, for the dense family, every decode step launches the
decode-attention kernel once per layer and every admission the flash
kernel once per layer; there is no other attention path.  For the ssm
family every admission launches the selective-scan kernel once per
layer, and a decode step's O(1) state update is plain PyTorch.
Greedy decoding is the parity target with the JAX engine;
``temperature > 0`` samples with ``torch.Generator``s seeded from
``ServeConfig.seed`` (JAX's PRNG draws other numbers).  Chaos
injection (``fault_plan``) and snapshot / resume are a later slice.

``naive_generate`` keeps the legacy per-token loop as the in-package
oracle: one step and one blocking argmax readback per token, batches run
head-of-line until every member finishes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve.pool import init_pool_cache, scatter_slot
from repro_torch.serve.scheduler import FifoScheduler, Request, RequestRecord


@dataclass(frozen=True)
class ServeConfig:
    """Serving engine knobs, as in the JAX package (which also has
    ``attn_backend``: on the card the port always runs its kernels).
    ``max_new_tokens`` counts ALL generated tokens including the one
    sampled from the prefill logits.  ``stop_token < 0`` disables early
    stopping.  ``temperature == 0`` is greedy.

    SLO / resilience knobs (None / 0 disables each): ``queue_cap``,
    ``ttft_deadline_s`` / ``deadline_s`` (relative to arrival),
    ``max_attempts`` admissions per request, ``retry_backoff_s``,
    ``stall_blocks`` zero-progress blocks before the watchdog reclaims a
    slot, ``guard_nonfinite`` (fault a slot on non-finite decode logits)
    and ``max_repeat`` consecutive identical tokens before a fault.
    """
    n_slots: int = 8
    cache_len: int = 128
    block_steps: int = 8
    max_new_tokens: int = 32
    stop_token: int = -1
    temperature: float = 0.0
    seed: int = 0
    queue_cap: Optional[int] = None
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    max_attempts: int = 2
    retry_backoff_s: float = 0.0
    stall_blocks: int = 0
    guard_nonfinite: bool = True
    max_repeat: int = 0


def _sample(logits: torch.Tensor, temperature: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """(S, V) logits -> (S,) int32 next tokens, on the device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


class ServeEngine:
    """Continuous-batching engine for the dense and ssm families.

    Usage::

        eng = ServeEngine(params, cfg, ServeConfig(n_slots=8))
        records = eng.serve(requests)        # scheduler.Request list
        records[rid].tokens                  # generated ids, stop incl.
        records[rid].state                   # terminal state

    ``device`` defaults to ``cuda`` and raises without a GPU; ``params``
    must already lie there.  ``eng.stats`` counts block dispatches,
    blocking host readbacks and admissions, with the JAX engine's keys
    (``request_reads`` stays 0: the port never blocks on one request's
    first token; ``snapshot_writes`` stays 0 until snapshots are ported).
    """

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig, *,
                 device=None):
        if scfg.n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got "
                             f"{scfg.n_slots}")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.state = self._init_state()
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        self.stats = {"block_dispatches": 0, "block_syncs": 0,
                      "block_tokens": 0, "admit_dispatches": 0,
                      "request_reads": 0, "faults_detected": 0,
                      "stalls_detected": 0, "snapshot_writes": 0}

    # ------------------------------------------------------------------
    def _init_state(self) -> dict:
        s, dev = self.scfg.n_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "cache": init_pool_cache(self.cfg, s, self.scfg.cache_len, dev),
            "active": torch.zeros((s,), dtype=torch.bool, device=dev),
            "stopped": torch.ones((s,), dtype=torch.bool, device=dev),
            "last_tok": torch.zeros((s, 1), **i32),
            "n_emitted": torch.zeros((s,), **i32),
            "max_new": torch.full((s,), self.scfg.max_new_tokens, **i32),
            # per-slot fault flags and consecutive-repeat run lengths
            "fault": torch.zeros((s,), dtype=torch.bool, device=dev),
            "rep_run": torch.zeros((s,), **i32),
        }

    def _admit(self, req: Request, slot: int, max_new: int) -> torch.Tensor:
        """Prefill + first-token sampling + slot scatter, all on the device;
        returns the first token as a device scalar (read lazily).  The
        slot's fault flag and repeat counter reset here; non-finite
        PREFILL logits set the flag at once, so the first block boundary
        retries instead of streaming garbage."""
        scfg, st = self.scfg, self.state
        tokens = torch.tensor(req.tokens, dtype=torch.int32,
                              device=self.device)[None]
        logits, req_cache = T.prefill(self.params, {"tokens": tokens},
                                      self.cfg, cache_len=scfg.cache_len)
        last = logits[:, -1, :]
        gen = None
        if scfg.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(
                (scfg.seed + 1) * 1_000_003 + req.rid)
        first = _sample(last, scfg.temperature, gen)[0]
        bad0 = (~torch.isfinite(last.float()).all() if scfg.guard_nonfinite
                else torch.zeros((), dtype=torch.bool, device=self.device))
        first_stopped = bad0 | (max_new <= 1)
        if scfg.stop_token >= 0:
            first_stopped = first_stopped | (first == scfg.stop_token)
        scatter_slot(st["cache"], req_cache, slot)
        st["active"][slot] = True
        st["stopped"][slot] = first_stopped
        st["last_tok"][slot, 0] = first
        st["n_emitted"][slot] = 1
        st["max_new"][slot] = max_new
        st["fault"][slot] = bad0
        st["rep_run"][slot] = 0
        return first

    def _block(self, cancel: torch.Tensor):
        """M decode steps with sampling, stop accounting and the output
        guards on the device.  ``cancel`` (S,) bool freezes
        deadline-expired slots.  Returns (tokens, emitted), both (M, S)."""
        scfg, st = self.scfg, self.state
        stop, max_rep = scfg.stop_token, scfg.max_repeat
        cache, last_tok = st["cache"], st["last_tok"]
        stopped, fault = st["stopped"] | cancel, st["fault"]
        n_emitted, rep_run = st["n_emitted"], st["rep_run"]
        toks, emitted = [], []
        for _ in range(scfg.block_steps):
            running = st["active"] & ~stopped
            logits, cache = T.decode_step_slots(
                self.params, cache, {"tokens": last_tok}, self.cfg,
                step_mask=running)
            lg = logits[:, 0, :]
            tok = _sample(lg, scfg.temperature, self._gen)
            # output guards: a tripped slot freezes and its token is never
            # emitted -- the host retries from the prompt instead
            if scfg.guard_nonfinite:
                bad = running & ~torch.isfinite(lg.float()).all(dim=-1)
            else:
                bad = torch.zeros_like(running)
            ok = running & ~bad
            same = tok == last_tok[:, 0]
            rep_run = torch.where(ok, torch.where(same, rep_run + 1, 0),
                                  rep_run)
            if max_rep > 0:
                bad = bad | (ok & (rep_run >= max_rep))
            good = running & ~bad
            tok = torch.where(good, tok, last_tok[:, 0])
            n_emitted = n_emitted + good.to(torch.int32)
            hit_stop = (tok == stop) if stop >= 0 else torch.zeros_like(good)
            exhausted = n_emitted >= st["max_new"]
            stopped = stopped | (good & (hit_stop | exhausted)) | bad
            fault = fault | bad
            last_tok = tok[:, None]
            toks.append(tok)
            emitted.append(good)
        st.update(cache=cache, last_tok=last_tok, stopped=stopped,
                  fault=fault, n_emitted=n_emitted, rep_run=rep_run)
        return torch.stack(toks), torch.stack(emitted)

    # ------------------------------------------------------------------
    def _admit_request(self, req: Request, rec: RequestRecord) -> None:
        scfg = self.scfg
        max_new = req.max_new if req.max_new is not None \
            else scfg.max_new_tokens
        if req.extras:
            raise NotImplementedError(
                f"request {req.rid} carries modality extras: the port "
                f"serves the token families (dense, ssm) only")
        need = len(req.tokens) + max_new + 1
        # a recurrent state has no length, so ssm has no cache-length limit
        if self.cfg.family != "ssm" and need > scfg.cache_len:
            raise ValueError(f"request {req.rid}: prompt+max_new {need} "
                             f"exceeds cache_len {scfg.cache_len}")
        first = self._admit(req, rec.slot, max_new)
        self.stats["admit_dispatches"] += 1
        rec.tokens.append(first)           # device scalar; resolved lazily

    def serve(self, requests: List[Request]) -> Dict[int, RequestRecord]:
        """Run a request stream to completion with continuous batching.

        Admission happens between decode blocks: arrived requests fill
        free slots (prefill + scatter), then one M-step block runs and its
        token buffer is read back -- the only blocking host sync in the
        decode path.  A request's first-token time is the end of the
        first block that reads its tokens back."""
        scfg = self.scfg
        sched = FifoScheduler(requests, scfg.n_slots,
                              queue_cap=scfg.queue_cap,
                              ttft_deadline_s=scfg.ttft_deadline_s,
                              deadline_s=scfg.deadline_s)
        stall = [0] * scfg.n_slots
        t0 = time.perf_counter()

        def now():
            return time.perf_counter() - t0

        while not sched.done:
            sched.shed_expired(now())
            while sched.admissible(now()):
                req, slot = sched.pop(now())
                stall[slot] = 0
                self._admit_request(req, sched.records[req.rid])
                # a request that stops at its first token never decodes
                if (req.max_new or scfg.max_new_tokens) <= 1:
                    rec = sched.records[req.rid]
                    if rec.first_token_s is None:
                        rec.first_token_s = now()
                    sched.release(slot, now())
            busy = [s for s, rid in enumerate(sched.slot_rid)
                    if rid is not None]
            if not busy:
                nr = sched.next_ready()
                if nr is None:
                    break
                wait = nr - now()
                if wait > 0:
                    time.sleep(wait)
                continue
            # watchdog, part 1: deadline-expired slots are cancelled ON
            # DEVICE by the block itself
            cancel = np.zeros((scfg.n_slots,), bool)
            t_check = now()
            for s in busy:
                if t_check > sched.abs_deadline(sched.slot_rid[s]):
                    cancel[s] = True
            toks, emitted = self._block(
                torch.from_numpy(cancel).to(self.device))
            self.stats["block_dispatches"] += 1
            # ONE readback per block: tokens, emission mask, stop and
            # fault flags, packed into one int32 tensor
            m = scfg.block_steps
            packed = torch.cat([toks, emitted.to(torch.int32),
                                self.state["stopped"][None].to(torch.int32),
                                self.state["fault"][None].to(torch.int32)]
                               ).cpu().numpy()
            self.stats["block_syncs"] += 1
            toks_h, emitted_h = packed[:m], packed[m:2 * m].astype(bool)
            stopped_h, fault_h = packed[2 * m].astype(bool), packed[2 * m + 1]
            t_block = now()
            for s in busy:
                rec = sched.records[sched.slot_rid[s]]
                if cancel[s]:
                    sched.release(s, t_block, state="timed_out")
                    continue
                new = toks_h[emitted_h[:, s], s]
                rec.tokens.extend(int(t) for t in new)
                self.stats["block_tokens"] += int(emitted_h[:, s].sum())
                if rec.first_token_s is None and len(rec.tokens) > 0:
                    rec.first_token_s = t_block
                if fault_h[s]:
                    rec.faults += 1
                    self.stats["faults_detected"] += 1
                    self._retry_or_fail(sched, s, t_block)
                elif stopped_h[s]:
                    sched.release(s, t_block)
                elif scfg.stall_blocks > 0 and not emitted_h[:, s].any():
                    # watchdog, part 2: a live slot that emitted nothing
                    stall[s] += 1
                    if stall[s] >= scfg.stall_blocks:
                        stall[s] = 0
                        self.stats["stalls_detected"] += 1
                        self._retry_or_fail(sched, s, t_block)
                else:
                    stall[s] = 0
        for rec in sched.records.values():      # resolve lazy first tokens
            rec.tokens = [int(t) for t in rec.tokens]
        return sched.records

    def _retry_or_fail(self, sched: FifoScheduler, slot: int,
                       now_s: float) -> None:
        """Reclaim a faulted/stuck slot: requeue with backoff while the
        attempt budget lasts, else terminal ``failed``."""
        rid = sched.slot_rid[slot]
        if sched.records[rid].attempts < self.scfg.max_attempts:
            sched.requeue(slot, now_s + self.scfg.retry_backoff_s)
        else:
            sched.release(slot, now_s, state="failed")


# ======================================================================
def naive_generate(params, cfg: ModelConfig, requests: List[Request],
                   scfg: ServeConfig,
                   stats: Optional[dict] = None) -> Dict[int, RequestRecord]:
    """The legacy per-token loop, kept as the oracle.

    Requests run in arrival order in fixed batches of ``n_slots`` (all
    prompts in a batch must share one length); every decoded token pays
    one step plus one blocking host readback (argmax and stop check on
    the host), and a batch runs until EVERY member finishes.  Each step is
    ``decode_step_slots`` with every slot at the same position.  Greedy
    only; runs on the device the params lie on."""
    stats = stats if stats is not None else {}
    for k in ("decode_dispatches", "host_syncs", "decode_tokens",
              "prefill_dispatches"):
        stats.setdefault(k, 0)
    dev = params["embed"].device
    records = {r.rid: RequestRecord(request=r) for r in requests}
    order = sorted(requests, key=lambda r: r.arrival_s)
    t0 = time.perf_counter()
    for i in range(0, len(order), scfg.n_slots):
        group = order[i:i + scfg.n_slots]
        plens = {len(r.tokens) for r in group}
        assert len(plens) == 1, "naive baseline needs equal prompt lengths"
        tokens = torch.tensor([r.tokens for r in group], dtype=torch.int32,
                              device=dev)
        logits, cache = T.prefill(params, {"tokens": tokens}, cfg,
                                  cache_len=scfg.cache_len)
        cache["len"] = cache["len"].expand(len(group)).contiguous()
        stats["prefill_dispatches"] += 1
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32).cpu()
        stats["host_syncs"] += 1
        t_first = time.perf_counter() - t0
        budgets = [r.max_new if r.max_new is not None
                   else scfg.max_new_tokens for r in group]
        outs = [[int(t)] for t in tok]
        done = [budgets[j] <= 1 or
                (scfg.stop_token >= 0 and int(tok[j]) == scfg.stop_token)
                for j in range(len(group))]
        for j, r in enumerate(group):
            records[r.rid].first_token_s = t_first
            records[r.rid].slot = j
        # head-of-line: the whole batch keeps stepping until ALL are done
        while not all(done):
            logits, cache = T.decode_step_slots(
                params, cache, {"tokens": tok[:, None].to(dev)}, cfg)
            stats["decode_dispatches"] += 1
            tok = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32).cpu()
            stats["host_syncs"] += 1
            for j in range(len(group)):
                if done[j]:
                    continue
                outs[j].append(int(tok[j]))
                stats["decode_tokens"] += 1
                if ((scfg.stop_token >= 0 and int(tok[j]) == scfg.stop_token)
                        or len(outs[j]) >= budgets[j]):
                    done[j] = True
        t_done = time.perf_counter() - t0
        for j, r in enumerate(group):
            records[r.rid].tokens = outs[j]
            records[r.rid].finished_s = t_done
            records[r.rid].state = "completed"
    return records


__all__ = ["ServeConfig", "ServeEngine", "naive_generate"]
