"""Continuous-batching decode engine over a slot-stacked cache pool.

The port of ``repro.serve.engine.ServeEngine`` for the dense (with its
sliding-window variant, ``rt=Runtime(window_override=)``), vlm (a
request's ``extras`` -- ``image_embeds`` (n_img, image_embed_dim) --
join its prefill batch), moe
(Llama-4-Scout: MoE FFN, chunked attention; DeepSeek-V2: MoE FFN and
MLA over a compressed latent pool), ssm, hybrid and audio (Whisper: a
request's ``enc_embeds`` (encoder_seq_len, encoder_embed_dim) extras run
the encoder at admission; the slot holds the causal K / V and the
encoder's cross K / V, a request with another frame count fails at the
scatter) families:

  - the S request slots live in ONE device-resident cache pool
    (``serve.pool``) with per-slot positions, ``active`` / ``stopped``
    masks, per-slot token budgets, the last sampled token, per-slot fault
    flags and repeat runs, and the GLOBAL decode-step counter ``t`` the
    chaos schedule indexes;
  - ``M = block_steps`` decode steps form one block: sampling, stop and
    budget accounting and the output guards (non-finite logits, runaway
    repetition) all run on the device, and the host reads back ONCE per
    block -- one packed tensor with the tokens, the emission mask and the
    stop and fault flags;
  - new requests are admitted between blocks: prefill (through the flash
    kernel, the selective-scan kernel for ssm, both for hybrid),
    first-token sampling and a scatter into a free slot, with no host
    readback;
  - stopped slots keep riding the batched step at a frozen position
    (``step_mask``), so no gather / compact is needed;
  - the host side -- deadlines, load shedding, the stall watchdog and the
    retry lane -- is the scheduler's, unchanged from the JAX package;
  - chaos injection (``serve(fault_plan=)``, ``serve.faults``) and serve
    snapshots (``snapshot`` / ``resume`` / ``resume_serve``) in the JAX
    package's checkpoint format, so a greedy snapshot of either package
    resumes in the other.

On the card the block is ONE CUDA-graph replay, the counterpart of the
reference's jitted ``_block_impl`` (``repro_torch.graphs`` captures it).
One graph is captured per device-visible fault plan (``None`` for a clean
or host-only plan), after one warm-up run with the state restored; the
block writes every carried tensor back into the state's own tensors
(``copy_``), so eager admission and the replays read and write the same
buffers.  Per-block inputs go through static buffers copied before the
replay: the cancel mask, and at ``temperature > 0`` M x S uniforms drawn
from the engine's ``torch.Generator`` (staged rather than
``CUDAGraph.register_generator_state``, so the CPU and the card sample
by the same inverse-CDF rule from the same kind of draws, and a snapshot
carries the sampler as one generator state).  Admission stays eager:
prompt lengths vary.  ``ServeEngine(..., eager=True)`` runs the same
block without the graph (the replay's oracle); on the CPU the block
always runs eagerly (the tests' path).  A capture that fails raises.

For the dense, vlm and moe families every decode step launches the
decode-attention kernel once per layer and every admission the flash
kernel once per layer (the moe family's experts are ``torch.matmul``
products, as in the reference, and launch no kernel of the port); under
MLA (DeepSeek-V2) every admission launches the flash kernel once per
layer at q.k 192 / v 128 and every decode step the ``mla_decode`` kernel
once per layer, and no decode-attention kernel; for
the ssm family every admission launches the selective-scan
kernel once per layer, and a decode step's O(1) state update is plain
PyTorch; for the hybrid family every admission launches the flash kernel
once per attention block and the scan once per recurrent block, and every
decode step the decode kernel once per attention block; for the audio
family every admission launches the flash kernel three times a decoder
layer's worth -- once per encoder layer (full mask), once per decoder
layer causal and once per decoder layer across (full mask) -- and every
decode step the decode kernel twice per decoder layer (causal, then
cross with every frame visible).  Greedy decoding is the parity target with the JAX engine;
``temperature > 0`` samples from ``torch.Generator``s seeded from
``ServeConfig.seed`` (JAX's PRNG draws other numbers).

``naive_generate`` keeps the legacy per-token loop as the in-package
oracle: one step and one blocking argmax readback per token, batches run
head-of-line until every member finishes.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs
from repro_torch import resolve_device
from repro_torch.checkpoint import (jax_key_layout, load_checkpoint,
                                   read_meta, save_checkpoint)
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve import faults as F
from repro_torch.serve.pool import init_pool_cache, scatter_slot
from repro_torch.serve.scheduler import FifoScheduler, Request, RequestRecord
from repro_torch.tree import copy_into, tree_leaves


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
            u: Optional[torch.Tensor]) -> torch.Tensor:
    """(S, V) logits -> (S,) int32 next tokens, on the device.  At
    ``temperature > 0`` each row is drawn by inverse CDF from its uniform
    in ``u`` (S,).  A row holding a non-finite logit is sampled from a
    zero stand-in instead (a NaN row would make the CDF undefined): the
    guard reads the raw logits, so its token is never emitted."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float()
    lg = torch.where(torch.isfinite(lg).all(dim=-1, keepdim=True), lg, 0.0)
    cdf = torch.softmax(lg / temperature, dim=-1).cumsum(dim=-1)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    return idx[:, 0].clamp(max=logits.shape[-1] - 1).to(torch.int32)


class ServeEngine:
    """Continuous-batching engine for the dense, vlm, moe, ssm, hybrid and
    audio families.

    Usage::

        eng = ServeEngine(params, cfg, ServeConfig(n_slots=8))
        records = eng.serve(requests)        # scheduler.Request list
        records[rid].tokens                  # generated ids, stop incl.
        records[rid].state                   # terminal state

        eng.serve(requests, fault_plan=seeded_plan(...),
                  snapshot_path="serve.npz", snapshot_every_blocks=1)
        eng = ServeEngine.resume("serve.npz", params, cfg)
        records = eng.resume_serve()         # after a crash

    ``device`` defaults to ``cuda`` and raises without a GPU; ``params``
    must already lie there.  ``rt`` is the model's ``Runtime`` (its
    ``window_override`` serves the dense family's sliding-window variant).
    ``eager`` runs the decode block without its CUDA graph.  ``eng.stats`` counts block dispatches, blocking host
    readbacks, admissions, per-request first-token reads (``sync_ttft``),
    detected faults and stalls and snapshot writes, with the JAX engine's
    keys; ``eng.graph_stats`` counts captures, their seconds and replays.
    """

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig, *,
                 rt: Optional[T.Runtime] = None, device=None,
                 eager: bool = False):
        if scfg.n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got "
                             f"{scfg.n_slots}")
        if cfg.sliding_window:
            eff = min(scfg.cache_len, cfg.sliding_window)
            if eff < cfg.sliding_window:
                raise ValueError(
                    f"cache_len {scfg.cache_len} smaller than the sliding "
                    f"window {cfg.sliding_window}: the pool ring would not "
                    f"match prefill's ring packing")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.rt = rt or T.Runtime()
        self.eager = eager
        self.state = self._init_state()
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        # the block's per-call inputs: static buffers a graph reads
        self._cancel = torch.zeros((scfg.n_slots,), dtype=torch.bool,
                                   device=self.device)
        self._unif = torch.zeros((scfg.block_steps, scfg.n_slots),
                                 dtype=torch.float32, device=self.device)
        self._plans: Dict[Optional[F.FaultPlan], F.DevicePlan] = {}
        self._graphs: Dict[Optional[F.FaultPlan], graphs.Captured] = {}
        self._resume_sched: Optional[FifoScheduler] = None
        self._sched: Optional[FifoScheduler] = None
        self._blocks_done = 0
        self.stats = {"block_dispatches": 0, "block_syncs": 0,
                      "block_tokens": 0, "admit_dispatches": 0,
                      "request_reads": 0, "faults_detected": 0,
                      "stalls_detected": 0, "snapshot_writes": 0}
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}

    # ------------------------------------------------------------------
    def _init_state(self) -> dict:
        s, dev = self.scfg.n_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "cache": init_pool_cache(self.cfg, s, self.scfg.cache_len, dev,
                                     rt=self.rt),
            "active": torch.zeros((s,), dtype=torch.bool, device=dev),
            "stopped": torch.ones((s,), dtype=torch.bool, device=dev),
            "last_tok": torch.zeros((s, 1), **i32),
            "n_emitted": torch.zeros((s,), **i32),
            "max_new": torch.full((s,), self.scfg.max_new_tokens, **i32),
            # per-slot fault flags and consecutive-repeat run lengths, and
            # the GLOBAL decode-step counter the chaos schedule indexes
            "fault": torch.zeros((s,), dtype=torch.bool, device=dev),
            "rep_run": torch.zeros((s,), **i32),
            "t": torch.zeros((), **i32),
        }

    def _admit(self, req: Request, slot: int, max_new: int) -> torch.Tensor:
        """Prefill + first-token sampling + slot scatter, all on the device
        and in place; returns the first token as a device scalar (read
        lazily).  The slot's fault flag and repeat counter reset here;
        non-finite PREFILL logits set the flag at once, so the first block
        boundary retries instead of streaming garbage."""
        scfg, st, dev = self.scfg, self.state, self.device
        batch = {"tokens": torch.tensor(req.tokens, dtype=torch.int32,
                                        device=dev)[None]}
        for name, arr in req.extras:          # e.g. a vlm's image_embeds
            batch[name] = torch.as_tensor(arr, device=dev)[None]
        logits, req_cache = T.prefill(self.params, batch, self.cfg,
                                      cache_len=scfg.cache_len, rt=self.rt)
        last = logits[:, -1, :]
        u = None
        if scfg.temperature > 0:
            gen = torch.Generator(device=dev).manual_seed(
                (scfg.seed + 1) * 1_000_003 + req.rid)
            u = torch.rand((1,), generator=gen, device=dev)
        first = _sample(last, scfg.temperature, u)[0]
        bad0 = (~torch.isfinite(last.float()).all() if scfg.guard_nonfinite
                else torch.zeros((), dtype=torch.bool, device=dev))
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

    def _block(self, plan: Optional[F.DevicePlan]) -> torch.Tensor:
        """M decode steps with sampling, stop accounting, the output guards
        and the chaos plan on the device.  Reads the cancel mask and the
        staged uniforms from their buffers, writes every carried tensor
        back into the state in place, and returns the packed (2M + 2, S)
        int32 result: tokens, emission mask, stopped and fault flags."""
        scfg, st = self.scfg, self.state
        stop, max_rep = scfg.stop_token, scfg.max_repeat
        cache, last_tok = st["cache"], st["last_tok"]
        stopped, fault = st["stopped"] | self._cancel, st["fault"]
        n_emitted, rep_run, t = st["n_emitted"], st["rep_run"], st["t"]
        toks, emitted = [], []
        for i in range(scfg.block_steps):
            running = st["active"] & ~stopped
            frozen = F.freeze_mask(plan, t)
            if frozen is not None:
                running = running & ~frozen
            logits, cache = T.decode_step_slots(
                self.params, cache, {"tokens": last_tok}, self.cfg,
                rt=self.rt, step_mask=running)
            lg = F.poison_logits(plan, t, logits[:, 0, :])
            tok = _sample(lg, scfg.temperature, self._unif[i])
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
            t = t + 1
            toks.append(tok)
            emitted.append(good)
        st["cache"]["len"].copy_(cache["len"])
        for name, new in (("last_tok", last_tok), ("stopped", stopped),
                          ("fault", fault), ("n_emitted", n_emitted),
                          ("rep_run", rep_run), ("t", t)):
            st[name].copy_(new)
        return torch.cat([torch.stack(toks),
                          torch.stack(emitted).to(torch.int32),
                          stopped[None].to(torch.int32),
                          fault[None].to(torch.int32)])

    # ---- the block as a CUDA graph ------------------------------------
    def _device_plan(self, key: Optional[F.FaultPlan]
                     ) -> Optional[F.DevicePlan]:
        if key is None:
            return None
        if key not in self._plans:
            self._plans[key] = key.on_device(self.scfg.n_slots,
                                             self.cfg.vocab_size, self.device)
        return self._plans[key]

    def capture(self, fault_plan: Optional[F.FaultPlan] = None
                ) -> graphs.Captured:
        """Capture the decode block for ``fault_plan``'s device-visible
        faults (``graphs.capture``: one warm-up run, the state restored
        after it, then the capture).  ``serve`` captures on first use; call
        this first to keep the capture out of a timed or counted window.
        Raises if the capture fails."""
        if self.device.type != "cuda":
            raise ValueError(f"capture: the decode block is captured on "
                             f"cuda; this engine runs on {self.device}")
        key = F.device_key(fault_plan)
        plan = self._device_plan(key)

        def run():
            with torch.no_grad():
                return self._block(plan)

        t0 = time.perf_counter()
        self._graphs[key] = graphs.capture(run, tree_leaves(self.state))
        torch.cuda.synchronize(self.device)
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        return self._graphs[key]

    def _run_block(self, fault_plan: Optional[F.FaultPlan],
                   cancel: np.ndarray) -> np.ndarray:
        """One block, read back once; returns the packed result on the
        host."""
        self._cancel.copy_(torch.from_numpy(cancel))
        if self.scfg.temperature > 0:
            self._unif.uniform_(generator=self._gen)
        key = F.device_key(fault_plan)
        if self.device.type == "cuda" and not self.eager:
            entry = self._graphs.get(key) or self.capture(fault_plan)
            out = entry.replay()
            self.graph_stats["replays"] += 1
        else:
            with torch.no_grad():
                out = self._block(self._device_plan(key))
        self.stats["block_dispatches"] += 1
        packed = out.cpu().numpy()
        self.stats["block_syncs"] += 1
        return packed

    # ------------------------------------------------------------------
    def _admit_request(self, req: Request, rec: RequestRecord,
                       sync_ttft: bool, now) -> None:
        scfg = self.scfg
        max_new = req.max_new if req.max_new is not None \
            else scfg.max_new_tokens
        # the reference's rule: a recurrent state has no length and a ring
        # overwrites itself, so ssm and a configured sliding window have
        # no cache-length limit.  It counts the text only: a vlm request's
        # image positions may take its decode past cache_len (writes then
        # land at C - 1, as in the reference), and an image + text prompt
        # longer than cache_len fails at the scatter
        if not self.cfg.sliding_window and self.cfg.family != "ssm":
            need = len(req.tokens) + max_new + 1
            if need > scfg.cache_len:
                raise ValueError(f"request {req.rid}: prompt+max_new "
                                 f"{need} exceeds cache_len "
                                 f"{scfg.cache_len}")
        first = self._admit(req, rec.slot, max_new)
        self.stats["admit_dispatches"] += 1
        rec.tokens.append(first)           # device scalar; resolved lazily
        if sync_ttft:
            first.item()
            self.stats["request_reads"] += 1
            rec.first_token_s = now()

    def serve(self, requests: List[Request], *, sync_ttft: bool = False,
              fault_plan: Optional[F.FaultPlan] = None,
              snapshot_path: Optional[str] = None,
              snapshot_every_blocks: int = 0) -> Dict[int, RequestRecord]:
        """Run a request stream to completion with continuous batching.

        Admission happens between decode blocks: arrived requests fill
        free slots (prefill + scatter), then one M-step block runs and its
        packed result is read back -- the only blocking host sync in the
        decode path.  A request's first-token time is the end of the
        first block that reads its tokens back; with ``sync_ttft`` the
        engine instead blocks on each request's first token at admission
        (one read per request, counted in ``request_reads``).

        ``fault_plan`` injects the chaos schedule (``serve.faults``);
        ``snapshot_path`` + ``snapshot_every_blocks=N`` write a serve
        snapshot every N blocks, so a crash -- real or simulated -- loses
        at most N blocks of decode work."""
        scfg = self.scfg
        sched = FifoScheduler(requests, scfg.n_slots,
                              queue_cap=scfg.queue_cap,
                              ttft_deadline_s=scfg.ttft_deadline_s,
                              deadline_s=scfg.deadline_s)
        # block indices are per stream; only resume_serve continues a
        # restored count (host delays and crashes index it)
        self._blocks_done = 0
        return self._run(sched, sync_ttft=sync_ttft, fault_plan=fault_plan,
                         snapshot_path=snapshot_path,
                         snapshot_every_blocks=snapshot_every_blocks)

    def resume_serve(self, *, sync_ttft: bool = False,
                     fault_plan: Optional[F.FaultPlan] = None,
                     snapshot_path: Optional[str] = None,
                     snapshot_every_blocks: int = 0
                     ) -> Dict[int, RequestRecord]:
        """Continue the stream restored by :meth:`resume`: unfinished
        requests run to a terminal state (already-admitted slots resume
        from the snapshot's device state).  Wall-clock SLO timestamps
        restart from the resume instant."""
        if self._resume_sched is None:
            raise RuntimeError("no restored stream: construct the engine "
                               "with ServeEngine.resume(path, ...) first")
        sched, self._resume_sched = self._resume_sched, None
        return self._run(sched, sync_ttft=sync_ttft, fault_plan=fault_plan,
                         snapshot_path=snapshot_path,
                         snapshot_every_blocks=snapshot_every_blocks)

    def _run(self, sched: FifoScheduler, *, sync_ttft: bool,
             fault_plan: Optional[F.FaultPlan],
             snapshot_path: Optional[str],
             snapshot_every_blocks: int) -> Dict[int, RequestRecord]:
        scfg = self.scfg
        self._sched = sched
        stall = [0] * scfg.n_slots
        t0 = time.perf_counter()

        def now():
            return time.perf_counter() - t0

        while not sched.done:
            sched.shed_expired(now())
            while sched.admissible(now()):
                req, slot = sched.pop(now())
                stall[slot] = 0
                self._admit_request(req, sched.records[req.rid], sync_ttft,
                                    now)
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
            if (fault_plan is not None and fault_plan.delay_s > 0
                    and self._blocks_done in fault_plan.delay_blocks):
                time.sleep(fault_plan.delay_s)
            # watchdog, part 1: deadline-expired slots are cancelled ON
            # DEVICE by the block itself
            cancel = np.zeros((scfg.n_slots,), bool)
            t_check = now()
            for s in busy:
                if t_check > sched.abs_deadline(sched.slot_rid[s]):
                    cancel[s] = True
            packed = self._run_block(fault_plan, cancel)
            m = scfg.block_steps
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
            self._blocks_done += 1
            if (snapshot_path and snapshot_every_blocks > 0
                    and self._blocks_done % snapshot_every_blocks == 0):
                self.snapshot(snapshot_path, sched)
            if (fault_plan is not None
                    and fault_plan.crash_after_block >= 0
                    and self._blocks_done - 1
                    == fault_plan.crash_after_block):
                raise F.SimulatedCrash(
                    f"fault plan killed the engine after block "
                    f"{fault_plan.crash_after_block}"
                    + (f"; resume from {snapshot_path!r}"
                       if snapshot_path else ""))
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

    # ----------------------------------------------------- persistence
    def _snapshot_tree(self) -> dict:
        """The state under the reference's leaf names, shapes and dtypes,
        with the JAX PRNG key's layout as ``key``."""
        return dict(self.state, key=jax_key_layout(self.scfg.seed))

    def snapshot(self, path: str,
                 sched: Optional[FifoScheduler] = None) -> None:
        """Write the full serve state in the JAX package's checkpoint
        format: the device pool (cache, per-slot positions, budgets, fault
        flags, global step counter) as the tree, the scheduler and
        ``ServeConfig`` in the JSON meta, and the port's sampler state
        under ``torch_sampler`` (a key the JAX package ignores).  Atomic:
        a crash mid-save never corrupts the previous snapshot."""
        sched = sched if sched is not None else self._sched
        for rec in sched.records.values():      # resolve lazy device scalars
            rec.tokens = [int(t) for t in rec.tokens]
        meta = {
            "kind": "serve_snapshot",
            "serve_config": dataclasses.asdict(self.scfg),
            "model_family": self.cfg.family,
            "scheduler": sched.to_meta(),
            "blocks_done": self._blocks_done,
            "torch_sampler": {"device": self.device.type,
                              "state": self._gen.get_state().tolist()},
        }
        save_checkpoint(path, self._snapshot_tree(), step=self._blocks_done,
                        meta=meta)
        self.stats["snapshot_writes"] += 1

    @classmethod
    def resume(cls, path: str, params, cfg: ModelConfig, *,
               rt: Optional[T.Runtime] = None,
               device=None) -> "ServeEngine":
        """Rebuild an engine from a serve snapshot of either package
        (``CheckpointError`` on a truncated/corrupt file, ``ValueError`` on
        a snapshot from another kind or model family).  The JAX package's
        ``attn_backend`` and PRNG ``key`` are dropped; the port's sampler
        state continues where it was written on the same device type (a
        snapshot without it, or from another device type, restarts the
        sampler from the seed).  Follow with :meth:`resume_serve`."""
        meta = read_meta(path)
        if meta.get("kind") != "serve_snapshot":
            raise ValueError(f"{path!r} is not a serve snapshot "
                             f"(kind={meta.get('kind')!r})")
        if meta["model_family"] != cfg.family:
            raise ValueError(
                f"snapshot {path!r} was taken from a {meta['model_family']!r}"
                f" model, cannot restore into {cfg.family!r}")
        scfg = ServeConfig(**{k: v for k, v in meta["serve_config"].items()
                              if k != "attn_backend"})
        eng = cls(params, cfg, scfg, rt=rt, device=device)
        tree, step = load_checkpoint(path, eng._snapshot_tree())
        del tree["key"]
        copy_into(eng.state, tree)
        eng._blocks_done = int(step)
        eng._resume_sched = FifoScheduler.from_meta(meta["scheduler"])
        sampler = meta.get("torch_sampler")
        if sampler and sampler["device"] == eng.device.type:
            eng._gen.set_state(torch.tensor(sampler["state"],
                                            dtype=torch.uint8))
        return eng


# ======================================================================
def naive_generate(params, cfg: ModelConfig, requests: List[Request],
                   scfg: ServeConfig, rt: Optional[T.Runtime] = None,
                   stats: Optional[dict] = None) -> Dict[int, RequestRecord]:
    """The legacy per-token loop, kept as the oracle.

    Requests run in arrival order in fixed batches of ``n_slots`` (all
    prompts in a batch must share one length); every decoded token pays
    one step plus one blocking host readback (argmax and stop check on
    the host), and a batch runs until EVERY member finishes.  Each step is
    ``decode_step_slots`` with every slot at the same position.  The
    members' ``extras`` (one shape a name across the batch) are stacked
    into the prefill batch, as the engine puts each request's into its
    own.  Greedy only; runs on the device the params lie on."""
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
        batch = {"tokens": torch.tensor([r.tokens for r in group],
                                        dtype=torch.int32, device=dev)}
        for name, _ in group[0].extras:
            batch[name] = torch.stack([
                torch.as_tensor(dict(r.extras)[name], device=dev)
                for r in group])
        logits, cache = T.prefill(params, batch, cfg,
                                  cache_len=scfg.cache_len, rt=rt)
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
                params, cache, {"tokens": tok[:, None].to(dev)}, cfg, rt=rt)
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
