"""Federated LM training driver on the node-stacked round engine: the port
of ``repro.launch.train``.

K nodes fine-tune one language model with GeoLoRA / GeoDoRA side-cars
(``--method``): each local step is next-token cross-entropy plus
lambda (1 - CKA) of the node's anchor Gram against the consensus
(``--lambda-geo``, ``--anchors`` shared token sequences), and each round
closes with the server step (consensus Gram, LAP precision weights,
side-car average, optional FedAvgM with ``--server-momentum``).  It runs
on ``core.engine.RoundEngine``, the engine of ``core.federation.
Federation``: a round, or a block of M rounds (``--block-size M``), is one
CUDA-graph replay on the card and one readback.  ``--block-size auto``
times the second round's dispatch against the whole round and picks M so
host work stays under 5% of round time.  ``--warmup-rounds N`` turns on a
warmup + cosine LR over the global round counter the engine carries.
``--participation`` samples each round's cohort on the device (uniform,
precision, dropout) or runs the async buffered protocol, with the
reference's flags.

Each local step runs the trunk once over the rows of all K nodes, whose
side-cars ride a node axis (``lora_matmul``'s node axis): the task pass
over (K B, S) tokens, the anchor pass over the K copies of the anchors.
The data is ``SyntheticLMStream``, one numpy stream per node (seed 100 +
i, the reference's streams token for token), staged a block at a time by
``BlockStager``; every node reads round r's batch in round r, as the
reference hands it, whatever the cohort (``per_round_draws``).  The
next block is staged on the host while the card runs the current one
(``RoundEngine.submit_block``): one readback per block, after the
staging.  Weights and anchors are random, from torch generators seeded
from 0 (the JAX package's keys cannot be reproduced).

  PYTHONPATH=src python -m repro_torch.launch.train --arch fedmm-small \\
      --rounds 8 --block-size 4 --local-steps 4 --batch 8 --seq 128 \\
      --participation uniform --cohort-size 2

``--device cpu`` runs it on the CPU (the kernels' plain versions); the
default is ``cuda``.  ``--tiny`` shrinks the model for CPU runs.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import cka as cka_mod
from repro_torch.core import lora as lora_mod
from repro_torch.core import participation as part_mod
from repro_torch.core.engine import (EngineConfig, RoundEngine,
                                     auto_block_size, stack_nodes)
from repro_torch.core.federation import (layer_major, merge_params,
                                         per_node_ce, with_dora_terms)
from repro_torch.data.pipeline import BlockStager, SyntheticLMStream
from repro_torch.data.synthetic import stream
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.tree import tree_leaves, tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fedmm-small")
    ap.add_argument("--method", default="geodora",
                    choices=["geolora", "geodora", "fedavg_full"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)     # per node
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--anchors", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lambda-geo", type=float, default=1.0)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--block-size", default="1",
                    help="M rounds per replay (1 = per round; 'auto' times "
                         "the dispatch at startup and picks M for < 5%% "
                         "host work)")
    ap.add_argument("--server-momentum", type=float, default=None,
                    help="server-side FedOpt momentum on the averaged "
                         "side-cars (off when unset)")
    ap.add_argument("--participation", default="full",
                    choices=["full", "uniform", "precision", "dropout",
                             "async"],
                    help="per-round cohort sampling strategy ('async' "
                         "turns on the buffered staleness-aware protocol)")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="nodes sampled per round (uniform / precision)")
    ap.add_argument("--dropout-rate", type=float, default=0.25,
                    help="per-node straggler probability (dropout)")
    ap.add_argument("--participation-seed", type=int, default=0)
    ap.add_argument("--lag-dist", default="fixed",
                    choices=["fixed", "geometric"],
                    help="async: per-report lag distribution")
    ap.add_argument("--lag", type=int, default=1,
                    help="async: fixed lag in rounds")
    ap.add_argument("--lag-p", type=float, default=0.5,
                    help="async: geometric lag success probability")
    ap.add_argument("--max-lag", type=int, default=4,
                    help="async: lag draws are clipped to this many rounds")
    ap.add_argument("--crash-rate", type=float, default=0.0,
                    help="async: per-round crash probability")
    ap.add_argument("--rejoin-rate", type=float, default=0.5,
                    help="async: per-round rejoin probability")
    ap.add_argument("--transient-rate", type=float, default=0.0,
                    help="async: per-round transient non-report "
                         "probability")
    ap.add_argument("--staleness", default="poly",
                    choices=["poly", "cutoff"],
                    help="async: staleness schedule on report weights")
    ap.add_argument("--staleness-alpha", type=float, default=1.0,
                    help="async: exponent of the poly staleness schedule")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="async: reports older than this many rounds get "
                         "zero aggregation weight")
    ap.add_argument("--quarantine-norm", type=float, default=1e6,
                    help="async: reports with non-finite values or an "
                         "update norm above this are quarantined")
    ap.add_argument("--poison-nodes", default="",
                    help="async fault injection: comma-separated node ids "
                         "whose reports are corrupted to NaN on device")
    ap.add_argument("--warmup-rounds", type=int, default=0,
                    help="> 0 turns on warmup+cosine LR over global rounds")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the model for CPU smoke runs")
    ap.add_argument("--precision-weighting", action="store_true",
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def model_config(args) -> ModelConfig:
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=32, d_ff=256, vocab_size=512,
                        dtype="float32")
    return cfg


def make_plan(args) -> Optional[part_mod.ParticipationPlan]:
    poison = tuple(int(x) for x in args.poison_nodes.split(",")
                   if x.strip())
    return part_mod.normalize(part_mod.ParticipationPlan(
        strategy=args.participation, cohort_size=args.cohort_size,
        dropout_rate=args.dropout_rate, seed=args.participation_seed,
        lag_dist=args.lag_dist, lag=args.lag, lag_p=args.lag_p,
        max_lag=args.max_lag, crash_rate=args.crash_rate,
        rejoin_rate=args.rejoin_rate, transient_rate=args.transient_rate,
        staleness=args.staleness, staleness_alpha=args.staleness_alpha,
        max_staleness=args.max_staleness,
        quarantine_norm=args.quarantine_norm, poison_nodes=poison))


def _inputs(params: dict, tokens: torch.Tensor) -> dict:
    """(K, n, S) token ids of K nodes -> the trunk's batch of K n rows,
    node-major; a per-node embedding (``fedavg_full``) is gathered here."""
    k, n, s = tokens.shape
    emb = params["embed"]
    if emb.dim() == 2:
        return {"tokens": tokens.reshape(k * n, s)}
    node = torch.arange(k, device=tokens.device)[:, None, None]
    return {"inputs_embeds": emb[node, tokens.long()].reshape(
        k * n, s, emb.shape[-1])}


class LMStep:
    """The engine's local step for the LM: every node's step at once.  The
    gradient of the sum of the nodes' losses is each node's own (their
    side-cars are separate rows of the node axis); AdamW then steps each
    node on its own (per-node clip)."""

    def __init__(self, cfg: ModelConfig, frozen: dict, anchors: torch.Tensor,
                 opt: AdamW, lambda_geo: float, n_nodes: int):
        self.cfg, self.opt, self.lambda_geo = cfg, opt, lambda_geo
        self.frozen = with_dora_terms(frozen)
        #: the anchors once per node, (K, A, S), made before any capture; a
        #: compact cohort of c nodes reads the first c
        self.anchors = anchors.expand(n_nodes, *anchors.shape).contiguous()

    def __call__(self, trains, opts, gbar, statics, batch):
        (tr,), (op,), (b,) = trains, opts, batch
        live = tree_map(lambda t: None if t is None
                        else t.detach().requires_grad_(), tr)
        params = merge_params(layer_major(live), self.frozen)
        tokens, labels = b["tokens"], b["labels"]            # (K, B, S)
        k, n = tokens.shape[:2]
        logits, aux = T.forward(params, _inputs(params, tokens), self.cfg)
        task = per_node_ce(logits.reshape(k, -1, logits.shape[-1]),
                            labels.reshape(k, -1))
        pooled_a = T.pooled(params, _inputs(params, self.anchors[:k]),
                            self.cfg).reshape(k, self.anchors.shape[1], -1)
        geo = cka_mod.geo_alignment_loss(pooled_a, gbar)
        loss = task + self.lambda_geo * geo
        leaves = tree_leaves(live)
        grads = iter(torch.autograd.grad(loss.sum(), leaves))
        g = tree_map(lambda t: None if t is None else next(grads), live)
        new_tr, new_op = self.opt.update_stacked(g, op, tr)
        acc = (logits.argmax(-1).reshape(k, -1)
               == labels.reshape(k, -1)).float().mean(-1)
        return (new_tr,), (new_op,), {
            "task": task.detach(), "geo": geo.detach(), "acc": acc,
            "pooled": aux["pooled"].detach().reshape(k, n, -1),
            "pooled_a": pooled_a.detach()}


@dataclass
class Run:
    """What ``build`` makes: the engine, the live round state (updated in
    place), the plan with its sampler generator, the per-node streams and
    the bytes a node ships each round against the full model's."""
    cfg: ModelConfig
    device: torch.device
    engine: RoundEngine
    state: tuple                  # trains, opts, gbar, server_m[, part]
    plan: Any
    part_gen: Optional[torch.Generator]
    streams: List[Any]
    up_bytes: int
    full_bytes: int


def build(args, params: Optional[dict] = None,
          anchors: Optional[torch.Tensor] = None,
          cfg: Optional[ModelConfig] = None) -> Run:
    """The driver's state from ``args``: random weights and anchors from
    seed 0 unless ``params`` (the full tree, side-cars attached) and
    ``anchors`` ((A, S) token ids) are given -- how a test starts from the
    reference's; ``cfg`` replaces ``args``' model config."""
    dev = resolve_device(args.device)
    cfg = cfg or model_config(args)
    k = args.nodes
    if params is None:
        params = T.init_params(stream(dev, 0, "model"), cfg, device=dev)
        if args.method != "fedavg_full":
            spec = lora_mod.LoRASpec(rank=args.rank,
                                     dora=args.method == "geodora")
            params = lora_mod.attach_lora(stream(dev, 0, "lora"), params,
                                          spec)
    if args.method != "fedavg_full":
        mask = lora_mod.trainable_mask(params)
    else:
        mask = tree_map(lambda _: True, params)
    trainable, frozen = lora_mod.partition(params, mask)
    if anchors is None:
        anchors = torch.randint(0, cfg.vocab_size, (args.anchors, args.seq),
                                generator=stream(dev, 0, "anchors"),
                                device=dev, dtype=torch.int32)
    sched = (warmup_cosine(args.warmup_rounds, max(args.rounds, 1))
             if args.warmup_rounds > 0 else None)
    opt = AdamW(lr=args.lr, grad_clip=1.0, round_schedule=sched)
    plan = make_plan(args)

    # LM nodes have no node-local adapters: every trainable leaf ships and
    # every node has one width -- a single engine bucket
    node_train = stack_nodes([trainable] * k)
    engine = RoundEngine(
        EngineConfig(n_nodes=k, local_steps=args.local_steps,
                     aggregation=("precision" if args.precision_weighting
                                  else "uniform"),
                     server_momentum=args.server_momentum,
                     per_round_draws=True),
        LMStep(cfg, frozen, anchors, opt, args.lambda_geo, k),
        (lora_mod.shipped_mask(node_train),), device=dev)
    trains = (node_train,)
    state = (trains, (stack_nodes([opt.init(trainable)] * k),),
             torch.eye(args.anchors, device=dev),
             engine.init_server_state(trains))
    part_gen = None
    if plan is not None:
        part = part_mod.init_state(plan, k, dev)
        if part is not None:
            part_gen = part.pop("gen")
            if plan.strategy == "async":
                part = engine.init_async_state(trains, plan,
                                               gram_side=args.anchors)
        state += (part,)
    streams = [iter(SyntheticLMStream(cfg.vocab_size, args.seq, args.batch,
                                      seed=100 + i)) for i in range(k)]
    up_bytes = lora_mod.param_bytes(trainable) + args.anchors ** 2 * 4
    full_bytes = lora_mod.param_bytes(lora_mod.combine(trainable, frozen))
    return Run(cfg=cfg, device=dev, engine=engine, state=state, plan=plan,
               part_gen=part_gen, streams=streams, up_bytes=up_bytes,
               full_bytes=full_bytes)


class Trainer:
    """The round loop over a ``Run``: stages blocks, submits them, logs one
    line per round."""

    def __init__(self, run: Run, args):
        self.run, self.k = run, args.nodes
        self.stager = BlockStager(run.streams, args.local_steps, 1,
                                  run.device)
        #: every round's metrics, in order
        self.records: List[dict] = []
        self.t0 = time.time()

    def cohort(self, rec: dict) -> int:
        if "cohort_size" not in rec:
            return self.k
        return max(int(round(rec["cohort_size"])), 1)

    def task(self, rec: dict) -> float:
        return sum(rec["task"]) / self.cohort(rec)

    def log_round(self, rec: dict) -> None:
        run, k, c = self.run, self.k, self.cohort(rec)
        rnd = len(self.records)
        self.records.append(rec)
        cohort = f" cohort={c}/{k}" if "cohort_size" in rec else ""
        if "n_delivered" in rec:
            qs = [int(round(x)) for x in rec["quarantined"]]
            cohort += (f" delivered={rec['n_delivered']:.0f}"
                       + (f" quarantined={qs}" if any(qs) else ""))
        up, full = run.up_bytes, run.full_bytes
        print(f"round {rnd}: task={self.task(rec):.4f} "
              f"geo={sum(rec['geo']) / c:.4f} "
              f"xcka={rec['cross_node_cka']:.3f} "
              f"w={[round(x, 3) for x in rec['weights']]}{cohort} "
              f"uplink={up / 1e6:.3f}MB vs full {full / 1e6:.1f}MB "
              f"({100 * (1 - up / full):.2f}% saved) "
              f"[{time.time() - self.t0:.0f}s]", flush=True)

    def stage(self, m: int) -> tuple:
        """The next m rounds' batches (one bucket) and plan uniforms."""
        run = self.run
        uniforms = None
        if run.part_gen is not None:
            uniforms = torch.stack([part_mod.draw_uniforms(
                run.plan, run.part_gen, self.k) for _ in range(m)])
        return (self.stager.next_block(m),), uniforms

    def submit(self, m: int, staged: tuple, log: bool = True):
        batches, uniforms = staged
        return self.run.engine.submit_block(
            self.run.state, m, statics=(None,), batches=batches,
            tap=self.log_round if log else None, plan=self.run.plan,
            uniforms=uniforms)

    def train(self, rounds: int, block_size) -> float:
        """``rounds`` rounds in blocks of ``block_size`` (or "auto");
        returns the last round's task loss (0.0 for no rounds)."""
        left = rounds
        if left <= 0:
            return 0.0
        auto = str(block_size) == "auto"
        block = 1 if auto else int(block_size)
        last = None
        if auto:
            # round 0 pays the capture; round 1 times the dispatch (host
            # work) against the whole round, and M keeps host work < 5%
            last = self.submit(1, self.stage(1)).metrics()[-1]
            left -= 1
            if left > 0:
                staged = self.stage(1)
                t0 = time.perf_counter()
                res = self.submit(1, staged, log=False)
                t_dispatch = time.perf_counter() - t0
                last = res.metrics()[-1]
                t_round = time.perf_counter() - t0
                block = auto_block_size(t_dispatch, t_round)
                print(f"[auto] dispatch={t_dispatch * 1e3:.2f}ms "
                      f"round={t_round * 1e3:.2f}ms -> block size "
                      f"M={block}", flush=True)
                self.log_round(last)
                left -= 1
        staged = self.stage(min(block, left)) if left > 0 else None
        while left > 0:
            m = min(block, left)
            res = self.submit(m, staged)
            left -= m
            if left > 0:          # the host stages block N+1 meanwhile
                staged = self.stage(min(block, left))
            last = res.metrics()[-1]
        return self.task(last)


def main(argv=None) -> float:
    """Parse the flags, build the state and train; returns the last
    round's task loss."""
    args = parse_args(argv)
    return Trainer(build(args), args).train(args.rounds, args.block_size)


if __name__ == "__main__":
    main()
