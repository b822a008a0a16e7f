"""Federated rounds for unpaired multimodal data, the paper's protocol: the
port of ``repro.core.federation.SequentialFederation``.

Per round, each node k (one modality, private data):
  1. runs local AdamW steps on L_task + lambda (1 - CKA(G_k, G_bar))
     (Eq. 3), training only the GeoLoRA ``lora_B`` / GeoDoRA ``dora_m`` /
     shared-head leaves and its local adapter W_mk; under GeoDoRA the
     geometric loss sees ``dora_m`` detached, so it constrains direction
     only; a bridge node adds an InfoNCE term between its two paired
     modalities;
  2. uploads its anchor Gram G_k (Eq. 1), its LAP precision p_k (Eq. 6)
     and its shipped side-cars;
  3. the server averages the Grams into G_bar, normalises the
     precisions into weights, averages the side-cars with them (Eqs. 4-5)
     and broadcasts.

On the card every GeoLoRA linear runs the ``lora_matmul`` kernel (forward
and input gradient), every attention the flash kernel, every Gram the
``gram`` kernel.  Random numbers come from ``torch.Generator``s seeded
from ``fed.seed`` and stable names (``data.synthetic.stream``): the JAX
streams cannot be reproduced, so a parity test carries the reference's
state across (``bridge.load_federation_state``) and replaces ``_draw``,
the per-step batch draw, with the reference's draws.  A round reads the
device once, for its record.

``Federation`` is the node-stacked twin on ``core.engine.RoundEngine``: the
same protocol with the K nodes stacked per width bucket, a round (and a
block of M rounds) one CUDA-graph replay on the card.

Both run participation plans (``core.participation``: sampled cohorts,
straggler masks and the async buffered server step); the sequential
round is the oracle of the engine's, with the same cohort and event
streams from the same plan seed.

Checkpoints are the JAX package's files (``checkpoint/``) with its leaf
set, so they load in either package: ``SequentialFederation`` saves the
consensus Gram and each node's trainables, AdamW state and key;
``Federation`` the bucketed engine state (``gbar``, ``train``, ``opt``,
``keys`` per bucket, ``server_m`` with server momentum, ``part`` under a
plan) with the reference's meta.  The port draws with torch generators,
not JAX keys: it writes ``keys`` (and the sampler's ``key``) in the JAX
layout and never reads them back, and it keeps every generator's state
in the meta under ``torch_generators``, a key the JAX package ignores.
A file without that state (the JAX package's, or one written on another
device type) restarts the generators from their construction seeds, so
the two packages cannot resume each other's random streams.
``Federation.restore`` writes into the live state tensors, so every
captured graph stays valid.  ``run_rounds(checkpoint_path=)`` writes
in-block checkpoints by splitting each block at its checkpoint rounds
(``core.engine``'s module docstring says why).

``Federation(mesh=)`` runs one process per device (``launch/mesh.py``):
each rank stacks only its own rows of every bucket, on its own device,
draws only its own nodes' data from their generators, and runs the
engine's sharded round, whose server step is the collectives of the
protocol's uplink; every rank returns the same history.  Every rank builds
every node first, as the single-device federation does (the per-node
side-cars and adapters are small; the frozen base is shared), and keeps
its rows.  ``nodes``, ``node_params``, ``save`` and ``restore`` are then
collective -- every rank calls them: the node views gather the stacks,
``save`` gathers the state and the generators to rank 0, which writes the
file the single-device federation writes for the same bucket layout, and
``restore`` reads the file on every rank and keeps the rank's rows.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import (jax_key_layout, load_checkpoint,
                                   read_meta, save_checkpoint)
from repro_torch.configs import ModelConfig, get_config
from repro_torch.configs.fedmm_base import MODALITY_TOKENIZER_DIMS
from repro_torch.core import aggregation as agg
from repro_torch.core import cka as cka_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import lora as lora_mod
from repro_torch.core import participation as part_mod
from repro_torch.core import uncertainty as unc
from repro_torch.data.synthetic import SyntheticMultimodal, stream
from repro_torch.data.tokenizers import default_tokenizers
from repro_torch.models import transformer as T
from repro_torch.models.common import (cross_entropy_loss, dora_w_terms,
                                       linear, make_linear)
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import copy_into, tree_leaves, tree_map

METHODS = ("geolora", "geodora", "fedavg_full")


@dataclass(frozen=True)
class FederationConfig:
    n_nodes: int = 4
    modalities: Tuple[str, ...] = ("image", "text", "genetics", "tabular")
    method: str = "geolora"            # geolora | geodora | fedavg_full
    aggregation: str = "precision"     # precision | uniform
    lora_rank: int = 8
    lambda_geo: float = 1.0
    rounds: int = 5
    local_steps: int = 10
    local_batch: int = 32
    lr: float = 3e-3
    n_classes: int = 8
    anchors_per_class: int = 4
    n_tokens: int = 16
    corrupt_nodes: Tuple[int, ...] = ()
    # bridge clients hold locally PAIRED data across two modalities and add
    # an intra-node contrastive loss
    bridge_nodes: Tuple[int, ...] = ()
    bridge_modality: str = "text"
    lambda_bridge: float = 0.5
    # nodes whose anchor modality is missing from the public set and is
    # replaced by noisy synthetic anchors
    synthetic_anchor_nodes: Tuple[int, ...] = ()
    synthetic_anchor_noise: float = 2.0
    seed: int = 0
    center_cka: bool = False
    # round index tensor -> LR multiplier (the optimizer's "round" counter)
    round_lr_schedule: Optional[Callable] = None
    # FedAvgM on the server's side-car average (``Federation`` only; the
    # sequential round ignores it, as in the reference): None is off
    server_momentum: Optional[float] = None


def _detach_named(tree, names=("dora_m",)):
    """``tree`` with the leaves called ``names`` detached."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node is None or name not in names:
            return node
        return node.detach()
    return walk(tree, "")


def per_node_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``cross_entropy_loss`` over the last batch axis: logits (..., B, C),
    labels (..., B) or (B,) -> (...,); (B, C) gives the scalar."""
    logits32 = logits.float()
    idx = labels.long().expand(logits.shape[:-1])[..., None]
    gold = logits32.gather(-1, idx)[..., 0]
    return (torch.logsumexp(logits32, dim=-1) - gold).mean(dim=-1)


def _width_buckets(widths) -> tuple:
    """Nodes grouped by adapter width: the distinct widths ascending, and
    per width the node ids that have it."""
    bucket_widths = tuple(sorted(set(widths)))
    return bucket_widths, tuple(tuple(i for i, w in enumerate(widths)
                                      if w == wb) for wb in bucket_widths)


def _shipped(trainable: dict) -> dict:
    """The uplink view of a node's trainables: shipped leaves, None
    elsewhere, and no key whose subtree ships nothing (a bridge node's
    ``adapter2``)."""
    mask = lora_mod.shipped_mask(trainable)
    view = tree_map(lambda p, m: p if m else None, trainable, mask)
    return {k: v for k, v in view.items() if tree_leaves(v)}


def jax_keys(ids, seed: int) -> np.ndarray:
    """The files' per-node ``key`` leaves, uint32 (n, 2): node i's row is
    ``jax_key_layout(i << 32 | seed)``, ``[i, seed]``, distinct per node
    (never read back)."""
    return np.stack([jax_key_layout(i << 32 | seed) for i in ids]
                    ).reshape(-1, 2)


def _gen_states(gens) -> list:
    return [None if g is None else g.get_state().tolist() for g in gens]


def _set_gen(gen, saved, fresh) -> None:
    """``gen`` to its saved state, or to ``fresh``'s (a generator made
    from the construction seed) where none was saved."""
    gen.set_state(fresh.get_state() if saved is None
                  else torch.tensor(saved, dtype=torch.uint8))


def _saved_gens(meta: dict, device: torch.device) -> Optional[dict]:
    """The meta's generator states when they were written on this device
    type (a generator's state is not portable across device types)."""
    g = meta.get("torch_generators")
    return g if g and g.get("device") == device.type else None


class SequentialFederation:
    """K simulated nodes on one device, stepped one by one: a Python loop
    over nodes and local steps.  ``device`` None means ``cuda`` (raises
    without a GPU)."""

    def __init__(self, fed: FederationConfig, model: ModelConfig = None, *,
                 device=None):
        if fed.method not in METHODS:
            raise ValueError(f"unknown method {fed.method!r}; one of "
                             f"{METHODS}")
        dev = resolve_device(device)
        self.fed, self.device = fed, dev
        self.cfg = model or get_config("fedmm-small")
        seed = fed.seed

        # ---- substrate: task, tokenizers, anchors ----
        self.task = SyntheticMultimodal(fed.n_classes, fed.modalities,
                                        seed=seed, device=dev)
        self.tokenizers = default_tokenizers(
            {m: MODALITY_TOKENIZER_DIMS[m] for m in fed.modalities},
            self.task.d_raw, fed.n_tokens, seed=seed, device=dev)
        anchors_raw = self.task.anchor_set(stream(dev, seed, "anchors"),
                                           fed.anchors_per_class)
        self.anchor_tokens = {m: self.tokenizers[m](raw)
                              for m, (raw, _) in anchors_raw.items()}
        # synthetic (generated) anchors: same class structure, heavy noise
        self.synthetic_anchor_tokens = {}
        if fed.synthetic_anchor_nodes:
            for m, (raw, _) in anchors_raw.items():
                noise = torch.randn(raw.shape, device=dev, generator=stream(
                    dev, seed, "synthetic-anchors", m))
                self.synthetic_anchor_tokens[m] = self.tokenizers[m](
                    raw + fed.synthetic_anchor_noise * noise)

        # ---- global model: random init (the protocol is init-agnostic) ----
        params = T.init_params(stream(dev, seed, "model"), self.cfg,
                               device=dev)
        if fed.method != "fedavg_full":
            spec = lora_mod.LoRASpec(rank=fed.lora_rank,
                                     dora=fed.method == "geodora")
            params = lora_mod.attach_lora(stream(dev, seed, "lora"), params,
                                          spec)
        params["cls_head"] = make_linear(stream(dev, seed, "cls_head"),
                                         self.cfg.d_model, fed.n_classes,
                                         torch.float32, device=dev)
        if fed.method == "fedavg_full":
            mask = tree_map(lambda _: True, params)
        else:
            mask = lora_mod.trainable_mask(params)
        trainable, frozen = lora_mod.partition(params, mask)

        # ---- per-node state: shared trainables + local adapter(s) ----
        self.opt = AdamW(lr=fed.lr, weight_decay=0.0, grad_clip=1.0,
                         round_schedule=fed.round_lr_schedule)
        self.nodes: List[dict] = []
        for i in range(fed.n_nodes):
            m = fed.modalities[i % len(fed.modalities)]
            train = dict(trainable, adapter=make_linear(
                stream(dev, seed, "adapter", i),
                self.tokenizers[m].d_out, self.cfg.d_model, torch.float32,
                device=dev))
            node = {"modality": m, "corrupt": i in fed.corrupt_nodes,
                    "bridge": i in fed.bridge_nodes,
                    "gen": stream(dev, seed, "data", i)}
            if node["bridge"]:
                m2 = fed.bridge_modality
                if m2 == m:
                    m2 = next(x for x in fed.modalities if x != m)
                node["modality2"] = m2
                train["adapter2"] = make_linear(
                    stream(dev, seed, "adapter2", i),
                    self.tokenizers[m2].d_out, self.cfg.d_model,
                    torch.float32, device=dev)
            node["trainable"] = train
            node["opt_state"] = self.opt.init(train)
            self.nodes.append(node)
        # the frozen trees carry placeholders for the adapters
        self.frozen = dict(frozen, adapter={"w": None})
        self.frozen_bridge = (dict(self.frozen, adapter2={"w": None})
                              if fed.bridge_nodes else None)

        self.gbar = self._initial_consensus()
        self.history: List[dict] = []

    # ------------------------------------------------------------------
    def _pooled(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        embeds = linear(tokens.float(), params["adapter"])
        return T.pooled(params, {"inputs_embeds": embeds}, self.cfg)

    def _frozen_for(self, node: dict) -> dict:
        return self.frozen_bridge if node["bridge"] else self.frozen

    @torch.no_grad()
    def _initial_consensus(self) -> torch.Tensor:
        pooled = [self._pooled(
            lora_mod.combine(n["trainable"], self._frozen_for(n)),
            self.anchor_tokens[n["modality"]]) for n in self.nodes]
        return cka_mod.consensus_gram(cka_mod.cosine_gram(
            torch.stack(pooled)))

    def _broadcast(self, avg: dict) -> None:
        """The server's downlink: ``avg``'s shipped leaves (cast to each
        leaf's dtype) onto every node, participants or not."""
        for node in self.nodes:
            mask = lora_mod.shipped_mask(node["trainable"])
            node["trainable"] = {
                k: tree_map(lambda p, s, sm: s.to(p.dtype) if sm else p, v,
                            avg[k], mask[k]) if k in avg else v
                for k, v in node["trainable"].items()}

    def _bytes_record(self) -> dict:
        """A round's communication fields: one node's uplink (shipped
        side-cars and its Gram) and the full model's bytes."""
        node0 = self.nodes[0]
        return {"uplink_bytes": agg.comm_bytes_per_round(
                    _shipped(node0["trainable"]),
                    gram_side=self.gbar.shape[0]),
                "full_model_bytes": lora_mod.param_bytes(lora_mod.combine(
                    node0["trainable"], self._frozen_for(node0)))}

    def _draw(self, i: int, node: dict):
        """One local step's batch of node ``i`` from its own generator:
        tokens (B, L, d_m), labels (B,), and on a bridge node the tokens
        of the same draws through its second modality (else None)."""
        raw, labels, raw2 = self.task.sample(
            node["gen"], node["modality"], self.fed.local_batch,
            corrupt=node["corrupt"], paired=node.get("modality2"))
        tokens2 = (None if raw2 is None
                   else self.tokenizers[node["modality2"]](raw2))
        return self.tokenizers[node["modality"]](raw), labels, tokens2

    # ------------------------------------------------------------------
    @staticmethod
    def _contrastive(z1: torch.Tensor, z2: torch.Tensor,
                     tau: float = 0.2) -> torch.Tensor:
        """Intra-node InfoNCE on locally PAIRED samples (bridge clients):
        (B, D) pairs -> a scalar, or stacks (K, B, D) -> (K,)."""
        z1 = z1 / torch.linalg.norm(z1, dim=-1, keepdim=True).clamp_min(1e-8)
        z2 = z2 / torch.linalg.norm(z2, dim=-1, keepdim=True).clamp_min(1e-8)
        sim = (z1 @ z2.transpose(-1, -2)) / tau
        labels = torch.arange(z1.shape[-2], device=z1.device)
        return 0.5 * (per_node_ce(sim, labels)
                      + per_node_ce(sim.transpose(-1, -2), labels))

    def _grads(self, trainable, frozen, tokens, labels, anchor_tokens, gbar,
               tokens2=None):
        """Gradients of Eq. 3 (plus the bridge term when ``tokens2``) with
        respect to the trainable leaves, and the step's metrics."""
        fed = self.fed
        train = tree_map(lambda t: None if t is None
                         else t.detach().requires_grad_(), trainable)
        params = lora_mod.combine(train, frozen)
        pooled = self._pooled(params, tokens)
        logits = linear(pooled, params["cls_head"])
        task = cross_entropy_loss(logits, labels)
        # GeoDoRA: the geometric loss constrains direction only
        params_geo = lora_mod.combine(_detach_named(train), frozen)
        pooled_a = self._pooled(params_geo, anchor_tokens)
        geo = cka_mod.geo_alignment_loss(pooled_a, gbar,
                                         center=fed.center_cka)
        loss = task + fed.lambda_geo * geo
        if tokens2 is not None:
            pooled2 = self._pooled(dict(params, adapter=params["adapter2"]),
                                   tokens2)
            loss = loss + fed.lambda_bridge * self._contrastive(pooled,
                                                                pooled2)
        leaves = tree_leaves(train)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        acc = (logits.argmax(-1) == labels).float().mean()
        return tree_map(lambda t: None if t is None else next(grads), train), \
            {"task": task.detach(), "geo": geo.detach(), "acc": acc,
             "pooled": pooled.detach(), "pooled_a": pooled_a.detach()}

    def _local_step(self, trainable, opt_state, frozen, tokens, labels,
                    anchor_tokens, gbar, tokens2=None):
        """One AdamW step on Eq. 3; on a bridge client (``tokens2``, its
        second modality's tokens of the same draws) plus the paired
        InfoNCE term."""
        grads, metrics = self._grads(trainable, frozen, tokens, labels,
                                     anchor_tokens, gbar, tokens2)
        return (*self.opt.update(grads, opt_state, trainable), metrics)

    # ------------------------------------------------------------------
    def _train_node(self, i: int, node: dict) -> dict:
        """Node ``i``'s local work of one round: its round counter moves,
        then E AdamW steps on batches from its own generator.  Returns the
        last step's metrics, what it uploads."""
        fed = self.fed
        if "round" in node["opt_state"]:
            node["opt_state"] = dict(node["opt_state"],
                                     round=node["opt_state"]["round"] + 1)
        m = node["modality"]
        anchors = (self.synthetic_anchor_tokens[m]
                   if i in fed.synthetic_anchor_nodes
                   else self.anchor_tokens[m])
        for _ in range(fed.local_steps):
            tokens, labels, tokens2 = self._draw(i, node)
            node["trainable"], node["opt_state"], last = \
                self._local_step(node["trainable"], node["opt_state"],
                                 self._frozen_for(node), tokens, labels,
                                 anchors, self.gbar, tokens2)
        return last

    def run_round(self, participants=None) -> dict:
        """One protocol round.  ``participants`` (node ids) restricts it
        to a reporting cohort: the others do nothing and contribute
        nothing, and still receive the broadcast.  None is the full
        round."""
        fed = self.fed
        active = None if participants is None else set(participants)
        if active is not None and not active:
            raise ValueError("empty participant set")
        grams, precisions, shipped_list, metrics = [], [], [], []
        self._last_raw_precisions = {}
        for i, node in enumerate(self.nodes):
            if active is not None and i not in active:
                continue
            last = self._train_node(i, node)
            metrics.append(torch.stack([last["task"], last["geo"],
                                        last["acc"]]))
            # upload: Gram + precision + shipped side-cars
            grams.append(cka_mod.cosine_gram(last["pooled_a"]))
            precisions.append(unc.node_precision(unc.lap_uncertainty(
                last["pooled"], last["pooled_a"])))
            # only the precision strategy's sampler reads these
            self._last_raw_precisions[i] = precisions[-1]
            shipped_list.append(_shipped(node["trainable"]))

        # ---- server (over whichever nodes reported) ----
        k_active = len(grams)
        grams = torch.stack(grams)
        self.gbar = cka_mod.consensus_gram(grams)
        if fed.aggregation == "precision":
            weights = unc.precision_weights(torch.stack(precisions))
        else:
            weights = torch.full((k_active,), 1.0 / k_active,
                                 device=self.device)
        self._broadcast(agg.aggregate_geolora(shipped_list, weights))

        off_diag = cka_mod.mean_offdiag_cka(grams, center=fed.center_cka)
        host = torch.cat([torch.stack(metrics).T.reshape(-1), weights,
                          off_diag[None]]).tolist()          # one readback
        task, geo, acc = (host[j * k_active:(j + 1) * k_active]
                          for j in range(3))
        weights = host[3 * k_active:4 * k_active]
        rec = {
            "task_loss": sum(task) / k_active,
            "geo_loss": sum(geo) / k_active,
            "acc": sum(acc) / k_active,
            "cross_node_cka": host[-1],
            **self._bytes_record(),
        }
        if active is None:
            rec["weights"] = weights
        else:
            ordered = sorted(active)
            rec["weights"] = [weights[ordered.index(i)] if i in active
                              else 0.0 for i in range(fed.n_nodes)]
            rec["participation"] = [1.0 if i in active else 0.0
                                    for i in range(fed.n_nodes)]
            rec["cohort_size"] = k_active
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------------
    # participation: the oracle of the engine's sampled rounds.  The same
    # sampler functions run here eagerly over the same width-bucket
    # groups, on uniforms from the same generator, so the cohort and
    # event streams are the engine's exactly
    def _node_width(self, node: dict) -> int:
        """The adapter width a node needs: its tokenizer's, or on a bridge
        node the wider of its two."""
        d = self.tokenizers[node["modality"]].d_out
        if node["bridge"]:
            d = max(d, self.tokenizers[node["modality2"]].d_out)
        return d

    def _participation_groups(self) -> tuple:
        """Canonical node ids per width bucket: the sampler's groups, the
        engine's default (bucketed) layout."""
        return _width_buckets([self._node_width(n) for n in self.nodes])[1]

    def _sample_participants(self, plan):
        """Advance the carried sampler state one round; returns the
        participating node ids (sorted) and the groups."""
        groups = self._participation_groups()
        prev = getattr(self, "_seq_part", None)
        state = (part_mod.init_state(plan, self.fed.n_nodes, self.device)
                 if prev is None or prev[0] != plan else prev[1])
        u = (None if state is None else
             part_mod.draw_uniforms(plan, state["gen"], self.fed.n_nodes))
        row_masks, _, state = part_mod.sample_rows(plan, state, groups, u,
                                                   device=self.device)
        self._seq_part = (plan, state)
        mask = torch.cat(row_masks).tolist()
        rows = [i for g in groups for i in g]
        return sorted(i for i, m in zip(rows, mask) if m > 0), groups

    def _update_seq_sampler(self, plan, groups, participants) -> None:
        """Fold this round's reported precisions into the sampler state
        (``precision`` strategy), as the engine's ``update_state``."""
        if plan.strategy != "precision":
            return
        plan_, state = self._seq_part
        rows = [i for g in groups for i in g]         # row order
        zero = torch.zeros((), device=self.device)
        mask = torch.tensor([1.0 if i in participants else 0.0
                             for i in rows], device=self.device)
        p = torch.stack([self._last_raw_precisions.get(i, zero)
                         for i in rows])
        self._seq_part = (plan_, part_mod.update_state(plan, state, mask,
                                                       p))

    def run_rounds(self, n: int, block_size: int = 1,
                   participation=None) -> List[dict]:
        """``n`` rounds.  ``block_size`` is accepted for parity with
        ``Federation`` (the sequential round always steps per round).
        ``participation`` (a ``ParticipationPlan`` or strategy name)
        samples each round's cohort with the engine's sampler; the sampler
        state carries across calls while the plan is unchanged."""
        plan = part_mod.normalize(participation)
        if plan is None:
            return [self.run_round() for _ in range(n)]
        if plan.strategy == "async":
            return [self._run_async_round(plan) for _ in range(n)]
        recs = []
        for _ in range(n):
            parts, groups = self._sample_participants(plan)
            recs.append(self.run_round(participants=parts))
            self._update_seq_sampler(plan, groups, set(parts))
        return recs

    def run(self, block_size: int = 1, participation=None) -> List[dict]:
        """``fed.rounds`` rounds; returns the history."""
        self.run_rounds(self.fed.rounds, block_size,
                        participation=participation)
        return self.history

    # ------------------------------------------------------------------
    # async (FedBuff): the oracle of the engine's async round.  The same
    # ``async_events`` on the same uniforms give the engine's event
    # stream, and the server calls the same staleness / consensus
    # functions, one node at a time
    def _report(self, plan, i: int, node: dict, last: dict):
        """Node ``i``'s uplink report (shipped side-cars in f32, Gram,
        precision), NaN-poisoned when the plan injects a fault there."""
        gram = cka_mod.cosine_gram(last["pooled_a"])
        if self.fed.aggregation == "precision":
            prec = unc.node_precision(unc.lap_uncertainty(
                last["pooled"], last["pooled_a"]))
        else:
            prec = torch.ones((), device=self.device)
        shipped = tree_map(lambda l: None if l is None else l.float(),
                           _shipped(node["trainable"]))
        if i in plan.poison_nodes:             # fault injection: uplink only
            nan = float("nan")
            shipped = tree_map(lambda l: None if l is None else l + nan,
                               shipped)
            gram, prec = gram + nan, prec + nan
        return {"shipped": shipped, "gram": gram, "prec": prec.float()}

    @staticmethod
    def _quarantined(plan, report: dict) -> bool:
        """The engine's quarantine guard, eagerly: a non-finite value
        anywhere in the report, or a shipped norm above the bound."""
        leaves = tree_leaves(report["shipped"])
        finite = all(bool(torch.isfinite(t).all())
                     for t in leaves + [report["gram"], report["prec"]])
        norm_sq = sum(float((l.float() ** 2).sum()) for l in leaves)
        return not finite or norm_sq > plan.quarantine_norm ** 2

    def _run_async_round(self, plan) -> dict:
        fed, k = self.fed, self.fed.n_nodes
        groups = self._participation_groups()
        rows = [i for g in groups for i in g]      # canonical id per row
        prev = getattr(self, "_seq_async", None)
        if prev is None or prev[0] != plan:
            self._seq_async = (plan, part_mod.init_state(plan, k,
                                                         self.device),
                               [None] * k)
        _, ctl, buf = self._seq_async
        # the server's previous broadcast: the shipped leaves are equal on
        # every node at round start; re-broadcast when nothing lands
        prev_shipped = tree_map(lambda l: None if l is None else l.float(),
                                _shipped(self.nodes[0]["trainable"]))
        u = part_mod.draw_uniforms(plan, ctl["gen"], k)
        start, lag_draw, ctl = part_mod.async_events(plan, ctl, u)
        start, lag_draw, countdown, lag, quarantined = (
            t.tolist() for t in (start, lag_draw, ctl["countdown"],
                                 ctl["lag"], ctl["quarantined"]))

        # starters run their local epochs; everyone else does NOTHING
        metrics = []
        for r, i in enumerate(rows):
            if start[r] <= 0:
                continue
            node = self.nodes[i]
            last = self._train_node(i, node)
            metrics.append([float(last[n]) for n in ("task", "geo", "acc")])
            report = self._report(plan, i, node, last)
            if self._quarantined(plan, report):
                quarantined[r] += 1
                continue                        # idle again; retries next
            buf[r] = report
            countdown[r] = lag[r] = lag_draw[r]

        # staleness-weighted delivery over the expiring reports
        delivered = [1.0 if c == 0 and buf[r] is not None else 0.0
                     for r, c in enumerate(countdown)]
        dev = self.device
        lag_t = torch.tensor(lag, dtype=torch.int32, device=dev)
        del_t = torch.tensor(delivered, device=dev)
        if fed.aggregation == "precision":
            zero = torch.zeros((), device=dev)
            base = torch.stack([zero if b is None else b["prec"]
                                for b in buf])
        else:
            base = torch.ones((k,), device=dev)
        wn = unc.stale_precision_weights(
            base, lag_t, del_t, plan.staleness, plan.staleness_alpha,
            plan.max_staleness)
        fresh = del_t * (unc.staleness_factor(
            lag_t, plan.staleness, plan.staleness_alpha,
            plan.max_staleness) > 0).float()
        w_host = wn.tolist()
        if sum(w_host) > 0:
            total = agg.weighted_mean_trees(
                [buf[r]["shipped"] for r in range(k) if w_host[r] > 0],
                torch.stack([wn[r] for r in range(k) if w_host[r] > 0]))
        else:
            total = prev_shipped       # no deliveries: the protocol idles
        self._broadcast(total)
        if fresh.sum().item() > 0:
            zeros = torch.zeros_like(self.gbar)
            grams = torch.stack([zeros if b is None else b["gram"]
                                 for b in buf])
            self.gbar = cka_mod.consensus_gram(grams, mask=fresh,
                                               fallback=self.gbar)
            xcka = float(cka_mod.mean_offdiag_cka(
                grams, center=fed.center_cka, mask=fresh))
        else:
            xcka = 0.0
        for r in range(k):
            if delivered[r] > 0:
                countdown[r] = -1
            elif countdown[r] > 0:
                countdown[r] -= 1

        ctl = dict(ctl, countdown=torch.tensor(countdown, dtype=torch.int32,
                                               device=dev),
                   lag=lag_t, quarantined=torch.tensor(
                       quarantined, dtype=torch.int32, device=dev))
        self._seq_async = (plan, ctl, buf)
        n_started = max(sum(1 for s in start if s > 0), 1)
        by_node = lambda vals: [vals[rows.index(i)] for i in range(k)]
        rec = {
            "task_loss": sum(x[0] for x in metrics) / n_started,
            "geo_loss": sum(x[1] for x in metrics) / n_started,
            "acc": sum(x[2] for x in metrics) / n_started,
            "cross_node_cka": xcka,
            **self._bytes_record(),
            "weights": by_node(w_host),
            "participation": by_node(start),
            "cohort_size": int(sum(start)),
            "delivered": by_node(delivered),
            "staleness": by_node([float(lag[r]) if delivered[r] > 0
                                  else -1.0 for r in range(k)]),
            "quarantined": by_node([float(q) for q in quarantined]),
            "n_delivered": float(sum(delivered)),
        }
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------------
    # checkpoints: the consensus Gram and per node its trainables, AdamW
    # state and key (JAX layout); the frozen base, tokenizers and anchors
    # are rebuilt from the config seed
    def _ckpt_nodes(self) -> dict:
        return {"gbar": self.gbar,
                "nodes": [{"trainable": n["trainable"],
                           "opt_state": n["opt_state"], "key": key}
                          for n, key in zip(self.nodes, jax_keys(
                              range(len(self.nodes)), self.fed.seed))]}

    def save(self, path: str) -> None:
        """The reference's file (step = rounds run), with each node's data
        generator under ``torch_generators`` in the meta."""
        save_checkpoint(path, self._ckpt_nodes(), step=len(self.history),
                        meta={"torch_generators": {
                            "device": self.device.type,
                            "nodes": _gen_states(n["gen"]
                                                 for n in self.nodes)}})

    def restore(self, path: str) -> int:
        """Load a file of either package into this federation (same
        config); returns its step.  Node generators continue from the
        file's states, or restart from their seeds when it has none for
        this device type."""
        state, step = load_checkpoint(path, self._ckpt_nodes())
        gens = _saved_gens(read_meta(path), self.device)
        self.gbar = state["gbar"]
        for i, (node, saved) in enumerate(zip(self.nodes, state["nodes"])):
            node["trainable"] = saved["trainable"]
            node["opt_state"] = saved["opt_state"]
            _set_gen(node["gen"], gens and gens["nodes"][i],
                     stream(self.device, self.fed.seed, "data", i))
        return step

    def node_params(self, i: int) -> dict:
        """Node i's full parameter tree (trainables over the frozen)."""
        node = self.nodes[i]
        return lora_mod.combine(node["trainable"], self._frozen_for(node))


# ======================================================================
def merge_params(train, frozen):
    """``lora.combine`` that keeps keys only ``frozen`` has (the engine's
    precomputed GeoDoRA terms): the union of both trees, the trainable leaf
    where it is not None."""
    if isinstance(train, dict) or isinstance(frozen, dict):
        train, frozen = train or {}, frozen or {}
        return {k: merge_params(train.get(k), frozen.get(k))
                for k in {**frozen, **train}}
    return frozen if train is None else train


def _cat_nodes(trees: list):
    """Per-bucket node stacks of one structure -> one stack of all nodes."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *xs: None if xs[0] is None else torch.cat(xs),
                    *trees)


LOCAL_KEYS = ("adapter", "adapter2")


def _rows_of_rank(buckets, mesh) -> tuple:
    """The node ids of each bucket whose rows this rank holds: slice s of
    the R equal slices of every bucket, s its shard index (every bucket
    without a mesh).  The engine checks that each bucket divides R."""
    if mesh is None:
        return tuple(buckets)
    from repro_torch.launch import mesh as mesh_mod
    n, s = mesh_mod.n_nodes(mesh), mesh_mod.shard_index(mesh)
    return tuple(m[s * (len(m) // n):(s + 1) * (len(m) // n)]
                 for m in buckets)


#: the parameter subtrees whose leaves stack layers (or hybrid groups) first
STACKS = ("blocks", "enc_blocks", "groups")


def layer_major(shared: dict) -> dict:
    """Node-stacked trainables with each stacked subtree's layer (or group)
    axis first and the node axis second, so the stack's per-layer views
    carry the node axis."""
    return {k: (tree_map(lambda t: None if t is None else t.transpose(0, 1),
                         v) if k in STACKS else v)
            for k, v in shared.items()}


def with_dora_terms(frozen: dict) -> dict:
    """The frozen tree with the GeoDoRA norm's W-only terms added to every
    linear with ``dora_m`` (W and A are frozen and shared: computed once)."""
    if isinstance(frozen, dict) and frozen.get("lora_A") is not None \
            and "dora_m" in frozen:
        return dict(frozen, **dora_w_terms(frozen["w"], frozen["lora_A"]))
    if isinstance(frozen, dict):
        return {k: with_dora_terms(v) for k, v in frozen.items()}
    return frozen


class Federation(SequentialFederation):
    """The width-bucketed node-stacked federation (the port of
    ``repro.core.federation.Federation``): nodes whose adapters share a
    width (tokenizer width, or a bridge node's wider one) form a bucket;
    each bucket's trainables and AdamW states are stacked on a node axis,
    adapters zero-padded to the bucket width (``width_bucketing=False``:
    one bucket of all nodes at the widest width).  A local step runs the
    tokenizer and the adapter per bucket and the transformer once over the
    rows of all K nodes, whose side-cars ride a node axis; the round (and
    ``run_rounds(n, block_size=M)``'s blocks) go through
    ``engine.RoundEngine``, one CUDA-graph replay each on the card.  The
    GeoDoRA norm's W-only terms are computed once, here.

    Records match the sequential round's; ``self.nodes`` is a lazily
    refreshed unpadded view of the stacked state (copies: the state is
    updated in place)."""

    def __init__(self, fed: FederationConfig, model: ModelConfig = None, *,
                 device=None, mesh=None, width_bucketing: bool = True):
        if mesh is not None:
            from repro_torch.launch.mesh import mesh_device
            own = mesh_device(mesh)
            if device is not None and torch.device(device) != own:
                raise ValueError(f"Federation(mesh=): this rank's device is "
                                 f"{own}, not {device}")
            device = own
        super().__init__(fed, model, device=device)
        self._width_bucketing = width_bucketing
        #: the in-block checkpoints written: step, path, seconds, bytes
        self.checkpoint_writes: List[dict] = []
        self._build_engine(mesh)

    @property
    def nodes(self):
        if getattr(self, "_views_stale", False):
            self._views_stale = False
            self._refresh_node_views()
        return self._nodes

    @nodes.setter
    def nodes(self, value):
        self._nodes = value

    # ------------------------------------------------------------------
    def _bucket_layout(self, widths, mesh=None):
        """(bucket widths, node ids per bucket).  Under a mesh every bucket
        must divide its batch slices; a bucketed layout that does not falls
        back to the one padded bucket, with a warning, as the reference
        does (the state's structure changes, so a checkpoint of it needs
        the same shard count to restore)."""
        one = (max(widths),), (tuple(range(len(widths))),)
        if not self._width_bucketing:
            return one
        layout = _width_buckets(widths)
        if mesh is not None and len(layout[1]) > 1:
            from repro_torch.launch.mesh import n_nodes as mesh_shards
            n_shards = mesh_shards(mesh)
            if any(len(m) % n_shards for m in layout[1]):
                import warnings
                warnings.warn(
                    f"width buckets {[len(m) for m in layout[1]]} do not "
                    f"divide the {n_shards} mesh batch slices; falling back "
                    f"to the single pad-to-max-width bucket (checkpoints "
                    f"from this layout require the same mesh shard count "
                    f"to restore)", stacklevel=3)
                return one
        return layout

    def _build_engine(self, mesh=None) -> None:
        fed, nodes, dev = self.fed, self._nodes, self.device
        self._has_bridges = any(n["bridge"] for n in nodes)
        widths = [self._node_width(n) for n in nodes]
        self._bucket_widths, buckets = self._bucket_layout(widths, mesh)
        self._buckets = tuple(buckets)
        self._node_bucket = {i: (b, r) for b, members in enumerate(buckets)
                             for r, i in enumerate(members)}
        #: the node ids of each bucket whose rows this rank holds
        self._local_buckets = _rows_of_rank(buckets, mesh)
        trains, opts, masks = [], [], []
        for members, wb in zip(self._local_buckets, self._bucket_widths):
            trees = []
            for i in members:
                node = nodes[i]
                t = dict(node["trainable"])
                t["adapter"] = {"w": engine_mod.pad_axis(
                    t["adapter"]["w"], wb, 0)}
                if self._has_bridges:
                    if node["bridge"]:
                        t["adapter2"] = {"w": engine_mod.pad_axis(
                            t["adapter2"]["w"], wb, 0)}
                    else:
                        # inert slot: the bridge term is masked to 0 on this
                        # node, so it gets exactly zero gradients and is
                        # never shipped, but it must be NONZERO -- a zero
                        # adapter makes pooled2 the zero vector, whose norm
                        # has a NaN gradient that 0 x NaN spreads to the node
                        t["adapter2"] = {"w": engine_mod.pad_axis(make_linear(
                            stream(dev, fed.seed, "inert-adapter2", i),
                            self.tokenizers[node["modality"]].d_out,
                            self.cfg.d_model, torch.float32,
                            device=dev)["w"], wb, 0)}
                trees.append(t)
            train_b = engine_mod.stack_nodes(trees)
            trains.append(train_b)
            opts.append(engine_mod.stack_nodes([self.opt.init(t)
                                                for t in trees]))
            masks.append(lora_mod.shipped_mask(train_b))
        self._trains, self._opts = tuple(trains), tuple(opts)
        self._refresh_statics()
        self._bytes = self._bytes_record()
        ecfg = engine_mod.EngineConfig(
            n_nodes=fed.n_nodes, local_steps=fed.local_steps,
            aggregation=fed.aggregation, center_cka=fed.center_cka,
            bucket_sizes=tuple(len(m) for m in buckets),
            node_perm=tuple(i for members in buckets for i in members),
            server_momentum=fed.server_momentum)
        self.engine = engine_mod.RoundEngine(
            ecfg, self._local_step_nodes, tuple(masks), device=dev,
            mesh=mesh)
        self._server_m = self.engine.init_server_state(self._trains)

    def _refresh_statics(self) -> None:
        """Per-bucket constants (anchor tokens, tokenizer weights padded to
        the bucket width, bridge masks) and the frozen tree with the
        GeoDoRA norm's W-only terms; rebuilt when the substrate is replaced
        (``bridge.load_engine_state``)."""
        fed, nodes = self.fed, self._nodes
        statics = []
        for members, wb in zip(self._local_buckets, self._bucket_widths):
            cols = {}
            for i in members:
                node = nodes[i]
                m = node["modality"]
                anchors = (self.synthetic_anchor_tokens[m]
                           if i in fed.synthetic_anchor_nodes
                           else self.anchor_tokens[m])
                row = {"anchors": engine_mod.pad_axis(anchors, wb, -1)}
                row.update(zip(("tok_w1", "tok_b1", "tok_w2"),
                               self.tokenizers[m].padded_weights(wb)))
                if self._has_bridges:
                    m2 = node.get("modality2", m)
                    row.update(zip(("tok2_w1", "tok2_b1", "tok2_w2"),
                                   self.tokenizers[m2].padded_weights(wb)))
                    row["bridge"] = torch.tensor(float(node["bridge"]),
                                                 device=self.device)
                for k, v in row.items():
                    cols.setdefault(k, []).append(v)
            statics.append({k: torch.stack(v) for k, v in cols.items()})
        self._statics = tuple(statics)
        self._frozen_engine = with_dora_terms(
            self.frozen_bridge if self._has_bridges else self.frozen)

    # ------------------------------------------------------------------
    def _tokenize(self, raw, w1, b1, w2):
        """Each node's frozen tokenizer at its bucket's width: raw (k, n,
        d_raw) -> tokens (k, n, L, width)."""
        h = torch.einsum("knd,kdlo->knlo", raw.float(), w1) + b1[:, None]
        return torch.tanh(h) @ w2[:, None]

    def _pooled_nodes(self, params, tokens, adapters) -> torch.Tensor:
        """Pooled activations (K, n, d_model) of all nodes: each bucket's
        tokens through its adapters, then one transformer pass over the K n
        sequences (per-node side-cars on a node axis)."""
        embeds = torch.cat([linear(t.float(), a)
                            for t, a in zip(tokens, adapters)])
        k, n = embeds.shape[:2]
        pooled = T.pooled(params, {"inputs_embeds": embeds.reshape(
            k * n, *embeds.shape[2:])}, self.cfg)
        return pooled.reshape(k, n, -1)

    def _local_step_nodes(self, trains, opts, gbar, statics, batch):
        """One local step of every node (Eq. 3, plus the bridge term where
        ``bridge`` is 1): the gradient of the sum of the nodes' losses,
        which is each node's own, then AdamW per node."""
        fed = self.fed
        live = tuple(tree_map(lambda t: None if t is None
                              else t.detach().requires_grad_(), tr)
                     for tr in trains)
        shared = layer_major(_cat_nodes([
            {k: v for k, v in tr.items() if k not in LOCAL_KEYS}
            for tr in live]))
        params = merge_params(shared, self._frozen_engine)
        params_geo = merge_params(_detach_named(shared), self._frozen_engine)
        tokens = [self._tokenize(b["raw"], st["tok_w1"], st["tok_b1"],
                                 st["tok_w2"])
                  for b, st in zip(batch, statics)]
        pooled = self._pooled_nodes(params, tokens,
                                    [tr["adapter"] for tr in live])
        logits = linear(pooled, params["cls_head"])
        labels = torch.cat([b["labels"] for b in batch])
        task = per_node_ce(logits, labels)
        pooled_a = self._pooled_nodes(params_geo,
                                      [st["anchors"] for st in statics],
                                      [tr["adapter"] for tr in live])
        geo = cka_mod.geo_alignment_loss(pooled_a, gbar,
                                         center=fed.center_cka)
        loss = task + fed.lambda_geo * geo
        if self._has_bridges:
            tokens2 = [self._tokenize(b["raw2"], st["tok2_w1"],
                                      st["tok2_b1"], st["tok2_w2"])
                       for b, st in zip(batch, statics)]
            pooled2 = self._pooled_nodes(params, tokens2,
                                         [tr["adapter2"] for tr in live])
            bridge = torch.cat([st["bridge"] for st in statics])
            loss = loss + fed.lambda_bridge * bridge * self._contrastive(
                pooled, pooled2)
        leaves = [tree_leaves(tr) for tr in live]
        flat = [t for ls in leaves for t in ls]
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(flat, torch.autograd.grad(
                          loss.sum(), flat, allow_unused=True))])
        new_trains, new_opts = [], []
        for tr, op in zip(trains, opts):
            g = tree_map(lambda t: None if t is None else next(grads), tr)
            t_new, o_new = self.opt.update_stacked(g, op, tr)
            new_trains.append(t_new)
            new_opts.append(o_new)
        acc = (logits.argmax(-1) == labels).float().mean(dim=-1)
        return tuple(new_trains), tuple(new_opts), {
            "task": task.detach(), "geo": geo.detach(), "acc": acc,
            "pooled": pooled.detach(), "pooled_a": pooled_a.detach()}

    # ------------------------------------------------------------------
    def _stage(self, m: int) -> tuple:
        """The next m rounds' draws, per bucket ``{"raw": (m, E, k_b, B,
        d_raw), "labels": (m, E, k_b, B)[, "raw2"]}``: each node draws m E
        batches from its own generator, as m sequential rounds would."""
        fed, nodes, e = self.fed, self._nodes, self.fed.local_steps
        out = []
        for members in self._local_buckets:
            d = self.task.sample_stacked(
                [nodes[i]["gen"] for i in members],
                [nodes[i]["modality"] for i in members], fed.local_batch,
                m * e, corrupt=[nodes[i]["corrupt"] for i in members],
                paired=[nodes[i].get("modality2") if self._has_bridges
                        and nodes[i]["bridge"] else None for i in members])
            if self._has_bridges and "raw2" not in d:
                d["raw2"] = d["raw"]
            out.append({k: v.reshape(m, e, *v.shape[1:])
                        for k, v in d.items()})
        return tuple(out)

    def _own_nodes(self) -> list:
        """The ids of the nodes whose rows this rank holds (all without a
        mesh), in engine-row order."""
        return [i for members in self._local_buckets for i in members]

    def _stage_part(self, m: int, plan) -> tuple:
        """The next m rounds' draws of this rank's nodes (``_stage``, one
        round at a time), each one's generator state after each round
        (``pos[j][n]``: after j rounds, ``_own_nodes`` order), and the
        plan's (m, n_u, K) uniforms, the same on every rank.  The
        generators are left after m rounds; ``_run_block_part`` moves each
        back to the rounds its node trained."""
        gens = [self._nodes[i]["gen"] for i in self._own_nodes()]
        pos = [[g.get_state() for g in gens]]
        rounds = []
        for _ in range(m):
            rounds.append(self._stage(1))
            pos.append([g.get_state() for g in gens])
        batches = tuple({k: torch.cat([r[b][k] for r in rounds])
                         for k in rounds[0][b]}
                        for b in range(len(rounds[0])))
        uniforms = None
        if part_mod.n_uniforms(plan):
            uniforms = torch.stack([part_mod.draw_uniforms(
                plan, self._part_gen, self.fed.n_nodes) for _ in range(m)])
        return batches, uniforms, pos

    def capture(self, block_size: int = 1, participation=None) -> None:
        """Capture the round (``block_size`` 1) or the block graph now, on
        the card, under ``participation`` if given, without moving the
        federation on: the draws and uniforms it warms up with are taken
        back from the generators.  ``run_rounds`` captures on first use;
        calling this first keeps the capture out of a measured window."""
        plan = part_mod.normalize(participation)
        if plan is not None:
            self._ensure_participation(plan)
        gens = [n["gen"] for n in self._nodes]
        if plan is not None and self._part_gen is not None:
            gens.append(self._part_gen)
        saved = [g.get_state() for g in gens]
        if plan is None:
            batches, uniforms = self._stage(block_size), None
        else:
            batches, uniforms, _ = self._stage_part(block_size, plan)
        for g, st in zip(gens, saved):
            g.set_state(st)
        self.engine.capture(block_size, self._state(plan), self._statics,
                            batches, plan=plan, uniforms=uniforms)

    def _state(self, plan=None) -> tuple:
        state = (self._trains, self._opts, self.gbar, self._server_m)
        return state if plan is None else state + (self._part_state,)

    def _run_block(self, m: int, tap=None) -> List[dict]:
        _, metrics = self.engine.run_block(
            self._state(), m, statics=self._statics, batches=self._stage(m),
            tap=tap)
        return self._record_block(metrics)

    def _record_block(self, metrics: list) -> List[dict]:
        self._views_stale = True
        recs = [self._metrics_record(x) for x in metrics]
        self.history.extend(recs)
        return recs

    def _run_block_part(self, plan, m: int, tap=None) -> List[dict]:
        """m rounds under ``plan``: one replay and one readback.  Each
        node's generator ends where the sequential rounds leave it: after
        as many rounds of draws as the node trained."""
        batches, uniforms, pos = self._stage_part(m, plan)
        _, metrics = self.engine.run_block(
            self._state(plan), m, statics=self._statics, batches=batches,
            tap=tap, plan=plan, uniforms=uniforms)
        for n, i in enumerate(self._own_nodes()):
            trained = sum(round(x["participation"][i]) for x in metrics)
            self._nodes[i]["gen"].set_state(pos[trained][n])
        return self._record_block(metrics)

    def _metrics_record(self, metrics: dict) -> dict:
        """A history record from a round's metrics; under participation the
        per-node scalars are zero off the cohort and average over it."""
        n = (max(metrics["cohort_size"], 1.0) if "participation" in metrics
             else self.fed.n_nodes)
        rec = {"task_loss": sum(metrics["task"]) / n,
               "geo_loss": sum(metrics["geo"]) / n,
               "acc": sum(metrics["acc"]) / n,
               "cross_node_cka": metrics["cross_node_cka"],
               **self._bytes,
               "weights": list(metrics["weights"])}
        if "participation" in metrics:
            rec["participation"] = list(metrics["participation"])
            rec["cohort_size"] = int(round(metrics["cohort_size"]))
        if "delivered" in metrics:
            for name in engine_mod.ASYNC_FIELDS:
                rec[name] = list(metrics[name])
            rec["n_delivered"] = metrics["n_delivered"]
        return rec

    # ---- participation ---------------------------------------------------
    def _init_part_state(self, plan):
        """The sampler's device state for ``plan`` (the async report buffer
        included) and its generator; (None, None) under ``nodes``."""
        state = part_mod.init_state(plan, self.fed.n_nodes, self.device)
        if state is None:
            return None, None
        gen = state.pop("gen")
        if plan.strategy == "async":
            state = self.engine.init_async_state(
                self._trains, plan, gram_side=int(self.gbar.shape[0]))
        return state, gen

    def _ensure_participation(self, plan) -> None:
        """Install ``plan``: the sampler state carries across calls while
        the plan is unchanged and starts afresh when it changes."""
        if getattr(self, "_part_plan", None) != plan:
            self._part_plan = plan
            self._part_state, self._part_gen = self._init_part_state(plan)

    def run_round(self, participants=None) -> dict:
        """One round: one replay of the round graph on the card.
        ``participants`` (node ids) runs a one-shot fixed ``nodes`` plan;
        each DISTINCT cohort captures a graph of its own, as the reference
        compiles one per cohort -- for cohorts sampled each round use
        ``run_rounds(participation=)``, which samples inside one graph."""
        if participants is None:
            return self._run_block(1)[0]
        plan = part_mod.ParticipationPlan(
            strategy="nodes", nodes=tuple(sorted(participants)))
        self._ensure_participation(plan)
        return self._run_block_part(plan, 1)[0]

    def run_rounds(self, n: int, block_size: int = 1, tap=None,
                   participation=None, checkpoint_path: str = None,
                   checkpoint_every: int = 0) -> List[dict]:
        """``n`` rounds; with ``block_size`` M > 1 as blocks of M rounds (the
        last block takes the rest), each one replay and one readback.
        ``tap`` is called once per round of a block with its metrics.
        ``participation`` (a ``ParticipationPlan`` or strategy name) samples
        each round's cohort on the device inside the round's graph; the
        sampler state carries across calls while the plan is unchanged.
        None / "full" is the full-participation round.

        ``checkpoint_path`` + ``checkpoint_every`` (block mode) write a
        ``restore()``-able checkpoint every ``e = min(checkpoint_every, m)``
        rounds of each block of m, at the reference's steps (the rounds
        run so far): the block runs as sub-blocks of e rounds and the rest,
        one replay and one readback each, with the write after each full
        one, so a kill loses fewer than e rounds.  ``{step}`` in the path
        gives one file per checkpoint; otherwise the file is replaced
        atomically.  A failing write is logged and dropped.  With
        ``block_size`` 1 no file is written, as in the reference.  This is
        the port's checkpoint path; it splits blocks by the engine's
        ``tap_spans``, but runs each sub-block as a block of its own
        (staged, replayed, read back) rather than through
        ``RoundEngine.submit_block(state_tap=)``, so that each file holds
        the data generators at its own round."""
        plan = part_mod.normalize(participation)
        if plan is None:
            block = lambda m, t: self._run_block(m, t)
            if block_size <= 1:
                return [self.run_round() for _ in range(n)]
        else:
            self._ensure_participation(plan)
            block = lambda m, t: self._run_block_part(plan, m, t)
            if block_size <= 1:
                return [block(1, tap)[0] for _ in range(n)]
        recs, done = [], 0
        while done < n:
            m = min(block_size, n - done)
            every = (min(max(1, checkpoint_every), m) if checkpoint_path
                     else m)
            for start, mm, full in engine_mod.tap_spans(m, every):
                sub_tap = tap
                if tap is not None and start:     # index within the block
                    sub_tap = (lambda rec, s=start: tap(dict(
                        rec, round_in_block=rec["round_in_block"] + s)))
                recs += block(mm, sub_tap)
                if checkpoint_path and full:
                    engine_mod._safe_tap(self._write_checkpoint,
                                         checkpoint_path)
            done += m
        return recs

    def _write_checkpoint(self, path: str) -> None:
        """``save`` at the rounds run so far, into ``path`` (its ``{step}``
        filled in); each write's step, path, seconds and bytes go to
        ``checkpoint_writes``."""
        step = len(self.history)
        path = path.format(step=step) if "{step}" in path else path
        t0 = time.perf_counter()
        self.save(path)
        self.checkpoint_writes.append({
            "step": step, "path": path, "seconds": time.perf_counter() - t0,
            "bytes": os.path.getsize(path)})

    def run(self, block_size: int = 1, participation=None) -> List[dict]:
        self.run_rounds(self.fed.rounds, block_size,
                        participation=participation)
        return self.history

    # ---- every node's rows, under a mesh -------------------------------
    def _gathered(self, stacks):
        """Per-bucket stacked trees with every node's rows: ``stacks``
        itself without a mesh, else each leaf gathered over the batch
        group in shard order (collective)."""
        eng = self.engine
        if eng.mesh is None:
            return stacks

        def gather(t):
            out = t.new_empty((t.shape[0] * eng._shards,) + t.shape[1:])
            dist.all_gather_into_tensor(out, t.contiguous(),
                                        group=eng._group)
            return out
        return tree_map(lambda t: None if t is None else gather(t), stacks)

    def _barrier(self) -> None:
        """Every rank's host waits for every other's (a one-element
        ``all_reduce`` read back); nothing without a mesh."""
        if self.engine.mesh is not None:
            flag = torch.zeros((1,), device=self.device)
            dist.all_reduce(flag)
            flag.item()

    # ---- checkpoints -----------------------------------------------------
    # the file is the engine's bucketed state under the reference's leaf
    # names; the bucket layout is rebuilt from the config, so a restore
    # into a federation with the same config and ``width_bucketing`` lands
    # every node back at its row
    def _ckpt_state(self, keys: bool = True, stacks=None) -> dict:
        """The live state tensors as the file's tree; ``keys`` adds the
        JAX-layout key leaves the reference's files hold.  ``stacks``
        replaces the rank's (trains, opts) -- with every node's rows, under
        a mesh."""
        trains, opts = stacks or (self._trains, self._opts)
        state = {"gbar": self.gbar, "train": trains, "opt": opts}
        if keys:
            state["keys"] = tuple(jax_keys(m, self.fed.seed)
                                  for m in self._buckets)
        if self._server_m is not None:
            state["server_m"] = self._server_m
        part = getattr(self, "_part_state", None)
        if part is not None:
            if keys:
                key = jax_key_layout(self._part_plan.seed)
                part = ({"ctl": dict(part["ctl"], key=key),
                         "buf": part["buf"]} if "ctl" in part
                        else dict(part, key=key))
            state["part"] = part
        return state

    def save(self, path: str) -> None:
        """The reference's checkpoint of the block carry (step = rounds
        run) with its meta (``server_momentum``, ``n_buckets``,
        ``round_schedule``, ``participation``), plus every generator's
        state under ``torch_generators``: a save at a block boundary holds
        everything a resumed run needs to continue bit for bit, the cohort
        stream included.  Under a mesh, collective: the state and the
        generators are gathered and rank 0 writes the file (one file
        system: every rank reads it back); every rank returns once it is
        written, or once rank 0's write has failed."""
        part_gen = getattr(self, "_part_gen", None)
        gens = {i: _gen_states([self._nodes[i]["gen"]])[0]
                for i in self._own_nodes()}
        state = self._ckpt_state(stacks=(self._gathered(self._trains),
                                         self._gathered(self._opts)))
        if self.engine.mesh is not None:
            parts = [None] * dist.get_world_size(self.engine._group)
            dist.all_gather_object(parts, gens, group=self.engine._group)
            gens = {i: g for part in parts for i, g in part.items()}
        try:
            if self.engine.mesh is None or dist.get_rank() == 0:
                save_checkpoint(
                    path, state, step=len(self.history),
                    meta={"server_momentum": self.fed.server_momentum,
                          "n_buckets": len(self._trains),
                          "round_schedule":
                              self.fed.round_lr_schedule is not None,
                          "participation": part_mod.plan_meta(
                              getattr(self, "_part_plan", None)),
                          "torch_generators": {
                              "device": self.device.type,
                              "nodes": [gens[i] for i in
                                        range(self.fed.n_nodes)],
                              "participation": _gen_states(
                                  [part_gen])[0]}})
        finally:
            self._barrier()

    def restore(self, path: str) -> int:
        """Load a checkpoint of either package (same config and
        ``width_bucketing``) into the live state tensors, in place, so
        captured graphs stay valid and nothing is captured anew; returns
        its step.  A mismatched ``server_momentum`` or ``round_schedule``
        raises ``ValueError``.  The file's plan is installed (its sampler
        state continues), or a stale one dropped.  Generators continue
        from the file's states, or restart from their construction seeds
        when it has none for this device type (a JAX file).  Under a mesh,
        collective: every rank reads the file and keeps its rows; the
        bucket layout, and so the mesh's shard count where the layout fell
        back to one bucket, must be the file's."""
        meta = read_meta(path)
        if meta.get("server_momentum") != self.fed.server_momentum:
            raise ValueError(
                f"checkpoint server_momentum={meta.get('server_momentum')} "
                f"does not match config {self.fed.server_momentum}; the "
                f"block carry structure differs")
        if bool(meta.get("round_schedule", False)) != \
                (self.fed.round_lr_schedule is not None):
            raise ValueError(
                f"checkpoint round_schedule="
                f"{bool(meta.get('round_schedule', False))} does not match "
                f"config round_lr_schedule="
                f"{self.fed.round_lr_schedule is not None}; the optimizer "
                f"carry structure (round counter) differs")
        plan = part_mod.plan_from_meta(meta.get("participation"))
        if plan is None:
            self._part_plan = self._part_state = self._part_gen = None
        else:
            self._ensure_participation(plan)
        every = tuple(tree_map(lambda t: None if t is None else t.new_empty(
            (t.shape[0] * self.engine._shards,) + t.shape[1:]), s)
            for s in (self._trains, self._opts))
        state, step = load_checkpoint(path, self._ckpt_state(stacks=every))
        state = dict(state, train=self.engine._local(state["train"]),
                     opt=self.engine._local(state["opt"]))
        copy_into(self._ckpt_state(keys=False), state)
        gens = _saved_gens(meta, self.device)
        for i, node in enumerate(self._nodes):
            _set_gen(node["gen"], gens and gens["nodes"][i],
                     stream(self.device, self.fed.seed, "data", i))
        if self._part_gen is not None:
            _set_gen(self._part_gen, gens and gens["participation"],
                     stream(self.device, plan.seed, "participation"))
        self._views_stale = True
        return step

    # ------------------------------------------------------------------
    def _unpad_node_tree(self, tree: dict, node: dict) -> dict:
        """One node's slice of a stacked tree without the padding: the
        sequential round's ragged structure."""
        tree = dict(tree)
        d = self.tokenizers[node["modality"]].d_out
        tree["adapter"] = {"w": tree["adapter"]["w"][:d]}
        if "adapter2" in tree:
            if node["bridge"]:
                d2 = self.tokenizers[node["modality2"]].d_out
                tree["adapter2"] = {"w": tree["adapter2"]["w"][:d2]}
            else:
                del tree["adapter2"]
        return tree

    def _refresh_node_views(self) -> None:
        """Per-node copies of the stacked state: node i is row r of bucket
        b (under a mesh, of the gathered stacks)."""
        trains, opts = self._gathered(self._trains), self._gathered(
            self._opts)
        for i, node in enumerate(self._nodes):
            b, r = self._node_bucket[i]
            row = (lambda t: None if t is None else t[r].clone())
            node["trainable"] = self._unpad_node_tree(
                tree_map(row, trains[b]), node)
            opt = opts[b]
            node["opt_state"] = {
                "m": self._unpad_node_tree(tree_map(row, opt["m"]), node),
                "v": self._unpad_node_tree(tree_map(row, opt["v"]), node),
                "step": opt["step"][r].clone()}
            if "round" in opt:
                node["opt_state"]["round"] = opt["round"][r].clone()


__all__ = ["FederationConfig", "SequentialFederation", "Federation"]
