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

Not ported yet: the node-stacked ``Federation`` / ``RoundEngine``,
participation plans and ``run_rounds``, async rounds, ``save`` /
``restore``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, get_config
from repro_torch.configs.fedmm_base import MODALITY_TOKENIZER_DIMS
from repro_torch.core import aggregation as agg
from repro_torch.core import cka as cka_mod
from repro_torch.core import lora as lora_mod
from repro_torch.core import uncertainty as unc
from repro_torch.data.synthetic import SyntheticMultimodal, stream
from repro_torch.data.tokenizers import default_tokenizers
from repro_torch.models import transformer as T
from repro_torch.models.common import cross_entropy_loss, linear, make_linear
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_map

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


def _detach_named(tree, names=("dora_m",)):
    """``tree`` with the leaves called ``names`` detached."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node is None or name not in names:
            return node
        return node.detach()
    return walk(tree, "")


def _shipped(trainable: dict) -> dict:
    """The uplink view of a node's trainables: shipped leaves, None
    elsewhere, and no key whose subtree ships nothing (a bridge node's
    ``adapter2``)."""
    mask = lora_mod.shipped_mask(trainable)
    view = tree_map(lambda p, m: p if m else None, trainable, mask)
    return {k: v for k, v in view.items() if tree_leaves(v)}


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
        """Intra-node InfoNCE on locally PAIRED samples (bridge clients)."""
        z1 = z1 / torch.linalg.norm(z1, dim=-1, keepdim=True).clamp_min(1e-8)
        z2 = z2 / torch.linalg.norm(z2, dim=-1, keepdim=True).clamp_min(1e-8)
        sim = (z1 @ z2.T) / tau
        labels = torch.arange(z1.shape[0], device=z1.device)
        return 0.5 * (cross_entropy_loss(sim, labels)
                      + cross_entropy_loss(sim.T, labels))

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
        for i, node in enumerate(self.nodes):
            if active is not None and i not in active:
                continue
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
            metrics.append(torch.stack([last["task"], last["geo"],
                                        last["acc"]]))
            # upload: Gram + precision + shipped side-cars
            grams.append(cka_mod.cosine_gram(last["pooled_a"]))
            precisions.append(unc.node_precision(unc.lap_uncertainty(
                last["pooled"], last["pooled_a"])))
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
        avg = agg.aggregate_geolora(shipped_list, weights)
        # broadcast to every node, participants or not
        for node in self.nodes:
            mask = lora_mod.shipped_mask(node["trainable"])
            node["trainable"] = {
                k: tree_map(lambda p, s, sm: s if sm else p, v, avg[k],
                            mask[k]) if k in avg else v
                for k, v in node["trainable"].items()}

        off_diag = cka_mod.mean_offdiag_cka(grams, center=fed.center_cka)
        host = torch.cat([torch.stack(metrics).T.reshape(-1), weights,
                          off_diag[None]]).tolist()          # one readback
        task, geo, acc = (host[j * k_active:(j + 1) * k_active]
                          for j in range(3))
        weights = host[3 * k_active:4 * k_active]
        node0 = self.nodes[0]
        rec = {
            "task_loss": sum(task) / k_active,
            "geo_loss": sum(geo) / k_active,
            "acc": sum(acc) / k_active,
            "cross_node_cka": host[-1],
            "uplink_bytes": agg.comm_bytes_per_round(
                shipped_list[0], gram_side=self.gbar.shape[0]),
            "full_model_bytes": lora_mod.param_bytes(lora_mod.combine(
                node0["trainable"], self._frozen_for(node0))),
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

    def run(self) -> List[dict]:
        """``fed.rounds`` full rounds; returns the history."""
        for _ in range(self.fed.rounds):
            self.run_round()
        return self.history


__all__ = ["FederationConfig", "SequentialFederation"]
