"""The step functions of the launch layer: the port of
``repro.launch.steps`` without a mesh.

- ``make_prefill_step`` / ``make_decode_step``: ``T.prefill`` with room
  for the prompt (plus the image positions for vlm) and 128 more, then
  the single-position ``T.decode_step`` -- the reference's legacy decode
  loop (``naive_generate``'s step, ``examples/serve_decode.py
  --legacy``).
- ``make_lm_train_step``: one full-parameter step, cross-entropy plus
  0.01 (load_balance + router_z), and one AdamW update.
- ``make_fed_train_step``: the paper's round in its FedSGD form, folded
  into the node-stacked ``core.engine.RoundEngine`` with one local step
  (E = 1), one width bucket, every trainable leaf shipped and the round's
  batches passed in.  Rows k b_loc:(k + 1) b_loc of the global batch are
  node k's; ``anchors`` (K, A, L), and ``anchor_enc_embeds`` for audio,
  are already per node.  Node k's loss is CE_k + lambda (1 - CKA(G_k,
  G_bar)) + aux_coeff (load_balance_k + router_z_k) (Eq. 3); the
  engine's server step gives the consensus Gram, the LAP precision
  weights (Eq. 6) and the weighted side-car average (Eq. 4 / 5 with one
  local step).  The new train state is row 0 (every leaf is shipped, so
  every row holds the average), the AdamW moments are averaged with the
  same weights and cast back to their dtype, and ``step`` (and ``round``
  where present) come from row 0.

The trunk runs once over the rows of all K nodes, whose trainables ride
a node axis (``lora_matmul``'s node axis), as ``launch.train.LMStep``
does; the moe family runs one node a forward instead, so that each
node's tokens are routed, capacity-limited and counted in the router's
aux values on their own, as under the reference's ``vmap``.  Each step
builds its engine and runs the round eagerly (the reference inlines it,
``jit=False``, into its caller's compilation): no CUDA graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cka as cka_mod
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.federation import (layer_major, merge_params,
                                         per_node_ce, with_dora_terms)
from repro_torch.launch.train import _inputs
from repro_torch.models import transformer as T
from repro_torch.models.common import cross_entropy_loss
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_map


def _none_map(f, *trees):
    return tree_map(lambda *xs: None if xs[0] is None else f(*xs), *trees)


def _grads(loss: torch.Tensor, live):
    """d loss / d every leaf of ``live``; zeros where a leaf is not on the
    loss's path (JAX's gradient there)."""
    leaves = tree_leaves(live)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter(torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, got))
    return tree_map(lambda t: None if t is None else next(grads), live)


class _FedStep:
    """The engine's local step for the FedSGD round: every node's one step
    at once.  The gradient of the sum of the nodes' losses is each node's
    own (their trainables are separate rows of the node axis); AdamW then
    steps each node on its own (``update_stacked``)."""

    def __init__(self, cfg: ModelConfig, rt: T.Runtime, frozen: dict,
                 opt: AdamW, lambda_geo: float, aux_coeff: float):
        self.cfg, self.rt, self.opt = cfg, rt, opt
        self.lambda_geo, self.aux_coeff = lambda_geo, aux_coeff
        self.frozen = with_dora_terms(frozen)

    def _nodes(self, live, b: dict, lo: int, hi: int) -> tuple:
        """Nodes lo..hi - 1 through the trunk: their task loss, router aux
        and pooled activations, their anchors' pooled rows, accuracy."""
        cfg, rt, n = self.cfg, self.rt, hi - lo
        params = merge_params(
            layer_major(_none_map(lambda t: t[lo:hi], live)), self.frozen)

        def rows(x):
            return x[lo:hi].reshape((-1,) + tuple(x.shape[2:]))

        batch = _inputs(params, b["tokens"][lo:hi])
        batch.update({name: rows(v) for name, v in b.items()
                      if name not in ("tokens", "labels")
                      and not name.startswith("anchor")})
        logits, aux = T.forward(params, batch, cfg, rt=rt)
        labels = b["labels"][lo:hi].reshape(n, -1)
        logits = logits.reshape(n, -1, logits.shape[-1])
        anchor = _inputs(params, b["anchors"][lo:hi])
        if "anchor_enc_embeds" in b:                       # audio anchors
            anchor["enc_embeds"] = rows(b["anchor_enc_embeds"])
        pooled_a = T.pooled(params, anchor, cfg, rt=rt)
        return (per_node_ce(logits, labels),
                (aux["load_balance"] + aux["router_z"]).expand(n),
                aux["pooled"].reshape(n, -1, aux["pooled"].shape[-1]),
                pooled_a.reshape(n, -1, pooled_a.shape[-1]),
                (logits.argmax(-1) == labels).float().mean(-1))

    def __call__(self, trains, opts, gbar, statics, batch):
        (tr,), (op,), (b,) = trains, opts, batch
        live = _none_map(lambda t: t.detach().requires_grad_(), tr)
        k = b["tokens"].shape[0]
        spans = ([(i, i + 1) for i in range(k)] if self.cfg.family == "moe"
                 else [(0, k)])
        task, aux, pooled, pooled_a, acc = (
            torch.cat(parts) for parts in zip(*(self._nodes(live, b, lo, hi)
                                                for lo, hi in spans)))
        geo = cka_mod.geo_alignment_loss(pooled_a, gbar)
        loss = task + self.lambda_geo * geo + self.aux_coeff * aux
        new_tr, new_op = self.opt.update_stacked(_grads(loss.sum(), live),
                                                 op, tr)
        return (new_tr,), (new_op,), {
            "task": task.detach(), "geo": geo.detach(), "acc": acc,
            "pooled": pooled.detach(), "pooled_a": pooled_a.detach()}


def make_fed_train_step(cfg: ModelConfig, rt: T.Runtime, opt: AdamW, *,
                        k_nodes: int, lambda_geo: float = 1.0,
                        aux_coeff: float = 0.01) -> Callable:
    """``step(trainable, frozen, opt_state, batch, gbar) -> (trainable,
    opt_state, gbar, {"task", "geo"})``: one FedSGD round of ``k_nodes``
    nodes (see the module docstring); ``task`` and ``geo`` are the nodes'
    means."""
    ecfg = EngineConfig(n_nodes=k_nodes, local_steps=1,
                        aggregation="precision")

    def step(trainable, frozen, opt_state, batch, gbar):
        # every trainable leaf ships; one width bucket
        shipped = _none_map(lambda _: True, trainable)
        engine = RoundEngine(ecfg, _FedStep(cfg, rt, frozen, opt, lambda_geo,
                                            aux_coeff),
                             (shipped,), device=gbar.device)

        def bcast(x):
            return x.expand(k_nodes, *x.shape).contiguous()

        def node_split(name, x):
            if name.startswith("anchor"):
                return x                                   # already (K, ...)
            return x.reshape((k_nodes, x.shape[0] // k_nodes)
                             + tuple(x.shape[1:]))

        batches = {n: node_split(n, v)[None] for n, v in batch.items()}
        node_opt = {"m": _none_map(bcast, opt_state["m"]),
                    "v": _none_map(bcast, opt_state["v"]),
                    "step": bcast(opt_state["step"])}
        if "round" in opt_state:       # global-round LR schedule counter
            node_opt["round"] = bcast(opt_state["round"])
        trains, opts, new_gbar, _, metrics = engine._round(
            (_none_map(bcast, trainable),), (node_opt,), gbar, None, (None,),
            (batches,))
        w = metrics["weights"].float()

        def wavg(x):
            return torch.tensordot(w, x.float(), dims=1).to(x.dtype)

        new_opt = {"m": _none_map(wavg, opts[0]["m"]),
                   "v": _none_map(wavg, opts[0]["v"]),
                   "step": opts[0]["step"][0]}
        if "round" in opts[0]:
            new_opt["round"] = opts[0]["round"][0]
        return (_none_map(lambda x: x[0], trains[0]), new_opt, new_gbar,
                {"task": metrics["task"].mean(),
                 "geo": metrics["geo"].mean()})

    return step


def make_lm_train_step(cfg: ModelConfig, rt: T.Runtime, opt: AdamW,
                       trainable_only: bool = False) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, ce)``: the
    plain LM step (the FedAvg-full baseline, centralised training) on
    every parameter.  ``trainable_only`` is taken and not read, as in the
    reference."""
    def step(params, opt_state, batch):
        live = _none_map(lambda t: t.detach().requires_grad_(), params)
        logits, aux = T.forward(live, batch, cfg, rt=rt)
        ce = cross_entropy_loss(logits, batch["labels"])
        loss = ce + 0.01 * (aux["load_balance"] + aux["router_z"])
        new_params, new_opt = opt.update(_grads(loss, live), opt_state,
                                         params)
        return new_params, new_opt, ce.detach()
    return step


def make_prefill_step(cfg: ModelConfig, rt: T.Runtime) -> Callable:
    """``step(params, batch) -> (logits, cache)``: ``T.prefill`` with
    ``_prefill_cache_len`` positions of cache."""
    def step(params, batch):
        return T.prefill(params, batch, cfg,
                         cache_len=_prefill_cache_len(batch, cfg), rt=rt)
    return step


def _prefill_cache_len(batch, cfg) -> int:
    s = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "image_embeds" in batch:
        s += batch["image_embeds"].shape[1]
    return s + 128          # decode headroom


def make_decode_step(cfg: ModelConfig, rt: T.Runtime) -> Callable:
    """``step(params, cache, batch) -> (logits, cache)``: one
    ``T.decode_step``, which writes into ``cache``'s tensors in place."""
    def step(params, cache, batch):
        return T.decode_step(params, cache, batch, cfg, rt=rt)
    return step


__all__ = ["make_fed_train_step", "make_lm_train_step", "make_prefill_step",
           "make_decode_step"]
