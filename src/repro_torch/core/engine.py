"""The node-stacked federated round engine: the port of
``repro.core.engine.RoundEngine`` for full participation on one device.

A round is E local steps for all K nodes at once, then the whole server
step (consensus Gram, LAP precision weights, side-car average, optional
FedAvgM).  Per-node trainables and AdamW states are stacked on a leading
node axis, one stack per width bucket (``bucket_sizes``; the rows of all
buckets concatenated are the engine's rows, ``node_perm`` maps them to
canonical node ids).  The caller's ``local_step`` owns the loss; the engine
owns the round loop and the server math.

Where the reference compiles a round (``jit``) and a block of M rounds
(``lax.scan`` over rounds) into one dispatch each, the port captures each
into one CUDA graph and replays it:

- the state (trainables, AdamW moments, consensus Gram, server momentum)
  is the caller's tensors, updated in place (``copy_``) at the end of the
  captured work, so every replay reads and writes the same buffers;
- the per-round batches are staged inputs (see ``data.synthetic``): the
  caller draws them before the call and the engine copies them into the
  graph's input buffers before the replay;
- a graph is captured once per block size M, after one warm-up run of the
  same work on a side stream (the state is restored after it); a capture
  that fails raises, there is no eager fallback on the card.  A changed
  set of state or statics tensors is captured anew;
- the metrics of the M rounds come back in one readback per block, and
  ``tap`` fires once per round on the host from it.

On the CPU the same round body runs eagerly (the tests' path).  The
capture, and how it keeps the kernels' launch counters exact through
replays, is ``repro_torch.graphs``'s, shared with the serving engine.

Not ported: participation plans and async rounds (``_round_part``,
``_round_async``), in-block checkpoints (``state_tap``), ``mesh=``; they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import graphs
from repro_torch.core import aggregation as agg
from repro_torch.core import cka as cka_mod
from repro_torch.core import uncertainty as unc
from repro_torch.graphs import COUNTED
from repro_torch.kernels.gram import cosine_gram
from repro_torch.tree import copy_into, tree_leaves, tree_map

SCALARS = ("task", "geo", "acc")

# local_step(trains, opts, gbar, statics, batch) -> (trains, opts, aux): one
# local step of every node; trains / opts / statics / batch are tuples per
# bucket whose leaves lead with the bucket's node axis; aux holds "pooled"
# (K, B, D), "pooled_a" (K, Ba, D) and the SCALARS (K,) in engine-row order.
LocalStep = Callable[..., Tuple[Any, Any, dict]]


@dataclass(frozen=True)
class EngineConfig:
    n_nodes: int
    local_steps: int
    aggregation: str = "precision"     # precision | uniform
    center_cka: bool = False
    # per-bucket node counts (sum n_nodes); () is one bucket of all nodes
    bucket_sizes: Tuple[int, ...] = ()
    # canonical node id of each engine row; () is the identity
    node_perm: Tuple[int, ...] = ()
    # FedAvgM coefficient on the round's pseudo-gradient; None is off (no
    # carried server state), 0.0 carries it and reduces to the average
    server_momentum: Optional[float] = None


def pad_axis(x: torch.Tensor, width: int, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` to ``width``.  Exact for the round: padded
    input columns are zero, so padded weight rows get zero gradients and
    stay zero under AdamW without weight decay."""
    axis = axis % x.dim()
    n = x.shape[axis]
    if n > width:
        raise ValueError(f"axis {axis} has {n} > target width {width}")
    if n == width:
        return x
    pads = [0, 0] * (x.dim() - axis - 1) + [0, width - n]
    return torch.nn.functional.pad(x, pads)


def stack_nodes(trees) -> Any:
    """Structurally identical per-node trees stacked on a new leading node
    axis (None leaves pass through)."""
    return tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs),
                    *trees)


def _index(tree, i: int):
    return tree_map(lambda t: None if t is None else t[i], tree)


def _safe_tap(fn, *args) -> None:
    """Taps are observability: an exception in one is logged and dropped."""
    try:
        fn(*args)
    except Exception:
        logging.getLogger("repro_torch.engine").exception(
            "engine tap callback raised; payload dropped")


@dataclass
class _Captured:
    graph: graphs.Captured    # out: (M, 4K + 1) packed metrics
    signature: tuple
    batches: Any              # the graph's input buffers


class RoundEngine:
    """One federated round -- and a block of M rounds -- as one replay.

    The round state is ``(trains, opts, gbar, server_m)``: tuples per bucket
    of node-stacked trees, the consensus Gram and the FedAvgM momentum tree
    (None when off).  ``run_block`` updates it in place.  Per-round metrics
    are ``{"task", "geo", "acc", "weights": K floats, "cross_node_cka":
    float}`` in canonical node order."""

    def __init__(self, ecfg: EngineConfig, local_step: LocalStep,
                 shipped_masks, *, device, mesh=None):
        if mesh is not None:
            raise NotImplementedError("RoundEngine(mesh=): the sharded round "
                                      "is not ported yet")
        if ecfg.aggregation not in ("precision", "uniform"):
            raise ValueError(f"unknown aggregation {ecfg.aggregation!r}")
        self.ecfg = ecfg
        self.local_step = local_step
        self.shipped_masks = tuple(shipped_masks)
        self.bucket_sizes = ecfg.bucket_sizes or (ecfg.n_nodes,)
        if sum(self.bucket_sizes) != ecfg.n_nodes:
            raise ValueError(f"bucket_sizes {self.bucket_sizes} do not sum "
                             f"to n_nodes={ecfg.n_nodes}")
        if len(self.shipped_masks) != len(self.bucket_sizes):
            raise ValueError(f"{len(self.shipped_masks)} shipped masks for "
                             f"{len(self.bucket_sizes)} buckets")
        perm = ecfg.node_perm or tuple(range(ecfg.n_nodes))
        if sorted(perm) != list(range(ecfg.n_nodes)):
            raise ValueError(f"node_perm {perm} is not a permutation")
        inv = [0] * ecfg.n_nodes
        for row, node in enumerate(perm):
            inv[node] = row
        self._inv_perm = (None if list(perm) == sorted(perm) else
                          torch.tensor(inv, dtype=torch.long, device=device))
        self._graphs = {}
        #: captures, replays and device readbacks so far
        self.stats = {"captures": 0, "replays": 0, "readbacks": 0}

    # ------------------------------------------------------------------
    def _grams_of(self, pooled_a: torch.Tensor) -> torch.Tensor:
        """(K, Ba, D) -> (K, Ba, Ba) anchor Grams: one launch of the gram
        kernel for every node."""
        return cosine_gram(pooled_a.contiguous())

    def _unpermute(self, x: torch.Tensor) -> torch.Tensor:
        """Engine-row order -> canonical node order."""
        return x if self._inv_perm is None else x[self._inv_perm]

    # ---- server-side FedOpt ------------------------------------------
    def init_server_state(self, trains):
        """Zero FedAvgM momentum shaped like one node's shipped leaves (f32,
        None elsewhere); None when the knob is off."""
        if self.ecfg.server_momentum is None:
            return None
        return tree_map(lambda l, m: None if l is None or not m else
                        torch.zeros(l.shape[1:], dtype=torch.float32,
                                    device=l.device),
                        trains[0], self.shipped_masks[0])

    def _server_prev(self, trains):
        """What the server broadcast last round: the shipped rows are equal
        at round start, so row 0 of bucket 0 (f32)."""
        return tree_map(lambda l, m: None if l is None or not m
                        else l[0].float(), trains[0], self.shipped_masks[0])

    def _apply_server_momentum(self, prev, total, server_m):
        """FedAvgM: m = beta m + (prev - avg); the server broadcasts
        prev - m (beta 0: the plain average)."""
        beta = float(self.ecfg.server_momentum)
        new_m = tree_map(lambda sm, p, t: None if t is None
                         else beta * sm + (p - t), server_m, prev, total)
        new_val = tree_map(lambda p, m_: None if p is None else p - m_,
                           prev, new_m)
        return new_m, new_val

    # ------------------------------------------------------------------
    def _local_epochs(self, trains, opts, gbar, statics, batches):
        """E local steps of every node (a loop where the reference scans);
        ``batches[b]`` leads with (E, k_b).  The optimizer's round counter,
        where it has one, moves once per round.  Returns the state and the
        last step's aux, what the server reads."""
        opts = tuple(dict(o, round=o["round"] + 1) if "round" in o else o
                     for o in opts)
        last = None
        for e in range(self.ecfg.local_steps):
            trains, opts, last = self.local_step(
                trains, opts, gbar, statics, tuple(_index(b, e)
                                                   for b in batches))
        return trains, opts, last

    def _round(self, trains, opts, gbar, server_m, statics, batches):
        k = self.ecfg.n_nodes
        prev = None if server_m is None else self._server_prev(trains)
        trains, opts, last = self._local_epochs(trains, opts, gbar, statics,
                                                batches)
        grams = self._grams_of(last["pooled_a"])
        new_gbar = cka_mod.consensus_gram(grams)
        if self.ecfg.aggregation == "precision":
            weights = unc.precision_weights(unc.batched_precisions(
                last["pooled"], last["pooled_a"]))
        else:
            weights = torch.full((k,), 1.0 / k, device=gbar.device)
        if server_m is None:
            trains = agg.weighted_average_bucketed(
                trains, weights, self.shipped_masks, self.bucket_sizes)
        else:
            total = agg.bucketed_partial_sums(
                trains, weights, self.shipped_masks, self.bucket_sizes)
            server_m, new_val = self._apply_server_momentum(prev, total,
                                                            server_m)
            trains = agg.broadcast_into_buckets(trains, self.shipped_masks,
                                                new_val)
        metrics = {name: self._unpermute(last[name].float())
                   for name in SCALARS}
        metrics["weights"] = self._unpermute(weights)
        metrics["cross_node_cka"] = cka_mod.mean_offdiag_cka(
            grams, center=self.ecfg.center_cka)
        return trains, opts, new_gbar, server_m, metrics

    @staticmethod
    def _pack(metrics: dict) -> torch.Tensor:
        return torch.cat([metrics[n] for n in SCALARS + ("weights",)]
                         + [metrics["cross_node_cka"].reshape(1)])

    def _unpack(self, row: list) -> dict:
        k = self.ecfg.n_nodes
        out = {n: row[j * k:(j + 1) * k]
               for j, n in enumerate(SCALARS + ("weights",))}
        out["cross_node_cka"] = row[-1]
        return out

    def _block(self, m: int, state, statics, batches) -> torch.Tensor:
        """m rounds from ``state``, written back into it; the packed
        metrics (m, 4K + 1)."""
        trains, opts, gbar, server_m = state
        rows = []
        for i in range(m):
            trains, opts, gbar, server_m, metrics = self._round(
                trains, opts, gbar, server_m, statics,
                tuple(_index(b, i) for b in batches))
            rows.append(self._pack(metrics))
        copy_into(state, (trains, opts, gbar, server_m))
        return torch.stack(rows)

    # ---- CUDA graphs ---------------------------------------------------
    @staticmethod
    def _signature(state, statics) -> tuple:
        return tuple(t.data_ptr() for t in tree_leaves((state, statics)))

    def capture(self, m: int, state, statics, batches) -> None:
        """Capture the m-round block on the card (``graphs.capture``: one
        warm-up run, the state restored after it, then the capture).
        Raises if the capture fails."""
        inputs = tree_map(lambda t: None if t is None else t.clone(),
                          batches)

        def run():
            with torch.enable_grad():
                return self._block(m, state, statics, inputs)

        self._graphs[m] = _Captured(graphs.capture(run, tree_leaves(state)),
                                    self._signature(state, statics), inputs)
        self.stats["captures"] += 1

    def captured_launches(self, m: int) -> dict:
        """Launches per wrapper that one replay of the m-round graph makes."""
        return self._graphs[m].graph.launches_by_name()

    def _replay(self, m: int, state, statics, batches) -> torch.Tensor:
        entry = self._graphs.get(m)
        if entry is None or entry.signature != self._signature(state,
                                                                statics):
            self.capture(m, state, statics, batches)
            entry = self._graphs[m]
        copy_into(entry.batches, batches)
        out = entry.graph.replay()
        self.stats["replays"] += 1
        return out

    # ------------------------------------------------------------------
    def run_block(self, state, m: int, *, statics, batches, tap=None,
                  state_tap=None, eager: bool = False):
        """Run m rounds on ``state`` in place: one graph replay on the card
        (``eager``: the same work without the graph, a replay's oracle),
        eagerly on the CPU.  ``batches`` is a tuple per bucket of trees
        whose leaves lead with (m, E, k_b).  Reads the device once; returns
        ``(state, metrics)``, metrics a list of m per-round dicts, and calls
        ``tap(metrics of round i, with "round_in_block": i)`` once per
        round."""
        if state_tap is not None:
            raise NotImplementedError("in-block checkpoints (state_tap) wait "
                                      "for the port of checkpoint/")
        if m < 1:
            raise ValueError(f"block size must be >= 1, got {m}")
        if state[2].device.type == "cuda" and not eager:
            out = self._replay(m, state, statics, batches)
        else:
            with torch.enable_grad():
                out = self._block(m, state, statics, batches)
        host = out.tolist()                                  # one readback
        self.stats["readbacks"] += 1
        metrics = [self._unpack(row) for row in host]
        if tap is not None:
            for i, rec in enumerate(metrics):
                _safe_tap(tap, dict(rec, round_in_block=i))
        return state, metrics


__all__ = ["EngineConfig", "RoundEngine", "pad_axis", "stack_nodes",
           "COUNTED"]
