"""The node-stacked federated round engine: the port of
``repro.core.engine.RoundEngine``, on one device or one process per
device (``mesh=``).

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

Participation plans (``core.participation``) have round bodies of their
own, so the full-participation graph stays as it is: ``_round_part``
samples the cohort on the device and runs either the compact path (the
cohort's rows gathered into (c_b, ...) stacks, compute proportional to
C) or the masked path (all K compute, the others' state kept), and
``_round_async`` runs the lag-and-failure simulator, the quarantine
guard, the report buffer and the staleness-weighted server step.  Both
are captured once per (plan, M), as the reference compiles once per
frozen plan.  The cohort of round i + 1 can depend on round i (the
``precision`` strategy's estimates, the async countdowns), so the
sampler runs inside the graph on uniforms staged before the block, and
each node reads its own next round of staged draws through a per-node
count of rounds trained (the caller re-positions the generators from
the readback).

Batches the caller passes per round (the LM driver's, ``per_round_draws``)
are read at slot r by every node in round r, whether it trained before or
not, as the reference hands every node round r's batch.

In-block checkpoints (``run_block(state_tap=)``).  A host write cannot
run inside a replay, so a block of m rounds with a tap every ``e`` rounds
runs as sub-blocks: the e-round graph ``m // e`` times, then the
remainder's graph, each sub-block followed by the tap on the live state.
The tap fires where the reference's in-scan tap fires -- after round
``ridx`` of the block where ``(ridx + 1) % e == 0``, at step
``round_offset + ridx + 1`` -- so a kill loses fewer than e rounds.  The
cost: ``m // e + (m % e > 0)`` replays instead of one, and the tap's
device-to-host copy of the state each time.  The block's metrics still
come back in one readback.  ``tap_spans`` is the one split both callers
use.  The canonical checkpoint path is
``Federation.run_rounds(checkpoint_path=)``: it runs each sub-block as a
block of its own, since each file must hold the data generators
positioned at its round, and writes the files.  ``state_tap`` is the
engine-level hook for a caller that passes its batches per round and
owns no generator to reposition; no caller of the port uses it yet (the
LM driver writes no checkpoints, as in the reference).

``submit_block`` enqueues a block and returns before its readback, so a
driver can stage the next block on the host while the card runs this one
(the reference's double buffering); ``run_block`` is submit then read.

Across processes (``mesh=``, ``launch/mesh.py``).  One process per
device -- NCCL between cards, gloo on the CPU -- and each rank holds its
own slice of every bucket's node axis: rows ``s k_b / R .. (s + 1) k_b /
R`` of bucket b on the rank of shard index s of R (``local_sizes``).  The
three round bodies are the same with a mesh or without one; what a mesh
changes is the server step's traffic, which is exactly the protocol's
uplink, over the batch axes' process group:

- ``_reduce``: one ``all_reduce`` (sum) of a flat f32 buffer packing the
  rank's partial sums -- the Gram sum, the precision (or cohort) sums --
  and then one of the weighted side-car sums, which need the precision
  total first;
- ``_gather_rows``: one ``all_gather_into_tensor`` of the rank's per-node
  rows (the scalars, weights, Grams; under ``async`` the precisions and
  the shipped side-cars, the report buffer's input), shard-major, then one
  static reordering into engine rows.  That is what the reference's
  per-bucket gathers give: a gather of the concatenated rows without the
  reordering would interleave the buckets shard-major and permute the
  per-node weights.

Without a mesh both are the identity, so the single-device round is
unchanged.  The sampler state is replicated: every rank draws the same
cohort (or async events) from the same staged uniforms and takes its own
rows of the mask; under a mesh a sampled round always runs the masked
path, as the reference's does.  The report buffer and the simulator's
arrays stay replicated too, and every rank runs the same full-K async
server step.  Every rank ends a round with the same metrics, so taps fire
on every rank with the full records.  On the card the collectives sit
inside the captured round and block graphs: the warm-up's collectives,
which run in the capture's order on every rank, open the communicator
before the capture.  On the CPU (gloo) the sharded round runs eagerly.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import graphs
from repro_torch.core import aggregation as agg
from repro_torch.core import cka as cka_mod
from repro_torch.core import participation as part_mod
from repro_torch.core import uncertainty as unc
from repro_torch.graphs import COUNTED
from repro_torch.kernels.gram import cosine_gram
from repro_torch.tree import copy_into, tree_leaves, tree_map

SCALARS = ("task", "geo", "acc")


def auto_block_size(dispatch_s: float, round_s: float, *,
                    target: float = 0.05, cap: int = 64) -> int:
    """Pick the fused-block size M from measured host dispatch overhead:
    the per-round host work under M-round blocks is ~``dispatch_s / M``,
    so the smallest M with ``dispatch_s / M < target * round_s`` keeps
    host work under ``target`` (default 5%) of round time.  Clamped to
    [1, cap]; degenerate measurements (zero/negative round time) take the
    cap.  Drivers measure once at startup (``--block-size auto``)."""
    if round_s <= 0 or dispatch_s <= 0:
        return cap if round_s <= 0 else 1
    m = math.ceil(dispatch_s / (target * round_s))
    return max(1, min(int(m), cap))


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
    # under a plan, which staged round a node reads: False, its own count
    # of rounds trained in the block (Federation: each node's k-th round
    # of draws); True, the round's index (batches passed per round)
    per_round_draws: bool = False


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


def masked_select(mask: torch.Tensor, new_tree, old_tree):
    """Per-row selection under a participation mask: rows with ``mask > 0``
    take the advanced value, the others keep the old one -- what makes a
    straggler's round a no-op on every piece of its state.  Leaves lead
    with the node-row axis."""
    def sel(new, old):
        if new is None:
            return None
        m = mask.reshape((mask.shape[0],) + (1,) * (new.dim() - 1)) > 0
        return torch.where(m, new, old)
    return tree_map(sel, new_tree, old_tree)


def _gather(tree, idx: torch.Tensor):
    return tree_map(lambda t: None if t is None else t.index_select(0, idx),
                    tree)


def _scatter(full, part, idx: torch.Tensor):
    """``full`` with rows ``idx`` replaced by ``part``'s (out of place)."""
    return tree_map(lambda f, p: None if f is None else f.index_copy(0, idx,
                                                                     p),
                    full, part)


def _pick_draws(batches, slots: torch.Tensor, rows: torch.Tensor):
    """Staged draws (M, E, k_b, ...) -> (E, n, ...): row ``rows[j]``'s draws
    of its round ``slots[j]``, its own count of rounds trained so far in
    the block -- so a node trains on its k-th round of draws whatever
    the cohort schedule."""
    return tree_map(lambda x: None if x is None
                    else x[slots, :, rows].transpose(0, 1), batches)


def tap_spans(m: int, every: int) -> list:
    """The sub-blocks of an m-round block with a state tap every ``every``
    rounds: ``(start, rounds, tap)`` each, ``tap`` true after a full one
    -- after round ``ridx`` of the block where ``(ridx + 1) % every ==
    0``, as the reference's in-scan tap fires."""
    return [(s, min(every, m - s), min(every, m - s) == every)
            for s in range(0, m, every)]


def _safe_tap(fn, *args) -> None:
    """Taps are observability: an exception in one is logged and dropped."""
    try:
        fn(*args)
    except Exception:
        logging.getLogger("repro_torch.engine").exception(
            "engine tap callback raised; payload dropped")


#: per-node fields of a participation round's packed metrics, after SCALARS
#: and the weights; the async round adds ASYNC_FIELDS
ASYNC_FIELDS = ("delivered", "staleness", "quarantined")


@dataclass
class _Captured:
    graph: graphs.Captured    # out: (M, F) packed metrics
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
        self._row_of_node = tuple(inv)
        # canonical node ids per bucket (row order) and each bucket's first
        # row: the participation sampler's groups
        groups, offs, off = [], [], 0
        for kb in self.bucket_sizes:
            groups.append(tuple(perm[off:off + kb]))
            offs.append(off)
            off += kb
        self._groups, self._bucket_offsets = tuple(groups), tuple(offs)
        self.device = torch.device(device)
        self.mesh, self._shards, self._shard = mesh, 1, 0
        if mesh is not None:
            self._shard_over(mesh)
        #: the rows of each bucket this rank holds (all without a mesh)
        self.local_sizes = tuple(kb // self._shards
                                 for kb in self.bucket_sizes)
        self._plan_consts = {}
        self._graphs = {}
        #: captures, replays and device readbacks so far
        self.stats = {"captures": 0, "replays": 0, "readbacks": 0}

    def _shard_over(self, mesh) -> None:
        """Split each bucket's node axis over the mesh's batch axes: check
        that every bucket divides (the reference's ``ValueError``), then
        take the batch group, this rank's shard index and the order that
        takes a shard-major gather to engine rows."""
        from repro_torch.launch import mesh as mesh_mod
        axes = mesh_mod.batch_axes(mesh)
        if not axes:
            raise ValueError("mesh has no batch axes to map nodes onto")
        n = mesh_mod.n_nodes(mesh)
        for b, kb in enumerate(self.bucket_sizes):
            if kb % n:
                raise ValueError(f"bucket {b} has {kb} nodes, not divisible "
                                 f"by the {n} mesh batch slices {axes}")
        self._group = mesh_mod.batch_group(mesh)
        self._shards, self._shard = n, mesh_mod.shard_index(mesh)
        # gathered position of engine row off_b + s k_b/R + j: shard s's
        # block of K/R rows, bucket b's slice of it, row j
        k_loc, order = self.ecfg.n_nodes // n, []
        for off, kb in zip(self._bucket_offsets, self.bucket_sizes):
            loc = kb // n
            order += [s * k_loc + off // n + j for s in range(n)
                      for j in range(loc)]
        self._gather_order = torch.tensor(order, dtype=torch.long,
                                          device=self.device)

    # ---- the server step's collectives (identities without a mesh) ----
    def _local(self, per_bucket) -> tuple:
        """This rank's rows of per-bucket (k_b, ...) tensors or trees of
        them."""
        return tuple(tree_map(lambda t, n=n: None if t is None else
                              t[self._shard * n:(self._shard + 1) * n], v)
                     for v, n in zip(per_bucket, self.local_sizes))

    def _reduce(self, *parts) -> list:
        """The sums over the batch group of f32 tensors: one
        ``all_reduce`` of them packed flat."""
        if self.mesh is None:
            return list(parts)
        flat = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(flat, group=self._group)
        return [t.view_as(p) for t, p in zip(
            flat.split([p.numel() for p in parts]), parts)]

    def _reduce_tree(self, tree):
        """``_reduce`` of a tree's leaves (None leaves kept)."""
        leaves = iter(self._reduce(*tree_leaves(tree)))
        return tree_map(lambda t: None if t is None else next(leaves), tree)

    def _gather_rows(self, cols) -> list:
        """(K_loc, ...) per-node columns of this rank -> (K, ...) columns of
        every node in engine-row order: one ``all_gather_into_tensor`` of
        them packed as f32 rows, then the static reordering."""
        if self.mesh is None:
            return list(cols)
        k_loc = sum(self.local_sizes)
        flat = torch.cat([c.float().reshape(k_loc, -1) for c in cols], 1)
        out = flat.new_empty((k_loc * self._shards, flat.shape[1]))
        dist.all_gather_into_tensor(out, flat, group=self._group)
        out = out.index_select(0, self._gather_order)
        widths = [c[0].numel() for c in cols]
        return [t.reshape((-1,) + tuple(c.shape[1:]))
                for t, c in zip(out.split(widths, 1), cols)]

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
        if self.ecfg.aggregation == "precision":
            p = unc.batched_precisions(last["pooled"],
                                       last["pooled_a"]).float().clamp_min(0)
            g_sum, p_sum = self._reduce(grams.sum(0), p.sum())
            weights = p / p_sum.clamp_min(1e-12)
        else:
            (g_sum,) = self._reduce(grams.sum(0))
            weights = torch.full((grams.shape[0],), 1.0 / k,
                                 device=gbar.device)
        new_gbar = g_sum / k
        total = self._reduce_tree(agg.bucketed_partial_sums(
            trains, weights, self.shipped_masks, self.local_sizes))
        if server_m is not None:
            server_m, total = self._apply_server_momentum(prev, total,
                                                          server_m)
        trains = agg.broadcast_into_buckets(trains, self.shipped_masks,
                                            total)
        *scalars, weights, grams = self._gather_rows(
            [last[name].float() for name in SCALARS] + [weights, grams])
        metrics = {name: self._unpermute(v)
                   for name, v in zip(SCALARS, scalars)}
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

    # ---- participation (sampled cohorts, straggler masks) --------------
    def _consts(self, plan) -> dict:
        """A plan's constants on the device, made once and before any
        capture (a host-to-device copy cannot sit in a graph): the fixed
        cohort of a ``nodes`` plan, and the NaN injection row of
        ``poison_nodes`` in engine-row order."""
        c = self._plan_consts.get(plan)
        if c is None:
            c = {}
            if plan.strategy == "nodes":
                c["cohort"] = part_mod.nodes_cohort(plan, self._groups,
                                                    self.device)
            if plan.poison_nodes:
                pm = part_mod.poison_mask(plan, self.ecfg.n_nodes,
                                          self._row_of_node, self.device)
                c["inject"] = torch.where(pm > 0, torch.full_like(
                    pm, float("nan")), torch.zeros_like(pm))
            self._plan_consts[plan] = c
        return c

    def _round_part(self, plan, trains, opts, gbar, server_m, part,
                    statics, batches, u, slots):
        """One round under a ``ParticipationPlan``: the cohort is sampled
        on the device from ``part`` and this round's uniforms ``u``; local
        epochs run only for the cohort (compact path: its rows gathered
        into (c_b, ...) stacks, then scattered back) or run for all and are
        kept only for it (masked path); the whole server step runs over the
        cohort.  Non-reporters keep their trainables, moments, round
        counter and draw slot, then receive the broadcast."""
        k = self.ecfg.n_nodes
        prev = None if server_m is None else self._server_prev(trains)
        if plan.strategy == "nodes":
            row_masks, cohort_rows = self._consts(plan)["cohort"]
        else:
            row_masks, cohort_rows, part = part_mod.sample_rows(
                plan, part, self._groups, u)
        compact = (self.mesh is None and plan.compact
                   and part_mod.static_cohort(plan)
                   and cohort_rows is not None)
        trains, opts = list(trains), list(opts)
        mask_rows = torch.cat(row_masks)
        need_p = (self.ecfg.aggregation == "precision"
                  or plan.strategy == "precision")

        if compact:
            live = [b for b, idx in enumerate(cohort_rows) if idx.shape[0]]
            idx = [cohort_rows[b] for b in live]
            tr_c, op_c, last = self._local_epochs(
                tuple(_gather(trains[b], i) for b, i in zip(live, idx)),
                tuple(_gather(opts[b], i) for b, i in zip(live, idx)), gbar,
                tuple(_gather(statics[b], i) for b, i in zip(live, idx)),
                tuple(_pick_draws(batches[b], slots[b].index_select(0, i), i)
                      for b, i in zip(live, idx)))
            for b, i, t, o in zip(live, idx, tr_c, op_c):
                trains[b] = _scatter(trains[b], t, i)
                opts[b] = _scatter(opts[b], o, i)
            rows_cat = torch.cat([self._bucket_offsets[b] + i
                                  for b, i in zip(live, idx)])
            c = int(rows_cat.shape[0])

            # ---- server over the cohort ----
            grams = self._grams_of(last["pooled_a"])
            new_gbar = cka_mod.consensus_gram(grams)         # C rows only
            p_c = (unc.batched_precisions(last["pooled"], last["pooled_a"])
                   if need_p else None)
            if self.ecfg.aggregation == "precision":
                w_c = unc.precision_weights(p_c)
            else:
                w_c = torch.full((c,), 1.0 / c, device=gbar.device)
            total = agg.bucketed_partial_sums(
                tr_c, w_c, tuple(self.shipped_masks[b] for b in live),
                tuple(int(i.shape[0]) for i in idx))
            if server_m is not None:
                server_m, total = self._apply_server_momentum(prev, total,
                                                              server_m)
            trains = list(agg.broadcast_into_buckets(
                tuple(trains), self.shipped_masks, total))

            def scatter(v):
                return torch.zeros((k,), device=gbar.device).index_copy(
                    0, rows_cat, v.float())
            scalars = {name: scatter(last[name]) for name in SCALARS}
            weights_rows = scatter(w_c)
            xcka = cka_mod.mean_offdiag_cka(grams,
                                            center=self.ecfg.center_cka)
            if p_c is not None:
                part = part_mod.update_state(plan, part, mask_rows,
                                             scatter(p_c))
        else:
            # masked path (always, under a mesh): every row computes, only
            # reporting rows' state advances; this rank's rows of the mask
            masks = self._local(row_masks)
            tr2, op2, last = self._local_epochs(
                tuple(trains), tuple(opts), gbar, statics,
                tuple(_pick_draws(bt, sl, torch.arange(
                    kb, device=gbar.device)) for bt, sl, kb
                      in zip(batches, slots, self.local_sizes)))
            for b, mb in enumerate(masks):
                trains[b] = masked_select(mb, tr2[b], trains[b])
                opts[b] = masked_select(mb, op2[b], opts[b])
            m_loc = torch.cat(masks)
            grams = self._grams_of(last["pooled_a"])
            p_loc = (unc.batched_precisions(
                last["pooled"], last["pooled_a"]).float().clamp_min(0)
                if need_p else None)
            w_num = (m_loc * p_loc if self.ecfg.aggregation == "precision"
                     else m_loc)
            g_num, n_rep, w_sum = self._reduce(
                (m_loc[:, None, None] * grams).sum(0), m_loc.sum(),
                w_num.sum())
            new_gbar = g_num / n_rep.clamp_min(1.0)
            weights = w_num / (w_sum.clamp_min(1e-12)
                               if self.ecfg.aggregation == "precision"
                               else w_sum.clamp_min(1.0))
            total = self._reduce_tree(agg.bucketed_partial_sums(
                tuple(trains), weights, self.shipped_masks,
                self.local_sizes))
            if server_m is not None:
                server_m, total = self._apply_server_momentum(prev, total,
                                                              server_m)
            trains = list(agg.broadcast_into_buckets(
                tuple(trains), self.shipped_masks, total))
            rows = self._gather_rows(
                [last[name].float() for name in SCALARS] + [weights, grams]
                + ([] if p_loc is None else [p_loc]))
            *scalars, weights_rows, grams = rows[:5]
            scalars = {name: v * mask_rows
                       for name, v in zip(SCALARS, scalars)}
            xcka = cka_mod.mean_offdiag_cka(
                grams, center=self.ecfg.center_cka, mask=mask_rows)
            if p_loc is not None:
                part = part_mod.update_state(plan, part, mask_rows, rows[5])

        metrics = {name: self._unpermute(v) for name, v in scalars.items()}
        metrics.update(weights=self._unpermute(weights_rows),
                       cross_node_cka=xcka,
                       participation=self._unpermute(mask_rows),
                       cohort_size=mask_rows.sum())
        slots = tuple(sl + mb.long()
                      for sl, mb in zip(slots, self._local(row_masks)))
        return (tuple(trains), tuple(opts), new_gbar, server_m, part,
                metrics, slots)

    # ---- async (FedBuff-style) rounds ---------------------------------
    def _shipped_rows(self, trains):
        """The shipped leaves of every bucket as one (K, ...) stack per leaf
        (float32, None elsewhere): the report buffer's layout.  Shipped
        shapes are the same in every bucket."""
        parts = [tree_map(lambda l, m_: None if l is None or not m_
                          else l.float(), tree, mask)
                 for tree, mask in zip(trains, self.shipped_masks)]
        return tree_map(lambda *ls: None if ls[0] is None else torch.cat(ls),
                        *parts)

    def init_async_state(self, trains, plan, gram_side: int) -> dict:
        """The carried async state for ``plan``: the simulator's (K,)
        arrays (``ctl``, without the generator, which the caller keeps)
        and the zeroed REPORT BUFFER -- per-node shipped side-cars, anchor
        Grams and LAP precisions (``buf``), shaped from ``trains``."""
        plan = part_mod.normalize(plan)
        if plan is None or plan.strategy != "async":
            raise ValueError("init_async_state needs an async plan")
        k, dev = self.ecfg.n_nodes, self.device
        buf = {"shipped": tree_map(lambda l: None if l is None
                                   else l.new_zeros((k,) + l.shape[1:]),
                                   self._shipped_rows(trains)),
               "gram": torch.zeros((k, gram_side, gram_side),
                                   dtype=torch.float32, device=dev),
               "prec": torch.zeros((k,), dtype=torch.float32, device=dev)}
        ctl = part_mod.device_state(part_mod.init_state(plan, k, dev))
        return {"ctl": ctl, "buf": buf}

    def _async_server(self, plan, trains, start, lag_draw, shipped, grams,
                      prec, buf, ctl, gbar, prev, server_m):
        """The async server step on (K,)-row reports: fault injection, the
        quarantine guard, the buffer write, the staleness-weighted average
        of the reports whose lag expires, and the broadcast.  A round with
        no delivery (or all staled out) keeps the previous broadcast
        value, consensus Gram and momentum: the protocol idles."""
        k = self.ecfg.n_nodes

        def rows(v, like):
            return v.reshape((k,) + (1,) * (like.dim() - 1))

        # fault injection: poison_nodes' uplink reports (never their local
        # state) turn to NaN, which the guard must catch
        if plan.poison_nodes:
            inj = self._consts(plan)["inject"]
            shipped = tree_map(lambda l: None if l is None
                               else l + rows(inj, l), shipped)
            grams, prec = grams + rows(inj, grams), prec + inj

        # the quarantine guard, before anything enters the buffer: a
        # non-finite value anywhere in the report, or an exploded norm
        finite = torch.isfinite(grams.reshape(k, -1)).all(1) \
            & torch.isfinite(prec)
        norm_sq = torch.zeros((k,), device=gbar.device)
        for leaf in tree_leaves(shipped):
            flat = leaf.reshape(k, -1)
            finite = finite & torch.isfinite(flat).all(1)
            norm_sq = norm_sq + (flat.float() ** 2).sum(1)
        qn = float(plan.quarantine_norm)
        bad = ((~finite) | (norm_sq > qn * qn)).float()
        ok = start * (1.0 - bad)
        ctl = dict(ctl, quarantined=ctl["quarantined"]
                   + (start * bad).to(torch.int32))

        # the buffer takes the accepted rows only (a rejected reporter
        # stays idle and retries next round)
        def sel(new, old):
            return torch.where(rows(ok, new) > 0, new, old)
        buf = {"shipped": tree_map(lambda n, o: None if n is None
                                   else sel(n, o), shipped, buf["shipped"]),
               "gram": sel(grams.float(), buf["gram"]),
               "prec": sel(prec.float(), buf["prec"])}
        countdown = torch.where(ok > 0, lag_draw, ctl["countdown"])
        lag = torch.where(ok > 0, lag_draw, ctl["lag"])

        # delivery: the reports whose lag expires this round, weighted by
        # precision x staleness factor, normalised over the deliveries
        delivered = (countdown == 0).float()
        f = unc.staleness_factor(lag, plan.staleness, plan.staleness_alpha,
                                 plan.max_staleness)
        fresh = delivered * (f > 0.0).float()
        base = (buf["prec"] if self.ecfg.aggregation == "precision"
                else torch.ones((k,), device=gbar.device))
        wn = unc.stale_precision_weights(
            base, lag, delivered, plan.staleness, plan.staleness_alpha,
            plan.max_staleness)
        any_del = wn.sum() > 0.0
        total = agg.weighted_average_reports(buf["shipped"], wn)

        def pick(new, old):
            return None if new is None else torch.where(any_del, new, old)
        if server_m is None:
            new_val = tree_map(pick, total, prev)
        else:
            m2, v2 = self._apply_server_momentum(prev, total, server_m)
            server_m = tree_map(pick, m2, server_m)
            new_val = tree_map(pick, v2, prev)
        trains = agg.broadcast_into_buckets(tuple(trains),
                                            self.shipped_masks, new_val)
        new_gbar = cka_mod.consensus_gram(buf["gram"], mask=fresh,
                                          fallback=gbar)
        countdown = torch.where(delivered > 0,
                                torch.full_like(countdown, -1),
                                torch.where(countdown > 0, countdown - 1,
                                            countdown))
        ctl = dict(ctl, countdown=countdown, lag=lag)
        srv = {"weights": wn, "delivered": delivered,
               "staleness": torch.where(delivered > 0, lag.float(),
                                        torch.full_like(delivered, -1.0)),
               "quarantined": ctl["quarantined"].float(),
               "n_delivered": delivered.sum(),
               "cross_node_cka": cka_mod.mean_offdiag_cka(
                   buf["gram"], center=self.ecfg.center_cka, mask=fresh)}
        return trains, new_gbar, server_m, {"ctl": ctl, "buf": buf}, srv

    def _round_async(self, plan, trains, opts, gbar, server_m, part,
                     statics, batches, u, slots):
        """One async round: the simulator decides which idle nodes START
        local work; starters' state advances (masked path), their reports
        enter the buffer through the quarantine guard with a drawn lag,
        and the server averages exactly the reports due this round."""
        prev = self._server_prev(trains)
        start, lag_draw, ctl = part_mod.async_events(plan, part["ctl"], u)
        starts = self._local(torch.split(start, self.bucket_sizes))
        tr2, op2, last = self._local_epochs(
            tuple(trains), tuple(opts), gbar, statics,
            tuple(_pick_draws(bt, sl, torch.arange(kb, device=gbar.device))
                  for bt, sl, kb in zip(batches, slots, self.local_sizes)))
        trains = [masked_select(mb, t, t0)
                  for mb, t, t0 in zip(starts, tr2, trains)]
        opts = tuple(masked_select(mb, o, o0)
                     for mb, o, o0 in zip(starts, op2, opts))
        grams = self._grams_of(last["pooled_a"])
        if self.ecfg.aggregation == "precision":
            prec = unc.batched_precisions(last["pooled"], last["pooled_a"])
        else:
            prec = torch.ones((grams.shape[0],), device=gbar.device)
        # the reports of every node: this rank's rows, gathered
        shipped = self._shipped_rows(trains)
        rows = self._gather_rows(
            [last[name].float() for name in SCALARS] + [grams, prec]
            + tree_leaves(shipped))
        *scalars, grams, prec = rows[:5]
        leaves = iter(rows[5:])
        shipped = tree_map(lambda t: None if t is None else next(leaves),
                           shipped)
        trains, new_gbar, server_m, part, srv = self._async_server(
            plan, trains, start, lag_draw, shipped, grams, prec,
            part["buf"], ctl, gbar, prev, server_m)
        metrics = {name: self._unpermute(v * start)
                   for name, v in zip(SCALARS, scalars)}
        metrics.update(weights=self._unpermute(srv["weights"]),
                       cross_node_cka=srv["cross_node_cka"],
                       participation=self._unpermute(start),
                       cohort_size=start.sum(),
                       n_delivered=srv["n_delivered"],
                       **{n: self._unpermute(srv[n]) for n in ASYNC_FIELDS})
        slots = tuple(sl + mb.long() for sl, mb in zip(slots, starts))
        return trains, opts, new_gbar, server_m, part, metrics, slots

    @staticmethod
    def _part_fields(is_async: bool) -> tuple:
        """A participation round's packed metrics: the (K,) fields, then
        the scalars."""
        return (SCALARS + ("weights", "participation")
                + (ASYNC_FIELDS if is_async else ()),
                ("cross_node_cka", "cohort_size")
                + (("n_delivered",) if is_async else ()))

    def _pack_part(self, metrics: dict) -> torch.Tensor:
        per_node, tail = self._part_fields("delivered" in metrics)
        return torch.cat([metrics[n] for n in per_node]
                         + [metrics[n].reshape(1).float() for n in tail])

    def _unpack_part(self, row: list, plan) -> dict:
        k = self.ecfg.n_nodes
        per_node, tail = self._part_fields(plan.strategy == "async")
        out = {n: row[j * k:(j + 1) * k] for j, n in enumerate(per_node)}
        out.update(zip(tail, row[len(per_node) * k:]))
        return out

    def _block_part(self, plan, m: int, state, statics, inputs
                    ) -> torch.Tensor:
        """m rounds under ``plan`` from ``state`` (its fifth element the
        sampler's device state), written back into it; ``inputs`` is the
        staged draws and the (m, n_u, K) uniforms (None under ``nodes``).
        Returns the packed metrics (m, F)."""
        trains, opts, gbar, server_m, part = state
        batches, uniforms = inputs
        body = (self._round_async if plan.strategy == "async"
                else self._round_part)
        slots = tuple(torch.zeros((kb,), dtype=torch.long,
                                  device=gbar.device)
                      for kb in self.local_sizes)
        rows = []
        for i in range(m):
            trains, opts, gbar, server_m, part, metrics, slots = body(
                plan, trains, opts, gbar, server_m, part, statics, batches,
                None if uniforms is None else uniforms[i], slots)
            if self.ecfg.per_round_draws:
                slots = tuple(torch.full_like(s, i + 1) for s in slots)
            rows.append(self._pack_part(metrics))
        copy_into(state, (trains, opts, gbar, server_m, part))
        return torch.stack(rows)

    # ---- CUDA graphs ---------------------------------------------------
    @staticmethod
    def _signature(state, statics) -> tuple:
        return tuple(t.data_ptr() for t in tree_leaves((state, statics)))

    def capture(self, m: int, state, statics, batches, *, plan=None,
                uniforms=None) -> None:
        """Capture the m-round block (under ``plan``, if given) on the card
        (``graphs.capture``: one warm-up run, the state restored after it,
        then the capture).  Raises if the capture fails."""
        plan = part_mod.normalize(plan)
        inputs = tree_map(lambda t: None if t is None else t.clone(),
                          batches if plan is None else (batches, uniforms))
        if plan is not None:
            self._consts(plan)

        def run():
            with torch.enable_grad():
                if plan is None:
                    return self._block(m, state, statics, inputs)
                return self._block_part(plan, m, state, statics, inputs)

        key = m if plan is None else (plan, m)
        self._graphs[key] = _Captured(
            graphs.capture(run, tree_leaves(state)),
            self._signature(state, statics), inputs)
        self.stats["captures"] += 1

    def captured_launches(self, m: int, plan=None) -> dict:
        """Launches per wrapper that one replay of the m-round graph (under
        ``plan``) makes."""
        plan = part_mod.normalize(plan)
        return self._graphs[m if plan is None else (plan, m)] \
            .graph.launches_by_name()

    def _replay(self, m: int, state, statics, batches, plan=None,
                uniforms=None) -> torch.Tensor:
        key = m if plan is None else (plan, m)
        entry = self._graphs.get(key)
        if entry is None or entry.signature != self._signature(state,
                                                                statics):
            self.capture(m, state, statics, batches, plan=plan,
                         uniforms=uniforms)
            entry = self._graphs[key]
        copy_into(entry.batches, batches if plan is None
                  else (batches, uniforms))
        out = entry.graph.replay()
        self.stats["replays"] += 1
        return out

    # ------------------------------------------------------------------
    def submit_block(self, state, m: int, *, statics, batches, tap=None,
                     state_tap=None, state_tap_every: int = 0,
                     round_offset: int = 0, eager: bool = False, plan=None,
                     uniforms=None) -> "BlockResult":
        """Run m rounds on ``state`` in place: one graph replay on the card
        (``eager``: the same work without the graph, a replay's oracle),
        eagerly on the CPU.  ``batches`` is a tuple per bucket of trees
        whose leaves lead with (m, E, k_b).  Under a participation
        ``plan``, ``state`` carries the sampler's device state as a fifth
        element and ``uniforms`` is the (m, n_u, K) staged uniforms (None
        under ``nodes``).  Returns before the readback: the result's
        ``metrics()`` reads the device once and calls ``tap(metrics of
        round i, with "round_in_block": i)`` once per round.

        ``state_tap(step, state)`` arms the in-block checkpoint: the block
        runs as the sub-blocks of ``tap_spans(m, state_tap_every)`` and
        the tap fires after each full one with the live state, at step
        ``round_offset`` + rounds done (see the module docstring).  It
        needs batches read by round (no plan, or ``per_round_draws``).  A
        raising tap is logged and dropped.  A ``Federation`` checkpoints
        through ``run_rounds(checkpoint_path=)``, not through this hook:
        its files must hold generators positioned per sub-block."""
        if m < 1:
            raise ValueError(f"block size must be >= 1, got {m}")
        plan = part_mod.normalize(plan)
        every = m
        if state_tap is not None:
            if not 1 <= state_tap_every <= m:
                raise ValueError(f"state_tap_every {state_tap_every} "
                                 f"outside [1, {m}]")
            if plan is not None and not self.ecfg.per_round_draws:
                raise ValueError(
                    "state_tap under a plan needs per_round_draws: a node "
                    "reads its own count of rounds trained, which a "
                    "sub-block cannot slice (Federation splits its blocks "
                    "itself)")
            every = state_tap_every
        outs = []
        for start, mm, full in tap_spans(m, every):
            cut = (lambda t, a=start, b=start + mm: None if t is None
                   else t[a:b])
            sub_b = batches if mm == m else tree_map(cut, batches)
            sub_u = (uniforms if mm == m or uniforms is None
                     else uniforms[start:start + mm])
            outs.append(self._run_sub(mm, state, statics, sub_b, plan, sub_u,
                                      eager))
            if state_tap is not None and full:
                _safe_tap(state_tap, round_offset + start + mm, state)
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return BlockResult(self, out, plan, tap)

    def _run_sub(self, m: int, state, statics, batches, plan, uniforms,
                 eager: bool) -> torch.Tensor:
        """The packed metrics of m rounds, replayed or eager.  A replay's
        output buffer is rewritten by the next replay of its graph, and
        the read is deferred, so it is cloned."""
        if state[2].device.type == "cuda" and not eager:
            out = self._replay(m, state, statics, batches, plan, uniforms)
            return out.clone()
        with torch.enable_grad():
            return (self._block(m, state, statics, batches)
                    if plan is None else self._block_part(
                        plan, m, state, statics, (batches, uniforms)))

    def run_block(self, state, m: int, **kw):
        """``submit_block`` then its one readback: returns ``(state,
        metrics)``, metrics a list of m per-round dicts."""
        return state, self.submit_block(state, m, **kw).metrics()


class BlockResult:
    """A submitted block's packed metrics, still on the device."""

    def __init__(self, engine: RoundEngine, out: torch.Tensor, plan, tap):
        self._engine, self._out, self._plan, self._tap = engine, out, plan, tap

    def metrics(self) -> list:
        """Read the device once; the per-round dicts (``tap`` fired)."""
        eng, plan = self._engine, self._plan
        host = self._out.tolist()                            # one readback
        eng.stats["readbacks"] += 1
        metrics = [eng._unpack(row) if plan is None
                   else eng._unpack_part(row, plan) for row in host]
        if self._tap is not None:
            for i, rec in enumerate(metrics):
                _safe_tap(self._tap, dict(rec, round_in_block=i))
        return metrics


__all__ = ["EngineConfig", "RoundEngine", "BlockResult", "auto_block_size",
           "pad_axis", "stack_nodes", "masked_select", "tap_spans", "COUNTED"]
