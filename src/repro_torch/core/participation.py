"""Participation layer: sampled cohorts, straggler masks, sampler state --
the port of ``repro.core.participation``.

The paper's server protocol (Eqs. 2, 4-6) averages side-cars, consensus
Grams and LAP precisions over *whichever nodes report*.  A
``ParticipationPlan`` says who reports each round:

  - **full** -- every node, every round (routed onto the engine's
    full-participation round, untouched);
  - **uniform** -- C of K nodes, bucket-stratified: ``allocate_cohort``
    gives each width bucket a static number of slots c_b (at least one
    per non-empty bucket), sampled uniformly within the bucket, so the
    engine can gather the cohort rows into fixed-shape ``(c_b, ...)``
    stacks and pay compute proportional to C;
  - **precision** -- like ``uniform`` but Gumbel-top-k over ``log p_k``,
    the nodes' last reported LAP precisions (``prev_p``): unreliable
    nodes are polled less often;
  - **dropout** -- every node fails to report with ``dropout_rate``; the
    cohort size varies, so the engine runs the masked path (all K
    compute, non-reporters' state kept);
  - **nodes** -- a fixed explicit cohort;
  - **async** -- the FedBuff-style regime: a lag-and-failure simulator
    (crash / rejoin Markov chain, transient non-reports, a fixed or
    geometric delivery lag) feeds a report buffer that the server
    averages with staleness weights, behind an on-device quarantine
    guard (``poison_nodes`` injects NaN uplinks that it must catch).

The random numbers.  The reference draws from a carried JAX key, whose
threefry stream torch cannot reproduce.  Here every sampling function
takes its uniforms as an input (``u``, in engine-row order) and applies
the reference's formula to them term for term: ``bernoulli(p)`` is
``u < p``, Gumbel scores are ``-log(-log(max(u, 1e-12)))``, the
geometric lag is ``floor(log1p(-u (1 - 1e-12)) / log1p(-min(p, 1 -
1e-7)))`` clipped to ``max_lag``, a cohort is ``topk`` then ``sort``.
The uniforms come from the sampler state's generator
(``data.synthetic.stream(device, plan.seed, "participation")``, one
``draw_uniforms`` call per round), so a test that hands these functions
the uniforms JAX's keys give gets JAX's cohorts and event streams.  The
sampler state holds that generator and the device tensors (``prev_p``;
``offline``, ``countdown``, ``lag``, ``quarantined``), not a key.

Every function here is branch-free on tensor values (``torch.where``,
``topk`` with a static k, ``index_fill``), so the round engine runs it
inside a captured CUDA graph; the sequential oracle calls the same
functions eagerly.

Non-participation: a node that does not report does nothing that round
-- trainables, optimizer moments, round counter and data generator carry
through -- and contributes nothing to the server step; it still receives
the broadcast.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.data.synthetic import stream

STRATEGIES = ("full", "uniform", "precision", "dropout", "nodes", "async")

LAG_DISTS = ("fixed", "geometric")
STALENESS_SCHEDULES = ("poly", "cutoff")


@dataclass(frozen=True)
class ParticipationPlan:
    """Static participation config (hashable: keys the engine's captured
    round and block graphs).  ``seed`` seeds the sampler's generator;
    ``compact`` opts the static-cohort strategies out of gather-compact
    execution (masked path instead)."""
    strategy: str = "full"
    cohort_size: Optional[int] = None          # uniform | precision
    dropout_rate: float = 0.25                 # dropout
    nodes: Tuple[int, ...] = ()                # nodes (fixed cohort)
    seed: int = 0
    compact: bool = True
    # --- async strategy: lag distribution + failure simulator ----------
    lag_dist: str = "fixed"                    # "fixed" | "geometric"
    lag: int = 1                               # fixed lag, rounds
    lag_p: float = 0.5                         # geometric success prob
    max_lag: int = 4                           # cap on any drawn lag
    transient_rate: float = 0.0                # per-round non-report prob
    crash_rate: float = 0.0                    # online -> offline prob
    rejoin_rate: float = 0.5                   # offline -> online prob
    # --- async server step: staleness weighting + quarantine -----------
    staleness: str = "poly"                    # "poly" | "cutoff"
    staleness_alpha: float = 1.0               # poly exponent
    max_staleness: Optional[int] = None        # hard gate on lag, rounds
    quarantine_norm: float = 1e6               # report-norm guard
    poison_nodes: Tuple[int, ...] = ()         # fault injection (NaN uplink)

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown participation strategy "
                             f"{self.strategy!r}; expected one of "
                             f"{STRATEGIES}")
        if self.strategy in ("uniform", "precision") \
                and not self.cohort_size:
            raise ValueError(f"strategy {self.strategy!r} needs a "
                             f"cohort_size")
        if self.strategy == "nodes" and not self.nodes:
            raise ValueError("strategy 'nodes' needs a non-empty node set")
        if self.strategy == "dropout" \
                and not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {self.dropout_rate} outside "
                             f"[0, 1)")
        if self.strategy == "async":
            if self.lag_dist not in LAG_DISTS:
                raise ValueError(f"unknown lag_dist {self.lag_dist!r}; "
                                 f"expected one of {LAG_DISTS}")
            if self.staleness not in STALENESS_SCHEDULES:
                raise ValueError(
                    f"unknown staleness schedule {self.staleness!r}; "
                    f"expected one of {STALENESS_SCHEDULES}")
            if self.lag < 0 or self.max_lag < 0:
                raise ValueError(f"lag {self.lag} / max_lag "
                                 f"{self.max_lag} must be >= 0")
            if self.lag_dist == "fixed" and self.lag > self.max_lag:
                raise ValueError(f"fixed lag {self.lag} exceeds max_lag "
                                 f"{self.max_lag}")
            if not 0.0 < self.lag_p <= 1.0:
                raise ValueError(f"lag_p {self.lag_p} outside (0, 1]")
            for name in ("transient_rate", "crash_rate", "rejoin_rate"):
                v = getattr(self, name)
                if not 0.0 <= v <= 1.0:
                    raise ValueError(f"{name} {v} outside [0, 1]")
            if self.crash_rate >= 1.0:
                raise ValueError("crash_rate 1.0 permanently kills every "
                                 "node; use < 1.0")
            if self.max_staleness is not None and self.max_staleness < 0:
                raise ValueError(f"max_staleness {self.max_staleness} "
                                 f"must be >= 0")
            if self.quarantine_norm <= 0.0:
                raise ValueError(f"quarantine_norm {self.quarantine_norm} "
                                 f"must be > 0")


def normalize(plan) -> Optional[ParticipationPlan]:
    """None / "full" / a full plan -> None (the full-participation round);
    strings become plans."""
    if plan is None:
        return None
    if isinstance(plan, str):
        plan = ParticipationPlan(strategy=plan)
    if plan.strategy == "full":
        return None
    return plan


def static_cohort(plan: ParticipationPlan) -> bool:
    """True when the per-round cohort size is fixed: the strategies the
    engine can run gather-compact."""
    return plan.strategy in ("uniform", "precision", "nodes")


def n_uniforms(plan: Optional[ParticipationPlan]) -> int:
    """Rows of (K,) uniforms one round consumes: 4 under ``async`` (crash,
    rejoin, transient, lag), none under ``nodes``, else 1."""
    plan = normalize(plan)
    if plan is None or plan.strategy == "nodes":
        return 0
    return 4 if plan.strategy == "async" else 1


def init_state(plan: Optional[ParticipationPlan], n_nodes: int,
               device="cpu"):
    """The carried sampler state: the generator of the plan's uniforms
    (``"gen"``), the running precision estimates (ENGINE ROW order) under
    ``precision``, and under ``async`` the simulator's (K,) arrays --
    ``countdown`` (rounds until the in-flight report lands, -1 idle),
    ``lag`` (the in-flight report's drawn lag), ``offline`` (the crash
    chain) and ``quarantined`` (reports the guard rejected).  None for
    stateless strategies."""
    plan = normalize(plan)
    if plan is None or plan.strategy == "nodes":
        return None
    dev = torch.device(device)
    state = {"gen": stream(dev, plan.seed, "participation")}
    if plan.strategy == "precision":
        state["prev_p"] = torch.ones((n_nodes,), dtype=torch.float32,
                                     device=dev)
    if plan.strategy == "async":
        state["offline"] = torch.zeros((n_nodes,), dtype=torch.float32,
                                       device=dev)
        state["countdown"] = torch.full((n_nodes,), -1, dtype=torch.int32,
                                        device=dev)
        state["lag"] = torch.zeros((n_nodes,), dtype=torch.int32, device=dev)
        state["quarantined"] = torch.zeros((n_nodes,), dtype=torch.int32,
                                           device=dev)
    return state


def device_state(state):
    """The state's tensors without its generator: what a captured round
    reads and writes in place."""
    if state is None:
        return None
    return {k: v for k, v in state.items() if k != "gen"}


def draw_uniforms(plan: ParticipationPlan, gen: torch.Generator,
                  n_nodes: int) -> Optional[torch.Tensor]:
    """One round's uniforms, (``n_uniforms(plan)``, K) from the sampler's
    generator; None when the plan draws none.  Blocks of M rounds stage M
    such calls, so a block consumes the stream as M single rounds do."""
    n = n_uniforms(plan)
    if n == 0:
        return None
    return torch.rand((n, n_nodes), generator=gen, device=gen.device)


def allocate_cohort(c: int, group_sizes) -> Tuple[int, ...]:
    """Largest-remainder proportional allocation of C cohort slots over the
    width buckets: static per-bucket cohort sizes (sum == C, each <= the
    bucket size) so the captured round can gather fixed-shape cohort
    states.  Deterministic: ties broken by bucket index.

    Every non-empty bucket is guaranteed at least one slot (requires
    C >= number of non-empty buckets), so no node is permanently starved
    by a zero-quota bucket.  Empty buckets get zero slots.  Within a
    bucket, sampling is uniform; ACROSS buckets inclusion probability is
    c_b / k_b, i.e. the strategies are bucket-STRATIFIED rather than
    exactly uniform over all C-subsets of K -- the price of cohort-shaped
    compute.  Use ``dropout`` or an explicit ``nodes`` plan when exact
    global semantics matter."""
    k = sum(group_sizes)
    live = [b for b, s in enumerate(group_sizes) if s > 0]
    n_groups = len(live)
    if not 1 <= c <= k:
        raise ValueError(f"cohort_size {c} outside [1, {k}]")
    if c < n_groups:
        raise ValueError(
            f"cohort_size {c} < {n_groups} non-empty width buckets: the "
            f"static per-bucket allocation would permanently starve a "
            f"bucket; use cohort_size >= {n_groups}, an explicit nodes= "
            f"plan, or the dropout strategy")
    sizes = [group_sizes[b] for b in live]
    # one guaranteed slot per non-empty bucket, remainder by
    # largest-remainder on the proportional quotas of the leftover slots
    base = [1] * n_groups
    rest = c - n_groups
    quotas = [rest * (s - 1) / max(k - n_groups, 1) for s in sizes]
    add = [min(int(q), s - 1) for q, s in zip(quotas, sizes)]
    rem = rest - sum(add)
    order = sorted(range(n_groups),
                   key=lambda b: (add[b] - quotas[b], b))
    for b in order:
        if rem == 0:
            break
        room = sizes[b] - 1 - add[b]
        take = min(room, 1)
        add[b] += take
        rem -= take
    # any residue (buckets at capacity) goes wherever room remains
    for b in range(n_groups):
        while rem > 0 and base[b] + add[b] < sizes[b]:
            add[b] += 1
            rem -= 1
    base = [b_ + a for b_, a in zip(base, add)]
    assert sum(base) == c and all(1 <= cb <= s for cb, s
                                  in zip(base, sizes))
    out = [0] * len(group_sizes)
    for b, cb in zip(live, base):
        out[b] = cb
    return tuple(out)


def _guarded(keep: torch.Tensor) -> torch.Tensor:
    """Never let every node drop out (an empty round divides by zero): an
    all-dropped draw degrades to full participation."""
    return torch.where(keep.any(), keep,
                       torch.ones_like(keep)).to(torch.float32)


def _row_mask(size: int, idx: torch.Tensor) -> torch.Tensor:
    return torch.zeros((size,), dtype=torch.float32,
                       device=idx.device).index_fill(0, idx, 1.0)


def nodes_cohort(plan: ParticipationPlan, groups, device):
    """The fixed cohort of a ``nodes`` plan: ``(row_masks, cohort_rows)``
    per bucket, made on ``device`` (the engine makes them once, before
    any capture)."""
    chosen = set(plan.nodes)
    rows = [[r for r, i in enumerate(g) if i in chosen] for g in groups]
    if sum(len(r) for r in rows) != len(chosen):
        raise ValueError(f"plan nodes {plan.nodes} are not all present "
                         f"in the federation's "
                         f"{sum(len(g) for g in groups)} nodes")
    idx = tuple(torch.tensor(r, dtype=torch.long, device=device)
                for r in rows)
    return (tuple(_row_mask(len(g), i) for g, i in zip(groups, idx)), idx)


def sample_rows(plan: ParticipationPlan, state, groups,
                u: Optional[torch.Tensor] = None, *, device="cpu"):
    """One round of cohort sampling.  ``groups`` is the engine's bucket
    layout, a tuple of tuples of CANONICAL node ids (row order within
    each bucket); ``u`` this round's uniforms, (1, K) or (K,) in engine
    row order (``draw_uniforms``; unused under ``nodes``).

    Returns ``(row_masks, cohort_rows, new_state)``:
      - ``row_masks[b]``: (k_b,) float32 0/1 participation per bucket row;
      - ``cohort_rows[b]``: (c_b,) int64 participating rows (sorted), or
        ``None`` under ``dropout``;
      - ``new_state``: the state (the generator moved in
        ``draw_uniforms``; nothing else changes here).
    """
    sizes = tuple(len(g) for g in groups)
    if plan.strategy == "nodes":
        masks, rows = nodes_cohort(plan, groups, device)
        return masks, rows, state
    u = u.reshape(-1)

    if plan.strategy == "dropout":
        mask = _guarded(u < 1.0 - plan.dropout_rate)
        return tuple(torch.split(mask, sizes)), None, state

    # uniform / precision: static per-bucket cohort sizes
    c_bs = allocate_cohort(plan.cohort_size, sizes)
    rows, masks, off = [], [], 0
    for s, cb in zip(sizes, c_bs):
        ub = u[off:off + s]
        if plan.strategy == "precision":
            # Gumbel-top-k over log p: c_b rows WITHOUT replacement, with
            # inclusion proportional-ish to the carried precision
            # estimates, so unreliable nodes are polled less often but
            # never starved outright
            p = state["prev_p"][off:off + s].clamp_min(1e-12)
            g = -torch.log(-torch.log(ub.clamp_min(1e-12)))
            scores = torch.log(p) + g
        else:
            scores = ub
        if cb:
            # top-c_b rows, then sorted so gather order is row order
            idx = torch.sort(torch.topk(scores, cb).indices).values
        else:
            idx = torch.zeros((0,), dtype=torch.long, device=u.device)
        rows.append(idx)
        masks.append(_row_mask(s, idx))
        off += s
    return tuple(masks), tuple(rows), state


def async_events(plan: ParticipationPlan, state, u: torch.Tensor):
    """One round of the async lag-and-failure simulator on (K,) control
    arrays in ENGINE ROW order; ``u`` is this round's (4, K) uniforms
    (crash, rejoin, transient, lag).  Per round, in order:

      1. crash / rejoin: each online node goes offline with
         ``crash_rate``, each offline node comes back with
         ``rejoin_rate``; a crash LOSES the in-flight report (countdown
         back to idle);
      2. transient non-report: an idle online node skips this round with
         ``transient_rate``;
      3. start: every idle, online, non-transient node runs a round of
         local work and ships its report with a fresh lag (``lag_dist``:
         fixed ``lag``, or geometric with success prob ``lag_p``; either
         clipped to ``max_lag``).  Lag 0 delivers this round.

    Returns ``(start, lag_draw, new_state)``: ``start`` the (K,) float32
    0/1 mask of nodes doing local work, ``lag_draw`` the (K,) int32 lag
    each starter ships with (0 elsewhere), ``new_state`` with
    ``offline`` / ``countdown`` advanced; the caller writes
    ``countdown`` / ``lag`` at the rows that pass its quarantine guard."""
    u_crash, u_rejoin, u_trans, u_lag = u
    offline = state["offline"]
    countdown = state["countdown"]

    crash = (u_crash < plan.crash_rate).to(torch.float32)
    rejoin = (u_rejoin < plan.rejoin_rate).to(torch.float32)
    new_offline = torch.where(offline > 0, 1.0 - rejoin, crash)
    # a crash kills the in-flight report
    countdown = torch.where(new_offline > 0, torch.full_like(countdown, -1),
                            countdown)

    transient = (u_trans < plan.transient_rate).to(torch.float32)
    idle = (countdown < 0).to(torch.float32)
    start = idle * (1.0 - new_offline) * (1.0 - transient)

    if plan.lag_dist == "fixed":
        lag_draw = torch.full_like(countdown, plan.lag)
    else:
        v = u_lag.clamp_min(1e-12)
        # number of failures before the first success, p = lag_p
        q = torch.full((), -min(plan.lag_p, 1.0 - 1e-7),
                       dtype=torch.float32, device=v.device)
        lag_draw = torch.floor(torch.log1p(-v * (1.0 - 1e-12))
                               / torch.log1p(q)).to(torch.int32)
    lag_draw = lag_draw.clamp(0, plan.max_lag) * start.to(torch.int32)

    new_state = dict(state, offline=new_offline, countdown=countdown)
    return start, lag_draw, new_state


def poison_mask(plan: ParticipationPlan, n_nodes: int, row_of_node=None,
                device="cpu") -> torch.Tensor:
    """(K,) float32 0/1 mask of fault-injected rows.  ``plan.poison_nodes``
    names CANONICAL node ids; ``row_of_node`` maps canonical id -> engine
    row (identity when omitted).  Made once, before any capture."""
    m = [0.0] * n_nodes
    for i in plan.poison_nodes:
        r = row_of_node[i] if row_of_node is not None else i
        m[r] = 1.0
    return torch.tensor(m, dtype=torch.float32, device=device)


def update_state(plan: ParticipationPlan, state, mask_rows: torch.Tensor,
                 precisions_rows: torch.Tensor):
    """Post-round update: the ``precision`` strategy folds this round's
    reported LAP precisions into its carried estimates at the reporting
    rows (non-reporters keep theirs).  Both (K,) in ENGINE ROW order."""
    if plan.strategy != "precision" or state is None:
        return state
    new_p = torch.where(mask_rows > 0, precisions_rows.to(torch.float32),
                        state["prev_p"])
    return dict(state, prev_p=new_p)


def plan_meta(plan: Optional[ParticipationPlan]):
    """JSON-serialisable plan description for checkpoint metadata."""
    if plan is None:
        return None
    return {"strategy": plan.strategy, "cohort_size": plan.cohort_size,
            "dropout_rate": plan.dropout_rate, "nodes": list(plan.nodes),
            "seed": plan.seed, "compact": plan.compact,
            "lag_dist": plan.lag_dist, "lag": plan.lag,
            "lag_p": plan.lag_p, "max_lag": plan.max_lag,
            "transient_rate": plan.transient_rate,
            "crash_rate": plan.crash_rate,
            "rejoin_rate": plan.rejoin_rate,
            "staleness": plan.staleness,
            "staleness_alpha": plan.staleness_alpha,
            "max_staleness": plan.max_staleness,
            "quarantine_norm": plan.quarantine_norm,
            "poison_nodes": list(plan.poison_nodes)}


def plan_from_meta(meta) -> Optional[ParticipationPlan]:
    if not meta:
        return None
    return ParticipationPlan(
        strategy=meta["strategy"], cohort_size=meta["cohort_size"],
        dropout_rate=meta["dropout_rate"], nodes=tuple(meta["nodes"]),
        seed=meta["seed"], compact=meta.get("compact", True),
        lag_dist=meta.get("lag_dist", "fixed"), lag=meta.get("lag", 1),
        lag_p=meta.get("lag_p", 0.5), max_lag=meta.get("max_lag", 4),
        transient_rate=meta.get("transient_rate", 0.0),
        crash_rate=meta.get("crash_rate", 0.0),
        rejoin_rate=meta.get("rejoin_rate", 0.5),
        staleness=meta.get("staleness", "poly"),
        staleness_alpha=meta.get("staleness_alpha", 1.0),
        max_staleness=meta.get("max_staleness"),
        quarantine_norm=meta.get("quarantine_norm", 1e6),
        poison_nodes=tuple(meta.get("poison_nodes", ())))


__all__ = ["STRATEGIES", "ParticipationPlan", "normalize", "static_cohort",
           "n_uniforms", "init_state", "device_state", "draw_uniforms",
           "allocate_cohort", "nodes_cohort", "sample_rows", "async_events",
           "poison_mask", "update_state", "plan_meta", "plan_from_meta"]
