"""The port's async (FedBuff-style) rounds: the lag-and-failure simulator,
the staleness-weighted server step, the quarantine guard and the report
buffer, in ``SequentialFederation`` and the node-stacked ``Federation``,
on the CPU in float32, in one process.

- ``async_events`` against ``repro.core.participation.async_events`` over
  6 rounds, fed the uniforms JAX's keys give (``split(key, 5)``, then
  ``uniform`` per draw, as the reference's ``bernoulli`` and lag draws
  make them): identical start masks, lags and control state.
- ``staleness_factor``, ``stale_precision_weights`` (both schedules, the
  all-zero round included) and ``weighted_average_reports`` against JAX
  on numpy inputs from a seed, at 1e-6; ``poison_mask`` exactly.
- The port's ``Federation`` against its ``SequentialFederation`` from one
  seed, 4 rounds, at 1e-5: a geometric lag with crashes, transient
  non-reports and a poisoned node, and a fixed lag that the cutoff
  schedule stales out (the protocol idles: the broadcast and the
  consensus Gram are kept).  Event streams exact (start, delivered,
  staleness, quarantined); the poisoned node's counter rises in every
  round it starts; blocks of 2 equal single rounds; a node that does not
  start keeps its state and generator.

The async rounds against the reference ``Federation`` are in
``test_torch_participation.py``, beside the ``nodes`` rounds, so the two
share one reference (its construction and first compile take ~30 s).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import participation as jpart  # noqa: E402
from repro.core import uncertainty as junc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import participation as tpart  # noqa: E402
from repro_torch.core import uncertainty as tunc  # noqa: E402
from repro_torch.core.federation import (Federation,  # noqa: E402
                                         FederationConfig,
                                         SequentialFederation)
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_engine import BASE, TINY, TOL, _close  # noqa: E402
from test_torch_participation import (_sat_out_state,  # noqa: E402
                                      compare_nodes, compare_participation)
from _torch_threads import _one_thread  # noqa: E402,F401


P = tpart.ParticipationPlan
ASYNC = dict(strategy="async", lag_dist="geometric", lag_p=0.5, max_lag=3,
             transient_rate=0.2, crash_rate=0.3, rejoin_rate=0.5,
             poison_nodes=(1,), seed=3)
EVENTS = ("participation", "delivered", "staleness", "quarantined",
          "n_delivered", "cohort_size")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_async_events_match_reference_on_its_uniforms():
    k = 7
    jplan, plan = jpart.ParticipationPlan(**ASYNC), P(**ASYNC)
    jstate = jpart.init_state(jplan, k)
    state = tpart.device_state(tpart.init_state(plan, k))
    for _ in range(6):
        _, kc, kr, kt, kl = jax.random.split(jstate["key"], 5)
        u = np.stack([np.asarray(jax.random.uniform(x, (k,)))
                      for x in (kc, kr, kt, kl)])
        js, jl, jstate = jpart.async_events(jplan, jstate)
        ts, tl, state = tpart.async_events(plan, state, _t(u))
        for a, b in ((ts, js), (tl, jl), (state["offline"],
                                          jstate["offline"]),
                     (state["countdown"], jstate["countdown"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the server's side, the same on both: arm the starters, deliver
        cd = np.where(np.asarray(js) > 0, np.asarray(jl),
                      np.asarray(jstate["countdown"]))
        cd = np.where(cd == 0, -1, np.where(cd > 0, cd - 1, cd)).astype(
            np.int32)
        jstate = dict(jstate, countdown=cd)
        state = dict(state, countdown=_t(cd))
    fixed = P(strategy="async", lag=2, max_lag=3)
    st = tpart.device_state(tpart.init_state(fixed, 3))
    start, lag, _ = tpart.async_events(fixed, st, torch.full((4, 3), 0.5))
    assert start.tolist() == [1.0] * 3 and lag.tolist() == [2] * 3


def test_poison_mask_matches_reference():
    plan = P(strategy="async", poison_nodes=(0, 3))
    jplan = jpart.ParticipationPlan(strategy="async", poison_nodes=(0, 3))
    rows = (2, 0, 3, 1)
    for r in (None, rows):
        np.testing.assert_array_equal(
            tpart.poison_mask(plan, 4, r).numpy(),
            np.asarray(jpart.poison_mask(jplan, 4, r)))


@pytest.mark.parametrize("schedule,alpha,max_st", [
    ("poly", 1.0, None), ("poly", 0.5, 2), ("cutoff", 1.0, 1)])
def test_staleness_weights_match_reference(schedule, alpha, max_st):
    rng = np.random.default_rng(6)
    lag = rng.integers(-1, 5, 8).astype(np.int32)
    p = (rng.random(8) * 4).astype(np.float32)
    _close(tunc.staleness_factor(_t(lag), schedule, alpha, max_st),
           junc.staleness_factor(lag, schedule, alpha, max_st), 1e-6, "f")
    for mask in (rng.integers(0, 2, 8), np.zeros(8)):
        m = mask.astype(np.float32)
        _close(tunc.stale_precision_weights(_t(p), _t(lag), _t(m), schedule,
                                            alpha, max_st),
               junc.stale_precision_weights(p, lag, m, schedule, alpha,
                                            max_st), 1e-6, f"w {mask}")
    with pytest.raises(ValueError, match="cutoff"):
        tunc.staleness_factor(_t(lag), "cutoff")


def test_weighted_average_reports_matches_reference():
    rng = np.random.default_rng(8)
    tree = {"blocks": {"lora_B": rng.standard_normal((5, 2, 3, 4))},
            "cls_head": {"w": rng.standard_normal((5, 4, 2))},
            "adapter": {"w": None}}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    for w in (rng.random(5).astype(np.float32), np.zeros(5, np.float32)):
        want = jagg.weighted_average_reports(tree, w)
        got = tagg.weighted_average_reports(
            bridge.params_from_numpy(tree, "cpu"), _t(w))
        assert got["adapter"]["w"] is None
        for path in (("blocks", "lora_B"), ("cls_head", "w")):
            _close(got[path[0]][path[1]], want[path[0]][path[1]], 1e-6,
                   str(path))


# ----------------------------------------------------------------------
# the port's Federation against its SequentialFederation
SEQ_CASES = {
    "geometric-faults-poison": (P(**ASYNC), {}),
    "cutoff-idle-uniform": (P(strategy="async", lag=2, max_lag=2,
                              staleness="cutoff", max_staleness=1, seed=4),
                            dict(aggregation="uniform")),
}


def compare_events(got, want):
    compare_participation(got, want)
    for g, w in zip(got, want):
        for key in EVENTS:
            assert g[key] == w[key], key
        assert all((s >= 0) == (d == 1.0)
                   for s, d in zip(g["staleness"], g["delivered"]))


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_async_federation_matches_sequential(case):
    plan, extra = SEQ_CASES[case]
    fed = FederationConfig(method="geodora", **BASE, **extra)
    seq = SequentialFederation(fed, TINY, device="cpu")
    eng = Federation(fed, TINY, device="cpu")
    want = seq.run_rounds(4, participation=plan)
    got, gbar0 = [], eng.gbar.clone()
    shipped0 = eng.nodes[0]["trainable"]["cls_head"]["w"].clone()
    for _ in range(4):
        before = [_sat_out_state(n) for n in eng.nodes]
        q0 = (got[-1]["quarantined"] if got else [0.0] * 4)
        got += eng.run_rounds(1, participation=plan)
        rec = got[-1]
        for i, p in enumerate(rec["participation"]):
            if not p:
                for a, b in zip(_sat_out_state(eng.nodes[i]), before[i]):
                    assert all(torch.equal(x, y) for x, y in zip(a, b)) \
                        if isinstance(a, list) else torch.equal(a, b), i
            for j in plan.poison_nodes:
                assert rec["quarantined"][j] == q0[j] + rec[
                    "participation"][j]
        assert all(np.isfinite(x) for x in rec["weights"])
    compare_events(got, want)
    if case == "cutoff-idle-uniform":
        # every report lands with lag 2 > max_staleness: nothing is
        # averaged, the broadcast and the consensus stay as they were
        assert sum(r["n_delivered"] for r in got) > 0
        assert all(sum(r["weights"]) == 0.0 for r in got)
        assert torch.equal(eng.gbar, gbar0)
        assert torch.equal(eng.nodes[2]["trainable"]["cls_head"]["w"],
                           shipped0)
    else:
        assert any(r["n_delivered"] > 0 and abs(sum(r["weights"]) - 1) < 1e-5
                   for r in got)
        assert all(torch.isfinite(t).all() for t in tree_leaves(eng._trains))
    _close(eng.gbar, seq.gbar, TOL, "consensus Gram")
    compare_nodes(eng, seq)


def test_async_blocks_equal_single_rounds():
    plan = P(**ASYNC)
    fed = FederationConfig(method="geodora", **BASE)
    single = Federation(fed, TINY, device="cpu")
    want = single.run_rounds(4, participation=plan)
    blocked = Federation(fed, TINY, device="cpu")
    got = blocked.run_rounds(3, block_size=2, participation=plan)
    got += blocked.run_rounds(1, block_size=2, participation=plan)
    compare_events(got, want)
    assert blocked.engine.stats["readbacks"] == 3
    compare_nodes(blocked, single)
    for key in ("ctl", "buf"):
        for a, b in zip(tree_leaves(blocked._part_state[key]),
                        tree_leaves(single._part_state[key])):
            _close(a, b, TOL, key)
