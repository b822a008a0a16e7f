"""``Federation(mesh=)`` across 4 gloo ranks on the CPU: the reference's
16-node, two-bucket ``TINY`` case of ``tests/test_mesh_multidevice.py`` on
the ``("pod", "data")`` (2, 2) mesh -- two buckets of 8 nodes, 2 nodes a
rank in each, ``corrupt_nodes=(3,)``.

The ranks are spawned processes (``_torch_mesh_worker.run_rank``, which
imports no JAX) that meet on a ``file://`` store under the test's tmp
directory, so parallel workers never race for a port; every collective
times out after 60 s, and the parent joins each rank under a timeout of
its own and kills what is left, so no rank can hang the suite.  All cases
run in one spawn.  While the ranks run the cases that need no JAX, the
parent builds the JAX package's unsharded ``Federation``, runs a round,
and hands its state and its next round's draws to the ranks as numpy.

Held here, every rank's results:
- two rounds against the single-device port within 1e-5 (records and
  weights: a shard-major gather would permute the per-node weights), and
  every rank's records equal to every other rank's;
- the second round against the JAX package at ``TOL`` / ``REL``, records
  and the gathered state;
- a block of 2 against two single rounds of the single-device port;
- ``uniform`` C 6 on the uniforms JAX's sampler key gives: the cohorts
  are JAX's, records within 1e-5 of the single-device port on the same
  uniforms;
- ``async`` (geometric lag, transients, a crash chain, node 5 poisoned):
  events (starts, deliveries, staleness, quarantines) equal to the
  single-device port's, records within 1e-5;
- a checkpoint written on rank 0: it restores into the single-device
  port's ``Federation`` with that federation's state after two rounds
  (1e-5), and into a fresh federation on the 4 ranks bit for bit, which
  then runs the next round as the saving federation does;
- the traffic of a round, counted by wrapping ``torch.distributed``'s
  collectives in the worker: the ``all_reduce``d bytes are one node's
  uplink (its Gram and its shipped side-cars, the record's
  ``uplink_bytes``) plus 4 bytes for each of the precision sums (one
  full, two under a cohort), in two calls; an async round reduces
  nothing and gathers the reports;
- the layout fallback's warning with buckets of 2 and 6 nodes over 4
  ranks, and its round against the single-device port with one padded
  bucket;
- ``data/pipeline.py`` under the mesh: ``BlockStager(sharding=)``,
  ``stack_block_batches(sharding=)`` and ``shard_batch`` give the rank's
  node rows of the unsharded block.
"""
import multiprocessing as mp
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import participation as jpart  # noqa: E402
from repro.core.federation import Federation as JFederation  # noqa: E402
from repro.core.federation import FederationConfig as JFedConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.federation import (Federation,  # noqa: E402
                                         FederationConfig)
from repro_torch.core.participation import ParticipationPlan  # noqa: E402
from test_torch_engine import (REL, TOL, _TINY, _close, _flat,  # noqa: E402
                               _reference_draws, _reference_state)
from test_torch_participation import (_jax_round_uniforms,  # noqa: E402
                                      compare_participation,
                                      compare_records)
import _torch_mesh_worker  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

WORLD = 4
JOIN_S = 300                    # the whole spawn, at most
TINY16 = get_config("fedmm-small").with_(**_TINY)
FED16 = dict(n_nodes=16, rounds=2, local_steps=1, local_batch=4,
             method="geolora", modalities=("genetics", "tabular"),
             corrupt_nodes=(3,), anchors_per_class=1, n_tokens=2,
             lora_rank=2)
FALLBACK = dict(FED16, n_nodes=8,
                modalities=("genetics", "tabular", "tabular", "tabular"))
UNIFORM = dict(strategy="uniform", cohort_size=6, seed=2)
ASYNC = dict(strategy="async", lag_dist="geometric", max_lag=2,
             transient_rate=0.3, crash_rate=0.2, poison_nodes=(5,), seed=3)
TOL1 = 1e-5
ASYNC_EVENTS = ("participation", "cohort_size", "delivered", "staleness",
                "quarantined", "n_delivered")


def _spawn(tmp_path, inp: dict, jax_reference):
    """Start the ranks, run ``jax_reference()`` meanwhile and hand its
    result over, join; returns each rank's results."""
    inp_path, jax_path = tmp_path / "inp.pkl", tmp_path / "jax.pkl"
    out_path = str(tmp_path / "out%d.pkl")
    with open(inp_path, "wb") as fh:
        pickle.dump(inp, fh)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_mesh_worker.run_rank, args=(
        r, WORLD, str(tmp_path / "store"), str(inp_path), str(jax_path),
        out_path)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = jax_reference()
        tmp = str(jax_path) + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(ref, fh)
        os.replace(tmp, jax_path)            # the ranks see it whole
        for p in procs:
            p.join(JOIN_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, f"{len(alive)} ranks hung"
    outs = []
    for r, p in enumerate(procs):
        assert p.exitcode == 0, f"rank {r} exited {p.exitcode}"
        with open(out_path % r, "rb") as fh:
            outs.append(pickle.load(fh))
        assert "error" not in outs[-1], f"rank {r}:\n{outs[-1]['error']}"
    return outs


def _jax_reference() -> dict:
    """The JAX package's unsharded federation after one round: its state
    and next round's draws (numpy), then that round's record and state."""
    ref = JFederation(JFedConfig(**FED16), jget_config("fedmm-small").with_(
        **_TINY))
    ref.run_round()
    state = _reference_state(ref)
    draws = [{k: v.numpy() for k, v in d.items()}
             for d in _reference_draws(ref)]
    want = ref.run_round()
    return {"state": state, "draws": draws, "want": want,
            "want_state": jax.device_get({"gbar": ref.gbar,
                                          "train": ref._trains,
                                          "opt": ref._opts})}


def _uniforms(groups, rounds: int):
    """JAX's sampler uniforms for ``UNIFORM`` over ``rounds`` rounds (row
    order, (1, K) each) and its cohort masks."""
    jplan = jpart.ParticipationPlan(**UNIFORM)
    jstate = jpart.init_state(jplan, FED16["n_nodes"])
    us, masks = [], []
    for _ in range(rounds):
        u, _ = _jax_round_uniforms(jplan, jstate["key"], groups)
        jm, _, jstate = jpart.sample_rows(jplan, jstate, groups)
        us.append(u)
        masks.append(np.concatenate([np.asarray(m) for m in jm]))
    return us, masks


def _single(cfg=FED16, **kw):
    return Federation(FederationConfig(**cfg), TINY16, device="cpu", **kw)


def test_federation_on_four_ranks(tmp_path):
    groups = _single().engine._groups
    uniforms, jax_masks = _uniforms(groups, 2)
    inp = {"tiny": _TINY, "fed": FED16, "fallback": FALLBACK,
           "uniform": UNIFORM, "async": ASYNC, "uniforms": uniforms,
           "ck_path": str(tmp_path / "ck.npz")}
    outs = _spawn(tmp_path, inp, _jax_reference)
    with open(tmp_path / "jax.pkl", "rb") as fh:
        jref = pickle.load(fh)

    # the single-device port on the same inputs
    full = _single()
    want_full = [full.run_round(), full.run_round()]
    want_block = _single().run_rounds(2, block_size=2)
    u = _single()
    stage, it = u._stage_part, iter(uniforms)

    def staged(m, plan):
        batches, _, pos = stage(m, plan)
        return batches, torch.from_numpy(
            np.stack([next(it) for _ in range(m)])), pos
    u._stage_part = staged
    want_uniform = u.run_rounds(2, participation=ParticipationPlan(
        **UNIFORM))
    want_async = _single().run_rounds(3, participation=ParticipationPlan(
        **ASYNC))
    want_fallback = [_single(FALLBACK, width_bucketing=False).run_round()]

    same = [k for k in outs[0] if k not in ("layout", "jax_state")]
    for r, out in enumerate(outs):
        assert all(out[k] == outs[0][k] for k in same), r
        assert out["layout"] == ([8, 8], [list(m[2 * r:2 * r + 2])
                                          for m in groups])
        compare_records(out["full"], want_full, w_tol=TOL1)
        compare_records(out["block"], want_full, w_tol=TOL1)
        compare_records(out["block"], want_block, w_tol=TOL1)
        compare_participation(out["uniform"], want_uniform)
        perm = [i for g in groups for i in g]
        for rec, mask in zip(out["uniform"], jax_masks):
            by_node = [0.0] * FED16["n_nodes"]
            for row, node in enumerate(perm):
                by_node[node] = float(mask[row])
            assert rec["participation"] == by_node
        compare_records(out["async"], want_async, w_tol=TOL1)
        for key in ASYNC_EVENTS:
            assert [x[key] for x in out["async"]] == \
                [x[key] for x in want_async], key
        assert out["pipeline"]
        assert out["fallback_warnings"] and out["fallback_layout"] == [8]
        compare_records(out["fallback"], want_fallback, w_tol=TOL1)
        # the checkpoint: step, restored bit for bit, the same next round
        assert out["restore_step"] == 2 and out["restore_equal"]
        assert out["restored_next"] == out["saved_next"]
        # the traffic of a round: the uplink, and the precision sums
        uplink = want_full[0]["uplink_bytes"]
        for case, sums in (("traffic_full", 1), ("traffic_uniform", 2)):
            reduced = [b for name, b in out[case] if name == "all_reduce"]
            assert len(reduced) == 2 and sum(reduced) == uplink + 4 * sums
        assert not [c for c in out["traffic_async"] if c[0] == "all_reduce"]
        # against the JAX package's second round
        compare_records([out["jax"]], [jref["want"]], w_tol=REL)

    # the file rank 0 wrote, in the single-device federation
    loaded = _single()
    assert loaded.restore(inp["ck_path"]) == 2
    for a, b in zip(_flat(bridge.params_to_numpy(
            (loaded.gbar, loaded._trains, loaded._opts))),
            _flat(bridge.params_to_numpy((full.gbar, full._trains,
                                          full._opts)))):
        _close(a[1], b[1], TOL1, a[0])
    # the JAX round's state, gathered on rank 0
    ours, theirs = outs[0]["jax_state"], jref["want_state"]
    _close(ours["gbar"], theirs["gbar"], TOL, "consensus Gram")
    for what in ("train", "opt"):
        a, b = _flat(ours[what]), _flat(theirs[what])
        assert [p for p, _ in a] == [p for p, _ in b], what
        for (path, x), (_, y) in zip(a, b):
            _close(x, y, REL * max(float(np.abs(y).max()), 1e-30),
                   f"{what} {path}")
