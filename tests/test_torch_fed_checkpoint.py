"""The federation's checkpoints in the port (``SequentialFederation`` and
``Federation``: ``save`` / ``restore`` / ``node_params``, in-block
checkpoints through ``run_rounds(checkpoint_path=)`` and the engine's
``run_block(state_tap=)``), on the CPU in float32, in one process.

- The reference's checkpoint tests on the port (``test_federation.py``,
  ``test_engine.py``, ``test_fused_rounds.py``, ``test_participation.py``,
  ``test_async.py``): a restored run continues bit for bit -- the state
  tensors, the records, every generator -- at a block boundary and
  mid-block (``checkpoint_every`` < M), under no plan, ``uniform`` and
  ``async``, with the reference's file steps; the guards on
  ``server_momentum`` and ``round_schedule``; a restore into the same
  federation writes into its live tensors.
- Files cross both ways: a reference file loads in the port and a port
  file in the reference, leaf for leaf and bit-exact, for the sequential
  state and for the stacked state under no plan, ``uniform`` and
  ``async``.  The states are filled with numbers from a seed first, so
  every leaf carries information.  Random streams do not cross (JAX keys,
  torch generators): a reference file restarts the port's generators
  from their seeds.
"""
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import participation as jpart  # noqa: E402
from repro.core.federation import Federation as JFederation  # noqa: E402
from repro.core.federation import FederationConfig as JFedConfig  # noqa: E402
from repro.core.federation import \
    SequentialFederation as JSequential  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import participation as tpart  # noqa: E402
from repro_torch.core.federation import (Federation,  # noqa: E402
                                         FederationConfig,
                                         SequentialFederation, jax_keys)
from repro_torch.data.synthetic import stream  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_engine import BASE, JTINY, TINY, _flat  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

P = tpart.ParticipationPlan


MIXED = dict(BASE, modalities=("image", "text", "genetics", "tabular"))
PLANS = {"none": None,
         "uniform": P(strategy="uniform", cohort_size=2, seed=9),
         "async": P(strategy="async", lag_dist="geometric", lag_p=0.5,
                    max_lag=3, crash_rate=0.2, transient_rate=0.2,
                    poison_nodes=(1,), seed=7)}


def _fed(**kw):
    return Federation(FederationConfig(**dict(dict(method="geodora",
                                                   **BASE), **kw)),
                      TINY, device="cpu")


def _state(f, plan=None):
    return [t.clone() for t in tree_leaves(f._state(plan))]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _gens_equal(f1, f2) -> bool:
    gens = [(a["gen"], b["gen"]) for a, b in zip(f1.nodes, f2.nodes)]
    if getattr(f1, "_part_gen", None) is not None:
        gens.append((f1._part_gen, f2._part_gen))
    return all(torch.equal(a.get_state(), b.get_state()) for a, b in gens)


# ----------------------------------------------------------------------
# the reference's checkpoint tests, on the port
def test_sequential_checkpoint_resume(tmp_path):
    """``test_federation.py::test_federation_checkpoint_resume``."""
    def make():
        return SequentialFederation(FederationConfig(
            n_nodes=2, rounds=2, local_steps=2, local_batch=8,
            method="geolora", aggregation="uniform",
            modalities=BASE["modalities"], anchors_per_class=2, n_tokens=4,
            lora_rank=4), TINY, device="cpu")

    f1 = make()
    f1.run_round()
    path = os.path.join(tmp_path, "fed.npz")
    f1.save(path)
    r_cont = f1.run_round()
    f2 = make()
    assert f2.restore(path) == 1
    r_resumed = f2.run_round()
    assert r_cont == r_resumed
    for i in range(2):
        assert _equal(tree_leaves(f1.node_params(i)),
                      tree_leaves(f2.node_params(i)))
    assert _gens_equal(f1, f2)


def test_checkpoint_roundtrip_through_bucket_permutation(tmp_path):
    """``test_engine.py::test_checkpoint_roundtrip_through_bucket_
    permutation``: 4 width buckets, a bridge node in the text bucket."""
    fed = dict(method="geolora", bridge_nodes=(0,), bridge_modality="text",
               **{k: v for k, v in MIXED.items() if k != "bridge_modality"})
    f1 = _fed(**fed)
    assert len(f1._buckets) == 3
    f1.run_round()
    path = os.path.join(tmp_path, "fed_bucketed.npz")
    f1.save(path)
    r_cont = f1.run_round()
    f2 = _fed(**fed)
    assert f2.restore(path) == 1
    assert f2.run_round() == r_cont
    for i, node in enumerate(f2.nodes):
        d = f2.tokenizers[node["modality"]].d_out
        assert node["trainable"]["adapter"]["w"].shape[0] == d
        assert _equal(tree_leaves(f1.nodes[i]["trainable"]),
                      tree_leaves(node["trainable"]))


def test_checkpoint_at_block_boundary_bit_identical(tmp_path):
    """``test_fused_rounds.py::test_checkpoint_at_block_boundary_bit_
    identical``."""
    kw = dict(method="geolora", bridge_nodes=(0,))
    f1 = _fed(**kw)
    f1.run_rounds(2, block_size=2)
    path = os.path.join(tmp_path, "fed_block.npz")
    f1.save(path)
    rec_cont = f1.run_rounds(2, block_size=2)
    f2 = _fed(**kw)
    assert f2.restore(path) == 2
    assert f2.run_rounds(2, block_size=2) == rec_cont
    assert _equal(_state(f1), _state(f2)) and _gens_equal(f1, f2)


def test_fedopt_state_checkpoints_and_guards_mismatch(tmp_path):
    """``test_fused_rounds.py::test_fedopt_state_checkpoints_and_guards_
    mismatch``."""
    f1 = _fed(method="geolora", server_momentum=0.9)
    f1.run_rounds(2, block_size=2)
    path = os.path.join(tmp_path, "fed_mom.npz")
    f1.save(path)
    f2 = _fed(method="geolora", server_momentum=0.9)
    assert f2.restore(path) == 2
    assert _equal(tree_leaves(f1._server_m), tree_leaves(f2._server_m))
    with pytest.raises(ValueError, match="server_momentum"):
        _fed(method="geolora").restore(path)


def test_participation_checkpoint_resumes_sampler_stream(tmp_path):
    """``test_participation.py::test_participation_checkpoint_resumes_
    sampler_stream``: the restored run needs no plan installed first."""
    plan = PLANS["uniform"]
    f1 = _fed(method="geolora")
    f1.run_rounds(2, block_size=2, participation=plan)
    path = os.path.join(tmp_path, "fed_part.npz")
    f1.save(path)
    rec_cont = f1.run_rounds(2, block_size=2, participation=plan)
    f2 = _fed(method="geolora")
    assert f2.restore(path) == 2
    assert f2._part_plan == plan
    rec_resumed = f2.run_rounds(2, block_size=2, participation=plan)
    assert rec_resumed == rec_cont
    assert any(0.0 in r["participation"] for r in rec_cont)


def test_round_schedule_checkpoint_guard(tmp_path):
    """``test_participation.py::test_round_schedule_checkpoint_guard``."""
    f1 = _fed(method="geolora", round_lr_schedule=lambda r: 1.0 / (1 + r))
    f1.run_round()
    path = os.path.join(tmp_path, "fed_sched.npz")
    f1.save(path)
    with pytest.raises(ValueError, match="round_schedule"):
        _fed(method="geolora").restore(path)


def _reference_steps(n: int, block: int, every: int) -> list:
    """The steps the reference's in-scan tap writes (``core/engine.py``
    ``fire_state_tap`` with ``run_rounds``' ``min(every, m)``)."""
    if block <= 1:
        return []
    steps, done = [], 0
    while done < n:
        m = min(block, n - done)
        e = min(max(1, every), m)
        steps += [done + r + 1 for r in range(m) if (r + 1) % e == 0]
        done += m
    return steps


@pytest.mark.parametrize("n,block,every", [(4, 2, 1), (4, 2, 2), (5, 2, 2),
                                           (5, 3, 2), (3, 1, 1), (4, 4, 0)])
def test_inblock_checkpoint_files_at_reference_steps(tmp_path, n, block,
                                                     every):
    f = _fed(method="geolora", local_steps=1)
    taps = []
    recs = f.run_rounds(n, block_size=block, tap=taps.append,
                        checkpoint_path=os.path.join(tmp_path,
                                                     "ck_{step}.npz"),
                        checkpoint_every=every)
    want = _reference_steps(n, block, every)
    assert sorted(os.listdir(tmp_path)) == sorted(f"ck_{s}.npz"
                                                  for s in want)
    assert [w["step"] for w in f.checkpoint_writes] == want
    assert len(recs) == n
    if block > 1:
        # the sub-blocks keep the round's index within its block
        assert [t["round_in_block"] for t in taps] == \
            [r for d in range(0, n, block) for r in range(min(block, n - d))]


@pytest.mark.parametrize("every", [1, 2], ids=["mid-block", "boundary"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_inblock_checkpoint_kill_and_resume_bit_identical(tmp_path, plan,
                                                          every):
    """``test_async.py::test_inblock_checkpoint_kill_and_resume_bit_
    identical`` under each plan: 4 rounds in blocks of 2 with a checkpoint
    every ``every`` rounds; the first file (mid-block under ``every`` 1,
    at the block's end under 2), restored into a fresh federation and run
    to round 4 in blocks of 2, ends in the uninterrupted run's state and
    generators; so does ``ck_2`` restored into the same one, in place."""
    plan = PLANS[plan]
    ck = os.path.join(tmp_path, "ck_{step}.npz")
    f1 = _fed()
    recs = f1.run_rounds(4, block_size=2, participation=plan,
                         checkpoint_path=ck, checkpoint_every=every)
    steps = _reference_steps(4, 2, every)
    assert sorted(os.listdir(tmp_path)) == sorted(f"ck_{s}.npz"
                                                  for s in steps)
    final = _state(f1, plan)
    for step in steps[:1]:
        f2 = _fed()
        assert f2.restore(ck.format(step=step)) == step
        assert f2.run_rounds(4 - step, block_size=2,
                             participation=plan) == recs[step:]
        assert _equal(_state(f2, plan), final) and _gens_equal(f1, f2)
    # in place: the same tensors take the file's values
    ptrs = [t.data_ptr() for t in tree_leaves(f1._state(plan))]
    assert f1.restore(ck.format(step=2)) == 2
    assert [t.data_ptr() for t in tree_leaves(f1._state(plan))] == ptrs
    f1.history = f1.history[:2]
    assert f1.run_rounds(2, block_size=2, participation=plan) == recs[2:]
    assert _equal(_state(f1, plan), final)


def test_failing_checkpoint_write_is_logged_and_dropped(tmp_path, caplog):
    blocker = os.path.join(tmp_path, "file")
    open(blocker, "w").close()
    f = _fed(method="geolora")
    with caplog.at_level(logging.ERROR, logger="repro_torch.engine"):
        recs = f.run_rounds(2, block_size=2, checkpoint_every=1,
                            checkpoint_path=os.path.join(blocker, "ck.npz"))
    assert len(recs) == 2 and f.checkpoint_writes == []
    assert sum("payload dropped" in r.message for r in caplog.records) == 2


def test_engine_state_tap_splits_the_block():
    """``RoundEngine.run_block(state_tap=)``: the tap fires at the
    reference's steps with the state of that round; the block's records
    and final state are the unsplit block's; one readback per block."""
    f1, f2 = _fed(method="geolora"), _fed(method="geolora")
    batches = f1._stage(3)
    seen = []

    def tap(step, state):
        seen.append((step, [t.clone() for t in tree_leaves(state)]))

    _, recs = f1.engine.run_block(f1._state(), 3, statics=f1._statics,
                                  batches=batches, state_tap=tap,
                                  state_tap_every=2, round_offset=5)
    assert f1.engine.stats["readbacks"] == 1
    assert [s for s, _ in seen] == [7]
    first = tuple({k: v[:2] for k, v in b.items()} for b in batches)
    _, want = f2.engine.run_block(f2._state(), 2, statics=f2._statics,
                                  batches=first)
    assert _equal(seen[0][1], _state(f2))
    rest = tuple({k: v[2:] for k, v in b.items()} for b in batches)
    _, more = f2.engine.run_block(f2._state(), 1, statics=f2._statics,
                                  batches=rest)
    assert recs == want + more and _equal(_state(f1), _state(f2))
    with pytest.raises(ValueError, match="outside"):
        f1.engine.run_block(f1._state(), 2, statics=f1._statics,
                            batches=f1._stage(2), state_tap=tap,
                            state_tap_every=3)
    plan = PLANS["uniform"]
    f1._ensure_participation(plan)
    b, u, _ = f1._stage_part(2, plan)
    with pytest.raises(ValueError, match="per_round_draws"):
        f1.engine.run_block(f1._state(plan), 2, statics=f1._statics,
                            batches=b, plan=plan, uniforms=u, state_tap=tap,
                            state_tap_every=1)


# ----------------------------------------------------------------------
# files across the packages
def _fill_numpy(tree, rng):
    """``tree`` (numpy leaves) with numbers from ``rng`` of each leaf's
    dtype and shape."""
    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return rng.standard_normal(x.shape).astype(x.dtype)
        return rng.integers(0, 2 ** 16, x.shape).astype(x.dtype)
    return jax.tree.map(fill, tree)


def _fill_port(tree, seed: int) -> None:
    """The port's live tensors overwritten in place with numbers from a
    seed (dtypes kept)."""
    g = torch.Generator().manual_seed(seed)
    for t in tree_leaves(tree):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=g))
        else:
            t.copy_(torch.randint(0, 2 ** 16, t.shape, generator=g))


def _assert_bits(ours, theirs, what):
    ours = _flat(bridge.params_to_numpy(ours))
    theirs = _flat(jax.device_get(theirs))
    assert [p for p, _ in ours] == [p for p, _ in theirs], what
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {path}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")


def _ref_tree(ref):
    tree = {"gbar": ref.gbar, "train": ref._trains, "opt": ref._opts,
            "server_m": ref._server_m}
    if getattr(ref, "_part_state", None) is not None:
        tree["part"] = ref._part_state
    return tree


def _port_tree(port):
    tree = {"gbar": port.gbar, "train": port._trains, "opt": port._opts,
            "server_m": port._server_m}
    if getattr(port, "_part_state", None) is not None:
        tree["part"] = port._part_state
    return tree


def _drop_keys(tree):
    """The reference's tree without its PRNG keys (the port has none)."""
    if isinstance(tree, dict):
        return {k: _drop_keys(v) for k, v in tree.items() if k != "key"}
    return tree


@pytest.fixture(scope="module")
def reference():
    """One reference ``Federation`` (geodora, server momentum 0.9, two
    width buckets), shared by the cross-package cases."""
    return JFederation(JFedConfig(method="geodora", server_momentum=0.9,
                                  **BASE), JTINY)


@pytest.mark.parametrize("plan", list(PLANS))
def test_stacked_files_cross_both_ways(reference, tmp_path, plan):
    ref, tplan = reference, PLANS[plan]
    jplan = None if tplan is None else jpart.ParticipationPlan(
        **tpart.plan_meta(tplan))
    rng = np.random.default_rng(3)
    # reference -> port
    ref._part_plan, ref._part_state = None, None
    if jplan is not None:
        ref._ensure_participation(jplan)
    filled = _fill_numpy(jax.device_get(_ref_tree(ref)), rng)
    ref.gbar, ref._trains, ref._opts, ref._server_m = (
        jax.tree.map(jnp.asarray, filled[k])
        for k in ("gbar", "train", "opt", "server_m"))
    if jplan is not None:
        ref._part_state = jax.tree.map(jnp.asarray, filled["part"])
    path = os.path.join(tmp_path, "ref.npz")
    ref.save(path)
    port = _fed(server_momentum=0.9)
    port.run_round()                     # moves the generators
    assert port.restore(path) == len(ref.history)
    assert port._part_plan == tplan
    _assert_bits(_port_tree(port), _drop_keys(filled), "ref -> port")
    fresh = [stream("cpu", 0, "data", i).get_state() for i in range(4)]
    assert all(torch.equal(n["gen"].get_state(), s)
               for n, s in zip(port._nodes, fresh))
    # port -> reference
    _fill_port(_port_tree(port), seed=4)
    port.save(path)
    ref._part_plan, ref._part_state = None, None
    assert ref.restore(path) == 1
    _assert_bits(_port_tree(port), _drop_keys(_ref_tree(ref)),
                 "port -> ref")
    for b, members in enumerate(port._buckets):
        np.testing.assert_array_equal(np.asarray(ref._keys[b]),
                                      jax_keys(members, 0))


def test_sequential_files_cross_both_ways(tmp_path):
    cfg = dict(method="geodora", bridge_nodes=(0,), **BASE)
    ref = JSequential(JFedConfig(**cfg), JTINY)
    port = SequentialFederation(FederationConfig(**cfg), TINY, device="cpu")
    rng = np.random.default_rng(5)

    def ref_tree():
        return {"gbar": ref.gbar,
                "nodes": [{"trainable": n["trainable"],
                           "opt_state": n["opt_state"]} for n in ref.nodes]}

    def port_tree():
        return {"gbar": port.gbar,
                "nodes": [{"trainable": n["trainable"],
                           "opt_state": n["opt_state"]} for n in port.nodes]}

    filled = _fill_numpy(jax.device_get(ref_tree()), rng)
    ref.gbar = jnp.asarray(filled["gbar"])
    for node, f in zip(ref.nodes, filled["nodes"]):
        node["trainable"] = jax.tree.map(jnp.asarray, f["trainable"])
        node["opt_state"] = jax.tree.map(jnp.asarray, f["opt_state"])
    path = os.path.join(tmp_path, "seq.npz")
    ref.save(path)
    port.run_round()
    assert port.restore(path) == 0
    _assert_bits(port_tree(), filled, "ref -> port")
    _fill_port(port_tree(), seed=6)
    port.save(path)
    assert ref.restore(path) == 1
    _assert_bits(port_tree(), ref_tree(), "port -> ref")
    for i, node in enumerate(ref.nodes):
        np.testing.assert_array_equal(np.asarray(node["key"]),
                                      jax_keys([i], 0)[0])
