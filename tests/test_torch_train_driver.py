"""The port's federated LM training driver (``repro_torch.launch.train``) and
its data pipeline (``repro_torch.data.pipeline``), on the CPU in float32,
against the reference (``repro.launch.train``, ``repro.data.pipeline``).

- ``SyntheticLMStream`` and ``BlockStager`` give the reference's tokens
  bit for bit, and a block does not depend on the block size;
  ``auto_block_size`` is the reference's on a grid of inputs.
- One driver round against the reference's.  The reference driver's local
  step and engine are closures inside its ``main``, so this file rebuilds
  them from ``src/repro/launch/train.py`` (its lines 150-224, as they
  stand).  The reference runs a round from its weights; the port's driver
  is built from the same weights and anchors (``build(params=,
  anchors=)``), the reference's state after that round is carried across,
  and both run the next round on the same batches -- under full
  participation, and under ``uniform`` with the uniforms the reference's
  key gives.  The second round is compared because AdamW from zero
  moments is ill-conditioned for parity.  Tolerances are those of
  ``test_torch_engine.py``: 1e-5 absolute on losses and CKA and the
  consensus Gram, 1e-4 on the weights, 1e-4 of each leaf's max |value|
  on the stacked trainables and moments.
- The entry point on the CPU, as ``tests/test_system.py`` runs the
  reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cka as jcka  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import participation as jpart  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.train import _broadcast_tree  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import cross_entropy_loss  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.tree import copy_into, tree_leaves  # noqa: E402
from test_torch_engine import REL, TOL, _close, _flat  # noqa: E402
from test_torch_participation import _jax_round_uniforms  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


ARGV = ["--tiny", "--nodes", "2", "--local-steps", "2", "--batch", "2",
        "--seq", "16", "--anchors", "6", "--rank", "4", "--device", "cpu"]


# ----------------------------------------------------------------------
# the data pipeline
def test_synthetic_stream_matches_reference():
    ours = iter(tpipe.SyntheticLMStream(300, 12, 3, seed=7))
    theirs = iter(jpipe.SyntheticLMStream(300, 12, 3, seed=7))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _streams(pkg, k=3):
    return [iter(pkg.SyntheticLMStream(200, 8, 2, seed=100 + i))
            for i in range(k)]


def test_block_stager_matches_reference_and_block_size():
    ours = tpipe.BlockStager(_streams(tpipe), 2, 4).next_block()
    theirs = jpipe.BlockStager(_streams(jpipe), 2, 4).next_block()
    halves = tpipe.BlockStager(_streams(tpipe), 2, 2)
    two = [halves.next_block(), halves.next_block(1), halves.next_block(1)]
    for k in ("tokens", "labels"):
        assert tuple(ours[k].shape) == (4, 2, 3, 2, 8)
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
        np.testing.assert_array_equal(
            torch.cat([b[k] for b in two]).numpy(), ours[k].numpy())


def test_make_lm_batch_shifts_labels():
    cfg = train.model_config(train.parse_args(["--tiny"]))
    b = tpipe.make_lm_batch(torch.Generator().manual_seed(0), cfg, 3, 10)
    assert b["tokens"].shape == b["labels"].shape == (3, 10)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("dispatch", [0.0, -1.0, 1e-4, 0.003, 0.02, 0.5, 9.0])
def test_auto_block_size_matches_reference(dispatch):
    for round_s in (-1.0, 0.0, 1e-3, 0.05, 0.4, 2.0):
        for cap in (1, 8, 64):
            assert tengine.auto_block_size(dispatch, round_s, cap=cap) == \
                jengine.auto_block_size(dispatch, round_s, cap=cap), \
                (dispatch, round_s, cap)


# ----------------------------------------------------------------------
# one round against the reference
def _reference_driver(args):
    """``repro.launch.train.main``'s state, local step and engine, rebuilt
    from its lines 150-224."""
    cfg = jget_config(args.arch).with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, dtype="float32")
    k_nodes = args.nodes
    key = jax.random.PRNGKey(0)
    rt = JT.Runtime()
    params = JT.init_params(key, cfg)
    spec = jlora.LoRASpec(rank=args.rank, dora=(args.method == "geodora"))
    params = jlora.attach_lora(jax.random.fold_in(key, 1), params, spec)
    mask = jlora.trainable_mask(params)
    trainable, frozen = jlora.partition(params, mask)
    opt = JAdamW(lr=args.lr, grad_clip=1.0, round_schedule=None)
    anchors = jax.random.randint(jax.random.fold_in(key, 2),
                                 (args.anchors, args.seq), 0, cfg.vocab_size)
    lambda_geo = args.lambda_geo

    def local_step(train_k, opt_k, key_k, gbar, _statics, batch):
        def loss_fn(tr):
            p = jlora.combine(tr, frozen)
            logits, aux = JT.forward(p, {"tokens": batch["tokens"]}, cfg, rt)
            task = cross_entropy_loss(logits, batch["labels"])
            _, a_aux = JT.forward(p, {"tokens": anchors}, cfg, rt)
            gram = jcka.cosine_gram(a_aux["pooled"])
            geo = 1.0 - jcka.cka(gram, gbar)
            return task + lambda_geo * geo, \
                (task, geo, aux["pooled"], a_aux["pooled"])
        grads, (task, geo, pooled, pooled_a) = \
            jax.grad(loss_fn, has_aux=True)(train_k)
        new_train, new_opt = opt.update(grads, opt_k, train_k)
        return new_train, new_opt, key_k, {
            "task": task, "geo": geo,
            "pooled": pooled, "pooled_a": pooled_a}

    shipped = jax.tree.map(lambda p: None if p is None else True,
                           trainable, is_leaf=lambda x: x is None)
    engine = jengine.RoundEngine(
        jengine.EngineConfig(n_nodes=k_nodes, local_steps=args.local_steps,
                             aggregation="precision",
                             server_momentum=args.server_momentum),
        opt, local_step, (shipped,))
    node_train = (_broadcast_tree(trainable, k_nodes),)
    node_opt = (jax.vmap(opt.init)(node_train[0]),)
    node_keys = (jax.random.split(jax.random.fold_in(key, 3), k_nodes),)
    state = [node_train, node_opt, node_keys, jnp.eye(args.anchors),
             engine.init_server_state(node_train)]
    return {"params": params, "anchors": anchors, "engine": engine,
            "state": state}


def _round_batches(args, streams):
    """One round's batches, (E, K, B, S) numpy, consumed as the drivers
    consume them."""
    grid = [[next(s) for s in streams] for _ in range(args.local_steps)]
    return {k: np.stack([np.stack([b[k] for b in step]) for step in grid])
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def reference():
    """The reference driver after its first round (full participation),
    its state on the host, and the second round's batches."""
    args = train.parse_args(ARGV)
    ref = _reference_driver(args)
    streams = [iter(jpipe.SyntheticLMStream(512, args.seq, args.batch,
                                            seed=100 + i))
               for i in range(args.nodes)]
    out = ref["engine"].round_fn(*ref["state"], (None,),
                                 (_round_batches(args, streams),))
    ref["state"] = jax.device_get(list(out[:-1]))
    ref["batches"] = _round_batches(args, streams)
    return ref


def _port_run(ref, argv):
    args = train.parse_args(argv)
    run = train.build(args, params=bridge.params_from_numpy(
        jax.device_get(ref["params"]), "cpu"),
        anchors=torch.from_numpy(np.array(ref["anchors"])).int())
    trains, opts, _, gbar, _ = ref["state"]
    copy_into(run.state[:3], bridge.params_from_numpy(
        (trains, opts, gbar), "cpu"))
    return args, run


def _compare(run, got, want, want_state):
    for name in ("task", "geo"):
        _close(got[name], np.asarray(want["scalars"][name]), TOL, name)
    _close(got["weights"], np.asarray(want["weights"]), REL, "weights")
    _close(got["cross_node_cka"], float(want["cross_node_cka"]), TOL, "xcka")
    _close(run.state[2], np.asarray(want_state[3]), TOL, "consensus Gram")
    for what, ours, theirs in (("trains", run.state[0], want_state[0]),
                               ("opts", run.state[1], want_state[1])):
        ours = _flat(bridge.params_to_numpy(ours))
        theirs = _flat(jax.device_get(theirs))
        assert [p for p, _ in ours] == [p for p, _ in theirs], what
        for (path, a), (_, b) in zip(ours, theirs):
            _close(a, b, REL * max(float(np.abs(b).max()), 1e-30),
                   f"{what} {path}")


def _staged(batches):
    return ({k: torch.from_numpy(v)[None] for k, v in batches.items()},)


def test_driver_round_matches_reference(reference):
    ref = reference
    args, run = _port_run(ref, ARGV)
    state = [jax.tree.map(jnp.asarray, s) for s in ref["state"]]
    out = ref["engine"].round_fn(*state, (None,), (ref["batches"],))
    _, got = run.engine.run_block(run.state, 1, statics=(None,),
                                  batches=_staged(ref["batches"]))
    _compare(run, got[0], out[-1], out)


def test_driver_round_matches_reference_under_uniform(reference):
    ref = reference
    args, run = _port_run(ref, ARGV + ["--participation", "uniform",
                                       "--cohort-size", "1",
                                       "--participation-seed", "3"])
    jplan = jpart.ParticipationPlan(strategy="uniform", cohort_size=1,
                                    seed=3)
    part = jpart.init_state(jplan, args.nodes)
    u, _ = _jax_round_uniforms(jplan, part["key"], ((0, 1),))
    state = [jax.tree.map(jnp.asarray, s) for s in ref["state"]]
    out = ref["engine"].part_round_fn(jplan)(*state, part, (None,),
                                              (ref["batches"],))
    _, got = run.engine.run_block(
        run.state, 1, statics=(None,), batches=_staged(ref["batches"]),
        plan=run.plan, uniforms=torch.from_numpy(np.array(u))[None])
    assert got[0]["participation"] == \
        [float(x) for x in np.asarray(out[-1]["participation"])]
    assert got[0]["cohort_size"] == 1.0
    _compare(run, got[0], out[-1], out)


# ----------------------------------------------------------------------
# the entry point
@pytest.mark.parametrize("extra", [
    [], ["--block-size", "2", "--rounds", "3", "--participation", "uniform",
         "--cohort-size", "1"]], ids=["per-round", "blocks-uniform"])
def test_train_driver_entrypoint(extra):
    final = train.main(["--tiny", "--rounds", "1", "--local-steps", "1",
                        "--batch", "2", "--seq", "32", "--anchors", "6",
                        "--nodes", "2", "--device", "cpu"] + extra)
    assert np.isfinite(final)


@pytest.mark.parametrize("plan", [
    [], ["--participation", "uniform", "--cohort-size", "1"],
    ["--participation", "async"]], ids=["full", "uniform", "async"])
def test_blocks_equal_single_rounds_and_submit_overlaps(plan):
    """The driver's blocks of 2 (staged while the previous block runs)
    leave the state that single rounds leave, one readback per block.
    Under a plan this holds only if round r of a block reads slot r of
    the staged batches for every node (``per_round_draws``), as a single
    round reads its own batch: with cohort 1 of 2, a node idle in round 0
    reading its own count of rounds trained would take round 0's batch in
    round 1."""
    states = []
    for block in ("1", "2"):
        args = train.parse_args(ARGV + plan + ["--block-size", block,
                                               "--local-steps", "1"])
        run = train.build(args)
        trainer = train.Trainer(run, args)
        final = trainer.train(4, block)
        states.append((final, [t.clone() for t in tree_leaves(run.state)]))
        assert run.engine.stats["readbacks"] == 4 // int(block)
    assert states[0][0] == states[1][0]
    assert all(torch.equal(a, b) for a, b in zip(states[0][1], states[1][1]))
