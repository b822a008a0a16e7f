"""The port's mesh layer (``launch/mesh.py``) and ``Federation(mesh=)`` on
one rank, on the CPU in float32, in one process.  A one-rank gloo group
(``make_local_mesh("cpu")``, on an in-process ``HashStore``) is started by
a module fixture and destroyed after the module, so it reaches no other
test file of the same worker.

- ``batch_axes`` / ``n_nodes`` against ``repro.launch.mesh`` on the same
  shapes and axes (abstract meshes on both sides), and the one-rank
  mesh's group, shard index and device.
- ``Federation(mesh=make_local_mesh("cpu"))`` against
  ``Federation(device="cpu")`` over 2 rounds: single rounds, a block of
  2, ``uniform`` C 2 and ``async`` (geometric lag, transients, node 1
  poisoned), records and state within 1e-5.  On one rank the sharded
  round is the same arithmetic (its ``all_reduce`` and gather are
  copies), so single rounds, blocks and ``async`` agree bit for bit;
  ``uniform`` differs in the last bits (~1e-7), because under a mesh a
  sampled round runs the masked path where the single-device one runs
  the compact one.  The node views, a save and a restore go through the
  gathers.
- The second round against the JAX package's ``Federation(mesh=
  make_local_mesh())`` under no plan, ``uniform`` C 2 and a deterministic
  ``async`` plan: the reference runs two full rounds, its state crosses
  through ``bridge.load_engine_state``, its next round's draws (and, for
  ``uniform``, the uniforms its sampler key gives) are fed to the port,
  at ``TOL`` / ``REL`` as ``test_torch_engine.py`` holds it.
- The reference's ``ValueError`` for a bucket that does not divide the
  shard count, and its fallback to one padded bucket, on mesh-like
  objects; ``data/pipeline.py``'s sharded staging on the one-rank mesh
  (every row); the kernel wrappers' device rule (any ``cuda:N``, one
  card a process) on stand-in tensors.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core import participation as jpart  # noqa: E402
from repro.core.federation import Federation as JFederation  # noqa: E402
from repro.core.federation import FederationConfig as JFedConfig  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.federation import (Federation,  # noqa: E402
                                         FederationConfig)
from repro_torch.core.participation import ParticipationPlan  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_engine import (BASE, HETERO, JTINY, TINY,  # noqa: E402
                               _close, _reference_draws)
from test_torch_participation import (_jax_round_uniforms,  # noqa: E402
                                      _ref_state, compare_participation,
                                      compare_records, compare_to_reference)
from _torch_threads import _one_thread  # noqa: E402,F401

P = ParticipationPlan
TOL1 = 1e-5                      # mesh against the single-device port


@pytest.fixture(scope="module")
def mesh():
    """The one-rank gloo mesh of this module."""
    assert not dist.is_initialized(), "a default group leaked into the worker"
    m = tmesh.make_local_mesh("cpu")
    yield m
    dist.destroy_process_group()


SHAPES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("pod", "data")), ((4,), ("data",)), ((8,), ("model",)),
          ((1, 1), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in SHAPES])
def test_batch_axes_and_n_nodes_match_reference(shape, axes):
    ours = tmesh.make_abstract_mesh(shape, axes)
    theirs = jmesh.make_abstract_mesh(shape, axes)
    assert tmesh.batch_axes(ours) == jmesh.batch_axes(theirs)
    assert tmesh.n_nodes(ours) == jmesh.n_nodes(theirs)
    assert ours.shape == dict(theirs.shape)


def test_local_mesh(mesh):
    assert tmesh.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert tmesh.batch_axes(mesh) == ("data",) and tmesh.n_nodes(mesh) == 1
    assert tmesh.shard_index(mesh) == 0
    assert tmesh.batch_group(mesh) is dist.group.WORLD
    assert tmesh.mesh_device(mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh((2, 2), ("pod", "data"), "cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="named axes"):
        tmesh.batch_axes(object())


# ----------------------------------------------------------------------
# against the single-device port
ASYNC = P(strategy="async", lag_dist="geometric", max_lag=2,
          transient_rate=0.3, poison_nodes=(1,), seed=3)
CASES = {"rounds": (None, 1), "block": (None, 2),
         "uniform": (P(strategy="uniform", cohort_size=2, seed=2), 1),
         "async": (ASYNC, 2)}


def _state(fed):
    return [t.clone() for t in tree_leaves(
        (fed._trains, fed._opts, fed.gbar, fed._server_m,
         getattr(fed, "_part_state", None)))]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_federation_matches_single_device(mesh, case):
    plan, block = CASES[case]
    fed = FederationConfig(method="geodora", **BASE, **HETERO)
    want = Federation(fed, TINY, device="cpu")
    got = Federation(fed, TINY, mesh=mesh)
    assert got.device == torch.device("cpu")
    h_want = want.run_rounds(2, block_size=block, participation=plan)
    h_got = got.run_rounds(2, block_size=block, participation=plan)
    if plan is None or plan.strategy == "async":
        compare_records(h_got, h_want, w_tol=TOL1)
    else:
        compare_participation(h_got, h_want)
    if plan is not None and plan.strategy == "async":
        for key in ("participation", "cohort_size", "delivered", "staleness",
                    "quarantined", "n_delivered"):
            assert [r[key] for r in h_got] == [r[key] for r in h_want], key
    bitwise = plan is None or plan.strategy == "async"
    for a, b in zip(_state(got), _state(want)):
        if bitwise:
            assert torch.equal(a, b)
        else:
            _close(a, b, TOL1, case)
    if bitwise:
        assert h_got == h_want
    # node views and node_params gather (one rank: the stacks themselves)
    for a, b in zip(tree_leaves(got.node_params(2)),
                    tree_leaves(want.node_params(2))):
        _close(a, b, TOL1, "node_params")


def test_mesh_checkpoint_round_trip(mesh, tmp_path):
    """A file saved under the mesh loads into the single-device federation
    and back into a fresh mesh federation with the same state."""
    fed = FederationConfig(method="geolora", **BASE)
    run = Federation(fed, TINY, mesh=mesh)
    run.run_rounds(2, participation=ASYNC)
    path = str(tmp_path / "ck.npz")
    run.save(path)
    others = (Federation(fed, TINY, device="cpu"),
              Federation(fed, TINY, mesh=mesh))
    for other in others:
        assert other.restore(path) == 2
        for a, b in zip(_state(other), _state(run)):
            assert torch.equal(a, b)
    # the three continue alike (the async round is bit for bit on a rank)
    want = run.run_rounds(1, participation=ASYNC)
    for other in others:
        assert other.run_rounds(1, participation=ASYNC) == want


# ----------------------------------------------------------------------
# against the JAX package's Federation on its one-device mesh
@pytest.fixture(scope="module")
def reference():
    """The reference on its local mesh after two full rounds, so every
    node's AdamW moments are warm."""
    ref = JFederation(JFedConfig(method="geodora", **BASE),
                      JTINY, mesh=jmesh.make_local_mesh())
    ref.run_rounds(2)
    return ref


DET = dict(strategy="async", lag=1, max_lag=2, poison_nodes=(1,))
JAX_PLANS = {"full": None,
             "uniform": dict(strategy="uniform", cohort_size=2, seed=2),
             "async": DET}


@pytest.mark.parametrize("case", list(JAX_PLANS))
def test_mesh_round_matches_reference(mesh, reference, case):
    ref, kw = reference, JAX_PLANS[case]
    port = Federation(FederationConfig(method="geodora", **BASE), TINY,
                      mesh=mesh)
    bridge.load_engine_state(port, _ref_state(ref))
    draws = _reference_draws(ref)
    port._stage = lambda m: draws
    if kw is None:
        want, got = ref.run_round(), port.run_round()
        compare_records([got], [want], w_tol=1e-4)
        _close(port.gbar, jax.device_get(ref.gbar), 1e-5, "consensus Gram")
        return
    jplan, plan = jpart.ParticipationPlan(**kw), P(**kw)
    if plan.strategy == "uniform":
        u, _ = _jax_round_uniforms(jplan, jpart.init_state(jplan, 4)["key"],
                                   port.engine._groups)
        stage = port._stage_part

        def staged(m, p):
            batches, _, pos = stage(m, p)
            return batches, torch.from_numpy(u)[None], pos
        port._stage_part = staged
    want = ref.run_rounds(1, participation=jplan)[0]
    got = port.run_rounds(1, participation=plan)[0]
    compare_to_reference(port, ref, got, want)


def test_pipeline_on_the_local_mesh(mesh):
    """On one rank the sharded pipeline stages every node row."""
    def streams():
        return [iter(pipe.SyntheticLMStream(64, 8, 2, seed=i))
                for i in range(3)]
    full = pipe.BlockStager(streams(), 2, 2).next_block()
    mine = pipe.BlockStager(streams(), 2, 2, sharding=mesh).next_block()
    assert all(torch.equal(mine[k], full[k]) for k in full)
    flat = {"x": np.arange(6).reshape(3, 2)}
    assert torch.equal(pipe.shard_batch(flat, mesh)["x"],
                       torch.from_numpy(flat["x"]))


def test_kernel_device_rule(monkeypatch):
    """The wrappers' ``_build.card``: any ``cuda:N`` (made current for the
    launch, not entered here), one card a process, nothing else."""
    class On:
        def __init__(self, device):
            self.device = torch.device(device)
    monkeypatch.setattr(_build, "_card", None)
    assert _build.card(On("cuda:2"), "gram").idx == 2
    assert _build.card(On("cuda:2"), "gram").idx == 2
    with pytest.raises(RuntimeError, match="process of its own"):
        _build.card(On("cuda:0"), "lora_matmul")
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="no kernel"):
            _build.card(On(dev), "flash_attention")


# ----------------------------------------------------------------------
class FakeMesh:
    shape = {"data": 3, "model": 1}


def test_bucket_must_divide_the_shards():
    """The reference's check (``RoundEngine``) and its layout fallback
    (``Federation._bucket_layout``) on mesh-like objects."""
    fed = Federation(FederationConfig(method="geolora", **BASE), TINY,
                     device="cpu")
    ecfg = fed.engine.ecfg                  # two buckets of two nodes
    with pytest.raises(ValueError, match="not divisible by the 3 mesh"):
        engine_mod.RoundEngine(ecfg, fed._local_step_nodes,
                               fed.engine.shipped_masks, device="cpu",
                               mesh=FakeMesh())

    class NoBatch:
        shape = {"model": 2}
    with pytest.raises(ValueError, match="no batch axes"):
        engine_mod.RoundEngine(ecfg, fed._local_step_nodes,
                               fed.engine.shipped_masks, device="cpu",
                               mesh=NoBatch())
    widths = [fed._node_width(n) for n in fed.nodes]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert fed._bucket_layout(widths, FakeMesh()) == \
            ((max(widths),), (tuple(range(4)),))
    assert any("falling back" in str(w.message) for w in caught)

    class TwoSlices:
        shape = {"pod": 1, "data": 2}
    assert fed._bucket_layout(widths, TwoSlices()) == \
        fed._bucket_layout(widths)
