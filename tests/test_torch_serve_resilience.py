"""The port's resilient serving on the CPU against the JAX engine, in one
process: the scenarios of tests/test_serve_resilience.py (SLO shedding,
deadlines, the output guards, the chaos plans, crash recovery) run
through both packages on the same weights (JAX init -> numpy -> bridge).

Greedy decoding is deterministic in both, so where a scenario does not
hang on the wall clock the two engines must end every request in the
same state with the same tokens, attempts and faults, and with equal
``stats``.  Scenarios driven by the wall clock (overload shedding, a
completion deadline) hold each package to the reference test's
invariants and the completed streams to each other.  Serve snapshots go
both ways: a greedy snapshot written by either package resumes in the
other to the uncrashed tokens.  At ``temperature > 0`` the RNGs differ,
so crash recovery is held to the port's own uncrashed run.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import state_counts as jstate_counts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    load_checkpoint)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.serve import (FaultPlan, ServeConfig,  # noqa: E402
                               ServeEngine, SimulatedCrash, poisson_requests,
                               seeded_plan, state_counts)
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")


def _model(jcfg, tcfg):
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(jax.device_get(jp),
                                                    "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _model(jget_config("fedmm-small").with_(**TINY),
                  get_config("fedmm-small").with_(**TINY))


@pytest.fixture(scope="module")
def mamba():
    return _model(jreduced(jget_config("falcon-mamba-7b")),
                  reduced(get_config("falcon-mamba-7b")))


def _reqs(model, n, seed=3, prompt_len=8):
    return poisson_requests(n, 0.0, prompt_len=prompt_len,
                            vocab_size=model[1].vocab_size, seed=seed)


def _jplan(plan):
    return None if plan is None else JFaultPlan(**dataclasses.asdict(plan))


def _port(model, scfg, **kw):
    return ServeEngine(model[3], model[1], scfg, device="cpu", **kw)


def _jax(model, scfg):
    return JServeEngine(model[2], model[0],
                        JServeConfig(**dataclasses.asdict(scfg)))


def _both(model, scfg, reqs, plan=None):
    """(port records, port engine, JAX records, JAX engine)."""
    eng, jeng = _port(model, scfg), _jax(model, scfg)
    recs = eng.serve(reqs, fault_plan=plan)
    jrecs = jeng.serve([JRequest(**dataclasses.asdict(r)) for r in reqs],
                       fault_plan=_jplan(plan))
    return recs, eng, jrecs, jeng


def _accounting(recs, n):
    counts = state_counts(recs)
    assert sum(counts.get(s, 0) for s in
               ("completed", "shed", "timed_out", "failed")) == n, counts
    return counts


def _assert_same(reqs, recs, eng, jrecs, jeng):
    """The two engines agree on every request and on ``stats``."""
    assert state_counts(recs) == jstate_counts(jrecs)
    for r in reqs:
        a, b = recs[r.rid], jrecs[r.rid]
        assert (a.state, a.tokens, a.attempts, a.faults) \
            == (b.state, [int(t) for t in b.tokens], b.attempts, b.faults), \
            r.rid
    assert eng.stats == jeng.stats


# ================================================== SLOs on the clock
def test_overload_sheds_and_completes_rest_in_both(tiny):
    """Bounded queue + TTFT deadline: in both packages overload ends in
    shed requests and completed ones, never an error; every completed
    stream matches its package's fault-free run, and the two packages'
    fault-free runs match each other."""
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=24, queue_cap=1,
                       ttft_deadline_s=1e-4)
    free = dataclasses.replace(scfg, queue_cap=None, ttft_deadline_s=None)
    reqs = _reqs(tiny, 6)
    clean, _, jclean, _ = _both(tiny, free, reqs)
    recs, _, jrecs, _ = _both(tiny, scfg, reqs)
    for got, want in ((recs, clean), (jrecs, jclean)):
        counts = _accounting(got, 6)
        assert counts["shed"] >= 1 and counts["completed"] >= 2
        for r in reqs:
            if got[r.rid].state == "completed":
                assert [int(t) for t in got[r.rid].tokens] \
                    == [int(t) for t in want[r.rid].tokens]
            if got[r.rid].state == "shed":
                assert got[r.rid].tokens == [] and got[r.rid].attempts == 0
    for r in reqs:
        assert clean[r.rid].tokens == [int(t) for t in jclean[r.rid].tokens]


def test_completion_deadline_times_out_slot_in_both(tiny):
    """A host delay pushes each request past its completion deadline: the
    watchdog cancels the slot at the next block boundary, and each partial
    stream is a prefix of the fault-free run, in both packages."""
    scfg = ServeConfig(n_slots=1, cache_len=64, block_steps=4,
                       max_new_tokens=24, deadline_s=0.05)
    reqs = _reqs(tiny, 2)
    clean, _, jclean, _ = _both(tiny, dataclasses.replace(
        scfg, deadline_s=None), reqs)
    plan = FaultPlan(delay_blocks=(1, 7), delay_s=0.2)
    recs, eng, jrecs, _ = _both(tiny, scfg, reqs, plan)
    for got in (recs, jrecs):
        assert _accounting(got, 2)["timed_out"] == 2
        for r in reqs:
            toks = [int(t) for t in got[r.rid].tokens]
            assert toks == clean[r.rid].tokens[:len(toks)]
            assert 0 < len(toks) < 24
    assert eng.graph_stats["captures"] == 0          # eager on the CPU


# ============================================ output guards and chaos
GUARD_CASES = {
    # NaN-poisoned steps trip the guard; the poisoned token is never
    # emitted and every request retries to its clean stream
    "nan retries": (dict(n_slots=3, max_new_tokens=10, max_attempts=3), 5,
                    11, FaultPlan(nan_steps=(3, 6), nan_slots=(0, 1))),
    # every decode step poisoned: the retry budget runs out -> failed
    "poison every step": (dict(n_slots=1, max_new_tokens=8,
                               max_attempts=2), 2, 5,
                          FaultPlan(nan_steps=tuple(range(512)))),
    # a frozen slot is reclaimed by the zero-progress watchdog and retried
    "stall watchdog": (dict(n_slots=2, max_new_tokens=12, max_attempts=3,
                            stall_blocks=2), 2, 9,
                       FaultPlan(freeze_steps=tuple(range(4, 12)),
                                 freeze_slots=(0,))),
    # the same freeze with the watchdog off only delays the same result
    "freeze, watchdog off": (dict(n_slots=2, max_new_tokens=12,
                                  max_attempts=3), 2, 9,
                             FaultPlan(freeze_steps=tuple(range(4, 12)),
                                       freeze_slots=(0,))),
    # NaN, a freeze and a host delay at once, with a (loose) deadline
    "composite": (dict(n_slots=3, max_new_tokens=12, max_attempts=2,
                       stall_blocks=2, deadline_s=30.0), 8, 23,
                  FaultPlan(nan_steps=(5, 9), nan_slots=(0,),
                            freeze_steps=tuple(range(8, 16)),
                            freeze_slots=(1,), delay_blocks=(2,),
                            delay_s=0.01)),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_chaos_plan_ends_like_jax(tiny, case):
    """Each chaos plan ends every request in the same terminal state with
    the same tokens, attempts and faults as the JAX engine, with equal
    stats; no stream carries a token the fault-free run lacks."""
    kw, n, seed, plan = GUARD_CASES[case]
    scfg = ServeConfig(cache_len=64, block_steps=4, **kw)
    reqs = _reqs(tiny, n, seed=seed)
    clean = _port(tiny, dataclasses.replace(scfg, deadline_s=None)).serve(
        reqs)
    recs, eng, jrecs, jeng = _both(tiny, scfg, reqs, plan)
    _assert_same(reqs, recs, eng, jrecs, jeng)
    counts = _accounting(recs, n)
    for r in reqs:
        got = recs[r.rid].tokens
        assert got == clean[r.rid].tokens[:len(got)], r.rid
    if case == "poison every step":
        assert counts["failed"] == 2
        assert all(recs[r.rid].attempts == 2
                   and len(recs[r.rid].tokens) <= 1 for r in reqs)
    elif case != "composite":
        assert counts["completed"] == n
        assert all(recs[r.rid].tokens == clean[r.rid].tokens for r in reqs)
    if case == "nan retries":
        assert eng.stats["faults_detected"] >= 1
    if case == "stall watchdog":
        assert eng.stats["stalls_detected"] >= 1


def test_repetition_guard_catches_forced_token_like_jax(tiny):
    """A finite forced token slips past the non-finite guard but trips the
    repetition guard; the retry, past the forced window, completes clean,
    in both packages alike."""
    base = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=40, max_attempts=3)
    reqs = _reqs(tiny, 2, seed=7)
    probe = _port(tiny, base).serve(reqs)
    longest = max(max(sum(1 for _ in g) for _, g in itertools.groupby(
        probe[r.rid].tokens)) for r in reqs)
    max_rep = longest + 2
    assert max_rep <= 32, "degenerate model: clean run is one long repeat"
    scfg = dataclasses.replace(base, max_repeat=max_rep,
                               max_new_tokens=max_rep + 6)
    plan = FaultPlan(force_steps=tuple(range(1, max_rep + 2)),
                     force_token=17)
    recs, eng, jrecs, jeng = _both(tiny, scfg, reqs, plan)
    _assert_same(reqs, recs, eng, jrecs, jeng)
    assert eng.stats["faults_detected"] >= 1
    assert _accounting(recs, 2)["completed"] == 2
    for r in reqs:
        assert recs[r.rid].tokens == probe[r.rid].tokens[:max_rep + 6]
        assert recs[r.rid].retries >= 1


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_freeze_resumes_bit_identically_like_jax(tiny, mamba, family):
    """A chaos-frozen slot that resumes continues exactly: attention by
    its frozen position, ssm by keeping its recurrent state -- the tokens
    equal the fault-free run's and the JAX engine's."""
    model = {"dense": tiny, "ssm": mamba}[family]
    scfg = ServeConfig(n_slots=2, cache_len=96, block_steps=4,
                       max_new_tokens=12)
    reqs = _reqs(model, 2, seed=19)
    clean = _port(model, scfg).serve(reqs)
    plan = FaultPlan(freeze_steps=(3, 4, 5), freeze_slots=(0,))
    recs, eng, jrecs, jeng = _both(model, scfg, reqs, plan)
    _assert_same(reqs, recs, eng, jrecs, jeng)
    assert _accounting(recs, 2)["completed"] == 2
    for r in reqs:
        assert recs[r.rid].tokens == clean[r.rid].tokens, r.rid


def test_nan_weights_at_temperature_retry_then_fail_like_jax(tiny):
    """NaN weights at temperature 0.7 (greedy: tests/test_torch_serve.py)
    trip the guard at every admission: each request retries to
    max_attempts and ends ``failed`` as in the JAX engine, and the
    sampler does not raise on the NaN rows."""
    jcfg, tcfg, jp, tp = tiny
    jbad = dict(jp, lm_head={"w": jp["lm_head"]["w"] * jnp.nan})
    tbad = dict(tp, lm_head={"w": tp["lm_head"]["w"] * float("nan")})
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=2,
                       max_new_tokens=6, max_attempts=2, temperature=0.7)
    reqs = _reqs(tiny, 3, seed=8, prompt_len=5)
    recs, eng, jrecs, jeng = _both((jcfg, tcfg, jbad, tbad), scfg, reqs)
    assert state_counts(recs) == jstate_counts(jrecs)
    assert _accounting(recs, 3)["failed"] == 3
    assert eng.stats["faults_detected"] == jeng.stats["faults_detected"] \
        == 6
    assert eng.stats == jeng.stats
    assert [recs[r.rid].attempts for r in reqs] == [2, 2, 2]


# ================================================= the plans themselves
@pytest.mark.parametrize("seed,kw", [
    (0, dict(nan_rate=0.2)),
    (7, dict(nan_rate=0.1, freeze_rate=0.05, freeze_span=3)),
    (13, dict(freeze_rate=0.2, delay_rate=0.3, delay_s=0.01,
              crash_after_block=4)),
])
def test_seeded_plan_equals_jax(seed, kw):
    got = seeded_plan(seed, n_steps=64, n_slots=5, **kw)
    want = jfaults.seeded_plan(seed, n_steps=64, n_slots=5, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.device_silent == want.device_silent
    assert hash(got) == hash(FaultPlan(**dataclasses.asdict(got)))


def test_poison_and_freeze_match_jax_at_every_step():
    """``poison_logits`` / ``freeze_mask`` on the plan's device tensors
    give JAX's values at every global step, NaNs in the same places."""
    plan = FaultPlan(nan_steps=(2, 5), nan_slots=(1,),
                     force_steps=(3, 5), force_slots=(0, 2), force_token=4,
                     freeze_steps=(1, 2), freeze_slots=())
    logits = np.random.default_rng(0).standard_normal((3, 9)).astype(
        np.float32)
    dplan = plan.on_device(3, 9, "cpu")
    for t in range(7):
        tt = torch.tensor(t, dtype=torch.int32)
        got = tfaults.poison_logits(dplan, tt, torch.from_numpy(logits))
        want = jfaults.poison_logits(_jplan(plan), jnp.int32(t),
                                     jnp.asarray(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tfaults.freeze_mask(dplan, tt).numpy(),
            np.asarray(jfaults.freeze_mask(_jplan(plan), jnp.int32(t), 3)))
    assert tfaults.device_key(plan) == plan
    host_only = FaultPlan(delay_blocks=(1,), delay_s=1.0, crash_after_block=2)
    assert tfaults.device_key(host_only) is tfaults.device_key(None) is None
    assert tfaults.device_key(dataclasses.replace(
        plan, delay_blocks=(3,), crash_after_block=1)) == plan
    assert tfaults.poison_logits(None, tt, torch.ones(2)).tolist() == [1, 1]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_block_and_admission_write_the_state_in_place(tiny, mamba, family,
                                                      tmp_path):
    """A CUDA graph reads and writes fixed buffers, so the block and eager
    admission must update the engine's state tensors where they lie --
    through a chaos plan at temperature > 0, a snapshot and a resume --
    never rebind them."""
    model = {"dense": tiny, "ssm": mamba}[family]
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=10, temperature=0.7, max_attempts=3)
    eng = _port(model, scfg)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.state)]
    plan = FaultPlan(nan_steps=(2,), freeze_steps=(5, 6), freeze_slots=(1,))
    snap = str(tmp_path / "s.npz")
    recs = eng.serve(_reqs(model, 3), fault_plan=plan, snapshot_path=snap,
                     snapshot_every_blocks=2)
    assert _accounting(recs, 3)["completed"] == 3
    assert eng.stats["faults_detected"] >= 1
    assert [t.data_ptr() for t in tree_leaves(eng.state)] == ptrs
    assert int(eng.state["t"]) == 4 * eng.stats["block_dispatches"]
    back = ServeEngine.resume(snap, model[3], model[1], device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(back.state)]
    back.resume_serve(fault_plan=plan)
    assert [t.data_ptr() for t in tree_leaves(back.state)] == ptrs


def test_sync_ttft_reads_each_first_token_like_jax(tiny):
    """``sync_ttft`` blocks once per admission on the first token (counted
    in ``request_reads``) and stamps TTFT there; tokens and stats match the
    JAX engine's."""
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=6)
    reqs = _reqs(tiny, 3, seed=4)
    eng, jeng = _port(tiny, scfg), _jax(tiny, scfg)
    recs = eng.serve(reqs, sync_ttft=True)
    jrecs = jeng.serve([JRequest(**dataclasses.asdict(r)) for r in reqs],
                       sync_ttft=True)
    _assert_same(reqs, recs, eng, jrecs, jeng)
    assert eng.stats["request_reads"] == eng.stats["admit_dispatches"] == 3
    assert all(recs[r.rid].first_token_s <= recs[r.rid].finished_s
               for r in reqs)


def test_capture_is_refused_off_the_card(tiny):
    """The decode block is captured on cuda only; on the CPU ``serve``
    runs it eagerly and ``capture`` raises instead of pretending."""
    eng = _port(tiny, ServeConfig(n_slots=1, cache_len=32))
    with pytest.raises(ValueError, match="cuda"):
        eng.capture()


# ===================================================== snapshot/resume
@pytest.mark.parametrize("every,crash", [(1, 1), (2, 2)])
def test_crash_resume_matches_uncrashed_run_at_temperature(tiny, tmp_path,
                                                           every, crash):
    """Kill-and-resume through the serve snapshot at temperature 0.7: the
    resumed engine completes every request with the uncrashed run's tokens
    (the snapshot carries the sampler's generator state and the step
    counter), also when the snapshot predates the crash by a block."""
    scfg = ServeConfig(n_slots=3, cache_len=64, block_steps=4,
                       max_new_tokens=16, temperature=0.7, seed=42)
    reqs = _reqs(tiny, 5, seed=13)
    want = _port(tiny, scfg).serve(reqs)
    snap = str(tmp_path / "serve.npz")
    eng = _port(tiny, scfg)
    with pytest.raises(SimulatedCrash, match="resume from"):
        eng.serve(reqs, fault_plan=FaultPlan(crash_after_block=crash),
                  snapshot_path=snap, snapshot_every_blocks=every)
    assert eng.stats["snapshot_writes"] == (crash + 1) // every
    partial = {rid: list(rec.tokens)
               for rid, rec in eng._sched.records.items()}
    running = [rid for rid, rec in eng._sched.records.items()
               if rec.state == "running"]
    assert running
    eng2 = ServeEngine.resume(snap, tiny[3], tiny[1], device="cpu")
    assert eng2.scfg == scfg
    assert eng2._blocks_done == (crash + 1) // every * every
    recs = eng2.resume_serve()
    assert _accounting(recs, 5)["completed"] == 5
    for r in reqs:
        assert recs[r.rid].tokens == want[r.rid].tokens, r.rid
        got = [int(t) for t in partial[r.rid]]
        assert recs[r.rid].tokens[:len(got)] == got, r.rid
    with pytest.raises(RuntimeError, match="no restored stream"):
        eng2.resume_serve()


def _crash(eng, reqs, snap, crash_type, plan_type):
    with pytest.raises(crash_type):
        eng.serve(reqs, fault_plan=plan_type(crash_after_block=1),
                  snapshot_path=snap, snapshot_every_blocks=1)


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_greedy_snapshot_resumes_across_packages(tiny, mamba, tmp_path,
                                                 family, writer):
    """A greedy snapshot written by either package resumes in the other
    to the JAX engine's uncrashed tokens: the same leaf set, names, shapes
    and dtypes, and the same scheduler meta."""
    model = {"dense": tiny, "ssm": mamba}[family]
    jcfg, tcfg, jp, tp = model
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=12, seed=1)
    reqs = _reqs(model, 3, seed=17)
    jreqs = [JRequest(**dataclasses.asdict(r)) for r in reqs]
    want = _jax(model, scfg).serve(jreqs)
    snap = str(tmp_path / "serve.npz")
    if writer == "jax":
        _crash(_jax(model, scfg), jreqs, snap, JSimulatedCrash, JFaultPlan)
        recs = ServeEngine.resume(snap, tp, tcfg,
                                  device="cpu").resume_serve()
    else:
        _crash(_port(model, scfg), reqs, snap, SimulatedCrash, FaultPlan)
        recs = JServeEngine.resume(snap, jp, jcfg).resume_serve()
    assert _accounting(recs, 3)["completed"] == 3
    for r in reqs:
        assert [int(t) for t in recs[r.rid].tokens] \
            == [int(t) for t in want[r.rid].tokens], r.rid


def test_resume_rejects_corrupt_and_mismatched_snapshots(tiny, tmp_path):
    jcfg, tcfg, jp, tp = tiny
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=8)
    snap = str(tmp_path / "serve.npz")
    _crash(_port(tiny, scfg), _reqs(tiny, 3), snap, SimulatedCrash,
           FaultPlan)
    # truncation -> CheckpointError with the path in the message
    with open(snap, "rb") as fh:
        blob = fh.read()
    trunc = str(tmp_path / "trunc.npz")
    with open(trunc, "wb") as fh:
        fh.write(blob[:len(blob) // 3])
    with pytest.raises(CheckpointError, match="trunc"):
        ServeEngine.resume(trunc, tp, tcfg, device="cpu")
    # a non-serve checkpoint (here one the JAX package wrote) -> ValueError
    other = str(tmp_path / "other.npz")
    jsave(other, {"x": jnp.zeros((2,))}, meta={"a": 1})
    with pytest.raises(ValueError, match="not a serve snapshot"):
        ServeEngine.resume(other, tp, tcfg, device="cpu")
    # wrong model family -> ValueError before any device work
    with pytest.raises(ValueError, match="family|model"):
        ServeEngine.resume(snap, tp, get_config("falcon-mamba-7b"),
                           device="cpu")
    # another serve configuration's pool -> the leaf shapes disagree
    eng = _port(tiny, dataclasses.replace(scfg, n_slots=3))
    eng.serve(_reqs(tiny, 1), snapshot_path=snap, snapshot_every_blocks=1)
    with pytest.raises(CheckpointError, match="shape"):
        load_checkpoint(snap, _port(tiny, scfg)._snapshot_tree())
