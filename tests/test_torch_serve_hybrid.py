"""The port's ServeEngine on the hybrid family (RecurrentGemma) and on the
dense family's sliding-window variant, on the CPU against the JAX
ServeEngine in one process, with the same weights (JAX init -> numpy ->
``bridge``) and greedy decoding:

- served tokens identical (to the JAX engine and to the port's
  ``naive_generate``) for the hybrid (``reduced(recurrentgemma-9b)``
  at 5 layers, so the pool has a ``tail``; prompts of 80 tokens against a
  local window of 64) and the windowed dense case (``reduced(fedmm-base)``
  under ``Runtime(window_override=16)``, prompts of 40);
- ``scatter_slot`` / ``gather_slot`` round trip over ``groups`` (slot
  axis 1) and ``tail`` (slot axis 0);
- a chaos-frozen slot resumes bit-identically (the RG-LRU state held),
  as ``tests/test_serve_resilience.py`` checks the reference;
- a hybrid serve snapshot written by each package resumes in the other
  to the JAX engine's uncrashed tokens;
- the construction check (a configured sliding window wider than
  ``cache_len``) and the cache-length rule (the hybrid family has a
  limit, a configured sliding window has none) raise, and admit, as the
  reference does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (FaultPlan, ServeConfig,  # noqa: E402
                               ServeEngine, SimulatedCrash, naive_generate,
                               poisson_requests, state_counts)
from repro_torch.serve.pool import (gather_slot, init_pool_cache,  # noqa: E402
                                    scatter_slot)
from _torch_threads import _one_thread  # noqa: E402,F401


#: name -> (arch, config override, window_override, prompt length,
#: cache_len)
CASES = {"hybrid": ("recurrentgemma-9b", {"n_layers": 5}, 0, 80, 96),
         "windowed dense": ("fedmm-base", {}, 16, 40, 64)}
SCFG = ServeConfig(n_slots=3, block_steps=4, max_new_tokens=10)


def _model(name):
    arch, over, window, plen, cache_len = CASES[name]
    jcfg = jreduced(jget_config(arch)).with_(**over)
    tcfg = reduced(get_config(arch)).with_(**over)
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"),
                jrt=JT.Runtime(window_override=window) if window else None,
                trt=TT.Runtime(window_override=window) if window else None,
                plen=plen, scfg=dataclasses.replace(SCFG,
                                                    cache_len=cache_len))


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in CASES}


def _reqs(m, n, seed=3):
    return poisson_requests(n, 0.0, prompt_len=m["plen"],
                            vocab_size=m["tcfg"].vocab_size, seed=seed)


def _jreqs(reqs):
    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


def _port(m, scfg=None):
    return ServeEngine(m["tp"], m["tcfg"], scfg or m["scfg"], rt=m["trt"],
                       device="cpu")


def _jax(m, scfg=None):
    return JServeEngine(m["jp"], m["jcfg"], JServeConfig(
        **dataclasses.asdict(scfg or m["scfg"])), m["jrt"])


def _tokens(recs, reqs):
    return {r.rid: [int(t) for t in recs[r.rid].tokens] for r in reqs}


@pytest.mark.parametrize("name", list(CASES))
def test_served_tokens_match_jax_engine(models, name):
    """5 requests streaming through 3 slots (admissions mid-decode, slots
    reused): tokens, states and ``stats`` as the JAX engine's, and tokens
    as the port's legacy per-token loop (one request a batch)."""
    m = models[name]
    reqs = _reqs(m, 5)
    eng, jeng = _port(m), _jax(m)
    recs = eng.serve(reqs)
    jrecs = jeng.serve(_jreqs(reqs))
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    naive = naive_generate(m["tp"], m["tcfg"], reqs, dataclasses.replace(
        m["scfg"], n_slots=1), rt=m["trt"])
    assert _tokens(naive, reqs) == _tokens(recs, reqs)
    assert all(recs[r.rid].state == "completed" for r in reqs)
    assert eng.stats == jeng.stats


@pytest.mark.parametrize("name", list(CASES))
def test_scatter_gather_roundtrip(models, name):
    """scatter_slot writes every leaf of a prefilled request -- stacked
    ``groups`` on axis 1, ``tail`` on axis 0 -- into its slot in place;
    gather_slot copies it back; the other slots stay empty."""
    m = models[name]
    pool = init_pool_cache(m["tcfg"], 4, m["scfg"].cache_len, device="cpu",
                           rt=m["trt"])
    empty = init_pool_cache(m["tcfg"], 4, m["scfg"].cache_len, device="cpu",
                            rt=m["trt"])
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (1, m["plen"])).astype(np.int32))
    _, req = TT.prefill(m["tp"], {"tokens": toks}, m["tcfg"],
                        cache_len=m["scfg"].cache_len, rt=m["trt"])
    scatter_slot(pool, req, 2)
    back = gather_slot(pool, 2)
    flat = jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(req))
    got = dict(jax.tree_util.tree_leaves_with_path(
        bridge.params_to_numpy(back)))
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], leaf)
    for slot in (0, 1, 3):
        other = gather_slot(pool, slot)
        want = gather_slot(empty, slot)
        for a, b in zip(jax.tree_util.tree_leaves(
                bridge.params_to_numpy(other)),
                jax.tree_util.tree_leaves(bridge.params_to_numpy(want))):
            np.testing.assert_array_equal(a, b)
    if name == "hybrid":
        assert pool["tail"][0]["h"].shape[0] == 4       # slot axis 0
        assert pool["groups"]["b0"]["h"].shape[1] == 4  # slot axis 1


def test_freeze_resumes_bit_identically_like_jax(models):
    """``tests/test_serve_resilience.py``'s recurrent-state scenario on
    the hybrid: slot 0 frozen at steps 3-5 resumes bit-identically (its
    RG-LRU ``h`` and ``conv`` held), under and without the stall
    watchdog, in both packages."""
    m = models["hybrid"]
    scfg = dataclasses.replace(m["scfg"], n_slots=2, max_new_tokens=12)
    reqs = _reqs(m, 2, seed=19)
    clean = _port(m, scfg).serve(reqs)
    plan = FaultPlan(freeze_steps=(3, 4, 5), freeze_slots=(0,))
    for stall_blocks in (2, 0):
        s = dataclasses.replace(scfg, stall_blocks=stall_blocks)
        recs = _port(m, s).serve(reqs, fault_plan=plan)
        jrecs = _jax(m, s).serve(_jreqs(reqs), fault_plan=JFaultPlan(
            **dataclasses.asdict(plan)))
        assert state_counts(recs)["completed"] == 2
        assert _tokens(recs, reqs) == _tokens(clean, reqs) \
            == _tokens(jrecs, reqs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hybrid_snapshot_resumes_across_packages(models, tmp_path, writer):
    """A greedy hybrid snapshot (the pool's ``groups`` and ``tail``, the
    scheduler meta) written by either package after block 1 resumes in
    the other to the JAX engine's uncrashed tokens."""
    m = models["hybrid"]
    scfg = dataclasses.replace(m["scfg"], n_slots=2, max_new_tokens=12,
                               seed=1)
    reqs = _reqs(m, 3, seed=17)
    want = _jax(m, scfg).serve(_jreqs(reqs))
    snap = str(tmp_path / "serve.npz")
    if writer == "jax":
        with pytest.raises(JSimulatedCrash):
            _jax(m, scfg).serve(_jreqs(reqs), fault_plan=JFaultPlan(
                crash_after_block=1), snapshot_path=snap,
                snapshot_every_blocks=1)
        recs = ServeEngine.resume(snap, m["tp"], m["tcfg"],
                                  device="cpu").resume_serve()
    else:
        with pytest.raises(SimulatedCrash):
            _port(m, scfg).serve(reqs, fault_plan=FaultPlan(
                crash_after_block=1), snapshot_path=snap,
                snapshot_every_blocks=1)
        recs = JServeEngine.resume(snap, m["jp"], m["jcfg"]).resume_serve()
    assert sum(1 for r in reqs if recs[r.rid].state == "completed") == 3
    assert _tokens(recs, reqs) == _tokens(want, reqs)


def test_construction_and_cache_length_errors_match_reference(models):
    """A configured sliding window wider than ``cache_len`` is refused at
    construction; a hybrid request whose prompt + max_new + 1 exceeds
    ``cache_len`` is refused at admission; a configured sliding window
    has no cache-length limit, so a prompt longer than ``cache_len`` is
    served -- all as the JAX engine does, with its messages."""
    m = models["windowed dense"]
    jcfg = m["jcfg"].with_(sliding_window=16)
    tcfg = m["tcfg"].with_(sliding_window=16)
    small = dataclasses.replace(SCFG, cache_len=8)
    errors = []
    for make in (lambda: JServeEngine(m["jp"], jcfg, JServeConfig(
                     **dataclasses.asdict(small))),
                 lambda: ServeEngine(m["tp"], tcfg, small, device="cpu")):
        with pytest.raises(ValueError, match="sliding window") as err:
            make()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    scfg = dataclasses.replace(SCFG, cache_len=24, max_new_tokens=6)
    reqs = _reqs(m, 2)                                  # 40 > cache_len 24
    recs = ServeEngine(m["tp"], tcfg, scfg, device="cpu").serve(reqs)
    jrecs = JServeEngine(m["jp"], jcfg, JServeConfig(
        **dataclasses.asdict(scfg))).serve(_jreqs(reqs))
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    assert all(len(recs[r.rid].tokens) == 6 for r in reqs)

    h = models["hybrid"]
    tight = dataclasses.replace(h["scfg"], cache_len=h["plen"] + 5)
    errors = []
    for eng, rq in ((_jax(h, tight), _jreqs(_reqs(h, 1))),
                    (_port(h, tight), _reqs(h, 1))):
        with pytest.raises(ValueError, match="exceeds cache_len") as err:
            eng.serve(rq)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="n_slots"):
        _port(h, dataclasses.replace(h["scfg"], n_slots=0))
