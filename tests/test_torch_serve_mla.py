"""The port's ServeEngine on DeepSeek-V2's MLA (``reduced(deepseek-v2-
236b)``: 2 layers, kv_lora 64, q_lora 48, rope 32, 4 experts top-2 + 1
shared, capacity factor 8.0 as ``tests/test_serve.py`` runs it; f32) on
the CPU against the JAX ServeEngine in one process, with the same
weights (JAX init -> numpy -> ``bridge``) and greedy decoding:

- served tokens, states and ``stats`` identical to the JAX engine's (and
  the port's ``naive_generate``) for 5 requests through 3 slots x 64, M
  4, slots reused mid-stream, and with ``q_lora_rank=0``;
- the latent pool's ``c_kv`` / ``k_rope`` leaves ride ``scatter_slot`` /
  ``gather_slot`` on the slot axis (axis 1);
- a greedy MLA snapshot written by either package resumes in the other
  to the JAX engine's uncrashed tokens.
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
from repro_torch.checkpoint import read_meta  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (FaultPlan, ServeConfig,  # noqa: E402
                               ServeEngine, SimulatedCrash, gather_slot,
                               init_pool_cache, naive_generate,
                               poisson_requests, scatter_slot)
from _torch_threads import _one_thread  # noqa: E402,F401

ARCH = "deepseek-v2-236b"
SCFG = ServeConfig(n_slots=3, cache_len=64, block_steps=4, max_new_tokens=8)


def _model(q_lora=None):
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    over = {"moe": dataclasses.replace(tcfg.moe, capacity_factor=8.0)}
    if q_lora is not None:
        over["mla"] = dataclasses.replace(tcfg.mla, q_lora_rank=q_lora)
    jcfg, tcfg = jcfg.with_(**over), tcfg.with_(**over)
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"))


@pytest.fixture(scope="module")
def model():
    return _model()


def _reqs(cfg, n=5, prompt_len=8, seed=3):
    return poisson_requests(n, 0.0, prompt_len=prompt_len,
                            vocab_size=cfg.vocab_size, seed=seed)


def _jreqs(reqs):
    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


def _tokens(recs, reqs):
    return {r.rid: [int(t) for t in recs[r.rid].tokens] for r in reqs}


def _serve_both(m, reqs, scfg=SCFG):
    eng = ServeEngine(m["tp"], m["tcfg"], scfg, device="cpu")
    jeng = JServeEngine(m["jp"], m["jcfg"],
                        JServeConfig(**dataclasses.asdict(scfg)))
    return eng, eng.serve(reqs), jeng, jeng.serve(_jreqs(reqs))


def test_served_tokens_match_jax_engine(model):
    """5 requests through 3 slots (admissions mid-decode, slots reused):
    tokens, states and ``stats`` as the JAX engine's, and tokens as the
    port's per-token loop."""
    reqs = _reqs(model["tcfg"])
    eng, recs, jeng, jrecs = _serve_both(model, reqs)
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    assert all(recs[r.rid].state == "completed" for r in reqs)
    assert all(len(recs[r.rid].tokens) == SCFG.max_new_tokens for r in reqs)
    assert eng.stats == jeng.stats
    naive = naive_generate(model["tp"], model["tcfg"], reqs,
                           dataclasses.replace(SCFG, n_slots=1))
    assert _tokens(naive, reqs) == _tokens(recs, reqs)


def test_served_tokens_match_jax_engine_without_q_lora():
    """The ``wq`` query path (``q_lora_rank=0``), longer prompts of 20
    tokens, 2 slots."""
    m = _model(q_lora=0)
    reqs = _reqs(m["tcfg"], n=3, prompt_len=20, seed=11)
    _, recs, _, jrecs = _serve_both(m, reqs,
                                    dataclasses.replace(SCFG, n_slots=2))
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)


def test_latent_pool_scatters_on_the_slot_axis(model):
    """A prefilled request's latents land in its slot of the pool (axis
    1 of every (L, S, C, .) leaf) and come back out whole; the other slots
    stay zero."""
    cfg = model["tcfg"]
    pool = init_pool_cache(cfg, 3, 32, device="cpu")
    assert set(pool) == {"c_kv", "k_rope", "len"}
    assert tuple(pool["c_kv"].shape) == (cfg.n_layers, 3, 32,
                                         cfg.mla.kv_lora_rank)
    toks = torch.from_numpy(np.arange(1, 12, dtype=np.int32))[None]
    _, req = TT.prefill(model["tp"], {"tokens": toks}, cfg, cache_len=32)
    scatter_slot(pool, req, 1)
    back = gather_slot(pool, 1)
    for name, leaf in req.items():
        assert torch.equal(back[name], leaf), name
    assert int(pool["len"][1]) == 11
    for slot in (0, 2):
        assert not bool(gather_slot(pool, slot)["c_kv"].any())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mla_snapshot_resumes_across_packages(model, tmp_path, writer):
    """A greedy MLA snapshot (the latent pool, the scheduler meta) written
    by either package after block 1 resumes in the other to the JAX
    engine's uncrashed tokens."""
    m = model
    scfg = dataclasses.replace(SCFG, n_slots=2, max_new_tokens=10, seed=1)
    reqs = _reqs(m["tcfg"], n=3, prompt_len=12, seed=17)
    want = JServeEngine(m["jp"], m["jcfg"], JServeConfig(
        **dataclasses.asdict(scfg))).serve(_jreqs(reqs))
    snap = str(tmp_path / "serve.npz")
    if writer == "jax":
        with pytest.raises(JSimulatedCrash):
            JServeEngine(m["jp"], m["jcfg"], JServeConfig(
                **dataclasses.asdict(scfg))).serve(
                _jreqs(reqs), fault_plan=JFaultPlan(crash_after_block=1),
                snapshot_path=snap, snapshot_every_blocks=1)
        recs = ServeEngine.resume(snap, m["tp"], m["tcfg"],
                                  device="cpu").resume_serve()
    else:
        with pytest.raises(SimulatedCrash):
            ServeEngine(m["tp"], m["tcfg"], scfg, device="cpu").serve(
                reqs, fault_plan=FaultPlan(crash_after_block=1),
                snapshot_path=snap, snapshot_every_blocks=1)
        recs = JServeEngine.resume(snap, m["jp"], m["jcfg"]).resume_serve()
    assert read_meta(snap)["model_family"] == "moe"
    assert sum(1 for r in reqs if recs[r.rid].state == "completed") == 3
    assert _tokens(recs, reqs) == _tokens(want, reqs)
