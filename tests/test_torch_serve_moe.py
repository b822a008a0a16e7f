"""The port's ServeEngine on the moe family (``reduced(llama4-scout-17b-
a16e)``: 2 layers, 4 experts top-1 plus 1 shared, chunked attention of
64) on the CPU against the JAX ServeEngine in one process, with the same
weights (JAX init -> numpy -> ``bridge``) and greedy decoding:

- served tokens, states and ``stats`` identical to the JAX engine's (and
  the port's ``naive_generate``) for 5 requests of 70-200 prompt tokens
  through 3 slots x 256 (rings of 64), M 4, at capacity factor 1.25 and
  0.75 (where every prefill's busiest expert is over capacity, so the
  routing's tie order decides which tokens it drops);
- a moe serve snapshot (meta ``model_family`` "moe") written by either
  package resumes in the other to the JAX engine's uncrashed tokens;
- prompt + max_new + 1 > ``cache_len`` raises at admission, and a
  ``cache_len`` below the chunk fails at the first admission's scatter,
  in both packages;
- a reduced DeepSeek-V2 engine (MLA, served since slice 14) admits and
  steps; the ``full`` mask runs in ``gqa_forward`` (since the audio
  slice) and still raises ``NotImplementedError`` in the slot decode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import read_meta  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.serve import (FaultPlan, ServeConfig,  # noqa: E402
                               ServeEngine, SimulatedCrash, naive_generate,
                               poisson_requests)
from _torch_threads import _one_thread  # noqa: E402,F401


ARCH = "llama4-scout-17b-a16e"
SCFG = ServeConfig(n_slots=3, cache_len=256, block_steps=4,
                   max_new_tokens=6)
PROMPT_LENS = (70, 200, 131, 70, 200)


def _model(factor):
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                              capacity_factor=factor))
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                              capacity_factor=factor))
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {f: _model(f) for f in (1.25, 0.75)}


def _reqs(m, lens=PROMPT_LENS, seed=3):
    return [dataclasses.replace(poisson_requests(
        1, 0.0, prompt_len=n, vocab_size=m["tcfg"].vocab_size,
        seed=seed + i)[0], rid=i) for i, n in enumerate(lens)]


def _jreqs(reqs):
    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


def _port(m, scfg=SCFG):
    return ServeEngine(m["tp"], m["tcfg"], scfg, device="cpu")


def _jax(m, scfg=SCFG):
    return JServeEngine(m["jp"], m["jcfg"],
                        JServeConfig(**dataclasses.asdict(scfg)))


def _tokens(recs, reqs):
    return {r.rid: [int(t) for t in recs[r.rid].tokens] for r in reqs}


def _overflow(m, tokens) -> int:
    """Tokens of a prompt's prefill routed to layer 0's busiest expert
    beyond its capacity, from the port's own blocks."""
    cfg, p = m["tcfg"], m["tp"]
    bp = {k: jax.tree_util.tree_map(lambda x: x[0], v)
          for k, v in p["blocks"].items()}
    x = p["embed"][torch.tensor(tokens).long()][None]
    h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    x = x + tattn.gqa_forward(bp["attn"], h, cfg, kind="chunked",
                              window=cfg.attention_chunk)
    _, idx, _ = moe.router_scores(
        bp["moe"], rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps), cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
    return int(counts.max()) - moe._capacity(len(tokens), 1, 4,
                                             cfg.moe.capacity_factor)


@pytest.mark.parametrize("factor", [1.25, 0.75])
def test_served_tokens_match_jax_engine(models, factor):
    """5 requests streaming through 3 slots (admissions mid-decode, slots
    reused, prompts across 1-3 chunk boundaries): tokens, states and
    ``stats`` as the JAX engine's, and tokens as the port's per-token
    loop.  At factor 0.75 every prompt's prefill drops tokens."""
    m = models[factor]
    reqs = _reqs(m)
    if factor < 1:
        assert all(_overflow(m, r.tokens) > 0 for r in reqs)
    eng, jeng = _port(m), _jax(m)
    recs = eng.serve(reqs)
    jrecs = jeng.serve(_jreqs(reqs))
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    assert all(recs[r.rid].state == "completed" for r in reqs)
    assert eng.stats == jeng.stats
    naive = naive_generate(m["tp"], m["tcfg"], reqs,
                           dataclasses.replace(SCFG, n_slots=1))
    assert _tokens(naive, reqs) == _tokens(recs, reqs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_snapshot_resumes_across_packages(models, tmp_path, writer):
    """A greedy moe snapshot (the ring pool, the scheduler meta) written by
    either package after block 1 resumes in the other to the JAX
    engine's uncrashed tokens."""
    m = models[1.25]
    scfg = dataclasses.replace(SCFG, n_slots=2, max_new_tokens=10, seed=1)
    reqs = _reqs(m, (70, 131, 70), seed=17)
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
    assert read_meta(snap)["model_family"] == "moe"
    assert sum(1 for r in reqs if recs[r.rid].state == "completed") == 3
    assert _tokens(recs, reqs) == _tokens(want, reqs)


def test_cache_length_rules_match_reference(models):
    """prompt + max_new + 1 > cache_len raises at admission with the
    reference's message; a cache_len under the chunk (a pool ring of 48
    against prefill's ring of 64) fails at the first admission in both
    packages, as the reference's rule leaves it."""
    m = models[1.25]
    tight = dataclasses.replace(SCFG, cache_len=205)    # 200 + 6 + 1 > 205
    errors = []
    for serve in (lambda: _jax(m, tight).serve(_jreqs(_reqs(m, (200,)))),
                  lambda: _port(m, tight).serve(_reqs(m, (200,)))):
        with pytest.raises(ValueError, match="exceeds cache_len") as err:
            serve()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    short = dataclasses.replace(SCFG, cache_len=48)
    with pytest.raises(TypeError, match="update shape"):
        _jax(m, short).serve(_jreqs(_reqs(m, (20,))))
    with pytest.raises(RuntimeError, match="48.*64"):
        _port(m, short).serve(_reqs(m, (20,)))


def test_reduced_deepseek_engine_admits_and_steps():
    """MLA, refused before slice 14: a ``ServeEngine`` on the reduced
    DeepSeek-V2 (random weights from a seed) admits 3 requests into its
    latent pool and steps them to completion (``tests/test_torch_serve_
    mla.py`` holds the tokens against the JAX engine)."""
    cfg = reduced(get_config("deepseek-v2-236b"))
    assert cfg.family == "moe" and cfg.mla is not None
    eng = ServeEngine(TT.init_params(0, cfg, device="cpu"), cfg,
                      dataclasses.replace(SCFG, cache_len=64), device="cpu")
    assert set(eng.state["cache"]) == {"c_kv", "k_rope", "len"}
    reqs = poisson_requests(3, 0.0, prompt_len=20,
                            vocab_size=cfg.vocab_size, seed=5)
    recs = eng.serve(reqs)
    assert all(recs[r.rid].state == "completed"
               and len(recs[r.rid].tokens) == SCFG.max_new_tokens
               for r in reqs)
    assert eng.stats["admit_dispatches"] == 3
    assert eng.stats["block_dispatches"] >= 1


def test_full_mask_still_raises():
    """Since the audio slice ``gqa_forward`` runs the full mask (held
    against the reference's on Scout's attention, RoPE and all); the
    slot decode still raises on it (the audio decoder's cross decode is
    ``gqa_cross_decode``)."""
    scout = reduced(get_config(ARCH))
    attn0 = jax.tree_util.tree_map(
        lambda w: w[0], TT.init_params(0, scout, device="cpu")["blocks"]["attn"])
    x = np.random.default_rng(3).standard_normal(
        (1, 4, scout.d_model)).astype(np.float32)
    got = tattn.gqa_forward(attn0, torch.from_numpy(x), scout, kind="full")
    want = JA.gqa_forward(jax.tree_util.tree_map(lambda w: w.numpy(), attn0),
                          x, jreduced(jget_config(ARCH)), kind="full")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    kv = torch.zeros((1, 8, scout.n_kv_heads, scout.head_dim))
    cache = {"k": kv, "v": kv.clone(),
             "pos": torch.zeros((1, 8), dtype=torch.int32),
             "lens": torch.zeros((1,), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="full"):
        tattn.gqa_decode_slots(attn0, torch.from_numpy(x[:, :1]), cache,
                               scout, kind="full")
