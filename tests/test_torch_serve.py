"""The port's ServeEngine on the CPU against the JAX ServeEngine and the
JAX ``naive_generate``, in one process, on the tiny config of
tests/test_serve.py with the same weights (JAX init -> numpy -> bridge).

Greedy decoding is the parity target: tokens must be identical.  Where
they differ, the test first compares the two packages' logits over the
prompt and the common prefix, so that a fault (logits disagree, or no
near-tie at the split) fails and a near-tie between the top two logits
is told apart from it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import naive_generate as jnaive  # noqa: E402
from repro.serve import poisson_requests as jpoisson  # noqa: E402
from repro.serve import state_counts as jstate_counts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (ServeConfig, ServeEngine,  # noqa: E402
                               naive_generate, poisson_requests, state_counts)
from _torch_threads import _one_thread  # noqa: E402,F401


TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = jget_config("fedmm-small").with_(**TINY)
    tcfg = get_config("fedmm-small").with_(**TINY)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(jax.device_get(jp), "cpu")


def _jscfg(scfg: ServeConfig) -> JServeConfig:
    return JServeConfig(**dataclasses.asdict(scfg))


def _jreqs(reqs):
    """The port's Request objects as the JAX package's (same fields)."""
    from repro.serve import Request as JRequest
    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


def _explain_mismatch(model, req, got, want):
    """Tokens differ: hold the logits of both packages over prompt + the
    common prefix.  Passes only for a genuine near-tie at the split.
    ``model`` is a fixture's (jcfg, tcfg, jax params, port params)."""
    jcfg, tcfg, jp, tp = model
    n = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
        if got[:len(want)] != want[:len(got)] else min(len(got), len(want))
    assert n < min(len(got), len(want)), \
        f"rid {req.rid}: lengths differ ({len(got)} vs {len(want)}) " \
        f"with no differing token"
    seq = np.asarray(list(req.tokens) + want[:n], np.int32)[None]
    jl, _ = JT.prefill(jp, {"tokens": jnp.asarray(seq)}, jcfg)
    tl, _ = TT.prefill(tp, {"tokens": torch.from_numpy(seq)}, tcfg)
    jl = np.asarray(jl[0, -1], np.float32)
    np.testing.assert_allclose(tl[0, -1].numpy(), jl, atol=1e-4, rtol=0)
    top2 = np.sort(jl)[-2:]
    assert top2[1] - top2[0] < NEAR_TIE, \
        f"rid {req.rid}: token {n} differs ({got[n]} vs {want[n]}) though " \
        f"logits agree and the top-2 gap is {top2[1] - top2[0]:.3g}"


def _assert_tokens(tiny, reqs, got, *wants):
    for want in wants:
        for r in reqs:
            g, w = got[r.rid].tokens, want[r.rid].tokens
            if g != w:
                _explain_mismatch(tiny, r, g, w)


def _jax_oracle(tiny, reqs, scfg):
    """Isolated JAX legacy runs, batch 1 per request."""
    jcfg, _, jp, _ = tiny
    return jnaive(jp, jcfg, _jreqs(reqs),
                  _jscfg(dataclasses.replace(scfg, n_slots=1)))


# ----------------------------------------------------------------------
def test_streamed_admission_matches_jax_engine_and_naive(tiny):
    """Requests stream into a smaller pool -- admissions land mid-decode
    and slots are re-used -- and decode token-identically to the JAX engine,
    the JAX legacy loop and the port's own legacy loop."""
    jcfg, tcfg, jp, tp = tiny
    scfg = ServeConfig(n_slots=3, cache_len=64, block_steps=4,
                       max_new_tokens=10)
    reqs = poisson_requests(7, 0.0, prompt_len=8, vocab_size=256, seed=11)
    reqs = [dataclasses.replace(r, arrival_s=0.02 * i)
            for i, r in enumerate(reqs)]
    recs = ServeEngine(tp, tcfg, scfg, device="cpu").serve(reqs)
    jrecs = JServeEngine(jp, jcfg, _jscfg(scfg)).serve(_jreqs(reqs))
    one = dataclasses.replace(scfg, n_slots=1)
    _assert_tokens(tiny, reqs, recs, jrecs, _jax_oracle(tiny, reqs, scfg),
                   naive_generate(tp, tcfg, reqs, one))
    assert all(len(recs[r.rid].tokens) == 10 for r in reqs)
    assert all(recs[r.rid].state == "completed" for r in reqs)
    assert len({recs[r.rid].slot for r in reqs}) <= scfg.n_slots


def test_stop_token_truncates_like_jax(tiny):
    """A stop token truncates exactly where the JAX legacy loop stops, and
    the freed slot goes to a queued request."""
    jcfg, tcfg, jp, tp = tiny
    base = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                       max_new_tokens=12)
    reqs = poisson_requests(5, 0.0, prompt_len=6, vocab_size=256, seed=5)
    free = ServeEngine(tp, tcfg, base, device="cpu").serve(reqs)
    stop = next(free[r.rid].tokens[3] for r in reqs
                if len(set(free[r.rid].tokens)) > 1)
    scfg = dataclasses.replace(base, stop_token=int(stop))
    recs = ServeEngine(tp, tcfg, scfg, device="cpu").serve(reqs)
    _assert_tokens(tiny, reqs, recs, _jax_oracle(tiny, reqs, scfg))
    truncated = 0
    for r in reqs:
        got = recs[r.rid].tokens
        if int(stop) in got:
            assert got.index(int(stop)) == len(got) - 1
            truncated += len(got) < 12
    assert truncated >= 1, "stop token never fired; test is vacuous"


def test_per_slot_budgets_like_jax(tiny):
    """Per-request max_new overrides run side by side in one pool."""
    jcfg, tcfg, jp, tp = tiny
    scfg = ServeConfig(n_slots=4, cache_len=64, block_steps=4,
                       max_new_tokens=9)
    reqs = poisson_requests(4, 0.0, prompt_len=8, vocab_size=256, seed=2)
    reqs = [dataclasses.replace(r, max_new=m)
            for r, m in zip(reqs, (1, 3, 9, None))]
    recs = ServeEngine(tp, tcfg, scfg, device="cpu").serve(reqs)
    assert [len(recs[r.rid].tokens) for r in reqs] == [1, 3, 9, 9]
    _assert_tokens(tiny, reqs, recs, _jax_oracle(tiny, reqs, scfg))


def test_one_readback_per_block(tiny):
    """One block and ONE host readback per M decode steps, measured by the
    engine's counters; the legacy loop pays one per token."""
    _, tcfg, _, tp = tiny
    scfg = ServeConfig(n_slots=4, cache_len=64, block_steps=8,
                       max_new_tokens=17)
    reqs = poisson_requests(4, 0.0, prompt_len=8, vocab_size=256, seed=7)
    eng = ServeEngine(tp, tcfg, scfg, device="cpu")
    eng.serve(reqs)
    st = eng.stats
    assert st["block_syncs"] == st["block_dispatches"] == 2
    assert st["block_tokens"] == 4 * 16
    assert st["admit_dispatches"] == 4
    assert st["request_reads"] == 0
    nstats = {}
    naive_generate(tp, tcfg, reqs, scfg, stats=nstats)
    assert nstats["decode_dispatches"] == 16
    assert nstats["host_syncs"] == 17


@pytest.mark.parametrize("knob", ["ttft_deadline_s", "deadline_s"])
def test_deadlines_end_in_the_same_states_as_jax(tiny, knob):
    """A zero TTFT deadline sheds every queued request; a zero completion
    deadline lets the watchdog cancel every admitted slot."""
    jcfg, tcfg, jp, tp = tiny
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=2,
                       max_new_tokens=6, **{knob: 0.0})
    reqs = poisson_requests(3, 0.0, prompt_len=5, vocab_size=256, seed=4)
    got = state_counts(ServeEngine(tp, tcfg, scfg, device="cpu").serve(reqs))
    want = jstate_counts(JServeEngine(jp, jcfg, _jscfg(scfg)).serve(
        _jreqs(reqs)))
    assert got == want
    assert got[{"ttft_deadline_s": "shed", "deadline_s": "timed_out"}[knob]] \
        == 3


def test_nonfinite_guard_retries_then_fails_like_jax(tiny):
    """NaN weights trip the on-device guard at admission: each request is
    retried up to max_attempts and ends ``failed``, as in the JAX engine."""
    jcfg, tcfg, jp, tp = tiny
    jbad = dict(jp, lm_head={"w": jp["lm_head"]["w"] * jnp.nan})
    tbad = dict(tp, lm_head={"w": tp["lm_head"]["w"] * float("nan")})
    scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=2,
                       max_new_tokens=6, max_attempts=2)
    reqs = poisson_requests(3, 0.0, prompt_len=5, vocab_size=256, seed=8)
    eng = ServeEngine(tbad, tcfg, scfg, device="cpu")
    recs = eng.serve(reqs)
    jeng = JServeEngine(jbad, jcfg, _jscfg(scfg))
    jrecs = jeng.serve(_jreqs(reqs))
    assert state_counts(recs) == jstate_counts(jrecs)
    assert state_counts(recs)["failed"] == 3
    assert eng.stats["faults_detected"] == jeng.stats["faults_detected"] == 6
    assert [recs[r.rid].attempts for r in reqs] == [2, 2, 2]


def test_temperature_sampling_is_seeded(tiny):
    """temperature > 0 samples from torch Generators seeded by
    ServeConfig.seed: the same seed gives the same tokens."""
    _, tcfg, _, tp = tiny
    reqs = poisson_requests(3, 0.0, prompt_len=6, vocab_size=256, seed=9)
    runs = []
    for seed in (3, 3, 4):
        scfg = ServeConfig(n_slots=2, cache_len=64, block_steps=4,
                           max_new_tokens=8, temperature=1.0, seed=seed)
        recs = ServeEngine(tp, tcfg, scfg, device="cpu").serve(reqs)
        assert all(len(recs[r.rid].tokens) == 8 for r in reqs)
        runs.append([recs[r.rid].tokens for r in reqs])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


@pytest.mark.parametrize("rate,seed,max_new", [(0.0, 0, None), (5.0, 3, 7),
                                               (100.0, 11, None)])
def test_poisson_requests_match_jax_copy(rate, seed, max_new):
    got = poisson_requests(6, rate, prompt_len=5, vocab_size=97, seed=seed,
                           max_new=max_new)
    want = jpoisson(6, rate, prompt_len=5, vocab_size=97, seed=seed,
                    max_new=max_new)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


# ----------------------------------------------------------------------
# the ssm family: reduced(falcon-mamba-7b), JAX weights carried across
@pytest.fixture(scope="module")
def mamba():
    from repro.configs import reduced as jreduced
    from repro_torch.configs import reduced
    jcfg = jreduced(jget_config("falcon-mamba-7b"))
    tcfg = reduced(get_config("falcon-mamba-7b"))
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(jax.device_get(jp),
                                                    "cpu")


def _forward_argmax(model, req, tokens):
    """Greedy tokens of the port's full-sequence forward over prompt +
    ``tokens``: the token after the prompt, then after each of
    ``tokens[:-1]``."""
    _, tcfg, _, tp = model
    seq = torch.tensor([list(req.tokens) + tokens[:-1]], dtype=torch.int32)
    logits, _ = TT.forward(tp, {"tokens": seq}, tcfg)
    return logits[0, len(req.tokens) - 1:].argmax(-1).tolist(), logits[0]


def test_ssm_streamed_admission_matches_jax_engine_and_naive(mamba):
    """Falcon-Mamba states stream through the pool: admissions land
    mid-decode, slots are re-used, and the port decodes token-identically
    to the JAX engine and the JAX legacy loop, as the dense family does."""
    jcfg, tcfg, jp, tp = mamba
    scfg = ServeConfig(n_slots=3, cache_len=64, block_steps=4,
                       max_new_tokens=8)
    reqs = poisson_requests(6, 0.0, prompt_len=8, vocab_size=512, seed=3)
    reqs = [dataclasses.replace(r, arrival_s=0.02 * i)
            for i, r in enumerate(reqs)]
    eng = ServeEngine(tp, tcfg, scfg, device="cpu")
    recs = eng.serve(reqs)
    jrecs = JServeEngine(jp, jcfg, _jscfg(scfg)).serve(_jreqs(reqs))
    _assert_tokens(mamba, reqs, recs, jrecs, _jax_oracle(mamba, reqs, scfg))
    assert all(len(recs[r.rid].tokens) == 8 for r in reqs)
    assert all(recs[r.rid].state == "completed" for r in reqs)
    assert eng.stats["admit_dispatches"] == 6
    assert len({recs[r.rid].slot for r in reqs}) <= scfg.n_slots


def test_ssm_admits_past_cache_len_like_jax(mamba):
    """A recurrent state has no length: prompt + max_new beyond cache_len
    is admitted and decodes as in JAX (the dense family refuses it)."""
    jcfg, tcfg, jp, tp = mamba
    scfg = ServeConfig(n_slots=2, cache_len=8, block_steps=4,
                       max_new_tokens=9)
    reqs = poisson_requests(2, 0.0, prompt_len=12, vocab_size=512, seed=6)
    recs = ServeEngine(tp, tcfg, scfg, device="cpu").serve(reqs)
    jrecs = JServeEngine(jp, jcfg, _jscfg(scfg)).serve(_jreqs(reqs))
    assert all(recs[r.rid].state == "completed"
               and len(recs[r.rid].tokens) == 9 for r in reqs)
    _assert_tokens(mamba, reqs, recs, jrecs)


def test_ssm_masked_slot_resumes_bit_identically(mamba):
    """A slot frozen by ``step_mask`` for three steps (as a deadline
    cancel or a chaos freeze holds it) and then resumed continues exactly
    where it stopped: its tokens and state equal an unfrozen run's, in the
    port and in JAX alike."""
    jcfg, tcfg, jp, tp = mamba
    from repro.serve.pool import init_pool_cache as jinit_pool
    from repro.serve.pool import scatter_slot as jscatter
    from repro_torch.serve import init_pool_cache, scatter_slot
    j_decode = jax.jit(JT.decode_step_slots, static_argnums=3)
    prompts = np.random.default_rng(21).integers(0, 512, (2, 6)).astype(
        np.int32)

    def run(frozen):
        tpool = init_pool_cache(tcfg, 2, 32, device="cpu")
        jpool = jinit_pool(jcfg, 2, 32)
        last = []
        for s in range(2):
            tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(
                prompts[s:s + 1])}, tcfg)
            _, jc = JT.prefill(jp, {"tokens": jnp.asarray(prompts[s:s + 1])},
                               jcfg)
            scatter_slot(tpool, tc, s)
            jpool = jscatter(jpool, jc, s)
            last.append(int(tl[0, -1].argmax()))
        tok = np.asarray(last, np.int32)
        seqs = {"port": [[], []], "jax": [[], []]}
        jtok = tok.copy()
        for step in range(10):
            mask = np.array([step not in frozen, True])
            tl, tpool = TT.decode_step_slots(
                tp, tpool, {"tokens": torch.from_numpy(tok[:, None])}, tcfg,
                step_mask=torch.from_numpy(mask))
            jl, jpool = j_decode(jp, jpool, {"tokens": jnp.asarray(
                jtok[:, None])}, jcfg, step_mask=jnp.asarray(mask))
            new = tl[:, 0].argmax(-1).numpy().astype(np.int32)
            jnew = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
            tok = np.where(mask, new, tok)
            jtok = np.where(mask, jnew, jtok)
            for s in np.flatnonzero(mask):
                seqs["port"][s].append(int(tok[s]))
                seqs["jax"][s].append(int(jtok[s]))
        return seqs, tpool

    clean, clean_pool = run(frozen=())
    held, held_pool = run(frozen=(3, 4, 5))
    assert held["port"][0] == clean["port"][0][:7]
    assert held["port"][1] == clean["port"][1]
    assert held["port"] == held["jax"]
    assert clean["port"] == clean["jax"]
    # slot 0's position advanced on its 7 running steps only
    assert held_pool["len"].tolist() == [13, 16]
    assert clean_pool["len"].tolist() == [16, 16]


@pytest.mark.parametrize("plen", [1, 2])
def test_ssm_short_prompt_decodes_like_forward(mamba, plen):
    """A prompt shorter than conv_kernel - 1 = 3, admitted into a slot that
    last held a longer request, decodes the tokens of the port's own
    full-sequence forward: the conv state is the causal conv's zero
    padding then the prompt, never the slot's stale rows.  (The JAX
    package keeps only the prompt's rows here; this is not compared with
    it.)"""
    _, tcfg, _, tp = mamba
    scfg = ServeConfig(n_slots=1, cache_len=64, block_steps=4,
                       max_new_tokens=8)
    long_req, short = poisson_requests(2, 0.0, prompt_len=9, vocab_size=512,
                                       seed=30 + plen)
    short = dataclasses.replace(short, tokens=short.tokens[:plen])
    recs = ServeEngine(tp, tcfg, scfg, device="cpu").serve([long_req, short])
    assert recs[long_req.rid].slot == recs[short.rid].slot == 0
    for req in (long_req, short):
        got = recs[req.rid].tokens
        want, logits = _forward_argmax(mamba, req, got)
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                top2 = np.sort(logits[len(req.tokens) - 1 + i].numpy())[-2:]
                assert top2[1] - top2[0] < NEAR_TIE, \
                    f"rid {req.rid} token {i}: {g} vs forward's {w}"


def test_ssm_pool_scatter_gather_roundtrip(mamba):
    """The ssm pool holds h (L, S, d_inner, N) f32 and conv (L, S, K - 1,
    d_inner) with the slot on axis 1; a prefilled state lands in its slot
    and comes back out bit for bit, the other slots untouched."""
    from repro_torch.serve import gather_slot, init_pool_cache, scatter_slot
    _, tcfg, _, tp = mamba
    pool = init_pool_cache(tcfg, 3, 16, device="cpu")
    assert set(pool) == {"h", "conv", "len"}
    assert pool["h"].dtype == torch.float32
    assert tuple(pool["conv"].shape) == (2, 3, 3, 512)
    toks = torch.arange(1, 3, dtype=torch.int32)[None]      # 2 < K - 1
    _, req = TT.prefill(tp, {"tokens": toks}, tcfg)
    assert scatter_slot(pool, req, 1) is pool
    back = gather_slot(pool, 1)
    for name, leaf in req.items():
        assert back[name].shape == leaf.shape, name
        assert torch.equal(back[name], leaf), name
    for s in (0, 2):
        other = gather_slot(pool, s)
        assert int(other["len"]) == 0
        assert not other["h"].any() and not other["conv"].any()
