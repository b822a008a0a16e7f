"""The port's ssm family against ``repro`` in one process: the selective
scan (plain version and the wrapper's CPU route) against the JAX oracle,
the Pallas kernel in interpret mode and ``_chunked_diag_scan``; the Mamba
block and the ssm transformer (forward, prefill, slot decode) against
JAX on ``reduced(falcon-mamba-7b)``, with the same weights (JAX init ->
numpy -> ``bridge``) and the same numpy inputs.

Tolerances: the scan at the Pallas tests' rtol 2e-4 / atol 1e-5 (f32);
the model at 1e-5 of max |value| (f32: both compute the same formulas,
in another order of summation)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import selective_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.pool import init_pool_cache as jinit_pool  # noqa: E402
from repro.serve.pool import scatter_slot as jscatter  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.pool import init_pool_cache, scatter_slot  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


ARCH = "falcon-mamba-7b"
J_INIT = jax.jit(JT.init_params, static_argnums=1)
J_FORWARD = jax.jit(JT.forward, static_argnums=2)
J_PREFILL = jax.jit(JT.prefill, static_argnums=2)
J_DECODE = jax.jit(JT.decode_step_slots, static_argnums=3)
J_MAMBA = jax.jit(jssm.mamba_forward, static_argnums=2)
J_MAMBA_DECODE = jax.jit(jssm.mamba_decode, static_argnums=3)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _rel_close(got, want, rel=1e-5):
    """|got - want| <= rel * max |want|."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _t(tree):
    return bridge.params_from_numpy(jax.device_get(tree), "cpu")


@pytest.fixture(scope="module")
def mamba():
    """reduced(falcon-mamba-7b): 2 layers, d_model 256, d_inner 512,
    N 16, dt_rank 16, vocab 512, f32; JAX weights and their bridge."""
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = J_INIT(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _t(jp)


# ----------------------------------------------------------------------
# the scan
def _scan_inputs(b, s, c, seed=0):
    r = _rng(seed)
    da = r.uniform(0.3, 0.99, (b, s, c)).astype(np.float32)
    dbx = r.standard_normal((b, s, c)).astype(np.float32)
    h0 = r.standard_normal((b, c)).astype(np.float32)
    return da, dbx, h0


def _jax_oracle(name, da, dbx, h0, chunk):
    da, dbx, h0 = map(jnp.asarray, (da, dbx, h0))
    if name == "ref":
        return jref.selective_scan_ref(da, dbx, h0)
    if name == "pallas":
        return selective_scan_pallas(da, dbx, h0, chunk=chunk, bc=16,
                                     interpret=True)
    return jssm._chunked_diag_scan(da, dbx, h0, chunk)


@pytest.mark.parametrize("oracle", ["ref", "pallas", "chunked"])
@pytest.mark.parametrize("b,s,c,chunk", [(2, 37, 45, 16), (1, 64, 32, 32),
                                         (3, 128, 17, 16)])
def test_scan_matches_jax(b, s, c, chunk, oracle):
    """The port's plain scan and the wrapper's CPU route against the JAX
    oracle, the Pallas kernel (interpret mode) and the model's chunked
    associative scan, from a nonzero h0, at tests/test_kernels.py's
    shapes."""
    da, dbx, h0 = _scan_inputs(b, s, c, seed=s)
    want_all, want_last = _jax_oracle(oracle, da, dbx, h0, chunk)
    args = tuple(map(torch.from_numpy, (da, dbx, h0)))
    for got_all, got_last in (ref.selective_scan_ref(*args),
                              selective_scan(*args)):
        assert got_all.dtype == got_last.dtype == torch.float32
        for got, want in ((got_all, want_all), (got_last, want_last)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=1e-5)


def test_scan_bf16_inputs_widen_like_jax():
    """bf16 da / dbx are widened to f32 on load, as the JAX oracle casts
    them; S = 1 is one step from h0."""
    da, dbx, h0 = _scan_inputs(2, 9, 33, seed=3)
    jda, jdbx = (jnp.asarray(a, jnp.bfloat16) for a in (da, dbx))
    tda, tdbx = (_t(a) for a in (jda, jdbx))
    assert tda.dtype == torch.bfloat16
    for s in (9, 1):
        want = jref.selective_scan_ref(jda[:, :s], jdbx[:, :s],
                                       jnp.asarray(h0))
        got = selective_scan(tda[:, :s].contiguous(),
                             tdbx[:, :s].contiguous(), torch.from_numpy(h0))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                       atol=1e-5)


def test_scan_wrapper_refuses_bad_inputs():
    da = torch.zeros((2, 5, 7))
    with pytest.raises(ValueError):
        selective_scan(da, torch.zeros((2, 5, 6)), torch.zeros((2, 7)))
    with pytest.raises(ValueError):
        selective_scan(da, da, torch.zeros((2, 6)))
    with pytest.raises(ValueError):       # no kernel off cuda:0 or the CPU
        meta = torch.zeros((2, 5, 7), device="meta")
        selective_scan(meta, meta, torch.zeros((2, 7), device="meta"))


# ----------------------------------------------------------------------
# the Mamba block
def _mixer(jp, layer=0):
    """One layer's Mamba weights: the JAX tree and its bridge."""
    jm = jax.tree.map(lambda a: a[layer], jp["blocks"]["mixer"])
    return jm, _t(jm)


def test_causal_conv1d_matches_jax():
    r = _rng(5)
    x = r.standard_normal((2, 9, 40)).astype(np.float32)
    w = r.standard_normal((4, 40)).astype(np.float32)
    b = r.standard_normal((40,)).astype(np.float32)
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm.causal_conv1d(*map(torch.from_numpy, (x, w, b)))
    _rel_close(got, want)


@pytest.mark.parametrize("stitch", [False, True])
def test_mamba_forward_matches_jax(mamba, stitch):
    """Output and final state (h, conv) of one Mamba block, from zero or
    from a carried (h0, conv0)."""
    jcfg, tcfg, jp, tp = mamba
    jm, tm = _mixer(jp)
    r = _rng(7)
    x = r.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if stitch:
        di, n = ssm.d_inner(tcfg), tcfg.ssm.state_dim
        h0 = r.standard_normal((2, di, n)).astype(np.float32)
        conv0 = r.standard_normal((2, tcfg.ssm.conv_kernel - 1,
                                   di)).astype(np.float32)
        kw_j = dict(h0=jnp.asarray(h0), conv0=jnp.asarray(conv0))
        kw_t = dict(h0=torch.from_numpy(h0), conv0=torch.from_numpy(conv0))
    jy, jst = J_MAMBA(jm, jnp.asarray(x), jcfg, **kw_j)
    ty, tst = ssm.mamba_forward(tm, torch.from_numpy(x), tcfg, **kw_t)
    _rel_close(ty, jy)
    assert tst["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert tuple(tst[k].shape) == jst[k].shape, k
        _rel_close(tst[k], jst[k])


def test_mamba_decode_matches_jax(mamba):
    jcfg, tcfg, jp, tp = mamba
    jm, tm = _mixer(jp, layer=1)
    r = _rng(8)
    di, n, k = ssm.d_inner(tcfg), tcfg.ssm.state_dim, tcfg.ssm.conv_kernel
    x = r.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    st = {"h": r.standard_normal((3, di, n)).astype(np.float32),
          "conv": r.standard_normal((3, k - 1, di)).astype(np.float32)}
    jy, jst = J_MAMBA_DECODE(jm, jnp.asarray(x), jax.tree.map(jnp.asarray, st),
                             jcfg)
    tst_in = {name: torch.from_numpy(v) for name, v in st.items()}
    ty, tst = ssm.mamba_decode(tm, torch.from_numpy(x), tst_in, tcfg)
    _rel_close(ty, jy)
    for name in ("h", "conv"):
        _rel_close(tst[name], jst[name])


def test_mamba_forward_decode_equivalence(mamba):
    """Token-by-token decode from the empty state equals the full-sequence
    forward (tests/test_mixers.py's invariant), in the port alone."""
    _, tcfg, jp, _ = mamba
    _, tm = _mixer(jp)
    x = torch.from_numpy(_rng(9).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    y_full, st_full = ssm.mamba_forward(tm, x, tcfg)
    state = ssm.init_mamba_state(2, tcfg, torch.float32)
    ys = []
    for t in range(12):
        y, state = ssm.mamba_decode(tm, x[:, t:t + 1], state, tcfg)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               rtol=1e-4, atol=1e-4)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k].numpy(), st_full[k].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [1, 2, 6, 11])
def test_mamba_state_stitching(mamba, split):
    """Two calls carrying (h, conv) equal one pass, also when a piece is
    shorter than conv_kernel - 1 = 3 (the port keeps K - 1 conv rows, zero
    rows first; the JAX package keeps fewer)."""
    _, tcfg, jp, _ = mamba
    _, tm = _mixer(jp)
    x = torch.from_numpy(_rng(10).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    y_full, st_full = ssm.mamba_forward(tm, x, tcfg)
    y1, st1 = ssm.mamba_forward(tm, x[:, :split], tcfg)
    assert st1["conv"].shape[1] == tcfg.ssm.conv_kernel - 1
    y2, st2 = ssm.mamba_forward(tm, x[:, split:], tcfg, h0=st1["h"],
                                conv0=st1["conv"])
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-4, atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st2[k].numpy(), st_full[k].numpy(),
                                   rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# the ssm transformer
def test_forward_matches_jax(mamba):
    jcfg, tcfg, jp, tp = mamba
    toks = _rng(11).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jl, jaux = J_FORWARD(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, taux = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _rel_close(tl, jl)
    _rel_close(taux["pooled"], jaux["pooled"])
    _rel_close(TT.pooled(tp, {"tokens": torch.from_numpy(toks)}, tcfg),
               jaux["pooled"])


def test_prefill_matches_jax(mamba):
    """Logits and the stacked (L, B, ...) states; cache_len is not read."""
    jcfg, tcfg, jp, tp = mamba
    toks = _rng(12).integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                        cache_len=64)
    _rel_close(tl, jl)
    assert set(tc) == set(jc) == {"h", "conv", "len"}
    assert tc["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        _rel_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == 7


def test_decode_step_slots_masked_matches_jax(mamba):
    """A 3-slot pool with two prefilled prompts, decoded with slot 1
    masked: logits and states of the running slots agree with JAX, the
    masked slot's h and conv keep their bits, and its position holds."""
    jcfg, tcfg, jp, tp = mamba
    rng = _rng(13)
    jpool, tpool = jinit_pool(jcfg, 3, 32), init_pool_cache(tcfg, 3, 32,
                                                             device="cpu")
    for slot, n in ((0, 5), (1, 9)):
        toks = rng.integers(0, jcfg.vocab_size, (1, n)).astype(np.int32)
        _, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        _, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
        jpool = jscatter(jpool, jc, slot)
        scatter_slot(tpool, tc, slot)
    before = {k: tpool[k].clone() for k in ("h", "conv")}
    mask = np.array([True, False, True])
    toks = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jnew = J_DECODE(jp, jpool, {"tokens": jnp.asarray(toks)}, jcfg,
                        step_mask=jnp.asarray(mask))
    tl, tnew = TT.decode_step_slots(tp, tpool, {"tokens": torch.from_numpy(
        toks)}, tcfg, step_mask=torch.from_numpy(mask))
    _rel_close(tl, jl)
    for k in ("h", "conv"):
        _rel_close(tnew[k], jnew[k])
        assert torch.equal(tnew[k][:, 1], before[k][:, 1]), k
        assert not torch.equal(tnew[k][:, 0], before[k][:, 0]), k
    assert tnew["len"].tolist() == np.asarray(jnew["len"]).tolist() \
        == [6, 9, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_ssm_tree(dtype):
    """``params_from_numpy`` keeps the ssm tree's structure, its f32 leaves
    (a_log, dt_bias, d_skip) f32 in a bf16 model, and every bit."""
    jcfg = jreduced(jget_config(ARCH)).with_(dtype=dtype)
    jp = J_INIT(jax.random.PRNGKey(1), jcfg)
    tp = _t(jp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        t = tp
        for p in path:
            t = t[p.key]
        name = jax.tree_util.keystr(path)
        want_dtype = "float32" if any(k in name for k in (
            "a_log", "dt_bias", "d_skip")) else dtype
        assert str(leaf.dtype) == want_dtype, name
        assert t.dtype == getattr(torch, want_dtype), name
        assert tuple(t.shape) == leaf.shape, name
        back = bridge.params_to_numpy(t)
        assert np.array_equal(np.asarray(back).view(np.uint8),
                              np.asarray(leaf).view(np.uint8)), name
    # the port's own init builds the same tree, shapes and dtypes
    mine = TT.init_params(0, reduced(get_config(ARCH)).with_(dtype=dtype),
                          device="cpu")
    spec = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[1]), mine) == spec
