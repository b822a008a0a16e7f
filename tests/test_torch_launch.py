"""The port's launch layer against the JAX reference on the CPU, in one
process: ``launch/steps.py``, ``Runtime.remat`` and
``launch/input_specs.py``.  JAX's weights and states cross through
``bridge``; inputs come from numpy seeds.

- ``make_fed_train_step`` (the FedSGD round on the engine, K 2) on
  ``reduced(smollm-135m)`` with GeoDoRA: JAX's first step, its state
  carried across, then the second step in both packages -- trainables,
  AdamW moments, ``step``, the consensus Gram and the metrics within
  1e-5 (``tests/test_torch_federation.py``'s tolerance; the first step
  from zero moments is the reference caveat "AdamW from zero moments").
  On ``reduced(llama4-scout-17b-a16e)`` (GeoLoRA, K 2): the first step's
  task and geo losses against JAX's (each node routed on its own), finite
  states, and the aux term reaching the update;
- ``make_lm_train_step`` the same way (second step, every parameter and
  the CE);
- ``Runtime(remat=True)`` against ``remat=False``: gradients and the LM
  step's update bit for bit, for a dense, a hybrid and an audio model;
- ``make_prefill_step``'s cache length (prompt + image + 128) and
  ``make_decode_step`` against ``decode_step``;
- ``input_specs``: the batches, Grams, caches and parameter trees of
  every input shape for the three architectures
  ``tests/test_system.py::test_input_specs_cover_all_shapes`` covers
  equal to JAX's ``ShapeDtypeStruct``s in shape and dtype, on the meta
  device; ``runtime_for`` and ``skip_reason`` as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.launch import input_specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, reduced  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.launch import input_specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import cross_entropy_loss  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
J_INIT = jax.jit(JT.init_params, static_argnums=1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(tree_t, tree_j, tol, what=""):
    """Two trees leaf by leaf, matched by key (None where the other is)."""
    if isinstance(tree_j, dict):
        assert sorted(tree_t) == sorted(tree_j), what
        for k in tree_j:
            _same(tree_t[k], tree_j[k], tol, f"{what}/{k}")
    elif isinstance(tree_j, (list, tuple)):
        for i, (t, j) in enumerate(zip(tree_t, tree_j)):
            _same(t, j, tol, f"{what}/{i}")
    elif tree_j is None:
        assert tree_t is None, what
    else:
        np.testing.assert_allclose(
            tree_t.detach().double().numpy(),
            np.asarray(tree_j, np.float64), atol=tol, rtol=0, err_msg=what)


def _lm_batch(cfg, b, s, rng):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def _fed_setup(arch, spec_kw, k, b, s, a, la, seed):
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = J_INIT(KEY, jcfg)
    jp = jlora.attach_lora(KEY, jp, jlora.LoRASpec(rank=4, **spec_kw))
    jtr, jfr = jlora.partition(jp, jlora.trainable_mask(jp))
    ttr, tfr = (bridge.params_from_numpy(jax.device_get(t), "cpu")
                for t in (jtr, jfr))
    rng = np.random.default_rng(seed)

    def batch():
        out = _lm_batch(tcfg, b, s, rng)
        out["anchors"] = rng.integers(0, tcfg.vocab_size,
                                      (k, a, la)).astype(np.int32)
        return out
    return jcfg, tcfg, (jtr, jfr), (ttr, tfr), batch


def test_fed_train_step_second_step_matches_jax():
    k = 2
    jcfg, tcfg, (jtr, jfr), (_, tfr), batch = _fed_setup(
        "smollm-135m", dict(dora=True), k, b=4, s=16, a=6, la=8, seed=0)
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jsteps.make_fed_train_step(jcfg, JT.Runtime(), jopt,
                                               k_nodes=k))
    tstep = tsteps.make_fed_train_step(tcfg, TT.Runtime(), topt, k_nodes=k)
    b1, b2 = batch(), batch()
    jtr, jos, jg, _ = jstep(jtr, jfr, jopt.init(jtr),
                            {n: jnp.asarray(v) for n, v in b1.items()},
                            jnp.eye(6))
    ttr, tos, tg = (bridge.params_from_numpy(jax.device_get(x), "cpu")
                    for x in (jtr, jos, jg))
    jtr, jos, jg, jm = jstep(jtr, jfr, jos,
                             {n: jnp.asarray(v) for n, v in b2.items()}, jg)
    ttr, tos, tg, tm = tstep(ttr, tfr, tos, {n: _t(v) for n, v in b2.items()},
                             tg)
    _same(ttr, jax.device_get(jtr), TOL, "trainables")
    _same(tos["m"], jax.device_get(jos["m"]), TOL, "m")
    _same(tos["v"], jax.device_get(jos["v"]), TOL, "v")
    assert int(tos["step"]) == int(jos["step"]) == 2
    assert tos["step"].dtype == torch.int32
    _same(tg, jax.device_get(jg), TOL, "gbar")
    for name in ("task", "geo"):
        _same(tm[name], jm[name], TOL, name)


def test_moe_fed_train_step_routes_each_node_and_takes_the_aux_term():
    k = 2
    jcfg, tcfg, (jtr, jfr), (ttr, tfr), batch = _fed_setup(
        "llama4-scout-17b-a16e", {}, k, b=4, s=16, a=6, la=8, seed=1)
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    b1 = batch()
    _, _, _, jm = jax.jit(jsteps.make_fed_train_step(
        jcfg, JT.Runtime(), jopt, k_nodes=k))(
            jtr, jfr, jopt.init(jtr), {n: jnp.asarray(v)
                                       for n, v in b1.items()}, jnp.eye(6))
    outs = {}
    for coeff in (0.01, 0.0):
        step = tsteps.make_fed_train_step(tcfg, TT.Runtime(), topt,
                                          k_nodes=k, aux_coeff=coeff)
        outs[coeff] = step(ttr, tfr, topt.init(ttr),
                           {n: _t(v) for n, v in b1.items()},
                           torch.eye(6))
    new_tr, new_opt, gbar, m = outs[0.01]
    for name in ("task", "geo"):
        assert torch.isfinite(m[name])
        _same(m[name], jm[name], TOL, name)
    assert all(torch.isfinite(x).all() for x in
               tree_leaves(new_tr) + tree_leaves(new_opt) + [gbar])
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new_tr), tree_leaves(outs[0.0][0])))


def test_lm_train_step_second_step_matches_jax():
    arch = "smollm-135m"
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jsteps.make_lm_train_step(jcfg, JT.Runtime(), jopt))
    tstep = tsteps.make_lm_train_step(tcfg, TT.Runtime(), topt)
    rng = np.random.default_rng(2)
    b1, b2 = _lm_batch(tcfg, 2, 16, rng), _lm_batch(tcfg, 2, 16, rng)
    jp = J_INIT(KEY, jcfg)
    jp, jos, _ = jstep(jp, jopt.init(jp), {n: jnp.asarray(v)
                                           for n, v in b1.items()})
    tp, tos = (bridge.params_from_numpy(jax.device_get(x), "cpu")
               for x in (jp, jos))
    jp, jos, jce = jstep(jp, jos, {n: jnp.asarray(v) for n, v in b2.items()})
    tp, tos, tce = tstep(tp, tos, {n: _t(v) for n, v in b2.items()})
    _same(tp, jax.device_get(jp), TOL, "params")
    _same(tos["m"], jax.device_get(jos["m"]), TOL, "m")
    _same(tce, jce, TOL, "ce")
    assert int(tos["step"]) == 2


def _extras(cfg, b, rng):
    if cfg.family != "audio":
        return {}
    return {"enc_embeds": _t(rng.standard_normal(
        (b, cfg.encoder_seq_len, cfg.encoder_embed_dim)).astype(np.float32))}


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_remat_changes_no_gradient(arch):
    """Every layer checkpointed or not: the same gradients and the same
    LM step, bit for bit."""
    cfg = reduced(get_config(arch))
    params = TT.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: _t(v) for k, v in _lm_batch(cfg, 2, 12, rng).items()}
    batch.update(_extras(cfg, 2, rng))
    opt = AdamW(lr=1e-3, grad_clip=1.0)
    got = {}
    for remat in (False, True):
        rt = TT.Runtime(remat=remat)
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits, _ = TT.forward(live, batch, cfg, rt=rt)
        loss = cross_entropy_loss(logits, batch["labels"])
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True)
        step = tsteps.make_lm_train_step(cfg, rt, opt)
        new, _, ce = step(params, opt.init(params), batch)
        got[remat] = (grads, tree_leaves(new), ce)
    for a, b in zip(got[False][0], got[True][0]):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(got[False][1], got[True][1]):
        assert torch.equal(a, b)
    assert torch.equal(got[False][2], got[True][2])


def test_prefill_and_decode_steps():
    arch = "phi-3-vision-4.2b"
    cfg = reduced(get_config(arch))
    params = TT.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": _t(rng.integers(0, cfg.vocab_size, (2, 10)).astype(
                 np.int32)),
             "image_embeds": _t(rng.standard_normal(
                 (2, cfg.n_image_tokens, cfg.image_embed_dim)).astype(
                     np.float32))}
    want = jsteps._prefill_cache_len(
        {k: np.asarray(v) for k, v in batch.items()},
        jreduced(jget_config(arch)))
    assert tsteps._prefill_cache_len(batch, cfg) == want == 10 + 8 + 128
    _, cache = tsteps.make_prefill_step(cfg, TT.Runtime())(params, batch)
    assert cache["k"].shape[2] == want
    twin = {k: v.clone() for k, v in cache.items()}
    tok = {"tokens": _t(rng.integers(0, cfg.vocab_size, (2, 1)).astype(
        np.int32))}
    got, cache = tsteps.make_decode_step(cfg, TT.Runtime())(params, cache,
                                                            tok)
    want, twin = TT.decode_step(params, twin, tok, cfg)
    assert torch.equal(got, want) and int(cache["len"]) == 19
    assert all(torch.equal(cache[k], twin[k]) for k in twin)


SPEC_ARCHS = ("mistral-nemo-12b", "whisper-large-v3", "phi-3-vision-4.2b")


def _meta_like(got, want, what=""):
    """Meta tensors against ``ShapeDtypeStruct``s: keys, shapes, dtypes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _meta_like(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _meta_like(g, w, f"{what}/{i}")
    else:
        assert got.device.type == "meta", what
        assert tuple(got.shape) == tuple(want.shape), what
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), what


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_input_specs_match_jax(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    assert (tspecs.ANCHORS, tspecs.ANCHOR_LEN) == (jspecs.ANCHORS,
                                                   jspecs.ANCHOR_LEN)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        assert tspecs.skip_reason(tcfg, shape) == jspecs.skip_reason(
            jcfg, jshape)
        if tspecs.skip_reason(tcfg, shape):
            continue
        jrt, trt = jspecs.runtime_for(jcfg, jshape, mesh), \
            tspecs.runtime_for(tcfg, shape)
        assert (trt.window_override, trt.remat) == (jrt.window_override,
                                                    jrt.remat)
        if shape.kind == "train":
            jb, _, jg = jspecs.train_batch_specs(jcfg, jshape, mesh)
            tb, tg = tspecs.train_batch_specs(tcfg, shape)
            _meta_like(tg, jg, "gbar")
        else:
            jb, _ = jspecs.serve_batch_specs(jcfg, jshape, mesh)
            tb = tspecs.serve_batch_specs(tcfg, shape)
            if shape.kind == "decode":
                _meta_like(tspecs.abstract_cache(tcfg, shape, trt),
                           jspecs.abstract_cache(jcfg, jshape, jrt), name)
        _meta_like(tb, jb, name)
    spec = (jlora.LoRASpec(rank=8, dora=True), tlora.LoRASpec(rank=8,
                                                             dora=True))
    _meta_like(tspecs.abstract_params(tcfg, spec[1]),
               jspecs.abstract_params(jcfg, spec[0]), "params")
