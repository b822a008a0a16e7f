"""The port's protocol modules against the JAX package's, in one process:
``core/cka``, ``core/uncertainty``, ``core/aggregation``, ``core/lora``,
``optim/adamw``, the tokenizer's math and the dense model's training
forward (``forward`` / ``pooled`` with GeoDoRA side-cars attached).  The
same numpy inputs go through both; f32, to 1e-5 of values of order 1
unless a test says otherwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import cka as jcka  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import uncertainty as junc  # noqa: E402
from repro.data.tokenizers import FrozenTokenizer as JTokenizer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import cka as tcka  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.core import uncertainty as tunc  # noqa: E402
from repro_torch.data.synthetic import SyntheticMultimodal  # noqa: E402
from repro_torch.data.tokenizers import FrozenTokenizer  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


TOL = 1e-5


def _rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(tree):
    return bridge.params_from_numpy(jax.device_get(tree), "cpu")


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=what)


def _grams(seed, k=3, b=8, d=20):
    z = _rnd(seed, (k, b, d))
    return z, np.array(jax.vmap(jcka.cosine_gram)(jnp.asarray(z)))


# ----------------------------------------------------------------------
@pytest.mark.parametrize("center", [False, True])
def test_cka_matches_jax(center):
    z, g = _grams(0)
    tg = torch.from_numpy(g)
    _close(tcka.cosine_gram(torch.from_numpy(z)), g)
    _close(tcka.cka(tg[0], tg[1], center=center),
           jcka.cka(g[0], g[1], center=center))
    _close(tcka.geo_alignment_loss(torch.from_numpy(z[0]), tg[2],
                                   center=center),
           jcka.geo_alignment_loss(jnp.asarray(z[0]), g[2], center=center))
    _close(tcka.consensus_gram(tg), jcka.consensus_gram(jnp.asarray(g)))
    _close(tcka.pairwise_cka(tg, center=center),
           jcka.pairwise_cka(jnp.asarray(g), center=center))
    _close(tcka.mean_offdiag_cka(tg, center=center),
           jcka.mean_offdiag_cka(jnp.asarray(g), center=center))


def test_uncertainty_matches_jax():
    z, a = _rnd(1, (10, 16)), _rnd(2, (6, 16))
    a[0] = z[3]                        # u = 0 there: the precision floor
    u = tunc.lap_uncertainty(torch.from_numpy(z), torch.from_numpy(a))
    ju = junc.lap_uncertainty(jnp.asarray(z), jnp.asarray(a))
    _close(u, ju)
    # a precision is a mean of 1 / max(u, 1e-3): values up to 1e3
    _close(tunc.node_precision(u), junc.node_precision(ju), 1e-5 * 1e3)
    p = np.asarray([3.0, 0.5, -1.0, 2.5], np.float32)   # a negative: clamped
    _close(tunc.precision_weights(torch.from_numpy(p)),
           junc.precision_weights(jnp.asarray(p)))


def test_aggregation_matches_jax():
    trees = [{"blocks": {"lora_B": _rnd(3 + i, (2, 4, 6)), "w": None},
              "cls_head": {"w": _rnd(9 + i, (6, 3))}} for i in range(3)]
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    got = tagg.aggregate_geolora([_t(x) for x in trees], torch.from_numpy(w))
    want = jagg.aggregate_geolora(trees, jnp.asarray(w))
    assert got["blocks"]["w"] is None
    _close(got["blocks"]["lora_B"], want["blocks"]["lora_B"])
    _close(got["cls_head"]["w"], want["cls_head"]["w"])
    uni = tagg.weighted_mean_trees([_t(x) for x in trees])
    _close(uni["cls_head"]["w"],
           jagg.weighted_mean_trees(trees)["cls_head"]["w"])
    assert tagg.comm_bytes_per_round(_t(trees[0]), gram_side=8) == \
        jagg.comm_bytes_per_round(trees[0], gram_side=8)


@pytest.mark.parametrize("round_schedule", [None, lambda r: 0.5 + 0.25 * r])
def test_adamw_matches_jax(round_schedule):
    """Four steps with clipping (the norm exceeds the clip on step 1), a
    frozen None leaf, a bf16 leaf and the round counter."""
    params = {"a": _rnd(20, (5, 4)), "frozen": None,
              "b": {"w": _rnd(21, (3,))}}
    kw = dict(lr=1e-2, weight_decay=0.01, grad_clip=1.0,
              round_schedule=round_schedule)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jp, tp = params, _t(params)
    tp["b"]["w"] = tp["b"]["w"].bfloat16()
    jp = dict(jp, b={"w": jnp.asarray(params["b"]["w"], jnp.bfloat16)})
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = {"a": _rnd(30 + step, (5, 4), 2.0 if step == 0 else 0.1),
             "frozen": None, "b": {"w": _rnd(40 + step, (3,), 0.1)}}
        if round_schedule is not None:
            js = dict(js, round=js["round"] + 1)
            ts = dict(ts, round=ts["round"] + 1)
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
    assert tp["frozen"] is None and ts["m"]["frozen"] is None
    assert tp["b"]["w"].dtype == torch.bfloat16
    assert int(ts["step"]) == int(js["step"]) == 4
    _close(tp["a"], jp["a"])
    _close(tp["b"]["w"], jnp.asarray(jp["b"]["w"], jnp.float32), 1e-2)
    _close(ts["m"]["a"], js["m"]["a"])
    _close(ts["v"]["a"], js["v"]["a"])


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def lora_params():
    """A reduced fedmm-small tree with GeoDoRA side-cars, from JAX, with
    lora_B and dora_m moved off their initial values so both matter."""
    jcfg = jreduced(jget_config("fedmm-small")).with_(n_layers=1)
    p = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    p = jlora.attach_lora(jax.random.PRNGKey(1), p,
                          jlora.LoRASpec(rank=4, dora=True))
    p = jax.device_get(p)
    blk = p["blocks"]["attn"]
    for i, name in enumerate(("wq", "wk", "wv", "wo")):
        blk[name]["lora_B"] = _rnd(50 + i, blk[name]["lora_B"].shape, 0.05)
        blk[name]["dora_m"] = blk[name]["dora_m"] * (
            1.0 + _rnd(60 + i, blk[name]["dora_m"].shape, 0.05))
    return jcfg, reduced(get_config("fedmm-small")).with_(n_layers=1), p


def test_lora_tree_functions_match_jax(lora_params):
    _, _, jp = lora_params
    jp = dict(jp, cls_head={"w": _rnd(70, (256, 4))},
              adapter={"w": _rnd(71, (8, 256))})
    tp = _t(jp)
    # attach: the same side-cars on the same linears, same shapes
    tplain = _t({k: v for k, v in jp.items()})
    for name in ("wq", "wk", "wv", "wo"):
        for leaf in ("lora_A", "lora_B", "dora_m"):
            tplain["blocks"]["attn"][name].pop(leaf)
    attached = tlora.attach_lora(torch.Generator().manual_seed(0), tplain,
                                 tlora.LoRASpec(rank=4, dora=True))
    shapes = tree_map(lambda x: None if x is None else tuple(x.shape), tp)
    assert tree_map(lambda x: None if x is None else tuple(x.shape),
                    dict(attached)) == shapes
    assert float(attached["blocks"]["attn"]["wq"]["lora_B"].abs().max()) \
        == 0.0
    # masks, partition, combine
    jmask = jlora.trainable_mask(jp)
    tmask = tlora.trainable_mask(tp)
    assert tmask == jax.tree.map(bool, jmask)
    jtrain, _ = jlora.partition(jp, jmask)
    ttrain, tfrozen = tlora.partition(tp, tmask)
    assert tlora.shipped_mask(ttrain) == jlora.shipped_mask(jtrain)
    assert tree_map(lambda x: x is None, ttrain) == \
        jax.tree.map(lambda x: x is None, jtrain,
                     is_leaf=lambda x: x is None)
    back = tlora.combine(ttrain, tfrozen)
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(tp)))
    assert tlora.param_bytes(ttrain) == jlora.param_bytes(jtrain)


def test_forward_and_pooled_match_jax(lora_params):
    """The training forward with GeoDoRA side-cars: logits and the pooled
    activations the federation reads, from the adapter path."""
    jcfg, tcfg, jp = lora_params
    embeds = _rnd(80, (3, 6, jcfg.d_model))
    logits, aux = jax.jit(JT.forward, static_argnums=2)(
        jp, {"inputs_embeds": jnp.asarray(embeds)}, jcfg)
    tp = _t(jp)
    tl, taux = TT.forward(tp, {"inputs_embeds": torch.from_numpy(embeds)},
                          tcfg)
    _close(tl, logits, what="logits")
    _close(taux["pooled"], aux["pooled"], what="pooled")
    _close(TT.pooled(tp, {"inputs_embeds": torch.from_numpy(embeds)}, tcfg),
           aux["pooled"], what="pooled()")


def test_tokenizer_and_task_math():
    """The tokenizer's math against the JAX tokenizer on its weights; the
    task's draws are the port's own (JAX's streams cannot be reproduced),
    so they are checked for what the protocol relies on: shapes, label
    range, class-sorted anchors and a bridge node's paired view."""
    jtok = JTokenizer("genetics", 12, 3, 10, seed=0)
    tok = FrozenTokenizer("genetics", 12, 3, 10, seed=0, device="cpu")
    tok.w1, tok.b1, tok.w2 = _t(jtok.padded_weights(10))
    raw = _rnd(90, (5, 12))
    _close(tok(torch.from_numpy(raw)), jtok(jnp.asarray(raw)))

    task = SyntheticMultimodal(4, ("genetics", "tabular"), d_raw=12,
                               device="cpu")
    gen = torch.Generator().manual_seed(0)
    raw, labels, raw2 = task.sample(gen, "genetics", 16, paired="tabular")
    assert raw.shape == raw2.shape == (16, 12) and labels.shape == (16,)
    assert 0 <= int(labels.min()) and int(labels.max()) < 4
    assert not torch.allclose(raw, raw2)
    bad, bad_labels, none = task.sample(gen, "tabular", 16, corrupt=True)
    assert none is None and bad.shape == (16, 12)
    anchors = task.anchor_set(gen, 2)
    assert anchors["tabular"][1].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    again = SyntheticMultimodal(4, ("genetics", "tabular"), d_raw=12,
                                device="cpu")
    assert torch.equal(again.prototypes, task.prototypes)    # stable seeds
