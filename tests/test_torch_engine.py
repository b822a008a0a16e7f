"""The port's node-stacked ``Federation`` (``core/engine.py``), on the CPU in
float32, in one process.

- Against the port's own ``SequentialFederation`` from the same seed: both
  draw the same batches from the same per-node generators, so two rounds
  must agree to 1e-5 (records, each node's trainables and AdamW moments)
  under geolora, geodora and fedavg_full, precision and uniform weights,
  server momentum 0 (the momentum path reduces to the average), a bridge,
  a corrupt and a synthetic-anchor node, with width buckets on and off.
  The two sum in other orders (stacked products, per-bucket sums), at
  ~1e-7 here.
- Against the reference ``Federation`` on its second round: the
  reference runs a round, its bucketed state goes through numpy into the
  port (``bridge.load_engine_state``), its next round's in-scan draws
  (``sample_in_scan`` from each node's carried key) are fed to the port,
  and both run that round.  Modalities ("genetics", "tabular") x 4 nodes
  make two width buckets of two nodes.  Tolerances are those of
  ``test_torch_federation.py``, for its reasons: 1e-5 absolute on losses,
  accuracy, CKA and the consensus Gram; 1e-4 on the precision weights;
  1e-4 of each leaf's max |value| on the stacked trainables, moments and
  server momentum.  Measured: up to 5.2e-6 of max over four processes
  (the reference's tokenizers are ``hash()``-seeded, so each process
  draws other numbers), too close to 6e-6 for a limit there.
- ``run_rounds(4, block_size=2)`` against four ``run_round`` calls, with
  one readback per block and the tap once per round.
- The stacked aggregation and precision functions against the reference's
  on numpy inputs from a seed (1e-6: the same f32 sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import uncertainty as junc  # noqa: E402
from repro.core.federation import Federation as JFederation  # noqa: E402
from repro.core.federation import FederationConfig as JFedConfig  # noqa: E402
from repro.data.tokenizers import FrozenTokenizer as JTokenizer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import uncertainty as tunc  # noqa: E402
from repro_torch.core.federation import (Federation,  # noqa: E402
                                         FederationConfig,
                                         SequentialFederation)
from repro_torch.data.tokenizers import FrozenTokenizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


_TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
             d_ff=64, vocab_size=128, dtype="float32")
TINY = get_config("fedmm-small").with_(**_TINY)
JTINY = jget_config("fedmm-small").with_(**_TINY)
BASE = dict(n_nodes=4, rounds=2, local_steps=2, local_batch=8,
            modalities=("genetics", "tabular"), bridge_modality="tabular",
            anchors_per_class=2, n_tokens=4, lora_rank=4)
HETERO = dict(bridge_nodes=(0,), corrupt_nodes=(1,),
              synthetic_anchor_nodes=(3,))
TOL, REL = 1e-5, 1e-4

# (method, FederationConfig fields, width_bucketing), by test id
SEQ_CASES = {
    "geolora": ("geolora", {}, True),
    "geodora-hetero": ("geodora", HETERO, True),
    "geodora-hetero-padded": ("geodora", HETERO, False),
    "fedavg_full-uniform": ("fedavg_full", dict(aggregation="uniform"), True),
    "geolora-momentum0-schedule": ("geolora", dict(
        server_momentum=0.0, round_lr_schedule=lambda r: 1.0 / (1 + r)),
        True),
}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0, err_msg=what)


def _compare_records(got, want, w_tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("task_loss", "geo_loss", "acc", "cross_node_cka"):
            _close(g[key], w[key], TOL, key)
        _close(g["weights"], w["weights"], w_tol, "weights")
        assert abs(sum(g["weights"]) - 1.0) < 1e-5
        for key in ("uplink_bytes", "full_model_bytes"):
            assert g[key] == w[key], key


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_federation_matches_sequential(case):
    method, extra, bucketing = SEQ_CASES[case]
    fed = FederationConfig(method=method, **BASE, **extra)
    seq = SequentialFederation(fed, TINY, device="cpu")
    eng = Federation(fed, TINY, device="cpu", width_bucketing=bucketing)
    assert len(eng._trains) == (2 if bucketing else 1)
    _compare_records(eng.run(), seq.run())
    _close(eng.gbar, seq.gbar, TOL, "consensus Gram")
    for i, (e, s) in enumerate(zip(eng.nodes, seq.nodes)):
        assert sorted(e["trainable"]) == sorted(s["trainable"])
        for part in ("trainable", "m", "v"):
            pick = ((lambda n: n["trainable"]) if part == "trainable"
                    else (lambda n, p=part: n["opt_state"][p]))
            for a, b in zip(tree_leaves(pick(e)), tree_leaves(pick(s))):
                assert a.shape == b.shape, f"node {i} {part}"
                _close(a, b, TOL, f"node {i} {part}")
        assert int(e["opt_state"]["step"]) == int(s["opt_state"]["step"])
        if "round" in s["opt_state"]:
            assert int(e["opt_state"]["round"]) == \
                int(s["opt_state"]["round"])


def test_server_momentum_moves_the_broadcast():
    """beta 0.9 carries a momentum tree and trains elsewhere than the plain
    average (its agreement with the reference is in the parity test).  The
    first broadcast is the average (zero momentum), so the third round is
    the first whose losses differ."""
    fed = FederationConfig(method="geolora", **BASE)
    off = Federation(fed, TINY, device="cpu")
    on = Federation(FederationConfig(method="geolora", server_momentum=0.9,
                                     **BASE), TINY, device="cpu")
    assert off._server_m is None and on._server_m is not None
    h_off, h_on = off.run_rounds(3), on.run_rounds(3)
    assert all(np.isfinite(r["task_loss"]) for r in h_on)
    assert abs(h_on[-1]["task_loss"] - h_off[-1]["task_loss"]) > 1e-7


def test_run_rounds_in_blocks_equals_single_rounds():
    fed = FederationConfig(method="geodora", **BASE, **HETERO)
    single = Federation(fed, TINY, device="cpu")
    want = [single.run_round() for _ in range(4)]
    blocked = Federation(fed, TINY, device="cpu")
    taps = []
    got = blocked.run_rounds(4, block_size=2, tap=taps.append)
    _compare_records(got, want, w_tol=1e-6)
    assert blocked.engine.stats["readbacks"] == 2
    assert [t["round_in_block"] for t in taps] == [0, 1, 0, 1]
    _close([np.mean(t["task"]) for t in taps],
           [r["task_loss"] for r in got], 1e-6, "tap")
    # a remainder block: 3 rounds in blocks of 2 and 1
    rest = Federation(fed, TINY, device="cpu").run_rounds(3, block_size=2)
    _compare_records(rest, want[:3], w_tol=1e-6)


def test_unported_options_raise():
    fed = FederationConfig(method="geolora", **BASE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Federation(fed, TINY)


# ----------------------------------------------------------------------
# against the reference Federation
def _reference_state(ref) -> dict:
    return jax.device_get({
        "frozen": ref.frozen, "frozen_bridge": ref.frozen_bridge,
        "tokenizers": {m: tok.padded_weights(tok.d_out)
                       for m, tok in ref.tokenizers.items()},
        "anchor_tokens": ref.anchor_tokens,
        "synthetic_anchor_tokens": ref.synthetic_anchor_tokens,
        "prototypes": ref.task.prototypes(),
        "modality_maps": {m: ref.task.modality_map(m)
                          for m in ref.fed.modalities},
        "gbar": ref.gbar, "trains": ref._trains, "opts": ref._opts,
        "server_m": ref._server_m})


def _reference_draws(ref) -> tuple:
    """Per bucket, the draws of the reference's next round as its in-scan
    local step makes them (``key, kb = split(key)``, ``sample_in_scan``),
    shaped as the port's staged batches (1, E, k_b, ...)."""
    fed, out = ref.fed, []
    for b, members in enumerate(ref._buckets):
        st = ref._staticss[b]
        cols = {"raw": [], "labels": [], "raw2": []}
        for r in range(len(members)):
            key, steps = ref._keys[b][r], {k: [] for k in cols}
            for _ in range(fed.local_steps):
                key, kb = jax.random.split(key)
                raw, labels, raw2 = ref.task.sample_in_scan(
                    kb, st["mod_w"][r], st["mod_b"][r], fed.local_batch,
                    st["corrupt"][r],
                    mod2_w=st["mod2_w"][r] if "mod2_w" in st else None,
                    mod2_b=st["mod2_b"][r] if "mod2_b" in st else None)
                for k, v in (("raw", raw), ("labels", labels),
                             ("raw2", raw2)):
                    steps[k].append(v)
            for k in cols:
                cols[k].append(steps[k])
        out.append({k: torch.from_numpy(np.array(v)).transpose(0, 1)[None]
                    for k, v in cols.items() if v[0][0] is not None})
    return tuple(out)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{path}/{i}")]
    return [] if tree is None else [(path, np.asarray(tree))]


JAX_CASES = {
    "geodora-hetero": ("geodora", HETERO),
    "geolora-momentum-uniform": ("geolora", dict(server_momentum=0.9,
                                                 aggregation="uniform")),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_federation_matches_reference_second_round(case):
    method, extra = JAX_CASES[case]
    ref = JFederation(JFedConfig(method=method, **BASE, **extra), JTINY)
    port = Federation(FederationConfig(method=method, **BASE, **extra),
                      TINY, device="cpu")
    assert [len(m) for m in port._buckets] == [2, 2]
    ref.run_round()
    bridge.load_engine_state(port, _reference_state(ref))
    draws = _reference_draws(ref)
    port._stage = lambda m: draws
    want, got = ref.run_round(), port.run_round()
    _compare_records([got], [want], w_tol=REL)
    _close(port.gbar, jax.device_get(ref.gbar), TOL, "consensus Gram")
    for what, ours, theirs in (
            ("trains", port._trains, ref._trains),
            ("opts", port._opts, ref._opts),
            ("server_m", port._server_m, ref._server_m)):
        ours = _flat(bridge.params_to_numpy(ours))
        theirs = _flat(jax.device_get(theirs))
        assert [p for p, _ in ours] == [p for p, _ in theirs], what
        for (path, a), (_, b) in zip(ours, theirs):
            _close(a, b, REL * max(float(np.abs(b).max()), 1e-30),
                   f"{what} {path}")


# ----------------------------------------------------------------------
def _trees(rng, sizes):
    """Per-bucket stacked trees: a shipped side-car and head, and a local
    adapter whose width differs by bucket."""
    return tuple({"blocks": {"lora_B": rng.standard_normal((kb, 3, 5))},
                  "cls_head": {"w": rng.standard_normal((kb, 5, 2))},
                  "adapter": {"w": rng.standard_normal((kb, 4 + 3 * b, 5))}}
                 for b, kb in enumerate(sizes))


def _masks(trees):
    return tuple({"blocks": {"lora_B": True}, "cls_head": {"w": True},
                  "adapter": {"w": False}} for _ in trees)


@pytest.mark.parametrize("fn", ["weighted_average_bucketed",
                                "bucketed_partial_sums",
                                "weighted_average_stacked",
                                "broadcast_into_buckets"])
def test_stacked_aggregation_matches_reference(fn):
    rng = np.random.default_rng(11)
    sizes = (1,) if fn == "weighted_average_stacked" else (2, 3, 1)
    trees = tuple(jax.tree.map(lambda x: x.astype(np.float32), t)
                  for t in _trees(rng, sizes))
    w = rng.random(sum(sizes)).astype(np.float32)
    w /= w.sum()
    tt = tuple(bridge.params_from_numpy(t, "cpu") for t in trees)
    tw = torch.from_numpy(w)
    if fn == "weighted_average_bucketed":
        want = jagg.weighted_average_bucketed(trees, w, _masks(trees), sizes)
        got = tagg.weighted_average_bucketed(tt, tw, _masks(tt), sizes)
    elif fn == "bucketed_partial_sums":
        want = jagg.bucketed_partial_sums(trees, w, _masks(trees), sizes)
        got = tagg.bucketed_partial_sums(tt, tw, _masks(tt), sizes)
    elif fn == "weighted_average_stacked":
        want = jagg.weighted_average_stacked(trees[0], w, _masks(trees)[0])
        got = tagg.weighted_average_stacked(tt[0], tw, _masks(tt)[0])
    else:
        total = {"blocks": {"lora_B": rng.standard_normal((3, 5))},
                 "cls_head": {"w": rng.standard_normal((5, 2))},
                 "adapter": {"w": None}}
        total = jax.tree.map(lambda x: x.astype(np.float32), total)
        want = jagg.broadcast_into_buckets(trees, _masks(trees), total)
        got = tagg.broadcast_into_buckets(
            tt, _masks(tt), bridge.params_from_numpy(total, "cpu"))
    ours, theirs = _flat(bridge.params_to_numpy(got)), _flat(
        jax.device_get(want))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.shape == b.shape, path
        _close(a, b, 1e-6, path)


def test_batched_precisions_match_reference():
    rng = np.random.default_rng(5)
    pooled = rng.standard_normal((4, 16, 24)).astype(np.float32)
    anchors = rng.standard_normal((4, 8, 24)).astype(np.float32)
    pooled[2] = anchors[2, :1]            # a node on an anchor: u at floor
    want = junc.batched_precisions(pooled, anchors)
    got = tunc.batched_precisions(torch.from_numpy(pooled),
                                  torch.from_numpy(anchors))
    _close(got, want, 1e-6 * float(np.abs(want).max()), "precisions")
    _close(tunc.precision_weights(got), junc.precision_weights(want), 1e-6,
           "weights")


@pytest.mark.parametrize("width", [192, 200, 768])
def test_padded_weights_match_reference(width):
    """The port's tokenizer carrying the reference's weights pads them as
    the reference does, and the padded tokenizer's first d_out channels
    are the tokenizer's own."""
    ref = JTokenizer("tabular", 64, 4, 192, seed=3)
    port = FrozenTokenizer("tabular", 64, 4, 192, seed=0, device="cpu")
    port.w1, port.b1, port.w2 = (torch.from_numpy(np.array(t))
                                 for t in ref.padded_weights(192))
    for a, b in zip(port.padded_weights(width), ref.padded_weights(width)):
        assert tuple(a.shape) == b.shape
        _close(a, b, 0.0, "padded weights")
    raw = np.random.default_rng(0).standard_normal((3, 64)).astype(
        np.float32)
    w1, b1, w2 = port.padded_weights(width)
    h = torch.einsum("nd,dlo->nlo", torch.from_numpy(raw), w1) + b1
    tokens = torch.tanh(h) @ w2
    _close(tokens[..., :192], port(torch.from_numpy(raw)), 1e-6, "tokens")
    assert not tokens[..., 192:].any()
