"""One round of the port's ``SequentialFederation`` against the reference's,
in one process, on the CPU (the kernels' plain versions stand in for the
CUDA kernels).

Both start from the same numbers: the reference runs one round, its
state goes through numpy into the port (``bridge.load_federation_state``),
and the reference's per-step draws for its next round -- the
``jax.random.split(node["key"])`` / ``task.sample`` / tokenizer sequence
of its ``run_round`` -- are reproduced before that round runs and
replayed into the port in place of ``_draw``.  Nothing else differs.  The
case has one bridge node (0), one corrupt node (1) and one
synthetic-anchor node (3), under each method; two more cases turn on
the options that are off by default: uniform aggregation, and a
round-keyed learning-rate schedule (the optimizer's ``round`` counter,
bumped by ``run_round``, is compared too).

The compared round is the second, so AdamW's moments hold the first
round's gradients.  From zero moments the comparison is ill-conditioned:
a first update u = g / (|g| + eps) with eps 1e-8 turns the ~1e-9 by
which the two frameworks' gradients differ (about 5e-7 of max |g|, the
size of JAX's own jit-versus-eager gap) into up to a tenth of lr at
elements whose gradient happens to be near eps, and later steps carry
that on.  That is AdamW's conditioning, not the port's arithmetic.

Tolerances, float32 throughout.  The round's losses, accuracy and
cross-node CKA, the node Grams and the consensus Gram agree to 1e-5
absolute (values of order 1; the frameworks sum in other orders).  The
precision weights (in [0, 1]) agree to 1e-4: a precision is a mean of
1 / u with u floored at 1e-3, which magnifies the rounding of a cosine by
up to 1 / (2 u) = 500.  Each node's moments m and v and its trainables
after the round (the shipped side-cars and the local adapters) agree to
1e-4 of each leaf's max |value|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import cka as jcka  # noqa: E402
from repro.core.federation import FederationConfig as JFedConfig  # noqa: E402
from repro.core.federation import SequentialFederation as JSeq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import cka as tcka  # noqa: E402
from repro_torch.core.federation import (FederationConfig,  # noqa: E402
                                         SequentialFederation)
from _torch_threads import _one_thread  # noqa: E402,F401


CASE = dict(n_nodes=4, local_steps=2, local_batch=8, n_classes=4,
            modalities=("genetics", "tabular"), bridge_modality="tabular",
            anchors_per_class=2, n_tokens=4, lora_rank=4, bridge_nodes=(0,),
            corrupt_nodes=(1,), synthetic_anchor_nodes=(3,))
TOL = 1e-5
REL = 1e-4
# (method, further FederationConfig fields), by test id; the schedule
# gives 1/3 in the compared (second) round, 1/2 had the counter not moved
CASES = {
    "geolora": ("geolora", {}),
    "geodora": ("geodora", {}),
    "fedavg_full": ("fedavg_full", {}),
    "fedavg_full-uniform": ("fedavg_full", dict(aggregation="uniform")),
    "geolora-round_lr_schedule": ("geolora", dict(
        round_lr_schedule=lambda r: 1.0 / (1 + r))),
}


def _reference_state(ref) -> dict:
    return jax.device_get({
        "frozen": ref.frozen, "frozen_bridge": ref.frozen_bridge,
        "nodes": [{"trainable": n["trainable"], "opt_state": n["opt_state"]}
                  for n in ref.nodes],
        "tokenizers": {m: tok.padded_weights(tok.d_out)
                       for m, tok in ref.tokenizers.items()},
        "anchor_tokens": ref.anchor_tokens,
        "synthetic_anchor_tokens": ref.synthetic_anchor_tokens,
        "prototypes": ref.task.prototypes(),
        "modality_maps": {m: ref.task.modality_map(m)
                          for m in ref.fed.modalities},
        "gbar": ref.gbar})


def _reference_draws(ref) -> list:
    """Per node, per local step: (tokens, labels, tokens2 or None), drawn
    as the reference's next ``run_round`` will draw them."""
    fed, draws = ref.fed, []
    for node in ref.nodes:
        key, steps = node["key"], []
        for _ in range(fed.local_steps):
            key, kb = jax.random.split(key)
            raw, labels = ref.task.sample(kb, node["modality"],
                                          fed.local_batch,
                                          corrupt=node["corrupt"])
            tokens2 = None
            if node.get("bridge"):
                raw2, _ = ref.task.sample(kb, node["modality2"],
                                          fed.local_batch)
                tokens2 = ref.tokenizers[node["modality2"]](raw2)
            steps.append(jax.device_get(
                (ref.tokenizers[node["modality"]](raw), labels, tokens2)))
        draws.append(steps)
    return draws


def _recording(fn, into: list):
    def wrapped(grams, **kw):
        into.append(np.asarray(grams))
        return fn(grams, **kw)
    return wrapped


def _flat(tree, path=""):
    """(path, leaf) of a nested dict of arrays, None leaves skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    return [] if tree is None else [(path, np.asarray(tree))]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0, err_msg=what)


def _replay(ref, port) -> None:
    """Feed the port the draws of the reference's next round."""
    draws = [iter(steps) for steps in _reference_draws(ref)]
    port._draw = lambda i, node: tuple(
        None if a is None else torch.from_numpy(np.array(a))
        for a in next(draws[i]))


def _compare(want, got, ref, port, grams) -> None:
    for key in ("task_loss", "geo_loss", "acc", "cross_node_cka"):
        _close(got[key], want[key], TOL, key)
    _close(got["weights"], want["weights"], REL, "weights")
    assert abs(sum(got["weights"]) - 1.0) < 1e-6
    for key in ("uplink_bytes", "full_model_bytes", "participation",
                "cohort_size"):
        assert got.get(key) == want.get(key), key
    _close(grams["port"][-1], grams["ref"][-1], TOL, "node Grams")
    _close(port.gbar, jax.device_get(ref.gbar), TOL, "consensus Gram")
    # every node's moments, and its trainables after the broadcast: the
    # shipped side-cars (the same on every node) and the local adapters
    for i, (pn, rn) in enumerate(zip(port.nodes, ref.nodes)):
        assert ("round" in pn["opt_state"]) == ("round" in rn["opt_state"])
        if "round" in rn["opt_state"]:
            assert int(pn["opt_state"]["round"]) == int(rn["opt_state"]
                                                        ["round"])
        for part in (lambda n: n["opt_state"]["m"],
                     lambda n: n["opt_state"]["v"], lambda n: n["trainable"]):
            ours = _flat(bridge.params_to_numpy(part(pn)))
            theirs = _flat(jax.device_get(part(rn)))
            assert [p for p, _ in ours] == [p for p, _ in theirs]
            for (path, a), (_, b) in zip(ours, theirs):
                _close(a, b, REL * float(np.abs(b).max()),
                       f"node {i} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_run_round_matches_reference(case, monkeypatch):
    """A full round in each case; under plain geolora then a round of the
    cohort (0, 2, 3): node 1 does nothing, reports nothing and still
    receives the broadcast."""
    method, extra = CASES[case]
    ref = JSeq(JFedConfig(method=method, **CASE, **extra),
               jreduced(jget_config("fedmm-small")))
    port = SequentialFederation(FederationConfig(method=method, **CASE,
                                                 **extra),
                                reduced(get_config("fedmm-small")),
                                device="cpu")
    ref.run_round()
    bridge.load_federation_state(port, _reference_state(ref))
    grams = {"ref": [], "port": []}
    monkeypatch.setattr(jcka, "mean_offdiag_cka",
                        _recording(jcka.mean_offdiag_cka, grams["ref"]))
    monkeypatch.setattr(tcka, "mean_offdiag_cka",
                        _recording(tcka.mean_offdiag_cka, grams["port"]))

    _replay(ref, port)
    want = ref.run_round()
    _compare(want, port.run_round(), ref, port, grams)
    if case == "geolora":
        _replay(ref, port)
        want = ref.run_round(participants=[0, 2, 3])
        got = port.run_round(participants=[0, 2, 3])
        assert got["weights"][1] == 0.0 and got["cohort_size"] == 3
        _compare(want, got, ref, port, grams)
