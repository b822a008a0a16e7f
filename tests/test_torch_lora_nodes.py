"""The node axis of the port's ``lora_matmul``, on the CPU.

The node-stacked round calls the GeoLoRA linear once for all K nodes: x
(K, M, d_in), W and A shared and frozen, B (K, r, N) per node.  The CUDA
kernel runs only on the card (``chip_smoke.py`` holds it against the plain
version there); here, in one process, from numpy inputs:

- the wrapper's plain path (what a CPU tensor runs) against ``jax.vmap``
  over nodes of the JAX oracle and of ``lora_matmul_pallas`` in interpret
  mode: the forward, dx (the kernel's second launch, with the per-node
  B_k^T in A's slot) and dB, at K 1 and 3 and ranks 8 and 64, in float32
  (1e-5 of max(1, |value|): both sum the same products in f32);
- a plain emulation of the bf16 kernel's sums run node by node -- k16
  steps within the K ranges that ``tile_plan`` picks for all K M rows, the
  f32 bottleneck, one rounding -- within chip_smoke.py's bf16 tolerance
  (3e-2 of max(1, |value|)) of the vmapped oracle and within one bf16
  step of the plain version, forward and on dx's strided views;
- ``tile_plan`` for K M rows: with one node it is the single-node plan,
  with K nodes it counts K times the M tiles (a tile never spans two
  nodes) and fills the card at the stacked round's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.lora_matmul import (  # noqa: E402
    BM, TARGET_BLOCKS, _check, lora_matmul, n_blocks, tile_plan)
from _torch_threads import _one_thread  # noqa: E402,F401


F32_TOL = 1e-5
BF16_TOL = 3e-2


def _rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _inputs(nodes, m, k, n, r, seed):
    """numpy x (K, M, k), W (k, n), A (k, r), B (K, r, n) and dy (K, M, n)."""
    return (_rnd(seed, (nodes, m, k)), _rnd(seed + 1, (k, n), k ** -0.5),
            _rnd(seed + 2, (k, r), k ** -0.5),
            _rnd(seed + 3, (nodes, r, n), r ** -0.5),
            _rnd(seed + 4, (nodes, m, n)))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _jax_nodes(fn):
    """``fn(x, w, a, b)`` vmapped over the nodes of x and b."""
    return jax.vmap(fn, in_axes=(0, None, None, 0))


def _pallas(x, w, a, b):
    return lora_matmul_pallas(x, w, a, b, bm=16, bn=32, bk=32,
                              interpret=True)


CASES = [(1, 24, 40, 48, 8), (3, 24, 40, 48, 8), (1, 16, 64, 40, 64),
         (3, 16, 64, 40, 64)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"K{c[0]}-r{c[4]}")
def test_node_axis_plain_version_matches_vmapped_jax(case):
    x, w, a, b, dy = _inputs(*case, seed=sum(case))
    tx, tb = (torch.from_numpy(t).requires_grad_() for t in (x, b))
    tw, ta = torch.from_numpy(w), torch.from_numpy(a)
    y = lora_matmul(tx, tw, ta, tb)
    y.backward(torch.from_numpy(dy))
    jx, jw, ja, jb, jdy = (jnp.asarray(t) for t in (x, w, a, b, dy))
    for fn in (jref.lora_matmul_ref, _pallas):
        assert _rel(y.detach(), _jax_nodes(fn)(jx, jw, ja, jb)) <= F32_TOL
    _, vjp = jax.vjp(lambda x_, b_: _jax_nodes(jref.lora_matmul_ref)(
        x_, jw, ja, b_), jx, jb)
    want_dx, want_db = vjp(jdy)
    assert _rel(tx.grad, want_dx) <= F32_TOL
    assert _rel(tb.grad, want_db) <= F32_TOL
    # dx is the kernel's function of (dy, W^T, B_k^T per node, A^T): the
    # Pallas kernel vmapped over the per-node operand in A's slot
    dx_pallas = jax.vmap(lambda d, bt: _pallas(d, jw.T, bt, ja.T))(
        jdy, jnp.swapaxes(jb, 1, 2))
    assert _rel(tx.grad, dx_pallas) <= F32_TOL


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def emulate_nodes(x, w, a, b, k_split):
    """The bf16 kernel's arithmetic, node by node: per node f32 sums one k16
    step at a time within each K range of ``k_split``, the ranges added in
    order, the f32 bottleneck's rank-r product added one rank at a time,
    one rounding.  a or b may be per node (K, ., .); strided views as the
    kernel reads them."""
    out = []
    for k_ in range(x.shape[0]):
        xk, ak, bk = (t[k_] if t.dim() == 3 else t for t in (x, a, b))
        xk, wk, ak, bk = (t.float() for t in (xk, w, ak, bk))
        m, kk = xk.shape
        y = torch.zeros((m, wk.shape[1]))
        xa = torch.zeros((m, ak.shape[1]))
        for k0 in range(0, kk, k_split):
            acc = torch.zeros_like(y)
            xacc = torch.zeros_like(xa)
            for s in range(k0, min(kk, k0 + k_split), 16):
                acc = acc + xk[:, s:s + 16] @ wk[s:s + 16]
                xacc = xacc + xk[:, s:s + 16] @ ak[s:s + 16]
            y, xa = y + acc, xa + xacc
        for s in range(ak.shape[1]):
            y = y + xa[:, s:s + 1] * bk[s]
        out.append(y.to(torch.bfloat16))
    return torch.stack(out)


def _one_step(got, want):
    got, want = got.float().numpy(), want.float().numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 2.0 ** -7 * np.abs(want) + 1e-5)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"K{c[0]}-r{c[4]}")
def test_emulation_per_node_matches_jax(case):
    nodes, m, k, n, r = case
    x, w, a, b, dy = (_bf16(t) for t in _inputs(*case, seed=3 * sum(case)))
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w, a, b)]
    got = emulate_nodes(x, w, a, b, tile_plan(m, k, n, nodes)[1])
    assert _rel(got.float(), _jax_nodes(jref.lora_matmul_ref)(*js)) \
        <= BF16_TOL
    _one_step(got, tref.lora_matmul_ref(x, w, a, b))
    # dx: the kernel on (dy, W^T, B_k^T, A^T), the per-node operand in A's
    # slot as a strided view (loop axis contiguous)
    views = (dy, w.t(), b.transpose(-1, -2), a.t())
    _check(*views)
    got = emulate_nodes(*views, tile_plan(m, n, k, nodes)[1])
    jdy = jnp.asarray(dy.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_: _jax_nodes(jref.lora_matmul_ref)(
        x_, *js[1:]), js[0])
    assert _rel(got.float(), vjp(jdy)[0]) <= BF16_TOL
    _one_step(got, tref.lora_matmul_ref(*views))


# the stacked round's calls: 4 nodes x 512 rows (32 x 16 tokens), K 768
STACKED_CALLS = {"forward, N 768": (512, 768, 768),
                 "forward, N 256": (512, 768, 256),
                 "dx from N 768": (512, 768, 768),
                 "dx from N 256": (512, 256, 768)}


@pytest.mark.parametrize("mkn", sorted(STACKED_CALLS.values()))
def test_tile_plan_with_one_node_is_the_single_node_plan(mkn):
    assert tile_plan(*mkn, 1) == tile_plan(*mkn)
    assert n_blocks(*mkn, 1) == n_blocks(*mkn)


@pytest.mark.parametrize("nodes", [4, 16])
@pytest.mark.parametrize("call", sorted(STACKED_CALLS))
def test_tile_plan_counts_the_tiles_of_every_node(call, nodes):
    """K M rows as K separate runs of M tiles: the plan's blocks are K
    times one node's M tiles by the N tiles by the K ranges, and fill the
    card."""
    m, k, n = STACKED_CALLS[call]
    bn, k_split = tile_plan(m, k, n, nodes)
    tiles = nodes * -(-m // BM) * -(-n // bn)
    assert n_blocks(m, k, n, nodes) == tiles * -(-k // k_split)
    assert n_blocks(m, k, n, nodes) >= TARGET_BLOCKS
    # a ragged M: the last tile of each node is partial, never shared
    assert n_blocks(m - 5, k, n, nodes) == n_blocks(m, k, n, nodes)


def test_check_takes_the_node_axis_and_refuses_mismatches():
    x = torch.zeros((3, 8, 16))
    w, a = torch.zeros((16, 24)), torch.zeros((16, 4))
    _check(x, w, a, torch.zeros((3, 4, 24)))
    with pytest.raises(ValueError, match="nodes"):
        _check(x, w, a, torch.zeros((2, 4, 24)))
    with pytest.raises(ValueError, match="node axis"):
        lora_matmul(x, w, a, torch.zeros((4, 24)))
