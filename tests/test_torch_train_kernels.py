"""The federated round's kernels on the CPU: the plain versions of the
``gram`` and ``lora_matmul`` kernels against the JAX oracles and the
Pallas kernels (interpret mode), and the gradients of the three autograd
Functions (gram, lora_matmul, flash attention) and of the GeoLoRA /
GeoDoRA ``linear`` against ``jax.grad`` of the JAX package's jnp path.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them
against these plain versions there.  On the CPU the Functions' forward
and backward run the plain versions and the same backward formulas the
card runs.  Tolerances as in tests/test_kernels.py: 1e-5 for f32 and
3e-2 for bf16, with inputs scaled so the outputs stay under 2, where one
bf16 step is at most 2^-7 (an f32 sum in another order may round to the
neighbouring bf16 value).  Gradients are f32, to 1e-5 of their size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cka as jcka  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gram import cosine_gram_pallas  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.gram import cosine_gram  # noqa: E402
from repro_torch.kernels.lora_matmul import lora_matmul  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol, what="", rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=rtol, err_msg=what)


# ----------------------------------------------------------------------
# plain versions against the JAX oracles and the Pallas kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 96), (37, 100)])
def test_cosine_gram_ref_matches_jax(shape, dtype):
    td, jd = DT[dtype]
    x = _rnd(0, shape)
    x[3] = 0.0                                  # a zero row: the eps clamp
    got = tref.cosine_gram_ref(torch.from_numpy(x).to(td))
    assert got.dtype == torch.float32
    _close(got, jref.cosine_gram_ref(jnp.asarray(x, jd)), TOL[dtype])
    _close(got, cosine_gram_pallas(jnp.asarray(x, jd), block=16,
                                   interpret=True), TOL[dtype])


def test_cosine_gram_ref_batched_matches_vmap():
    x = _rnd(1, (3, 16, 48))
    _close(tref.cosine_gram_ref(torch.from_numpy(x)),
           jax.vmap(jref.cosine_gram_ref)(jnp.asarray(x)), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mknr", [(64, 96, 80, 8), (37, 50, 29, 4)])
def test_lora_matmul_ref_matches_jax(mknr, dtype):
    m, k, n, r = mknr
    td, jd = DT[dtype]
    x, w = _rnd(2, (m, k), 0.25), _rnd(3, (k, n), k ** -0.5)
    a, b = _rnd(4, (k, r), k ** -0.5), _rnd(5, (r, n), r ** -0.5)
    got = tref.lora_matmul_ref(*(torch.from_numpy(t).to(td)
                                 for t in (x, w, a, b)))
    assert got.dtype == td
    js = [jnp.asarray(t, jd) for t in (x, w, a, b)]
    _close(got, jref.lora_matmul_ref(*js), TOL[dtype])
    _close(got, lora_matmul_pallas(*js, bm=16, bn=32, bk=32, interpret=True),
           TOL[dtype])


def test_wrappers_take_the_plain_path_on_the_cpu():
    """A CPU tensor never launches a kernel: the counters stay at 0."""
    before = (cosine_gram.launches, lora_matmul.launches,
              flash_attention.launches)
    x = torch.from_numpy(_rnd(6, (8, 16)))
    cosine_gram(x)
    lora_matmul(x, torch.ones(16, 4), torch.ones(16, 2), torch.ones(2, 4))
    q = torch.from_numpy(_rnd(7, (1, 4, 2, 64)))
    flash_attention(q, q, q)
    assert (cosine_gram.launches, lora_matmul.launches,
            flash_attention.launches) == before


# ----------------------------------------------------------------------
# gradients of the autograd Functions against jax.grad of the jnp path
def _vjp_jax(fn, args, cot):
    """Gradients of <fn(*args), cot> in JAX."""
    return jax.grad(lambda *a: (fn(*a) * cot).sum(),
                    argnums=tuple(range(len(args))))(*args)


def _vjp_torch(fn, args, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (fn(*leaves) * torch.from_numpy(cot)).sum().backward()
    return [t.grad for t in leaves]


def test_cosine_gram_grad_matches_jax():
    """A zero row takes the eps clamp, which passes no gradient to the norm:
    its gradient is dz / sqrt(eps), ~1e4 here, so the check is relative."""
    x = _rnd(8, (2, 12, 40))
    x[0, 5] = 0.0
    cot = _rnd(9, (2, 12, 12))
    (want,) = _vjp_jax(jax.vmap(jcka.cosine_gram), (jnp.asarray(x),),
                       jnp.asarray(cot))
    (got,) = _vjp_torch(cosine_gram, (x,), cot)
    _close(got, want, 1e-5, rtol=1e-5)


def test_lora_matmul_grad_matches_jax():
    m, k, n, r = 20, 24, 16, 4
    x, w = _rnd(10, (m, k)), _rnd(11, (k, n), k ** -0.5)
    a, b = _rnd(12, (k, r), k ** -0.5), _rnd(13, (r, n))
    cot = _rnd(14, (m, n))
    jx, jb = _vjp_jax(lambda x_, b_: x_ @ w + (x_ @ a) @ b_,
                      (jnp.asarray(x), jnp.asarray(b)), jnp.asarray(cot))
    gx, gb = _vjp_torch(lambda x_, b_: lora_matmul(
        x_, torch.from_numpy(w), torch.from_numpy(a), b_), (x, b), cot)
    _close(gx, jx, 1e-5, "dx")
    _close(gb, jb, 1e-5, "dB")


@pytest.mark.parametrize("t", [16, 13])
def test_flash_attention_grad_matches_jax(t):
    """The backward recomputes through ``flash_attention_ref``; the JAX
    path is ``blockwise_attention`` (what ``gqa_forward`` runs)."""
    q, k, v = _rnd(15, (2, t, 4, 64)), _rnd(16, (2, t, 2, 64)), \
        _rnd(17, (2, t, 2, 64))
    cot = _rnd(18, (2, t, 4, 64))
    pos = jnp.arange(t, dtype=jnp.int32)[None].repeat(2, 0)
    want = _vjp_jax(lambda *a: jattn.blockwise_attention(
        *a, kind="causal", q_positions=pos),
        tuple(jnp.asarray(z) for z in (q, k, v)), jnp.asarray(cot))
    got = _vjp_torch(flash_attention, (q, k, v), cot)
    for g, w_, name in zip(got, want, "qkv"):
        _close(g, w_, 1e-5, f"d{name}")


@pytest.mark.parametrize("dora", [False, True])
def test_geolora_linear_matches_jax(dora):
    """``linear`` with side-cars, forward and the gradients in x, lora_B
    and dora_m (the DoRA norm sees B live, W and A detached)."""
    d_in, d_out, r = 24, 16, 4
    lin = {"w": _rnd(19, (d_in, d_out), d_in ** -0.5),
           "lora_A": _rnd(20, (d_in, r), r ** -0.5),
           "lora_B": _rnd(21, (r, d_out), 0.1)}
    if dora:
        lin["dora_m"] = 1.0 + _rnd(22, (d_out,), 0.1)
    x, cot = _rnd(23, (3, 5, d_in)), _rnd(24, (3, 5, d_out))
    live = ["lora_B"] + (["dora_m"] if dora else [])

    def jfn(x_, *vals):
        return jcommon.linear(x_, dict(lin, **dict(zip(live, vals))))

    def tfn(x_, *vals):
        frozen = {k: torch.from_numpy(v) for k, v in lin.items()}
        return tcommon.linear(x_, dict(frozen, **dict(zip(live, vals))))

    args = (x, *(lin[k] for k in live))
    _close(tfn(*(torch.from_numpy(a) for a in args)),
           jfn(*(jnp.asarray(a) for a in args)), 1e-5, "forward")
    want = _vjp_jax(jfn, tuple(jnp.asarray(a) for a in args),
                    jnp.asarray(cot))
    got = _vjp_torch(tfn, args, cot)
    for g, w_, name in zip(got, want, ["x"] + live):
        _close(g, w_, 1e-5, f"d{name}")
