"""The wgmma design of the absorbed-MLA decode kernel
(``src/repro_torch/csrc/mla_decode.cu``) on the CPU: what its arithmetic
adds to the plain version, in one process.

- ``mla_decode.share_plan``, the Python twin of the integer arithmetic by
  which each CTA takes its share of one slot's visible tiles from
  ``lens`` on the device, covers every visible tile exactly once, in
  shares of one slot each that hold at most the least cap (of at least
  ``least`` tiles) needing G shares, leaves at most G (so G + S - 1)
  pieces, and agrees with what
  the combine pass derives for each slot -- at DeepSeek-V2's serve pool,
  all slots at lens 0, all at C, one at C with seven at 0, S 64 at C 128,
  S 1 at C 1 and seeded random lens for S 1, 8 and 64, at share counts
  from S to more than the tiles, at least 1 and 3 tiles a share;
- ``ref.mla_decode_pieces_ref``, the plain emulation of the design (the
  same pieces, tile order and combine order, P rounded to q's dtype)
  against ``ref.mla_decode_ref`` (f32, 1e-5: f32 sums in another order)
  and against the JAX reference's ``mla_decode_slots`` einsums at kvr 512
  / rd 64 (f32 1e-5; bf16 within the card's limit for this kernel, 5e-3 +
  2^-5 |want|, since the two round P or alpha to bf16 at different
  points);
- ``mla_plan`` picks the design by (dtype, H) and ``share_budget``
  sizes G.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import mla_decode as md  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

#: DeepSeek-V2's serve pool (C 4,352) and its slots' lens
POOL_C = 4352
POOL_LENS = [0, 1, 511, 1000, 2049, 4095, 4351, 4352]
_rng = np.random.default_rng(26)
#: name -> (lens, C)
CASES = {
    "pool": (POOL_LENS, POOL_C),
    "all at 0": ([0] * 8, POOL_C),
    "all at C": ([POOL_C] * 8, POOL_C),
    "one at C, seven at 0": ([POOL_C] + [0] * 7, POOL_C),
    "S 64 at C 128": ([(37 * i) % 129 for i in range(64)], 128),
    "S 1 at C 1": ([0], 1),
    **{f"random S {s}": (_rng.integers(0, 3000, s).tolist(), 2999)
       for s in (1, 8, 64)},
}
SHARES = [0, 5, 66, 132, 1000]          # added to S, or at least S


def _shares(case, extra):
    s = len(CASES[case][0])
    return s + extra if extra < 6 else max(s, extra)


def _combine_view(lens, c, shares, least):
    """{slot: (first piece, pieces)} of every slot in pieces, as the
    combine pass derives it (``mla_piece_combine_kernel``): each slot's
    share count from the cap, its first piece from a prefix over the
    slots before it."""
    tiles = md._visible_tiles(lens, c)
    cap = md.share_cap(tiles, shares, least)
    view, base = {}, 0
    for s, n in enumerate(tiles):
        k = -(-n // cap)
        if k > 1:
            view[s] = (base, k)
            base += k
    return view


@pytest.mark.parametrize("least", [1, 3])
@pytest.mark.parametrize("extra", SHARES)
@pytest.mark.parametrize("case", list(CASES))
def test_share_plan_covers_each_visible_tile_once(case, extra, least):
    lens, c = CASES[case]
    shares = _shares(case, extra)
    tiles = md._visible_tiles(lens, c)
    segs = md.share_plan(lens, c, shares, least)
    seen = []
    for g, s, a, b, _ in segs:
        assert 0 <= a < b <= tiles[s]
        seen += [(s, t) for t in range(a, b)]
    assert seen == [(s, t) for s, n in enumerate(tiles) for t in range(n)]
    # shares are numbered in order, at most G, one slot each, none holding
    # more than the least cap of at least `least` that needs at most G
    # shares
    assert [g for g, *_ in segs] == list(range(len(segs)))
    assert len(lens) <= len(segs) <= shares
    cap = md.share_cap(tiles, shares, least)
    assert cap == next(b for b in range(least, max(tiles) + least + 1)
                       if sum(-(-n // b) for n in tiles) <= shares)
    assert max(b - a for _, _, a, b, _ in segs) <= cap
    by_slot = {}
    for g, s, a, b, p in segs:
        by_slot.setdefault(s, []).append((b - a, p))
    for s, got in by_slot.items():
        sizes = [n for n, _ in got]
        assert max(sizes) - min(sizes) <= 1 and max(sizes) <= cap
    # a slot of one share writes the output; the others leave pieces,
    # numbered slot after slot: at most G (so at most G + S - 1)
    pieces = [p for *_, p in segs if p >= 0]
    assert pieces == list(range(len(pieces)))
    assert len(pieces) <= shares
    assert {s: (got[0][1], len(got)) for s, got in by_slot.items()
            if got[0][1] >= 0} == _combine_view(lens, c, shares, least)
    assert all((len(got) == 1) == (got[0][1] < 0)
               for got in by_slot.values())


def test_share_plan_needs_a_share_a_slot():
    with pytest.raises(ValueError):
        md.share_plan([1, 2, 3], 64, 2)


def test_visible_tiles_rule():
    """A slot shows its rows c <= lens (at most C) in tiles of 64, and at
    least one tile: position 0 is visible at lens 0."""
    assert md._visible_tiles([0, 63, 64, 127, 4351, 4352, 9999], 4352) == \
        [1, 1, 2, 2, 68, 68, 68]
    assert md._visible_tiles([-1, 0], 1) == [1, 1]
    assert sum(md._visible_tiles(POOL_LENS, POOL_C)) == 259


def _inputs(s, h, c, lens, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in
            ((s, h, 512), (s, h, 64), (s, c, 512), (s, c, 64))]
    return arrs, np.array(lens, dtype=np.int32)


@pytest.mark.parametrize("least", [1, 2])
@pytest.mark.parametrize("shares", [6, 8, 13, 40])
@pytest.mark.parametrize("c,lens", [(300, [0, 63, 64, 299, 300]),
                                    (130, [129, 1, 130, 64, 0, 65]),
                                    (1280, [1279, 0, 5])])
def test_pieces_ref_matches_plain(c, lens, shares, least):
    """Up to 20 pieces a slot (more than the combine's batch of 16 at 1280
    positions, 40 shares, one tile a share)."""
    arrs, ln = _inputs(len(lens), 4, c, lens, seed=c + shares)
    args = [torch.from_numpy(a) for a in arrs]
    got = ref.mla_decode_pieces_ref(*args, torch.from_numpy(ln), 0.07,
                                    shares, least)
    want = ref.mla_decode_ref(*args, torch.from_numpy(ln), 0.07)
    assert (got - want).abs().max().item() <= 1e-5


def _mla_einsums(q_c, q_rope, c_kv, k_rope, lens, scale):
    """The attention of ``repro.models.attention.mla_decode_slots`` (its
    lines after the cache write), in jnp."""
    sc = (jnp.einsum("bhc,bsc->bhs", q_c, c_kv,
                     preferred_element_type=jnp.float32)
          + jnp.einsum("bhd,bsd->bhs", q_rope, k_rope,
                       preferred_element_type=jnp.float32)) * scale
    valid = jnp.arange(c_kv.shape[1])[None, None, :] <= lens[:, None, None]
    sc = jnp.where(valid, sc, -1e30)
    alpha = jax.nn.softmax(sc, axis=-1).astype(c_kv.dtype)
    return jnp.einsum("bhs,bsc->bhc", alpha, c_kv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pieces_ref_matches_reference_einsums(dtype):
    """The emulation of the kernel's split (7 shares over 4 slots of 1 to
    4 tiles: three slots in 6 pieces) against the JAX reference, at
    DeepSeek-V2's latent (kvr 512, rd 64) and scale 192^-0.5."""
    lens, c, scale = [255, 0, 200, 130], 256, 192 ** -0.5
    arrs, ln = _inputs(len(lens), 8, c, lens, seed=7)
    jt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tt = getattr(torch, dtype)
    want = np.asarray(_mla_einsums(*(jnp.asarray(a, jt) for a in arrs),
                                   jnp.asarray(ln), scale), np.float32)
    args = [torch.from_numpy(a).to(tt) for a in arrs]
    assert sum(p >= 0 for *_, p in md.share_plan(lens, c, 7)) == 6
    got = ref.mla_decode_pieces_ref(*args, torch.from_numpy(ln), scale,
                                    7).float().numpy()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5
    else:
        assert (diff / (5e-3 + 2 ** -5 * np.abs(want))).max() <= 1.0


@pytest.mark.parametrize("dtype,h,c,design", [
    ("float32", 128, POOL_C, "fma"), ("float32", 64, POOL_C, "fma"),
    ("bfloat16", 16, POOL_C, "mma"), ("bfloat16", 32, POOL_C, "mma"),
    ("bfloat16", 48, POOL_C, "mma"), ("bfloat16", 64, POOL_C, "wgmma"),
    ("bfloat16", 128, POOL_C, "wgmma"), ("bfloat16", 128, 128, "wgmma"),
    ("bfloat16", 64, 1, "wgmma"), ("bfloat16", 96, POOL_C, "mma")])
def test_mla_plan_picks_design(dtype, h, c, design):
    """The wgmma design at bf16 H 64 / 128; the mma design at other
    bf16 head counts; the FMA kernel in f32."""
    plan = md.mla_plan(getattr(torch, dtype), 8, h, c)
    assert plan[0] == design and plan[0] in md.DESIGNS
    if design == "wgmma":
        assert plan[1:] == (md.share_budget(8, h, c, md.WG_LEAST),
                            md.WG_LEAST)
        assert 8 <= plan[1]
        assert plan[1] == 8 or plan[1] * (h // md.WG_HEADS) <= md.WG_CTAS
    else:
        assert plan[1:] == md.split_plan(8, h, c)


def test_mla_plan_shares_at_most_the_tiles():
    """G fills the card's CTAs, but never more shares than the slots could
    use at ``least`` tiles a share, and one a slot where a full slot holds
    fewer than 2 S tiles."""
    assert md.share_budget(1, 128, 1, 1) == 1
    assert md.share_budget(2, 64, 200, 1) == 8
    assert md.share_budget(2, 64, 200, 3) == 4
    assert md.share_budget(4, 64, 2000, 3) == 44
    assert md.share_budget(8, 128, 4352, 3) == md.WG_CTAS // 2
    assert md.share_budget(80, 128, 4352, 3) == 80
    assert md.share_budget(16, 128, 2048, 3) == md.WG_CTAS // 2
    assert md.share_budget(34, 128, 4352, 3) == md.WG_CTAS // 2
    # a full slot under 2 S tiles: one share a slot (no combine pass)
    assert md.share_budget(64, 128, 128, 1) == 64
    assert md.share_budget(64, 128, 4352, 3) == 64
    assert md.share_budget(35, 128, 4352, 3) == 35
    assert md.share_budget(16, 128, 512, 3) == 16
    assert md.mla_plan(torch.bfloat16, 8, 128, 4352)[1] == md.WG_CTAS // 2
