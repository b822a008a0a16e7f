"""The arithmetic of the port's two attention kernel designs, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  What their designs add to the
plain arithmetic is checked here, against the JAX oracles and Pallas
kernels (interpret mode) in one process, from numpy inputs:

- decode: the wrapper's choice of chunks along the pool (``split_plan``)
  and a plain emulation of the kernel's two passes -- each chunk's (m, l,
  acc), then the merge -- over the same chunk boundaries, f32 tolerance
  1e-5;
- the XOR swizzle of ``csrc/mma.cuh``'s shared-memory tiles, at every
  row width the kernels stage (dh 96's 8 n + 4 chunks among them): a
  bijection whose ldmatrix phases hit 8 distinct bank groups;
- flash: an emulation of the bf16 tensor-core kernel's numerics (scores
  in f32 from bf16 inputs, online softmax in base 2 over 64-key tiles, P
  rounded to bf16 before P V, the row sum from the unrounded P) against
  the plain version at the bf16 tolerance chip_smoke.py uses (3e-2),
  under the causal and the full mask.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TARGET_BLOCKS, split_bounds, split_len_for, split_plan, tile_len)
from _torch_threads import _one_thread  # noqa: E402,F401


SENTINEL = (2 ** 31 - 1) // 2


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------------
# (a) the wrapper's chunks
#: (S, KV, C, dh, rep); a case's id is its first four
POOLS = [(8, 8, 1024, 64, 2),       # fedmm-base
         (8, 8, 1000, 64, 2),       # ragged C
         (8, 3, 1000, 64, 3),       # smollm-135m grouping
         (4, 4, 520, 128, 8),       # yi-6b grouping, dh 128
         (64, 8, 128, 64, 2),       # slots x heads fill the card
         (1, 1, 40, 64, 1),         # shorter than one tile
         (2, 1, 65536, 64, 16),     # a long pool
         (8, 32, 2048, 96, 1),      # Phi-3-vision: dh 96, MHA
         (3, 4, 1000, 96, 1)]       # dh 96, ragged C


@pytest.mark.parametrize("s_slots,n_kv,c,dh,rep", POOLS,
                         ids=["-".join(map(str, p[:4])) for p in POOLS])
def test_split_plan_chunks_are_whole_tiles_and_cover_the_pool(s_slots, n_kv,
                                                              c, dh, rep):
    n_split, split_len = split_plan(s_slots, n_kv, c, dh, rep)
    bounds = split_bounds(c, n_split, split_len)
    tile = tile_len(dh)
    assert bounds[0] == 0 and bounds[-1] == c and len(bounds) == n_split + 1
    assert split_len % tile == 0
    sizes = np.diff(bounds)
    assert (sizes[:-1] == split_len).all()
    if c >= tile:
        assert (sizes >= tile).all()                 # every chunk a whole tile
        assert sizes[-1] < split_len + tile          # the last: + ragged tail
    else:
        assert n_split == 1
    # the kernel's own check on its arguments
    assert (n_split - 1) * split_len < c


def test_split_plan_fills_the_card_at_fedmm_base():
    n_split, split_len = split_plan(8, 8, 1024, 64, 2)
    assert (n_split, split_len) == (8, 128)
    assert n_split * 8 * 8 >= TARGET_BLOCKS == 264


def test_split_plan_at_the_vlm_pool():
    """Phi-3-vision's pool (S 8, C 2,048, KV 32, rep 1, dh 96): tiles of
    32 positions (``kTile<96>``: 4096 // 96 = 42 is no whole number of
    the 16 rows a sweep covers), 256 (KV head, slot) blocks, so 2 chunks
    of 1,024; the kernel's tile loop over them covers every position
    once."""
    assert tile_len(96) == 32 and 4096 // 96 == 42
    n_split, split_len = split_plan(8, 32, 2048, 96, 1)
    assert (n_split, split_len) == (2, 1024)
    assert n_split * 8 * 32 >= TARGET_BLOCKS
    for c in (2048, 1000, 31, 33):
        bounds = split_bounds(c, *split_plan(8, 32, c, 96, 1))
        seen = np.zeros(c, np.int64)
        for a, b in zip(bounds[:-1], bounds[1:]):     # as the split pass
            for t in range(-(-(b - a) // 32)):        # ntiles of TC
                seen[a + 32 * t:min(a + 32 * (t + 1), b)] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("s_slots,n_kv,c", [(64, 8, 128), (33, 8, 4096),
                                            (132, 2, 1024)])
def test_split_plan_one_chunk_when_slots_fill_the_card(s_slots, n_kv, c):
    assert s_slots * n_kv >= TARGET_BLOCKS
    assert split_plan(s_slots, n_kv, c, 64, 2) == (1, 64 * max(1, c // 64))


@pytest.mark.parametrize("c,dh,want", [(512, 64, 3), (1000, 64, 8),
                                       (1000, 64, 100), (256, 128, 5)])
def test_split_len_for_never_makes_more_chunks_than_asked(c, dh, want):
    n_split, split_len = split_len_for(c, dh, want)
    assert 1 <= n_split <= want
    assert (n_split - 1) * split_len < c <= n_split * split_len + tile_len(dh)


# ----------------------------------------------------------------------
# (b) the two passes of the decode kernel, emulated
def _pool(seed, s_slots, c, n_kv, rep, dh, lens, window=0):
    """Slot j holds lens[j] tokens (a ring of width c when ``window``),
    empty entries at the sentinel, the query at the newest position."""
    q = _rnd(seed, (s_slots, n_kv * rep, dh))
    k = _rnd(seed + 1, (s_slots, c, n_kv, dh))
    v = _rnd(seed + 2, (s_slots, c, n_kv, dh))
    lens = np.asarray(lens, np.int32)
    idx = np.arange(c, dtype=np.int32)[None, :]
    if window:
        wrap = ((lens[:, None] - 1 - idx) // c) * c + idx
        pos = np.where((wrap >= 0) & (idx < np.minimum(lens[:, None], c))
                       & (wrap < lens[:, None]), wrap, SENTINEL)
    else:
        pos = np.where(idx < lens[:, None], idx, SENTINEL)
    q_pos = np.maximum(lens - 1, 0).astype(np.int32)
    return q, k, v, q_pos, pos.astype(np.int32)


def _one_chunk_only(seed):
    """Slot 1's visible entries lie at pool indices [200, 250): inside
    one chunk for 1, 2, 3 and 8 chunks of C 512; every other chunk of the
    slot is empty.  Slot 2 is fully masked."""
    q, k, v, q_pos, pos = _pool(seed, 3, 512, 2, 2, 64, [512, 0, 0])
    pos[1] = SENTINEL
    pos[1, 200:250] = np.arange(50)
    q_pos[1] = 49
    return q, k, v, q_pos, pos


# name -> (pool, window, fully masked slots)
DECODE_CASES = {
    "fully masked slot": (lambda: _pool(1, 4, 512, 2, 2, 64,
                                        [512, 0, 300, 77]), 0, (1,)),
    "visible in one chunk only": (lambda: _one_chunk_only(5), 0, (2,)),
    "ring window 256": (lambda: _pool(9, 4, 512, 2, 2, 64,
                                      [100, 512, 700, 1500], window=256),
                        256, ()),
    "rep 1": (lambda: _pool(13, 3, 512, 4, 1, 64, [512, 3, 260]), 0, ()),
    "rep 3": (lambda: _pool(17, 3, 512, 2, 3, 64, [0, 511, 129]), 0, (0,)),
    "rep 8": (lambda: _pool(21, 2, 512, 1, 8, 64, [512, 64]), 0, ()),
    "dh 128": (lambda: _pool(25, 3, 256, 2, 2, 128, [256, 31, 0]), 0, (2,)),
    "dh 96 rep 1": (lambda: _pool(29, 3, 256, 2, 1, 96, [256, 40, 0]), 0,
                    (2,)),
}
_reference_cache = {}


def _references(name):
    """The port's plain version, the Pallas kernel (interpret mode) and the
    JAX oracle on one case, computed once."""
    if name not in _reference_cache:
        make, window, _ = DECODE_CASES[name]
        arrays = make()
        plain = tref.decode_attention_ref(
            *(torch.from_numpy(a) for a in arrays), window=window).numpy()
        jin = [jnp.asarray(a) for a in arrays]
        pallas = np.asarray(decode_attention_pallas(
            *jin, window=window, bkv=128, interpret=True), np.float32)
        oracle = np.asarray(jref.decode_attention_ref(*jin, window=window),
                            np.float32)
        _reference_cache[name] = (arrays, plain, pallas, oracle)
    return _reference_cache[name]


def _two_pass(q, k, v, q_pos, kv_pos, window, bounds):
    """The split pass (per chunk: row max m, row sum l, un-normalised
    accumulator; an empty chunk gives m = -inf, l = 0) and the combine
    pass, in f32, as csrc/decode_attention.cu computes them."""
    s_slots, h, dh = q.shape
    c, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    window = window or c
    qg = q.float().reshape(s_slots, n_kv, rep, dh) * dh ** -0.5
    sc = torch.einsum("bgrd,bcgd->bgrc", qg, k.float())
    qp = q_pos.long()[:, None, None, None]
    kp = kv_pos.long()[:, None, None, :]
    ok = ((kp <= qp) & (qp - kp < window)).expand_as(sc)
    ms, ls, accs = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        x, o = sc[..., a:b], ok[..., a:b]
        seen = o.any(-1, keepdim=True)
        m = torch.where(seen, x.masked_fill(~o, -math.inf).amax(
            -1, keepdim=True), torch.tensor(-math.inf))
        p = torch.where(o, torch.exp(x - torch.where(seen, m, 0.0)), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bgrc,bcgd->bgrd", p, v[:, a:b].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = l > 0                                    # empty chunks skipped
    m_star = torch.where(live, m, -math.inf).amax(0)
    w = torch.where(live, torch.exp(
        m - torch.where(torch.isfinite(m_star), m_star, 0.0)), 0.0)
    out = (acc * w).sum(0) / (l * w).sum(0).clamp_min(1e-30)
    return out.reshape(s_slots, h, dh)


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_two_passes_match_the_references(name, n_split):
    arrays, plain, pallas, oracle = _references(name)
    _, window, masked = DECODE_CASES[name]
    c, dh = arrays[1].shape[1], arrays[0].shape[2]
    got_n, split_len = split_len_for(c, dh, n_split)
    assert got_n == n_split                         # the case needs n tiles
    bounds = split_bounds(c, got_n, split_len)
    got = _two_pass(*(torch.from_numpy(a) for a in arrays), window,
                    bounds).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    live = [i for i in range(got.shape[0]) if i not in masked]
    np.testing.assert_allclose(got[live], oracle[live], atol=1e-5)
    for i in masked:                                # exactly 0, as Pallas
        assert np.abs(got[i]).max() == 0.0 and np.abs(pallas[i]).max() == 0.0


def test_one_chunk_case_leaves_every_other_chunk_empty():
    """The case's premise: at 8 chunks, slot 1 sees entries in one only."""
    q, k, v, q_pos, pos = _one_chunk_only(5)
    bounds = split_bounds(512, *split_len_for(512, 64, 8))
    seen = [bool(((pos[1, a:b] <= q_pos[1])).any())
            for a, b in zip(bounds[:-1], bounds[1:])]
    assert seen == [False, False, False, True, False, False, False, False]


# ----------------------------------------------------------------------
# (c) the shared-memory swizzle of mma.cuh, emulated
def _swz(row, r, c):
    """``swz<ROW>`` of csrc/mma.cuh: the element offset of 16-byte chunk c
    of row r in a swizzled bf16 tile of ``row`` elements a row."""
    ch = row // 8
    if ch > 8 and ch % 8 == 4:                      # 8 n + 4 chunks (dh 96)
        head = ch - 4
        c = c ^ (r & 7) if c < head else head + ((c - head) ^ ((r >> 1) & 3))
        return (r * ch + c) * 8
    mask = min(ch, 8) - 1
    shift = 0 if ch >= 8 else {4: 1, 2: 2}.get(ch, 3)
    return (r * ch + (c ^ ((r >> shift) & mask))) * 8


@pytest.mark.parametrize("row", [16, 32, 64, 96, 128, 192, 256, 576])
def test_swizzle_is_a_bijection_free_of_bank_conflicts(row):
    """Each chunk of a 64-row tile lands once, in its own row, and the 8
    rows one ldmatrix phase reads at one logical chunk (rows 8 j .. 8 j +
    7, as the flash kernel's K and V reads take them) hit 8 distinct
    16-byte bank groups: the 8 n + 4 layout of dh 96 as much as the
    others.  A 16-byte row needs no swizzle (its 8 rows span the banks)."""
    ch, rows = row // 8, 64
    offs = [[_swz(row, r, c) for c in range(ch)] for r in range(rows)]
    flat = sorted(o for line in offs for o in line)
    assert flat == list(range(0, rows * row, 8))
    assert all(r * row <= o < (r + 1) * row
               for r, line in enumerate(offs) for o in line)
    for r0 in range(0, rows, 8):
        for c in range(ch):
            groups = {(offs[r][c] * 2 // 16) % 8 for r in range(r0, r0 + 8)}
            assert len(groups) == 8, (row, r0, c)


# ----------------------------------------------------------------------
# (d) the bf16 flash kernel's numerics, emulated
def _flash_tensor_core(q, k, v, bk=64, causal=True):
    """Causal attention (bottom-right; every key visible under ``causal``
    False, the kernel's full mask) as the bf16 kernel computes it: f32
    scores of bf16 q and k, scaled by dh^-0.5 log2(e) in f32; an online
    softmax in base 2 over tiles of ``bk`` keys; P rounded to bf16 before
    it meets V, the row sum l from the unrounded P; out / max(l, 1e-30)
    cast to bf16."""
    b, t, h, dh = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    qf = q.float().reshape(b, t, n_kv, rep, dh)
    kf, vf = k.float(), v.float()
    scale_log2 = dh ** -0.5 * math.log2(math.e)
    m = torch.full((b, n_kv, rep, t, 1), -math.inf)
    l = torch.zeros((b, n_kv, rep, t, 1))
    o = torch.zeros((b, n_kv, rep, t, dh))
    qi = torch.arange(t)[:, None]
    for k0 in range(0, s, bk):
        x = torch.einsum("btgrd,bsgd->bgrts", qf, kf[:, k0:k0 + bk]) \
            * scale_log2
        ki = torch.arange(k0, min(k0 + bk, s))[None, :]
        if causal:
            x = x.masked_fill(~(ki <= qi + (s - t)), -math.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(x - base)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("bgrts,bsgd->bgrtd",
                                    p.bfloat16().float(), vf[:, k0:k0 + bk])
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh).bfloat16()


def _fold(x):
    """(B, T, H, dh) -> (B*H, T, dh), the layout of the JAX oracle."""
    b, t, h, dh = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * h, t, dh)


@pytest.mark.parametrize("b,t,s,h,n_kv,dh", [
    (1, 512, 512, 16, 8, 64),      # serve prefill
    (32, 16, 16, 12, 4, 64),       # the federated round
    (1, 100, 300, 8, 2, 128),      # S != T, dh 128
    (4, 65, 65, 6, 3, 64),         # ragged T, B 4
    (1, 300, 300, 4, 4, 96),       # Phi-3-vision's dh 96, MHA
    (2, 100, 200, 4, 2, 96)])      # dh 96, S != T
def test_flash_tensor_core_numerics_fit_the_bf16_check(b, t, s, h, n_kv, dh):
    seed = t + s
    q, k, v = (torch.from_numpy(_rnd(seed + i, shape)).bfloat16()
               for i, shape in enumerate(((b, t, h, dh), (b, s, n_kv, dh),
                                          (b, s, n_kv, dh))))
    got = _flash_tensor_core(q, k, v).float()
    plain = tref.flash_attention_ref(q, k, v).float()
    assert (got - plain).abs().max().item() <= 3e-2
    rep = h // n_kv
    kr, vr = (np.repeat(x.float().numpy(), rep, 2) for x in (k, v))
    oracle = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(_fold(x), jnp.bfloat16)
          for x in (q.float().numpy(), kr, vr))), np.float32)
    np.testing.assert_allclose(_fold(got.numpy()), oracle, atol=3e-2)


@pytest.mark.parametrize("b,t,s,h,n_kv,dh", [
    (1, 375, 375, 5, 5, 64),       # Whisper's encoder cut 4x, MHA
    (1, 56, 375, 5, 5, 64),        # its cross attention, T != S
    (2, 1, 375, 4, 2, 64),         # one row, rep 2
    (1, 65, 300, 4, 4, 96),        # ragged, dh 96
    (1, 100, 40, 4, 2, 128)])      # fewer keys than rows, dh 128
def test_flash_tensor_core_numerics_fit_the_bf16_check_full_mask(
        b, t, s, h, n_kv, dh):
    """The emulation under the full mask against the plain version and
    the JAX oracle at ``causal=False`` (3e-2 in bf16)."""
    seed = 2 * t + s
    q, k, v = (torch.from_numpy(_rnd(seed + i, shape)).bfloat16()
               for i, shape in enumerate(((b, t, h, dh), (b, s, n_kv, dh),
                                          (b, s, n_kv, dh))))
    got = _flash_tensor_core(q, k, v, causal=False).float()
    plain = tref.flash_attention_ref(q, k, v, causal=False).float()
    assert (got - plain).abs().max().item() <= 3e-2
    rep = h // n_kv
    kr, vr = (np.repeat(x.float().numpy(), rep, 2) for x in (k, v))
    oracle = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(_fold(x), jnp.bfloat16)
          for x in (q.float().numpy(), kr, vr)), causal=False), np.float32)
    np.testing.assert_allclose(_fold(got.numpy()), oracle, atol=3e-2)
