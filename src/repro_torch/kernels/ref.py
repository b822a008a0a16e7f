"""Plain PyTorch versions of the port's kernels.

Each wrapper in ``kernels/`` sends a CPU tensor here; on the card
``chip_smoke.py`` holds the CUDA kernel against these on the same inputs.
They mirror the JAX oracles in ``repro/kernels/ref.py``; ``mla_decode_ref``,
whose kernel replaces no Pallas kernel, mirrors the jnp einsums of
``repro.models.attention.mla_decode_slots``; ``mla_decode_pieces_ref``
and ``selective_scan_chunked_ref`` are twins of a kernel design's
arithmetic for the tests.  ``cosine_gram_ref``
also takes a stack (K, B, D) of node batches, and ``lora_matmul_ref`` has
no scale (every caller of the JAX ``linear`` uses 1).  The attention
versions differ from the JAX oracles in two deliberate ways, both of
which the CUDA kernels share:

- a row whose every key is masked yields 0, as ``decode_attention_pallas``
  does (it masks ``p`` explicitly and clamps ``l``); the JAX oracle takes
  a softmax over an all ``-1e30`` row and yields the mean of V instead;
- ``flash_attention_ref`` takes the ``blockwise_attention`` layout --
  q (B, T, H, dh), k / v (B, S, KV, dh), query head h reading KV head
  h // (H // KV) -- so ``gqa_forward`` calls it without a transpose.  Its
  mask is causal, aligned bottom-right (``k <= q + (S - T)``) as in the
  JAX oracle (with S == T, as in prefill, that is the Pallas rule too),
  or with ``window`` > 0 the oracle's sliding kind aligned the same way,
  ``k <= q + (S - T)`` and ``q + (S - T) - k < window``, or with
  ``chunk`` > 0 its chunked kind (llama4's local attention), ``k <= q +
  (S - T)`` and ``(q + (S - T)) // chunk == k // chunk``; or with
  ``causal=False`` the Pallas kernel's and the oracle's full mask, every
  key 0..S-1 visible to every row (no padded key: the oracle pads none,
  and the Pallas kernel masks its padding by ``sk_valid``).

``window`` and ``chunk`` exclude each other and the full mask.  Both attention versions
read absolute positions for the chunked rule: ``q + (S - T)`` and the
key index for flash, ``q_pos`` and ``kv_pos`` for decode.

Attention scores (scaled by dh^-0.5), softmax and the weighted sum run in
float32; the result is cast back to the input dtype.  The scan runs in
float32 and returns float32, as the Pallas kernel does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_softmax_av(sc: torch.Tensor, ok: torch.Tensor, v_eq: str,
                       v: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the last axis, then the V contraction; fully
    masked rows give 0."""
    sc = sc.masked_fill(~ok, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(sc - m), sc.new_zeros(()))
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(v_eq, p / l.clamp_min(1e-30), v.float())


def _chunk_start(pos: torch.Tensor, chunk: int) -> torch.Tensor:
    """The first position of ``pos``'s chunk (positions >= 0)."""
    return pos - pos % chunk


def _check_mask(window: int, chunk: int, causal: bool = True) -> None:
    if window and chunk:
        raise ValueError(f"window {window} and chunk {chunk}: the sliding "
                         f"and chunked masks exclude each other")
    if not causal and (window or chunk):
        raise ValueError(f"window {window} and chunk {chunk} with "
                         f"causal=False: the full mask takes neither")


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         window: int = 0, chunk: int = 0) -> torch.Tensor:
    """Single-token decode attention over the packed KV pool.
    q: (S, H, dh); k, v: (S, C, KV, dh); q_pos: (S,); kv_pos: (S, C).
    Entry c of slot s is visible when
    ``kv_pos <= q_pos and q_pos - kv_pos < window`` (window 0 means C),
    and with ``chunk`` > 0 when ``kv_pos <= q_pos`` and both lie in one
    chunk, ``kv_pos >= q_pos - q_pos % chunk``."""
    _check_mask(window, chunk)
    s_slots, h, dh = q.shape
    c, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    window = window or c
    qg = q.float().reshape(s_slots, n_kv, rep, dh) * dh ** -0.5
    sc = torch.einsum("bgrd,bcgd->bgrc", qg, k.float())
    qp = q_pos.to(torch.int64)[:, None, None, None]
    kp = kv_pos.to(torch.int64)[:, None, None, :]
    ok = (kp <= qp) & (qp - kp < window)
    if chunk:
        ok = ok & (kp >= _chunk_start(qp, chunk))
    out = _masked_softmax_av(sc, ok, "bgrc,bcgd->bgrd", v)
    return out.reshape(s_slots, h, dh).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        chunk: int = 0) -> torch.Tensor:
    """Causal (``window`` and ``chunk`` 0), sliding-window, chunked or,
    under ``causal=False``, full (every key to every row, T != S allowed)
    full-sequence attention.  q: (B, T, H, dh); k: (B, S, KV, dh) and v
    (B, S, KV, dv) with H = KV * rep; dv may differ from dh (MLA's q.k
    heads of 192 and v heads of 128), and the scores are scaled by
    dh^-0.5 all the same.  Returns (B, T, H, dv)."""
    _check_mask(window, chunk, causal)
    b, t, h, dh = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    qg = q.float().reshape(b, t, n_kv, rep, dh) * dh ** -0.5
    sc = torch.einsum("btgrd,bsgd->bgrts", qg, k.float())
    qi = torch.arange(t, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    qa = qi + (s - t)                          # the query's position
    ok = ki <= qa if causal else torch.ones(
        (t, s), dtype=torch.bool, device=q.device)
    if window:
        ok = ok & (qa - ki < window)
    if chunk:
        ok = ok & (ki >= _chunk_start(qa, chunk))
    ok = ok.expand(b, n_kv, rep, t, s)
    out = _masked_softmax_av(sc, ok, "bgrts,bsgd->btgrd", v)
    return out.reshape(b, t, h, v.shape[-1]).to(q.dtype)


def mla_decode_ref(q_c: torch.Tensor, q_rope: torch.Tensor,
                   c_kv: torch.Tensor, k_rope: torch.Tensor,
                   lens: torch.Tensor, scale: float) -> torch.Tensor:
    """Absorbed MLA decode over the latent pool: every query head of a
    slot reads the slot's one latent row per position, which is both its
    key (with the rope key beside it) and its value.
    q_c: (S, H, kvr); q_rope: (S, H, rd); c_kv: (S, C, kvr); k_rope:
    (S, C, rd); lens: (S,) int32.  Entry c of slot s is visible when
    ``c <= lens[s]`` (so at ``lens == C`` all C are).  Scores
    ``(q_c . c_kv + q_rope . k_rope) * scale``, the softmax and the
    weighted sum of ``c_kv`` run in float32; returns (S, H, kvr) in q's
    dtype."""
    sc = (torch.einsum("shc,snc->shn", q_c.float(), c_kv.float())
          + torch.einsum("shd,snd->shn", q_rope.float(), k_rope.float())
          ) * scale
    n = torch.arange(c_kv.shape[1], device=c_kv.device)
    ok = (n[None, :] <= lens.to(torch.int64)[:, None])[:, None, :]
    out = _masked_softmax_av(sc, ok.expand_as(sc), "shn,snc->shc", c_kv)
    return out.to(q_c.dtype)


def mla_decode_pieces_ref(q_c: torch.Tensor, q_rope: torch.Tensor,
                          c_kv: torch.Tensor, k_rope: torch.Tensor,
                          lens: torch.Tensor, scale: float,
                          shares: int, least: int = 1) -> torch.Tensor:
    """``mla_decode_ref`` computed as the wgmma design of
    ``csrc/mla_decode.cu`` computes it, for the tests: the shares of
    ``mla_decode.share_plan(lens, C, shares, least)``, each walked tile by tile
    (``WG_TILE`` positions) with a running max m (raw score units), row
    sum l and accumulator, the probabilities exp2(s log2(e) scale - m
    log2(e) scale) rounded to q's dtype for the P . V product (bf16 as the
    kernel rounds them; f32 inputs keep them) and summed in f32 for l; a
    slot of one share is divided out at once, the pieces of the others (m
    in natural units) merged in share order, sixteen at a time into a
    running max m*, sum and accumulator rescaled to each batch's new max:
    out = sum acc_i e^(m_i - m*) / max(sum l_i e^(m_i - m*), 1e-30).
    Sums run in float32 in another order than the tensor cores', so it
    meets the kernel within rounding, not bit for bit.  A twin; no path calls it."""
    from repro_torch.kernels.mla_decode import WG_TILE, share_plan

    s_slots, h, kvr = q_c.shape
    c = c_kv.shape[1]
    q = torch.cat([q_c, q_rope], -1).float()
    kv = torch.cat([c_kv, k_rope], -1).float()
    sl2 = scale * 1.4426950408889634
    ninf = float("-inf")
    ln = [int(x) for x in lens.tolist()]
    out = torch.zeros((s_slots, h, kvr), dtype=torch.float32,
                      device=q_c.device)
    pieces = {}
    for _, s, a, b, piece in share_plan(ln, c, shares, least):
        n_vis = 0 if ln[s] < 0 else min(ln[s] + 1, c)
        m = torch.full((h,), ninf, device=q_c.device)
        l = torch.zeros((h,), device=q_c.device)
        acc = torch.zeros((h, kvr), device=q_c.device)
        for t in range(a, b):
            rows = kv[s, t * WG_TILE:(t + 1) * WG_TILE]
            sc = q[s] @ rows.T
            pos = torch.arange(t * WG_TILE, t * WG_TILE + rows.shape[0],
                               device=q_c.device)
            sc = sc.masked_fill((pos >= n_vis)[None], ninf)
            m_new = torch.maximum(m, sc.amax(-1))
            base = torch.where(m_new == ninf, 0.0, m_new * sl2)
            corr = torch.exp2(m * sl2 - base)
            p = torch.exp2(sc * sl2 - base[:, None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None] + p.to(q_c.dtype).float() @ rows[:, :kvr]
            m = m_new
        if piece < 0:
            out[s] = acc / l.clamp_min(1e-30)[:, None]
        else:
            mn = torch.where(m == ninf, m, m * scale)
            pieces.setdefault(s, []).append((mn, l, acc))
    for s, ps in pieces.items():                    # the combine, 16 at a time
        mstar = torch.full((h,), ninf, device=q_c.device)
        lsum = torch.zeros_like(mstar)
        acc = torch.zeros_like(out[s])
        for i0 in range(0, len(ps), 16):
            batch = ps[i0:i0 + 16]
            mb = torch.stack([mstar] + [mi for mi, _, _ in batch]).amax(0)
            keep = torch.where(mstar == ninf, 0.0, torch.exp(mstar - mb))
            keep = torch.where(mb == ninf, 1.0, keep)
            lsum, acc = lsum * keep, acc * keep[:, None]
            for mi, li, ai in batch:
                w = torch.where(mi == ninf, 0.0, torch.exp(mi - mb))
                lsum = lsum + w * li
                acc = acc + w[:, None] * ai
            mstar = torch.where(mb == ninf, mstar, mb)
        out[s] = acc / lsum.clamp_min(1e-30)[:, None]
    return out.to(q_c.dtype)


def cosine_gram_ref(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarities in float32, each row divided by
    ``sqrt(max(|x|^2, eps))``.  x: (B, D) -> (B, B), or a stack
    (K, B, D) -> (K, B, B)."""
    x32 = x.float()
    xn = x32 / torch.sqrt((x32 * x32).sum(-1, keepdim=True).clamp_min(eps))
    return xn @ xn.transpose(-1, -2)


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The GeoLoRA linear y = x @ W + (x @ A) @ B, both products in float32,
    cast back to x's dtype.  x: (M, K); w: (K, N); a: (K, r); b: (r, N).
    With a node axis x is (nodes, M, K) and a (nodes, K, r) and / or b
    (nodes, r, N) are per node (the products broadcast over it): node k
    gets x_k @ W + (x_k @ A_k) @ B_k."""
    x32 = x.float()
    y = x32 @ w.float() + (x32 @ a.float()) @ b.float()
    return y.to(x.dtype)


def selective_scan_ref(da: torch.Tensor, dbx: torch.Tensor,
                       h0: torch.Tensor) -> tuple:
    """Diagonal recurrence h_t = da_t * h_{t-1} + dbx_t, a sequential loop
    over S in float32.  da, dbx: (B, S, C); h0: (B, C) -> (h_all (B, S, C),
    h_last (B, C)), both float32."""
    da32, dbx32 = da.float(), dbx.float()
    h = h0.float()
    h_all = torch.empty(da32.shape, dtype=torch.float32, device=da.device)
    for t in range(da32.shape[1]):
        h = da32[:, t] * h + dbx32[:, t]
        h_all[:, t] = h
    return h_all, h


def selective_scan_chunked_ref(da: torch.Tensor, dbx: torch.Tensor,
                               h0: torch.Tensor, chunk: int) -> tuple:
    """The recurrence as the chained design of ``csrc/selective_scan.cu``
    computes it at sub-chunks of ``chunk`` steps, step for step and
    rounding for rounding (float32, every product and sum rounded apart).
    S is cut into chunks of ``chunk`` steps; every chunk but the last
    composes its pair (A = prod da, b = its end state from 0); the pairs
    fold in order from h0 into each chunk's carry-in, carry_k = A_k *
    carry_{k-1} + b_k; then each chunk runs h = da * h + dbx from its
    carry-in, which is in exact arithmetic h_t = local_t + (prod of da up
    to t) * carry_in.  With chunk >= S it is ``selective_scan_ref``.  A
    twin for the tests; no path calls it."""
    da32, dbx32 = da.float(), dbx.float()
    s = da32.shape[1]
    carry = h0.float()
    carries = [carry]
    for t0 in range(0, s - chunk, chunk):           # every chunk but the last
        a_k = torch.ones_like(carry)
        b_k = torch.zeros_like(carry)
        for t in range(t0, t0 + chunk):
            b_k = da32[:, t] * b_k + dbx32[:, t]
            a_k = da32[:, t] * a_k
        carry = a_k * carry + b_k
        carries.append(carry)
    h_all = torch.empty(da32.shape, dtype=torch.float32, device=da.device)
    for k, h in enumerate(carries):
        for t in range(k * chunk, min(s, (k + 1) * chunk)):
            h = da32[:, t] * h + dbx32[:, t]
            h_all[:, t] = h
    return h_all, h


__all__ = ["decode_attention_ref", "flash_attention_ref", "mla_decode_ref",
           "mla_decode_pieces_ref", "cosine_gram_ref", "lora_matmul_ref",
           "selective_scan_ref", "selective_scan_chunked_ref"]
