"""Sort-based LZS match search (the fast path).

Computes the same per-position greedy match decision as
``lzs_tpu.ops.match.best_matches`` (the exhaustive reference kernel) —
the policy pinned byte-identical to the reference C encoders
(lzs-compression.c:326-362, lzs-compression-simple.c:266-278; see
lzs_tpu.spec) — in O(N log N) sort work:

  score[i] = max k in [2, cap] such that the k-gram at i occurs at some
             j in [i - window, i - 1]             (capped greedy score)
  off[i]   = i - j* where j* is the *nearest* such occurrence for k = score
  full[i]  = exact run length of the chosen offset (= score when score < cap)

Structure (one suffix-style sort, then one cheap packed sort per k):

  1. ONE sort of all positions by their cap-byte gram (packed into 32-bit
     big-endian words; position as the final key). Byte-level LCPs of
     rank-adjacent elements (``plcp``) then identify, for every k, the
     "k-segments": maximal rank runs sharing a k-byte prefix (the min-LCP
     interval property of lexicographic order).
  2. Per k: each element's k-segment head is a running max of segment
     breaks (one cummax), and one SINGLE-OPERAND sort of seg<<15|pos
     orders each segment by position — the sorted predecessor is exactly
     the nearest previous occurrence of the k-gram. A second
     single-operand sort of pos<<16|cand restores position order.

  Single-operand sorts of packed int32 keys are the cheapest sorts XLA
  offers, so deriving the 11 per-k orders from packed keys costs a
  fraction of sorting per-k gram keys directly. Every key packs the
  position, making the order unique, so stability is never needed.

Correctness notes:
  * The nearest previous occurrence is global; if it is farther than
    ``window``, no closer one exists, so the window test on the sorted
    predecessor alone is exact.
  * No validity masking is needed anywhere: an element e whose gram
    overruns the data (e + k > n) satisfies e > n - k >= q for every
    valid query position q (q + k <= n), so e sorts after all valid
    queries inside any segment and can never be a predecessor; invalid
    *queries* are masked out of the final reduction only.

Extension beyond the capped score (the COMPRESS_EXTENDED re-measure loop,
lzs-compression.c:417-431): run ends pin most capped heads arithmetically
for ANY offset (see best_matches — runlen decrements by one along a
diagonal, and only stolen or data-end runs stay unknown); the remaining
heads fetch one 48-byte span per side with a gather and count leading
equal bytes elementwise; runs past the span close with one
diagonal-run column per distinct offset (reverse cumulative min).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import spec

_BIG = 0x3FFFFFFF    # plain int: jnp scalars become captured jaxpr consts


def _shift(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """x[i + s] with zero padding at the end (last axis)."""
    if s == 0:
        return x
    pad = jnp.zeros(x.shape[:-1] + (s,), x.dtype)
    return jnp.concatenate([x[..., s:], pad], axis=-1)


def _gram_words(x: jnp.ndarray, nwords: int) -> list[jnp.ndarray]:
    """Big-endian 4-byte gram words starting at each position.

    x: int32[N] byte values. Returns nwords uint32[N] arrays; word w holds
    bytes [4w, 4w+4) of the gram (zeros past the array end).
    """
    words = []
    for w in range(nwords):
        g = jnp.zeros(x.shape, jnp.uint32)
        for t in range(4):
            g = (g << 8) | _shift(x, 4 * w + t).astype(jnp.uint32)
        words.append(g)
    return words


def _rank_lcp(words: list[jnp.ndarray], cap: int) -> jnp.ndarray:
    """Byte LCP (capped at cap) of rank-adjacent gram words.

    words: sorted uint32 gram-word columns. Returns int32[N] with entry r =
    LCP(element r-1, element r); entry 0 is 0.
    """
    n = words[0].shape[0]
    lcp = jnp.full(n, cap, jnp.int32)
    consumed = jnp.zeros(n, jnp.bool_)
    for w, col in enumerate(words):
        prev = jnp.concatenate([~col[:1], col[:-1]])   # differ at rank 0
        z = col ^ prev
        here = 4 * w + (jax.lax.clz(z) >> 3).astype(jnp.int32)
        differs = z != 0
        lcp = jnp.where(differs & ~consumed, jnp.minimum(here, cap), lcp)
        consumed = consumed | differs
    return lcp


def candidates(x: jnp.ndarray, n: jnp.ndarray, *,
               window: int = spec.WINDOW_SIZE,
               cap: int = spec.SEARCH_MATCH_MAX):
    """Per-position greedy (score, off) for one block.

    x: int32[N] byte values (zeros past ``n``); N <= 32768.
    Returns (score, off): int32[N] each (off = 0 where no match).
    """
    npos = x.shape[0]
    assert npos <= 1 << 15, "match search supports blocks up to 32768"
    assert spec.MIN_MATCH <= cap <= 16
    x = x.astype(jnp.int32)
    i = jnp.arange(npos, dtype=jnp.int32)
    nwords = -(-cap // 4)

    words = _gram_words(x, nwords)
    # is_stable=False everywhere in this module: every key includes the
    # position, so the total order is unique and stability is pure cost.
    out = jax.lax.sort(tuple(words) + (i,), dimension=0,
                       num_keys=nwords + 1, is_stable=False)
    swords, p = list(out[:nwords]), out[-1]
    plcp = _rank_lcp(swords, cap)
    r = jnp.arange(npos, dtype=jnp.int32)

    score = jnp.zeros(npos, jnp.int32)
    off = jnp.zeros(npos, jnp.int32)
    for k in range(spec.MIN_MATCH, cap + 1):
        seg = jax.lax.cummax(jnp.where(plcp < k, r, 0))
        packed = (seg << 15) | p
        skey = jax.lax.sort(packed, is_stable=False)
        prev = jnp.concatenate([jnp.full(1, -1, jnp.int32), skey[:-1]])
        mypos = skey & 0x7FFF
        prevpos = prev & 0x7FFF
        same = (skey >> 15) == (prev >> 15)
        cand = jnp.where(same & (mypos - prevpos <= window), prevpos, -1)
        back = jax.lax.sort((mypos << 16) | (cand + 1), is_stable=False)
        cand_k = (back & 0xFFFF) - 1
        hit = (cand_k >= 0) & (i + k <= n)
        score = jnp.where(hit, k, score)
        off = jnp.where(hit, i - cand_k, off)
    return score, off


_PROBE_CAP = 1024     # compacted probe lanes per wave (structured data
                      # produces ~700 steal heads per 32K block; one wave
                      # must usually cover them all)
_T1_WORDS = 12        # tier-1 compare span: 12 words = 48 bytes (probe
                      # extensions measure p99.9 = 25 B / max 44 B on
                      # the bench corpus; longer runs close in tier 2)


def _probe_extension(x: jnp.ndarray, n: jnp.ndarray, base: jnp.ndarray,
                     doff: jnp.ndarray, active: jnp.ndarray) -> jnp.ndarray:
    """Exact run extension for far offsets: length of the maximal run of
    x[a + t] == x[a + t - doff] (t >= 0) at a = base, for active lanes.

    Active lanes are first *compacted* (one cheap sort) into waves of
    _PROBE_CAP lanes. Tier 1 gathers a 48-byte span from each side
    (probe extensions are short: p99.9 = 25 bytes on the bench corpus)
    and counts leading equal bytes elementwise. Tier 2: survivors (runs
    past the span) are grouped by *distinct offset* and each group is
    closed with one elementwise diagonal-run column (reverse cumulative
    min) — linear total work even for very long periodic matches.
    """
    npos = x.shape[0]
    cap = min(_PROBE_CAP, npos)
    nwords = npos // 4 + _T1_WORDS + 2
    xe = jnp.concatenate(
        [x, jnp.zeros(nwords * 4 - npos, jnp.int32)]).reshape(nwords, 4)
    wtab = ((xe[:, 0] << 24) | (xe[:, 1] << 16) | (xe[:, 2] << 8)
            | xe[:, 3])
    j = jnp.arange(npos, dtype=jnp.int32)
    span = jnp.arange(_T1_WORDS + 1, dtype=jnp.int32)

    def aligned_span(start):
        """(cap,) byte positions -> (cap, _T1_WORDS) big-endian words of
        x[start ..], bit-aligned to the byte."""
        w = wtab[(start >> 2)[:, None] + span]
        sh = ((start & 3) * 8).astype(jnp.uint32)[:, None]
        hi = w[:, :-1].astype(jnp.uint32)
        lo = w[:, 1:].astype(jnp.uint32)
        return jnp.where(sh == 0, hi, (hi << sh) | (lo >> (32 - sh)))

    def wave(state):
        remaining, ln = state
        # compact: indices of up to `cap` active lanes (single-word sort)
        key = jnp.where(remaining, j, npos + j)
        idx = jax.lax.sort(key, is_stable=False)[:cap] % npos
        lanes = remaining[idx]                     # False once exhausted
        cbase = base[idx]
        cdoff = jnp.maximum(doff[idx], 1)

        a = jnp.clip(cbase, 0, npos - 1)
        aw = aligned_span(a)
        bw = aligned_span(a - jnp.minimum(cdoff, a))
        xor = (aw ^ bw).astype(jnp.uint32)
        lew = jnp.where(xor == 0, 32, jax.lax.clz(xor)).astype(
            jnp.int32) >> 3
        opn = jnp.concatenate(
            [jnp.ones((cap, 1), jnp.bool_),
             jax.lax.cummin(lew, axis=1)[:, :-1] >= 4], axis=1)
        ext = jnp.sum(jnp.where(opn, lew, 0), axis=1)
        full_span = ext >= 4 * _T1_WORDS
        ext = jnp.minimum(ext, jnp.maximum(n - cbase, 0))
        cln = jnp.where(lanes, ext, 0)
        act = lanes & full_span & (cbase + ext < n)

        # tier 2: close long runs by distinct offset, one column at a time
        def t2_body(state2):
            act2, cln2 = state2
            d0 = jnp.min(jnp.where(act2, cdoff, _BIG))
            prev = jnp.where(j >= d0, jnp.roll(x, d0), -1)
            eq = (x == prev) & (j < n)
            mm = jnp.where(eq, _BIG, j)
            rm = jax.lax.cummin(mm, reverse=True)
            col = jnp.maximum(jnp.minimum(rm, n) - j, 0)
            mine = act2 & (cdoff == d0)
            cln2 = jnp.where(mine, col[jnp.clip(cbase, 0, npos - 1)], cln2)
            return act2 & ~mine, cln2

        _, cln = jax.lax.while_loop(lambda s: jnp.any(s[0]), t2_body,
                                    (act, cln))
        ln = ln.at[idx].add(jnp.where(lanes, cln, 0), mode="drop")
        # the wave took the first `cap` active positions in index order,
        # so clearing them is rank arithmetic, not a scatter
        rank = jnp.cumsum(remaining.astype(jnp.int32)) - 1
        remaining = remaining & (rank >= cap)
        return remaining, ln

    _, length = jax.lax.while_loop(
        lambda s: jnp.any(s[0]), wave,
        (active, doff * 0))   # varying-axes-preserving zeros (see above)
    return length


def small_extension(x: jnp.ndarray, n: jnp.ndarray, score: jnp.ndarray,
                    off: jnp.ndarray, cap: int):
    """(full, capped): full = score where exact; ``capped`` marks the
    positions whose run extends past the capped score (score == cap with
    room left in the data) — there full holds the lower bound ``cap``
    and best_matches resolves the rest via run ends / probes.

    The run-end argument in best_matches is offset-agnostic and
    resolves these positions arithmetically (an RLE d=1 run can never
    be stolen at all; steals need a strictly nearer offset).
    """
    del x
    npos = score.shape[0]
    i = jnp.arange(npos, dtype=jnp.int32)
    capped = (score >= cap) & (i + cap < n)
    return score, capped


@functools.partial(jax.jit, static_argnames=("window", "cap", "chunk"))
def best_matches(x: jnp.ndarray, n: jnp.ndarray, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX,
                 chunk: int = 4096):
    """Drop-in replacement for ``match.best_matches`` (sort-based).

    Args:
      x: int32[N] byte values of one block (padding beyond ``n`` ignored).
      n: int32 scalar true length.
      window / cap: LZS search parameters (2047 / 12 for reference parity).
      chunk: unused (kept for call compatibility; the search is whole-block).

    Returns:
      (score, off, full): int32[N] each, as match.best_matches.
    """
    del chunk
    x = x.astype(jnp.int32)
    score, off = candidates(x, n, window=window, cap=cap)
    return (score, off) + (_extend(x, n, score, off, cap),)


@functools.partial(jax.jit, static_argnames=("window", "cap"))
def best_matches_batch(x: jnp.ndarray, n: jnp.ndarray, *,
                       window: int = spec.WINDOW_SIZE,
                       cap: int = spec.SEARCH_MATCH_MAX):
    """Batched best_matches: int32[B, N] x, int32[B] n -> (score, off,
    full) int32[B, N] each."""
    x = x.astype(jnp.int32)
    score, off = jax.vmap(functools.partial(
        candidates, window=window, cap=cap))(x, n)
    full = jax.vmap(functools.partial(_extend, cap=cap))(x, n, score, off)
    return score, off, full


def _extend(x, n, score, off, cap):
    """Uncapped run length at the chosen offset for capped positions."""
    npos = x.shape[0]
    i = jnp.arange(npos, dtype=jnp.int32)
    full, capped = small_extension(x, n, score, off, cap)

    # Far-offset extension at *region heads*: consecutive capped positions
    # with the same offset d satisfy runlen(i+1, d) = runlen(i, d) - 1
    # (the run loses its first byte), so one value per maximal same-d run
    # serves the whole run by subtraction. Moreover, the run END usually
    # pins that value with NO probe at all: if the run of m same-(cap, d)
    # positions ends at e = i + m because score(e) < cap or off(e) > d,
    # then runlen(e, d) < cap (off is the *minimum* capped offset), and
    # since runlen decrements by exactly 1 along the diagonal,
    # runlen(e-1, d) = cap exactly, hence runlen(i, d) = cap + m - 1.
    # Probes are needed only when (a) the run was *stolen* by a strictly
    # nearer capped offset (off(e) < d, where runlen(e, d) stays unknown)
    # or (b) the run touches the data end (e + cap > n). Both are rare,
    # which keeps the probe loop to a handful of compacted lanes.
    prev_c = jnp.concatenate([jnp.zeros(1, jnp.bool_), capped[:-1]])
    prev_o = jnp.concatenate([jnp.zeros(1, jnp.int32), off[:-1]])
    head = capped & (~prev_c | (off != prev_o))

    brk = head | ~capped
    is_cap_score = score >= cap
    binfo = jnp.where(brk,
                      (i << 13) | (is_cap_score.astype(jnp.int32) << 12)
                      | jnp.clip(off, 0, 0x7FF),
                      _BIG)
    rcm = jax.lax.cummin(binfo, reverse=True)           # next break >= j
    nxt1 = jnp.concatenate([rcm[1:], jnp.full(1, _BIG, jnp.int32)])
    has_brk = nxt1 < _BIG
    e = jnp.where(has_brk, nxt1 >> 13, npos)
    steal = has_brk & (((nxt1 >> 12) & 1) == 1) & ((nxt1 & 0x7FF) < off)
    # e + cap >= n: membership in the run requires e + cap < n strictly,
    # so a break at e + cap == n says nothing about runlen(e, d) — probe.
    need_probe = head & ((e + cap >= n) | steal)
    ext_res = e - i - 1
    ext_p = _probe_extension(x, n, i + cap, off, need_probe)
    ext_h = jnp.where(need_probe, ext_p, ext_res)

    pk = jax.lax.cummax(
        jnp.where(head, (i << 16) | jnp.minimum(cap + ext_h, 0xFFFF), -1))
    hfull = pk & 0xFFFF
    hpos = pk >> 16
    full = jnp.where(capped, hfull - (i - hpos), full)
    return full
