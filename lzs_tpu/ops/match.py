"""Parallel LZS match search.

Computes, for every position i of a block, the reference-equivalent greedy
match decision (see lzs_tpu.spec for the policy statement, verified
byte-identical to the reference C encoders lzs-compression.c:326-362 and
lzs-compression-simple.c:266-278):

  score[i] = max over d in [1, min(i, window)] of min(runlen(i, d), 12)
  off[i]   = smallest d attaining the max (nearest-match tie-break)
  full[i]  = exact (uncapped) run length at (i, off[i])

The key insight making this parallel: runlen(i, d) — the number of
consecutive byte equalities x[i+k] == x[i+k-d] — equals
(first mismatch position >= i in column d) - i, which is a *reverse
cumulative min* along the position axis of per-cell mismatch positions.
One associative scan replaces the reference's sequential hash-chain walk,
and the whole (position x offset) plane is data-parallel.

The offset axis is processed in chunks so peak memory stays at
O(block * chunk) instead of O(block * window).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import spec

_BIG = 0x3FFFFFFF    # plain int: jnp scalars become captured jaxpr consts


def _chunk_scores(x: jnp.ndarray, n: jnp.ndarray, d0: int, dc: int,
                  window: int, cap: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best (packed key, full run length) over offsets [d0+1, d0+dc].

    Returns per-position arrays. Key packs (capped score, nearness) so a
    single max reduction implements the policy's tie-break:
        key = score * 2048 + (2048 - d)
    """
    npos = x.shape[0]
    i = jnp.arange(npos, dtype=jnp.int32)[:, None]            # (N, 1)
    d = (d0 + 1 + jnp.arange(dc, dtype=jnp.int32))[None, :]   # (1, dc)
    src = i - d
    hist = jnp.where(src >= 0, x[jnp.clip(src, 0)], -1)
    valid = (src >= 0) & (i < n) & (d <= window) & (x[:, None] == hist)
    # first-mismatch position at-or-after i, per column: reverse cummin
    mm_pos = jnp.where(valid, _BIG, i)
    nm = jnp.flip(jax.lax.cummin(jnp.flip(mm_pos, 0), axis=0), 0)
    # clamp to block end: with no sentinel row past N, a run matching
    # through the final row would otherwise read as unbounded
    runlen = jnp.minimum(nm - i, n - i)                       # exact, >= 0
    score = jnp.minimum(runlen, cap)
    key = score * 2048 + (2048 - d)                           # unique per d
    col = jnp.argmax(key, axis=1)
    best_key = jnp.take_along_axis(key, col[:, None], axis=1)[:, 0]
    best_full = jnp.take_along_axis(runlen, col[:, None], axis=1)[:, 0]
    return best_key, best_full


@functools.partial(jax.jit, static_argnames=("window", "cap", "chunk"))
def best_matches(x: jnp.ndarray, n: jnp.ndarray, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX,
                 chunk: int = 256):
    """Per-position best-match table for one block.

    Args:
      x: int32[N] byte values of the block (padding beyond ``n`` ignored).
      n: int32 scalar, true length.
      window: sliding-window size (2047 for standard LZS).
      cap: search cap for match selection (12 for reference parity).
      chunk: offsets processed per fold step.

    Returns:
      (score, off, full): int32[N] each. ``score`` is the capped selection
      score (match iff >= MIN_MATCH), ``off`` the chosen offset, ``full``
      the exact run length of the chosen offset.
    """
    x = x.astype(jnp.int32)
    nchunks = -(-window // chunk)

    def fold(carry, d0):
        best_key, best_full = carry
        key, full = _chunk_scores(x, n, d0, chunk, window, cap)
        upd = key > best_key
        return (jnp.where(upd, key, best_key),
                jnp.where(upd, full, best_full)), None

    init = (jnp.full(x.shape, -1, jnp.int32), jnp.zeros(x.shape, jnp.int32))
    d0s = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    (best_key, best_full), _ = jax.lax.scan(fold, init, d0s)
    score = best_key // 2048
    off = 2048 - (best_key - score * 2048)
    return score, off, best_full
