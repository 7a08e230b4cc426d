"""Greedy token-chain resolution and per-position emission units.

The greedy LZS tokenization is a chain: each token's start depends on the
previous token's length (the reference walks it as a state machine,
lzs-compression.c:301-448). Token starts are resolved in three
logarithmic stages instead of a position-by-position walk:

  1. In-tile pointer doubling: within tiles of ``_TILE`` positions, jump
     tables A_t[i] = position after 2^t token hops from i (frozen at the
     first position past the tile). log2(_TILE) gather rounds.
  2. A tile-granular ``lax.scan`` threads the single sequential
     dependency: the entry position of tile t+1 is the exit of the chain
     from tile t's entry (one tiny gather per step).
  3. Descent marking: every position i binary-searches down the jump
     tables from its tile's entry; i is a token start iff the chain's
     last position <= i is i itself.

Emission units: every token start carries its head unit (flag + literal, or
flag + offset + initial length code, <= 18 bits). Extension nibbles of a long
match (lzs-compression.c:417-431) are attributed to positions *inside* the
match (position start+1+t carries nibble t), so every position emits at most
one bounded-width unit and bit offsets become a single prefix sum. Ownership
(which token a position lies in) is propagated gather-free: a packed
``cummax`` carries (start index, is_match) forward, and a reverse ``cummin``
of start indices gives each token's end, hence its length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import spec

_TILE = 128
_BIG = 0x3FFFFFFF    # plain int: jnp scalars become captured jaxpr consts


def token_starts(step: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """bool[N]: True at greedy token start positions.

    step: int32[N] bytes consumed by a token starting at each position
    (>= 1 wherever i < n).
    """
    npos = step.shape[0]
    pad = (-npos) % _TILE
    if pad:
        step = jnp.concatenate([step, jnp.ones(pad, step.dtype)])
    m = step.shape[0]
    ntiles = m // _TILE
    rounds = _TILE.bit_length() - 1
    i = jnp.arange(m, dtype=jnp.int32)
    base = (jnp.arange(ntiles, dtype=jnp.int32) * _TILE)[:, None]

    # 1. in-tile jump tables by pointer doubling (frozen once past tile)
    a = (i + jnp.maximum(step, 1)).reshape(ntiles, _TILE)
    tables = [a]
    for _ in range(rounds):
        g = jnp.take_along_axis(a, jnp.clip(a - base, 0, _TILE - 1), axis=1)
        a = jnp.where(a < base + _TILE, g, a)
        tables.append(a)
    exits = a                     # first chain position >= tile end

    # 2. entry of each tile: thread the chain exit tile by tile (the one
    # sequential dependency: ntiles steps of one scalar fetch each)
    def entry_step(c, inp):
        ex, b0 = inp
        inside = (c >= b0) & (c < b0 + _TILE)
        nxt = ex[jnp.clip(c - b0, 0, _TILE - 1)]
        return jnp.where(inside, nxt, c), c

    # step[0] * 0: the carry must inherit the varying manual axes of the
    # data under shard_map (a bare jnp.int32(0) mistypes the scan)
    _, entries = jax.lax.scan(entry_step, step[0] * 0,
                              (exits, base[:, 0]))

    # 3. descent: last chain position <= i, from the tile entry down
    pos = jnp.broadcast_to(entries[:, None], (ntiles, _TILE))
    it = i.reshape(ntiles, _TILE)
    for t in range(rounds - 1, -1, -1):
        nxt = jnp.take_along_axis(tables[t],
                                  jnp.clip(pos - base, 0, _TILE - 1), axis=1)
        ok = (pos >= base) & (pos < base + _TILE) & (nxt <= it)
        pos = jnp.where(ok, nxt, pos)
    starts = (pos == it).reshape(-1)[:npos]
    return starts & (jnp.arange(npos, dtype=jnp.int32) < n)


@jax.jit
def emission_units(x: jnp.ndarray, n: jnp.ndarray, score: jnp.ndarray,
                   off: jnp.ndarray, full: jnp.ndarray):
    """Per-position emission units for the bit packer.

    Returns (value, width, starts, length):
      value, width: int32[N]; width 0 means the position emits nothing.
      starts: bool[N] token-start flags; length: int32[N] token length at
      starts (1 for literals).
    """
    npos = x.shape[0]
    i = jnp.arange(npos, dtype=jnp.int32)
    is_match = (score >= spec.MIN_MATCH) & (i < n)
    length = jnp.where(is_match, full, 1)
    starts = token_starts(jnp.where(i < n, length, 1), n)

    # --- head units at token starts ---
    # Length code by arithmetic: initial 2,3,4 -> 0b00,0b01,0b10 (2
    # bits); 5,6,7 -> 0b1100..0b1110 and 8 -> 0b1111 (4 bits).
    # lzs-compression.c:91-124.
    initial = jnp.clip(jnp.minimum(length, spec.MAX_SHORT_LENGTH), 2, 8)
    short_code = initial < 5
    lv = jnp.where(short_code, initial - 2, initial + 7)
    lw = jnp.where(short_code, 2, 4)
    short = off <= spec.SHORT_OFFSET_MAX
    off_field = jnp.where(short, (1 << spec.SHORT_OFFSET_BITS) | off, off)
    off_width = jnp.where(short, 1 + spec.SHORT_OFFSET_BITS,
                          1 + spec.LONG_OFFSET_BITS)
    match_v = ((((jnp.int32(1) << off_width) | off_field) << lw) | lv)
    match_w = 1 + off_width + lw
    head_v = jnp.where(is_match, match_v, x.astype(jnp.int32))
    head_w = jnp.where(is_match, match_w, 9)

    # --- gather-free ownership propagation ---
    key = jnp.where(starts, (i << 1) | is_match.astype(jnp.int32), -1)
    ck = jax.lax.cummax(key)
    owner = ck >> 1
    own_match = (ck & 1) == 1
    nstart = jnp.where(starts, i, _BIG)
    rc = jax.lax.cummin(nstart, reverse=True)           # next start >= j
    own_len = jnp.minimum(rc, n) - owner                # token length at j

    # --- extension nibbles attributed to in-match positions ---
    t = i - owner - 1
    rest = own_len - spec.MAX_SHORT_LENGTH
    q = jnp.maximum(rest, 0) // spec.MAX_EXTENDED_LENGTH
    is_nib = ((~starts) & (owner >= 0) & own_match
              & (own_len >= spec.MAX_SHORT_LENGTH)
              & (t < q + 1) & (i < n))
    nib_v = jnp.where(t < q, spec.MAX_EXTENDED_LENGTH,
                      rest - q * spec.MAX_EXTENDED_LENGTH)

    value = jnp.where(starts, head_v, jnp.where(is_nib, nib_v, 0))
    width = jnp.where(starts, head_w, jnp.where(is_nib, 4, 0))
    return value, width, starts, length
