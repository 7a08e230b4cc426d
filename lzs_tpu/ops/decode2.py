"""Sync-parallel LZS decode (the container fast path).

The bit-serial token parse is the sequential core of LZS decode
(lzs-decompression.c:459-743). The container format sidesteps it: the
encoder records parser state at the last parse point before every multiple
of ``span`` compressed bits (encode.encode_block_sync), so lane l of the
decoder owns the statically located bit range [span*l - 24, span*(l+1))
— its word fetches stay inside a per-lane tile of span/32 + 2 words that
is carved out of the stream with *reshapes only*.

The parse is a WORD-FED scan: step s feeds every lane column s of its own
tile simultaneously (a static slice — no gather, no one-hot fetch), and
the lane keeps the last two words as a 64-bit register. Up to four tokens
are parsed per fed word (4 is exact: the densest legal token packing is
the 17-bit pair "13-bit extended-match head + 4-bit terminating nibble",
so at most 4 token starts fall in any 32-bit window). A parse substep
consumes either one token head (<= 17 bits) or a run of up to 6 extension
nibbles (<= 24 bits), mirroring the incremental decoder's states
(lzs-decompression.c:505-739) with the nibble loop batched.

Each parsed token becomes ONE packed int32 record (opos<<13 | is_copy<<11
| payload); zero-length tokens are suppressed so records have strictly
increasing output positions in lane-major order, the form the copy
expansion (ops.expand) turns into bytes by pointer doubling.

Raw streams without sync metadata use ops.decode (the bit-parallel
decoder, or the bit-serial scan that mirrors the reference's state
machine, corrupt-input semantics included).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import spec
from . import encode as enc
from . import expand


_SUBSTEPS = 4         # tokens parseable per fed 32-bit word (see docstring)
_BIG = 0x3FFFFFFF    # plain int: jnp scalars become captured jaxpr consts


def _lane_tiles(comp: jnp.ndarray, nslots: int, span: int) -> jnp.ndarray:
    """Carve per-lane word tiles out of the stream with reshapes only.

    comp: uint8[C]. Returns int32[nslots, wpl + 2] where
    tile[l, s] = word[wpl*l - 1 + s] (big-endian 32-bit words of the
    padded stream; out-of-range words are zero).
    """
    wpl = span // 32
    nwords = nslots * wpl
    b = comp.astype(jnp.int32)
    need = nwords * 4
    if b.shape[0] < need:
        b = jnp.concatenate([b, jnp.zeros(need - b.shape[0], jnp.int32)])
    else:
        b = b[:need]
    b = b.reshape(nwords, 4)
    w = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    cur = w.reshape(nslots, wpl)
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), w[:-1]])
    col0 = prev.reshape(nslots, wpl)[:, :1]
    nxt = jnp.concatenate([cur[1:, :1], jnp.zeros((1, 1), jnp.int32)])
    return jnp.concatenate([col0, cur, nxt], axis=1)      # [L, wpl + 2]


def _parse_substep(w, bitpos, outpos, mode, cur_off, can):
    """Decode one token at the top 24 bits of ``w`` for lanes where ``can``.

    Returns (record, bitpos, outpos, mode, cur_off); record = -1 where
    nothing was parsed or the token has zero output length.
    """
    wu = w.astype(jnp.uint32)

    # --- NORMAL: one token head (lzs-decompression.c:214-343) ---
    flag = (wu >> 31).astype(jnp.int32)
    lit = ((wu >> 23) & 0xFF).astype(jnp.int32)
    offflag = ((wu >> 30) & 1).astype(jnp.int32)
    off7 = ((wu >> 23) & 0x7F).astype(jnp.int32)
    off11 = ((wu >> 19) & 0x7FF).astype(jnp.int32)
    l4 = jnp.where(offflag == 1,
                   ((wu >> 19) & 0xF).astype(jnp.int32),
                   ((wu >> 15) & 0xF).astype(jnp.int32))
    long_len = (l4 >> 2) == 3
    len_init = jnp.where(long_len, (l4 & 3) + 5, (l4 >> 2) + 2)
    lw = jnp.where(long_len, 4, 2)
    is_lit = flag == 0
    n_off = jnp.where(offflag == 1, off7, off11)
    n_len = jnp.where(is_lit, 1, len_init)
    n_consume = jnp.where(is_lit, 9,
                          1 + jnp.where(offflag == 1, 8, 12) + lw)
    n_mode = jnp.where((~is_lit) & long_len & ((l4 & 3) == 3), 1, 0)

    # --- EXTENDED: up to 6 nibbles (24 valid bits) in one substep
    #     (lzs-decompression.c:713-730, batched) ---
    nw = (~wu | jnp.uint32(0xFF)).astype(jnp.uint32)
    lzn = jax.lax.clz(nw)
    nf = jnp.minimum((lzn >> 2).astype(jnp.int32), 6)
    whole = nf >= 6
    term = (wu >> (jnp.uint32(28) - 4 * jnp.minimum(
        nf, 5).astype(jnp.uint32))) & 0xF
    e_len = jnp.where(whole, 6 * spec.MAX_EXTENDED_LENGTH,
                      spec.MAX_EXTENDED_LENGTH * nf
                      + term.astype(jnp.int32))
    e_consume = jnp.where(whole, 24, 4 * (nf + 1))
    e_mode = jnp.where(whole, 1, 0)

    is_ext = mode == 1
    is_copy = is_ext | ~is_lit
    payload = jnp.where(is_ext, cur_off, jnp.where(is_lit, lit, n_off))
    length = jnp.where(is_ext, e_len, n_len)
    consume = jnp.where(is_ext, e_consume, n_consume)
    rec = jnp.where(can & (length > 0),
                    (outpos << 13) | (is_copy.astype(jnp.int32) << 11)
                    | payload, -1)
    bitpos = bitpos + jnp.where(can, consume, 0)
    outpos = outpos + jnp.where(can, length, 0)
    mode = jnp.where(can, jnp.where(is_ext, e_mode, n_mode), mode)
    cur_off = jnp.where(can & ~is_ext & ~is_lit, n_off, cur_off)
    return rec, bitpos, outpos, mode, cur_off


def _parse_full(comp: jnp.ndarray, sync_bit: jnp.ndarray,
                sync_out: jnp.ndarray, span: int):
    """Lane-parallel token parse of one block's stream.

    comp: uint8[C]; sync_bit: int32[L] record bit offsets (slot l is the
    last parse point before bit span*l; sentinel-filled past nsync);
    sync_out: int32[L] packed records — output offset (bits 0..16) |
    mode (bit 17) | current match offset (bits 18..28).

    Returns (recs, out_final): recs int32[(wpl + 2) * _SUBSTEPS, L]
    packed token records in step order (lane-major transpose gives
    records sorted by output position): opos << 13 | is_copy << 11 |
    payload, or -1 for empty slots; out_final int32[L] is each lane's
    final output position (an integrity signal: it must equal the next
    lane's starting offset).
    """
    nslots = sync_bit.shape[0]
    wpl = span // 32
    tile = _lane_tiles(comp, nslots, span)               # [L, wpl+2]
    end_bit = jnp.concatenate([sync_bit[1:], sync_bit[-1:]])
    lane_word0 = jnp.arange(nslots, dtype=jnp.int32) * wpl - 1

    def step(state, inp):
        word, s = inp
        hi, lo, bitpos, outpos, mode, cur_off = state
        hi, lo = lo, word
        ebits = (lane_word0 + s + 1) * 32    # bits fed so far (exclusive)
        recs = []
        for _ in range(_SUBSTEPS):
            sh = jnp.clip(bitpos - (ebits - 64), 0, 63).astype(jnp.uint32)
            hu = hi.astype(jnp.uint32)
            lu = lo.astype(jnp.uint32)
            w = jnp.where(
                sh < 32,
                (hu << sh) | jnp.where(sh == 0, jnp.uint32(0),
                                       lu >> (jnp.uint32(32) - sh)),
                lu << (sh - 32))
            can = (bitpos < end_bit) & (bitpos + enc.MAX_STEP_BITS <= ebits)
            rec, bitpos, outpos, mode, cur_off = _parse_substep(
                w, bitpos, outpos, mode, cur_off, can)
            recs.append(rec)
        return (hi, lo, bitpos, outpos, mode, cur_off), jnp.stack(recs)

    zero = jnp.zeros(nslots, jnp.int32)
    init = (zero, zero, sync_bit, sync_out & 0x1FFFF,
            (sync_out >> 17) & 1, sync_out >> 18)
    steps = jnp.arange(wpl + 2, dtype=jnp.int32)
    state, recs = jax.lax.scan(step, init, (tile.T, steps))
    return recs.reshape((wpl + 2) * _SUBSTEPS, nslots), state[3]


def _parse(comp: jnp.ndarray, sync_bit: jnp.ndarray, sync_out: jnp.ndarray,
           span: int) -> jnp.ndarray:
    """Lane-parallel token parse; records only (see _parse_full)."""
    return _parse_full(comp, sync_bit, sync_out, span)[0]


@functools.partial(jax.jit, static_argnames=("out_cap", "span"))
def decode_block_sync(comp: jnp.ndarray, sync_bit: jnp.ndarray,
                      sync_out: jnp.ndarray, n: jnp.ndarray, *,
                      out_cap: int, span: int = enc.SYNC_SPAN):
    """Decode one container block with sync metadata.

    Args:
      comp: uint8[C] compressed payload.
      sync_bit/sync_out: int32[I] sync records from encode_block_sync.
      n: int32 scalar decoded length.
      out_cap: static output capacity (the block size).

    Returns uint8[out_cap] (bytes past ``n`` are zero).
    """
    out, _ = decode_batch_sync(comp[None], sync_bit[None], sync_out[None],
                               n[None], out_cap=out_cap, span=span)
    return out[0]


@functools.partial(jax.jit, static_argnames=("out_cap", "span"))
def decode_batch_sync(comp: jnp.ndarray, sync_bit: jnp.ndarray,
                      sync_out: jnp.ndarray, n: jnp.ndarray, *,
                      out_cap: int, span: int = enc.SYNC_SPAN):
    """Batched sync-parallel decode with per-block status words.

    Args:
      comp: uint8[B, C]; sync_bit/sync_out: int32[B, I]; n: int32[B].
      out_cap: static output capacity (the block size).

    Returns (out uint8[B, out_cap], status int32[B]). Status is a
    bitmask in the spirit of LzsDecompressStatus_t (lzs.h:170-178):
      bit 0  a byte inside [0, n) had no covering token
      bit 1  a copy source fell before the block start (zero-filled)
      bit 2  a parse lane's final output position disagrees with the
             next lane's sync record (corrupt stream or records)
    0 means the block decoded cleanly.
    """
    recs, out_final = jax.vmap(
        lambda c, sb, so: _parse_full(c, sb, so, span))(
        comp.astype(jnp.int32), sync_bit, sync_out)
    # lane-major order: records sorted by output position
    lane_major = jnp.swapaxes(recs, 1, 2).reshape(recs.shape[0], -1)
    out, status = expand.expand_records(lane_major, n, out_cap)

    # lane-boundary integrity: lane l parses bits [sync_bit[l],
    # sync_bit[l+1]) and must land exactly on lane l+1's output offset;
    # the last active lane (and every sentinel) must land on n
    nxt = jnp.concatenate(
        [sync_out[:, 1:] & 0x1FFFF, n[:, None]], axis=1)
    bad = jnp.any(out_final != nxt, axis=1)
    status = status | (bad.astype(jnp.int32) << 2)
    return out.astype(jnp.uint8), status


def make_decoder_sync(in_cap: int, out_cap: int, *,
                      span: int = enc.SYNC_SPAN):
    """Jitted batch decoder over container blocks with sync records.

    Returns bytes only (see decode_batch_sync for the status variant).
    """
    del in_cap

    def fn(comp, sync_bit, sync_out, n):
        return decode_batch_sync(comp, sync_bit, sync_out, n,
                                 out_cap=out_cap, span=span)[0]

    return fn
