"""LZS decode pipeline: bit-serial token parse + parallel copy expansion.

Stage 1 (parse) is inherently sequential within a stream (token boundaries
are data-dependent), so it is a tight `lax.scan` with a tiny constant-work
body — and it vectorizes across blocks under vmap, which is where decode
throughput comes from (SURVEY.md section 7 step 4). The scan mirrors the
reference incremental decoder's state machine (lzs-decompression.c:459-743)
collapsed to two states (normal/extended) plus a done flag, with the
per-field input-sufficiency gates of the single-call decoder
(lzs-decompression.c:214-343).

Stage 2 (expansion) resolves LZ77 copies — including overlapping RLE chains
(offset < length) — by pointer doubling over output positions: each copy
byte points at its source byte, literals are fixed points, and log2(N)
gather rounds land every byte on its originating literal. Out-of-range
back-references resolve to pointer -1 and produce zero bytes, reproducing
the reference's information-leak guard (lzs-decompression.c:348-357).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import spec
from . import expand
from .bitpack import read_window


def _bits(w: jnp.ndarray, start: int, count: int) -> jnp.ndarray:
    return ((w >> jnp.uint32(32 - start - count))
            & jnp.uint32((1 << count) - 1)).astype(jnp.int32)


def default_max_units(out_cap: int) -> int:
    """Parse-step budget: every unit of a valid single stream produces at
    least one output byte, except one terminal zero-nibble per match token
    and the end marker."""
    return out_cap + out_cap // 2 + 8


def _parse_scan(comp: jnp.ndarray, inbytes: jnp.ndarray, *,
                out_cap: int, max_units: int | None = None,
                multi_stream: bool = False):
    """Bit-serial parse of one LZS stream (the sequential core).

    Returns per-unit arrays (kind, val, off, length, opos) plus
    (out_len, end_markers); kind 0 = none, 1 = literal, 2 = copy.
    """
    if max_units is None:
        max_units = default_max_units(out_cap)
    data = jnp.concatenate(
        [comp.astype(jnp.int32), jnp.zeros(4, jnp.int32)])
    inbits = inbytes.astype(jnp.int32) * 8

    def step(carry, _):
        bitpos, mode, cur_off, out_count, markers, done = carry
        rem = inbits - bitpos
        w = read_window(data, bitpos)

        flag = _bits(w, 0, 1)
        lit = _bits(w, 1, 8)
        offflag = _bits(w, 1, 1)
        off7 = _bits(w, 2, 7)
        off11 = _bits(w, 2, 11)
        l4 = jnp.where(offflag == 1, _bits(w, 9, 4), _bits(w, 13, 4))
        long_len = (l4 >> 2) == 3
        len_init = jnp.where(long_len, (l4 & 3) + 5, (l4 >> 2) + 2)
        lw = jnp.where(long_len, 4, 2)
        nib = _bits(w, 0, 4)

        is_ext = mode == 1
        # --- normal-mode branch resolution ---
        is_lit = (flag == 0)
        is_marker = (flag == 1) & (offflag == 1) & (off7 == 0)
        is_short = (flag == 1) & (offflag == 1) & (off7 != 0)
        need = jnp.where(is_lit, 9,
               jnp.where(is_marker, 9,
               jnp.where(is_short, 9 + lw, 13 + lw)))
        n_starved = rem < need
        n_consume = jnp.where(is_marker,
                              ((bitpos + 9 + 7) & ~7) - bitpos, need)
        n_kind = jnp.where(is_lit, 1, jnp.where(is_marker, 0, 2))
        n_off = jnp.where(is_short, off7, off11)
        n_len = jnp.where(is_lit, 1, jnp.where(is_marker, 0, len_init))
        n_mode = jnp.where((n_kind == 2)
                           & (len_init == spec.MAX_SHORT_LENGTH), 1, 0)
        n_done = is_marker & (not multi_stream)

        # --- extended-mode branch ---
        e_starved = rem < 4
        e_len = nib
        e_mode = jnp.where(nib == spec.MAX_EXTENDED_LENGTH, 1, 0)

        starved = jnp.where(is_ext, e_starved, n_starved)
        halt = done | starved
        kind = jnp.where(halt, 0, jnp.where(is_ext, 2, n_kind))
        off = jnp.where(is_ext, cur_off, n_off)
        length = jnp.where(kind == 0, 0,
                           jnp.where(is_ext, e_len, n_len))
        length = jnp.minimum(length, out_cap - out_count)
        val = lit
        consume = jnp.where(halt, 0, jnp.where(is_ext, 4, n_consume))
        new_mode = jnp.where(halt, mode, jnp.where(is_ext, e_mode, n_mode))
        new_off = jnp.where((kind == 2) & ~is_ext, n_off, cur_off)
        new_markers = markers + jnp.where(halt | ~is_marker | is_ext, 0, 1)
        new_done = halt | (~is_ext & n_done & ~done)
        new_count = out_count + length
        new_done = new_done | (new_count >= out_cap)
        carry = (bitpos + consume, new_mode, new_off, new_count,
                 new_markers, new_done)
        return carry, (kind, val, off, length, out_count)

    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
            jnp.int32(0), jnp.bool_(False))
    (bitpos, _, _, out_len, markers, _), units = jax.lax.scan(
        step, init, None, length=max_units)
    return units + (out_len, markers)


def pad_input(comp: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad the input width to a 1 KiB multiple, so that ragged host
    calls (the CLI, truncation sweeps) reuse compiled programs."""
    b, c0 = comp.shape
    cpad = max(-(-c0 // 1024) * 1024, 1024)
    if cpad == c0:
        return comp
    return jnp.concatenate([comp, jnp.zeros((b, cpad - c0), comp.dtype)],
                           axis=1)


def decode_batch(comp: jnp.ndarray, inbytes: jnp.ndarray, *,
                 out_cap: int, max_units: int | None = None,
                 multi_stream: bool = False, engine: str = "bits"):
    """Batched decode_block: (uint8[B, C], int32[B]) ->
    (uint8[B, out_cap], int32[B], int32[B]).

    engine "bits" (default) is the parallel per-bit parse + chain walk
    (ops.bitpar — no serial scan at all); "scan" is the bit-serial
    lax.scan mirror of the reference state machine, kept as the
    executable-semantics oracle (both are pinned equal in tests).
    """
    from . import bitpar

    comp = pad_input(comp)
    if engine == "bits" and out_cap <= bitpar.MAX_OUT_CAP:
        return bitpar.decode_batch_bits(comp, inbytes, out_cap=out_cap,
                                        multi_stream=multi_stream)
    return _decode_batch_scan(comp, inbytes, out_cap=out_cap,
                              max_units=max_units,
                              multi_stream=multi_stream)


@functools.partial(jax.jit,
                   static_argnames=("out_cap", "max_units", "multi_stream"))
def _decode_batch_scan(comp: jnp.ndarray, inbytes: jnp.ndarray, *,
                       out_cap: int, max_units: int | None = None,
                       multi_stream: bool = False):
    kind, val, off, length, opos, out_len, markers = jax.vmap(
        lambda c, m: _parse_scan(c, m, out_cap=out_cap,
                                 max_units=max_units,
                                 multi_stream=multi_stream))(comp, inbytes)
    is_copy = (kind == 2).astype(jnp.int32)
    pay = jnp.where(kind == 1, val, off)
    rec = jnp.where(length > 0,
                    (opos << 13) | (is_copy << 11) | pay, -1)
    out, _ = expand.expand_records(rec, out_len, out_cap)
    return out.astype(jnp.uint8), out_len, markers


def decode_block(comp, inbytes, *, out_cap, max_units=None,
                 multi_stream=False, engine="bits"):
    """Decode one LZS stream.

    Args:
      comp: uint8[C] compressed bytes (zero padding beyond ``inbytes`` ok).
      inbytes: int32 scalar, valid input length.
      out_cap: static output capacity in bytes.
      max_units: static parse-step budget (default scales with out_cap).
      multi_stream: continue across end markers (incremental semantics,
        lzs-decompression.c:559-576) instead of stopping at the first one.

    Returns:
      (out: uint8[out_cap], out_len: int32, end_markers: int32)
    """
    out, out_len, markers = decode_batch(
        comp[None], inbytes[None], out_cap=out_cap, max_units=max_units,
        multi_stream=multi_stream, engine=engine)
    return out[0], out_len[0], markers[0]


def make_decoder(in_cap: int, out_cap: int, *, max_units: int | None = None,
                 multi_stream: bool = False):
    """Jitted batch decoder: (uint8[B, in_cap], int32[B]) ->
    (uint8[B, out_cap], int32[B], int32[B])."""
    del in_cap
    return functools.partial(decode_batch, out_cap=out_cap,
                             max_units=max_units,
                             multi_stream=multi_stream)


def decode_bytes(data: bytes, out_cap: int, *,
                 multi_stream: bool = False) -> bytes:
    """Host helper: decode a single stream."""
    import numpy as np

    buf = np.frombuffer(data, np.uint8)
    out, out_len, _ = decode_block(jnp.asarray(buf), jnp.int32(len(buf)),
                                   out_cap=out_cap,
                                   multi_stream=multi_stream)
    return bytes(np.asarray(out)[:int(out_len)])
