"""Parallel raw-stream LZS decode: per-bit speculative parse + chain walk.

The raw (reference-compatible) LZS stream has no sync metadata, so token
boundaries are data-dependent — the classic reason decode is "inherently
serial" (lzs-decompression.c:459-743 walks it one state at a time, and
ops.decode mirrors that as a lax.scan at ~1.5 bytes/step). This module
removes the serial parse entirely:

  1. Speculatively decode a token head at EVERY bit offset of the stream
     (pure elementwise work over nbits lanes — flag/offset/length fields
     are static bit extractions, lzs-decompression.c:214-343).
  2. Resolve extension-nibble chains (lzs-decompression.c:370-406) for
     every bit at once: chains step by 4 bits, so the 4 phase classes
     are columns of a reshape, and "total added length / nibbles until
     the first non-15 nibble" is a segmented reverse linear recurrence
     y[t] = a[t] + g[t] * y[t+4] — one log-depth associative scan.
  3. The successor function succ(b) = bit offset of the next token head
     if a head starts at bit b is then known for every bit. The true
     token chain is the orbit of bit 0 under succ — exactly the
     token-walk problem the encoder already solves, so the same
     pointer-doubling walk (tokenize.token_starts) marks all real heads.
  4. Each real head becomes one packed record (opos << 13 | is_copy << 11
     | payload). Two heads are always >= 9 bits apart, so slot b // 9 is
     injective over heads: a reshape + max compacts records densely
     enough for the copy expansion (ops.expand) — no sort, no scatter.

End markers (offset 0, lzs-decompression.c:255-261) terminate the chain
(single-stream) or jump to the next byte boundary (multi-stream,
lzs-decompression.c:559-576). Truncation reproduces the incremental
decoder's starvation semantics: a head or nibble whose bits overrun the
input emits nothing and ends the chain — and since an extension nibble
needs 4 bits while any head needs >= 9, a chain cut mid-extension can
never resynthesize a bogus head token.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import spec

_BIG = 0x3FFFFFFF
#: records pack opos into bits 13.. of an int32 -> output capacity bound
MAX_OUT_CAP = 1 << 18


_SEG_C = 16                   # sequential block width of the blocked scan


def _seg_reverse_sum(a: jnp.ndarray, g: jnp.ndarray):
    """Solve y[t] = a[t] + g[t] * y[t+1] (y past the end = 0), last axis.

    a int32, g int32 in {0, 1}. Hand-rolled blocked scan: a sequential
    compose over _SEG_C-wide blocks (slices stay lane-contiguous via one
    block transpose), then recursion on the per-block summaries, then one
    combine pass. The affine maps f_t(y) = a_t + g_t * y compose
    associatively, which is what makes the per-block summary exact.

    jax.lax.associative_scan is not used: on an earlier backend it
    returned wrong values for this operator at batch >= 32 on
    (B, 73984, 4)-sized operands, which
    tests/test_ops.py::test_bitpar_matches_scan_engine pins at batch 32.
    Whether the library scan is correct and faster on the GPU is open
    (ROADMAP D3).
    """
    n = a.shape[-1]
    c = _SEG_C
    if n <= c:
        y = a[..., n - 1]
        ys = [y]
        for j in range(n - 2, -1, -1):
            y = a[..., j] + g[..., j] * y
            ys.append(y)
        return jnp.stack(ys[::-1], axis=-1)
    nb = -(-n // c)
    pad = nb * c - n
    if pad:
        z = jnp.zeros(a.shape[:-1] + (pad,), a.dtype)
        a = jnp.concatenate([a, z], -1)
        g = jnp.concatenate([g, z], -1)
    shape = a.shape
    ab = a.reshape(shape[:-1] + (nb, c)).swapaxes(-1, -2)   # (..., c, nb)
    gb = g.reshape(shape[:-1] + (nb, c)).swapaxes(-1, -2)
    y = ab[..., c - 1, :]
    gp = gb[..., c - 1, :]
    ys, gps = [y], [gp]
    for j in range(c - 2, -1, -1):
        y = ab[..., j, :] + gb[..., j, :] * y
        gp = gb[..., j, :] * gp
        ys.append(y)
        gps.append(gp)
    ylocal = jnp.stack(ys[::-1], axis=-2)                   # (..., c, nb)
    gplocal = jnp.stack(gps[::-1], axis=-2)
    s = _seg_reverse_sum(y, gp)          # suffix values at block starts
    carry = jnp.concatenate([s[..., 1:], jnp.zeros_like(s[..., :1])], -1)
    yfull = ylocal + gplocal * carry[..., None, :]
    out = yfull.swapaxes(-1, -2).reshape(shape)
    return out[..., :n] if pad else out


def _shift_left(a: jnp.ndarray, s: int) -> jnp.ndarray:
    """a[..., t + s] with zero fill past the end."""
    b = a.shape[0]
    return jnp.concatenate(
        [a[:, s:], jnp.zeros((b, s), a.dtype)], axis=1)


def _bit_windows(comp: jnp.ndarray, cpad: int) -> jnp.ndarray:
    """uint32[B, 8 * cpad] big-endian 32-bit window starting at every bit."""
    b = comp.shape[0]
    by = comp.astype(jnp.uint32)
    if by.shape[1] < cpad + 4:
        by = jnp.concatenate(
            [by, jnp.zeros((b, cpad + 4 - by.shape[1]), jnp.uint32)],
            axis=1)
    w8 = ((by[:, :cpad] << 24) | (by[:, 1:cpad + 1] << 16)
          | (by[:, 2:cpad + 2] << 8) | by[:, 3:cpad + 3])
    nxt = by[:, 4:cpad + 4]
    r = jnp.arange(8, dtype=jnp.uint32)[None, None, :]
    w = jnp.where(r == 0, w8[:, :, None],
                  (w8[:, :, None] << r) | (nxt[:, :, None] >> (8 - r)))
    return w.reshape(b, cpad * 8)


@functools.partial(jax.jit,
                   static_argnames=("out_cap", "multi_stream"))
def decode_batch_bits(comp: jnp.ndarray, inbytes: jnp.ndarray, *,
                      out_cap: int, multi_stream: bool = False):
    """Parallel decode of a batch of raw LZS streams.

    Args:
      comp: uint8/int32[B, C] compressed bytes (zero padding past
        ``inbytes`` is fine).
      inbytes: int32[B] valid input lengths.
      out_cap: static output capacity in bytes (<= 2**18).
      multi_stream: continue across end markers (incremental semantics,
        lzs-decompression.c:559-576) instead of stopping at the first.

    Returns:
      (out: uint8[B, out_cap], out_len: int32[B], end_markers: int32[B])
      — the same contract as ops.decode.decode_batch.
    """
    from . import expand, tokenize

    assert out_cap <= MAX_OUT_CAP, "record packing bounds out_cap to 2^18"
    b, cpad = comp.shape
    nbits = cpad * 8
    inbits = (inbytes.astype(jnp.int32) * 8)[:, None]
    w = _bit_windows(comp, cpad)
    t = jnp.arange(nbits, dtype=jnp.int32)[None, :]

    # --- extension-nibble chains for every bit (4 phase classes) ---
    # Only the chain's added LENGTH is scanned; the nibble count follows
    # arithmetically: non-terminal nibbles are always 15, so a completed
    # chain has cnt = len // 15 + 1 exactly, and a truncated chain's
    # overcount of one only moves the successor deeper into input
    # starvation (any head needs >= 9 bits, a nibble only 4).
    nib = ((w >> 28) & 0xF).astype(jnp.int32)
    valid = (t + 4 <= inbits)
    g = (valid & (nib == spec.MAX_EXTENDED_LENGTH)).astype(jnp.int32)
    a_len = jnp.where(valid, nib, 0)
    q4 = nbits // 4
    # naturally bounded by 15 * nbits / 4 < 2^21: no overflow anywhere.
    ext_pack = _seg_reverse_sum(
        a_len.reshape(b, q4, 4).transpose(0, 2, 1),
        g.reshape(b, q4, 4).transpose(0, 2, 1)
    ).transpose(0, 2, 1).reshape(b, nbits)
    del a_len, g, valid, nib

    # --- head fields at every bit (lzs-decompression.c:214-343) ---
    flag = (w >> 31).astype(jnp.int32)
    lit = ((w >> 23) & 0xFF).astype(jnp.int32)
    offflag = ((w >> 30) & 1).astype(jnp.int32)
    off7 = ((w >> 23) & 0x7F).astype(jnp.int32)
    off11 = ((w >> 19) & 0x7FF).astype(jnp.int32)
    l4 = jnp.where(offflag == 1, ((w >> 19) & 0xF).astype(jnp.int32),
                   ((w >> 15) & 0xF).astype(jnp.int32))
    long_len = (l4 >> 2) == 3
    len_init = jnp.where(long_len, (l4 & 3) + 5, (l4 >> 2) + 2)
    lw = jnp.where(long_len, 4, 2)
    is_lit = flag == 0
    short_off = offflag == 1
    is_marker = (~is_lit) & short_off & (off7 == 0)
    is_match = (~is_lit) & ~is_marker
    need = jnp.where(is_lit | is_marker, 9,
                     jnp.where(short_off, 9 + lw, 13 + lw))
    enters_ext = is_match & (l4 == 15)

    # ext chain starts at t + need; need has 4 values for match heads
    ext_sel = jnp.where(
        short_off,
        jnp.where(long_len, _shift_left(ext_pack, 13),
                  _shift_left(ext_pack, 11)),
        jnp.where(long_len, _shift_left(ext_pack, 17),
                  _shift_left(ext_pack, 15)))
    ext_here = jnp.where(enters_ext, ext_sel, 0)
    del ext_pack, ext_sel

    head_ok = t + need <= inbits
    length = jnp.where(is_lit, 1,
                       jnp.where(is_marker, 0, len_init + ext_here))
    length = jnp.minimum(length, out_cap)
    consume = need + jnp.where(enters_ext, 4 * (ext_here // 15 + 1), 0)
    succ_marker = ((t + 9 + 7) & ~7) if multi_stream else jnp.full_like(
        t, nbits)
    succ = jnp.where(~head_ok, nbits,
                     jnp.where(is_marker, succ_marker, t + consume))
    delta = jnp.maximum(succ - t, 1)

    # --- the real token chain ---
    heads = jax.vmap(tokenize.token_starts)(
        delta, jnp.broadcast_to(inbits[:, 0], (b,)))

    # --- slot compaction FIRST: heads are >= 9 bits apart -> bit // 9
    # is injective over heads, so one packed per-bit value max-reduced
    # into bit // 9 slots carries everything, and the rest of the
    # pipeline (offset cumsum, record assembly, marker count) runs at
    # slot width, 9x narrower than the per-bit arrays ---
    live = heads & head_ok & (is_lit | is_match | is_marker)
    payload = jnp.where(is_lit, lit, jnp.where(short_off, off7, off11))
    # packed = length << 12 | is_copy << 11 | payload (length <= 2^18
    # keeps it positive); a marker is the unique all-zero entry (length
    # 0, literal flag, payload = offset 0)
    packed = jnp.where(live,
                       (length << 12)
                       | (is_match.astype(jnp.int32) << 11) | payload,
                       -1)
    s9 = -(-nbits // 9)
    packed = jnp.concatenate(
        [packed, jnp.full((b, s9 * 9 - nbits), -1, jnp.int32)], axis=1)
    slot = jnp.max(packed.reshape(b, s9, 9), axis=2)

    valid_s = slot >= 0
    len_s = jnp.where(valid_s, slot >> 12, 0)
    opos = jnp.cumsum(len_s, axis=1) - len_s
    total = opos[:, -1] + len_s[:, -1]
    out_len = jnp.minimum(total, out_cap)
    markers = jnp.sum((valid_s & (slot == 0)
                       & (opos < out_cap)).astype(jnp.int32), axis=1)
    opc = jnp.minimum(opos, out_cap)
    # record = opos << 13 | is_copy << 11 | payload — exactly the slot's
    # low 12 bits; a marker leaves a zero-length literal-0 pseudo-record
    # that the next record at the same output position outranks
    rec = jnp.where(valid_s & (opos < out_cap),
                    (opc << 13) | (slot & 0xFFF), -1)
    out, _ = expand.expand_records(rec, out_len, out_cap)
    return out.astype(jnp.uint8), out_len, markers
