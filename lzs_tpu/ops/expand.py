"""LZ77 copy expansion by pointer doubling over output positions.

The decoders (decode2's container parse, bitpar's raw-stream parse and
decode's bit-serial scan) all end in the same record form: one packed
int32 per token, ``opos << 13 | is_copy << 11 | payload`` (payload = the
literal byte or the copy offset), in slot order with nondecreasing
output positions and -1 in empty slots. This module turns records into
bytes with whole-array XLA operations and no sequential state:

  1. Coverage: a running max fills the empty slots (the form is
     nondecreasing), each slot where the fill changes scatters its record
     to its output position (max), and a running max over output
     positions gives every byte its covering record — the last one with
     ``opos <= j``.
  2. Sources: a copy of length L > d is periodic with period d, so byte j
     of a copy starting at s reads ``src = s - d + (j - s) % d``, which is
     always strictly before s (lzs-decompression.c:346-365 byte-serial
     semantics, RLE chains included). Literals, uncovered bytes and
     copies whose source falls before the block start are fixed points.
  3. log2(out_cap) rounds of ``ptr = ptr[ptr]`` land every byte on its
     fixed point; one gather reads the value. A source before the block
     start gives zero, the reference decoder's corrupt-input hygiene
     ("Avoid information leak", lzs-decompression.c:348-357).

Status bits (per block), the container-level analogue of the reference's
LzsDecompressStatus_t (lzs.h:170-178):
  bit 0  a byte inside [0, n) had no covering token (parse underrun)
  bit 1  a copy source fell before the block start (offset too far)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def expand_records(recs: jnp.ndarray, n: jnp.ndarray, out_cap: int):
    """Expand packed parse records into output bytes.

    recs: int32[B, S] records in slot order (-1 for empty slots); n:
    int32[B] decoded lengths; out_cap: static output width.

    Returns (out int32[B, out_cap], status int32[B]); bytes at or past
    ``n`` are zero.
    """
    b, s = recs.shape
    rows = jnp.arange(b, dtype=jnp.int32)[:, None]
    fill = jax.lax.cummax(jnp.where(recs >= 0, recs, -1), axis=1)
    prev = jnp.concatenate(
        [jnp.full((b, 1), -1, jnp.int32), fill[:, :-1]], axis=1)
    # one scatter per distinct record; opos past out_cap is dropped
    at = jnp.where((fill != prev) & (fill >= 0), fill >> 13, out_cap)
    cover = jnp.full((b, out_cap), -1, jnp.int32).at[rows, at].max(
        fill, mode="drop")
    rec = jax.lax.cummax(cover, axis=1)

    j = jnp.broadcast_to(jnp.arange(out_cap, dtype=jnp.int32)[None, :],
                         (b, out_cap))
    nq = n[:, None]
    none = rec < 0
    seg_start = rec >> 13
    copy_bit = ((rec >> 11) & 1) == 1       # also set where rec == -1
    pay = rec & 0x7FF
    d = jnp.maximum(pay, 1)
    src = seg_start - d + jax.lax.rem(j - seg_start, d)
    is_copy = copy_bit & ~none
    val = jnp.where(is_copy | none, 0, pay & 0xFF)
    ptr = jnp.where(is_copy & (src >= 0), src, j)

    for _ in range(max(out_cap - 1, 1).bit_length()):
        ptr = jnp.take_along_axis(ptr, ptr, axis=1,
                                  mode="promise_in_bounds")
    out = jnp.take_along_axis(val, ptr, axis=1, mode="promise_in_bounds")

    inside = j < nq
    bad_cov = jnp.any(none & inside, axis=1)
    bad_src = jnp.any(copy_bit & (src < 0) & inside, axis=1)
    status = bad_cov.astype(jnp.int32) | (bad_src.astype(jnp.int32) << 1)
    return jnp.where(inside, out, 0), status
