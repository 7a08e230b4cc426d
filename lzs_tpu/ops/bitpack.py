"""MSB-first bit packing with prefix-summed offsets.

Every position carries one right-aligned (value, width <= 25) unit. Bit
offsets are the exclusive prefix sum of widths; each unit splits into at
most two pieces, the bits that land in its anchor word (offset >> 5) and
the spill into the next word. Units never share bits, so adding the
pieces into the words equals the reference's bit-queue accumulation
(lzs-compression.c:303-313): one cumsum and one scatter-add.
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_bits_batch(value: jnp.ndarray, width: jnp.ndarray,
                    cap_bytes: int, end_marker: tuple | None = None):
    """Pack per-position bit fields into byte streams, one per row.

    Args:
      value: int32[B, M] right-aligned bit fields (width <= 25 bits).
      width: int32[B, M] field widths (0..25); zero-width entries emit
        nothing.
      cap_bytes: static output capacity in bytes; a multiple of 4 with
        >= 8 bytes of slack past the worst-case stream.
      end_marker: ``(value, bits)`` of one trailing unit appended after
        the last real one (not counted in ``offs``).

    Returns:
      (bytes: uint8[B, cap_bytes], total_bits: int32[B],
       offs: int32[B, M] exclusive bit offsets)
    """
    assert cap_bytes % 4 == 0
    cap_words = cap_bytes // 4
    b = value.shape[0]
    value = value.astype(jnp.int32)
    width = width.astype(jnp.int32)
    incl = jnp.cumsum(width, axis=1)
    offs = incl - width
    total_bits = incl[:, -1]
    if end_marker is not None:
        emv, emb = end_marker
        value = jnp.concatenate(
            [value, jnp.full((b, 1), emv, jnp.int32)], axis=1)
        width = jnp.concatenate(
            [width, jnp.full((b, 1), emb, jnp.int32)], axis=1)
        allo = jnp.concatenate([offs, total_bits[:, None]], axis=1)
        total_bits = total_bits + emb
    else:
        allo = offs
    # each unit's bits in its anchor word (hi) and the next one (lo)
    v = value.astype(jnp.uint32)
    end = (allo & 31) + width
    live = width > 0
    hi = jnp.where(end <= 32,
                   v << jnp.clip(32 - end, 0, 31).astype(jnp.uint32),
                   v >> jnp.clip(end - 32, 0, 31).astype(jnp.uint32))
    hi = jnp.where(live, hi, jnp.uint32(0))
    lo = jnp.where(live & (end > 32),
                   v << jnp.clip(64 - end, 0, 31).astype(jnp.uint32),
                   jnp.uint32(0))
    w0 = allo >> 5
    rows = jnp.arange(b, dtype=jnp.int32)[:, None]
    words = jnp.zeros((b, cap_words), jnp.uint32)
    words = words.at[rows, jnp.where(hi != 0, w0, cap_words)].add(
        hi, mode="drop")
    words = words.at[rows, jnp.where(lo != 0, w0 + 1, cap_words)].add(
        lo, mode="drop")
    return words_to_bytes(words), total_bits, offs


def words_to_bytes(words: jnp.ndarray) -> jnp.ndarray:
    """Big-endian 32-bit word array -> uint8 byte array (elementwise)."""
    w = words.astype(jnp.uint32)
    b = jnp.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                   (w >> 8) & 0xFF, w & 0xFF], axis=-1)
    return b.reshape(w.shape[:-1] + (w.shape[-1] * 4,)).astype(jnp.uint8)


def read_window(data: jnp.ndarray, bitpos: jnp.ndarray) -> jnp.ndarray:
    """Read a 32-bit big-endian window starting at byte bitpos>>3, shifted so
    the bit at ``bitpos`` becomes the MSB. ``data`` must be int32-valued bytes
    padded with >= 4 trailing zeros."""
    b = bitpos >> 3
    w = ((data[b] << 24) | (data[b + 1] << 16)
         | (data[b + 2] << 8) | data[b + 3]).astype(jnp.uint32)
    return (w << (bitpos & 7).astype(jnp.uint32))
