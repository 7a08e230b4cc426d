"""Full LZS encode pipeline (bytes -> bitstream) as a jittable function.

Stages: best-match table (sortmatch.py, sort-based; match.py exhaustive
variant selectable) -> token chain + emission units (tokenize.py) ->
prefix-sum bit pack (bitpack.py) -> end marker + padding. Output is
byte-identical to the reference C encoders for any input (policy verified
in tests against lzs_compress / lzs_simple_compress / the incremental CLI).

``encode_block_sync`` additionally emits decode sync metadata: parser-state
records at the last parse point before every multiple of ``span``
compressed bits, so the container-format decoder can parse one stream with
hundreds of independent lanes over statically located stream tiles (see
decode2.py — the fixed spacing is what makes the parallel parse
gather-free). Records live in the container framing only — the LZS payload
stays reference-compatible.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import spec
from . import bitpack, match, sortmatch, tokenize

#: nibbles consumed per parse step inside an extension run (decode2 contract:
#: a parse step sees >= 25 valid bits from one word fetch, so 6 nibbles)
NIBBLES_PER_STEP = 6
#: default compressed-bit span between sync records. Records sit at the last
#: parse point before every multiple of ``span`` bits, so decode lane l owns
#: a *statically located* word tile of the stream — the parse needs no
#: gathers. Must be a multiple of 32 and > 24 (the widest parse step).
SYNC_SPAN = 2048
#: widest parse step in bits: a token head is <= 17, a 6-nibble group is 24
MAX_STEP_BITS = 24
#: narrowest parse step in bits (a literal: flag + 8)
MIN_STEP_BITS = 9
_BIG = 0x3FFFFFFF    # plain int: jnp scalars become captured jaxpr consts


def cap_bytes(block: int) -> int:
    """Static compressed-output capacity for a block of ``block`` bytes
    (multiple of 4, with slack for the word-granular packer)."""
    return (spec.compressed_max(block) + 11) & ~3


def sync_slots(block: int, span: int = SYNC_SPAN) -> int:
    """Static number of sync-record slots for a block."""
    return -(-(cap_bytes(block) * 8) // span) + 1


def sync_scan_len(span: int = SYNC_SPAN) -> int:
    """Static parse-step budget per decode lane for a given record span."""
    return -(-(span + MAX_STEP_BITS) // MIN_STEP_BITS) + 1


def _pipeline_batch(x, n, window, cap, chunk, backend, policy="greedy"):
    """Batched encode pipeline: x int32[B, N], n int32[B]."""
    x = x.astype(jnp.int32)
    nb, npos = x.shape
    if backend == "sort":
        score, off, full = sortmatch.best_matches_batch(
            x, n, window=window, cap=cap)
    else:
        score, off, full = jax.vmap(
            lambda a, b: match.best_matches(
                a, b, window=window, cap=cap, chunk=min(chunk, 256)))(x, n)
    if policy == "lazy":
        # 1-token-lookahead (lazy) selection: defer a match when the
        # next position holds a strictly longer one — emit a literal
        # instead (the gzip-style improvement over the C encoder's pure
        # greedy policy, lzs-compression.c:326-362). Streams stay valid
        # LZS; byte-parity with the C encoder is a greedy-only property.
        is_m = score >= spec.MIN_MATCH
        nxt_m = jnp.concatenate(
            [is_m[:, 1:], jnp.zeros((nb, 1), jnp.bool_)], axis=1)
        nxt_full = jnp.concatenate(
            [full[:, 1:], jnp.zeros((nb, 1), jnp.int32)], axis=1)
        defer = is_m & nxt_m & (nxt_full > full)
        score = jnp.where(defer, 0, score)
        full = jnp.where(defer, 1, full)
    else:
        assert policy == "greedy", policy
    value, width, starts, length = jax.vmap(tokenize.emission_units)(
        x, n, score, off, full)
    comp, total_bits, offs = bitpack.pack_bits_batch(
        value, width, cap_bytes(npos),
        end_marker=(spec.END_MARKER_VALUE, spec.END_MARKER_BITS))
    nbytes = (total_bits + 7) >> 3
    return comp, nbytes, total_bits, offs, width, starts, off


@functools.partial(
    jax.jit,
    static_argnames=("window", "cap", "chunk", "backend", "policy"))
def encode_block(x: jnp.ndarray, n: jnp.ndarray, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX,
                 chunk: int = 4096, backend: str = "sort",
                 policy: str = "greedy"):
    """Encode one block.

    Args:
      x: uint8/int32[N] block contents (only the first ``n`` bytes matter).
      n: int32 scalar true length.
      backend: "sort" (fast path) or "exhaustive" (brute-force reference
        kernel); both produce identical bytes.

    Returns:
      (comp: uint8[cap_bytes(N)], nbytes: int32) — the stream including the
      end marker and zero padding to a byte boundary.
    """
    comp, nbytes = _pipeline_batch(x[None], n[None], window, cap, chunk,
                                   backend, policy)[:2]
    return comp[0], nbytes[0]


@functools.partial(
    jax.jit,
    static_argnames=("window", "cap", "chunk", "backend", "policy"))
def encode_batch(x: jnp.ndarray, n: jnp.ndarray, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX,
                 chunk: int = 4096, backend: str = "sort",
                 policy: str = "greedy"):
    """Batched encode_block: (uint8[B, N], int32[B]) ->
    (uint8[B, cap_bytes(N)], int32[B]). ``policy`` is "greedy"
    (reference byte parity) or "lazy" (1-token lookahead, usually
    smaller output; still a valid LZS stream)."""
    comp, nbytes = _pipeline_batch(x, n, window, cap, chunk, backend,
                                   policy)[:2]
    return comp, nbytes


@functools.partial(
    jax.jit, static_argnames=("window", "cap", "chunk", "backend", "span"))
def encode_block_sync(x: jnp.ndarray, n: jnp.ndarray, *,
                      window: int = spec.WINDOW_SIZE,
                      cap: int = spec.SEARCH_MATCH_MAX,
                      chunk: int = 4096, backend: str = "sort",
                      span: int = SYNC_SPAN):
    """Encode one block and emit parse sync records.

    Record slot l >= 1 holds the parser state at the *last* parse point
    before bit ``span * l`` (one always exists within MAX_STEP_BITS of the
    boundary since no parse step spans more bits); slot 0 is the stream
    start. Decode lane l therefore parses only bits
    [span*l - MAX_STEP_BITS, span*(l+1)) — a statically located slice, so
    the decoder's word fetches stay inside a small per-lane tile.

    Returns:
      comp: uint8[cap_bytes(N)], nbytes: int32,
      sync_bit: int32[I] bit offset of each sync point,
      sync_out: int32[I] packed record: output byte offset (bits 0..16) |
        parser mode (bit 17) | current match offset (bits 18..28) — mode 1
        resumes inside an extension-nibble chain,
      nsync: int32 number of lanes (= ceil(token_bits / span)); remaining
      slots hold the stream-end sentinel: sync_bit = total token bits,
      sync_out = n.
    """
    out = encode_batch_sync(x[None], n[None], window=window, cap=cap,
                            chunk=chunk, backend=backend, span=span)
    return tuple(o[0] for o in out)


@functools.partial(
    jax.jit, static_argnames=("window", "cap", "chunk", "backend", "span",
                              "policy"))
def encode_batch_sync(x: jnp.ndarray, n: jnp.ndarray, *,
                      window: int = spec.WINDOW_SIZE,
                      cap: int = spec.SEARCH_MATCH_MAX,
                      chunk: int = 4096, backend: str = "sort",
                      span: int = SYNC_SPAN, policy: str = "greedy"):
    """Batched encode_block_sync (see its docstring for the record
    contract): (uint8[B, N], int32[B]) -> (comp, nbytes, sync_bit,
    sync_out, nsync) with a leading batch axis on every output."""
    assert span % 32 == 0 and span > MAX_STEP_BITS
    comp, nbytes, total_bits, offs, width, starts, off = _pipeline_batch(
        x, n, window, cap, chunk, backend, policy)
    sync_bit, sync_out, nsync = _sync_records_batch(
        total_bits, offs, width, starts, off, n, span)
    return comp, nbytes, sync_bit, sync_out, nsync


def _sync_records_batch(total_bits, offs, width, starts, off, n, span):
    """Parser-state records at the span-crossing parse steps.

    Parse steps are the token heads and every NIBBLES_PER_STEP-th
    extension nibble (decode2's lane contract). A step is <=
    MAX_STEP_BITS bits, so it crosses at most one multiple of ``span``,
    and every slot 1..nsync-1 receives exactly one record: the step that
    starts before the boundary while the next step starts at or past it.
    """
    b, npos = starts.shape
    end_bits = total_bits - spec.END_MARKER_BITS
    nslots = sync_slots(npos, span)
    width = width[:, :npos]
    o = offs[:, :npos]
    i = jnp.broadcast_to(jnp.arange(npos, dtype=jnp.int32)[None, :],
                         (b, npos))

    okey = jax.lax.cummax(jnp.where(
        starts, (i << 12) | jnp.minimum(off, spec.LONG_OFFSET_MAX), -1),
        axis=1)
    owner_i = okey >> 12
    owner_off = okey & 0xFFF
    t = i - owner_i - 1
    is_nib = (~starts) & (width == 4)
    is_step = starts | (is_nib & (t % NIBBLES_PER_STEP == 0))
    opos = owner_i + spec.MAX_SHORT_LENGTH + spec.MAX_EXTENDED_LENGTH * t
    rec = jnp.where(starts, i, opos | (1 << 17) | (owner_off << 18))

    # start of the next parse step; past the last one, the end marker
    nso = jax.lax.cummin(jnp.where(is_step, o, _BIG), axis=1, reverse=True)
    next_o = jnp.minimum(
        jnp.concatenate([nso[:, 1:], end_bits[:, None]], axis=1),
        end_bits[:, None])
    c = next_o // span
    cross = is_step & (o // span < c)
    rows = jnp.arange(b, dtype=jnp.int32)[:, None]
    at = jnp.where(cross, c, nslots)
    built_bit = jnp.zeros((b, nslots), jnp.int32).at[rows, at].set(
        o, mode="drop")
    built_rec = jnp.zeros((b, nslots), jnp.int32).at[rows, at].set(
        rec, mode="drop")

    nsync = (end_bits + span - 1) // span
    slot = jnp.arange(nslots, dtype=jnp.int32)[None, :]
    sync_bit = jnp.where(slot < nsync[:, None], built_bit,
                         end_bits[:, None])
    sync_out = jnp.where(slot < nsync[:, None], built_rec, n[:, None])
    return sync_bit, sync_out, nsync


def make_encoder(block: int, *, window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX, chunk: int = 4096,
                 backend: str = "sort", sync: bool = False,
                 span: int = SYNC_SPAN, policy: str = "greedy"):
    """Return a jitted batch encoder over fixed block size.

    Maps (uint8[B, block], int32[B]) -> (uint8[B, cap_bytes], int32[B])
    plus (sync_bit, sync_out, nsync) when ``sync``.
    """
    del block
    if sync:
        return functools.partial(encode_batch_sync, window=window, cap=cap,
                                 chunk=chunk, backend=backend, span=span,
                                 policy=policy)
    return functools.partial(encode_batch, window=window, cap=cap,
                             chunk=chunk, backend=backend, policy=policy)


# ---------------------------------------------------------------------------
# Host convenience wrappers
# ---------------------------------------------------------------------------

def encode_bytes(data: bytes, block: int = 1 << 15) -> bytes:
    """Host helper: encode a whole byte string as one stream per block,
    concatenated (each block is an independent LZS stream with end marker).
    """
    import numpy as np

    out = bytearray()
    for start in range(0, max(len(data), 1), block):
        piece = data[start:start + block]
        x = np.zeros(block, np.uint8)
        x[:len(piece)] = np.frombuffer(piece, np.uint8)
        comp, nbytes = encode_block(jnp.asarray(x), jnp.int32(len(piece)))
        out += bytes(np.asarray(comp)[:int(nbytes)])
    return bytes(out)
