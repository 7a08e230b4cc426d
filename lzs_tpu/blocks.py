"""Multi-block batch codec API (one chip) and container framing.

Independent fixed-size blocks are the framework's unit of data parallelism
(SURVEY.md section 2.4): each block is a self-terminating LZS stream (with
its own end marker), so the raw concatenation of block streams is itself a
valid stream chain — decodable by the reference incremental decoder, which
crosses end markers (lzs-decompression.c:559-576).

Two output formats:

  raw        pure concatenated LZS streams. Reference-CLI compatible; decode
             in parallel only if block lengths are known out-of-band.
  container  (version 4) a header carrying block size, per-block compressed
             lengths, an adler32 payload checksum, and parse sync records
             — parser-state checkpoints at the last parse point before
             every multiple of ``span`` compressed bits — enabling
             gather-free lane-parallel decode (ops.decode2). The payload
             remains the raw concatenation, still decodable by the
             reference decoder. Decoding validates the checksum, the
             per-lane parse boundaries, and per-block expansion status
             words, raising ValueError on corruption.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np

from .ops import decode as dec_ops
from .ops import decode2 as dec2_ops
from .ops import encode as enc_ops

MAGIC = b"LZST"
VERSION = 4
DEFAULT_BLOCK = 1 << 15
_HDR = "<4sBBHIIQI"


def pad_blocks(data: bytes, block: int) -> tuple[np.ndarray, np.ndarray]:
    """Split data into a (B, block) uint8 array plus per-block lengths."""
    n = len(data)
    nblocks = max(1, -(-n // block))
    x = np.zeros((nblocks, block), np.uint8)
    lens = np.zeros(nblocks, np.int32)
    flat = np.frombuffer(data, np.uint8)
    for b in range(nblocks):
        piece = flat[b * block:(b + 1) * block]
        x[b, :len(piece)] = piece
        lens[b] = len(piece)
    return x, lens


def concat_streams(comp: jnp.ndarray, lens: jnp.ndarray) -> tuple[
        jnp.ndarray, jnp.ndarray]:
    """Device-side ragged concatenation of per-block streams.

    comp: uint8[B, C]; lens: int32[B]. Returns (flat uint8[B*C], total).
    Bytes past each block's length are dropped via prefix-sum scatter.
    """
    nb, cap = comp.shape
    offs = jnp.cumsum(lens) - lens
    total = offs[-1] + lens[-1]
    j = jnp.arange(cap, dtype=jnp.int32)[None, :]
    idx = jnp.where(j < lens[:, None], offs[:, None] + j, nb * cap)
    flat = jnp.zeros(nb * cap, jnp.uint8).at[idx].set(comp, mode="drop")
    return flat, total


FLAG_LAZY = 1          # container flags bit: lazy (1-token-lookahead) policy
_KNOWN_FLAGS = FLAG_LAZY


@dataclasses.dataclass
class BlockCodec:
    """Batch codec over fixed-size blocks with cached jitted kernels.

    ``policy``: "greedy" (reference byte parity) or "lazy" (1-token
    lookahead — usually smaller output, still a valid LZS stream; the
    container flags byte records which policy produced a blob).
    """
    block: int = DEFAULT_BLOCK
    chunk: int = 4096
    span: int = enc_ops.SYNC_SPAN
    policy: str = "greedy"

    def __post_init__(self):
        assert self.policy in ("greedy", "lazy"), self.policy
        self.cap = enc_ops.cap_bytes(self.block)
        self.slots = enc_ops.sync_slots(self.block, self.span)
        self._enc = enc_ops.make_encoder(self.block, chunk=self.chunk,
                                         sync=True, span=self.span,
                                         policy=self.policy)
        self._dec_sync = dec2_ops.make_decoder_sync(self.cap, self.block,
                                                    span=self.span)
        self._dec_raw = None

    # -- device-level primitives (fixed batch shape) --
    def encode_batch(self, x: jnp.ndarray, n: jnp.ndarray):
        """(uint8[B, block], int32[B]) -> (comp uint8[B, cap], clen int32[B],
        sync_bit int32[B, I], sync_out int32[B, I], nsync int32[B])."""
        return self._enc(x, n)

    def decode_batch(self, comp, sync_bit, sync_out, n):
        """Sync-parallel batch decode -> uint8[B, block]."""
        return self._dec_sync(comp, sync_bit, sync_out, n)

    def decode_batch_status(self, comp, sync_bit, sync_out, n):
        """Sync-parallel batch decode with per-block status words
        (decode2.decode_batch_sync docstring lists the bits)."""
        return dec2_ops.decode_batch_sync(
            comp, sync_bit, sync_out, n, out_cap=self.block,
            span=self.span)

    def decode_batch_raw(self, comp: jnp.ndarray, nbytes: jnp.ndarray):
        """Metadata-free batch decode (the bit-parallel raw decoder,
        ops.bitpar; reference semantics)."""
        if self._dec_raw is None:
            self._dec_raw = dec_ops.make_decoder(self.cap, self.block)
        return self._dec_raw(comp, nbytes)

    # -- host-level byte APIs --
    def compress(self, data: bytes, container: bool = True) -> bytes:
        x, lens = pad_blocks(data, self.block)
        comp, clens, sbit, sout, nsync = self.encode_batch(
            jnp.asarray(x), jnp.asarray(lens))
        flat, total = concat_streams(comp, clens)
        payload = bytes(np.asarray(flat)[:int(total)])
        if not container:
            return payload
        clens_np = np.asarray(clens, np.uint32)
        nsync_np = np.asarray(nsync, np.uint32)
        sbit_np = np.asarray(sbit)
        sout_np = np.asarray(sout)
        # per-block end sentinel (bit offset of the end marker) is the
        # sentinel value the encoder stores in unused slots
        endbits = sbit_np[:, -1].astype(np.uint32)
        # row-major boolean-mask selection keeps block order — one numpy
        # slab copy instead of a per-block Python loop
        live = (np.arange(sbit_np.shape[1])[None, :]
                < nsync_np[:, None].astype(np.int64))
        recs_np = np.stack([sbit_np[live], sout_np[live]],
                           axis=1).astype(np.uint32)
        crc = zlib.adler32(payload) & 0xFFFFFFFF
        flags = FLAG_LAZY if self.policy == "lazy" else 0
        header = struct.pack(_HDR, MAGIC, VERSION, flags, self.span,
                             self.block, len(clens_np), len(data), crc)
        return (header + clens_np.tobytes() + nsync_np.tobytes()
                + endbits.tobytes() + recs_np.tobytes() + payload)

    def decompress(self, blob: bytes) -> bytes:
        """Decode a container blob.

        Every header field is validated against the payload before use
        (the framing-layer extension of the reference's corrupt-input
        hygiene, lzs-decompression.c:348-357): malformed, truncated, or
        hostile containers raise ValueError, never index errors or silent
        corruption. Fuzzed in tests/test_blocks_dist.py.
        """
        hdr_size = struct.calcsize(_HDR)
        if len(blob) < hdr_size:
            raise ValueError("container truncated: header incomplete")
        if blob[:4] != MAGIC:
            raise ValueError("not a container stream; use raw decode")
        magic, ver, flags, span, block, nblocks, orig, crc = \
            struct.unpack_from(_HDR, blob)
        if ver != VERSION:
            raise ValueError(f"unsupported container version {ver}")
        if flags & ~_KNOWN_FLAGS:
            raise ValueError(f"unknown container flags {flags:#x}")
        if block != self.block or span != self.span:
            raise ValueError("container block/span mismatch with codec")
        if nblocks < 1 or nblocks > len(blob):
            raise ValueError(f"implausible block count {nblocks}")
        if not orig <= nblocks * block:
            raise ValueError(
                f"decoded size {orig} exceeds {nblocks} x {block} blocks")
        if orig and not orig > (nblocks - 1) * block:
            raise ValueError("decoded size implies empty trailing blocks")

        def _take(count: int, pos: int, what: str) -> np.ndarray:
            if pos + 4 * count > len(blob):
                raise ValueError(f"container truncated in {what}")
            return np.frombuffer(blob, np.uint32, count, pos).astype(
                np.int64)

        pos = hdr_size
        clens = _take(nblocks, pos, "block lengths")
        pos += 4 * nblocks
        nsync = _take(nblocks, pos, "sync counts")
        pos += 4 * nblocks
        endbits = _take(nblocks, pos, "end offsets").astype(np.int32)
        pos += 4 * nblocks
        if (clens > self.cap).any() or (clens < 0).any():
            raise ValueError("block compressed length exceeds capacity")
        if (nsync > self.slots).any():
            raise ValueError("sync record count exceeds slot capacity")
        total_recs = int(nsync.sum())
        recs64 = _take(2 * total_recs, pos, "sync records")
        recs = recs64.reshape(total_recs, 2).astype(np.int32)
        pos += 8 * total_recs
        payload = np.frombuffer(blob, np.uint8, offset=pos)
        if len(payload) < clens.sum():
            raise ValueError("container truncated in payload")
        if zlib.adler32(payload.tobytes()) & 0xFFFFFFFF != crc:
            raise ValueError("payload checksum mismatch")
        clens = clens.astype(np.int32)
        nsync = nsync.astype(np.int32)
        if (recs < 0).any() or (
                recs[:, 0] > int(clens.max(initial=0)) * 8).any():
            raise ValueError("sync record bit offset out of payload range")

        lens = np.full(nblocks, block, np.int32)
        if orig:
            lens[-1] = orig - block * (nblocks - 1)
        else:
            lens[:] = 0
        # slab fills: boolean-mask assignment walks rows in order, which
        # is exactly the payload / record concatenation order (no
        # per-block Python loop — the host must not become the wall at
        # device decode rates)
        comp = np.zeros((nblocks, self.cap), np.uint8)
        cmask = np.arange(self.cap)[None, :] < clens[:, None]
        comp[cmask] = payload[:int(clens.sum())]
        smask = np.arange(self.slots)[None, :] < nsync[:, None]
        sbit = np.broadcast_to(endbits[:, None],
                               (nblocks, self.slots)).copy()
        sout = np.broadcast_to(lens[:, None],
                               (nblocks, self.slots)).copy()
        sbit[smask] = recs[:, 0]
        sout[smask] = recs[:, 1]
        out, status = self.decode_batch_status(
            jnp.asarray(comp), jnp.asarray(sbit), jnp.asarray(sout),
            jnp.asarray(lens))
        status_np = np.asarray(status)
        if status_np.any():
            bad = np.nonzero(status_np)[0]
            raise ValueError(
                f"decode integrity failure in block(s) {bad.tolist()} "
                f"(status {[int(status_np[i]) for i in bad]})")
        out = np.asarray(out)
        omask = np.arange(self.block)[None, :] < lens[:, None]
        result = out[omask].tobytes()
        if len(result) != orig:
            raise ValueError(
                f"decoded size {len(result)} != recorded {orig}")
        return result
