"""Multi-device scaling: block data parallelism over a device mesh.

The reference is single-threaded; this module is the distributed-systems
layer this codec adds (SURVEY.md section 2.4). Design:

  * independent blocks are sharded over a 1-D mesh axis ("blocks")
  * each device runs the full encode/decode pipeline on its local shard
  * per-block compressed lengths, sync records, and padded payloads are
    exchanged with an ordered all_gather so the host reassembles streams
    in original block order (BASELINE.json configs 3 and 5)

Collectives ride XLA (NCCL between the GPUs of a host, and across hosts
via jax.distributed); nothing here talks to transport directly. For multi-host
runs call jax.distributed.initialize() before building the mesh — the
sharded callables below are host-agnostic.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import decode2 as dec2_ops
from ..ops import encode as enc_ops

AXIS = "blocks"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host entry point: initialize the JAX distributed runtime.

    Arguments default to the standard environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or the
    cluster auto-detection jax.distributed supports natively). Call once
    per process before building a mesh that spans hosts; single-process
    use needs no call. Idempotent.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_block_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices for block data parallelism."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (AXIS,))


def encode_sharded(mesh: Mesh, block: int, chunk: int = 4096,
                   span: int = enc_ops.SYNC_SPAN):
    """Build a sharded batch encoder with an ordered all-gather.

    The collective is explicit: each device encodes its block shard with
    the local pipeline, then ``jax.lax.all_gather(..., tiled=True)`` inside
    ``shard_map`` concatenates shards in mesh order — the
    block order of the output is pinned to the input order by
    construction, not left to GSPMD sharding propagation.

    Returns fn: (uint8[B, block], int32[B]) ->
    (comp, clens, sync_bit, sync_out, nsync), all replicated after the
    gather so any host can assemble the container.
    """
    enc = enc_ops.make_encoder(block, chunk=chunk, sync=True, span=span)
    in_s = NamedSharding(mesh, P(AXIS))

    def local(x, n):
        outs = enc(x, n)
        return tuple(jax.lax.all_gather(o, AXIS, tiled=True) for o in outs)

    # check_vma=False: the tiled all_gather leaves every device holding the
    # full array, so out_specs=P() is correct in fact; JAX's varying-axes
    # type system cannot infer replication through all_gather (jax 0.9).
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P(AXIS), P(AXIS)),
                           out_specs=P(), check_vma=False))

    def call(x, n):
        x = jax.device_put(x, in_s)
        n = jax.device_put(n, in_s)
        return fn(x, n)

    return call


def decode_sharded(mesh: Mesh, block: int, span: int = enc_ops.SYNC_SPAN):
    """Build a sharded sync-parallel batch decoder (same layout)."""
    cap = enc_ops.cap_bytes(block)
    dec = dec2_ops.make_decoder_sync(cap, block, span=span)
    in_s = NamedSharding(mesh, P(AXIS))

    def local(comp, sbit, sout, n):
        out = dec(comp, sbit, sout, n)
        return jax.lax.all_gather(out, AXIS, tiled=True)

    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P(AXIS),) * 4, out_specs=P(),
                           check_vma=False))  # see encode_sharded

    def call(comp, sbit, sout, n):
        comp = jax.device_put(comp, in_s)
        sbit = jax.device_put(sbit, in_s)
        sout = jax.device_put(sout, in_s)
        n = jax.device_put(n, in_s)
        return fn(comp, sbit, sout, n)

    return call


@dataclasses.dataclass
class DistributedCodec:
    """Host API: compress/decompress with blocks sharded over a mesh.

    The batch dimension is padded to a multiple of the mesh size so every
    device holds an equal shard (empty blocks encode to a bare end marker
    and are dropped on assembly).
    """
    mesh: Mesh
    block: int = 1 << 15
    chunk: int = 4096
    span: int = enc_ops.SYNC_SPAN

    def __post_init__(self):
        self.cap = enc_ops.cap_bytes(self.block)
        self.slots = enc_ops.sync_slots(self.block, self.span)
        self._enc = encode_sharded(self.mesh, self.block, self.chunk,
                                   self.span)
        self._dec = decode_sharded(self.mesh, self.block, self.span)

    @property
    def ndev(self) -> int:
        return self.mesh.devices.size

    def _pad_batch(self, arr: np.ndarray, fill=0) -> np.ndarray:
        b = arr.shape[0]
        want = -(-b // self.ndev) * self.ndev
        if want == b:
            return arr
        pad = np.full((want - b,) + arr.shape[1:], fill, arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def compress(self, data: bytes):
        """Returns (payload, clens, sync_bit, sync_out, nsync) with
        payload = raw concatenated streams in original block order."""
        from ..blocks import pad_blocks

        x, lens = pad_blocks(data, self.block)
        nblocks = x.shape[0]
        x, lens = self._pad_batch(x), self._pad_batch(lens)
        comp, clens, sbit, sout, nsync = self._enc(
            jnp.asarray(x), jnp.asarray(lens))
        comp = np.asarray(comp)[:nblocks]
        clens = np.asarray(clens)[:nblocks]
        payload = b"".join(comp[b, :clens[b]].tobytes()
                           for b in range(nblocks))
        return (payload, [int(c) for c in clens],
                np.asarray(sbit)[:nblocks], np.asarray(sout)[:nblocks],
                np.asarray(nsync)[:nblocks])

    def decompress(self, payload: bytes, clens, sbit, sout,
                   out_lens) -> bytes:
        nblocks = len(clens)
        comp = np.zeros((nblocks, self.cap), np.uint8)
        pos = 0
        for b, c in enumerate(clens):
            comp[b, :c] = np.frombuffer(payload, np.uint8, c, pos)
            pos += c
        lens_np = np.asarray(out_lens, np.int32)
        comp = self._pad_batch(comp)
        sbit = self._pad_batch(np.asarray(sbit, np.int32))
        sout = self._pad_batch(np.asarray(sout, np.int32))
        out = self._dec(jnp.asarray(comp), jnp.asarray(sbit),
                        jnp.asarray(sout),
                        jnp.asarray(self._pad_batch(lens_np)))
        out = np.asarray(out)[:nblocks]
        return b"".join(out[b, :lens_np[b]].tobytes()
                        for b in range(nblocks))
