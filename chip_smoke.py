"""Prove that the codec's device paths run, compiled, on an NVIDIA GPU.

Drives the shipped entry points once at the README's configuration: the
frozen 8 MiB bench corpus (bench.make_corpus, pinned by CORPUS_SHA) in
256 blocks of 32 KiB. Phases, all in this one process:

  0 device     JAX must see a GPU; prints it, and nvidia-smi's name and
               power limit (from a child process that does not import JAX)
  1 compile    lowers and compiles the container encoder, the container
               decoder and the raw decoder at (256, 32768); prints the
               compile seconds and memory analysis of each
  2 container  BlockCodec.compress / decompress round trip, byte-exact
  3 parity     greedy raw streams == native C++ encoder on all 256 blocks
               and == the NumPy reference model on a seeded sample;
               the lazy-policy container round-trips
  4 raw        BlockCodec.decode_batch_raw (the bit-parallel decoder)
               gives back every block
  5 cli        lzs_tpu.cli.main in-process (no second process on the
               card): raw and --container compress/decompress of 1 MiB;
               the native decoder decodes the raw file too
  6 selftest   the 144 adversarial parity checks (lzs_tpu.selftest)
  7 report     peak device memory and the wall time of each phase

``--devices 4`` runs only the four-card path: DistributedCodec over a
1-D mesh of four GPUs must round-trip the corpus, and its payload must be
byte-identical to single-device BlockCodec output.

Any failure raises and the exit code is non-zero. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.

Usage: python chip_smoke.py [--devices 4]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np

import bench
from lzs_tpu import reference, selftest
from lzs_tpu.blocks import BlockCodec, pad_blocks
from lzs_tpu.utils import compile_cache, device, native

BLOCK = 1 << 15
SIZE = 1 << 23
REF_SAMPLE = 8          # blocks checked against the NumPy reference model


def corpus() -> bytes:
    data = bench.make_corpus(SIZE)
    got = hashlib.sha256(data).hexdigest()
    assert got == bench.CORPUS_SHA, f"corpus drift: {got}"
    return data


def blocks_of(out: np.ndarray, lens: np.ndarray) -> list[bytes]:
    return [out[b, :lens[b]].tobytes() for b in range(len(lens))]


def phase_compile(block: int, nblocks: int) -> None:
    import jax
    import jax.numpy as jnp

    from lzs_tpu import spec
    from lzs_tpu.ops import bitpar, decode, decode2, encode

    cap = encode.cap_bytes(block)
    slots = encode.sync_slots(block)
    u8 = jax.ShapeDtypeStruct((nblocks, block), jnp.uint8)
    i32 = jax.ShapeDtypeStruct((nblocks,), jnp.int32)
    comp = jax.ShapeDtypeStruct((nblocks, cap), jnp.uint8)
    recs = jax.ShapeDtypeStruct((nblocks, slots), jnp.int32)
    raw = jax.eval_shape(decode.pad_input, comp)
    # the same static arguments BlockCodec passes, so later calls reuse
    # these executables
    stages = {
        "encode_batch_sync": lambda: encode.encode_batch_sync.lower(
            u8, i32, window=spec.WINDOW_SIZE, cap=spec.SEARCH_MATCH_MAX,
            chunk=4096, backend="sort", span=encode.SYNC_SPAN,
            policy="greedy"),
        "decode2.decode_batch_sync": lambda: decode2.decode_batch_sync.lower(
            comp, recs, recs, i32, out_cap=block, span=encode.SYNC_SPAN),
        "decode.decode_batch (bitpar)": lambda: bitpar.decode_batch_bits.lower(
            raw, i32, out_cap=block, multi_stream=False),
    }
    for name, lower in stages.items():
        t0 = time.perf_counter()
        compiled = lower().compile()
        print(f"compile {name}: {time.perf_counter() - t0:.1f} s")
        print(f"  memory_analysis: {compiled.memory_analysis()}")


def phase_container(data: bytes, block: int) -> None:
    codec = BlockCodec(block=block)
    blob = codec.compress(data)
    assert codec.decompress(blob) == data, "container round trip"
    print(f"container: {len(data)} -> {len(blob)} bytes, round trip exact")


def phase_parity(data: bytes, block: int) -> tuple:
    import jax.numpy as jnp

    codec = BlockCodec(block=block)
    x, lens = pad_blocks(data, block)
    comp, clens = codec.encode_batch(jnp.asarray(x), jnp.asarray(lens))[:2]
    streams = blocks_of(np.asarray(comp), np.asarray(clens))
    pieces = blocks_of(x, lens)
    bad = [b for b, (s, p) in enumerate(zip(streams, pieces))
           if s != native.compress(p)]
    assert not bad, f"native encoder parity fails in blocks {bad[:10]}"
    sample = np.random.default_rng(2026).choice(
        len(pieces), min(REF_SAMPLE, len(pieces)), replace=False)
    for b in sample:
        assert streams[b] == reference.lzs_compress(pieces[b]), \
            f"reference model parity fails in block {b}"
    lazy = BlockCodec(block=block, policy="lazy")
    lblob = lazy.compress(data)
    assert lazy.decompress(lblob) == data, "lazy container round trip"
    print(f"parity: {len(streams)}/{len(streams)} blocks == native encoder, "
          f"{len(sample)} sampled == reference model; lazy container "
          f"{len(lblob)} bytes round-trips")
    return comp, clens, x, lens


def phase_raw(comp, clens, x, lens, block: int) -> None:
    out = BlockCodec(block=block).decode_batch_raw(comp, clens)[0]
    got = blocks_of(np.asarray(out), lens)
    bad = [b for b, (g, p) in enumerate(zip(got, blocks_of(x, lens)))
           if g != p]
    assert not bad, f"raw decode differs in blocks {bad[:10]}"
    print(f"raw decode: {len(got)}/{len(got)} blocks exact")


def phase_cli(data: bytes) -> None:
    from lzs_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(data)
        for mode in ([], ["--container"]):
            packed = os.path.join(tmp, "packed" + "".join(mode))
            back = packed + ".out"
            assert cli.main(["compress", *mode, src, packed]) == 0
            assert cli.main(["decompress", *mode, packed, back]) == 0
            with open(back, "rb") as f:
                assert f.read() == data, f"cli round trip {mode}"
            if not mode:
                with open(packed, "rb") as f:
                    raw = f.read()
                assert native.decompress(raw, out_cap=len(data) + 16,
                                         multi_stream=True) == data
        print(f"cli: raw and --container round trips of {len(data)} bytes "
              "exact; native decoder reads the raw file")


def phase_selftest() -> None:
    passed, total, fails = selftest.run()
    print(f"selftest: {passed}/{total}")
    assert passed == total, f"selftest failures: {fails[:20]}"


def run_single(data: bytes, block: int) -> dict:
    """Phases 1-6; returns the wall seconds of each."""
    nblocks = -(-len(data) // block)
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    timed("compile", phase_compile, block, nblocks)
    timed("container", phase_container, data, block)
    comp, clens, x, lens = timed("parity", phase_parity, data, block)
    timed("raw", phase_raw, comp, clens, x, lens, block)
    timed("cli", phase_cli, data[:1 << 20])
    timed("selftest", phase_selftest)
    return walls


def run_distributed(data: bytes, block: int, ndev: int) -> dict:
    """DistributedCodec over ``ndev`` devices against one-device output."""
    import jax

    from lzs_tpu.parallel import dist

    walls = {}
    t0 = time.perf_counter()
    mesh = dist.make_block_mesh(jax.devices()[:ndev])
    codec = dist.DistributedCodec(mesh, block=block)
    payload, clens, sbit, sout, _ = codec.compress(data)
    x, lens = pad_blocks(data, block)
    out = codec.decompress(payload, clens, sbit, sout, lens)
    assert out == data, "distributed round trip"
    walls["distributed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = BlockCodec(block=block).compress(data, container=False)
    assert payload == single, "distributed payload != one-device payload"
    walls["one_device"] = time.perf_counter() - t0
    print(f"distributed: {ndev} devices, {len(clens)} blocks, payload "
          f"{len(payload)} bytes == one-device BlockCodec, round trip exact")
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    devs = device.require_gpu(args.devices)
    cache = compile_cache.enable()
    import jax

    info = device.describe(devs)
    smi = device.nvidia_smi()
    print(f"device: {info['kind']} x{info['count']} ({info['platform']}), "
          f"jax {jax.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile cache: {cache}")
    for line in smi:
        print(f"nvidia-smi: {line}")

    t0 = time.perf_counter()
    data = corpus()
    if args.devices == 1:
        walls = run_single(data, BLOCK)
    else:
        walls = run_distributed(data, BLOCK, args.devices)
    walls["total"] = time.perf_counter() - t0

    peak = max(d.memory_stats().get("peak_bytes_in_use", 0) for d in devs)
    print(f"peak_bytes_in_use: {peak}")
    label = f"[{smi[0]}]"
    for name, sec in walls.items():
        print(f"wall {name}: {sec:.2f} s {label}")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
