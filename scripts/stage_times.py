"""Wall time of each device stage of the codec at the bench shape, on a GPU.

Every stage is jitted on its own and fed the previous stage's outputs on
the frozen 8 MiB bench corpus in 256 blocks of 32 KiB. A stage is timed
after one warm-up call, with block_until_ready around each call; the
median of ``--repeats`` calls is reported. Stages jitted alone lose the
fusion across stage borders that the end-to-end programs get, so the
end-to-end rows are timed too.

The raw decoder's token walk runs over one node per compressed bit; it
is timed here on seeded steps of 9 to 32 bits at that width.

Prints one line per stage, the card's name and power limit, and a JSON
line with the same numbers (also written to ``--out``).

Usage: python scripts/stage_times.py [--repeats 5] [--size N] [--block N]
                                     [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import bench  # noqa: E402
from lzs_tpu.utils import compile_cache, device  # noqa: E402


def timed(fn, *args, repeats: int):
    """(first-call seconds, median seconds over ``repeats``, output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--size", type=int, default=1 << 23)
    ap.add_argument("--block", type=int, default=1 << 15)
    ap.add_argument("--out", default="chiprun_out/stage_times.json")
    args = ap.parse_args(argv)

    devs = device.require_gpu()
    compile_cache.enable()
    import jax
    import jax.numpy as jnp

    from lzs_tpu import spec
    from lzs_tpu.blocks import pad_blocks
    from lzs_tpu.ops import (bitpack, bitpar, decode, decode2, encode,
                             expand, sortmatch, tokenize)

    block = args.block
    x_np, lens_np = pad_blocks(bench.make_corpus(args.size), block)
    x, n = jnp.asarray(x_np), jnp.asarray(lens_np)
    rows = {}

    def stage(name, fn, *fargs):
        first, med, out = timed(jax.jit(fn), *fargs, repeats=args.repeats)
        rows[name] = {"median_ms": med * 1e3, "first_call_s": first}
        print(f"{name:34s} {med * 1e3:10.3f} ms   (first call "
              f"{first:6.1f} s)", flush=True)
        return out

    xi = x.astype(jnp.int32)
    score, off = stage("match.candidates", jax.vmap(sortmatch.candidates),
                       xi, n)
    full = stage("match.extend", jax.vmap(functools.partial(
        sortmatch._extend, cap=spec.SEARCH_MATCH_MAX)), xi, n, score, off)
    i = jnp.arange(block, dtype=jnp.int32)[None, :]
    is_match = (score >= spec.MIN_MATCH) & (i < n[:, None])
    step = jnp.where(is_match, full, 1)
    stage("tokenize.walk", jax.vmap(tokenize.token_starts), step, n)
    value, width, starts, _ = stage(
        "tokenize.units (with walk)", jax.vmap(tokenize.emission_units),
        xi, n, score, off, full)
    comp, total_bits, offs = stage(
        "bitpack", functools.partial(
            bitpack.pack_bits_batch, cap_bytes=encode.cap_bytes(block),
            end_marker=(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)),
        value, width)
    stage("sync_records", functools.partial(
        encode._sync_records_batch, span=encode.SYNC_SPAN),
        total_bits, offs, width, starts, off, n)
    comp, nbytes, sbit, sout, _ = stage(
        "encode_batch_sync (end to end)", encode.encode_batch_sync, x, n)

    recs, _ = stage("decode2.parse", jax.vmap(functools.partial(
        decode2._parse_full, span=encode.SYNC_SPAN)),
        comp.astype(jnp.int32), sbit, sout)
    lane_major = jnp.swapaxes(recs, 1, 2).reshape(recs.shape[0], -1)
    stage("expand", functools.partial(expand.expand_records, out_cap=block),
          lane_major, n)
    stage("decode_batch_sync (end to end)", functools.partial(
        decode2.decode_batch_sync, out_cap=block), comp, sbit, sout, n)

    raw = decode.pad_input(comp)
    stage("bitpar (raw decode, end to end)", functools.partial(
        bitpar.decode_batch_bits, out_cap=block), raw, nbytes)
    nbits = raw.shape[1] * 8
    delta = jnp.asarray(np.random.default_rng(9).integers(
        9, 33, (x.shape[0], nbits), dtype=np.int32))
    stage(f"tokenize.walk (raw, {nbits} nodes)",
          jax.vmap(tokenize.token_starts), delta, n * 0 + nbits)

    smi = device.nvidia_smi()
    print(f"nvidia-smi: {smi[0]}")
    record = {"device": device.describe(devs), "gpu": smi[0],
              "shape": [int(x.shape[0]), block], "stages": rows}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
