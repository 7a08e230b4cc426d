"""File-to-file compression CLIs.

Matches the reference CLI contract (c/src/utils/lzs-compress.c:60-76,
python/lzs-compress.py:44-49): ``lzs-compress INFILE OUTFILE`` /
``lzs-decompress INFILE OUTFILE`` produce/consume raw LZS streams that
interoperate with the reference implementations.

The default compress path is the device batch pipeline emitting raw
concatenated per-block streams — each block an independent LZS stream
with its own end marker, which the reference incremental decoder (the
reference CLI default, lzs-decompression.c:559-576) decodes as one
stream. ``--stream`` selects the carried-window host path instead (one
continuous stream, byte-identical to the reference incremental encoder).
``--container`` adds the framing that enables the sync-parallel decoder.

Usage:
    python -m lzs_tpu.cli compress   [--container | --stream] IN OUT
    python -m lzs_tpu.cli decompress [--container] IN OUT
"""

from __future__ import annotations

import argparse
import sys

from .utils import compile_cache


def _compress(args) -> int:
    data = open(args.infile, "rb").read()
    policy = "lazy" if args.lazy else "greedy"
    if args.container:
        from .blocks import BlockCodec
        out = BlockCodec(block=args.block, policy=policy).compress(data)
    elif args.stream:
        if args.lazy:
            raise SystemExit("--lazy needs the device batch path "
                             "(--blocks or --container)")
        from .stream import compress_stream
        out = compress_stream(data, feed_size=args.block)
    else:
        from .blocks import BlockCodec
        out = BlockCodec(block=args.block, policy=policy).compress(
            data, container=False)
    open(args.outfile, "wb").write(out)
    if args.verbose:
        ratio = len(out) / max(len(data), 1)
        print(f"{len(data)} -> {len(out)} bytes ({ratio:.1%})",
              file=sys.stderr)
    return 0


def _decompress_raw_device(data: bytes):
    """Decode a raw (reference-format) stream chain on the device.

    Uses the parallel raw decoder (ops.bitpar) with multi_stream
    semantics and a geometric output-capacity retry under the
    reference's 16x expansion bound (lzs.h:79-81); sizes are bucketed to
    powers of two so repeat invocations reuse compiled programs. Returns
    None when the output outgrows the device decoder's record packing
    (bitpar.MAX_OUT_CAP); the caller then decodes on the host.
    """
    if not data:
        return b""
    import numpy as np
    import jax.numpy as jnp

    from .ops import bitpar
    from .ops import decode as dec_ops

    n = len(data)
    in_cap = 1 << max(9, (n - 1).bit_length())
    buf = np.zeros(in_cap, np.uint8)
    buf[:n] = np.frombuffer(data, np.uint8)
    comp = jnp.asarray(buf)
    max_units = in_cap * 2 + 16
    cap = 1 << max(12, (4 * n - 1).bit_length())
    while cap <= max(16 * n, 1 << 12):
        if cap > bitpar.MAX_OUT_CAP:
            # past the record packing bound only the bit-serial scan is
            # left on the device, far slower than the native host decoder
            return None
        out, out_len, _ = dec_ops.decode_block(
            comp, jnp.int32(n), out_cap=cap, max_units=max_units,
            multi_stream=True)
        if int(out_len) < cap:
            return np.asarray(out)[:int(out_len)].tobytes()
        cap *= 2
    return None


def _decompress(args) -> int:
    data = open(args.infile, "rb").read()
    if args.container or data[:4] == b"LZST":
        from .blocks import BlockCodec
        import struct
        block = struct.unpack_from("<I", data, 8)[0]
        span = struct.unpack_from("<H", data, 6)[0]
        out = BlockCodec(block=block, span=span).decompress(data)
    else:
        out = _decompress_raw_device(data)
        if out is None:
            from .stream import decompress_stream
            out = decompress_stream(data)
    open(args.outfile, "wb").write(out)
    if args.verbose:
        print(f"{len(data)} -> {len(out)} bytes", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lzs_tpu.cli", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("compress", _compress), ("decompress", _decompress)):
        p = sub.add_parser(name)
        p.add_argument("infile")
        p.add_argument("outfile")
        p.add_argument("--container", action="store_true",
                       help="block-parallel container framing")
        p.add_argument("--block", type=int, default=1 << 15,
                       help="block / feed size")
        p.add_argument("-v", "--verbose", action="store_true")
        p.set_defaults(fn=fn)
        if name == "compress":
            p.add_argument("--stream", action="store_true",
                           help="carried-window host path (one continuous "
                                "stream, byte-identical to the reference "
                                "incremental encoder)")
            p.add_argument("--blocks", action="store_true",
                           help="(default) raw concatenated per-block "
                                "streams via the device batch pipeline")
            p.add_argument("--lazy", action="store_true",
                           help="1-token-lookahead match selection "
                                "(usually smaller output; still a valid "
                                "LZS stream, decodable by the reference "
                                "decoder)")
        else:
            p.set_defaults(blocks=False, stream=False)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    return args.fn(args)


def main_compress(argv=None) -> int:
    """``lzs-compress INFILE OUTFILE`` — the reference's two-argument CLI
    contract (c/src/utils/lzs-compress.c:60-76)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return main(["compress"] + argv)


def main_decompress(argv=None) -> int:
    """``lzs-decompress INFILE OUTFILE`` (c/src/utils/lzs-decompress.c)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return main(["decompress"] + argv)


if __name__ == "__main__":
    raise SystemExit(main())
