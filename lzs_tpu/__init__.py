"""lzs_tpu — an LZS (ANSI X3.241-1994) compression codec in JAX for GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the reference
LZS implementation (cmcqueen/lzs-compression): bit-exact LZS round-trip,
block-parallel encode/decode on the device, streaming/incremental APIs
with carried window state, generalized offset/length coders, a native
C++ host runtime, and multi-device scaling via jax.sharding. See
PARITY.md for the component-by-component mapping to the reference.

Layering (mirrors SURVEY.md section 1):
  spec.py        wire-format constants (L1)
  reference.py   executable NumPy specification / oracle (L2 spec)
  coders.py      generalized pluggable offset/length coders + the
                 GeneralCodec pipeline (P4/P5/P6 parity)
  ops/           XLA compute path (L2 device):
                   sortmatch.py  sort-based nearest-k-gram match search
                   match.py      exhaustive windowed-compare search
                   tokenize.py   greedy token chain + emission units
                   bitpack.py    prefix-sum parallel bit packing
                   encode.py     full encode pipeline (+ sync metadata)
                   decode.py     raw-stream decode (reference semantics)
                   decode2.py    sync-parallel container decoder
                   bitpar.py     per-bit parallel raw-stream parse
                   expand.py     pointer-doubling copy expansion
  blocks.py      multi-block batch API + container framing (L3)
  stream.py      incremental/streaming API with carried state (L3)
  parallel/      device-mesh sharding and ordered all-gather collectives
  models/        named codec profiles
  utils/         native C++ runtime bindings, observability/debug
  cli.py         file-to-file compress/decompress (L4)
"""

from .spec import LzsConfig, DEFAULT_CONFIG, compressed_max
from .reference import lzs_compress, lzs_decompress

__version__ = "0.2.0"

__all__ = [
    "LzsConfig",
    "DEFAULT_CONFIG",
    "compressed_max",
    "lzs_compress",
    "lzs_decompress",
    "BlockCodec",
    "StreamCompressor",
    "StreamDecompressor",
    "GeneralCodec",
]


def __getattr__(name):
    # lazy imports so `import lzs_tpu` stays light (no jax requirement)
    if name == "BlockCodec":
        from .blocks import BlockCodec
        return BlockCodec
    if name in ("StreamCompressor", "StreamDecompressor"):
        from . import stream
        return getattr(stream, name)
    if name == "GeneralCodec":
        from .coders import GeneralCodec
        return GeneralCodec
    raise AttributeError(name)
