"""XLA compute path for the LZS codec.

Pipeline stages (each stage is a pure, jittable function over fixed shapes):

  sortmatch.py sort-based per-position best-match table (the fast path)
  match.py     exhaustive windowed-compare best-match table (oracle)
  tokenize.py  greedy token chain via pointer doubling; per-position
               emission units and bit widths
  bitpack.py   MSB-first bit packing via prefix-summed offsets + scatter-add
  encode.py    full encode pipeline (bytes -> LZS stream) + sync records
  decode.py    raw-stream decode entry (bitpar, or the bit-parse scan)
  decode2.py   sync-parallel container decode
  bitpar.py    per-bit speculative parse of raw streams
  expand.py    pointer-doubling LZ77 copy expansion
"""

from .encode import encode_block, make_encoder
from .decode import decode_block, make_decoder

__all__ = ["encode_block", "make_encoder", "decode_block", "make_decoder"]
