"""Cross-validation against the reference python implementation, run in
place as the live oracle (SURVEY.md section 4 implication (d)).

For every generalized coder profile that has a counterpart in
/root/reference/python/lzs.py (OffsetCoder1/1b/2 x LengthCoder1..8), a
stream encoded by the reference LZCMCoder must decode byte-exactly with our
GeneralCodec, and vice versa. The two compressors pick different (both
valid) matches, so conformance is decode-level, per SURVEY.md section 3.5.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from lzs_tpu.coders import (BiasedOffsetCoder, FixedOffsetCoder,
                            GeneralCodec, REFERENCE_LENGTH_CODERS,
                            StandardOffsetCoder)

REF_PATH = "/root/reference/python/lzs.py"


@pytest.fixture(scope="module")
def ref():
    if not pathlib.Path(REF_PATH).exists():
        pytest.skip("reference python implementation not available")
    spec_ = importlib.util.spec_from_file_location("ref_lzs", REF_PATH)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules["ref_lzs"] = mod
    spec_.loader.exec_module(mod)
    return mod


def _samples() -> list[bytes]:
    rng = np.random.default_rng(7)
    text = (b"the quick brown fox jumps over the lazy dog. " * 20
            + b"abcabcabcabcabc" * 8)
    return [
        b"",
        b"A",
        b"X" * 300,                                   # RLE + extension chain
        text,
        bytes(rng.integers(0, 256, 500, dtype=np.uint8)),   # incompressible
        (b"prefix-" + bytes(rng.integers(97, 123, 40, dtype=np.uint8))) * 30,
        b"ab" * 100 + b"ra" + b"abra" * 50,           # overlapping period 2/4
    ]


def _profiles(ref):
    """(name, ours, theirs) pairs for every matching coder combination."""
    out = []
    for lname, lcoder in REFERENCE_LENGTH_CODERS.items():
        out.append((f"std7/11+{lname}",
                    GeneralCodec(StandardOffsetCoder(7, 11), lcoder),
                    ref.LZCMCoder(ref.OffsetCoder1(7, 11),
                                  getattr(ref, f"LengthCoder{lname[2:]}")())))
    out.append(("biased7/11+lc1",
                GeneralCodec(BiasedOffsetCoder(7, 11),
                             REFERENCE_LENGTH_CODERS["lc1"]),
                ref.LZCMCoder(ref.OffsetCoder1b(7, 11), ref.LengthCoder1())))
    out.append(("fixed10+lc3",
                GeneralCodec(FixedOffsetCoder(10),
                             REFERENCE_LENGTH_CODERS["lc3"]),
                ref.LZCMCoder(ref.OffsetCoder2(10), ref.LengthCoder3())))
    out.append(("fixed12+lc8",
                GeneralCodec(FixedOffsetCoder(12),
                             REFERENCE_LENGTH_CODERS["lc8"]),
                ref.LZCMCoder(ref.OffsetCoder2(12), ref.LengthCoder8())))
    return out


def test_reference_decodes_our_streams(ref):
    for name, ours, theirs in _profiles(ref):
        for data in _samples():
            blob = ours.compress_bytes(data)
            got = theirs.decompress(theirs.decode(blob))
            assert got == data, f"{name}: reference failed on our stream"


def test_we_decode_reference_streams(ref):
    for name, ours, theirs in _profiles(ref):
        for data in _samples():
            blob = theirs.encode(theirs.compress(data))
            got = ours.decompress_bytes(blob)
            assert got == data, f"{name}: we failed on reference stream"


def test_token_level_equivalence_on_reference_stream(ref):
    """Our token decode of a reference stream must reproduce the reference
    token structure (folding their (None, n) continuations into lengths)."""
    theirs = ref.LZCMCoder(ref.OffsetCoder1(7, 11), ref.LengthCoder1())
    ours = GeneralCodec(StandardOffsetCoder(7, 11),
                        REFERENCE_LENGTH_CODERS["lc1"])
    data = b"X" * 100 + b"hello hello hello" * 5
    blob = theirs.encode(theirs.compress(data))
    ref_tokens = []
    for tok in theirs.decode(blob):
        if isinstance(tok, bytes):
            ref_tokens.append(("lit", tok[0]))
        else:
            off, ln = tok
            if off is None:
                ref_tokens[-1] = (ref_tokens[-1][0], ref_tokens[-1][1],
                                  ref_tokens[-1][2] + ln)
            else:
                ref_tokens.append(("match", -off, ln))
    ref_tokens.append(("end",))
    assert ours.decode(blob) == ref_tokens


def test_compressed_size_not_worse_than_reference(ref):
    """Our exhaustive-window policy must compress at least as well as the
    reference fragment-dict policy on every profile (BASELINE.json)."""
    for name, ours, theirs in _profiles(ref):
        for data in _samples():
            ours_len = len(ours.compress_bytes(data))
            theirs_len = len(theirs.encode(theirs.compress(data)))
            assert ours_len <= theirs_len, (
                f"{name}: {ours_len} > reference {theirs_len}")
