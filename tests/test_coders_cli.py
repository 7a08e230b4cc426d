"""Generalized coder layer (lzs_tpu.coders) and CLI (lzs_tpu.cli) tests."""

import subprocess
import sys

import numpy as np
import pytest

from lzs_tpu import coders, reference
from test_stream import mixed_data

DATA = mixed_data(9, 8000)


def test_standard_codec_wire_compatible():
    codec = coders.STANDARD_CODEC
    blob = codec.compress_bytes(DATA)
    assert blob == reference.lzs_compress(DATA)
    assert codec.decompress_bytes(blob) == DATA


def test_standard_codec_golden_vector():
    from golden import GOLDEN_COMPRESSED, GOLDEN_PLAINTEXT
    codec = coders.STANDARD_CODEC
    assert codec.decompress_bytes(GOLDEN_COMPRESSED) == GOLDEN_PLAINTEXT


@pytest.mark.parametrize("offc", [
    coders.StandardOffsetCoder(7, 11),
    coders.StandardOffsetCoder(6, 10),
    coders.BiasedOffsetCoder(7, 11),
    coders.FixedOffsetCoder(12),
    coders.FixedOffsetCoder(9),
])
@pytest.mark.parametrize("lenc", sorted(coders.LENGTH_CODER_PRESETS))
def test_general_profiles_roundtrip(offc, lenc):
    codec = coders.GeneralCodec(offc, coders.LENGTH_CODER_PRESETS[lenc])
    data = DATA[:4000]
    blob = codec.compress_bytes(data)
    assert codec.decompress_bytes(blob) == data


def test_token_stages_compose():
    codec = coders.STANDARD_CODEC
    toks = codec.compress(DATA[:2000])
    blob = codec.encode(toks)
    toks2 = codec.decode(blob)
    assert toks == toks2
    assert codec.decompress(toks2) == DATA[:2000]


def test_gen_decompress_bounded_memory():
    codec = coders.STANDARD_CODEC
    toks = codec.compress(DATA[:3000])
    pieces = list(codec.gen_decompress(toks))
    assert b"".join(pieces) == DATA[:3000]


def test_cli_raw_roundtrip(tmp_path):
    src = tmp_path / "in.bin"
    comp = tmp_path / "out.lzs"
    back = tmp_path / "back.bin"
    src.write_bytes(DATA)
    from lzs_tpu import cli
    assert cli.main(["compress", str(src), str(comp)]) == 0
    assert comp.read_bytes() == reference.lzs_compress(DATA)
    assert cli.main(["decompress", str(comp), str(back)]) == 0
    assert back.read_bytes() == DATA


def test_cli_container_roundtrip(tmp_path):
    src = tmp_path / "in.bin"
    comp = tmp_path / "out.lzst"
    back = tmp_path / "back.bin"
    src.write_bytes(DATA)
    from lzs_tpu import cli
    assert cli.main(["compress", "--container", "--block", "4096",
                     str(src), str(comp)]) == 0
    assert comp.read_bytes()[:4] == b"LZST"
    assert cli.main(["decompress", str(comp), str(back)]) == 0
    assert back.read_bytes() == DATA


def test_cli_cross_reference(tmp_path, ref_driver):
    src = tmp_path / "in.bin"
    comp = tmp_path / "out.lzs"
    src.write_bytes(DATA[:5000])
    from lzs_tpu import cli
    cli.main(["compress", str(src), str(comp)])
    assert ref_driver("d", comp.read_bytes()) == DATA[:5000]
