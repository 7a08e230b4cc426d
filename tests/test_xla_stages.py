"""The plain-XLA device stages against the NumPy reference model.

Copy expansion (ops.expand), the bit packer (ops.bitpack) and the
container sync records (ops.encode), each against an independent host
form of the same contract; plus the compile-cache helper, the GPU
requirement of the measurement scripts, and one full-width parity check
that runs only on a card.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lzs_tpu import reference as ref
from lzs_tpu import spec
from lzs_tpu.ops import bitpack, decode, encode, expand
from lzs_tpu.utils import compile_cache, device

REPO = pathlib.Path(__file__).resolve().parent.parent


def _records(tokens):
    """Reference tokens -> packed parse records and the output length."""
    recs, opos = [], 0
    for tok in tokens:
        if tok[0] == "lit":
            recs.append((opos << 13) | tok[1])
            opos += 1
        elif tok[0] == "match":
            recs.append((opos << 13) | (1 << 11) | tok[1])
            opos += tok[2]
    return recs, opos


def _expand(rows, out_cap):
    width = max(len(r) for r, _ in rows)
    recs = np.full((len(rows), width), -1, np.int32)
    for b, (r, _) in enumerate(rows):
        recs[b, :len(r)] = r
    n = np.array([m for _, m in rows], np.int32)
    out, status = expand.expand_records(jnp.asarray(recs), jnp.asarray(n),
                                        out_cap)
    return np.asarray(out), np.asarray(status)


_RNG = np.random.default_rng(41)
EXPAND_CASES = {
    # copies of copies: every match reads bytes another match wrote,
    # offsets below the length (RLE and short periods) and far ones
    "deep_overlapped_chains": (
        [("lit", 65), ("match", 1, 300), ("lit", 66), ("match", 2, 517)]
        + [("match", 3 + 7 * k, 9 + k) for k in range(40)]
        + [("match", 1500, 1900), ("lit", 0), ("match", 2047, 2100)], 0),
    "data_then_long_period": (
        ref.compress(bytes(_RNG.integers(0, 256, 700, dtype=np.uint8))
                     + bytes(range(97, 124)) * 150)[:-1], 0),
    # offset 9 at output position 3: bytes before the block start read as
    # zero (lzs-decompression.c:348-357) and set status bit 1
    "source_before_block_start": (
        [("lit", 1), ("lit", 2), ("lit", 3), ("match", 9, 30),
         ("lit", 7), ("match", 2, 11)], 2),
}


@pytest.mark.parametrize("name", sorted(EXPAND_CASES))
def test_expand_matches_reference(name):
    tokens, want_status = EXPAND_CASES[name]
    want = ref.decompress(tokens)
    recs, n = _records(tokens)
    assert n == len(want)
    out, status = _expand([(recs, n)], 8192)
    assert out[0, :n].astype(np.uint8).tobytes() == want
    assert not out[0, n:].any()
    assert int(status[0]) == want_status


def test_expand_coverage_underrun():
    """Records that start past byte 0 leave a coverage gap: status bit 0,
    zeros in the gap, and the covered bytes still exact."""
    tokens = [("lit", 5), ("lit", 6), ("match", 2, 40), ("lit", 9)]
    recs, n = _records(tokens)
    want = ref.decompress(tokens)
    out, status = _expand([(recs[2:], n), (recs, n)], 256)
    assert int(status[0]) & 1 and int(status[1]) == 0
    assert out[1, :n].astype(np.uint8).tobytes() == want
    # the gap reads as zeros, and so does the copy of it
    np.testing.assert_array_equal(out[0, :n - 1], 0)
    assert out[0, n - 1] == 9


@pytest.mark.parametrize("engine", ["bits", "scan"])
def test_multi_stream_markers(engine):
    """Concatenated streams, empty ones included: each end marker leaves
    a zero-length record and the next stream continues at the next byte."""
    parts = [b"abcabcabc" * 20, b"", b"\x00" * 50, b"", b"xyz" * 3 + b"Q"]
    stream = b"".join(ref.lzs_compress(p) for p in parts)
    want = ref.lzs_decompress(stream, stop_at_end=False)
    assert want == b"".join(parts)
    buf = np.frombuffer(stream, np.uint8)
    out, out_len, markers = decode.decode_block(
        jnp.asarray(buf), jnp.int32(len(buf)), out_cap=1024,
        multi_stream=True, engine=engine)
    assert int(out_len) == len(want) and int(markers) == len(parts)
    assert np.asarray(out)[:len(want)].tobytes() == want


def _writer_bytes(units, end_marker):
    w = ref.BitWriter()
    for v, wd in units:
        w.put(int(v), int(wd))
    if end_marker:
        w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
    bits = w.bit_length
    w.pad_to_byte()
    return w.getvalue(), bits


def _widths(kind, m, rng):
    if kind == "max":
        return np.full(m, 25)
    if kind == "min":
        return np.ones(m, np.int64)
    if kind == "word_aligned":               # every unit ends on a word
        return np.tile([25, 7, 16, 16, 9, 23], m // 6 + 1)[:m]
    if kind == "sparse":                     # most positions emit nothing
        return np.where(rng.random(m) < 0.1, rng.integers(1, 26, m), 0)
    return rng.integers(0, 26, m)


@pytest.mark.parametrize("kind", ["max", "min", "word_aligned", "sparse",
                                  "mixed"])
@pytest.mark.parametrize("end_marker", [False, True])
def test_pack_matches_bitwriter(kind, end_marker):
    rng = np.random.default_rng(len(kind) + 7 * end_marker)
    b, m = 3, 600
    width = np.stack([_widths(kind, m, rng) for _ in range(b)]).astype(
        np.int32)
    value = (rng.integers(0, 1 << 25, (b, m))
             & ((1 << width) - 1)).astype(np.int32)
    cap = (25 * m + 9 + 7) // 8 + 8
    cap += -cap % 4
    em = (spec.END_MARKER_VALUE, spec.END_MARKER_BITS) if end_marker else None
    out, total, offs = map(np.asarray, bitpack.pack_bits_batch(
        jnp.asarray(value), jnp.asarray(width), cap, end_marker=em))
    for r in range(b):
        want, bits = _writer_bytes(zip(value[r], width[r]), end_marker)
        assert int(total[r]) == bits
        assert out[r, :len(want)].tobytes() == want
        assert not out[r, len(want):].any()
        np.testing.assert_array_equal(
            offs[r], np.cumsum(width[r]) - width[r])


def _host_sync(data, span, block):
    """(sync_bit, sync_out) of one block by walking the reference tokens:
    parse steps are token heads and every 6th extension nibble; slot l >=
    1 holds the last step starting before bit span * l."""
    steps, bit, opos = [], 0, 0
    for tok in ref.compress(data)[:-1]:
        steps.append((bit, opos))
        if tok[0] == "lit":
            bit += 9
            opos += 1
            continue
        _, off, length = tok
        bit += 1 + spec.offset_bits(off) + spec.LENGTH_CODE_WIDTH[
            min(length, spec.MAX_SHORT_LENGTH)]
        if length >= spec.MAX_SHORT_LENGTH:
            for t in range((length - spec.MAX_SHORT_LENGTH) // 15 + 1):
                if t % encode.NIBBLES_PER_STEP == 0:
                    rec = opos + spec.MAX_SHORT_LENGTH + 15 * t
                    steps.append((bit, rec | (1 << 17) | (off << 18)))
                bit += 4
        opos += length
    end_bits, nslots = bit, encode.sync_slots(block, span)
    nsync = -(-end_bits // span)
    sb, so = [end_bits] * nslots, [len(data)] * nslots
    for slot in range(min(nsync, nslots)):
        last = max((s for s in steps if s[0] < span * slot),
                   default=(0, 0))
        sb[slot], so[slot] = last
    return np.array(sb), np.array(so), nsync


@pytest.mark.parametrize("span", [128, 2048])
def test_sync_records_match_contract(span):
    rng = np.random.default_rng(span)
    block = 4096
    datas = [
        bytes(rng.integers(97, 100, block, dtype=np.uint8)),
        b"Z" * 3000 + bytes(rng.integers(0, 256, 500, dtype=np.uint8)),
        bytes(rng.integers(0, 256, 2047, dtype=np.uint8)) * 2,
        b"",
    ]
    x = np.zeros((len(datas), block), np.uint8)
    for i, d in enumerate(datas):
        x[i, :len(d)] = np.frombuffer(d, np.uint8)
    lens = np.array([len(d) for d in datas], np.int32)
    _, _, sbit, sout, nsync = map(np.asarray, encode.encode_batch_sync(
        jnp.asarray(x), jnp.asarray(lens), span=span))
    for i, d in enumerate(datas):
        wb, wo, wn = _host_sync(d, span, block)
        assert int(nsync[i]) == wn
        np.testing.assert_array_equal(sbit[i, :len(wb)], wb)
        np.testing.assert_array_equal(sout[i, :len(wo)], wo)


def test_compile_cache_honours_environment():
    class Config:
        def __init__(self):
            self.set = {}

        def update(self, key, value):
            self.set[key] = value

    cfg = Config()
    assert compile_cache.enable(cfg, {compile_cache.ENV: "/x"}) == "/x"
    assert cfg.set == {}
    path = compile_cache.enable(cfg, {})
    assert path == str(REPO / ".jax_cache")
    assert cfg.set["jax_compilation_cache_dir"] == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_require_gpu_raises_without_one():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_chip_smoke_fails_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result off the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "no GPU" in run.stderr


@pytest.mark.gpu
def test_full_width_parity_on_gpu(gpu):
    """Compiled encode at (256, 32768) on the card: every block's stream
    equals the native C++ encoder's."""
    sys.path.insert(0, str(REPO))
    import bench
    from lzs_tpu.blocks import BlockCodec, pad_blocks
    from lzs_tpu.utils import native

    data = bench.make_corpus(1 << 23)
    x, lens = pad_blocks(data, 1 << 15)
    comp, clens = BlockCodec().encode_batch(jnp.asarray(x),
                                            jnp.asarray(lens))[:2]
    comp, clens = np.asarray(comp), np.asarray(clens)
    for b in range(len(lens)):
        piece = x[b, :lens[b]].tobytes()
        assert comp[b, :clens[b]].tobytes() == native.compress(piece)
