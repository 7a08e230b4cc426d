"""Adversarial parity checks of the compiled device codec.

Every case is (1) encoded on the device and compared byte for byte with
the NumPy reference model (itself pinned to the C encoder by the test
suite), (2) container-decoded on the device back to the input, and (3)
raw-decoded on the device back to the input: three checks per case, one
batch shape, three compilations.
"""

from __future__ import annotations

import numpy as np

BLOCK = 4096


def cases() -> list[bytes]:
    """Adversarial parity cases for the compiled device kernels.

    Mirrors the reference's four decoder harnesses and closed-form
    property tests (test-lzs.c:93-167, test-lzs-decompression.c:106-290)
    plus the failure shapes found during development: steal-heavy small
    alphabets, RLE run ends, deep overlapped-copy chains, the exact
    window limit, and block-capacity edges.
    """
    rng = np.random.default_rng(404)
    cases: list[bytes] = [b"", b"A", b"AB", b"ABAB" * 3]
    # repeated-byte closed-form family (extension-nibble chains + RLE)
    for k in (1, 7, 8, 9, 22, 23, 37, 300, 2047, 2048, 4095, 4096):
        cases.append(b"X" * k)
    # no-repeated-2-gram sequence: literals only, exact 9/8 expansion
    seq = bytearray()
    for i in range(1, 250):
        seq += bytes([0, i])
    cases.append(bytes(seq[:506]))
    # steal-heavy tiny alphabets and periodic data with perturbed tails
    for a in (2, 3, 4):
        cases.append(bytes(rng.integers(97, 97 + a, 4000,
                                        dtype=np.uint8)))
    cases.append((b"abcdefg" * 600)[:4000])
    cases.append((b"ab" * 2000)[:3999] + b"Q")
    # RLE run ends followed by near-miss tails
    cases.append(b"Q" * 2000 + b"QRQS" * 20 + b"Q" * 100)
    cases.append(b"\x00" * 3000 + b"\x01" + b"\x00" * 1000)
    # window-limit pins: match at exactly 2047, miss at 2048
    probe = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    cases.append(probe + b"\xAA" * (2047 - len(probe)) + probe)
    cases.append(probe + b"\xAA" * (2048 - len(probe)) + probe)
    # deep overlapped-copy chains (offset < length, repeated extension)
    cases.append(b"zy" + b"zy" * 1800)
    cases.append(b"abc" + b"abc" * 1300 + b"abd")
    # structured records with shared 12-byte prefixes (plateau chains)
    rec = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    cases.append(b"".join(
        rec[:12] + bytes([int(v)]) * 4
        for v in rng.integers(0, 256, 200)))
    # incompressible and mixed
    cases.append(bytes(rng.integers(0, 256, 4096, dtype=np.uint8)))
    cases.append(bytes(rng.integers(0, 256, 4093, dtype=np.uint8)))
    for _ in range(12):
        parts, total = [], 0
        while total < 3500:
            k = int(rng.integers(0, 4))
            if k == 0:
                parts.append(bytes([int(rng.integers(0, 256))])
                             * int(rng.integers(1, 400)))
            elif k == 1:
                parts.append(bytes(rng.integers(97, 103,
                                                int(rng.integers(10, 600)),
                                                dtype=np.uint8)))
            elif k == 2 and parts:
                prev = b"".join(parts)
                parts.append(prev[:int(rng.integers(0, min(len(prev),
                                                           900) + 1))])
            else:
                parts.append(bytes(rng.integers(0, 256,
                                                int(rng.integers(1, 300)),
                                                dtype=np.uint8)))
            total = sum(map(len, parts))
        cases.append(b"".join(parts)[:4096])
    return [c[:4096] for c in cases]


def run() -> tuple[int, int, list[str]]:
    """Run every case; returns (passed, total, failed check labels)."""
    import jax.numpy as jnp

    from . import reference
    from .ops import decode as dec_ops
    from .ops import decode2 as dec2_ops
    from .ops import encode as enc_ops

    cs = cases()
    while len(cs) % 8:
        cs.append(b"pad")
    x = np.zeros((len(cs), BLOCK), np.uint8)
    lens = np.zeros(len(cs), np.int32)
    for i, c in enumerate(cs):
        x[i, :len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    xj, nj = jnp.asarray(x), jnp.asarray(lens)
    comp, nbytes, sbit, sout, _ = enc_ops.encode_batch_sync(xj, nj)
    out_sync = dec2_ops.decode_batch_sync(comp, sbit, sout, nj,
                                          out_cap=BLOCK)[0]
    out_raw = dec_ops.decode_batch(comp, nbytes, out_cap=BLOCK)[0]
    comp_np, nbytes_np = np.asarray(comp), np.asarray(nbytes)
    out_sync_np, out_raw_np = np.asarray(out_sync), np.asarray(out_raw)

    passed = total = 0
    fails = []
    for i, c in enumerate(cs):
        got = comp_np[i, :nbytes_np[i]].tobytes()
        for label, ok in (
                ("enc", got == reference.lzs_compress(c)),
                ("dsync", out_sync_np[i, :len(c)].tobytes() == c),
                ("draw", out_raw_np[i, :len(c)].tobytes() == c)):
            total += 1
            if ok:
                passed += 1
            else:
                fails.append(f"{i}:{label}")
    return passed, total, fails
