"""Batched sort-based match search against the exhaustive oracle.

The windowed brute-force kernel (ops.match, the analogue of
lzs_simple_compress's O(N*W) scan) and the sort-based search must pick
the same capped score and nearest offset at every position.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lzs_tpu.ops import sortmatch


def _mixed_corpus(rng, npos):
    kinds = [
        lambda: (rng.integers(0, 4, npos) + 97),          # tiny alphabet
        lambda: np.tile(rng.integers(0, 256, 16), npos // 16 + 1)[:npos],
        lambda: rng.integers(0, 256, npos),                # random
        lambda: np.repeat(rng.integers(0, 256, npos // 64 + 1),
                          64)[:npos],                      # RLE runs
    ]
    return kinds[rng.integers(0, len(kinds))]().astype(np.int32)


def _assert_matches_exhaustive(x, n):
    """Batched sort-based candidates == the exhaustive kernel's choices."""
    from lzs_tpu.ops import match

    sj, nj = jnp.asarray(x), jnp.asarray(n)
    gs, go = map(np.asarray, jax.jit(jax.vmap(sortmatch.candidates))(
        sj, nj))
    ws, wo, _ = map(np.asarray, jax.jit(jax.vmap(
        lambda a, m: match.best_matches(a, m)))(sj, nj))
    # scores below MIN_MATCH mean "no match" in both (see
    # test_exhaustive_backend_matches_sort_backend)
    gm, wm = gs >= 2, ws >= 2
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(np.where(gm, gs, 0), np.where(wm, ws, 0))
    np.testing.assert_array_equal(np.where(gm, go, 0), np.where(wm, wo, 0))


@pytest.mark.parametrize("npos", [4096, 8192])
def test_candidates_batch_matches_oracle(npos):
    rng = np.random.default_rng(npos)
    b = 4
    x = np.stack([_mixed_corpus(rng, npos) for _ in range(b)])
    n = np.array([npos, npos - 17, npos // 2 + 3, 5], np.int32)
    for i in range(b):
        x[i, n[i]:] = 0
    _assert_matches_exhaustive(x, n)


def test_best_matches_batch_matches_oracle():
    rng = np.random.default_rng(7)
    npos, b = 4096, 3
    x = np.stack([_mixed_corpus(rng, npos) for _ in range(b)])
    n = np.array([npos, npos - 1, 2048], np.int32)
    for i in range(b):
        x[i, n[i]:] = 0
    sj, nj = jnp.asarray(x), jnp.asarray(n)
    got = jax.jit(sortmatch.best_matches_batch)(sj, nj)
    want = jax.jit(jax.vmap(
        lambda a, m: sortmatch.best_matches(a, m)))(sj, nj)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_candidates_batch_small_block_fallback():
    rng = np.random.default_rng(11)
    x = (rng.integers(0, 8, (2, 1024)) + 60).astype(np.int32)
    n = np.array([1024, 700], np.int32)
    x[1, 700:] = 0
    _assert_matches_exhaustive(x, n)


def test_exhaustive_backend_matches_sort_backend():
    """C5 pinning: the brute-force windowed-compare kernel (ops.match,
    the analogue of lzs_simple_compress's O(N*W) scan,
    lzs-compression-simple.c:266-278) must agree with the sort-based
    search at every position, and encode_block(backend="exhaustive")
    must emit identical bytes."""
    from lzs_tpu.ops import match
    from lzs_tpu.ops.encode import encode_block

    rng = np.random.default_rng(23)
    npos = 2048
    for seed in range(3):
        r = np.random.default_rng(seed)
        x = _mixed_corpus(r, npos)
        n = npos - int(r.integers(0, 64))
        x[n:] = 0
        sj, nj = jnp.asarray(x), jnp.int32(n)
        es, eo, ef = map(np.asarray, match.best_matches(sj, nj))
        ss, so, sf = map(np.asarray, sortmatch.best_matches(sj, nj))
        # scores below MIN_MATCH are "no match" — the kernels encode
        # them differently (0 vs degenerate 1-byte runs) and emission
        # ignores both, so normalize before comparing
        em, sm = es >= 2, ss >= 2
        np.testing.assert_array_equal(em, sm)
        np.testing.assert_array_equal(np.where(em, es, 0),
                                      np.where(sm, ss, 0))
        np.testing.assert_array_equal(np.where(em, eo, 0),
                                      np.where(sm, so, 0))
        np.testing.assert_array_equal(np.where(em, ef, 0),
                                      np.where(sm, sf, 0))

    x = _mixed_corpus(rng, npos)
    sj, nj = jnp.asarray(x), jnp.int32(npos)
    ce, ne = encode_block(sj, nj, backend="exhaustive")
    cs, ns = encode_block(sj, nj, backend="sort")
    assert int(ne) == int(ns)
    np.testing.assert_array_equal(np.asarray(ce), np.asarray(cs))


def test_emission_units_batch_matches_vmapped():
    """Batched emission units, written out unit by unit with the
    reference BitWriter, must give the reference encoder's stream."""
    from lzs_tpu import reference, spec
    from lzs_tpu.ops import tokenize

    rng = np.random.default_rng(12)
    b, npos = 3, 2048
    kinds = [lambda: rng.integers(97, 101, npos),
             lambda: np.repeat(rng.integers(0, 256, npos // 32),
                               32)[:npos],
             lambda: rng.integers(0, 256, npos)]
    x = np.stack([kinds[i % 3]().astype(np.int32) for i in range(b)])
    n = np.array([npos, npos - 13, 901], np.int32)
    for i in range(b):
        x[i, n[i]:] = 0
    sj, nj = jnp.asarray(x), jnp.asarray(n)
    score, off, full = jax.jit(sortmatch.best_matches_batch)(sj, nj)
    value, width, _, _ = map(np.asarray, jax.jit(jax.vmap(
        tokenize.emission_units))(sj, nj, score, off, full))
    for r in range(b):
        w = reference.BitWriter()
        for v, wd in zip(value[r], width[r]):
            w.put(int(v), int(wd))
        w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
        w.pad_to_byte()
        data = x[r, :n[r]].astype(np.uint8).tobytes()
        assert w.getvalue() == reference.lzs_compress(data)


def test_pext_scan_kernels_match_xla():
    """The row scans the pipeline uses (running max, reverse running
    min, prefix sum along the last axis) against NumPy."""
    rng = np.random.default_rng(31)
    for b, w in ((8, 1024), (3, 512), (4, 4096)):
        v = rng.integers(-1000, 1000, (b, w)).astype(np.int32)
        vj = jnp.asarray(v)
        np.testing.assert_array_equal(
            np.asarray(jax.lax.cummax(vj, axis=1)),
            np.maximum.accumulate(v, axis=1))
        np.testing.assert_array_equal(
            np.asarray(jax.lax.cummin(vj, axis=1, reverse=True)),
            np.minimum.accumulate(v[:, ::-1], axis=1)[:, ::-1])
        np.testing.assert_array_equal(
            np.asarray(jnp.cumsum(vj, axis=1)), np.cumsum(v, axis=1))
