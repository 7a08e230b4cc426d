"""Parity tests for the pointer-doubling token walk (tokenize.token_starts).

The oracle is a host-side sequential walk (the reference algorithm's
chain, lzs-compression.c:301-448 consumes tokens one at a time).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lzs_tpu.ops import tokenize


def host_walk(step, n):
    starts = np.zeros(step.shape[0], bool)
    i = 0
    while i < n:
        starts[i] = True
        i += max(int(step[i]), 1)
    return starts


@pytest.mark.parametrize("seed,npos", [(0, 256), (1, 1024), (2, 2048)])
def test_pwalk_matches_host_walk(seed, npos):
    rng = np.random.default_rng(seed)
    b = 4
    step = rng.integers(1, 9, (b, npos)).astype(np.int32)
    for _ in range(npos // 16):
        bb, ii = rng.integers(0, b), rng.integers(0, npos)
        step[bb, ii] = rng.integers(1, npos // 2)
    n = np.array([npos, npos - 7, npos // 2 + 1, 1], np.int32)
    got = np.asarray(jax.vmap(tokenize.token_starts)(
        jnp.asarray(step), jnp.asarray(n)))
    want = np.stack([host_walk(step[i], n[i]) for i in range(b)])
    np.testing.assert_array_equal(got, want)


def test_token_starts_vmap_dispatch():
    """vmapped token_starts must agree with per-block calls."""
    rng = np.random.default_rng(4)
    b, npos = 5, 512
    step = rng.integers(1, 30, (b, npos)).astype(np.int32)
    n = np.full(b, npos, np.int32)
    batched = np.asarray(jax.vmap(tokenize.token_starts)(
        jnp.asarray(step), jnp.asarray(n)))
    single = np.stack([
        np.asarray(tokenize.token_starts(jnp.asarray(step[i]),
                                         jnp.int32(n[i])))
        for i in range(b)])
    np.testing.assert_array_equal(batched, single)


def test_token_starts_wide_positions():
    """Chain walks past position 65535 (the raw-stream bit walk runs at
    ~300 K positions)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from lzs_tpu.ops import tokenize

    rng = np.random.default_rng(3)
    n = 128 * 1024          # 131072 positions > 2^16
    step = rng.integers(1, 30, (2, n)).astype(np.int32)
    lens = np.array([n, n - 777], np.int32)
    got = np.asarray(jax.vmap(tokenize.token_starts)(
        jnp.asarray(step), jnp.asarray(lens)))
    for b in range(2):
        ref = np.zeros(n, bool)
        pos = 0
        while pos < lens[b]:
            ref[pos] = True
            pos += max(int(step[b, pos]), 1)
        assert np.array_equal(got[b], ref)
