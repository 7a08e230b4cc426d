"""Greedy-vs-lazy match policy sweep (BASELINE config 2).

Measures compressed sizes of the greedy policy (byte-identical to the
reference C encoder, pinned by tests) and the lazy 1-token-lookahead
policy on the frozen bench corpus plus any files named on the command
line (LAZY_SWEEP.json lists the reference implementation's own C and
Python sources). Prints a size table and a JSON summary line.

Usage: python scripts/lazy_sweep.py [FILE ...]
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np


def corpora(files):
    out = [(f.name, f.read_bytes()) for f in map(pathlib.Path, files)]
    from bench import make_corpus
    out.append(("bench_corpus_1MiB", make_corpus(1 << 20)))
    return out


def main() -> None:
    import jax.numpy as jnp

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from lzs_tpu.utils import compile_cache
    compile_cache.enable()
    from lzs_tpu.blocks import pad_blocks
    from lzs_tpu.ops import encode as enc_ops

    block = 1 << 15
    rows = []
    for name, data in corpora(sys.argv[1:]):
        x, lens = pad_blocks(data, block)
        xj, lj = jnp.asarray(x), jnp.asarray(lens)
        sizes = {}
        for policy in ("greedy", "lazy"):
            _, nbytes = enc_ops.encode_batch(xj, lj, policy=policy)
            sizes[policy] = int(np.asarray(nbytes).sum())
        rows.append((name, len(data), sizes["greedy"], sizes["lazy"]))
        print(f"{name:28s} {len(data):9d} B   greedy {sizes['greedy']:9d}"
              f"   lazy {sizes['lazy']:9d}   "
              f"({100 * sizes['lazy'] / max(sizes['greedy'], 1):.2f}% of "
              f"greedy)", file=sys.stderr)

    summary = {
        "corpus": [{"name": n, "raw": r, "greedy": g, "lazy": l}
                   for n, r, g, l in rows],
        "lazy_never_larger": all(l <= g for _, _, g, l in rows),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
