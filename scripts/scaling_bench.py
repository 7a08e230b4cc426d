"""Sharding overhead on a virtual CPU mesh (1 -> 2 -> 4 -> 8 devices).

Fixed work PER DEVICE, the shard_map + all_gather pipeline from
parallel.dist, best-of-reps timing. The N virtual CPU devices share the
host's physical cores, so the raw wall ratio t_1/t_N conflates sharding
overhead with plain core contention, and nothing here says how the mesh
behaves on GPUs and NVLink. The JSON line therefore reports:

  efficiency_raw   = t_1 / t_N                  (ideal 1.0 only if the
                                                 host had >= N free cores)
  efficiency       = t_1 * max(1, N/ncores) / t_N
                     (vs the core-bound ideal: N devices on C cores can at
                      best run N/C times longer under N-times the work)
  speedup_vs_single_program = t_single(N*W) / t_N
                     (MEASURED reference: the same TOTAL workload run as
                      one unsharded single-device program on this host —
                      it shares the cores exactly like the mesh run does,
                      so any gap is pure sharding/collective overhead,
                      which is what a real N-chip mesh would add on top
                      of per-chip compute)

Usage: python scripts/scaling_bench.py [--per-dev-blocks N] [--block N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-dev-blocks", type=int, default=32)
    ap.add_argument("--block", type=int, default=1 << 15)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()

    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from lzs_tpu.utils import compile_cache
    compile_cache.enable()
    from lzs_tpu.parallel import dist
    from lzs_tpu.ops import decode2 as dec2_ops
    from lzs_tpu.ops import encode as enc_ops

    rng = np.random.default_rng(5)
    rows = []
    for ndev in (1, 2, 4, 8):
        mesh = dist.make_block_mesh(jax.devices()[:ndev])
        nblocks = args.per_dev_blocks * ndev
        x = rng.integers(0, 256, (nblocks, args.block), dtype=np.uint8)
        x[:, args.block // 4: args.block // 2] = 65
        n = np.full(nblocks, args.block, np.int32)
        enc = dist.encode_sharded(mesh, args.block, chunk=1024)
        dec = dist.decode_sharded(mesh, args.block)

        # no-collective variant: same local pipelines, results left
        # sharded (out_specs=P(axis)) — the wall difference is the
        # all-gather share of the step
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P
        enc_local = enc_ops.make_encoder(args.block, chunk=1024, sync=True)
        dec_local = dec2_ops.make_decoder_sync(
            enc_ops.cap_bytes(args.block), args.block)
        in_s = NamedSharding(mesh, P(dist.AXIS))
        enc_ng = jax.jit(shard_map(
            lambda a, b: enc_local(a, b), mesh=mesh,
            in_specs=(P(dist.AXIS),) * 2, out_specs=P(dist.AXIS),
            check_vma=False))
        dec_ng = jax.jit(shard_map(
            lambda c, sb, so, m: dec_local(c, sb, so, m), mesh=mesh,
            in_specs=(P(dist.AXIS),) * 4, out_specs=P(dist.AXIS),
            check_vma=False))

        def run():
            comp, clens, sbit, sout, nsync = enc(jnp.asarray(x),
                                                 jnp.asarray(n))
            out = dec(comp, sbit, sout, jnp.asarray(n))
            jax.block_until_ready(out)
            return out

        def run_ng():
            xs = jax.device_put(jnp.asarray(x), in_s)
            ns = jax.device_put(jnp.asarray(n), in_s)
            comp, clens, sbit, sout, nsync = enc_ng(xs, ns)
            out = dec_ng(comp, sbit, sout, ns)
            jax.block_until_ready(out)
            return out

        # calibration: the same TOTAL work as ONE unsharded program on
        # device 0 — the measured contention reference curve
        def run_single():
            comp, clens, sbit, sout, nsync = enc_local(jnp.asarray(x),
                                                       jnp.asarray(n))
            out = dec_local(comp, sbit, sout, jnp.asarray(n))
            jax.block_until_ready(out)
            return out

        out = run()                                   # compile + correctness
        assert bytes(np.asarray(out)[0]) == bytes(x[0])
        run_ng()
        run_single()
        best = float("inf")
        best_ng = float("inf")
        best_1 = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
            t0 = time.perf_counter()
            run_ng()
            best_ng = min(best_ng, time.perf_counter() - t0)
            t0 = time.perf_counter()
            run_single()
            best_1 = min(best_1, time.perf_counter() - t0)
        share = max(0.0, (best - best_ng) / best)
        rows.append({"devices": ndev, "blocks": nblocks,
                     "bytes": int(nblocks * args.block),
                     "per_device_bytes": int(args.per_dev_blocks
                                             * args.block),
                     "wall_s": round(best, 4),
                     "wall_no_gather_s": round(best_ng, 4),
                     "wall_single_dev_s": round(best_1, 4),
                     "collective_share": round(share, 3)})
        print(f"{ndev} devices: {nblocks} blocks, {best*1e3:.1f} ms "
              f"(no-gather {best_ng*1e3:.1f} ms, single-dev same work "
              f"{best_1*1e3:.1f} ms, collective share {share:.1%})",
              file=sys.stderr)

    ncores = os.cpu_count() or 1
    t1 = rows[0]["wall_s"]
    for r in rows:
        n = r["devices"]
        r["efficiency_raw"] = round(t1 / r["wall_s"], 3)
        r["efficiency"] = round(t1 * max(1, n / ncores) / r["wall_s"], 3)
        r["speedup_vs_single_program"] = round(
            r["wall_single_dev_s"] / r["wall_s"], 3)
    print(f"host cores: {ncores}; speedup vs one unsharded program: "
          f"{[r['speedup_vs_single_program'] for r in rows]} "
          f"(model: {[r['efficiency'] for r in rows]}, "
          f"raw: {[r['efficiency_raw'] for r in rows]})", file=sys.stderr)
    print(json.dumps({"kind": "sharding_overhead_cpu_mesh",
                      "host_cores": ncores, "rows": rows}))


if __name__ == "__main__":
    main()
