"""Measured-peak microbenchmark: bf16 and int8 matmul rates and a large
copy on the attached device, via the same scan-chained delta harness as
bench.py. Spec-sheet peaks assume perfect shapes; these say what a plain
XLA program reaches on this card.

Run: python tools/bench_roofline.py [--size 4096] [--steps 32]
Prints one JSON line per dtype.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def make_chain(n_size: int, dtype):
    @functools.partial(jax.jit, static_argnums=(2,))
    def chain(a, b, n):
        def body(carry, _):
            x, acc = carry
            y = jax.lax.dot_general(
                x, b, (((1,), (0,)), ((), ())),
                preferred_element_type=(jnp.int32 if dtype == jnp.int8
                                        else jnp.float32))
            s = jnp.sum(y.astype(jnp.float32)) * jnp.float32(1e-12)
            # re-quantize/cast back so the chain stays in the bench dtype,
            # with a data dependence on the previous product
            if dtype == jnp.int8:
                x = jnp.clip(x.astype(jnp.int32)
                             + (s * 0).astype(jnp.int32), -127, 127
                             ).astype(jnp.int8)
            else:
                x = (x.astype(jnp.float32) + s * jnp.float32(1e-30)
                     ).astype(dtype)
            return (x, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (a, jnp.float32(0)), None, length=n)
        return acc
    return chain


def bench_dtype(dtype, size, n1=4, n2=20, reps=3):
    rng = np.random.RandomState(0)
    if dtype == jnp.int8:
        a = jnp.asarray(rng.randint(-127, 128, (size, size)), jnp.int8)
        b = jnp.asarray(rng.randint(-127, 128, (size, size)), jnp.int8)
    else:
        a = jnp.asarray(rng.randn(size, size), dtype)
        b = jnp.asarray(rng.randn(size, size), dtype)
    chain = make_chain(size, dtype)
    float(chain(a, b, n1))
    float(chain(a, b, n2))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(chain(a, b, n1))
        t1 = time.perf_counter()
        float(chain(a, b, n2))
        t2 = time.perf_counter()
        dt = (t2 - t1) - (t1 - t0)
        if dt > 0:
            best = min(best, dt / (n2 - n1))
    flops = 2.0 * size ** 3
    return flops / best


def bench_bandwidth(mbytes=256, n1=4, n2=20, reps=3):
    """Measured HBM bandwidth: scan-chained elementwise update of a large
    f32 array (each step reads + writes the whole array = 2x its bytes).
    Anchors the 'this DW conv is bandwidth-bound' rows in the r4 per-layer
    roofline the way the matmul probes anchor MFU."""
    n = mbytes * (1 << 20) // 4
    x0 = jnp.ones((n,), jnp.float32)

    @functools.partial(jax.jit, static_argnums=(1,))
    def chain(x, steps):
        def body(x, _):
            return x * jnp.float32(1.0000001), None
        x, _ = jax.lax.scan(body, x, None, length=steps)
        return jnp.sum(x[:1024])

    float(chain(x0, n1))
    float(chain(x0, n2))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(chain(x0, n1))
        t1 = time.perf_counter()
        float(chain(x0, n2))
        t2 = time.perf_counter()
        dt = (t2 - t1) - (t1 - t0)
        if dt > 0:
            best = min(best, dt / (n2 - n1))
    return 2.0 * n * 4 / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--dtypes", default="bfloat16,int8")
    ap.add_argument("--bandwidth-mb", type=int, default=256,
                    help="HBM probe array size in MB (0 = skip)")
    args = ap.parse_args()
    if args.bandwidth_mb:
        try:
            bw = bench_bandwidth(args.bandwidth_mb)
            print(json.dumps({"probe": "hbm_copy", "mb": args.bandwidth_mb,
                              "gbps": round(bw / 1e9, 1)}), flush=True)
        except Exception as e:
            print(json.dumps({"probe": "hbm_copy",
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
    for name in args.dtypes.split(","):
        dt = {"bfloat16": jnp.bfloat16, "int8": jnp.int8,
              "float32": jnp.float32}[name.strip()]
        try:
            rate = bench_dtype(dt, args.size)
            print(json.dumps({"dtype": name, "size": args.size,
                              "tops": round(rate / 1e12, 1)}), flush=True)
        except Exception as e:
            print(json.dumps({"dtype": name,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)


if __name__ == "__main__":
    main()
