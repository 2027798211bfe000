"""Per-layer roofline of the 416²/81-class int8 detect trunk.

For every conv layer of the quantized mobilenet trunk + neck + YOLO head
(quant.build_layer_graph order, exactly as the shipped chained-int8 path
executes them — including each layer's dequant→bias→act→requant epilogue),
this tool:

  1. delta-times the layer in ISOLATION at the operating point's true input
     shape/dtype/scale (scan-chained iterations with a data dependence, the
     bench.py harness);
  2. times an int8 GEMM of the identical contraction shape
     (M = B·Ho·Wo, K = kh·kw·Cin, N = Cout) — the layer's shape-specific
     ceiling, with no patch extraction or epilogue;
  3. reports µs/img, GFLOP/img, effective TOP/s, and the ratio to the
     same-shape GEMM (dense convs) or achieved GB/s (depthwise layers,
     which are bandwidth- not FLOPs-bound).

A final row chains the ENTIRE trunk+neck+yolo to show what XLA's
cross-layer fusion buys vs the sum of isolated layers.

Run: python tools/profile_layers_416.py [--batch 128] [--layers a,b,...]
Prints one JSON line per layer.  Reference for the stack being profiled:
/root/reference/myolo/model.py:249-292 (mobilenet_graph + yolo_branch_graph).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _delta_time(call, n1, n2, reps=5):
    """Median delta-per-iteration between n2- and n1-iteration runs."""
    float(call(n1))
    float(call(n2))
    deltas = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(call(n1))
        t1 = time.perf_counter()
        float(call(n2))
        t2 = time.perf_counter()
        dt = (t2 - t1) - (t1 - t0)
        if dt > 0:
            deltas.append(dt / (n2 - n1))
    if not deltas:
        raise RuntimeError("non-positive deltas")
    return float(np.median(deltas))


def _adaptive_time(make_call, t_guess=2e-3, target=0.35, n1=4, reps=5):
    """Pick the chain-length spread so the delta is ~`target` seconds of
    device time (well past the ~±10 ms RPC jitter), then measure."""
    spread = max(16, int(target / max(t_guess, 1e-7)))
    spread = min(spread, 4096)
    call = make_call()
    t = _delta_time(call, n1, n1 + spread, reps=2)
    # re-pick once if the guess was far off
    want = max(16, min(int(target / max(t, 1e-7)), 4096))
    if want > 2 * spread or want < spread // 2:
        spread = want
    return _delta_time(call, n1, n1 + spread, reps=reps)


def chain_layer(layer, x0, x_scale, out_scale):
    """Isolated-layer scan chain: executes `layer` exactly as the shipped
    chained-int8 path does (quant.run_layer_int8, incl. the requantize
    epilogue when out_scale is set)."""
    from mask_yolo_tpu import quant

    @functools.partial(jax.jit, static_argnums=(1,))
    def repeat(x, n):
        def body(carry, _):
            x, acc = carry
            y, _ = quant.run_layer_int8(layer, x, x_scale=x_scale,
                                        out_scale=out_scale)
            s = jnp.sum(y.astype(jnp.float32)) * jnp.float32(1e-9)
            if x.dtype == jnp.int8:
                x = jnp.clip(x.astype(jnp.int32) + (s * 0).astype(jnp.int32),
                             -127, 127).astype(jnp.int8)
            else:
                x = x + (s * jnp.float32(1e-30)).astype(x.dtype)
            return (x, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (x, jnp.float32(0)), None, length=n)
        return acc

    return lambda n: repeat(x0, n)


def chain_gemm(m, k, n):
    """Same-shape int8 GEMM ceiling: int8[M,K] @ int8[K,N] → int32."""
    rng = np.random.RandomState(0)
    a = jnp.asarray(rng.randint(-127, 128, (m, k)), jnp.int8)
    b = jnp.asarray(rng.randint(-127, 128, (k, n)), jnp.int8)

    @functools.partial(jax.jit, static_argnums=(2,))
    def repeat(a, b, steps):
        def body(carry, _):
            x, acc = carry
            y = jax.lax.dot_general(x, b, (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32)
            s = jnp.sum(y.astype(jnp.float32)) * jnp.float32(1e-12)
            x = jnp.clip(x.astype(jnp.int32) + (s * 0).astype(jnp.int32),
                         -127, 127).astype(jnp.int8)
            return (x, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (a, jnp.float32(0)), None,
                                   length=steps)
        return acc

    return lambda steps: repeat(a, b, steps)


def chain_whole(graph, x0):
    """The real trunk topology (quant._trunk_outputs): neck AND yolo both
    consume C4, the trunk output."""
    from mask_yolo_tpu import quant

    @functools.partial(jax.jit, static_argnums=(1,))
    def repeat(x, n):
        def body(carry, _):
            x, acc = carry
            raw, fmap = quant._trunk_outputs(graph, x, quant=True)
            s = (jnp.sum(raw.astype(jnp.float32))
                 + jnp.sum(fmap.astype(jnp.float32))) * jnp.float32(1e-9)
            x = x + s * jnp.float32(1e-30)
            return (x, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (x, jnp.float32(0)), None, length=n)
        return acc

    return lambda n: repeat(x0, n)


def chain_prefix(layers, x0):
    """Scan chain over the first N layers (the chain-update overhead on the
    fixed f32 input is constant across prefixes, so successive deltas give
    each layer's TRUE marginal cost in the fused program context)."""
    from mask_yolo_tpu import quant

    @functools.partial(jax.jit, static_argnums=(1,))
    def repeat(x, n):
        def body(carry, _):
            x, acc = carry
            y = quant.run_layers(layers, x, quant=True)
            s = jnp.sum(y.astype(jnp.float32)) * jnp.float32(1e-9)
            x = x + s * jnp.float32(1e-30)
            return (x, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (x, jnp.float32(0)), None, length=n)
        return acc

    return lambda n: repeat(x0, n)


def run_prefix_mode(graph, cfg, b, rng):
    """Marginal (fused-context) cost per layer from prefix deltas."""
    h, w = cfg.IMAGE_SHAPE[:2]
    x_img = jnp.asarray(rng.rand(b, h, w, 3).astype(np.float32))

    def part_rows(layers, x0, part):
        prev = 0.0
        # append a terminal f32 cast "layer" cost? not needed: run_layers on
        # a prefix ends at that layer's f32 output (out_scale=None for the
        # last), slightly different from mid-chain int8 output — noted in
        # the row as 'prefix semantics'
        for i in range(1, len(layers) + 1):
            t = _adaptive_time(lambda: chain_prefix(layers[:i], x0),
                               t_guess=max(prev, 5.0) * 1e-6 * b * 1.2)
            us = t / b * 1e6
            print(json.dumps({"prefix": f"{part}:{layers[i-1].name}",
                              "cum_us_per_img": round(us, 2),
                              "marginal_us_per_img":
                                  round(us - prev, 2)}), flush=True)
            prev = us

    part_rows(graph["trunk"], x_img, "trunk")
    # neck and yolo both consume C4; feed a realistic C4-shaped f32 input
    c4_hw = (math.ceil(h / 8), math.ceil(w / 8))
    c4 = jnp.asarray(rng.rand(b, *c4_hw, 512).astype(np.float32) * 6.0)
    part_rows(graph["neck"], c4, "neck")
    part_rows(graph["yolo"], c4, "yolo")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--layers", default=None,
                    help="comma-separated layer-name filter (default: all)")
    ap.add_argument("--skip-gemm", action="store_true")
    ap.add_argument("--skip-whole", action="store_true")
    ap.add_argument("--prefix", action="store_true",
                    help="marginal in-context costs from prefix deltas "
                         "instead of isolated layers")
    args = ap.parse_args()

    from mask_yolo_tpu import quant
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.models.network import MaskYoloNet

    cfg = CocoStyleConfig()
    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE,
                      compute_dtype=cfg.COMPUTE_DTYPE,
                      image_hw=tuple(cfg.IMAGE_SHAPE[:2]))
    variables = jax.jit(lambda r, i, ro: net.init(r, i, ro, train=False))(
        jax.random.PRNGKey(0),
        jnp.zeros((1, *cfg.IMAGE_SHAPE), jnp.float32),
        jnp.zeros((1, 8, 4), jnp.float32))
    calib = np.random.RandomState(1).rand(4, *cfg.IMAGE_SHAPE).astype(np.float32)
    det = quant.QuantizedDetector.from_variables(jax.device_get(variables),
                                                 cfg, calib)
    graph = det.graph

    if args.prefix:
        run_prefix_mode(graph, cfg, args.batch, np.random.RandomState(0))
        return

    b = args.batch
    h, w = cfg.IMAGE_SHAPE[:2]
    only = set(args.layers.split(",")) if args.layers else None
    rng = np.random.RandomState(0)

    # walk each part's chain to derive every layer's input shape/dtype/scale
    # — mirrors quant.run_layers' inter-layer int8 policy. Topology
    # (quant._trunk_outputs): trunk consumes the image; neck AND yolo both
    # consume C4 (the trunk output), each as its own f32-entry chain.
    def walk(layers, hw, cin):
        scale = None
        rows = []
        for i, layer in enumerate(layers):
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            out_scale = (nxt.a_scale if nxt is not None
                         and quant._scale_ok(nxt.a_scale) else None)
            kh, kw, _, ko = np.asarray(layer.kernel).shape
            cout = ko  # dw kernels are [kh, kw, 1, C] → O == C
            ho = math.ceil(hw[0] / layer.strides[0])
            wo = math.ceil(hw[1] / layer.strides[1])
            rows.append(dict(layer=layer, in_hw=hw, cin=cin,
                             out_hw=(ho, wo), cout=cout, kh=kh, kw=kw,
                             in_scale=scale, out_scale=out_scale))
            hw, cin, scale = (ho, wo), cout, out_scale
        assert scale is None  # each part ends in an f32 output layer
        return rows, hw, cin

    rows, c4_hw, c4_c = walk(graph["trunk"], (h, w), 3)
    neck_rows, _, _ = walk(graph["neck"], c4_hw, c4_c)
    yolo_rows, _, _ = walk(graph["yolo"], c4_hw, c4_c)
    rows += neck_rows + yolo_rows

    sum_us = 0.0
    for r in rows:
        layer = r["layer"]
        if only and layer.name not in only:
            continue
        hw_in, cin = r["in_hw"], r["cin"]
        if r["in_scale"] is not None:
            x0 = jnp.asarray(rng.randint(-127, 128, (b, *hw_in, cin)),
                             jnp.int8)
        else:
            x0 = jnp.asarray(rng.rand(b, *hw_in, cin).astype(np.float32))
        # FLOPs (MAC*2) of the conv contraction
        m = b * r["out_hw"][0] * r["out_hw"][1]
        if layer.groups == 1:
            kdim = r["kh"] * r["kw"] * cin
            n_dim = r["cout"]
        else:  # depthwise: per-channel kh*kw dot
            kdim = r["kh"] * r["kw"]
            n_dim = 1
        flops = 2.0 * m * kdim * n_dim * (r["cout"] if layer.groups > 1 else 1)
        out = {"layer": layer.name, "kind": layer.kind,
               "in": [*hw_in, cin], "out": [*r["out_hw"], r["cout"]],
               "stride": layer.strides[0],
               "int8": bool(layer.quantize and layer.w_q is not None),
               "gflop_per_img": round(flops / b / 1e9, 3)}
        try:
            t = _adaptive_time(lambda: chain_layer(layer, x0, r["in_scale"],
                                                   r["out_scale"]))
            us_img = t / b * 1e6
            sum_us += us_img
            out["us_per_img"] = round(us_img, 2)
            out["eff_tops"] = round(flops / t / 1e12, 1)
            # achieved memory bandwidth (in + out tensors; int8=1B, f32=4B)
            in_b = 1 if r["in_scale"] is not None else 4
            out_b = 1 if r["out_scale"] is not None else 4
            byts = b * (hw_in[0] * hw_in[1] * cin * in_b
                        + r["out_hw"][0] * r["out_hw"][1] * r["cout"] * out_b)
            out["gbps"] = round(byts / t / 1e9, 1)
            if (not args.skip_gemm and layer.groups == 1 and out["int8"]):
                tg = _adaptive_time(lambda: chain_gemm(m, kdim, n_dim),
                                    t_guess=t)
                out["gemm_us_per_img"] = round(tg / b * 1e6, 2)
                out["gemm_tops"] = round(flops / tg / 1e12, 1)
                out["pct_of_gemm"] = round(100.0 * tg / t, 1)
        except Exception as e:
            out["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(out), flush=True)

    if not args.skip_whole and not only:
        x0 = jnp.asarray(rng.rand(b, h, w, 3).astype(np.float32))
        t = _adaptive_time(lambda: chain_whole(graph, x0), t_guess=8e-3)
        print(json.dumps({"layer": "WHOLE_TRUNK", "us_per_img":
                          round(t / b * 1e6, 2),
                          "sum_isolated_us_per_img": round(sum_us, 2)}),
              flush=True)


if __name__ == "__main__":
    main()
