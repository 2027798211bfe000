"""Stage-level timing of the int8 infer_yolo pipeline at the 416²/81-class
operating point — the detection-only complement of tools/profile_stages_416.py,
isolating the 81-class NMS sweep.

Cumulative prefixes of the infer_yolo pipeline (pipelines.py
infer_yolo_from_callables), delta-timed with the bench.py harness; successive
differences isolate per-stage cost:

  trunk      int8 backbone + neck + YOLO head (raw grid)
  +decode    + proposal decode, sigmoid conf, reference softmax, threshold
  +select    + candidate compaction (INFER_YOLO_TOP_N shared top-N, or
               INFER_YOLO_PER_CLASS_K per-class top-K — whichever the
               config/flags select)
  +nms       + the greedy per-class suppression chain
  full       + scatter-back, winning-class max/argmax, validity
             (= the shipped QuantizedDetector.infer_yolo_fn program)

Run: python tools/profile_infer_yolo.py [--batch 128] [--per-class-k 48]
     [--top-n 256] [--stages a,b] [--end-to-end-only]
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


def _checksum(out):
    s = jnp.float32(0)
    for v in jax.tree_util.tree_leaves(out):
        s = s + jnp.sum(v.astype(jnp.float32)) * jnp.float32(1e-6)
    return s


def bench(call, images, n1=4, n2=16, reps=5):
    float(call(images, n1))
    float(call(images, n2))
    ds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(call(images, n1))
        t1 = time.perf_counter()
        float(call(images, n2))
        t2 = time.perf_counter()
        d = (t2 - t1) - (t1 - t0)
        if d > 0:
            ds.append(d / (n2 - n1))
    if not ds:
        raise RuntimeError("non-positive deltas")
    return float(np.median(ds))


def main():
    from mask_yolo_tpu.utils.compile_cache import enable as _enable_cache
    _enable_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--top-n", type=int, default=None,
                    help="override INFER_YOLO_TOP_N (CocoStyle default 256)")
    ap.add_argument("--per-class-k", type=int, default=None,
                    help="override INFER_YOLO_PER_CLASS_K (default 0 = off)")
    ap.add_argument("--stages", default=None)
    ap.add_argument("--end-to-end-only", action="store_true",
                    help="time only the full shipped program (fast A/B mode)")
    ap.add_argument("--trace-only", action="store_true",
                    help="trace (lower) every stage without executing — a "
                         "CPU-cheap shape/type smoke test")
    args = ap.parse_args()

    from mask_yolo_tpu import quant
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.models.network import MaskYoloNet
    from mask_yolo_tpu.ops.boxes import decode_yolo_proposals
    from mask_yolo_tpu.ops.nms import (class_aware_nms, greedy_nms_mask,
                                       reference_softmax)

    class Cfg(CocoStyleConfig):
        pass

    if args.top_n is not None:
        Cfg.INFER_YOLO_TOP_N = args.top_n
    if args.per_class_k is not None:
        Cfg.INFER_YOLO_PER_CLASS_K = args.per_class_k
    cfg = Cfg()
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

    n_top = int(cfg.INFER_YOLO_TOP_N or 0)
    k_cls = int(cfg.INFER_YOLO_PER_CLASS_K or 0)
    nms_t = float(cfg.NMS_THRESHOLD)
    n_grid = cfg.GRID_H * cfg.GRID_W * cfg.N_BOX

    def upto_decode(images):
        grid, _ = det.trunk(images)
        grid = grid.astype(jnp.float32)
        boxes = decode_yolo_proposals(grid, cfg.anchors_wh,
                                      cfg.GRID_H, cfg.GRID_W)
        conf = jax.nn.sigmoid(grid[..., 4])

        def per_image(g, cf):
            probs = cf[..., None] * reference_softmax(g[..., 5:])
            probs = probs * (probs > cfg.OBJ_THRESHOLD)
            return probs.reshape(-1, cfg.NUM_CLASSES)

        probs = jax.vmap(per_image)(grid, conf)
        return boxes, probs

    def upto_select(images):
        boxes, probs = upto_decode(images)
        if k_cls and k_cls < n_grid:
            def sel(bx, p):
                top_s, top_i = jax.lax.top_k(p.T, k_cls)
                return bx[top_i], top_s
            return jax.vmap(sel)(boxes, probs)
        if n_top and n_top < n_grid:
            def sel(bx, p):
                _, idx = jax.lax.top_k(jnp.max(p, axis=-1), n_top)
                return bx[idx], p[idx]
            return jax.vmap(sel)(boxes, probs)
        return boxes, probs

    def upto_nms(images):
        bx, sc = upto_select(images)
        if k_cls and k_cls < n_grid:
            # bx [B, C, K, 4], sc [B, C, K]
            keep = jax.vmap(jax.vmap(lambda b_, s_: greedy_nms_mask(
                b_, s_, nms_t)))(bx, sc)
            return sc * keep.astype(sc.dtype)
        return jax.vmap(lambda b_, p_: class_aware_nms(b_, p_, nms_t))(bx, sc)

    def stage_trunk(images):
        return det.trunk(images)

    def stage_decode(images):
        return upto_decode(images)

    def stage_select(images):
        return upto_select(images)

    def stage_nms(images):
        return upto_nms(images)

    def stage_full(images):
        return det.infer_yolo_fn()(images)

    stages = [("trunk", stage_trunk), ("+decode", stage_decode),
              ("+select", stage_select), ("+nms", stage_nms),
              ("full", stage_full)]
    if args.end_to_end_only:
        stages = [("full", stage_full)]
    elif args.stages:
        want = set(args.stages.split(","))
        stages = [s for s in stages if s[0] in want]

    def make_repeat(fn):
        @functools.partial(jax.jit, static_argnums=(1,))
        def repeat(images, n):
            def body(carry, _):
                img, acc = carry
                s = _checksum(fn(img))
                img = img + s * jnp.float32(1e-30)
                return (img, acc + s), None
            (_, acc), _ = jax.lax.scan(body, (images, jnp.float32(0)), None,
                                       length=n)
            return acc
        return repeat

    images = jnp.asarray(np.random.RandomState(0)
                         .rand(args.batch, *cfg.IMAGE_SHAPE)
                         .astype(np.float32))
    if args.trace_only:
        for name, fn in stages:
            make_repeat(fn).lower(images, 2)
            print(json.dumps({"stage": name, "traced": True}), flush=True)
        return
    prev = 0.0
    for name, fn in stages:
        t = bench(make_repeat(fn), images)
        us = t / args.batch * 1e6
        print(json.dumps({"stage": name, "us_per_img": round(us, 2),
                          "delta_us": round(us - prev, 2),
                          "img_per_s": round(args.batch / t / 1e0, 1),
                          "top_n": n_top, "per_class_k": k_cls}), flush=True)
        prev = us


if __name__ == "__main__":
    main()
