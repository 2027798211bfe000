"""Stage-level timing of the detect pipeline on the GPU.

Uses the same delta-timing harness as bench.py (scalar-checksum fetch, delta
between N1 and N2 scan iterations cancels the fixed dispatch and fetch
overhead). Each stage is timed as a cumulative prefix of the pipeline so the
differences isolate per-stage cost:

  trunk            backbone + YOLO head
  +decode          + grid decode to boxes/scores/classes
  +nms             + top-K + class NMS
  +mask            + ROIAlign + mask head + class-select
  full             + on-chip mask paste to 224² + threshold

Run: python tools/profile_stages.py [batch_size] [stage ...]
"""

from __future__ import annotations

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np



def _checksum(*arrays):
    s = jnp.float32(0)
    for v in arrays:
        for leaf in jax.tree_util.tree_leaves(v):
            s = s + jnp.sum(leaf.astype(jnp.float32)) * jnp.float32(1e-6)
    return s


def main():
    from mask_yolo_tpu import pipelines
    from mask_yolo_tpu.data.shapes import ShapesConfig
    from mask_yolo_tpu.models.network import MaskYoloNet
    from mask_yolo_tpu.ops.boxes import decode_detections
    from mask_yolo_tpu.ops.nms import index_order_class_nms_mask
    from mask_yolo_tpu.ops.roi_align import paste_masks

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128

    class BenchConfig(ShapesConfig):
        COMPUTE_DTYPE = "bfloat16"

    cfg = BenchConfig()
    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE,
                      compute_dtype=cfg.COMPUTE_DTYPE)
    rng = jax.random.PRNGKey(0)
    img1 = jnp.zeros((1, *cfg.IMAGE_SHAPE), jnp.float32)
    variables = jax.jit(lambda r, i, ro: net.init(r, i, ro, train=False))(
        rng, img1, jnp.zeros((1, 8, 4), jnp.float32))

    k = cfg.DETECTION_MAX_INSTANCES
    h, w = cfg.IMAGE_SHAPE[:2]

    def stage_trunk(images):
        grid, fmap = net.apply(variables, images, train=False, method=net.trunk)
        return _checksum(grid, fmap)

    def stage_decode(images):
        grid, fmap = net.apply(variables, images, train=False, method=net.trunk)
        det = decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        return _checksum(det, fmap)

    def stage_nms(images):
        grid, fmap = net.apply(variables, images, train=False, method=net.trunk)
        det = decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        boxes, scores, classes = det[..., :4], det[..., 4], det[..., 5].astype(jnp.int32)
        area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0
        masked = jnp.where(area_ok, scores, -1.0)
        top_scores, idx = jax.lax.top_k(masked, k)
        top_boxes = jnp.take_along_axis(boxes, idx[..., None], axis=1)
        top_classes = jnp.take_along_axis(classes, idx, axis=1)
        valid = top_scores > cfg.OBJ_THRESHOLD
        keep = jax.vmap(lambda bx, cl, va: index_order_class_nms_mask(bx, cl, va, 0.7))(
            top_boxes, top_classes, valid)
        return _checksum(top_boxes, top_scores, keep, fmap)

    def stage_mask(images):
        grid, fmap = net.apply(variables, images, train=False, method=net.trunk)
        det = decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        boxes, scores, classes = det[..., :4], det[..., 4], det[..., 5].astype(jnp.int32)
        area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0
        masked = jnp.where(area_ok, scores, -1.0)
        top_scores, idx = jax.lax.top_k(masked, k)
        top_boxes = jnp.take_along_axis(boxes, idx[..., None], axis=1)
        top_classes = jnp.take_along_axis(classes, idx, axis=1)
        pred_masks = net.apply(variables, top_boxes, fmap, train=False,
                               method=net.mask_branch)
        onehot = jax.nn.one_hot(top_classes, cfg.NUM_CLASSES, dtype=pred_masks.dtype)
        sel = jnp.einsum("bkhwc,bkc->bkhw", pred_masks, onehot)
        return _checksum(sel, top_scores)

    def stage_full(images):
        out = pipelines.detect_outputs(net, variables, images, cfg)
        return _checksum(out)

    stages = [("trunk", stage_trunk), ("+decode", stage_decode),
              ("+nms", stage_nms), ("+mask", stage_mask), ("full", stage_full)]
    if len(sys.argv) > 2:
        wanted = set(sys.argv[2:])
        stages = [s for s in stages if s[0] in wanted]

    images = jax.device_put(jnp.asarray(
        np.random.RandomState(0).rand(batch, *cfg.IMAGE_SHAPE).astype(np.float32)))

    n1, n2 = 1, 6

    def make_repeat(fn):
        @functools.partial(jax.jit, static_argnums=(1,))
        def repeat(images, n):
            def body(carry, _):
                img, acc = carry
                s = fn(img)
                return (img + s * jnp.float32(1e-30), acc + s), None
            (_, acc), _ = jax.lax.scan(body, (images, jnp.float32(0)), None, length=n)
            return acc
        return repeat

    print(f"batch={batch}")
    prev = 0.0
    for name, fn in stages:
        rep = make_repeat(fn)
        float(rep(images, n1)); float(rep(images, n2))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter(); float(rep(images, n1))
            t1 = time.perf_counter(); float(rep(images, n2))
            t2 = time.perf_counter()
            dt = ((t2 - t1) - (t1 - t0)) / (n2 - n1)
            if dt > 0:
                best = min(best, dt)
        us_img = best / batch * 1e6
        print(f"{name:10s} {best*1e3:8.3f} ms/iter  {us_img:8.2f} µs/img",
              flush=True)
        prev = us_img


if __name__ == "__main__":
    main()
