"""AOT-artifact throughput check: the StableHLO export (export.py) must
match the live-jit detect pipeline on the device — an AOT layout/donation
regression would otherwise ship silently behind the HTTP server.

Exports the detect pipeline (bf16 module path, and int8 after quantize),
loads it back through ExportedDetector, and delta-times artifact vs live
with the bench.py harness.

Run: python tools/bench_export.py [--config shapes|coco416] [--batch 128]
Prints one JSON line per (path, flavor).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
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


def make_repeat(fn):
    """Scan-chained repeat of an images→outputs callable (f32 images)."""

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


def bench(call, images, n1=4, n2=24, reps=5):
    float(call(images, n1))
    float(call(images, n2))
    deltas = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(call(images, n1))
        t1 = time.perf_counter()
        float(call(images, n2))
        t2 = time.perf_counter()
        dt = (t2 - t1) - (t1 - t0)
        if dt > 0:
            deltas.append(dt / (n2 - n1))
    if not deltas:
        raise RuntimeError("non-positive deltas")
    return images.shape[0] / float(np.median(deltas))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="coco416",
                    choices=["shapes", "coco416"])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--flavors", default="bf16,int8")
    args = ap.parse_args()

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.data.shapes import ShapesConfig
    from mask_yolo_tpu.export import ExportedDetector

    base = {"shapes": ShapesConfig, "coco416": CocoStyleConfig}[args.config]

    class Cfg(base):
        BATCH_SIZE = args.batch

    cfg = Cfg()
    model = MaskYOLO(mode="inference", config=cfg)
    images = jnp.asarray(np.random.RandomState(0)
                         .rand(args.batch, *cfg.IMAGE_SHAPE)
                         .astype(np.float32))

    for flavor in args.flavors.split(","):
        flavor = flavor.strip()
        if flavor == "int8":
            calib = np.random.RandomState(1).rand(
                4, *cfg.IMAGE_SHAPE).astype(np.float32)
            model.quantize(calib)
        elif model._qdet is not None:
            model._invalidate_infer_fns()

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, f"detect_{flavor}.mytpu")
            header = model.export_model(path, input_dtype="float32")
            det = ExportedDetector.load(path)

            live_fn = (model._qdet.detect_fn() if model._qdet is not None
                       else (lambda im: model.detect_batch(im)))
            try:
                live = bench(make_repeat(live_fn), images)
                art = bench(make_repeat(det._call), images)
                print(json.dumps({
                    "config": args.config, "flavor": flavor,
                    "batch": args.batch,
                    "live_img_per_s": round(live, 1),
                    "artifact_img_per_s": round(art, 1),
                    "artifact_vs_live": round(art / live, 3),
                    "compute_path": header["compute_path"],
                }), flush=True)
            except Exception as e:
                print(json.dumps({"config": args.config, "flavor": flavor,
                                  "error": f"{type(e).__name__}: {e}"}),
                      flush=True)


if __name__ == "__main__":
    main()
