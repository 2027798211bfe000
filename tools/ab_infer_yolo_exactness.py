"""On-checkpoint exactness A/B for the infer_yolo candidate-compaction knobs
(INFER_YOLO_PER_CLASS_K / INFER_YOLO_TOP_N) against the exact full-grid
per-class NMS, on REAL trained predictions.

The repo's equivalence tests (tests/test_nms.py, tests/test_pipelines.py)
prove the documented condition — per-class compaction is output-identical
while every class has <= K above-threshold boxes. This tool measures whether
that condition actually HOLDS for a trained checkpoint on real eval images,
and by how much margin: it reports the max/p99 per-(image, class)
above-threshold box count (the condition variable) plus an elementwise
output comparison per variant. Evidence for choosing a CocoStyleConfig
default (ROADMAP A5).

Reference semantics being preserved: the per-class greedy suppression of
/root/reference/myolo/myolo_utils.py:67-80.

Run (GPU):
  python tools/ab_infer_yolo_exactness.py \
      --weights quality_run_coco_r4t/best_weights \
      --data quality_run_coco_r4t/coco_eval
CPU smoke: add --cpu (forces the CPU backend, 4 images).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from mask_yolo_tpu.utils.compile_cache import enable as _enable_cache


def main():
    _enable_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--data", required=True,
                    help="COCO-format dataset dir (instances.json + images/)")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--limit", type=int, default=64)
    ap.add_argument("--k", type=int, nargs="+", default=[32, 48, 64])
    ap.add_argument("--top-n", type=int, nargs="+", default=[256])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        args.limit = min(args.limit, 4)

    import jax.numpy as jnp

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.data.coco import CocoDataset
    from mask_yolo_tpu.data.loader import load_image_gt
    from mask_yolo_tpu.ops.nms import reference_softmax
    from mask_yolo_tpu.pipelines import images_f32, infer_yolo_outputs

    class RunConfig(CocoStyleConfig):
        NUM_CLASSES = 1 + args.num_classes
        LABELS = (["background"]
                  + [f"c{i:02d}" for i in range(1, args.num_classes + 1)])

    ds = CocoDataset()
    ds.load_coco(os.path.join(args.data, "instances.json"),
                 os.path.join(args.data, "images"))
    ds.prepare()
    cfg0 = RunConfig()
    m = MaskYOLO(mode="inference", config=cfg0)
    m.load_weights(args.weights)

    ids = list(ds.image_ids)[:args.limit]
    images = jnp.asarray(np.stack([
        load_image_gt(ds, cfg0, i)[0].astype(np.float32) / 255.0
        for i in ids]))

    def run(top_n, k_cls):
        class KC(RunConfig):
            INFER_YOLO_TOP_N = top_n
            INFER_YOLO_PER_CLASS_K = k_cls

        cfg = KC()
        out = jax.jit(lambda im: infer_yolo_outputs(m.net, m.variables,
                                                    im, cfg))(images)
        return {n: np.asarray(v) for n, v in out.items()}

    exact = run(0, 0)  # full-grid per-class NMS: the ground truth

    @jax.jit
    def per_class_counts(im):
        grid, _ = m.net.apply(m.variables, images_f32(im), train=False,
                              method=m.net.trunk)
        grid = grid.astype(jnp.float32)
        conf = jax.nn.sigmoid(grid[..., 4])
        probs = conf[..., None] * reference_softmax(grid[..., 5:])
        over = probs > cfg0.OBJ_THRESHOLD
        return over.reshape(im.shape[0], -1, cfg0.NUM_CLASSES).sum(axis=1)

    counts = np.asarray(per_class_counts(images))
    report = {"n_images": len(ids),
              "max_boxes_per_class": int(counts.max()),
              "p99_boxes_per_class": float(np.percentile(counts, 99))}
    print(json.dumps({"condition": report}), flush=True)

    variants = ([(f"k{k}", 0, k) for k in args.k]
                + [(f"topn{n}", n, 0) for n in args.top_n])
    for name, top_n, k_cls in variants:
        got = run(top_n, k_cls)
        kept = exact["valid"]
        row = {
            "scores_equal": bool(np.allclose(got["scores"], exact["scores"],
                                             atol=1e-6)),
            "valid_equal": bool((got["valid"] == exact["valid"]).all()),
            "classes_equal_on_valid": bool(
                (got["classes"][kept] == exact["classes"][kept]).all()),
            "divergent_entries": int((~np.isclose(
                got["scores"], exact["scores"], atol=1e-6)).sum()),
        }
        report[name] = row
        print(json.dumps({name: row}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print("FULL:", json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
