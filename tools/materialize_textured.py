"""Materialize the textured 81-class COCO-format datasets of the 81-class
quality campaign (docs/QUALITY.md) on the CPU, ahead of training.

Pure-CPU and idempotent: writes the same three splits (same seeds/counts/
paths) that `tools/quality_run_coco.py --textured --train-images 6000
--val-images 64 --eval-images 64 --out /root/repo/quality_run_coco_r4t`
expects, so the campaign command reuses them instead of spending its first
~hour regenerating. Safe to kill and re-run: each split is only marked
reusable once its instances.json holds the full image count.

Run: python tools/materialize_textured.py [--out /root/repo/quality_run_coco_r4t]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quality_run_coco import _make_coco_copy  # noqa: E402  (tools/ sibling)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/root/repo/quality_run_coco_r4t")
    ap.add_argument("--train-images", type=int, default=6000)
    ap.add_argument("--val-images", type=int, default=64)
    ap.add_argument("--eval-images", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-classes", type=int, default=80)
    args = ap.parse_args()

    for name, count, seed in (("coco_val", args.val_images, args.seed + 1),
                              ("coco_eval", args.eval_images, args.seed + 2),
                              ("coco_train", args.train_images, args.seed)):
        t0 = time.time()
        d = _make_coco_copy(os.path.join(args.out, name), count, seed,
                            args.num_classes, textured=True)
        print(f"{name}: {len(d.image_ids)} images ready "
              f"({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
