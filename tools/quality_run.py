"""Quality run: train Mask-YOLO on Shapes to convergence on the GPU, then
report box/mask AP and save qualitative overlays.

This produces the quantitative numbers the reference never published
(SURVEY.md §6) plus the qualitative PNG parity artifacts (README.md:10-22).

Run: python tools/quality_run.py --epochs 40 --train-images 400
Outputs under --out (default ./quality_run/): weights/, metrics.json,
InferMaskYOLO-*.png overlays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-images", type=int, default=400)
    ap.add_argument("--val-images", type=int, default=50)
    ap.add_argument("--eval-images", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="./quality_run")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override Config.COMPUTE_DTYPE for the run")
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"],
                    help="override Config.BACKBONE (resnet50_fpn = the "
                         "reference README's stated scale-up path, "
                         "/root/reference/README.md:5)")
    ap.add_argument("--augment", action="store_true",
                    help="seeded per-epoch flip/rot90/scale/brightness "
                         "augmentation (data/augment.default_augmenter)")
    ap.add_argument("--augment-flip-only", action="store_true",
                    help="round-1-style flip-only augmentation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-overlays", type=int, default=4)
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="Config.LR_SCHEDULE for the run")
    ap.add_argument("--lr-warmup-steps", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate pooled AP on the eval set every N epochs "
                         "during training (make_ap_eval_callback); tracks "
                         "the best box_ap50 checkpoint")
    args = ap.parse_args()

    from mask_yolo_tpu import MaskYOLO, evaluate_dataset
    from mask_yolo_tpu.data.shapes import ShapesConfig, ShapesDataset

    class RunConfig(ShapesConfig):
        BATCH_SIZE = args.batch_size
        LR_SCHEDULE = args.lr_schedule
        LR_WARMUP_STEPS = args.lr_warmup_steps

    if args.compute_dtype:
        RunConfig.COMPUTE_DTYPE = args.compute_dtype
    if args.backbone:
        RunConfig.BACKBONE = args.backbone
    config = RunConfig()
    os.makedirs(args.out, exist_ok=True)

    train_ds = ShapesDataset()
    train_ds.load_shapes(args.train_images, config.IMAGE_SHAPE[0],
                         config.IMAGE_SHAPE[1], seed=args.seed)
    train_ds.prepare()
    val_ds = ShapesDataset()
    val_ds.load_shapes(args.val_images, config.IMAGE_SHAPE[0],
                       config.IMAGE_SHAPE[1], seed=args.seed + 1)
    val_ds.prepare()
    eval_ds = ShapesDataset()
    eval_ds.load_shapes(args.eval_images, config.IMAGE_SHAPE[0],
                        config.IMAGE_SHAPE[1], seed=args.seed + 2)
    eval_ds.prepare()

    augmentation = None
    if args.augment_flip_only:
        from mask_yolo_tpu.data import augment as _augment
        augmentation = _augment.Sequential([_augment.Fliplr(0.5)],
                                           seed=args.seed + 7)
    elif args.augment:
        from mask_yolo_tpu.data.augment import default_augmenter
        augmentation = default_augmenter(seed=args.seed + 7)

    callbacks = None
    ap_cb = None
    if args.eval_every > 0:
        from mask_yolo_tpu import make_ap_eval_callback
        ap_cb = make_ap_eval_callback(
            eval_ds, config, every=args.eval_every, batch_size=8,
            score_threshold=args.score_threshold,
            history_path=os.path.join(args.out, "ap_history.jsonl"),
            best_weights_path=os.path.join(args.out, "best_weights"))
        callbacks = [ap_cb]

    model = MaskYOLO(mode="training", config=config,
                     model_dir=os.path.join(args.out, "ckpt"), seed=args.seed)
    t0 = time.perf_counter()
    model.train(train_ds, val_ds, learning_rate=args.lr, epochs=args.epochs,
                layers="all", augmentation=augmentation,
                custom_callbacks=callbacks)
    train_s = time.perf_counter() - t0
    weights = os.path.join(args.out, "weights")
    model.save_weights(weights)
    print(f"trained {args.epochs} epochs in {train_s:.0f}s", flush=True)

    infer = MaskYOLO(mode="inference", config=RunConfig())
    infer.load_weights(weights)

    t0 = time.perf_counter()
    result = evaluate_dataset(infer, eval_ds, config, batch_size=8,
                              score_threshold=args.score_threshold)
    eval_s = time.perf_counter() - t0
    result.pop("per_image")

    # int8 quantized-path accuracy (same weights, PTQ calibration on a few
    # eval images) — quantifies the quantization cost of the 4.5x-faster path
    import numpy as np

    from mask_yolo_tpu.data.loader import load_image_gt
    from mask_yolo_tpu.quant import QuantizedDetector

    calib = np.stack([
        load_image_gt(eval_ds, config, i)[0].astype(np.float32) / 255.0
        for i in list(eval_ds.image_ids)[:8]])
    qdet = QuantizedDetector.from_variables(infer.variables, config, calib,
                                            net=infer.net)

    class _QuantAdapter:
        def detect_batch(self, images):
            import jax.numpy as jnp
            return qdet.detect_outputs(jnp.asarray(images))

    q_result = evaluate_dataset(_QuantAdapter(), eval_ds, config,
                                batch_size=8,
                                score_threshold=args.score_threshold)
    result["int8_box_ap50"] = q_result["box_ap50"]
    result["int8_mask_ap50"] = q_result["mask_ap50"]
    result["int8_mean_recall50"] = q_result["mean_recall50"]
    result["train_seconds"] = round(train_s, 1)
    result["eval_seconds"] = round(eval_s, 1)
    result["epochs"] = args.epochs
    result["train_images"] = args.train_images
    if ap_cb is not None and ap_cb.history:
        result["best_epoch_box_ap50"] = ap_cb.best
        result["ap_trajectory"] = [
            {k: e[k] for k in ("epoch", "box_ap50", "mask_ap50")}
            for e in ap_cb.history]
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2), flush=True)

    for image_id in list(eval_ds.image_ids)[:args.num_overlays]:
        infer.detect(eval_ds.load_image(image_id), save_path=args.out,
                     cs_threshold=args.score_threshold)
    print("overlays saved to", args.out, flush=True)


if __name__ == "__main__":
    main()
