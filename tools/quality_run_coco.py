"""80-class quality run at the CocoStyleConfig operating point (416², 81
classes, MASK_TOP_K): the quality evidence of docs/QUALITY.md.

Pipeline (exercises the COCO loader end-to-end, not just in unit tests):
  1. generate a dense multi-class synthetic dataset (data/dense_shapes.py:
     80 classes, up to 48 instances/image — the shipped MASK_TOP_K);
  2. export it to an on-disk COCO-style dataset (images/*.png + COCO JSON
     with RLE segmentations, data/coco.dataset_to_coco_json);
  3. reload through data/coco.CocoDataset — training and evaluation read
     ONLY the COCO-format copy;
  4. train CocoStyleConfig on the GPU, evaluate pooled box/mask AP, eval the
     int8 PTQ path, save overlays + metrics.json.

Run: python tools/quality_run_coco.py --epochs 25 --train-images 300
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _make_coco_copy(out_dir, count, seed, num_classes, textured=False):
    """Dense synthetic set → on-disk COCO dataset → CocoDataset. Reuses an
    existing materialization (same seed ⇒ same data) when present."""
    import json as _json

    from mask_yolo_tpu.data.coco import CocoDataset, dataset_to_coco_json
    from mask_yolo_tpu.data.dense_shapes import DenseShapesDataset

    ann = os.path.join(out_dir, "instances.json")
    sidecar = os.path.join(out_dir, "materialize_meta.json")
    want = {"count": count, "seed": seed, "num_classes": num_classes,
            "textured": bool(textured)}
    reuse = False
    if os.path.exists(ann):
        with open(ann) as f:
            meta = _json.load(f)
        reuse = len(meta.get("images", [])) == count
        # the image count alone can't distinguish a flat materialization
        # from a textured one (or a different seed) at the same path — the
        # sidecar records the generation parameters and must match exactly
        if reuse and os.path.exists(sidecar):
            with open(sidecar) as f:
                reuse = _json.load(f) == want
        elif reuse:
            print(f"[warn] {out_dir}: no materialize_meta.json sidecar; "
                  "regenerating to guarantee the requested parameters",
                  flush=True)
            reuse = False
    if not reuse:
        src = DenseShapesDataset()
        src.load_dense(count, 416, 416, seed=seed, num_classes=num_classes,
                       textured=textured)
        src.prepare()
        ann = dataset_to_coco_json(src, out_dir)
        with open(sidecar, "w") as f:
            _json.dump(want, f)
    d = CocoDataset()
    d.load_coco(ann, os.path.join(out_dir, "images"))
    d.prepare()
    return d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-images", type=int, default=300)
    ap.add_argument("--val-images", type=int, default=32)
    ap.add_argument("--eval-images", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="./quality_run_coco")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--textured", action="store_true",
                    help="photographic-complexity fixture: per-instance "
                         "texture, background clutter, lighting gradients "
                         "(data/dense_shapes.py textured mode, r4)")
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--num-overlays", type=int, default=3)
    ap.add_argument("--mask-top-k", type=int, default=None,
                    help="override CocoStyleConfig.MASK_TOP_K for eval")
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"],
                    help="override Config.BACKBONE (resnet50_fpn = the "
                         "reference README's stated scale-up path, "
                         "/root/reference/README.md:5)")
    ap.add_argument("--augment", action="store_true",
                    help="per-epoch geometric + photometric train-time "
                         "augmentation (data/augment.default_augmenter)")
    ap.add_argument("--augment-flip-only", action="store_true",
                    help="flip-only augmentation (lighter; the Shapes "
                         "quality tool's round-1 recipe)")
    ap.add_argument("--skip-int8", action="store_true")
    ap.add_argument("--int8-per-channel", action="store_true",
                    help="QUANT_PER_CHANNEL_ACT for the int8 eval (the best "
                         "measured 81-class PTQ variant, docs/QUALITY.md)")
    ap.add_argument("--int8-qat-steps", type=int, default=0,
                    help="label-free QAT finetune steps for the int8 eval")
    ap.add_argument("--calib-images", type=int, default=8)
    ap.add_argument("--resume-from", default=None,
                    help="checkpoint dir from a previous run's ckpt/ — "
                         "continues training to --epochs total")
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="Config.LR_SCHEDULE for the run")
    ap.add_argument("--lr-warmup-steps", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate pooled AP on the eval set every N epochs "
                         "during training (make_ap_eval_callback); tracks "
                         "the best box_ap50 checkpoint")
    ap.add_argument("--scan-steps", type=int, default=0,
                    help="Config.TRAIN_SCAN_STEPS: train S optimizer steps "
                         "per dispatch (one upload, one lax.scan program)")
    ap.add_argument("--stop-after-epoch", type=int, default=0,
                    help="stop training after epoch N (its checkpoint is on "
                         "disk; continue with --resume-from); schedules "
                         "still see --epochs")
    args = ap.parse_args()

    from mask_yolo_tpu.utils.compile_cache import enable as _enable_cache
    _enable_cache()

    from mask_yolo_tpu import MaskYOLO, evaluate_dataset
    from mask_yolo_tpu.config import CocoStyleConfig

    class RunConfig(CocoStyleConfig):
        BATCH_SIZE = args.batch_size
        NUM_CLASSES = 1 + args.num_classes
        LABELS = (["background"]
                  + [f"c{i:02d}" for i in range(1, args.num_classes + 1)])
        LR_SCHEDULE = args.lr_schedule
        LR_WARMUP_STEPS = args.lr_warmup_steps
        TRAIN_SCAN_STEPS = args.scan_steps

    if args.mask_top_k is not None:
        RunConfig.MASK_TOP_K = args.mask_top_k
    if args.backbone:
        RunConfig.BACKBONE = args.backbone
    config = RunConfig()
    os.makedirs(args.out, exist_ok=True)

    print("materializing COCO-format datasets ...", flush=True)
    train_ds = _make_coco_copy(os.path.join(args.out, "coco_train"),
                               args.train_images, args.seed, args.num_classes,
                               textured=args.textured)
    val_ds = _make_coco_copy(os.path.join(args.out, "coco_val"),
                             args.val_images, args.seed + 1, args.num_classes,
                             textured=args.textured)
    eval_ds = _make_coco_copy(os.path.join(args.out, "coco_eval"),
                              args.eval_images, args.seed + 2,
                              args.num_classes, textured=args.textured)
    print(f"train={len(train_ds.image_ids)} val={len(val_ds.image_ids)} "
          f"eval={len(eval_ds.image_ids)} classes={train_ds.num_classes}",
          flush=True)

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

    augmentation = None
    if args.augment_flip_only:
        from mask_yolo_tpu.data import augment as _augment
        augmentation = _augment.Sequential([_augment.Fliplr(0.5)],
                                           seed=args.seed + 7)
    elif args.augment:
        from mask_yolo_tpu.data.augment import default_augmenter
        augmentation = default_augmenter(seed=args.seed + 7)

    model = MaskYOLO(mode="training", config=config,
                     model_dir=os.path.join(args.out, "ckpt"), seed=args.seed)
    t0 = time.perf_counter()
    model.train(train_ds, val_ds, learning_rate=args.lr, epochs=args.epochs,
                layers="all", augmentation=augmentation,
                resume_from=args.resume_from,
                custom_callbacks=callbacks,
                stop_after_epoch=args.stop_after_epoch or None)
    train_s = time.perf_counter() - t0
    if args.stop_after_epoch and args.stop_after_epoch < args.epochs:
        print(f"stopped after epoch {args.stop_after_epoch} in "
              f"{train_s:.0f}s (of {args.epochs}); checkpoint on disk",
              flush=True)
        return
    weights = os.path.join(args.out, "weights")
    model.save_weights(weights)
    print(f"trained {args.epochs} epochs in {train_s:.0f}s", flush=True)

    infer = MaskYOLO(mode="inference", config=RunConfig())
    infer.load_weights(weights)

    t0 = time.perf_counter()
    result = evaluate_dataset(infer, eval_ds, config, batch_size=8,
                              score_threshold=args.score_threshold)
    eval_s = time.perf_counter() - t0
    result.pop("per_image", None)

    if not args.skip_int8:
        import numpy as np

        from mask_yolo_tpu.data.loader import load_image_gt
        from mask_yolo_tpu.quant import QuantizedDetector

        if args.int8_per_channel:
            config.QUANT_PER_CHANNEL_ACT = True
        calib = np.stack([
            load_image_gt(eval_ds, config, i)[0].astype(np.float32) / 255.0
            for i in list(eval_ds.image_ids)[:args.calib_images]])
        qdet = QuantizedDetector.from_variables(infer.variables, config, calib)
        if args.int8_qat_steps:
            qdet.finetune(calib, steps=args.int8_qat_steps, lr=1e-5)

        class _QuantAdapter:
            def detect_batch(self, images):
                import jax.numpy as jnp
                return qdet.detect_outputs(jnp.asarray(images))

        q = evaluate_dataset(_QuantAdapter(), eval_ds, config, batch_size=8,
                             score_threshold=args.score_threshold)
        result["int8_box_ap50"] = q["box_ap50"]
        result["int8_mask_ap50"] = q["mask_ap50"]

    result["train_seconds"] = round(train_s, 1)
    result["eval_seconds"] = round(eval_s, 1)
    result["epochs"] = args.epochs
    result["train_images"] = args.train_images
    result["num_classes"] = args.num_classes
    result["mask_top_k"] = config.MASK_TOP_K
    result["textured"] = bool(args.textured)
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
