"""Evaluate int8 PTQ/QAT variants of a saved checkpoint against its f32 AP.

Standalone version of the int8 tail of tools/quality_run_coco.py so the
quantization ablation (per-tensor vs per-channel activation scales, with or
without label-free QAT) can be re-run on any checkpoint without retraining —
e.g. on the best weights of a long run. Rebuilds the reference's
missing quantization story (the reference has none; quantization is a
capability this framework adds on top of /root/reference/myolo/model.py's
float-only inference graph).

Run (GPU):
  python tools/eval_int8.py --weights quality_run_coco_r3b/weights \
      --data quality_run_coco_r3b/coco_eval --variants f32 pc pc_qat \
      --out asset/coco80_int8_r3b.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mask_yolo_tpu.utils.compile_cache import enable as _enable_cache

VARIANTS = ("f32", "pt", "pc", "pt_qat", "pc_qat", "pc_qat_mw",
            "pc_f32deconv", "pc_f32tail", "pc_qat_mw_f32deconv")


def main():
    _enable_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True,
                    help="checkpoint dir from MaskYOLO.save_weights")
    ap.add_argument("--data", required=True,
                    help="COCO-format dataset dir (instances.json + images/)")
    ap.add_argument("--variants", nargs="+", default=["f32", "pt", "pc", "pc_qat"],
                    choices=list(VARIANTS) + ["none"],
                    help="pt=per-tensor PTQ, pc=+QUANT_PER_CHANNEL_ACT, "
                         "*_qat=+label-free finetune; none = skip (e.g. a "
                         "pure --mask-top-k sweep)")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--calib-images", type=int, default=16)
    ap.add_argument("--qat-steps", type=int, default=200)
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--eval-images", type=int, default=0,
                    help="cap eval to the first N images (0 = all)")
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"])
    ap.add_argument("--mask-top-k", type=int, nargs="+", default=None,
                    help="ALSO evaluate the f32 model at each MASK_TOP_K "
                         "value (0 = mask every kept detection, the "
                         "reference's behavior — "
                         "/root/reference/myolo/model.py:926-931). The A/B "
                         "that prices the masks-for-top-K fallback where "
                         "scenes exceed K instances.")
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args()

    import numpy as np

    from mask_yolo_tpu import MaskYOLO, evaluate_dataset
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.data.coco import CocoDataset
    from mask_yolo_tpu.data.loader import load_image_gt
    from mask_yolo_tpu.quant import QuantizedDetector

    class RunConfig(CocoStyleConfig):
        NUM_CLASSES = 1 + args.num_classes
        LABELS = (["background"]
                  + [f"c{i:02d}" for i in range(1, args.num_classes + 1)])

    if args.backbone:
        RunConfig.BACKBONE = args.backbone

    ds = CocoDataset()
    ds.load_coco(os.path.join(args.data, "instances.json"),
                 os.path.join(args.data, "images"))
    ds.prepare()
    image_ids = list(ds.image_ids)
    if args.eval_images:
        image_ids = image_ids[:args.eval_images]

    infer = MaskYOLO(mode="inference", config=RunConfig())
    infer.load_weights(args.weights)

    calib = np.stack([
        load_image_gt(ds, infer.config, i)[0].astype(np.float32) / 255.0
        for i in image_ids[:args.calib_images]])

    def quantized(per_channel: bool, qat: bool, **overrides):
        cfg = RunConfig()
        cfg.QUANT_PER_CHANNEL_ACT = per_channel
        for k, v in overrides.items():
            setattr(cfg, k, v)
        qdet = QuantizedDetector.from_variables(infer.variables, cfg, calib)
        if qat:
            qdet.finetune(calib, steps=args.qat_steps, lr=1e-5)

        class _Adapter:
            def detect_batch(self, images):
                import jax.numpy as jnp
                return qdet.detect_outputs(jnp.asarray(images))

        return _Adapter()

    models = {
        "f32": lambda: infer,
        "pt": lambda: quantized(False, False),
        "pc": lambda: quantized(True, False),
        "pt_qat": lambda: quantized(False, True),
        "pc_qat": lambda: quantized(True, True),
        # ablations that close the 81-class int8 mask residual:
        # mask-weighted QAT distillation — the residual lives in the mask
        # branch, so weight its term 4× in the finetune objective
        "pc_qat_mw": lambda: quantized(True, True, QUANT_QAT_MASK_WEIGHT=4.0),
        # leave the mask deconv (the last conv before the class head) bf16
        "pc_f32deconv": lambda: quantized(
            True, False, QUANT_MASK_F32_LAYERS=("mask_deconv",)),
        # leave the whole mask tail (conv4 + deconv) bf16
        "pc_f32tail": lambda: quantized(
            True, False, QUANT_MASK_F32_LAYERS=("mask_conv4", "mask_deconv")),
        "pc_qat_mw_f32deconv": lambda: quantized(
            True, True, QUANT_QAT_MASK_WEIGHT=4.0,
            QUANT_MASK_F32_LAYERS=("mask_deconv",)),
    }

    results = {}
    for kp in (args.mask_top_k or []):
        class KpConfig(RunConfig):
            MASK_TOP_K = kp

        m = MaskYOLO(mode="inference", config=KpConfig())
        m.load_weights(args.weights)
        t0 = time.perf_counter()
        r = evaluate_dataset(m, ds, m.config, image_ids=image_ids,
                             batch_size=args.batch_size,
                             score_threshold=args.score_threshold)
        r.pop("per_image", None)
        r["eval_seconds"] = round(time.perf_counter() - t0, 1)
        results[f"f32_topk{kp}"] = r
        print(f"[f32 MASK_TOP_K={kp}] box_ap50={r['box_ap50']:.4f} "
              f"mask_ap50={r['mask_ap50']:.4f} ({r['eval_seconds']}s)",
              flush=True)

    for name in args.variants:
        if name == "none":
            continue
        t0 = time.perf_counter()
        r = evaluate_dataset(models[name](), ds, infer.config,
                             image_ids=image_ids, batch_size=args.batch_size,
                             score_threshold=args.score_threshold)
        r.pop("per_image", None)
        r["eval_seconds"] = round(time.perf_counter() - t0, 1)
        results[name] = r
        print(f"[{name}] box_ap50={r['box_ap50']:.4f} "
              f"mask_ap50={r['mask_ap50']:.4f} ({r['eval_seconds']}s)",
              flush=True)

    meta = {"weights": args.weights, "data": args.data,
            "n_images": len(image_ids), "calib_images": args.calib_images,
            "qat_steps": args.qat_steps, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(meta, f, indent=2)
    print(json.dumps(meta, indent=2), flush=True)


if __name__ == "__main__":
    main()
