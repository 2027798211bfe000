"""Export CLI: weights + config → one portable StableHLO detect artifact.

Build-side counterpart of serving from an artifact (export.py): load a
trained checkpoint, AOT-trace the full image→boxes+masks pipeline with the
weights baked in, and write a single file a deployment process loads with
`ExportedDetector.load(path)` — no model code, no checkpoint directory.

Examples:
  python tools/export_model.py --weights ./quality_run/weights \
      --config shapes --out shapes_detect.mytpu
  python tools/export_model.py --weights W --config-json ./ckpt/config.json \
      --out coco_detect.mytpu --batch-size 32 --platforms cuda cpu
  python tools/export_model.py --out m.mytpu --config shapes --weights W \
      --verify   # reload the artifact and check it against the live model
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from predict import build_config  # shared --config/--config-json/--labels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True,
                    help="checkpoint dir (save_weights/train output)")
    ap.add_argument("--out", required=True, help="artifact file to write")
    ap.add_argument("--config", choices=["shapes", "coco"], default=None)
    ap.add_argument("--config-json", default=None,
                    help="config.json persisted by train()")
    ap.add_argument("--labels", default=None,
                    help="comma-separated label override")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="pin the batch (default: symbolic, any B)")
    ap.add_argument("--input-dtype", choices=["uint8", "float32"],
                    default="uint8")
    ap.add_argument("--platforms", nargs="+", default=None,
                    help="lowering platforms, e.g. --platforms cuda cpu")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and compare against the live "
                         "model on a random batch (requires a platform this "
                         "process can run)")
    args = ap.parse_args()

    from mask_yolo_tpu import MaskYOLO

    config = build_config(args)
    model = MaskYOLO(mode="inference", config=config)
    model.load_weights(args.weights)
    header = model.export_model(args.out, batch_size=args.batch_size,
                                input_dtype=args.input_dtype,
                                platforms=args.platforms)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size_mb:.1f} MB) "
          f"platforms={header['platforms']} batch={header['batch_size']}")

    if args.verify:
        import numpy as np

        from mask_yolo_tpu.export import ExportedDetector

        det = ExportedDetector.load(args.out)
        b = args.batch_size or 2
        rng = np.random.RandomState(0)
        imgs = (rng.rand(b, *config.IMAGE_SHAPE) * 255).astype(np.uint8)
        got = {k: np.asarray(v) for k, v in det.detect_batch(imgs).items()}
        ref = {k: np.asarray(v) for k, v in model.detect_batch(imgs).items()}
        # the artifact and the live model are two separate XLA compilations
        # of the same math; on an accelerator they may differ in the last
        # bits of a box, which can flip the odd borderline 0.5-threshold
        # mask pixel — so verify with tolerances, exact on the discrete
        # outputs
        # hard errors, not asserts: verification must not silently pass
        # under `python -O`
        for k in ("classes", "valid", "scores"):
            if not np.array_equal(got[k], ref[k]):
                raise SystemExit(f"verify FAILED: {k} differs between "
                                 f"artifact and live model")
        if not np.allclose(got["boxes"], ref["boxes"], atol=1e-3):
            raise SystemExit("verify FAILED: boxes differ beyond 1e-3 px")
        frac = np.mean(got["masks"] != ref["masks"])
        # untrained/low-confidence models sit near the 0.5 mask threshold on
        # many boundary pixels, so allow up to 0.1% borderline flips
        if not frac < 1e-3:
            raise SystemExit(
                f"verify FAILED: masks differ on {frac:.2e} of pixels")
        print(f"verify: artifact matches live model on B={b} "
              f"(boxes atol 1e-3 px, {frac:.1e} borderline mask pixels)")


if __name__ == "__main__":
    main()
