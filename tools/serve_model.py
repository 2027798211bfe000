#!/usr/bin/env python
"""Launch the dynamic-batching inference server over a trained checkpoint.

  python tools/serve_model.py --weights ./weights [--quantize] [--port 8000]
  python tools/serve_model.py --artifact m.mytpu   # StableHLO export, no
                                                   # model code or checkpoint

POST /detect with an .npy-serialized uint8 [H, W, 3] image; JSON response.
See mask_yolo_tpu/serve.py for the batching design and
mask_yolo_tpu/export.py for the artifact format.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=None,
                    help="checkpoint dir (or use --artifact)")
    ap.add_argument("--artifact", default=None,
                    help="serve a StableHLO export (tools/export_model.py) "
                         "instead of a checkpoint")
    ap.add_argument("--config", default="shapes",
                    choices=["shapes", "coco416"],
                    help="operating point (Config subclass)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="static serving batch (default 8, or the "
                         "artifact's pinned batch)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--quantize", action="store_true",
                    help="serve the int8 PTQ path (calibrates on zeros+noise)")
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    args = ap.parse_args()

    import numpy as np

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.data.shapes import ShapesConfig
    from mask_yolo_tpu.serve import BatchingExecutor, InferenceServer

    if bool(args.weights) == bool(args.artifact):
        ap.error("exactly one of --weights / --artifact is required")

    if args.artifact:
        from mask_yolo_tpu.export import ExportedDetector

        if args.quantize:
            ap.error("--quantize applies at export time, not to an artifact")
        if "--config" in sys.argv:
            ap.error("--config is determined by the artifact header; it "
                     "cannot be overridden when serving --artifact")
        model = ExportedDetector.load(args.artifact)
        cfg = model.serve_config(batch_size=args.batch_size)
    else:
        base = {"shapes": ShapesConfig,
                "coco416": CocoStyleConfig}[args.config]

        class ServeConfig(base):
            BATCH_SIZE = args.batch_size or 8

        cfg = ServeConfig()
        model = MaskYOLO(mode="inference", config=cfg)
        model.load_weights(args.weights)
        if args.quantize:
            calib = np.random.RandomState(0).rand(
                4, *cfg.IMAGE_SHAPE).astype(np.float32)
            model.quantize(calib)
    ex = BatchingExecutor(model, cfg, batch_size=cfg.BATCH_SIZE,
                          max_delay_s=args.max_delay_ms / 1e3,
                          score_threshold=args.score_threshold)
    # compile + first-dispatch happen on the worker thread, off the
    # request path
    ex.warmup()
    server = InferenceServer(ex, host=args.host, port=args.port).start()
    print(f"serving on http://{server.host}:{server.port}  "
          f"(batch {cfg.BATCH_SIZE}, {'int8' if args.quantize else 'float'})",
          flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        server.stop()
        ex.shutdown()


if __name__ == "__main__":
    main()
