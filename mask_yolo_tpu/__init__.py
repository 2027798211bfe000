"""mask_yolo_tpu — an instance-segmentation framework in JAX.

A from-scratch JAX/XLA rebuild of the Mask-YOLO architecture
(one-stage YOLOv2 anchor-grid detector + Mask R-CNN-style mask branch on a
truncated MobileNetV1 backbone). Public surface mirrors the reference
(/root/reference/myolo): `Config`, `MaskYOLO`, dataset classes, and
`visualize` — while every compute path is an XLA program: training steps are
pjit-sharded over a device mesh, and the full image→boxes+masks inference
pipeline (decode, NMS, top-K, ROIAlign, mask paste) runs on-chip.
"""

from .config import Config
from .evaluate import evaluate_dataset, make_ap_eval_callback
from .export import ExportedDetector
from .model import MaskYOLO

__all__ = ["Config", "MaskYOLO", "ExportedDetector", "evaluate_dataset",
           "make_ap_eval_callback"]

__version__ = "0.1.0"
