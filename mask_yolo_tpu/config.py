"""Configuration system.

Preserves the subclass-and-override surface of the reference Config class
(/root/reference/myolo/config.py:15-257): hyperparameters are class attributes,
users subclass `Config` and override what they need, and `display()` dumps the
resolved values. On top of that surface we add derived-value validation and a
`frozen_dict()` export used to build static (hashable) arguments for jitted
functions — under XLA every shape-determining config value must be a Python
constant at trace time.
"""

from __future__ import annotations

import numpy as np


class Config:
    """Base configuration. Subclass and override (reference: config.py:15-22).

    All shape-determining values (GRID_H/W, N_BOX, NUM_CLASSES, IMAGE_SHAPE,
    TRAIN_ROIS_PER_IMAGE, MASK_SHAPE, ...) are static: they are baked into the
    compiled XLA program. Changing them requires re-tracing, which happens
    automatically because jitted entry points take the config as a static
    argument keyed by these values.
    """

    # Naming / labels (reference: config.py:26, 44)
    NAME = None
    LABELS = ["background", "object"]

    # Classes including background (reference: config.py:22)
    NUM_CLASSES = 1 + 1

    # YOLOv2 anchor priors in *grid units* (w0,h0,w1,h1,...)
    # (reference: config.py:28)
    ANCHORS = [1.27, 1.31, 1.95, 1.85, 2.40, 2.72, 3.20, 3.32, 5.06, 5.05]

    # Grid geometry (reference: config.py:30-32)
    N_BOX = 5
    GRID_H, GRID_W = 7, 7
    TRUE_BOX_BUFFER = 10

    BATCH_SIZE = 1

    # Loss scales (reference: config.py:34-38)
    OBJECT_SCALE = 5.0
    COORD_SCALE = 1.0
    CLASS_SCALE = 1.0
    NO_OBJECT_SCALE = 1.0
    WARM_UP_BATCHES = 0
    CLASS_WEIGHTS = None  # defaults to ones(NUM_CLASSES); resolved lazily

    # Training schedule (reference: config.py:62-67). 0 = one full pass over
    # the dataset per epoch / every validation batch (this framework's
    # default; the reference's Keras defaults were 1000/5). Positive values
    # cap the train steps and validation batches per epoch.
    STEPS_PER_EPOCH = 0
    VALIDATION_STEPS = 0

    # Backbone (reference: config.py:74-92). "mobilenet" or "resnet50_fpn".
    BACKBONE = "mobilenet"
    BACKBONE_STRIDES = [8]
    TOP_FEATURE_MAP_DEPTH = 256
    SECOND_PHASE_YOLO_DEPTH = 512

    # FPN settings (used when BACKBONE == "resnet50_fpn")
    FPN_PYRAMID_SIZE = 256

    # Mini-mask (reference: config.py:122-123)
    USE_MINI_MASK = False
    MINI_MASK_SHAPE = (56, 56)

    # Mean pixel for mold_image (reference: config.py:159, myolo_utils.py:153)
    MEAN_PIXEL = [123.7, 116.8, 103.9]

    # Input geometry (reference: config.py:145-156, 232)
    IMAGE_RESIZE_MODE = "square"
    IMAGE_MIN_DIM = 224
    IMAGE_MAX_DIM = 224
    IMAGE_MIN_SCALE = 0
    IMAGE_CHANNEL_COUNT = 3
    IMAGE_SHAPE = [224, 224, 3]

    # ROI head geometry (reference: config.py:166-180)
    TRAIN_ROIS_PER_IMAGE = GRID_H * GRID_W * N_BOX
    POOL_SIZE = 7
    MASK_POOL_SIZE = 14
    MASK_SHAPE = [28, 28]
    MAX_GT_INSTANCES = 10
    # Train-time mask branch runs on only the top-M assignment slots
    # (positives first) — loss-identical while an image has ≤ M positive
    # proposals, and the branch cost is linear in M. 0 = all
    # TRAIN_ROIS_PER_IMAGE slots (the reference's behavior, model.py:876-882).
    MASK_TRAIN_TOP_ROIS = 0
    # Run training as S-step scan superbatches: ONE host→device upload and
    # ONE dispatch per S optimizer steps (lax.scan of the identical step
    # body — update-sequence-equal to S single dispatches,
    # tests/test_train.py). A wall-clock lever only where per-dispatch
    # latency dominates the step. 0/1 = one dispatch per step (the default).
    TRAIN_SCAN_STEPS = 0

    # Optimization (reference: config.py:200-230)
    LEARNING_RATE = 0.001
    LEARNING_MOMENTUM = 0.9
    # LR schedule over the whole train() call. "constant" is the reference's
    # behavior (fixed Adam lr, model.py:1071-1075). "cosine" decays from
    # LEARNING_RATE to LEARNING_RATE * LR_FINAL_FRACTION over the run, after
    # LR_WARMUP_STEPS of linear warm-up (warm-up also applies to "constant"
    # when > 0). On resume_from, the schedule position is the restored global
    # step, and the decay horizon is the *current* call's total steps.
    LR_SCHEDULE = "constant"
    LR_WARMUP_STEPS = 0
    LR_FINAL_FRACTION = 0.02
    # Explicit cosine horizon in optimizer steps; 0 = derive from the
    # train() call (epochs × steps/epoch). Set this when training runs in
    # several resumed processes (stop_after_epoch + resume_from) so every
    # segment decays against the SAME horizon.
    LR_TOTAL_STEPS = 0
    WEIGHT_DECAY = 0.0001
    LOSS_WEIGHTS = {"yolo_sum_loss": 1.0, "myolo_mask_loss": 1.0}
    TRAIN_BN = False
    GRADIENT_CLIP_NORM = 5.0

    # Inference pipeline (new; the reference hardcodes these per call site:
    # obj 0.35 in infer_yolo model.py:1230, 0.2 in detect model.py:1281,
    # nms 0.3 both, NMB 0.7 model.py:1304)
    OBJ_THRESHOLD = 0.35
    NMS_THRESHOLD = 0.3
    # second-stage class-aware NMS in detect() (the reference's NMB pass uses
    # 0.7, model.py:1304 — loose enough to keep near-duplicates; 0.3 measures
    # better AP on Shapes)
    DETECTION_NMS_THRESHOLD = 0.7
    DETECTION_MAX_INSTANCES = 10  # top-K kept after NMS (ref: top10, model.py:1292)
    # Run the mask branch + paste only on the MASK_TOP_K highest-scoring NMS
    # survivors (slots re-sorted valid-first). 0 = all DETECTION_MAX_INSTANCES
    # slots (exact). Output-identical whenever ≤ MASK_TOP_K boxes survive;
    # the mask branch cost is linear in this value.
    MASK_TOP_K = 0

    # infer_yolo: run the per-class NMS on only the N highest-max-prob boxes
    # (output-identical while ≤ N boxes pass OBJ_THRESHOLD; 0 = full grid).
    # Set on large-grid configs where grid_boxes ≫ plausible detections.
    INFER_YOLO_TOP_N = 0

    # infer_yolo: compact each class's above-threshold boxes to its own top-K
    # slots BEFORE the greedy suppression chain (output-identical while every
    # class has ≤ K boxes over OBJ_THRESHOLD — per class, not per image, so a
    # far tighter bound than INFER_YOLO_TOP_N's shared pool). Cuts the
    # sequential chain from N steps to K and the IoU slab by (N/K)²; takes
    # precedence over INFER_YOLO_TOP_N when both are set. 0 = off.
    INFER_YOLO_PER_CLASS_K = 0

    # Keep only the newest N per-epoch checkpoints (0 = keep all, the
    # reference's ModelCheckpoint behavior — model.py:1026)
    MAX_CHECKPOINTS = 5

    # Compute precision: "bfloat16" activations with float32 params/outputs,
    # or "float32" for parity testing. On a GPU, float32 matmuls and convs
    # run in TF32 unless jax.default_matmul_precision("highest") is set —
    # a float32 reference sets it.
    COMPUTE_DTYPE = "float32"

    # int8-PTQ path: also quantize the depthwise convs. None = auto (on for
    # inputs ≥ 320², int8 depthwise; bf16 below). The threshold is not
    # measured on the GPU yet.
    QUANT_DW_INT8 = None

    # int8-PTQ path: keep the 3×3/s2 RGB stem conv (contraction K = 27) in
    # bf16, which is also closer to the f32 reference. None = auto (bf16
    # stem for inputs ≥ 320², int8 below). The threshold is not measured
    # on the GPU yet.
    QUANT_STEM_BF16 = None

    # int8 detect path: fold the per-ROI class selection into the final
    # mask conv (gather each ROI's 256→1 filter by class id) instead of
    # computing all NUM_CLASSES masks and one-hot-selecting afterwards.
    # The class conv writes NUM_CLASSES× less, but the per-ROI weight
    # gather turns one GEMM ([K·p², 256]×[256, 81]) into per-sample matvecs
    # with no filter reuse. Default OFF; the arithmetic is bit-compatible.
    QUANT_FOLD_MASK_SELECT = False

    # int8 detect path: ROIAlign crop at default matmul precision instead
    # of HIGHEST. Default OFF: the default keeps f32 accumulation
    # (bit-parity with the reference crop).
    QUANT_FAST_CROP = False

    # QAT (QuantizedDetector.finetune) distillation objective: weight on
    # the mask-probability term relative to the grid/fmap terms. The
    # 81-class int8 residual lives in the mask branch; >1 biases the
    # finetune toward closing it.
    QUANT_QAT_MASK_WEIGHT = 1.0

    # Mask-head layer names to keep in bf16 on the int8 path (e.g.
    # ("mask_conv4",) or ("mask_deconv",)) — the leave-layer-f32 ablation
    # for localizing the residual int8 mask-AP cost. () = all int8.
    QUANT_MASK_F32_LAYERS = ()

    # int8-PTQ activation calibration statistic: 100 = absmax (default);
    # < 100 clips to that percentile of |activations|. Measured at the
    # 81-class point: clipping HURTS (99.9% halved AP — the extreme
    # activations carry the detector's signal; docs/QUALITY.md), so
    # absmax stays the default.
    QUANT_CALIB_PCT = 100.0

    # int8-PTQ: per-INPUT-channel activation scales. Each quantized conv's
    # input is quantized with one scale per channel (calibrated per-channel
    # absmax); the scales fold into the already-per-output-channel weight
    # quantization, so the int8 matmul itself is unchanged — only the
    # cheap elementwise (re)quantize becomes a per-channel multiply.
    # Recovers resolution lost to cross-channel range imbalance without
    # clipping anything (vs QUANT_CALIB_PCT, which measured WORSE here).
    QUANT_PER_CHANNEL_ACT = False

    # int8-PTQ: per-output-channel bias correction (Nagel et al. 2019,
    # "Data-Free Quantization..."): after weight quantization, the expected
    # pre-activation error E[conv_f32(x) - deq(conv_int8(quant(x)))] over
    # the calibration batch is folded into each quantized layer's bias on
    # the int8 path only (f32 parity paths are untouched).
    QUANT_BIAS_CORRECT = False

    # Host data-loading workers for data_generator (0 = load in the calling
    # thread). The reference computed cpu_count() but left Keras
    # multiprocessing disabled (model.py:1045, 1057-1058). DATA_WORKER_MODE:
    # "thread" (cheap; the C++ kernels release the GIL but Python-level
    # per-image code still serializes) or "process" (fork-start workers —
    # real CPU parallelism; same batches as thread mode, bit for bit).
    DATA_WORKERS = 0
    DATA_WORKER_MODE = "thread"

    # Parallelism (the reference has none — SURVEY.md §2.3). Axis sizes for the
    # device mesh; DATA_PARALLEL=0 means "all available devices".
    DATA_PARALLEL = 0
    MODEL_PARALLEL = 1

    def __init__(self):
        self.validate()

    # -- derived helpers ---------------------------------------------------

    @property
    def num_anchors(self) -> int:
        return len(self.ANCHORS) // 2

    @property
    def anchors_wh(self) -> np.ndarray:
        """[N_BOX, 2] anchor (w, h) priors in grid units."""
        return np.asarray(self.ANCHORS, dtype=np.float32).reshape(-1, 2)

    @property
    def class_weights(self) -> np.ndarray:
        if self.CLASS_WEIGHTS is None:
            return np.ones(self.NUM_CLASSES, dtype=np.float32)
        return np.asarray(self.CLASS_WEIGHTS, dtype=np.float32)

    @property
    def grid_boxes(self) -> int:
        """Total predicted boxes per image (reference: 7*7*5 = 245)."""
        return self.GRID_H * self.GRID_W * self.N_BOX

    def validate(self):
        h, w = self.IMAGE_SHAPE[:2]
        if h % 32 != 0 or w % 32 != 0:
            # reference enforces this at model build (model.py:791-794)
            raise ValueError(
                "Image size must be divisible by 32 (e.g. 224, 256, 288...)."
            )
        if self.num_anchors != self.N_BOX:
            raise ValueError(
                f"len(ANCHORS)//2 == {self.num_anchors} must equal N_BOX == {self.N_BOX}"
            )
        if len(self.LABELS) not in (0, self.NUM_CLASSES):
            raise ValueError(
                f"LABELS has {len(self.LABELS)} entries but NUM_CLASSES={self.NUM_CLASSES}"
            )

    def static_key(self) -> tuple:
        """Hashable tuple of every shape/compile-relevant value. Used as the
        static argument for jit caching."""
        return (
            self.NUM_CLASSES,
            tuple(float(a) for a in self.ANCHORS),
            self.N_BOX,
            self.GRID_H,
            self.GRID_W,
            self.TRUE_BOX_BUFFER,
            tuple(self.IMAGE_SHAPE),
            self.TRAIN_ROIS_PER_IMAGE,
            self.MASK_POOL_SIZE,
            tuple(self.MASK_SHAPE),
            self.MAX_GT_INSTANCES,
            self.TOP_FEATURE_MAP_DEPTH,
            self.SECOND_PHASE_YOLO_DEPTH,
            self.BACKBONE,
            self.COMPUTE_DTYPE,
            float(self.OBJECT_SCALE),
            float(self.NO_OBJECT_SCALE),
            float(self.COORD_SCALE),
            float(self.CLASS_SCALE),
            int(self.WARM_UP_BATCHES),
            bool(self.USE_MINI_MASK),
            tuple(self.MINI_MASK_SHAPE),
            float(self.OBJ_THRESHOLD),
            float(self.NMS_THRESHOLD),
            int(self.DETECTION_MAX_INSTANCES),
            float(self.DETECTION_NMS_THRESHOLD),
            int(getattr(self, "MASK_TOP_K", 0) or 0),
            int(getattr(self, "MASK_TRAIN_TOP_ROIS", 0) or 0),
            int(getattr(self, "INFER_YOLO_TOP_N", 0) or 0),
            int(getattr(self, "INFER_YOLO_PER_CLASS_K", 0) or 0),
        )

    def display(self):
        """Print all configuration values (reference: config.py:251-257)."""
        print("\nConfigurations:")
        for a in dir(self):
            if not a.startswith("__") and not callable(getattr(self, a)):
                print("{:30} {}".format(a, getattr(self, a)))
        print("\n")

    def to_dict(self) -> dict:
        return {
            a: getattr(self, a)
            for a in dir(self)
            if not a.startswith("__") and not callable(getattr(self, a))
        }


class CocoStyleConfig(Config):
    """The BASELINE.md scale-out operating point: batched 80-class COCO-style
    inference at 416² with on-device NMS + mask unmold, batch-sharded over
    the devices of a mesh (BASELINE.json configs list).

    416/32 = 13×13 grid; anchors are the standard YOLOv2-VOC/COCO priors in
    grid units. LABELS left empty (= any 81-way label set)."""

    NAME = "coco416"
    LABELS = []
    NUM_CLASSES = 1 + 80
    IMAGE_SHAPE = [416, 416, 3]
    IMAGE_MIN_DIM = 416
    IMAGE_MAX_DIM = 416
    GRID_H, GRID_W = 13, 13
    N_BOX = 5
    # YOLOv2 COCO anchor priors (grid units)
    ANCHORS = [0.57273, 0.677385, 1.87446, 2.06253, 3.33843, 5.47434,
               7.88282, 3.52778, 9.77052, 9.16828]
    TRAIN_ROIS_PER_IMAGE = 13 * 13 * 5
    MAX_GT_INSTANCES = 50
    TRUE_BOX_BUFFER = 30
    DETECTION_MAX_INSTANCES = 100
    # masks for the 48 best survivors (output-identical while ≤ 48 boxes
    # survive NMS). Measured on the r5 textured 81-class campaign (64 dense
    # eval images, up to 48 instances each — asset/coco80_masktopk_r5.json):
    # K=32 costs −0.060 mask AP50 vs masking all 100 slots (0.682 vs 0.742);
    # K=48 recovers it (0.741) at half the mask-branch cost of K=100. The
    # branch is linear in K, so drop back to 32 only for sparse-scene
    # deployments (the reference masks ALL boxes, model.py:926-931).
    MASK_TOP_K = 48
    COMPUTE_DTYPE = "bfloat16"
    USE_MINI_MASK = True
    MASK_TRAIN_TOP_ROIS = 128
    # 13·13·5 = 845 grid boxes; per-class NMS on the top 256 by max prob
    # (identical while ≤ 256 boxes pass threshold; single unrolled NMS pass)
    INFER_YOLO_TOP_N = 256
