"""MaskYOLO — the user-facing orchestrator.

API-parity rebuild of the reference MaskYOLO class
(/root/reference/myolo/model.py:761-1391): same constructor signature
(mode ∈ {'training', 'inference', 'yolo'}, config, model_dir,
yolo_pretrain_dir, yolo_trainable) and same methods (build, train, compile,
set_trainable, load_weights, infer_yolo, detect, decode_masks) — but instead
of wiring a Keras graph it owns a module (models/nn.py) + parameter pytree and a set of
jitted pipelines, and instead of host-side NumPy post-processing everything
from decode to mask pasting runs on-chip (pipelines.py).

Reference bugs deliberately fixed (SURVEY.md §7 "reference bugs"):
 * detect() no longer reloads weights on every call (model.py:1265) — weights
   load once; pass weights_dir=None after the first call;
 * the hardcoded `nmb_indices = [109, 130]` debug override (model.py:1306) is
   gone — real NMS output is used;
 * train() loads the whole dataset instead of a hardcoded 50/6 preload
   (model.py:995-1006);
 * the warm-up counter is replica-safe (an explicit step argument).
"""

from __future__ import annotations

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import pipelines
from .data.pipeline import BatchGenerator, preload_dataset
from .models.network import MaskYoloNet
from .parallel.mesh import build_mesh, replicate_tree
from .train import state as state_lib
from .train import trainer as trainer_lib
from .utils import compile_cache


def _deep_merge_by_name(current, loaded, exclude: set, report: dict,
                        _path: str = ""):
    """Leaf-wise by-name merge of `loaded` into `current` (Keras by_name
    semantics): a leaf is taken iff the same path exists in `current` with
    the same shape; mismatches are recorded in report['shape_mismatch']."""
    import numpy as _np

    if not isinstance(current, dict) or not isinstance(loaded, dict):
        cur = _np.asarray(current)
        new = _np.asarray(loaded)
        if cur.shape != new.shape:
            report["shape_mismatch"].append(
                f"{_path}: have {cur.shape}, file has {new.shape}")
            return current
        return jnp.asarray(new, dtype=cur.dtype)
    merged = dict(current)
    for k, v in loaded.items():
        if k in exclude:
            continue
        if k in merged:
            merged[k] = _deep_merge_by_name(merged[k], v, exclude, report,
                                            f"{_path}/{k}" if _path else k)
        else:
            report.setdefault("skipped", []).append(f"{_path}/{k}")
    return merged


class MaskYOLO:
    """Build/train/infer orchestrator. See module docstring."""

    def __init__(self, mode, config, model_dir=None, yolo_pretrain_dir=None,
                 yolo_trainable=True, seed: int = 0):
        assert mode in ["training", "inference", "yolo"]
        self.mode = mode
        self.config = config
        self.model_dir = model_dir or "./checkpoints"
        self.yolo_pretrain_dir = yolo_pretrain_dir
        self.yolo_trainable = yolo_trainable
        self.seed = seed
        self.epoch = 0
        self._mesh = None
        self._tx = None
        self._train_step = None
        self._detect_fn = None
        self._infer_yolo_fn = None
        self._qdet = None
        self._sharded_det = None
        self.build(mode=mode, config=config)

    # -- construction --------------------------------------------------------

    def build(self, mode, config):
        h, w = config.IMAGE_SHAPE[:2]
        if w % 32 != 0 or h % 32 != 0:
            raise Exception(
                "Image size must be dividable by 32 to adapt with YOLO framework. "
                "For example, use 224, 256, 288, 320, 356, ... etc. ")
        if config.GRID_H != h // 32 or config.GRID_W != w // 32:
            raise Exception(
                f"GRID_{{H,W}}={config.GRID_H},{config.GRID_W} must equal "
                f"IMAGE_SHAPE/32={h//32},{w//32}")

        self.net = MaskYoloNet(
            num_classes=config.NUM_CLASSES,
            n_box=config.N_BOX,
            top_feature_map_depth=config.TOP_FEATURE_MAP_DEPTH,
            mask_pool_size=config.MASK_POOL_SIZE,
            backbone=config.BACKBONE,
            compute_dtype=config.COMPUTE_DTYPE,
            image_hw=(h, w),
        )
        rng = jax.random.PRNGKey(self.seed)
        dummy_img = jnp.zeros((1, h, w, 3), jnp.float32)
        dummy_rois = jnp.zeros((1, 8, 4), jnp.float32)
        # jit the init: eager init dispatches hundreds of tiny ops; jitted
        # it is one compiled program
        variables = jax.jit(
            lambda r, i, ro: self.net.init(r, i, ro, train=False)
        )(rng, dummy_img, dummy_rois)
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats", {})

        if self.yolo_pretrain_dir is not None:
            # load pretrained backbone+YOLO-branch weights and optionally
            # freeze them (reference model.py:854-868). Keras .h5 files from
            # the reference codebase are converted on the fly (utils/keras_h5)
            if str(self.yolo_pretrain_dir).endswith((".h5", ".hdf5")):
                report = self.load_weights_from_keras_h5(self.yolo_pretrain_dir)
                # a pretrain file that contributes no YOLO-branch weights
                # would silently leave a random (and, with
                # yolo_trainable=False, frozen) head — fail loudly instead
                if not any(p and p[0] == "yolo"
                           for p in report.get("loaded_paths", ())):
                    raise ValueError(
                        f"{self.yolo_pretrain_dir} contained no YOLO-branch "
                        f"weights (loaded: {report['loaded']}, skipped: "
                        f"{report['skipped']})")
            else:
                self.load_weights(self.yolo_pretrain_dir, by_name=True)

    @property
    def variables(self):
        return {"params": self.params, "batch_stats": self.batch_stats}

    @property
    def mesh(self):
        if self._mesh is None:
            # global batch = per-process BATCH_SIZE × processes (multi-host)
            gbs = int(self.config.BATCH_SIZE) * max(jax.process_count(), 1)
            self._mesh = build_mesh(self.config, batch_size=gbs)
        return self._mesh

    # -- training ------------------------------------------------------------

    def compile(self, learning_rate, momentum=None, layer_regex: str = ".*",
                total_steps: int = 0):
        """Create the optimizer (Adam, reference model.py:1071-1075) and the
        jitted train step. `momentum` is accepted for signature parity; Adam
        ignores it exactly like the reference does.

        yolo_trainable=False freezes backbone AND yolo head: the reference
        builds the whole image→yolo_output sub-model and sets trainable on
        EVERY layer in that path — which includes the mobilenet graph —
        (model.py:861-868: KM.Model([input_image, ...], [yolo_output]);
        `for layer in model.layers: layer.trainable = self.yolo_trainable`),
        so ("backbone", "yolo") is the faithful scope."""
        frozen = () if self.yolo_trainable else ("backbone", "yolo")
        self._tx = state_lib.make_optimizer(
            learning_rate, self.config, params=self.params,
            layer_regex=layer_regex, frozen_prefixes=frozen,
            total_steps=total_steps)
        self._train_step = trainer_lib.make_train_step(
            self.net, self.config, self._tx,
            mode="training" if self.mode == "training" else "yolo")
        scan_s = int(getattr(self.config, "TRAIN_SCAN_STEPS", 0) or 0)
        self._scan_train_step = (
            trainer_lib.make_scan_train_step(
                self.net, self.config, self._tx,
                mode="training" if self.mode == "training" else "yolo")
            if scan_s > 1 else None)

    def set_trainable(self, layer_regex, **_):
        """Record the trainable-layer regex; applied at compile()."""
        self._layer_regex = layer_regex if isinstance(layer_regex, str) else ".*"

    def train(self, train_dataset, val_dataset, learning_rate, epochs,
              layers="all", augmentation=None, custom_callbacks=None,
              no_augmentation_sources=None, verbose=True, profile_dir=None,
              resume_from=None, stop_after_epoch=None):
        """Train. Same signature as the reference (model.py:943).

        custom_callbacks: list of callables invoked as
        cb(epoch, train_metrics, val_loss, state) after each epoch — the
        stand-in for Keras callbacks (reference model.py:1030-1034).
        profile_dir: capture a jax.profiler trace of a few steps of the
        first epoch into this directory.
        resume_from: path of a checkpoint written by a previous train();
        restores params, BN stats, optimizer moments AND the epoch counter,
        then continues to `epochs` (the resume the reference left manual —
        initial_epoch commented out at model.py:1050).
        stop_after_epoch: return cleanly once this epoch completes (its
        checkpoint is already on disk) while schedules/targets still see the
        full `epochs` horizon — the building block for segmented training:
        run a bounded slice per process, resume_from the newest checkpoint in
        a fresh process.
        """
        compile_cache.enable()
        layer_regex = {"all": ".*"}.get(layers, layers)

        mode = "training" if self.mode == "training" else "yolo"
        if augmentation is not None:
            # reference semantics: augmentation is re-sampled per sample per
            # epoch (fit_generator pulls from the generator forever,
            # model.py:1047) — route through the endless generator instead of
            # the one-shot preload
            from .data.pipeline import GeneratorEpochSource, data_generator

            # floor, not ceil: data_generator only emits full B-sized batches
            # (the remainder rolls into the next pull), so ceil would drift
            # the epoch boundary off the dataset pass / shuffle point
            steps = max(1, len(train_dataset.image_ids)
                        // self.config.BATCH_SIZE)
            train_gen = GeneratorEpochSource(
                data_generator(train_dataset, self.config, shuffle=True,
                               augmentation=augmentation, mode=mode),
                steps, self.config)
        else:
            train_data = preload_dataset(train_dataset, self.config)
            train_gen = BatchGenerator(train_data, self.config, mode=mode,
                                       shuffle=True, seed=self.seed)
        val_data = preload_dataset(val_dataset, self.config)
        val_gen = BatchGenerator(val_data, self.config, mode=mode,
                                 shuffle=False)

        self.set_trainable(layer_regex)
        # cosine decay horizon = steps that will actually run: run_epoch caps
        # each epoch at min(STEPS_PER_EPOCH, len(generator)) (_LimitedSource)
        steps_cap = int(getattr(self.config, "STEPS_PER_EPOCH", 0) or 0)
        steps_per_epoch = (min(steps_cap, len(train_gen)) if steps_cap
                           else len(train_gen))
        self.compile(learning_rate, self.config.LEARNING_MOMENTUM,
                     layer_regex=layer_regex,
                     total_steps=max(1, epochs * steps_per_epoch))

        mesh = self.mesh
        state = state_lib.create_train_state(
            replicate_tree(self.params, mesh),
            replicate_tree(self.batch_stats, mesh),
            self._tx)
        if resume_from is not None:
            state, self.epoch = state_lib.resume_train_state(resume_from, state)
            state = state_lib.TrainState(
                params=replicate_tree(state.params, mesh),
                batch_stats=replicate_tree(state.batch_stats, mesh),
                opt_state=replicate_tree(state.opt_state, mesh),
                step=state.step)
            if verbose:
                print(f"Resumed from {resume_from} at epoch {self.epoch}")
        eval_step = trainer_lib.make_eval_step(self.net, self.config, mode)

        os.makedirs(self.model_dir, exist_ok=True)
        # persist the resolved config next to the checkpoints (reproducibility;
        # the reference only ever printed it, config.py:251-257)
        import json
        with open(os.path.join(self.model_dir, "config.json"), "w") as f:
            json.dump({k: v for k, v in self.config.to_dict().items()
                       if isinstance(v, (int, float, str, bool, list, tuple,
                                         dict, type(None)))},
                      f, indent=2, default=str)
        start_epoch = self.epoch
        for epoch in range(start_epoch, epochs):
            if verbose:
                print(f"Epoch {epoch + 1}/{epochs}")
            state, metrics = trainer_lib.run_epoch(
                self._train_step, state, train_gen, mesh=mesh, verbose=verbose,
                profile_dir=profile_dir if epoch == start_epoch else None,
                max_steps=int(getattr(self.config, "STEPS_PER_EPOCH", 0) or 0),
                scan_step=self._scan_train_step,
                scan_steps=int(getattr(self.config, "TRAIN_SCAN_STEPS", 0)
                               or 0))
            train_gen.on_epoch_end()

            # validation (reference: fit_generator validation_data), capped
            # by VALIDATION_STEPS when positive (reference config.py:67)
            val_metrics = []
            from .parallel.mesh import shard_batch
            val_steps = int(getattr(self.config, "VALIDATION_STEPS", 0) or 0)
            n_val = min(len(val_gen), val_steps) if val_steps > 0 else len(val_gen)
            for i in range(n_val):
                val_metrics.append(eval_step(state, shard_batch(val_gen[i], mesh)))
            val_loss = float(np.mean([float(m["loss"]) for m in val_metrics]))
            if verbose:
                print(f"  train: {metrics}  val_loss: {val_loss:.4f}")

            ckpt_path = os.path.join(
                self.model_dir,
                "saved_model_" + datetime.datetime.now().strftime(
                    "%b%d-%H-%M-%S") + f"_e{epoch + 1:04d}")
            state_lib.save_checkpoint(ckpt_path, state, epoch=epoch + 1)
            self._rotate_checkpoints()
            self.epoch = epoch + 1
            # per-epoch scalar history (the observability the reference got
            # from its TensorBoard callback, model.py:1024-1027)
            import json
            with open(os.path.join(self.model_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps({"epoch": epoch + 1, "val_loss": val_loss,
                                    **metrics}) + "\n")
            for cb in custom_callbacks or ():
                cb(epoch, metrics, val_loss, state)
            if stop_after_epoch is not None and epoch + 1 >= stop_after_epoch:
                if verbose:
                    print(f"Stopping after epoch {epoch + 1} "
                          f"(stop_after_epoch; target {epochs})")
                break

        self.params = jax.device_get(state.params)
        self.batch_stats = jax.device_get(state.batch_stats)
        self._invalidate_infer_fns()  # weights changed; drop cached/quantized graphs
        return state

    def _rotate_checkpoints(self):
        """Keep only the newest Config.MAX_CHECKPOINTS epoch checkpoints
        (0 = keep all). The reference's ModelCheckpoint wrote one file per
        epoch forever (model.py:1026); long runs accumulate GBs."""
        import shutil

        keep = int(getattr(self.config, "MAX_CHECKPOINTS", 0) or 0)
        if keep <= 0:
            return
        ckpts = sorted(
            (d for d in os.listdir(self.model_dir)
             if d.startswith("saved_model_")
             and os.path.isdir(os.path.join(self.model_dir, d))),
            key=lambda d: os.path.getmtime(os.path.join(self.model_dir, d)))
        for stale in ckpts[:-keep]:
            shutil.rmtree(os.path.join(self.model_dir, stale),
                          ignore_errors=True)

    # -- checkpoint I/O --------------------------------------------------------

    def save_weights(self, filepath):
        import optax

        dummy_tx = optax.identity()
        st = state_lib.TrainState(params=self.params,
                                  batch_stats=self.batch_stats,
                                  opt_state=dummy_tx.init(self.params),
                                  step=jnp.zeros((), jnp.int32))
        state_lib.save_checkpoint(filepath, st, epoch=self.epoch)

    def load_weights(self, filepath, by_name=False, exclude=None):
        """Restore params (and batch stats) from a checkpoint directory
        written by save_weights/train (train/state.py), with the
        reference's by_name/exclude subtree semantics (model.py:1157-1196)."""
        self._invalidate_infer_fns()
        ckpt = state_lib.load_checkpoint(filepath)
        self.params = state_lib.merge_params(self.params, ckpt["params"],
                                             by_name=by_name, exclude=exclude)
        if ckpt.get("batch_stats"):
            self.batch_stats = state_lib.merge_params(
                self.batch_stats, ckpt["batch_stats"],
                by_name=by_name, exclude=exclude)

    def load_weights_from_keras_h5(self, filepath, exclude=None):
        """Load weights from a Keras-2 h5 file written by the REFERENCE
        codebase (pretrained YOLO branch, model.py:854-868, or a full
        ModelCheckpoint file, model.py:1026). Layers are merged by name with
        shape checking (Keras by_name semantics); `exclude` skips top-level
        modules (e.g. ["mask"]). Returns the conversion report dict."""
        from .utils import keras_h5

        self._invalidate_infer_fns()
        params, stats, report = keras_h5.load_keras_h5(filepath)
        report.setdefault("shape_mismatch", [])
        self.params = _deep_merge_by_name(self.params, params,
                                          set(exclude or ()), report)
        self.batch_stats = _deep_merge_by_name(self.batch_stats, stats,
                                               set(exclude or ()), report)
        if report["skipped"] or report["shape_mismatch"]:
            import warnings
            warnings.warn(
                f"keras_h5 load from {filepath}: skipped layers "
                f"{report['skipped']}, shape mismatches "
                f"{report['shape_mismatch']}", stacklevel=2)
        return report

    def export_model(self, path, batch_size=None, input_dtype="uint8",
                     platforms=None):
        """AOT-export the detect pipeline (weights baked in) to a portable
        StableHLO artifact at `path` — the deployment format a serving
        process loads with `export.ExportedDetector.load(path)` needing only
        jax, no model code. batch_size=None exports a symbolic batch
        dimension (one artifact, any B). After quantize(), the active int8
        pipeline is what gets exported (consistent with detect/detect_batch
        serving int8 then). Returns the artifact header dict.
        See export.py for the format and rationale."""
        from . import export as export_lib

        if self._qdet is not None:
            exported, header = export_lib.export_detect_fn(
                self._qdet.detect_fn(), self.config, batch_size=batch_size,
                input_dtype=input_dtype, platforms=platforms,
                compute_path="int8")
        else:
            exported, header = export_lib.export_detect(
                self.net, self.variables, self.config, batch_size=batch_size,
                input_dtype=input_dtype, platforms=platforms)
        export_lib.save_exported(exported, header, path)
        return header

    # -- inference -------------------------------------------------------------

    def _invalidate_infer_fns(self):
        """Drop cached inference callables. A quantized detect path closes
        over a weight snapshot (quant.py), so any weight change (load_weights,
        train) must invalidate it or detect would silently keep serving the
        stale graph."""
        self._detect_fn = None
        self._infer_yolo_fn = None
        self._qdet = None
        self._sharded_det = None

    def _ensure_infer_fns(self):
        compile_cache.enable()
        if self._detect_fn is None:
            net, config = self.net, self.config

            @jax.jit
            def detect_fn(variables, images):
                return pipelines.detect_outputs(net, variables, images, config)

            @jax.jit
            def infer_yolo_fn(variables, images):
                return pipelines.infer_yolo_outputs(net, variables, images, config)

            self._detect_fn = detect_fn
            self._infer_yolo_fn = infer_yolo_fn

    def quantize(self, calib_images, finetune_steps: int = 0,
                 finetune_lr: float = 1e-5):
        """Switch this model's detect pipeline to the int8 quantized path
        (post-training quantization; see quant.py). calib_images:
        [N, H, W, 3] float in [0, 1] used for activation-range calibration.

        finetune_steps > 0 additionally runs label-free quantization-aware
        fine-tuning (QuantizedDetector.finetune): the quantized layers are
        distilled against the f32 teacher on calib_images with fake-quant in
        the loop, recovering accuracy PTQ alone loses at many-class points.

        New capability vs the float32-only reference.

        The quantized graph snapshots the current weights: any later
        load_weights()/train() invalidates it (detect falls back to the float
        path with the new weights) — re-call quantize() to re-quantize."""
        from .quant import QuantizedDetector

        calib = np.asarray(calib_images)
        if np.issubdtype(calib.dtype, np.integer):
            # accept uint8 images like detect() does (same footgun as the
            # export.py input normalization): calibrating on 0-255 where
            # [0, 1] is expected would silently wreck every scale
            calib = calib.astype(np.float32) / 255.0
        qdet = QuantizedDetector.from_variables(
            jax.device_get(self.variables), self.config, calib, net=self.net)
        if finetune_steps:
            qdet.finetune(calib, steps=finetune_steps, lr=finetune_lr)
        self._ensure_infer_fns()
        self._detect_fn = lambda variables, images: qdet.detect_outputs(images)
        # detection-only inference serves the same int8 trunk
        self._infer_yolo_fn = (
            lambda variables, images: qdet.infer_yolo_outputs(images))
        self._qdet = qdet
        return qdet

    def infer_yolo(self, image, weights_dir=None, save_path="./img_results/",
                   display=True):
        """Detection-only inference on one uint8 image (reference
        model.py:1198-1236). Returns a list of BoundBox objects
        (utils.host_ops.BoundBox: reference-compatible .xmin/.get_label()/
        .get_score() surface AND dict access). After quantize() this serves
        the int8 trunk, like detect."""
        from .utils.host_ops import BoundBox

        assert list(image.shape) == list(self.config.IMAGE_SHAPE)
        assert image.dtype == np.uint8
        if weights_dir is not None:
            self.load_weights(weights_dir)
        self._ensure_infer_fns()

        images = jnp.asarray(image[None].astype(np.float32) / 255.0)
        out = jax.device_get(self._infer_yolo_fn(self.variables, images))
        boxes = []
        for i in np.where(out["valid"][0])[0]:
            x1, y1, x2, y2 = out["boxes"][0, i]
            boxes.append(BoundBox(
                xmin=float(x1), ymin=float(y1),
                xmax=float(x2), ymax=float(y2),
                score=float(out["scores"][0, i]),
                label=int(out["classes"][0, i])))
        if display:
            from .utils import visualize
            os.makedirs(save_path, exist_ok=True)
            now = datetime.datetime.now().strftime("%b-%d-%H-%M")
            visualize.draw_boxes_mpl(
                image, boxes, self.config.LABELS,
                save_file=os.path.join(save_path, f"InferYOLO-{now}.png"))
        return boxes

    def detect(self, image, weights_dir=None, save_path="./img_results/",
               cs_threshold=0.35, display=True):
        """Full detection + mask pipeline on one uint8 image (reference
        model.py:1238-1328). Returns [{bboxes, class_ids, confidence_scores,
        full_masks}] with full_masks as [H, W, N]."""
        assert list(image.shape) == list(self.config.IMAGE_SHAPE)
        assert image.dtype == np.uint8
        assert self.mode == "inference"
        if weights_dir is not None:
            self.load_weights(weights_dir)
        self._ensure_infer_fns()

        images = jnp.asarray(image[None].astype(np.float32) / 255.0)
        out = jax.device_get(self._detect_fn(self.variables, images))

        keep = out["valid"][0] & (out["scores"][0] >= cs_threshold)
        idx = np.where(keep)[0]
        boxes = out["boxes"][0][idx]
        class_ids = out["classes"][0][idx]
        scores = out["scores"][0][idx]
        full_masks = np.transpose(out["masks"][0][idx], (1, 2, 0))  # [H, W, N]

        results = [{
            "bboxes": boxes,
            "class_ids": class_ids,
            "confidence_scores": scores,
            "full_masks": full_masks,
        }]
        if display:
            from .utils import visualize
            os.makedirs(save_path, exist_ok=True)
            now = datetime.datetime.now().strftime("%b-%d-%H-%M")
            name = self.config.NAME or "MaskYOLO"
            visualize.display_instances(
                image, boxes, full_masks, class_ids, self.config.LABELS, scores,
                save_path=os.path.join(save_path, f"InferMaskYOLO-{name}-{now}.png"))
        return results

    def detect_batch(self, images_float, weights_dir=None, mesh=None):
        """Batched on-chip detection: [B, H, W, 3] float in [0, 1] →
        fixed-shape dict (see pipelines.detect_outputs). The throughput path.

        mesh: a jax.sharding.Mesh (or True to auto-build one over all
        devices) shards the batch over the mesh's 'data' axis — the
        BASELINE.md scale-out path (parallel/inference.ShardedDetector).
        B must divide by the data-axis size."""
        if weights_dir is not None:
            self.load_weights(weights_dir)
        if mesh is not None and mesh is not False:
            if self._qdet is not None:
                # an active quantized detector serves mesh requests too —
                # consistent with the non-mesh path after quantize()
                return self._qdet.detect_outputs(
                    images_float,
                    mesh=self.mesh if mesh is True else mesh)
            if self._sharded_det is None or (
                    mesh is not True and self._sharded_det.mesh is not mesh):
                from .parallel.inference import ShardedDetector

                self._sharded_det = ShardedDetector(
                    self.net, self.variables, self.config,
                    mesh=None if mesh is True else mesh)
            return self._sharded_det(images_float)
        self._ensure_infer_fns()
        return self._detect_fn(self.variables, images_float)

    def decode_masks(self, detections, myolo_mask, image_shape):
        """Host-side reformatting kept for API parity (model.py:1330-1391).
        detections: [1, N, 6]; myolo_mask: [1, N, mh, mw, C]."""
        det = np.asarray(detections[0])
        masks = np.asarray(myolo_mask[0])
        n = det.shape[0]
        boxes = det[:, :4]
        scores = det[:, 4]
        class_ids = det[:, 5].astype(np.int32)
        sel = masks[np.arange(n), :, :, class_ids]
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = area > 0
        boxes, class_ids, scores, sel = (boxes[keep], class_ids[keep],
                                         scores[keep], sel[keep])
        from .utils.host_ops import unmold_mask
        full = [unmold_mask(m, b, image_shape) for m, b in zip(sel, boxes)]
        full = (np.stack(full, axis=-1) if full
                else np.empty(tuple(image_shape[:2]) + (0,)))
        return boxes, class_ids, scores, full
