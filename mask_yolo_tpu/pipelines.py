"""End-to-end jitted pipelines: training forward, detection-only inference,
and the fully on-chip image→boxes+masks pass.

This is the component the reference spreads across MaskYOLO.build's three
modes plus host-side NumPy post-processing (/root/reference/myolo/model.py:
787-941, 1198-1391; myolo_utils.py:21-113, 883-912). Here each mode is a pure
function of (variables, arrays) that jit compiles into a single XLA program —
the device↔host boundary the reference crosses at model.py:1269 does not
exist: decode, NMS, top-K, mask selection and mask pasting all run on-chip.

Key performance decision (documented equivalence): the reference's inference
graph runs the mask branch on all 245 decoded boxes and selects afterwards
(model.py:926-931, 1292-1310). The mask branch is per-ROI independent, so
masking only the K = DETECTION_MAX_INSTANCES boxes that survive score top-K
gives bit-identical surviving masks at ~245/K× less mask-branch compute.
NMS runs *after* the top-K gather but before mask pasting, so suppressed
boxes simply carry valid=False, exactly like the reference's index filter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .losses import mask_loss as mask_loss_fn
from .losses import yolo_loss as yolo_loss_fn
from .ops.boxes import decode_detections, decode_yolo_proposals, norm_boxes
from .ops.nms import (class_aware_nms, index_order_class_nms_mask,
                      per_class_topk_nms, reference_softmax)
from .ops.roi_align import paste_masks
from .ops.target_assign import assign_mask_targets


def images_f32(images):
    """Accept uint8 images and normalize on device. Shipping uint8 over the
    host→device link is 4× less transfer than pre-normalized float32.
    /255 on device is bit-identical to /255 on host for uint8 inputs.
    Float inputs pass through unchanged."""
    if images.dtype == jnp.uint8:
        return images.astype(jnp.float32) / 255.0
    return images


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnums=(0, 3),
                   static_argnames=("train", "mutable_stats"))
def training_loss(net, variables, batch, config, seen, train: bool = True,
                  mutable_stats: bool = False):
    """Full 'training'-mode forward + combined loss (reference mode='training'
    graph, model.py:872-901).

    batch dict:
      image:        [B, H, W, 3] uint8 (normalized on device) or float in [0, 1]
      yolo_target:  [B, gh, gw, nb, 5+C]
      true_boxes:   [B, 1, 1, 1, T, 4] grid units
      gt_class_ids: [B, G] int32, zero-padded
      gt_boxes:     [B, G, 4] float32 pixel xyxy, zero-padded
      gt_masks:     [B, H, W, G] bool

    Returns ((loss, (metrics, new_model_state))) suitable for value_and_grad
    with has_aux=True.
    """
    bn_train = train and config.TRAIN_BN
    # BN in batch-stats mode always writes the batch_stats collection, so it
    # must be mutable whenever bn_train is set; updates are simply discarded
    # unless the caller asked for them (mutable_stats)
    mutable = ["batch_stats"] if bn_train else False

    def apply(method, *args):
        out = net.apply(variables, *args, train=bn_train, method=method,
                        mutable=mutable)
        return out if mutable else (out, {})

    # FPN configs route through trunk_pyramid: fmap is then the (P3, P4, P5)
    # tuple and the mask head pools each ROI from its FPN-assigned level
    (grid, fmap), updates = apply(net.pick_trunk(), images_f32(batch["image"]))

    h, w = config.IMAGE_SHAPE[:2]
    # decode proposals in normalized coords (DecodeYOLOLayer, model.py:874)
    proposals = decode_yolo_proposals(grid, config.anchors_wh,
                                      config.GRID_H, config.GRID_W)
    proposals = jax.lax.stop_gradient(proposals)

    # GT boxes px → normalized (model.py:819-820)
    gt_boxes_norm = norm_boxes(batch["gt_boxes"], (w, h))

    rois, target_class_ids, target_masks = assign_mask_targets(
        proposals, batch["gt_class_ids"], gt_boxes_norm,
        batch["gt_masks"].astype(jnp.float32), tuple(config.MASK_SHAPE),
        bool(config.USE_MINI_MASK))

    # MASK_TRAIN_TOP_ROIS: run the (dominant) training mask branch only on
    # the top-M assignment slots, positives first. The mask loss is a
    # positive-only mean, so this is loss-identical whenever the image has
    # ≤ M positive proposals — negatives contribute exactly 0 — and it cuts
    # the train step's mask-branch FLOPs by R/M (the branch over all
    # TRAIN_ROIS_PER_IMAGE proposals is ~75% of step time at the Shapes
    # point; Mask R-CNN style implementations subsample ROIs the same way).
    # With live BatchNorm (TRAIN_BN) the mask-head batch statistics are
    # computed over the selected ROIs instead of all proposals — no longer
    # dominated by background crops, a (mild, beneficial) difference.
    # 0 (default) = reference-exact: mask branch over every proposal.
    m_top = int(getattr(config, "MASK_TRAIN_TOP_ROIS", 0) or 0)
    if m_top and m_top < rois.shape[1]:
        key = (target_class_ids > 0).astype(jnp.float32)
        _, order = jax.lax.top_k(key, m_top)  # positives first, stable
        rois = jnp.take_along_axis(rois, order[..., None], axis=1)
        target_class_ids = jnp.take_along_axis(target_class_ids, order, axis=1)
        target_masks = jnp.take_along_axis(
            target_masks, order[:, :, None, None], axis=1)

    (pred_masks,), updates2 = _apply_mask(net, variables, rois, fmap, bn_train,
                                          mutable)
    if updates2:
        # each apply returns the FULL batch_stats collection with only its
        # own branch updated (the other subtrees are the stale inputs), so
        # merge per-module: trunk modules from the trunk apply, 'mask' from
        # the mask apply. Overwriting wholesale kept trunk BN running stats
        # at their init values forever, which saturated the eval-mode
        # (use_running_average) forward into input-independent constants.
        merged = dict(updates["batch_stats"])
        merged["mask"] = updates2["batch_stats"]["mask"]
        updates = {"batch_stats": merged}

    y_loss, y_metrics = yolo_loss_fn(batch["yolo_target"], grid,
                                     batch["true_boxes"], config, seen)
    m_loss = mask_loss_fn(target_masks, target_class_ids, pred_masks)

    lw = config.LOSS_WEIGHTS
    total = (y_loss * lw.get("yolo_sum_loss", 1.0)
             + m_loss * lw.get("myolo_mask_loss", 1.0))

    metrics = dict(y_metrics)
    metrics["myolo_mask_loss"] = m_loss
    metrics["loss"] = total
    if not mutable_stats:
        updates = {}
    return total, (metrics, updates)


def _apply_mask(net, variables, rois, fmap, bn_train, mutable):
    out = net.apply(variables, rois, fmap, train=bn_train,
                    method=net.mask_branch, mutable=mutable)
    if mutable:
        masks, updates = out
        return (masks,), updates
    return (out,), {}


@functools.partial(jax.jit,
                   static_argnums=(0, 3),
                   static_argnames=("train", "mutable_stats"))
def yolo_only_loss(net, variables, batch, config, seen, train: bool = True,
                   mutable_stats: bool = False):
    """mode='yolo' forward: backbone + YOLO head + YOLO loss only
    (reference model.py:906-920)."""
    bn_train = train and config.TRAIN_BN
    mutable = ["batch_stats"] if bn_train else False
    out = net.apply(variables, images_f32(batch["image"]), train=bn_train,
                    method=net.trunk, mutable=mutable)
    if mutable:
        (grid, _fmap), updates = out
    else:
        (grid, _fmap), updates = out, {}
    loss, metrics = yolo_loss_fn(batch["yolo_target"], grid,
                                 batch["true_boxes"], config, seen)
    metrics = dict(metrics)
    metrics["loss"] = loss
    if not mutable_stats:
        updates = {}
    return loss, (metrics, updates)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 3))
def infer_yolo_outputs(net, variables, images, config):
    """Detection-only inference, fully on-chip: the device-side equivalent of
    MaskYOLO.infer_yolo + decode_one_yolo_output (model.py:1198-1236;
    myolo_utils.py:36-85).

    images: [B, H, W, 3] float in [0, 1].
    Returns dict with fixed-shape results per image:
      boxes  [B, N, 4] normalized xyxy
      scores [B, N]    winning class score after per-class NMS
      classes[B, N]    int32 winning class
      valid  [B, N]    bool (score > OBJ_THRESHOLD)
    """
    trunk = lambda imgs: net.apply(variables, imgs, train=False,
                                   method=net.trunk)
    return infer_yolo_from_callables(trunk, images, config)


def infer_yolo_from_callables(trunk, images, config):
    """infer_yolo_outputs with a pluggable trunk executor — shared by the
    f32/bf16 module path above and the int8 quantized path
    (quant.QuantizedDetector.infer_yolo_fn), mirroring
    detect_from_callables."""
    grid, _ = trunk(images_f32(images))
    grid = grid.astype(jnp.float32)
    boxes = decode_yolo_proposals(grid, config.anchors_wh,
                                  config.GRID_H, config.GRID_W)
    b = grid.shape[0]
    conf = jax.nn.sigmoid(grid[..., 4])

    # INFER_YOLO_TOP_N: run the per-class NMS only on the N boxes with the
    # highest max-class probability. Boxes below OBJ_THRESHOLD carry
    # all-zero probs (they can neither suppress nor survive), so this is
    # output-identical whenever ≤ N boxes pass the threshold — essentially
    # always at N=256 — while cutting the NMS from the 845-box blocked path
    # to one ≤512-box unrolled pass. 0 = off (full-grid NMS).
    n_top = int(getattr(config, "INFER_YOLO_TOP_N", 0) or 0)
    # INFER_YOLO_PER_CLASS_K: compact each class's boxes to its own top-K
    # BEFORE the greedy chain. The per-class suppression of class c only ever
    # involves boxes with prob_c > 0 (threshold already applied), so while
    # each class has ≤ K above-threshold boxes — a per-CLASS bound, far
    # tighter than TOP_N's shared pool — the kept set is identical. The
    # sequential chain shrinks N→K steps and the IoU slab (N/K)²×
    # (config.py INFER_YOLO_PER_CLASS_K).
    k_cls = int(getattr(config, "INFER_YOLO_PER_CLASS_K", 0) or 0)

    def per_image(g, bx, cf):
        # conf-weighted class probabilities, thresholded
        # (myolo_utils.py:42-44, incl. the reference's quirky softmax)
        probs = cf[..., None] * reference_softmax(g[..., 5:])
        probs = probs * (probs > config.OBJ_THRESHOLD)
        probs = probs.reshape(-1, config.NUM_CLASSES)
        if k_cls and k_cls < probs.shape[0]:
            probs = per_class_topk_nms(bx, probs, k_cls, config.NMS_THRESHOLD)
        elif n_top and n_top < probs.shape[0]:
            _, idx = jax.lax.top_k(jnp.max(probs, axis=-1), n_top)
            kept = class_aware_nms(bx[idx], probs[idx], config.NMS_THRESHOLD)
            probs = jnp.zeros_like(probs).at[idx].set(kept)
        else:
            probs = class_aware_nms(bx, probs, config.NMS_THRESHOLD)
        score = jnp.max(probs, axis=-1)
        label = jnp.argmax(probs, axis=-1).astype(jnp.int32)
        return score, label

    scores, classes = jax.vmap(per_image)(grid, boxes, conf)
    valid = scores > config.OBJ_THRESHOLD
    return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def detect_outputs(net, variables, images, config, score_threshold=None):
    """Full image → boxes + instance masks, one XLA program.

    The on-chip rebuild of MaskYOLO.detect + decode_masks + unmold_mask
    (model.py:1238-1391, myolo_utils.py:883-912), with the reference's
    hardcoded `nmb_indices = [109, 130]` debug override (model.py:1306)
    *fixed*: real NMS output is used (SURVEY.md §7 "reference bugs").

    Returns per image (K = DETECTION_MAX_INSTANCES):
      boxes   [B, K, 4] float32 pixel xyxy
      classes [B, K] int32
      scores  [B, K] float32
      masks   [B, K, H, W] bool full-size instance masks
      valid   [B, K] bool
    """
    trunk = lambda imgs: net.apply(variables, imgs, train=False,
                                   method=net.pick_trunk())

    def select_masks(rois, fmap, classes):
        masks = net.apply(variables, rois, fmap, train=False,
                          method=net.mask_branch)
        return select_class(masks, classes, config.NUM_CLASSES)

    return detect_from_callables(trunk, select_masks, images, config,
                                 score_threshold)


def select_class(masks, classes, num_classes: int):
    """[B, K, mh, mw, C] per-class masks → [B, K, mh, mw]: each ROI's mask
    for its own class (a one-hot contraction over C)."""
    onehot = jax.nn.one_hot(classes, num_classes, dtype=masks.dtype)
    return jnp.einsum("bkhwc,bkc->bkhw", masks, onehot)


def detect_from_callables(trunk, select_masks, images, config,
                          score_threshold=None):
    """detect_outputs with pluggable executors — shared by the f32/bf16
    module path above and the int8 quantized path (quant.py).

    trunk: images → (yolo grid, mask feature map or FPN pyramid).
    select_masks: (rois [B, K, 4], fmap, classes [B, K]) → [B, K, mh, mw],
    each ROI's sigmoid mask for its class."""
    if score_threshold is None:
        score_threshold = config.OBJ_THRESHOLD
    k = config.DETECTION_MAX_INSTANCES
    h, w = config.IMAGE_SHAPE[:2]

    grid, fmap = trunk(images_f32(images))
    det = decode_detections(grid, config.anchors_wh, config.GRID_H, config.GRID_W)
    boxes, scores, classes = det[..., :4], det[..., 4], det[..., 5].astype(jnp.int32)

    # zero-area filter (decode_masks, model.py:1373-1380) folded into validity
    area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0

    # top-K by score (model.py:1292), masked scores for suppressed/zero-area
    masked_scores = jnp.where(area_ok, scores, -1.0)
    top_scores, idx = jax.lax.top_k(masked_scores, k)
    top_boxes = jnp.take_along_axis(boxes, idx[..., None], axis=1)
    top_classes = jnp.take_along_axis(classes, idx, axis=1)
    valid = top_scores > score_threshold

    # class-aware NMS in score order (the reference's NMB pass; its 0.7
    # threshold — model.py:1304 — is the config default, tunable via
    # DETECTION_NMS_THRESHOLD: 0.3 suppresses the near-duplicate boxes the
    # reference's loose setting lets through)
    det_nms = float(getattr(config, "DETECTION_NMS_THRESHOLD", 0.7))
    keep = jax.vmap(lambda bx, cl, va: index_order_class_nms_mask(
        bx, cl, va, det_nms))(top_boxes, top_classes, valid)
    valid = valid & keep

    # MASK_TOP_K: run the mask branch (and paste) only on the kp highest-
    # scoring NMS SURVIVORS instead of all K slots. Slots are re-sorted
    # valid-first (score order preserved within each group) so survivors
    # occupy the leading slots; output is an identical set of detections as
    # long as ≤ kp boxes survive NMS — only the slot ordering changes. The
    # mask branch scales linearly in K, while real images rarely carry
    # anywhere near 100 instances. 0/None (default) = exact K-slot path.
    kp = int(getattr(config, "MASK_TOP_K", 0) or 0)
    kp = min(kp, k) if kp > 0 else k
    if kp < k:
        sort_key = jnp.where(valid, top_scores + 2.0, top_scores)
        _, order = jax.lax.top_k(sort_key, k)
        top_boxes = jnp.take_along_axis(top_boxes, order[..., None], axis=1)
        top_scores = jnp.take_along_axis(top_scores, order, axis=1)
        top_classes = jnp.take_along_axis(top_classes, order, axis=1)
        valid = jnp.take_along_axis(valid, order, axis=1)
    mask_boxes = top_boxes[:, :kp]
    mask_classes = top_classes[:, :kp]

    # mask branch on the kp (≤ K) survivors only (equivalence note in module
    # docstring: the reference masks all 245 decoded boxes, model.py:926-931)
    sel_masks = select_masks(mask_boxes, fmap, mask_classes)  # [B, kp, mh, mw]

    # paste into full-image canvas + threshold 0.5 (unmold_mask equivalent);
    # bf16 configs paste in bf16 (see ops/roi_align.paste_masks)
    paste_dtype = (jnp.bfloat16 if config.COMPUTE_DTYPE == "bfloat16"
                   else jnp.float32)
    full = jax.vmap(lambda m, bx: paste_masks(m, bx, (h, w),
                                              dtype=paste_dtype))(
        sel_masks, mask_boxes)
    full_bool = (full >= 0.5) & valid[:, :kp, None, None]
    if kp < k:  # slots beyond kp carry no mask (all-False canvas)
        full_bool = jnp.pad(full_bool,
                            ((0, 0), (0, k - kp), (0, 0), (0, 0)))

    boxes_px = top_boxes * jnp.asarray([w, h, w, h], dtype=jnp.float32)
    return {
        "boxes": boxes_px,
        "classes": top_classes,
        "scores": top_scores,
        "masks": full_bool,
        "valid": valid,
    }
