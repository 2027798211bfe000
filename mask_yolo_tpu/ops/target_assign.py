"""Mask-branch training-target assignment, fixed shape.

Replacement for DetectMaskTargetLayer / detect_mask_target_graph
(/root/reference/myolo/model.py:420-661). The reference builds ragged arrays
with tf.where / boolean_mask / dynamic tf.pad and loops per batch element via
batch_slice; XLA needs static shapes, so here every quantity is computed for
all TRAIN_ROIS_PER_IMAGE proposals with validity masks:

 * positives = proposals with max-IoU >= 0.5 against any valid GT box
   (reference model.py:513-516);
 * each positive inherits the class id and mask of its best-overlap GT
   (model.py:539-555);
 * the GT mask is cropped to the proposal box and resized to MASK_SHAPE with
   bilinear sampling, then rounded to {0,1} (model.py:580-589);
 * negatives get class 0 and a zero mask.

Deviation from the reference (documented, provably equivalent): the reference
reorders outputs positives-first then zero-pads to TRAIN_ROIS_PER_IMAGE
(model.py:591-600). Since every decoded proposal is either positive or
negative, the concatenation is a permutation of the original 245 proposals —
and the downstream mask head applies per-ROI independently while the mask
loss only gathers ROIs with class > 0, so the permutation has no effect on
any loss value. We keep the original proposal order and skip the sort.

The per-ROI GT-mask gather is expressed as a one-hot matmul instead of
a gather, and the crop is the separable-matmul crop from ops/roi_align.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .boxes import box_iou_matrix
from .roi_align import crop_and_resize_per_roi


@functools.partial(jax.jit, static_argnums=(4, 5))
def assign_mask_targets_single(proposals, gt_class_ids, gt_boxes, gt_masks,
                               mask_shape, mini: bool = False):
    """Single-image assignment.

    proposals: [R, 4] normalized (x1, y1, x2, y2) decoded YOLO boxes.
    gt_class_ids: [G] int32, zero-padded.
    gt_boxes: [G, 4] normalized, zero-padded.
    gt_masks: [H, W, G] bool/float — full-size, or MINI_MASK_SHAPE-size
      box-relative mini-masks when `mini` is set.
    Returns (rois [R,4], target_class_ids [R] int32, target_masks [R,mh,mw]).

    `mini=True` implements the USE_MINI_MASK crop the reference left as a
    commented-out TODO (model.py:562-578): the ROI is transformed from
    normalized image space into the matched GT box's frame before cropping,
    since mini-masks cover only the GT box extent.
    """
    r = proposals.shape[0]
    g = gt_boxes.shape[0]
    mh, mw = mask_shape

    valid_gt = jnp.sum(jnp.abs(gt_boxes), axis=1) > 0  # trim_zeros_graph equiv.

    overlaps = box_iou_matrix(proposals, gt_boxes)  # [R, G]
    overlaps = jnp.where(valid_gt[None, :], overlaps, -1.0)

    roi_iou_max = jnp.max(overlaps, axis=1)
    positive = roi_iou_max >= 0.5
    best_gt = jnp.argmax(overlaps, axis=1)  # [R]

    target_class = jnp.where(positive, gt_class_ids[best_gt], 0).astype(jnp.int32)

    # one-hot gather of each ROI's GT mask: [R, G] @ [G, H*W] as a matmul
    onehot = jax.nn.one_hot(best_gt, g, dtype=jnp.float32) * positive[:, None]
    h, w = gt_masks.shape[0], gt_masks.shape[1]
    masks_flat = gt_masks.astype(jnp.float32).reshape(h * w, g).T  # [G, H*W]
    roi_masks = (onehot @ masks_flat).reshape(r, h, w)

    # crop GT mask to the proposal box, resize to the network mask size,
    # binarize (reference rounds at model.py:589)
    crop_boxes = proposals
    if mini:
        # ROI coords → matched-GT-box frame (mini-masks span the GT box)
        roi_gt_box = onehot @ gt_boxes  # [R, 4]
        gw = jnp.maximum(roi_gt_box[:, 2] - roi_gt_box[:, 0], 1e-8)
        gh = jnp.maximum(roi_gt_box[:, 3] - roi_gt_box[:, 1], 1e-8)
        crop_boxes = jnp.stack([
            (proposals[:, 0] - roi_gt_box[:, 0]) / gw,
            (proposals[:, 1] - roi_gt_box[:, 1]) / gh,
            (proposals[:, 2] - roi_gt_box[:, 0]) / gw,
            (proposals[:, 3] - roi_gt_box[:, 1]) / gh,
        ], axis=1)
    cropped = crop_and_resize_per_roi(roi_masks, crop_boxes, (mh, mw))
    target_masks = jnp.round(cropped) * positive[:, None, None].astype(cropped.dtype)

    return proposals, target_class, target_masks


@functools.partial(jax.jit, static_argnums=(4, 5))
def assign_mask_targets(proposals, gt_class_ids, gt_boxes, gt_masks, mask_shape,
                        mini: bool = False):
    """Batched assignment (vmap over the batch axis — the replacement for
    the reference's batch_slice Python loop, model.py:644).

    proposals: [B, R, 4]; gt_class_ids: [B, G]; gt_boxes: [B, G, 4]
    normalized; gt_masks: [B, H, W, G] (or [B, mh, mw, G] mini-masks).
    """
    return jax.vmap(
        lambda p, c, b, m: assign_mask_targets_single(p, c, b, m, mask_shape,
                                                      mini)
    )(proposals, gt_class_ids, gt_boxes, gt_masks)
