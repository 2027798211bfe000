"""On-device non-max suppression, fixed shape, jittable.

The reference performs all suppression on the host in pure Python:
`decode_one_yolo_output` (/root/reference/myolo/myolo_utils.py:36-85) runs a
per-class greedy NMS over BoundBox objects, and `NMB`
(myolo_utils.py:88-113) runs a second class-aware pass in `detect()`
(model.py:1304). Both are O(N²) loops over at most 245 boxes — trivially
small — so the on-device version computes the full IoU matrix once and runs
a fixed-trip `lax.fori_loop` over the score-sorted order. Everything stays
on-chip and static-shape; "dropped" boxes are expressed by zeroed scores, not
by shrinking arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .boxes import box_iou_matrix


@functools.partial(jax.jit, static_argnums=(2,))
def greedy_nms_mask(boxes, scores, iou_threshold: float):
    """Greedy score-ordered NMS. Returns a bool keep-mask aligned to input.

    boxes: [N, 4] (x1, y1, x2, y2); scores: [N] (0 = inactive, never kept
    as a suppressor). Matches the reference's per-class loop semantics
    (myolo_utils.py:67-80): iterate in descending score order; a surviving
    box suppresses every later box with IoU >= threshold.
    """
    n = boxes.shape[0]
    order = jnp.argsort(-scores)
    boxes_s = boxes[order]
    scores_s = scores[order]
    active0 = scores_s > 0.0

    if n <= 512:
        # unrolled so the whole suppression chain fuses into one XLA program
        # instead of n sequential fori_loop trips that each pay kernel-launch
        # latency (the dependency chain is inherent — greedy NMS is
        # order-sequential — but the per-step work is a tiny vector op)
        iou = box_iou_matrix(boxes_s, boxes_s)
        later = jnp.arange(n)[None, :] > jnp.arange(n)[:, None]
        sup = later & (iou >= iou_threshold)
        keep_s = jnp.ones(n, dtype=bool)
        for i in range(n):
            suppress = keep_s[i] & active0[i] & sup[i]
            keep_s = keep_s & ~suppress
    else:
        # Blocked suppression for large N (e.g. 13·13·5 = 845 at 416²): tiles
        # of TILE score-sorted boxes; each fori_loop trip handles one tile
        # with a dense intra-tile unroll, carrying the keep mask across
        # tiles. Sequential depth drops from N launches to N/TILE (7 at 845)
        # while compile cost stays at one TILE-step unroll, and the per-tile
        # [TILE, N] IoU slab replaces the full [N, N] matrix (which vmapped
        # over 81 classes would be 81·N² floats).
        TILE = 128
        n_tiles = -(-n // TILE)
        n_pad = n_tiles * TILE
        boxes_p = jnp.pad(boxes_s, ((0, n_pad - n), (0, 0)))
        active_p = jnp.pad(active0, (0, n_pad - n))
        idx = jnp.arange(n_pad)

        def tile_body(t, keep):
            start = t * TILE
            rows = jax.lax.dynamic_slice(boxes_p, (start, 0), (TILE, 4))
            iou_t = box_iou_matrix(rows, boxes_p)  # [TILE, n_pad]
            for i in range(TILE):
                g = start + i
                suppress = (keep[g] & active_p[g] & (idx > g)
                            & (iou_t[i] >= iou_threshold))
                keep = keep & ~suppress
            return keep

        keep_s = jax.lax.fori_loop(0, n_tiles, tile_body,
                                   jnp.ones(n_pad, dtype=bool))[:n]
    # unsort
    keep = jnp.zeros(n, dtype=bool).at[order].set(keep_s)
    return keep


@functools.partial(jax.jit, static_argnums=(2,))
def class_aware_nms(boxes, class_scores, iou_threshold: float):
    """Per-class greedy NMS: zero the class score of suppressed boxes.

    boxes: [N, 4]; class_scores: [N, C]. Returns class_scores with
    suppressed entries zeroed — the exact effect of the reference's
    `boxes[index_j].classes[c] = 0` (myolo_utils.py:80). vmapped over C.
    """
    keep = jax.vmap(lambda s: greedy_nms_mask(boxes, s, iou_threshold),
                    in_axes=1, out_axes=1)(class_scores)
    return class_scores * keep.astype(class_scores.dtype)


@functools.partial(jax.jit, static_argnums=(2, 3))
def per_class_topk_nms(boxes, class_scores, k: int, iou_threshold: float):
    """class_aware_nms with per-class candidate compaction: each class's
    suppression runs over only its own top-k boxes by that class's score.

    Exactly equal to class_aware_nms while every class has ≤ k boxes with
    score > 0 — class c's greedy chain only ever involves boxes with a
    positive class-c score (zeros neither suppress nor survive,
    myolo_utils.py:67-80), and top-k then captures all of them. The
    sequential chain shrinks N→k steps and the per-class IoU slab (N/k)²×:
    the 416² infer_yolo cost driver (845 grid boxes, 81 classes) drops from
    a shared 256-box pool to k≈32-64 slots per class.

    boxes: [N, 4]; class_scores: [N, C]. Returns class_scores with
    suppressed entries zeroed (same contract as class_aware_nms).
    """
    n, c = class_scores.shape
    if k >= n:
        return class_aware_nms(boxes, class_scores, iou_threshold)
    top_s, top_i = jax.lax.top_k(class_scores.T, k)          # [C, k] desc
    keep = jax.vmap(lambda b_, s_: greedy_nms_mask(b_, s_, iou_threshold))(
        boxes[top_i], top_s)                                  # [C, k]
    kept = top_s * keep.astype(top_s.dtype)
    return jnp.zeros_like(class_scores).at[
        top_i, jnp.arange(c)[:, None]].set(kept)


@functools.partial(jax.jit, static_argnums=(1, 2))
def reference_softmax(x, axis=-1, t=-100.0):
    """The reference's _softmax (myolo_utils.py:25-33): global max-shift and
    a rescale when the minimum is extremely negative. Reproduced exactly for
    output parity."""
    x = x - jnp.max(x)
    xmin = jnp.min(x)
    x = jnp.where(xmin < t, x / xmin * t, x)
    e = jnp.exp(x)
    return e / jnp.sum(e, axis=axis, keepdims=True)


@functools.partial(jax.jit, static_argnums=(3,))
def index_order_class_nms_mask(boxes, class_ids, valid, iou_threshold: float):
    """The reference's second-stage `NMB` (myolo_utils.py:88-113): iterate in
    *index* order (not score order); box i suppresses every later box j with
    the same class id and IoU >= threshold. Returns a keep mask.

    NMB quirk preserved: the reference never checks whether box i was itself
    removed, so an already-suppressed box STILL suppresses later boxes
    (chain suppression — myolo_utils.py:100-109 has no membership test on
    index_i). This makes every i's suppression row independent of the keep
    state, so the whole pass is one dense matrix reduction — no sequential
    loop at all.

    boxes: [N, 4] normalized; class_ids: [N] int; valid: [N] bool (invalid
    slots — below-threshold padding the reference's NMB never saw — neither
    suppress nor survive).
    """
    n = boxes.shape[0]
    iou = box_iou_matrix(boxes, boxes)
    later = jnp.arange(n)[None, :] > jnp.arange(n)[:, None]
    same_class = class_ids[:, None] == class_ids[None, :]
    suppressed_by = (valid[:, None] & later & same_class
                     & (iou >= iou_threshold))  # [i, j]: i removes j
    return valid & ~jnp.any(suppressed_by, axis=0)


@functools.partial(jax.jit, static_argnums=(3, 4))
def top_k_detections(boxes, scores, class_ids, k: int, score_threshold: float):
    """Select top-k detections by score with a validity mask.

    Returns (boxes [k,4], scores [k], class_ids [k], valid [k]) — the
    fixed-shape equivalent of the reference's host-side top-10 + threshold
    filter (model.py:1292-1297).
    """
    k = min(k, scores.shape[0])
    top_scores, idx = jax.lax.top_k(scores, k)
    valid = top_scores > score_threshold
    return boxes[idx], top_scores, class_ids[idx], valid
