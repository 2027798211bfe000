"""ROIAlign as separable bilinear interpolation — two dense contractions.

Replacement for the reference's PyramidROIAlign, which wraps
`tf.image.crop_and_resize` (/root/reference/myolo/model.py:299-413). Instead of
per-box gather loops, the bilinear crop is expressed as two small matrix
multiplies per ROI:

    crop[r] = Wy[r] @ image @ Wx[r]^T        (per channel)

where Wy[r] is [pool_h, H] and Wx[r] is [pool_w, W] interpolation matrices
whose rows are the bilinear "tent" weights of each output sample point. Rows
whose sample coordinate falls outside [0, dim-1] are all-zero, reproducing
crop_and_resize's extrapolation_value=0. Batched over (batch, roi) with
einsum, the whole op is two dense contractions — no dynamic shapes, no
gathers, fully differentiable w.r.t. the feature map.

Numerical semantics match tf.image.crop_and_resize (bilinear):
  sample_y(i) = y1*(H-1) + i * (y2-y1)*(H-1)/(pool_h-1)   for pool_h > 1
  sample_y    = 0.5*(y1+y2)*(H-1)                          for pool_h == 1
(the reference feeds boxes as (y1, x1, y2, x2); our public API takes
(x1, y1, x2, y2) like the rest of this framework and swaps internally, exactly
as the reference does at model.py:558-559.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def interp_matrix(lo, hi, in_size: int, out_size: int, dtype=jnp.float32):
    """Bilinear interpolation matrices for a batch of 1-D spans.

    lo, hi: [...] normalized span start/end (TF convention: both inside).
    Returns W: [..., out_size, in_size] where W[..., i, :] holds the two
    bilinear weights of sample point i (all-zero if out of range).
    """
    # weights are always computed in f32 — sample coordinates are too
    # precision-sensitive for bf16 — and only the result is cast to `dtype`
    lo = lo.astype(jnp.float32)
    hi = hi.astype(jnp.float32)
    n = in_size - 1
    if out_size > 1:
        steps = jnp.arange(out_size, dtype=jnp.float32) / (out_size - 1)  # [P]
        coords = lo[..., None] * n + steps * ((hi - lo)[..., None] * n)
    else:
        coords = 0.5 * (lo + hi)[..., None] * n

    grid = jnp.arange(in_size, dtype=jnp.float32)  # [in_size]
    # tent kernel: weight of input index h for sample coordinate c
    w = jnp.maximum(0.0, 1.0 - jnp.abs(coords[..., None] - grid))
    # out-of-range samples contribute 0 (TF extrapolation_value)
    in_range = (coords >= 0.0) & (coords <= n)
    return (w * in_range[..., None].astype(jnp.float32)).astype(dtype)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def crop_and_resize(feature, boxes, crop_size, dtype=None, precision=None):
    """Batched bilinear crop: feature [B, H, W, C], boxes [B, R, 4]
    (x1, y1, x2, y2) normalized → [B, R, ph, pw, C].

    Equivalent to tf.image.crop_and_resize applied per (batch, roi) with the
    pyramid collapsed to a single level, which is exactly what the reference
    does (PyramidROIAlign clamps roi_level to 0, model.py:353-354).

    precision: None → HIGHEST (f32 accumulation; bit-parity with the
    reference crop). The int8 detect pipeline may pass DEFAULT
    (QUANT_FAST_CROP): with bf16 crops, HIGHEST forces multi-pass f32
    arithmetic AND f32 intermediates, and the crop's output feeds
    quantized convs anyway.
    """
    ph, pw = crop_size
    b, h, w, c = feature.shape
    if dtype is None:
        dtype = feature.dtype
    boxes = jax.lax.stop_gradient(boxes)  # reference: model.py:373-374
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    wy = interp_matrix(y1, y2, h, ph, dtype)  # [B, R, ph, H]
    wx = interp_matrix(x1, x2, w, pw, dtype)  # [B, R, pw, W]
    feat = feature.astype(dtype)
    # two contractions; XLA fuses the transpose/reshapes. These
    # contractions are tiny (K = H or W), so f32 accumulation costs no
    # FLOPs-bound time — only the intermediates' dtype matters (see above).
    prec = jax.lax.Precision.HIGHEST if precision is None else precision
    tmp = jnp.einsum("brph,bhwc->brpwc", wy, feat, precision=prec)
    out = jnp.einsum("brpwc,brqw->brpqc", tmp, wx, precision=prec)
    return out


@functools.partial(jax.jit, static_argnums=(2, 3))
def crop_and_resize_per_roi(images, boxes, crop_size, dtype=jnp.float32):
    """Per-ROI single-channel crop: images [R, H, W], boxes [R, 4]
    (x1, y1, x2, y2) normalized → [R, ph, pw].

    Used for GT-mask target generation (the reference's
    tf.image.crop_and_resize over per-ROI masks, model.py:580-589).
    """
    ph, pw = crop_size
    r, h, w = images.shape
    boxes = jax.lax.stop_gradient(boxes)
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    wy = interp_matrix(y1, y2, h, ph, dtype)  # [R, ph, H]
    wx = interp_matrix(x1, x2, w, pw, dtype)  # [R, pw, W]
    imgs = images.astype(dtype)
    prec = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("rph,rhw->rpw", wy, imgs, precision=prec)
    return jnp.einsum("rpw,rqw->rpq", tmp, wx, precision=prec)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def multilevel_crop_and_resize(features, boxes, crop_size,
                               image_hw=(224, 224), canonical_scale=224.0,
                               canonical_level=1):
    """True multi-level (FPN) ROIAlign — the generalization the reference
    carries but clamps to one level (PyramidROIAlign, model.py:350-354
    constrains roi_level to 0; SURVEY.md §7 step 7 restores it).

    features: tuple of pyramid maps ordered fine→coarse (P2..P5-style),
    each [B, Hi, Wi, C]. boxes: [B, R, 4] normalized (x1, y1, x2, y2).
    image_hw: static pixel size of the input image (normalized box sides ×
    this give pixel extents). Level assignment is FPN eq. 1: an ROI of
    `canonical_scale` pixels maps to features[canonical_level], and each
    ×2 in scale moves one level coarser (reference model.py:350-354, which
    writes it in normalized coordinates). `canonical_level` is the INDEX of
    the k0 level in the fine→coarse `features` tuple: for a (P3, P4, P5)
    pyramid FPN's k0=4 is P4 = index 1 (the default); callers with a
    different pyramid must pass the k0 index explicitly.

    Static-shape implementation: crop from EVERY level (the [B, R, ph, pw, C]
    crops are tiny) and one-hot combine — no data-dependent gathers, fully
    differentiable w.r.t. every feature map. Returns [B, R, ph, pw, C].
    """
    n_levels = len(features)
    h_px, w_px = image_hw
    bw = jnp.maximum(boxes[..., 2] - boxes[..., 0], 1e-8) * w_px
    bh = jnp.maximum(boxes[..., 3] - boxes[..., 1], 1e-8) * h_px
    level = canonical_level + jnp.round(
        jnp.log2(jnp.sqrt(bw * bh) / canonical_scale))
    level = jnp.clip(level, 0, n_levels - 1).astype(jnp.int32)  # [B, R]

    crops = jnp.stack(
        [crop_and_resize(f, boxes, crop_size) for f in features], axis=0)
    onehot = jax.nn.one_hot(level, n_levels, dtype=crops.dtype)  # [B, R, L]
    return jnp.einsum("lbrpqc,brl->brpqc", crops, onehot)


@functools.partial(jax.jit, static_argnums=(2, 3))
def paste_masks(masks, boxes, image_size, dtype=jnp.float32):
    """Inverse of crop_and_resize: paste per-ROI masks back to image canvas.

    masks: [R, mh, mw] float mask logits/probabilities.
    boxes: [R, 4] (x1, y1, x2, y2) normalized.
    Returns [R, H, W] float — each mask bilinearly resized into its box,
    zero elsewhere. Device-side replacement for the reference's host-side
    unmold_mask loop (myolo_utils.py:883-912).

    Construction: for image pixel y the source mask coordinate is
    (y/(H-1) - y1) / (y2 - y1) * (mh - 1); weights form a [R, H, mh] matrix
    (rows outside the box are zero), so pasting is again two contractions.

    dtype: contraction dtype. The weight COORDINATES are always computed in
    f32 (precision-sensitive); only the contractions run in `dtype`.
    float32 contracts at Precision.HIGHEST for bit-parity with the host
    oracle; bfloat16 runs at default precision, and the only observable
    difference is sub-ULP wobble of borderline 0.5-threshold pixels on mask
    edges.
    """
    r, mh, mw = masks.shape
    h, w = image_size
    boxes = jax.lax.stop_gradient(boxes).astype(jnp.float32)
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))

    def paste_matrix(lo, hi, out_size, m_size):
        # coordinate of each output pixel inside the mask (f32 always)
        pix = jnp.arange(out_size, dtype=jnp.float32) / max(out_size - 1, 1)
        span = jnp.maximum(hi - lo, 1e-8)[..., None]
        coords = (pix - lo[..., None]) / span * (m_size - 1)  # [R, H]
        grid = jnp.arange(m_size, dtype=jnp.float32)
        # pixels slightly past the box edge still belong to the box outline;
        # clamp their sample coordinate to the border value
        inside = (coords >= -0.5) & (coords <= (m_size - 1) + 0.5)
        coords = jnp.clip(coords, 0.0, m_size - 1)
        wgt = jnp.maximum(0.0, 1.0 - jnp.abs(coords[..., None] - grid))  # [R, H, m]
        return (wgt * inside[..., None]).astype(dtype)

    py = paste_matrix(y1, y2, h, mh)  # [R, H, mh]
    px = paste_matrix(x1, x2, w, mw)  # [R, W, mw]
    m = masks.astype(dtype)
    prec = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    tmp = jnp.einsum("rhm,rmn->rhn", py, m, precision=prec)
    return jnp.einsum("rhn,rwn->rhw", tmp, px, precision=prec)
