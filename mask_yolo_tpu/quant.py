"""Post-training int8 quantized inference path.

New capability vs the reference (which is float32 Keras end to end): the
convolution stack — backbone, neck, YOLO head and mask head — runs with int8
operands and int32 accumulation. XLA:GPU refuses every integer
`conv_general_dilated`, so the int8 convs are written as int8 GEMMs and
shifted multiply-adds (ops/int8_conv.py), exact to the last bit.

Scheme (standard PTQ):
  * BatchNorm is folded into the preceding conv's kernel + bias
    (inference-time affine).
  * Weights: symmetric per-output-channel int8, scale = absmax/127.
  * Activations: symmetric per-tensor int8 with *static* scales collected by
    a one-pass calibration over sample images (absmax, f32 forward).
  * Accumulation in int32 (`preferred_element_type`), dequantized to f32,
    bias + activation applied, then re-quantized at the next conv.
  * The pointwise/3×3 convs carrying ~90% of the FLOPs run int8. The mask
    deconv is reformulated as an exactly equivalent 1×1 conv to 4x channels
    + depth-to-space, a dense int8 GEMM instead of a dilated conv that
    wastes 4× the FLOPs. The final sigmoid mask conv stays bf16; depthwise
    convs and the stem follow Config.QUANT_DW_INT8 / QUANT_STEM_BF16.

The layer graph below mirrors models/{mobilenet,yolo_head,network,mask_head}
exactly (same names, same strides); `test_quant.py` asserts the folded f32
graph reproduces the module forward bit-closely so the two cannot drift.

Reference anchor: the conv stack being quantized is the reference's
mobilenet_graph + yolo_branch_graph + feature_map + build_mask_graph
(/root/reference/myolo/model.py:55-79, 249-292, 848, 668-715).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .models.layers import relu6
from .ops.int8_conv import conv_int8
from .ops.roi_align import crop_and_resize


# ---------------------------------------------------------------------------
# BN folding + layer-graph extraction
# ---------------------------------------------------------------------------


def fold_conv_bn(kernel, bn_params, bn_stats, conv_bias=None, eps: float = 1e-3):
    """Fold an inference-mode BatchNorm into the preceding conv.

    y = gamma * (conv(x) + b - mean) / sqrt(var + eps) + beta
      = conv(x) * f + (b - mean) * f + beta,   f = gamma / sqrt(var + eps)
    """
    gamma = np.asarray(bn_params["scale"], np.float32)
    beta = np.asarray(bn_params["bias"], np.float32)
    mean = np.asarray(bn_stats["mean"], np.float32)
    var = np.asarray(bn_stats["var"], np.float32)
    f = gamma / np.sqrt(var + eps)
    k = np.asarray(kernel, np.float32) * f  # broadcast over trailing O axis
    b = np.zeros_like(mean) if conv_bias is None else np.asarray(conv_bias, np.float32)
    return k, (b - mean) * f + beta


@dataclass
class Layer:
    """One conv layer of the folded inference graph."""

    name: str
    kind: str          # 'conv' | 'dw' | 'deconv'
    kernel: Any        # f32 [kh, kw, I(/g), O]
    bias: Any          # f32 [O]
    strides: tuple = (1, 1)
    act: str = "relu6"  # 'relu6' | 'relu' | 'linear' | 'sigmoid'
    groups: int = 1
    quantize: bool = True
    # filled by quantize_graph():
    w_q: Any = None       # int8 kernel
    w_scale: Any = None   # f32 [O]
    # input activation scale: f32 scalar, or f32 [C_in] vector when
    # QUANT_PER_CHANNEL_ACT calibrated per-channel scales
    a_scale: Any = 0.0
    # vector a_scale is folded into w_q (per input channel), so the int8
    # dequant factor is w_scale alone
    act_folded: bool = False
    # per-output-channel bias correction applied on the int8 path only
    # (QUANT_BIAS_CORRECT; f32/bf16 parity paths keep the exact module bias)
    bias_corr: Any = None


def _scale_ok(s) -> bool:
    """Usable activation scale? (positive scalar, or all-positive vector)"""
    if isinstance(s, np.ndarray):
        return bool(s.size) and bool(np.all(s > 0))
    return bool(s and s > 0.0)


def _ds_block(params, stats, name, strides, dw_int8: bool = False):
    """DepthwiseSeparable block → [dw layer, pw layer (int8)].

    dw_int8: quantize the depthwise conv too. Config.QUANT_DW_INT8 selects
    (auto: on for inputs ≥ 320²)."""
    p, s = params[name], stats[name]
    dwk, dwb = fold_conv_bn(p["conv_dw"]["kernel"], p["conv_dw_bn"], s["conv_dw_bn"])
    pwk, pwb = fold_conv_bn(p["conv_pw"]["kernel"], p["conv_pw_bn"], s["conv_pw_bn"])
    # depthwise kernel is [kh, kw, 1, C] → feature_group_count = C
    groups = int(dwk.shape[-1])
    return [
        Layer(f"{name}/dw", "dw", dwk, dwb, strides, "relu6",
              groups=groups, quantize=dw_int8),
        Layer(f"{name}/pw", "conv", pwk, pwb, (1, 1), "relu6"),
    ]


def build_layer_graph(variables, config):
    """Extract the folded inference layer graph from the module variables.

    Returns dict with 'trunk' (stem+backbone), 'neck', 'yolo', 'mask' layer
    lists. Fully-quantized trunks are mobilenet-only; for other backbones
    (resnet50_fpn) 'trunk'/'neck'/'yolo' are None and only the mask head —
    the K-linear dominant branch — is extracted (hybrid mode: the caller
    runs the trunk through the bf16 module and the mask head int8).
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    mask_f32 = getattr(config, "QUANT_MASK_F32_LAYERS", ()) or ()
    if config.BACKBONE != "mobilenet":
        return {"trunk": None, "neck": None, "yolo": None,
                "mask": _mask_layers(params["mask"], stats["mask"],
                                     f32_layers=mask_f32)}

    dw_int8 = getattr(config, "QUANT_DW_INT8", None)
    if dw_int8 is None:  # auto: int8 depthwise from 320² up
        dw_int8 = int(config.IMAGE_SHAPE[0]) >= 320
    dw_int8 = bool(dw_int8)

    stem_bf16 = getattr(config, "QUANT_STEM_BF16", None)
    if stem_bf16 is None:  # auto: bf16 stem from 320² up
        stem_bf16 = int(config.IMAGE_SHAPE[0]) >= 320
    stem_bf16 = bool(stem_bf16)

    bb_p, bb_s = params["backbone"], stats["backbone"]
    trunk = []
    k, b = fold_conv_bn(bb_p["conv1"]["conv"]["kernel"], bb_p["conv1"]["bn"],
                        bb_s["conv1"]["bn"])
    trunk.append(Layer("conv1", "conv", k, b, (2, 2), "relu6",
                       quantize=not stem_bf16))
    bb_strides = {"block2": (2, 2), "block4": (2, 2)}
    for i in range(1, 7):
        name = f"block{i}"
        trunk += _ds_block(bb_p, bb_s, name, bb_strides.get(name, (1, 1)),
                           dw_int8=dw_int8)

    neck = [Layer("feature_map", "conv",
                  np.asarray(params["feature_map"]["kernel"], np.float32),
                  np.asarray(params["feature_map"]["bias"], np.float32),
                  (1, 1), "linear")]

    y_p, y_s = params["yolo"], stats["yolo"]
    yolo = []
    y_strides = {"block7": (2, 2), "block13": (2, 2)}
    for i in range(7, 15):
        name = f"block{i}"
        yolo += _ds_block(y_p, y_s, name, y_strides.get(name, (1, 1)),
                          dw_int8=dw_int8)
    yolo.append(Layer("conv_23", "conv",
                      np.asarray(y_p["conv_23"]["kernel"], np.float32),
                      np.asarray(y_p["conv_23"]["bias"], np.float32),
                      (1, 1), "linear"))

    return {"trunk": trunk, "neck": neck, "yolo": yolo,
            "mask": _mask_layers(params["mask"], stats["mask"],
                                 f32_layers=mask_f32)}


def _mask_layers(m_p, m_s, f32_layers=()):
    """Folded mask-head layer chain (shared by every backbone).

    f32_layers: mask-head layer names (e.g. 'mask_conv4', 'mask_deconv') to
    run bf16 instead of int8 — the Config.QUANT_MASK_F32_LAYERS ablation
    knob for localizing the residual int8 mask-AP cost."""
    f32_layers = set(f32_layers or ())
    mask = []
    for i in range(1, 5):
        k, b = fold_conv_bn(m_p[f"mask_conv{i}"]["kernel"],
                            m_p[f"mask_bn{i}"], m_s[f"mask_bn{i}"],
                            conv_bias=m_p[f"mask_conv{i}"].get("bias"))
        mask.append(Layer(f"mask_conv{i}", "conv", k, b, (1, 1), "relu",
                          quantize=f"mask_conv{i}" not in f32_layers))
    # 2×2/s2 ConvTranspose == 1×1 conv to (2·2·O) channels + depth-to-space:
    # y[2i+di, 2j+dj, o] = Σ_c x[i,j,c] · W[di,dj,c,o]. The deconv therefore
    # runs as a dense int8 1×1 conv with zero padding waste
    # (conv_transpose lowers as a dilated conv that wastes 4× the FLOPs).
    # The depth-to-space itself is NOT applied here: the following 1×1
    # class conv is expanded block-diagonally to consume the (di,dj,o)
    # layout directly, and depth-to-space runs after it on the small
    # per-class tensor (256/num_classes× smaller) instead of on the
    # [N,14,14,4·256] one.
    dk = np.asarray(m_p["mask_deconv"]["kernel"], np.float32)  # [2, 2, C, O]
    kh, kw, ci, co = dk.shape
    dk_1x1 = dk.transpose(2, 0, 1, 3).reshape(1, 1, ci, kh * kw * co)
    mask.append(Layer("mask_deconv", "conv", dk_1x1,
                      np.tile(np.asarray(m_p["mask_deconv"]["bias"],
                                         np.float32), kh * kw),
                      (1, 1), "relu",
                      quantize="mask_deconv" not in f32_layers))
    ok = np.asarray(m_p["mask_out"]["kernel"], np.float32)  # [1, 1, O, C]
    nc = ok.shape[-1]
    ok_block = np.zeros((1, 1, kh * kw * co, kh * kw * nc), np.float32)
    for blk in range(kh * kw):
        ok_block[0, 0, blk * co:(blk + 1) * co, blk * nc:(blk + 1) * nc] = ok[0, 0]
    mask.append(Layer("mask_out", "out_d2s", ok_block,
                      np.tile(np.asarray(m_p["mask_out"]["bias"], np.float32),
                              kh * kw),
                      (1, 1), "sigmoid", quantize=False))
    return mask


# ---------------------------------------------------------------------------
# Forward execution (f32 reference / int8 quantized)
# ---------------------------------------------------------------------------

_ACTS = {
    "relu6": relu6,
    "relu": jax.nn.relu,
    "linear": lambda x: x,
    "sigmoid": jax.nn.sigmoid,
}


def _conv(x, kernel, strides, groups=1):
    return jax.lax.conv_general_dilated(
        x, kernel, strides, "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
        preferred_element_type=jnp.float32)


def _deconv(x, kernel, strides):
    # nn.ConvTranspose semantics: conv_transpose with HWIO kernel
    return jax.lax.conv_transpose(
        x, kernel, strides, "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)


def _depth_to_space2(y):
    """[B, H, W, 4·O] → [B, 2H, 2W, O] (block layout [dh, dw, o])."""
    b, h, w, c4 = y.shape
    o = c4 // 4
    y = y.reshape(b, h, w, 2, 2, o)
    y = y.transpose(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, o)


def run_layer_f32(layer: Layer, x, collect=None, calib_pct: float = 100.0):
    """Reference f32 execution of one folded layer (also calibration probe:
    appends (name, range(x)) to `collect` — every layer's input range is
    needed because chained int8 execution re-quantizes each layer's output
    to its successor's input scale).

    calib_pct: activation-range statistic. 100 = absmax (the default);
    < 100 = that percentile of |x|, clipping rare outliers. Measured at the
    81-class point: clipping HURTS (99.9% halves AP — the extreme
    activations are signal, not noise; docs/QUALITY.md), so absmax
    stays the default; the knob is kept for datasets where it wins."""
    if collect is not None:
        ax = jnp.abs(x)
        # absmax collects the per-channel vector; calibrate() reduces it to
        # a scalar unless QUANT_PER_CHANNEL_ACT keeps it. Percentile mode
        # stays a whole-tensor scalar statistic.
        stat = (jnp.max(ax, axis=tuple(range(ax.ndim - 1)))
                if calib_pct >= 100.0
                else jnp.quantile(ax.astype(jnp.float32).ravel(),
                                  calib_pct / 100.0))
        collect.append((layer.name, stat))
    k = jnp.asarray(layer.kernel)
    if layer.kind == "deconv":
        y = _deconv(x, k, layer.strides)
    else:
        y = _conv(x, k, layer.strides, layer.groups)
    y = y + jnp.asarray(layer.bias)
    y = _ACTS[layer.act](y)
    if layer.kind == "out_d2s":
        y = _depth_to_space2(y)
    return y


def _quantize_act(x, scale):
    # scale: scalar, or per-channel vector broadcast over the last axis
    inv = jnp.asarray(np.float32(1.0) / np.asarray(scale, np.float32))
    return jnp.clip(jnp.round(x * inv), -127, 127).astype(jnp.int8)


def run_layer_int8(layer: Layer, x, x_scale=None, out_scale=None):
    """Quantized execution of one layer.

    x: int8 tensor with scale `x_scale`, or f32 tensor (x_scale=None).
    out_scale: if set, the output is re-quantized to int8 at this scale
    (the next layer's calibrated input scale) so inter-layer tensors stay
    int8 in device memory — 4× less activation traffic than f32
    intermediates, with the epilogue math (dequant→bias→act→requant) left
    to XLA to fuse into the GEMM.
    Returns (y, y_scale): int8+scale if out_scale, else f32+None.
    """
    if layer.quantize and layer.w_q is not None and _scale_ok(layer.a_scale):
        if x_scale is None:
            x_q = _quantize_act(x, layer.a_scale)
        else:
            x_q = x
        # vector a_scale is already folded into w_q (act_folded) — chained
        # int8 inputs are always quantized at exactly this layer's a_scale,
        # so the fold is valid for both entry paths
        s_in = 1.0 if layer.act_folded else (
            layer.a_scale if x_scale is None else x_scale)
        y = conv_int8(x_q, jnp.asarray(layer.w_q), layer.strides,
                      layer.groups)
        bias = jnp.asarray(layer.bias)
        if layer.bias_corr is not None:
            bias = bias + jnp.asarray(layer.bias_corr)
        y = y.astype(jnp.float32) * (jnp.asarray(layer.w_scale)
                                     * jnp.float32(s_in)) + bias
    else:
        # bf16 compute (layers not quantized: final sigmoid conv, and the
        # depthwise convs / stem where the config keeps them in bf16)
        xb = (x.astype(jnp.float32)
              * jnp.asarray(np.asarray(x_scale, np.float32))
              if x_scale is not None else x).astype(jnp.bfloat16)
        k = jnp.asarray(layer.kernel, jnp.bfloat16)
        if layer.kind == "deconv":
            y = _deconv(xb, k, layer.strides)
        else:
            y = _conv(xb, k, layer.strides, layer.groups)
        y = y.astype(jnp.float32) + jnp.asarray(layer.bias)
    y = _ACTS[layer.act](y)
    if layer.kind == "out_d2s":
        y = _depth_to_space2(y)
    if out_scale is not None:
        return _quantize_act(y, out_scale), out_scale
    return y, None


def run_layers(layers, x, quant: bool, collect=None, calib_pct: float = 100.0,
               x_scale=None, out_scale=None):
    """x_scale: scale of an already-int8 input `x` (a producer segment
    quantized it — the C4 hand-off below); out_scale: requantize the final
    output to int8 at this scale instead of returning f32 (XLA fuses the
    round/clip/cast into the last conv's epilogue)."""
    if not quant:
        assert x_scale is None and out_scale is None
        for layer in layers:
            x = run_layer_f32(layer, x, collect, calib_pct)
        return x
    scale = x_scale
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        # inter-layer tensors stay int8 in device memory whenever the next
        # layer has a calibrated input scale — even between bf16 layers,
        # int8 storage is the 4× activation-traffic cut (the bf16 layer
        # dequantizes on load)
        nxt_scale = (nxt.a_scale if nxt is not None and _scale_ok(nxt.a_scale)
                     else None)
        x, scale = run_layer_int8(layer, x, scale, nxt_scale)
        i += 1
    if out_scale is not None:
        if scale is None:
            x = _quantize_act(x, out_scale)
        else:
            # a segment that already ended int8 must have ended at the
            # requested scale — returning int8 at a different chained scale
            # would be silently dequantized wrong by the caller
            assert np.array_equal(np.asarray(scale), np.asarray(out_scale)), \
                "run_layers ended int8 at a scale != out_scale"
        return x
    assert scale is None  # segments end in an f32 (linear/sigmoid) layer
    return x


# ---------------------------------------------------------------------------
# Calibration + weight quantization
# ---------------------------------------------------------------------------


def _trunk_outputs(graph, images, quant: bool, collect=None,
                   calib_pct: float = 100.0):
    # int8 C4 hand-off: the trunk output is a 5.5 MB/img f32 tensor at 416²
    # that an f32 hand-off writes once and reads twice (neck + yolo each
    # re-quantize it). The neck's and yolo's input scales are calibrated on
    # the SAME tensor, so when they agree the trunk requantizes C4 once and
    # both consumers read int8 (4× less traffic; value-identical up to
    # FMA-reassociation rounding flips on requantize boundaries).
    shared = None
    if quant and collect is None and graph["neck"] and graph["yolo"]:
        na, ya = graph["neck"][0], graph["yolo"][0]
        # BOTH consumers must be int8 layers that would quantize their input
        # anyway (quantize + w_q + calibrated scale — the run_layer_int8
        # entry condition): a consumer running in f32 (e.g. block7/dw when
        # QUANT_DW_INT8 is off at 224²) reads the exact f32 C4 today, and
        # handing it dequantized int8 would inject a quantization round-trip
        # that never existed (caught by test_int8_c4_handoff_bit_identical).
        if (na.quantize and na.w_q is not None
                and ya.quantize and ya.w_q is not None
                and _scale_ok(na.a_scale) and _scale_ok(ya.a_scale)
                and np.array_equal(np.asarray(na.a_scale),
                                   np.asarray(ya.a_scale))
                and na.act_folded == ya.act_folded):
            shared = na.a_scale
    c4 = run_layers(graph["trunk"], images, quant, collect,
                    calib_pct=calib_pct, out_scale=shared)
    fmap = run_layers(graph["neck"], c4, quant, collect,
                      calib_pct=calib_pct, x_scale=shared)
    raw = run_layers(graph["yolo"], c4, quant, collect,
                     calib_pct=calib_pct, x_scale=shared)
    return raw, fmap


def _mask_outputs(graph, rois, fmap, pool_size: int, num_classes: int,
                  quant: bool, collect=None, image_hw=(224, 224),
                  calib_pct: float = 100.0, classes=None,
                  fast_crop: bool = False):
    """classes: optional [B, R] int32 — fold the per-ROI class selection
    INTO the final 1×1 mask conv (gather each ROI's 256→1 filter column)
    and return already-selected [B, R, 2p, 2p] masks instead of the full
    [B, R, 2p, 2p, num_classes] tensor. Same products, same 256-term
    accumulation per output — but the class conv writes (and the select
    einsum re-reads) num_classes× less.

    fast_crop: crop with default matmul precision instead of HIGHEST —
    quant-path only (see ops/roi_align.crop_and_resize)."""
    b, r = rois.shape[:2]
    # quant path crops in bf16: halves the [B,K,14,28,C] contraction
    # intermediates' memory traffic; calibration/parity path stays f32
    dt = jnp.bfloat16 if quant else jnp.float32
    prec = (jax.lax.Precision.DEFAULT if (fast_crop and quant) else None)
    if isinstance(fmap, (tuple, list)):
        # FPN hybrid mode: pool each ROI from its pyramid level
        from .ops.roi_align import multilevel_crop_and_resize

        x = multilevel_crop_and_resize(tuple(fmap), rois,
                                       (pool_size, pool_size),
                                       image_hw=tuple(image_hw),
                                       canonical_level=1).astype(dt)
    else:
        x = crop_and_resize(fmap, rois, (pool_size, pool_size), dtype=dt,
                            precision=prec)
    x = x.astype(jnp.float32)
    x = x.reshape(b * r, pool_size, pool_size, x.shape[-1])
    side = 2 * pool_size
    if classes is not None:
        last = graph["mask"][-1]
        assert last.kind == "out_d2s" and collect is None
        # keep the deconv→class-conv tensor int8 in memory exactly like the
        # full path does (run_layers' out_scale chaining)
        ms = last.a_scale if quant and _scale_ok(last.a_scale) else None
        x = run_layers(graph["mask"][:-1], x, quant, calib_pct=calib_pct,
                       out_scale=ms)
        return _selected_out_d2s(last, x, classes.reshape(b * r),
                                 num_classes, pool_size,
                                 x_scale=ms).reshape(b, r, side, side)
    x = run_layers(graph["mask"], x, quant, collect, calib_pct=calib_pct)
    return x.reshape(b, r, side, side, num_classes)


def _selected_out_d2s(layer: Layer, x, classes, num_classes: int,
                      pool_size: int, x_scale=None):
    """The out_d2s class conv with per-ROI class selection folded in.

    The stored kernel is the block-diagonal [1, 1, 4·co, 4·nc] expansion
    (see _mask_layers) whose block `blk`, column `c` is the original class
    conv's [co] filter for class c — so block 0's first nc columns ARE the
    original [co, nc] matrix. Selecting class c_n for ROI n before the
    matmul (a [co] gather) computes exactly the products the full conv +
    one-hot einsum would keep, over the same co-term accumulation.

    x: [N, p, p, 4·co] f32 (deconv+relu output), or int8 at scale x_scale.
    classes: [N] int32. Returns [N, 2p, 2p] f32 sigmoid masks.
    """
    co = layer.kernel.shape[2] // 4
    w = jnp.asarray(layer.kernel[0, 0, :co, :num_classes])  # [co, nc]
    b4 = jnp.asarray(layer.bias[:num_classes])              # [nc]
    w_sel = jnp.take(w.T, classes, axis=0)                  # [N, co]
    b_sel = jnp.take(b4, classes)                           # [N]
    if x_scale is not None:  # dequantize (fuses into the einsum's load)
        x = x.astype(jnp.float32) * jnp.asarray(np.asarray(x_scale,
                                                           np.float32))
    n, p = x.shape[0], x.shape[1]
    xb = x.reshape(n, p, p, 4, co).astype(jnp.bfloat16)
    y = jnp.einsum("nhwbc,nc->nhwb", xb, w_sel.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    y = jax.nn.sigmoid(y + b_sel[:, None, None, None])
    return _depth_to_space2(y)[..., 0]


def calibrate(graph, config, images, rois=None, float_trunk=None):
    """One f32 forward over calibration images; sets each layer's a_scale.

    images: [N, H, W, 3] float in [0, 1]. rois: [N, R, 4] normalized boxes for
    the mask branch (defaults to a few spread boxes). float_trunk: hybrid-mode
    callable images -> (grid, fmap/pyramid) supplying the feature maps when
    the graph has no quantized trunk."""
    if rois is None:
        base = np.asarray([[0.0, 0.0, 1.0, 1.0], [0.1, 0.1, 0.6, 0.6],
                           [0.4, 0.4, 0.9, 0.9], [0.25, 0.25, 0.75, 0.75]],
                          np.float32)
        rois = np.tile(base[None], (images.shape[0], 1, 1))

    hw = tuple(config.IMAGE_SHAPE[:2])
    # activation-range statistic: 100 = absmax (default; percentile clipping
    # measured WORSE at the 81-class point — see run_layer_f32 docstring)
    pct = float(getattr(config, "QUANT_CALIB_PCT", 100.0) or 100.0)

    @jax.jit
    def probe(images, rois):
        collect = []
        if graph["trunk"] is not None:
            raw, fmap = _trunk_outputs(graph, images, quant=False,
                                       collect=collect, calib_pct=pct)
        else:
            # hybrid mode: the module trunk supplies the feature map(s)
            fmap = float_trunk(images)[1]
        _mask_outputs(graph, rois, fmap, config.MASK_POOL_SIZE,
                      config.NUM_CLASSES, quant=False, collect=collect,
                      image_hw=hw, calib_pct=pct)
        return {name: v for name, v in collect}

    # per-channel activation scales (QUANT_PER_CHANNEL_ACT): keep the
    # per-channel absmax vector instead of reducing it to one scalar.
    # Only defined for the absmax statistic (percentile mode stays scalar).
    per_ch = bool(getattr(config, "QUANT_PER_CHANNEL_ACT", False)) \
        and pct >= 100.0

    absmax = jax.device_get(probe(jnp.asarray(images), jnp.asarray(rois)))
    for part in graph.values():
        for layer in part or ():
            if layer.name in absmax:
                v = np.asarray(absmax[layer.name], np.float32)
                if per_ch and v.ndim == 1:
                    if layer.quantize:
                        # SmoothQuant-style split (Xiao et al. 2022): folding
                        # the FULL per-channel act range into the kernel just
                        # moves the imbalance into the weight grid (the
                        # per-output-channel weight scales can't compensate
                        # input-channel variation — measured 16x WORSE than
                        # per-tensor). Migrate only r_c = a_c^α / w_c^(1-α)
                        # (α=0.5 splits the burden evenly); the remaining
                        # uniform factor distorts nothing.
                        k = np.abs(np.asarray(layer.kernel, np.float32))
                        ax = k.ndim - 1 if layer.kind == "dw" else k.ndim - 2
                        w_c = np.moveaxis(k, ax, 0).reshape(
                            k.shape[ax], -1).max(axis=1)
                        a_c = np.maximum(v, 1e-12)
                        w_c = np.maximum(w_c, 1e-12)
                        alpha = float(getattr(config, "QUANT_SMOOTH_ALPHA",
                                              0.5))
                        r = a_c ** alpha / w_c ** (1.0 - alpha)
                        s = r * (float(np.max(a_c / r)) / 127.0)
                    else:
                        # bf16/storage-only layers have no weight grid to
                        # protect: exact per-channel absmax is strictly best
                        s = v / 127.0
                    # dead channels (absmax 0) quantize exactly at ANY scale,
                    # but a large fallback (e.g. 1.0) would dominate the
                    # folded kernel's per-output-channel absmax and crush
                    # the live channels' weight resolution — fill with the
                    # median live scale instead (measured 70x weight-error
                    # difference on a random-init trunk with dead relu6
                    # channels)
                    pos = s[v > 0]
                    fill = float(np.median(pos)) if pos.size else 1.0
                    layer.a_scale = np.where(v > 0, s,
                                             fill).astype(np.float32)
                else:
                    layer.a_scale = float(v.max()) / 127.0 or 1.0
    return graph


def quantize_weights(graph):
    """Symmetric per-output-channel int8 weights for quantizable layers.

    Per-channel activation scales (vector a_scale) fold into the kernel
    before weight quantization: y = Σ_ci W[..,ci,co]·(x_q[..,ci]·s_ci)
    = Σ_ci (W·s_ci)[..,ci,co]·x_q[..,ci], so the int8 matmul and its
    per-output-channel dequant are unchanged — s_in becomes exactly 1.
    """
    for part in graph.values():
        for layer in part or ():
            if layer.quantize:
                _quantize_layer_kernel(layer,
                                       np.asarray(layer.kernel, np.float32))
    return graph


def _quantize_layer_kernel(layer, k):
    """Set layer.w_q/w_scale from the f32 kernel `k` (folding a vector
    a_scale along the input-channel axis first)."""
    if isinstance(layer.a_scale, np.ndarray):
        if layer.kind == "dw":
            # grouped [kh, kw, 1, C]: output channel c reads only
            # input channel c → fold along the trailing axis
            k = k * layer.a_scale.reshape(1, 1, 1, -1)
        else:
            k = k * layer.a_scale.reshape(1, 1, -1, 1)
        layer.act_folded = True
    absmax = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    layer.w_q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    layer.w_scale = scale


def bias_correct(graph, config, images, rois=None, float_trunk=None):
    """Per-output-channel bias correction (Nagel et al. 2019, §5 of
    "Data-Free Quantization Through Weight Equalization and Bias
    Correction"). Must run AFTER quantize_weights.

    For every quantized layer, the expected pre-activation quantization
    error E[conv_f32(x) + b  −  (deq(conv_int8(quant(x))) + b)] is measured
    over the calibration batch, with x taken from the exact f32 forward
    (errors are corrected layer-by-layer, not compounded). The per-channel
    mean lands in layer.bias_corr, which run_layer_int8 adds on the int8
    path only — run_layer_f32 keeps bit parity with the module forward.
    """
    if rois is None:
        base = np.asarray([[0.0, 0.0, 1.0, 1.0], [0.1, 0.1, 0.6, 0.6],
                           [0.4, 0.4, 0.9, 0.9], [0.25, 0.25, 0.75, 0.75]],
                          np.float32)
        rois = np.tile(base[None], (images.shape[0], 1, 1))

    def correct_chain(layers, x):
        for layer in layers:
            if (layer.quantize and layer.w_q is not None
                    and _scale_ok(layer.a_scale)):
                y_f = _conv(x, jnp.asarray(layer.kernel), layer.strides,
                            layer.groups)
                x_q = _quantize_act(x, layer.a_scale)
                s_in = 1.0 if layer.act_folded else layer.a_scale
                y_q = conv_int8(x_q, jnp.asarray(layer.w_q), layer.strides,
                                layer.groups)
                y_q = y_q.astype(jnp.float32) * (jnp.asarray(layer.w_scale)
                                                 * jnp.float32(s_in))
                delta = jnp.mean((y_f - y_q).astype(jnp.float32),
                                 axis=(0, 1, 2))
                layer.bias_corr = np.asarray(jax.device_get(delta),
                                             np.float32)
            x = run_layer_f32(layer, x)
        return x

    images = jnp.asarray(images)
    if graph["trunk"] is not None:
        c4 = correct_chain(graph["trunk"], images)
        fmap = correct_chain(graph["neck"], c4)
        correct_chain(graph["yolo"], c4)
    else:
        fmap = float_trunk(images)[1]

    pool = config.MASK_POOL_SIZE
    rois = jnp.asarray(rois)
    b, r = rois.shape[:2]
    if isinstance(fmap, (tuple, list)):
        from .ops.roi_align import multilevel_crop_and_resize

        x = multilevel_crop_and_resize(tuple(fmap), rois, (pool, pool),
                                       image_hw=tuple(config.IMAGE_SHAPE[:2]),
                                       canonical_level=1)
    else:
        x = crop_and_resize(fmap, rois, (pool, pool), dtype=jnp.float32)
    x = x.astype(jnp.float32).reshape(b * r, pool, pool, x.shape[-1])
    correct_chain(graph["mask"], x)
    return graph


# ---------------------------------------------------------------------------
# Quantization-aware fine-tuning (distillation-based, label-free)
# ---------------------------------------------------------------------------


def _fq(v, s):
    """Quantize→dequantize at scale `s` with a straight-through gradient
    (the round/clip is invisible to autodiff; s may be per-channel, and may
    be a traced value — _fq_kernel recomputes weight scales on the fly)."""
    s = jnp.asarray(s, jnp.float32)
    q = jnp.clip(jnp.round(v / s), -127, 127) * s
    return v + jax.lax.stop_gradient(q - v)


def _fq_kernel(k, layer):
    """Effective f32 kernel the int8 path realizes: fold a vector a_scale,
    fake-quant at per-output-channel scales, unfold. The scales are
    recomputed from the current kernel under stop_gradient (absmax tracks
    the weights as they drift during fine-tuning)."""
    fold = None
    if isinstance(layer.a_scale, np.ndarray):
        shape = (1, 1, 1, -1) if layer.kind == "dw" else (1, 1, -1, 1)
        fold = jnp.asarray(layer.a_scale).reshape(shape)
        k = k * fold
    s = jax.lax.stop_gradient(jnp.maximum(
        jnp.max(jnp.abs(k), axis=(0, 1, 2), keepdims=True), 1e-12) / 127.0)
    k = _fq(k, s)
    if fold is not None:
        k = k / fold
    return k


def _run_layers_fq(layers, x, params):
    """f32 forward with fake-quantized weights/activations on the layers the
    int8 path quantizes — the differentiable simulation of run_layers(quant=
    True). params: {layer.name: {"kernel", "bias"}} trainable overrides."""
    for layer in layers:
        p = params.get(layer.name)
        k = p["kernel"] if p else jnp.asarray(layer.kernel)
        b = p["bias"] if p else jnp.asarray(layer.bias)
        if (layer.quantize and layer.w_q is not None
                and _scale_ok(layer.a_scale)):
            x = _fq(x, layer.a_scale)
            k = _fq_kernel(k, layer)
        y = _conv(x, k, layer.strides, layer.groups) + b
        y = _ACTS[layer.act](y)
        if layer.kind == "out_d2s":
            y = _depth_to_space2(y)
        x = y
    return x


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class QuantizedDetector:
    """int8 end-to-end detect pipeline with the same outputs as
    pipelines.detect_outputs (decode/NMS/top-K/paste stay f32 on-chip).

    Backbones other than mobilenet run in HYBRID mode: the trunk stays the
    module forward (bf16 for bf16 configs) and only the mask head — the branch
    whose cost is linear in the kept-detection count — runs int8. A fully
    quantized residual/FPN trunk would need a graph (not chain) executor;
    hybrid mode removes the previous hard NotImplementedError while keeping
    the accuracy-lossless int8 contract for the quantized part."""

    def __init__(self, graph, config, float_trunk=None):
        self.graph = graph
        self.config = config
        self._float_trunk = float_trunk
        self._detect = None
        self._detect_sharded = None
        self._infer_yolo = None

    @classmethod
    def from_variables(cls, variables, config, calib_images, net=None):
        """net: the MaskYoloNet — required for non-mobilenet (hybrid)
        backbones, whose trunk keeps running through the module."""
        graph = build_layer_graph(variables, config)
        float_trunk = None
        if graph["trunk"] is None:
            if net is None:
                raise ValueError(
                    f"BACKBONE={config.BACKBONE!r} quantizes in hybrid mode: "
                    "pass net= so the trunk can run through the module")
            from . import pipelines

            def float_trunk(images):
                return net.apply(variables, pipelines.images_f32(images),
                                 train=False, method=net.pick_trunk())
        graph = calibrate(graph, config, calib_images, float_trunk=float_trunk)
        graph = quantize_weights(graph)
        if bool(getattr(config, "QUANT_BIAS_CORRECT", False)):
            graph = bias_correct(graph, config, calib_images,
                                 float_trunk=float_trunk)
        return cls(graph, config, float_trunk=float_trunk)

    def finetune(self, images, rois=None, steps: int = 200, lr: float = 1e-5,
                 seed: int = 0):
        """Quantization-aware fine-tuning (label-free distillation).

        Tunes the quantized layers' kernels/biases so the int8 forward
        matches the f32 teacher's outputs (raw grid, feature map, mask
        probabilities) on `images`, using straight-through fake-quant —
        the int8 rounding is inside the training loss, so the optimizer
        moves weights to quantization-friendly points.

        Results are written ONLY into the int8 deployment graph: tuned
        kernels re-quantize into w_q/w_scale and tuned biases land in
        bias_corr. run_layer_f32 / trunk(quant=False) keep the exact module
        weights, so parity oracles and re-calibration are unaffected.

        Returns {"loss_initial", "loss_final"} (normalized MSE vs teacher).
        """
        import optax

        graph, cfg = self.graph, self.config
        if rois is None:
            base = np.asarray([[0.0, 0.0, 1.0, 1.0], [0.1, 0.1, 0.6, 0.6],
                               [0.4, 0.4, 0.9, 0.9],
                               [0.25, 0.25, 0.75, 0.75]], np.float32)
            rois = np.tile(base[None], (np.asarray(images).shape[0], 1, 1))
        images = jnp.asarray(images)
        rois = jnp.asarray(rois)
        pool = cfg.MASK_POOL_SIZE
        hw = tuple(cfg.IMAGE_SHAPE[:2])
        b, r = rois.shape[:2]

        def crop(fmap, dtype=jnp.float32):
            if isinstance(fmap, (tuple, list)):
                from .ops.roi_align import multilevel_crop_and_resize

                x = multilevel_crop_and_resize(tuple(fmap), rois,
                                               (pool, pool), image_hw=hw,
                                               canonical_level=1)
            else:
                x = crop_and_resize(fmap, rois, (pool, pool), dtype=dtype)
            return x.astype(jnp.float32).reshape(b * r, pool, pool,
                                                 x.shape[-1])

        # f32 teacher targets (original weights)
        @jax.jit
        def teacher():
            if graph["trunk"] is not None:
                raw_t, fmap_t = _trunk_outputs(graph, images, quant=False)
            else:
                raw_t, fmap_t = None, self._float_trunk(images)[1]
            mask_t = run_layers(graph["mask"], crop(fmap_t), quant=False)
            return raw_t, fmap_t, mask_t

        raw_t, fmap_t, mask_t = teacher()

        params = {}
        for part in graph.values():
            for l in part or ():
                if l.quantize and l.w_q is not None:
                    bias = np.asarray(l.bias, np.float32)
                    if l.bias_corr is not None:
                        bias = bias + l.bias_corr
                    params[l.name] = {
                        "kernel": jnp.asarray(l.kernel, jnp.float32),
                        "bias": jnp.asarray(bias),
                    }
        if not params:
            return {"loss_initial": 0.0, "loss_final": 0.0}

        def nmse(x, t):
            return jnp.mean((x - t) ** 2) / (jnp.mean(t ** 2) + 1e-8)

        # QUANT_QAT_MASK_WEIGHT: up-weight the mask-probability term of the
        # distillation objective. The 81-class int8 residual lives in the
        # mask branch (−0.009 mask AP50 vs −0.006 box, docs/QUALITY.md); the
        # joint equal-weight objective lets grid/fmap error trade against it.
        mw = float(getattr(cfg, "QUANT_QAT_MASK_WEIGHT", 1.0) or 1.0)

        def loss_fn(p):
            if graph["trunk"] is not None:
                c4 = _run_layers_fq(graph["trunk"], images, p)
                fmap = _run_layers_fq(graph["neck"], c4, p)
                raw = _run_layers_fq(graph["yolo"], c4, p)
                loss = nmse(raw, raw_t) + nmse(fmap, fmap_t)
            else:
                fmap, loss = fmap_t, 0.0
            mask = _run_layers_fq(graph["mask"], crop(fmap), p)
            return loss + mw * nmse(mask, mask_t)

        opt = optax.adam(lr)

        @jax.jit
        def step(p, state):
            loss, grads = jax.value_and_grad(loss_fn)(p)
            upd, state = opt.update(grads, state)
            return optax.apply_updates(p, upd), state, loss

        state = opt.init(params)
        loss0 = None
        best = (np.inf, params)
        for _ in range(int(steps)):
            new_params, state, l = step(params, state)
            l = float(l)  # loss at `params` (pre-update)
            if loss0 is None:
                loss0 = l
            if l < best[0]:
                best = (l, params)
            params = new_params
        # the last update's params are unevaluated; score them too so the
        # returned graph is the best point actually observed
        final_l = float(loss_fn(params))
        if final_l < best[0]:
            best = (final_l, params)
        loss, params = best

        # write back into the int8 deployment graph only
        for part in graph.values():
            for l in part or ():
                p = params.get(l.name)
                if p is None:
                    continue
                _quantize_layer_kernel(
                    l, np.asarray(jax.device_get(p["kernel"]), np.float32))
                l.bias_corr = (np.asarray(jax.device_get(p["bias"]),
                                          np.float32)
                               - np.asarray(l.bias, np.float32))
        self._detect = None  # re-jit with the tuned constants
        self._detect_sharded = None
        self._infer_yolo = None
        return {"loss_initial": loss0, "loss_final": loss}

    def trunk(self, images, quant: bool = True):
        if self.graph["trunk"] is None:
            return self._float_trunk(images)
        raw, fmap = _trunk_outputs(self.graph, images, quant)
        b, gh, gw = raw.shape[0], raw.shape[1], raw.shape[2]
        nb = self.config.N_BOX
        grid = raw.reshape(b, gh, gw, nb, raw.shape[-1] // nb)
        return grid.astype(jnp.float32), fmap

    def mask_branch(self, rois, fmap, quant: bool = True, classes=None):
        """classes: optional [B, R] int32 — return already-class-selected
        [B, R, 2p, 2p] masks via the folded class conv (_selected_out_d2s);
        None returns the full [B, R, 2p, 2p, num_classes] tensor."""
        return _mask_outputs(self.graph, rois, fmap,
                             self.config.MASK_POOL_SIZE,
                             self.config.NUM_CLASSES, quant,
                             image_hw=tuple(self.config.IMAGE_SHAPE[:2]),
                             classes=classes,
                             fast_crop=bool(getattr(self.config,
                                                    "QUANT_FAST_CROP", False)))

    def select_masks(self, rois, fmap, classes):
        """[B, R] ROIs + classes → [B, R, 2p, 2p] class-selected masks: the
        folded class conv under QUANT_FOLD_MASK_SELECT, else the full class
        conv and a one-hot select (pipelines.select_class)."""
        if (self.config.QUANT_FOLD_MASK_SELECT
                and self.graph["mask"][-1].kind == "out_d2s"):
            return self.mask_branch(rois, fmap, classes=classes)
        from .pipelines import select_class

        return select_class(self.mask_branch(rois, fmap), classes,
                            self.config.NUM_CLASSES)

    def detect_outputs(self, images, mesh=None):
        """Same contract as pipelines.detect_outputs, int8 conv stack.

        mesh: a jax.sharding.Mesh shards the batch over its 'data' axis
        (the int8 weights are jit constants and replicate). The pipeline is
        per-image independent, so no collectives are inserted. Batch must
        divide by the data-axis size."""
        detect_fn = self.detect_fn()
        if mesh is not None:
            from .parallel.mesh import batch_sharding, place_batch_array

            # keep uint8 batches uint8: the on-device images_f32 handles the
            # /255 (a float32 cast here would skip it and feed 0..255 floats)
            images = np.asarray(images)
            if images.dtype != np.uint8:
                images = images.astype(np.float32, copy=False)
            images = place_batch_array(images, batch_sharding(mesh))
            if mesh.shape.get("model", 1) <= 1:
                # pure DP: manual batch sharding (shard_map) — zero
                # collectives by construction; GSPMD's TopK partitioner
                # would otherwise all-gather the batch at the score top-K
                # (same fix as parallel/inference.ShardedDetector)
                # cache is (mesh, fn): a shard_map is bound to the mesh it
                # was built over — reusing it for a different mesh would
                # misplace shards (model.detect_batch guards the same way)
                if (self._detect_sharded is None
                        or self._detect_sharded[0] is not mesh):
                    from jax.sharding import PartitionSpec as P

                    self._detect_sharded = (mesh, jax.jit(jax.shard_map(
                        detect_fn, mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"))))
                return self._detect_sharded[1](images)
        return detect_fn(images)

    def infer_yolo_outputs(self, images):
        """Same contract as pipelines.infer_yolo_outputs (detection-only
        inference, reference model.py:1198-1236), int8 trunk. Decode and the
        per-class NMS stay f32 on-chip, exactly like detect_outputs."""
        return self.infer_yolo_fn()(images)

    def infer_yolo_fn(self):
        """The jitted images→infer_yolo-outputs callable (int8 trunk weights
        baked in as jit constants) — the detection-only counterpart of
        detect_fn, so infer_yolo serves the same quantized trunk that detect
        does after MaskYOLO.quantize()."""
        if self._infer_yolo is None:
            from . import pipelines

            config = self.config

            @jax.jit
            def infer_yolo(images):
                return pipelines.infer_yolo_from_callables(
                    self.trunk, images, config)

            self._infer_yolo = infer_yolo
        return self._infer_yolo

    def detect_fn(self):
        """The jitted images→outputs callable (int8 weights baked in as jit
        constants) — also what export.py AOT-serializes for int8 serving
        artifacts."""
        if self._detect is None:
            from . import pipelines

            config = self.config

            @jax.jit
            def detect(images):
                return pipelines.detect_from_callables(
                    self.trunk, self.select_masks, images, config)

            self._detect = detect
            self._detect_sharded = None  # wraps the fn above; rebuild too
        return self._detect
