"""int8 convolutions with exact int32 accumulation, in forms XLA:GPU compiles.

XLA:GPU hands integer convolutions to cuDNN, which takes only narrow
patterns (NHWC, channel counts that are multiples of 4, no feature groups).
The quantized detect path (quant.py) has layers outside them: the RGB stem
(3 input channels) and the depthwise convs (`feature_group_count = C`). So
every int8 conv here is written without `conv_general_dilated`:

  * 1×1 (pointwise, deconv-as-1×1, class conv): an int8 `dot_general` over
    the channel axis with `preferred_element_type=int32` (an int8 GEMM);
  * dense k×k (stem, neck, mask convs): the k² shifted SAME-padded windows
    concatenated along channels ("patches", ordered like the HWIO kernel's
    flattening) and the same int8 `dot_general`;
  * depthwise k×k: k² shifted int32 multiply-adds, which XLA fuses into one
    elementwise kernel.

The GEMM contraction is zero-padded to a multiple of 32, the int8 MMA
depth: with the RGB stem's K = 27, XLA:GPU's Triton int8 GEMM returned
wrong sums for a batch of 8 at 416² on an H100 (jax 0.9.0), while K
padded to 28 or 32 was exact. Zeros add nothing to an integer sum.

Integer sums are exact in any order, so each form equals
`lax.conv_general_dilated(x, w, strides, "SAME", ("NHWC", "HWIO", "NHWC"),
feature_group_count=g, preferred_element_type=int32)` bit for bit
(tests/test_int8_conv.py checks each kind against it).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _same_pad(size: int, k: int, s: int):
    """Output size and (lo, hi) padding of a SAME conv along one axis
    (lax's rule: the odd pixel of padding goes to the high side)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, (total // 2, total - total // 2)


def _windows(x, kh: int, kw: int, strides):
    """The kh·kw strided windows of SAME-padded x, each [N, Ho, Wo, C], in
    (dy, dx) row-major order — the order of an HWIO kernel's leading axes."""
    n, h, w, c = x.shape
    sh, sw = strides
    ho, ph = _same_pad(h, kh, sh)
    wo, pw = _same_pad(w, kw, sw)
    xp = jnp.pad(x, ((0, 0), ph, pw, (0, 0)))
    return [lax.slice(xp, (0, dy, dx, 0),
                      (n, dy + (ho - 1) * sh + 1, dx + (wo - 1) * sw + 1, c),
                      (1, sh, sw, 1))
            for dy in range(kh) for dx in range(kw)]


_K_MULTIPLE = 32


def _gemm(cols, w2d):
    """[..., K] int8 · [K, O] int8 → [..., O] int32, K zero-padded to a
    multiple of 32."""
    pad = -w2d.shape[0] % _K_MULTIPLE
    if pad:
        cols = jnp.pad(cols, [(0, 0)] * (cols.ndim - 1) + [(0, pad)])
        w2d = jnp.pad(w2d, ((0, pad), (0, 0)))
    return lax.dot_general(cols, w2d, (((cols.ndim - 1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)


def conv_int8(x, w, strides=(1, 1), groups: int = 1):
    """SAME-padded NHWC int8 conv with int32 accumulation.

    x: int8 [N, H, W, C]; w: int8 HWIO [kh, kw, C/groups, O].
    groups: 1 (dense) or C with a [kh, kw, 1, C] kernel (depthwise).
    Returns int32 [N, ceil(H/sh), ceil(W/sw), O].
    """
    kh, kw, ci, co = w.shape
    strides = tuple(strides)
    if groups == 1:
        if kh == kw == 1:
            # a 1×1 SAME conv pads nothing: striding is subsampling
            cols = x[:, ::strides[0], ::strides[1]]
        else:
            cols = jnp.concatenate(_windows(x, kh, kw, strides), axis=-1)
        return _gemm(cols, w.reshape(kh * kw * ci, co))
    if ci == 1 and groups == x.shape[-1] == co:
        wi = w.astype(jnp.int32)
        acc = None
        for i, win in enumerate(_windows(x, kh, kw, strides)):
            term = win.astype(jnp.int32) * wi[i // kw, i % kw, 0]
            acc = term if acc is None else acc + term
        return acc
    raise NotImplementedError(
        f"int8 conv with feature_group_count={groups} over {x.shape[-1]} "
        f"channels and a {tuple(w.shape)} kernel: only dense and depthwise "
        "convs have an int8 form")
