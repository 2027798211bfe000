"""Truncated MobileNetV1 backbone.

Rebuilds the reference's mobilenet_graph (/root/reference/myolo/model.py:55-79):
3x3/s2 stem (32ch) + six depthwise-separable blocks
(64, 64/s2, 128, 256/s2, 256, 512), producing a stride-8 feature map
(28x28x512 at 224² input). The extra 512-channel block matches the
reference's "added by me" block_id=6 (model.py:77).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import nn
from .layers import ConvBN, DepthwiseSeparable


class MobileNetBackbone(nn.Module):
    alpha: float = 1.0
    depth_multiplier: int = 1
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None

    def __call__(self, x, train: bool = False):
        a, dm, dt = self.alpha, self.depth_multiplier, self.dtype
        # 224x224x3 -> 112x112x32 stem (reference conv_block, model.py:42-52)
        x = ConvBN(int(32 * a), (3, 3), (2, 2), dtype=dt, axis_name=self.axis_name,
                   name="conv1")(x, train)
        # 112 -> 56
        x = DepthwiseSeparable(64, (1, 1), a, dm, dt, self.axis_name, name="block1")(x, train)
        x = DepthwiseSeparable(64, (2, 2), a, dm, dt, self.axis_name, name="block2")(x, train)
        # 56 -> 28
        x = DepthwiseSeparable(128, (1, 1), a, dm, dt, self.axis_name, name="block3")(x, train)
        x = DepthwiseSeparable(256, (2, 2), a, dm, dt, self.axis_name, name="block4")(x, train)
        # 28x28
        x = DepthwiseSeparable(256, (1, 1), a, dm, dt, self.axis_name, name="block5")(x, train)
        x = DepthwiseSeparable(512, (1, 1), a, dm, dt, self.axis_name, name="block6")(x, train)
        return x  # [B, H/8, W/8, 512]
