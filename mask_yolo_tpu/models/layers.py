"""Shared NN building blocks.

Counterparts of the reference's Keras blocks: `conv_block`
(/root/reference/myolo/model.py:42-52) and keras_applications'
`_depthwise_conv_block` (imported at model.py:19). Parameters are float32;
compute dtype is configurable (bfloat16 for production configs) so the
convolutions run on the tensor cores while the optimizer state stays fp32.

BatchNorm: the reference uses Keras BN with TRAIN_BN=False (config.py:227),
i.e. frozen statistics. Here BN carries a `batch_stats` collection; `train=True`
with `train_bn=True` updates the running stats, otherwise the running averages
are used — the multi-replica-safe equivalent (stats sync via cross-replica
axis when present).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from . import nn


def relu6(x):
    """relu capped at 6 (reference model.py:38-39)."""
    return jnp.minimum(jnp.maximum(x, 0.0), 6.0)


class ConvBN(nn.Module):
    """Conv2D + BatchNorm + activation."""

    features: int
    kernel: tuple = (3, 3)
    strides: tuple = (1, 1)
    padding: str = "SAME"
    activation: Callable | None = relu6
    use_bias: bool = False
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None

    def __call__(self, x, train: bool = False):
        x = nn.Conv(
            self.features,
            self.kernel,
            strides=self.strides,
            padding=self.padding,
            use_bias=self.use_bias,
            dtype=self.dtype,
            param_dtype=jnp.float32,
            name="conv",
        )(x)
        x = nn.BatchNorm(
            use_running_average=not train,
            dtype=jnp.float32,  # BN stats in f32 (bf16 batch stats corrupt the running averages)
            axis_name=self.axis_name if train else None,
            name="bn",
        )(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class DepthwiseSeparable(nn.Module):
    """MobileNetV1 depthwise-separable block: 3x3 depthwise conv + BN + relu6,
    then 1x1 pointwise conv + BN + relu6 (keras_applications
    _depthwise_conv_block semantics, reference model.py:19,68-77)."""

    features: int
    strides: tuple = (1, 1)
    alpha: float = 1.0
    depth_multiplier: int = 1
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None

    def __call__(self, x, train: bool = False):
        in_ch = x.shape[-1]
        out_ch = int(self.features * self.alpha)
        # depthwise: groups == input channels
        x = nn.Conv(
            in_ch * self.depth_multiplier,
            (3, 3),
            strides=self.strides,
            padding="SAME",
            feature_group_count=in_ch,
            use_bias=False,
            dtype=self.dtype,
            param_dtype=jnp.float32,
            name="conv_dw",
        )(x)
        x = nn.BatchNorm(
            use_running_average=not train,
            dtype=jnp.float32,  # BN stats in f32 (bf16 batch stats corrupt the running averages)
            axis_name=self.axis_name if train else None,
            name="conv_dw_bn",
        )(x)
        x = relu6(x)
        x = nn.Conv(
            out_ch,
            (1, 1),
            strides=(1, 1),
            padding="SAME",
            use_bias=False,
            dtype=self.dtype,
            param_dtype=jnp.float32,
            name="conv_pw",
        )(x)
        x = nn.BatchNorm(
            use_running_average=not train,
            dtype=jnp.float32,  # BN stats in f32 (bf16 batch stats corrupt the running averages)
            axis_name=self.axis_name if train else None,
            name="conv_pw_bn",
        )(x)
        return relu6(x)
