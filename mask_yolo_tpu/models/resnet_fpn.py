"""ResNet-50 + FPN backbone — the reference README's stated scale-up path
(/root/reference/README.md:5; config hooks at config.py:74-84, BASELINE.json
configs[3]).

Standard bottleneck ResNet-50 producing C2..C5, with a top-down FPN that
fuses them into a stride-8 P3 map projected to 512 channels — the same
output contract as the MobileNet backbone (28x28x512 at 224²), so every
downstream component (neck, YOLO head, mask branch) is backbone-agnostic.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import nn


class Bottleneck(nn.Module):
    features: int
    strides: tuple = (1, 1)
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None

    def __call__(self, x, train: bool = False):
        dt = self.dtype

        def bn(name):
            # BN in f32: bf16 batch stats corrupt the running averages
            return nn.BatchNorm(use_running_average=not train, momentum=0.99,
                                epsilon=1e-3, dtype=jnp.float32,
                                param_dtype=jnp.float32,
                                axis_name=self.axis_name if train else None,
                                name=name)

        residual = x
        y = nn.Conv(self.features, (1, 1), strides=self.strides, use_bias=False,
                    dtype=dt, param_dtype=jnp.float32, name="conv1")(x)
        y = nn.relu(bn("bn1")(y))
        y = nn.Conv(self.features, (3, 3), padding="SAME", use_bias=False,
                    dtype=dt, param_dtype=jnp.float32, name="conv2")(y)
        y = nn.relu(bn("bn2")(y))
        y = nn.Conv(self.features * 4, (1, 1), use_bias=False,
                    dtype=dt, param_dtype=jnp.float32, name="conv3")(y)
        y = bn("bn3")(y)
        if residual.shape != y.shape:
            residual = nn.Conv(self.features * 4, (1, 1), strides=self.strides,
                               use_bias=False, dtype=dt, param_dtype=jnp.float32,
                               name="proj")(x)
            residual = bn("proj_bn")(residual)
        return nn.relu(y + residual)


class ResNetFPNBackbone(nn.Module):
    """ResNet-50 stages + FPN; returns a stride-8 fused map with 512 channels."""

    pyramid_size: int = 256
    out_features: int = 512
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None

    def __call__(self, x, train: bool = False, return_pyramid: bool = False):
        """return_pyramid: also return the (P3, P4, P5) maps (stride 8/16/32,
        `pyramid_size` channels each) for true multi-level ROIAlign
        (ops/roi_align.multilevel_crop_and_resize)."""
        dt = self.dtype
        blocks = {"c2": (3, 64), "c3": (4, 128), "c4": (6, 256), "c5": (3, 512)}

        # stem: 7x7/s2 + maxpool/s2 -> stride 4
        x = nn.Conv(64, (7, 7), strides=(2, 2), padding="SAME", use_bias=False,
                    dtype=dt, param_dtype=jnp.float32, name="stem_conv")(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.99,
                         epsilon=1e-3, dtype=jnp.float32,
                         param_dtype=jnp.float32,
                         axis_name=self.axis_name if train else None,
                         name="stem_bn")(x)
        x = nn.relu(x)
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")

        feats = {}
        for stage, (n, width) in blocks.items():
            for i in range(n):
                strides = (2, 2) if (i == 0 and stage != "c2") else (1, 1)
                x = Bottleneck(width, strides, dt, self.axis_name,
                               name=f"{stage}_block{i}")(x, train)
            feats[stage] = x

        # FPN top-down: lateral 1x1 + nearest upsample + add, down to P3 (stride 8)
        def lateral(name, f):
            return nn.Conv(self.pyramid_size, (1, 1), dtype=dt,
                           param_dtype=jnp.float32, name=name)(f)

        p5 = lateral("lat5", feats["c5"])
        p4 = lateral("lat4", feats["c4"]) + _upsample2x(p5)
        p3 = lateral("lat3", feats["c3"]) + _upsample2x(p4)
        p3 = nn.Conv(self.pyramid_size, (3, 3), padding="SAME", dtype=dt,
                     param_dtype=jnp.float32, name="smooth3")(p3)

        # project to the backbone output contract (512ch at stride 8)
        out = nn.Conv(self.out_features, (1, 1), dtype=dt, param_dtype=jnp.float32,
                      name="out_proj")(p3)
        out = nn.relu(out)
        if return_pyramid:
            return out, (p3, p4, p5)
        return out


def _upsample2x(x):
    """Nearest-neighbour 2x upsample — a reshape/broadcast XLA fuses into
    the consumer."""
    b, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (b, h, 2, w, 2, c))
    return x.reshape(b, h * 2, w * 2, c)
