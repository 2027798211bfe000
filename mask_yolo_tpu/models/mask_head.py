"""Mask branch: ROIAlign → conv stack → deconv → per-class sigmoid masks.

Rebuilds build_mask_graph (/root/reference/myolo/model.py:668-715). The
reference wraps every layer in TimeDistributed to map over the ROI axis; here
the (batch, roi) axes are folded into one leading dim, which turns 245 tiny
conv calls into one large batched conv.

ROIAlign itself is the separable-matmul crop from ops/roi_align.py (the
reference's PyramidROIAlign / tf.image.crop_and_resize, model.py:299-413).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import nn
from ..ops.roi_align import crop_and_resize, multilevel_crop_and_resize


class MaskHead(nn.Module):
    num_classes: int
    pool_size: int = 14
    conv_features: int = 256
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None
    # pixel size of the network input — used only by the FPN multi-level
    # path to convert normalized ROI extents to pixels for level assignment
    image_hw: tuple = (224, 224)

    def __call__(self, rois, feature_map, train: bool = False):
        """rois: [B, R, 4] normalized (x1,y1,x2,y2); feature_map: [B, h, w, C]
        — or a tuple of FPN pyramid maps (fine→coarse), in which case each
        ROI is pooled from its FPN-assigned level (true multi-level
        ROIAlign, the path the reference clamps at model.py:350-354).

        Returns [B, R, 2*pool, 2*pool, num_classes] sigmoid masks
        (28x28 for pool_size=14, matching MASK_SHAPE).
        """
        b, r = rois.shape[:2]
        if isinstance(feature_map, (tuple, list)):
            # (P3, P4, P5) fine→coarse; canonical_level=1 is FPN's k0=4 (=P4)
            x = multilevel_crop_and_resize(
                tuple(feature_map), rois, (self.pool_size, self.pool_size),
                image_hw=tuple(self.image_hw), canonical_level=1)
            x = x.astype(self.dtype)
        else:
            x = crop_and_resize(feature_map, rois,
                                (self.pool_size, self.pool_size),
                                dtype=self.dtype)
        x = x.reshape(b * r, self.pool_size, self.pool_size, x.shape[-1])

        for i in range(1, 5):  # four 3x3 conv+BN+relu (model.py:688-709)
            x = nn.Conv(self.conv_features, (3, 3), padding="SAME",
                        dtype=self.dtype, param_dtype=jnp.float32,
                        name=f"mask_conv{i}")(x)
            x = nn.BatchNorm(use_running_average=not train, momentum=0.99,
                             # BN in f32: bf16 batch stats corrupt the
                             # running averages
                             epsilon=1e-3, dtype=jnp.float32,
                             param_dtype=jnp.float32,
                             axis_name=self.axis_name if train else None,
                             name=f"mask_bn{i}")(x)
            x = nn.relu(x)

        # 2x2/s2 transposed conv (model.py:711)
        x = nn.ConvTranspose(self.conv_features, (2, 2), strides=(2, 2),
                             dtype=self.dtype, param_dtype=jnp.float32,
                             name="mask_deconv")(x)
        x = nn.relu(x)

        # 1x1 conv to per-class masks with sigmoid (model.py:713)
        x = nn.Conv(self.num_classes, (1, 1), dtype=self.dtype,
                    param_dtype=jnp.float32, name="mask_out")(x)
        x = nn.sigmoid(x.astype(jnp.float32))
        side = 2 * self.pool_size
        return x.reshape(b, r, side, side, self.num_classes)
