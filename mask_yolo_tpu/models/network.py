"""The complete Mask-YOLO network as one module.

Wires backbone → {feature-map neck, YOLO head} and exposes the mask branch,
mirroring the graph built by MaskYOLO.build
(/root/reference/myolo/model.py:787-941):

    C4   = backbone(image)                       # [B, 28, 28, 512]
    fmap = Conv3x3(C4) -> TOP_FEATURE_MAP_DEPTH  # neck, model.py:848
    grid = yolo_head(C4)                         # [B, gh, gw, nb, 5+C]
    masks = mask_head(rois, fmap)                # [B, R, 28, 28, C]

Decode / target-assignment / NMS are *not* layers here (the reference made
them Keras layers because Keras requires it); they are pure functions in
ops/ that the pipelines in pipelines.py compose under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import nn
from .mask_head import MaskHead
from .mobilenet import MobileNetBackbone
from .resnet_fpn import ResNetFPNBackbone
from .yolo_head import YoloHead


class MaskYoloNet(nn.Module):
    num_classes: int
    n_box: int
    top_feature_map_depth: int = 256
    mask_pool_size: int = 14
    backbone: str = "mobilenet"
    compute_dtype: str = "float32"
    axis_name: str | None = None
    image_hw: tuple = (224, 224)

    def _dtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32

    def _backbone(self):
        if self.backbone == "mobilenet":
            return MobileNetBackbone(dtype=self._dtype(),
                                     axis_name=self.axis_name, name="backbone")
        if self.backbone == "resnet50_fpn":
            return ResNetFPNBackbone(pyramid_size=self.top_feature_map_depth,
                                     dtype=self._dtype(),
                                     axis_name=self.axis_name, name="backbone")
        raise ValueError(f"unknown backbone {self.backbone!r}")

    def _yolo(self):
        return YoloHead(self.n_box, self.num_classes, dtype=self._dtype(),
                        axis_name=self.axis_name, name="yolo")

    def trunk(self, image, train: bool = False):
        """image [B, H, W, 3] float in [0, 1] → (yolo_grid, mask_feature_map)."""
        c4 = self._backbone()(image, train)
        # neck: reduce depth for the mask branch only (reference model.py:848)
        fmap = nn.Conv(self.top_feature_map_depth, (3, 3), padding="SAME",
                       dtype=self._dtype(), name="feature_map")(c4)
        grid = self._yolo()(c4, train)
        return grid, fmap

    def trunk_pyramid(self, image, train: bool = False):
        """FPN variant of trunk: → (yolo_grid, (P3, P4, P5)). The pyramid
        feeds the mask branch through true multi-level ROIAlign; requires
        backbone='resnet50_fpn'."""
        if self.backbone != "resnet50_fpn":
            raise ValueError("trunk_pyramid requires the resnet50_fpn backbone")
        c4, pyramid = self._backbone()(image, train, return_pyramid=True)
        grid = self._yolo()(c4, train)
        return grid, pyramid

    def mask_branch(self, rois, fmap, train: bool = False):
        """rois [B, R, 4] normalized → [B, R, 28, 28, C] sigmoid masks."""
        return MaskHead(self.num_classes, self.mask_pool_size,
                        dtype=self._dtype(), axis_name=self.axis_name,
                        image_hw=tuple(self.image_hw), name="mask")(
                            rois, fmap, train)

    def pick_trunk(self):
        """The trunk the pipelines should use: FPN backbones feed the mask
        branch from the (P3, P4, P5) pyramid via true multi-level ROIAlign;
        everything else uses the fused single-level map (the reference's
        clamped PyramidROIAlign, model.py:353-354)."""
        return self.trunk_pyramid if self.backbone == "resnet50_fpn" else self.trunk

    def __call__(self, image, rois, train: bool = False):
        """Full forward touching every parameter (used for init)."""
        grid, fmap = self.trunk(image, train)
        masks = self.mask_branch(rois, fmap, train)
        return grid, fmap, masks
