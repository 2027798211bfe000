"""YOLO detection branch.

Rebuilds yolo_branch_graph (/root/reference/myolo/model.py:249-278): eight
more depthwise-separable blocks taking the stride-8 feature map down to the
stride-32 grid (512 @ /16 ×5, 1024/s2, 1024), then a 1x1 conv to
N_BOX*(5+NUM_CLASSES) channels reshaped to [B, gh, gw, nb, 5+C].

Kept as its own module (the reference wraps it in a sub-Model,
build_yolo_model model.py:281-292) so pretrained-YOLO weights can be loaded
and optionally frozen as a named parameter subtree.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import nn
from .layers import DepthwiseSeparable


class YoloHead(nn.Module):
    n_box: int
    num_classes: int
    alpha: float = 1.0
    depth_multiplier: int = 1
    dtype: jnp.dtype = jnp.float32
    axis_name: str | None = None

    def __call__(self, x, train: bool = False):
        a, dm, dt = self.alpha, self.depth_multiplier, self.dtype
        # 28x28x512 -> 14x14x512 (reference block_id=7, model.py:256)
        x = DepthwiseSeparable(512, (2, 2), a, dm, dt, self.axis_name, name="block7")(x, train)
        for i in range(8, 13):  # blocks 8-12 at 14x14 (model.py:259-263)
            x = DepthwiseSeparable(512, (1, 1), a, dm, dt, self.axis_name,
                                   name=f"block{i}")(x, train)
        # 14 -> 7 (model.py:265)
        x = DepthwiseSeparable(1024, (2, 2), a, dm, dt, self.axis_name, name="block13")(x, train)
        x = DepthwiseSeparable(1024, (1, 1), a, dm, dt, self.axis_name, name="block14")(x, train)

        # 1x1 prediction conv (reference conv_23, model.py:271)
        x = nn.Conv(
            self.n_box * (5 + self.num_classes),
            (1, 1),
            padding="SAME",
            use_bias=True,
            dtype=dt,
            param_dtype=jnp.float32,
            name="conv_23",
        )(x)
        b, gh, gw, _ = x.shape
        # raw grid stays in float32 for the loss/decode math
        return x.reshape(b, gh, gw, self.n_box, 5 + self.num_classes).astype(jnp.float32)
