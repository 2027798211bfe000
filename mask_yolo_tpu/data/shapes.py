"""Synthetic Shapes dataset — the framework's primary end-to-end fixture.

Rebuilds the reference's ShapesDataset/ShapesConfig
(/root/reference/example/shapes/dataset_shapes.py:14-204): random squares,
circles and triangles on a random background, generated in memory with
pixel-exact GT masks, occlusion handled by painting back-to-front, and
overlapping shapes pruned with NMS@0.3. Unlike the reference (module-level
`random`), generation here is fully deterministic given `seed`, which is what
makes the test-suite goldens possible (SURVEY.md §4).
"""

from __future__ import annotations

import math

import numpy as np

from ..config import Config
from ..utils import image as image_ops
from .dataset import Dataset, non_max_suppression


class ShapesConfig(Config):
    """Training config for the toy Shapes dataset
    (reference: dataset_shapes.py:14-50)."""

    NAME = "shapes"
    LABELS = ["background", "square", "circle", "triangle"]
    BATCH_SIZE = 16
    NUM_CLASSES = 1 + 3
    IMAGE_MIN_DIM = 224
    IMAGE_MAX_DIM = 224
    ANCHORS = [1.27273, 1.277385, 2.47446, 2.56253, 4.03843, 4.07434]
    N_BOX = 3
    TRAIN_ROIS_PER_IMAGE = Config.GRID_H * Config.GRID_W * 3
    # mini-masks: ship 56²-cropped GT masks instead of full 224² canvases —
    # ~16× less host→device transfer on the training path; the
    # device-side target crop handles
    # both representations (ops/target_assign.py)
    USE_MINI_MASK = True
    # mask branch on the 32 best assignment slots during training (≥ 3× the
    # MAX_GT_INSTANCES=10 positives a Shapes image can produce per anchor
    # neighborhood) — ~4.6× less train-step mask compute, loss-identical
    MASK_TRAIN_TOP_ROIS = 32
    # train BN in batch-stats mode: Shapes trains from scratch (no pretrained
    # stats to freeze); the reference's Keras BNs behave this way implicitly
    TRAIN_BN = True


class ShapesDataset(Dataset):
    """Generates the synthetic shapes dataset in memory. No file access.

    reference: dataset_shapes.py:53-180.
    """

    SHAPE_NAMES = ["square", "circle", "triangle"]

    def load_shapes(self, count, height, width, seed: int | None = 0):
        """Generate `count` image specs. Images are rasterized lazily in
        load_image(). Deterministic given `seed`."""
        rng = np.random.RandomState(seed) if seed is not None else np.random
        self.add_class("shapes", 1, "square")
        self.add_class("shapes", 2, "circle")
        self.add_class("shapes", 3, "triangle")
        for i in range(count):
            bg_color, shapes = self.random_image(height, width, rng)
            self.add_image(
                "shapes",
                image_id=i,
                path=None,
                width=width,
                height=height,
                bg_color=bg_color,
                shapes=shapes,
            )

    # -- rasterization -----------------------------------------------------

    def draw_shape(self, image, shape, dims, color):
        """Draw one shape spec onto `image` (reference: dataset_shapes.py:121-135)."""
        x, y, s = dims
        if shape == "square":
            image_ops.fill_rectangle(image, x - s, y - s, x + s, y + s, color)
        elif shape == "circle":
            image_ops.fill_circle(image, x, y, s, color)
        elif shape == "triangle":
            sin60 = math.sin(math.radians(60))
            xs = [x, x - s / sin60, x + s / sin60]
            ys = [y - s, y + s, y + s]
            image_ops.fill_polygon(image, xs, ys, color)
        return image

    def load_image(self, image_id):
        info = self.image_info[image_id]
        bg_color = np.array(info["bg_color"]).reshape([1, 1, 3])
        image = np.ones([info["height"], info["width"], 3], dtype=np.uint8)
        image = image * bg_color.astype(np.uint8)
        for shape, color, dims in info["shapes"]:
            image = self.draw_shape(image, shape, dims, np.array(color, dtype=np.uint8))
        return image

    def image_reference(self, image_id):
        info = self.image_info[image_id]
        if info["source"] == "shapes":
            return info["shapes"]
        return super().image_reference(image_id)

    def load_mask(self, image_id):
        """Instance masks with back-to-front occlusion handling
        (reference: dataset_shapes.py:102-119)."""
        info = self.image_info[image_id]
        shapes = info["shapes"]
        count = len(shapes)
        mask = np.zeros([info["height"], info["width"], count], dtype=np.uint8)
        for i, (shape, _, dims) in enumerate(shapes):
            mask[:, :, i : i + 1] = self.draw_shape(
                mask[:, :, i : i + 1].copy(), shape, dims, 1
            )
        # Occlusion: later shapes occlude earlier ones
        occlusion = np.logical_not(mask[:, :, -1]).astype(np.uint8)
        for i in range(count - 2, -1, -1):
            mask[:, :, i] = mask[:, :, i] * occlusion
            occlusion = np.logical_and(occlusion, np.logical_not(mask[:, :, i]))
        class_ids = np.array(
            [self.class_names.index(s[0]) for s in shapes], dtype=np.int32
        )
        return mask.astype(bool), class_ids

    # -- spec generation ----------------------------------------------------

    def random_shape(self, height, width, rng):
        shape = self.SHAPE_NAMES[rng.randint(0, len(self.SHAPE_NAMES))]
        color = tuple(int(rng.randint(0, 256)) for _ in range(3))
        # reference uses buffer=20 at 224²; scale it so small test images work
        buffer = min(20, height // 8)
        y = int(rng.randint(buffer, height - buffer))
        x = int(rng.randint(buffer, width - buffer))
        s_lo = min(buffer, max(2, height // 12))
        s = int(rng.randint(s_lo, max(height // 4, s_lo) + 1))
        return shape, color, (x, y, s)

    def random_image(self, height, width, rng):
        bg_color = np.array([rng.randint(0, 256) for _ in range(3)])
        shapes = []
        boxes = []
        n = int(rng.randint(1, 5))
        for _ in range(n):
            shape, color, dims = self.random_shape(height, width, rng)
            shapes.append((shape, color, dims))
            x, y, s = dims
            boxes.append([x - s, y - s, x + s, y + s])
        # prune heavily overlapping GT shapes (reference: dataset_shapes.py:178)
        keep_ixs = non_max_suppression(np.array(boxes), np.arange(n), 0.3)
        shapes = [s for i, s in enumerate(shapes) if i in keep_ixs]
        return bg_color, shapes
