"""Tests for the seeded mask-safe augmentation pipeline (data/augment.py)
and the seeded flip in load_image_gt — the augmentation-parity surface of the
reference's imgaug integration (/root/reference/myolo/myolo_utils.py:306-343).
"""

import numpy as np
import pytest

from mask_yolo_tpu.data import augment
from mask_yolo_tpu.data.shapes import ShapesConfig, ShapesDataset


def _sample(seed=3):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
    mask = np.zeros((32, 32, 2), bool)
    mask[4:12, 6:18, 0] = True
    mask[20:30, 2:10, 1] = True
    return image, mask


def test_fliplr_applies_to_both():
    image, mask = _sample()
    op = augment.Fliplr(p=1.0)
    img2, msk2 = op(image, mask, np.random.RandomState(0))
    np.testing.assert_array_equal(img2, np.fliplr(image))
    np.testing.assert_array_equal(msk2, np.fliplr(mask))


def test_rot90_geometric_consistency():
    image, mask = _sample()
    op = augment.Rot90(ks=(1,))
    img2, msk2 = op(image, mask, np.random.RandomState(0))
    np.testing.assert_array_equal(img2, np.rot90(image, 1, axes=(0, 1)))
    np.testing.assert_array_equal(msk2, np.rot90(mask, 1, axes=(0, 1)))


def test_rot90_nonsquare_restricted_to_half_turns():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (16, 32, 3), dtype=np.uint8)
    mask = np.zeros((16, 32, 1), bool)
    op = augment.Rot90(ks=(1, 3))  # only odd ks requested → falls back to 0
    img2, msk2 = op(image, mask, np.random.RandomState(0))
    assert img2.shape == image.shape and msk2.shape == mask.shape


def test_scale_keeps_shape_and_dtype():
    image, mask = _sample()
    for s in (0.8, 1.25):
        op = augment.Scale((s, s))
        img2, msk2 = op(image, mask, np.random.RandomState(0))
        assert img2.shape == image.shape and img2.dtype == np.uint8
        assert msk2.shape == mask.shape and msk2.dtype == bool
        # mask survives (the object is central enough not to crop away)
        assert msk2.any()


def test_photometric_ops_leave_mask_alone():
    image, mask = _sample()
    for op in (augment.Brightness((0.5, 0.5)), augment.Contrast((1.5, 1.5))):
        img2, msk2 = op(image, mask, np.random.RandomState(0))
        np.testing.assert_array_equal(msk2, mask)
        assert not np.array_equal(img2, image)
        assert img2.dtype == np.uint8


def test_sequential_seeded_reproducible_and_resampling():
    image, mask = _sample()
    a = augment.default_augmenter(seed=11)
    b = augment.default_augmenter(seed=11)
    # same seed → identical stream call by call
    for _ in range(3):
        ia, ma = a(image, mask)
        ib, mb = b(image, mask)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)
    # fresh resampling between calls: over 8 draws at least two distinct
    # outputs (flip/rot90 alone give 8 geometric variants)
    outs = {a(image, mask)[0].tobytes() for _ in range(8)}
    assert len(outs) >= 2


def test_affects_mask_flag():
    assert augment.Fliplr().affects_mask
    assert augment.Scale().affects_mask
    assert not augment.Brightness().affects_mask
    assert augment.Sequential([augment.Brightness()]).affects_mask is False
    assert augment.Sequential(
        [augment.Brightness(), augment.Fliplr()]).affects_mask is True


def test_load_image_gt_flip_is_seeded():
    from mask_yolo_tpu.data.loader import load_image_gt

    class SmallConfig(ShapesConfig):
        IMAGE_SHAPE = [64, 64, 3]
        IMAGE_MIN_DIM = 64
        IMAGE_MAX_DIM = 64
        GRID_H, GRID_W = 2, 2

    cfg = SmallConfig()
    ds = ShapesDataset()
    ds.load_shapes(4, 64, 64, seed=0)
    ds.prepare()

    a = [load_image_gt(ds, cfg, i, augment=True,
                       rng=np.random.RandomState(9)) for i in range(4)]
    b = [load_image_gt(ds, cfg, i, augment=True,
                       rng=np.random.RandomState(9)) for i in range(4)]
    for (ia, ca, ba, ma), (ib, cb, bb, mb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ba, bb)
        np.testing.assert_array_equal(ma, mb)


def test_augmented_gt_boxes_match_masks():
    """Boxes are re-extracted AFTER augmentation, so they must tightly bound
    the augmented masks."""
    from mask_yolo_tpu.data.loader import extract_bboxes, load_image_gt

    class SmallConfig(ShapesConfig):
        IMAGE_SHAPE = [64, 64, 3]
        IMAGE_MIN_DIM = 64
        IMAGE_MAX_DIM = 64
        GRID_H, GRID_W = 2, 2

    cfg = SmallConfig()
    ds = ShapesDataset()
    ds.load_shapes(6, 64, 64, seed=1)
    ds.prepare()
    aug = augment.default_augmenter(seed=2)
    for i in range(6):
        _, cids, boxes, masks = load_image_gt(ds, cfg, i, augmentation=aug,
                                              use_mini_mask=False)
        np.testing.assert_array_equal(boxes, extract_bboxes(masks))
        assert cids.shape[0] == masks.shape[-1]


def test_batchgen_norm_false_debug_mode():
    """BatchGenerator(norm=False) emits 0..255 images with GT boxes drawn
    (reference myolo_utils.py:826-840)."""
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset

    class SmallConfig(ShapesConfig):
        IMAGE_SHAPE = [64, 64, 3]
        IMAGE_MIN_DIM = 64
        IMAGE_MAX_DIM = 64
        GRID_H, GRID_W = 2, 2
        BATCH_SIZE = 4

    cfg = SmallConfig()
    ds = ShapesDataset()
    ds.load_shapes(4, 64, 64, seed=2)
    ds.prepare()
    data = preload_dataset(ds, cfg)
    normed = BatchGenerator(data, cfg, mode="training", shuffle=False)[0]
    debug = BatchGenerator(data, cfg, mode="training", shuffle=False,
                           norm=False)[0]
    assert debug["image"].max() > 1.5          # 0..255 scale
    # identical except where boxes were painted
    diff = np.abs(debug["image"]
                  - normed["image"].astype(np.float32)).max(axis=-1) > 0.5
    assert diff.any()                           # boxes drawn
    assert diff.mean() < 0.5                    # ...but most pixels untouched
    # targets are unaffected by the debug overlay
    np.testing.assert_array_equal(debug["yolo_target"], normed["yolo_target"])


def test_data_generator_norm_false():
    from mask_yolo_tpu.data.pipeline import data_generator

    class SmallConfig(ShapesConfig):
        IMAGE_SHAPE = [64, 64, 3]
        IMAGE_MIN_DIM = 64
        IMAGE_MAX_DIM = 64
        GRID_H, GRID_W = 2, 2
        BATCH_SIZE = 2

    cfg = SmallConfig()
    ds = ShapesDataset()
    ds.load_shapes(4, 64, 64, seed=2)
    ds.prepare()
    batch = next(data_generator(ds, cfg, shuffle=False, norm=False))
    assert batch["image"].max() > 1.5


class _FakeImgaugFliplr:
    """Duck-typed imgaug stand-in (imgaug is not installed in CI): always
    flips horizontally, freezes per-image via to_deterministic like
    imgaug.augmenters.Fliplr(1.0)."""

    def __init__(self):
        self.deterministic_calls = 0

    def to_deterministic(self):
        self.deterministic_calls += 1
        return self

    def augment_image(self, image, hooks=None):
        return np.fliplr(image).copy()


def test_imgaug_adapter_duck_types(rng):
    """An imgaug-style augmenter (duck-typed on
    augment_image/to_deterministic) plugs into the augmentation slot and is
    applied to image AND mask (reference myolo_utils.py:306-343)."""
    from mask_yolo_tpu.data.augment import ImgaugAdapter, as_augmenter

    fake = _FakeImgaugFliplr()
    aug = as_augmenter(fake)
    assert isinstance(aug, ImgaugAdapter)

    image = (rng.rand(16, 24, 3) * 255).astype(np.uint8)
    mask = np.zeros((16, 24, 2), dtype=bool)
    mask[2:6, 3:9, 0] = True
    mask[8:12, 15:20, 1] = True
    out_img, out_mask = aug(image, mask)
    assert fake.deterministic_calls == 1
    np.testing.assert_array_equal(out_img, np.fliplr(image))
    np.testing.assert_array_equal(out_mask, np.fliplr(mask))
    assert out_mask.dtype == bool


def test_imgaug_adapter_duck_type_with_imgaug_importable(rng):
    """Regression: hooks= must be gated on the AUGMENTER being a real
    imgaug object, not on `import imgaug` succeeding — a duck-typed
    augmenter whose augment_image takes no hooks kwarg must still work
    when an imgaug module is importable."""
    import sys

    import mask_yolo_tpu.data.augment as aug_mod

    class _NoHooksAug:
        def augment_image(self, image):  # NO hooks kwarg
            return image[:, ::-1]

    class _FakeImgaugModule:
        class HooksImages:  # would be passed as hooks= if the gate is wrong
            def __init__(self, activator=None):
                self.activator = activator

    sys.modules["imgaug"] = _FakeImgaugModule()
    try:
        adapter = aug_mod.ImgaugAdapter(_NoHooksAug())
        image = (rng.rand(8, 12, 3) * 255).astype(np.uint8)
        mask = np.zeros((8, 12, 1), dtype=bool)
        mask[2:5, 3:7, 0] = True
        out_img, out_mask = adapter(image, mask)
        np.testing.assert_array_equal(out_img, np.fliplr(image))
        np.testing.assert_array_equal(out_mask, np.fliplr(mask))
    finally:
        del sys.modules["imgaug"]


def test_imgaug_adapter_rejects_shape_changes():
    from mask_yolo_tpu.data.augment import ImgaugAdapter

    class BadCrop:
        def augment_image(self, image, hooks=None):
            return image[:-2]

    with pytest.raises(ValueError, match="changed the image/mask shape"):
        ImgaugAdapter(BadCrop())(np.zeros((8, 8, 3), np.uint8),
                                 np.zeros((8, 8, 1), bool))


def test_as_augmenter_passthrough_and_rejection():
    from mask_yolo_tpu.data import augment

    seq = augment.default_augmenter(seed=3)
    assert augment.as_augmenter(seq) is seq
    assert augment.as_augmenter(None) is None
    fn = lambda image, mask: (image, mask)
    assert augment.as_augmenter(fn) is fn
    with pytest.raises(TypeError, match="augment_image"):
        augment.as_augmenter(object())
    with pytest.raises(TypeError, match="augment_image"):
        augment.ImgaugAdapter(object())


def test_load_image_gt_accepts_imgaug_style(rng):
    """End-to-end: train(augmentation=<imgaug aug>) path — load_image_gt
    wraps duck-typed imgaug augmenters automatically; GT boxes follow the
    flipped masks."""
    from mask_yolo_tpu.data.loader import load_image_gt
    from mask_yolo_tpu.data.shapes import ShapesConfig, ShapesDataset

    class Cfg(ShapesConfig):
        USE_MINI_MASK = False

    cfg = Cfg()
    ds = ShapesDataset()
    ds.load_shapes(4, *cfg.IMAGE_SHAPE[:2], seed=11)
    ds.prepare()

    img_a, ids_a, box_a, mask_a = load_image_gt(
        ds, cfg, ds.image_ids[0], augmentation=None)
    img_b, ids_b, box_b, mask_b = load_image_gt(
        ds, cfg, ds.image_ids[0], augmentation=_FakeImgaugFliplr())
    np.testing.assert_array_equal(img_b, np.fliplr(img_a))
    np.testing.assert_array_equal(ids_b, ids_a)
    np.testing.assert_array_equal(mask_b, np.fliplr(mask_a))
    w = cfg.IMAGE_SHAPE[1]
    # x1' = W - x2, x2' = W - x1 under a horizontal flip
    np.testing.assert_array_equal(box_b[:, 0], w - box_a[:, 2])
    np.testing.assert_array_equal(box_b[:, 2], w - box_a[:, 0])
