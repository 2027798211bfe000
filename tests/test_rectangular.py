"""Non-square IMAGE_SHAPE end-to-end coverage.

IMAGE_SHAPE is [H, W, 3]; the device decoder normalizes x by GRID_W and y by
GRID_H (ops/boxes.py:54-59). These tests prove the host encoder, the host
post-processing helpers (NMB/unmold) and the device pipelines all share that
convention on a rectangular 64×96 (grid 2×3) operating point — structurally
the same case as 224×320 (grid 7×10) at test-friendly size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mask_yolo_tpu.config import Config
from mask_yolo_tpu.data.encoder import encode_yolo_targets
from mask_yolo_tpu.ops.boxes import decode_yolo_proposals


class RectShapesConfig(Config):
    NAME = "rect64x96"
    LABELS = ["background", "square", "circle", "triangle"]
    NUM_CLASSES = 4
    IMAGE_SHAPE = [64, 96, 3]  # H=64, W=96
    IMAGE_MIN_DIM = 64
    IMAGE_MAX_DIM = 96
    GRID_H, GRID_W = 2, 3
    N_BOX = 2
    ANCHORS = [0.6, 0.7, 1.2, 1.1]
    TRUE_BOX_BUFFER = 4
    MAX_GT_INSTANCES = 4
    TRAIN_ROIS_PER_IMAGE = 2 * 3 * 2
    MASK_POOL_SIZE = 4
    MASK_SHAPE = [8, 8]
    TOP_FEATURE_MAP_DEPTH = 16
    BATCH_SIZE = 2
    TRAIN_BN = True
    DETECTION_MAX_INSTANCES = 4


@pytest.fixture(scope="module")
def rect_cfg():
    return RectShapesConfig()


def _logit(p):
    return np.log(p / (1.0 - p))


def test_encoder_decoder_agree_rectangular(rect_cfg, rng):
    """encode → (invert the YOLO parametrization into a raw grid) → device
    decode must reproduce the original GT boxes in normalized coords.

    This is the exact loop that silently broke on non-square configs when
    the encoder read IMAGE_SHAPE[0] as width: the decoded box came back
    transposed in scale."""
    cfg = rect_cfg
    H, W = cfg.IMAGE_SHAPE[:2]
    anchors = cfg.anchors_wh
    for _ in range(10):
        x1 = rng.randint(0, W - 16)
        y1 = rng.randint(0, H - 16)
        bw = rng.randint(8, W - x1)
        bh = rng.randint(8, H - y1)
        gt = np.zeros((cfg.MAX_GT_INSTANCES, 4), np.float32)
        ids = np.zeros((cfg.MAX_GT_INSTANCES,), np.int32)
        gt[0] = [x1, y1, x1 + bw, y1 + bh]
        ids[0] = 1
        target, _ = encode_yolo_targets(gt, ids, cfg)

        where = np.argwhere(target[..., 4] == 1.0)
        assert len(where) == 1
        gy, gx, a = where[0]
        cx, cy, w, h = target[gy, gx, a, :4]

        # invert the YOLOv2 parametrization into a raw grid
        raw = np.zeros((1, cfg.GRID_H, cfg.GRID_W, cfg.N_BOX,
                        5 + cfg.NUM_CLASSES), np.float32)
        fx = np.clip(cx - gx, 1e-4, 1 - 1e-4)
        fy = np.clip(cy - gy, 1e-4, 1 - 1e-4)
        raw[0, gy, gx, a, 0] = _logit(fx)
        raw[0, gy, gx, a, 1] = _logit(fy)
        raw[0, gy, gx, a, 2] = np.log(w / anchors[a, 0])
        raw[0, gy, gx, a, 3] = np.log(h / anchors[a, 1])

        boxes = np.asarray(decode_yolo_proposals(
            jnp.asarray(raw), anchors, cfg.GRID_H, cfg.GRID_W))
        flat = (gy * cfg.GRID_W + gx) * cfg.N_BOX + a
        got = boxes[0, flat]
        want = np.array([x1 / W, y1 / H, (x1 + bw) / W, (y1 + bh) / H])
        np.testing.assert_allclose(got, want, atol=2e-3)


def test_paste_vs_host_unmold_rectangular(rng):
    """Device paste_masks vs host unmold_mask on a rectangular canvas: both
    must place the mask at the same pixel location (H=64, W=96)."""
    from mask_yolo_tpu.ops.roi_align import paste_masks
    from mask_yolo_tpu.utils.host_ops import unmold_mask

    # smooth soft-disk mask: resampling-convention differences (align-corners
    # device paste vs half-pixel host resize) stay local to the boundary
    yy, xx = np.mgrid[:28, :28]
    mask = (np.hypot(yy - 13.5, xx - 13.5) < 10).astype(np.float32)[None]
    # a box clearly off-center in both axes: x spans right half, y top half
    box = np.array([0.55, 0.10, 0.95, 0.45], np.float32)
    full_dev = np.asarray(
        paste_masks(jnp.asarray(mask), jnp.asarray(box[None]), (64, 96)))[0] >= 0.5
    full_host = unmold_mask(mask[0], box, [64, 96, 3])
    assert full_dev.shape == (64, 96) and full_host.shape == (64, 96)
    inter = np.logical_and(full_dev, full_host).sum()
    union = np.logical_or(full_dev, full_host).sum()
    # small pasted region → boundary pixels dominate; 0.8 still catches any
    # axis swap (a transposed paste on this box scores ~0 IoU)
    assert union > 0 and inter / union > 0.8
    # the occupied region must sit in the right-top quadrant-ish area
    ys, xs = np.nonzero(full_dev)
    assert xs.min() >= int(0.5 * 96) and ys.max() <= int(0.5 * 64)


def test_rectangular_train_and_detect_e2e(rect_cfg, rng):
    """One train step + full detect pipeline on the 64×96 config: finite
    loss, correct output shapes, masks on the rectangular canvas."""
    from mask_yolo_tpu import pipelines
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
    from mask_yolo_tpu.data.shapes import ShapesDataset
    from mask_yolo_tpu.models.network import MaskYoloNet
    from mask_yolo_tpu.train import state as state_lib
    from mask_yolo_tpu.train import trainer as trainer_lib

    cfg = rect_cfg
    H, W = cfg.IMAGE_SHAPE[:2]
    ds = ShapesDataset()
    ds.load_shapes(cfg.BATCH_SIZE, H, W, seed=7)
    ds.prepare()
    data = preload_dataset(ds, cfg)
    gen = BatchGenerator(data, cfg, mode="training", shuffle=False)

    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE,
                      image_hw=(H, W))
    img = jnp.zeros((cfg.BATCH_SIZE, H, W, 3), jnp.float32)
    rois = jnp.zeros((cfg.BATCH_SIZE, cfg.TRAIN_ROIS_PER_IMAGE, 4), jnp.float32)
    variables = net.init(jax.random.PRNGKey(1), img, rois, train=False)

    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables.get("batch_stats", {})), tx)
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()}
    assert batch["image"].shape[1:3] == (H, W)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))

    out = jax.device_get(pipelines.detect_outputs(
        net, {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(batch["image"]), cfg))
    k = cfg.DETECTION_MAX_INSTANCES
    assert out["boxes"].shape == (cfg.BATCH_SIZE, k, 4)
    assert out["masks"].shape == (cfg.BATCH_SIZE, k, H, W)
    # pixel boxes must live in [0, W] × [0, H]
    v = out["valid"]
    if v.any():
        bx = out["boxes"][v]
        assert bx[:, 0].min() >= -W and bx[:, 2].max() <= 2 * W

    iy = jax.device_get(pipelines.infer_yolo_outputs(
        net, {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(batch["image"]), cfg))
    assert iy["boxes"].shape == (cfg.BATCH_SIZE, cfg.grid_boxes, 4)
