"""Cross-framework parity vs real TensorFlow/Keras.

Until round 2, output parity was asserted only against NumPy oracles written
by the same author as the implementation — a shared misreading of the
reference would pass silently. These tests close that loop against the
ACTUAL frameworks the reference runs on:

  * ops/roi_align.crop_and_resize       vs tf.image.crop_and_resize
    (the op PyramidROIAlign wraps, /root/reference/myolo/model.py:299-413)
  * trunk + mask forward                vs a layer-for-layer tf.keras rebuild
    of the reference graph (model.py:55-79, 249-292, 668-715, 848), fed by
    weights exported through utils/keras_h5.save_keras_h5
  * ops/boxes.decode_detections         vs a TF port of DetectionsLayer
    (model.py:1479-1541)
  * losses.yolo_loss / losses.mask_loss vs TF ports of yolo_custom_loss
    (model.py:86-242) and myolo_mask_loss_graph (model.py:718-754), incl.
    Keras binary_crossentropy's epsilon clipping

Skipped cleanly when tensorflow is not installed.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

keras = tf.keras


# ---------------------------------------------------------------------------
# 1. crop_and_resize vs tf.image.crop_and_resize
# ---------------------------------------------------------------------------


def test_crop_and_resize_matches_tf(rng):
    """Separable-matmul crop == tf.image.crop_and_resize (bilinear,
    extrapolation_value=0), including boxes spanning outside the canvas."""
    from mask_yolo_tpu.ops.roi_align import crop_and_resize

    b, h, w, c = 2, 17, 23, 3
    feat = rng.rand(b, h, w, c).astype(np.float32)
    boxes = []
    for _ in range(6):
        x1, y1 = rng.uniform(-0.3, 0.7, 2)
        boxes.append([x1, y1, x1 + rng.uniform(0.05, 0.7),
                      y1 + rng.uniform(0.05, 0.7)])
    boxes.append([-0.2, -0.2, 1.3, 1.2])   # spans past every edge
    boxes.append([0.9, 0.9, 1.4, 1.3])     # mostly outside
    boxes = np.asarray(boxes, np.float32)
    boxes_b = np.broadcast_to(boxes, (b, len(boxes), 4))

    for ph, pw in [(14, 14), (7, 7), (1, 5)]:
        ours = np.asarray(crop_and_resize(jnp.asarray(feat),
                                          jnp.asarray(boxes_b), (ph, pw)))
        # TF takes (y1, x1, y2, x2) and a flat box list with batch indices
        tf_boxes = boxes_b[..., [1, 0, 3, 2]].reshape(-1, 4)
        box_ind = np.repeat(np.arange(b), len(boxes)).astype(np.int32)
        theirs = tf.image.crop_and_resize(
            feat, tf_boxes, box_ind, (ph, pw),
            method="bilinear", extrapolation_value=0.0).numpy()
        np.testing.assert_allclose(
            ours.reshape(-1, ph, pw, c), theirs, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# 2. trunk + mask forward parity via save_keras_h5 weights
# ---------------------------------------------------------------------------


def _relu6(name):
    return keras.layers.ReLU(max_value=6.0, name=name)


def _dw_block(x, filters, block_id, strides=(1, 1)):
    """keras_applications _depthwise_conv_block (reference model.py:19,
    imported and used at model.py:55-79, 249-268): 3x3 depthwise + BN +
    relu6, then 1x1 pointwise + BN + relu6, all SAME padding."""
    x = keras.layers.DepthwiseConv2D(
        3, strides=strides, padding="same", use_bias=False,
        name=f"conv_dw_{block_id}")(x)
    x = keras.layers.BatchNormalization(
        epsilon=1e-3, momentum=0.99, name=f"conv_dw_{block_id}_bn")(x)
    x = _relu6(f"conv_dw_{block_id}_relu")(x)
    x = keras.layers.Conv2D(
        filters, 1, padding="same", use_bias=False,
        name=f"conv_pw_{block_id}")(x)
    x = keras.layers.BatchNormalization(
        epsilon=1e-3, momentum=0.99, name=f"conv_pw_{block_id}_bn")(x)
    return _relu6(f"conv_pw_{block_id}_relu")(x)


def _build_tf_trunk(image_shape, n_box, num_classes, fmap_depth):
    """tf.keras rebuild of the reference trunk: mobilenet_graph
    (model.py:55-79) + feature_map neck (model.py:848) + yolo branch
    (model.py:249-292, conv_23 at 271)."""
    inp = keras.Input(shape=tuple(image_shape))
    x = keras.layers.Conv2D(32, 3, strides=2, padding="same", use_bias=False,
                            name="conv1")(inp)
    x = keras.layers.BatchNormalization(epsilon=1e-3, momentum=0.99,
                                        name="conv1_bn")(x)
    x = _relu6("conv1_relu")(x)
    x = _dw_block(x, 64, 1)
    x = _dw_block(x, 64, 2, strides=(2, 2))
    x = _dw_block(x, 128, 3)
    x = _dw_block(x, 256, 4, strides=(2, 2))
    x = _dw_block(x, 256, 5)
    c4 = _dw_block(x, 512, 6)  # the reference's "added by me" block

    fmap = keras.layers.Conv2D(fmap_depth, 3, padding="same",
                               name="feature_map")(c4)

    y = _dw_block(c4, 512, 7, strides=(2, 2))
    for i in range(8, 13):
        y = _dw_block(y, 512, i)
    y = _dw_block(y, 1024, 13, strides=(2, 2))
    y = _dw_block(y, 1024, 14)
    grid_raw = keras.layers.Conv2D(n_box * (5 + num_classes), 1,
                                   padding="same", name="conv_23")(y)
    return keras.Model(inp, [grid_raw, fmap])


def _build_tf_mask_head(pool, depth, num_classes):
    """tf.keras rebuild of build_mask_graph's conv stack (model.py:668-715),
    minus the ROIAlign front end (fed pre-pooled features)."""
    inp = keras.Input(shape=(pool, pool, depth))
    x = inp
    for i in range(1, 5):
        x = keras.layers.Conv2D(256, 3, padding="same",
                                name=f"myolo_mask_conv{i}")(x)
        x = keras.layers.BatchNormalization(epsilon=1e-3, momentum=0.99,
                                            name=f"myolo_mask_bn{i}")(x)
        x = keras.layers.ReLU(name=f"myolo_mask_relu{i}")(x)
    x = keras.layers.Conv2DTranspose(256, 2, strides=2, activation="relu",
                                     name="myolo_mask_deconv")(x)
    x = keras.layers.Conv2D(num_classes, 1, activation="sigmoid",
                            name="myolo_mask")(x)
    return keras.Model(inp, x)


def _load_h5_into_tf(model, path):
    """Assign weights from a save_keras_h5 file into a tf.keras model by
    layer name (the Keras-2 by_name contract)."""
    import h5py

    have = {l.name for l in model.layers}
    loaded = []
    with h5py.File(path, "r") as f:
        for name in [n.decode() for n in f.attrs["layer_names"]]:
            if name not in have:
                continue
            g = f[name]
            arrays = [np.asarray(g[n.decode()])
                      for n in g.attrs["weight_names"]]
            model.get_layer(name).set_weights(arrays)
            loaded.append(name)
    return loaded


@pytest.fixture(scope="module")
def parity_model(tmp_path_factory):
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 2
        COMPUTE_DTYPE = "float32"

    cfg = Cfg()
    m = MaskYOLO(mode="inference", config=cfg, seed=3)
    return m, cfg


def test_trunk_forward_parity_vs_tf_keras(parity_model, tmp_path, rng):
    """Trunk == tf.keras reference-graph rebuild loaded from
    save_keras_h5 weights: raw grid and neck feature map to ~1e-4."""
    from mask_yolo_tpu.utils import keras_h5

    m, cfg = parity_model
    path = str(tmp_path / "w.h5")
    keras_h5.save_keras_h5(path, jax.device_get(m.params),
                           jax.device_get(m.batch_stats))

    tfm = _build_tf_trunk(cfg.IMAGE_SHAPE, cfg.N_BOX, cfg.NUM_CLASSES,
                          cfg.TOP_FEATURE_MAP_DEPTH)
    loaded = _load_h5_into_tf(tfm, path)
    assert "conv_23" in loaded and "conv1" in loaded and "feature_map" in loaded

    images = rng.rand(2, *cfg.IMAGE_SHAPE).astype(np.float32)
    grid_j, fmap_j = m.net.apply(m.variables, jnp.asarray(images),
                                 train=False, method=m.net.trunk)
    grid_t, fmap_t = tfm(images, training=False)
    grid_t = grid_t.numpy().reshape(grid_j.shape)
    np.testing.assert_allclose(np.asarray(grid_j), grid_t,
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(fmap_j), fmap_t.numpy(),
                               atol=2e-4, rtol=1e-3)


def test_mask_branch_parity_vs_tf_keras(parity_model, tmp_path, rng):
    """Mask branch (incl. on-device ROIAlign) == tf.image.crop_and_resize
    + tf.keras mask-head rebuild, weights via save_keras_h5 — the full
    build_mask_graph path (model.py:668-715 with PyramidROIAlign 299-413)."""
    from mask_yolo_tpu.utils import keras_h5

    m, cfg = parity_model
    path = str(tmp_path / "w.h5")
    keras_h5.save_keras_h5(path, jax.device_get(m.params),
                           jax.device_get(m.batch_stats))

    tf_mask = _build_tf_mask_head(cfg.MASK_POOL_SIZE,
                                  cfg.TOP_FEATURE_MAP_DEPTH, cfg.NUM_CLASSES)
    loaded = _load_h5_into_tf(tf_mask, path)
    assert "myolo_mask" in loaded and "myolo_mask_deconv" in loaded

    b, r = 2, 5
    images = rng.rand(b, *cfg.IMAGE_SHAPE).astype(np.float32)
    lo = rng.uniform(0.0, 0.6, size=(b, r, 2)).astype(np.float32)
    span = rng.uniform(0.1, 0.4, size=(b, r, 2)).astype(np.float32)
    rois = np.concatenate([lo, lo + span], axis=-1)  # (x1, y1, x2, y2)

    _, fmap_j = m.net.apply(m.variables, jnp.asarray(images),
                            train=False, method=m.net.trunk)
    masks_j = np.asarray(m.net.apply(m.variables, jnp.asarray(rois), fmap_j,
                                     train=False, method=m.net.mask_branch))

    pool = cfg.MASK_POOL_SIZE
    tf_boxes = rois[..., [1, 0, 3, 2]].reshape(-1, 4)
    box_ind = np.repeat(np.arange(b), r).astype(np.int32)
    pooled = tf.image.crop_and_resize(np.asarray(fmap_j), tf_boxes, box_ind,
                                      (pool, pool), extrapolation_value=0.0)
    masks_t = tf_mask(pooled, training=False).numpy()
    masks_t = masks_t.reshape(masks_j.shape)
    np.testing.assert_allclose(masks_j, masks_t, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# 3. decode parity vs a TF port of DetectionsLayer
# ---------------------------------------------------------------------------


def _tf_detections_layer(grid, anchors_wh, grid_h, grid_w):
    """TF port of DetectionsLayer (model.py:1479-1541): sigmoid(txy)+cell,
    exp(twh)*anchor, /GRID, conf=sigmoid, class=argmax. Square grids only
    (the reference normalizes both axes by GRID_W at model.py:1454,1459 —
    identical to our per-axis normalization when GRID_H == GRID_W)."""
    assert grid_h == grid_w
    b = grid.shape[0]
    nb = anchors_wh.shape[0]
    cols = tf.tile(tf.reshape(tf.range(grid_w, dtype=tf.float32),
                              (1, 1, grid_w, 1)), (1, grid_h, 1, 1))
    rows = tf.tile(tf.reshape(tf.range(grid_h, dtype=tf.float32),
                              (1, grid_h, 1, 1)), (1, 1, grid_w, 1))
    cell = tf.stack([cols, rows], axis=-1)  # [1, gh, gw, 1, 2]
    xy = (tf.sigmoid(grid[..., 0:2]) + cell) / float(grid_w)
    wh = tf.exp(grid[..., 2:4]) * anchors_wh[None, None, None] / float(grid_w)
    mins = xy - wh / 2.0
    maxs = xy + wh / 2.0
    conf = tf.sigmoid(grid[..., 4:5])
    cls = tf.cast(tf.argmax(grid[..., 5:], axis=-1), tf.float32)[..., None]
    det = tf.concat([mins, maxs, conf, cls], axis=-1)
    return tf.reshape(det, (b, grid_h * grid_w * nb, 6))


def test_decode_detections_matches_tf_port(rng):
    from mask_yolo_tpu.ops.boxes import decode_detections

    gh = gw = 7
    nb, nc = 5, 4
    anchors = rng.uniform(0.5, 4.0, size=(nb, 2)).astype(np.float32)
    grid = rng.uniform(-3, 3, size=(2, gh, gw, nb, 5 + nc)).astype(np.float32)

    ours = np.asarray(decode_detections(jnp.asarray(grid), anchors, gh, gw))
    theirs = _tf_detections_layer(tf.constant(grid), tf.constant(anchors),
                                  gh, gw).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# 4. loss-value parity vs TF ports of the reference losses
# ---------------------------------------------------------------------------


def _tf_yolo_loss(y_true, y_pred, true_boxes, config, seen):
    """TF port of yolo_custom_loss (model.py:86-242): masked MSE on xy/wh of
    responsible anchors, IoU-weighted confidence MSE with the 0.6-IoU
    no-object suppression against the true-box buffer, per-cell softmax CE,
    and the warm-up phase (seen < WARM_UP_BATCHES)."""
    gh, gw = config.GRID_H, config.GRID_W
    anchors = tf.constant(config.anchors_wh)[None, None, None]
    cols = tf.tile(tf.reshape(tf.range(gw, dtype=tf.float32),
                              (1, 1, gw, 1)), (1, gh, 1, 1))
    rows = tf.tile(tf.reshape(tf.range(gh, dtype=tf.float32),
                              (1, gh, 1, 1)), (1, 1, gw, 1))
    cell = tf.stack([cols, rows], axis=-1)

    pred_xy = tf.sigmoid(y_pred[..., 0:2]) + cell
    pred_wh = tf.exp(y_pred[..., 2:4]) * anchors
    pred_conf = tf.sigmoid(y_pred[..., 4])
    pred_class = y_pred[..., 5:]

    true_xy = y_true[..., 0:2]
    true_wh = y_true[..., 2:4]

    def iou(xy1, wh1, xy2, wh2):
        mins1, maxs1 = xy1 - wh1 / 2.0, xy1 + wh1 / 2.0
        mins2, maxs2 = xy2 - wh2 / 2.0, xy2 + wh2 / 2.0
        iwh = tf.maximum(tf.minimum(maxs1, maxs2) - tf.maximum(mins1, mins2), 0.0)
        inter = iwh[..., 0] * iwh[..., 1]
        return inter / (wh1[..., 0] * wh1[..., 1]
                        + wh2[..., 0] * wh2[..., 1] - inter)

    true_conf = iou(true_xy, true_wh, pred_xy, pred_wh) * y_true[..., 4]
    true_class = tf.argmax(y_true[..., 5:], axis=-1)

    coord_mask = y_true[..., 4:5] * config.COORD_SCALE
    best_ious = tf.reduce_max(
        iou(pred_xy[..., None, :], pred_wh[..., None, :],
            true_boxes[..., 0:2], true_boxes[..., 2:4]), axis=-1)
    conf_mask = (tf.cast(best_ious < 0.6, tf.float32)
                 * (1.0 - y_true[..., 4]) * config.NO_OBJECT_SCALE
                 + y_true[..., 4] * config.OBJECT_SCALE)
    class_mask = y_true[..., 4] * config.CLASS_SCALE

    if seen < config.WARM_UP_BATCHES:
        no_box = tf.cast(coord_mask < config.COORD_SCALE / 2.0, tf.float32)
        true_xy = true_xy + (0.5 + cell) * no_box
        true_wh = true_wh + anchors * no_box
        coord_mask = tf.ones_like(coord_mask)

    nb_coord = tf.reduce_sum(tf.cast(coord_mask > 0.0, tf.float32))
    nb_conf = tf.reduce_sum(tf.cast(conf_mask > 0.0, tf.float32))
    nb_class = tf.reduce_sum(tf.cast(class_mask > 0.0, tf.float32))

    loss_xy = tf.reduce_sum(tf.square(true_xy - pred_xy) * coord_mask) \
        / (nb_coord + 1e-6) / 2.0
    loss_wh = tf.reduce_sum(tf.square(true_wh - pred_wh) * coord_mask) \
        / (nb_coord + 1e-6) / 2.0
    loss_conf = tf.reduce_sum(tf.square(true_conf - pred_conf) * conf_mask) \
        / (nb_conf + 1e-6) / 2.0
    ce = tf.nn.sparse_softmax_cross_entropy_with_logits(
        labels=true_class, logits=pred_class)
    loss_class = tf.reduce_sum(ce * class_mask) / (nb_class + 1e-6)
    total = loss_xy + loss_wh + loss_conf + loss_class
    return {"loss_xy": loss_xy, "loss_wh": loss_wh, "loss_conf": loss_conf,
            "loss_class": loss_class, "yolo_sum_loss": total}


def _shapes_batch(cfg, rng, n=2):
    from mask_yolo_tpu.data.encoder import encode_batch
    from mask_yolo_tpu.data.loader import load_image_gt
    from mask_yolo_tpu.data.shapes import ShapesDataset

    ds = ShapesDataset()
    ds.load_shapes(n, cfg.IMAGE_SHAPE[0], cfg.IMAGE_SHAPE[1], seed=11)
    ds.prepare()
    boxes = np.zeros((n, cfg.MAX_GT_INSTANCES, 4), np.float32)
    ids = np.zeros((n, cfg.MAX_GT_INSTANCES), np.int32)
    for i in ds.image_ids:
        _, cls, bx, _ = load_image_gt(ds, cfg, i)
        k = min(len(cls), cfg.MAX_GT_INSTANCES)
        boxes[i, :k] = bx[:k]
        ids[i, :k] = cls[:k]
    return encode_batch(boxes, ids, cfg)


def test_yolo_loss_matches_tf_port(rng):
    """Component-by-component loss parity on real encoded Shapes targets,
    both in the trained regime and the warm-up phase."""
    from conftest import TinyConfig

    from mask_yolo_tpu.losses import yolo_loss

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = []
        WARM_UP_BATCHES = 3

    cfg = Cfg()
    y_true, true_boxes = _shapes_batch(cfg, rng)
    # stay within the exp clamp (|twh| <= 8) where ours == reference exactly
    y_pred = rng.uniform(-2.5, 2.5, size=y_true.shape).astype(np.float32)

    for seen in (100.0, 0.0):  # past warm-up / inside warm-up
        loss_j, metrics_j = yolo_loss(jnp.asarray(y_true), jnp.asarray(y_pred),
                                      jnp.asarray(true_boxes), cfg, seen)
        metrics_t = _tf_yolo_loss(tf.constant(y_true), tf.constant(y_pred),
                                  tf.constant(true_boxes), cfg, seen)
        for k in ("loss_xy", "loss_wh", "loss_conf", "loss_class",
                  "yolo_sum_loss"):
            np.testing.assert_allclose(
                float(metrics_j[k]), float(metrics_t[k]), rtol=1e-5,
                atol=1e-6, err_msg=f"{k} (seen={seen})")
        np.testing.assert_allclose(float(loss_j),
                                   float(metrics_t["yolo_sum_loss"]),
                                   rtol=1e-5)


def test_mask_loss_matches_keras_bce(rng):
    """mask_loss == Keras binary_crossentropy (with its 1e-7 prob clipping)
    gathered on the target-class channel, positives-only mean — the exact
    myolo_mask_loss_graph recipe (model.py:718-754)."""
    from mask_yolo_tpu.losses import mask_loss

    b, r, mh, mw, c = 2, 6, 8, 8, 4
    target_masks = (rng.rand(b, r, mh, mw) > 0.5).astype(np.float32)
    target_ids = rng.randint(0, c, size=(b, r)).astype(np.int32)
    target_ids[:, -2:] = 0  # padding/negative slots
    pred = rng.uniform(1e-8, 1.0 - 1e-8,
                       size=(b, r, mh, mw, c)).astype(np.float32)

    ours = float(mask_loss(jnp.asarray(target_masks), jnp.asarray(target_ids),
                           jnp.asarray(pred)))

    # TF port: gather positive ROIs' target-class channel, K.mean(BCE)
    pos = np.argwhere(target_ids > 0)
    y_true_g = np.stack([target_masks[i, j] for i, j in pos])
    y_pred_g = np.stack([pred[i, j, :, :, target_ids[i, j]] for i, j in pos])
    theirs = float(tf.reduce_mean(keras.losses.binary_crossentropy(
        tf.constant(y_true_g[..., None]), tf.constant(y_pred_g[..., None]))))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)

    # no positives → exactly 0 (model.py:750)
    zero = float(mask_loss(jnp.asarray(target_masks),
                           jnp.zeros((b, r), np.int32), jnp.asarray(pred)))
    assert zero == 0.0
