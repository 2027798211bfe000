"""ResNet-50+FPN backbone tests: output contract matches the MobileNet
backbone (stride-8, 512 channels) so every downstream component works
unchanged, and a training step runs through it."""

import jax
import jax.numpy as jnp
import numpy as np


def _cfg():
    from conftest import TinyConfig

    class RCfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BACKBONE = "resnet50_fpn"
        BATCH_SIZE = 2

    return RCfg()


def test_resnet_fpn_output_contract(rng):
    cfg = _cfg()
    from mask_yolo_tpu.models.network import MaskYoloNet

    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE)
    img = jnp.asarray(rng.rand(2, *cfg.IMAGE_SHAPE).astype(np.float32))
    rois = jnp.zeros((2, 4, 4), jnp.float32)
    variables = jax.jit(lambda: net.init(jax.random.PRNGKey(0), img, rois,
                                         train=False))()
    grid, fmap = jax.jit(
        lambda v, im: net.apply(v, im, train=False, method=net.trunk))(
        variables, img)
    h, w = cfg.IMAGE_SHAPE[:2]
    # stride-8 contract shared with the mobilenet backbone
    assert fmap.shape == (2, h // 8, w // 8, cfg.TOP_FEATURE_MAP_DEPTH)
    assert grid.shape == (2, cfg.GRID_H, cfg.GRID_W, cfg.N_BOX,
                          5 + cfg.NUM_CLASSES)


def test_resnet_fpn_train_step(rng):
    cfg = _cfg()
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
    from mask_yolo_tpu.data.shapes import ShapesDataset
    from mask_yolo_tpu.models.network import MaskYoloNet
    from mask_yolo_tpu.train import state as state_lib
    from mask_yolo_tpu.train import trainer as trainer_lib

    ds = ShapesDataset()
    ds.load_shapes(2, 64, 64, seed=9)
    ds.prepare()
    data = preload_dataset(ds, cfg)
    gen = BatchGenerator(data, cfg, mode="training", shuffle=False)

    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE)
    img = jnp.zeros((cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE), jnp.float32)
    rois = jnp.zeros((cfg.BATCH_SIZE, cfg.TRAIN_ROIS_PER_IMAGE, 4), jnp.float32)
    variables = jax.jit(lambda: net.init(jax.random.PRNGKey(1), img, rois,
                                         train=False))()

    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables.get("batch_stats", {})), tx)
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()}
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state.step) == 1


def test_fpn_pyramid_mask_branch(rng):
    """trunk_pyramid returns P3/P4/P5 and the mask branch pools each ROI
    from its FPN-assigned level (multi-level ROIAlign path)."""
    cfg = _cfg()
    from mask_yolo_tpu.models.network import MaskYoloNet

    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE)
    img = jnp.asarray(rng.rand(2, *cfg.IMAGE_SHAPE).astype(np.float32))
    variables = jax.jit(lambda: net.init(
        jax.random.PRNGKey(0), img, jnp.zeros((2, 4, 4), jnp.float32),
        train=False))()

    grid, pyr = jax.jit(
        lambda v, im: net.apply(v, im, train=False, method=net.trunk_pyramid))(
        variables, img)
    h, w = cfg.IMAGE_SHAPE[:2]
    assert len(pyr) == 3
    assert pyr[0].shape == (2, h // 8, w // 8, cfg.TOP_FEATURE_MAP_DEPTH)
    assert pyr[1].shape == (2, h // 16, w // 16, cfg.TOP_FEATURE_MAP_DEPTH)
    assert pyr[2].shape == (2, h // 32, w // 32, cfg.TOP_FEATURE_MAP_DEPTH)

    rois = jnp.asarray(np.asarray(
        [[[0.1, 0.1, 0.3, 0.3], [0.0, 0.0, 1.0, 1.0]]] * 2, np.float32))
    masks = jax.jit(lambda v, r, p: net.apply(
        v, r, tuple(p), train=False, method=net.mask_branch))(
        variables, rois, pyr)
    s = 2 * cfg.MASK_POOL_SIZE
    assert masks.shape == (2, 2, s, s, cfg.NUM_CLASSES)
    assert np.isfinite(np.asarray(masks)).all()


def test_fpn_wired_through_public_pipelines(rng):
    """With BACKBONE='resnet50_fpn' the public pipelines pool the mask branch
    from the FPN pyramid, NOT the fused single-level neck. Distinguishing
    observables:
      * training grads w.r.t. the neck ('feature_map') are exactly zero —
        nothing consumes the fused map on the FPN path;
      * detect outputs are invariant to the neck's parameters."""
    import jax
    import jax.numpy as jnp

    from mask_yolo_tpu import pipelines
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
    from mask_yolo_tpu.data.shapes import ShapesDataset
    from mask_yolo_tpu.models.network import MaskYoloNet

    cfg = _cfg()
    ds = ShapesDataset()
    ds.load_shapes(2, 64, 64, seed=9)
    ds.prepare()
    gen = BatchGenerator(preload_dataset(ds, cfg), cfg, mode="training",
                         shuffle=False)
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()}

    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE,
                      image_hw=tuple(cfg.IMAGE_SHAPE[:2]))
    img = jnp.zeros((cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE), jnp.float32)
    rois = jnp.zeros((cfg.BATCH_SIZE, cfg.TRAIN_ROIS_PER_IMAGE, 4), jnp.float32)
    variables = jax.jit(lambda: net.init(jax.random.PRNGKey(1), img, rois,
                                         train=False))()

    def loss_of(params):
        v = {"params": params, "batch_stats": variables.get("batch_stats", {})}
        loss, _ = pipelines.training_loss(net, v, batch, cfg, seen=1e9,
                                          train=False, mutable_stats=False)
        return loss

    grads = jax.grad(loss_of)(variables["params"])
    neck = np.concatenate([np.asarray(g).ravel()
                           for g in jax.tree.leaves(grads["feature_map"])])
    assert np.all(neck == 0.0), "neck got gradient: fused path still in use"
    yolo = np.concatenate([np.asarray(g).ravel()
                           for g in jax.tree.leaves(grads["yolo"])])
    assert np.any(yolo != 0.0)

    # detect invariance to the neck
    out1 = jax.device_get(pipelines.detect_outputs(
        net, variables, batch["image"], cfg))
    mutated = jax.tree.map(lambda x: x, variables)
    mutated["params"]["feature_map"]["kernel"] = (
        mutated["params"]["feature_map"]["kernel"] + 100.0)
    out2 = jax.device_get(pipelines.detect_outputs(
        net, mutated, batch["image"], cfg))
    for k in out1:
        np.testing.assert_array_equal(out1[k], out2[k])


def test_fpn_maskyolo_end_to_end(tmp_path):
    """Public-API e2e: MaskYOLO with resnet50_fpn trains (loss decreases)
    and detect() returns well-formed results (SURVEY §7 step 7)."""
    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset

    cfg = _cfg()
    cfg.BATCH_SIZE = 2
    tr = ShapesDataset(); tr.load_shapes(2, 64, 64, seed=3); tr.prepare()
    va = ShapesDataset(); va.load_shapes(2, 64, 64, seed=4); va.prepare()

    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path))
    losses = []
    m.train(tr, va, learning_rate=1e-3, epochs=6, layers="all", verbose=False,
            custom_callbacks=[lambda e, tm, vl, s: losses.append(tm["loss"])])
    assert losses[-1] < losses[0], losses

    m.mode = "inference"
    img = tr.load_image(0)
    res = m.detect(img, display=False, cs_threshold=0.0)
    r = res[0]
    assert r["full_masks"].shape[:2] == tuple(cfg.IMAGE_SHAPE[:2])
    assert len(r["bboxes"]) == len(r["class_ids"]) == len(r["confidence_scores"])
