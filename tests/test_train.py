"""Training smoke + overfit tests on the tiny config: the jitted train step
runs, the loss decreases when overfitting one Shapes batch, and layer
freezing actually freezes parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def fresh(tree):
    """Deep-copy a pytree — train steps donate their state buffers."""
    return jax.tree.map(jnp.array, tree)

from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
from mask_yolo_tpu.data.shapes import ShapesDataset
from mask_yolo_tpu.models.network import MaskYoloNet
from mask_yolo_tpu.train import state as state_lib
from mask_yolo_tpu.train import trainer as trainer_lib


@pytest.fixture(scope="module")
def setup(rng):
    from conftest import TinyConfig

    class ShapesTiny(TinyConfig):
        # ShapesDataset emits class ids 1..3 → needs 1 + 3 classes
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]

    cfg = ShapesTiny()
    ds = ShapesDataset()
    ds.load_shapes(cfg.BATCH_SIZE, 64, 64, seed=5)
    ds.prepare()
    data = preload_dataset(ds, cfg)
    gen = BatchGenerator(data, cfg, mode="training", shuffle=False)
    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE)
    img = jnp.zeros((cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE), jnp.float32)
    rois = jnp.zeros((cfg.BATCH_SIZE, cfg.TRAIN_ROIS_PER_IMAGE, 4), jnp.float32)
    variables = net.init(jax.random.PRNGKey(1), img, rois, train=False)
    return cfg, net, variables, gen


def test_overfit_one_batch_loss_decreases(setup):
    cfg, net, variables, gen = setup
    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()}
    losses = []
    for _ in range(25):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7, losses
    assert int(state.step) == 25


def test_yolo_mode_train_step(setup):
    cfg, net, variables, gen = setup
    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="yolo")
    state = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()
             if k in ("image", "yolo_target", "true_boxes")}
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    # the wh-loss oscillates under single-batch Adam overfit (exp
    # parametrization), so compare a robust statistic, not the last step
    assert np.median(losses[5:]) < losses[0], losses
    assert min(losses[5:]) < 0.5 * losses[0], losses


def test_layer_freezing(setup):
    """Freezing the backbone subtree must leave it bit-identical while the
    YOLO head (which always receives gradient through the YOLO loss) trains.
    (The mask head can legitimately receive zero gradient when no proposal
    reaches 0.5 IoU with GT, so it is not the right 'changed' witness.)"""
    cfg, net, variables, gen = setup
    tx = state_lib.make_optimizer(1e-3, cfg, params=variables["params"],
                                  layer_regex=".*",
                                  frozen_prefixes=("backbone",))
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    before_backbone = jax.device_get(state.params["backbone"])
    before_yolo = jax.device_get(state.params["yolo"])
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()}
    for _ in range(3):
        state, _ = step(state, batch)
    after_backbone = jax.device_get(state.params["backbone"])
    after_yolo = jax.device_get(state.params["yolo"])
    for b, a in zip(jax.tree.leaves(before_backbone), jax.tree.leaves(after_backbone)):
        np.testing.assert_array_equal(b, a)
    changed = any(
        not np.array_equal(b, a)
        for b, a in zip(jax.tree.leaves(before_yolo), jax.tree.leaves(after_yolo)))
    assert changed


def test_trainable_labels_regex(setup):
    cfg, net, variables, _ = setup
    labels = state_lib.trainable_labels(variables["params"], r"mask.*")
    flat = jax.tree_util.tree_flatten_with_path(labels)[0]
    for path, lbl in flat:
        top = str(getattr(path[0], "key", path[0]))
        assert lbl == ("train" if top.startswith("mask") else "freeze")


def test_trunk_bn_stats_update(setup):
    """Regression: trunk BN running stats must move off init during training
    (a stale-merge bug once froze them, saturating eval-mode inference into
    input-independent constants)."""
    cfg, net, variables, gen = setup
    assert cfg.TRAIN_BN
    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    batch = {k: jnp.asarray(v) for k, v in gen[0].items()}
    for _ in range(3):
        state, _ = step(state, batch)

    def leaves(tree):
        return jax.tree_util.tree_leaves_with_path(tree)

    init_stats = variables["batch_stats"]
    moved_backbone = moved_mask = False
    for (path, new), (_, old) in zip(leaves(state.batch_stats),
                                     leaves(init_stats)):
        top = str(getattr(path[0], "key", path[0]))
        changed = not np.allclose(np.asarray(new), np.asarray(old))
        if top == "backbone" and changed:
            moved_backbone = True
        if top == "mask" and changed:
            moved_mask = True
    assert moved_backbone, "backbone BN running stats frozen at init"
    assert moved_mask, "mask BN running stats frozen at init"


def test_run_epoch_prefetch_matches_direct(setup):
    """Prefetched epochs produce the same final state as direct indexing."""
    cfg, net, variables, gen = setup
    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")

    s1 = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    s1, m1 = trainer_lib.run_epoch(step, s1, gen, mesh=None, verbose=False,
                                   prefetch=2)
    s2 = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    s2, m2 = trainer_lib.run_epoch(step, s2, gen, mesh=None, verbose=False,
                                   prefetch=0)
    assert int(s1.step) == int(s2.step) == len(gen)
    np.testing.assert_allclose(m1["loss"], m2["loss"], rtol=1e-5)


def test_train_with_augmentation_uses_generator(tmp_path):
    """MaskYOLO.train(augmentation=...) re-applies the augmentation every
    epoch (generator path), unlike the one-shot preload."""
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 8

    cfg = Cfg()
    tr = ShapesDataset(); tr.load_shapes(8, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(8, 64, 64, seed=1); va.prepare()

    calls = {"n": 0}

    def aug(image, mask):
        calls["n"] += 1
        return np.fliplr(image), np.fliplr(mask)

    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path))
    m.train(tr, va, learning_rate=1e-3, epochs=2, layers="all",
            augmentation=aug, verbose=False)
    # 8 images/epoch × 2 epochs = 16 augmentation calls (one-shot preload
    # would have been 8)
    assert calls["n"] == 16, calls
    import os
    assert os.path.exists(str(tmp_path / "config.json"))
    assert os.path.exists(str(tmp_path / "history.jsonl"))


def test_steps_per_epoch_caps_run_epoch(setup):
    """STEPS_PER_EPOCH wiring: max_steps caps the epoch."""
    cfg, net, variables, gen = setup
    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    s = state_lib.create_train_state(
        fresh(variables["params"]), fresh(variables.get("batch_stats", {})), tx)
    assert len(gen) >= 1
    s, _ = trainer_lib.run_epoch(step, s, gen, mesh=None, verbose=False,
                                 prefetch=2, max_steps=1)
    assert int(s.step) == 1
    # 0 = unlimited (full generator)
    s, _ = trainer_lib.run_epoch(step, s, gen, mesh=None, verbose=False,
                                 prefetch=0, max_steps=0)
    assert int(s.step) == 1 + len(gen)


def test_steps_knobs_honored_by_train(tmp_path):
    """MaskYOLO.train honors STEPS_PER_EPOCH and VALIDATION_STEPS."""
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 4
        STEPS_PER_EPOCH = 1   # dataset has 8/4 = 2 batches; cap to 1
        VALIDATION_STEPS = 1

    cfg = Cfg()
    tr = ShapesDataset(); tr.load_shapes(8, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(8, 64, 64, seed=1); va.prepare()
    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path))
    state = m.train(tr, va, learning_rate=1e-3, epochs=2, layers="all",
                    verbose=False)
    # 2 epochs × 1 capped step
    assert int(state.step) == 2


def test_prefetcher_early_abandon_does_not_hang(setup):
    """Consumer abandoning iteration mid-epoch must not leave the worker
    blocked on a full queue (ADVICE r1: prefetch.py q.put deadlock)."""
    import threading
    import time

    from mask_yolo_tpu.data.prefetch import DevicePrefetcher

    cfg, _, _, gen = setup
    before = threading.active_count()
    it = iter(DevicePrefetcher(gen, None, size=1))
    next(it)          # worker is now staging ahead / blocked on the queue
    it.close()        # abandon iteration
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch worker still alive"


def test_lr_schedule_resolution():
    """make_lr_schedule: constant stays a scalar (checkpoint-compatible with
    prior rounds); cosine warms up to the peak and decays to the floor."""
    from conftest import TinyConfig

    class Constant(TinyConfig):
        pass

    class Cosine(TinyConfig):
        LR_SCHEDULE = "cosine"
        LR_WARMUP_STEPS = 10
        LR_FINAL_FRACTION = 0.1

    assert state_lib.make_lr_schedule(1e-3, Constant(), 100) == 1e-3
    sched = state_lib.make_lr_schedule(1e-3, Cosine(), 100)
    assert float(sched(0)) == 0.0                       # warm-up start
    assert np.isclose(float(sched(10)), 1e-3)           # peak after warm-up
    assert np.isclose(float(sched(100)), 1e-4)          # floor at horizon
    mid = float(sched(55))
    assert 1e-4 < mid < 1e-3                            # strictly decaying
    with pytest.raises(ValueError):
        state_lib.make_lr_schedule(1e-3, Cosine(), 0)   # needs a horizon

    class Bad(TinyConfig):
        LR_SCHEDULE = "triangular"

    with pytest.raises(ValueError):
        state_lib.make_lr_schedule(1e-3, Bad(), 100)


def test_cosine_schedule_trains_and_resumes(tmp_path):
    """End-to-end: cosine schedule trains through MaskYOLO.train and the
    schedule position survives resume_from (optax count restores)."""
    from mask_yolo_tpu import MaskYOLO
    from conftest import TinyConfig

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 4
        LR_SCHEDULE = "cosine"
        LR_WARMUP_STEPS = 2
        VALIDATION_STEPS = 1

    cfg = Cfg()
    tr = ShapesDataset(); tr.load_shapes(8, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(4, 64, 64, seed=1); va.prepare()
    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path / "a"))
    state = m.train(tr, va, learning_rate=1e-3, epochs=2, layers="all",
                    verbose=False)
    assert int(state.step) == 4  # 2 epochs x 2 steps
    ckpts = sorted((tmp_path / "a").glob("saved_model_*"))
    assert ckpts
    m2 = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path / "b"))
    state2 = m2.train(tr, va, learning_rate=1e-3, epochs=3, layers="all",
                      verbose=False, resume_from=str(ckpts[-1]))
    assert int(state2.step) == 6


def test_resume_across_schedule_kinds_resets_optimizer(tmp_path):
    """Resuming a constant-LR checkpoint under LR_SCHEDULE='cosine' (different
    optax opt_state structure) restores params/epoch with a warning instead of
    crashing; the optimizer moments reset."""
    import warnings

    from mask_yolo_tpu import MaskYOLO
    from conftest import TinyConfig

    class Base(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 4
        VALIDATION_STEPS = 1

    class CosineCfg(Base):
        LR_SCHEDULE = "cosine"
        LR_WARMUP_STEPS = 1

    tr = ShapesDataset(); tr.load_shapes(4, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(4, 64, 64, seed=1); va.prepare()
    m = MaskYOLO(mode="training", config=Base(), model_dir=str(tmp_path / "a"))
    m.train(tr, va, learning_rate=1e-3, epochs=1, layers="all", verbose=False)
    ckpt = sorted((tmp_path / "a").glob("saved_model_*"))[-1]

    m2 = MaskYOLO(mode="training", config=CosineCfg(),
                  model_dir=str(tmp_path / "b"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        state = m2.train(tr, va, learning_rate=1e-3, epochs=2, layers="all",
                         verbose=False, resume_from=str(ckpt))
    assert any("optimizer moments RESET" in str(x.message) for x in w)
    assert int(state.step) == 2  # epoch 1 restored + 1 more epoch x 1 step


def test_lr_total_steps_overrides_horizon():
    """Config.LR_TOTAL_STEPS pins the cosine horizon regardless of the
    per-call total_steps — what keeps segmented runs on one schedule."""
    from conftest import TinyConfig

    class Cfg(TinyConfig):
        LR_SCHEDULE = "cosine"
        LR_FINAL_FRACTION = 0.1
        LR_TOTAL_STEPS = 100

    sched = state_lib.make_lr_schedule(1e-3, Cfg(), total_steps=10)
    assert np.isclose(float(sched(100)), 1e-4)   # floor at the pinned horizon
    assert float(sched(10)) > 5e-4               # nowhere near floor at 10


def test_stop_after_epoch(tmp_path):
    """train(stop_after_epoch=k) checkpoints and returns after epoch k while
    the schedule horizon still reflects the full `epochs`."""
    from mask_yolo_tpu import MaskYOLO
    from conftest import TinyConfig

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 4
        VALIDATION_STEPS = 1

    cfg = Cfg()
    tr = ShapesDataset(); tr.load_shapes(4, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(4, 64, 64, seed=1); va.prepare()
    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path))
    state = m.train(tr, va, learning_rate=1e-3, epochs=10, layers="all",
                    verbose=False, stop_after_epoch=2)
    assert int(state.step) == 2      # 2 epochs x 1 step, not 10
    assert m.epoch == 2
    ckpts = sorted(tmp_path.glob("saved_model_*"))
    assert ckpts and str(ckpts[-1]).endswith("_e0002")
    # resume the remaining epochs in a "new process" (fresh model object)
    m2 = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path))
    state2 = m2.train(tr, va, learning_rate=1e-3, epochs=4, layers="all",
                      verbose=False, resume_from=str(ckpts[-1]))
    assert int(state2.step) == 4


def test_scan_train_step_matches_per_step(setup):
    """The scan superbatch path == the per-step path.

    Two layers of evidence, because multi-step BITWISE equality across two
    different XLA programs is unobtainable: the separately-compiled bodies
    differ at ~1 ulp (measured 1.2e-7 after one SGD step) and the early
    YOLO loss is sharp enough to amplify that chaotically (measured loss
    deltas 0 → 8e-5 → 4e-3 → 0.23 over four steps). So:
      (a) ONE scanned step vs ONE plain step — equal to FP noise (the
          bodies compute the same update);
      (b) scan(S=4) vs 4 × scan(S=1) — bit-exact (same compiled body), which
          pins the sequencing: batch order, step counter, BN/opt threading.
    """
    cfg, net, variables, gen = setup
    rng = np.random.default_rng(11)
    base = gen[0]
    batches = []
    for _ in range(4):  # distinct images per step so the test isn't trivial
        b = {k: np.asarray(v).copy() for k, v in base.items()}
        b["image"] = rng.integers(0, 255, b["image"].shape).astype(
            b["image"].dtype)
        batches.append(b)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    scan_step = trainer_lib.make_scan_train_step(net, cfg, tx, mode="training")

    def init():
        return state_lib.create_train_state(
            fresh(variables["params"]),
            fresh(variables.get("batch_stats", {})), tx)

    # (a) one step: scanned body == plain body to FP noise. atol 1e-4 =
    # 10% of the 1e-3 Adam update: raw-gradient noise is ~1 ulp (1.2e-7
    # under SGD) but Adam's g/(|g|+eps) amplifies it on near-zero-gradient
    # elements (measured: 1 element in 4096 at 3.6e-5)
    s_plain, m_plain = step(init(), batches[0])
    s_one, m_one = scan_step(init(), {k: v[:1] for k, v in stacked.items()})
    assert int(s_one.step) == int(s_plain.step) == 1
    np.testing.assert_allclose(float(m_one["loss"]), float(m_plain["loss"]),
                               rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), atol=1e-4),
        (s_plain.params, s_plain.batch_stats),
        (s_one.params, s_one.batch_stats))

    # (b) sequencing: one scan of 4 == four scans of 1, bit-exact
    s_seq = init()
    for i in range(4):
        s_seq, m_seq = scan_step(s_seq, {k: v[i:i + 1]
                                         for k, v in stacked.items()})
    s_all, m_all = scan_step(init(), stacked)
    assert int(s_all.step) == int(s_seq.step) == 4
    assert float(m_all["loss"]) == float(m_seq["loss"])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)),
        (s_seq.params, s_seq.batch_stats, s_seq.opt_state),
        (s_all.params, s_all.batch_stats, s_all.opt_state))


def test_run_epoch_scan_with_remainder(setup):
    """run_epoch(scan_steps=2) over 5 batches = 2 superbatches + 1 remainder
    step, in order — bit-exact against the same compiled callables invoked
    by hand."""
    cfg, net, variables, gen = setup
    rng = np.random.default_rng(13)
    base = gen[0]
    batches = []
    for _ in range(5):
        b = {k: np.asarray(v).copy() for k, v in base.items()}
        b["image"] = rng.integers(0, 255, b["image"].shape).astype(
            b["image"].dtype)
        batches.append(b)

    class _List:
        def __init__(self, items):
            self.items = items

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return {k: v.copy() for k, v in self.items[i].items()}

    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    scan_step = trainer_lib.make_scan_train_step(net, cfg, tx, mode="training")

    def init():
        return state_lib.create_train_state(
            fresh(variables["params"]),
            fresh(variables.get("batch_stats", {})), tx)

    s_ref = init()
    for lo in (0, 2):
        s_ref, _ = scan_step(s_ref, {k: np.stack([b[k] for b in
                                                  batches[lo:lo + 2]])
                                     for k in batches[0]})
    s_ref, _ = step(s_ref, batches[4])

    s_epoch = init()
    s_epoch, _ = trainer_lib.run_epoch(step, s_epoch, _List(batches),
                                       verbose=False, scan_step=scan_step,
                                       scan_steps=2)
    assert int(s_epoch.step) == int(s_ref.step) == 5
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), s_ref.params, s_epoch.params)
