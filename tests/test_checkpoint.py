"""Checkpoint round-trip + by_name/exclude subtree loading."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mask_yolo_tpu.train import state as state_lib


@pytest.fixture()
def small_params(rng):
    return {
        "backbone": {"conv1": {"kernel": jnp.asarray(rng.randn(3, 3, 3, 8),
                                                     jnp.float32)}},
        "yolo": {"conv_23": {"kernel": jnp.asarray(rng.randn(1, 1, 8, 4),
                                                   jnp.float32),
                 "bias": jnp.zeros((4,), jnp.float32)}},
        "mask": {"mask_conv1": {"kernel": jnp.asarray(rng.randn(3, 3, 8, 8),
                                                      jnp.float32)}},
    }


def test_save_load_roundtrip(tmp_path, small_params):
    tx = optax.adam(1e-3)
    st = state_lib.create_train_state(small_params, {}, tx)
    path = os.path.join(tmp_path, "ckpt")
    state_lib.save_checkpoint(path, st, epoch=3)
    loaded = state_lib.load_checkpoint(path)
    assert loaded["epoch"] == 3
    for a, b in zip(jax.tree.leaves(small_params),
                    jax.tree.leaves(loaded["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_merge_by_name_and_exclude(small_params, rng):
    other = jax.tree.map(lambda x: x + 1.0, small_params)
    merged = state_lib.merge_params(small_params, other, by_name=True,
                                    exclude=["mask"])
    # backbone/yolo replaced, mask kept
    np.testing.assert_array_equal(
        np.asarray(merged["backbone"]["conv1"]["kernel"]),
        np.asarray(other["backbone"]["conv1"]["kernel"]))
    np.testing.assert_array_equal(
        np.asarray(merged["mask"]["mask_conv1"]["kernel"]),
        np.asarray(small_params["mask"]["mask_conv1"]["kernel"]))


def test_merge_by_name_skips_unknown(small_params):
    loaded = {"backbone": small_params["backbone"], "unknown_module": {"w": jnp.ones(3)}}
    merged = state_lib.merge_params(small_params, loaded, by_name=True)
    assert "unknown_module" not in merged
    assert set(merged.keys()) == {"backbone", "yolo", "mask"}


def test_maskyolo_save_load(tmp_path):
    from conftest import TinyConfig
    from mask_yolo_tpu.model import MaskYOLO

    m = MaskYOLO(mode="inference", config=TinyConfig(), seed=0)
    path = os.path.join(tmp_path, "w")
    m.save_weights(path)

    m2 = MaskYOLO(mode="inference", config=TinyConfig(), seed=1)
    # different seeds → different params
    a = jax.tree.leaves(m.params)[0]
    b = jax.tree.leaves(m2.params)[0]
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    m2.load_weights(path)
    for x, y in zip(jax.tree.leaves(m.params), jax.tree.leaves(m2.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_full_resume_roundtrip(tmp_path, tiny_config):
    """save_checkpoint + resume_train_state restore params, optimizer
    moments and the epoch counter exactly."""
    import jax
    import jax.numpy as jnp

    from mask_yolo_tpu.train import state as state_lib

    params = {"layer": {"kernel": jnp.arange(6.0).reshape(2, 3)}}
    tx = state_lib.make_optimizer(1e-3, tiny_config)
    state = state_lib.create_train_state(params, {}, tx)
    # take two steps so Adam moments are non-trivial
    for _ in range(2):
        grads = jax.tree.map(jnp.ones_like, state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        import optax
        state = state_lib.TrainState(
            params=optax.apply_updates(state.params, updates),
            batch_stats={}, opt_state=opt_state, step=state.step + 1)

    path = str(tmp_path / "ckpt")
    state_lib.save_checkpoint(path, state, epoch=7)

    fresh = state_lib.create_train_state(
        jax.tree.map(jnp.zeros_like, params), {}, tx)
    restored, epoch = state_lib.resume_train_state(path, fresh)
    assert epoch == 7
    assert int(restored.step) == 2
    np.testing.assert_allclose(np.asarray(restored.params["layer"]["kernel"]),
                               np.asarray(state.params["layer"]["kernel"]))
    got = jax.tree_util.tree_leaves(restored.opt_state)
    want = jax.tree_util.tree_leaves(state.opt_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w))


def test_maskyolo_train_resume(tmp_path):
    """MaskYOLO.train(resume_from=...) continues at the saved epoch."""
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 8  # divisible over the 8-device test mesh

    cfg = Cfg()
    tr = ShapesDataset(); tr.load_shapes(2, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(2, 64, 64, seed=1); va.prepare()

    m1 = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path / "a"))
    m1.train(tr, va, learning_rate=1e-3, epochs=2, layers="all", verbose=False)
    import glob
    ckpts = sorted(glob.glob(str(tmp_path / "a" / "saved_model_*")))
    assert ckpts

    m2 = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path / "b"))
    m2.train(tr, va, learning_rate=1e-3, epochs=3, layers="all",
             verbose=False, resume_from=ckpts[-1])
    assert m2.epoch == 3  # resumed at 2, ran one more epoch


def test_checkpoint_rotation(tmp_path):
    """MAX_CHECKPOINTS keeps only the newest N epoch checkpoints."""
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 8
        MAX_CHECKPOINTS = 2

    cfg = Cfg()
    tr = ShapesDataset(); tr.load_shapes(2, 64, 64, seed=0); tr.prepare()
    va = ShapesDataset(); va.load_shapes(2, 64, 64, seed=1); va.prepare()
    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path))
    m.train(tr, va, learning_rate=1e-3, epochs=4, layers="all", verbose=False)
    import glob
    ckpts = glob.glob(str(tmp_path / "saved_model_*"))
    assert len(ckpts) == 2, ckpts
    # the kept ones are the newest (epoch suffix 3 and 4)
    suffixes = sorted(c.rsplit("_e", 1)[1] for c in ckpts)
    assert suffixes == ["0003", "0004"], suffixes


def test_npz_checkpoint_layout_and_by_name_exclude(tmp_path):
    """A checkpoint is a directory with arrays.npz (leaves keyed by their
    '/'-joined tree paths) and meta.json; load_weights(by_name=True,
    exclude=[...]) replaces every named module but the excluded ones."""
    import json

    from conftest import TinyConfig
    from mask_yolo_tpu.model import MaskYOLO

    src = MaskYOLO(mode="inference", config=TinyConfig(), seed=0)
    src.epoch = 5
    path = tmp_path / "w"
    src.save_weights(str(path))
    assert sorted(os.listdir(path)) == ["arrays.npz", "meta.json"]
    assert json.loads((path / "meta.json").read_text()) == {"step": 0,
                                                            "epoch": 5}
    with np.load(path / "arrays.npz") as z:
        assert "params/backbone/conv1/conv/kernel" in z.files
        assert "batch_stats/mask/mask_bn1/mean" in z.files

    dst = MaskYOLO(mode="inference", config=TinyConfig(), seed=1)
    before = jax.tree.map(np.asarray, dst.params)
    dst.load_weights(str(path), by_name=True, exclude=["mask"])
    for name in dst.params:
        want = before[name] if name == "mask" else src.params[name]
        for a, b in zip(jax.tree.leaves(dst.params[name]),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_overwrite_leaves_no_temporary(tmp_path, small_params):
    """Saving over an existing checkpoint replaces it whole (written under a
    temporary name, then renamed) and leaves nothing else behind."""
    tx = optax.adam(1e-3)
    path = str(tmp_path / "ckpt")
    state_lib.save_checkpoint(path, state_lib.create_train_state(
        small_params, {}, tx), epoch=1)
    bumped = jax.tree.map(lambda x: x + 1.0, small_params)
    state_lib.save_checkpoint(path, state_lib.create_train_state(
        bumped, {}, tx), epoch=2)
    assert os.listdir(tmp_path) == ["ckpt"]
    loaded = state_lib.load_checkpoint(path)
    assert loaded["epoch"] == 2
    np.testing.assert_array_equal(
        loaded["params"]["yolo"]["conv_23"]["bias"],
        np.asarray(bumped["yolo"]["conv_23"]["bias"]))
