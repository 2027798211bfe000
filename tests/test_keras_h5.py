"""Keras-h5 weight interop tests (utils/keras_h5.py): kernel-layout
conversions are verified against the TF op semantics, and a full round trip
through the Keras file layout reproduces the model bit-exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from mask_yolo_tpu.utils import keras_h5


def test_deconv_kernel_conversion_matches_tf_semantics(rng):
    """nn.ConvTranspose with the converted kernel == tf.nn.conv2d_transpose
    with the original Keras [kh, kw, out, in] kernel (stride 2, kernel 2,
    SAME): y[2i+d, 2j+e, o] = sum_c x[i,j,c] * K[d,e,o,c]."""
    from mask_yolo_tpu.models import nn

    h = w = 3
    cin, cout = 2, 3
    x = rng.rand(1, h, w, cin).astype(np.float32)
    k = rng.rand(2, 2, cout, cin).astype(np.float32)

    y_tf = np.zeros((1, 2 * h, 2 * w, cout), np.float32)
    for i in range(h):
        for j in range(w):
            for d in range(2):
                for e in range(2):
                    y_tf[0, 2 * i + d, 2 * j + e] += x[0, i, j] @ k[d, e].T

    mod = nn.ConvTranspose(cout, (2, 2), strides=(2, 2))
    v = {"params": {"kernel": jnp.asarray(keras_h5._deconv_kernel(k).copy()),
                    "bias": jnp.zeros(cout)}}
    y = np.asarray(mod.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_tf, rtol=1e-5, atol=1e-6)


def test_depthwise_kernel_conversion(rng):
    """nn.Conv grouped conv with the converted kernel == per-channel
    depthwise conv with the Keras [kh, kw, cin, 1] kernel."""
    from mask_yolo_tpu.models import nn

    cin = 4
    x = rng.rand(1, 6, 6, cin).astype(np.float32)
    k = rng.rand(3, 3, cin, 1).astype(np.float32)

    # direct per-channel correlation, SAME padding
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    y_ref = np.zeros_like(x)
    for c in range(cin):
        for i in range(6):
            for j in range(6):
                y_ref[0, i, j, c] = np.sum(
                    xp[0, i:i + 3, j:j + 3, c] * k[:, :, c, 0])

    mod = nn.Conv(cin, (3, 3), padding="SAME", feature_group_count=cin,
                  use_bias=False)
    v = {"params": {"kernel": jnp.asarray(keras_h5._depthwise_kernel(k))}}
    y = np.asarray(mod.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)


def _tiny_model(tmp_path):
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 2

    return MaskYOLO(mode="inference", config=Cfg(),
                    model_dir=str(tmp_path)), Cfg()


def test_h5_round_trip_bit_exact(tmp_path, rng):
    """save_keras_h5(load_keras_h5(save(...))) reproduces every forward
    output bit-exactly: the name map + layout conversions invert cleanly."""
    m, cfg = _tiny_model(tmp_path)
    path = str(tmp_path / "weights.h5")
    keras_h5.save_keras_h5(path, jax.device_get(m.params),
                           jax.device_get(m.batch_stats))

    params, stats, report = keras_h5.load_keras_h5(path)
    assert not report["skipped"], report
    # every loaded leaf equals the original
    orig = jax.device_get(m.params)
    for top in params:
        for a, b in zip(jax.tree.leaves(params[top]),
                        jax.tree.leaves(orig[top])):
            np.testing.assert_allclose(a, b, atol=0, rtol=0)


def _nest_yolo_branch(flat_path, nested_path):
    """Rewrite a flat save_weights h5 into the REAL Keras-2 nested-Model
    layout the reference's ModelCheckpoint produces (model.py:854-868 wraps
    the YOLO branch in a sub-Model): the yolo-branch layers move under ONE
    top-level 'yolo_model' group whose group-level weight_names attr lists
    nested per-variable paths ('conv_dw_7/depthwise_kernel:0', ...); the
    sub-groups carry NO attrs of their own."""
    import h5py

    with h5py.File(flat_path, "r") as src, h5py.File(nested_path, "w") as dst:
        layer_names = [n.decode() for n in src.attrs["layer_names"]]
        out_layers = []
        yolo_weight_names = []
        ymodel = dst.create_group("yolo_model")
        for name in layer_names:
            g = src[name]
            wnames = [n.decode() for n in g.attrs["weight_names"]]
            is_yolo = (name == "conv_23" or
                       (name.startswith(("conv_dw_", "conv_pw_")) and
                        int(name.split("_")[2]) >= 7))
            if is_yolo:
                for wn in wnames:
                    ymodel.create_dataset(wn, data=np.asarray(g[wn]))
                    yolo_weight_names.append(wn.encode())
            else:
                ng = dst.create_group(name)
                for wn in wnames:
                    ng.create_dataset(wn, data=np.asarray(g[wn]))
                ng.attrs["weight_names"] = np.array(
                    [n.encode() for n in wnames])
                out_layers.append(name.encode())
        ymodel.attrs["weight_names"] = np.array(yolo_weight_names)
        out_layers.append(b"yolo_model")
        dst.attrs["layer_names"] = np.array(out_layers)


def test_nested_submodel_h5_layout(tmp_path, rng):
    """A real Keras-2 nested-Model file (yolo branch under a 'yolo_model'
    group with a NON-empty path-style weight_names attr) must load the YOLO
    blocks — the r2 advisor found these were silently skipped."""
    m, cfg = _tiny_model(tmp_path)
    flat = str(tmp_path / "flat.h5")
    nested = str(tmp_path / "nested.h5")
    keras_h5.save_keras_h5(flat, jax.device_get(m.params),
                           jax.device_get(m.batch_stats))
    _nest_yolo_branch(flat, nested)

    p_flat, s_flat, _ = keras_h5.load_keras_h5(flat)
    p_nested, s_nested, report = keras_h5.load_keras_h5(nested)
    assert "yolo" in p_nested, report
    assert any(p[0] == "yolo" for p in report["loaded_paths"])
    assert not report["skipped"], report
    for a, b in zip(jax.tree.leaves(p_flat), jax.tree.leaves(p_nested)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(s_flat), jax.tree.leaves(s_nested)):
        np.testing.assert_array_equal(a, b)


def test_yolo_pretrain_without_yolo_weights_raises(tmp_path):
    """yolo_pretrain_dir pointing at an h5 that contributes no YOLO-branch
    weights must raise instead of training a frozen random head."""
    import h5py
    import pytest

    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]

    path = str(tmp_path / "empty.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("some_unknown_layer")
        g.create_dataset("some_unknown_layer/kernel:0", data=np.zeros((1, 1)))
        g.attrs["weight_names"] = np.array([b"some_unknown_layer/kernel:0"])
        f.attrs["layer_names"] = np.array([b"some_unknown_layer"])
    with pytest.warns(UserWarning):
        with pytest.raises(ValueError, match="no YOLO-branch"):
            MaskYOLO(mode="training", config=Cfg(), model_dir=str(tmp_path),
                     yolo_pretrain_dir=path, yolo_trainable=False)


def test_load_weights_from_keras_h5_end_to_end(tmp_path, rng):
    """Perturb a model, then restore it from a reference-layout h5: detect
    outputs must return to the originals (pretrained-YOLO interop,
    reference model.py:854-868)."""
    m, cfg = _tiny_model(tmp_path)
    images = jnp.asarray(rng.rand(2, *cfg.IMAGE_SHAPE).astype(np.float32))
    out0 = jax.device_get(m.detect_batch(images))

    path = str(tmp_path / "pretrained.h5")
    keras_h5.save_keras_h5(path, jax.device_get(m.params),
                           jax.device_get(m.batch_stats))

    # scramble the weights
    m.params = jax.tree.map(lambda x: x + 0.3, m.params)
    out_scrambled = jax.device_get(m.detect_batch(images))
    assert not np.allclose(out_scrambled["scores"], out0["scores"])

    report = m.load_weights_from_keras_h5(path)
    assert not report["shape_mismatch"], report
    out1 = jax.device_get(m.detect_batch(images))
    np.testing.assert_allclose(out1["scores"], out0["scores"], atol=1e-6)
    np.testing.assert_array_equal(out1["masks"], out0["masks"])


def test_yolo_pretrain_dir_h5_and_freezing(tmp_path, rng):
    """MaskYOLO(yolo_pretrain_dir='*.h5', yolo_trainable=False) loads the
    weights at build time and freezes backbone+yolo during training (the
    reference freezes every layer of the image→yolo path, model.py:861-868)."""
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]
        BATCH_SIZE = 2

    cfg = Cfg()
    donor = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path),
                     seed=7)
    path = str(tmp_path / "yolo_pretrain.h5")
    keras_h5.save_keras_h5(path, jax.device_get(donor.params),
                           jax.device_get(donor.batch_stats))

    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path),
                 yolo_pretrain_dir=path, yolo_trainable=False, seed=0)
    for a, b in zip(jax.tree.leaves(jax.device_get(m.params["yolo"])),
                    jax.tree.leaves(jax.device_get(donor.params["yolo"]))):
        np.testing.assert_array_equal(a, b)

    tr = ShapesDataset(); tr.load_shapes(2, 64, 64, seed=3); tr.prepare()
    va = ShapesDataset(); va.load_shapes(2, 64, 64, seed=4); va.prepare()
    before = jax.device_get(m.params)
    m.train(tr, va, learning_rate=1e-3, epochs=1, layers="all", verbose=False)
    after = jax.device_get(m.params)
    for sub in ("backbone", "yolo"):
        for a, b in zip(jax.tree.leaves(before[sub]), jax.tree.leaves(after[sub])):
            np.testing.assert_array_equal(a, b)
    # the optimizer must still carry gradient through to the unfrozen
    # subtrees (the mask branch can legitimately see zero gradient on a
    # 2-image run when no proposal reaches 0.5 IoU, so probe the optimizer
    # with synthetic all-ones gradients instead of real training deltas)
    ones = jax.tree.map(jnp.ones_like, m.params)
    upd, _ = m._tx.update(ones, m._tx.init(m.params), m.params)
    for sub in ("backbone", "yolo"):
        for g in jax.tree.leaves(upd[sub]):
            np.testing.assert_array_equal(np.asarray(g), 0.0)
    assert any(np.any(np.asarray(g) != 0.0)
               for g in jax.tree.leaves(upd["mask"])), "mask head frozen too"
    assert any(np.any(np.asarray(g) != 0.0)
               for g in jax.tree.leaves(upd["feature_map"]))
