"""models/nn.py against flax.linen: the same network source run on both.

The model files (models/{layers,mobilenet,yolo_head,mask_head,resnet_fpn}.py)
are loaded a second time with `nn` bound to a flax-backed shim, and a flax
MaskYoloNet with the same submodule names wires them together. Both are
initialised from one key and run on one batch: the variable trees, the
outputs and the updated batch statistics must be identical.
"""

import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mask_yolo_tpu.models.network import MaskYoloNet

fnn = pytest.importorskip("flax.linen")

_PKG = "mask_yolo_tpu._flax_models"


def _flax_models():
    """The model modules, executed against a flax-backed `nn`."""
    if _PKG in sys.modules:
        return sys.modules[_PKG]

    class Module(fnn.Module):
        def __init_subclass__(cls, **kwargs):
            if "__call__" in cls.__dict__:
                cls.__call__ = fnn.compact(cls.__dict__["__call__"])
            super().__init_subclass__(**kwargs)

    class BatchNorm(fnn.BatchNorm):
        momentum: float = 0.99
        epsilon: float = 1e-3

    shim = types.ModuleType(_PKG + ".nn")
    shim.__dict__.update(Module=Module, Conv=fnn.Conv, BatchNorm=BatchNorm,
                         ConvTranspose=fnn.ConvTranspose,
                         max_pool=fnn.max_pool, relu=fnn.relu,
                         sigmoid=fnn.sigmoid)
    pkg = types.ModuleType(_PKG)
    pkg.__path__ = [os.path.dirname(importlib.import_module(
        "mask_yolo_tpu.models.nn").__file__)]
    sys.modules[_PKG] = pkg
    sys.modules[_PKG + ".nn"] = shim
    pkg.nn = shim
    return pkg


def _flax_net(**kw):
    _flax_models()
    mods = {m: importlib.import_module(f"{_PKG}.{m}")
            for m in ("mobilenet", "resnet_fpn", "yolo_head", "mask_head")}

    class FlaxMaskYoloNet(fnn.Module):
        num_classes: int
        n_box: int
        top_feature_map_depth: int = 256
        mask_pool_size: int = 14
        backbone: str = "mobilenet"
        compute_dtype: str = "float32"
        image_hw: tuple = (224, 224)

        def setup(self):
            dt = jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32
            if self.backbone == "mobilenet":
                self.bb = mods["mobilenet"].MobileNetBackbone(dtype=dt,
                                                              name="backbone")
            else:
                self.bb = mods["resnet_fpn"].ResNetFPNBackbone(
                    pyramid_size=self.top_feature_map_depth, dtype=dt,
                    name="backbone")
            self.neck = fnn.Conv(self.top_feature_map_depth, (3, 3),
                                 padding="SAME", dtype=dt, name="feature_map")
            self.yolo = mods["yolo_head"].YoloHead(self.n_box, self.num_classes,
                                                   dtype=dt, name="yolo")
            self.mask = mods["mask_head"].MaskHead(
                self.num_classes, self.mask_pool_size, dtype=dt,
                image_hw=tuple(self.image_hw), name="mask")

        def trunk(self, image, train=False):
            c4 = self.bb(image, train)
            return self.yolo(c4, train), self.neck(c4)

        def trunk_pyramid(self, image, train=False):
            c4, pyramid = self.bb(image, train, return_pyramid=True)
            return self.yolo(c4, train), pyramid

        def mask_branch(self, rois, fmap, train=False):
            return self.mask(rois, fmap, train)

        def __call__(self, image, rois, train=False):
            grid, fmap = self.trunk(image, train)
            return grid, fmap, self.mask_branch(rois, fmap, train)

    return FlaxMaskYoloNet(**kw)


def _tree_signature(tree):
    return {jax.tree_util.keystr(p): (np.shape(v), np.asarray(v).dtype)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(a, b):
    assert _tree_signature(a) == _tree_signature(b)
    for (p, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                         jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("backbone", ["mobilenet", "resnet50_fpn"])
def test_nn_matches_flax(backbone, train, dtype):
    kw = dict(num_classes=3, n_box=2, top_feature_map_depth=16,
              mask_pool_size=4, backbone=backbone, compute_dtype=dtype,
              image_hw=(64, 64))
    ours, ref = MaskYoloNet(**kw), _flax_net(**kw)
    key = jax.random.PRNGKey(5)
    img = jax.random.uniform(jax.random.PRNGKey(1), (2, 64, 64, 3))
    rois = jnp.asarray(np.tile([[0.1, 0.1, 0.6, 0.7], [0.3, 0.2, 0.9, 0.8],
                                [0.0, 0.0, 1.0, 1.0]], (2, 1, 1)), jnp.float32)

    v_ours = jax.jit(lambda k: ours.init(k, img, rois, train=False))(key)
    v_ref = jax.jit(lambda k: ref.init(k, img, rois, train=False))(key)
    _assert_trees_equal(v_ours, v_ref)

    # the same variables through both: outputs and (in train mode) the
    # updated running statistics agree exactly
    mutable = ["batch_stats"] if train else False
    method = "trunk_pyramid" if backbone == "resnet50_fpn" else "trunk"
    for meth, args in ((None, (img, rois)), (method, (img,))):
        run = lambda net: jax.jit(lambda v: net.apply(
            v, *args, train=train, method=meth, mutable=mutable))(v_ours)
        _assert_trees_equal(run(ours), run(ref))
