"""ops/int8_conv.py: every int8 conv form equals lax.conv_general_dilated
with int32 accumulation, bit for bit, one case per conv kind of the
quantized network (tests at small spatial sizes; the widths that matter for
exactness — the contraction depth — are the network's)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from mask_yolo_tpu.ops.int8_conv import conv_int8

CASES = {
    # name: (x shape, HWIO kernel shape, strides, feature groups)
    "stem_3x3_s2_cin3": ((8, 33, 31, 3), (3, 3, 3, 32), (2, 2), 1),
    "pointwise_1x1": ((2, 9, 9, 64), (1, 1, 64, 128), (1, 1), 1),
    "pointwise_1x1_s2": ((2, 9, 10, 32), (1, 1, 32, 16), (2, 2), 1),
    "dense_3x3_neck": ((2, 7, 7, 512), (3, 3, 512, 256), (1, 1), 1),
    "depthwise_3x3_s1": ((2, 12, 11, 32), (3, 3, 1, 32), (1, 1), 32),
    "depthwise_3x3_s2": ((2, 12, 11, 64), (3, 3, 1, 64), (2, 2), 64),
    "mask_conv_3x3": ((6, 14, 14, 256), (3, 3, 256, 256), (1, 1), 1),
    "mask_deconv_as_1x1": ((6, 14, 14, 256), (1, 1, 256, 1024), (1, 1), 1),
}


def _reference(x, w, strides, groups):
    return lax.conv_general_dilated(
        x, w, strides, "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)


def _operands(name):
    xs, ws, _, _ = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.integers(-127, 128, xs, dtype=np.int8)
    w = rng.integers(-127, 128, ws, dtype=np.int8)
    # saturated corners: the largest sums a layer can produce
    x[0, :3, :3] = 127
    w[..., 0] = 127
    return x, w


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_conv_equals_lax_conv(name):
    _, _, strides, groups = CASES[name]
    x, w = _operands(name)
    fn = jax.jit(conv_int8, static_argnums=(2, 3))
    got = np.asarray(fn(x, w, strides, groups))
    want = np.asarray(_reference(x, w, strides, groups))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_int8_conv_rejects_other_groupings():
    x = np.zeros((1, 4, 4, 8), np.int8)
    with pytest.raises(NotImplementedError, match="feature_group_count=2"):
        conv_int8(x, np.zeros((3, 3, 4, 8), np.int8), (1, 1), groups=2)


def test_int8_conv_is_lowered_without_integer_convs():
    """XLA:GPU refuses integer conv_general_dilated; no form may emit one."""
    for name, (xs, ws, strides, groups) in CASES.items():
        jaxpr = jax.make_jaxpr(conv_int8, static_argnums=(2, 3))(
            np.zeros(xs, np.int8), np.zeros(ws, np.int8), strides, groups)
        prims = {e.primitive.name for e in jaxpr.eqns}
        assert "conv_general_dilated" not in prims, name


@pytest.mark.gpu
def test_int8_conv_on_card_matches_cpu(gpu_device):
    """On the card the int32 accumulators equal the CPU's for every kind."""
    cpu = jax.devices("cpu")[0]
    fn = jax.jit(conv_int8, static_argnums=(2, 3))
    for name, (_, _, strides, groups) in CASES.items():
        x, w = _operands(name)
        got = np.asarray(fn(jax.device_put(x, gpu_device),
                            jax.device_put(w, gpu_device), strides, groups))
        want = np.asarray(fn(jax.device_put(x, cpu), jax.device_put(w, cpu),
                             strides, groups))
        np.testing.assert_array_equal(got, want, err_msg=name)
