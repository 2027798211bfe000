"""The small module layer the network is written in.

It provides exactly what models/*.py use: a `Module` with `init` and
`apply`, explicitly named submodules, `Conv` (with `feature_group_count`),
`ConvTranspose`, `BatchNorm`, `max_pool`, `relu` and `sigmoid`.

Variables live in a `{"params": ..., "batch_stats": ...}` tree of nested
dicts keyed by submodule name, the layout flax.linen builds for the same
module nesting, so checkpoints, the quantizer, the Keras-h5 converter and
the sharding rules read it by path. Initialisers follow the usual
distributions (lecun-normal kernels, zero biases, BatchNorm scale 1 /
bias 0 / mean 0 / var 1). Each parameter is drawn from the init key folded
with the SHA-1 of its module path and its creation index within that
module — the derivation flax uses, so a seed gives the same weights under
either. Compute-dtype casting follows flax's
`dtype`/`param_dtype` convention: parameters are stored in `param_dtype`
and inputs, kernel and bias are cast to `dtype` before the op.

A module is a frozen dataclass, hence hashable, so a network can be a
static argument of `jax.jit`. Submodules are created inside the calling
method with `name=` and called at once; calling a module opens its child
scope under the caller's.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

relu = jax.nn.relu
sigmoid = jax.nn.sigmoid

_lecun_normal = jax.nn.initializers.lecun_normal()
_zeros = jax.nn.initializers.zeros
_ones = jax.nn.initializers.ones


class _Scope:
    """Where a module's variables live while `init`/`apply` runs: flat
    {collection: {path: array}} dicts shared by the whole call, plus this
    module's path."""

    def __init__(self, flat, rng, mutable, initializing, path=(),
                 counters=None):
        self.flat = flat
        self.rng = rng
        self.mutable = mutable
        self.initializing = initializing
        self.path = path
        self.counters = {} if counters is None else counters

    def child(self, name: str) -> "_Scope":
        return _Scope(self.flat, self.rng, self.mutable, self.initializing,
                      self.path + (name,), self.counters)

    def get(self, collection: str, name: str, init: Callable[[], Any]):
        store = self.flat.setdefault(collection, {})
        key = self.path + (name,)
        if key not in store:
            if not self.initializing:
                raise KeyError(f"variable {collection}/{'/'.join(key)} "
                               "is missing from the variables given to apply")
            store[key] = init()
        return store[key]

    def put(self, collection: str, name: str, value):
        if not (self.initializing or collection in self.mutable):
            raise ValueError(f"collection {collection!r} is immutable here: "
                             f"pass mutable=[{collection!r}] to apply")
        self.flat[collection][self.path + (name,)] = value

    def next_rng(self):
        """Key for the next parameter this module creates: the init key
        folded with the first 4 bytes of SHA-1(path names, creation index)."""
        n = self.counters.get(self.path, 0) + 1
        self.counters[self.path] = n
        h = hashlib.sha1()
        for part in self.path + (n,):
            h.update(part.encode() if isinstance(part, str)
                     else part.to_bytes((part.bit_length() + 7) // 8, "big"))
        return jax.random.fold_in(self.rng,
                                  int.from_bytes(h.digest()[:4], "big"))


_local = threading.local()


def _current() -> _Scope:
    stack = getattr(_local, "stack", None)
    if not stack:
        raise RuntimeError("a module was called outside init/apply")
    return stack[-1]


def _run_in(scope: _Scope, fn, *args, **kwargs):
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(scope)
    try:
        return fn(*args, **kwargs)
    finally:
        stack.pop()


def _scoped_call(fn):
    """Wrap a submodule's __call__ so that it runs in its own child scope."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if self.name is None:
            raise ValueError(f"{type(self).__name__} called as a submodule "
                             "needs a name=")
        return _run_in(_current().child(self.name), fn, self, *args, **kwargs)

    call.unscoped = fn
    return call


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses are frozen dataclasses whose fields are the
    module's hyper-parameters."""

    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "__call__" in cls.__dict__:
            cls.__call__ = _scoped_call(cls.__dict__["__call__"])
        dataclasses.dataclass(frozen=True)(cls)

    # -- variables (valid only while init/apply runs) -----------------------

    def param(self, name: str, init_fn, shape, dtype=jnp.float32):
        scope = _current()
        return scope.get("params", name,
                         lambda: init_fn(scope.next_rng(), shape, dtype))

    def variable(self, collection: str, name: str, init: Callable[[], Any]):
        return _current().get(collection, name, init)

    def put_variable(self, collection: str, name: str, value):
        _current().put(collection, name, value)

    def is_initializing(self) -> bool:
        return _current().initializing

    # -- entry points --------------------------------------------------------

    def _root_fn(self, method):
        if method is None:
            fn = type(self).__call__
        elif isinstance(method, str):
            fn = getattr(type(self), method)
        else:
            fn = getattr(method, "__func__", method)
        return getattr(fn, "unscoped", fn)

    def init(self, rng, *args, method=None, **kwargs):
        """Run `method` (default __call__) creating every variable it
        touches; returns {collection: nested dict}."""
        flat: dict = {}
        scope = _Scope(flat, rng, (), initializing=True)
        _run_in(scope, self._root_fn(method), self, *args, **kwargs)
        return {c: _unflatten(v) for c, v in flat.items()}

    def apply(self, variables, *args, method=None, mutable=False, **kwargs):
        """Run `method` (default __call__; a bound method of this module or
        its name) with `variables`. With mutable (a list of collection
        names, or True for all) returns (out, {collection: updated tree})."""
        flat = {c: dict(_flatten(t)) for c, t in variables.items()}
        if mutable is True:
            mutable = tuple(flat)
        mutable = tuple(mutable or ())
        scope = _Scope(flat, None, mutable, initializing=False)
        out = _run_in(scope, self._root_fn(method), self, *args, **kwargs)
        if not mutable:
            return out
        return out, {c: _unflatten(flat.get(c, {})) for c in mutable}


def _cast(dtype, *xs):
    """Cast inputs/params to `dtype`, or to their promoted type if None."""
    if dtype is None:
        dtype = jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


class Conv(Module):
    """2-D NHWC convolution with an HWIO kernel and optional bias."""

    features: int
    kernel_size: tuple
    strides: tuple = (1, 1)
    padding: str = "SAME"
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        kshape = tuple(self.kernel_size) + (
            x.shape[-1] // self.feature_group_count, self.features)
        kernel = self.param("kernel", _lecun_normal, kshape, self.param_dtype)
        bias = (self.param("bias", _zeros, (self.features,), self.param_dtype)
                if self.use_bias else None)
        x, kernel, bias = _cast(self.dtype, x, kernel, bias)
        y = lax.conv_general_dilated(
            x, kernel, tuple(self.strides), self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=self.feature_group_count)
        if bias is not None:
            y = y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
        return y


class ConvTranspose(Module):
    """2-D NHWC transposed convolution (kernel [kh, kw, in, out])."""

    features: int
    kernel_size: tuple
    strides: tuple = (1, 1)
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        kshape = tuple(self.kernel_size) + (x.shape[-1], self.features)
        kernel = self.param("kernel", _lecun_normal, kshape, self.param_dtype)
        bias = (self.param("bias", _zeros, (self.features,), self.param_dtype)
                if self.use_bias else None)
        x, kernel, bias = _cast(self.dtype, x, kernel, bias)
        y = lax.conv_transpose(x, kernel, tuple(self.strides), self.padding,
                               dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if bias is not None:
            y = y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
        return y


class BatchNorm(Module):
    """Batch normalisation over all but the last axis.

    Statistics are taken in (at least) float32 as E[x²] − E[x]²; under
    `axis_name` both means are averaged across that axis in one pmean.
    Outside init, training updates the running averages
    (`ra = momentum·ra + (1 − momentum)·batch`), which needs
    mutable=["batch_stats"].
    """

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-3
    dtype: Any = jnp.float32
    param_dtype: Any = jnp.float32
    axis_name: str | None = None

    def __call__(self, x):
        feat = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros(feat, jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones(feat, jnp.float32))
        if self.use_running_average:
            mean, var = ra_mean, ra_var
        else:
            stat_dtype = jnp.promote_types(self.dtype or x.dtype, jnp.float32)
            xs = x.astype(stat_dtype)
            axes = tuple(range(x.ndim - 1))
            mu, mu2 = xs.mean(axes), lax.square(xs).mean(axes)
            initializing = self.is_initializing()
            if self.axis_name is not None and not initializing:
                both = lax.pmean(jnp.stack([mu, mu2], axis=0), self.axis_name)
                mu, mu2 = both[0], both[1]
            mean, var = mu, jnp.maximum(0.0, mu2 - lax.square(mu))
            if not initializing:
                m = self.momentum
                self.put_variable("batch_stats", "mean",
                                  m * ra_mean + (1 - m) * mean)
                self.put_variable("batch_stats", "var",
                                  m * ra_var + (1 - m) * var)
        shape = (1,) * (x.ndim - 1) + feat
        scale = self.param("scale", _ones, feat, self.param_dtype)
        bias = self.param("bias", _zeros, feat, self.param_dtype)
        y = x - mean.reshape(shape)
        mul = lax.rsqrt(var.reshape(shape) + self.epsilon) * scale.reshape(shape)
        y = y * mul + bias.reshape(shape)
        out_dtype = self.dtype or jnp.result_type(x, scale, bias)
        return jnp.asarray(y, out_dtype)


def max_pool(x, window, strides, padding="SAME"):
    """NHWC max pooling."""
    return lax.reduce_window(x, -jnp.inf, lax.max, (1,) + tuple(window) + (1,),
                             (1,) + tuple(strides) + (1,), padding)
