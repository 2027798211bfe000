"""Device mesh + sharding policy.

The reference is strictly single-process/single-device (GPU_COUNT=0,
/root/reference/myolo/config.py:47; SURVEY.md §2.3 documents the absence of
any parallelism or collectives). The replacement is the standard JAX
recipe: build a `Mesh` over the available devices, annotate array shardings
with `NamedSharding`, and let XLA insert the collectives (psum for gradient
reduction under `jit`). The GPUs of one host are joined all to all, so the
mesh shape follows the algorithm (data × model), not a wiring topology.

Axes:
  'data'  — batch dimension (pure DP; gradients all-reduced by XLA)
  'model' — tensor parallelism: wide conv kernels (the 512/1024-channel YOLO
            head blocks, the 256-channel mask-head convs) are sharded over
            their output-channel dim via `param_shardings`; GSPMD propagates
            the channel sharding through the depthwise/pointwise stacks and
            inserts the Megatron-style collectives itself. Gradients come out
            sharded like the params, so optimizer state shards too — TP here
            buys memory (params + Adam moments / mp) and keeps every device
            busy on any (dp, mp) factorization.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def build_mesh(config=None, devices=None, batch_size: int = 0) -> Mesh:
    """Build a (data, model) mesh. DATA_PARALLEL=0 means 'all devices / MP'.

    batch_size > 0 (the GLOBAL batch): when DATA_PARALLEL is auto, shrink the
    data axis to the largest size dividing the batch, so small debug batches
    train on a device subset instead of failing the batch-sharding
    divisibility check. An explicit DATA_PARALLEL is honored as given (and
    must tile the devices exactly with MODEL_PARALLEL)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    mp = int(getattr(config, "MODEL_PARALLEL", 1) or 1) if config is not None else 1
    dp = int(getattr(config, "DATA_PARALLEL", 0) or 0) if config is not None else 0
    if dp == 0:
        dp = max(n // mp, 1)
        if batch_size > 0:
            while dp > 1 and batch_size % dp != 0:
                dp -= 1
    assert dp * mp <= n, f"mesh {dp}x{mp} > {n} devices"
    dev_array = np.asarray(devices)[: dp * mp].reshape(dp, mp)
    return Mesh(dev_array, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over the 'data' mesh axis."""
    return NamedSharding(mesh, P("data"))


def scan_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for stacked S-step superbatches ([S, B, ...], trainer
    _ChunkedSource): the scan axis replicated, the batch axis sharded."""
    return NamedSharding(mesh, P(None, "data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def place_batch_array(v, sharding):
    """Put one host array onto the mesh under `sharding`. Multi-process
    (jax.distributed) runs treat `v` as this process's LOCAL shard and
    assemble the global array (parallel/distributed.py recipe); single
    process is a plain device_put."""
    if jax.process_count() > 1:
        return jax.make_array_from_process_local_data(sharding, np.asarray(v))
    return jax.device_put(v, sharding)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Place a host batch dict onto the mesh, batch-axis sharded. In
    multi-host runs each process passes its local shard (see
    parallel/distributed.py)."""
    sh = batch_sharding(mesh)
    return {k: place_batch_array(v, sh) for k, v in batch.items()}


def replicate_tree(tree, mesh: Mesh):
    """Replicate a pytree (params / optimizer state) across the mesh."""
    sh = replicated(mesh)
    return jax.device_put(tree, sh)


# ---------------------------------------------------------------------------
# Tensor parallelism over the 'model' axis
# ---------------------------------------------------------------------------

# Channel widths below this stay replicated: sharding a 64-wide conv over the
# mesh buys nothing and costs a collective per layer.
TP_MIN_CHANNELS = 256


def param_shardings(tree, mesh: Mesh, min_channels: int = TP_MIN_CHANNELS):
    """NamedSharding pytree for tensor-parallel placement of `tree`.

    Rule: any leaf whose last (output-channel) dim is >= min_channels and
    divisible by the 'model' axis size is sharded over 'model' on that dim —
    conv kernels [kh, kw, cin, cout], depthwise kernels [kh, kw, 1, c],
    biases / BN scale / BN stats [c]. Everything else (and everything when
    model=1) is replicated. Works on params, batch_stats, and optax states
    alike (Adam moments mirror param shapes; scalar counts stay replicated).
    """
    mp = mesh.shape["model"]

    def rule(x):
        shape = tuple(getattr(x, "shape", ()))
        if (mp > 1 and shape and shape[-1] >= min_channels
                and shape[-1] % mp == 0):
            return NamedSharding(
                mesh, P(*([None] * (len(shape) - 1)), "model"))
        return NamedSharding(mesh, P())

    return jax.tree.map(rule, tree)


def shard_tree(tree, mesh: Mesh, min_channels: int = TP_MIN_CHANNELS):
    """Place params/stats/opt-state on the mesh under the TP sharding rules."""
    return jax.device_put(tree, param_shardings(tree, mesh, min_channels))


def place_tree(tree, mesh: Mesh):
    """Params placement honoring the mesh: TP-sharded when the mesh has a
    real 'model' axis, replicated otherwise."""
    if mesh.shape.get("model", 1) > 1:
        return shard_tree(tree, mesh)
    return replicate_tree(tree, mesh)
