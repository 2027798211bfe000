"""Sharded batched inference over a device mesh.

Completes the BASELINE.md scale-out row — "batched 80-class COCO-style
inference at 416² with on-device NMS + mask unmold" over many devices — for the
*inference* direction (train/trainer.py covers training). The reference has
no batched inference at all: `detect` runs one image through Keras predict
and post-processes on host (/root/reference/myolo/model.py:1238-1328).

Design: `pipelines.detect_outputs` is per-image independent (decode, NMS,
top-K, ROIAlign, mask paste are all vmapped over batch), so batch-axis
sharding over 'data' propagates through the whole program with zero
cross-device collectives — each chip detects its slice of the batch and
results gather only if the host fetches them. With MODEL_PARALLEL > 1 the
wide conv kernels additionally shard over 'model' (parallel/mesh.py
param_shardings) and GSPMD inserts the Megatron-style collectives inside
the trunk.

Multi-host: each process passes its LOCAL batch shard (the
parallel/distributed.py recipe); `place_batch_array` assembles the global
array and `local_results` returns this process's slice of the outputs.
"""

from __future__ import annotations

import jax
import numpy as np

from .mesh import batch_sharding, build_mesh, place_batch_array, place_tree


class ShardedDetector:
    """Batched image→boxes+masks inference sharded over a (data, model) mesh.

    Usage:
        det = ShardedDetector(net, variables, config)       # mesh auto-built
        out = det(images_f32)            # [B, H, W, 3] float in [0, 1]
        host = jax.device_get(out)       # gathers to host

    B must be divisible by the mesh's 'data' axis size.
    """

    def __init__(self, net, variables, config, mesh=None):
        if mesh is None:
            mesh = build_mesh(config)
        self.mesh = mesh
        self.config = config
        self.variables = place_tree(variables, mesh)
        self._batch_sh = batch_sharding(mesh)

        from .. import pipelines

        if mesh.shape.get("model", 1) > 1:
            # TP: GSPMD partitions the trunk's wide kernels and inserts the
            # Megatron-style collectives itself
            @jax.jit
            def detect(variables, images):
                return pipelines.detect_outputs(net, variables, images, config)
        else:
            # Pure DP: the pipeline is per-image independent, so run each
            # device's batch slice as a MANUAL shard (shard_map) — zero
            # cross-device collectives BY CONSTRUCTION, asserted on the
            # compiled HLO in tests/test_multichip.py. (Left to GSPMD, the
            # TopK custom call does not partition over the batch axis and
            # XLA inserts a batch all-gather at detect's score top-K.)
            from jax.sharding import PartitionSpec as P

            detect = jax.jit(jax.shard_map(
                lambda v, im: pipelines.detect_outputs(net, v, im, config),
                mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data")))

        self._fn = detect

    def __call__(self, images_f32):
        # keep the caller's dtype: uint8 batches ship 4x less over the
        # host→device link and are normalized on device by
        # pipelines.images_f32 (casting to float32 HERE would skip that /255
        # and feed 0..255 floats into the network — silent garbage)
        images = np.asarray(images_f32)
        if images.dtype != np.uint8:
            images = images.astype(np.float32, copy=False)
        images = place_batch_array(images, self._batch_sh)
        return self._fn(self.variables, images)

    def local_results(self, out):
        """Multi-host helper: this process's batch slice of `out`, as host
        numpy. Single-process runs get the whole batch."""
        def to_local(x):
            shards = [s for s in x.addressable_shards]
            shards.sort(key=lambda s: s.index[0].start or 0)
            return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

        return jax.tree.map(to_local, out)
