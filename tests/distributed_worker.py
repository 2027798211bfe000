"""Multi-host worker used by tests/test_distributed.py.

Runs as one of N processes (MYOLO_* env triplet), each owning 4 virtual CPU
devices, and executes the FULL sharded training step over the global
(N*4)-device mesh with per-process data loading — the multi-host recipe of
parallel/distributed.py. Prints one line: `RESULT <loss> <global_devices>`.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_yolo_tpu.config import Config  # noqa: E402
from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset  # noqa: E402
from mask_yolo_tpu.data.shapes import ShapesDataset  # noqa: E402
from mask_yolo_tpu.models.network import MaskYoloNet  # noqa: E402
from mask_yolo_tpu.parallel import distributed  # noqa: E402
from mask_yolo_tpu.parallel.mesh import build_mesh, replicate_tree, shard_batch  # noqa: E402
from mask_yolo_tpu.train import state as state_lib  # noqa: E402
from mask_yolo_tpu.train import trainer as trainer_lib  # noqa: E402


class TinyConfig(Config):
    NAME = "dist-tiny"
    LABELS = ["background", "square", "circle", "triangle"]
    NUM_CLASSES = 4
    IMAGE_SHAPE = [64, 64, 3]
    IMAGE_MIN_DIM = 64
    IMAGE_MAX_DIM = 64
    GRID_H, GRID_W = 2, 2
    N_BOX = 2
    ANCHORS = [0.6, 0.7, 1.2, 1.1]
    TRUE_BOX_BUFFER = 4
    MAX_GT_INSTANCES = 4
    TRAIN_ROIS_PER_IMAGE = 8
    MASK_POOL_SIZE = 4
    MASK_SHAPE = [8, 8]
    TOP_FEATURE_MAP_DEPTH = 16
    TRAIN_BN = True
    BATCH_SIZE = 4  # LOCAL batch per process (global = 4 × process_count)


def main():
    pidx, pcnt = distributed.initialize()
    assert pcnt >= 2, f"expected a multi-process job, got {pcnt}"
    assert jax.device_count() == 4 * pcnt
    assert len(jax.local_devices()) == 4

    cfg = TinyConfig()
    # identical dataset spec everywhere; each process loads only its slice
    ds = ShapesDataset()
    ds.load_shapes(cfg.BATCH_SIZE * pcnt, 64, 64, seed=0)
    ds.prepare()
    my_ids = distributed.local_image_ids(ds.image_ids)
    assert len(my_ids) == cfg.BATCH_SIZE
    data = preload_dataset(ds, cfg, image_ids=my_ids)
    gen = BatchGenerator(data, cfg, mode="training", shuffle=False)

    mesh = build_mesh(cfg)  # global mesh over all 8 devices
    assert mesh.devices.size == 4 * pcnt

    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE)
    img = jnp.zeros((cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE), jnp.float32)
    rois = jnp.zeros((cfg.BATCH_SIZE, cfg.TRAIN_ROIS_PER_IMAGE, 4), jnp.float32)
    variables = jax.jit(lambda: net.init(jax.random.PRNGKey(0), img, rois,
                                         train=False))()

    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        replicate_tree(jax.device_get(variables["params"]), mesh),
        replicate_tree(jax.device_get(variables.get("batch_stats", {})), mesh),
        tx)

    losses = []
    for _ in range(2):
        batch = shard_batch(gen[0], mesh)  # local [4,...] → global [8,...]
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[1] < losses[0] * 1.5  # sane trajectory, not exploding
    assert distributed.is_chief() == (pidx == 0)
    print(f"RESULT {losses[-1]:.6f} {jax.device_count()}", flush=True)


if __name__ == "__main__":
    main()
