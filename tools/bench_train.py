"""Training throughput benchmark (images/sec on one device).

Two measurements at the Shapes 224² operating point:

(a) device-only step rate: ONE jitted program scanning N train steps with the
    batch resident on device, delta-timed exactly like bench.py (N2−N1
    cancels the fixed dispatch and fetch overhead);
(b) end-to-end epoch rate: the real path — BatchGenerator target encoding +
    DevicePrefetcher upload + train step — timed by wall clock with a final
    metrics fetch forcing completion. The uint8-image + mini-mask batch
    ships ~1.3 MB/step where float32 images + full-size masks took ~18.

Usage: python tools/bench_train.py [--batch 16] [--images 256] [--legacy]
  --legacy re-measures with float32 images + full-canvas masks for a
  before/after comparison.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


def setup(batch_size: int, config_name: str = "shapes"):
    from mask_yolo_tpu.config import CocoStyleConfig
    from mask_yolo_tpu.data.shapes import ShapesConfig
    from mask_yolo_tpu.models.network import MaskYoloNet

    base = {"shapes": ShapesConfig, "coco416": CocoStyleConfig}[config_name]

    class BenchConfig(base):
        BATCH_SIZE = batch_size
        COMPUTE_DTYPE = "bfloat16"

    cfg = BenchConfig()
    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE,
                      compute_dtype=cfg.COMPUTE_DTYPE,
                      image_hw=tuple(cfg.IMAGE_SHAPE[:2]))
    img = jnp.zeros((batch_size, *cfg.IMAGE_SHAPE), jnp.float32)
    rois = jnp.zeros((batch_size, cfg.TRAIN_ROIS_PER_IMAGE, 4), jnp.float32)
    variables = jax.jit(lambda r, i, ro: net.init(r, i, ro, train=False))(
        jax.random.PRNGKey(0), img, rois)
    return cfg, net, variables


def make_scan_steps(net, cfg, tx):
    """One jitted program running n train steps back to back on device."""
    from mask_yolo_tpu import pipelines
    import optax

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(state, batch, n):
        def body(carry, _):
            st = carry

            def compute(params):
                variables = {"params": params, "batch_stats": st.batch_stats}
                return pipelines.training_loss(
                    net, variables, batch, cfg,
                    seen=st.step.astype(jnp.float32), train=True,
                    mutable_stats=True)

            (loss, (metrics, updates)), grads = jax.value_and_grad(
                compute, has_aux=True)(st.params)
            upd, opt_state = tx.update(grads, st.opt_state, st.params)
            from mask_yolo_tpu.train.state import TrainState
            st = TrainState(params=optax.apply_updates(st.params, upd),
                            batch_stats=updates.get("batch_stats",
                                                    st.batch_stats),
                            opt_state=opt_state, step=st.step + 1)
            return st, loss

        state, losses = jax.lax.scan(body, state, None, length=n)
        return jnp.sum(losses)

    return run


def make_scan_fwd(net, cfg):
    """Loss forward only (no grad, no update) — the fwd side of the
    training-roofline split."""
    from mask_yolo_tpu import pipelines

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(state, batch, n):
        def body(carry, _):
            st = carry
            variables = {"params": st.params, "batch_stats": st.batch_stats}
            loss, _ = pipelines.training_loss(
                net, variables, batch, cfg,
                seen=st.step.astype(jnp.float32), train=True,
                mutable_stats=True)
            return st, loss

        state, losses = jax.lax.scan(body, state, None, length=n)
        return jnp.sum(losses)

    return run


def bench_device_steps(cfg, net, variables, n1=2, n2=8, reps=3,
                       fwd_only=False):
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
    from mask_yolo_tpu.data.shapes import ShapesDataset
    from mask_yolo_tpu.train import state as state_lib

    ds = ShapesDataset()
    ds.load_shapes(cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE[:2], seed=0)
    ds.prepare()
    gen = BatchGenerator(preload_dataset(ds, cfg), cfg, mode="training",
                         shuffle=False)
    batch = {k: jax.device_put(v) for k, v in gen[0].items()}

    tx = state_lib.make_optimizer(1e-3, cfg)
    run = make_scan_fwd(net, cfg) if fwd_only else make_scan_steps(net, cfg, tx)

    def fresh_state():
        return state_lib.create_train_state(
            jax.tree.map(jnp.array, variables["params"]),
            jax.tree.map(jnp.array, variables.get("batch_stats", {})), tx)

    float(run(fresh_state(), batch, n1))  # compile + warm
    float(run(fresh_state(), batch, n2))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(fresh_state(), batch, n1))
        t1 = time.perf_counter()
        float(run(fresh_state(), batch, n2))
        t2 = time.perf_counter()
        dt = (t2 - t1) - (t1 - t0)
        if dt > 0:
            best = min(best, dt / (n2 - n1))
    return cfg.BATCH_SIZE / best


def bench_epoch(cfg, net, variables, n_images: int, legacy: bool,
                epochs: int = 3, augment: bool = False):
    """End-to-end epoch wall-clock: generator + prefetch upload + steps.

    augment=True times the quality-run path instead: the endless
    data_generator re-loading + re-augmenting every image per epoch
    (default_augmenter), host work the native C++ kernels accelerate."""
    from mask_yolo_tpu.data.pipeline import (BatchGenerator,
                                             GeneratorEpochSource,
                                             data_generator, preload_dataset)
    from mask_yolo_tpu.data.shapes import ShapesDataset
    from mask_yolo_tpu.train import state as state_lib
    from mask_yolo_tpu.train import trainer as trainer_lib

    if legacy:
        class LegacyCfg(type(cfg)):
            USE_MINI_MASK = False
        cfg = LegacyCfg()

    ds = ShapesDataset()
    ds.load_shapes(n_images, *cfg.IMAGE_SHAPE[:2], seed=0)
    ds.prepare()
    if augment:
        from mask_yolo_tpu.data.augment import default_augmenter

        endless = data_generator(ds, cfg, shuffle=True,
                                 augmentation=default_augmenter(seed=0),
                                 seed=0)
        gen = GeneratorEpochSource(endless, n_images // cfg.BATCH_SIZE, cfg)
    else:
        data = preload_dataset(ds, cfg)
        if legacy:  # round-1-style float32 image payload
            data = dict(data, images=data["images"].astype(np.float32) / 255.0)
        gen = BatchGenerator(data, cfg, mode="training", shuffle=False)
    bytes_per_step = sum(np.asarray(v).nbytes for v in gen[0].values())

    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(net, cfg, tx, mode="training")
    state = state_lib.create_train_state(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables.get("batch_stats", {})), tx)

    state, _ = trainer_lib.run_epoch(step, state, gen, verbose=False)  # warm
    best = float("inf")
    for _ in range(epochs):
        t0 = time.perf_counter()
        state, metrics = trainer_lib.run_epoch(step, state, gen, verbose=False)
        dt = time.perf_counter() - t0
        best = min(best, dt)
    n_steps = len(gen)
    return {
        "images_per_sec": n_steps * cfg.BATCH_SIZE / best,
        "sec_per_step": best / n_steps,
        "mb_per_step": bytes_per_step / 1e6,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--legacy", action="store_true",
                    help="round-1-style batches (float32 + full masks)")
    ap.add_argument("--augment", action="store_true",
                    help="time the augmented data_generator path")
    ap.add_argument("--skip-device", action="store_true")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="also time the loss forward alone (fwd/bwd split "
                         "for the training roofline)")
    ap.add_argument("--config", default="shapes",
                    choices=["shapes", "coco416"],
                    help="coco416 = CocoStyleConfig (81 classes, 416²) on "
                         "Shapes geometry — the training-roofline row "
                         "for the scale-out operating point")
    args = ap.parse_args()

    cfg, net, variables = setup(args.batch, args.config)
    out = {"batch_size": args.batch, "config": args.config,
           "device": str(jax.devices()[0])}
    if not args.skip_device:
        ips = bench_device_steps(cfg, net, variables)
        out["device_only_images_per_sec"] = round(ips, 1)
        print(f"# device-only train step: {ips:,.0f} img/s", file=sys.stderr,
              flush=True)
        if args.split:
            fwd = bench_device_steps(cfg, net, variables, fwd_only=True)
            out["fwd_only_images_per_sec"] = round(fwd, 1)
            out["fwd_us_per_img"] = round(1e6 / fwd, 1)
            out["step_us_per_img"] = round(1e6 / ips, 1)
            out["bwd_opt_over_fwd"] = round(fwd / ips - 1, 2)
            print(f"# fwd-only: {fwd:,.0f} img/s", file=sys.stderr, flush=True)
    if not args.skip_e2e:
        e = bench_epoch(cfg, net, variables, args.images, args.legacy,
                        augment=args.augment)
        out.update({
            "e2e_images_per_sec": round(e["images_per_sec"], 1),
            "e2e_sec_per_step": round(e["sec_per_step"], 4),
            "mb_per_step": round(e["mb_per_step"], 2),
            "payload": ("legacy_f32_fullmask" if args.legacy
                        else "uint8_minimask"),
            "augmented_generator": bool(args.augment),
        })
    print(json.dumps(out))


if __name__ == "__main__":
    main()
