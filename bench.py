"""Benchmark: end-to-end detect throughput at 224² on one NVIDIA GPU.

Measures the full image→boxes+masks pipeline (backbone → YOLO head → decode
→ NMS → top-K → ROIAlign → mask head → mask paste, one XLA program) in
bfloat16 and int8 at batch 128, and prints ONE JSON line naming the device:

  {"metric": ..., "value": N, "unit": "images/sec", "per_path": {...},
   "device": {"platform", "kind", "count", "card"}}

Without a GPU it exits non-zero; a path that fails fails the run.

Timing: each timed unit is ONE jitted program that runs the detect
pipeline N times under `lax.scan`, chained by a tiny data dependence (so
XLA cannot CSE the iterations away) and returning a scalar checksum whose
fetch forces completion. Per-iteration time is the *delta* between an
N2-iteration and an N1-iteration run, which cancels the fixed dispatch and
fetch overhead. The benchmark's cells, its metrics and its comparison
against the float32 reference are ROADMAP A1.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

def _setup(backbone: str | None = None):
    from mask_yolo_tpu.data.shapes import ShapesConfig
    from mask_yolo_tpu.models.network import MaskYoloNet

    class BenchConfig(ShapesConfig):
        COMPUTE_DTYPE = "bfloat16"

    if backbone:
        BenchConfig.BACKBONE = backbone
    cfg = BenchConfig()
    net = MaskYoloNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                      top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                      mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE,
                      compute_dtype=cfg.COMPUTE_DTYPE,
                      image_hw=tuple(cfg.IMAGE_SHAPE[:2]))
    rng = jax.random.PRNGKey(0)
    img = jnp.zeros((1, *cfg.IMAGE_SHAPE), jnp.float32)
    variables = jax.jit(lambda r, i, ro: net.init(r, i, ro, train=False))(
        rng, img, jnp.zeros((1, 8, 4), jnp.float32))
    return cfg, net, variables


def _checksum(out):
    """Small scalar summarizing every output (forces full pipeline)."""
    s = jnp.float32(0)
    for v in jax.tree_util.tree_leaves(out):
        s = s + jnp.sum(v.astype(jnp.float32)) * jnp.float32(1e-6)
    return s


def make_repeat_fn(net, cfg):
    from mask_yolo_tpu import pipelines

    @functools.partial(jax.jit, static_argnums=(2,))
    def repeat(variables, images, n):
        def body(carry, _):
            img, acc = carry
            # nested jit is inlined into the enclosing trace
            out = pipelines.detect_outputs(net, variables, img, cfg)
            s = _checksum(out)
            # data dependence: perturb input by an invisible epsilon so the
            # scan body cannot be hoisted/CSE'd; value is numerically zero
            img = img + s * jnp.float32(1e-30)
            return (img, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (images, jnp.float32(0)), None,
                                   length=n)
        return acc

    return repeat


def make_repeat_fn_int8(det):
    """Same harness over the int8 quantized detect pipeline (quant.py)."""
    from mask_yolo_tpu import pipelines

    cfg = det.config

    @functools.partial(jax.jit, static_argnums=(1,))
    def repeat(images, n):
        def body(carry, _):
            img, acc = carry
            out = pipelines.detect_from_callables(det.trunk, det.select_masks,
                                                  img, cfg)
            s = _checksum(out)
            img = img + s * jnp.float32(1e-30)
            return (img, acc + s), None
        (_, acc), _ = jax.lax.scan(body, (images, jnp.float32(0)), None,
                                   length=n)
        return acc

    return repeat


def bench_detect(call, cfg, batch_size: int,
                 n1: int = 2, n2: int = 52, reps: int = 5):
    """call(images, n) -> scalar; returns images/sec via delta timing.

    n2 - n1 sets the measured chain length; it must be long enough that the
    device-time delta dwarfs the host's timing jitter. The median (not
    min) of the per-rep deltas is reported: with delta timing, min
    systematically picks the most noise-deflated sample.
    """
    images = jax.device_put(
        jnp.asarray(np.random.RandomState(0)
                    .rand(batch_size, *cfg.IMAGE_SHAPE).astype(np.float32)))
    float(call(images, n1))  # compile + warm
    float(call(images, n2))
    deltas = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(call(images, n1))
        t1 = time.perf_counter()
        float(call(images, n2))
        t2 = time.perf_counter()
        dt = (t2 - t1) - (t1 - t0)
        if dt > 0:
            deltas.append(dt / (n2 - n1))
    if not deltas:
        raise RuntimeError("timing deltas were non-positive")
    return batch_size / float(np.median(deltas))


def card() -> str:
    """The GPUs' names and power limits, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"])
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX runs on {devices[0].platform}")
    device = {"platform": devices[0].platform, "kind": devices[0].device_kind,
              "count": len(devices), "card": card()}
    print(f"# {device}", file=sys.stderr, flush=True)

    from mask_yolo_tpu.quant import QuantizedDetector
    from mask_yolo_tpu.utils.compile_cache import enable as _enable_cache

    _enable_cache()
    cfg, net, variables = _setup(args.backbone)
    repeat_bf16 = make_repeat_fn(net, cfg)
    calib = np.random.RandomState(1).rand(8, *cfg.IMAGE_SHAPE).astype(np.float32)
    det = QuantizedDetector.from_variables(jax.device_get(variables), cfg,
                                           calib, net=net)
    paths = {
        "bf16": lambda im, n: repeat_bf16(variables, im, n),
        "int8": make_repeat_fn_int8(det),
    }
    bs = 128
    per_path = {}
    for path, call in paths.items():
        per_path[path] = bench_detect(call, cfg, bs)
        print(f"# {path} batch {bs}: {per_path[path]:,.0f} img/s",
              file=sys.stderr, flush=True)
    best_path = max(per_path, key=per_path.get)
    result = {
        "metric": "images/sec end-to-end detect (224², boxes+masks, "
                  "one device)",
        "value": round(per_path[best_path], 1),
        "unit": "images/sec",
        "batch_size": bs,
        "path": best_path,
        "per_path": {k: round(v, 1) for k, v in per_path.items()},
        "device": device,
    }
    if args.backbone:
        result["backbone"] = args.backbone
    print(json.dumps(result))


if __name__ == "__main__":
    main()
