"""Smoke run of the main path on NVIDIA GPUs, in one process.

    python chip_smoke.py            # every one-card phase, on the first GPU
    python chip_smoke.py --four     # only the four-card paths and their
                                    # one-card comparisons

The system is driven through the entry points a user calls, at the full
width of CocoStyleConfig (416², 81 classes, MobileNet trunk, MASK_TOP_K=48,
bf16) on the seeded synthetic 81-class scenes of data/dense_shapes.py, with
random weights from --seed. One-card phases:

  1. train   MaskYOLO.train a few steps at batch 16; save_weights and
             load_weights into an inference model.
  2. detect  detect_batch (batch 32, bf16) and detect on one uint8 image,
             against the same pipeline in float32 at HIGHEST precision.
  3. detection only   infer_yolo on the same image.
  4. int8    quantize + detect_batch; every int8 conv kind bit-equal to the
             CPU; the trunk within the int8 bound of the f32 reference.
  5. serve   BatchingExecutor + InferenceServer on 127.0.0.1 answer HTTP
             requests with masks.
  6. export  export_model(platforms=["cuda"]) + ExportedDetector.load
             against the live jitted detect.
  7. resnet50_fpn   detect at batch 1 against its f32 HIGHEST reference.

No phase catches its own failure: any exception ends the run with a
non-zero exit and no result line. Without a GPU the script exits non-zero
before any phase. The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.

Untrained weights score every detection far below the shipped 0.35
OBJ_THRESHOLD, so the smoke configs set it to 0: all DETECTION_MAX_INSTANCES
slots are live and the mask branch runs on MASK_TOP_K of them, the load of
a dense scene.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np

# Tolerances, each with its reason.
TOL = {
    # bf16 keeps 8 significant bits (rounding ≤ 2^-9 ≈ 0.2% per value); the
    # trunk rounds its activations at ~30 convs and the errors add roughly
    # in quadrature, ≈ 1–2% relative L2. 5% leaves room without hiding a
    # wrong layer, which shows as O(100%).
    "bf16_rel_l2": 0.05,
    # a detection is the same detection if its box overlaps at IoU ≥ 0.9
    # with the same class
    "match_iou": 0.9,
    # untrained scores lie close together, so bf16 noise swaps detections
    # across the top-K and MASK_TOP_K cut-offs; most must still match
    "matched_frac": 0.75,
    # mean |Δ mask probability| of matched detections: bf16 logit noise
    # plus the crop shift of an IoU ≥ 0.9 box
    "mask_prob_mean_abs": 0.05,
    # int8 trunk: max |grid_q − grid_f| < 0.1·max|grid_f| + 0.05, the bound
    # tests/test_quant.py holds the int8 path to
    "int8_rel": 0.1,
    "int8_abs": 0.05,
    # export: the artifact and the live jit are two compilations of one
    # program; float results may differ in the last bits
    "export_box_px": 1e-2,
    "export_score": 1e-4,
    "export_mask_frac": 1e-3,
    # four cards vs one: the per-device batch differs, so convs may take
    # other algorithms; the last-bit differences can flip a discrete choice
    # (a proposal's target assignment), which moves the loss a little
    "four_loss_rel": 1e-2,
    # Adam's first step moves each parameter by ≈ lr·sign(g); entries whose
    # gradient is within noise of 0 (e.g. the class channels of absent
    # classes), or touched by a flipped assignment, may take the other
    # sign. Being scale-free, that step checks the direction of the
    # reduced gradient, not its scale.
    "four_param_abs": 1e-5,
    "four_param_agree": 0.95,
}

REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, ".chip_smoke")


def log(msg: str):
    print(msg, flush=True)


def check(ok, what):
    """Raise when a smoke check fails (kept under python -O, unlike
    assert)."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# configurations and data
# ---------------------------------------------------------------------------


def smoke_config(base=None, **overrides):
    """CocoStyleConfig (or `base`) with the smoke's overrides: OBJ_THRESHOLD
    0 (see the module docstring) plus `overrides`."""
    if base is None:
        from mask_yolo_tpu.config import CocoStyleConfig as base
    attrs = {"OBJ_THRESHOLD": 0.0, **overrides}
    return type("SmokeConfig", (base,), attrs)()


def dense_dataset(cfg, count: int, seed: int):
    from mask_yolo_tpu.data.dense_shapes import DenseShapesDataset

    h, w = cfg.IMAGE_SHAPE[:2]
    hi = min(48, int(cfg.MAX_GT_INSTANCES))
    ds = DenseShapesDataset()
    ds.load_dense(count, h, w, seed=seed, num_classes=cfg.NUM_CLASSES - 1,
                  min_instances=max(1, hi // 2), max_instances=hi)
    ds.prepare()
    return ds


def images_u8(ds, n: int):
    return np.stack([ds.load_image(i) for i in range(n)]).astype(np.uint8)


def _trunk_fn(model):
    net = model.net
    import jax

    return jax.jit(lambda v, im: net.apply(v, im, train=False,
                                           method=net.pick_trunk()))


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _iou(a, b):
    """[N, 4] × [M, 4] xyxy → [N, M]."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = lambda z: (z[:, 2] - z[:, 0]) * (z[:, 3] - z[:, 1])
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _check_detect_contract(out, cfg, batch: int):
    k = cfg.DETECTION_MAX_INSTANCES
    h, w = cfg.IMAGE_SHAPE[:2]
    check(out["boxes"].shape == (batch, k, 4), out["boxes"].shape)
    check(out["masks"].shape == (batch, k, h, w), out["masks"].shape)
    check(out["masks"].dtype == bool, out["masks"].dtype)
    check(np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all(),
          "non-finite boxes or scores")
    check(out["valid"].any(), "no live detection")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_train(cfg, train_ds, val_ds, workdir: str, epochs: int,
                seed: int = 0):
    """Train through MaskYOLO.train, check the loss falls, print the step's
    memory analysis, save the weights. Returns (model, weights path)."""
    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
    from mask_yolo_tpu.parallel.mesh import shard_batch

    m = MaskYOLO(mode="training", config=cfg, seed=seed,
                 model_dir=os.path.join(workdir, "train"))
    losses = []
    t0 = time.perf_counter()
    state = m.train(train_ds, val_ds, learning_rate=1e-3, epochs=epochs,
                    layers="all", verbose=False,
                    custom_callbacks=[lambda e, tm, vl, s:
                                      losses.append(tm["loss"])])
    log(f"train: {epochs} epochs x {len(train_ds.image_ids) // cfg.BATCH_SIZE}"
        f" steps at batch {cfg.BATCH_SIZE}, {time.perf_counter() - t0:.1f} s"
        f" with compiles; last-step loss per epoch {losses}")
    check(np.isfinite(losses).all(), losses)
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    batch = BatchGenerator(preload_dataset(train_ds, cfg), cfg,
                           mode="training")[0]
    compiled = m._train_step.lower(state, shard_batch(batch, m.mesh)).compile()
    log(f"train step memory_analysis: {compiled.memory_analysis()}")
    del state

    path = os.path.join(workdir, "weights")
    m.save_weights(path)
    return m, path


def load_inference(cfg, path: str, seed: int = 1):
    """MaskYOLO in inference mode with the weights at `path`."""
    from mask_yolo_tpu import MaskYOLO

    m = MaskYOLO(mode="inference", config=cfg, seed=seed)
    m.load_weights(path)
    return m


def compare_detect(model, ref, images, tol=TOL):
    """model's detect_batch against ref's (float32 config) under HIGHEST
    precision: trunk outputs by relative L2, detections by box matching and
    the mask probabilities of matched detections. Returns a summary dict."""
    import jax

    cfg = model.config
    out = jax.device_get(model.detect_batch(images))
    _check_detect_contract(out, cfg, images.shape[0])
    grid, fmap = jax.device_get(_trunk_fn(model)(model.variables, images))
    with jax.default_matmul_precision("highest"):
        ref_out = jax.device_get(ref.detect_batch(images))
        grid_r, fmap_r = jax.device_get(_trunk_fn(ref)(ref.variables, images))
    summary = {"grid_rel_l2": _rel_l2(grid, grid_r)}
    for i, (f, fr) in enumerate(zip(jax.tree.leaves(fmap),
                                    jax.tree.leaves(fmap_r))):
        summary[f"fmap{i}_rel_l2"] = _rel_l2(f, fr)
    for k, v in summary.items():
        check(v <= tol["bf16_rel_l2"], (k, v))

    # detections: each reference detection with a mask slot, matched to a
    # same-class detection of `model` at IoU ≥ match_iou
    kp = int(cfg.MASK_TOP_K or cfg.DETECTION_MAX_INSTANCES)
    h, w = cfg.IMAGE_SHAPE[:2]
    pairs = []
    n_ref = 0
    for b in range(images.shape[0]):
        ri = np.where(ref_out["valid"][b, :kp])[0]
        ti = np.where(out["valid"][b, :kp])[0]
        n_ref += len(ri)
        if not len(ri) or not len(ti):
            continue
        iou = _iou(ref_out["boxes"][b, ri], out["boxes"][b, ti])
        same = ref_out["classes"][b, ri][:, None] == out["classes"][b, ti][None]
        iou = np.where(same, iou, 0.0)
        for a, j in enumerate(iou.argmax(1)):
            if iou[a, j] >= tol["match_iou"]:
                pairs.append((b, ri[a], ti[j]))
    frac = len(pairs) / max(n_ref, 1)
    summary["matched"] = f"{len(pairs)}/{n_ref}"
    check(n_ref and frac >= tol["matched_frac"], summary)

    # mask probabilities of the matched pairs, each from its own box
    slots = {}
    arrays = {k: (np.zeros((images.shape[0], kp, 4), np.float32),
                  np.zeros((images.shape[0], kp), np.int32))
              for k in ("test", "ref")}
    for b, i_ref, i_test in pairs:
        s = slots[b] = slots.get(b, -1) + 1
        for key, src, i in (("test", out, i_test), ("ref", ref_out, i_ref)):
            arrays[key][0][b, s] = src["boxes"][b, i] / [w, h, w, h]
            arrays[key][1][b, s] = src["classes"][b, i]
    p_test = _mask_probs(model, images, *arrays["test"])
    with jax.default_matmul_precision("highest"):
        p_ref = _mask_probs(ref, images, *arrays["ref"])
    live = np.zeros(p_test.shape[:2], bool)
    for b, s in slots.items():
        live[b, :s + 1] = True
    summary["mask_prob_mean_abs"] = float(
        np.abs(p_test[live] - p_ref[live]).mean())
    check(summary["mask_prob_mean_abs"] <= tol["mask_prob_mean_abs"], summary)
    return out, summary


def _mask_probs(model, images, rois, classes):
    """[B, K] normalized boxes + classes → [B, K, mh, mw] mask
    probabilities of `model` (trunk and mask branch, class-selected)."""
    import jax

    from mask_yolo_tpu.pipelines import select_class

    net, cfg = model.net, model.config

    def fn(v, im, r, c):
        fmap = net.apply(v, im, train=False, method=net.pick_trunk())[1]
        masks = net.apply(v, r, fmap, train=False, method=net.mask_branch)
        return select_class(masks, c, cfg.NUM_CLASSES)

    return np.asarray(jax.jit(fn)(model.variables, images, rois, classes))


def phase_detect(model, ref, imgs_u8):
    """detect_batch against the f32 reference, then detect() on one uint8
    image."""
    cfg = model.config
    _, summary = compare_detect(model, ref, imgs_u8.astype(np.float32) / 255.0)
    log(f"detect ({cfg.COMPUTE_DTYPE}, batch {imgs_u8.shape[0]}) vs float32 "
        f"HIGHEST: {summary}")
    res = model.detect(imgs_u8[0], display=False, cs_threshold=0.0)[0]
    n = len(res["bboxes"])
    h, w = cfg.IMAGE_SHAPE[:2]
    check(n > 0 and res["full_masks"].shape == (h, w, n),
          f"detect(): {n} detections, masks {res['full_masks'].shape}")
    log(f"detect(one uint8 image): {n} detections with [H, W, N] masks")


def phase_infer_yolo(model, img_u8):
    boxes = model.infer_yolo(img_u8, display=False)
    check(len(boxes) > 0, "infer_yolo returned no box")
    for b in boxes:
        check(b.xmin <= b.xmax and b.ymin <= b.ymax
              and 0.0 <= b.get_score() <= 1.0
              and 0 <= b.get_label() < model.config.NUM_CLASSES, vars(b))
    log(f"infer_yolo: {len(boxes)} boxes")


def int8_conv_cases(graph, cfg, batch: int = 8):
    """One int8 conv of each kind in the quantized graph, with its real
    weights and input shape: {kind: (x_shape, w_q, strides, groups)}. The
    stem gets an int8 case even where the config keeps it in bf16."""
    h, w = cfg.IMAGE_SHAPE[:2]
    cases = {}

    def walk(part, layers, shape):
        for layer in layers:
            kh, kw, _, co = layer.kernel.shape
            n, hh, ww, c = shape
            w_q = layer.w_q
            if part == "trunk" and layer.name == "conv1":
                kind = f"stem {kh}x{kw}/s{layer.strides[0]} cin={c}"
                if w_q is None:
                    k = np.asarray(layer.kernel, np.float32)
                    s = np.maximum(np.abs(k).reshape(-1, co).max(0), 1e-12)
                    w_q = np.clip(np.round(k / (s / 127.0)), -127,
                                  127).astype(np.int8)
            elif layer.groups > 1:
                kind = f"depthwise {kh}x{kw}/s{layer.strides[0]}"
            elif part == "mask":
                kind = f"mask {kh}x{kw}"
            else:
                kind = f"{'pointwise' if kh == 1 else 'dense'} {kh}x{kw}"
            if w_q is not None:
                cases.setdefault(kind, ((n, hh, ww, c), np.asarray(w_q),
                                        tuple(layer.strides), layer.groups))
            shape = (n, -(-hh // layer.strides[0]), -(-ww // layer.strides[1]),
                     co)
        return shape

    if graph["trunk"] is not None:
        c4 = walk("trunk", graph["trunk"], (batch, h, w, 3))
        walk("neck", graph["neck"], c4)
        walk("yolo", graph["yolo"], c4)
    rois = batch * int(cfg.MASK_TOP_K or cfg.DETECTION_MAX_INSTANCES)
    p = cfg.MASK_POOL_SIZE
    walk("mask", [l for l in graph["mask"] if l.kind != "out_d2s"],
         (rois, p, p, graph["mask"][0].kernel.shape[2]))
    return cases


def _count_ops(closed_jaxpr):
    """(int8×int8→int32 dot_generals, conv_general_dilated) in a jaxpr and
    every jaxpr nested in it."""
    counts = {"gemm": 0, "conv": 0}

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if (name == "dot_general"
                    and all(v.aval.dtype == np.int8 for v in eqn.invars)
                    and eqn.outvars[0].aval.dtype == np.int32):
                counts["gemm"] += 1
            elif name == "conv_general_dilated":
                counts["conv"] += 1
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(closed_jaxpr.jaxpr)
    return counts


def phase_int8(model, ref, calib, images):
    """quantize + detect_batch; every int8 conv kind's int32 accumulators
    equal the CPU's; no quantized layer runs in another form; the int8
    trunk within the test_quant bound of the f32 HIGHEST reference."""
    import jax

    from mask_yolo_tpu.ops.int8_conv import conv_int8

    cfg = model.config
    qdet = model.quantize(calib)
    out = jax.device_get(model.detect_batch(images))
    _check_detect_contract(out, cfg, images.shape[0])

    cpu = jax.devices("cpu")[0]
    conv = jax.jit(conv_int8, static_argnums=(2, 3))
    rng = np.random.default_rng(0)
    for kind, (shape, w_q, strides, groups) in int8_conv_cases(
            qdet.graph, cfg).items():
        x = rng.integers(-127, 128, shape, dtype=np.int8)
        got = np.asarray(conv(x, w_q, strides, groups))
        want = np.asarray(conv(jax.device_put(x, cpu), jax.device_put(w_q, cpu),
                               strides, groups))
        check(got.dtype == np.int32 and np.array_equal(got, want),
              f"int8 {kind}: accumulators differ from the CPU's")
        log(f"int8 {kind}: x {shape}, w {w_q.shape}: int32 accumulators "
            f"bit-equal to {cpu.platform}")

    layers = [l for part in qdet.graph.values() if part for l in part]
    int8 = [l for l in layers if l.quantize and l.w_q is not None]
    counts = _count_ops(jax.make_jaxpr(qdet.detect_fn())(images))
    want = {"gemm": sum(l.groups == 1 for l in int8),
            "conv": len(layers) - len(int8)}
    check(counts == want, f"detect program ops {counts}, expected {want}")
    log(f"int8 detect program: {want['gemm']} int8 GEMMs, "
        f"{len(int8) - want['gemm']} int8 depthwise, {want['conv']} "
        f"bf16 convs ({len(layers)} layers)")

    grid_q = np.asarray(jax.jit(lambda im: qdet.trunk(im)[0])(images))
    with jax.default_matmul_precision("highest"):
        grid_f = np.asarray(_trunk_fn(ref)(ref.variables, images)[0])
    err = float(np.abs(grid_q - grid_f).max())
    scale = float(np.abs(grid_f).max())
    bound = TOL["int8_rel"] * scale + TOL["int8_abs"]
    check(err < bound, f"int8 grid error {err} >= {bound}")
    log(f"int8 trunk vs float32 HIGHEST: max |Δgrid| {err:.4g} < {bound:.4g}")
    return qdet


def time_detect(model, images, reps: int = 10) -> float:
    """Median ms of model.detect_batch(images) after warm-up, each call
    ending in block_until_ready."""
    import jax

    images = jax.device_put(images)
    for _ in range(2):
        jax.block_until_ready(model.detect_batch(images))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(model.detect_batch(images))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def phase_serve(model, cfg, imgs_u8, batch: int, n_requests: int = 4):
    """BatchingExecutor + InferenceServer on 127.0.0.1 in this process:
    concurrent HTTP requests come back with RLE masks."""
    from concurrent.futures import ThreadPoolExecutor

    from mask_yolo_tpu.serve import (BatchingExecutor, InferenceServer,
                                     rle_to_mask)

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    ex = BatchingExecutor(model, cfg, batch_size=batch, score_threshold=0.0)
    srv = None
    try:
        ex.warmup()
        srv = InferenceServer(ex, host="127.0.0.1", port=0).start()
        url = f"http://127.0.0.1:{srv.port}"

        def post(i):
            buf = io.BytesIO()
            np.save(buf, imgs_u8[i])
            req = urllib.request.Request(f"{url}/detect", data=buf.getvalue(),
                                         method="POST",
                                         headers={"X-Include-Masks": "1"})
            with opener.open(req, timeout=600) as r:
                return r.status, json.loads(r.read())

        with ThreadPoolExecutor(n_requests) as pool:
            replies = list(pool.map(post, range(n_requests)))
        h, w = cfg.IMAGE_SHAPE[:2]
        for status, body in replies:
            dets = body["detections"]
            check(status == 200 and dets, f"HTTP {status}: {str(body)[:200]}")
            mask = rle_to_mask(dets[0]["mask_rle"], dets[0]["mask_shape"])
            check(mask.shape == (h, w), mask.shape)
        with opener.open(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["ok"], health)
        log(f"serve: {n_requests} HTTP requests answered with masks "
            f"({[len(b['detections']) for _, b in replies]} detections), "
            f"stats {health['stats']}")
    finally:
        if srv is not None:
            srv.stop()
        ex.shutdown()


def phase_export(model, imgs_u8, workdir: str, platforms):
    """export_model + ExportedDetector.load against the live jitted
    detect."""
    import jax

    from mask_yolo_tpu.export import ExportedDetector

    path = os.path.join(workdir, "detect.export")
    header = model.export_model(path, platforms=platforms)
    det = ExportedDetector.load(path)
    got = jax.device_get(det.detect_batch(imgs_u8))
    live = jax.device_get(model.detect_batch(imgs_u8))
    same = all(np.array_equal(np.asarray(got[k]), np.asarray(live[k]))
               for k in live)
    for k in ("classes", "valid"):
        check(np.array_equal(got[k], live[k]), f"export: {k} differ")
    box = float(np.abs(got["boxes"] - live["boxes"]).max())
    score = float(np.abs(got["scores"] - live["scores"]).max())
    masks = float((got["masks"] != live["masks"]).mean())
    check(box <= TOL["export_box_px"] and score <= TOL["export_score"]
          and masks <= TOL["export_mask_frac"],
          f"export vs live: |Δbox| {box}, |Δscore| {score}, mask pixels "
          f"differing {masks}")
    log(f"export ({header['compute_path']}, platforms {header['platforms']}): "
        f"artifact {'bit-equal to' if same else 'within tolerance of'} the "
        f"live detect (|Δbox| {box:.3g} px, |Δscore| {score:.3g}, mask "
        f"pixels differing {masks:.3g})")


def phase_resnet(cfg, ref_cfg, imgs_u8, workdir: str, seed: int = 0):
    """The resnet50_fpn trunk: detect against its f32 HIGHEST reference."""
    from mask_yolo_tpu import MaskYOLO

    m = MaskYOLO(mode="inference", config=cfg, seed=seed)
    path = os.path.join(workdir, "resnet_weights")
    m.save_weights(path)
    ref = load_inference(ref_cfg, path)
    _, summary = compare_detect(m, ref, imgs_u8.astype(np.float32) / 255.0)
    log(f"resnet50_fpn detect ({cfg.COMPUTE_DTYPE}, batch "
        f"{imgs_u8.shape[0]}) vs float32 HIGHEST: {summary}")


def phase_four(cfg, train_ds, imgs_u8, seed: int = 0, n_devices: int = 4):
    """The multi-card paths against one card: the train step on a (4, 1)
    and a (2, 2) (data, model) mesh, and the data-parallel detect."""
    import jax
    from jax.sharding import Mesh

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.pipeline import BatchGenerator, preload_dataset
    from mask_yolo_tpu.parallel.mesh import place_tree, shard_batch
    from mask_yolo_tpu.train import state as state_lib
    from mask_yolo_tpu.train import trainer as trainer_lib

    devices = np.asarray(jax.devices()[:n_devices])
    half = n_devices // 2

    def mesh(dp, mp):
        return Mesh(devices[:dp * mp].reshape(dp, mp), ("data", "model"))

    m = MaskYOLO(mode="training", config=cfg, seed=seed)
    host = jax.device_get(m.variables)
    tx = state_lib.make_optimizer(1e-3, cfg)
    step = trainer_lib.make_train_step(m.net, cfg, tx, mode="training")
    batch = BatchGenerator(preload_dataset(train_ds, cfg), cfg,
                           mode="training")[0]
    results = {}
    for shape in ((1, 1), (n_devices, 1), (half, 2)):
        mh = mesh(*shape)
        state = state_lib.create_train_state(
            place_tree(host["params"], mh), place_tree(host["batch_stats"], mh),
            tx)
        state, metrics = step(state, shard_batch(batch, mh))
        results[shape] = (float(metrics["loss"]),
                          np.concatenate([np.ravel(x) for x in jax.tree.leaves(
                              jax.device_get(state.params))]))
    loss1, p1 = results[(1, 1)]
    for shape in ((n_devices, 1), (half, 2)):
        loss, p = results[shape]
        rel = abs(loss - loss1) / abs(loss1)
        agree = float((np.abs(p - p1) <= TOL["four_param_abs"]).mean())
        check(np.isfinite(loss) and rel <= TOL["four_loss_rel"]
              and agree >= TOL["four_param_agree"],
              f"train step on mesh {shape}: loss {loss} vs {loss1}, params "
              f"agreeing {agree}")
        log(f"train step, global batch {cfg.BATCH_SIZE}, mesh (data, model)="
            f"{shape} vs one device: loss {loss:.6f} vs {loss1:.6f} (rel "
            f"{rel:.2e}), {agree:.4%} of {p.size} params within "
            f"{TOL['four_param_abs']}, max |Δ| {np.abs(p - p1).max():.3g}")

    infer = MaskYOLO(mode="inference", config=cfg, seed=seed)
    infer.params, infer.batch_stats = host["params"], host["batch_stats"]
    out_n = jax.device_get(infer.detect_batch(imgs_u8, mesh=mesh(n_devices, 1)))
    per = imgs_u8.shape[0] // n_devices
    one = mesh(1, 1)
    parts = [jax.device_get(infer.detect_batch(imgs_u8[i * per:(i + 1) * per],
                                               mesh=one))
             for i in range(n_devices)]
    out_1 = {k: np.concatenate([p[k] for p in parts]) for k in out_n}
    same = all(np.array_equal(out_n[k], out_1[k]) for k in out_n)
    for k in ("classes", "valid"):
        check(np.array_equal(out_n[k], out_1[k]), f"sharded detect: {k} differ")
    box = float(np.abs(out_n["boxes"] - out_1["boxes"]).max())
    masks = float((out_n["masks"] != out_1["masks"]).mean())
    check(box <= TOL["export_box_px"] and masks <= TOL["export_mask_frac"],
          f"sharded detect: |Δbox| {box}, mask pixels differing {masks}")
    log(f"detect_batch(mesh={n_devices}x1) vs one device on the same "
        f"{per}-image shards: {'bit-equal' if same else 'within tolerance'} "
        f"(|Δbox| {box:.3g} px, mask pixels differing {masks:.3g})")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _memory(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "not reported"
    mib = lambda n: f"{n / 2 ** 20:.1f} MiB"
    return (f"arguments {mib(ma.argument_size_in_bytes)}, outputs "
            f"{mib(ma.output_size_in_bytes)}, temporaries "
            f"{mib(ma.temp_size_in_bytes)}, code "
            f"{mib(ma.generated_code_size_in_bytes)}")


def run_one_card(seed: int, base=None, batch: int = 32, train_batch: int = 16,
                 n_train: int = 32, epochs: int = 4,
                 export_platforms=("cuda",)):
    """Phases 1–7. `base` (default CocoStyleConfig) and the sizes exist so
    that the same sequence can be rehearsed at a tiny size on the CPU."""
    import jax

    train_cfg = smoke_config(base, BATCH_SIZE=train_batch)
    infer_cfg = smoke_config(base, BATCH_SIZE=batch, COMPUTE_DTYPE="bfloat16")
    ref_cfg = smoke_config(base, BATCH_SIZE=batch, COMPUTE_DTYPE="float32")
    train_ds = dense_dataset(train_cfg, n_train, seed)
    val_ds = dense_dataset(train_cfg, batch, seed + 1)

    model, path = phase_train(train_cfg, train_ds, val_ds, WORKDIR, epochs,
                              seed=seed)
    infer = load_inference(infer_cfg, path)
    for a, b in zip(jax.tree.leaves(model.params), jax.tree.leaves(infer.params)):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              "load_weights did not restore the trained weights")
    log("save_weights -> load_weights: trained weights restored exactly")
    ref = load_inference(ref_cfg, path)

    imgs = images_u8(val_ds, batch)
    images = imgs.astype(np.float32) / 255.0
    phase_detect(infer, ref, imgs)
    log(f"detect program memory_analysis: "
        f"{_memory(infer._detect_fn.lower(infer.variables, images).compile())}")
    phase_infer_yolo(infer, imgs[0])
    ms_bf16 = time_detect(infer, images)

    calib = images_u8(train_ds, 8).astype(np.float32) / 255.0
    qdet = phase_int8(infer, ref, calib, images)
    log(f"int8 detect program memory_analysis: "
        f"{_memory(qdet.detect_fn().lower(images).compile())}")
    ms_int8 = time_detect(infer, images)
    kind = jax.devices()[0].device_kind
    h, w = infer_cfg.IMAGE_SHAPE[:2]
    for name, ms in (("bf16", ms_bf16), ("int8", ms_int8)):
        log(f"detect_batch {h}x{w} batch {batch} {name} (plain XLA) on "
            f"{kind}: median {ms:.3f} ms warmed (a smoke timing, not a "
            f"benchmark)")

    phase_serve(infer, infer_cfg, imgs, batch=batch)
    phase_export(infer, imgs, WORKDIR, list(export_platforms))
    phase_resnet(smoke_config(base, BACKBONE="resnet50_fpn", BATCH_SIZE=1,
                              COMPUTE_DTYPE="bfloat16"),
                 smoke_config(base, BACKBONE="resnet50_fpn", BATCH_SIZE=1,
                              COMPUTE_DTYPE="float32"),
                 imgs[:1], WORKDIR, seed=seed)


def run_four_cards(seed: int):
    cfg = smoke_config(BATCH_SIZE=16)
    train_ds = dense_dataset(cfg, 16, seed)
    phase_four(cfg, train_ds, images_u8(dense_dataset(cfg, 32, seed + 1), 32),
               seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their one-card "
                         "comparisons")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the synthetic data")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    need = 4 if args.four else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke.py: needs {need} GPU(s); JAX has {len(devices)} "
              f"{devices[0].platform} device(s)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
        f"({devices[0].platform})")
    from mask_yolo_tpu.utils import compile_cache

    log(f"compile cache: {compile_cache.enable()}")

    shutil.rmtree(WORKDIR, ignore_errors=True)
    os.makedirs(WORKDIR)
    t0 = time.perf_counter()
    try:
        (run_four_cards if args.four else run_one_card)(args.seed)
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
