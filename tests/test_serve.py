"""Serving tests: dynamic batching correctness + the HTTP front end.

The reference has no serving path at all; serve.py is the standard
pattern — one static-batch compiled program fed by a batching queue."""

import concurrent.futures
import io
import json
import urllib.request

import numpy as np
import pytest

from mask_yolo_tpu.serve import (BatchingExecutor, InferenceServer,
                                 mask_to_rle, rle_to_mask)


def test_rle_round_trip(rng):
    for _ in range(5):
        m = rng.rand(13, 17) > 0.6
        assert np.array_equal(rle_to_mask(mask_to_rle(m), m.shape), m)
    assert mask_to_rle(np.zeros((4, 4), bool)) == [16]
    assert mask_to_rle(np.ones((2, 2), bool)) == [0, 4]
    assert mask_to_rle(np.zeros((0, 0), bool)) == []


@pytest.fixture(scope="module")
def served_model():
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO

    class Cfg(TinyConfig):
        BATCH_SIZE = 4
        OBJ_THRESHOLD = 0.0  # untrained net: keep everything

    cfg = Cfg()
    model = MaskYOLO(mode="inference", config=cfg)
    # warm the compiled program once so batching tests aren't timing-skewed
    model.detect_batch(np.zeros((cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE), np.uint8))
    return model, cfg


def test_executor_batches_and_matches_direct(served_model, rng):
    model, cfg = served_model
    ex = BatchingExecutor(model, cfg, max_delay_s=0.2, score_threshold=0.0)
    try:
        images = (rng.rand(6, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
        futs = [ex.submit(im) for im in images]
        results = [f.result(timeout=120) for f in futs]

        # per-request results match a direct padded detect_batch call
        direct = {k: np.asarray(v) for k, v in model.detect_batch(
            np.concatenate([images[:4]])).items()}
        got0 = results[0]["detections"]
        keep = direct["valid"][0]
        assert len(got0) == int(keep.sum())
        for d, j in zip(got0, np.where(keep)[0]):
            assert d["score"] == pytest.approx(float(direct["scores"][0, j]),
                                               abs=1e-6)
            assert d["class_id"] == int(direct["classes"][0, j])

        # 6 requests with batch_size 4 → at most 3 batches, fewer than 6
        assert ex.stats["requests"] == 6
        assert ex.stats["batches"] < 6
    finally:
        ex.shutdown()


def test_executor_rejects_bad_input(served_model):
    model, cfg = served_model
    ex = BatchingExecutor(model, cfg)
    try:
        with pytest.raises(ValueError):
            ex.submit(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(ValueError):
            ex.submit(np.zeros(tuple(cfg.IMAGE_SHAPE), np.float32))
    finally:
        ex.shutdown()


def test_executor_masks_rle(served_model, rng):
    model, cfg = served_model
    ex = BatchingExecutor(model, cfg, score_threshold=0.0)
    try:
        img = (rng.rand(*cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
        res = ex.detect(img, include_masks=True)
        assert res["detections"], "untrained net with threshold 0 keeps slots"
        d = res["detections"][0]
        mask = rle_to_mask(d["mask_rle"], d["mask_shape"])
        assert mask.shape == tuple(cfg.IMAGE_SHAPE[:2])
    finally:
        ex.shutdown()


def test_shutdown_semantics(served_model, rng):
    """shutdown() actually stops the worker; submit() after shutdown raises;
    queued-but-unprocessed requests fail instead of hanging forever."""
    model, cfg = served_model
    ex = BatchingExecutor(model, cfg, max_delay_s=0.01)
    img = (rng.rand(*cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    ex.detect(img, timeout=120)  # worker alive and serving
    ex.shutdown()
    assert not ex._worker.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(img)

    # shutdown with requests still in the queue: futures must resolve (to an
    # error), not hang. Use a model stub that blocks so the queue backs up.
    import threading
    release = threading.Event()

    class SlowModel:
        def detect_batch(self, batch):
            release.wait(timeout=30)
            return model.detect_batch(batch)

    ex2 = BatchingExecutor(SlowModel(), cfg, batch_size=1, max_delay_s=0.0)
    futs = [ex2.submit(img) for _ in range(3)]
    release.set()
    ex2.shutdown()
    for f in futs:
        try:
            f.result(timeout=10)  # processed before shutdown → fine
        except RuntimeError as e:
            assert "shut down" in str(e)  # drained at shutdown → failed fast


def test_queue_backpressure(served_model, rng):
    """A full bounded queue rejects with QueueFullError (→ 429) instead of
    growing without limit."""
    import threading

    from mask_yolo_tpu.serve import QueueFullError

    model, cfg = served_model
    release = threading.Event()

    class BlockedModel:
        def detect_batch(self, batch):
            release.wait(timeout=60)
            return model.detect_batch(batch)

    ex = BatchingExecutor(BlockedModel(), cfg, batch_size=1, max_delay_s=0.0,
                          max_queue=2)
    img = (rng.rand(*cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    try:
        futs = [ex.submit(img)]  # worker picks this up and blocks
        import time
        time.sleep(0.3)
        futs += [ex.submit(img), ex.submit(img)]  # fills queue (maxsize 2)
        with pytest.raises(QueueFullError):
            ex.submit(img)
        assert ex.stats["rejected"] == 1
        release.set()
        for f in futs:
            f.result(timeout=120)
        assert ex.latency_ms["n"] == 3 and ex.latency_ms["p99"] > 0
    finally:
        release.set()
        ex.shutdown()


def test_concurrent_clients_stress(served_model, rng):
    """Many concurrent clients against one executor: every request resolves,
    results are per-request correct (batching never crosses wires)."""
    model, cfg = served_model
    ex = BatchingExecutor(model, cfg, max_delay_s=0.02, score_threshold=0.0)
    try:
        images = (rng.rand(24, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)

        def client(i):
            return i, ex.detect(images[i], timeout=120)

        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            results = dict(pool.map(client, range(24)))
        assert len(results) == 24
        # spot-check wire integrity: request i's result equals a direct
        # single-image run of image i
        for i in (0, 7, 23):
            direct = {k: np.asarray(v) for k, v in model.detect_batch(
                np.broadcast_to(images[i],
                                (cfg.BATCH_SIZE, *cfg.IMAGE_SHAPE))).items()}
            keep = direct["valid"][0]
            dets = results[i]["detections"]
            assert len(dets) == int(keep.sum())
            for d, j in zip(dets, np.where(keep)[0]):
                assert d["score"] == pytest.approx(
                    float(direct["scores"][0, j]), abs=1e-5)
        assert ex.latency_ms["n"] == 24
    finally:
        ex.shutdown()


def test_http_server_end_to_end(served_model, rng):
    model, cfg = served_model
    ex = BatchingExecutor(model, cfg, max_delay_s=0.05, score_threshold=0.0)
    server = InferenceServer(ex, port=0).start()
    try:
        url = f"http://{server.host}:{server.port}"
        with urllib.request.urlopen(f"{url}/healthz") as r:
            health = json.loads(r.read())
        assert health["ok"] and health["batch_size"] == cfg.BATCH_SIZE
        assert "latency_ms" in health and "max_queue" in health

        def post(img):
            buf = io.BytesIO()
            np.save(buf, img)
            req = urllib.request.Request(
                f"{url}/detect", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        images = (rng.rand(5, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            results = list(pool.map(post, images))
        assert all("detections" in r for r in results)
        assert all(len(r["detections"]) > 0 for r in results)

        # bad input → 400
        buf = io.BytesIO()
        np.save(buf, np.zeros((8, 8, 3), np.uint8))
        req = urllib.request.Request(f"{url}/detect", data=buf.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
    finally:
        server.stop()
        ex.shutdown()
