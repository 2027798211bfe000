"""Production serving: dynamic-batching inference for the detect pipeline.

The reference has no serving story (edit-a-script drivers only;
/root/reference/example/*). Serving an accelerator well has three rules:
keep ONE compiled program (static batch shape — recompiles stall the
device), feed it full batches (it is throughput hardware), and decouple
request latency from batch assembly. This module implements the standard
recipe:

  * `BatchingExecutor` — requests enqueue individually; a worker thread
    drains up to `batch_size` of them (waiting at most `max_delay_s` after
    the first), pads the batch to the static shape, runs the jitted
    image→boxes+masks pipeline ONCE, and fans the per-request results back
    out through futures. Padded slots cost compute but never a recompile.
  * `InferenceServer` — a stdlib ThreadingHTTPServer speaking npy in /
    JSON out (zero extra dependencies), so many HTTP clients share one
    executor and therefore one device program.

Works with any object exposing `detect_batch(images_uint8_or_float)` →
the fixed-shape dict of pipelines.detect_outputs — i.e. a MaskYOLO in
inference mode, quantized or not.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class QueueFullError(RuntimeError):
    """Raised by submit() when the bounded request queue is at capacity —
    backpressure instead of unbounded memory growth under overload. The HTTP
    layer maps it to 429."""


def mask_to_rle(mask: np.ndarray) -> list[int]:
    """Row-major run-length encoding of a bool mask (starts with the run
    length of zeros, like COCO's uncompressed RLE counts)."""
    flat = np.asarray(mask, dtype=bool).ravel(order="C")
    if flat.size == 0:
        return []
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat[0]:  # RLE starts with a zero-run by convention
        counts = [0] + counts
    return [int(c) for c in counts]


def rle_to_mask(counts: list[int], shape) -> np.ndarray:
    """Inverse of mask_to_rle."""
    flat = np.zeros(int(np.prod(shape)), dtype=bool)
    pos, val = 0, False
    for c in counts:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape(shape)


class BatchingExecutor:
    """Dynamic batching over a fixed-shape detect pipeline.

    model: object with detect_batch(images [B, H, W, 3]) → fixed-shape dict.
    batch_size: the STATIC batch the device program was compiled for.
    max_delay_s: max time to hold the first request of a batch while
    waiting for more (the latency/throughput knob).
    """

    def __init__(self, model, config, batch_size: int | None = None,
                 max_delay_s: float = 0.005, score_threshold: float = 0.35,
                 max_queue: int | None = None):
        self.model = model
        self.config = config
        self.batch_size = int(batch_size or config.BATCH_SIZE)
        self.max_delay_s = float(max_delay_s)
        self.score_threshold = float(score_threshold)
        # bounded queue: overload rejects fast (QueueFullError → HTTP 429)
        # instead of accumulating requests whose deadline already passed
        self.max_queue = int(max_queue) if max_queue else 8 * self.batch_size
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "rejected": 0}
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def submit(self, image: np.ndarray, include_masks: bool = False) -> Future:
        """Enqueue one uint8 [H, W, 3] image; resolves to a JSON-able dict
        {detections: [{box, class_id, label, score, mask_rle?}], ...}."""
        image = np.asarray(image)
        h, w, c = self.config.IMAGE_SHAPE
        if image.shape != (h, w, c):
            raise ValueError(f"expected image shape {(h, w, c)}, got {image.shape}")
        if image.dtype != np.uint8:
            raise ValueError(f"expected uint8 image, got {image.dtype}")
        if self._stop.is_set():
            raise RuntimeError("executor is shut down")
        fut: Future = Future()
        try:
            self._queue.put_nowait((time.monotonic(), image, include_masks, fut))
        except queue.Full:
            self.stats["rejected"] += 1
            raise QueueFullError(
                f"request queue full ({self.max_queue} pending)") from None
        return fut

    def detect(self, image: np.ndarray, include_masks: bool = False,
               timeout: float | None = 600.0) -> dict:
        """Blocking convenience wrapper around submit(). The generous default
        timeout covers a first-call XLA compile (minutes on a cold cache);
        call warmup() at startup to keep it off the request path."""
        return self.submit(image, include_masks).result(timeout=timeout)

    def warmup(self, timeout: float | None = 600.0) -> None:
        """Run one dummy batch through the WORKER thread so the compile (and
        any per-thread device-runtime initialization) happens before traffic
        arrives."""
        h, w, c = self.config.IMAGE_SHAPE
        self.detect(np.zeros((h, w, c), np.uint8), timeout=timeout)

    def shutdown(self):
        """Stop the worker (no sentinel: the worker polls _stop with a short
        get timeout, so a mid-batch shutdown can't swallow a wakeup token and
        leave the thread blocked forever) and fail any still-queued requests."""
        self._stop.set()
        self._worker.join(timeout=5.0)
        while True:
            try:
                *_, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("executor is shut down"))

    @property
    def latency_ms(self) -> dict:
        """p50/p99 end-to-end (submit → result) latency over the last 1024
        requests, in milliseconds."""
        lat = sorted(self._latencies)
        if not lat:
            return {"p50": None, "p99": None, "n": 0}
        return {"p50": 1e3 * lat[len(lat) // 2],
                "p99": 1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                "n": len(lat)}

    # -- worker ---------------------------------------------------------------

    def _run(self):
        h, w, c = self.config.IMAGE_SHAPE
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            items = [item]
            deadline = time.monotonic() + self.max_delay_s
            while len(items) < self.batch_size:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remain))
                except queue.Empty:
                    break

            batch = np.zeros((self.batch_size, h, w, c), np.uint8)
            for i, (_, img, _, _) in enumerate(items):
                batch[i] = img
            try:
                out = {k: np.asarray(v)
                       for k, v in self.model.detect_batch(batch).items()}
            except Exception as e:  # propagate to every waiting client
                for *_, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self.stats["requests"] += len(items)
            self.stats["batches"] += 1
            self.stats["padded_slots"] += self.batch_size - len(items)
            now = time.monotonic()
            for i, (t0, _, include_masks, fut) in enumerate(items):
                if not fut.done():
                    fut.set_result(self._format(out, i, include_masks))
                    self._latencies.append(now - t0)

    def _format(self, out, i: int, include_masks: bool) -> dict:
        labels = list(getattr(self.config, "LABELS", []) or [])
        keep = out["valid"][i] & (out["scores"][i] >= self.score_threshold)
        dets = []
        for j in np.where(keep)[0]:
            cid = int(out["classes"][i, j])
            d = {
                "box": [float(v) for v in out["boxes"][i, j]],
                "class_id": cid,
                "label": labels[cid] if cid < len(labels) else str(cid),
                "score": float(out["scores"][i, j]),
            }
            if include_masks:
                d["mask_rle"] = mask_to_rle(out["masks"][i, j])
                d["mask_shape"] = list(out["masks"][i, j].shape)
            dets.append(d)
        return {"detections": dets}


class InferenceServer:
    """Minimal HTTP front end over a BatchingExecutor (stdlib only).

    POST /detect      body: .npy-serialized uint8 [H, W, 3] image
                      header X-Include-Masks: 1 → RLE masks in the response
    GET  /healthz     liveness + stats
    """

    def __init__(self, executor: BatchingExecutor, host: str = "127.0.0.1",
                 port: int = 0):
        import http.server
        import io

        ex = executor

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True, "stats": ex.stats,
                                      "batch_size": ex.batch_size,
                                      "max_queue": ex.max_queue,
                                      "latency_ms": ex.latency_ms})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/detect":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    image = np.load(io.BytesIO(self.rfile.read(n)),
                                    allow_pickle=False)
                    include = self.headers.get("X-Include-Masks", "0") == "1"
                    result = ex.detect(image, include_masks=include)
                    self._reply(200, result)
                except QueueFullError as e:
                    self._reply(429, {"error": str(e)})
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
