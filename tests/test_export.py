"""AOT export tests: the detect pipeline serialized to a StableHLO artifact
(export.py) must reload and reproduce the live jitted path exactly.

The reference has no export/deployment format at all (every driver script
rebuilds the Keras graph from Python + .h5 — /root/reference/myolo/model.py:
756-803); jax.export is the replacement this suite covers."""

import numpy as np
import pytest

from mask_yolo_tpu.export import ExportedDetector


@pytest.fixture(scope="module")
def tiny_model():
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO

    class Cfg(TinyConfig):
        BATCH_SIZE = 2
        OBJ_THRESHOLD = 0.0  # untrained net: keep everything

    cfg = Cfg()
    return MaskYOLO(mode="inference", config=cfg), cfg


def test_symbolic_batch_round_trip(tiny_model, tmp_path, rng):
    model, cfg = tiny_model
    path = tmp_path / "detect.mytpu"
    header = model.export_model(path)
    assert header["batch_size"] is None
    assert header["image_shape"] == list(cfg.IMAGE_SHAPE)

    det = ExportedDetector.load(path)
    # one symbolic-batch artifact serves different batch sizes, and each
    # matches the live jitted pipeline bit-for-bit
    for b in (1, 3):
        imgs = (rng.rand(b, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
        got = {k: np.asarray(v) for k, v in det.detect_batch(imgs).items()}
        ref = {k: np.asarray(v) for k, v in model.detect_batch(imgs).items()}
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            assert np.array_equal(got[k], ref[k]), k


def test_fixed_batch_artifact_rejects_other_batches(tiny_model, tmp_path, rng):
    model, cfg = tiny_model
    path = tmp_path / "detect_b2.mytpu"
    header = model.export_model(path, batch_size=2)
    assert header["batch_size"] == 2

    det = ExportedDetector.load(path)
    imgs = (rng.rand(2, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    out = det.detect_batch(imgs)
    assert np.asarray(out["boxes"]).shape == (2, cfg.DETECTION_MAX_INSTANCES, 4)
    with pytest.raises(ValueError, match="batch_size=2"):
        det.detect_batch(imgs[:1])


def test_float_input_is_quantized_to_wire_dtype(tiny_model, tmp_path, rng):
    """Callers holding [0, 1] floats can feed a uint8-exported artifact:
    the loader rounds to the wire dtype, equivalent to uint8 capture."""
    model, cfg = tiny_model
    path = tmp_path / "detect.mytpu"
    model.export_model(path)
    det = ExportedDetector.load(path)

    u8 = (rng.rand(2, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    got = det.detect_batch(u8.astype(np.float32) / 255.0)
    ref = det.detect_batch(u8)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_multi_platform_artifact_runs_on_cpu(tiny_model, tmp_path, rng):
    """Cross-platform lowering: one artifact exported for BOTH cpu and cuda
    (the deployment pattern — export on a dev box, serve on either) loads
    and runs on this CPU process and matches the live model."""
    model, cfg = tiny_model
    path = tmp_path / "detect_multi.mytpu"
    header = model.export_model(path, platforms=["cpu", "cuda"])
    assert sorted(header["platforms"]) == ["cpu", "cuda"]

    det = ExportedDetector.load(path)
    imgs = (rng.rand(2, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    got = det.detect_batch(imgs)
    ref = model.detect_batch(imgs)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_int8_path_exports_after_quantize(tmp_path, rng):
    """After quantize(), export_model serializes the ACTIVE int8 pipeline
    (consistent with detect/detect_batch serving int8 then) and the artifact
    matches the live quantized path exactly."""
    from conftest import TinyConfig

    from mask_yolo_tpu import MaskYOLO

    class Cfg(TinyConfig):
        BATCH_SIZE = 2
        OBJ_THRESHOLD = 0.0

    cfg = Cfg()
    model = MaskYOLO(mode="inference", config=cfg)
    calib = rng.rand(2, *cfg.IMAGE_SHAPE).astype(np.float32)
    model.quantize(calib)

    path = tmp_path / "detect_int8.mytpu"
    header = model.export_model(path)
    assert header["compute_path"] == "int8"

    det = ExportedDetector.load(path)
    imgs = (rng.rand(3, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    got = det.detect_batch(imgs)
    ref = model.detect_batch(imgs.astype(np.float32) / 255.0)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_load_rejects_foreign_files(tmp_path):
    p = tmp_path / "not_an_export.bin"
    p.write_bytes(b"PNG....definitely not a detect artifact")
    with pytest.raises(ValueError, match="bad magic"):
        ExportedDetector.load(p)


def test_exported_detector_serves(tiny_model, tmp_path, rng):
    """ExportedDetector satisfies the serve.py detect_batch contract — a
    deployment process can put the artifact straight behind the batching
    executor with no model code."""
    from mask_yolo_tpu.serve import BatchingExecutor

    model, cfg = tiny_model
    path = tmp_path / "detect.mytpu"
    model.export_model(path, batch_size=cfg.BATCH_SIZE)
    det = ExportedDetector.load(path)

    # the artifact header carries everything the executor needs from Config
    shim = det.serve_config()
    assert shim.IMAGE_SHAPE == list(cfg.IMAGE_SHAPE)
    assert shim.BATCH_SIZE == cfg.BATCH_SIZE
    assert shim.LABELS == list(cfg.LABELS)
    with pytest.raises(ValueError, match="pins batch_size"):
        det.serve_config(batch_size=cfg.BATCH_SIZE + 1)

    ex = BatchingExecutor(det, shim, max_delay_s=0.2, score_threshold=0.0)
    try:
        imgs = (rng.rand(3, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
        results = [f.result(timeout=120) for f in [ex.submit(im) for im in imgs]]
        # the pipeline is per-image independent, so each request's result
        # matches a direct call regardless of how the executor batched it
        direct = model.detect_batch(imgs[:cfg.BATCH_SIZE])
        keep = np.asarray(direct["valid"])[0]
        assert len(results[0]["detections"]) == int(keep.sum())
    finally:
        ex.shutdown()


def test_float32_artifact_normalizes_integer_input(tiny_model, tmp_path, rng):
    """ADVICE r3 (medium): an artifact exported with input_dtype='float32'
    expects pre-normalized [0, 1] input; uint8 callers (the serve wire
    format) must be normalized by the loader, not bare-cast — a bare cast
    fed 0-255 floats into the graph and produced garbage detections."""
    model, cfg = tiny_model
    path = tmp_path / "detect_f32.mytpu"
    header = model.export_model(path, input_dtype="float32")
    assert header["input_dtype"] == "float32"
    det = ExportedDetector.load(path)

    u8 = (rng.rand(2, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    got = det.detect_batch(u8)  # integer input → /255 normalization
    ref = det.detect_batch(u8.astype(np.float32) / 255.0)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_export_needs_no_flatbuffers(tiny_model, tmp_path, rng, monkeypatch):
    """jax's own Exported.serialize/deserialize need the flatbuffers
    package, which a GPU serving host may lack; the container format
    stores the StableHLO bytecode and the signature itself."""
    import jax

    def refuse(*_, **__):
        raise ImportError("flatbuffers is not installed")

    monkeypatch.setattr(jax.export.Exported, "serialize", refuse)
    monkeypatch.setattr(jax.export, "deserialize", refuse)
    model, cfg = tiny_model
    path = tmp_path / "detect_nofb.mytpu"
    model.export_model(path, batch_size=2)
    det = ExportedDetector.load(path)
    imgs = (rng.rand(2, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    got = det.detect_batch(imgs)
    ref = model.detect_batch(imgs)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k
