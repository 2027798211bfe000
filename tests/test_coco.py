"""COCO-JSON loader tests (data/coco.py): RLE codecs, segmentation decode,
a full Dataset→COCO-JSON→Dataset round trip, and the >MASK_TOP_K-survivors
detect behavior."""

import os

import numpy as np
import pytest

from mask_yolo_tpu.data.coco import (CocoDataset, dataset_to_coco_json,
                                     decode_segmentation, rle_decode_counts,
                                     rle_encode, rle_from_string)


def _rle_to_string(counts):
    """COCO compressed-RLE encoder (test-side inverse of rle_from_string):
    delta-code counts from index 3 on, then emit each as a little-endian
    base-32 varint (5 value bits + continuation bit, ASCII offset 48)."""
    s = []
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        while True:
            ch = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (ch & 0x10)) and \
                   not (x == -1 and (ch & 0x10))
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
            if not more:
                break
    return "".join(s)


def test_rle_round_trip(rng):
    for _ in range(5):
        m = rng.rand(13, 17) > 0.6
        counts = rle_encode(m)
        assert np.array_equal(rle_decode_counts(counts, m.shape), m)
    assert rle_encode(np.zeros((3, 3), bool)) == [9]
    assert rle_encode(np.ones((2, 2), bool)) == [0, 4]


def test_rle_column_major_convention():
    """COCO RLE runs are column-major: a full first COLUMN is one leading
    run of h ones."""
    m = np.zeros((4, 3), bool)
    m[:, 0] = True
    assert rle_encode(m) == [0, 4, 8]


def test_compressed_rle_string_decode(rng):
    for _ in range(10):
        m = rng.rand(20, 11) > 0.5
        counts = rle_encode(m)
        s = _rle_to_string(counts)
        assert rle_from_string(s) == counts
        assert np.array_equal(
            decode_segmentation({"size": list(m.shape), "counts": s}, m.shape), m)


def test_polygon_segmentation_decode():
    seg = [[2.0, 2.0, 8.0, 2.0, 8.0, 6.0, 2.0, 6.0]]  # axis-aligned rect
    m = decode_segmentation(seg, (10, 12))
    assert m[4, 5] and not m[0, 0] and not m[8, 10]
    ys, xs = np.nonzero(m)
    assert 1 <= ys.min() <= 3 and 5 <= ys.max() <= 7
    assert 1 <= xs.min() <= 3 and 7 <= xs.max() <= 9


def test_shapes_to_coco_round_trip(tmp_path, rng):
    """Export the synthetic Shapes dataset to an on-disk COCO-style dataset,
    reload it through CocoDataset: images, masks and class ids must match."""
    from mask_yolo_tpu.data.shapes import ShapesDataset

    src = ShapesDataset()
    src.load_shapes(4, 64, 64, seed=9)
    src.prepare()
    ann = dataset_to_coco_json(src, str(tmp_path))

    d = CocoDataset()
    d.load_coco(ann, str(tmp_path / "images"))
    d.prepare()
    assert d.num_classes == src.num_classes  # BG + square/circle/triangle
    assert sorted(d.class_names) == sorted(src.class_names)
    assert len(d.image_ids) == 4

    for cid in d.image_ids:
        src_id = d.image_info[cid]["id"]
        np.testing.assert_array_equal(d.load_image(cid),
                                      src.load_image(src_id))
        m_src, ids_src = src.load_mask(src_id)
        m_coco, ids_coco = d.load_mask(cid)
        assert m_coco.shape == m_src.shape
        # annotation order is preserved by the exporter
        np.testing.assert_array_equal(m_coco, m_src.astype(bool))
        # class NAMES must agree (internal contiguous ids may permute)
        assert [d.class_names[i] for i in ids_coco] == \
               [src.class_names[i] for i in ids_src]


def test_coco_class_filter_and_crowd(tmp_path):
    """class_ids restriction and iscrowd skipping."""
    import json

    ann = {
        "images": [{"id": 1, "file_name": "a.png", "width": 8, "height": 8}],
        "categories": [{"id": 3, "name": "cat"}, {"id": 7, "name": "dog"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 3, "iscrowd": 0,
             "segmentation": {"size": [8, 8], "counts": [0, 8, 56]}},
            {"id": 2, "image_id": 1, "category_id": 7, "iscrowd": 0,
             "segmentation": {"size": [8, 8], "counts": [8, 8, 48]}},
            {"id": 3, "image_id": 1, "category_id": 3, "iscrowd": 1,
             "segmentation": {"size": [8, 8], "counts": [16, 8, 40]}},
        ],
    }
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(ann))
    from PIL import Image
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a.png")

    d = CocoDataset()
    d.load_coco(str(path), str(tmp_path))
    d.prepare()
    masks, ids = d.load_mask(0)
    assert masks.shape[-1] == 2  # crowd skipped
    assert set(d.class_names) == {"BG", "cat", "dog"}

    d2 = CocoDataset()
    d2.load_coco(str(path), str(tmp_path), class_ids=[7])
    d2.prepare()
    masks2, ids2 = d2.load_mask(0)
    assert masks2.shape[-1] == 1
    assert d2.class_names[ids2[0]] == "dog"

    d3 = CocoDataset()
    d3.load_coco(str(path), str(tmp_path), include_crowd=True)
    d3.prepare()
    assert d3.load_mask(0)[0].shape[-1] == 3


def test_mask_top_k_with_more_survivors(rng):
    """When MORE than MASK_TOP_K boxes survive NMS, the top-kp by score carry
    masks and the remaining survivors stay valid with correct boxes/scores
    but empty masks (the documented fallback, pipelines.py MASK_TOP_K)."""
    import jax.numpy as jnp

    from conftest import TinyConfig
    from mask_yolo_tpu.pipelines import detect_from_callables

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "a", "b", "c"]
        GRID_H, GRID_W = 4, 4
        IMAGE_SHAPE = [128, 128, 3]
        N_BOX = 1
        ANCHORS = [0.5, 0.5]
        DETECTION_MAX_INSTANCES = 12
        MASK_TOP_K = 4
        OBJ_THRESHOLD = 0.3
        DETECTION_NMS_THRESHOLD = 0.5

    cfg = Cfg()
    gh, gw, nb, nc = cfg.GRID_H, cfg.GRID_W, cfg.N_BOX, cfg.NUM_CLASSES
    # one small well-separated box per cell, all high-confidence → 16
    # NMS survivors > kp=4
    grid = np.zeros((1, gh, gw, nb, 5 + nc), np.float32)
    grid[..., 0:2] = 0.0          # sigmoid → 0.5: box centered in its cell
    grid[..., 2:4] = 0.0          # wh = anchor = 0.5 grid units (separated)
    conf_logits = rng.uniform(2.0, 6.0, size=(1, gh, gw, nb))
    grid[..., 4] = conf_logits    # sigmoid > 0.88 everywhere
    grid[..., 5 + 1] = 5.0        # all class 1

    fmap_stub = jnp.zeros((1, 4, 4, 8), jnp.float32)
    mh = cfg.MASK_POOL_SIZE * 2

    def trunk(images):
        return jnp.asarray(grid), fmap_stub

    def select_masks(rois, fmap, classes):
        r = rois.shape[1]
        return jnp.ones((1, r, mh, mh), jnp.float32)  # solid masks

    out = {k: np.asarray(v) for k, v in detect_from_callables(
        trunk, select_masks, jnp.zeros((1, *cfg.IMAGE_SHAPE), jnp.float32),
        cfg).items()}

    k, kp = cfg.DETECTION_MAX_INSTANCES, cfg.MASK_TOP_K
    assert out["valid"][0].sum() == k  # 16 survivors, truncated to K=12 slots
    # survivors are sorted valid-first; the first kp slots carry masks
    has_mask = out["masks"][0].any(axis=(1, 2))
    assert has_mask[:kp].all()
    assert not has_mask[kp:].any()
    # mask-less survivors still report correct boxes/scores (the top-kp are
    # the kp highest scores among survivors)
    scores = out["scores"][0]
    assert scores[:kp].min() >= scores[kp:k][out["valid"][0][kp:k]].max()


def test_detections_to_coco_results_scale_mapping():
    """detections_to_coco_results maps boxes/masks back to the original frame
    through resize_image's per-axis scale and emits scoreable COCO entries."""
    from mask_yolo_tpu.data.coco import (decode_segmentation,
                                         detections_to_coco_results)

    # network frame 64x64, original 128x96 (h, w) -> scale = (0.5, 2/3)
    scale = (64 / 128, 64 / 96)
    boxes = np.array([[16.0, 8.0, 48.0, 32.0]])  # x1 y1 x2 y2, net frame
    masks = np.zeros((64, 64, 1), np.float32)
    masks[8:32, 16:48, 0] = 1.0
    res = detections_to_coco_results(7, boxes, [2], [0.9], masks, scale=scale)
    assert len(res) == 1
    e = res[0]
    assert e["image_id"] == 7 and e["category_id"] == 2
    x, y, w, h = e["bbox"]
    # x: 16 / (2/3) = 24, w: 32 / (2/3) = 48; y: 8/0.5 = 16, h: 24/0.5 = 48
    assert np.allclose([x, y, w, h], [24.0, 16.0, 48.0, 48.0])
    m = decode_segmentation(e["segmentation"], tuple(e["segmentation"]["size"]))
    assert e["segmentation"]["size"] == [128, 96]
    # mask area scales by 1/(sy*sx) = 3 (nearest resize, allow rounding slop)
    assert abs(m.sum() - masks.sum() * 3) / (masks.sum() * 3) < 0.1
    # no scale: identity
    res2 = detections_to_coco_results("img_a", boxes, [1], [0.5])
    assert res2[0]["image_id"] == "img_a"
    assert np.allclose(res2[0]["bbox"], [16.0, 8.0, 32.0, 24.0])


def test_predict_cli_end_to_end(tmp_path):
    """tools/predict.py: weights + PNG directory -> COCO results JSON with
    original-frame geometry (images intentionally NOT at network size)."""
    import json
    import subprocess
    import sys as _sys

    from PIL import Image

    from mask_yolo_tpu import MaskYOLO
    from mask_yolo_tpu.data.shapes import ShapesDataset
    from conftest import TinyConfig

    class Cfg(TinyConfig):
        NUM_CLASSES = 4
        LABELS = ["background", "square", "circle", "triangle"]

    cfg = Cfg()
    m = MaskYOLO(mode="training", config=cfg, model_dir=str(tmp_path / "ckpt"))
    weights = tmp_path / "weights"
    m.save_weights(str(weights))
    # persist the config the way train() does
    (tmp_path / "ckpt").mkdir(exist_ok=True)
    with open(tmp_path / "ckpt" / "config.json", "w") as f:
        json.dump({k: v for k, v in cfg.to_dict().items()
                   if isinstance(v, (int, float, str, bool, list, tuple,
                                     dict, type(None)))}, f, default=str)

    ds = ShapesDataset(); ds.load_shapes(3, 96, 96, seed=3); ds.prepare()
    img_dir = tmp_path / "imgs"; img_dir.mkdir()
    for i in ds.image_ids:
        Image.fromarray(ds.load_image(i)).save(img_dir / f"{i:03d}.png")

    out_json = tmp_path / "res.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [_sys.executable, os.path.join(repo, "tools", "predict.py"),
         "--weights", str(weights),
         "--config-json", str(tmp_path / "ckpt" / "config.json"),
         "--images", str(img_dir), "--out", str(out_json),
         "--batch-size", "2", "--score-threshold", "0.0"],
        # ~43 s uncontended; a loaded host can stretch the subprocess's jit
        # compiles far past that — budget for the worst case
        capture_output=True, text=True, env=env, cwd=repo, timeout=2400)
    assert proc.returncode == 0, proc.stderr[-2000:]
    results = json.loads(out_json.read_text())
    assert isinstance(results, list)
    for e in results:
        assert set(e) >= {"image_id", "category_id", "bbox", "score",
                          "segmentation"}
        # original-frame geometry: 96x96 inputs vs 64x64 net frame
        assert e["segmentation"]["size"] == [96, 96]
        # untrained weights may decode boxes past the canvas; just check the
        # coordinates are in the original frame's order of magnitude (the
        # exact scale mapping is unit-tested above)
        x, y, w, h = e["bbox"]
        assert -96 <= x <= 192 and -96 <= y <= 192 and w <= 288 and h <= 288


def test_coco_category_map_noncontiguous_ids(tmp_path):
    """coco_category_map: internal contiguous indices → original (gappy) COCO
    ids, matching CocoDataset.load_coco's sorted-id class registration."""
    import json

    from mask_yolo_tpu.data.coco import coco_category_map, detections_to_coco_results

    cats = [{"id": 15, "name": "bench"}, {"id": 1, "name": "person"},
            {"id": 90, "name": "toothbrush"}]
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"categories": cats, "images": [],
                               "annotations": []}))
    m = coco_category_map(str(ann))
    assert m == {1: 1, 2: 15, 3: 90}
    res = detections_to_coco_results(
        0, np.array([[0.0, 0.0, 4.0, 4.0]]), [2], [0.7], category_map=m)
    assert res[0]["category_id"] == 15


def test_predict_image_id_disambiguation():
    """assign_image_ids falls back to full paths when stems collide
    ('7.png' vs '007.png', or equal names across directories)."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "predict_tool", os.path.join(repo, "tools", "predict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    assert mod.assign_image_ids(["a/7.png", "a/008.png"]) == [7, 8]
    assert mod.assign_image_ids(["a/7.png", "b/007.png"]) == \
        ["a/7.png", "b/007.png"]
    assert mod.assign_image_ids(["a/x.png", "b/x.png"]) == \
        ["a/x.png", "b/x.png"]
