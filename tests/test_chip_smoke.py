"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions run end to end at TinyConfig size."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_alone(cwd, env_platform="cpu"):
    env = dict(os.environ, JAX_PLATFORMS=env_platform)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run_alone(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs 1 GPU" in r.stderr


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_alone(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from conftest import TinyConfig

    work = str(tmp_path_factory.mktemp("smoke"))
    cfg = chip_smoke.smoke_config(TinyConfig, BATCH_SIZE=8)
    ref_cfg = chip_smoke.smoke_config(TinyConfig, BATCH_SIZE=8,
                                      COMPUTE_DTYPE="float32")
    infer_cfg = chip_smoke.smoke_config(TinyConfig, BATCH_SIZE=8,
                                        COMPUTE_DTYPE="bfloat16")
    train_ds = chip_smoke.dense_dataset(cfg, 16, seed=0)
    val_ds = chip_smoke.dense_dataset(cfg, 8, seed=1)
    model, path = chip_smoke.phase_train(cfg, train_ds, val_ds, work,
                                         epochs=6)
    infer = chip_smoke.load_inference(infer_cfg, path)
    ref = chip_smoke.load_inference(ref_cfg, path)
    return dict(cfg=infer_cfg, infer=infer, ref=ref, work=work,
                imgs=chip_smoke.images_u8(val_ds, 8), train_ds=train_ds)


def test_smoke_detect_phases(tiny):
    chip_smoke.phase_detect(tiny["infer"], tiny["ref"], tiny["imgs"])
    chip_smoke.phase_infer_yolo(tiny["infer"], tiny["imgs"][0])


def test_smoke_int8_serve_export(tiny):
    from mask_yolo_tpu import MaskYOLO

    m = MaskYOLO(mode="inference", config=tiny["cfg"])
    m.params, m.batch_stats = tiny["infer"].params, tiny["infer"].batch_stats
    imgs = tiny["imgs"]
    calib = chip_smoke.images_u8(tiny["train_ds"], 4).astype(np.float32) / 255
    chip_smoke.phase_int8(m, tiny["ref"], calib,
                          imgs.astype(np.float32) / 255.0)
    chip_smoke.phase_serve(m, tiny["cfg"], imgs, batch=8, n_requests=3)
    chip_smoke.phase_export(m, imgs, tiny["work"], ["cpu"])


def test_smoke_int8_cases_cover_every_kind(tiny):
    """At 416² (int8 depthwise, bf16 stem) the cases still name the stem,
    and every kind a CocoStyle graph has."""
    from conftest import TinyConfig
    from mask_yolo_tpu import quant

    class DW(TinyConfig):
        QUANT_DW_INT8 = True
        QUANT_STEM_BF16 = True

    graph = quant.build_layer_graph(tiny["infer"].variables, DW())
    for layer in (l for part in graph.values() if part for l in part):
        if layer.quantize:
            quant._quantize_layer_kernel(layer, np.asarray(layer.kernel))
    kinds = set(chip_smoke.int8_conv_cases(graph, DW()))
    assert kinds == {"stem 3x3/s2 cin=3", "depthwise 3x3/s1",
                     "depthwise 3x3/s2", "pointwise 1x1", "dense 3x3",
                     "mask 3x3", "mask 1x1"}, kinds


def test_smoke_resnet_phase(tiny):
    from conftest import TinyConfig

    cfg = chip_smoke.smoke_config(TinyConfig, BACKBONE="resnet50_fpn",
                                  BATCH_SIZE=2, COMPUTE_DTYPE="bfloat16")
    ref_cfg = chip_smoke.smoke_config(TinyConfig, BACKBONE="resnet50_fpn",
                                      BATCH_SIZE=2)
    chip_smoke.phase_resnet(cfg, ref_cfg, tiny["imgs"][:2], tiny["work"])


def test_smoke_four_device_phase(tiny):
    """The --four paths on four of the virtual CPU devices."""
    from conftest import TinyConfig

    cfg = chip_smoke.smoke_config(TinyConfig, BATCH_SIZE=8, TRAIN_BN=False)
    chip_smoke.phase_four(cfg, tiny["train_ds"], tiny["imgs"], n_devices=4)


def test_smoke_one_card_sequence(monkeypatch, tmp_path):
    """run_one_card end to end at TinyConfig size (export lowered for the
    CPU instead of cuda)."""
    from conftest import TinyConfig

    monkeypatch.setattr(chip_smoke, "WORKDIR", str(tmp_path))
    chip_smoke.run_one_card(0, base=TinyConfig, batch=8, train_batch=8,
                            n_train=16, epochs=6, export_platforms=("cpu",))
