"""The main path imports neither flax nor orbax: after a training step, a
save and a detect in a fresh interpreter, sys.modules holds no flax* or
orbax* module."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys, tempfile
import numpy as np
sys.path.insert(0, "tests")
from conftest import TinyConfig
from mask_yolo_tpu import MaskYOLO
from mask_yolo_tpu.data.shapes import ShapesDataset

class Cfg(TinyConfig):
    NUM_CLASSES = 4
    LABELS = ["background", "square", "circle", "triangle"]
    BATCH_SIZE = 8

ds = ShapesDataset(); ds.load_shapes(8, 64, 64, seed=0); ds.prepare()
work = tempfile.mkdtemp(dir=sys.argv[1])
m = MaskYOLO(mode="training", config=Cfg(), model_dir=work)
m.train(ds, ds, learning_rate=1e-3, epochs=1, layers="all", verbose=False)
m.save_weights(work + "/w")
inf = MaskYOLO(mode="inference", config=Cfg())
inf.load_weights(work + "/w")
inf.detect(ds.load_image(0), display=False)
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("flax", "orbax"))))
"""


def test_main_path_imports_no_flax_or_orbax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
