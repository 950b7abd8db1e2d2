"""``python -m pmv_tpu_torch.tools.validate_zoo`` against the JAX package's
``tools/validate_zoo.py`` on the CPU.

Four seeded AVI videos of 40 frames of 48^2 (as tests/test_validate_zoo.py
writes them), a test CSV, the tiny MViTv2 yaml of that test, and a
``.pyth`` of the port's model from a seed, whose state_dict is in
PySlowFast's names (``{"model_state": ..., "epoch": 1}``, the released
files' layout). The JAX tool reads the file through its torch importer and
tests 2 views of each video; the port's tool, on the same file, CSV and
videos, gives the same top-1 and top-5: it exits 0 with ``--expected-top1``
at JAX's top-1 and a tolerance of 0, and 1, with ``"pass": false``, 50
points off. The tool's refusal of stats without a top-1 (detection,
multi-label) and a dense-crop sweep's verdict on its best crop, on stats
given to it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.engine import test as ptest
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.native import binding
from pmv_tpu_torch.tools import validate_zoo
from torch_port_util import one_thread  # noqa: F401

T, S = 4, 32
ROOT = os.path.join(os.path.dirname(__file__), "..")

YAML = """
MODEL:
  MODEL_NAME: MViT
  ARCH: mvit
  NUM_CLASSES: 11
  DROPOUT_RATE: 0.0
MVIT:
  DEPTH: 3
  EMBED_DIM: 8
  NUM_HEADS: 1
  DIM_MUL: [[1, 2.0]]
  HEAD_MUL: [[1, 2.0]]
  POOL_KVQ_KERNEL: [3, 3, 3]
  POOL_KV_STRIDE_ADAPTIVE: [1, 4, 4]
  POOL_Q_STRIDE: [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]]
  DROPPATH_RATE: 0.0
  MODE: conv
  CLS_EMBED_ON: False
  USE_ABS_POS: False
  REL_POS_SPATIAL: True
  REL_POS_TEMPORAL: True
  QKV_BIAS: True
  RESIDUAL_POOLING: True
  DIM_MUL_IN_ATT: True
DATA:
  PATH_TO_DATA_DIR: {root}
  PATH_PREFIX: {vids}
  PM_SUBSET: _pmv400
  PATH_LABEL_SEPARATOR: ","
  NUM_FRAMES: {t}
  SAMPLING_RATE: 2
  TRAIN_CROP_SIZE: {s}
  TEST_CROP_SIZE: {s}
TEST:
  ENABLE: True
  DATASET: kinetics
  BATCH_SIZE: 8
  NUM_ENSEMBLE_VIEWS: 2
  NUM_SPATIAL_CROPS: 1
OUTPUT_DIR: {out}
TPU:
  COMPUTE_DTYPE: float32
"""


@pytest.fixture
def zoo_setup(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        frames = rng.integers(0, 255, (40, 48, 48, 3), dtype=np.uint8)
        name = f"v{i}.avi"
        binding.write_test_video(vids / name, frames, fps=30)
        rows.append(f"{name},{i % 2}")
    (tmp_path / "test_pmv400.csv").write_text("\n".join(rows) + "\n")
    yaml_path = tmp_path / "TINY_MVITV2.yaml"
    yaml_path.write_text(YAML.format(root=tmp_path, vids=vids, t=T, s=S,
                                     out=tmp_path / "out").lstrip())
    cfg = get_cfg()
    cfg.merge_from_file(str(yaml_path))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    ckpt = tmp_path / "ckpt_epoch_00001.pyth"
    torch.save({"model_state": model.state_dict(), "epoch": 1}, str(ckpt))
    return yaml_path, ckpt


def _verdict(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_port_tool_matches_jax_tool(zoo_setup, capsys, one_thread):  # noqa: F811
    yaml_path, ckpt = zoo_setup
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import validate_zoo as jax_validate_zoo
    finally:
        sys.path.pop(0)
    base = ["--cfg", str(yaml_path), "--ckpt", str(ckpt)]
    assert jax_validate_zoo.run(jax_validate_zoo.parse_args(base)) == 0
    want = _verdict(capsys)
    assert want["expected_top1"] is None and 0.0 <= want["top1"] <= 100.0

    argv = base + ["--device", "cpu", "--expected-top1", str(want["top1"]), "--tolerance", "0"]
    with pytest.raises(SystemExit) as exit_:
        validate_zoo.main(argv)
    got = _verdict(capsys)
    assert exit_.value.code == 0 and got["pass"] is True
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    assert got["config"] == "TINY_MVITV2.yaml" and got["diff"] == 0.0

    far = want["top1"] + 50.0
    argv = base + ["--device", "cpu", "--expected-top1", str(far), "--opts", "TEST.BATCH_SIZE",
                   "4"]
    assert validate_zoo.run(validate_zoo.parse_args(argv)) == 1
    got = _verdict(capsys)
    assert got["pass"] is False and got["top1"] == want["top1"]
    assert got["diff"] == round(want["top1"] - far, 3)


def test_zoo_table_and_stats_handling(monkeypatch, tmp_path, capsys):
    """The JAX tool's table; a dense-crop sweep's best crop; stats without a
    top-1 refused with the JAX tool's message."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import validate_zoo as jax_validate_zoo
    finally:
        sys.path.pop(0)
    assert validate_zoo.ZOO == jax_validate_zoo.ZOO
    argv = ["--cfg", os.path.join(ROOT, "configs", "Kinetics", "MVITv2_S_16x4.yaml"),
            "--ckpt", str(tmp_path / "k400.pyth"), "--device", "cpu"]
    seen = []

    def sweep(cfg, device=None):
        seen.append((cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE, device))
        return [{"top1_acc": "80.60", "top5_acc": "94.00"},
                {"top1_acc": "81.20", "top5_acc": "94.50"}]

    monkeypatch.setattr(ptest, "test", sweep)
    assert validate_zoo.run(validate_zoo.parse_args(argv)) == 0
    verdict = _verdict(capsys)
    assert seen == [(str(tmp_path / "k400.pyth"), "pytorch", "cpu")]
    assert (verdict["top1"], verdict["top5"], verdict["expected_top1"]) == (81.2, 94.5, 81.0)
    assert verdict["diff"] == 0.2 and verdict["pass"] is True
    monkeypatch.setattr(ptest, "test", lambda cfg, device=None: {"map": 0.5})
    with pytest.raises(SystemExit, match="report mAP and are not supported"):
        validate_zoo.run(validate_zoo.parse_args(argv))
