"""The port's host data path against the JAX package's.

- ``temporal``, ``transform`` and ``spatial`` (verbatim numpy copies) on
  seeded inputs and generators: equal outputs, exactly.
- The decode library, built from the port's own source into
  ``build/native/`` (ignored by git, never ``pmv_tpu/native/``): the same
  frames, bit for bit, as ``pmv_tpu.native.binding`` on the same written
  video, at the native size and resized.
- ``Kinetics`` on mixed portrait and landscape videos with rect crops and
  SWITCH_AUTO: test-mode samples (which draw nothing) bit-equal to JAX's in
  frames, label, index and ``pm``; train-mode ``_decode_and_transform``
  bit-equal under the same seeded generator (rect with AUTO_ADJUST, and
  the relative jitter with repeated augmentation).
- The loader: the batch order and ``len`` of a (seed, epoch), per rank;
  ``Synthetic``: the same samples.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

import pmv_tpu.data  # noqa: F401  (registers the JAX datasets)
from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.data import loader as jloader
from pmv_tpu.data import spatial as jspatial
from pmv_tpu.data import temporal as jtemporal
from pmv_tpu.data import transform as jtransform
from pmv_tpu.data.build import build_dataset as jax_build_dataset
from pmv_tpu.native import binding as jbinding
from pmv_tpu_torch.data import loader, spatial, temporal, transform
from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.native import binding
from torch_port_util import port_cfg

ROOT = Path(__file__).resolve().parents[1]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


TEMPORAL_CASES = {
    "random": (temporal.get_start_end_idx, jtemporal.get_start_end_idx,
               (120, 64, -1, 1)),
    "uniform": (temporal.get_start_end_idx, jtemporal.get_start_end_idx,
                (120, 64, 2, 5)),
    "offset": (temporal.get_start_end_idx, jtemporal.get_start_end_idx,
               (120, 64, 3, 5, True)),
    "multi": (temporal.get_multiple_start_end_idx, jtemporal.get_multiple_start_end_idx,
              (300, [32, 32, 32], -1, 1, 5, 40)),
    "indices": (temporal.temporal_sampling_indices, jtemporal.temporal_sampling_indices,
                (50, 3.5, 40.2, 8)),
}


@pytest.mark.parametrize("case", sorted(TEMPORAL_CASES))
def test_temporal_matches_jax(case):
    ours, ref, args = TEMPORAL_CASES[case]
    kwargs = {} if case == "indices" else {"rng": None}
    for seed in range(3):
        if kwargs:
            kwargs = {"rng": np.random.default_rng(seed)}
            ref_kwargs = {"rng": np.random.default_rng(seed)}
        else:
            ref_kwargs = {}
        _equal(ours(*args, **kwargs), ref(*args, **ref_kwargs))


def _clip(seed, shape=(3, 37, 29, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


TRANSFORM_CASES = {
    "short_side_scale": lambda m, x, r: m.short_side_scale(x, 20),
    "jitter": lambda m, x, r: m.random_short_side_scale_jitter(x, 18, 40, rng=r),
    "jitter_inverse": lambda m, x, r: m.random_short_side_scale_jitter(
        x, 18, 40, inverse_uniform_sampling=True, rng=r),
    "random_crop": lambda m, x, r: m.random_crop(x, 16, rng=r),
    "random_crop_rect": lambda m, x, r: m.random_crop_rect(x, [24, 12], rng=r),
    "flip": lambda m, x, r: m.horizontal_flip(0.5, x, rng=r),
    "uniform_crop": lambda m, x, r: [m.uniform_crop(x, 16, i) for i in range(3)],
    "uniform_crop_rect": lambda m, x, r: [m.uniform_crop_rect(x, [24, 12], i)
                                          for i in range(3)],
    "uniform_crop_rect_wide": lambda m, x, r: [
        m.uniform_crop_rect(x.transpose(0, 2, 1, 3), [12, 24], i) for i in range(3)],
    "specified_crop": lambda m, x, r: m.specified_crop(x, 16, rel_center_ords=[0.3, 0.6]),
    "random_resized_crop": lambda m, x, r: m.random_resized_crop(
        x, 24, 12, scale=(0.08, 1.0), ratio=(0.75, 1.333), rng=r),
    "resized_crop_shift": lambda m, x, r: m.random_resized_crop_with_shift(
        x, 24, 12, scale=(0.3, 1.0), ratio=(0.75, 1.333), rng=r),
    "normalize": lambda m, x, r: m.tensor_normalize(x, [0.45] * 3, [0.225] * 3),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transform_matches_jax(case):
    fn = TRANSFORM_CASES[case]
    for seed in range(4):
        x = _clip(seed)
        _equal(fn(transform, x, np.random.default_rng(seed)),
               fn(jtransform, x, np.random.default_rng(seed)))


SPATIAL_CASES = {
    "train_square": dict(spatial_idx=-1, min_scale=30, max_scale=40, crop_size=24),
    "train_rect_adjust": dict(spatial_idx=-1, min_scale=20, max_scale=40,
                              rect_crop_size=[32, 16], auto_adjust=True),
    "train_relative": dict(spatial_idx=-1, crop_size=16, aspect_ratio=[0.75, 1.33],
                           scale=[0.08, 1.0]),
    "test_rect_adjust": dict(spatial_idx=2, min_scale=20, max_scale=20,
                             rect_crop_size=[24, 16], auto_adjust=True),
    "test_center": dict(spatial_idx=1, min_scale=24, max_scale=24, crop_size=24),
    "dense": dict(spatial_idx=-2, min_scale=24, max_scale=24, crop_size=20,
                  rel_center_ratio=[0.25, 0.75]),
}


@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_spatial_matches_jax(case):
    kwargs = SPATIAL_CASES[case]
    for seed in range(3):
        x = _clip(seed, (2, 41, 27, 3))
        _equal(spatial.spatial_sampling(x, rng=np.random.default_rng(seed), **kwargs),
               jspatial.spatial_sampling(x, rng=np.random.default_rng(seed), **kwargs))
    for rect in ([32, 16], [16, 32]):
        for h, w in ((96, 56), (56, 96), (64, 64)):
            assert spatial.scale_adjust_short_side_scale_jitter(20, 40, rect, h, w) == \
                jspatial.scale_adjust_short_side_scale_jitter(20, 40, rect, h, w)


def test_decoder_builds_from_the_ports_source_into_an_ignored_path():
    lib = binding.get_lib()
    path = binding.library_path()
    assert Path(lib._name) == path and path.exists()
    assert path.parent == ROOT / "build" / "native"
    assert binding.SOURCE == ROOT / "pmv_tpu_torch" / "native" / "video_decoder.cpp"
    assert (ROOT / "pmv_tpu" / "native") not in path.parents
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT)
    assert ignored.returncode == 0, f"{path} is not ignored by git"


@pytest.mark.parametrize("size", [None, (20, 36)], ids=["native", "resized"])
def test_decoder_frames_match_jax(tmp_path, size):
    frames = np.random.default_rng(0).integers(0, 256, (12, 40, 24, 3), np.uint8)
    path = tmp_path / "v.avi"
    binding.write_test_video(path, frames, fps=12)
    out_w, out_h = size or (None, None)
    ours = binding.VideoReader(path)
    ref = jbinding.VideoReader(path)
    assert (ours.fps, ours.num_frames, ours.width, ours.height) == (
        ref.fps, ref.num_frames, ref.width, ref.height)
    idx = [0, 3, 4, 11]
    got = ours.read_frames(idx, out_w=out_w, out_h=out_h)
    np.testing.assert_array_equal(got, ref.read_frames(idx, out_w=out_w, out_h=out_h))
    if size is None:
        np.testing.assert_array_equal(got, frames[idx])
    ours.close()
    ref.close()


# Portrait and landscape sources, mixed.
VIDEOS = [(96, 56), (56, 96), (80, 60), (60, 100), (72, 72)]


@pytest.fixture(scope="module")
def pm_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pmv")
    vids = root / "videos"
    vids.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w) in enumerate(VIDEOS):
        binding.write_test_video(
            vids / f"v{i}.avi", rng.integers(0, 256, (30, h, w, 3), np.uint8), fps=15)
        rows.append(f"v{i}.avi,{i % 3}")
    for mode in ("train", "val", "test"):
        (root / f"{mode}_pmv.csv").write_text("\n".join(rows) + "\n")
    return root


def _kinetics_cfg(root, **overrides):
    cfg = jax_get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(root)
    cfg.DATA.PATH_PREFIX = str(root / "videos")
    cfg.DATA.PM_SUBSET = "_pmv"
    cfg.DATA.PATH_LABEL_SEPARATOR = ","
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE_RECT = [32, 24]
    cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True
    cfg.DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST = True
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE_RECT = [32, 24]
    cfg.DATA.TEST_CROP_SIZE_RECT_SWITCH_AUTO = True
    cfg.DATA.TEST_JITTER_SCALES_AUTO_ADJUST = True
    cfg.DATA.USE_OFFSET_SAMPLING = True
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.MODEL.NUM_CLASSES = 3
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for name in path:
            node = getattr(node, name)
        setattr(node, leaf, value)
    return cfg


@pytest.mark.parametrize("crops", [1, 3])
def test_kinetics_test_mode_samples_match_jax(pm_data, crops):
    cfg = _kinetics_cfg(pm_data, **{"TEST.NUM_SPATIAL_CROPS": crops})
    ours = build_dataset("kinetics", port_cfg(cfg), "test")
    ref = jax_build_dataset("kinetics", cfg, "test")
    assert len(ours) == len(ref) == len(VIDEOS) * 2 * crops
    pms = []
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert (a["label"], a["index"], a["pm"]) == (b["label"], b["index"], b["pm"])
        assert a["time"] == b["time"]
        assert a["frames"].dtype == np.uint8 and a["frames"].shape == (4, 32, 24, 3)
        np.testing.assert_array_equal(a["frames"], b["frames"])
        pms.append(a["pm"])
    assert any(pms) and not all(pms)


@pytest.mark.parametrize("recipe", ["rect_adjust", "relative_repeated"])
def test_kinetics_train_decode_matches_jax_under_one_rng(pm_data, recipe):
    overrides = {}
    if recipe == "relative_repeated":
        overrides = {"DATA.TRAIN_JITTER_SCALES_RELATIVE": [0.08, 1.0],
                     "DATA.TRAIN_JITTER_ASPECT_RELATIVE": [0.75, 1.3333],
                     "AUG.ENABLE": True, "AUG.NUM_SAMPLE": 2}
    cfg = _kinetics_cfg(pm_data, **overrides)
    ours = build_dataset("kinetics", port_cfg(cfg), "train")
    ref = jax_build_dataset("kinetics", cfg, "train")
    for i, (h, w) in enumerate(VIDEOS):
        params = ours._sample_params(i)
        assert params == ref._sample_params(i)
        path = ours._path_to_videos[i]
        with binding.VideoReader(path) as r1, jbinding.VideoReader(path) as r2:
            (a, pm_a), t_a = ours._decode_and_transform(r1, *params, np.random.default_rng(i))
            (b, pm_b), t_b = ref._decode_and_transform(r2, *params, np.random.default_rng(i))
        assert pm_a == pm_b == (h > w) and t_a == t_b
        np.testing.assert_array_equal(a, b)
        assert a.shape[-4:] == (4, 32, 24, 3)
    # A sample is a function of (seed, epoch, index).
    np.testing.assert_array_equal(ours[1]["frames"], ours[1]["frames"])
    first = ours[1]["frames"]
    ours._set_epoch_num(1)
    assert not np.array_equal(ours[1]["frames"], first)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"frames": np.full((1,), i, np.uint8), "label": i % 3, "index": i,
                "time": 0.0, "pm": i % 2 == 0}


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
@pytest.mark.parametrize("rank, world", [(0, 1), (1, 3)])
def test_loader_order_matches_jax(shuffle, drop_last, rank, world):
    ds = _Indices(37)
    for epoch in (0, 3):
        ours = loader.DataLoader(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=5,
                                 rank=rank, world_size=world, num_workers=2)
        # One process's loader at the global batch (4 a rank): a rank takes
        # its rows of each of its batches, [4 rank, 4 rank + 4).
        ref = jloader.DataLoader(ds, 4 * world, shuffle=shuffle, drop_last=drop_last,
                                 seed=5, num_workers=2)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(ours)
        want = [{k: v[4 * rank:4 * rank + 4] for k, v in b.items()} for b in ref]
        want = [b for b in want if len(b["index"])]
        assert len(ours) == len(ref) and len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_repeated_augmentation_collate_matches_jax():
    rng = np.random.default_rng(0)
    samples = [{"frames": rng.integers(0, 256, (2, 3, 4, 4, 3), np.uint8), "label": i,
                "index": i, "time": 0.5, "pm": bool(i % 2)} for i in range(3)]
    a = loader.multiple_samples_collate(samples)
    b = jloader.multiple_samples_collate(samples)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_matches_jax(mode):
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "tiny_synthetic.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE_RECT = [16, 12]
    ours = build_dataset("synthetic", port_cfg(cfg), mode)
    ref = jax_build_dataset("synthetic", cfg, mode)
    assert len(ours) == len(ref)
    for i in (0, 1, 7, len(ref) - 1):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("skip_rows", [0, 3, 7])
def test_kinetics_chunked_csv_matches_jax(pm_data, skip_rows):
    """DATA.LOADER_CHUNK_SIZE rows from DATA.SKIP_ROWS in train mode,
    wrapping to the file's start past its end."""
    cfg = _kinetics_cfg(pm_data, **{"DATA.LOADER_CHUNK_SIZE": 2, "DATA.SKIP_ROWS": skip_rows})
    ours = build_dataset("kinetics", port_cfg(cfg), "train")
    ref = jax_build_dataset("kinetics", cfg, "train")
    assert ours._path_to_videos == ref._path_to_videos and ours._labels == ref._labels


def test_kinetics_retries_replace_a_missing_video_in_train_mode(pm_data, tmp_path):
    """After NUM_RETRIES // 8 failed opens a train sample is replaced by
    another video (drawn from the sample's generator); test mode retries the
    same video and raises."""
    rows = (pm_data / "train_pmv.csv").read_text()
    (tmp_path / "train_pmv.csv").write_text("missing.avi,2\n" + rows)
    (tmp_path / "test_pmv.csv").write_text("missing.avi,2\n")
    cfg = _kinetics_cfg(pm_data, **{"DATA.PATH_TO_DATA_DIR": str(tmp_path)})
    train = build_dataset("kinetics", port_cfg(cfg), "train")
    sample = train[0]
    assert sample["index"] != 0 and sample["frames"].shape == (4, 32, 24, 3)
    assert sample["label"] == train._labels[sample["index"]]
    test = build_dataset("kinetics", port_cfg(cfg), "test")
    with pytest.raises(RuntimeError, match="retries"):
        test[0]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_dummy_load_returns_the_first_sample_as_jax(pm_data, mode):
    """DATA.DUMMY_LOAD: the first sample decoded, returned for every later
    index; in test mode (no draws) the same sample as JAX's Kinetics on the
    same CSV and decoder."""
    cfg = _kinetics_cfg(pm_data, **{"DATA.DUMMY_LOAD": True})
    ours = build_dataset("kinetics", port_cfg(cfg), mode)
    first = ours[3]
    assert first["index"] == 3
    for i in (0, 5, 3):
        assert ours[i] is first
    if mode == "test":
        ref = jax_build_dataset("kinetics", cfg, mode)
        want = ref[3]
        assert ref[0] is want
        assert (first["label"], first["index"], first["pm"]) == (
            want["label"], want["index"], want["pm"])
        np.testing.assert_array_equal(first["frames"], want["frames"])
