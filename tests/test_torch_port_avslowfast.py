"""The port's AVSlowFast against the JAX package's.

On configs/Kinetics/AVSLOWFAST_8x8_R50.yaml cut by ``--opts``-style
overrides (not edited): depth 18, width 8, 8 frames of 32^2, 5 classes, a
log-mel of AUDIO_FRAME_NUM 64 x AUDIO_MEL_NUM 16; float32 on the CPU; the
JAX variables drawn with numpy from a seed on the tree of
``jax.eval_shape`` of an init that sees the misaligned audio (the AVS
projections and ``s5_fuse`` exist), carried over with
``state_dict_from_jax`` and loaded strictly:

- the eval scores (no misaligned audio) and ``return_embeddings``;
- the train-mode forward with the misaligned audio under both DropPathway
  decisions (the one JAX draws at DROPPATHWAY_RATE 0.5 from a key, handed
  to the port: one compiled JAX function serves both): the scores, each
  AVS loss and the running statistics; the flag pattern of a JAX test
  (FS_FUSION [T, F, T, F], AFS_FUSION [F, T, F, F]): its tree and eval
  scores;
- ``audio_pair_mask`` on silent and duplicate rows; the antialiased 8 -> 2
  resize of the audio's time axis at s3 against ``jax.image.resize``
  (which ``F.interpolate`` is not);
- the gradients and one SGD step of the recipe against the jitted JAX
  ``make_train_step`` under both decisions, on the tree of JAX's
  ``init_state`` on a batch with "audio" and "audio_mis" (the set-up of
  the slow-marked ``tests/test_audio.py:216``), both sides in float64
  activations (``jax.enable_x64``; a float32 ReLU input within a rounding
  of 0 decides either way, and float32's floor lies near the 1e-4 gate
  even with the ReLUs held, as SlowFast's): loss, grad norm, top-k, each
  weight's update, the BatchNorm statistics;
- the full-size yaml's state_dicts against the JAX ``eval_shape`` trees
  (names, shapes, 38,059,696 parameters with the misaligned audio and
  35,660,976 without), each taking a JAX tree with ``strict=True``;
- a ``pm`` batch raising on both sides; the easy-negative roll against the
  JAX package's ``train_epoch`` (its ``prepare_batch``), before and after
  DATA.MIX_NEG_EPOCH;
- ``run_net --device cpu`` on a tiny ``Kinetics_av`` of AVI files with
  audio written from a seed: train, precise BN, eval, ``test_final``, then
  the resume.

Tolerance: atol 2e-4, rtol 1e-4; running statistics rtol 1e-4, atol 2e-5
(as tests/test_torch_port_csn.py holds them).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import avslowfast as javs
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.engine import steps as psteps
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.models import attention, build_model
from pmv_tpu_torch.models import avslowfast as pavs
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params, state_dict_from_jax
from torch_port_util import (
    draw_variables,
    jax_dropout_key,
    jax_dropout_masks_fn,
    jax_train_draws,
    numpy_tree,
    one_thread,
    port_cfg,
    to_np,
)

YAML = Path(__file__).resolve().parents[1] / "configs" / "Kinetics" / "AVSLOWFAST_8x8_R50.yaml"
TOL = dict(atol=2e-4, rtol=1e-4)
TINY = ("RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5",
        "DATA.AUDIO_FRAME_NUM", "64", "DATA.AUDIO_MEL_NUM", "16",
        "TRAIN.MIXED_PRECISION", "False", "NUM_GPUS", "1")
PARAMS = {True: 38_059_696, False: 35_660_976}


def tiny_cfg(*opts):
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(YAML))
    cfg.merge_from_list(list(TINY + opts))
    return cfg


def _inputs(batch, seed, misaligned=True):
    """[slow, fast, audio(, audio_mis)] float32 arrays, as pack_pathways
    packs a normalized clip."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 32, 32, 3)).astype(np.float32)
    audio = [rng.normal(size=(batch, 64, 16)).astype(np.float32)
             for _ in range(2 if misaligned else 1)]
    return [x[:, ::4], x, *audio]


_SHAPES = {}  # the flags of a tiny config -> the shapes of its state's variables


def _flags(cfg):
    sf = cfg.SLOWFAST
    return tuple(sf.FS_FUSION), tuple(sf.AFS_FUSION), tuple(sf.AVS_FLAG)


def _variables(cfg, jmodel, seed, dtype=np.float32):
    """Variables drawn from ``seed`` on the tree of JAX's ``init_state`` on a
    batch with "audio" and "audio_mis" (the AVS projections and ``s5_fuse``
    exist; traced, not run, once for each set of flags)."""
    key = _flags(cfg)
    if key not in _SHAPES:
        jbatch = {k: jnp.asarray(v) for k, v in _batch(0, 1).items()}
        state = jax.eval_shape(
            lambda b: jsteps.init_state(cfg, jmodel, b, jax.random.PRNGKey(0))[0], jbatch)
        _SHAPES[key] = {"params": state.params, "batch_stats": state.batch_stats}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                  draw_variables(_SHAPES[key], seed))


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"frames": rng.integers(0, 256, (b, 8, 32, 32, 3), np.uint8),
            "labels": rng.integers(0, 5, b),
            "audio": rng.normal(size=(b, 64, 16)).astype(np.float32),
            "audio_mis": rng.normal(size=(b, 64, 16)).astype(np.float32)}


def _models(*opts, seed=3):
    cfg = tiny_cfg(*opts)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = _variables(cfg, jmodel, seed)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    return cfg, jmodel, variables, model


_KERNEL_LAYOUT = {5: lambda s: (s[4], s[3], *s[:3]), 4: lambda s: (s[3], s[2], s[0], s[1]),
                  2: lambda s: s[::-1]}


def _jax_names_and_shapes(*trees):
    """The port's name and shape of each leaf of flax trees (of shapes)."""
    out = {}
    for tree in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = [str(k.key) for k in path]
            shape = tuple(leaf.shape)
            if names[-1] == "kernel":
                shape = _KERNEL_LAYOUT[len(shape)](shape)
            out[flax_path_to_torch(names)] = shape
    return out


def _torch(inputs, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a)).to(dtype) for a in inputs]


def _assert_stats(model, batch_stats):
    want = state_dict_from_jax({"params": {}, "batch_stats": numpy_tree(batch_stats)})
    got = model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=name)


# DropPathway at rate 0.5, so that one compiled JAX function takes both
# decisions, by its key; a kept step leaves the AVS losses after the
# earliest AFS junction (s3) at exactly 0, a dropped one does not.
HALF = ("SLOWFAST.DROPPATHWAY_RATE", "0.5")


def test_eval_embeddings_and_train_forward_match_jax():
    """The eval scores and ``return_embeddings`` (no misaligned audio);
    then the train-mode forward with the misaligned audio under each
    DropPathway decision, the one JAX draws from its key handed to the
    port: the scores, each AVS loss (dropped: s3, s4 and s5; kept: s3
    alone) and the running statistics. The head's dropout off (the step's
    test holds its masks)."""
    cfg, jmodel, variables, model = _models(*HALF, "MODEL.DROPOUT_RATE", "0.0")
    inputs = _inputs(4, 2)

    @jax.jit
    def forwards(v, x, key):
        scores = jmodel.apply(v, x[:3], train=False)
        emb = jmodel.apply(v, x[:3], train=False, return_embeddings=True)
        train = jmodel.apply(v, x, train=True, mutable=["batch_stats"], rngs={"dropout": key})
        return scores, emb, train

    model.eval()
    with torch.inference_mode():
        scores = model(_torch(inputs[:3]))
        v_emb, a_emb = model(_torch(inputs[:3]), return_embeddings=True)
    decisions = set()
    for k in range(1, 9):  # keys 1 and 2 take the two decisions
        want, (jv, ja), ((jout, jlosses), upd) = forwards(variables, inputs,
                                                          jax.random.PRNGKey(k))
        if k == 1:
            assert scores.shape == (4, 5) and float(want.max()) < 0.99
            np.testing.assert_allclose(to_np(scores), np.asarray(want), **TOL)
            assert v_emb.shape == (4, 256 + 32) and a_emb.shape == (4, 32)
            np.testing.assert_allclose(to_np(v_emb), np.asarray(jv), **TOL)
            np.testing.assert_allclose(to_np(a_emb), np.asarray(ja), **TOL)
        dropped = float(jlosses["s4_avs"]) != 0.0
        if dropped in decisions:
            continue
        decisions.add(dropped)
        trained = copy.deepcopy(model).train()
        out, losses = trained(_torch(inputs), drop_pathway=dropped)
        losses = {k: v.detach() for k, v in losses.items()}
        np.testing.assert_allclose(to_np(out), np.asarray(jout), **TOL)
        assert sorted(losses) == sorted(jlosses) == ["s3_avs", "s4_avs", "s5_avs"]
        for name, value in jlosses.items():
            np.testing.assert_allclose(float(losses[name]), float(value), rtol=1e-4, atol=1e-6)
        live = [n for n, v in losses.items() if float(v) != 0.0]
        assert live == (["s3_avs", "s4_avs", "s5_avs"] if dropped else ["s3_avs"])
        _assert_stats(trained, upd["batch_stats"])
        if len(decisions) == 2:
            break
    assert decisions == {False, True}


def test_flag_pattern_of_a_jax_test_matches_jax():
    """``tests/test_audio.py``'s flags, FS_FUSION [T, F, T, F] and
    AFS_FUSION [F, T, F, F] (the s1 junction a concat only, s2's the audio
    only, none after s3): the same tree (the JAX variables load strictly),
    and the eval scores."""
    opts = ("SLOWFAST.FS_FUSION", "[True, False, True, False]",
            "SLOWFAST.AFS_FUSION", "[False, True, False, False]")
    cfg, jmodel, variables, model = _models(*opts)
    assert not hasattr(model.s1_fuse, "conv_a2fs_0") and not hasattr(model.s2_fuse, "conv_f2s")
    assert hasattr(model.s4_fuse, "avs") and not hasattr(model.s4_fuse, "conv_f2s")
    inputs = _inputs(2, 5, misaligned=False)
    model.eval()
    with torch.inference_mode():
        got = model(_torch(inputs))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, inputs)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_audio_pair_mask_matches_jax():
    """Silent rows (variance under AVS_VAR_THRESH) and near-duplicate pairs
    (cosine similarity at or over AVS_DUPLICATE_THRESH) drop out."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(6, 64, 16)).astype(np.float32)
    neg = rng.normal(size=(6, 64, 16)).astype(np.float32)
    pos[1] = 0.0  # silent
    neg[2] = 0.05 * rng.normal(size=(64, 16))  # quiet: variance 0.0025
    neg[3] = pos[3]  # a duplicate
    neg[4] = pos[4] + 1e-4 * rng.normal(size=(64, 16))  # near one
    for thresholds in ((0.01, 0.99999), (0.001, 0.99)):
        want = np.asarray(javs.audio_pair_mask(jnp.asarray(pos), jnp.asarray(neg), *thresholds))
        got = pavs.audio_pair_mask(torch.from_numpy(pos), torch.from_numpy(neg), *thresholds)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [True, False, True, False, False, True]


def test_audio_time_resize_is_jax_antialiased_resize():
    """s3's audio (8 steps at the tiny size, 16 at full) to the slow
    pathway's T (2, and 8): ``jax.image.resize``'s triangle kernel widens
    when it downsamples; ``F.interpolate(mode="linear")`` does not."""
    a = np.random.default_rng(0).normal(size=(2, 8, 6)).astype(np.float32)
    for t_in, t_out in ((8, 2), (16, 8), (4, 2)):
        x = np.random.default_rng(t_in).normal(size=(2, t_in, 6)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, t_out, 6), method="linear"))
        got = attention.resize_axis(torch.from_numpy(x), 1, t_out)
        np.testing.assert_allclose(to_np(got), want, atol=1e-6, rtol=1e-6)
    plain = F.interpolate(torch.from_numpy(a).transpose(1, 2), size=2, mode="linear")
    want = np.asarray(jax.image.resize(jnp.asarray(a), (2, 2, 6), method="linear"))
    assert np.abs(to_np(plain.transpose(1, 2)) - want).max() > 0.05


def _rel_l2(got, want):
    diff = sum(float((got[k] - v).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.square().sum()) for v in want.values())) ** 0.5


def test_sgd_step_matches_jax_under_both_decisions():
    """The tree of JAX's ``init_state`` on a batch with the misaligned audio
    (traced, not run: it is the port's), the variables drawn on it from a
    seed; one step of the recipe (cross-entropy plus the AVS losses, head
    dropout 0.5, SGD with Nesterov momentum and weight decay) on both sides
    in float64 activations, one compiled JAX step taking each DropPathway
    decision by its key: the port's step under the decision whose loss is
    JAX's (the other's is not), then its grad norm to rtol 1e-4, top-k
    equal, the gradient held in each weight's update to relative L2 1e-4,
    the statistics."""
    cfg = tiny_cfg(*HALF)
    batch = _batch(4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lr = 0.05
    decisions = set()
    variables = _variables(cfg, jax_build_model(cfg, dtype=jnp.float32), 6, np.float64)
    with jax.enable_x64(True):
        jmodel = jax_build_model(cfg, dtype=jnp.float64)
        tx = joptim.construct_optimizer(variables["params"], cfg)
        jstate0 = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]))
        x = jsteps.make_eval_preprocess_fn(cfg)(jbatch["frames"])
        packed = jsteps.pack_pathways(cfg, x, jbatch["audio"], jbatch["audio_mis"])
        model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float64)
        load_jax_params(model, variables)
        model.double()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert {n: tuple(v.shape) for n, v in before.items()
                if not n.endswith("num_batches_tracked")} == _jax_names_and_shapes(
            *_SHAPES[_flags(cfg)].values())
        step = make_train_step(port_cfg(cfg), device="cpu")
        jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))
        head_mask = jax_dropout_masks_fn(jmodel, packed)
        for k in range(1, 9):  # keys 1 and 2 take the two decisions
            key = jax.random.PRNGKey(k)
            (mask,) = map(np.asarray, head_mask(variables, jax_dropout_key(key, 0)))
            jstate, jm = jstep(jstate0, jbatch, key, lr)
            runs = {}
            for dropped in (False, True):
                model.load_state_dict(before)
                draws = {**jax_train_draws(cfg, key, 0, batch["frames"].shape),
                         "dropout": torch.tensor(mask, dtype=torch.float64),
                         "drop_pathway": dropped}
                m = step(init_state(port_cfg(cfg), model), batch, lr, draws)
                runs[dropped] = (m, {n: v.clone() for n, v in model.state_dict().items()})
            rel = {d: abs(float(m["loss"]) / float(jm["loss"]) - 1) for d, (m, _) in runs.items()}
            dropped = min(rel, key=rel.get)
            assert rel[dropped] < 1e-5 and rel[not dropped] > 1e-3, rel
            if dropped in decisions:
                continue
            decisions.add(dropped)
            m, got = runs[dropped]
            assert sorted(n for n in m if n.endswith("_avs")) == ["s3_avs", "s4_avs", "s5_avs"]
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
            assert float(m["top1_err"]) == float(jm["top1_err"])
            assert float(m["top5_err"]) == float(jm["top5_err"])
            want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                                   "batch_stats": jstate.batch_stats}))
            names = [n for n in want if "running" not in n
                     and not n.endswith("num_batches_tracked")]
            assert _rel_l2({n: before[n] - got[n] for n in names},
                           {n: before[n] - want[n] for n in names}) < 1e-4
            model.load_state_dict(got)
            _assert_stats(model, jstate.batch_stats)
            if len(decisions) == 2:
                break
    assert decisions == {False, True}


@pytest.mark.parametrize("misaligned", [True, False])
def test_full_size_yaml_matches_the_jax_tree(misaligned):
    """Names, shapes and the parameter count at full width from
    ``jax.eval_shape`` of the JAX init (with the misaligned audio, as the
    training model, and without); the port's model built on the meta
    device takes a JAX tree of those shapes with ``strict=True``."""
    from pmv_tpu_torch.config import get_cfg

    cfg = jax_get_cfg()
    cfg.merge_from_file(str(YAML))
    cfg.DATA.GET_MISALIGNED_AUDIO = misaligned
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    xs = [jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32),
          jax.ShapeDtypeStruct((1, 32, 224, 224, 3), jnp.float32),
          jax.ShapeDtypeStruct((1, 128, 80), jnp.float32)]
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                            xs + xs[2:] * misaligned)
    expected = _jax_names_and_shapes(shapes["params"], shapes["batch_stats"])
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    pcfg = get_cfg()
    pcfg.merge_from_file(str(YAML))
    pcfg.DATA.GET_MISALIGNED_AUDIO = misaligned
    with torch.device("meta"):
        model = pavs.AVSlowFast(pcfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax == PARAMS[misaligned]
    assert ("s5_fuse.avs.query_fc.weight" in got) == misaligned
    assert got["s3_fuse.conv_a2fs_1.weight"] == (640, 64, 5, 1)  # to the concat's width
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    model.load_state_dict(state_dict_from_jax(zeros), strict=True, assign=True)
    assert model.s1.pathway2_stem.conv_t.weight.shape == (8, 1, 9, 1)


def test_a_pm_batch_raises_on_both_sides():
    """The JAX package's portrait steps pack the transposed clip without the
    audio and fail at its assert (its pm eval step, ``train.py:
    _make_pm_eval_step``, at once; its pm train step after the landscape
    forward, `steps.py:246`); the port raises NotImplementedError, and on a
    config with RECT_SWITCH_AUTO at once."""
    from pmv_tpu.engine.train import _make_pm_eval_step

    cfg = tiny_cfg()
    batch = {**_batch(1, 2), "pm": np.array([True, False])}
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = _variables(cfg, jmodel, 0)
    jstate = TrainState(step=0, params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None)
    with pytest.raises(AssertionError, match="audio"):
        _make_pm_eval_step(cfg, jmodel, jmodel)(jstate, jnp.asarray(batch["frames"]),
                                                jnp.asarray(batch["pm"]))
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="portrait"):
        make_train_step(pcfg, device="cpu")(init_state(pcfg, model), batch, 0.1)
    with pytest.raises(NotImplementedError, match="portrait"):
        psteps.make_eval_step(pcfg, model, device="cpu")(batch["frames"], batch["pm"],
                                                         batch["audio"])
    pcfg.DATA.TEST_CROP_SIZE_RECT_SWITCH_AUTO = True
    with pytest.raises(NotImplementedError, match="portrait"):
        psteps.make_eval_step(pcfg, model, device="cpu")


@pytest.mark.parametrize("epoch", [0, 96])
def test_easy_negatives_match_jax_prepare_batch(epoch):
    """The JAX package's ``train_epoch`` rolls "audio_mis" in its
    ``prepare_batch``; a step that records what it gets reads the roll.
    Before DATA.MIX_NEG_EPOCH (96) every row takes the next row's clip;
    from it on only the first int(0.75 n)."""
    from pmv_tpu.engine import train as jtrain
    from pmv_tpu.parallel import mesh as mesh_lib
    from pmv_tpu.utils import meters as jmeters

    cfg = tiny_cfg("TPU.DEVICE_PREFETCH", "0", "LOG_PERIOD", "1")
    rows = np.arange(8, dtype=np.float32)[:, None, None] * np.ones((8, 4, 2), np.float32)
    batch = {"frames": np.zeros((8, 1, 1, 1, 3), np.uint8), "labels": np.zeros(8, np.int64),
             "pm": np.zeros(8, bool), "audio": rows, "audio_mis": rows}
    seen = []

    def record(state, device_batch, rng, lr):
        seen.append(np.asarray(device_batch["audio_mis"]))
        zero = jnp.zeros(())
        return state, {"loss": zero, "grad_norm": zero, "top1_err": zero, "top5_err": zero,
                       "nan": jnp.zeros((), bool)}

    jtrain.train_epoch([batch], record, record, None, jmeters.TrainMeter(1, cfg), epoch, cfg,
                       mesh_lib.create_mesh(), jax.random.PRNGKey(0))
    got = psteps.easy_negatives(port_cfg(cfg), rows, epoch)
    np.testing.assert_array_equal(got.numpy(), seen[0])
    order = got[:, 0, 0].long().tolist()
    assert order == ([1, 2, 3, 4, 5, 6, 7, 0] if epoch == 0 else [1, 2, 3, 4, 5, 0, 6, 7])


def _write_kinetics_av(root, videos=8, seed=0):
    """``videos`` AVIs of 30 frames of 40x48 at 15 fps with 2 s of audio
    (a chirp and noise from ``seed``), listed in train.csv, val.csv and
    test.csv."""
    from pmv_tpu_torch.native import binding

    rng = np.random.default_rng(seed)
    (root / "videos").mkdir(parents=True)
    rows = []
    t = np.arange(32000) / 16000
    for i in range(videos):
        wav = 0.3 * np.sin(2 * np.pi * (100 * (i + 1) + 300 * t) * t) + 0.05 * rng.normal(size=t.shape)
        binding.write_test_video(root / "videos" / f"v{i}.avi",
                                 rng.integers(0, 256, (30, 40, 48, 3), np.uint8), fps=15,
                                 audio=wav.astype(np.float32))
        rows.append(f"v{i}.avi,{i % 5}")
    for mode in ("train", "val", "test"):
        (root / f"{mode}.csv").write_text("\n".join(rows) + "\n")


def _run_net_argv(data, out, max_epoch):
    return ["--cfg", str(YAML), "--device", "cpu", "--opts", *TINY,
            "TRAIN.DATASET", "kinetics_av", "TEST.DATASET", "kinetics_av",
            "DATA.PATH_TO_DATA_DIR", str(data), "DATA.PATH_PREFIX", str(data / "videos"),
            "DATA.PATH_LABEL_SEPARATOR", ",", "DATA.NUM_FRAMES", "8", "DATA.SAMPLING_RATE", "2",
            "DATA.TRAIN_JITTER_SCALES", "[32, 40]", "TRAIN.BATCH_SIZE", "4",
            "TEST.BATCH_SIZE", "4", "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "1",
            "SOLVER.MAX_EPOCH", str(max_epoch), "SOLVER.WARMUP_EPOCHS", "0.0",
            "DATA_LOADER.NUM_WORKERS", "2", "OUTPUT_DIR", str(out)]


def test_run_net_trains_on_kinetics_av_tests_and_resumes(tmp_path, one_thread):  # noqa: F811
    """The yaml cut to the tiny size, on AVI files with audio: one epoch
    trains (with the misaligned audio, DropPathway, the easy negatives),
    runs precise BN, checkpoints, evaluates and tests 2 views with the
    audio; a second call with SOLVER.MAX_EPOCH 2 resumes from the
    checkpoint."""
    import json

    from pmv_tpu_torch.tools import run_net

    data, out = tmp_path / "data", tmp_path / "job"
    _write_kinetics_av(data)
    assert run_net.main(_run_net_argv(data, out, 1)) == 0
    log = (out / "stdout.log").read_text()
    stats = [json.loads(line.split("json_stats: ", 1)[1])
             for line in log.splitlines() if "json_stats: " in line]
    train = [s for s in stats if s.get("_type") == "train_epoch"]
    assert len(train) == 1 and np.isfinite(train[0]["loss"])
    assert "Updated precise BN stats over 2 batches" in log
    assert any(s.get("_type") == "val_epoch" for s in stats)
    assert stats[-1]["split"] == "test_final"
    ckpt = out / "checkpoints" / "checkpoint_epoch_00001.pyth"
    state = torch.load(ckpt, map_location="cpu", weights_only=True)["model_state"]
    assert "s5_fuse.avs.ref_fc.weight" in state and "s2.pathway2.b0_a.weight" in state
    assert run_net.main(_run_net_argv(data, out, 2)) == 0
    log = (out / "stdout.log").read_text()
    assert f"Load from last checkpoint, {ckpt}." in log and "Start epoch: 2" in log
    assert (out / "checkpoints" / "checkpoint_epoch_00002.pyth").exists()
    assert "json_stats" in log.rsplit("Start epoch: 2", 1)[1]
