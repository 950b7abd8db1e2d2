"""The port's contrastive SSL training against the JAX package's, on the CPU
in float32.

- One step of each of moco, simclr, byol, swav and mem (the published
  yamls' recipes: the moco-v2 colour jitter, SGD with Nesterov momentum,
  LARS for SimCLR, BYOL and SwAV) on a tiny Slow backbone, on 5-D frames
  and on 6-D frames of 3 views (views 0 and 1 taken), against the jitted
  JAX ``make_ssl_train_step`` (one compile a type, on the 6-D batch) from
  one state (the online, momentum,
  predictor and prototype tensors, the BatchNorm statistics, a queue whose
  pointer wraps, a bank) and the JAX step's colour draws
  (``torch_port_util.jax_ssl_step_draws``), JAX's ReLUs taking the port's
  decisions: loss and grad norm (atol 2e-4, rtol 1e-4), the gradients
  (relative L2 1e-4; JAX's read off its SGD trace after one step from
  zero, with no weight decay), and the whole state after the step (every
  tensor, atol 2e-4, rtol 1e-4).
- The weight-decay mask over the trainable tree {online, predictor,
  prototypes}, against the JAX package's; the feature step of the kNN
  monitor against ``make_ssl_feature_step``.
- ``run_net --device cpu`` on configs/contrastive_ssl/MoCo_SlowR50_8x8.yaml
  at a tiny width on ``Synthetic``: train_ssl trains, logs the kNN line,
  checkpoints (every SSL tensor restored exactly) and resumes; then
  configs/Kinetics/SLOW_8x8_R50.yaml fine-tunes from that checkpoint with
  CHECKPOINT_CLEAR_NAME_PATTERN ["backbone."] (the backbone's tensors
  loaded, the head at its init), and tests. SSL under fsdp raises.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmv_tpu.engine import ssl_steps as jssl
from pmv_tpu.models import contrastive as jcm
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.engine import ssl_steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import contrastive as cm
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.tools.grad_witness import Decisions, relu_decisions
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_contrastive import jax_encoder, tiny_ssl_cfg
from torch_port_util import (  # noqa: F401
    draw_variables,
    folded_like,
    jax_ssl_step_draws,
    numpy_tree,
    one_thread,
    port_cfg,
)

ROOT = Path(__file__).resolve().parents[1]
MOCO_YAML = str(ROOT / "configs" / "contrastive_ssl" / "MoCo_SlowR50_8x8.yaml")
SLOW_YAML = str(ROOT / "configs" / "Kinetics" / "SLOW_8x8_R50.yaml")
YAMLS = {"moco": "MoCo_SlowR50_8x8.yaml", "simclr": "SimCLR_SlowR50_8x8.yaml",
         "byol": "BYOL_SlowR50_8x8.yaml", "swav": "SwAV_Slow_R50_8x8.yaml",
         "mem": "MoCo_SlowR50_8x8.yaml"}
ATOL, RTOL = 2e-4, 1e-4
LR = 0.05
INDEX = np.array([5, 17, 0, 63])
pytestmark = pytest.mark.usefixtures("one_thread")


def step_cfg(ssl_type, *opts):
    """The tiny contrastive model with the recipe of ``ssl_type``'s yaml, no
    weight decay (so that JAX's gradients read off its trace)."""
    return tiny_ssl_cfg(ssl_type, "slow", YAMLS[ssl_type], "SOLVER.WEIGHT_DECAY", "0.0",
                        "SOLVER.BASE_LR", str(LR), *opts)


def jax_ssl_state(cfg, seed=0):
    """The JAX model, a whole SSLTrainState drawn with numpy (every tensor
    its own draw: the momentum encoder is not the online one, the queue's
    pointer wraps within the next batch, the bank has untouched rows), and
    its optimizer."""
    jmodel, variables = jax_encoder(cfg, seed)
    c = cfg.CONTRASTIVE
    rng = np.random.default_rng(seed + 7)

    def unit(n):
        z = rng.normal(size=(n, c.DIM)).astype(np.float32)
        return z / np.linalg.norm(z, axis=-1, keepdims=True)

    shapes = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                    variables["params"])
    predictor = prototypes = None
    trainable = {"online": variables["params"]}
    if c.TYPE == "byol":
        pred = jcm.PredictorMLP(dim=c.DIM, hidden=c.MLP_DIM)
        predictor = draw_variables(jax.eval_shape(
            lambda: pred.init(jax.random.PRNGKey(0), jnp.zeros((1, c.DIM))))["params"], seed + 3)
        trainable["predictor"] = predictor
    if c.TYPE == "swav":
        prototypes = rng.normal(size=(c.SWAV_QEUE_LEN, c.DIM)).astype(np.float32)
        trainable["prototypes"] = prototypes
    bank = unit(c.LENGTH)
    bank[40:] = 0.0
    tx = joptim.construct_optimizer(trainable, cfg)
    state = jssl.SSLTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(trainable),
        momentum_params=draw_variables(shapes, seed + 2), queue=unit(c.QUEUE_LEN),
        queue_ptr=jnp.int32(c.QUEUE_LEN - 2), bank=bank, predictor_params=predictor,
        prototypes=prototypes)
    return jmodel, state, tx


def port_state_dict(state, ssl_type):
    """The port's state_dict of a JAX SSLTrainState: the fields the port's
    model of ``ssl_type`` holds."""
    fields = {"params": state.params, "batch_stats": state.batch_stats, "bank": state.bank,
              "predictor_params": state.predictor_params, "prototypes": state.prototypes}
    if ssl_type in cm.MOMENTUM_TYPES:
        fields["momentum_params"] = state.momentum_params
    if ssl_type == "moco":
        fields.update(queue=state.queue, queue_ptr=state.queue_ptr)
    return state_dict_from_jax(numpy_tree(fields))


def jax_order(decisions, ssl_type):
    """The port's ReLU decisions in the JAX step's call order. The port runs
    the momentum encoder's key forward before the online one (it must read
    the statistics before the train forward moves them); JAX traces the
    online forward first, then BYOL's predictor, then the momentum
    forwards."""
    masks = decisions.masks
    if ssl_type == "moco":  # port: key, online, queue
        n = len(masks) // 3
        masks = masks[n:2 * n] + masks[:n] + masks[2 * n:]
    elif ssl_type == "byol":  # port: key, online, predictor
        n = (len(masks) - 1) // 2
        masks = masks[n:] + masks[:n]
    return Decisions(masks)


def _trace(opt_state):
    """The ``trace`` tree of the optax chain's one ``optax.trace`` state."""
    is_trace = lambda s: isinstance(s, optax.TraceState)  # noqa: E731
    (found,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_trace)
                if is_trace(s)]
    return found.trace


def _frames(views):
    shape = (4, views, 4, 16, 16, 3) if views else (4, 4, 16, 16, 3)
    return np.random.default_rng(11).integers(0, 256, shape, np.uint8)


def _relative_l2(got, want):
    diff = sum(float((got[k].double() - v.double()).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.double().square().sum()) for v in want.values())) ** 0.5


_JAX_STEPS = {}  # ssl_type -> the jitted JAX step, ReLU decisions as an argument


def jax_step(ssl_type, cfg, jmodel, tx):
    """The JAX step of ``ssl_type`` on a 6-D batch of ``VIEWS`` views, each
    call of flax's ``nn.relu`` taking the next of the decisions passed in
    (relu(v) = v * decision, as ``jax_relu_decisions``, but as an argument,
    so that one compile serves both cases of a type)."""
    if ssl_type not in _JAX_STEPS:
        import flax.linen as fnn

        step = jssl.make_ssl_train_step(cfg, jmodel, tx)

        def held(state, batch, rng, lr, masks):
            relu, it = fnn.relu, iter(masks)
            fnn.relu = lambda v: v * folded_like(next(it), v.shape).astype(v.dtype)
            try:
                out = step(state, batch, rng, lr)
            finally:
                fnn.relu = relu
            assert next(it, None) is None, "the JAX step made fewer ReLU calls than the port"
            return out

        _JAX_STEPS[ssl_type] = jax.jit(held)
    return _JAX_STEPS[ssl_type]


VIEWS = 3


@pytest.mark.parametrize("ndim", [5, 6])
@pytest.mark.parametrize("ssl_type", ["moco", "simclr", "byol", "swav", "mem"])
def test_ssl_step_matches_jax(ssl_type, ndim):
    """The port's step on ``ndim``-D frames. JAX takes the same views: a 6-D
    batch as it is; for a 5-D batch, which JAX augments twice, the batch's
    clip as each of the 6-D batch's views (views 0 and 1 equal: the same
    computation as on the 5-D batch)."""
    cfg = step_cfg(ssl_type)
    jmodel, jstate, tx = jax_ssl_state(cfg)
    frames = _frames(VIEWS)
    batch = {"frames": frames if ndim == 6 else frames[:, 0], "index": INDEX}
    jframes = frames if ndim == 6 else np.repeat(frames[:, :1], VIEWS, axis=1)
    rng = jax.random.PRNGKey(3)
    draws = jax_ssl_step_draws(cfg, rng, 0, frames[:, 0].shape)
    assert set(draws["view1"]) == {"ssl_color"}

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    before = port_state_dict(jstate, ssl_type)
    model.load_state_dict(before, strict=True)
    state = ssl_steps.init_ssl_state(pcfg, model)
    step = ssl_steps.make_ssl_train_step(pcfg, device="cpu")
    with relu_decisions() as decisions:
        m = step(state, batch, LR, draws)

    masks = [m.numpy() for m in jax_order(decisions, ssl_type).masks]
    jnew, jm = jax_step(ssl_type, cfg, jmodel, tx)(
        jstate, {"frames": jnp.asarray(jframes), "index": jnp.asarray(INDEX)}, rng, LR, masks)

    assert set(m) == set(jm) and not bool(m["nan"]) and state.step == 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=ATOL, rtol=RTOL,
                                   err_msg=key)
    trace = _trace(jnew.opt_state)
    jgrads = state_dict_from_jax(numpy_tree({
        "params": trace["online"], "predictor_params": trace.get("predictor"),
        "prototypes": trace.get("prototypes")}))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    assert _relative_l2(grads, jgrads) < 1e-4

    want = port_state_dict(jnew, ssl_type)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        moved = not torch.equal(got[name], before[name])
        assert moved == (not torch.equal(value, before[name])), name
    if ssl_type == "moco":
        assert int(got["queue_ptr"]) == 2  # 30 + 4 wraps at 32
    assert not torch.equal(got["bank"][INDEX], before["bank"][INDEX])
    rest = np.setdiff1d(np.arange(64), INDEX)
    assert torch.equal(got["bank"][rest], before["bank"][rest])


@pytest.mark.parametrize("ssl_type", ["byol", "swav"])
def test_weight_decay_mask_over_the_trainable_tree_matches_jax(ssl_type):
    cfg = step_cfg(ssl_type, "SOLVER.WEIGHT_DECAY", "1e-6")
    _, jstate, _ = jax_ssl_state(cfg)
    trainable = {"online": jstate.params, "predictor": jstate.predictor_params,
                 "prototypes": jstate.prototypes}
    jmask = joptim.make_wd_mask({k: v for k, v in trainable.items() if v is not None}, cfg)
    want = state_dict_from_jax(jax.tree_util.tree_map(lambda v: np.float32(v), {
        "params": jmask["online"], "predictor_params": jmask.get("predictor"),
        "prototypes": jmask.get("prototypes")}))
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    got = optim.make_wd_mask(model, cfg)
    assert {k: bool(v) for k, v in got.items()} == {k: bool(v) for k, v in want.items()}
    assert got.get("prototypes", True) and not got["backbone.s1.pathway0_stem.bn.weight"]


def test_feature_step_matches_jax():
    cfg = step_cfg("moco")
    jmodel, jstate, _ = jax_ssl_state(cfg)
    frames = _frames(0)
    want = jax.jit(jssl.make_ssl_feature_step(cfg, jmodel))(jstate, jnp.asarray(frames))
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    model.load_state_dict(port_state_dict(jstate, "moco"), strict=True)
    got = ssl_steps.make_ssl_feature_step(port_cfg(cfg), model, device="cpu")(frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------- the CLI

# float32 on the CPU: PyTorch's CPU bfloat16 conv weight gradient returns
# non-finite values at these grids (ROADMAP.md, Faults).
TINY = ["NUM_GPUS", "1", "TRAIN.MIXED_PRECISION", "False", "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic",
        "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8", "DATA.NUM_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "16", "DATA.TEST_CROP_SIZE", "16",
        "DATA.TRAIN_JITTER_SCALES", "[16, 20]", "RESNET.DEPTH", "18",
        "RESNET.WIDTH_PER_GROUP", "4", "DATA_LOADER.NUM_WORKERS", "0",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
        "SOLVER.MAX_EPOCH", "1", "LOG_PERIOD", "2"]
TINY_MOCO = TINY + ["CONTRASTIVE.DIM", "8", "CONTRASTIVE.MLP_DIM", "16",
                    "CONTRASTIVE.QUEUE_LEN", "32", "CONTRASTIVE.LENGTH", "100",
                    "MODEL.NUM_CLASSES", "8", "TRAIN.EVAL_PERIOD", "1",
                    "TRAIN.CHECKPOINT_PERIOD", "1"]
TINY_SLOW = TINY + ["MODEL.NUM_CLASSES", "5", "BN.NUM_BATCHES_PRECISE", "2",
                    "TRAIN.CHECKPOINT_EPOCH_RESET", "True",
                    "TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN", "['backbone.']"]


def _ckpt(out, epoch, task="ssl"):
    return cu.get_path_to_checkpoint(str(out), epoch, task)


def _knn_lines(log):
    return [json.loads(line.split("json_stats: ", 1)[1]) for line in log.splitlines()
            if "ssl_knn_epoch" in line]


def test_run_net_pretrains_moco_resumes_and_fine_tunes_slow_on_cpu(tmp_path):
    pt, ft = tmp_path / "pt", tmp_path / "ft"
    run_net.main(["--cfg", MOCO_YAML, "--device", "cpu", "--opts", "OUTPUT_DIR", str(pt),
                  *TINY_MOCO])
    log = (pt / "stdout.log").read_text()
    (knn,) = _knn_lines(log)
    assert knn["epoch"] == 0 and 0.0 <= knn["knn_top1_acc"] <= 100.0
    first = torch.load(_ckpt(pt, 1), map_location="cpu", weights_only=True)
    assert first["optimizer_state"]["param_groups"][0]["count"] == 64 // 8
    state_file = first["model_state"]
    assert int(state_file["queue_ptr"]) == (8 * 8) % 32
    assert int((state_file["bank"].norm(dim=1) > 0.5).sum()) == 64  # every sample's row

    # The restore as train_ssl makes it: every tensor, the SSL state's too.
    cfg = get_cfg()
    cfg.merge_from_file(MOCO_YAML)
    cfg.merge_from_list(TINY_MOCO)
    model = build_model(cfg, device="cpu", seed=cfg.RNG_SEED)
    state = ssl_steps.init_ssl_state(cfg, model)
    assert cu.load_checkpoint(_ckpt(pt, 1), state) == 0
    for name, value in model.state_dict().items():
        assert torch.equal(value, state_file[name]), name
    assert state.step == 8 and state.optimizer.state
    assert any(k.startswith("momentum.backbone.") for k in state_file)

    run_net.main(["--cfg", MOCO_YAML, "--device", "cpu", "--opts", "OUTPUT_DIR", str(pt),
                  *TINY_MOCO, "SOLVER.MAX_EPOCH", "2"])
    log = (pt / "stdout.log").read_text()
    assert f"Resumed SSL training from {_ckpt(pt, 1)}" in log and "Start epoch: 2" in log
    assert [k["epoch"] for k in _knn_lines(log)] == [0, 1]
    second = torch.load(_ckpt(pt, 2), map_location="cpu", weights_only=True)
    assert second["optimizer_state"]["param_groups"][0]["count"] == 16
    assert not torch.equal(second["model_state"]["queue"], state_file["queue"])
    pt_state = second["model_state"]

    # The supervised Slow from the MoCo checkpoint: the backbone's tensors.
    ft_cfg = get_cfg()
    ft_cfg.merge_from_file(SLOW_YAML)
    ft_cfg.merge_from_list(TINY_SLOW + ["OUTPUT_DIR", str(ft),
                                        "TRAIN.CHECKPOINT_FILE_PATH", _ckpt(pt, 2)])
    init = build_model(ft_cfg, device="cpu", seed=ft_cfg.RNG_SEED)
    fresh = {k: v.clone() for k, v in init.state_dict().items()}
    ft_state = ssl_steps.init_ssl_state(ft_cfg, init)
    assert cu.load_train_checkpoint(ft_cfg, ft_state) == 0
    assert ft_state.step == 0 and not ft_state.optimizer.state
    loaded = kept = 0
    for name, value in init.state_dict().items():
        src = pt_state.get("backbone." + name)
        if src is not None:
            assert torch.equal(value, src), name
            loaded += 1
        else:
            assert name.startswith("head.") and torch.equal(value, fresh[name]), name
            kept += 1
    assert kept == 2 and loaded == len([k for k in pt_state if k.startswith("backbone.")])
    run_net.main(["--cfg", SLOW_YAML, "--device", "cpu", "--opts", "OUTPUT_DIR", str(ft),
                  *TINY_SLOW, "TRAIN.CHECKPOINT_FILE_PATH", _ckpt(pt, 2)])
    log = (ft / "stdout.log").read_text()
    assert f"Loaded {loaded} of the model's {loaded + kept} tensors from the checkpoint" in log
    assert f"{kept} kept their init" in log
    assert '"split": "test_final"' in log
