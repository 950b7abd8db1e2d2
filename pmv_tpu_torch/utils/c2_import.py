"""Caffe2 checkpoints (TRAIN/TEST.CHECKPOINT_TYPE "caffe2": FAIR's original
video-model zoo files, `MViT/slowfast/utils/checkpoint.py:226-294`,
`c2_model_loading.py`).

The port's copy of `pmv_tpu/utils/c2_import.py`: a pickle holding a
``blobs`` dict of numpy arrays named by the Caffe2 layer convention, renamed
to PySlowFast's state-dict names by the reference's rules
(``get_name_convert_func``), applied in order so that chained rewrites
compose as there:

    conv1_w                      -> s1.pathway0_stem.conv.weight
    res_conv1_bn_s               -> s1.pathway0_stem.bn.weight
    res2_0_branch2a_w            -> s2.pathway0_res0.branch2.a.weight
    res2_0_branch1_bn_rm         -> s2.pathway0_res0.branch1_bn.running_mean
    t_res2_0_branch2a_w          -> s2.pathway1_res0.branch2.a.weight  (fast)
    t_pool1_subsample_w          -> s1_fuse.conv_f2s.weight
    t_res2_3_branch2c_bn_subsample_w -> s2_fuse.conv_f2s.weight
    nonlocal_conv3_1_theta_w     -> s3.pathway0_nonlocal1.conv_theta.weight
    pred_b                       -> head.projection.bias

Caffe2's layouts are torch's (conv blobs [O, I, T, H, W], the 1x1x1 ones
too, as ``common.PointwiseConv`` keeps them; FC blobs [out, in]), and the
port's modules carry PySlowFast's names, so the import is the renamed dict
loaded by name. As in the JAX package, which fills only the "params" tree
(`c2_import.py:112-120`), only the model's parameters load: BatchNorm
running statistics keep their init. A head of another shape (another class
count) keeps its init, as ``torch_import.convert_state_dict`` drops it.
"""

import pickle
import re

import numpy as np
import torch

# (pattern, replacement) pairs applied in order; every rule may rewrite the
# running name (nonlocal before res, fuse before the plain fast pathway,
# the leaf suffixes last).
_C2_RULES = (
    # Nonlocal blocks: hoist into the stage, name the inner convs.
    (r"^nonlocal_conv(\d+)_(\d+)_(.*)", r"s\1.pathway0_nonlocal\2_\3"),
    (r"^(.*)_nonlocal(\d+)_(theta|phi|g|out)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal(\d+)_(bn)_(.*)", r"\1_nonlocal\2.\3.\4"),
    # SlowFast fuse convs (fast->slow 't_' prefixed subsample layers).
    (r"^t_pool1_subsample_bn_(.*)", r"s1_fuse.bn.\1"),
    (r"^t_pool1_subsample_(.*)", r"s1_fuse.conv_f2s.\1"),
    (r"^t_res(\d+)_(\d+)_branch2c_bn_subsample_bn_(.*)", r"s\1_fuse.bn.\3"),
    (r"^t_res(\d+)_(\d+)_branch2c_bn_subsample_(.*)",
     r"s\1_fuse.conv_f2s.\3"),
    # Slow/single pathway residual blocks + stem.
    (r"^res(\d+)_(\d+)_branch(\d+)([a-z])_(.*)",
     r"s\1.pathway0_res\2.branch\3.\4_\5"),
    (r"^res_conv1_bn_(.*)", r"s1.pathway0_stem.bn.\1"),
    (r"^conv1_xy(.*)", r"s1.pathway0_stem.conv_xy\1"),
    (r"^conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    (r"^res(\d+)_(\d+)_branch(\d+)_(.*)", r"s\1.pathway0_res\2.branch\3_\4"),
    (r"^res_conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    # Fast pathway mirrors with a 't_' prefix.
    (r"^t_res(\d+)_(\d+)_branch(\d+)([a-z])_(.*)",
     r"s\1.pathway1_res\2.branch\3.\4_\5"),
    (r"^t_res_conv1_bn_(.*)", r"s1.pathway1_stem.bn.\1"),
    (r"^t_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    (r"^t_res(\d+)_(\d+)_branch(\d+)_(.*)",
     r"s\1.pathway1_res\2.branch\3_\4"),
    (r"^t_res_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    # Heads (classifier, X3D conv_5/lin_5 projection layers, SE fc).
    (r"pred_(.*)", r"head.projection.\1"),
    (r"(.*)b_bn_fc(.*)", r"\1se.fc\2"),
    (r"conv_5(.*)", r"head.conv_5\1"),
    (r"lin_5(.*)", r"head.lin_5\1"),
    # Leaf suffixes: Caffe2 s/b/rm/riv -> torch BN + generic weight/bias.
    (r"(.*)bn.b\Z", r"\1bn.bias"),
    (r"(.*)bn.s\Z", r"\1bn.weight"),
    (r"(.*)bn.rm\Z", r"\1bn.running_mean"),
    (r"(.*)bn.riv\Z", r"\1bn.running_var"),
    (r"(.*)[._]b\Z", r"\1.bias"),
    (r"(.*)[._]w\Z", r"\1.weight"),
)

# Optimizer and bookkeeping blobs with no model tensor. As in the JAX
# package (and the reference), "lr" drops every blob whose name holds those
# two letters.
_SKIP_SUBSTRINGS = ("momentum", "lr", "model_iter")


def convert_c2_name(name):
    """One Caffe2 blob name -> its PySlowFast state-dict name."""
    for pattern, repl in _C2_RULES:
        name = re.sub(pattern, repl, name)
    return name


def load_c2_state_dict(path):
    """A Caffe2 pickle -> {PySlowFast name: np.ndarray}, the blobs' layouts
    as they are (torch's). The file is unpickled: load only a file you
    trust."""
    with open(path, "rb") as f:
        payload = pickle.load(f, encoding="latin1")
    blobs = payload["blobs"] if "blobs" in payload else payload
    sd = {}
    for key, value in blobs.items():
        if any(s in key for s in _SKIP_SUBSTRINGS):
            continue
        arr = np.asarray(value)
        if arr.dtype == object or arr.ndim == 0:
            continue
        sd[convert_c2_name(key)] = arr
    return sd


def model_params(path, model):
    """The tensors of the Caffe2 file ``path`` that name parameters of
    ``model`` (its buffers, the BatchNorm statistics among them, are left
    out), as torch tensors; a vector blob of a parameter's size but another
    shape takes the parameter's, as the JAX package's converter reshapes
    it. ``checkpoint.load_model_state`` loads them by name."""
    params = dict(model.named_parameters())
    out = {}
    for name, arr in load_c2_state_dict(path).items():
        param = params.get(name)
        if param is None:
            continue
        if tuple(arr.shape) != tuple(param.shape) and param.dim() <= 1 \
                and arr.size == param.numel():
            arr = arr.reshape(tuple(param.shape))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
