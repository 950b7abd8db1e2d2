"""Carry weights over from the JAX package's parameter trees.

``state_dict_from_jax(variables)`` takes a flax param tree (or the
{"params", "batch_stats"} variables) as nested dicts of numpy arrays and
returns a ``state_dict`` under the reference's PySlowFast
names (``blocks.3.attn.pool_q.weight``, ``blocks.3.attn.norm_q.weight``, ...),
in PyTorch's layouts, ready for ``load_state_dict(strict=True)``. It is the
inverse of the JAX package's torch importer (`utils/torch_import.py`), whose
name mapping is copied here. MaskMViT's tree maps by the same rules:
``backbone/...`` to ``backbone.`` and the MViT names, ``mask_token``,
``pred_head.{norm,projection}``, ``decoder_embed``,
``decoder_pos_embed{,_spatial,_temporal}`` and ``decoder_blocks.{i}.*``.
A ContrastiveEncoder's tree maps to ``backbone.`` and ``projection.fc{i}``;
the rest of the JAX package's ``SSLTrainState`` comes in beside "params"
and "batch_stats", under the state's field names: "momentum_params" (to
``momentum.``), "predictor_params" (to ``predictor.``), "prototypes",
"queue", "queue_ptr" and "bank" (``models/contrastive.py``). AVSlowFast's tree maps by the same
rules, with no rule of its own: the audio pathway ``s1.pathway2_stem/
{conv_t,conv_f,bn}`` and ``s{2..5}.pathway2/b{i}_{a,b,c,proj}(_bn)``, the
junctions ``s{3,4,5}_fuse/{conv_f2s,bn_f2s,conv_a2fs_k,bn_a2fs_k}`` and
their ``avs/{ref_fc,query_fc}`` keep their flax paths as the port's names
(``models/avslowfast.py``), the 2-D kernels in Conv2d's layout.

Layouts (flax, channels-last -> torch):
- Dense kernel [in, out]                 -> Linear weight [out, in]
- Conv3d kernel [T, H, W, I, O]          -> Conv3d weight [O, I, T, H, W]
  (depthwise pool kernels [t, h, w, 1, C] -> [C, 1, t, h, w])
- Conv2d kernel [H, W, I, O]             -> Conv2d weight [O, I, H, W]
- LayerNorm / BatchNorm scale, bias      -> weight, bias
- BatchNorm mean, var (``batch_stats``)  -> running_mean, running_var
  (a SubBatchNorm's of S x C values, its scale and bias at its own level,
  with no "BatchNorm_0" under it)
"""

import re

import numpy as np
import torch

_LEAF_MAP = {
    "kernel": "weight",
    "pool_kernel": "weight",  # AttentionPool's depthwise kernel
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def flax_path_to_torch(path_names):
    """Map a flax param path (list of names) to the torch state-dict name."""
    names = list(path_names)
    leaf = names[-1]
    mods = names[:-1]
    out = []
    i = 0
    while i < len(mods):
        m = mods[i]
        # MViT attention pools: attn/pool_q(/pool_kernel) -> attn.pool_q;
        # attn/pool_q/norm -> attn.norm_q.
        if m in ("pool_q", "pool_k", "pool_v"):
            if i + 1 < len(mods) and mods[i + 1] == "norm":
                out.append("norm_" + m.split("_")[1])
                i += 2
                continue
            out.append(m)
            i += 1
            continue
        # ResNet-family stages register children as "pathway{P}_res{i}".
        if (
            out
            and re.fullmatch(r"s\d+\.pathway\d+", out[-1])
            and re.fullmatch(r"(res|nonlocal)\d+", m)
        ):
            out[-1] = out[-1] + "_" + m
            i += 1
            continue
        # flax BatchNorm wrappers nest an anonymous "BatchNorm_0" level.
        if re.fullmatch(r"BatchNorm_\d+", m):
            i += 1
            continue
        out.append(m)
        i += 1
    return ".".join(out + [_LEAF_MAP.get(leaf, leaf)])


def _to_torch_layout(arr, leaf):
    if leaf in ("kernel", "pool_kernel"):
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return arr.T
    return arr


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, path)
        else:
            yield path, value


# The fields of the JAX package's SSLTrainState that hold module trees, and
# the port's prefix of each; and those that hold one array, kept by name.
_SSL_TREES = {"momentum_params": "momentum.", "predictor_params": "predictor."}
_SSL_ARRAYS = ("prototypes", "queue", "queue_ptr", "bank")


def state_dict_from_jax(variables):
    """flax variables -> state_dict: a param tree (nested dicts of arrays),
    or {"params": ..., "batch_stats": ...}, whose BatchNorm statistics
    become ``running_mean`` / ``running_var``; each BatchNorm also gets a
    ``num_batches_tracked`` of 0, which the JAX package does not keep. The
    latter may also hold the SSL state's fields (module docstring); a field
    that is None is left out."""
    if "params" in variables:
        trees = [("", variables["params"]), ("", variables.get("batch_stats") or {})]
        trees += [(prefix, variables[key]) for key, prefix in _SSL_TREES.items()
                  if variables.get(key) is not None]
    else:
        trees = [("", variables)]
    state = {}
    for prefix, tree in trees:
        for path, value in _leaves(tree):
            arr = _to_torch_layout(np.asarray(value, dtype=np.float32), path[-1])
            state[prefix + flax_path_to_torch(path)] = torch.from_numpy(
                np.array(arr, order="C")  # a writable copy
            )
    for name in [n for n in state if n.rsplit(".", 1)[-1] == "running_mean"]:
        state[name.removesuffix("running_mean") + "num_batches_tracked"] = torch.tensor(0)
    if "params" in variables:
        for key in _SSL_ARRAYS:
            if variables.get(key) is not None:
                dtype = np.int64 if key == "queue_ptr" else np.float32
                state[key] = torch.from_numpy(np.array(variables[key], dtype=dtype))
    return state


def load_jax_params(model, variables):
    """Load flax variables (``state_dict_from_jax``) into ``model`` with
    strict name/shape checks."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model
