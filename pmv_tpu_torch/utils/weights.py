"""Carry weights over from the JAX package's parameter trees.

``state_dict_from_jax(params)`` takes a flax param tree as nested dicts of
numpy arrays and returns a ``state_dict`` under the reference's PySlowFast
names (``blocks.3.attn.pool_q.weight``, ``blocks.3.attn.norm_q.weight``, ...),
in PyTorch's layouts, ready for ``load_state_dict(strict=True)``. It is the
inverse of the JAX package's torch importer (`utils/torch_import.py`), whose
name mapping is copied here.

Layouts (flax, channels-last -> torch):
- Dense kernel [in, out]                 -> Linear weight [out, in]
- Conv3d kernel [T, H, W, I, O]          -> Conv3d weight [O, I, T, H, W]
  (depthwise pool kernels [t, h, w, 1, C] -> [C, 1, t, h, w])
- Conv2d kernel [H, W, I, O]             -> Conv2d weight [O, I, H, W]
- LayerNorm / BatchNorm scale, bias      -> weight, bias
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


def state_dict_from_jax(params):
    """flax params (nested dicts of arrays, or {"params": ...}) -> state_dict."""
    if "params" in params:
        params = params["params"]
    state = {}
    for path, value in _leaves(params):
        arr = _to_torch_layout(np.asarray(value, dtype=np.float32), path[-1])
        state[flax_path_to_torch(path)] = torch.from_numpy(
            np.array(arr, order="C")  # a writable copy
        )
    return state


def load_jax_params(model, params):
    """Load a flax param tree into ``model`` with strict name/shape checks."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
