"""Shared helpers of the pmv_tpu_torch parity tests (tests/test_torch_port_*).

Inputs are made with numpy from a seed and handed to both packages; weights
go from the JAX parameter tree to the port through ``state_dict_from_jax``.
This module imports no JAX at import time, so that the CUDA tests, which
run where JAX is not installed, can use it.
"""

import numpy as np
import pytest
import torch
import yaml

import pmv_tpu_torch.config as port_config
from pmv_tpu_torch.ops import depthwise as port_depthwise


def port_cfg(jax_cfg):
    """The port's CfgNode holding the same values as a pmv_tpu config."""
    return port_config.CfgNode(yaml.safe_load(jax_cfg.dump()))


def numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def random_params(params, seed):
    """Every parameter redrawn with numpy, large enough that rel-pos tables,
    pool kernels and norms move the outputs (norm scales near 1)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, p):
        noise = rng.normal(size=tuple(p.shape)).astype(np.float32)
        return 1.0 + 0.1 * noise if str(path[-1].key) == "scale" else 0.3 * noise

    return jax.tree_util.tree_map_with_path(draw, params)


def to_np(t):
    return t.detach().float().numpy()


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 through chip_smoke.py)")
    return torch.device("cuda")


@pytest.fixture
def depthwise_calls(monkeypatch):
    """Counts the model's calls into ops.depthwise3x3x3. On the CPU the
    wrapper takes the plain version and launches nothing, so its launch
    count cannot show the path was taken; this spy can."""
    from pmv_tpu_torch.models import attention

    calls = []

    def spy(x, w):
        calls.append(tuple(x.shape))
        return port_depthwise.depthwise3x3x3(x, w)

    monkeypatch.setattr(attention, "depthwise3x3x3", spy)
    return calls
