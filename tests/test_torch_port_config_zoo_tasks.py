"""The shipped yamls outside ``configs/Kinetics/`` (AVA, Charades, ImageNet,
SSv2, the contrastive and masked SSL yamls, the tiny ones) build in the port
with the JAX model's parameter count, as tests/test_torch_port_config_zoo.py
holds the Kinetics yamls."""

import pytest

from test_torch_port_config_zoo import CONFIGS, KINETICS, check_parameter_count, config_ids

OTHERS = [p for p in CONFIGS if p not in KINETICS]


@pytest.mark.parametrize("path", OTHERS, ids=config_ids(OTHERS))
def test_config_builds_with_the_jax_parameter_count(path):
    check_parameter_count(path)
