"""User extension point for config keys.

Mirrors `MViT/slowfast/config/custom_config.py:7-9`: downstream projects add
their own default keys here (or monkeypatch this function) and they become
part of every `get_cfg()` tree before YAML/`--opts` merging.
"""


def add_custom_config(_C):
    # Add your own customized configs, e.g.
    # _C.MY_PROJECT = CfgNode(); _C.MY_PROJECT.MY_KEY = ...
    pass
