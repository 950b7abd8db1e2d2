"""A lightweight yacs-style configuration node.

Mirrors the config *surface* of the reference's fvcore `CfgNode`
(`MViT/slowfast/config/defaults.py`, `MViT/slowfast/utils/parser.py:67-94`):
attribute access, nested groups, YAML file merge, and `--opts KEY VALUE`
list merge with literal-eval type coercion. Implemented from scratch so the
framework has no fvcore/yacs dependency.
"""

import ast
import copy

import yaml


class CfgNode(dict):
    """Nested attribute-accessible config dictionary with type-checked merge."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            self[k] = v

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(
            f"Config key '{name}' not found. Available: {sorted(self.keys())[:20]}..."
        )

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]

    def clone(self):
        return copy.deepcopy(self)

    # ------------------------------------------------------------------ merge
    def merge_from_other_cfg(self, other):
        _merge_a_into_b(other, self, key_path=[])

    def merge_from_file(self, cfg_filename, allow_unsafe=False):
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_a_into_b(CfgNode(loaded), self, key_path=[])

    def merge_from_list(self, cfg_list):
        assert len(cfg_list) % 2 == 0, (
            f"Override list has odd length: {cfg_list}; it must be a list of pairs"
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            key_parts = full_key.split(".")
            d = self
            for sub_key in key_parts[:-1]:
                assert sub_key in d, f"Non-existent key: {full_key}"
                d = d[sub_key]
            sub_key = key_parts[-1]
            assert sub_key in d, f"Non-existent key: {full_key}"
            value = _decode_cfg_value(v)
            value = _check_and_coerce_cfg_value_type(value, d[sub_key], full_key)
            d[sub_key] = value

    # ------------------------------------------------------------------- dump
    def dump(self):
        def _to_dict(node):
            if isinstance(node, CfgNode):
                return {k: _to_dict(v) for k, v in node.items()}
            return node

        return yaml.safe_dump(_to_dict(self), default_flow_style=None)

    def __repr__(self):
        return f"CfgNode({dict.__repr__(self)})"


class FrozenCfg:
    """Immutable attribute-access view of a CfgNode.

    Used at the flax module boundary: linen rewrites dict attributes into
    FrozenDicts (losing attribute access), but leaves plain objects alone.
    Lists become tuples so the object is fully hashable / trace-stable.
    """

    def __init__(self, d):
        for k, v in d.items():
            if isinstance(v, dict):
                v = FrozenCfg(v)
            elif isinstance(v, list):
                v = _freeze_seq(v)
            object.__setattr__(self, k, v)

    def __setattr__(self, name, value):
        raise AttributeError("FrozenCfg is immutable")

    def __repr__(self):
        return f"FrozenCfg({self.__dict__})"


def _freeze_seq(v):
    return tuple(
        _freeze_seq(x) if isinstance(x, list) else x for x in v
    )


def freeze_cfg(cfg):
    return FrozenCfg(cfg)


def _merge_a_into_b(a, b, key_path):
    for k, v_a in a.items():
        full_key = ".".join(key_path + [str(k)])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v_b = b[k]
        if isinstance(v_b, CfgNode):
            if not isinstance(v_a, (dict, CfgNode)):
                raise ValueError(
                    f"Cannot merge non-dict into config group {full_key}"
                )
            _merge_a_into_b(CfgNode(v_a), v_b, key_path + [str(k)])
        else:
            v_a = _decode_cfg_value(v_a)
            v_a = _check_and_coerce_cfg_value_type(v_a, v_b, full_key)
            b[k] = v_a


def _decode_cfg_value(v):
    """Decode a raw (possibly string) override value via literal_eval."""
    if isinstance(v, dict):
        return CfgNode(v)
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce_cfg_value_type(replacement, original, full_key):
    """Coerce `replacement` to the type of `original` when compatible."""
    original_type = type(original)
    replacement_type = type(replacement)
    if original is None or replacement is None:
        return replacement
    if replacement_type is original_type:
        return replacement
    # Allowed casts (same as yacs): list<->tuple, int->float, str<->unicode.
    if isinstance(replacement, tuple) and isinstance(original, list):
        return list(replacement)
    if isinstance(replacement, list) and isinstance(original, tuple):
        return tuple(replacement)
    if isinstance(replacement, int) and isinstance(original, float):
        return float(replacement)
    if isinstance(replacement, bool) != isinstance(original, bool):
        # Do not silently coerce bool<->int mixups beyond python semantics.
        if isinstance(original, bool) and replacement in (0, 1):
            return bool(replacement)
    raise ValueError(
        f"Type mismatch ({original_type} vs {replacement_type}) for config "
        f"key {full_key}: cannot replace {original!r} with {replacement!r}"
    )
