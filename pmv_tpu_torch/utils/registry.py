"""Minimal name->object registry (replaces fvcore Registry).

Used for DATASET_REGISTRY (`MViT/slowfast/datasets/build.py:6`) and
MODEL_REGISTRY (`MViT/slowfast/models/build.py:16`).
"""


class Registry:
    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    def register(self, obj=None, name=None):
        if obj is None:
            # Used as a decorator.
            def deco(fn_or_class):
                key = name if name is not None else fn_or_class.__name__
                self._do_register(key, fn_or_class)
                return fn_or_class

            return deco
        key = name if name is not None else obj.__name__
        self._do_register(key, obj)
        return obj

    def _do_register(self, name, obj):
        if name in self._obj_map:
            raise KeyError(
                f"'{name}' already registered in '{self._name}' registry"
            )
        self._obj_map[name] = obj

    def get(self, name):
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def keys(self):
        return self._obj_map.keys()

    def __contains__(self, name):
        return name in self._obj_map
