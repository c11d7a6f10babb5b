"""Name -> object registries (reference wm_basicsr/utils/registry.py), the
port's copy of comfyui_keep_tpu/utils/registry.py. ARCH_REGISTRY holds the
port's nn.Module classes under the JAX package's arch names; METRIC_REGISTRY
the metric functions that `metrics.calculate_metric` dispatches to;
DATASET_REGISTRY, MODEL_REGISTRY and LOSS_REGISTRY the datasets, trainers
and losses that `data.build_dataset`, `training.trainers.build_model` and
`training.losses.build_loss` look up by the options' `type` /
`model_type`.
"""
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: Optional[str] = None):
        """Register obj under `name` (its __name__ by default); without obj,
        a decorator."""
        if obj is None:
            def deco(o):
                self._register(name or o.__name__, o)
                return o
            return deco
        self._register(name or obj.__name__, obj)
        return obj

    def _register(self, name: str, obj: Any):
        if name in self._obj_map:
            raise KeyError(f"'{name}' already registered in '{self._name}'")
        self._obj_map[name] = obj

    def get(self, name: str):
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"'{name}' not found in '{self._name}' registry. "
                           f"Available: {sorted(self._obj_map)}")
        return ret

    def __contains__(self, name: str):
        return name in self._obj_map

    def __iter__(self):
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
