"""Dataset registry (`MViT/slowfast/datasets/build.py:6-32`)."""

from pmv_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(dataset_name, cfg, split):
    """Capitalized name lookup, matching the reference convention."""
    name = dataset_name.capitalize()
    return DATASET_REGISTRY.get(name)(cfg, split)
