from pmv_tpu_torch.models.build import MODEL_REGISTRY, build_model  # noqa: F401

# Import model modules so their @MODEL_REGISTRY.register() decorators run.
from pmv_tpu_torch.models import mvit  # noqa: F401
