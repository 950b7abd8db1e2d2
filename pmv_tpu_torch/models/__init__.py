from pmv_tpu_torch.models.build import MODEL_REGISTRY, build_model  # noqa: F401

# Import model modules so their @MODEL_REGISTRY.register() decorators run.
from pmv_tpu_torch.models import (  # noqa: F401
    avslowfast,
    contrastive,
    csn_r2plus1d,
    masked,
    mvit,
    resnet,
    uniformer,
    x3d,
)

# The PyTorchVideo builder's model names (`ptv_model_builder.py`) build the
# native models, as in the JAX package (PTVCSN and PTVR2plus1D are registered
# in csn_r2plus1d.py). The reference's PTVR3D builds with 2+1D bottlenecks
# (`ptv_model_builder.py:707-790`), so it names R(2+1)D.
MODEL_REGISTRY.register(resnet.build_resnet, name="PTVResNet")
MODEL_REGISTRY.register(resnet.build_slowfast, name="PTVSlowFast")
MODEL_REGISTRY.register(x3d.build_x3d, name="PTVX3D")
MODEL_REGISTRY.register(mvit.build_mvit, name="PTVMViT")
MODEL_REGISTRY.register(csn_r2plus1d.build_r2plus1d, name="PTVR3D")
