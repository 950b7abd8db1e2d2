from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_plain  # noqa: F401
