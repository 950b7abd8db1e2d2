"""Visualization (`pmv_tpu/visualization`): the TensorBoard writer, Grad-CAM,
the prediction overlays and their drawing pool, the demo and the AVA demo."""
