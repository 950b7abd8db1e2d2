"""Visualization (`pmv_tpu/visualization`): the TensorBoard writer. The model
and wrong-prediction visualization, the demo and Grad-CAM are not ported."""
