"""RoIAlign on channels-last feature maps.

Counterpart of `pmv_tpu/ops/roi_align.py` (detectron2's ROIAlign as the
reference's ``ResNetRoIHead`` uses it): per output bin an s x s grid of
bilinear samples, averaged; ``aligned`` shifts the boxes by -0.5 pixel and
floors their size at 1e-6 (1 without it). As in the JAX package, every
sample point is clamped into [0, H - 1] x [0, W - 1], where detectron2
zeroes samples outside [-1, H] (ROADMAP.md records the difference). Plain
PyTorch ops; the JAX function is XLA, not a Pallas kernel.

The samples are gathered at their points from each box's map,
``features[b, y, x]`` for the box's batch index b, not from a copy of the
map per box. The box coordinates and the bilinear weights are float32 (the
JAX package's), so the result is float32 for bfloat16 or float32 features
and float64 for float64 ones.
"""

import torch


def roi_align(features, boxes, box_batch_idx, output_size, spatial_scale=1.0,
              sampling_ratio=2, aligned=True):
    """features [B, H, W, C]; boxes [N, 4] (x1, y1, x2, y2) in input
    coordinates; box_batch_idx [N] ints -> [N, out_h, out_w, C]."""
    out_h, out_w = output_size
    _, h, w, c = features.shape
    n = boxes.shape[0]
    dev = features.device
    boxes = boxes.to(dev, torch.float32) * spatial_scale
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (boxes[:, i] - offset for i in range(4))
    min_size = 1e-6 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=min_size) / out_w
    bin_h = torch.clamp(y2 - y1, min=min_size) / out_h
    s = sampling_ratio
    iy = (torch.arange(out_h * s, dtype=torch.float32, device=dev) + 0.5) / s
    ix = (torch.arange(out_w * s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]  # [N, out_h * s]
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]  # [N, out_w * s]

    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    y0i, x0i = y0.long(), x0.long()
    wy = (torch.clamp(ys, 0, h - 1) - y0)[:, :, None, None]
    wx = (torch.clamp(xs, 0, w - 1) - x0)[:, None, :, None]
    bidx = box_batch_idx.to(dev).long()[:, None, None]

    def at(yi, xi):  # [N, Y, X, C]
        return features[bidx, yi[:, :, None], xi[:, None, :]]

    grid = (at(y0i, x0i) * (1 - wy) * (1 - wx) + at(y0i, x1i) * (1 - wy) * wx
            + at(y1i, x0i) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return grid.reshape(n, out_h, s, out_w, s, c).mean(dim=(2, 4))
