"""Prediction overlays (the reference's `VideoVisualizer`).

The port's copy of `pmv_tpu/visualization/video_vis.py`, PIL and numpy
alone, drawing the same pixels: the reference
`slowfast/visualization/video_visualizer.py` surface on PIL, a
deterministic per-class color palette (the reference samples a matplotlib
colormap by class id), top-k text with score-scaled alpha backgrounds,
score bars, a lower-third text block for clip-level predictions, and
labeled boxes for detection overlays.

The class-based `VideoVisualizer` below carries the reference's full
clip-annotation protocol (`video_visualizer.py:322-677`): "top-k" vs
"thres" label modes with a per-class threshold array built from
DEMO.COMMON_CLASS_NAMES, ground-truth overlays (red dashed boxes,
"[GT] name" labels, text below the box), prediction overlays (green
boxes, "[score] name" labels above the box), box alpha fading in/out
around the keyframe across `draw_clip_range`, and `repeat_frame`
slow-motion. matplotlib/Detectron2 drawing is replaced by PIL.
"""

import colorsys
import itertools

import numpy as np


def class_color(class_id, num_classes=400):
    """Deterministic palette: hue spread over classes (the reference
    samples `cm.get_cmap('rainbow')(i / num_classes)`)."""
    h = (class_id % max(num_classes, 1)) / max(num_classes, 1)
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def _text_w(text):
    return 6 * len(text) + 4


def draw_predictions(frame, preds, class_names, top_k=3, thres=0.0,
                     num_classes=None):
    """Lower-third top-k overlay with class colors and score bars.

    frame: uint8 [H, W, 3]; preds: [C] scores (post-softmax or sigmoid).
    Returns a new annotated uint8 array.
    """
    from PIL import Image, ImageDraw

    preds = np.asarray(preds, np.float32)
    num_classes = num_classes or len(preds)
    order = np.argsort(preds)[::-1][:top_k]
    order = [i for i in order if preds[i] >= thres] or [int(order[0])]

    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img, "RGBA")
    h, w = frame.shape[:2]
    line_h = 16
    y0 = h - line_h * len(order) - 6
    draw.rectangle([0, y0 - 2, w, h], fill=(0, 0, 0, 150))
    for row, i in enumerate(order):
        y = y0 + row * line_h
        color = class_color(int(i), num_classes)
        name = class_names[i] if i < len(class_names) else str(int(i))
        score = float(preds[i])
        # Score bar behind the text (reference: score-scaled alpha).
        bar_w = int((w - 8) * max(min(score, 1.0), 0.0))
        draw.rectangle([4, y + 2, 4 + bar_w, y + line_h - 3],
                       fill=color + (70,))
        draw.rectangle([4, y + 3, 12, y + line_h - 4], fill=color + (255,))
        draw.text((16, y), f"{name}: {score:.3f}", fill=(255, 255, 255, 255))
    return np.asarray(img.convert("RGB"))


def draw_boxes(frame, boxes, labels_per_box, num_classes=80):
    """Detection overlay: colored boxes + per-box label stacks.

    boxes: [N, 4] pixel xyxy; labels_per_box: list of [(class_id, name,
    score), ...] per box. Returns a new annotated uint8 array."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img, "RGBA")
    for box, labels in zip(boxes, labels_per_box):
        x1, y1, x2, y2 = [float(v) for v in box]
        box_color = (0, 255, 0)
        if labels:
            box_color = class_color(int(labels[0][0]), num_classes)
        draw.rectangle([x1, y1, x2, y2], outline=box_color + (255,), width=2)
        y = y1 + 2
        for cid, name, score in labels:
            text = f"{name}: {score:.2f}"
            c = class_color(int(cid), num_classes)
            draw.rectangle(
                [x1 + 2, y - 1, x1 + 2 + _text_w(text), y + 12],
                fill=c + (160,),
            )
            draw.text((x1 + 4, y), text, fill=(255, 255, 255, 255))
            y += 14
    return np.asarray(img.convert("RGB"))


def _create_text_labels(classes, scores, class_names, ground_truth=False):
    """`video_visualizer.py:18-42`: "[GT] name" or "[0.87] name" lines."""
    labels = [
        class_names[i] if 0 <= i < len(class_names) else str(int(i))
        for i in classes
    ]
    if ground_truth:
        return [f"[GT] {label}" for label in labels]
    if scores is not None:
        return [f"[{s:.2f}] {label}" for s, label in zip(scores, labels)]
    return labels


def _dashed_rectangle(draw, xyxy, color, width=2, dash=6):
    """PIL stand-in for the reference's matplotlib '--' GT box style."""
    x1, y1, x2, y2 = xyxy
    edges = [
        ((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
        ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1)),
    ]
    for (ax, ay), (bx, by) in edges:
        length = max(abs(bx - ax), abs(by - ay))
        n = max(int(length // dash), 1)
        for k in range(0, n, 2):
            t0, t1 = k / n, min((k + 1) / n, 1.0)
            draw.line(
                [(ax + (bx - ax) * t0, ay + (by - ay) * t0),
                 (ax + (bx - ax) * t1, ay + (by - ay) * t1)],
                fill=color, width=width,
            )


class VideoVisualizer:
    """Clip annotator with the reference surface (`video_visualizer.py:322`).

    Args mirror the reference constructor: ``mode`` is "top-k" (draw the
    ``top_k`` highest-scoring classes) or "thres" (draw every class whose
    score clears a per-class threshold: ``thres`` for classes named in
    ``common_class_names``, ``lower_thres`` for the rest —
    `video_visualizer.py:657-677`).
    """

    def __init__(self, num_classes, class_names_path="", top_k=1, thres=0.7,
                 lower_thres=0.3, common_class_names=None, colormap="rainbow",
                 mode="top-k"):
        assert mode in ("top-k", "thres"), f"Unknown mode {mode}"
        self.num_classes = num_classes
        self.mode = mode
        self.top_k = top_k
        self.thres = thres
        self.lower_thres = lower_thres
        if class_names_path:
            from pmv_tpu_torch.visualization.tensorboard_vis import get_class_names

            self.class_names = list(get_class_names(class_names_path))
        else:
            self.class_names = [str(i) for i in range(num_classes)]
        if mode == "thres":
            self._thres_array = self._get_thres_array(common_class_names)

    def _get_thres_array(self, common_class_names=None):
        thres_array = np.full((self.num_classes,), self.lower_thres,
                              np.float32)
        if common_class_names:
            common = set(common_class_names)
            ids = [i for i, n in enumerate(self.class_names) if n in common]
        else:
            ids = list(range(self.num_classes))
        thres_array[ids] = self.thres
        return thres_array

    def _get_color(self, class_id):
        return class_color(int(class_id), self.num_classes)

    def _top_labels(self, preds, ground_truth):
        """Per-instance (classes, scores) under the active mode."""
        if ground_truth:
            # preds is [num_boxes, ids...] or [ids...] of true class ids.
            rows = preds if isinstance(preds, (list, tuple)) else [preds]
            if rows and np.isscalar(rows[0]):
                rows = [rows]
            return [[int(c) for c in np.atleast_1d(r)] for r in rows], \
                   [None] * len(rows)
        preds = np.atleast_2d(np.asarray(preds, np.float32))
        classes, scores = [], []
        for row in preds:
            if self.mode == "top-k":
                order = np.argsort(row)[::-1][: self.top_k]
            else:
                order = np.nonzero(row >= self._thres_array[: len(row)])[0]
            classes.append([int(i) for i in order])
            scores.append([float(row[i]) for i in order])
        return classes, scores

    def _draw_label_stack(self, draw, labels, colors, anchor_xy, width,
                          above, text_alpha):
        """Stack label lines above (predictions) or below (ground truth)
        an anchor, one class-colored background per line
        (`draw_multiple_text`, `video_visualizer.py:110-220`)."""
        x, y = anchor_xy
        line_h = 14
        for i, (text, color) in enumerate(zip(labels, colors)):
            ty = y - (i + 1) * line_h if above else y + i * line_h
            draw.rectangle(
                [x, ty, x + _text_w(text), ty + line_h - 1],
                fill=color + (int(255 * text_alpha),),
            )
            draw.text((x + 2, ty + 1), text, fill=(255, 255, 255, 255))

    def draw_one_frame(self, frame, preds, bboxes=None, alpha=0.5,
                       text_alpha=0.7, ground_truth=False):
        """Annotate one frame (`video_visualizer.py:404-512`).

        preds: [C] or [num_boxes, C] scores (or class-id lists when
        ``ground_truth``); bboxes: optional [num_boxes, 4] pixel xyxy.
        ``alpha`` fades box edges (the clip fade); text is constant.
        Returns a new uint8 array.
        """
        from PIL import Image, ImageDraw

        classes, scores = self._top_labels(preds, ground_truth)
        img = Image.fromarray(np.ascontiguousarray(frame))
        draw = ImageDraw.Draw(img, "RGBA")
        h, w = frame.shape[:2]
        box_a = int(255 * max(min(alpha, 1.0), 0.0))
        if bboxes is not None and len(bboxes):
            for inst, box in enumerate(np.asarray(bboxes, np.float32)):
                labels = _create_text_labels(
                    classes[inst], scores[inst], self.class_names,
                    ground_truth=ground_truth,
                )
                colors = [self._get_color(c) for c in classes[inst]]
                x1, y1, x2, y2 = [float(v) for v in box]
                if ground_truth:
                    # Red dashed box, labels below (reference box_color="r",
                    # line_style="--", top_corner=False).
                    _dashed_rectangle(
                        draw, (x1, y1, x2, y2), (255, 32, 32, box_a)
                    )
                    self._draw_label_stack(
                        draw, labels, colors, (x1, y2 + 2), w,
                        above=False, text_alpha=text_alpha,
                    )
                else:
                    draw.rectangle([x1, y1, x2, y2],
                                   outline=(32, 255, 32, box_a), width=2)
                    self._draw_label_stack(
                        draw, labels, colors, (x1, y1 - 2), w,
                        above=True, text_alpha=text_alpha,
                    )
        else:
            labels = _create_text_labels(
                classes[0], scores[0], self.class_names,
                ground_truth=ground_truth,
            )
            colors = [self._get_color(c) for c in classes[0]]
            # Whole-frame anchor: predictions stack from the top edge,
            # ground truth from the bottom (reference top_corner logic).
            if ground_truth:
                self._draw_label_stack(draw, labels, colors,
                                       (2, h - 14 * len(labels) - 4), w,
                                       above=False, text_alpha=text_alpha)
            else:
                self._draw_label_stack(draw, labels, colors,
                                       (2, 14 * len(labels) + 4), w,
                                       above=True, text_alpha=text_alpha)
        return np.asarray(img.convert("RGB"))

    def draw_clip_range(self, frames, preds, bboxes=None, text_alpha=0.5,
                        ground_truth=False, keyframe_idx=None,
                        draw_range=None, repeat_frame=1):
        """Annotate ``frames[draw_range[0]:draw_range[1]+1]``, passing the
        rest through untouched (`video_visualizer.py:514-566`). Returns a
        list of frames (longer than the input when ``repeat_frame`` > 1).
        """
        frames = list(frames)
        if draw_range is None:
            draw_range = [0, len(frames) - 1]
        lo = max(0, int(draw_range[0]))
        hi = min(int(draw_range[1]), len(frames) - 1)
        if keyframe_idx is None:
            keyframe_idx = len(frames) // 2
        drawn = self.draw_clip(
            frames[lo:hi + 1], preds, bboxes=bboxes, text_alpha=text_alpha,
            ground_truth=ground_truth, keyframe_idx=keyframe_idx - lo,
            repeat_frame=repeat_frame,
        )
        return frames[:lo] + drawn + frames[hi + 1:]

    def draw_clip(self, frames, preds, bboxes=None, text_alpha=0.5,
                  ground_truth=False, keyframe_idx=None, repeat_frame=1):
        """Annotate every frame with box alpha fading 0->1 into the
        keyframe and back out (`video_visualizer.py:568-633`)."""
        assert repeat_frame >= 1
        seq = list(itertools.chain.from_iterable(
            itertools.repeat(i, repeat_frame) for i in range(len(frames))
        ))
        n = len(seq)
        if keyframe_idx is None:
            half_left, half_right = n // 2, (n + 1) // 2
        else:
            mid = int((keyframe_idx / max(len(frames), 1)) * n)
            half_left, half_right = mid, n - mid
        alphas = np.concatenate([
            np.linspace(0, 1, num=half_left),
            np.linspace(1, 0, num=half_right),
        ])
        return [
            self.draw_one_frame(
                frames[i], preds, bboxes, alpha=float(a),
                text_alpha=text_alpha, ground_truth=ground_truth,
            )
            for a, i in zip(alphas, seq)
        ]
