"""AVA-style demo with precomputed person boxes.

Counterpart of `pmv_tpu/visualization/ava_demo.py:40-272` (the reference's
`slowfast/visualization/ava_demo_precomputed_boxes.py`,
AVAVisualizerWithPrecomputedBox): person boxes come from a csv
(DEMO.PREDS_BOXES, AVA list format, through ``data/ava.py::
parse_bboxes_file``), each keyframe's clip (NUM_FRAMES at SAMPLING_RATE
around it, ``get_sequence``, short-side scaled to TEST_CROP_SIZE, no crop;
the boxes scaled by ``_scale_box_ratio``) runs through the port's detection
eval step at MAX_BOXES box slots, and the video is re-rendered through the
reference draw protocol (`ava_demo_precomputed_boxes.py:193-311`):
overlapping clips share a carried buffer, boxes fade in/out across
``draw_range`` (2/10 of the clip around the keyframe), predictions render
slowed down by DEMO.SLOWMO, and ground-truth boxes from DEMO.GT_BOXES
overlay as red dashed boxes.

Frames come from ``source`` (``native/binding.VideoReader`` on
DEMO.INPUT_VIDEO by default; the video's name for the box files is
INPUT_VIDEO's stem) and go to ``sink(path, frames, fps)``
(``binding.write_test_video`` by default), as in ``demo.py``.
"""

import os

import numpy as np

from pmv_tpu_torch.data import transform
from pmv_tpu_torch.data.ava import MAX_BOXES, _scale_box_ratio, get_sequence, parse_bboxes_file
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.device import resolve_device
from pmv_tpu_torch.visualization.demo import _write, build_video_visualizer

logger = pmv_logging.get_logger(__name__)


def load_boxes_labels(cfg, video_name, fps, img_width, img_height):
    """Load pred (and optional GT) boxes keyed by keyframe index, in display
    pixels, labels shifted to 0-based (`ava_demo_precomputed_boxes.py:390-467`).

    Returns (pred_boxes, gt_boxes): each maps frame_idx -> [boxes, labels]
    where boxes is a list of pixel xyxy and labels[i] a list of class ids.
    gt_boxes is None when DEMO.GT_BOXES is unset.
    """
    starting = cfg.DEMO.STARTING_SECOND

    def _one(path, is_gt):
        by_video = parse_bboxes_file(
            path, is_gt=is_gt, detect_thresh=cfg.AVA.DETECTION_SCORE_THRESH
        )
        if video_name in by_video:
            by_sec = by_video[video_name]
        elif len(by_video) == 1:
            by_sec = next(iter(by_video.values()))
        else:
            raise KeyError(
                f"{video_name} not in {path} (has {sorted(by_video)[:5]}...)"
            )
        out = {}
        for sec, entries in by_sec.items():
            if not entries:
                continue
            kf = int(round((sec - starting) * fps))
            boxes = np.array([b[0] for b in entries.values()], np.float32)
            boxes[:, [0, 2]] *= img_width
            boxes[:, [1, 3]] *= img_height
            labels = [
                [i - 1 for i in b[1]] for b in entries.values()
            ]  # 1-based AVA ids -> 0-based display ids
            out[kf] = [boxes.tolist(), labels]
        return out

    pred = _one(cfg.DEMO.PREDS_BOXES, is_gt=False)
    gt = _one(cfg.DEMO.GT_BOXES, is_gt=True) if cfg.DEMO.GT_BOXES else None
    return pred, gt


def merge_pred_gt_boxes(pred_dict, gt_dict=None):
    """frame_idx -> list of [is_gt, boxes, labels] (`visualization/utils.py`
    merge_pred_gt_boxes)."""
    merged = {k: [[False, v[0], v[1]]] for k, v in pred_dict.items()}
    if gt_dict is not None:
        for k, v in gt_dict.items():
            merged.setdefault(k, []).append([True, v[0], v[1]])
    return merged


def ava_demo(cfg, device=None, source=None, sink=None):
    """Render DEMO.INPUT_VIDEO (or ``source``) with action predictions for
    the person boxes listed in DEMO.PREDS_BOXES (plus DEMO.GT_BOXES
    overlays when given), on ``device`` (CUDA by default; raises without a
    CUDA device unless ``device="cpu"``). Returns the output path."""
    device = resolve_device(device)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    assert cfg.DEMO.INPUT_VIDEO and cfg.DEMO.PREDS_BOXES
    cfg = cfg.clone()
    cfg.DETECTION.ENABLE = True

    reader = source
    if reader is None:
        from pmv_tpu_torch.native import binding

        reader = binding.VideoReader(cfg.DEMO.INPUT_VIDEO)
    fps = max(reader.fps, 1.0)
    total = reader.num_frames
    video_name = os.path.splitext(os.path.basename(cfg.DEMO.INPUT_VIDEO))[0]

    pred_boxes, gt_boxes = load_boxes_labels(cfg, video_name, fps, reader.width, reader.height)

    crop = cfg.DATA.TEST_CROP_SIZE
    t = cfg.DATA.NUM_FRAMES
    stride = cfg.DATA.SAMPLING_RATE
    seq_len = t * stride

    model = build_model(cfg, device=device, seed=0)
    cu.load_test_checkpoint(cfg, model)
    det_step = steps.make_detection_eval_step(cfg, model, device=device)

    # --- predictions per keyframe (reference get_predictions): the clip
    # short-side scaled to TEST_CROP_SIZE, no crop; the boxes scaled by the
    # reference's `cv2_transform.scale_boxes` factor, the long side's floor
    # ratio (``_scale_box_ratio``), which RoIAlign sees.
    for kf in sorted(pred_boxes):
        boxes_px, _ = pred_boxes[kf]
        if kf < 0 or kf >= total:
            continue
        n = min(len(boxes_px), MAX_BOXES)
        if n == 0:
            continue
        seq = np.asarray(get_sequence(kf, seq_len // 2, stride, total)[:t])
        frames = reader.read_frames(seq).astype(np.float32)
        scaled = transform.short_side_scale(frames, crop)
        factor = _scale_box_ratio(frames.shape[1], frames.shape[2], crop)
        boxes_in = np.zeros((MAX_BOXES, 4), np.float32)
        boxes_in[:n] = np.asarray(boxes_px[:n], np.float32) * factor
        mask = np.zeros((MAX_BOXES,), bool)
        mask[:n] = True
        scores = det_step(np.clip(scaled, 0, 255).astype(np.uint8)[None], boxes_in[None],
                          mask[None])
        pred_boxes[kf][0] = boxes_px[:n]
        pred_boxes[kf][1] = scores.float().cpu().numpy()[0, :n]
        logger.info("keyframe %d: %d boxes predicted", kf, n)

    all_boxes = merge_pred_gt_boxes(pred_boxes, gt_boxes)
    video_vis = build_video_visualizer(cfg)

    # --- draw protocol (`ava_demo_precomputed_boxes.py:193-311`): clips
    # around consecutive keyframes overlap; a carried buffer keeps the
    # overlapping tail so fades compose; predictions repeat SLOWMO times
    # inside draw_range.
    no_repeat = max(int(cfg.DEMO.SLOWMO), 1)
    draw_range = [seq_len // 2 - seq_len // 10, seq_len // 2 + seq_len // 10]
    draw_range_repeat = [
        draw_range[0],
        (draw_range[1] - draw_range[0]) * no_repeat + draw_range[0],
    ]

    out_frames = []

    def display(frames):
        for f in frames:
            out_frames.append(np.ascontiguousarray(f, np.uint8))

    def frame_range(start, num):
        if num <= 0 or start >= total:
            return []
        idx = np.arange(start, min(start + num, total))
        return list(reader.read_frames(idx))

    prev_buffer = []
    prev_end_idx = 0
    for kf in sorted(k for k in all_boxes if 0 <= k < total):
        start_idx = max(0, kf - seq_len // 2)
        dist = start_idx - prev_end_idx
        if dist >= 0:
            display(prev_buffer)
            display(frame_range(prev_end_idx, dist))
            prev_buffer = []
            num_new = seq_len
        else:
            display(prev_buffer[:dist])
            prev_buffer = prev_buffer[dist:]
            num_new = seq_len + dist
        new_frames = frame_range(max(start_idx, prev_end_idx), num_new)
        clip = prev_buffer + new_frames
        prev_end_idx = max(start_idx, prev_end_idx) + len(new_frames)
        for i, (is_gt, boxes, labels) in enumerate(all_boxes[kf]):
            if not len(boxes):
                continue
            # Reference branches on entry INDEX, not is_gt
            # (`ava_demo_precomputed_boxes.py:275-281`): the first entry
            # gets repeat=SLOWMO + the base draw_range, later entries
            # repeat=1 + the repeat-extended range — so a GT-only
            # keyframe is slowed down like a prediction would be.
            if i == 0:
                repeat, rng = no_repeat, draw_range
            else:
                repeat, rng = 1, draw_range_repeat
            if is_gt:
                preds = labels
            else:
                preds = np.asarray(labels, np.float32)
                if preds.ndim != 2 or not preds.shape[1]:
                    continue  # keyframe never scored (off-video)
            rng = [rng[0], min(rng[1], len(clip) - 1)]
            clip = video_vis.draw_clip_range(
                clip,
                preds,
                bboxes=np.asarray(boxes, np.float32),
                ground_truth=is_gt,
                draw_range=rng,
                repeat_frame=repeat,
            )
        prev_buffer = clip
    display(prev_buffer)
    display(frame_range(prev_end_idx, total - prev_end_idx))
    if source is None:
        reader.close()

    out_path = cfg.DEMO.OUTPUT_FILE or os.path.join(cfg.OUTPUT_DIR, "ava_demo_out.avi")
    out_fps = cfg.DEMO.OUTPUT_FPS if cfg.DEMO.OUTPUT_FPS > 0 else int(fps)
    _write(sink, out_path, np.stack(out_frames), out_fps)
    logger.info("AVA demo output written to %s", out_path)
    return out_path
