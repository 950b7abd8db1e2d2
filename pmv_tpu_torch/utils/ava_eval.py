"""AVA action-detection evaluation: per-class PASCAL AP at IoU 0.5.

The port's copy of `pmv_tpu/utils/ava_eval.py` (numpy; the reference's
vendored object-detection evaluator and the protocol of
`ava_eval_helper.py:49-304`): the label-map, exclusion and groundtruth CSV
readers, the class whitelist, excluded timestamps, the conversion of the
model's scores to detections (vectorized, where the reference loops boxes
x classes in Python), and the PASCAL metric names. ``run_evaluation``
matches, per image and in insertion order, each detection to its
largest-IoU groundtruth box of its class if unclaimed and at IoU >= 0.5,
then sorts all of a class's detections by score for the all-points
interpolated AP; classes without groundtruth are left out of the mean
(``evaluate_detections_by_id``). ``evaluate_detections`` is the simpler
matcher by score over 0-based class columns.
"""

import csv
import time
from collections import defaultdict

import numpy as np

from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


def make_image_key(video_id, timestamp):
    """`ava_eval_helper.py:49-51`."""
    return "%s,%04d" % (video_id, int(timestamp))


def read_csv(csv_file, class_whitelist=None, load_score=False):
    """AVA-format csv -> (boxes, labels, scores) keyed dicts; boxes are
    [y1, x1, y2, x2] (`ava_eval_helper.py:54-88`)."""
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(csv_file, "r") as f:
        for row in csv.reader(f):
            if len(row) not in (7, 8):
                raise ValueError(f"{csv_file}: wrong number of columns: {row}")
            image_key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(n) for n in row[2:6])
            action_id = int(row[6])
            if class_whitelist and action_id not in class_whitelist:
                continue
            score = float(row[7]) if load_score else 1.0
            boxes[image_key].append([y1, x1, y2, x2])
            labels[image_key].append(action_id)
            scores[image_key].append(score)
    return boxes, labels, scores


def read_exclusions(exclusions_file):
    """csv of `video-id,timestamp` -> set of excluded image keys
    (`ava_eval_helper.py:91-105`)."""
    excluded = set()
    if exclusions_file:
        with open(exclusions_file, "r") as f:
            for row in csv.reader(f):
                if len(row) != 2:
                    raise ValueError(f"{exclusions_file}: expected 2 columns, got: {row}")
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(labelmap_file):
    """pbtxt label map -> (categories list, class-id set)
    (`ava_eval_helper.py:108-124`)."""
    labelmap = []
    class_ids = set()
    name = ""
    with open(labelmap_file, "r") as f:
        for line in f:
            if line.startswith("  name:"):
                name = line.split('"')[1]
            elif line.startswith("  id:") or line.startswith("  label_id:"):
                class_id = int(line.strip().split(" ")[-1])
                labelmap.append({"id": class_id, "name": name})
                class_ids.add(class_id)
    return labelmap, class_ids


def get_ava_mini_groundtruth(full_groundtruth):
    """Frames with sec % 4 == 0, for fast val (`meters.py:28-43`)."""
    ret = [defaultdict(list), defaultdict(list), defaultdict(list)]
    for i in range(3):
        for key in full_groundtruth[i]:
            if int(key.split(",")[1]) % 4 == 0:
                ret[i][key] = full_groundtruth[i][key]
    return ret


def get_ava_eval_data(
    scores, boxes, metadata, class_whitelist, video_idx_to_name=None
):
    """Model outputs -> AVA detection dicts (`ava_eval_helper.py:250-287`),
    vectorized (the reference loops boxes x classes in Python).

    scores: [N, C]; boxes: [N, 4] normalized (x1, y1, x2, y2);
    metadata: [N, 2] (video_idx, sec). Detection labels are 1-based
    (class column c -> action id c+1), whitelist-filtered.
    """
    scores = np.asarray(scores, np.float64)
    boxes = np.asarray(boxes, np.float64)
    metadata = np.asarray(metadata)
    n, c = scores.shape
    wl = sorted(a for a in class_whitelist if 1 <= a <= c)
    cls_cols = np.asarray([a - 1 for a in wl], np.int64)
    yxyx = boxes[:, [1, 0, 3, 2]]
    keys = np.asarray(
        [
            make_image_key(
                video_idx_to_name[int(np.round(m[0]))]
                if video_idx_to_name is not None
                else str(int(np.round(m[0]))),
                int(np.round(m[1])),
            )
            for m in metadata
        ]
    )
    out_boxes, out_labels, out_scores = {}, {}, {}
    labels_row = np.asarray(wl, np.int64)
    for key in np.unique(keys):
        sel = keys == key
        kb = yxyx[sel]  # [K, 4]
        ks = scores[sel][:, cls_cols]  # [K, W]
        out_boxes[key] = np.repeat(kb, len(wl), axis=0)
        out_labels[key] = np.tile(labels_row, kb.shape[0])
        out_scores[key] = ks.reshape(-1)
    return out_boxes, out_labels, out_scores


def run_evaluation(categories, groundtruth, detections, excluded_keys):
    """AVA evaluation main logic (`ava_eval_helper.py:175-247`): drop
    excluded timestamps, per-class PASCAL AP over whitelisted classes,
    reference metric-name format."""
    gt_boxes, gt_labels, _ = groundtruth
    det_boxes, det_labels, det_scores = detections
    gt = {}
    for key in gt_boxes:
        if key in excluded_keys:
            logger.info(
                "Found excluded timestamp in ground truth: %s. Ignored.", key
            )
            continue
        gt[key] = (
            np.asarray(gt_boxes[key], float).reshape(-1, 4),
            np.asarray(gt_labels[key], int),
        )
    det = {}
    for key in det_boxes:
        if key in excluded_keys:
            logger.info(
                "Found excluded timestamp in detections: %s. Ignored.", key
            )
            continue
        det[key] = (
            np.asarray(det_boxes[key], float).reshape(-1, 4),
            np.asarray(det_labels[key], int),
            np.asarray(det_scores[key], float),
        )
    class_ids = sorted(c["id"] for c in categories)
    id_to_name = {c["id"]: c["name"] for c in categories}
    mean_ap, aps = evaluate_detections_by_id(gt, det, class_ids)
    metrics = {"PascalBoxes_Precision/mAP@0.5IOU": mean_ap}
    for cid, ap in aps.items():
        metrics[
            "PascalBoxes_PerformanceByCategory/AP@0.5IOU/%s"
            % id_to_name.get(cid, str(cid))
        ] = ap
    return metrics


def evaluate_ava(
    preds,
    original_boxes,
    metadata,
    excluded_keys,
    class_whitelist,
    categories,
    groundtruth=None,
    video_idx_to_name=None,
    name="latest",
):
    """`ava_eval_helper.py:137-172` on numpy arrays. Returns mAP."""
    eval_start = time.time()
    detections = get_ava_eval_data(
        preds, original_boxes, metadata, class_whitelist,
        video_idx_to_name=video_idx_to_name,
    )
    logger.info("Evaluating with %d unique GT frames.", len(groundtruth[0]))
    logger.info(
        "Evaluating with %d unique detection frames", len(detections[0])
    )
    results = run_evaluation(
        categories, groundtruth, detections, excluded_keys
    )
    logger.info("AVA eval done in %f seconds.", time.time() - eval_start)
    return results["PascalBoxes_Precision/mAP@0.5IOU"]


def write_results(detections, filename):
    """Official AVA csv output (`ava_eval_helper.py:290-304`)."""
    boxes, labels, scores = detections
    with open(filename, "w") as f:
        for key in boxes:
            for box, label, score in zip(
                boxes[key], labels[key], scores[key]
            ):
                f.write(
                    "%s,%.03f,%.03f,%.03f,%.03f,%d,%.04f\n"
                    % (key, box[1], box[0], box[3], box[2], label, score)
                )
    logger.info("AVA results wrote to %s", filename)


def box_iou(a, b):
    """a: [N, 4], b: [M, 4] (x1, y1, x2, y2) -> [N, M] IoU."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(recalls, precisions):
    """All-points interpolated AP (PASCAL)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(groundtruth, detections, num_classes, iou_thresh=0.5):
    """Frame-level detection mAP.

    groundtruth: dict image_key -> (boxes [G, 4], labels [G]).
    detections: dict image_key -> (boxes [D, 4], labels [D], scores [D]).
    Returns (mAP, per_class_AP dict).
    """
    aps = {}
    for c in range(num_classes):
        # Collect per-image GT and detections of class c.
        npos = 0
        records = []  # (score, is_tp)
        gt_by_img = {}
        for key, (g_boxes, g_labels) in groundtruth.items():
            sel = np.asarray(g_labels) == c
            gt_by_img[key] = np.asarray(g_boxes)[sel]
            npos += int(sel.sum())
        if npos == 0:
            continue
        for key, (d_boxes, d_labels, d_scores) in detections.items():
            sel = np.asarray(d_labels) == c
            boxes = np.asarray(d_boxes)[sel]
            scores = np.asarray(d_scores)[sel]
            gts = gt_by_img.get(key, np.zeros((0, 4)))
            matched = np.zeros(len(gts), bool)
            order = np.argsort(-scores)
            for i in order:
                if len(gts) == 0:
                    records.append((scores[i], False))
                    continue
                ious = box_iou(boxes[i : i + 1], gts)[0]
                j = int(np.argmax(ious))
                if ious[j] >= iou_thresh and not matched[j]:
                    matched[j] = True
                    records.append((scores[i], True))
                else:
                    records.append((scores[i], False))
        if not records:
            aps[c] = 0.0
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.array([r[1] for r in records], dtype=np.float64)
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(1.0 - tps)
        recalls = tp_cum / npos
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        aps[c] = average_precision(recalls, precisions)
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return mean_ap, aps


def evaluate_detections_by_id(groundtruth, detections, class_ids,
                              iou_thresh=0.5):
    """Matcher keyed by explicit (1-based) action ids, bit-equal with the
    reference's vendored evaluator:
    - per image, detections match greedily in INSERTION order (the vendored
      `per_image_evaluation._compute_tp_fp_for_single_class` never sorts by
      score — `per_image_evaluation.py:335-345`), each taking its argmax-IoU
      ground truth if unclaimed;
    - the precision/recall curve then sorts all (score, tp) pairs globally
      by `np.argsort(scores)[::-1]` (`metrics.py:60-61`);
    - classes without ground truth are excluded from the mean (NaN +
      nanmean in the reference).
    """
    aps = {}
    for cid in class_ids:
        npos = 0
        gt_by_img = {}
        for key, (g_boxes, g_labels) in groundtruth.items():
            sel = np.asarray(g_labels) == cid
            gt_by_img[key] = np.asarray(g_boxes).reshape(-1, 4)[sel]
            npos += int(sel.sum())
        if npos == 0:
            continue
        all_scores = []
        all_tp = []
        for key, (d_boxes, d_labels, d_scores) in detections.items():
            sel = np.asarray(d_labels) == cid
            boxes = np.asarray(d_boxes).reshape(-1, 4)[sel]
            scores = np.asarray(d_scores)[sel]
            gts = gt_by_img.get(key, np.zeros((0, 4)))
            matched = np.zeros(len(gts), bool)
            for i in range(len(scores)):
                all_scores.append(scores[i])
                if len(gts) == 0:
                    all_tp.append(False)
                    continue
                ious = box_iou(boxes[i : i + 1], gts)[0]
                j = int(np.argmax(ious))
                if ious[j] >= iou_thresh and not matched[j]:
                    matched[j] = True
                    all_tp.append(True)
                else:
                    all_tp.append(False)
        if not all_scores:
            aps[cid] = 0.0
            continue
        order = np.argsort(np.asarray(all_scores))[::-1]
        tps = np.asarray(all_tp, np.float64)[order]
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(1.0 - tps)
        recalls = tp_cum / npos
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        aps[cid] = average_precision(recalls, precisions)
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return mean_ap, aps
