"""Write a small AVA-layout dataset from a seed, for the ``Ava`` dataset.

    python -m pmv_tpu_torch.tools.ava_dump --out DIR [--videos 8] [--frames 90]
        [--width 455] [--height 256] [--seed 0]

Under ``DIR``: ``frames/<video>/<frame>.jpg`` (a smooth random picture a
video, shifted and brightened frame by frame), ``frame_lists/{train,val}.csv``
(the same videos in both), and ``annotations/`` with every file the AVA
yamls (``configs/AVA/``) and the defaults name: the train groundtruth
``ava_train_v2.2.csv`` and the predicted-box lists of both splits (the
groundtruth boxes, each with a score of 0.95, and a low-scored box the
score threshold drops), the val groundtruth ``ava_val_v2.2.csv``, the label
map and the excluded timestamps. Keyframes at seconds 902 to 904 (frames
0, 30 and 60 of a 30 fps video); 1 to 4 people a keyframe, each with 1 to
3 of the action ids 1 to ``classes`` - 1 (``Ava`` keeps id a as class
column a, as the JAX package does), one box of each keyframe touching the
frame's edge. So a run points AVA.FRAME_DIR, FRAME_LIST_DIR and
ANNOTATION_DIR at it and changes nothing else of a yaml.
"""

import argparse
import os
import sys

import numpy as np

SECS = (902, 903, 904)
PREDICTED = ("person_box_67091280_iou90/ava_detection_train_boxes_and_labels_include_"
             "negative_v2.2.csv",
             "person_box_67091280_iou90/ava_detection_val_boxes_and_labels.csv",
             "ava_val_predicted_boxes.csv")


def _boxes(rng, n):
    """``n`` boxes (x1, y1, x2, y2) in [0, 1], the first touching an edge."""
    xy = rng.uniform(0.0, 0.6, (n, 2))
    wh = rng.uniform(0.2, 0.4, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], axis=1)
    boxes[0, rng.integers(4)] = 0.0 if rng.uniform() < 0.5 else 1.0
    boxes[0, :2], boxes[0, 2:] = np.minimum(boxes[0, :2], boxes[0, 2:]), \
        np.maximum(boxes[0, :2], boxes[0, 2:])
    return boxes


def write_ava_dump(root, videos=8, frames=90, width=455, height=256, classes=80, seed=0):
    """Write the dataset under ``root`` (module docstring); returns the
    (video, sec) keyframes in order."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    ann = os.path.join(root, "annotations")
    for d in ("frame_lists", os.path.join("annotations", "person_box_67091280_iou90")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    header = "original_vido_id video_id frame_id path labels"
    rows, gt, pred, keyframes = [header], [], [], []
    for v in range(videos):
        name = f"video{v:03d}"
        os.makedirs(os.path.join(root, "frames", name), exist_ok=True)
        base = Image.fromarray(rng.integers(0, 256, (9, 16, 3), np.uint8)).resize(
            (width + frames, height), Image.BILINEAR)
        for j in range(frames):
            path = f"{name}/{j:06d}.jpg"
            frame = base.crop((j, 0, j + width, height))
            frame.point(lambda p, j=j: min(255, p + j % 32)).save(
                os.path.join(root, "frames", path), quality=90)
            rows.append(f'{name} {v} {j} {path} ""')
        for sec in SECS:
            keyframes.append((name, sec))
            for person, box in enumerate(_boxes(rng, int(rng.integers(1, 5)))):
                coords = ",".join(f"{c:.3f}" for c in box)
                for action in sorted(rng.choice(np.arange(1, classes), int(rng.integers(1, 4)),
                                                replace=False)):
                    gt.append(f"{name},{sec},{coords},{action},{person}")
                    pred.append(f"{name},{sec},{coords},{action},0.95")
            low = ",".join(f"{c:.3f}" for c in _boxes(rng, 1)[0])
            pred.append(f"{name},{sec},{low},,0.10")
    for split in ("train", "val"):
        with open(os.path.join(root, "frame_lists", f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for filename, lines in [("ava_train_v2.2.csv", gt), ("ava_val_v2.2.csv", gt)] + [
            (p, pred) for p in PREDICTED]:
        with open(os.path.join(ann, filename), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(ann, "ava_action_list_v2.2_for_activitynet_2019.pbtxt"), "w") as f:
        for action in range(1, classes + 1):
            f.write(f'label {{\n  name: "action {action}"\n  label_id: {action}\n'
                    f'  label_type: PERSON_MOVEMENT\n}}\n')
    with open(os.path.join(ann, "ava_val_excluded_timestamps_v2.2.csv"), "w") as f:
        f.write(f"video{videos - 1:03d},0903\n")
    return keyframes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--videos", type=int, default=8)
    parser.add_argument("--frames", type=int, default=90)
    parser.add_argument("--width", type=int, default=455)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    keyframes = write_ava_dump(args.out, args.videos, args.frames, args.width, args.height,
                               seed=args.seed)
    print(f"{len(keyframes)} keyframes over {args.videos} videos in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
