"""Asynchronous visualization pipeline (async_predictor.py parity).

The port's copy of `pmv_tpu/visualization/async_vis.py`. The reference
(`slowfast/visualization/async_predictor.py:17-319`) runs two
multiprocess pools: per-GPU `AsycnActionPredictor` workers and per-CPU
`AsyncVis` drawing workers, joined by ordered result queues. Here, as in
the JAX package, prediction is one eval step a window on one device, so only
the drawing pool survives the translation: PIL annotation is CPU-bound
Python and parallelizes across processes.

Components:
- `TaskInfo`: the unit of work flowing decode -> predict -> draw -> write
  (reference `slowfast/utils/misc.py` TaskInfo surface).
- `AsyncVis`: N worker processes drawing via a `VideoVisualizer`, with the
  reference's ordered `get()` protocol (results may complete out of order;
  consumers receive tasks in put order).
- `draw_predictions(task, video_vis)`: keyframe/draw-range/buffer logic
  (reference `async_predictor.py:276-319`).

The JAX package forks its workers. The port's demo makes its pool after
CUDA is initialised and while its decode and predict threads run, where a
fork may copy a lock that another thread holds: the workers start by
``spawn``, so the `VideoVisualizer` is pickled to them, and they draw with
PIL and numpy alone. ``shutdown`` joins them.
"""

import atexit
import dataclasses
import multiprocessing as mp
import queue
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class TaskInfo:
    """One clip window moving through the demo pipeline."""

    id: int = -1
    frames: Any = None  # [num_buffer + seq_len, H, W, 3] uint8
    num_buffer_frames: int = 0
    img_height: int = 0
    img_width: int = 0
    crop_size: int = 0
    clip_vis_size: int = 10
    action_preds: Any = None  # [C] or [num_boxes, C] scores; None = skipped
    bboxes: Any = None  # [num_boxes, 4] crop-space xyxy or None
    num_pad_frames: int = 0  # repeated tail frames (final partial window)

    def add_frames(self, idx, frames):
        self.id = idx
        self.frames = np.asarray(frames)


class _StopToken:
    pass


def revert_scaled_boxes(crop_size, boxes, img_height, img_width):
    """Map crop-space boxes back to original pixels (reference
    `cv2_transform.revert_scaled_boxes`): undo the short-side-to-crop_size
    scale."""
    scale = min(img_height, img_width) / float(crop_size)
    return np.asarray(boxes, np.float32) * scale


def draw_predictions(task, video_vis):
    """Annotate a task's frames (reference `async_predictor.py:276-319`):
    boxes reverted to source pixels, labels drawn only within
    ``clip_vis_size`` frames of the keyframe, buffer frames passed through.
    Returns the full frame list (buffer + annotated + tail)."""
    boxes = task.bboxes
    frames = list(task.frames)
    preds = task.action_preds
    if boxes is not None and len(boxes):
        boxes = revert_scaled_boxes(
            task.crop_size, boxes, task.img_height, task.img_width
        )

    keyframe_idx = len(frames) // 2 - task.num_buffer_frames
    draw_range = [
        keyframe_idx - task.clip_vis_size,
        keyframe_idx + task.clip_vis_size,
    ]
    buffer = frames[: task.num_buffer_frames]
    frames = frames[task.num_buffer_frames:]
    if boxes is not None:
        if len(boxes) != 0:
            frames = video_vis.draw_clip_range(
                frames, preds, boxes,
                keyframe_idx=keyframe_idx, draw_range=draw_range,
            )
    else:
        frames = video_vis.draw_clip_range(
            frames, preds,
            keyframe_idx=keyframe_idx, draw_range=draw_range,
        )
    return buffer + list(frames)


def _vis_worker(video_vis, task_queue, result_queue):
    """Worker loop (reference `AsyncVis._VisWorker.run`). Tasks with
    ``action_preds is None`` (NUM_CLIPS_SKIP pass-throughs) echo their
    frames unannotated."""
    while True:
        task = task_queue.get()
        if isinstance(task, _StopToken):
            return
        if task.action_preds is not None:
            task.frames = np.array(draw_predictions(task, video_vis))
        result_queue.put(task)


class AsyncVis:
    """Ordered multiprocess drawing pool (reference `AsyncVis`,
    `async_predictor.py:126-230`).

    ``n_workers`` <= 0 runs synchronously in-process (used by tests and
    single-core hosts). ``get()`` raises ``queue.Empty`` until the next
    task *in put order* is ready.
    """

    def __init__(self, video_vis, n_workers=None):
        n_workers = mp.cpu_count() if n_workers is None else n_workers
        self.video_vis = video_vis
        self.get_indices_ls = []
        self.result_data = {}
        self.put_id = -1
        self.procs = []
        if n_workers > 0:
            ctx = mp.get_context("spawn")
            self.task_queue = ctx.Queue()
            self.result_queue = ctx.Queue()
            for _ in range(n_workers):
                p = ctx.Process(
                    target=_vis_worker,
                    args=(video_vis, self.task_queue, self.result_queue),
                    daemon=True,
                )
                p.start()
                self.procs.append(p)
            atexit.register(self.shutdown)
        else:
            self.task_queue = None
            self.result_queue = queue.Queue()

    def put(self, task):
        self.put_id += 1
        if self.task_queue is not None:
            self.task_queue.put(task)
        else:
            if task.action_preds is not None:
                task.frames = np.array(
                    draw_predictions(task, self.video_vis)
                )
            self.result_queue.put(task)

    def get(self):
        """Next result in put order, or raise queue.Empty."""
        get_idx = self.get_indices_ls[0]
        if self.result_data.get(get_idx) is not None:
            res = self.result_data.pop(get_idx)
            del self.get_indices_ls[0]
            return res
        while True:
            res = self.result_queue.get(block=False)
            if res.id == get_idx:
                del self.get_indices_ls[0]
                return res
            self.result_data[res.id] = res

    def shutdown(self, timeout=30.0):
        """Stop the workers and wait for them (``timeout`` seconds each, then
        terminate)."""
        if self.task_queue is not None:
            for _ in self.procs:
                self.task_queue.put(_StopToken())
        for p in self.procs:
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join()
        self.procs = []
