"""Demo: action recognition over a video, written out annotated.

Counterpart of `pmv_tpu/visualization/demo.py:96-251` (the reference's
`MViT/tools/demo_net.py` and `slowfast/visualization/{demo_loader,
predictor,async_predictor,video_visualizer}.py`):

- frames come from ``source`` (the port's FFmpeg reader, ``native/
  binding.VideoReader``, on DEMO.INPUT_VIDEO by default), or, with
  DEMO.WEBCAM >= 0, from cv2.VideoCapture, imported only then;
- clip windows follow the reference protocol (`demo_loader.py:228-266`):
  each task carries DATA.NUM_FRAMES x SAMPLING_RATE consecutive new
  frames plus DEMO.BUFFER_SIZE carried-over frames; every
  (NUM_CLIPS_SKIP+1)-th task is predicted by the port's eval step on
  NUM_FRAMES frames picked by linspace over the window, short-side scaled
  and centre-cropped to TEST_CROP_SIZE (``data/transform.py``); the rest
  pass through unannotated; a final partial window is padded with its last
  frame for the model and trimmed again, so every source frame is written
  exactly once;
- drawing runs on the ``AsyncVis`` pool (DEMO.NUM_VIS_INSTANCES workers)
  through ``VideoVisualizer`` (top-k/thres modes, keyframe fade,
  CLIP_VIS_SIZE draw range);
- the frames go to ``sink(path, frames, fps)`` (``binding.write_test_video``
  by default, an uncompressed AVI) at DEMO.OUTPUT_FILE, else
  OUTPUT_DIR/demo_out.avi.

``source`` and ``sink`` let a caller feed frames from memory and keep what
comes out: an object with ``fps``, ``num_frames``, ``width``, ``height``,
``read_frames(indices)`` -> uint8 [N, H, W, 3] and ``close()``, as the
binding's reader has; the card's host has no FFmpeg to decode or write.
"""

import os
import queue
import threading
import time

import numpy as np

from pmv_tpu_torch.data import transform
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.device import resolve_device
from pmv_tpu_torch.visualization.async_vis import AsyncVis, TaskInfo
from pmv_tpu_torch.visualization.video_vis import VideoVisualizer

logger = pmv_logging.get_logger(__name__)


def _cv2_stream_windows(cap, seq_len):
    """Yield ``(window, real_len)``: consecutive ``seq_len``-frame windows
    (RGB uint8 [T, H, W, 3]) from an opened cv2.VideoCapture until the
    stream ends; a final partial window padded by repeating its last frame."""
    import cv2

    buf = []
    while True:
        ret, frame = cap.read()
        if not ret:
            if buf:
                real = len(buf)
                while len(buf) < seq_len:
                    buf.append(buf[-1])
                yield np.stack(buf), real
            return
        buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if len(buf) == seq_len:
            yield np.stack(buf), seq_len
            buf = []


def file_windows(reader, seq_len):
    """Yield ``(window, real_len)`` windows of ``reader``; the final partial
    window padded with its last frame."""
    total = reader.num_frames
    for start in range(0, total, seq_len):
        idx = np.minimum(np.arange(start, start + seq_len), total - 1)
        yield reader.read_frames(idx.astype(np.int64)), min(seq_len, total - start)


def build_video_visualizer(cfg):
    """VideoVisualizer from the DEMO config surface (`demo_net.py:39-54`)."""
    common_classes = cfg.DEMO.COMMON_CLASS_NAMES if cfg.DEMO.LABEL_FILE_PATH else None
    return VideoVisualizer(
        num_classes=cfg.MODEL.NUM_CLASSES,
        class_names_path=cfg.DEMO.LABEL_FILE_PATH,
        top_k=cfg.TENSORBOARD.MODEL_VIS.TOPK_PREDS,
        thres=cfg.DEMO.COMMON_CLASS_THRES,
        lower_thres=cfg.DEMO.UNCOMMON_CLASS_THRES,
        common_class_names=common_classes,
        colormap=cfg.TENSORBOARD.MODEL_VIS.COLORMAP,
        mode=cfg.DEMO.VIS_MODE,
    )


def window_clip(frames, num_frames, size):
    """The model's clip of a window: ``num_frames`` frames by linspace
    (`visualization/utils.py:318` process_cv2_inputs), short-side scaled to
    ``size`` and centre-cropped, uint8 [num_frames, size, size, 3]."""
    idx = np.linspace(0, len(frames) - 1, num_frames).astype(np.int64)
    clip = transform.short_side_scale(frames[idx].astype(np.float32), size)
    clip = transform.uniform_crop(clip, size, 1)
    return np.clip(clip, 0, 255).astype(np.uint8)


def _write(sink, out_path, frames, fps):
    if sink is None:
        from pmv_tpu_torch.native import binding

        sink = binding.write_test_video
    sink(out_path, frames, fps=fps)


def demo(cfg, device=None, source=None, sink=None):
    """Annotate DEMO.INPUT_VIDEO, a DEMO.WEBCAM stream or ``source`` with
    per-window predictions on ``device`` (CUDA by default; raises without a
    CUDA device unless ``device="cpu"``). Returns the output path."""
    device = resolve_device(device)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    use_webcam = source is None and cfg.DEMO.WEBCAM >= 0
    assert use_webcam or source is not None or cfg.DEMO.INPUT_VIDEO, (
        "DEMO.INPUT_VIDEO must point at a video file (or set DEMO.WEBCAM)"
    )
    cfg = cfg.clone()
    cfg.TEST.PROCESS = True
    t = cfg.DATA.NUM_FRAMES
    seq_len = t * cfg.DATA.SAMPLING_RATE
    assert cfg.DEMO.BUFFER_SIZE <= seq_len // 2, (
        "Buffer size cannot be greater than half of sequence length."
    )
    size = cfg.DATA.TEST_CROP_SIZE
    num_skip = cfg.DEMO.NUM_CLIPS_SKIP + 1

    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    cu.load_test_checkpoint(cfg, model)
    eval_step = steps.make_eval_step(cfg, model, device=device)

    async_vis = AsyncVis(build_video_visualizer(cfg), n_workers=cfg.DEMO.NUM_VIS_INSTANCES)

    cap = opened = None
    if use_webcam:
        import cv2

        cap = cv2.VideoCapture(cfg.DEMO.WEBCAM)
        assert cap.isOpened(), f"cannot open webcam {cfg.DEMO.WEBCAM}"
        if cfg.DEMO.DISPLAY_WIDTH > 0:
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.DEMO.DISPLAY_WIDTH)
        if cfg.DEMO.DISPLAY_HEIGHT > 0:
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.DEMO.DISPLAY_HEIGHT)
        src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        windows = _cv2_stream_windows(cap, seq_len)
        logger.info("Demo: webcam %d (%.1f fps)", cfg.DEMO.WEBCAM, src_fps)
    else:
        if source is None:
            from pmv_tpu_torch.native import binding

            source = opened = binding.VideoReader(cfg.DEMO.INPUT_VIDEO)
        src_fps = source.fps
        windows = file_windows(source, seq_len)
        logger.info("Demo: %s (%d frames, %.1f fps)", cfg.DEMO.INPUT_VIDEO or "frames given",
                    source.num_frames, source.fps)

    decode_q = queue.Queue(maxsize=4)
    err_q = queue.Queue()

    def decoder_stage():
        buffer = None
        for i, (frames, real_len) in enumerate(windows):
            task = TaskInfo(
                num_buffer_frames=0 if buffer is None else len(buffer),
                img_height=frames.shape[1],
                img_width=frames.shape[2],
                crop_size=size,
                clip_vis_size=cfg.DEMO.CLIP_VIS_SIZE,
                num_pad_frames=len(frames) - real_len,
            )
            task.add_frames(i, frames if buffer is None else np.concatenate([buffer, frames]))
            if cfg.DEMO.BUFFER_SIZE > 0:
                buffer = frames[-cfg.DEMO.BUFFER_SIZE:]
            decode_q.put(task)
        if cap is not None:
            cap.release()
        decode_q.put(None)

    n_tasks = [0]
    predict_done = threading.Event()

    def predict_stage():
        while True:
            task = decode_q.get()
            if task is None:
                predict_done.set()
                return
            if task.id % num_skip == 0:
                preds = eval_step(window_clip(task.frames, t, size)[None])
                task.action_preds = preds.float().cpu().numpy()[0]
            async_vis.get_indices_ls.append(task.id)
            async_vis.put(task)
            n_tasks[0] += 1

    def run_stage(fn):
        # A stage's failure surfaces in this thread instead of leaving the
        # pipeline waiting on a queue that never fills.
        def wrapped():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001
                err_q.put(e)
                predict_done.set()

        thread = threading.Thread(target=wrapped, daemon=True)
        thread.start()
        return thread

    threads = [run_stage(decoder_stage), run_stage(predict_stage)]
    out_frames = []
    received = 0
    try:
        while True:
            if not err_q.empty():
                raise err_q.get()
            if predict_done.is_set() and received == n_tasks[0]:
                break
            try:
                task = async_vis.get()
            except (queue.Empty, IndexError):
                time.sleep(0.01)
                continue
            received += 1
            emit = np.asarray(task.frames)[task.num_buffer_frames:]
            if task.num_pad_frames:
                emit = emit[: len(emit) - task.num_pad_frames]
            out_frames.extend(np.ascontiguousarray(f, np.uint8) for f in emit)
        for thread in threads:
            thread.join()
    finally:
        async_vis.shutdown()
        if opened is not None:
            opened.close()

    out_path = cfg.DEMO.OUTPUT_FILE or os.path.join(cfg.OUTPUT_DIR, "demo_out.avi")
    fps = cfg.DEMO.OUTPUT_FPS if cfg.DEMO.OUTPUT_FPS > 0 else int(max(src_fps, 1))
    _write(sink, out_path, np.stack(out_frames), fps)
    logger.info("Demo output written to %s", out_path)
    return out_path
