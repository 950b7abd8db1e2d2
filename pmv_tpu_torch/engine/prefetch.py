"""Host-to-device copies that overlap the train step.

Counterpart of `pmv_tpu/engine/prefetch.py` (the reference's pinned-memory
``non_blocking`` copies, `MViT/tools/train_net.py:88-111`). On a CUDA device
``DevicePrefetcher`` keeps ``depth`` batches ahead of the one the step is
working on: each batch's "frames", "labels" and, from a loader with
AUG.GEN_MASK_LOADER, "mask", from ``Kinetics_av`` the float32 log-mel
"audio" and "audio_mis", and from ``Ava`` the "boxes" and "box_mask" (its
"labels" are the boxes' multi-hot rows), go into pinned memory and
then to the card on a side stream, and the event recorded after the copy is
what the consuming stream waits on. The other keys (the "pm" flags, the
indices, AVA's "ori_boxes" and "metadata") stay numpy arrays on the
host, where the engine reads them without waiting for the card. ``record_stream`` tells the caching allocator that
the consuming stream uses the copies; the caching host allocator keeps a
pinned buffer until the copy out of it has ended, so no buffer is reused
early. On the CPU it passes batches through as they are.
"""

import collections

import torch

DEVICE_KEYS = ("frames", "labels", "mask", "audio", "audio_mis", "boxes", "box_mask")


class DevicePrefetcher:
    """Iterate ``loader``, yielding ``(host_batch, device_batch)``; with
    ``depth`` >= 1 and a CUDA ``device``, the copies of the next ``depth``
    batches are in flight while the caller works on this one."""

    def __init__(self, loader, device, depth=1):
        self._loader = loader
        self._device = torch.device(device)
        self._depth = int(depth)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the prefetcher")

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        if self._device.type != "cuda" or self._depth < 1:
            for batch in self._loader:
                yield batch, batch
            return
        stream = torch.cuda.Stream(self._device)
        ahead = collections.deque()
        for batch in self._loader:
            ahead.append(self._stage(batch, stream))
            if len(ahead) > self._depth:
                yield self._ready(*ahead.popleft())
        while ahead:
            yield self._ready(*ahead.popleft())

    def _stage(self, batch, stream):
        """Start the copies of one batch on ``stream``."""
        staged = dict(batch)
        with torch.cuda.stream(stream):
            for key in DEVICE_KEYS:
                if key in batch:
                    pinned = torch.as_tensor(batch[key]).pin_memory()
                    staged[key] = pinned.to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return batch, staged, done

    def _ready(self, batch, staged, done):
        """Make the current stream wait for the copies, and tell the
        allocator that it uses them."""
        current = torch.cuda.current_stream(self._device)
        current.wait_event(done)
        for key in DEVICE_KEYS:
            if key in staged:
                staged[key].record_stream(current)
        return batch, staged
