"""Input pipeline: a thread pool of decode workers and a bounded queue of
collated numpy batches.

Counterpart of `pmv_tpu/data/loader.py` (`MViT/slowfast/datasets/
loader.py`). The decoder is native code that releases the GIL, so threads
decode in parallel without pickling every clip between processes, as
``torch.utils.data.DataLoader``'s worker processes would. Each rank draws
its slice of the epoch's permutation (``DistributedSampler``'s role); the
rank and world size come from ``torch.distributed`` when it is initialised,
else 0 and 1. The order of a (RNG_SEED, epoch) is the JAX package's.
Batches are numpy arrays; ``engine/prefetch.py`` moves them to the card.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.utils.device import rank_and_world_size


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size,
        shuffle=False,
        drop_last=False,
        num_workers=8,
        prefetch_depth=2,
        seed=0,
        rank=0,
        world_size=1,
        collate=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.seed = seed
        self.epoch = 0
        self.rank = rank
        self.world_size = world_size
        self.collate = collate or _collate

    def set_epoch(self, epoch):
        """Reseed the shuffle and the dataset's draws (reference
        `loader.shuffle_dataset`)."""
        self.epoch = epoch
        if hasattr(self.dataset, "_set_epoch_num"):
            self.dataset._set_epoch_num(epoch)

    def _epoch_indices(self):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            order = np.arange(n)
        shard = order[self.rank::self.world_size]
        if self.drop_last:
            shard = shard[:(len(shard) // self.batch_size) * self.batch_size]
        return shard

    def __len__(self):
        shard_len = (len(self.dataset) + self.world_size - 1) // self.world_size
        if self.drop_last:
            return shard_len // self.batch_size
        return (shard_len + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = self._epoch_indices()
        batches = [
            indices[i:i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        out_q = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                (int(i) for i in batch_idx)))
                        out_q.put(self.collate(samples))
            except Exception as e:  # raised again in the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # drain, so that the producer can end
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()


def _collate(samples):
    """Stack sample dicts into a batch of numpy arrays."""
    labels = [s["label"] for s in samples]
    return {
        "frames": np.stack([s["frames"] for s in samples]),
        "labels": (
            np.stack(labels)
            if isinstance(labels[0], np.ndarray)
            else np.asarray(labels, np.int64)
        ),
        "index": np.asarray([s["index"] for s in samples], np.int64),
        "time": np.asarray([s["time"] for s in samples], np.float32),
        "pm": np.asarray([s["pm"] for s in samples], bool),
    }


def multiple_samples_collate(samples):
    """Flatten repeated-augmentation samples (`loader.py:46-71`): each
    sample carries a leading num_aug axis, folded into the batch copy-major
    ([all copy-0s | all copy-1s | ...]), so that the on-device RandAugment,
    which draws per contiguous group, gives each copy its own chain."""
    flat = []
    for i in range(samples[0]["frames"].shape[0]):
        for s in samples:
            flat.append(dict(s, frames=s["frames"][i]))
    return _collate(flat)


def construct_loader(cfg, split, dataset=None):
    """The loader of ``split`` (`loader.py:112-169`): train shuffles and
    drops the last partial batch; val and test keep the order and every
    sample."""
    assert split in ["train", "val", "test"]
    if split == "train" and (cfg.MULTIGRID.SHORT_CYCLE or cfg.MULTIGRID.LONG_CYCLE):
        raise NotImplementedError("multigrid training is not ported")
    if split in ("train", "val"):
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    shuffle = drop_last = split == "train"
    if dataset is None:
        dataset = build_dataset(dataset_name, cfg, split)
    collate = None
    if split == "train" and cfg.AUG.ENABLE and cfg.AUG.NUM_SAMPLE > 1:
        collate = multiple_samples_collate
    rank, world_size = rank_and_world_size()
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        prefetch_depth=cfg.DATA_LOADER.PREFETCH_DEPTH,
        seed=cfg.RNG_SEED,
        rank=rank,
        world_size=world_size,
        collate=collate,
    )
