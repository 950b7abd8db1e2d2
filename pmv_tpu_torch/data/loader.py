"""Input pipeline: a thread pool of decode workers and a bounded queue of
collated numpy batches.

Counterpart of `pmv_tpu/data/loader.py` (`MViT/slowfast/datasets/
loader.py`). The decoder is native code that releases the GIL, so threads
decode in parallel without pickling every clip between processes, as
``torch.utils.data.DataLoader``'s worker processes would. The order of a
(RNG_SEED, epoch) is the JAX package's. Batches are numpy arrays;
``engine/prefetch.py`` moves them to the card.

Ranks (``DistributedSampler``'s role; the rank and world size come from
``torch.distributed`` when it is initialised, else 0 and 1): a step's
global batch is the ``batch_size x world_size`` samples that one process
would take at that step, and rank r takes rows [r b, (r + 1) b) of it, so
the ranks together run the one-process job's steps. The JAX package gives
each host a strided slice of the order instead (`pmv_tpu/data/loader.py:
67`): the same samples in each step, in another order, and hosts whose
slices differ in length take different counts of training steps. Here every
rank has ``len(loader)`` steps; in a split without ``drop_last`` a rank
whose rows of the last step are none yields one batch fewer
(``parallel.distributed.lockstep`` evens them out).

Multigrid short cycles (`pmv_tpu/data/loader.py:77-123`, PySlowFast's
``ShortCycleBatchSampler``): the steps cycle through batches of
``batch_size x [f0, f1, 1]`` samples, and a sample of the two short phases
is indexed ``(i, phase)`` so that the dataset shrinks its crop
(``data/kinetics.py``, ``data/synthetic.py``). Each rank takes its
contiguous share of each phase's global batch, as of a plain step's.
``len`` follows the JAX package's rule, ``drop_last`` included.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.parallel import mesh


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
        short_cycle=None,
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
        self.short_cycle = short_cycle  # (f0, f1): the multigrid short cycle's factors

    def _sizes(self):
        """The batch sizes of a cycle of steps, this rank's."""
        if self.short_cycle:
            f0, f1 = self.short_cycle
            return [self.batch_size * f0, self.batch_size * f1, self.batch_size]
        return [self.batch_size]

    def set_epoch(self, epoch):
        """Reseed the shuffle and the dataset's draws (reference
        `loader.shuffle_dataset`)."""
        self.epoch = epoch
        if hasattr(self.dataset, "_set_epoch_num"):
            self.dataset._set_epoch_num(epoch)

    def _batches(self):
        """This rank's sample indices of each step of the epoch: ints, or
        (index, phase) in a short cycle's phases 0 and 1."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            order = np.arange(n)
        sizes = self._sizes()
        batches, pos = [], 0
        for step in range(len(self)):
            size = sizes[step % len(sizes)]
            phase = step % 3 if self.short_cycle and step % 3 < 2 else None
            start = pos + self.rank * size
            rows = [int(i) if phase is None else (int(i), phase)
                    for i in order[start:min(start + size, pos + size * self.world_size)]]
            if rows:
                batches.append(rows)
            pos += size * self.world_size
        return batches

    def __len__(self):
        """Steps in an epoch, the same on every rank."""
        sizes = [s * self.world_size for s in self._sizes()]
        cycle = sum(sizes)
        steps = len(self.dataset) // cycle * len(sizes)
        rest = len(self.dataset) % cycle
        for size in sizes:
            if rest <= 0 or (self.drop_last and rest < size):
                break
            steps += 1
            rest -= size
        return steps

    def __iter__(self):
        batches = self._batches()
        out_q = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
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
    """Stack sample dicts into a batch of numpy arrays; a sample's "mask"
    (AUG.GEN_MASK_LOADER), "audio" and "audio_mis" (``Kinetics_av``), and
    "boxes", "box_mask", "ori_boxes" and "metadata" (``Ava``) too."""
    labels = [s["label"] for s in samples]
    batch = {
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
    for key in ("mask", "audio", "audio_mis", "boxes", "box_mask", "ori_boxes", "metadata"):
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples])
    return batch


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


def short_cycle_factors(cfg):
    """The batch factors (f0, f1) of the multigrid short cycle's phases 0
    and 1, round((TRAIN_CROP_SIZE / (s x DEFAULT_S))^2) for each s of
    SHORT_CYCLE_FACTORS (`pmv_tpu/data/loader.py:242-260`); None without
    MULTIGRID.SHORT_CYCLE or before ``init_multigrid`` set DEFAULT_S."""
    if not (cfg.MULTIGRID.SHORT_CYCLE and cfg.MULTIGRID.DEFAULT_S > 0):
        return None
    return tuple(
        int(round((float(cfg.DATA.TRAIN_CROP_SIZE) / (s * cfg.MULTIGRID.DEFAULT_S)) ** 2))
        for s in cfg.MULTIGRID.SHORT_CYCLE_FACTORS
    )


def construct_loader(cfg, split, dataset=None):
    """The loader of ``split`` (`loader.py:112-169`): train shuffles and
    drops the last partial batch; val and test keep the order and every
    sample. A process takes TRAIN.BATCH_SIZE (TEST.BATCH_SIZE) / NUM_GPUS
    samples a step (x the model axis under dp_sp, whose model groups take
    the same rows, by the rank's data index, each rank the whole sample:
    the steps cut its frames to the rank's planes, and AVSlowFast's audio
    stays whole). A train sample of contrastive views (DATA.
    TRAIN_CROP_NUM_TEMPORAL or _SPATIAL > 1) keeps its view axis: frames
    [B, V, T, H, W, C]. Under MULTIGRID.SHORT_CYCLE the train loader takes
    the short cycle's batches (``short_cycle_factors``)."""
    assert split in ["train", "val", "test"]
    if split in ("train", "val"):
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    lay = mesh.layout(cfg)
    batch_size = batch_size // max(cfg.NUM_GPUS, 1) * lay.model_size  # as in PySlowFast
    shuffle = drop_last = split == "train"
    if dataset is None:
        dataset = build_dataset(dataset_name, cfg, split)
    collate = None
    multi_view = cfg.DATA.TRAIN_CROP_NUM_TEMPORAL > 1 or cfg.DATA.TRAIN_CROP_NUM_SPATIAL > 1
    if split == "train" and cfg.AUG.ENABLE and cfg.AUG.NUM_SAMPLE > 1 and not multi_view:
        # Repeated-augmentation copies fold into the batch; contrastive
        # views keep their axis ([B, V, T, H, W, C]) for the SSL step.
        collate = multiple_samples_collate
    short_cycle = short_cycle_factors(cfg) if split == "train" else None
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        prefetch_depth=cfg.DATA_LOADER.PREFETCH_DEPTH,
        seed=cfg.RNG_SEED,
        rank=lay.data,
        world_size=lay.data_size,
        collate=collate,
        short_cycle=short_cycle,
    )
