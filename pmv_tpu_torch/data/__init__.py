"""Host data and on-device training augmentation.

- Datasets (``DATASET_REGISTRY``): ``Kinetics`` (also registered as
  ``Ptvkinetics``), ``Kinetics_av`` (``kinetics_av.py``: with log-mel
  audio, ``audio.py``), ``Synthetic``, and the frame-list datasets ``Ssv2``
  (``Ptvssv2``), ``Sth``, ``Charades`` (``Ptvcharades``) and ``Imagenet``
  (``frame_datasets.py``), AVA's keyframes ``Ava`` (``ava.py``); the
  threaded ``loader``.
- On-device augmentation: RandAugment, random erasing, MixUp/CutMix. Each is
  split into "sample" (the random parameters, drawn from a
  ``torch.Generator`` the train step owns) and "apply" (deterministic given
  those parameters), so that a test can hand the port the parameters the
  JAX package drew and compare the outputs.
"""

from pmv_tpu_torch.data.build import DATASET_REGISTRY, build_dataset  # noqa: F401
from pmv_tpu_torch.data import (  # noqa: F401  (registration)
    ava,
    frame_datasets,
    kinetics,
    kinetics_av,
    synthetic,
)
