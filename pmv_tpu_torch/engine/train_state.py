"""Training state: the step counter, the model and its optimizer.

Counterpart of `pmv_tpu/engine/train_state.py`. In PyTorch the parameters
live in the model and the optimizer's moments in the optimizer, both updated
in place, so the state holds the two objects and the count of steps taken.
In a multi-process job ``wrapped`` is the module the train step calls
(``parallel.distributed.wrap_model``: the model under DDP, or over FSDP's
sharded parameters); ``model`` is the module that holds the parameters.
"""

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    wrapped: torch.nn.Module = None
