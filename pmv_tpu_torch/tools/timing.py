"""Device timing helpers shared by chip_smoke.py and the tools here."""

import subprocess

import numpy as np
import torch


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters=25, flush=None):
    """Median device milliseconds of ``fn`` over ``iters`` launches, by CUDA
    events. ``flush`` (a buffer larger than L2), when given, is overwritten
    before each launch, so every launch reads its inputs from device memory.
    A spin of about half a millisecond on the stream ahead of each launch
    keeps the card busy while the host enqueues, so the host's launch
    latency does not fall between the two events."""
    fn()  # warm-up
    times = []
    for _ in range(iters):
        torch.cuda._sleep(1_000_000)
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
