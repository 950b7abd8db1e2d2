"""Multi-process jobs over torch.distributed (``distributed.py``)."""
