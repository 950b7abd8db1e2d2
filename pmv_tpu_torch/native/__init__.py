"""The port's native FFmpeg decode library (``binding.py``)."""
