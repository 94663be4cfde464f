"""Checkpoint save/load and fp32 recovery (``saving.py``, ``zero_to_fp32.py``)."""
