"""Telemetry: model-FLOPs utilization (``mfu.py``)."""
