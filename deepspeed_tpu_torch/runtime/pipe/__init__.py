"""The stacked-trunk model interface (``spmd.py``)."""
