"""Memory models for sizing a run (``memory.py``)."""
