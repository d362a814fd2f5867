"""Deterministic token batches (``data/pipeline.py``)."""
