"""Data parallelism: one process a card (``mesh.py``)."""
