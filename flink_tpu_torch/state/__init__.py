"""Keyed-state descriptors (``descriptors.py``)."""
