"""Test seams of the port: deterministic fault injection (``faults``)."""
