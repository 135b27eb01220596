"""Graph processing — the Gelly analog (ref flink-gelly, SURVEY §2.7): the
port of flink_tpu/gelly/. ``graph.py`` attaches the neighbourhood,
clustering, similarity and mutation methods to ``Graph`` as the
reference's does."""

from flink_tpu_torch.gelly.graph import Graph

__all__ = ["Graph"]
