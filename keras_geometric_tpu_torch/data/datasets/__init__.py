"""Dataset generators (ported so far: the community graph)."""

from .synthetic import community_graph

__all__ = ["community_graph"]
