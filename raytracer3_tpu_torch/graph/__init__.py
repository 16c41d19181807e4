"""Declarative frame graph (port of ``raytracer3_tpu/graph``)."""

from raytracer3_tpu_torch.graph.graph import FrameGraph, GraphError

__all__ = ["FrameGraph", "GraphError"]
