"""Render settings of the port (counterpart of ``raytracer3_tpu/utils/config.py``).

The settings are a plain frozen dataclass with no JAX in it, so the port
shares the reference's class rather than copying it: one set of defaults
drives both renderers. The port reads the fields of its slice (size,
bounces, samples, shading mode, clamps, NEE roulette) and raises on the
options it does not cover yet (``render/wavefront._check_settings``).
"""

from raytracer3_tpu.utils.config import RenderSettings

__all__ = ["RenderSettings"]
