"""Packed G-buffer: 4 × uint32 per pixel plus planar depth (port of
``raytracer3_tpu/render/gbuffer.py``), the words bit-equal with the
reference's.

  word0: albedo as color888 (sqrt-gamma, packing.slang:46-62)
  word1: normal as 11-10-11 unorm (packing.slang:12-43)
  word2: (perceptual roughness, metalness) as 2×f16 (packing.slang:89-98)
  word3: emissive as rgb9e5 shared-exponent HDR (packing.slang:100-166)

Words are uint32 values held in int64 tensors (ops/packing.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer3_tpu_torch.ops import packing
from raytracer3_tpu_torch.scene import types as scene_types


class PackedGBuffer(NamedTuple):
    data: torch.Tensor  # [..., 4] int64 holding uint32 words
    depth: torch.Tensor  # [...] float32, planar as in the reference


def roughness_to_perceptual(r: torch.Tensor) -> torch.Tensor:
    """gbuffer_helpers.slang:72-74."""
    return packing.sqrt_rn(torch.clamp_min(r, 0.0))


def perceptual_to_roughness(r: torch.Tensor) -> torch.Tensor:
    """gbuffer_helpers.slang:76-78."""
    return r * r


def pack_surface(surface: scene_types.SurfaceInfo, depth: torch.Tensor) -> PackedGBuffer:
    rm = torch.stack([roughness_to_perceptual(surface.roughness), surface.metalness], dim=-1)
    words = [
        packing.pack_color_888(surface.albedo),
        packing.pack_normal_11_10_11(surface.normal),
        packing.pack_2xf16(rm),
        packing.pack_rgb9e5(surface.emissive),
    ]
    return PackedGBuffer(data=torch.stack(words, dim=-1), depth=depth)


def unpack_surface(g: PackedGBuffer, normal=None) -> scene_types.SurfaceInfo:
    """The surface of the packed words; ``normal``: their normals where a
    pass decoded them already (the probe frames' ``sis``)."""
    d = g.data
    rm = packing.unpack_2xf16(d[..., 2])
    return scene_types.SurfaceInfo(
        albedo=packing.unpack_color_888(d[..., 0]),
        normal=packing.unpack_normal_11_10_11(d[..., 1]) if normal is None else normal,
        roughness=perceptual_to_roughness(rm[..., 0]),
        metalness=rm[..., 1],
        emissive=packing.unpack_rgb9e5(d[..., 3]),
    )


def unpack_normal(g: PackedGBuffer) -> torch.Tensor:
    """Normals only (structured_importance_sampling.slang:27 unpack_normal)."""
    return packing.unpack_normal_11_10_11(g.data[..., 1])
