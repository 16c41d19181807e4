"""Render settings of the port (copy of ``raytracer3_tpu/utils/config.py``).

One frozen dataclass of static per-pipeline knobs, with the reference's
fields and defaults (``tests/test_torch_wavefront.py`` holds them equal).
The port reads every field the reference's renderer reads (``tex_cone_angle``
sets the wavefront's ray-cone mip level on atlas-textured scenes);
``proberng`` and ``cell_size`` are the reference tuner's knobs, which no
pipeline reads.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static per-pipeline knobs."""

    width: int = 1920
    height: int = 1088
    bounces: int = 4
    samples: int = 1
    # Probe GI layout: 1 probe / probe_spacing px, probe_res × probe_res
    # octahedral directions per probe.
    probe_spacing: int = 16
    probe_res: int = 8
    # Probe-ray path depth (2 adds one NEE-shaded diffuse bounce).
    probe_bounces: int = 1
    # Each probe texel traces its second bounce with probability 1/k per
    # frame, weighted k× (only with probe_bounces >= 2).
    probe_bounce2_splits: int = 1
    # Trace 1/k of each probe's texels per frame, round-robin by frame index.
    probe_texel_splits: int = 1
    # SH projection fills never-written texels with the probe's mean.
    probe_sh_fill: bool = True
    cell_size: float = 0.01
    proberng: bool = False
    # Pure-diffuse shading (the reference mode); else metallic-roughness GGX.
    diffuse_only: bool = False
    # Firefly clamp for bounce radiance (0 = off).
    radiance_clamp: float = 0.0
    # Pixel angular size for ray-cone texture LOD (textured scenes only).
    tex_cone_angle: float = 0.00104
    # Trace all `samples` paths in ONE wavefront of samples·W·H lanes.
    sample_batch: bool = False
    # Fuse each bounce's NEE shadow batch into the next-bounce launch.
    fuse_shadow: bool = False
    # NEE shadow-ray Russian roulette threshold (0 = off).
    nee_rr_threshold: float = 0.0
    # rgb9e5-pack the colour lane state across launches (not bit-compatible).
    lane_diet: bool = False

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def probe_grid(self) -> tuple[int, int]:
        return (self.width // self.probe_spacing, self.height // self.probe_spacing)
