"""The card's peak bandwidth and the traversal's least bytes, kept with the
benchmark so that no change to the program moves them.

The peak: NVIDIA's data sheet of the H100 SXM (at the 700 W limit).
The traversal's work is the rays a frame traces (primaries, the closest-hit
rays that are alive, the shadow rays tested): each ray's inputs read once
(origin, direction, cap: 7 float32) and its hit record written once (t, u,
v, triangle id: 4 words), whatever kernel or tree walks it. The scene's
tables are not counted: their reads depend on the tree."""

from __future__ import annotations

# HBM bytes a second, by ``torch.cuda.get_device_name()``.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

RAY_IN_BYTES = 7 * 4
HIT_OUT_BYTES = 4 * 4


def ray_bytes(rays: int) -> int:
    """Least bytes a traversal of ``rays`` rays moves."""
    return int(rays) * (RAY_IN_BYTES + HIT_OUT_BYTES)


def traversal_floor_s(rays: int, device_name: str) -> float:
    """The least seconds a traversal of ``rays`` rays takes on the card."""
    return ray_bytes(rays) / HBM_BYTES_PER_S.get(device_name, HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"])
