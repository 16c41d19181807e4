"""Film: progressive accumulation of radiance across frames (port of
``raytracer3_tpu/render/film.py``): blendfactor ≥ 1 replaces, else
``lerp(prev, radiance, blendfactor)``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Film(NamedTuple):
    accum: torch.Tensor  # [H, W, 3] running radiance estimate
    frame_index: int  # frames accumulated since reset

    @staticmethod
    def create(height: int, width: int, *, device) -> "Film":
        return Film(accum=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
                    frame_index=0)


def blend(film: Film, radiance: torch.Tensor, blendfactor: torch.Tensor) -> Film:
    """refrence_mode.slang:61-65: replace when blendfactor>=1, else lerp."""
    out = torch.where(blendfactor >= 1.0, radiance, film.accum + (radiance - film.accum) * blendfactor)
    return Film(accum=out, frame_index=film.frame_index + 1)


def progressive_blendfactor(frame_index: int, device=None) -> torch.Tensor:
    """Equal-weight progressive average: 1/(n+1) in float32 — frame 0 replaces.
    The quotient is taken on the host and filled in on the device: no
    host-to-device copy."""
    factor = np.float32(1.0) / (np.float32(frame_index) + np.float32(1.0))
    return torch.full((), float(factor), dtype=torch.float32, device=device)


def accumulate_progressive(film: Film, radiance: torch.Tensor) -> Film:
    """Progressive mode: each frame contributes equally (unbiased mean)."""
    return blend(film, radiance, progressive_blendfactor(film.frame_index, film.accum.device))


def reset(film: Film) -> Film:
    """Camera moved → restart the integral (the interactive-mode reset,
    BASELINE.json config 5)."""
    return Film(accum=torch.zeros_like(film.accum), frame_index=0)
