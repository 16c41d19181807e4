"""How ``correct`` is decided: the film (the frame path's colour state) and
the display that the window's frames produced, at a sample of pixels drawn
from the seed, against the plain reference of the cell's frame path
(``frames/<name>.py``'s ``reference_frames``) given the same triangles,
materials, sky, blue noise, camera controls and frame indices. Two
numbers are compared, each with a limit of the cell's own
(``limits/<cell>.json``):

- ``film_err_p50``: the median over (frame, pixel) of the film's relative
  error, max over channels of |program − reference| / max(|reference|,
  1e-3). Paths that the two sides trace alike agree to the bit, so it
  reads the precision of the radiance, the blend and the lane state.
- ``worst_frame_bad_pct``: over the frames, the largest share of pixels
  whose display differs from the reference's by more than 1/255 in a
  channel (or is not finite). A path whose hit differs by rounding changes
  its pixel whole; a frame that is wrong shows in most of its pixels.

Each frame that goes over the second limit counts as ``failed``."""

from __future__ import annotations

import torch

DISPLAY_STEP = 1.0 / 255.0
FILM_FLOOR = 1e-3


def numbers(films, displays, ref_films, ref_displays) -> dict:
    """The compared numbers of program (or control) against reference:
    ``film_err_p50`` and ``worst_frame_bad_pct``, and the share of bad
    pixels of each frame."""
    den = torch.clamp_min(ref_films.abs().amax(dim=-1), FILM_FLOOR)
    rel = ((films - ref_films).abs().amax(dim=-1) / den).nan_to_num(nan=float("inf"))
    ddiff = (displays - ref_displays).abs().amax(dim=-1)
    bad = ~(ddiff <= DISPLAY_STEP)  # NaN counts as bad
    per_frame = bad.to(torch.float64).mean(dim=1) * 100.0
    return {"film_err_p50": float(rel.reshape(-1).median()), "worst_frame_bad_pct": float(per_frame.max()),
            "per_frame_bad_pct": per_frame.cpu().tolist()}


def judge(readings: dict, limits: dict) -> tuple[bool, list, int]:
    """(correct, lines "name number limit", failed frames) of readings
    against the cell's limits."""
    lines, ok = [], True
    for name in ("film_err_p50", "worst_frame_bad_pct"):
        v, lim = readings[name], limits[name]
        ok = ok and v <= lim
        lines.append((name, v, lim))
    failed = sum(1 for x in readings["per_frame_bad_pct"] if not x <= limits["worst_frame_bad_pct"])
    return ok, lines, failed


def compare(frame, config, traffic, mesh, sky, bn_np, schedule, record, pix_flat, device, colour_dtype=None,
            state=None) -> dict:
    """Readings of a window's record (its gathered frames) against the
    reference of the frame path ``frame``; with ``colour_dtype`` the
    control's readings in the program's place instead."""
    state = state or frame.reference_state(mesh, sky, device)
    bn = torch.as_tensor(bn_np, dtype=torch.float32, device=device)
    n = len(record.call)
    rf, rd = frame.reference_frames(config, traffic, state, bn, schedule, record.base_index, n, pix_flat)
    idx = torch.as_tensor(record.gathered, dtype=torch.int64, device=device)
    if colour_dtype is None:
        films = torch.stack(record.films).to(device)
        displays = torch.stack(record.displays).to(device)
    else:
        cf, cd = frame.reference_frames(config, traffic, state, bn, schedule, record.base_index, n, pix_flat,
                                        colour_dtype=colour_dtype)
        films, displays = cf[idx], cd[idx]
    return numbers(films, displays, rf[idx], rd[idx])
