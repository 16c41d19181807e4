"""Checkpoint / resume of renderer state (port of
``raytracer3_tpu/utils/checkpoint.py``): the film (accumulated radiance and
frame count), the camera, the probe state and extras in one ``.npz``.

The keys, dtypes and ``FORMAT_VERSION`` are the reference's, so a file
written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import film as film_mod

FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save(path: str, film: film_mod.Film, cam: camera_mod.Camera, probe_state=None,
         extra: Optional[dict] = None):
    """Write the state to ``path`` through a temporary file and a rename, so
    an interrupted write never leaves a partial checkpoint."""
    arrays = {
        "__version__": np.asarray(FORMAT_VERSION),
        "film.accum": _host(film.accum),
        "film.frame_index": np.asarray(film.frame_index, np.int32),
    }
    for i, field in enumerate(cam._fields):
        arrays[f"camera.{field}"] = _host(cam[i])
    if probe_state is not None:
        for i, field in enumerate(probe_state._fields):
            arrays[f"probes.{field}"] = _host(probe_state[i])
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = _host(v)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load(path: str, *, device):
    """Returns (film, camera, probe_state_or_None, extra_dict) with the
    tensors on ``device`` (extras stay numpy)."""
    z = np.load(path, allow_pickle=False)
    version = int(z["__version__"])
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} != {FORMAT_VERSION}")

    def t(key):
        return torch.as_tensor(z[key], device=device)

    film = film_mod.Film(accum=t("film.accum"), frame_index=int(z["film.frame_index"]))
    cam = camera_mod.Camera(*(t(f"camera.{f}") for f in camera_mod.Camera._fields))
    probe_state = None
    if "probes.atlas" in z.files:
        from raytracer3_tpu_torch.render import probes as probes_mod

        probe_state = probes_mod.ProbeState(*(t(f"probes.{f}") for f in probes_mod.ProbeState._fields))
    extra = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
    return film, cam, probe_state, extra
