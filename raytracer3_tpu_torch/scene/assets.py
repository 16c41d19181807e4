"""Processed-asset cache: content-hashed binary cache of ingested GLBs, the
blue-noise cache and the background asset pipeline (copy of
``raytracer3_tpu/scene/assets.py``, host numpy only).

A source .glb is parsed once; the result is cached as .npz keyed by a hash
of (file bytes, loader options, pipeline version), so unchanged sources
skip reprocessing. The format and the key are the reference's, byte for
byte, so either package reads the other's cache. The cache directory
defaults to ``build/assets`` of the checkout (``RT3_ASSET_CACHE``
overrides it).

Each writer stages its file under a name that holds its process and
thread id and renames it into place, so concurrent loads of one source
never write the same temporary file.

``AsyncAssetPipeline`` processes GLBs on worker threads while the frame
loop runs: ``load`` enqueues, ``poll`` returns what finished (the
reference's ``loaded_assets`` split, world/mod.rs:50-101).
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

import numpy as np

from raytracer3_tpu_torch.scene import gltf as gltf_mod

# The reference's pipeline version: it is part of the cache key.
PIPELINE_VERSION = 3

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DEFAULT_CACHE_DIR = os.environ.get("RT3_ASSET_CACHE", os.path.join(_REPO_ROOT, "build", "assets"))


def _cache_dir(cache_dir: Optional[str]) -> str:
    d = cache_dir or _DEFAULT_CACHE_DIR
    os.makedirs(d, exist_ok=True)
    return d


def _content_hash(data: bytes, options: str) -> str:
    h = hashlib.sha256()
    h.update(f"v{PIPELINE_VERSION}|{options}|".encode())
    h.update(data)
    return h.hexdigest()[:24]


def load_glb_cached(path: str, texture_size: int = 256, cache_dir: Optional[str] = None) -> gltf_mod.MeshData:
    """Load a .glb through the processed cache."""
    with open(path, "rb") as f:
        raw = f.read()
    key = _content_hash(raw, f"glb|tex{texture_size}")
    cache_path = os.path.join(_cache_dir(cache_dir), f"{key}.npz")

    if os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=False)
        return gltf_mod.MeshData(
            positions=z["positions"],
            normals=z["normals"],
            uvs=z["uvs"],
            indices=z["indices"],
            geo_id=z["geo_id"],
            base_color=z["base_color"],
            emission=z["emission"],
            metallic=z["metallic"],
            roughness=z["roughness"],
            base_color_texture=z["base_color_texture"],
            textures=z["textures"] if "textures" in z.files else None,
            tex_images=([z[k] for k in sorted(f for f in z.files if f.startswith("tex_img_"))] or None),
            colors=z["colors"] if "colors" in z.files else None,
        )

    md = gltf_mod.load_glb(raw, texture_size=texture_size)
    arrays = dict(
        positions=md.positions,
        normals=md.normals,
        uvs=md.uvs,
        indices=md.indices,
        geo_id=md.geo_id,
        base_color=md.base_color,
        emission=md.emission,
        metallic=md.metallic,
        roughness=md.roughness,
        base_color_texture=md.base_color_texture,
    )
    if md.textures is not None:
        arrays["textures"] = md.textures
    if md.colors is not None:
        arrays["colors"] = md.colors
    if md.tex_images is not None:
        for i, im in enumerate(md.tex_images):
            arrays[f"tex_img_{i:03d}"] = im
    # savez appends .npz unless the name ends with it.
    tmp = f"{cache_path}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, cache_path)
    return md


def blue_noise_cached(size: int = 64, cache_dir: Optional[str] = None) -> np.ndarray:
    """The generated blue-noise rank texture (``rng.generate_blue_noise``),
    cached on disk under the reference's file name."""
    cache_path = os.path.join(_cache_dir(cache_dir), f"bluenoise_{size}.npy")
    if os.path.exists(cache_path):
        return np.load(cache_path)
    from raytracer3_tpu_torch.ops import rng

    bn = rng.generate_blue_noise(size=size)
    tmp = f"{cache_path}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
    np.save(tmp, bn)
    os.replace(tmp, cache_path)
    return bn


class AsyncAssetPipeline:
    """Background-thread GLB processing through the asset cache:
    ``load()`` enqueues and returns a ticket, the frame loop calls
    ``poll()`` each tick and integrates whatever finished."""

    def __init__(self, max_workers: int = 2, cache_dir: Optional[str] = None):
        import concurrent.futures as cf

        self._pool = cf.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="rt3-assets")
        self._cache_dir = cache_dir
        self._pending = {}
        self._next = 0

    def load(self, path: str, **kw) -> int:
        """Enqueue a .glb for background processing; returns a ticket."""
        ticket = self._next
        self._next += 1
        self._pending[ticket] = self._pool.submit(load_glb_cached, path, cache_dir=self._cache_dir, **kw)
        return ticket

    def poll(self):
        """Completed (ticket, MeshData) pairs since the last poll
        (non-blocking); a worker's exception is raised here."""
        done = [(t, f) for t, f in self._pending.items() if f.done()]
        out = []
        for t, f in done:
            del self._pending[t]
            out.append((t, f.result()))
        return out

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def wait_all(self, timeout: Optional[float] = None):
        """Block until every pending asset is processed; returns them all."""
        import concurrent.futures as cf

        cf.wait(list(self._pending.values()), timeout=timeout)
        return self.poll()

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
