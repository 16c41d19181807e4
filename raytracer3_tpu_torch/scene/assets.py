"""Processed-asset cache: content-hashed binary cache of ingested GLBs (copy
of ``load_glb_cached`` and its helpers from ``raytracer3_tpu/scene/assets.py``,
host numpy only).

A source .glb is parsed once; the result is cached as .npz keyed by a hash
of (file bytes, loader options, pipeline version), so unchanged sources
skip reprocessing. The format and the key are the reference's, byte for
byte, so either package reads the other's cache. The cache directory
defaults to ``build/assets`` of the checkout (``RT3_ASSET_CACHE``
overrides it).

Each writer stages its file under a name that holds its process and
thread id and renames it into place, so concurrent loads of one source
never write the same temporary file.
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
