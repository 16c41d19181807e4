"""Mesh encoder (port of ``tools/mesh_encoder.py``): glTF/GLB → an
optimised, quantised ``.rtmesh`` file (14-bit positions, 8+8-bit
octahedral normals, 12-bit uvs, vertex-cache-ordered indices) through the
native library (``native/rt3native.cpp``, bound by
``raytracer3_tpu_torch.native``). The bytes equal the reference tool's for
the same mesh, and each package decodes the other's files.

    python -m raytracer3_tpu_torch.tools.mesh_encoder input.glb output.rtmesh [--no-optimize]
    python -m raytracer3_tpu_torch.tools.mesh_encoder --analyze input.glb   # ACMR/ATVR report

Host numpy only: no device is involved.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

from raytracer3_tpu_torch import native
from raytracer3_tpu_torch.scene import gltf

MAGIC = b"RTM1"


def encode(md, optimize: bool = True) -> bytes:
    indices = md.indices.astype(np.int32)
    n_verts = len(md.positions)
    if optimize:
        indices = native.optimize_vertex_cache(indices, n_verts)
        indices, remap = native.optimize_vertex_fetch(indices, n_verts)
        inv = np.argsort(remap)
        positions, normals, uvs = md.positions[inv], md.normals[inv], md.uvs[inv]
    else:
        positions, normals, uvs = md.positions, md.normals, md.uvs

    qpos, sb = native.quantize_positions(positions.astype(np.float32))
    qnrm = native.encode_normals(normals.astype(np.float32))
    quv = np.clip(uvs * 4095.0 + 0.5, 0, 4095).astype(np.uint16)  # 12-bit

    out = bytearray()
    out += MAGIC
    out += struct.pack("<iii", n_verts, int(indices.size), len(md.base_color))
    out += sb.astype(np.float32).tobytes()
    out += qpos.tobytes()
    out += qnrm.tobytes()
    out += quv.tobytes()
    out += indices.astype(np.uint32).tobytes()
    out += md.geo_id.astype(np.int32).tobytes()
    out += md.base_color.astype(np.float32).tobytes()
    out += md.emission.astype(np.float32).tobytes()
    out += md.metallic.astype(np.float32).tobytes()
    out += md.roughness.astype(np.float32).tobytes()
    return bytes(out)


def decode(data: bytes) -> gltf.MeshData:
    if data[:4] != MAGIC:
        raise ValueError("not an .rtmesh file")
    nv, ni, ng = struct.unpack_from("<iii", data, 4)
    off = 16
    sb = np.frombuffer(data, np.float32, 6, off); off += 24
    qpos = np.frombuffer(data, np.uint16, nv * 3, off).reshape(nv, 3); off += nv * 6
    qnrm = np.frombuffer(data, np.uint16, nv, off); off += nv * 2
    quv = np.frombuffer(data, np.uint16, nv * 2, off).reshape(nv, 2); off += nv * 4
    idx = np.frombuffer(data, np.uint32, ni, off).astype(np.int32); off += ni * 4
    nt = ni // 3
    geo = np.frombuffer(data, np.int32, nt, off); off += nt * 4
    bc = np.frombuffer(data, np.float32, ng * 4, off).reshape(ng, 4); off += ng * 16
    em = np.frombuffer(data, np.float32, ng * 3, off).reshape(ng, 3); off += ng * 12
    mt = np.frombuffer(data, np.float32, ng, off); off += ng * 4
    rg = np.frombuffer(data, np.float32, ng, off); off += ng * 4
    return gltf.MeshData(
        positions=native.dequantize_positions(qpos, sb),
        normals=native.decode_normals(np.ascontiguousarray(qnrm)),
        uvs=quv.astype(np.float32) / 4095.0,
        indices=idx.reshape(-1, 3),
        geo_id=np.ascontiguousarray(geo),
        base_color=np.ascontiguousarray(bc),
        emission=np.ascontiguousarray(em),
        metallic=np.ascontiguousarray(mt),
        roughness=np.ascontiguousarray(rg),
        base_color_texture=np.full(ng, -1, np.int32),
    )


def analyze(md) -> str:
    """ACMR/ATVR before and after the vertex-cache order, at caches of 16 and 32."""
    n_verts = len(md.positions)
    lines = []
    for cache in (16, 32):
        a0, v0 = native.analyze_cache(md.indices, n_verts, cache)
        opt = native.optimize_vertex_cache(md.indices, n_verts)
        a1, v1 = native.analyze_cache(opt, n_verts, cache)
        lines.append(f"cache={cache:3d}: ACMR {a0:.3f} → {a1:.3f}   ATVR {v0:.3f} → {v1:.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--no-optimize", action="store_true")
    ap.add_argument("--analyze", action="store_true")
    args = ap.parse_args(argv)

    md = gltf.load_glb(args.input)
    if args.analyze:
        print(f"{args.input}: {len(md.positions)} verts, {len(md.indices)} tris")
        print(analyze(md))
        return 0
    if not args.output:
        ap.error("output path required unless --analyze")
    blob = encode(md, optimize=not args.no_optimize)
    with open(args.output, "wb") as f:
        f.write(blob)
    raw = len(md.positions) * 32 + len(md.indices) * 12
    print(f"wrote {args.output}: {len(blob)} bytes ({len(blob) / max(raw, 1):.2%} of raw)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
