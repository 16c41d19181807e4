"""Mesh-tooling report (port of ``tools/meshopt_bench.py``, the meshopt
demo's counterpart): every optimizer over a mesh, with the FIFO-cache
ACMR/ATVR and overfetch metrics, the vertex weld, the codecs' sizes with
their zlib ratios, the simplification levels with their error, and each
stage's time in ms. Host only: numpy and the port's native library
(``raytracer3_tpu_torch/native.py``, built with g++ into ``build/native/``).

    python -m raytracer3_tpu_torch.tools.meshopt_bench                 # procedural atrium
    python -m raytracer3_tpu_torch.tools.meshopt_bench scene.glb       # any GLB
    python -m raytracer3_tpu_torch.tools.meshopt_bench --detail 4      # bigger atrium

Left out, as in the reference (docs/PARITY.md): stripify and the
vendor-specific NV/AMD/Intel cache simulators.
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib

import numpy as np


def _t(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, (time.perf_counter() - t0) * 1e3


def overfetch(indices: np.ndarray, n_verts: int, block: int = 16) -> float:
    """Vertex-fetch overfetch: memory blocks touched / minimum blocks needed
    (meshopt.rs analyze_fetch role; 16 verts ≈ one 512 B block at 32 B/vert)."""
    idx = indices.reshape(-1)
    blocks = np.unique(idx // block)
    seq = np.count_nonzero(np.diff(idx // block) != 0) + 1
    need = max(len(blocks), 1)
    return seq / need


def codec_report(name: str, raw: bytes, enc: bytes) -> str:
    zr = len(zlib.compress(raw, 6))
    ze = len(zlib.compress(enc, 6))
    return (
        f"  {name:<18} raw {len(raw):>9} B  enc {len(enc):>9} B"
        f" ({len(enc)/max(len(raw),1):6.1%})"
        f"   +zlib: raw→{zr:>9} B  enc→{ze:>9} B ({ze/max(zr,1):6.1%})"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", help="GLB path (default: atrium)")
    ap.add_argument("--detail", type=int, default=2)
    args = ap.parse_args(argv)

    from raytracer3_tpu_torch import native

    if not native.available():
        print("native lib unavailable — g++ could not build native/rt3native.cpp")
        return 1

    if args.input:
        from raytracer3_tpu_torch.scene import gltf

        md = gltf.load_glb(args.input)
        pos, nrm, uvs, idx = md.positions, md.normals, md.uvs, md.indices
        name = args.input
    else:
        from raytracer3_tpu_torch.scene import procedural

        kw = procedural.atrium(detail=args.detail)
        pos, nrm, uvs, idx = (
            kw["positions"], kw["normals"], kw["uvs"], kw["indices"]
        )
        name = f"atrium(detail={args.detail})"
    pos = np.asarray(pos, np.float32)
    nrm = np.asarray(nrm, np.float32)
    uvs = np.asarray(uvs, np.float32)
    idx = np.asarray(idx, np.int32)
    nv, nt = len(pos), len(idx)
    print(f"{name}: {nv} verts, {nt} tris")

    # --- optimizer ladder with cache metrics + timings (meshopt.rs:362-394)
    print("\noptimizers (FIFO cache model):")
    for cache in (16, 32):
        a0, v0 = native.analyze_cache(idx, nv, cache)
        (opt, t_cache) = _t(native.optimize_vertex_cache, idx, nv)
        a1, v1 = native.analyze_cache(opt, nv, cache)
        print(
            f"  cache={cache:3d}: ACMR {a0:.3f} → {a1:.3f}   "
            f"ATVR {v0:.3f} → {v1:.3f}   ({t_cache:.1f} ms)"
        )
    opt = native.optimize_vertex_cache(idx, nv)
    (fetch_res, t_fetch) = _t(native.optimize_vertex_fetch, opt, nv)
    fetched, remap = fetch_res
    print(
        f"  fetch reorder: overfetch {overfetch(opt, nv):.3f} → "
        f"{overfetch(fetched, nv):.3f}   ({t_fetch:.1f} ms)"
    )
    (weld_res, t_weld) = _t(
        native.weld_vertices,
        np.concatenate([pos, nrm, uvs], axis=1),
    )
    print(f"  weld: {nv} → {weld_res[1]} verts   ({t_weld:.1f} ms)")

    # --- codecs (encoder.rs:120-190) with compression (meshopt.rs:396-557)
    print("\ncodecs:")
    (qp_res, t_qp) = _t(native.quantize_positions, pos)
    qpos, sb = qp_res
    print(codec_report("positions 14-bit", pos.tobytes(), qpos.tobytes())
          + f"   ({t_qp:.1f} ms)")
    rt = native.dequantize_positions(qpos, sb)
    ext = float(np.max(pos.max(0) - pos.min(0)))
    print(f"    roundtrip max err {np.abs(rt - pos).max():.3e}"
          f" ({np.abs(rt - pos).max() / max(ext, 1e-9):.2e} of extent)")
    (qn, t_qn) = _t(native.encode_normals, nrm)
    print(codec_report("normals octa8", nrm.tobytes(), qn.tobytes())
          + f"   ({t_qn:.1f} ms)")
    rtn = native.decode_normals(qn)
    dots = np.clip(np.sum(rtn * nrm, axis=-1), -1, 1)
    print(f"    roundtrip max angle err "
          f"{np.degrees(np.arccos(dots.min())):.3f}°")
    quv = np.clip(uvs * 4095.0 + 0.5, 0, 4095).astype(np.uint16)
    print(codec_report("uvs 12-bit", uvs.tobytes(), quv.tobytes()))
    # Index codec: cache-optimized order makes deltas small → bytes shrink
    # under zlib even at the same raw width (the demo's index-codec point).
    print(codec_report("indices (as-is)", idx.tobytes(), idx.tobytes()))
    d = np.diff(fetched.reshape(-1), prepend=np.int32(0)).astype(np.int32)
    print(codec_report("indices delta(opt)", fetched.astype(np.int32).tobytes(),
                       d.tobytes()))

    # --- simplification ladder (meshopt.rs:559-700)
    print("\nsimplification (quadric collapse, border-locked):")
    for ratio in (0.5, 0.2, 0.05):
        (res, t_s) = _t(native.simplify, pos, idx, ratio)
        out, err = res
        print(
            f"  target {ratio:4.0%}: {nt} → {len(out)} tris"
            f"   max-collapse-err {err:.4g}   ({t_s:.1f} ms)"
        )

    # Exercises of the demo (src/meshopt/meshopt.rs:247, 362-394, 559+)
    # that a ray tracer has no use for, listed so that this report covers
    # the demo's whole output:
    print("\nnot applicable to a ray tracer (docs/PARITY.md):")
    print("  stripify            : n/a — triangle strips are a raster"
          " submission format; traversal consumes indexed triangles")
    print("  vcache NV/AMD/Intel : n/a — vendor post-transform cache"
          " simulators of the raster pipeline; the FIFO model above is the"
          " portable metric")
    print("  overdraw (3.0)      : n/a — no rasterizer; traversal finds"
          " the nearest hit per ray")
    return 0


if __name__ == "__main__":
    sys.exit(main())
