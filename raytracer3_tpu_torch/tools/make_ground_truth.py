"""Ground-truth renders (port of ``tools/make_ground_truth.py``): the
high-spp reference-mode oracles and the 720p showcase, rendered by
``render/pathtracer.render_image`` (the ground-truth integrator, a code path
apart from the production wavefront).

- ``oracle_atrium_192x108.npz``: the 19k-triangle atrium (``detail=2``) at
  192×108, 4 bounces, raw float radiance;
- with ``--v2``, in its place, ``oracle_atrium_384x216.npz`` and
  ``oracle_atrium_ggx_384x216.npz`` (the GGX-stress view,
  ``procedural.atrium_camera_ggx``);
- ``ground_truth_atrium_720.png``: the 300k-triangle atrium (``detail=8``,
  through GLB ingest and ``World``) at 1280×720, AgX display.

On the card the backend is ``packet_backend`` (K1/K2 for ``detail=2``, K3
treelets for ``detail=8``); ``--device cpu`` takes the LBVH backend
(``ops/traverse.make_bvh_backend``) and renders the oracles only. Frames of
``batch`` samples accumulate in float64 and are averaged. The npz fields are
the stored oracles' (``radiance``, ``spp``, ``bounces``, ``detail`` and, for
``--v2``, ``camera``). Everything goes to ``--out``; the stored oracles in
``resources/`` are the port's yardstick and are never written.

    python -m raytracer3_tpu_torch.tools.make_ground_truth --spp 512              # oracle + showcase
    python -m raytracer3_tpu_torch.tools.make_ground_truth --skip-720             # the 192x108 oracle only
    python -m raytracer3_tpu_torch.tools.make_ground_truth --v2                   # the two 384x216 oracles
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

DEFAULT_OUT = os.path.join("build", "ground_truth")


def render_reference(scene, tris, cam, width, height, bounces, spp, batch=8, seed0=0, *, device, backend=None):
    """Average ``spp // batch`` reference-mode frames of ``batch`` samples
    (``render_image`` loops the samples; frames decorrelate through the
    frame index ``seed0 + i``) → float32 [H, W, 3]. ``backend`` is a
    (intersect_fn, occluded_fn) pair; by default ``packet_backend(host_tris=
    tris)`` on a CUDA device and the LBVH on the CPU."""
    from raytracer3_tpu_torch.render import pathtracer
    from raytracer3_tpu_torch.utils.config import RenderSettings

    dev = torch.device(device)
    settings = RenderSettings(width=width, height=height, bounces=bounces, samples=batch, radiance_clamp=50.0)
    if backend is None:
        if dev.type == "cpu":
            from raytracer3_tpu_torch.ops import traverse

            backend = traverse.make_bvh_backend(scene)[:2]
        else:
            from raytracer3_tpu_torch.ops import traverse_kernel as tk

            b = tk.packet_backend(host_tris=tris, device=dev)
            backend = b.bind(b.arrays)
    isect, occl = backend
    total = torch.zeros((height, width, 3), dtype=torch.float64, device=dev)
    n_frames = max(1, spp // batch)
    for i in range(n_frames):
        total += pathtracer.render_image(scene, cam, settings, seed0 + i, isect, occl).double()
        if (i + 1) % 8 == 0 or i + 1 == n_frames:
            print(f"  frame {i + 1}/{n_frames}", file=sys.stderr, flush=True)
    return (total / n_frames).to(torch.float32).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spp", type=int, default=512)
    ap.add_argument("--skip-720", action="store_true")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--v2", action="store_true",
                    help="the 384x216 oracles instead: the default view and the GGX-stress view "
                    "(procedural.atrium_camera_ggx, metal props and a grazing floor)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the LBVH backend, oracles only (the 720p showcase needs the card)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="output directory")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (--device cpu renders the oracles through the LBVH)")
    from raytracer3_tpu_torch.scene import procedural

    os.makedirs(args.out, exist_ok=True)

    if args.v2:
        scene, tris = procedural.atrium_scene(detail=2, return_host=True, device=dev)
        for tag, cam_fn in (("", procedural.atrium_camera), ("ggx_", procedural.atrium_camera_ggx)):
            w2, h2 = 384, 216
            print(f"oracle v2: atrium(detail=2) {tag or 'default '}{w2}x{h2} reference mode", file=sys.stderr)
            img = render_reference(scene, tris, cam_fn(aspect=w2 / h2, device=dev), w2, h2, bounces=4,
                                   spp=args.spp, device=dev)
            path = os.path.join(args.out, f"oracle_atrium_{tag}384x216.npz")
            np.savez_compressed(path, radiance=img.astype(np.float32), spp=np.int32(args.spp),
                                bounces=np.int32(4), detail=np.int32(2), camera=tag or "default")
            print(f"wrote {path}", file=sys.stderr)
        return 0

    if not args.skip_oracle:
        print("oracle: atrium(detail=2) 192x108 reference mode", file=sys.stderr)
        scene, tris = procedural.atrium_scene(detail=2, return_host=True, device=dev)
        cam = procedural.atrium_camera(aspect=192 / 108, device=dev)
        img = render_reference(scene, tris, cam, 192, 108, bounces=4, spp=args.spp, device=dev)
        path = os.path.join(args.out, "oracle_atrium_192x108.npz")
        np.savez_compressed(path, radiance=img.astype(np.float32), spp=np.int32(args.spp), bounces=np.int32(4),
                            detail=np.int32(2))
        print(f"wrote {path}", file=sys.stderr)

    if not args.skip_720:
        if dev.type != "cuda":
            raise RuntimeError("the 720p showcase renders on the card (pass --skip-720 with --device cpu)")
        from raytracer3_tpu_torch.render import postprocess
        from raytracer3_tpu_torch.utils import image as im

        print("showcase: atrium(detail=8) 1280x720 reference mode", file=sys.stderr)
        big_scene, big_tris = procedural.sponza_world_scene(8, device=dev)
        cam = procedural.atrium_camera(aspect=1280 / 720, device=dev)
        img = render_reference(big_scene, big_tris, cam, 1280, 720, bounces=4, spp=max(64, args.spp // 4), batch=4,
                               device=dev)
        out = postprocess.postprocess(torch.as_tensor(img, device=dev)).cpu().numpy()
        path = os.path.join(args.out, "ground_truth_atrium_720.png")
        im.write_png(path, out)
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
