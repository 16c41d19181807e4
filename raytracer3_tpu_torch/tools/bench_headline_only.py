"""The headline configuration alone (port of ``tools/bench_headline_only.py``):
atrium 19k triangles, 960×544, 4 bounces with NEE, 6 timed frames through
``bench.run_config``, for quick A/Bs of frame-level changes without the
300k-triangle scene. Prints the record as one JSON line.

    python -m raytracer3_tpu_torch.tools.bench_headline_only [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from raytracer3_tpu_torch import bench
    from raytracer3_tpu_torch.scene import procedural

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (--device cpu runs the plain versions)")
    scene, tris = procedural.atrium_scene(detail=2, return_host=True, device=dev)
    cam = procedural.atrium_camera(aspect=960 / 544, device=dev)
    print(json.dumps(bench.run_config("headline", scene, tris, cam, 960, 544, 4, n_frames=6, device=dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
