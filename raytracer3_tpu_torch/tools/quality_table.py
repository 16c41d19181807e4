"""Quality table of the GI modes (port of ``tools/quality_table.py``): each
probe and hybrid pipeline rendered against the stored float oracle
(``resources/oracle_atrium_192x108.npz``: the atrium at its ``detail``,
reference mode, high spp) at the oracle's size, compared as
tests/test_ground_truth.py compares them: the AgX display in 4×4 block
means (mean and p99 of |Δ|, the brightness ratio) and the mean SSIM of
the luminance (7×7 box window).

    python -m raytracer3_tpu_torch.tools.quality_table [--frames 8] [--device cpu]

Runs on the card through the packet backend (K1/K2) unless ``--device cpu``
(brute force). One JSON line per mode on stderr, a markdown table on
stdout. The reference tool's on-chip column joined TPU frame times from
BENCH_DETAILS.json; those are not the port's, so the table has none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (mode, pipeline, settings overrides); "_frames" overrides --frames.
MODES = (
    ("probe_gi", "probe", {}),
    ("probe_gi_nofill", "probe", {"probe_sh_fill": False}),
    ("probe_gi_b2", "probe", {"probe_bounces": 2}),
    ("probe_gi_split2", "probe", {"probe_texel_splits": 2}),
    # Equal wall time for the amortised mode: 12 frames against 8.
    ("probe_gi_split2_ewt", "probe", {"probe_texel_splits": 2, "_frames": 12}),
    ("probe_gi_b2k4", "probe", {"probe_bounces": 2, "probe_bounce2_splits": 4}),
    ("probe_gi_b2k4_split2", "probe", {"probe_bounces": 2, "probe_bounce2_splits": 4, "probe_texel_splits": 2,
                                       "_frames": 16}),
    ("hybrid_gi", "hybrid", {}),
    ("hybrid_gi_b2", "hybrid", {"probe_bounces": 2}),
)


def block_means(disp: np.ndarray, block: int = 4) -> np.ndarray:
    h, w = disp.shape[0] // block, disp.shape[1] // block
    return disp[: h * block, : w * block].reshape(h, block, w, block, 3).mean(axis=(1, 3))


def ssim(a: np.ndarray, b: np.ndarray, c1=0.01**2, c2=0.03**2, win=7) -> float:
    """Mean SSIM of the luminance of two [0, 1] images (Wang et al. with a
    win × win box filter over the valid region)."""

    def lum(x):
        return 0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2]

    x, y = lum(a).astype(np.float64), lum(b).astype(np.float64)

    def boxf(img):
        c = np.pad(np.cumsum(np.cumsum(img, axis=0), axis=1), ((1, 0), (1, 0)))
        return (c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]) / (win * win)

    mx, my = boxf(x), boxf(y)
    vx = np.maximum(boxf(x * x) - mx * mx, 0)
    vy = np.maximum(boxf(y * y) - my * my, 0)
    cxy = boxf(x * y) - mx * my
    return float(np.mean((2 * mx * my + c1) * (2 * cxy + c2) / ((mx * mx + my * my + c1) * (vx + vy + c2))))


def table(frames: int = 8, oracle: str = "resources/oracle_atrium_192x108.npz", device="cuda", modes=MODES):
    """The rows of every mode: mean and p99 block |Δ|, brightness ratio, SSIM."""
    from raytracer3_tpu_torch.ops import intersect as isect_mod
    from raytracer3_tpu_torch.ops import tonemap
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    dev = torch.device(device)
    z = np.load(oracle if os.path.isabs(oracle) else os.path.join(REPO, oracle))
    radiance, detail = z["radiance"], int(z["detail"])
    h, w = radiance.shape[:2]
    scene, tris = procedural.atrium_scene(detail=detail, return_host=True, device=dev)
    cam = procedural.atrium_camera(aspect=w / h, device=dev)
    backend = (tk.packet_backend(host_tris=tris, device=dev) if dev.type == "cuda"
               else isect_mod.brute_backend(scene=scene, device=dev))
    ref_disp = tonemap.agx_tonemap(torch.as_tensor(radiance), look="punchy").numpy()
    b_ref = block_means(ref_disp)
    rows = []
    for name, kind, overrides in modes:
        skw = dict(overrides)
        n_frames = skw.pop("_frames", frames)
        settings = RenderSettings(width=w, height=h, bounces=1, samples=1, probe_spacing=12, probe_res=8, **skw)
        factory = pipelines.hybrid_gi_pipeline if kind == "hybrid" else pipelines.probe_gi_pipeline
        step, init_state = factory(scene, settings, backend=backend, device=dev)
        state = init_state()
        disp = None
        for i in range(n_frames):
            disp, state = step(state, cam, i)
        d_full = disp.cpu().numpy()
        diff = np.abs(block_means(d_full) - b_ref)
        rows.append(dict(mode=name, frames=n_frames, mean_block_diff=round(float(diff.mean()), 4),
                         p99_block_diff=round(float(np.percentile(diff, 99)), 4),
                         brightness_ratio=round(float(block_means(d_full).mean() / b_ref.mean()), 3),
                         ssim=round(ssim(d_full, ref_disp), 4)))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--oracle", default="resources/oracle_atrium_192x108.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("quality_table: no CUDA device (--device cpu renders with brute force on the host)", file=sys.stderr)
        return 1
    rows = table(args.frames, args.oracle, args.device)
    where = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" else "cpu"
    print(f"\n{where}, {args.oracle}, {args.frames} frames unless noted\n")
    print("| mode | frames | mean block diff | p99 | brightness vs oracle | SSIM |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['mode']} | {r['frames']} | {r['mean_block_diff']} | {r['p99_block_diff']} "
              f"| {r['brightness_ratio']} | {r['ssim']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
