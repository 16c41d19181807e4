"""Frame probe (port of ``tools/frame_probe.py``): full-frame variants of
the production wavefront on the card, to split a frame's time between the
traversal kernels and everything else. ``--stub`` replaces the
intersector with constant hits (no traversal at all), so real − stub is
what traversal costs the frame, and the stub alone is the frame driver and
shading chain.

    python -m raytracer3_tpu_torch.tools.frame_probe                       # the headline (atrium detail 2)
    python -m raytracer3_tpu_torch.tools.frame_probe --stub
    python -m raytracer3_tpu_torch.tools.frame_probe --world --detail 8 --width 1280 --height 720 \\
        --samples 16 --bounces 2 --diet [--stub]                          # sponza720's frame

The backend is ``packet_backend`` as the bench configurations build it
(K1/K2, or K3 when it routes a large scene to treelets); ``--world`` builds
the scene as the sponza configurations do (GLB → asset cache → ``World``).
Each variant runs one warm-up frame and ``--reps`` timed frames into a
progressive film: frame_ms is the median of CUDA events around each frame,
beside the host's wall time a frame, the measured and nominal Mray/s and
the launches a frame. ``--profile`` adds one profiled frame of each
variant: device busy, the traversal kernels' share, and the rest of the
device time by kind of kernel (elementwise, gather/scatter, sort, cat,
reduction, other), from ``torch.profiler``.

Runs on the CUDA device; exits 1 without one unless ``--device cpu`` is
given (host-clock times of the plain versions, not device times).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

# Kernel names of the traversal kernels (csrc/traverse.cu).
TRAVERSAL_KEYS = ("traverse_", "segment_", "tlas_")
# Device-time kinds of the rest, matched in order on the kernel's name.
KINDS = (("sort", ("sort", "radix")), ("gather/scatter", ("index", "gather", "scatter")),
         ("cat", ("cat",)), ("reduction", ("reduce",)), ("elementwise", ("elementwise", "vectorized")))


def _stub(o, d):
    """Constant hits that depend on the ray only: the frame's shading and
    bookkeeping run as usual, traversal does not."""
    from raytracer3_tpu_torch.ops import intersect as isect_mod

    return isect_mod.Hit(t=o[:, 0].abs() * 0.01 + 1.0, uv=d[:, :2].abs() * 0.3,
                         prim_id=(o[:, 1] * 7).to(torch.int32) % 1000, hit=o[:, 0] < 1e20)


def _stub_occl(o, d, tmax):
    return (o[:, 0] + d[:, 0]) * 0.0 > 1.0


def profile_split(render, dev) -> dict:
    """Device time of one ``render()`` by kind of kernel (ms)."""
    from torch.autograd import DeviceType

    from raytracer3_tpu_torch.utils import profiling

    torch.cuda.synchronize(dev)
    with profiling.trace() as prof:
        render()
        torch.cuda.synchronize(dev)
    out = {"busy": 0.0, "traversal": 0.0, **{k: 0.0 for k, _ in KINDS}, "other": 0.0, "launches": 0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0 or e.key.startswith(("pass:", "texture:")):
            continue
        ms = e.device_time_total / 1e3
        out["busy"] += ms
        out["launches"] += e.count
        name = e.key.lower()
        if any(k in e.key for k in TRAVERSAL_KEYS):
            out["traversal"] += ms
            continue
        kind = next((k for k, words in KINDS if any(w in name for w in words)), "other")
        out[kind] += ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stub", action="store_true", help="constant hits in place of traversal")
    ap.add_argument("--detail", type=int, default=2, help="atrium detail (2: 19k tris, the headline; 8: 300k)")
    ap.add_argument("--world", action="store_true", help="the scene through GLB → World, as the sponza configs")
    ap.add_argument("--samples", type=int, default=1, help=">1 batches the samples into one wavefront")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--bounces", type=int, default=4, help="bounces of the full variant")
    ap.add_argument("--fuse", action="store_true", help="fused shadow + bounce launches")
    ap.add_argument("--diet", action="store_true", help="the lane diet (RenderSettings.lane_diet)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true", help="one profiled frame per variant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("frame_probe: no CUDA device (--device cpu runs the plain versions on the host)", file=sys.stderr)
        return 1
    from raytracer3_tpu_torch.ops import rng as rng_mod
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.render import wavefront
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    t0 = time.perf_counter()
    if args.world:
        scene, host_tris = procedural.sponza_world_scene(args.detail, device=dev)
    else:
        scene, host_tris = procedural.atrium_scene(detail=args.detail, return_host=True, device=dev)
    backend = tk.packet_backend(host_tris=host_tris, device=dev)
    cam = procedural.atrium_camera(aspect=args.width / args.height, device=dev)
    blue_noise = torch.as_tensor(rng_mod.generate_blue_noise(64), device=dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"frame_probe on {card}: atrium detail {args.detail} ({host_tris[0].shape[0]} tris, "
          f"{'World' if args.world else 'procedural'}), {type(backend.meta).__name__}, set up in "
          f"{time.perf_counter() - t0:.1f} s; {'STUB traversal' if args.stub else 'real traversal'}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(tag, bounces, nee, sort):
        settings = RenderSettings(width=args.width, height=args.height, bounces=bounces, samples=args.samples,
                                  sample_batch=args.samples > 1, radiance_clamp=50.0, fuse_shadow=args.fuse,
                                  lane_diet=args.diet)
        if args.stub:
            isect, occl, primary, fused, sort_lanes = _stub, _stub_occl, None, None, sort
        else:
            isect, occl = backend.bind(backend.arrays)
            primary = backend.bind_primary(backend.arrays)
            fused = backend.bind_capped(backend.arrays) if settings.fuse_shadow else None
            # Treelet backends sort their own launches.
            sort_lanes = sort and not backend.self_sorting

        def frame(fi):
            return wavefront.render_frame(scene, cam, settings, fi, isect, occl if nee else None,
                                          sort_rays=sort_lanes, blue_noise=blue_noise, return_stats=True,
                                          primary_fn=primary, fused_fn=fused)

        film = film_mod.Film.create(args.height, args.width, device=dev)
        radiance, _ = frame(0)
        film = film_mod.accumulate_progressive(film, radiance)
        sync()
        for k in tk.LAUNCHES:
            tk.LAUNCHES[k] = 0
        ms, traced = [], 0
        t_host = time.perf_counter()
        for i in range(1, args.reps + 1):
            if dev.type == "cuda":
                s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s_ev.record()
            t_frame = time.perf_counter()
            radiance, n = frame(i)
            film = film_mod.accumulate_progressive(film, radiance)
            if dev.type == "cuda":
                e_ev.record()
                e_ev.synchronize()
                ms.append(s_ev.elapsed_time(e_ev))
            else:
                ms.append((time.perf_counter() - t_frame) * 1e3)
            traced += int(n)
        host_ms = (time.perf_counter() - t_host) / args.reps * 1e3
        dt = statistics.median(ms)
        n_px = args.width * args.height * args.samples
        nominal = n_px * (1 + (bounces - 1) + (bounces if nee else 0))
        rec = dict(variant=tag, stub=args.stub, frame_ms=dt, ms=ms, host_ms=host_ms,
                   mrays_measured=traced / args.reps / dt / 1e3, mrays_nominal=nominal / dt / 1e3,
                   launches={k: v // args.reps for k, v in tk.LAUNCHES.items() if v},
                   film_finite=bool(film.accum.isfinite().all()))
        if args.profile and dev.type == "cuda":
            rec["device_ms"] = profile_split(lambda: frame(args.reps + 1), dev)
        print(f"{tag:26s}: {dt:9.3f} ms (frames {', '.join(f'{x:.3f}' for x in ms)}; host wall {host_ms:.1f} "
              f"ms/frame)  {rec['mrays_measured']:8.2f} Mray/s measured ({rec['mrays_nominal']:8.2f} nominal)  "
              f"launches/frame {rec['launches']}", flush=True)
        if "device_ms" in rec:
            dm = rec["device_ms"]
            rest = dm["busy"] - dm["traversal"]
            print(f"{'':26s}  device busy {dm['busy']:.3f} ms over {dm['launches']} kernels: traversal "
                  f"{dm['traversal']:.3f} ms ({100 * dm['traversal'] / max(dm['busy'], 1e-9):.1f}%), the rest "
                  f"{rest:.3f} ms: " + ", ".join(f"{k} {dm[k]:.3f}" for k, _ in KINDS) + f", other {dm['other']:.3f}",
                  flush=True)
        print(json.dumps(rec), flush=True)

    run(f"full ({args.bounces}b, nee, sort)", args.bounces, True, True)
    run("no nee", args.bounces, False, True)
    run("bounces=1", 1, True, True)
    run("bounces=2", 2, True, True)
    if args.stub:
        run("stub no sort", args.bounces, True, False)
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
