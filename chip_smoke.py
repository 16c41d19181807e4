"""Smoke run of the PyTorch/CUDA port on one GPU: builds the traversal
kernels, checks them against their plain PyTorch version at the main path's
shapes, checks the atrium golden through the kernels, and times the headline
frame (procedural atrium, 19k triangles + HDR sky, 960×544, 4 bounces, NEE/MIS,
blue noise, coherence-sorted traversal).

    python3 chip_smoke.py

Needs one CUDA device and nvcc. Every phase prints a line; any failure exits
non-zero. The second-to-last lines are the kernels' JSON record and the
card's ``name, power.limit``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(width=960, height=544, bounces=4)
SUBSET = 65536  # rays compared against the O(N·T) plain version
TIMED_FRAMES = 5
KERNEL_SOURCE = "raytracer3_tpu_torch/csrc/traverse.cu"
# packet_intersect, the function that reaches pl.pallas_call with _kernel.
REPLACES = "raytracer3_tpu/ops/pallas/traverse_kernel.py:1267"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def judge(name, got, ref):
    """The reference's kernel-oracle rule (tests/test_traverse_kernel.py):
    hit-mask mismatches ≤ max(2, n/500), t within rtol 1e-4 on mutual hits,
    ≥ 90% of mutual hits on the same prim, uv within rtol 1e-3 there.
    Returns (mismatches, max |Δt| over mutual hits)."""
    import torch

    n = got.hit.shape[0]
    mism = int((got.hit != ref.hit).sum())
    m = got.hit & ref.hit
    n_m = int(m.sum())
    dt = (got.t[m] - ref.t[m]).abs()
    max_dt = float(dt.max()) if n_m else 0.0
    t_ok = bool((dt <= 1e-5 + 1e-4 * ref.t[m].abs()).all())
    same = m & (got.prim_id == ref.prim_id)
    n_same = int(same.sum())
    uv_ok = bool(torch.allclose(got.uv[same], ref.uv[same], rtol=1e-3, atol=1e-4))
    phase(f"  {name}: n={n} hits={int(got.hit.sum())} mismatches={mism} "
          f"(limit {max(2, n // 500)}) same_prim={n_same}/{n_m} max|dt|={max_dt:.3g}")
    if mism > max(2, n // 500) or not t_ok or n_same < 0.9 * n_m or not uv_ok:
        fail(f"kernel disagrees with its plain version on {name}")
    return mism, max_dt


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> None:
    jax_before = "jax" in sys.modules
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    if not os.path.isdir(os.path.join(REPO, "raytracer3_tpu_torch")):
        fail(f"no raytracer3_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, REPO)
    from raytracer3_tpu_torch.ops import rng, traverse_kernel as tk
    from raytracer3_tpu_torch.render import camera as camera_mod
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.render import pathtracer, pipelines, wavefront
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.scene import types as scene_types
    from raytracer3_tpu_torch.ops import brdf, mathx
    from raytracer3_tpu_torch.utils.config import RenderSettings

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    phase(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} | {card}")

    # --- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    tk.load_kernels()
    phase(f"build: nvcc {' '.join(tk.NVCC_FLAGS)} -> {time.perf_counter() - t0:.2f} s")

    # --- 2. headline scene and tables (host BVH build) -------------------
    t0 = time.perf_counter()
    scene, tris = procedural.atrium_scene(detail=2, return_host=True, device=dev)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    backend = tk.packet_backend(host_tris=tris, device=dev)
    t_bvh = time.perf_counter() - t0
    pt = backend.meta._replace(node_table=backend.arrays["nodes"], cluster_table=backend.arrays["clusters"])
    phase(f"scene: atrium detail=2 {tris[0].shape[0]} tris, sky 256x512, built in {t_scene:.2f} s; "
          f"BVH: {pt.num_nodes} wide-{pt.width} nodes, {pt.num_clusters} clusters of <= {pt.leaf_size}, "
          f"depth {pt.depth}, built in {t_bvh:.2f} s")

    # --- 3. kernels against the plain version at main-path shapes --------
    w, h = HEADLINE["width"], HEADLINE["height"]
    settings = RenderSettings(width=w, height=h, bounces=HEADLINE["bounces"], radiance_clamp=50.0)
    cam = procedural.atrium_camera(aspect=w / h, device=dev)
    blue_noise = torch.as_tensor(rng.generate_blue_noise(64), device=dev)
    tw, th = wavefront.pick_tile(w, h)
    pix = wavefront.tiled_pixel_order(w, h, tw, th, device=dev)
    sampler = rng.Sampler.from_pixels(pix, 0)
    bx, by = pix[:, 0].long() % 64, pix[:, 1].long() % 64
    jit = torch.stack([rng.animate_blue_noise(blue_noise[by, bx], 0),
                       rng.animate_blue_noise(blue_noise[bx, by], 7919)], dim=-1)
    o, d = camera_mod.primary_rays(cam, w, h, jitter=jit, pixel_xy=pix)
    o, d = o.contiguous(), d.contiguous()
    prim = tk.packet_intersect(pt, o, d)
    # One bounce population: BRDF-sampled from the primary hits, dead lanes
    # parked, coherence-sorted as sorted_trace sorts it.
    surf = scene_types.hit_surface_info(scene, prim.prim_id, prim.uv)
    nrm = pathtracer._face_forward(surf.normal, -d)
    onb = mathx.build_orthonormal_basis(nrm)
    hit_pos = o + prim.t[:, None] * d
    u_l, sampler = sampler.next3()
    sh_o, sh_d, sh_t, pre_ok, _, sampler = pathtracer._nee_prepare(
        scene, hit_pos, nrm, -d, surf, u_l, sampler, settings, alive_mask=prim.hit)
    u3, sampler = sampler.next3()
    s = brdf.surface_sample(surf.albedo, surf.roughness, surf.metalness, mathx.to_local(onb, -d), u3)
    alive = prim.hit & s.valid
    bounds = (scene.positions.amin(0), scene.positions.amax(0))
    b_dir = mathx.to_world(onb, s.wi)
    b_org = torch.where(alive[:, None], hit_pos, 1e30)
    perm = torch.argsort(wavefront.sort_key_pos_dir(b_org, b_dir, alive, bounds), stable=True)
    b_org, b_dir = b_org[perm].contiguous(), b_dir[perm].contiguous()
    sperm = torch.argsort(wavefront.sort_key_pos_dir(sh_o, sh_d, pre_ok, bounds), stable=True)
    sh_o, sh_d, sh_t = sh_o[sperm].contiguous(), sh_d[sperm].contiguous(), sh_t[sperm].contiguous()
    n_alive, n_shadow = int(alive.sum()), int(pre_ok.sum())
    park_o = torch.full((1024, 3), 1e30, device=dev)
    park_d = torch.nn.functional.normalize(torch.randn(1024, 3, device=dev, generator=torch.Generator(dev).manual_seed(0)), dim=-1)
    park_t = torch.zeros(1024, device=dev)

    def sub(x, n):
        # Evenly spaced subset: keeps the sorted packets' coherence.
        idx = torch.linspace(0, x.shape[0] - 1, n, device=dev).long()
        return x[idx].contiguous()

    phase(f"kernel vs plain (subset of {SUBSET} rays; primaries {o.shape[0]}, "
          f"bounce {n_alive} alive, shadow {n_shadow} traced):")
    records = {}
    cases = [
        ("closest", "primaries", o, d, None),
        ("closest", "sorted bounce", b_org[:n_alive], b_dir[:n_alive], None),
        ("any", "NEE shadow t_max", sh_o[:n_shadow], sh_d[:n_shadow], sh_t[:n_shadow]),
        ("closest", "parked", park_o, park_d, park_t),
        ("any", "parked", park_o, park_d, park_t),
    ]
    for kind, name, co, cd, ct in cases:
        n = min(SUBSET, co.shape[0])
        so, sd = sub(co, n), sub(cd, n)
        st = sub(ct, n) if ct is not None else tk._BG
        any_hit = kind == "any"
        got = tk.packet_intersect(pt, so, sd, t_max=st, any_hit=any_hit)
        ref = tk.packet_intersect_plain(pt, so, sd, t_max=st, any_hit=any_hit)
        torch.cuda.synchronize()
        if any_hit:
            mism = int((got.hit != ref.hit).sum())
            phase(f"  {kind} {name}: n={n} hits={int(got.hit.sum())} mismatches={mism} (limit {max(2, n // 500)})")
            if mism > max(2, n // 500):
                fail(f"any-hit kernel disagrees with its plain version on {name}")
            err = float((got.hit.float() - ref.hit.float()).abs().max())
        else:
            mism, err = judge(f"{kind} {name}", got, ref)
        if name == "parked" and bool(got.hit.any()):
            fail(f"a parked ray hit ({kind})")
        full = time_ms(lambda: tk.packet_intersect(pt, co, cd, t_max=ct if ct is not None else tk._BG,
                                                   any_hit=any_hit), 10)
        k_ms = time_ms(lambda: tk.packet_intersect(pt, so, sd, t_max=st, any_hit=any_hit), 10)
        p_ms = time_ms(lambda: tk.packet_intersect_plain(pt, so, sd, t_max=st, any_hit=any_hit), 3)
        phase(f"    time {kind} {name}: kernel {k_ms:.4f} ms vs plain {p_ms:.3f} ms on {n} rays; "
              f"kernel on all {co.shape[0]} rays {full:.4f} ms ({co.shape[0] / full / 1e3:.1f} Mray/s)")
        key = "K1 closest" if kind == "closest" else "K2 any"
        rec = records.setdefault(key, {"max_abs_err": 0.0, "cases": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append((name, n, k_ms, p_ms, co.shape[0], full))

    # --- 4. the atrium golden through the kernels --------------------------
    g_scene, g_tris = procedural.atrium_scene(detail=1, return_host=True, device=dev)
    g_cam = procedural.atrium_camera(aspect=1.0, device=dev)
    g_backend = tk.packet_backend(host_tris=g_tris, device=dev)
    gi, go = g_backend.bind(g_backend.arrays)
    gs = RenderSettings(width=48, height=48, bounces=2, samples=1, radiance_clamp=50.0)
    acc = torch.zeros((48, 48, 3), device=dev)
    for i in range(4):
        acc += wavefront.render_frame(g_scene, g_cam, gs, i, gi, go, sort_rays=True)
    acc = (acc / 4).cpu().numpy()
    golden = np.load(os.path.join(REPO, "tests", "golden", "atrium_packet_48_4f.npy"))
    diff = np.abs(acc - golden)
    rel = float(diff.sum() / np.abs(golden).sum())
    share = float((diff.max(-1) <= 1e-3).mean())
    phase(f"golden atrium_packet_48_4f: mean rel diff {rel:.3g} (limit 1e-3), "
          f"pixels within 1e-3 {share:.4f} (limit 0.98)")
    if not (rel < 1e-3 and share >= 0.98):
        fail("the atrium golden disagrees")

    # --- 5. the headline frame through the user entry points ---------------
    step, init_state = pipelines.wavefront_pipeline(
        scene, settings, backend=backend, blue_noise=blue_noise, device=dev)
    isect, occl = backend.bind(backend.arrays)
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    # Warm-up frame through the progressive pipeline (trace → blend → AgX).
    display, state = step(init_state(), cam, 0)
    torch.cuda.synchronize()
    if display.shape != (h, w, 3) or not bool(display.isfinite().all()):
        fail("the pipeline's display image is not a finite [H, W, 3] image")
    # Timed frames as bench.py drives them: render_frame + progressive film.
    film = film_mod.Film.create(h, w, device=dev)
    events, traced = [], []
    t_host = time.perf_counter()
    for i in range(1, TIMED_FRAMES + 1):
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        radiance, n_traced = wavefront.render_frame(
            scene, cam, settings, i, isect, occl, sort_rays=True, blue_noise=blue_noise,
            return_stats=True)
        film = film_mod.accumulate_progressive(film, radiance)
        e_ev.record()
        events.append((s_ev, e_ev))
        traced.append(n_traced)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    launches = dict(tk.LAUNCHES)
    frames = TIMED_FRAMES + 1
    phase(f"headline launches over 1 warm-up + {TIMED_FRAMES} timed frames: {launches}")
    if launches != {"closest": 4 * frames, "any": 4 * frames}:
        fail(f"expected 4 closest-hit and 4 any-hit launches per frame, got {launches} over {frames} frames")
    ms = [s_ev.elapsed_time(e_ev) for s_ev, e_ev in events]
    frame_ms = statistics.median(ms)
    rays = [int(t) for t in traced]
    acc = film.accum
    mean = float(acc.mean())
    if not bool(acc.isfinite().all()) or not mean > 0.0:
        fail(f"headline film not finite with a positive mean (mean {mean})")
    nominal = w * h * (1 + 2 * settings.bounces)
    phase(f"headline {w}x{h} bounces={settings.bounces}: frame_ms median {frame_ms:.3f} "
          f"(frames {', '.join(f'{x:.3f}' for x in ms)}; host wall {host_s / TIMED_FRAMES * 1e3:.1f} ms/frame), "
          f"measured {statistics.median(rays) / frame_ms / 1e3:.2f} Mray/s "
          f"({statistics.median(rays) / (w * h):.3f} rays/pixel), nominal {nominal / frame_ms / 1e3:.2f} Mray/s, "
          f"film mean {mean:.4f}")

    # --- 6. where the headline frame's device time goes --------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        wavefront.render_frame(scene, cam, settings, TIMED_FRAMES + 1, isect, occl, sort_rays=True,
                               blue_noise=blue_noise)
        t_issue = time.perf_counter() - t_prof
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t_prof
    averages = prof.key_averages()
    # Device-side events (kernels, memcpy/memset).
    rows = [(e.key, e.device_time_total, e.count) for e in averages
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    trav_us = sum(r[1] for r in rows if "traverse_kernel" in r[0])
    phase(f"profile of one headline frame: device busy {busy_us / 1e3:.3f} ms, traversal kernels "
          f"{trav_us / 1e3:.3f} ms ({100 * trav_us / max(busy_us, 1):.1f}%), kernel launches "
          f"{sum(r[2] for r in rows)}")
    for key, us, count in rows[:8]:
        phase(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    # Host-side events: PyTorch ops and the CUDA runtime calls they make,
    # by self time (time in the event itself, not in the events under it).
    host = [(e.key, e.self_cpu_time_total, e.count) for e in averages
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host_us = sum(r[1] for r in host)
    host.sort(key=lambda r: -r[1])
    calls = {k: (us, c) for k, us, c in host}
    sync_us, n_sync = calls.get("cudaStreamSynchronize", (0, 0))
    phase(f"  host, profiled frame: wall {t_prof * 1e3:.3f} ms (Python returned after {t_issue * 1e3:.3f} ms), "
          f"self time of host events {host_us / 1e3:.3f} ms, stream syncs {n_sync} "
          f"({sync_us / 1e3:.3f} ms), cudaLaunchKernel x{calls.get('cudaLaunchKernel', (0, 0))[1]}")
    for key, us, count in host[:12]:
        phase(f"  host {us / 1e3:9.3f} ms  x{count:<5d} {key[:80]}")

    # --- record -----------------------------------------------------------
    if "jax" in sys.modules and not jax_before:
        fail("the port loaded jax")
    kernels = []
    for key, kind in (("K1 closest", "closest"), ("K2 any", "any")):
        rec = records[key]
        # ms and plain_ms: both versions on the same subset of one ray set;
        # full_ms: the kernel on that whole set, as the headline frame
        # launches it.
        name, n, k_ms, p_ms, n_full, full = rec["cases"][1] if kind == "closest" else rec["cases"][0]
        kernels.append({
            "name": f"{key}: traverse_kernel<{'true' if kind == 'any' else 'false'}> ({name})",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": launches[kind],
            "max_abs_err": rec["max_abs_err"],
            "ms": k_ms,
            "plain_ms": p_ms,
            "rays": n,
            "full_ms": full,
            "full_rays": n_full,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
