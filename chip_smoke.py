"""Smoke run of the PyTorch/CUDA port on one GPU: builds the traversal
kernels and drives both paths of the port.

- Headline: procedural atrium (19k triangles + HDR sky), 960×544, 4
  bounces, NEE/MIS, blue noise, coherence-sorted traversal through K1/K2
  (single-level tables). K1/K2 are held against their plain version at the
  path's shapes, the atrium golden is rendered through them, and the frame
  is timed and profiled.
- The port's bench first (``bench_phase``): ``python -m
  raytracer3_tpu_torch.bench`` as a process of its own, its eight configs
  (headline, sponza720 and sponza1080 at the spp their ladders take, the
  five probe-pipeline configs) checked for errors, finite times and their
  kernels' launches.
- sponza720 at 16 spp: the 300k-triangle atrium through GLB ingest and
  ``World``, routed by ``packet_backend`` to the treelet segment grid (K3),
  1280×720, 2 bounces, 16 samples in one batched wavefront (bench.py's
  sponza720 settings one rung below the 32 spp its ladder takes). K3 is
  held against its plain version on five ray sets at the path's shapes,
  the atrium golden is rendered through K3, K1 over one whole-scene table
  (its walk, and its general loop) is timed beside K3 on the same rays,
  and the frame is timed and profiled.
- instanced720: the same atrium split the way a user would instance it (a
  shell mesh spawned once, one column mesh spawned 14 times with yawed
  transforms, both through GLB ingest and ``World``), traced through the
  two-level backend (K4), same settings as sponza720. K4 is held against its
  plain version on four ray sets, and against K3 on the flattened ``World``
  on the same bounce rays; the frame is timed and profiled, its film held
  against the flattened world's film, and a transform edit rebinds without
  rebuilding the cluster table or the shading rows.
- K5 (the visit counters) on every kernel ray set above: the stats form of
  each kernel against ``traverse_plain`` (per-ray counts and hits equal) on
  the subsets, its hits against the production kernel's on the whole sets,
  and from the whole-set counts each kernel's operation-side bound and SIMT
  efficiency. K3's second driver (``treelet_intersect_rounds``) and
  ``nearest_first`` run beside the production single pass on sponza720's
  bounce and shadow sets.
- The two loops of K1/K2, K3 and K4, both hit kinds: the walk kernels
  (what the frames launch) against the general loop on every ray set of
  theirs, outputs equal bit for bit, both timed on the whole set in the
  same run;
  K5 rows for the tail any-hit launch of both frames (shadow batch + escape
  probes in one launch), and for instanced720 that launch coherence-sorted,
  the sort and its gathers timed beside it and the unsorted launch (the
  frames trace it unsorted: the sort cost more than it saved). The stack each table set needs: its
  depth, the reference's depth formula and the need computed from the
  tables.
- Probe GI: bench.py's ``probe_gi`` and ``hybrid_gi`` configs (the
  headline atrium, 960×544, packed G-buffer → SIS → probes → SH →
  interpolate → AgX) through K1/K2's walks, each timed with its launches
  per frame and profiled; the probe display after 4 frames held against
  the same frames through K1/K2's general loop; the reference-mode tracer
  (``reference_pipeline``) on the same scene at 480×272, 2 samples, 3
  bounces; the Cornell golden (16 frames of reference mode) through the
  packet backend; and ``sponza1080_probe_gi`` (1920×1088, texel splits 2)
  on the 300k atrium through K3.
- The wavefront's options: the headline through ``wavefront_pipeline`` with and
  without the à-trous denoiser (``denoise=True``); the three ground-truth
  oracles (``resources/oracle_atrium_*.npz``) through K1/K2 with the bounds
  of ``tests/test_ground_truth.py``, and probe_gi and hybrid_gi against the
  192×108 oracle's sanity bounds; the oracles rendered anew by the port's
  ``tools/make_ground_truth.py`` (reference mode, 512 spp, K1/K2) and held
  against the stored ones (``ground_truth_phase``); sponza720 at 16 spp
  timed at bench.py's setting (lane diet on), its frame 0 with the diet
  off held to the reference's diet bound, the fused shadow+bounce frame
  (K3's mixed-hit shape over 29.5M lanes) and the ``tail_anyhit=False``
  frame each against the split film, one 32-spp diet frame (bench.py's
  sponza720); ``sponza1080`` (1920×1088, 4 bounces, 16 spp in one
  33.4M-lane wavefront, lane diet) timed and profiled through K3.
- Textures and the frame graph: ``wavefront_pipeline`` on the graph
  after 4 headline frames against the same frames composed by hand
  (bit-equal); the reference's two textured goldens (``textured_mip_64_8f``
  through the wavefront's mip atlas and ray cone, ``textured_64_8f``
  through reference mode's texture array) through K1/K2; and
  ``sponza720_textured``: sponza720's scene with a seeded texture on each
  non-emissive material (six 1024², one 1000×750) and seeded vertex
  colours through K3 at sponza720's settings, timed and profiled (the
  ``texture:*`` ranges) beside the untextured frame, and ``sample_atlas``
  on the card against the CPU on a million of its first-bounce lanes.
- The interactive app stack (BASELINE config 5) at 1920×1088: the viewer's
  headline scene (``viewer.atrium_world``, ``World.trace_backend("auto")``
  → K1/K2, 4 bounces) through an in-process ``Viewer`` along a scripted
  camera path, its displays held bit-equal to the same frames composed by
  hand, K1/K2 held against their plain version on its own tables and one
  frame's rays, timed (steady frame, submit → ready on the display's
  event beside the viewer's submit → pop, move → ready, host issue of a
  step and of the frame function, one profiled step, fps at 1 and 3
  frames in flight, the denoised frame); ``python -m
  raytracer3_tpu_torch.app.viewer`` as a subprocess fed
  ``docs/INTERACTIVE.md``'s commands on stdin (exit 0, the film's count
  restarting after a move, a look and ``set bounces=2``); and, after
  sponza1080_probe_gi, the probe-GI viewer on the 300k atrium through K3
  (steady frame, move → 90% converged), then the port's
  ``tools/interactive_evidence.py`` loop at its defaults (1920×1088, texel
  splits 1, 120 frames) on that scene into ``build/interactive/`` (the
  trace, the summary and the five-frame PNG strip).
- BASELINE config 2 (``lbvh512_phase``): sponza720's GLB mesh (299,508
  triangles) through ``World.backend("bvh")``, the LBVH built on the card
  (plain PyTorch, as the reference's is jnp) and held bit-equal to the
  same build on the CPU; 512×512 primaries through ``bvh_intersect`` and
  one hard-shadow ray per hit toward the sky's sun through
  ``bvh_occluded``, held against K1/K2 on the same triangles by the
  oracle rule; build and trace times, loop turns, peak memory; the
  shadowed image to ``build/lbvh512.ppm``; and the 192×108 oracle rendered
  through ``World.backend("bvh")`` within the reference's bound.
- Multi-device rendering (``tiled_phase``): a 1-rank NCCL group (NCCL
  refuses two ranks on one card); the headline through
  ``parallel/mesh.render_wavefront_tiled`` (K1/K2) bit-equal to
  ``wavefront.render_frame``'s frame, timed beside it with the per-rank
  ray counts, and ``render_sample_parallel`` bit-equal to
  ``render_image`` at the seed ``frame · 1 + 0``.
- The traversal-statistics path: the port's probe
  (``raytracer3_tpu_torch.tools.perf_probe``) with ``--stats`` over K1/K2,
  ``--instanced --detail 8 --stats`` over K4 and ``--treelet --detail 8
  --stats --rounds`` over K3, its K5 launches counted.

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
# sponza720 at 16 spp: bench.py's sponza720 scene and settings (run_config
# with sample_batch and the lane diet, which bench.py:136-138 turns on
# whenever samples > 1) one rung below the 32 spp its ladder takes
# (bench.py:369-377, 427; the port's bench runs that frame, bench_phase).
SPONZA = dict(detail=8, width=1280, height=720, bounces=2, samples=16)
SPONZA_TIMED_FRAMES = 3
# bench.py's sponza1080 (bench.py:451-459; the same run_config, so the diet
# too) on sponza720's scene and treelet backend.
SPONZA1080 = dict(width=1920, height=1088, bounces=4, samples=16)
SPONZA1080_TIMED_FRAMES = 2
# The ground-truth oracles with tests/test_ground_truth.py's frames (×4 spp)
# and bounds (mean, p99 of the 4×4 block-mean display difference).
ORACLES = (("oracle_atrium_192x108.npz", 12, 0.02, 0.10), ("oracle_atrium_384x216.npz", 6, 0.03, 0.15),
           ("oracle_atrium_ggx_384x216.npz", 6, 0.045, 0.15))
K3_SUBSET = 32768  # rays compared against K3's plain version (O(N·T) per step)
KERNEL_SOURCE = "raytracer3_tpu_torch/csrc/traverse.cu"
# The functions that reach pl.pallas_call with _kernel: packet_intersect
# (K1/K2) and packet_intersect_segments (K3).
REPLACES = "raytracer3_tpu/ops/pallas/traverse_kernel.py:1267"
REPLACES_K3 = "raytracer3_tpu/ops/pallas/traverse_kernel.py:1375"
# K4: packet_intersect on two-level tables, via tlas.two_level_backend.
REPLACES_K4 = "raytracer3_tpu/ops/tlas.py:308"
# K5: the counters of _kernel, returned by both launchers with stats=True.
REPLACES_K5 = "raytracer3_tpu/ops/pallas/traverse_kernel.py:1212"
# K3's second driver.
REPLACES_ROUNDS = "raytracer3_tpu/ops/treelets.py:787"
# instanced720: sponza720's settings on the instanced atrium.
INSTANCED = dict(detail=8, columns=14, yaw_step=0.3)
INSTANCED_TIMED_FRAMES = 3
# bench.py's probe_gi / hybrid_gi (960×544) and sponza1080_probe_gi configs.
PROBE_TIMED_FRAMES = 5
SPONZA1080_PROBE = dict(width=1920, height=1088, probe_texel_splits=2)
# The reference-mode tracer on the headline atrium, cut to a size that keeps
# the script inside its time limit.
REFERENCE = dict(width=480, height=272, bounces=3, samples=2)
STATS_BYTES = 20  # K5 writes five int32 counts per ray
# Kernel names profile_frame counts as traversal: K3's and K1/K2's.
K3_KEYS = ("segment_kernel", "segment_walk_kernel", "segment_walk_any_kernel")
K12_KEYS = ("traverse_kernel", "traverse_walk_kernel", "traverse_walk_any_kernel")
# sponza720_textured: one seeded texture per non-emissive atrium material
# (six 1024² and one 1000×750: non-square and non-power-of-two chains) and
# seeded per-vertex COLOR_0; the sampler held card against CPU on this many
# of the frame's first-bounce lanes, at the CPU tests' tolerance.
TEX_SIZES = ((1024, 1024),) * 6 + ((750, 1000),)
TEX_SEED = 10
TEX_LANES = 1 << 20
TEX_RTOL, TEX_ATOL = 1e-6, 1e-7
# BASELINE config 5 (interactive): viewer.main's settings at 1920×1088.
LBVH512 = dict(width=512, height=512, sun_dir=(0.35, 0.55, 0.2))  # BASELINE.json config 2
TILED_TIMED_FRAMES = 3
INTERACTIVE = dict(width=1920, height=1088, bounces=4)
INTERACTIVE_TIMED_FRAMES = 10
INTERACTIVE_PROBE_TIMED_FRAMES = 20
VIEWER_MAIN_LINE_TIMEOUT_S = 300
# The port's bench (raytracer3_tpu_torch/bench.py) as a process of its own:
# its eight configs, in bench.py's order, and the counters each must launch.
BENCH_CONFIGS = ("headline", "sponza720", "sponza1080", "sponza1080_probe_gi", "sponza720_probe_gi",
                 "sponza720_hybrid_gi", "probe_gi", "hybrid_gi")
BENCH_K12 = ("headline", "probe_gi", "hybrid_gi")  # the 19k atrium: K1/K2; the rest the 300k one: K3
BENCH_HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "nominal_value", "headline_frame_ms",
                       "sponza1080_mrays", "sponza1080_frame_ms", "sponza1080_spp_per_s", "sponza720_spp_per_s",
                       "sponza720_probe_gi_fps", "sponza1080_probe_gi_fps")
BENCH_TIMEOUT_S = 600
# The port's tools/make_ground_truth.py: reference mode at 512 spp in frames
# of 8 samples, 4 bounces (each frame 1 + 8·3 closest-hit and 8·4 any-hit
# launches); tools/interactive_evidence.py at its defaults.
GT_SPP, GT_BATCH, GT_BOUNCES = 512, 8, 4
EVIDENCE = dict(width=1920, height=1088, probe_texel_splits=1, frames=120)
PHASE_S = {}  # seconds of the phases timed on their own
T_START = time.perf_counter()
# record_function ranges of the frame graph's passes and the texture path.
RANGE_PREFIXES = ("pass:", "texture:")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def packet_geo(pt, out_bytes: int) -> dict:
    """``perf_probe.visit_summary``'s table geometry for single- or
    two-level tables."""
    two = pt.inst_table is not None
    tabs = (pt.node_table, pt.cluster_table) + ((pt.inst_table,) if two else ())
    return dict(width=pt.width, leaf_size=pt.leaf_size, node_row_bytes=pt.node_table.shape[1] * 4,
                cluster_row_bytes=pt.cluster_table.shape[1] * 4, kind="k4" if two else "k12",
                inst_row_bytes=pt.inst_table.shape[1] * 4 if two else 0, out_bytes=out_bytes,
                table_bytes=nbytes(*tabs))


def segment_geo(tt) -> dict:
    return dict(width=tt.width, leaf_size=tt.leaf_size, node_row_bytes=tt.node_tables.shape[2] * 4,
                cluster_row_bytes=tt.cluster_tables.shape[2] * 4, kind="k3", out_bytes=16,
                table_bytes=nbytes(tt.node_tables, tt.cluster_tables, tt.aabb))


def k5_report(label, n, n_bad, off, full_off, sub, full, ms, full_ms, plain_ms, n_full):
    from raytracer3_tpu_torch.tools import perf_probe

    phase(f"    K5 {label}: stats kernel vs traverse_plain on {n} rays: per-ray counts differ on {n_bad}, "
          f"hit fields differing {off or 'none'}; whole set of {n_full}: hits differ from the production "
          f"kernel's in {full_off or 'no field'}")
    phase(f"      stats kernel {ms:.4f} ms on {n} rays, plain {plain_ms:.3f} ms; on the whole set {full_ms:.4f} ms")
    phase(f"      whole set {perf_probe.summary_line(full)}")
    if n_bad or off or full_off:
        fail(f"K5 disagrees on {label}")


def k5_packet(pt, label, any_hit, sub_rays, full_rays, out_bytes):
    """K5 of K1/K2/K4 on one ray set: the stats kernel against
    ``traverse_plain`` on the subset (every hit field and every per-ray
    count equal), its hits against the production kernel's on the whole
    set, and the visit summaries of both (``perf_probe.visit_summary``)."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.tools import perf_probe

    (so, sd, st), (co, cd, ct) = sub_rays, full_rays
    fields = ("hit", "t", "uv", "prim_id") + (("inst",) if pt.inst_table is not None else ())
    hk, ck = tk.packet_intersect(pt, so, sd, t_max=st, any_hit=any_hit, stats=True)
    hp, cp = tk.traverse_plain(pt, so, sd, t_max=st, any_hit=any_hit)
    hf, cf = tk.packet_intersect(pt, co, cd, t_max=ct, any_hit=any_hit, stats=True)
    hn = tk.packet_intersect(pt, co, cd, t_max=ct, any_hit=any_hit)
    torch.cuda.synchronize()
    off = [f for f in fields if not torch.equal(getattr(hk, f), getattr(hp, f))]
    full_off = [f for f in fields if not torch.equal(getattr(hf, f), getattr(hn, f))]
    n_bad = int((ck != cp).any(dim=1).sum())
    geo = packet_geo(pt, out_bytes)
    sub, full = perf_probe.visit_summary(ck, **geo), perf_probe.visit_summary(cf, **geo)
    del hf, hn, cf
    ms = time_ms(lambda: tk.packet_intersect(pt, so, sd, t_max=st, any_hit=any_hit, stats=True), 10)
    full_ms = time_ms(lambda: tk.packet_intersect(pt, co, cd, t_max=ct, any_hit=any_hit, stats=True), 5)
    plain_ms = time_ms(lambda: tk.traverse_plain(pt, so, sd, t_max=st, any_hit=any_hit), 1)
    k5_report(label, so.shape[0], n_bad, off, full_off, sub, full, ms, full_ms, plain_ms, co.shape[0])
    stats_geo = dict(geo, out_bytes=out_bytes + STATS_BYTES)
    return dict(sub=sub, full=full, ms=ms, full_ms=full_ms, plain_ms=plain_ms,
                stats_sub=perf_probe.visit_summary(ck, **stats_geo))


def k5_segments(tt, label, sl, sl_full):
    """K5 of K3: the same checks on one segment launch (subset) and its
    whole set, against ``segments_traverse_plain``."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.tools import perf_probe

    ok, ck = sl.launch(tt, stats=True)
    op, cp = sl.launch(tt, fn=tk.segments_traverse_plain, stats=True)
    of, cf = sl_full.launch(tt, stats=True)
    same_full = torch.equal(of, sl_full.launch(tt))
    torch.cuda.synchronize()
    off = [] if torch.equal(ok, op) else ["out rows"]
    n_bad = int((ck != cp).any(dim=1).sum())
    geo = segment_geo(tt)
    sub, full = perf_probe.visit_summary(ck, **geo), perf_probe.visit_summary(cf, **geo)
    del of, cf
    ms = time_ms(lambda: sl.launch(tt, stats=True), 10)
    full_ms = time_ms(lambda: sl_full.launch(tt, stats=True), 3)
    plain_ms = time_ms(lambda: sl.launch(tt, fn=tk.segments_traverse_plain, stats=True), 1)
    k5_report(label, sl.n, n_bad, off, [] if same_full else ["out rows"], sub, full, ms, full_ms, plain_ms,
              sl_full.n)
    return dict(sub=sub, full=full, ms=ms, full_ms=full_ms, plain_ms=plain_ms,
                stats_sub=perf_probe.visit_summary(ck, **dict(geo, out_bytes=16 + STATS_BYTES)))


def general_segments(tt, sl):
    """One launch of K3's general loop on the segment launch ``sl``: the
    rows ``sl.launch(tt)`` returns, from ``segment_kernel<any_hit, 128>``
    whatever the tables' shape (the wrapper would pick the walk kernel)."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    kw = sl.kw
    return tk._launch_segments(
        tk.load_kernels(), tt, sl.seg_list, sl.seg_entry, sl.seg_gmask, sl.origins, sl.directions, sl.t_cap,
        sl.anyhit_row, kw["t_min"], kw["any_hit"], kw["step_cull"], kw["sublanes"], kw["max_groups"], False,
        "general", torch.cuda.current_stream().cuda_stream)[0]


def general_packet(pt, o, d, t_max, any_hit=False):
    """One launch of K1/K2's or K4's general loop (``traverse_kernel`` or
    ``tlas_kernel<any_hit, 128>``) with the wrapper's own tail, so that it
    returns and costs what ``packet_intersect`` does around the walk
    kernel."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.ops.intersect import Hit

    out_t, out_u, out_v, out_prim, out_inst, _ = tk._launch_packet(
        tk.load_kernels(), pt, o, d, tk._t_cap(t_max, o.shape[0], o.device), 1e-4, any_hit, False, "general",
        torch.cuda.current_stream().cuda_stream)
    found = out_prim >= 0
    return Hit(t=torch.where(found, out_t, tk._BG), uv=torch.stack([out_u, out_v], dim=-1), prim_id=out_prim,
               hit=found, inst=out_inst)


def same_bits(a, b) -> bool:
    """Tensors (or ``Hit``s, field by field) equal to the bit."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if not isinstance(a, torch.Tensor):
        return all(same_bits(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def sub(x, n):
    """Evenly spaced subset of n rows: keeps the sorted packets' coherence.
    Integer steps: a float32 linspace rounds past the end above 2^24 rays."""
    import torch

    idx = torch.arange(n, device=x.device) * (x.shape[0] - 1) // max(n - 1, 1)
    return x[idx].contiguous()


def k12_population(scene, pt, cam, settings, blue_noise):
    """One frame's K1/K2 ray sets at the settings' size: the tiled,
    blue-noise-jittered primaries, and from their hits one bounce population
    (BRDF-sampled, dead lanes parked) and its NEE shadow rays, each
    coherence-sorted as sorted_trace sorts it, live rays first. Returns
    (o, d, b_org, b_dir, n_alive, sh_o, sh_d, sh_t, n_shadow)."""
    import torch

    from raytracer3_tpu_torch.ops import rng, traverse_kernel as tk
    from raytracer3_tpu_torch.render import camera as camera_mod
    from raytracer3_tpu_torch.render import wavefront

    w, h, dev = settings.width, settings.height, scene.positions.device
    tw, th = wavefront.pick_tile(w, h)
    pix = wavefront.tiled_pixel_order(w, h, tw, th, device=dev)
    sampler = rng.Sampler.from_pixels(pix, 0)
    bx, by = pix[:, 0].long() % 64, pix[:, 1].long() % 64
    jit = torch.stack([rng.animate_blue_noise(blue_noise[by, bx], 0),
                       rng.animate_blue_noise(blue_noise[bx, by], 7919)], dim=-1)
    o, d = camera_mod.primary_rays(cam, w, h, jitter=jit, pixel_xy=pix)
    o, d = o.contiguous(), d.contiguous()
    prim = tk.packet_intersect(pt, o, d)
    sh_o, sh_d, sh_t, pre_ok, b_org, b_dir, alive = bounce_population(scene, o, d, prim, sampler, settings)
    bounds = (scene.positions.amin(0), scene.positions.amax(0))
    perm = torch.argsort(wavefront.sort_key_pos_dir(b_org, b_dir, alive, bounds), stable=True)
    b_org, b_dir = b_org[perm].contiguous(), b_dir[perm].contiguous()
    sperm = torch.argsort(wavefront.sort_key_pos_dir(sh_o, sh_d, pre_ok, bounds), stable=True)
    sh_o, sh_d, sh_t = sh_o[sperm].contiguous(), sh_d[sperm].contiguous(), sh_t[sperm].contiguous()
    return o, d, b_org, b_dir, int(alive.sum()), sh_o, sh_d, sh_t, int(pre_ok.sum())


def k12_against_plain(pt, kind, name, co, cd, ct):
    """K1 (``kind`` "closest") or K2 ("any", per-ray caps ``ct``) against
    ``packet_intersect_plain`` on an evenly spaced subset of SUBSET rays of
    one ray set, by the oracle rule (any-hit by mismatch count); fails on
    disagreement. Returns the subset (o, d, t cap), the kernel's hits and
    the max abs error."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk

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
        _, err = judge(f"{kind} {name}", got, ref)
    return (so, sd, st), got, err


def stack_line(label, tables) -> str:
    """The stack a table set needs: the reference's depth formula against
    the need its packing computed, and the loop that need takes."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    return (f"stack {label}: depth {tables.depth}, the reference's formula {tk.reference_stack_depth(tables)} "
            f"entries, the tables' true need {tk.stack_depth(tables)} (the kernels hold {tk.STACK_CAPACITY}, the "
            f"general loop's second instantiation {tk.DEEP_STACK_CAPACITY})")


def loops_line(label, same, walk_ms, general_ms, full):
    """One ray set through both loops of the source: the walk kernel's
    outputs against the general loop's (bit for bit), their whole-set
    times, and K5's bound and SIMT efficiency beside them."""
    phase(f"    loops {label}: walk {walk_ms:.4f} ms vs general loop {general_ms:.4f} ms on the whole set "
          f"({general_ms / walk_ms:.2f}x); outputs bit-equal {same}; operation-side bound "
          f"{full['op_bound_ms']:.4f} ms (walk {walk_ms / full['bound_ms']:.1f}x above the bound, general "
          f"{general_ms / full['bound_ms']:.1f}x); SIMT efficiency {full['simt_eff']:.3f}")
    if not same:
        fail(f"the walk kernel and the general loop disagree on {label}")


def bounce_population(scene, o, d, hit, sampler, settings):
    """One bounce's rays from the primary hits, as trace_wavefront makes
    them: the NEE shadow batch (dead lanes parked, cap 0) and the
    BRDF-sampled bounce rays (dead lanes parked at 1e30)."""
    import torch

    from raytracer3_tpu_torch.ops import brdf, mathx
    from raytracer3_tpu_torch.render import pathtracer
    from raytracer3_tpu_torch.scene import types as scene_types

    surf = scene_types.hit_surface_info(scene, hit.prim_id, hit.uv, hit.inst)
    nrm = pathtracer._face_forward(surf.normal, -d)
    onb = mathx.build_orthonormal_basis(nrm)
    hit_pos = o + hit.t[:, None] * d
    u_l, sampler = sampler.next3()
    sh_o, sh_d, sh_t, pre_ok, _, sampler = pathtracer._nee_prepare(
        scene, hit_pos, nrm, -d, surf, u_l, sampler, settings, alive_mask=hit.hit)
    u3, sampler = sampler.next3()
    s = brdf.surface_sample(surf.albedo, surf.roughness, surf.metalness, mathx.to_local(onb, -d), u3)
    alive = hit.hit & s.valid
    b_dir = mathx.to_world(onb, s.wi)
    b_org = torch.where(alive[:, None], hit_pos, 1e30)
    return (sh_o.contiguous(), sh_d.contiguous(), sh_t.contiguous(), pre_ok,
            b_org.contiguous(), b_dir.contiguous(), alive)


def _range_kernels(prof, name: str) -> dict:
    """Device µs by kernel name of the kernels launched inside every
    ``record_function(name)`` range of a profile."""
    from torch.autograd import DeviceType

    out = {}

    def walk(e):
        for k in e.kernels:
            out[k.name] = out.get(k.name, 0.0) + k.duration
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def profile_frame(render, kernel_keys, label: str, ranges=None):
    """Profile one call of ``render`` (a frame) with CPU and CUDA activity:
    device busy time, the share of kernels whose name holds one of
    ``kernel_keys``, the top device kernels, host events by self time, and
    the device time of the kernels inside each named range (the graph's
    ``pass:*``, the textures' ``texture:*``; gathers and the rest apart),
    which go into ``ranges`` when a dict is given. Returns (device busy ms,
    traversal ms, stream syncs)."""
    import torch
    from torch.autograd import DeviceType

    from raytracer3_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.trace() as prof:
        t_prof = time.perf_counter()
        render()
        t_issue = time.perf_counter() - t_prof
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t_prof
    averages = prof.key_averages()
    # Device-side events (kernels, memcpy/memset).
    rows = [(e.key, e.device_time_total, e.count) for e in averages
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0 and not e.key.startswith(RANGE_PREFIXES)]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    trav_us = sum(r[1] for r in rows if any(k in r[0] for k in kernel_keys))
    phase(f"profile of one {label} frame: device busy {busy_us / 1e3:.3f} ms, traversal kernels "
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
    names = sorted({e.key for e in averages if e.key.startswith(RANGE_PREFIXES)})
    for name in names:
        kern = _range_kernels(prof, name)
        dev_us = sum(kern.values())
        gather_us = sum(us for k, us in kern.items() if "index" in k.lower() or "gather" in k.lower())
        calls = sum(e.count for e in averages if e.key == name and e.device_type == DeviceType.CPU)
        phase(f"  range {name}: x{calls}, device {dev_us / 1e3:.3f} ms ({100 * dev_us / max(busy_us, 1):.1f}% of "
              f"busy) in {len(kern)} kernel names: gathers {gather_us / 1e3:.3f} ms, the rest (elementwise, "
              f"cat, reductions) {(dev_us - gather_us) / 1e3:.3f} ms")
        if ranges is not None:
            ranges[name] = dict(calls=calls, device_ms=dev_us / 1e3, gather_ms=gather_us / 1e3,
                                share=dev_us / max(busy_us, 1))
    return busy_us / 1e3, trav_us / 1e3, n_sync


def pipeline_phase(label, make, scene, settings, cam, backend, timed, kernel_keys, per_frame, dev):
    """Drive one pipeline through its entry point (``make(scene, settings,
    backend=, device=)``, then ``step(state, cam, frame_index)``): one
    warm-up frame and ``timed`` frames, each step timed by CUDA events, the
    launch counts set to 0 before and read after, then one profiled frame.
    Fails unless the display is a finite [H, W, 3] image with a positive
    mean and the path launched exactly ``per_frame`` (counter → launches
    per frame) and nothing else. Returns the phase's record."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    step, init_state = make(scene, settings, backend=backend, device=dev)
    state = init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    events = []
    t_host = time.perf_counter()
    for i in range(timed + 1):  # frame 0 is the warm-up (and a camera cut)
        if i == 1:
            torch.cuda.synchronize()
            t_host = time.perf_counter()
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        display, state = step(state, cam, i)
        e_ev.record()
        events.append((s_ev, e_ev))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    frames = timed + 1
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    phase(f"{label} launches over 1 warm-up + {timed} timed frames: {launches}")
    if launches != {k: n * frames for k, n in per_frame.items()}:
        fail(f"{label}: expected {per_frame} launches per frame, got {launches} over {frames} frames")
    w, h = settings.width, settings.height
    mean = float(display.mean())
    if tuple(display.shape) != (h, w, 3) or not bool(display.isfinite().all()) or not mean > 0.0:
        fail(f"{label}: the display is not a finite [H, W, 3] image with a positive mean (mean {mean})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ms = [s_ev.elapsed_time(e_ev) for s_ev, e_ev in events[1:]]
    frame_ms = statistics.median(ms)
    phase(f"{label} {w}x{h}: frame_ms median {frame_ms:.3f} (warm-up {events[0][0].elapsed_time(events[0][1]):.3f}; "
          f"frames {', '.join(f'{x:.3f}' for x in ms)}; host wall {host_s / timed * 1e3:.1f} ms/frame), "
          f"{1e3 / frame_ms:.2f} fps, peak device memory {peak_gib:.2f} GiB, launches per frame {per_frame}, "
          f"display mean {mean:.4f}")
    busy_ms, trav_ms, n_sync = profile_frame(lambda: step(state, cam, frames), kernel_keys, label)
    return dict(frame_ms=frame_ms, fps=1e3 / frame_ms, peak_gib=peak_gib, busy_ms=busy_ms, traversal_ms=trav_ms,
                stream_syncs=n_sync, launches=launches)


def probe_phases(scene, backend, pt, cam, dev):
    """The probe-GI path at bench.py's ``probe_gi``/``hybrid_gi`` configs
    (atrium detail 2 + sky, 960×544, bounces 1, samples 1) through K1/K2's
    walks; the probe display after 4 frames held against the same frames
    through K1/K2's general loop; the reference-mode tracer on the same
    scene; the Cornell golden through the packet backend. Returns the
    paths' records."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.ops.backend import TraceBackend
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.scene import analytic
    from raytracer3_tpu_torch.utils.config import RenderSettings

    keys = K12_KEYS
    ps = RenderSettings(width=HEADLINE["width"], height=HEADLINE["height"], bounces=1, samples=1)
    rec = {}
    # Per frame: the G-buffer's primaries and the probe rays (closest), the
    # probe hits' NEE shadow rays (any); hybrid adds the per-pixel direct
    # light's shadow rays.
    rec["probe_gi"] = pipeline_phase("probe_gi", pipelines.probe_gi_pipeline, scene, ps, cam, backend,
                                     PROBE_TIMED_FRAMES, keys, {"closest": 2, "any": 1}, dev)
    rec["hybrid_gi"] = pipeline_phase("hybrid_gi", pipelines.hybrid_gi_pipeline, scene, ps, cam, backend,
                                      PROBE_TIMED_FRAMES, keys, {"closest": 2, "any": 2}, dev)

    # The walks against the general loop: the same 4 frames of probe_gi.
    general = TraceBackend(
        backend.arrays,
        lambda a, o, d: general_packet(pt, o.contiguous(), d.contiguous(), tk._BG),
        lambda a, o, d, t: general_packet(pt, o.contiguous(), d.contiguous(), t, any_hit=True).hit,
    )
    shown = []
    for be in (backend, general):
        step, init_state = pipelines.probe_gi_pipeline(scene, ps, backend=be, device=dev)
        state = init_state()
        for i in range(4):
            display, state = step(state, cam, i)
        shown.append(display)
    same = same_bits(shown[0], shown[1])
    max_d = float((shown[0] - shown[1]).abs().max())
    phase(f"probe_gi display after 4 frames, K1/K2 walks vs the general loop: bit-equal {same}, max |diff| "
          f"{max_d:.3g} (limit 1e-6)")
    if not (same or max_d <= 1e-6):
        fail("the probe display through the walks disagrees with the general loop's")

    # The reference-mode tracer: per frame one primary trace, then per
    # sample and bounce one NEE shadow launch and, but on the last bounce,
    # one closest-hit launch.
    rs = RenderSettings(width=REFERENCE["width"], height=REFERENCE["height"], bounces=REFERENCE["bounces"],
                        samples=REFERENCE["samples"])
    n_closest = 1 + rs.samples * (rs.bounces - 1)
    rec["reference"] = pipeline_phase("reference mode", pipelines.reference_pipeline, scene, rs, cam, backend,
                                      PROBE_TIMED_FRAMES, keys, {"closest": n_closest, "any": rs.samples * rs.bounces},
                                      dev)

    # The Cornell golden (16 frames of reference mode) through K1/K2.
    c_scene = analytic.cornell_box(device=dev)
    c_backend = tk.packet_backend(scene=c_scene, device=dev)
    cs = RenderSettings(width=64, height=64, bounces=3, samples=1, diffuse_only=True)
    step, init_state = pipelines.reference_pipeline(c_scene, cs, backend=c_backend, device=dev)
    state = init_state()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    for i in range(16):
        _, state = step(state, analytic.default_camera(device=dev), i)
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    if launches != {"closest": 16 * 3, "any": 16 * 3}:
        fail(f"the Cornell golden did not go through K1/K2's walks as expected: {launches}")
    golden = np.load(os.path.join(REPO, "tests", "golden", "cornell_64_16f.npy"))
    diff = np.abs(state["film"].cpu().numpy() - golden)
    rel = float(diff.sum() / np.abs(golden).sum())
    share = float((diff.max(-1) <= 1e-3).mean())
    phase(f"golden cornell_64_16f (reference mode) through K1/K2: mean rel diff {rel:.3g} (limit 1e-3), pixels "
          f"within 1e-3 {share:.4f} (limit 0.98); launches {launches}")
    if not (rel < 1e-3 and share >= 0.98):
        fail("the Cornell golden disagrees")
    rec["cornell_golden"] = dict(launches=launches, mean_rel=rel, share=share)
    torch.cuda.empty_cache()
    return rec


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
    from raytracer3_tpu_torch.render import pipelines, wavefront
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.bench import frames_line, frames_run
    from raytracer3_tpu_torch.ops import mathx
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

    # --- 1b. the port's bench as a user runs it, before this process holds a scene
    bench_rec = bench_phase()

    # --- 2. headline scene and tables (host BVH build) -------------------
    t0 = time.perf_counter()
    scene, tris = procedural.atrium_scene(detail=2, return_host=True, device=dev)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    backend = tk.packet_backend(host_tris=tris, device=dev)
    t_bvh = time.perf_counter() - t0
    pt = backend.meta._replace(node_table=backend.arrays["nodes"], cluster_table=backend.arrays["clusters"])
    k12_table_bytes = nbytes(pt.node_table, pt.cluster_table)
    phase(f"scene: atrium detail=2 {tris[0].shape[0]} tris, sky 256x512, built in {t_scene:.2f} s; "
          f"BVH: {pt.num_nodes} wide-{pt.width} nodes, {pt.num_clusters} clusters of <= {pt.leaf_size}, "
          f"depth {pt.depth}, built in {t_bvh:.2f} s")
    phase("  " + stack_line("headline table", pt))

    # --- 3. kernels against the plain version at main-path shapes --------
    w, h = HEADLINE["width"], HEADLINE["height"]
    settings = RenderSettings(width=w, height=h, bounces=HEADLINE["bounces"], radiance_clamp=50.0)
    cam = procedural.atrium_camera(aspect=w / h, device=dev)
    blue_noise = torch.as_tensor(rng.generate_blue_noise(64), device=dev)
    o, d, b_org, b_dir, n_alive, sh_o, sh_d, sh_t, n_shadow = k12_population(
        scene, pt, cam, settings, blue_noise)
    park_o = torch.full((1024, 3), 1e30, device=dev)
    park_d = torch.nn.functional.normalize(torch.randn(1024, 3, device=dev, generator=torch.Generator(dev).manual_seed(0)), dim=-1)
    park_t = torch.zeros(1024, device=dev)

    if tk.trace_loop(pt.width, pt.leaf_size, single_level=True, stack_need=tk.stack_depth(pt)) != "walk":
        fail("the headline table does not take the walk kernels")
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
        (so, sd, st), got, err = k12_against_plain(pt, kind, name, co, cd, ct)
        n, any_hit = so.shape[0], kind == "any"
        if name == "parked" and bool(got.hit.any()):
            fail(f"a parked ray hit ({kind})")
        full = time_ms(lambda: tk.packet_intersect(pt, co, cd, t_max=ct if ct is not None else tk._BG,
                                                   any_hit=any_hit), 10)
        k_ms = time_ms(lambda: tk.packet_intersect(pt, so, sd, t_max=st, any_hit=any_hit), 10)
        p_ms = time_ms(lambda: tk.packet_intersect_plain(pt, so, sd, t_max=st, any_hit=any_hit), 3)
        phase(f"    time {kind} {name}: kernel {k_ms:.4f} ms vs plain {p_ms:.3f} ms on {n} rays; "
              f"kernel on all {co.shape[0]} rays {full:.4f} ms ({co.shape[0] / full / 1e3:.1f} Mray/s)")
        key = "K1 closest" if kind == "closest" else "K2 any"
        rec = records.setdefault(key, {"max_abs_err": 0.0, "cases": [], "k5": [], "loops": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append((name, n, k_ms, p_ms, co.shape[0], full))
        t_all = ct if ct is not None else tk._BG
        rec["k5"].append(None if name == "parked" else k5_packet(
            pt, f"{key} {name}", any_hit, (so, sd, st), (co, cd, t_all), 16))
        loops = None
        if name != "parked":
            same = same_bits(tk.packet_intersect(pt, co, cd, t_max=t_all, any_hit=any_hit),
                             general_packet(pt, co, cd, t_all, any_hit))
            g_full = time_ms(lambda: general_packet(pt, co, cd, t_all, any_hit), 10)
            loops = dict(general_ms=time_ms(lambda: general_packet(pt, so, sd, st, any_hit), 10),
                         full_general_ms=g_full)
            loops_line(f"{key} {name}", same, full, g_full, rec["k5"][-1]["full"])
        rec["loops"].append(loops)

    # --- 4. the atrium golden through the kernels --------------------------
    g_scene, g_tris = procedural.atrium_scene(detail=1, return_host=True, device=dev)
    g_cam = procedural.atrium_camera(aspect=1.0, device=dev)
    g_backend = tk.packet_backend(host_tris=g_tris, device=dev)
    gi, go = g_backend.bind(g_backend.arrays)
    gs = RenderSettings(width=48, height=48, bounces=2, samples=1, radiance_clamp=50.0)
    acc = torch.zeros((48, 48, 3), device=dev)
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    for i in range(4):
        acc += wavefront.render_frame(g_scene, g_cam, gs, i, gi, go, sort_rays=True)
    off_walk = [k for k, v in tk.LAUNCHES.items() if v and k not in ("closest", "any")]
    if not (tk.LAUNCHES["closest"] > 0 and tk.LAUNCHES["any"] > 0) or off_walk:
        fail(f"the golden through K1/K2 did not go through the walk kernels: {dict(tk.LAUNCHES)}")
    acc = (acc / 4).cpu().numpy()
    golden = np.load(os.path.join(REPO, "tests", "golden", "atrium_packet_48_4f.npy"))
    diff = np.abs(acc - golden)
    rel = float(diff.sum() / np.abs(golden).sum())
    share = float((diff.max(-1) <= 1e-3).mean())
    phase(f"golden atrium_packet_48_4f through K1/K2: mean rel diff {rel:.3g} (limit 1e-3), "
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
    if launches != dict({k: 0 for k in launches}, closest=4 * frames, any=4 * frames):
        fail(f"expected 4 closest-hit and 4 any-hit launches per frame on the walk, got {launches} over {frames} "
             f"frames")
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
    profile_frame(lambda: wavefront.render_frame(scene, cam, settings, TIMED_FRAMES + 1, isect, occl,
                                                 sort_rays=True, blue_noise=blue_noise),
                  K12_KEYS, "headline")
    headline_launches = launches

    # --- 6b. probe GI, hybrid and the reference-mode tracer on the headline scene
    probe_rec = probe_phases(scene, backend, pt, cam, dev)
    probe_rec.update(denoise_phase(scene, backend, settings, cam, blue_noise, dev))
    graph_phase(scene, backend, settings, cam, blue_noise, dev)
    probe_rec.update(textured_golden_phase(dev))
    probe_rec.update(oracle_phases(scene, backend, dev))
    probe_rec.update(bench_rec)
    probe_rec.update(ground_truth_phase())
    # --- 6b'. multi-device rendering on torch.distributed, one rank -------
    probe_rec.update(tiled_phase(scene, backend, settings, cam, dev, card))
    # --- 6c. BASELINE config 5: the viewer in-process, then its entry point --
    probe_rec.update(interactive_phase(dev, card))
    for kind, key in (("closest", "K1 closest"), ("any", "K2 any")):
        records[key]["max_abs_err"] = max(records[key]["max_abs_err"],
                                          probe_rec["interactive1080"]["max_abs_err"][kind])
    torch.cuda.empty_cache()
    viewer_main_phase(card)
    # --- 6d. BASELINE config 2: the LBVH oracle backends ------------------
    probe_rec.update(lbvh512_phase(dev, card))
    del scene, tris, backend, pt, film, acc, o, d, sh_o, sh_d, sh_t, b_org, b_dir, state, display
    torch.cuda.empty_cache()

    # --- 7. the 300k-triangle atrium through GLB ingest and World ----------
    from raytracer3_tpu_torch.ops import treelets

    t0 = time.perf_counter()
    big_scene, big_tris = procedural.sponza_world_scene(
        SPONZA["detail"], device=dev, cache_dir=os.path.join(REPO, "build", "assets"))
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = tk.packet_backend(host_tris=big_tris, device=dev)
    t_tt = time.perf_counter() - t0
    if not (big.self_sorting and isinstance(big.meta, treelets.TreeletTables)):
        fail("packet_backend did not route the 300k-triangle scene to the treelet backend")
    tt = big.meta._replace(node_tables=big.arrays["nodes"], cluster_tables=big.arrays["clusters"],
                           aabb=big.arrays["aabb"])
    tt_shape = (tt.width, tt.leaf_size)
    table_mb = (tt.node_tables.numel() + tt.cluster_tables.numel()) * 4 / 1e6
    k3_table_bytes = nbytes(tt.node_tables, tt.cluster_tables, tt.aabb)
    phase(f"sponza scene: atrium detail={SPONZA['detail']} -> GLB -> asset cache -> World: "
          f"{big_tris[0].shape[0]} tris ({big_scene.indices.shape[0]} with the pool's padding), "
          f"built in {t_ingest:.2f} s; treelets: K={tt.num_treelets}, depth {tt.depth}, width {tt.width}, "
          f"leaf {tt.leaf_size}, nodes {tuple(tt.node_tables.shape)} + clusters "
          f"{tuple(tt.cluster_tables.shape)} = {table_mb:.1f} MB, built in {t_tt:.2f} s")
    phase("  " + stack_line("sponza treelets", tt))

    # --- 8. K3 against its plain version at sponza720's shapes ---------------
    sw, shh, spp = SPONZA["width"], SPONZA["height"], SPONZA["samples"]
    s_settings = RenderSettings(width=sw, height=shh, bounces=SPONZA["bounces"], samples=spp,
                                sample_batch=True, radiance_clamp=50.0, lane_diet=True)
    cam720 = procedural.atrium_camera(aspect=sw / shh, device=dev)
    parts = [wavefront.sample_rays(cam720, s_settings, 0, s_i, blue_noise) for s_i in range(spp)]
    po = torch.cat([p_[0] for p_ in parts]).contiguous()
    pd = torch.cat([p_[1] for p_ in parts]).contiguous()
    psampler = rng.Sampler(seed=torch.cat([p_[2].seed for p_ in parts]), index=parts[0][2].index)
    del parts
    primary_b = big.bind_primary(big.arrays)
    prim_b = primary_b(po, pd)
    sh_o, sh_d, sh_t, pre_ok, b_org, b_dir, alive = bounce_population(
        big_scene, po, pd, prim_b, psampler, s_settings)
    n_lanes = po.shape[0]
    sorted_kw = dict(sublanes=1024, max_groups=treelets.MAX_GROUPS_SORTED, step_cull=True)
    bg = torch.full((n_lanes,), mathx.BACKGROUND_DEPTH, device=dev)
    park_o2 = torch.full((1024, 3), 1e30, device=dev)
    park_t2 = torch.zeros(1024, device=dev)
    flags = torch.cat([torch.ones(n_lanes, dtype=torch.bool, device=dev),
                       torch.zeros(n_lanes, dtype=torch.bool, device=dev)])
    k3_sets = [
        ("closest", "presorted tiled primaries", po, pd, bg, None,
         dict(sublanes=512, max_groups=treelets.MAX_GROUPS_PRIMARY, step_cull=True, presorted=True)),
        ("closest", "sorted bounce", b_org, b_dir, bg, None, sorted_kw),
        ("any", "NEE shadow t_max", sh_o, sh_d, sh_t, None, dict(sorted_kw, any_hit=True)),
        # The frame's tail launch: the last bounce's shadow batch and its
        # escape probes in one any-hit launch (wavefront.trace_wavefront).
        ("any", "tail shadow+escape", torch.cat([sh_o, b_org]), torch.cat([sh_d, b_dir]),
         torch.cat([sh_t, bg]), None, dict(sorted_kw, any_hit=True)),
        ("mixed", "capped shadow+bounce", torch.cat([sh_o, b_org]), torch.cat([sh_d, b_dir]),
         torch.cat([sh_t, bg]), flags, sorted_kw),
        ("closest", "parked", park_o2, park_d, park_t2, None, sorted_kw),
        ("any", "parked", park_o2, park_d, park_t2, None, dict(sorted_kw, any_hit=True)),
    ]
    phase(f"K3 vs plain at sponza720 shapes ({sw}x{shh}x{spp} spp = {n_lanes} lanes; primaries hit "
          f"{int(prim_b.hit.sum())}, bounce {int(alive.sum())} alive, shadow {int(pre_ok.sum())} traced; "
          f"evenly spaced subsets of {K3_SUBSET} rays):")
    k3 = {"closest": {"max_abs_err": 0.0, "cases": [], "k5": [], "loops": []},
          "any": {"max_abs_err": 0.0, "cases": [], "k5": [], "loops": []}}
    bounce_launch = None
    for kind, name, co, cd, ct, cf, kw in k3_sets:
        n = min(K3_SUBSET, co.shape[0])
        so, sd, st = sub(co, n), sub(cd, n), sub(ct, n)
        sf = sub(cf, n) if cf is not None else None
        sl = treelets.segment_launch(tt, so, sd, t_max=st, anyhit_mask=sf, **kw)
        got = treelets.finish(sl, sl.launch(tt))
        ref = treelets.finish(sl, sl.launch(tt, fn=tk.packet_intersect_segments_plain))
        torch.cuda.synchronize()
        if kind == "any":
            mism = int((got.hit != ref.hit).sum())
            err = float((got.hit.float() - ref.hit.float()).abs().max())
            phase(f"  K3 any {name}: n={n} hits={int(got.hit.sum())} mismatches={mism} (limit {max(2, n // 500)})")
            if mism > max(2, n // 500):
                fail(f"K3 any-hit disagrees with its plain version on {name}")
        elif kind == "mixed":
            f_ = sf
            mism = int((got.hit[f_] != ref.hit[f_]).sum())
            phase(f"  K3 mixed {name}, flagged half: n={int(f_.sum())} hits={int(got.hit[f_].sum())} "
                  f"mismatches={mism} (limit {max(2, int(f_.sum()) // 500)})")
            if mism > max(2, int(f_.sum()) // 500):
                fail(f"K3 flagged lanes disagree with the plain version on {name}")
            keep = ~f_
            _, err = judge(f"K3 mixed {name}, closest half",
                           type(got)(*(None if x is None else x[keep] for x in got)),
                           type(ref)(*(None if x is None else x[keep] for x in ref)))
        else:
            _, err = judge(f"K3 closest {name}", got, ref)
        if name == "parked" and bool(got.hit.any()):
            fail(f"a parked ray hit (K3 {kind})")
        sl_full = treelets.segment_launch(tt, co, cd, t_max=ct, anyhit_mask=cf, **kw)
        full = time_ms(lambda: sl_full.launch(tt), 5)
        k_ms = time_ms(lambda: sl.launch(tt), 10)
        p_ms = time_ms(lambda: sl.launch(tt, fn=tk.packet_intersect_segments_plain), 1)
        hit_only = kind == "any"
        trace = time_ms(lambda: treelets.treelet_intersect(tt, co, cd, t_max=ct, anyhit_mask=cf,
                                                           hit_only=hit_only, **kw), 3)
        phase(f"    time K3 {kind} {name}: kernel {k_ms:.4f} ms vs plain {p_ms:.3f} ms on {n} rays; kernel on all "
              f"{co.shape[0]} rays ({sl_full.seg_list.shape[0]} segments x {sl_full.seg_list.shape[1]} steps) "
              f"{full:.4f} ms ({co.shape[0] / full / 1e3:.1f} Mray/s); driver + kernel + un-sort {trace:.3f} ms")
        rec = k3["any" if kind == "any" else "closest"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append((name, n, k_ms, p_ms, co.shape[0], full))
        rec["k5"].append(None if name == "parked" else k5_segments(tt, f"K3 {kind} {name}", sl, sl_full))
        loops = None
        if name != "parked":
            if tk.trace_loop(tt.width, tt.leaf_size, group_rays=tk._segment_groups(
                    kw["sublanes"], kw["max_groups"])[1], stack_need=tk.stack_depth(tt)) != "walk":
                fail("sponza720's treelet tables do not take the walk kernels")
            same = same_bits(sl_full.launch(tt), general_segments(tt, sl_full))
            g_full = time_ms(lambda: general_segments(tt, sl_full), 5)
            loops = dict(general_ms=time_ms(lambda: general_segments(tt, sl), 10), full_general_ms=g_full)
            loops_line(f"K3 {kind} {name}", same, full, g_full, rec["k5"][-1]["full"])
        rec["loops"].append(loops)
        if name == "sorted bounce":
            bounce_launch = sl_full
        else:
            del sl_full

    # --- 8b. K3's rounds driver and nearest_first beside the single pass -----
    rounds_rec = rounds_phase(tt, b_org, b_dir, bg, sh_o, sh_d, sh_t, sorted_kw, sub)

    # --- 9. the atrium golden through K3 -------------------------------------
    g_scene, g_tris = procedural.atrium_scene(detail=1, return_host=True, device=dev)
    g_tb = treelets.treelet_backend(host_tris=g_tris, max_tris=4096, device=dev)
    gi, go = g_tb.bind(g_tb.arrays)
    gp = g_tb.bind_primary(g_tb.arrays)
    acc = torch.zeros((48, 48, 3), device=dev)
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    for i in range(4):
        acc += wavefront.render_frame(g_scene, g_cam, gs, i, gi, go, sort_rays=not g_tb.self_sorting,
                                      primary_fn=gp)
    off_walk = [k for k, v in tk.LAUNCHES.items() if v and ("general" in k or "deep" in k)]
    if not (tk.LAUNCHES["seg_closest"] > 0 and tk.LAUNCHES["seg_any"] > 0) or off_walk:
        fail(f"the golden through K3 did not go through the walk kernels: {dict(tk.LAUNCHES)}")
    acc = (acc / 4).cpu().numpy()
    diff = np.abs(acc - golden)
    rel = float(diff.sum() / np.abs(golden).sum())
    share = float((diff.max(-1) <= 1e-3).mean())
    phase(f"golden atrium_packet_48_4f through K3 ({g_tb.meta.num_treelets} treelets): mean rel diff "
          f"{rel:.3g} (limit 1e-3), pixels within 1e-3 {share:.4f} (limit 0.98)")
    if not (g_tb.meta.num_treelets >= 2 and rel < 1e-3 and share >= 0.98):
        fail("the atrium golden through K3 disagrees")

    # --- 10. routing record: K1 over one whole-scene table vs K3 -------------
    t0 = time.perf_counter()
    from raytracer3_tpu_torch.ops import cluster_bvh

    one = tk.tables_from_numpy(tk.pack_tables_host(cluster_bvh.build_cluster_bvh_host(
        *big_tris, 12, width=16, cluster_mode="sah")), dev)
    t_one = time.perf_counter() - t0
    bo, bd = bounce_launch.origins, bounce_launch.directions
    if tk.trace_loop(one.width, one.leaf_size, single_level=True, stack_need=tk.stack_depth(one)) != "walk":
        fail("the whole-scene table does not take the walk kernels")
    k1_hit = tk.packet_intersect(one, bo, bd)
    one_same = same_bits(k1_hit, general_packet(one, bo, bd, tk._BG))
    k3_hit = treelets.finish(bounce_launch._replace(order=None, n=bo.shape[0]), bounce_launch.launch(tt))
    torch.cuda.synchronize()
    # Two different trees may part on a grazing ray: where the ray touches a
    # box only at its edge, the slab test can round the box away in one tree
    # and not in the other. So the record counts the rays they part on (hit
    # mask, or t beyond rtol 1e-4) and holds that count to the oracle rule's
    # mismatch limit.
    n_b = bo.shape[0]
    both = k1_hit.hit & k3_hit.hit
    hit_mism = int((k1_hit.hit != k3_hit.hit).sum())
    t_off = int((both & ((k1_hit.t - k3_hit.t).abs() > 1e-5 + 1e-4 * k3_hit.t.abs())).sum())
    same = int((both & (k1_hit.prim_id == k3_hit.prim_id)).sum())
    phase(f"  K1 whole-scene table vs K3 treelets, sorted bounce: n={n_b} hit mismatches={hit_mism}, "
          f"t beyond rtol 1e-4 {t_off} (limit {max(2, n_b // 500)} together), same_prim={same}/{int(both.sum())}")
    if hit_mism + t_off > max(2, n_b // 500):
        fail("K1 over one whole-scene table and K3 over treelets part on too many rays")
    if not one_same:
        fail("K1's walk and its general loop disagree on the whole-scene table")
    k1_ms = time_ms(lambda: tk.packet_intersect(one, bo, bd), 5)
    k1_general_ms = time_ms(lambda: general_packet(one, bo, bd, tk._BG), 5)
    k3_ms = time_ms(lambda: bounce_launch.launch(tt), 5)
    bounds_b = (big_scene.positions.amin(0), big_scene.positions.amax(0))
    isect1 = lambda o_, d_: tk.packet_intersect(one, o_.contiguous(), d_.contiguous())
    k1_trace = time_ms(lambda: wavefront.sorted_trace(isect1, b_org, b_dir, alive, bounds_b), 3)
    k3_trace = time_ms(lambda: big.intersect(b_org, b_dir), 3)
    phase("  " + stack_line("whole-scene table", one))
    phase(f"routing record ({card}): one leaf-12 table of {one.num_clusters} clusters, depth {one.depth}, "
          f"{(one.node_table.numel() + one.cluster_table.numel()) * 4 / 1e6:.1f} MB, built in {t_one:.2f} s; "
          f"{one.node_table.shape[0]} node rows; on the {bo.shape[0]} treelet-sorted bounce rays K1 on the walk "
          f"{k1_ms:.4f} ms (general loop {k1_general_ms:.4f} ms, outputs bit-equal {one_same}) vs K3 {k3_ms:.4f} ms; "
          f"whole bounce trace K1 + sorted_trace {k1_trace:.3f} ms vs treelet backend {k3_trace:.3f} ms")
    del k1_hit, k3_hit, bounce_launch, po, pd, prim_b, sh_o, sh_d, sh_t, b_org, b_dir, bg, flags, k3_sets
    torch.cuda.empty_cache()

    # --- 11. sponza720 through the user entry points, bench.py's setting -----
    isect_b, occl_b = big.bind(big.arrays)
    s_rec = frames_run("sponza720 at 16 spp", lambda fi: wavefront.render_frame(
        big_scene, cam720, s_settings, fi, isect_b, occl_b, sort_rays=not big.self_sorting, blue_noise=blue_noise,
        return_stats=True, primary_fn=primary_b), SPONZA_TIMED_FRAMES, {"seg_closest": 2, "seg_any": 2}, dev)
    phase(frames_line("sponza720 at 16 spp", s_rec, s_settings))
    s_launches, diet_rad0 = s_rec["launches"], s_rec.pop("radiance0")
    frames = SPONZA_TIMED_FRAMES + 1
    s_rec["busy_ms"] = profile_frame(lambda: wavefront.render_frame(
        big_scene, cam720, s_settings, frames, isect_b, occl_b, sort_rays=not big.self_sorting,
        blue_noise=blue_noise, primary_fn=primary_b),
        K3_KEYS, "sponza720 at 16 spp")[0]
    torch.cuda.empty_cache()
    probe_rec.update(sponza_variants(big, big_scene, cam720, s_settings, blue_noise, diet_rad0, dev))
    del diet_rad0
    torch.cuda.empty_cache()
    # --- 11a. sponza720_textured: the mip atlas and vertex colours through K3 ---
    probe_rec.update(textured_sponza_phase(big, big_scene, cam720, s_settings, blue_noise, s_rec, dev))

    # --- 11b. sponza1080_probe_gi: the probe pipeline at 1080p through K3 ---
    p_settings = RenderSettings(bounces=1, samples=1, **SPONZA1080_PROBE)
    cam1080 = procedural.atrium_camera(aspect=p_settings.width / p_settings.height, device=dev)
    probe_rec["sponza1080_probe_gi"] = pipeline_phase(
        f"sponza1080_probe_gi (texel splits {p_settings.probe_texel_splits})", pipelines.probe_gi_pipeline,
        big_scene, p_settings, cam1080, big, PROBE_TIMED_FRAMES,
        K3_KEYS, {"seg_closest": 2, "seg_any": 1}, dev)
    torch.cuda.empty_cache()
    probe_rec.update(interactive_probe_phase(big, big_scene, dev, card))
    torch.cuda.empty_cache()
    probe_rec.update(interactive_evidence_phase(big, big_scene, big_tris, dev))
    torch.cuda.empty_cache()

    # --- 11c. sponza1080: the north star, bench.py's settings, through K3 -----
    probe_rec["sponza1080"] = sponza1080_phase(big, big_scene, blue_noise, dev)
    torch.cuda.empty_cache()
    # The other route of the 300k atrium on the same frames.
    probe_rec.update(route_phase(one, big_scene, s_settings, cam720, blue_noise, dev))
    del one

    del big, big_scene, big_tris, tt, isect_b, occl_b
    torch.cuda.empty_cache()

    # --- 12-16. instanced720 through the two-level backend (K4) --------------
    k4 = instanced_phases(dev, blue_noise, s_settings, cam720, card)

    # --- 17. the traversal-statistics path: the port's probe ---------------
    from raytracer3_tpu_torch.tools import perf_probe

    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    probe = {}
    for argv in (["--stats"], ["--instanced", "--detail", "8", "--stats"],
                 ["--treelet", "--detail", "8", "--stats", "--rounds"]):
        phase(f"perf_probe {' '.join(argv)} --reps 3:")
        probe[argv[0]] = perf_probe.main(argv + ["--reps", "3"])
    p_launches = dict(tk.LAUNCHES)
    phase(f"probe launches: {p_launches}")
    rounds_launches = sum(sum(v for k, v in probe["--treelet"]["launches"][sec].items() if k.startswith("seg_"))
                          for sec in ("bounce rounds", "shadow rounds"))
    missing = [k for k in ("closest_stats", "any_stats", "tlas_closest_stats", "tlas_any_stats",
                           "seg_closest_stats", "seg_any_stats") if p_launches[k] == 0]
    if missing or rounds_launches == 0:
        fail(f"the probe path launched no {missing or 'K3 launch of the rounds driver'}")
    stray = [k for k, v in p_launches.items() if ("general" in k or "deep" in k) and v]
    if stray or not all(p_launches[k] for k in ("closest", "any", "seg_closest", "tlas_closest", "seg_any", "tlas_any")):
        fail(f"the probe's launches did not go through the walk kernels: {p_launches}")
    for path, out in probe.items():
        for name, pop in out["populations"].items():
            if "stats" in pop and not (pop["stats"]["node_pops"] >= 1.0 and pop["ms"] > 0):
                fail(f"perf_probe {path}: no visits counted on {name}")

    # --- record -----------------------------------------------------------
    if "jax" in sys.modules and not jax_before:
        fail("the port loaded jax")
    kernels = []
    # ms and plain_ms: both versions on the same subset of one ray set;
    # bound_ms the least time for that subset: the larger of the bytes side
    # (rays in, results out, tables read once, over 3.35 TB/s) and the
    # operation side (the float32 operations of the subset's own visits,
    # counted by K5, over 67 TFLOP/s); full_*: the same on the whole set, as
    # its path launches it; bound_side, simt_eff and mean_counts are the
    # whole set's. launches: the count from the path's own run (headline for
    # K1/K2, sponza720 for K3, instanced720 for K4, the probe for K5 and the
    # rounds driver). The closest-hit rows of K3 and K4 are the walk kernels;
    # ms_general and full_ms_general are the general loop's times on the same
    # rays in this run (the loop those rows ran before the walk was written).
    def row(name, fn, replaces, launches, err, ms, plain_ms, n, sub, full, full_ms, n_full):
        return {
            "name": f"{name}: {fn}", "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": sub["bound_ms"], "bound_by": sub["bound_by"], "library_ms": None,  # no PyTorch call traverses a BVH
            "op_bound_ms": sub["op_bound_ms"], "bytes_bound_ms": sub["bytes_bound_ms"],
            "bound_side": full["bound_by"], "simt_eff": full["simt_eff"],
            "mean_counts": {k: full[k] for k in tk.STAT_COLUMNS},
            "row_bytes_per_ray": full["row_bytes_per_ray"], "rays": n, "full_ms": full_ms,
            "full_bound_ms": full["bound_ms"], "full_op_bound_ms": full["op_bound_ms"], "full_rays": n_full,
        }

    w3, w4 = f"<{tt_shape[0]}, {tt_shape[1]}, ", f"<{k4['shape'][0]}, {k4['shape'][1]}, "
    # One row per kernel, with the launches its path counted. A frame's two
    # any-hit launches are a bounce's NEE shadow batch and the tail (the last
    # bounce's shadow batch with its escape probes): the row's own numbers
    # are the shadow set's, and "tail" holds the tail set's.
    for key, rec, case, tail, fn, stats_fn, replaces, n_launch, stats_key in (
        ("K1 closest", records["K1 closest"], 1, None, "traverse_walk_kernel<16, 12, false>",
         "traverse_walk_kernel<16, 12, true>", REPLACES, headline_launches["closest"], "closest_stats"),
        ("K2 any", records["K2 any"], 0, None, "traverse_walk_any_kernel<16, 12, false>",
         "traverse_walk_any_kernel<16, 12, true>", REPLACES, headline_launches["any"], "any_stats"),
        ("K3 closest", k3["closest"], 1, None, f"segment_walk_kernel{w3}false>", f"segment_walk_kernel{w3}true>",
         REPLACES_K3, s_launches["seg_closest"], "seg_closest_stats"),
        ("K3 any", k3["any"], 0, 1, f"segment_walk_any_kernel{w3}false>", f"segment_walk_any_kernel{w3}true>",
         REPLACES_K3, s_launches["seg_any"], "seg_any_stats"),
        ("K4 closest", k4["closest"], 1, None, f"tlas_walk_kernel{w4}false>", f"tlas_walk_kernel{w4}true>",
         REPLACES_K4, k4["launches"]["tlas_closest"], "tlas_closest_stats"),
        # The instanced720 frame launches its tail in the frame's order
        # (case 1); the same lanes coherence-sorted (case 2) sit under
        # "tail_sorted".
        ("K4 any", k4["any"], 0, 1, f"tlas_walk_any_kernel{w4}false>", f"tlas_walk_any_kernel{w4}true>",
         REPLACES_K4, k4["launches"]["tlas_any"], "tlas_any_stats"),
    ):
        name, n, k_ms, p_ms, n_full, full = rec["cases"][case]
        k5 = rec["k5"][case]
        kernels.append(row(f"{key} ({name})", fn, replaces, n_launch, rec["max_abs_err"], k_ms, p_ms, n,
                           k5["sub"], k5["full"], full, n_full))
        counter = {"K1 closest": "closest", "K2 any": "any", "K3 closest": "seg_closest",
                   "K3 any": "seg_any"}.get(key)
        if counter is not None:
            # Every path that runs this kernel, each counted in its own run.
            by_path = {"headline" if key[1] in "12" else "sponza720": n_launch}
            by_path.update({path: prec["launches"][counter] for path, prec in probe_rec.items()
                            if prec["launches"].get(counter)})
            kernels[-1]["launches_by_path"] = by_path
        if rec["loops"][case] is not None:
            kernels[-1].update(ms_general=rec["loops"][case]["general_ms"],
                               full_ms_general=rec["loops"][case]["full_general_ms"])
        # K5: the stats form of the same kernel on the same rays (its
        # counts bit-equal to traverse_plain's, so its error is 0).
        kernels.append(row(f"K5 of {key} ({name})", stats_fn, REPLACES_K5,
                           p_launches[stats_key], 0.0, k5["ms"], k5["plain_ms"], n, k5["stats_sub"], k5["full"],
                           k5["full_ms"], n_full))
        tails = [] if tail is None else [("tail", tail)] + ([("tail_sorted", 2)] if key == "K4 any" else [])
        if key == "K3 closest":
            # The mixed-hit shape (shadow lanes flagged any-hit) on the 29.5M
            # lanes of a fused launch.
            tails = [("mixed", 2)]
        for label, c in tails:
            t_name, t_n, t_ms, t_plain, t_n_full, t_full_ms = rec["cases"][c]
            t5 = rec["k5"][c]
            kernels[-2][label] = {
                "rays_set": t_name, "rays": t_n, "ms": t_ms, "plain_ms": t_plain, "bound_ms": t5["sub"]["bound_ms"],
                "full_rays": t_n_full, "full_ms": t_full_ms, "full_bound_ms": t5["full"]["bound_ms"],
                "full_op_bound_ms": t5["full"]["op_bound_ms"], "simt_eff": t5["full"]["simt_eff"],
                "mean_counts": {k: t5["full"][k] for k in tk.STAT_COLUMNS}, "stats_full_ms": t5["full_ms"],
                "ms_general": rec["loops"][c]["general_ms"], "full_ms_general": rec["loops"][c]["full_general_ms"],
            }
        if key == "K4 any":
            kernels[-2]["tail_sort"] = k4["tail_sort"]
        if key == "K3 closest":
            # Of a fused frame's two K3 closest-hit launches one is the
            # primary trace, the other the mixed launch.
            fr = probe_rec["sponza720_fused"]
            kernels[-2]["mixed"]["launches_by_path"] = {"sponza720_fused": fr["launches"]["seg_closest"] - fr["frames"]}
    r = rounds_rec
    kernels.append(row("K3-rounds (sorted bounce, treelet_intersect_rounds)", f"segment_walk_kernel{w3}false>",
                       REPLACES_ROUNDS, rounds_launches, r["max_abs_err"], r["ms"], r["plain_ms"], r["n"],
                       r["sub"], r["full"], r["full_ms"], r["n_full"]))
    total = time.perf_counter() - T_START
    shares = ", ".join(f"{k} {v:.1f} s ({100 * v / total:.1f}%)" for k, v in PHASE_S.items())
    phase(f"chip_smoke total {total:.1f} s: {shares}, the rest {total - sum(PHASE_S.values()):.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def textured_golden_phase(dev):
    """The reference's two textured goldens (``tools/regen_goldens.py``)
    through the packet backend's K1/K2: ``textured_mip_64_8f`` (wavefront,
    mip atlas, ray-cone level) and ``textured_64_8f`` (reference mode,
    legacy texture array), 8 frames each, by the atrium golden's rule.
    Their 4 triangles make one cluster, so the tables may take K1/K2's
    general loop and not the walk: printed, and either counts. Returns the
    records."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import pathtracer, wavefront
    from raytracer3_tpu_torch.scene import analytic

    rec = {}
    for name, mip in (("textured_mip_64_8f", True), ("textured_64_8f", False)):
        scene, cam, s = analytic.textured_floor(mip, device=dev)
        backend = tk.packet_backend(scene=scene, device=dev)
        pt = backend.meta._replace(node_table=backend.arrays["nodes"], cluster_table=backend.arrays["clusters"])
        loop = tk.trace_loop(pt.width, pt.leaf_size, single_level=True, stack_need=tk.stack_depth(pt))
        isect, occl = backend.bind(backend.arrays)
        render = wavefront.render_frame if mip else pathtracer.render_image
        for k in tk.LAUNCHES:
            tk.LAUNCHES[k] = 0
        acc = sum(render(scene, cam, s, i, isect, occl) for i in range(8)) / 8
        launches = {k: v for k, v in tk.LAUNCHES.items() if v}
        keys = ("closest", "any") if loop == "walk" else (f"closest_{loop}", f"any_{loop}")
        if not all(launches.get(k) for k in keys) or set(launches) - set(keys):
            fail(f"the golden {name} did not go through K1/K2 ({loop} loop) as expected: {launches}")
        golden = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npy"))
        diff = np.abs(acc.cpu().numpy() - golden)
        rel = float(diff.sum() / np.abs(golden).sum())
        share = float((diff.max(-1) <= 1e-3).mean())
        what = "wavefront, mip atlas, ray cone" if mip else "reference mode, texture array"
        phase(f"golden {name} ({what}) through K1/K2: {pt.num_clusters} cluster, {pt.num_nodes} node of width "
              f"{pt.width}: K1/K2's {loop} loop{'' if loop == 'walk' else ' (the walk takes width 16, leaf 12)'}; "
              f"mean rel diff {rel:.3g} (limit 1e-3), pixels within 1e-3 {share:.4f} (limit 0.98), max |diff| "
              f"{float(diff.max()):.3g}; launches {launches}")
        if not (rel < 1e-3 and share >= 0.98):
            fail(f"the golden {name} disagrees")
        rec[f"golden {name}"] = dict(launches=launches, mean_rel=rel, share=share, loop=loop)
    return rec


def graph_phase(scene, backend, settings, cam, blue_noise, dev):
    """``wavefront_pipeline`` (trace → blend → post on the frame graph)
    after 4 headline frames against the same frames composed by hand:
    ``render_frame`` with the backend's primary trace → the film's 1/(n+1)
    blend → AgX. The displays must be equal bit for bit."""
    import torch

    from raytracer3_tpu_torch.render import pipelines, postprocess, wavefront

    step, init_state = pipelines.wavefront_pipeline(scene, settings, backend=backend, blue_noise=blue_noise,
                                                    device=dev)
    state = init_state()
    for i in range(4):
        display, state = step(state, cam, i)
    isect, occl = backend.bind(backend.arrays)
    primary = backend.bind_primary(backend.arrays)
    film = torch.zeros((settings.height, settings.width, 3), device=dev)
    n = torch.zeros((), device=dev)
    for i in range(4):
        radiance = wavefront.render_frame(scene, cam, settings, i, isect, occl, sort_rays=True, blue_noise=blue_noise,
                                          primary_fn=primary)
        film = film + (radiance - film) * (1.0 / (n + 1.0))
        n = n + 1.0
    by_hand = postprocess.postprocess(film)
    same = same_bits(display, by_hand) and same_bits(state["film"], film)
    phase(f"wavefront_pipeline on the frame graph after 4 headline frames vs the frames composed by hand: display "
          f"and film bit-equal {same}, max |display diff| {float((display - by_hand).abs().max()):.3g}")
    if not same:
        fail("the graph's wavefront pipeline differs from the composition by hand")


def textured_sponza_phase(big, big_scene, cam, s_settings, blue_noise, untextured, dev):
    """sponza720_textured: sponza720's triangles (the World scene's arrays,
    pulled back: its order and pool padding, so ``big``'s treelet tables
    trace it), materials and sky through ``make_scene`` with one seeded
    texture per non-emissive material (``TEX_SIZES``: the mip atlas) and
    seeded per-vertex colours (32-lane shade rows), at bench.py's sponza720
    settings through K3. Frames as ``frames_run`` drives them, one
    profiled frame with the texture ranges, beside the untextured frame of
    this call (``untextured``); then the card's ``sample_atlas`` against
    the CPU's on ``TEX_LANES`` of frame 0's first-bounce lanes. Returns
    the record."""
    from raytracer3_tpu_torch.bench import frames_line, frames_run
    import torch

    from raytracer3_tpu_torch.render import wavefront
    from raytracer3_tpu_torch.scene import textures
    from raytracer3_tpu_torch.scene import types as scene_types

    host = {k: getattr(big_scene, k).cpu().numpy() for k in ("positions", "normals", "uvs", "indices", "geo_id")}
    mats = {k: getattr(big_scene.materials, k).cpu().numpy() for k in ("base_color", "emission", "metallic",
                                                                        "roughness")}
    textured = mats["emission"].max(-1) <= 0.0
    bct = np.full(len(textured), -1, np.int32)
    bct[textured] = np.arange(int(textured.sum()), dtype=np.int32)
    if int(textured.sum()) != len(TEX_SIZES):
        fail(f"the atrium has {int(textured.sum())} non-emissive materials, not {len(TEX_SIZES)}")
    rng = np.random.default_rng(TEX_SEED)
    images = [rng.random((h, w, 3), dtype=np.float32) for h, w in TEX_SIZES]
    colors = (0.5 + 0.5 * rng.random((host["positions"].shape[0], 3), dtype=np.float32)).astype(np.float32)
    t0 = time.perf_counter()
    atlas, meta = textures.build_texture_atlas(images)
    t_atlas = time.perf_counter() - t0
    del atlas
    t0 = time.perf_counter()
    tscene = scene_types.make_scene(**host, **mats, base_color_texture=bct, tex_images=images, colors=colors,
                                    env_map=big_scene.env_map.cpu().numpy(), device=dev)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    del images
    ah, aw = tscene.tex_atlas.shape[:2]
    phase(f"sponza720_textured scene: {tscene.num_triangles} triangles, {len(TEX_SIZES)} textures "
          f"{[f'{w}x{h}' for h, w in TEX_SIZES]} -> atlas {aw} x {ah} texels ({nbytes(tscene.tex_atlas) / 1e6:.1f} "
          f"MB f32, {nbytes(tscene.tex_words) / 1e6:.1f} MB rgb9e5 words), mip levels {meta[:, 4].astype(int).tolist()}, "
          f"log2 texel density per material {np.round(tscene.mat_table[:, 9].cpu().numpy(), 3).tolist()}; atlas "
          f"built on the host in {t_atlas:.2f} s, make_scene (atlas, densities, 32-lane rows, upload, pack) "
          f"{t_scene:.2f} s; shade rows {tuple(tscene.shade_table.shape)}")

    isect, occl = big.bind(big.arrays)
    primary = big.bind_primary(big.arrays)

    def render(fi, stats=True):
        return wavefront.render_frame(tscene, cam, s_settings, fi, isect, occl, sort_rays=not big.self_sorting,
                                      blue_noise=blue_noise, return_stats=stats, primary_fn=primary)

    rec = frames_run("sponza720_textured", render, SPONZA_TIMED_FRAMES, {"seg_closest": 2, "seg_any": 2}, dev)
    rec.pop("radiance0")
    phase(frames_line("sponza720_textured", rec, s_settings))
    ranges = {}
    busy, trav, n_sync = profile_frame(lambda: render(SPONZA_TIMED_FRAMES + 1, stats=False), K3_KEYS,
                                       "sponza720_textured", ranges)
    rec.update(busy_ms=busy, traversal_ms=trav, stream_syncs=n_sync, ranges=ranges)
    tex_ms = sum(r["device_ms"] for r in ranges.values())
    phase(f"sponza720_textured vs sponza720 (same call, same backend and settings): frame_ms {rec['frame_ms']:.3f} vs "
          f"{untextured['frame_ms']:.3f} ({100 * (rec['frame_ms'] / untextured['frame_ms'] - 1):+.1f}%), spp/s "
          f"{s_settings.samples / rec['frame_ms'] * 1e3:.3f} vs {s_settings.samples / untextured['frame_ms'] * 1e3:.3f}, "
          f"peak {rec['peak_gib']:.2f} vs {untextured['peak_gib']:.2f} GiB, device busy {busy:.3f} vs "
          f"{untextured['busy_ms']:.3f} ms; texture ranges {tex_ms:.3f} ms of the device "
          f"({100 * tex_ms / max(busy, 1e-9):.1f}%)")
    if not ranges.get("texture:sample", {}).get("calls"):
        fail("the textured frame did not sample the atlas")

    # The sampler on the card against the CPU, on frame 0's first-bounce
    # lanes (the primaries' hits): the same (tex_id, uv, lod) inputs.
    parts = [wavefront.sample_rays(cam, s_settings, 0, s_i, blue_noise) for s_i in range(s_settings.samples)]
    po = torch.cat([p_[0] for p_ in parts]).contiguous()
    pd = torch.cat([p_[1] for p_ in parts]).contiguous()
    del parts
    hit = primary(po, pd)
    lanes = hit.hit.nonzero()[:, 0]
    lanes = lanes[torch.arange(TEX_LANES, device=dev) * (lanes.shape[0] - 1) // (TEX_LANES - 1)]
    prim, bary, d, t = hit.prim_id[lanes], hit.uv[lanes], pd[lanes], hit.t[lanes]
    del po, pd, hit
    fp = wavefront.footprint_log2(tscene, prim, d, t, 0, s_settings)
    row = tscene.shade_table[prim.long()]
    w0, w1, w2 = (1.0 - bary[:, 0] - bary[:, 1])[:, None], bary[:, 0:1], bary[:, 1:2]
    tex_uv = row[:, 9:11] * w0 + row[:, 11:13] * w1 + row[:, 13:15] * w2
    mat = tscene.mat_table[row[:, 15].long()]
    tex_id, lod = mat[:, 8].to(torch.int32), fp + mat[:, 9]
    words, wmeta = tscene.tex_words, tscene.tex_meta
    card = textures.sample_atlas(words, aw, wmeta, tex_id, tex_uv, lod)
    host_args = [x.cpu() for x in (words, wmeta, tex_id, tex_uv, lod)]
    cpu = textures.sample_atlas(host_args[0], aw, *host_args[1:])
    rows = wmeta[tex_id.clamp_min(0).long()]
    levels = textures.mip_levels(rows, lod)
    taps_equal, n_taps = True, 0
    for level in levels[:2]:
        got = textures.level_taps(rows, tex_uv, level, rows[:, 5] > 0.5, aw)
        ref = textures.level_taps(rows.cpu(), host_args[3], level.cpu(), rows[:, 5].cpu() > 0.5, aw)
        for a, b in zip(got[0], ref[0]):
            taps_equal &= torch.equal(a.cpu(), b)
            n_taps += a.shape[0]
    card = card.cpu()
    rel = ((card - cpu).abs() / cpu.abs().clamp_min(1e-30)).max()
    within = bool(((card - cpu).abs() <= TEX_ATOL + TEX_RTOL * cpu.abs()).all())
    lv = levels[0].cpu()
    phase(f"sample_atlas card vs CPU on {TEX_LANES} of frame 0's first-bounce lanes (levels "
          f"{int(lv.min())}..{int(lv.max())}, mean {float(lv.float().mean()):.2f}): tap indices equal {taps_equal} "
          f"({n_taps} taps), colours bit-equal {same_bits(card, cpu)}, max relative difference {float(rel):.3g} "
          f"(tolerance rtol {TEX_RTOL:g} + atol {TEX_ATOL:g}: {within})")
    if not (taps_equal and within):
        fail("sample_atlas on the card disagrees with the CPU")
    rec["sampler_vs_cpu"] = dict(taps_equal=taps_equal, max_rel=float(rel), bit_equal=same_bits(card, cpu))
    del tscene, words, wmeta, card, cpu, row, mat
    torch.cuda.empty_cache()
    return {"sponza720_textured": rec}


def rounds_phase(tt, b_org, b_dir, bg, sh_o, sh_d, sh_t, sorted_kw, sub):
    """K3's rounds driver and ``nearest_first`` beside the production single
    pass on sponza720's bounce and shadow sets (hit masks within the oracle
    rule's limit, t by the oracle rule on the bounce), timed; the rounds
    driver against itself over K3's plain version on a subset. Returns the
    rounds driver's record."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.ops import treelets
    from raytracer3_tpu_torch.tools import perf_probe

    geo = segment_geo(tt)
    rec = None
    phase("K3 rounds driver and nearest_first against the production single pass (sponza720 sets):")
    for kind, name, co, cd, ct in (("closest", "sorted bounce", b_org, b_dir, bg),
                                   ("any", "NEE shadow t_max", sh_o, sh_d, sh_t)):
        any_hit = kind == "any"
        n = co.shape[0]
        single = treelets.treelet_intersect(tt, co, cd, t_max=ct, any_hit=any_hit, **sorted_kw)
        rnd, r_counts, n_rounds = treelets.treelet_intersect_rounds(tt, co, cd, t_max=ct, any_hit=any_hit,
                                                                   stats=True, return_rounds=True)
        nf = treelets.treelet_intersect(tt, co, cd, t_max=ct, any_hit=any_hit, nearest_first=True, **sorted_kw)
        torch.cuda.synchronize()
        for label, h in (("rounds", rnd), ("nearest_first", nf)):
            if any_hit:
                mism = int((h.hit != single.hit).sum())
                phase(f"  {label} vs single pass, {name}: n={n} hits={int(h.hit.sum())} mismatches={mism} "
                      f"(limit {max(2, n // 500)})")
                if mism > max(2, n // 500):
                    fail(f"K3 {label} disagrees with the single pass on {name}")
            else:
                judge(f"{label} vs single pass, {name}", h, single)
        full = perf_probe.visit_summary(r_counts, **geo)
        del single, rnd, nf, r_counts
        t_single = time_ms(lambda: treelets.treelet_intersect(tt, co, cd, t_max=ct, any_hit=any_hit, **sorted_kw), 2)
        t_rounds = time_ms(lambda: treelets.treelet_intersect_rounds(tt, co, cd, t_max=ct, any_hit=any_hit), 2)
        t_nf = time_ms(lambda: treelets.treelet_intersect(tt, co, cd, t_max=ct, any_hit=any_hit, nearest_first=True,
                                                          **sorted_kw), 2)
        phase(f"  time {name} ({n} rays): single pass {t_single:.3f} ms, rounds {t_rounds:.3f} ms "
              f"({n_rounds} rounds), nearest_first {t_nf:.3f} ms (driver and kernels, CUDA events)")
        phase(f"    rounds, whole set {perf_probe.summary_line(full)}")
        if rec is None:
            ns = min(K3_SUBSET, n)
            so, sd, st = sub(co, ns), sub(cd, ns), sub(ct, ns)
            got, s_counts = treelets.treelet_intersect_rounds(tt, so, sd, t_max=st, stats=True)
            ref = treelets.treelet_intersect_rounds(tt, so, sd, t_max=st,
                                                    segment_fn=tk.packet_intersect_segments_plain)
            _, err = judge(f"rounds over K3 vs over K3's plain version, {name}", got, ref)
            ms = time_ms(lambda: treelets.treelet_intersect_rounds(tt, so, sd, t_max=st), 5)
            plain_ms = time_ms(lambda: treelets.treelet_intersect_rounds(
                tt, so, sd, t_max=st, segment_fn=tk.packet_intersect_segments_plain), 1)
            phase(f"    rounds on {ns} rays: {ms:.3f} ms over K3, {plain_ms:.3f} ms over its plain version")
            rec = dict(n=ns, n_full=n, ms=ms, plain_ms=plain_ms, full_ms=t_rounds, max_abs_err=err,
                       sub=perf_probe.visit_summary(s_counts, **geo), full=full)
    return rec


def instanced_world(detail: int, cache_dir: str):
    """The instanced atrium through the user's path: the atrium split into a
    shell mesh (every triangle but the columns', skylight included) and one
    column mesh at the origin (the atrium's cylinder tessellation + capital
    and base boxes), each written as a GLB and read through the asset cache
    into a ``World``; the shell spawned once, the column at the atrium's 14
    column positions with a yaw of 0.3·k rad each. Returns (world, column
    entities, (shell, column) triangle counts)."""
    from raytracer3_tpu_torch.app import world as world_mod
    from raytracer3_tpu_torch.scene import assets, gltf, procedural

    shell, column, transforms = procedural.instanced_atrium(detail, INSTANCED["yaw_step"])
    w = world_mod.World()
    handles = []
    os.makedirs(cache_dir, exist_ok=True)
    for name, m in (("shell", shell), ("column", column)):
        path = os.path.join(cache_dir, f"instanced_{name}_d{detail}.glb")
        gltf.write_glb_multi(path, m["positions"], m["normals"], m["uvs"], m["indices"], m["geo_id"],
                             m["base_color"], m["emission"], m["metallic"], m["roughness"])
        handles.append(w.add_mesh_data(assets.load_glb_cached(path, cache_dir=cache_dir)))
    w.spawn(handles[0], name="shell")
    cols = [w.spawn(handles[1], transform=t, name=f"column{k}") for k, t in enumerate(transforms)]
    w.env_map = procedural.sky_equirect(256, 512)
    return w, cols, (len(shell["indices"]), len(column["indices"]))


def instanced_phases(dev, blue_noise, settings, cam, card):
    """instanced720: build, K4 against its plain version, K4 against K3 on
    the flattened world, the timed and profiled frame, the film against the
    flattened film, and a transform edit. Returns K4's records."""
    from raytracer3_tpu_torch.bench import frames_line, frames_run
    import torch

    from raytracer3_tpu_torch.ops import rng, tlas as tlas_mod, treelets, traverse_kernel as tk
    from raytracer3_tpu_torch.render import wavefront
    from raytracer3_tpu_torch.scene import procedural, types as scene_types

    # --- 12. build ----------------------------------------------------------
    t0 = time.perf_counter()
    iw, cols, (n_shell, n_col) = instanced_world(INSTANCED["detail"], os.path.join(REPO, "build", "assets"))
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    i_scene = iw.scene_instanced(device=dev)
    t_iscene = time.perf_counter() - t0
    t0 = time.perf_counter()
    ib = iw.tlas_backend(device=dev)
    torch.cuda.synchronize()
    t_two = time.perf_counter() - t0
    pt4, tl = ib.meta
    mids, meshes = iw._mesh_list()
    t0 = time.perf_counter()
    for m in meshes:
        pos, idx = m["positions"], m["indices"]
        tlas_mod.build_mesh_blas(pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]])
    t_blas = time.perf_counter() - t0
    t0 = time.perf_counter()
    tlas_mod.build_two_level(meshes, iw._instance_list(mids), blas_cache=iw._blas_cache)
    t_tlas_only = time.perf_counter() - t0
    two_bytes = nbytes(pt4.node_table, pt4.cluster_table, pt4.inst_table)
    t0 = time.perf_counter()
    f_scene = iw.scene(device=dev)
    fb = tk.packet_backend(host_tris=iw._host_tris(), device=dev)
    t_flat = time.perf_counter() - t0
    if not (fb.self_sorting and isinstance(fb.meta, treelets.TreeletTables)):
        fail("packet_backend did not route the flattened instanced world to the treelet backend")
    ft = fb.meta._replace(node_tables=fb.arrays["nodes"], cluster_tables=fb.arrays["clusters"],
                          aabb=fb.arrays["aabb"])
    flat_bytes = nbytes(ft.node_tables, ft.cluster_tables, ft.aabb)
    n_tris = n_shell + INSTANCED["columns"] * n_col
    phase(f"instanced scene: shell {n_shell} tris x1 + column {n_col} tris x{INSTANCED['columns']} = {n_tris} "
          f"tris through GLB -> asset cache -> World in {t_ingest:.2f} s; scene_instanced {t_iscene:.2f} s; "
          f"tlas_backend from scratch {t_two:.2f} s: the 2 BLAS builds {t_blas:.2f} s, the TLAS and tables over "
          f"cached BLASes {t_tlas_only:.3f} s, the rest upload; TLAS {tl.tlas_nodes} rows (depth {tl.depth} with the BLAS), {tl.num_nodes} node rows, "
          f"{tl.num_clusters} clusters, {tl.inst_table.shape[0]} instances = {two_bytes / 1e6:.2f} MB; flattened "
          f"World.scene() + packet_backend -> {ft.num_treelets} treelets {flat_bytes / 1e6:.2f} MB in {t_flat:.2f} s "
          f"(two-level / flattened {two_bytes / flat_bytes:.3f})")
    phase("  " + stack_line("instanced two-level tables (marker included)", pt4))
    if int(f_scene.emissive.count) != int(i_scene.emissive.count) or int(i_scene.emissive.count) == 0:
        fail("the instanced and flattened light lists differ")

    # --- 13. K4 against its plain version at instanced720's shapes ---------
    sw, shh, spp = settings.width, settings.height, settings.samples
    parts = [wavefront.sample_rays(cam, settings, 0, s_i, blue_noise) for s_i in range(spp)]
    po = torch.cat([p_[0] for p_ in parts]).contiguous()
    pd = torch.cat([p_[1] for p_ in parts]).contiguous()
    psampler = rng.Sampler(seed=torch.cat([p_[2].seed for p_ in parts]), index=parts[0][2].index)
    del parts
    prim4 = tk.packet_intersect(pt4, po, pd)
    sh_o, sh_d, sh_t, pre_ok, b_org, b_dir, alive = bounce_population(i_scene, po, pd, prim4, psampler, settings)
    bounds = (i_scene.positions.amin(0), i_scene.positions.amax(0))
    perm = torch.argsort(wavefront.sort_key_pos_dir(b_org, b_dir, alive, bounds), stable=True)
    sb_o, sb_d = b_org[perm].contiguous(), b_dir[perm].contiguous()
    n_alive = int(alive.sum())
    sperm = torch.argsort(wavefront.sort_key_pos_dir(sh_o, sh_d, pre_ok, bounds), stable=True)
    ss_o, ss_d, ss_t = sh_o[sperm].contiguous(), sh_d[sperm].contiguous(), sh_t[sperm].contiguous()
    n_shadow = int(pre_ok.sum())
    # The frame's tail launch: the last bounce's shadow batch and its escape
    # probes, any hit, in the frame's lane order (as the frame launches it)
    # and coherence-sorted (wavefront.sorted_occlusion, the alternative).
    tail_o, tail_d = torch.cat([sh_o, b_org]), torch.cat([sh_d, b_dir])
    tail_t, tail_live = torch.cat([sh_t, torch.full_like(sh_t, tk._BG)]), torch.cat([pre_ok, alive])
    tperm = torch.argsort(wavefront.sort_key_pos_dir(tail_o, tail_d, tail_live, bounds), stable=True)
    st_o, st_d, st_t = tail_o[tperm].contiguous(), tail_d[tperm].contiguous(), tail_t[tperm].contiguous()
    park_o = torch.full((1024, 3), 1e30, device=dev)
    park_d = torch.nn.functional.normalize(
        torch.randn(1024, 3, device=dev, generator=torch.Generator(dev).manual_seed(1)), dim=-1)
    park_t = torch.zeros(1024, device=dev)

    phase(f"K4 vs plain at instanced720 shapes ({sw}x{shh}x{spp} spp = {po.shape[0]} lanes; primaries hit "
          f"{int(prim4.hit.sum())}, bounce {n_alive} alive, shadow {n_shadow} traced; evenly spaced subsets of "
          f"{K3_SUBSET} rays):")
    k4 = {"closest": {"max_abs_err": 0.0, "cases": [], "k5": [], "loops": []},
          "any": {"max_abs_err": 0.0, "cases": [], "k5": [], "loops": []}}
    bg = tk._BG
    if tk.trace_loop(pt4.width, pt4.leaf_size, two_level=True, stack_need=tk.stack_depth(pt4)) != "walk":
        fail("instanced720's two-level tables do not take the walk kernels")
    for kind, name, co, cd, ct in (
        ("closest", "tiled primaries", po, pd, bg),
        ("closest", "sorted bounce", sb_o[:n_alive], sb_d[:n_alive], bg),
        ("any", "NEE shadow t_max", ss_o[:n_shadow], ss_d[:n_shadow], ss_t[:n_shadow]),
        ("any", "tail shadow+escape (unsorted)", tail_o, tail_d, tail_t),
        ("any", "tail shadow+escape (sorted)", st_o, st_d, st_t),
        ("closest", "parked", park_o, park_d, park_t),
        ("any", "parked", park_o, park_d, park_t),
    ):
        n = min(K3_SUBSET, co.shape[0])
        so, sd = sub(co, n), sub(cd, n)
        st = sub(ct, n) if isinstance(ct, torch.Tensor) else ct
        any_hit = kind == "any"
        got = tk.packet_intersect(pt4, so, sd, t_max=st, any_hit=any_hit)
        ref = tk.packet_intersect_plain(pt4, so, sd, t_max=st, any_hit=any_hit)
        torch.cuda.synchronize()
        if any_hit:
            mism = int((got.hit != ref.hit).sum())
            err = float((got.hit.float() - ref.hit.float()).abs().max())
            phase(f"  K4 any {name}: n={n} hits={int(got.hit.sum())} mismatches={mism} (limit {max(2, n // 500)})")
            if mism > max(2, n // 500):
                fail(f"K4 any-hit disagrees with its plain version on {name}")
        else:
            _, err = judge(f"K4 closest {name}", got, ref)
            m = got.hit & ref.hit
            same = m & (got.prim_id == ref.prim_id) & (got.inst == ref.inst)
            inst_off = m & (got.inst != ref.inst) & (got.t != ref.t)
            phase(f"    same (prim, inst) on {int(same.sum())}/{int(m.sum())} mutual hits; instance differs off an "
                  f"exact-t tie on {int(inst_off.sum())}; misses with inst -1: {bool((got.inst[~got.hit] == -1).all())}")
            if int(inst_off.sum()) or not bool((got.inst[~got.hit] == -1).all()):
                fail(f"K4 instance ids disagree with its plain version on {name}")
        if name == "parked" and bool(got.hit.any()):
            fail(f"a parked ray hit (K4 {kind})")
        full = time_ms(lambda: tk.packet_intersect(pt4, co, cd, t_max=ct, any_hit=any_hit), 5)
        k_ms = time_ms(lambda: tk.packet_intersect(pt4, so, sd, t_max=st, any_hit=any_hit), 10)
        p_ms = time_ms(lambda: tk.packet_intersect_plain(pt4, so, sd, t_max=st, any_hit=any_hit), 1)
        phase(f"    time K4 {kind} {name}: kernel {k_ms:.4f} ms vs plain {p_ms:.3f} ms on {n} rays; kernel on all "
              f"{co.shape[0]} rays {full:.4f} ms ({co.shape[0] / full / 1e3:.1f} Mray/s)")
        rec = k4[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append((name, n, k_ms, p_ms, co.shape[0], full))
        rec["k5"].append(None if name == "parked" else k5_packet(
            pt4, f"K4 {kind} {name}", any_hit, (so, sd, st), (co, cd, ct), 20))
        loops = None
        if name != "parked":
            walk = tk.packet_intersect(pt4, co, cd, t_max=ct, any_hit=any_hit)
            same = same_bits(walk, general_packet(pt4, co, cd, ct, any_hit))
            del walk
            g_full = time_ms(lambda: general_packet(pt4, co, cd, ct, any_hit), 5)
            loops = dict(general_ms=time_ms(lambda: general_packet(pt4, so, sd, st, any_hit), 10),
                         full_general_ms=g_full)
            loops_line(f"K4 {kind} {name}", same, full, g_full, rec["k5"][-1]["full"])
        rec["loops"].append(loops)
    tail_sort = tail_sort_line(ib.occluded, tail_o, tail_d, tail_t, tail_live, bounds)
    del prim4, sh_o, sh_d, sh_t, pre_ok, ss_o, ss_d, ss_t, perm, sperm, tail_o, tail_d, tail_t, tail_live, tperm
    del st_o, st_d, st_t

    # --- 14. instanced (K4) against flattened (K3) on the same rays ----------
    n_b = b_org.shape[0]
    hi_ = ib.intersect(b_org, b_dir)
    hf_ = fb.intersect(b_org, b_dir)
    torch.cuda.synchronize()
    live = alive
    both = hi_.hit & hf_.hit & live
    hit_off = (hi_.hit != hf_.hit) & live
    t_off = both & ((hi_.t - hf_.t).abs() > 1e-5 + 1e-4 * hf_.t.abs())
    parted = hit_off | t_off
    n_live = int(live.sum())
    phase(f"instanced (K4) vs flattened (K3) on the {n_live} live bounce rays of {n_b}: hit-mask agreement "
          f"{1 - int(hit_off.sum()) / max(n_live, 1):.7f} ({int(hit_off.sum())} differ), t beyond rtol 1e-4 on "
          f"{int(t_off.sum())} of {int(both.sum())} mutual hits; parted {int(parted.sum())} "
          f"(limit {max(2, n_live // 500)})")
    # Why they part: the two trees hold the same triangles in two spaces
    # (object space behind a 3x4 vs baked world space), so rounding differs
    # in the last bits. That decides (1) whether a ray leaving a surface
    # re-hits it just past t_min, (2) hits at a triangle edge, (3) exact-t
    # ties, and (4) at a shallow angle to the hit face small rounding moves t.
    uv_i = torch.stack([hi_.uv[:, 0], hi_.uv[:, 1], 1 - hi_.uv[:, 0] - hi_.uv[:, 1]], 1).amin(1)
    uv_f = torch.stack([hf_.uv[:, 0], hf_.uv[:, 1], 1 - hf_.uv[:, 0] - hf_.uv[:, 1]], 1).amin(1)
    n_geo = scene_types.geometric_normals(f_scene, hf_.prim_id)
    cos_f = (n_geo * b_dir).sum(1).abs()
    near_tmin = parted & (torch.minimum(hi_.t, hf_.t) < 1e-3)
    edge = parted & ~near_tmin & (torch.minimum(uv_i, uv_f) < 1e-4)
    tie = parted & ~near_tmin & ~edge & (hi_.t == hf_.t)
    shallow = parted & ~near_tmin & ~edge & ~tie & (cos_f < 0.05)
    other = parted & ~(near_tmin | edge | tie | shallow)
    phase(f"  why: re-hit of the surface the ray leaves, t < 1e-3 {int(near_tmin.sum())}; at a triangle edge "
          f"(barycentric < 1e-4) {int(edge.sum())}; exact-t tie {int(tie.sum())}; shallow angle "
          f"(|cos| < 0.05 to the hit face) {int(shallow.sum())}; other {int(other.sum())}")
    for label, mask in (("other", other), ("shallow", shallow), ("edge", edge), ("near t_min", near_tmin)):
        for i in torch.nonzero(mask).squeeze(1)[:2].tolist():
            phase(f"  parted ray {i} ({label}): instanced hit={bool(hi_.hit[i])} t={float(hi_.t[i]):.7g} "
                  f"inst={int(hi_.inst[i])} uv=({float(hi_.uv[i, 0]):.3g},{float(hi_.uv[i, 1]):.3g}); flattened "
                  f"hit={bool(hf_.hit[i])} t={float(hf_.t[i]):.7g} uv=({float(hf_.uv[i, 0]):.3g},"
                  f"{float(hf_.uv[i, 1]):.3g}), |cos| {float(cos_f[i]):.3g}")
    if int(parted.sum()) > max(2, n_live // 500):
        fail("the instanced and flattened worlds part on too many bounce rays")
    del hi_, hf_, both, hit_off, t_off, parted, b_org, b_dir, sb_o, sb_d, po, pd, alive, live, n_geo, cos_f
    torch.cuda.empty_cache()

    # --- 15. the instanced720 frame through the user entry points ------------
    isect_i, occl_i = ib.bind(ib.arrays)
    i_rec = frames_run("instanced720", lambda fi: wavefront.render_frame(
        i_scene, cam, settings, fi, isect_i, occl_i, sort_rays=True, blue_noise=blue_noise, return_stats=True),
        INSTANCED_TIMED_FRAMES, {"tlas_closest": 2, "tlas_any": 2}, dev)
    i_rec.pop("radiance0")
    phase(frames_line("instanced720", i_rec, settings))
    launches, frames = i_rec["launches"], INSTANCED_TIMED_FRAMES + 1
    profile_frame(lambda: wavefront.render_frame(i_scene, cam, settings, frames, isect_i, occl_i, sort_rays=True,
                                                 blue_noise=blue_noise),
                  ("tlas_kernel", "tlas_walk_kernel", "tlas_walk_any_kernel"), "instanced720")

    # The instanced film against the flattened World's film: same camera,
    # same RNG counters, 2 frames each.
    isect_f, occl_f = fb.bind(fb.arrays)
    prim_f = fb.bind_primary(fb.arrays)
    img_i = torch.zeros((shh, sw, 3), device=dev)
    img_f = torch.zeros((shh, sw, 3), device=dev)
    for i in range(2):
        img_i += wavefront.render_frame(i_scene, cam, settings, i, isect_i, occl_i, sort_rays=True,
                                        blue_noise=blue_noise)
        img_f += wavefront.render_frame(f_scene, cam, settings, i, isect_f, occl_f, sort_rays=not fb.self_sorting,
                                        blue_noise=blue_noise, primary_fn=prim_f)
    img_i, img_f = (img_i / 2).cpu().numpy(), (img_f / 2).cpu().numpy()
    if not (np.isfinite(img_i).all() and np.isfinite(img_f).all()):
        fail("instanced or flattened film not finite")
    mean_rel = abs(float(img_i.mean()) - float(img_f.mean())) / max(float(img_f.mean()), 1e-6)
    lit = (img_f.max(-1) > 0.05) & (img_i.max(-1) > 0.05)
    px_rel = float(np.abs(img_i[lit] - img_f[lit]).mean() / img_f[lit].mean())
    diff = np.abs(img_i - img_f)
    golden_rel = float(diff.sum() / np.abs(img_f).sum())
    share = float((diff.max(-1) <= 1e-3).mean())
    phase(f"instanced vs flattened film (2 frames x {spp} spp): mean relative difference {mean_rel:.3g} (limit 0.05), "
          f"lit-pixel relative difference {px_rel:.3g} over {int(lit.sum())} lit pixels (limit 0.35); "
          f"sum|diff|/sum|flat| {golden_rel:.3g}, pixels within 1e-3 {share:.4f}")
    if not (mean_rel < 0.05 and lit.sum() > 0.5 * lit.size and px_rel < 0.35):
        fail("the instanced film disagrees with the flattened film")
    del img_i, img_f, fb, f_scene, isect_f, occl_f, prim_f
    torch.cuda.empty_cache()

    # --- 16. transform edit: rebuild the TLAS and the small tables only ------
    clusters_before, shade_before = ib.arrays["clusters"], i_scene.shade_table
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iw.set_transform(cols[3], procedural.yawed(-1.5, -2.2, 1.1))
    i_scene2 = iw.scene_instanced(device=dev)
    ib2 = iw.tlas_backend(device=dev)
    torch.cuda.synchronize()
    rebind_ms = (time.perf_counter() - t0) * 1e3
    same_objects = ib2.arrays["clusters"] is clusters_before and i_scene2.shade_table is shade_before
    same_ptr = (ib2.arrays["clusters"].data_ptr() == clusters_before.data_ptr()
                and i_scene2.shade_table.data_ptr() == shade_before.data_ptr())
    moved = not torch.equal(ib2.arrays["insts"], ib.arrays["insts"])
    isect2, occl2 = ib2.bind(ib2.arrays)
    img = wavefront.render_frame(i_scene2, cam, settings, 0, isect2, occl2, sort_rays=True, blue_noise=blue_noise)
    torch.cuda.synchronize()
    finite = bool(img.isfinite().all())
    phase(f"transform edit (column 3 moved and turned): scene_instanced + tlas_backend {rebind_ms:.1f} ms; cluster "
          f"table and shade_table the same objects {same_objects}, same data_ptr {same_ptr}; instance table changed "
          f"{moved}; re-rendered frame finite {finite}, mean {float(img.mean()):.4f}")
    if not (same_objects and same_ptr and moved and finite):
        fail("the transform edit did not rebind in place")
    return dict(k4, launches=launches, table_bytes=two_bytes, shape=(pt4.width, pt4.leaf_size), tail_sort=tail_sort)


def tail_sort_line(occluded, o, d, t, live, bounds):
    """The frame's tail any-hit launch coherence-sorted
    (``wavefront.sorted_occlusion``) against the same launch in the frame's
    order, as the frame traces it: hit bits equal, and the times of the
    sort with its gathers (and of its parts: key, argsort, gather in,
    scatter out), of the sorted launch, of the two together and of the
    unsorted launch, each timed on its own in this run."""
    import torch

    from raytracer3_tpu_torch.render import wavefront

    unsorted = occluded(o, d, t)
    got = wavefront.sorted_occlusion(occluded, o, d, t, live, bounds)
    torch.cuda.synchronize()
    same = torch.equal(got, unsorted)
    key = wavefront.sort_key_pos_dir(o, d, live, bounds)
    perm = torch.argsort(key, stable=True)
    packed = torch.cat([o, d, t[:, None]], dim=1)[perm]
    so, sd, st = packed[:, 0:3].contiguous(), packed[:, 3:6].contiguous(), packed[:, 6].contiguous()

    def sort_and_gathers():
        p_ = torch.argsort(wavefront.sort_key_pos_dir(o, d, live, bounds), stable=True)
        pk = torch.cat([o, d, t[:, None]], dim=1)[p_]
        out = torch.empty_like(unsorted)
        out[p_] = unsorted
        return pk, out

    def scatter_out():
        out = torch.empty_like(unsorted)
        out[perm] = unsorted
        return out

    parts = dict(key_ms=time_ms(lambda: wavefront.sort_key_pos_dir(o, d, live, bounds), 5),
                 argsort_ms=time_ms(lambda: torch.argsort(key, stable=True), 5),
                 gather_ms=time_ms(lambda: torch.cat([o, d, t[:, None]], dim=1)[perm], 5),
                 scatter_ms=time_ms(scatter_out, 5))
    sort_ms = time_ms(sort_and_gathers, 5)
    sorted_launch_ms = time_ms(lambda: occluded(so, sd, st), 5)
    together_ms = time_ms(lambda: wavefront.sorted_occlusion(occluded, o, d, t, live, bounds), 5)
    unsorted_ms = time_ms(lambda: occluded(o, d, t), 5)
    phase(f"tail sort, instanced720 tail ({o.shape[0]} lanes, K4 any): sort + gathers {sort_ms:.4f} ms ("
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in parts.items()) + f"), sorted launch {sorted_launch_ms:.4f} ms, "
          f"sorted_occlusion end to end {together_ms:.4f} ms vs unsorted launch {unsorted_ms:.4f} ms "
          f"(sorting pays {unsorted_ms / together_ms:.2f}x; the frame traces the tail unsorted); hit bits equal {same}")
    if not same:
        fail("the sorted tail launch answers other hit bits than the unsorted one")
    return dict(rays=o.shape[0], sort_ms=sort_ms, sorted_launch_ms=sorted_launch_ms, together_ms=together_ms,
                unsorted_ms=unsorted_ms, **parts)


def film_diff(a, b) -> dict:
    """Two [H, W, 3] films: bit-equal?, pixels that differ, their max |diff|."""
    d = (a - b).abs().amax(-1)
    return dict(same=same_bits(a, b), pixels=int((d > 0).sum()), max_diff=float(d.max()))


def sponza_variants(big, big_scene, cam, s_settings, blue_noise, diet_rad0, dev):
    """sponza720's options beside bench.py's frame (lane diet on, whose
    frame 0 is ``diet_rad0``): frame 0 with the diet off held to the
    reference test's bound; the fused shadow+bounce launch through K3's
    mixed-hit shape and the tail-off path, each against the diet-off split
    film (diet off on both sides: the diet rounds at other points on the
    fused path); one 32-spp frame with the diet, bench.py's ladder top at
    720p. Returns the paths' records."""
    from raytracer3_tpu_torch.bench import frames_line, frames_run
    import dataclasses

    from raytracer3_tpu_torch.render import wavefront

    isect, occl = big.bind(big.arrays)
    primary, capped = big.bind_primary(big.arrays), big.bind_capped(big.arrays)

    def render_with(settings, **kw):
        return lambda fi: wavefront.render_frame(
            big_scene, cam, settings, fi, isect, occl, sort_rays=not big.self_sorting, blue_noise=blue_noise,
            return_stats=True, primary_fn=primary, **kw)

    off = dataclasses.replace(s_settings, lane_diet=False)
    rec = {}
    rec["sponza720_diet_off"] = frames_run("sponza720 at 16 spp, diet off", render_with(off), 1,
                                           {"seg_closest": 2, "seg_any": 2}, dev)
    phase(frames_line("sponza720 at 16 spp, diet off", rec["sponza720_diet_off"], off))
    split0 = rec["sponza720_diet_off"].pop("radiance0")
    bad = int(((diet_rad0 - split0).abs() > 2e-3 + 0.02 * split0.abs()).sum())
    dd = film_diff(diet_rad0, split0)
    phase(f"sponza720 at 16 spp, frame 0, lane diet on vs off: values beyond rtol 0.02 + atol 2e-3 {bad} (limit 0; "
          f"tests/test_wavefront.py TestLaneDiet), pixels differing {dd['pixels']}, max |diff| {dd['max_diff']:.4g}")
    if bad:
        fail("the lane diet's film is beyond the reference's bound of the default film")
    del diet_rad0

    n_px = off.width * off.height
    fused = dataclasses.replace(off, fuse_shadow=True)
    rec["sponza720_fused"] = frames_run("sponza720 at 16 spp, fused", render_with(fused, fused_fn=capped), 2,
                                        {"seg_closest": 2, "seg_any": 1}, dev)
    phase(frames_line("sponza720 at 16 spp, fused", rec["sponza720_fused"], fused))
    rec["sponza720_tail_off"] = frames_run("sponza720 at 16 spp, tail_anyhit=False", render_with(off, tail_anyhit=False), 2,
                                           {"seg_closest": 3, "seg_any": 2}, dev)
    phase(frames_line("sponza720 at 16 spp, tail_anyhit=False", rec["sponza720_tail_off"], off))
    for key, what in (("sponza720_fused", "fused (K3 mixed, one 29.5M-lane launch per non-tail bounce)"),
                      ("sponza720_tail_off", "tail_anyhit=False")):
        dd = film_diff(rec[key].pop("radiance0"), split0)
        rec[key]["film_vs_split"] = dd
        phase(f"sponza720 at 16 spp, frame 0, {what} vs the split path: bit-equal {dd['same']}, pixels differing "
              f"{dd['pixels']} of {n_px} (limit {n_px // 500}), max |diff| {dd['max_diff']:.4g}")
        if dd["pixels"] > n_px // 500:
            fail(f"sponza720 {what} parts from the split path on too many pixels")
    del split0

    s32 = dataclasses.replace(s_settings, samples=32)
    rec["sponza720_32spp"] = frames_run("sponza720 at 32 spp", render_with(s32), 0,
                                        {"seg_closest": 2, "seg_any": 2}, dev)
    rec["sponza720_32spp"].pop("radiance0")
    phase(frames_line("sponza720 at 32 spp (bench.py's sponza720, the ladder's top rung), one frame", rec["sponza720_32spp"], s32))
    return rec


def sponza1080_phase(backend, big_scene, blue_noise, dev, label="sponza1080",
                     per_frame=(("seg_closest", 4), ("seg_any", 4)), keys=K3_KEYS, timed=SPONZA1080_TIMED_FRAMES):
    """bench.py's sponza1080 (``bench.py:451-459``): 1920×1088, 4 bounces,
    16 spp in one wavefront of 33,423,360 lanes, lane diet on, through
    ``backend`` (the treelet backend's K3 unless given another): one
    warm-up and ``timed`` frames, then a profiled frame. Returns the
    record."""
    from raytracer3_tpu_torch.bench import frames_line, frames_run
    from raytracer3_tpu_torch.render import wavefront
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    s = RenderSettings(width=SPONZA1080["width"], height=SPONZA1080["height"], bounces=SPONZA1080["bounces"],
                       samples=SPONZA1080["samples"], sample_batch=True, radiance_clamp=50.0, lane_diet=True)
    cam = procedural.atrium_camera(aspect=s.width / s.height, device=dev)
    isect, occl = backend.bind(backend.arrays)
    primary = backend.bind_primary(backend.arrays)

    def render(fi, stats=True):
        return wavefront.render_frame(big_scene, cam, s, fi, isect, occl, sort_rays=not backend.self_sorting,
                                      blue_noise=blue_noise, return_stats=stats, primary_fn=primary)

    rec = frames_run(label, render, timed, dict(per_frame), dev)
    rec.pop("radiance0")
    phase(frames_line(f"{label} ({s.width * s.height * s.samples} lanes)", rec, s))
    busy, trav, n_sync = profile_frame(lambda: render(timed + 1, stats=False), keys, label)
    rec.update(busy_ms=busy, traversal_ms=trav, stream_syncs=n_sync)
    return rec


def route_phase(one, big_scene, s_settings, cam720, blue_noise, dev):
    """The 300k atrium's routing question (ROADMAP M8b) on frames: sponza720
    (1 warm-up + 2 frames) and sponza1080 (1 + 1) through K1/K2 over one
    whole-scene table ``one`` (leaf 12, the route ``packet_backend`` takes
    below ``TREELET_ROUTE_BYTES``), beside the treelet route's frames of the
    same call. Returns the records."""
    from raytracer3_tpu_torch.bench import frames_line, frames_run
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.ops.backend import TraceBackend
    from raytracer3_tpu_torch.render import wavefront

    table = TraceBackend(
        {}, lambda a, o, d: tk.packet_intersect(one, o.contiguous(), d.contiguous()),
        lambda a, o, d, t: tk.packet_intersect(one, o.contiguous(), d.contiguous(), t_max=t.contiguous(),
                                               any_hit=True).hit)
    isect, occl = table.bind(table.arrays)
    rec = {"sponza720 one table": frames_run(
        "sponza720 at 16 spp through one table (K1/K2)", lambda fi: wavefront.render_frame(
            big_scene, cam720, s_settings, fi, isect, occl, sort_rays=True, blue_noise=blue_noise,
            return_stats=True), 2, {"closest": 2, "any": 2}, dev)}
    rec["sponza720 one table"].pop("radiance0")
    phase(frames_line("sponza720 at 16 spp through one table (K1/K2)", rec["sponza720 one table"], s_settings))
    rec["sponza1080 one table"] = sponza1080_phase(table, big_scene, blue_noise, dev,
                                                   label="sponza1080 through one table (K1/K2)",
                                                   per_frame=(("closest", 4), ("any", 4)), keys=K12_KEYS, timed=1)
    return rec


def oracle_phases(scene, backend, dev):
    """The ground-truth oracles (``resources/oracle_atrium_*.npz``,
    high-spp reference-mode renders of the headline's atrium) against the
    port's wavefront through K1/K2 (``packet_backend``), with the bounds of
    ``tests/test_ground_truth.py``: AgX display (look "punchy") in 4×4 block
    means. Then probe_gi and hybrid_gi on the 192×108 oracle at spacing 12,
    8×8 texels, 8 frames, against its loose sanity bounds. Returns the
    paths' records."""
    import torch

    from raytracer3_tpu_torch.ops import tonemap, traverse_kernel as tk
    from raytracer3_tpu_torch.render import pipelines, wavefront
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    def blocks(disp):
        h, w = disp.shape[0] // 4, disp.shape[1] // 4
        return disp[: h * 4, : w * 4].reshape(h, 4, w, 4, 3).mean(dim=(1, 3)).cpu().numpy()

    isect, occl = backend.bind(backend.arrays)
    rec = {}
    v1_ref = None
    for name, n_frames, mean_tol, p99_tol in ORACLES:
        z = np.load(os.path.join(REPO, "resources", name))
        oracle, bounces = z["radiance"], int(z["bounces"])
        camera = str(z["camera"]) if "camera" in z.files else "default"
        if int(z["detail"]) != 2:
            fail(f"{name}: the oracle is of atrium detail {int(z['detail'])}, the headline scene is detail 2")
        h, w = oracle.shape[:2]
        cam_fn = procedural.atrium_camera_ggx if camera.startswith("ggx") else procedural.atrium_camera
        cam = cam_fn(aspect=w / h, device=dev)
        s = RenderSettings(width=w, height=h, bounces=bounces, samples=4, radiance_clamp=50.0)
        for k in tk.LAUNCHES:
            tk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        total = torch.zeros((h, w, 3), dtype=torch.float64, device=dev)
        for i in range(n_frames):
            total += wavefront.render_frame(scene, cam, s, i, isect, occl, sort_rays=True).double()
        img = (total / n_frames).to(torch.float32)
        launches = {k: v for k, v in tk.LAUNCHES.items() if v}
        per_frame = s.samples * bounces
        if launches != {"closest": per_frame * n_frames, "any": per_frame * n_frames}:
            fail(f"{name}: expected {per_frame} K1 and {per_frame} K2 walk launches per frame, got {launches}")
        ref_blocks = blocks(tonemap.agx_tonemap(torch.as_tensor(oracle, device=dev), look="punchy"))
        diff = np.abs(blocks(tonemap.agx_tonemap(img, look="punchy")) - ref_blocks)
        mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
        phase(f"oracle {name} ({w}x{h}, {bounces} bounces, {n_frames} frames x {s.samples} spp = "
              f"{n_frames * s.samples} spp against {int(z['spp'])}) through K1/K2: mean block diff {mean:.4f} "
              f"(limit {mean_tol}), p99 {p99:.4f} (limit {p99_tol}); launches {launches}; "
              f"{time.perf_counter() - t0:.1f} s")
        if not (mean < mean_tol and p99 < p99_tol):
            fail(f"the wavefront through K1/K2 is beyond the oracle's bounds on {name}")
        rec[f"oracle {name}"] = dict(mean=mean, p99=p99, launches=launches)
        if v1_ref is None:
            v1_ref = (name, ref_blocks, w, h, procedural.atrium_camera(aspect=w / h, device=dev))

    name, ref_blocks, w, h, cam = v1_ref
    ps = RenderSettings(width=w, height=h, bounces=1, samples=1, probe_spacing=12, probe_res=8)
    for label, make, per_frame in (("probe_gi", pipelines.probe_gi_pipeline, {"closest": 2, "any": 1}),
                                   ("hybrid_gi", pipelines.hybrid_gi_pipeline, {"closest": 2, "any": 2})):
        step, init_state = make(scene, ps, backend=backend, device=dev)
        state = init_state()
        for k in tk.LAUNCHES:
            tk.LAUNCHES[k] = 0
        for i in range(8):
            disp, state = step(state, cam, i)
        launches = {k: v for k, v in tk.LAUNCHES.items() if v}
        if launches != {k: 8 * v for k, v in per_frame.items()}:
            fail(f"{label} on the oracle: expected {per_frame} launches per frame, got {launches}")
        a = blocks(disp)
        mean, bright, ref_bright = float(np.abs(a - ref_blocks).mean()), float(a.mean()), float(ref_blocks.mean())
        phase(f"oracle {name}, {label} (spacing 12, 8x8 texels, 8 frames) through K1/K2: mean block diff "
              f"{mean:.4f} (limit 0.25), brightness {bright:.4f} vs the oracle's {ref_bright:.4f} (off by "
              f"{abs(bright - ref_bright) / ref_bright:.3f}, limit 0.45)")
        if not (mean < 0.25 and abs(bright - ref_bright) < 0.45 * max(ref_bright, 1e-6)):
            fail(f"{label} is beyond the oracle's sanity bounds")
        rec[f"oracle {label}"] = dict(mean=mean, brightness=bright, launches=launches)
    return rec


def denoise_phase(scene, backend, settings, cam, blue_noise, dev):
    """The headline through ``wavefront_pipeline`` with and without the
    à-trous denoiser (``denoise=True``), each timed (``pipeline_phase``),
    and frame 0's displays held apart: both finite, the denoised one not the
    plain one. Returns the two records."""
    import functools

    import torch

    from raytracer3_tpu_torch.render import pipelines

    keys = K12_KEYS
    per_frame = {"closest": settings.bounces, "any": settings.bounces}
    rec, shown = {}, []
    for label, denoise in (("headline pipeline", False), ("headline pipeline, denoised", True)):
        make = functools.partial(pipelines.wavefront_pipeline, blue_noise=blue_noise, denoise=denoise)
        rec[label] = pipeline_phase(label, make, scene, settings, cam, backend, PROBE_TIMED_FRAMES, keys,
                                    per_frame, dev)
        step, init_state = make(scene, settings, backend=backend, device=dev)
        shown.append(step(init_state(), cam, 0)[0])
    d = (shown[1] - shown[0]).abs()
    finite = all(bool(x.isfinite().all()) for x in shown)
    phase(f"denoised headline frame 0: finite {finite}; differs from the plain display on "
          f"{int((d.amax(-1) > 0).sum())} of {d.shape[0] * d.shape[1]} pixels, mean |diff| {float(d.mean()):.4f}; "
          f"frame_ms {rec['headline pipeline, denoised']['frame_ms']:.3f} denoised vs "
          f"{rec['headline pipeline']['frame_ms']:.3f} plain")
    if not finite or not float(d.max()) > 0.0:
        fail("the denoised headline display is not finite or equals the plain one")
    torch.cuda.empty_cache()
    return rec



def lbvh512_phase(dev, card):
    """BASELINE.json config 2: one glTF mesh, LBVH build and traversal,
    primary rays and hard shadows, 512×512. The mesh is sponza720's GLB
    (``procedural.sponza_world``) in a ``World``; ``World.backend("bvh")``
    builds the LBVH over the scene's padded triangles on the card. The
    card's tables are held bit-equal to the CPU's build of the same
    triangles; the 512×512 primaries (``atrium_camera(aspect=1)``, pixel
    centres) and one shadow ray per hit toward the sky's sun are held
    against K1/K2 over the same triangles (``make_packet_backend``) by the
    oracle rule, their launches counted under ``lbvh512``. Prints the
    build's and the traces' times and loop turns and the peak memory,
    writes the shadowed image to ``build/lbvh512.ppm``, then renders the
    192×108 oracle through ``World.backend("bvh")`` of the headline atrium
    within tests/test_ground_truth.py's bound. Returns the records."""
    import torch

    from raytracer3_tpu_torch.app import viewer as viewer_mod
    from raytracer3_tpu_torch.ops import bvh as bvh_mod
    from raytracer3_tpu_torch.ops import mathx, tonemap, traverse, traverse_kernel as tk
    from raytracer3_tpu_torch.render import camera as camera_mod
    from raytracer3_tpu_torch.render import wavefront
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.scene import types as scene_types
    from raytracer3_tpu_torch.utils.config import RenderSettings

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    w512, h512 = LBVH512["width"], LBVH512["height"]
    t0 = time.perf_counter()
    world = procedural.sponza_world(SPONZA["detail"], cache_dir=os.path.join(REPO, "build", "assets"))
    scene = world.scene(device=dev)
    host = world._host_tris()
    n_real = host[0].shape[0]
    tris = scene.tri_vertices()
    if not all(np.array_equal(t[:n_real].cpu().numpy(), h) for t, h in zip(tris, host)):
        fail("lbvh512: the World scene's first triangles are not the mesh's (prim ids would not compare)")
    phase(f"lbvh512 scene: {n_real} triangles of sponza720's GLB in a World ({tris[0].shape[0]} with the pool's "
          f"padding), {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    isect, occl = world.backend("bvh", device=dev)  # the build finishes on the card before it returns
    build_ms = (time.perf_counter() - t0) * 1e3
    build_turns = dict(bvh_mod.LOOP_TURNS)
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    card_bvh = bvh_mod.build_lbvh(*tris)
    t0 = time.perf_counter()
    cpu_bvh = bvh_mod.build_lbvh(*(t.cpu() for t in tris))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = {k: same_bits(getattr(card_bvh, k).cpu(), getattr(cpu_bvh, k)) for k in bvh_mod.BVH._fields}
    phase(f"lbvh512 build ({card}): World.backend('bvh') {build_ms:.1f} ms on the host clock (the loops read a "
          f"flag a turn; turns {build_turns}), peak {build_peak:.3f} GiB; the card's tables bit-equal to the CPU's "
          f"build ({cpu_ms:.1f} ms on the host): {same}")
    if not all(same.values()):
        fail("lbvh512: the card's LBVH tables differ from the CPU's build")
    del card_bvh, cpu_bvh

    cam = procedural.atrium_camera(aspect=w512 / h512, device=dev)
    o, d = camera_mod.primary_rays(cam, w512, h512)
    torch.cuda.reset_peak_memory_stats()
    trace_ms, hit = [], None
    for _ in range(3):
        s_ev, e_ev = events()
        s_ev.record()
        hit = isect(o, d)
        e_ev.record()
        torch.cuda.synchronize()
        trace_ms.append(s_ev.elapsed_time(e_ev))
    trace_turns = traverse.LOOP_TURNS["turns"]
    sun = torch.nn.functional.normalize(torch.tensor(LBVH512["sun_dir"], dtype=torch.float32, device=dev), dim=0)
    sel = hit.hit.nonzero().squeeze(1)
    sh_o = o[sel] + d[sel] * hit.t[sel, None]
    sh_d = sun.expand(sh_o.shape[0], 3).contiguous()
    sh_t = torch.full((sh_o.shape[0],), mathx.BACKGROUND_DEPTH, dtype=torch.float32, device=dev)
    shadow_ms, blocked = [], None
    for _ in range(3):
        s_ev, e_ev = events()
        s_ev.record()
        blocked = occl(sh_o, sh_d, sh_t)
        e_ev.record()
        torch.cuda.synchronize()
        shadow_ms.append(s_ev.elapsed_time(e_ev))
    shadow_turns = traverse.LOOP_TURNS["turns"]
    trace_peak = torch.cuda.max_memory_allocated() / 2**30

    # The shadowed image: sky on a miss, N·L where the sun is seen, 0.1 ambient.
    nrm = scene_types.geometric_normals(scene, hit.prim_id[sel])
    lit = torch.where(blocked, 0.0, (nrm * sun).sum(-1).abs())
    img = torch.zeros((w512 * h512, 3), dtype=torch.float32, device=dev)
    img[:, 2] = 0.6
    img[sel] = (0.1 + lit)[:, None].expand(-1, 3)
    img = tonemap.agx_tonemap(img.reshape(h512, w512, 3)).clamp(0, 1)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    ppm = os.path.join(REPO, "build", "lbvh512.ppm")
    with open(ppm, "wb") as f:
        f.write(f"P6 {w512} {h512} 255\n".encode())
        f.write((img * 255.0 + 0.5).to(torch.uint8).cpu().numpy().tobytes())
    n_hit, n_blocked = int(sel.shape[0]), int(blocked.sum())
    phase(f"lbvh512 trace ({card}): {w512}x{h512} primaries through bvh_intersect {statistics.median(trace_ms):.3f} "
          f"ms median of {', '.join(f'{x:.3f}' for x in trace_ms)} ({trace_turns} loop turns), {n_hit} hits; "
          f"{n_hit} hard-shadow rays through bvh_occluded {statistics.median(shadow_ms):.3f} ms median of "
          f"{', '.join(f'{x:.3f}' for x in shadow_ms)} ({shadow_turns} turns), {n_blocked} in shadow; peak "
          f"{trace_peak:.3f} GiB; image {os.path.relpath(ppm, REPO)}")
    if not (n_hit > 0 and 0 < n_blocked < n_hit and bool(img.isfinite().all())):
        fail(f"lbvh512: implausible frame ({n_hit} hits, {n_blocked} in shadow)")

    # The same rays through K1/K2 over the same triangles (launches counted).
    pi, po, _ = tk.make_packet_backend(host_tris=host, device=dev)
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    k_hit = pi(o, d)
    k_blocked = po(sh_o, sh_d, sh_t)
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    _, max_dt = judge("lbvh512 primaries: bvh_intersect vs K1", hit, k_hit)
    mism = int((blocked != k_blocked).sum())
    phase(f"  lbvh512 shadows: bvh_occluded vs K2: n={n_hit} mismatches={mism} (limit {max(2, n_hit // 500)}); "
          f"K1/K2 launches {launches}")
    if mism > max(2, n_hit // 500):
        fail("lbvh512: the LBVH's shadow rays disagree with K2")

    # The 192×108 oracle through World.backend("bvh") of the headline atrium.
    name, n_frames, mean_tol, p99_tol = ORACLES[0]
    z = np.load(os.path.join(REPO, "resources", name))
    oracle, bounces = z["radiance"], int(z["bounces"])
    oh, ow = oracle.shape[:2]
    aw = viewer_mod.atrium_world(int(z["detail"]))
    a_scene = aw.scene(device=dev)
    a_isect, a_occl = aw.backend("bvh", device=dev)
    ocam = procedural.atrium_camera(aspect=ow / oh, device=dev)
    # The 4 samples of a frame in one wavefront: the same per-sample draws.
    s = RenderSettings(width=ow, height=oh, bounces=bounces, samples=4, sample_batch=True, radiance_clamp=50.0)
    t0 = time.perf_counter()
    total = torch.zeros((oh, ow, 3), dtype=torch.float64, device=dev)
    for i in range(n_frames):
        total += wavefront.render_frame(a_scene, ocam, s, i, a_isect, a_occl, sort_rays=True).double()
    img = (total / n_frames).to(torch.float32)

    def blocks(disp):
        bh, bw = disp.shape[0] // 4, disp.shape[1] // 4
        return disp[: bh * 4, : bw * 4].reshape(bh, 4, bw, 4, 3).mean(dim=(1, 3)).cpu().numpy()

    diff = np.abs(blocks(tonemap.agx_tonemap(img, look="punchy"))
                  - blocks(tonemap.agx_tonemap(torch.as_tensor(oracle, device=dev), look="punchy")))
    mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    oracle_s = time.perf_counter() - t0
    phase(f"oracle {name} ({ow}x{oh}, {bounces} bounces, {n_frames} frames x {s.samples} spp) through "
          f"World.backend('bvh'): mean block diff {mean:.4f} (limit {mean_tol}), p99 {p99:.4f} (limit {p99_tol}); "
          f"{oracle_s:.1f} s")
    if not (mean < mean_tol and p99 < p99_tol):
        fail("the wavefront through the LBVH is beyond the oracle's bounds")
    return {"lbvh512": dict(launches=launches, build_ms=build_ms, build_turns=build_turns, cpu_build_ms=cpu_ms,
                            trace_ms=trace_ms, trace_turns=trace_turns, shadow_ms=shadow_ms,
                            shadow_turns=shadow_turns, hits=n_hit, shadowed=n_blocked, peak_gib=trace_peak,
                            build_peak_gib=build_peak, max_dt_vs_k1=max_dt, shadow_mismatches=mism,
                            oracle=dict(mean=mean, p99=p99, seconds=oracle_s))}


def tiled_phase(scene, backend, settings, cam, dev, card):
    """``parallel/mesh`` on the card in a 1-rank NCCL group (NCCL refuses
    two ranks on one card): the headline (960×544, 4 bounces, K1/K2, no
    blue noise: the reference's tiled body has none) through
    ``render_wavefront_tiled`` held bit-equal to ``render_frame``'s frame on
    every timed frame, both timed (CUDA events) with their launches, the
    rank's traced-ray count beside the frame's; then
    ``render_sample_parallel`` bit-equal to ``render_image`` at the seed
    ``frame · 1 + 0``. Returns the record (launches under ``tiled``)."""
    import socket

    import torch
    import torch.distributed as dist

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.parallel import mesh as pmesh
    from raytracer3_tpu_torch.render import pathtracer, wavefront
    from raytracer3_tpu_torch.utils import runtime

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    runtime.init_distributed(f"localhost:{port}", 1, 0, device=dev, timeout_s=120.0)
    try:
        mesh = pmesh.make_render_mesh()
        isect, occl = backend.bind(backend.arrays)

        def tiled(fi):
            return pmesh.render_wavefront_tiled(scene, cam, settings, fi, backend.arrays, backend.intersect_fn,
                                                backend.occluded_fn, mesh=mesh, sort_rays=True, return_stats=True)

        def plain(fi):
            return wavefront.render_frame(scene, cam, settings, fi, isect, occl, sort_rays=True, return_stats=True)

        rec = {}
        for label, render in (("tiled", tiled), ("plain", plain)):
            render(0)
            torch.cuda.synchronize()
            for k in tk.LAUNCHES:
                tk.LAUNCHES[k] = 0
            ms, frames = [], []
            for fi in range(1, TILED_TIMED_FRAMES + 1):
                s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s_ev.record()
                frames.append(render(fi))
                e_ev.record()
                torch.cuda.synchronize()
                ms.append(s_ev.elapsed_time(e_ev))
            rec[label] = dict(frame_ms=statistics.median(ms), ms=ms, frames=frames,
                              launches={k: v // TILED_TIMED_FRAMES for k, v in tk.LAUNCHES.items() if v})
        same = [same_bits(a[0], b[0]) for a, b in zip(rec["tiled"]["frames"], rec["plain"]["frames"])]
        counts = [t[1].tolist() for t in rec["tiled"]["frames"]]
        traced = [int(p[1]) for p in rec["plain"]["frames"]]
        phase(f"tiled (1-rank NCCL group, {card}): headline {settings.width}x{settings.height} "
              f"bounces={settings.bounces} through render_wavefront_tiled {rec['tiled']['frame_ms']:.3f} ms median "
              f"({', '.join(f'{x:.3f}' for x in rec['tiled']['ms'])}) vs render_frame "
              f"{rec['plain']['frame_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in rec['plain']['ms'])}); per-rank "
              f"traced rays {counts} vs the frame's {traced}; launches per frame {rec['tiled']['launches']} vs "
              f"{rec['plain']['launches']}; frames bit-equal {same}")
        if not (all(same) and [c[0] for c in counts] == traced and rec["tiled"]["launches"] == rec["plain"]["launches"]
                and rec["tiled"]["launches"].get("closest") and rec["tiled"]["launches"].get("any")):
            fail("tiled: render_wavefront_tiled on one rank is not render_frame's frame through K1/K2")
        t0 = time.perf_counter()
        sp = pmesh.render_sample_parallel(scene, cam, settings, 0, isect, occl, mesh=mesh)
        ref = pathtracer.render_image(scene, cam, settings, 0, isect, occl)
        phase(f"tiled: render_sample_parallel on one rank bit-equal to render_image at seed 0: {same_bits(sp, ref)} "
              f"({time.perf_counter() - t0:.1f} s for both)")
        if not same_bits(sp, ref):
            fail("tiled: render_sample_parallel on one rank is not render_image's frame")
    finally:
        dist.destroy_process_group()
    launches = {k: v * TILED_TIMED_FRAMES for k, v in rec["tiled"]["launches"].items()}
    return {"tiled": dict(launches=launches, frame_ms=rec["tiled"]["frame_ms"], ms=rec["tiled"]["ms"],
                          plain_frame_ms=rec["plain"]["frame_ms"], plain_ms=rec["plain"]["ms"], counts=counts,
                          traced=traced)}


def host_clock_anchor():
    """A timing event that fired on an idle device, with the host time
    (``time.perf_counter``) it fired at: ``ready_at`` turns a later event's
    completion on the same device into host seconds."""
    import torch

    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev.record()
    ev.synchronize()
    return ev, (t0 + time.perf_counter()) / 2


def ready_at(anchor, event) -> float:
    """Host time (s) at which ``event`` (timing, completed) fired."""
    ev, t = anchor
    return t + ev.elapsed_time(event) / 1e3


def _script_cameras(v, script, dt):
    """Drive Viewer ``v`` along ``script`` (controls set before each step,
    None holds still): returns each step's display, the camera it rendered
    with and whether the step reset the film."""
    out = []
    for c in script:
        for k, val in (c or {}).items():
            setattr(v.controls, k, val)
        display = v.step(dt=dt)
        out.append((display, v.cam, v.film.frame_index == 1))
    return out


def interactive_phase(dev, card):
    """BASELINE config 5 at 1920×1088 through the viewer's entry points: the
    headline atrium and sky as ``viewer.main`` builds them (``World``,
    ``trace_backend("auto")`` → K1/K2), 4 bounces, radiance clamp 50, an
    in-process ``Viewer`` over ``make_default_frame_fn``. A scripted path
    (8 still frames, 4 with ``move_z=1``, 2 looks, 8 still) must leave the
    film's count at the frames since the last move and give displays
    bit-equal to the same frames composed by hand (``render_frame`` →
    ``accumulate_progressive`` → ``postprocess``, ``film.reset`` where the
    viewer moved). K1/K2 are held against their plain version on this
    path's own tables and one frame's rays. Then the steady frame (CUDA
    events), submit → ready (the display's event on the host's clock)
    beside the viewer's own submit → pop, move → display ready, the host
    issue time of a step and of the frame function alone, one profiled
    step, fps at 1 and 3 frames in flight, and the denoised frame. Returns
    the record for the kernels' ``launches_by_path`` and ``max_abs_err``."""
    import torch

    from raytracer3_tpu_torch.app import viewer as viewer_mod
    from raytracer3_tpu_torch.ops import rng, traverse_kernel as tk
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.render import postprocess, wavefront
    from raytracer3_tpu_torch.scene import procedural

    w, h = INTERACTIVE["width"], INTERACTIVE["height"]
    t0 = time.perf_counter()
    world = viewer_mod.atrium_world(detail=2)
    scene = world.scene(device=dev)
    backend = world.trace_backend("auto", device=dev)
    t_build = time.perf_counter() - t0
    if backend.self_sorting or not isinstance(backend.meta, tk.PacketTables):
        fail("World.trace_backend('auto') on CUDA did not give the packet backend (K1/K2)")
    settings = viewer_mod.main_settings(w, h, INTERACTIVE["bounces"])
    cam0 = procedural.atrium_camera(aspect=w / h, device=dev)
    frame_fn = viewer_mod.make_default_frame_fn(scene, settings, backend=backend)
    phase(f"interactive1080: World atrium detail 2 ({scene.indices.shape[0]} triangles with the pool's padding), "
          f"trace_backend('auto') -> packet backend, built in {t_build:.2f} s")

    # The scripted path, launches counted.
    still, moves, looks = [None] * 8, [dict(move_z=1.0)] + [None] * 3, [dict(move_z=0.0, look_dx=0.4, look_dy=0.05),
                                                                       dict(look_dx=-0.2)]
    script = still + moves + looks + still
    dt = 1 / 30
    v = viewer_mod.Viewer(frame_fn, cam0, settings, frames_in_flight=3, device=dev)
    torch.cuda.synchronize()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    path = _script_cameras(v, script, dt)
    v.drain()
    launches = {k: n for k, n in tk.LAUNCHES.items() if n}
    frames = len(script)
    resets = [i for i, (_, _, r) in enumerate(path) if r]
    expect_resets = [0] + list(range(8, 14))
    since_last = frames - resets[-1]
    phase(f"interactive1080 scripted path ({frames} frames, resets at {resets}): film.frame_index "
          f"{v.film.frame_index} (frames since the last move {since_last}); launches {launches}")
    if resets != expect_resets or v.film.frame_index != since_last:
        fail(f"interactive1080: resets {resets} (expected {expect_resets}), film count {v.film.frame_index} "
             f"(expected {since_last})")
    if launches != {"closest": 4 * frames, "any": 4 * frames}:
        fail(f"interactive1080: expected 4 K1 + 4 K2 walk launches a frame, got {launches} over {frames} frames")
    # The same frames composed by hand.
    isect, occl = backend.bind(backend.arrays)
    film = film_mod.Film.create(h, w, device=dev)
    mism = []
    for i, (display, cam, reset) in enumerate(path):
        if reset:
            film = film_mod.reset(film)
        film = film_mod.accumulate_progressive(film, wavefront.render_frame(scene, cam, settings, i, isect, occl,
                                                                            sort_rays=True))
        if not same_bits(display, postprocess.postprocess(film.accum)):
            mism.append(i)
    ok = not mism and same_bits(film.accum, v.film.accum) and film.frame_index == v.film.frame_index
    mean = float(path[-1][0].mean())
    phase(f"interactive1080 displays vs the frames composed by hand: bit-equal on all {frames} {ok} (differ at "
          f"{mism}); last display finite {bool(path[-1][0].isfinite().all())}, mean {mean:.4f}")
    if not ok or not bool(path[-1][0].isfinite().all()) or not mean > 0.0:
        fail("interactive1080: the viewer's displays differ from the frames composed by hand")
    del path, film

    # K1/K2 against the plain version on this path's tables and on one
    # frame's primaries, sorted bounce rays and NEE shadow rays at 1920x1088.
    pt = backend.meta._replace(node_table=backend.arrays["nodes"], cluster_table=backend.arrays["clusters"])
    blue_noise = torch.as_tensor(rng.generate_blue_noise(64), device=dev)
    o, d, b_org, b_dir, n_alive, sh_o, sh_d, sh_t, n_shadow = k12_population(scene, pt, cam0, settings, blue_noise)
    phase(f"interactive1080 kernel vs plain on World's tables (subset of {SUBSET} rays; primaries {o.shape[0]}, "
          f"bounce {n_alive} alive, shadow {n_shadow} traced):")
    errs = {}
    for kind, name, co, cd, ct in (("closest", "primaries", o, d, None),
                                   ("closest", "sorted bounce", b_org[:n_alive], b_dir[:n_alive], None),
                                   ("any", "NEE shadow t_max", sh_o[:n_shadow], sh_d[:n_shadow], sh_t[:n_shadow])):
        _, _, err = k12_against_plain(pt, kind, f"interactive1080 {name}", co, cd, ct)
        errs[kind] = max(errs.get(kind, 0.0), err)
    del o, d, b_org, b_dir, sh_o, sh_d, sh_t, blue_noise

    # Steady frames through the queue (3 in flight): device time by CUDA
    # events per step, host time per step, submit -> ready (the event after
    # the display, on the host's clock) and the viewer's submit -> pop.
    def steady(viewer, n):
        anchor = host_clock_anchor()
        events, host, submit = [], [], []
        viewer._timings.clear()
        for _ in range(n):
            s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t_step = time.perf_counter()
            s_ev.record()
            viewer.step(dt=dt)
            e_ev.record()
            host.append((time.perf_counter() - t_step) * 1e3)
            submit.append(t_step)
            events.append((s_ev, e_ev))
        viewer.drain()
        ready = [(ready_at(anchor, e) - t) * 1e3 for (_, e), t in zip(events, submit)]
        return [a.elapsed_time(b) for a, b in events], host, ready, [x * 1e3 for x in viewer._timings]

    ms, host, ready, popped = steady(v, INTERACTIVE_TIMED_FRAMES)
    frame_ms = statistics.median(ms)
    # Move -> that frame's display ready, 3 frames queued before it; how far
    # the card was behind the host at the move (the last queued frame's
    # display ready after the move's step began: > 0 means still rendering).
    anchor = host_clock_anchor()
    queued = []
    for _ in range(3):
        v.step(dt=dt)
        queued.append(torch.cuda.Event(enable_timing=True))
        queued[-1].record()
    v.controls.move_z = 1.0
    t_move = time.perf_counter()
    v.step(dt=dt)
    m_ev = torch.cuda.Event(enable_timing=True)
    m_ev.record()
    v.controls.move_z = 0.0
    v.drain()
    move_ms = (ready_at(anchor, m_ev) - t_move) * 1e3
    behind_ms = (ready_at(anchor, queued[-1]) - t_move) * 1e3
    # Host issue of one step, and of the frame function alone, each on an
    # idle device with nothing queued (the step then never waits).
    issue_step, issue_fn = [], []
    for _ in range(3):
        v.drain()
        torch.cuda.synchronize()
        t_issue = time.perf_counter()
        v.step(dt=dt)
        issue_step.append((time.perf_counter() - t_issue) * 1e3)
        v.drain()
        spare = film_mod.Film(accum=v.film.accum.clone(), frame_index=v.film.frame_index)
        torch.cuda.synchronize()
        t_issue = time.perf_counter()
        frame_fn(spare, v.cam, v.frame_index)
        issue_fn.append((time.perf_counter() - t_issue) * 1e3)
    torch.cuda.synchronize()
    del spare
    # One steady step profiled: device busy against the frame.
    v.drain()
    busy_ms, trav_ms, n_sync = profile_frame(lambda: v.step(dt=dt), K12_KEYS, "interactive1080 viewer step")
    v.drain()
    fps = {}
    for depth in (1, 3):
        fv = viewer_mod.Viewer(frame_fn, cam0, settings, frames_in_flight=depth, device=dev)
        fv.step(dt=dt)
        fv.drain()
        torch.cuda.synchronize()
        t_fps = time.perf_counter()
        for _ in range(INTERACTIVE_TIMED_FRAMES):
            fv.step(dt=dt)
        fv.drain()
        fps[depth] = dict(fps=INTERACTIVE_TIMED_FRAMES / (time.perf_counter() - t_fps), viewer_fps=fv.fps)
    phase(f"interactive1080 {w}x{h} bounces={settings.bounces} | {card}: steady frame_ms median {frame_ms:.3f} "
          f"(frames {', '.join(f'{x:.3f}' for x in ms)}); host per step median {statistics.median(host):.3f} ms; "
          f"submit -> ready (display event) median {statistics.median(ready):.3f} ms (frames "
          f"{', '.join(f'{x:.3f}' for x in ready)}), the viewer's submit -> pop median "
          f"{statistics.median(popped):.3f} ms (3 in flight); move -> display ready {move_ms:.3f} ms (the card "
          f"{behind_ms:.3f} ms behind the host at the move); host issue on an idle device: a step median "
          f"{statistics.median(issue_step):.3f} ms ({', '.join(f'{x:.3f}' for x in issue_step)}), the frame "
          f"function alone {statistics.median(issue_fn):.3f} ms ({', '.join(f'{x:.3f}' for x in issue_fn)}), the "
          f"viewer's own {statistics.median(issue_step) - statistics.median(issue_fn):.3f} ms; profiled step: device "
          f"busy {busy_ms:.3f} ms of the {frame_ms:.3f} ms frame (idle share {1 - busy_ms / frame_ms:.3f}), "
          f"K1/K2 {trav_ms:.3f} ms, stream syncs {n_sync}; fps at 1 in flight {fps[1]['fps']:.3f} (Viewer.fps "
          f"{fps[1]['viewer_fps']:.3f}), at 3 {fps[3]['fps']:.3f} (Viewer.fps {fps[3]['viewer_fps']:.3f}); K1/K2 per "
          f"frame 4 + 4")
    # The denoised viewer frame.
    dv = viewer_mod.Viewer(viewer_mod.make_default_frame_fn(scene, settings, backend=backend, denoise=True), cam0,
                           settings, frames_in_flight=3, device=dev)
    dv.step(dt=dt)
    dv.drain()
    dms, _, _, _ = steady(dv, 5)
    den = dv.drain()
    den_ms = statistics.median(dms)
    phase(f"interactive1080 denoised | {card}: steady frame_ms median {den_ms:.3f} (frames "
          f"{', '.join(f'{x:.3f}' for x in dms)}), display finite {bool(den.isfinite().all())}")
    if not bool(den.isfinite().all()):
        fail("interactive1080: the denoised display is not finite")
    return {"interactive1080": dict(frame_ms=frame_ms, host_ms=statistics.median(host),
                                    ready_ms=statistics.median(ready), pop_ms=statistics.median(popped),
                                    move_ms=move_ms, behind_ms=behind_ms, busy_ms=busy_ms,
                                    issue_step_ms=statistics.median(issue_step),
                                    issue_fn_ms=statistics.median(issue_fn), fps=fps, denoised_ms=den_ms,
                                    launches=launches, frames=frames, max_abs_err=errs)}


def viewer_main_phase(card):
    """``python -m raytracer3_tpu_torch.app.viewer`` at 1920×1088, 4 bounces
    on the card, driven through stdin with ``docs/INTERACTIVE.md``'s script
    (``save`` apart: it needs PIL), polling ``stats`` until 3 frames have
    passed between two commands. Fails unless it exits 0 with a parseable
    final status line, ``spp`` falls below ``frame`` after the move and the
    look, and ``spp`` restarts after ``set bounces=2``."""
    import queue
    import threading

    cmd = [sys.executable, "-m", "raytracer3_tpu_torch.app.viewer", "--width", str(INTERACTIVE["width"]),
           "--height", str(INTERACTIVE["height"]), "--bounces", str(INTERACTIVE["bounces"])]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    err_path = os.path.join(REPO, "build", "viewer_main.stderr")
    os.makedirs(os.path.dirname(err_path), exist_ok=True)
    lines = queue.Queue()
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO,
                             env=env)
    threading.Thread(target=lambda: [lines.put(x) for x in p.stdout], daemon=True).start()
    seen = []

    def stop(msg):
        p.kill()
        p.wait()
        tail = open(err_path).read()[-1500:]
        fail(f"viewer main: {msg}; status lines {seen}; stderr tail: {tail}")

    def send(text):
        try:
            p.stdin.write(text + "\n")
            p.stdin.flush()
        except BrokenPipeError:
            stop(f"the viewer closed its input before {text!r}")

    def stats():
        send("stats")
        try:
            line = lines.get(timeout=VIEWER_MAIN_LINE_TIMEOUT_S)
        except queue.Empty:
            stop(f"no status line within {VIEWER_MAIN_LINE_TIMEOUT_S} s")
        seen.append(json.loads(line))
        return seen[-1]

    def after_frames(n=3):
        start = stats()
        now = start
        while now["frame"] < start["frame"] + n:
            time.sleep(0.05)
            now = stats()
        return now

    first = after_frames()
    t_first = time.perf_counter() - t0
    send("move 0 0 1")
    after_frames()
    send("stop")
    after_move = stats()
    after_frames()
    send("look 0.4 0.05")
    after_look = after_frames()
    before_set = after_look
    send("set bounces=2")
    after_set = stats()
    settled = after_frames()
    send("quit")
    try:
        p.stdin.close()
        rc = p.wait(timeout=VIEWER_MAIN_LINE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stop("it did not exit after quit")
    rest = []
    while True:
        try:
            rest.append(lines.get(timeout=5))
        except queue.Empty:
            break
    try:
        final = json.loads(rest[-1])
    except (IndexError, ValueError):
        final = None
    phase(f"viewer main | {card}: first status after {t_first:.1f} s (start-up and build included); status lines:")
    for st in seen + ([final] if final else []):
        phase(f"  {json.dumps(st)}")
    checks = {
        "exit code 0": rc == 0,
        "a final status line": final is not None and sorted(final) == ["fps", "frame", "spp"],
        "spp < frame after the move": after_move["spp"] < after_move["frame"],
        "spp < frame after the look": after_look["spp"] < after_look["frame"] and
        after_look["spp"] <= after_look["frame"] - first["frame"],
        "spp restarts after set bounces=2": after_set["frame"] < before_set["frame"] and
        after_set["spp"] == after_set["frame"] and settled["spp"] == settled["frame"] > after_set["frame"],
    }
    phase(f"viewer main checks: {checks}; final {final}; {time.perf_counter() - t0:.1f} s")
    if not all(checks.values()):
        fail(f"viewer main: {[k for k, ok in checks.items() if not ok]}")


def interactive_probe_phase(big, big_scene, dev, card):
    """The port's counterpart of ``tools/interactive_evidence.py``: the
    probe-GI pipeline at 1920×1088 (texel splits 2) on the 300k atrium
    through the treelet backend (K3), driven by a ``Viewer`` with 3 frames
    in flight over the reference's bridge (the film's ``frame_index`` is the
    pipeline's, so a move is a camera cut) along its path: 30 still frames,
    8 frames of ``move_z=0.3`` and ``look_dx=0.06``, then a stop and 60
    still frames. Reports the steady frame over 20 still frames (CUDA
    events) and the move → 90% converged latency by the reference's
    definition (14 steady frames) and measured (the first frame after the
    stop whose mean |display − display at stop+20| has closed 90% of its
    gap at stop+1; also against stop+60, which stop+20 is still short of
    with half the texels traced a frame). Writes no image."""
    import torch

    from raytracer3_tpu_torch.app import viewer as viewer_mod
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    s = RenderSettings(bounces=1, samples=1, **SPONZA1080_PROBE)
    cam = procedural.atrium_camera(aspect=s.width / s.height, device=dev)
    step, init_state = pipelines.probe_gi_pipeline(big_scene, s, backend=big, device=dev)
    cell = {"state": init_state()}

    def frame_fn(film, cam_, frame_index):
        # The film's count restarts at a move: frame 0 is a camera cut.
        display, cell["state"] = step(cell["state"], cam_, film.frame_index)
        return film_mod.Film(accum=film.accum, frame_index=film.frame_index + 1), display

    v = viewer_mod.Viewer(frame_fn, cam, s, frames_in_flight=3, device=dev)
    torch.cuda.synchronize()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    dt, stop_at, after, longer = 1 / 30, 38, 20, 60
    displays = {}
    for i in range(stop_at + longer + 1):
        if 30 <= i < stop_at:
            v.controls.move_z, v.controls.look_dx = 0.3, 0.06
        elif i == stop_at:
            v.controls.move_z = v.controls.look_dx = 0.0
        display = v.step(dt=dt)
        if i > stop_at:
            displays[i - stop_at] = display
    v.drain()
    frames = stop_at + longer + 1
    launches = {k: n for k, n in tk.LAUNCHES.items() if n}
    per_frame = {"seg_closest": 2, "seg_any": 1}
    if launches != {k: n * frames for k, n in per_frame.items()}:
        fail(f"interactive probe: expected {per_frame} launches a frame, got {launches} over {frames} frames")
    if not all(bool(d.isfinite().all()) for d in displays.values()):
        fail("interactive probe: a display after the stop is not finite")

    def closing(end):
        # mean |display - display at stop+end| for stop+1 .. stop+end, and
        # the first frame that has closed 90% of the gap at stop+1.
        gaps = [float((displays[k] - displays[end]).abs().mean()) for k in range(1, end + 1)]
        if not gaps[0] > 0.0:
            fail(f"interactive probe: no gap after the stop (gaps {gaps[:3]})")
        return gaps, next(k for k, g in enumerate(gaps, 1) if g <= 0.1 * gaps[0])

    gaps, first90 = closing(after)
    gaps_long, first90_long = closing(longer)
    del displays
    events = []
    for _ in range(INTERACTIVE_PROBE_TIMED_FRAMES):
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        v.step(dt=dt)
        e_ev.record()
        events.append((s_ev, e_ev))
    v.drain()
    ms = [a.elapsed_time(b) for a, b in events]
    frame_ms = statistics.median(ms)
    phase(f"interactive probe-GI {s.width}x{s.height} (texel splits {s.probe_texel_splits}, 3 in flight, K3) | "
          f"{card}: steady frame_ms median {frame_ms:.3f} over {len(ms)} still frames ({1e3 / frame_ms:.2f} fps); "
          f"move -> 90% converged: reference definition 14 x frame = {14 * frame_ms / 1e3:.3f} s, measured "
          f"against stop+{after} {first90} frames after the stop = {first90 * frame_ms / 1e3:.3f} s (gap at stop+1 "
          f"{gaps[0]:.5f}, mean |display - display at stop+{after}| by frame: {', '.join(f'{g:.5f}' for g in gaps)}); "
          f"against stop+{longer} {first90_long} frames = {first90_long * frame_ms / 1e3:.3f} s (gap at stop+1 "
          f"{gaps_long[0]:.5f}, by frame: {', '.join(f'{g:.5f}' for g in gaps_long)}); launches per frame "
          f"{per_frame}")
    phase("  record, not compared: the reference's tools/interactive_evidence.py on a TPU v5e gave 202.4 ms a frame "
          "and 2.83 s to 90% converged (docs/interactive_trace_r5.json)")
    return {"interactive_probe1080": dict(frame_ms=frame_ms, ms=ms, first90=first90, first90_long=first90_long,
                                          latency_ref_s=14 * frame_ms / 1e3, latency_s=first90 * frame_ms / 1e3,
                                          launches=launches, frames=frames)}


def bench_phase():
    """The port's bench as a user runs it: ``python -m raytracer3_tpu_torch.bench
    --details build/bench/BENCH_DETAILS.json`` in a process of its own
    (stdout and stderr kept in ``build/bench/``). Fails on a nonzero exit,
    an error entry, a config missing of the eight, a time or rate that is
    not finite and positive, a config that did not launch its kernels
    (K1/K2 on the 19k atrium, K3 on the 300k one) or a stdout headline line
    without ``bench.py``'s keys. Returns each config's launches (per frame
    × its frames) for the kernels line."""
    out_dir = os.path.join(REPO, "build", "bench")
    details = os.path.join(out_dir, "BENCH_DETAILS.json")
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(details):
        os.remove(details)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "raytracer3_tpu_torch.bench", "--details", details], cwd=REPO,
                              capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"the bench did not finish within {BENCH_TIMEOUT_S} s")
    PHASE_S["bench_phase"] = time.perf_counter() - t0
    for name, text in (("bench.stdout", proc.stdout), ("bench.stderr", proc.stderr)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    if proc.returncode != 0:
        fail(f"the bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    records = json.load(open(details))
    errors = [r for r in records if "error" in r]
    if errors:
        fail(f"the bench recorded errors: {errors}")
    by = {r["config"]: r for r in records}
    missing = [c for c in BENCH_CONFIGS if c not in by]
    if missing or [r["config"] for r in records] != list(BENCH_CONFIGS):
        fail(f"the bench's configs are not bench.py's eight in its order (missing {missing}): "
             f"{[r['config'] for r in records]}")
    head = json.loads(proc.stdout.strip().splitlines()[-1])
    if [k for k in BENCH_HEADLINE_KEYS if k not in head]:
        fail(f"the bench's headline line lacks {[k for k in BENCH_HEADLINE_KEYS if k not in head]}: {head}")
    phase(f"bench_phase: python -m raytracer3_tpu_torch.bench -> rc 0 in {PHASE_S['bench_phase']:.1f} s; "
          f"headline line {json.dumps(head)}")
    out = {}
    for tag in BENCH_CONFIGS:
        r = by[tag]
        rates = [r["frame_ms"], r["fps"]] + ([r["mrays_per_s_per_chip"], r["spp_per_s"]] if "spp_per_s" in r else [])
        if not all(np.isfinite(x) and x > 0 for x in rates + r["frame_ms_each"]):
            fail(f"bench {tag}: a time or rate is not finite and positive: {r}")
        want = ("closest", "any") if tag in BENCH_K12 else ("seg_closest", "seg_any")
        per_frame = r["launches_per_frame"]
        if sorted(per_frame) != sorted(want) or not all(per_frame.values()):
            fail(f"bench {tag}: expected launches of {want} a frame only, got {per_frame}")
        frames = len(r["frame_ms_each"]) + 1
        out[f"bench {tag}"] = {"launches": {k: v * frames for k, v in per_frame.items()}}
        rung = (f", spp {r['samples_per_frame']} of the ladder {r['spp_ladder']} (budget left at the pick "
                f"{r['budget_left_s']:.0f} s)" if "spp_ladder" in r else "")
        rays = (f", {r['spp_per_s']} spp/s, {r['mrays_per_s_per_chip']} Mray/s measured "
                f"({r['nominal_mrays_per_s_per_chip']} nominal, {r['measured_rays_per_pixel']} rays/pixel), "
                f"vs_baseline {r['vs_baseline']}" if "spp_per_s" in r else "")
        phase(f"  bench {tag} {r['width']}x{r['height']} ({r['tris']} tris){rung}: frame_ms {r['frame_ms']} "
              f"(frames {', '.join(f'{x:.3f}' for x in r['frame_ms_each'])}; warm-up {r['warmup_ms']:.3f}; host "
              f"wall {r['host_ms_per_frame']:.1f} ms/frame), {r['fps']} fps{rays}, peak {r['peak_gib']:.2f} GiB, "
              f"launches per frame {per_frame}")
    return out


def ground_truth_phase():
    """The port's ``tools/make_ground_truth.py`` through K1/K2 (``main``,
    as a user calls it): ``--skip-720`` (the 192×108 oracle) and ``--v2``
    (the two 384×216 oracles) at 512 spp into ``build/ground_truth/``, each
    held against its stored ``resources/oracle_atrium_*.npz``: the same
    fields and settings, and the 4×4 block means of the AgX displays
    (``quality_table.tonemap_blocks``) within ``ORACLES``' bounds. Returns
    the launches."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.tools import make_ground_truth, quality_table

    out = os.path.join(REPO, "build", "ground_truth")
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    for argv in (["--skip-720"], ["--v2"]):
        t1 = time.perf_counter()
        if make_ground_truth.main(argv + ["--spp", str(GT_SPP), "--out", out]) != 0:
            fail(f"make_ground_truth {argv} returned nonzero")
        phase(f"ground_truth_phase: make_ground_truth {argv[0]} --spp {GT_SPP} -> {time.perf_counter() - t1:.1f} s")
    PHASE_S["ground_truth_phase"] = time.perf_counter() - t0
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    frames = len(ORACLES) * GT_SPP // GT_BATCH
    per_frame = {"closest": 1 + GT_BATCH * (GT_BOUNCES - 1), "any": GT_BATCH * GT_BOUNCES}
    if launches != {k: v * frames for k, v in per_frame.items()}:
        fail(f"ground truth: expected {per_frame} walk launches a frame over {frames} frames, got {launches}")
    rec = {"ground_truth": {"launches": launches, "seconds": PHASE_S["ground_truth_phase"]}}
    for name, _, mean_tol, p99_tol in ORACLES:
        got, ref = np.load(os.path.join(out, name)), np.load(os.path.join(REPO, "resources", name))
        if sorted(got.files) != sorted(ref.files) or any(str(got[k]) != str(ref[k]) for k in ref.files
                                                         if k != "radiance"):
            fail(f"ground truth {name}: fields {got.files} / settings differ from the stored oracle's")
        if got["radiance"].shape != ref["radiance"].shape or not np.isfinite(got["radiance"]).all():
            fail(f"ground truth {name}: radiance not finite of the stored shape {ref['radiance'].shape}")
        diff = np.abs(quality_table.tonemap_blocks(got["radiance"]) - quality_table.tonemap_blocks(ref["radiance"]))
        mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
        phase(f"  ground truth {name} ({GT_SPP} spp, K1/K2) against the stored oracle: mean block diff {mean:.5f} "
              f"(limit {mean_tol}), p99 {p99:.5f} (limit {p99_tol}), max {float(diff.max()):.5f}")
        if not (mean < mean_tol and p99 < p99_tol):
            fail(f"the port's ground truth is beyond the oracle's bounds on {name}")
        rec["ground_truth"][name] = dict(mean=mean, p99=p99)
    phase(f"  ground truth launches {launches} ({per_frame} a frame over {frames} frames)")
    return rec


def interactive_evidence_phase(big, big_scene, big_tris, dev):
    """The port's ``tools/interactive_evidence.py`` loop (``evidence``) at
    the tool's defaults (1920×1088, texel splits 1, 120 frames and 20 timed)
    on the 300k atrium and its treelet backend (K3), the scene and backend
    the tool's ``main`` builds, into ``build/interactive/``. Fails unless
    the trace has 120 frames with the reference's fields, the five PNGs are
    there, every display was finite, the summary holds a finite move → 90%
    converged time and the frames launched K3 as the probe pipeline does.
    Returns the launches."""
    import torch

    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.tools import interactive_evidence
    from raytracer3_tpu_torch.utils.config import RenderSettings

    e = EVIDENCE
    s = RenderSettings(width=e["width"], height=e["height"], bounces=1, samples=1,
                       probe_texel_splits=e["probe_texel_splits"])
    cam = procedural.atrium_camera(aspect=s.width / s.height, device=dev)
    step, init_state = pipelines.probe_gi_pipeline(big_scene, s, backend=big, device=dev)
    out = os.path.join(REPO, "build", "interactive")
    pngs = [os.path.join(out, f"{tag}.png") for tag in interactive_evidence.SNAPS.values()]
    for path in pngs + [os.path.join(out, "interactive_trace.json")]:
        if os.path.exists(path):
            os.remove(path)
    torch.cuda.synchronize()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = interactive_evidence.evidence(big_tris, step, init_state, cam, s, e["frames"], out, device=dev)
    PHASE_S["interactive_evidence"] = time.perf_counter() - t0
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    frames = e["frames"] + interactive_evidence.TIMED_FRAMES
    per_frame = {"seg_closest": 2, "seg_any": 1}
    if launches != {k: v * frames for k, v in per_frame.items()}:
        fail(f"interactive evidence: expected {per_frame} launches a frame over {frames} frames, got {launches}")
    summ, trace = res["summary"], res["trace"]
    saved = json.load(open(os.path.join(out, "interactive_trace.json")))
    fields = {"frame", "phase", "t", "step_ms", "spp", "fps"}
    if len(trace) != e["frames"] or saved["summary"] != summ or any(set(t) != fields for t in saved["trace"]):
        fail(f"interactive evidence: the trace is not {e['frames']} frames of {sorted(fields)}")
    heads = [open(p_, "rb").read(8) if os.path.exists(p_) else b"" for p_ in pngs]
    if any(h != b"\x89PNG\r\n\x1a\n" for h in heads):
        fail(f"interactive evidence: the strip's PNGs are not all there: {pngs}")
    lat = summ["move_to_90pct_converged_s"]
    if not (summ["all_displays_finite"] and np.isfinite(lat) and lat > 0 and summ["move_stop_frame"] == 38):
        fail(f"interactive evidence: summary {summ}")
    spp_after = [t["spp"] for t in trace[38:41]]
    phase(f"interactive_evidence {s.width}x{s.height} (texel splits {s.probe_texel_splits}, K3) -> "
          f"{PHASE_S['interactive_evidence']:.1f} s: steady frame {summ['steady_frame_ms']} ms ({summ['fps']} fps), "
          f"move -> 90% converged {lat} s, spp at frames 38-40 {spp_after}, five PNGs and the trace in "
          f"build/interactive/; launches {launches} over {frames} frames")
    return {"interactive_evidence": {"launches": launches, "summary": summ}}


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # noqa: BLE001 — a raised check is a failed phase
        import traceback

        traceback.print_exc()
        fail(f"{type(exc).__name__}: {exc}")
