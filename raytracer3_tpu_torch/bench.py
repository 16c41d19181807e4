"""The port's bench (port of ``bench.py``): Mray/s and frame times of
progressive path tracing on one CUDA device.

    python -m raytracer3_tpu_torch.bench [--details build/bench/BENCH_DETAILS.json]

Prints each configuration's record as a JSON line on stderr and, after every
configuration, the headline JSON line on stdout (``{"metric", "value",
"unit", "vs_baseline", ...}``, the keys of ``bench.py``'s
``headline_line``); the last stdout line is the most complete. Every record
is also rewritten into ``--details`` after each configuration. Runs on the
CUDA device; ``--device cpu`` runs the plain versions on the host (for the
tests; host-clock times) and a missing card raises.

Configurations, in ``bench.py``'s order and at its frame counts:

- ``headline``: procedural atrium (19k triangles) + HDR sky, 960×544, 4
  bounces, NEE/MIS, RR, blue noise, 3 timed frames (K1/K2).
- ``sponza720``: the 300k-triangle atrium through GLB ingest and ``World``
  (``procedural.sponza_world_scene``), 1280×720, 2 bounces, spp from the
  ladder 32/16/8/4 (capped by ``RT3_BENCH_MAX_SPP720``), 2 timed frames;
  ``sponza1080``: 1920×1088, 4 bounces, ladder 16/8/4, 2 timed frames (K3).
- ``sponza1080_probe_gi`` (texel splits 2), ``sponza720_probe_gi``,
  ``sponza720_hybrid_gi``, then ``probe_gi`` and ``hybrid_gi`` at 960×544:
  the probe pipelines, 3 timed frames each.

Each frame is compiled, as ``bench.py`` jits its frame: ``render_frame`` and
the film's blend (``run_config``) or a pipeline's step (``run_probe_config``)
run as one CUDA graph (``graph.capture_step``), captured by the first call
and replayed a frame. Timing: frame 0 is the warm-up and the capture (its
host time, synced, is ``capture_ms``: the counterpart of the reference's
compile frame); each timed frame runs between two CUDA events and
``frame_ms`` is their median. The traced-ray counts stay on the device
until the last frame is done. Each configuration's graph is released, and
the allocator's cache emptied, before the next. ``value`` is measured
Mray/s (primaries + alive closest-hit lanes + traced shadow lanes);
``vs_baseline`` divides it by the north star on one card: Sponza
1920×1088, 1 primary + 4 bounce rays a pixel, 30 fps = 313.344 Mray/s.

The whole bench fits a wall-clock budget (``RT3_BENCH_BUDGET_S``, default
1500 s): the sponza configurations take the largest spp of their ladder
whose estimated cost fits a share of the remaining budget (``_pick_spp``),
and a configuration that raises is recorded as ``{"config", "error"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

# One card against the north star (BASELINE.md): 1920·1088 pixels ×
# (1 primary + 4 bounce rays) × 30 fps. bench.py divides it by the 8 chips
# of a v5e-8; the port's unit is one card.
BASELINE_MRAYS_PER_CHIP = 1920 * 1088 * (1 + 4) * 30 / 1e6  # 313.344

BUDGET_S = float(os.environ.get("RT3_BENCH_BUDGET_S", "1500"))
_T0 = None  # main's start (time.monotonic()); nothing runs at import
DEFAULT_DETAILS = os.path.join("build", "bench", "BENCH_DETAILS.json")

# Cost priors of the spp ladder: seconds per spp of a frame and of the
# warm-up frame, measured by this bench on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (PERF.md): sponza720 at 32 spp 1,092.3 ms a frame after
# a 1,199.3 ms warm-up, sponza1080 at 16 spp 2,346.9 ms after 2,511.4 ms;
# the whole bench took 44 s.
PER_SPP_S_720, WARMUP_S_720 = 0.034, 1.2
PER_SPP_S_1080, WARMUP_S_1080 = 0.147, 2.5
LADDER_1080 = [16, 8, 4]


def _remaining() -> float:
    t0 = time.monotonic() if _T0 is None else _T0
    return BUDGET_S - (time.monotonic() - t0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_calls(fn, timed: int, dev):
    """Call ``fn(i)`` for i = 0 (the warm-up) .. ``timed``, each call between
    two CUDA events (on the CPU, where a call is done when it returns, the
    host clock). Returns (outputs, [ms per call], host wall ms per timed
    call, host wall ms of the warm-up call until its work is done). Nothing
    is read back before the last call is done."""
    cuda = dev.type == "cuda"
    outs, marks = [], []
    _sync(dev)
    t_host = time.perf_counter()
    first_ms = None
    for i in range(timed + 1):
        if i == 1:
            _sync(dev)
            t_first, t_host = t_host, time.perf_counter()
            first_ms = (t_host - t_first) * 1e3
        if cuda:
            s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_ev.record()
            outs.append(fn(i))
            e_ev.record()
            marks.append((s_ev, e_ev))
        else:
            t0 = time.perf_counter()
            outs.append(fn(i))
            marks.append((t0, time.perf_counter()))
    _sync(dev)
    host_ms = (time.perf_counter() - t_host) / max(timed, 1) * 1e3
    if first_ms is None:
        first_ms = host_ms
    ms = [s.elapsed_time(e) if cuda else (e - s) * 1e3 for s, e in marks]
    return outs, ms, host_ms, first_ms


def frames_run(label, render, timed, per_frame, dev, film_hw=None):
    """Drive ``render(frame_index) -> (radiance [H, W, 3], traced count)``
    into a progressive film: warm-up frame 0 and frames 1 to ``timed``, each
    timed (``timed_calls``), the launch counts set to 0 before and read
    after, the peak device memory over all of them (reset before the
    warm-up; None on the CPU). With ``film_hw`` = (H, W) the frame (render
    and film blend, as ``bench.py`` jits it) is one compiled step
    (``graph.capture_step``: on the card a CUDA graph captured by frame 0
    and replayed by the others, its frame index and blend factor graph
    inputs; eager on the CPU); without, each frame runs eagerly. Raises
    unless the film is finite with a positive mean and, when ``per_frame``
    (counter → launches per frame) is given, the path launched exactly that.
    Returns the record: the warm-up frame's radiance under ``radiance0``,
    the film under ``film``, frame 0's host time under ``capture_ms``."""
    from raytracer3_tpu_torch.graph.graph import capture_step
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import film as film_mod

    cell = {"film": None, "rad0": None}
    step = None
    if film_hw is not None:
        def body(state, fi, bf):
            radiance, n_traced = render(fi)
            film = film_mod.blend(film_mod.Film(state["film"], 0), radiance, bf)
            return (radiance, n_traced), {"film": film.accum}

        step = capture_step(body, where=lambda: f"{label}'s frame")
        cell["film"] = film_mod.Film.create(*film_hw, device=dev)

    def frame(i):
        if step is not None:
            film = cell["film"]
            (radiance, n_traced), st = step({"film": film.accum}, fi=i,
                                            bf=film_mod.progressive_blendfactor(film.frame_index, dev))
            cell["film"] = film_mod.Film(st["film"], film.frame_index + 1)
            if cell["rad0"] is None:
                cell["rad0"] = radiance
            return n_traced
        radiance, n_traced = render(i)
        if cell["film"] is None:
            cell["film"] = film_mod.Film.create(radiance.shape[0], radiance.shape[1], device=dev)
            cell["rad0"] = radiance
        cell["film"] = film_mod.accumulate_progressive(cell["film"], radiance)
        return n_traced

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    traced, ms_all, host_ms, first_ms = timed_calls(frame, timed, dev)
    frames = timed + 1
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    if per_frame is not None and launches != {k: n * frames for k, n in per_frame.items()}:
        raise RuntimeError(f"{label}: expected {per_frame} launches per frame, got {launches} over {frames} frames")
    film = cell["film"]
    mean = float(film.accum.mean())
    if not bool(film.accum.isfinite().all()) or not mean > 0.0:
        raise RuntimeError(f"{label}: film not finite with a positive mean (mean {mean})")
    counts = [int(t) for t in traced]
    ms = ms_all[1:] or ms_all[:1]
    return dict(frame_ms=statistics.median(ms), ms=ms, warm_ms=ms_all[0], peak_gib=peak_gib, launches=launches,
                frames=frames, traced=statistics.median(counts[1:] or counts), traced_frames=counts[1:] or counts,
                film_mean=mean, host_ms=host_ms, capture_ms=first_ms, radiance0=cell["rad0"], film=film)


def frames_line(label, rec, settings) -> str:
    """``frames_run``'s record as one line of text."""
    w, h, spp, nb = settings.width, settings.height, settings.samples, settings.bounces
    fms, rays = rec["frame_ms"], rec["traced"]
    nominal = w * h * (1 + 2 * nb) * spp
    peak = "not measured" if rec["peak_gib"] is None else f"{rec['peak_gib']:.2f} GiB"
    return (f"{label} {w}x{h} bounces={nb} spp={spp} (sample_batch {settings.sample_batch}, lane_diet "
            f"{settings.lane_diet}, fuse_shadow {settings.fuse_shadow}): frame_ms median {fms:.3f} (warm-up "
            f"{rec['warm_ms']:.3f}; frames {', '.join(f'{x:.3f}' for x in rec['ms'])}; host wall "
            f"{rec['host_ms']:.1f} ms/frame), {spp / fms * 1e3:.3f} spp/s, measured {rays / fms / 1e3:.2f} Mray/s "
            f"({rays / (w * h):.3f} rays/pixel), nominal {nominal / fms / 1e3:.2f} Mray/s, peak device memory "
            f"{peak}, launches per frame {per_frame_of(rec)}, film mean {rec['film_mean']:.4f}")


def per_frame_of(rec) -> dict:
    return {k: v // rec["frames"] for k, v in rec["launches"].items()}


def bench_settings(width, height, bounces, samples=1, fuse_shadow=False):
    """``bench.py``'s RenderSettings (``bench.py:128-142``)."""
    from raytracer3_tpu_torch.utils.config import RenderSettings

    # samples > 1 batches all paths into one wavefront of samples·W·H
    # lanes; the lane diet (rgb9e5-packed colour state across launches) is
    # on for such frames unless RT3_LANE_DIET says otherwise; NEE shadow-ray
    # Russian roulette stays opt-in (RT3_NEE_RR).
    return RenderSettings(
        width=width, height=height, bounces=bounces, samples=samples, sample_batch=samples > 1,
        radiance_clamp=50.0, fuse_shadow=fuse_shadow,
        lane_diet=os.environ.get("RT3_LANE_DIET", "1" if samples > 1 else "0") == "1",
        nee_rr_threshold=float(os.environ.get("RT3_NEE_RR", "0")),
    )


def run_config(tag, scene, host_tris, cam, width, height, bounces, n_frames=3, samples=1, fuse_shadow=False,
               backend=None, *, device):
    """One progressive path-tracing configuration: ``wavefront.render_frame``
    through ``backend`` (default ``packet_backend(host_tris=...)``: K1/K2,
    or K3 for a scene it routes to treelets) → ``film.accumulate_progressive``
    as one compiled frame (``frames_run`` with ``film_hw``), one warm-up
    (the capture) and ``n_frames`` timed frames. Returns the record."""
    from raytracer3_tpu_torch.ops import rng as rng_mod
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import wavefront

    dev = torch.device(device)
    if backend is None:
        backend = tk.packet_backend(host_tris=host_tris, device=dev)
    settings = bench_settings(width, height, bounces, samples, fuse_shadow)
    blue_noise = torch.as_tensor(rng_mod.generate_blue_noise(64), device=dev)
    isect, occl = backend.bind(backend.arrays)
    primary = backend.bind_primary(backend.arrays)
    fused = backend.bind_capped(backend.arrays) if settings.fuse_shadow else None

    def render(fi):
        return wavefront.render_frame(scene, cam, settings, fi, isect, occl, sort_rays=not backend.self_sorting,
                                      blue_noise=blue_noise, return_stats=True, primary_fn=primary, fused_fn=fused)

    rec = frames_run(tag, render, n_frames, None, dev, film_hw=(height, width))
    dt = rec["frame_ms"] / 1e3
    # Nominal rays a pixel: 1 primary + bounces closest-hit + bounces NEE
    # shadow; the measured count (lanes actually traced) is the Mray/s
    # numerator, smaller where Russian roulette and escapes end paths.
    measured = sum(rec["traced_frames"]) / len(rec["traced_frames"])
    mrays = measured / dt / 1e6
    return {
        "config": tag,
        "width": width,
        "height": height,
        "bounces": bounces,
        "samples_per_frame": samples,
        "tris": int(host_tris[0].shape[0]),
        "frame_ms": round(rec["frame_ms"], 1),
        "fps": round(1.0 / dt, 2),
        "spp_per_s": round(samples / dt, 2),
        "mrays_per_s_per_chip": round(mrays, 3),
        "nominal_mrays_per_s_per_chip": round(width * height * (1 + 2 * bounces) * samples / dt / 1e6, 3),
        "measured_rays_per_pixel": round(measured / (width * height), 2),
        "vs_baseline": round(mrays / BASELINE_MRAYS_PER_CHIP, 4),
        **_extras(rec),
        "traced_rays_each": rec["traced_frames"],
    }


def _extras(rec) -> dict:
    """The port's keys beside the reference's: each timed frame's CUDA-event
    time, the warm-up's, the warm-up's host time with its capture (synced),
    host wall time a frame, peak device memory (None on the CPU) and
    launches a frame."""
    return {"frame_ms_each": rec["ms"], "warmup_ms": rec["warm_ms"], "capture_ms": rec["capture_ms"],
            "host_ms_per_frame": rec["host_ms"], "peak_gib": rec["peak_gib"],
            "launches_per_frame": per_frame_of(rec)}


def run_probe_config(tag, scene, host_tris, cam, width, height, n_frames=3, hybrid=False, settings_kw=None, *,
                     device):
    """Probe-GI pipeline cost (G-buffer → SIS → probe trace → SH →
    interpolate → AgX, one compiled step a frame, captured by the warm-up);
    ``hybrid=True`` benches the hybrid probes + path-traced direct light
    pipeline."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.utils.config import RenderSettings

    dev = torch.device(device)
    backend = tk.packet_backend(host_tris=host_tris, device=dev)
    settings = RenderSettings(width=width, height=height, bounces=1, samples=1, **(settings_kw or {}))
    factory = pipelines.hybrid_gi_pipeline if hybrid else pipelines.probe_gi_pipeline
    step, init_state = factory(scene, settings, backend=backend, device=dev)
    cell = {"state": init_state()}

    def frame(i):
        disp, cell["state"] = step(cell["state"], cam, i)
        return disp

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    shown, ms_all, host_ms, first_ms = timed_calls(frame, n_frames, dev)
    disp = shown[-1]
    if tuple(disp.shape) != (height, width, 3) or not bool(disp.isfinite().all()):
        raise RuntimeError(f"{tag}: the display is not a finite [{height}, {width}, 3] image")
    ms = ms_all[1:] or ms_all[:1]
    dt = statistics.median(ms) / 1e3
    rec = dict(ms=ms, warm_ms=ms_all[0], host_ms=host_ms, capture_ms=first_ms, frames=n_frames + 1,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
               launches={k: v for k, v in tk.LAUNCHES.items() if v})
    return {"config": tag, "width": width, "height": height, "tris": int(host_tris[0].shape[0]),
            "frame_ms": round(dt * 1e3, 1), "fps": round(1.0 / dt, 2), **_extras(rec)}


class _Emitter:
    """Incremental result sink: rewrites the details file and re-prints the
    stdout headline line after every configuration, so the record is whole
    and consistent at any point past the headline."""

    def __init__(self, details: str = DEFAULT_DETAILS):
        self.details = details
        self.results = []
        self.errors = []

    def add(self, r_):
        self.results.append(r_)
        print(json.dumps(r_), file=sys.stderr, flush=True)
        self.flush()

    def fail(self, tag, exc):
        err = {"config": tag, "error": f"{type(exc).__name__}: {exc}"[:500]}
        self.errors.append(err)
        print(json.dumps(err), file=sys.stderr, flush=True)
        self.flush()

    def _by(self, tag):
        for r_ in self.results:
            if r_["config"] == tag:
                return r_
        return None

    def headline_line(self):
        head = self._by("headline")
        if head is None:
            return None
        line = {
            "metric": "mrays_per_s_per_chip",
            "value": head["mrays_per_s_per_chip"],
            "unit": "Mray/s",
            "vs_baseline": head["vs_baseline"],
            "nominal_value": head["nominal_mrays_per_s_per_chip"],
            "headline_frame_ms": head["frame_ms"],
        }
        sponza = self._by("sponza1080")
        if sponza is not None:
            line.update({"sponza1080_mrays": sponza["mrays_per_s_per_chip"],
                         "sponza1080_frame_ms": sponza["frame_ms"],
                         "sponza1080_spp_per_s": sponza["spp_per_s"]})
        s720 = self._by("sponza720")
        if s720 is not None:
            line["sponza720_spp_per_s"] = s720["spp_per_s"]
        pg = self._by("sponza720_probe_gi")
        if pg is not None:
            line["sponza720_probe_gi_fps"] = pg["fps"]
        pg1080 = self._by("sponza1080_probe_gi")
        if pg1080 is not None:
            line["sponza1080_probe_gi_fps"] = pg1080["fps"]
        return line

    def flush(self):
        if os.path.dirname(self.details):
            os.makedirs(os.path.dirname(self.details), exist_ok=True)
        with open(self.details, "w") as f:
            json.dump(list(self.results) + self.errors, f, indent=1)
        line = self.headline_line()
        if line is not None:
            print(json.dumps(line), flush=True)


def _pick_spp(ladder, per_spp_s, compile_s, n_frames, share):
    """Largest spp from ``ladder`` whose estimated cost (``compile_s`` +
    ``n_frames`` frames at ``per_spp_s`` seconds an spp, cost ~ linear in
    spp) fits ``share`` of the remaining budget."""
    for spp in ladder:
        est = compile_s + n_frames * per_spp_s * spp
        if est <= _remaining() * share:
            return spp
    return ladder[-1]


def main(argv=None) -> int:
    global _T0
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--details", default=DEFAULT_DETAILS, help="where every config's record is written")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions, for the tests)")
    args = ap.parse_args(argv)
    _T0 = time.monotonic()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card (--device cpu runs the plain versions)")
    from raytracer3_tpu_torch.scene import procedural

    em = _Emitter(args.details)

    def attempt(tag, fn):
        try:
            em.add(fn())
        except Exception as e:  # noqa: BLE001 — fail-isolated configs
            em.fail(tag, e)
        if dev.type == "cuda":
            # The config's graph (and its private memory pool) is gone with
            # its step; hand its memory back before the next config.
            torch.cuda.empty_cache()

    # --- headline (the official number) first ---
    scene, tris = procedural.atrium_scene(detail=2, return_host=True, device=dev)
    cam = procedural.atrium_camera(aspect=960 / 544, device=dev)
    attempt("headline", lambda: run_config("headline", scene, tris, cam, 960, 544, 4, device=dev))

    # --- sponza configs: the north-star scene, budget-adaptive spp ---
    probe_runs = []
    try:
        big_scene, big_tris = procedural.sponza_world_scene(8, device=dev)
        cam720 = procedural.atrium_camera(aspect=1280 / 720, device=dev)
        cam1080 = procedural.atrium_camera(aspect=1920 / 1088, device=dev)
        max720 = int(os.environ.get("RT3_BENCH_MAX_SPP720", "32"))
        ladder720 = [s for s in (32, 16, 8, 4) if s <= max720]
        # Each record says which rung its ladder gave and the budget left
        # at the pick.
        left, spp720 = _remaining(), _pick_spp(ladder720, per_spp_s=PER_SPP_S_720, compile_s=WARMUP_S_720,
                                               n_frames=2, share=0.45)
        if _remaining() > 180.0:
            attempt("sponza720", lambda: dict(run_config(
                "sponza720", big_scene, big_tris, cam720, 1280, 720, 2, samples=spp720, n_frames=2, device=dev),
                spp_ladder=ladder720, budget_left_s=left))
        left, spp1080 = _remaining(), _pick_spp(LADDER_1080, per_spp_s=PER_SPP_S_1080, compile_s=WARMUP_S_1080,
                                                n_frames=2, share=0.8)
        if _remaining() > 180.0:
            attempt("sponza1080", lambda: dict(run_config(
                "sponza1080", big_scene, big_tris, cam1080, 1920, 1088, 4, samples=spp1080, n_frames=2, device=dev),
                spp_ladder=LADDER_1080, budget_left_s=left))
        probe_runs += [
            ("sponza1080_probe_gi", big_scene, big_tris, cam1080, 1920, 1088, False, {"probe_texel_splits": 2}),
            ("sponza720_probe_gi", big_scene, big_tris, cam720, 1280, 720, False, None),
            ("sponza720_hybrid_gi", big_scene, big_tris, cam720, 1280, 720, True, None),
        ]
    except Exception as e:  # noqa: BLE001 — the scene build itself failed
        em.fail("sponza_scene", e)

    # --- probe pipelines (skipped once the budget is spent) ---
    probe_runs += [
        ("probe_gi", scene, tris, cam, 960, 544, False, None),
        ("hybrid_gi", scene, tris, cam, 960, 544, True, None),
    ]
    for tag, sc, tr, cm, w, h, hybrid, skw in probe_runs:
        if _remaining() < 120.0:
            em.fail(tag, TimeoutError("skipped: bench budget spent"))
            continue
        attempt(tag, lambda: run_probe_config(tag, sc, tr, cm, w, h, hybrid=hybrid, settings_kw=skw, device=dev))
    _finish(em)
    return 0


def _finish(em: _Emitter) -> None:
    em.flush()
    if em.headline_line() is None:
        # Headline failed: still leave a parseable record.
        print(json.dumps({"metric": "mrays_per_s_per_chip", "value": 0.0, "unit": "Mray/s", "vs_baseline": 0.0,
                          "error": (em.errors[0]["error"] if em.errors else "unknown")}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
