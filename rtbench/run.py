"""One run of one cell of the benchmark on the card:

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's scene as a ``World`` of the port, its backend and
the compiled frame of the configuration's frame path (``frames/<name>.py``),
captures the frame's one graph and renders one warm frame; the window then
steps the ``Viewer`` in a closed loop for ``--seconds``. With ``--trace 0``
the last line of standard output carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from ``torch.profiler`` over
a stretch of the window and from the frame function's traced-ray count
over that stretch. After the window the program is freed and the frames
are checked against the frame path's plain reference (``rtbench/check.py``);
the numbers compared and their limits end standard error and the result
line.

Exits 3 with no result without a CUDA device (or fewer than the cell
asks for), and 4 if a JAX module is loaded once the window has closed.
Every cache the run writes is under the checkout's ``build/``."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer3_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def cache_env(root: str = ROOT):
    """Fixed build and kernel-cache directories inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["RT3_ASSET_CACHE"] = os.path.join(root, "build", "assets")
    os.environ["USE_FLAX"] = "0"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float, age0: float = 0.0,
             frame_wrapper=None, log=print):
    """Set-up, window, metrics and check of one cell; returns the result
    dict (the check's numbers under ``checks``, last) and the lines to end
    standard error with."""
    import torch

    from rtbench import check, inputs, program, tracing, traffic, window

    dev = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    mesh, sky, bn = inputs.scene_inputs(cfg)
    schedule = traffic.Schedule(tr, seed)
    prog = program.Program(cfg, tr, mesh, sky, bn, dev, cell.frame, frame_wrapper=frame_wrapper)
    viewer = prog.viewer(schedule)
    base = program.warm_up(viewer, schedule)
    r = cfg["render"]
    pix = torch.as_tensor(traffic.pixel_sample(seed, tr["check_pixels"], r["height"], r["width"]), device=dev)
    stretch = int(tr["trace_frames"]) if trace else 0
    setup_s = time.perf_counter() - t_start + age0
    rec = program.run_window(viewer, schedule, seconds, pix, base, cell.frame.colour_state, stretch_frames=stretch,
                             profile_fn=tracing.profiler)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    ks = window.done_in_window(rec.done, rec.t_end)
    gaps = sorted((b - a) * 1e3 for a, b in zip([rec.t0] + [rec.done[k] for k in ks[:-1]], [rec.done[k] for k in ks]))
    if gaps:
        log(f"window: {len(rec.call)} frames, {len(ks)} done in it; ms between displays p50 "
            f"{window.percentile(gaps, 50)}, p95 {window.percentile(gaps, 95)}, max {gaps[-1]}", file=sys.stderr)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values, breakdown, by_kind = {}, None, None
    if not trace:
        e2e = {"frame_ms": window.frame_ms(rec.t0, rec.done, rec.t_end),
               "latency_ms_p95": window.latency_ms_p95(rec.call, rec.done, rec.t_end),
               "peak_gib": peak / 2**30 if cuda else None, "setup_s": setup_s}
        values = {m["name"]: e2e.get(m["name"]) for m in cell.end_to_end}
    else:
        st = rec.stretch
        if st is None:
            raise RuntimeError("the window closed before its traced stretch began")
        path = os.path.join(ROOT, "build", "rtbench", "trace", "stretch.json")
        ctx = tracing.context(tracing.events(st["profile"], path), len(st["cams"]), [st["rays"]], kind,
                              passes=getattr(cell.frame, "PASSES", None))
        from rtbench import spec

        values = {m["name"]: spec.metric_reader(m["name"])(ctx) for m in cell.per_layer}
        busy_s, window_s = tracing.busy_window_s(ctx)
        device_info.update(busy_s=busy_s, window_s=window_s)
        breakdown = tracing.breakdown(ctx)
        by_kind = tracing.kinds(ctx)
        log(f"stretch: {len(st['cams'])} frames, traced rays {st['rays']}, busy {busy_s} s of {window_s} s",
            file=sys.stderr)

    # The program's state goes before the reference runs.
    n_frames = len(rec.call)
    done_all = all(t is not None for t in rec.done)
    del viewer, prog
    rec.stretch = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = check.compare(cell.frame, cfg, tr, mesh, sky, bn, schedule, rec, pix, dev)
    log(f"reference: {n_frames} frames, {len(rec.gathered)} compared, {time.perf_counter() - t_ref:.2f} s",
        file=sys.stderr)
    ok, lines, failed = check.judge(readings, cell.limits)
    failed += 0 if done_all else 1
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    result = {"correct": bool(ok and done_all), "attempted": n_frames, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
        result["kernel_kinds_ms"] = by_kind
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in lines}
    return result, [f"check {name} {v!r} limit {lim!r}" for name, v, lim in lines]


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the benchmark on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    age0 = process_age_s()
    cache_env()

    from rtbench import spec

    try:
        cell = spec.cell(args.workload)
    except (OSError, KeyError) as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    try:
        result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, age0)
    except ForbiddenModules as e:
        print(f"rtbench: JAX modules loaded: {e.args[0]}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"rtbench: JAX modules loaded: {found}", file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
