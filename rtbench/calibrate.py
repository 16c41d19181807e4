"""The readings that a cell's limits are set from (``limits/<cell>.json``),
in one process on the card; the benchmark's own runs never run this.

    python3 rtbench/calibrate.py --workload <name> --seconds <s> --seeds 11 12 13 ... [--control 3]

For each seed: a fresh ``Viewer`` on the one program (its graph captured
once), the warm-up and a window of ``--seconds`` as a run makes them, then
the check's numbers of the program against the reference, and for the
first ``--control`` seeds the control's: the reference computed with its
colour state in bfloat16, put in the program's place. ``--faults``
seconds then runs each fault of ``faults.py`` planted in the program on
the first three seeds, with windows of that length. One JSON line a seed
(and a fault) on standard output."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seeds, seconds: float, device, control: int = 0, frame_wrapper=None):
    """One dict a seed: frames, the program's numbers, the control's (the
    first ``control`` seeds) and the reference's seconds."""
    import torch

    from rtbench import check, inputs, program, traffic

    dev = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    mesh, sky, bn = inputs.scene_inputs(cfg)
    prog = program.Program(cfg, tr, mesh, sky, bn, dev, cell.frame, frame_wrapper=frame_wrapper)
    state = cell.frame.reference_state(mesh, sky, dev)
    r = cfg["render"]
    out = []
    for i, seed in enumerate(seeds):
        schedule = traffic.Schedule(tr, seed)
        viewer = prog.viewer(schedule)
        base = program.warm_up(viewer, schedule)
        pix = torch.as_tensor(traffic.pixel_sample(seed, tr["check_pixels"], r["height"], r["width"]), device=dev)
        rec = program.run_window(viewer, schedule, seconds, pix, base, cell.frame.colour_state)
        del viewer
        t = time.perf_counter()
        sound = check.compare(cell.frame, cfg, tr, mesh, sky, bn, schedule, rec, pix, dev, state=state)
        row = {"seed": seed, "frames": len(rec.call), "compared": len(rec.gathered),
               "reference_s": time.perf_counter() - t, "program": _short(sound)}
        if i < control:
            row["control"] = _short(check.compare(cell.frame, cfg, tr, mesh, sky, bn, schedule, rec, pix, dev,
                                                  colour_dtype=torch.bfloat16, state=state))
        out.append(row)
    return out


def _short(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if k != "per_frame_bad_pct"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of the program and of the control for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0, help="seeds (the first ones) that also read the control")
    ap.add_argument("--faults", type=float, default=0.0, help="window seconds of the fault runs (0: none)")
    args = ap.parse_args(argv)
    from rtbench import run, spec

    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for row in readings(cell, args.seeds, args.seconds, "cuda", args.control):
        print(json.dumps(row), flush=True)
    if args.faults:
        from rtbench import faults

        for name, wrap in faults.FAULTS.items():
            for row in readings(cell, args.seeds[:3], args.faults, "cuda", frame_wrapper=wrap):
                print(json.dumps(dict(row, fault=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
