"""Traversal probe of the port (counterpart of ``tools/perf_probe.py``): times
the traversal kernels alone on three ray populations of the atrium at
960 × (n / 960), so that a kernel change is measured without a frame around
it. The populations: tile-ordered primaries; bounce rays (random directions
from the primary hits, dead lanes parked at 1e30), coherence-sorted; shadow
rays from the primary hits toward a point above the atrium (any hit, capped
at 0.999 of the distance).

    python -m raytracer3_tpu_torch.tools.perf_probe --stats
    python -m raytracer3_tpu_torch.tools.perf_probe --treelet --detail 8 --stats --rounds
    python -m raytracer3_tpu_torch.tools.perf_probe --instanced --detail 8 --stats

- Default: K1/K2 over single-level tables (leaf 12, width 16; atrium
  ``--detail 2``, 19,188 triangles).
- ``--treelet``: K3 at ``treelets.treelet_backend``'s production settings
  (SAH treelets of ≤ 98,304 triangles, leaf 24, width 16; sorted launches in
  1,024-sublane segments of 128 groups with step_cull, primaries presorted
  in 512-sublane segments), then an ``e_cap`` sweep of the bounce.
  ``--rounds`` adds ``treelet_intersect_rounds`` and ``nearest_first`` on
  each population; ``--sweep`` rebuilds with ``max_tris`` 32,768 and 65,536.
- ``--instanced``: K4 on the instanced atrium (a shell mesh + 14 column
  instances, ``procedural.instanced_atrium``).
- ``--stats``: the K5 form of each launch. Per ray: node pops, leaf pops,
  slab tests and Möller–Trumbore tests; the least time of the launch, the
  larger of its operation side (float32 operations counted from
  csrc/traverse.cu, ``OPS_*`` below, over the card's 67 TFLOP/s) and its
  bytes side (rays in, results out, tables once, over 3.35 TB/s); SIMT
  efficiency (Σ pops / (32 · Σ per-warp max pops) over 32-ray warps in
  launch order); and the node and cluster row bytes the pops request per
  ray (a figure, not a bound: no L2 rate is published). With
  ``--treelet``, also the layout statistics of each population.

Runs on the CUDA device, timing with CUDA events (median of ``--reps``
after a warm-up). Without a device it exits non-zero unless ``--device
cpu`` is given, which runs the plain versions and prints host-clock times
that are not device times.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W).
FP32_PEAK = 67e12  # float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
RAY_IN_BYTES = 28  # origin, direction, t cap (float32)

# Float32 operations per visit, counted in csrc/traverse.cu: each add,
# subtract, multiply, divide, min, max, compare and abs is one operation
# (built with --fmad=false, none fuses, so the card issues at most half the
# 67 TFLOP/s that counts a fused multiply-add as two; the bound is the
# published peak's all the same).
OPS_RAY = 9  # the clamped inverse direction: 3 × (abs, compare, divide)
OPS_NODE_SLOT = 3  # the empty-slot test, every slot of a popped node: add, abs, compare
OPS_SLAB = 26  # a real slot: 6 subtracts, 6 multiplies, 12 min/max, the take test (2)
OPS_LEAF_SLOT = 1  # the padding test, every slot of a popped leaf
OPS_TRI = 53  # Möller–Trumbore: 2 cross products (12 mul, 6 sub), det (3 mul, 2 add), |det| test (2),
# 1 divide, 3 subtracts, 3 dots with their 1/det scale (3 × (4 mul, 2 add)), 6 accept operations
OPS_HOP = 42  # K4 instance hop: origin and direction through the 3×4 (18 mul, 15 add), inverse (9)
OPS_STEP = 1  # K3 step traversed: the step_cull compare

TARGET = (0.0, 8.0, 0.0)  # the shadow rays' point above the atrium


def visit_summary(counts: torch.Tensor, width: int, leaf_size: int, node_row_bytes: int,
                  cluster_row_bytes: int, *, kind: str = "k12", inst_row_bytes: int = 0,
                  out_bytes: int = 16, table_bytes: int = 0) -> dict:
    """K5 counts [N, 5] of one launch (``kind`` "k12", "k3" or "k4") →
    per-ray means, the operation and bytes sides of the launch's least
    time (ms), the side that bounds it, SIMT efficiency and row bytes
    requested per ray."""
    n = max(int(counts.shape[0]), 1)
    node, leaf, slab, tri, extra = counts.to(torch.float64).sum(dim=0).tolist()
    ops = (OPS_RAY * counts.shape[0] + OPS_NODE_SLOT * width * node + OPS_SLAB * slab
           + OPS_LEAF_SLOT * leaf_size * leaf + OPS_TRI * tri)
    if kind == "k4":
        ops += OPS_HOP * extra
    elif kind == "k3":
        ops += OPS_STEP * extra
    op_ms = ops / FP32_PEAK * 1e3
    bytes_ms = (counts.shape[0] * (RAY_IN_BYTES + out_bytes) + table_bytes) / HBM_BYTES_PER_S * 1e3
    iters = counts[:, 0].to(torch.int64) + counts[:, 1]
    if kind == "k4":
        iters = iters + counts[:, 4]
    warps = torch.nn.functional.pad(iters, (0, (-iters.shape[0]) % 32)).reshape(-1, 32)
    busy = float(warps.amax(dim=1).sum()) * 32
    row_bytes = node_row_bytes * node + cluster_row_bytes * leaf + (inst_row_bytes * extra if kind == "k4" else 0)
    from raytracer3_tpu_torch.ops.traverse_kernel import STAT_COLUMNS

    return dict(
        zip(STAT_COLUMNS, (node / n, leaf / n, slab / n, tri / n, extra / n)),
        rays=int(counts.shape[0]), ops=ops, op_bound_ms=op_ms, bytes_bound_ms=bytes_ms,
        bound_ms=max(op_ms, bytes_ms), bound_by="operations" if op_ms >= bytes_ms else "bytes",
        simt_eff=float(iters.sum()) / busy if busy else 1.0, row_bytes_per_ray=row_bytes / n,
    )


def summary_line(s: dict, ms=None) -> str:
    extra = f" steps/hops {s['steps_or_hops']:.2f}" if s["steps_or_hops"] else ""
    above = f", {ms / s['bound_ms']:.1f}x above" if ms is not None else ""
    return (f"per ray: node pops {s['node_pops']:.2f} leaf pops {s['leaf_pops']:.2f} slab tests "
            f"{s['slab_tests']:.1f} tri tests {s['tri_tests']:.1f}{extra}; {s['ops']:.4g} ops -> "
            f"{s['op_bound_ms']:.4f} ms, bytes {s['bytes_bound_ms']:.4f} ms: bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']}{above}); SIMT efficiency {s['simt_eff']:.3f}; row bytes "
            f"{s['row_bytes_per_ray']:.0f}/ray")


def _timer(device: torch.device, reps: int):
    """fn → ms: CUDA events (median of reps after a warm-up) on the card;
    the host clock (one run) on the CPU."""
    if device.type == "cuda":
        def t(fn):
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
    else:
        def t(fn):
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
    return t


def _primaries(n: int, device):
    from raytracer3_tpu_torch.render import camera as camera_mod
    from raytracer3_tpu_torch.render import wavefront
    from raytracer3_tpu_torch.scene import procedural

    w = 960
    h = max(1, n // w)
    cam = procedural.atrium_camera(aspect=960 / 544, device=device)
    tile = wavefront.pick_tile(w, h)
    pix = (wavefront.tiled_pixel_order(w, h, *tile, device=device) if tile
           else camera_mod.pixel_grid(w, h, device=device))
    jitter = torch.full((pix.shape[0], 2), 0.5, device=device)
    o, d = camera_mod.primary_rays(cam, w, h, jitter=jitter, pixel_xy=pix)
    return o.contiguous(), d.contiguous()


def _secondaries(o, d, hit):
    """(bounce origins, bounce directions, alive, shadow directions, light
    distance) from the primary hits; random directions from numpy seed 0."""
    n = o.shape[0]
    dirs = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = torch.as_tensor(dirs, device=o.device)
    alive = hit.hit
    hp = o + hit.t[:, None] * d
    o2 = torch.where(alive[:, None], hp, 1e30)
    to_l = torch.tensor(TARGET, dtype=torch.float32, device=o.device)[None, :] - hp
    dist = torch.linalg.norm(to_l, dim=-1)
    sd = to_l / torch.clamp_min(dist, 1e-6)[:, None]
    return o2, dirs, alive, sd, dist


class _Report:
    """Prints the probe's lines and keeps them as a dict for callers."""

    def __init__(self, device):
        self.device = device
        self.unit = "ms" if device.type == "cuda" else "ms host clock (CPU plain version, not a device time)"
        self.out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                    "populations": {}, "launches": {}}

    def time_line(self, name: str, n: int, ms: float, extra: str = "") -> None:
        self.out["populations"].setdefault(name, {}).update(rays=n, ms=ms)
        print(f"{name:22s}: {ms:9.4f} {self.unit}  {n / ms / 1e3:8.2f} Mray/s{extra}", flush=True)

    def stats_line(self, name: str, s: dict, stats_ms: float, ms: float) -> None:
        self.out["populations"].setdefault(name, {}).update(stats=s, stats_ms=stats_ms)
        # A host-clock time on the CPU is no device time: no ratio to the bound.
        ratio_ms = ms if self.device.type == "cuda" else None
        print(f"  K5 {name}: {summary_line(s, ratio_ms)}; stats launch {stats_ms:.4f} {self.unit}", flush=True)


class _Launches:
    """Kernel launches of one section of the probe (``LAUNCHES`` deltas)."""

    def __init__(self, report: _Report, section: str):
        self.report, self.section = report, section

    def __enter__(self):
        from raytracer3_tpu_torch.ops import traverse_kernel as tk

        self.before = dict(tk.LAUNCHES)

    def __exit__(self, *exc):
        from raytracer3_tpu_torch.ops import traverse_kernel as tk

        self.report.out["launches"][self.section] = {
            k: v - self.before[k] for k, v in tk.LAUNCHES.items() if v != self.before[k]}


def run_packet(args, tris, device, t, rep: _Report, instanced=None):
    """K1/K2 (or K4 on ``instanced`` two-level tables) on the three
    populations."""
    from raytracer3_tpu_torch.ops import cluster_bvh as cb_mod
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import wavefront

    t0 = time.perf_counter()
    if instanced is None:
        cb = cb_mod.build_cluster_bvh_host(*tris, args.leaf or 12, width=args.width, cluster_mode="sah")
        pt = tk.tables_from_numpy(tk.pack_tables_host(cb), device)
        kind, out_bytes, tables = "k12", 16, (pt.node_table, pt.cluster_table)
    else:
        pt = instanced
        kind, out_bytes, tables = "k4", 20, (pt.node_table, pt.cluster_table, pt.inst_table)
    print(f"tables: {pt.num_nodes} nodes, {pt.num_clusters} clusters of <= {pt.leaf_size}, width {pt.width}, "
          f"depth {pt.depth} ({time.perf_counter() - t0:.2f} s)", flush=True)
    table_bytes = sum(x.numel() * 4 for x in tables)
    geo = dict(width=pt.width, leaf_size=pt.leaf_size, node_row_bytes=pt.node_table.shape[1] * 4,
               cluster_row_bytes=pt.cluster_table.shape[1] * 4, kind=kind, out_bytes=out_bytes,
               table_bytes=table_bytes,
               inst_row_bytes=pt.inst_table.shape[1] * 4 if pt.inst_table is not None else 0)

    o, d = _primaries(args.n, device)
    hit = tk.packet_intersect(pt, o, d)
    o2, dirs, alive, sd, dist = _secondaries(o, d, hit)
    perm = torch.argsort(wavefront.sort_key_pos_dir(o2, dirs, alive), stable=True)
    pops = [
        ("primary", o, d, tk._BG, False),
        ("bounce (sorted)", o2[perm].contiguous(), dirs[perm].contiguous(), tk._BG, False),
        ("bounce (unsorted)", o2.contiguous(), dirs, tk._BG, False),
        ("shadow (sorted)", o2[perm].contiguous(), sd[perm].contiguous(), (dist[perm] * 0.999).contiguous(), True),
    ]
    for name, po, pd, cap, any_hit in pops:
        with _Launches(rep, name):
            ms = t(lambda: tk.packet_intersect(pt, po, pd, t_max=cap, any_hit=any_hit))
            rep.time_line(name, po.shape[0], ms)
            if args.stats:
                _, counts = tk.packet_intersect(pt, po, pd, t_max=cap, any_hit=any_hit, stats=True)
                stats_ms = t(lambda: tk.packet_intersect(pt, po, pd, t_max=cap, any_hit=any_hit, stats=True))
                rep.stats_line(name, visit_summary(counts, **geo), stats_ms, ms)


def _treelet_tables(tris, args, max_tris, device):
    from raytracer3_tpu_torch.ops import treelets

    t0 = time.perf_counter()
    tt = treelets.tables_to_device(treelets.build_treelets_host(
        *tris, args.leaf or 24, width=args.width, max_tris=max_tris, partition="sah", cluster_mode="sah"), device)
    print(f"treelets: K={tt.num_treelets}, max_tris {max_tris}, {tt.max_nodes} node and {tt.max_clusters} "
          f"cluster rows each, depth {tt.depth} ({time.perf_counter() - t0:.2f} s)", flush=True)
    return tt


def run_treelet(args, tris, device, t, rep: _Report):
    """K3 through the production treelet driver on the three populations."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.ops import treelets

    tt = _treelet_tables(tris, args, args.max_tris or 98304, device)
    k = tt.num_treelets
    table_bytes = sum(x.numel() * 4 for x in (tt.node_tables, tt.cluster_tables, tt.aabb))
    geo = dict(width=tt.width, leaf_size=tt.leaf_size, node_row_bytes=tt.node_tables.shape[2] * 4,
               cluster_row_bytes=tt.cluster_tables.shape[2] * 4, kind="k3", table_bytes=table_bytes)
    sorted_kw = dict(sublanes=1024, max_groups=treelets.MAX_GROUPS_SORTED, step_cull=True)
    if args.n < 1024 * 128:  # tiny probes (tests): segments that the rays fill
        sorted_kw["sublanes"] = 8
    primary_kw = dict(sorted_kw, sublanes=min(512, sorted_kw["sublanes"]), max_groups=treelets.MAX_GROUPS_PRIMARY,
                      presorted=True)

    o, d = _primaries(args.n, device)
    bg = torch.full((o.shape[0],), tk._BG, device=device)
    prim = treelets.treelet_intersect(tt, o, d, **primary_kw)
    o2, dirs, alive, sd, dist = _secondaries(o, d, prim)
    cap = torch.where(alive, 1e5, 0.0)
    scap = torch.where(alive, dist * 0.999, 0.0)
    pops = [
        ("primary", o, d, bg, False, primary_kw),
        ("bounce", o2, dirs, cap, False, sorted_kw),
        ("shadow", o2, sd, scap, True, sorted_kw),
    ]
    single = {}
    for name, po, pd, pc, any_hit, kw in pops:
        with _Launches(rep, name):
            sl = treelets.segment_launch(tt, po, pd, t_max=pc, any_hit=any_hit, **kw)
            ms = t(lambda: sl.launch(tt))
            drv = t(lambda: treelets.treelet_intersect(tt, po, pd, t_max=pc, any_hit=any_hit, **kw))
            rep.time_line(name, po.shape[0], ms,
                          f"  ({sl.seg_list.shape[0]} segments x {sl.seg_list.shape[1]} steps; "
                          f"driver + kernel + un-sort {drv:.3f} ms)")
            rep.out["populations"][name]["driver_ms"] = drv
            single[name] = treelets.finish(sl, sl.launch(tt))
            if args.stats:
                _, counts = sl.launch(tt, stats=True)
                stats_ms = t(lambda: sl.launch(tt, stats=True))
                rep.stats_line(name, visit_summary(counts, **geo), stats_ms, ms)
                lay = treelets.treelet_layout_stats(tt, po, pd, pc, sublanes=kw["sublanes"])
                rep.out["populations"][name]["layout"] = lay
                print(f"  layout {name}: candidates {lay['cand_mean']:.2f}/{lay['cand_max']} per ray, union "
                      f"{lay['union_mean']:.2f}/{lay['union_max']} per segment, steps {lay['steps']} over "
                      f"{lay['segments']} segments", flush=True)

    # e_cap sweep on the bounce: cap 0 is the grid alone (every step
    # skipped); rising caps show time tracking the union depth (hits drop).
    for cap_i in (0, 1, 2, 4, 8, 16):
        if cap_i >= k:
            break
        sl = treelets.segment_launch(tt, o2, dirs, t_max=cap, e_cap=cap_i, **sorted_kw)
        print(f"  bounce e_cap={cap_i:2d}: {t(lambda: sl.launch(tt)):9.4f} {rep.unit}", flush=True)

    if args.rounds:
        for name, po, pd, pc, any_hit, kw in pops[1:]:
            with _Launches(rep, f"{name} rounds"):
                ms = t(lambda: treelets.treelet_intersect_rounds(tt, po, pd, t_max=pc, any_hit=any_hit))
                got, rounds = treelets.treelet_intersect_rounds(tt, po, pd, t_max=pc, any_hit=any_hit,
                                                                return_rounds=True)
                rounds = int(rounds)  # a 0-d tensor on the card, read after the call
            nf_kw = {key: v for key, v in kw.items() if key != "presorted"}
            with _Launches(rep, f"{name} nearest_first"):
                nf_ms = t(lambda: treelets.treelet_intersect(tt, po, pd, t_max=pc, any_hit=any_hit,
                                                             nearest_first=True, **nf_kw))
                nf = treelets.treelet_intersect(tt, po, pd, t_max=pc, any_hit=any_hit, nearest_first=True, **nf_kw)
            ref = single[name]
            mism = int((got.hit != ref.hit).sum())
            nf_mism = int((nf.hit != ref.hit).sum())
            rep.out["populations"][name].update(rounds_ms=ms, rounds=rounds, rounds_mismatches=mism,
                                                nearest_first_ms=nf_ms, nearest_first_mismatches=nf_mism)
            print(f"{name + ' rounds':22s}: {ms:9.4f} {rep.unit}  {po.shape[0] / ms / 1e3:8.2f} Mray/s  "
                  f"({rounds} rounds, hit mask differs from the single pass on {mism}); nearest_first "
                  f"{nf_ms:.4f} (differs on {nf_mism})", flush=True)

    if args.sweep:
        for mt in (32768, 65536):
            tt2 = _treelet_tables(tris, args, mt, device)
            for name, po, pd, pc, any_hit, kw in pops[1:]:
                sl = treelets.segment_launch(tt2, po, pd, t_max=pc, any_hit=any_hit, **kw)
                rep.time_line(f"{name} max_tris {mt}", po.shape[0], t(lambda: sl.launch(tt2)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--detail", type=int, default=2)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--leaf", type=int, default=None, help="leaf size (12; 24 for --treelet)")
    ap.add_argument("--n", type=int, default=960 * 544)
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--treelet", action="store_true")
    ap.add_argument("--instanced", action="store_true")
    ap.add_argument("--max-tris", type=int, default=None, help="treelet size (98,304)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rounds", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("perf_probe: no CUDA device; the probe measures the card "
                         "(--device cpu runs the plain versions instead)")
    from raytracer3_tpu_torch.scene import procedural

    rep = _Report(device)
    t = _timer(device, args.reps)
    print(f"device {rep.out['device']}", flush=True)
    if args.instanced:
        from raytracer3_tpu_torch.ops import tlas

        shell, column, transforms = procedural.instanced_atrium(args.detail)
        meshes = [dict(positions=m["positions"], indices=m["indices"]) for m in (shell, column)]
        insts = [(0, np.eye(4, dtype=np.float32))] + [(1, m) for m in transforms]
        print(f"instanced atrium: shell {len(shell['indices'])} tris x1 + column {len(column['indices'])} tris "
              f"x{len(transforms)}", flush=True)
        pt, _ = tlas.two_level_backend(meshes, insts, leaf_size=args.leaf or 12, width=args.width,
                                       device=device).meta
        run_packet(args, None, device, t, rep, instanced=pt)
        return rep.out
    kw = procedural.atrium(detail=args.detail)
    pos, idx = kw["positions"], kw["indices"]
    tris = (pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]])
    print(f"atrium detail={args.detail}: {idx.shape[0]} tris", flush=True)
    if args.treelet:
        run_treelet(args, tris, device, t, rep)
    else:
        run_packet(args, tris, device, t, rep)
    return rep.out


if __name__ == "__main__":
    main()
