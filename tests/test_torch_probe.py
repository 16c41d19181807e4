"""The port's traversal probe (``raytracer3_tpu_torch.tools.perf_probe``)
and profiling helpers (``raytracer3_tpu_torch.utils.profiling``).

- The probe runs end to end on the CPU when asked (``--device cpu``, tiny
  ``--n``): the K1/K2 path with ``--stats``, the treelet path with
  ``--stats --rounds`` and the instanced path, each population with its
  visit summary; without a card and without ``--device cpu`` it exits with
  a message and a non-zero code.
- ``visit_summary``'s arithmetic on hand-made counts.
- ``pass_scope`` and ``trace`` run on the CPU and ``trace`` writes its
  chrome trace.
"""

import json
import os

import pytest
import torch

from raytracer3_tpu_torch.tools import perf_probe
from raytracer3_tpu_torch.utils import profiling as tprofiling
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


TINY = ["--device", "cpu", "--n", "1920", "--detail", "1", "--reps", "1"]


def _check_populations(out, names):
    assert out["device"] == "cpu"
    assert list(out["populations"]) == names
    for name in names:
        pop = out["populations"][name]
        assert pop["rays"] == 1920 and pop["ms"] > 0
        s = pop["stats"]
        assert s["node_pops"] >= 1 and s["slab_tests"] > s["node_pops"] and 0 < s["simt_eff"] <= 1
        assert s["bound_ms"] == max(s["op_bound_ms"], s["bytes_bound_ms"]) > 0
        assert s["bound_by"] in ("operations", "bytes") and s["row_bytes_per_ray"] > 0
    # CPU calls run the plain versions: no kernel launch is counted.
    assert all(not v for v in out["launches"].values())


def test_probe_packet_path_runs_on_cpu(capsys):
    out = perf_probe.main(TINY + ["--stats"])
    _check_populations(out, ["primary", "bounce (sorted)", "bounce (unsorted)", "shadow (sorted)"])
    text = capsys.readouterr().out
    assert "K5 shadow (sorted): per ray: node pops" in text and "not a device time" in text


def test_probe_treelet_path_runs_on_cpu(capsys):
    out = perf_probe.main(TINY + ["--treelet", "--max-tris", "2048", "--stats", "--rounds"])
    _check_populations(out, ["primary", "bounce", "shadow"])
    for name in ("bounce", "shadow"):
        pop = out["populations"][name]
        assert pop["rounds"] >= 1 and pop["rounds_mismatches"] == 0 and pop["nearest_first_mismatches"] == 0
        assert pop["layout"]["cand_max"] >= 1
    assert "bounce e_cap= 0" in capsys.readouterr().out


def test_probe_instanced_path_runs_on_cpu():
    out = perf_probe.main(TINY + ["--instanced", "--stats"])
    _check_populations(out, ["primary", "bounce (sorted)", "bounce (unsorted)", "shadow (sorted)"])
    assert out["populations"]["primary"]["stats"]["steps_or_hops"] >= 1  # instance hops


def test_probe_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would measure it")
    with pytest.raises(SystemExit) as e:
        perf_probe.main(["--n", "1920"])
    assert e.value.code not in (0, None)


def test_visit_summary_arithmetic():
    # 64 rays in two warps; K4 counts (hops in column 4).
    counts = torch.zeros((64, 5), dtype=torch.int32)
    counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3], counts[:, 4] = 4, 2, 40, 24, 1
    counts[0, 0] = 12  # one slow ray in the first warp
    s = perf_probe.visit_summary(counts, width=16, leaf_size=12, node_row_bytes=512, cluster_row_bytes=512,
                                 kind="k4", inst_row_bytes=128, out_bytes=20, table_bytes=1000)
    p = perf_probe
    ops = 64 * p.OPS_RAY + p.OPS_NODE_SLOT * 16 * (64 * 4 + 8) + p.OPS_SLAB * 40 * 64 + p.OPS_LEAF_SLOT * 12 * 2 * 64 \
        + p.OPS_TRI * 24 * 64 + p.OPS_HOP * 64
    assert s["ops"] == ops
    assert s["op_bound_ms"] == pytest.approx(ops / 67e12 * 1e3)
    assert s["bytes_bound_ms"] == pytest.approx((64 * 48 + 1000) / 3.35e12 * 1e3)
    iters = 64 * 7 + 8  # node + leaf + hop per ray
    assert s["simt_eff"] == pytest.approx(iters / (32 * (15 + 7)))
    assert s["node_pops"] == pytest.approx((64 * 4 + 8) / 64)
    assert s["row_bytes_per_ray"] == pytest.approx((512 * (64 * 4 + 8) + 512 * 128 + 128 * 64) / 64)
    assert s["bound_by"] == "operations" and s["bound_ms"] == s["op_bound_ms"]


def test_pass_scope_and_trace_on_cpu(tmp_path):
    with tprofiling.trace(str(tmp_path)) as prof:
        with tprofiling.pass_scope("rt3_probe_region"):
            torch.ones(64).cumsum(0)
    keys = {e.key for e in prof.key_averages()}
    assert "rt3_probe_region" in keys
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "rt3_probe_region" in f.read()
    with tprofiling.trace() as prof:  # no logdir: nothing written
        torch.ones(4).sum()
    assert json.loads(json.dumps({"n": len(prof.key_averages())}))["n"] >= 1
