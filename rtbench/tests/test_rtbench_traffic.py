"""The seeded camera paths repeat for a seed, differ between seeds and stay
inside the atrium's aisle."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from rtbench import traffic
from rtbench.tests import helpers


def _mix(name):
    with open(os.path.join(helpers.ROOT, "rtbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _path(params, seed, n):
    s = traffic.Schedule(params, seed)
    pos = np.asarray(s.start_position, np.float64)
    fwd = np.asarray(s.start_direction, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    out = [pos]
    for k in range(n):
        ctl = s.controls(k)
        if any(abs(v) > 1e-9 for v in ctl):
            pos, fwd = traffic._step(pos, fwd, ctl, params["move_speed"] * params["dt"])
        out.append(pos)
    return s, np.stack(out)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3_000_000_017])
def test_walk_repeats_for_a_seed_and_stays_inside(seed):
    p = _mix("walk1")
    s1, a = _path(p, seed, 600)
    s2, b = _path(p, seed, 600)
    assert np.array_equal(a, b) and s1.start_direction == s2.start_direction
    lo, hi = (np.asarray(x) for x in p["bounds"])
    assert (a >= lo - 1e-6).all() and (a <= hi + 1e-6).all()
    ctls = [s1.controls(k) for k in range(600)]
    moving = [any(abs(v) > 1e-9 for v in c) for c in ctls]
    assert not moving[0]  # a still period first
    # Runs of moving and still frames fall in the mix's ranges.
    runs, cur, n = [], moving[0], 0
    for m in moving:
        if m == cur:
            n += 1
        else:
            runs.append((cur, n))
            cur, n = m, 1
    for is_move, n in runs:
        lo_n, hi_n = p["burst_frames"] if is_move else p["still_frames"]
        assert lo_n <= n <= hi_n


def test_walks_differ_between_seeds():
    p = _mix("walk1")
    _, a = _path(p, 1, 200)
    _, b = _path(p, 2, 200)
    assert not np.array_equal(a, b)


def test_still_never_moves():
    p = _mix("still16")
    s, a = _path(p, 99, 300)
    assert (a == a[0]).all()
    lo, hi = (np.asarray(x) for x in p["bounds"])
    assert (a[0] >= lo).all() and (a[0] <= hi).all()


def test_pixel_sample_is_seeded_and_distinct():
    a = traffic.pixel_sample(5, 4096, 1088, 1920)
    assert np.array_equal(a, traffic.pixel_sample(5, 4096, 1088, 1920))
    assert len(np.unique(a)) == 4096 and a.min() >= 0 and a.max() < 1088 * 1920
    assert not np.array_equal(a, traffic.pixel_sample(6, 4096, 1088, 1920))
