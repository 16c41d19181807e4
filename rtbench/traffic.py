"""The one traffic generator: a traffic mix's parameters (``traffic/<name>.json``)
and a seed make the camera's start pose and its controls for every frame,
as a user at the viewer would give them, and the sample of pixels that the
check compares.

A mix alternates still periods (``still_frames``: the camera stands, the
film converges) and bursts (``burst_frames``: each frame orbits by a yaw
and strafes and walks at the viewer's speed, so the viewer resets the
film), starting with a still period; ``burst_frames`` of [0, 0] stands
still for good. Each burst's move is drawn from the seed and tried against
``bounds`` on a float64 copy of the viewer's camera update; a move that
would leave them is drawn again, and after 64 draws the burst walks toward
the bounds' centre. Every parameter comes from the file; the seed only
draws from the ranges it gives."""

from __future__ import annotations

import numpy as np

_UP = np.array([0.0, 1.0, 0.0])


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def _unit(v):
    return v / np.linalg.norm(v)


def _step(pos, fwd, ctl, speed_dt):
    """The viewer's camera update (``camera.orbit_camera``, pitch 0) in
    float64: yaw about +y, then a move along the old basis."""
    mx, my, mz, look_dx, _ = ctl
    right = _unit(np.cross(fwd, _UP))
    up = np.cross(right, fwd)
    yaw = -look_dx
    c, s = np.cos(yaw), np.sin(yaw)
    f1 = _unit(np.array([c * fwd[0] + s * fwd[2], fwd[1], -s * fwd[0] + c * fwd[2]]))
    return pos + (mx * right + my * up + mz * fwd) * speed_dt, f1


class Schedule:
    """Start pose and per-frame controls ``(move_x, move_y, move_z,
    look_dx, look_dy)`` of one seed."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self._rng = _rng(seed, 0)
        jp = np.asarray(params["start_jitter"]["position"], np.float64)
        jy = float(params["start_jitter"]["yaw"])
        pos = np.asarray(params["start_position"], np.float64) + self._rng.uniform(-jp, jp)
        d = _unit(np.asarray(params["start_direction"], np.float64))
        yaw = self._rng.uniform(-jy, jy)
        c, s = np.cos(yaw), np.sin(yaw)
        d = np.array([c * d[0] + s * d[2], d[1], -s * d[0] + c * d[2]])
        self.start_position = [float(x) for x in pos.astype(np.float32)]
        self.start_direction = [float(x) for x in d.astype(np.float32)]
        self._pos, self._fwd = pos, _unit(d)
        self._lo, self._hi = (np.asarray(b, np.float64) for b in params["bounds"])
        self._speed_dt = float(params["move_speed"]) * float(params["dt"])
        self._controls: list = []
        self._still_next = True

    @property
    def dt(self) -> float:
        return float(self.p["dt"])

    def controls(self, k: int) -> tuple:
        while len(self._controls) <= k:
            self._extend()
        return self._controls[k]

    def _inside(self, pos) -> bool:
        return bool(np.all(pos >= self._lo) and np.all(pos <= self._hi))

    def _extend(self):
        lo_b, hi_b = self.p["burst_frames"]
        if self._still_next or hi_b <= 0:
            lo_s, hi_s = self.p["still_frames"]
            n = int(self._rng.integers(lo_s, hi_s + 1))
            self._controls += [(0.0, 0.0, 0.0, 0.0, 0.0)] * n
            self._still_next = False
            return
        self._still_next = True
        n = int(self._rng.integers(lo_b, hi_b + 1))
        for _ in range(64):
            ctl = (float(self._rng.uniform(*self.p["strafe"])), 0.0, float(self._rng.uniform(*self.p["forward"])),
                   -float(self._rng.uniform(*self.p["yaw_per_frame"])), 0.0)
            path = self._walk(ctl, n)
            if path is not None:
                break
        else:
            # Toward the centre of the bounds, in the camera's frame.
            to_c = (self._lo + self._hi) / 2.0 - self._pos
            right = _unit(np.cross(self._fwd, _UP))
            scale = 1.0 / max(np.abs(to_c).max(), 1e-9)
            ctl = (float(np.dot(to_c, right) * scale), 0.0, float(np.dot(to_c, self._fwd) * scale), 0.0, 0.0)
            path = self._walk(ctl, n, check=False)
        self._pos, self._fwd = path
        self._controls += [tuple(float(np.float32(c)) for c in ctl)] * n

    def _walk(self, ctl, n: int, check: bool = True):
        pos, fwd = self._pos, self._fwd
        for _ in range(n):
            pos, fwd = _step(pos, fwd, ctl, self._speed_dt)
            if check and not self._inside(pos):
                return None
        return pos, fwd


def pixel_sample(seed: int, count: int, height: int, width: int) -> np.ndarray:
    """``count`` distinct flat pixel indices (row-major, sorted) drawn from
    the seed: the pixels whose film and display the check compares."""
    count = min(int(count), height * width)
    return np.sort(_rng(seed, 1).choice(height * width, size=count, replace=False)).astype(np.int64)
