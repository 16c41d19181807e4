"""The port's app utilities against the JAX reference: checkpoints
(``utils/checkpoint.py``), the settings tuner (``app/tuner.py``), the MJPEG
preview (``app/preview.py``) and device reporting (``utils/runtime.py``).

- A checkpoint round-trips the film, camera, probe state and extras; the
  version guard refuses another format; a file written by either package
  loads in the other, every array bit-equal.
- ``tests/test_tuner.py``'s six cases on the port, and the port's knob sets
  are the reference's.
- The preview serves ``/`` and, after a publish while a client streams,
  ``/frame.jpg`` over 127.0.0.1 on a port picked by the system; without a
  client it wants no frame and publishes nothing.
"""

import http.client
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.app import tuner as jtuner
from raytracer3_tpu.render import film as jfilm
from raytracer3_tpu.render import probes as jprobes
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.utils import checkpoint as jcheckpoint
from raytracer3_tpu_torch.app import preview as tpreview
from raytracer3_tpu_torch.app import tuner as ttuner
from raytracer3_tpu_torch.app.tuner import DynamicState, SettingsTuner
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import film as tfilm
from raytracer3_tpu_torch.render import probes as tprobes
from raytracer3_tpu_torch.utils import checkpoint as tcheckpoint
from raytracer3_tpu_torch.utils import runtime as truntime
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

CPU = torch.device("cpu")


def _port_state(seed=3):
    rng = np.random.default_rng(seed)
    settings = RenderSettings(width=32, height=32)
    film = tfilm.Film(accum=torch.from_numpy(rng.random((32, 32, 3), dtype=np.float32)), frame_index=17)
    cam = tcamera.camera_from_numpy(janalytic.default_camera()._asdict(), "cpu")
    ps = tprobes.ProbeState.create(settings, device=CPU)
    ps = tprobes.ProbeState(*(torch.from_numpy(rng.random(tuple(x.shape), dtype=np.float32)) for x in ps))
    return film, cam, ps


def _assert_tensors_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# utils/checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    film, cam, ps = _port_state()
    p = str(tmp_path / "ckpt.npz")
    tcheckpoint.save(p, film, cam, ps, extra={"spp": np.asarray(17), "note": torch.arange(3)})
    film2, cam2, ps2, extra = tcheckpoint.load(p, device=CPU)
    assert torch.equal(film2.accum, film.accum) and film2.frame_index == 17
    for a, b in zip(cam2, cam):
        assert torch.equal(a, b)
    assert ps2 is not None and all(torch.equal(a, b) for a, b in zip(ps2, ps))
    assert int(extra["spp"]) == 17 and extra["note"].tolist() == [0, 1, 2]
    assert not (tmp_path / "ckpt.npz.tmp.npz").exists()
    # Without probe state the loader returns None for it.
    tcheckpoint.save(p, film, cam)
    assert tcheckpoint.load(p, device=CPU)[2] is None


def test_checkpoint_version_guard(tmp_path):
    p = str(tmp_path / "bad.npz")
    np.savez(p, **{"__version__": np.asarray(999)})
    with pytest.raises(ValueError, match="version"):
        tcheckpoint.load(p, device=CPU)
    assert tcheckpoint.FORMAT_VERSION == jcheckpoint.FORMAT_VERSION == 1


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(5)
    settings = RenderSettings(width=32, height=32)
    jf = jfilm.Film(accum=jnp.asarray(rng.random((32, 32, 3), dtype=np.float32)), frame_index=jnp.asarray(9, jnp.int32))
    jc = janalytic.default_camera()
    jp = jprobes.ProbeState(*(jnp.asarray(rng.random(x.shape, dtype=np.float32))
                              for x in jprobes.ProbeState.create(settings)))
    p = str(tmp_path / "ref.npz")
    jcheckpoint.save(p, jf, jc, jp, extra={"spp": np.asarray(9)})
    film, cam, ps, extra = tcheckpoint.load(p, device=CPU)
    _assert_tensors_equal(film.accum, jf.accum)
    assert film.frame_index == 9
    for name in tcamera.Camera._fields:
        _assert_tensors_equal(getattr(cam, name), getattr(jc, name))
    for name in tprobes.ProbeState._fields:
        _assert_tensors_equal(getattr(ps, name), getattr(jp, name))
    assert int(extra["spp"]) == 9


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    film, cam, ps = _port_state(seed=6)
    p = str(tmp_path / "port.npz")
    tcheckpoint.save(p, film, cam, ps, extra={"spp": np.asarray(17)})
    jf, jc, jp, extra = jcheckpoint.load(p)
    _assert_tensors_equal(film.accum, jf.accum)
    _assert_tensors_equal(np.asarray(film.frame_index, np.int32), jf.frame_index)
    for name in tcamera.Camera._fields:
        _assert_tensors_equal(getattr(cam, name), getattr(jc, name))
    for name in tprobes.ProbeState._fields:
        _assert_tensors_equal(getattr(ps, name), getattr(jp, name))
    assert int(extra["spp"]) == 17
    # The files hold the same keys with the same dtypes.
    ref_p = str(tmp_path / "ref.npz")
    jcheckpoint.save(ref_p, jf, jc, jp, extra={"spp": np.asarray(17)})
    a, b = np.load(p), np.load(ref_p)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        _assert_tensors_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# app/tuner: tests/test_tuner.py on the port
# ---------------------------------------------------------------------------


def test_tuner_knob_sets_are_the_reference_sets():
    assert ttuner.STATIC_KNOBS == jtuner.STATIC_KNOBS
    assert ttuner.DYNAMIC_KNOBS == jtuner.DYNAMIC_KNOBS
    assert DynamicState() == DynamicState(**vars(jtuner.DynamicState()))
    assert SettingsTuner(RenderSettings()).dump().splitlines()[1:] == \
        jtuner.SettingsTuner(jtuner.RenderSettings()).dump().splitlines()[1:]


def test_static_change_flags_recompile():
    t = SettingsTuner(RenderSettings(width=64, height=64, bounces=2))
    s, _ = t.apply("bounces=5")
    assert s.bounces == 5
    assert t.consume_recompile_flag()
    assert not t.consume_recompile_flag()


def test_same_value_no_recompile():
    t = SettingsTuner(RenderSettings(bounces=4))
    t.apply("bounces=4")
    assert not t.consume_recompile_flag()


def test_dynamic_change_no_recompile():
    t = SettingsTuner(RenderSettings())
    _, d = t.apply("blendfactor=0.25 cell_size=0.5")
    assert d.blendfactor == 0.25
    assert d.cell_size == 0.5
    assert not t.consume_recompile_flag()


def test_bool_knob():
    t = SettingsTuner(RenderSettings())
    s, _ = t.apply("diffuse_only=true")
    assert s.diffuse_only is True
    _, d = t.apply("proberng=1")
    assert d.proberng is True


def test_multiple_and_errors():
    t = SettingsTuner(RenderSettings())
    s, d = t.apply("samples=3 blendfactor=0.1")
    assert s.samples == 3 and d.blendfactor == 0.1
    with pytest.raises(ValueError, match="unknown knob"):
        t.apply("nonsense=1")
    with pytest.raises(ValueError, match="key=value"):
        t.apply("oops")


def test_dump_lists_everything():
    out = SettingsTuner(RenderSettings()).dump()
    assert "bounces=" in out and "blendfactor=" in out


# ---------------------------------------------------------------------------
# app/preview
# ---------------------------------------------------------------------------


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def test_preview_without_a_client_publishes_nothing():
    srv = tpreview.PreviewServer(port=0, min_interval=0.0).start()
    try:
        assert srv.port != 0
        assert not srv.wants_frame()
        assert not srv.publish(torch.zeros(8, 8, 3))
        status, ctype, body = _get(srv.port, "/")
        assert status == 200 and ctype == "text/html" and b"/stream" in body
        assert _get(srv.port, "/frame.jpg")[0] == 503
        assert _get(srv.port, "/nothing")[0] == 404
    finally:
        srv.stop()


def test_preview_serves_a_published_frame():
    srv = tpreview.PreviewServer(port=0, min_interval=0.0).start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    try:
        conn.request("GET", "/stream")
        stream = conn.getresponse()
        assert stream.status == 200 and "multipart/x-mixed-replace" in stream.getheader("Content-Type")
        deadline = time.monotonic() + 10
        while not srv.wants_frame() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.wants_frame()
        img = torch.linspace(0.0, 1.0, 16 * 16 * 3).reshape(16, 16, 3)
        assert srv.publish(img)
        status, ctype, body = _get(srv.port, "/frame.jpg")
        assert status == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
        # The streaming client receives the same JPEG as its first part.
        got = threading.Event()
        part = []

        def read_part():
            head = stream.fp.readline() + stream.fp.readline() + stream.fp.readline()
            part.append(head)
            got.set()

        threading.Thread(target=read_part, daemon=True).start()
        assert got.wait(10) and b"rt3frame" in part[0] and f"Content-Length: {len(body)}".encode() in part[0]
    finally:
        conn.close()
        srv.stop()


# ---------------------------------------------------------------------------
# utils/runtime
# ---------------------------------------------------------------------------


def test_device_info_cpu():
    i = truntime.device_info(torch.device("cpu"))
    assert (i.platform, i.device_kind, i.num_devices, i.num_hosts, i.memory_per_device) == ("cpu", "cpu", 1, 1, None)
    assert truntime.describe("cpu").startswith("cpu × 1 (cpu) on 1 host(s)")
    with pytest.raises(ValueError):
        truntime.device_info("meta")
