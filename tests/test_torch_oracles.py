"""Card-only checks of the wavefront's options through the CUDA kernels (they
skip without a CUDA device; on the card: ``python -m pytest
tests/test_torch_oracles.py -m gpu``).

- The 192×108 ground-truth oracle (``resources/oracle_atrium_192x108.npz``,
  a high-spp reference-mode render) against the port's wavefront through
  K1/K2, with the bounds of ``tests/test_ground_truth.py``: AgX display in
  4×4 block means, mean < 0.02 and p99 < 0.10 at 48 spp.
- On a small treelet scene through K3: the fused shadow+bounce frame (K3's
  mixed-hit shape) and the ``tail_anyhit=False`` frame against the split
  frame (bit-equal but for at most 1 pixel in 500), and the lane diet
  against the default frame within the reference's bound (``rtol 0.02,
  atol 2e-3``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.ops import tonemap
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def _blocks(radiance):
    disp = tonemap.agx_tonemap(radiance, look="punchy")
    h, w = disp.shape[0] // 4, disp.shape[1] // 4
    return disp[: h * 4, : w * 4].reshape(h, 4, w, 4, 3).mean(dim=(1, 3)).cpu().numpy()


@pytest.mark.gpu
def test_oracle_192x108_through_k1k2_on_card():
    dev = _cuda()
    z = np.load(os.path.join(REPO, "resources", "oracle_atrium_192x108.npz"))
    oracle = z["radiance"]
    h, w = oracle.shape[:2]
    scene, tris = tprocedural.atrium_scene(detail=int(z["detail"]), return_host=True, device=dev)
    backend = ttk.packet_backend(host_tris=tris, device=dev)
    isect, occl = backend.bind(backend.arrays)
    cam = tprocedural.atrium_camera(aspect=w / h, device=dev)
    s = RenderSettings(width=w, height=h, bounces=int(z["bounces"]), samples=4, radiance_clamp=50.0)
    before = dict(ttk.LAUNCHES)
    total = torch.zeros((h, w, 3), dtype=torch.float64, device=dev)
    for i in range(12):  # 48 spp
        total += twavefront.render_frame(scene, cam, s, i, isect, occl, sort_rays=True).double()
    assert ttk.LAUNCHES["closest"] - before["closest"] == 12 * s.samples * s.bounces
    diff = np.abs(_blocks((total / 12).to(torch.float32)) - _blocks(torch.as_tensor(oracle, device=dev)))
    assert diff.mean() < 0.02, diff.mean()
    assert np.percentile(diff, 99) < 0.10, np.percentile(diff, 99)


@pytest.mark.gpu
def test_fused_diet_and_tail_off_through_k3_on_card():
    dev = _cuda()
    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device=dev)
    backend = ttreelets.treelet_backend(host_tris=tris, max_tris=4096, device=dev)
    assert backend.meta.num_treelets >= 2
    isect, occl = backend.bind(backend.arrays)
    primary, capped = backend.bind_primary(backend.arrays), backend.bind_capped(backend.arrays)
    cam = tprocedural.atrium_camera(aspect=2.0, device=dev)
    s = RenderSettings(width=128, height=64, bounces=3, samples=4, sample_batch=True, radiance_clamp=50.0)

    def frame(settings, **kw):
        before = dict(ttk.LAUNCHES)
        img = twavefront.render_frame(scene, cam, settings, 3, isect, occl, primary_fn=primary, **kw)
        torch.cuda.synchronize()
        return img, {k: ttk.LAUNCHES[k] - before[k] for k in ("seg_closest", "seg_any")}

    split, n_split = frame(s)
    fused, n_fused = frame(dataclasses.replace(s, fuse_shadow=True), fused_fn=capped)
    tail_off, n_off = frame(s, tail_anyhit=False)
    diet, _ = frame(dataclasses.replace(s, lane_diet=True))
    # Split: primary + 2 closest, 2 NEE + the tail; fused: primary + 2
    # mixed, the tail; tail off: primary + 3 closest, 3 NEE.
    assert n_split == {"seg_closest": 3, "seg_any": 3}
    assert n_fused == {"seg_closest": 3, "seg_any": 1}
    assert n_off == {"seg_closest": 4, "seg_any": 3}
    px = s.width * s.height
    for img in (fused, tail_off):
        assert int(((img - split).abs().amax(-1) > 0).sum()) <= px // 500
    assert float(split.mean()) > 0 and bool(split.isfinite().all())
    torch.testing.assert_close(diet, split, rtol=0.02, atol=2e-3)
    assert float((diet - split).abs().max()) > 0
