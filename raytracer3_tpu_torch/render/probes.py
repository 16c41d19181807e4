"""Screen-space octahedral radiance-probe GI (port of
``raytracer3_tpu/render/probes.py``; the reference's shaders/old/ probe
stack).

1. ``structured_importance_sampling``: per probe (one per sp×sp pixel tile) a
   pdf over its R×R octahedral directions from the tile's G-buffer normals;
   the lowest third of the directions give their rays to the highest ones,
   traced at the 2R mip (15-bit direction index + 1 mip bit).
2. ``trace_probes``: one ray per probe texel from the probe's anchor; the
   hit's emission, one NEE sample and optionally one more diffuse bounce,
   blended into the probe atlas over time. ``probe_texel_splits`` = k traces
   one round-robin class of texels per frame.
3. ``project_sh``: each probe's R×R texels → SH3 coefficients.
4. ``interpolate_probes``: per pixel the four surrounding probes, weighted
   bilinearly and by depth and normal agreement, give cosine-lobe irradiance
   × albedo/π + emission; a pixel no probe reaches is debug red.

Every trace goes through the backend's ``intersect_fn``/``occluded_fn`` (and
``primary_fn`` for the G-buffer's tile-ordered primaries), in the
reference's ray order.

The probe resolve (steps 1, 3 and 4 on the packed G-buffer: ``sis_packed``,
``project_sh``, ``interpolate_packed``) runs on a CUDA device as the three
hand-written kernels of ``ops/probe_resolve_kernel`` (``csrc/
probe_resolve.cu``), one a pass; elsewhere as PyTorch, the kernels' plain
versions (``sis_packed_plain``, ``project_sh_plain``,
``interpolate_packed_plain``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from raytracer3_tpu_torch.ops import brdf, mathx, packing, probe_resolve_kernel, rng, sh
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import gbuffer as gbuffer_mod
from raytracer3_tpu_torch.render import pathtracer
from raytracer3_tpu_torch.scene import types as scene_types

_M32 = 0xFFFFFFFF


class ProbeState(NamedTuple):
    """Temporal probe buffers (the prev_probe_atlas double buffer)."""

    atlas: torch.Tensor  # [Py*R, Px*R, 3] radiance
    depth: torch.Tensor  # [Py*R, Px*R] hit distance; 0 = never traced
    sh_coeffs: torch.Tensor  # [Py, Px, 3, 9]

    @staticmethod
    def create(settings, *, device) -> "ProbeState":
        px, py = settings.probe_grid
        r = settings.probe_res
        z = dict(dtype=torch.float32, device=device)
        return ProbeState(
            atlas=torch.zeros((py * r, px * r, 3), **z),
            depth=torch.zeros((py * r, px * r), **z),
            sh_coeffs=torch.zeros((py, px, 3, 9), **z),
        )


def octa_direction_grid(res: int, *, device) -> torch.Tensor:
    """[res, res, 3] unit directions at the octahedral texel centres
    (trace_probes.slang octa_decode((i+0.5)/res)); [v, u] indexing."""
    u = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    return packing.octa_decode(torch.stack([uu, vv], dim=-1))


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving: one fixed order of additions on
    any device, so that tied and near-tied sums come out alike everywhere."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        y = x[..., :half] + x[..., half:2 * half]
        x = torch.cat([y, x[..., 2 * half:]], dim=-1) if x.shape[-1] % 2 else y
    return x[..., 0]


def sis_pdf(gbuf_normal: torch.Tensor, settings) -> torch.Tensor:
    """[Py, Px, R·R] per-probe direction pdf: max(Σ_i n_i·dir_d, 0) / sp²
    over the tile's normals (the reference's einsum), summed in
    ``_sum_last``'s order."""
    px, py = settings.probe_grid
    r = settings.probe_res
    sp = settings.probe_spacing
    tiles = gbuf_normal[: py * sp, : px * sp].reshape(py, sp, px, sp, 3)
    tiles = tiles.permute(0, 2, 1, 3, 4).reshape(py, px, 1, sp * sp, 3)
    dirs = octa_direction_grid(r, device=gbuf_normal.device).reshape(1, 1, r * r, 1, 3)
    dots = tiles[..., 0] * dirs[..., 0] + tiles[..., 1] * dirs[..., 1] + tiles[..., 2] * dirs[..., 2]
    return torch.clamp_min(_sum_last(dots), 0.0) / (sp * sp)


def sis_cull_count(probe_res: int) -> int:
    """How many of a probe's R·R directions SIS culls and retraces at the
    fine mip: the lowest third by pdf."""
    return int(probe_res * probe_res * (1.0 / 3.0))


def structured_importance_sampling(gbuf_normal: torch.Tensor, settings):
    """Per-probe ray budgeting (structured_importance_sampling.slang:19-70).

    Returns (dir_index [Py, Px, R·R] int64, mip [Py, Px, R·R] int64): the
    direction's index in the base (R) or fine (2R) octahedral grid and the
    mip bit. The lowest ``sis_cull_count(R)`` of the directions by pdf (ties
    by index: a stable sort, as ``jnp.argsort``) are culled; the culled one
    of rank q is retraced at the fine mip in the direction of rank q from
    the top."""
    r = settings.probe_res
    ndirs = r * r
    pdf = sis_pdf(gbuf_normal, settings)
    order = torch.argsort(pdf, dim=-1, stable=True)  # ascending: first = most cullable
    ranks = torch.argsort(order, dim=-1, stable=True)
    culled = ranks < sis_cull_count(r)
    top = torch.flip(order, dims=[-1])
    target = torch.gather(top, -1, torch.clamp(ranks, 0, ndirs - 1))
    fine_idx = (target // r) * 2 * (2 * r) + (target % r) * 2
    base_idx = torch.arange(ndirs, device=pdf.device).expand(pdf.shape)
    return torch.where(culled, fine_idx, base_idx), culled.to(torch.int64)


def _probe_resolve(device):
    """The library of the probe resolve's passes (``csrc/probe_resolve.cu``)
    that tensors on ``device`` take: the nvcc build on a CUDA device, None
    (the plain versions) elsewhere."""
    return probe_resolve_kernel.load_kernels() if torch.device(device).type == "cuda" else None


def sis_packed(gbuf_data: torch.Tensor, settings):
    """(gbuf_normal [H, W, 3], dir_index, mip) of the packed G-buffer's words
    ``gbuf_data`` [H, W, 4]: the normals decoded once for every later pass,
    and ``structured_importance_sampling`` over them."""
    lib = _probe_resolve(gbuf_data.device)
    if lib is None:
        return sis_packed_plain(gbuf_data, settings)
    r = settings.probe_res
    return probe_resolve_kernel.sis(lib, gbuf_data, settings.probe_grid, settings.probe_spacing, r,
                                    sis_cull_count(r))


def sis_packed_plain(gbuf_data: torch.Tensor, settings):
    """``sis_packed`` in PyTorch."""
    normal = packing.unpack_normal_11_10_11(gbuf_data[..., 1])
    return (normal,) + structured_importance_sampling(normal, settings)


def _last_writers(flat_idx: torch.Tensor, n_dst: int):
    """``zeros(n_dst).at[flat_idx].set(src)`` takes, where an index repeats,
    the last update (the reference's CPU scatter); this makes that rule
    explicit so that it holds on any device. Returns each update's
    destination (``n_dst``, a slot past the end, where a later update of
    the same element wins) and the mask of elements written."""
    order = torch.arange(flat_idx.shape[0], device=flat_idx.device)
    last = torch.full((n_dst,), -1, dtype=torch.int64, device=flat_idx.device)
    last = last.scatter_reduce(0, flat_idx, order, reduce="amax")
    return torch.where(last[flat_idx] == order, flat_idx, n_dst), last >= 0


def _scatter(dst: torch.Tensor, n_dst: int, src: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((n_dst + 1,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    out[dst] = src
    return out[:n_dst]


def trace_probes(scene: scene_types.Scene, intersect_fn, gbuf_depth, gbuf_normal, origins, view_dirs,
                 dir_index, mip, prev: ProbeState, settings, frame_index, blendfactor,
                 occluded_fn: Optional[pathtracer.OccludedFn] = None, include_direct: bool = True,
                 return_count: bool = False):
    """Trace one ray per probe texel and blend it into the atlas
    (trace_probes.slang:14-77). Returns the new ``ProbeState``; with
    ``return_count`` also the lanes traced, as ``wavefront.trace_wavefront``
    counts them: every probe ray, the live second-bounce rays and the
    shadow lanes that traverse (a 0-d int64 tensor, or an int where no
    launch's count depends on the data).

    ``include_direct=False`` drops what a per-pixel direct pass covers (the
    emission and env seen by the probe ray): the atlas then holds bounced
    light only (the hybrid split). ``blendfactor`` ≥ 1 is a camera cut: the
    atlas takes the new values and zeroes the texels not written this frame.

    ``settings.probe_texel_splits`` = k > 1 traces the texels t ≡ frame
    (mod k) only; the others keep their value (on a cut they are zeroed, as
    in the reference). ``probe_bounces`` ≥ 2 adds one diffuse bounce at the
    probe hit, traced by a 1/``probe_bounce2_splits`` share of the texels
    each frame and weighted by the inverse."""
    px, py = settings.probe_grid
    r = settings.probe_res
    sp = settings.probe_spacing
    rr = r * r
    k = max(1, int(settings.probe_texel_splits))
    if rr % k:
        raise ValueError(f"probe_texel_splits {k} must divide probe_res^2 = {rr}")
    rr_eff = rr // k
    n = py * px * rr_eff
    dev = gbuf_depth.device

    # Probe anchors: pixel (x·sp, y·sp) (trace_probes.slang:24).
    ayy = (torch.arange(py, device=dev) * sp)[:, None].expand(py, px)
    axx = (torch.arange(px, device=dev) * sp)[None, :].expand(py, px)
    anchor_depth = gbuf_depth[ayy, axx]
    anchor_pos = origins[ayy, axx] + view_dirs[ayy, axx] * anchor_depth[..., None]
    probe_valid = anchor_depth < mathx.BACKGROUND_DEPTH

    # Per texel: a jittered octahedral direction at the base or fine mip.
    ids3 = torch.arange(py * px * rr, dtype=torch.int64, device=dev).reshape(py, px, rr)
    di = dir_index.reshape(py, px, rr)
    mp = mip.reshape(py, px, rr)
    if k > 1:
        # Round-robin class m = frame mod k (texel t = j·k + m). The sampler
        # keeps the full atlas ids, so a texel's jitter does not depend on k.
        m_idx = rng.frame_word(frame_index) % k

        def _sel(a):
            a = a.reshape(py, px, rr_eff, k)
            if isinstance(m_idx, torch.Tensor):  # a device-side select (a compiled step's index)
                return a.index_select(3, m_idx.reshape(1)).squeeze(3)
            return a[..., m_idx]

        di, mp, ids3 = _sel(di), _sel(mp), _sel(ids3)
    sampler = rng.Sampler.from_ids(ids3.reshape(-1), frame_index)
    uj, sampler = sampler.next2()
    fine = mp == 1
    size = torch.where(fine, 2.0 * r, float(r))
    dx = torch.where(fine, di % (2 * r), di % r).to(torch.float32)
    dy = torch.where(fine, torch.div(di, 2 * r, rounding_mode="floor"),
                     torch.div(di, r, rounding_mode="floor")).to(torch.float32)
    uvj = (torch.stack([dx, dy], dim=-1) + uj.reshape(py, px, rr_eff, 2)) / size[..., None]
    ray_dir = packing.octa_decode(uvj).reshape(n, 3)

    # Anchor normals face the camera, so the offset pushes into open space.
    anchor_nrm = pathtracer._face_forward(gbuf_normal[ayy, axx], -view_dirs[ayy, axx])
    ray_org = anchor_pos[:, :, None, :].expand(py, px, rr_eff, 3).reshape(n, 3)
    nrm = anchor_nrm[:, :, None, :].expand(py, px, rr_eff, 3).reshape(n, 3)
    ray_org = ray_org + nrm * 5e-4  # TMin analog (trace_probes.slang:55)

    h = intersect_fn(ray_org, ray_dir)
    traced = n
    surface = scene_types.hit_surface_info(scene, h.prim_id, h.uv, h.inst)

    # The probe hit: emission and one NEE sample (single-bounce GI).
    radiance = surface.emissive if include_direct else torch.zeros_like(surface.emissive)
    hit_pos = ray_org + h.t[:, None] * ray_dir
    s_nrm = pathtracer._face_forward(surface.normal, -ray_dir)
    has_lights = int(scene.emissive.tri_ids.shape[0]) > 0
    if occluded_fn is not None and has_lights:
        u3, sampler = sampler.next3()
        li, sampler, n_shadow = pathtracer._nee_contribution(
            scene, occluded_fn, hit_pos, s_nrm, -ray_dir, surface, u3, sampler, settings,
            alive_mask=h.hit, return_count=True,
        )
        radiance = radiance + li
        traced = traced + n_shadow
    if settings.probe_bounces > 1:
        # One cosine-sampled diffuse bounce at the probe hit: all of it is
        # bounced light at the anchor, so it is kept in both modes.
        u2, sampler = sampler.next2()
        s2 = brdf.diffuse_sample(surface.albedo, u2)
        d2w = mathx.to_world(mathx.build_orthonormal_basis(s_nrm), s2.wi)
        o2 = hit_pos + s_nrm * 5e-4
        alive2 = h.hit & s2.valid
        w2 = 1.0
        k2 = max(1, int(settings.probe_bounce2_splits))
        if k2 > 1:
            # Each texel traces its second bounce with probability 1/k2,
            # weighted k2 (unbiased); the others are parked.
            u_sel, sampler = sampler.next1()
            alive2 = alive2 & (u_sel < (1.0 / k2))
            w2 = float(k2)
        o2 = torch.where(alive2[:, None], o2, 1e30)
        h2 = intersect_fn(o2, d2w)
        traced = traced + alive2.sum()
        surface2 = scene_types.hit_surface_info(scene, h2.prim_id, h2.uv, h2.inst)
        b_rad = surface2.emissive
        if occluded_fn is not None and has_lights:
            hp2 = o2 + h2.t[:, None] * d2w
            n2 = pathtracer._face_forward(surface2.normal, -d2w)
            u3b, sampler = sampler.next3()
            li2, sampler, n_shadow2 = pathtracer._nee_contribution(
                scene, occluded_fn, hp2, n2, -d2w, surface2, u3b, sampler, settings,
                alive_mask=alive2 & h2.hit, return_count=True,
            )
            b_rad = b_rad + li2
            traced = traced + n_shadow2
        b_rad = torch.where(h2.hit[:, None], b_rad, pathtracer._sample_env(scene, d2w))
        radiance = radiance + torch.where(alive2[:, None], w2 * s2.value_over_pdf * b_rad, 0.0)
    if include_direct:
        radiance = torch.where(h.hit[:, None], radiance, pathtracer._sample_env(scene, ray_dir))
    else:
        radiance = torch.where(h.hit[:, None], radiance, 0.0)

    # The texel written: the direction scaled back to the base grid
    # (trace_probes.slang:74 writes at (direction_2d / size) * R).
    tex_x = torch.clamp(dx / size * r, 0, r - 1).to(torch.int64)
    tex_y = torch.clamp(dy / size * r, 0, r - 1).to(torch.int64)
    pyy = torch.arange(py, device=dev)[:, None, None]
    pxx = torch.arange(px, device=dev)[None, :, None]
    row = pyy * r + tex_y.reshape(py, px, rr_eff)
    col = pxx * r + tex_x.reshape(py, px, rr_eff)
    n_dst = py * r * px * r
    dst, written = _last_writers((row * (px * r) + col).reshape(-1), n_dst)
    new_atlas = _scatter(dst, n_dst, radiance).reshape(prev.atlas.shape)
    new_depth = _scatter(dst, n_dst, h.t).reshape(prev.depth.shape)
    written = written.reshape(prev.depth.shape)

    # Temporal blend (trace_probes.slang:74): the texels written this frame
    # move toward their new value; the rest keep theirs, or zero on a cut.
    # Probes anchored on the sky hold zero radiance and BACKGROUND depth.
    if isinstance(blendfactor, torch.Tensor):
        keep = torch.where(blendfactor >= 1.0, 0.0, 1.0)
    else:
        keep = 0.0 if float(blendfactor) >= 1.0 else 1.0
    pv = probe_valid.repeat_interleave(r, dim=0).repeat_interleave(r, dim=1)
    blended = torch.where(written[..., None], prev.atlas + (new_atlas - prev.atlas) * blendfactor, prev.atlas * keep)
    depth_eff = torch.where(written, new_depth, prev.depth * keep)
    atlas = torch.where(pv[..., None], blended, 0.0)
    depth = torch.where(pv, depth_eff, mathx.BACKGROUND_DEPTH)
    state = ProbeState(atlas=atlas, depth=depth, sh_coeffs=prev.sh_coeffs)
    return (state, traced) if return_count else state


def project_sh(state: ProbeState, settings) -> ProbeState:
    """Probe atlas → SH3 coefficients (spherical_harmonic_conversion.slang:
    9-33): coeff = Σ_d Y(dir_d)·L_d × 4π/R². With ``settings.probe_sh_fill``
    the texels never written since a reset (depth 0) take their probe's mean
    written radiance first, so the culled directions do not count as black."""
    lib = _probe_resolve(state.atlas.device)
    if lib is None:
        return project_sh_plain(state, settings)
    coeffs = probe_resolve_kernel.sh(lib, state.atlas, state.depth, settings.probe_grid, settings.probe_res,
                                     settings.probe_sh_fill)
    return state._replace(sh_coeffs=coeffs)


def project_sh_plain(state: ProbeState, settings) -> ProbeState:
    """``project_sh`` in PyTorch, in the atlas's dtype (float64 gives the
    exact projection of float32 texels that the kernel is held to)."""
    px, py = settings.probe_grid
    r = settings.probe_res
    atlas = state.atlas.reshape(py, r, px, r, 3).permute(0, 2, 1, 3, 4).reshape(py, px, r * r, 3)
    if settings.probe_sh_fill:
        dep = state.depth.reshape(py, r, px, r).permute(0, 2, 1, 3).reshape(py, px, r * r)
        written = (dep > 0.0)[..., None]
        wsum = written.sum(dim=2, keepdim=True).to(atlas.dtype)
        mean = torch.where(written, atlas, 0.0).sum(dim=2, keepdim=True) / torch.clamp_min(wsum, 1.0)
        atlas = torch.where(written, atlas, mean)
    basis = sh.sh3_evaluate(octa_direction_grid(r, device=atlas.device).reshape(r * r, 3)).to(atlas.dtype)
    coeffs = torch.einsum("yxdc,dk->yxck", atlas, basis) * (4.0 * math.pi / (r * r))
    return state._replace(sh_coeffs=coeffs)


def _pow8(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def _blend_neighbours(contribs, weights, albedo, emissive, pix_depth):
    """Normalise the four weights, blend the irradiance, shade, paint the
    pixels no probe reaches red and the sky black."""
    wsum = weights[0] + weights[1] + weights[2] + weights[3]  # written out: one order on every device
    failed = wsum <= 1e-8
    den = torch.clamp_min(wsum, 1e-8)
    irr = sum(c * (wgt / den)[..., None] for c, wgt in zip(contribs, weights))
    light = irr * albedo * mathx.INV_PI + emissive
    red = torch.zeros_like(light)
    red[..., 0] = 1.0
    light = torch.where(failed[..., None], red, light)
    return torch.where((pix_depth >= mathx.BACKGROUND_DEPTH)[..., None], 0.0, light)


def _edge_weight(pdep, pnrm, dep, nrm, w_bil):
    """Edge-aware weight (interpolate_probes.slang:65-70)."""
    wgt = torch.clamp(1.0 - torch.abs(pdep - dep) / torch.clamp_min(dep, 1e-6), 0.0, 1.0)
    cos = nrm[..., 0] * pnrm[..., 0] + nrm[..., 1] * pnrm[..., 1] + nrm[..., 2] * pnrm[..., 2]
    wgt = wgt * torch.clamp_min(cos, 0.0)
    return torch.where(pdep < mathx.BACKGROUND_DEPTH, (w_bil + 1e-3) * _pow8(wgt), 0.0)


def _edge_pad(a: torch.Tensor) -> torch.Tensor:
    """Repeat the last row and column (the generic path's index clip)."""
    a = torch.cat([a, a[-1:]], dim=0)
    return torch.cat([a, a[:, -1:]], dim=1)


def _interpolate_probes_cells(gbuf_depth, gbuf_normal, albedo, emissive, state: ProbeState, settings):
    """``interpolate_probes`` for frames of whole cells (H = Py·sp, W =
    Px·sp, every production size): all pixels of a cell share their four
    probes, so the probe rows are slices broadcast over the cell instead of
    per-pixel gathers. Same weights and order of accumulation as the
    generic path."""
    h, w = gbuf_depth.shape
    px, py = settings.probe_grid
    sp = settings.probe_spacing
    adep = _edge_pad(gbuf_depth[::sp, ::sp])
    anrm = _edge_pad(gbuf_normal[::sp, ::sp])
    acoef = _edge_pad(state.sh_coeffs)

    dep_c = gbuf_depth.reshape(py, sp, px, sp)
    nrm_c = gbuf_normal.reshape(py, sp, px, sp, 3)
    basis = sh.sh3_transform_cos_lobe(nrm_c)  # [py, sp, px, sp, 9]
    f = torch.arange(sp, dtype=torch.float32, device=gbuf_depth.device) / sp
    fy = f[None, :, None, None]
    fx = f[None, None, None, :]

    contribs, weights = [], []
    for oy in (0, 1):
        for ox in (0, 1):
            pdep = adep[oy:oy + py, ox:ox + px][:, None, :, None]
            pnrm = anrm[oy:oy + py, ox:ox + px][:, None, :, None, :]
            w_bil = (fx if ox else (1.0 - fx)) * (fy if oy else (1.0 - fy))
            wgt = _edge_weight(pdep, pnrm, dep_c, nrm_c, w_bil)
            coeffs = acoef[oy:oy + py, ox:ox + px][:, None, :, None]
            irr = (coeffs * basis[..., None, :]).sum(dim=-1)
            contribs.append(torch.clamp_min(irr, 0.0))
            weights.append(wgt.expand(py, sp, px, sp))
    light = _blend_neighbours(contribs, weights, albedo.reshape(py, sp, px, sp, 3),
                              emissive.reshape(py, sp, px, sp, 3), dep_c)
    return light.reshape(h, w, 3)


def interpolate_probes(gbuf_depth, gbuf_normal, albedo, emissive, state: ProbeState, settings) -> torch.Tensor:
    """Per pixel the four surrounding probes, weighted bilinearly and
    edge-aware → irradiance × albedo/π + emission, [H, W, 3]
    (interpolate_probes.slang:11-110); a pixel no probe reaches is red."""
    h, w = gbuf_depth.shape
    px, py = settings.probe_grid
    sp = settings.probe_spacing
    if h == py * sp and w == px * sp:
        return _interpolate_probes_cells(gbuf_depth, gbuf_normal, albedo, emissive, state, settings)

    dev = gbuf_depth.device
    ys = torch.arange(h, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w)
    p0x = torch.clamp(torch.div(xs, sp, rounding_mode="floor"), 0, px - 1)
    p0y = torch.clamp(torch.div(ys, sp, rounding_mode="floor"), 0, py - 1)
    fx = (xs - p0x * sp).to(torch.float32) / sp
    fy = (ys - p0y * sp).to(torch.float32) / sp
    contribs, weights = [], []
    for oy in (0, 1):
        for ox in (0, 1):
            pxc = torch.clamp(p0x + ox, 0, px - 1)
            pyc = torch.clamp(p0y + oy, 0, py - 1)
            w_bil = (fx if ox else (1.0 - fx)) * (fy if oy else (1.0 - fy))
            wgt = _edge_weight(gbuf_depth[pyc * sp, pxc * sp], gbuf_normal[pyc * sp, pxc * sp],
                               gbuf_depth, gbuf_normal, w_bil)
            irr = sh.sh3_unproject_cos_lobe(state.sh_coeffs[pyc, pxc], gbuf_normal)
            contribs.append(torch.clamp_min(irr, 0.0))
            weights.append(wgt)
    return _blend_neighbours(contribs, weights, albedo, emissive, gbuf_depth)


def interpolate_packed(gbuf_depth, gbuf_normal, gbuf_data, sh_coeffs, settings, emission: bool = True):
    """``interpolate_probes`` of a frame's depth [H, W], normals [H, W, 3]
    and packed words [H, W, 4] (the albedo decoded from word 0, the emission
    from word 3, or zero where ``emission`` is false: the hybrid's indirect
    term) from the probes' coefficients [Py, Px, 3, 9]: the lit image."""
    lib = _probe_resolve(gbuf_depth.device)
    if lib is None:
        return interpolate_packed_plain(gbuf_depth, gbuf_normal, gbuf_data, sh_coeffs, settings, emission)
    return probe_resolve_kernel.interpolate(lib, gbuf_depth, gbuf_normal, gbuf_data, sh_coeffs,
                                           settings.probe_spacing, emission)


def interpolate_packed_plain(gbuf_depth, gbuf_normal, gbuf_data, sh_coeffs, settings, emission: bool = True):
    """``interpolate_packed`` in PyTorch."""
    albedo = packing.unpack_color_888(gbuf_data[..., 0])
    emissive = packing.unpack_rgb9e5(gbuf_data[..., 3])
    if not emission:
        emissive = torch.zeros_like(emissive)
    return interpolate_probes(gbuf_depth, gbuf_normal, albedo, emissive, ProbeState(None, None, sh_coeffs), settings)


def trace_packed_gbuffer(scene: scene_types.Scene, intersect_fn, cam, settings, primary_fn=None):
    """Primary rays (pixel centres) → packed G-buffer [H, W] and hit mask.

    With ``primary_fn`` (a backend's ``bind_primary``) the primaries go out
    in tile-swizzled order where a tile divides the frame (consecutive rays
    form screen tiles) and the buffers are un-swizzled with reshapes."""
    from raytracer3_tpu_torch.render import wavefront

    w, h = settings.width, settings.height
    dev = scene.positions.device
    tile = wavefront.pick_tile(w, h) if primary_fn is not None else None
    if tile is not None:
        tw_, th_ = tile
        _, pix = wavefront.frame_pixels(w, h, dev)
        o, d = camera_mod.primary_rays(cam, w, h, pixel_xy=pix)
        gbuf = pathtracer.trace_gbuffer(scene, primary_fn, o, d)

        def unswizzle(a):
            rest = tuple(a.shape[1:])
            a = a.reshape((h // th_, w // tw_, th_, tw_) + rest)
            return a.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))).reshape((h, w) + rest)
    else:
        pix = camera_mod.pixel_grid(w, h, device=dev)
        o, d = camera_mod.primary_rays(cam, w, h, pixel_xy=pix)
        gbuf = pathtracer.trace_gbuffer(scene, intersect_fn, o, d)

        def unswizzle(a):
            return a.reshape((h, w) + tuple(a.shape[1:]))

    surface = scene_types.SurfaceInfo(*(unswizzle(a) for a in gbuf.surface))
    return gbuffer_mod.pack_surface(surface, unswizzle(gbuf.depth)), unswizzle(gbuf.hit)


def _view(cam, packed: gbuffer_mod.PackedGBuffer, settings):
    """(depth, view origins, view dirs) of a packed G-buffer, with the
    row-ordered pixel-centre rays."""
    w, h = settings.width, settings.height
    pix = camera_mod.pixel_grid(w, h, device=packed.depth.device)
    o, d = camera_mod.primary_rays(cam, w, h, pixel_xy=pix)
    return packed.depth, o.reshape(h, w, 3), d.reshape(h, w, 3)


def probe_gi_from_gbuffer(scene: scene_types.Scene, intersect_fn, cam, packed, prev: ProbeState, settings,
                          frame_index, blendfactor=0.15, occluded_fn=None):
    """SIS → trace probes → SH → interpolate on a packed G-buffer [H, W].
    Returns (light [H, W, 3], new ProbeState, aux dict)."""
    depth2, o2, d2 = _view(cam, packed, settings)
    normal2, dir_index, mip = sis_packed(packed.data, settings)
    state = trace_probes(scene, intersect_fn, depth2, normal2, o2, d2, dir_index, mip,
                         prev, settings, frame_index, blendfactor, occluded_fn)
    state = project_sh(state, settings)
    light = interpolate_packed(depth2, normal2, packed.data, state.sh_coeffs, settings)
    return light, state, dict(depth=depth2, view_dirs=d2)


def hybrid_gi_from_gbuffer(scene: scene_types.Scene, intersect_fn, cam, packed, prev: ProbeState, settings,
                           frame_index, blendfactor=0.15, occluded_fn=None):
    """Hybrid frame: per-pixel direct light (one NEE shadow ray per pixel)
    plus probe-interpolated indirect light from an atlas traced with
    ``include_direct=False``, so the two partition the incident light.
    Returns (light, new ProbeState, aux with the ``indirect`` term)."""
    depth2, o2, d2 = _view(cam, packed, settings)
    normal2, dir_index, mip = sis_packed(packed.data, settings)
    surface = gbuffer_mod.unpack_surface(packed, normal=normal2)
    state = trace_probes(scene, intersect_fn, depth2, normal2, o2, d2, dir_index, mip,
                         prev, settings, frame_index, blendfactor, occluded_fn, include_direct=False)
    state = project_sh(state, settings)
    indirect = interpolate_packed(depth2, normal2, packed.data, state.sh_coeffs, settings, emission=False)
    direct, _ = hybrid_direct(scene, occluded_fn, surface, depth2, o2, d2, settings, frame_index)
    light, indirect = hybrid_light(indirect, direct, depth2, surface.emissive)
    return light, state, dict(depth=depth2, view_dirs=d2, indirect=indirect)


def hybrid_direct(scene: scene_types.Scene, occluded_fn, surface, depth2, o2, d2, settings, frame_index):
    """The hybrid frame's per-pixel direct light: one NEE sample at each
    primary surface of an unpacked G-buffer [H, W] (zero without
    ``occluded_fn``). Returns (direct [H, W, 3], shadow lanes traced)."""
    w, h = settings.width, settings.height
    hitmask = (depth2 < mathx.BACKGROUND_DEPTH).reshape(-1)
    flat_surface = scene_types.SurfaceInfo(*(a.reshape((-1,) + tuple(a.shape[2:])) for a in surface))
    d_flat = d2.reshape(-1, 3)
    nrm = pathtracer._face_forward(flat_surface.normal, -d_flat)
    hit_pos = o2.reshape(-1, 3) + depth2.reshape(-1, 1) * d_flat
    direct = torch.zeros((h * w, 3), dtype=torch.float32, device=depth2.device)
    traced = 0
    if occluded_fn is not None:
        ids = torch.arange(h * w, dtype=torch.int64, device=depth2.device)
        sampler = rng.Sampler.from_ids(ids, (rng.frame_word(frame_index) + 77777) & _M32)
        u3, sampler = sampler.next3()
        li, sampler, traced = pathtracer._nee_contribution(
            scene, occluded_fn, hit_pos, nrm, -d_flat, flat_surface, u3, sampler, settings,
            alive_mask=hitmask, return_count=True,
        )
        direct = torch.where(hitmask[:, None], li, 0.0)
    return direct.reshape(h, w, 3), traced


def hybrid_light(indirect, direct, depth2, emissive):
    """(light, indirect) of a hybrid frame: the probes' indirect term plus
    the direct term and the emission, both zero on the sky."""
    sky = (depth2 >= mathx.BACKGROUND_DEPTH)[..., None]
    indirect = torch.where(sky, 0.0, indirect)
    return torch.where(sky, 0.0, indirect + direct + emissive), indirect


def probe_gi_frame(scene: scene_types.Scene, intersect_fn, cam, prev: ProbeState, settings, frame_index,
                   blendfactor=0.15, occluded_fn=None):
    """A whole probe-GI frame: packed G-buffer (row-ordered primaries) →
    ``probe_gi_from_gbuffer``. Returns (light, new ProbeState, aux)."""
    packed, hit2 = trace_packed_gbuffer(scene, intersect_fn, cam, settings)
    light, state, aux = probe_gi_from_gbuffer(scene, intersect_fn, cam, packed, prev, settings,
                                              frame_index, blendfactor, occluded_fn)
    aux["hit"] = hit2
    return light, state, aux
