"""The shade kernel (``csrc/shade.cu``) against its plain version, the
PyTorch ``wavefront._shade_plain``.

On the CPU the kernel's source is built with g++ under ``csrc/host_shim.h``
(``shade_kernel.load_host_kernels()``: every thread of a launch run in
turn) and driven through ``wavefront._shade_on_kernel``, the glue the CUDA
path takes: all three forms (the deferred pass, and passes A and B around
the bounce's own shadow launch, sorted as in production), on small seeded
queues of primary hits with dead and missed lanes (every 13th lane a miss). The cases cross the
three NEE branches (area lights only: Cornell; the env only: the atrium
with its light list emptied; the mixture: the atrium with its sky) and no
NEE, 16- and 32-lane shade rows (seeded vertex colours), two-level rows
(seeded instance ids, normal matrices and material overrides), bounce 0
(the queue's constant columns as stride-0 views) and a bounce at
``rr_start`` (seeded throughput, radiance and pdf), and the variants
``diet`` (the lane diet), ``diffuse`` (``diffuse_only``) and ``nee_rr``
(the shadow-ray roulette).

Each case is held twice:
- To the bit, and the sampler's counter equal, against the plain path run
  with correctly rounded ``sqrt``, ``rsqrt``, ``sin`` and ``cos`` (through
  float64), which the host build uses too: where the operations match, the
  outputs match.
- Against the plain path as it runs: PyTorch's vectorised CPU ``sqrt``,
  ``rsqrt``, ``sin`` and ``cos`` are off by an ulp on ~0.6-19% of inputs
  (``sqrt`` ~0.7%, ``rsqrt`` ~0.6%, ``cos`` ~19% against a correctly rounded
  one, with torch 2.13's CPU build on x86-64), and the chain carries such an ulp on through its
  cancellations (``sample_vndf``'s 1 - p1² - p2², a normalised sum near
  zero, GGX's masking near grazing), so a float output that reaches the
  film is held to within 2^-18 of its lane's scale, and ``alive`` and
  ``pre_ok`` must be equal, but on lanes where such an ulp decides a
  threshold test (a lobe pick, a roulette) or is amplified past the bound;
  the test counts those lanes and holds them to 0.1% of a case's lanes.
  Measured over the 120 cases (122,880 lanes): no ``alive`` or ``pre_ok``
  differs; 8 lanes are beyond 2^-18, all in two-level cases (whose seeded
  normal matrices tilt shading normals to grazing), one at most a case, the
  worst at 2^-12.6 of its lane's scale (``contrib``); elsewhere 2^-18.8
  (radiance), 2^-20.2 (direction), 2^-22.9 (shadow direction).

Also here: a CPU frame takes the plain path and counts no shade launch;
the wrapper refuses tensors of another device or dtype; and, marked
``gpu``, the CUDA build against the plain path on the card, to the bit,
and inside a captured CUDA graph.
"""

import dataclasses

import pytest
import torch

from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import shade_kernel as sk
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.render import pathtracer as tpathtracer
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.scene import types as ttypes
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

RES = 32  # 1,024 lanes a case
RR_START = 3
FRAME = 5
SCENES = ("area", "env", "mix", "colors32", "inst")
FORMS = ("split", "deferred", "none")
VARIANTS = ("base", "diet", "diffuse", "nee_rr")
FLOAT_TOL_LOG2 = -18  # the unpatched comparison: |Δ| <= 2^-18 of the lane's scale
FLIP_SHARE = 0.001


@pytest.fixture(scope="module")
def host_lib():
    return sk.load_host_kernels()


def _empty_lights(scene):
    """The scene's light list emptied: NEE samples the env alone."""
    z = torch.zeros((0,), dtype=torch.float32)
    em = ttypes.EmissiveTable(tri_ids=torch.zeros((0,), dtype=torch.int32), areas=z, cdf=z,
                              total_area=torch.tensor(0.0), count=torch.tensor(0, dtype=torch.int32),
                              light_table=torch.zeros((1, 16), dtype=torch.float32))
    return scene._replace(emissive=em)


def _with_colors(scene, seed):
    """32-lane shade rows: seeded vertex colours in lanes 16:25."""
    g = torch.Generator().manual_seed(seed)
    st = scene.shade_table
    wide = torch.zeros((st.shape[0], 32), dtype=torch.float32)
    wide[:, :16] = st
    wide[:, 16:25] = torch.rand((st.shape[0], 9), generator=g) * 0.8 + 0.2
    return scene._replace(shade_table=wide)


def _with_instances(scene, seed, n_inst=7):
    """Two-level rows: a seeded normal matrix and material row an instance,
    the override flag (lane 11) set on some."""
    g = torch.Generator().manual_seed(seed)
    mats = []
    for _ in range(n_inst):
        q_, _ = torch.linalg.qr(torch.randn((3, 3), generator=g, dtype=torch.float64))
        mats.append((q_ * (0.5 + torch.rand((3,), generator=g, dtype=torch.float64))).float().reshape(9))
    imat = torch.zeros((n_inst, 12), dtype=torch.float32)
    imat[:, 0:3] = torch.rand((n_inst, 3), generator=g)
    imat[:, 3:6] = torch.where(torch.rand((n_inst, 1), generator=g) > 0.7, 2.0, 0.0)
    imat[:, 6] = torch.rand((n_inst,), generator=g)
    imat[:, 7] = torch.rand((n_inst,), generator=g) * 0.9 + 0.05
    imat[:, 11] = (torch.arange(n_inst) % 2 == 0).float()
    return scene._replace(inst_normal_mats=torch.stack(mats), inst_mat_table=imat)


class Case:
    """A scene, its camera and brute-force backend, and a queue of primary
    hits at ``RES``x``RES``."""

    def __init__(self, name):
        if name in ("area", "colors32"):
            scene = tanalytic.cornell_box(device="cpu")
            cam = tanalytic.default_camera(device="cpu")
        else:
            scene, _ = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
            cam = tprocedural.atrium_camera(aspect=1.0, device="cpu")
        backend = tintersect.brute_backend(scene=scene, device="cpu")
        if name == "env":
            scene = _empty_lights(scene)
        elif name == "colors32":
            scene = _with_colors(scene, 3)
        elif name == "inst":
            scene = _with_instances(scene, 4)
        self.name, self.scene = name, scene
        self.isect, self.occl = backend.bind(backend.arrays)
        self.settings = RenderSettings(width=RES, height=RES, bounces=4, samples=1)
        self.o, self.d, self.sampler = twavefront.sample_rays(cam, self.settings, FRAME, 0)
        hit = self.isect(self.o, self.d)
        # Every 13th lane a miss, as a backend reports one (both scenes are
        # closed to these cameras).
        miss = torch.arange(self.o.shape[0]) % 13 == 0
        self.hit = hit._replace(t=torch.where(miss, 1e5, hit.t), uv=torch.where(miss[:, None], 0.0, hit.uv),
                                prim_id=torch.where(miss, -1, hit.prim_id).to(torch.int32), hit=hit.hit & ~miss)
        self.bounds = (torch.amin(scene.positions, dim=0), torch.amax(scene.positions, dim=0))

    def queue(self, b: int, seed: int):
        """Bounce 0: the first bounce's constant columns as stride-0 views,
        as ``render_frame`` builds them; later bounces: seeded throughput,
        radiance and pdf. A tenth of the hits are killed; misses stay dead."""
        n = self.o.shape[0]
        g = torch.Generator().manual_seed(seed)
        alive = self.hit.hit & (torch.rand((n,), generator=g) > 0.1)
        inst = None
        if self.name == "inst":
            inst = torch.randint(-1, self.scene.inst_mat_table.shape[0], (n,), generator=g, dtype=torch.int32)
        if b == 0:
            one = torch.ones((1, 3), dtype=torch.float32)
            thr, rad = one.expand(n, 3), torch.zeros_like(one).expand(n, 3)
            prev_pdf = torch.full((1,), 1e8, dtype=torch.float32).expand(n)
        else:
            thr = torch.rand((n, 3), generator=g) * 2.0
            rad = torch.rand((n, 3), generator=g)
            prev_pdf = torch.rand((n,), generator=g) * 4.0
        return twavefront.RayQueue(
            origin=self.o, direction=self.d, throughput=thr, radiance=rad,
            pixel_id=torch.arange(n, dtype=torch.int32), alive=alive, prev_pdf=prev_pdf, depth=self.hit.t,
            prim_id=self.hit.prim_id.to(torch.int32), uv=self.hit.uv, inst=inst)


_CASES = {}


def _case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


def _settings(case, variant):
    s = case.settings
    if variant == "diet":
        return dataclasses.replace(s, lane_diet=True)
    if variant == "diffuse":
        return dataclasses.replace(s, diffuse_only=True)
    if variant == "nee_rr":
        return dataclasses.replace(s, nee_rr_threshold=0.5)
    return s


class _CorrectlyRounded:
    """The plain path's sqrt, rsqrt, sin and cos through float64, so that
    they round as the host build's do."""

    def __init__(self, monkeypatch):
        sqrt, sin, cos = torch.sqrt, torch.sin, torch.cos

        def sqrt_rn(x):
            return sqrt(x.double()).float() if x.dtype == torch.float32 else sqrt(x)

        monkeypatch.setattr(torch, "sqrt", sqrt_rn)
        monkeypatch.setattr(torch, "rsqrt", lambda x: torch.reciprocal(sqrt_rn(x)))
        monkeypatch.setattr(torch, "sin", lambda x: sin(x.double()).float())
        monkeypatch.setattr(torch, "cos", lambda x: cos(x.double()).float())


def _shade_args(case, form, variant, b):
    s = _settings(case, variant)
    q = case.queue(b, seed=17 + b)
    occl = None if form == "none" else case.occl
    q_env = tpathtracer._env_mix_q(case.scene)
    use_nee = occl is not None and (int(case.scene.emissive.tri_ids.shape[0]) > 0 or q_env > 0.0)
    return (case.scene, q, case.sampler, s, b, use_nee, q_env, form == "deferred", occl, True, case.bounds,
            RR_START)


def _outputs(sh):
    """A ``_Shaded``'s tensors by name (the shadow batch's too)."""
    out = {k: getattr(sh, k) for k in ("radiance", "hit_pos", "new_dir", "throughput", "prev_pdf", "alive")}
    if sh.shadow is not None:
        out.update(zip(("shadow_o", "shadow_d", "shadow_t", "pre_ok", "contrib"), sh.shadow))
    if sh.q_throughput is not None:
        out["q_throughput"] = sh.q_throughput
    return out


def _bits(x):
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same_bits(got, want):
    assert got.sampler.index == want.sampler.index and got.sampler.seed is want.sampler.seed
    assert int(got.n_shadow) == int(want.n_shadow)
    g, w = _outputs(got), _outputs(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(_bits(g[k]), _bits(w[k])), f"{k}: {(_bits(g[k]) != _bits(w[k])).sum().item()} values differ"


_NEXT = ("hit_pos", "new_dir", "throughput", "prev_pdf")  # read on the next bounce where alive
_SHADOW = ("shadow_o", "shadow_d", "shadow_t", "contrib")  # read where pre_ok


def threshold_lanes(got, want) -> torch.Tensor:
    """Lanes where a bool differs, or a float output that reaches the film
    is beyond 2^FLOAT_TOL_LOG2 of its lane's scale (the largest magnitude
    of the lane's values of that output, at least 1e-30): the radiance on
    every lane, the next bounce's state where a side keeps the lane alive,
    the shadow batch where a side has it pre_ok. Elsewhere nothing reads
    them (the film's adds are masked, dead lanes are parked)."""
    g, w = _outputs(got), _outputs(want)
    n = w["alive"].shape[0]
    bad = torch.zeros((n,), dtype=torch.bool)
    read = {k: g["alive"] | w["alive"] for k in _NEXT}
    if "pre_ok" in w:
        read.update({k: g["pre_ok"] | w["pre_ok"] for k in _SHADOW})
    for k in w:
        a, b = g[k].reshape(n, -1), w[k].reshape(n, -1)
        if b.dtype == torch.bool:
            bad |= (a != b).any(dim=1)
            continue
        both_nan = torch.isnan(a) & torch.isnan(b)
        lane_scale = torch.clamp_min(torch.nan_to_num(b.abs(), posinf=0.0).amax(dim=1, keepdim=True), 1e-30)
        off = ((a - b).abs() > lane_scale * 2.0 ** FLOAT_TOL_LOG2) & ~both_nan
        bad |= off.any(dim=1) & read.get(k, torch.ones((n,), dtype=torch.bool))
    return bad


@pytest.mark.parametrize("b", [0, RR_START])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("scene", SCENES)
def test_kernel_matches_plain(scene, form, variant, b, host_lib, monkeypatch):
    case = _case(scene)
    args = _shade_args(case, form, variant, b)
    got = twavefront._shade_on_kernel(host_lib, *args)
    want = twavefront._shade_plain(*args)
    bad = threshold_lanes(got, want)
    assert bad.float().mean().item() <= FLIP_SHARE, f"{int(bad.sum())} of {bad.numel()} lanes part"
    _CorrectlyRounded(monkeypatch)
    assert_same_bits(got, twavefront._shade_plain(*args))


def test_cases_cover_branches_and_lanes():
    # The cases reach what they are meant to: each NEE branch, both row
    # widths, instance rows, dead and missed lanes, emitters hit.
    modes = {name: sk.nee_mode(_case(name).scene, True, tpathtracer._env_mix_q(_case(name).scene))
             for name in SCENES}
    assert modes == {"area": sk.NEE_AREA, "env": sk.NEE_ENV, "mix": sk.NEE_MIX, "colors32": sk.NEE_AREA,
                     "inst": sk.NEE_MIX}
    assert _case("colors32").scene.shade_table.shape[1] == 32
    for name in SCENES:
        case = _case(name)
        q = case.queue(RR_START, seed=17 + RR_START)
        assert (~case.hit.hit).any() and (case.hit.hit & ~q.alive).any() and q.alive.float().mean() > 0.3
        surf = ttypes.hit_surface_info(case.scene, q.prim_id, q.uv, q.inst)
        assert (surf.emissive.amax(dim=1) > 0).any() or name == "env"
    inst = _case("inst").queue(0, seed=17).inst
    assert (inst < 0).any() and (inst > 0).any()


def test_cpu_frame_takes_plain_path_and_counts_no_launch(monkeypatch):
    case = _case("mix")
    before = dict(ttk.LAUNCHES)

    def refuse(*a, **k):
        raise AssertionError("a CPU frame took the shade kernel")

    monkeypatch.setattr(twavefront, "_shade_on_kernel", refuse)
    img = twavefront.render_frame(case.scene, tprocedural.atrium_camera(aspect=1.0, device="cpu"),
                                  dataclasses.replace(case.settings, width=8, height=8), FRAME, case.isect, case.occl,
                                  sort_rays=True)
    assert torch.isfinite(img).all()
    assert ttk.LAUNCHES == before and all(ttk.LAUNCHES[k] == before[k] for k in ttk.SHADE_KEYS)
    assert not sk.covers(case.scene, "cpu")
    textured = tanalytic.textured_floor(False, device="cpu")[0]
    assert not sk.covers(textured, "cuda")
    assert not sk.covers(case.scene._replace(shade_table=None), "cuda")
    assert sk.covers(case.scene, "cuda")


def test_wrapper_refuses_other_devices_and_dtypes(host_lib):
    case = _case("area")
    q = case.queue(0, seed=1)
    s = case.settings
    kw = dict(emit_mis=False, roulette=False, q_env=0.0)
    with pytest.raises(ValueError, match="cannot take tensors"):
        sk.launch(type("CudaBuild", (), {"rt3_device_type": "cuda"})(), "deferred", sk.NEE_AREA, case.scene, q,
                  case.sampler.seed, 0, s, **kw)
    with pytest.raises(ValueError, match="origin must be"):
        sk.launch(host_lib, "deferred", sk.NEE_AREA, case.scene, q._replace(origin=q.origin.double()),
                  case.sampler.seed, 0, s, **kw)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        sk.launch(host_lib, "deferred", sk.NEE_AREA, case.scene, q._replace(direction=q.direction.t().contiguous().t()),
                  case.sampler.seed, 0, s, **kw)
    with pytest.raises(ValueError, match="no split_a pass"):
        sk.launch(host_lib, "split_a", sk.NEE_NONE, case.scene, q, case.sampler.seed, 0, s, **kw)
    with pytest.raises(ValueError, match="split_b needs"):
        sk.launch(host_lib, "split_b", sk.NEE_AREA, case.scene, q, case.sampler.seed, 0, s, **kw)


# -- on the card ------------------------------------------------------------


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    return x


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scene", SCENES)
def test_cuda_kernel_matches_plain_on_card(scene, variant):
    # The CUDA build against the plain path on the card: PyTorch's CUDA
    # kernels call the same sqrtf, rsqrtf, sinf and cosf, so every form and
    # bounce must agree to the bit.
    dev = _card()
    case = _case(scene)
    lib = sk.load_kernels()
    backend = tintersect.brute_backend(scene=_to(case.scene, dev), device=dev)
    _, occl = backend.bind(backend.arrays)
    for form in FORMS:
        for b in (0, RR_START):
            args = list(_to(_shade_args(case, form, variant, b), dev))
            args[2] = type(case.sampler)(case.sampler.seed.to(dev), case.sampler.index)
            args[8] = None if form == "none" else occl
            before = {k: ttk.LAUNCHES[k] for k in ttk.SHADE_KEYS}
            got = twavefront._shade_on_kernel(lib, *args)
            launched = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.SHADE_KEYS}
            assert launched == ({"shade_deferred": 0, "shade_split_a": 1, "shade_split_b": 1} if form == "split"
                                else {"shade_deferred": 1, "shade_split_a": 0, "shade_split_b": 0})
            assert_same_bits(got, twavefront._shade_plain(*args))


@pytest.mark.gpu
def test_cuda_kernel_captures_in_a_graph():
    dev = _card()
    case = _case("mix")
    lib = sk.load_kernels()
    args = list(_to(_shade_args(case, "deferred", "diet", RR_START), dev))
    args[2] = type(case.sampler)(case.sampler.seed.to(dev), case.sampler.index)
    eager = twavefront._shade_on_kernel(lib, *args)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        twavefront._shade_on_kernel(lib, *args)
        with torch.cuda.graph(graph, stream=side):
            captured = twavefront._shade_on_kernel(lib, *args)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert_same_bits(captured, eager)
