"""BRDF sampling and evaluation: Lambert diffuse + GGX specular with VNDF
sampling and height-correlated Smith masking (the parts of
``raytracer3_tpu_torch/ops/brdf.py`` that the benchmark's plain reference
uses, frozen). Local tangent frame (+z = normal); invalid
samples are masked to zero, never branched."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rtbench.reference import mathx

BRDF_SAMPLING_MIN_COS = 1e-5
TAU = mathx.TAU
INV_PI = mathx.INV_PI


class BrdfSample(NamedTuple):
    wi: torch.Tensor  # [..., 3] sampled incident direction (local frame)
    value_over_pdf: torch.Tensor  # [..., 3]
    value: torch.Tensor  # [..., 3]
    pdf: torch.Tensor  # [...]
    valid: torch.Tensor  # [...] bool
    approx_roughness: torch.Tensor  # [...]


class BrdfValue(NamedTuple):
    value_over_pdf: torch.Tensor
    value: torch.Tensor
    pdf: torch.Tensor


def _unit_z(like: torch.Tensor, z: float) -> torch.Tensor:
    out = torch.zeros_like(like)
    out[..., 2] = z
    return out


def fresnel_schlick_rgb(f0: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """RGB f0, scalar f90 = 1."""
    m = torch.clamp_min(1.0 - cos_theta, 0.0)
    m5 = m * m * m * m * m
    return f0 + (1.0 - f0) * m5[..., None]


def g_smith_ggx_correlated(ndotv, ndotl, a2):
    lambda_v = ndotl * torch.sqrt((-ndotv * a2 + ndotv) * ndotv + a2)
    lambda_l = ndotv * torch.sqrt((-ndotl * a2 + ndotl) * ndotl + a2)
    return 2.0 * ndotl * ndotv / torch.clamp_min(lambda_v + lambda_l, 1e-20)


def g_smith_ggx1(ndotv, a2):
    nv2 = torch.clamp_min(ndotv * ndotv, 1e-20)
    tan2_v = (1.0 - nv2) / nv2
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2_v))


def ggx_ndf(a2, cos_theta):
    denom_sqrt = cos_theta * cos_theta * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom_sqrt * denom_sqrt, 1e-20)


def pdf_ggx_vn(a2, wo, h):
    """Visible-normal pdf (brdf.slang:166-170)."""
    g1 = g_smith_ggx1(wo[..., 2], a2)
    d = ggx_ndf(a2, h[..., 2])
    return g1 * d * torch.clamp_min(mathx.dot(wo, h, keepdims=False), 0.0) / torch.clamp_min(
        wo[..., 2], 1e-20
    )


def sample_vndf(alpha, wo: torch.Tensor, urand: torch.Tensor) -> torch.Tensor:
    """Sample the GGX distribution of visible normals (Heitz 2018;
    brdf.slang:185-215). Returns the half-vector h in the local frame."""
    alpha = torch.broadcast_to(torch.as_tensor(alpha, dtype=wo.dtype, device=wo.device), wo.shape[:-1])
    vh = mathx.normalize(torch.stack([alpha * wo[..., 0], alpha * wo[..., 1], wo[..., 2]], dim=-1))
    t1 = torch.where(
        vh[..., 2:3] < 0.9999,
        mathx.normalize(mathx.cross(_unit_z(vh, 1.0), vh)),
        mathx.const((1.0, 0.0, 0.0), vh.dtype, vh.device),
    )
    t2 = mathx.cross(vh, t1)
    r = torch.sqrt(urand[..., 0])
    phi = TAU * urand[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))[..., None] * vh
    )
    return mathx.normalize(
        torch.stack([alpha * nh[..., 0], alpha * nh[..., 1], torch.clamp_min(nh[..., 2], 0.0)], dim=-1)
    )


def diffuse_sample(albedo: torch.Tensor, urand: torch.Tensor) -> BrdfSample:
    """Cosine-hemisphere sample (brdf.slang:56-73)."""
    wi = mathx.cosine_sample_hemisphere(urand)
    pdf = torch.full(wi.shape[:-1], INV_PI, dtype=wi.dtype, device=wi.device)
    vop = torch.broadcast_to(albedo, wi.shape[:-1] + (3,))
    return BrdfSample(
        wi=wi,
        value_over_pdf=vop,
        value=vop * pdf[..., None],
        pdf=pdf,
        valid=wi[..., 2] > 1e-6,
        approx_roughness=torch.ones(wi.shape[:-1], dtype=wi.dtype, device=wi.device),
    )


def diffuse_evaluate(albedo: torch.Tensor, wi: torch.Tensor) -> BrdfValue:
    """brdf.slang:76-83."""
    up = wi[..., 2] > 0.0
    pdf = torch.where(up, INV_PI, 0.0)
    vop = torch.where(up[..., None], albedo, 0.0)
    return BrdfValue(value_over_pdf=vop, value=vop * pdf[..., None], pdf=pdf)


def specular_sample(roughness, f0_albedo, wo, urand) -> BrdfSample:
    """brdf.slang:217-267 with USE_GGX_VNDF_SAMPLING=1."""
    roughness = torch.broadcast_to(torch.as_tensor(roughness, dtype=wo.dtype, device=wo.device), wo.shape[:-1])
    a2 = roughness * roughness
    h = sample_vndf(roughness, wo, urand)
    ndf_pdf = pdf_ggx_vn(a2, wo, h)
    wi = mathx.reflect(-wo, h)
    valid = (
        (h[..., 2] > BRDF_SAMPLING_MIN_COS)
        & (wi[..., 2] > BRDF_SAMPLING_MIN_COS)
        & (wo[..., 2] > BRDF_SAMPLING_MIN_COS)
    )
    jacobian = 1.0 / torch.clamp_min(4.0 * mathx.dot(wi, h, keepdims=False), 1e-20)
    fresnel = fresnel_schlick_rgb(f0_albedo, mathx.dot(h, wi, keepdims=False))
    g = g_smith_ggx_correlated(wo[..., 2], wi[..., 2], a2)
    g_over_g1_wo = g / torch.clamp_min(g_smith_ggx1(wo[..., 2], a2), 1e-20)
    pdf = ndf_pdf * jacobian / torch.clamp_min(wi[..., 2], 1e-20)
    value_over_pdf = fresnel * g_over_g1_wo[..., None]
    value = fresnel * (
        g * ggx_ndf(a2, h[..., 2]) / torch.clamp_min(4.0 * wo[..., 2] * wi[..., 2], 1e-20)
    )[..., None]
    z = torch.zeros_like(value)
    return BrdfSample(
        wi=torch.where(valid[..., None], wi, _unit_z(wi, -1.0)),
        value_over_pdf=torch.where(valid[..., None], value_over_pdf, z),
        value=torch.where(valid[..., None], value, z),
        pdf=torch.where(valid, pdf, 0.0),
        valid=valid,
        approx_roughness=roughness,
    )


def specular_evaluate(roughness, f0_albedo, wo, wi) -> BrdfValue:
    """brdf.slang:269-303 with VNDF pdf."""
    roughness = torch.broadcast_to(torch.as_tensor(roughness, dtype=wo.dtype, device=wo.device), wo.shape[:-1])
    a2 = roughness * roughness
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    m = mathx.normalize(wo + wi)
    pdf_h = pdf_ggx_vn(a2, wo, m)
    jacobian = 1.0 / torch.clamp_min(4.0 * mathx.dot(wi, m, keepdims=False), 1e-20)
    fresnel = fresnel_schlick_rgb(f0_albedo, mathx.dot(m, wi, keepdims=False))
    g = g_smith_ggx_correlated(wo[..., 2], wi[..., 2], a2)
    g_over_g1_wo = g / torch.clamp_min(g_smith_ggx1(wo[..., 2], a2), 1e-20)
    pdf = pdf_h * jacobian / torch.clamp_min(wi[..., 2], 1e-20)
    value_over_pdf = fresnel * g_over_g1_wo[..., None]
    value = fresnel * (
        g * ggx_ndf(a2, m[..., 2]) / torch.clamp_min(4.0 * wo[..., 2] * wi[..., 2], 1e-20)
    )[..., None]
    z = torch.zeros_like(value)
    return BrdfValue(
        value_over_pdf=torch.where(valid[..., None], value_over_pdf, z),
        value=torch.where(valid[..., None], value, z),
        pdf=torch.where(valid, pdf, 0.0),
    )


def _lobe_setup(albedo, metalness, wo):
    f0 = mathx.lerp(torch.full_like(albedo, 0.04), albedo, metalness[..., None])
    kd = albedo * (1.0 - metalness[..., None])
    # Lobe-selection probability from the average fresnel at wo.
    f_avg = torch.mean(fresnel_schlick_rgb(f0, torch.clamp_min(wo[..., 2], 0.0)), dim=-1)
    d_avg = torch.mean(kd, dim=-1)
    p_spec = torch.clamp(f_avg / torch.clamp_min(f_avg + d_avg, 1e-6), 0.05, 0.95)
    return f0, kd, p_spec


def surface_sample(albedo, roughness, metalness, wo, urand3) -> BrdfSample:
    """Sample the combined diffuse+specular surface: pick the lobe by the
    fresnel-weighted specular probability, then MIS-combine pdfs."""
    f0, kd, p_spec = _lobe_setup(albedo, metalness, wo)
    pick_spec = urand3[..., 2] < p_spec
    u2 = urand3[..., :2]
    ds = diffuse_sample(kd, u2)
    ss = specular_sample(roughness, f0, wo, u2)
    wi = torch.where(pick_spec[..., None], ss.wi, ds.wi)
    dv = diffuse_evaluate(kd, wi)
    sv = specular_evaluate(roughness, f0, wo, wi)
    pdf = p_spec * sv.pdf + (1.0 - p_spec) * dv.pdf
    value = dv.value + sv.value
    vop = value / torch.clamp_min(pdf, 1e-20)[..., None]
    valid = torch.where(pick_spec, ss.valid, ds.valid) & (pdf > 0.0)
    z = torch.zeros_like(vop)
    return BrdfSample(
        wi=wi,
        value_over_pdf=torch.where(valid[..., None], vop, z),
        value=torch.where(valid[..., None], value, z),
        pdf=torch.where(valid, pdf, 0.0),
        valid=valid,
        approx_roughness=torch.where(pick_spec, roughness, torch.ones_like(roughness)),
    )


def surface_evaluate(albedo, roughness, metalness, wo, wi) -> BrdfValue:
    """Evaluate the combined surface BRDF (for NEE/MIS)."""
    f0, kd, p_spec = _lobe_setup(albedo, metalness, wo)
    dv = diffuse_evaluate(kd, wi)
    sv = specular_evaluate(roughness, f0, wo, wi)
    pdf = p_spec * sv.pdf + (1.0 - p_spec) * dv.pdf
    value = dv.value + sv.value
    return BrdfValue(value_over_pdf=value / torch.clamp_min(pdf, 1e-20)[..., None], value=value, pdf=pdf)
