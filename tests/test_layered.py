"""Stochastic LayeredBxDF unit tests (scatter/layered.py vs bxdfs.h:432).

Reference-parity at render level is gated by tools/probe_material.py (the
crown coated materials match the pbrt-v4 CPU binary within ~1% under a
uniform light). These tests lock in the estimator invariants that don't need
the reference binary."""

import numpy as np
import jax.numpy as jnp
import pytest

from nn_bvh.core import vecmath as vm
from nn_bvh.geometry import scene as sm
from nn_bvh.scatter import bxdf, layered


def _ctx(n, mat=sm.MAT_COATED_DIFFUSE, refl=0.6, ax=0.0, eta=1.5, k=0.0,
         coat_ax=0.1):
    return bxdf.MaterialCtx(
        mat_type=jnp.full((n,), mat, jnp.int32),
        refl=jnp.full((n, 4), refl),
        ax=jnp.full((n,), ax), ay=jnp.full((n,), ax),
        eta=jnp.full((n,), eta), k=jnp.full((n,), k),
        coat_ax=jnp.full((n,), coat_ax))


def _dirs(n, seed=0, up=True):
    rs = np.random.RandomState(seed)
    w = rs.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    if up:
        w[:, 2] = np.abs(w[:, 2])
    return jnp.asarray(w, jnp.float32)


def test_eta_one_reduces_to_base():
    """Coat with eta -> 1 and zero roughness is a no-op interface: f must be
    the base diffuse refl/pi up to the layer's Tr attenuation (~4%)."""
    n = 8192
    ctx = _ctx(n, refl=0.6, eta=1.0001, coat_ax=0.0)
    wo = vm.normalize(jnp.broadcast_to(jnp.asarray([0.3, 0.2, 0.9]), (n, 3)))
    wi = _dirs(n, 1)
    cc = jnp.zeros((n,), bool)
    f = layered.coated_f(ctx, wo, wi, cc)
    mean = float(jnp.mean(f))
    want = 0.6 / np.pi
    assert abs(mean - want) / want < 0.08, (mean, want)


@pytest.mark.parametrize("coat_ax", [0.0, 0.102, 0.447])
def test_energy_bounded(coat_ax):
    """White coated diffuse: directional albedo stays <= 1 for smooth,
    crown-like, and very rough coats."""
    n = 16384
    ctx = _ctx(n, refl=1.0, coat_ax=coat_ax)
    wo = vm.normalize(jnp.broadcast_to(jnp.asarray([0.3, 0.2, 0.9]), (n, 3)))
    wi = _dirs(n, 2)
    cc = jnp.zeros((n,), bool)
    f = layered.coated_f(ctx, wo, wi, cc)
    assert bool(jnp.all(jnp.isfinite(f)))
    alb = float(jnp.mean(f[:, 0] * wi[:, 2]) * 2 * np.pi)
    assert 0.0 < alb <= 1.01, alb


def test_opposite_hemisphere_zero():
    """Opaque base: transmission through the stack is zero."""
    n = 1024
    ctx = _ctx(n)
    wo = vm.normalize(jnp.broadcast_to(jnp.asarray([0.3, 0.2, 0.9]), (n, 3)))
    wi = _dirs(n, 3) * jnp.asarray([1.0, 1.0, -1.0])
    cc = jnp.zeros((n,), bool)
    f = layered.coated_f(ctx, wo, wi, cc)
    assert float(jnp.max(jnp.abs(f))) == 0.0


def test_two_sided_flip_symmetry():
    """twoSided: the query (wo, wi) equals (-wo, -wi) exactly (same RNG seed
    path after the internal flip)."""
    n = 1024
    ctx = _ctx(n, coat_ax=0.2)
    wo = _dirs(n, 4)
    wi = _dirs(n, 5)
    cc = jnp.zeros((n,), bool)
    f1 = layered.coated_f(ctx, wo, wi, cc)
    f2 = layered.coated_f(ctx, -wo, -wi, cc)
    assert np.allclose(np.asarray(f1), np.asarray(f2), rtol=1e-5, atol=1e-7)


def test_pdf_floor_and_finite():
    """PDF estimate is >= the 0.1/(4pi) uniform floor and finite (the
    reference's Lerp(0.9, 1/(4 Pi), pdfSum) mixture)."""
    n = 4096
    ctx = _ctx(n, coat_ax=0.3)
    wo = _dirs(n, 6)
    wi = _dirs(n, 7)
    cc = jnp.zeros((n,), bool)
    pdf = layered.coated_pdf(ctx, wo, wi, cc)
    assert bool(jnp.all(jnp.isfinite(pdf)))
    assert float(jnp.min(pdf)) >= 0.1 / (4 * np.pi) - 1e-6


def test_sample_exits_upward_and_beta_consistent():
    """Sampled directions stay in wo's hemisphere (opaque base) and the
    sampled hemispherical-reflectance estimate agrees with the f-walk
    estimate within the truncation envelope."""
    n = 40000
    rs = np.random.RandomState(0)
    ctx = _ctx(n, refl=0.8, coat_ax=0.102)
    wo = vm.normalize(jnp.broadcast_to(jnp.asarray([0.3, 0.2, 0.9]), (n, 3)))
    uc = jnp.asarray(rs.rand(n), jnp.float32)
    u2 = jnp.asarray(rs.rand(n, 2), jnp.float32)
    cc = jnp.zeros((n,), bool)
    wi, f, pdf, ok, spec = layered.coated_sample(ctx, wo, uc, u2, cc)
    ok_np = np.asarray(ok)
    assert np.all(np.asarray(wi)[ok_np, 2] > 0)
    est_s = float(np.mean(np.where(
        ok_np, np.asarray(f[:, 0] * jnp.abs(wi[:, 2])
                          / jnp.maximum(pdf, 1e-12)), 0.0)))
    wi_u = _dirs(n, 8)
    f_u = layered.coated_f(ctx, wo, wi_u, cc)
    est_u = float(jnp.mean(f_u[:, 0] * wi_u[:, 2]) * 2 * np.pi)
    assert abs(est_s - est_u) / est_u < 0.12, (est_s, est_u)


def test_coated_conductor_base():
    """CoatedConductor: smooth coat over rough gold-ish base — finite,
    energy-bounded, and brighter than the bare Fresnel-attenuated base at
    normal incidence (the coat adds its own reflection)."""
    n = 16384
    ctx = _ctx(n, mat=sm.MAT_COATED_CONDUCTOR, refl=1.0, ax=0.3, eta=0.2,
               k=3.9, coat_ax=0.2)
    wo = vm.normalize(jnp.broadcast_to(jnp.asarray([0.1, 0.0, 0.99]), (n, 3)))
    wi = _dirs(n, 9)
    cc = jnp.ones((n,), bool)
    f = layered.coated_f(ctx, wo, wi, cc)
    assert bool(jnp.all(jnp.isfinite(f)))
    alb = float(jnp.mean(f[:, 0] * wi[:, 2]) * 2 * np.pi)
    assert 0.0 < alb <= 1.01, alb
