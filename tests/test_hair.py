"""Hair BSDF tests — mirrors the reference's hair tests (bsdfs_test.cpp:
WhiteFurnace / SamplingConsistency idiom for HairBxDF).

The scattering model is energy preserving: with sigma_a = 0 the full-sphere
integral of f |cos theta_i| must be 1 for any roughness/h. Sampling must be
consistent with pdf (E[f cos / pdf] equals the same integral) and pdf must
integrate to 1 over the sphere."""

import numpy as np
import jax
import jax.numpy as jnp

from nn_bvh.scatter import hair
from nn_bvh.core import sampling

N = 1 << 16


def _uniform_sphere(key, n):
    u = jax.random.uniform(key, (n, 2))
    return sampling.sample_uniform_sphere(u)


def _furnace_integral(wo, h, beta_m, beta_n, key):
    """Monte-Carlo full-sphere integral of f * |cos| with sigma_a = 0."""
    wi = _uniform_sphere(key, N)
    sig = jnp.zeros((N, 4))
    args = lambda x: jnp.full((N,), x, jnp.float32)
    fv = hair.f(jnp.broadcast_to(wo, (N, 3)), wi, args(h), args(1.55), sig,
                args(beta_m), args(beta_n))
    cos_i = jnp.abs(wi[..., 2])
    est = jnp.mean(fv[..., 0] * cos_i) / sampling.UNIFORM_SPHERE_PDF
    return float(est)


def test_white_furnace():
    key = jax.random.PRNGKey(0)
    wo = jnp.asarray([0.3, 0.8, np.sqrt(1 - 0.09 - 0.64)], jnp.float32)
    for i, (bm, bn, h) in enumerate([(0.3, 0.4, 0.2), (0.6, 0.6, -0.5),
                                     (0.9, 0.9, 0.0)]):
        est = _furnace_integral(wo, h, bm, bn, jax.random.PRNGKey(i))
        assert abs(est - 1.0) < 0.12, (bm, bn, h, est)


def test_pdf_integrates_to_one():
    wo = jnp.asarray([0.1, 0.7, np.sqrt(1 - 0.01 - 0.49)], jnp.float32)
    wi = _uniform_sphere(jax.random.PRNGKey(7), N)
    args = lambda x: jnp.full((N,), x, jnp.float32)
    sig = jnp.full((N, 4), 0.25)
    p = hair.pdf(jnp.broadcast_to(wo, (N, 3)), wi, args(0.3), args(1.55),
                 sig, args(0.4), args(0.5))
    est = float(jnp.mean(p) / sampling.UNIFORM_SPHERE_PDF)
    assert abs(est - 1.0) < 0.08, est


def test_sampling_consistency():
    """E[f cos / pdf] over sample_f draws equals the furnace integral (=1
    with sigma_a = 0); also checks pdf > 0 wherever f > 0 along samples."""
    n = N
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    wo = jnp.asarray([0.25, 0.55, np.sqrt(1 - 0.0625 - 0.3025)], jnp.float32)
    wo_b = jnp.broadcast_to(wo, (n, 3))
    args = lambda x: jnp.full((n,), x, jnp.float32)
    sig = jnp.zeros((n, 4))
    uc = jax.random.uniform(k1, (n,))
    u2 = jax.random.uniform(k2, (n, 2))
    wi, fv, pdf = hair.sample_f(wo_b, args(0.1), args(1.55), sig,
                                args(0.5), args(0.4), uc, u2)
    ok = pdf > 1e-9
    w = jnp.where(ok, fv[..., 0] * jnp.abs(wi[..., 2])
                  / jnp.maximum(pdf, 1e-9), 0.0)
    est = float(jnp.mean(w))
    assert abs(est - 1.0) < 0.15, est
    assert float(jnp.mean(ok.astype(jnp.float32))) > 0.99


def test_absorption_darkens():
    """sigma_a > 0 must strictly reduce the TT/TRT energy."""
    wo = jnp.asarray([0.0, 0.6, 0.8], jnp.float32)
    e_white = _furnace_integral(wo, 0.3, 0.5, 0.5, jax.random.PRNGKey(9))
    wi = _uniform_sphere(jax.random.PRNGKey(9), N)
    args = lambda x: jnp.full((N,), x, jnp.float32)
    sig = jnp.full((N, 4), 1.5)
    fv = hair.f(jnp.broadcast_to(wo, (N, 3)), wi, args(0.3), args(1.55),
                sig, args(0.5), args(0.5))
    e_dark = float(jnp.mean(fv[..., 0] * jnp.abs(wi[..., 2]))
                   / sampling.UNIFORM_SPHERE_PDF)
    assert e_dark < e_white - 0.1, (e_dark, e_white)


def test_material_dispatch():
    """A hair material flows through gather/evaluate/sample lane dispatch."""
    from nn_bvh.geometry import scene as scene_mod
    from nn_bvh.scatter import bxdf

    b = scene_mod.SceneBuilder()
    hm = b.add_material("hair", reflectance=(0.4, 0.25, 0.1),
                        roughness=0.3, beta_n=0.4, eta=1.55)
    b.add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), hm)
    sc = b.build()
    lam = jnp.full((8, 4), 550.0)
    uv = jnp.linspace(0.0, 1.0, 16).reshape(8, 2)
    ctx = bxdf.gather_material(sc, jnp.zeros((8,), jnp.int32), lam, None, uv)
    assert ctx.h is not None
    wo = jnp.broadcast_to(jnp.asarray([0.3, 0.4, np.sqrt(0.75)]), (8, 3))
    wi = jnp.broadcast_to(jnp.asarray([-0.2, 0.5, np.sqrt(0.71)]), (8, 3))
    f, pdf = bxdf.evaluate(ctx, wo.astype(jnp.float32), wi.astype(jnp.float32))
    assert np.all(np.isfinite(np.asarray(f))) and np.all(np.asarray(f) >= 0)
    assert np.all(np.asarray(pdf) > 0)
    bs = bxdf.sample(ctx, wo.astype(jnp.float32), jnp.full((8,), 0.4),
                     jnp.full((8, 2), 0.3))
    assert np.all(np.isfinite(np.asarray(bs.f)))
    assert np.all(np.asarray(bs.valid))
