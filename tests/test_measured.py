"""Measured/tabulated BRDF tests (MeasuredBxDF, base/bxdf.h:166; bxdfs.h —
RGL table evaluation). Our table is a dense (mu_o, mu_i, dphi) grid; tests
tabulate analytic BRDFs and check round-trip accuracy, sampling consistency,
and end-to-end dispatch + render agreement with the analytic material."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nn_bvh.scatter import measured
from nn_bvh.core import sampling


def _lambertian(albedo=0.6):
    return lambda wo, wi: np.full(wo.shape[:-1] + (3,), albedo / np.pi,
                                  np.float32)


def test_tabulate_roundtrip_lambertian():
    """A tabulated constant BRDF must evaluate back exactly (uplift of a
    constant RGB is wavelength-flat to rgb2spec fit accuracy)."""
    tab = measured.table_to_coeffs(measured.tabulate(_lambertian(0.6)))
    tabs = jnp.asarray(tab)[None]
    n = 4096
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    wo = sampling.sample_cosine_hemisphere(jax.random.uniform(k1, (n, 2)))
    wi = sampling.sample_cosine_hemisphere(jax.random.uniform(k2, (n, 2)))
    lam = jnp.full((n, 4), 550.0)
    f = measured.f(tabs, jnp.zeros((n,), jnp.int32), wo, wi, lam)
    ref = 0.6 / np.pi
    err = float(jnp.max(jnp.abs(f - ref)))
    assert err < 0.02 * ref + 5e-3, err


def test_tabulated_ggx_matches_analytic():
    """Tabulate our own rough-conductor evaluate() and compare the table
    lookup against the analytic value at random direction pairs."""
    from nn_bvh.scatter import bxdf
    from nn_bvh.geometry import scene as scene_mod

    alpha_rough = 0.4

    def make_ctx(shape):
        return bxdf.MaterialCtx(
            mat_type=jnp.full(shape, scene_mod.MAT_CONDUCTOR, jnp.int32),
            refl=jnp.full(shape + (4,), 0.9),
            ax=jnp.full(shape, alpha_rough), ay=jnp.full(shape, alpha_rough),
            eta=jnp.full(shape, 0.2), k=jnp.full(shape, 3.9))

    def analytic_rgb(wo, wi):
        ctx = make_ctx(wo.shape[:-1])
        f, _ = bxdf.evaluate(ctx, jnp.asarray(wo), jnp.asarray(wi))
        return np.asarray(f[..., :3])

    tab = measured.table_to_coeffs(measured.tabulate(analytic_rgb,
                                                     res=(32, 32, 32)))
    tabs = jnp.asarray(tab)[None]
    n = 2048
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    # keep away from grazing angles where the table undersamples the lobe
    wo = sampling.sample_cosine_hemisphere(
        jax.random.uniform(k1, (n, 2), minval=0.1, maxval=0.9))
    wi = sampling.sample_cosine_hemisphere(
        jax.random.uniform(k2, (n, 2), minval=0.1, maxval=0.9))
    lam = jnp.full((n, 4), 550.0)
    f_tab = measured.f(tabs, jnp.zeros((n,), jnp.int32), wo, wi, lam)
    f_ref = jnp.asarray(analytic_rgb(np.asarray(wo), np.asarray(wi)))
    rel = jnp.abs(f_tab[..., 0] - f_ref[..., 0]) / (f_ref[..., 0] + 0.05)
    assert float(jnp.mean(rel)) < 0.15, float(jnp.mean(rel))


def test_sampling_consistency():
    """E[f cos / pdf] over sample_f equals the hemispherical albedo."""
    tab = measured.table_to_coeffs(measured.tabulate(_lambertian(0.5)))
    tabs = jnp.asarray(tab)[None]
    n = 1 << 14
    wo = jnp.broadcast_to(jnp.asarray([0.3, 0.2, np.sqrt(1 - 0.13)]),
                          (n, 3)).astype(jnp.float32)
    u2 = jax.random.uniform(jax.random.PRNGKey(5), (n, 2))
    lam = jnp.full((n, 4), 550.0)
    wi, f, pdf = measured.sample_f(tabs, jnp.zeros((n,), jnp.int32), wo,
                                   lam, u2)
    est = float(jnp.mean(f[..., 0] * jnp.abs(wi[..., 2])
                         / jnp.maximum(pdf, 1e-9)))
    assert abs(est - 0.5) < 0.02, est


@pytest.mark.slow
def test_render_dispatch_matches_diffuse():
    """End to end: a scene whose floor uses a tabulated Lambertian renders
    the same as the analytic diffuse floor (integrator + dispatch path)."""
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf
    from nn_bvh.wavefront import camera as camera_mod, integrator

    def build(use_measured):
        b = scene_mod.SceneBuilder()
        if use_measured:
            tid = b.add_measured_brdf(measured.tabulate(_lambertian(0.7)))
            m = b.add_material("measured", measured=tid)
        else:
            m = b.add_material("diffuse", reflectance=(0.7, 0.7, 0.7))
        b.add_quad((-5, -1, -5), (5, -1, -5), (5, -1, 5), (-5, -1, 5), m)
        b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1),
                   b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5)),
                   emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
        sc = b.build()
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        cam = camera_mod.make_perspective(
            xf.look_at((0, 1.0, -4), (0, 0, 0), (0, 1, 0)), fov=60.0,
            width=16, height=16)
        return sc, dbvh, cam

    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, rr_depth=99)
    img_a = integrator.render(*build(False), spp=16, seed=1, cfg=cfg)
    img_m = integrator.render(*build(True), spp=16, seed=1, cfg=cfg)
    m_a, m_m = float(jnp.mean(img_a)), float(jnp.mean(img_m))
    # tabulated Lambertian at 0.7 vs analytic diffuse 0.7 (rgb2spec uplift on
    # both sides): means agree within the reference's integrator band
    assert abs(m_a - m_m) < 0.03, (m_a, m_m)
