"""TabulatedBSSRDF (scatter/bssrdf.py) + wavefront subsurface stage.

Mirrors the reference's test strategy for sampling code (SURVEY.md §4.2):
sample-vs-pdf histogram agreement for Sr, table invariants, and an
end-to-end render of a subsurface sphere (no NaNs, bounded energy —
cpu/integrators_test.cpp idiom)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nn_bvh.scatter import bssrdf as bss


@pytest.fixture(scope="module")
def table():
    return bss.compute_beam_diffusion_table(g=0.0, eta=1.33)


def test_rho_eff_monotone_bounded(table):
    rho_eff = np.asarray(table.rho_eff)
    assert np.all(np.diff(rho_eff) >= -1e-6)
    assert rho_eff[0] == 0.0
    assert 0.5 < rho_eff[-1] <= 1.05  # eta=1.33 Fresnel keeps it under 1


def test_profile_nonnegative_decaying(table):
    prof = np.asarray(table.profile)
    assert np.all(prof >= 0)
    # beyond a few mean free paths the profile must have decayed
    assert np.all(prof[:, -1] < np.maximum(prof.max(axis=1) * 1e-3, 1e-12))


def test_sr_sample_matches_pdf(table):
    """Histogram of sampled radii vs the analytic area pdf (chi-squared-ish
    agreement, the bsdfs_test.cpp idiom)."""
    n = 20000
    rs = np.random.RandomState(0)
    u = jnp.asarray(rs.rand(n).astype(np.float32))
    sigma_t = jnp.full((n,), 1.0, jnp.float32)
    rho = jnp.full((n,), 0.8, jnp.float32)
    r, pdf, rho_eff = jax.jit(bss.sr_sample)(table, sigma_t, rho, u)
    r = np.asarray(r)
    assert np.isfinite(r).all() and (r >= 0).all()
    # pdf at the sampled radius should integrate to ~1 over area:
    # E[1/(2 pi r pdf_area(r))] * ... simpler: bin the samples and compare
    # normalized counts against pdf * 2 pi r dr
    edges = np.linspace(0.0, float(np.percentile(r, 98)), 24)
    hist, _ = np.histogram(r, edges)
    centers = 0.5 * (edges[1:] + edges[:-1])
    pdf_c = np.asarray(jax.jit(bss.sr_pdf)(
        table, jnp.full_like(jnp.asarray(centers, jnp.float32), 1.0),
        jnp.full_like(jnp.asarray(centers, jnp.float32), 0.8),
        jnp.asarray(centers, jnp.float32)))
    expect = pdf_c * np.diff(edges)
    expect = expect / expect.sum()
    got = hist / hist.sum()
    mask = expect > 0.01
    assert np.abs(got[mask] - expect[mask]).max() < 0.05, \
        np.abs(got - expect).max()


def test_sr_eval_scaling(table):
    """Sr scales as sigma_t^2 with radius in mfp units (bssrdf.h scaling)."""
    r = jnp.asarray([0.05, 0.2, 0.7], jnp.float32)
    rho = jnp.full((3,), 0.6, jnp.float32)
    a = np.asarray(bss.sr_eval(table, jnp.full((3,), 1.0), rho, r))
    b = np.asarray(bss.sr_eval(table, jnp.full((3,), 2.0), rho, r / 2.0))
    np.testing.assert_allclose(b, 4.0 * a, rtol=1e-4)


@pytest.fixture(scope="module")
def sss_scene():
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf
    from nn_bvh.wavefront import camera as camera_mod

    b = scene_mod.SceneBuilder()
    sss = b.add_material("subsurface", sigma_a=(0.02, 0.04, 0.07),
                         sigma_s=(2.2, 2.6, 3.0), sss_scale=2.0, eta=1.33)
    floor = b.add_material("diffuse", reflectance=(0.4, 0.4, 0.4))
    b.add_sphere((0, 0.7, 0), 0.7, sss, n_theta=12, n_phi=24)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), floor)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), floor,
               emission_rgb=(1, 1, 1), emission_scale=10.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.6, -3.2), (0, 0.7, 0), (0, 1, 0)), fov=45.0,
        width=24, height=24)
    return sc, dbvh, cam


def test_subsurface_scene_flags(sss_scene):
    sc, _, _ = sss_scene
    assert sc.feat_subsurface
    assert sc.sss_profile.shape[0] == 1
    assert np.isfinite(np.asarray(sc.sss_profile)).all()


def test_subsurface_sphere_renders(sss_scene):
    from nn_bvh.wavefront import integrator

    sc, dbvh, cam = sss_scene
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True, traversal="xla")
    img = np.asarray(integrator.render(sc, dbvh, cam, spp=4,
                                       sampler="independent", cfg=cfg))
    assert np.isfinite(img).all(), "subsurface render produced NaN/inf"
    assert img.mean() > 1e-3, "subsurface render is black"
    # the sphere is strongly scattering, weakly absorbing: bounded energy
    assert img.mean() < 10.0, img.mean()
    # center of the sphere (lit from above) must be visibly non-black
    c = img[8:16, 8:16].mean()
    assert c > 1e-3, c
