"""End-to-end integrator tests on analytic scenes.

Mirrors the reference's `cpu/integrators_test.cpp`: in-memory scenes whose
converged radiance is known analytically, rendered through the real
integrator, mean image value asserted within the same +-0.025 tolerance
(integrators_test.cpp:55,64).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator

RES = 24
TOL = 0.025


def furnace_scene(albedo=0.5, le=0.5):
    """Camera inside a big emissive+diffuse sphere: L = le / (1 - albedo)."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(albedo, albedo, albedo))
    b.add_sphere((0, 0, 0), 10.0, m, n_theta=24, n_phi=48,
                 emission_rgb=(1, 1, 1), emission_scale=le, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=90.0, width=RES, height=RES
    )
    return sc, dbvh, cam


def quad_light_scene():
    """Diffuse floor lit by an overhead area light; plus direct-view emitter."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.7, 0.7, 0.7))
    b.add_quad((-5, -1, -5), (5, -1, -5), (5, -1, 5), (-5, -1, 5), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.0, -4), (0, 0, 0), (0, 1, 0)), fov=60.0, width=RES, height=RES
    )
    return sc, dbvh, cam


class TestFurnace:
    @pytest.mark.parametrize("mis", [False, True])
    def test_furnace_converges_to_analytic(self, mis):
        sc, dbvh, cam = furnace_scene(albedo=0.5, le=0.5)
        cfg = integrator.IntegratorConfig(max_depth=10, mis=mis, rr_depth=12)
        # SimplePath (no MIS) has higher variance: more spp to sit inside the
        # reference's +-0.025 gate (integrators_test.cpp:55)
        spp = 12 if mis else 32
        img = integrator.render(sc, dbvh, cam, spp=spp, sampler="sobol", cfg=cfg)
        mean = float(jnp.mean(img))
        # analytic: 0.5 * sum(0.5^k, k=0..10) ~= 0.9995
        assert abs(mean - 1.0) < TOL, f"furnace mean {mean}"
        # all channels equal (gray scene through full spectral pipeline)
        ch = np.asarray(img).reshape(-1, 3).mean(0)
        np.testing.assert_allclose(ch, ch.mean(), atol=0.02)

    def test_emitter_direct_view(self):
        sc, dbvh, cam = furnace_scene(albedo=0.0, le=0.75)
        cfg = integrator.IntegratorConfig(max_depth=2, mis=True)
        img = integrator.render(sc, dbvh, cam, spp=8, cfg=cfg)
        np.testing.assert_allclose(float(jnp.mean(img)), 0.75, atol=TOL)


class TestIntegratorsAgree:
    def test_simplepath_vs_path(self):
        sc, dbvh, cam = quad_light_scene()
        cfg_s = integrator.IntegratorConfig(max_depth=4, mis=False, rr_depth=99)
        cfg_p = integrator.IntegratorConfig(max_depth=4, mis=True, rr_depth=99)
        img_s = integrator.render(sc, dbvh, cam, spp=48, seed=1, cfg=cfg_s)
        img_p = integrator.render(sc, dbvh, cam, spp=48, seed=2, cfg=cfg_p)
        m_s, m_p = float(jnp.mean(img_s)), float(jnp.mean(img_p))
        assert m_s > 0.01 and m_p > 0.01
        # both unbiased estimators of the same integral
        assert abs(m_s - m_p) < 0.05 * max(m_s, m_p) + 0.01, (m_s, m_p)

    def test_point_light_analytic(self):
        # diffuse floor y=0, point light at (0,2,0) intensity I:
        # L(x) = I * cos / r^2 * rho / pi
        b = scene_mod.SceneBuilder()
        m = b.add_material("diffuse", reflectance=(0.6, 0.6, 0.6))
        b.add_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20), m)
        b.add_point_light((0, 2, 0), (1, 1, 1), scale=4.0)
        sc = b.build()
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        cam = camera_mod.make_perspective(
            xf.look_at((0, 3, -3.0), (0, 0, 0), (0, 1, 0)), fov=30.0,
            width=RES, height=RES,
        )
        cfg = integrator.IntegratorConfig(max_depth=1, mis=True)
        img = integrator.render(sc, dbvh, cam, spp=8, cfg=cfg)
        # center pixel looks at origin: r=2, cos=1 -> L = 4/(4) * 0.6/pi
        expected = 4.0 / 4.0 * 0.6 / np.pi
        center = float(np.asarray(img)[RES // 2, RES // 2].mean())
        np.testing.assert_allclose(center, expected, rtol=0.08)


class TestDeterminism:
    @pytest.mark.slow
    def test_same_seed_same_image(self):
        sc, dbvh, cam = quad_light_scene()
        cfg = integrator.IntegratorConfig(max_depth=3)
        a = integrator.render(sc, dbvh, cam, spp=4, seed=7, cfg=cfg)
        b = integrator.render(sc, dbvh, cam, spp=4, seed=7, cfg=cfg)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.slow
    def test_different_seed_differs(self):
        sc, dbvh, cam = quad_light_scene()
        cfg = integrator.IntegratorConfig(max_depth=3)
        a = integrator.render(sc, dbvh, cam, spp=2, seed=7, cfg=cfg)
        b = integrator.render(sc, dbvh, cam, spp=2, seed=8, cfg=cfg)
        assert not np.array_equal(np.asarray(a), np.asarray(b))


class TestEnvMapAndTextures:
    def test_env_map_escape_radiance(self):
        # constant equal-area env map: escaped rays must see its radiance
        b = scene_mod.SceneBuilder()
        m = b.add_material("diffuse")
        b.add_quad((100, -1, 100), (101, -1, 100), (101, -1, 101), (100, -1, 101), m)
        env = np.ones((16, 16, 3), np.float32)
        b.set_environment_map(env, scale=2.0)
        sc = b.build()
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        cam = camera_mod.make_perspective(
            xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=60.0,
            width=8, height=8,
        )
        cfg = integrator.IntegratorConfig(max_depth=1, mis=True)
        img = integrator.render(sc, dbvh, cam, spp=8, cfg=cfg)
        np.testing.assert_allclose(float(jnp.mean(img)), 2.0, atol=0.08)

    def test_env_sample_pdf_consistency(self):
        import jax
        from nn_bvh.scatter import lights

        b = scene_mod.SceneBuilder()
        m = b.add_material("diffuse")
        b.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), m)
        rs = np.random.RandomState(0)
        env = (rs.rand(32, 32, 3).astype(np.float32) + 0.05)
        b.set_environment_map(env)
        sc = b.build()
        scd = jax.tree.map(jnp.asarray, sc)
        u2 = jax.random.uniform(jax.random.PRNGKey(1), (8192, 2))
        dirs, pdf = lights.env_sample_dir(scd, u2)
        # unit directions, E[1/pdf] = sphere measure 4pi
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(dirs), axis=-1), 1.0, atol=1e-4
        )
        np.testing.assert_allclose(
            float(jnp.mean(1.0 / pdf)), 4 * np.pi, rtol=0.05
        )
        # pdf at sampled dir matches the lookup pdf
        pdf2 = lights.env_pdf_dir(scd, dirs)
        frac = float(jnp.mean(jnp.isclose(pdf, pdf2, rtol=1e-3)))
        assert frac > 0.95  # boundary texels may round to neighbors

    def test_checker_texture_renders_two_tones(self):
        b = scene_mod.SceneBuilder()
        tex = b.add_texture_checker((0.05, 0.05, 0.05), (0.9, 0.9, 0.9), uscale=4)
        m = b.add_material("diffuse", texture=tex)
        # quad with explicit uvs
        verts = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
        faces = np.array([[0, 1, 2], [0, 2, 3]])
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        b.add_mesh(verts, faces, m, uvs=uvs)
        b.add_point_light((0, 3, 0), (1, 1, 1), scale=10.0)
        sc = b.build()
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        cam = camera_mod.make_perspective(
            xf.look_at((0, 3.5, -0.01), (0, 0, 0), (0, 1, 0)), fov=60.0,
            width=16, height=16,
        )
        cfg = integrator.IntegratorConfig(max_depth=1, mis=True)
        img = np.asarray(integrator.render(sc, dbvh, cam, spp=4, cfg=cfg))
        lum = img.mean(-1).reshape(-1)
        lit = lum[lum > 1e-5]
        assert len(lit) > 50
        bright = lit > np.median(lit)
        # two tone populations with a big ratio
        assert lit[bright].mean() > 4 * max(lit[~bright].mean(), 1e-6)


def test_mipmap_minification_no_alias():
    """High-frequency checker on a receding plane: with the mip atlas +
    ray-cone LOD (geometry/texture.py, util/mipmap.h analog) the far region
    must converge to the checker mean instead of aliasing to one tone."""
    import numpy as np
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf
    from nn_bvh.wavefront import camera as camera_mod, integrator

    b = scene_mod.SceneBuilder()
    tex = b.add_texture_checker((0.1, 0.1, 0.1), (0.9, 0.9, 0.9), uscale=64)
    m = b.add_material("diffuse", texture=tex)
    # receding plane: uv stretches 40x120 -> far texels way below pixel rate
    b.add_quad((-20, 0, 0), (20, 0, 0), (20, 0, 120), (-20, 0, 120), m,
               uvs=np.asarray([(0, 0), (40, 0), (40, 120), (0, 120)],
                              np.float32))
    b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.0, 0), (0, 0.85, 4), (0, 1, 0)), fov=40.0,
        width=48, height=48)
    cfg = integrator.IntegratorConfig(max_depth=2, traversal="xla")
    img = np.asarray(integrator.render(sc, dbvh, cam, spp=8,
                                       sampler="independent", cfg=cfg))
    # far band (top third of the plane, just below the horizon): each pixel
    # footprint covers many checker cells -> pixel VALUES near the mean, not
    # just the region average (aliasing would bimodalize them)
    ys = slice(26, 31)
    far = img[ys, 8:-8].mean(-1)
    mean_tone = 0.5 * (0.1 + 0.9) * 0.5  # albedo mean * (approx shading)
    # per-pixel spread: mip-filtered pixels cluster tightly
    assert far.std() < 0.08, (far.std(), far.mean())
    # and the band mean is finite/sane
    assert 0.05 < far.mean() < 0.9


def test_pixel_stats_counters():
    """collect_stats returns per-lane [bounces, shadow, hits, rr] counters
    (STAT_PIXEL_COUNTER analog) consistent with the render."""
    import numpy as np
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf
    from nn_bvh.wavefront import camera as camera_mod, integrator

    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse")
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_uniform_infinite_light((1, 1, 1))
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 3, -4), (0, 0, 0), (0, 1, 0)), fov=50.0,
        width=16, height=16)
    cfg = integrator.IntegratorConfig(max_depth=3, traversal="xla")
    imgs, totals = integrator.render_pixel_stats(sc, dbvh, cam, spp=2,
                                                 sampler="independent",
                                                 cfg=cfg)
    assert set(imgs) == {"bounces", "shadow_rays", "hits", "rr_terms"}
    assert imgs["bounces"].shape == (16, 16)
    # the floor fills the lower image: hits > 0 there, bounces >= hits
    assert totals["stats/hits"] > 0
    assert totals["stats/bounces"] >= totals["stats/hits"]
    assert totals["stats/shadow_rays"] > 0
