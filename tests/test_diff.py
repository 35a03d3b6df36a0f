"""Differentiable rendering: pixel gradients vs finite differences.

BASELINE.json north-star gate: "pixel gradients must be allclose to finite
differences". Convention (SURVEY.md §7.1 diff/): gradients flow through
shading (material spectra, light scales), not through visibility/geometry —
so with a fixed sampler the estimator is a smooth function of material
parameters and FD must match to first order.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.core import samplers
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.scatter import lightsamplers
from nn_bvh.wavefront import camera as camera_mod, film as film_mod, integrator

RES = 12


def setup():
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    # differentiated parameters as jnp (the scene pipeline is host numpy)
    sc = sc.replace(mat_coeffs=jnp.asarray(sc.mat_coeffs),
                    light_scale=jnp.asarray(sc.light_scale))
    cam = camera_mod.make_perspective(
        xf.look_at((0, 2, -5), (0, 0, 0), (0, 1, 0)), fov=40.0, width=RES, height=RES
    )
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=99,
                                      early_exit=False)  # runs under jax.grad
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=4)
    lst = lightsamplers.build(sc, cfg.light_sampler)
    return sc, dbvh, cam, cfg, sampler_cfg, lst


def make_loss(sc, dbvh, cam, cfg, sampler_cfg, lst):
    R = cam.width * cam.height
    pixel_idx = jnp.arange(R, dtype=jnp.int32)

    def loss(mat_coeffs, light_scale):
        s2 = sc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        total = jnp.zeros(())
        for s in range(2):
            L, lam, pdf, _fw = integrator.trace_wave(
                s2, dbvh, cam, sampler_cfg, cfg, pixel_idx, jnp.int32(s), lst
            )
            f = film_mod.make_film(cam.height, cam.width)
            f = film_mod.add_samples(f, pixel_idx, L, lam, pdf)
            total = total + jnp.sum(f.xyz) / R
        return total

    return jax.jit(loss), jax.jit(jax.grad(loss, argnums=(0, 1)))


# >10 minutes for the FD sweeps on a 2-core box (VERDICT r3): out of the
# default gate; run with `pytest -m slow` or in the full nightly pass.
pytestmark = pytest.mark.slow


class TestPixelGradients:
    def test_material_grads_match_fd(self):
        sc, dbvh, cam, cfg, sampler_cfg, lst = setup()
        loss, grad = make_loss(sc, dbvh, cam, cfg, sampler_cfg, lst)
        c0 = sc.mat_coeffs
        s0 = sc.light_scale
        g_mat, g_light = grad(c0, s0)
        g_mat = np.asarray(g_mat)
        assert np.all(np.isfinite(g_mat))
        assert np.abs(g_mat).max() > 0

        # central finite differences on every material coefficient
        eps = 1e-3
        for i in range(c0.shape[0]):
            for j in range(3):
                cp = c0.at[i, j].add(eps)
                cm = c0.at[i, j].add(-eps)
                fd = (float(loss(cp, s0)) - float(loss(cm, s0))) / (2 * eps)
                np.testing.assert_allclose(
                    g_mat[i, j], fd, rtol=2e-2, atol=2e-4,
                    err_msg=f"mat coeff ({i},{j})",
                )

    def test_light_scale_grads_match_fd(self):
        sc, dbvh, cam, cfg, sampler_cfg, lst = setup()
        loss, grad = make_loss(sc, dbvh, cam, cfg, sampler_cfg, lst)
        c0, s0 = sc.mat_coeffs, sc.light_scale
        _, g_light = grad(c0, s0)
        g_light = np.asarray(g_light)
        assert np.all(np.isfinite(g_light))
        eps = 1e-3
        # light scales enter linearly: fd on the first few lights
        for i in range(min(3, len(g_light))):
            sp = s0.at[i].add(eps)
            sm = s0.at[i].add(-eps)
            fd = (float(loss(c0, sp)) - float(loss(c0, sm))) / (2 * eps)
            np.testing.assert_allclose(g_light[i], fd, rtol=2e-2, atol=2e-4,
                                       err_msg=f"light {i}")

    def test_grad_descent_matches_target_albedo(self):
        # invert a rendering: recover albedo coeffs from a target image
        sc, dbvh, cam, cfg, sampler_cfg, lst = setup()
        R = cam.width * cam.height
        pixel_idx = jnp.arange(R, dtype=jnp.int32)

        def render_img(mat_coeffs):
            s2 = sc.replace(mat_coeffs=mat_coeffs)
            L, lam, pdf, _fw = integrator.trace_wave(
                s2, dbvh, cam, sampler_cfg, cfg, pixel_idx, jnp.int32(0), lst
            )
            f = film_mod.make_film(cam.height, cam.width)
            return film_mod.add_samples(f, pixel_idx, L, lam, pdf).xyz

        target = render_img(sc.mat_coeffs)
        # perturb and descend back
        c = sc.mat_coeffs + 0.3
        obj = jax.jit(jax.value_and_grad(
            lambda cc: jnp.mean((render_img(cc) - target) ** 2)
        ))
        l0, _ = obj(c)
        for _ in range(30):
            l, g = obj(c)
            c = c - 2.0 * g
        l1, _ = obj(c)
        assert float(l1) < float(l0) * 0.15, (float(l0), float(l1))
