"""Coated diffuse/conductor + MixMaterial tests (bsdfs_test.cpp idioms)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nn_bvh import accel
from nn_bvh.core import vecmath as vm
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.scatter import bxdf
from nn_bvh.wavefront import camera as camera_mod, integrator


def _ctx(kind, n, refl=(0.8, 0.8, 0.8), roughness=0.3, coat_roughness=0.1,
         eta=1.5):
    b = scene_mod.SceneBuilder()
    m = b.add_material(kind, reflectance=refl, roughness=roughness,
                       coat_roughness=coat_roughness, eta=eta)
    b.add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), m)
    sc = b.build()
    lam = jnp.full((n, 4), 550.0)
    return bxdf.gather_material(sc, jnp.full((n,), m, jnp.int32), lam), sc


@pytest.mark.parametrize("kind,rough", [("coateddiffuse", 0.0),
                                        ("coatedconductor", 0.3)])
def test_coated_sample_pdf_consistency(kind, rough):
    """E_sampled[f cos / pdf] must equal E_uniform[f cos * 2pi] (hemispherical
    reflectance estimated two ways — the reference's chi-squared/rho idiom)."""
    n = 40000
    rs = np.random.RandomState(0)
    ctx, _ = _ctx(kind, n, roughness=rough, coat_roughness=0.2)
    wo = vm.normalize(jnp.broadcast_to(jnp.asarray([0.3, 0.1, 0.8]), (n, 3)))
    uc = jnp.asarray(rs.rand(n), jnp.float32)
    u2 = jnp.asarray(rs.rand(n, 2), jnp.float32)
    bs = bxdf.sample(ctx, wo, uc, u2)
    ok = np.asarray(bs.valid)
    est_s = np.asarray(bs.f * (vm.abs_cos_theta(bs.wi)
                               / jnp.maximum(bs.pdf, 1e-12))[..., None])
    # E[f cos / pdf * 1(valid)]: invalid samples contribute zero (they carry
    # zero radiance in the integrator), so average over ALL draws
    est_s = float((est_s * ok[:, None]).mean(0).mean())
    # uniform-hemisphere estimate
    wi_u = np.asarray(
        jnp.stack([jnp.asarray(rs.randn(n)), jnp.asarray(rs.randn(n)),
                   jnp.abs(jnp.asarray(rs.randn(n)))], -1))
    wi_u = jnp.asarray(wi_u / np.linalg.norm(wi_u, axis=-1, keepdims=True))
    f_u, _ = bxdf.evaluate(ctx, wo, wi_u)
    est_u = float(jnp.mean(f_u.mean(-1) * vm.abs_cos_theta(wi_u)) * 2 * np.pi)
    assert est_s > 0
    # Both estimators are stochastic LayeredBxDF walks with maxDepth
    # truncation (bxdfs.h semantics); the sampled walk drops unexited paths
    # while the f-walk captures exits via per-visit NEE, so the two carry
    # slightly different truncation bias. Agreement with the reference
    # renderer itself is gated by tools/probe_material.py (<1% on the crown
    # coated materials); here we only require the estimators to agree
    # within the combined truncation + MC envelope.
    assert abs(est_s - est_u) / max(est_u, 1e-9) < 0.12, (est_s, est_u)


@pytest.mark.slow
def test_coated_diffuse_furnace_bounded():
    """Coated white diffuse in a unit furnace: energy <= 1 and most energy
    preserved (single-scattering layer approximation loses the multiple
    coat-base interreflection, so expect [0.8, 1.01])."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("coateddiffuse", reflectance=(1, 1, 1),
                       roughness=0.1, eta=1.5)
    b.add_sphere((0, 0, 2.5), 1.0, m, n_theta=16, n_phi=32)
    b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=20.0, width=16,
        height=16)
    cfg = integrator.IntegratorConfig(max_depth=12, traversal="xla")
    img = integrator.render(sc, dbvh, cam, spp=48, sampler="independent",
                            cfg=cfg)
    # compare against the pure env (no sphere in view) brightness
    b2 = scene_mod.SceneBuilder()
    d2 = b2.add_material("diffuse")
    b2.add_quad((-1, -1, -50), (1, -1, -50), (1, 1, -50), (-1, 1, -50), d2)
    b2.add_uniform_infinite_light((1, 1, 1), scale=1.0)
    sc2 = b2.build()
    sc2, dbvh2, _ = accel.build_scene_bvh(sc2)
    env = integrator.render(sc2, dbvh2, cam, spp=8, sampler="independent",
                            cfg=integrator.IntegratorConfig(max_depth=2,
                                                            traversal="xla"))
    ratio = float(np.mean(np.asarray(img))) / float(np.mean(np.asarray(env)))
    assert 0.80 <= ratio <= 1.02, ratio


def test_mix_material_blends():
    """mix(red, green, amount) renders as the blend of the pure renders."""
    def render_scene(which):
        b = scene_mod.SceneBuilder()
        red = b.add_material("diffuse", reflectance=(0.9, 0.05, 0.05))
        green = b.add_material("diffuse", reflectance=(0.05, 0.9, 0.05))
        if which == "mix":
            m = b.add_material("mix", mix_materials=(red, green),
                               mix_amount=0.5)
        else:
            m = red if which == "red" else green
        b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
        b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
        sc = b.build()
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        cam = camera_mod.make_perspective(
            xf.look_at((0, 3, -3), (0, 0, 0), (0, 1, 0)), fov=40.0,
            width=12, height=12)
        cfg = integrator.IntegratorConfig(max_depth=2, traversal="xla")
        return np.asarray(integrator.render(sc, dbvh, cam, spp=32,
                                            sampler="independent", cfg=cfg))

    mix = render_scene("mix").mean((0, 1))
    red = render_scene("red").mean((0, 1))
    green = render_scene("green").mean((0, 1))
    want = 0.5 * (red + green)
    assert np.allclose(mix, want, rtol=0.06, atol=0.01), (mix, want)
