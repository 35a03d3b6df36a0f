"""Media + VolPath tests.

Modeled on the reference's test idioms (SURVEY.md §4): statistical property
tests for the phase function, and analytic-scene radiometric checks with the
reference's ±0.025-style mean tolerances (cpu/integrators_test.cpp:55).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nn_bvh import accel
from nn_bvh.core import samplers
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.scatter import media
from nn_bvh.wavefront import camera as camera_mod, integrator


# ---------------------------------------------------------------------------
# HG phase function properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [-0.6, 0.0, 0.35, 0.8])
def test_hg_normalization(g):
    # integrate p over the sphere: 2*pi * int p(cos) dcos = 1
    n = 4096
    cos_t = np.linspace(-1 + 1e-5, 1 - 1e-5, n)
    p = np.asarray(media.hg_p(jnp.asarray(cos_t), jnp.float32(g)))
    integral = 2 * np.pi * np.trapezoid(p, cos_t)
    assert abs(integral - 1.0) < 1e-3, integral


@pytest.mark.parametrize("g", [-0.5, 0.0, 0.7])
def test_hg_sample_pdf_consistency(g):
    """Sample_p returns pdf == p(wo, wi), and the sampled cos histogram
    matches the analytic density (the reference's chi-squared idiom,
    util/sampling_test.cpp)."""
    n = 20000
    rs = np.random.RandomState(0)
    u2 = jnp.asarray(rs.rand(n, 2), jnp.float32)
    wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    wi, pdf = media.phase_sample(wo, u2, jnp.full((n,), g, jnp.float32))
    # unit directions
    assert np.allclose(np.linalg.norm(np.asarray(wi), axis=-1), 1.0, atol=1e-4)
    # pdf equals the phase value (perfect importance sampling)
    p_eval = media.phase_p(wo, wi, jnp.full((n,), g, jnp.float32))
    assert np.allclose(np.asarray(pdf), np.asarray(p_eval), rtol=1e-4, atol=1e-6)
    # histogram of cos(theta) vs marginal density 2*pi*p(cos)
    cos_s = np.asarray(media.hg_p(jnp.asarray([0.0]), jnp.float32(g)))  # warm
    cos_samples = np.asarray(jnp.sum(wi * wo, axis=-1))
    hist, edges = np.histogram(cos_samples, bins=24, range=(-1, 1), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    expect = 2 * np.pi * np.asarray(media.hg_p(jnp.asarray(centers), jnp.float32(g)))
    mask = expect > 0.05
    rel = np.abs(hist[mask] - expect[mask]) / expect[mask]
    assert np.mean(rel) < 0.15, (np.mean(rel), g)


def test_density_grid_trilinear():
    """Grid density: constant grid == constant density inside, 0 outside."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse")
    b.add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), m)
    med = b.add_medium("grid", sigma_a=(1, 1, 1),
                       density=np.full((8, 8, 8), 2.5, np.float32),
                       bounds=np.array([[0, 0, 0], [1, 1, 1]], np.float32))
    sc = b.build()
    ctx = media.gather_medium(sc, jnp.full((4,), med, jnp.int32),
                              jnp.full((4, 4), 550.0))
    p_in = jnp.asarray([[0.5, 0.5, 0.5], [0.25, 0.7, 0.1],
                        [0.5, 0.5, 0.5], [2.0, 0.5, 0.5]], jnp.float32)
    dens = np.asarray(media.density(sc, ctx, p_in))
    assert np.allclose(dens[:3], 2.5, atol=1e-4)
    assert dens[3] == 0.0


# ---------------------------------------------------------------------------
# analytic VolPath scenes
# ---------------------------------------------------------------------------

def _slab_scene(sigma_a=1.0, sigma_s=0.0, emissive_wall=True, med_le=0.0,
                slab=True, grid=False, g=0.0):
    """Camera at origin looking +z; medium slab z in [0.5, 1.5] spanning the
    view; wall at z=3."""
    b = scene_mod.SceneBuilder()
    black = b.add_material("diffuse", reflectance=(0, 0, 0))
    med = -1
    if slab:
        if grid:
            med = b.add_medium(
                "grid", sigma_a=(sigma_a,) * 3, sigma_s=(sigma_s,) * 3,
                Le=(1, 1, 1), Le_scale=med_le, g=g,
                density=np.ones((4, 4, 4), np.float32),
                bounds=np.array([[-20, -20, 0.5], [20, 20, 1.5]], np.float32))
        else:
            med = b.add_medium(
                "homogeneous", sigma_a=(sigma_a,) * 3, sigma_s=(sigma_s,) * 3,
                Le=(1, 1, 1), Le_scale=med_le, g=g)
        # slab boundary: two large interface quads with outward normals
        # (+z face normal +z, -z face normal -z) => inside = slab interior
        b.add_quad((-20, -20, 1.5), (20, -20, 1.5), (20, 20, 1.5), (-20, 20, 1.5),
                   -1, med_inside=med, med_outside=-1)
        b.add_quad((-20, 20, 0.5), (20, 20, 0.5), (20, -20, 0.5), (-20, -20, 0.5),
                   -1, med_inside=med, med_outside=-1)
    if emissive_wall:
        b.add_quad((-20, 20, 3.0), (20, 20, 3.0), (20, -20, 3.0), (-20, -20, 3.0),
                   black, emission_rgb=(1, 1, 1), emission_scale=5.0,
                   two_sided=True)
    else:
        b.add_quad((-20, 20, 3.0), (20, 20, 3.0), (20, -20, 3.0), (-20, -20, 3.0),
                   black)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=8.0, width=16, height=16)
    return sc, dbvh, cam


def _mean_render(sc, dbvh, cam, spp=32, max_depth=5, kind="volpath"):
    img = integrator.render(
        sc, dbvh, cam, spp=spp, sampler="independent", seed=3,
        cfg=integrator.IntegratorConfig(kind=kind, max_depth=max_depth,
                                        traversal="xla", compact=False))
    return float(np.mean(np.asarray(img)))


def test_volpath_homogeneous_absorption():
    """Transmittance through an absorbing slab: ratio of with/without medium
    = exp(-sigma_a * width) (narrow fov => near-perpendicular rays)."""
    sigma = 1.2
    sc1, db1, cam = _slab_scene(sigma_a=sigma)
    sc0, db0, _ = _slab_scene(slab=False)
    with_med = _mean_render(sc1, db1, cam)
    without = _mean_render(sc0, db0, cam)
    got = with_med / without
    want = np.exp(-sigma * 1.0)
    assert abs(got - want) < 0.035, (got, want)


@pytest.mark.slow
def test_volpath_grid_matches_homogeneous():
    sigma = 0.8
    sc1, db1, cam = _slab_scene(sigma_a=sigma)
    sc2, db2, _ = _slab_scene(sigma_a=sigma, grid=True)
    a = _mean_render(sc1, db1, cam)
    bb = _mean_render(sc2, db2, cam)
    assert abs(a - bb) / max(a, 1e-9) < 0.05, (a, bb)


def test_volpath_medium_emission():
    """Absorbing + emissive slab over a black wall: L = Le_eff (1-e^{-sa w}).
    Check via the ratio between two widths ... here two sigmas:
    L(s1)/L(s2) = (1-e^{-s1})/(1-e^{-s2})."""
    s1, s2 = 2.0, 0.5
    sc1, db1, cam = _slab_scene(sigma_a=s1, emissive_wall=False, med_le=1.0)
    sc2, db2, _ = _slab_scene(sigma_a=s2, emissive_wall=False, med_le=1.0)
    r = _mean_render(sc1, db1, cam) / max(_mean_render(sc2, db2, cam), 1e-12)
    want = (1 - np.exp(-s1)) / (1 - np.exp(-s2))
    assert abs(r - want) / want < 0.06, (r, want)


def test_volpath_scattering_energy_conserved():
    """Pure-scattering slab (albedo 1) inside a uniform radiance-1 environment:
    every path eventually escapes to the unit-radiance sphere, so the image
    must equal the no-medium image exactly in expectation — a strong check
    that the NEE + phase MIS weights (r_u/r_l algebra) sum to one."""
    def env_scene(slab):
        b = scene_mod.SceneBuilder()
        med = b.add_medium("homogeneous", sigma_a=(0, 0, 0), sigma_s=(1, 1, 1))
        if slab:
            b.add_quad((-20, -20, 1.5), (20, -20, 1.5), (20, 20, 1.5),
                       (-20, 20, 1.5), -1, med_inside=med, med_outside=-1)
            b.add_quad((-20, 20, 0.5), (20, 20, 0.5), (20, -20, 0.5),
                       (-20, -20, 0.5), -1, med_inside=med, med_outside=-1)
        else:
            # far-away dummy geometry outside the view
            m = b.add_material("diffuse", reflectance=(0, 0, 0))
            b.add_quad((-1, -1, -50), (1, -1, -50), (1, 1, -50), (-1, 1, -50), m)
        b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
        sc = b.build()
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        cam = camera_mod.make_perspective(
            xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=8.0,
            width=16, height=16)
        return sc, dbvh, cam

    sc1, db1, cam = env_scene(True)
    sc0, db0, _ = env_scene(False)
    with_med = _mean_render(sc1, db1, cam, spp=64, max_depth=24)
    without = _mean_render(sc0, db0, cam, spp=16)
    assert abs(with_med / without - 1.0) < 0.05, (with_med, without)


def test_volpath_matches_path_without_media():
    """On a media-free scene VolPath's rescaled-probability estimator reduces
    to the Path integrator (statistically)."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=8, n_phi=16)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0,
        width=24, height=24)
    a = _mean_render(sc, dbvh, cam, spp=48, kind="path")
    v = _mean_render(sc, dbvh, cam, spp=48, kind="volpath")
    assert abs(a - v) / max(a, 1e-9) < 0.05, (a, v)


def test_parser_named_medium_interface(tmp_path):
    """MakeNamedMedium + MediumInterface parse into CompiledScene media
    (reference scene.cpp:909 CreateMedia + graphics-state MediumInterface);
    crown.pbrt's homogeneous ruby/sapphire media follow this path."""
    import numpy as np
    from nn_bvh.geometry import pbrt_parser, scene as scene_mod

    f = tmp_path / "med.pbrt"
    f.write_text("""
Camera "perspective" "float fov" [50]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.1 0.2 0.3] "rgb sigma_s" [0.5 0.5 0.5]
    "float scale" [2.0] "float g" [0.3]
MakeNamedMedium "smoke" "string type" "uniformgrid"
    "integer nx" [2] "integer ny" [2] "integer nz" [2]
    "float density" [1 2 3 4 5 6 7 8]
    "point3 p0" [0 0 0] "point3 p1" [1 1 1]
AttributeBegin
  Material "none"
  MediumInterface "fog" ""
  Shape "sphere" "float radius" [1]
AttributeEnd
Material "diffuse"
Shape "trianglemesh" "point3 P" [-1 0 -1  1 0 -1  1 0 1]
  "integer indices" [0 1 2]
""")
    res = pbrt_parser.parse_file(str(f))
    assert not any("MakeNamedMedium" in w for w in res.warnings), res.warnings
    sc = res.builder.build()
    assert sc.n_media == 2
    assert int(np.asarray(sc.med_type)[0]) == scene_mod.MED_HOMOGENEOUS
    assert int(np.asarray(sc.med_type)[1]) == scene_mod.MED_GRID
    assert float(np.asarray(sc.med_max_density)[1]) == 8.0
    assert abs(float(np.asarray(sc.med_scales)[0, 3]) - 0.3) < 1e-6  # g
    # the sphere is an analytic quadric since r4: it carries the medium
    # interface in quad_med (and tri_shade's appended row); the floor
    # triangles do not
    assert sc.n_quadrics == 1
    assert int(np.asarray(sc.quad_med)[0, 0]) == 0
    assert int(np.asarray(sc.tri_shade)[-1, 26]) == 0  # appended quad row
    tmi = np.asarray(sc.tri_med_inside)[:sc.n_tris]
    assert (tmi == -1).all()  # floor carries no interface


def test_dda_majorant_sparse_grid_unbiased():
    """A sparse density grid (one dense blob in a mostly-empty volume):
    transmittance estimated through the DDA majorant loop matches the
    numerically integrated exp(-int sigma) — the per-supervoxel majorants
    (DDAMajorantIterator, media.h:135) must not bias the estimator, only
    cut null collisions vs the global-majorant bound."""
    from nn_bvh.geometry import scene as sm
    from nn_bvh.scatter import media as media_mod
    import jax
    import jax.numpy as jnp

    # density grid: empty except a dense cube in the middle
    d = np.zeros((32, 32, 32), np.float32)
    d[12:20, 12:20, 12:20] = 8.0
    b = sm.SceneBuilder()
    blk = b.add_material("diffuse", reflectance=(0, 0, 0))
    med = b.add_medium("grid", sigma_a=(1, 1, 1), sigma_s=(0, 0, 0),
                       scale=1.0, density=d,
                       bounds=np.array([[0, 0, 0], [1, 1, 1]], np.float32))
    b.add_quad((-9, -9, 9), (9, -9, 9), (9, 9, 9), (-9, 9, 9), blk)
    sc = b.build()
    sc = jax.tree.map(jnp.asarray, sc)

    # majorant grid is conservative: every supervoxel majorant >= max of
    # the trilinear field inside it (check against dense sampling)
    maj = np.asarray(sc.med_maj_grids)[0]
    assert maj.max() == 8.0
    assert (maj == 0).mean() > 0.5  # sparse: most supervoxels empty

    # straight ray through the blob center: estimate E[T] via the DDA loop
    n = 2048
    lam = jnp.full((n, 4), 550.0)
    med_ids = jnp.zeros((n,), jnp.int32)
    ctx = media_mod.gather_medium(sc, med_ids, lam)
    o = jnp.broadcast_to(jnp.asarray([0.5, 0.5, -0.2]), (n, 3))
    dirs = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    t0, t1 = media_mod.segment_bounds(ctx, o, dirs, jnp.full((n,), 10.0))
    dda = media_mod.dda_init(sc, ctx, o, dirs, t0, t1)
    sigma_unit = ctx.sigma_a + ctx.sigma_s

    # ratio tracking with per-segment majorants
    import numpy.random as npr
    rs = npr.RandomState(7)

    def run_ratio():
        T = np.ones(n, np.float64)
        t = np.asarray(t0).copy()
        st = jax.tree.map(np.asarray, dda)
        alive = np.ones(n, bool)
        for _ in range(256):
            if not alive.any():
                break
            maj_l = np.asarray(sigma_unit)[:, 0] * st.maj_dens
            seg_end = np.minimum(st.seg_end, np.asarray(t1))
            u = rs.rand(n)
            dt = np.where(maj_l > 1e-12, -np.log1p(-u) / np.maximum(maj_l, 1e-12), 1e30)
            t_new = t + dt
            crossed = alive & (t_new >= seg_end) & (seg_end < np.asarray(t1))
            exited = alive & (t_new >= seg_end) & ~crossed
            ev = alive & ~crossed & ~exited
            p = np.asarray(o) + t_new[:, None] * np.asarray(dirs)
            dens = np.asarray(media_mod.density(
                sc, ctx, jnp.asarray(p, jnp.float32)))
            sig = np.asarray(sigma_unit)[:, 0] * dens
            # null-collision ratio update
            T = np.where(ev, T * np.maximum(maj_l - sig, 0.0)
                         / np.maximum(maj_l, 1e-12), T)
            t = np.where(ev, t_new, np.where(crossed, seg_end, t))
            alive = alive & (ev | crossed) & (T > 0)
            st2 = media_mod.dda_advance(sc, ctx, jax.tree.map(jnp.asarray, st),
                                        t1, jnp.asarray(crossed))
            st = jax.tree.map(np.asarray, st2)
        return T.mean()

    est = run_ratio()
    # ground truth: integrate sigma along the ray numerically
    ts = np.linspace(float(np.asarray(t0)[0]), float(np.asarray(t1)[0]), 4001)
    ps = np.asarray(o)[0] + ts[:, None] * np.asarray(dirs)[0]
    dens = np.asarray(media_mod.density(
        sc, ctx, jnp.asarray(np.broadcast_to(ps[None, 0], (1, 3)))))  # warm
    dens_line = np.asarray(media_mod.density(
        sc, jax.tree.map(lambda x: x[:1], ctx),
        jnp.asarray(ps[None, :, :], jnp.float32).reshape(-1, 3)[None][0][None][0]
        if False else jnp.asarray(ps, jnp.float32)))
    tau = np.trapz(np.asarray(sigma_unit)[0, 0] * dens_line, ts)
    want = np.exp(-tau)
    assert abs(est - want) < 0.03, (est, want)


def test_blackbody_temperature_emission():
    """Temperature-grid medium emits blackbody radiance: a hotter grid is
    brighter and red/blue balance follows Planck (media.h GridMedium
    temperature emission; spectrum.h BlackbodySpectrum)."""
    import numpy as np
    import jax.numpy as jnp
    from nn_bvh.geometry import scene as scene_mod
    from nn_bvh.scatter import media

    def ctx_at(T_kelvin):
        b = scene_mod.SceneBuilder()
        m = b.add_material("diffuse")
        b.add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), m)
        dens = np.ones((8, 8, 8), np.float32)
        temp = np.full((8, 8, 8), T_kelvin, np.float32)
        mid = b.add_medium("grid", sigma_a=(1, 1, 1), density=dens,
                           bounds=[[-1, -1, -1], [1, 1, 1]],
                           temperature=temp, Le_scale=1.0)
        sc = b.build()
        lam = jnp.asarray([[450.0, 550.0, 650.0, 750.0]])
        ctx = media.gather_medium(sc, jnp.asarray([mid], jnp.int32), lam)
        le = media.le_at(sc, ctx, jnp.zeros((1, 3)), lam)
        return np.asarray(le)[0]

    le_cool = ctx_at(1500.0)
    le_hot = ctx_at(6000.0)
    assert np.isfinite(le_cool).all() and np.isfinite(le_hot).all()
    # Planck: at 1500K the 750nm band dominates the 450nm band strongly
    assert le_cool[3] > 10.0 * le_cool[0], le_cool
    # at 6000K the spectrum is far flatter
    assert le_hot[0] > 0.3 * le_hot[3], le_hot
    # zero-temperature (or missing grid) media keep their RGB Le path
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse")
    b.add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), m)
    mid = b.add_medium("homogeneous", sigma_a=(1, 1, 1), Le=(2, 2, 2),
                       Le_scale=1.0)
    sc = b.build()
    lam = jnp.asarray([[450.0, 550.0, 650.0, 750.0]])
    ctx = media.gather_medium(sc, jnp.asarray([mid], jnp.int32), lam)
    le = np.asarray(media.le_at(sc, ctx, jnp.zeros((1, 3)), lam))[0]
    assert (le > 0).all()
