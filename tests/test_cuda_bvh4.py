"""CUDA BVH4 traversal (accel/cuda_bvh4.py) and the dispatch around it.

The kernel itself runs only on a GPU (test marked `gpu`; chip_smoke.py's
kernel phase is its on-card run at full size). Everything around it is
checked here on the CPU:

- the wide-node collapse and the packed 128-byte node table: boxes contain
  their subtrees, every primitive is reachable, the stack bound raises;
- `walk_numpy`, the kernel's walk over the packed tables in numpy, against
  brute force (`traverse.intersect_brute`);
- the traced wrapper (SoA ray packing, odd batch sizes, dead lanes, the
  shard_map varying-axes cast, gradients through a render) with the FFI
  launch replaced by the XLA walk;
- backend choice: "auto" is the XLA walk on the CPU, "cuda" without a GPU
  raises instead of falling back.
"""

import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.accel import build, bvh4, cuda_bvh4, dispatch, raysort, traverse
from nn_bvh.geometry import scene as scene_mod, transform as xf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_scene():
    rs = np.random.RandomState(3)
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * 4 + np.array([0, 1.0, 0])
        b.add_sphere(c, 0.3 + 0.3 * rs.rand(), m, n_theta=10, n_phi=20)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    return sc, dbvh


@pytest.fixture(scope="module")
def packed(small_scene):
    sc, dbvh = small_scene
    return cuda_bvh4.pack_scene(dbvh, sc.tri_p)


def _rays(R, seed=11, dead_every=5):
    rs = np.random.RandomState(seed)
    o = (rs.rand(R, 3).astype(np.float32) - 0.5) * 6
    o[:, 1] += 1.5
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((R,), 1e30, np.float32)
    t_max[::dead_every] = -1.0  # dead lanes (terminated rays in a dense wave)
    return o, d, t_max


def _fake_launch(dbvh):
    """Stand-in for the FFI launch: unpack the (7, R) rays, run the XLA walk
    on the wrapper's (possibly motion-blended) triangle table and return the
    hit primitive, as the kernel does."""
    dbvh = jax.tree.map(jnp.asarray, dbvh)

    def launch(node_tab, tri_tab, rays, any_hit):
        tri_p = tri_tab.reshape(-1, 3, 4)[:, :, :3]
        o, d, t_max = rays[0:3].T, rays[3:6].T, rays[6]
        one = lambda o_, d_, t_: traverse._traverse_one(
            dbvh, tri_p, o_, d_, t_, any_hit, build.MAX_LEAF_PRIMS)
        return jax.vmap(one)(o, d, t_max).prim

    return launch


# ---------------------------------------------------------------------------
# host side: collapse and packing
# ---------------------------------------------------------------------------

def test_bvh4_collapse_covers_all_prims(small_scene):
    sc, dbvh = small_scene
    wl, wh, wm = bvh4.collapse_bvh4(
        np.asarray(dbvh.node_lo)[:dbvh.n_nodes],
        np.asarray(dbvh.node_hi)[:dbvh.n_nodes],
        np.asarray(dbvh.node_meta)[:dbvh.n_nodes])
    seen = np.zeros(sc.tri_p.shape[0], bool)
    for w in range(len(wm)):
        for k in range(4):
            m = wm[w, k]
            if m < 0:
                u = -m - 1
                off, cnt = u // 16, u % 16 + 1
                seen[off:off + cnt] = True
    meta = np.asarray(dbvh.node_meta)[:dbvh.n_nodes]
    real = np.zeros(sc.tri_p.shape[0], bool)
    for off, cnt, _ in meta:
        if cnt > 0:
            real[off:off + cnt] = True
    assert (seen == real).all()


def test_packed_child_boxes_contain_subtrees(small_scene, packed):
    sc, _ = small_scene
    node_tab, tri_tab = packed
    assert node_tab.shape[1] == cuda_bvh4.NODE_F32 and node_tab.dtype == np.float32
    lo = node_tab[:, 0:12].reshape(-1, 3, 4).transpose(0, 2, 1)
    hi = node_tab[:, 12:24].reshape(-1, 3, 4).transpose(0, 2, 1)
    child = node_tab[:, 24:28].view(np.int32)
    tris = tri_tab.reshape(-1, 3, 4)[:, :, :3]
    np.testing.assert_array_equal(tris, np.asarray(sc.tri_p, np.float32))
    n_leaf_prims = 0
    for e in range(len(node_tab)):
        for c in range(4):
            ref = int(child[e, c])
            if ref == cuda_bvh4.EMPTY:
                continue
            if ref >= 0:
                live = child[ref] != cuda_bvh4.EMPTY
                assert (lo[ref][live] >= lo[e, c]).all()
                assert (hi[ref][live] <= hi[e, c]).all()
            else:
                u = -ref - 1
                off, cnt = u >> 4, (u & 15) + 1
                v = tris[off:off + cnt].reshape(-1, 3)
                assert (v >= lo[e, c]).all() and (v <= hi[e, c]).all()
                n_leaf_prims += cnt
    assert n_leaf_prims == sc.n_tris


def test_stack_depth_bound_raises(small_scene, monkeypatch):
    sc, dbvh = small_scene
    monkeypatch.setattr(cuda_bvh4, "STACK_DEPTH", 8)
    with pytest.raises(ValueError, match="STACK_DEPTH"):
        cuda_bvh4.pack_scene(dbvh, sc.tri_p)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_numpy_matches_brute(small_scene, packed, any_hit):
    """The kernel's walk over the packed tables, in numpy, finds what brute
    force finds: same distance, same triangle up to exact ties."""
    sc, _ = small_scene
    node_tab, tri_tab = packed
    o, d, t_max = _rays(256)
    t, prim, b1, b2 = cuda_bvh4.walk_numpy(node_tab, tri_tab, o, d, t_max,
                                           any_hit=any_hit)
    ref = traverse.intersect_brute(jnp.asarray(sc.tri_p), jnp.asarray(o),
                                   jnp.asarray(d), jnp.asarray(t_max))
    ref_prim = np.asarray(ref.prim)
    live = t_max > 0
    assert (prim[~live] < 0).all() and np.isinf(t[~live]).all()
    assert ((prim >= 0) == (ref_prim >= 0)).all()
    assert (ref_prim[live] >= 0).mean() > 0.3   # the batch really hits
    if any_hit:
        return
    hit = prim >= 0
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    diff = hit & (prim != ref_prim)
    assert diff.sum() <= 2   # ties on shared edges only
    np.testing.assert_allclose(b1[hit & ~diff], np.asarray(ref.b1)[hit & ~diff],
                               atol=1e-4)


# ---------------------------------------------------------------------------
# traced wrapper, with the launch replaced by the XLA walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("any_hit", [False, True])
def test_wrapper_odd_batch_and_dead_lanes(small_scene, packed, monkeypatch,
                                          any_hit):
    sc, dbvh = small_scene
    node_tab, tri_tab = packed
    monkeypatch.setattr(cuda_bvh4, "_ffi_traverse", _fake_launch(dbvh))
    o, d, t_max = _rays(1000)   # not a multiple of the 128-thread block
    args = (jnp.asarray(node_tab), jnp.asarray(tri_tab), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(t_max))
    live = t_max > 0
    dj = jax.tree.map(jnp.asarray, dbvh)
    if any_hit:
        occ = np.asarray(jax.jit(cuda_bvh4.occluded)(*args))
        assert occ.shape == (1000,) and not occ[~live].any()
        ref = traverse.intersect_any(dj, jnp.asarray(sc.tri_p), o, d, t_max)
        assert (occ[live] == np.asarray(ref)[live]).all()
        return
    # the hit record is recomputed from the primitive with the walk's
    # triangle test: equal up to XLA's contraction choices (~1 ulp)
    hit = jax.jit(cuda_bvh4.closest)(*args)
    ref = traverse.intersect_closest(dj, jnp.asarray(sc.tri_p), o, d, t_max)
    assert hit.t.shape == hit.prim.shape == hit.b1.shape == (1000,)
    assert (np.asarray(hit.prim)[~live] < 0).all()
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))
    for a, b in zip(hit, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_wrapper_under_shard_map(small_scene, packed, monkeypatch):
    """Rays sharded, tables replicated: the wrapper casts the tables to the
    rays' varying axes, and the sharded result equals the unsharded one."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    sc, dbvh = small_scene
    node_tab, tri_tab = (jnp.asarray(a) for a in packed)
    monkeypatch.setattr(cuda_bvh4, "_ffi_traverse", _fake_launch(dbvh))
    o, d, t_max = (jnp.asarray(a) for a in _rays(512))
    mesh = Mesh(np.array(jax.devices()[:2]), ("rays",))

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P("rays"), P("rays"), P("rays")),
             out_specs=P("rays"))
    def sharded(nt, tt, o_, d_, t_):
        return cuda_bvh4.closest(nt, tt, o_, d_, t_)

    hs = sharded(node_tab, tri_tab, o, d, t_max)
    h1 = cuda_bvh4.closest(node_tab, tri_tab, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(hs.prim), np.asarray(h1.prim))

    # the real FFI call traces and lowers under shard_map and grad as well
    # (no library here: registration is skipped and nothing is compiled)
    monkeypatch.undo()
    monkeypatch.setattr(cuda_bvh4, "register", lambda: None)

    def loss(scale, nt, tt, o_, d_, t_):
        h = cuda_bvh4.closest(nt, tt, o_ * scale, d_, t_)
        occ = cuda_bvh4.occluded(nt, tt, o_, d_, t_)
        return jax.lax.psum(jnp.sum(jnp.where(occ, h.b1, 0.0) * scale),
                            "rays")

    g = jax.jit(partial(shard_map, mesh=mesh,
                        in_specs=(P(), P(), P(), P("rays"), P("rays"),
                                  P("rays")), out_specs=P())(
        jax.grad(loss)))
    assert "nn_bvh_bvh4_closest" in g.lower(
        jnp.float32(1.0), node_tab, tri_tab, o, d, t_max).as_text()


def test_wrapped_render_gradient_finite(monkeypatch):
    """A render whose intersectors are the CUDA backend's (launch replaced)
    differentiates: the wrapper detaches visibility, material gradients are
    finite and nonzero."""
    from nn_bvh.core import samplers
    from nn_bvh.scatter import lightsamplers
    from nn_bvh.wavefront import camera as camera_mod, film as film_mod, \
        integrator

    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    monkeypatch.setattr(cuda_bvh4, "_ffi_traverse", _fake_launch(dbvh))
    node_tab, tri_tab = cuda_bvh4.pack_scene(dbvh, sc.tri_p)
    isect = dispatch.Intersectors(
        "cuda", ((jnp.asarray(node_tab), jnp.asarray(tri_tab)), None),
        sc.bounds, sort=False, quad_base=int(sc.tri_p.shape[0]))
    cam = camera_mod.make_perspective(
        xf.look_at((0, 2, -5), (0, 0, 0), (0, 1, 0)), fov=40.0, width=8,
        height=8)
    cfg = integrator.IntegratorConfig(max_depth=2, rr_depth=99,
                                      early_exit=False)
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    lst = lightsamplers.build(sc, cfg.light_sampler)
    pix = jnp.arange(64, dtype=jnp.int32)

    def loss(coeffs, tables):
        s2 = sc.replace(mat_coeffs=coeffs)
        L, lam, pdf, _ = integrator.trace_wave(
            s2, dbvh, cam, scfg, cfg, pix, jnp.int32(0), lst,
            isect.bind(tables))
        f = film_mod.add_samples(film_mod.make_film(8, 8), pix, L, lam, pdf)
        return jnp.sum(f.xyz)

    g = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(sc.mat_coeffs),
                                           isect.tables))
    assert np.isfinite(g).all() and np.abs(g).max() > 0


# ---------------------------------------------------------------------------
# backend choice and helpers
# ---------------------------------------------------------------------------

def test_auto_picks_xla_on_cpu(small_scene):
    sc, dbvh = small_scene
    assert dispatch.resolve_traversal("auto") == "xla"
    assert dispatch.make_intersectors(sc, dbvh).backend == "xla"


def test_cuda_without_gpu_raises(small_scene):
    sc, dbvh = small_scene
    with pytest.raises(RuntimeError, match="needs a GPU"):
        dispatch.make_intersectors(sc, dbvh, traversal="cuda")
    with pytest.raises(ValueError, match="traversal must be one of"):
        dispatch.resolve_traversal("pallas")


def test_ray_sort_key_orders_dead_lanes_last():
    o, d, t_max = _rays(777, dead_every=3)
    key = raysort.ray_sort_key(jnp.asarray(o), jnp.asarray(d),
                               jnp.zeros(3), jnp.full(3, 6.0),
                               jnp.asarray(t_max))
    dead_sorted = (t_max < 0)[np.argsort(np.asarray(key), kind="stable")]
    n_live = int((t_max >= 0).sum())
    assert not dead_sorted[:n_live].any() and dead_sorted[n_live:].all()


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    from nn_bvh.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    cache.enable_jax_cache()   # sets no directory when the env names one
    assert jax.config.jax_compilation_cache_dir == before


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.mark.gpu
def test_cuda_kernel_matches_xla_walk(small_scene, gpu_device):
    """On a card: the kernel against the XLA walk (chip_smoke.py repeats
    this at full size on the bench scene)."""
    sc, dbvh = small_scene
    o, d, t_max = (jnp.asarray(a) for a in _rays(4096))
    cu = dispatch.make_intersectors(sc, dbvh, traversal="cuda")
    xl = dispatch.make_intersectors(sc, dbvh, traversal="xla")
    hc, hx = cu.closest(o, d, t_max), xl.closest(o, d, t_max)
    live = np.asarray(t_max) > 0
    pc, px = np.asarray(hc.prim), np.asarray(hx.prim)
    assert (pc[~live] < 0).all()
    tc = np.where(pc >= 0, np.asarray(hc.t), 0.0)
    tx = np.where(px >= 0, np.asarray(hx.t), 0.0)
    np.testing.assert_allclose(tc, tx, rtol=1e-5)
    assert (np.asarray(cu.any_hit(o, d, t_max)) == np.asarray(
        xl.any_hit(o, d, t_max)))[live].all()
