"""Traversal-backend dispatch: one place that picks how rays meet the BVH.

The reference selects its aggregate once at startup (`cpu/render.cpp:47`
CreateAggregate; `wavefront/integrator.cpp:162` OptiX vs CPUAggregate).
Given a compiled scene + flat BVH, `make_intersectors` returns an
`Intersectors` bundle backed by one of

- "cuda": the BVH4 kernel (cuda_bvh4.py), one thread per ray, on the GPU;
- "xla": the per-ray while-loop walk (traverse.py), the plain reference and
  the CPU path.

`traversal="auto"` picks "xla" on the CPU and "cuda" on the GPU; any other
platform raises. Asking for "cuda" without a GPU, or a library that fails to
build or load, raises too: there is no quiet fallback.

JIT-boundary rule: the device tables can be hundreds of MB for big scenes. A
jitted function that CLOSES OVER them embeds them as jaxpr constants and
compile time explodes. So `Intersectors` exposes the device tables as a
`.tables` pytree to be threaded through jit as an ARGUMENT, and
`.bind(tables)` rebuilds the (closest, any_hit) callables from the traced
values inside the jit. Calling `.closest/.any_hit` directly (eager, or on
CPU tests) also works — it binds the concrete tables.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from . import cuda_bvh4, raysort, traverse

TRAVERSALS = ("auto", "xla", "cuda")


class BoundIntersectors(NamedTuple):
    closest: Callable   # (o, d, t_max) -> Hit
    any_hit: Callable   # (o, d, t_max) -> bool mask
    backend: str


class Intersectors:
    """Backend choice + device tables. See module docstring for .bind().

    Analytic quadrics (geometry/quadrics.py) ride as a third table group:
    they are intersected brute-force as an (R, Q) broadcast AFTER the
    triangle traversal and merged by min-t — the analog of the reference
    GPU backend's separate quadric BVH (gpu/aggregate.h:107). Quadric prim
    ids = quad_base + q (above the padded triangle range)."""

    def __init__(self, backend: str, tables, bounds, sort: bool,
                 quad_base: int = 0):
        self.backend = backend
        self.tables = tables      # pytree of device arrays (jit-arg friendly)
        self.bounds = bounds
        self.sort = sort
        self.quad_base = quad_base
        # object motion blur: shutter-end variants of the POSITION-bearing
        # tables (None entries = static/shared). The BVH node table is built
        # over keyframe-union bounds and shared; only triangle data lerps.
        self.tables_end = None

    @staticmethod
    def lerp_tables(tables, tables_end, t):
        """Per-wave shutter-time interpolation of the traversal tables
        (inside jit). a + t*(b-a) is exact when b == a, so static entries
        pass through bit-identically."""
        if tables_end is None:
            return tables
        core, quads = tables
        core_e, _ = tables_end
        new_core = tuple(
            a if b is None else a + t * (b - a)
            for a, b in zip(core, core_e))
        return (new_core, quads)

    def bind(self, tables=None) -> BoundIntersectors:
        # tables is ALWAYS the 2-tuple (core_backend_tables, quad_tables)
        # with quad_tables = (quad_type, quad_params) or None
        t, quads = self.tables if tables is None else tables
        if self.backend == "xla":
            dbvh, tri_p = t
            _closest = lambda *a: traverse.intersect_closest(dbvh, tri_p, *a)
            _any = lambda *a: traverse.intersect_any(dbvh, tri_p, *a)
        else:  # cuda
            node_tab, tri_tab = t
            _closest = lambda *a: cuda_bvh4.closest(node_tab, tri_tab, *a)
            _any = lambda *a: cuda_bvh4.occluded(node_tab, tri_tab, *a)
        if self.sort:
            _closest = raysort.make_sorted_isect(_closest, self.bounds)
            _any = raysort.make_sorted_isect(_any, self.bounds)
        if quads is not None:
            from ..geometry import quadrics as quadrics_mod

            qtype, qparams = quads
            base = self.quad_base
            tri_closest, tri_any = _closest, _any

            def _closest(o, d, t_max):
                hit = tri_closest(o, d, t_max)
                eff = jnp.where(jnp.isfinite(hit.t), hit.t, t_max)
                tq, qi, u, v = quadrics_mod.intersect(qtype, qparams,
                                                      o, d, eff)
                take = qi >= 0  # already tested tq < eff
                return traverse.Hit(
                    t=jnp.where(take, tq, hit.t),
                    prim=jnp.where(take, base + qi, hit.prim),
                    b1=jnp.where(take, u, hit.b1),
                    b2=jnp.where(take, v, hit.b2))

            def _any(o, d, t_max):
                return tri_any(o, d, t_max) | quadrics_mod.intersect_any(
                    qtype, qparams, o, d, t_max)

        return BoundIntersectors(closest=_closest, any_hit=_any,
                                 backend=self.backend)

    # convenience: direct (eager / closure) use — fine for CPU tests and
    # small scenes, avoid inside an outer jit for big ones
    @property
    def closest(self):
        return self.bind().closest

    @property
    def any_hit(self):
        return self.bind().any_hit


def resolve_traversal(traversal: str = "auto") -> str:
    """"auto" -> "xla" on the CPU, "cuda" on the GPU. Raises on any other
    platform, on an unknown name, and on "cuda" without a GPU."""
    if traversal not in TRAVERSALS:
        raise ValueError(f"traversal must be one of {TRAVERSALS}, "
                         f"got {traversal!r}")
    platform = jax.default_backend()
    if traversal == "auto":
        if platform == "cpu":
            return "xla"
        if platform == "gpu":
            return "cuda"
        raise RuntimeError(f"no traversal backend for platform {platform!r}")
    if traversal == "cuda" and platform != "gpu":
        raise RuntimeError(
            f"traversal='cuda' needs a GPU; JAX runs on {platform!r}")
    return traversal


def make_intersectors(scene, dbvh, traversal: str = "auto",
                      sort: bool = False) -> Intersectors:
    """Build the traversal backend for this scene on this platform.

    Host-side packing + the single device upload happen here, and so does
    the CUDA library's build and registration (set-up, outside any jit).
    `scene`/`dbvh` should be host (numpy) arrays. `sort` wraps every call in
    a ray-coherence sort (raysort.make_sorted_isect); the wavefront
    integrators sort their lane state instead (IntegratorConfig.resort).
    """
    backend = resolve_traversal(traversal)
    n_tris = int(scene.tri_p.shape[0])

    # analytic quadric tables (prim ids offset by the PADDED tri count so
    # they index tri_shade's appended rows)
    quads = None
    if getattr(scene, "n_quadrics", 0):
        quads = (jnp.asarray(scene.quad_type), jnp.asarray(scene.quad_params))

    tri_p_end = getattr(scene, "tri_p_end", None)
    if backend == "xla":
        core = (jax.tree.map(jnp.asarray, dbvh), jnp.asarray(scene.tri_p))
        tri_end = tri_p_end
    else:
        cuda_bvh4.register()
        node_tab, tri_tab = cuda_bvh4.pack_scene(dbvh, scene.tri_p)
        core = (jnp.asarray(node_tab), jnp.asarray(tri_tab))
        tri_end = (cuda_bvh4.pack_tris(tri_p_end)
                   if tri_p_end is not None else None)
    isect = Intersectors(backend, (core, quads), scene.bounds, sort=sort,
                         quad_base=n_tris)
    if tri_end is not None:
        # object motion: only the triangle table lerps; the node table was
        # built over both keyframes' bounds and is shared
        isect.tables_end = ((None, jnp.asarray(tri_end)), None)
    return isect
