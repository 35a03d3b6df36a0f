"""Light samplers: uniform, power, and the many-light BVH.

Counterpart of the reference's LightSampler family (`lightsamplers.h`:
Uniform:26, Power:63, BVH:260 — the Conty-Kulla light BVH over
CompactLightBounds:102, Exhaustive:407). The sampler picks WHICH light a
shading point talks to; lights.sample_li then samples it.

Power emitted per light (Light::Phi analogs):
- point: 4*pi*I*scale (lights.cpp PointLight::Phi)
- distant: pi*r_scene^2*L (approx; scene-radius dependent)
- uniform infinite: 4*pi^2*r_scene^2*L
- area tri: pi*A*L*(1 or 2 for twosided) (DiffuseAreaLight::Phi)

BVHLightSampler mapping: the tree is built on host (median split over
light-bounds centroids; LightBounds cone unions per DirectionCone::Union) and
flattened to SoA arrays; Sample() is a lockstep fori_loop of
importance-proportional stochastic descent over all lanes at once
(lightsamplers.h:290-318), PMF() the bit-trail walk (lightsamplers.h:324-358).
Infinite/distant lights sit outside the tree and are selected first with
pInfinite = n_inf / (n_inf + 1) exactly like the reference. The reference's
cos(theta_i) importance factor for surface normals is omitted (ctx normal = 0
case, lightsamplers.h:191) so Sample and PMF stay consistent without carrying
the previous shading normal through the path state — a variance, not a
correctness, tradeoff.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling
from ..geometry import scene as scene_mod

Array = jax.Array

UNIFORM = 0
POWER = 1
BVH = 2
EXHAUSTIVE = 3


def compute_light_powers(scene: scene_mod.CompiledScene) -> np.ndarray:
    """Relative power of each light (host-side, scene build time)."""
    lt = np.asarray(scene.light_type)
    scale = np.asarray(scene.light_scale)
    rgbish = 1.0  # chroma coefficients are normalized; scale carries magnitude
    params = np.asarray(scene.light_params)
    bounds = np.asarray(scene.bounds)
    radius = 0.5 * float(np.linalg.norm(bounds[1] - bounds[0])) + 1e-6
    tri_p = np.asarray(scene.tri_p)

    power = np.zeros(len(lt), np.float64)
    for i, t in enumerate(lt):
        if t == scene_mod.LIGHT_POINT:
            power[i] = 4 * np.pi * scale[i]
        elif t == scene_mod.LIGHT_SPOT:
            # SpotLight::Phi ~ 2 pi I (1 - .5(cosStart+cosEnd)) — scale-level
            power[i] = 2 * np.pi * scale[i]
        elif t in (scene_mod.LIGHT_PROJECTION, scene_mod.LIGHT_GONIOMETRIC):
            power[i] = 4 * np.pi * scale[i]
        elif t == scene_mod.LIGHT_DISTANT:
            power[i] = np.pi * radius * radius * scale[i]
        elif t == scene_mod.LIGHT_UNIFORM_INFINITE:
            power[i] = 4 * np.pi**2 * radius * radius * scale[i]
        elif t in (scene_mod.LIGHT_IMAGE_INFINITE, scene_mod.LIGHT_PORTAL_ENV):
            lum = np.asarray(scene.env_luminance)
            mean_lum = float(lum.mean()) if lum.size > 1 else 1.0
            power[i] = 4 * np.pi**2 * radius * radius * scale[i] * mean_lum
        elif t == scene_mod.LIGHT_AREA_TRI:
            ti = int(params[i, 0])
            p = tri_p[ti]
            area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
            two = 2.0 if params[i, 1] > 0 else 1.0
            power[i] = np.pi * area * scale[i] * two * rgbish
        elif t == scene_mod.LIGHT_SPHERE_AREA:
            r = float(params[i, 0])
            two = 2.0 if params[i, 1] > 0 else 1.0
            power[i] = np.pi * (4 * np.pi * r * r) * scale[i] * two * rgbish
    return np.maximum(power.astype(np.float32), 0.0)


class LightSamplerTables(NamedTuple):
    kind: int              # static
    pmf: Array             # (L,) selection pmf (power/uniform; BVH fallback)
    cdf: Array             # (L,) inclusive cdf
    # --- BVH arrays (1-element dummies for uniform/power) -----------------
    node_blo: Array        # (N,3)
    node_bhi: Array        # (N,3)
    node_w: Array          # (N,3) cone axis
    node_cos: Array        # (N,2) [cos_theta_o, cos_theta_e]
    node_phi: Array        # (N,)
    node_meta: Array       # (N,3) i32 [child_or_light, is_leaf, two_sided]
    light_trail: Array     # (L,) uint32 bit trail (LSB = first descent)
    light_in_bvh: Array    # (L,) bool
    inf_ids: Array         # (Li,) i32 ids of infinite/distant lights
    p_infinite: float      # static
    bvh_depth: int         # static: max descent steps
    has_bvh: bool          # static


from ..utils.pytree import register_static as _register_static

_register_static(LightSamplerTables, ("kind", "p_infinite", "bvh_depth",
                                      "has_bvh"))


# ---------------------------------------------------------------------------
# host-side LightBounds + tree build
# ---------------------------------------------------------------------------

def _cone_union(w1, t1, w2, t2):
    """DirectionCone::Union (util/vecmath.h): exact union of two direction
    cones -> (axis, half-angle)."""
    if t1 < 0:
        return w2, t2
    if t2 < 0:
        return w1, t1
    td = float(np.arccos(np.clip(np.dot(w1, w2), -1.0, 1.0)))
    if min(td + t2, np.pi) <= t1:
        return w1, t1
    if min(td + t1, np.pi) <= t2:
        return w2, t2
    to = (t1 + t2 + td) / 2
    if to >= np.pi:
        return w1, np.pi
    tr = to - t1
    axis = np.cross(w1, w2)
    n = np.linalg.norm(axis)
    if n < 1e-9:
        return w1, np.pi if td > 1e-3 else to
    axis = axis / n
    # rotate w1 by tr around axis (Rodrigues)
    wr = (w1 * np.cos(tr) + np.cross(axis, w1) * np.sin(tr)
          + axis * np.dot(axis, w1) * (1 - np.cos(tr)))
    return wr / np.linalg.norm(wr), to


def _light_bounds(scene, powers):
    """Per-light LightBounds rows (Light::Bounds analogs) for tree lights;
    returns (ids, blo, bhi, w, theta_o, theta_e, phi, two) + infinite ids."""
    lt = np.asarray(scene.light_type)
    pos = np.asarray(scene.light_pos)
    params = np.asarray(scene.light_params)
    tri_p = np.asarray(scene.tri_p)
    rows, inf_ids = [], []
    for i, t in enumerate(lt):
        if t in (scene_mod.LIGHT_DISTANT, scene_mod.LIGHT_UNIFORM_INFINITE,
                 scene_mod.LIGHT_IMAGE_INFINITE, scene_mod.LIGHT_PORTAL_ENV):
            inf_ids.append(i)
            continue
        if t == scene_mod.LIGHT_AREA_TRI:
            p = tri_p[int(params[i, 0])]
            lo, hi = p.min(0), p.max(0)
            n = np.cross(p[1] - p[0], p[2] - p[0])
            ln = np.linalg.norm(n)
            w = n / ln if ln > 1e-12 else np.array([0, 0, 1.0])
            two = params[i, 1] > 0
            rows.append((i, lo, hi, w, 0.0, np.pi / 2, powers[i], two))
        elif t == scene_mod.LIGHT_SPHERE_AREA:
            r = float(params[i, 0])
            lo, hi = pos[i] - r, pos[i] + r
            # emits in every direction: omni normal cone (theta_o = pi)
            rows.append((i, lo, hi, np.array([0, 0, 1.0]), np.pi,
                         np.pi / 2, powers[i], params[i, 1] > 0))
        elif t == scene_mod.LIGHT_SPOT:
            w = params[i, 0:3]
            cos_total = params[i, 3]
            rows.append((i, pos[i], pos[i], w,
                         float(np.arccos(np.clip(cos_total, -1, 1))),
                         np.pi / 2, powers[i], False))
        elif t in (scene_mod.LIGHT_PROJECTION, scene_mod.LIGHT_GONIOMETRIC):
            rows.append((i, pos[i], pos[i], np.array([0, 0, 1.0]), np.pi,
                         np.pi / 2, powers[i], False))
        else:  # point
            rows.append((i, pos[i], pos[i], np.array([0, 0, 1.0]), np.pi,
                         np.pi / 2, powers[i], False))
    return rows, inf_ids


def _build_light_bvh(rows):
    """Median-split build over light-bounds centroids (the reference uses an
    SAH-like direction-cone cost, lightsamplers.cpp:188 EvaluateCost; median
    split trades a little sampling quality for a simple deterministic build).
    Returns flat SoA arrays + per-light bit trails."""
    nodes = []  # dicts
    trails = {}

    def emit(lights, trail, depth):
        my = len(nodes)
        nodes.append(None)
        if len(lights) == 1:
            i, lo, hi, w, to, te, phi, two = lights[0]
            nodes[my] = dict(blo=lo, bhi=hi, w=w, cos=(np.cos(to), np.cos(te)),
                             phi=phi, child=i, leaf=1, two=int(two))
            trails[i] = trail
            return my
        cents = np.stack([(l[1] + l[2]) * 0.5 for l in lights])
        axis = int(np.argmax(cents.max(0) - cents.min(0)))
        order = np.argsort(cents[:, axis], kind="stable")
        half = len(lights) // 2
        left = [lights[j] for j in order[:half]]
        right = [lights[j] for j in order[half:]]
        emit(left, trail, depth + 1)  # first child at my+1
        c1 = emit(right, trail | (1 << depth), depth + 1)
        # merged bounds/cone/power
        blo = np.minimum.reduce([l[1] for l in lights])
        bhi = np.maximum.reduce([l[2] for l in lights])
        w, t = lights[0][3], lights[0][4]
        for l in lights[1:]:
            w, t = _cone_union(np.asarray(w, np.float64), t,
                               np.asarray(l[3], np.float64), l[4])
        te = max(l[5] for l in lights)
        phi = sum(l[6] for l in lights)
        two = int(any(l[7] for l in lights))
        nodes[my] = dict(blo=blo, bhi=bhi, w=w, cos=(np.cos(t), np.cos(te)),
                         phi=phi, child=c1, leaf=0, two=two)
        # fix first-child trail bit (0): already trail unchanged
        return my

    emit(rows, 0, 0)
    n = len(nodes)
    blo = np.stack([nd["blo"] for nd in nodes]).astype(np.float32)
    bhi = np.stack([nd["bhi"] for nd in nodes]).astype(np.float32)
    w = np.stack([np.asarray(nd["w"], np.float32) for nd in nodes])
    cos = np.asarray([nd["cos"] for nd in nodes], np.float32)
    phi = np.asarray([nd["phi"] for nd in nodes], np.float32)
    meta = np.asarray([[nd["child"], nd["leaf"], nd["two"]] for nd in nodes],
                      np.int32)
    return blo, bhi, w, cos, phi, meta, trails, n


def build(scene: scene_mod.CompiledScene, kind: str = "power") -> LightSamplerTables:
    kinds = {"uniform": UNIFORM, "power": POWER, "bvh": BVH,
             "exhaustive": EXHAUSTIVE}
    k = kinds[kind]
    L = scene.n_lights
    z1 = jnp.zeros((1,), jnp.float32)
    z13 = jnp.zeros((1, 3), jnp.float32)
    dummy_bvh = dict(
        node_blo=z13, node_bhi=z13, node_w=z13,
        node_cos=jnp.zeros((1, 2), jnp.float32), node_phi=z1,
        node_meta=jnp.zeros((1, 3), jnp.int32),
        light_trail=jnp.zeros((max(L, 1),), jnp.uint32),
        light_in_bvh=jnp.zeros((max(L, 1),), bool),
        inf_ids=jnp.zeros((1,), jnp.int32),
        p_infinite=0.0, bvh_depth=0, has_bvh=False,
    )
    empty = jnp.zeros((0,), jnp.float32)
    if L == 0:
        return LightSamplerTables(k, empty, empty, **dummy_bvh)
    if k in (UNIFORM, EXHAUSTIVE):
        # Exhaustive's context-free Sample is uniform (lightsamplers.h:418)
        pmf_ = np.full(L, 1.0 / L, np.float32)
    else:
        p = compute_light_powers(scene)
        tot = p.sum()
        pmf_ = (p / tot).astype(np.float32) if tot > 0 else np.full(L, 1.0 / L, np.float32)
        # guard: never zero-probability a light that might be the only path
        pmf_ = np.maximum(pmf_, 1e-8)
        pmf_ /= pmf_.sum()
    cdf = np.cumsum(pmf_).astype(np.float32)

    if k == EXHAUSTIVE:
        # ExhaustiveLightSampler (lightsamplers.cpp:251-312): keep each
        # bounded light's LightBounds as ONE leaf "node"; Sample/PMF
        # evaluate importance over ALL of them (ground truth for the BVH).
        powers = compute_light_powers(scene)
        rows, inf_ids = _light_bounds(scene, powers)
        if rows:
            ids = np.asarray([r[0] for r in rows], np.int32)
            blo = np.stack([r[1] for r in rows]).astype(np.float32)
            bhi = np.stack([r[2] for r in rows]).astype(np.float32)
            w = np.stack([np.asarray(r[3], np.float32) for r in rows])
            cos = np.asarray([(np.cos(r[4]), np.cos(r[5])) for r in rows],
                             np.float32)
            phi = np.asarray([r[6] for r in rows], np.float32)
            meta = np.stack([ids, np.ones_like(ids),
                             np.asarray([int(bool(r[7])) for r in rows],
                                        np.int32)], axis=1)
            in_bvh = np.zeros(L, bool)
            in_bvh[ids] = True
            n_inf = len(inf_ids)
            p_inf = n_inf / (n_inf + 1.0) if n_inf else 0.0
            return LightSamplerTables(
                EXHAUSTIVE, jnp.asarray(pmf_), jnp.asarray(cdf),
                node_blo=jnp.asarray(blo), node_bhi=jnp.asarray(bhi),
                node_w=jnp.asarray(w), node_cos=jnp.asarray(cos),
                node_phi=jnp.asarray(phi), node_meta=jnp.asarray(meta),
                light_trail=jnp.zeros((L,), jnp.uint32),
                light_in_bvh=jnp.asarray(in_bvh),
                inf_ids=jnp.asarray(np.asarray(inf_ids, np.int32)
                                    if inf_ids else np.zeros(1, np.int32)),
                p_infinite=float(p_inf), bvh_depth=0, has_bvh=True,
            )
        k = UNIFORM  # only infinite lights

    if k == BVH:
        powers = compute_light_powers(scene)
        rows, inf_ids = _light_bounds(scene, powers)
        if rows:
            blo, bhi, w, cos, phi, meta, trails, n = _build_light_bvh(rows)
            trail_arr = np.zeros(L, np.uint32)
            in_bvh = np.zeros(L, bool)
            for lid, tr in trails.items():
                trail_arr[lid] = tr
                in_bvh[lid] = True
            n_inf = len(inf_ids)
            p_inf = n_inf / (n_inf + 1.0) if n_inf else 0.0
            depth = int(np.ceil(np.log2(max(len(rows), 2)))) + 2
            return LightSamplerTables(
                BVH, jnp.asarray(pmf_), jnp.asarray(cdf),
                node_blo=jnp.asarray(blo), node_bhi=jnp.asarray(bhi),
                node_w=jnp.asarray(w), node_cos=jnp.asarray(cos),
                node_phi=jnp.asarray(phi), node_meta=jnp.asarray(meta),
                light_trail=jnp.asarray(trail_arr),
                light_in_bvh=jnp.asarray(in_bvh),
                inf_ids=jnp.asarray(np.asarray(inf_ids, np.int32)
                                    if inf_ids else np.zeros(1, np.int32)),
                p_infinite=float(p_inf), bvh_depth=depth, has_bvh=True,
            )
        k = POWER  # only infinite lights: power sampling
    return LightSamplerTables(k, jnp.asarray(pmf_), jnp.asarray(cdf),
                              **dummy_bvh)


# ---------------------------------------------------------------------------
# device-side importance + traversal (CompactLightBounds::Importance,
# lightsamplers.h:144-201, with the ctx-normal term omitted)
# ---------------------------------------------------------------------------

def _cos_sub(sin_a, cos_a, sin_b, cos_b):
    return jnp.where(cos_a > cos_b, 1.0, cos_a * cos_b + sin_a * sin_b)


def _sin_sub(sin_a, cos_a, sin_b, cos_b):
    return jnp.where(cos_a > cos_b, 0.0, sin_a * cos_b - cos_a * sin_b)


def _importance(t: LightSamplerTables, node: Array, p: Array) -> Array:
    blo = t.node_blo[node]
    bhi = t.node_bhi[node]
    w = t.node_w[node]
    cos_o = t.node_cos[node, 0]
    cos_e = t.node_cos[node, 1]
    phi = t.node_phi[node]
    two = t.node_meta[node, 2] > 0

    pc = 0.5 * (blo + bhi)
    d2 = vm.length_squared(p - pc)
    d2 = jnp.maximum(d2, vm.length(bhi - blo) / 2.0)
    wi = vm.normalize(p - pc)
    cos_w = vm.dot(w, wi)
    cos_w = jnp.where(two, jnp.abs(cos_w), cos_w)
    sin_w = vm.safe_sqrt(1.0 - cos_w * cos_w)
    # angle subtended by the bounding sphere of the box (BoundSubtendedDirections)
    r2 = vm.length_squared(bhi - pc)
    dc2 = vm.length_squared(p - pc)
    sin2_b = jnp.clip(r2 / jnp.maximum(dc2, 1e-20), 0.0, 1.0)
    cos_b = jnp.where(dc2 <= r2, -1.0, vm.safe_sqrt(1.0 - sin2_b))
    sin_b = vm.safe_sqrt(1.0 - cos_b * cos_b)
    sin_o = vm.safe_sqrt(1.0 - cos_o * cos_o)
    cos_x = _cos_sub(sin_w, cos_w, sin_o, cos_o)
    sin_x = _sin_sub(sin_w, cos_w, sin_o, cos_o)
    cos_p = _cos_sub(sin_x, cos_x, sin_b, cos_b)
    imp = jnp.where(cos_p <= cos_e, 0.0, phi * cos_p / d2)
    return jnp.maximum(imp, 0.0)


def _exhaustive_importances(t: LightSamplerTables, p: Array) -> Array:
    """(R, Lb) LightBounds importances of every bounded light at p."""
    Lb = t.node_phi.shape[0]
    return jax.vmap(lambda l: _importance(t, l, p))(jnp.arange(Lb)).T


def sample_ctx(t: LightSamplerTables, p: Array, u: Array):
    """Context-aware Sample (BVHLightSampler::Sample, lightsamplers.h:266;
    ExhaustiveLightSampler::Sample, lightsamplers.cpp:268):
    p (R,3) reference points, u (R,) -> (light_id, pmf, u_remapped)."""
    if t.kind == EXHAUSTIVE and t.has_bvh:
        return _sample_exhaustive(t, p, u)
    if t.kind != BVH or not t.has_bvh:
        return sample(t, u)
    R = u.shape[0]
    n_inf = t.inf_ids.shape[0] if float(t.p_infinite) > 0 else 0
    p_inf = jnp.float32(t.p_infinite)
    take_inf = u < p_inf
    if n_inf > 0:
        ui = jnp.clip(u / jnp.maximum(p_inf, 1e-9), 0.0, 1.0 - 2**-24)
        inf_k = jnp.minimum((ui * n_inf).astype(jnp.int32), n_inf - 1)
        inf_id = t.inf_ids[inf_k]
        inf_pmf = p_inf / n_inf
    else:
        inf_id = jnp.full((R,), -1, jnp.int32)
        inf_pmf = 0.0
    ub = jnp.clip((u - p_inf) / jnp.maximum(1.0 - p_inf, 1e-9), 0.0, 1.0 - 2**-24)

    def body(_, carry):
        node, ub, pmf_acc, ok = carry
        is_leaf = t.node_meta[node, 1] > 0
        c0 = node + 1
        c1 = t.node_meta[node, 0]
        i0 = _importance(t, c0, p)
        i1 = _importance(t, jnp.maximum(c1, 0), p)
        tot = i0 + i1
        dead = (~is_leaf) & (tot <= 0)
        w0 = jnp.where(tot > 0, i0 / jnp.maximum(tot, 1e-30), 0.5)
        go0 = ub < w0
        ub_new = jnp.where(go0, ub / jnp.maximum(w0, 1e-9),
                           (ub - w0) / jnp.maximum(1.0 - w0, 1e-9))
        ub_new = jnp.clip(ub_new, 0.0, 1.0 - 2**-24)
        node_new = jnp.where(go0, c0, c1)
        pmf_new = pmf_acc * jnp.where(go0, w0, 1.0 - w0)
        upd = ~is_leaf & ~dead
        return (jnp.where(upd, node_new, node),
                jnp.where(upd, ub_new, ub),
                jnp.where(upd, pmf_new, pmf_acc),
                ok & ~dead)

    node0 = jnp.zeros((R,), jnp.int32)
    pmf0 = jnp.full((R,), 1.0 - float(t.p_infinite), jnp.float32) + u * 0.0
    node, ub, pmf_acc, ok = jax.lax.fori_loop(
        0, t.bvh_depth, body, (node0, ub, pmf0, u > -1.0))
    light = t.node_meta[node, 0]
    lid = jnp.where(take_inf, inf_id, jnp.where(ok, light, -1))
    pmf_out = jnp.where(take_inf, inf_pmf, pmf_acc)
    u_out = jnp.where(take_inf, jnp.zeros_like(u), ub)
    valid = jnp.where(take_inf, inf_id >= 0, ok)
    return jnp.where(valid, lid, -1), pmf_out, u_out


def _sample_exhaustive(t: LightSamplerTables, p: Array, u: Array):
    """ExhaustiveLightSampler::Sample (lightsamplers.cpp:268): infinite
    lights with pInfinite = n_inf/(n_inf+1), else CDF inversion over the
    per-light importances (identical in distribution to the reference's
    weighted-reservoir pass — same selection PMF)."""
    R = u.shape[0]
    n_inf = t.inf_ids.shape[0] if float(t.p_infinite) > 0 else 0
    p_inf = jnp.float32(t.p_infinite)
    take_inf = u < p_inf
    if n_inf > 0:
        ui = jnp.clip(u / jnp.maximum(p_inf, 1e-9), 0.0, 1.0 - 2**-24)
        inf_k = jnp.minimum((ui * n_inf).astype(jnp.int32), n_inf - 1)
        inf_id = t.inf_ids[inf_k]
        inf_pmf = p_inf / n_inf
    else:
        inf_id = jnp.full((R,), -1, jnp.int32)
        inf_pmf = 0.0
    ub = jnp.clip((u - p_inf) / jnp.maximum(1.0 - p_inf, 1e-9),
                  0.0, 1.0 - 2**-24)
    imp = _exhaustive_importances(t, p)                     # (R, Lb)
    total = imp.sum(-1)                                     # (R,)
    csum = jnp.cumsum(imp, axis=-1)
    target = ub[:, None] * total[:, None]
    idx = jnp.sum((csum <= target).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, imp.shape[1] - 1)
    sel_imp = jnp.take_along_axis(imp, idx[:, None], axis=-1)[:, 0]
    lo = jnp.where(idx == 0, 0.0,
                   jnp.take_along_axis(csum, jnp.maximum(idx - 1, 0)[:, None],
                                       axis=-1)[:, 0])
    u2 = jnp.clip((target[:, 0] - lo) / jnp.maximum(sel_imp, 1e-20),
                  0.0, 1.0 - 2**-24)
    ok = total > 0
    pmf_b = (1.0 - p_inf) * sel_imp / jnp.maximum(total, 1e-30)
    lid_b = t.node_meta[idx, 0]
    lid = jnp.where(take_inf, inf_id, jnp.where(ok, lid_b, -1))
    pmf_out = jnp.where(take_inf, inf_pmf, pmf_b)
    u_out = jnp.where(take_inf, jnp.zeros_like(u), u2)
    return lid, pmf_out, u_out


def pmf_ctx(t: LightSamplerTables, p: Array, light_id: Array) -> Array:
    """Context-aware PMF (BVHLightSampler::PMF bit-trail walk,
    lightsamplers.h:324; ExhaustiveLightSampler::PMF,
    lightsamplers.cpp:296)."""
    if t.kind == EXHAUSTIVE and t.has_bvh:
        L = t.pmf.shape[0]
        lid = jnp.clip(light_id, 0, L - 1)
        in_b = t.light_in_bvh[lid]
        imp = _exhaustive_importances(t, p)                 # (R, Lb)
        total = imp.sum(-1)
        match = t.node_meta[None, :, 0] == lid[:, None]     # (R, Lb)
        light_imp = jnp.sum(jnp.where(match, imp, 0.0), axis=-1)
        p_inf = float(t.p_infinite)
        pmf_b = (1.0 - p_inf) * light_imp / jnp.maximum(total, 1e-30)
        n_inf = t.inf_ids.shape[0] if p_inf > 0 else 0
        inf_pmf = (p_inf / n_inf) if n_inf > 0 else 0.0
        return jnp.where(in_b, pmf_b, inf_pmf)
    if t.kind != BVH or not t.has_bvh:
        return pmf(t, light_id)
    L = t.pmf.shape[0]
    lid = jnp.clip(light_id, 0, L - 1)
    in_bvh = t.light_in_bvh[lid]
    n_inf = t.inf_ids.shape[0] if float(t.p_infinite) > 0 else 0
    inf_pmf = (float(t.p_infinite) / n_inf) if n_inf > 0 else 0.0
    trail = t.light_trail[lid]

    def body(_, carry):
        node, trail, pmf_acc, done = carry
        is_leaf = t.node_meta[node, 1] > 0
        c0 = node + 1
        c1 = t.node_meta[node, 0]
        i0 = _importance(t, c0, p)
        i1 = _importance(t, jnp.maximum(c1, 0), p)
        bit = (trail & jnp.uint32(1)) == 1
        ci = jnp.where(bit, i1, i0)
        tot = i0 + i1
        pmf_new = pmf_acc * ci / jnp.maximum(tot, 1e-30)
        node_new = jnp.where(bit, c1, c0)
        upd = ~done & ~is_leaf
        return (jnp.where(upd, node_new, node),
                jnp.where(upd, trail >> 1, trail),
                jnp.where(upd, pmf_new, pmf_acc),
                done | is_leaf)

    R = p.shape[0]
    node0 = jnp.zeros(light_id.shape, jnp.int32)
    pmf0 = jnp.full(light_id.shape, 1.0 - float(t.p_infinite), jnp.float32)
    _, _, pmf_bvh, _ = jax.lax.fori_loop(
        0, t.bvh_depth, body, (node0, trail, pmf0,
                               jnp.zeros(light_id.shape, bool)))
    return jnp.where(in_bvh, pmf_bvh, inf_pmf)


def sample(tables: LightSamplerTables, u: Array) -> tuple[Array, Array, Array]:
    """Context-free sample: u (R,) -> (light_id (R,), pmf (R,), u_remapped)."""
    L = tables.pmf.shape[0]
    if L == 0:
        z = jnp.zeros_like(u)
        return jnp.full(u.shape, -1, jnp.int32), z, u
    if tables.kind in (UNIFORM, EXHAUSTIVE):
        lid = jnp.minimum((u * L).astype(jnp.int32), L - 1)
        u2 = jnp.clip(u * L - lid.astype(jnp.float32), 0.0, 1.0 - 2**-24)
        return lid, jnp.full(u.shape, 1.0 / L), u2
    lid = jnp.clip(jnp.searchsorted(tables.cdf, u, side="right"), 0, L - 1)
    pmf_ = tables.pmf[lid]
    lo = jnp.where(lid == 0, 0.0, tables.cdf[jnp.maximum(lid - 1, 0)])
    hi = tables.cdf[lid]
    u2 = jnp.clip((u - lo) / jnp.maximum(hi - lo, 1e-20), 0.0, 1.0 - 2**-24)
    return lid, pmf_, u2


def pmf(tables: LightSamplerTables, light_id: Array) -> Array:
    """Selection pmf of a given light (for MIS at emissive hits)."""
    L = tables.pmf.shape[0]
    if L == 0:
        return jnp.zeros(light_id.shape, jnp.float32)
    if tables.kind in (UNIFORM, EXHAUSTIVE):
        return jnp.full(light_id.shape, 1.0 / L)
    return tables.pmf[jnp.clip(light_id, 0, L - 1)]
