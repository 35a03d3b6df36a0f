"""Analytic quadrics: sphere / disk / cylinder (shapes.h:107,404,574).

The r1-r3 build tessellated quadrics into triangles (with a shadow-ray
"sag" epsilon to hide the inscribed-mesh bias, VERDICT r3 missing #4).
This module intersects them ANALYTICALLY, as a dense batch: scenes carry few
quadrics (killeroo: 2 spheres; crown: 2), so instead of entering the BVH
they are tested brute-force as an (R, Q) broadcast after the
triangle traversal and merged by min-t — the same architecture as the
reference GPU backend, which builds a SEPARATE acceleration structure for
quadrics (`gpu/aggregate.h:107 buildBVHForQuadrics`) and merges at the
instance level.

Quadric records are world-space canonical frames:
  sphere:   [cx cy cz | r | zx zy zz | xx xy xz | zmin zmax phimax]
  disk:     [cx cy cz | r | nx ny nz | xx xy xz | h=0  inner phimax]
  cylinder: [cx cy cz | r | ax ay az | xx xy xz | zmin zmax phimax]
(z/n/a = frame z axis; x = frame x axis for phi; zmin/zmax in frame units.)

Quadric prim ids live ABOVE the padded triangle range: hit.prim =
quad_base + q; tri_shade carries Q appended rows so the fused
material/light/medium gathers work unchanged (integrator._shading_point
branches only for position/normal/uv).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import vecmath as vm

Array = jax.Array

SPHERE = 0
DISK = 1
CYLINDER = 2
BILINEAR = 3   # non-planar bilinear patch (Reshetov; shapes.h:1279)

N_QUAD_PARAMS = 13


def make_bilinear_record(p00, p10, p01, p11) -> tuple[int, np.ndarray]:
    """Bilinear-patch record: the 4 corners packed into the param slots
    (pbrt corner order p00 p10 p01 p11, shapes.h BilinearPatch)."""
    p = np.zeros(N_QUAD_PARAMS, np.float32)
    p[0:3] = np.asarray(p00, np.float32)
    p[3:6] = np.asarray(p10, np.float32)
    p[6:9] = np.asarray(p01, np.float32)
    p[9:12] = np.asarray(p11, np.float32)
    return BILINEAR, p


def make_record(kind: str, center, radius: float, axis=(0.0, 0.0, 1.0),
                x_axis=None, zmin: float = -1e30, zmax: float = 1e30,
                inner_radius: float = 0.0,
                phimax: float = 2.0 * np.pi) -> tuple[int, np.ndarray]:
    """Host-side quadric record (world-space canonical frame)."""
    kinds = {"sphere": SPHERE, "disk": DISK, "cylinder": CYLINDER}
    z = np.asarray(axis, np.float64)
    z = z / max(np.linalg.norm(z), 1e-12)
    if x_axis is None:
        h = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
        x = np.cross(h, z)
        x /= max(np.linalg.norm(x), 1e-12)
    else:
        x = np.asarray(x_axis, np.float64)
        x /= max(np.linalg.norm(x), 1e-12)
    p = np.zeros(N_QUAD_PARAMS, np.float32)
    p[0:3] = np.asarray(center, np.float32)
    p[3] = float(radius)
    p[4:7] = z.astype(np.float32)
    p[7:10] = x.astype(np.float32)
    if kinds[kind] == DISK:
        p[10] = 0.0
        p[11] = float(inner_radius)
    else:
        p[10] = float(max(zmin, -radius if kinds[kind] == SPHERE else zmin))
        p[11] = float(min(zmax, radius if kinds[kind] == SPHERE else zmax))
    p[12] = float(phimax)
    return kinds[kind], p


def bounds(kind: int, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if kind == BILINEAR:
        pts = p[0:12].reshape(4, 3)
        return pts.min(0), pts.max(0)
    c, r = p[0:3], p[3]
    if kind == DISK:
        return c - r, c + r
    if kind == CYLINDER:
        z = p[4:7]
        lo = np.minimum(c + p[10] * z, c + p[11] * z) - r
        hi = np.maximum(c + p[10] * z, c + p[11] * z) + r
        return lo, hi
    return c - r, c + r


# ---------------------------------------------------------------------------
# device intersection: (R,) rays x (Q,) quadrics
# ---------------------------------------------------------------------------

def _quadratic(a, b, c):
    """Stable quadratic roots (math.h Quadratic, citardauq form).
    Returns (has, t0, t1) with t0 <= t1."""
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b) * sq)
    q = jnp.where(jnp.abs(b) < 1e-30, -0.5 * sq, q)
    t0 = q / jnp.where(jnp.abs(a) < 1e-30, 1e-30, a)
    t1 = c / jnp.where(jnp.abs(q) < 1e-30, 1e-30, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    return has, lo, hi


def intersect(qtype: Array, qparams: Array, o: Array, d: Array, t_max: Array,
              eps: float = 1e-4):
    """All-quadrics closest hit. o/d (R,3), t_max (R,) -> (t (R,), idx (R,),
    u (R,), v (R,)) with idx = -1 on miss. Brute force over Q (Q is small)."""
    R = o.shape[0]
    Q = qparams.shape[0]
    c = qparams[None, :, 0:3]            # (1,Q,3)
    r = qparams[None, :, 3]              # (1,Q)
    zax = qparams[None, :, 4:7]
    xax = qparams[None, :, 7:10]
    yax = jnp.cross(zax, xax)
    p0 = qparams[None, :, 10]
    p1 = qparams[None, :, 11]
    ob = o[:, None, :] - c               # (R,Q,3)
    db = d[:, None, :]
    oz = jnp.sum(ob * zax, -1)
    dz = jnp.sum(db * zax, -1)

    # ---- sphere ----
    a_s = jnp.sum(db * db, -1)
    b_s = 2.0 * jnp.sum(ob * db, -1)
    c_s = jnp.sum(ob * ob, -1) - r * r
    has_s, s0, s1 = _quadratic(a_s, b_s, c_s)
    t_sph = jnp.where(s0 > eps, s0, s1)
    ok_s = has_s & (t_sph > eps)

    # ---- disk (plane z=0 in frame, radius annulus) ----
    t_dk = -oz / jnp.where(jnp.abs(dz) < 1e-12, 1e-12, dz)
    pd = ob + t_dk[..., None] * db
    rd2 = jnp.sum(pd * pd, -1) - jnp.sum(pd * zax, -1) ** 2
    ok_d = (jnp.abs(dz) > 1e-12) & (t_dk > eps) & (rd2 <= r * r) \
        & (rd2 >= p1 * p1)

    # ---- cylinder (infinite, clipped to [zmin, zmax] along frame z) ----
    dperp = db - dz[..., None] * zax
    operp = ob - oz[..., None] * zax
    a_c = jnp.sum(dperp * dperp, -1)
    b_c = 2.0 * jnp.sum(dperp * operp, -1)
    c_c = jnp.sum(operp * operp, -1) - r * r
    has_c, c0, c1 = _quadratic(a_c, b_c, c_c)
    z_at = lambda t: oz + t * dz
    ok_c0 = has_c & (c0 > eps) & (z_at(c0) >= p0) & (z_at(c0) <= p1)
    ok_c1 = has_c & (c1 > eps) & (z_at(c1) >= p0) & (z_at(c1) <= p1)
    t_cyl = jnp.where(ok_c0, c0, c1)
    ok_c = ok_c0 | ok_c1

    # ---- bilinear patch (Reshetov; shapes.h:1279 IntersectBilinearPatch).
    # P(u,v) = p00 + u a + v b + uv cc with a=p10-p00, b=p01-p00,
    # cc=p11-p10-p01+p00. Projecting the ray equation onto two vectors
    # k1,k2 perpendicular to d eliminates t and leaves two bilinear
    # equations; eliminating v gives a quadratic in u.
    bp00 = qparams[None, :, 0:3]
    bp10 = qparams[None, :, 3:6]
    bp01 = qparams[None, :, 6:9]
    bp11 = qparams[None, :, 9:12]
    ba = bp10 - bp00
    bb = bp01 - bp00
    bcc = bp11 - bp10 - bp01 + bp00
    bs = bp00 - o[:, None, :]
    k1, k2 = vm.coordinate_system(d)
    k1 = k1[:, None, :]
    k2 = k2[:, None, :]
    A1 = jnp.sum(k1 * bcc, -1); B1 = jnp.sum(k1 * ba, -1)
    C1 = jnp.sum(k1 * bb, -1); D1 = jnp.sum(k1 * bs, -1)
    A2 = jnp.sum(k2 * bcc, -1); B2 = jnp.sum(k2 * ba, -1)
    C2 = jnp.sum(k2 * bb, -1); D2 = jnp.sum(k2 * bs, -1)
    qa = A1 * B2 - A2 * B1
    qb = A1 * D2 + B2 * C1 - A2 * D1 - B1 * C2
    qc = C1 * D2 - C2 * D1
    has_b, u0, u1 = _quadratic(qa, qb, qc)
    # linear fallback when the quadratic degenerates (planar-ish patches)
    u_lin = -qc / jnp.where(jnp.abs(qb) < 1e-20, 1e-20, qb)
    lin = jnp.abs(qa) < 1e-12 * jnp.maximum(jnp.abs(qb), 1.0)
    dd = jnp.sum(d * d, -1)[:, None]

    def _patch_eval(uu):
        den1 = A1 * uu + C1
        den2 = A2 * uu + C2
        use1 = jnp.abs(den1) >= jnp.abs(den2)
        vv = jnp.where(use1,
                       -(B1 * uu + D1) / jnp.where(jnp.abs(den1) < 1e-20,
                                                   1e-20, den1),
                       -(B2 * uu + D2) / jnp.where(jnp.abs(den2) < 1e-20,
                                                   1e-20, den2))
        pt = bs + uu[..., None] * ba + vv[..., None] * bb \
            + (uu * vv)[..., None] * bcc
        tt = jnp.sum(pt * d[:, None, :], -1) / dd
        okk = (uu >= 0) & (uu <= 1) & (vv >= 0) & (vv <= 1) & (tt > eps)
        return jnp.where(okk, tt, jnp.inf), vv, okk

    tb0, vb0, okb0 = _patch_eval(jnp.where(lin, u_lin, u0))
    tb1, vb1, okb1 = _patch_eval(u1)
    okb1 = okb1 & ~lin
    pick0 = tb0 <= tb1
    t_bil = jnp.minimum(tb0, tb1)
    u_bil = jnp.where(pick0, jnp.where(lin, u_lin, u0), u1)
    v_bil = jnp.where(pick0, vb0, vb1)
    ok_b = (okb0 | okb1) & (has_b | lin)

    qt = qtype[None, :]
    t_all = jnp.select([qt == SPHERE, qt == DISK, qt == BILINEAR],
                       [t_sph, t_dk, t_bil], t_cyl)
    ok = jnp.select([qt == SPHERE, qt == DISK, qt == BILINEAR],
                    [ok_s, ok_d, ok_b], ok_c)
    ok = ok & (t_all < t_max[:, None])
    t_all = jnp.where(ok, t_all, jnp.inf)

    # parametric uv (Sphere/Disk/Cylinder::Intersect interaction uv)
    ph = ob + t_all[..., None] * db
    px = jnp.sum(ph * xax, -1)
    py = jnp.sum(ph * yax, -1)
    pz = jnp.sum(ph * zax, -1)
    phi = jnp.arctan2(py, px)
    phi = jnp.where(phi < 0, phi + 2.0 * np.pi, phi)
    u_sph = phi / jnp.maximum(qparams[None, :, 12], 1e-6)
    v_sph = jnp.arccos(jnp.clip(pz / jnp.maximum(r, 1e-9), -1.0, 1.0)) / np.pi
    rr = jnp.sqrt(jnp.maximum(px * px + py * py, 1e-20))
    v_dk = (r - rr) / jnp.maximum(r - p1, 1e-9)
    v_cyl = (pz - p0) / jnp.maximum(p1 - p0, 1e-9)
    u = jnp.where(qt == BILINEAR, jnp.clip(u_bil, 0.0, 1.0), u_sph)
    v = jnp.select([qt == SPHERE, qt == DISK, qt == BILINEAR],
                   [v_sph, v_dk, jnp.clip(v_bil, 0.0, 1.0)], v_cyl)

    best = jnp.argmin(t_all, axis=1)
    ar = jnp.arange(R)
    t_best = t_all[ar, best]
    hit_any = jnp.isfinite(t_best)
    return (jnp.where(hit_any, t_best, jnp.inf),
            jnp.where(hit_any, best, -1),
            u[ar, best], v[ar, best])


def intersect_any(qtype: Array, qparams: Array, o: Array, d: Array,
                  t_max: Array, eps: float = 1e-4) -> Array:
    t, idx, _, _ = intersect(qtype, qparams, o, d, t_max, eps)
    return idx >= 0


def shading(qtype: Array, qparams: Array, qidx: Array, o: Array, d: Array,
            t: Array, u: Array | None = None, v: Array | None = None):
    """Analytic position/normal at a quadric hit. qidx (R,) >= 0 assumed
    (callers mask). u/v: parametric hit coords (needed for the bilinear-
    patch normal dPdu x dPdv). Returns (p, n) with n the OUTWARD geometric
    normal (= shading normal; quadrics/patches are smooth)."""
    rec = qparams[jnp.maximum(qidx, 0)]
    kind = qtype[jnp.maximum(qidx, 0)]
    c = rec[..., 0:3]
    zax = rec[..., 4:7]
    p = o + t[..., None] * d
    rel = p - c
    # sphere: radial; disk: frame z; cylinder: radial from axis
    n_sph = vm.normalize(rel)
    n_dk = zax
    pz = jnp.sum(rel * zax, -1, keepdims=True)
    n_cyl = vm.normalize(rel - pz * zax)
    n = jnp.select([(kind == SPHERE)[..., None], (kind == DISK)[..., None]],
                   [n_sph, n_dk], n_cyl)
    if u is not None:
        # bilinear patch: n = normalize(dPdu x dPdv), oriented toward -d
        ba = rec[..., 3:6] - rec[..., 0:3]
        bb = rec[..., 6:9] - rec[..., 0:3]
        bcc = rec[..., 9:12] - rec[..., 3:6] - rec[..., 6:9] + rec[..., 0:3]
        dpdu = ba + v[..., None] * bcc
        dpdv = bb + u[..., None] * bcc
        n_bil = vm.normalize(jnp.cross(dpdu, dpdv))
        n_bil = jnp.where((jnp.sum(n_bil * d, -1) > 0)[..., None],
                          -n_bil, n_bil)
        n = jnp.where((kind == BILINEAR)[..., None], n_bil, n)
    return p, n


def uv_scale(qtype: np.ndarray, qparams: np.ndarray) -> np.ndarray:
    """Host: approximate uv-length per world-length for ray-cone LOD."""
    r = np.maximum(qparams[:, 3], 1e-6)
    out = 1.0 / (np.pi * r)
    for i in range(len(qtype)):
        if qtype[i] == BILINEAR:
            pts = qparams[i, 0:12].reshape(4, 3)
            ext = max(np.linalg.norm(pts[1] - pts[0]),
                      np.linalg.norm(pts[2] - pts[0]), 1e-6)
            out[i] = 1.0 / ext
    return out.astype(np.float32)
