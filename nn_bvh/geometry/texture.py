"""Native-resolution mipmapped textures (atlas + ray-cone LOD).

Replaces the r1-r3 fixed 256^2 texture stack (the old `TEX_RES` resample,
flagged in VERDICT r3 as a standing fidelity cap) with the device analog of
the reference's MIPMap (`util/mipmap.h:49`, trilinear path):

- Host: every image texture keeps its NATIVE resolution; a box-filtered mip
  pyramid is built per texture in RGB space (filtering before spectral
  uplift, matching the reference which filters texels and uplifts samples),
  each level is converted to sigmoid-polynomial coefficients, and all levels
  of all textures are packed into ONE flat (Ntexels, 4) atlas. A small
  (T, LMAX, 3) descriptor table holds [offset, width, height] per level.
- Device: `lookup()` gathers from the flat atlas — bilinear within the
  selected level, optionally lerped across two levels (trilinear). Flat
  1-D gathers keep XLA on the fast full-row gather path (BASELINE.md r3:
  sliced-minor-dim gathers are ~50x slower).
- LOD: ray cones (`cone_*` helpers) — the batch-friendly footprint tracker:
  no per-lane differential state, just a spread angle and a hit distance,
  the standard RT-core-era replacement for pbrt's CPU ray differentials
  (`cameras.h` ray differentials; wavefront approximates them too).

Texture lookups that predate LOD wiring pass lod=None and read level 0
bilinearly (full native resolution).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# host-side: pyramid build + atlas packing
# ---------------------------------------------------------------------------

def build_pyramid(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered mip chain down to 1x1 (MIPMap::generatePyramid analog;
    odd sizes round up like the reference's ResampleWeights path, here by
    edge-padding to even before the 2x box)."""
    img = np.asarray(img, np.float32)
    levels = [img]
    cur = img
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h % 2 or w % 2:
            cur = np.pad(cur, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
            h, w = cur.shape[:2]
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                      + cur[0::2, 1::2] + cur[1::2, 1::2])
        levels.append(cur.astype(np.float32))
    return levels


def pack_atlas(images: list[np.ndarray]):
    """Pack mip pyramids of all textures into one flat coefficient atlas.

    Returns (atlas (N, 4) f32, desc (T, LMAX, 3) i32 [offset, w, h]).
    Levels beyond a texture's chain repeat its 1x1 tail so lod clamping
    needs no per-texture bound."""
    from ..core import rgb2spec

    pyramids = [build_pyramid(im) for im in images]
    lmax = max(len(p) for p in pyramids)
    chunks = []
    desc = np.zeros((len(images), lmax, 3), np.int64)
    offset = 0
    for t, pyr in enumerate(pyramids):
        for l in range(lmax):
            lev = pyr[min(l, len(pyr) - 1)]
            h, w = lev.shape[:2]
            if l < len(pyr):
                coeffs = rgb2spec.rgb_image_to_coeffs(lev).reshape(-1, 4)
                chunks.append(coeffs)
                desc[t, l] = (offset, w, h)
                offset += h * w
            else:
                desc[t, l] = desc[t, len(pyr) - 1]
    atlas = np.concatenate(chunks, 0).astype(np.float32)
    return atlas, desc.astype(np.int32)


# ---------------------------------------------------------------------------
# device-side lookup
# ---------------------------------------------------------------------------

def _bilerp_level(atlas: Array, off: Array, w: Array, h: Array,
                  uv: Array) -> Array:
    """Bilinear fetch inside one level (4 flat gathers).

    uv in [0,1) after wrapping; texel centers at (i+0.5)/w like the
    reference's MIPMap::Texel addressing."""
    fx = uv[..., 0] * w.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0.astype(jnp.float32)
    ty = fy - y0.astype(jnp.float32)

    def texel(xi, yi):
        # wrap addressing (UVMapping repeat; pbrt WrapMode::Repeat default)
        xi = jax.lax.rem(xi + w * 16, jnp.maximum(w, 1))
        yi = jax.lax.rem(yi + h * 16, jnp.maximum(h, 1))
        return atlas[off + yi * w + xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    tx1 = tx[..., None]
    ty1 = ty[..., None]
    return ((c00 * (1 - tx1) + c10 * tx1) * (1 - ty1)
            + (c01 * (1 - tx1) + c11 * tx1) * ty1)


def lookup(atlas: Array, desc: Array, tex_id: Array, uv: Array,
           foot_log2: Array | None = None, trilinear: bool = True) -> Array:
    """Filtered texture fetch -> (..., 4) spectral coefficients.

    tex_id: (...,) i32 (callers mask invalid ids themselves); uv (..., 2);
    foot_log2: (...,) log2 of the uv-space footprint width (ray-cone
    estimate); the mip level is foot_log2 + log2(native width) per texture
    (None = level 0, unfiltered native). trilinear lerps the two bracketing
    levels (8 gathers), else bilinear at the rounded level."""
    T, LMAX, _ = desc.shape
    tid = jnp.clip(tex_id, 0, T - 1)
    uvw = uv - jnp.floor(uv)
    if foot_log2 is None:
        d = desc[tid, 0]
        return _bilerp_level(atlas, d[..., 0], d[..., 1], d[..., 2], uvw)
    w0 = desc[tid, 0, 1].astype(jnp.float32)
    lod = foot_log2 + jnp.log2(jnp.maximum(w0, 1.0))
    lod = jnp.clip(lod, 0.0, LMAX - 1.0)
    if not trilinear:
        li = jnp.round(lod).astype(jnp.int32)
        d = desc[tid, li]
        return _bilerp_level(atlas, d[..., 0], d[..., 1], d[..., 2], uvw)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, LMAX - 1)
    fr = (lod - l0.astype(jnp.float32))[..., None]
    d0 = desc[tid, l0]
    d1 = desc[tid, l1]
    c0 = _bilerp_level(atlas, d0[..., 0], d0[..., 1], d0[..., 2], uvw)
    c1 = _bilerp_level(atlas, d1[..., 0], d1[..., 1], d1[..., 2], uvw)
    return c0 * (1.0 - fr) + c1 * fr


# ---------------------------------------------------------------------------
# ray-cone LOD
# ---------------------------------------------------------------------------

def camera_spread(fov_deg: float, height: int) -> float:
    """Per-pixel cone spread angle of the camera (radians/pixel)."""
    import math

    return 2.0 * math.tan(math.radians(fov_deg) * 0.5) / max(height, 1)


def cone_foot_log2(cone_width: Array, cos_in: Array,
                   uv_scale: Array) -> Array:
    """log2 uv-space footprint of a ray cone at the hit.

    cone_width: accumulated cone width at the hit (t * spread for camera
    rays); cos_in: |w . n|; uv_scale: per-triangle uv-length per
    world-length (sqrt(uv_area / world_area)). One footprint axis stretches
    by 1/cos under oblique incidence; the sqrt is the isotropic-trilinear
    compromise (Amanatides-style cone tracing)."""
    foot_uv = cone_width * uv_scale / jnp.sqrt(jnp.clip(cos_in, 1e-2, 1.0))
    return jnp.log2(jnp.maximum(foot_uv, 1e-12))
