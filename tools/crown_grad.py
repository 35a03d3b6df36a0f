#!/usr/bin/env python
"""Crown pixel-gradient check: autodiff vs finite differences on a crown
material parameter (BASELINE.json north star: 'pixel gradients allclose to
finite differences', gated here on the real scene rather than a toy).

Renders a small crop of the crown at low spp, takes d(mean crop luminance)/
d(mat_coeffs[gold]) by reverse-mode AD through the wavefront renderer, and
compares against central finite differences with COMMON RANDOM NUMBERS
(same sampler seeds, so the FD noise cancels and the comparison is exact up
to float precision + the FD step's truncation error).

Usage: python tools/crown_grad.py  (GPU)
Prints a JSON line with rel_err; exit 0 iff rel_err < 2%.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from nn_bvh.utils.cache import enable_jax_cache

    enable_jax_cache()
    from nn_bvh.geometry import pbrt_parser
    from nn_bvh.core import samplers
    from nn_bvh.wavefront import integrator
    from nn_bvh.scatter import lightsamplers
    from nn_bvh.accel import dispatch

    scene_file = "/tmp/crown_golden/crown_golden.pbrt"
    assert os.path.exists(scene_file), \
        "stage first: python tools/refbuild/crown_golden.py"
    sc, dbvh, cam, res = pbrt_parser.load_scene(scene_file)
    # small central crop: shrink the film; camera rays still cover the crown
    res_px = int(os.environ.get("CROWN_GRAD_RES", "64"))
    depth = int(os.environ.get("CROWN_GRAD_DEPTH", "4"))
    cam = cam._replace(width=res_px, height=res_px)
    cfg = integrator.IntegratorConfig(
        max_depth=depth, mis=True, kind="path",
        early_exit=False,  # runs under jax.grad
        # NaN-bisect knobs: CROWN_GRAD_NO_NEE=1 drops light sampling (BSDF
        # path only), isolating the NEE/emissive-MIS subsystem
        sample_lights=not os.environ.get("CROWN_GRAD_NO_NEE"))
    sampler_cfg = samplers.make_sampler("independent", seed=7, spp=2)
    ls = lightsamplers.build(sc, cfg.light_sampler)
    isect = dispatch.make_intersectors(
        sc, dbvh, sort=not os.environ.get("CROWN_GRAD_NOSORT"))
    scd, dbvhd, lsd = jax.tree.map(jnp.asarray, (sc, dbvh, ls))

    R = cam.width * cam.height
    pixel_idx = jnp.arange(R, dtype=jnp.int32)

    # pick the most-used material (the crown's dominant gold)
    mats, counts = np.unique(np.asarray(sc.tri_mat)[:sc.n_tris],
                             return_counts=True)
    mat_id = int(mats[np.argmax(counts * (mats >= 0))])

    # EVERY large array rides as a jit ARGUMENT — a closed-over scene would
    # be serialized into the jaxpr as a constant and blow up compile time
    # (the dispatch.bind tables pattern applied to the whole loss)
    def crop_mean(coeffs, tables, scd, dbvhd, lsd):
        s2 = scd.replace(mat_coeffs=coeffs)
        bi = isect.bind(tables)
        total = jnp.float32(0.0)
        for s in range(2):
            L, lam, lam_pdf, fw = integrator.trace_wave(
                s2, dbvhd, cam, sampler_cfg, cfg, pixel_idx, jnp.int32(s),
                lsd, bi)
            total = total + jnp.mean(L)
        return total / 2.0

    f = jax.jit(crop_mean)
    g = jax.jit(jax.grad(crop_mean))

    coeffs0 = jnp.asarray(sc.mat_coeffs)
    grad = np.asarray(g(coeffs0, isect.tables, scd, dbvhd, lsd))[mat_id]

    eps = 3e-2
    fd = np.zeros(3, np.float64)
    for c in range(3):
        dv = np.zeros_like(np.asarray(coeffs0))
        dv[mat_id, c] = eps
        up = float(f(coeffs0 + dv, isect.tables, scd, dbvhd, lsd))
        dn = float(f(coeffs0 - dv, isect.tables, scd, dbvhd, lsd))
        fd[c] = (up - dn) / (2 * eps)

    denom = max(np.abs(fd).max(), 1e-12)
    rel = float(np.abs(grad - fd).max() / denom)
    print(json.dumps({
        "metric": "crown_grad_vs_fd_rel_err",
        "mat_id": mat_id,
        "grad_ad": [float(x) for x in grad],
        "grad_fd": [float(x) for x in fd],
        "value": rel,
    }))
    return 0 if rel < 0.02 else 1


if __name__ == "__main__":
    sys.exit(main())
