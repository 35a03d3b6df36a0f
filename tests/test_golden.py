"""Golden parity tests against the reference pbrt-v4 CPU renderer.

The goldens under data/golden/ were rendered by the actual pbrt-v4 CPU
binary built from /root/reference (see BASELINE.md "golden baseline" section
for the exact commands). The gate mirrors the reference's own accuracy
test: scene-average radiance within a small tolerance
(cpu/integrators_test.cpp:50-65 uses ±0.025 on unit scenes; here the scene
mean is ~2.26 so the gate is relative), plus a blockwise structural check
so a right-mean-wrong-image render cannot pass.

CI renders at reduced res/spp on CPU (the full 400x400@16spp config is for
the GPU).
"""

import os

import numpy as np
import pytest

from nn_bvh.utils import exr

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden")
KILLEROO = "/root/reference/scenes/killeroos/killeroo-simple-v4.pbrt"


def _downsample(im: np.ndarray, nb: int) -> np.ndarray:
    """Average-pool to (nb, nb, 3)."""
    h, w, _ = im.shape
    bh, bw = h // nb, w // nb
    return im[:nb * bh, :nb * bw].reshape(nb, bh, nb, bw, 3).mean((1, 3))


@pytest.fixture(scope="module")
def golden16():
    return exr.read_rgb(os.path.join(GOLDEN,
                                     "killeroo-simplepath-400-16spp.exr"))


def test_golden_exr_reads(golden16):
    assert golden16.shape == (400, 400, 3)
    assert np.isfinite(golden16).all()
    assert 1.0 < golden16.mean() < 4.0


def test_killeroo_simplepath_mean_parity(golden16):
    """Render killeroo-simple (reduced res/spp) and gate the scene mean and
    blockwise structure against the pbrt-v4 CPU golden."""
    from nn_bvh import accel
    from nn_bvh.geometry import pbrt_parser
    from nn_bvh.wavefront import integrator

    res, spp = 100, 4
    sc, dbvh, cam, _ = pbrt_parser.load_scene(KILLEROO)
    cam = cam._replace(width=res, height=res)
    cfg = integrator.IntegratorConfig(max_depth=5, mis=False,
                                      traversal="xla")
    img = np.asarray(integrator.render(sc, dbvh, cam, spp=spp,
                                       sampler="halton", cfg=cfg))

    g = _downsample(golden16, 10)   # 10x10 blocks of the 400^2 golden
    o = _downsample(img, 10)        # 10x10 blocks of the 100^2 render

    # scene-average gate (reference integrators_test.cpp:55 idiom, relative
    # because the scene mean is ~2.26, not 1.0)
    rel = abs(o.mean() - g.mean()) / g.mean()
    assert rel < 0.05, (o.mean(), g.mean(), rel)

    # blockwise structural gate: most 40x40-px blocks agree within 15%
    # (4 spp blocks are noisy; the mean gate above carries the precision)
    denom = np.maximum(g.mean(-1), 0.05)
    blockrel = np.abs(o.mean(-1) - g.mean(-1)) / denom
    assert np.median(blockrel) < 0.10, np.median(blockrel)
    assert (blockrel < 0.35).mean() > 0.9, blockrel
