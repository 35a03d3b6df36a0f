"""Crown north-star gate: our volpath render vs the pbrt-v4 CPU golden.

BASELINE.json's north star asks for crown @64spp allclose to the reference
CPU binary (scenes/crown/crown.pbrt:3-19, reduced to 250x350@64spp for the
2-core refbuild render — see tools/refbuild/crown_golden.py and BASELINE.md).

Two layers:
1. Artifact parity (always runs): data/golden/crown-ours-volpath-250x350-64spp.exr
   is the render produced by THIS repo (tools/crown_gate.py);
   CI gates it against the pbrt golden blockwise. A regression that changes
   the committed artifact (or a stale artifact after a renderer change) is
   caught by re-rendering with tools/crown_gate.py before release.
2. Live render parity (opt-in, NN_BVH_RUN_CROWN=1): parses + renders crown
   in-process at reduced spp and applies the same gate. Hours on CPU —
   meant for the GPU.
"""

import os

import numpy as np
import pytest

from nn_bvh.utils import exr

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden")
PBRT_GOLDEN = os.path.join(GOLDEN, "crown-volpath-250x350-64spp.exr")
OURS = os.path.join(GOLDEN, "crown-ours-volpath-250x350-64spp.exr")


def _downsample(im: np.ndarray, nbh: int, nbw: int) -> np.ndarray:
    h, w, _ = im.shape
    bh, bw = h // nbh, w // nbw
    return im[:nbh * bh, :nbw * bw].reshape(nbh, bh, nbw, bw, 3).mean((1, 3))


def _gate(ours: np.ndarray, golden: np.ndarray):
    """Scene-mean + blockwise structural gate (integrators_test.cpp:50-65
    idiom, relative tolerances; crown is mostly dark with bright jewels so
    block denominators are floored)."""
    assert ours.shape == golden.shape, (ours.shape, golden.shape)
    g = _downsample(golden, 10, 7)
    o = _downsample(ours, 10, 7)
    rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
    assert rel < 0.05, f"scene mean off by {rel:.3%} (ours {o.mean():.4f} vs pbrt {g.mean():.4f})"
    denom = np.maximum(g.mean(-1), 0.05 * g.mean())
    blockrel = np.abs(o.mean(-1) - g.mean(-1)) / denom
    assert np.median(blockrel) < 0.10, f"block median {np.median(blockrel):.3%}"
    assert (blockrel < 0.35).mean() > 0.85, \
        f"only {(blockrel < 0.35).mean():.1%} of blocks within 35%"


def test_crown_pbrt_golden_reads():
    g = exr.read_rgb(PBRT_GOLDEN)
    assert g.shape == (350, 250, 3)
    assert np.isfinite(g).all()
    assert g.mean() > 0


@pytest.mark.skipif(not os.path.exists(OURS),
                    reason="crown-ours artifact not rendered yet "
                           "(run tools/crown_gate.py on the GPU)")
def test_crown_artifact_structure():
    """Structural parity (round-4 artifact: block median 3.8%, backdrop
    within 5%). Kept alongside the strict gate below as a finer-grained
    regression signal."""
    ours = exr.read_rgb(OURS)
    gold = exr.read_rgb(PBRT_GOLDEN)
    g = _downsample(gold, 14, 10)
    o = _downsample(ours, 14, 10)
    denom = np.maximum(g.mean(-1), 0.05 * g.mean())
    blockrel = np.abs(o.mean(-1) - g.mean(-1)) / denom
    assert np.median(blockrel) < 0.10, np.median(blockrel)
    # the neutral backdrop (border blocks) must be photometrically exact
    border = np.concatenate([blockrel[0], blockrel[1], blockrel[:, 0],
                             blockrel[:, -1]])
    assert np.median(border) < 0.05, np.median(border)


@pytest.mark.skipif(not os.path.exists(OURS),
                    reason="crown-ours artifact not rendered yet")
def test_crown_artifact_parity():
    """North-star STRICT gate (BASELINE.json): crown 64spp vs the pbrt-v4
    CPU golden. PASSING since round 4: the stochastic LayeredBxDF
    (scatter/layered.py) + native-res mip textures (geometry/texture.py)
    closed the r3 +16.7% scene-mean gap to +1.9% (block median 3.8%,
    p90 11.8%). Artifact rendered by tools/crown_gate.py."""
    _gate(exr.read_rgb(OURS), exr.read_rgb(PBRT_GOLDEN))


@pytest.mark.skipif(os.environ.get("NN_BVH_RUN_CROWN") != "1",
                    reason="live crown render is accelerator-scale work "
                           "(set NN_BVH_RUN_CROWN=1)")
def test_crown_live_parity():
    from nn_bvh.geometry import pbrt_parser
    from nn_bvh.wavefront import integrator

    scene_file = "/tmp/crown_golden/crown_golden.pbrt"
    assert os.path.exists(scene_file), \
        "stage first: python tools/refbuild/crown_golden.py"
    sc, dbvh, cam, opts = pbrt_parser.load_scene(scene_file)
    cfg = integrator.IntegratorConfig(
        max_depth=int(opts.get("maxdepth", 100)), mis=True, kind="volpath")
    img = np.asarray(integrator.render(sc, dbvh, cam, spp=64,
                                       sampler="halton", cfg=cfg))
    _gate(img, exr.read_rgb(PBRT_GOLDEN))
