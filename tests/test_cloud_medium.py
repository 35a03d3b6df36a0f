"""CloudMedium (media.h:430): procedural noise density baked to a grid at
scene compile, traversed with the standard grid-medium DDA majorants.
Also covers the pbrt-v4 `Material ""` -> medium-interface semantics fix."""

import os
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest

from nn_bvh.utils import noise
from nn_bvh.geometry import pbrt_parser
from nn_bvh.wavefront import integrator

pytestmark = pytest.mark.slow

_TPL = """
LookAt 0 0.5 -3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Integrator "volpath" "integer maxdepth" [6]
WorldBegin
MakeNamedMedium "puff" MEDIUM
AttributeBegin
  Material ""
  MediumInterface "puff" ""
  Shape "trianglemesh" "point3 P" [-1 -0.5 -1  1 -0.5 -1  1 1.5 -1  -1 1.5 -1  -1 -0.5 1  1 -0.5 1  1 1.5 1  -1 1.5 1]
    "integer indices" [0 2 1 0 3 2  4 5 6 4 6 7  0 5 4 0 1 5  3 6 2 3 7 6  0 7 3 0 4 7  1 6 5 1 2 6]
AttributeEnd
AttributeBegin
  Translate 0 2.5 0
  AreaLightSource "diffuse" "rgb L" [10 10 10] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1] "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def _render(med: str) -> float:
    src = _TPL.replace("MEDIUM", med)
    with tempfile.NamedTemporaryFile("w", suffix=".pbrt", delete=False) as f:
        f.write(src)
        path = f.name
    try:
        sc, dbvh, cam, res = pbrt_parser.load_scene(path)
    finally:
        os.unlink(path)
    assert sc.n_media == 1
    img = integrator.render(
        sc, dbvh, cam, spp=4,
        cfg=integrator.IntegratorConfig(max_depth=6, kind="volpath",
                                        compact=False))
    return float(jnp.mean(img))


def test_cloud_density_field():
    g = noise.cloud_density_grid(res=32)
    assert g.shape == (32, 32, 32)
    assert 0.0 <= g.min() and g.max() <= 1.0
    # altitude falloff: lower half (the +2*max(0,0.5-y) term) is denser
    assert g[:, :8].mean() > g[:, -8:].mean()
    # wispiness perturbs the field
    g2 = noise.cloud_density_grid(res=32, wispiness=0.0)
    assert np.abs(g - g2).max() > 1e-3


def test_cloud_scene_renders_through_volpath():
    m_cloud = _render(
        '"string type" "cloud" "float density" [1.0] '
        '"rgb sigma_s" [1.5 1.5 1.5] "rgb sigma_a" [0.05 0.05 0.05] '
        '"point3 p0" [-1 -0.5 -1] "point3 p1" [1 1.5 1]')
    m_homog = _render(
        '"string type" "homogeneous" '
        '"rgb sigma_s" [1.5 1.5 1.5] "rgb sigma_a" [0.05 0.05 0.05]')
    assert np.isfinite(m_cloud) and m_cloud > 0.01
    # procedural density < 1 everywhere => scatters less than the
    # unit-density homogeneous medium, but not absurdly so
    assert 0.1 * m_homog < m_cloud < m_homog
