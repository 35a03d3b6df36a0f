"""Named spectra (metal eta/k, stdillum, .spd) + spectral conductor Fresnel.

Reference: util/spectrum.cpp GetNamedSpectrum (named tables at :2666-2800),
PiecewiseLinearSpectrum::FromInterleaved normalization (:158-160), and the
crown scene's `"spectrum eta" ["metal-Au-eta"]` usage.
"""

import numpy as np
import jax.numpy as jnp

from nn_bvh.core import named_spectra, spectrum as spec_mod
from nn_bvh.geometry import scene as scene_mod
from nn_bvh.scatter import bxdf


def test_named_spectra_inventory():
    ns = named_spectra.names()
    for want in ["metal-Au-eta", "metal-Au-k", "metal-Ag-eta", "metal-Cu-k",
                 "stdillum-A", "stdillum-D65", "glass-BK7", "illum-acesD60"]:
        assert want in ns, want
    # gold eta at 500nm is ~0.85-1.0 (Johnson & Christy); k ~1.8-2.0
    eta_500 = named_spectra.eval_at("metal-Au-eta", np.array([500.0]))[0]
    k_500 = named_spectra.eval_at("metal-Au-k", np.array([500.0]))[0]
    assert 0.7 < eta_500 < 1.2, eta_500
    assert 1.5 < k_500 < 2.3, k_500


def test_illuminant_normalized_to_luminance_one():
    lam, val = named_spectra.get("stdillum-D65")
    grid = np.arange(spec_mod.LAMBDA_MIN, spec_mod.LAMBDA_MAX + 1.0)
    v = np.interp(grid, lam, val, left=val[0], right=val[-1])
    inner = np.sum(v * spec_mod.cie_y(grid))
    assert abs(inner / spec_mod.CIE_Y_INTEGRAL - 1.0) < 1e-4


def test_spd_roundtrip(tmp_path):
    p = tmp_path / "test.spd"
    p.write_text("400 0.5\n500 1.0\n600 0.25\n")
    lam, val = named_spectra.read_spd(str(p))
    assert np.allclose(lam, [400, 500, 600])
    d = named_spectra.dense((lam, val))
    assert d.shape == (named_spectra.DENSE_N,)
    assert abs(d[int(450 - spec_mod.LAMBDA_MIN)] - 0.75) < 1e-5  # lerp
    assert abs(d[0] - 0.5) < 1e-5  # constant extension below 400


def test_spectral_gold_fresnel_matches_table():
    """Conductor with metal-Au-eta/k: normal-incidence Fresnel at each
    sampled wavelength matches R = ((eta-1)^2 + k^2)/((eta+1)^2 + k^2)
    computed directly from the reference's measured table."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("conductor", reflectance=(1, 1, 1), roughness=0.0,
                       eta_spectrum="metal-Au-eta", k_spectrum="metal-Au-k")
    b.add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), m)
    sc = b.build()
    assert sc.feat_spectral

    lam = jnp.asarray([[450.0, 550.0, 650.0, 750.0]])
    ctx = bxdf.gather_material(sc, jnp.asarray([m]), lam)
    assert ctx.eta_s is not None
    # wo at normal incidence
    wo = jnp.asarray([[0.0, 0.0, 1.0]])
    fr = np.asarray(bxdf.fr_complex(jnp.abs(wo[..., 2])[..., None],
                                    ctx.eta_s, ctx.k_s))[0]
    for i, l in enumerate([450.0, 550.0, 650.0, 750.0]):
        eta = named_spectra.eval_at("metal-Au-eta", np.array([l]))[0]
        k = named_spectra.eval_at("metal-Au-k", np.array([l]))[0]
        want = ((eta - 1) ** 2 + k ** 2) / ((eta + 1) ** 2 + k ** 2)
        assert abs(fr[i] - want) < 5e-3, (l, fr[i], want)
    # gold: red reflectance far above blue
    assert fr[2] > fr[0] * 1.5, fr


def test_parser_named_spectrum_conductor(tmp_path):
    """crown.pbrt-style `"spectrum eta" ["metal-Au-eta"]` parses into a
    spectral conductor; an unparameterized conductor defaults to copper
    (materials.cpp ConductorMaterial::Create)."""
    from nn_bvh.geometry import pbrt_parser

    scene = tmp_path / "gold.pbrt"
    scene.write_text("""
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "conductor"
    "spectrum eta" [ "metal-Au-eta" ]
    "spectrum k" [ "metal-Au-k" ]
    "float roughness" [0.1]
Shape "trianglemesh"
    "point3 P" [-1 0 -1  1 0 -1  1 0 1]
    "integer indices" [0 1 2]
Material "conductor" "float roughness" [0.2]
Shape "trianglemesh"
    "point3 P" [-1 0 -1  1 0 -1  1 0 1]
    "integer indices" [0 1 2]
""")
    res = pbrt_parser.parse_file(str(scene))
    sc = res.builder.build()
    assert sc.feat_spectral
    mp = np.asarray(sc.mat_params)
    # material 0: gold tables at indices 0/1
    assert mp[0, 10] >= 0 and mp[0, 11] >= 0
    # material 1: default copper tables (deduplicated registrations)
    assert mp[1, 10] >= 0 and mp[1, 11] >= 0
    gold_eta = np.asarray(sc.spec_tables)[int(mp[0, 10])]
    cu_eta = np.asarray(sc.spec_tables)[int(mp[1, 10])]
    assert not np.allclose(gold_eta, cu_eta)
    want = named_spectra.dense("metal-Au-eta")
    assert np.allclose(gold_eta, want)
