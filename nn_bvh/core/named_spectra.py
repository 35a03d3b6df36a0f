"""Named spectra: pbrt's GetNamedSpectrum + .spd file ingestion.

The reference ships measured spectral tables (metal eta/k, CIE standard
illuminants, glass dispersion, camera sensor responses) in
`util/spectrum.cpp` and resolves them by name via GetNamedSpectrum()
(util/spectrum.cpp:2582-2800); scenes reference them as
`"spectrum eta" ["metal-Au-eta"]` (scenes/crown/crown.pbrt) or as .spd
two-column files (scenes/killeroos/killeroo-gold.pbrt "spds/Au.eta.spd").

Here the tables live in `data/named_spectra.npz` (extracted by
tools/extract_named_spectra.py) as (N, 2) (wavelength_nm, value) pairs.
Illuminants flagged in __normalize__ are scaled to luminance 1 exactly like
PiecewiseLinearSpectrum::FromInterleaved(normalize=true)
(util/spectrum.cpp:158-160), using our analytic CIE-Y fit.

Device representation: spectra consumed at trace time (conductor eta/k) are
densified onto a 1-nm grid over [LAMBDA_MIN, LAMBDA_MAX] so a sampled
wavelength resolves with one gather + lerp — the gather-friendly analog of
pbrt's binary-search PiecewiseLinearSpectrum::operator() (spectrum.h:458).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from . import spectrum as spec_mod

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                     "named_spectra.npz")

# dense grid resolution (matches the CIE table density the reference uses)
DENSE_N = int(spec_mod.LAMBDA_MAX - spec_mod.LAMBDA_MIN) + 1  # 471 @ 1nm


@lru_cache(maxsize=1)
def _load() -> dict:
    z = np.load(_DATA, allow_pickle=False)
    normalize = set(str(s) for s in z["__normalize__"])
    out = {}
    for k in z.files:
        if k == "__normalize__":
            continue
        pairs = z[k].astype(np.float64)
        lam, val = pairs[:, 0], pairs[:, 1]
        if k in normalize:
            # scale to luminance 1: CIE_Y_integral / InnerProduct(spec, Y)
            grid = np.arange(spec_mod.LAMBDA_MIN, spec_mod.LAMBDA_MAX + 1.0)
            v = np.interp(grid, lam, val, left=val[0], right=val[-1])
            inner = float(np.sum(v * spec_mod.cie_y(grid)))
            val = val * (spec_mod.CIE_Y_INTEGRAL / max(inner, 1e-12))
        out[k] = (lam, val)
    return out


def names() -> list[str]:
    return sorted(_load().keys())


def has(name: str) -> bool:
    return name in _load()


def get(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(wavelengths_nm, values), normalized if the reference normalizes."""
    try:
        return _load()[name]
    except KeyError:
        raise KeyError(
            f"unknown named spectrum {name!r}; known: {names()[:8]}...")


def read_spd(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Two-column .spd file: wavelength_nm value per line (killeroo-gold
    spds/*.spd; reference reads these via ReadFloatFile + PiecewiseLinear)."""
    lam, val = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            lam.append(float(parts[0]))
            val.append(float(parts[1]))
    lam = np.asarray(lam, np.float64)
    val = np.asarray(val, np.float64)
    order = np.argsort(lam)
    return lam[order], val[order]


def dense(name_or_pairs) -> np.ndarray:
    """Resample a named spectrum (str), .spd path, or (lam, val) pair onto
    the 1-nm device grid -> (DENSE_N,) float32. Constant-extends beyond the
    measured range, like FromInterleaved (spectrum.cpp:140-152)."""
    if isinstance(name_or_pairs, str):
        if name_or_pairs.endswith(".spd") or os.path.sep in name_or_pairs:
            lam, val = read_spd(name_or_pairs)
        else:
            lam, val = get(name_or_pairs)
    else:
        lam, val = name_or_pairs
    grid = np.arange(spec_mod.LAMBDA_MIN, spec_mod.LAMBDA_MAX + 1.0)
    return np.interp(grid, lam, val, left=val[0], right=val[-1]).astype(
        np.float32)


def eval_at(name_or_pairs, lam_nm: np.ndarray) -> np.ndarray:
    """Piecewise-linear evaluation at arbitrary wavelengths (host-side;
    used by tests and by PixelSensor construction)."""
    if isinstance(name_or_pairs, str):
        l, v = get(name_or_pairs)
    else:
        l, v = name_or_pairs
    return np.interp(lam_nm, l, v, left=v[0], right=v[-1])
