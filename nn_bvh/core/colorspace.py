"""Color spaces and sensor white balance.

Counterpart of `util/color.h` / `util/colorspace.h` (RGBColorSpace) and the
white-balancing role of `PixelSensor` (film.h:36). We carry sRGB primaries;
other spaces can be added as 3x3 matrices.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import spectrum

Array = jax.Array

# Standard sRGB (D65) matrices — public colorimetry constants.
XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB).astype(np.float32)

SRGB_WHITE_XYZ = SRGB_TO_XYZ @ np.ones(3, np.float32)  # D65 whitepoint, Y=1

# Bradford chromatic adaptation matrix (von Kries in sharpened LMS space),
# as used by the reference's WhiteBalance (colorspace/white balance).
_BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ],
    np.float32,
)
_BRADFORD_INV = np.linalg.inv(_BRADFORD).astype(np.float32)


def white_balance_matrix(src_white_xyz: np.ndarray, dst_white_xyz: np.ndarray) -> np.ndarray:
    """XYZ->XYZ chromatic adaptation from src whitepoint to dst whitepoint."""
    lms_src = _BRADFORD @ np.asarray(src_white_xyz, np.float32)
    lms_dst = _BRADFORD @ np.asarray(dst_white_xyz, np.float32)
    d = np.diag(lms_dst / lms_src).astype(np.float32)
    return (_BRADFORD_INV @ d @ _BRADFORD).astype(np.float32)


# Sensor matrix: adapt from the render illuminant's whitepoint to sRGB white,
# then to linear sRGB. With this, an albedo-1 surface lit to radiance = the
# normalized std illuminant integrates to RGB (1,1,1) (the PixelSensor
# 'imaging ratio' contract, film.h:36).
_WB = white_balance_matrix(spectrum.illuminant_whitepoint_xyz(), SRGB_WHITE_XYZ)
SENSOR_XYZ_TO_SRGB = (XYZ_TO_SRGB @ _WB).astype(np.float32)


def _rgb_space(rx, ry, gx, gy, bx, by, wx, wy):
    """RGB->XYZ matrix from chromaticity primaries + whitepoint
    (RGBColorSpace ctor, util/colorspace.cpp)."""
    def xyz(x, y):
        return np.array([x / y, 1.0, (1 - x - y) / y], np.float32)

    m = np.stack([xyz(rx, ry), xyz(gx, gy), xyz(bx, by)], axis=1)
    w = xyz(wx, wy)
    s = np.linalg.solve(m, w)
    return (m * s[None, :]).astype(np.float32)


# The reference's four color spaces (util/colorspace.cpp: sRGB, DCI-P3,
# Rec2020, ACES2065-1) as RGB->XYZ matrices; published chromaticities.
RGB_TO_XYZ = {
    "srgb": _rgb_space(0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    "dci-p3": _rgb_space(0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    "rec2020": _rgb_space(0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    "aces2065-1": _rgb_space(0.7347, 0.2653, 0.0000, 1.0000, 0.0001, -0.0770,
                             0.32168, 0.33767),
}
XYZ_TO_RGB = {k: np.linalg.inv(v).astype(np.float32) for k, v in RGB_TO_XYZ.items()}


def xyz_to_linear_srgb(xyz: Array, white_balance: bool = True) -> Array:
    m = jnp.asarray(SENSOR_XYZ_TO_SRGB if white_balance else XYZ_TO_SRGB)
    # HIGHEST: float32 products (a GPU's default may use TF32, ~3 digits)
    return jnp.einsum("ij,...j->...i", m, xyz,
                      precision=jax.lax.Precision.HIGHEST)


def linear_srgb_to_xyz(rgb: Array) -> Array:
    return jnp.einsum("ij,...j->...i", jnp.asarray(SRGB_TO_XYZ), rgb,
                      precision=jax.lax.Precision.HIGHEST)


def srgb_encode(rgb: Array) -> Array:
    """Linear -> sRGB gamma (util/color.h SRGBToLinear inverse)."""
    rgb = jnp.clip(rgb, 0.0, 1.0)
    return jnp.where(
        rgb <= 0.0031308, 12.92 * rgb, 1.055 * jnp.power(rgb, 1.0 / 2.4) - 0.055
    )


def srgb_decode(srgb: Array) -> Array:
    return jnp.where(
        srgb <= 0.04045, srgb / 12.92, jnp.power((srgb + 0.055) / 1.055, 2.4)
    )


def luminance(rgb: Array) -> Array:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
