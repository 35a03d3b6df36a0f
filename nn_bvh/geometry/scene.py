"""Scene compilation: host-side builder -> frozen SoA device buffers.

This is the analog of the reference's scene pipeline
(`BasicSceneBuilder` -> `BasicScene` -> per-backend object creation,
scene.h:260-382 + cpu/render.cpp:24-56): instead of building trees of
polymorphic objects, we flatten everything at build time into dense SoA jnp
arrays — triangles in render space, integer material/light ids per primitive,
tagged material and light parameter tables. Polymorphic dispatch becomes
integer tags + masked lane selects (the reference's TaggedPointer::Dispatch,
util/taggedptr.h:361, resolved per lane instead of per call).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rgb2spec
from . import transform as xf

Array = jax.Array

# material type tags (base/material.h:35 tag list analog)
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_DIELECTRIC = 2
MAT_THIN_DIELECTRIC = 3
MAT_DIFFUSE_TRANSMISSION = 4
MAT_COATED_DIFFUSE = 5
MAT_COATED_CONDUCTOR = 6
MAT_MIX = 7
MAT_HAIR = 8
MAT_MEASURED = 9
MAT_SUBSURFACE = 10     # SubsurfaceMaterial (materials.h:696): smooth
#   dielectric entry interface + TabulatedBSSRDF transport (scatter/bssrdf.py)
MAT_SSS_EXIT = 11       # virtual: NormalizedFresnel exit lobe, set per-lane
#   by the integrator after a successful probe (never appears in mat_type)
MAT_INTERFACE = -1  # no material (pass-through)

# light type tags (base/light.h:40 analog)
LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_UNIFORM_INFINITE = 2
LIGHT_AREA_TRI = 3
LIGHT_IMAGE_INFINITE = 4
LIGHT_SPOT = 5
LIGHT_PROJECTION = 6
LIGHT_GONIOMETRIC = 7
LIGHT_PORTAL_ENV = 8
# One analytic sphere area light per emissive sphere SHAPE (the reference's
# DiffuseAreaLight over Sphere, lights.h + shapes.h:280 Sphere::Sample cone
# sampling). The sphere geometry is still tessellated for visibility, but
# light sampling/pdf use the analytic center+radius — one light per shape,
# not one per tessellation triangle (pbrt killeroo-simple: "AreaLights 1").
LIGHT_SPHERE_AREA = 9

# light_params layout by type (see scatter.lights.sample_li):
#   AREA_TRI:    [0]=tri_index [1]=two_sided
#   SPOT:        [0:3]=direction [3]=cos_total_width [4]=cos_falloff_start
#   PROJECTION:  [0:3]=direction [3]=tan_half_x [4]=tan_half_y [5]=tex_id
#                [6:9]=up vector
#   GONIOMETRIC: [5]=tex_id (equal-area octahedral intensity map)
#   PORTAL_ENV:  [0:12]=portal quad corners p0 p1 p2 p3 (world space)

N_MAT_PARAMS = 12  # [rough_u, rough_v, eta, k, transmittance, texture,
#  mix_a, mix_b, mix_amount, coat_roughness, eta_tab, k_tab]
N_LIGHT_PARAMS = 12

# texture kinds (base/texture.h tag list analog; evaluated per lane)
TEX_NONE = -1
TEX_IMAGE = 0
TEX_CHECKER = 1
TEX_UV_SCALE = 2  # reserved

# media (base/medium.h:76 tag list; Cloud/NanoVDB are host-converted to grids)
MED_NONE = -1
MED_HOMOGENEOUS = 0
MED_GRID = 1
MED_GRID_RES = 64  # density grids resampled to a fixed-size stack (like TEX_RES)
MAJ_GRID_RES = 16  # low-res conservative majorant grid (MajorantGrid, media.h)

TEX_RES = 256  # bake resolution for ANALYTIC textures (checker/procedural);
# image textures keep native resolution in the mip atlas (geometry/texture.py)


class CompiledScene(NamedTuple):
    """Frozen device-side scene. All arrays are SoA jnp arrays.

    Triangle counts are padded to a multiple of 128 (lane width) with
    degenerate all-zero triangles, which the watertight intersector rejects
    (det == 0).
    """

    # geometry
    tri_p: Array        # (N, 3, 3) vertex positions, render space
    tri_n: Array        # (N, 3, 3) shading normals (geometric if none given)
    tri_uv: Array       # (N, 3, 2)
    tri_mat: Array      # (N,) i32 material id (-1 = interface/none)
    tri_light: Array    # (N,) i32 area-light id (-1 = not emissive)
    n_tris: int         # actual (unpadded) triangle count — static

    # materials (tagged SoA table)
    mat_type: Array     # (M,) i32
    mat_coeffs: Array   # (M, 3) sigmoid-poly coefficients of base color
    mat_scale: Array    # (M,)
    mat_params: Array   # (M, N_MAT_PARAMS) [rough_u, rough_v, eta, k,
    #   transmittance, texture, mix_a, mix_b, mix_amount, coat_roughness,
    #   eta_tab, k_tab] — eta_tab/k_tab index spec_tables (-1 = scalar)

    # lights (tagged SoA table)
    light_type: Array   # (L,) i32
    light_pos: Array    # (L, 3) position / direction
    light_coeffs: Array  # (L, 3) sigmoid-poly of emission chroma
    light_scale: Array  # (L,) photometric scale on normalized illuminant
    light_params: Array  # (L, N_LIGHT_PARAMS) [tri_index, twosided, ...]
    n_lights: int

    # scene bounds (2,3)
    bounds: Array

    # textures: flat mip atlas of spectral-coefficient texels. Each texel
    # holds [c0, c1, c2, scale] (sigmoid-polynomial uplift precomputed on host
    # per texel — the device-side analog of pbrt's RGBToSpectrumTable lookup,
    # without the 8-gather trilinear table walk). Native resolution + box mip
    # pyramids packed by geometry/texture.pack_atlas (util/mipmap.h analog).
    tex_atlas: Array = None   # (Ntexels, 4) flat coefficient atlas
    tex_desc: Array = None    # (T, LMAX, 3) i32 [offset, width, height]
    # measured BRDFs (MeasuredBxDF analog, scatter/measured.py): a stack of
    # (mu_o, mu_i, dphi) tables of spectral-uplift coefficients.
    # (T, No, Ni, Np, 4); the 1-entry zero table means "none".
    measured_coeffs: Array = None
    measured_alpha: Array = None  # (T,) fitted GGX proxy-sampler roughness
    # env map (ImageInfiniteLight, equal-area octahedral like the reference):
    # (He, We, 4) coefficient image + luminance distribution tables
    env_coeffs: Array = None
    env_cond_cdf: Array = None   # (He, We+1)
    env_marg_cdf: Array = None   # (He+1,)
    env_marg_func: Array = None  # (He,)
    env_luminance: Array = None  # (He, We) sampling function
    # portal image warp (PortalImageInfiniteLight, lights.h:631;
    # scatter/portal.py): rectified env image + SAT over the sampling
    # density + portal frame rows (x, y, z)
    portal_img_coeffs: Array = None  # (Rp, Rp, 4)
    portal_sat: Array = None         # (Rp+1, Rp+1)
    portal_frame: Array = None       # (3, 3)

    # fused per-triangle shading record (N, 28), built after BVH reorder:
    # [v0 v1 v2 (9) | n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat_id | light_id |
    #  med_inside | med_outside].
    # One gather serves the whole shading stage — gathers are
    # latency-bound and width-insensitive, so fusing
    # 5 table gathers into 1 is a ~4x win on the hit-shading stage.
    tri_shade: Array = None

    # participating media (tagged SoA table; base/medium.h Homogeneous/Grid —
    # RGBGrid/Cloud/NanoVDB become density grids at scene-build time).
    # med_rec fused at trace time by scatter.media.medium_records:
    med_type: Array = None        # (K,) i32
    med_sa_coeffs: Array = None   # (K,3) sigma_a sigmoid-poly chroma
    med_ss_coeffs: Array = None   # (K,3) sigma_s
    med_le_coeffs: Array = None   # (K,3) emission chroma
    med_scales: Array = None      # (K,4) [sigma_a_scale, sigma_s_scale, le_scale, g]
    med_grid_id: Array = None     # (K,) i32 index into med_grids (-1 = none)
    med_max_density: Array = None  # (K,) majorant density (1 for homogeneous)
    med_bounds: Array = None      # (K,2,3) world AABB of the density grid
    med_grids: Array = None       # (G, D, H, W) density stack
    med_temp_grids: Array = None  # (G2, D, H, W) Kelvin temperature stack
    med_temp_grid_id: Array = None  # (K,) i32 index (-1 = RGB Le)
    # conservative low-res majorant grids, one per density grid: supervoxel
    # max with 1-fine-voxel dilation so it bounds the trilinear field
    # everywhere inside the supervoxel (MajorantGrid, media.h:100; fed to the
    # per-lane DDA in volpath). (G, MAJ, MAJ, MAJ).
    med_maj_grids: Array = None
    n_media: int = 0
    # medium the camera sits in (pbrt: camera "medium" directive) — static
    camera_medium: int = -1
    # per-triangle medium interface (MediumInterface, primitive.h): the medium
    # on the side the geometric normal points away from (inside) / toward
    # (outside). Folded into tri_shade cols 26/27 for the fused gather.
    # object motion blur (AnimatedPrimitive analog, cpu/primitive.h:33 /
    # transform.h:444): shutter-end copies of the vertex tables. None for
    # static scenes. The renderer lerps tables per WAVE at a stratified
    # shutter time (static columns use a + t*(b-a), exact when b == a),
    # and the BVH is built over the UNION of both keyframes' prim bounds
    # so one tree is conservative for every t.
    tri_p_end: Array = None        # (N,3,3) f32 or None
    tri_n_end: Array = None        # (N,3,3) f32 or None
    tri_shade_end: Array = None    # like tri_shade or None
    tri_med_inside: Array = None   # (N,) i32
    tri_med_outside: Array = None  # (N,) i32

    # named-spectrum tables (S, 471): each row a spectrum densified onto the
    # 1-nm grid over [360, 830] nm (core/named_spectra.dense) — the device
    # analog of pbrt's PiecewiseLinearSpectrum named spectra
    # (util/spectrum.cpp GetNamedSpectrum); consumed by spectral conductor
    # Fresnel via one gather + lerp per sampled wavelength.
    spec_tables: Array = None

    # subsurface materials (TabulatedBSSRDF, scatter/bssrdf.py): per-material
    # RGB sigma chroma (sigmoid-poly coeffs) + scales + g, and the
    # photon-beam-diffusion tables stacked per material (each built with
    # that material's g/eta at scene compile). mat_params[3] holds the
    # per-material sss row id for MAT_SUBSURFACE rows.
    sss_coeffs_a: Array = None   # (S,3)
    sss_scale_a: Array = None    # (S,)
    sss_coeffs_s: Array = None   # (S,3)
    sss_scale_s: Array = None    # (S,)
    sss_g: Array = None          # (S,)
    sss_profile: Array = None    # (S, 64, 64) r*Sr (unit sigma_t)
    sss_cdf: Array = None        # (S, 64, 64)
    sss_rho_eff: Array = None    # (S, 64)
    sss_radius: Array = None     # (64,)
    sss_rho: Array = None        # (64,)

    # analytic quadrics (geometry/quadrics.py; shapes.h Sphere/Disk/
    # Cylinder). Their prim ids live above the padded triangle range and
    # their mat/light/medium columns ride in tri_shade's appended rows.
    quad_type: Array = None     # (Q,) i32
    quad_params: Array = None   # (Q, 13) world-frame records
    quad_uv_scale: Array = None  # (Q,) ray-cone LOD scale
    quad_mat: Array = None      # (Q,) i32
    quad_light: Array = None    # (Q,) i32
    quad_med: Array = None      # (Q, 2) i32 [inside, outside]
    n_quadrics: int = 0         # static

    # static feature gates, computed at build time. They must be STATIC
    # (not traced): the scene is threaded through jit as an ARGUMENT, so
    # inspecting mat_type inside a traced function is impossible — these
    # flags decide which material branches get traced at all (the analog of
    # pbrt's per-material-type wavefront kernel specialization,
    # wavefront/surfscatter.cpp:39).
    feat_mix: bool = False
    feat_hair: bool = False
    feat_measured: bool = False
    feat_portal: bool = False
    # any material with a named-spectrum eta/k table (gates the spectral
    # Fresnel gathers in bxdf.gather_material)
    feat_spectral: bool = False
    feat_subsurface: bool = False
    # any coated material (gates the stochastic LayeredBxDF walk in
    # scatter/layered.py — the walk is priced only when present)
    feat_coated: bool = False

    def replace(self, **kw):
        return self._replace(**kw)


def make_tri_shade(scene: "CompiledScene", use_end: bool = False) -> np.ndarray:
    tp = np.asarray(scene.tri_p_end if use_end else scene.tri_p, np.float32)
    tn = np.asarray(scene.tri_n_end if use_end else scene.tri_n, np.float32)
    tu = np.asarray(scene.tri_uv, np.float32)
    n = len(tp)
    nq = int(scene.n_quadrics or 0)
    out = np.zeros((n + nq, 28), np.float32)
    out[:n, 0:9] = tp.reshape(n, 9)
    out[:n, 9:18] = tn.reshape(n, 9)
    out[:n, 18:24] = tu.reshape(n, 6)
    out[:n, 24] = np.asarray(scene.tri_mat, np.float32)
    out[:n, 25] = np.asarray(scene.tri_light, np.float32)
    if scene.tri_med_inside is not None:
        out[:n, 26] = np.asarray(scene.tri_med_inside, np.float32)
        out[:n, 27] = np.asarray(scene.tri_med_outside, np.float32)
    else:
        out[:n, 26:28] = -1.0
    if nq:
        # appended quadric rows: only the material/light/medium columns are
        # meaningful (positions/normals/uv are computed analytically by
        # integrator._shading_point; geometry/quadrics.py)
        out[n:, 24] = np.asarray(scene.quad_mat, np.float32)
        out[n:, 25] = np.asarray(scene.quad_light, np.float32)
        out[n:, 26:28] = np.asarray(scene.quad_med, np.float32)
    return out


def majorant_grid(dens: np.ndarray, res: int = MAJ_GRID_RES) -> np.ndarray:
    """Conservative low-res majorant of a density grid (MajorantGrid,
    media.h:100): supervoxel max over the covered fine voxels, dilated by one
    fine voxel on every side so the TRILINEAR density field (which reads
    neighbor samples) is bounded everywhere inside the supervoxel."""
    d = np.asarray(dens, np.float32)
    D, H, W = d.shape
    pad = np.pad(d, 1, mode="edge")
    out = np.zeros((res, res, res), np.float32)
    zb = [int(np.floor(i * D / res)) for i in range(res + 1)]
    yb = [int(np.floor(i * H / res)) for i in range(res + 1)]
    xb = [int(np.floor(i * W / res)) for i in range(res + 1)]
    for z in range(res):
        for y in range(res):
            for x in range(res):
                out[z, y, x] = pad[zb[z]:zb[z + 1] + 2,
                                   yb[y]:yb[y + 1] + 2,
                                   xb[x]:xb[x + 1] + 2].max()
    return out


# static counts must not trace under jit/shard_map
from ..utils.pytree import register_static as _register_static  # noqa: E402

_register_static(CompiledScene, ("n_tris", "n_lights", "n_media", "camera_medium",
                                 "n_quadrics",
                                 "feat_mix", "feat_hair", "feat_measured",
                                 "feat_portal", "feat_spectral",
                                 "feat_subsurface", "feat_coated"))


@dataclass
class SceneBuilder:
    """Accumulates meshes/materials/lights on host, then compiles.

    The graphics-state conveniences of the reference's BasicSceneBuilder
    (CTM stack, AttributeBegin/End) live in the pbrt parser front end; this
    class is the flat "SceneEntity" sink (scene.h:35-195 analog).
    """

    _tri_p: list = field(default_factory=list)
    _tri_n: list = field(default_factory=list)
    _tri_uv: list = field(default_factory=list)
    _tri_mat: list = field(default_factory=list)
    _tri_emit: list = field(default_factory=list)  # (rgb, scale, twosided) or None per mesh
    _tri_med: list = field(default_factory=list)    # (med_inside, med_outside) per mesh
    _tri_pe: list = field(default_factory=list)     # motion: end verts (F,3,3) or None
    _tri_ne: list = field(default_factory=list)     # motion: end normals or None
    _materials: list = field(default_factory=list)
    _sss: list = field(default_factory=list)
    _lights: list = field(default_factory=list)
    _textures: list = field(default_factory=list)   # native-res (H,W,3) rgb
    _quadrics: list = field(default_factory=list)   # analytic quadric dicts
    _measured: list = field(default_factory=list)   # (No,Ni,Np,3) rgb tables
    _media: list = field(default_factory=list)
    _spec_tables: list = field(default_factory=list)  # (471,) dense spectra
    _spec_names: dict = field(default_factory=dict)   # name -> table index
    _camera_medium: int = -1
    _env_image: "np.ndarray | None" = None          # (He,We,3) equal-area rgb
    _env_scale: float = 1.0

    # ---- materials -------------------------------------------------------

    def add_measured_brdf(self, table_rgb: np.ndarray) -> int:
        """Register a measured/tabulated BRDF (MeasuredBxDF analog): an
        (No, Ni, Np, 3) RGB grid over (mu_o, mu_i, dphi) — see
        scatter/measured.py tabulate()/load_table(). Returns the id for
        add_material(kind="measured", measured=id). All tables in one scene
        must share a resolution (they are stacked into one device array)."""
        self._measured.append(np.asarray(table_rgb, np.float32))
        return len(self._measured) - 1

    def add_texture_image(self, rgb_image: np.ndarray) -> int:
        """Register an RGB image texture at NATIVE resolution (mip pyramid
        built at compile, geometry/texture.py). Returns texture id for
        add_material(texture=...)."""
        self._textures.append(np.asarray(rgb_image, np.float32))
        return len(self._textures) - 1

    def add_texture_checker(self, rgb1=(0.1, 0.1, 0.1), rgb2=(0.9, 0.9, 0.9),
                            uscale: float = 8.0) -> int:
        """Checkerboard baked into an image texture (CheckerboardTexture
        analog; frequency via uscale squares per uv unit)."""
        t = (np.arange(TEX_RES) * uscale / TEX_RES).astype(np.int64)
        par = (t[:, None] + t[None, :]) % 2
        img = np.where(par[..., None] > 0, np.asarray(rgb2, np.float32),
                       np.asarray(rgb1, np.float32))
        self._textures.append(img.astype(np.float32))
        return len(self._textures) - 1

    def add_texture_procedural(self, kind: str, scale: float = 8.0,
                               octaves: int = 6, omega: float = 0.5,
                               seed: int = 0, rgb1=(0.12, 0.1, 0.08),
                               rgb2=(0.9, 0.88, 0.82)) -> int:
        """Procedural texture (FBm/Wrinkled/Windy/Marble/Dots, textures.h)
        baked over uv space at scene-build time (utils.noise.bake)."""
        from ..utils import noise

        img = noise.bake(kind, res=TEX_RES, scale=scale, octaves=octaves,
                         omega=omega, seed=seed, rgb1=rgb1, rgb2=rgb2)
        self._textures.append(img)
        return len(self._textures) - 1

    def set_environment_map(self, equal_area_rgb: np.ndarray, scale: float = 1.0) -> int:
        """ImageInfiniteLight (lights.h): equal-area octahedral radiance map."""
        self._env_image = np.asarray(equal_area_rgb, np.float32)
        self._env_scale = float(scale)
        self._lights.append(
            dict(type=LIGHT_IMAGE_INFINITE, pos=np.zeros(3, np.float32),
                 rgb=np.ones(3, np.float32), scale=scale,
                 params=np.zeros(N_LIGHT_PARAMS, np.float32))
        )
        return len(self._lights) - 1

    def add_material(
        self,
        kind: str = "diffuse",
        reflectance=(0.5, 0.5, 0.5),
        roughness: float = 0.0,
        eta: float | None = None,
        k: float = 3.9,
        transmittance: float = 0.0,
        texture: int = -1,
        coat_roughness: float = 0.0,
        mix_materials: tuple = (-1, -1),
        mix_amount: float = 0.5,
        beta_n: float | None = None,
        measured: int = -1,
        eta_spectrum=None,
        k_spectrum=None,
        sigma_a=(0.0011, 0.0024, 0.014),
        sigma_s=(2.55, 3.21, 3.77),
        sss_scale: float = 1.0,
        g: float = 0.0,
    ) -> int:
        """Material factory (base/material.h tag list). coateddiffuse /
        coatedconductor carry a dielectric coat (eta, coat_roughness) over the
        base lobe; mix stochastically selects mix_materials[0] with
        probability mix_amount per intersection (MixMaterial semantics).
        For kind="hair" (HairMaterial, materials.h): roughness = beta_m
        (longitudinal), beta_n = azimuthal roughness (defaults to beta_m),
        eta should be ~1.55; reflectance sets sigma_a via the Chiang
        inversion at shading time."""
        kinds = {
            "diffuse": MAT_DIFFUSE,
            "conductor": MAT_CONDUCTOR,
            "dielectric": MAT_DIELECTRIC,
            "thindielectric": MAT_THIN_DIELECTRIC,
            "diffusetransmission": MAT_DIFFUSE_TRANSMISSION,
            "coateddiffuse": MAT_COATED_DIFFUSE,
            "coatedconductor": MAT_COATED_CONDUCTOR,
            "mix": MAT_MIX,
            "hair": MAT_HAIR,
            "measured": MAT_MEASURED,
            "subsurface": MAT_SUBSURFACE,
        }
        # eta=None sentinel: per-kind default (1.33 for subsurface per the
        # reference's SubsurfaceMaterial, 1.5 dielectric otherwise) — an
        # explicit eta=1.5 on subsurface is honored (ADVICE r3).
        if eta is None:
            eta = 1.33 if kind == "subsurface" else 1.5
        if kind == "subsurface":
            # sss row id rides in the k slot (params[3])
            k = float(len(self._sss))
            self._sss.append(dict(
                sigma_a=np.asarray(sigma_a, np.float32),
                sigma_s=np.asarray(sigma_s, np.float32),
                scale=float(sss_scale), g=float(g), eta=float(eta)))
        if kind == "measured":
            # measured table id rides in the (unused) k slot, params[3]
            k = float(measured)
        # named/measured spectral eta & k (conductors; util/spectrum.cpp
        # GetNamedSpectrum + scene "spectrum eta" ["metal-Au-eta"]): densify
        # onto the 1-nm grid and index via params[10]/params[11]
        eta_tab = k_tab = -1.0
        if eta_spectrum is not None:
            eta_tab = float(self.add_spectrum_table(eta_spectrum))
            eta = float(np.median(self._spec_tables[int(eta_tab)]))
        if k_spectrum is not None:
            k_tab = float(self.add_spectrum_table(k_spectrum))
            k = float(np.median(self._spec_tables[int(k_tab)]))
        second_rough = roughness if beta_n is None else beta_n
        self._materials.append(
            dict(
                type=kinds[kind],
                reflectance=np.asarray(reflectance, np.float32),
                params=np.array(
                    [roughness, second_rough, eta, k, transmittance, float(texture),
                     float(mix_materials[0]), float(mix_materials[1]),
                     mix_amount, coat_roughness, eta_tab, k_tab],
                    np.float32,
                ),
            )
        )
        return len(self._materials) - 1

    def _build_sss(self) -> dict:
        """Compile the subsurface table stack (one beam-diffusion table per
        sss material, built with ITS g/eta — bssrdf.h:105 keeps one table per
        TabulatedBSSRDF). Sigma chroma stored as sigmoid-poly coeffs +
        scales (RGBUnboundedSpectrum analog, like media)."""
        if not self._sss:
            return {}
        from ..core import rgb2spec
        from ..scatter import bssrdf as bssrdf_mod

        sa = np.stack([m["sigma_a"] for m in self._sss])
        ss = np.stack([m["sigma_s"] for m in self._sss])
        scale = np.array([m["scale"] for m in self._sss], np.float32)
        ca, sca = rgb2spec.rgb_to_coeffs_host(sa)
        cs, scs = rgb2spec.rgb_to_coeffs_host(ss)
        tabs = [bssrdf_mod.compute_beam_diffusion_table(m["g"], m["eta"])
                for m in self._sss]
        return dict(
            sss_coeffs_a=ca.astype(np.float32),
            sss_scale_a=(sca * scale).astype(np.float32),
            sss_coeffs_s=cs.astype(np.float32),
            sss_scale_s=(scs * scale).astype(np.float32),
            sss_g=np.array([m["g"] for m in self._sss], np.float32),
            sss_profile=np.stack([np.asarray(t.profile) for t in tabs]),
            sss_cdf=np.stack([np.asarray(t.cdf) for t in tabs]),
            sss_rho_eff=np.stack([np.asarray(t.rho_eff) for t in tabs]),
            sss_radius=np.asarray(tabs[0].radius),
            sss_rho=np.asarray(tabs[0].rho),
        )

    def add_spectrum_table(self, spec) -> int:
        """Register a named spectrum (str name or .spd path), (lam, val)
        pair, or dense (471,) array; returns its index in spec_tables.
        Deduplicates by name."""
        from ..core import named_spectra

        key = spec if isinstance(spec, str) else None
        if key is not None and key in self._spec_names:
            return self._spec_names[key]
        dense = (np.asarray(spec, np.float32)
                 if isinstance(spec, np.ndarray) and spec.ndim == 1
                 and spec.shape[0] == named_spectra.DENSE_N
                 else named_spectra.dense(spec))
        self._spec_tables.append(dense.astype(np.float32))
        idx = len(self._spec_tables) - 1
        if key is not None:
            self._spec_names[key] = idx
        return idx

    # ---- media -----------------------------------------------------------

    def add_medium(
        self,
        kind: str = "homogeneous",
        sigma_a=(1.0, 1.0, 1.0),
        sigma_s=(0.0, 0.0, 0.0),
        scale: float = 1.0,
        g: float = 0.0,
        Le=(0.0, 0.0, 0.0),
        Le_scale: float = 0.0,
        density: Optional[np.ndarray] = None,
        bounds: Optional[np.ndarray] = None,
        temperature: Optional[np.ndarray] = None,
        temperature_scale: float = 1.0,
        temperature_offset: float = 0.0,
    ) -> int:
        """Register a participating medium (HomogeneousMedium / GridMedium,
        media.h). `density` is a (D,H,W) grid resampled to MED_GRID_RES^3;
        `bounds` its world AABB ((2,3)); sigma_* are RGB extinction chromas
        scaled by `scale` (RGBUnboundedSpectrum semantics). Emission Le is
        multiplied by sigma_a at sample points (GridMedium Le/LeScale).
        `temperature` ((D,H,W) Kelvin grid, with scale/offset applied at
        build) switches emission to per-point BLACKBODY radiance at the
        local temperature times Le_scale (GridMedium temperature grid,
        media.h:355 / medium_interface temperaturescale)."""
        kinds = {"homogeneous": MED_HOMOGENEOUS, "grid": MED_GRID,
                 "rgbgrid": MED_GRID, "cloud": MED_GRID, "nanovdb": MED_GRID}
        mtype = kinds[kind]
        if mtype == MED_GRID:
            if density is None or bounds is None:
                raise ValueError("grid medium needs density + bounds")
            d = np.asarray(density, np.float32)
            # resample to the fixed stack resolution (nearest; grids are
            # smooth — trilinear sampling happens at render time)
            r = MED_GRID_RES
            zi = (np.arange(r) * (d.shape[0] / r)).astype(np.int64)
            yi = (np.arange(r) * (d.shape[1] / r)).astype(np.int64)
            xi = (np.arange(r) * (d.shape[2] / r)).astype(np.int64)
            grid = d[zi][:, yi][:, :, xi]
            max_density = float(d.max())
            bounds = np.asarray(bounds, np.float32).reshape(2, 3)
            maj = majorant_grid(grid)
        else:
            grid = None
            maj = None
            max_density = 1.0
            bounds = np.zeros((2, 3), np.float32)
        tgrid = None
        if temperature is not None:
            # blackbody path: ctx.le must carry a FLAT le_scale spectrum
            # (media.le_at multiplies by the normalized Planck curve)
            if not np.any(np.asarray(Le)):
                Le = (1.0, 1.0, 1.0)
            t = (np.asarray(temperature, np.float32) - temperature_offset) \
                * temperature_scale
            r = MED_GRID_RES
            zi = (np.arange(r) * (t.shape[0] / r)).astype(np.int64)
            yi = (np.arange(r) * (t.shape[1] / r)).astype(np.int64)
            xi = (np.arange(r) * (t.shape[2] / r)).astype(np.int64)
            tgrid = t[zi][:, yi][:, :, xi]
        self._media.append(
            dict(type=mtype, sigma_a=np.asarray(sigma_a, np.float32),
                 sigma_s=np.asarray(sigma_s, np.float32), scale=float(scale),
                 g=float(g), Le=np.asarray(Le, np.float32),
                 Le_scale=float(Le_scale), grid=grid, maj=maj,
                 max_density=max_density, bounds=bounds, tgrid=tgrid)
        )
        return len(self._media) - 1

    def set_camera_medium(self, medium: int) -> None:
        self._camera_medium = int(medium)

    # ---- lights ----------------------------------------------------------

    def add_point_light(self, position, intensity_rgb=(1, 1, 1), scale: float = 1.0) -> int:
        self._lights.append(
            dict(type=LIGHT_POINT, pos=np.asarray(position, np.float32),
                 rgb=np.asarray(intensity_rgb, np.float32), scale=scale,
                 params=np.zeros(N_LIGHT_PARAMS, np.float32))
        )
        return len(self._lights) - 1

    def add_distant_light(self, direction, radiance_rgb=(1, 1, 1), scale: float = 1.0) -> int:
        d = np.asarray(direction, np.float64)
        d = (d / np.linalg.norm(d)).astype(np.float32)
        self._lights.append(
            dict(type=LIGHT_DISTANT, pos=d, rgb=np.asarray(radiance_rgb, np.float32),
                 scale=scale, params=np.zeros(N_LIGHT_PARAMS, np.float32))
        )
        return len(self._lights) - 1

    def add_uniform_infinite_light(self, radiance_rgb=(1, 1, 1), scale: float = 1.0) -> int:
        self._lights.append(
            dict(type=LIGHT_UNIFORM_INFINITE, pos=np.zeros(3, np.float32),
                 rgb=np.asarray(radiance_rgb, np.float32), scale=scale,
                 params=np.zeros(N_LIGHT_PARAMS, np.float32))
        )
        return len(self._lights) - 1

    def add_spot_light(self, position, direction, intensity_rgb=(1, 1, 1),
                       scale: float = 1.0, cone_angle: float = 30.0,
                       cone_delta: float = 5.0) -> int:
        """SpotLight (lights.h): smooth falloff between cone_angle-cone_delta
        and cone_angle (degrees, like pbrt's coneangle/conedeltaangle)."""
        d = np.asarray(direction, np.float64)
        d = (d / np.linalg.norm(d)).astype(np.float32)
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0:3] = d
        params[3] = np.cos(np.deg2rad(cone_angle))
        params[4] = np.cos(np.deg2rad(max(cone_angle - cone_delta, 0.0)))
        self._lights.append(
            dict(type=LIGHT_SPOT, pos=np.asarray(position, np.float32),
                 rgb=np.asarray(intensity_rgb, np.float32), scale=scale,
                 params=params))
        return len(self._lights) - 1

    def add_projection_light(self, position, direction, image: np.ndarray,
                             scale: float = 1.0, fov: float = 45.0,
                             up=(0, 1, 0)) -> int:
        """ProjectionLight (lights.h): projects an RGB image like a slide
        projector within a square frustum of the given fov (degrees)."""
        d = np.asarray(direction, np.float64)
        d = (d / np.linalg.norm(d)).astype(np.float32)
        tex = self.add_texture_image(image)
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0:3] = d
        params[3] = params[4] = np.tan(np.deg2rad(fov) / 2)
        params[5] = tex
        u = np.asarray(up, np.float64)
        u = u - d * np.dot(u, d)
        params[6:9] = (u / max(np.linalg.norm(u), 1e-9)).astype(np.float32)
        self._lights.append(
            dict(type=LIGHT_PROJECTION, pos=np.asarray(position, np.float32),
                 rgb=np.ones(3, np.float32), scale=scale, params=params))
        return len(self._lights) - 1

    def add_goniometric_light(self, position, intensity_map: np.ndarray,
                              intensity_rgb=(1, 1, 1), scale: float = 1.0) -> int:
        """GoniometricLight (lights.h): point light with an equal-area
        octahedral angular intensity map."""
        tex = self.add_texture_image(intensity_map)
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[5] = tex
        self._lights.append(
            dict(type=LIGHT_GONIOMETRIC, pos=np.asarray(position, np.float32),
                 rgb=np.asarray(intensity_rgb, np.float32), scale=scale,
                 params=params))
        return len(self._lights) - 1

    def add_portal(self, p0, p1, p2, p3) -> int:
        """PortalImageInfiniteLight (lights.h:631): restricts env-map
        illumination sampling to the solid angle of a planar quad portal.
        Requires set_environment_map; converts that env light to a portal
        light."""
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0:12] = np.concatenate(
            [np.asarray(x, np.float32) for x in (p0, p1, p2, p3)])
        for l in self._lights:
            if l["type"] == LIGHT_IMAGE_INFINITE:
                l["type"] = LIGHT_PORTAL_ENV
                l["params"] = params
                return self._lights.index(l)
        raise ValueError("add_portal requires set_environment_map first")

    # ---- geometry --------------------------------------------------------

    def add_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        material: int,
        normals: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
        transform: Optional[np.ndarray] = None,
        emission_rgb=None,
        emission_scale: float = 1.0,
        two_sided: bool = False,
        med_inside: int = -1,
        med_outside: int = -1,
        light_id: int | None = None,
        transform_end: Optional[np.ndarray] = None,
    ) -> None:
        """Add an indexed triangle mesh. If emission_rgb is set, every triangle
        becomes a DiffuseAreaLight (matching the reference, where a
        trianglemesh arealight makes one light per Triangle shape).
        If light_id is set instead, ALL triangles map to that pre-registered
        light record (used by analytic shape lights, e.g. the sphere area
        light). med_inside/med_outside attach a MediumInterface
        (primitive.h): the medium on the side the geometric normal points
        away from / toward; use material=-1 (MAT_INTERFACE) for a pure
        medium boundary."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        verts0 = vertices
        norms0 = normals
        if transform is not None:
            vertices = xf.apply_points(transform, verts0)
            if norms0 is not None:
                normals = xf.apply_normals(transform, norms0)
        p = vertices[faces]  # (F, 3, 3)
        if normals is not None:
            n = np.asarray(normals, np.float32)[faces]
        else:
            ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            n = np.repeat(ng[:, None, :], 3, axis=1)
        # shutter-end keyframe (ActiveTransform EndTime): same topology,
        # second transform
        if transform_end is not None and (
                transform is None
                or not np.allclose(transform_end, transform)):
            ve = xf.apply_points(transform_end, verts0)
            pe = ve[faces]
            if norms0 is not None:
                ne = xf.apply_normals(transform_end, norms0)[faces]
            else:
                nge = np.cross(pe[:, 1] - pe[:, 0], pe[:, 2] - pe[:, 0])
                nge /= np.maximum(
                    np.linalg.norm(nge, axis=-1, keepdims=True), 1e-20)
                ne = np.repeat(nge[:, None, :], 3, axis=1)
            self._tri_pe.append(pe.astype(np.float32))
            self._tri_ne.append(ne.astype(np.float32))
        else:
            self._tri_pe.append(None)
            self._tri_ne.append(None)
        if uvs is not None:
            uv = np.asarray(uvs, np.float32)[faces]
        else:
            uv = np.zeros((len(faces), 3, 2), np.float32)
        self._tri_p.append(p)
        self._tri_n.append(n.astype(np.float32))
        self._tri_uv.append(uv)
        self._tri_mat.append(np.full(len(faces), material, np.int32))
        self._tri_med.append((int(med_inside), int(med_outside)))
        if light_id is not None:
            self._tri_emit.append(int(light_id))
        elif emission_rgb is not None:
            self._tri_emit.append(
                (np.asarray(emission_rgb, np.float32), float(emission_scale), two_sided)
            )
        else:
            self._tri_emit.append(None)

    def add_quadric(self, kind: str, center, radius: float, material: int,
                    axis=(0.0, 0.0, 1.0), inner_radius: float = 0.0,
                    zmin: float = -1e30, zmax: float = 1e30,
                    light_id: int = -1, med_inside: int = -1,
                    med_outside: int = -1) -> int:
        """Register an ANALYTIC quadric (geometry/quadrics.py; shapes.h
        Sphere:107 / Disk:404 / Cylinder:574). Intersected exactly — no
        tessellation, no inscribed-mesh shadow bias."""
        from . import quadrics as quadrics_mod

        qt, qp = quadrics_mod.make_record(
            kind, center, radius, axis=axis, inner_radius=inner_radius,
            zmin=zmin, zmax=zmax)
        self._quadrics.append(dict(
            type=qt, params=qp, material=int(material),
            light=int(light_id if light_id is not None else -1),
            med=(int(med_inside), int(med_outside))))
        return len(self._quadrics) - 1

    def add_bilinear_patch(self, p00, p10, p01, p11, material: int,
                           light_id: int = -1, med_inside: int = -1,
                           med_outside: int = -1) -> int:
        """ANALYTIC bilinear patch (Reshetov intersection,
        geometry/quadrics.py; shapes.h:1279). Exact for non-planar patches
        that a 2-triangle split would get wrong."""
        from . import quadrics as quadrics_mod

        qt, qp = quadrics_mod.make_bilinear_record(p00, p10, p01, p11)
        self._quadrics.append(dict(
            type=qt, params=qp, material=int(material),
            light=int(light_id if light_id is not None else -1),
            med=(int(med_inside), int(med_outside))))
        return len(self._quadrics) - 1

    def add_sphere(self, center, radius, material, n_theta=32, n_phi=64,
                   emission_rgb=None, emission_scale: float = 1.0,
                   two_sided: bool = False, **kw):
        """Tessellated sphere (the reference's analytic Sphere shape,
        shapes.h:107, is represented as a fine mesh; analytic quadrics can come
        later as a separate prim type).

        If emissive, registers ONE analytic sphere area light
        (LIGHT_SPHERE_AREA) covering the whole shape — cone solid-angle
        sampling per the reference's Sphere::Sample (shapes.h:280) — instead
        of one light per tessellation triangle. params: [radius, twosided,
        sag] where sag is the max chord depth of the tessellation, used to
        shorten shadow rays so the inscribed tessellated surface doesn't
        occlude its own analytic sample points."""
        if emission_rgb is not None:
            light_id = self.add_sphere_area_light(
                center, radius, emission_rgb, emission_scale,
                two_sided=two_sided, n_theta=n_theta)
            kw = dict(kw, light_id=light_id)
        th = np.linspace(0, np.pi, n_theta + 1)
        ph = np.linspace(0, 2 * np.pi, n_phi + 1)
        tt, pp = np.meshgrid(th, ph, indexing="ij")
        x = np.sin(tt) * np.cos(pp)
        y = np.sin(tt) * np.sin(pp)
        z = np.cos(tt)
        verts = np.stack([x, y, z], -1).reshape(-1, 3)
        normals = verts.copy()
        verts = verts * radius + np.asarray(center, np.float32)
        idx = lambda i, j: i * (n_phi + 1) + j
        faces = []
        for i in range(n_theta):
            for j in range(n_phi):
                a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
                if i > 0:
                    faces.append([a, b, d])
                if i < n_theta - 1:
                    faces.append([b, c, d])
        self.add_mesh(np.asarray(verts, np.float32), np.asarray(faces), material,
                      normals=normals.astype(np.float32), **kw)

    def add_sphere_area_light(self, center, radius, emission_rgb,
                              emission_scale: float = 1.0,
                              two_sided: bool = False,
                              n_theta: int = 16) -> int:
        """Register ONE analytic sphere area light record (LIGHT_SPHERE_AREA).
        The caller still adds tessellated geometry with this light_id so
        rays can hit it; n_theta sets the tessellation's inscribed radius
        (params[2]) used to bound shadow rays so the light's own inscribed
        mesh can never self-occlude its analytic sample points."""
        r_ins = float(radius) * float(np.cos(np.pi / max(n_theta, 3))) * 0.999
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0] = float(radius)
        params[1] = 1.0 if two_sided else 0.0
        params[2] = r_ins
        self._lights.append(
            dict(type=LIGHT_SPHERE_AREA,
                 pos=np.asarray(center, np.float32),
                 rgb=np.asarray(emission_rgb, np.float32),
                 scale=float(emission_scale), params=params))
        return len(self._lights) - 1

    def add_quad(self, p00, p10, p11, p01, material, **kw):
        verts = np.asarray([p00, p10, p11, p01], np.float32)
        faces = np.asarray([[0, 1, 2], [0, 2, 3]])
        self.add_mesh(verts, faces, material, **kw)

    # ---- compile ---------------------------------------------------------

    def build(self) -> CompiledScene:
        if not self._tri_p:
            if not self._quadrics:
                raise ValueError("empty scene")
            # quadric-only scene: one degenerate triangle keeps the BVH and
            # padded-lane machinery shaped (rejected by det==0 everywhere)
            self.add_mesh(np.zeros((3, 3), np.float32),
                          np.array([[0, 1, 2]]), material=-1)
        tri_p = np.concatenate(self._tri_p)
        tri_n = np.concatenate(self._tri_n)
        tri_uv = np.concatenate(self._tri_uv)
        tri_mat = np.concatenate(self._tri_mat)
        n = len(tri_p)
        animated = any(pe is not None for pe in self._tri_pe)
        if animated:
            tri_p_end = np.concatenate(
                [pe if pe is not None else p0
                 for pe, p0 in zip(self._tri_pe, self._tri_p)])
            tri_n_end = np.concatenate(
                [ne if ne is not None else n0
                 for ne, n0 in zip(self._tri_ne, self._tri_n)])

        # expand per-mesh medium interfaces into per-triangle columns
        tri_med_in = np.concatenate(
            [np.full(len(c), mi, np.int32)
             for c, (mi, _) in zip(self._tri_p, self._tri_med)]
        )
        tri_med_out = np.concatenate(
            [np.full(len(c), mo, np.int32)
             for c, (_, mo) in zip(self._tri_p, self._tri_med)]
        )

        # expand per-mesh emission into per-triangle area lights
        tri_light = np.full(n, -1, np.int32)
        lights = list(self._lights)
        off = 0
        for chunk, emit in zip(self._tri_p, self._tri_emit):
            cnt = len(chunk)
            if isinstance(emit, int):
                # whole mesh maps to one pre-registered shape light
                tri_light[off:off + cnt] = emit
            elif emit is not None:
                rgb, sc, two = emit
                for k in range(cnt):
                    tri_light[off + k] = len(lights)
                    params = np.zeros(N_LIGHT_PARAMS, np.float32)
                    params[0] = off + k
                    params[1] = 1.0 if two else 0.0
                    lights.append(
                        dict(type=LIGHT_AREA_TRI, pos=np.zeros(3, np.float32),
                             rgb=rgb, scale=sc, params=params)
                    )
            off += cnt

        # pad triangles to lane multiple with degenerate (all-zero) triangles
        pad = (-n) % 128
        if pad:
            tri_p = np.concatenate([tri_p, np.zeros((pad, 3, 3), np.float32)])
            tri_n = np.concatenate([tri_n, np.zeros((pad, 3, 3), np.float32)])
            tri_n[n:, :, 2] = 1.0
            if animated:
                tri_p_end = np.concatenate(
                    [tri_p_end, np.zeros((pad, 3, 3), np.float32)])
                tri_n_end = np.concatenate(
                    [tri_n_end, np.zeros((pad, 3, 3), np.float32)])
                tri_n_end[n:, :, 2] = 1.0
            tri_uv = np.concatenate([tri_uv, np.zeros((pad, 3, 2), np.float32)])
            tri_mat = np.concatenate([tri_mat, np.full(pad, -1, np.int32)])
            tri_light = np.concatenate([tri_light, np.full(pad, -1, np.int32)])
            tri_med_in = np.concatenate([tri_med_in, np.full(pad, -1, np.int32)])
            tri_med_out = np.concatenate([tri_med_out, np.full(pad, -1, np.int32)])

        # materials
        if not self._materials:
            self.add_material("diffuse")
        mat_type = np.array([m["type"] for m in self._materials], np.int32)
        refl = np.stack([m["reflectance"] for m in self._materials])
        mat_coeffs, mat_scale = rgb2spec.rgb_to_coeffs_host(refl)
        mat_params = np.stack([m["params"] for m in self._materials])

        # lights
        if lights:
            light_type = np.array([l["type"] for l in lights], np.int32)
            light_pos = np.stack([l["pos"] for l in lights])
            lrgb = np.stack([l["rgb"] for l in lights])
            lscale = np.array([l["scale"] for l in lights], np.float32)
            lc, ls = rgb2spec.rgb_to_coeffs_host(lrgb)
            light_scale = lscale * ls
            light_params = np.stack([l["params"] for l in lights])
        else:
            light_type = np.zeros(0, np.int32)
            light_pos = np.zeros((0, 3), np.float32)
            lc = np.zeros((0, 3), np.float32)
            light_scale = np.zeros(0, np.float32)
            light_params = np.zeros((0, N_LIGHT_PARAMS), np.float32)

        # textures -> native-res mip atlas of spectral coefficients (host)
        if self._textures:
            from . import texture as texture_mod

            tex_atlas, tex_desc = texture_mod.pack_atlas(self._textures)
        else:
            tex_atlas = np.zeros((1, 4), np.float32)
            tex_desc = np.zeros((1, 1, 3), np.int32)

        # measured BRDF tables -> stacked spectral-coefficient grids
        if self._measured:
            from ..scatter import measured as measured_mod

            measured_coeffs = np.stack(
                [measured_mod.table_to_coeffs(t) for t in self._measured]
            )
            measured_alpha = np.array(
                [measured_mod.fit_ggx_alpha(t) for t in self._measured],
                np.float32)
        else:
            measured_coeffs = np.zeros((1, 2, 2, 2, 4), np.float32)
            measured_alpha = np.ones((1,), np.float32)

        # environment map -> coefficient image + luminance sampling tables
        if self._env_image is not None:
            env_coeffs = rgb2spec.rgb_image_to_coeffs(self._env_image)
            lum = (
                0.2126 * self._env_image[..., 0]
                + 0.7152 * self._env_image[..., 1]
                + 0.0722 * self._env_image[..., 2]
            ).astype(np.float32) + 1e-9
            he, we = lum.shape
            row_int = lum.mean(1)
            cond = np.concatenate(
                [np.zeros((he, 1), np.float32), np.cumsum(lum, 1) / we], 1
            ) / np.maximum(row_int[:, None], 1e-20)
            marg_cdf = np.concatenate([[0.0], np.cumsum(row_int) / he]).astype(np.float32)
            integral = marg_cdf[-1]
            marg_cdf = marg_cdf / max(integral, 1e-20)
            env = dict(
                env_coeffs=env_coeffs, env_cond_cdf=cond.astype(np.float32),
                env_marg_cdf=marg_cdf,
                env_marg_func=(row_int / max(integral, 1e-20)).astype(np.float32),
                env_luminance=(lum / max(integral, 1e-20)).astype(np.float32),
            )
        else:
            env = dict(
                env_coeffs=np.zeros((1, 1, 4), np.float32),
                env_cond_cdf=np.zeros((1, 2), np.float32),
                env_marg_cdf=np.zeros((2,), np.float32),
                env_marg_func=np.zeros((1,), np.float32),
                env_luminance=np.zeros((1, 1), np.float32),
            )

        # portal image warp tables (scatter/portal.py; first portal light)
        portal = {}
        if self._env_image is not None:
            for l in self._lights:
                if l["type"] == LIGHT_PORTAL_ENV:
                    from ..scatter import portal as portal_mod

                    quad = np.asarray(l["params"][0:12],
                                      np.float32).reshape(4, 3)
                    xw, yw, zw = portal_mod.frame_from_quad(*quad)
                    # orient +z away from the scene (the illuminated side
                    # faces the env; the reference relies on vertex winding,
                    # lights.h ImageFromRender w.z <= 0 -> invisible)
                    centroid = np.concatenate(
                        [t.reshape(-1, 3) for t in self._tri_p]).mean(0)
                    if np.dot(zw, centroid - quad[0]) > 0:
                        xw, yw, zw = yw, xw, -zw  # swap x/y keeps RH frame
                    pic, sat = portal_mod.build_tables(
                        self._env_image, quad, frame=(xw, yw, zw))
                    portal = dict(portal_img_coeffs=pic, portal_sat=sat,
                                  portal_frame=np.stack([xw, yw, zw]))
                    break

        # media -> fused-gather-ready SoA columns
        if self._media:
            med_type = np.array([m["type"] for m in self._media], np.int32)
            sa_c, sa_s = rgb2spec.rgb_to_coeffs_host(
                np.stack([m["sigma_a"] for m in self._media]))
            ss_c, ss_s = rgb2spec.rgb_to_coeffs_host(
                np.stack([m["sigma_s"] for m in self._media]))
            le_c, le_s = rgb2spec.rgb_to_coeffs_host(
                np.stack([m["Le"] for m in self._media]))
            user = np.array([m["scale"] for m in self._media], np.float32)
            med_scales = np.stack(
                [sa_s * user, ss_s * user,
                 le_s * np.array([m["Le_scale"] for m in self._media], np.float32),
                 np.array([m["g"] for m in self._media], np.float32)], -1)
            grids, majs, tgrids = [], [], []
            med_grid_id = np.full(len(self._media), -1, np.int32)
            med_temp_grid_id = np.full(len(self._media), -1, np.int32)
            for i, m in enumerate(self._media):
                if m["grid"] is not None:
                    med_grid_id[i] = len(grids)
                    grids.append(m["grid"])
                    majs.append(m["maj"])
                if m.get("tgrid") is not None:
                    med_temp_grid_id[i] = len(tgrids)
                    tgrids.append(m["tgrid"])
            med = dict(
                med_type=med_type, med_sa_coeffs=sa_c, med_ss_coeffs=ss_c,
                med_le_coeffs=le_c, med_scales=med_scales.astype(np.float32),
                med_grid_id=med_grid_id,
                med_max_density=np.array(
                    [m["max_density"] for m in self._media], np.float32),
                med_bounds=np.stack([m["bounds"] for m in self._media]),
                med_grids=(np.stack(grids) if grids
                           else np.zeros((1, 1, 1, 1), np.float32)),
                med_maj_grids=(np.stack(majs) if majs
                               else np.ones((1, 1, 1, 1), np.float32)),
                med_temp_grids=(np.stack(tgrids) if tgrids
                                else np.zeros((1, 1, 1, 1), np.float32)),
                med_temp_grid_id=med_temp_grid_id,
                n_media=len(self._media), camera_medium=self._camera_medium,
            )
        else:
            med = dict(
                med_type=np.zeros(0, np.int32),
                med_sa_coeffs=np.zeros((0, 3), np.float32),
                med_ss_coeffs=np.zeros((0, 3), np.float32),
                med_le_coeffs=np.zeros((0, 3), np.float32),
                med_scales=np.zeros((0, 4), np.float32),
                med_grid_id=np.zeros(0, np.int32),
                med_max_density=np.zeros(0, np.float32),
                med_bounds=np.zeros((0, 2, 3), np.float32),
                med_grids=np.zeros((1, 1, 1, 1), np.float32),
                med_maj_grids=np.ones((1, 1, 1, 1), np.float32),
                med_temp_grids=np.zeros((1, 1, 1, 1), np.float32),
                med_temp_grid_id=np.zeros(0, np.int32),
                n_media=0, camera_medium=-1,
            )

        lo = tri_p[:n].reshape(-1, 3).min(0)
        hi = tri_p[:n].reshape(-1, 3).max(0)

        # analytic quadrics: SoA arrays + scene-bounds extension
        if self._quadrics:
            from . import quadrics as quadrics_mod

            quad_type = np.array([q["type"] for q in self._quadrics], np.int32)
            quad_params = np.stack([q["params"] for q in self._quadrics])
            quad_mat = np.array([q["material"] for q in self._quadrics], np.int32)
            quad_light = np.array([q["light"] for q in self._quadrics], np.int32)
            quad_med = np.array([q["med"] for q in self._quadrics], np.int32)
            quad_uvs = quadrics_mod.uv_scale(quad_type, quad_params)
            for qt, qp in zip(quad_type, quad_params):
                qlo, qhi = quadrics_mod.bounds(int(qt), qp)
                lo = np.minimum(lo, qlo)
                hi = np.maximum(hi, qhi)
            quads = dict(quad_type=quad_type, quad_params=quad_params,
                         quad_uv_scale=quad_uvs, quad_mat=quad_mat,
                         quad_light=quad_light, quad_med=quad_med,
                         n_quadrics=len(self._quadrics))
        else:
            quads = dict(n_quadrics=0)

        # NOTE: arrays stay HOST-side numpy. Device upload happens exactly once
        # (to_device / the renderers), so the whole scene pipeline (BVH
        # build, reorder, light-power tables) runs on numpy first and nothing
        # is read back from the device.
        out = CompiledScene(
            tri_p=tri_p,
            tri_n=tri_n,
            tri_uv=tri_uv,
            tri_mat=tri_mat,
            tri_light=tri_light,
            n_tris=n,
            mat_type=mat_type,
            mat_coeffs=mat_coeffs,
            mat_scale=mat_scale,
            mat_params=mat_params,
            light_type=light_type,
            light_pos=light_pos,
            light_coeffs=lc,
            light_scale=light_scale,
            light_params=light_params,
            n_lights=int(len(lights)),
            bounds=np.stack([lo, hi]),
            **quads,
            tex_atlas=tex_atlas,
            tex_desc=tex_desc,
            measured_coeffs=measured_coeffs,
            measured_alpha=measured_alpha,
            tri_med_inside=tri_med_in,
            tri_med_outside=tri_med_out,
            feat_mix=bool(np.any(mat_type == MAT_MIX)),
            feat_subsurface=bool(np.any(mat_type == MAT_SUBSURFACE)),
            **self._build_sss(),
            feat_hair=bool(np.any(mat_type == MAT_HAIR)),
            feat_measured=bool(np.any(mat_type == MAT_MEASURED)),
            feat_portal=bool(np.any(light_type == LIGHT_PORTAL_ENV)),
            feat_spectral=bool(self._spec_tables),
            feat_coated=bool(np.any((mat_type == MAT_COATED_DIFFUSE)
                                    | (mat_type == MAT_COATED_CONDUCTOR))),
            spec_tables=(np.stack(self._spec_tables)
                         if self._spec_tables else None),
            **med,
            **env,
            **portal,
        )
        if animated:
            out = out.replace(tri_p_end=tri_p_end, tri_n_end=tri_n_end)
        # fused shading record (rebuilt after any BVH reorder)
        out = out.replace(tri_shade=make_tri_shade(out))
        if animated:
            out = out.replace(tri_shade_end=make_tri_shade(out, use_end=True))
        return out


def to_device(scene: CompiledScene) -> CompiledScene:
    """One-shot upload of every scene buffer to the default device."""
    return jax.tree.map(jnp.asarray, scene)
