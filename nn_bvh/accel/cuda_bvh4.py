"""BVH4 traversal on NVIDIA Hopper: a CUDA kernel called through `jax.ffi`.

The kernel (cuda/bvh4_traverse.cu) runs one thread per ray over the 4-wide
BVH of `bvh4.collapse_bvh4`, with a private near-to-far stack. This module
holds everything around it that runs without a card:

- host packing of the wide nodes (128-byte records: four child boxes in SoA
  plus four child references) and of the triangles (three float4 vertices);
- `walk_numpy`, a plain per-ray walk over the same packed tables — the
  reference beside the kernel that the CPU tests check against brute force;
- the build of the shared library with `nvcc` into `cuda/_build/` (keyed by
  a hash of the source and flags, at first use) and its FFI registration;
- `closest` / `occluded`, the wrappers the dispatcher calls inside jit and
  shard_map.

Build command (what `build_library` runs):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -std=c++17 -shared \
        -Xcompiler -fPIC -I $(python -c 'import jax.ffi; print(jax.ffi.include_dir())') \
        -o nn_bvh/accel/cuda/_build/libnn_bvh_bvh4_<hash>.so nn_bvh/accel/cuda/bvh4_traverse.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

from . import bvh4
from ..geometry import triangle
from .traverse import Hit

STACK_DEPTH = 128          # kStack in cuda/bvh4_traverse.cu
NODE_F32 = 32              # 128-byte node record
TRI_F32 = 12               # p0.xyz 0 p1.xyz 0 p2.xyz 0
EMPTY = int(np.iinfo(np.int32).min)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cuda", "bvh4_traverse.cu")
_BUILD_DIR = os.path.join(_DIR, "cuda", "_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
_TARGETS = {False: "nn_bvh_bvh4_closest", True: "nn_bvh_bvh4_any"}
_SYMBOLS = {False: "NnBvhBvh4Closest", True: "NnBvhBvh4Any"}

_registered = False


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------

def pack_nodes(wide_lo: np.ndarray, wide_hi: np.ndarray,
               wide_meta: np.ndarray) -> np.ndarray:
    """(W,4,3) lo/hi + (W,4) meta -> (W, 32) f32 node records.

    Row layout: lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4] child[4]
    pad[4]; child refs are i32 bits, empty slots (meta 0: the root is never a
    child) become EMPTY."""
    W = len(wide_lo)
    tab = np.zeros((W, NODE_F32), np.float32)
    for ax in range(3):
        tab[:, 4 * ax:4 * ax + 4] = wide_lo[:, :, ax]
        tab[:, 12 + 4 * ax:16 + 4 * ax] = wide_hi[:, :, ax]
    child = np.where(wide_meta == 0, EMPTY, wide_meta).astype(np.int32)
    tab[:, 24:28] = child.view(np.float32)
    return tab


def pack_tris(tri_p) -> np.ndarray:
    """(N,3,3) vertices -> (N, 12) f32: three float4-aligned vertices."""
    tri_p = np.asarray(tri_p, np.float32)
    tab = np.zeros((len(tri_p), 3, 4), np.float32)
    tab[:, :, :3] = tri_p
    return tab.reshape(len(tri_p), TRI_F32)


def pack_scene(dbvh, tri_p) -> tuple[np.ndarray, np.ndarray]:
    """Binary flat BVH + triangles -> (node_tab, tri_tab) host arrays.

    Raises ValueError when the tree is deep enough to overflow the kernel's
    per-thread stack (each interior level adds at most 3 entries)."""
    n = int(dbvh.n_nodes)
    wl, wh, wm = bvh4.collapse_bvh4(np.asarray(dbvh.node_lo)[:n],
                                    np.asarray(dbvh.node_hi)[:n],
                                    np.asarray(dbvh.node_meta)[:n])
    depth = bvh4.wide_depth(wm)
    if 3 * depth + 4 >= STACK_DEPTH:
        raise ValueError(
            f"BVH4 depth {depth} overflows STACK_DEPTH={STACK_DEPTH}")
    return pack_nodes(wl, wh, wm), pack_tris(tri_p)


# ---------------------------------------------------------------------------
# plain reference: the kernel's walk in numpy, one ray at a time
# ---------------------------------------------------------------------------

def _tri_np(o, d, t_max, tris):
    """Watertight test of one ray against (k, 12) triangles (float32,
    geometry/triangle.py arithmetic) -> (hit, t, b1, b2) arrays."""
    f = np.float32
    ad = np.abs(d)
    kz = int(np.argmax(ad))
    kx = 0 if kz == 2 else kz + 1
    ky = 0 if kx == 2 else kx + 1
    perm = [kx, ky, kz]
    dp = d[perm]
    inv_dz = f(1.0) / dp[2]
    sx, sy, sz = -dp[0] * inv_dz, -dp[1] * inv_dz, inv_dz
    v = tris.reshape(-1, 3, 4)[:, :, :3][:, :, perm] - o[perm]
    x = v[..., 0] + sx * v[..., 2]
    y = v[..., 1] + sy * v[..., 2]
    z = v[..., 2]

    def edge(a, b):
        return (x[:, a] * y[:, b] - y[:, a] * x[:, b],
                f(4e-7) * (np.abs(x[:, a] * y[:, b]) + np.abs(y[:, a] * x[:, b])))

    (e0, t0), (e1, t1), (e2, t2) = edge(1, 2), edge(2, 0), edge(0, 1)
    same = (((e0 >= -t0) & (e1 >= -t1) & (e2 >= -t2))
            | ((e0 <= t0) & (e1 <= t1) & (e2 <= t2)))
    det = e0 + e1 + e2
    ts = e0 * z[:, 0] * sz + e1 * z[:, 1] * sz + e2 * z[:, 2] * sz
    with np.errstate(divide="ignore", invalid="ignore"):
        pos = (det > 0) & (ts > 0) & (ts < t_max * det)
        neg = (det < 0) & (ts < 0) & (ts > t_max * det)
        inv = np.where(det != 0, f(1.0) / np.where(det != 0, det, f(1.0)), f(0))
        t = ts * inv
    hit = same & (det != 0) & (pos | neg) & np.isfinite(t)
    return hit, t, e1 * inv, e2 * inv


def _slab_np(o, inv, t, lo, hi):
    """Slab test of one ray against (4, 3) child boxes -> entry distances
    (inf on a miss)."""
    with np.errstate(over="ignore", invalid="ignore"):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
    tn = np.minimum(t0, t1).max(axis=1)
    tf = np.maximum(t0, t1).min(axis=1) * np.float32(1.0000004)
    ok = (tn <= tf) & (tf > 0) & (tn < t)
    return np.where(ok, tn, np.float32(np.inf))


def walk_numpy(node_tab, tri_tab, o, d, t_max, any_hit: bool = False):
    """Per-ray walk over the packed tables, in the kernel's order.
    Returns numpy (t, prim, b1, b2) with misses at t=inf, prim=-1."""
    f = np.float32
    node_tab = np.asarray(node_tab, f)
    tri_tab = np.asarray(tri_tab, f)
    o, d, t_max = (np.asarray(a, f) for a in (o, d, t_max))
    lo = node_tab[:, 0:12].reshape(-1, 3, 4).transpose(0, 2, 1)
    hi = node_tab[:, 12:24].reshape(-1, 3, 4).transpose(0, 2, 1)
    child = node_tab[:, 24:28].view(np.int32)
    R = len(o)
    t_out = np.full(R, np.inf, f)
    prim_out = np.full(R, -1, np.int32)
    b1_out = np.zeros(R, f)
    b2_out = np.zeros(R, f)
    for i in range(R):
        t = t_max[i]
        if not t > 0:
            continue
        di = d[i]
        safe = np.where(np.abs(di) < 1e-20,
                        np.where(di < 0, f(-1e-20), f(1e-20)), di)
        inv = f(1.0) / safe
        prim, b1, b2 = -1, f(0), f(0)
        stack = [(0, -np.inf)]
        while stack:
            e, te = stack.pop()
            if not te < t:
                continue
            if e >= 0:
                k = _slab_np(o[i], inv, t, lo[e], hi[e])
                k = np.where(child[e] == EMPTY, np.inf, k)
                for c in np.argsort(-k, kind="stable"):
                    if np.isfinite(k[c]):
                        stack.append((int(child[e, c]), k[c]))
                continue
            u = -e - 1
            off, cnt = u >> 4, (u & 15) + 1
            h, th, u1, u2 = _tri_np(o[i], di, t, tri_tab[off:off + cnt])
            for j in range(cnt):
                if h[j] and th[j] < t:
                    t, prim, b1, b2 = th[j], off + j, u1[j], u2[j]
                    if any_hit:
                        break
            if any_hit and prim >= 0:
                break
        if prim >= 0:
            t_out[i], prim_out[i], b1_out[i], b2_out[i] = t, prim, b1, b2
    return t_out, prim_out, b1_out, b2_out


# ---------------------------------------------------------------------------
# build, load and register the library
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libnn_bvh_bvh4_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the kernel library if this source has not been built yet.
    Raises RuntimeError when nvcc is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-I", jax.ffi.include_dir(),
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({e}); cannot build {_SRC}")
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed:\n{e.stderr}")
    os.replace(tmp, so)
    return so


def register() -> None:
    """Build (if needed), load and register both FFI targets. Idempotent."""
    global _registered
    if _registered:
        return
    lib = ctypes.CDLL(build_library())
    for any_hit, target in _TARGETS.items():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[any_hit])),
            platform="CUDA")
    _registered = True


# ---------------------------------------------------------------------------
# traced wrapper
# ---------------------------------------------------------------------------

def _ffi_traverse(node_tab, tri_tab, rays, any_hit: bool):
    """One kernel launch: rays (7, R) -> hit primitive (R,) i32, -1 = miss."""
    register()
    out = jax.ShapeDtypeStruct((rays.shape[1],), jnp.int32)
    prim = jax.ffi.ffi_call(_TARGETS[any_hit], out, vmap_method="sequential")(
        node_tab, tri_tab, rays)
    # under shard_map the result varies like the rays (one launch per shard)
    vma = tuple(jax.typeof(rays).vma)
    return jax.lax.pcast(prim, vma, to="varying") if vma else prim


def _launch(node_tab, tri_tab, o, d, t_max, any_hit):
    """Pack the rays as (7, R) SoA and launch. Visibility carries no
    gradient, and the FFI call has no derivative rule, so every input is
    detached here. Under shard_map the replicated tables are cast to the
    rays' varying axes so the call sees one set of axes."""
    sg = jax.lax.stop_gradient
    rays = sg(jnp.concatenate([jnp.moveaxis(o, -1, 0), jnp.moveaxis(d, -1, 0),
                               t_max[None].astype(o.dtype)], axis=0))
    node_tab, tri_tab = sg(node_tab), sg(tri_tab)
    vma = tuple(jax.typeof(rays).vma)
    if vma:
        node_tab, tri_tab = (
            x if jax.typeof(x).vma else jax.lax.pcast(x, vma, to="varying")
            for x in (node_tab, tri_tab))
    return _ffi_traverse(node_tab, tri_tab, rays, any_hit)


def closest(node_tab, tri_tab, o, d, t_max) -> Hit:
    """Closest hit for a ray batch. o, d: (R, 3); t_max: (R,), lanes with
    t_max <= 0 miss.

    The kernel finds the primitive; t and the barycentrics come from
    geometry/triangle.py on that primitive, the arithmetic the XLA walk uses,
    so both backends return the same record for the same hit. A grazing hit
    that this arithmetic rejects becomes a miss."""
    prim = _launch(node_tab, tri_tab, o, d, t_max, False)
    o, d, t_max = (jax.lax.stop_gradient(a) for a in (o, d, t_max))
    tri = jax.lax.stop_gradient(tri_tab)[jnp.maximum(prim, 0)]
    v = tri.reshape(-1, 3, 4)[..., :3]
    th = triangle.intersect(o, d, t_max, v[:, 0], v[:, 1], v[:, 2])
    ok = (prim >= 0) & th.hit
    return Hit(t=jnp.where(ok, th.t, jnp.inf), prim=jnp.where(ok, prim, -1),
               b1=jnp.where(ok, th.b1, 0.0), b2=jnp.where(ok, th.b2, 0.0))


def occluded(node_tab, tri_tab, o, d, t_max):
    """Any hit within t_max (shadow rays) -> bool (R,)."""
    return _launch(node_tab, tri_tab, o, d, t_max, True) >= 0
