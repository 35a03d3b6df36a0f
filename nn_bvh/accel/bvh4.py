"""BVH4 wide nodes: host-side collapse of the binary BVH.

Collapsing the binary tree (the reference's LinearBVHNode layout,
cpu/aggregates.cpp:505) into 4-wide nodes halves the interior-node count, so
a traversal pops half as many nodes and tests four child boxes per pop. The
CUDA kernel (cuda_bvh4.py) packs these wide nodes into 128-byte records.

Child meta encoding (wide_meta):
  >= 0 -> wide-node index (interior child)
  <  0 -> leaf: -(1 + tri_offset*16 + (count-1)), count in 1..16
  empty children get lo=hi=+3e38 and meta 0 (the packer marks them empty).
"""

from __future__ import annotations

import numpy as np

WIDTH = 4


def collapse_bvh4(node_lo: np.ndarray, node_hi: np.ndarray,
                  node_meta: np.ndarray, max_leaf: int = 8):
    """Binary flat BVH (build.BVH layout: interior -> children (self+1,
    offset)) -> (wide_lo (W,4,3), wide_hi (W,4,3), wide_meta (W,4) i64).

    Greedy: each wide node starts from a binary node's two children and
    repeatedly expands the largest-area interior child until it holds 4
    binary subtree roots. Iterative with an explicit stack + preallocated
    arrays (crown-scale trees are ~1M binary nodes; appending Python lists
    per node is too slow)."""
    node_lo = np.asarray(node_lo, np.float32)
    node_hi = np.asarray(node_hi, np.float32)
    meta = np.asarray(node_meta)
    offs, cnts = meta[:, 0].astype(np.int64), meta[:, 1].astype(np.int64)
    ext = node_hi - node_lo
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    n_bin = len(node_lo)
    cap = max(4, n_bin)  # wide count <= binary interior count + 1
    wide_lo = np.full((cap, WIDTH, 3), 3e38, np.float32)
    wide_hi = np.full((cap, WIDTH, 3), 3e38, np.float32)
    wide_meta = np.zeros((cap, WIDTH), np.int64)
    n_wide = 1  # root = 0

    def leaf_entry(c):
        assert 1 <= cnts[c] <= 16
        return -(1 + offs[c] * 16 + (cnts[c] - 1))

    stack = [(0, 0)]  # (binary root, wide index)
    while stack:
        b, w = stack.pop()
        if cnts[b] > 0:
            children = [b]  # degenerate: binary root itself is a leaf
        else:
            children = [b + 1, int(offs[b])]
            while len(children) < WIDTH:
                best, best_a = -1, -1.0
                for k, c in enumerate(children):
                    if cnts[c] == 0 and area[c] > best_a:
                        best, best_a = k, float(area[c])
                if best < 0:
                    break
                c = children.pop(best)
                children.extend([c + 1, int(offs[c])])
        for k, c in enumerate(children):
            wide_lo[w, k] = node_lo[c]
            wide_hi[w, k] = node_hi[c]
            if cnts[c] > 0:
                wide_meta[w, k] = leaf_entry(c)
            else:
                cw = n_wide
                n_wide += 1
                wide_meta[w, k] = cw
                stack.append((c, cw))
    return wide_lo[:n_wide], wide_hi[:n_wide], wide_meta[:n_wide]


def wide_depth(wide_meta: np.ndarray) -> int:
    """Max stack occupancy bound: 3 extra entries per interior level."""
    W = len(wide_meta)
    depth = np.zeros(W, np.int32)
    # children always have larger indices than parents (DFS alloc order is
    # not guaranteed by the stack, but indices ARE allocated parent-first)
    for w in range(W):
        for k in range(WIDTH):
            m = wide_meta[w, k]
            if m > 0:
                if depth[m] < depth[w] + 1:
                    depth[m] = depth[w] + 1
    return int(depth.max()) + 1 if W else 1
