// Native BVH builder: binned SAH over primitive bounds.
//
// The framework's host-side equivalent of the reference's
// BVHAggregate build (src/pbrt/cpu/aggregates.cpp: buildRecursive :192,
// 12-bucket SAH sweep :278, flattenBVH :505, async child builds :363).
// Produces the exact flattened layout of accel/build.py::BVH:
//   node_lo/node_hi: (n_nodes, 3) f32
//   node_meta:       (n_nodes, 3) i32 = [offset, count, axis]
//                    count>0 leaf (offset = first reordered prim);
//                    count==0 interior (first child = self+1, offset = 2nd
//                    child, axis = split axis for ordered descent)
//   prim_order:      (n,) i64 original index per post-reorder slot
// Depth-first node order (right subtree pushed first onto an explicit
// stack), identical to the numpy builder so the two are drop-in equals.
//
// Single-threaded by design: the build is a one-shot scene-compile step and
// the deployment hosts expose 2 cores shared with XLA compilation (the
// reference forks async child builds >=128k prims, aggregates.cpp:363 —
// worth adding here if host core counts grow).
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_BUCKETS = 12;

struct V3 {
    float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float half_area(const V3 &lo, const V3 &hi) {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
}

struct Builder {
    const V3 *lo;
    const V3 *hi;
    std::vector<V3> cent;
    int max_leaf;
    float trav_cost;

    // output (single contiguous arrays, preallocated to 2n by the caller)
    float *node_lo;
    float *node_hi;
    int32_t *node_meta;
    int64_t *order;

    struct Frame {
        int64_t *idx;       // working index slice (in scratch)
        int64_t count;
        int32_t patch;      // parent node to patch with our id (-1 none)
        int64_t prim_base;  // where this subtree's prims land in `order`
    };

    int32_t n_nodes = 0;

    int32_t alloc_node() { return n_nodes++; }

    void emit_leaf(int32_t me, const Frame &f, const V3 &blo, const V3 &bhi) {
        node_lo[3 * me] = blo.x;
        node_lo[3 * me + 1] = blo.y;
        node_lo[3 * me + 2] = blo.z;
        node_hi[3 * me] = bhi.x;
        node_hi[3 * me + 1] = bhi.y;
        node_hi[3 * me + 2] = bhi.z;
        node_meta[3 * me] = (int32_t)f.prim_base;
        node_meta[3 * me + 1] = (int32_t)f.count;
        node_meta[3 * me + 2] = 0;
        std::memcpy(order + f.prim_base, f.idx, f.count * sizeof(int64_t));
    }

    // sequential depth-first build of one subtree
    void build(std::vector<Frame> &stack) {
        while (!stack.empty()) {
            Frame f = stack.back();
            stack.pop_back();
            int32_t me = alloc_node();
            if (f.patch >= 0) node_meta[3 * f.patch] = me;

            V3 blo = lo[f.idx[0]], bhi = hi[f.idx[0]];
            V3 clo = cent[f.idx[0]], chi = clo;
            for (int64_t i = 1; i < f.count; ++i) {
                blo = vmin(blo, lo[f.idx[i]]);
                bhi = vmax(bhi, hi[f.idx[i]]);
                clo = vmin(clo, cent[f.idx[i]]);
                chi = vmax(chi, cent[f.idx[i]]);
            }
            node_lo[3 * me] = blo.x;
            node_lo[3 * me + 1] = blo.y;
            node_lo[3 * me + 2] = blo.z;
            node_hi[3 * me] = bhi.x;
            node_hi[3 * me + 1] = bhi.y;
            node_hi[3 * me + 2] = bhi.z;

            if (f.count <= max_leaf) {
                emit_leaf(me, f, blo, bhi);
                continue;
            }

            V3 ext = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
            int axis = 0;
            float e = ext.x;
            if (ext.y > e) { axis = 1; e = ext.y; }
            if (ext.z > e) { axis = 2; e = ext.z; }
            const float *cptr = &cent[0].x;
            const float clo_a = (&clo.x)[axis];

            int64_t mid;
            if (e <= 1e-12f) {
                // degenerate centroids: equal-counts split
                mid = f.count / 2;
                std::nth_element(
                    f.idx, f.idx + mid, f.idx + f.count,
                    [&](int64_t a, int64_t b) {
                        return cptr[3 * a + axis] < cptr[3 * b + axis];
                    });
            } else {
                // 12-bucket binned SAH sweep (aggregates.cpp:278)
                float scale = N_BUCKETS / e;
                int64_t counts[N_BUCKETS] = {};
                V3 b_lo[N_BUCKETS], b_hi[N_BUCKETS];
                for (int k = 0; k < N_BUCKETS; ++k) {
                    b_lo[k] = {1e30f, 1e30f, 1e30f};
                    b_hi[k] = {-1e30f, -1e30f, -1e30f};
                }
                auto bucket_of = [&](int64_t p) {
                    int bk = (int)((cptr[3 * p + axis] - clo_a) * scale);
                    return bk < 0 ? 0 : (bk >= N_BUCKETS ? N_BUCKETS - 1 : bk);
                };
                for (int64_t i = 0; i < f.count; ++i) {
                    int64_t p = f.idx[i];
                    int bk = bucket_of(p);
                    counts[bk]++;
                    b_lo[bk] = vmin(b_lo[bk], lo[p]);
                    b_hi[bk] = vmax(b_hi[bk], hi[p]);
                }
                // forward/backward scans
                float a_l[N_BUCKETS - 1], a_r[N_BUCKETS - 1];
                int64_t c_l[N_BUCKETS - 1], c_r[N_BUCKETS - 1];
                {
                    V3 acc_lo = b_lo[0], acc_hi = b_hi[0];
                    int64_t cc = counts[0];
                    for (int k = 0; k < N_BUCKETS - 1; ++k) {
                        if (k) {
                            acc_lo = vmin(acc_lo, b_lo[k]);
                            acc_hi = vmax(acc_hi, b_hi[k]);
                            cc += counts[k];
                        }
                        a_l[k] = half_area(acc_lo, acc_hi);
                        c_l[k] = cc;
                    }
                    acc_lo = b_lo[N_BUCKETS - 1];
                    acc_hi = b_hi[N_BUCKETS - 1];
                    cc = counts[N_BUCKETS - 1];
                    for (int k = N_BUCKETS - 2; k >= 0; --k) {
                        if (k < N_BUCKETS - 2) {
                            acc_lo = vmin(acc_lo, b_lo[k + 1]);
                            acc_hi = vmax(acc_hi, b_hi[k + 1]);
                            cc += counts[k + 1];
                        }
                        a_r[k] = half_area(acc_lo, acc_hi);
                        c_r[k] = cc;
                    }
                }
                int split = -1;
                float best = 1e30f;
                for (int k = 0; k < N_BUCKETS - 1; ++k) {
                    if (c_l[k] == 0 || c_r[k] == 0) continue;
                    // 2x half_area == full area; constant factor cancels
                    float cost = 2.f * (a_l[k] * c_l[k] + a_r[k] * c_r[k]);
                    if (cost < best) { best = cost; split = k; }
                }
                if (split < 0) {
                    mid = f.count / 2;
                    std::nth_element(
                        f.idx, f.idx + mid, f.idx + f.count,
                        [&](int64_t a, int64_t b) {
                            return cptr[3 * a + axis] < cptr[3 * b + axis];
                        });
                } else {
                    auto it = std::partition(
                        f.idx, f.idx + f.count,
                        [&](int64_t p) { return bucket_of(p) <= split; });
                    mid = it - f.idx;
                    if (mid == 0 || mid == f.count) {
                        mid = f.count / 2;
                        std::nth_element(
                            f.idx, f.idx + mid, f.idx + f.count,
                            [&](int64_t a, int64_t b) {
                                return cptr[3 * a + axis] < cptr[3 * b + axis];
                            });
                    }
                }
            }

            node_meta[3 * me] = 0;       // patched by right child
            node_meta[3 * me + 1] = 0;   // interior
            node_meta[3 * me + 2] = axis;
            // push right first -> left is processed next (depth-first)
            stack.push_back({f.idx + mid, f.count - mid, me,
                             f.prim_base + mid});
            stack.push_back({f.idx, mid, -2, f.prim_base});
        }
    }
};

}  // namespace

extern "C" {

// Returns number of nodes written (node arrays must hold >= 2n entries),
// or -1 on invalid input.
int64_t nn_bvh_build_sah(const float *prim_lo, const float *prim_hi,
                         int64_t n, int32_t max_leaf,
                         float *node_lo, float *node_hi, int32_t *node_meta,
                         int64_t *prim_order) {
    if (n <= 0 || max_leaf < 1) return -1;
    Builder b;
    b.lo = reinterpret_cast<const V3 *>(prim_lo);
    b.hi = reinterpret_cast<const V3 *>(prim_hi);
    b.cent.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        b.cent[i] = {0.5f * (b.lo[i].x + b.hi[i].x),
                     0.5f * (b.lo[i].y + b.hi[i].y),
                     0.5f * (b.lo[i].z + b.hi[i].z)};
    }
    b.max_leaf = max_leaf;
    b.node_lo = node_lo;
    b.node_hi = node_hi;
    b.node_meta = node_meta;
    b.order = prim_order;

    std::vector<int64_t> scratch(n);
    for (int64_t i = 0; i < n; ++i) scratch[i] = i;
    std::vector<Builder::Frame> stack;
    stack.push_back({scratch.data(), n, -1, 0});
    b.build(stack);
    return b.n_nodes;
}

// Full-tree SAH cost of a flattened BVH (nn_loss.py:165 metric with
// C_inn/C_tri), for parity checks against the Python implementation.
double nn_bvh_sah_cost(const float *node_lo, const float *node_hi,
                       const int32_t *node_meta, int64_t n_nodes,
                       double c_trav, double c_isect) {
    double total = 0.0;
    const V3 *lo = reinterpret_cast<const V3 *>(node_lo);
    const V3 *hi = reinterpret_cast<const V3 *>(node_hi);
    for (int64_t i = 0; i < n_nodes; ++i) {
        double area = 2.0 * half_area(lo[i], hi[i]);
        int32_t count = node_meta[3 * i + 1];
        total += (count > 0) ? c_isect * count * area : c_trav * area;
    }
    double root = 2.0 * half_area(lo[0], hi[0]);
    return total / (root > 1e-20 ? root : 1e-20);
}

}  // extern "C"
