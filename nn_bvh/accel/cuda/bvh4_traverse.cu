// BVH4 ray traversal for NVIDIA Hopper, called from JAX through the XLA FFI.
//
// One thread per ray. Each thread walks the 4-wide BVH (accel/bvh4.py
// collapse, packed by accel/cuda_bvh4.py) with a private stack of
// (entry, entry distance) pairs in local memory, visiting hit children near
// to far. Closest-hit shrinks t and prunes popped entries whose entry
// distance is no longer below it; any-hit stops at its first hit.
//
// Semantics follow the XLA walk (accel/traverse.py): the same f32 slab test
// (far distance widened by 1.0000004) and the watertight triangle test of
// geometry/triangle.py with the same epsilons. Only the visiting order
// differs, so closest hits agree up to ties between equal distances.
// The kernel returns the hit primitive only; the wrapper computes the hit
// record (t, barycentrics) with geometry/triangle.py, the code the XLA walk
// uses, so both backends hand the renderer the same bits for the same hit.
//
// Node (32 f32 = 128 B): lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4]
// child[4] (i32 bits) pad[4]. child >= 0: interior node index;
// kEmpty: no child; otherwise leaf -(1 + offset * 16 + (count - 1)).
// Triangle (12 f32 = 48 B): p0.xyz, 0, p1.xyz, 0, p2.xyz, 0.
// Rays: one (7, R) f32 buffer, rows ox oy oz dx dy dz t_max.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStack = 128;      // must equal cuda_bvh4.STACK_DEPTH
constexpr int kBlock = 128;      // threads per block
constexpr int kEmpty = INT32_MIN;

// XLA lowers f32 1/x to rcp.approx.f32 on this target and emits no fused
// multiply-adds (the library is built with -fmad=false); mirroring both keeps
// the kernel's hit decisions on the same bits as the XLA walk's.
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sel3(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}

struct Ray {
  float ox, oy, oz;
  float ix, iy, iz;        // clamped reciprocal direction (slab test)
  int kx, ky, kz;          // watertight axis permutation
  float sx, sy, sz;        // watertight shear
  float opx, opy, opz;     // origin, permuted
};

__device__ __forceinline__ float safe_inv(float c) {
  // traverse._traverse_one: |d| < 1e-20 -> +-1e-20 (d == -0 counts as +)
  float s = fabsf(c) < 1e-20f ? (c < 0.f ? -1e-20f : 1e-20f) : c;
  return rcp(s);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  // jnp.argmax: first index of the maximum
  int kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  int kx = kz == 2 ? 0 : kz + 1;
  int ky = kx == 2 ? 0 : kx + 1;
  r.kx = kx; r.ky = ky; r.kz = kz;
  float dpx = sel3(dx, dy, dz, kx);
  float dpy = sel3(dx, dy, dz, ky);
  float dpz = sel3(dx, dy, dz, kz);
  float inv_dz = rcp(dpz);
  r.sx = -dpx * inv_dz;
  r.sy = -dpy * inv_dz;
  r.sz = inv_dz;
  r.opx = sel3(ox, oy, oz, kx);
  r.opy = sel3(ox, oy, oz, ky);
  r.opz = sel3(ox, oy, oz, kz);
  return r;
}

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 to_ray_space(const Ray& r, float4 p) {
  // translate, permute, shear (geometry/triangle.py intersect)
  float px = sel3(p.x, p.y, p.z, r.kx) - r.opx;
  float py = sel3(p.x, p.y, p.z, r.ky) - r.opy;
  float pz = sel3(p.x, p.y, p.z, r.kz) - r.opz;
  return V3{px + r.sx * pz, py + r.sy * pz, pz};
}

__device__ __forceinline__ void edge(V3 a, V3 b, float& e, float& tol) {
  e = a.x * b.y - a.y * b.x;
  tol = 4e-7f * (fabsf(a.x * b.y) + fabsf(a.y * b.x));
}

// Watertight test against one triangle; on a hit below t_max writes t.
__device__ __forceinline__ bool tri_hit(const Ray& r, const float4* tri,
                                        float t_max, float& t_out) {
  V3 p0 = to_ray_space(r, __ldg(tri + 0));
  V3 p1 = to_ray_space(r, __ldg(tri + 1));
  V3 p2 = to_ray_space(r, __ldg(tri + 2));
  float e0, e1, e2, tol0, tol1, tol2;
  edge(p1, p2, e0, tol0);
  edge(p2, p0, e1, tol1);
  edge(p0, p1, e2, tol2);
  bool same_side = (e0 >= -tol0 && e1 >= -tol1 && e2 >= -tol2) ||
                   (e0 <= tol0 && e1 <= tol1 && e2 <= tol2);
  float det = e0 + e1 + e2;
  if (!same_side || det == 0.f) return false;
  float ts = e0 * p0.z * r.sz + e1 * p1.z * r.sz + e2 * p2.z * r.sz;
  bool pos = det > 0.f && ts > 0.f && ts < t_max * det;
  bool neg = det < 0.f && ts < 0.f && ts > t_max * det;
  if (!(pos || neg)) return false;
  float t = ts * rcp(det);
  if (!isfinite(t)) return false;
  t_out = t;
  return true;
}

// Slab test of one child box (traverse._slab); returns the entry distance,
// or +inf on a miss.
__device__ __forceinline__ float slab(const Ray& r, float t, float lox,
                                      float loy, float loz, float hix,
                                      float hiy, float hiz) {
  float t0x = (lox - r.ox) * r.ix, t1x = (hix - r.ox) * r.ix;
  float t0y = (loy - r.oy) * r.iy, t1y = (hiy - r.oy) * r.iy;
  float t0z = (loz - r.oz) * r.iz, t1z = (hiz - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fmaxf(t0z, t1z)) * 1.0000004f;
  bool hit = tn <= tf && tf > 0.f && tn < t;
  return hit ? tn : INFINITY;
}

__device__ __forceinline__ void cswap(float& ka, int& ma, float& kb, int& mb) {
  if (ka > kb) {
    float k = ka; ka = kb; kb = k;
    int m = ma; ma = mb; mb = m;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
bvh4_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
            const float* __restrict__ rays, int64_t n_rays,
            int32_t* __restrict__ prim_out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  float t = rays[6 * n_rays + i];
  int32_t prim = -1;
  if (t > 0.f) {
    Ray r = make_ray(rays[i], rays[n_rays + i], rays[2 * n_rays + i],
                     rays[3 * n_rays + i], rays[4 * n_rays + i],
                     rays[5 * n_rays + i]);
    int st_e[kStack];
    float st_t[kStack];
    int sp = 1;
    st_e[0] = 0;
    st_t[0] = -INFINITY;
    while (sp > 0) {
      --sp;
      int e = st_e[sp];
      if (!(st_t[sp] < t)) continue;  // box now behind the closest hit
      if (e >= 0) {
        const float4* n = nodes + 8 * static_cast<int64_t>(e);
        float4 lx = __ldg(n + 0), ly = __ldg(n + 1), lz = __ldg(n + 2);
        float4 hx = __ldg(n + 3), hy = __ldg(n + 4), hz = __ldg(n + 5);
        int4 ch = __ldg(reinterpret_cast<const int4*>(n + 6));
        float k0 = slab(r, t, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x);
        float k1 = slab(r, t, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y);
        float k2 = slab(r, t, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z);
        float k3 = slab(r, t, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w);
        int m0 = ch.x, m1 = ch.y, m2 = ch.z, m3 = ch.w;
        if (m0 == kEmpty) k0 = INFINITY;
        if (m1 == kEmpty) k1 = INFINITY;
        if (m2 == kEmpty) k2 = INFINITY;
        if (m3 == kEmpty) k3 = INFINITY;
        // ascending by entry distance; push far first so the nearest pops next
        cswap(k0, m0, k1, m1);
        cswap(k2, m2, k3, m3);
        cswap(k0, m0, k2, m2);
        cswap(k1, m1, k3, m3);
        cswap(k1, m1, k2, m2);
        if (k3 < INFINITY && sp < kStack) { st_e[sp] = m3; st_t[sp] = k3; ++sp; }
        if (k2 < INFINITY && sp < kStack) { st_e[sp] = m2; st_t[sp] = k2; ++sp; }
        if (k1 < INFINITY && sp < kStack) { st_e[sp] = m1; st_t[sp] = k1; ++sp; }
        if (k0 < INFINITY && sp < kStack) { st_e[sp] = m0; st_t[sp] = k0; ++sp; }
      } else {
        int u = -e - 1;
        int off = u >> 4;
        int cnt = (u & 15) + 1;
        bool done = false;
        for (int j = 0; j < cnt; ++j) {
          float th;
          // strict th < t as in the XLA walk's leaf update
          if (tri_hit(r, tris + 3 * static_cast<int64_t>(off + j), t, th) &&
              th < t) {
            t = th;
            prim = off + j;
            if (kAnyHit) { done = true; break; }
          }
        }
        if (done) break;
      }
    }
  }
  prim_out[i] = prim;
}

template <bool kAnyHit>
ffi::Error Bvh4Impl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> rays,
                    ffi::ResultBuffer<ffi::S32> prim) {
  auto rd = rays.dimensions();
  auto nd = nodes.dimensions();
  auto td = tris.dimensions();
  if (rd.size() != 2 || rd[0] != 7)
    return ffi::Error::InvalidArgument("rays must be (7, R) f32");
  if (nd.size() != 2 || nd[1] != 32)
    return ffi::Error::InvalidArgument("nodes must be (W, 32) f32");
  if (td.size() != 2 || td[1] != 12)
    return ffi::Error::InvalidArgument("triangles must be (N, 12) f32");
  int64_t n_rays = rd[1];
  if (n_rays == 0) return ffi::Error::Success();
  int64_t blocks = (n_rays + kBlock - 1) / kBlock;
  bvh4_kernel<kAnyHit><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), rays.typed_data(),
      n_rays, prim->typed_data());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

#define NN_BVH_BIND                                    \
  ffi::Ffi::Bind()                                     \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()        \
      .Arg<ffi::Buffer<ffi::F32>>()                    \
      .Arg<ffi::Buffer<ffi::F32>>()                    \
      .Arg<ffi::Buffer<ffi::F32>>()                    \
      .Ret<ffi::Buffer<ffi::S32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(NnBvhBvh4Closest, Bvh4Impl<false>, NN_BVH_BIND);
XLA_FFI_DEFINE_HANDLER_SYMBOL(NnBvhBvh4Any, Bvh4Impl<true>, NN_BVH_BIND);
