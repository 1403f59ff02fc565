// Per-ray threaded-BVH traversal for NVIDIA GPUs, called from JAX
// through the XLA foreign function interface (ops/traverse_cuda.py).
//
// The same skip-link walk as ops/traverse.py:trace_gather, over the same
// packed tables (scene/flatten.py:GeometryData):
//   nodes (N, 8) f32: [min xyz | max xyz | bitcast(skip) | bitcast(leafbits)]
//   tris  (T, 12) f32: [p0 xyz | e1 xyz | e2 xyz | bitcast(mat) | pad | pad]
//   node_inst (N,) i32 and inst_inv (I, 3, 4) f32 for two-level scenes.
// One thread walks one ray with its whole state in registers and leaves
// the loop when its own ray is done; rows are read as float4 through the
// read-only path. The arithmetic mirrors trace_gather term by term and is
// compiled without multiply-add contraction, so the two round alike.
//
// Build: see ops/traverse_cuda.py (nvcc -gencode arch=compute_90a,
// code=sm_90a -shared into <repo>/build/).
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kInf = 1e30f;
constexpr float kEps = 1e-7f;
constexpr float kBoxShrink = 1.0f - 4e-7f;
constexpr float kBoxGrow = 1.0f + 4e-7f;
constexpr int kLeafMask = (1 << 24) - 1;
constexpr int kMaxLeaf = 4;  // geometry/bvh.py build, ops/traverse.MAX_LEAF
constexpr int kBlock = 128;

__device__ __forceinline__ float SafeInv(float d) {
  const float dd = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / dd;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray MakeRay(float ox, float oy, float oz,
                                       float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, SafeInv(dx), SafeInv(dy), SafeInv(dz)};
}

template <bool kAnyHit, bool kInstanced>
__global__ void __launch_bounds__(kBlock)
TraceKernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
            const int32_t* __restrict__ node_inst,
            const float4* __restrict__ inst_inv,
            const float* __restrict__ origin,
            const float* __restrict__ direction,
            const float* __restrict__ t_max, int64_t n_rays,
            float* __restrict__ out_t, int32_t* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float wox = origin[3 * r], woy = origin[3 * r + 1],
              woz = origin[3 * r + 2];
  const float wdx = direction[3 * r], wdy = direction[3 * r + 1],
              wdz = direction[3 * r + 2];
  const Ray world = MakeRay(wox, woy, woz, wdx, wdy, wdz);
  Ray ray = world;
  int cur_inst = -1;

  float best_t = fminf(t_max[r], kInf);
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  // A ray with t_max <= 0 (a dead lane) can record no hit (hits need
  // t > kEps), so it skips the walk; the outputs are the same.
  int node = best_t > 0.0f ? 0 : -1;

  while (node >= 0) {
    const float4 a = __ldg(&nodes[2 * node]);
    const float4 b = __ldg(&nodes[2 * node + 1]);
    const int skip = __float_as_int(b.z);
    const int leafbits = __float_as_int(b.w);

    if (kInstanced) {
      const int inst = __ldg(&node_inst[node]);
      if (inst != cur_inst) {
        cur_inst = inst;
        if (inst < 0) {
          ray = world;
        } else {
          const float4 m0 = __ldg(&inst_inv[3 * inst]);
          const float4 m1 = __ldg(&inst_inv[3 * inst + 1]);
          const float4 m2 = __ldg(&inst_inv[3 * inst + 2]);
          ray = MakeRay(m0.x * wox + m0.y * woy + m0.z * woz + m0.w,
                        m1.x * wox + m1.y * woy + m1.z * woz + m1.w,
                        m2.x * wox + m2.y * woy + m2.z * woz + m2.w,
                        m0.x * wdx + m0.y * wdy + m0.z * wdz,
                        m1.x * wdx + m1.y * wdy + m1.z * wdz,
                        m2.x * wdx + m2.y * wdy + m2.z * wdz);
        }
      }
    }

    // slab test against the current best t
    const float t0x = (a.x - ray.ox) * ray.ix, t1x = (a.w - ray.ox) * ray.ix;
    const float t0y = (a.y - ray.oy) * ray.iy, t1y = (b.x - ray.oy) * ray.iy;
    const float t0z = (a.z - ray.oz) * ray.iz, t1z = (b.y - ray.oz) * ray.iz;
    const float t_near =
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)) *
        kBoxShrink;
    const float t_far =
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) *
        kBoxGrow;
    const bool hit_box = fmaxf(t_near, 0.0f) <= fminf(t_far, best_t);

    if (hit_box && leafbits >= 0) {
      const int first = leafbits & kLeafMask;
      const int count = min(leafbits >> 24, kMaxLeaf);
      for (int k = 0; k < count; ++k) {
        const int tid = first + k;
        const float4 r0 = __ldg(&tris[3 * tid]);
        const float4 r1 = __ldg(&tris[3 * tid + 1]);
        const float4 r2 = __ldg(&tris[3 * tid + 2]);
        // Moller-Trumbore against [p0 | e1 | e2]
        const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
        const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
        const float px = ray.dy * e2z - ray.dz * e2y;
        const float py = ray.dz * e2x - ray.dx * e2z;
        const float pz = ray.dx * e2y - ray.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok_det = fabsf(det) > 1e-12f;
        const float inv_det = ok_det ? 1.0f / det : 0.0f;
        const float tx = ray.ox - r0.x, ty = ray.oy - r0.y, tz = ray.oz - r0.z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool hit = ok_det && u >= -kEps && v >= -kEps &&
                         u + v <= 1.0f + kEps && t > kEps;
        if (hit && t < best_t) {
          best_t = t;
          best_tri = tid;
          best_u = u;
          best_v = v;
        }
      }
      if (kAnyHit && best_tri >= 0) break;
    }
    node = (hit_box && leafbits < 0) ? -leafbits - 2 : skip;
  }

  out_t[r] = best_t;
  out_tri[r] = best_tri;
  out_u[r] = best_u;
  out_v[r] = best_v;
}

template <bool kAnyHit, bool kInstanced>
void Launch(cudaStream_t stream, int64_t n, const float* nodes,
            const float* tris, const int32_t* node_inst, const float* inst_inv,
            const float* origin, const float* direction, const float* t_max,
            float* t, int32_t* tri, float* u, float* v) {
  const int64_t grid = (n + kBlock - 1) / kBlock;
  TraceKernel<kAnyHit, kInstanced><<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), node_inst,
      reinterpret_cast<const float4*>(inst_inv), origin, direction, t_max, n,
      t, tri, u, v);
}

ffi::Error TraceImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                     ffi::Buffer<ffi::F32> tris,
                     ffi::Buffer<ffi::S32> node_inst,
                     ffi::Buffer<ffi::F32> inst_inv,
                     ffi::Buffer<ffi::F32> origin,
                     ffi::Buffer<ffi::F32> direction,
                     ffi::Buffer<ffi::F32> t_max,
                     ffi::ResultBuffer<ffi::F32> out_t,
                     ffi::ResultBuffer<ffi::S32> out_tri,
                     ffi::ResultBuffer<ffi::F32> out_u,
                     ffi::ResultBuffer<ffi::F32> out_v, int32_t any_hit,
                     int32_t instanced) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (nodes.element_count() % 8 != 0 || tris.element_count() % 12 != 0 ||
      inst_inv.element_count() % 12 != 0) {
    return ffi::Error::InvalidArgument(
        "cadrays_trace: nodes must be (N, 8), tris (T, 12), inst_inv (I, 3, 4)");
  }
  if (origin.element_count() != static_cast<size_t>(3 * n) ||
      direction.element_count() != static_cast<size_t>(3 * n) ||
      out_t->element_count() != static_cast<size_t>(n)) {
    return ffi::Error::InvalidArgument(
        "cadrays_trace: origin/direction must be (R, 3) and t_max (R,)");
  }
  if (n == 0) return ffi::Error::Success();
  auto* launch = any_hit ? (instanced ? &Launch<true, true> : &Launch<true, false>)
                         : (instanced ? &Launch<false, true> : &Launch<false, false>);
  launch(stream, n, nodes.typed_data(), tris.typed_data(),
         node_inst.typed_data(), inst_inv.typed_data(), origin.typed_data(),
         direction.typed_data(), t_max.typed_data(), out_t->typed_data(),
         out_tri->typed_data(), out_u->typed_data(), out_v->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("cadrays_trace launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CadraysTrace, TraceImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::S32>>()  // node_inst
                                  .Arg<ffi::Buffer<ffi::F32>>()  // inst_inv
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origin
                                  .Arg<ffi::Buffer<ffi::F32>>()  // direction
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
                                  .Attr<int32_t>("any_hit")
                                  .Attr<int32_t>("instanced"));
