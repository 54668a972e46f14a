// Wide-BVH walk for Hopper: closest hit and any hit over one quantized
// 8-wide BVH chunk, one thread per ray.
//
// Replaces: src/blink/kernels/traverse_pallas.py::_make_kernel_wide with
// quant=True, leaf_mode='group' (any_hit=False and any_hit=True), reached
// through _traverse_wide_packed. The TPU kernel walks a 4096-ray packet
// with one scalar cursor, because the TPU has no per-lane gathers; here
// each ray walks with its own stack and takes its child order from its own
// direction octant. Child order changes only which of two exactly tied
// triangles wins.
//
// Arithmetic, kept identical to the plain torch version
// (kernels/traverse_wide.py) and to the TPU kernel:
//   - child boxes decode as o + q*s with a rounded multiply, then a rounded
//     add (__fmul_rn/__fadd_rn, never a fused multiply-add): the host's
//     conservative-box check (bvh/wide.py::_quantize_children) used that
//     arithmetic, and a fused decode can move a bound inwards by one ulp;
//   - the slab test propagates NaN as jnp.minimum/maximum do (fminf/fmaxf
//     drop it), then reads a NaN near as -inf and a NaN far as +inf;
//   - Möller–Trumbore with an exact 1/det, det == 0 degenerate, t in
//     [t_min, t_max], then a strict t < best merge in slot order;
//   - any hit: a hit exactly at t_far does not block.
// Build with -fmad=false -prec-div=true -prec-sqrt=true -ftz=false and
// without --use_fast_math (kernels/_build.py), so that the remaining plain
// expressions round like the plain torch version.
//
// What bounds it on the H100: the FP32 work of the slab tests (8 per node
// pop) and the triangle tests, and the scattered reads of 96-byte node
// records and 48-byte triangle records. All tables stay in global memory:
// one chunk's node tables (~0.5 MB at 1M triangles) do not fit the 227 KB
// of shared memory a block may use, and the three chunks of the 1M-triangle
// scene (~45 MB) fit the 50 MB L2. Nothing more is done about it in this
// first version: no shared-memory staging, no packet or warp-cooperative
// traversal, no persistent threads.

#include <cuda_runtime.h>
#include <stdint.h>

#define WIDE_STACK_CAP 192  // bvh/wide.py::WIDE_STACK_CAP

namespace {

constexpr float kTMax = 1e30f;  // kernels/types.py::T_MAX
constexpr int kThreads = 128;

__device__ __forceinline__ float dequant(float o, int q, float s) {
  return __fadd_rn(o, __fmul_rn(static_cast<float>(q), s));
}

// jnp.minimum / jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ bool slab(float ox, float oy, float oz, float ix,
                                     float iy, float iz, float t_min,
                                     float t_max, float lx, float ly, float lz,
                                     float hx, float hy, float hz) {
  const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
  const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
  const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
  float near = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                       nan_min(t0z, t1z));
  float far = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                      nan_max(t0z, t1z));
  if (near != near) near = -INFINITY;
  if (far != far) far = INFINITY;
  return nan_max(near, t_min) <= nan_min(far, t_max);
}

// Möller–Trumbore as kernels/triangle.py::triangle_tuv; kTMax on a miss.
__device__ __forceinline__ float tri_t(float ox, float oy, float oz, float dx,
                                       float dy, float dz, const float4* rec,
                                       float t_min, float t_max) {
  const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool degen = det == 0.0f;
  const float inv = 1.0f / (degen ? 1.0f : det);
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool valid = !degen && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                     t >= t_min && t <= t_max;
  return valid ? t : kTMax;
}

// Closest hit: t/prim hold the best so far (threaded across chunks) and are
// updated where this chunk has a nearer hit. Any hit: t_in is t_far,
// blocked is set where a hit lies in [t_min, min(t_far, T_MAX)); rays
// already blocked by an earlier chunk do no work.
template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads)
    wide_walk(const float* __restrict__ o, const float* __restrict__ d,
              float* __restrict__ t_io, int* __restrict__ prim,
              bool* __restrict__ blocked, const int* __restrict__ child,
              const float* __restrict__ nbox, const int* __restrict__ perm,
              const float4* __restrict__ tri, const int* __restrict__ tri_id,
              int n, float t_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (ANY_HIT && blocked[i]) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const int octant = (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0) |
                     (dz >= 0.0f ? 4 : 0);
  float best = ANY_HIT ? nan_min(t_io[i], kTMax) : t_io[i];
  int best_slot = -1;

  int stack[WIDE_STACK_CAP];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    const int pm = __ldg(perm + node * 8 + octant);
    const float* nb = nbox + node * 8;
    const float nox = __ldg(nb), noy = __ldg(nb + 1), noz = __ldg(nb + 2);
    const float nsx = __ldg(nb + 3), nsy = __ldg(nb + 4), nsz = __ldg(nb + 5);
    int ref[8], cnt[8];
    unsigned need = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // near-first order of this octant
      const int c8 = (pm >> (3 * k)) & 7;
      const int* w = child + (node * 8 + c8) * 3;
      const int w0 = __ldg(w), w1 = __ldg(w + 1);
      ref[k] = __ldg(w + 2);
      cnt[k] = w0 >> 24;
      const bool hit = slab(
          ox, oy, oz, ix, iy, iz, t_min, best,
          dequant(nox, w0 & 255, nsx), dequant(noy, (w0 >> 8) & 255, nsy),
          dequant(noz, (w0 >> 16) & 255, nsz), dequant(nox, w1 & 255, nsx),
          dequant(noy, (w1 >> 8) & 255, nsy),
          dequant(noz, (w1 >> 16) & 255, nsz));
      need |= (hit ? 1u : 0u) << k;
    }
    // Leaf children, tested at the parent's pop, in near-first order.
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!((need >> k) & 1u) || cnt[k] <= 0) continue;
      for (int s = ref[k]; s < ref[k] + cnt[k]; ++s) {
        const float t =
            tri_t(ox, oy, oz, dx, dy, dz, tri + 3 * s, t_min, best);
        if (t < best) {
          if (ANY_HIT) {
            blocked[i] = true;
            return;
          }
          best = t;
          best_slot = s;
        }
      }
    }
    // Internal children, pushed far to near so the nearest pops first.
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      if (((need >> k) & 1u) && cnt[k] == 0 && ref[k] > 0) stack[sp++] = ref[k];
    }
  }
  if (!ANY_HIT && best_slot >= 0) {
    t_io[i] = best;
    prim[i] = __ldg(tri_id + best_slot);
  }
}

template <bool ANY_HIT>
int launch(const float* o, const float* d, float* t_io, int* prim,
           bool* blocked, const int* child, const float* nbox, const int* perm,
           const float* tri, const int* tri_id, int n, float t_min,
           cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  wide_walk<ANY_HIT><<<blocks, kThreads, 0, stream>>>(
      o, d, t_io, prim, blocked, child, nbox, perm,
      reinterpret_cast<const float4*>(tri), tri_id, n, t_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o, d: (n, 3) f32; t: (n,) f32 best t, in/out; prim: (n,) i32, in/out;
// child: (n_wide*24,) i32; nbox, perm: (n_wide*8,); tri: (P, 12) f32 with
// 16-byte-aligned rows; tri_id: (P,) i32. Returns cudaGetLastError().
extern "C" int wide_closest(const float* o, const float* d, float* t, int* prim,
                            const int* child, const float* nbox,
                            const int* perm, const float* tri,
                            const int* tri_id, int n, float t_min,
                            cudaStream_t stream) {
  return launch<false>(o, d, t, prim, nullptr, child, nbox, perm, tri, tri_id,
                       n, t_min, stream);
}

// As wide_closest, with t_far: (n,) f32 and blocked: (n,) bool, in/out.
extern "C" int wide_anyhit(const float* o, const float* d, const float* t_far,
                           bool* blocked, const int* child, const float* nbox,
                           const int* perm, const float* tri,
                           const int* tri_id, int n, float t_min,
                           cudaStream_t stream) {
  return launch<true>(o, d, const_cast<float*>(t_far), nullptr, blocked, child,
                      nbox, perm, tri, tri_id, n, t_min, stream);
}
