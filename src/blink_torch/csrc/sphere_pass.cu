// Closest-sphere pass for Hopper: one thread per ray over at most 64
// analytic spheres, under a per-ray cap.
//
// Replaces: src/blink/kernels/sphere.py::_make_sphere_kernel (its
// pallas_call is in sphere_pass_pallas), which the pallas backend runs for
// the closest hit and for the occlusion test of every scene with spheres.
// The TPU kernel keeps the sphere table in SMEM and unrolls over it for a
// packet of rays; here each block loads the (S, 4) centre/radius table once
// into shared memory and each thread loops over it for its own ray.
//
// Arithmetic, kept identical to the plain torch version
// (kernels/sphere.py::sphere_pass_plain) and to the TPU kernel:
//   a = dx*dx + dy*dy + dz*dz, inv_a = 1/a once per ray; per sphere
//   half_b = ocx*dx + ocy*dy + ocz*dz, c = ocx*ocx + ocy*ocy + ocz*ocz - r*r,
//   disc = half_b*half_b - a*c, t0/t1 = (-half_b -/+ sqrt(disc)) * inv_a;
//   spheres in ascending order, a sphere wins where disc > 0,
//   t_min <= t <= cap and t < best (strict, so the first of tied minima
//   wins); T_MAX and prim 0 where none won.
// Build with -fmad=false -prec-div=true -prec-sqrt=true -ftz=false and
// without --use_fast_math (kernels/_build.py): a contracted multiply-add in
// half_b or c would move t by an ulp and could flip a winner at the
// t <= cap and t < best edges.
//
// What bounds it on the H100: bytes. A ray reads o, d and its cap (28 B)
// and writes t and prim (8 B); with 8 spheres it does about 25 FP32
// operations per sphere, far below the card's 67 TFLOP/s for its 36 B at
// 3.35 TB/s. At the 65,536 rays of a 256x256 frame the launch itself
// costs more than either. Nothing more is done about it: the table sits in
// shared memory so that the loop reads no device memory.

#include <cuda_runtime.h>

namespace {

constexpr float kTMax = 1e30f;  // kernels/types.py::T_MAX
constexpr int kThreads = 256;
constexpr int kMaxSpheres = 64;  // kernels/sphere.py::MAX_PALLAS_SPHERES

// jnp.minimum: NaN if either operand is NaN (fminf would drop it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__global__ void __launch_bounds__(kThreads)
    sphere_pass_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_max,
                       const float4* __restrict__ tab, int n_spheres,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       int n, float t_min) {
  __shared__ float4 s_tab[kMaxSpheres];
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) s_tab[s] = tab[s];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const float cap = nan_min(t_max[i], kTMax);
  float best = cap;
  int prim = -1;
  for (int s = 0; s < n_spheres; ++s) {
    const float4 sp = s_tab[s];
    const float ocx = ox - sp.x, ocy = oy - sp.y, ocz = oz - sp.z;
    const float half_b = ocx * dx + ocy * dy + ocz * dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - sp.w * sp.w;
    const float disc = half_b * half_b - a * c;
    const bool hit_disc = disc > 0.0f;
    const float sq = sqrtf(hit_disc ? disc : 1.0f);
    const float t0 = (-half_b - sq) * inv_a;
    const float t1 = (-half_b + sq) * inv_a;
    const float t = t0 >= t_min ? t0 : t1;
    if (hit_disc && t >= t_min && t <= cap && t < best) {
      best = t;
      prim = s;
    }
  }
  t_out[i] = prim >= 0 ? best : kTMax;
  prim_out[i] = prim >= 0 ? prim : 0;
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32 per-ray cap; tab: (n_spheres, 4) f32
// rows [cx cy cz r], 16-byte aligned, n_spheres <= 64; t_out: (n,) f32 and
// prim_out: (n,) i32, written. Returns cudaGetLastError().
extern "C" int sphere_pass(const float* o, const float* d, const float* t_max,
                           const float* tab, float* t_out, int* prim_out,
                           int n, int n_spheres, float t_min,
                           cudaStream_t stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  sphere_pass_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_max, reinterpret_cast<const float4*>(tab), n_spheres, t_out,
      prim_out, n, t_min);
  return static_cast<int>(cudaGetLastError());
}
