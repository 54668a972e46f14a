// Closest-sphere pass for Hopper: one thread per ray over at most 64
// analytic spheres, under a per-ray cap.
//
// Replaces: src/blink/kernels/sphere.py::_make_sphere_kernel (its
// pallas_call is in sphere_pass_pallas), which the pallas backend runs for
// the closest hit and for the occlusion test of every scene with spheres.
// The TPU kernel keeps the sphere table in SMEM and unrolls over it for a
// packet of rays; here each block loads the centres and radii once into a
// shared-memory table and each thread loops over it for its own ray.
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
// costs more than either, and so does each elementwise launch around it.
// The design keeps the loop off device memory and the launches few:
//   - each block copies the table into shared memory once, straight from
//     the scene's center (S, 3) and radius (S,) tensors, so the caller
//     builds no (S, 4) table (a launch of its own) first;
//   - a thread issues its ray's loads before the table copy and the
//     barrier, so the two trips to device memory overlap instead of
//     following each other;
//   - sphere_merge_launch (MERGE) also does the closest hit's merge with
//     the hit the ray came with (kernels/api.py's compare and three
//     selects, five launches) in its epilogue.
// A build with -DSPHERE_PASS_EMPTY launches the same grid with an empty
// body: the floor under any design (sphere_pass_ab.py, chip_smoke.py).
// Against the earlier build in one process (sphere_pass_ab.py, H100 80GB
// HBM3 at 700 W; PERF.md §6, row 8), at 65,536 rays and 8 spheres: the
// early ray loads took the kernel to 0.95x (0.0027 ms, of which 0.00095 ms
// is the empty launch's floor; 0.94x at 1,048,576 rays, 64% of the byte
// bound); reading center and radius in place left the kernel as it was
// and took the table's launch out of each call; the merge in the epilogue
// left the kernel within 1% and took a closest hit's sphere step from
// 0.0107 to 0.0028 ms of device time and from seven launches to one.

#include <cuda_runtime.h>

namespace {

constexpr float kTMax = 1e30f;  // kernels/types.py::T_MAX
constexpr int kThreads = 256;
constexpr int kMaxSpheres = 64;  // kernels/sphere.py::MAX_PALLAS_SPHERES

// jnp.minimum: NaN if either operand is NaN (fminf would drop it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

// The closest sphere of each ray under its cap t_in. MERGE false: t_out,
// prim_out get the sphere's t and index (T_MAX and 0 where none is nearer
// than the cap). MERGE true: t_in is the ray's best hit so far, with its
// kind_in and prim_in; where the sphere's t is below it, t_out, kind_out
// and prim_out get the sphere's t, kind_sphere and index, else t_in,
// kind_in and prim_in.
template <bool MERGE>
__global__ void __launch_bounds__(kThreads)
    sphere_pass_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_in,
                       const float* __restrict__ center,
                       const float* __restrict__ radius, int n_spheres,
                       const int* __restrict__ kind_in,
                       const int* __restrict__ prim_in, float* __restrict__ t_out,
                       int* __restrict__ kind_out, int* __restrict__ prim_out,
                       int kind_sphere, int n, float t_min) {
#ifdef SPHERE_PASS_EMPTY
  return;
#endif
  __shared__ float4 s_tab[kMaxSpheres];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  // The ray's loads, issued before the table's.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t_ray = 0.0f;
  int k_ray = 0, p_ray = 0;
  if (live) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    t_ray = t_in[i];
    if constexpr (MERGE) {
      k_ray = kind_in[i];
      p_ray = prim_in[i];
    }
  }
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) {
    s_tab[s] = make_float4(center[3 * s], center[3 * s + 1], center[3 * s + 2],
                           radius[s]);
  }
  __syncthreads();
  if (!live) return;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const float cap = nan_min(t_ray, kTMax);
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
  const float s_t = prim >= 0 ? best : kTMax;
  const int s_prim = prim >= 0 ? prim : 0;
  if constexpr (MERGE) {
    const bool nearer = s_t < t_ray;
    t_out[i] = nearer ? s_t : t_ray;
    kind_out[i] = nearer ? kind_sphere : k_ray;
    prim_out[i] = nearer ? s_prim : p_ray;
  } else {
    t_out[i] = s_t;
    prim_out[i] = s_prim;
  }
}

template <bool MERGE>
int launch(const float* o, const float* d, const float* t_in,
           const float* center, const float* radius, const int* kind_in,
           const int* prim_in, float* t_out, int* kind_out, int* prim_out,
           int n, int n_spheres, float t_min, int kind_sphere,
           cudaStream_t stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  sphere_pass_kernel<MERGE><<<blocks, kThreads, 0, stream>>>(
      o, d, t_in, center, radius, n_spheres, kind_in, prim_in, t_out, kind_out,
      prim_out, kind_sphere, n, t_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32 per-ray cap; center: (n_spheres, 3) f32
// and radius: (n_spheres,) f32, n_spheres <= 64; t_out: (n,) f32 and
// prim_out: (n,) i32, written. Returns cudaGetLastError().
extern "C" int sphere_pass_launch(const float* o, const float* d,
                                  const float* t_max, const float* center,
                                  const float* radius, float* t_out,
                                  int* prim_out, int n, int n_spheres,
                                  float t_min, cudaStream_t stream) {
  return launch<false>(o, d, t_max, center, radius, nullptr, nullptr, t_out,
                       nullptr, prim_out, n, n_spheres, t_min, 0, stream);
}

// The pass merged into a closest hit: t_in (n,) f32, kind_in and prim_in
// (n,) i32, the ray's best hit so far, read; t_out, kind_out and prim_out
// (n,) written with the nearer of it and the closest sphere (of kind
// kind_sphere). Other arguments as sphere_pass_launch's.
extern "C" int sphere_merge_launch(const float* o, const float* d,
                                   const float* t_in, const float* center,
                                   const float* radius, const int* kind_in,
                                   const int* prim_in, float* t_out,
                                   int* kind_out, int* prim_out, int n,
                                   int n_spheres, float t_min, int kind_sphere,
                                   cudaStream_t stream) {
  return launch<true>(o, d, t_in, center, radius, kind_in, prim_in, t_out,
                      kind_out, prim_out, n, n_spheres, t_min, kind_sphere,
                      stream);
}

// What the runtime reports of the kernel (merge 0: sphere_pass_launch's,
// 1: sphere_merge_launch's): out[0] registers a thread, out[1] local memory
// a thread in bytes, out[2] resident blocks an SM (the occupancy
// calculator's answer), out[3] threads a block. Returns a cudaError_t.
extern "C" int sphere_pass_attributes(int merge, int* out) {
  const void* f =
      merge ? reinterpret_cast<const void*>(&sphere_pass_kernel<true>)
            : reinterpret_cast<const void*>(&sphere_pass_kernel<false>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = kThreads;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], f, out[3], 0));
}
