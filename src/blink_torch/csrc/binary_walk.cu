// Binary-BVH walks for Hopper: closest hit and any hit over one flat binary
// BVH (or one chunk of a chunked scene), one thread per ray. Two templates,
// four entry points:
//
//   skip_walk<ANY_HIT>     replaces src/blink/kernels/traverse_pallas.py::
//                          _make_kernel (the skip-link walk), closest and
//                          any hit;
//   ordered_walk<ANY_HIT>  replaces _make_kernel_ordered (closest and any
//                          hit) and _make_kernel_ordered_rg (closest hit),
//                          which compute the same function.
// All three TPU kernels reach pallas_call in _traverse_pallas.
//
// The TPU kernels walk a 4096-ray packet with one scalar cursor (or one
// scalar stack), entering a node if any ray of the packet needs it, because
// the TPU cannot index lanes dynamically. Here each ray walks alone:
//   - skip: node = need ? node+1 : skip[node], from the root until node ==
//     n_nodes; no stack;
//   - ordered: pop a node; a needed internal node is replaced on the stack
//     by its far child with the near child on top (STACK_CAP = 64 entries
//     in local memory; the host checks the tree's depth against it). The
//     near child is the left one iff (d[axis] >= 0) XOR !lower_first, from
//     the ray's own direction: the TPU kernel takes the sign of the sum of
//     d over its packet. The order only decides which of two exactly tied
//     triangles wins.
//   - _make_kernel_ordered_rg's row groups cull leaf tests for 8-row
//     sub-packets that do not need the leaf. A thread per ray tests a leaf
//     only when its own ray needs it, so it has nothing to cull: the row
//     groups have no counterpart here.
//
// Arithmetic, kept identical to the plain torch version
// (kernels/traverse_packed.py) and to wide_walk.cu:
//   - the slab test propagates NaN as jnp.minimum/maximum do, then reads a
//     NaN near as -inf and a NaN far as +inf;
//   - Möller–Trumbore with an exact 1/det, det == 0 degenerate, t in
//     [t_min, t_max], then a strict t < best merge in slot order;
//   - best starts at min(t_far, T_MAX), so a hit exactly at t_far does not
//     count; any hit stops at its first hit.
// Build with -fmad=false -prec-div=true -prec-sqrt=true -ftz=false and
// without --use_fast_math (kernels/_build.py).
//
// What bounds it on the H100. Not the FP32 work of the slab and triangle
// tests, nor the bytes: the tables stay in global memory (a 120,000-
// triangle chunk's are ~8 MB, the 50 MB L2 holds several chunks) and each
// call reads them at a few percent of the card's rate. A walk waits on
// chains of dependent loads (a node's record, then its slab test, then the
// next node's address) and on lanes that diverge: a ray's walk is a chain
// of some 80 node visits and 80 triangle tests on config 2. Both walks are
// designed against that (below): the leaf is lane state in one loop, so a
// lane at a leaf no longer holds its warp's other lanes in a leaf loop of
// its own, and a leaf's records are loaded a batch at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_CAP 64  // kernels/traverse_packed.py::STACK_CAP

namespace {

constexpr float kTMax = 1e30f;  // kernels/types.py::T_MAX
constexpr int kThreads = 128;

// jnp.minimum / jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ bool slab(float ox, float oy, float oz, float ix,
                                     float iy, float iz, float t_min,
                                     float t_max, float4 lo, float4 hi) {
  const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  float near = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                       nan_min(t0z, t1z));
  float far = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                      nan_max(t0z, t1z));
  if (near != near) near = -INFINITY;
  if (far != far) far = INFINITY;
  return nan_max(near, t_min) <= nan_min(far, t_max);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int i) {
  Ray r;
  r.ox = o[3 * i], r.oy = o[3 * i + 1], r.oz = o[3 * i + 2];
  r.dx = d[3 * i], r.dy = d[3 * i + 1], r.dz = d[3 * i + 2];
  r.ix = 1.0f / r.dx, r.iy = 1.0f / r.dy, r.iz = 1.0f / r.dz;
  return r;
}

// ---------------------------------------------------------------------------
// skip_walk: the skip-link walk, redesigned for Hopper. Each ray makes the
// plain walk's node visits and triangle tests in the plain walk's order
// (kernels/traverse_packed.py::skip_walk_plain); what the design changes is
// how a warp's lanes share its turns and when a leaf's loads are issued:
//   - a leaf is lane state, the slots [s, e) still to test, and the walk is
//     one loop: each turn is, lane by lane, one node step or one leaf
//     batch, so a lane that reaches a leaf no longer holds the warp's other
//     lanes in a leaf loop of their own;
//   - a leaf batch loads kBatch records together, each load predicated on
//     the leaf's end, then tests them in slot order against the running
//     best t, so a leaf's second load does not wait on its first test.
// kBatch = 2 was the fastest of 1, 2, 3, 4 and 8 (PERF.md §6): each
// record held in registers costs nine of them, and above 2 the registers
// cost more warps an SM than the loads in flight gave back. Issuing node
// cur + 1's loads with node cur's slab test, and stepping a warp's lanes
// in order of their position, were slower and are not done.
constexpr int kBatch = 2;

// A build with -DBINARY_WALK_COUNTS (kernels/traverse_packed.py::
// walk_counts) counts each ray's node visits
// (the ordered walk's pops) and triangle tests, and each warp's turns of
// each kind (node step, leaf batch) and the lanes that take part in them
// (__activemask, as the warp runs them).
#ifdef BINARY_WALK_COUNTS
// Per-ray (visits, tests) and per-warp (turns, lanes) counters, each (n,)
// or (ceil(n / 32),) int64, or null when not counting.
__device__ long long* g_walk_visits = nullptr;
__device__ long long* g_walk_tests = nullptr;
__device__ long long* g_walk_turns = nullptr;
__device__ long long* g_walk_lanes = nullptr;
#define WALK_COUNT(counter, i, v) \
  if (counter) counter[i] += (v)
// One warp turn of the branch that the calling lanes run together.
#define WALK_COUNT_TURN(i)                                      \
  {                                                             \
    const unsigned m = __activemask();                          \
    if ((threadIdx.x & 31) == __ffs(static_cast<int>(m)) - 1) { \
      WALK_COUNT(g_walk_turns, (i) >> 5, 1);                    \
      WALK_COUNT(g_walk_lanes, (i) >> 5, __popc(m));            \
    }                                                           \
  }
#else
#define WALK_COUNT(counter, i, v)
#define WALK_COUNT_TURN(i)
#endif

// Möller–Trumbore as kernels/triangle.py::triangle_tuv on a record already
// in registers: a = (v0, e1.x), b = (e1.yz, e2.xy), c = e2.z; kTMax on a
// miss.
__device__ __forceinline__ float tri_t_rec(const Ray& r, float4 a, float4 b,
                                           float c, float t_min,
                                           float t_max) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool degen = det == 0.0f;
  const float inv = 1.0f / (degen ? 1.0f : det);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool valid = !degen && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                     t >= t_min && t <= t_max;
  return valid ? t : kTMax;
}

// One leaf batch of ray i: the records of slots [s, min(s + kBatch, e))
// loaded together, then tested in slot order against the running best t
// with a strict < merge; an any hit stops at its first hit. Advances s.
template <bool ANY_HIT>
__device__ __forceinline__ void leaf_batch(const Ray& r,
                                           const float4* __restrict__ tri,
                                           int i, float t_min, int& s, int e,
                                           float& best, int& best_slot,
                                           bool& hit) {
  float4 ra[kBatch], rb[kBatch];
  float rc[kBatch];  // e2.z, the only float of the third float4 read
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (s + j < e) {
      const float4* rec = tri + 3 * (s + j);
      ra[j] = __ldg(rec);
      rb[j] = __ldg(rec + 1);
      rc[j] = __ldg(reinterpret_cast<const float*>(rec + 2));
    }
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (s + j < e && !hit) {
      WALK_COUNT(g_walk_tests, i, 1);
      const float t = tri_t_rec(r, ra[j], rb[j], rc[j], t_min, best);
      if (t < best) {
        if (ANY_HIT) {
          hit = true;
        } else {
          best = t;
          best_slot = s + j;
        }
      }
    }
  }
  s += kBatch;
}

// box: (n_nodes, 8) f32 as float4 pairs (lo.xyz, 0), (hi.xyz, 0); node:
// (n_nodes, 8) i32 as int4 pairs (skip, first, count, rchild), (axis,
// lower_first, 0, 0). Closest hit: t_io/prim hold the best so far and are
// updated where this chunk has a nearer hit. Any hit: t_io is t_far, and
// blocked is set where a hit lies in [t_min, min(t_far, T_MAX)); rays
// already blocked by an earlier chunk do no work.
//
// __launch_bounds__'s floor of one block an SM changes no limit (the
// kernel fits 9 or more) but changes ptxas's choice: 56 registers instead
// of 48 (any hit) and 54 (closest); any hit ran 4-15% faster with it,
// closest within 3% either way (PERF.md §6).
template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads, 1)
    skip_walk(const float* __restrict__ o, const float* __restrict__ d,
              float* __restrict__ t_io, int* __restrict__ prim,
              bool* __restrict__ blocked, const float4* __restrict__ box,
              const int4* __restrict__ node, const float4* __restrict__ tri,
              const int* __restrict__ tri_id, int n, int n_nodes,
              float t_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || (ANY_HIT && blocked[i])) return;
  const Ray r = load_ray(o, d, i);
  float best = ANY_HIT ? nan_min(t_io[i], kTMax) : t_io[i];
  int best_slot = -1, cur = 0, s = 0, e = 0;
  bool hit = false;  // any hit: blocked in this chunk
  while (s < e || cur < n_nodes) {
    if (s < e) {
      WALK_COUNT_TURN(i);
      leaf_batch<ANY_HIT>(r, tri, i, t_min, s, e, best, best_slot, hit);
      if (hit) break;
    } else {
      WALK_COUNT_TURN(i);
      WALK_COUNT(g_walk_visits, i, 1);
      const int4 m = __ldg(node + 2 * cur);
      const bool need = slab(r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, t_min, best,
                             __ldg(box + 2 * cur), __ldg(box + 2 * cur + 1));
      if (need && m.z > 0) {
        s = m.y;
        e = s + m.z;
      }
      cur = need ? cur + 1 : m.x;
    }
  }
  if (ANY_HIT && hit) blocked[i] = true;
  if (!ANY_HIT && best_slot >= 0) {
    t_io[i] = best;
    prim[i] = __ldg(tri_id + best_slot);
  }
}

// ---------------------------------------------------------------------------
// ordered_walk: the ordered walk, redesigned for Hopper as skip_walk was.
// Each ray makes the plain walk's pops and triangle tests in the plain
// walk's order (kernels/traverse_packed.py::ordered_walk_plain). A lane's
// state is its stack and the leaf slots [s, e) still to test, and the walk
// is one loop: each turn is, lane by lane, one pop (a node step) or one
// leaf batch (leaf_batch, as skip_walk's). A node step loads both int4s of
// the node's 32-byte row together with its two box float4s, so the
// near/far choice waits on no second load; a needed internal node is
// replaced on the stack by its far child with the near child on top. The
// pops are the plain walk's: the near child is the left one iff
// (d[axis] >= 0) XOR !lower_first (-0.0 counts as positive), a leaf's slots
// are tested in order against the running best t with a strict < merge,
// and an any hit stops at its first hit. kBatch = 2 and the floor of one
// block an SM in __launch_bounds__ are skip_walk's, each measured again
// here; keeping the near child in a register (pushing the far child only)
// measured no faster and is not done (PERF.md §6).
template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads, 1)
    ordered_walk(const float* __restrict__ o, const float* __restrict__ d,
                 float* __restrict__ t_io, int* __restrict__ prim,
                 bool* __restrict__ blocked, const float4* __restrict__ box,
                 const int4* __restrict__ node,
                 const float4* __restrict__ tri,
                 const int* __restrict__ tri_id, int n, int n_nodes,
                 float t_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || (ANY_HIT && blocked[i])) return;
  const Ray r = load_ray(o, d, i);
  float best = ANY_HIT ? nan_min(t_io[i], kTMax) : t_io[i];
  int best_slot = -1, sp = 0, s = 0, e = 0;
  int stack[STACK_CAP];
  stack[sp++] = 0;
  bool hit = false;  // any hit: blocked in this chunk
  while (s < e || sp > 0) {
    if (s < e) {
      WALK_COUNT_TURN(i);
      leaf_batch<ANY_HIT>(r, tri, i, t_min, s, e, best, best_slot, hit);
      if (hit) break;
    } else {
      WALK_COUNT_TURN(i);
      WALK_COUNT(g_walk_visits, i, 1);
      const int cur = stack[--sp];
      const int4 m = __ldg(node + 2 * cur), m1 = __ldg(node + 2 * cur + 1);
      const bool need = slab(r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, t_min, best,
                             __ldg(box + 2 * cur), __ldg(box + 2 * cur + 1));
      if (need && m.z > 0) {
        s = m.y;
        e = s + m.z;
      } else if (need && m.w > 0) {
        const float da = m1.x == 0 ? r.dx : (m1.x == 1 ? r.dy : r.dz);
        const bool near_is_left = !(da >= 0.0f) != (m1.y != 0);  // -0 >= 0
        const int left = cur + 1, right = m.w;
        stack[sp++] = near_is_left ? right : left;  // far, popped last
        stack[sp++] = near_is_left ? left : right;  // near, popped next
      }
    }
  }
  if (ANY_HIT && hit) blocked[i] = true;
  if (!ANY_HIT && best_slot >= 0) {
    t_io[i] = best;
    prim[i] = __ldg(tri_id + best_slot);
  }
}

template <bool ORDERED, bool ANY_HIT>
int launch(const float* o, const float* d, float* t_io, int* prim,
           bool* blocked, const float* box, const int* node, const float* tri,
           const int* tri_id, int n, int n_nodes, float t_min,
           cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const float4* b = reinterpret_cast<const float4*>(box);
  const int4* m = reinterpret_cast<const int4*>(node);
  const float4* t = reinterpret_cast<const float4*>(tri);
  if (ORDERED) {
    ordered_walk<ANY_HIT><<<blocks, kThreads, 0, stream>>>(
        o, d, t_io, prim, blocked, b, m, t, tri_id, n, n_nodes, t_min);
  } else {
    skip_walk<ANY_HIT><<<blocks, kThreads, 0, stream>>>(
        o, d, t_io, prim, blocked, b, m, t, tri_id, n, n_nodes, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool ANY_HIT>
const void* kernel_of(int ordered) {
  return ordered ? reinterpret_cast<const void*>(&ordered_walk<ANY_HIT>)
                 : reinterpret_cast<const void*>(&skip_walk<ANY_HIT>);
}

}  // namespace

// o, d: (n, 3) f32; t: (n,) f32 best t, in/out; prim: (n,) i32, in/out;
// box: (n_nodes, 8) f32, node: (n_nodes, 8) i32, tri: (P, 12) f32, all
// 16-byte aligned; tri_id: (P,) i32. Return cudaGetLastError().
extern "C" int skip_closest(const float* o, const float* d, float* t,
                            int* prim, const float* box, const int* node,
                            const float* tri, const int* tri_id, int n,
                            int n_nodes, float t_min, cudaStream_t stream) {
  return launch<false, false>(o, d, t, prim, nullptr, box, node, tri,
                              tri_id, n, n_nodes, t_min, stream);
}

extern "C" int ordered_closest(const float* o, const float* d, float* t,
                               int* prim, const float* box, const int* node,
                               const float* tri, const int* tri_id, int n,
                               int n_nodes, float t_min, cudaStream_t stream) {
  return launch<true, false>(o, d, t, prim, nullptr, box, node, tri,
                              tri_id, n, n_nodes, t_min, stream);
}

// As the closest-hit entry points, with t_far: (n,) f32 and blocked: (n,)
// bool, in/out.
extern "C" int skip_anyhit(const float* o, const float* d, const float* t_far,
                           bool* blocked, const float* box, const int* node,
                           const float* tri, const int* tri_id, int n,
                           int n_nodes, float t_min, cudaStream_t stream) {
  return launch<false, true>(o, d, const_cast<float*>(t_far), nullptr,
                             blocked, box, node, tri, tri_id, n, n_nodes,
                             t_min, stream);
}

extern "C" int ordered_anyhit(const float* o, const float* d,
                              const float* t_far, bool* blocked,
                              const float* box, const int* node,
                              const float* tri, const int* tri_id, int n,
                              int n_nodes, float t_min, cudaStream_t stream) {
  return launch<true, true>(o, d, const_cast<float*>(t_far), nullptr,
                             blocked, box, node, tri, tri_id, n, n_nodes,
                             t_min, stream);
}

// What the runtime reports of one kernel (ordered or skip, any_hit or
// closest): out[0] registers a thread, out[1] local memory a thread in
// bytes (the ordered walk's stack and any spills), out[2] resident blocks
// an SM (the occupancy calculator's answer), out[3] threads a block.
// Returns a cudaError_t.
extern "C" int binary_walk_attributes(int ordered, int any_hit, int* out) {
  const void* f = any_hit ? kernel_of<true>(ordered) : kernel_of<false>(ordered);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = kThreads;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], f, out[3], 0));
}

#ifdef BINARY_WALK_COUNTS
// Sets the counting build's counters, for both walks: per ray (n,) int64
// node visits (pops) and triangle tests, per warp (ceil(n / 32),) int64
// loop turns and lanes that stepped, summed over launches; null pointers
// stop counting. Returns a cudaError_t.
extern "C" int binary_walk_set_counters(long long* visits, long long* tests,
                                        long long* turns, long long* lanes) {
  cudaError_t err = cudaMemcpyToSymbol(g_walk_visits, &visits, sizeof(visits));
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_walk_tests, &tests, sizeof(tests));
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_walk_turns, &turns, sizeof(turns));
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_walk_lanes, &lanes, sizeof(lanes));
  }
  return static_cast<int>(err);
}
#endif
