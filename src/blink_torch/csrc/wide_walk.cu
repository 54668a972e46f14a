// Wide-BVH walk for Hopper: closest hit and any hit over one 8-wide BVH
// chunk, one thread per ray, under each of blink's leaf schedules and
// child-box layouts.
//
// Replaces: src/blink/kernels/traverse_pallas.py::_make_kernel_wide,
// reached through _traverse_wide_packed, with any_hit False and True and:
//   - quant=True/False: quantized child boxes (8-bit coordinates against a
//     per-node frame, decoded here) or f32 child boxes (two float4 loads a
//     slot, no decode);
//   - leaf_mode='group': the leaf children that pass, tested at the
//     parent's pop, triangles from the record table `tri`;
//   - leaf_mode='row': the same leaves in the same order, triangles from
//     the 8-triangle batch table `tbat` through `bref` (the gid in the
//     record); the TPU merges each batch against the best t at batch entry,
//     lowest slot first among equal t, which is the sequential strict <
//     merge's result, so the hits are group's bit for bit;
//   - leaf_mode='stream': at each pop with leaves, the ray tests its
//     pending leaf, then this pop's leaves but the last, which becomes the
//     pending leaf; the last one is tested after the walk: a one-leaf
//     deferral per thread, the counterpart of the TPU kernel's DMA double
//     buffer. The walk then prunes with a best t one leaf late, pops a
//     superset of group's nodes and finds group's hits;
//   - leaf_mode='skip': the walk without leaf tests, for timing only (every
//     ray misses): its time against group's splits a walk into node walk
//     and leaf tests. Its best t stays what the ray came in with, so a skip
//     ray pops every node whose box its [t_min, t_far] segment passes: for
//     a closest hit a superset of group's pops, and skip's share of group's
//     time is an upper bound on the node walk's share.
// The TPU kernel walks a 4096-ray packet with one scalar cursor, because
// the TPU has no per-lane gathers, and gates leaf tests by row groups or
// 128-ray rows; here each ray walks with its own stack, takes its child
// order from its own direction octant and tests only the leaves its own
// slab tests pass, so the packet-shape knobs (rows, row_groups) have no
// counterpart. Child order changes only which of two exactly tied
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
// What bounds it on the H100. Not the arithmetic: a ray's slab and
// triangle tests are a few thousand lane-instructions, a small share of the
// SM cycles a walk takes. A walk waits on chains of dependent loads and on
// lanes that diverge. In the first design (one thread a ray, as now), a
// pop reads the stack, then the octant order, and only then each child
// record; a leaf test loads its record only after the
// previous test's compare and branch; and a warp runs the leaf loops of its
// lanes' eight near-first positions one after another, so a lane with a
// 44-triangle leaf makes 44 serial L2 round trips while the rest of its
// warp waits. The tables stay in global memory:
// one chunk's node tables (~0.5 MB at 1M triangles) do not fit the 227 KB
// of shared memory a block may use, and a 1M-triangle scene's tables fit
// the 50 MB L2 or nearly.
//
// Every schedule is redesigned around that, as one template
// (wide_group_walk<ANY_HIT, QUANT, MODE>: MODE picks the record table,
// stream's deferral, or skip's lack of leaf tests). The steps, each timed
// against the earlier build in one process
// by wide_walk_ab.py at 1,048,576 rays on Sponza 1M, H100 80GB HBM3 at
// 700 W (PERF.md §6), first for group:
//   1. a pop issues all its loads together (the octant order, the node's
//      96-byte child record as six 16-byte loads, its frame) and orders
//      masks in registers; the nearest internal child that passed is the
//      next node without a trip through the stack; kept;
//   2. the leaves of a pop run as one loop over a cursor, so a warp's lanes
//      run one loop body whatever leaf each is in (kept: with 1 and 2,
//      0.88-0.89x the earlier time), and each turn loads a batch of records
//      before testing the first (kept, kBatch = 8 records: 0.60-0.63x
//      closest, 0.66-0.79x any hit); batches that run on into the pop's
//      next leaf, two half batches with the next one's loads issued
//      before the current one is tested, and L1 prefetches of the next
//      node and the next batch gained nothing or were slower; dropped;
//   3. more warps in flight: a minimum of 5-8 blocks an SM spills and was
//      slower, the stack's top in shared memory changed nothing, blocks of
//      32, 64 or 256 threads gained nothing; none kept (128 registers, 16
//      resident warps an SM);
//   4. persistent warps that take 32 rays at a time from a counter, and one
//      loop whose every turn is a pop or a batch lane by lane, were slower;
//      dropped.
// Then row and stream on group's walk (against their first design, the
// parent):
//   5. row: group's pop and cursor loop over the batch table, a turn one
//      512-byte tbat row of 8 records, the gid read for the winner alone,
//      a leaf's bref entry read as the leaf starts; kept: 0.600x / 0.611x
//      the parent (closest / any hit, layout (a)), 0.551x / 0.684x on (b),
//      1.2-1.5% over group on the same layout. The node's bref row issued
//      with the pop's other loads (two int4s) instead tied on (a) and lost
//      1.7% / 5.9% on (b), where its f32 kernels took 131-134 registers
//      and 12 warps an SM; dropped;
//   6. stream: the queue [pending leaf, this pop's leaves but the last] run
//      by the same loop; kept: 0.611x / 0.643x the parent on (a), 0.621x /
//      0.693x on (b), 1.06-1.13x row (closest hit: 26-27% more tests, the
//      best t a leaf late; 1-3% more pops);
//   7. stream: the pending leaf's first records staged in shared memory by
//      cp.async while the walk goes on (the TPU's DMA double buffer; per
//      thread, [record][float4][lane], no bank conflicts): 2.0-3.6x slower
//      than 6 with 8, 4 or 2 records (cp.async.cg), 1.06-1.17x with
//      L1-allocating copies (cp.async.ca), 2.3-2.7x with one cp.async.bulk
//      of 4 records on a per-thread mbarrier; the copies alone, their
//      records read from global memory, cost as much, while 48 KB of shared
//      memory reserved and unused cost 0-2.6%: coherent rays find the
//      pending leaf's records in L1, so staging hides no latency and adds
//      traffic; dropped, as was an L2 prefetch of the pending leaf (1.006-
//      1.031x slower without staging, a tie with it);
//   8. a floor of 4 blocks an SM for row and stream (128 registers) spilled
//      112-116 bytes in stream's f32 kernels and moved times by -1.3% to
//      +1.1%; dropped: stream's f32 kernels keep 130-134 registers and 12
//      warps an SM, the others 126-128 and 16.
// Then skip on group's walk:
//   9. group's pop with no leaf loop: 43-48 registers and 40 warps an SM,
//      as the first design had; 1.018x / 0.999x the first design's time
//      on layout (a) (closest / any hit), 1.058x / 1.050x on (b). At 40
//      warps an SM the first design's dependent loads were already
//      hidden; what group's pop buys at 16 warps it cannot buy here. Kept,
//      so that skip against group compares schedules on one design.

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

// Möller–Trumbore as kernels/triangle.py::triangle_tuv on a record already
// loaded (v0 e1 e2 in three float4s); kTMax on a miss.
__device__ __forceinline__ float tri_t_rec(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float4 a, float4 b, float4 c,
                                           float t_min, float t_max) {
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

enum LeafMode { kGroup = 0, kRow = 1, kStream = 2, kSkip = 3 };  // LEAF_MODES

// ---------------------------------------------------------------------------
// group, row and stream: one walk, redesigned to hide latency (the note at
// the head of this file). kBatch is the number of a leaf's triangle records
// loaded together before the first of them is tested: with the row tables,
// one 512-byte batch of tbat. A build with -DWIDE_WALK_COUNTS
// (wide_walk_ab.py --counts, traverse_wide.walk_counts) counts each ray's
// pops and tests, to check them against the plain walk's.
constexpr int kBatch = 8;

#ifdef WIDE_WALK_COUNTS
// A counting build: each ray adds its pops and triangle tests to these
// per-ray counters when they are set.
__device__ long long* g_walk_pops = nullptr;
__device__ long long* g_walk_tests = nullptr;
#define WIDE_WALK_COUNT(counter, i) \
  if (counter) ++counter[i]
#else
#define WIDE_WALK_COUNT(counter, i)
#endif

// a[i] for a register array and a lane-varying i, by selects: indexing the
// array with i would move it to local memory.
__device__ __forceinline__ int pick8(const int (&a)[8], int i) {
  const int a01 = (i & 1) ? a[1] : a[0], a23 = (i & 1) ? a[3] : a[2];
  const int a45 = (i & 1) ? a[5] : a[4], a67 = (i & 1) ? a[7] : a[6];
  const int a03 = (i & 2) ? a23 : a01, a47 = (i & 2) ? a67 : a45;
  return (i & 4) ? a47 : a03;
}

// Bit k of the result is bit (slot at position k of the order pm) of m: a
// mask by child slot, permuted into the octant's near-first order.
__device__ __forceinline__ unsigned by_order(unsigned m, int pm) {
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) r |= ((m >> ((pm >> (3 * k)) & 7)) & 1u) << k;
  return r;
}

// Lowest set bit of a non-zero mask.
__device__ __forceinline__ int lowest(unsigned m) {
  return __ffs(static_cast<int>(m)) - 1;
}

// The leaf tests of one pop as one loop over a cursor: the records [s, e)
// of the leaf under way (stream: the pending leaf), then each leaf of lf_k
// (near-first positions in the order pm; by child slot, the count from cnt
// and the first record from ref, or for row and stream kBatch times the
// leaf's first batch in the node's bref row `brow`, read as the leaf
// starts). Each turn loads up to kBatch records of the leaf, each load
// predicated on the leaf's end, and tests them in slot order against the
// running best with a strict <. Returns true at an any hit.
// COUNT (the two-level walk's counting build) adds the tests to *n_tests, a
// turn's at its start (an add a turn, not a test: the count costs the walk
// little), less those an any hit leaves untested.
template <bool ANY_HIT, int MODE, bool COUNT = false>
__device__ __forceinline__ bool leaf_loop(
    const float4* __restrict__ recs, const int* __restrict__ brow, int s,
    int e, unsigned lf_k, int pm, const int (&ref)[8], const int (&cnt)[8],
    float ox, float oy, float oz, float dx, float dy, float dz, float t_min,
    float& best, int& best_hit, int i, int* n_tests = nullptr) {
  // Float4s a record: tri's 48-byte records [v0 e1 e2], tbat's 64-byte
  // ones [v0 e1 e2 gid slot] and padding.
  constexpr int kRec = MODE == kGroup ? 3 : 4;
  while (s < e || lf_k) {
    if (s >= e) {
      const int c8 = (pm >> (3 * lowest(lf_k))) & 7;
      lf_k &= lf_k - 1;
      s = MODE == kGroup ? pick8(ref, c8) : kBatch * __ldg(brow + c8);
      e = s + pick8(cnt, c8);
    }
    float4 ra[kBatch], rb[kBatch];
    float rc[kBatch];  // e2.z, the only float of the third float4 read
    if constexpr (COUNT) *n_tests += min(e - s, kBatch);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (s + j < e) {
        const float4* rec = recs + kRec * (s + j);
        ra[j] = __ldg(rec);
        rb[j] = __ldg(rec + 1);
        rc[j] = __ldg(reinterpret_cast<const float*>(rec + 2));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (s + j < e) {
        WIDE_WALK_COUNT(g_walk_tests, i);
        const float t = tri_t_rec(ox, oy, oz, dx, dy, dz, ra[j], rb[j],
                                  make_float4(rc[j], 0.0f, 0.0f, 0.0f), t_min,
                                  best);
        if (t < best) {
          if constexpr (ANY_HIT && COUNT) *n_tests -= min(e - s, kBatch) - (j + 1);
          if (ANY_HIT) return true;
          best = t;
          best_hit = s + j;
        }
      }
    }
    s += kBatch;
  }
  return false;
}

// Closest hit and any hit under the group, row, stream and skip schedules.
// Closest hit: t/prim hold the best so far (threaded across chunks) and are
// updated where this chunk has a nearer hit. Any hit: t_in is t_far,
// blocked is set where a hit lies in [t_min, min(t_far, T_MAX)); rays
// already blocked by an earlier chunk do no work. skip tests no leaf: the
// walk prunes with the best t it came in with for its whole length (t_in,
// or min(t_far, T_MAX)), writes nothing and blocks nothing. child is int32 words
// (QUANT) or floats; nbox is read only with QUANT. recs is the record
// table: tri (group; gids in tri_id) or tbat (row and stream; a leaf's
// first batch in bref). Each ray sees what the plain walk
// (kernels/traverse_wide.py) gives it under the same schedule: the same
// pops in the same order, the children in its octant's near-first order, a
// leaf's triangles in slot order against the running best t with a strict
// < merge (row's per-batch merge in the plain walk gives the same result:
// traverse_wide._leaf_tests). What differs is when loads are issued and
// where state lives:
//   - a pop issues all its loads at once (the octant order, the 8 child
//     records as 16-byte loads, the frame), slab-tests the children in slot
//     order into masks, and applies the order to the masks in registers;
//   - the nearest internal child that passed is the next node without a
//     trip through the stack, and the rest are pushed far to near, before
//     the leaf tests (which cannot change them);
//   - the leaves of a pop run as one loop over a cursor (leaf_loop; skip
//     has none);
//   - stream: the queue is [the pending leaf, this pop's leaves but the
//     last], and the last becomes the pending leaf, tested at the ray's
//     next leaf-bearing pop or after the walk.
template <bool ANY_HIT, bool QUANT, int MODE>
__global__ void __launch_bounds__(kThreads)
    wide_group_walk(const float* __restrict__ o, const float* __restrict__ d,
                    float* __restrict__ t_io, int* __restrict__ prim,
                    bool* __restrict__ blocked, const void* __restrict__ child,
                    const float* __restrict__ nbox, const int* __restrict__ perm,
                    const float4* __restrict__ recs,
                    const int* __restrict__ tri_id,
                    const int* __restrict__ bref, int n, float t_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (ANY_HIT && blocked[i]) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const int octant = (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0) |
                     (dz >= 0.0f ? 4 : 0);
  float best = ANY_HIT ? nan_min(t_io[i], kTMax) : t_io[i];
  int best_hit = -1;  // the winning record
  int pend_s = 0, pend_c = 0;  // stream: the pending leaf (count 0: none)
  int stack[WIDE_STACK_CAP];
  int sp = 0;
  int ref[8], cnt[8];  // by child slot: first record (or child node), count

  int node = 0;
  while (node >= 0) {
    // The pop: every load issued together, the slab tests by slot.
    WIDE_WALK_COUNT(g_walk_pops, i);
    const int pm = __ldg(perm + node * 8 + octant);
    const int* brow = bref + node * 8;
    unsigned leaf = 0, inner = 0;  // children that passed, by slot
    if constexpr (QUANT) {
      const int4* cw = reinterpret_cast<const int4*>(child) + node * 6;
      const float4* fr = reinterpret_cast<const float4*>(nbox) + node * 2;
      int w[24];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int4 v = __ldg(cw + j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
      const float4 f0 = __ldg(fr), f1 = __ldg(fr + 1);  // ox oy oz sx, sy sz
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int w0 = w[3 * c], w1 = w[3 * c + 1];
        ref[c] = w[3 * c + 2];
        cnt[c] = w0 >> 24;
        const bool hit = slab(
            ox, oy, oz, ix, iy, iz, t_min, best,
            dequant(f0.x, w0 & 255, f0.w), dequant(f0.y, (w0 >> 8) & 255, f1.x),
            dequant(f0.z, (w0 >> 16) & 255, f1.y), dequant(f0.x, w1 & 255, f0.w),
            dequant(f0.y, (w1 >> 8) & 255, f1.x),
            dequant(f0.z, (w1 >> 16) & 255, f1.y));
        leaf |= (hit && cnt[c] > 0 ? 1u : 0u) << c;
        inner |= (hit && cnt[c] == 0 && ref[c] > 0 ? 1u : 0u) << c;
      }
    } else {
      const float4* cf = static_cast<const float4*>(child) + node * 16;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 a = __ldg(cf + 2 * c);      // lx ly lz hx
        const float4 b = __ldg(cf + 2 * c + 1);  // hy hz ref cnt
        ref[c] = static_cast<int>(b.z);
        cnt[c] = static_cast<int>(b.w);
        const bool hit =
            slab(ox, oy, oz, ix, iy, iz, t_min, best, a.x, a.y, a.z, a.w, b.x, b.y);
        leaf |= (hit && cnt[c] > 0 ? 1u : 0u) << c;
        inner |= (hit && cnt[c] == 0 && ref[c] > 0 ? 1u : 0u) << c;
      }
    }

    // The next node: the nearest internal child that passed, else the
    // stack's top; the other internal children pushed far to near.
    unsigned in_k = by_order(inner, pm);
    if (in_k) {
      node = pick8(ref, (pm >> (3 * lowest(in_k))) & 7);
      for (in_k &= in_k - 1; in_k;) {
        const int k = 31 - __clz(static_cast<int>(in_k));
        in_k &= ~(1u << k);
        stack[sp++] = pick8(ref, (pm >> (3 * k)) & 7);
      }
    } else {
      node = sp > 0 ? stack[--sp] : -1;
    }

    if constexpr (MODE == kSkip) {
      continue;  // no leaf tests: no leaf_loop, no record table read
    } else {
      // The leaves that passed, near first (lf_k: by near-first position).
      unsigned lf_k = by_order(leaf, pm);
      int s = 0, e = 0;
      if constexpr (MODE == kStream) {
        // The pending leaf first, then all of this pop's leaves but the
        // last, which becomes the pending leaf.
        if (!lf_k) continue;
        const int k = 31 - __clz(static_cast<int>(lf_k));
        lf_k &= ~(1u << k);
        const int c8 = (pm >> (3 * k)) & 7;
        s = pend_s;
        e = pend_s + pend_c;
        pend_s = kBatch * __ldg(brow + c8);
        pend_c = pick8(cnt, c8);
      }
      if (leaf_loop<ANY_HIT, MODE>(recs, brow, s, e, lf_k, pm, ref, cnt, ox, oy,
                                   oz, dx, dy, dz, t_min, best, best_hit, i)) {
        blocked[i] = true;
        return;
      }
    }
  }
  if constexpr (MODE == kStream) {  // the pending leaf, after the walk
    if (pend_c > 0 &&
        leaf_loop<ANY_HIT, MODE>(recs, bref, pend_s, pend_s + pend_c, 0u, 0, ref,
                                 cnt, ox, oy, oz, dx, dy, dz, t_min, best,
                                 best_hit, i)) {
      blocked[i] = true;
      return;
    }
  }
  if constexpr (MODE != kSkip) {
    if (!ANY_HIT && best_hit >= 0) {
      t_io[i] = best;
      if constexpr (MODE == kGroup) {
        prim[i] = __ldg(tri_id + best_hit);
      } else {  // the gid, float 9 of the winning tbat record
        prim[i] = static_cast<int>(
            __ldg(reinterpret_cast<const float*>(recs + 4 * best_hit + 2) + 1));
      }
    }
  }
}

template <bool ANY_HIT, bool QUANT>
int launch_mode(int mode, const float* o, const float* d, float* t_io,
                int* prim, bool* blocked, const void* child, const float* nbox,
                const int* perm, const float* tri, const int* tri_id,
                const int* bref, const float* tbat, int n, float t_min,
                cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const float4* tr = reinterpret_cast<const float4*>(tri);
  const float4* tb = reinterpret_cast<const float4*>(tbat);
  switch (mode) {
    case kGroup:
      wide_group_walk<ANY_HIT, QUANT, kGroup><<<blocks, kThreads, 0, stream>>>(
          o, d, t_io, prim, blocked, child, nbox, perm, tr, tri_id, bref, n,
          t_min);
      break;
    case kRow:
      wide_group_walk<ANY_HIT, QUANT, kRow><<<blocks, kThreads, 0, stream>>>(
          o, d, t_io, prim, blocked, child, nbox, perm, tb, tri_id, bref, n,
          t_min);
      break;
    case kStream:
      wide_group_walk<ANY_HIT, QUANT, kStream><<<blocks, kThreads, 0, stream>>>(
          o, d, t_io, prim, blocked, child, nbox, perm, tb, tri_id, bref, n,
          t_min);
      break;
    case kSkip:
      wide_group_walk<ANY_HIT, QUANT, kSkip><<<blocks, kThreads, 0, stream>>>(
          o, d, t_io, prim, blocked, child, nbox, perm, tr, tri_id, bref, n,
          t_min);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel of variant (ANY_HIT, QUANT, mode), for the runtime's queries.
template <bool ANY_HIT, bool QUANT>
const void* kernel_of(int mode) {
  switch (mode) {
    case kGroup:
      return reinterpret_cast<const void*>(&wide_group_walk<ANY_HIT, QUANT, kGroup>);
    case kRow:
      return reinterpret_cast<const void*>(&wide_group_walk<ANY_HIT, QUANT, kRow>);
    case kStream:
      return reinterpret_cast<const void*>(&wide_group_walk<ANY_HIT, QUANT, kStream>);
    case kSkip:
      return reinterpret_cast<const void*>(&wide_group_walk<ANY_HIT, QUANT, kSkip>);
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// The two-level walk (tlas_wide_group_walk<ANY_HIT>; bvh/tlas.py builds its
// tables, kernels/traverse_tlas.py launches it and holds its plain
// version). It replaces no TPU kernel: blink's bvh/tlas.py is a structural
// reference in plain JAX. A TLAS, an 8-wide quantized BVH over the
// instances' world boxes whose leaf children each hold one instance record,
// is walked with the world ray; at each instance the ray enters, it is
// moved into object space (the instance's w2o: a rounded multiply, then a
// rounded add, left to right) and its object's BLAS, a production chunk
// (quantized 8-wide nodes, wide leaves of 44), is walked by group's pop and
// leaf loop from the best t so far. An affine map
// keeps the ray parameter, so object-space t compares with the world best
// directly. The BLAS tables of all objects lie end to end; an instance
// record names its object's first node and first record, and the global id
// of its first triangle (prim = that + the object-local id).
//
// Order of work, which the plain version repeats ray for ray: one stack
// holds TLAS nodes (>= 0) and instance records (-1 - record); a TLAS pop
// slab-tests the node's children against [t_min, best] and pushes every
// child that passed far to near (a leaf child as its records, last first),
// so the nearest pops next; a BLAS walk runs on the stack above the TLAS
// entries. Any hit stops at the first occluder in [t_min, min(t_far,
// T_MAX)) of any instance.
//
// What bounds it: as the flat walk, chains of dependent loads and lanes
// that diverge, now through two trees; the entry adds a 64-byte instance
// record and two affine maps. The pop of both trees is quant_pop,
// wide_group_walk's quantized pop as a function. That kernel keeps its own
// copy of the pop and of the next-node step: called from its QUANT branch,
// quant_pop moves the register counts of 3 of its 16 variants in ptxas's
// report (row and skip ones), and with the next-node step and the octant
// shared as well, of 9. On an H100 at 700 W the walks take 21.4 ms of a
// sponza1m_tlas.path frame, 1.24x the flat walk's 17.25 ms on the same
// rays, at 1.8% of their operations bound, with 152 registers and 12 warps
// an SM (PERF.md, section 6, row 10).
//
// A build with -DTLAS_WALK_COUNTS (kernels/traverse_tlas.py::walk_counts)
// counts each ray's TLAS pops, BLAS pops, triangle tests and BLAS walks
// begun in registers, and adds them to counts[0..3] with one atomic add a
// warp a counter.
#ifdef TLAS_WALK_COUNTS
constexpr bool kTlasCounts = true;
#else
constexpr bool kTlasCounts = false;
#endif

struct TlasCounts {
  int tlas_pops = 0, blas_pops = 0, tests = 0, entries = 0;
};

// The quantized pop of node `node` (wide_group_walk's QUANT branch): the
// children that pass the slab test against [t_min, t_max], as masks by
// slot of leaf and internal children, each slot's ref and count; returns
// the near-first order of the ray's octant.
__device__ __forceinline__ int quant_pop(
    const int4* __restrict__ child, const float4* __restrict__ nbox,
    const int* __restrict__ perm, int node, int octant, float ox, float oy,
    float oz, float ix, float iy, float iz, float t_min, float t_max,
    unsigned& leaf, unsigned& inner, int (&ref)[8], int (&cnt)[8]) {
  const int pm = __ldg(perm + node * 8 + octant);
  const int4* cw = child + node * 6;
  const float4* fr = nbox + node * 2;
  int w[24];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int4 v = __ldg(cw + j);
    w[4 * j] = v.x;
    w[4 * j + 1] = v.y;
    w[4 * j + 2] = v.z;
    w[4 * j + 3] = v.w;
  }
  const float4 f0 = __ldg(fr), f1 = __ldg(fr + 1);  // ox oy oz sx, sy sz
  leaf = 0;
  inner = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int w0 = w[3 * c], w1 = w[3 * c + 1];
    ref[c] = w[3 * c + 2];
    cnt[c] = w0 >> 24;
    const bool hit = slab(
        ox, oy, oz, ix, iy, iz, t_min, t_max,
        dequant(f0.x, w0 & 255, f0.w), dequant(f0.y, (w0 >> 8) & 255, f1.x),
        dequant(f0.z, (w0 >> 16) & 255, f1.y), dequant(f0.x, w1 & 255, f0.w),
        dequant(f0.y, (w1 >> 8) & 255, f1.x),
        dequant(f0.z, (w1 >> 16) & 255, f1.y));
    leaf |= (hit && cnt[c] > 0 ? 1u : 0u) << c;
    inner |= (hit && cnt[c] == 0 && ref[c] > 0 ? 1u : 0u) << c;
  }
  return pm;
}

__device__ __forceinline__ int octant_of(float dx, float dy, float dz) {
  return (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0) | (dz >= 0.0f ? 4 : 0);
}

// One ray's two-level walk from `best` (closest hit: the best t so far, and
// best_prim; any hit: the bound). Returns true at an any hit.
template <bool ANY_HIT>
__device__ __forceinline__ bool tlas_ray(
    float ox, float oy, float oz, float dx, float dy, float dz, float t_min,
    float& best, int& best_prim, const int4* __restrict__ tchild,
    const float4* __restrict__ tnbox, const int* __restrict__ tperm,
    const int* __restrict__ tinst, const float4* __restrict__ iw2o,
    const int4* __restrict__ imeta, const int4* __restrict__ bchild,
    const float4* __restrict__ bnbox, const int* __restrict__ bperm,
    const float4* __restrict__ brecs, const int* __restrict__ btri_id,
    TlasCounts& c) {
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const int octant = octant_of(dx, dy, dz);
  int stack[WIDE_STACK_CAP];
  int sp = 0;
  stack[sp++] = 0;
  int ref[8], cnt[8];
  while (sp > 0) {
    const int e = stack[--sp];
    unsigned leaf, inner;
    if (e >= 0) {  // a TLAS node
      if constexpr (kTlasCounts) ++c.tlas_pops;
      const int pm = quant_pop(tchild, tnbox, tperm, e, octant, ox, oy, oz, ix,
                               iy, iz, t_min, best, leaf, inner, ref, cnt);
      for (unsigned m = by_order(leaf | inner, pm); m;) {
        const int k = 31 - __clz(static_cast<int>(m));
        m &= ~(1u << k);
        const int c8 = (pm >> (3 * k)) & 7;
        const int r = pick8(ref, c8);
        if ((inner >> c8) & 1u) {
          stack[sp++] = r;
        } else {
          for (int j = pick8(cnt, c8) - 1; j >= 0; --j) stack[sp++] = -1 - (r + j);
        }
      }
      continue;
    }
    // An instance: the ray in object space, its object's BLAS.
    if constexpr (kTlasCounts) ++c.entries;
    const int inst = __ldg(tinst + (-1 - e));
    const int4 meta = __ldg(imeta + inst);  // first node, first record, first prim
    const float4 m0 = __ldg(iw2o + 3 * inst), m1 = __ldg(iw2o + 3 * inst + 1),
                 m2 = __ldg(iw2o + 3 * inst + 2);
    const float px = ox * m0.x + oy * m0.y + oz * m0.z + m0.w;
    const float py = ox * m1.x + oy * m1.y + oz * m1.z + m1.w;
    const float pz = ox * m2.x + oy * m2.y + oz * m2.z + m2.w;
    const float qx = dx * m0.x + dy * m0.y + dz * m0.z;
    const float qy = dx * m1.x + dy * m1.y + dz * m1.z;
    const float qz = dx * m2.x + dy * m2.y + dz * m2.z;
    const float jx = 1.0f / qx, jy = 1.0f / qy, jz = 1.0f / qz;
    const int oct = octant_of(qx, qy, qz);
    const int4* cw = bchild + 6 * meta.x;
    const float4* fr = bnbox + 2 * meta.x;
    const int* pmb = bperm + 8 * meta.x;
    const float4* recs = brecs + 3 * meta.y;
    int best_hit = -1;
    const int base = sp;
    int node = 0;
    while (node >= 0) {  // group's walk, on the stack above the TLAS entries
      if constexpr (kTlasCounts) ++c.blas_pops;
      const int pm = quant_pop(cw, fr, pmb, node, oct, px, py, pz, jx, jy, jz,
                               t_min, best, leaf, inner, ref, cnt);
      unsigned in_k = by_order(inner, pm);
      if (in_k) {
        node = pick8(ref, (pm >> (3 * lowest(in_k))) & 7);
        for (in_k &= in_k - 1; in_k;) {
          const int k = 31 - __clz(static_cast<int>(in_k));
          in_k &= ~(1u << k);
          stack[sp++] = pick8(ref, (pm >> (3 * k)) & 7);
        }
      } else {
        node = sp > base ? stack[--sp] : -1;
      }
      if (leaf_loop<ANY_HIT, kGroup, kTlasCounts>(
              recs, nullptr, 0, 0, by_order(leaf, pm), pm, ref, cnt, px, py,
              pz, qx, qy, qz, t_min, best, best_hit, 0, &c.tests)) {
        return true;
      }
    }
    if (!ANY_HIT && best_hit >= 0) {
      best_prim = meta.z + __ldg(btri_id + meta.y + best_hit);
    }
  }
  return false;
}

// Closest hit: t holds each ray's bound (min(t_far, T_MAX)) and receives its
// best t; prim receives the global triangle id or -1. Any hit: t is t_far,
// read only; blocked receives whether a triangle lies in [t_min,
// min(t_far, T_MAX)). Every ray is written.
template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads) tlas_wide_group_walk(
    const float* __restrict__ o, const float* __restrict__ d,
    float* __restrict__ t_io, int* __restrict__ prim, bool* __restrict__ blocked,
    const int4* __restrict__ tchild, const float4* __restrict__ tnbox,
    const int* __restrict__ tperm, const int* __restrict__ tinst,
    const float4* __restrict__ iw2o, const int4* __restrict__ imeta,
    const int4* __restrict__ bchild, const float4* __restrict__ bnbox,
    const int* __restrict__ bperm, const float4* __restrict__ brecs,
    const int* __restrict__ btri_id, unsigned long long* __restrict__ counts,
    int n, float t_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  TlasCounts c;
  if (i < n) {
    float best = ANY_HIT ? nan_min(t_io[i], kTMax) : t_io[i];
    int best_prim = -1;
    const bool hit = tlas_ray<ANY_HIT>(
        o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
        d[3 * i + 2], t_min, best, best_prim, tchild, tnbox, tperm, tinst,
        iw2o, imeta, bchild, bnbox, bperm, brecs, btri_id, c);
    if (ANY_HIT) {
      blocked[i] = hit;
    } else {
      t_io[i] = best;
      prim[i] = best_prim;
    }
  }
  if constexpr (kTlasCounts) {
    // Every lane of the (whole) warp gets here; lane 0 adds the warp's sums.
    __syncwarp();
    const int v[4] = {c.tlas_pops, c.blas_pops, c.tests, c.entries};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned long long s = static_cast<unsigned long long>(v[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(counts + k, s);
    }
  }
}

}  // namespace

// One launch of the variant (any_hit, quant, mode) over one chunk.
// o, d: (n, 3) f32. Closest hit: t (n,) f32 best t and prim (n,) i32, both
// in/out; blocked null. Any hit: t is t_far (n,) f32, read only; blocked
// (n,) bool in/out; prim null. child: quant (n_wide*24,) i32, else
// (n_wide*64,) f32, 16-byte aligned; nbox (n_wide*8,) f32 (quant only);
// perm (n_wide*8,) i32; tri (P, 12) f32 with 16-byte-aligned rows; tri_id
// (P,) i32; bref (n_wide*8,) i32 and tbat (n_batches, 8, 16) f32 (row and
// stream only). mode: 0 group, 1 row, 2 stream, 3 skip. Returns
// cudaGetLastError().
extern "C" int wide_walk_launch(int any_hit, int quant, int mode,
                                const float* o, const float* d, float* t,
                                int* prim, bool* blocked, const void* child,
                                const float* nbox, const int* perm,
                                const float* tri, const int* tri_id,
                                const int* bref, const float* tbat, int n,
                                float t_min, cudaStream_t stream) {
  if (any_hit) {
    return quant ? launch_mode<true, true>(mode, o, d, t, prim, blocked, child,
                                           nbox, perm, tri, tri_id, bref, tbat,
                                           n, t_min, stream)
                 : launch_mode<true, false>(mode, o, d, t, prim, blocked,
                                            child, nbox, perm, tri, tri_id,
                                            bref, tbat, n, t_min, stream);
  }
  return quant ? launch_mode<false, true>(mode, o, d, t, prim, blocked, child,
                                          nbox, perm, tri, tri_id, bref, tbat,
                                          n, t_min, stream)
               : launch_mode<false, false>(mode, o, d, t, prim, blocked, child,
                                           nbox, perm, tri, tri_id, bref, tbat,
                                           n, t_min, stream);
}

// What the runtime reports of the variant's kernel: out[0] registers a
// thread, out[1] local memory a thread in bytes (the stack and any
// spills), out[2] resident blocks an SM (the occupancy calculator's
// answer), out[3] threads a block. Returns a cudaError_t.
extern "C" int wide_walk_attributes(int any_hit, int quant, int mode,
                                    int* out) {
  const void* f = any_hit ? (quant ? kernel_of<true, true>(mode)
                                   : kernel_of<true, false>(mode))
                          : (quant ? kernel_of<false, true>(mode)
                                   : kernel_of<false, false>(mode));
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = kThreads;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], f, out[3], 0));
}

// One launch of the two-level walk (any_hit 0: closest hit, 1: any hit)
// over n rays. o, d: (n, 3) f32; t: (n,) f32 (closest: in/out; any hit:
// t_far); prim: (n,) i32 out (closest) or null; blocked: (n,) bool out (any
// hit) or null. TLAS: tchild (N*24,) i32, tnbox (N*8,) f32, tperm (N*8,) i32,
// tinst (records,) i32 (the instance of each leaf record). Instances: iw2o
// (I, 3, 4) f32, imeta (I, 4) i32 [first BLAS node, first BLAS record,
// first global triangle, object]. BLAS tables of every object end to end:
// bchild, bnbox, bperm as the TLAS's, brecs (P, 12) f32, btri_id (P,) i32
// object-local ids. counts: (4,) int64 added to by the counting build
// (null otherwise). Every table 16-byte aligned. Returns cudaGetLastError().
extern "C" int tlas_walk_launch(
    int any_hit, const float* o, const float* d, float* t, int* prim,
    bool* blocked, const void* tchild, const float* tnbox, const int* tperm,
    const int* tinst, const float* iw2o, const int* imeta, const void* bchild,
    const float* bnbox, const int* bperm, const float* brecs,
    const int* btri_id, long long* counts, int n, float t_min,
    cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto tc = static_cast<const int4*>(tchild);
  const auto tn = reinterpret_cast<const float4*>(tnbox);
  const auto w2o = reinterpret_cast<const float4*>(iw2o);
  const auto meta = reinterpret_cast<const int4*>(imeta);
  const auto bc = static_cast<const int4*>(bchild);
  const auto bn = reinterpret_cast<const float4*>(bnbox);
  const auto br = reinterpret_cast<const float4*>(brecs);
  const auto cn = reinterpret_cast<unsigned long long*>(counts);
  if (any_hit) {
    tlas_wide_group_walk<true><<<blocks, kThreads, 0, stream>>>(
        o, d, t, prim, blocked, tc, tn, tperm, tinst, w2o, meta, bc, bn, bperm,
        br, btri_id, cn, n, t_min);
  } else {
    tlas_wide_group_walk<false><<<blocks, kThreads, 0, stream>>>(
        o, d, t, prim, blocked, tc, tn, tperm, tinst, w2o, meta, bc, bn, bperm,
        br, btri_id, cn, n, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef WIDE_WALK_COUNTS
// Sets the counting build's per-ray counters ((n,) int64 each, or null to
// stop counting). Returns a cudaError_t.
extern "C" int wide_walk_set_counters(long long* pops, long long* tests) {
  cudaError_t err = cudaMemcpyToSymbol(g_walk_pops, &pops, sizeof(pops));
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_walk_tests, &tests, sizeof(tests));
  }
  return static_cast<int>(err);
}
#endif
