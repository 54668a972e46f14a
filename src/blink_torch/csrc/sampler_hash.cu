// The sampler's counter-based hash chain for Hopper: one launch a public
// call of core/sampler.py, every word a native uint32_t in registers.
//
// Replaces: no Pallas kernel. In blink (src/blink/core/sampler.py) the
// chain is jnp uint32 arithmetic that XLA fuses into the code around it.
// Why it was added: torch has no usable uint32 shifts and adds, so the
// port's plain version (core/sampler.py: fold, _mix, _mix2, _mul) keeps
// each word in an int64 tensor and splits every multiply into 16-bit
// halves: about 55 elementwise launches a fold, each reading and writing
// 8-byte words of every row. A path-traced frame of 4,194,304 samples runs
// about 29 folds, some 1,600 launches and about a third of the frame's
// kernel time on an H100 80GB HBM3 at 700 W.
//
// Arithmetic, identical to the plain version and to blink's sampler, all
// mod 2^32:
//   mix:  x ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15; x *= 0x846CA68B;
//         x ^= x >> 16   (mix2: shifts 16, 13, 16; 0x85EBCA6B, 0xC2B2AE35)
//   fold of word d into (lo, hi): lo = mix(lo ^ (d * kGolden + kFoldLo)),
//         hi = mix2(hi ^ (d * kGolden2 + kFoldHi) ^ lo)
//   draw i of dimension dim: the hi word of the fold of dim * 16 + i,
//         (hi >> 8) as float times 2^-24 (exact in float32).
// Integer throughout, so keys and draws equal the plain version's bit for
// bit; the float conversion is exact, so no build flag matters to it.
//
// What bounds it on the H100: bytes. A fold is about 30 integer operations
// on a row; a row reads its key (16 B) or its per-row words (8 B each) and
// writes a key (16 B) or its draws (4 B each). At 4,194,304 rows a call
// moves 67-335 MB, 0.02-0.1 ms at 3.35 TB/s, against hundreds of integer
// operations a byte that the card could do.
// The design takes one pass over those bytes and no more:
//   - sampler_fold_launch: one thread a row folds 1 to 3 words in order
//     (scalars passed by value, per-row words read through their stride)
//     and writes the row's key once, as one 16-byte store;
//   - sampler_uniform_launch: one thread a row folds each of its n
//     counters into the key in registers and writes n floats;
//   - a key is read through its row stride, so the views keys[:, :2] and
//     keys[:, 2:4] of the camera's (N, 4) keys need no copy, and a (2,)
//     root broadcasts over the rows with stride 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Most words one fold launch takes (block_key's three).
constexpr int kMaxWords = 3;

// core/sampler.py's constants.
constexpr unsigned kGolden = 0x9E3779B9u;   // _GOLDEN
constexpr unsigned kGolden2 = 0x517CC1B7u;  // _GOLDEN2
constexpr unsigned kFoldLo = 0x85EBCA6Bu;   // fold's offset of the low word
constexpr unsigned kFoldHi = 0x27220A95u;   // fold's offset of the high word
constexpr unsigned kDimStride = 16u;        // _DIM_STRIDE
constexpr unsigned kMixA = 0x7FEB352Du;     // _mix's multipliers
constexpr unsigned kMixB = 0x846CA68Bu;
constexpr unsigned kMix2A = 0x85EBCA6Bu;    // _mix2's multipliers
constexpr unsigned kMix2B = 0xC2B2AE35u;

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= kMixA;
  x ^= x >> 15;
  x *= kMixB;
  return x ^ (x >> 16);
}

__device__ __forceinline__ unsigned mix2(unsigned x) {
  x ^= x >> 16;
  x *= kMix2A;
  x ^= x >> 13;
  x *= kMix2B;
  return x ^ (x >> 16);
}

__device__ __forceinline__ void fold(unsigned& lo, unsigned& hi, unsigned d) {
  lo = mix(lo ^ (d * kGolden + kFoldLo));
  hi = mix2(hi ^ (d * kGolden2 + kFoldHi) ^ lo);
}

// The words of one fold launch: word w is the low 32 bits of
// ptr[w][row * stride[w]], or value[w] where ptr[w] is null.
struct Words {
  const long long* ptr[kMaxWords];
  long long stride[kMaxWords];
  unsigned value[kMaxWords];
  int n;
};

// out (n, 2): each row's key (row * key_stride of `key`, or the zero state
// where key is null) with the words folded in, in order.
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const long long* __restrict__ key, long long key_stride, Words words,
                long long* __restrict__ out, long long n) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  unsigned lo = 0, hi = 0;
  if (key != nullptr) {
    lo = static_cast<unsigned>(key[row * key_stride]);
    hi = static_cast<unsigned>(key[row * key_stride + 1]);
  }
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w < words.n) {
      const long long* p = words.ptr[w];
      fold(lo, hi, p ? static_cast<unsigned>(p[row * words.stride[w]]) : words.value[w]);
    }
  }
  reinterpret_cast<longlong2*>(out)[row] = make_longlong2(lo, hi);
}

// out (n_rows, n_draws): draw i of dimension dim of each row's key.
__global__ void __launch_bounds__(kThreads)
    uniform_kernel(const long long* __restrict__ key, long long key_stride, int n_draws,
                   unsigned dim, float* __restrict__ out, long long n_rows) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const unsigned k_lo = static_cast<unsigned>(key[row * key_stride]);
  const unsigned k_hi = static_cast<unsigned>(key[row * key_stride + 1]);
  float* o = out + row * n_draws;
  for (int i = 0; i < n_draws; ++i) {
    unsigned lo = k_lo, hi = k_hi;
    fold(lo, hi, dim * kDimStride + static_cast<unsigned>(i));
    o[i] = static_cast<float>(hi >> 8) * (1.0f / 16777216.0f);
  }
}

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

// Fold n_words (1 to kMaxWords) words into each of n rows' keys: key (the
// int64 words of row r at key + r * key_stride; stride 0 broadcasts one
// key, null is the zero state), word w per row from word_ptr[w] with
// stride word_stride[w] (int64, masked to 32 bits), or word_value[w] where
// word_ptr[w] is null; out (n, 2) int64, contiguous. Returns a cudaError_t.
extern "C" int sampler_fold_launch(const long long* key, long long key_stride,
                                   const long long* const* word_ptr,
                                   const long long* word_stride,
                                   const unsigned* word_value, int n_words,
                                   long long* out, long long n, cudaStream_t stream) {
  if (n_words < 1 || n_words > kMaxWords || n < 1) return cudaErrorInvalidValue;
  Words words{};
  for (int w = 0; w < n_words; ++w) {
    words.ptr[w] = word_ptr[w];
    words.stride[w] = word_stride[w];
    words.value[w] = word_value[w];
  }
  words.n = n_words;
  fold_kernel<<<blocks_for(n), kThreads, 0, stream>>>(key, key_stride, words, out, n);
  return static_cast<int>(cudaGetLastError());
}

// Draws 0..n_draws-1 (at most 16) of dimension dim of each of n_rows
// keys (as sampler_fold_launch reads them; key not null), into out
// (n_rows, n_draws) float32, contiguous. Returns a cudaError_t.
extern "C" int sampler_uniform_launch(const long long* key, long long key_stride,
                                      int n_draws, unsigned dim, float* out,
                                      long long n_rows, cudaStream_t stream) {
  if (key == nullptr || n_draws < 1 || n_draws > static_cast<int>(kDimStride) || n_rows < 1)
    return cudaErrorInvalidValue;
  uniform_kernel<<<blocks_for(n_rows), kThreads, 0, stream>>>(key, key_stride, n_draws, dim,
                                                             out, n_rows);
  return static_cast<int>(cudaGetLastError());
}
