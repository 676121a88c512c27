// Character pre-decoder for Hopper (sm_90a): raw bytes -> per-position
// (kind, tag) (K5).
//
// Replaces, in the JAX package, src/repro/kernels/predecode.py:
//   K5  predecode_pallas  (_kernel)
// It computes exactly what that kernel computes: each byte position of a
// (B, L) batch is classified from its byte and the three after it in the
// same row -- '<' then two symbols is an OPEN, '</' then two symbols a
// CLOSE, anything else PAD -- and the tag is v0 * 64 + v1 over the
// 64-symbol alphabet (a-z A-Z 0-9 _ .), -1 for PAD.  Zeros are shifted in
// past each row's end, so a tag never reads the next document's bytes.
//
// What bounds it on this card: bytes.  Each position reads 1 byte and
// writes two int32 (9 bytes), and the classification is a dozen integer
// operations.  The TPU kernel needs the 1-3 byte halo materialised as
// three shifted copies because a grid block cannot read past its tile.
// A first design here (one thread a position, four 1-byte loads behind
// bounds tests and two 4-byte stores) was held by the load/store pipe and
// the few bytes each thread kept in flight, at half the byte bound.
//
// What this design does about it: every warp load and store instruction
// moves contiguous bytes, and each thread keeps 16 positions in flight.
//   * A warp takes 128 consecutive 4-byte words (512 positions) of one
//     row; lane l holds words l, l + 32, l + 64 and l + 96, four
//     read-only 4-byte loads (ld.global.nc) that each cover 128
//     contiguous bytes across the warp.
//   * A word's 3-byte halo is the next word of the row: the next lane
//     hands it over with __shfl_down_sync, lane 31 takes lane 0's next
//     word by __shfl_sync and, for the last, loads it itself; a row's
//     last word takes zeros.
//   * Each byte's symbol value is found once, and the four positions of a
//     word are classified in registers.
//   * Each word's kind and tag leave as one 16-byte streaming store each
//     (__stcs of int4), so a warp store writes 512 contiguous bytes: at
//     the main path's 131 MB of output nothing is read back from L2.
// One warp-iteration per (row, 512-position span), walked by a grid
// that is grid-stride only past a few waves.  The vector path needs
// L % 4 == 0, a 4-byte aligned input and 16-byte aligned outputs, which
// every byte batch of the stage has (rows padded to a multiple of
// 1,024).  Any other shape -- odd L, a view with an unaligned storage
// offset -- takes the scalar path of the same kernel, one position a
// thread.  (The layout of 16 consecutive positions a thread, one 16-byte
// load and four 16-byte stores of each output, ran slower than the
// first design: its stores fill half a 32-byte sector a lane.)
//
// The C entry point takes device pointers and a CUDA stream and returns
// the cudaError_t of the launch (0 = launched).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOpen = 0;
constexpr int kClose = 1;
constexpr int kPad = 2;
constexpr unsigned kLt = 60;     // '<'
constexpr unsigned kSlash = 47;  // '/'
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 4;              // words a lane takes per span
constexpr int kSpan = 32 * kWords;     // words a warp takes per span
constexpr int kWaves = 4;              // resident grids before grid-stride
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ int symbol_value(unsigned b) {
  if (b - 97u < 26u) return static_cast<int>(b - 97u);        // a-z
  if (b - 65u < 26u) return static_cast<int>(b - 65u) + 26;   // A-Z
  if (b - 48u < 10u) return static_cast<int>(b - 48u) + 52;   // 0-9
  if (b == 95u) return 62;                                    // '_'
  if (b == 46u) return 63;                                    // '.'
  return -1;
}

// One position from its byte b0, the next byte b1 and the symbol values
// s1..s3 of the three bytes after it.
__device__ __forceinline__ void classify(unsigned b0, unsigned b1, int s1,
                                         int s2, int s3, int& kind,
                                         int& tag) {
  const bool is_lt = b0 == kLt;
  const bool is_close = is_lt && b1 == kSlash;
  const int v0 = is_close ? s2 : s1;
  const int v1 = is_close ? s3 : s2;
  const bool ok = (v0 | v1) >= 0;
  kind = (is_lt && ok) ? (is_close ? kClose : kOpen) : kPad;
  tag = (is_lt && ok) ? v0 * 64 + v1 : -1;
}

// scalar path: one position a thread, bounds-tested halo
__device__ void predecode_scalar(const uint8_t* __restrict__ data, int rows,
                                 int length, int32_t* __restrict__ kind,
                                 int32_t* __restrict__ tag) {
  const long long n = static_cast<long long>(rows) * length;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long r = i / length;
    const int p = static_cast<int>(i - r * length);
    const uint8_t* row = data + r * length;
    const unsigned b1 = p + 1 < length ? row[p + 1] : 0u;
    const unsigned b2 = p + 2 < length ? row[p + 2] : 0u;
    const unsigned b3 = p + 3 < length ? row[p + 3] : 0u;
    int k, t;
    classify(row[p], b1, symbol_value(b1), symbol_value(b2),
             symbol_value(b3), k, t);
    kind[i] = k;
    tag[i] = t;
  }
}

// vector path: a warp per (row, span of kSpan words), see the note above
__device__ void predecode_words(const uint8_t* __restrict__ data, int rows,
                                int length, int32_t* __restrict__ kind,
                                int32_t* __restrict__ tag) {
  const int words = length / 4;
  const int spans = (words + kSpan - 1) / kSpan;
  const long long n = static_cast<long long>(rows) * spans;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long i = static_cast<long long>(blockIdx.x) * kWarps +
                     threadIdx.x / 32;
       i < n; i += stride) {                       // uniform over the warp
    const long long r = i / spans;
    const int first = static_cast<int>(i - r * spans) * kSpan + lane;
    const unsigned* row = reinterpret_cast<const unsigned*>(data + r * length);
    unsigned x[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = first + 32 * k;
      x[k] = w < words ? __ldg(row + w) : 0u;
    }
    const int last = first + 32 * (kWords - 1);
    const unsigned beyond =
        lane == 31 && last + 1 < words ? __ldg(row + last + 1) : 0u;
    int4* ko = reinterpret_cast<int4*>(kind + r * length);
    int4* to = reinterpret_cast<int4*>(tag + r * length);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      // every lane shuffles, active or not
      const unsigned down = __shfl_down_sync(kFullWarp, x[k], 1);
      const unsigned wrap =
          k + 1 < kWords
              ? __shfl_sync(kFullWarp, x[k + 1 < kWords ? k + 1 : k], 0)
              : beyond;
      const int w = first + 32 * k;
      if (w >= words) continue;
      const unsigned halo = w + 1 == words ? 0u : (lane == 31 ? wrap : down);
      unsigned b[7];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = (x[k] >> (8 * j)) & 0xffu;
#pragma unroll
      for (int j = 0; j < 3; ++j) b[4 + j] = (halo >> (8 * j)) & 0xffu;
      int sym[7];
#pragma unroll
      for (int j = 1; j < 7; ++j) sym[j] = symbol_value(b[j]);
      int kd[4], tg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        classify(b[j], b[j + 1], sym[j + 1], sym[j + 2], sym[j + 3], kd[j],
                 tg[j]);
      __stcs(ko + w, make_int4(kd[0], kd[1], kd[2], kd[3]));
      __stcs(to + w, make_int4(tg[0], tg[1], tg[2], tg[3]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
predecode_kernel(const uint8_t* __restrict__ data, int rows, int length,
                 bool vec, int32_t* __restrict__ kind,
                 int32_t* __restrict__ tag) {
  if (vec)
    predecode_words(data, rows, length, kind, tag);
  else
    predecode_scalar(data, rows, length, kind, tag);
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

extern "C" {

int pd_predecode(const void* data, int rows, int length, void* kind,
                 void* tag, void* stream) {
  const bool vec = length % 4 == 0 && aligned(data, 4) &&
                   aligned(kind, 16) && aligned(tag, 16);
  // blocks the work needs: a warp per span (vector), a thread per
  // position (scalar)
  const long long want =
      vec ? (static_cast<long long>(rows) *
                 ((length / 4 + kSpan - 1) / kSpan) +
             kWarps - 1) / kWarps
          : (static_cast<long long>(rows) * length + kThreads - 1) / kThreads;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, predecode_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) * kWaves;
  const int grid = static_cast<int>(want < cap ? want : cap);
  if (grid == 0) return 0;
  predecode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), rows, length, vec,
      static_cast<int32_t*>(kind), static_cast<int32_t*>(tag));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
