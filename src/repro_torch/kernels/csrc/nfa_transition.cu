// Levelwise NFA transition for Hopper (sm_90a): one document level, or one
// wavefront chunk, of W nodes advanced over S states at once (K6).
//
// Replaces, in the JAX package, src/repro/kernels/nfa_transition.py:
//   K6  nfa_transition_pallas  (_kernel)
// It computes exactly what that kernel computes, in float32:
//
//   src      = parent_rows @ parent_1h                      (W, S)
//   tagmatch = onehot(tags) @ req + wild                    (W, S)
//   out      = min(src * tagmatch + parent_rows * selfloop, 1) * (tags >= 0)
//
// onehot(tags) @ req is a row gather: row tags[r] of req, or a zero row
// when the tag is < 0 or >= T (as jax.nn.one_hot gives), so a tag past the
// plan's tag space still matches the wildcard states; only tags < 0 mask
// the row out.  The inputs are 0/1 and the sums are integers below 2^24,
// so the result is exact in any summation order.
//
// What bounds it on this card: operations.  The product is 2*W*S*S FLOP
// against W*S + S*S + T*S floats read and W*S written; at the port's
// shapes (S = 3,712 states, W = 2,048 rows a wavefront step) that is about
// 470 FLOP a byte, far above the card's float32 ridge.  Full float32, no
// TF32: the bound is 2*W*S*S over the 67 TFLOP/s float32 rate outside the
// tensor cores.  parent_1h has one 1 per column, so the product is a
// gather in disguise; a tensor-core (bf16, exact for 0/1 operands) or
// sparse form is the redesign's work, not this kernel's.
//
// What this simple design does about it: the classic shared-memory tiled
// SGEMM.  One thread block of 256 threads per 64 x 64 output tile (row
// tiles on grid x, state tiles on grid y); the reduction axis advances in
// slabs of 16 through shared memory (A transposed, so each thread reads
// its 4 rows and its 4 states of a slab as one float4 each); every thread
// keeps a 4 x 4 register tile and accumulates with FFMA.  The TPU kernel
// pads W and S up to its block grid; here every load and store masks the
// ragged W and S edges itself, so the caller pads nothing.  The epilogue
// (tag row gather, wildcard, self loop, clamp, valid mask) runs in the same
// block on the register tile, so src never reaches device memory.
//
// The C entry point takes device pointers and a CUDA stream and returns
// the cudaError_t of the launch (0 = launched).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;     // output rows of a block (W axis)
constexpr int kTileCols = 64;     // output states of a block (S axis)
constexpr int kSlab = 16;         // reduction states per shared-memory slab
constexpr int kPer = 4;           // a thread's rows and states
constexpr int kThreads = (kTileRows / kPer) * (kTileCols / kPer);   // 256
constexpr int kPadA = 4;          // keeps the transposed rows float4-aligned
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
nfa_transition_kernel(const float* __restrict__ parent_rows, int w, int s,
                      const int32_t* __restrict__ tags,
                      const float* __restrict__ req, int t,
                      const float* __restrict__ wild,
                      const float* __restrict__ parent_1h,
                      const float* __restrict__ selfloop,
                      float* __restrict__ out) {
  __shared__ __align__(16) float a_s[kSlab][kTileRows + kPadA];  // A^T slab
  __shared__ __align__(16) float b_s[kSlab][kTileCols];          // P slab

  const int tid = threadIdx.x;
  const int tx = tid % (kTileCols / kPer);     // state group of this thread
  const int ty = tid / (kTileCols / kPer);     // row group of this thread
  const int row0 = blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * kTileCols;

  // loaders: A as (row, 4 consecutive k), P as (k, 4 consecutive states)
  const int a_row = tid / (kSlab / kPer);
  const int a_k = (tid % (kSlab / kPer)) * kPer;
  const int b_k = tid / (kTileCols / kPer);
  const int b_col = (tid % (kTileCols / kPer)) * kPer;
  const int ga_row = row0 + a_row;
  const float* a_src = parent_rows + static_cast<size_t>(ga_row) * s;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kSlab) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = k0 + a_k + q;
      a_s[a_k + q][a_row] = (ga_row < w && k < s) ? a_src[k] : 0.f;
    }
    {
      const int k = k0 + b_k;
      const float* b_src = parent_1h + static_cast<size_t>(k) * s;
      float v[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int c = col0 + b_col + q;
        v[q] = (k < s && c < s) ? b_src[c] : 0.f;
      }
      *reinterpret_cast<float4*>(&b_s[b_k][b_col]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[k][ty * kPer]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[k][tx * kPer]);
      const float av[kPer] = {a.x, a.y, a.z, a.w};
      const float bv[kPer] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue on the register tile
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty * kPer + i;
    if (r >= w) continue;
    const int tag = tags[r];
    const float valid = tag >= 0 ? 1.f : 0.f;
    const bool has_row = tag >= 0 && tag < t;
    const float* req_row = req + static_cast<size_t>(has_row ? tag : 0) * s;
    const float* p_row = parent_rows + static_cast<size_t>(r) * s;
    float* o_row = out + static_cast<size_t>(r) * s;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx * kPer + j;
      if (c >= s) continue;
      const float tagmatch = (has_row ? req_row[c] : 0.f) + wild[c];
      // unfused products and sum, as the reference rounds them
      const float v = __fadd_rn(__fmul_rn(acc[i][j], tagmatch),
                                __fmul_rn(p_row[c], selfloop[c]));
      o_row[c] = fminf(v, 1.f) * valid;
    }
  }
}

}  // namespace

extern "C" {

// parent_rows (W, S) f32, tags (W,) int32, req (T, S) f32, wild (S,) f32,
// parent_1h (S, S) f32, selfloop (S,) f32 -> out (W, S) f32; all
// contiguous, row-major, on the stream's device.
int nt_transition(const float* parent_rows, int w, int s, const int32_t* tags,
                  const float* req, int t, const float* wild,
                  const float* parent_1h, const float* selfloop, float* out,
                  void* stream) {
  if (w <= 0 || s <= 0) return 0;
  const int col_tiles = (s + kTileCols - 1) / kTileCols;
  if (col_tiles > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileRows - 1) / kTileRows, col_tiles);
  nfa_transition_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      parent_rows, w, s, tags, req, t, wild, parent_1h, selfloop, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
