// Levelwise NFA transition for Hopper (sm_90a): one document level, or one
// wavefront chunk, of W nodes advanced over S states at once (K6).
//
// Replaces, in the JAX package, src/repro/kernels/nfa_transition.py:
//   K6  nfa_transition_pallas  (_kernel)
// It computes exactly what that kernel computes, in float32, for every
// plan the system builds:
//
//   src      = parent_rows @ parent_1h                      (W, S)
//   tagmatch = onehot(tags) @ req + wild                    (W, S)
//   out      = min(src * tagmatch + parent_rows * selfloop, 1) * (tags >= 0)
//
// parent_1h has exactly one 1 per column (P[in_state[s], s] = 1, padding
// states have parent 0), so the product is a gather:
// src[w, s] = parent_rows[w, parent_idx[s]] with parent_idx = in_state.
// The kernel takes parent_idx (S,) int32 and gathers; the one-term sum is
// exact, so every value equals the product's.  onehot(tags) @ req is a row
// gather too: row tags[r] of req, or a zero row when the tag is < 0 or
// >= T (as jax.nn.one_hot gives), so a tag past the plan's tag space still
// matches the wildcard states; only tags < 0 mask the row out.
//
// What bounds it on this card: bytes.  Each output element costs about
// five operations against 8 bytes of device memory (its parent-row value
// read once, its output written once); the req table (T x S floats, 1.9 MB
// at 3,712 states) and the (S,) vectors stay in L2 and L1.  At a wavefront
// step (W = 2,048, S = 3,712) that is 62.8 MB, 0.0187 ms at 3.35 TB/s.
//
// What the design does about it: a grid of a few blocks per SM walks the
// rows (block b takes rows b, b + grid, ...).  Each block stages a parent
// row in shared memory with cp.async, 16 bytes a thread, double-buffered,
// so the next row's copy is in flight while this row is gathered from
// shared memory; the row is read from device memory once, coalesced.
// Each thread owns four consecutive states of a row and reads their
// parent_idx, wild and selfloop as one 16-byte load each (L1-resident
// across rows), its req row slice from L2, and writes its four outputs as
// one 16-byte streaming store.  Where S is not a multiple of 4 (or a
// pointer is not 16-byte aligned) the same kernel runs one state a thread
// with 4-byte copies.  Where two staged rows do not fit the block's shared
// memory (S past about 29,000 states on an H100), a second kernel reads
// the parent values straight from device memory (the row's own coalesced
// read leaves it in L1 and L2 for the gather).  Ragged W and S are masked
// in the loops, so the caller pads nothing.  A parent_idx outside [0, S)
// reads 0 (no parent) instead of leaving the row.
//
// The C entry point takes device pointers and a CUDA stream and returns
// the cudaError_t of the launch (0 = launched).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// one output element, rounded as the reference rounds it (no FMA)
__device__ __forceinline__ float step(float src, float tagmatch, float own,
                                      float self, float valid) {
  const float v = __fadd_rn(__fmul_rn(src, tagmatch), __fmul_rn(own, self));
  return fminf(v, 1.f) * valid;
}

__device__ __forceinline__ float parent_of(const float* row, int p, int s) {
  return static_cast<unsigned>(p) < static_cast<unsigned>(s) ? row[p] : 0.f;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* parent_rows;
  int w, s;
  const int32_t* tags;
  const float* req;
  int t;
  const float* wild;
  const int32_t* parent_idx;
  const float* selfloop;
  float* out;
};

// Row r's outputs from `row`, the parent row (staged in shared memory or
// in device memory).  V = 4: four consecutive states a thread, 16-byte
// loads and stores (S % 4 == 0, aligned pointers); V = 1: one state.
template <int V>
__device__ __forceinline__ void row_out(const Args& a, int r,
                                        const float* row) {
  const int tag = __ldg(a.tags + r);
  const float valid = tag >= 0 ? 1.f : 0.f;
  const bool has_row = tag >= 0 && tag < a.t;
  const float* req_row = a.req + static_cast<size_t>(has_row ? tag : 0) * a.s;
  float* o_row = a.out + static_cast<size_t>(r) * a.s;
  if (V == 4) {
    const int n4 = a.s >> 2;
    for (int c = threadIdx.x; c < n4; c += blockDim.x) {
      const int4 p = __ldg(reinterpret_cast<const int4*>(a.parent_idx) + c);
      const float4 wd = __ldg(reinterpret_cast<const float4*>(a.wild) + c);
      const float4 sl = __ldg(reinterpret_cast<const float4*>(a.selfloop) + c);
      const float4 rq = has_row
          ? __ldg(reinterpret_cast<const float4*>(req_row) + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 own = reinterpret_cast<const float4*>(row)[c];
      float4 v;
      v.x = step(parent_of(row, p.x, a.s), rq.x + wd.x, own.x, sl.x, valid);
      v.y = step(parent_of(row, p.y, a.s), rq.y + wd.y, own.y, sl.y, valid);
      v.z = step(parent_of(row, p.z, a.s), rq.z + wd.z, own.z, sl.z, valid);
      v.w = step(parent_of(row, p.w, a.s), rq.w + wd.w, own.w, sl.w, valid);
      __stcs(reinterpret_cast<float4*>(o_row) + c, v);
    }
  } else {
    for (int c = threadIdx.x; c < a.s; c += blockDim.x) {
      const float rq = has_row ? __ldg(req_row + c) : 0.f;
      o_row[c] = step(parent_of(row, __ldg(a.parent_idx + c), a.s),
                      rq + __ldg(a.wild + c), row[c], __ldg(a.selfloop + c),
                      valid);
    }
  }
}

// Stage row r of parent_rows into `dst` (each thread its own chunks).
template <int V>
__device__ __forceinline__ void stage(const Args& a, int r, float* dst) {
  const float* src = a.parent_rows + static_cast<size_t>(r) * a.s;
  const int n = a.s / V;
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    cp_async(dst + c * V, src + c * V, 4 * V);
}

// Parent rows staged in shared memory, two buffers of S floats (rounded
// up to 4), the next row's copy in flight while this one is gathered.
template <int V>
__global__ void __launch_bounds__(kThreads)
transition_staged(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = (a.s + 3) & ~3;
  int r = blockIdx.x;
  if (r >= a.w) return;
  stage<V>(a, r, smem);
  cp_async_commit();
  for (int i = 0; r < a.w; r += gridDim.x, ++i) {
    const int next = r + gridDim.x;
    if (next < a.w) {
      stage<V>(a, next, smem + ((i + 1) & 1) * pitch);
      cp_async_commit();
      cp_async_wait<1>();   // this row's copy is done, the next in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();        // every thread's chunks of this row have landed
    row_out<V>(a, r, smem + (i & 1) * pitch);
    __syncthreads();        // this buffer is read before it is refilled
  }
}

// Rows too long to stage: the parent values come from device memory.
template <int V>
__global__ void __launch_bounds__(kThreads)
transition_direct(Args a) {
  for (int r = blockIdx.x; r < a.w; r += gridDim.x)
    row_out<V>(a, r, a.parent_rows + static_cast<size_t>(r) * a.s);
}

size_t staged_bytes(int s) { return 2 * 4 * static_cast<size_t>((s + 3) & ~3); }

// The current device's SM count and opt-in shared memory per block,
// read once per device.
struct Device {
  int sms = 0, smem_optin = 0;
};

cudaError_t current_device(Device* out) {
  constexpr int kMaxDevices = 64;
  static Device known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = known[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) {
      d.sms = 0;
      return err;
    }
  }
  *out = d;
  return cudaSuccess;
}

template <class Kernel>
int launch(Kernel kernel, const Args& a, size_t smem, int sms,
           cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(a.w < resident ? a.w : resident);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most states a row may have for the staged kernel on this device
// (-1 if the device cannot be read).
int nt_staged_max_states() {
  Device d;
  if (current_device(&d) != cudaSuccess) return -1;
  return (d.smem_optin / 8) & ~3;
}

// parent_rows (W, S) f32, tags (W,) int32, req (T, S) f32, wild (S,) f32,
// parent_idx (S,) int32, selfloop (S,) f32 -> out (W, S) f32; all
// contiguous, row-major, on the stream's device.  vec4 != 0 asks for the
// 16-byte path (S % 4 == 0 and 16-byte aligned pointers).
int nt_transition(const float* parent_rows, int w, int s, const int32_t* tags,
                  const float* req, int t, const float* wild,
                  const int32_t* parent_idx, const float* selfloop,
                  float* out, int vec4, void* stream) {
  if (w <= 0 || s <= 0) return 0;
  const Args a{parent_rows, w, s, tags, req, t, wild, parent_idx, selfloop,
               out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Device d;
  const cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = staged_bytes(s);
  if (smem <= static_cast<size_t>(d.smem_optin))
    return vec4 ? launch(transition_staged<4>, a, smem, d.sms, st)
                : launch(transition_staged<1>, a, smem, d.sms, st);
  return vec4 ? launch(transition_direct<4>, a, 0, d.sms, st)
              : launch(transition_direct<1>, a, 0, d.sms, st);
}

}  // extern "C"
