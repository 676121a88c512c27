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
// three shifted copies because a grid block cannot read past its tile;
// here each thread reads its four bytes straight from the row (the
// neighbours' loads hit the same cache lines), so nothing is copied.
//
// What this simple design does about it: one thread per position, a 2-D
// grid of (position blocks, rows), coalesced byte loads and int32 stores.
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
constexpr int kLt = 60;     // '<'
constexpr int kSlash = 47;  // '/'
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ inline int symbol_value(int b) {
  if (b >= 97 && b <= 122) return b - 97;       // a-z
  if (b >= 65 && b <= 90) return b - 65 + 26;   // A-Z
  if (b >= 48 && b <= 57) return b - 48 + 52;   // 0-9
  if (b == 95) return 62;                       // '_'
  if (b == 46) return 63;                       // '.'
  return -1;
}

__global__ void predecode_kernel(const uint8_t* __restrict__ data, int rows,
                                 int length, int32_t* __restrict__ kind,
                                 int32_t* __restrict__ tag) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= length) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* row = data + static_cast<size_t>(r) * length;
    const int b0 = row[p];
    const int b1 = p + 1 < length ? row[p + 1] : 0;
    const int b2 = p + 2 < length ? row[p + 2] : 0;
    const int b3 = p + 3 < length ? row[p + 3] : 0;
    const bool is_lt = b0 == kLt;
    const bool is_close = is_lt && b1 == kSlash;
    const bool is_open = is_lt && !is_close;
    const int v0 = symbol_value(is_close ? b2 : b1);
    const int v1 = symbol_value(is_close ? b3 : b2);
    const bool ok = v0 >= 0 && v1 >= 0;
    const int k = (is_open && ok) ? kOpen : ((is_close && ok) ? kClose : kPad);
    const size_t i = static_cast<size_t>(r) * length + p;
    kind[i] = k;
    tag[i] = k != kPad ? v0 * 64 + v1 : -1;
  }
}

}  // namespace

extern "C" {

int pd_predecode(const void* data, int rows, int length, void* kind,
                 void* tag, void* stream) {
  const dim3 grid((length + kThreads - 1) / kThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  predecode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), rows, length,
      static_cast<int32_t*>(kind), static_cast<int32_t*>(tag));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
