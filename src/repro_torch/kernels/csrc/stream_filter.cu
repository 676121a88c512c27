// Streaming-filter megakernels for Hopper (sm_90a): events -> verdicts (K1)
// and raw bytes -> verdicts in one launch (K2).
//
// Replaces, in the JAX package, src/repro/kernels/stream_filter.py:
//   K1  stream_filter_pallas        (_kernel, _stream_events, _advance)
//   K2  stream_filter_bytes_pallas  (_bytes_kernel, _bytes_stream,
//                                    parse.fused_predecode)
// Both compute exactly what those functions compute: per (document or
// segment, state block) a bit-packed NFA stack of (max_depth+2, WB) words
// advanced once per event, with accept lanes and first-match ordinals.
//
// What bounds them on this card: the events of one (document, block) pair
// form a sequential chain -- each OPEN reads the stack row the previous
// events left -- so a pair cannot be split across threads in time, only
// across its WB words.  The bytes are read once per state block (G times
// per segment), which is little next to the chain.  Neither the bytes nor
// the integer operations bound the kernels; the chain's latency does.
//
// What this simple design does about it: one thread block per (document
// or segment, state block), all of them in flight at once; the block's
// tables and stack live in shared memory; one thread per packed word, so
// the per-event step is a handful of shared-memory reads and two barriers.
// Only OPEN events do work (a CLOSE only pops the depth, a PAD nothing);
// an OPEN gathers only the source bits its tag can use (the set bits of
// the tag's mask word) and scans the accept lanes only when an accept
// state turns on for the first time in the document.  Making the chain
// itself shorter is later work.
//
// Packed words are uint32_t here and torch.int32 bit views outside.  The C
// entry points take device pointers and a CUDA stream and return the
// cudaError_t of the launch (0 = launched).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOpen = 0;
constexpr int kClose = 1;
constexpr int kPad = 2;
constexpr int32_t kNoMatch = 0x7fffffff;
constexpr int kLt = 60;     // '<'
constexpr int kSlash = 47;  // '/'

struct Tables {
  const uint32_t* tagmask;   // (G, T+1, WB) per-tag match words; row T: wild
  const int32_t* pw;         // (G, WB, 32) parent word per state lane
  const int32_t* pb;         // (G, WB, 32) parent bit per state lane
  const uint32_t* selfloop;  // (G, WB)
  const uint32_t* init;      // (G, WB)
  const int32_t* acc_word;   // (G, QB)
  const int32_t* acc_bit;    // (G, QB)
  int n_blocks, n_tags, wb, qb, max_depth;
};

// Dynamic shared memory of one thread block, in this order.
struct Smem {
  uint32_t* tagmask;  // (T+1) * WB
  int32_t* src;       // 32 * WB: [j * WB + w] = parent state of lane j, word w
  uint32_t* stack;    // (max_depth + 2) * WB
  uint32_t* accmask;  // WB: OR of every accept lane's bit, per word
  int32_t* accloc;    // QB: accept lane -> local state (word * 32 + bit)
  int32_t* matched;   // QB
  int32_t* first;     // QB
  int32_t* ev;        // blockDim.x: one window of event words
  int32_t* pos;       // blockDim.x: their byte positions (K2)
  int32_t* warpcnt;   // 32: hits per warp in a byte window (K2)
};

__host__ __device__ inline size_t smem_bytes(int n_tags, int wb, int qb,
                                             int max_depth, int threads) {
  return 4 * (static_cast<size_t>(n_tags + 1) * wb + 32 * wb +
              static_cast<size_t>(max_depth + 2) * wb + wb + 3 * qb +
              2 * static_cast<size_t>(threads) + 32);
}

__device__ inline Smem carve(unsigned char* base, const Tables& t) {
  Smem s;
  uint32_t* p = reinterpret_cast<uint32_t*>(base);
  s.tagmask = p;                                   p += (t.n_tags + 1) * t.wb;
  s.src = reinterpret_cast<int32_t*>(p);           p += 32 * t.wb;
  s.stack = p;                                     p += (t.max_depth + 2) * t.wb;
  s.accmask = p;                                   p += t.wb;
  s.accloc = reinterpret_cast<int32_t*>(p);        p += t.qb;
  s.matched = reinterpret_cast<int32_t*>(p);       p += t.qb;
  s.first = reinterpret_cast<int32_t*>(p);         p += t.qb;
  s.ev = reinterpret_cast<int32_t*>(p);            p += blockDim.x;
  s.pos = reinterpret_cast<int32_t*>(p);           p += blockDim.x;
  s.warpcnt = reinterpret_cast<int32_t*>(p);
  return s;
}

// Load block g's tables into shared memory, root the stack, clear the lanes.
__device__ void load_block(const Smem& s, const Tables& t, int g) {
  const int tid = threadIdx.x, nt = blockDim.x, wb = t.wb;
  const uint32_t* tm = t.tagmask + static_cast<size_t>(g) * (t.n_tags + 1) * wb;
  for (int i = tid; i < (t.n_tags + 1) * wb; i += nt) s.tagmask[i] = tm[i];
  const int32_t* pw = t.pw + static_cast<size_t>(g) * wb * 32;
  const int32_t* pb = t.pb + static_cast<size_t>(g) * wb * 32;
  for (int i = tid; i < wb * 32; i += nt)
    s.src[(i & 31) * wb + (i >> 5)] = pw[i] * 32 + pb[i];
  for (int w = tid; w < wb; w += nt) {
    s.stack[w] = t.init[static_cast<size_t>(g) * wb + w];
    s.accmask[w] = 0u;
  }
  __syncthreads();
  for (int q = tid; q < t.qb; q += nt) {
    const int loc = t.acc_word[static_cast<size_t>(g) * t.qb + q] * 32 +
                    t.acc_bit[static_cast<size_t>(g) * t.qb + q];
    s.accloc[q] = loc;
    s.matched[q] = 0;
    s.first[q] = kNoMatch;
    atomicOr(&s.accmask[loc >> 5], 1u << (loc & 31));
  }
  __syncthreads();
}

// One OPEN event with tag `tag` and ordinal `ord`, called by every thread
// of the block (the arguments are uniform).  Thread w < WB owns word w:
//   src  = the word's 32 parent bits, gathered from the top-of-stack row
//   nxt  = (src & tagmask[tclip]) | (selfloop & row)
// nxt is pushed at clip(depth + 1) and the accept lanes read from it.
// `pending` holds the word's accept states not active yet in this
// document: every lane of a state matches at the state's first activation,
// so the lanes are scanned only when some pending state turns on.
__device__ inline void open_event(const Smem& s, const Tables& t, int tag,
                                  int ord, int& depth, uint32_t selfw,
                                  uint32_t& pending) {
  const int tid = threadIdx.x, wb = t.wb;
  const int tclip = (tag >= 0 && tag < t.n_tags) ? tag : t.n_tags;
  const uint32_t* row = s.stack + depth * wb;
  uint32_t nxt = 0u;
  if (tid < wb) {
    uint32_t m = s.tagmask[tclip * wb + tid];
    uint32_t src = 0u;
    while (m) {  // only lanes the tag can match need their parent bit
      const int j = __ffs(m) - 1;
      m &= m - 1u;
      const int p = s.src[j * wb + tid];
      src |= ((row[p >> 5] >> (p & 31)) & 1u) << j;
    }
    nxt = src | (selfw & row[tid]);
  }
  const int widx = min(depth + 1, t.max_depth + 1);
  __syncthreads();  // every read of `row` is done before any write
  if (tid < wb) s.stack[widx * wb + tid] = nxt;
  const int any = __syncthreads_or((nxt & pending) != 0u);
  pending &= ~nxt;
  depth = widx;
  if (any) {
    const uint32_t* top = s.stack + widx * wb;
    for (int q = tid; q < t.qb; q += blockDim.x) {
      if (s.matched[q]) continue;
      const int loc = s.accloc[q];
      if ((top[loc >> 5] >> (loc & 31)) & 1u) {
        s.matched[q] = 1;
        s.first[q] = ord;
      }
    }
  }
}

// K1: one thread block per (document b, state block g) over fused event
// words (kind << 16) | (tag & 0xffff); outputs (B, G, QB).
__global__ void events_kernel(const int32_t* __restrict__ events, int n_events,
                              Tables t, int32_t* __restrict__ matched,
                              int32_t* __restrict__ first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const Smem s = carve(smem, t);
  load_block(s, t, g);
  const size_t gw = static_cast<size_t>(g) * t.wb + tid;
  const uint32_t selfw = tid < t.wb ? t.selfloop[gw] : 0u;
  uint32_t pending = tid < t.wb ? s.accmask[tid] : 0u;
  const int32_t* evrow = events + static_cast<size_t>(b) * n_events;
  int depth = 0;
  for (int base = 0; base < n_events; base += blockDim.x) {
    const int n = min(static_cast<int>(blockDim.x), n_events - base);
    __syncthreads();  // the previous window is consumed
    if (tid < n) s.ev[tid] = evrow[base + tid];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int ev = s.ev[j];
      const int kind = ev >> 16;
      if (kind == kOpen)
        open_event(s, t, ev & 0xffff, base + j, depth, selfw, pending);
      else if (kind == kClose)
        depth = max(depth - 1, 0);
    }
  }
  const size_t out = (static_cast<size_t>(b) * t.n_blocks + g) * t.qb;
  for (int q = tid; q < t.qb; q += blockDim.x) {
    matched[out + q] = s.matched[q];
    first[out + q] = s.first[q];
  }
}

__device__ inline int symbol_value(int b) {
  if (b >= 97 && b <= 122) return b - 97;       // a-z
  if (b >= 65 && b <= 90) return b - 65 + 26;   // A-Z
  if (b >= 48 && b <= 57) return b - 48 + 52;   // 0-9
  if (b == 95) return 62;                       // '_'
  if (b == 46) return 63;                       // '.'
  return -1;
}

// K2: one thread block per (segment s, state block g) over raw bytes
// (S, L) with document starts (S, D+1); outputs (S, G, D, QB).
__global__ void bytes_kernel(const uint8_t* __restrict__ data, int length,
                             const int32_t* __restrict__ starts, int n_docs,
                             Tables t, int32_t* __restrict__ matched,
                             int32_t* __restrict__ first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, seg = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const Smem s = carve(smem, t);
  load_block(s, t, g);
  const size_t gw = static_cast<size_t>(g) * t.wb + tid;
  const uint32_t selfw = tid < t.wb ? t.selfloop[gw] : 0u;
  const uint32_t initw = tid < t.wb ? t.init[gw] : 0u;
  const uint32_t accw = tid < t.wb ? s.accmask[tid] : 0u;
  uint32_t pending = accw;
  const uint8_t* row = data + static_cast<size_t>(seg) * length;
  const int32_t* st = starts + static_cast<size_t>(seg) * (n_docs + 1);
  int32_t* mout = matched + (static_cast<size_t>(seg) * t.n_blocks + g) *
                                n_docs * t.qb;
  int32_t* fout = first + (static_cast<size_t>(seg) * t.n_blocks + g) *
                              n_docs * t.qb;
  // slot d ends where slot d + 1 starts; the last slot never ends early
  int d = 0;
  int bound = n_docs > 1 ? st[1] : INT32_MAX;
  int depth = 0, ord = 0;
  for (int base = 0; base < length; base += blockDim.x) {
    // classify one position per thread (3-byte lookahead, zeros past L)
    const int p = base + tid;
    int word = 0;
    bool keep = false;
    if (p < length) {
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
      const int kind = (is_open && ok) ? kOpen : ((is_close && ok) ? kClose : kPad);
      keep = kind != kPad;
      word = (kind << 16) | ((v0 * 64 + v1) & 0xffff);
    }
    // compact the hits in position order: ballot within each warp, then
    // the counts of the lower warps
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the previous window is consumed
    if (lane == 0) s.warpcnt[warp] = __popc(mask);
    __syncthreads();
    int off = __popc(mask & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = s.warpcnt[w];
      if (w < warp) off += c;
      total += c;
    }
    if (keep) {
      s.ev[off] = word;
      s.pos[off] = p;
    }
    __syncthreads();
    for (int j = 0; j < total; ++j) {
      const int ev = s.ev[j];
      const int pos = s.pos[j];
      while (pos >= bound) {  // crossed one or more document boundaries
        for (int q = tid; q < t.qb; q += blockDim.x) {
          mout[static_cast<size_t>(d) * t.qb + q] = s.matched[q];
          fout[static_cast<size_t>(d) * t.qb + q] = s.first[q];
          s.matched[q] = 0;
          s.first[q] = kNoMatch;
        }
        if (tid < t.wb) s.stack[tid] = initw;
        pending = accw;
        depth = 0;
        ord = 0;
        ++d;
        bound = d + 1 < n_docs ? st[d + 1] : INT32_MAX;
        __syncthreads();
      }
      const int kind = ev >> 16;
      if (kind == kOpen)
        open_event(s, t, ev & 0xffff, ord, depth, selfw, pending);
      else if (kind == kClose)
        depth = max(depth - 1, 0);
      ++ord;
    }
  }
  // the document the stream ended inside; later (empty) slots keep zeros
  for (int q = tid; q < t.qb; q += blockDim.x) {
    mout[static_cast<size_t>(d) * t.qb + q] = s.matched[q];
    fout[static_cast<size_t>(d) * t.qb + q] = s.first[q];
  }
  for (int dd = d + 1; dd < n_docs; ++dd)
    for (int q = tid; q < t.qb; q += blockDim.x) {
      mout[static_cast<size_t>(dd) * t.qb + q] = 0;
      fout[static_cast<size_t>(dd) * t.qb + q] = kNoMatch;
    }
}

int threads_for(int wb) { return ((wb > 32 ? wb : 32) + 31) / 32 * 32; }

Tables make_tables(const void* tagmask, const void* pw, const void* pb,
                   const void* selfloop, const void* init, const void* acc_word,
                   const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
                   int max_depth) {
  return Tables{static_cast<const uint32_t*>(tagmask),
                static_cast<const int32_t*>(pw),
                static_cast<const int32_t*>(pb),
                static_cast<const uint32_t*>(selfloop),
                static_cast<const uint32_t*>(init),
                static_cast<const int32_t*>(acc_word),
                static_cast<const int32_t*>(acc_bit),
                n_blocks, n_tags, wb, qb, max_depth};
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes of one launch.
long long sf_smem_bytes(int n_tags, int wb, int qb, int max_depth) {
  return static_cast<long long>(
      smem_bytes(n_tags, wb, qb, max_depth, threads_for(wb)));
}

int sf_events(const void* events, int n_docs, int n_events,
              const void* tagmask, const void* pw, const void* pb,
              const void* selfloop, const void* init, const void* acc_word,
              const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
              int max_depth, void* matched, void* first, void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const int threads = threads_for(wb);
  const size_t smem = smem_bytes(n_tags, wb, qb, max_depth, threads);
  cudaError_t err = cudaFuncSetAttribute(
      events_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  events_kernel<<<dim3(n_blocks, n_docs), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(events), n_events, t,
      static_cast<int32_t*>(matched), static_cast<int32_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

int sf_bytes(const void* data, int n_segments, int length, const void* starts,
             int n_docs, const void* tagmask, const void* pw, const void* pb,
             const void* selfloop, const void* init, const void* acc_word,
             const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
             int max_depth, void* matched, void* first, void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const int threads = threads_for(wb);
  const size_t smem = smem_bytes(n_tags, wb, qb, max_depth, threads);
  cudaError_t err = cudaFuncSetAttribute(
      bytes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bytes_kernel<<<dim3(n_blocks, n_segments), threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), length,
      static_cast<const int32_t*>(starts), n_docs, t,
      static_cast<int32_t*>(matched), static_cast<int32_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
