// Streaming-filter megakernels for Hopper (sm_90a): events -> accept lanes
// (K1), raw bytes -> accept lanes in one launch (K2), and their sparse
// twins, which end in a bounded match list instead (K4, K3).
//
// Replaces, in the JAX package, src/repro/kernels/stream_filter.py:
//   K1  stream_filter_pallas              (_kernel, _stream_events, _advance)
//   K2  stream_filter_bytes_pallas        (_bytes_kernel, _bytes_stream,
//                                          parse.fused_predecode)
//   K4  stream_filter_pallas_sparse       (_kernel_sparse, _emit_rows,
//                                          _sparse_init)
//   K3  stream_filter_bytes_pallas_sparse (_bytes_kernel_sparse)
// All four compute exactly what those functions compute: per (document or
// segment, state block) a bit-packed NFA stack of (max_depth+2, WB) words
// advanced once per event, with accept lanes and first-match ordinals.
// K1/K4 share one event loop (events_kernel) and K2/K3 another
// (bytes_kernel); a template parameter picks what a finished document
// does with its lanes: DenseOut writes them out, SparseOut emits one
// (doc, accept class, first) row per hit lane into a bounded buffer.
//
// What bounds them on this card: the events of one (document, block) pair
// form a sequential chain -- each OPEN reads the stack row the previous
// events left -- so a pair cannot be split across threads in time, only
// across its WB words.  The bytes are read once per state block (G times
// per segment), which is little next to the chain.  Neither the bytes nor
// the integer operations bound the kernels; the chain's latency does.  The
// sparse epilogue adds one emission per (document, block): two passes over
// the QB lanes and one atomicAdd, small next to the chain.
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
// The TPU epilogue ranks hits with a matmul cumsum and masked sums and
// relies on its grid running in order, so one running counter is an
// exclusive scan.  Here thread blocks run in parallel: each emission ranks
// its hits with ballots and per-warp counts, reserves its rows with one
// atomicAdd on a device counter, and writes the rows below `cap`.  The
// counter keeps the true total, so count > cap still signals overflow;
// row order varies from run to run.
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
  int32_t* pos;       // blockDim.x: their byte positions (K2, K3)
  int32_t* warpcnt;   // 33: hits per warp in a byte window or a lane chunk,
                      // and [32] one emission's first row (K3, K4)
  int32_t* lanecls;   // QB: accept class of each lane, -1 inert (K3, K4)
};

__host__ __device__ inline size_t smem_bytes(int n_tags, int wb, int qb,
                                             int max_depth, int threads,
                                             bool sparse) {
  return 4 * (static_cast<size_t>(n_tags + 1) * wb + 32 * wb +
              static_cast<size_t>(max_depth + 2) * wb + wb +
              (sparse ? 4 : 3) * static_cast<size_t>(qb) +
              2 * static_cast<size_t>(threads) + 33);
}

__device__ inline Smem carve(unsigned char* base, const Tables& t,
                             bool sparse) {
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
  s.warpcnt = reinterpret_cast<int32_t*>(p);        p += 33;
  s.lanecls = sparse ? reinterpret_cast<int32_t*>(p) : nullptr;
  return s;
}

// Load block g's tables into shared memory, root the stack, clear the
// lanes; `lane_cls` (G, QB), when given, names the accept classes.
__device__ void load_block(const Smem& s, const Tables& t, int g,
                           const int32_t* lane_cls) {
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
    if (lane_cls) s.lanecls[q] = lane_cls[static_cast<size_t>(g) * t.qb + q];
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

// ------------------------------------------------------------- outputs
// What a finished document does with its lanes.  `row` is the document
// (events) or segment (bytes) of the thread block, `slot` the document
// slot within it (always 0 for events).  Every thread calls flush().

// K1/K2: the lanes of every (row, block, slot) out as (rows, G, slots, QB).
struct DenseOut {
  int32_t* matched;
  int32_t* first;
  int n_slots;
  static constexpr bool kSparse = false;

  __device__ const int32_t* lane_cls() const { return nullptr; }

  __device__ void flush(const Smem& s, const Tables& t, int g, int row,
                        int slot) const {
    const size_t out =
        ((static_cast<size_t>(row) * t.n_blocks + g) * n_slots + slot) * t.qb;
    for (int q = threadIdx.x; q < t.qb; q += blockDim.x) {
      matched[out + q] = s.matched[q];
      first[out + q] = s.first[q];
    }
  }

  // a slot the stream never reached: no lanes
  __device__ void clear(const Tables& t, int g, int row, int slot) const {
    const size_t out =
        ((static_cast<size_t>(row) * t.n_blocks + g) * n_slots + slot) * t.qb;
    for (int q = threadIdx.x; q < t.qb; q += blockDim.x) {
      matched[out + q] = 0;
      first[out + q] = kNoMatch;
    }
  }
};

// K3/K4: one (doc, accept class, first) row per hit lane into a bounded
// buffer (cap, 3); `count` keeps the true number of rows.
struct SparseOut {
  const int32_t* doc_map;   // (rows, n_slots) batch row of each slot, -1 unused
  const int32_t* classes;   // (G, QB) accept class of each lane, -1 inert
  int32_t* buf;
  int32_t* count;
  int n_slots, cap;
  static constexpr bool kSparse = true;

  __device__ const int32_t* lane_cls() const { return classes; }

  __device__ void flush(const Smem& s, const Tables& t, int, int row,
                        int slot) const {
    emit(s, t, doc_map[static_cast<size_t>(row) * n_slots + slot]);
  }

  __device__ void clear(const Tables&, int, int, int) const {}

  // The hits are the lanes with matched && class >= 0 of a slot with
  // doc >= 0.  Pass 1 sums them over the block and reserves their rows
  // with one atomicAdd; pass 2 ranks them in lane order, blockDim.x lanes
  // at a time (ballot within each warp, then the counts of the lower
  // warps), and writes the rows below `cap`.  A thread reads only the
  // lanes q = tid (mod blockDim.x), the ones it resets after a flush.
  __device__ void emit(const Smem& s, const Tables& t, int doc) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    int mine = 0;
    if (doc >= 0)
      for (int q = tid; q < t.qb; q += blockDim.x)
        mine += (s.matched[q] != 0 && s.lanecls[q] >= 0) ? 1 : 0;
    mine = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0) s.warpcnt[warp] = mine;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += s.warpcnt[w];
    if (total > 0) {  // uniform over the block
      if (tid == 0) s.warpcnt[32] = atomicAdd(count, total);
      __syncthreads();  // the first row is out; every read above is done
      int next = s.warpcnt[32];
      for (int q0 = 0; q0 < t.qb; q0 += blockDim.x) {
        const int q = q0 + tid;
        const bool hit =
            q < t.qb && s.matched[q] != 0 && s.lanecls[q] >= 0;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) s.warpcnt[warp] = __popc(mask);
        __syncthreads();
        int off = __popc(mask & ((1u << lane) - 1u)), chunk = 0;
        for (int w = 0; w < nwarps; ++w) {
          const int c = s.warpcnt[w];
          if (w < warp) off += c;
          chunk += c;
        }
        if (hit && next + off < cap) {
          int32_t* r = buf + 3 * static_cast<size_t>(next + off);
          r[0] = doc;
          r[1] = s.lanecls[q];
          r[2] = s.first[q];
        }
        next += chunk;
        __syncthreads();  // the counts are read before the next chunk's
      }
    }
    __syncthreads();  // every read of warpcnt is done before its next use
  }
};

// ------------------------------------------------------------- kernels
// K1/K4: one thread block per (document b, state block g) over fused event
// words (kind << 16) | (tag & 0xffff).
template <class Out>
__global__ void events_kernel(const int32_t* __restrict__ events,
                              int n_events, Tables t, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const Smem s = carve(smem, t, Out::kSparse);
  load_block(s, t, g, out.lane_cls());
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
  out.flush(s, t, g, b, 0);
}

__device__ inline int symbol_value(int b) {
  if (b >= 97 && b <= 122) return b - 97;       // a-z
  if (b >= 65 && b <= 90) return b - 65 + 26;   // A-Z
  if (b >= 48 && b <= 57) return b - 48 + 52;   // 0-9
  if (b == 95) return 62;                       // '_'
  if (b == 46) return 63;                       // '.'
  return -1;
}

// K2/K3: one thread block per (segment s, state block g) over raw bytes
// (S, L) with document starts (S, D+1).
template <class Out>
__global__ void bytes_kernel(const uint8_t* __restrict__ data, int length,
                             const int32_t* __restrict__ starts, int n_docs,
                             Tables t, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, seg = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const Smem s = carve(smem, t, Out::kSparse);
  load_block(s, t, g, out.lane_cls());
  const size_t gw = static_cast<size_t>(g) * t.wb + tid;
  const uint32_t selfw = tid < t.wb ? t.selfloop[gw] : 0u;
  const uint32_t initw = tid < t.wb ? t.init[gw] : 0u;
  const uint32_t accw = tid < t.wb ? s.accmask[tid] : 0u;
  uint32_t pending = accw;
  const uint8_t* row = data + static_cast<size_t>(seg) * length;
  const int32_t* st = starts + static_cast<size_t>(seg) * (n_docs + 1);
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
        out.flush(s, t, g, seg, d);
        for (int q = tid; q < t.qb; q += blockDim.x) {
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
  // the document the stream ended inside; later (empty) slots hold nothing
  out.flush(s, t, g, seg, d);
  for (int dd = d + 1; dd < n_docs; ++dd) out.clear(t, g, seg, dd);
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

template <class Out>
int launch_events(const void* events, int n_docs, int n_events,
                  const Tables& t, const Out& out, void* stream) {
  const int threads = threads_for(t.wb);
  const size_t smem =
      smem_bytes(t.n_tags, t.wb, t.qb, t.max_depth, threads, Out::kSparse);
  cudaError_t err = cudaFuncSetAttribute(
      events_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  events_kernel<Out><<<dim3(t.n_blocks, n_docs), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(events), n_events, t, out);
  return static_cast<int>(cudaGetLastError());
}

template <class Out>
int launch_bytes(const void* data, int n_segments, int length,
                 const void* starts, int n_docs, const Tables& t,
                 const Out& out, void* stream) {
  const int threads = threads_for(t.wb);
  const size_t smem =
      smem_bytes(t.n_tags, t.wb, t.qb, t.max_depth, threads, Out::kSparse);
  cudaError_t err = cudaFuncSetAttribute(
      bytes_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bytes_kernel<Out><<<dim3(t.n_blocks, n_segments), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), length,
      static_cast<const int32_t*>(starts), n_docs, t, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes of one launch (sparse != 0: K3/K4).
long long sf_smem_bytes(int n_tags, int wb, int qb, int max_depth,
                        int sparse) {
  return static_cast<long long>(smem_bytes(n_tags, wb, qb, max_depth,
                                           threads_for(wb), sparse != 0));
}

int sf_events(const void* events, int n_docs, int n_events,
              const void* tagmask, const void* pw, const void* pb,
              const void* selfloop, const void* init, const void* acc_word,
              const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
              int max_depth, void* matched, void* first, void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const DenseOut out{static_cast<int32_t*>(matched),
                     static_cast<int32_t*>(first), 1};
  return launch_events(events, n_docs, n_events, t, out, stream);
}

int sf_events_sparse(const void* events, int n_docs, int n_events,
                     const void* doc_ids, const void* tagmask, const void* pw,
                     const void* pb, const void* selfloop, const void* init,
                     const void* acc_word, const void* acc_bit, int n_blocks,
                     int n_tags, int wb, int qb, int max_depth,
                     const void* lane_cls, int cap, void* buf, void* count,
                     void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const SparseOut out{static_cast<const int32_t*>(doc_ids),
                      static_cast<const int32_t*>(lane_cls),
                      static_cast<int32_t*>(buf), static_cast<int32_t*>(count),
                      1, cap};
  return launch_events(events, n_docs, n_events, t, out, stream);
}

int sf_bytes(const void* data, int n_segments, int length, const void* starts,
             int n_docs, const void* tagmask, const void* pw, const void* pb,
             const void* selfloop, const void* init, const void* acc_word,
             const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
             int max_depth, void* matched, void* first, void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const DenseOut out{static_cast<int32_t*>(matched),
                     static_cast<int32_t*>(first), n_docs};
  return launch_bytes(data, n_segments, length, starts, n_docs, t, out,
                      stream);
}

int sf_bytes_sparse(const void* data, int n_segments, int length,
                    const void* starts, int n_docs, const void* doc_map,
                    const void* tagmask, const void* pw, const void* pb,
                    const void* selfloop, const void* init,
                    const void* acc_word, const void* acc_bit, int n_blocks,
                    int n_tags, int wb, int qb, int max_depth,
                    const void* lane_cls, int cap, void* buf, void* count,
                    void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const SparseOut out{static_cast<const int32_t*>(doc_map),
                      static_cast<const int32_t*>(lane_cls),
                      static_cast<int32_t*>(buf), static_cast<int32_t*>(count),
                      n_docs, cap};
  return launch_bytes(data, n_segments, length, starts, n_docs, t, out,
                      stream);
}

}  // extern "C"
