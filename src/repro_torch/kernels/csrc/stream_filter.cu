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
// Both loops drive the same per-event step (Chain).
//
// What bounds them on this card: the events of one (document, block) pair
// form a sequential chain -- each OPEN reads the stack row the previous
// events left -- so a pair cannot be split across threads in time, only
// across its WB words.  The bytes are read once per state block (G times
// per segment), which is little next to the chain.  Neither the bytes nor
// the integer operations bound the kernels; the chain's latency does: the
// time of one event's dependent shared-memory loads and synchronisation,
// times the events of the longest chain.
//
// What the design does about it:
// * One warp runs a chain.  Lane l owns the words l, l + 32, ... of the
//   block (NW = WB/32 rounded up to a power of two, a template parameter;
//   two words at the port's WB = 64), keeps their self-loop and pending
//   accept bits in registers, and every per-event barrier is a __syncwarp.
// * The per-event work is spread evenly over the lanes.  A short kernel
//   (build_entries) first turns each block's tag masks and parent tables
//   into gather entries, one per state a tag can switch on: (parent word,
//   parent bit, word, bit) in one int.  The states every tag matches (the
//   wildcards, most of the work) form one list; every tag's other states a
//   list of their own.  An OPEN walks the wildcard list and its tag's list
//   32 entries a round, one per lane: each lane reads its entry's parent
//   bit from the top-of-stack row and ORs it into the pushed row with a
//   shared-memory atomicOr.  Lists are ordered so a round's entries fall on
//   different words; the first 10 rounds of the wildcard list stay in
//   registers, decoded, and every stack read of a step's rounds is issued
//   before its first atomicOr, with no branch between.  A round costs the
//   same whatever word its entries come from, so the step takes (wildcard
//   + tag states) / 32 rounds, not the busiest word's bit count.
// * Accept lanes are scanned only when an accept state turns on for the
//   first time in the document (the `pending` words): every lane of a
//   state matches at the state's first activation, so a lane matches iff
//   its state is among the words' newly activated bits.
// * K1/K4 read 32 events with one coalesced load, the next 32 in flight,
//   and hand them to the chain by __shfl_sync.
// * K2/K3 take the byte front end off the chain: a second warp (the
//   producer) classifies the segment 256 positions at a time (eight a
//   lane, three bytes of look-ahead, the next window's bytes in flight),
//   finds each event's document slot from the starts, compacts the events
//   in byte order and writes them as one word each -- slot << 13 |
//   kind << 12 | tag -- into a ring of 7 windows in shared memory.  The
//   two warps hand over once per window with named barriers (bar.arrive /
//   bar.sync, one per ring slot for "full" and one for "empty"), never per
//   event.  An event whose slot is past the chain's document first flushes
//   that document (and any empty one between), re-roots the stack and
//   restarts the ordinal, exactly where the original per-position boundary
//   test did; that switch is a call out of line, so the event loop stays
//   one small body in the instruction cache.
//
// The TPU epilogue ranks hits with a matmul cumsum and masked sums and
// relies on its grid running in order, so one running counter is an
// exclusive scan.  Here thread blocks run in parallel: each emission ranks
// its hits with warp ballots, reserves its rows with one atomicAdd on a
// device counter, and writes the rows below `cap`.  The counter keeps the
// true total, so count > cap still signals overflow; row order varies from
// run to run.
//
// Packed words are uint32_t here and torch.int32 bit views outside.  The C
// entry points take device pointers and a CUDA stream and return the
// cudaError_t of the launch (0 = launched).

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kOpen = 0;
constexpr int kClose = 1;
constexpr int32_t kNoMatch = 0x7fffffff;
constexpr int kLt = 60;     // '<'
constexpr int kSlash = 47;  // '/'
constexpr unsigned kFull = 0xffffffffu;

// the byte kernels' event ring: windows of byte positions, one ring slot
// each, at most one event per position
constexpr int kWindow = 256;          // positions per window
constexpr int kPerLane = kWindow / 32;  // consecutive positions a lane
constexpr int kRingSlots = 7;         // windows the producer may run ahead
constexpr int kFullBar = 1;           // named barriers kFullBar + slot and
constexpr int kEmptyBar = kFullBar + kRingSlots;  // kEmptyBar + slot
constexpr int kSlotShift = 13;        // slot << 13 | kind << 12 | tag
constexpr int kMaxSlots = 1 << (32 - kSlotShift);
// gather entry: parent word | parent bit << 10 | word << 15 | bit << 25
constexpr int kHeld = 10;             // wildcard rounds kept in registers
constexpr int kPrepThreads = 256;

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
  uint32_t* ent;      // 32 * WB gather entries (see build_entries)
  int32_t* toff;      // T+2: tag t's entries are [toff[t], toff[t+1]); the
                      // entries [0, toff[0]) match every tag
  uint32_t* stack;    // (max_depth + 2) * WB
  uint32_t* acc;      // WB + 32: the row being pushed, assembled by the
                      // lanes; then one word per lane that takes the ORs
                      // of rounds where the lane has no entry
  uint32_t* accmask;  // WB: OR of every accept lane's bit, per word
  uint32_t* newly;    // WB: accept bits that just turned on, per word
  int32_t* accloc;    // QB: accept lane -> local state (word * 32 + bit)
  int32_t* matched;   // QB
  int32_t* first;     // QB
  int32_t* lanecls;   // QB: accept class of each lane, -1 inert (K3, K4)
  int32_t* ring;      // kRingSlots * kWindow event words (K2, K3)
  int32_t* ring_n;    // kRingSlots: events in each slot (K2, K3)
};

__host__ __device__ inline size_t smem_bytes(int n_tags, int wb, int qb,
                                             int max_depth, bool sparse,
                                             bool ring) {
  return 4 * (32 * static_cast<size_t>(wb) + n_tags + 2 +
              static_cast<size_t>(max_depth + 2) * wb + 3 * wb + 32 +
              (sparse ? 4 : 3) * static_cast<size_t>(qb) +
              (ring ? kRingSlots * (kWindow + 1) : 0));
}

__device__ inline Smem carve(unsigned char* base, const Tables& t,
                             bool sparse, bool ring) {
  Smem s;
  uint32_t* p = reinterpret_cast<uint32_t*>(base);
  s.ent = p;                                       p += 32 * t.wb;
  s.toff = reinterpret_cast<int32_t*>(p);          p += t.n_tags + 2;
  s.stack = p;                                     p += (t.max_depth + 2) * t.wb;
  s.acc = p;                                       p += t.wb + 32;
  s.accmask = p;                                   p += t.wb;
  s.newly = p;                                     p += t.wb;
  s.accloc = reinterpret_cast<int32_t*>(p);        p += t.qb;
  s.matched = reinterpret_cast<int32_t*>(p);       p += t.qb;
  s.first = reinterpret_cast<int32_t*>(p);         p += t.qb;
  s.lanecls = nullptr;
  if (sparse) {
    s.lanecls = reinterpret_cast<int32_t*>(p);     p += t.qb;
  }
  s.ring = s.ring_n = nullptr;
  if (ring) {
    s.ring = reinterpret_cast<int32_t*>(p);        p += kRingSlots * kWindow;
    s.ring_n = reinterpret_cast<int32_t*>(p);
  }
  return s;
}

// ------------------------------------------------------ gather entries
// Block g's gather entries, written to `ent` (G, 32 * WB) and `toff`
// (G, T+2) by one thread block of kPrepThreads per state block.  `always`
// is the AND of every tag row of the masks (the states every tag
// matches); tag t's own states are its row without them.  A plan puts
// every state in all rows (a wildcard) or in at most one (checked when it
// is built, check_block_tables), so the entries fit 32 * WB; writes and
// list bounds stop there whatever the tables, so no read leaves the list.

// One warp: the entries of the masks buf[0..wb) from `pos` on, in rounds
// of "the k-th set bit of every word", so 32 consecutive entries mostly
// fall on different words.
__device__ void emit_entries(const uint32_t* buf, int wb, int pos, int cap,
                             const int32_t* pw, const int32_t* pb,
                             uint32_t* ent) {
  const int lane = threadIdx.x & 31;
  int most = 0;
  for (int w = lane; w < wb; w += 32) most = max(most, __popc(buf[w]));
  most = __reduce_max_sync(kFull, most);
  for (int k = 0; k < most; ++k)
    for (int w0 = 0; w0 < wb; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t x = w < wb ? buf[w] : 0u;
      const bool has = __popc(x) > k;
      const unsigned bal = __ballot_sync(kFull, has);
      if (has) {
        uint32_t y = x;
        for (int kk = 0; kk < k; ++kk) y &= y - 1u;
        const int j = __ffs(y) - 1;
        const int e = pos + __popc(bal & ((1u << lane) - 1u));
        if (e < cap)
          ent[e] = static_cast<uint32_t>(pw[w * 32 + j]) |
                   static_cast<uint32_t>(pb[w * 32 + j]) << 10 |
                   static_cast<uint32_t>(w) << 15 |
                   static_cast<uint32_t>(j) << 25;
      }
      pos += __popc(bal);
    }
}

__global__ void __launch_bounds__(kPrepThreads)
build_entries(Tables t, uint32_t* ent_all, int32_t* toff_all) {
  extern __shared__ __align__(16) uint32_t prep[];
  const int g = blockIdx.x, tid = threadIdx.x, wb = t.wb, rows = t.n_tags + 1;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kPrepThreads / 32;
  uint32_t* always = prep;                                   // wb
  int32_t* start = reinterpret_cast<int32_t*>(prep + wb);    // rows
  uint32_t* bufs = prep + wb + rows;                         // nwarps * wb
  const uint32_t* tm = t.tagmask + static_cast<size_t>(g) * rows * wb;
  const int32_t* pw = t.pw + static_cast<size_t>(g) * wb * 32;
  const int32_t* pb = t.pb + static_cast<size_t>(g) * wb * 32;
  uint32_t* ent = ent_all + static_cast<size_t>(g) * 32 * wb;
  int32_t* toff = toff_all + static_cast<size_t>(g) * (rows + 1);
  for (int w = tid; w < wb; w += kPrepThreads) {
    uint32_t a = ~0u;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) a &= tm[static_cast<size_t>(r) * wb + w];
    always[w] = a;
  }
  __syncthreads();
  for (int r = warp; r < rows; r += nwarps) {
    int c = 0;
    for (int w = lane; w < wb; w += 32)
      c += __popc(tm[static_cast<size_t>(r) * wb + w] & ~always[w]);
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) start[r] = c;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts, after the wildcards
    int n = 0;
    for (int w = lane; w < wb; w += 32) n += __popc(always[w]);
    int carry = __reduce_add_sync(kFull, n);
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const int c = r < rows ? start[r] : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (r < rows) start[r] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) toff[rows] = min(carry, 32 * wb);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kPrepThreads)
    toff[r] = min(start[r], 32 * wb);
  if (warp == 0) emit_entries(always, wb, 0, 32 * wb, pw, pb, ent);
  uint32_t* buf = bufs + warp * wb;
  for (int r = warp; r < rows; r += nwarps) {
    for (int w = lane; w < wb; w += 32)
      buf[w] = tm[static_cast<size_t>(r) * wb + w] & ~always[w];
    __syncwarp();
    emit_entries(buf, wb, start[r], 32 * wb, pw, pb, ent);
    __syncwarp();
  }
}

size_t prep_smem_bytes(int n_tags, int wb) {
  return 4 * (static_cast<size_t>(wb) * (1 + kPrepThreads / 32) + n_tags + 1);
}

// Load block g's entries and tables into shared memory, root the stack,
// clear the lanes; `lane_cls` (G, QB), when given, names the accept
// classes.  Every thread of the block calls it.
__device__ void load_block(const Smem& s, const Tables& t, int g,
                           const uint32_t* ent, const int32_t* toff,
                           const int32_t* lane_cls) {
  const int tid = threadIdx.x, nt = blockDim.x, wb = t.wb;
  const uint32_t* e = ent + static_cast<size_t>(g) * 32 * wb;
  for (int i = tid; i < 32 * wb; i += nt) s.ent[i] = e[i];
  const int32_t* o = toff + static_cast<size_t>(g) * (t.n_tags + 2);
  for (int i = tid; i < t.n_tags + 2; i += nt) s.toff[i] = o[i];
  for (int w = tid; w < wb; w += nt) {
    s.stack[w] = t.init[static_cast<size_t>(g) * wb + w];
    s.accmask[w] = 0u;
    s.newly[w] = 0u;
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

// Gather entry x, or none (x past the list) for lane `lane`: the word of
// `acc` its bit goes to (the lane's own spare word when none) and that
// bit, then the parent's bit in `row` -- no branches, so a round's stack
// reads and atomics issue back to back.
__device__ __forceinline__ int put_word(uint32_t x, bool some, int wb,
                                        int lane) {
  return some ? static_cast<int>((x >> 15) & 0x3ffu) : wb + lane;
}

__device__ __forceinline__ uint32_t put_value(uint32_t x, bool some) {
  return some ? 1u << (x >> 25) : 0u;
}

__device__ __forceinline__ uint32_t parent_bit(uint32_t x,
                                               const uint32_t* row) {
  return (row[x & 0x3ffu] >> ((x >> 10) & 31u)) & 1u;
}

// Entries [e0, e1) of a list, 32 a round, one per lane; four rounds at a
// time, their stack reads all issued before any atomicOr.
__device__ __forceinline__ void gather_list(const uint32_t* ent, int e0,
                                            int e1, const uint32_t* row,
                                            uint32_t* acc, int wb, int lane) {
  for (int e = e0 + lane; e < e1; e += 4 * 32) {
    uint32_t x[4], bit[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = e + 32 * k < e1 ? ent[e + 32 * k] : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) bit[k] = parent_bit(x[k], row);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool some = e + 32 * k < e1;
      atomicOr(acc + put_word(x[k], some, wb, lane),
               put_value(x[k], some) & (0u - bit[k]));
    }
  }
}

// ------------------------------------------------------------- the chain
// One (document or segment, state block) chain, run by one warp.  Lane l
// owns the words w = l + 32 * i, i < NW, of the block (those below WB).
template <int NW>
struct Chain {
  uint32_t selfw[NW], pending[NW];
  // this lane's first wildcard entries, decoded: parent word, parent bit,
  // word of `acc` and the value ORed into it (a spare word and 0 past the
  // list)
  int hpw[kHeld], hpb[kHeld], hword[kHeld];
  uint32_t hval[kHeld];
  int lane, depth, n_always;

  __device__ bool owns(int i, int wb) const { return lane + 32 * i < wb; }

  __device__ void init(const Smem& s, const Tables& t, int g) {
    lane = threadIdx.x & 31;
    depth = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int w = lane + 32 * i;
      selfw[i] = owns(i, t.wb) ? t.selfloop[static_cast<size_t>(g) * t.wb + w]
                               : 0u;
      pending[i] = owns(i, t.wb) ? s.accmask[w] : 0u;
    }
    n_always = s.toff[0];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int e = lane + 32 * k;
      const bool some = e < n_always;
      const uint32_t x = some ? s.ent[e] : 0u;
      hpw[k] = static_cast<int>(x & 0x3ffu);
      hpb[k] = static_cast<int>((x >> 10) & 31u);
      hword[k] = put_word(x, some, t.wb, lane);
      hval[k] = put_value(x, some);
    }
  }

  // A new document, once its lanes are clear and its root row is back:
  // every accept state pending again, the stack at the root.
  __device__ void restart(const Smem& s, const Tables& t) {
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (owns(i, t.wb)) pending[i] = s.accmask[lane + 32 * i];
    depth = 0;
  }

  __device__ void close() { depth = max(depth - 1, 0); }

  // One OPEN event with tag `tag` and ordinal `ord` (uniform over the
  // warp).  The pushed row is
  //   nxt = (parent bits of the tag's states) | (selfloop & row)
  // assembled in s.acc from the wildcard list and the tag's list, pushed
  // at clip(depth + 1); the accept lanes read from it.
  __device__ void open(const Smem& s, const Tables& t, int tag, int ord) {
    const int wb = t.wb;
    const int tclip = (tag >= 0 && tag < t.n_tags) ? tag : t.n_tags;
    const int lo = s.toff[tclip], hi = s.toff[tclip + 1];
    const uint32_t* row = s.stack + depth * wb;
    // the tag's first round, read with the wildcards' rounds
    const uint32_t xt = lo + lane < hi ? s.ent[lo + lane] : 0u;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (owns(i, wb)) s.acc[lane + 32 * i] = selfw[i] & row[lane + 32 * i];
    __syncwarp();
    uint32_t bit[kHeld];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) bit[k] = (row[hpw[k]] >> hpb[k]) & 1u;
    const uint32_t bt = parent_bit(xt, row);
#pragma unroll
    for (int k = 0; k < kHeld; ++k)
      atomicOr(s.acc + hword[k], hval[k] & (0u - bit[k]));
    const bool some = lo + lane < hi;
    atomicOr(s.acc + put_word(xt, some, wb, lane),
             put_value(xt, some) & (0u - bt));
    gather_list(s.ent, 32 * kHeld, n_always, row, s.acc, wb, lane);
    gather_list(s.ent, lo + 32, hi, row, s.acc, wb, lane);
    __syncwarp();  // the row is assembled; every read of `row` is done
    const int widx = min(depth + 1, t.max_depth + 1);
    uint32_t newly = 0u;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (!owns(i, wb)) continue;
      const uint32_t nxt = s.acc[lane + 32 * i];
      const uint32_t fresh = nxt & pending[i];
      s.stack[widx * wb + lane + 32 * i] = nxt;
      if (fresh) s.newly[lane + 32 * i] = fresh;
      pending[i] &= ~nxt;
      newly |= fresh;
    }
    depth = widx;
    const bool any = __any_sync(kFull, newly != 0u);
    __syncwarp();  // the pushed row (and `newly`) are visible to every lane
    if (any) {
      // a lane matches iff its state just turned on; lane q is read and
      // written only by lane q % 32
      for (int q = lane; q < t.qb; q += 32) {
        const int loc = s.accloc[q];
        if ((s.newly[loc >> 5] >> (loc & 31)) & 1u) {
          s.matched[q] = 1;
          s.first[q] = ord;
        }
      }
      __syncwarp();  // every read of `newly` is done
#pragma unroll
      for (int i = 0; i < NW; ++i)
        if (owns(i, wb)) s.newly[lane + 32 * i] = 0u;
      __syncwarp();
    }
  }
};

// ------------------------------------------------------------- outputs
// What a finished document does with its lanes.  `row` is the document
// (events) or segment (bytes) of the thread block, `slot` the document
// slot within it (always 0 for events).  The chain's warp calls flush();
// lane q % 32 is the only reader and writer of lane q.

// K1/K2: the lanes of every (row, block, slot) out as (rows, G, slots, QB).
struct DenseOut {
  int32_t* matched;
  int32_t* first;
  int n_slots;
  static constexpr bool kSparse = false;

  __device__ const int32_t* lane_cls() const { return nullptr; }

  __device__ size_t at(const Tables& t, int g, int row, int slot) const {
    return ((static_cast<size_t>(row) * t.n_blocks + g) * n_slots + slot) *
           t.qb;
  }

  __device__ void flush(const Smem& s, const Tables& t, int g, int row,
                        int slot) const {
    const size_t out = at(t, g, row, slot);
    for (int q = threadIdx.x & 31; q < t.qb; q += 32) {
      matched[out + q] = s.matched[q];
      first[out + q] = s.first[q];
    }
  }

  // a slot the stream never reached: no lanes
  __device__ void clear(const Tables& t, int g, int row, int slot) const {
    const size_t out = at(t, g, row, slot);
    for (int q = threadIdx.x & 31; q < t.qb; q += 32) {
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
  // doc >= 0.  The warp sums them and reserves their rows with one
  // atomicAdd, then ranks them in lane order 32 lanes at a time (ballot)
  // and writes the rows below `cap`.
  __device__ void emit(const Smem& s, const Tables& t, int doc) const {
    if (doc < 0) return;  // uniform over the warp
    const int lane = threadIdx.x & 31;
    int mine = 0;
    for (int q = lane; q < t.qb; q += 32)
      mine += (s.matched[q] != 0 && s.lanecls[q] >= 0) ? 1 : 0;
    const int total = __reduce_add_sync(kFull, mine);
    if (total == 0) return;
    int next = 0;
    if (lane == 0) next = atomicAdd(count, total);
    next = __shfl_sync(kFull, next, 0);
    for (int q0 = 0; q0 < t.qb; q0 += 32) {
      const int q = q0 + lane;
      const bool hit = q < t.qb && s.matched[q] != 0 && s.lanecls[q] >= 0;
      const unsigned mask = __ballot_sync(kFull, hit);
      const int off = __popc(mask & ((1u << lane) - 1u));
      if (hit && next + off < cap) {
        int32_t* r = buf + 3 * static_cast<size_t>(next + off);
        r[0] = doc;
        r[1] = s.lanecls[q];
        r[2] = s.first[q];
      }
      next += __popc(mask);
    }
  }
};

// ------------------------------------------------------------- kernels
// K1/K4: one warp per (document b, state block g) over fused event words
// (kind << 16) | (tag & 0xffff).
template <class Out, int NW>
__global__ void __launch_bounds__(32)
events_kernel(const int32_t* __restrict__ events, int n_events, Tables t,
              const uint32_t* __restrict__ ent,
              const int32_t* __restrict__ toff, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const Smem s = carve(smem, t, Out::kSparse, false);
  load_block(s, t, g, ent, toff, out.lane_cls());
  Chain<NW> c;
  c.init(s, t, g);
  const int32_t* evrow = events + static_cast<size_t>(b) * n_events;
  int cur = lane < n_events ? __ldg(evrow + lane) : 0;
  for (int base = 0; base < n_events; base += 32) {
    const int n = min(32, n_events - base);
    const int ahead = base + 32 + lane;       // the next 32, in flight
    const int next = ahead < n_events ? __ldg(evrow + ahead) : 0;
    int ev = __shfl_sync(kFull, cur, 0);
    for (int j = 0; j < n; ++j) {
      const int following = __shfl_sync(kFull, cur, (j + 1) & 31);
      const int kind = ev >> 16;
      if (kind == kOpen)
        c.open(s, t, ev & 0xffff, base + j);
      else if (kind == kClose)
        c.close();
      ev = following;
    }
    cur = next;
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

// named barriers between the producer and the chain warp (64 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// The chain's document ends where document `slot` starts: flush it and
// any empty one between, clear the lanes and re-root the stack in shared
// memory (the chain then resets its registers).  Rare, so kept out of the
// event loop's code; arguments by value, so nothing of the caller's has
// to leave registers.
template <class Out>
__device__ __noinline__ void next_document(Smem s, Tables t, Out out, int g,
                                           int seg, int d, int slot) {
  const int lane = threadIdx.x & 31;
  for (; d < slot; ++d) {
    out.flush(s, t, g, seg, d);
    for (int q = lane; q < t.qb; q += 32) {
      s.matched[q] = 0;
      s.first[q] = kNoMatch;
    }
  }
  for (int w = lane; w < t.wb; w += 32)
    s.stack[w] = t.init[static_cast<size_t>(g) * t.wb + w];
  __syncwarp();
}

// K2/K3 producer warp: classify the segment row window by window, compact
// the events in byte order into the ring (slot << 13 | kind << 12 | tag),
// hand each window over.  Document slot d ends where slot d + 1 starts; the
// last slot never ends early.
__device__ void produce(const Smem& s, const uint8_t* __restrict__ row,
                        int length, const int32_t* __restrict__ st,
                        int n_docs, int n_windows) {
  const int lane = threadIdx.x & 31;
  int d = 0;
  int bound = n_docs > 1 ? __ldg(st + 1) : INT32_MAX;
  // this window's bytes, three past the lane's positions, and the next
  // window's, in flight
  int b[kPerLane + 3], ahead[kPerLane + 3];
#pragma unroll
  for (int x = 0; x < kPerLane + 3; ++x)
    b[x] = lane * kPerLane + x < length ? __ldg(row + lane * kPerLane + x) : 0;
  for (int k = 0; k < n_windows; ++k) {
    const int slot = k % kRingSlots;
    const int p0 = k * kWindow + lane * kPerLane;
#pragma unroll
    for (int x = 0; x < kPerLane + 3; ++x)
      ahead[x] = p0 + kWindow + x < length ? __ldg(row + p0 + kWindow + x)
                                           : 0;
    if (k >= kRingSlots) bar_sync(kEmptyBar + slot);  // the chain freed it
    int word[kPerLane], n = 0;
    bool keep[kPerLane];
#pragma unroll
    for (int x = 0; x < kPerLane; ++x) {
      const int p = p0 + x;
      const bool is_lt = b[x] == kLt;
      const bool is_close = is_lt && b[x + 1] == kSlash;
      const bool is_open = is_lt && !is_close;
      const int v0 = symbol_value(is_close ? b[x + 2] : b[x + 1]);
      const int v1 = symbol_value(is_close ? b[x + 3] : b[x + 2]);
      const bool ok = v0 >= 0 && v1 >= 0;
      keep[x] = p < length && (is_open || is_close) && ok;
      if (p < length)
        while (p >= bound) {  // crossed one or more document starts
          ++d;
          bound = d + 1 < n_docs ? __ldg(st + d + 1) : INT32_MAX;
        }
      word[x] = (d << kSlotShift) | ((is_close ? kClose : kOpen) << 12) |
                ((v0 * 64 + v1) & 0xfff);
      n += keep[x] ? 1 : 0;
    }
    int incl = n;  // inclusive scan of the lanes' counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int32_t* dst = s.ring + slot * kWindow + (incl - n);
#pragma unroll
    for (int x = 0; x < kPerLane; ++x)
      if (keep[x]) *dst++ = word[x];
    d = __shfl_sync(kFull, d, 31);      // the last position's slot
    bound = __shfl_sync(kFull, bound, 31);
    if (lane == 0) s.ring_n[slot] = total;
    bar_arrive(kFullBar + slot);
#pragma unroll
    for (int x = 0; x < kPerLane + 3; ++x) b[x] = ahead[x];
  }
}

// K2/K3: one thread block of two warps per (segment, state block g) over
// raw bytes (S, L) with document starts (S, D+1): warp 1 produces the
// events, warp 0 runs the chain.
template <class Out, int NW>
__global__ void __launch_bounds__(64)
bytes_kernel(const uint8_t* __restrict__ data, int length,
             const int32_t* __restrict__ starts, int n_docs, Tables t,
             const uint32_t* __restrict__ ent,
             const int32_t* __restrict__ toff, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, seg = blockIdx.y, lane = threadIdx.x & 31;
  const Smem s = carve(smem, t, Out::kSparse, true);
  load_block(s, t, g, ent, toff, out.lane_cls());
  const int n_windows = (length + kWindow - 1) / kWindow;
  if (threadIdx.x >= 32) {
    produce(s, data + static_cast<size_t>(seg) * length, length,
            starts + static_cast<size_t>(seg) * (n_docs + 1), n_docs,
            n_windows);
    return;
  }
  Chain<NW> c;
  c.init(s, t, g);
  int d = 0, ord = 0;
  for (int k = 0; k < n_windows; ++k) {
    const int ring_slot = k % kRingSlots;
    bar_sync(kFullBar + ring_slot);
    const int n = s.ring_n[ring_slot];
    const int32_t* evs = s.ring + ring_slot * kWindow;
#pragma unroll 1
    for (int base = 0; base < n; base += 32) {  // one copy of the loop body
      const int cur = base + lane < n ? evs[base + lane] : 0;
      const int m = min(32, n - base);
      int ev = __shfl_sync(kFull, cur, 0);
      for (int j = 0; j < m; ++j) {
        const int following = __shfl_sync(kFull, cur, (j + 1) & 31);
        const int slot =
            static_cast<int>(static_cast<unsigned>(ev) >> kSlotShift);
        if (d < slot) {  // crossed one or more document boundaries
          next_document(s, t, out, g, seg, d, slot);
          c.restart(s, t);
          d = slot;
          ord = 0;
        }
        if ((ev >> 12) & 1)
          c.close();
        else
          c.open(s, t, ev & 0xfff, ord);
        ++ord;
        ev = following;
      }
    }
    __syncwarp();  // every lane has read the slot
    if (k + kRingSlots < n_windows) bar_arrive(kEmptyBar + ring_slot);
  }
  // the document the stream ended inside; later (empty) slots hold nothing
  out.flush(s, t, g, seg, d);
  for (int dd = d + 1; dd < n_docs; ++dd) out.clear(t, g, seg, dd);
}

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

template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The gather entries of every block, in `scratch`: ent (G, 32 * WB), then
// toff (G, T+2).
struct Entries {
  const uint32_t* ent;
  const int32_t* toff;
};

size_t scratch_words(int n_blocks, int n_tags, int wb) {
  return static_cast<size_t>(n_blocks) * (32 * static_cast<size_t>(wb) +
                                          n_tags + 2);
}

int prepare(const Tables& t, void* scratch, void* stream, Entries* e) {
  uint32_t* ent = static_cast<uint32_t*>(scratch);
  int32_t* toff = reinterpret_cast<int32_t*>(
      ent + static_cast<size_t>(t.n_blocks) * 32 * t.wb);
  *e = Entries{ent, toff};
  return launch(build_entries, dim3(t.n_blocks), kPrepThreads,
                prep_smem_bytes(t.n_tags, t.wb), stream, t, ent, toff);
}

template <class Out, int NW>
int launch_events_nw(const void* events, int n_docs, int n_events,
                     const Tables& t, const Entries& e, const Out& out,
                     void* stream) {
  const size_t smem =
      smem_bytes(t.n_tags, t.wb, t.qb, t.max_depth, Out::kSparse, false);
  return launch(events_kernel<Out, NW>, dim3(t.n_blocks, n_docs), 32, smem,
                stream, static_cast<const int32_t*>(events), n_events, t,
                e.ent, e.toff, out);
}

template <class Out, int NW>
int launch_bytes_nw(const void* data, int n_segments, int length,
                    const void* starts, int n_docs, const Tables& t,
                    const Entries& e, const Out& out, void* stream) {
  const size_t smem =
      smem_bytes(t.n_tags, t.wb, t.qb, t.max_depth, Out::kSparse, true);
  return launch(bytes_kernel<Out, NW>, dim3(t.n_blocks, n_segments), 64,
                smem, stream, static_cast<const uint8_t*>(data), length,
                static_cast<const int32_t*>(starts), n_docs, t, e.ent,
                e.toff, out);
}

// Calls f(std::integral_constant<int, NW>) with NW = WB / 32 rounded up to
// a power of two, the chain's words per lane.
template <int NW = 1, class F>
int with_words_per_lane(int wb, F&& f) {
  if (32 * NW >= wb) return f(std::integral_constant<int, NW>{});
  if constexpr (NW < 32) {
    return with_words_per_lane<2 * NW>(wb, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Out>
int launch_events(const void* events, int n_docs, int n_events,
                  const Tables& t, const Out& out, void* scratch,
                  void* stream) {
  Entries e;
  const int err = prepare(t, scratch, stream, &e);
  if (err != 0) return err;
  return with_words_per_lane(t.wb, [&](auto nw) {
    return launch_events_nw<Out, decltype(nw)::value>(
        events, n_docs, n_events, t, e, out, stream);
  });
}

template <class Out>
int launch_bytes(const void* data, int n_segments, int length,
                 const void* starts, int n_docs, const Tables& t,
                 const Out& out, void* scratch, void* stream) {
  if (n_docs >= kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  Entries e;
  const int err = prepare(t, scratch, stream, &e);
  if (err != 0) return err;
  return with_words_per_lane(t.wb, [&](auto nw) {
    return launch_bytes_nw<Out, decltype(nw)::value>(
        data, n_segments, length, starts, n_docs, t, e, out, stream);
  });
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes of one launch (sparse != 0: K3/K4;
// bytes != 0: K2/K3, which hold the event ring).
long long sf_smem_bytes(int n_tags, int wb, int qb, int max_depth,
                        int sparse, int bytes) {
  return static_cast<long long>(
      smem_bytes(n_tags, wb, qb, max_depth, sparse != 0, bytes != 0));
}

// The most document slots a segment may hold in one byte launch.
int sf_max_slots() { return kMaxSlots - 1; }

// int32 words of the scratch buffer every launch takes (its gather
// entries).
long long sf_scratch_words(int n_blocks, int n_tags, int wb) {
  return static_cast<long long>(scratch_words(n_blocks, n_tags, wb));
}

int sf_events(const void* events, int n_docs, int n_events,
              const void* tagmask, const void* pw, const void* pb,
              const void* selfloop, const void* init, const void* acc_word,
              const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
              int max_depth, void* matched, void* first, void* scratch,
              void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const DenseOut out{static_cast<int32_t*>(matched),
                     static_cast<int32_t*>(first), 1};
  return launch_events(events, n_docs, n_events, t, out, scratch, stream);
}

int sf_events_sparse(const void* events, int n_docs, int n_events,
                     const void* doc_ids, const void* tagmask, const void* pw,
                     const void* pb, const void* selfloop, const void* init,
                     const void* acc_word, const void* acc_bit, int n_blocks,
                     int n_tags, int wb, int qb, int max_depth,
                     const void* lane_cls, int cap, void* buf, void* count,
                     void* scratch, void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const SparseOut out{static_cast<const int32_t*>(doc_ids),
                      static_cast<const int32_t*>(lane_cls),
                      static_cast<int32_t*>(buf), static_cast<int32_t*>(count),
                      1, cap};
  return launch_events(events, n_docs, n_events, t, out, scratch, stream);
}

int sf_bytes(const void* data, int n_segments, int length, const void* starts,
             int n_docs, const void* tagmask, const void* pw, const void* pb,
             const void* selfloop, const void* init, const void* acc_word,
             const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
             int max_depth, void* matched, void* first, void* scratch,
             void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const DenseOut out{static_cast<int32_t*>(matched),
                     static_cast<int32_t*>(first), n_docs};
  return launch_bytes(data, n_segments, length, starts, n_docs, t, out,
                      scratch, stream);
}

int sf_bytes_sparse(const void* data, int n_segments, int length,
                    const void* starts, int n_docs, const void* doc_map,
                    const void* tagmask, const void* pw, const void* pb,
                    const void* selfloop, const void* init,
                    const void* acc_word, const void* acc_bit, int n_blocks,
                    int n_tags, int wb, int qb, int max_depth,
                    const void* lane_cls, int cap, void* buf, void* count,
                    void* scratch, void* stream) {
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const SparseOut out{static_cast<const int32_t*>(doc_map),
                      static_cast<const int32_t*>(lane_cls),
                      static_cast<int32_t*>(buf), static_cast<int32_t*>(count),
                      n_docs, cap};
  return launch_bytes(data, n_segments, length, starts, n_docs, t, out,
                      scratch, stream);
}

}  // extern "C"
