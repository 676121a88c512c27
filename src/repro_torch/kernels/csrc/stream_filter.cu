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
// events left.  The bytes are read once per state block (G times per
// segment), which is little next to the chain.  Neither the bytes nor the
// integer operations bound the kernels; the chain's latency does: the time
// of one event's dependent shared-memory loads and synchronisation, times
// the events of the longest chain.  A launch of G x S chains on few long
// documents (16 documents of 1 MB in 11 blocks: 176 chains, each ~60,000
// opens) leaves most of the card's resident blocks idle, so its time is
// one chain's.  An H100 holds 528 such blocks, 4 an SM: the plan's 47 KB
// of shared memory allows 4, and so does the pool of named barriers, of
// which a byte kernel holds all 16 ids (the ring's ids are in registers).
//
// What the design does about it:
// * K2 over one-document segments splits each chain into P pieces in time
//   when G x S chains would leave resident blocks idle (the wrapper picks P
//   from the launch's shape and the card's residency).  The row an OPEN
//   pushes depends only on the row under it and the tag, so the stack at
//   any position is the rows its open ancestors pushed, replayed from the
//   root.  A piece starts on a window edge, replays its ancestors' opens
//   (recording nothing), then runs its own bytes with the ordinal of its
//   first event; pieces merge their lanes with atomicOr (matched) and
//   atomicMin (first), which is exact in any order.  Two small kernels
//   plan the pieces on the device in the same call: piece_windows sums
//   each window's event walk (events, net depth, least and most prefix,
//   most rise: composable, so windows and lanes combine by scans), and
//   piece_plan scans them per segment to each piece's first ordinal and
//   depth, and finds each ancestor as the last OPEN reaching its level in
//   the last window that dips below it.  A segment whose depth ever passes
//   max_depth + 1 (the stack clips, and stops holding the ancestors' rows)
//   is run whole by its first piece.  Each event is still stepped once a
//   block; the replays add at most max_depth + 1 opens a piece.
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
constexpr int kPlanThreads = 1024;    // piece_plan: one block a segment

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
  // at clip(depth + 1); the accept lanes read from it.  A replayed
  // ancestor (kRecord false) pushes its row and records no lane: the
  // piece that holds the ancestor's own open records it.
  template <bool kRecord = true>
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
      const uint32_t fresh = kRecord ? nxt & pending[i] : 0u;
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
// `merge`: the row runs as pieces, each ORing its hits into `matched` and
// taking the least ordinal into `first`, cleared to 0 and kNoMatch first.
struct DenseOut {
  int32_t* matched;
  int32_t* first;
  int n_slots;
  bool merge;
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
      if (!merge) {
        matched[out + q] = s.matched[q];
        first[out + q] = s.first[q];
      } else if (s.matched[q] != 0) {
        atomicOr(matched + out + q, 1);
        atomicMin(first + out + q, s.first[q]);
      }
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

// One lane's bytes of a window: its kPerLane positions from `p` and three
// of look-ahead, zeros past the row's end.
__device__ __forceinline__ void load_lane(const uint8_t* __restrict__ row,
                                          int length, int p,
                                          int (&b)[kPerLane + 3]) {
#pragma unroll
  for (int x = 0; x < kPerLane + 3; ++x)
    b[x] = p + x < length ? __ldg(row + p + x) : 0;
}

// The event a position starts, from its byte and the three after it:
// kind << 12 | tag, or -1 for none.  The producer and the piece plan both
// classify with it, so they count the same events.
__device__ __forceinline__ int classify(int b0, int b1, int b2, int b3) {
  const bool is_lt = b0 == kLt;
  const bool is_close = is_lt && b1 == kSlash;
  const int v0 = symbol_value(is_close ? b2 : b1);
  const int v1 = symbol_value(is_close ? b3 : b2);
  return is_lt && v0 >= 0 && v1 >= 0
             ? ((is_close ? kClose : kOpen) << 12) | (v0 * 64 + v1)
             : -1;
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

// K2/K3 producer warp: classify the windows [k0, k1) of the segment row,
// compact the events in byte order into the ring (slot << 13 | kind << 12
// | tag), hand each window over.  Document slot d ends where slot d + 1
// starts; the last slot never ends early.
__device__ void produce(const Smem& s, const uint8_t* __restrict__ row,
                        int length, const int32_t* __restrict__ st,
                        int n_docs, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  int d = 0;
  int bound = n_docs > 1 ? __ldg(st + 1) : INT32_MAX;
  // this window's bytes, three past the lane's positions, and the next
  // window's, in flight
  int b[kPerLane + 3], ahead[kPerLane + 3];
  load_lane(row, length, k0 * kWindow + lane * kPerLane, b);
  for (int k = k0; k < k1; ++k) {
    const int slot = (k - k0) % kRingSlots;
    const int p0 = k * kWindow + lane * kPerLane;
    load_lane(row, length, p0 + kWindow, ahead);
    if (k - k0 >= kRingSlots) bar_sync(kEmptyBar + slot);  // the chain freed it
    int word[kPerLane], n = 0;
    bool keep[kPerLane];
#pragma unroll
    for (int x = 0; x < kPerLane; ++x) {
      const int p = p0 + x;
      const int ev = classify(b[x], b[x + 1], b[x + 2], b[x + 3]);
      keep[x] = p < length && ev >= 0;
      if (p < length)
        while (p >= bound) {  // crossed one or more document starts
          ++d;
          bound = d + 1 < n_docs ? __ldg(st + d + 1) : INT32_MAX;
        }
      word[x] = (d << kSlotShift) | (ev & 0x1fff);
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

// int32 words of one piece's entry in the plan: its windows [k0, k1), the
// ordinal of its first event, its depth at k0, then one ancestor tag a
// level, root first.
__host__ __device__ inline int piece_words(int max_depth) {
  return 4 + max_depth + 1;
}

// K2/K3: one thread block of two warps per (segment, state block g) over
// raw bytes (S, L) with document starts (S, D+1): warp 1 produces the
// events, warp 0 runs the chain.  With a piece plan (K2 over one-document
// segments, n_pieces > 1) block row y runs piece y % n_pieces of segment
// y / n_pieces: its ancestors' opens, then its own windows.
template <class Out, int NW>
__global__ void __launch_bounds__(64)
bytes_kernel(const uint8_t* __restrict__ data, int length,
             const int32_t* __restrict__ starts, int n_docs, Tables t,
             const uint32_t* __restrict__ ent,
             const int32_t* __restrict__ toff, Out out,
             const int32_t* __restrict__ plan, int n_pieces) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, seg = blockIdx.y / n_pieces;
  const int lane = threadIdx.x & 31;
  int k0 = 0, k1 = (length + kWindow - 1) / kWindow, ord = 0, n_anc = 0;
  const int32_t* anc = nullptr;
  if (plan != nullptr) {
    const int32_t* e =
        plan + static_cast<size_t>(blockIdx.y) * piece_words(t.max_depth);
    k0 = __ldg(e);
    k1 = __ldg(e + 1);
    ord = __ldg(e + 2);
    n_anc = __ldg(e + 3);
    anc = e + 4;
  }
  const Smem s = carve(smem, t, Out::kSparse, true);
  load_block(s, t, g, ent, toff, out.lane_cls());
  if (threadIdx.x >= 32) {
    produce(s, data + static_cast<size_t>(seg) * length, length,
            starts + static_cast<size_t>(seg) * (n_docs + 1), n_docs, k0,
            k1);
    return;
  }
  Chain<NW> c;
  c.init(s, t, g);
  for (int j = 0; j < n_anc; ++j)
    c.template open<false>(s, t, __ldg(anc + j), 0);
  int d = 0;
  for (int k = k0; k < k1; ++k) {
    const int ring_slot = (k - k0) % kRingSlots;
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
    if (k + kRingSlots < k1) bar_arrive(kEmptyBar + ring_slot);
  }
  // the document the stream ended inside; later (empty) slots hold nothing
  out.flush(s, t, g, seg, d);
  for (int dd = d + 1; dd < n_docs; ++dd) out.clear(t, g, seg, dd);
}

// ------------------------------------------------------------- pieces
// An event walk over a run of positions, from any stack depth: its events
// `n`, the net depth change `net`, the least and the most prefix sum of
// +1 (open) / -1 (close), the empty prefix counted as 0 (`lo` <= 0 <=
// `hi`), and the most the sum rises above its running least (`rise`).
// From depth d (closes at the root do nothing) the walk ends at
// max(d + net, net - lo), its least depth is max(0, d + lo) and its
// deepest max(d + hi, rise).  Walks compose associatively, in order.
struct Walk {
  int n, net, lo, hi, rise;
};

__device__ __forceinline__ Walk walk_of(int ev) {
  if (ev < 0) return Walk{0, 0, 0, 0, 0};
  if ((ev >> 12) & 1) return Walk{1, -1, -1, 0, 0};
  return Walk{1, 1, 0, 1, 1};
}

__device__ __forceinline__ Walk compose(const Walk& a, const Walk& b) {
  return Walk{a.n + b.n, a.net + b.net, min(a.lo, a.net + b.lo),
              max(a.hi, a.net + b.hi),
              max(max(a.rise, b.rise), a.net - a.lo + b.hi)};
}

__device__ __forceinline__ int depth_after(const Walk& w, int d) {
  return max(d + w.net, w.net - w.lo);
}

__device__ __forceinline__ Walk shfl_walk_up(const Walk& w, int o) {
  return Walk{__shfl_up_sync(kFull, w.n, o), __shfl_up_sync(kFull, w.net, o),
              __shfl_up_sync(kFull, w.lo, o), __shfl_up_sync(kFull, w.hi, o),
              __shfl_up_sync(kFull, w.rise, o)};
}

// Inclusive scan of the lanes' walks, in lane order.
__device__ __forceinline__ Walk warp_scan(Walk w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Walk l = shfl_walk_up(w, o);
    if (lane >= o) w = compose(l, w);
  }
  return w;
}

// The walk of one lane's positions of the window from p0 (positions past
// the row's end start nothing); `ev` gets each position's event.
__device__ __forceinline__ Walk lane_walk(const uint8_t* __restrict__ row,
                                          int length, int p0,
                                          int (&ev)[kPerLane]) {
  int b[kPerLane + 3];
  load_lane(row, length, p0, b);
  Walk w{0, 0, 0, 0, 0};
#pragma unroll
  for (int x = 0; x < kPerLane; ++x) {
    ev[x] = p0 + x < length ? classify(b[x], b[x + 1], b[x + 2], b[x + 3])
                            : -1;
    w = compose(w, walk_of(ev[x]));
  }
  return w;
}

// One warp a window of a segment: the window's walk into walks (S, W).  The
// grid also clears the merged lanes, n_out of each, for the pieces' atomics.
__global__ void __launch_bounds__(256)
piece_windows(const uint8_t* __restrict__ data, int length, int n_windows,
              Walk* walks, int32_t* matched, int32_t* first, size_t n_out) {
  const size_t nthreads =
      static_cast<size_t>(gridDim.x) * gridDim.y * blockDim.x;
  for (size_t i = (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                      blockDim.x + threadIdx.x;
       i < n_out; i += nthreads) {
    matched[i] = 0;
    first[i] = kNoMatch;
  }
  const int w = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int seg = blockIdx.y, lane = threadIdx.x & 31;
  if (w >= n_windows) return;  // uniform over the warp
  int ev[kPerLane];
  Walk acc = warp_scan(lane_walk(data + static_cast<size_t>(seg) * length,
                                 length, w * kWindow + lane * kPerLane, ev));
  if (lane == 31) walks[static_cast<size_t>(seg) * n_windows + w] = acc;
}

// One block a segment, in three steps.
// 1. Scan the windows' walks from the root: each window's first ordinal,
//    its depth at its start and its least depth (`ords`, `depth`, `low`,
//    (S, W)), and the segment's whole walk.
// 2. Cut the segment into n_pieces runs of windows, as even as whole
//    windows allow, and write each piece's entry (piece_words): windows,
//    first ordinal (the events of the windows before it) and depth D.  A
//    segment deeper than max_depth + 1 goes whole to its first piece, and
//    its other pieces get no windows.
// 3. Each ancestor of a piece at level k <= D is the last OPEN reaching
//    depth k before the piece: it lies in the last window before the piece
//    whose least depth is below k (after it the depth stays >= k).  One warp
//    a piece walks back over the windows 128 at a time to find those
//    windows (kept in the entry's ancestor slots), then one warp a (piece,
//    level) replays its window's events and puts the ancestor's tag in its
//    slot.
__global__ void __launch_bounds__(kPlanThreads)
piece_plan(const uint8_t* __restrict__ data, int length, int n_windows,
           int n_pieces, int max_depth, const Walk* __restrict__ walks,
           int32_t* ords, int32_t* depth, int32_t* low, int32_t* plan) {
  __shared__ Walk carry[kPlanThreads / 32];
  __shared__ Walk whole;  // the segment's walk
  const int seg = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kPlanThreads / 32;
  const size_t row0 = static_cast<size_t>(seg) * n_windows;
  const int words = piece_words(max_depth);
  int32_t* entries = plan + static_cast<size_t>(seg) * n_pieces * words;
  // 1. each thread folds a run of windows; a block scan gives its prefix
  const int per = (n_windows + kPlanThreads - 1) / kPlanThreads;
  const int w0 = min(tid * per, n_windows), w1 = min(w0 + per, n_windows);
  Walk mine{0, 0, 0, 0, 0};
  for (int w = w0; w < w1; ++w) mine = compose(mine, walks[row0 + w]);
  Walk incl = warp_scan(mine);
  if (lane == 31) carry[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warps' totals
    const Walk ex = shfl_walk_up(warp_scan(carry[lane]), 1);
    __syncwarp();
    carry[lane] = lane == 0 ? Walk{0, 0, 0, 0, 0} : ex;
  }
  __syncthreads();
  const Walk before_lane = shfl_walk_up(incl, 1);
  Walk pre = lane == 0 ? carry[warp] : compose(carry[warp], before_lane);
  if (tid == kPlanThreads - 1) whole = compose(pre, mine);
  for (int w = w0; w < w1; ++w) {
    const Walk x = walks[row0 + w];
    const int d = depth_after(pre, 0);
    ords[row0 + w] = pre.n;
    depth[row0 + w] = d;
    low[row0 + w] = max(0, d + x.lo);
    pre = compose(pre, x);
  }
  __syncthreads();
  const bool clipped = whole.rise > max_depth + 1;
  // 2. the pieces' windows, first ordinals and depths
  for (int i = tid; i < n_pieces; i += kPlanThreads) {
    int32_t* e = entries + static_cast<size_t>(i) * words;
    int c0 = static_cast<int>(static_cast<long long>(i) * n_windows /
                              n_pieces);
    int c1 = static_cast<int>(static_cast<long long>(i + 1) * n_windows /
                              n_pieces);
    if (clipped) {
      c0 = 0;
      c1 = i == 0 ? n_windows : 0;
    }
    const bool inside = !clipped && c0 < n_windows;
    e[0] = c0;
    e[1] = c1;
    e[2] = inside ? ords[row0 + c0] : 0;
    e[3] = inside ? depth[row0 + c0] : 0;
  }
  __syncthreads();
  // 3a. the window of each ancestor; lane l takes the four windows
  // top - 4 l - j, j < 4, so the lanes go back from `top` in order
  for (int i = warp; i < n_pieces; i += nwarps) {
    int32_t* e = entries + static_cast<size_t>(i) * words;
    int kmax = e[3];  // levels 1..kmax still without a window
    for (int top = e[0] - 1; kmax > 0 && top >= 0; top -= 128) {
      int lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = top - 4 * lane - j;
        lo[j] = w >= 0 ? low[row0 + w] : INT32_MAX;
      }
      // inclusive min over the lanes before and this one
      int m = min(min(lo[0], lo[1]), min(lo[2], lo[3]));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, m, o);
        if (lane >= o) m = min(m, v);
      }
      const int later = __shfl_up_sync(kFull, m, 1);  // later windows' least
      int above = lane == 0 ? kmax : min(kmax, later);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = top - 4 * lane - j;
        if (w >= 0)
          for (int k = lo[j] + 1; k <= above; ++k) e[4 + k - 1] = w;
        above = min(above, lo[j]);
      }
      kmax = min(kmax, __shfl_sync(kFull, m, 31));
    }
  }
  __syncthreads();
  // 3b. each ancestor's tag: the last OPEN of its window reaching its level
  const uint8_t* row = data + static_cast<size_t>(seg) * length;
  const int levels = max_depth + 1;
  for (int pair = warp; pair < n_pieces * levels; pair += nwarps) {
    int32_t* e = entries + static_cast<size_t>(pair / levels) * words;
    const int k = pair % levels + 1;
    if (k > e[3]) continue;  // uniform over the warp
    const int w = e[4 + k - 1];
    int ev[kPerLane];
    const Walk own = lane_walk(row, length, w * kWindow + lane * kPerLane, ev);
    const Walk incl2 = warp_scan(own);
    const Walk ex = shfl_walk_up(incl2, 1);
    int dep = lane == 0 ? depth[row0 + w] : depth_after(ex, depth[row0 + w]);
    int tag = -1;
#pragma unroll
    for (int x = 0; x < kPerLane; ++x) {
      if (ev[x] < 0) continue;
      if ((ev[x] >> 12) & 1) {
        dep = max(dep - 1, 0);
      } else if (++dep == k) {
        tag = ev[x] & 0xfff;
      }
    }
    const unsigned has = __ballot_sync(kFull, tag >= 0);
    tag = __shfl_sync(kFull, tag, has ? 31 - __clz(has) : 0);
    if (lane == 0) e[4 + k - 1] = tag;
  }
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
                    const Entries& e, const Out& out, const int32_t* plan,
                    int n_pieces, void* stream) {
  const size_t smem =
      smem_bytes(t.n_tags, t.wb, t.qb, t.max_depth, Out::kSparse, true);
  return launch(bytes_kernel<Out, NW>,
                dim3(t.n_blocks, n_segments * n_pieces), 64, smem, stream,
                static_cast<const uint8_t*>(data), length,
                static_cast<const int32_t*>(starts), n_docs, t, e.ent,
                e.toff, out, plan, n_pieces);
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

int n_windows_of(int length) { return (length + kWindow - 1) / kWindow; }

// int32 words of the piece plan's scratch, after the gather entries: the
// windows' walks (S, W), their first ordinals, depths and least depths
// (S, W) each, and the pieces' entries (S, P, piece_words).
size_t piece_scratch_words(int n_segments, int n_pieces, int length,
                           int max_depth) {
  const size_t sw = static_cast<size_t>(n_segments) * n_windows_of(length);
  return sw * (sizeof(Walk) / 4 + 3) +
         static_cast<size_t>(n_segments) * n_pieces * piece_words(max_depth);
}

// The piece plan of S one-document segments, into `scratch` (see
// piece_scratch_words), with the dense output cleared for the merge;
// `*plan` gets the pieces' entries.
int plan_pieces(const void* data, int n_segments, int length, int n_pieces,
                int max_depth, const DenseOut& out, const Tables& t,
                int32_t* scratch, void* stream, const int32_t** plan) {
  const int n_windows = n_windows_of(length);
  const size_t sw = static_cast<size_t>(n_segments) * n_windows;
  Walk* walks = reinterpret_cast<Walk*>(scratch);
  int32_t* ords = scratch + sw * (sizeof(Walk) / 4);
  int32_t* depth = ords + sw;
  int32_t* low = depth + sw;
  int32_t* entries = low + sw;
  *plan = entries;
  const size_t n_out = static_cast<size_t>(n_segments) * t.n_blocks * t.qb;
  const int per_block = 256 / 32;  // windows, one a warp
  int err = launch(piece_windows,
                   dim3((n_windows + per_block - 1) / per_block, n_segments),
                   256, 0, stream, static_cast<const uint8_t*>(data), length,
                   n_windows, walks, out.matched, out.first, n_out);
  if (err != 0) return err;
  return launch(piece_plan, dim3(n_segments), kPlanThreads, 0, stream,
                static_cast<const uint8_t*>(data), length, n_windows,
                n_pieces, max_depth, static_cast<const Walk*>(walks), ords,
                depth, low, entries);
}

template <class Out>
int launch_bytes(const void* data, int n_segments, int length,
                 const void* starts, int n_docs, const Tables& t,
                 const Out& out, void* scratch, const int32_t* plan,
                 int n_pieces, void* stream) {
  if (n_docs >= kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  Entries e;
  const int err = prepare(t, scratch, stream, &e);
  if (err != 0) return err;
  return with_words_per_lane(t.wb, [&](auto nw) {
    return launch_bytes_nw<Out, decltype(nw)::value>(
        data, n_segments, length, starts, n_docs, t, e, out, plan, n_pieces,
        stream);
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

// int32 words a dense byte launch in n_pieces > 1 pieces takes after the
// gather entries (its piece plan).
long long sf_piece_words(int n_segments, int n_pieces, int length,
                         int max_depth) {
  return static_cast<long long>(
      piece_scratch_words(n_segments, n_pieces, length, max_depth));
}

// Thread blocks of the dense byte kernel that the current card holds at
// once (blocks an SM at its shared memory, times the SMs); -1 on error.
int sf_bytes_resident(int n_tags, int wb, int qb, int max_depth) {
  const size_t smem = smem_bytes(n_tags, wb, qb, max_depth, false, true);
  return with_words_per_lane(wb, [&](auto nw) {
    const auto kernel = bytes_kernel<DenseOut, decltype(nw)::value>;
    int per_sm = 0, dev = 0, sms = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 64,
                                                      smem) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return -1;
    return per_sm * sms;
  });
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
                     static_cast<int32_t*>(first), 1, false};
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

// n_pieces > 1 runs each one-document segment (n_docs 1) as that many
// pieces in time; the scratch then holds sf_piece_words more words.
int sf_bytes(const void* data, int n_segments, int length, const void* starts,
             int n_docs, const void* tagmask, const void* pw, const void* pb,
             const void* selfloop, const void* init, const void* acc_word,
             const void* acc_bit, int n_blocks, int n_tags, int wb, int qb,
             int max_depth, void* matched, void* first, void* scratch,
             int n_pieces, void* stream) {
  if (n_pieces < 1 || (n_pieces > 1 && (n_docs != 1 || length < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t = make_tables(tagmask, pw, pb, selfloop, init, acc_word,
                               acc_bit, n_blocks, n_tags, wb, qb, max_depth);
  const DenseOut out{static_cast<int32_t*>(matched),
                     static_cast<int32_t*>(first), n_docs, n_pieces > 1};
  const int32_t* plan = nullptr;
  if (n_pieces > 1) {
    const int err = plan_pieces(
        data, n_segments, length, n_pieces, max_depth, out, t,
        static_cast<int32_t*>(scratch) + scratch_words(n_blocks, n_tags, wb),
        stream, &plan);
    if (err != 0) return err;
  }
  return launch_bytes(data, n_segments, length, starts, n_docs, t, out,
                      scratch, plan, n_pieces, stream);
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
                      scratch, nullptr, 1, stream);
}

}  // extern "C"
