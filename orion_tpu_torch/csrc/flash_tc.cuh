// The block plan shared by the bf16 tensor-core kernels of K3
// (flash_fwd.cu, flash_fwd_tc_kernel) and K7 (flash_bwd.cu,
// flash_dq_tc_kernel): one block of 8 warps per (q tile of 128 rows, q
// head, batch), a warp per 16 query rows, and a loop over key steps of 32
// keys streamed through a two-stage cp.async ring (K, V and the keys'
// segment ids).
//
// Which (query, key) pairs count is one contract for K3, K7 and K8: the
// causal diagonal with q_offset, the sliding window, kv range, segment
// ids, and under seg_pad_zero the tile skip of K3's float32 kernel, which
// runs tiles of 64 rows x 32 keys and skips a tile whose rows or keys are
// all padding (segment 0). So a padding pair (segment 0 against segment
// 0) counts only where a live 64-row q tile meets a live 32-key tile. A
// warp's 16 rows lie in one 64-row tile and a step is one 32-key tile, so
// that liveness is uniform over a warp's step: a dead step is skipped by
// the warp (no products), and no per-pair test is needed for it.
//
// Per warp and step, Step says whether the step is dead (nothing to
// attend: liveness, the diagonal, the window, rows past Sq) or full
// (every pair kept, so no mask is applied): rows and keys in range,
// wholly inside the diagonal and the window, and, with segments, every
// row and key of the step carrying the same segment id (compared as the
// warp's min/max row id against the step's min/max key id). The serve
// always passes segment ids, so without that last test the fast path
// would never fire there.
//
// Explicit positions (K3 only: qpos [B, Sq], kpos [B, Skv] in Mask): the
// causal and window tests compare positions, not indices, and nothing
// assumes they rise (a striped layout's do not). K3's bf16 positions
// kernel packs a kv head's G query heads into one block (PackRows: product
// row r is query q0 + r % tq of the group's head r / tq, tq * G <= ROWS),
// and live_steps lists the key steps a block may attend from the extremes
// of its q positions and of each step's kv positions (and, under
// seg_pad_zero, the step's liveness), so the ring loads only those;
// classify_pos then tests each warp's q extremes against the step's: dead
// when the warp's largest q position precedes the step's smallest kv
// position, or, under a window, when the step's largest kv position is at
// or below the warp's smallest q position less the window; full when every
// pair lies inside the diagonal and the window. A warp's 16 rows lie in
// one 64-query tile (tq is a power of two), so the liveness contract above
// holds for it unchanged. K7's positions branch walks the same list per
// block of 128 rows of one head (PackRows with G = 1), classify_pos per
// warp. K8's walks the transpose (live_qtiles): the q tiles that can reach
// a block's keys, from each tile's q extremes against the keys'.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tc.cuh"

namespace ftc {

constexpr int ROWS = 128;  // query rows of a block (8 warps x 16)
constexpr int KB = 32;     // keys per step: the float32 K3's kv tile
constexpr int SUB = 64;    // the float32 K3's q tile: the unit of q liveness
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int POS_MAX = 0x7fffffff;
constexpr int POS_MIN = -POS_MAX - 1;

// Blocks per SM the kernels are compiled for: two (at most 128 registers
// a thread) up to H = 128, one at H = 256.
template <int HD> __host__ __device__ constexpr int min_blocks() { return HD <= 128 ? 2 : 1; }

// The mask arguments both kernels' Args carry (positions: K3's only).
struct Mask {
  int Sq, Skv;
  int causal, q_offset, window;
  bool has_seg, skip_pad;
  const int* qpos = nullptr;  // [B, Sq] explicit q positions, or null
  const int* kpos = nullptr;  // [B, Skv] explicit kv positions
};

// Key steps [begin, end) of the block at q0: steps wholly past the
// diagonal of its last real row or wholly behind the window of its first
// row attend nothing.
__device__ __forceinline__ void step_range(const Mask& m, int q0, int& begin, int& end) {
  const int n_kt = (m.Skv + KB - 1) / KB;
  end = n_kt;
  begin = 0;
  if (m.causal) {
    const int qlast = min(q0 + ROWS, m.Sq) - 1 + m.q_offset;
    end = qlast < 0 ? 0 : min(n_kt, qlast / KB + 1);
    if (m.window > 0) {
      const int cmin = q0 + m.q_offset - m.window + 1;
      begin = cmin > 0 ? cmin / KB : 0;
    }
  }
  if (end < begin) end = begin;
}

// This thread's two rows (grp and grp + 8 of the warp's 16) and the
// warp's row facts.
struct Rows {
  int r0;         // the warp's first query row
  int qseg[2];    // segment ids of the thread's rows (0 past Sq or without segments)
  int smin, smax; // the warp's least and greatest row segment id
  bool live;      // seg_pad_zero: the warp's 64-row q tile holds a real row
};

// Reads the rows' segment ids; liveness of both 64-row tiles of the block
// by two barriers (every thread must call it). Returns whether any row of
// the block is live (always true without seg_pad_zero).
__device__ __forceinline__ bool load_rows(const Mask& m, const int* qseg, int b, int q0, Rows& r) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, grp = lane >> 2;
  r.r0 = q0 + warp * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r.r0 + grp + 8 * h;
    r.qseg[h] = (m.has_seg && qi < m.Sq) ? qseg[static_cast<int64_t>(b) * m.Sq + qi] : 0;
  }
  r.smin = r.smax = 0;
  if (m.has_seg) {
    r.smin = __reduce_min_sync(FULL, min(r.qseg[0], r.qseg[1]));
    r.smax = __reduce_max_sync(FULL, max(r.qseg[0], r.qseg[1]));
  }
  r.live = true;
  if (!m.skip_pad) return true;
  int own = 0;
  if (tid < ROWS && q0 + tid < m.Sq) own = qseg[static_cast<int64_t>(b) * m.Sq + q0 + tid];
  const bool lo = __syncthreads_or(tid < SUB && own > 0);
  const bool hi = __syncthreads_or(tid >= SUB && tid < ROWS && own > 0);
  r.live = warp < SUB / 16 ? lo : hi;
  return lo || hi;
}

// Asynchronous load of key step k0 (K and V rows of kv head kvh, the
// keys' segment ids and, with positions, their positions) into ring stage
// `kv` ([K [KB][LD], V [KB][LD]]), `ks` and `kp` ([KB] each); keys past
// Skv are zero-filled (segment 0).
template <int HD>
__device__ __forceinline__ void load_step(const Mask& m, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, const int* kseg, int b,
                                          int kvh, int K, int k0, __nv_bfloat16* kv, int* ks,
                                          int* kp = nullptr) {
  constexpr int LD = HD + 8, CH = HD / 8;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 2 * KB * CH; idx += NT) {
    const int which = idx / (KB * CH), r = (idx / CH) % KB, c = (idx % CH) * 8;
    const int j = k0 + r;
    const bool in = j < m.Skv;
    const int64_t off = in ? ((static_cast<int64_t>(b) * m.Skv + j) * K + kvh) * HD + c : 0;
    tc::cp16(kv + which * KB * LD + r * LD + c, (which ? v : k) + off, in);
  }
  if (tid < KB) {
    const int j = k0 + tid;
    const bool in = m.has_seg && j < m.Skv;
    const void* src = in ? static_cast<const void*>(kseg + static_cast<int64_t>(b) * m.Skv + j)
                         : static_cast<const void*>(k);
    tc::cp4(ks + tid, src, in);
  }
  if (m.kpos != nullptr && tid >= KB && tid < 2 * KB) {
    const int j = k0 + tid - KB;
    const bool in = j < m.Skv;
    const void* src = in ? static_cast<const void*>(m.kpos + static_cast<int64_t>(b) * m.Skv + j)
                         : static_cast<const void*>(m.kpos);
    tc::cp4(kp + tid - KB, src, in);
  }
}

// Explicit positions: the key steps a block whose queries are [q0, q0 +
// nq) may attend, in order, into `steps` (n_kt ints of shared memory;
// `red` 3 more), and their number (every thread must call it; it returns
// the same to all). A step is out when it is all padding under
// seg_pad_zero (or no row is live), when its least kv position exceeds the
// block's greatest q position, or, under a window, when its greatest kv
// position is at or below the block's least q position less the window.
// A warp takes eight steps at a time, a lane a key of each: one coalesced
// pass over the row's kv positions (and segment ids), 4 bytes a key. With
// non-null `facts` (3 n_kt ints of shared memory) it also keeps each
// step's least and greatest kv position and its one key segment id (or
// -1), so the walk classifies a step without reductions (classify_pos).
__device__ __forceinline__ int live_steps(const Mask& m, const int* kseg, int b, int q0, int nq,
                                          bool rows_live, int* steps, int* red,
                                          int* facts = nullptr) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int lo = POS_MAX, hi = POS_MIN;
  for (int r = tid; r < nq; r += NT) {
    if (q0 + r < m.Sq) {
      const int p = m.qpos[static_cast<int64_t>(b) * m.Sq + q0 + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (tid == 0) {
    red[0] = POS_MAX;
    red[1] = POS_MIN;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(red, lo);
    atomicMax(red + 1, hi);
  }
  __syncthreads();
  const int64_t qmin = red[0], qmax = red[1];
  const int n_kt = (m.Skv + KB - 1) / KB;
  const int64_t krow = static_cast<int64_t>(b) * m.Skv;
  constexpr int SPW = 8;  // steps a warp takes at once, their loads in flight together
  for (int t0 = warp * SPW; t0 < n_kt; t0 += NT / 32 * SPW) {
    int p[SPW], sg[SPW];
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int c = (t0 + j) * KB + lane;
      const bool in = t0 + j < n_kt && c < m.Skv;
      p[j] = in ? m.kpos[krow + c] : 0;
      sg[j] = in && m.skip_pad ? kseg[krow + c] : 0;
    }
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int t = t0 + j;
      const bool in = t * KB + lane < m.Skv;
      const int kmin = __reduce_min_sync(FULL, in ? p[j] : POS_MAX);
      const int kmax = __reduce_max_sync(FULL, in ? p[j] : POS_MIN);
      bool live = rows_live;
      if (m.skip_pad) live = live && __any_sync(FULL, sg[j] > 0);
      if (m.causal) live = live && kmin <= qmax && (m.window <= 0 || kmax > qmin - m.window);
      if (lane == 0 && t < n_kt) steps[t] = live;
      if (facts != nullptr) {
        // Segment ids as the ring stages them: 0 past Skv.
        const int s = in && m.has_seg ? kseg[krow + t * KB + lane] : 0;
        const int smin = __reduce_min_sync(FULL, s), smax = __reduce_max_sync(FULL, s);
        if (lane == 0 && t < n_kt) {
          facts[3 * t] = kmin;
          facts[3 * t + 1] = kmax;
          facts[3 * t + 2] = smin == smax ? smin : -1;
        }
      }
    }
  }
  __syncthreads();
  if (tid < 32) {
    // In-place compaction by one warp: a chunk's flags are all read
    // before the ballot, and its writes land at or below the chunk.
    int count = 0;
    for (int base = 0; base < n_kt; base += 32) {
      const int t = base + lane;
      const bool f = t < n_kt && steps[t] != 0;
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) steps[count + __popc(bal & ((1u << lane) - 1u))] = t;
      count += __popc(bal);
    }
    if (lane == 0) red[2] = count;
  }
  __syncthreads();
  return red[2];
}

// Explicit positions, the transpose of live_steps (K8): the q tiles of tq
// queries that may reach the keys [k0, k0 + nk) of row b, in order, into
// `tiles` (n_qt ints of shared memory; `red` 3 more), and their number
// (every thread must call it; it returns the same to all). A tile is out
// when it holds no query, or (causal) when its greatest q position precedes
// the keys' least kv position, or, under a window, when the keys' greatest
// kv position is at or below its least q position less the window. A warp
// takes a tile at a time, each lane tq / 32 of its queries: one coalesced
// pass over the row's q positions. `facts` (2 n_qt ints) keeps each tile's
// least and greatest q position, by tile; kmin / kmax return the keys'.
__device__ __forceinline__ int live_qtiles(const Mask& m, int b, int k0, int nk, int tq,
                                           int* tiles, int* red, int* facts, int& kmin,
                                           int& kmax) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int lo = POS_MAX, hi = POS_MIN;
  for (int r = tid; r < nk; r += NT) {
    if (k0 + r < m.Skv) {
      const int p = m.kpos[static_cast<int64_t>(b) * m.Skv + k0 + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (tid == 0) {
    red[0] = POS_MAX;
    red[1] = POS_MIN;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(red, lo);
    atomicMax(red + 1, hi);
  }
  __syncthreads();
  kmin = red[0];
  kmax = red[1];
  const int n_qt = (m.Sq + tq - 1) / tq;
  const int64_t qrow = static_cast<int64_t>(b) * m.Sq;
  for (int t = warp; t < n_qt; t += NT / 32) {
    int qlo = POS_MAX, qhi = POS_MIN;
    for (int i = lane; i < tq; i += 32) {
      const int s = t * tq + i;
      if (s < m.Sq) {
        const int p = m.qpos[qrow + s];
        qlo = min(qlo, p);
        qhi = max(qhi, p);
      }
    }
    qlo = __reduce_min_sync(FULL, qlo);
    qhi = __reduce_max_sync(FULL, qhi);
    bool live = qlo <= qhi && kmin <= kmax;  // a query and a key
    if (m.causal)
      live = live && qhi >= kmin &&
             (m.window <= 0 || static_cast<int64_t>(kmax) > static_cast<int64_t>(qlo) - m.window);
    if (lane == 0) {
      tiles[t] = live;
      facts[2 * t] = qlo;
      facts[2 * t + 1] = qhi;
    }
  }
  __syncthreads();
  if (tid < 32) {
    // In-place compaction by one warp, as in live_steps.
    int count = 0;
    for (int base = 0; base < n_qt; base += 32) {
      const int t = base + lane;
      const bool f = t < n_qt && tiles[t] != 0;
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) tiles[count + __popc(bal & ((1u << lane) - 1u))] = t;
      count += __popc(bal);
    }
    if (lane == 0) red[2] = count;
  }
  __syncthreads();
  return red[2];
}

// The rows of a GQA-packed block (K3's bf16 positions kernel): product row
// r of the ROWS is query q0 + r % tq of the group's head r / tq, so a
// warp's 16 rows are 16 queries of one head (tq >= 16) or the same tq
// queries of 16 / tq heads; either way they lie in one 64-query tile. The
// thread keeps what the mask needs of its two rows; the warp's extremes and
// flags go to shared memory (WarpFacts), read once a step.
struct PackRows {
  int qi[2];    // the thread's two rows' queries (grp and grp + 8 of the warp's 16)
  int qseg[2];  // segment ids (0 for a row that is not valid, or without segments)
  int qp[2];    // positions (0 for a row that is not valid)
};

// A warp's facts: its least and greatest q position (valid rows) and row
// segment id, and flags: some row valid (a real (head, query) row), every
// row valid, its 64-query tile live (a real query; always without
// seg_pad_zero).
struct WarpFacts {
  int pmin, pmax, smin, smax, flags;
};
constexpr int ANY_ROW = 1, ALL_ROWS = 2, TILE_LIVE = 4;

// The product row (of ROWS) of the thread's row h: / tq its head in the
// group, % tq its query in the block.
__device__ __forceinline__ int packed_row(int h) {
  return threadIdx.x / 32 * 16 + (threadIdx.x % 32 >> 2) + 8 * h;
}

// Reads the rows' segment ids and positions and writes the warp's facts to
// wf[warp] (every thread must call it: one barrier). Returns whether some
// warp of the block has a valid row in a live tile (with nothing to attend
// otherwise, the block writes zeros).
__device__ __forceinline__ bool load_packed_rows(const Mask& m, const int* qseg, int b, int q0,
                                                 int tq, int G, PackRows& r, WarpFacts* wf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t row0 = static_cast<int64_t>(b) * m.Sq;
  int lo = POS_MAX, hi = POS_MIN;
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pr = packed_row(h);
    r.qi[h] = q0 + pr % tq;
    valid[h] = pr / tq < G && r.qi[h] < m.Sq;
    r.qseg[h] = (m.has_seg && valid[h]) ? qseg[row0 + r.qi[h]] : 0;
    r.qp[h] = valid[h] ? m.qpos[row0 + r.qi[h]] : 0;
    if (valid[h]) {
      lo = min(lo, r.qp[h]);
      hi = max(hi, r.qp[h]);
    }
  }
  const bool all = __all_sync(FULL, valid[0] && valid[1]);
  const bool any = __any_sync(FULL, valid[0] || valid[1]);
  int smin = 0, smax = 0;
  if (m.has_seg) {
    smin = __reduce_min_sync(FULL, min(r.qseg[0], r.qseg[1]));
    smax = __reduce_max_sync(FULL, max(r.qseg[0], r.qseg[1]));
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  bool live = true;
  if (m.skip_pad) {
    const int t0 = (q0 + (warp * 16) % tq) / SUB * SUB;
    bool own = false;
    for (int i = lane; i < SUB; i += 32)
      own = own || (t0 + i < m.Sq && qseg[row0 + t0 + i] > 0);
    live = __any_sync(FULL, own);
  }
  if (lane == 0)
    wf[warp] = WarpFacts{lo, hi, smin, smax,
                         (any ? ANY_ROW : 0) | (all ? ALL_ROWS : 0) | (live ? TILE_LIVE : 0)};
  return __syncthreads_or(live && any);
}

// What a warp does with the step at k0 whose key segment ids are ks.
struct Step {
  bool dead;  // no pair of the warp's rows counts: skip the products
  bool full;  // every pair counts: no mask
};

__device__ __forceinline__ Step classify(const Mask& m, const Rows& r, int k0, const int* ks) {
  const int lane = threadIdx.x % 32;
  const int kown = ks[lane];
  bool kv_live = true, same = true;
  if (m.has_seg) {
    kv_live = __any_sync(FULL, kown > 0);
    const int kmin = __reduce_min_sync(FULL, kown), kmax = __reduce_max_sync(FULL, kown);
    same = r.smin == r.smax && kmin == kmax && kmin == r.smin;
  }
  // causal: no pair attends / every pair attends
  const int qfirst = r.r0 + m.q_offset, qlast = r.r0 + 15 + m.q_offset;
  const bool behind = k0 > qlast || (m.window > 0 && k0 + KB - 1 <= qfirst - m.window);
  const bool inside = k0 + KB - 1 <= qfirst && (m.window <= 0 || qlast - k0 < m.window);
  Step s;
  s.dead = r.r0 >= m.Sq || (m.skip_pad && !(r.live && kv_live)) || (m.causal && behind);
  s.full = !s.dead && r.r0 + 16 <= m.Sq && k0 + KB <= m.Skv && same && (!m.causal || inside);
  return s;
}

// The same for a packed warp with explicit positions, from the warp's
// facts and the step's (kept by live_steps: its least and greatest kv
// position, and its one key segment id or -1), without a reduction. A
// listed step is live under seg_pad_zero.
__device__ __forceinline__ Step classify_pos(const Mask& m, const WarpFacts& w, int k0,
                                             const int* f) {
  const int64_t kmin = f[0], kmax = f[1];
  const bool behind =
      kmin > w.pmax || (m.window > 0 && kmax <= static_cast<int64_t>(w.pmin) - m.window);
  const bool inside = kmax <= w.pmin && (m.window <= 0 || w.pmax - kmin < m.window);
  const bool same = !m.has_seg || (w.smin == w.smax && f[2] == w.smin);
  Step s;
  s.dead = !(w.flags & ANY_ROW) || (m.skip_pad && !(w.flags & TILE_LIVE)) || (m.causal && behind);
  s.full = !s.dead && (w.flags & ALL_ROWS) && k0 + KB <= m.Skv && same && (!m.causal || inside);
  return s;
}

// Whether the pair (row qi with segment id qs, key c with segment id cs)
// counts on a step that is neither dead nor full (liveness is the warp's);
// with explicit positions qp and kp are the pair's positions.
__device__ __forceinline__ bool keep(const Mask& m, int qi, int qs, int c, int cs, int qp = 0,
                                     int kp = 0) {
  bool k = qi < m.Sq && c < m.Skv;
  if (m.causal) {
    const int d = m.qpos != nullptr ? qp - kp : qi + m.q_offset - c;
    k = k && d >= 0;
    if (m.window > 0) k = k && d < m.window;
  }
  if (m.has_seg) k = k && qs == cs;
  return k;
}

// The q tile of this block. LONGEST_FIRST runs causal tiles in reverse
// along the grid's slowest axis, so the tiles with the most keys start
// first and short ones fill the tail of the last wave. K3 measured faster
// so (2-3 % at the training shapes, 15-17 % at the ragged serve's), K7
// slower (5-10 %), so K7 keeps index order.
template <bool LONGEST_FIRST>
__device__ __forceinline__ int q_tile(const Mask& m) {
  return LONGEST_FIRST && m.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
}

}  // namespace ftc
