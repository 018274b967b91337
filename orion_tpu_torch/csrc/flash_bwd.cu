// K7 flash_dq and K8 flash_dkv: the flash-attention backward, hand-written
// for Hopper (sm_90a).
//
// Replace the TPU kernels orion_tpu/ops/pallas/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (the two pl.pallas_call in _bwd_call). FA-2 formulation:
// the probabilities are recomputed from the forward's saved log-sum-exp,
//   z  = softcap(q*scale . k),   P = exp(z - lse)   (0 where masked),
//   dP = dO . v,                 dZ = P * (dP - delta),
//   dS = dZ * (1 - t^2) under softcap (t = tanh(s / cap)), else dZ,
// with delta = rowsum(dO * O) computed by the wrapper. Then
//   dq = scale * sum_kv dS . k             (K7)
//   dk = scale * sum_q  dS^T . q,  dv = sum_q P^T . dO   (K8, over the G
//   query heads of the kv head's group).
// Layout at the interface is the JAX package's: q/dO/dq [B, Sq, N, H],
// k/v/dk/dv [B, Skv, K, H]; lse and delta float32 [B, N, Sq]. Masks as in
// K3 (flash_fwd.cu): causal with q_offset, sliding window, segment ids
// with the seg_pad_zero tile skip, kv padding.
//
// What bounds them on an H100: operations. K7 does three products per
// (query, key) pair (q.k, dO.v, dS.k: 6*H flops), K8 four (q.k, dO.v,
// P^T.dO, dS^T.q: 8*H flops), against ~H bytes per row read, far above the
// ridge point; the tensor-core bound at 989 TFLOP/s bf16 is what they are
// measured against.
//
// K8 in bfloat16 (flash_dkv_tc_kernel) runs its four products on the
// tensor cores, FA-2's dK/dV loop:
//   - one block of 8 warps per (kv tile of 64 keys, kv head, batch); the
//     loop over the G query heads of the group and the q tiles of 64 rows
//     lives in the block, dk/dv in f32 registers (a warp owns 16 kv rows x
//     H/2 columns of each), each element written once by one thread: no
//     atomics, the result does not depend on scheduling;
//   - K and V stay resident in shared memory as bf16; the q/dO tiles (with
//     their lse, delta and segment ids) load with 16-byte cp.async. Up to
//     H = 128 they have one buffer and the kernel is built for two blocks
//     per SM (at most 128 registers a thread), so one block's products
//     hide the other's loads: measured faster than two buffers and one
//     block. At H = 256 (245 registers) they are double-buffered, the next
//     step's load overlapping this step's products;
//   - phase 1: S^T = K.Q^T and dP^T = V.dO^T with mma.sync.m16n8k16 (bf16
//     in, f32 accumulate; ldmatrix fragments from rows skewed by 16 bytes),
//     a warp per 16 kv rows x 32 queries; P and dS in f32 registers, then
//     to shared memory as bf16; phase 2: dV += P^T.dO and dK += dS^T.Q, a
//     warp per 16 kv rows x H/2 columns;
//   - mma.sync and not wgmma (in K7 too): mma.sync's fragments need no
//     shared-memory descriptors or swizzled layouts, so the kernels can be
//     read against the formulas above; the positions kernels at H = 64 and
//     128 run on wgmma (below);
//   - skips and masks match K3's exactly: a 64-key tile holds two of K3's
//     64x32 tiles, the causal and window ranges of q tiles are K3's, and
//     under seg_pad_zero a pair counts only where K3 ran its sub-tile
//     (a live q tile and a live 32-key half), folded into the mask inside
//     the exponential; q tiles whose rows are all padding are skipped. A
//     step whose every pair is kept (no segments, in range, inside the
//     diagonal and the window) skips the mask, and a thread keeps its
//     columns' lse and delta in registers for the step.
// Shared memory: (2*64 + 2*64*buffers) rows of H + 8 bf16 plus 2 x 64 x 72
// bf16: 88,832 B at H = 128, 222,720 B at H = 256.
//
// K7 in bfloat16 (flash_dq_tc_kernel) runs its three products on the
// tensor cores, FA-2's dQ loop with K3's block plan (flash_tc.cuh):
//   - one block of 8 warps per (q tile of 128 rows, q head, batch), a warp
//     per 16 query rows; Q and dO stay resident in shared memory as bf16
//     (rows of H + 8), the rows' lse and delta in registers for the
//     block's life;
//   - a loop over key steps of 32 keys (the float32 K3's kv tile), K, V
//     and the keys' segment ids streamed through a two-stage cp.async
//     ring: the next step's load overlaps this step's products. 32 keys (not 64) keep S
//     and dP in 32 registers beside dq's H/2, so a thread fits 128
//     registers up to H = 128, and Q, dO and the ring fit 104,704 B, so
//     two blocks share an SM (one at H = 256, 203,008 B);
//   - S = Q.K^T and dP = dO.V^T on mma.sync.m16n8k16, the scale applied
//     to the f32 logits; P and dS in f32 registers, the mask inside the
//     exponential; dS becomes bf16 A fragments straight from the
//     accumulators' registers (the C layout of two adjacent 8-key blocks
//     is the A layout of one 16-key block), then dQ += dS.K with K read
//     as a [keys][H] B operand by ldmatrix.trans;
//   - dq in f32 registers, scaled once at the end and written by one
//     thread per element: no atomics, the result does not depend on
//     scheduling;
//   - the pairs that count are K3's and K8's by the shared skip contract:
//     a warp skips a step that none of its pairs attend (liveness under
//     seg_pad_zero per 64-row q tile and 32-key step, the diagonal, the
//     window), and a step whose every pair counts skips the mask;
//   - causal q tiles run in index order: longest first, which K3 gains
//     from, measured 5-10 % slower here over three timed runs of both
//     orders (flash_tc.cuh, q_tile).
//
// K7 and K8 in float32 (flash_dq_kernel, flash_dkv_kernel) keep a design
// of their own: products as plain f32 FMAs on the CUDA cores, like
// K3's float32 kernel (no mma, no cp.async), at the 67 TFLOP/s f32 rate at
// best. float32 stays there on purpose: the tensor cores would take it as
// TF32, and the f32 parity drives hold these kernels to 2e-6. What that
// design does:
//   - K7: one block per (q tile of 64 rows, q head, batch); Pallas's
//     sequential kv grid axis becomes a loop over kv tiles of 32 keys with
//     dq carried in registers (4 rows x H/16 columns per thread) and
//     written once.
//   - K8 (f32): one block per (kv tile of 32 keys, kv head, batch). Pallas
//     carries dk/dv in VMEM scratch across its sequential (group, q tile)
//     grid axes; blocks on the card run in no order, so the loop over the
//     G query heads of the group and over the q tiles lives inside the
//     block, with dk/dv in registers (2 rows x H/16 columns each per
//     thread). No atomics: each dk/dv row is written by exactly one thread
//     once, so the result does not depend on scheduling.
//   - Both use K3's float32 tiles (64 queries x 32 keys) and its score
//     loop, so a tile that K3 skipped (past the causal diagonal, behind
//     the window, or all padding under seg_pad_zero) is skipped here too,
//     and the recomputed logits are K3's bit for bit: exp(z - lse) never
//     sees a logit that lse did not count.
// Explicit positions, K7-pos and K8-pos: the has_pos branch of _dq_kernel
// (flash_attention.py:229) and _dkv_kernel (:274), masked by _block_mask
// and _block_run (:88-140). With non-null qpos [B, Sq] and kpos [B, Skv]
// (int32) the causal and window tests compare positions, not indices, and
// nothing assumes they rise (the ring's past blocks under a window, the
// striped ring's stripes). The gradient of K3's positions branch, with the
// lse cotangent folded into delta by the wrapper; no seg_pad_zero, no
// q_offset. Bound by operations, as K7 and K8. In bfloat16 at H = 64 and
// 128, warp-specialised kernels on wgmma and TMA (namespace wg, the
// building blocks in hopper.cuh); ops/flash_pos_bwd.py writes their plan
// out in PyTorch:
//   - a plan pass per call (bwd_plan_kernel, into a scratch tensor the
//     wrapper allocates, a block a batch row): each 64-entry tile's least
//     and greatest position and segment id, once, so no block rescans a
//     sequence; from them every (q tile, kv tile) pair is DEAD (no pair
//     admitted: neither loaded nor computed), FULL (every pair admitted:
//     no mask) or MASKED; and each batch row's blocks by their work
//     (K7: the kv tiles either q tile attends; K8: the live pairs of its
//     two kv tiles), most first, the grid running them in that order
//     with every head of a block together;
//   - a block is three warpgroups: two consumers (wgmma, 240 registers a
//     thread by setmaxnreg) and one warp of the third producing, the
//     block's walk read from shared memory: bf16 tiles by TMA (one thread)
//     with the 128-byte swizzle
//     into a ring guarded by full and empty mbarriers; the row arrays
//     (positions, segment ids, lse, delta) by the producer warp's cp.async
//     arriving on the same full barrier, as their rows start at any 4
//     bytes where a TMA box must start on 16;
//   - K7-pos (flash_dq_wg_kernel): a block per (128 query rows, q head);
//     Q and dO resident, K and V through a three-stage ring; S = Q.K^T and
//     dP = dO.V^T on wgmma m64n64k16 from shared memory in two commit
//     groups (S's exponentials overlap dP), dQ += dS.K on m64nHk16 with dS
//     from registers and K read MN-major; dq in f32 registers. A FULL step
//     costs one FFMA and one EX2 an element (the mask, positions and
//     segment ids only on MASKED steps; softcap a kernel of its own);
//   - K8-pos (flash_dkv_wg_kernel): a block per (128 keys, kv head), its
//     two 64-key tiles one after the other; K and V resident, Q, dO and
//     the queries' row arrays through a two-stage ring, walking (query
//     head of the group, q tile). The two consumer warpgroups split a step
//     by role: one S^T = K.Q^T, P^T and dV += P^T.dO, the other dP^T =
//     V.dO^T, dS^T and dK += dS^T.Q; only P^T passes between them, through
//     shared memory in f32 (dS^T = P^T (dP^T - delta) is formed before any
//     rounding, as in K7-pos and the JAX kernel), under two named barriers.
//     A warpgroup so holds one accumulator of H / 2 registers (dK or dV)
//     beside the step's 32: with dK and dV in one warpgroup ptxas kept a
//     32-register block in local memory (about 600 bytes of spill stores,
//     its wgmmas serialized, note C7512) and the kernel ran 1.25x slower.
//     What holds it back now: the second warpgroup waits for P^T once a
//     step, and each Q and dO tile is loaded once for each of the block's
//     two kv tiles;
//   - each output element is written once by one thread: two launches give
//     the same bits, no atomics.
// H = 16, 32 and 256 keep the mma.sync kernels, chosen in launch by head dim:
// flash_dq_tc_kernel<HD, true> and flash_dkv_tc_kernel<HD, true> (mma.sync,
// cp.async), the index kernels' templates with K3-pos's live-step list
// (flash_tc.cuh live_steps) and the q tiles that reach a kv tile
// (live_qtiles); float32 keeps the CUDA-core kernels (flash_dq_kernel,
// flash_dkv_kernel) with the same lists.
//
// In every kernel the mask goes inside the exponential, exp(keep ? z - lse
// : NEG_INF), never exp(z - lse) * mask: a row that attends nothing carries
// lse = NEG_INF, and exp(z - NEG_INF) would be inf (inf * 0 = NaN). Query
// rows past Sq are masked the same way. In the striped and windowed rings
// whole rows of a block attend nothing; their gradients are zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "flash_tc.cuh"
#include "hopper.cuh"
#include "tc.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile (K3's)
constexpr int BK = 32;   // keys per tile (K3's)
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, N, Sq]
  const float* delta;  // [B, N, Sq]
  void* dq;            // K7 output, [B, Sq, N, H]
  void* dk;            // K8 outputs, [B, Skv, K, H]
  void* dv;
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Skv] or null
  int Sq, Skv, N, K;
  int causal, q_offset, window, seg_pad_zero;
  float softcap, scale;
};

// Args with explicit positions, after the segment ids: what the positions
// kernels and the float32 kernels take. The bf16 index kernels keep taking
// Args: the argument struct's size enters their register allocation, and
// the positions added to Args raised K7's spills and its time by 17 %
// (measured, PERF.md §6).
struct PosArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  const int* qseg;
  const int* kseg;
  const int* qpos;     // [B, Sq] explicit positions, or null (K7/K8-pos)
  const int* kpos;     // [B, Skv]
  int Sq, Skv, N, K;
  int causal, q_offset, window, seg_pad_zero;
  float softcap, scale;

  Args args() const {
    return Args{q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, Sq, Skv, N, K,
                causal, q_offset, window, seg_pad_zero, softcap, scale};
  }
};

// Shared memory of one tile pair; both kernels use the same carve-up.
template <int HD>
struct Tile {
  float* Qs;      // [BQ][HD+1] q * scale
  float* dOs;     // [BQ][HD+1]
  float* Ks;      // [BK][HD+1]
  float* Vs;      // [BK][HD+1]
  float* Ps;      // [BQ][BK+1] probabilities (K8 only)
  float* Ss;      // [BQ][BK+1] dS
  float* lse_s;   // [BQ]
  float* delta_s; // [BQ]
  int* qseg_s;    // [BQ]
  int* kseg_s;    // [BK]
  // Explicit positions only (pos_bytes): the tile's q and kv positions,
  // three reduction ints, the list of live key steps (K7) or q tiles (K8)
  // and two ints of facts per list entry.
  int* qpos_s;    // [BQ]
  int* kpos_s;    // [BK]
  int* red;       // [4]
  int* list;      // [n]
  int* facts;     // [2 n]

  __device__ explicit Tile(float* smem, int n_list = 0) {
    Qs = smem;
    dOs = Qs + BQ * (HD + 1);
    Ks = dOs + BQ * (HD + 1);
    Vs = Ks + BK * (HD + 1);
    Ps = Vs + BK * (HD + 1);
    Ss = Ps + BQ * (BK + 1);
    lse_s = Ss + BQ * (BK + 1);
    delta_s = lse_s + BQ;
    qseg_s = reinterpret_cast<int*>(delta_s + BQ);
    kseg_s = qseg_s + BQ;
    qpos_s = kseg_s + BK;
    kpos_s = qpos_s + BQ;
    red = kpos_s + BK;
    list = red + 4;
    facts = list + n_list;
  }

  static constexpr size_t bytes() {
    return sizeof(float) * (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + 2 * BQ * (BK + 1) + 2 * BQ) +
           sizeof(int) * (BQ + BK);
  }
  static constexpr size_t pos_bytes(int n_list) { return sizeof(int) * (BQ + BK + 4 + 3 * n_list); }
};

// Row-level inputs of q tile q0 of head n: lse, delta, segment ids.
// Rows past Sq get lse = NEG_INF and are masked by in_q() below.
template <int HD>
__device__ __forceinline__ void load_rows(const PosArgs& a, Tile<HD>& t, int b, int n, int q0,
                                          bool has_seg) {
  const int tid = threadIdx.x;
  if (tid < BQ) {
    const int s = q0 + tid;
    const bool in = s < a.Sq;
    const int64_t row = (static_cast<int64_t>(b) * a.N + n) * a.Sq + s;
    t.lse_s[tid] = in ? a.lse[row] : NEG_INF;
    t.delta_s[tid] = in ? a.delta[row] : 0.f;
    t.qseg_s[tid] = (has_seg && in) ? a.qseg[static_cast<int64_t>(b) * a.Sq + s] : 0;
    if (a.qpos != nullptr) t.qpos_s[tid] = in ? a.qpos[static_cast<int64_t>(b) * a.Sq + s] : 0;
  }
}

// q (pre-scaled, as K3 does) and dO rows of q tile q0, head n.
template <int HD>
__device__ __forceinline__ void load_q(const PosArgs& a, Tile<HD>& t, int b, int n, int q0) {
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, h = i % HD, s = q0 + r;
    float x = 0.f, d = 0.f;
    if (s < a.Sq) {
      const int64_t g = ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + h;
      x = q[g];
      d = dout[g];
    }
    t.Qs[r * (HD + 1) + h] = x * a.scale;
    t.dOs[r * (HD + 1) + h] = d;
  }
}

// k and v rows of kv tile k0, kv head kvh, and their segment ids.
template <int HD>
__device__ __forceinline__ void load_kv(const PosArgs& a, Tile<HD>& t, int b, int kvh, int k0,
                                        bool has_seg) {
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  if (threadIdx.x < BK) {
    const int c = k0 + threadIdx.x;
    t.kseg_s[threadIdx.x] =
        (has_seg && c < a.Skv) ? a.kseg[static_cast<int64_t>(b) * a.Skv + c] : 0;
    if (a.kpos != nullptr)
      t.kpos_s[threadIdx.x] = c < a.Skv ? a.kpos[static_cast<int64_t>(b) * a.Skv + c] : 0;
  }
  for (int i = threadIdx.x; i < BK * HD; i += NT) {
    const int c = i / HD, h = i % HD, s = k0 + c;
    float kx = 0.f, vx = 0.f;
    if (s < a.Skv) {
      const int64_t g = ((static_cast<int64_t>(b) * a.Skv + s) * a.K + kvh) * HD + h;
      kx = k[g];
      vx = v[g];
    }
    t.Ks[c * (HD + 1) + h] = kx;
    t.Vs[c * (HD + 1) + h] = vx;
  }
}

// dS (and P) of the tile pair (q0, k0) into Ss (and Ps when keep_p).
// Thread layout as K3's score phase: rows r0..r0+3, keys cg and cg+16.
template <int HD>
__device__ __forceinline__ void tile_ds(const PosArgs& a, Tile<HD>& t, int q0, int k0,
                                        bool has_seg, bool keep_p) {
  const int tid = threadIdx.x;
  const int cg = tid % 16, r0 = (tid / 16) * 4;
  float sc[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 8
  for (int h = 0; h < HD; ++h) {
    const float k0v = t.Ks[cg * (HD + 1) + h];
    const float k1v = t.Ks[(cg + 16) * (HD + 1) + h];
    const float v0v = t.Vs[cg * (HD + 1) + h];
    const float v1v = t.Vs[(cg + 16) * (HD + 1) + h];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qv = t.Qs[(r0 + i) * (HD + 1) + h];
      const float dv = t.dOs[(r0 + i) * (HD + 1) + h];
      sc[i][0] = fmaf(qv, k0v, sc[i][0]);
      sc[i][1] = fmaf(qv, k1v, sc[i][1]);
      dp[i][0] = fmaf(dv, v0v, dp[i][0]);
      dp[i][1] = fmaf(dv, v1v, dp[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    const int qi = q0 + r;
    const int qpos = qi + a.q_offset;
    const float lse = t.lse_s[r], delta = t.delta_s[r];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cl = cg + 16 * j;
      const int c = k0 + cl;
      const float s = sc[i][j];
      float z = s, th = 0.f;
      if (a.softcap > 0.f) {
        th = tanhf(s / a.softcap);
        z = a.softcap * th;
      }
      bool keep = c < a.Skv && qi < a.Sq;
      if (a.causal) {
        const int d = a.qpos != nullptr ? t.qpos_s[r] - t.kpos_s[cl] : qpos - c;
        keep = keep && d >= 0;
        if (a.window > 0) keep = keep && d < a.window;
      }
      if (has_seg) keep = keep && t.qseg_s[r] == t.kseg_s[cl];
      const float p = expf(keep ? z - lse : NEG_INF);
      const float dz = p * (dp[i][j] - delta);
      const float ds = a.softcap > 0.f ? dz * (1.f - th * th) : dz;
      t.Ss[r * (BK + 1) + cl] = ds;
      if (keep_p) t.Ps[r * (BK + 1) + cl] = p;
    }
  }
}

// K7: one block per (q tile, q head, batch), looping over kv tiles.
template <int HD>
__global__ void __launch_bounds__(NT) flash_dq_kernel(PosArgs a) {
  constexpr int HC = HD / 16;  // dq columns per thread
  extern __shared__ float smem[];
  Tile<HD> t(smem, (a.Skv + BK - 1) / BK);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (a.N / a.K);
  const int cg = tid % 16, r0 = (tid / 16) * 4;
  const bool has_seg = a.qseg != nullptr;
  const bool skip_pad = has_seg && a.seg_pad_zero;

  load_q<HD>(a, t, b, n, q0);
  load_rows<HD>(a, t, b, n, q0, has_seg);
  const int q_live = __syncthreads_or(tid < BQ && t.qseg_s[tid] > 0);

  // kv tile range, as K3's.
  const int n_kt = (a.Skv + BK - 1) / BK;
  int kt_end = n_kt;
  if (a.causal) {
    const int qmax = q0 + BQ - 1 + a.q_offset;
    kt_end = qmax < 0 ? 0 : min(n_kt, qmax / BK + 1);
  }
  int kt_begin = 0;
  if (a.causal && a.window > 0) {
    const int cmin = q0 + a.q_offset - a.window + 1;
    kt_begin = cmin > 0 ? cmin / BK : 0;
  }
  int n_iter = max(kt_end - kt_begin, 0);
  const bool has_pos = a.qpos != nullptr;
  if (has_pos) {
    // The tile's live key steps from the positions, as K3's (flash_tc.cuh).
    const ftc::Mask m{a.Sq, a.Skv, a.causal, 0, a.window, has_seg, false, a.qpos, a.kpos};
    n_iter = ftc::live_steps(m, a.kseg, b, q0, BQ, true, t.list, t.red);
  }

  float acc[4][HC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (has_pos ? t.list[it] : kt_begin + it) * BK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ss/kseg_s are done
    load_kv<HD>(a, t, b, kvh, k0, has_seg);
    const int kv_live = __syncthreads_or(tid < BK && t.kseg_s[tid] > 0);
    if (skip_pad && !(kv_live && q_live)) continue;  // uniform over the block
    tile_ds<HD>(a, t, q0, k0, has_seg, false);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = t.Ss[(r0 + i) * (BK + 1) + c];
#pragma unroll
      for (int hc = 0; hc < HC; ++hc) {
        const float kk = t.Ks[c * (HD + 1) + cg + 16 * hc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][hc] = fmaf(d[i], kk, acc[i][hc]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + r0 + i;
    if (s >= a.Sq) continue;
    float* row = dq + ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD;
#pragma unroll
    for (int hc = 0; hc < HC; ++hc) row[cg + 16 * hc] = acc[i][hc] * a.scale;
  }
}

// K8, float32: one block per (kv tile, kv head, batch), looping over the
// group's query heads and the q tiles, on the CUDA cores (see the note at
// the top of the file).
template <int HD>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(PosArgs a) {
  constexpr int HC = HD / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  Tile<HD> t(smem, (a.Sq + BQ - 1) / BQ);
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.N / a.K;
  const int cg = tid % 16, kr0 = (tid / 16) * 2;  // kv rows kr0, kr0+1 of the tile
  const bool has_seg = a.qseg != nullptr;
  const bool skip_pad = has_seg && a.seg_pad_zero;

  load_kv<HD>(a, t, b, kvh, k0, has_seg);
  const int kv_live = __syncthreads_or(tid < BK && t.kseg_s[tid] > 0);

  // q tile range. Causal: K3 runs tile (q0, k0) iff k0 <= q0 + BQ - 1 +
  // q_offset, so q tiles wholly before the kv tile skip. Window: iff
  // k0 + BK - 1 > q0 + q_offset - window, so q tiles wholly past the
  // window's reach skip.
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = n_qt;
  if (a.causal) {
    const int lo = k0 - a.q_offset - BQ + 1;
    qt_begin = lo > 0 ? min(n_qt, (lo + BQ - 1) / BQ) : 0;
    if (a.window > 0) {
      const int hi = k0 + BK - 1 - a.q_offset + a.window;  // q0 < hi
      qt_end = hi <= 0 ? 0 : min(n_qt, (hi + BQ - 1) / BQ);
    }
  }
  if (skip_pad && !kv_live) qt_end = qt_begin;  // an all-padding kv tile
  int n_it = max(qt_end - qt_begin, 0);
  const bool has_pos = a.qpos != nullptr;
  if (has_pos) {
    // The q tiles that can reach this kv tile, from the positions
    // (flash_tc.cuh live_qtiles).
    const ftc::Mask m{a.Sq, a.Skv, a.causal, 0, a.window, has_seg, false, a.qpos, a.kpos};
    int kmin, kmax;
    n_it = ftc::live_qtiles(m, b, k0, BK, BQ, t.list, t.red, t.facts, kmin, kmax);
  }

  float dk[2][HC], dv[2][HC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int n = kvh * G + g;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (has_pos ? t.list[it] : qt_begin + it) * BQ;
      __syncthreads();  // the previous tile's reads of Qs/dOs/Ps/Ss/row data are done
      load_rows<HD>(a, t, b, n, q0, has_seg);
      const int q_live = __syncthreads_or(tid < BQ && t.qseg_s[tid] > 0);
      if (skip_pad && !q_live) continue;  // uniform over the block
      load_q<HD>(a, t, b, n, q0);
      __syncthreads();
      tile_ds<HD>(a, t, q0, k0, has_seg, true);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float p0 = t.Ps[r * (BK + 1) + kr0];
        const float p1 = t.Ps[r * (BK + 1) + kr0 + 1];
        const float s0 = t.Ss[r * (BK + 1) + kr0];
        const float s1 = t.Ss[r * (BK + 1) + kr0 + 1];
#pragma unroll
        for (int hc = 0; hc < HC; ++hc) {
          const float dov = t.dOs[r * (HD + 1) + cg + 16 * hc];
          const float qv = t.Qs[r * (HD + 1) + cg + 16 * hc];  // includes scale
          dv[0][hc] = fmaf(p0, dov, dv[0][hc]);
          dv[1][hc] = fmaf(p1, dov, dv[1][hc]);
          dk[0][hc] = fmaf(s0, qv, dk[0][hc]);
          dk[1][hc] = fmaf(s1, qv, dk[1][hc]);
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + kr0 + i;
    if (c >= a.Skv) continue;
    const int64_t base = ((static_cast<int64_t>(b) * a.Skv + c) * a.K + kvh) * HD;
#pragma unroll
    for (int hc = 0; hc < HC; ++hc) {
      dkp[base + cg + 16 * hc] = dk[i][hc];
      dvp[base + cg + 16 * hc] = dv[i][hc];
    }
  }
}

// ---------------------------------------------------------------------------
// K8, bfloat16: the same function on the tensor cores (see the note at the
// top of the file). One block of 8 warps per (kv tile of TK = 64 keys, kv
// head, batch); TQ = 64 query rows per step of the loop over (query head of
// the group, q tile).
namespace tcdkv {

constexpr int TK = 64;
constexpr int TQ = 64;
constexpr int LDP = TQ + 8;  // row stride of the P^T / dS^T tiles (bf16)

// Buffers of the q/dO tiles and blocks per SM: one buffer and two blocks
// (at most 128 registers a thread) up to H = 128, where the other block
// hides a block's loads; two buffers and one block at H = 256.
template <int HD> __host__ __device__ constexpr int stages() { return HD <= 128 ? 1 : 2; }
template <int HD> __host__ __device__ constexpr int min_blocks() { return HD <= 128 ? 2 : 1; }

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;  // row stride of the K/V/Q/dO tiles (bf16)
  // Buffer st of the q/dO tiles is base + st * its size: plain pointer
  // arithmetic, so no array of pointers is indexed at run time.
  __nv_bfloat16* k;       // [TK][LD]
  __nv_bfloat16* v;       // [TK][LD]
  __nv_bfloat16* q_;      // [ST][TQ][LD]
  __nv_bfloat16* dout_;   // [ST][TQ][LD]
  __nv_bfloat16* pt;      // [TK][LDP] P^T of the step
  __nv_bfloat16* dst;     // [TK][LDP] dS^T of the step
  float* lse_;            // [ST][TQ]
  float* delta_;          // [ST][TQ]
  int* qseg_;             // [ST][TQ]

  static constexpr int ST = stages<HD>();
  __host__ __device__ static constexpr size_t bytes() {
    return sizeof(__nv_bfloat16) * (2 * TK * LD + 2 * ST * TQ * LD + 2 * TK * LDP) +
           sizeof(float) * 2 * ST * TQ + sizeof(int) * ST * TQ;
  }

  __device__ explicit Smem(unsigned char* base) {
    k = reinterpret_cast<__nv_bfloat16*>(base);
    v = k + TK * LD;
    q_ = v + TK * LD;
    dout_ = q_ + ST * TQ * LD;
    pt = dout_ + ST * TQ * LD;
    dst = pt + TK * LDP;
    lse_ = reinterpret_cast<float*>(dst + TK * LDP);
    delta_ = lse_ + ST * TQ;
    qseg_ = reinterpret_cast<int*>(delta_ + ST * TQ);
  }
  __device__ __nv_bfloat16* q(int st) const { return q_ + st * TQ * LD; }
  __device__ __nv_bfloat16* dout(int st) const { return dout_ + st * TQ * LD; }
  __device__ float* lse(int st) const { return lse_ + st * TQ; }
  __device__ float* delta(int st) const { return delta_ + st * TQ; }
  __device__ int* qseg(int st) const { return qseg_ + st * TQ; }
};

// Asynchronous copies of q tile q0 of head n (q, dO, lse, delta, segment
// ids and, into `qpos` when not null, positions) into stage st; rows past
// Sq are zero-filled.
template <int HD, typename A>
__device__ __forceinline__ void load_q_async(const A& a, Smem<HD>& sm, int st, int b, int n,
                                             int q0, bool has_seg, const int* qpos_src = nullptr,
                                             int* qpos = nullptr) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
  for (int i = threadIdx.x; i < TQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    const bool in = s < a.Sq;
    const int64_t g = in ? ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + c : 0;
    tc::cp16(sm.q(st) + r * Smem<HD>::LD + c, q + g, in);
    tc::cp16(sm.dout(st) + r * Smem<HD>::LD + c, dout + g, in);
  }
  const int tid = threadIdx.x;
  if (tid < 3 * TQ) {
    const int r = tid % TQ, s = q0 + r, which = tid / TQ;
    const bool in = s < a.Sq;
    const int64_t row = in ? (static_cast<int64_t>(b) * a.N + n) * a.Sq + s : 0;
    if (which == 0) tc::cp4(sm.lse(st) + r, a.lse + row, in);
    if (which == 1) tc::cp4(sm.delta(st) + r, a.delta + row, in);
    if (which == 2) {
      const bool sin = in && has_seg;
      const void* src = sin ? static_cast<const void*>(a.qseg + static_cast<int64_t>(b) * a.Sq + s)
                            : static_cast<const void*>(a.lse);
      tc::cp4(sm.qseg(st) + r, src, sin);
    }
  } else if (qpos != nullptr && tid < 4 * TQ) {
    const int r = tid - 3 * TQ, s = q0 + r;
    const bool in = s < a.Sq;
    const void* src = in ? static_cast<const void*>(qpos_src + static_cast<int64_t>(b) * a.Sq + s)
                         : static_cast<const void*>(qpos_src);
    tc::cp4(qpos + r, src, in);
  }
}

// Under seg_pad_zero K3 skips a q tile whose rows are all padding: so does
// K8. Uniform over the block (a barrier).
template <typename A>
__device__ __forceinline__ bool q_live(const A& a, int b, int qt, bool skip_pad) {
  if (!skip_pad) return true;
  const int tid = threadIdx.x, s = qt * TQ + tid;
  const bool p = tid < TQ && s < a.Sq && a.qseg[static_cast<int64_t>(b) * a.Sq + s] > 0;
  return __syncthreads_or(p);
}

// The next live step after (g, qt); g == G when none is left.
template <typename A>
__device__ __forceinline__ void advance(const A& a, int b, int& g, int& qt, int qt_begin,
                                        int qt_end, int G, bool skip_pad) {
  do {
    if (++qt >= qt_end) {
      qt = qt_begin;
      ++g;
    }
  } while (g < G && !q_live(a, b, qt, skip_pad));
}

// Explicit positions (POS, K8-pos): the block lists the q tiles that can
// reach its keys (flash_tc.cuh live_qtiles) and walks them over the group's
// heads; the mask compares the pair's positions, and a step needs none when
// every key precedes every query within the window (from the keys' and the
// tile's extremes). Its shared memory adds, after Smem, the stages' q
// positions [ST][TQ], four reduction ints, the tile list [n_qt] and each
// tile's q extremes [n_qt][2] (pos_bytes).
template <int HD>
constexpr size_t pos_bytes(int n_qt) {
  return sizeof(int) * (Smem<HD>::ST * TQ + 4 + 3 * n_qt);
}

template <int HD, bool POS>
__global__ void __launch_bounds__(NT, min_blocks<HD>())
    flash_dkv_tc_kernel(std::conditional_t<POS, PosArgs, Args> a) {
  using S = Smem<HD>;
  constexpr int LD = S::LD;
  constexpr int NB = HD / 16;  // 8-column blocks of dk/dv per warp (half of H)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S sm(smem_raw);
  int* qpos_st = reinterpret_cast<int*>(smem_raw + S::bytes());  // [ST][TQ] (POS)
  int* red = qpos_st + S::ST * TQ;                               // [4]
  int* tiles = red + 4;                                          // [n_qt]
  int* qfacts = tiles + (a.Sq + TQ - 1) / TQ;                    // [n_qt][2]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * TK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.N / a.K;
  const bool has_seg = a.qseg != nullptr;
  const bool skip_pad = has_seg && a.seg_pad_zero;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v);

  // The block's K and V rows stay resident for the whole loop.
  for (int i = tid; i < TK * (HD / 8); i += NT) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, s = k0 + r;
    const bool in = s < a.Skv;
    const int64_t g = in ? ((static_cast<int64_t>(b) * a.Skv + s) * a.K + kvh) * HD + c : 0;
    tc::cp16(sm.k + r * LD + c, kg + g, in);
    tc::cp16(sm.v + r * LD + c, vg + g, in);
  }

  // Segment ids of this thread's two kv rows in phase 1, and which of K3's
  // 32-key sub-tiles hold a live (non-padding) key.
  const int wr = warp & 3;  // kv rows wr*16 .. wr*16+15 in both phases
  int kseg_r[2] = {0, 0}, kpos_r[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = k0 + wr * 16 + grp + 8 * h;
    if (has_seg) kseg_r[h] = c < a.Skv ? a.kseg[static_cast<int64_t>(b) * a.Skv + c] : 0;
    if constexpr (POS) kpos_r[h] = c < a.Skv ? a.kpos[static_cast<int64_t>(b) * a.Skv + c] : 0;
  }
  int ks_own = 0;
  if (has_seg && tid < TK && k0 + tid < a.Skv)
    ks_own = a.kseg[static_cast<int64_t>(b) * a.Skv + k0 + tid];
  const bool live0 = __syncthreads_or(tid < TK / 2 && ks_own > 0);
  const bool live1 = __syncthreads_or(tid >= TK / 2 && tid < TK && ks_own > 0);

  // q tile range, as K3 visits it: causal tiles wholly before the kv tile
  // and window tiles wholly past its reach are skipped (see flash_dkv_kernel).
  const int n_qt = (a.Sq + TQ - 1) / TQ;
  int qt_begin = 0, qt_end = n_qt;
  if (a.causal) {
    const int lo = k0 - a.q_offset - TQ + 1;
    qt_begin = lo > 0 ? min(n_qt, (lo + TQ - 1) / TQ) : 0;
    if (a.window > 0) {
      const int hi = k0 + TK - 1 - a.q_offset + a.window;  // q0 < hi
      qt_end = hi <= 0 ? 0 : min(n_qt, (hi + TQ - 1) / TQ);
    }
  }
  if (skip_pad && !(live0 || live1)) qt_end = qt_begin;  // an all-padding kv tile

  // Steps run over (g, qt), qt fastest, skipping what K3 skipped; with
  // positions over (g, i), qt = tiles[i].
  int g = 0, qt = qt_begin, li = 0, n_live = 0, kmin = 0, kmax = 0;
  const int* qpos_src = nullptr;
  if constexpr (POS) {
    qpos_src = a.qpos;
    const ftc::Mask m{a.Sq, a.Skv, a.causal, 0, a.window, has_seg, false, a.qpos, a.kpos};
    n_live = ftc::live_qtiles(m, b, k0, TK, TQ, tiles, red, qfacts, kmin, kmax);
    if (n_live == 0) g = G;
    else qt = tiles[0];
  } else {
    if (qt_begin >= qt_end) g = G;
    else if (!q_live(a, b, qt, skip_pad)) advance(a, b, g, qt, qt_begin, qt_end, G, skip_pad);
  }
  if (g < G)
    load_q_async<HD>(a, sm, 0, b, kvh * G + g, qt * TQ, has_seg, qpos_src,
                     POS ? qpos_st : nullptr);
  tc::cp_commit();

  float dk[NB][4], dv[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  int st = 0;
  while (g < G) {
    int ng = g, nqt = qt, nli = li;
    if constexpr (POS) {
      if (++nli >= n_live) {
        nli = 0;
        ++ng;
      }
      nqt = tiles[nli];
    } else {
      advance(a, b, ng, nqt, qt_begin, qt_end, G, skip_pad);
    }
    tc::cp_wait_all();
    __syncthreads();  // stage st landed; the previous step's reads are done
    if (S::ST == 2 && ng < G)
      load_q_async<HD>(a, sm, st ^ 1, b, kvh * G + ng, nqt * TQ, has_seg, qpos_src,
                       POS ? qpos_st + (st ^ 1) * TQ : nullptr);
    tc::cp_commit();
    const int q0 = qt * TQ;

    // Phase 1: S^T = K . Q^T and dP^T = V . dO^T for kv rows wr*16.. and
    // queries wc*32.., then P^T and dS^T (f32) into shared memory as bf16.
    {
      const int wc = warp >> 2;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t ka[4], va[4];
        tc::load_a(ka, sm.k, LD, wr * 16, kk, lane);
        tc::load_a(va, sm.v, LD, wr * 16, kk, lane);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t qb[4], ob[4];
          tc::load_b_nk(qb, sm.q(st), LD, wc * 32 + jp * 16, kk, lane);
          tc::load_b_nk(ob, sm.dout(st), LD, wc * 32 + jp * 16, kk, lane);
          tc::mma(s[2 * jp], ka, qb[0], qb[1]);
          tc::mma(s[2 * jp + 1], ka, qb[2], qb[3]);
          tc::mma(dp[2 * jp], va, ob[0], ob[1]);
          tc::mma(dp[2 * jp + 1], va, ob[2], ob[3]);
        }
      }
      // The step's lse and delta of this thread's 8 query columns.
      float lse_c[4][2], delta_c[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lse_c[j][e] = sm.lse(st)[wc * 32 + j * 8 + 2 * tig + e];
          delta_c[j][e] = sm.delta(st)[wc * 32 + j * 8 + 2 * tig + e];
        }
      // Whether every pair of the tile is kept (no mask to apply): no
      // segments, in range, and (causal) wholly inside the diagonal and the
      // window (with positions: every key at or before every query, the
      // greatest distance inside the window).
      bool inside;
      if constexpr (POS) {
        const int64_t qmin = qfacts[2 * qt], qmax = qfacts[2 * qt + 1];
        inside = kmax <= qmin && (a.window <= 0 || qmax - kmin < a.window);
      } else {
        inside = q0 + a.q_offset >= k0 + TK - 1 &&
                 (a.window <= 0 || q0 + TQ - 1 + a.q_offset - k0 < a.window);
      }
      const bool full = !has_seg && k0 + TK <= a.Skv && q0 + TQ <= a.Sq && (!a.causal || inside);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // kv row grp (h = 0) or grp + 8
          const int lr = wr * 16 + grp + 8 * h;
          const int c = k0 + lr;
          // A pair is counted only where K3 ran its 64x32 tile.
          const bool sub_live = !skip_pad || (lr < TK / 2 ? live0 : live1);
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lc = wc * 32 + j * 8 + 2 * tig + e;
            const int qi = q0 + lc;
            const float sv = s[j][2 * h + e] * a.scale;
            float z = sv, th = 0.f;
            if (a.softcap > 0.f) {
              th = tanhf(sv / a.softcap);
              z = a.softcap * th;
            }
            bool keep = full;
            if (!full) {
              keep = sub_live && c < a.Skv && qi < a.Sq;
              if (a.causal) {
                const int d = POS ? qpos_st[st * TQ + lc] - kpos_r[h] : qi + a.q_offset - c;
                keep = keep && d >= 0;
                if (a.window > 0) keep = keep && d < a.window;
              }
              if (has_seg) keep = keep && sm.qseg(st)[lc] == kseg_r[h];
            }
            // The mask inside the exponential: lse may be NEG_INF.
            const float p = tc::exp_(keep ? z - lse_c[j][e] : NEG_INF);
            const float dz = p * (dp[j][2 * h + e] - delta_c[j][e]);
            pv[e] = p;
            dsv[e] = a.softcap > 0.f ? dz * (1.f - th * th) : dz;
          }
          const int lc0 = wc * 32 + j * 8 + 2 * tig;
          *reinterpret_cast<uint32_t*>(sm.pt + lr * LDP + lc0) = tc::pack_bf16(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(sm.dst + lr * LDP + lc0) = tc::pack_bf16(dsv[0], dsv[1]);
        }
      }
    }
    __syncthreads();

    // Phase 2: dV += P^T . dO and dK += dS^T . Q for kv rows wr*16.. and
    // head columns wh*H/2 ..
    {
      const int h0 = (warp >> 2) * (HD / 2);
#pragma unroll
      for (int kk = 0; kk < TQ; kk += 16) {
        uint32_t pa[4], sa[4];
        tc::load_a(pa, sm.pt, LDP, wr * 16, kk, lane);
        tc::load_a(sa, sm.dst, LDP, wr * 16, kk, lane);
        if constexpr (NB == 1) {
          uint32_t ob[2], qb[2];
          tc::load_b_kn8(ob, sm.dout(st), LD, kk, h0, lane);
          tc::load_b_kn8(qb, sm.q(st), LD, kk, h0, lane);
          tc::mma(dv[0], pa, ob[0], ob[1]);
          tc::mma(dk[0], sa, qb[0], qb[1]);
        } else {
#pragma unroll
          for (int jp = 0; jp < NB / 2; ++jp) {
            uint32_t ob[4], qb[4];
            tc::load_b_kn(ob, sm.dout(st), LD, kk, h0 + jp * 16, lane);
            tc::load_b_kn(qb, sm.q(st), LD, kk, h0 + jp * 16, lane);
            tc::mma(dv[2 * jp], pa, ob[0], ob[1]);
            tc::mma(dv[2 * jp + 1], pa, ob[2], ob[3]);
            tc::mma(dk[2 * jp], sa, qb[0], qb[1]);
            tc::mma(dk[2 * jp + 1], sa, qb[2], qb[3]);
          }
        }
      }
    }
    if (S::ST == 1) {  // one buffer: the next tile loads once this one is read
      __syncthreads();
      if (ng < G) load_q_async<HD>(a, sm, 0, b, kvh * G + ng, nqt * TQ, has_seg, qpos_src,
                                   POS ? qpos_st : nullptr);
      tc::cp_commit();
    }
    g = ng;
    qt = nqt;
    li = nli;
    st = (st + 1) % S::ST;
  }
  tc::cp_wait_all();

  // dk = scale * sum dS^T . q (q was not pre-scaled); one thread per element.
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv);
  const int h0 = (warp >> 2) * (HD / 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = k0 + wr * 16 + grp + 8 * h;
    if (c >= a.Skv) continue;
    const int64_t base = ((static_cast<int64_t>(b) * a.Skv + c) * a.K + kvh) * HD;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = h0 + j * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(dkp + base + col) =
          tc::pack_bf16(dk[j][2 * h] * a.scale, dk[j][2 * h + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + base + col) = tc::pack_bf16(dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

}  // namespace tcdkv


// ---------------------------------------------------------------------------
// K7, bfloat16: dq on the tensor cores (see the note at the top of the file
// and flash_tc.cuh). One block of 8 warps per (q tile of 128 rows, q head,
// batch), a warp per 16 rows, key steps of 32 keys.
namespace tcdq {

using ftc::KB;
using ftc::ROWS;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * ROWS + 2 * 2 * KB) * (HD + 8) + sizeof(int) * 2 * KB;
}

// Explicit positions (K7-pos) add the keys' positions ring, the warps'
// facts, and the step list (one int a key step: at 262144 keys the list
// takes 32 KB, so the block still fits beside Q, dO and the ring).
constexpr size_t pos_bytes(int n_kt) {
  return sizeof(int) * (2 * KB + 4 + n_kt) + sizeof(ftc::WarpFacts) * (ftc::NT / 32);
}

// The facts classify_pos reads for a staged step (its least and greatest
// kv position and its one key segment id, or -1), as live_steps keeps
// them, from the ring by the warp: kp and ks hold the step's KB keys (ks 0
// past Skv).
__device__ __forceinline__ void step_facts(const ftc::Mask& m, int k0, const int* kp,
                                           const int* ks, int (&f)[3]) {
  const int lane = threadIdx.x % 32;
  const bool in = k0 + lane < m.Skv;
  f[0] = __reduce_min_sync(ftc::FULL, in ? kp[lane] : ftc::POS_MAX);
  f[1] = __reduce_max_sync(ftc::FULL, in ? kp[lane] : ftc::POS_MIN);
  const int sg = m.has_seg ? ks[lane] : 0;
  const int smin = __reduce_min_sync(ftc::FULL, sg), smax = __reduce_max_sync(ftc::FULL, sg);
  f[2] = smin == smax ? smin : -1;
}

// The mask of the index path, and of the positions path (which takes
// neither q_offset nor seg_pad_zero).
__device__ __forceinline__ ftc::Mask mask_of(const Args& a) {
  return ftc::Mask{a.Sq, a.Skv, a.causal, a.q_offset, a.window, a.qseg != nullptr,
                   a.qseg != nullptr && a.seg_pad_zero != 0};
}

__device__ __forceinline__ ftc::Mask mask_of(const PosArgs& a) {
  return ftc::Mask{a.Sq, a.Skv, a.causal, 0, a.window, a.qseg != nullptr, false, a.qpos, a.kpos};
}

// The query of the thread's row h (grp and grp + 8 of the warp's 16).
__device__ __forceinline__ int query(const ftc::Rows& r, int grp, int h) {
  return r.r0 + grp + 8 * h;
}

__device__ __forceinline__ int query(const ftc::PackRows& r, int, int h) { return r.qi[h]; }

// POS (K7-pos) is the same block with explicit positions. The block lists
// the key steps its 128 queries may attend (flash_tc.cuh live_steps,
// K3-pos's list) and walks those; each warp classifies a step from its own
// q extremes and the step's (classify_pos, the rows as PackRows of one
// head), and the mask compares the pair's positions. The step's facts come
// from warp reductions over the staged keys (step_facts): kept in shared
// memory as K3-pos keeps them, a long row's (262144 keys) would take 128 KB
// beside Q, dO and the ring. The index path takes Args, not PosArgs (see
// PosArgs), and compiles to the same SASS as when it was a kernel of its
// own; a step's first key is written out at each use because a lambda for
// it moved ptxas's schedule of that path (1.5 % slower, PERF.md §6).
template <int HD, bool POS>
__global__ void __launch_bounds__(ftc::NT, ftc::min_blocks<HD>())
    flash_dq_tc_kernel(std::conditional_t<POS, PosArgs, Args> a) {
  constexpr int LD = HD + 8;
  constexpr int NH = HD / 8;  // 8-column blocks of dq per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][LD]
  __nv_bfloat16* dos = qs + ROWS * LD;                              // [ROWS][LD]
  __nv_bfloat16* ring = dos + ROWS * LD;             // [2][K [KB][LD], V [KB][LD]]
  int* kseg_ring = reinterpret_cast<int*>(ring + 2 * 2 * KB * LD);  // [2][KB]
  int* kpos_ring = kseg_ring + 2 * KB;                              // [2][KB] (POS)
  ftc::WarpFacts* wf = reinterpret_cast<ftc::WarpFacts*>(kpos_ring + 2 * KB);  // [8]
  int* red = reinterpret_cast<int*>(wf + ftc::NT / 32);             // [4]
  int* steps = red + 4;                                             // [n_kt]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const ftc::Mask m = mask_of(a);
  const int n = blockIdx.x, b = blockIdx.y;
  const int q0 = ftc::q_tile<false>(m) * ROWS;
  const int kvh = n / (a.N / a.K);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  // The key steps: [kt_begin, kt_begin + n_steps), or POS's list.
  std::conditional_t<POS, ftc::PackRows, ftc::Rows> rows;
  int kt_begin = 0, n_steps;
  if constexpr (POS) {
    const bool any = ftc::load_packed_rows(m, a.qseg, b, q0, ROWS, 1, rows, wf);
    n_steps = any ? ftc::live_steps(m, a.kseg, b, q0, ROWS, true, steps, red) : 0;
  } else {
    const bool any_live = ftc::load_rows(m, a.qseg, b, q0, rows);
    int kt_end;
    ftc::step_range(m, q0, kt_begin, kt_end);
    if (!any_live) kt_end = kt_begin;  // every row padding: zeros out
    n_steps = kt_end - kt_begin;
  }

  // The rows' lse and delta stay in registers; rows past Sq get lse =
  // NEG_INF and are masked.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = query(rows, grp, h);
    const int64_t row = (static_cast<int64_t>(b) * a.N + n) * a.Sq + qi;
    lse_r[h] = qi < a.Sq ? a.lse[row] : NEG_INF;
    delta_r[h] = qi < a.Sq ? a.delta[row] : 0.f;
  }

  if (n_steps > 0) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
    for (int idx = tid; idx < ROWS * (HD / 8); idx += ftc::NT) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, s = q0 + r;
      const bool in = s < a.Sq;
      const int64_t off = in ? ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + c : 0;
      tc::cp16(qs + r * LD + c, q + off, in);
      tc::cp16(dos + r * LD + c, dout + off, in);
    }
    ftc::load_step<HD>(m, k, v, a.kseg, b, kvh, a.K, (POS ? steps[0] : kt_begin) * KB, ring,
                       kseg_ring, POS ? kpos_ring : nullptr);
    tc::cp_commit();
  }

  float dq[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    tc::cp_wait_all();
    __syncthreads();  // step i staged; every read of the previous step done
    if (i + 1 < n_steps)
      ftc::load_step<HD>(m, k, v, a.kseg, b, kvh, a.K,
                         (POS ? steps[i + 1] : kt_begin + i + 1) * KB,
                         ring + (st ^ 1) * 2 * KB * LD, kseg_ring + (st ^ 1) * KB,
                         POS ? kpos_ring + (st ^ 1) * KB : nullptr);
    tc::cp_commit();
    const __nv_bfloat16* kt = ring + st * 2 * KB * LD;
    const __nv_bfloat16* vt = kt + KB * LD;
    const int* ks = kseg_ring + st * KB;
    const int* kp = kpos_ring + st * KB;
    const int k0 = (POS ? steps[i] : kt_begin + i) * KB;
    ftc::Step step;
    if constexpr (POS) {
      int f[3];
      step_facts(m, k0, kp, ks, f);
      step = ftc::classify_pos(m, wf[warp], k0, f);
    } else {
      step = ftc::classify(m, rows, k0, ks);
    }
    if (step.dead) continue;  // uniform over the warp

    // S = Q . K^T and dP = dO . V^T for the warp's 16 rows x 32 keys.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4], oa[4];
      tc::load_a(qa, qs, LD, warp * 16, kk, lane);
      tc::load_a(oa, dos, LD, warp * 16, kk, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t kb4[4], vb4[4];
        tc::load_b_nk(kb4, kt, LD, jp * 16, kk, lane);
        tc::load_b_nk(vb4, vt, LD, jp * 16, kk, lane);
        tc::mma(s[2 * jp], qa, kb4[0], kb4[1]);
        tc::mma(s[2 * jp + 1], qa, kb4[2], kb4[3]);
        tc::mma(dp[2 * jp], oa, vb4[0], vb4[1]);
        tc::mma(dp[2 * jp + 1], oa, vb4[2], vb4[3]);
      }
    }

    // dS = P * (dP - delta) (times 1 - t^2 under softcap) in f32, into s;
    // the mask inside the exponential (lse may be NEG_INF).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int h = e4 >> 1;
        const float sv = s[j][e4] * a.scale;
        float z = sv, th = 0.f;
        if (a.softcap > 0.f) {
          th = tanhf(sv / a.softcap);
          z = a.softcap * th;
        }
        bool kept = true;
        if (!step.full) {
          const int cl = j * 8 + 2 * tig + (e4 & 1);
          if constexpr (POS)
            kept = ftc::keep(m, rows.qi[h], rows.qseg[h], k0 + cl, ks[cl], rows.qp[h], kp[cl]);
          else
            kept = ftc::keep(m, rows.r0 + grp + 8 * h, rows.qseg[h], k0 + cl, ks[cl]);
        }
        const float p = tc::exp_(kept ? z - lse_r[h] : NEG_INF);
        const float dz = p * (dp[j][e4] - delta_r[h]);
        s[j][e4] = a.softcap > 0.f ? dz * (1.f - th * th) : dz;
      }
    }

    // dQ += dS . K, dS from the registers as bf16 A fragments, K read as a
    // [keys][H] B operand (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t da[4];
      da[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < NH / 2; ++jp) {
        uint32_t kb4[4];
        tc::load_b_kn(kb4, kt, LD, kk * 16, jp * 16, lane);
        tc::mma(dq[2 * jp], da, kb4[0], kb4[1]);
        tc::mma(dq[2 * jp + 1], da, kb4[2], kb4[3]);
      }
    }
  }
  tc::cp_wait_all();

  // dq = scale * sum dS . k (q was not pre-scaled); one thread per element.
  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = query(rows, grp, h);
    if (qi >= a.Sq) continue;
    const int64_t row = (static_cast<int64_t>(b) * a.Sq + qi) * a.N + n;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      *reinterpret_cast<uint32_t*>(dqp + row * HD + j * 8 + 2 * tig) =
          tc::pack_bf16(dq[j][2 * h] * a.scale, dq[j][2 * h + 1] * a.scale);
    }
  }
}

}  // namespace tcdq


// ---------------------------------------------------------------------------
// K7-pos and K8-pos in bfloat16 at head_dim 64 and 128: warp-specialised
// kernels on wgmma and TMA (see the note at the top of the file and
// ops/flash_pos_bwd.py, which writes the plan out in PyTorch). A block is
// three warpgroups: 0 and 1 consume (wgmma), one tile of 64 rows or keys
// each; in warpgroup 2 one warp produces (TMA from one thread, cp.async
// from the warp, into a ring of stages each guarded by a full and an empty
// mbarrier).
namespace wg {

constexpr int T = 64;           // rows or keys of a tile: one consumer warpgroup's
constexpr int ROWS = 2 * T;     // query rows (K7) or keys (K8) of a block
constexpr int NTHREADS = 384;
constexpr int CONSUMER_REGS = 240;
constexpr int DQ_STAGES = 3;   // K, V ring of K7-pos
constexpr int DKV_STAGES = 2;  // Q, dO ring of K8-pos (3 and 4 measured no faster)
constexpr int CONSUMER_WARPS = 8;
constexpr int DEAD = 0, MASKED = 1, FULL = 2;
constexpr int PLAN_THREADS = 512;

struct Facts {
  int lo, hi, slo, shi;  // least / greatest position and segment id of a tile
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// What both kernels take: the tensor maps of q, dO, k and v (passed by
// value, so they live in the kernel's parameter space, where TMA reads
// them), the row arrays and the plan pass's scratch.
struct WgArgs {
  CUtensorMap q, dout, k, v;      // bf16 [B, S, heads, H]; boxes of 64 columns
  const float* lse;               // [B, N, Sq]
  const float* delta;
  const int* qpos;                // [B, Sq]
  const int* kpos;                // [B, Skv]
  const int* qseg;                // [B, Sq] or null
  const int* kseg;
  void* dq;                       // bf16 [B, Sq, N, H]
  void* dk;                       // bf16 [B, Skv, K, H]
  void* dv;
  int* plan;                      // the plan pass's scratch (plan_scratch_ints)
  int B, Sq, Skv, N, K, causal, window, has_seg;
  float softcap, scale;
};

// The plan's scratch, int32: q tiles' facts [B][n_qt][4], kv tiles'
// [B][n_kt][4], then one block order [B][n_order].
struct PlanLayout {
  int n_qt, n_kt, n_order;
  __host__ __device__ PlanLayout(int Sq, int Skv)
      : n_qt(cdiv(Sq, T)), n_kt(cdiv(Skv, T)),
        n_order(cdiv(Sq, ROWS) > cdiv(Skv, ROWS) ? cdiv(Sq, ROWS) : cdiv(Skv, ROWS)) {}
  __host__ __device__ int64_t kf(int B) const { return static_cast<int64_t>(B) * n_qt * 4; }
  __host__ __device__ int64_t order(int B) const {
    return kf(B) + static_cast<int64_t>(B) * n_kt * 4;
  }
};

// L2-coherent: the plan pass reads back facts it wrote itself.
__device__ __forceinline__ Facts load_facts(const int* f, int64_t i) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(f + 4 * i));
  return Facts{v.x, v.y, v.z, v.w};
}

// The class of the pair (q tile with facts q, kv tile with facts k):
// whole = every entry of the tile lies inside its sequence. As
// ops/flash_pos_bwd.py tile_classes.
__device__ __forceinline__ int tile_class(const Facts& q, bool q_whole, const Facts& k,
                                          bool k_whole, int causal, int window, int has_seg) {
  bool dead = false, full = q_whole && k_whole;
  if (causal) {
    dead = k.lo > q.hi;
    full = full && k.hi <= q.lo;
    if (window > 0) {
      dead = dead || static_cast<int64_t>(k.hi) <= static_cast<int64_t>(q.lo) - window;
      full = full && static_cast<int64_t>(q.hi) - k.lo < window;
    }
  }
  if (has_seg) {
    dead = dead || q.shi < k.slo || k.shi < q.slo;
    full = full && q.slo == q.shi && k.slo == k.shi && q.slo == k.slo;
  }
  return dead ? DEAD : (full ? FULL : MASKED);
}

// One block of the pass per batch row: the facts of every tile of both
// sequences, a warp a tile (one coalesced read of the positions and
// segment ids, 4 bytes an entry); then every K7 (dq) or K8 block's work, a
// warp a block; then the blocks by work, most first, equal work in index
// order (each block's rank counted against all).
struct PlanArgs {
  const int* qpos;
  const int* kpos;
  const int* qseg;
  const int* kseg;
  int* plan;
  int Sq, Skv, causal, window, has_seg, dq;
};

__device__ __forceinline__ void tile_facts(const int* pos, const int* seg, int S, int b, int t,
                                           int* out) {
  const int lane = threadIdx.x % 32;
  int lo = ftc::POS_MAX, hi = ftc::POS_MIN, slo = ftc::POS_MAX, shi = ftc::POS_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = t * T + lane + 32 * h;
    if (i < S) {
      const int p = pos[static_cast<int64_t>(b) * S + i];
      lo = min(lo, p);
      hi = max(hi, p);
      if (seg != nullptr) {
        const int s = seg[static_cast<int64_t>(b) * S + i];
        slo = min(slo, s);
        shi = max(shi, s);
      }
    }
  }
  lo = __reduce_min_sync(ftc::FULL, lo);
  hi = __reduce_max_sync(ftc::FULL, hi);
  slo = seg != nullptr ? __reduce_min_sync(ftc::FULL, slo) : 0;
  shi = seg != nullptr ? __reduce_max_sync(ftc::FULL, shi) : 0;
  if (lane == 0) *reinterpret_cast<int4*>(out) = make_int4(lo, hi, slo, shi);
}

__global__ void __launch_bounds__(PLAN_THREADS) bwd_plan_kernel(PlanArgs p) {
  extern __shared__ int plan_cnt[];  // [n_blocks]
  int* cnt = plan_cnt;
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int NW = PLAN_THREADS / 32;
  const PlanLayout L(p.Sq, p.Skv);
  const int B = gridDim.x;
  int* qf = p.plan;
  int* kf = p.plan + L.kf(B);
  for (int t = warp; t < L.n_qt; t += NW)
    tile_facts(p.qpos, p.qseg, p.Sq, b, t, qf + 4 * (static_cast<int64_t>(b) * L.n_qt + t));
  for (int t = warp; t < L.n_kt; t += NW)
    tile_facts(p.kpos, p.kseg, p.Skv, b, t, kf + 4 * (static_cast<int64_t>(b) * L.n_kt + t));
  __syncthreads();  // the block's facts are visible to it (plain loads below)

  // A block's own two tiles (q tiles for K7, kv tiles for K8) against every
  // tile of the other sequence.
  const int n_own = p.dq ? L.n_qt : L.n_kt, n_other = p.dq ? L.n_kt : L.n_qt;
  const int n_blk = cdiv(n_own, 2);
  const int* own = (p.dq ? qf : kf) + 4 * static_cast<int64_t>(b) * n_own;
  const int* other = (p.dq ? kf : qf) + 4 * static_cast<int64_t>(b) * n_other;
  const int S_own = p.dq ? p.Sq : p.Skv, S_other = p.dq ? p.Skv : p.Sq;
  for (int blk = warp; blk < n_blk; blk += NW) {
    const bool has1 = 2 * blk + 1 < n_own;
    const Facts f0 = load_facts(own, 2 * blk);
    const Facts f1 = has1 ? load_facts(own, 2 * blk + 1) : f0;
    const bool w0 = (2 * blk + 1) * T <= S_own, w1 = (2 * blk + 2) * T <= S_own;
    int count = 0;
    for (int o = lane; o < n_other; o += 32) {
      const Facts fo = load_facts(other, o);
      const bool wo = (o + 1) * T <= S_other;
      if (p.dq) {
        // K7's two warpgroups take a step together: the steps either attends.
        count += tile_class(f0, w0, fo, wo, p.causal, p.window, p.has_seg) != DEAD ||
                 (has1 && tile_class(f1, w1, fo, wo, p.causal, p.window, p.has_seg) != DEAD);
      } else {
        // K8 walks its two kv tiles in turn: the live pairs of both.
        count += (tile_class(fo, wo, f0, w0, p.causal, p.window, p.has_seg) != DEAD) +
                 (has1 && tile_class(fo, wo, f1, w1, p.causal, p.window, p.has_seg) != DEAD);
      }
    }
    count = __reduce_add_sync(ftc::FULL, count);
    if (lane == 0) cnt[blk] = count;
  }
  __syncthreads();
  int* order = p.plan + L.order(B) + static_cast<int64_t>(b) * L.n_order;
  for (int i = tid; i < n_blk; i += PLAN_THREADS) {
    const int c = cnt[i];
    int r = 0;
    for (int j = 0; j < n_blk; ++j) {
      const int cj = cnt[j];
      r += cj > c || (cj == c && j < i);
    }
    order[r] = i;
  }
}

// The block's walk, into `list` (n_other ints of shared memory) and its
// length into *n_list: every tile of the other sequence where either of the
// block's own two tiles is not DEAD, in order, as other << 4 | class of the
// first own tile | class of the second << 2 (every thread must call it).
__device__ __forceinline__ void build_walk(const WgArgs& a, int b, int blk, bool dq, int* list,
                                           int* n_list) {
  const PlanLayout L(a.Sq, a.Skv);
  const int* qf = a.plan;
  const int* kf = a.plan + L.kf(a.B);
  const int n_own = dq ? L.n_qt : L.n_kt, n_other = dq ? L.n_kt : L.n_qt;
  const int* own = (dq ? qf : kf) + 4 * static_cast<int64_t>(b) * n_own;
  const int* other = (dq ? kf : qf) + 4 * static_cast<int64_t>(b) * n_other;
  const int S_own = dq ? a.Sq : a.Skv, S_other = dq ? a.Skv : a.Sq;
  const bool has1 = 2 * blk + 1 < n_own;
  const Facts f0 = load_facts(own, 2 * blk);
  const Facts f1 = has1 ? load_facts(own, 2 * blk + 1) : f0;
  const bool w0 = (2 * blk + 1) * T <= S_own, w1 = (2 * blk + 2) * T <= S_own;
  for (int o = threadIdx.x; o < n_other; o += NTHREADS) {
    const Facts fo = load_facts(other, o);
    const bool wo = (o + 1) * T <= S_other;
    int c0, c1 = DEAD;
    if (dq) {
      c0 = tile_class(f0, w0, fo, wo, a.causal, a.window, a.has_seg);
      if (has1) c1 = tile_class(f1, w1, fo, wo, a.causal, a.window, a.has_seg);
    } else {
      c0 = tile_class(fo, wo, f0, w0, a.causal, a.window, a.has_seg);
      if (has1) c1 = tile_class(fo, wo, f1, w1, a.causal, a.window, a.has_seg);
    }
    list[o] = (c0 != DEAD || c1 != DEAD) ? (o << 4 | c0 | c1 << 2) : -1;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // In-place compaction by one warp, as in flash_tc.cuh live_steps.
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < n_other; base += 32) {
      const int o = base + lane;
      const int e = o < n_other ? list[o] : -1;
      const unsigned bal = __ballot_sync(ftc::FULL, e >= 0);
      if (e >= 0) list[count + __popc(bal & ((1u << lane) - 1u))] = e;
      count += __popc(bal);
    }
    if (lane == 0) *n_list = count;
  }
  __syncthreads();
}

// The block this CTA runs: rank r of its batch row in the plan's order,
// every head of a block together (grid = B x n_blocks x heads).
__device__ __forceinline__ void block_of(const WgArgs& a, int heads, int& b, int& head,
                                         int& blk) {
  const int L = blockIdx.x, per = a.B * heads;
  const int r = L / per;
  b = (L % per) / heads;
  head = L % heads;
  const PlanLayout P(a.Sq, a.Skv);
  blk = a.plan[P.order(a.B) + static_cast<int64_t>(b) * P.n_order + r];
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = hop::smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// 2^x on the MUFU unit (ex2.approx.ftz): exp(z - lse) as 2^(z log2 e -
// lse log2 e), one FFMA and one MUFU an element; -inf-like arguments give
// 0, so a masked pair takes MASK_L2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float MASK_L2 = -1e30f;

// The producer warp's copy of 64 int32 / float32 entries [i0, i0 + 64) of
// `src` (row base, n entries valid) into `dst`, two a lane, asynchronous;
// entries past n read zeros. The stage's full barrier counts the warp's
// 32 arrivals (arrive_on_copies) beside the TMA's bytes: the entries of
// a row start at any 4 bytes, where a TMA box must start on 16.
__device__ __forceinline__ void copy_row(void* dst, const void* src, int i0, int n) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    const bool in = i0 + i < n;
    tc::cp4(static_cast<char*>(dst) + 4 * i,
            in ? static_cast<const char*>(src) + 4 * static_cast<int64_t>(i0 + i) : src, in);
  }
}

// An arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(hop::smem_u32(bar))
               : "memory");
}

constexpr int FULL_ARRIVALS = 33;  // the producer's expect_tx and its warp's 32 copy arrivals

// A descriptor the compiler cannot see through: offsets are added to it at
// each product, not hoisted out of the walk as 16 live 64-bit values.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// Keeps A fragments in their registers up to this point: wgmma reads them
// after the instruction that names them, until its group completes.
__device__ __forceinline__ void hold_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

// One consumer warp's arrival on a stage's empty barrier (8 free it).
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hop::bar_arrive(empty);
}

// dS (or P) of the accumulator, 16 floats a 16-deep slice, as the bf16 A
// fragments of the next product: slice kk is columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = tc::pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = tc::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = tc::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = tc::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc (+)= X . Y^T over the head dim: X the warpgroup's 64 rows of a
// [halves][rows][64] tile whose halves lie `x_half` bytes apart, Y a
// [halves][64][64] tile. A descriptor's address field counts 16 bytes.
template <int HD>
__device__ __forceinline__ void product_ss(float (&acc)[32], const unsigned char* x,
                                           int x_half, const unsigned char* y) {
  const uint64_t dx = opaque(hop::desc(x, 16, 1024)), dy = opaque(hop::desc(y, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int h = kk / 4, off = (kk % 4) * 32;
    hop::wgmma_ss_n64(acc, dx + ((h * x_half + off) >> 4), dy + ((h * T * 128 + off) >> 4),
                      kk > 0);
  }
}

// acc += A . Y over 64 rows of Y, a [halves][64][64] tile read MN-major
// (its head columns the product's N).
template <int HD>
__device__ __forceinline__ void product_rs(float (&acc)[HD / 2], const uint32_t (&a)[4][4],
                                           const unsigned char* y) {
  const uint64_t dy = opaque(hop::desc(y, T * 128, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = dy + ((kk * 16 * 128) >> 4);
    if constexpr (HD == 128) hop::wgmma_rs_n128(acc, a[kk], d);
    else hop::wgmma_rs_n64(acc, a[kk], d);
  }
}

// K7-pos: one block per (q tile of ROWS rows, q head, batch row), in the
// plan's order. Shared memory (1024-aligned): Q and dO [halves][ROWS][64]
// resident; the ring's stages of K and V [halves][64][64] and the keys'
// positions and segment ids [64]; the barriers; the walk.
template <int HD>
struct DqSmem {
  static constexpr int HALVES = HD / 64;
  static constexpr int Q_HALF = ROWS * 128;           // bytes of a half of Q or dO
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * T * 128;  // K or V of a step
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int KPOS = RING + DQ_STAGES * STAGE;  // [DQ_STAGES][64] int
  static constexpr int KSEG = KPOS + DQ_STAGES * T * 4;
  static constexpr int BARS = KSEG + DQ_STAGES * T * 4;  // full[DQ_STAGES], empty[DQ_STAGES], q
  static constexpr int NLIST = BARS + (2 * DQ_STAGES + 1) * 8;
  static constexpr int LIST = NLIST + 16;
  static constexpr size_t bytes(int n_kt) { return 1024 + LIST + 4 * static_cast<size_t>(n_kt); }
};

// CAP: softcap > 0, a kernel of its own (the tanh and its 1 - t^2 stay
// out of the common step).
template <int HD, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_dq_wg_kernel(const __grid_constant__ WgArgs a) {
  using S = DqSmem<HD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* sm = align1024(wg_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* qbar = empty + DQ_STAGES;
  int* n_list_p = reinterpret_cast<int*>(sm + S::NLIST);
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int b, n, blk;
  block_of(a, a.N, b, n, blk);
  const int q0 = blk * ROWS, kvh = n / (a.N / a.K);
  if (tid == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      hop::bar_init(full + s, FULL_ARRIVALS);
      hop::bar_init(empty + s, CONSUMER_WARPS);
    }
    hop::bar_init(qbar, 1);
    hop::fence_bar_init();
  }
  build_walk(a, b, blk, true, list, n_list_p);  // its barriers order the inits too
  const int n_list = *n_list_p;

  if (warp >= CONSUMER_WARPS) {
    // Producer: Q and dO once, then K and V of each step of the walk by
    // TMA (one thread), the keys' positions (and segment ids) by the warp.
    hop::reg_dealloc<24>();
    if (warp == CONSUMER_WARPS && n_list > 0) {
      if (lane == 0) {
        hop::bar_expect_tx(qbar, 2 * S::Q_BYTES);
        for (int h = 0; h < S::HALVES; ++h) {
          hop::tma_4d(sm + h * S::Q_HALF, &a.q, qbar, h * 64, n, q0, b);
          hop::tma_4d(sm + S::Q_BYTES + h * S::Q_HALF, &a.dout, qbar, h * 64, n, q0, b);
        }
      }
      const int* kpos = a.kpos + static_cast<int64_t>(b) * a.Skv;
      const int* kseg = a.has_seg ? a.kseg + static_cast<int64_t>(b) * a.Skv : nullptr;
      for (int i = 0; i < n_list; ++i) {
        const int st = i % DQ_STAGES;
        hop::bar_wait(empty + st, ((i / DQ_STAGES) & 1) ^ 1);
        const int k0 = (list[i] >> 4) * T;
        if (lane == 0) {
          unsigned char* kv = sm + S::RING + st * S::STAGE;
          hop::bar_expect_tx(full + st, S::STAGE);
          for (int h = 0; h < S::HALVES; ++h) {
            hop::tma_4d(kv + h * T * 128, &a.k, full + st, h * 64, kvh, k0, b);
            hop::tma_4d(kv + S::KV_BYTES + h * T * 128, &a.v, full + st, h * 64, kvh, k0, b);
          }
        }
        copy_row(sm + S::KPOS + st * T * 4, kpos, k0, a.Skv);
        if (kseg != nullptr) copy_row(sm + S::KSEG + st * T * 4, kseg, k0, a.Skv);
        arrive_on_copies(full + st);
      }
    }
  } else {
    hop::reg_alloc<CONSUMER_REGS>();
    const int wgi = warp / 4, grp = lane >> 2, tig = lane & 3;
    // This thread's two rows (grp and grp + 8 of its warp's 16): lse, delta,
    // position and segment id in registers; rows past Sq get lse = NEG_INF.
    int qi[2], qp[2], qs[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qi[h] = q0 + wgi * T + (warp % 4) * 16 + grp + 8 * h;
      const bool in = qi[h] < a.Sq;
      const int64_t row = (static_cast<int64_t>(b) * a.N + n) * a.Sq + qi[h];
      lse_r[h] = in ? a.lse[row] : NEG_INF;
      delta_r[h] = in ? a.delta[row] : 0.f;
      qp[h] = in ? a.qpos[static_cast<int64_t>(b) * a.Sq + qi[h]] : 0;
      qs[h] = in && a.has_seg ? a.qseg[static_cast<int64_t>(b) * a.Sq + qi[h]] : 0;
    }
    const float scale_l2 = a.scale * tc::LOG2E;
    const float nlse_l2[2] = {-lse_r[0] * tc::LOG2E, -lse_r[1] * tc::LOG2E};
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    if (n_list > 0) hop::bar_wait(qbar, 0);
    const unsigned char* qs_wg = sm + wgi * T * 128;
    const unsigned char* dos_wg = sm + S::Q_BYTES + wgi * T * 128;
    // The step's products in three groups: S and dP (S's exponentials
    // overlap dP), then dQ += dS . K. A step DEAD for the warpgroup only
    // releases its stage.
    for (int i = 0; i < n_list; ++i) {
      const int st = i % DQ_STAGES;
      const int e = list[i];
      const int cls = (e >> (2 * wgi)) & 3;
      const int k0 = (e >> 4) * T;
      const unsigned char* kt = sm + S::RING + st * S::STAGE;
      hop::bar_wait(full + st, (i / DQ_STAGES) & 1);
      if (cls != DEAD) {  // uniform over the warpgroup
        float s[32], dp[32];
        hop::wg_fence();
        product_ss<HD>(s, qs_wg, S::Q_HALF, kt);
        hop::wg_commit();
        product_ss<HD>(dp, dos_wg, S::Q_HALF, kt + S::KV_BYTES);
        hop::wg_commit();
        hop::wg_wait<1>();
        hop::fence_regs(s);
        // P = exp(z - lse) in f32 into s: no mask on a FULL step, else the
        // mask inside the exponential (lse may be NEG_INF); under softcap
        // times 1 - t^2 (dS = P (dP - delta) (1 - t^2); P alone enters no
        // product).
        if (cls == FULL && !CAP) {
#pragma unroll
          for (int x = 0; x < 32; ++x) s[x] = ex2(fmaf(s[x], scale_l2, nlse_l2[(x >> 1) & 1]));
        } else {
          const int* kp = reinterpret_cast<const int*>(sm + S::KPOS + st * T * 4);
          const int* ks = reinterpret_cast<const int*>(sm + S::KSEG + st * T * 4);
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int h = (x >> 1) & 1, c = (x >> 2) * 8 + 2 * tig + (x & 1);
            float z = s[x] * a.scale, th = 0.f;
            if constexpr (CAP) {
              th = tanhf(z / a.softcap);
              z = a.softcap * th;
            }
            bool keep = true;
            if (cls != FULL) {
              keep = qi[h] < a.Sq && k0 + c < a.Skv;
              if (a.causal) {
                const int d = qp[h] - kp[c];
                keep = keep && d >= 0 && (a.window <= 0 || d < a.window);
              }
              if (a.has_seg) keep = keep && qs[h] == ks[c];
            }
            const float p = ex2(keep ? fmaf(z, tc::LOG2E, nlse_l2[h]) : MASK_L2);
            s[x] = CAP ? p * (1.f - th * th) : p;
          }
        }
        hop::wg_wait<0>();
        hop::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4)
            dp[4 * j + e4] = s[4 * j + e4] * (dp[4 * j + e4] - delta_r[e4 >> 1]);
        uint32_t da[4][4];
        to_a(dp, da);
        hop::wg_fence();
        product_rs<HD>(dq, da, kt);  // dQ += dS . K
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(dq);
        hold_frags(da);
      }
      release(empty + st);
    }
    // dq = scale * sum dS . k; one thread per element.
    __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qi[h] >= a.Sq) continue;
      __nv_bfloat16* row = dqp + ((static_cast<int64_t>(b) * a.Sq + qi[h]) * a.N + n) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + j * 8 + 2 * tig) =
            tc::pack_bf16(dq[4 * j + 2 * h] * a.scale, dq[4 * j + 2 * h + 1] * a.scale);
    }
  }
}

// K8-pos: one block per (128 keys, kv head, batch row), in the plan's
// order: its two kv tiles one after the other, each walking (query head of
// the group, q tile of the walk not DEAD for the tile). The two consumer
// warpgroups split the step by role over the tile's 64 keys: warpgroup 0
// computes S^T = K . Q^T, P^T (the mask inside the exponential) and dV +=
// P^T . dO; warpgroup 1 dP^T = V . dO^T, dS^T = P^T (dP^T - delta) and dK
// += dS^T . Q. P^T passes from 0 to 1 through shared memory in f32, so
// dS^T is formed before any rounding (as K7-pos forms dS; P^T rounds to
// bf16 only as dV's A fragments), under two named barriers: BAR_P (P^T is
// in the tile) and BAR_FREE (warpgroup 1 holds it in registers), so
// warpgroup 0 runs up to a step ahead and never waits for dS^T. So a
// warpgroup holds one accumulator of 64 registers (dK or dV) beside the
// step's 32: with both in one warpgroup (128 registers) ptxas spilled a
// 32-register block to local memory and serialized the wgmmas.
// Shared memory: K and V [halves][ROWS][64] resident; the ring's stages of
// Q and dO [halves][64][64] and the q tile's lse, delta, positions and
// segment ids [64]; the exchange tiles P^T and its softcap factor 1 - t^2
// (f32); the barriers; the walk.
template <int HD>
struct DkvSmem {
  static constexpr int HALVES = HD / 64;
  static constexpr int K_HALF = ROWS * 128;
  static constexpr int K_BYTES = HALVES * K_HALF;
  static constexpr int Q_TILE = HALVES * T * 128;    // Q or dO of a step
  static constexpr int ROWDATA = 4 * T * 4;          // lse, delta, qpos, qseg
  static constexpr int STAGE = 2 * Q_TILE + ROWDATA;  // a multiple of 1024
  static constexpr int RING = 2 * K_BYTES;
  static constexpr int XCH = RING + DKV_STAGES * STAGE;  // [2][64][64] f32
  static constexpr int BARS = XCH + 2 * T * T * 4;  // full[DKV_STAGES], empty[DKV_STAGES], kv
  static constexpr int NLIST = BARS + (2 * DKV_STAGES + 1) * 8;
  static constexpr int LIST = NLIST + 16;
  static constexpr size_t bytes(int n_qt) { return 1024 + LIST + 4 * static_cast<size_t>(n_qt); }
};

// Named barriers between the two consumer warpgroups (0 is __syncthreads').
constexpr int BAR_P = 1, BAR_FREE = 2;

__device__ __forceinline__ void bar_arrive_named(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_sync_named(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// Elements 4 j .. 4 j + 3 of a warpgroup thread's accumulator layout in a
// [8][128] float4 tile: the same thread of the other warpgroup reads them
// back; a warp's 32 float4 are 512 consecutive bytes, no conflict.
__device__ __forceinline__ float4* f32_at(unsigned char* tile, int j) {
  return reinterpret_cast<float4*>(tile) + j * 128 + threadIdx.x % 128;
}

// CAP: softcap > 0, a kernel of its own (the tanh and its 1 - t^2 stay out
// of the common step).
template <int HD, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_dkv_wg_kernel(const __grid_constant__ WgArgs a) {
  using S = DkvSmem<HD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* sm = align1024(wg_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* empty = full + DKV_STAGES;
  uint64_t* kvbar = empty + DKV_STAGES;
  int* n_list_p = reinterpret_cast<int*>(sm + S::NLIST);
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.N / a.K;
  int b, kvh, blk;
  block_of(a, a.K, b, kvh, blk);
  const int k0 = blk * ROWS;
  if (tid == 0) {
    for (int s = 0; s < DKV_STAGES; ++s) {
      hop::bar_init(full + s, FULL_ARRIVALS);
      hop::bar_init(empty + s, CONSUMER_WARPS);
    }
    hop::bar_init(kvbar, 1);
    hop::fence_bar_init();
  }
  build_walk(a, b, blk, false, list, n_list_p);
  const int n_list = *n_list_p;

  if (warp >= CONSUMER_WARPS) {
    // Producer: K and V once, then for each kv tile, query head of the
    // group and q tile of the walk Q and dO by TMA (one thread), the
    // queries' lse, delta and positions (and segment ids) by the warp.
    hop::reg_dealloc<24>();
    if (warp == CONSUMER_WARPS && n_list > 0) {
      if (lane == 0) {
        hop::bar_expect_tx(kvbar, 2 * S::K_BYTES);
        for (int h = 0; h < S::HALVES; ++h) {
          hop::tma_4d(sm + h * S::K_HALF, &a.k, kvbar, h * 64, kvh, k0, b);
          hop::tma_4d(sm + S::K_BYTES + h * S::K_HALF, &a.v, kvbar, h * 64, kvh, k0, b);
        }
      }
      const int* qpos = a.qpos + static_cast<int64_t>(b) * a.Sq;
      const int* qseg = a.has_seg ? a.qseg + static_cast<int64_t>(b) * a.Sq : nullptr;
      int i = 0;
      for (int kt = 0; kt < 2; ++kt) {
        for (int g = 0; g < G; ++g) {
          const int n = kvh * G + g;
          const int64_t row = (static_cast<int64_t>(b) * a.N + n) * a.Sq;
          for (int li = 0; li < n_list; ++li) {
            if (((list[li] >> (2 * kt)) & 3) == DEAD) continue;
            const int st = i % DKV_STAGES;
            hop::bar_wait(empty + st, ((i / DKV_STAGES) & 1) ^ 1);
            ++i;
            const int t0 = (list[li] >> 4) * T;
            unsigned char* qd = sm + S::RING + st * S::STAGE;
            if (lane == 0) {
              hop::bar_expect_tx(full + st, 2 * S::Q_TILE);
              for (int h = 0; h < S::HALVES; ++h) {
                hop::tma_4d(qd + h * T * 128, &a.q, full + st, h * 64, n, t0, b);
                hop::tma_4d(qd + S::Q_TILE + h * T * 128, &a.dout, full + st, h * 64, n, t0, b);
              }
            }
            unsigned char* rd = qd + 2 * S::Q_TILE;
            copy_row(rd, a.lse + row, t0, a.Sq);
            copy_row(rd + T * 4, a.delta + row, t0, a.Sq);
            copy_row(rd + 2 * T * 4, qpos, t0, a.Sq);
            if (qseg != nullptr) copy_row(rd + 3 * T * 4, qseg, t0, a.Sq);
            arrive_on_copies(full + st);
          }
        }
      }
    }
  } else {
    hop::reg_alloc<CONSUMER_REGS>();
    const int role = warp / 4;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
    const int grp = lane >> 2, tig = lane & 3;
    const float scale_l2 = a.scale * tc::LOG2E;
    unsigned char* p_tile = sm + S::XCH;         // P^T, f32
    unsigned char* c_tile = p_tile + T * T * 4;  // 1 - t^2, f32
    if (n_list > 0) hop::bar_wait(kvbar, 0);
    int i = 0;
    for (int kt = 0; kt < 2; ++kt) {
      // This thread's two keys of the tile (grp and grp + 8 of its warp's
      // 16): position and segment id for the mask (warpgroup 0).
      int kc[2], kp[2], ks[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        kc[h] = k0 + kt * T + (warp % 4) * 16 + grp + 8 * h;
        const bool in = kc[h] < a.Skv;
        kp[h] = in ? a.kpos[static_cast<int64_t>(b) * a.Skv + kc[h]] : 0;
        ks[h] = in && a.has_seg ? a.kseg[static_cast<int64_t>(b) * a.Skv + kc[h]] : 0;
      }
      // K's rows of the tile (warpgroup 0) or V's (warpgroup 1).
      const unsigned char* kv = sm + role * S::K_BYTES + kt * T * 128;
      float out[HD / 2];  // dK or dV of the tile's keys
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) out[x] = 0.f;
      for (int g = 0; g < G; ++g) {
        for (int li = 0; li < n_list; ++li) {
          const int e = list[li];
          const int cls = (e >> (2 * kt)) & 3;
          if (cls == DEAD) continue;  // not loaded either
          const int st = i % DKV_STAGES;
          hop::bar_wait(full + st, (i / DKV_STAGES) & 1);
          ++i;
          const int t0 = (e >> 4) * T;
          const unsigned char* qt = sm + S::RING + st * S::STAGE;
          const unsigned char* dot = qt + S::Q_TILE;
          const float* lse = reinterpret_cast<const float*>(dot + S::Q_TILE);
          const float* delta = lse + T;
          const int* qpos = reinterpret_cast<const int*>(delta + T);
          const int* qseg = qpos + T;
          float acc[32];
          uint32_t fa[4][4], sfa[4][4];
          hop::wg_fence();
          product_ss<HD>(acc, kv, S::K_HALF, role == 0 ? qt : dot);  // S^T or dP^T
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::fence_regs(acc);
          if (role == 0) {
            // P^T: element 4 j + 2 h + e is key grp + 8 h, query 8 j + 2 tig
            // + e; elements 4 j .. 4 j + 3 go to the exchange as one float4,
            // and pair (e = 0, 1) is dV's A fragment [j / 2][2 (j % 2) + h].
            if (i > 1) bar_sync_named(BAR_FREE);  // warpgroup 1 holds the last P^T
            if (cls == FULL && !CAP) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float2 lse_c = *reinterpret_cast<const float2*>(lse + j * 8 + 2 * tig);
                const float n0 = -lse_c.x * tc::LOG2E, n1 = -lse_c.y * tc::LOG2E;
                const float4 p4 = make_float4(ex2(fmaf(acc[4 * j], scale_l2, n0)),
                                              ex2(fmaf(acc[4 * j + 1], scale_l2, n1)),
                                              ex2(fmaf(acc[4 * j + 2], scale_l2, n0)),
                                              ex2(fmaf(acc[4 * j + 3], scale_l2, n1)));
                *f32_at(p_tile, j) = p4;
                fa[j / 2][2 * (j % 2)] = tc::pack_bf16(p4.x, p4.y);
                fa[j / 2][2 * (j % 2) + 1] = tc::pack_bf16(p4.z, p4.w);
              }
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int c0 = j * 8 + 2 * tig;
                const float2 lse_c = *reinterpret_cast<const float2*>(lse + c0);
                const float nl[2] = {-lse_c.x * tc::LOG2E, -lse_c.y * tc::LOG2E};
                float pv[4], cv[4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
#pragma unroll
                  for (int e2 = 0; e2 < 2; ++e2) {
                    float z = acc[4 * j + 2 * h + e2] * a.scale, th = 0.f;
                    if constexpr (CAP) {
                      th = tanhf(z / a.softcap);
                      z = a.softcap * th;
                    }
                    bool keep = true;
                    if (cls != FULL) {
                      keep = t0 + c0 + e2 < a.Sq && kc[h] < a.Skv;
                      if (a.causal) {
                        const int d = qpos[c0 + e2] - kp[h];
                        keep = keep && d >= 0 && (a.window <= 0 || d < a.window);
                      }
                      if (a.has_seg) keep = keep && qseg[c0 + e2] == ks[h];
                    }
                    pv[2 * h + e2] = ex2(keep ? fmaf(z, tc::LOG2E, nl[e2]) : MASK_L2);
                    cv[2 * h + e2] = 1.f - th * th;
                  }
                }
                *f32_at(p_tile, j) = make_float4(pv[0], pv[1], pv[2], pv[3]);
                if constexpr (CAP) *f32_at(c_tile, j) = make_float4(cv[0], cv[1], cv[2], cv[3]);
                fa[j / 2][2 * (j % 2)] = tc::pack_bf16(pv[0], pv[1]);
                fa[j / 2][2 * (j % 2) + 1] = tc::pack_bf16(pv[2], pv[3]);
              }
            }
            bar_arrive_named(BAR_P);  // P^T is in p_tile
            hop::wg_fence();
            product_rs<HD>(out, fa, dot);  // dV += P^T . dO
            hop::wg_commit();
            hop::wg_wait<0>();
            hold_frags(fa);
          } else {
            bar_sync_named(BAR_P);
            float4 p4[8], c4[CAP ? 8 : 1];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              p4[j] = *f32_at(p_tile, j);
              if constexpr (CAP) c4[j] = *f32_at(c_tile, j);
            }
            bar_arrive_named(BAR_FREE);  // p_tile may take the next P^T
            // dS^T = P^T (dP^T - delta) (1 - t^2) in f32, rounded once.
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 delta_c = *reinterpret_cast<const float2*>(delta + j * 8 + 2 * tig);
              float d[4] = {p4[j].x * (acc[4 * j] - delta_c.x),
                            p4[j].y * (acc[4 * j + 1] - delta_c.y),
                            p4[j].z * (acc[4 * j + 2] - delta_c.x),
                            p4[j].w * (acc[4 * j + 3] - delta_c.y)};
              if constexpr (CAP) {
                d[0] *= c4[j].x;
                d[1] *= c4[j].y;
                d[2] *= c4[j].z;
                d[3] *= c4[j].w;
              }
              sfa[j / 2][2 * (j % 2)] = tc::pack_bf16(d[0], d[1]);
              sfa[j / 2][2 * (j % 2) + 1] = tc::pack_bf16(d[2], d[3]);
            }
            hop::wg_fence();
            product_rs<HD>(out, sfa, qt);  // dK += dS^T . Q
            hop::wg_commit();
            hop::wg_wait<0>();
            hold_frags(sfa);
          }
          hop::fence_regs(out);
          release(empty + st);
        }
      }
      // dv (warpgroup 0), dk = scale * sum dS^T . q (warpgroup 1); one
      // thread per element.
      __nv_bfloat16* outp = static_cast<__nv_bfloat16*>(role == 0 ? a.dv : a.dk);
      const float f = role == 0 ? 1.f : a.scale;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kc[h] >= a.Skv) continue;
        const int64_t base = ((static_cast<int64_t>(b) * a.Skv + kc[h]) * a.K + kvh) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(outp + base + j * 8 + 2 * tig) =
              tc::pack_bf16(out[4 * j + 2 * h] * f, out[4 * j + 2 * h + 1] * f);
      }
    }
    // Warpgroup 1 arrived on BAR_FREE once a step, warpgroup 0 waited from
    // the second step on: its last wait balances the barrier.
    if (role == 0 && i > 0) bar_sync_named(BAR_FREE);
  }
}

// The plan pass alone into `plan` (dq: K7's block order, else K8's).
inline cudaError_t plan_only(const int* qpos, const int* kpos, const int* qseg,
                             const int* kseg, int* plan, int B, int Sq, int Skv, int causal,
                             int window, bool dq, cudaStream_t stream) {
  const int n_blk = dq ? cdiv(Sq, ROWS) : cdiv(Skv, ROWS);
  if (static_cast<size_t>(n_blk) * 4 > 48 * 1024) return cudaErrorInvalidValue;
  const PlanArgs pa{qpos, kpos, qseg, kseg, plan, Sq, Skv, causal, window, qseg != nullptr,
                    dq ? 1 : 0};
  bwd_plan_kernel<<<B, PLAN_THREADS, n_blk * 4, stream>>>(pa);
  return cudaGetLastError();
}

// The plan pass, then K7-pos (dq) or K8-pos: maps from the operands;
// cudaErrorInvalidValue when a map cannot be made or the walk's list or
// the plan's counts do not fit shared memory.
template <int HD>
cudaError_t launch(const PosArgs& p, int* plan, int B, bool dq, cudaStream_t stream) {
  WgArgs a{};
  a.lse = p.lse;
  a.delta = p.delta;
  a.qpos = p.qpos;
  a.kpos = p.kpos;
  a.qseg = p.qseg;
  a.kseg = p.kseg;
  a.dq = p.dq;
  a.dk = p.dk;
  a.dv = p.dv;
  a.plan = plan;
  a.B = B;
  a.Sq = p.Sq;
  a.Skv = p.Skv;
  a.N = p.N;
  a.K = p.K;
  a.causal = p.causal;
  a.window = p.window;
  a.has_seg = p.qseg != nullptr;
  a.softcap = p.softcap;
  a.scale = p.scale;
  const PlanLayout L(p.Sq, p.Skv);
  const int64_t n_rows = static_cast<int64_t>(B) * p.N * p.Sq;
  const int n_blk = dq ? cdiv(p.Sq, ROWS) : cdiv(p.Skv, ROWS);
  const size_t smem = dq ? DqSmem<HD>::bytes(L.n_kt) : DkvSmem<HD>::bytes(L.n_qt);
  if (plan == nullptr || n_rows >= (int64_t{1} << 31) ||
      static_cast<int64_t>(B) * max(p.Sq, p.Skv) >= (int64_t{1} << 31) || smem > 232448 ||
      static_cast<size_t>(n_blk) * 4 > 48 * 1024) {
    fprintf(stderr, "flash_bwd: shapes past the warpgroup kernels' limits (B %d, Sq %d, Skv %d, "
                    "N %d, H %d)\n", B, p.Sq, p.Skv, p.N, HD);
    return cudaErrorInvalidValue;
  }
  const int q_rows = dq ? ROWS : T, kv_rows = dq ? T : ROWS;
  const CUresult r[4] = {hop::map_rows(&a.q, p.q, B, p.Sq, p.N, HD, q_rows),
                         hop::map_rows(&a.dout, p.dout, B, p.Sq, p.N, HD, q_rows),
                         hop::map_rows(&a.k, p.k, B, p.Skv, p.K, HD, kv_rows),
                         hop::map_rows(&a.v, p.v, B, p.Skv, p.K, HD, kv_rows)};
  for (int i = 0; i < 4; ++i) {
    if (r[i] != CUDA_SUCCESS) {
      fprintf(stderr, "flash_bwd: TMA tensor map %d (q, dO, k, v) not encoded: CUresult %d\n", i,
              static_cast<int>(r[i]));
      return cudaErrorInvalidValue;
    }
  }
  cudaError_t err = plan_only(p.qpos, p.kpos, p.qseg, p.kseg, plan, B, p.Sq, p.Skv, p.causal,
                              p.window, dq, stream);
  if (err != cudaSuccess) return err;
  const int heads = dq ? p.N : p.K;
  const dim3 grid(B * n_blk * heads);
  const bool cap = p.softcap > 0.f;
  void (*kernel)(WgArgs) =
      dq ? (cap ? &flash_dq_wg_kernel<HD, true> : &flash_dq_wg_kernel<HD, false>)
         : (cap ? &flash_dkv_wg_kernel<HD, true> : &flash_dkv_wg_kernel<HD, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg


template <typename A>
cudaError_t launch_with(void (*kernel)(A), dim3 grid, int threads, size_t smem,
                        cudaStream_t stream, const A& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16: the tensor-core kernels; with positions at H = 64 and 128 the
// warpgroup kernels after their plan pass, at other head dims the index
// kernels' templates with POS. float32 keeps the CUDA-core ones,
// positions a run-time branch with their list in shared memory.
template <int HD>
cudaError_t launch(const PosArgs& a, int* plan, int B, bool bf16, bool dq, cudaStream_t stream) {
  const bool pos = a.qpos != nullptr;
  if constexpr (HD == 64 || HD == 128) {
    if (pos && bf16) return wg::launch<HD>(a, plan, B, dq, stream);
  }
  const int n_kt = (a.Skv + BK - 1) / BK, n_qt = (a.Sq + BQ - 1) / BQ;
  if (dq && bf16) {
    const dim3 grid(a.N, B, (a.Sq + ftc::ROWS - 1) / ftc::ROWS);
    const size_t tsm = tcdq::smem_bytes<HD>();
    return pos ? launch_with(tcdq::flash_dq_tc_kernel<HD, true>, grid, ftc::NT,
                             tsm + tcdq::pos_bytes(n_kt), stream, a)
               : launch_with(tcdq::flash_dq_tc_kernel<HD, false>, grid, ftc::NT, tsm, stream,
                             a.args());
  }
  if (dq) {
    const size_t smem = Tile<HD>::bytes() + (pos ? Tile<HD>::pos_bytes(n_kt) : 0);
    return launch_with(flash_dq_kernel<HD>, dim3(n_qt, a.N, B), NT, smem, stream, a);
  }
  if (bf16) {
    const dim3 grid((a.Skv + tcdkv::TK - 1) / tcdkv::TK, a.K, B);
    const size_t tsm = tcdkv::Smem<HD>::bytes();
    const int n_qt_tc = (a.Sq + tcdkv::TQ - 1) / tcdkv::TQ;
    return pos ? launch_with(tcdkv::flash_dkv_tc_kernel<HD, true>, grid, NT,
                             tsm + tcdkv::pos_bytes<HD>(n_qt_tc), stream, a)
               : launch_with(tcdkv::flash_dkv_tc_kernel<HD, false>, grid, NT, tsm, stream,
                             a.args());
  }
  const size_t smem = Tile<HD>::bytes() + (pos ? Tile<HD>::pos_bytes(n_qt) : 0);
  return launch_with(flash_dkv_kernel<HD>, dim3(n_kt, a.K, B), NT, smem, stream, a);
}

cudaError_t by_head_dim(const PosArgs& a, int* plan, int B, int H, bool bf16, bool dq,
                        cudaStream_t stream) {
  switch (H) {
    case 16: return launch<16>(a, plan, B, bf16, dq, stream);
    case 32: return launch<32>(a, plan, B, bf16, dq, stream);
    case 64: return launch<64>(a, plan, B, bf16, dq, stream);
    case 128: return launch<128>(a, plan, B, bf16, dq, stream);
    case 256: return launch<256>(a, plan, B, bf16, dq, stream);
    default: return cudaErrorInvalidValue;
  }
}

// An empty kv (K7) or q (K8) range still launches and writes zeros.
int run(const PosArgs& a, int* plan, int B, int H, int dtype, bool dq, void* stream) {
  if (B == 0 || (dq ? a.Sq : a.Skv) == 0) return 0;
  return static_cast<int>(
      by_head_dim(a, plan, B, H, dtype == 1, dq, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Positions (qpos and kpos together, or both null) refuse q_offset and
// seg_pad_zero: K7/K8-pos run without the tile skip.
int check_pos(const PosArgs& a) {
  if ((a.qpos == nullptr) != (a.kpos == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.qpos != nullptr && (a.q_offset != 0 || a.seg_pad_zero != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none.
// Segment and position pointers may be null; with positions, `plan` is the
// plan pass's int32 scratch (ops/flash_pos_bwd.py plan_scratch_ints), read
// by the bf16 kernels at head_dim 64 and 128. Return cudaGetLastError()
// after the launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, const int* qseg,
                        const int* kseg, const int* qpos, const int* kpos, int* plan, int B, int Sq,
                        int Skv, int N, int K, int H, int causal, int q_offset, int window,
                        int seg_pad_zero, float softcap, float scale, int dtype, void* stream) {
  const PosArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, qseg, kseg, qpos, kpos,
                  Sq, Skv, N, K, causal, q_offset, window, seg_pad_zero, softcap, scale};
  if (const int rc = check_pos(a)) return rc;
  return run(a, plan, B, H, dtype, true, stream);
}

// The plan pass of K7-pos (dq = 1) or K8-pos alone, into `plan`
// (plan_scratch_ints entries): what the kernels read, for checks.
extern "C" int flash_bwd_plan(const int* qpos, const int* kpos, const int* qseg, const int* kseg,
                              int* plan, int B, int Sq, int Skv, int causal, int window, int dq,
                              void* stream) {
  if (B == 0) return 0;
  return static_cast<int>(wg::plan_only(qpos, kpos, qseg, kseg, plan, B, Sq, Skv, causal, window,
                                        dq != 0, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv,
                         const int* qseg, const int* kseg, const int* qpos, const int* kpos,
                         int* plan, int B, int Sq, int Skv, int N, int K, int H, int causal,
                         int q_offset, int window, int seg_pad_zero, float softcap, float scale,
                         int dtype, void* stream) {
  const PosArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, qseg, kseg, qpos, kpos,
                  Sq, Skv, N, K, causal, q_offset, window, seg_pad_zero, softcap, scale};
  if (const int rc = check_pos(a)) return rc;
  return run(a, plan, B, H, dtype, false, stream);
}
