// K3: flash-attention forward for prefill and training, hand-written for
// Hopper (sm_90a), and the merge of its positions branch's split walk.
//
// Replaces the TPU kernel orion_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (the pl.pallas_call in _fwd_call): grouped-query attention with an online
// softmax, causal mask with q_offset, segment ids (with the seg_pad_zero
// tile skip), sliding window and logit softcap. Layout at the interface is
// the JAX package's: q/o [B, Sq, N, H], k/v [B, Skv, K, H], contiguous.
// With a non-null `lse`, the kernel also writes each row's log-sum-exp of
// its attended logits, m + log(l), as float32 [B, N, Sq] (NEG_INF where
// the row attends nothing): the residual the backward kernels K7/K8
// (flash_bwd.cu) recompute the probabilities from. Serving passes null.
// A row with nothing attended returns 0 (l == 0 -> l_safe = 1), not NaN.
// Padded query rows (segment 0) hold values that the caller discards.
//
// Explicit positions (the has_pos branch of _fwd_kernel: _block_mask and
// _block_run, flash_attention.py:88-140): with non-null qpos [B, Sq] and
// kpos [B, Skv] (int32) the causal and window tests compare positions,
// not indices (q_offset unused). The serving caller is the gather prefill
// body: tail queries at prefix_len + i over a prefix gathered at [0,
// P_pre*psz) and the tail, so a row with a short prefix meets prefix
// columns that are padding, and a striped layout (sequence parallelism)
// gives positions that do not rise. Positions are read, never assumed:
// a block first lists the key steps it may attend (flash_tc.cuh
// live_steps: the block's q position extremes against each step's kv
// extremes, and the seg_pad_zero liveness), in shared memory, and its
// loop walks that list, so a dead step is neither loaded nor computed;
// inside, each warp tests its own extremes per step (dead, or full with
// no mask), and the mask compares the pair's positions. The list costs
// one coalesced pass over the row's kv positions per block (4 bytes a key,
// from L2) against 2 * H * 2 bytes a key of K and V.
//
// bfloat16 with positions (flash_fwd_pos_tc_kernel) is its own kernel,
// because at the gather body's shapes (4 rows of 256 queries over up to
// 8448 keys, rows resuming at 0 to 7936) a block per (q tile, head, row)
// leaves the time to the serial walk of the longest rows' blocks, ~260
// steps each, while the short rows' blocks sit idle, and the four heads of
// a group would load the same K and V steps in four blocks:
//   - the group's G query heads share a block, tq = the largest power of
//     two with G * tq <= 128 queries of each (flash_tc.cuh PackRows), so a
//     K/V step is loaded once per kv head, not once per query head (K9's
//     packing);
//   - the (row, q tile, kv head) walk splits over the grid's n_splits
//     (from the shapes, ops/flash_pos.py grid_splits): every split block
//     computes the same live-step list and takes an even share of it, one
//     split per split_steps live steps and at most n_splits. Splitting the
//     list, not fixed key ranges, balances the gather layout's long and
//     short rows and a striped layout alike: a split never holds dead
//     steps, and a short row takes one split, whose block writes the
//     normalized output (and lse) itself;
//   - otherwise each split writes float32 partials (O unnormalized, m, l;
//     [n_splits, B, Sq, N, H] and [.., 2]) and flash_pos_merge_kernel
//     combines them in split order, so the same inputs give the same
//     bits; each block's active splits reach the merge through n_act;
//   - the step itself is the index kernel's (attend_step, below),
//     so identity positions on one split give the index path's bits.
//
// What bounds it on an H100: operations. Attention does two products of
// 2*H flops per (query, key) pair (q.k and p.v: about 4*H flops) against
// ~4*H bytes per query row, far above the card's ridge point, so the
// tensor-core rate (989 TFLOP/s bf16) is the bound it is measured against.
//
// bfloat16 (flash_fwd_tc_kernel) runs both products on the tensor cores,
// K9's forward loop without the pages (the block plan is flash_tc.cuh's,
// shared with K7):
//   - one block of 8 warps per (q tile of 128 rows, q head, batch); a warp
//     owns 16 query rows with their f32 online softmax (m, l) and output
//     accumulator in registers; Q stays in shared memory (rows of H + 8
//     bf16, the 16-byte skew of tc.cuh) for the block's life;
//   - a loop over key steps of 32 keys (the float32 kernel's kv tile), K,
//     V and the keys' segment ids streamed through a two-stage cp.async
//     ring, so the next step's load overlaps this step's products. 32 keys keep the
//     logits in 16 registers, so a thread fits 128 registers up to H = 128
//     and two blocks share an SM (one at H = 256);
//   - S = Q.K^T and O += P.V with mma.sync.m16n8k16 (bf16 in, f32
//     accumulate; ldmatrix fragments); the scale is applied to the f32
//     logits after the product (H^-0.5 is no power of two: q * scale
//     rounded to bf16 would move the lse), then the softcap and the mask
//     in f32, the online softmax per row, and P to bf16 A fragments
//     straight from the logits' registers (the C layout of two adjacent
//     8-key blocks is the A layout of one 16-key block);
//   - a step needs no mask when it is wholly inside the diagonal and the
//     window, its rows and keys in range, and every row and key carries
//     one segment id; a warp skips a step none of its pairs attend (past
//     the diagonal, behind the window, or padding under seg_pad_zero: the
//     skip contract of flash_tc.cuh, which K7 and K8 share), and a block
//     whose rows are all padding writes zeros without loading anything;
//   - causal q tiles start longest first (reverse order on the grid's
//     slowest axis), so short tiles fill the last wave: measured 2.7 %
//     faster at the training shapes and 15 % at the ragged serve's than
//     index order (flash_tc.cuh, q_tile);
//   - mma.sync and not wgmma: mma.sync's fragments need no shared-memory
//     descriptors or swizzled layouts, so the kernel can be read against
//     the formulas; wgmma (and TMA) is the step after this one.
// Shared memory: 128 query rows plus two stages of 32 K and V rows, rows
// of H + 8 bf16: 69,888 B at H = 128, 135,424 B at H = 256.
//
// float32 (flash_fwd_kernel) keeps a design of its own on the CUDA
// cores on purpose: the tensor cores would take f32 as TF32, and the f32
// parity drives hold K3 to 1e-4. What that design does:
//   - one block per (q tile of BQ=64 rows, q head, batch); a loop over kv
//     tiles of BK=32 keys replaces Pallas's sequential kv grid axis, with the
//     softmax state (m, l, acc) in registers across the loop;
//   - register tiling: each of the 256 threads owns 4 query rows x 2 keys of
//     the score tile and 4 rows x H/16 columns of the output accumulator, so
//     a shared-memory read feeds several FMAs;
//   - tiles with nothing to attend are skipped whole: kv tiles past the
//     causal diagonal or wholly behind the window, and, under seg_pad_zero,
//     tiles whose query rows or key columns are all padding (segment id 0),
//     so a ragged prefill burst pays each row's own length, not the bucket's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tc.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;       // [B, N, Sq] or null
  const int* qseg;  // [B, Sq] or null
  const int* kseg;  // [B, Skv] or null
  const int* qpos;  // [B, Sq] explicit positions, or null
  const int* kpos;  // [B, Skv]
  int Sq, Skv, N, K;
  int causal, q_offset, window, seg_pad_zero;
  float softcap, scale;
  // bf16 with positions (flash_fwd_pos_tc_kernel) and its merge: queries
  // per block, splits in the grid, live steps per split, the float32
  // partials [n_splits, B, Sq, N, HD] / [.., 2] (m, l) and each (row, q
  // tile) block's active splits [B, ceil(Sq / tq)] (null with one split).
  int tq, n_splits, split_steps, B;
  float* o_part;
  float* ml_part;
  int* n_act;
};

// Explicit positions add the tile's q and kv positions, live_steps'
// three reduction ints and its step list (n_kt ints).
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}
constexpr size_t pos_smem_f32(int n_kt) { return sizeof(int) * (BQ + BK + 4 + n_kt); }

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int HC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][HD+1], pre-scaled by H^-0.5
  float* Ks = Qs + BQ * (HD + 1);      // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* Ps = Vs + BK * HD;            // [BQ][BK+1] probabilities
  int* qseg_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BQ]
  int* kseg_s = qseg_s + BQ;                                 // [BK]
  int* qpos_s = kseg_s + BK;                                 // [BQ] (positions)
  int* kpos_s = qpos_s + BQ;                                 // [BK]
  int* red = kpos_s + BK;                                    // [4]
  int* steps = red + 4;                                      // [n_kt]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (a.N / a.K);
  const int rg = tid / 16, cg = tid % 16;
  const int r0 = rg * 4;
  const bool has_seg = a.qseg != nullptr;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, h = i % HD, s = q0 + r;
    float x = 0.f;
    if (s < a.Sq) x = q[((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + h];
    Qs[r * (HD + 1) + h] = x * a.scale;
  }
  const bool has_pos = a.qpos != nullptr;
  if (tid < BQ) {
    const int s = q0 + tid;
    qseg_s[tid] = (has_seg && s < a.Sq) ? a.qseg[static_cast<int64_t>(b) * a.Sq + s] : 0;
    if (has_pos) qpos_s[tid] = s < a.Sq ? a.qpos[static_cast<int64_t>(b) * a.Sq + s] : 0;
  }
  const int q_live = __syncthreads_or(tid < BQ && qseg_s[tid] > 0);
  const bool skip_pad = has_seg && a.seg_pad_zero;

  // kv tile range: causal tiles past the diagonal and window tiles wholly
  // behind it contribute nothing to any row of this tile.
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
  if (has_pos) {
    // The tile's live key steps from the positions (flash_tc.cuh).
    const ftc::Mask m{a.Sq, a.Skv, a.causal, a.q_offset, a.window, has_seg, skip_pad,
                      a.qpos, a.kpos};
    n_iter = ftc::live_steps(m, a.kseg, b, q0, BQ, !skip_pad || q_live, steps, red);
  }

  float acc[4][HC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (has_pos ? steps[it] : kt_begin + it) * BK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps/kseg_s are done
    if (tid < BK) {
      const int c = k0 + tid;
      kseg_s[tid] = (has_seg && c < a.Skv) ? a.kseg[static_cast<int64_t>(b) * a.Skv + c] : 0;
      if (has_pos) kpos_s[tid] = c < a.Skv ? a.kpos[static_cast<int64_t>(b) * a.Skv + c] : 0;
    }
    const int kv_live = __syncthreads_or(tid < BK && kseg_s[tid] > 0);
    if (skip_pad && !(kv_live && q_live)) continue;  // uniform over the block

    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, h = i % HD, s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < a.Skv) {
        const int64_t g = ((static_cast<int64_t>(b) * a.Skv + s) * a.K + kvh) * HD + h;
        kx = k[g];
        vx = v[g];
      }
      Ks[c * (HD + 1) + h] = kx;
      Vs[c * HD + h] = vx;
    }
    __syncthreads();

    // Scores for rows r0..r0+3 and keys cg, cg+16 of this tile.
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
    for (int h = 0; h < HD; ++h) {
      const float k0v = Ks[cg * (HD + 1) + h];
      const float k1v = Ks[(cg + 16) * (HD + 1) + h];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(r0 + i) * (HD + 1) + h];
        sc[i][0] = fmaf(qv, k0v, sc[i][0]);
        sc[i][1] = fmaf(qv, k1v, sc[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      const int qpos = q0 + r + a.q_offset;
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = cg + 16 * j;
        const int c = k0 + cl;
        float z = sc[i][j];
        if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
        bool keep = c < a.Skv;
        if (a.causal) {
          const int d = has_pos ? qpos_s[r] - kpos_s[cl] : qpos - c;
          keep = keep && d >= 0;
          if (a.window > 0) keep = keep && d < a.window;
        }
        if (has_seg) keep = keep && qseg_s[r] == kseg_s[cl];
        ok[j] = keep;
        sc[i][j] = keep ? z : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[r * (BK + 1) + cg + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + ps;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(r0 + i) * (BK + 1) + c];
#pragma unroll
      for (int hc = 0; hc < HC; ++hc) {
        const float vv = Vs[c * HD + cg + 16 * hc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][hc] = fmaf(p[i], vv, acc[i][hc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + r0 + i;
    if (s >= a.Sq) continue;
    const float l_safe = l_i[i] == 0.f ? 1.f : l_i[i];
    float* orow = o + ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD;
#pragma unroll
    for (int hc = 0; hc < HC; ++hc) orow[cg + 16 * hc] = acc[i][hc] / l_safe;
    // m_i / l_i are equal across the 16 threads of a row group (shuffle-reduced).
    if (a.lse != nullptr && cg == 0) {
      a.lse[(static_cast<int64_t>(b) * a.N + n) * a.Sq + s] =
          l_i[i] == 0.f ? NEG_INF : m_i[i] + logf(l_i[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the same function on the tensor cores (see the note at the top
// of the file and flash_tc.cuh).
template <int HD>
__global__ void __launch_bounds__(ftc::NT, ftc::min_blocks<HD>()) flash_fwd_tc_kernel(Args a) {
  using ftc::KB;
  using ftc::ROWS;
  constexpr int LD = HD + 8;
  constexpr int NH = HD / 8;  // 8-column blocks of the output per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][LD]
  __nv_bfloat16* ring = qs + ROWS * LD;                // [2][K [KB][LD], V [KB][LD]]
  int* kseg_ring = reinterpret_cast<int*>(ring + 2 * 2 * KB * LD);  // [2][KB]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const ftc::Mask m{a.Sq, a.Skv, a.causal, a.q_offset, a.window, a.qseg != nullptr,
                    a.qseg != nullptr && a.seg_pad_zero != 0};
  const int n = blockIdx.x, b = blockIdx.y;
  const int q0 = ftc::q_tile<true>(m) * ROWS;
  const int kvh = n / (a.N / a.K);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  ftc::Rows rows;
  const bool any_live = ftc::load_rows(m, a.qseg, b, q0, rows);
  int kt_begin, kt_end;
  ftc::step_range(m, q0, kt_begin, kt_end);
  if (!any_live) kt_end = kt_begin;  // every row padding: zeros out
  const int n_steps = kt_end - kt_begin;

  if (n_steps > 0) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int idx = tid; idx < ROWS * (HD / 8); idx += ftc::NT) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, s = q0 + r;
      const bool in = s < a.Sq;
      const int64_t off = in ? ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + c : 0;
      tc::cp16(qs + r * LD + c, q + off, in);
    }
    ftc::load_step<HD>(m, k, v, a.kseg, b, kvh, a.K, kt_begin * KB, ring, kseg_ring);
    tc::cp_commit();
  }

  float o[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {ftc::NEG_INF, ftc::NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    tc::cp_wait_all();
    __syncthreads();  // step i staged; every read of the previous step done
    if (i + 1 < n_steps)
      ftc::load_step<HD>(m, k, v, a.kseg, b, kvh, a.K, (kt_begin + i + 1) * KB,
                         ring + (st ^ 1) * 2 * KB * LD, kseg_ring + (st ^ 1) * KB);
    tc::cp_commit();
    const __nv_bfloat16* kt = ring + st * 2 * KB * LD;
    const __nv_bfloat16* vt = kt + KB * LD;
    const int* ks = kseg_ring + st * KB;
    const int k0 = (kt_begin + i) * KB;
    const ftc::Step step = ftc::classify(m, rows, k0, ks);
    if (step.dead) continue;  // uniform over the warp

    // S = Q . K^T for the warp's 16 rows x 32 keys.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4];
      tc::load_a(qa, qs, LD, warp * 16, kk, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t kb4[4];
        tc::load_b_nk(kb4, kt, LD, jp * 16, kk, lane);
        tc::mma(s[2 * jp], qa, kb4[0], kb4[1]);
        tc::mma(s[2 * jp + 1], qa, kb4[2], kb4[3]);
      }
    }

    // Scale and softcap in f32, the mask as -inf where needed, then the
    // online softmax per row (a row's four lanes reduce by shuffles).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        float z = s[j][e4] * a.scale;
        if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
        if (!step.full) {
          const int h = e4 >> 1, cl = j * 8 + 2 * tig + (e4 & 1);
          if (!ftc::keep(m, rows.r0 + grp + 8 * h, rows.qseg[h], k0 + cl, ks[cl])) z = -INFINITY;
        }
        s[j][e4] = z;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(ftc::FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(ftc::FULL, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: m_run starts at NEG_INF
      alpha[h] = tc::exp_(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const float p = tc::exp_(s[j][e4] - m_run[e4 >> 1]);  // 0 for a masked key
        sum[e4 >> 1] += p;
        s[j][e4] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(ftc::FULL, sum[h], 1);
      sum[h] += __shfl_xor_sync(ftc::FULL, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P . V, P from the logits' registers as bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < NH / 2; ++jp) {
        uint32_t vb[4];
        tc::load_b_kn(vb, vt, LD, kk * 16, jp * 16, lane);
        tc::mma(o[2 * jp], pa, vb[0], vb[1]);
        tc::mma(o[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  tc::cp_wait_all();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = rows.r0 + grp + 8 * h;
    if (qi >= a.Sq) continue;
    const float inv = 1.f / (l_run[h] == 0.f ? 1.f : l_run[h]);
    const int64_t row = (static_cast<int64_t>(b) * a.Sq + qi) * a.N + n;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      *reinterpret_cast<uint32_t*>(out + row * HD + j * 8 + 2 * tig) =
          tc::pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
    // m_run / l_run are equal across the four lanes of a row.
    if (a.lse != nullptr && tig == 0) {
      a.lse[(static_cast<int64_t>(b) * a.N + n) * a.Sq + qi] =
          l_run[h] == 0.f ? NEG_INF : m_run[h] + logf(l_run[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 with explicit positions: the group's G query heads packed into
// one block, its live key steps split across blocks, and a merge (see the
// note at the top of the file).

// One key step of K3's bf16 forward for the warp's 16 rows (rows warp * 16
// .. + 15 of the Q tile qs) against the staged K and V (kt, vt; rows of HD
// + 8): S = Q . K^T with mma.sync, the scale and softcap in f32 (H^-0.5 is
// no power of two: q * scale rounded to bf16 would move the lse), where the
// step is not full the mask as -inf (keep(h, cl): the thread's row grp + 8h
// against key cl of the step), the online softmax per row (m_run, l_run;
// a row's four lanes reduce by shuffles), and O += P . V with P as bf16 A
// fragments straight from the logits' registers (the C layout of two
// adjacent 8-key blocks is the A layout of one 16-key block). It is the
// index kernel's loop body, operation for operation, so identity positions
// on one split give the index path's bits (the identity check holds them
// bitwise); the index kernel keeps its copy inline, where calling this one
// measured slower.
template <int HD, typename Keep>
__device__ __forceinline__ void attend_step(const __nv_bfloat16* qs, const __nv_bfloat16* kt,
                                            const __nv_bfloat16* vt, bool full, float scale,
                                            float softcap, float (&o)[HD / 8][4],
                                            float (&m_run)[2], float (&l_run)[2], Keep keep) {
  constexpr int LD = HD + 8;
  constexpr int NH = HD / 8;  // 8-column blocks of the output per warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // S = Q . K^T for the warp's 16 rows x 32 keys.
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t qa[4];
    tc::load_a(qa, qs, LD, warp * 16, kk, lane);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t kb4[4];
      tc::load_b_nk(kb4, kt, LD, jp * 16, kk, lane);
      tc::mma(s[2 * jp], qa, kb4[0], kb4[1]);
      tc::mma(s[2 * jp + 1], qa, kb4[2], kb4[3]);
    }
  }

  const int tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      float z = s[j][e4] * scale;
      if (softcap > 0.f) z = softcap * tanhf(z / softcap);
      if (!full && !keep(e4 >> 1, j * 8 + 2 * tig + (e4 & 1))) z = -INFINITY;
      s[j][e4] = z;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(ftc::FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(ftc::FULL, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);  // finite: m_run starts at NEG_INF
    alpha[h] = tc::exp_(m_run[h] - m_new);
    m_run[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      const float p = tc::exp_(s[j][e4] - m_run[e4 >> 1]);  // 0 for a masked key
      sum[e4 >> 1] += p;
      s[j][e4] = p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(ftc::FULL, sum[h], 1);
    sum[h] += __shfl_xor_sync(ftc::FULL, sum[h], 2);
    l_run[h] = l_run[h] * alpha[h] + sum[h];
  }
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }

  // O += P . V.
#pragma unroll
  for (int kk = 0; kk < ftc::KB / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int jp = 0; jp < NH / 2; ++jp) {
      uint32_t vb[4];
      tc::load_b_kn(vb, vt, LD, kk * 16, jp * 16, lane);
      tc::mma(o[2 * jp], pa, vb[0], vb[1]);
      tc::mma(o[2 * jp + 1], pa, vb[2], vb[3]);
    }
  }
}

// Splits that walk a block's n_live live steps: one per split_steps, at
// least one, at most the grid's (ops/flash_pos.py active_splits).
__device__ __forceinline__ int active_splits(const Args& a, int n_live) {
  return min(a.n_splits, max(1, (n_live + a.split_steps - 1) / a.split_steps));
}

template <int HD>
__global__ void __launch_bounds__(ftc::NT, ftc::min_blocks<HD>()) flash_fwd_pos_tc_kernel(Args a) {
  using ftc::KB;
  using ftc::ROWS;
  constexpr int LD = HD + 8;
  constexpr int NH = HD / 8;  // 8-column blocks of the output per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][LD]
  __nv_bfloat16* ring = qs + ROWS * LD;                // [2][K [KB][LD], V [KB][LD]]
  int* kseg_ring = reinterpret_cast<int*>(ring + 2 * 2 * KB * LD);  // [2][KB]
  int* kpos_ring = kseg_ring + 2 * KB;  // [2][KB]
  ftc::WarpFacts* wf = reinterpret_cast<ftc::WarpFacts*>(kpos_ring + 2 * KB);  // [8]
  int* red = reinterpret_cast<int*>(wf + ftc::NT / 32);  // [4]
  int* steps = red + 4;                                  // [n_kt]
  int* facts = steps + (a.Skv + KB - 1) / KB;            // [n_kt][3]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tig = lane & 3;
  const ftc::Mask m{a.Sq, a.Skv, a.causal, 0, a.window, a.qseg != nullptr,
                    a.qseg != nullptr && a.seg_pad_zero != 0, a.qpos, a.kpos};
  const int G = a.N / a.K, tq = a.tq;
  const int qt = blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z / a.n_splits, split = blockIdx.z % a.n_splits;
  const int q0 = qt * tq;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  // Every split of the block lists the same live steps and takes its
  // share of them; splits past the block's active ones have nothing.
  ftc::PackRows rows;
  const bool any_live = ftc::load_packed_rows(m, a.qseg, b, q0, tq, G, rows, wf);
  const int n_live =
      any_live ? ftc::live_steps(m, a.kseg, b, q0, tq, true, steps, red, facts) : 0;
  const int n_act = active_splits(a, n_live);
  if (split >= n_act) return;  // uniform over the block
  if (a.n_act != nullptr && split == 0 && kvh == 0 && tid == 0)
    a.n_act[static_cast<int64_t>(b) * gridDim.x + qt] = n_act;
  const int i0 = split * n_live / n_act;
  const int n_steps = (split + 1) * n_live / n_act - i0;

  if (n_steps > 0) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int idx = tid; idx < ROWS * (HD / 8); idx += ftc::NT) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int g = r / tq, s = q0 + r % tq;
      const bool in = g < G && s < a.Sq;
      const int64_t off =
          in ? ((static_cast<int64_t>(b) * a.Sq + s) * a.N + kvh * G + g) * HD + c : 0;
      tc::cp16(qs + r * LD + c, q + off, in);
    }
    ftc::load_step<HD>(m, k, v, a.kseg, b, kvh, a.K, steps[i0] * KB, ring, kseg_ring,
                       kpos_ring);
    tc::cp_commit();
  }

  float o[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {ftc::NEG_INF, ftc::NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    tc::cp_wait_all();
    __syncthreads();  // step i staged; every read of the previous step done
    if (i + 1 < n_steps)
      ftc::load_step<HD>(m, k, v, a.kseg, b, kvh, a.K, steps[i0 + i + 1] * KB,
                         ring + (st ^ 1) * 2 * KB * LD, kseg_ring + (st ^ 1) * KB,
                         kpos_ring + (st ^ 1) * KB);
    tc::cp_commit();
    const __nv_bfloat16* kt = ring + st * 2 * KB * LD;
    const __nv_bfloat16* vt = kt + KB * LD;
    const int* ks = kseg_ring + st * KB;
    const int* kp = kpos_ring + st * KB;
    const int t = steps[i0 + i], k0 = t * KB;
    const ftc::Step step = ftc::classify_pos(m, wf[warp], k0, facts + 3 * t);
    if (step.dead) continue;  // uniform over the warp
    attend_step<HD>(qs, kt, vt, step.full, a.scale, a.softcap, o, m_run, l_run,
                         [&](int h, int cl) {
                           return ftc::keep(m, rows.qi[h], rows.qseg[h], k0 + cl, ks[cl],
                                            rows.qp[h], kp[cl]);
                         });
  }
  tc::cp_wait_all();

  // The rows: normalized into o (and lse) when the block's walk has one
  // active split, else this split's partial (O unnormalized, m, l).
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = ftc::packed_row(h) / tq;
    if (g >= G || rows.qi[h] >= a.Sq) continue;
    const int n = kvh * G + g;
    const int64_t row = (static_cast<int64_t>(b) * a.Sq + rows.qi[h]) * a.N + n;
    if (n_act == 1) {
      const float inv = 1.f / (l_run[h] == 0.f ? 1.f : l_run[h]);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        *reinterpret_cast<uint32_t*>(out + row * HD + j * 8 + 2 * tig) =
            tc::pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      }
      // m_run / l_run are equal across the four lanes of a row.
      if (a.lse != nullptr && tig == 0) {
        a.lse[(static_cast<int64_t>(b) * a.N + n) * a.Sq + rows.qi[h]] =
            l_run[h] == 0.f ? NEG_INF : m_run[h] + logf(l_run[h]);
      }
    } else {
      const int64_t prow = static_cast<int64_t>(split) * a.B * a.Sq * a.N + row;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        *reinterpret_cast<float2*>(a.o_part + prow * HD + j * 8 + 2 * tig) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      }
      if (tig == 0) *reinterpret_cast<float2*>(a.ml_part + 2 * prow) = make_float2(m_run[h], l_run[h]);
    }
  }
}

// The merge of the splits' partials, in split order (deterministic): one
// block per (query, row), a warp per head, a lane per column c * 32 + lane
// (coalesced); each split's weight exp(m - max m) is taken once per head.
// The heads of a (row, q tile) block whose walk had one active split were
// written by the kernel itself.
template <int HD>
__global__ void __launch_bounds__(NT) flash_pos_merge_kernel(Args a) {
  constexpr int CPL = HD >= 32 ? HD / 32 : 1;  // columns per lane
  const int s = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_act = a.n_act[static_cast<int64_t>(b) * ((a.Sq + a.tq - 1) / a.tq) + s / a.tq];
  if (n_act <= 1) return;
  const int64_t plane = static_cast<int64_t>(a.B) * a.Sq * a.N;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  for (int n = warp; n < a.N; n += NT / 32) {
    const int64_t row = (static_cast<int64_t>(b) * a.Sq + s) * a.N + n;
    float mx = NEG_INF;
    for (int sp = 0; sp < n_act; ++sp) mx = fmaxf(mx, a.ml_part[2 * (sp * plane + row)]);
    float l = 0.f, acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_act; ++sp) {
      const int64_t pr = sp * plane + row;
      const float w = expf(a.ml_part[2 * pr] - mx);
      l += a.ml_part[2 * pr + 1] * w;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c * 32 + lane < HD) acc[c] += a.o_part[pr * HD + c * 32 + lane] * w;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (c * 32 + lane < HD)
        out[row * HD + c * 32 + lane] = __float2bfloat16(l == 0.f ? 0.f : acc[c] / l);
    if (a.lse != nullptr && lane == 0)
      a.lse[(static_cast<int64_t>(b) * a.N + n) * a.Sq + s] = l == 0.f ? NEG_INF : mx + logf(l);
  }
}

// bf16 without positions: the tensor-core kernel; float32, with or without
// positions: flash_fwd_kernel (CUDA cores), whose positions add the step
// list (n_kt ints) to its shared memory. bf16 with positions goes through
// launch_pos.
template <int HD>
cudaError_t launch(const Args& a, int B, bool bf16, cudaStream_t stream) {
  const bool pos = a.qpos != nullptr;
  if (bf16) {
    if (pos) return cudaErrorInvalidValue;
    const size_t smem = sizeof(__nv_bfloat16) * (ftc::ROWS + 2 * 2 * ftc::KB) * (HD + 8) +
                        sizeof(int) * 2 * ftc::KB;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(a.N, B, (a.Sq + ftc::ROWS - 1) / ftc::ROWS);
    flash_fwd_tc_kernel<HD><<<grid, ftc::NT, smem, stream>>>(a);
  } else {
    const int n_kt = (a.Skv + BK - 1) / BK;
    const size_t smem = smem_bytes<HD>() + (pos ? pos_smem_f32(n_kt) : 0);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
    flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// bf16 with positions: the split kernel. Its shared memory adds the kv
// positions' ring, the warps' facts, and the step list with each step's
// facts (4 n_kt ints) to the index kernel's.
template <int HD>
cudaError_t launch_pos(const Args& a, int B, cudaStream_t stream) {
  const int n_kt = (a.Skv + ftc::KB - 1) / ftc::KB;
  const size_t smem = sizeof(__nv_bfloat16) * (ftc::ROWS + 2 * 2 * ftc::KB) * (HD + 8) +
                      sizeof(int) * (2 * 2 * ftc::KB + 4 + 4 * n_kt) +
                      sizeof(ftc::WarpFacts) * (ftc::NT / 32);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_pos_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + a.tq - 1) / a.tq, a.K, B * a.n_splits);
  flash_fwd_pos_tc_kernel<HD><<<grid, ftc::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_merge(const Args& a, int B, cudaStream_t stream) {
  dim3 grid(a.Sq, B);
  flash_pos_merge_kernel<HD><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

// f(std::integral_constant<int, H>) for the compiled head dims.
template <typename F>
cudaError_t by_head_dim(int H, F f) {
  switch (H) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none;
// lse, the segment ids and the positions may be null (qpos and kpos go
// together; bf16 with positions is flash_fwd_pos). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* qseg, const int* kseg, const int* qpos, const int* kpos,
                         int B, int Sq, int Skv, int N, int K, int H, int causal, int q_offset,
                         int window, int seg_pad_zero, float softcap, float scale, int dtype,
                         void* stream) {
  Args a{q, k, v, o, lse, qseg, kseg, qpos, kpos, Sq, Skv, N, K, causal, q_offset, window,
         seg_pad_zero, softcap, scale};
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  return static_cast<int>(by_head_dim(H, [&](auto hd) {
    return launch<decltype(hd)::value>(a, B, bf16, s);
  }));
}

// bfloat16 with explicit positions (qpos, kpos required): the split
// kernel, tq queries of each of the G = N / K heads of a kv head per block
// (a power of two, tq * G <= 128), n_splits splits in the grid of
// split_steps live key steps each. With n_splits > 1, o_part / ml_part
// ([n_splits, B, Sq, N, H] / [.., 2] float32) and n_act ([B, ceil(Sq /
// tq)] int32) take the partials of blocks with more than one active split,
// and flash_pos_merge then combines them. Other arguments as flash_fwd's
// (q_offset unused; dtype must be 1). Returns cudaGetLastError() after the
// launch.
extern "C" int flash_fwd_pos(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int* qseg, const int* kseg, const int* qpos,
                             const int* kpos, float* o_part, float* ml_part, int* n_act,
                             int tq, int n_splits, int split_steps, int B, int Sq, int Skv,
                             int N, int K, int H, int causal, int q_offset, int window,
                             int seg_pad_zero, float softcap, float scale, int dtype,
                             void* stream) {
  Args a{q, k, v, o, lse, qseg, kseg, qpos, kpos, Sq, Skv, N, K, causal, 0, window,
         seg_pad_zero, softcap, scale, tq, n_splits, split_steps, B, o_part, ml_part, n_act};
  (void)q_offset;
  if (B == 0 || Sq == 0) return 0;
  if (dtype != 1 || qpos == nullptr || kpos == nullptr || K < 1 || N % K || tq < 1 ||
      (tq & (tq - 1)) || tq * (N / K) > ftc::ROWS || n_splits < 1 || split_steps < 1 ||
      (n_splits > 1 && (o_part == nullptr || ml_part == nullptr || n_act == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dim(H, [&](auto hd) {
    return launch_pos<decltype(hd)::value>(a, B, s);
  }));
}

// The split kernel's merge: out [B, Sq, N, H] bf16 (and, with a non-null
// lse, lse [B, N, Sq] float32) of every (row, q tile) block with more than
// one active split, from the partials flash_fwd_pos wrote; other rows are
// left as they are. Returns cudaGetLastError() after the launch.
extern "C" int flash_pos_merge(const float* o_part, const float* ml_part, const int* n_act,
                               void* out, float* lse, int B, int Sq, int N, int H, int tq,
                               int n_splits, void* stream) {
  Args a{};
  a.o_part = const_cast<float*>(o_part);
  a.ml_part = const_cast<float*>(ml_part);
  a.n_act = const_cast<int*>(n_act);
  a.o = out;
  a.lse = lse;
  a.B = B;
  a.Sq = Sq;
  a.N = N;
  a.tq = tq;
  a.n_splits = n_splits;
  if (B == 0 || Sq == 0) return 0;
  if (tq < 1 || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dim(H, [&](auto hd) {
    return launch_merge<decltype(hd)::value>(a, B, s);
  }));
}
