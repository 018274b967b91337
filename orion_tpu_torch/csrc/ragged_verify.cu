// K10: ragged paged attention for speculative verification, the W new
// tokens' K/V written in place, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/ragged_paged_attention.py::
// _kernel (the pl.pallas_call in _call), both of its pool branches, chain and
// tree masks: slot b holds lens[b] >= 1 real queries at positions start[b] +
// j; their K/V are written into the flat [L*num_pages, K, psz, HD] pool at
// row layer_base + page_table[b, pos / psz], column pos % psz, for pos <=
// last = min(start + lens - 1, P*psz - 1); then every query attends the
// slot's pages, the drafts of the same dispatch included (chain: kv_pos <=
// start + w; tree: the context below start plus the new slots its ancestor
// word names), under a window and a softcap where given.
//
// What bounds it on an H100: bytes, as for K4. A verify step attends the same
// pages a decode step does, now for W queries instead of one: about 2*W*G
// flops per byte of bf16 K/V (4*W*G for int8), still far below the ridge
// point for W*G = 20. Every page is read once for all W*G query rows of its
// kv head, the amortization that is the point of verifying drafts in one
// pass. For bfloat16 q (bf16 and int8 pools; ragged_verify_tc_kernel) the
// design is K4's (csrc/paged_decode.cu), whose page walk it shares
// (csrc/paged_tc.cuh), widened from G heads to W*G query rows:
//   - the page walk is split across the grid: one block of four warps per
//     (split of SPLIT_PAGES pages, kv head, slot). The number of splits
//     comes from the page table's width alone (the host reads no device
//     data, so the step can be captured by a CUDA graph). A slot's walk
//     covers [walk_lo, last], walk_lo = max(0, start - window + 1) under a
//     window, else 0: the earliest position any query may see, chain or
//     tree (a tree query at depth d sees context from start + d - window +
//     1, and d >= 0). Splits outside it exit at once. A slot with one
//     active split writes its normalized output directly; otherwise every
//     active split writes a float32 partial for EVERY query row (O
//     unnormalized, m, l; a row that sees none of the split's keys leaves
//     m = NEG_INF, l = 0, O = 0) to scratch the wrapper allocates, and
//     ragged_verify_merge_kernel combines a slot's partials in split order
//     (deterministic, no atomics), over the split range this kernel's plan
//     gives, not per query;
//   - the drafts are written by their owning split: each split writes the
//     real tokens whose positions fall in its own keys ([start, last] within
//     [split * SPLIT_PAGES * psz, (split + 1) * ...)), raw or under int8
//     with quantize_kv's bits, one warp per (token, K or V), before it
//     stages any page; a __syncthreads() orders those st.global before its
//     cp.async reads (both in the generic proxy), so the walk reads the
//     drafts back as the pool holds them (dequantized under int8, exactly as
//     a later decode reads them). Split boundaries are page boundaries, so
//     no other split reads those pages; drafts straddling a split boundary
//     are written part by each split, and each reads back only its part.
//     Padding tokens (j >= lens) and positions past the table write nothing;
//   - inside a block the warps form KL = 2 key lanes x RG = 2 row groups.
//     A key lane owns every KL-th 32-key step of the split and its own
//     online softmax per row; its steps stream through its own two-stage
//     ring by 16-byte cp.async, each key's page id resolved a step ahead,
//     row group 0 staging K and row group 1 V (int8: raw, with their
//     scales, each then converting its half to bf16 by the magic-bias path,
//     exact for |q| <= 127). The two warps of a key lane meet at a named
//     barrier (bar.sync over their 64 threads) once a step, twice under
//     int8, so the next step's load overlaps this step's products and no
//     block-wide barrier runs in the walk. Each warp serves its row group's
//     row tiles against every key the lane stages; the key lanes' states
//     are merged once, in lane order, at the end;
//   - S = Q.K^T and O += P.V on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate). The W*G query rows of a kv head are packed r = w*G + g
//     (the JAX kernel's layout) into m16 row tiles, zero-padded: 20 rows, two
//     tiles, at Llama-3-8B. The scale goes on the f32 logits (H^-0.5 is no
//     power of two at H = 128), then the K scale, the softcap, and the mask
//     inside the exponential; P (times the V scale under int8) goes to bf16
//     A fragments from the logits' registers. The per-(row, key) mask is
//     evaluated only on steps that reach start, the split's edges or a
//     window's edge; on the others every key is kept for every row. A
//     row's mask is two words in shared memory: chain [lo, hi]; tree the
//     context's lower edge lo and a bit per draft slot (ancestors and
//     itself, less those the window drops), so a chain-shaped tree keeps the
//     same keys as the chain and gives the same bits;
//   - registers, where K10 differs from K4: a warp holds the O of every row
//     tile it serves, 64 f32 registers per tile at H = 128, and W*G rows can
//     need up to eight tiles (W = 31) or more. So the tiles are spread over
//     the row groups, and the rows are looped: a block serves its rows in
//     passes of pass_mt<HD>() tiles (two at H = 128 and 256, one a warp;
//     128 / H a warp below 128, 64 f32 registers of O), each pass walking
//     the split's keys anew (a second pass reads its pages from L2). At the
//     serve's W*G = 20 one pass holds both tiles and reads every page once.
//     Shared memory (one pass's query tile, the rings, the row masks) does
//     not grow with W: static_asserts hold it, so the bf16 kernel takes any
//     W (the tree's ancestor words cap a tree at 31).
// mma.sync and not wgmma/TMA for K4's reasons: a row tile of a verify step
// is 16-32 rows, below wgmma's 64, and the loads are a gather over page ids.
// Idle slots point at scratch page 0, so several blocks may write page 0 at
// once, in no order; page 0 is never read for a live slot, and callers
// comparing pools or outputs exclude it and the pad rows.
//
// float32 q (the f32 parity drives) keeps the first version's design on the
// CUDA cores (ragged_verify_kernel), which those drives hold to 1e-4 against
// the CPU: one block per (slot, kv head) serves all W*G query rows, writes
// the W tokens' K/V first (one warp per token row, int8 with quantize_kv's
// bits), then walks the slot's pages 0 .. last / psz (less those wholly
// behind the earliest query's window) with the per-row online-softmax state
// and the output accumulators in shared memory (W*G*HD floats each) and the
// logits as f32 FMAs over the K page held in shared memory. Shared memory is
// its limit on W: verify_smem_bytes in ops/ragged_paged_attention.py mirrors
// smem_floats below, and check_verify_fit rejects a float32 model's
// speculate_tokens whose block would not fit.
// Must not be built with --use_fast_math (IEEE divide in the quantization).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "paged_tc.cuh"
#include "tc.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);
// Pages per split of the bf16 kernel's walk (ops/ragged_paged_attention.py
// VERIFY_SPLIT_PAGES mirrors it; the launcher refuses a grid of another
// width): K4's size, timed there against 4 and 16 (PERF.md, PR 7).
constexpr int SPLIT_PAGES = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

struct Args {
  const void* q;          // [B, W, N, HD]
  void* k_pool;           // [rows, K, psz, HD]
  void* v_pool;
  float* k_scale;         // [rows, K, SW] (int8 pools) or null
  float* v_scale;
  const void* k_new;      // [B, W, K, HD] or null (no write)
  const void* v_new;
  const int* page_table;  // [B, P]
  const int* start;       // [B]
  const int* lens;        // [B]
  const int* words;       // [B, W] ancestor words, or null (chain)
  const int* depths;      // [B, W] tree depths (with words)
  void* out;              // [B, W, N, HD]
  int W, N, K, psz, P, SW;
  int64_t layer_base;
  int window;
  float softcap, scale;
  // bf16 kernel and merge: splits in the grid, slots, and the f32 partials
  // [n_splits, B, W, N, HD] / [.., 2] (m, l) of slots whose walk spans more
  // than one split.
  int n_splits, B;
  float* o_part;
  float* ml_part;
};

// float32 kernel: floats of shared memory for R = W*G query rows (the
// Python fit check mirrors this count).
__host__ __device__ inline size_t smem_floats(int R, int HD, int psz, int W) {
  return static_cast<size_t>(2 * R * HD + psz * (2 * HD + 1) + R * psz + 3 * R + 2 * psz +
                             2 * W);
}

// quantize_kv of one HD-vector by one warp: dst (int8) and *scale_dst.
template <int HD>
__device__ void quantize_row_warp(const float* src, int8_t* dst, float* scale_dst, int lane) {
  float amax = 0.f;
  for (int h = lane; h < HD; h += 32) amax = fmaxf(amax, fabsf(src[h]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax * INV127, 1e-8f);
  for (int h = lane; h < HD; h += 32) {
    dst[h] = static_cast<int8_t>(static_cast<int>(rintf(src[h] / s)));
  }
  if (lane == 0) *scale_dst = s;
}

// float32 q; TP is the pool's type (float or int8).
template <typename TP, int HD>
__global__ void __launch_bounds__(NT) ragged_verify_kernel(Args a) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  const int W = a.W;
  const int G = a.N / a.K;
  const int R = W * G;
  const int psz = a.psz;
  extern __shared__ float sm[];
  float* Qs = sm;                      // [R][HD], pre-scaled by HD^-0.5
  float* Acc = Qs + R * HD;            // [R][HD] output accumulators
  float* Ks = Acc + R * HD;            // [psz][HD+1]
  float* Vs = Ks + psz * (HD + 1);     // [psz][HD]
  float* Ss = Vs + psz * HD;           // [R][psz] logits, then probabilities
  float* m_s = Ss + R * psz;           // [R]
  float* l_s = m_s + R;                // [R]
  float* al_s = l_s + R;               // [R] this page's rescale factor
  float* ksc = al_s + R;               // [psz] this page's K scales (int8)
  float* vsc = ksc + psz;              // [psz]
  int* wd_s = reinterpret_cast<int*>(vsc + psz);  // [W] ancestor words
  int* dp_s = wd_s + W;                           // [W] depths

  TP* kp = static_cast<TP*>(a.k_pool);
  TP* vp = static_cast<TP*>(a.v_pool);
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int start = a.start[b];
  const int nlen = a.lens[b];
  const int* pt = a.page_table + static_cast<int64_t>(b) * a.P;
  const int64_t page_elems = static_cast<int64_t>(psz) * HD;
  const int max_pos = a.P * psz - 1;
  const int last = min(start + nlen - 1, max_pos);
  const bool tree = a.words != nullptr;

  // 1. The real tokens' K/V into the pool: one warp per (token, K or V).
  if (a.k_new != nullptr) {
    for (int t = warp; t < 2 * W; t += NWARP) {
      const int j = t >> 1;
      const int pos = start + j;
      if (j >= nlen || pos > last) continue;
      const int64_t row = a.layer_base + pt[pos / psz];
      const int64_t dst = (row * a.K + kvh) * page_elems + static_cast<int64_t>(pos % psz) * HD;
      const int64_t src = ((static_cast<int64_t>(b) * W + j) * a.K + kvh) * HD;
      const bool is_v = t & 1;
      const float* xn = static_cast<const float*>(is_v ? a.v_new : a.k_new) + src;
      TP* pool = is_v ? vp : kp;
      if constexpr (QUANT) {
        float* sc = (is_v ? a.v_scale : a.k_scale) + (row * a.K + kvh) * a.SW + pos % psz;
        quantize_row_warp<HD>(xn, pool + dst, sc, lane);
      } else {
        for (int h = lane; h < HD; h += 32) pool[dst + h] = xn[h];
      }
    }
  }

  // 2. Queries, softmax state, accumulators, tree words.
  for (int i = tid; i < R * HD; i += NT) {
    const int r = i / HD, h = i % HD;
    const int w = r / G, g = r % G;
    const float* q = static_cast<const float*>(a.q) +
                     ((static_cast<int64_t>(b) * W + w) * a.N + kvh * G + g) * HD;
    Qs[i] = q[h] * a.scale;
    Acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  if (tree) {
    for (int w = tid; w < W; w += NT) {
      wd_s[w] = a.words[static_cast<int64_t>(b) * W + w];
      dp_s[w] = a.depths[static_cast<int64_t>(b) * W + w];
    }
  }

  // 3. The page walk: pages 0 .. last / psz, less those wholly behind the
  // earliest query's window (the earliest visible position of any query,
  // chain or tree, is start - window + 1).
  int p_begin = 0;
  if (a.window > 0) p_begin = max(start - a.window + 1, 0) / psz;
  const int p_end = last / psz;
  for (int pg = p_begin; pg <= p_end; ++pg) {
    __syncthreads();  // the writes above / the previous page's reads
    const int64_t prow = (a.layer_base + pt[pg]) * a.K + kvh;
    const int64_t base = prow * page_elems;
    for (int i = tid; i < psz * HD; i += NT) {
      const int c = i / HD, h = i % HD;
      Ks[c * (HD + 1) + h] = to_f32(kp[base + i]);
      Vs[i] = to_f32(vp[base + i]);
    }
    if constexpr (QUANT) {
      for (int c = tid; c < psz; c += NT) {
        ksc[c] = a.k_scale[prow * a.SW + c];
        vsc[c] = a.v_scale[prow * a.SW + c];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * psz; idx += NT) {
      const int r = idx / psz, c = idx % psz;
      const int w = r / G;
      const int pos = pg * psz + c;
      bool keep;
      if (!tree) {
        const int qp = start + w;
        keep = pos <= qp && (a.window <= 0 || pos >= qp - a.window + 1);
      } else {
        const int slot = pos - start;
        const int qd = dp_s[w];
        if (slot >= 0 && slot < W) {
          const unsigned word = static_cast<unsigned>(wd_s[w]);
          keep = ((word >> min(slot, 31)) & 1u) || slot == w;
          if (a.window > 0) keep = keep && dp_s[slot] >= qd - a.window + 1;
        } else {
          keep = pos < start;
          if (a.window > 0) keep = keep && pos >= start + qd - a.window + 1;
        }
      }
      float z = -INFINITY;  // -inf marks a masked column
      if (keep) {
        const float* qr = Qs + r * HD;
        const float* kc = Ks + c * (HD + 1);
        float d = 0.f;
#pragma unroll 8
        for (int h = 0; h < HD; ++h) d = fmaf(qr[h], kc[h], d);
        if constexpr (QUANT) d *= ksc[c];
        if (a.softcap > 0.f) d = a.softcap * tanhf(d / a.softcap);
        z = d;
      }
      Ss[idx] = z;
    }
    __syncthreads();

    for (int r = warp; r < R; r += NWARP) {
      float mx = NEG_INF;
      for (int c = lane; c < psz; c += 32) mx = fmaxf(mx, Ss[r * psz + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < psz; c += 32) {
        const float z = Ss[r * psz + c];
        const float p = z == -INFINITY ? 0.f : expf(z - m_new);
        sum += p;
        // int8: the V scale folds into the probability (after the row sum).
        Ss[r * psz + c] = QUANT ? p * vsc[c] : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        al_s[r] = alpha;
      }
    }
    __syncthreads();

    // Each thread owns the same accumulators on every page: no barrier is
    // needed between reading and writing them.
    for (int o = tid; o < R * HD; o += NT) {
      const int r = o / HD, h = o % HD;
      const float* pr = Ss + r * psz;
      float x = Acc[o] * al_s[r];
      for (int c = 0; c < psz; ++c) x = fmaf(pr[c], Vs[c * HD + h], x);
      Acc[o] = x;
    }
  }
  __syncthreads();

  for (int o = tid; o < R * HD; o += NT) {
    const int r = o / HD, h = o % HD;
    const int w = r / G, g = r % G;
    const float l = l_s[r];
    float* out = static_cast<float*>(a.out) +
                 ((static_cast<int64_t>(b) * W + w) * a.N + kvh * G + g) * HD;
    out[h] = Acc[o] / (l == 0.f ? 1.f : l);
  }
}

template <typename TP, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.W * (a.N / a.K);
  const size_t smem = sizeof(float) * smem_floats(R, HD, a.psz, a.W);
  cudaError_t err = cudaFuncSetAttribute(ragged_verify_kernel<TP, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B, a.K);
  ragged_verify_kernel<TP, HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t by_head_dim(const Args& a, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 16: return launch<TP, 16>(a, B, stream);
    case 32: return launch<TP, 32>(a, B, stream);
    case 64: return launch<TP, 64>(a, B, stream);
    case 128: return launch<TP, 128>(a, B, stream);
    case 256: return launch<TP, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernel (bf16 and int8 pools) on the tensor cores: see the note at
// the top of the file.
namespace tcrv {

constexpr int KL = 2;         // key lanes: each streams every KL-th step of the split
constexpr int RG = 2;         // row groups: the warps of a key lane split its row tiles
constexpr int WARPS = KL * RG;
constexpr int NTT = 32 * WARPS;
constexpr int KEY_BLOCK = ptc::KEY_BLOCK;
// A split holds whole key steps at every page size (multiples of 16), so
// its inner steps take the unmasked path.
static_assert(SPLIT_PAGES * 16 % KEY_BLOCK == 0, "a split must hold whole key steps");

// Row tiles of 16 query rows a warp serves in a pass (64 f32 registers of
// O up to H = 128, 128 at 256), and a pass's tiles (the row groups').
template <int HD> __host__ __device__ constexpr int warp_mt() { return HD >= 128 ? 1 : 128 / HD; }
template <int HD> __host__ __device__ constexpr int pass_mt() { return RG * warp_mt<HD>(); }

// The block's shared memory: one pass's query rows and the key lanes' rings
// (csrc/paged_tc.cuh; a ring per key lane, shared by its row groups), then
// the pass's row masks lo [ROWS] and hv [ROWS].
template <int HD, bool QUANT>
struct Smem : ptc::Ring<HD, QUANT, pass_mt<HD>(), KL> {
  using Base = ptc::Ring<HD, QUANT, pass_mt<HD>(), KL>;
  // int8: the two warps of a key lane convert K's and V's rows at once.
  static_assert(!QUANT || Base::TILES == 2, "int8 needs a K and a V tile per ring");
  __host__ __device__ static constexpr size_t bytes() {
    return Base::bytes() + sizeof(int) * 2 * Base::ROWS;
  }
  int* lo;
  int* hv;
  __device__ Smem(unsigned char* base, int lane_ring) : Base(base, lane_ring) {
    lo = reinterpret_cast<int*>(base + Base::bytes());
    hv = lo + Base::ROWS;
  }
};

// A slot's active splits [s0, s1], its walk's first position lo and its last
// written position. The merge and the Python mirror
// (ops/ragged_paged_attention.py verify_active_splits) agree.
struct Plan {
  int s0, s1, lo, last;
};
__device__ __forceinline__ Plan plan(int start, int lens, int window, int psz, int P) {
  const int last = min(start + lens - 1, P * psz - 1);
  const int lo = window > 0 ? max(0, start - window + 1) : 0, split_keys = SPLIT_PAGES * psz;
  return {lo / split_keys, last / split_keys, lo, last};
}

// Two blocks an SM (shared memory allows no more at H = 128): up to 255
// registers a thread.
template <int HD, bool QUANT>
__global__ void __launch_bounds__(NTT, 2) ragged_verify_tc_kernel(Args a) {
  using Sm = Smem<HD, QUANT>;
  constexpr int LD = Sm::LD, KB = Sm::KB, ROWS = Sm::ROWS;
  constexpr int WMT = warp_mt<HD>();
  constexpr int NKB = KB / 8;  // 8-key blocks of the logits
  constexpr int NH = HD / 8;   // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kl = warp % KL, rg = warp / KL;  // key lane, row group
  const int grp = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int W = a.W, G = a.N / a.K, R = W * G;
  const int start = a.start[b];
  const Plan pl = plan(start, a.lens[b], a.window, a.psz, a.P);
  if (split < pl.s0 || split > pl.s1) return;
  const int split_keys = SPLIT_PAGES * a.psz;
  const int* pt = a.page_table + static_cast<int64_t>(b) * a.P;
  const int64_t bw = static_cast<int64_t>(b) * W;
  const bool tree = a.words != nullptr;
  Sm sm(smem_raw, kl);

  // This split's keys [klo, khi); key lane kl takes 32-key steps kb0 + kl,
  // kb0 + kl + KL, ...; of each step row group 0 stages K (and its scales),
  // row group 1 V.
  const int klo = max(split * split_keys, pl.lo);
  const int khi = min((split + 1) * split_keys, pl.last + 1);
  const int kb0 = klo / KB, nkb = (khi + KB - 1) / KB - kb0;
  const int n_w = nkb > kl ? (nkb - kl + KL - 1) / KL : 0;
  auto k_at = [&](int i) { return (kb0 + kl + i * KL) * KB; };
  auto load = [&](ptc::KeyRow kr, int st) {
    if (rg == 0)
      ptc::load_step<0>(a, sm, kr, kvh, st);
    else
      ptc::load_step<1>(a, sm, kr, kvh, st);
  };
  // The two warps of this key lane meet at barrier 1 + kl.
  auto lane_sync = [&]() {
    static_assert(KL == 2, "one named barrier per key lane");
    if (kl == 0)
      ptc::named_sync<1, 32 * RG>();
    else
      ptc::named_sync<2, 32 * RG>();
  };

  // The drafts in this split's keys (positions [max(klo, start), khi), all
  // real and inside the table), one warp per (token, K or V), before any
  // read of their pages.
  if (a.k_new != nullptr) {
    const int j0 = max(klo, start) - start, nj = khi - start - j0;
    for (int t = warp; t < 2 * nj; t += WARPS) {
      const int j = j0 + (t >> 1), pos = start + j, which = t & 1;
      const int64_t prow = (a.layer_base + pt[pos / a.psz]) * a.K + kvh;
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(which ? a.v_new : a.k_new) +
                               ((bw + j) * a.K + kvh) * HD;
      ptc::write_row<HD, QUANT>(a, x, which, prow, pos % a.psz);
    }
  }
  // The latest first-seen context position over the slot's rows: a step of
  // keys in [lo_max, start) inside [klo, khi) is kept by every row.
  int lo_max = INT_MIN;
  if (a.window > 0) {
    int dmax = W - 1;
    if (tree) {
      dmax = 0;
      for (int w = 0; w < W; ++w) dmax = max(dmax, a.depths[bw + w]);
    }
    lo_max = start + dmax - a.window + 1;
  }
  __syncthreads();  // the drafts' st.global before every cp.async of their pages

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const int n_pass = (R + ROWS - 1) / ROWS;
  const bool direct = pl.s0 == pl.s1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int r0 = pass * ROWS, nr = min(ROWS, R - r0), n_mt = (nr + 15) / 16;
    // The first two steps' page ids, read before the queries are staged.
    const ptc::KeyRow kr0 = n_w > 0 ? ptc::key_row(a, pt, k_at(0), klo, khi) : ptc::KeyRow{-1, 0};
    ptc::KeyRow kr = n_w > 1 ? ptc::key_row(a, pt, k_at(1), klo, khi) : ptc::KeyRow{-1, 0};

    // Query rows r0 + r, r = w*G + g of kv head kvh (rows past R zero): one
    // cp.async group.
    for (int idx = tid; idx < n_mt * 16 * (HD / 8); idx += NTT) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, rr = r0 + r;
      const int64_t off = r < nr ? ((bw + rr / G) * a.N + kvh * G + rr % G) * HD + c : 0;
      tc::cp16(sm.q + r * LD + c, q + off, r < nr);
    }
    tc::cp_commit();
    // Each row's mask (rows past R keep nothing).
    for (int r = tid; r < ROWS; r += NTT) {
      int lo = INT_MAX, hv = tree ? 0 : -1;
      if (r < nr) {
        const int w = (r0 + r) / G;
        const int d = tree ? a.depths[bw + w] : w;
        lo = a.window > 0 ? start + d - a.window + 1 : INT_MIN;
        if (!tree) {
          hv = start + w;
        } else {
          unsigned vis = static_cast<unsigned>(a.words[bw + w]) | (1u << w);
          if (a.window > 0)
            for (int j = 0; j < W; ++j)
              if (a.depths[bw + j] < d - a.window + 1) vis &= ~(1u << j);
          hv = static_cast<int>(vis);
        }
      }
      sm.lo[r] = lo;
      sm.hv[r] = hv;
    }

    if (n_w > 0) load(kr0, 0);
    tc::cp_commit();
    tc::cp_wait<1>();  // this thread's share of the queries has landed
    __syncthreads();   // every thread's share, and the masks

    // This warp's row tiles are rg, rg + RG, ... of the pass's n_mt.
    float o[WMT][NH][4];
    float m_run[WMT][2], l_run[WMT][2];
#pragma unroll
    for (int t = 0; t < WMT; ++t) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[t][j][e] = 0.f;
      m_run[t][0] = m_run[t][1] = NEG_INF;
      l_run[t][0] = l_run[t][1] = 0.f;
    }

    for (int i = 0; i < n_w; ++i) {
      const int st = i & 1;
      const int k0 = k_at(i);
      tc::cp_wait_all();
      // Step i staged by both warps of the key lane, and both done with
      // step i - 1 (its stage and tiles free).
      lane_sync();
      if (i + 1 < n_w) load(kr, st ^ 1);
      tc::cp_commit();
      // The step after next's page ids: kr is read at the next step's load.
      if (i + 2 < n_w) kr = ptc::key_row(a, pt, k_at(i + 2), klo, khi);
      const __nv_bfloat16* kt = QUANT ? sm.tile() : sm.kv(st);
      const __nv_bfloat16* vt = kt + KB * LD;
      if constexpr (QUANT) {
        ptc::convert_rows(sm, st, rg, sm.tile() + rg * KB * LD);  // K (rg 0) or V (rg 1)
        lane_sync();                                               // both tiles written
      }
      const float* sc = sm.sc(st);
      // Every key of the step is kept for every row: no mask to apply.
      const bool full = k0 >= klo && k0 + KB <= khi && k0 + KB <= start && k0 >= lo_max;

#pragma unroll
      for (int t = 0; t < WMT; ++t) {
        const int mt = t * RG + rg;
        if (mt >= n_mt) break;
        // S = Q . K^T for the tile's 16 rows x KB keys.
        float s[NKB][4];
#pragma unroll
        for (int j = 0; j < NKB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
          uint32_t qa[4];
          tc::load_a(qa, sm.q, LD, mt * 16, kk, lane);
#pragma unroll
          for (int jp = 0; jp < NKB / 2; ++jp) {
            uint32_t kb4[4];
            tc::load_b_nk(kb4, kt, LD, jp * 16, kk, lane);
            tc::mma(s[2 * jp], qa, kb4[0], kb4[1]);
            tc::mma(s[2 * jp + 1], qa, kb4[2], kb4[3]);
          }
        }
        // The scale, the K scale and the softcap in f32, then the mask as
        // -inf, then the online softmax per row.
        int rlo[2] = {0, 0}, rhv[2] = {0, 0};
        if (!full) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rlo[h] = sm.lo[mt * 16 + grp + 8 * h];
            rhv[h] = sm.hv[mt * 16 + grp + 8 * h];
          }
        }
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            float z = s[j][e4] * a.scale;
            if constexpr (QUANT) z *= sc[j * 8 + 2 * tig + (e4 & 1)];
            if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
            if (!full) {
              const int jj = k0 + j * 8 + 2 * tig + (e4 & 1), h = e4 >> 1;
              bool keep = jj >= klo && jj < khi;
              if (!tree)
                keep = keep && jj >= rlo[h] && jj <= rhv[h];
              else if (keep)  // jj - start < lens <= 31 for a draft slot
                keep = jj < start ? jj >= rlo[h]
                                  : ((static_cast<unsigned>(rhv[h]) >> (jj - start)) & 1u) != 0;
              if (!keep) z = -INFINITY;
            }
            s[j][e4] = z;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_run[t][h], mx[h]);  // finite: m_run starts at NEG_INF
          alpha[h] = tc::exp_(m_run[t][h] - m_new);
          m_run[t][h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int h = e4 >> 1;
            const float p = tc::exp_(s[j][e4] - m_run[t][h]);  // 0 for a masked key
            sum[h] += p;
            // Under int8 the V scale folds into the probabilities.
            s[j][e4] = QUANT ? p * sc[KB + j * 8 + 2 * tig + (e4 & 1)] : p;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l_run[t][h] = l_run[t][h] * alpha[h] + sum[h];
        }
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          o[t][j][0] *= alpha[0];
          o[t][j][1] *= alpha[0];
          o[t][j][2] *= alpha[1];
          o[t][j][3] *= alpha[1];
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
            tc::mma(o[t][2 * jp], pa, vb[0], vb[1]);
            tc::mma(o[t][2 * jp + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
    tc::cp_wait_all();
    __syncthreads();  // every warp is done with its ring: the merge reuses it

    // The key lanes' states (a lane without keys: O 0, m NEG_INF, l 0), then
    // their merge in lane order, for the pass's rows.
#pragma unroll
    for (int t = 0; t < WMT; ++t) {
      const int mt = t * RG + rg;
      if (mt >= n_mt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kl * ROWS + mt * 16 + grp + 8 * h;
#pragma unroll
        for (int j = 0; j < NH; ++j)
          *reinterpret_cast<float2*>(sm.o + r * HD + j * 8 + 2 * tig) =
              make_float2(o[t][j][2 * h], o[t][j][2 * h + 1]);
        if (tig == 0)
          *reinterpret_cast<float2*>(sm.ml + 2 * r) = make_float2(m_run[t][h], l_run[t][h]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * HD; idx += NTT) {
      const int r = idx / HD, h = idx % HD, rr = r0 + r;
      float m = NEG_INF;
#pragma unroll
      for (int k = 0; k < KL; ++k) m = fmaxf(m, sm.ml[2 * (k * ROWS + r)]);
      float l = 0.f, acc = 0.f;
#pragma unroll
      for (int k = 0; k < KL; ++k) {
        const float e = tc::exp_(sm.ml[2 * (k * ROWS + r)] - m);
        l += sm.ml[2 * (k * ROWS + r) + 1] * e;
        acc += sm.o[(k * ROWS + r) * HD + h] * e;
      }
      const int64_t row = (bw + rr / G) * a.N + kvh * G + rr % G;
      if (direct) {
        static_cast<__nv_bfloat16*>(a.out)[row * HD + h] =
            __float2bfloat16(acc / (l == 0.f ? 1.f : l));
      } else {
        const int64_t prow = static_cast<int64_t>(split) * a.B * W * a.N + row;
        a.o_part[prow * HD + h] = acc;
        if (h == 0) *reinterpret_cast<float2*>(a.ml_part + 2 * prow) = make_float2(m, l);
      }
    }
    __syncthreads();  // the merge's reads before the next pass's stores
  }
}

// The merge of a slot's split partials, in split order (deterministic): one
// thread per (query row, head, column); slots with one active split are
// skipped (their blocks wrote the output directly).
__global__ void __launch_bounds__(256) ragged_verify_merge_kernel(Args a, int H) {
  const int w = blockIdx.y, b = blockIdx.z, idx = blockIdx.x * 256 + threadIdx.x;
  const Plan pl = plan(a.start[b], a.lens[b], a.window, a.psz, a.P);
  if (pl.s0 == pl.s1 || idx >= a.N * H) return;
  const int64_t plane = static_cast<int64_t>(a.B) * a.W * a.N;
  const int64_t row = (static_cast<int64_t>(b) * a.W + w) * a.N + idx / H;
  const int h = idx % H;
  float m = NEG_INF;
  for (int sp = pl.s0; sp <= pl.s1; ++sp) m = fmaxf(m, a.ml_part[2 * (sp * plane + row)]);
  float l = 0.f, acc = 0.f;
  for (int sp = pl.s0; sp <= pl.s1; ++sp) {
    const int64_t pr = sp * plane + row;
    const float e = expf(a.ml_part[2 * pr] - m);
    l += a.ml_part[2 * pr + 1] * e;
    acc += a.o_part[pr * H + h] * e;
  }
  static_cast<__nv_bfloat16*>(a.out)[row * H + h] = __float2bfloat16(l == 0.f ? 0.f : acc / l);
}

template <int HD, bool QUANT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD, QUANT>::bytes();
  // One block fits an SM's 227 KB opt-in; up to H = 128 two blocks (1 KB
  // reserved each) share its 228 KB.
  static_assert(smem <= 227 * 1024, "a block's shared memory exceeds the opt-in limit");
  static_assert(HD > 128 || 2 * (smem + 1024) <= 228 * 1024, "two blocks must fit an SM");
  cudaError_t err = cudaFuncSetAttribute(ragged_verify_tc_kernel<HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_splits, a.K, B);
  ragged_verify_tc_kernel<HD, QUANT><<<grid, NTT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t by_head_dim(const Args& a, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 16: return launch<16, QUANT>(a, B, stream);
    case 32: return launch<32, QUANT>(a, B, stream);
    case 64: return launch<64, QUANT>(a, B, stream);
    case 128: return launch<128, QUANT>(a, B, stream);
    case 256: return launch<256, QUANT>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcrv

}  // namespace

// dtype (of q, k_new, v_new, out): 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the tensor-core kernel). quant: 0 = the pools are of dtype, 1 =
// int8 pools with float32 scale pools of width SW. k_new/v_new null = no
// write; words/depths null = the chain mask. window <= 0 and softcap <= 0
// mean none. bf16 only: the walk splits into n_splits = ceil(P /
// SPLIT_PAGES) blocks of SPLIT_PAGES pages (the grid's width: every page of
// the table), and o_part / ml_part hold [n_splits, B, W, N, H] / [.., 2]
// float32 partials (may be null when n_splits is 1); ragged_verify_merge
// then combines them. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ragged_verify(const void* q, void* k_pool, void* v_pool, float* k_scale,
                             float* v_scale, const void* k_new, const void* v_new,
                             const int* page_table, const int* start, const int* lens,
                             const int* words, const int* depths, void* out, float* o_part,
                             float* ml_part, int B, int W, int N, int K, int H, int psz, int P,
                             int SW, long long layer_base, int window, float softcap,
                             float scale, int dtype, int quant, int n_splits, void* stream) {
  Args a{q,     k_pool, v_pool, k_scale, v_scale, k_new, v_new,
         page_table, start, lens, words, depths, out, W, N, K, psz, P, SW,
         static_cast<int64_t>(layer_base), window, softcap, scale, n_splits, B, o_part,
         ml_part};
  if (B == 0) return 0;
  if (W < 1 || N % K != 0 || psz < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (words != nullptr && (depths == nullptr || W > 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant && (k_scale == nullptr || v_scale == nullptr || psz > SW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (n_splits != (P > SPLIT_PAGES ? (P + SPLIT_PAGES - 1) / SPLIT_PAGES : 1) ||
        (n_splits > 1 && (o_part == nullptr || ml_part == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    err = quant ? tcrv::by_head_dim<true>(a, B, H, s) : tcrv::by_head_dim<false>(a, B, H, s);
  } else {
    err = quant ? by_head_dim<int8_t>(a, B, H, s) : by_head_dim<float>(a, B, H, s);
  }
  return static_cast<int>(err);
}

// The bf16 kernel's merge: out [B, W, N, H] bf16 of every slot whose walk
// spans more than one split, from the partials ragged_verify wrote (other
// slots untouched). Returns cudaGetLastError() after the launch.
extern "C" int ragged_verify_merge(const float* o_part, const float* ml_part, const int* start,
                                   const int* lens, void* out, int B, int W, int N, int H,
                                   int psz, int P, int window, void* stream) {
  Args a{};
  a.o_part = const_cast<float*>(o_part);
  a.ml_part = const_cast<float*>(ml_part);
  a.start = start;
  a.lens = lens;
  a.out = out;
  a.B = B;
  a.W = W;
  a.N = N;
  a.psz = psz;
  a.P = P;
  a.window = window;
  if (B == 0) return 0;
  if (psz < 1 || H < 1 || W < 1 || W > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N * H + 255) / 256, W, B);
  tcrv::ragged_verify_merge_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, H);
  return static_cast<int>(cudaGetLastError());
}
