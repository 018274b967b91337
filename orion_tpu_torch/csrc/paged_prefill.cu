// K9: paged-flash prefill — a prefill chunk's queries attend the row's paged
// KV history plus the chunk itself, and the chunk's pages are written into
// the pool whole, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/paged_flash_prefill.py::_kernel
// (the pl.pallas_call in _call), both of its pool branches. Row b resumes at
// the page-aligned start[b]: query j (absolute position start[b] + j, j <
// lens[b] real) attends
//   - the row's history pages, walk[b, ip] for ip < start[b] / psz (read from
//     the flat [L*num_pages, K, psz, H] pool at row layer_base + walk[b, ip];
//     int8 pools dequantized: the K scale on the logit columns after q.k, the
//     V scale folded into the probabilities before p.v, as K4 does), and
//   - the chunk's own earlier positions, read RAW from the dense k_new/v_new
//     [B, S, K, H], never from the pool (under int8 too: only history is
//     quantized),
// under the optional sliding window and logit softcap. It also writes chunk
// page cb of every row — walk[b, P_pre + cb] — whole: the raw page, or under
// int8 its quantize_kv bits (s = max|x| * float(1/127) floored at 1e-8, q =
// rintf(x / s) with the IEEE divide: never build with --use_fast_math) and
// the scales in columns [0, psz) of the scale pool rows, later columns left
// as they were. Padding columns are written too, as the JAX package does.
//
// What bounds it on an H100: at the serving shapes (chunks of 256 queries,
// G = 4 query heads per kv head, contexts of thousands of tokens) the
// attention products, about 4 * N * H flops per attended (query, key) pair:
// operations on the tensor cores. The TPU grid (B, NC, P_pre + NC) walks
// pages sequentially and re-applies the write on clamped revisits that exist
// only to elide DMAs; on Hopper the design is instead, for bfloat16 q (bf16
// and int8 pools; paged_prefill_tc_kernel):
//   - one block of 8 warps per (row, q tile, kv head, history split): the
//     group's G query heads x tq queries (tq = the largest power of two with
//     G * tq <= 128) are the 128 rows of one product, so each K/V page is
//     read once per kv head and q tile, not once per query head; a warp
//     owns 16 rows, with their f32 online softmax and output in registers.
//     (Warps of 32 rows, two tiles per K/V fragment, measured slower: at
//     255 registers they spill);
//   - the walk runs over key blocks of 32 consecutive walk positions (part
//     of a page or several pages, so every page size shares one carve-up),
//     streamed through a ring of two shared-memory stages by 16-byte
//     cp.async: the next block's load overlaps this block's products. bf16
//     pages land as they are; int8 pages land raw with their scales and are
//     converted to bf16 in shared memory (exact: |q| <= 127). 32 keys (not
//     64) keep a thread at 128 registers up to H = 128, so two blocks share
//     an SM and hide each other's waits (measured faster);
//   - the mask is applied only on steps that need it (the history's last
//     partial block, the window's edge, the chunk's diagonal, rows past the
//     group or the chunk); every other step goes straight from the scaled
//     logits to the softmax;
//   - S = Q.K^T and O += P.V with mma.sync.m16n8k16 (bf16 in, f32
//     accumulate; ldmatrix fragments from rows skewed by 16 bytes): the K
//     scale on the logit columns, softcap and mask in f32, P (x V scale
//     under int8) to bf16 A fragments straight from the logits' registers.
//     mma.sync and not wgmma: no shared-memory descriptors or swizzle to get
//     right first; wgmma is the next step;
//   - the history splits into blocks of split_pages pages across the grid,
//     so a long row's walk spreads over many SMs: a row with one split
//     writes its normalized output directly; otherwise every split writes
//     its partial (O unnormalized, m, l) to float32 scratch the wrapper
//     allocates, and paged_prefill_merge_kernel combines them in split
//     order (deterministic). Split 0 also attends the chunk;
//   - it skips, as the TPU kernel does, history pages at or past start, keys
//     wholly behind the window of the tile's earliest query, chunk keys past
//     the tile's last real query, and q tiles past lens (zeros out);
//   - exactly one block writes each chunk token of each kv head: split 0 of
//     the token's q tile, whether or not it attends (a warp per token; int8:
//     quantize_kv's bits). History pages are never chunk pages of the same
//     launch, so reads and writes do not race. Pad rows (all-zero walk)
//     write scratch page 0, several at once in no order; page 0 is never
//     read.
// Shared memory: 128 query rows plus two stages of K and V, rows of H + 8
// bf16 (int8: two raw stages plus one bf16 tile): 68 / 70 KB at H = 128.
//
// float32 q (the f32 parity drives) keeps the first version's design on the
// CUDA cores (paged_prefill_kernel): the tensor cores would take f32 as TF32,
// and those drives hold K9 to 1e-4 against the CPU:
//   - one block per (row, page-sized q block, q head): the q block's psz
//     queries of one head stay in shared memory, and the block loops over
//     its history pages and then over the chunk pages cb <= qb with an f32
//     online softmax, psz/256 of a row's keys and H*psz/256 of its outputs
//     per thread (a row's 256/psz threads reduce with warp shuffles);
//   - the same skips; one block (q block cb, the group's first query head)
//     writes each (chunk page, kv head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Output accumulators per thread (H * psz / NT), at the largest page size
// the shared-memory budget admits for each head_dim.
template <int HD> __host__ __device__ constexpr int max_acc() { return HD >= 128 ? HD / 4 : HD / 2; }

struct Args {
  const void* q;       // [B, S, N, HD]
  void* k_pool;        // [rows, K, psz, HD]
  void* v_pool;
  float* k_scale;      // [rows, K, SW] (int8 pools) or null
  float* v_scale;
  const void* k_new;   // [B, S, K, HD]
  const void* v_new;
  const int* walk;     // [B, P_pre + NC]
  const int* start;    // [B] page-aligned tokens already in the pool
  const int* lens;     // [B] real chunk tokens
  void* out;           // [B, S, N, HD]
  int S, N, K, psz, P_pre, NC, SW;
  int64_t layer_base;
  int window;
  float softcap, scale;
  // bf16 kernel only: history split size in pages, splits in the grid, the
  // q tile, and the f32 partials [n_splits, B, S, N, HD] / [.., 2] (m, l)
  // of rows whose history spans more than one split.
  int split_pages, n_splits, tq, B;
  float* o_part;
  float* ml_part;
};

// Splits of row b that hold work: one per split_pages history pages, at
// least one (split 0 also takes the chunk). The merge mirrors it.
__device__ __forceinline__ int active_splits(const Args& a, int start) {
  const int n_hist = min(a.P_pre, start / a.psz);
  return max(1, (n_hist + a.split_pages - 1) / a.split_pages);
}

template <int HD>
size_t smem_bytes(int psz) {
  return sizeof(float) * (2 * psz * (HD + 1) + psz * HD + psz * (psz + 1) + 2 * psz);
}

// Reduce over the tpr consecutive lanes that share a query row.
__device__ __forceinline__ float row_max(float v, int tpr) {
  for (int off = tpr / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v, int tpr) {
  for (int off = tpr / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(Args a) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  constexpr int MAXA = max_acc<HD>();
  const int psz = a.psz;
  const int tpr = NT / psz;                 // threads per query row
  const int qb = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int G = a.N / a.K, kvh = n / G;
  const int tid = threadIdx.x, i = tid / tpr, sub = tid % tpr;
  const int nacc = HD / tpr > 0 ? HD / tpr : 1;  // h = sub + tpr * j
  const int ncol = psz / tpr;                    // c = sub + tpr * j

  extern __shared__ float sm[];
  float* Qs = sm;                      // [psz][HD+1], pre-scaled by H^-0.5
  float* Ks = Qs + psz * (HD + 1);     // [psz][HD+1]
  float* Vs = Ks + psz * (HD + 1);     // [psz][HD]
  float* Ps = Vs + psz * HD;           // [psz][psz+1] logits, then probabilities
  float* ksc = Ps + psz * (psz + 1);   // [psz] this page's K scales (int8)
  float* vsc = ksc + psz;              // [psz]

  TP* kp = static_cast<TP*>(a.k_pool);
  TP* vp = static_cast<TP*>(a.v_pool);
  const TQ* kn = static_cast<const TQ*>(a.k_new);
  const TQ* vn = static_cast<const TQ*>(a.v_new);
  const int* walk = a.walk + static_cast<int64_t>(b) * (a.P_pre + a.NC);
  const int start = a.start[b], qlen = a.lens[b];
  const int64_t page_elems = static_cast<int64_t>(psz) * HD;
  // Row s of the chunk, kv head kvh, in k_new / v_new.
  auto new_row = [&](int s) { return ((static_cast<int64_t>(b) * a.S + s) * a.K + kvh) * HD; };

  // Fused whole-page write of chunk page qb (one block per page and kv head).
  if (n % G == 0) {
    const int64_t prow = (a.layer_base + walk[a.P_pre + qb]) * a.K + kvh;
    const int64_t dst = prow * page_elems + static_cast<int64_t>(i) * HD;
    const int64_t src = new_row(qb * psz + i);
    for (int pass = 0; pass < 2; ++pass) {
      const TQ* x = (pass == 0 ? kn : vn) + src;
      TP* pool = (pass == 0 ? kp : vp) + dst;
      if constexpr (QUANT) {
        float amax = 0.f;
        for (int h = sub; h < HD; h += tpr) amax = fmaxf(amax, fabsf(to_f32(x[h])));
        const float s = fmaxf(row_max(amax, tpr) * INV127, 1e-8f);
        for (int h = sub; h < HD; h += tpr) {
          pool[h] = static_cast<int8_t>(static_cast<int>(rintf(to_f32(x[h]) / s)));
        }
        if (sub == 0) (pass == 0 ? a.k_scale : a.v_scale)[prow * a.SW + i] = s;
      } else {
        for (int h = sub; h < HD; h += tpr) pool[h] = x[h];
      }
    }
  }

  TQ* out = static_cast<TQ*>(a.out);
  const int64_t out_row = ((static_cast<int64_t>(b) * a.S + qb * psz + i) * a.N + n) * HD;
  if (qb * psz >= qlen) {  // an all-padding q block: finite zeros
    for (int h = sub; h < HD; h += tpr) out[out_row + h] = from_f32<TQ>(0.f);
    return;
  }

  const TQ* q = static_cast<const TQ*>(a.q);
  for (int idx = tid; idx < psz * HD; idx += NT) {
    const int r = idx / HD, h = idx % HD;
    Qs[r * (HD + 1) + h] =
        to_f32(q[((static_cast<int64_t>(b) * a.S + qb * psz + r) * a.N + n) * HD + h]) * a.scale;
  }

  float acc[MAXA];
#pragma unroll
  for (int j = 0; j < MAXA; ++j) acc[j] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;
  const int q_loc = qb * psz + i;  // chunk-local position of this thread's query

  // Walk step ip < n_hist reads history page ip; ip >= n_hist reads chunk
  // page ip - n_hist. Steps outside [first, last] are skipped.
  const int n_hist = min(a.P_pre, start / psz);
  int first = 0;
  if (a.window > 0) {
    const int lo = start + qb * psz - a.window + 1;  // earliest query's window
    first = lo > 0 ? lo / psz : 0;
  }
  int cb_first = 0;
  if (a.window > 0) {
    const int lo = qb * psz - a.window + 1;
    cb_first = lo > 0 ? lo / psz : 0;
  }
  const int cb_last = min(qb, (qlen - 1) / psz);

  for (int step = 0; step < n_hist + a.NC; ++step) {
    const bool hist = step < n_hist;
    const int cb = step - n_hist;
    if (hist ? step < first : (cb < cb_first || cb > cb_last)) continue;

    __syncthreads();  // Qs stored / the previous page's reads done
    if (hist) {
      const int64_t prow = (a.layer_base + walk[step]) * a.K + kvh;
      const int64_t base = prow * page_elems;
      for (int idx = tid; idx < psz * HD; idx += NT) {
        const int c = idx / HD, h = idx % HD;
        Ks[c * (HD + 1) + h] = to_f32(kp[base + idx]);
        Vs[idx] = to_f32(vp[base + idx]);
      }
      if constexpr (QUANT) {
        for (int c = tid; c < psz; c += NT) {
          ksc[c] = a.k_scale[prow * a.SW + c];
          vsc[c] = a.v_scale[prow * a.SW + c];
        }
      }
    } else {
      for (int idx = tid; idx < psz * HD; idx += NT) {
        const int c = idx / HD, h = idx % HD;
        const int64_t g = new_row(cb * psz + c) + h;
        Ks[c * (HD + 1) + h] = to_f32(kn[g]);
        Vs[idx] = to_f32(vn[g]);
      }
    }
    __syncthreads();

    // Logits of this thread's columns, masked with -inf; the row max.
    const float* qi = Qs + i * (HD + 1);
    float mx = NEG_INF;
    for (int jc = 0; jc < ncol; ++jc) {
      const int c = sub + tpr * jc;
      const float* kc = Ks + c * (HD + 1);
      float z = 0.f;
#pragma unroll 8
      for (int h = 0; h < HD; ++h) z = fmaf(qi[h], kc[h], z);
      if (QUANT && hist) z *= ksc[c];
      if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
      bool keep;
      if (hist) {
        const int kv_pos = step * psz + c;  // absolute, below start
        keep = a.window <= 0 || kv_pos >= start + q_loc - a.window + 1;
      } else {
        const int kv_loc = cb * psz + c;    // chunk-local
        keep = kv_loc <= q_loc && (a.window <= 0 || kv_loc >= q_loc - a.window + 1);
      }
      z = keep ? z : -INFINITY;
      Ps[i * (psz + 1) + c] = z;
      mx = fmaxf(mx, z);
    }
    const float m_new = fmaxf(m_run, row_max(mx, tpr));
    float sum = 0.f;
    for (int jc = 0; jc < ncol; ++jc) {
      const int c = sub + tpr * jc;
      const float z = Ps[i * (psz + 1) + c];
      const float p = z == -INFINITY ? 0.f : expf(z - m_new);
      sum += p;
      Ps[i * (psz + 1) + c] = (QUANT && hist) ? p * vsc[c] : p;
    }
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + row_sum(sum, tpr);
    m_run = m_new;
    __syncthreads();  // the row's probabilities, written by its tpr threads

    const float* pi = Ps + i * (psz + 1);
#pragma unroll
    for (int j = 0; j < MAXA; ++j) {
      if (j < nacc) acc[j] *= alpha;
    }
    for (int c = 0; c < psz; ++c) {
      const float p = pi[c];
      const float* vc = Vs + c * HD + sub;
#pragma unroll
      for (int j = 0; j < MAXA; ++j) {
        if (j < nacc) acc[j] = fmaf(p, vc[tpr * j], acc[j]);
      }
    }
  }

  const float inv = 1.f / (l_run == 0.f ? 1.f : l_run);
#pragma unroll
  for (int j = 0; j < MAXA; ++j) {
    const int h = sub + tpr * j;
    if (j < nacc && h < HD) out[out_row + h] = from_f32<TQ>(acc[j] * inv);
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernel (bf16 and int8 pools) on the tensor cores: see the note at
// the top of the file.
namespace tcpf {

constexpr int ROWS = 128;  // product rows of a block: G query heads x tq queries

// Keys per step of the walk (a block of consecutive walk positions, part of
// a page or several pages).
constexpr int KEY_BLOCK = 32;

// Blocks per SM the kernel is compiled for: two up to H = 128 (at most 128
// registers a thread; 32 keys a step keep the logits in 16 of them), one at
// H = 256.
template <int HD> __host__ __device__ constexpr int min_blocks() { return HD <= 128 ? 2 : 1; }

template <int HD, bool QUANT>
struct Smem {
  static constexpr int LD = HD + 8;    // bf16 row stride
  static constexpr int LD8 = HD + 16;  // int8 row stride (bytes)
  static constexpr int KB = KEY_BLOCK;
  // Stage st of the ring is base + st * its size: plain pointer arithmetic,
  // so no array of pointers is indexed at run time.
  __nv_bfloat16* q;         // [ROWS][LD] the block's queries
  __nv_bfloat16* kv_;       // bf16 pools: the ring, [2][K [KB][LD], V [KB][LD]]
  __nv_bfloat16* tile;      // int8 pools: the bf16 K/V the products read
  int8_t* raw_;             // int8 pools: the ring, [2][K [KB][LD8], V [KB][LD8]]
  float* sc_;               // int8 pools: [2][K, V scales [KB]]

  static constexpr size_t bytes() {
    return sizeof(__nv_bfloat16) * ROWS * LD +
           (QUANT ? sizeof(__nv_bfloat16) * 2 * KB * LD + 2 * 2 * KB * LD8 + sizeof(float) * 2 * 2 * KB
                  : sizeof(__nv_bfloat16) * 2 * 2 * KB * LD);
  }

  __device__ explicit Smem(unsigned char* base) {
    q = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* p = q + ROWS * LD;
    kv_ = tile = p;
    raw_ = reinterpret_cast<int8_t*>(p + 2 * KB * LD);
    sc_ = reinterpret_cast<float*>(raw_ + 2 * 2 * KB * LD8);
  }
  __device__ __nv_bfloat16* kv(int st) const { return kv_ + st * 2 * KB * LD; }
  __device__ int8_t* raw(int st) const { return raw_ + st * 2 * KB * LD8; }
  __device__ float* sc(int st) const { return sc_ + st * 2 * KB; }
};

// The chunk tokens [s0, s1) of kv head kvh into their pool pages, one warp
// per token: raw, or under int8 quantize_kv's bits and the scale.
template <int HD, bool QUANT>
__device__ __forceinline__ void write_tokens(const Args& a, int b, int kvh, int s0, int s1,
                                             const int* walk) {
  using TP = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const __nv_bfloat16* kn = static_cast<const __nv_bfloat16*>(a.k_new);
  const __nv_bfloat16* vn = static_cast<const __nv_bfloat16*>(a.v_new);
  for (int s = s0 + warp; s < s1; s += NT / 32) {
    const int64_t prow = (a.layer_base + walk[a.P_pre + s / a.psz]) * a.K + kvh;
    const int64_t dst = (prow * a.psz + s % a.psz) * HD;
    const int64_t src = ((static_cast<int64_t>(b) * a.S + s) * a.K + kvh) * HD;
    for (int pass = 0; pass < 2; ++pass) {
      const __nv_bfloat16* x = (pass == 0 ? kn : vn) + src;
      TP* pool = static_cast<TP*>(pass == 0 ? a.k_pool : a.v_pool) + dst;
      if constexpr (QUANT) {
        float amax = 0.f;
        for (int h = lane; h < HD; h += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[h])));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        const float sc = fmaxf(amax * INV127, 1e-8f);
        for (int h = lane; h < HD; h += 32)
          pool[h] = static_cast<int8_t>(static_cast<int>(rintf(__bfloat162float(x[h]) / sc)));
        if (lane == 0) (pass == 0 ? a.k_scale : a.v_scale)[prow * a.SW + s % a.psz] = sc;
      } else {
        if (lane < HD / 8)
          reinterpret_cast<uint4*>(pool)[lane] = reinterpret_cast<const uint4*>(x)[lane];
      }
    }
  }
}

// Asynchronous load of walk step i: history key block hb0 + i (K/V and,
// int8, the scales) into ring stage st; chunk key block cb0 + i - nh into
// stage st (bf16 pools) or the tile (int8, whose ring holds int8 bytes).
template <int HD, bool QUANT>
__device__ __forceinline__ void load_step(const Args& a, const Smem<HD, QUANT>& sm,
                                          const int* walk, int b, int kvh, int i, int st, int nh,
                                          int hb0, int cb0, int n_hkeys) {
  using Sm = Smem<HD, QUANT>;
  constexpr int LD = Sm::LD, LD8 = Sm::LD8, KB = Sm::KB;
  const int tid = threadIdx.x, psz = a.psz, lp = 31 - __clz(psz);
  if (i < nh) {
    const int k0 = (hb0 + i) * KB;
    if constexpr (QUANT) {
      constexpr int CH = HD / 16;
      for (int idx = tid; idx < 2 * KB * CH; idx += NT) {
        const int which = idx / (KB * CH), r = (idx / CH) % KB, c = (idx % CH) * 16;
        const int j = k0 + r;
        const bool in = j < n_hkeys;
        int64_t off = 0;
        if (in) off = (((a.layer_base + walk[j >> lp]) * a.K + kvh) * psz + (j & (psz - 1))) * HD + c;
        const int8_t* pool = static_cast<const int8_t*>(which ? a.v_pool : a.k_pool);
        tc::cp16(sm.raw(st) + which * KB * LD8 + r * LD8 + c, pool + off, in);
      }
      if (tid < 2 * KB) {
        const int which = tid / KB, r = tid % KB, j = k0 + r;
        const bool in = j < n_hkeys;
        int64_t off = 0;
        if (in) off = ((a.layer_base + walk[j >> lp]) * a.K + kvh) * a.SW + (j & (psz - 1));
        tc::cp4(sm.sc(st) + which * KB + r, (which ? a.v_scale : a.k_scale) + off, in);
      }
    } else {
      constexpr int CH = HD / 8;
      for (int idx = tid; idx < 2 * KB * CH; idx += NT) {
        const int which = idx / (KB * CH), r = (idx / CH) % KB, c = (idx % CH) * 8;
        const int j = k0 + r;
        const bool in = j < n_hkeys;
        int64_t off = 0;
        if (in) off = (((a.layer_base + walk[j >> lp]) * a.K + kvh) * psz + (j & (psz - 1))) * HD + c;
        const __nv_bfloat16* pool = static_cast<const __nv_bfloat16*>(which ? a.v_pool : a.k_pool);
        tc::cp16(sm.kv(st) + which * KB * LD + r * LD + c, pool + off, in);
      }
    }
  } else {
    const int k0 = (cb0 + i - nh) * KB;
    __nv_bfloat16* dst = QUANT ? sm.tile : sm.kv(st);
    constexpr int CH = HD / 8;
    for (int idx = tid; idx < 2 * KB * CH; idx += NT) {
      const int which = idx / (KB * CH), r = (idx / CH) % KB, c = (idx % CH) * 8;
      const int j = k0 + r;
      const bool in = j < a.S;
      const int64_t off = in ? ((static_cast<int64_t>(b) * a.S + j) * a.K + kvh) * HD + c : 0;
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(which ? a.v_new : a.k_new);
      tc::cp16(dst + which * KB * LD + r * LD + c, src + off, in);
    }
  }
}

template <int HD, bool QUANT>
__global__ void __launch_bounds__(NT, min_blocks<HD>()) paged_prefill_tc_kernel(Args a) {
  using Sm = Smem<HD, QUANT>;
  constexpr int LD = Sm::LD, LD8 = Sm::LD8, KB = Sm::KB;
  constexpr int NKB = KB / 8;  // 8-key blocks of the logits per warp
  constexpr int NH = HD / 8;   // 8-column blocks of the output per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm sm(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int qt = blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z / a.n_splits, split = blockIdx.z % a.n_splits;
  const int G = a.N / a.K, TQ = a.tq, qs = qt * TQ, psz = a.psz;
  const int start = a.start[b], qlen = a.lens[b];
  const int n_hist = min(a.P_pre, start / psz);
  const int n_act = active_splits(a, start);
  if (split >= n_act) return;
  const int* walk = a.walk + static_cast<int64_t>(b) * (a.P_pre + a.NC);

  // Exactly one block writes each chunk token of each kv head: split 0 of
  // the token's q tile, whether or not it attends.
  if (split == 0) write_tokens<HD, QUANT>(a, b, kvh, qs, min(qs + TQ, a.S), walk);

  // The walk: history key blocks [hb0, hb1) of this split (keys below the
  // earliest query's window skipped), then chunk key blocks [cb0, cb1)
  // (split 0; keys up to the tile's last real query). A q tile with no real
  // query walks nothing: its rows come out as zeros.
  const int n_hkeys = n_hist * psz;
  int hb0 = 0, hb1 = 0, cb0 = 0, cb1 = 0;
  if (qs < qlen) {
    int lo = split * a.split_pages * psz;
    const int hi = min(n_hkeys, (split + 1) * a.split_pages * psz);
    if (a.window > 0) lo = max(lo, start + qs - a.window + 1);
    if (lo < hi) {
      hb0 = lo / KB;
      hb1 = (hi + KB - 1) / KB;
    }
    if (split == 0) {
      const int clo = a.window > 0 ? max(0, qs - a.window + 1) : 0;
      const int chi = min(qs + TQ, qlen);
      if (clo < chi) {
        cb0 = clo / KB;
        cb1 = (chi + KB - 1) / KB;
      }
    }
  }
  const int nh = hb1 - hb0, n_items = nh + (cb1 - cb0);

  // This thread's two product rows (grp and grp + 8 of the warp's 16).
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + grp + 8 * h;
    qpos[h] = qs + r % TQ;
    rvalid[h] = r / TQ < G && qpos[h] < a.S;
  }
  // Every row of the block is a real (head, query) row.
  const bool rows_full = G * TQ == ROWS && qs + TQ <= a.S;

  float o[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  if (n_items > 0) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int idx = tid; idx < ROWS * (HD / 8); idx += NT) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int gq = r / TQ, s = qs + r % TQ;
      const bool in = gq < G && s < a.S;
      const int64_t off = in ? ((static_cast<int64_t>(b) * a.S + s) * a.N + kvh * G + gq) * HD + c : 0;
      tc::cp16(sm.q + r * LD + c, q + off, in);
    }
    if (!QUANT || nh > 0) load_step<HD, QUANT>(a, sm, walk, b, kvh, 0, 0, nh, hb0, cb0, n_hkeys);
    tc::cp_commit();
  }

  for (int i = 0; i < n_items; ++i) {
    const int st = i & 1;
    const bool hist = i < nh;
    tc::cp_wait_all();
    __syncthreads();  // step i staged; every read of the previous step done
    if constexpr (QUANT) {
      if (hist) {
        // int8 -> bf16, exact (|x| <= 127); the scales stay in sc(st).
        constexpr int CH = HD / 16;
        for (int idx = tid; idx < 2 * KB * CH; idx += NT) {
          const int which = idx / (KB * CH), r = (idx / CH) % KB, c = (idx % CH) * 16;
          const int4 w = *reinterpret_cast<const int4*>(sm.raw(st) + which * KB * LD8 + r * LD8 + c);
          const int8_t* x = reinterpret_cast<const int8_t*>(&w);
          uint32_t y[8];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            y[t] = tc::pack_bf16(static_cast<float>(x[2 * t]), static_cast<float>(x[2 * t + 1]));
          uint4* d = reinterpret_cast<uint4*>(sm.tile + which * KB * LD + r * LD + c);
          d[0] = make_uint4(y[0], y[1], y[2], y[3]);
          d[1] = make_uint4(y[4], y[5], y[6], y[7]);
        }
      } else {
        load_step<HD, QUANT>(a, sm, walk, b, kvh, i, st, nh, hb0, cb0, n_hkeys);
        tc::cp_commit();
        tc::cp_wait_all();
      }
    }
    // Prefetch step i + 1 while this one computes (int8 chunk steps load
    // into the tile, so they wait for their turn).
    if (i + 1 < n_items && (!QUANT || i + 1 < nh))
      load_step<HD, QUANT>(a, sm, walk, b, kvh, i + 1, st ^ 1, nh, hb0, cb0, n_hkeys);
    tc::cp_commit();
    if constexpr (QUANT) __syncthreads();  // the tile is written
    const __nv_bfloat16* kt = QUANT ? sm.tile : sm.kv(st);
    const __nv_bfloat16* vt = kt + KB * LD;
    const float* sc = sm.sc(st);
    const int k0 = hist ? (hb0 + i) * KB : (cb0 + i - nh) * KB;
    // Whether every row attends every key of the step (no mask to apply):
    // history keys all before the row's history end and inside the window
    // of the block's last query; chunk keys all at or before its first.
    const bool full =
        rows_full && (hist ? k0 + KB <= n_hkeys && (a.window <= 0 || k0 >= start + qs + TQ - a.window)
                           : k0 + KB - 1 <= qs && (a.window <= 0 || k0 >= qs + TQ - a.window));

    // S = Q . K^T for the warp's 16 rows x KB keys.
    float s[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4];
      tc::load_a(qa, sm.q, LD, warp * 16, kk, lane);
#pragma unroll
      for (int jp = 0; jp < NKB / 2; ++jp) {
        uint32_t kb4[4];
        tc::load_b_nk(kb4, kt, LD, jp * 16, kk, lane);
        tc::mma(s[2 * jp], qa, kb4[0], kb4[1]);
        tc::mma(s[2 * jp + 1], qa, kb4[2], kb4[3]);
      }
    }

    // K scale and softcap in f32, the mask as -inf (where a key is masked
    // for some row), then the online softmax per row.
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        float z = s[j][e4] * a.scale;
        if (QUANT && hist) z *= sc[j * 8 + 2 * tig + (e4 & 1)];
        if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
        s[j][e4] = z;
      }
    }
    if (!full) {
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int h = e4 >> 1, jj = k0 + j * 8 + 2 * tig + (e4 & 1);
          bool keep = rvalid[h];
          if (hist) {
            keep = keep && jj < n_hkeys && (a.window <= 0 || jj >= start + qpos[h] - a.window + 1);
          } else {
            keep = keep && jj <= qpos[h] && (a.window <= 0 || jj >= qpos[h] - a.window + 1);
          }
          if (!keep) s[j][e4] = -INFINITY;
        }
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
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: m_run starts at NEG_INF
      alpha[h] = tc::exp_(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int h = e4 >> 1;
        const float p = tc::exp_(s[j][e4] - m_run[h]);  // 0 for a masked key
        sum[h] += p;
        // Under int8 the V scale folds into the probabilities.
        s[j][e4] = (QUANT && hist) ? p * sc[KB + j * 8 + 2 * tig + (e4 & 1)] : p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
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

  // The rows: normalized into out when the row has one split, else the
  // split's partial (O unnormalized, m, l) for the merge.
  const bool direct = n_act == 1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rvalid[h]) continue;
    const int r = warp * 16 + grp + 8 * h;
    const int n = kvh * G + r / TQ;
    const int64_t row = (static_cast<int64_t>(b) * a.S + qpos[h]) * a.N + n;
    if (direct) {
      const float inv = 1.f / (l_run[h] == 0.f ? 1.f : l_run[h]);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        *reinterpret_cast<uint32_t*>(out + row * HD + j * 8 + 2 * tig) =
            tc::pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      }
    } else {
      const int64_t prow = static_cast<int64_t>(split) * a.B * a.S * a.N + row;
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
// block per (query, row), rows with one split skipped (written directly).
template <int HD>
__global__ void __launch_bounds__(NT) paged_prefill_merge_kernel(Args a) {
  const int s = blockIdx.x, b = blockIdx.y;
  const int n_act = active_splits(a, a.start[b]);
  if (n_act <= 1) return;
  const int64_t plane = static_cast<int64_t>(a.B) * a.S * a.N;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  for (int idx = threadIdx.x; idx < a.N * HD; idx += NT) {
    const int n = idx / HD, h = idx % HD;
    const int64_t row = (static_cast<int64_t>(b) * a.S + s) * a.N + n;
    float m = NEG_INF;
    for (int sp = 0; sp < n_act; ++sp) m = fmaxf(m, a.ml_part[2 * (sp * plane + row)]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < n_act; ++sp) {
      const int64_t pr = sp * plane + row;
      const float w = expf(a.ml_part[2 * pr] - m);
      l += a.ml_part[2 * pr + 1] * w;
      acc += a.o_part[pr * HD + h] * w;
    }
    out[row * HD + h] = __float2bfloat16(l == 0.f ? 0.f : acc / l);
  }
}

template <int HD, bool QUANT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if ((a.split_pages * a.psz) % KEY_BLOCK || a.tq < 1 || a.tq * (a.N / a.K) > ROWS)
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<HD, QUANT>::bytes();
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_tc_kernel<HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + a.tq - 1) / a.tq, a.K, B * a.n_splits);
  paged_prefill_tc_kernel<HD, QUANT><<<grid, NT, smem, stream>>>(a);
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

template <int HD>
cudaError_t merge(const Args& a, cudaStream_t stream) {
  dim3 grid(a.S, a.B);
  paged_prefill_merge_kernel<HD><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tcpf

template <typename TQ, typename TP, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if ((HD * a.psz) / NT > max_acc<HD>()) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<HD>(a.psz);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<TQ, TP, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.NC, a.N, B);
  paged_prefill_kernel<TQ, TP, HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TP>
cudaError_t by_head_dim(const Args& a, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 16: return launch<TQ, TP, 16>(a, B, stream);
    case 32: return launch<TQ, TP, 32>(a, B, stream);
    case 64: return launch<TQ, TP, 64>(a, B, stream);
    case 128: return launch<TQ, TP, 128>(a, B, stream);
    case 256: return launch<TQ, TP, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q, k_new, v_new, out): 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the tensor-core kernel). quant: 0 = the pools are of dtype, 1 =
// int8 pools with float32 scale pools of width SW. psz must be a power of two
// in [16, 128] and S = NC * psz. window <= 0 and softcap <= 0 mean none.
// bf16 only: the history splits into n_splits blocks of split_pages pages,
// with tq queries of each of the G = N / K heads per block, and o_part /
// ml_part hold [n_splits, B, S, N, H] / [.., 2] float32 partials (may be
// null when n_splits is 1); paged_prefill_merge then combines them. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int paged_prefill(const void* q, void* k_pool, void* v_pool, float* k_scale,
                             float* v_scale, const void* k_new, const void* v_new,
                             const int* walk, const int* start, const int* lens, void* out,
                             float* o_part, float* ml_part, int B, int S, int N, int K, int H,
                             int psz, int P_pre, int NC, int SW, long long layer_base,
                             int window, float softcap, float scale, int dtype, int quant,
                             int split_pages, int n_splits, int tq, void* stream) {
  Args a{q,     k_pool, v_pool, k_scale, v_scale, k_new, v_new, walk,
         start, lens,   out,    S,       N,       K,     psz,   P_pre,
         NC,    SW,     static_cast<int64_t>(layer_base), window, softcap, scale,
         split_pages, n_splits, tq, B, o_part, ml_part};
  if (B == 0 || NC == 0) return 0;
  if (psz < 16 || psz > 128 || (psz & (psz - 1)) || S != NC * psz || N % K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant && (k_scale == nullptr || v_scale == nullptr || psz > SW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (split_pages < 1 || n_splits < 1 || (n_splits > 1 && (o_part == nullptr || ml_part == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    err = quant ? tcpf::by_head_dim<true>(a, B, H, s) : tcpf::by_head_dim<false>(a, B, H, s);
  } else {
    err = quant ? by_head_dim<float, int8_t>(a, B, H, s) : by_head_dim<float, float>(a, B, H, s);
  }
  return static_cast<int>(err);
}

// The bf16 kernel's merge: out [B, S, N, H] bf16 of every row whose history
// spans more than one split, from the partials paged_prefill wrote (other
// rows untouched). Returns cudaGetLastError() after the launch.
extern "C" int paged_prefill_merge(const float* o_part, const float* ml_part, const int* start,
                                   void* out, int B, int S, int N, int H, int psz, int P_pre,
                                   int split_pages, void* stream) {
  Args a{};
  a.o_part = const_cast<float*>(o_part);
  a.ml_part = const_cast<float*>(ml_part);
  a.start = start;
  a.out = out;
  a.B = B;
  a.S = S;
  a.N = N;
  a.psz = psz;
  a.P_pre = P_pre;
  a.split_pages = split_pages;
  if (B == 0 || S == 0) return 0;
  if (psz < 1 || split_pages < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return static_cast<int>(tcpf::merge<16>(a, s));
    case 32: return static_cast<int>(tcpf::merge<32>(a, s));
    case 64: return static_cast<int>(tcpf::merge<64>(a, s));
    case 128: return static_cast<int>(tcpf::merge<128>(a, s));
    case 256: return static_cast<int>(tcpf::merge<256>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
