// K4: paged decode attention with the new token's K/V written in place,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/paged_attention.py::_kernel
// (the pl.pallas_call in _call), both of its pool branches: one query token
// per slot attends that slot's pages of the flat [L*num_pages, K, psz, H]
// pool at rows layer_base + page_table[b, p] for p <= last_pos // psz (pages
// wholly behind the sliding window skipped), after writing the token's own
// K/V into row layer_base + page_table[b, last_pos // psz], column
// last_pos % psz. Logits are scale * q.k (times the K scale under int8),
// softcapped; keys past last_pos or behind the window are masked.
//
// What bounds it on an H100: bytes. Each attended key and value is read once
// and used for the G = N/K query heads of its kv head: about 2*G flops per
// byte in bf16 (4*G in int8), far below the ridge point, so the work is to
// keep enough bytes in flight on every SM. The TPU grid (B, P) walks a
// slot's pages in order and carries the softmax across them; on Hopper,
// for bfloat16 q (bf16 and int8 pools; paged_decode_tc_kernel):
//   - the page walk is split across the grid: one block of WARPS warps per
//     (split of SPLIT_PAGES pages, kv head, slot), so a slot's long context
//     spreads over many SMs and the slot with the longest context no longer
//     sets the time alone. Splits past the slot's last page or wholly behind
//     its window exit at once; the number of splits comes from the page
//     table's width, never from last_pos (the host reads no device data).
//     A slot with one active split writes its normalized output directly;
//     otherwise every split writes a float32 partial (O unnormalized, m, l
//     per head) to scratch the wrapper allocates, and
//     paged_decode_merge_kernel combines them in split order (deterministic,
//     no atomics);
//   - inside a block each warp owns every WARPS-th 32-key step of the split
//     and its own online softmax: the step's keys stream through the warp's
//     own ring of two shared-memory stages by 16-byte cp.async, so the next
//     step's load overlaps this step's products and no block-wide barrier
//     runs in the walk. Each lane resolves one key's page id a step ahead
//     (one page-table load per lane, its latency under the products), and
//     the lanes copying that key's row take its offset by shuffle: a copy
//     never waits on a table load of its own. int8 pages land raw with their
//     scales and are converted to bf16 in shared memory (exact: |q| <= 127)
//     with a float's magic bias on the integer and f32 pipes, not the
//     quarter-rate conversion unit; at one row tile K's and V's conversions
//     share a tile, so three blocks fit an SM at H = 128 (bf16 and int8:
//     74 and 60 KB). The warps' states are merged once, in warp order, at
//     the end;
//   - S = Q.K^T and O += P.V on mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//     the G heads are the rows of one m16 tile, zero-padded (G > 16, at head
//     dims under 128, takes several tiles). Three quarters of a product row
//     tile is padding at G = 4; the kernel is bound by bytes, so the tensor
//     cores' idle rows cost nothing that shows. The scale applies to the f32
//     logits (H^-0.5 is no power of two at H = 128: q * scale would round),
//     then the K scale, the softcap and the mask inside the exponential; P
//     (times the V scale under int8) goes to bf16 A fragments straight from
//     the logits' registers. Steps where every key is kept skip the mask.
//     mma.sync and not wgmma/TMA: a decode step's product is one 16-row tile,
//     below wgmma's 64 rows, and the loads are a gather over page ids that a
//     TMA descriptor does not walk by itself; a wgmma/TMA design (several
//     slots or q tiles per warpgroup, a page-id driven TMA ring) is the next
//     step.
// The new token: exactly one block per (slot, kv head) writes it, the split
// that owns page last_pos // psz, before that block stages any page; a
// __syncthreads() orders the st.global before the block's cp.async reads
// (both in the generic proxy; a TMA bulk copy would need fence.proxy.async),
// so the walk reads the token back as the pool holds it. No other split
// reads that page. Under int8 the block writes quantize_kv's bits, as
// ops/common.py quantize_kv computes them: s = max|x| * float(1/127) (a
// multiply, not a divide by 127), floored at 1e-8, q = rintf(x / s) with the
// IEEE divide (this file must not be built with --use_fast_math), and the
// scale into column last_pos % psz of the scale pool.
// Idle slots point at scratch page 0, so several blocks may write page 0 at
// once, in no order; page 0 is never read for a live slot, and callers
// comparing pools or outputs exclude it and the idle slots.
//
// float32 q (the f32 parity drives) keeps the first version's design on the
// CUDA cores (paged_decode_kernel): the tensor cores would take f32 as TF32,
// and those drives hold K4 to 1e-4 against the CPU. One block per (slot, kv
// head) walks the slot's live pages in order; the online-softmax state per
// head lives in shared memory and the G*H output accumulators in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "paged_tc.cuh"
#include "tc.cuh"

namespace {

constexpr int NT = 128;
constexpr int MAXO = 16;  // output accumulators per thread: G*H <= 2048
constexpr float NEG_INF = -1e30f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);
// Pages per split of the bf16 kernel's walk (ops/paged_attention.py
// DECODE_SPLIT_PAGES mirrors it; the launcher refuses a grid of another
// width). 8 was timed against 4 and 16 on an H100: see PERF.md's K4 notes.
constexpr int SPLIT_PAGES = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

struct Args {
  const void* q;       // [B, N, HD]
  void* k_pool;        // [rows, K, psz, HD]
  void* v_pool;
  float* k_scale;      // [rows, K, SW] (int8 pools) or null
  float* v_scale;
  const void* k_new;   // [B, K, HD] or null
  const void* v_new;
  const int* page_table;  // [B, P]
  const int* last_pos;    // [B]
  void* out;              // [B, N, HD]
  int N, K, psz, P, SW;
  int64_t layer_base;
  int window;
  float softcap, scale;
  // bf16 kernel and merge: splits in the grid, slots, and the f32 partials
  // [n_splits, B, N, HD] / [.., 2] (m, l) of slots whose walk spans more
  // than one split.
  int n_splits, B;
  float* o_part;
  float* ml_part;
};

// The active splits [s0, s1] of a slot and the window's first kept position
// lo: s1 owns page last_pos // psz (and the new token's write). The merge
// and the Python mirror (ops/paged_attention.py decode_active_splits) agree.
struct Plan {
  int s0, s1, lo;
};
__device__ __forceinline__ Plan plan(int lp, int window, int psz) {
  const int lo = window > 0 ? max(0, lp - window + 1) : 0, split_keys = SPLIT_PAGES * psz;
  return {lo / split_keys, lp / split_keys, lo};
}

template <int HD>
size_t smem_bytes(int G, int psz) {
  return sizeof(float) * (G * HD + psz * (HD + 1) + psz * HD + G * psz + 3 * G + 2 * psz + 4);
}

// The max over the block of each thread's v (every thread gets it).
__device__ __forceinline__ float block_max(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// quantize_kv of one HD-vector into dst (int8) and *scale_dst.
template <int HD>
__device__ void quantize_row(const float* src, int8_t* dst, float* scale_dst, float* red) {
  float amax = 0.f;
  for (int h = threadIdx.x; h < HD; h += NT) amax = fmaxf(amax, fabsf(to_f32(src[h])));
  const float s = fmaxf(block_max(amax, red) * INV127, 1e-8f);
  for (int h = threadIdx.x; h < HD; h += NT) {
    dst[h] = static_cast<int8_t>(static_cast<int>(rintf(to_f32(src[h]) / s)));
  }
  if (threadIdx.x == 0) *scale_dst = s;
}

// float32 q: TP is the pool's type (float or int8).
template <typename TP, int HD>
__global__ void __launch_bounds__(NT) paged_decode_kernel(Args a) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  const int G = a.N / a.K;
  const int psz = a.psz;
  extern __shared__ float sm[];
  float* Qs = sm;                      // [G][HD], pre-scaled by H^-0.5
  float* Ks = Qs + G * HD;             // [psz][HD+1]
  float* Vs = Ks + psz * (HD + 1);     // [psz][HD]
  float* Ss = Vs + psz * HD;           // [G][psz] scores, then probabilities
  float* m_s = Ss + G * psz;           // [G]
  float* l_s = m_s + G;                // [G]
  float* al_s = l_s + G;               // [G] this page's rescale factor
  float* ksc = al_s + G;               // [psz] this page's K scales (int8)
  float* vsc = ksc + psz;              // [psz] this page's V scales (int8)
  float* red = vsc + psz;              // [NT / 32] reduction scratch

  TP* kp = static_cast<TP*>(a.k_pool);
  TP* vp = static_cast<TP*>(a.v_pool);
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lp = a.last_pos[b];
  const int* pt = a.page_table + static_cast<int64_t>(b) * a.P;
  const int64_t page_elems = static_cast<int64_t>(psz) * HD;

  if (a.k_new != nullptr) {
    const int64_t row = a.layer_base + pt[lp / psz];
    const int64_t dst = (row * a.K + kvh) * page_elems + static_cast<int64_t>(lp % psz) * HD;
    const int64_t src = (static_cast<int64_t>(b) * a.K + kvh) * HD;
    const float* kn = static_cast<const float*>(a.k_new) + src;
    const float* vn = static_cast<const float*>(a.v_new) + src;
    if constexpr (QUANT) {
      const int64_t sdst = (row * a.K + kvh) * a.SW + lp % psz;
      quantize_row<HD>(kn, kp + dst, a.k_scale + sdst, red);
      quantize_row<HD>(vn, vp + dst, a.v_scale + sdst, red);
    } else {
      for (int h = tid; h < HD; h += NT) {
        kp[dst + h] = kn[h];
        vp[dst + h] = vn[h];
      }
    }
  }
  const float* q = static_cast<const float*>(a.q) + (static_cast<int64_t>(b) * a.N + kvh * G) * HD;
  for (int i = tid; i < G * HD; i += NT) Qs[i] = q[i] * a.scale;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int n_out = G * HD;
  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;

  int p_begin = 0;
  const int lo = a.window > 0 ? lp - a.window + 1 : 0;
  if (lo > 0) p_begin = lo / psz;
  const int p_end = lp / psz;

  for (int pg = p_begin; pg <= p_end; ++pg) {
    __syncthreads();  // the new token's store and the previous page's reads
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

    for (int idx = tid; idx < G * psz; idx += NT) {
      const int g = idx / psz, c = idx % psz;
      const float* qg = Qs + g * HD;
      const float* kc = Ks + c * (HD + 1);
      float z = 0.f;
#pragma unroll 8
      for (int h = 0; h < HD; ++h) z = fmaf(qg[h], kc[h], z);
      if constexpr (QUANT) z *= ksc[c];
      if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
      const int pos = pg * psz + c;
      const bool keep = pos <= lp && pos >= lo;
      Ss[idx] = keep ? z : -INFINITY;  // -inf marks a masked column
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      float mx = NEG_INF;
      for (int c = lane; c < psz; c += 32) mx = fmaxf(mx, Ss[g * psz + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < psz; c += 32) {
        const float z = Ss[g * psz + c];
        const float p = z == -INFINITY ? 0.f : expf(z - m_new);
        sum += p;
        // int8: the V scale folds into the probability (after the row sum).
        Ss[g * psz + c] = QUANT ? p * vsc[c] : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        al_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int o = tid + NT * i;
      if (o < n_out) {
        const int g = o / HD, h = o % HD;
        const float* pg_row = Ss + g * psz;
        float x = acc[i] * al_s[g];
        for (int c = 0; c < psz; ++c) x = fmaf(pg_row[c], Vs[c * HD + h], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.out) + (static_cast<int64_t>(b) * a.N + kvh * G) * HD;
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int o = tid + NT * i;
    if (o < n_out) {
      const float l = l_s[o / HD];
      out[o] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
}

template <typename TP, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(a.N / a.K, a.psz);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TP, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B, a.K);
  paged_decode_kernel<TP, HD><<<grid, NT, smem, stream>>>(a);
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
namespace tcpd {

constexpr int WARPS = 2;            // warps of a block, each with its own keys
constexpr int NTT = 32 * WARPS;
constexpr int KEY_BLOCK = ptc::KEY_BLOCK;  // keys per step of a warp
// A split holds whole key steps at every page size (multiples of 16), so
// its inner steps take the unmasked path.
static_assert(SPLIT_PAGES * 16 % KEY_BLOCK == 0, "a split must hold whole key steps");

// Row tiles of 16 heads a block may need: G * H <= 2048, so G <= 16 up to
// H = 128 and at most 128 / H tiles below it.
template <int HD> __host__ __device__ constexpr int max_mt() { return HD >= 128 ? 1 : 128 / HD; }

// The block's shared memory: the G query heads (zero-padded to the row
// tiles) and each warp's ring (csrc/paged_tc.cuh).
template <int HD, bool QUANT>
using Smem = ptc::Ring<HD, QUANT, max_mt<HD>(), WARPS>;

// The new token's K (pass 0) and V (pass 1) of kv head kvh into column
// lp % psz of its page, one warp per pass (ptc::write_row).
template <int HD, bool QUANT>
__device__ __forceinline__ void write_token(const Args& a, int b, int kvh, int lp, const int* pt) {
  const int warp = threadIdx.x / 32;
  const int64_t prow = (a.layer_base + pt[lp / a.psz]) * a.K + kvh;
  const int64_t src = (static_cast<int64_t>(b) * a.K + kvh) * HD;
  for (int pass = warp; pass < 2; pass += WARPS) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(pass == 0 ? a.k_new : a.v_new) + src;
    ptc::write_row<HD, QUANT>(a, x, pass, prow, lp % a.psz);
  }
}

template <int HD, bool QUANT>
__global__ void __launch_bounds__(NTT) paged_decode_tc_kernel(Args a) {
  using Sm = Smem<HD, QUANT>;
  constexpr int LD = Sm::LD, KB = Sm::KB, ROWS = Sm::ROWS;
  constexpr int MAXMT = max_mt<HD>();
  constexpr int NKB = KB / 8;  // 8-key blocks of the logits
  constexpr int NH = HD / 8;   // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.N / a.K, n_mt = (G + 15) / 16;
  const int lp = a.last_pos[b];
  const int split_keys = SPLIT_PAGES * a.psz;
  const Plan pl = plan(lp, a.window, a.psz);
  if (split < pl.s0 || split > pl.s1) return;
  const int* pt = a.page_table + static_cast<int64_t>(b) * a.P;
  Sm sm(smem_raw, warp);

  // This split's keys [klo, khi); the warp takes 32-key steps kb0 + warp,
  // kb0 + warp + WARPS, ... Their first two steps' page ids are read first,
  // so those loads overlap the query's.
  const int klo = max(split * split_keys, pl.lo);
  const int khi = min((split + 1) * split_keys, lp + 1);
  const int kb0 = klo / KB, nkb = (khi + KB - 1) / KB - kb0;
  const int n_w = nkb > warp ? (nkb - warp + WARPS - 1) / WARPS : 0;
  auto k_at = [&](int i) { return (kb0 + warp + i * WARPS) * KB; };
  const ptc::KeyRow kr0 = n_w > 0 ? ptc::key_row(a, pt, k_at(0), klo, khi) : ptc::KeyRow{-1, 0};
  ptc::KeyRow kr = n_w > 1 ? ptc::key_row(a, pt, k_at(1), klo, khi) : ptc::KeyRow{-1, 0};

  // The G query heads of kv head kvh (rows past G zero): one cp.async group.
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           (static_cast<int64_t>(b) * a.N + kvh * G) * HD;
  for (int idx = tid; idx < n_mt * 16 * (HD / 8); idx += NTT) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    tc::cp16(sm.q + r * LD + c, q + (r < G ? r * HD + c : 0), r < G);
  }
  tc::cp_commit();
  // The split owning page lp / psz writes the new token, before any read.
  if (a.k_new != nullptr && split == pl.s1) write_token<HD, QUANT>(a, b, kvh, lp, pt);
  __syncthreads();  // the token's st.global before every cp.async of its page

  if (n_w > 0) ptc::load_step(a, sm, kr0, kvh, 0);
  tc::cp_commit();
  tc::cp_wait<1>();  // this thread's share of Q has landed
  __syncthreads();   // every thread's share has

  float o[MAXMT][NH][4];
  float m_run[MAXMT][2], l_run[MAXMT][2];
#pragma unroll
  for (int mt = 0; mt < MAXMT; ++mt) {
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
    m_run[mt][0] = m_run[mt][1] = NEG_INF;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int i = 0; i < n_w; ++i) {
    const int st = i & 1;
    const int k0 = k_at(i);
    tc::cp_wait_all();
    __syncwarp();  // step i staged; every lane's reads of step i - 1 done
    if (i + 1 < n_w) ptc::load_step(a, sm, kr, kvh, st ^ 1);
    tc::cp_commit();
    // The step after next's page ids: kr is read at the next step's load.
    if (i + 2 < n_w) kr = ptc::key_row(a, pt, k_at(i + 2), klo, khi);
    if constexpr (QUANT) {
      ptc::convert_rows(sm, st, 0, sm.tile());
      if constexpr (Sm::TILES == 2) ptc::convert_rows(sm, st, 1, sm.tile() + KB * LD);
      __syncwarp();  // the tiles are written
    }
    const __nv_bfloat16* kt = QUANT ? sm.tile() : sm.kv(st);
    const __nv_bfloat16* vt = QUANT ? sm.tile() + (Sm::TILES - 1) * KB * LD : kt + KB * LD;
    const float* sc = sm.sc(st);
    // Every key of the step is kept: no mask to apply.
    const bool full = k0 >= klo && k0 + KB <= khi;

#pragma unroll
    for (int mt = 0; mt < MAXMT; ++mt) {
      if (mt >= n_mt) break;
      // S = Q . K^T for the tile's 16 heads x KB keys.
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
      // -inf (a key outside [klo, khi)), then the online softmax per head.
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          float z = s[j][e4] * a.scale;
          if constexpr (QUANT) z *= sc[j * 8 + 2 * tig + (e4 & 1)];
          if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
          if (!full) {
            const int jj = k0 + j * 8 + 2 * tig + (e4 & 1);
            if (jj < klo || jj >= khi) z = -INFINITY;
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
        const float m_new = fmaxf(m_run[mt][h], mx[h]);  // finite: m_run starts at NEG_INF
        alpha[h] = tc::exp_(m_run[mt][h] - m_new);
        m_run[mt][h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int h = e4 >> 1;
          const float p = tc::exp_(s[j][e4] - m_run[mt][h]);  // 0 for a masked key
          sum[h] += p;
          // Under int8 the V scale folds into the probabilities.
          s[j][e4] = QUANT ? p * sc[KB + j * 8 + 2 * tig + (e4 & 1)] : p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_run[mt][h] = l_run[mt][h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
      if constexpr (QUANT && Sm::TILES == 1) {
        __syncwarp();  // every lane's reads of K's tile done
        ptc::convert_rows(sm, st, 1, sm.tile());
        __syncwarp();  // V's tile is written
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
          tc::mma(o[mt][2 * jp], pa, vb[0], vb[1]);
          tc::mma(o[mt][2 * jp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  tc::cp_wait_all();
  __syncthreads();  // every warp is done with its ring: the merge reuses it

  // The warps' states (a warp without keys: O 0, m NEG_INF, l 0), then
  // their merge in warp order.
#pragma unroll
  for (int mt = 0; mt < MAXMT; ++mt) {
    if (mt >= n_mt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * ROWS + mt * 16 + grp + 8 * h;
#pragma unroll
      for (int j = 0; j < NH; ++j)
        *reinterpret_cast<float2*>(sm.o + r * HD + j * 8 + 2 * tig) =
            make_float2(o[mt][j][2 * h], o[mt][j][2 * h + 1]);
      if (tig == 0) *reinterpret_cast<float2*>(sm.ml + 2 * r) = make_float2(m_run[mt][h], l_run[mt][h]);
    }
  }
  __syncthreads();
  const bool direct = pl.s0 == pl.s1;
  const int64_t row0 = static_cast<int64_t>(b) * a.N + kvh * G;
  for (int idx = tid; idx < G * HD; idx += NTT) {
    const int r = idx / HD, h = idx % HD;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, sm.ml[2 * (w * ROWS + r)]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = tc::exp_(sm.ml[2 * (w * ROWS + r)] - m);
      l += sm.ml[2 * (w * ROWS + r) + 1] * e;
      acc += sm.o[(w * ROWS + r) * HD + h] * e;
    }
    const int64_t row = row0 + r;
    if (direct) {
      static_cast<__nv_bfloat16*>(a.out)[row * HD + h] = __float2bfloat16(acc / (l == 0.f ? 1.f : l));
    } else {
      const int64_t prow = static_cast<int64_t>(split) * a.B * a.N + row;
      a.o_part[prow * HD + h] = acc;
      if (h == 0) *reinterpret_cast<float2*>(a.ml_part + 2 * prow) = make_float2(m, l);
    }
  }
}

// The merge of a slot's split partials, in split order (deterministic): one
// thread per (head, column); slots with one active split are skipped (their
// blocks wrote the output directly).
__global__ void __launch_bounds__(256) paged_decode_merge_kernel(Args a, int H) {
  const int b = blockIdx.y, idx = blockIdx.x * 256 + threadIdx.x;
  const Plan pl = plan(a.last_pos[b], a.window, a.psz);
  if (pl.s0 == pl.s1 || idx >= a.N * H) return;
  const int64_t plane = static_cast<int64_t>(a.B) * a.N;
  const int64_t row = static_cast<int64_t>(b) * a.N + idx / H;
  const int h = idx % H;
  float m = NEG_INF;
  for (int sp = pl.s0; sp <= pl.s1; ++sp) m = fmaxf(m, a.ml_part[2 * (sp * plane + row)]);
  float l = 0.f, acc = 0.f;
  for (int sp = pl.s0; sp <= pl.s1; ++sp) {
    const int64_t pr = sp * plane + row;
    const float w = expf(a.ml_part[2 * pr] - m);
    l += a.ml_part[2 * pr + 1] * w;
    acc += a.o_part[pr * H + h] * w;
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
  if (a.N / a.K > 16 * max_mt<HD>()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_tc_kernel<HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_splits, a.K, B);
  paged_decode_tc_kernel<HD, QUANT><<<grid, NTT, smem, stream>>>(a);
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

}  // namespace tcpd

}  // namespace

// dtype (of q, k_new, v_new, out): 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the tensor-core kernel). quant: 0 = the pools are of dtype, 1 =
// int8 pools with float32 scale pools of width SW. k_new/v_new null = no
// write. window <= 0 and softcap <= 0 mean none. Needs (N/K) * H <= 2048.
// bf16 only: the walk splits into n_splits = ceil(P / SPLIT_PAGES) blocks of
// SPLIT_PAGES pages (the grid's width: every page of the table), and o_part /
// ml_part hold [n_splits, B, N, H] / [.., 2] float32 partials (may be null
// when n_splits is 1);
// paged_decode_merge then combines them. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int paged_decode(const void* q, void* k_pool, void* v_pool, float* k_scale,
                            float* v_scale, const void* k_new, const void* v_new,
                            const int* page_table, const int* last_pos, void* out,
                            float* o_part, float* ml_part, int B, int N, int K, int H, int psz,
                            int P, int SW, long long layer_base, int window, float softcap,
                            float scale, int dtype, int quant, int n_splits, void* stream) {
  Args a{q,     k_pool, v_pool, k_scale, v_scale, k_new, v_new, page_table,
         last_pos, out, N,  K,      psz,     P,     SW,    static_cast<int64_t>(layer_base),
         window, softcap, scale, n_splits, B, o_part, ml_part};
  if (B == 0) return 0;
  if (N % K || (N / K) * H > NT * MAXO || psz < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (quant && (k_scale == nullptr || v_scale == nullptr || psz > SW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (n_splits != (P > SPLIT_PAGES ? (P + SPLIT_PAGES - 1) / SPLIT_PAGES : 1) ||
        (n_splits > 1 && (o_part == nullptr || ml_part == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    err = quant ? tcpd::by_head_dim<true>(a, B, H, s) : tcpd::by_head_dim<false>(a, B, H, s);
  } else {
    err = quant ? by_head_dim<int8_t>(a, B, H, s) : by_head_dim<float>(a, B, H, s);
  }
  return static_cast<int>(err);
}

// The bf16 kernel's merge: out [B, N, H] bf16 of every slot whose walk spans
// more than one split, from the partials paged_decode wrote (other slots
// untouched). Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_merge(const float* o_part, const float* ml_part, const int* last_pos,
                                  void* out, int B, int N, int H, int psz, int window,
                                  void* stream) {
  Args a{};
  a.o_part = const_cast<float*>(o_part);
  a.ml_part = const_cast<float*>(ml_part);
  a.last_pos = last_pos;
  a.out = out;
  a.B = B;
  a.N = N;
  a.psz = psz;
  a.window = window;
  if (B == 0) return 0;
  if (psz < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N * H + 255) / 256, B);
  tcpd::paged_decode_merge_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, H);
  return static_cast<int>(cudaGetLastError());
}
