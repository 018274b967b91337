// K10: ragged paged attention for speculative verification, the W new
// tokens' K/V written in place, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/ragged_paged_attention.py::
// _kernel (the pl.pallas_call in _call), both of its pool branches, chain and
// tree masks: slot b holds lens[b] real queries at positions start[b] + j;
// their K/V are written into the flat [L*num_pages, K, psz, HD] pool at row
// layer_base + page_table[b, pos / psz], column pos % psz, for pos <= last =
// min(start + lens - 1, P*psz - 1); then every query attends the slot's pages,
// the drafts of the same dispatch included (chain: kv_pos <= start + w; tree:
// the context below start plus the new slots its ancestor word names).
//
// What bounds it on an H100: bytes, as for K4. A verify step attends the same
// pages a decode step does, now for W queries instead of one: about 2*W*G
// flops per byte of bf16 K/V (4*W*G for int8), still far below the ridge
// point for W*G = 20. The design is K4's, widened from G to W*G query rows:
//   - one block per (slot, kv head) serves all W*G query rows of its kv head,
//     so each page is read from device memory ONCE for all W queries -- the
//     amortization that is the point of verifying drafts in one pass, where W
//     single-token decodes would read every page W times;
//   - the W tokens' K/V are written first (one warp per token row; under
//     int8 quantized with ops/common.py quantize_kv's arithmetic, bit for
//     bit), then __syncthreads() orders those global stores before the page
//     walk, which reads the drafts back like any other key: a query sees its
//     drafts exactly as a later decode would (dequantized under int8). Padding
//     tokens (j >= lens) and positions past the table write nothing. Stores
//     are direct: the TPU kernel's one-hot merge was a Mosaic workaround;
//   - the walk covers pages 0 .. last / psz and skips pages wholly behind the
//     EARLIEST query's window; later queries' tighter windows and the chain or
//     tree structure are masks, and a fully masked page is an exact no-op of
//     the online softmax;
//   - per query row an f32 online-softmax state (max, sum) and the output
//     accumulators live in shared memory (W*G*HD floats: 10 KB at W=5, G=4,
//     HD=128); the logits of a page are f32 FMAs over the K page held in
//     shared memory (rows padded by one against bank conflicts).
// The int8 branch applies the K scale to the logit columns after q.k and
// folds the V scale into the probabilities before p.v, as K4-int8 does.
// Shared memory is the limit on W: verify_smem_bytes in
// ops/ragged_paged_attention.py mirrors smem_floats below, and the engine
// rejects a speculate_tokens whose block would not fit. Idle slots point at
// scratch page 0, so several blocks may write page 0 at once; page 0 is never
// read for a live slot, and callers comparing pools exclude page-0 rows.
// Must not be built with --use_fast_math (IEEE divide in the quantization).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
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
};

// Floats of shared memory for R = W*G query rows (the Python fit check
// mirrors this count).
__host__ __device__ inline size_t smem_floats(int R, int HD, int psz, int W) {
  return static_cast<size_t>(2 * R * HD + psz * (2 * HD + 1) + R * psz + 3 * R + 2 * psz +
                             2 * W);
}

// quantize_kv of one HD-vector by one warp: dst (int8) and *scale_dst.
template <typename TQ, int HD>
__device__ void quantize_row_warp(const TQ* src, int8_t* dst, float* scale_dst, int lane) {
  float amax = 0.f;
  for (int h = lane; h < HD; h += 32) amax = fmaxf(amax, fabsf(to_f32(src[h])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax * INV127, 1e-8f);
  for (int h = lane; h < HD; h += 32) {
    dst[h] = static_cast<int8_t>(static_cast<int>(rintf(to_f32(src[h]) / s)));
  }
  if (lane == 0) *scale_dst = s;
}

template <typename TQ, typename TP, int HD>
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
      const TQ* xn = static_cast<const TQ*>(is_v ? a.v_new : a.k_new) + src;
      TP* pool = is_v ? vp : kp;
      if constexpr (QUANT) {
        float* sc = (is_v ? a.v_scale : a.k_scale) + (row * a.K + kvh) * a.SW + pos % psz;
        quantize_row_warp<TQ, HD>(xn, pool + dst, sc, lane);
      } else {
        for (int h = lane; h < HD; h += 32) pool[dst + h] = xn[h];
      }
    }
  }

  // 2. Queries, softmax state, accumulators, tree words.
  for (int i = tid; i < R * HD; i += NT) {
    const int r = i / HD, h = i % HD;
    const int w = r / G, g = r % G;
    const TQ* q = static_cast<const TQ*>(a.q) +
                  ((static_cast<int64_t>(b) * W + w) * a.N + kvh * G + g) * HD;
    Qs[i] = to_f32(q[h]) * a.scale;
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
    TQ* out = static_cast<TQ*>(a.out) +
              ((static_cast<int64_t>(b) * W + w) * a.N + kvh * G + g) * HD;
    out[h] = from_f32<TQ>(Acc[o] / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TP, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.W * (a.N / a.K);
  const size_t smem = sizeof(float) * smem_floats(R, HD, a.psz, a.W);
  cudaError_t err = cudaFuncSetAttribute(ragged_verify_kernel<TQ, TP, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B, a.K);
  ragged_verify_kernel<TQ, TP, HD><<<grid, NT, smem, stream>>>(a);
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

// dtype (of q, k_new, v_new, out): 0 = float32, 1 = bfloat16. quant: 0 = the
// pools are of dtype, 1 = int8 pools with float32 scale pools of width SW.
// k_new/v_new null = no write; words/depths null = the chain mask. window <= 0
// and softcap <= 0 mean none. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int ragged_verify(const void* q, void* k_pool, void* v_pool, float* k_scale,
                             float* v_scale, const void* k_new, const void* v_new,
                             const int* page_table, const int* start, const int* lens,
                             const int* words, const int* depths, void* out, int B, int W,
                             int N, int K, int H, int psz, int P, int SW, long long layer_base,
                             int window, float softcap, float scale, int dtype, int quant,
                             void* stream) {
  Args a{q,     k_pool, v_pool, k_scale, v_scale, k_new, v_new,
         page_table, start, lens, words, depths, out, W, N, K, psz, P, SW,
         static_cast<int64_t>(layer_base), window, softcap, scale};
  if (B == 0) return 0;
  if (W < 1 || N % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (words != nullptr && (depths == nullptr || W > 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant && (k_scale == nullptr || v_scale == nullptr || psz > SW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = quant ? by_head_dim<__nv_bfloat16, int8_t>(a, B, H, s)
                : by_head_dim<__nv_bfloat16, __nv_bfloat16>(a, B, H, s);
  } else {
    err = quant ? by_head_dim<float, int8_t>(a, B, H, s) : by_head_dim<float, float>(a, B, H, s);
  }
  return static_cast<int>(err);
}
