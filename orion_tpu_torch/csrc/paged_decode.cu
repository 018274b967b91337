// K4: paged decode attention with the new token's K/V written in place,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/paged_attention.py::_kernel
// (the pl.pallas_call in _call), both of its pool branches: one query token
// per slot attends that slot's pages of the flat [L*num_pages, K, psz, H]
// pool at rows layer_base + page_table[b, :], after writing the token's own
// K/V into row layer_base + page_table[b, last_pos // psz], column
// last_pos % psz.
//
// What bounds it on an H100: bytes. Each attended key and value is read once
// and used for G = N/K query heads (about 2*G flops per byte in bf16, 4*G in
// int8), far below the ridge point. The design:
//   - one block per (slot, kv head); the block serves all G query heads of
//     its kv head, so every K/V page is read from device memory once, not G
//     times;
//   - the block walks only its slot's live pages, page_table[b, p] for
//     p <= last_pos // psz, skipping pages wholly behind the sliding window,
//     so traffic follows the ragged real context lengths;
//   - the write of the new token happens first, then __syncthreads() (which
//     orders the block's global stores before its later loads) and the page
//     walk reads it like any other key; the pool stays in place, with no
//     external scatter and no copy;
//   - the online-softmax state per head lives in shared memory and the G*H
//     output accumulators in registers across the page loop.
// The int8 branch (pools of int8 with float32 scale pools [rows, K, SW],
// column t = token t's scale) halves the bytes of a bf16 pool. It quantizes
// the new token in the block with the arithmetic of ops/common.py
// quantize_kv, bit for bit: s = max|x| * float(1/127) (a multiply, not a
// divide by 127), floored at 1e-8, q = rintf(x / s) with the IEEE divide
// (this file must not be built with --use_fast_math), and writes the int8
// row and its scale; the page walk then applies the K scale to the logit
// columns after q.k and folds the V scale into the probabilities before p.v,
// so the int8 page is used as it is read.
// Idle slots point at scratch page 0, so several blocks may write page 0 at
// once; page 0 is never read for a live slot, and callers comparing pools
// exclude page-0 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;
constexpr int MAXO = 16;  // output accumulators per thread: G*H <= 2048
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
};

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
template <typename TQ, int HD>
__device__ void quantize_row(const TQ* src, int8_t* dst, float* scale_dst, float* red) {
  float amax = 0.f;
  for (int h = threadIdx.x; h < HD; h += NT) amax = fmaxf(amax, fabsf(to_f32(src[h])));
  const float s = fmaxf(block_max(amax, red) * INV127, 1e-8f);
  for (int h = threadIdx.x; h < HD; h += NT) {
    dst[h] = static_cast<int8_t>(static_cast<int>(rintf(to_f32(src[h]) / s)));
  }
  if (threadIdx.x == 0) *scale_dst = s;
}

template <typename TQ, typename TP, int HD>
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
    const TQ* kn = static_cast<const TQ*>(a.k_new) + src;
    const TQ* vn = static_cast<const TQ*>(a.v_new) + src;
    if constexpr (QUANT) {
      const int64_t sdst = (row * a.K + kvh) * a.SW + lp % psz;
      quantize_row<TQ, HD>(kn, kp + dst, a.k_scale + sdst, red);
      quantize_row<TQ, HD>(vn, vp + dst, a.v_scale + sdst, red);
    } else {
      for (int h = tid; h < HD; h += NT) {
        kp[dst + h] = kn[h];
        vp[dst + h] = vn[h];
      }
    }
  }
  const TQ* q = static_cast<const TQ*>(a.q) + (static_cast<int64_t>(b) * a.N + kvh * G) * HD;
  for (int i = tid; i < G * HD; i += NT) Qs[i] = to_f32(q[i]) * a.scale;
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

  TQ* out = static_cast<TQ*>(a.out) + (static_cast<int64_t>(b) * a.N + kvh * G) * HD;
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int o = tid + NT * i;
    if (o < n_out) {
      const float l = l_s[o / HD];
      out[o] = from_f32<TQ>(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename TQ, typename TP, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(a.N / a.K, a.psz);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TP, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B, a.K);
  paged_decode_kernel<TQ, TP, HD><<<grid, NT, smem, stream>>>(a);
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
// k_new/v_new null = no write. window <= 0 and softcap <= 0 mean none. Needs
// (N/K) * H <= 2048. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int paged_decode(const void* q, void* k_pool, void* v_pool, float* k_scale,
                            float* v_scale, const void* k_new, const void* v_new,
                            const int* page_table, const int* last_pos, void* out, int B, int N,
                            int K, int H, int psz, int P, int SW, long long layer_base,
                            int window, float softcap, float scale, int dtype, int quant,
                            void* stream) {
  Args a{q,     k_pool, v_pool, k_scale, v_scale, k_new, v_new, page_table,
         last_pos, out, N,  K,      psz,     P,     SW,    static_cast<int64_t>(layer_base),
         window, softcap, scale};
  if (B == 0) return 0;
  if ((N / K) * H > NT * MAXO) return static_cast<int>(cudaErrorInvalidValue);
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
