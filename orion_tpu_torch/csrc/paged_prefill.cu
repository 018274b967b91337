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
// operations on the tensor cores in principle. This first version is simple
// and right, not fast: f32 FMAs on the CUDA cores, like K3 and K4, with no
// wgmma or TMA. The TPU grid (B, NC, P_pre + NC) walks pages sequentially and
// re-applies the write on clamped revisits that exist only to elide DMAs; on
// Hopper the design is instead:
//   - one block per (row, page-sized q block, q head): the q block's psz
//     queries of one head stay in shared memory, and the block loops over
//     its history pages and then over the chunk pages cb <= qb with an f32
//     online softmax, psz/256 of a row's keys and H*psz/256 of its outputs
//     per thread (a row's 256/psz threads reduce with warp shuffles);
//   - it skips, as the TPU kernel does, history pages at or past start, pages
//     wholly behind the window of the block's earliest query, and q blocks
//     past lens (their outputs are written as zeros, finite garbage);
//   - exactly one block writes each (chunk page, kv head): the one of q block
//     cb and the first query head of the kv head's group, whether or not the
//     block attends; no write is repeated. History pages are never chunk
//     pages of the same launch, so reads and writes do not race. Pad rows
//     (all-zero walk) write scratch page 0, several at once in no order;
//     page 0 is never read.
// K/V pages are read from device memory once per query head of their group
// (G times; the repeats mostly hit L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
};

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

// dtype (of q, k_new, v_new, out): 0 = float32, 1 = bfloat16. quant: 0 = the
// pools are of dtype, 1 = int8 pools with float32 scale pools of width SW.
// psz must be a power of two in [16, 128] and S = NC * psz. window <= 0 and
// softcap <= 0 mean none. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int paged_prefill(const void* q, void* k_pool, void* v_pool, float* k_scale,
                             float* v_scale, const void* k_new, const void* v_new,
                             const int* walk, const int* start, const int* lens, void* out,
                             int B, int S, int N, int K, int H, int psz, int P_pre, int NC,
                             int SW, long long layer_base, int window, float softcap,
                             float scale, int dtype, int quant, void* stream) {
  Args a{q,  k_pool, v_pool, k_scale, v_scale, k_new,  v_new, walk, start,
         lens, out, S,  N,       K,       psz,   P_pre, NC,   SW,
         static_cast<int64_t>(layer_base), window, softcap, scale};
  if (B == 0 || NC == 0) return 0;
  if (psz < 16 || psz > 128 || (psz & (psz - 1)) || S != NC * psz || N % K)
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
