// K3: flash-attention forward for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (the pl.pallas_call in _fwd_call): grouped-query attention with an online
// softmax, causal mask with q_offset, segment ids (with the seg_pad_zero
// block skip), sliding window and logit softcap. Layout at the interface is
// the JAX package's: q/o [B, Sq, N, H], k/v [B, Skv, K, H], contiguous.
//
// What bounds it on an H100: operations. Prefill attention does ~2*H
// multiply-adds per (query, key) pair against ~4*H bytes per query row, far
// above the card's ridge point. This first version computes the products as
// plain f32 FMAs on the CUDA cores (no wgmma, no TMA), so it is bounded by
// the 67 TFLOP/s f32 rate, not the tensor cores; making it tensor-core bound
// is later work. What the design does about the bound it has:
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
// A row with nothing attended returns 0 (l == 0 -> l_safe = 1), not NaN.
// Padded query rows (segment 0) hold garbage that the caller discards.
//
// With a non-null `lse`, the kernel also writes each row's log-sum-exp of
// its attended logits, m + log(l), as float32 [B, N, Sq] (NEG_INF where
// the row attends nothing): the residual the backward kernels K7/K8
// (flash_bwd.cu) recompute the probabilities from. Serving passes null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;       // [B, N, Sq] or null
  const int* qseg;  // [B, Sq] or null
  const int* kseg;  // [B, Skv] or null
  int Sq, Skv, N, K;
  int causal, q_offset, window, seg_pad_zero;
  float softcap, scale;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int HC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][HD+1], pre-scaled by H^-0.5
  float* Ks = Qs + BQ * (HD + 1);      // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* Ps = Vs + BK * HD;            // [BQ][BK+1] probabilities
  int* qseg_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BQ]
  int* kseg_s = qseg_s + BQ;                                 // [BK]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

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
    if (s < a.Sq) x = to_f32(q[((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + h]);
    Qs[r * (HD + 1) + h] = x * a.scale;
  }
  if (tid < BQ) {
    const int s = q0 + tid;
    qseg_s[tid] = (has_seg && s < a.Sq) ? a.qseg[static_cast<int64_t>(b) * a.Sq + s] : 0;
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

  float acc[4][HC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps/kseg_s are done
    if (tid < BK) {
      const int c = k0 + tid;
      kseg_s[tid] = (has_seg && c < a.Skv) ? a.kseg[static_cast<int64_t>(b) * a.Skv + c] : 0;
    }
    const int kv_live = __syncthreads_or(tid < BK && kseg_s[tid] > 0);
    if (skip_pad && !(kv_live && q_live)) continue;  // uniform over the block

    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, h = i % HD, s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < a.Skv) {
        const int64_t g = ((static_cast<int64_t>(b) * a.Skv + s) * a.K + kvh) * HD + h;
        kx = to_f32(k[g]);
        vx = to_f32(v[g]);
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
          const int d = qpos - c;
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
    T* orow = o + ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD;
#pragma unroll
    for (int hc = 0; hc < HC; ++hc) orow[cg + 16 * hc] = from_f32<T>(acc[i][hc] / l_safe);
    // m_i / l_i are equal across the 16 threads of a row group (shuffle-reduced).
    if (a.lse != nullptr && cg == 0) {
      a.lse[(static_cast<int64_t>(b) * a.N + n) * a.Sq + s] =
          l_i[i] == 0.f ? NEG_INF : m_i[i] + logf(l_i[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(const Args& a, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none;
// lse may be null. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* qseg, const int* kseg, int B, int Sq, int Skv,
                         int N, int K, int H, int causal, int q_offset, int window,
                         int seg_pad_zero, float softcap, float scale, int dtype,
                         void* stream) {
  Args a{q, k, v, o, lse, qseg, kseg, Sq, Skv, N, K, causal, q_offset, window,
         seg_pad_zero, softcap, scale};
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? by_head_dim<__nv_bfloat16>(a, B, H, s)
                               : by_head_dim<float>(a, B, H, s);
  return static_cast<int>(err);
}
