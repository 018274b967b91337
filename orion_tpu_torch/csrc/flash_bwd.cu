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
// measured against. This first version computes the products as plain f32
// FMAs on the CUDA cores, like K3 (no wgmma, no TMA), so it runs at the
// 67 TFLOP/s f32 rate at best. What the design does about the bound and the
// card:
//   - K7: one block per (q tile of 64 rows, q head, batch); Pallas's
//     sequential kv grid axis becomes a loop over kv tiles of 32 keys with
//     dq carried in registers (4 rows x H/16 columns per thread) and
//     written once.
//   - K8: one block per (kv tile of 32 keys, kv head, batch). Pallas
//     carries dk/dv in VMEM scratch across its sequential (group, q tile)
//     grid axes; blocks on the card run in no order, so the loop over the
//     G query heads of the group and over the q tiles lives inside the
//     block, with dk/dv in registers (2 rows x H/16 columns each per
//     thread). No atomics: each dk/dv row is written by exactly one thread
//     once, so the result does not depend on scheduling.
//   - Both use K3's tiles (64 queries x 32 keys) and K3's score loop, so a
//     tile that K3 skipped (past the causal diagonal, behind the window,
//     or all padding under seg_pad_zero) is skipped here too, and the
//     recomputed logits are K3's bit for bit: exp(z - lse) never sees a
//     logit that lse did not count.
//   - The mask goes inside the exponential, exp(keep ? z - lse : NEG_INF),
//     never exp(z - lse) * mask: a row that attends nothing carries
//     lse = NEG_INF, and exp(z - NEG_INF) would be inf (inf * 0 = NaN).
//     Query rows past Sq are masked the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile (K3's)
constexpr int BK = 32;   // keys per tile (K3's)
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

  __device__ explicit Tile(float* smem) {
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
  }

  static constexpr size_t bytes() {
    return sizeof(float) * (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + 2 * BQ * (BK + 1) + 2 * BQ) +
           sizeof(int) * (BQ + BK);
  }
};

// Row-level inputs of q tile q0 of head n: lse, delta, segment ids.
// Rows past Sq get lse = NEG_INF and are masked by in_q() below.
template <int HD>
__device__ __forceinline__ void load_rows(const Args& a, Tile<HD>& t, int b, int n, int q0,
                                          bool has_seg) {
  const int tid = threadIdx.x;
  if (tid < BQ) {
    const int s = q0 + tid;
    const bool in = s < a.Sq;
    const int64_t row = (static_cast<int64_t>(b) * a.N + n) * a.Sq + s;
    t.lse_s[tid] = in ? a.lse[row] : NEG_INF;
    t.delta_s[tid] = in ? a.delta[row] : 0.f;
    t.qseg_s[tid] = (has_seg && in) ? a.qseg[static_cast<int64_t>(b) * a.Sq + s] : 0;
  }
}

// q (pre-scaled, as K3 does) and dO rows of q tile q0, head n.
template <typename T, int HD>
__device__ __forceinline__ void load_q(const Args& a, Tile<HD>& t, int b, int n, int q0) {
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, h = i % HD, s = q0 + r;
    float x = 0.f, d = 0.f;
    if (s < a.Sq) {
      const int64_t g = ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD + h;
      x = to_f32(q[g]);
      d = to_f32(dout[g]);
    }
    t.Qs[r * (HD + 1) + h] = x * a.scale;
    t.dOs[r * (HD + 1) + h] = d;
  }
}

// k and v rows of kv tile k0, kv head kvh, and their segment ids.
template <typename T, int HD>
__device__ __forceinline__ void load_kv(const Args& a, Tile<HD>& t, int b, int kvh, int k0,
                                        bool has_seg) {
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if (threadIdx.x < BK) {
    const int c = k0 + threadIdx.x;
    t.kseg_s[threadIdx.x] =
        (has_seg && c < a.Skv) ? a.kseg[static_cast<int64_t>(b) * a.Skv + c] : 0;
  }
  for (int i = threadIdx.x; i < BK * HD; i += NT) {
    const int c = i / HD, h = i % HD, s = k0 + c;
    float kx = 0.f, vx = 0.f;
    if (s < a.Skv) {
      const int64_t g = ((static_cast<int64_t>(b) * a.Skv + s) * a.K + kvh) * HD + h;
      kx = to_f32(k[g]);
      vx = to_f32(v[g]);
    }
    t.Ks[c * (HD + 1) + h] = kx;
    t.Vs[c * (HD + 1) + h] = vx;
  }
}

// dS (and P) of the tile pair (q0, k0) into Ss (and Ps when keep_p).
// Thread layout as K3's score phase: rows r0..r0+3, keys cg and cg+16.
template <int HD>
__device__ __forceinline__ void tile_ds(const Args& a, Tile<HD>& t, int q0, int k0,
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
        const int d = qpos - c;
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
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dq_kernel(Args a) {
  constexpr int HC = HD / 16;  // dq columns per thread
  extern __shared__ float smem[];
  Tile<HD> t(smem);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (a.N / a.K);
  const int cg = tid % 16, r0 = (tid / 16) * 4;
  const bool has_seg = a.qseg != nullptr;
  const bool skip_pad = has_seg && a.seg_pad_zero;

  load_q<T, HD>(a, t, b, n, q0);
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

  float acc[4][HC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ss/kseg_s are done
    load_kv<T, HD>(a, t, b, kvh, k0, has_seg);
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

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + r0 + i;
    if (s >= a.Sq) continue;
    T* row = dq + ((static_cast<int64_t>(b) * a.Sq + s) * a.N + n) * HD;
#pragma unroll
    for (int hc = 0; hc < HC; ++hc) row[cg + 16 * hc] = from_f32<T>(acc[i][hc] * a.scale);
  }
}

// K8: one block per (kv tile, kv head, batch), looping over the group's
// query heads and the q tiles.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Args a) {
  constexpr int HC = HD / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  Tile<HD> t(smem);
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.N / a.K;
  const int cg = tid % 16, kr0 = (tid / 16) * 2;  // kv rows kr0, kr0+1 of the tile
  const bool has_seg = a.qseg != nullptr;
  const bool skip_pad = has_seg && a.seg_pad_zero;

  load_kv<T, HD>(a, t, b, kvh, k0, has_seg);
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

  float dk[2][HC], dv[2][HC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int n = kvh * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's reads of Qs/dOs/Ps/Ss/row data are done
      load_rows<HD>(a, t, b, n, q0, has_seg);
      const int q_live = __syncthreads_or(tid < BQ && t.qseg_s[tid] > 0);
      if (skip_pad && !q_live) continue;  // uniform over the block
      load_q<T, HD>(a, t, b, n, q0);
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

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + kr0 + i;
    if (c >= a.Skv) continue;
    const int64_t base = ((static_cast<int64_t>(b) * a.Skv + c) * a.K + kvh) * HD;
#pragma unroll
    for (int hc = 0; hc < HC; ++hc) {
      dkp[base + cg + 16 * hc] = from_f32<T>(dk[i][hc]);
      dvp[base + cg + 16 * hc] = from_f32<T>(dv[i][hc]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int B, bool dq, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::bytes();
  if (dq) {
    cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.N, B);
    flash_dq_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((a.Skv + BK - 1) / BK, a.K, B);
    flash_dkv_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(const Args& a, int B, int H, bool dq, cudaStream_t stream) {
  switch (H) {
    case 16: return launch<T, 16>(a, B, dq, stream);
    case 32: return launch<T, 32>(a, B, dq, stream);
    case 64: return launch<T, 64>(a, B, dq, stream);
    case 128: return launch<T, 128>(a, B, dq, stream);
    case 256: return launch<T, 256>(a, B, dq, stream);
    default: return cudaErrorInvalidValue;
  }
}

// An empty kv (K7) or q (K8) range still launches and writes zeros.
int run(const Args& a, int B, int H, int dtype, bool dq, void* stream) {
  if (B == 0 || (dq ? a.Sq : a.Skv) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? by_head_dim<__nv_bfloat16>(a, B, H, dq, s)
                               : by_head_dim<float>(a, B, H, dq, s);
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none.
// Segment pointers may be null. Return cudaGetLastError() after the launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, const int* qseg,
                        const int* kseg, int B, int Sq, int Skv, int N, int K, int H,
                        int causal, int q_offset, int window, int seg_pad_zero,
                        float softcap, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, qseg, kseg, Sq, Skv, N, K,
         causal, q_offset, window, seg_pad_zero, softcap, scale};
  return run(a, B, H, dtype, true, stream);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv,
                         const int* qseg, const int* kseg, int B, int Sq, int Skv, int N,
                         int K, int H, int causal, int q_offset, int window,
                         int seg_pad_zero, float softcap, float scale, int dtype,
                         void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, qseg, kseg, Sq, Skv, N, K, causal,
         q_offset, window, seg_pad_zero, softcap, scale};
  return run(a, B, H, dtype, false, stream);
}
