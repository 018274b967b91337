// K1 and K5: RMSNorm forward, and its backward with the scale gradient in
// the same pass, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels orion_tpu/ops/pallas/norms.py::_fwd_kernel (K1)
// and ::_dx_kernel (K5), both launched by the pl.pallas_call in _rows_call:
//   K1: y = x * r * s with r = 1 / sqrt(mean(x^2) + eps), in float32,
//       rounded once to x's dtype;
//   K5: for a cotangent g, dx = r * (u - x * r^2 * mean(u * x)) with
//       u = g * s, in float32, rounded once to x's dtype; and, when the scale
//       needs a gradient, the partial sums of dscale = sum over rows of
//       g * x * r, which the JAX package leaves to XLA beside _dx_kernel as
//       one fused reduction.
//
// What bounds both on an H100: bytes. A few operations an element against 4
// bytes moved (K1 in bf16: x in, y out) or 6 (K5: x and g in, dx out), far
// below the ridge point, so the design moves every byte across device
// memory once, keeps rows in flight, and keeps each warp's serial work
// short:
//   - a row is taken by a group of C warps (C = 4 at D = 2048 in bf16, 7 at
//     3584, 8 at 4096 and 8192, fixed per width at compile time), each warp
//     holding two 16-byte vectors a lane of its columns (four at the widest
//     rows): lane l the group's vectors l, l+32, ..., so one load
//     instruction of a warp moves 512 contiguous bytes. Each warp reduces
//     its part with xor shuffles, and the C partial sums cross the group
//     once a row through shared memory under a named barrier of those C
//     warps alone (one barrier a row: the exchange is double-buffered by the
//     row's parity), added in warp order so every warp gets the same bits.
//     One warp a row would hold 16 vectors a lane at D = 4096 (170
//     registers) and walk its 128 elements a lane as one serial chain, twice:
//     at a decode step's 32 rows 4.2 us against 2.3 for the split row
//     (H100 80GB HBM3);
//   - a persistent grid, SMs x resident blocks (the occupancy API, asked once
//     per kernel and device), whose row groups stride over the rows with the
//     next kDepth - 1 rows' loads in flight in a ring of register buffers; at
//     a decode step's rows the grid is ceil(R / G) blocks of G row groups;
//   - the scale (bfloat16 in a serve, the float32 master weight beside
//     bfloat16 rows in training) is read in the rows' own vector layout
//     through the read-only path: every group of an SM reads the same D
//     elements, so after an SM's first row they come from L1, and no block
//     waits on a staging barrier before its first row;
//   - K5 keeps the scale gradient's per-column float32 accumulators in
//     registers beside x and g: each warp adds g * (x * r) for its columns
//     over the rows its group walks; at the end the block's row groups add
//     theirs to group 0's in group order through shared memory, and the block
//     writes one float32 partial row of the [n_partials, D] scratch the
//     wrapper allocates. The wrapper finishes with partials.sum(0), a plain
//     reduction outside the kernel as XLA's is in the JAX package. No atomics
//     anywhere: two launches give the same bits. dscale moved into K5
//     because it was computed beside K5 by eager PyTorch (float32 upcasts of
//     x and g, the row rsqrt, an einsum lowered to a batched matmul over
//     permuted views): 1.16 ms a call at llama-1b-bench's [16384, 2048], 17
//     times K5's own time, where K5 already holds x, g and r in registers.
// Widths off the compiled table (D other than 32 * E * {8, 14, 16, 28, 32},
// E = 8 bf16 or 4 float32 elements a vector) and rows or scales that are
// not 16-byte aligned take the generic kernels: one warp per row in two
// passes of one element a lane (the second reads the row again, from L1/L2);
// the generic K5 accumulates dscale in one partial row per warp in device memory, each lane
// owning fixed columns, so it too is deterministic and takes any D.
//
// Arithmetic as the plain version: a float32 sum of squares, divided by D,
// plus eps, an IEEE sqrtf and a true divide (this file must not be built
// with --use_fast_math); only the order of the sums differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // warps a block of K1 and of the generic kernels
// Rows a row group keeps loaded or in flight (K1, K5); 2, 3 and 4 timed
// within 1 % of each other (H100 80GB HBM3).
constexpr int kDepth = 3;

template <typename T>
struct Vec;  // elements of T in a 16-byte vector
template <>
struct Vec<bf16> {
  static constexpr int E = 8;
};
template <>
struct Vec<float> {
  static constexpr int E = 4;
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]),
                    tc::pack_bf16(f[4], f[5]), tc::pack_bf16(f[6], f[7]));
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// E consecutive floats of shared memory (16-byte aligned).
template <int E>
__device__ __forceinline__ void load_f(const float* p, float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + k);
    f[k] = t.x;
    f[k + 1] = t.y;
    f[k + 2] = t.z;
    f[k + 3] = t.w;
  }
}

template <int E>
__device__ __forceinline__ void store_f(float* p, const float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// Every lane gets the same bits: float addition is commutative, so each
// xor step leaves partner lanes equal.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float scale_at(const void* s, int s_f32, int j) {
  return s_f32 ? __ldg(static_cast<const float*>(s) + j)
               : __bfloat162float(static_cast<const bf16*>(s)[j]);
}

// The scale's elements v*E .. v*E+E-1 (those of a row's 16-byte vector v)
// as floats, from a bfloat16 or float32 scale 16-byte aligned, through the
// read-only path: every warp of an SM reads the same D elements, so after
// the first row they come from L1.
template <int E>
__device__ __forceinline__ void load_scale(const void* s, int s_f32, int v, float (&f)[E]) {
  if (s_f32) {
    const float4* p = static_cast<const float4*>(s) + v * (E / 4);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 t = __ldg(p + k);
      f[4 * k] = t.x;
      f[4 * k + 1] = t.y;
      f[4 * k + 2] = t.z;
      f[4 * k + 3] = t.w;
    }
  } else if constexpr (E == 8) {
    unpack(__ldg(static_cast<const uint4*>(s) + v), f);
  } else {  // four bf16 beside float32 rows
    const uint2 t = __ldg(static_cast<const uint2*>(s) + v);
    f[0] = __uint_as_float(t.x << 16);
    f[1] = __uint_as_float(t.x & 0xffff0000u);
    f[2] = __uint_as_float(t.y << 16);
    f[3] = __uint_as_float(t.y & 0xffff0000u);
  }
}

// sum of f[e]^2 over a vector, then added to acc: eight (four) short
// independent chains a row instead of one long one.
template <int E>
__device__ __forceinline__ float sum_sq(const float (&f)[E]) {
  float t = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) t = fmaf(f[e], f[e], t);
  return t;
}

// Hide v's value from the compiler, so a second pass unpacks the vector
// again (two integer operations an element) instead of keeping the first
// pass's floats alive: twice a row's registers, which spilled at D = 4096.
__device__ __forceinline__ void launder(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

// A barrier of `threads` threads (whole warps) under id `id` (1-15; 0 is
// __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float rstd(float ss, int D, float eps) {
  return 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
}

// ---------------------------------------------------------------------------
// Row groups (K1 and K5)
// ---------------------------------------------------------------------------

// A block: G row groups of C warps (eight warps, seven at C = 7); a group
// walks rows, its warp cw owning the row's columns [cw * CW, (cw+1) * CW),
// CW = VW * 32 * E (VW 16-byte vectors a lane).
template <int C>
struct Groups {
  static constexpr int G = C >= 5 ? 1 : 8 / C;
  static constexpr int WARPS = C * G;
};

// This warp's VW vectors a lane of row `row` from column col0, with the
// streaming hint (ld.global.cs: K1, 3 % faster than the read-only path) or
// through the read-only path (ld.global.nc: K5's two inputs, 3 % faster
// than streaming; both on an H100 80GB HBM3).
template <typename T, int VW, int C, bool kStream>
__device__ __forceinline__ void load_vecs(uint4* v, const T* p, int row, int col0, int lane) {
  constexpr int D = C * VW * 32 * Vec<T>::E;
  const uint4* q = reinterpret_cast<const uint4*>(p + static_cast<int64_t>(row) * D + col0) + lane;
#pragma unroll
  for (int i = 0; i < VW; ++i) v[i] = kStream ? __ldcs(q + 32 * i) : __ldg(q + 32 * i);
}

// The group's C warps' row sums added in warp order, the same bits in every
// warp; slot: the group's exchange for this row's parity (a warp rewrites
// it two rows later, after every warp of the group has passed the barrier
// of the row between, so one barrier a row suffices).
template <int C>
__device__ __forceinline__ float2 group_sum(float2 v, float2* slot, int grp, int cw, int lane) {
  if constexpr (C == 1) {
    return v;
  } else {
    if (lane == 0) slot[cw] = v;
    bar_sync(1 + grp, C * 32);
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      t.x += slot[k].x;
      t.y += slot[k].y;
    }
    return t;
  }
}

// A row group's walk over rows row, row + stride, ... < R with the next
// kDepth - 1 rows' loads in flight: load(buf, r) issues row r's loads into
// one of kDepth register buffers, step(buf, r, par) consumes them (par: the
// row's parity, for the group's exchange slot).
template <int N, typename Load, typename Step>
__device__ __forceinline__ void walk_rows(int row, int stride, int R, Load load, Step step) {
  uint4 buf[kDepth][N];
#pragma unroll
  for (int k = 0; k < kDepth - 1; ++k)
    if (row + k * stride < R) load(buf[k], row + k * stride);
  int par = 0;
  for (; row < R; row += kDepth * stride) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int r = row + k * stride;
      if (r >= R) return;
      const int next = r + (kDepth - 1) * stride;
      if (next < R) load(buf[(k + kDepth - 1) % kDepth], next);
      step(buf[k], r, par);
      par ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

template <typename T, int VW, int C>
__device__ __forceinline__ void fwd_row(uint4 (&v)[VW], const void* scale, int s_f32,
                                        float2* slot, int grp, int cw, T* out, int row,
                                        int col0, int lane, float eps) {
  constexpr int E = Vec<T>::E, D = C * VW * 32 * E;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VW; ++i) {
    float f[E];
    unpack(v[i], f);
    ss += sum_sq(f);
    launder(v[i]);
  }
  ss = group_sum<C>(make_float2(warp_sum(ss), 0.f), slot, grp, cw, lane).x;
  const float r = rstd(ss, D, eps);
  const int v0 = col0 / E + lane;
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * D + col0) + lane;
#pragma unroll
  for (int i = 0; i < VW; ++i) {
    float f[E], s[E];
    unpack(v[i], f);
    load_scale<E>(scale, s_f32, v0 + 32 * i, s);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = f[e] * r * s[e];
    o[32 * i] = pack(f);
  }
}

// D = C * VW * 32 * E: row group grp takes rows blockIdx.x * G + grp,
// strided over the persistent grid, the next row's loads in flight.
template <typename T, int VW, int C>
__global__ void __launch_bounds__(Groups<C>::WARPS * 32)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ scale, int s_f32,
                       T* __restrict__ out, int R, float eps) {
  constexpr int G = Groups<C>::G, CW = VW * 32 * Vec<T>::E;
  __shared__ float2 xch[G][2][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / C, cw = warp % C, col0 = cw * CW;
  const int stride = gridDim.x * G;
  float2* slot = &xch[grp][0][0];
  walk_rows<VW>(
      blockIdx.x * G + grp, stride, R,
      [&](uint4 (&v)[VW], int r) { load_vecs<T, VW, C, true>(v, x, r, col0, lane); },
      [&](uint4 (&v)[VW], int r, int par) {
        fwd_row<T, VW, C>(v, scale, s_f32, slot + par * C, grp, cw, out, r, col0, lane, eps);
      });
}

// Any D: one warp per row in two passes of one element a lane.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rmsnorm_fwd_generic_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                               int s_f32, T* __restrict__ out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < R; row += stride) {
    const T* xr = x + static_cast<int64_t>(row) * D;
    T* orow = out + static_cast<int64_t>(row) * D;
    float ss = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float f = to_f32(xr[j]);
      ss = fmaf(f, f, ss);
    }
    const float r = rstd(warp_sum(ss), D, eps);
    for (int j = lane; j < D; j += 32)
      orow[j] = from_f32<T>(to_f32(xr[j]) * r * scale_at(scale, s_f32, j));
  }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// One row's chunk of VW * 32 * E columns (this warp's) from column col0:
// the row sums across the group's C warps, dx, and dscale's accumulators.
template <typename T, int VW, int C>
__device__ __forceinline__ void bwd_row(uint4 (&v)[2 * VW], const void* scale,
                                        int s_f32, float2* slot, int grp, int cw, T* dx,
                                        int row, int col0, int lane, float eps,
                                        bool want_ds, float (&acc)[VW][Vec<T>::E]) {
  constexpr int E = Vec<T>::E, D = C * VW * 32 * E;
  const int v0 = col0 / E + lane;  // this lane's first vector of the row
  float ss = 0.f, ux = 0.f;
#pragma unroll
  for (int i = 0; i < VW; ++i) {
    float xf[E], gf[E], s[E];
    unpack(v[i], xf);
    unpack(v[VW + i], gf);
    load_scale<E>(scale, s_f32, v0 + 32 * i, s);
    float t = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) t = fmaf(gf[e] * s[e], xf[e], t);
    ss += sum_sq(xf);
    ux += t;
    launder(v[i]);
    launder(v[VW + i]);
  }
  const float2 sums = group_sum<C>(make_float2(warp_sum(ss), warp_sum(ux)), slot, grp, cw, lane);
  const float r = rstd(sums.x, D, eps);
  const float c = sums.y / static_cast<float>(D);
  uint4* o = reinterpret_cast<uint4*>(dx + static_cast<int64_t>(row) * D + col0) + lane;
#pragma unroll
  for (int i = 0; i < VW; ++i) {
    float xf[E], gf[E], s[E], d[E];
    unpack(v[i], xf);
    unpack(v[VW + i], gf);
    load_scale<E>(scale, s_f32, v0 + 32 * i, s);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float u = gf[e] * s[e];
      const float xr = xf[e] * r;
      d[e] = r * (u - xr * r * c);
      if (want_ds) acc[i][e] = fmaf(gf[e], xr, acc[i][e]);
    }
    o[32 * i] = pack(d);
  }
}

// D = C * VW * 32 * E: row group `grp` of C warps takes rows blockIdx.x * G +
// grp, strided by gridDim.x * G; warp cw of the group owns columns
// [cw * CW, (cw + 1) * CW). part (may be null): [gridDim.x, D] float32.
template <typename T, int VW, int C>
__global__ void __launch_bounds__(Groups<C>::WARPS * 32)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const void* __restrict__ scale, int s_f32, T* __restrict__ dx,
                       float* __restrict__ part, int R, float eps) {
  constexpr int E = Vec<T>::E, G = Groups<C>::G, CW = VW * 32 * E, D = C * CW;
  extern __shared__ __align__(16) float acc_sm[];  // [G - 1][D] row groups 1.. dscale sums
  __shared__ float2 xch[G][2][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / C, cw = warp % C, col0 = cw * CW;
  const int stride = gridDim.x * G;
  const bool want_ds = part != nullptr;

  float acc[VW][E];
#pragma unroll
  for (int i = 0; i < VW; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  float2* slot = &xch[grp][0][0];
  walk_rows<2 * VW>(
      blockIdx.x * G + grp, stride, R,
      [&](uint4 (&v)[2 * VW], int r) {
        load_vecs<T, VW, C, false>(v, x, r, col0, lane);
        load_vecs<T, VW, C, false>(v + VW, g, r, col0, lane);
      },
      [&](uint4 (&v)[2 * VW], int r, int par) {
        bwd_row<T, VW, C>(v, scale, s_f32, slot + par * C, grp, cw, dx, r, col0, lane, eps,
                          want_ds, acc);
      });
  if (!want_ds) return;  // the same for the whole block: no barrier below is split
  if constexpr (G > 1) {
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < VW; ++i)
        store_f<E>(acc_sm + (grp - 1) * D + col0 + (32 * i + lane) * E, acc[i]);
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int k = 0; k < G - 1; ++k) {
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        float t[E];
        load_f<E>(acc_sm + k * D + col0 + (32 * i + lane) * E, t);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += t[e];
      }
    }
  }
  float* prow = part + static_cast<int64_t>(blockIdx.x) * D + col0;
#pragma unroll
  for (int i = 0; i < VW; ++i) store_f<E>(prow + (32 * i + lane) * E, acc[i]);
}

// Any D, as rmsnorm_fwd_generic_kernel. part (may be null): one float32
// partial row per warp, [gridDim.x * kWarps, D], written whole.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rmsnorm_bwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               const void* __restrict__ scale, int s_f32, T* __restrict__ dx,
                               float* __restrict__ part, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  float* prow = part == nullptr ? nullptr : part + static_cast<int64_t>(wid) * D;
  // Each lane owns the columns j = lane (mod 32), the same in every pass, so
  // its partial sums need no synchronization.
  if (prow != nullptr)
    for (int j = lane; j < D; j += 32) prow[j] = 0.f;
  for (int row = wid; row < R; row += stride) {
    const int64_t off = static_cast<int64_t>(row) * D;
    const T *xr = x + off, *gr = g + off;
    T* dr = dx + off;
    float ss = 0.f, ux = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float xf = to_f32(xr[j]), gf = to_f32(gr[j]);
      ss = fmaf(xf, xf, ss);
      ux = fmaf(gf * scale_at(scale, s_f32, j), xf, ux);
    }
    const float r = rstd(warp_sum(ss), D, eps);
    const float c = warp_sum(ux) / static_cast<float>(D);
    for (int j = lane; j < D; j += 32) {
      const float xf = to_f32(xr[j]), gf = to_f32(gr[j]);
      const float u = gf * scale_at(scale, s_f32, j);
      const float xs = xf * r;
      dr[j] = from_f32<T>(r * (u - xs * r * c));
      if (prow != nullptr) prow[j] = fmaf(gf, xs, prow[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks a persistent grid of `fn` may hold on the current device (SMs x
// resident blocks an SM), asked of the occupancy API once per kernel and
// device.
cudaError_t resident(const void* fn, int threads, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int dev, blocks;
  };
  static Entry cache[128];
  static int n = 0;
  static std::mutex mu;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    if (cache[i].fn == fn && cache[i].dev == dev) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  if (n < 128) cache[n++] = Entry{fn, dev, *blocks};
  return cudaSuccess;
}

// The persistent grid: enough blocks for every row once, at most the
// resident ones (more waves timed the same: H100 80GB HBM3).
cudaError_t grid(const void* fn, int threads, int smem, int R, int rows_per_block, int* blocks) {
  int most = 0;
  const cudaError_t err = resident(fn, threads, smem, &most);
  if (err != cudaSuccess) return err;
  const int64_t need = (static_cast<int64_t>(R) + rows_per_block - 1) / rows_per_block;
  *blocks = static_cast<int>(need < most ? need : most);
  return cudaSuccess;
}

template <typename T, int VW, int C>
cudaError_t fwd_fast(const T* x, const void* s, int s_f32, T* out, int R, float eps,
                     cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(rmsnorm_fwd_kernel<T, VW, C>);
  constexpr int threads = Groups<C>::WARPS * 32;
  int blocks;
  const cudaError_t err = grid(fn, threads, 0, R, Groups<C>::G, &blocks);
  if (err != cudaSuccess) return err;
  rmsnorm_fwd_kernel<T, VW, C><<<blocks, threads, 0, st>>>(x, s, s_f32, out, R, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* xp, const void* s, int s_f32, void* outp, int R, int D, float eps,
                cudaStream_t st) {
  constexpr int E = Vec<T>::E;
  const T* x = static_cast<const T*>(xp);
  T* out = static_cast<T*>(outp);
  if (aligned16(x) && aligned16(out) && aligned16(s) && D % (32 * E) == 0) {
    switch (D / (32 * E)) {  // vectors a lane over the row -> (VW, C), as K5's
      case 8: return fwd_fast<T, 2, 4>(x, s, s_f32, out, R, eps, st);
      case 14: return fwd_fast<T, 2, 7>(x, s, s_f32, out, R, eps, st);
      case 16: return fwd_fast<T, 2, 8>(x, s, s_f32, out, R, eps, st);
      case 28: return fwd_fast<T, 4, 7>(x, s, s_f32, out, R, eps, st);
      case 32: return fwd_fast<T, 4, 8>(x, s, s_f32, out, R, eps, st);
      default: break;
    }
  }
  const void* fn = reinterpret_cast<const void*>(rmsnorm_fwd_generic_kernel<T>);
  int blocks;
  const cudaError_t err = grid(fn, kWarps * 32, 0, R, kWarps, &blocks);
  if (err != cudaSuccess) return err;
  rmsnorm_fwd_generic_kernel<T><<<blocks, kWarps * 32, 0, st>>>(x, s, s_f32, out, R, D, eps);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *g, *scale;
  int s_f32;
  void* dx;
  float* part;
  int R, D;
  float eps;
};

// How K5 runs at one (dtype, D, alignment): its kernel, block, shared
// memory, rows a block takes per step and partial rows a block writes.
struct BwdPlan {
  const void* fn;
  void (*launch)(const BwdArgs&, int blocks, cudaStream_t);
  int threads, smem, rows_per_block, partials_per_block;
};

template <typename T, int VW, int C>
void bwd_fast_launch(const BwdArgs& a, int blocks, cudaStream_t st) {
  constexpr int D = C * VW * 32 * Vec<T>::E;
  rmsnorm_bwd_kernel<T, VW, C><<<blocks, Groups<C>::WARPS * 32, (Groups<C>::G - 1) * D * 4, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.scale, a.s_f32,
      static_cast<T*>(a.dx), a.part, a.R, a.eps);
}

template <typename T, int VW, int C>
BwdPlan bwd_fast_plan() {
  constexpr int D = C * VW * 32 * Vec<T>::E, G = Groups<C>::G;
  // G - 1 groups' accumulators, under the 48 KB a block gets without
  // opting in (beside the static row-sum exchange).
  static_assert((G - 1) * D * 4 + G * 2 * C * 8 <= 48 * 1024, "K5 shared memory over 48 KB");
  return BwdPlan{reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, VW, C>),
                 bwd_fast_launch<T, VW, C>, Groups<C>::WARPS * 32, (G - 1) * D * 4, G, 1};
}

template <typename T>
void bwd_generic_launch(const BwdArgs& a, int blocks, cudaStream_t st) {
  rmsnorm_bwd_generic_kernel<T><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.scale, a.s_f32,
      static_cast<T*>(a.dx), a.part, a.R, a.D, a.eps);
}

// fast: x, g, dx and the scale 16-byte aligned and D a multiple of E.
template <typename T>
BwdPlan bwd_plan(int D, int fast) {
  constexpr int E = Vec<T>::E;
  if (fast && D % (32 * E) == 0) {
    // Vectors a lane over the row -> (VW, C): two vectors a lane (with the
    // next row's in flight and the accumulators, about 100 registers, two
    // blocks an SM) up to C = 8 warps, four beyond.
    switch (D / (32 * E)) {
      case 8: return bwd_fast_plan<T, 2, 4>();
      case 14: return bwd_fast_plan<T, 2, 7>();
      case 16: return bwd_fast_plan<T, 2, 8>();
      case 28: return bwd_fast_plan<T, 4, 7>();
      case 32: return bwd_fast_plan<T, 4, 8>();
      default: break;
    }
  }
  return BwdPlan{reinterpret_cast<const void*>(rmsnorm_bwd_generic_kernel<T>),
                 bwd_generic_launch<T>, kWarps * 32, 0, kWarps, kWarps};
}

cudaError_t bwd_grid(int R, int D, int dtype, int fast, BwdPlan* p, int* blocks) {
  *p = dtype == 1 ? bwd_plan<bf16>(D, fast) : bwd_plan<float>(D, fast);
  return grid(p->fn, p->threads, p->smem, R, p->rows_per_block, blocks);
}

}  // namespace

// K1: out [R, D] = rmsnorm(x [R, D]) * scale [D]; dtype 1 bf16, 0 float32
// (x and out); the scale float32 when s_f32, else bf16. Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int R, int D, int dtype,
                           int s_f32, float eps, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || D < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? fwd<bf16>(x, scale, s_f32, out, R, D, eps, st)
                                     : fwd<float>(x, scale, s_f32, out, R, D, eps, st);
  return static_cast<int>(err);
}

// The number of float32 partial rows [n, D] K5 writes for R rows of width D
// (aligned: x, g, dx and the scale all 16-byte aligned), or minus a
// cudaError_t.
extern "C" int rmsnorm_bwd_partials(int R, int D, int dtype, int aligned) {
  if (R < 1 || D < 1 || (dtype != 0 && dtype != 1)) return -static_cast<int>(cudaErrorInvalidValue);
  const int fast = aligned && D % (dtype == 1 ? 8 : 4) == 0;
  BwdPlan p;
  int blocks;
  const cudaError_t err = bwd_grid(R, D, dtype, fast, &p, &blocks);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * p.partials_per_block;
}

// K5: dx [R, D] (x's dtype) of rmsnorm at x for the cotangent g, and, when
// part is not null, dscale's float32 partial rows part [n_part, D]
// (n_part = rmsnorm_bwd_partials(R, D, dtype, aligned)); the caller sums
// them over rows. Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                           float* part, int n_part, int R, int D, int dtype, int s_f32,
                           float eps, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || D < 1 || dx == nullptr || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fast = D % (dtype == 1 ? 8 : 4) == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dx) && aligned16(scale);
  const BwdArgs a{x, g, scale, s_f32, dx, part, R, D, eps};
  BwdPlan p;
  int blocks;
  const cudaError_t err = bwd_grid(R, D, dtype, fast, &p, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (part != nullptr && n_part != blocks * p.partials_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  p.launch(a, blocks, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
