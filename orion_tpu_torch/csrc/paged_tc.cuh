// The paged page walk of the bf16 tensor-core kernels K4 (paged_decode.cu)
// and K10 (ragged_verify.cu), shared: each warp of a block streams its own
// 32-key steps of a slot's pages through a two-stage shared-memory ring by
// 16-byte cp.async, the page id of each key resolved a step ahead; int8
// pages land raw with their scales and are converted to bf16 in shared
// memory; the slot's new tokens are written into their pages first, raw or
// under int8 with quantize_kv's bits. The pool is the flat [rows, K, psz,
// HD] layout; a kernel's Args supply k_pool, v_pool, k_scale, v_scale,
// layer_base, K, psz and SW under those names.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace ptc {

constexpr int KEY_BLOCK = 32;  // keys per step of a warp
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

// A block's shared memory: the query rows (ROWS = 16 * MT, zero-padded) and
// WARPS rings, which the warps' end-of-walk states reuse.
template <int HD_, bool QUANT_, int MT, int WARPS>
struct Ring {
  static constexpr int HD = HD_;
  static constexpr bool QUANT = QUANT_;
  static constexpr int LD = HD + 8;    // bf16 row stride
  static constexpr int LD8 = HD + 16;  // int8 row stride (bytes)
  static constexpr int KB = KEY_BLOCK;
  static constexpr int ROWS = 16 * MT;
  // int8 pools: bf16 tiles a warp converts a step into. With one row tile
  // K's tile is dead once S is computed and V's conversion reuses it; with
  // several row tiles each tile's S and P.V interleave, so K and V get a
  // tile each.
  static constexpr int TILES = MT == 1 ? 1 : 2;
  static constexpr size_t Q_BYTES = sizeof(__nv_bfloat16) * ROWS * LD;
  // A warp's ring: bf16 pools [2 stages][K [KB][LD], V [KB][LD]]; int8 pools
  // [2][K, V [KB][LD8]] raw, [2][K, V scales [KB]], and the bf16 tiles.
  static constexpr size_t RAW_BYTES = 2 * 2 * KB * LD8;
  static constexpr size_t SC_BYTES = sizeof(float) * 2 * 2 * KB;
  static constexpr size_t WARP_BYTES =
      QUANT ? RAW_BYTES + SC_BYTES + sizeof(__nv_bfloat16) * TILES * KB * LD
            : sizeof(__nv_bfloat16) * 2 * 2 * KB * LD;
  // After the walk the rings hold the warps' states: O [WARPS][ROWS][HD] and
  // (m, l) [WARPS][ROWS][2], float32.
  static constexpr size_t MERGE_BYTES = sizeof(float) * WARPS * ROWS * (HD + 2);
  static constexpr size_t RING_BYTES =
      WARPS * WARP_BYTES > MERGE_BYTES ? WARPS * WARP_BYTES : MERGE_BYTES;
  __host__ __device__ static constexpr size_t bytes() { return Q_BYTES + RING_BYTES; }

  __nv_bfloat16* q;   // [ROWS][LD] the block's query rows
  unsigned char* w;   // this warp's ring
  float* o;           // the merge: [WARPS][ROWS][HD]
  float* ml;          // [WARPS][ROWS][2]

  __device__ Ring(unsigned char* base, int warp) {
    q = reinterpret_cast<__nv_bfloat16*>(base);
    w = base + Q_BYTES + warp * WARP_BYTES;
    o = reinterpret_cast<float*>(base + Q_BYTES);
    ml = o + WARPS * ROWS * HD;
  }
  __device__ __nv_bfloat16* kv(int st) const {
    return reinterpret_cast<__nv_bfloat16*>(w) + st * 2 * KB * LD;
  }
  __device__ int8_t* raw(int st) const { return reinterpret_cast<int8_t*>(w) + st * 2 * KB * LD8; }
  __device__ float* sc(int st) const { return reinterpret_cast<float*>(w + RAW_BYTES) + st * 2 * KB; }
  __device__ __nv_bfloat16* tile() const {
    return reinterpret_cast<__nv_bfloat16*>(w + RAW_BYTES + SC_BYTES);
  }
};

// One warp writes one HD-row x (bf16) of K (which 0) or V (1) into column
// col of pool row prow (= (layer_base + page) * K + kv head): raw, or under
// int8 quantize_kv's bits, as ops/common.py quantize_kv computes them: s =
// max|x| * float(1/127) (a multiply, not a divide by 127), floored at 1e-8,
// q = rintf(x / s) with the IEEE divide (the including source must not be
// built with --use_fast_math), and the scale into column col of the scale
// pool.
template <int HD, bool QUANT, class A>
__device__ __forceinline__ void write_row(const A& a, const __nv_bfloat16* x, int which,
                                          int64_t prow, int col) {
  using TP = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  const int lane = threadIdx.x % 32;
  TP* pool = static_cast<TP*>(which == 0 ? a.k_pool : a.v_pool) + (prow * a.psz + col) * HD;
  if constexpr (QUANT) {
    float amax = 0.f;
    for (int h = lane; h < HD; h += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[h])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fmaxf(amax * INV127, 1e-8f);
    for (int h = lane; h < HD; h += 32)
      pool[h] = static_cast<int8_t>(static_cast<int>(rintf(__bfloat162float(x[h]) / s)));
    if (lane == 0) (which == 0 ? a.k_scale : a.v_scale)[prow * a.SW + col] = s;
  } else {
    if (lane < HD / 8)
      reinterpret_cast<uint4*>(pool)[lane] = reinterpret_cast<const uint4*>(x)[lane];
  }
}

// Where key k0 + lane of a step lives, for the lane that resolves it: its
// page id as the table holds it (-1 for a key outside [klo, khi), never
// read) and its column in the page. One page-table load per lane and step,
// issued a step ahead; the arithmetic on the loaded id waits for load_step,
// so the load's latency is not on the step's path.
struct KeyRow {
  int page, col;
};
template <class A>
__device__ __forceinline__ KeyRow key_row(const A& a, const int* pt, int k0, int klo, int khi) {
  const int j = k0 + static_cast<int>(threadIdx.x % 32), pg = j / a.psz;
  if (j < klo || j >= khi) return {-1, 0};
  return {pt[pg], j - pg * a.psz};
}

// Asynchronous load, by one warp, of the 32 keys of a step into ring stage
// st: K/V rows (and, int8, their scales) where kr (lane r's KeyRow for key
// r) names one, zeros for the others; PART 0 loads only K (and its
// scales), 1 only V, -1 both. A row's 16-byte chunks go to neighbouring
// lanes (coalesced), so each lane takes its row's element offset from the
// lane that resolved the key.
template <int PART = -1, class Sm, class A>
__device__ __forceinline__ void load_step(const A& a, const Sm& sm, KeyRow kr, int kvh, int st) {
  constexpr int HD = Sm::HD, LD = Sm::LD, LD8 = Sm::LD8, KB = Sm::KB;
  constexpr int EL = Sm::QUANT ? 16 : 8;  // elements per 16-byte chunk
  constexpr int CH = HD / EL;             // chunks per row
  constexpr int I0 = PART == 1 ? KB * CH : 0, I1 = PART == 0 ? KB * CH : 2 * KB * CH;
  const int lane = threadIdx.x % 32;
  const int64_t prow = (a.layer_base + kr.page) * a.K + kvh;
  const int64_t eoff = kr.page >= 0 ? (prow * a.psz + kr.col) * HD : -1;
#pragma unroll 4
  for (int idx = I0 + lane; idx < I1; idx += 32) {
    const int which = idx / (KB * CH), r = (idx / CH) % KB, c = (idx % CH) * EL;
    const int64_t e = __shfl_sync(0xffffffffu, eoff, r);
    if constexpr (Sm::QUANT) {
      const int8_t* pool = static_cast<const int8_t*>(which ? a.v_pool : a.k_pool);
      tc::cp16(sm.raw(st) + which * KB * LD8 + r * LD8 + c, pool + (e >= 0 ? e + c : 0), e >= 0);
    } else {
      const __nv_bfloat16* pool = static_cast<const __nv_bfloat16*>(which ? a.v_pool : a.k_pool);
      tc::cp16(sm.kv(st) + which * KB * LD + r * LD + c, pool + (e >= 0 ? e + c : 0), e >= 0);
    }
  }
  if constexpr (Sm::QUANT) {
    const int64_t soff = kr.page >= 0 ? prow * a.SW + kr.col : 0;
    if constexpr (PART != 1) tc::cp4(sm.sc(st) + lane, a.k_scale + soff, kr.page >= 0);
    if constexpr (PART != 0) tc::cp4(sm.sc(st) + KB + lane, a.v_scale + soff, kr.page >= 0);
  }
}

// A barrier over the N threads (whole warps) that name barrier ID (1-15; 0
// is __syncthreads()), with __syncthreads()'s ordering of their
// shared-memory accesses. The ID is a constant, so ptxas reserves only the
// barriers a kernel names.
template <int ID, int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

// Four int8 (one 32-bit word) as two bf16 pairs, exact, on the integer and
// f32 pipes (not the quarter-rate conversion unit): 0x4B000000 | (x + 128)
// is the float 2^23 + x + 128, less 2^23 + 128 it is x exactly, and the
// upper half of an f32 that holds an integer |x| <= 128 is bf16(x) exactly.
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    f[t] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + t)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// int8 -> bf16 of one warp's K (which 0) or V (1) rows of ring stage st
// into dst [KB][LD], exact (|x| <= 127); the scales stay in sc(st).
template <class Sm>
__device__ __forceinline__ void convert_rows(const Sm& sm, int st, int which, __nv_bfloat16* dst) {
  constexpr int LD = Sm::LD, LD8 = Sm::LD8, KB = Sm::KB;
  constexpr int CH = Sm::HD / 16;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < KB * CH / 32; ++i) {
    const int idx = lane + 32 * i, r = idx / CH, c = (idx % CH) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(sm.raw(st) + which * KB * LD8 + r * LD8 + c);
    const uint2 y0 = i8x4_to_bf16(w.x), y1 = i8x4_to_bf16(w.y);
    const uint2 y2 = i8x4_to_bf16(w.z), y3 = i8x4_to_bf16(w.w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * LD + c);
    d[0] = make_uint4(y0.x, y0.y, y1.x, y1.y);
    d[1] = make_uint4(y2.x, y2.y, y3.x, y3.y);
  }
}

}  // namespace ptc
