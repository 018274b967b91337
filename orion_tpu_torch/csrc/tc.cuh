// Tensor-core building blocks shared by the bf16 kernels of K3 (flash_fwd.cu),
// K4 (paged_decode.cu), K7 and K8 (flash_bwd.cu) and K9 (paged_prefill.cu):
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads and the
// warp-level mma.sync.m16n8k16 product (bf16 in, f32 accumulate), for sm_90a.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * grp + tig):
//   A (16 x 16, rows x depth): a0 = (grp, 2tig..+1), a1 = (grp+8, 2tig..+1),
//                              a2 = (grp, 2tig+8..+9), a3 = (grp+8, 2tig+8..+9)
//   B (16 x 8, depth x cols):  b0 = (2tig..+1, grp), b1 = (2tig+8..+9, grp)
//   C (16 x 8 f32):            c0, c1 = (grp, 2tig..+1), c2, c3 = (grp+8, 2tig..+1)
// Tiles in shared memory keep rows of H + 8 bf16 (a 16-byte skew per row), so
// the eight row addresses of one ldmatrix phase fall in distinct banks.
// Only the cp.async waits clobber "memory": the copies, fragment loads and
// products are ordered against plain shared-memory stores by __syncthreads()
// (or __syncwarp() where a warp owns the tile), and a clobber on every
// ldmatrix would make the compiler reload every value it keeps in memory
// after each one.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src must
// still be a valid address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !pred.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// Wait until at most N of this thread's committed groups are still pending.
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// A operand (16 rows x 16 depth) of a row-major [rows][ld] bf16 tile at (r0, k0).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld, int r0,
                                       int k0, int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B operands of two 8-column blocks (n0..n0+15) x 16 depth from a tile stored
// [n][k] (the depth contiguous): b[0..1] for columns n0..n0+7, b[2..3] for
// n0+8..n0+15.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* t, int ld,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (the columns contiguous), transposed by
// ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* t, int ld,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// One 8-column block of the same (lanes 0-15 give the addresses).
__device__ __forceinline__ void load_b_kn8(uint32_t (&b)[2], const __nv_bfloat16* t, int ld,
                                           int k0, int n0, int lane) {
  ldsm_x2_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0);
}

// c += a . b on the tensor cores: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (round to nearest even), lo in the low half (the
// lower column): one cvt into a register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// e^x as 2^(x log2 e): one multiply and the MUFU.EX2 instruction.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp_(float x) { return exp2f(x * LOG2E); }

}  // namespace tc
