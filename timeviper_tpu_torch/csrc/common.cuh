// Helpers shared by the hand-written Hopper kernels of timeviper_tpu_torch.
//
// Every kernel here is built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into one shared library with a plain C interface (see ops/_cuda.py). The C
// entry points take raw device pointers and the caller's stream, launch, and
// return cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tv {

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ __nv_bfloat16 to_bf(float v) { return __float2bfloat16(v); }

// Inclusive prefix sum over the block (blockDim.x a multiple of 32, <= 1024).
__device__ __forceinline__ float block_inclusive_scan(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    float s = lane < nw ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += warp_sums[w - 1];
  return v;
}

// ---- bf16 tensor-core building blocks (mma.sync m16n8k16, ldmatrix) ----

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The two B fragments (keys 0-7 and 8-15 of a k-step, 8 columns) of a
// row-major [key][col] tile, transposed on the way out of shared memory.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// The four A fragments (16 x 16, rows = columns of the stored tile) of a
// row-major [k][row] tile, transposed on the way out of shared memory: lane l
// passes the address of stored row (l & 7) + 8 * (l >> 4), column 8 * ((l >> 3) & 1).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// One padded row segment of 8 elements from device memory, zero outside.
__device__ __forceinline__ uint4 ld_row8(const __nv_bfloat16* base, bool in) {
  return in ? *reinterpret_cast<const uint4*>(base) : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tv
