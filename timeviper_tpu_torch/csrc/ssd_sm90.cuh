// The pieces the Hopper passes of K1 (ssd_fwd.cu) and K4 (ssd_bwd.cu) are
// built from: 64-row operand tiles copied by 16-byte cp.async into the
// 128-byte swizzle that TMA would write and attn_sm90.cuh's wgmma
// descriptors name, the swizzled reads around them, and a named barrier per
// consumer warpgroup.
#pragma once

#include "attn_sm90.cuh"

namespace tv {
namespace ssd {

using sm90::smem_u32;

constexpr int kBox = 64 * 128;    // 64 rows of 64 bf16 columns, 128-byte swizzled
constexpr int kNTile = 2 * kBox;  // 64 rows of N = 128 columns: two boxes

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Make what this thread wrote to shared memory (by cp.async or by stores)
// visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Wait for all of this thread's copies (committed or not), and make them
// visible to wgmma.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async();
}
// Wait until at most N of this thread's committed copy groups are pending,
// and make the landed ones visible to wgmma.
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  fence_async();
}

// Byte offset of the 16-byte chunk c (of 8 columns) of row r in a swizzled box.
__device__ __forceinline__ int sw_off(int r, int c) { return r * 128 + (((c & 7) ^ (r & 7)) << 4); }

// 64 rows of COLS bf16 columns (row r at src + r * ld; rows >= valid read
// zero, from the valid address `any`) into 128-byte swizzled boxes of 64
// columns at dst, box k at dst + k kBox: the layout TMA's 128-byte swizzle
// gives. NT threads, thread t.
template <int COLS, int NT>
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* src, size_t ld,
                                          int valid, int t, const __nv_bfloat16* any) {
  constexpr int CH = COLS / 8;  // 16-byte chunks a row
#pragma unroll
  for (int e = t; e < 64 * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < valid;
    cp16(dst + (c >> 3) * kBox + sw_off(r, c), ok ? src + (size_t)r * ld + c * 8 : any, ok);
  }
}

// n floats (a multiple of 4) from src to dst by 16-byte copies, 128 threads.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n, int t) {
  for (int e = t; e < n / 4; e += 128) cp16(dst + 4 * e, src + 4 * e, true);
}

// Eight bf16 values times scale, rounded to bf16 again, in one 16-byte word.
__device__ __forceinline__ uint4 scale8(uint4 raw, float scale) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_uint4(pack_bf16(bf(v[0]) * scale, bf(v[1]) * scale),
                    pack_bf16(bf(v[2]) * scale, bf(v[3]) * scale),
                    pack_bf16(bf(v[4]) * scale, bf(v[5]) * scale),
                    pack_bf16(bf(v[6]) * scale, bf(v[7]) * scale));
}

// Two bf16 values at (row r, column c), c even, of a swizzled box.
__device__ __forceinline__ float2 ld_sw(const uint8_t* box, int r, int c) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(box + sw_off(r, c >> 3) + (c & 7) * 2);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Named barrier of the 128 threads of consumer warpgroup wg: id 1 + wg, so a
// kernel uses ids 1 up to its count of consumer warpgroups (1-4 in
// ssd_fwd.cu's chunk_scan, 1-2 in its chunk_state and in ssd_bwd.cu's walk).
// Id 0 is __syncthreads; a kernel built on this header names no other
// barrier in that range.
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

}  // namespace ssd
}  // namespace tv
