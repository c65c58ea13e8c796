// Attention forward for Hopper (sm_90a): TMA, an mbarrier ring and wgmma.
// Instantiated by block_attn.cu (K9: head dim 128, GQA heads packed per
// block, segment ids, row statistics, split keys), flash_fwd.cu (K2: K9's
// causal mode with the row log-sum-exp for the backward), vit_attn.cu (K6:
// InternVideo2's head dim 88, v read through its own strides) and
// vit_attn_qkv.cu (K3: SigLIP's head dim 72 and DINOv2's 64, q, k and v read
// in place from the fused qkv rows) and headgrid_attn.cu (K10a: K3's reads at
// head dim 128, several heads a block, the TPU kernel's softmax without a
// row max). flash_bwd.cu (K2-bwd) issues its products with issue_qk and
// issue_pv, roles swapped, in kernels of its own.
//
// What bounds these kernels on the H100 is the tensor cores: 4 * Lq * Lk * D
// products per (batch, head) against a few bytes per row, hundreds of
// operations per byte, so the design keeps the tensor cores fed:
//
// - A block is one producer warpgroup and NWG consumer warpgroups (2 for
//   K9 and K2, 3 for K6 and K3). Each consumer warpgroup owns 64 query rows
//   (the wgmma M tile) and walks the keys in tiles of BKV (128 for K9 and
//   K2; 64 for K6 and K3, whose S, O and P must fit 160 registers a thread).
//   S = Q K^T runs as wgmma m64n{BKV}k16 with Q and K read from shared
//   memory; O += P V runs with P taken from S's accumulator registers,
//   rounded to bf16 (as the plain versions round their probabilities), and
//   V read from shared memory with the transpose bit. Softmax is f32 with a
//   running row max (ex2.approx of pre-scaled logits); each thread keeps its
//   own partial row sum and the four lanes of a row add theirs once at the
//   end.
// - Inside a warpgroup, tile i's Q K^T is issued together with tile i-1's
//   P V, and tile i's softmax runs while that P V is on the tensor cores;
//   the block's consumer warpgroups interleave besides. The first tile is
//   peeled and a short last tile runs apart, so the loop issues one wgmma
//   sequence with no branch around it (ptxas serializes wgmma that it must
//   fence on a divergent path).
// - One thread of the producer warpgroup fills a ring of kStages stages of
//   K (with the keys' segment ids, if any) and of V by TMA
//   (cp.async.bulk.tensor, completion on an mbarrier), so the next tiles'
//   copies overlap this tile's math. K and V have barriers of their own: a
//   consumer releases a K stage once its softmax has read S, and a V stage
//   once its P V has run, so the next K lands while this V is still read.
//   setmaxnreg gives the producer's registers to the consumers (24/240
//   with two consumer warpgroups, 32/160 with three).
// - The tensor maps are 4-D (head dim, heads, rows, batch) over the caller's
//   strides, so q, k and v are read in place: K9's k and v as row ranges of
//   a cache buffer, K6's v and K3's q, k and v as column bands of a fused
//   qkv buffer. A box spans BOXW columns, the width of one swizzle atom (64
//   columns and 128-byte swizzle for D 128 and hd 64; 32 columns and 64-byte
//   swizzle for hd 88 and 72, whose Q K^T depths of 96 and 80 take three
//   boxes): TMA writes each box swizzled, and the wgmma descriptors name the
//   same swizzle. The columns past the head dim (88-95, 72-95) and the rows
//   past the tensor's end are zero-filled by TMA; Q K^T runs over the head
//   dim rounded up to 16, P V at N = head dim.
// - GQA: a block serves `pack` query heads that share one KV head. The Q box
//   is (BOXW columns, pack heads, 64 / pack rows), so the M tile holds
//   (row, head) pairs in row-major order and each K/V tile is loaded once
//   for the pack heads. A question of 12 rows fills 48 of the 64 M rows.
// - A last key tile of at most NARROW keys runs as wgmma m64n{NARROW}k16 and
//   NARROW / 16 P V steps, not as a whole masked tile: K6's 1,025th key
//   (NARROW 16; 2% of its time at 16 clips, bench/attention_ab.py), K3's
//   last 25 keys of 729 or 30 of 734 (NARROW 32).
// - Segment ids (K9, K2) come by TMA with their K tile, from rows padded to
//   a multiple of 4 ids (a box starts on a 16-byte boundary), and the mask
//   is branch-free.
// - Causal (Lq == Lk): the grid runs the last query tiles first (the longest
//   key walks), a block stops at its own diagonal, a consumer skips tiles
//   wholly above its rows, and only tiles that cross the diagonal are masked.
// - Split keys (K9): blockIdx.z = batch * n_split + split; a split walks
//   split_tiles key tiles and writes its normalised o in f32 with its l and
//   m to scratch; block_attn.cu's merge kernel then merges the splits in a
//   fixed order.
// - LSE (K2): the epilogue writes each row's log-sum-exp of the scaled
//   logits, m * scale + log(l), to `l` in place of l and m (+inf for a row
//   that saw no key, so that the backward's exp(s * scale - lse) is 0).
//
// - Softmax policy (template parameter SM): kRunningMax as above; K10a's
//   kNoMax (p = bf16(exp(min(s, 75))), l the sum of those p, nothing
//   subtracted or rescaled: values reach e^75, which bf16 p and the f32 l and
//   P V hold) and kLinear (p = bf16(0.01 s), l = 1). Both pre-scale q as the
//   TPU kernel does, q' = bf16(q * bf16(scale)): each consumer warpgroup
//   scales its own Q rows in shared memory after the Q barrier and fences
//   them for wgmma. With no max a key that TMA zero-filled past Lk would give
//   exp(0) = 1, so the last tile's mask (whole or narrow) keeps keys < Lk.
// - Heads a block (template parameter HPP, K10a): the block walks HPP heads
//   (groups of `pack`) in turn with one K/V ring that runs on across the head
//   boundary, and two Q buffers, so the next head's Q and first K/V tiles
//   load while this head's last tiles run.
//
// A row that sees no key keeps l = 0, m = -inf and o = 0.
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is looked up at run time

#include "common.cuh"

namespace tv {
namespace sm90 {

constexpr int kNarrow = 16;  // the default NARROW: a last tile of at most 16 keys runs as N = 16
constexpr int kStages = 2;   // K and V stages in the ring

enum class Softmax { kRunningMax, kNoMax, kLinear };

struct AttnParams {
  CUtensorMap tq, tk, tv;  // 4-D maps (head dim, heads, rows, batch)
  CUtensorMap tseg;        // map over the keys' segment ids, if seg_kv is given
  __nv_bfloat16* o;        // (B, Lq, Hq, HD) bf16, unless o_part is given
  float* o_part;           // (n_split, B, Lq, Hq, HD) f32 normalised partials, or null
  float* l;                // (n_split, B, Hq, Lq) row sums (LSE: log-sum-exps), or null
  float* m;                // (n_split, B, Hq, Lq) row maxima of the scaled logits, or null
  const int* seg_q;        // (B, Lq) segment ids of the rows, or null
  const int* seg_kv;       // (B, Lk rounded up to 4) ids of the keys; null iff seg_q is
  int B, Lq, Lk, Hq, Hkv, pack, n_split, split_tiles;
  float scale, scale_log2;  // softmax scale, and it times log2(e)
};

// HD: head dim; BOXW: columns of a TMA box (one swizzle span); NWG:
// consumer warpgroups; BKV: keys a tile.
template <int HD, int BOXW, int NWG, int BKV>
struct Shape {
  static constexpr int HDP = (HD + 15) / 16 * 16;      // Q K^T depth
  static constexpr int NBOX = (HDP + BOXW - 1) / BOXW;  // column boxes a row
  static constexpr int SWZ = BOXW * 2;                  // swizzle span (bytes of a box row)
  static constexpr int Q_BOX = 64 * SWZ;                // bytes of one Q box (64 rows)
  static constexpr int KV_BOX = BKV * SWZ;              // bytes of one K or V box
  static constexpr int Q_BYTES = NWG * NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;        // K (or V) of one stage
  static constexpr int threads = 128 * (NWG + 1);
  static constexpr int ACC = HD / 2;                    // O accumulator floats a thread
  static constexpr int P_REGS = BKV / 16;               // P fragments: 16 keys each
  static constexpr size_t smem = 1024 + Q_BYTES + 2 * kStages * KV_BYTES +
                                 kStages * BKV * sizeof(int) + 8 * (1 + 4 * kStages);
  static_assert(SWZ == 128 || SWZ == 64 || SWZ == 32, "a box row is one swizzle span");
  static_assert(HD % 8 == 0, "wgmma N is a multiple of 8");
};

// ---- barriers, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, and the swizzle (128 B: 1, 64 B: 2, 32 B: 3).
template <int SWZ>
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = SWZ == 128 ? 1 : (SWZ == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// d (64 x 128 f32, 64 a thread) (+)= A (64 x 16, smem) * B (128 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32, 32 a thread) (+)= A (64 x 16, smem) * B (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 f32, 16 a thread) (+)= A (64 x 16, smem) * B (32 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16 f32, 8 a thread) (+)= A (64 x 16, smem) * B (16 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32, 64 a thread) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 88 f32, 44 a thread) += A (64 x 16, registers) * B (16 x 88, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[44], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
      "}, {%44, %45, %46, %47}, %48, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 72 f32, 36 a thread) += A (64 x 16, registers) * B (16 x 72, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[36], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32, 32 a thread) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T of the first NCOL keys of a stage of BKV-key tiles: K-major
// operands, 16 columns a step over the padded depth. Fences the registers
// the threads wrote before it, and commits one group.
template <int HD, int BOXW, int BKV, int NCOL>
__device__ __forceinline__ void issue_qk(float (&s)[NCOL / 2], uint32_t q_addr, uint32_t k_addr) {
  using S = Shape<HD, BOXW, 1, BKV>;
  constexpr int SWZ = S::SWZ, KS = S::HDP / 16;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int box = ks * 16 / BOXW, off = (ks * 16 % BOXW) * 2;
    wgmma_ss(s, mdesc<SWZ>(q_addr + box * S::Q_BOX + off, 16, 8 * SWZ),
             mdesc<SWZ>(k_addr + box * S::KV_BOX + off, 16, 8 * SWZ), ks > 0);
  }
  wg_commit();
}

// O += P V over the first NCOL keys of a stage: P from registers, V
// MN-major (the transpose bit). Fences, and commits one group.
template <int HD, int BOXW, int BKV, int NCOL>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[NCOL / 16][4],
                                         uint32_t v_addr) {
  using S = Shape<HD, BOXW, 1, BKV>;
  constexpr int SWZ = S::SWZ;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NCOL / 16; ++kk)
    wgmma_rs(o, pa[kk], mdesc<SWZ>(v_addr + kk * 16 * SWZ, S::KV_BOX, 8 * SWZ));
  wg_commit();
}

// 2^x in one instruction (2^-22 relative; -inf gives 0): the softmax's
// exponent, where exp2f's extra instructions cost K9 a tenth of its time.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Mask one tile's logits, then its online softmax in place: s becomes P,
// the running max mr and this thread's partial sums lr move on, and alpha
// is what the running output must be scaled by. Element e of chunk j is
// row a (e < 2, token ta, segment sa) or b, key kv0 + 8 j + cq + (e & 1).
template <int NCOL, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[NCOL / 2], float (&mr)[2], float (&lr)[2],
                                             float (&alpha)[2], const int* segk, int kv0,
                                             int kv_end, bool mask, int ta, int tb, int sa,
                                             int sb, float sl2) {
  constexpr int NJ = NCOL / 8;
  const int cq = (threadIdx.x & 3) * 2;
  if (mask) {  // branch-free: the ids of a key pair are read as one int2
    const bool seg = segk != nullptr;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int2 ids = seg ? *reinterpret_cast<const int2*>(segk + j * 8 + cq) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kv0 + j * 8 + cq + (e & 1), t = e < 2 ? ta : tb;
        const int id = (e & 1) ? ids.y : ids.x, want = seg ? (e < 2 ? sa : sb) : 0;
        const bool ok = kp < kv_end && (!CAUSAL || kp <= t) && id == want;
        s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
      }
    }
  }
  // in raw logit units; 2^x of the pre-scaled difference
  float mx[2] = {mr[0], mr[1]};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with no visible key yet keeps m = -inf and takes p = 0
    alpha[r] = mx[r] == -INFINITY ? 1.f : ex2((mr[r] - mx[r]) * sl2);
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;
    mr[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -base[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
  lr[0] = lr[0] * alpha[0] + sum[0];
  lr[1] = lr[1] * alpha[1] + sum[1];
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// K10a's probabilities of one tile in place, without a row max. kNoMax:
// p = bf16(exp(min(s, 75))) of the pre-scaled logits, this thread's partial
// row sums lr += p; kLinear: p = 0.01 s (rounded to bf16 by to_bf16). With
// `mask`, keys at or past kv_end give p = 0 (TMA zero-fills them, and
// exp(0) is 1).
template <int NCOL, Softmax SM>
__device__ __forceinline__ void probs_nomax(float (&s)[NCOL / 2], float (&lr)[2], int kv0,
                                            int kv_end, bool mask) {
  constexpr int NJ = NCOL / 8;
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !mask || kv0 + j * 8 + cq + (e & 1) < kv_end;
      float x = s[4 * j + e];
      if (SM == Softmax::kNoMax) {
        x = __bfloat162float(__float2bfloat16(ex2(fminf(x, 75.f) * 1.4426950408889634f)));
        x = ok ? x : 0.f;
        lr[e >> 1] += x;
      } else {
        x = ok ? x * 0.01f : 0.f;
      }
      s[4 * j + e] = x;
    }
  }
}

// P rounded to bf16: S's accumulator layout is the register A operand's.
template <int NP>
__device__ __forceinline__ void to_bf16(const float (&s)[NP * 8], uint32_t (&pa)[NP][4]) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// K10a: this consumer warpgroup's Q rows in place, q' = bf16(q * bf16(scale))
// (one rounding of the exact product, as the TPU kernel's bf16 multiply),
// then fenced for wgmma, which reads shared memory through the async proxy,
// and synchronised over the warpgroup's 128 threads (named barrier 1 + w).
template <int BYTES>
__device__ __forceinline__ void prescale_q(uint8_t* q, float scale, int w) {
  const __nv_bfloat162 sc = __float2bfloat162_rn(__bfloat162float(__float2bfloat16(scale)));
  uint4* v = reinterpret_cast<uint4*>(q);
#pragma unroll 4
  for (int i = threadIdx.x & 127; i < BYTES / 16; i += 128) {
    uint4 x = v[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hmul2(h[k], sc);
    v[i] = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // the id in a register makes ptxas reserve all 16 barriers, yet K10a ran
  // 6-9% faster with it than with literal ids behind a branch on w (PERF.md)
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// grid (ceil(Lq * pack / (64 NWG)), Hq / (pack HPP), B * n_split),
// Shape::threads threads, smem_bytes<...>() of dynamic shared memory. LSE:
// write the row log-sum-exp to p.l (if given) in place of l and m. NARROW:
// the widest last key tile that runs as one narrow step (16 or 32). SM: the
// softmax policy; HPP: head groups a block walks in turn.
template <int HD, int BOXW, int NWG, int BKV, bool CAUSAL, bool LSE, int NARROW,
          Softmax SM = Softmax::kRunningMax, int HPP = 1>
__global__ void __launch_bounds__(Shape<HD, BOXW, NWG, BKV>::threads, 1)
    attn_sm90_kernel(const __grid_constant__ AttnParams p) {
  using S = Shape<HD, BOXW, NWG, BKV>;
  constexpr bool kMax = SM == Softmax::kRunningMax;
  constexpr int QBUF = HPP > 1 ? 2 : 1;  // Q buffers: the next head's Q loads early
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;                              // [QBUF][NWG][NBOX][64][BOXW]
  uint8_t* sK = sQ + QBUF * S::Q_BYTES;            // [kStages][NBOX][BKV][BOXW]
  uint8_t* sV = sK + kStages * S::KV_BYTES;        // [kStages][NBOX][BKV][BOXW]
  int* segk = reinterpret_cast<int*>(sV + kStages * S::KV_BYTES);  // [kStages][BKV]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(segk + kStages * BKV);  // [QBUF]
  uint64_t* k_full = q_full + QBUF;      // [kStages]: the stage's K (and ids) have landed
  uint64_t* k_empty = k_full + kStages;  // [kStages]: every consumer is done with them
  uint64_t* v_full = k_empty + kStages;  // [kStages]: the same for V
  uint64_t* v_empty = v_full + kStages;
  uint64_t* q_empty = v_empty + kStages;  // [QBUF], HPP > 1: a Q buffer is free again

  const int mt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // long rows first
  const int b = blockIdx.z / p.n_split, split = blockIdx.z % p.n_split;
  const int pack = p.pack, tok = 64 / pack;  // tokens a consumer warpgroup
  const int t0 = mt * NWG * tok;
  const int kv_begin = split * p.split_tiles * BKV;
  int kv_end = min(p.Lk, kv_begin + p.split_tiles * BKV);
  if (CAUSAL) kv_end = min(kv_end, t0 + NWG * tok);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  const int n_active = min(NWG, (p.Lq - t0 + tok - 1) / tok);  // consumers with rows
  const bool seg = p.seg_kv != nullptr;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
#pragma unroll
    for (int qb = 0; qb < QBUF; ++qb) mbar_init(&q_full[qb], 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&k_empty[st], n_active * 128);
      mbar_init(&v_full[st], 1);
      mbar_init(&v_empty[st], n_active * 128);
    }
    if (HPP > 1)
      for (int qb = 0; qb < QBUF; ++qb) mbar_init(&q_empty[qb], n_active * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    regs_dec<NWG == 2 ? 24 : 32>();
    if (tid != 0) return;
#pragma unroll 1
    for (int hh = 0; hh < HPP; ++hh) {
      const int g = blockIdx.y * HPP + hh, qb = hh % QBUF, it0 = hh * n_tiles;
      const int hk = g * pack / (p.Hq / p.Hkv);
      uint8_t* q_buf = sQ + qb * S::Q_BYTES;
      if (HPP > 1) mbar_wait(&q_empty[qb], ((hh / QBUF) & 1) ^ 1);
      mbar_expect_tx(&q_full[qb], n_active * S::NBOX * S::Q_BOX);
      for (int w = 0; w < n_active; ++w)
        for (int c = 0; c < S::NBOX; ++c)
          tma_load_4d(q_buf + (w * S::NBOX + c) * S::Q_BOX, &p.tq, &q_full[qb], c * BOXW,
                      g * pack, t0 + w * tok, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = (it0 + i) % kStages, kv0 = kv_begin + i * BKV;
        const uint32_t free_parity = (((it0 + i) / kStages) & 1) ^ 1;
        mbar_wait(&k_empty[st], free_parity);
        mbar_expect_tx(&k_full[st], S::KV_BYTES + (seg ? BKV * sizeof(int) : 0));
        for (int c = 0; c < S::NBOX; ++c)
          tma_load_4d(sK + st * S::KV_BYTES + c * S::KV_BOX, &p.tk, &k_full[st], c * BOXW, hk,
                      kv0, b);
        // the tile's key segment ids (those past Lk are masked by position)
        if (seg) tma_load_2d(segk + st * BKV, &p.tseg, &k_full[st], kv0, b);
        mbar_wait(&v_empty[st], free_parity);
        mbar_expect_tx(&v_full[st], S::KV_BYTES);
        for (int c = 0; c < S::NBOX; ++c)
          tma_load_4d(sV + st * S::KV_BYTES + c * S::KV_BOX, &p.tv, &v_full[st], c * BOXW, hk,
                      kv0, b);
      }
    }
  } else {
    // ---- consumers: 64 (row, head) pairs each ----
    regs_inc<NWG == 2 ? 240 : 160>();
    const int w = wg - 1;
    if (w >= n_active) return;
    const int lane = tid & 31, r_a = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int t_lo = t0 + w * tok, t_hi = min(p.Lq, t_lo + tok) - 1;
    const int ta = t_lo + r_a / pack, tb = t_lo + (r_a + 8) / pack;
    int sa = 0, sb = 0;
    if (p.seg_q != nullptr) {
      if (ta < p.Lq) sa = p.seg_q[(long long)b * p.Lq + ta];
      if (tb < p.Lq) sb = p.seg_q[(long long)b * p.Lq + tb];
    }
    // causal: the tiles past this warpgroup's last row are only released
    const int n_own = CAUSAL ? min(n_tiles, (t_hi - kv_begin) / BKV + 1) : n_tiles;
    // Tile i's Q K^T runs on the tensor cores beside tile i-1's P V, and its
    // softmax beside that P V: S and the pending P live in registers at once.
    // The first tile is peeled and a short last one runs apart, so that the
    // loop issues the same wgmma sequence every time.
    const bool narrow_last = n_own > 0 && kv_end - (kv_begin + (n_own - 1) * BKV) <= NARROW;
    const int n_full = n_own - (narrow_last ? 1 : 0);
    auto kv_of = [&](int i) { return kv_begin + i * BKV; };
    auto masked = [&](int i) {
      return seg || kv_of(i) + BKV > kv_end || (CAUSAL && kv_of(i) + BKV - 1 > t_lo);
    };

#pragma unroll 1
    for (int hh = 0; hh < HPP; ++hh) {
      const int g = blockIdx.y * HPP + hh, qb = hh % QBUF, it0 = hh * n_tiles;
      const int ha = g * pack + r_a % pack, hb = g * pack + (r_a + 8) % pack;
      float o[S::ACC];
#pragma unroll
      for (int i = 0; i < S::ACC; ++i) o[i] = 0.f;
      float mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f}, alpha[2];
      float s[BKV / 2];
      uint32_t pa[S::P_REGS][4];
      uint8_t* q_buf = sQ + qb * S::Q_BYTES + w * S::NBOX * S::Q_BOX;
      const uint32_t q_addr = smem_u32(q_buf);
      // the softmax of tile i in place (s becomes P; kMax: mr, alpha move on)
      const float sl2 = p.scale_log2;
      auto softmax = [&](auto& sx, int i, int st, bool mask) {
        constexpr int NC = sizeof(sx) / sizeof(float) * 2;
        if constexpr (kMax)
          softmax_tile<NC, CAUSAL>(sx, mr, lr, alpha, seg ? segk + st * BKV : nullptr, kv_of(i),
                                   kv_end, mask, ta, tb, sa, sb, sl2);
        else
          probs_nomax<NC, SM>(sx, lr, kv_of(i), kv_end, mask);
      };

      mbar_wait(&q_full[qb], (hh / QBUF) & 1);
      __syncwarp();
      if constexpr (!kMax) prescale_q<S::NBOX * S::Q_BOX>(q_buf, p.scale, w);
      if (n_full > 0) {
        const int st = it0 % kStages;
        mbar_wait(&k_full[st], (it0 / kStages) & 1);
        __syncwarp();
        issue_qk<HD, BOXW, BKV, BKV>(s, q_addr, smem_u32(sK + st * S::KV_BYTES));
        wg_wait<0>();
        pin(s);
        softmax(s, 0, st, masked(0));
        mbar_arrive(&k_empty[st]);
        to_bf16<S::P_REGS>(s, pa);
      }
      for (int i = 1; i < n_full; ++i) {
        const int st = (it0 + i) % kStages, pst = (it0 + i - 1) % kStages;
        mbar_wait(&k_full[st], ((it0 + i) / kStages) & 1);
        __syncwarp();
        issue_qk<HD, BOXW, BKV, BKV>(s, q_addr, smem_u32(sK + st * S::KV_BYTES));
        mbar_wait(&v_full[pst], ((it0 + i - 1) / kStages) & 1);
        __syncwarp();
        issue_pv<HD, BOXW, BKV, BKV>(o, pa, smem_u32(sV + pst * S::KV_BYTES));
        wg_wait<1>();
        pin(s);
        softmax(s, i, st, masked(i));
        mbar_arrive(&k_empty[st]);
        wg_wait<0>();
        pin(o);
        pin(pa);
        mbar_arrive(&v_empty[pst]);
        if constexpr (kMax) rescale(o, alpha);
        to_bf16<S::P_REGS>(s, pa);
      }
      if (n_full > 0) {
        const int pst = (it0 + n_full - 1) % kStages;
        mbar_wait(&v_full[pst], ((it0 + n_full - 1) / kStages) & 1);
        __syncwarp();
        issue_pv<HD, BOXW, BKV, BKV>(o, pa, smem_u32(sV + pst * S::KV_BYTES));
        wg_wait<0>();
        pin(o);
        pin(pa);
        mbar_arrive(&v_empty[pst]);
      }
      if (narrow_last) {  // at most NARROW keys: one narrow step, not overlapped
        const int i = n_own - 1, st = (it0 + i) % kStages;
        const uint32_t parity = ((it0 + i) / kStages) & 1;
        float sn[NARROW / 2];
        uint32_t pn[NARROW / 16][4];
        mbar_wait(&k_full[st], parity);
        __syncwarp();
        issue_qk<HD, BOXW, BKV, NARROW>(sn, q_addr, smem_u32(sK + st * S::KV_BYTES));
        wg_wait<0>();
        pin(sn);
        softmax(sn, i, st, true);
        mbar_arrive(&k_empty[st]);
        if constexpr (kMax) rescale(o, alpha);
        to_bf16<NARROW / 16>(sn, pn);
        mbar_wait(&v_full[st], parity);
        __syncwarp();
        issue_pv<HD, BOXW, BKV, NARROW>(o, pn, smem_u32(sV + st * S::KV_BYTES));
        wg_wait<0>();
        pin(o);
        pin(pn);
        mbar_arrive(&v_empty[st]);
      }
      for (int i = n_own; i < n_tiles; ++i) {  // causal: after every row of this warpgroup
        const int st = (it0 + i) % kStages;
        const uint32_t parity = ((it0 + i) / kStages) & 1;
        mbar_wait(&k_full[st], parity);
        mbar_arrive(&k_empty[st]);
        mbar_wait(&v_full[st], parity);
        mbar_arrive(&v_empty[st]);
      }
      if (HPP > 1) mbar_arrive(&q_empty[qb]);  // every wgmma that read this Q has run

      // ---- epilogue: normalise and write this thread's two rows ----
      const int cq = (lane & 3) * 2;
      if constexpr (SM != Softmax::kLinear) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 1);
          lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 2);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r == 0 ? ta : tb, h = r == 0 ? ha : hb;
        if (t >= p.Lq) continue;
        float inv;
        if constexpr (kMax)
          inv = lr[r] > 0.f ? 1.f / lr[r] : 0.f;
        else if constexpr (SM == Softmax::kNoMax)
          inv = 1.f / fmaxf(lr[r], 1e-30f);
        else
          inv = 1.f;
        const long long row = ((long long)split * p.B + b) * p.Lq + t;
        if (p.l != nullptr && (lane & 3) == 0) {
          const long long i = (((long long)split * p.B + b) * p.Hq + h) * p.Lq + t;
          if (LSE) {
            p.l[i] = lr[r] > 0.f ? mr[r] * p.scale + logf(lr[r]) : INFINITY;
          } else {
            p.l[i] = lr[r];
            p.m[i] = mr[r] == -INFINITY ? -INFINITY : mr[r] * p.scale;
          }
        }
        if (p.o_part != nullptr) {
          float* dst = p.o_part + (row * p.Hq + h) * HD + cq;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        } else {
          __nv_bfloat16* dst = p.o + (row * p.Hq + h) * HD + cq;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---- host side ----

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D bf16 map over (head dim, heads, rows, batch) with element strides
// hs, rs, bs, read in boxes of (box_w, box_h, box_r, 1), swizzled by the box
// row's width (box_w * 2 bytes). Returns false if the driver refuses it.
inline bool encode_map(CUtensorMap* map, const void* base, int hd, int heads, int rows,
                       int batch, long long hs, long long rs, long long bs, int box_w, int box_h,
                       int box_r) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hs * 2, (cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, (cuuint32_t)box_h, (cuuint32_t)box_r, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = box_w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : box_w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An int32 map over B rows of `ld` ids (ld a multiple of 4, a 16-byte
// aligned base), read box_n ids of one row at a time: TMA starts a box's
// innermost extent on a 16-byte boundary.
inline bool encode_ids(CUtensorMap* map, const int* base, int ld, int B, int box_n) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ld % 4 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(int)};
  const cuuint32_t box[2] = {(cuuint32_t)box_n, 1}, unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of attn_sm90_kernel: a second Q buffer and three more
// barriers when a block walks several heads.
template <int HD, int BOXW, int NWG, int BKV, int HPP>
constexpr size_t smem_bytes() {
  using S = Shape<HD, BOXW, NWG, BKV>;
  return S::smem + (HPP > 1 ? S::Q_BYTES + 8 * 3 : 0);
}

template <int HD, int BOXW, int NWG, int BKV, bool CAUSAL, bool LSE = false, int NARROW = kNarrow,
          Softmax SM = Softmax::kRunningMax, int HPP = 1>
int launch(const AttnParams& p, cudaStream_t stream) {
  using S = Shape<HD, BOXW, NWG, BKV>;
  static_assert(NARROW % 16 == 0 && NARROW < BKV, "a narrow step is whole k-steps of P V");
  static_assert(SM == Softmax::kRunningMax || !(CAUSAL || LSE),
                "K10a's softmax takes no causal mask and writes no row statistics");
  constexpr size_t smem = smem_bytes<HD, BOXW, NWG, BKV, HPP>();
  auto kernel = attn_sm90_kernel<HD, BOXW, NWG, BKV, CAUSAL, LSE, NARROW, SM, HPP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((p.Hq / p.pack) % HPP != 0) return cudaErrorInvalidValue;
  const int rows = NWG * 64 / p.pack;  // tokens a block
  const dim3 grid((p.Lq + rows - 1) / rows, p.Hq / p.pack / HPP, p.B * p.n_split);
  kernel<<<grid, S::threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace tv
