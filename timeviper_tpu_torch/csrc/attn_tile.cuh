// Tiled online-softmax attention forward on bf16 tensor cores, shared by
// flash_fwd.cu (causal GQA prefill), vit_attn_qkv.cu (non-causal whole-frame
// ViT attention from the fused qkv buffer) and vit_attn.cu (non-causal
// whole-clip attention from separate q, k and v).
//
// One block of BQ / 16 warps owns BQ query rows of one (batch, head); each
// warp owns 16 of them and streams the keys in tiles of BKV. The tile shape
// is a template parameter, (64, 64) by default: every path launches that
// instantiation (4 warps), and the K2 microbenchmark
// (bench/microbench_flash.py) sweeps (64 | 128) x (64 | 128). Both
// products run as mma.sync.m16n8k16 (bf16 in, f32 accumulate): S = Q K^T with
// Q held in registers for the whole walk and K read from shared memory, then
// O += P V with P taken straight from S's accumulator registers (rounded to
// bf16, as the plain version rounds its probabilities) and V's fragments
// read transposed out of shared memory by ldmatrix. Tiles move from device
// memory in 16-byte vectors. Row max and sum are f32 and shared by the four
// lanes of a row through shuffles. A head dim that is no multiple of 16
// (SigLIP's 72, InternVideo2's 88) is zero-padded to the next one (80, 96)
// for Q K^T only.
//
// Every row stride and head offset must be a multiple of 8 elements and the
// base pointers 16-byte aligned (the wrappers check).
//
// Element (b, t, h, d) of q sits at q + b*q_bs + t*q_rs + h*q_hs + d, and the
// same for k, v and o: the caller's strides let one kernel read heads
// straight out of a fused projection buffer. v shares k's strides, unless the
// kernel is instantiated with OWN_V and takes AttnArgsV (vit_attn.cu: v is a
// column slice of the qkv buffer while q and k come from the q/k norms).
// AttnArgs itself stays as it is: on the H100, 16 more bytes in it changed
// the instruction schedule of K2 and K3 and slowed both (see PERF.md), so
// the shared-stride instantiations keep their smaller argument struct.
//
// Instantiated with LM (block_attn.cu, K9) the kernel takes AttnArgsLM: the
// query rows' segment ids come from `seg` (B, Lq) and the keys' from
// `seg_kv` (B, Lk), so a rectangular block (Lq != Lk) can be masked, and
// each row's running sum l and max m of the scaled logits are written as
// (B, Hq, Lq) f32 instead of the log-sum-exp. A row that sees no key keeps
// l = 0, m = -inf and an output of 0.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tv {

constexpr int kAttnBQ = 64;   // the default tile: query rows a block
constexpr int kAttnBKV = 64;  // and keys a tile

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* seg;  // (B, L) segment ids for self-attention, or null
  float* lse = nullptr;  // (B, Hq, Lq) row log-sum-exp of the scaled logits, or null
  long long q_bs, k_bs, o_bs;
  int q_rs, q_hs, k_rs, k_hs, o_rs, o_hs;  // v shares k's strides
  int Lq, Lk, Hq, Hkv;
  float scale;
};

struct AttnArgsV : AttnArgs {
  long long v_bs;
  int v_rs, v_hs;
};

struct AttnArgsLM : AttnArgs {
  const int* seg_kv;  // (B, Lk) segment ids of the keys; null iff seg is
  float* l;           // (B, Hq, Lq) row sum of exp(s - m)
  float* m;           // (B, Hq, Lq) row max of the scaled logits s
};

template <bool OWN_V, bool LM = false>
using AttnArgsOf =
    std::conditional_t<LM, AttnArgsLM, std::conditional_t<OWN_V, AttnArgsV, AttnArgs>>;

template <int HD, int BQ = kAttnBQ, int BKV = kAttnBKV>
struct AttnShape {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // Q K^T depth, padded
  // row stride of the Q, K and V tiles: 16-byte rows whose 32-bit word
  // offsets step by 4 (mod 32) from row to row, so fragment loads and
  // ldmatrix rows fall on distinct banks
  static constexpr int LD = HDP + 8;
  static constexpr int VPR = HDP / 8;  // 16-byte vectors in a padded row
  static constexpr int threads = 2 * BQ;  // a warp per 16 query rows
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (BQ + 2 * BKV) * LD + sizeof(int) * BKV;
};

// grid (ceil(Lq / BQ), Hq, B), 2 * BQ threads, AttnShape<HD, BQ, BKV>::smem of
// dynamic smem.
template <int HD, bool CAUSAL, bool OWN_V = false, bool LM = false, int BQ = kAttnBQ,
          int BKV = kAttnBKV>
__global__ void __launch_bounds__(AttnShape<HD, BQ, BKV>::threads)
    attn_fwd_kernel(AttnArgsOf<OWN_V, LM> a) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  using S = AttnShape<HD, BQ, BKV>;
  static_assert(BKV <= S::threads, "one thread per key loads the key segments");
  constexpr int kAttnThreads = S::threads;
  constexpr int KS = S::HDP / 16, NO = HD / 8, NT = BKV / 8, LD = S::LD, VPR = S::VPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                                 // [BKV][LD]
  __nv_bfloat16* Vs = Ks + BKV * LD;                                // [BKV][LD]
  int* segk = reinterpret_cast<int*>(Vs + BKV * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const __nv_bfloat16* qb = a.q + b * a.q_bs + (long long)h * a.q_hs;
  const __nv_bfloat16* kb = a.k + b * a.k_bs + (long long)hk * a.k_hs;
  const __nv_bfloat16* vb = a.v + b * a.k_bs + (long long)hk * a.k_hs;
  if constexpr (OWN_V) vb = a.v + b * a.v_bs + (long long)hk * a.v_hs;

  for (int e = tid; e < BQ * VPR; e += kAttnThreads) {
    const int r = e / VPR, d = (e % VPR) * 8, t = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * LD + d) =
        ld_row8(qb + (long long)t * a.q_rs + d, t < a.Lq && d < HD);
  }
  __syncthreads();

  // this lane's rows of the tile: r0 and r0 + 8; its column pair: cq, cq + 1
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* p = Qs + r0 * LD + ks * 16 + cq;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * LD);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * LD + 8);
  }
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  int segq[2] = {0, 0};
  if (a.seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (qpos[i] < a.Lq) segq[i] = a.seg[(long long)b * a.Lq + qpos[i]];
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int kv_end = CAUSAL ? min(a.Lk, q0 + BQ) : a.Lk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's Ks and Vs are no longer read
    for (int e = tid; e < BKV * VPR; e += kAttnThreads) {
      const int j = e / VPR, d = (e % VPR) * 8, t = kv0 + j;
      const bool in = t < a.Lk && d < HD;
      *reinterpret_cast<uint4*>(Ks + j * LD + d) = ld_row8(kb + (long long)t * a.k_rs + d, in);
      if constexpr (OWN_V)
        *reinterpret_cast<uint4*>(Vs + j * LD + d) = ld_row8(vb + (long long)t * a.v_rs + d, in);
      else
        *reinterpret_cast<uint4*>(Vs + j * LD + d) = ld_row8(vb + (long long)t * a.k_rs + d, in);
    }
    if (tid < BKV) {
      const int t = kv0 + tid;
      if constexpr (LM)
        segk[tid] = (a.seg_kv != nullptr && t < a.Lk) ? a.seg_kv[(long long)b * a.Lk + t] : 0;
      else
        segk[tid] = (a.seg != nullptr && t < a.Lk) ? a.seg[(long long)b * a.Lk + t] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's BKV keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* p = Ks + (nt * 8 + (lane >> 2)) * LD + cq;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_16816(s[nt], qf[ks], ld32(p + ks * 16), ld32(p + ks * 16 + 8));
    }

    // scale, mask, online softmax; element i of s[nt] is row qpos[i / 2], key cq + (i & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = nt * 8 + cq + (i & 1), kp = kv0 + j, row = i >> 1;
        bool ok = kp < a.Lk;
        if (CAUSAL) ok = ok && kp <= qpos[row];
        if (a.seg != nullptr) ok = ok && segk[j] == segq[row];
        s[nt][i] = ok ? s[nt][i] * a.scale : -INFINITY;
        mx[row] = fmaxf(mx[row], s[nt][i]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m[row], mx[row]);
      // a row with no visible key yet keeps m = -inf and takes p = 0
      alpha[row] = m_new == -INFINITY ? 1.f : expf(m[row] - m_new);
      mx[row] = m_new;
      m[row] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i >> 1;
        s[nt][i] = mx[row] == -INFINITY ? 0.f : expf(s[nt][i] - mx[row]);
        sum[row] += s[nt][i];
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 1);
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 2);
      l[row] = l[row] * alpha[row] + sum[row];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A operand's layout
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // lanes 0-15 address the k-step's 16 key rows (the upper 16 repeat them)
      const __nv_bfloat16* row = Vs + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, row + n * 8);
        mma_16816(o[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qpos[row] >= a.Lq) continue;
    const float inv = l[row] > 0.f ? 1.f / l[row] : 0.f;
    // the backward recomputes P = exp(s * scale - lse); a row that saw no
    // key gets +inf, so its P is 0
    if constexpr (LM) {
      if ((lane & 3) == 0) {
        const long long i = ((long long)b * a.Hq + h) * a.Lq + qpos[row];
        a.l[i] = l[row];
        a.m[i] = m[row];
      }
    } else if (a.lse != nullptr && (lane & 3) == 0) {
      a.lse[((long long)b * a.Hq + h) * a.Lq + qpos[row]] =
          l[row] > 0.f ? m[row] + logf(l[row]) : INFINITY;
    }
    __nv_bfloat16* ob = a.o + b * a.o_bs + (long long)qpos[row] * a.o_rs + (long long)h * a.o_hs;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      ob[n * 8 + cq] = to_bf(o[n][2 * row] * inv);
      ob[n * 8 + cq + 1] = to_bf(o[n][2 * row + 1] * inv);
    }
  }
}

template <int HD, bool CAUSAL, bool OWN_V = false, bool LM = false, int BQ = kAttnBQ,
          int BKV = kAttnBKV>
int launch_attn(const AttnArgsOf<OWN_V, LM>& a, int B, cudaStream_t stream) {
  using S = AttnShape<HD, BQ, BKV>;
  auto kernel = attn_fwd_kernel<HD, CAUSAL, OWN_V, LM, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.Hq, B);
  kernel<<<grid, S::threads, S::smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tv
