// Causal flash-attention backward with GQA and packed segment ids, for Hopper.
//
// Replaces the backward of the TPU kernel that timeviper_tpu/ops/flash_pallas.py
// wraps: JAX's bundled Pallas TPU flash attention, whose VJP runs
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq (two pallas_calls).
// Here, FlashAttention-2 style and deterministic, in three launches:
//   1. delta:  D_i = rowsum(dO_i * O_i) in f32, one warp per (b, t, h) row;
//   2. dkv:    one block per (batch, KV head, 64-key tile). It walks the
//              Hq/Hkv query heads of the GQA group and the query tiles at or
//              below the diagonal, recomputes P = exp(S * scale - LSE) under
//              the causal and segment mask from the forward's row LSE, and
//              accumulates dV += P^T dO and dK += (P * (dO V^T - D))^T Q, so
//              the group's heads are summed in the block with no atomics;
//   3. dq:     one block per (batch, query head, 64-query tile), walking the
//              key tiles up to the diagonal: dQ += (P * (dO V^T - D)) K.
// dK and dQ take the softmax scale at the end. All products run as
// mma.sync m16n8k16 with bf16 operands (P and dS rounded to bf16, as the
// forward rounds P) and f32 sums; the operand tiles stay in shared memory and
// their fragments are read from there, leaving the registers to the f32
// accumulators. Every sum has a fixed order: the gradients are bitwise
// repeatable.
//
// What bounds it on the H100: the causal L^2 * D products, five per tile
// against the forward's two (about 1.4 TFLOP per layer at L = 8192); like the
// forward it loads a tile and then consumes it, with no cp.async / TMA
// pipeline, and recomputes exp per element. Head dim 128; any length; a -1
// left pad is a segment like any other. Row strides are those of the
// contiguous (B, L, H, 128) tensors.
#include "common.cuh"

namespace {

using tv::bf;
using tv::to_bf;

constexpr int kD = 128;
constexpr int kBlk = 64;  // query and key tile
constexpr int kThreads = 128;
constexpr int kLD = kD + 8;
constexpr int kKS = kD / 16;  // k-steps over the head dim
constexpr int kNT = kBlk / 8;  // n-tiles over a tile's rows
constexpr int kNO = kD / 8;    // n-tiles over the head dim

struct BwdArgs {
  const __nv_bfloat16* q;   // (B, L, Hq, D)
  const __nv_bfloat16* k;   // (B, L, Hkv, D)
  const __nv_bfloat16* v;   // (B, L, Hkv, D)
  const __nv_bfloat16* o;   // (B, L, Hq, D)
  const __nv_bfloat16* dO;  // (B, L, Hq, D)
  const float* lse;         // (B, Hq, L)
  const int* seg;           // (B, L) or null
  float* delta;             // (B, Hq, L)
  __nv_bfloat16* dq;        // (B, L, Hq, D)
  __nv_bfloat16* dk;        // (B, L, Hkv, D)
  __nv_bfloat16* dv;        // (B, L, Hkv, D)
  int B, L, Hq, Hkv;
  float scale;
};

// Pass 1. grid (ceil(B*L*Hq / 4)), 128 threads: warp w takes row 4 * block + w
// in q's memory order (b, t, h).
__global__ void __launch_bounds__(kThreads) delta_kernel(BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * 4 + warp;
  if (r >= (long long)a.B * a.L * a.Hq) return;
  const __nv_bfloat16* o = a.o + r * kD + lane * 4;
  const __nv_bfloat16* g = a.dO + r * kD + lane * 4;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s += bf(o[i]) * bf(g[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const long long h = r % a.Hq, t = (r / a.Hq) % a.L, b = r / ((long long)a.Hq * a.L);
    a.delta[(b * a.Hq + h) * a.L + t] = s;
  }
}

// 64 rows of head h of a (B, L, H, D) tensor into a [64][kLD] tile, zero past L.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* base, int L, int H, int b, int h,
                                          int t0, __nv_bfloat16* dst) {
  for (int e = threadIdx.x; e < kBlk * kD / 8; e += kThreads) {
    const int r = e / (kD / 8), d = (e % (kD / 8)) * 8, t = t0 + r;
    *reinterpret_cast<uint4*>(dst + r * kLD + d) =
        tv::ld_row8(base + (((long long)b * L + t) * H + h) * kD + d, t < L);
  }
}

__device__ __forceinline__ void afrag(uint32_t (&af)[4], const __nv_bfloat16* t, int r,
                                      int col) {
  const __nv_bfloat16* p = t + r * kLD + col;
  af[0] = tv::ld32(p);
  af[1] = tv::ld32(p + 8 * kLD);
  af[2] = tv::ld32(p + 8);
  af[3] = tv::ld32(p + 8 * kLD + 8);
}

// acc[16 x 64] = A rows [r][d] . B rows [n][d]^T over the head dim, both tiles
// [64][kLD] in shared memory; this warp's rows start at r.
__device__ __forceinline__ void tile_dot(float (&acc)[kNT][4], const __nv_bfloat16* A,
                                         const __nv_bfloat16* Bt, int r, int lane) {
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    uint32_t af[4];
    afrag(af, A, r, ks * 16 + cq);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* p = Bt + (nt * 8 + (lane >> 2)) * kLD + ks * 16 + cq;
      tv::mma_16816(acc[nt], af, tv::ld32(p), tv::ld32(p + 8));
    }
  }
}

// out[16 x D] += S[16 x 64] (rounded to bf16) . V[64][D] with V read
// transposed from shared memory.
__device__ __forceinline__ void tile_pv(float (&out)[kNO][4], const float (&s)[kNT][4],
                                        const __nv_bfloat16* V, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlk / 16; ++kk) {
    const uint32_t pa[4] = {tv::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            tv::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            tv::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            tv::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const __nv_bfloat16* row = V + (kk * 16 + (lane & 15)) * kLD;
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      uint32_t b0, b1;
      tv::ldsm_x2_trans(b0, b1, row + n * 8);
      tv::mma_16816(out[n], pa, b0, b1);
    }
  }
}

constexpr size_t kSmem = sizeof(__nv_bfloat16) * 4 * kBlk * kLD + sizeof(float) * 2 * kBlk +
                         sizeof(int) * kBlk;

// Pass 2. grid (ceil(L / 64), Hkv, B), 128 threads, kSmem of dynamic smem.
// Warp w owns keys k0 + 16w .. k0 + 16w + 15; the tiles are transposed
// (rows = keys, columns = queries).
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBlk * kLD;
  __nv_bfloat16* Qs = Vs + kBlk * kLD;
  __nv_bfloat16* Gs = Qs + kBlk * kLD;  // dO
  float* lse_s = reinterpret_cast<float*>(Gs + kBlk * kLD);
  float* delta_s = lse_s + kBlk;
  int* segq = reinterpret_cast<int*>(delta_s + kBlk);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBlk, hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.Hq / a.Hkv;
  const int rl = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int kpos[2] = {k0 + rl, k0 + rl + 8};
  int segk[2] = {0, 0};
  if (a.seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kpos[i] < a.L) segk[i] = a.seg[(long long)b * a.L + kpos[i]];
  }
  load_rows(a.k, a.L, a.Hkv, b, hk, k0, Ks);
  load_rows(a.v, a.L, a.Hkv, b, hk, k0, Vs);

  float dk[kNO][4] = {}, dv[kNO][4] = {};
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const float* lse = a.lse + ((long long)b * a.Hq + h) * a.L;
    const float* delta = a.delta + ((long long)b * a.Hq + h) * a.L;
    for (int q0 = k0; q0 < a.L; q0 += kBlk) {
      __syncthreads();  // the previous query tile is no longer read
      load_rows(a.q, a.L, a.Hq, b, h, q0, Qs);
      load_rows(a.dO, a.L, a.Hq, b, h, q0, Gs);
      if (tid < kBlk) {
        const int t = q0 + tid;
        lse_s[tid] = t < a.L ? lse[t] : INFINITY;
        delta_s[tid] = t < a.L ? delta[t] : 0.f;
        segq[tid] = (a.seg != nullptr && t < a.L) ? a.seg[(long long)b * a.L + t] : 0;
      }
      __syncthreads();

      // P^T = exp(K Q^T * scale - lse), masked
      float p[kNT][4];
      tile_dot(p, Ks, Qs, rl, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int half = q >> 1, il = nt * 8 + cq + (q & 1), qp = q0 + il;
          bool ok = qp < a.L && kpos[half] < a.L && kpos[half] <= qp;
          if (a.seg != nullptr) ok = ok && segk[half] == segq[il];
          p[nt][q] = ok ? expf(p[nt][q] * a.scale - lse_s[il]) : 0.f;
        }
      tile_pv(dv, p, Gs, lane);  // dV += P^T dO

      // dS^T = P^T * (V dO^T - delta)
      float ds[kNT][4];
      tile_dot(ds, Vs, Gs, rl, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = nt * 8 + cq + (q & 1);
          ds[nt][q] = p[nt][q] * (ds[nt][q] - delta_s[il]);
        }
      tile_pv(dk, ds, Qs, lane);  // dK += dS^T Q
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (kpos[half] >= a.L) continue;
    const long long row = (((long long)b * a.L + kpos[half]) * a.Hkv + hk) * kD;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        a.dk[row + n * 8 + cq + u] = to_bf(dk[n][2 * half + u] * a.scale);
        a.dv[row + n * 8 + cq + u] = to_bf(dv[n][2 * half + u]);
      }
  }
}

// Pass 3. grid (ceil(L / 64), Hq, B), 128 threads, kSmem of dynamic smem.
// Warp w owns queries q0 + 16w .. q0 + 16w + 15.
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + kBlk * kLD;
  __nv_bfloat16* Ks = Gs + kBlk * kLD;
  __nv_bfloat16* Vs = Ks + kBlk * kLD;
  int* segk = reinterpret_cast<int*>(Vs + kBlk * kLD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlk, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int rl = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int qpos[2] = {q0 + rl, q0 + rl + 8};
  float lse[2], delta[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qpos[i] < a.L;
    lse[i] = in ? a.lse[((long long)b * a.Hq + h) * a.L + qpos[i]] : INFINITY;
    delta[i] = in ? a.delta[((long long)b * a.Hq + h) * a.L + qpos[i]] : 0.f;
    if (a.seg != nullptr && in) segq[i] = a.seg[(long long)b * a.L + qpos[i]];
  }
  load_rows(a.q, a.L, a.Hq, b, h, q0, Qs);
  load_rows(a.dO, a.L, a.Hq, b, h, q0, Gs);

  float dq[kNO][4] = {};
  const int kv_end = min(a.L, q0 + kBlk);
  for (int k0 = 0; k0 < kv_end; k0 += kBlk) {
    __syncthreads();
    load_rows(a.k, a.L, a.Hkv, b, hk, k0, Ks);
    load_rows(a.v, a.L, a.Hkv, b, hk, k0, Vs);
    if (tid < kBlk) {
      const int t = k0 + tid;
      segk[tid] = (a.seg != nullptr && t < a.L) ? a.seg[(long long)b * a.L + t] : 0;
    }
    __syncthreads();

    float p[kNT][4];
    tile_dot(p, Qs, Ks, rl, lane);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int half = q >> 1, jl = nt * 8 + cq + (q & 1), kp = k0 + jl;
        bool ok = kp < a.L && qpos[half] < a.L && kp <= qpos[half];
        if (a.seg != nullptr) ok = ok && segk[jl] == segq[half];
        p[nt][q] = ok ? expf(p[nt][q] * a.scale - lse[half]) : 0.f;
      }
    float ds[kNT][4];
    tile_dot(ds, Gs, Vs, rl, lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) ds[nt][q] = p[nt][q] * (ds[nt][q] - delta[q >> 1]);
    tile_pv(dq, ds, Ks, lane);  // dQ += dS K
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (qpos[half] >= a.L) continue;
    const long long row = (((long long)b * a.L + qpos[half]) * a.Hq + h) * kD;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) a.dq[row + n * 8 + cq + u] = to_bf(dq[n][2 * half + u] * a.scale);
  }
}

}  // namespace

extern "C" int tv_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dO, const void* lse, const void* seg, void* delta,
                            void* dq, void* dk, void* dv, int B, int L, int Hq, int Hkv, int D,
                            float scale, void* stream) {
  if (D != kD || Hq % Hkv != 0) return cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dO = static_cast<const __nv_bfloat16*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.seg = static_cast<const int*>(seg);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B; a.L = L; a.Hq = Hq; a.Hkv = Hkv;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmem)) != cudaSuccess)
    return err;
  const long long rows = (long long)B * L * Hq;
  delta_kernel<<<(unsigned)((rows + 3) / 4), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (L + kBlk - 1) / kBlk;
  dkv_kernel<<<dim3(tiles, Hkv, B), kThreads, kSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<<<dim3(tiles, Hq, B), kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}
