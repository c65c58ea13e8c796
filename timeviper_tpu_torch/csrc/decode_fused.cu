// K7: one Mamba-2 decode step (x conv roll + bias + SiLU, state update, y,
// gated RMSNorm) for Hopper (sm_90a).
//
// Replaces the TPU kernel timeviper_tpu/ops/decode_fused.py:_kernel (driven
// by fused_mamba_decode, reached from models/nano.py:mamba_mixer_decode under
// TIMEVIPER_FUSED_DECODE=1). What bounds it on the H100 is bytes: the f32
// state (B, H, P, N) is read and written once, 8.4 MB for the 9B at batch 1
// (about 2.5 us at 3.35 TB/s), against ~4 flops per state element. At batch
// 1 that is one DRAM round trip's worth of bytes spread over the card, so
// what the design fights is latency:
//
// - A block owns CH = 128 channels (state rows of N) of one group and one
//   batch row: 64 blocks for the 9B at batch 1. Each thread issues all of
//   its first 128 state columns as 16-byte streaming loads before anything
//   else (a warp's load is a channel's 512 contiguous bytes), so the
//   block's 64 KB, and the whole state across the card, are in flight at
//   once; the conv taps, B, C, dt and the gate load beside them, and the
//   conv runs while they fly. A later 128-column pass (N > 128) loads at
//   its turn. The loads first are what took batch 1 from 0.021 to ~0.009
//   ms; 64 channels a block (clusters of 16, twice the SMs) ran no faster
//   there and slower at batch 8, so it is not kept.
// - The gated RMSNorm needs the mean square over the group's CpG channels,
//   which span CpG / CH blocks (8 for the 9B's 1,024-channel groups): those
//   blocks form one thread-block cluster. Each block pushes its partial sum
//   into every block's shared memory (distributed shared memory), and one
//   cluster barrier later each sums the partials in rank order: a fixed
//   order, no atomics, no second pass. A relaxed arrive at the start,
//   waited on just before the pushes, shows every block of the cluster
//   running without a barrier on the critical path.
// - A channel's y is the warp's sum over its lanes' columns (shuffles);
//   lane i of a warp then owns the warp's channel i for the conv, the gate,
//   the norm and the output.
// As in the TPU kernel, xs and y stay f32 into the norm.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxN = 512;
constexpr int kMaxK = 8;
constexpr int kCH = 128;                   // channels a block
constexpr int kMaxCluster = 8;             // a portable cluster

struct DecodeArgs {
  const __nv_bfloat16* xr;    // (B, d_inner), row stride sxr
  const __nv_bfloat16* Bv;    // (B, G*N) post-conv
  const __nv_bfloat16* Cv;    // (B, G*N) post-conv
  const float* dtf;           // (B, H) processed dt
  const __nv_bfloat16* gate;  // (B, d_inner), row stride sgate
  const __nv_bfloat16* csx;   // (B, d_inner, K) conv state, oldest tap first
  const float* ssm;           // (B, H, P, N) = (B, d_inner, N)
  const float* wx;            // (d_inner, K)
  const float* bx;            // (d_inner,)
  const float* A_log;         // (H,)
  const float* D;             // (H,)
  const float* nw;            // (d_inner,)
  __nv_bfloat16* y;           // (B, d_inner)
  __nv_bfloat16* new_csx;     // (B, d_inner, K)
  float* new_ssm;             // (B, d_inner, N)
  int H, P, G, N, K, CpG, d_inner;
  long long sxr, sgate;
  float eps;
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four bf16 at p (8-byte aligned) as floats.
__device__ __forceinline__ float4 ld_bf4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// grid (G * CpG / kCH, B), cluster (CpG / kCH, 1, 1). Warp w owns channels
// c0 + CPW w .. + CPW - 1; lane l the state columns 4 l .. 4 l + 3 of each
// 128-column pass.
__global__ void __launch_bounds__(kThreads, 2)
    decode_fused_kernel(const __grid_constant__ DecodeArgs a) {
  constexpr int CPW = kCH / (kThreads / 32);  // channels a warp
  __shared__ float parts[kMaxCluster];       // the cluster's block partials, by rank
  __shared__ float warp_sq[kThreads / 32];
  cluster_arrive_relaxed();  // this block runs: its shared memory may be written
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = a.CpG / kCH, rank = blockIdx.x % nblk;
  const int g = blockIdx.x / nblk, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kCH + warp * CPW;  // the warp's first channel

  // the first 128 state columns of the warp's channels, all in flight
  const float* src = a.ssm + ((size_t)b * a.d_inner + cw) * a.N + lane * 4;
  float4 sv[CPW];
#pragma unroll
  for (int i = 0; i < CPW; ++i) sv[i] = __ldcs(reinterpret_cast<const float4*>(src + i * a.N));
  const __nv_bfloat16* bg = a.Bv + ((size_t)b * a.G + g) * a.N + lane * 4;
  const __nv_bfloat16* cgp = a.Cv + ((size_t)b * a.G + g) * a.N + lane * 4;
  float4 Bq = ld_bf4(bg), Cq = ld_bf4(cgp);

  // lane i < CPW: channel cw + i's conv (roll in xr, taps, bias, SiLU), its
  // head's decay and dt xs
  const int c = cw + (lane < CPW ? lane : 0), h = c / a.P;
  float xs = 0.f, dA = 0.f, dtx = 0.f, z = 0.f;
  if (lane < CPW) {
    const __nv_bfloat16* cs = a.csx + ((size_t)b * a.d_inner + c) * a.K;
    __nv_bfloat16* ncs = a.new_csx + ((size_t)b * a.d_inner + c) * a.K;
    const float* w = a.wx + (size_t)c * a.K;
    const __nv_bfloat16 xin = a.xr[(size_t)b * a.sxr + c];
    const float dt = a.dtf[(size_t)b * a.H + h];
    z = tv::bf(a.gate[(size_t)b * a.sgate + c]);
    float acc = 0.f;
    for (int k = 0; k < a.K; ++k) {
      const __nv_bfloat16 v = k + 1 < a.K ? cs[k + 1] : xin;
      ncs[k] = v;
      acc += tv::bf(v) * w[k];
    }
    acc += a.bx[c];
    xs = acc * sigmoid(acc);
    dA = expf(dt * -expf(a.A_log[h]));
    dtx = dt * xs;
  }
  float yp[CPW];
#pragma unroll
  for (int i = 0; i < CPW; ++i) yp[i] = 0.f;

  float* dst = a.new_ssm + ((size_t)b * a.d_inner + cw) * a.N + lane * 4;
  for (int n0 = 0; n0 < a.N; n0 += 128) {
    if (n0 > 0) {  // the next pass's columns (N > 128)
#pragma unroll
      for (int i = 0; i < CPW; ++i)
        sv[i] = __ldcs(reinterpret_cast<const float4*>(src + i * a.N + n0));
      Bq = ld_bf4(bg + n0);
      Cq = ld_bf4(cgp + n0);
    }
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const float dAi = __shfl_sync(0xffffffffu, dA, i), dtxi = __shfl_sync(0xffffffffu, dtx, i);
      float4 o;
      o.x = sv[i].x * dAi + dtxi * Bq.x;
      o.y = sv[i].y * dAi + dtxi * Bq.y;
      o.z = sv[i].z * dAi + dtxi * Bq.z;
      o.w = sv[i].w * dAi + dtxi * Bq.w;
      __stcs(reinterpret_cast<float4*>(dst + i * a.N + n0), o);
      yp[i] += o.x * Cq.x + o.y * Cq.y + o.z * Cq.z + o.w * Cq.w;
    }
  }
  // y of channel i: the warp's sum; lane i keeps it
  float yv = 0.f;
#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    float v = yp[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == i) yv = v;
  }
  float v = 0.f, sq = 0.f;
  if (lane < CPW) {
    v = (yv + a.D[h] * xs) * (z * sigmoid(z));
    sq = v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) warp_sq[warp] = sq;
  __syncthreads();
  cluster_wait();  // every block of the cluster runs
  if (threadIdx.x < nblk) {  // the block's partial into block threadIdx.x's parts[rank]
    float p = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) p += warp_sq[w];
    *cluster.map_shared_rank(&parts[rank], (unsigned)threadIdx.x) = p;
  }
  cluster_arrive();
  cluster_wait();  // every block's partial is here; no block reads another's memory after this
  float total = 0.f;
  for (int r = 0; r < nblk; ++r) total += parts[r];
  const float rstd = 1.f / sqrtf(total / a.CpG + a.eps);
  if (lane < CPW) a.y[(size_t)b * a.d_inner + c] = tv::to_bf(v * rstd * a.nw[c]);
}

}  // namespace

extern "C" int tv_decode_fused(const void* xr, const void* Bv, const void* Cv, const void* dtf,
                               const void* gate, const void* csx, const void* ssm,
                               const void* wx, const void* bx, const void* A_log,
                               const void* D, const void* nw, void* y, void* new_csx,
                               void* new_ssm, int B, int H, int P, int G, int N, int K,
                               long long sxr, long long sgate, float eps, void* stream) {
  const int d_inner = H * P, CpG = d_inner / G;
  if (H % G != 0 || CpG % kCH != 0 || CpG / kCH > kMaxCluster || N % 128 != 0 || N > kMaxN ||
      K < 1 || K > kMaxK || B < 1)
    return cudaErrorInvalidValue;
  DecodeArgs a;
  a.xr = static_cast<const __nv_bfloat16*>(xr);
  a.Bv = static_cast<const __nv_bfloat16*>(Bv);
  a.Cv = static_cast<const __nv_bfloat16*>(Cv);
  a.dtf = static_cast<const float*>(dtf);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.csx = static_cast<const __nv_bfloat16*>(csx);
  a.ssm = static_cast<const float*>(ssm);
  a.wx = static_cast<const float*>(wx);
  a.bx = static_cast<const float*>(bx);
  a.A_log = static_cast<const float*>(A_log);
  a.D = static_cast<const float*>(D);
  a.nw = static_cast<const float*>(nw);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.new_csx = static_cast<__nv_bfloat16*>(new_csx);
  a.new_ssm = static_cast<float*>(new_ssm);
  a.H = H; a.P = P; a.G = G; a.N = N; a.K = K; a.CpG = CpG; a.d_inner = d_inner;
  a.sxr = sxr; a.sgate = sgate; a.eps = eps;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * (CpG / kCH), B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CpG / kCH;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_fused_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
