// K7: one Mamba-2 decode step (x conv roll + bias + SiLU, state update, y,
// gated RMSNorm) for Hopper (sm_90a).
//
// Replaces the TPU kernel timeviper_tpu/ops/decode_fused.py:_kernel (driven
// by fused_mamba_decode, reached from models/nano.py:mamba_mixer_decode under
// TIMEVIPER_FUSED_DECODE=1). What bounds it on the H100 is bytes: the f32
// state (B, H, P, N) is read and written once, 8.4 MB for the 9B at batch 1
// (about 2.5 us at 3.35 TB/s), against ~4 flops per state element.
//
// The TPU grid is (B, G): 8 programs at batch 1, each moving one group's
// 1024 x 128 f32 state. Here a block owns 128 channels (rows of P x N state
// rows) of one group and one batch row, so the 9B at batch 1 runs 64 blocks
// of 256 threads, each warp streaming 16 channels' state rows with 16-byte
// loads. The gated RMSNorm needs the mean square over the group's CpG
// channels, which span CpG / 128 blocks: those blocks form one thread-block
// cluster (CpG / 128 <= 8), each puts its partial sum in shared memory, and
// each reads the others' through distributed shared memory after a cluster
// barrier; no second pass and no atomics. As in the TPU kernel, xs and y stay
// f32 into the norm.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChan = 128;    // channels a block owns
constexpr int kThreads = 256;  // 8 warps, 16 channels each
constexpr int kMaxN = 512;
constexpr int kMaxK = 8;

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

// grid (G * CpG / 128, B), cluster (CpG / 128, 1, 1)
__global__ void __launch_bounds__(kThreads) decode_fused_kernel(DecodeArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  const int per_group = a.CpG / kChan;
  const int g = blockIdx.x / per_group;
  const int c0 = blockIdx.x * kChan;  // first channel of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ __align__(16) float Bs[kMaxN];
  __shared__ __align__(16) float Cs[kMaxN];
  __shared__ float xs_s[kChan], v_s[kChan], warp_part[kThreads / 32];
  __shared__ float part;

  for (int n = tid; n < a.N; n += kThreads) {
    Bs[n] = tv::bf(a.Bv[((size_t)b * a.G + g) * a.N + n]);
    Cs[n] = tv::bf(a.Cv[((size_t)b * a.G + g) * a.N + n]);
  }
  if (tid < kChan) {  // the x conv: roll in xr, taps, bias, SiLU
    const int c = c0 + tid;
    const __nv_bfloat16* cs = a.csx + ((size_t)b * a.d_inner + c) * a.K;
    __nv_bfloat16* ncs = a.new_csx + ((size_t)b * a.d_inner + c) * a.K;
    const float* w = a.wx + (size_t)c * a.K;
    const __nv_bfloat16 xin = a.xr[(size_t)b * a.sxr + c];
    float acc = 0.f;
    for (int k = 0; k < a.K; ++k) {
      const __nv_bfloat16 v = k + 1 < a.K ? cs[k + 1] : xin;
      ncs[k] = v;
      acc += tv::bf(v) * w[k];
    }
    acc += a.bx[c];
    xs_s[tid] = acc * sigmoid(acc);
  }
  __syncthreads();

  // the state rows: warp w streams channels 16w .. 16w + 15
  for (int i = 0; i < kChan / (kThreads / 32); ++i) {
    const int cl = warp * (kChan / (kThreads / 32)) + i;
    const int c = c0 + cl, h = c / a.P;
    const float dt = a.dtf[(size_t)b * a.H + h];
    const float dA = expf(dt * -expf(a.A_log[h]));
    const float xs = xs_s[cl];
    const float dtx = dt * xs;
    const float* s = a.ssm + ((size_t)b * a.d_inner + c) * a.N;
    float* ns = a.new_ssm + ((size_t)b * a.d_inner + c) * a.N;
    float yacc = 0.f;
    for (int n = lane * 4; n < a.N; n += 128) {
      const float4 sv = *reinterpret_cast<const float4*>(s + n);
      float4 o;
      o.x = sv.x * dA + dtx * Bs[n];
      o.y = sv.y * dA + dtx * Bs[n + 1];
      o.z = sv.z * dA + dtx * Bs[n + 2];
      o.w = sv.w * dA + dtx * Bs[n + 3];
      *reinterpret_cast<float4*>(ns + n) = o;
      yacc += o.x * Cs[n] + o.y * Cs[n + 1] + o.z * Cs[n + 2] + o.w * Cs[n + 3];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) yacc += __shfl_xor_sync(0xffffffffu, yacc, off);
    if (lane == 0) {
      const float yv = yacc + a.D[h] * xs;
      const float z = tv::bf(a.gate[(size_t)b * a.sgate + c]);
      v_s[cl] = yv * (z * sigmoid(z));
    }
  }
  __syncthreads();

  // the block's share of the group's sum of squares, then the cluster's
  float sq = tid < kChan ? v_s[tid] * v_s[tid] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) warp_part[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_part[w];
    part = t;
  }
  cluster.sync();  // every block's partial is written
  float total = 0.f;
  for (int r = 0; r < per_group; ++r) total += *cluster.map_shared_rank(&part, r);
  cluster.sync();  // no block leaves while another still reads its partial
  const float rstd = 1.f / sqrtf(total / a.CpG + a.eps);
  if (tid < kChan) {
    const int c = c0 + tid;
    a.y[(size_t)b * a.d_inner + c] = tv::to_bf(v_s[tid] * rstd * a.nw[c]);
  }
}

}  // namespace

extern "C" int tv_decode_fused(const void* xr, const void* Bv, const void* Cv, const void* dtf,
                               const void* gate, const void* csx, const void* ssm,
                               const void* wx, const void* bx, const void* A_log,
                               const void* D, const void* nw, void* y, void* new_csx,
                               void* new_ssm, int B, int H, int P, int G, int N, int K,
                               long long sxr, long long sgate, float eps, void* stream) {
  const int d_inner = H * P, CpG = d_inner / G;
  if (H % G != 0 || CpG % kChan != 0 || CpG / kChan > 8 || N % 128 != 0 || N > kMaxN ||
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
  cfg.gridDim = dim3(G * (CpG / kChan), B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CpG / kChan;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_fused_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
