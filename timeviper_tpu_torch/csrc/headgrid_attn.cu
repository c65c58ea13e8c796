// Head-grid ViT attention at head dim 128 (K10a), the kernel of the ViT
// attention microbenchmark (bench/microbench_vit_attn.py).
//
// Replaces the TPU kernel scripts/microbench_vit_attn.py:_headgrid_kernel
// (headgrid_attention, a pallas_call over the grid (frames, H / hpp)). It
// probes SigLIP's attention with each head's 72 columns zero-padded to 128:
// the input is the fused (B, T, 3 * H * 128) qkv buffer, column order
// (3, H, 128), the output (B, T, H * 128). Per head, as the TPU kernel:
//
//   q' = bf16(q * bf16(scale))            scale = 1 / sqrt(72), the true hd
//   s  = q' k^T                           f32
//   p  = bf16(exp(min(s, 75)))            no row max subtracted
//   l  = sum_j f32(p)                     (a ones matmul on the TPU)
//   o  = bf16((p v) / max(l, 1e-30))
//
// and with DO_EXP false p = bf16(0.01 * s), l = 1: the two products alone.
// The TPU kernel's column mask keeps the keys below t_valid, all T of them at
// its one caller; here the same bound masks the zero-padded keys of the last
// tile. It is a field of its own, set to T by the entry point: compared with
// the loop bound a.T itself, nvcc (CUDA 12.8) emits code that takes 9.9
// instead of 7.5 ms at 2 and 4 heads a block on 256 frames (PERF.md).
// Without a row max, l and o accumulate over the key tiles with no
// rescaling, exactly the sums the TPU kernel takes over the whole frame.
//
// The TPU kernel holds a frame's 729 keys for hpp heads in VMEM. Here one
// block of 4 warps owns 64 query rows of one (frame, group of HPP heads)
// and runs the group's heads one after the other; keys stream through
// shared memory in tiles of 64, and both products run on mma.sync m16n8k16
// (bf16 in, f32 accumulate) with the fragment helpers of common.cuh, as in
// attn_tile.cuh. HPP and DO_EXP are template parameters. The kernel has its
// own argument struct: growing attn_tile.cuh's AttnArgs slowed K2 and K3.
//
// What bounds it on the H100: the padded products, 4 * T^2 * 128 per (frame,
// head), 1.1 TFLOP at 256 frames of 729 tokens and 16 heads, on the bf16
// tensor cores (1.1 ms at 989 TFLOP/s); the 0.6 GB of qkv and output take
// 0.18 ms at 3.35 TB/s. Each key tile is loaded, then consumed, with no
// cp.async / TMA pipeline, and the exp runs per element.
#include "common.cuh"

namespace {

constexpr int kHD = 128;           // the padded head dim
constexpr int kBQ = 64;            // query rows a block
constexpr int kBKV = 64;           // keys a tile
constexpr int kThreads = 128;      // a warp per 16 query rows
constexpr int kLD = kHD + 8;       // smem row stride: rows step 4 banks apart
constexpr int kVPR = kHD / 8;      // 16-byte vectors a row
constexpr size_t kSmem = sizeof(__nv_bfloat16) * (kBQ + 2 * kBKV) * kLD;

struct HeadgridArgs {
  const __nv_bfloat16* qkv;  // (B, T, 3 * H * 128)
  __nv_bfloat16* o;          // (B, T, H * 128)
  int T, H, t_valid;  // t_valid: the keys the mask keeps (T)
  float scale;
};

__device__ __forceinline__ float round_bf(float x) { return tv::bf(tv::to_bf(x)); }

// grid (ceil(T / 64), H / HPP, B), 128 threads, kSmem of dynamic smem.
template <int HPP, bool DO_EXP>
__global__ void __launch_bounds__(kThreads) headgrid_attn_kernel(HeadgridArgs a) {
  constexpr int KS = kHD / 16, NO = kHD / 8, NT = kBKV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + kBQ * kLD;                               // [BKV][LD]
  __nv_bfloat16* Vs = Ks + kBKV * kLD;                              // [BKV][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ, b = blockIdx.z;
  const int C = a.H * kHD;
  const long long rs = 3LL * C;  // row stride of qkv
  const __nv_bfloat16* frame = a.qkv + (long long)b * a.T * rs;
  const float scale = round_bf(a.scale);
  const int kv_valid = min(a.t_valid, a.T);
  // this lane's rows of the tile: r0 and r0 + 8; its column pair: cq, cq + 1
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;

  for (int hh = 0; hh < HPP; ++hh) {
    const int h = blockIdx.y * HPP + hh;
    const __nv_bfloat16* qb = frame + h * kHD;
    const __nv_bfloat16* kb = qb + C;
    const __nv_bfloat16* vb = qb + 2 * C;

    __syncthreads();  // the previous head's tiles are no longer read
    for (int e = tid; e < kBQ * kVPR; e += kThreads) {
      const int r = e / kVPR, d = (e % kVPR) * 8, t = q0 + r;
      uint4 raw = tv::ld_row8(qb + t * rs + d, t < a.T);
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = tv::to_bf(tv::bf(x[i]) * scale);
      *reinterpret_cast<uint4*>(Qs + r * kLD + d) = raw;
    }
    __syncthreads();
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* p = Qs + r0 * kLD + ks * 16 + cq;
      qf[ks][0] = tv::ld32(p);
      qf[ks][1] = tv::ld32(p + 8 * kLD);
      qf[ks][2] = tv::ld32(p + 8);
      qf[ks][3] = tv::ld32(p + 8 * kLD + 8);
    }

    float l[2] = {0.f, 0.f};
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int kv0 = 0; kv0 < a.T; kv0 += kBKV) {
      __syncthreads();  // the previous tile's Ks and Vs are no longer read
      for (int e = tid; e < kBKV * kVPR; e += kThreads) {
        const int j = e / kVPR, d = (e % kVPR) * 8, t = kv0 + j;
        *reinterpret_cast<uint4*>(Ks + j * kLD + d) = tv::ld_row8(kb + t * rs + d, t < a.T);
        *reinterpret_cast<uint4*>(Vs + j * kLD + d) = tv::ld_row8(vb + t * rs + d, t < a.T);
      }
      __syncthreads();

      // S = Q' K^T for this warp's 16 rows and the tile's 64 keys
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* p = Ks + (nt * 8 + (lane >> 2)) * kLD + cq;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          tv::mma_16816(s[nt], qf[ks], tv::ld32(p + ks * 16), tv::ld32(p + ks * 16 + 8));
      }

      // P in bf16, as the TPU kernel casts it; element i of s[nt] is row
      // r0 + 8 * (i / 2), key kv0 + nt * 8 + cq + (i & 1). Keys past T are
      // zero rows of K and V: with DO_EXP their exp(0) is masked, without
      // it their p is 0 and their v is 0
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (DO_EXP) {
            const int j = kv0 + nt * 8 + cq + (i & 1);
            s[nt][i] = j < kv_valid ? round_bf(expf(fminf(s[nt][i], 75.f))) : 0.f;
            l[i >> 1] += s[nt][i];
          } else {
            s[nt][i] = round_bf(s[nt][i] * 0.01f);
          }
        }
      }

      // O += P V: P's accumulator layout is the A operand's layout
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        const uint32_t pa[4] = {tv::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                tv::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                tv::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                tv::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // lanes 0-15 address the k-step's 16 key rows (the upper 16 repeat them)
        const __nv_bfloat16* row = Vs + (kk * 16 + (lane & 15)) * kLD;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          tv::ldsm_x2_trans(b0, b1, row + n * 8);
          tv::mma_16816(o[n], pa, b0, b1);
        }
      }
    }

#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int t = q0 + r0 + 8 * row;
      float inv = 1.f;
      if constexpr (DO_EXP) {
        // the row sum over the four lanes that hold the row's columns
        float sum = l[row];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv = 1.f / fmaxf(sum, 1e-30f);
      }
      if (t >= a.T) continue;
      __nv_bfloat16* ob = a.o + ((long long)b * a.T + t) * C + h * kHD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        ob[n * 8 + cq] = tv::to_bf(o[n][2 * row] * inv);
        ob[n * 8 + cq + 1] = tv::to_bf(o[n][2 * row + 1] * inv);
      }
    }
  }
}

template <int HPP, bool DO_EXP>
int launch(const HeadgridArgs& a, int B, cudaStream_t stream) {
  auto kernel = headgrid_attn_kernel<HPP, DO_EXP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBQ - 1) / kBQ, a.H / HPP, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tv_headgrid_attn(const void* qkv, void* out, int B, int T, int H, int hpp,
                                int do_exp, float scale, void* stream) {
  const int t_valid = T;  // see the note at the top
  if (H % hpp != 0) return cudaErrorInvalidValue;
  HeadgridArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.T = T;
  a.H = H;
  a.t_valid = t_valid;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hpp * 2 + (do_exp ? 1 : 0)) {
    case 3: return launch<1, true>(a, B, s);
    case 2: return launch<1, false>(a, B, s);
    case 5: return launch<2, true>(a, B, s);
    case 4: return launch<2, false>(a, B, s);
    case 9: return launch<4, true>(a, B, s);
    case 8: return launch<4, false>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
