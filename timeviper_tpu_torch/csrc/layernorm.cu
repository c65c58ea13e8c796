// K8: residual add + LayerNorm (+ int8 quantize) for Hopper (sm_90a).
//
// Replaces the TPU kernels timeviper_tpu/ops/layernorm.py:_ln_kernel and
// _ln_res_kernel (driven by fused_ln, reached from models/vit.py's fused-LN
// encoder loop). Per row of D (1152 in SigLIP-SO400M):
//   x_new = res + x (f32 sum; written in bf16 when there is a residual)
//   y     = (x_new - mean) / sqrt(var + eps) * w + b,
//           mean = E[x_new], var = E[x_new^2] - mean^2 (the TPU kernel's form)
//   y written in bf16, or as int8 clip(rint(y * act_inv), -127, 127)
//
// What bounds it on the H100 is bytes: about 4 flops per element against 2-6
// bytes. One warp owns a row and keeps it in registers (D / 32 f32 a lane,
// read as 8-byte vectors of 4 bf16), so each input is read once and each
// output written once, with the two sums reduced by shuffles and no shared
// memory. The TPU kernel's row blocks become 4 rows (4 warps) per block and
// thousands of blocks, which fills the card at 8 frames x 729 rows.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V = D / 128 vectors of 4 per lane
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    ln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
              const float* __restrict__ w, const float* __restrict__ b,
              const float* __restrict__ act_inv, __nv_bfloat16* __restrict__ x_new,
              void* __restrict__ y, int rows, float eps) {
  constexpr int D = V * 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float v[V][4];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (i * 32 + lane) * 4;
    const uint2 raw = *reinterpret_cast<const uint2*>(x + base + c);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 lo = __bfloat1622float2(xv[0]), hi = __bfloat1622float2(xv[1]);
    if (res != nullptr) {
      const uint2 rr = *reinterpret_cast<const uint2*>(res + base + c);
      const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&rr);
      const float2 rlo = __bfloat1622float2(rv[0]), rhi = __bfloat1622float2(rv[1]);
      lo = make_float2(rlo.x + lo.x, rlo.y + lo.y);
      hi = make_float2(rhi.x + hi.x, rhi.y + hi.y);
      *reinterpret_cast<uint2*>(x_new + base + c) =
          make_uint2(tv::pack_bf16(lo.x, lo.y), tv::pack_bf16(hi.x, hi.y));
    }
    v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = hi.x; v[i][3] = hi.y;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s += v[i][k];
      sq += v[i][k] * v[i][k];
    }
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float inv_d = 1.f / D;
  const float mean = s * inv_d;
  const float var = sq * inv_d - mean * mean;
  const float rstd = 1.f / sqrtf(var + eps);
  const float qs = act_inv != nullptr ? *act_inv : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (i * 32 + lane) * 4;
    const float4 wv = *reinterpret_cast<const float4*>(w + c);
    const float4 bv = *reinterpret_cast<const float4*>(b + c);
    const float o[4] = {(v[i][0] - mean) * rstd * wv.x + bv.x,
                        (v[i][1] - mean) * rstd * wv.y + bv.y,
                        (v[i][2] - mean) * rstd * wv.z + bv.z,
                        (v[i][3] - mean) * rstd * wv.w + bv.w};
    if (act_inv != nullptr) {
      char4 q;
      int qi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)  // round half to even, as jnp.round
        qi[k] = min(127, max(-127, __float2int_rn(o[k] * qs)));
      q.x = (signed char)qi[0]; q.y = (signed char)qi[1];
      q.z = (signed char)qi[2]; q.w = (signed char)qi[3];
      *reinterpret_cast<char4*>(static_cast<int8_t*>(y) + base + c) = q;
    } else {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + base + c) =
          make_uint2(tv::pack_bf16(o[0], o[1]), tv::pack_bf16(o[2], o[3]));
    }
  }
}

template <int V>
cudaError_t launch(const void* x, const void* res, const void* w, const void* b,
                   const void* act_inv, void* x_new, void* y, int rows, float eps,
                   cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_kernel<V><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(act_inv), static_cast<__nv_bfloat16*>(x_new), y, rows, eps);
  return cudaGetLastError();
}

}  // namespace

// x, res (optional): (rows, D) bf16; w, b: (D,) f32; act_inv (optional): f32
// scalar on the device; x_new: (rows, D) bf16 when res is given; y: (rows, D)
// bf16, or int8 when act_inv is given. D % 128 == 0, D <= 2048.
extern "C" int tv_layernorm(const void* x, const void* res, const void* w, const void* b,
                            const void* act_inv, void* x_new, void* y, int rows, int D,
                            float eps, void* stream) {
  if (D % 128 != 0 || D > 2048 || (res != nullptr) != (x_new != nullptr) || rows <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / 128) {
#define TV_LN_CASE(V) \
  case V:             \
    return launch<V>(x, res, w, b, act_inv, x_new, y, rows, eps, s);
    TV_LN_CASE(1) TV_LN_CASE(2) TV_LN_CASE(3) TV_LN_CASE(4) TV_LN_CASE(5) TV_LN_CASE(6)
    TV_LN_CASE(7) TV_LN_CASE(8) TV_LN_CASE(9) TV_LN_CASE(10) TV_LN_CASE(11) TV_LN_CASE(12)
    TV_LN_CASE(13) TV_LN_CASE(14) TV_LN_CASE(15) TV_LN_CASE(16)
#undef TV_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
