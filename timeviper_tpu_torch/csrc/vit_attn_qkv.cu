// Whole-frame ViT attention read straight from the fused qkv projection.
//
// Replaces the TPU kernel timeviper_tpu/ops/vit_attention.py:
// vit_attention_qkv (_vit_attn_qkv_kernel), reached from models/vit.py through
// encoder_attention_qkv. Like it, the kernel reads the q, k and v column bands
// of head h out of the (F, T, 3*H*hd) buffer (column order (3, H, hd)) and
// writes (F, T, H*hd) for the out-projection, so no relayout touches device
// memory. The TPU kernel used a clamped one-pass softmax without the row max;
// this one subtracts the running max (attn_tile.cuh), which gives the same
// result wherever logits stay below 75.
//
// What bounds it on the H100: the T^2 * hd products per (frame, head), about
// 0.15 GFLOP at SigLIP's T = 729, hd = 72, run on the bf16 tensor cores
// through mma.sync (attn_tile.cuh). hd = 72 is no multiple of the MMA depth
// 16, so Q and K are zero-padded to 80 columns in shared memory for Q K^T;
// P V needs no padding (72 = 9 output tiles of 8). One block per 64 query
// rows of one (frame, head) gives F * 16 * 12 blocks, enough to fill 132 SMs
// at any frame count above one.
#include "attn_tile.cuh"

extern "C" int tv_vit_attn_qkv(const void* qkv, void* out, int F, int T, int H, int hd,
                               float scale, void* stream) {
  const int C = H * hd;
  tv::AttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(qkv);
  a.k = a.q + C;
  a.v = a.q + 2 * C;
  a.o = static_cast<__nv_bfloat16*>(out);
  a.seg = nullptr;
  a.q_bs = (long long)T * 3 * C;
  a.q_rs = 3 * C;
  a.q_hs = hd;
  a.k_bs = a.q_bs;
  a.k_rs = a.q_rs;
  a.k_hs = hd;
  a.o_bs = (long long)T * C;
  a.o_rs = C;
  a.o_hs = hd;
  a.Lq = T; a.Lk = T; a.Hq = H; a.Hkv = H;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 72: return tv::launch_attn<72, false>(a, F, s);
    case 64: return tv::launch_attn<64, false>(a, F, s);
    default: return cudaErrorInvalidValue;
  }
}
