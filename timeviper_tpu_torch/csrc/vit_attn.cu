// Whole-clip non-causal attention for the InternVideo2 tower (K6).
//
// Replaces the TPU kernel timeviper_tpu/ops/vit_attention.py:vit_attention
// (_vit_attn_kernel), reached from models/internvideo2.py through
// encoder_attention for every one of the tower's 39 blocks: 1025 tokens a
// clip (4 frames x 16 x 16 patches + CLS), 16 heads of 88. The TPU kernel
// took q, k and v padded to T 1152 and hd 128 in a (B, H, T, hd) relayout,
// pre-scaled q in bf16, used a clamped one-pass exp(min(s, 75)) with no row
// max and took the row sum from a ones column folded into P V. This one reads
// the caller's (B, T, H, hd) tensors in place through their strides: q and k
// come out of the full-width q/k RMSNorm as their own (B, T, H*hd) tensors,
// v is a column slice of the fused qkv projection (row stride 3*H*hd), so
// nothing is padded or copied. It scales the f32 logits, subtracts the
// running row max (attn_tile.cuh) and sums the f32 probabilities, which
// equals the TPU kernel's result wherever the logits stay below 75.
//
// What bounds it on the H100: the 4 * T^2 * hd products per (clip, head),
// 5.9 GFLOP per clip over 16 heads at T = 1025, run on the bf16 tensor
// cores through mma.sync. hd = 88 is no multiple of the MMA depth 16, so Q
// and K are zero-padded to 96 columns in shared memory for Q K^T; P V needs
// no padding (88 = 11 output tiles of 8). One block per 64 query rows of one
// (clip, head): 17 x 16 x B blocks, 272 per clip, which fills 132 SMs at any
// clip count.
#include "attn_tile.cuh"

extern "C" int tv_vit_attn(const void* q, const void* k, const void* v, void* o, int B, int T,
                           int H, int hd, long long q_bs, int q_rs, long long k_bs, int k_rs,
                           long long v_bs, int v_rs, float scale, void* stream) {
  tv::AttnArgsV a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.seg = nullptr;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.q_hs = hd;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.k_hs = hd;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.v_hs = hd;
  a.o_bs = (long long)T * H * hd;  // the output is a fresh contiguous (B, T, H, hd)
  a.o_rs = H * hd;
  a.o_hs = hd;
  a.Lq = T; a.Lk = T; a.Hq = H; a.Hkv = H;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 88: return tv::launch_attn<88, false, true>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
