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
// running row max and sums the f32 probabilities, which equals the TPU
// kernel's result wherever the logits stay below 75.
//
// What bounds it on the H100: the 4 * T^2 * hd products per (clip, head),
// 5.9 GFLOP per clip over 16 heads at T = 1025, on the bf16 tensor cores.
// The kernel is attn_sm90.cuh's (wgmma fed by a TMA ring from a producer
// warp) at hd 88: TMA reads each row as three 32-column boxes (64-byte
// swizzle) of a map whose head dim is 88, so columns 88-95 arrive as zeros
// and Q K^T runs at depth 96 with no copy; P V runs at N = 88. Three
// consumer warpgroups take 192 query rows a block, so a clip's 1,025 rows
// fill 17 of 18 warpgroup tiles (6 blocks a (clip, head), 1,536 at 16
// clips) where 128-row blocks would leave a ninth block for one row. The
// keys come in tiles of 64 (three warpgroups get 160 registers a thread,
// too few for 128-key tiles with Q K^T and P V in flight at once); the
// 1,025th key runs as a 16-key tile (wgmma N 16), not a whole 64-key one.
#include "attn_sm90.cuh"

namespace {
constexpr int kBKV = 64;  // keys a tile
constexpr int kNWG = 3;   // consumer warpgroups, 64 query rows each
}

// The LSE variant (an `lse` pointer given) also writes each row's
// log-sum-exp, (B, H, T) f32, to AttnParams::l for the backward
// (csrc/vit_attn_bwd.cu), as K2 does.
//
// block_rows: the query rows a block that the caller counts blocks in; a
// launch for another tile is refused. lse: (B, H, T) f32, or null.
extern "C" int tv_vit_attn(const void* q, const void* k, const void* v, void* o, void* lse,
                           int B, int T,
                           int H, int hd, long long q_bs, int q_rs, long long k_bs, int k_rs,
                           long long v_bs, int v_rs, int block_rows, float scale, void* stream) {
  using namespace tv::sm90;
  if (block_rows != kNWG * 64 || hd != 88 || B < 1 || T < 1 || H < 1)
    return cudaErrorInvalidValue;
  AttnParams p{};
  if (!(encode_map(&p.tq, q, hd, H, T, B, hd, q_rs, q_bs, 32, 1, 64) &&
        encode_map(&p.tk, k, hd, H, T, B, hd, k_rs, k_bs, 32, 1, kBKV) &&
        encode_map(&p.tv, v, hd, H, T, B, hd, v_rs, v_bs, 32, 1, kBKV)))
    return cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);  // a fresh contiguous (B, T, H, hd)
  p.l = static_cast<float*>(lse);
  p.B = B; p.Lq = T; p.Lk = T; p.Hq = H; p.Hkv = H;
  p.pack = 1; p.n_split = 1; p.split_tiles = (T + kBKV - 1) / kBKV;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lse != nullptr ? launch<88, 32, kNWG, kBKV, false, true>(p, s)
                        : launch<88, 32, kNWG, kBKV, false>(p, s);
}
