// Whole-frame ViT attention read straight from the fused qkv projection (K3).
//
// Replaces the TPU kernel timeviper_tpu/ops/vit_attention.py:
// vit_attention_qkv (_vit_attn_qkv_kernel), reached from models/vit.py through
// encoder_attention_qkv in every SigLIP (hd 72, T 729) and DINOv2-L (hd 64,
// T 734) layer. Like it, the kernel reads the q, k and v column bands of head
// h out of the (F, T, 3*H*hd) buffer (column order (3, H, hd)) and writes
// (F, T, H*hd) for the out-projection, so no relayout touches device memory.
// The TPU kernel used a clamped one-pass softmax without the row max; this
// one subtracts the running max, which gives the same result wherever the
// logits stay below 75.
//
// What bounds it on the H100: the 4 * T^2 * hd products per (frame, head),
// 0.15 GFLOP at SigLIP's T = 729, hd = 72, on the bf16 tensor cores. The
// kernel is attn_sm90.cuh's (wgmma fed by a TMA ring from a producer warp).
// Three 4-D maps (head dim, heads, rows, frame) over the one buffer, based at
// columns 0, C and 2C (C = H*hd) with row stride 3C and head stride hd, read
// q, k and v in place. hd 72 comes as three 32-column boxes (64-byte
// swizzle; head stride 144 B and bases 2,304 B apart, multiples of 16 as TMA
// needs) whose columns 72-95 TMA zero-fills, so Q K^T runs at depth 80 with
// no copy and P V at N 72; hd 64 is one 64-column box (128-byte swizzle).
// The LSE variant (an `lse` pointer given) also writes each row's
// log-sum-exp, (F, H, T) f32, to AttnParams::l for the backward
// (csrc/vit_attn_bwd.cu), as K2 does.
// Three consumer warpgroups take 192 query rows a block (4 blocks a (frame,
// head) at T 729 and 734) and walk the keys in tiles of 64, as K6 does; the
// last 25 keys of 729 (30 of 734) run as one N 32 step, not a whole masked
// tile.
#include "attn_sm90.cuh"

namespace {
constexpr int kBKV = 64;    // keys a tile
constexpr int kNWG = 3;     // consumer warpgroups, 64 query rows each
constexpr int kNarrowQKV = 32;  // a last tile of at most 32 keys runs as N = 32
}

// block_rows: the query rows a block that the caller counts blocks in; a
// launch for another tile is refused. lse: (F, H, T) f32 row log-sum-exps,
// or null.
extern "C" int tv_vit_attn_qkv(const void* qkv, void* out, void* lse, int F, int T, int H,
                               int hd, int block_rows, float scale, void* stream) {
  using namespace tv::sm90;
  if (block_rows != kNWG * 64 || (hd != 72 && hd != 64) || F < 1 || T < 1 || H < 1)
    return cudaErrorInvalidValue;
  const long long C = (long long)H * hd, rs = 3 * C, bs = (long long)T * rs;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  const int boxw = hd == 64 ? 64 : 32;
  AttnParams p{};
  if (!(encode_map(&p.tq, base, hd, H, T, F, hd, rs, bs, boxw, 1, 64) &&
        encode_map(&p.tk, base + C, hd, H, T, F, hd, rs, bs, boxw, 1, kBKV) &&
        encode_map(&p.tv, base + 2 * C, hd, H, T, F, hd, rs, bs, boxw, 1, kBKV)))
    return cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(out);  // a fresh contiguous (F, T, H, hd)
  p.l = static_cast<float*>(lse);
  p.B = F; p.Lq = T; p.Lk = T; p.Hq = H; p.Hkv = H;
  p.pack = 1; p.n_split = 1; p.split_tiles = (T + kBKV - 1) / kBKV;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    return hd == 72 ? launch<72, 32, kNWG, kBKV, false, true, kNarrowQKV>(p, s)
                    : launch<64, 64, kNWG, kBKV, false, true, kNarrowQKV>(p, s);
  return hd == 72 ? launch<72, 32, kNWG, kBKV, false, false, kNarrowQKV>(p, s)
                  : launch<64, 64, kNWG, kBKV, false, false, kNarrowQKV>(p, s);
}
