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
// its one caller; here the last key tile masks the keys at or past T, which
// TMA zero-fills (exp(0) would be 1). Without a row max, l and o accumulate
// over the key tiles with no rescaling, exactly the sums the TPU kernel takes
// over the whole frame.
//
// What bounds it on the H100: the padded products, 4 * T^2 * 128 per (frame,
// head), 1.1 TFLOP at 256 frames of 729 tokens and 16 heads, on the bf16
// tensor cores (1.1 ms at 989 TFLOP/s); the 0.6 GB of qkv and output take
// 0.18 ms at 3.35 TB/s. The kernel is attn_sm90.cuh's with K10a's softmax
// policies (kNoMax, kLinear): wgmma fed by a TMA ring from a producer warp,
// q, k and v read in place through three 4-D maps (head dim, heads, rows,
// frame) based at columns 0, C and 2C (C = H * 128) with row stride 3C, in
// K2's 64-column, 128-byte-swizzle boxes; each consumer warpgroup pre-scales
// its Q rows in shared memory. A block owns the rows of one (frame, group of
// hpp heads) and walks the group's heads in turn, its K/V ring running on
// across the head boundary (two Q buffers), so a block's prologue and
// epilogue are paid once per hpp * T keys.
//
// The tile (query rows a block, keys a tile) is
// ops/headgrid_attention.py:HEADGRID_TILE, K3's geometry: three consumer
// warpgroups, 64-key tiles, the last 25 keys of 729 as one N 32 step. K2's
// (two warpgroups, 128-key tiles, a whole masked last tile) was 11-48%
// slower at 8 frames and 10-19% at 256 (PERF.md).
#include "attn_sm90.cuh"

namespace {

constexpr int kRows = 192;   // query rows a block: three consumer warpgroups
constexpr int kBKV = 64;     // keys a tile
constexpr int kLastStep = 32;  // a last tile of at most 32 keys runs as N = 32

}  // namespace

// qkv (B, T, 3 * H * 128) bf16, 16-byte aligned; out (B, T, H * 128). A
// tile (block_rows, kv_tile) other than the built one is refused.
extern "C" int tv_headgrid_attn(const void* qkv, void* out, int B, int T, int H, int hpp,
                                int do_exp, int block_rows, int kv_tile, float scale,
                                void* stream) {
  using namespace tv::sm90;
  constexpr int HD = 128;
  if (B < 1 || T < 1 || H < 1 || hpp < 1 || H % hpp != 0 || block_rows != kRows ||
      kv_tile != kBKV)
    return cudaErrorInvalidValue;
  const long long C = (long long)H * HD, rs = 3 * C, bs = (long long)T * rs;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  AttnParams p{};
  if (!(encode_map(&p.tq, base, HD, H, T, B, HD, rs, bs, 64, 1, 64) &&
        encode_map(&p.tk, base + C, HD, H, T, B, HD, rs, bs, 64, 1, kv_tile) &&
        encode_map(&p.tv, base + 2 * C, HD, H, T, B, HD, rs, bs, 64, 1, kv_tile)))
    return cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.Lq = T; p.Lk = T; p.Hq = H; p.Hkv = H;
  p.pack = 1; p.n_split = 1; p.split_tiles = (T + kv_tile - 1) / kv_tile;
  p.scale = scale;  // rounded to bf16 by the pre-scale
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr Softmax E = Softmax::kNoMax, N = Softmax::kLinear;
  switch (hpp * 2 + (do_exp ? 1 : 0)) {
    case 3: return launch<HD, 64, 3, kBKV, false, false, kLastStep, E, 1>(p, s);
    case 2: return launch<HD, 64, 3, kBKV, false, false, kLastStep, N, 1>(p, s);
    case 5: return launch<HD, 64, 3, kBKV, false, false, kLastStep, E, 2>(p, s);
    case 4: return launch<HD, 64, 3, kBKV, false, false, kLastStep, N, 2>(p, s);
    case 9: return launch<HD, 64, 3, kBKV, false, false, kLastStep, E, 4>(p, s);
    case 8: return launch<HD, 64, 3, kBKV, false, false, kLastStep, N, 4>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block, in bytes: one Q buffer at hpp 1, two above.
extern "C" int tv_headgrid_smem(int hpp) {
  using tv::sm90::smem_bytes;
  return (int)(hpp > 1 ? smem_bytes<128, 64, 3, kBKV, 2>() : smem_bytes<128, 64, 3, kBKV, 1>());
}
