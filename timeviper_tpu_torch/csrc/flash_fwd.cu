// Causal flash-attention forward with GQA and packed segment ids (K2).
//
// Replaces the TPU kernel timeviper_tpu/ops/flash_pallas.py:flash_attention,
// which wraps JAX's bundled Pallas TPU flash kernel and repeats the KV heads
// into its MHA layout. Here query head h reads KV head h / (Hq/Hkv) in place,
// any sequence length is taken (the TPU path needed L >= 512 and L % 256 == 0),
// and the left pads of a bucketed prompt (segment -1) are masked by segment
// equality like every other packed segment. Under autograd it also writes
// each row's log-sum-exp of the scaled logits (f32, (B, Hq, L); +inf for a
// row that saw no key) for the backward (flash_bwd.cu); the serving path
// passes NULL and skips it.
//
// What bounds it on the H100: the causal L^2 * D products (about 0.55 TFLOP
// per layer at L = 8192) on the bf16 tensor cores. The kernel is
// attn_sm90.cuh's causal mode (wgmma fed by a TMA ring from a producer warp,
// the longest key walks first, a block stopping at its diagonal and only the
// tiles that cross it masked), as K9 runs it: head dim 128 in 64-column boxes
// (128-byte swizzle), the `pack` query heads of one KV head in a block (4 on
// the 9B, so each K/V tile is loaded once for them), the segment ids as both
// the rows' and the keys' ids (the keys' by TMA, from rows the wrapper pads
// to a multiple of 4).
//
// The tile (query (row, head) pairs a block, keys a tile) is one of
// ops/flash_attention.py:FLASH_TILES: (128, 128), two consumer warpgroups
// and 128-key tiles, K9's tile, which every path runs; (128, 64) and
// (192, 64), three warpgroups as K6 runs them, for the K2 microbenchmark
// (bench/microbench_flash.py, the counterpart of the TPU script
// scripts/microbench_flash.py, which swept the bundled kernel's block sizes
// at L = 81,920).
#include "attn_sm90.cuh"

// seg_q (B, Lq) and seg_kv (B, Lk rounded up to 4, 16-byte aligned) int32,
// both or neither (then Lq == Lk); lse (B, Hq, Lq) f32 or null. pack query
// heads of one KV head a block (a power of two dividing Hq / Hkv and 64).
// A tile that is not instantiated is refused.
extern "C" int tv_flash_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                            const void* seg_kv, void* o, void* lse, int B, int Lq, int Lk,
                            int Hq, int Hkv, int D, int pack, int block_rows, int kv_tile,
                            float scale, void* stream) {
  using namespace tv::sm90;
  const int rep = Hkv > 0 ? Hq / Hkv : 0;
  if (D != 128 || Hkv <= 0 || Hq % Hkv != 0 || pack <= 0 || 64 % pack != 0 ||
      rep % pack != 0 || B < 1 || Lq < 1 || Lk < 1 ||
      (seg_q == nullptr) != (seg_kv == nullptr) || (seg_q != nullptr && Lq != Lk))
    return cudaErrorInvalidValue;
  AttnParams p{};
  if (!(encode_map(&p.tq, q, D, Hq, Lq, B, D, (long long)Hq * D, (long long)Lq * Hq * D, 64,
                   pack, 64 / pack) &&
        encode_map(&p.tk, k, D, Hkv, Lk, B, D, (long long)Hkv * D, (long long)Lk * Hkv * D, 64,
                   1, kv_tile) &&
        encode_map(&p.tv, v, D, Hkv, Lk, B, D, (long long)Hkv * D, (long long)Lk * Hkv * D, 64,
                   1, kv_tile) &&
        (seg_kv == nullptr ||
         encode_ids(&p.tseg, static_cast<const int*>(seg_kv), (Lk + 3) / 4 * 4, B, kv_tile))))
    return cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.l = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.Hq = Hq; p.Hkv = Hkv;
  p.pack = pack; p.n_split = 1; p.split_tiles = (Lk + kv_tile - 1) / kv_tile;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_rows == 128 && kv_tile == 128) return launch<128, 64, 2, 128, true, true>(p, s);
  if (block_rows == 128 && kv_tile == 64) return launch<128, 64, 2, 64, true, true>(p, s);
  if (block_rows == 192 && kv_tile == 64) return launch<128, 64, 3, 64, true, true>(p, s);
  return cudaErrorInvalidValue;
}
