// One KV block of attention that returns its row statistics (K9).
//
// Replaces the TPU kernel timeviper_tpu/parallel/seq_parallel.py:
// _block_attn_lse, which calls JAX's bundled Pallas TPU flash kernel
// (_flash_attention_impl with save_residuals=True) and returns the normalised
// output o with the row sum l and row max m of the scaled logits, so that
// partial results over disjoint key blocks merge exactly. The port's
// continuation on a cached prefix (models/prefix_cache.py) calls it twice per
// attention layer: a non-causal rectangular block (the suffix's queries
// against the prefix rows of the cache, Lq != Lk) and a causal square block
// (the suffix against its own rows), merged by (l, m).
//
// The TPU kernel repeated the KV heads into its MHA layout, needed Lq, Lk >=
// 256 and multiples of 256, and emitted NaN for a row that sees no key. Here
// query head h reads KV head h / (Hq/Hkv) in place, any Lq and Lk are taken
// (Lk = 0 too: an empty prefix), a row that sees no key gives l = 0, m = -inf
// and o = 0, and k and v are read through a batch stride of their own, so
// the prefix rows [valid_from, length) of a cache buffer are read where they
// lie, without a copy. Query and key segment ids (the wrapper folds the
// valid masks into them, as the TPU branch does) are compared for equality.
//
// What bounds it on the H100: the 4 * Lq * Lk * D products per (batch, head),
// 825 GFLOP for a 4,096-token clip against a 12,288-row prefix, on the bf16
// tensor cores. The kernel is attn_sm90.cuh's (wgmma fed by a TMA ring from
// a producer warp), at D 128 with two consumer warpgroups (128 (row, head)
// pairs a block). A block packs the `pack` query heads of one KV head, so
// each K/V tile is loaded once for them (4 on the 9B), not once per head.
// When the blocks of a call would not fill the card (a question of 12-300
// rows against a 16k prefix), the keys are split across blocks in whole
// tiles: each split writes its partial (o, l, m) in f32 to scratch the
// wrapper allocates, and attn_merge_kernel below merges them in split
// order. The plan (pack, n_split, split_tiles) is ops/block_attention.py:
// block_attn_plan, a function of the shapes alone, so the bits do not
// depend on the card. No atomics: a repeat gives the same bits.
#include "attn_sm90.cuh"

namespace {
constexpr int kBKV = 128;  // keys a tile
constexpr int kNWG = 2;    // consumer warpgroups, 64 (row, head) pairs each

// Merge n_split partial results of K9 in split order, by the rule of
// ops/block_attention.py:merge_parts: a split whose row saw no key (l = 0)
// gets weight 0. One warp a (batch, row, head), head dim 128, 4 columns a
// lane; no atomics, so a repeat gives the same bits.
__global__ void __launch_bounds__(256) attn_merge_kernel(const float* o_part, const float* l_part,
                                                         const float* m_part, __nv_bfloat16* o,
                                                         float* l, float* m, int n_split, int B,
                                                         int Lq, int Hq) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const long long rows = (long long)B * Lq * Hq;
  if (row >= rows) return;
  const int h = row % Hq, t = (row / Hq) % Lq, b = row / ((long long)Hq * Lq);
  const long long lm = ((long long)b * Hq + h) * Lq + t;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[s * rows + lm]);
  float total = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ls = l_part[s * rows + lm];
    total += ls > 0.f ? ls * expf(m_part[s * rows + lm] - mx) : 0.f;
  }
  const float denom = fmaxf(total, 1e-30f);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float ls = l_part[s * rows + lm];
    const float wgt = (ls > 0.f ? ls * expf(m_part[s * rows + lm] - mx) : 0.f) / denom;
    if (wgt > 0.f) {
      const float4 v = *reinterpret_cast<const float4*>(o_part + (s * rows + row) * 128 + lane * 4);
      acc.x += v.x * wgt;
      acc.y += v.y * wgt;
      acc.z += v.z * wgt;
      acc.w += v.w * wgt;
    }
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + row * 128 + lane * 4);
  dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
  dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
  if (lane == 0) {
    l[lm] = total;
    m[lm] = mx;
  }
}

}  // namespace

// seg_q (B, Lq) and seg_kv (B, Lk rounded up to 4) int32, both or neither;
// o_part, l_part and m_part are the splits' scratch when n_split > 1.
// kv_tile and block_rows are the tile that the plan (pack, n_split,
// split_tiles) was made for: a launch for another tile is refused.
extern "C" int tv_block_attn(const void* q, const void* k, const void* v, const void* seg_q,
                             const void* seg_kv, void* o, void* l, void* m, void* o_part,
                             void* l_part, void* m_part, int B, int Lq, int Lk, int Hq, int Hkv,
                             int D, long long k_bs, int causal, int kv_tile, int block_rows,
                             int pack, int n_split, int split_tiles, float scale, void* stream) {
  using namespace tv::sm90;
  const int rep = Hkv > 0 ? Hq / Hkv : 0;
  if (kv_tile != kBKV || block_rows != kNWG * 64 || D != 128 || Hkv <= 0 || Hq % Hkv != 0 ||
      (causal && (Lq != Lk || n_split != 1)) ||
      (seg_q == nullptr) != (seg_kv == nullptr) || pack <= 0 || 64 % pack != 0 ||
      rep % pack != 0 || n_split < 1 || split_tiles < 1 || B < 1 || Lq < 1 || Lk < 0 ||
      (long long)n_split * split_tiles * kBKV < Lk ||
      (n_split > 1 && ((long long)(n_split - 1) * split_tiles * kBKV >= Lk || o_part == nullptr ||
                       l_part == nullptr || m_part == nullptr)))
    return cudaErrorInvalidValue;
  AttnParams p{};
  if (!encode_map(&p.tq, q, D, Hq, Lq, B, D, (long long)Hq * D, (long long)Lq * Hq * D, 64, pack,
                  64 / pack))
    return cudaErrorInvalidValue;
  if (Lk > 0 &&  // an empty block is never read
      !(encode_map(&p.tk, k, D, Hkv, Lk, B, D, (long long)Hkv * D, k_bs, 64, 1, kBKV) &&
        encode_map(&p.tv, v, D, Hkv, Lk, B, D, (long long)Hkv * D, k_bs, 64, 1, kBKV) &&
        (seg_kv == nullptr ||
         encode_ids(&p.tseg, static_cast<const int*>(seg_kv), (Lk + 3) / 4 * 4, B, kBKV))))
    return cudaErrorInvalidValue;
  const bool split = n_split > 1;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_part = split ? static_cast<float*>(o_part) : nullptr;
  p.l = static_cast<float*>(split ? l_part : l);
  p.m = static_cast<float*>(split ? m_part : m);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.Hq = Hq; p.Hkv = Hkv;
  p.pack = pack; p.n_split = n_split; p.split_tiles = split_tiles;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = causal ? launch<128, 64, kNWG, kBKV, true>(p, s)
                   : launch<128, 64, kNWG, kBKV, false>(p, s);
  if (err != cudaSuccess || !split) return err;
  const long long rows = (long long)B * Lq * Hq;
  attn_merge_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(l_part),
      static_cast<const float*>(m_part), static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
      static_cast<float*>(m), n_split, B, Lq, Hq);
  return cudaGetLastError();
}
