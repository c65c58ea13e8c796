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
// tensor cores through mma.sync (attn_tile.cuh, the tile K2 runs). Each key
// tile is loaded and then consumed with no cp.async / TMA pipeline, and the
// softmax's exp runs per element: that, not the tensor cores, bounds it. One
// block per 64 query rows of one (batch, head): 64 x 32 blocks at Lq 4,096,
// Hq 32; a 256-row question gives only 128 blocks, under one wave of 132 SMs.
#include "attn_tile.cuh"

extern "C" int tv_block_attn(const void* q, const void* k, const void* v, const void* seg_q,
                             const void* seg_kv, void* o, void* l, void* m, int B, int Lq,
                             int Lk, int Hq, int Hkv, int D, long long k_bs, int causal,
                             float scale, void* stream) {
  if (D != 128 || Hq % Hkv != 0 || (causal && Lq != Lk) ||
      (seg_q == nullptr) != (seg_kv == nullptr))
    return cudaErrorInvalidValue;
  tv::AttnArgsLM a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.seg = static_cast<const int*>(seg_q);
  a.seg_kv = static_cast<const int*>(seg_kv);
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.q_bs = (long long)Lq * Hq * D;
  a.q_rs = Hq * D;
  a.q_hs = D;
  a.k_bs = k_bs;  // v shares it: both are row ranges of same-shaped buffers
  a.k_rs = Hkv * D;
  a.k_hs = D;
  a.o_bs = a.q_bs;
  a.o_rs = a.q_rs;
  a.o_hs = D;
  a.Lq = Lq; a.Lk = Lk; a.Hq = Hq; a.Hkv = Hkv;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? tv::launch_attn<128, true, false, true>(a, B, s)
                : tv::launch_attn<128, false, false, true>(a, B, s);
}
