// Causal flash-attention forward with GQA and packed segment ids, for Hopper.
//
// Replaces the TPU kernel timeviper_tpu/ops/flash_pallas.py:flash_attention,
// which wraps JAX's bundled Pallas TPU flash kernel and repeats the KV heads
// into its MHA layout. Here query head h reads KV head h / (Hq/Hkv) in place,
// any sequence length is taken (the TPU path needed L >= 512 and L % 256 == 0),
// and the left pads of a bucketed prompt (segment -1) are masked by segment
// equality like every other packed segment.
//
// What bounds it on the H100: the causal L^2 * D products (about 0.55 TFLOP
// per layer at L = 8192). They run on the bf16 tensor cores through mma.sync
// (attn_tile.cuh), with f32 accumulation and row statistics. Each key tile
// is loaded and then consumed, with no cp.async / TMA pipeline to overlap the
// two, and the softmax's exp runs per element: that, not the tensor cores,
// bounds it. It keeps the O(L) memory of the online softmax from the TPU
// design and skips key tiles past the query tile's last row. Under autograd
// it also writes each row's log-sum-exp (f32, (B, Hq, L)) for the backward
// (flash_bwd.cu); the serving path passes NULL and skips it.
//
// The tile (BQ, BKV) is chosen per call from {64, 128}^2: BQ 128 runs 8
// warps, and BKV 128 takes more than 48 KB of dynamic shared memory. The
// paths run (64, 64); the K2 microbenchmark (bench/microbench_flash.py, the
// counterpart of the TPU script scripts/microbench_flash.py, which swept the
// bundled kernel's block sizes at L = 81,920) runs all four.
#include "attn_tile.cuh"

namespace {

tv::AttnArgs flash_args(const void* q, const void* k, const void* v, const void* seg, void* o,
                        void* lse, int Lq, int Lk, int Hq, int Hkv, int D, float scale) {
  tv::AttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.seg = static_cast<const int*>(seg);
  a.lse = static_cast<float*>(lse);
  a.q_bs = (long long)Lq * Hq * D;
  a.q_rs = Hq * D;
  a.q_hs = D;
  a.k_bs = (long long)Lk * Hkv * D;
  a.k_rs = Hkv * D;
  a.k_hs = D;
  a.o_bs = a.q_bs;
  a.o_rs = a.q_rs;
  a.o_hs = D;
  a.Lq = Lq; a.Lk = Lk; a.Hq = Hq; a.Hkv = Hkv;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" int tv_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                            void* o, void* lse, int B, int Lq, int Lk, int Hq, int Hkv, int D,
                            float scale, int bq, int bkv, void* stream) {
  if (D != 128 || Hq % Hkv != 0 || (seg != nullptr && Lq != Lk)) return cudaErrorInvalidValue;
  const tv::AttnArgs a = flash_args(q, k, v, seg, o, lse, Lq, Lk, Hq, Hkv, D, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq == 64 && bkv == 64) return tv::launch_attn<128, true, false, false, 64, 64>(a, B, s);
  if (bq == 64 && bkv == 128) return tv::launch_attn<128, true, false, false, 64, 128>(a, B, s);
  if (bq == 128 && bkv == 64) return tv::launch_attn<128, true, false, false, 128, 64>(a, B, s);
  if (bq == 128 && bkv == 128) return tv::launch_attn<128, true, false, false, 128, 128>(a, B, s);
  return cudaErrorInvalidValue;
}
