// Flash-attention backward with GQA (K2-bwd), for Hopper, in two modes: causal
// with packed segment ids and Lq == Lk (the attention layers' training), and
// non-causal with separate query and key lengths and no segment ids (TransV's
// cross-attention of the text rows over a stage's dropped visual tokens, whose
// forward is K9).
//
// Replaces the backward of the TPU kernel that timeviper_tpu/ops/flash_pallas.py
// wraps: JAX's bundled Pallas TPU flash attention, whose VJP runs
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq (two pallas_calls,
// each with `causal` and separate q_seq_len / kv_seq_len). Here, as there,
// two kernels and no atomics, each instantiated for both modes (CAUSAL):
//   1. dq:    K2's forward structure: one block per (group of `pack` query
//             heads, 128 (row, head) pairs, batch), the last query tiles
//             first. Its consumers first compute their rows' D_i =
//             rowsum(dO_i * O_i) and the forward's row log-sum-exp times
//             log2(e), and write both, f32, in (B, Hq, Lp) rows for dkv (Lp
//             = Lq rounded up to 4, so that TMA can read a row's tiles; 0 /
//             +inf past Lq). Q and dO are read once through K2's packed
//             boxes, K and V (with the keys' segment ids) streamed in
//             128-key tiles, up to the diagonal (causal) or all Lk keys:
//             S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K;
//   2. dkv:   one block per (KV head, 128-key tile, batch), the first key
//             tiles (the longest query walks) launched first. Two consumer
//             warpgroups own 64 keys each, their K and V tiles loaded once;
//             a producer warp streams, for each of the GQA group's query
//             heads in turn, the query tiles from the diagonal down (causal)
//             or all Lq queries: Q, dO, the row statistics and the queries'
//             segment ids. Per tile:
//               S^T  = K Q^T                 wgmma, K and Q from shared memory
//               dP^T = V dO^T                wgmma
//               P^T  = 2^(S^T scale log2e - lse2), masked
//               dV  += P^T dO                wgmma, P^T from registers, dO
//                                            through the transpose bit
//               dS^T = P^T (dP^T - D)
//               dK  += dS^T Q                wgmma, dS^T from registers
//             so the group's heads are summed in the block's registers.
// With segment ids, each 64-token tile's least and greatest id
// (ops/flash_attention.py:tile_segment_ids) decide per tile pair: one id on
// both sides needs no segment compare, and disjoint ranges keep no pair, so
// the pair is not loaded or computed at all: a packed row's cross-segment
// blocks, half the causal triangle of the main case.
// dK and dQ take the softmax scale at the end. Every product is issued by
// attn_sm90.cuh's issue_qk / issue_pv with the operands' roles swapped; P
// and dS are rounded to bf16 for the tensor cores (as the forward rounds P)
// and every sum is f32 in a fixed order, so the gradients are bitwise
// repeatable.
//
// What bounds it on the H100: the causal L^2 * D products on the bf16 tensor
// cores, five per kept (query, key) pair (10 * Hq * D FLOP a pair; the
// two-kernel recompute issues seven). The operand tiles come by TMA into
// 128-byte-swizzled shared memory through an mbarrier ring (two stages), so
// the next tile's copies overlap this tile's products, and setmaxnreg gives
// the producer's registers to the consumers (24 / 240): dkv keeps dK and dV
// (64 + 64 f32 a thread) beside S^T and dP^T (32 + 32) at 64-query tiles; dq
// keeps dQ (64) beside S and dP (64 + 64) at 128-key tiles, 3-5% faster
// than 64 (PERF.md). A third ring stage for dkv measured level; leaving a
// tile's dQ product in flight over the next tile's S and dP ran out of
// registers (ptxas serializes the wgmma, C7512) and was 4-7% slower; delta
// in dq's prologue was 1% faster than a pass of its own. Head dim 128; any
// length; a -1 left pad is a segment like any other. Queries past Lq and keys
// past Lk are masked by position (TMA fills their rows with zeros), and a row
// that sees no key (its log-sum-exp +inf) gets probability 0 and gradient 0.
#include "attn_sm90.cuh"

namespace {

using namespace tv::sm90;

constexpr int kD = 128;
constexpr int kBox = 64 * 128;        // bytes of one 64-row, 64-column swizzled box
constexpr int kTile = 2 * kBox;       // 64 rows x 128 columns
constexpr int kNWG = 2;               // consumer warpgroups (64 rows each) in both kernels
constexpr int kThreads = 128 * (kNWG + 1);
constexpr int kBK = kNWG * 64;        // dkv: keys a block
constexpr int kBQ = 64;               // dkv: queries a tile
// tile_ids (ops/flash_attention.py:tile_segment_ids) hold one entry per
// FLASH_BWD_TILE[1] tokens, which tv_flash_bwd checks against kBQ; the
// kernels index them in 64-token tiles
static_assert(kBQ == 64, "tile_ids entries cover 64 tokens");
constexpr int kRows = kNWG * 64;      // dq: (row, head) pairs a block
constexpr int kBKV = 128;             // dq: keys a tile
constexpr int kRing = 2;              // stages of each ring
constexpr float kLog2e = 1.4426950408889634f;

// One more int than the causal-only struct had: its size stays 1,280 bytes
// (a multiple of the tensor maps' 64-byte alignment).
struct BwdParams {
  CUtensorMap tq, tdo;        // (D, Hq, Lq, B), boxes (64, 1, 64): dkv's query tiles
  CUtensorMap tq_pk, tdo_pk;  // the same, boxes (64, pack, 64 / pack): dq's (row, head) pairs
  CUtensorMap tk, tv;         // (D, Hkv, Lk, B), boxes (64, 1, 64)
  CUtensorMap tlse, tdelta;   // (Lp, B * Hq) f32, boxes (64, 1)
  CUtensorMap tseg;           // (L rounded up to 4, B) int32 ids, boxes (64, 1), if seg
  const __nv_bfloat16* o;     // (B, Lq, Hq, D): the forward's output
  const __nv_bfloat16* dO;
  const float* lse;           // (B, Hq, Lq): the forward's row log-sum-exp
  float* lse2;                // (B, Hq, Lp): lse times log2(e), written by dq for dkv
  float* delta;               // (B, Hq, Lp): rowsum(dO * O), the same
  const int* seg;             // (B, L) segment ids, or null (causal only: Lq == Lk == L)
  const int2* tile_ids;       // (B, ceil(L / 64)): a tile's least and greatest id (with seg)
  __nv_bfloat16* dq;          // (B, Lq, Hq, D)
  __nv_bfloat16* dk;          // (B, Lk, Hkv, D)
  __nv_bfloat16* dv;
  int B, Lq, Lk, Lp, Hq, Hkv, pack;
  float scale, scale_log2;
};
static_assert(sizeof(BwdParams) == 1280, "BwdParams grew past its 1,280 bytes");

// P = 2^(s scale log2e - lse2) in place for one NC-column tile of this
// thread's two rows (element e of chunk j: row e >> 1, column 8 j + cq +
// (e & 1)); lse2 per column (dkv: its queries) or per row (dq). With `mask`,
// a pair outside the causal (CAUSAL) and segment mask, or past Lq or Lk,
// gives 0.
template <int NC, bool COL_STATS, bool CAUSAL>
__device__ __forceinline__ void probs(float (&s)[NC / 2], const float* lse2_col,
                                      const float (&lse2_row)[2], float sl2, bool mask,
                                      const int* seg_col, const int (&seg_row)[2],
                                      const int (&pos_row)[2], int col0, int Lq, int Lk) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 lc = COL_STATS ? *reinterpret_cast<const float2*>(lse2_col + 8 * j + cq)
                                : make_float2(0.f, 0.f);
    const int2 ids = mask && seg_col != nullptr
                         ? *reinterpret_cast<const int2*>(seg_col + 8 * j + cq)
                         : make_int2(0, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = COL_STATS ? ((e & 1) ? lc.y : lc.x) : lse2_row[e >> 1];
      float x = ex2(fmaf(s[4 * j + e], sl2, -l));
      if (mask) {
        const int col = col0 + 8 * j + cq + (e & 1), row = pos_row[e >> 1];
        // dkv: rows are keys, columns queries; dq: rows are queries, columns keys
        const int q = COL_STATS ? col : row, k = COL_STATS ? row : col;
        const int id = (e & 1) ? ids.y : ids.x;
        const bool ok = q < Lq && k < Lk && (!CAUSAL || k <= q) &&
                        (seg_col == nullptr || id == seg_row[e >> 1]);
        x = ok ? x : 0.f;
      }
      s[4 * j + e] = x;
    }
  }
}

// dS = P (dP - D) in place in dp; D per column (dkv) or per row (dq).
template <int NC, bool COL_STATS>
__device__ __forceinline__ void dsoft(float (&dp)[NC / 2], const float (&p)[NC / 2],
                                      const float* d_col, const float (&d_row)[2]) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 dc = COL_STATS ? *reinterpret_cast<const float2*>(d_col + 8 * j + cq)
                                : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = COL_STATS ? ((e & 1) ? dc.y : dc.x) : d_row[e >> 1];
      dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - d);
    }
  }
}

// acc * mul rounded to bf16 into this thread's two rows of a (.., 128) row
// block: row r's pointer is dst[r] (null past L).
__device__ __forceinline__ void store_rows(const float (&acc)[64], float mul,
                                           __nv_bfloat16* const (&dst)[2]) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (dst[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst[r] + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

constexpr size_t kDkvSmem = 1024 + 2 * kNWG * kTile + kRing * (2 * kTile + 3 * kBQ * 4) +
                            8 * (1 + 2 * kRing);
constexpr int kKvTile = (kBKV / 64) * kTile;  // dq: bytes of one K or V tile
constexpr size_t kDqSmem =
    1024 + 2 * kNWG * kTile + kRing * (2 * kKvTile + kBKV * 4) + 8 * (1 + 2 * kRing);

// Whether a pair of 64-token tiles, given by their (least, greatest) ids,
// needs the segment compare: unless every token of both carries one id.
__device__ __forceinline__ bool mixed(int2 a, int2 b) {
  return a.x != a.y || b.x != b.y || a.x != b.x;
}

// Whether no pair of the two tiles shares an id: their id ranges are disjoint.
__device__ __forceinline__ bool apart(int2 a, int2 b) { return a.y < b.x || b.y < a.x; }

// Kernel 2. grid (Hkv, ceil(Lk / 128), B), kThreads threads, kDkvSmem bytes.
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;                    // [kNWG][2 boxes][64][64]
  uint8_t* sV = sK + kNWG * kTile;
  uint8_t* sQ = sV + kNWG * kTile;       // [kRing][2 boxes][64][64]
  uint8_t* sG = sQ + kRing * kTile;      // dO, the same
  float* lse_s = reinterpret_cast<float*>(sG + kRing * kTile);  // [kRing][kBQ]
  float* dl_s = lse_s + kRing * kBQ;                            // [kRing][kBQ]
  int* segq_s = reinterpret_cast<int*>(dl_s + kRing * kBQ);     // [kRing][kBQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(segq_s + kRing * kBQ);
  uint64_t* full = kv_full + 1;      // [kRing]: the stage's tiles have landed
  uint64_t* empty = full + kRing;    // [kRing]: every consumer is done with them

  const int Lq = p.Lq, Lk = CAUSAL ? p.Lq : p.Lk;
  const int hk = blockIdx.x, b = blockIdx.z, k0 = blockIdx.y * kBK;
  const int rep = p.Hq / p.Hkv;
  const int q_first = CAUSAL ? k0 : 0;  // query tiles from the diagonal down, or all
  const int n_qt = (Lq - q_first + kBQ - 1) / kBQ;
  const int n_it = rep * n_qt;
  const int n_active = min(kNWG, (Lk - k0 + 63) / 64);  // consumers with keys
  const bool seg = CAUSAL && p.seg != nullptr;
  const int2* tile_id = p.tile_ids + (long long)b * ((Lq + 63) / 64);
  // a query tile that no key of the block attends in its segment is skipped
  // by the producer and the consumers alike
  auto skipped = [&](int it) {
    if (!seg) return false;
    const int2 id_q = tile_id[(q_first + (it % n_qt) * kBQ) / 64];
    bool all = true;
    for (int w = 0; w < n_active; ++w) all = all && apart(tile_id[k0 / 64 + w], id_q);
    return all;
  };

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < kRing; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], n_active * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then Q, dO and the row data per tile ----
    regs_dec<24>();
    if (tid != 0) return;
    mbar_expect_tx(kv_full, n_active * 2 * kTile);
    for (int w = 0; w < n_active; ++w)
      for (int c = 0; c < 2; ++c) {
        tma_load_4d(sK + w * kTile + c * kBox, &p.tk, kv_full, c * 64, hk, k0 + 64 * w, b);
        tma_load_4d(sV + w * kTile + c * kBox, &p.tv, kv_full, c * 64, hk, k0 + 64 * w, b);
      }
    for (int it = 0, n = 0; it < n_it; ++it) {
      if (skipped(it)) continue;
      const int h = hk * rep + it / n_qt, q0 = q_first + (it % n_qt) * kBQ, st = n % kRing;
      mbar_wait(&empty[st], ((n / kRing) & 1) ^ 1);
      ++n;
      mbar_expect_tx(&full[st], 2 * kTile + 2 * kBQ * 4 + (seg ? kBQ * 4 : 0));
      for (int c = 0; c < 2; ++c) {
        tma_load_4d(sQ + st * kTile + c * kBox, &p.tq, &full[st], c * 64, h, q0, b);
        tma_load_4d(sG + st * kTile + c * kBox, &p.tdo, &full[st], c * 64, h, q0, b);
      }
      tma_load_2d(lse_s + st * kBQ, &p.tlse, &full[st], q0, b * p.Hq + h);
      tma_load_2d(dl_s + st * kBQ, &p.tdelta, &full[st], q0, b * p.Hq + h);
      if (seg) tma_load_2d(segq_s + st * kBQ, &p.tseg, &full[st], q0, b);
    }
  } else {
    // ---- consumers: 64 keys each ----
    regs_inc<240>();
    const int w = wg - 1;
    if (w >= n_active) return;
    const int lane = tid & 31, r_a = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int kw = k0 + 64 * w;  // this warpgroup's first key
    const int key[2] = {kw + r_a, kw + r_a + 8};
    int segk[2] = {0, 0};
    const int2 id_k = seg ? tile_id[kw / 64] : make_int2(0, 0);
    if (seg) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (key[r] < Lk) segk[r] = p.seg[(long long)b * Lk + key[r]];
    }
    const float no_row[2] = {0.f, 0.f};
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t pa[4][4];
    const uint32_t k_addr = smem_u32(sK + w * kTile), v_addr = smem_u32(sV + w * kTile);
    mbar_wait(kv_full, 0);
    __syncwarp();
    for (int it = 0, n = 0; it < n_it; ++it) {
      if (skipped(it)) continue;
      const int q0 = q_first + (it % n_qt) * kBQ, st = n % kRing;
      const uint32_t parity = (n / kRing) & 1;
      ++n;
      const uint32_t q_addr = smem_u32(sQ + st * kTile), g_addr = smem_u32(sG + st * kTile);
      // a tile that crosses the diagonal, or runs past Lq or Lk, or whose
      // tokens carry more than one segment id
      const bool mask = (seg && mixed(id_k, tile_id[q0 / 64])) || (CAUSAL && q0 < kw + 63) ||
                        q0 + kBQ > Lq || kw + 64 > Lk;
      mbar_wait(&full[st], parity);
      __syncwarp();
      issue_qk<kD, 64, kBQ, kBQ>(s, k_addr, q_addr);   // S^T = K Q^T
      issue_qk<kD, 64, kBQ, kBQ>(dp, v_addr, g_addr);  // dP^T = V dO^T
      wg_wait<1>();
      pin(s);
      probs<kBQ, true, CAUSAL>(s, lse_s + st * kBQ, no_row, p.scale_log2, mask,
                               seg ? segq_s + st * kBQ : nullptr, segk, key, q0, Lq, Lk);
      to_bf16<4>(s, pa);
      issue_pv<kD, 64, kBQ, kBQ>(dv, pa, g_addr);  // dV += P^T dO
      wg_wait<1>();
      pin(dp);
      dsoft<kBQ, true>(dp, s, dl_s + st * kBQ, no_row);
      wg_wait<0>();
      pin(dv);
      pin(pa);
      to_bf16<4>(dp, pa);
      issue_pv<kD, 64, kBQ, kBQ>(dk, pa, q_addr);  // dK += dS^T Q
      wg_wait<0>();
      pin(dk);
      pin(pa);
      mbar_arrive(&empty[st]);
    }
    __nv_bfloat16* rows_k[2];
    __nv_bfloat16* rows_v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long off = (((long long)b * Lk + key[r]) * p.Hkv + hk) * kD;
      rows_k[r] = key[r] < Lk ? p.dk + off : nullptr;
      rows_v[r] = key[r] < Lk ? p.dv + off : nullptr;
    }
    store_rows(dk, p.scale, rows_k);
    store_rows(dv, 1.f, rows_v);
  }
}

// Kernel 1. grid (Hq / pack, ceil(Lq * pack / 128), B), kThreads threads,
// kDqSmem bytes. K and V tiles of kBKV keys come as 64-row boxes (dkv's
// maps), two to a column band.
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const __grid_constant__ BwdParams p) {
  constexpr int BKV = kBKV, KV_TILE = kKvTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;                  // [kNWG][2 boxes][64][64]
  uint8_t* sG = sQ + kNWG * kTile;     // dO, the same
  uint8_t* sK = sG + kNWG * kTile;     // [kRing][2 boxes][BKV][64]
  uint8_t* sV = sK + kRing * KV_TILE;
  int* segk_s = reinterpret_cast<int*>(sV + kRing * KV_TILE);  // [kRing][BKV]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(segk_s + kRing * BKV);
  uint64_t* full = q_full + 1;     // [kRing]
  uint64_t* empty = full + kRing;  // [kRing]

  const int pack = p.pack, tok = 64 / pack, g = blockIdx.x, b = blockIdx.z;
  const int mt = gridDim.y - 1 - blockIdx.y;  // the longest key walks first
  const int t0 = mt * kNWG * tok;
  const int Lq = p.Lq, Lk = CAUSAL ? p.Lq : p.Lk;
  const int hk = g * pack / (p.Hq / p.Hkv);
  const int kv_end = CAUSAL ? min(Lk, t0 + kNWG * tok) : Lk;  // up to the diagonal, or all
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int n_active = min(kNWG, (Lq - t0 + tok - 1) / tok);
  const bool seg = CAUSAL && p.seg != nullptr;
  const int2* tile_id = p.tile_ids + (long long)b * ((Lq + 63) / 64);
  // a key tile that no row of the block attends in its segment is skipped by
  // the producer and the consumers alike
  const int L = Lq;
  auto skipped = [&](int i) {
    if (!seg) return false;
    bool all = true;
    for (int w = 0; w < n_active; ++w)
      for (int h = 0; h < BKV / 64 && i * BKV + 64 * h < L; ++h)
        all = all && apart(tile_id[(t0 + w * tok) / 64], tile_id[i * (BKV / 64) + h]);
    return all;
  };

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kRing; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], n_active * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO once, then K, V and the keys' ids per tile ----
    regs_dec<24>();
    if (tid != 0) return;
    mbar_expect_tx(q_full, n_active * 2 * kTile);
    for (int w = 0; w < n_active; ++w)
      for (int c = 0; c < 2; ++c) {
        tma_load_4d(sQ + w * kTile + c * kBox, &p.tq_pk, q_full, c * 64, g * pack,
                    t0 + w * tok, b);
        tma_load_4d(sG + w * kTile + c * kBox, &p.tdo_pk, q_full, c * 64, g * pack,
                    t0 + w * tok, b);
      }
    for (int i = 0, n = 0; i < n_tiles; ++i) {
      if (skipped(i)) continue;
      const int st = n % kRing, kv0 = i * BKV;
      mbar_wait(&empty[st], ((n / kRing) & 1) ^ 1);
      ++n;
      mbar_expect_tx(&full[st], 2 * KV_TILE + (seg ? BKV * 4 : 0));
      for (int c = 0; c < 2; ++c)
        for (int r = 0; r < BKV; r += 64) {
          const int off = st * KV_TILE + c * (BKV / 64) * kBox + r * 128;
          tma_load_4d(sK + off, &p.tk, &full[st], c * 64, hk, kv0 + r, b);
          tma_load_4d(sV + off, &p.tv, &full[st], c * 64, hk, kv0 + r, b);
          if (seg && c == 0)
            tma_load_2d(segk_s + st * BKV + r, &p.tseg, &full[st], kv0 + r, b);
        }
    }
  } else {
    // ---- consumers: 64 (row, head) pairs each ----
    regs_inc<240>();
    const int w = wg - 1;
    if (w >= n_active) return;
    const int lane = tid & 31, r_a = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int t_lo = t0 + w * tok, t_hi = min(Lq, t_lo + tok) - 1;
    const int tq[2] = {t_lo + r_a / pack, t_lo + (r_a + 8) / pack};
    const int hq[2] = {g * pack + r_a % pack, g * pack + (r_a + 8) % pack};
    float lse2[2], dl[2];
    int segq[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row's delta and lse2, its quad's four threads 32 columns each;
      // the last token's row also writes the rows past it up to Lp
      const bool in = tq[r] < Lq;
      const int quad = tid & 3;
      float d = 0.f;
      if (in) {
        const long long off = (((long long)b * Lq + tq[r]) * p.Hq + hq[r]) * kD + quad * 32;
        const uint4* x = reinterpret_cast<const uint4*>(p.o + off);
        const uint4* y = reinterpret_cast<const uint4*>(p.dO + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 xo = x[j], yg = y[j];
          const __nv_bfloat162* xo2 = reinterpret_cast<const __nv_bfloat162*>(&xo);
          const __nv_bfloat162* yg2 = reinterpret_cast<const __nv_bfloat162*>(&yg);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(xo2[e]), c = __bfloat1622float2(yg2[e]);
            d += a.x * c.x + a.y * c.y;
          }
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const long long row = (long long)b * p.Hq + hq[r];
      dl[r] = d;
      lse2[r] = in ? p.lse[row * Lq + tq[r]] * kLog2e : INFINITY;
      if (in && quad == 0) {
        p.delta[row * p.Lp + tq[r]] = d;
        p.lse2[row * p.Lp + tq[r]] = lse2[r];
        if (tq[r] == Lq - 1)
          for (int t = Lq; t < p.Lp; ++t) {
            p.delta[row * p.Lp + t] = 0.f;
            p.lse2[row * p.Lp + t] = INFINITY;
          }
      }
      if (seg && in) segq[r] = p.seg[(long long)b * Lq + tq[r]];
    }
    const int2 id_q = seg ? tile_id[t_lo / 64] : make_int2(0, 0);  // rows in one tile
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    float s[BKV / 2], dp[BKV / 2];
    uint32_t da[BKV / 16][4];
    const uint32_t q_addr = smem_u32(sQ + w * kTile), g_addr = smem_u32(sG + w * kTile);
    // tiles at or below this warpgroup's rows (causal), or all
    const int n_own = CAUSAL ? min(n_tiles, t_hi / BKV + 1) : n_tiles;
    mbar_wait(q_full, 0);
    __syncwarp();
    int n = 0;  // tiles the producer loaded so far
    for (int i = 0; i < n_own; ++i) {
      if (skipped(i)) continue;
      const int st = n % kRing, kv0 = i * BKV;
      const uint32_t parity = (n / kRing) & 1;
      ++n;
      const uint32_t k_addr = smem_u32(sK + st * KV_TILE), v_addr = smem_u32(sV + st * KV_TILE);
      bool mixed_ids = false;
      if (seg)
#pragma unroll
        for (int h = 0; h < BKV / 64; ++h)
          if (kv0 + 64 * h < Lk) mixed_ids |= mixed(id_q, tile_id[kv0 / 64 + h]);
      const bool mask = mixed_ids || kv0 + BKV > Lk || (CAUSAL && kv0 + BKV - 1 > t_lo);
      mbar_wait(&full[st], parity);
      __syncwarp();
      issue_qk<kD, 64, BKV, BKV>(s, q_addr, k_addr);   // S = Q K^T
      issue_qk<kD, 64, BKV, BKV>(dp, g_addr, v_addr);  // dP = dO V^T
      wg_wait<1>();
      pin(s);
      probs<BKV, false, CAUSAL>(s, nullptr, lse2, p.scale_log2, mask,
                                seg ? segk_s + st * BKV : nullptr, segq, tq, kv0, Lq, Lk);
      wg_wait<0>();
      pin(dp);
      dsoft<BKV, false>(dp, s, nullptr, dl);
      to_bf16<BKV / 16>(dp, da);
      issue_pv<kD, 64, BKV, BKV>(dq, da, k_addr);  // dQ += dS K
      wg_wait<0>();
      pin(dq);
      pin(da);
      mbar_arrive(&empty[st]);
    }
    for (int i = n_own; i < n_tiles; ++i) {  // past this warpgroup's rows: only released
      if (skipped(i)) continue;
      const int st = n % kRing;
      mbar_wait(&full[st], (n / kRing) & 1);
      mbar_arrive(&empty[st]);
      ++n;
    }
    __nv_bfloat16* rows[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rows[r] = tq[r] < Lq ? p.dq + (((long long)b * Lq + tq[r]) * p.Hq + hq[r]) * kD : nullptr;
    store_rows(dq, p.scale, rows);
  }
}

// A 2-D f32 map over `rows` rows of `ld` floats (ld a multiple of 4), read
// in boxes of (box_n, 1).
bool encode_f32_rows(CUtensorMap* map, const float* base, int ld, int rows, int box_n) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ld % 4 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_n, 1}, unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Make the device that holds `ptr` current in the calling thread. PyTorch
// runs a backward in a thread of its own; where this entry point is that
// thread's first CUDA work, no context is current there and
// cuTensorMapEncodeTiled refuses every tensor map, which came back as CUDA
// error 1 at launch.
cudaError_t bind_device(const void* ptr) {
  cudaPointerAttributes a;
  const cudaError_t err = cudaPointerGetAttributes(&a, ptr);
  return err != cudaSuccess ? err : cudaSetDevice(a.device);
}

}  // namespace

// q, o, dO, dq (B, Lq, Hq, 128), k, v, dk, dv (B, Lk, Hkv, 128) bf16, 16-byte
// aligned; lse (B, Hq, Lq) f32 from K2 (causal) or formed from K9's row
// statistics (non-causal); causal takes Lq == Lk; seg (B, L) int32 and
// seg_pad (its rows padded to 4 ids, pad_key_ids) and tile_ids (B, ceil(L /
// 64), 2: a tile's least and greatest id), all or none, and only causal; lse2
// and delta (B, Hq, Lp) f32 scratch, Lp = Lq rounded up to 4. pack: query
// heads of one KV head a dq block (gqa_pack). A tile (keys a dkv block,
// queries a dkv tile, pairs a dq block, keys a dq tile) that is not the built
// one is refused. Lq, Lk >= 1: the caller gives an empty side's zeros itself.
extern "C" int tv_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dO, const void* lse, const void* seg,
                            const void* seg_pad, const void* tile_ids, void* lse2, void* delta,
                            void* dq, void* dk, void* dv, int B, int Lq, int Lk, int Hq, int Hkv,
                            int D, int pack, int causal, int dkv_keys, int dkv_queries,
                            int dq_rows, int dq_keys, float scale, void* stream) {
  using namespace tv::sm90;
  const int rep = Hkv > 0 ? Hq / Hkv : 0;
  if (D != kD || Hkv <= 0 || Hq % Hkv != 0 || pack <= 0 || 64 % pack != 0 || rep % pack != 0 ||
      B < 1 || Lq < 1 || Lk < 1 || (causal && Lq != Lk) || (!causal && seg != nullptr) ||
      (seg == nullptr) != (seg_pad == nullptr) || (seg == nullptr) != (tile_ids == nullptr))
    return cudaErrorInvalidValue;
  if (dkv_keys != kBK || dkv_queries != kBQ || dq_rows != kRows || dq_keys != kBKV)
    return cudaErrorInvalidValue;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  const int Lp = (Lq + 3) / 4 * 4;
  const long long hs = D, rq = (long long)Hq * D, rk = (long long)Hkv * D;
  BwdParams p{};
  if (!(encode_map(&p.tq, q, D, Hq, Lq, B, hs, rq, rq * Lq, 64, 1, 64) &&
        encode_map(&p.tdo, dO, D, Hq, Lq, B, hs, rq, rq * Lq, 64, 1, 64) &&
        encode_map(&p.tq_pk, q, D, Hq, Lq, B, hs, rq, rq * Lq, 64, pack, 64 / pack) &&
        encode_map(&p.tdo_pk, dO, D, Hq, Lq, B, hs, rq, rq * Lq, 64, pack, 64 / pack) &&
        encode_map(&p.tk, k, D, Hkv, Lk, B, hs, rk, rk * Lk, 64, 1, 64) &&
        encode_map(&p.tv, v, D, Hkv, Lk, B, hs, rk, rk * Lk, 64, 1, 64) &&
        encode_f32_rows(&p.tlse, static_cast<const float*>(lse2), Lp, B * Hq, kBQ) &&
        encode_f32_rows(&p.tdelta, static_cast<const float*>(delta), Lp, B * Hq, kBQ) &&
        (seg_pad == nullptr ||
         encode_ids(&p.tseg, static_cast<const int*>(seg_pad), Lp, B, 64))))
    return cudaErrorInvalidValue;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(lse2);
  p.delta = static_cast<float*>(delta);
  p.seg = static_cast<const int*>(seg);
  p.tile_ids = static_cast<const int2*>(tile_ids);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.Lp = Lp; p.Hq = Hq; p.Hkv = Hkv; p.pack = pack;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto dkv = causal ? dkv_kernel<true> : dkv_kernel<false>;
  auto dqk = causal ? dq_kernel<true> : dq_kernel<false>;
  if ((err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kDkvSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kDqSmem)) != cudaSuccess)
    return err;
  const int rows_q = kRows / pack;  // tokens a dq block
  dqk<<<dim3(Hq / pack, (Lq + rows_q - 1) / rows_q, B), kThreads, kDqSmem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv<<<dim3(Hkv, (Lk + kBK - 1) / kBK, B), kThreads, kDkvSmem, s>>>(p);
  return cudaGetLastError();
}

// Dynamic shared memory a block of the dkv (which 0) or dq kernel (1), in
// bytes.
extern "C" int tv_flash_bwd_smem(int which) { return (int)(which == 0 ? kDkvSmem : kDqSmem); }
