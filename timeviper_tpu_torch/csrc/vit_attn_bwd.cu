// The backward of whole-frame non-causal ViT attention (dQ, dK, dV), the
// gradient K3 and K6 need when a vision tower trains.
//
// No TPU kernel is replaced: the JAX package has no Pallas backward for its
// whole-frame kernels and differentiates its jnp oracle
// (timeviper_tpu/ops/vit_attention.py:318-336), which off the TPU is what
// encoder_attention_qkv and encoder_attention run. A plain backward in
// PyTorch materialises (frames, heads, T, T) f32 scores, probabilities and
// their gradients: 2.2 GB each for one SigLIP layer at 64 frames. This kernel
// keeps them on chip.
//
// Shapes: SigLIP (hd 72, T 729, 16 heads) and DINOv2-L (hd 64, T 734) with
// q, k and v read in place from the fused (F, T, 3*H*hd) qkv rows and dq, dk,
// dv written into one fused (F, T, 3*H*hd) gradient; InternVideo2 (hd 88,
// T 1,025) with q and k their own tensors, v a column slice of the fused qkv,
// and dq, dk, dv three contiguous tensors. Every operand is read through its
// own (batch, row) strides; a head's hd columns are contiguous.
//
// As K2-bwd's non-causal mode (csrc/flash_bwd.cu), two kernels and no
// atomics, so the gradients are bitwise repeatable:
//   1. dq:  one block per (head, 128 query rows, frame). Its consumers first
//           form each row's D = rowsum(dO * O) from the forward's bf16 output
//           and the row log-sum-exp times log2(e) (K3's or K6's LSE
//           variant), and write both for dkv. K and V stream in 128-key
//           tiles: S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K.
//   2. dkv: one block per (head, 128 keys, frame). Two consumer warpgroups
//           own 64 keys each, their K and V loaded once; a producer warp
//           streams the 64-query tiles of Q, dO and the row data:
//           S^T = K Q^T, dP^T = V dO^T, P^T, dV += P^T dO, dS^T, dK += dS^T Q.
// Every product is attn_sm90.cuh's issue_qk / issue_pv, as in K2-bwd. hd 72
// and 88 are not multiples of wgmma's depth of 16 bf16: their operands come
// by TMA as 32-column boxes (64-byte swizzle) whose columns past hd TMA
// zero-fills, so the products that reduce over hd (S, dP) run at depth 80
// or 96, as K3 and K6 run Q K^T; the products whose N is hd (dV, dK, dQ) run
// at N 72 or 88. hd 64 is one 64-column box (128-byte swizzle). Column
// offsets of k and v in the fused row are multiples of H*hd elements, and a
// head's start one of hd: 16-byte multiples at these head dims, as TMA's
// boxes need.
//
// What bounds it on the H100: the five T^2 hd products per (frame, head), 10
// T^2 hd FLOP on the bf16 tensor cores (the two-kernel recompute issues
// seven): 0.38 GFLOP a (frame, head) at SigLIP's shape. A simple first
// kernel: two ring stages, no persistence, no overlap of one tile's last
// product with the next tile's first.
//
// Keys and queries past T are masked by position (TMA fills their rows with
// zeros); dK and dQ take the softmax scale at the end.
#include "attn_sm90.cuh"

namespace {

using namespace tv::sm90;

constexpr int kNWG = 2;                     // consumer warpgroups (64 rows each)
constexpr int kThreads = 128 * (kNWG + 1);
constexpr int kBK = kNWG * 64;              // dkv: keys a block
constexpr int kBQ = 64;                     // dkv: queries a tile
constexpr int kRows = kNWG * 64;            // dq: query rows a block
constexpr int kBKV = 128;                   // dq: keys a tile
constexpr int kRing = 2;                    // stages of each ring
constexpr float kLog2e = 1.4426950408889634f;

// The backward's own parameters: attn_sm90.cuh's AttnParams is shared by
// five forward kernels and stays as it is.
struct VitBwdParams {
  CUtensorMap tq, tk, tv, tdo;  // (hd, H, T, B), boxes (BOXW, 1, 64)
  CUtensorMap tlse, tdelta;     // (Tp, B * H) f32, boxes (64, 1)
  const __nv_bfloat16* o;       // (B, T, H, hd) contiguous: the forward's output
  const __nv_bfloat16* dO;      // the same layout
  const float* lse;             // (B, H, T): the forward's row log-sum-exp
  float* lse2;                  // (B, H, Tp): lse times log2(e), written by dq for dkv
  float* delta;                 // (B, H, Tp): rowsum(dO * O), the same
  __nv_bfloat16* dq;            // rows of H * hd gradient columns at (g_bs, g_rs)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long g_bs;
  int g_rs;
  int B, T, Tp, H;
  float scale, scale_log2;
};

template <int HD, int BOXW>
struct BwdShape {
  static constexpr int HDP = (HD + 15) / 16 * 16;       // depth of S and dP
  static constexpr int NBOX = (HDP + BOXW - 1) / BOXW;  // column boxes a row
  static constexpr int SWZ = 2 * BOXW;                  // bytes of a box row
  static constexpr int BOX = 64 * SWZ;                  // one 64-row box
  static constexpr int TILE = NBOX * BOX;               // 64 rows, every column box
  static constexpr int KV_TILE = 2 * TILE;              // dq: 128 keys, a box band 128 rows
  static constexpr size_t dkv_smem =
      1024 + 2 * kNWG * TILE + kRing * (2 * TILE + 2 * kBQ * 4) + 8 * (1 + 2 * kRing);
  static constexpr size_t dq_smem = 1024 + 2 * kNWG * TILE + kRing * 2 * KV_TILE +
                                    8 * (1 + 2 * kRing);
  static_assert(BOX % 1024 == 0, "swizzled boxes start on 1,024-byte boundaries");
};

// P = 2^(s scale log2e - lse2) in place for one NC-column tile of this
// thread's two rows (element e of chunk j: row e >> 1, column 8 j + cq +
// (e & 1)); lse2 per column (dkv: its queries) or per row (dq). With `mask`,
// a row or column at or past T gives 0.
template <int NC, bool COL_STATS>
__device__ __forceinline__ void probs(float (&s)[NC / 2], const float* lse2_col,
                                      const float (&lse2_row)[2], float sl2, bool mask,
                                      const int (&pos_row)[2], int col0, int T) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 lc = COL_STATS ? *reinterpret_cast<const float2*>(lse2_col + 8 * j + cq)
                                : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = COL_STATS ? ((e & 1) ? lc.y : lc.x) : lse2_row[e >> 1];
      float x = ex2(fmaf(s[4 * j + e], sl2, -l));
      if (mask) {
        const int col = col0 + 8 * j + cq + (e & 1);
        x = col < T && pos_row[e >> 1] < T ? x : 0.f;
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

// acc * mul rounded to bf16 into this thread's two rows of hd columns: row
// r's pointer is dst[r] (null past T).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float mul,
                                           __nv_bfloat16* const (&dst)[2]) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (dst[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst[r] + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Kernel 2. grid (H, ceil(T / 128), B), kThreads threads, dkv_smem bytes.
template <int HD, int BOXW>
__global__ void __launch_bounds__(kThreads, 1)
    vit_dkv_kernel(const __grid_constant__ VitBwdParams p) {
  using S = BwdShape<HD, BOXW>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;                   // [kNWG][NBOX][64][BOXW]
  uint8_t* sV = sK + kNWG * S::TILE;
  uint8_t* sQ = sV + kNWG * S::TILE;    // [kRing][NBOX][64][BOXW]
  uint8_t* sG = sQ + kRing * S::TILE;   // dO, the same
  float* lse_s = reinterpret_cast<float*>(sG + kRing * S::TILE);  // [kRing][kBQ]
  float* dl_s = lse_s + kRing * kBQ;                              // [kRing][kBQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kRing * kBQ);
  uint64_t* full = kv_full + 1;     // [kRing]: the stage's tiles have landed
  uint64_t* empty = full + kRing;   // [kRing]: every consumer is done with them

  const int T = p.T, h = blockIdx.x, b = blockIdx.z, k0 = blockIdx.y * kBK;
  const int n_qt = (T + kBQ - 1) / kBQ;
  const int n_active = min(kNWG, (T - k0 + 63) / 64);  // consumers with keys

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
    mbar_expect_tx(kv_full, n_active * 2 * S::TILE);
    for (int w = 0; w < n_active; ++w)
      for (int c = 0; c < S::NBOX; ++c) {
        tma_load_4d(sK + w * S::TILE + c * S::BOX, &p.tk, kv_full, c * BOXW, h, k0 + 64 * w, b);
        tma_load_4d(sV + w * S::TILE + c * S::BOX, &p.tv, kv_full, c * BOXW, h, k0 + 64 * w, b);
      }
    for (int it = 0; it < n_qt; ++it) {
      const int q0 = it * kBQ, st = it % kRing;
      mbar_wait(&empty[st], ((it / kRing) & 1) ^ 1);
      mbar_expect_tx(&full[st], 2 * S::TILE + 2 * kBQ * 4);
      for (int c = 0; c < S::NBOX; ++c) {
        tma_load_4d(sQ + st * S::TILE + c * S::BOX, &p.tq, &full[st], c * BOXW, h, q0, b);
        tma_load_4d(sG + st * S::TILE + c * S::BOX, &p.tdo, &full[st], c * BOXW, h, q0, b);
      }
      tma_load_2d(lse_s + st * kBQ, &p.tlse, &full[st], q0, b * p.H + h);
      tma_load_2d(dl_s + st * kBQ, &p.tdelta, &full[st], q0, b * p.H + h);
    }
  } else {
    // ---- consumers: 64 keys each ----
    regs_inc<240>();
    const int w = wg - 1;
    if (w >= n_active) return;
    const int lane = tid & 31, r_a = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int kw = k0 + 64 * w;  // this warpgroup's first key
    const int key[2] = {kw + r_a, kw + r_a + 8};
    const float no_row[2] = {0.f, 0.f};
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t pa[4][4];
    const uint32_t k_addr = smem_u32(sK + w * S::TILE), v_addr = smem_u32(sV + w * S::TILE);
    mbar_wait(kv_full, 0);
    __syncwarp();
    for (int it = 0; it < n_qt; ++it) {
      const int q0 = it * kBQ, st = it % kRing;
      const uint32_t parity = (it / kRing) & 1;
      const uint32_t q_addr = smem_u32(sQ + st * S::TILE), g_addr = smem_u32(sG + st * S::TILE);
      const bool mask = q0 + kBQ > T || kw + 64 > T;
      mbar_wait(&full[st], parity);
      __syncwarp();
      issue_qk<HD, BOXW, kBQ, kBQ>(s, k_addr, q_addr);   // S^T = K Q^T
      issue_qk<HD, BOXW, kBQ, kBQ>(dp, v_addr, g_addr);  // dP^T = V dO^T
      wg_wait<1>();
      pin(s);
      probs<kBQ, true>(s, lse_s + st * kBQ, no_row, p.scale_log2, mask, key, q0, T);
      to_bf16<4>(s, pa);
      issue_pv<HD, BOXW, kBQ, kBQ>(dv, pa, g_addr);  // dV += P^T dO
      wg_wait<1>();
      pin(dp);
      dsoft<kBQ, true>(dp, s, dl_s + st * kBQ, no_row);
      wg_wait<0>();
      pin(dv);
      pin(pa);
      to_bf16<4>(dp, pa);
      issue_pv<HD, BOXW, kBQ, kBQ>(dk, pa, q_addr);  // dK += dS^T Q
      wg_wait<0>();
      pin(dk);
      pin(pa);
      mbar_arrive(&empty[st]);
    }
    __nv_bfloat16* rows_k[2];
    __nv_bfloat16* rows_v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long off = (long long)b * p.g_bs + (long long)key[r] * p.g_rs + h * HD;
      rows_k[r] = key[r] < T ? p.dk + off : nullptr;
      rows_v[r] = key[r] < T ? p.dv + off : nullptr;
    }
    store_rows<HD>(dk, p.scale, rows_k);
    store_rows<HD>(dv, 1.f, rows_v);
  }
}

// Kernel 1. grid (H, ceil(T / 128), B), kThreads threads, dq_smem bytes. K
// and V tiles of 128 keys come as two 64-row boxes a column band.
template <int HD, int BOXW>
__global__ void __launch_bounds__(kThreads, 1)
    vit_dq_kernel(const __grid_constant__ VitBwdParams p) {
  using S = BwdShape<HD, BOXW>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;                    // [kNWG][NBOX][64][BOXW]
  uint8_t* sG = sQ + kNWG * S::TILE;     // dO, the same
  uint8_t* sK = sG + kNWG * S::TILE;     // [kRing][NBOX][128][BOXW]
  uint8_t* sV = sK + kRing * S::KV_TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kRing * S::KV_TILE);
  uint64_t* full = q_full + 1;     // [kRing]
  uint64_t* empty = full + kRing;  // [kRing]

  const int T = p.T, h = blockIdx.x, b = blockIdx.z, t0 = blockIdx.y * kRows;
  const int n_tiles = (T + kBKV - 1) / kBKV;
  const int n_active = min(kNWG, (T - t0 + 63) / 64);

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
    // ---- producer: Q and dO once, then K and V per tile ----
    regs_dec<24>();
    if (tid != 0) return;
    mbar_expect_tx(q_full, n_active * 2 * S::TILE);
    for (int w = 0; w < n_active; ++w)
      for (int c = 0; c < S::NBOX; ++c) {
        tma_load_4d(sQ + w * S::TILE + c * S::BOX, &p.tq, q_full, c * BOXW, h, t0 + 64 * w, b);
        tma_load_4d(sG + w * S::TILE + c * S::BOX, &p.tdo, q_full, c * BOXW, h, t0 + 64 * w, b);
      }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kRing, kv0 = i * kBKV;
      mbar_wait(&empty[st], ((i / kRing) & 1) ^ 1);
      mbar_expect_tx(&full[st], 2 * S::KV_TILE);
      for (int c = 0; c < S::NBOX; ++c)
        for (int r = 0; r < kBKV; r += 64) {
          const int off = st * S::KV_TILE + c * 2 * S::BOX + r * S::SWZ;
          tma_load_4d(sK + off, &p.tk, &full[st], c * BOXW, h, kv0 + r, b);
          tma_load_4d(sV + off, &p.tv, &full[st], c * BOXW, h, kv0 + r, b);
        }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    regs_inc<240>();
    const int w = wg - 1;
    if (w >= n_active) return;
    const int lane = tid & 31, r_a = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int tq[2] = {t0 + 64 * w + r_a, t0 + 64 * w + r_a + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row's delta and lse2, its quad's four threads a pair of columns
      // in every 8; the last row also writes the rows past it up to Tp
      const bool in = tq[r] < T;
      const int quad = tid & 3;
      float d = 0.f;
      if (in) {
        const long long off = (((long long)b * T + tq[r]) * p.H + h) * HD;
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(p.o + off);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(p.dO + off);
#pragma unroll
        for (int c = quad; c < HD / 2; c += 4) {
          const float2 a = __bfloat1622float2(x[c]), g = __bfloat1622float2(y[c]);
          d += a.x * g.x + a.y * g.y;
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const long long row = (long long)b * p.H + h;
      dl[r] = d;
      lse2[r] = in ? p.lse[row * T + tq[r]] * kLog2e : INFINITY;
      if (in && quad == 0) {
        p.delta[row * p.Tp + tq[r]] = d;
        p.lse2[row * p.Tp + tq[r]] = lse2[r];
        if (tq[r] == T - 1)
          for (int t = T; t < p.Tp; ++t) {
            p.delta[row * p.Tp + t] = 0.f;
            p.lse2[row * p.Tp + t] = INFINITY;
          }
      }
    }
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    float s[kBKV / 2], dp[kBKV / 2];
    uint32_t da[kBKV / 16][4];
    const uint32_t q_addr = smem_u32(sQ + w * S::TILE), g_addr = smem_u32(sG + w * S::TILE);
    mbar_wait(q_full, 0);
    __syncwarp();
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kRing, kv0 = i * kBKV;
      const uint32_t parity = (i / kRing) & 1;
      const uint32_t k_addr = smem_u32(sK + st * S::KV_TILE);
      const uint32_t v_addr = smem_u32(sV + st * S::KV_TILE);
      const bool mask = kv0 + kBKV > T || t0 + 64 * w + 64 > T;
      mbar_wait(&full[st], parity);
      __syncwarp();
      issue_qk<HD, BOXW, kBKV, kBKV>(s, q_addr, k_addr);   // S = Q K^T
      issue_qk<HD, BOXW, kBKV, kBKV>(dp, g_addr, v_addr);  // dP = dO V^T
      wg_wait<1>();
      pin(s);
      probs<kBKV, false>(s, nullptr, lse2, p.scale_log2, mask, tq, kv0, T);
      wg_wait<0>();
      pin(dp);
      dsoft<kBKV, false>(dp, s, nullptr, dl);
      to_bf16<kBKV / 16>(dp, da);
      issue_pv<HD, BOXW, kBKV, kBKV>(dq, da, k_addr);  // dQ += dS K
      wg_wait<0>();
      pin(dq);
      pin(da);
      mbar_arrive(&empty[st]);
    }
    __nv_bfloat16* rows[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rows[r] = tq[r] < T ? p.dq + (long long)b * p.g_bs + (long long)tq[r] * p.g_rs + h * HD
                          : nullptr;
    store_rows<HD>(dq, p.scale, rows);
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

// Make the device that holds `ptr` current in the calling thread: PyTorch
// runs a backward in a thread of its own, where this entry point may be the
// first CUDA work and no context is current (cuTensorMapEncodeTiled then
// refuses every map).
cudaError_t bind_device(const void* ptr) {
  cudaPointerAttributes a;
  const cudaError_t err = cudaPointerGetAttributes(&a, ptr);
  return err != cudaSuccess ? err : cudaSetDevice(a.device);
}

template <int HD, int BOXW>
int launch_bwd(const VitBwdParams& p, cudaStream_t s) {
  using S = BwdShape<HD, BOXW>;
  auto dkv = vit_dkv_kernel<HD, BOXW>;
  auto dq = vit_dq_kernel<HD, BOXW>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::dkv_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::dq_smem)) != cudaSuccess)
    return err;
  dq<<<dim3(p.H, (p.T + kRows - 1) / kRows, p.B), kThreads, S::dq_smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv<<<dim3(p.H, (p.T + kBK - 1) / kBK, p.B), kThreads, S::dkv_smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, T, H, hd) bf16 read through their (batch, row) element
// strides, heads side by side; o and dO contiguous (B, T, H, hd); lse (B, H,
// T) f32 from K3's or K6's LSE variant; lse2 and delta (B, H, Tp) f32
// scratch, Tp = T rounded up to 4; dq, dk, dv rows of H * hd columns at the
// strides (g_bs, g_rs), all three alike (the fused qkv gradient, or three
// contiguous tensors). hd 64, 72 or 88. A tile (keys a dkv block, query rows
// a dq block) that is not the built one is refused.
extern "C" int tv_vit_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const void* lse, void* lse2, void* delta,
                               void* dq, void* dk, void* dv, int B, int T, int H, int hd,
                               long long q_bs, int q_rs, long long k_bs, int k_rs, long long v_bs,
                               int v_rs, long long g_bs, int g_rs, int dkv_keys, int dq_rows,
                               float scale, void* stream) {
  using namespace tv::sm90;
  if ((hd != 64 && hd != 72 && hd != 88) || B < 1 || T < 1 || H < 1 || dkv_keys != kBK ||
      dq_rows != kRows)
    return cudaErrorInvalidValue;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  const int Tp = (T + 3) / 4 * 4, boxw = hd == 64 ? 64 : 32;
  const long long rs_o = (long long)H * hd;
  VitBwdParams p{};
  if (!(encode_map(&p.tq, q, hd, H, T, B, hd, q_rs, q_bs, boxw, 1, 64) &&
        encode_map(&p.tk, k, hd, H, T, B, hd, k_rs, k_bs, boxw, 1, 64) &&
        encode_map(&p.tv, v, hd, H, T, B, hd, v_rs, v_bs, boxw, 1, 64) &&
        encode_map(&p.tdo, dO, hd, H, T, B, hd, rs_o, rs_o * T, boxw, 1, 64) &&
        encode_f32_rows(&p.tlse, static_cast<const float*>(lse2), Tp, B * H, kBQ) &&
        encode_f32_rows(&p.tdelta, static_cast<const float*>(delta), Tp, B * H, kBQ)))
    return cudaErrorInvalidValue;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(lse2);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.g_bs = g_bs;
  p.g_rs = g_rs;
  p.B = B; p.T = T; p.Tp = Tp; p.H = H;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 72 ? launch_bwd<72, 32>(p, s)
                  : hd == 88 ? launch_bwd<88, 32>(p, s) : launch_bwd<64, 64>(p, s);
}

// Dynamic shared memory a block of the dkv (which 0) or dq kernel (1) at
// head dim hd, in bytes.
extern "C" int tv_vit_attn_bwd_smem(int which, int hd) {
  if (hd == 64) return (int)(which == 0 ? BwdShape<64, 64>::dkv_smem : BwdShape<64, 64>::dq_smem);
  if (hd == 72) return (int)(which == 0 ? BwdShape<72, 32>::dkv_smem : BwdShape<72, 32>::dq_smem);
  return (int)(which == 0 ? BwdShape<88, 32>::dkv_smem : BwdShape<88, 32>::dq_smem);
}
