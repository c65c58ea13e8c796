// Mamba-2 SSD chunked-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel timeviper_tpu/ops/ssd_pallas.py:_ssd_bwd_kernel
// (driven by _ssd_pallas_bwd, the backward of the custom_vjp _ssd_core). It
// gives the gradients of (y, final state) with respect to x, dt (raw), A, B,
// C, D, dt_bias and the initial state, from the output cotangents and the
// per-chunk inbound states the forward (ssd_fwd.cu) kept.
//
// The TPU kernel walks the chunks of one (batch, group) in reverse and
// carries the state cotangent dh in VMEM: at batch 1 and 8 groups that is 8
// sequential programs for 132 SMs. Here, as in the forward, the work is split
// into passes that run in parallel over chunks, with only one short
// sequential walk:
//   1. dt:        processed dt, chunk-local cumsum of dt*A, the chunk carry
//                 (the forward's pass 1, recomputed);
//   2. cb:        C.B^T per (chunk, group), the lower-triangle tiles;
//   3. contrib:   what each chunk adds to the cotangent of its inbound state,
//                 sum_i w_out_i dy_i^T C_i (P x N), per (chunk, head);
//   4. dstate:    a reverse walk over the nc chunks, one thread per state
//                 element: dh_in(c) = carry_c dh_out(c) + contrib_c, seeded
//                 with the final-state cotangent. It leaves dh_out(c), the
//                 cotangent of chunk c's end state, and d initial state.
//   5. dc / db:   one block per (chunk, group, 64-row tile) that loops over
//                 the group's heads as the TPU kernel does, so dC (rows i)
//                 and dB (rows j) are summed over the heads inside the block
//                 with no atomics. dc computes dM = dy.xdt^T on the i rows,
//                 dCB and dC; db the transposed tiles on the j rows, dB, dxdt,
//                 dx and the per-position pieces of the dt gradient.
//   6. dtfinal:   per (chunk, head): the suffix sum of the cumsum cotangent,
//                 ddt_raw (softplus' sigmoid and the dt_limit clip mask, 0 on
//                 the ragged tail), and per-chunk partials of dA, d dt_bias
//                 and dD that the wrapper sums (a tiny torch.sum, as the JAX
//                 wrapper's jnp.sum over its per-program partials).
// Every sum has a fixed order, so the gradients are bitwise repeatable.
//
// What bounds it: about 2.3x the forward's products (dM, M^T dy, dCB B,
// dCB^T C per head and chunk, plus the P x N cross terms), on the bf16
// tensor cores (mma.sync m16n8k16) with bf16 operands and f32 sums as in the
// TPU kernel; then the scalar work that builds the masked decay tiles and the
// f32 scratch traffic (inbound states and their cotangents, 4 MB a chunk at
// the 9B's 128 heads). Segment ids reset the state exactly as the forward
// and the TPU kernel do: cont, keep_last, no_boundary and the previous
// chunk's last id (clamped at chunk 0).
#include "common.cuh"

namespace {

using tv::bf;
using tv::to_bf;

constexpr int kP = 64;
constexpr int kN = 128;
constexpr int kTile = 64;
constexpr int kLDN = kN + 8;
constexpr int kLDP = kP + 8;
constexpr int kThreads = 128;

struct BwdArgs {
  const __nv_bfloat16* x;   // (B, L, H, P)
  const __nv_bfloat16* dt;  // (B, L, H) raw
  const float* A;           // (H,)
  const float* dt_bias;     // (H,) or null
  const float* D;           // (H,) or null
  const __nv_bfloat16* Bm;  // (B, L, G, N)
  const __nv_bfloat16* Cm;  // (B, L, G, N)
  const int* seq;           // (B, L) or null
  const float* states;      // (B, nc, H, P, N) inbound states from the forward
  const __nv_bfloat16* dy;  // (B, L, H, P)
  const float* dfinal;      // (B, H, P, N) or null
  __nv_bfloat16* dx;        // (B, L, H, P)
  float* ddt;               // (B, L, H)
  float* dB;                // (B, L, G, N)
  float* dC;                // (B, L, G, N)
  float* dinit;             // (B, H, P, N)
  float* part;              // (3, B, nc, H): dA, d dt_bias, dD per chunk
  float* dtp;               // (B, H, Lp)
  float* acs;               // (B, H, Lp)
  float* carry;             // (B, H, nc)
  float* cb;                // (B, nc, G, cs, cs)
  float* dstates;           // (B, nc, H, P, N): contributions, then dh_out
  float* da;                // (B, H, Lp) cotangent of the cumsum, before the suffix sum
  float* ubuf;              // (B, H, Lp) the u_j term (its chunk sum feeds the last row)
  float* ddt1;              // (B, H, Lp) sum_p dxdt x
  int B, L, H, G, cs, nc, Lp;
  int clamp;
  float dt_lo, dt_hi;
};

__device__ __forceinline__ int seg_at(const BwdArgs& a, int b, int t) {
  if (a.seq == nullptr) return 0;
  if (t >= a.L) t = a.L - 1;
  return a.seq[(size_t)b * a.L + t];
}

__device__ __forceinline__ int seg_prev(const BwdArgs& a, int b, int c) {
  return c == 0 ? seg_at(a, b, 0) : seg_at(a, b, c * a.cs - 1);
}

__device__ __forceinline__ float softplus_f(float d) { return d > 20.f ? d : log1pf(expf(d)); }

// Sum over the block (all threads call it; blockDim.x a multiple of 32).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // warp_part of an earlier call is no longer read
  if (lane == 0) warp_part[w] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += warp_part[i];
  return s;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Pass 1. grid (nc, H, B), block cs threads (the forward's pass 1).
__global__ void dt_kernel(BwdArgs a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int pos = c * a.cs + t;
  float d = 0.f;
  if (pos < a.L) {
    d = bf(a.dt[((size_t)b * a.L + pos) * a.H + h]);
    if (a.dt_bias) d += a.dt_bias[h];
    d = softplus_f(d);
    if (a.clamp) d = fminf(fmaxf(d, a.dt_lo), a.dt_hi);
  }
  const float v = tv::block_inclusive_scan(d * a.A[h]);
  const size_t o = ((size_t)b * a.H + h) * a.Lp + pos;
  a.dtp[o] = d;
  a.acs[o] = v;
  if (t == a.cs - 1) {
    const int first = seg_at(a, b, c * a.cs), last = seg_at(a, b, pos);
    const bool keep = first == last && first == seg_prev(a, b, c);
    a.carry[((size_t)b * a.H + h) * a.nc + c] = keep ? expf(v) : 0.f;
  }
}

// Pass 2. grid (nc * T * T, G, B), 128 threads; tiles above the diagonal exit.
__global__ void __launch_bounds__(kThreads) cb_kernel(BwdArgs a) {
  const int T = a.cs / kTile;
  const int c = blockIdx.x / (T * T);
  const int it = (blockIdx.x % (T * T)) / T, jt = blockIdx.x % T;
  if (jt > it) return;
  const int g = blockIdx.y, b = blockIdx.z;
  __shared__ __align__(16) __nv_bfloat16 Cs[kTile][kLDN];
  __shared__ __align__(16) __nv_bfloat16 Bs[kTile][kLDN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = c * a.cs + it * kTile, j0 = c * a.cs + jt * kTile;
  for (int e = tid; e < kTile * kN / 8; e += kThreads) {
    const int r = e / (kN / 8), n = (e % (kN / 8)) * 8;
    const int pi = i0 + r, pj = j0 + r;
    *reinterpret_cast<uint4*>(&Cs[r][n]) =
        tv::ld_row8(a.Cm + (((size_t)b * a.L + pi) * a.G + g) * kN + n, pi < a.L);
    *reinterpret_cast<uint4*>(&Bs[r][n]) =
        tv::ld_row8(a.Bm + (((size_t)b * a.L + pj) * a.G + g) * kN + n, pj < a.L);
  }
  __syncthreads();
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  float acc[kTile / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < kN / 16; ++ks) {
    const uint32_t af[4] = {tv::ld32(&Cs[r0][ks * 16 + cq]), tv::ld32(&Cs[r0 + 8][ks * 16 + cq]),
                            tv::ld32(&Cs[r0][ks * 16 + cq + 8]),
                            tv::ld32(&Cs[r0 + 8][ks * 16 + cq + 8])};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const __nv_bfloat16* p = &Bs[nt * 8 + (lane >> 2)][ks * 16 + cq];
      tv::mma_16816(acc[nt], af, tv::ld32(p), tv::ld32(p + 8));
    }
  }
  float* out = a.cb + (((size_t)b * a.nc + c) * a.G + g) * a.cs * a.cs;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = it * kTile + r0 + 8 * half, j = jt * kTile + nt * 8 + cq;
      *reinterpret_cast<float2*>(out + (size_t)i * a.cs + j) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
}

// Pass 3. grid (nc, H, B), 128 threads. dstates[b,c,h,p,n] = sum_i w_i dy[i,p]
// C[i,n] with w_i = exp(acs_i) for the rows of the inbound state's segment
// (the forward's chunk_state product with dy, w_out and C).
__global__ void __launch_bounds__(kThreads) contrib_kernel(BwdArgs a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  extern __shared__ float w[];  // cs weights
  __shared__ __align__(16) __nv_bfloat16 Ys[kTile][kLDP];  // dy * w, [i][p]
  __shared__ __align__(16) __nv_bfloat16 Cs[kTile][kLDN];  // C, [i][n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
  const int sprev = seg_prev(a, b, c);
  for (int t = tid; t < a.cs; t += kThreads)
    w[t] = seg_at(a, b, c * a.cs + t) == sprev ? expf(a.acs[hrow + t]) : 0.f;
  float acc[kN / 8][4] = {};
  for (int i0 = 0; i0 < a.cs; i0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * kP; e += kThreads) {
      const int i = e / kP, p = e % kP, pos = c * a.cs + i0 + i;
      Ys[i][p] = to_bf(pos < a.L ? bf(a.dy[(((size_t)b * a.L + pos) * a.H + h) * kP + p]) *
                                       w[i0 + i]
                                 : 0.f);
    }
    for (int e = tid; e < kTile * kN / 8; e += kThreads) {
      const int i = e / (kN / 8), n = (e % (kN / 8)) * 8, pos = c * a.cs + i0 + i;
      *reinterpret_cast<uint4*>(&Cs[i][n]) =
          tv::ld_row8(a.Cm + (((size_t)b * a.L + pos) * a.G + g) * kN + n, pos < a.L);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      tv::ldsm_x4_trans(af, &Ys[kk * 16 + (lane & 7) + 8 * (lane >> 4)]
                               [warp * 16 + 8 * ((lane >> 3) & 1)]);
      const __nv_bfloat16* crow = &Cs[kk * 16 + (lane & 15)][0];
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t b0, b1;
        tv::ldsm_x2_trans(b0, b1, crow + nt * 8);
        tv::mma_16816(acc[nt], af, b0, b1);
      }
    }
  }
  float* out = a.dstates + (((size_t)b * a.nc + c) * a.H + h) * kP * kN;
  const int p0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out + (p0 + 8 * half) * kN + nt * 8 + cq) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
}

// Pass 4. grid (P*N / 128, H, B): one thread per state element walks the
// chunks in reverse, replacing each chunk's contribution with dh_out(c).
__global__ void __launch_bounds__(kThreads) dstate_kernel(BwdArgs a) {
  constexpr int kUnroll = 8;
  const int e = blockIdx.x * kThreads + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t hstride = (size_t)a.H * kP * kN;
  const size_t own = ((size_t)b * a.H + h) * kP * kN + e;
  float s = a.dfinal ? a.dfinal[own] : 0.f;
  float* st = a.dstates + (size_t)b * a.nc * hstride + (size_t)h * kP * kN + e;
  const float* carry = a.carry + ((size_t)b * a.H + h) * a.nc;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= kUnroll) {
    float local[kUnroll], decay[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 - u >= 0) {
        local[u] = st[(c0 - u) * hstride];
        decay[u] = carry[c0 - u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 - u >= 0) {
        st[(c0 - u) * hstride] = s;
        s = s * decay[u] + local[u];
      }
    }
  }
  a.dinit[own] = s;
}

// Shared-memory carving of the dc / db kernels (16-byte aligned pieces).
struct TileSmem {
  __nv_bfloat16* own_n;   // [64][kLDN] group rows of the block's own tile (C for dc, B for db)
  __nv_bfloat16* state;   // [64 (p)][kLDN] h_in (dc) or dh_out (db) of the head, bf16
  __nv_bfloat16* own_p;   // [64][kLDP] dy rows (dc) or xdt rows (db) of the head
  __nv_bfloat16* walk_p;  // [64][kLDP] xdt rows (dc) or dy rows (db) of the walked tile
  __nv_bfloat16* walk_n;  // [64][kLDN] B rows (dc) or C rows (db) of the walked tile
  float* own_acs;         // [64]
  float* own_w;           // [64] w_out (dc) or w_st (db)
  float* own_dtp;         // [64]
  float* walk_acs;        // [64]
  int* own_seg;           // [64]
  int* walk_seg;          // [64]
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (3 * kTile * kLDN + 2 * kTile * kLDP) +
      sizeof(float) * 4 * kTile + sizeof(int) * 2 * kTile;
  __device__ explicit TileSmem(unsigned char* raw) {
    own_n = reinterpret_cast<__nv_bfloat16*>(raw);
    state = own_n + kTile * kLDN;
    own_p = state + kTile * kLDN;
    walk_p = own_p + kTile * kLDP;
    walk_n = walk_p + kTile * kLDP;
    own_acs = reinterpret_cast<float*>(walk_n + kTile * kLDN);
    own_w = own_acs + kTile;
    own_dtp = own_w + kTile;
    walk_acs = own_dtp + kTile;
    own_seg = reinterpret_cast<int*>(walk_acs + kTile);
    walk_seg = own_seg + kTile;
  }
};

// 64 rows of a group stream [.][N] (B or C) into a [64][kLDN] tile.
__device__ __forceinline__ void load_group_rows(const BwdArgs& a, const __nv_bfloat16* src,
                                                __nv_bfloat16* dst, int b, int g, int pos0) {
  for (int e = threadIdx.x; e < kTile * kN / 8; e += kThreads) {
    const int r = e / (kN / 8), n = (e % (kN / 8)) * 8, pos = pos0 + r;
    *reinterpret_cast<uint4*>(dst + r * kLDN + n) =
        tv::ld_row8(src + (((size_t)b * a.L + pos) * a.G + g) * kN + n, pos < a.L);
  }
}

// 64 rows of head h of a [.][H][P] stream, times an optional per-row f32
// weight (dtp for xdt), into a [64][kLDP] bf16 tile.
__device__ __forceinline__ void load_head_rows(const BwdArgs& a, const __nv_bfloat16* src,
                                               __nv_bfloat16* dst, int b, int h, int pos0,
                                               const float* row_w) {
  for (int e = threadIdx.x; e < kTile * kP; e += kThreads) {
    const int r = e / kP, p = e % kP, pos = pos0 + r;
    float v = 0.f;
    if (pos < a.L) {
      v = bf(src[(((size_t)b * a.L + pos) * a.H + h) * kP + p]);
      if (row_w) v *= row_w[r];
    }
    dst[r * kLDP + p] = to_bf(v);
  }
}

// A (P x N) f32 state of one (chunk, head) into a [64][kLDN] bf16 tile.
__device__ __forceinline__ void load_state(const float* src, __nv_bfloat16* dst) {
  for (int e = threadIdx.x; e < kP * kN / 4; e += kThreads) {
    const int p = e / (kN / 4), n = (e % (kN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + p * kN + n);
    *reinterpret_cast<uint2*>(dst + p * kLDN + n) =
        make_uint2(tv::pack_bf16(v.x, v.y), tv::pack_bf16(v.z, v.w));
  }
}

// A fragment of rows (r, r + 8) x cols (16 kk + cq ...) of a [.][ld] bf16
// tile, each row scaled by its f32 weight before the bf16 rounding.
__device__ __forceinline__ void scaled_afrag(uint32_t (&af)[4], const __nv_bfloat16* t, int ld,
                                             int r, int col, float w0, float w1) {
  const __nv_bfloat16* p0 = t + r * ld + col;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  af[0] = tv::pack_bf16(bf(p0[0]) * w0, bf(p0[1]) * w0);
  af[1] = tv::pack_bf16(bf(p1[0]) * w1, bf(p1[1]) * w1);
  af[2] = tv::pack_bf16(bf(p0[8]) * w0, bf(p0[9]) * w0);
  af[3] = tv::pack_bf16(bf(p1[8]) * w1, bf(p1[9]) * w1);
}

__device__ __forceinline__ void afrag(uint32_t (&af)[4], const __nv_bfloat16* t, int ld, int r,
                                      int col) {
  const __nv_bfloat16* p = t + r * ld + col;
  af[0] = tv::ld32(p);
  af[1] = tv::ld32(p + 8 * ld);
  af[2] = tv::ld32(p + 8);
  af[3] = tv::ld32(p + 8 * ld + 8);
}

// Pass 5a. grid (nc * T, G, B), 128 threads, TileSmem::bytes of dynamic smem.
// The block owns rows i of one 64-row tile of chunk c and walks the group's
// heads; warp w owns rows 16w..16w+15. Per head:
//   t_i   = w_out_i dy_i . (C_i h_in^T)                       (the y_off term)
//   dC_i += (w_out_i dy_i) h_in + sum_{j<=i} dCB[i,j] B_j
//   dCB[i,j] = [j <= i, same segment] exp(acs_i - acs_j) dy_i . xdt_j
//   da_i  = sum_j dCB[i,j] CB[i,j] + t_i
__global__ void __launch_bounds__(kThreads) dc_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem sm(smem_raw);
  const int T = a.cs / kTile;
  const int c = blockIdx.x / T, it = blockIdx.x % T, g = blockIdx.y, b = blockIdx.z;
  const int R = a.H / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = it * kTile, pos_i = c * a.cs + i0;
  const int rl = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int sprev = seg_prev(a, b, c);
  load_group_rows(a, a.Cm, sm.own_n, b, g, pos_i);
  if (tid < kTile) sm.own_seg[tid] = seg_at(a, b, pos_i + tid);
  const float* cbm = a.cb + (((size_t)b * a.nc + c) * a.G + g) * a.cs * a.cs;
  const float* cb_rows[2] = {cbm + (size_t)(i0 + rl) * a.cs, cbm + (size_t)(i0 + rl + 8) * a.cs};

  float accC[kN / 8][4] = {};
  for (int hh = 0; hh < R; ++hh) {
    const int h = g * R + hh;
    const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
    __syncthreads();  // the previous head's tiles are no longer read
    load_state(a.states + (((size_t)b * a.nc + c) * a.H + h) * kP * kN, sm.state);
    load_head_rows(a, a.dy, sm.own_p, b, h, pos_i, nullptr);
    if (tid < kTile) {
      const float v = a.acs[hrow + i0 + tid];
      sm.own_acs[tid] = v;
      sm.own_w[tid] = sm.own_seg[tid] == sprev ? expf(v) : 0.f;
    }
    __syncthreads();
    const float w0 = sm.own_w[rl], w1 = sm.own_w[rl + 8];

    // y_off = C_i h_in^T (16 x P per warp), then t_i = w_out_i dy_i . y_off_i
    float tpart[2] = {0.f, 0.f};
    {
      float yo[kP / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kN / 16; ++ks) {
        uint32_t af[4];
        afrag(af, sm.own_n, kLDN, rl, ks * 16 + cq);
#pragma unroll
        for (int nt = 0; nt < kP / 8; ++nt) {
          const __nv_bfloat16* p = sm.state + (nt * 8 + (lane >> 2)) * kLDN + ks * 16 + cq;
          tv::mma_16816(yo[nt], af, tv::ld32(p), tv::ld32(p + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < kP / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int half = q >> 1, p = nt * 8 + cq + (q & 1);
          tpart[half] += bf(sm.own_p[(rl + 8 * half) * kLDP + p]) * yo[nt][q];
        }
    }
    const float t0 = w0 * quad_sum(tpart[0]), t1 = w1 * quad_sum(tpart[1]);

    // dC += (w_out dy) h_in
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk) {
      uint32_t af[4];
      scaled_afrag(af, sm.own_p, kLDP, rl, kk * 16 + cq, w0, w1);
      const __nv_bfloat16* srow = sm.state + (kk * 16 + (lane & 15)) * kLDN;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t b0, b1;
        tv::ldsm_x2_trans(b0, b1, srow + nt * 8);
        tv::mma_16816(accC[nt], af, b0, b1);
      }
    }

    float rowE[2] = {0.f, 0.f};
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile, pos_j = c * a.cs + j0;
      __syncthreads();  // the previous walked tile is no longer read
      if (tid < kTile) {
        sm.walk_acs[tid] = a.acs[hrow + j0 + tid];
        sm.walk_seg[tid] = seg_at(a, b, pos_j + tid);
        sm.own_dtp[tid] = a.dtp[hrow + j0 + tid];  // dtp of the walked rows
      }
      __syncthreads();
      load_head_rows(a, a.x, sm.walk_p, b, h, pos_j, sm.own_dtp);
      load_group_rows(a, a.Bm, sm.walk_n, b, g, pos_j);
      __syncthreads();

      // dM = dy_i . xdt_j (16 x 64 per warp)
      float dm[kTile / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kP / 16; ++ks) {
        uint32_t af[4];
        afrag(af, sm.own_p, kLDP, rl, ks * 16 + cq);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          const __nv_bfloat16* p = sm.walk_p + (nt * 8 + (lane >> 2)) * kLDP + ks * 16 + cq;
          tv::mma_16816(dm[nt], af, tv::ld32(p), tv::ld32(p + 8));
        }
      }
      // dCB = mask * decay * dM; rowE += dCB * CB
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int half = q >> 1, il = rl + 8 * half, jl = nt * 8 + cq + (q & 1);
          const bool ok = j0 + jl <= i0 + il && sm.walk_seg[jl] == sm.own_seg[il];
          const float v = ok ? dm[nt][q] * expf(sm.own_acs[il] - sm.walk_acs[jl]) : 0.f;
          if (ok) rowE[half] += v * cb_rows[half][j0 + jl];
          dm[nt][q] = v;
        }
      // dC += dCB B_j
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t pa[4] = {tv::pack_bf16(dm[2 * kk][0], dm[2 * kk][1]),
                                tv::pack_bf16(dm[2 * kk][2], dm[2 * kk][3]),
                                tv::pack_bf16(dm[2 * kk + 1][0], dm[2 * kk + 1][1]),
                                tv::pack_bf16(dm[2 * kk + 1][2], dm[2 * kk + 1][3])};
        const __nv_bfloat16* brow = sm.walk_n + (kk * 16 + (lane & 15)) * kLDN;
#pragma unroll
        for (int nt = 0; nt < kN / 8; ++nt) {
          uint32_t b0, b1;
          tv::ldsm_x2_trans(b0, b1, brow + nt * 8);
          tv::mma_16816(accC[nt], pa, b0, b1);
        }
      }
    }
    const float e0 = quad_sum(rowE[0]), e1 = quad_sum(rowE[1]);
    if ((lane & 3) == 0) {
      a.da[hrow + i0 + rl] = e0 + t0;
      a.da[hrow + i0 + rl + 8] = e1 + t1;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = pos_i + rl + 8 * half;
    if (pos >= a.L) continue;
    float* out = a.dC + (((size_t)b * a.L + pos) * a.G + g) * kN;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
      *reinterpret_cast<float2*>(out + nt * 8 + cq) =
          make_float2(accC[nt][2 * half], accC[nt][2 * half + 1]);
  }
}

// Pass 5b. grid (nc * T, G, B), 128 threads, TileSmem::bytes of dynamic smem.
// The block owns rows j of one 64-row tile of chunk c and walks the group's
// heads; per head, over the tiles i >= j:
//   dxdt_j = w_st_j (dh_out B_j) + sum_{i>=j} M[i,j] dy_i
//   u_j    = xdt_j . (w_st_j dh_out B_j)
//   dB_j  += (w_st_j xdt_j) dh_out + sum_{i>=j} dCB[i,j] C_i
//   da_j  -= sum_i dCB[i,j] CB[i,j] + u_j
//   dx_j   = dxdt_j dtp_j + D dy_j;  ddt1_j = dxdt_j . x_j
__global__ void __launch_bounds__(kThreads) db_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem sm(smem_raw);
  const int T = a.cs / kTile;
  const int c = blockIdx.x / T, jt = blockIdx.x % T, g = blockIdx.y, b = blockIdx.z;
  const int R = a.H / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = jt * kTile, pos_j = c * a.cs + j0;
  const int rl = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int seg_last = seg_at(a, b, c * a.cs + a.cs - 1);
  load_group_rows(a, a.Bm, sm.own_n, b, g, pos_j);
  if (tid < kTile) sm.own_seg[tid] = seg_at(a, b, pos_j + tid);
  const float* cbm = a.cb + (((size_t)b * a.nc + c) * a.G + g) * a.cs * a.cs;

  float accB[kN / 8][4] = {};
  for (int hh = 0; hh < R; ++hh) {
    const int h = g * R + hh;
    const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
    __syncthreads();
    load_state(a.dstates + (((size_t)b * a.nc + c) * a.H + h) * kP * kN, sm.state);
    if (tid < kTile) {
      const float v = a.acs[hrow + j0 + tid];
      sm.own_acs[tid] = v;
      sm.own_dtp[tid] = a.dtp[hrow + j0 + tid];
      sm.own_w[tid] = sm.own_seg[tid] == seg_last ? expf(a.acs[hrow + a.cs - 1] - v) : 0.f;
    }
    __syncthreads();
    load_head_rows(a, a.x, sm.own_p, b, h, pos_j, sm.own_dtp);
    __syncthreads();
    const float w0 = sm.own_w[rl], w1 = sm.own_w[rl + 8];

    // dxdt = w_st (B_j dh^T) to start; u_j from it
    float accX[kP / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      uint32_t af[4];
      afrag(af, sm.own_n, kLDN, rl, ks * 16 + cq);
#pragma unroll
      for (int nt = 0; nt < kP / 8; ++nt) {
        const __nv_bfloat16* p = sm.state + (nt * 8 + (lane >> 2)) * kLDN + ks * 16 + cq;
        tv::mma_16816(accX[nt], af, tv::ld32(p), tv::ld32(p + 8));
      }
    }
    float upart[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int half = q >> 1, p = nt * 8 + cq + (q & 1);
        accX[nt][q] *= half ? w1 : w0;
        upart[half] += bf(sm.own_p[(rl + 8 * half) * kLDP + p]) * accX[nt][q];
      }
    const float u0 = quad_sum(upart[0]), u1 = quad_sum(upart[1]);

    // dB += (w_st xdt) dh
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk) {
      uint32_t af[4];
      scaled_afrag(af, sm.own_p, kLDP, rl, kk * 16 + cq, w0, w1);
      const __nv_bfloat16* srow = sm.state + (kk * 16 + (lane & 15)) * kLDN;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t b0, b1;
        tv::ldsm_x2_trans(b0, b1, srow + nt * 8);
        tv::mma_16816(accB[nt], af, b0, b1);
      }
    }

    float colE[2] = {0.f, 0.f};
    for (int it = jt; it < T; ++it) {
      const int i0 = it * kTile, pos_i = c * a.cs + i0;
      __syncthreads();
      load_head_rows(a, a.dy, sm.walk_p, b, h, pos_i, nullptr);
      load_group_rows(a, a.Cm, sm.walk_n, b, g, pos_i);
      if (tid < kTile) {
        sm.walk_acs[tid] = a.acs[hrow + i0 + tid];
        sm.walk_seg[tid] = seg_at(a, b, pos_i + tid);
      }
      __syncthreads();

      // dM^T = xdt_j . dy_i (16 x 64 per warp)
      float dm[kTile / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kP / 16; ++ks) {
        uint32_t af[4];
        afrag(af, sm.own_p, kLDP, rl, ks * 16 + cq);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          const __nv_bfloat16* p = sm.walk_p + (nt * 8 + (lane >> 2)) * kLDP + ks * 16 + cq;
          tv::mma_16816(dm[nt], af, tv::ld32(p), tv::ld32(p + 8));
        }
      }
      // M^T and dCB^T, rounded to bf16 pairs in the A layout as they are made
      uint32_t mpk[kTile / 8][2], dpk[kTile / 8][2];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        float mv[4], dv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int half = q >> 1, jl = rl + 8 * half, il = nt * 8 + cq + (q & 1);
          const bool ok = i0 + il >= j0 + jl && sm.walk_seg[il] == sm.own_seg[jl];
          float m = 0.f, d = 0.f;
          if (ok) {
            const float lh = expf(sm.walk_acs[il] - sm.own_acs[jl]);
            const float cbv = cbm[(size_t)(i0 + il) * a.cs + j0 + jl];
            m = cbv * lh;
            d = dm[nt][q] * lh;
            colE[half] += d * cbv;
          }
          mv[q] = m;
          dv[q] = d;
        }
        mpk[nt][0] = tv::pack_bf16(mv[0], mv[1]);
        mpk[nt][1] = tv::pack_bf16(mv[2], mv[3]);
        dpk[nt][0] = tv::pack_bf16(dv[0], dv[1]);
        dpk[nt][1] = tv::pack_bf16(dv[2], dv[3]);
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t ma[4] = {mpk[2 * kk][0], mpk[2 * kk][1], mpk[2 * kk + 1][0],
                                mpk[2 * kk + 1][1]};
        const uint32_t da_[4] = {dpk[2 * kk][0], dpk[2 * kk][1], dpk[2 * kk + 1][0],
                                 dpk[2 * kk + 1][1]};
        const __nv_bfloat16* yrow = sm.walk_p + (kk * 16 + (lane & 15)) * kLDP;
#pragma unroll
        for (int nt = 0; nt < kP / 8; ++nt) {
          uint32_t b0, b1;
          tv::ldsm_x2_trans(b0, b1, yrow + nt * 8);
          tv::mma_16816(accX[nt], ma, b0, b1);
        }
        const __nv_bfloat16* crow = sm.walk_n + (kk * 16 + (lane & 15)) * kLDN;
#pragma unroll
        for (int nt = 0; nt < kN / 8; ++nt) {
          uint32_t b0, b1;
          tv::ldsm_x2_trans(b0, b1, crow + nt * 8);
          tv::mma_16816(accB[nt], da_, b0, b1);
        }
      }
    }
    const float e0 = quad_sum(colE[0]), e1 = quad_sum(colE[1]);

    // this head's dx, ddt1, da and u for rows j
    const float Dh = a.D ? a.D[h] : 0.f;
    float xd[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jl = rl + 8 * half, pos = pos_j + jl;
      if (pos >= a.L) continue;
      const float dtp = sm.own_dtp[jl];
      const size_t row = (((size_t)b * a.L + pos) * a.H + h) * kP;
#pragma unroll
      for (int nt = 0; nt < kP / 8; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int p = nt * 8 + cq + u;
          const float v = accX[nt][2 * half + u];
          xd[half] += v * bf(a.x[row + p]);
          a.dx[row + p] = to_bf(v * dtp + Dh * bf(a.dy[row + p]));
        }
    }
    const float x0 = quad_sum(xd[0]), x1 = quad_sum(xd[1]);
    if ((lane & 3) == 0) {
      a.da[hrow + j0 + rl] -= e0 + u0;
      a.da[hrow + j0 + rl + 8] -= e1 + u1;
      a.ubuf[hrow + j0 + rl] = u0;
      a.ubuf[hrow + j0 + rl + 8] = u1;
      a.ddt1[hrow + j0 + rl] = x0;
      a.ddt1[hrow + j0 + rl + 8] = x1;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = pos_j + rl + 8 * half;
    if (pos >= a.L) continue;
    float* out = a.dB + (((size_t)b * a.L + pos) * a.G + g) * kN;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
      *reinterpret_cast<float2*>(out + nt * 8 + cq) =
          make_float2(accB[nt][2 * half], accB[nt][2 * half + 1]);
  }
}

// Pass 6. grid (nc, H, B), block cs threads: thread t is row t of the chunk.
//   da_last += sum_j u_j + carry * sum_{p,n} dh_out h_in
//   ddA_t = sum_{i >= t} da_i;  ddt_raw_t = (ddt1_t + ddA_t A) sigmoid(dt_raw) [clip]
// and the chunk's partial sums of dA = ddA . dtp, d dt_bias = sum ddt_raw and
// dD = sum dy . x.
__global__ void dtfinal_kernel(BwdArgs a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int pos = c * a.cs + t;
  const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
  const size_t sofs = (((size_t)b * a.nc + c) * a.H + h) * kP * kN;
  float vpart = 0.f;
  for (int e = t; e < kP * kN; e += a.cs) vpart += a.dstates[sofs + e] * a.states[sofs + e];
  const float v = block_sum(vpart) * a.carry[((size_t)b * a.H + h) * a.nc + c];
  const float usum = block_sum(a.ubuf[hrow + t]);
  float da = a.da[hrow + t];
  if (t == a.cs - 1) da += usum + v;
  const float total = block_sum(da);
  const float ddA = total - tv::block_inclusive_scan(da) + da;  // suffix sum
  const float dtp = a.dtp[hrow + t];
  float raw_grad = 0.f, dD = 0.f;
  if (pos < a.L) {
    const size_t row = ((size_t)b * a.L + pos) * a.H + h;
    float r = bf(a.dt[row]);
    if (a.dt_bias) r += a.dt_bias[h];
    raw_grad = (a.ddt1[hrow + t] + ddA * a.A[h]) / (1.f + expf(-r));
    if (a.clamp) {
      const float sp = softplus_f(r);
      if (!(sp > a.dt_lo && sp < a.dt_hi)) raw_grad = 0.f;
    }
    a.ddt[row] = raw_grad;
    for (int p = 0; p < kP; ++p) dD += bf(a.dy[row * kP + p]) * bf(a.x[row * kP + p]);
  }
  const float dA = block_sum(ddA * dtp);
  const float dbias = block_sum(raw_grad);
  const float dDs = block_sum(dD);
  if (t == 0) {
    const size_t o = ((size_t)b * a.nc + c) * a.H + h, plane = (size_t)a.B * a.nc * a.H;
    a.part[o] = dA;
    a.part[plane + o] = dbias;
    a.part[2 * plane + o] = dDs;
  }
}

}  // namespace

extern "C" int tv_ssd_bwd(const void* x, const void* dt, const void* A, const void* dt_bias,
                          const void* D, const void* Bm, const void* Cm, const void* seq,
                          const void* states, const void* dy, const void* dfinal, void* dx,
                          void* ddt, void* dB, void* dC, void* dinit, void* part, void* dtp,
                          void* acs, void* carry, void* cb, void* dstates, void* da, void* ubuf,
                          void* ddt1, int B, int L, int H, int P, int G, int N, int cs, int clamp,
                          float dt_lo, float dt_hi, void* stream) {
  if (P != kP || N != kN || cs % kTile != 0 || cs > 1024 || H % G != 0)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const __nv_bfloat16*>(dt);
  a.A = static_cast<const float*>(A);
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.D = static_cast<const float*>(D);
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.seq = static_cast<const int*>(seq);
  a.states = static_cast<const float*>(states);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.dfinal = static_cast<const float*>(dfinal);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dinit = static_cast<float*>(dinit);
  a.part = static_cast<float*>(part);
  a.dtp = static_cast<float*>(dtp);
  a.acs = static_cast<float*>(acs);
  a.carry = static_cast<float*>(carry);
  a.cb = static_cast<float*>(cb);
  a.dstates = static_cast<float*>(dstates);
  a.da = static_cast<float*>(da);
  a.ubuf = static_cast<float*>(ubuf);
  a.ddt1 = static_cast<float*>(ddt1);
  a.B = B; a.L = L; a.H = H; a.G = G; a.cs = cs;
  a.nc = (L + cs - 1) / cs;
  a.Lp = a.nc * cs;
  a.clamp = clamp; a.dt_lo = dt_lo; a.dt_hi = dt_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = cs / kTile;
  const int smem = (int)TileSmem::bytes;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  dt_kernel<<<dim3(a.nc, H, B), cs, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cb_kernel<<<dim3(a.nc * T * T, G, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  contrib_kernel<<<dim3(a.nc, H, B), kThreads, cs * sizeof(float), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dstate_kernel<<<dim3(kP * kN / kThreads, H, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dc_kernel<<<dim3(a.nc * T, G, B), kThreads, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  db_kernel<<<dim3(a.nc * T, G, B), kThreads, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dtfinal_kernel<<<dim3(a.nc, H, B), cs, 0, s>>>(a);
  return cudaGetLastError();
}
