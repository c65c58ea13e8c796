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
//   2. cb:        C.B^T per (chunk, group), the lower-triangle 64 x 64 tiles,
//                 written twice in the register order in which the dc and db
//                 threads read them (rows i or rows j): value k of thread t
//                 at float4 k * 128 + t, so a warp's load (and store) is 512
//                 contiguous bytes;
//   3. contrib:   what each chunk adds to the cotangent of its inbound state,
//                 sum_i w_out_i dy_i^T C_i (P x N), per (chunk, head);
//   4. dstate:    a reverse walk over the nc chunks, one thread per state
//                 element: dh_in(c) = carry_c dh_out(c) + contrib_c, seeded
//                 with the final-state cotangent. It leaves d initial state,
//                 bf16 copies of dh_out(c) and of the inbound state h_in(c)
//                 for the products of pass 5, and per-block partial sums of
//                 dh_out(c) . h_in(c) for the cumsum cotangent of pass 6;
//   5. dc / db:   the products, one block per (chunk, 64-row tile, group,
//                 slice of the group's heads), below;
//   6. reduce:    where the heads were split over S > 1 slices, dC and dB as
//                 the sum of the slices' partials, slice 0 first;
//   7. dtfinal:   per (chunk, head): the suffix sum of the cumsum cotangent,
//                 ddt_raw (softplus' sigmoid and the dt_limit clip mask, 0 on
//                 the ragged tail), and per-chunk partials of dA, d dt_bias
//                 and dD that the wrapper sums (a tiny torch.sum, as the JAX
//                 wrapper's jnp.sum over its per-program partials).
// Every sum has a fixed order and there are no atomics, so the gradients are
// bitwise repeatable.
//
// What bounds it: about 2.3x the forward's products (dM, M^T dy, dCB B,
// dCB^T C per head and chunk pair, plus the P x N cross terms), 0.10 ms at
// the 9B's L 4,096 on the bf16 tensor cores, against ~0.15 GB of reads and
// writes (0.05 ms). The products are small (64 x 64 x 64 a tile pair and
// head) and wrapped in scalar work: the masked decay tile, an exp a pair and
// head, and the row sums of the cumsum cotangent. The design of pass 5 does
// this about it:
// - A block is two consumer warpgroups that take the slice's heads in turn
//   (heads 0, 2, .. and 1, 3, ..), each with its own ring, 1 block an SM
//   (223 KB of shared memory). Its dC (dc) or dB (db) rows are summed over
//   its heads in registers, then warpgroup 1's sum is added to warpgroup
//   0's through shared memory: a fixed order, no atomics.
// - What the group's heads share is staged once a block: C of the block's
//   own rows and B of every walked tile (dc), B of the own rows and C of
//   every walked tile (db), 16 KB a tile, by 16-byte cp.async.
// - What is per head streams through a ring of 16-byte cp.async: a head
//   slot (the bf16 state h_in or dh_out, the own rows of dy or x, the head's
//   cumsum and dt) and walk slots (x or dy of one walked tile), two of each,
//   so the next unit's copies run under this unit's products. No loads of
//   fewer than 16 bytes.
// - Every 64-row product is one wgmma sequence (attn_sm90.cuh's issue_qk /
//   issue_pv): dM = dy_i x_j^T (64 x 64 x 64), dC += dCB B_j and dB +=
//   dCB^T C_i (64 x 128 x 64, dCB from registers), dxdt += M^T dy_i, the
//   y_off = C_i h_in^T and B_j dh^T products (64 x 64 x 128), and dC +=
//   (w_out dy) h_in, dB += (w_st xdt) dh. Operand tiles lie in shared
//   memory in the 128-byte swizzle that TMA would write and the wgmma
//   descriptors name.
// - The decay tile is ex2 of (acs_i - acs_j) log2(e) per pair, never
//   exp(acs_i) exp(-acs_j), which overflows f32 within a chunk at the 9B's A.
//   dt_j scales dM's columns (dc) or rows (db) in f32 after the product.
// - Parallelism: grid (nc * T, G * S, B); at L 4,096 and S 1, 512 blocks of
//   8 warps in 3.9 waves, the longest walks (dc's last tile row, db's
//   first) launched first; the wrapper raises S (2, 4) where the grid would
//   give fewer than 3 waves (the 1,064-token training rows).
// Segment ids reset the state exactly as the forward and the TPU kernel do:
// cont, keep_last, no_boundary and the previous chunk's last id (clamped at
// chunk 0).
#include "ssd_sm90.cuh"

namespace {

using namespace tv::sm90;
using namespace tv::ssd;
using tv::bf;
using tv::to_bf;

constexpr int kP = 64;
constexpr int kN = 128;
constexpr int kTile = 64;
// tiles a chunk: chunks of at most 256 rows (the wrapper runs a longer chunk
// as 256-row ones)
constexpr int kMaxT = 4;
constexpr int kLDN = kN + 8;
constexpr int kLDP = kP + 8;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

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
  float* cb;                // (B, nc, G, 2, T, T, 8 x 128 x 4): C.B^T tiles in dc's and db's order
  float* dstates;           // (B, nc, H, P, N): the chunks' contributions
  __nv_bfloat16* hin_bf;    // (B, nc, H, P, N): h_in(c) in bf16
  __nv_bfloat16* dh_bf;     // (B, nc, H, P, N): dh_out(c) in bf16
  float* vpart;             // (B, nc, H, P*N/128): partial sums of dh_out . h_in
  float* slices;            // (2, S, B, L, G, N): dC and dB partials per head slice (S > 1)
  float* da;                // (B, H, Lp) cotangent of the cumsum, before the suffix sum
  float* ubuf;              // (B, H, Lp) the u_j term (its chunk sum feeds the last row)
  float* ddt1;              // (B, H, Lp) sum_p dxdt x
  float* dyx;               // (B, H, Lp) sum_p dy x (the rows' terms of dD)
  int B, L, H, G, cs, nc, Lp, S;
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

// The 32 accumulator values thread t (of a warpgroup) holds of a 64 x 64
// tile: rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 k + 2 (t % 4) (+ 1);
// value 4 k + 2 half + e is (row + 8 half, column + e).
__device__ __forceinline__ int frag_row(int t, int idx) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((idx >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int idx) {
  return 8 * (idx >> 2) + 2 * (t & 3) + (idx & 1);
}

// Offset (floats) of the C.B^T tile (it, jt) of (b, c, g) in order o (0:
// dc's, rows i; 1: db's, rows j).
__device__ __forceinline__ size_t cb_tile(const BwdArgs& a, int b, int c, int g, int o, int it,
                                          int jt) {
  const int T = a.cs / kTile;
  return ((((size_t)b * a.nc + c) * a.G + g) * 2 + o) * T * T * 4096 +
         (size_t)(it * T + jt) * 4096;
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
  // the product tile, over Cs once it is read
  float (*tile)[kTile + 1] = reinterpret_cast<float (*)[kTile + 1]>(&Cs[0][0]);
  static_assert(sizeof(float) * kTile * (kTile + 1) <= sizeof(Cs), "the tile fits in Cs");
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
  __syncthreads();  // Cs and Bs are read
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[r0 + 8 * (q >> 1)][nt * 8 + cq + (q & 1)] = acc[nt][q];
  __syncthreads();
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float4* out = reinterpret_cast<float4*>(a.cb + cb_tile(a, b, c, g, o, it, jt)) + tid;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(tid, 4 * k + e), col = frag_col(tid, 4 * k + e);
        v[e] = o == 0 ? tile[r][col] : tile[col][r];
      }
      out[k * kThreads] = make_float4(v[0], v[1], v[2], v[3]);
    }
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
    for (int e = tid; e < kTile * kP / 8; e += kThreads) {
      const int i = e / (kP / 8), p = (e % (kP / 8)) * 8, pos = c * a.cs + i0 + i;
      const uint4 raw = tv::ld_row8(a.dy + (((size_t)b * a.L + pos) * a.H + h) * kP + p,
                                    pos < a.L);
      *reinterpret_cast<uint4*>(&Ys[i][p]) = scale8(raw, w[i0 + i]);
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
// chunks in reverse: dh_out(c) is the carried value, written in bf16 with
// h_in(c) beside it, and its product with h_in(c) summed over the block's
// 128 elements (vpart, block x of P*N/128).
__global__ void __launch_bounds__(kThreads) dstate_kernel(BwdArgs a) {
  constexpr int kUnroll = 8;
  __shared__ float red[kUnroll][kThreads / 32];
  const int e = blockIdx.x * kThreads + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t hstride = (size_t)a.H * kP * kN;
  const size_t own = ((size_t)b * a.H + h) * kP * kN + e;
  float s = a.dfinal ? a.dfinal[own] : 0.f;
  const size_t base = (size_t)b * a.nc * hstride + (size_t)h * kP * kN + e;
  const float* carry = a.carry + ((size_t)b * a.H + h) * a.nc;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= kUnroll) {
    float local[kUnroll], decay[kUnroll], hin[kUnroll], prod[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 - u >= 0) {
        local[u] = a.dstates[base + (c0 - u) * hstride];
        hin[u] = a.states[base + (c0 - u) * hstride];
        decay[u] = carry[c0 - u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      prod[u] = 0.f;
      if (c0 - u >= 0) {
        const size_t o = base + (c0 - u) * hstride;
        a.dh_bf[o] = to_bf(s);
        a.hin_bf[o] = to_bf(hin[u]);
        prod[u] = s * hin[u];
        s = s * decay[u] + local[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v = prod[u];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[u][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < kUnroll && c0 - (int)threadIdx.x >= 0) {
      float v = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) v += red[threadIdx.x][w];
      a.vpart[(((size_t)b * a.nc + c0 - threadIdx.x) * a.H + h) * gridDim.x + blockIdx.x] = v;
    }
    __syncthreads();
  }
  a.dinit[own] = s;
}

// ---- pass 5: the dc and db kernels ----

constexpr int kVec = 256 * 4;      // a head's cumsum or dt over a chunk of <= 256 rows
constexpr int kHeadSlot = kNTile + kBox + 2 * kVec;  // state, own rows, acs, dtp
constexpr int kWGBytes = 2 * kHeadSlot + 2 * kBox;   // two head slots, two walk slots
constexpr int kWalkThreads = 256;  // two consumer warpgroups
constexpr size_t kWalkSmem =
    1024 + (1 + kMaxT) * kNTile + 2 * kWGBytes + 256 * sizeof(int);

// The register A operand (rows ra, ra + 8 of 16 x 64) of a swizzled [64][64]
// box, row r scaled by w[r] in f32 before the bf16 rounding.
__device__ __forceinline__ void scaled_a(uint32_t (&pa)[4][4], const uint8_t* box, int ra,
                                         float w0, float w1) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float2 v0 = ld_sw(box, ra, 16 * kk + cq), v1 = ld_sw(box, ra + 8, 16 * kk + cq);
    const float2 v2 = ld_sw(box, ra, 16 * kk + 8 + cq), v3 = ld_sw(box, ra + 8, 16 * kk + 8 + cq);
    pa[kk][0] = tv::pack_bf16(v0.x * w0, v0.y * w0);
    pa[kk][1] = tv::pack_bf16(v1.x * w1, v1.y * w1);
    pa[kk][2] = tv::pack_bf16(v2.x * w0, v2.y * w0);
    pa[kk][3] = tv::pack_bf16(v3.x * w1, v3.y * w1);
  }
}

// Pass 5. DB false: dc, DB true: db. grid (nc * T, G * S, B), 256 threads,
// kWalkSmem bytes. blockIdx.x = k nc + c: the block's own tile is T-1-k
// (dc) or k (db), so the longest walks start first. Warpgroup wg takes the
// heads wg, wg + 2, .. of the block's slice; for each head a unit of the
// head's data, then one unit per walked tile.
//
// dc, rows i of tile it, walking j <= it; per head:
//   t_i   = w_out_i dy_i . (C_i h_in^T)                       (the y_off term)
//   dC_i += (w_out_i dy_i) h_in + sum_{j<=i} dCB[i,j] B_j
//   dCB[i,j] = [j <= i, same segment] exp(acs_i - acs_j) dt_j (dy_i . x_j)
//   da_i  = sum_j dCB[i,j] CB[i,j] + t_i
// db, rows j of tile jt, walking i from the last tile down to jt; per head:
//   dxdt_j = w_st_j (dh_out B_j) + sum_{i>=j} M[i,j] dy_i,  M = CB exp(acs_i - acs_j) (masked)
//   u_j    = xdt_j . (w_st_j dh_out B_j)
//   dB_j  += (w_st_j xdt_j) dh_out + sum_{i>=j} dCB[i,j] C_i
//   da_j  -= sum_i dCB[i,j] CB[i,j] + u_j
//   dx_j   = dxdt_j dtp_j + D dy_j;  ddt1_j = dxdt_j . x_j;  dyx_j = dy_j . x_j
template <bool DB>
__global__ void __launch_bounds__(kWalkThreads, 1) walk_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* own_n = align1024(smem_raw);       // [64][128] group rows of the own tile
  uint8_t* grp_n = own_n + kNTile;            // [T][64][128] group rows of the walked tiles
  uint8_t* wg_base = grp_n + kMaxT * kNTile;  // per warpgroup: head slots, walk slots
  int* seg = reinterpret_cast<int*>(wg_base + 2 * kWGBytes);  // [cs] the chunk's ids

  const int T = a.cs / kTile, R = a.H / a.G, Rs = R / a.S;
  const int c = blockIdx.x % a.nc, k = blockIdx.x / a.nc;
  const int own = DB ? k : T - 1 - k;
  const int g = blockIdx.y / a.S, sl = blockIdx.y % a.S, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int lane = tid & 31, ra = 16 * (tw >> 5) + (lane >> 2), cq = (lane & 3) * 2;
  const int pos0 = c * a.cs, pos_own = pos0 + own * kTile;
  const int first = DB ? own : 0, last = DB ? T - 1 : own;  // walked tiles
  const int nwalk = last - first + 1;
  const __nv_bfloat16* own_src = DB ? a.Bm : a.Cm;
  const __nv_bfloat16* walk_src = DB ? a.Cm : a.Bm;
  const size_t gld = (size_t)a.G * kN;
  const size_t grow = ((size_t)b * a.L + pos0) * a.G + g;  // row pos0 of group g

  // the group's rows, once a block
  load_tile<kN, kWalkThreads>(own_n, own_src + (grow + (size_t)own * kTile * a.G) * kN, gld,
                              a.L - pos_own, tid, own_src);
  for (int t = first; t <= last; ++t)
    load_tile<kN, kWalkThreads>(grp_n + t * kNTile,
                                walk_src + (grow + (size_t)t * kTile * a.G) * kN, gld,
                                a.L - pos0 - t * kTile, tid, walk_src);
  for (int t = tid; t < a.cs; t += kWalkThreads) seg[t] = seg_at(a, b, pos0 + t);

  uint8_t* mine = wg_base + wg * kWGBytes;
  const int nheads = (Rs - wg + 1) / 2;  // heads wg, wg + 2, .. of the slice
  const int units = nheads * (1 + nwalk);
  const __nv_bfloat16* hx = DB ? a.x : a.dy;     // own rows of the head: x (db), dy (dc)
  const __nv_bfloat16* wx = DB ? a.dy : a.x;     // walked rows: dy (db), x (dc)
  const __nv_bfloat16* st_src = DB ? a.dh_bf : a.hin_bf;
  const size_t hld = (size_t)a.H * kP;

  auto head_of = [&](int hk) { return g * R + sl * Rs + wg + 2 * hk; };
  auto head_slot = [&](int hk) { return mine + (hk & 1) * kHeadSlot; };
  // the walked tile of step q of a head: dc j = q, db i from the last tile down
  auto walk_tile = [&](int q) { return DB ? last - q : q; };
  auto issue = [&](int u) {
    const int hk = u / (1 + nwalk), q = u % (1 + nwalk) - 1, h = head_of(hk);
    if (q < 0) {
      uint8_t* hs = head_slot(hk);
      load_tile<kN, 128>(hs, st_src + (((size_t)b * a.nc + c) * a.H + h) * kP * kN, kN, kP, tw,
                         st_src);
      load_tile<kP, 128>(hs + kNTile, hx + (((size_t)b * a.L + pos_own) * a.H + h) * kP, hld,
                         a.L - pos_own, tw, hx);
      const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)pos0;
      load_vec(reinterpret_cast<float*>(hs + kNTile + kBox), a.acs + hrow, a.cs, tw);
      load_vec(reinterpret_cast<float*>(hs + kNTile + kBox + kVec), a.dtp + hrow, a.cs, tw);
    } else {
      const int t = walk_tile(q), w0 = pos0 + t * kTile;
      load_tile<kP, 128>(mine + 2 * kHeadSlot + ((hk * nwalk + q) & 1) * kBox,
                         wx + (((size_t)b * a.L + w0) * a.H + h) * kP, hld, a.L - w0, tw, wx);
    }
    cp_commit();
  };

  if (units > 0) issue(0);
  cp_wait_all();
  __syncthreads();

  float acc[64];  // dC (dc) or dB (db) rows of the own tile, this warpgroup's heads
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int seg_r[2] = {seg[own * kTile + ra], seg[own * kTile + ra + 8]};
  const int seg_ref = DB ? seg_at(a, b, pos0 + a.cs - 1) : seg_prev(a, b, c);
  const uint32_t own_addr = smem_u32(own_n);
  // per head, carried across its units
  float acs_r[2], dtp_r[2], wrow[2], part[2], tu[2];
  float ax[32];  // db: dxdt of the own rows

  for (int u = 0; u < units; ++u) {
    if (u > 0) {
      cp_wait_all();
      wg_bar(wg);
    }
    if (u + 1 < units) issue(u + 1);
    const int hk = u / (1 + nwalk), q = u % (1 + nwalk) - 1, h = head_of(hk);
    uint8_t* hs = head_slot(hk);
    const uint32_t st_addr = smem_u32(hs), hx_addr = smem_u32(hs + kNTile);
    const float* acs = reinterpret_cast<const float*>(hs + kNTile + kBox);
    const float* dtp = acs + kVec / 4;
    if (q < 0) {
      // ---- the head's unit ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = own * kTile + ra + 8 * r;
        acs_r[r] = acs[i];
        dtp_r[r] = dtp[i];
        wrow[r] = seg_r[r] == seg_ref ? expf(DB ? acs[a.cs - 1] - acs[i] : acs[i]) : 0.f;
        part[r] = 0.f;
      }
      float yo[32];
      // dc: y_off = C_i h_in^T; db: B_j dh^T
      issue_qk<kN, 64, 64, 64>(yo, own_addr, st_addr);
      uint32_t pa[4][4];
      // dc: (w_out dy_i); db: (w_st dt_j x_j)
      scaled_a(pa, hs + kNTile, ra, DB ? wrow[0] * dtp_r[0] : wrow[0],
               DB ? wrow[1] * dtp_r[1] : wrow[1]);
      issue_pv<kN, 64, 64, 64>(acc, pa, st_addr);  // dC += (w_out dy) h_in; dB += (w_st xdt) dh
      wg_wait<1>();
      pin(yo);
      float tp[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = ld_sw(hs + kNTile, ra + 8 * r, 8 * j + cq);
          if (DB) {
            yo[4 * j + 2 * r] *= wrow[r];
            yo[4 * j + 2 * r + 1] *= wrow[r];
            tp[r] += (v.x * yo[4 * j + 2 * r] + v.y * yo[4 * j + 2 * r + 1]) * dtp_r[r];
          } else {
            tp[r] += v.x * yo[4 * j + 2 * r] + v.y * yo[4 * j + 2 * r + 1];
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) tu[r] = DB ? quad_sum(tp[r]) : wrow[r] * quad_sum(tp[r]);
      if (DB) {
#pragma unroll
        for (int i = 0; i < 32; ++i) ax[i] = yo[i];
      }
      wg_wait<0>();
      pin(acc);
      pin(pa);
      continue;
    }
    // ---- a walked tile ----
    const int t = walk_tile(q);
    const uint32_t w_addr = smem_u32(mine + 2 * kHeadSlot + ((hk * nwalk + q) & 1) * kBox);
    const int it = DB ? t : own, jt = DB ? own : t;
    float s[32];
    // dc: dM = dy_i x_j^T (rows i); db: dM^T = x_j dy_i^T (rows j)
    issue_qk<kP, 64, 64, 64>(s, hx_addr, w_addr);
    float cbv[32];
    {
      const float4* src =
          reinterpret_cast<const float4*>(a.cb + cb_tile(a, b, c, g, DB ? 1 : 0, it, jt)) + tw;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float4 v = __ldg(src + e * kThreads);
        cbv[4 * e] = v.x;
        cbv[4 * e + 1] = v.y;
        cbv[4 * e + 2] = v.z;
        cbv[4 * e + 3] = v.w;
      }
    }
    wg_wait<0>();
    pin(s);
    uint32_t pm[4][4], pd[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = t * kTile + 8 * j + cq;  // chunk row of the thread's columns
      const float2 ac = *reinterpret_cast<const float2*>(acs + col);
      const float2 dc = *reinterpret_cast<const float2*>(dtp + col);
      const int2 sc = *reinterpret_cast<const int2*>(seg + col);
      float mv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, idx = 4 * j + e;
        const float acol = (e & 1) ? ac.y : ac.x;
        const int scol = (e & 1) ? sc.y : sc.x;
        const int rowp = own * kTile + ra + 8 * r, colp = col + (e & 1);
        // dc: rows i, columns j; db: rows j, columns i
        const bool ok = (DB ? colp >= rowp : colp <= rowp) && scol == seg_r[r];
        const float l =
            ok ? ex2((DB ? acol - acs_r[r] : acs_r[r] - acol) * kLog2e) : 0.f;
        const float d = s[idx] * (DB ? dtp_r[r] : ((e & 1) ? dc.y : dc.x)) * l;
        part[r] += d * cbv[idx];
        dv[e] = d;
        mv[e] = cbv[idx] * l;
      }
      pd[j >> 1][(j & 1) * 2] = tv::pack_bf16(dv[0], dv[1]);
      pd[j >> 1][(j & 1) * 2 + 1] = tv::pack_bf16(dv[2], dv[3]);
      pm[j >> 1][(j & 1) * 2] = tv::pack_bf16(mv[0], mv[1]);
      pm[j >> 1][(j & 1) * 2 + 1] = tv::pack_bf16(mv[2], mv[3]);
    }
    // dc: dC += dCB B_j; db: dB += dCB^T C_i
    issue_pv<kN, 64, 64, 64>(acc, pd, smem_u32(grp_n + t * kNTile));
    if (DB) issue_pv<kP, 64, 64, 64>(ax, pm, w_addr);  // dxdt += M^T dy_i
    wg_wait<0>();
    pin(acc);
    if (DB) pin(ax);
    pin(pd);
    if (DB) pin(pm);
    if (q < nwalk - 1) continue;
    // ---- the head's last walked tile: its per-row results ----
    const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)pos_own;
    float e2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) e2[r] = quad_sum(part[r]);
    if (!DB) {
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) a.da[hrow + ra + 8 * r] = e2[r] + tu[r];
      }
      continue;
    }
    // db: the walk slot holds dy of the own rows (the diagonal tile comes last)
    const uint8_t* dy_own = mine + 2 * kHeadSlot + ((hk * nwalk + q) & 1) * kBox;
    const float Dh = a.D ? a.D[h] : 0.f;
    float xd[2] = {0.f, 0.f}, yx[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = pos_own + ra + 8 * r;
      __nv_bfloat16* dxrow = a.dx + (((size_t)b * a.L + pos) * a.H + h) * kP;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 xv = ld_sw(hs + kNTile, ra + 8 * r, 8 * j + cq);
        const float2 yv = ld_sw(dy_own, ra + 8 * r, 8 * j + cq);
        const float v0 = ax[4 * j + 2 * r], v1 = ax[4 * j + 2 * r + 1];
        xd[r] += v0 * xv.x + v1 * xv.y;
        yx[r] += yv.x * xv.x + yv.y * xv.y;
        if (pos < a.L)
          *reinterpret_cast<__nv_bfloat162*>(dxrow + 8 * j + cq) = __floats2bfloat162_rn(
              v0 * dtp_r[r] + Dh * yv.x, v1 * dtp_r[r] + Dh * yv.y);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xd[r] = quad_sum(xd[r]);
      yx[r] = quad_sum(yx[r]);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t o = hrow + ra + 8 * r;
        a.da[o] -= e2[r] + tu[r];
        a.ubuf[o] = tu[r];
        a.ddt1[o] = xd[r];
        a.dyx[o] = yx[r];
      }
    }
  }

  // warpgroup 1's sum into warpgroup 0's, then the rows out (a slice's
  // partial where S > 1)
  __syncthreads();
  float4* xch = reinterpret_cast<float4*>(wg_base);  // [16][128] float4
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      xch[e * 128 + tw] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float4 v = xch[e * 128 + tw];
    acc[4 * e] += v.x;
    acc[4 * e + 1] += v.y;
    acc[4 * e + 2] += v.z;
    acc[4 * e + 3] += v.w;
  }
  float* out = a.S > 1 ? a.slices + ((size_t)(DB ? a.S : 0) + sl) * a.B * a.L * a.G * kN
                       : (DB ? a.dB : a.dC);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = pos_own + ra + 8 * r;
    if (pos >= a.L) continue;
    float* row = out + (((size_t)b * a.L + pos) * a.G + g) * kN;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + cq) = make_float2(acc[4 * j + 2 * r],
                                                                 acc[4 * j + 2 * r + 1]);
  }
}

// Pass 6 (S > 1). grid (ceil(n / 4 / 128), 2), 128 threads: dC (y 0) or dB
// (y 1) = the slices' partials summed, slice 0 first; n = B L G N.
__global__ void __launch_bounds__(kThreads) reduce_kernel(BwdArgs a) {
  const size_t n = (size_t)a.B * a.L * a.G * kN;
  const size_t e = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= n) return;
  const float* src = a.slices + (size_t)blockIdx.y * a.S * n + e;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < a.S; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(src + k * n);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>((blockIdx.y ? a.dB : a.dC) + e) = s;
}

// Pass 7. grid (nc, H, B), block cs threads: thread t is row t of the chunk.
//   da_last += sum_j u_j + carry * sum_{p,n} dh_out h_in
//   ddA_t = sum_{i >= t} da_i;  ddt_raw_t = (ddt1_t + ddA_t A) sigmoid(dt_raw) [clip]
// and the chunk's partial sums of dA = ddA . dtp, d dt_bias = sum ddt_raw and
// dD = sum dy . x (its rows' terms from db).
__global__ void dtfinal_kernel(BwdArgs a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int pos = c * a.cs + t;
  const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
  constexpr int kParts = kP * kN / kThreads;
  const float* vp = a.vpart + (((size_t)b * a.nc + c) * a.H + h) * kParts;
  const float v = block_sum(t < kParts ? vp[t] : 0.f) * a.carry[((size_t)b * a.H + h) * a.nc + c];
  const float usum = block_sum(a.ubuf[hrow + t]);
  float da = a.da[hrow + t];
  if (t == a.cs - 1) da += usum + v;
  const float total = block_sum(da);
  const float ddA = total - tv::block_inclusive_scan(da) + da;  // suffix sum
  const float dtp = a.dtp[hrow + t];
  float raw_grad = 0.f;
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
  }
  const float dA = block_sum(ddA * dtp);
  const float dbias = block_sum(raw_grad);
  const float dDs = block_sum(a.dyx[hrow + t]);  // 0 on the ragged tail (x reads 0 there)
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
                          void* acs, void* carry, void* cb, void* dstates, void* hin_bf,
                          void* dh_bf, void* vpart, void* slices, void* da, void* ubuf,
                          void* ddt1, void* dyx, int B, int L, int H, int P, int G, int N,
                          int cs, int S,
                          int clamp, float dt_lo, float dt_hi, void* stream) {
  if (P != kP || N != kN || cs % kTile != 0 || cs > kMaxT * kTile || H % G != 0 || S < 1 ||
      (H / G) % S != 0 || (S > 1 && slices == nullptr))
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
  a.hin_bf = static_cast<__nv_bfloat16*>(hin_bf);
  a.dh_bf = static_cast<__nv_bfloat16*>(dh_bf);
  a.vpart = static_cast<float*>(vpart);
  a.slices = static_cast<float*>(slices);
  a.da = static_cast<float*>(da);
  a.ubuf = static_cast<float*>(ubuf);
  a.ddt1 = static_cast<float*>(ddt1);
  a.dyx = static_cast<float*>(dyx);
  a.B = B; a.L = L; a.H = H; a.G = G; a.cs = cs; a.S = S;
  a.nc = (L + cs - 1) / cs;
  a.Lp = a.nc * cs;
  a.clamp = clamp; a.dt_lo = dt_lo; a.dt_hi = dt_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = cs / kTile;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(walk_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kWalkSmem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kWalkSmem)) != cudaSuccess)
    return err;
  dt_kernel<<<dim3(a.nc, H, B), cs, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cb_kernel<<<dim3(a.nc * T * T, G, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  contrib_kernel<<<dim3(a.nc, H, B), kThreads, cs * sizeof(float), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dstate_kernel<<<dim3(kP * kN / kThreads, H, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  walk_kernel<false><<<dim3(a.nc * T, G * S, B), kWalkThreads, kWalkSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  walk_kernel<true><<<dim3(a.nc * T, G * S, B), kWalkThreads, kWalkSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (S > 1) {
    const size_t n4 = (size_t)B * L * G * kN / 4;
    reduce_kernel<<<dim3((unsigned)((n4 + kThreads - 1) / kThreads), 2), kThreads, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dtfinal_kernel<<<dim3(a.nc, H, B), cs, 0, s>>>(a);
  return cudaGetLastError();
}

// Dynamic shared memory of a dc / db block, for the build log.
extern "C" int tv_ssd_bwd_smem() { return (int)kWalkSmem; }
