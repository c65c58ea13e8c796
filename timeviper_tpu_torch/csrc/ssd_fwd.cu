// Mamba-2 SSD chunked-scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel timeviper_tpu/ops/ssd_pallas.py:_ssd_kernel (driven
// by _ssd_pallas_fwd, reached through ssd_auto from models/nano.py).
//
// What bounds it on the H100 is first parallelism: the TPU grid walks the
// chunks of one (batch, group) in order and carries the state in VMEM, which
// at batch 1 and 8 groups is 8 programs for 132 SMs. Here the work is split
// into passes that run in parallel over chunks, so every pass but the short
// state pass fills the card:
//   1. dt_cumsum:   dt = softplus(dt + dt_bias) clamped to dt_limit (0 on the
//                   ragged tail), the chunk-local cumsum of dt*A, and the
//                   factor that carries the state across the chunk;
//   2. chunk_cb:    C.B^T once per (chunk, group), shared by the group's heads;
//   3. chunk_state: what each chunk adds to the state at its end;
//   4. state_pass:  a sequential walk over the nc = L/cs chunks per (b, h,
//                   state element), turning chunk states into inbound states;
//   5. chunk_scan:  intra-chunk (C.B^T * decay) . (x*dt), plus C . state_in,
//                   plus D*x.
// The three products (about 60 GFLOP a layer at L = 8192) run on the bf16
// tensor cores (mma.sync m16n8k16, ldmatrix), with bf16 operands and f32 sums
// as in the TPU kernel; the decay weights, the cumsum and the carried state
// are f32. What bounds it then is the scalar work around the products
// (building the masked decay matrix element by element; the x*dt tiles are
// built eight channels at a time from 16-byte loads), not the products and
// not the ~0.5 GB of f32 scratch traffic a layer. Head h reads group
// h / (H/G). seq_idx resets the state inside a chunk and at chunk boundaries,
// exactly as the TPU kernel does. x, dt, B and C may be column slices of one
// wider in-projection output: their rows are `sx`, `sdt`, `sbc` apart.
//
// K5 is the same five passes after a conv stage: it replaces the `fuse_conv`
// mode of the same TPU kernel (timeviper_tpu/ops/ssd_pallas.py:_ssd_kernel
// via ssd_conv_scan_fused :981), which carries a halo of 3 raw rows across
// its in-order chunk walk. Here the passes read x, B and C many times over
// (chunk_scan reads x 2.5 times a row on average at 4 tiles a chunk, B and C
// are read once per head of a group), so a loader that convolved what it
// read would convolve each raw element 3.5 (x) to 18.5 (B, C) times. Instead
// conv_kernel convolves every raw element exactly once into bf16 scratch
// that the wrapper allocates, and the five passes read that. What bounds
// the conv stage is bytes: the raw streams read once (plus a 3-row halo per
// 32 rows, from L2) and the convolved ones written once, 20,480 bf16 a token
// of the 9B, ~0.05 ms at L 4,096 against 3.35 TB/s; the convolved B and C
// (17 MB) stay in the 50 MB L2 for the passes. Next to the bytes it runs an
// exp and a division a channel (SiLU), so it keeps many loads in flight: a
// thread owns 8 channels of one stream (16-byte loads and stores, a warp 512
// contiguous bytes of a row) and walks 32 rows, loading the next 4 rows
// while it convolves these, with the 3 raw rows before each held in
// registers (96 registers, 5 blocks an SM: batches of 8 rows took 128 and
// ran 23% slower); the tile's segment ids sit in shared memory, read from
// device memory once. Taps, bias and SiLU run in f32 in the TPU kernel's
// order (ssd_pallas.py:155-183) and the result is rounded to bf16, as the
// TPU kernel does; a tap before row 0 or in another segment than the row's
// reads zero (_tap_mask, :137-147).
#include "common.cuh"

namespace {

using tv::bf;
using tv::to_bf;

constexpr int kP = 64;      // mamba head dim this kernel takes
constexpr int kN = 128;     // state size this kernel takes
constexpr int kTile = 64;   // chunk rows of one shared-memory tile
constexpr int kLDN = kN + 8;  // bf16 row strides of the [.][N] and [.][P] tiles:
constexpr int kLDP = kP + 8;  // 16-byte rows on distinct banks for ldmatrix
constexpr int kThreads = 128;  // four warps

struct SsdArgs {
  const __nv_bfloat16* x;   // (B, L, H, P)
  const __nv_bfloat16* dt;  // (B, L, H) raw
  const float* A;           // (H,)
  const float* dt_bias;     // (H,) or null
  const float* D;           // (H,) or null
  const __nv_bfloat16* Bm;  // (B, L, G, N)
  const __nv_bfloat16* Cm;  // (B, L, G, N)
  const int* seq;           // (B, L) or null
  const float* init;        // (B, H, P, N) or null
  __nv_bfloat16* y;         // (B, L, H, P)
  float* final_state;       // (B, H, P, N)
  float* dtp;               // (B, H, Lp) processed dt
  float* acs;               // (B, H, Lp) chunk-local cumsum of dt*A
  float* carry;             // (B, H, nc) state decay across each chunk, 0 at a boundary
  float* states;            // (B, nc, H, P, N) chunk states, then inbound states
  float* cb;                // (B, nc, G, cs, cs)
  int B, L, H, G, cs, nc, Lp;
  // row strides (elements) of x, dt and B/C between positions: the streams
  // may be column slices of one in-projection output (its fused leaf)
  int sx, sdt, sbc;
  int clamp;
  float dt_lo, dt_hi;
};

// Segment id at position t; the ragged tail repeats the last real id.
__device__ __forceinline__ int seg_at(const SsdArgs& a, int b, int t) {
  if (a.seq == nullptr) return 0;
  if (t >= a.L) t = a.L - 1;
  return a.seq[(size_t)b * a.L + t];
}

// Segment id the state carried INTO chunk c belongs to (chunk 0: its own first).
__device__ __forceinline__ int seg_prev(const SsdArgs& a, int b, int c) {
  return c == 0 ? seg_at(a, b, 0) : seg_at(a, b, c * a.cs - 1);
}

// v[i] * scale rounded to bf16, eight of them in one 16-byte word.
__device__ __forceinline__ uint4 pack8(const float (&v)[8], float scale) {
  return make_uint4(tv::pack_bf16(v[0] * scale, v[1] * scale),
                    tv::pack_bf16(v[2] * scale, v[3] * scale),
                    tv::pack_bf16(v[4] * scale, v[5] * scale),
                    tv::pack_bf16(v[6] * scale, v[7] * scale));
}

// Eight channels p0..p0+7 of x at row pos of head h; zero past the end.
__device__ __forceinline__ void x_row8(const SsdArgs& a, int b, int pos, int h, int p0,
                                       float (&v)[8]) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (pos < a.L)
    raw = *reinterpret_cast<const uint4*>(a.x + ((size_t)b * a.L + pos) * a.sx + h * kP + p0);
  const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = bf(r[i]);
}

// Eight channels n..n+7 of B or C (`m`) at row pos of group g; zero past the end.
__device__ __forceinline__ uint4 bc_row8(const SsdArgs& a, const __nv_bfloat16* m, int b,
                                         int pos, int g, int n) {
  if (pos >= a.L) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(m + ((size_t)b * a.L + pos) * a.sbc + g * kN + n);
}

// K5's conv stage. One raw stream (x, B or C) of `ch` channels, rows `ld`
// elements apart, into a contiguous (B, L, ch) bf16 stream.
struct ConvStream {
  const __nv_bfloat16* raw;
  __nv_bfloat16* out;
  const float* w;     // (ch, 4) taps
  const float* bias;  // (ch,) or null
  int ch, ld;
};

struct ConvArgs {
  ConvStream s[3];  // x, B, C
  const int* seq;   // (B, L) or null
  int L;
  int blocks0, blocks1;  // channel blocks of x, and of x and B together
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

constexpr int kConvRows = 32;  // rows a conv block walks
constexpr int kConvBatch = 4;  // rows loaded together, the next batch under this one's math

// One row of 8 channels: SiLU(raw w[3] + sum_j (tap j on ? win[3 - j] : 0)
// w[3 - j] + bias), tap j = 0 first and each later tap one fused
// multiply-add, as written out (not left to the compiler's contraction);
// rounded to bf16 into dst.
__device__ __forceinline__ void conv_row(uint4 raw, const float (&win)[3][8],
                                         const float4 (*w_s)[kThreads],
                                         const float (*b_s)[kThreads], bool on1, bool on2,
                                         bool on3, __nv_bfloat16* dst) {
  const int tid = threadIdx.x;
  const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 w4 = w_s[i][tid];
    float o = __fmul_rn(bf(v0[i]), w4.w);
    o = __fmaf_rn(on1 ? win[2][i] : 0.f, w4.z, o);
    o = __fmaf_rn(on2 ? win[1][i] : 0.f, w4.y, o);
    o = __fmaf_rn(on3 ? win[0][i] : 0.f, w4.x, o);
    out[i] = silu(o + b_s[i][tid]);
  }
  *reinterpret_cast<uint4*>(dst) = pack8(out, 1.f);
}

// The window moves down one row: raw becomes row pos - 1.
__device__ __forceinline__ void shift_in(float (&win)[3][8], uint4 raw) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    win[0][i] = win[1][i];
    win[1][i] = win[2][i];
    win[2][i] = bf(reinterpret_cast<const __nv_bfloat16*>(&raw)[i]);
  }
}

// grid (ceil(L / 32), channel blocks of all three streams, B), 128 threads:
// thread t of a block owns channels 8 t .. 8 t + 7 of its stream's block and
// walks its rows (conv_row); a tap before row 0 or in another segment reads
// zero. A batch of rows whose taps all lie in their own segment, the common
// case, runs without the masks.
__global__ void __launch_bounds__(kThreads) conv_kernel(const __grid_constant__ ConvArgs a) {
  __shared__ int seg[kConvRows + 3];
  // each thread's taps and biases, [channel][thread]: in shared memory
  // rather than 40 registers, for more blocks an SM
  __shared__ float4 w_s[8][kThreads];
  __shared__ float b_s[8][kThreads];
  const int r0 = blockIdx.x * kConvRows, b = blockIdx.z;
  const int by = blockIdx.y;
  const int si = by < a.blocks0 ? 0 : (by < a.blocks1 ? 1 : 2);
  const ConvStream& st = a.s[si];
  const int ch0 = ((by - (si == 0 ? 0 : (si == 1 ? a.blocks0 : a.blocks1))) * kThreads +
                   threadIdx.x) * 8;
  for (int t = threadIdx.x; t < kConvRows + 3; t += kThreads) {
    int pos = min(max(r0 - 3 + t, 0), a.L - 1);
    seg[t] = a.seq ? a.seq[(size_t)b * a.L + pos] : 0;
  }
  const int tid = threadIdx.x;
  if (ch0 < st.ch) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w_s[i][tid] = reinterpret_cast<const float4*>(st.w)[ch0 + i];
      b_s[i][tid] = st.bias ? st.bias[ch0 + i] : 0.f;
    }
  }
  __syncthreads();
  if (ch0 >= st.ch) return;
  const __nv_bfloat16* col = st.raw + (size_t)b * a.L * st.ld + ch0;
  __nv_bfloat16* dst = st.out + (size_t)b * a.L * st.ch + ch0;
  const int rows = min(kConvRows, a.L - r0);
  auto load = [&](int q) {
    return q < rows ? *reinterpret_cast<const uint4*>(col + (size_t)(r0 + q) * st.ld)
                    : make_uint4(0u, 0u, 0u, 0u);
  };
  // win[k]: raw row pos - 3 + k for the next row pos, in f32
  float win[3][8];
  uint4 cur[kConvBatch], nxt[kConvBatch];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 raw = r0 - 3 + k >= 0
                          ? *reinterpret_cast<const uint4*>(col + (size_t)(r0 - 3 + k) * st.ld)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < 8; ++i) win[k][i] = bf(reinterpret_cast<const __nv_bfloat16*>(&raw)[i]);
  }
#pragma unroll
  for (int u = 0; u < kConvBatch; ++u) cur[u] = load(u);
  // a loop over the batches, not unrolled: one batch's code already holds 32
  // exps and divisions
#pragma unroll 1
  for (int q0 = 0; q0 < rows; q0 += kConvBatch) {
#pragma unroll
    for (int u = 0; u < kConvBatch; ++u) nxt[u] = load(q0 + kConvBatch + u);
    // every tap of the batch's rows in the rows' own segment (the common
    // case: no masks), uniform over the block
    bool whole = r0 + q0 >= 3;
    for (int q = q0; q < q0 + kConvBatch + 3 && q < rows + 3; ++q)
      whole = whole && seg[q] == seg[q0];
    if (whole) {
#pragma unroll
      for (int u = 0; u < kConvBatch; ++u) {
        const int q = q0 + u;
        if (q < rows) conv_row(cur[u], win, w_s, b_s, true, true, true,
                               dst + (size_t)(r0 + q) * st.ch);
        shift_in(win, cur[u]);
      }
    } else {  // one row's code in a loop, its raw row again from the cache
#pragma unroll 1
      for (int u = 0; u < kConvBatch; ++u) {
        const int q = q0 + u, pos = r0 + q, s = seg[q + 3];
        const uint4 raw = load(q);
        if (q < rows)
          conv_row(raw, win, w_s, b_s, pos >= 1 && seg[q + 2] == s,
                   pos >= 2 && seg[q + 1] == s, pos >= 3 && seg[q] == s,
                   dst + (size_t)pos * st.ch);
        shift_in(win, raw);
      }
    }
#pragma unroll
    for (int u = 0; u < kConvBatch; ++u) cur[u] = nxt[u];
  }
}

// Pass 1. grid (nc, H, B), block cs threads.
__global__ void dt_cumsum_kernel(SsdArgs a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int pos = c * a.cs + t;
  float d = 0.f;
  if (pos < a.L) {
    d = bf(a.dt[((size_t)b * a.L + pos) * a.sdt + h]);
    if (a.dt_bias) d += a.dt_bias[h];
    d = d > 20.f ? d : log1pf(expf(d));  // softplus
    if (a.clamp) d = fminf(fmaxf(d, a.dt_lo), a.dt_hi);
  }
  const float v = tv::block_inclusive_scan(d * a.A[h]);
  const size_t o = ((size_t)b * a.H + h) * a.Lp + pos;
  a.dtp[o] = d;
  a.acs[o] = v;
  if (t == a.cs - 1) {  // v is the chunk's total: the carried state's decay
    const int first = seg_at(a, b, c * a.cs), last = seg_at(a, b, pos);
    const bool keep = first == last && first == seg_prev(a, b, c);
    a.carry[((size_t)b * a.H + h) * a.nc + c] = keep ? expf(v) : 0.f;
  }
}

// Pass 2. grid (nc * T * T, G, B) with T = cs / 64, 128 threads; blocks above
// the diagonal (j tile > i tile) exit at once, chunk_scan never reads them.
// CB[i, j] = C_i . B_j for a 64 x 64 tile on the tensor cores; warp w owns
// rows 16w..16w+15.
__global__ void __launch_bounds__(kThreads) chunk_cb_kernel(SsdArgs a) {
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
    *reinterpret_cast<uint4*>(&Cs[r][n]) = bc_row8(a, a.Cm, b, pi, g, n);
    *reinterpret_cast<uint4*>(&Bs[r][n]) = bc_row8(a, a.Bm, b, pj, g, n);
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

// Pass 3. grid (nc, H, B), 128 threads. states[b,c,h,p,n] = sum_j w_j x[j,p]
// B[j,n] with w_j = dt_j exp(acs_last - acs_j), kept only for rows of the
// chunk's last segment (earlier segments never reach the chunk's end state).
// A 64 x 128 product over the chunk's rows on the tensor cores: the operands
// (x * w and B, both [j][...] in shared memory) are read transposed by
// ldmatrix; warp w owns p rows 16w..16w+15.
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(SsdArgs a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  extern __shared__ float w[];  // cs weights
  __shared__ __align__(16) __nv_bfloat16 Xs[kTile][kLDP];  // x * w, [j][p]
  __shared__ __align__(16) __nv_bfloat16 Bs[kTile][kLDN];  // B, [j][n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
  const float acs_last = a.acs[hrow + a.cs - 1];
  const int seg_last = seg_at(a, b, c * a.cs + a.cs - 1);
  for (int t = tid; t < a.cs; t += kThreads) {
    const bool keep = seg_at(a, b, c * a.cs + t) == seg_last;
    w[t] = keep ? a.dtp[hrow + t] * expf(acs_last - a.acs[hrow + t]) : 0.f;
  }
  float acc[kN / 8][4] = {};
  for (int j0 = 0; j0 < a.cs; j0 += kTile) {
    __syncthreads();  // w is written / the previous tiles are no longer read
    for (int e = tid; e < kTile * kP / 8; e += kThreads) {
      const int j = e / (kP / 8), p0 = (e % (kP / 8)) * 8;
      float xv[8];
      x_row8(a, b, c * a.cs + j0 + j, h, p0, xv);
      *reinterpret_cast<uint4*>(&Xs[j][p0]) = pack8(xv, w[j0 + j]);
    }
    for (int e = tid; e < kTile * kN / 8; e += kThreads) {
      const int j = e / (kN / 8), n = (e % (kN / 8)) * 8, pos = c * a.cs + j0 + j;
      *reinterpret_cast<uint4*>(&Bs[j][n]) = bc_row8(a, a.Bm, b, pos, g, n);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      tv::ldsm_x4_trans(af, &Xs[kk * 16 + (lane & 7) + 8 * (lane >> 4)]
                               [warp * 16 + 8 * ((lane >> 3) & 1)]);
      const __nv_bfloat16* brow = &Bs[kk * 16 + (lane & 15)][0];
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t b0, b1;
        tv::ldsm_x2_trans(b0, b1, brow + nt * 8);
        tv::mma_16816(acc[nt], af, b0, b1);
      }
    }
  }
  float* out = a.states + (((size_t)b * a.nc + c) * a.H + h) * kP * kN;
  const int p0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out + (p0 + 8 * half) * kN + nt * 8 + cq) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
}

// Pass 4. grid (P*N / 128, H, B): one thread per state element walks the
// chunks in order, overwriting each chunk state with the inbound state. The
// chunk states are read kUnroll at a time so that their loads overlap.
__global__ void __launch_bounds__(kThreads) state_pass_kernel(SsdArgs a) {
  constexpr int kUnroll = 8;
  const int e = blockIdx.x * kThreads + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t hstride = (size_t)a.H * kP * kN;
  float s = a.init ? a.init[((size_t)b * a.H + h) * kP * kN + e] : 0.f;
  float* st = a.states + (size_t)b * a.nc * hstride + (size_t)h * kP * kN + e;
  const float* carry = a.carry + ((size_t)b * a.H + h) * a.nc;
  for (int c0 = 0; c0 < a.nc; c0 += kUnroll) {
    float local[kUnroll], decay[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < a.nc) {
        local[u] = st[(c0 + u) * hstride];
        decay[u] = carry[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < a.nc) {
        st[(c0 + u) * hstride] = s;
        s = s * decay[u] + local[u];
      }
    }
  }
  a.final_state[((size_t)b * a.H + h) * kP * kN + e] = s;
}

// Pass 5. grid (nc * cs/64, H, B), 128 threads: 64 output rows x P of one
// (chunk, head) on the tensor cores; warp w owns rows 16w..16w+15.
//   y[i,p] = exp(acs_i) cont_i sum_n C[i,n] S_in[p,n]                (inbound state)
//          + sum_{j<=i, same segment} CB[i,j] exp(acs_i - acs_j) dt_j x[j,p]
//          + D x[i,p]
// The masked decay matrix is built in registers straight into the MMA's A
// layout; x*dt is read transposed by ldmatrix. As in the TPU kernel, the
// operands of both products are bf16 and the sums f32.
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(SsdArgs a) {
  const int T = a.cs / kTile;
  const int c = blockIdx.x / T, it = blockIdx.x % T, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  __shared__ __align__(16) __nv_bfloat16 Cs[kTile][kLDN];  // C rows of the tile
  __shared__ __align__(16) __nv_bfloat16 Ss[kP][kLDN];     // inbound state [p][n]
  __shared__ __align__(16) __nv_bfloat16 Xs[kTile][kLDP];  // x * dt, [j][p]
  __shared__ float acs_i[kTile], out_w[kTile], acs_j[kTile];
  __shared__ int seg_i[kTile], seg_j[kTile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t hrow = ((size_t)b * a.H + h) * a.Lp + (size_t)c * a.cs;
  const int i0 = it * kTile;  // row offset inside the chunk
  const int sprev = seg_prev(a, b, c);
  if (tid < kTile) {
    const float v = a.acs[hrow + i0 + tid];
    const int s = seg_at(a, b, c * a.cs + i0 + tid);
    acs_i[tid] = v;
    seg_i[tid] = s;
    out_w[tid] = s == sprev ? expf(v) : 0.f;
  }
  const float* sin = a.states + (((size_t)b * a.nc + c) * a.H + h) * kP * kN;
  for (int e = tid; e < kTile * kN / 8; e += kThreads) {
    const int r = e / (kN / 8), n = (e % (kN / 8)) * 8, pos = c * a.cs + i0 + r;
    *reinterpret_cast<uint4*>(&Cs[r][n]) = bc_row8(a, a.Cm, b, pos, g, n);
  }
  for (int e = tid; e < kP * kN / 4; e += kThreads) {
    const int p = e / (kN / 4), n = (e % (kN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(sin + p * kN + n);
    *reinterpret_cast<uint2*>(&Ss[p][n]) =
        make_uint2(tv::pack_bf16(v.x, v.y), tv::pack_bf16(v.z, v.w));
  }
  __syncthreads();

  const int rl = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;  // rows rl, rl + 8 of the tile
  float acc[kP / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < kN / 16; ++ks) {
    const uint32_t af[4] = {tv::ld32(&Cs[rl][ks * 16 + cq]), tv::ld32(&Cs[rl + 8][ks * 16 + cq]),
                            tv::ld32(&Cs[rl][ks * 16 + cq + 8]),
                            tv::ld32(&Cs[rl + 8][ks * 16 + cq + 8])};
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
      const __nv_bfloat16* p = &Ss[nt * 8 + (lane >> 2)][ks * 16 + cq];
      tv::mma_16816(acc[nt], af, tv::ld32(p), tv::ld32(p + 8));
    }
  }
#pragma unroll
  for (int nt = 0; nt < kP / 8; ++nt) {
    acc[nt][0] *= out_w[rl];
    acc[nt][1] *= out_w[rl];
    acc[nt][2] *= out_w[rl + 8];
    acc[nt][3] *= out_w[rl + 8];
  }

  const float* cbm = a.cb + (((size_t)b * a.nc + c) * a.G + g) * a.cs * a.cs;
  const float* cb_rows[2] = {cbm + (size_t)(i0 + rl) * a.cs, cbm + (size_t)(i0 + rl + 8) * a.cs};
  for (int j0 = 0; j0 < i0 + kTile; j0 += kTile) {
    __syncthreads();  // the previous Xs / acs_j / seg_j are no longer read
    for (int e = tid; e < kTile * kP / 8; e += kThreads) {
      const int j = e / (kP / 8), p0 = (e % (kP / 8)) * 8;
      float xv[8];
      x_row8(a, b, c * a.cs + j0 + j, h, p0, xv);
      *reinterpret_cast<uint4*>(&Xs[j][p0]) = pack8(xv, a.dtp[hrow + j0 + j]);
      // the last tile is the block's own rows: keep their x for the D x term
      // in Cs, whose C rows the inbound-state product no longer reads
      if (j0 == i0) *reinterpret_cast<uint4*>(&Cs[j][p0]) = pack8(xv, 1.f);
    }
    if (tid < kTile) {
      acs_j[tid] = a.acs[hrow + j0 + tid];
      seg_j[tid] = seg_at(a, b, c * a.cs + j0 + tid);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      // A fragment of M[i, j] = CB[i, j] exp(acs_i - acs_j), masked to j <= i
      // and one segment: rows rl / rl + 8, columns cq, cq + 1 (+ 8)
      float mv[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int half = q & 1, jl = kk * 16 + cq + 8 * (q >> 1);  // local j in the tile
        const int il = rl + 8 * half;
        const float2 cbv = *reinterpret_cast<const float2*>(cb_rows[half] + j0 + jl);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool ok = j0 + jl + u <= i0 + il && seg_j[jl + u] == seg_i[il];
          mv[q][u] = ok ? (u ? cbv.y : cbv.x) * expf(acs_i[il] - acs_j[jl + u]) : 0.f;
        }
      }
      const uint32_t af[4] = {tv::pack_bf16(mv[0][0], mv[0][1]), tv::pack_bf16(mv[1][0], mv[1][1]),
                              tv::pack_bf16(mv[2][0], mv[2][1]), tv::pack_bf16(mv[3][0], mv[3][1])};
      const __nv_bfloat16* xrow = &Xs[kk * 16 + (lane & 15)][0];
#pragma unroll
      for (int nt = 0; nt < kP / 8; ++nt) {
        uint32_t b0, b1;
        tv::ldsm_x2_trans(b0, b1, xrow + nt * 8);
        tv::mma_16816(acc[nt], af, b0, b1);
      }
    }
  }

  const float Dh = a.D ? a.D[h] : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = c * a.cs + i0 + rl + 8 * half;
    if (pos >= a.L) continue;
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = nt * 8 + cq + u;
        const size_t o = (((size_t)b * a.L + pos) * a.H + h) * kP + p;
        a.y[o] = to_bf(acc[nt][2 * half + u] + Dh * bf(Cs[rl + 8 * half][p]));
      }
    }
  }
}

}  // namespace

extern "C" int tv_ssd_fwd(const void* x, const void* dt, const void* A, const void* dt_bias,
                          const void* D, const void* Bm, const void* Cm, const void* seq,
                          const void* init, const void* wx, const void* bx, const void* wB,
                          const void* bB, const void* wC, const void* bC, void* xc, void* Bc,
                          void* Cc, void* y, void* final_state, void* dtp, void* acs,
                          void* carry, void* states, void* cb, int B, int L, int H, int P,
                          int G, int N, int cs, int sx, int sdt, int sbc, int clamp,
                          float dt_lo, float dt_hi, void* stream) {
  if (P != kP || N != kN || cs % kTile != 0 || cs > 1024 || H % G != 0)
    return cudaErrorInvalidValue;
  if ((wx == nullptr) != (wB == nullptr) || (wx == nullptr) != (wC == nullptr) ||
      (wx != nullptr && (xc == nullptr || Bc == nullptr || Cc == nullptr)))
    return cudaErrorInvalidValue;  // K5 convolves all three streams into scratch, or none
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  SsdArgs a;
  if (wx != nullptr) {  // K5: the conv stage, then K1's passes on its output
    ConvArgs ca;
    const void* raw[3] = {x, Bm, Cm};
    void* out[3] = {xc, Bc, Cc};
    const void* w[3] = {wx, wB, wC};
    const void* bias[3] = {bx, bB, bC};
    const int ch[3] = {H * P, G * N, G * N}, ld[3] = {sx, sbc, sbc};
    int blocks[3];
    for (int i = 0; i < 3; ++i) {
      ca.s[i] = ConvStream{static_cast<const __nv_bfloat16*>(raw[i]),
                           static_cast<__nv_bfloat16*>(out[i]), static_cast<const float*>(w[i]),
                           static_cast<const float*>(bias[i]), ch[i], ld[i]};
      blocks[i] = (ch[i] / 8 + kThreads - 1) / kThreads;
    }
    ca.seq = static_cast<const int*>(seq);
    ca.L = L;
    ca.blocks0 = blocks[0];
    ca.blocks1 = blocks[0] + blocks[1];
    conv_kernel<<<dim3((L + kConvRows - 1) / kConvRows, ca.blocks1 + blocks[2], B), kThreads, 0,
                  s>>>(ca);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    x = xc;
    Bm = Bc;
    Cm = Cc;
    sx = H * P;
    sbc = G * N;
  }
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const __nv_bfloat16*>(dt);
  a.A = static_cast<const float*>(A);
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.D = static_cast<const float*>(D);
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.seq = static_cast<const int*>(seq);
  a.init = static_cast<const float*>(init);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.final_state = static_cast<float*>(final_state);
  a.dtp = static_cast<float*>(dtp);
  a.acs = static_cast<float*>(acs);
  a.carry = static_cast<float*>(carry);
  a.states = static_cast<float*>(states);
  a.cb = static_cast<float*>(cb);
  a.B = B; a.L = L; a.H = H; a.G = G; a.cs = cs;
  a.sx = sx; a.sdt = sdt; a.sbc = sbc;
  a.nc = (L + cs - 1) / cs;
  a.Lp = a.nc * cs;
  a.clamp = clamp; a.dt_lo = dt_lo; a.dt_hi = dt_hi;
  const int T = cs / kTile;
  dt_cumsum_kernel<<<dim3(a.nc, H, B), cs, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_cb_kernel<<<dim3(a.nc * T * T, G, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_state_kernel<<<dim3(a.nc, H, B), kThreads, cs * sizeof(float), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass_kernel<<<dim3(kP * kN / kThreads, H, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_scan_kernel<<<dim3(a.nc * T, H, B), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}
