// Mamba-2 SSD chunked-scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel timeviper_tpu/ops/ssd_pallas.py:_ssd_kernel (driven
// by _ssd_pallas_fwd, reached through ssd_auto from models/nano.py). Per
// chunk the TPU kernel computes C.B^T once for a group and then, head by
// head, what is causal attention with a decay mask in place of the softmax
// (Q = C and K = B shared by the group's heads, V = x dt per head), plus
// C . inbound state and D x, carrying the state across its in-order chunk
// walk: 8 programs at batch 1 for 132 SMs. Here the work runs as passes
// parallel over chunks, with one short sequential walk:
//   1. dt_cumsum:   dt = softplus(dt + dt_bias) clamped to dt_limit (0 on the
//                   ragged tail), the chunk-local cumsum of dt*A, and the
//                   factor that carries the state across the chunk;
//   2. chunk_state: what each chunk adds to the state at its end,
//                   (x w)^T B over the chunk's rows, per head;
//   3. state_pass:  a walk over the nc chunks per (b, h, 4 state elements)
//                   turning chunk states into inbound states: in bf16 (what
//                   chunk_scan reads) always, in f32 in place only where the
//                   backward (K4) takes them (`keep_f32`);
//   4. chunk_scan:  per 64-row tile i of a chunk, y_i = sum_{j <= i} M_ij
//                   (x_j dt_j) + w_out_i C_i . h_in + D x_i, M = C.B^T *
//                   decay, masked to j <= i and one segment.
// Chunks of at most 256 rows (four 64-row tiles): the wrapper runs a longer
// chunk as 256-row ones, the same function with the state rounded to bf16
// every 256 rows.
//
// What bounds it on the H100 is bytes: x, dt, B, C and the segment ids in,
// y and the final state out, 156 MB at the 9B's L 4,096 (0.047 ms at 3.35
// TB/s), against ~20 GFLOP of bf16 products (0.02 ms at the tensor cores'
// peak). The passes add the f32 chunk states (written once, read once, 134
// MB) and the bf16 inbound states (67 MB). The design:
// - chunk_scan and chunk_state run one block per (chunk[, 64-row tile],
//   group, slice of the group's heads), one block an SM (their staged tiles
//   take most of the shared memory), whose consumer warpgroups take the
//   slice's heads in turn, as K4's walk kernels do (ssd_bwd.cu). What the
//   group shares is staged once a block by 16-byte cp.async into the
//   128-byte swizzle: C_i and B_j of every walked tile (chunk_scan), B of
//   the chunk (chunk_state). What is per head (the bf16 inbound state, the
//   head's cumsum and dt, its x tiles) streams through cp.async groups per
//   warpgroup. Each warpgroup's step is a chain (wait for its copies, build
//   an operand, the product, wait for it) that one warpgroup cannot overlap
//   with itself, so what holds chunk_scan back is how many such chains an SM
//   runs: it has four warpgroups with one slot each for the head's state
//   and two for its x tiles, one unit ahead (two warpgroups with deeper
//   rings, or the product left in flight across units, ran slower).
//   chunk_state keeps two warpgroups, each with two slots of a head's whole
//   chunk (four with one slot ran slower).
// - Every product is a wgmma sequence (attn_sm90.cuh): C_i B_j^T (64 x 64 x
//   128) once a block and tile pair, kept in shared memory in the
//   accumulator's register order (f32, over the B tile it came from) for the
//   block's heads; y_off = C_i h_in^T (64 x 64 x 128); M x_j (64 x 64 x 64,
//   M from registers); chunk_state's (x w)^T B (64 x 128 x 64 a tile, both
//   operands read transposed from shared memory).
// - The rounding points are the TPU kernel's: x dt is rounded to bf16 (each
//   x tile scaled in shared memory as it lands) and the masked decay matrix
//   M separately (dt folded into M instead ran chunk_scan ~13% faster; see
//   PERF.md for why it was not kept). The decay of a walked tile j below the
//   block's tile i0 is exp(acs_i - acs_i0) exp(acs_i0 - acs_j): both factors
//   are at most 1 (the cumsum only falls), the second a column factor taken
//   once a head, the first a row factor on those tiles' sum. The diagonal
//   tile takes ex2 of the scaled difference per pair. Never exp(acs_i)
//   exp(-acs_j): at the 9B's A that overflows f32 within a chunk.
// - Blocks whose tile starts at or past L exit at once (a 12-row question
//   fills one of a chunk's four tiles); the wrapper splits a group's heads
//   over slices where a grid would fill under 3 waves
//   (ops/ssd_kernel.py:head_slices).
// - Every sum has a fixed order and there are no atomics: the outputs are
//   bitwise repeatable.
// Head h reads group h / (H/G). seq_idx resets the state inside a chunk and
// at chunk boundaries, exactly as the TPU kernel does. x, dt, B and C may be
// column slices of one wider in-projection output: their rows are `sx`,
// `sdt`, `sbc` apart.
//
// K5 is the same passes after a conv stage: it replaces the `fuse_conv`
// mode of the same TPU kernel (timeviper_tpu/ops/ssd_pallas.py:_ssd_kernel
// via ssd_conv_scan_fused :981), which carries a halo of 3 raw rows across
// its in-order chunk walk. Here the passes read x, B and C many times over
// (chunk_scan reads x 2.5 times a row on average at 4 tiles a chunk), so a
// loader that convolved what it read would convolve each raw element
// several times. Instead conv_kernel convolves every raw element exactly
// once into bf16 scratch that the wrapper allocates, and the passes read
// that. What bounds the conv stage is bytes: the raw streams read once (plus
// a 3-row halo per 32 rows, from L2) and the convolved ones written once,
// 20,480 bf16 a token of the 9B, ~0.05 ms at L 4,096 against 3.35 TB/s; the
// convolved B and C (17 MB) stay in the 50 MB L2 for the passes. Next to the
// bytes it runs an exp and a division a channel (SiLU), so it keeps many
// loads in flight: a thread owns 8 channels of one stream (16-byte loads and
// stores, a warp 512 contiguous bytes of a row) and walks 32 rows, loading
// the next 4 rows while it convolves these, with the 3 raw rows before each
// held in registers (96 registers, 5 blocks an SM: batches of 8 rows took
// 128 and ran 23% slower); the tile's segment ids sit in shared memory, read
// from device memory once. Taps, bias and SiLU run in f32 in the TPU
// kernel's order (ssd_pallas.py:155-183) and the result is rounded to bf16,
// as the TPU kernel does; a tap before row 0 or in another segment than the
// row's reads zero (_tap_mask, :137-147).
#include "ssd_sm90.cuh"

namespace {

using namespace tv::sm90;
using namespace tv::ssd;
using tv::bf;

constexpr int kP = 64;         // mamba head dim this kernel takes
constexpr int kN = 128;        // state size this kernel takes
constexpr int kTile = 64;      // chunk rows of one tile
constexpr int kMaxT = 4;       // tiles a chunk: chunks of at most 256 rows
constexpr int kThreads = 128;  // the conv stage's and state_pass's blocks
constexpr int kWG = 256;       // chunk_state's blocks: two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

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
  float* states;            // (B, nc, H, P, N) chunk states; with keep_f32 then the inbound states
  __nv_bfloat16* hin;       // (B, nc, H, P, N) inbound states in bf16
  int B, L, H, G, cs, nc, Lp;
  // row strides (elements) of x, dt and B/C between positions: the streams
  // may be column slices of one in-projection output (its fused leaf)
  int sx, sdt, sbc;
  int S_state, S_scan;  // slices of a group's heads in chunk_state and chunk_scan
  int clamp, keep_f32;
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

// d (64 x 128 f32, 64 a thread) (+)= A (64 x 16) * B (16 x 128), both read
// from shared memory MN-major (the two transpose bits): A's tile stored
// [k][m], B's [k][n].
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The descriptor of a swizzled operand tile k-step kk (16 rows of [k][.]
// storage) read MN-major: its 64-column boxes kBox apart, 8-row groups
// 1,024 bytes apart.
__device__ __forceinline__ uint64_t mn_desc(const uint8_t* tile, int kk) {
  return mdesc<128>(smem_u32(tile) + kk * 16 * 128, kBox, 1024);
}

constexpr int kVec = 256 * 4;  // bytes of a head's cumsum or dt over a chunk
constexpr int kStateSlot = kMaxT * kBox + 2 * kVec;  // a head's x tiles, acs, dtp
constexpr size_t kStateSmem = 1024 + kMaxT * kNTile + 2 * 2 * kStateSlot + 256 * sizeof(int);

// Pass 2. grid (nc, G * S_state, B), 256 threads, kStateSmem bytes.
// states[b,c,h,p,n] = sum_j w_j x[j,p] B[j,n], w_j = dt_j exp(acs_last -
// acs_j) for rows of the chunk's last segment (earlier segments never reach
// the chunk's end state), else 0. The block stages the group's B rows of
// the chunk; warpgroup wg takes the heads wg, wg + 2, .. of the block's
// slice, each head's x tiles and cumsum and dt one unit of its two-slot
// ring: w into the dt copy, x w rounded to bf16 in place, then (x w)^T B as
// one m64n128 wgmma sequence over the chunk's live tiles.
__global__ void __launch_bounds__(kWG, 1) chunk_state_kernel(const __grid_constant__ SsdArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* b_tiles = align1024(smem_raw);           // [T][64][128] the group's B rows
  uint8_t* wg_base = b_tiles + kMaxT * kNTile;      // per warpgroup: two head slots
  int* seg = reinterpret_cast<int*>(wg_base + 2 * 2 * kStateSlot);  // [cs] the chunk's ids
  const int R = a.H / a.G, Rs = R / a.S_state;
  const int c = blockIdx.x, g = blockIdx.y / a.S_state, sl = blockIdx.y % a.S_state;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int lane = tid & 31, ra = 16 * (tw >> 5) + (lane >> 2), cq = (lane & 3) * 2;
  const int pos0 = c * a.cs;
  const int nt = min(a.cs / kTile, (a.L - pos0 + kTile - 1) / kTile);  // tiles with rows < L
  for (int t = 0; t < nt; ++t)
    load_tile<kN, kWG>(b_tiles + t * kNTile,
                       a.Bm + ((size_t)b * a.L + pos0 + t * kTile) * a.sbc + g * kN, a.sbc,
                       a.L - pos0 - t * kTile, tid, a.Bm);
  for (int t = tid; t < a.cs; t += kWG) seg[t] = seg_at(a, b, pos0 + t);

  uint8_t* mine = wg_base + wg * 2 * kStateSlot;
  const int nheads = (Rs - wg + 1) / 2;  // heads wg, wg + 2, .. of the slice
  auto head_of = [&](int k) { return g * R + sl * Rs + wg + 2 * k; };
  auto issue = [&](int k) {
    if (k < nheads) {
      const int h = head_of(k);
      uint8_t* hs = mine + (k & 1) * kStateSlot;
      for (int t = 0; t < nt; ++t) {
        const int p = pos0 + t * kTile;
        load_tile<kP, 128>(hs + t * kBox, a.x + ((size_t)b * a.L + p) * a.sx + h * kP, a.sx,
                           a.L - p, tw, a.x);
      }
      const size_t hrow = ((size_t)b * a.H + h) * a.Lp + pos0;
      load_vec(reinterpret_cast<float*>(hs + kMaxT * kBox), a.acs + hrow, a.cs, tw);
      load_vec(reinterpret_cast<float*>(hs + kMaxT * kBox + kVec), a.dtp + hrow, a.cs, tw);
    }
    cp_commit();
  };

  issue(0);
  cp_wait_all();
  __syncthreads();
  const int seg_last = seg[a.cs - 1];
  for (int k = 0; k < nheads; ++k) {
    if (k > 0) {
      cp_wait_all();
      wg_bar(wg);
    }
    issue(k + 1);
    uint8_t* hs = mine + (k & 1) * kStateSlot;
    const float* acs = reinterpret_cast<const float*>(hs + kMaxT * kBox);
    float* w = reinterpret_cast<float*>(hs + kMaxT * kBox + kVec);  // dt, then the row weights
    const float acs_last = acs[a.cs - 1];
    for (int j = tw; j < a.cs; j += 128)
      w[j] = seg[j] == seg_last ? w[j] * expf(acs_last - acs[j]) : 0.f;
    wg_bar(wg);
    for (int e = tw; e < nt * 512; e += 128) {  // x w, rounded to bf16, in place
      const int t = e >> 9, r = (e >> 3) & 63;
      uint4* v = reinterpret_cast<uint4*>(hs + t * kBox + sw_off(r, e & 7));
      *v = scale8(*v, w[t * kTile + r]);
    }
    fence_async();
    wg_bar(wg);
    float acc[64];
    wg_fence();
#pragma unroll 1
    for (int t = 0; t < nt; ++t) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_tt(acc, mn_desc(hs + t * kBox, kk), mn_desc(b_tiles + t * kNTile, kk),
                 t > 0 || kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(acc);
    float* out = a.states + (((size_t)b * a.nc + c) * a.H + head_of(k)) * kP * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(out + (ra + 8 * half) * kN + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// Pass 3. grid (P*N / 512, H, B), 128 threads: thread t owns 4 consecutive
// state elements and walks the chunks in order, writing each chunk's
// inbound state in bf16 (and with keep_f32 in f32 over its chunk state).
// The chunk states are read kUnroll at a time so that their loads overlap.
__global__ void __launch_bounds__(kThreads) state_pass_kernel(SsdArgs a) {
  constexpr int kUnroll = 8;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4, h = blockIdx.y, b = blockIdx.z;
  const size_t hstride = (size_t)a.H * kP * kN;
  const size_t own = ((size_t)b * a.H + h) * kP * kN + e;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.init) s = *reinterpret_cast<const float4*>(a.init + own);
  const size_t base = (size_t)b * a.nc * hstride + (size_t)h * kP * kN + e;
  const float* carry = a.carry + ((size_t)b * a.H + h) * a.nc;
  for (int c0 = 0; c0 < a.nc; c0 += kUnroll) {
    float4 local[kUnroll];
    float decay[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < a.nc) {
        local[u] = *reinterpret_cast<const float4*>(a.states + base + (c0 + u) * hstride);
        decay[u] = carry[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < a.nc) {
        const size_t o = base + (c0 + u) * hstride;
        *reinterpret_cast<uint2*>(a.hin + o) =
            make_uint2(tv::pack_bf16(s.x, s.y), tv::pack_bf16(s.z, s.w));
        if (a.keep_f32) *reinterpret_cast<float4*>(a.states + o) = s;
        s.x = s.x * decay[u] + local[u].x;
        s.y = s.y * decay[u] + local[u].y;
        s.z = s.z * decay[u] + local[u].z;
        s.w = s.w * decay[u] + local[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(a.final_state + own) = s;
}

constexpr int kScanWGs = 4;  // chunk_scan's consumer warpgroups
constexpr int kScanThreads = 128 * kScanWGs;
// per warpgroup: the bf16 inbound state [p][n], two walk slots, two (acs, dtp) slots
constexpr int kScanWG = kNTile + 2 * kBox + 2 * 2 * kVec;
constexpr size_t kScanSmem =
    1024 + (1 + kMaxT) * kNTile + kScanWGs * kScanWG + 256 * sizeof(int);

// Pass 4. grid (nc * T, G * S_scan, B), kScanThreads threads, kScanSmem
// bytes. blockIdx.x = k nc + c: the block's rows are tile it = T-1-k of
// chunk c, so the longest walks start first. Per head h, for the block's
// rows i, with xd_j = x_j dt_j rounded to bf16:
//   y_i = e_i (w_i C_i . h_in + sum_{j < i0} M'_ij xd_j) + sum_{i0 <= j <= i} M_ij xd_j + D x_i
//   w_i   = [segment of the inbound state] exp(acs_i0),  e_i = exp(acs_i - acs_i0)
//   M'_ij = [same segment] CB_ij exp(acs_i0 - acs_j)
//   M_ij  = [j <= i, same segment] CB_ij exp(acs_i - acs_j)
// with i0 the tile's first row and CB = C.B^T (e_i w_i is the inbound
// state's weight exp(acs_i)). The block stages C_i and the B_j of its walked
// tiles; the warpgroups compute C_i B_j^T (tiles wg, wg + 4, ..) over the B
// tiles. Warpgroup wg then takes the heads wg, wg + 4, .. of the slice, one
// unit per walked tile j = 0..it: its x tile, and with tile 0 the head's
// inbound state, cumsum and dt, whose C_i . h_in runs first (so the next
// head's copies may follow it into the slot) while the column factors
// exp(acs_i0 - acs_j) are made in place of the cumsum. Each x tile is scaled
// by dt in place as it lands (the diagonal tile's raw x kept in registers
// for D x first). Each unit is a cp.async group
// issued one unit ahead; a head's cumsum and dt alternate between two slots.
__global__ void __launch_bounds__(kScanThreads, 1)
    chunk_scan_kernel(const __grid_constant__ SsdArgs a) {
  const int T = a.cs / kTile;
  const int c = blockIdx.x % a.nc, it = T - 1 - blockIdx.x / a.nc;
  const int pos0 = c * a.cs, i0 = it * kTile, pos_i = pos0 + i0;
  if (pos_i >= a.L) return;  // a tile wholly in the ragged tail
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* c_own = align1024(smem_raw);       // [64][128] C of the block's rows
  uint8_t* tiles = c_own + kNTile;            // [T][64][128] B_j, then C_i B_j^T in register order
  uint8_t* wg_base = tiles + kMaxT * kNTile;  // per warpgroup: state, walk and vector slots
  int* seg = reinterpret_cast<int*>(wg_base + kScanWGs * kScanWG);  // [cs] the chunk's ids
  const int R = a.H / a.G, Rs = R / a.S_scan;
  const int g = blockIdx.y / a.S_scan, sl = blockIdx.y % a.S_scan, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int lane = tid & 31, ra = 16 * (tw >> 5) + (lane >> 2), cq = (lane & 3) * 2;

  // the group's rows, once a block
  const size_t grow = (size_t)b * a.L * a.sbc + g * kN;
  load_tile<kN, kScanThreads>(c_own, a.Cm + grow + (size_t)pos_i * a.sbc, a.sbc, a.L - pos_i,
                              tid, a.Cm);
  for (int t = 0; t <= it; ++t)
    load_tile<kN, kScanThreads>(tiles + t * kNTile,
                                a.Bm + grow + (size_t)(pos0 + t * kTile) * a.sbc, a.sbc,
                                a.L - pos0 - t * kTile, tid, a.Bm);
  cp_commit();
  for (int t = tid; t < a.cs; t += kScanThreads) seg[t] = seg_at(a, b, pos0 + t);

  uint8_t* hs = wg_base + wg * kScanWG;  // the head's inbound state
  const int per_head = it + 1;           // units a head: its walked tiles 0..it
  const int nheads = (Rs - wg + kScanWGs - 1) / kScanWGs;  // heads wg, wg + 4, ..
  const int units = nheads * per_head;
  auto head_of = [&](int hk) { return g * R + sl * Rs + wg + kScanWGs * hk; };
  auto walk_slot = [&](int u) { return hs + kNTile + (u & 1) * kBox; };
  // the head's cumsum and dt, by head parity: the next head's land beside them
  auto vec_slot = [&](int hk) {
    return reinterpret_cast<float*>(hs + kNTile + 2 * kBox + (hk & 1) * 2 * kVec);
  };
  auto issue = [&](int u) {
    if (u < units) {
      const int hk = u / per_head, q = u % per_head, h = head_of(hk);
      if (q == 0) {
        load_tile<kN, 128>(hs, a.hin + (((size_t)b * a.nc + c) * a.H + h) * kP * kN, kN, kP, tw,
                           a.hin);
        const size_t hrow = ((size_t)b * a.H + h) * a.Lp + pos0;
        load_vec(vec_slot(hk), a.acs + hrow, a.cs, tw);
        load_vec(vec_slot(hk) + kVec / 4, a.dtp + hrow, a.cs, tw);
      }
      const int w0 = pos0 + q * kTile;
      load_tile<kP, 128>(walk_slot(u), a.x + ((size_t)b * a.L + w0) * a.sx + h * kP, a.sx,
                         a.L - w0, tw, a.x);
    }
    cp_commit();  // an empty group past the last unit keeps the count
  };
  issue(0);
  cp_wait_group<1>();  // the group's rows
  __syncthreads();

  // C_i B_j^T, over B_j in the register order of the threads that read it
  for (int t = wg; t <= it; t += kScanWGs) {
    float s[32];
    issue_qk<kN, 64, 64, 64>(s, smem_u32(c_own), smem_u32(tiles + t * kNTile));
    wg_wait<0>();
    pin(s);
    wg_bar(wg);  // every warp's product has read B_t
    float4* dst = reinterpret_cast<float4*>(tiles + t * kNTile) + tw;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dst[k * 128] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  }
  __syncthreads();

  const int seg_r[2] = {seg[i0 + ra], seg[i0 + ra + 8]};
  const int sprev = seg_prev(a, b, c);
  float acc[32];
  for (int u = 0; u < units; ++u) {
    cp_wait_group<0>();  // unit u has landed
    wg_bar(wg);
    const int hk = u / per_head, q = u % per_head;
    uint8_t* xs = walk_slot(u);
    float* acs = vec_slot(hk);  // the cumsum; below i0, the column factors
    const float* dtp = vec_slot(hk) + kVec / 4;
    if (q == 0) {
      // ---- the head's first unit: w_i C_i . h_in, the column factors ----
      issue_qk<kN, 64, 64, 64>(acc, smem_u32(c_own), smem_u32(hs));  // C_i h_in^T
      const float a0 = acs[i0];
      for (int j = tw; j < i0; j += 128) acs[j] = ex2((a0 - acs[j]) * kLog2e);
      wg_wait<0>();
      pin(acc);
      const float w0 = ex2(a0 * kLog2e);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float wr = seg_r[r] == sprev ? w0 : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 2 * r] *= wr;
          acc[4 * j + 2 * r + 1] *= wr;
        }
      }
      wg_bar(wg);  // the factors are in; every warp's product has read h_in
    }
    issue(u + 1);
    // x dt, rounded to bf16, in place; first, on the diagonal tile, the raw
    // x of this thread's rows for D x
    uint32_t xraw[2][8];  // bf16 pairs
    if (q == it) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xraw[r][j] = *reinterpret_cast<const uint32_t*>(xs + sw_off(ra + 8 * r, j) + cq * 2);
      wg_bar(wg);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = tw + 128 * k, r = e >> 3;
      uint4* v = reinterpret_cast<uint4*>(xs + sw_off(r, e & 7));
      *v = scale8(*v, dtp[q * kTile + r]);
    }
    fence_async();
    wg_bar(wg);
    float cbv[32];
    {
      const float4* src = reinterpret_cast<const float4*>(tiles + q * kNTile) + tw;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 v = src[k * 128];
        cbv[4 * k] = v.x;
        cbv[4 * k + 1] = v.y;
        cbv[4 * k + 2] = v.z;
        cbv[4 * k + 3] = v.w;
      }
    }
    uint32_t pm[4][4];
    if (q < it) {
      // ---- a tile below the block's: M' x_j ----
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = q * kTile + 8 * j + cq;
        const float2 gv = *reinterpret_cast<const float2*>(acs + col);
        const int2 sc = *reinterpret_cast<const int2*>(seg + col);
        float mv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = ((e & 1) ? sc.y : sc.x) == seg_r[e >> 1];
          mv[e] = ok ? cbv[4 * j + e] * ((e & 1) ? gv.y : gv.x) : 0.f;
        }
        pm[j >> 1][(j & 1) * 2] = tv::pack_bf16(mv[0], mv[1]);
        pm[j >> 1][(j & 1) * 2 + 1] = tv::pack_bf16(mv[2], mv[3]);
      }
      issue_pv<kP, 64, 64, 64>(acc, pm, smem_u32(xs));
      wg_wait<0>();
      pin(acc);
      pin(pm);
      continue;
    }
    // ---- the diagonal tile: the decay per pair, the head's rows out ----
    const float acs_r[2] = {acs[i0 + ra], acs[i0 + ra + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = i0 + 8 * j + cq;
      const float2 ac = *reinterpret_cast<const float2*>(acs + col);
      const int2 sc = *reinterpret_cast<const int2*>(seg + col);
      float mv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = 8 * j + cq + (e & 1) <= ra + 8 * r && ((e & 1) ? sc.y : sc.x) == seg_r[r];
        mv[e] = ok ? cbv[4 * j + e] * ex2((acs_r[r] - ((e & 1) ? ac.y : ac.x)) * kLog2e) : 0.f;
      }
      pm[j >> 1][(j & 1) * 2] = tv::pack_bf16(mv[0], mv[1]);
      pm[j >> 1][(j & 1) * 2 + 1] = tv::pack_bf16(mv[2], mv[3]);
    }
    const float a0 = acs[i0];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float er = ex2((acs_r[r] - a0) * kLog2e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j + 2 * r] *= er;
        acc[4 * j + 2 * r + 1] *= er;
      }
    }
    issue_pv<kP, 64, 64, 64>(acc, pm, smem_u32(xs));
    wg_wait<0>();
    pin(acc);
    pin(pm);
    wg_bar(wg);  // every warp's product has read x_i
    // y = acc + D x, rounded to bf16 over x_i, then out as 16-byte rows
    const int h = head_of(hk);
    const float Dh = a.D ? a.D[h] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xraw[r][j]));
        *reinterpret_cast<uint32_t*>(xs + sw_off(ra + 8 * r, j) + cq * 2) =
            tv::pack_bf16(acc[4 * j + 2 * r] + Dh * xv.x, acc[4 * j + 2 * r + 1] + Dh * xv.y);
      }
    wg_bar(wg);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = tw + 128 * k, r = e >> 3, pos = pos_i + r;
      if (pos < a.L)
        *reinterpret_cast<uint4*>(a.y + (((size_t)b * a.L + pos) * a.H + h) * kP + (e & 7) * 8) =
            *reinterpret_cast<const uint4*>(xs + sw_off(r, e & 7));
    }
  }
}

}  // namespace

extern "C" int tv_ssd_fwd(const void* x, const void* dt, const void* A, const void* dt_bias,
                          const void* D, const void* Bm, const void* Cm, const void* seq,
                          const void* init, const void* wx, const void* bx, const void* wB,
                          const void* bB, const void* wC, const void* bC, void* xc, void* Bc,
                          void* Cc, void* y, void* final_state, void* dtp, void* acs,
                          void* carry, void* states, void* hin, int B, int L, int H, int P,
                          int G, int N, int cs, int sx, int sdt, int sbc, int S_state,
                          int S_scan, int clamp, int keep_f32, float dt_lo, float dt_hi,
                          void* stream) {
  if (P != kP || N != kN || cs % kTile != 0 || cs > kMaxT * kTile || H % G != 0 ||
      S_state < 1 || S_scan < 1 || (H / G) % S_state != 0 || (H / G) % S_scan != 0)
    return cudaErrorInvalidValue;
  if ((wx == nullptr) != (wB == nullptr) || (wx == nullptr) != (wC == nullptr) ||
      (wx != nullptr && (xc == nullptr || Bc == nullptr || Cc == nullptr)))
    return cudaErrorInvalidValue;  // K5 convolves all three streams into scratch, or none
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  static bool smem_set = false;  // the kernels' shared memory limits, once a process
  if (!smem_set) {
    if ((err = cudaFuncSetAttribute(chunk_state_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kStateSmem)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kScanSmem)) != cudaSuccess)
      return err;
    smem_set = true;
  }
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
  a.hin = static_cast<__nv_bfloat16*>(hin);
  a.B = B; a.L = L; a.H = H; a.G = G; a.cs = cs;
  a.sx = sx; a.sdt = sdt; a.sbc = sbc;
  a.S_state = S_state; a.S_scan = S_scan;
  a.nc = (L + cs - 1) / cs;
  a.Lp = a.nc * cs;
  a.clamp = clamp; a.keep_f32 = keep_f32; a.dt_lo = dt_lo; a.dt_hi = dt_hi;
  const int T = cs / kTile;
  dt_cumsum_kernel<<<dim3(a.nc, H, B), cs, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_state_kernel<<<dim3(a.nc, G * S_state, B), kWG, kStateSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass_kernel<<<dim3(kP * kN / (4 * kThreads), H, B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_scan_kernel<<<dim3(a.nc * T, G * S_scan, B), kScanThreads, kScanSmem, s>>>(a);
  return cudaGetLastError();
}

// Threads and dynamic shared memory of a chunk_scan (which 0) or
// chunk_state (1) block, for the build log and the launch plan.
extern "C" int tv_ssd_fwd_block(int which, int* out) {
  out[0] = which ? kWG : kScanThreads;
  out[1] = (int)(which ? kStateSmem : kScanSmem);
  return 0;
}
