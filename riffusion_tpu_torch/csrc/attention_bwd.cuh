// The backward of K1's attention, O = softmax(Q K^T * scale) V, over packed
// (b, s, h*d) operands: the two kernel bodies (dK/dV and dQ) that
// attention_dkv.cu and attention_dq.cu launch, their fp32 instances for
// checks, and what both share. The Hopper building blocks (cp.async tile
// copies, wgmma and its descriptors, ex2) are in hopper.cuh.
//
// What they replace: the two Pallas kernels of the custom VJP of jax's TPU
// flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq).
//
// Both kernels recompute the probabilities from the forward's log-sum-exp
// (attention_common.cuh writes it: natural log, (b, h, s_q) fp32) and take
// delta = rowsum(dO * O), (b, h, s_q) fp32, computed by the caller:
//   P  = exp(scale * Q K^T - LSE)         (as exp2(S * c - LSE * log2 e))
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - delta)
//   dK = scale * dS^T Q,   dQ = scale * dS K
// The scale is applied once, to the (rows, d) output. P and dS are rounded
// to bf16 for the products that take them (dV, dK, dQ); every product
// accumulates in fp32.
//
// The split mirrors the TPU kernels': the dK/dV kernel owns a K/V tile and
// loops over Q tiles, the dQ kernel owns a Q tile and loops over K/V tiles,
// so each output row is written by one block, no atomics are needed and the
// result does not depend on block order. A ragged s_q is masked by an
// infinite LSE (P = 0) and zero rows; a ragged s_kv by P = 0 (dQ), zero
// rows, and by not writing past s_kv (dK/dV).
//
// What bounds them on this card. dK/dV does four products (S^T, dP^T, dV,
// dK) and dQ three (S, dP, dQ): 8 and 6 * b*h*s_q*s_kv*d FLOP, 172 and 129
// GFLOP at the fine-tuning site (4, 4096, 8*40), against some 60 MB of
// operands: far above the card's ~295 bf16 FLOP/byte ridge, so tensor-core
// issue bounds them (0.174 and 0.130 ms at 989 TFLOP/s). Each also
// recomputes P, one exp2 per logit, 537M at that site: at 16 exp2 per clock
// per SM that is about 0.13 ms, as much as dQ's tensor-core time, so at
// d = 40 the exponentials bound dQ as well.
//
// What the design does about it (attention_bwd_bf16_body):
// - The products are wgmma m64nNk16 (bf16 in, fp32 accumulators), one
//   warpgroup per 64 owned rows, two warpgroups per block (128 owned rows,
//   which halves the re-reads of the streamed operands against 64).
// - Every tile sits in shared memory once, in wgmma's no-swizzle layout.
//   The products that reduce over d read the streamed tile K-major; those
//   that reduce over its rows (dV = P^T dO, dK = dS^T Q, dQ = dS K) read
//   the same tile MN-major through a second descriptor: no transposed copy.
//   P and dS go from the accumulators to the next product's register A
//   operand (the m64nN accumulator layout packed to bf16 pairs is the
//   m64k16 A fragment).
// - The streamed tiles (Q, dO and their LSE and delta rows for dK/dV; K, V
//   for dQ) come through a 3-stage ring of cp.async copies, two tiles
//   ahead of the one in the products; each tile costs one wait and one
//   barrier. Which chunks a thread copies is worked out once. d = 40 is
//   padded to 48 for the reduction by the copies' zero fill; the outputs
//   stay 40 wide.
// - S and dP are two wgmma groups: the exponentials of P start when S has
//   landed, while dP is still in the tensor cores, and dK/dV issues
//   dV += P^T dO before it forms dS. exp2 is the SFU's ex2.approx.
// - dQ up to d = 48 fits in 128 registers, so two blocks share an SM and
//   one block's exponentials overlap the other's products. dK/dV (162
//   registers at d = 40) runs one block per SM: capped at 128 it spilled
//   and lost.
// - dK/dV at d = 128 streams 32-row tiles (its two 64 x 128 fp32
//   accumulators leave too few registers for 64-wide S^T and dP^T).
// Tried on the card and dropped: a one-phase skew between the two
// warpgroups (slower: their exponentials still met), one warpgroup per
// block (dK/dV slower), 2 or 4 ring stages for 3 (no difference), 32-row
// streamed tiles with two blocks per SM (no gain). No warp
// specialisation, TMA or clusters yet.
//
// Times on an H100 80GB HBM3 at 700 W (scripts/time_attention_kernels.py,
// parent / change / change / parent in one call): at (4, 4096, 8*40)
// dK/dV 0.687-0.733 ms (2.06-2.10 before), dQ 0.456-0.457 ms (1.62), the
// whole backward with delta 1.18-1.28 ms against the library's 1.00-1.03;
// at (4, 1024, 8*80) dK/dV 0.112-0.118 ms, dQ 0.090-0.091 ms. That is
// 234-250 TFLOP/s for dK/dV and 282 for dQ, a quarter of the bf16 peak:
// the copies' issue and the latency between each warpgroup's products and
// its exponentials, not the tensor cores or the SFUs, set the pace
// (PERF.md section 6).

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace riff {

constexpr int kBwdTile = 64;  // rows per block and per staged tile (fp32)

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (batch, heads, s_q), natural log
  const float* delta;  // (batch, heads, s_q), rowsum(dO * O)
  void* g0;            // dQ (dQ kernel) or dK (dK/dV kernel)
  void* g1;            // dV (dK/dV kernel), unused by the dQ kernel
  // element strides of the batch and sequence dims; the packed h*d dim is
  // contiguous. g0 and g1 share one layout.
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, g_sb, g_ss;
  int s_q, s_kv, head_dim;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// This block's (batch row, head) slice of the (b, h, s_q) log-sum-exp.
__device__ __forceinline__ const float* lse_rows(const BwdParams& p) {
  return p.lse + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.s_q;
}

// The same slice of delta.
__device__ __forceinline__ const float* delta_rows(const BwdParams& p) {
  return p.delta + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.s_q;
}

// dS for one logit: the softmax's Jacobian applied to dP.
__device__ __forceinline__ float grad_logit(float prob, float dp, float delta) {
  return prob * (dp - delta);
}

// Stage LSE * log2(e) and delta of query rows [m0, m0 + ROWS) into shared
// memory; rows past s_q get an infinite LSE (so P = 0) and delta 0.
template <int ROWS>
__device__ __forceinline__ void stage_row_stats(float* s_lse2, float* s_delta, const float* lse,
                                                const float* delta, int m0, int s_q) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const bool in = m0 + r < s_q;
    s_lse2[r] = in ? lse[m0 + r] * kLog2e : INFINITY;
    s_delta[r] = in ? delta[m0 + r] : 0.f;
  }
}

// Write this warp's 16 x DN fp32 accumulator (times `mult`) as bf16 rows
// r0 and r0 + 8 (this thread's), skipping rows past `nrows`.
template <int DN>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[DN / 8][4], float mult, int r0,
                                           int nrows, int head_dim, int t) {
#pragma unroll
  for (int dt = 0; dt < DN / 8; ++dt) {
    if (dt * 8 >= head_dim) break;  // head_dim is a multiple of 8
    const int cc = dt * 8 + t * 2;
    if (r0 < nrows) {
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * ss + cc) =
          pack_bf16x2(acc[dt][0] * mult, acc[dt][1] * mult);
    }
    if (r0 + 8 < nrows) {
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + 8) * ss + cc) =
          pack_bf16x2(acc[dt][2] * mult, acc[dt][3] * mult);
    }
  }
}

// The LSE (natural log) and delta of query rows [r0, r0 + ROWS) into
// s_stats[0, ROWS) and [ROWS, 2 * ROWS); zero past s_q.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_row_stats(float* s_stats, const float* lse,
                                               const float* delta, int r0, int s_q) {
  for (int i = threadIdx.x; i < 2 * ROWS; i += THREADS) {
    const int r = i % ROWS;
    const bool in = r0 + r < s_q;
    cp_async_4(s_stats + i, (i < ROWS ? lse : delta) + (in ? r0 + r : 0), in);
  }
}

// The bf16 bodies: each block owns kBwdRows rows (two warpgroups of 64) of
// two operands X0, X1 and streams BN-row tiles of two others, Y0, Y1,
// through a ring of kBwdStages shared-memory stages:
//   dK/dV (DKV): X = K, V (the K/V rows it owns), Y = Q, dO;
//     S^T = K Q^T, dP^T = V dO^T, P^T, dS^T; dV += P^T dO, dK += dS^T Q.
//   dQ: X = Q, dO, Y = K, V;  S = Q K^T, dP = dO V^T, P, dS;  dQ += dS K.
// Each warpgroup computes the first two products (64 x BN) with wgmma from
// shared memory (A = its 64 rows of X, K-major; B = the Y tile, K-major:
// the reduction runs over d), forms P and dS in the accumulator registers,
// packs them to bf16 as the register A operand of the output products, and
// takes the same Y tile again as B through an MN-major descriptor (the
// reduction runs over Y's rows). Every tile sits in shared memory once.
// The LSE and delta belong to the query rows: they come with the Q tile,
// in each ring stage for dK/dV (S^T's columns), with the owned tiles for dQ
// (S's rows, read into registers).
constexpr int kBwdGroups = 2;                // warpgroups per block
constexpr int kBwdRows = 64 * kBwdGroups;    // owned rows per block
constexpr int kBwdThreads = 128 * kBwdGroups;
constexpr int kBwdStages = 3;                // ring stages of streamed tiles
constexpr int kBwdAhead = kBwdStages - 1;    // tiles in flight ahead of the one in use

// Streamed rows per tile: 64, or 32 where dK/dV's two 64 x d fp32
// accumulators (d = 128) leave too few registers for 64-wide S^T and dP^T.
template <bool DKV, int DP>
__host__ __device__ constexpr int bwd_stream_rows() {
  return DKV && DP > 112 ? 32 : 64;
}

// Blocks per SM the registers are capped for: two for dQ up to d = 48
// (it fits in 128 registers, and two blocks of two warpgroups interleave
// one's exponentials with the other's products), one elsewhere.
template <bool DKV, int DP>
__host__ __device__ constexpr int bwd_min_blocks() {
  return !DKV && DP <= 48 ? 2 : 1;
}

template <bool DKV, int DP>
__host__ __device__ constexpr int bwd_smem_bytes() {
  constexpr int kBn = bwd_stream_rows<DKV, DP>();
  // X0, X1; the ring of Y0, Y1 tiles; the LSE and delta: per stage for
  // dK/dV, of the owned rows for dQ
  return 2 * kBwdRows * DP * 2 + kBwdStages * 2 * kBn * DP * 2 +
         (DKV ? kBwdStages * 2 * kBn * 4 : 2 * kBwdRows * 4);
}

// DP: d padded to 16 (the reduction of S and dP); DN: d padded to 8 (the
// width of the output products and their accumulators).
template <bool DKV, int DP, int DN>
__device__ __forceinline__ void attention_bwd_bf16_body(const BwdParams& p) {
  constexpr int kBn = bwd_stream_rows<DKV, DP>();
  constexpr int kStageElems = 2 * kBn * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s_x0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x1 = s_x0 + kBwdRows * DP;
  __nv_bfloat16* s_ring = s_x1 + kBwdRows * DP;
  float* s_stats = reinterpret_cast<float*>(s_ring + kBwdStages * kStageElems);

  const int group = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int own0 = blockIdx.x * kBwdRows;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + batch * p.do_sb + col0;
  const __nv_bfloat16* x0 = DKV ? k : q;
  const __nv_bfloat16* x1 = DKV ? v : dout;
  const __nv_bfloat16* y0 = DKV ? q : k;
  const __nv_bfloat16* y1 = DKV ? dout : v;
  const long long x0_ss = DKV ? p.k_ss : p.q_ss, x1_ss = DKV ? p.v_ss : p.do_ss;
  const long long y0_ss = DKV ? p.q_ss : p.k_ss, y1_ss = DKV ? p.do_ss : p.v_ss;
  const int own_n = DKV ? p.s_kv : p.s_q;
  const int stream_n = DKV ? p.s_q : p.s_kv;
  const int ntiles = (stream_n + kBn - 1) / kBn;
  const float* lse = lse_rows(p);
  const float* delta = delta_rows(p);
  const float c = p.scale_log2;

  const TileCopies<DP, kBn, kBwdThreads> stream_copies(p.head_dim);
  auto load_stage = [&](int tile) {
    __nv_bfloat16* y = s_ring + (tile % kBwdStages) * kStageElems;
    stream_copies.copy(y, y0, y0_ss, tile * kBn, stream_n);
    stream_copies.copy(y + kBn * DP, y1, y1_ss, tile * kBn, stream_n);
    if constexpr (DKV) {
      load_row_stats<kBn, kBwdThreads>(s_stats + (tile % kBwdStages) * 2 * kBn, lse, delta,
                                       tile * kBn, stream_n);
    }
  };
  // The owned tiles (and for dQ their rows' LSE and delta) land with the
  // first streamed tile (copy group 0).
  {
    const TileCopies<DP, kBwdRows, kBwdThreads> own_copies(p.head_dim);
    own_copies.copy(s_x0, x0, x0_ss, own0, own_n);
    own_copies.copy(s_x1, x1, x1_ss, own0, own_n);
    if constexpr (!DKV) load_row_stats<kBwdRows, kBwdThreads>(s_stats, lse, delta, own0, p.s_q);
  }
#pragma unroll
  for (int s = 0; s < kBwdAhead; ++s) {
    if (s < ntiles) load_stage(s);
    cp_async_commit();
  }

  float acc0[DN / 8][4], acc1[DN / 8][4];  // dK and dV, or dQ
#pragma unroll
  for (int i = 0; i < DN / 8; ++i) {
    acc0[i][0] = acc0[i][1] = acc0[i][2] = acc0[i][3] = 0.f;
    acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
  }
  // This warpgroup's 64 rows of X0 and X1, K-major.
  const uint64_t a0 = smem_desc(s_x0 + group * 64 * 8, kBwdRows * 16, 128);
  const uint64_t a1 = smem_desc(s_x1 + group * 64 * 8, kBwdRows * 16, 128);
  float s[kBn / 8][4], dp[kBn / 8][4];  // S (S^T) and dP (dP^T), 64 x kBn
  // dQ: LSE * log2(e) and delta of this thread's two query rows.
  float row_lse2[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};

  // P into s. Element e of n-tile j is row g (+ 8 for e >= 2) of the
  // warp's 16 and column j * 8 + 2t (+ 1 for odd e). Only the last tile
  // can be ragged.
  auto probabilities = [&](auto ragged, int n0, const float* st) {
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const bool in = !decltype(ragged)::value || n0 + col < stream_n;
        if constexpr (DKV) {  // the column is a query row
          const float lse2 = in ? st[col] * kLog2e : INFINITY;
          s[j][e] = exp2_approx(fmaf(s[j][e], c, -lse2));
        } else {  // the column is a K/V row
          s[j][e] = in ? exp2_approx(fmaf(s[j][e], c, -row_lse2[e >> 1])) : 0.f;
        }
      }
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    // Tile it has landed (the owned tiles with the first); every thread is
    // done with tile it - 1, whose stage takes tile it + kBwdAhead.
    cp_async_wait<kBwdAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + kBwdAhead < ntiles) load_stage(it + kBwdAhead);
    cp_async_commit();

    const int stage = it % kBwdStages;
    const __nv_bfloat16* s_y0 = s_ring + stage * kStageElems;
    const __nv_bfloat16* s_y1 = s_y0 + kBn * DP;
    const float* st = s_stats + stage * 2 * kBn;
    const int n0 = it * kBn;
    if constexpr (!DKV) {  // the owned rows' statistics have landed
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = group * 64 + warp * 16 + g + 8 * r;
        row_lse2[r] = own0 + row < p.s_q ? s_stats[row] * kLog2e : INFINITY;
        row_delta[r] = s_stats[kBwdRows + row];
      }
    }
    // S and dP, as two wgmma groups: the exponentials of P start when S
    // has landed, while dP is in the tensor cores.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<kBn>::ss(&s[0][0], desc_advance(a0, kk * 2 * kBwdRows * 16),
                     smem_desc(s_y0 + kk * 2 * kBn * 8, kBn * 16, 128), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<kBn>::ss(&dp[0][0], desc_advance(a1, kk * 2 * kBwdRows * 16),
                     smem_desc(s_y1 + kk * 2 * kBn * 8, kBn * 16, 128), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    if (n0 + kBn <= stream_n) {
      probabilities(Flag<false>(), n0, st);
    } else {
      probabilities(Flag<true>(), n0, st);
    }

    // The output products take P or dS in bf16 as their register A operand
    // (two adjacent accumulator n-tiles are one k16 fragment) and the
    // stage's Y1 or Y0 rows kk * 16.. as B, read MN-major. dK/dV issues
    // dV += P^T dO before it forms dS.
    if constexpr (DKV) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBn / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        Wgmma<DN>::template rs<kMnMajor>(&acc1[0][0], pa,  // dV += P^T dO
                                         smem_desc(s_y1 + kk * 16 * 8, 128, kBn * 16));
      }
      wgmma_commit();
    }
    wgmma_wait<DKV ? 1 : 0>();  // dP has landed
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {  // dS into dp
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dl = DKV ? st[kBn + j * 8 + t * 2 + (e & 1)] : row_delta[e >> 1];
        dp[j][e] = grad_logit(s[j][e], dp[j][e], dl);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBn / 16; ++kk) {  // dK += dS^T Q, or dQ += dS K
      const uint32_t dsa[4] = {
          pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      Wgmma<DN>::template rs<kMnMajor>(&acc0[0][0], dsa,
                                       smem_desc(s_y0 + kk * 16 * 8, 128, kBn * 16));
    }
    wgmma_commit();
    wgmma_wait<0>();  // the stage is done with
    fence_regs(acc0);
    fence_regs(acc1);
  }

  const int row = own0 + group * 64 + warp * 16 + g;
  const long long out_off = batch * p.g_sb + col0;
  store_rows<DN>(static_cast<__nv_bfloat16*>(p.g0) + out_off, p.g_ss, acc0, p.scale, row, own_n,
                 p.head_dim, t);
  if constexpr (DKV) {
    store_rows<DN>(static_cast<__nv_bfloat16*>(p.g1) + out_off, p.g_ss, acc1, 1.f, row, own_n,
                   p.head_dim, t);
  }
}

// dK/dV, bf16: one block of two warpgroups per (128-row K/V tile, head,
// batch row), looping over Q tiles; writes dK (times the scale) and dV.
template <int DP, int DN>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks<true, DP>())
    attention_dkv_bf16_kernel(const BwdParams p) {
  attention_bwd_bf16_body<true, DP, DN>(p);
}

// dQ, bf16: one block of two warpgroups per (128-row Q tile, head, batch
// row), looping over K/V tiles; writes dQ (times the scale).
template <int DP, int DN>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks<false, DP>())
    attention_dq_bf16_kernel(const BwdParams p) {
  attention_bwd_bf16_body<false, DP, DN>(p);
}

// fp32 dK/dV: one thread per K/V row (ROWS per block), 32-row Q tiles
// staged in shared memory, plain FMAs.
template <int DP, int ROWS>
__global__ void __launch_bounds__(ROWS) attention_dkv_f32_kernel(const BwdParams p) {
  __shared__ float s_q[kF32TileN][DP];
  __shared__ float s_do[kF32TileN][DP];
  __shared__ float s_lse2[kF32TileN];
  __shared__ float s_delta[kF32TileN];

  const int row = blockIdx.x * ROWS + threadIdx.x;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + batch * p.q_sb + col0;
  const float* k = static_cast<const float*>(p.k) + batch * p.k_sb + col0;
  const float* v = static_cast<const float*>(p.v) + batch * p.v_sb + col0;
  const float* dout = static_cast<const float*>(p.dout) + batch * p.do_sb + col0;
  const float* lse = lse_rows(p);
  const float* delta = delta_rows(p);
  const float c = p.scale_log2;

  float kr[DP], vr[DP], dk[DP], dv[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const bool in = row < p.s_kv && i < p.head_dim;
    kr[i] = in ? k[(long long)row * p.k_ss + i] : 0.f;
    vr[i] = in ? v[(long long)row * p.v_ss + i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  for (int m0 = 0; m0 < p.s_q; m0 += kF32TileN) {
    for (int idx = threadIdx.x; idx < kF32TileN * DP; idx += ROWS) {
      const int r = idx / DP;
      const int i = idx % DP;
      const bool in = m0 + r < p.s_q && i < p.head_dim;
      s_q[r][i] = in ? q[(long long)(m0 + r) * p.q_ss + i] : 0.f;
      s_do[r][i] = in ? dout[(long long)(m0 + r) * p.do_ss + i] : 0.f;
    }
    stage_row_stats<kF32TileN>(s_lse2, s_delta, lse, delta, m0, p.s_q);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kF32TileN; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(kr[i], s_q[j][i], s);
        dp = fmaf(vr[i], s_do[j][i], dp);
      }
      const float prob = exp2f(fmaf(s, c, -s_lse2[j]));
      const float ds = grad_logit(prob, dp, s_delta[j]);
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dv[i] = fmaf(prob, s_do[j][i], dv[i]);
        dk[i] = fmaf(ds, s_q[j][i], dk[i]);
      }
    }
    __syncthreads();
  }
  if (row < p.s_kv) {
    float* gk = static_cast<float*>(p.g0) + batch * p.g_sb + col0 + (long long)row * p.g_ss;
    float* gv = static_cast<float*>(p.g1) + batch * p.g_sb + col0 + (long long)row * p.g_ss;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      if (i < p.head_dim) {
        gk[i] = dk[i] * p.scale;
        gv[i] = dv[i];
      }
    }
  }
}

// fp32 dQ: one thread per query row (ROWS per block), 32-row K/V tiles
// staged in shared memory, plain FMAs.
template <int DP, int ROWS>
__global__ void __launch_bounds__(ROWS) attention_dq_f32_kernel(const BwdParams p) {
  __shared__ float s_k[kF32TileN][DP];
  __shared__ float s_v[kF32TileN][DP];

  const int row = blockIdx.x * ROWS + threadIdx.x;
  const bool row_in = row < p.s_q;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + batch * p.q_sb + col0;
  const float* k = static_cast<const float*>(p.k) + batch * p.k_sb + col0;
  const float* v = static_cast<const float*>(p.v) + batch * p.v_sb + col0;
  const float* dout = static_cast<const float*>(p.dout) + batch * p.do_sb + col0;
  const float c = p.scale_log2;
  const float lse2 = row_in ? lse_rows(p)[row] * kLog2e : INFINITY;
  const float dl = row_in ? delta_rows(p)[row] : 0.f;

  float qr[DP], dr[DP], dq[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const bool in = row_in && i < p.head_dim;
    qr[i] = in ? q[(long long)row * p.q_ss + i] : 0.f;
    dr[i] = in ? dout[(long long)row * p.do_ss + i] : 0.f;
    dq[i] = 0.f;
  }
  for (int n0 = 0; n0 < p.s_kv; n0 += kF32TileN) {
    for (int idx = threadIdx.x; idx < kF32TileN * DP; idx += ROWS) {
      const int r = idx / DP;
      const int i = idx % DP;
      const bool in = n0 + r < p.s_kv && i < p.head_dim;
      s_k[r][i] = in ? k[(long long)(n0 + r) * p.k_ss + i] : 0.f;
      s_v[r][i] = in ? v[(long long)(n0 + r) * p.v_ss + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kF32TileN; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(qr[i], s_k[j][i], s);
        dp = fmaf(dr[i], s_v[j][i], dp);
      }
      const float prob = n0 + j < p.s_kv ? exp2f(fmaf(s, c, -lse2)) : 0.f;
      const float ds = grad_logit(prob, dp, dl);
#pragma unroll
      for (int i = 0; i < DP; ++i) dq[i] = fmaf(ds, s_k[j][i], dq[i]);
    }
    __syncthreads();
  }
  if (row_in) {
    float* out = static_cast<float*>(p.g0) + batch * p.g_sb + col0 + (long long)row * p.g_ss;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      if (i < p.head_dim) out[i] = dq[i] * p.scale;
    }
  }
}

enum class BwdKernel { kDkv, kDq };

template <BwdKernel KIND, int DP, int DN>
cudaError_t launch_bwd(const BwdParams& p, int dtype, int batch, int num_heads,
                       cudaStream_t stream) {
  constexpr bool kDkv = KIND == BwdKernel::kDkv;
  const int rows = kDkv ? p.s_kv : p.s_q;
  if (dtype == 1) {
    const dim3 grid((rows + kBwdTile - 1) / kBwdTile, num_heads, batch);
    if constexpr (kDkv) {
      attention_dkv_f32_kernel<DP, kBwdTile><<<grid, kBwdTile, 0, stream>>>(p);
    } else {
      attention_dq_f32_kernel<DP, kBwdTile><<<grid, kBwdTile, 0, stream>>>(p);
    }
    return cudaGetLastError();
  }
  // above 48 KB a block's dynamic shared memory must be asked for
  constexpr int smem = bwd_smem_bytes<kDkv, DP>();
  void (*kernel)(const BwdParams);
  if constexpr (kDkv) {
    kernel = attention_dkv_bf16_kernel<DP, DN>;
  } else {
    kernel = attention_dq_bf16_kernel<DP, DN>;
  }
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((rows + kBwdRows - 1) / kBwdRows, num_heads, batch);
  kernel<<<grid, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The body of both C entry points. Pointers: q, k, v, dO in the packed
// (b, s, h*d) layout read through their strides; lse and delta (b, h, s_q)
// fp32; g0/g1 the outputs (dQ, or dK and dV) in one packed layout.
// dtype: 0 = bfloat16, 1 = float32. Returns a cudaError_t value: 0 when the
// launch was accepted.
template <BwdKernel KIND>
int attention_backward(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* g0, void* g1, long long q_sb,
                       long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                       long long v_ss, long long do_sb, long long do_ss, long long g_sb,
                       long long g_ss, int batch, int s_q, int s_kv, int num_heads,
                       int head_dim, float scale, int dtype, int device, void* stream) {
  if (batch <= 0 || s_q <= 0 || s_kv <= 0 || num_heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1) || batch > 65535 ||
      num_heads > 65535 || (KIND == BwdKernel::kDkv && g1 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdParams p{q,     k,     v,    dout, lse, delta, g0,       g1,    q_sb,
                    q_ss,  k_sb,  k_ss, v_sb, v_ss, do_sb, do_ss,   g_sb,  g_ss,
                    s_q,   s_kv,  head_dim,   scale, scale * kLog2e};
  // the library's own CUDA runtime: select the operands' device first
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return (int)launch_bwd<KIND, 16, 16>(p, dtype, batch, num_heads, st);
    case 32: return (int)launch_bwd<KIND, 32, 32>(p, dtype, batch, num_heads, st);
    case 48:  // d = 40 (the fine-tuning path's seq-4096 sites) keeps 40-wide outputs
      return head_dim == 40 ? (int)launch_bwd<KIND, 48, 40>(p, dtype, batch, num_heads, st)
                            : (int)launch_bwd<KIND, 48, 48>(p, dtype, batch, num_heads, st);
    case 64: return (int)launch_bwd<KIND, 64, 64>(p, dtype, batch, num_heads, st);
    case 80: return (int)launch_bwd<KIND, 80, 80>(p, dtype, batch, num_heads, st);
    case 96: return (int)launch_bwd<KIND, 96, 96>(p, dtype, batch, num_heads, st);
    case 112: return (int)launch_bwd<KIND, 112, 112>(p, dtype, batch, num_heads, st);
    case 128: return (int)launch_bwd<KIND, 128, 128>(p, dtype, batch, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace riff
