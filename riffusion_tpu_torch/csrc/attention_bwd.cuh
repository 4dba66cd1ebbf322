// The backward of K1's attention, O = softmax(Q K^T * scale) V, over packed
// (b, s, h*d) operands: the two kernel bodies (dK/dV and dQ) that
// attention_dkv.cu and attention_dq.cu launch, their fp32 instances for
// checks, and what both share. The helpers of attention_common.cuh (the
// m16n8k16 product, the staging of packed rows) are reused.
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
// The split mirrors the TPU kernels' (jax's pallas flash_attention
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq): the dK/dV kernel owns
// a K/V tile and loops over Q tiles, the dQ kernel owns a Q tile and loops
// over K/V tiles, so each output row is written by one block and no atomics
// are needed. A ragged s_q is masked by an infinite LSE (P = 0) and zero
// rows; a ragged s_kv by zero rows (dQ) and by not writing past s_kv (dK/dV).

#pragma once

#include "attention_common.cuh"

namespace riff {

constexpr int kBwdTile = 64;  // rows per block and per streamed tile (bf16)

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

// One 16 x 64 fp32 tile of X Y^T for this warp: X is 16 rows of a
// [rows][DP + 8] bf16 shared-memory array starting at `x`, Y the 64 rows of
// another such array starting at `y`.
template <int DP>
__device__ __forceinline__ void tile_xyt(float (&acc)[kBwdTile / 8][4], const __nv_bfloat16* x,
                                         const __nv_bfloat16* y, int g, int t) {
  constexpr int kLd = DP + 8;
#pragma unroll
  for (int nt = 0; nt < kBwdTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* a = x + g * kLd + kk * 16 + t * 2;
    const uint32_t af[4] = {
        *reinterpret_cast<const uint32_t*>(a), *reinterpret_cast<const uint32_t*>(a + 8 * kLd),
        *reinterpret_cast<const uint32_t*>(a + 8),
        *reinterpret_cast<const uint32_t*>(a + 8 * kLd + 8)};
#pragma unroll
    for (int nt = 0; nt < kBwdTile / 8; ++nt) {
      const __nv_bfloat16* b = y + (nt * 8 + g) * kLd + kk * 16 + t * 2;
      mma_16816(acc[nt], af, *reinterpret_cast<const uint32_t*>(b),
                *reinterpret_cast<const uint32_t*>(b + 8));
    }
  }
}

// acc (16 x DP) += W Z, with W this warp's 16 x 64 fp32 tile (rounded to
// bf16 here; two adjacent accumulator tiles form one A fragment) and Z a
// 64 x DP operand stored transposed in shared memory as [DP][64 + 8].
template <int DP>
__device__ __forceinline__ void tile_acc_wz(float (&acc)[DP / 8][4],
                                            const float (&w)[kBwdTile / 8][4],
                                            const __nv_bfloat16* zt, int g, int t) {
  constexpr int kLdT = kBwdTile + 8;
#pragma unroll
  for (int j = 0; j < kBwdTile / 16; ++j) {
    const uint32_t wa[4] = {pack_bf16x2(w[2 * j][0], w[2 * j][1]),
                            pack_bf16x2(w[2 * j][2], w[2 * j][3]),
                            pack_bf16x2(w[2 * j + 1][0], w[2 * j + 1][1]),
                            pack_bf16x2(w[2 * j + 1][2], w[2 * j + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const __nv_bfloat16* b = zt + (dt * 8 + g) * kLdT + j * 16 + t * 2;
      mma_16816(acc[dt], wa, *reinterpret_cast<const uint32_t*>(b),
                *reinterpret_cast<const uint32_t*>(b + 8));
    }
  }
}

// Write this warp's 16 x DP fp32 accumulator (times `mult`) as bf16 rows
// r0 and r0 + 8 (this thread's), skipping rows past `nrows`.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[DP / 8][4], float mult, int r0,
                                           int nrows, int head_dim, int t) {
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
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

template <int DP>
constexpr int dkv_smem_bytes() {
  // K, V, Q, dO as [64][DP + 8]; Q^T and dO^T as [DP][64 + 8]; LSE, delta
  return (4 * kBwdTile * (DP + 8) + 2 * DP * (kBwdTile + 8)) * 2 + 2 * kBwdTile * 4;
}

// dK/dV, bf16: one block of 4 warps per (64-row K/V tile, head, batch row);
// each warp owns 16 K/V rows. The block stages its K and V tile once, then
// loops over 64-row Q tiles: for each it stages Q and dO (and both
// transposed) with their LSE and delta rows, and each warp forms, for its
// rows, S^T = K Q^T, P^T, dP^T = V dO^T and dS^T, and accumulates
// dV += P^T dO and dK += dS^T Q in fp32 registers.
template <int DP>
__global__ void __launch_bounds__(128) attention_dkv_bf16_kernel(const BwdParams p) {
  constexpr int kLd = DP + 8;
  constexpr int kLdT = kBwdTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + kBwdTile * kLd;
  __nv_bfloat16* s_q = s_v + kBwdTile * kLd;
  __nv_bfloat16* s_do = s_q + kBwdTile * kLd;
  __nv_bfloat16* s_qt = s_do + kBwdTile * kLd;
  __nv_bfloat16* s_dot = s_qt + DP * kLdT;
  float* s_lse2 = reinterpret_cast<float*>(s_dot + DP * kLdT);
  float* s_delta = s_lse2 + kBwdTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBwdTile;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + batch * p.do_sb + col0;
  const float* lse = lse_rows(p);
  const float* delta = delta_rows(p);
  const float c = p.scale_log2;

  stage_rows<DP, kBwdTile, 128>(s_k, k, p.k_ss, n0, p.s_kv, p.head_dim);
  stage_rows<DP, kBwdTile, 128>(s_v, v, p.v_ss, n0, p.s_kv, p.head_dim);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const __nv_bfloat16* k_rows = s_k + warp * 16 * kLd;
  const __nv_bfloat16* v_rows = s_v + warp * 16 * kLd;

  for (int m0 = 0; m0 < p.s_q; m0 += kBwdTile) {
    stage_rows<DP, kBwdTile, 128>(s_q, q, p.q_ss, m0, p.s_q, p.head_dim);
    stage_rows<DP, kBwdTile, 128>(s_do, dout, p.do_ss, m0, p.s_q, p.head_dim);
    stage_rows_transposed<DP, kBwdTile, 128>(s_qt, q, p.q_ss, m0, p.s_q, p.head_dim);
    stage_rows_transposed<DP, kBwdTile, 128>(s_dot, dout, p.do_ss, m0, p.s_q, p.head_dim);
    stage_row_stats<kBwdTile>(s_lse2, s_delta, lse, delta, m0, p.s_q);
    __syncthreads();

    // Rows are this warp's K/V rows, columns the tile's 64 query rows.
    float pt[kBwdTile / 8][4], dst[kBwdTile / 8][4];
    tile_xyt<DP>(pt, k_rows, s_q, g, t);    // S^T
    tile_xyt<DP>(dst, v_rows, s_do, g, t);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kBwdTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        pt[nt][e] = exp2f(fmaf(pt[nt][e], c, -s_lse2[col]));
        dst[nt][e] = grad_logit(pt[nt][e], dst[nt][e], s_delta[col]);
      }
    }
    tile_acc_wz<DP>(dv, pt, s_dot, g, t);   // dV += P^T dO
    tile_acc_wz<DP>(dk, dst, s_qt, g, t);   // dK += dS^T Q
    __syncthreads();
  }

  const int row = n0 + warp * 16 + g;
  const long long out_off = batch * p.g_sb + col0;
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.g0) + out_off, p.g_ss, dk, p.scale, row, p.s_kv,
                 p.head_dim, t);
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.g1) + out_off, p.g_ss, dv, 1.f, row, p.s_kv,
                 p.head_dim, t);
}

template <int DP>
constexpr int dq_smem_bytes() {
  // K, V as [64][DP + 8] (Q and dO pass through them first); K^T as
  // [DP][64 + 8]
  return (2 * kBwdTile * (DP + 8) + DP * (kBwdTile + 8)) * 2;
}

// dQ, bf16: one block of 4 warps per (64-row Q tile, head, batch row); each
// warp owns 16 query rows and keeps their Q and dO as mma A fragments in
// registers, with their LSE and delta. The block loops over 64-row K/V
// tiles: S = Q K^T, P, dP = dO V^T, dS, and dQ += dS K.
template <int DP>
__global__ void __launch_bounds__(128) attention_dq_bf16_kernel(const BwdParams p) {
  constexpr int kLd = DP + 8;
  constexpr int kLdT = kBwdTile + 8;
  constexpr int kKSteps = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + kBwdTile * kLd;
  __nv_bfloat16* s_kt = s_v + kBwdTile * kLd;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kBwdTile;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + batch * p.do_sb + col0;
  const float c = p.scale_log2;

  // Q and dO rows -> shared memory (the K and V buffers) -> A fragments.
  stage_rows<DP, kBwdTile, 128>(s_k, q, p.q_ss, m0, p.s_q, p.head_dim);
  stage_rows<DP, kBwdTile, 128>(s_v, dout, p.do_ss, m0, p.s_q, p.head_dim);
  __syncthreads();
  uint32_t qa[kKSteps][4], da[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int off = (warp * 16 + g) * kLd + kk * 16 + t * 2;
    const __nv_bfloat16* a = s_k + off;
    const __nv_bfloat16* b = s_v + off;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(a);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(a + 8 * kLd);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(a + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(a + 8 * kLd + 8);
    da[kk][0] = *reinterpret_cast<const uint32_t*>(b);
    da[kk][1] = *reinterpret_cast<const uint32_t*>(b + 8 * kLd);
    da[kk][2] = *reinterpret_cast<const uint32_t*>(b + 8);
    da[kk][3] = *reinterpret_cast<const uint32_t*>(b + 8 * kLd + 8);
  }
  __syncthreads();

  // This thread's two query rows: g and g + 8 of the warp's 16.
  const int row = m0 + warp * 16 + g;
  const float* lse = lse_rows(p);
  const float* delta = delta_rows(p);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < p.s_q;
    lse2[r] = in ? lse[row + 8 * r] * kLog2e : INFINITY;
    dl[r] = in ? delta[row + 8 * r] : 0.f;
  }

  float dq[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int n0 = 0; n0 < p.s_kv; n0 += kBwdTile) {
    stage_rows<DP, kBwdTile, 128>(s_k, k, p.k_ss, n0, p.s_kv, p.head_dim);
    stage_rows<DP, kBwdTile, 128>(s_v, v, p.v_ss, n0, p.s_kv, p.head_dim);
    stage_rows_transposed<DP, kBwdTile, 128>(s_kt, k, p.k_ss, n0, p.s_kv, p.head_dim);
    __syncthreads();

    float s[kBwdTile / 8][4], ds[kBwdTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBwdTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* kb = s_k + (nt * 8 + g) * kLd + kk * 16 + t * 2;
        const __nv_bfloat16* vb = s_v + (nt * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kb),
                  *reinterpret_cast<const uint32_t*>(kb + 8));
        mma_16816(ds[nt], da[kk], *reinterpret_cast<const uint32_t*>(vb),
                  *reinterpret_cast<const uint32_t*>(vb + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool in = n0 + nt * 8 + t * 2 + (e & 1) < p.s_kv;
        const float prob = in ? exp2f(fmaf(s[nt][e], c, -lse2[r])) : 0.f;
        ds[nt][e] = grad_logit(prob, ds[nt][e], dl[r]);
      }
    }
    tile_acc_wz<DP>(dq, ds, s_kt, g, t);  // dQ += dS K
    __syncthreads();
  }

  store_rows<DP>(static_cast<__nv_bfloat16*>(p.g0) + batch * p.g_sb + col0, p.g_ss, dq, p.scale,
                 row, p.s_q, p.head_dim, t);
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

template <BwdKernel KIND, int DP>
cudaError_t launch_bwd(const BwdParams& p, int dtype, int batch, int num_heads,
                       cudaStream_t stream) {
  constexpr bool kDkv = KIND == BwdKernel::kDkv;
  const int rows = kDkv ? p.s_kv : p.s_q;
  const dim3 grid((rows + kBwdTile - 1) / kBwdTile, num_heads, batch);
  if (dtype == 1) {
    if constexpr (kDkv) {
      attention_dkv_f32_kernel<DP, kBwdTile><<<grid, kBwdTile, 0, stream>>>(p);
    } else {
      attention_dq_f32_kernel<DP, kBwdTile><<<grid, kBwdTile, 0, stream>>>(p);
    }
    return cudaGetLastError();
  }
  // above 48 KB a block's dynamic shared memory must be asked for
  if constexpr (kDkv) {
    constexpr int smem = dkv_smem_bytes<DP>();
    const cudaError_t set = cudaFuncSetAttribute(
        attention_dkv_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
    attention_dkv_bf16_kernel<DP><<<grid, 128, smem, stream>>>(p);
  } else {
    constexpr int smem = dq_smem_bytes<DP>();
    const cudaError_t set = cudaFuncSetAttribute(
        attention_dq_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
    attention_dq_bf16_kernel<DP><<<grid, 128, smem, stream>>>(p);
  }
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
    case 16: return (int)launch_bwd<KIND, 16>(p, dtype, batch, num_heads, st);
    case 32: return (int)launch_bwd<KIND, 32>(p, dtype, batch, num_heads, st);
    case 48: return (int)launch_bwd<KIND, 48>(p, dtype, batch, num_heads, st);
    case 64: return (int)launch_bwd<KIND, 64>(p, dtype, batch, num_heads, st);
    case 80: return (int)launch_bwd<KIND, 80>(p, dtype, batch, num_heads, st);
    case 96: return (int)launch_bwd<KIND, 96>(p, dtype, batch, num_heads, st);
    case 112: return (int)launch_bwd<KIND, 112>(p, dtype, batch, num_heads, st);
    case 128: return (int)launch_bwd<KIND, 128>(p, dtype, batch, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace riff
