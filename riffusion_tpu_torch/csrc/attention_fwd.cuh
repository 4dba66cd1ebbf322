// The bf16 forward body for Hopper (sm_90a) of both forward kernels,
// O = softmax(Q K^T * scale) V over packed (b, s, h*d) operands:
// attention_fwd_bf16_kernel, and the host code that launches it. K1
// (attention.cu) launches it with the log-sum-exp write when training asks
// for it, K2 (row_attention.cu) without; both with two warpgroups per block
// (attention.cu gives the times of one against two). Their fp32
// check instances are attention_common.cuh's attention_f32_kernel. The
// Hopper building blocks (cp.async tile copies, descriptors, wgmma, ex2) are
// in hopper.cuh.
//
// The arithmetic: fp32 logits; an online softmax over 64-row K/V tiles in
// fp32 in the log2 domain, the running max kept in logit units and the
// scale*log2(e) fold c entering each exp2 argument through one FFMA
// (s * c - m * c); P rounded to bf16 unnormalized for P V; fp32
// accumulation; the division by the row sum once, on the output. exp2 is
// the SFU's ex2.approx (relative error about 2^-22). The CPU emulation of
// the kernels (tests/test_torch_attention.py _kernel_numerics) rounds at
// these same points.
//
// The log-sum-exp (template argument LSE): after the row sums, each row's
// natural-log LSE, log sum_j exp(scale * q.k_j) = scale * m + log(row sum),
// goes to p.lse as fp32, (batch, heads, s_q) contiguous: what the backward
// kernels (attention_bwd.cuh) read. The serving instances have no write.
//
// The design (its parts are those of attention_bwd.cuh's dQ body, which has
// the same shape: owned query rows, K and V streamed):
// - One block of GROUPS warpgroups (1 or 2) per (64 * GROUPS-row query
//   tile, head, batch row), each warpgroup owning 64 query rows. The grid
//   runs the query tile fastest, then the head, then the batch row, so the
//   blocks in flight share one batch row's K/V in L2. Two warpgroups halve
//   the K/V copies per query row; one gives twice the blocks, and lost at
//   every shape of K1's paths all the same.
// - Q is copied once by cp.async into wgmma's no-swizzle core-matrix layout
//   and lands with the first K/V tile. d is zero-filled to DP (a multiple
//   of 16: 40 -> 48) by the copies, never loaded from the next head.
// - K and V come through a 3-stage cp.async ring, two tiles ahead of the
//   one in the products, with each thread's copy slots worked out once:
//   one wait and one barrier per tile.
// - S = Q K^T is wgmma m64n64k16 from shared memory, this warpgroup's Q rows
//   and the K tile both K-major, DP / 16 k-steps. Q's descriptor steps over
//   the block's 64 * GROUPS rows between its 8-column chunks.
// - The softmax runs on the S accumulators in registers. Only the last tile
//   can be ragged, and only it is masked.
// - O += P V is wgmma with P, packed to bf16 from the S accumulators, as the
//   register A operand, and B the V tile as it was copied, row-major, read
//   MN-major through its descriptor: no transposed copy. Its width DN is d
//   rounded up to 8 (40 at d = 40, not 48).
// - At d = 40 a two-warpgroup block fits in 80 registers, so three blocks
//   share an SM (five of one warpgroup, which shared memory then limits),
//   and one block's exponentials run while another's products do.
// Tried on the card and dropped (slower in the same call): two blocks per
// SM at d = 40; the next tile's S in the tensor cores while this tile's
// exponentials run (FA3's overlap inside a warpgroup, with a second set of
// S accumulators, 120 registers); the previous tile's P V in the tensor
// cores during them. No TMA, warp specialisation or clusters yet.

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace riff {

constexpr int kFwdTileN = 64;              // K/V rows per streamed tile
constexpr int kFwdStages = 3;              // ring stages of K/V tiles
constexpr int kFwdAhead = kFwdStages - 1;  // tiles in flight ahead of the one in use

// Q, then the ring of (K, V) tile pairs, for GROUPS warpgroups per block.
template <int DP, int GROUPS>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (64 * GROUPS * DP + kFwdStages * 2 * kFwdTileN * DP) * 2;
}

// Blocks per SM the registers are capped for. Two warpgroups: three where
// P V is at most 40 wide (80 registers a thread; at DN = 48 that cap
// spills), two up to d = 64 (128), one above. One warpgroup: as many as
// shared memory holds (227 KB an SM): five at d = 40 (102 registers),
// three up to d = 80 (170), two above.
template <int DP, int DN, int GROUPS>
__host__ __device__ constexpr int fwd_min_blocks() {
  if (GROUPS == 2) return DN <= 40 ? 3 : DP <= 64 ? 2 : 1;
  return DN <= 40 ? 5 : DP <= 80 ? 3 : 2;
}

// DP: d padded to 16 (the reduction of S); DN: d padded to 8 (the width of
// P V and of its accumulator); GROUPS: warpgroups per block, 64 query rows
// each; LSE: write the rows' log-sum-exp to p.lse.
template <int DP, int DN, int GROUPS, bool LSE>
__global__ void __launch_bounds__(128 * GROUPS, fwd_min_blocks<DP, DN, GROUPS>())
    attention_fwd_bf16_kernel(const Params p) {
  constexpr int kRows = 64 * GROUPS;  // query rows per block
  constexpr int kThreads = 128 * GROUPS;
  constexpr int kStageElems = 2 * kFwdTileN * DP;  // K, then V
  constexpr int kNTiles = kFwdTileN / 8;           // n-tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_ring = s_q + kRows * DP;

  const int group = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  const int ntiles = (p.s_kv + kFwdTileN - 1) / kFwdTileN;
  const float c = p.scale_log2;

  // Each thread's copy slots; the chunks past head_dim are zero-filled.
  const TileCopies<DP, kFwdTileN, kThreads> kv_copies(p.head_dim);
  const TileCopies<DP, kRows, kThreads> q_copies(p.head_dim);
  auto load_stage = [&](int tile) {
    __nv_bfloat16* s_k = s_ring + (tile % kFwdStages) * kStageElems;
    kv_copies.copy(s_k, k, p.k_ss, tile * kFwdTileN, p.s_kv);
    kv_copies.copy(s_k + kFwdTileN * DP, v, p.v_ss, tile * kFwdTileN, p.s_kv);
  };
  q_copies.copy(s_q, q, p.q_ss, m0, p.s_q);  // lands with the first tile (copy group 0)
#pragma unroll
  for (int s = 0; s < kFwdAhead; ++s) {
    if (s < ntiles) load_stage(s);
    cp_async_commit();
  }

  // This warpgroup's 64 rows of Q, K-major: the block's next 8-column chunk
  // is kRows rows on.
  const uint64_t qa = smem_desc(s_q + group * 64 * 8, kRows * 16, 128);
  float acc[DN / 8][4];  // O, unnormalized
#pragma unroll
  for (int i = 0; i < DN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float s[kNTiles][4];  // S, then P: this warpgroup's 64 rows x the tile's 64 columns
  // Each thread holds two query rows: g (elements 0, 1) and g + 8 (2, 3).
  float row_max[2] = {-INFINITY, -INFINITY};  // logit units
  float row_sum[2] = {0.f, 0.f};              // partial, over this thread's columns

  // P into s, the running max and sum moved on, and O rescaled to the new
  // max. Element e of n-tile j is row g (+ 8 for e >= 2) of the warp's 16
  // and column j * 8 + 2t (+ 1 for odd e). Only the last tile can be
  // ragged: its columns past s_kv get logit -inf.
  auto softmax = [&](auto ragged, int n0) {
    if constexpr (decltype(ragged)::value) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + j * 8 + t * 2 + (e & 1) >= p.s_kv) s[j][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // Column n0 is always in range, so mx is finite from the first tile on
    // (and alpha 0 there).
    const float alpha[2] = {exp2_approx((row_max[0] - mx[0]) * c),
                            exp2_approx((row_max[1] - mx[1]) * c)};
    const float mc[2] = {mx[0] * c, mx[1] * c};
    row_max[0] = mx[0];
    row_max[1] = mx[1];
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(fmaf(s[j][e], c, -mc[e >> 1]));
        part[e >> 1] += s[j][e];
      }
    }
    row_sum[0] = row_sum[0] * alpha[0] + part[0];
    row_sum[1] = row_sum[1] * alpha[1] + part[1];
#pragma unroll
    for (int i = 0; i < DN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];  // O to the new max
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    // Tile it has landed (Q with the first); every thread is done with tile
    // it - 1, whose stage takes tile it + kFwdAhead.
    cp_async_wait<kFwdAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + kFwdAhead < ntiles) load_stage(it + kFwdAhead);
    cp_async_commit();

    const __nv_bfloat16* s_k = s_ring + (it % kFwdStages) * kStageElems;
    const __nv_bfloat16* s_v = s_k + kFwdTileN * DP;
    const int n0 = it * kFwdTileN;
    wgmma_fence();  // S = Q K^T
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<kFwdTileN>::ss(&s[0][0], desc_advance(qa, kk * 2 * kRows * 16),
                           smem_desc(s_k + kk * 2 * kFwdTileN * 8, kFwdTileN * 16, 128), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (n0 + kFwdTileN <= p.s_kv) {
      softmax(Flag<false>(), n0);
    } else {
      softmax(Flag<true>(), n0);
    }

    // O += P V: P in bf16 as the register A operand (two adjacent S n-tiles
    // are one k16 fragment), the V tile's rows kk * 16.. as B, read MN-major.
    // All of P is packed before the first product: a register written
    // between two wgmma of one group makes ptxas fence the second.
    uint32_t pa[kFwdTileN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kFwdTileN / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdTileN / 16; ++kk) {
      Wgmma<DN>::template rs<kMnMajor>(&acc[0][0], pa[kk],
                                       smem_desc(s_v + kk * 16 * 8, 128, kFwdTileN * 16));
    }
    wgmma_commit();
    wgmma_wait<0>();  // the stage is done with
    fence_regs(acc);
  }

  // Full row sums across the 4 threads of each row group; with LSE each
  // row's log-sum-exp, then the one division, on the (rows, DN) output;
  // bf16 written for the columns below head_dim and the rows below s_q.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const int row = m0 + group * 64 + warp * 16 + g;
  if constexpr (LSE) {
    if (t == 0) {
      // log sum_j exp(scale * s_j) = scale * m + log(sum_j exp2((s_j - m) * c))
      float* lse = p.lse + ((long long)batch * gridDim.y + blockIdx.y) * p.s_q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r < p.s_q) lse[row + 8 * r] = fmaf(row_max[r], p.scale, logf(row_sum[r]));
      }
    }
  }
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + batch * p.o_sb + col0;
#pragma unroll
  for (int dt = 0; dt < DN / 8; ++dt) {
    if (dt * 8 >= p.head_dim) break;  // head_dim is a multiple of 8
    const int cc = dt * 8 + t * 2;
    if (row < p.s_q) {
      *reinterpret_cast<uint32_t*>(o + (long long)row * p.o_ss + cc) =
          pack_bf16x2(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    }
    if (row + 8 < p.s_q) {
      *reinterpret_cast<uint32_t*>(o + (long long)(row + 8) * p.o_ss + cc) =
          pack_bf16x2(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
    }
  }
}

// The instance for one padded width: bf16 (dtype 0) or the fp32 check
// instance (1, which writes the log-sum-exp when p.lse is set), on a grid
// of (64 * GROUPS-row query tiles, heads, batch rows). Returns the launch's
// cudaError_t, or the refusal of its dynamic shared memory.
template <int DP, int DN, int GROUPS, bool LSE>
cudaError_t launch_fwd(const Params& p, int dtype, int batch, int num_heads,
                       cudaStream_t stream) {
  constexpr int rows = 64 * GROUPS;
  const dim3 grid((p.s_q + rows - 1) / rows, num_heads, batch);
  if (dtype == 1) {
    attention_f32_kernel<DP, rows><<<grid, rows, 0, stream>>>(p);
    return cudaGetLastError();
  }
  // above 48 KB a block's dynamic shared memory must be asked for
  constexpr int smem = fwd_smem_bytes<DP, GROUPS>();
  const cudaError_t set =
      cudaFuncSetAttribute(attention_fwd_bf16_kernel<DP, DN, GROUPS, LSE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  attention_fwd_bf16_kernel<DP, DN, GROUPS, LSE><<<grid, 128 * GROUPS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launches the instance for the padded head width of checked parameters
// (fwd_params). Returns a cudaError_t value: 0 when the launch was accepted.
template <int GROUPS, bool LSE>
int fwd_launch(const Params& p, int dtype, int batch, int num_heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((p.head_dim + 15) / 16 * 16) {
    case 16: return (int)launch_fwd<16, 16, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 32: return (int)launch_fwd<32, 32, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 48:  // d = 40 (the seq-4096 sites) runs P V 40 wide
      return p.head_dim == 40
                 ? (int)launch_fwd<48, 40, GROUPS, LSE>(p, dtype, batch, num_heads, st)
                 : (int)launch_fwd<48, 48, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 64: return (int)launch_fwd<64, 64, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 80: return (int)launch_fwd<80, 80, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 96: return (int)launch_fwd<96, 96, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 112: return (int)launch_fwd<112, 112, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    case 128: return (int)launch_fwd<128, 128, GROUPS, LSE>(p, dtype, batch, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The first half of both forward entry points: checks their arguments into
// `p` (make_params) and selects the operands' device. dtype: 0 = bfloat16,
// 1 = float32; strides are in elements; `lse` is null or a (batch, heads,
// s_q) fp32 buffer. Returns a cudaError_t value: 0 when fwd_launch may go on.
inline int fwd_params(Params& p, const void* q, const void* k, const void* v, void* o,
                      float* lse, long long q_sb, long long q_ss, long long k_sb,
                      long long k_ss, long long v_sb, long long v_ss, long long o_sb,
                      long long o_ss, int batch, int s_q, int s_kv, int num_heads, int head_dim,
                      float scale, int dtype, int device) {
  if (!make_params(p, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, batch,
                   s_q, s_kv, num_heads, head_dim, scale, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  // Each library carries its own (static) CUDA runtime, whose current device
  // is not PyTorch's: select the operands' device before launching.
  return (int)cudaSetDevice(device);
}

}  // namespace riff
