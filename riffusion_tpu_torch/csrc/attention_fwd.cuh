// K2's bf16 forward body for Hopper (sm_90a), O = softmax(Q K^T * scale) V
// over packed (b, s, h*d) operands: attention_fwd_bf16_kernel, and the host
// body of row_attention.cu's C entry point. K2's fp32 path keeps
// attention_common.cuh's attention_f32_kernel; K1 (attention.cu) stays on
// attention_common.cuh's mma.sync body. The Hopper building blocks
// (cp.async tile copies, descriptors, wgmma, ex2) are in hopper.cuh.
//
// The arithmetic, and so every rounding point, is attention_common.cuh's:
// fp32 logits; an online softmax over 64-row K/V tiles in fp32 in the log2
// domain, the running max kept in logit units and the scale*log2(e) fold c
// entering each exp2 argument through one FFMA (s * c - m * c); P rounded
// to bf16 unnormalized for P V; fp32 accumulation; the division by the row
// sum once, on the output. The CPU emulation of the bf16 kernels
// (tests/test_torch_attention.py _kernel_numerics) therefore stands for
// this body too. exp2 is the SFU's ex2.approx (relative error about 2^-22)
// instead of exp2f.
//
// The design (its parts are those of attention_bwd.cuh's dQ body, which has
// the same shape: 128 owned query rows, K and V streamed):
// - One block of two warpgroups per (128-row query tile, head, batch row),
//   each warpgroup owning 64 query rows. The grid runs the query tile
//   fastest, then the head, then the batch row, so the blocks in flight
//   share one batch row's K/V in L2.
// - Q is copied once by cp.async into wgmma's no-swizzle core-matrix layout
//   and lands with the first K/V tile. d is zero-filled to DP (a multiple
//   of 16: 40 -> 48) by the copies, never loaded from the next head.
// - K and V come through a 3-stage cp.async ring, two tiles ahead of the
//   one in the products, with each thread's copy slots worked out once:
//   one wait and one barrier per tile.
// - S = Q K^T is wgmma m64n64k16 from shared memory, this warpgroup's Q rows
//   and the K tile both K-major, DP / 16 k-steps.
// - The softmax runs on the S accumulators in registers. Only the last tile
//   can be ragged, and only it is masked.
// - O += P V is wgmma with P, packed to bf16 from the S accumulators, as the
//   register A operand, and B the V tile as it was copied, row-major, read
//   MN-major through its descriptor: no transposed copy. Its width DN is d
//   rounded up to 8 (40 at d = 40, not 48).
// - At d = 40 a block fits in 80 registers, so three blocks share an SM
//   (two up to d = 64), and one block's exponentials run while another's
//   products do.
// Tried on the card and dropped (slower in the same call): two blocks per
// SM at d = 40; the next tile's S in the tensor cores while this tile's
// exponentials run (FA3's overlap inside a warpgroup, with a second set of
// S accumulators, 120 registers); the previous tile's P V in the tensor
// cores during them. No TMA, warp specialisation or clusters yet.
// The warpgroups per block (kFwdGroups) are one constant, and a
// log-sum-exp write would follow the row sums: both are to become template
// arguments when K1 moves onto this body.

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace riff {

constexpr int kFwdGroups = 2;              // warpgroups per block
constexpr int kFwdRows = 64 * kFwdGroups;  // query rows per block
constexpr int kFwdThreads = 128 * kFwdGroups;
constexpr int kFwdTileN = 64;              // K/V rows per streamed tile
constexpr int kFwdStages = 3;              // ring stages of K/V tiles
constexpr int kFwdAhead = kFwdStages - 1;  // tiles in flight ahead of the one in use

// Blocks per SM the registers are capped for: three where P V is at most
// 40 wide (80 registers a thread; at DN = 48 that cap spills), two up to
// d = 64 (128), one above.
template <int DP, int DN>
__host__ __device__ constexpr int fwd_min_blocks() {
  return DN <= 40 ? 3 : DP <= 64 ? 2 : 1;
}

// Q, then the ring of (K, V) tile pairs.
template <int DP>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (kFwdRows * DP + kFwdStages * 2 * kFwdTileN * DP) * 2;
}

// DP: d padded to 16 (the reduction of S); DN: d padded to 8 (the width of
// P V and of its accumulator).
template <int DP, int DN>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks<DP, DN>())
    attention_fwd_bf16_kernel(const Params p) {
  constexpr int kStageElems = 2 * kFwdTileN * DP;  // K, then V
  constexpr int kNTiles = kFwdTileN / 8;           // n-tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_ring = s_q + kFwdRows * DP;

  const int group = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kFwdRows;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  const int ntiles = (p.s_kv + kFwdTileN - 1) / kFwdTileN;
  const float c = p.scale_log2;

  // Each thread's copy slots; the chunks past head_dim are zero-filled.
  const TileCopies<DP, kFwdTileN, kFwdThreads> kv_copies(p.head_dim);
  const TileCopies<DP, kFwdRows, kFwdThreads> q_copies(p.head_dim);
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

  // This warpgroup's 64 rows of Q, K-major.
  const uint64_t qa = smem_desc(s_q + group * 64 * 8, kFwdRows * 16, 128);
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
      Wgmma<kFwdTileN>::ss(&s[0][0], desc_advance(qa, kk * 2 * kFwdRows * 16),
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

  // Full row sums across the 4 threads of each row group, then the one
  // division, on the (rows, DN) output; bf16 written for the columns below
  // head_dim and the rows below s_q.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  const int row = m0 + group * 64 + warp * 16 + g;
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
// instance (1), on a grid of 128-row query tiles. Returns the launch's
// cudaError_t, or the refusal of its dynamic shared memory.
template <int DP, int DN>
cudaError_t launch_fwd(const Params& p, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 1) {
    attention_f32_kernel<DP, kFwdRows><<<grid, kFwdRows, 0, stream>>>(p);
    return cudaGetLastError();
  }
  // above 48 KB a block's dynamic shared memory must be asked for
  constexpr int smem = fwd_smem_bytes<DP>();
  const cudaError_t set = cudaFuncSetAttribute(
      attention_fwd_bf16_kernel<DP, DN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  attention_fwd_bf16_kernel<DP, DN><<<grid, kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The body of row_attention.cu's C entry point: checks the arguments (K2
// writes no log-sum-exp: `lse` must be null), selects the operands' device,
// and launches the instance for the padded head width. dtype: 0 = bfloat16,
// 1 = float32; strides are in elements. Returns a cudaError_t value: 0 when
// the launch was accepted.
inline int row_attention_forward(const void* q, const void* k, const void* v, void* o,
                                 float* lse, long long q_sb, long long q_ss, long long k_sb,
                                 long long k_ss, long long v_sb, long long v_ss, long long o_sb,
                                 long long o_ss, int batch, int s_q, int s_kv, int num_heads,
                                 int head_dim, float scale, int dtype, int device,
                                 void* stream) {
  Params p;
  if (lse != nullptr ||
      !make_params(p, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, batch,
                   s_q, s_kv, num_heads, head_dim, scale, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  // Each library carries its own (static) CUDA runtime, whose current device
  // is not PyTorch's: select the operands' device before launching.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((s_q + kFwdRows - 1) / kFwdRows, num_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return (int)launch_fwd<16, 16>(p, dtype, grid, st);
    case 32: return (int)launch_fwd<32, 32>(p, dtype, grid, st);
    case 48:  // d = 40 (the batched path's seq-4096 sites) runs P V 40 wide
      return head_dim == 40 ? (int)launch_fwd<48, 40>(p, dtype, grid, st)
                            : (int)launch_fwd<48, 48>(p, dtype, grid, st);
    case 64: return (int)launch_fwd<64, 64>(p, dtype, grid, st);
    case 80: return (int)launch_fwd<80, 80>(p, dtype, grid, st);
    case 96: return (int)launch_fwd<96, 96>(p, dtype, grid, st);
    case 112: return (int)launch_fwd<112, 112>(p, dtype, grid, st);
    case 128: return (int)launch_fwd<128, 128>(p, dtype, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace riff
