// K1's serving forward for Hopper (sm_90a), warp-specialised:
// attention_fwd_bf16_kernel_ws, O = softmax(Q K^T * scale) V over packed
// (b, s, h*d) bf16 operands without the log-sum-exp write, and the host code
// that launches it. attention.cu launches it at the head widths that
// ops/attention.py routes to it (d = 40 and 80, SD v1's self-attention, and
// 64, SDXL's); K1's LSE instances (training), its fp32 check instance and
// K2 stay on attention_fwd.cuh. The building blocks (TMA, mbarriers,
// named barriers, setmaxnreg, wgmma, ex2) are in hopper.cuh.
//
// What bounds it. At SDXL's seq-4096 sites (2, 4096, 10*64) one call is
// 4*b*h*s*s*d = 85.9 GFLOP (0.087 ms at 989 TFLOP/s) and b*h*s*s = 335 M
// exponentials (0.080 ms at 16 a clock on 132 SMs at 1980 MHz): the two
// limits are about equal, so a body that runs the exponentials and the
// products one after the other (attention_fwd.cuh) can at best reach their
// sum. This body overlaps them.
//
// The design:
// - One block of three warpgroups per (128-row query tile, head, batch
//   row), one block an SM. Warpgroup 0 is the producer: it lowers its
//   register cap to 24 (setmaxnreg) and one thread of it loads Q once, then
//   streams K/V tiles of BN rows into a ring of STAGES stages by TMA, each
//   stage with a full mbarrier (the loads' bytes) and an empty one (the
//   consumers' eight warps done with it). Warpgroups 1 and 2 are the
//   consumers, 64 query rows each, with the cap raised to 240.
// - The tensor maps are 4-d views of the packed operands, (d, s, h, b)
//   with the sequence, head and batch strides, passed by value
//   (__grid_constant__), so a captured CUDA graph replays them with its own
//   buffers. A box is 64 columns of one head (128 bytes, 128-byte swizzle)
//   by the tile's rows: columns past d and rows past s are zero-filled by
//   the TMA (d = 40 pads to the box's 64, of which S reads 48), never
//   read from the next head. Widths above 64 take a second 64-column panel.
// - Inside a consumer the products of the next tile overlap this tile's
//   exponentials: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
//   together (two commit groups), the softmax of S_j runs while
//   P_{j-1} V_{j-1} is in the tensor cores, and O is rescaled after it.
// - Between the consumers, the issues take turns on two named barriers
//   (ping-pong): one warpgroup's products are issued while the other runs
//   its softmax.
// - S is wgmma m64nBNk16 from shared memory (Q and the K tile K-major,
//   DP / 16 k-steps); P V is wgmma with P packed to bf16 from the S
//   accumulators as the register operand and the V tile read MN-major (the
//   transpose bit), DN = d wide.
// The arithmetic is attention_fwd.cuh's: fp32 logits; the log2-domain
// online softmax with one FFMA and one ex2.approx a logit; P rounded to bf16
// unnormalised; fp32 accumulation; one division at the end. Only the tile is
// wider (BN = 128 K/V rows), which changes where the running max is taken,
// not what is rounded. Only the last K/V tile can be ragged, and only it is
// masked.

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace riff {

constexpr int kWsRows = 128;     // query rows per block: two consumer warpgroups
constexpr int kWsThreads = 384;  // the producer warpgroup and the two consumers
constexpr int kWsBarFirst = 1;   // the consumers' named barriers: 1 (first), 2

// Q, the ring of (K, V) stages, then the mbarriers, after 1024 bytes of
// slack for the swizzled tiles' alignment.
template <int DP, int BN, int STAGES>
__host__ __device__ constexpr int fwd_ws_smem_bytes() {
  return 1024 + ((DP + 63) / 64) * (kWsRows + STAGES * 2 * BN) * 128 + 8 * (1 + 2 * STAGES);
}

// DP: d padded to 16 (the reduction of S); DN: d (the width of P V); BN:
// K/V rows per tile; STAGES: ring stages.
template <int DP, int DN, int BN, int STAGES>
__global__ void __launch_bounds__(kWsThreads, 1)
    attention_fwd_bf16_kernel_ws(const Params p, const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv) {
  constexpr int kPanels = (DP + 63) / 64;     // 64-column panels of a tile
  constexpr int kQPanel = kWsRows * 64;       // elements of one Q panel
  constexpr int kKvPanel = BN * 64;           // elements of one K or V panel
  constexpr int kStage = 2 * kPanels * kKvPanel;  // K's panels, then V's
  constexpr uint32_t kQBytes = kPanels * kQPanel * 2;
  constexpr uint32_t kStageBytes = kStage * 2;
  constexpr int kNTiles = BN / 8;  // n-tiles of S
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* s_ring = s_q + kPanels * kQPanel;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_ring + STAGES * kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * kWsRows;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int ntiles = (p.s_kv + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // each consumer warp once
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load_4d(s_q + pn * kQPanel, &tq, q_full, pn * 64, m0, head, batch);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        // the consumers are done with the tile this stage held
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        __nv_bfloat16* s_k = s_ring + st * kStage;
        mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load_4d(s_k + pn * kKvPanel, &tk, &full[st], pn * 64, it * BN, head, batch);
          tma_load_4d(s_k + (kPanels + pn) * kKvPanel, &tv, &full[st], pn * 64, it * BN, head,
                      batch);
        }
      }
      // the block ends with no load in flight into its shared memory
      for (int last = ntiles > STAGES ? ntiles - STAGES : 0; last < ntiles; ++last) {
        mbar_wait(&full[last % STAGES], (last / STAGES) & 1);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();  // what the producer gave up: 65,536 less its 128 x 24, over 256

  const int w = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float c = p.scale_log2;
  // Ping-pong: a consumer issues its products after the other has issued
  // its own (bar.sync on its barrier), then lets the other go (bar.arrive on
  // the other's); consumer 0 goes first.
  const int own_bar = kWsBarFirst + w;
  const int other_bar = kWsBarFirst + 1 - w;
  if (w == 1) named_bar_arrive(other_bar, 256);

  // This consumer's 64 rows of Q (panel kk / 4, 32 bytes a k16 step), the
  // stage's K tile (BN rows, K-major) and V tile (read MN-major: 16 rows a
  // k16 step, the next 64 columns a panel on).
  auto q_desc = [&](int kk) {
    return smem_desc_sw128(s_q + (kk / 4) * kQPanel + w * 64 * 64 + (kk % 4) * 16, 16);
  };
  auto k_desc = [&](const __nv_bfloat16* s_k, int kk) {
    return smem_desc_sw128(s_k + (kk / 4) * kKvPanel + (kk % 4) * 16, 16);
  };
  auto v_desc = [&](const __nv_bfloat16* s_v, int kk) {
    return smem_desc_sw128(s_v + kk * 16 * 64, kKvPanel * 2);
  };
  auto stage_k = [&](int it) { return s_ring + (it % STAGES) * kStage; };

  float acc[DN / 8][4];  // O, unnormalized
#pragma unroll
  for (int i = 0; i < DN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float s[kNTiles][4];         // S, then P: 64 rows x the tile's BN columns
  uint32_t pa[BN / 16][4];     // P in bf16, the register operand of P V
  // Each thread holds two query rows: g (elements 0, 1) and g + 8 (2, 3).
  float row_max[2] = {-INFINITY, -INFINITY};  // logit units
  float row_sum[2] = {0.f, 0.f};              // partial, over this thread's columns

  // P into s, the running max and sum moved on; returns in `alpha` the
  // factor O is rescaled by once its pending product is done. Element e of
  // n-tile j is row g (+ 8 for e >= 2) of the warp's 16 and column
  // j * 8 + 2t (+ 1 for odd e). Only the last tile can be ragged: its
  // columns past s_kv get logit -inf.
  auto softmax = [&](auto ragged, int n0, float (&alpha)[2]) {
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
    alpha[0] = exp2_approx((row_max[0] - mx[0]) * c);
    alpha[1] = exp2_approx((row_max[1] - mx[1]) * c);
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
  };
  auto softmax_tile = [&](int it, float (&alpha)[2]) {
    const int n0 = it * BN;
    if (n0 + BN <= p.s_kv) {
      softmax(Flag<false>(), n0, alpha);
    } else {
      softmax(Flag<true>(), n0, alpha);
    }
  };
  // P packed to bf16 (two adjacent S n-tiles are one k16 fragment), all of
  // it before the first product that reads it.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  auto issue_s = [&](int it) {  // S = Q K^T
    const __nv_bfloat16* s_k = stage_k(it);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BN>::ss(&s[0][0], q_desc(kk), k_desc(s_k, kk), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int it) {  // O += P V
    const __nv_bfloat16* s_v = stage_k(it) + kPanels * kKvPanel;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Wgmma<DN>::template rs<kMnMajor>(&acc[0][0], pa[kk], v_desc(s_v, kk));
    }
    wgmma_commit();
  };
  // This warp is done with tile it's stage (its products have completed).
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % STAGES]);
  };

  float alpha[2];
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  named_bar_sync(own_bar, 256);
  wgmma_fence();
  issue_s(0);
  named_bar_arrive(other_bar, 256);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(0, alpha);
  pack_p();
  for (int it = 1; it < ntiles; ++it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    named_bar_sync(own_bar, 256);
    wgmma_fence();
    issue_s(it);
    issue_pv(it - 1);
    named_bar_arrive(other_bar, 256);
    wgmma_wait<1>();  // S of tile it
    fence_regs(s);
    softmax_tile(it, alpha);
    wgmma_wait<0>();  // P V of tile it - 1
    fence_regs(acc);
    release(it - 1);
#pragma unroll
    for (int i = 0; i < DN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];  // O to the new max
    }
    pack_p();
  }
  named_bar_sync(own_bar, 256);
  wgmma_fence();
  issue_pv(ntiles - 1);
  if (w == 0) named_bar_arrive(other_bar, 256);  // consumer 1 takes no turn more
  wgmma_wait<0>();
  fence_regs(acc);

  // Full row sums across the 4 threads of each row group, then the one
  // division, on the (rows, DN) output; bf16 written for the rows below s_q.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const int row = m0 + w * 64 + warp * 16 + g;
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + batch * p.o_sb +
                     (long long)head * p.head_dim;
#pragma unroll
  for (int dt = 0; dt < DN / 8; ++dt) {
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

// The driver's cuTensorMapEncodeTiled, through the runtime (no link against
// libcuda); null where the driver has none.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &found,
                                                            12000, cudaEnableDefault, &status);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault, &status);
#endif
    return rc == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(found)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one packed (batch, seq, heads * head_dim) bf16 operand
// as (head_dim, seq, heads, batch), strides in elements, boxes of 64
// columns by `rows` rows with the 128-byte swizzle. Returns false where the
// driver refuses it.
inline bool ws_tensor_map(CUtensorMap* map, const void* x, long long sb, long long ss, int batch,
                          int seq, int heads, int head_dim, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)head_dim * 2,
                                 (cuuint64_t)sb * 2};  // bytes, of dims 1..3
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One instance on a grid of (128-row query tiles, heads, batch rows).
// Returns the launch's cudaError_t, or the refusal of a tensor map or of its
// dynamic shared memory.
template <int DP, int DN, int BN, int STAGES>
cudaError_t launch_fwd_ws(const Params& p, int batch, int num_heads, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!ws_tensor_map(&tq, p.q, p.q_sb, p.q_ss, batch, p.s_q, num_heads, p.head_dim, kWsRows) ||
      !ws_tensor_map(&tk, p.k, p.k_sb, p.k_ss, batch, p.s_kv, num_heads, p.head_dim, BN) ||
      !ws_tensor_map(&tv, p.v, p.v_sb, p.v_ss, batch, p.s_kv, num_heads, p.head_dim, BN)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = fwd_ws_smem_bytes<DP, BN, STAGES>();
  const cudaError_t set = cudaFuncSetAttribute(attention_fwd_bf16_kernel_ws<DP, DN, BN, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((p.s_q + kWsRows - 1) / kWsRows, num_heads, batch);
  attention_fwd_bf16_kernel_ws<DP, DN, BN, STAGES><<<grid, kWsThreads, smem, stream>>>(p, tq, tk,
                                                                                       tv);
  return cudaGetLastError();
}

// Launches the warp-specialised instance for the head width of checked bf16
// parameters (fwd_params) without an LSE buffer. Returns a cudaError_t
// value: 0 when the launch was accepted; cudaErrorInvalidValue at a width
// with no instance here (ops/attention.py routes only these widths here).
inline int fwd_ws_launch(const Params& p, int batch, int num_heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.lse != nullptr) return (int)cudaErrorInvalidValue;
  switch (p.head_dim) {
    case 40: return (int)launch_fwd_ws<48, 40, 128, 3>(p, batch, num_heads, st);
    case 64: return (int)launch_fwd_ws<64, 64, 128, 3>(p, batch, num_heads, st);
    case 80: return (int)launch_fwd_ws<80, 80, 128, 2>(p, batch, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace riff
