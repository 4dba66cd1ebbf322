// Non-causal multi-head attention forward, O = softmax(Q K^T * scale) V, for
// Hopper (sm_90a). Built by riffusion_tpu_torch/ops/attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point, riff_attention_forward.
//
// What it replaces. The JAX package runs UNet self-attention as Pallas on
// the TPU in two places:
//   K1  jax.experimental.pallas.ops.tpu.flash_attention, called from
//       riffusion_tpu/models/layers.py Attention.__call__ (flash branch) at
//       UNet batch <= 8, i.e. on the single-clip serving path;
//   K2  riffusion_tpu/ops/attention.py full_row_attention, the batched
//       serving path (UNet batch > 8).
// This kernel is the Hopper counterpart of K1 and keeps K2's main point: Q,
// K, V and O stay in the packed (b, s, h*d) layout the to_q / to_k / to_v
// projections emit. The kernel reads them through (batch, seq) strides with
// the head picked by a column offset; no transpose or pad copy exists.
//
// What bounds it on this card. At the slice's largest sites (b=2, h=8,
// s=4096, d=40) one call is 4*b*h*s*s*d = 43 GFLOP against about 21 MB of
// operands: ~2000 FLOP per byte, far above the H100's ~295 bf16 FLOP/byte
// ridge. The kernel is bound by tensor-core issue, not by memory.
//
// What the design does about it. K2 keeps a whole K/V row resident in 96 MB
// of VMEM; an SM has 227 KB of shared memory, so this is an online-softmax
// (flash) kernel that streams K/V tiles:
//   - one block of 4 warps per (64-row query tile, head, batch); each warp
//     owns 16 query rows;
//   - Q is staged once and kept in registers as mma A fragments;
//   - 64-row K and V tiles are staged through shared memory, with d
//     zero-padded to a multiple of 16 (40 -> 48), which is exact;
//   - Q K^T and P V run on the tensor cores as mma.sync m16n8k16 bf16 with
//     fp32 accumulation; the logits never leave registers;
//   - running max and sum are fp32, in the log2 domain: the scale*log2(e)
//     fold is one fp32 multiply on the logits accumulator (K2 folds it into
//     Q in bf16; doing it in fp32 costs the same and rounds less), so the
//     softmax numerator is a bare exp2;
//   - P is cast to bf16 for P V, and the division by the row sum comes after
//     P V, on the (rows, d) output.
// wgmma, TMA and a multi-stage pipeline are later work: this version loads a
// tile, synchronizes, and computes.
//
// An fp32 instance (plain FMA, one thread per query row, same online
// softmax) exists so the kernel can be held against its plain version at
// fp32 tolerance; the serving path runs the bf16 instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // kv rows per staged tile (bf16 instance)
constexpr int kWarps = 4;     // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kF32TileN = 32;  // kv rows per staged tile (fp32 instance)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of the batch and sequence dims; the packed h*d dim is
  // contiguous
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  int s_q, s_kv, head_dim;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + kBlockN) of one head into shared memory as
// [row][DP + 8] bf16, zero-filling rows past `nrows` and columns past
// `head_dim`. 16-byte vector loads: head_dim, the strides and the base are
// multiples of 8 elements (the wrapper checks).
template <int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ss, int r0, int nrows, int head_dim) {
  constexpr int kLd = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < kBlockN * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c < head_dim) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ss + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Stage V rows [r0, r0 + kBlockN) transposed, as [d][kBlockN + 8], so the
// P V B fragments (two consecutive kv rows of one d column) are one 32-bit
// shared-memory load each.
template <int DP>
__device__ __forceinline__ void stage_rows_transposed(__nv_bfloat16* dst,
                                                      const __nv_bfloat16* src, long long ss,
                                                      int r0, int nrows, int head_dim) {
  constexpr int kLdT = kBlockN + 8;
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < kBlockN * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c < head_dim) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ss + c);
    }
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLdT + r] = e[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attention_bf16_kernel(const Params p) {
  constexpr int kLd = DP + 8;
  constexpr int kLdT = kBlockN + 8;
  constexpr int kKSteps = DP / 16;   // k steps of Q K^T
  constexpr int kDTiles = DP / 8;    // n tiles of P V
  constexpr int kNTiles = kBlockN / 8;

  __shared__ __align__(16) __nv_bfloat16 s_k[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 s_vt[DP * kLdT];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread within the group
  const int m0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const long long col0 = (long long)head * p.head_dim;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + batch * p.o_sb + col0;

  // Q tile -> shared memory (borrowing the K buffer) -> A fragments.
  stage_rows<DP>(s_k, q, p.q_ss, m0, p.s_q, p.head_dim);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  {
    const __nv_bfloat16* base = s_k + (warp * 16 + g) * kLd + t * 2;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const __nv_bfloat16* b = base + kk * 16;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(b);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(b + 8 * kLd);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(b + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(b + 8 * kLd + 8);
    }
  }
  __syncthreads();

  // Each thread holds two query rows: g (elements 0, 1) and g + 8 (2, 3).
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // partial over this thread's columns

  for (int n0 = 0; n0 < p.s_kv; n0 += kBlockN) {
    stage_rows<DP>(s_k, k, p.k_ss, n0, p.s_kv, p.head_dim);
    stage_rows_transposed<DP>(s_vt, v, p.v_ss, n0, p.s_kv, p.head_dim);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = s_k + (nt * 8 + g) * kLd + t * 2;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + kk * 16 + 8);
        mma_16816(s[nt], qa[kk], b0, b1);
      }
    }

    // Scale into the log2 domain, mask the ragged kv tail, new row max.
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + t * 2 + (e & 1);
        s[nt][e] = col < p.s_kv ? s[nt][e] * p.scale_log2 : -INFINITY;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // Column n0 is always in range, so mx is finite from the first tile on.
    const float alpha0 = exp2f(row_max[0] - mx[0]);
    const float alpha1 = exp2f(row_max[1] - mx[1]);
    row_max[0] = mx[0];
    row_max[1] = mx[1];

    float part0 = 0.f, part1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      part0 += s[nt][0] + s[nt][1];
      part1 += s[nt][2] + s[nt][3];
    }
    row_sum[0] = row_sum[0] * alpha0 + part0;
    row_sum[1] = row_sum[1] * alpha1 + part1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V. Two adjacent S accumulator tiles form one bf16 A fragment.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const __nv_bfloat16* vb = s_vt + (dt * 8 + g) * kLdT + j * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vb + 8);
        mma_16816(acc[dt], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  // Full row sums across the 4 threads of each row group, then O / l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const float inv0 = 1.f / row_sum[0];
  const float inv1 = 1.f / row_sum[1];
  const int row0 = m0 + warp * 16 + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + t * 2;
    if (dt * 8 >= p.head_dim) break;  // head_dim is a multiple of 8
    if (row0 < p.s_q) {
      *reinterpret_cast<uint32_t*>(o + (long long)row0 * p.o_ss + c) =
          pack_bf16x2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (row1 < p.s_q) {
      *reinterpret_cast<uint32_t*>(o + (long long)row1 * p.o_ss + c) =
          pack_bf16x2(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

// fp32 instance: one thread per query row, kv tiles staged in shared memory,
// the same log2-domain online softmax with plain FMAs.
template <int DP>
__global__ void __launch_bounds__(kBlockM)
    attention_f32_kernel(const Params p) {
  __shared__ float s_k[kF32TileN][DP];
  __shared__ float s_v[kF32TileN][DP];

  const int row = blockIdx.x * kBlockM + threadIdx.x;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const float* q = static_cast<const float*>(p.q) + blockIdx.z * p.q_sb + col0;
  const float* k = static_cast<const float*>(p.k) + blockIdx.z * p.k_sb + col0;
  const float* v = static_cast<const float*>(p.v) + blockIdx.z * p.v_sb + col0;
  float* o = static_cast<float*>(p.o) + blockIdx.z * p.o_sb + col0;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = (row < p.s_q && c < p.head_dim) ? q[(long long)row * p.q_ss + c] : 0.f;
    acc[c] = 0.f;
  }
  float row_max = -INFINITY;
  float row_sum = 0.f;

  for (int n0 = 0; n0 < p.s_kv; n0 += kF32TileN) {
    for (int idx = threadIdx.x; idx < kF32TileN * DP; idx += kBlockM) {
      const int r = idx / DP;
      const int c = idx % DP;
      const bool in = n0 + r < p.s_kv && c < p.head_dim;
      s_k[r][c] = in ? k[(long long)(n0 + r) * p.k_ss + c] : 0.f;
      s_v[r][c] = in ? v[(long long)(n0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[kF32TileN];
    float mx = row_max;
#pragma unroll 1
    for (int j = 0; j < kF32TileN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) dot = fmaf(qr[c], s_k[j][c], dot);
      s[j] = n0 + j < p.s_kv ? dot * p.scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(row_max - mx);
    row_max = mx;
    row_sum *= alpha;
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] *= alpha;
#pragma unroll 1
    for (int j = 0; j < kF32TileN; ++j) {
      const float pj = exp2f(s[j] - mx);
      row_sum += pj;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(pj, s_v[j][c], acc[c]);
    }
    __syncthreads();
  }

  if (row < p.s_q) {
    const float inv = 1.f / row_sum;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < p.head_dim) o[(long long)row * p.o_ss + c] = acc[c] * inv;
    }
  }
}

template <int DP>
void launch(const Params& p, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 0) {
    attention_bf16_kernel<DP><<<grid, kThreads, 0, stream>>>(p);
  } else {
    attention_f32_kernel<DP><<<grid, kBlockM, 0, stream>>>(p);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements. `device` is the
// CUDA ordinal of the operands and `stream` a stream on it. Returns a
// cudaError_t value: 0 when the launch was accepted.
extern "C" int riff_attention_forward(const void* q, const void* k, const void* v, void* o,
                                      long long q_sb, long long q_ss, long long k_sb,
                                      long long k_ss, long long v_sb, long long v_ss,
                                      long long o_sb, long long o_ss, int batch, int s_q,
                                      int s_kv, int num_heads, int head_dim, float scale,
                                      int dtype, int device, void* stream) {
  if (batch <= 0 || s_q <= 0 || s_kv <= 0 || num_heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1) ||
      batch > 65535 || num_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // This library carries its own (static) CUDA runtime, whose current device
  // is not PyTorch's: select the operands' device before launching.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.s_q = s_q;
  p.s_kv = s_kv;
  p.head_dim = head_dim;
  p.scale_log2 = scale * 1.4426950408889634f;

  const dim3 grid((s_q + kBlockM - 1) / kBlockM, num_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: launch<16>(p, dtype, grid, st); break;
    case 32: launch<32>(p, dtype, grid, st); break;
    case 48: launch<48>(p, dtype, grid, st); break;
    case 64: launch<64>(p, dtype, grid, st); break;
    case 80: launch<80>(p, dtype, grid, st); break;
    case 96: launch<96>(p, dtype, grid, st); break;
    case 112: launch<112>(p, dtype, grid, st); break;
    case 128: launch<128>(p, dtype, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
