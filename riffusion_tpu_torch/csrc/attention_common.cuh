// The attention kernel body shared by the port's two kernels, attention.cu
// (K1) and row_attention.cu (K2), and its helpers: the launch parameters,
// the bf16 m16n8k16 tensor-core product, the staging of packed (b, s, h*d)
// rows into shared memory, the bf16 kernel (templated on the padded head
// width and the warps per block, the one thing the two kernels set apart),
// and the fp32 instance both keep for checks against their plain version.
// Each .cu file includes this header and is built into a shared library of
// its own, with its own C entry point; the build hash covers this header.
//
// The forward writes each query row's log-sum-exp when it is given an LSE
// buffer (training keeps it for the backward kernels of attention_bwd.cuh):
// fp32, (batch, heads, s_q) contiguous, the natural log of
// sum_j exp(scale * q.k_j). The bf16 kernel takes that as a template
// argument, so the instance that serving runs (a null buffer) is the kernel
// without the write.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace riff {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileN = 64;     // kv rows per staged tile (bf16 instance)
constexpr int kF32TileN = 32;  // kv rows per staged tile (fp32 instance)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (batch, heads, s_q) log-sum-exp, or null
  // element strides of the batch and sequence dims; the packed h*d dim is
  // contiguous
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  int s_q, s_kv, head_dim;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// Fills Params from the C entry points' common argument list; returns false
// for arguments no instance takes.
inline bool make_params(Params& p, const void* q, const void* k, const void* v, void* o,
                        float* lse, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                        int batch, int s_q, int s_kv, int num_heads, int head_dim, float scale,
                        int dtype) {
  if (batch <= 0 || s_q <= 0 || s_kv <= 0 || num_heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1) || batch > 65535 ||
      num_heads > 65535) {
    return false;
  }
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + ROWS) of one head into shared memory as
// [row][DP + 8] bf16, zero-filling rows past `nrows` and columns past
// `head_dim`. 16-byte vector loads: head_dim, the strides and the base are
// multiples of 8 elements (the wrapper checks).
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ss, int r0, int nrows, int head_dim) {
  constexpr int kLd = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c < head_dim) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ss + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Stage V rows [r0, r0 + ROWS) transposed, as [d][ROWS + 8], so the P V B
// fragments (two consecutive kv rows of one d column) are one 32-bit
// shared-memory load each.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows_transposed(__nv_bfloat16* dst,
                                                      const __nv_bfloat16* src, long long ss,
                                                      int r0, int nrows, int head_dim) {
  constexpr int kLdT = ROWS + 8;
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
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

// bf16 instance: one block of WARPS warps per (WARPS * 16-row query tile,
// head, batch row); each warp owns 16 query rows. Q is staged once and kept
// in registers as mma A fragments; 64-row K and V tiles stream through
// shared memory (the Q tile is staged through the same buffer first); Q K^T
// and P V are mma.sync m16n8k16 bf16 with fp32 accumulation. The softmax is
// online, in fp32, in the log2 domain: the running max is kept in logit
// units and the scale*log2(e) fold c enters each exp2 argument through one
// fp32 FFMA (s * c - m * c). P is cast to bf16 unnormalized for P V; the
// division by the row sum comes once, on the (rows, d) output. With LSE the
// rows' log-sum-exp goes to p.lse.
template <int DP, int WARPS, bool LSE>
__global__ void __launch_bounds__(WARPS * 32) attention_bf16_kernel(const Params p) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kBlockM = WARPS * 16;
  constexpr int kLd = DP + 8;
  constexpr int kLdT = kTileN + 8;
  constexpr int kKSteps = DP / 16;  // k steps of Q K^T
  constexpr int kDTiles = DP / 8;   // n tiles of P V
  constexpr int kNTiles = kTileN / 8;
  constexpr int kKvElems = kTileN * kLd + DP * kLdT;
  constexpr int kQElems = kBlockM * kLd;
  constexpr int kSmemElems = kKvElems > kQElems ? kKvElems : kQElems;

  __shared__ __align__(16) __nv_bfloat16 smem[kSmemElems];
  __nv_bfloat16* s_k = smem;
  __nv_bfloat16* s_vt = smem + kTileN * kLd;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread within the group
  const int m0 = blockIdx.x * kBlockM;
  const long long col0 = (long long)blockIdx.y * p.head_dim;
  const int batch = blockIdx.z;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + col0;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + col0;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + batch * p.o_sb + col0;

  // Q tile -> shared memory -> this warp's A fragments (16 rows).
  stage_rows<DP, kBlockM, kThreads>(smem, q, p.q_ss, m0, p.s_q, p.head_dim);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  {
    const __nv_bfloat16* base = smem + (warp * 16 + g) * kLd + t * 2;
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
  const float c = p.scale_log2;
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // partial over this thread's columns

  for (int n0 = 0; n0 < p.s_kv; n0 += kTileN) {
    stage_rows<DP, kTileN, kThreads>(s_k, k, p.k_ss, n0, p.s_kv, p.head_dim);
    stage_rows_transposed<DP, kTileN, kThreads>(s_vt, v, p.v_ss, n0, p.s_kv, p.head_dim);
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

    // Mask the ragged kv tail, new row max (logit units).
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + t * 2 + (e & 1);
        if (col >= p.s_kv) s[nt][e] = -INFINITY;
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
    const float alpha0 = exp2f((row_max[0] - mx[0]) * c);
    const float alpha1 = exp2f((row_max[1] - mx[1]) * c);
    row_max[0] = mx[0];
    row_max[1] = mx[1];
    const float mc0 = mx[0] * c;
    const float mc1 = mx[1] * c;

    float part0 = 0.f, part1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = exp2f(fmaf(s[nt][0], c, -mc0));
      s[nt][1] = exp2f(fmaf(s[nt][1], c, -mc0));
      s[nt][2] = exp2f(fmaf(s[nt][2], c, -mc1));
      s[nt][3] = exp2f(fmaf(s[nt][3], c, -mc1));
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

    // O += P V with P unnormalized in bf16. Two adjacent S accumulator tiles
    // form one A fragment.
#pragma unroll
    for (int j = 0; j < kTileN / 16; ++j) {
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

  // Full row sums across the 4 threads of each row group, then the one
  // division, on the (rows, d) output.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const float inv0 = 1.f / row_sum[0];
  const float inv1 = 1.f / row_sum[1];
  const int row0 = m0 + warp * 16 + g;
  const int row1 = row0 + 8;
  if constexpr (LSE) {
    if (t == 0) {
      // log sum_j exp(scale * s_j) = scale * m + log(sum_j exp2((s_j - m) * c))
      float* lse = p.lse + ((long long)batch * gridDim.y + blockIdx.y) * p.s_q;
      if (row0 < p.s_q) lse[row0] = fmaf(row_max[0], p.scale, logf(row_sum[0]));
      if (row1 < p.s_q) lse[row1] = fmaf(row_max[1], p.scale, logf(row_sum[1]));
    }
  }
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int cc = dt * 8 + t * 2;
    if (dt * 8 >= p.head_dim) break;  // head_dim is a multiple of 8
    if (row0 < p.s_q) {
      *reinterpret_cast<uint32_t*>(o + (long long)row0 * p.o_ss + cc) =
          pack_bf16x2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (row1 < p.s_q) {
      *reinterpret_cast<uint32_t*>(o + (long long)row1 * p.o_ss + cc) =
          pack_bf16x2(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

// fp32 instance: one thread per query row (ROWS rows per block), kv tiles
// staged in shared memory, a log2-domain online softmax with plain FMAs.
template <int DP, int ROWS>
__global__ void __launch_bounds__(ROWS) attention_f32_kernel(const Params p) {
  __shared__ float s_k[kF32TileN][DP];
  __shared__ float s_v[kF32TileN][DP];

  const int row = blockIdx.x * ROWS + threadIdx.x;
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
    for (int idx = threadIdx.x; idx < kF32TileN * DP; idx += ROWS) {
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
    if (p.lse != nullptr) {  // row_max is in log2 units here
      p.lse[((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.s_q + row] =
          (row_max + log2f(row_sum)) / kLog2e;
    }
    const float inv = 1.f / row_sum;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < p.head_dim) o[(long long)row * p.o_ss + c] = acc[c] * inv;
    }
  }
}

template <int DP, int WARPS>
void launch(const Params& p, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 0 && p.lse != nullptr) {
    attention_bf16_kernel<DP, WARPS, true><<<grid, WARPS * 32, 0, stream>>>(p);
  } else if (dtype == 0) {
    attention_bf16_kernel<DP, WARPS, false><<<grid, WARPS * 32, 0, stream>>>(p);
  } else {
    attention_f32_kernel<DP, WARPS * 16><<<grid, WARPS * 16, 0, stream>>>(p);
  }
}

// The body of both C entry points: checks the arguments, selects the
// operands' device, and launches the instance for the padded head width on
// a grid of (query tiles of WARPS * 16 rows, heads, batch rows). The query
// tile varies fastest, then the head, then the batch row, so the blocks in
// flight share one batch row's K/V in L2. dtype: 0 = bfloat16, 1 = float32;
// strides are in elements; `lse` is null or a (batch, heads, s_q) fp32
// buffer. Returns a cudaError_t value: 0 when the launch was accepted.
template <int WARPS>
int attention_forward(const void* q, const void* k, const void* v, void* o, float* lse,
                      long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                      long long v_sb, long long v_ss, long long o_sb, long long o_ss, int batch,
                      int s_q, int s_kv, int num_heads, int head_dim, float scale, int dtype,
                      int device, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, batch,
                   s_q, s_kv, num_heads, head_dim, scale, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  // Each library carries its own (static) CUDA runtime, whose current device
  // is not PyTorch's: select the operands' device before launching.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;

  constexpr int kBlockM = WARPS * 16;
  const dim3 grid((s_q + kBlockM - 1) / kBlockM, num_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: launch<16, WARPS>(p, dtype, grid, st); break;
    case 32: launch<32, WARPS>(p, dtype, grid, st); break;
    case 48: launch<48, WARPS>(p, dtype, grid, st); break;
    case 64: launch<64, WARPS>(p, dtype, grid, st); break;
    case 80: launch<80, WARPS>(p, dtype, grid, st); break;
    case 96: launch<96, WARPS>(p, dtype, grid, st); break;
    case 112: launch<112, WARPS>(p, dtype, grid, st); break;
    case 128: launch<128, WARPS>(p, dtype, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace riff
