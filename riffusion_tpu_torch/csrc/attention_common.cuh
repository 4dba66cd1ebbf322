// What the attention kernels share: the forward's launch parameters and
// their checks (make_params), the bf16 pair packing, and the fp32 forward
// instance (attention_f32_kernel) that K1 (attention.cu) and K2
// (row_attention.cu) keep for checks against their plain version at fp32
// tolerance. Their bf16 body is attention_fwd.cuh's; the backward's is
// attention_bwd.cuh's. Each .cu file is built into a shared library of its
// own, with its own C entry point; the build hash covers every header
// beside it.
//
// The forward writes each query row's log-sum-exp when it is given an LSE
// buffer (training keeps it for the backward kernels): fp32,
// (batch, heads, s_q) contiguous, the natural log of
// sum_j exp(scale * q.k_j).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace riff {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kF32TileN = 32;  // kv rows per staged tile (fp32 instances)

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

}  // namespace riff
