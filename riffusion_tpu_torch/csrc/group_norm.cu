// GroupNorm over channels_last (NHWC) activations, with SiLU optionally
// fused, for Hopper (sm_90a). Built by riffusion_tpu_torch/ops/attention.py
// build_kernels (one nvcc per source, in the same round as the attention
// kernels) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point, riff_group_norm,
// launched by riffusion_tpu_torch/ops/group_norm.py.
//
// What it replaces. No TPU kernel: the JAX package's GroupNorm is plain jnp
// (riffusion_tpu/models/layers.py GroupNorm), which XLA fuses with the ops
// around it in its NHWC layout. The port ran it as F.group_norm on NCHW
// tensors: a cast to fp32, the moments, the normalisation, a cast back and
// F.silu, five passes and about 28 bytes of traffic an element, with the
// moments over B x G = 64 rows, one block each; around it cuDNN transposed
// every convolution's input and output between NCHW and its NHWC kernels.
// The serving UNet now keeps NHWC from end to end, and this is the
// GroupNorm that layout needs.
//
// What it computes. Per (image, group of C/G adjacent channels): the mean
// and the biased variance of x in fp32, y = x * a + b with a = rstd * gamma
// and b = beta - mean * a (torch's fused affine), rounded to x's dtype;
// with SiLU, out = silu(y) on the rounded y, rounded again. Those are the
// plain version's roundings (ops/group_norm.py group_norm_reference), so the
// two differ by the order in which the statistics are summed.
//
// What bounds it on this card. Memory. An element is read for the
// statistics, read again for the normalisation and written: 6 bytes at
// bf16, 4 where the second read comes out of the 50 MB L2, as it can at
// every site of the serving path (the largest input, 2 x 64 x 64 x 960
// bf16, is 15.7 MB). The path's 61 sites hold about 90 M elements a UNet
// evaluation at batch 2: at least 0.11 ms at 3.35 TB/s.
//
// What the design does about it.
//   - The whole card at every batch. Two launches over a grid of (spatial
//     chunk, image): the wrapper cuts each image's H*W rows into chunks so
//     that the grid holds about one block of about 384 threads per SM
//     (ops/group_norm.py `tiling`, whose constants say how they were
//     chosen), where torch's moments ran one block per (image, group).
//   - Coalesced 16-byte loads of whole rows. A block is R x C/V threads
//     (V = 8 bf16 or 4 fp32 elements a load): thread (r, v) reads the v-th
//     16 bytes of rows r, r + R, r + 2R, ... of its chunk, four loads in
//     flight, so a warp reads 512 contiguous bytes and a thread's channels
//     stay fixed.
//   - Statistics by Welford and Chan, never as a sum and a sum of squares,
//     so no cancellation appears that torch's Welford does not have: each
//     thread keeps a Welford state per channel of its load; the block
//     merges its R x C/G states per group (count, mean, M2), a warp a
//     group, each lane its states in turn, then the warp's lanes pairwise
//     (Chan), and writes one partial per (image, group, chunk) to a scratch
//     the wrapper allocates.
//   - The second launch merges the chunk partials of its image's groups in
//     the same way, in one pass; it folds gamma (loaded before the merge)
//     and beta into one scale and shift per channel of the thread's load,
//     and normalises its chunk, SiLU fused.
//   - Why not one launch with a thread-block cluster: a cluster holds at
//     most 16 blocks, and an image's statistics need every chunk of the
//     image, so at the single clip's batch of 2 the grid would be 32 blocks
//     on 132 SMs. Two launches keep the card full at every batch, and their
//     cost is one more launch inside the captured graph.
//
// Both launches check cudaGetLastError; a refused launch returns its error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace riffgn {

constexpr int kUnroll = 4;  // loads in flight per thread
constexpr int kSeg = 32;    // lanes that merge one group's states: a warp
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 48 * 1024;  // static limit: no attribute asked for

// The launch geometry, computed by ops/group_norm.py `tiling` and checked
// by riff_group_norm.
struct Geometry {
  int batch, hw, channels, groups;
  int cpg;     // channels per group
  int vpr;     // 16-byte loads per spatial row: channels / V
  int rows;    // R: the spatial rows a block reads at once; R * vpr threads load
  int chunk;   // spatial rows per block (the last chunk of an image may be shorter)
  int chunks;  // chunks per image
};

// One 16-byte load of T as fp32 values, and back.
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&f)[V]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[V]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return raw;
  }
};

template <>
struct Pack<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&f)[V]) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static uint4 pack(const float (&f)[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// Chan's merge of the state (nb, mean_b, m2_b) into (n, mean, m2): count,
// mean and sum of squared deviations of two disjoint sets, as one.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mean_b, float m2_b) {
  const float total = n + nb;
  if (total == 0.f) return;
  const float delta = mean_b - mean, wb = nb / total;
  mean = fmaf(delta, wb, mean);
  m2 += m2_b + delta * delta * n * wb;
  n = total;
}

// The states of a segment's kSeg lanes merged pairwise (Chan), into every
// lane's; all lanes of the warp run it. A segment is kSeg aligned lanes.
__device__ __forceinline__ void segment_merge(float& n, float& mean, float& m2) {
#pragma unroll
  for (int o = kSeg / 2; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mean_b = __shfl_xor_sync(0xffffffffu, mean, o);
    const float m2_b = __shfl_xor_sync(0xffffffffu, m2, o);
    chan_merge(n, mean, m2, nb, mean_b, m2_b);
  }
}

// gamma or beta at channel c: bf16 (param_f32 0) or fp32 (1)
__device__ __forceinline__ float param(const void* p, int c, int param_f32) {
  return param_f32 ? static_cast<const float*>(p)[c]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]);
}

// The partials' planes: count, mean and M2 of (image, group, chunk), each
// at ((image * groups + group) * chunks + chunk).
struct Partials {
  float* count;
  float* mean;
  float* m2;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_stats_kernel(const T* __restrict__ x, Partials part, const Geometry g) {
  constexpr int V = Pack<T>::V;
  extern __shared__ float smem[];  // mean[R][C], m2[R][C], count[R]
  float* s_mean = smem;
  float* s_m2 = smem + g.rows * g.channels;
  float* s_count = s_m2 + g.rows * g.channels;

  const int image = blockIdx.y, k = blockIdx.x;
  const int v = threadIdx.x % g.vpr, r = threadIdx.x / g.vpr;
  const int row_begin = k * g.chunk;
  const int row_end = min(row_begin + g.chunk, g.hw);

  if (r < g.rows) {  // the threads past R * vpr only merge
    const T* col = x + (long long)image * g.hw * g.channels + v * V;
    float mean[V], m2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
    int n = 0;
    for (int row = row_begin + r; row < row_end; row += kUnroll * g.rows) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = row + u * g.rows;
        if (rr < row_end) raw[u] = *reinterpret_cast<const uint4*>(col + (long long)rr * g.channels);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * g.rows >= row_end) break;
        float f[V];
        Pack<T>::unpack(raw[u], f);
        ++n;
        const float inv = 1.f / n;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[i] - mean[i];
          mean[i] = fmaf(d, inv, mean[i]);
          m2[i] = fmaf(d, f[i] - mean[i], m2[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s_mean[r * g.channels + v * V + i] = mean[i];
      s_m2[r * g.channels + v * V + i] = m2[i];
    }
    if (v == 0) s_count[r] = (float)n;
  }
  __syncthreads();

  // Each group's R x cpg states, merged by kSeg lanes: every lane its
  // states in turn, then the segment's lanes pairwise
  const int seg = threadIdx.x / kSeg, sub = threadIdx.x % kSeg, segs = blockDim.x / kSeg;
  const int states = g.rows * g.cpg;
  for (int first = 0; first < g.groups; first += segs) {
    const int group = first + seg;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    if (group < g.groups) {
      for (int e = sub; e < states; e += kSeg) {
        const int slot = e / g.cpg, at = slot * g.channels + group * g.cpg + e % g.cpg;
        chan_merge(n, mean, m2, s_count[slot], s_mean[at], s_m2[at]);
      }
    }
    segment_merge(n, mean, m2);
    if (group < g.groups && sub == 0) {
      const long long at = ((long long)image * g.groups + group) * g.chunks + k;
      part.count[at] = n;
      part.mean[at] = mean;
      part.m2[at] = m2;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_apply_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                            const void* __restrict__ beta, int param_f32, Partials part,
                            T* __restrict__ y, const Geometry g, float eps, int silu) {
  constexpr int V = Pack<T>::V;
  extern __shared__ float smem[];  // mean[G], rstd[G]
  float* s_mean = smem;
  float* s_rstd = smem + g.groups;

  const int image = blockIdx.y, k = blockIdx.x;
  const int v = threadIdx.x % g.vpr, r = threadIdx.x / g.vpr;
  const bool loads = r < g.rows;  // the threads past R * vpr only merge
  float scale[V], shift[V];       // gamma and beta first, loaded while the merge runs
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = loads ? param(gamma, v * V + i, param_f32) : 0.f;
    shift[i] = loads ? param(beta, v * V + i, param_f32) : 0.f;
  }

  // Each group's chunk partials, merged as the statistics launch merges its
  // states; the trip count is the same for every thread, so whole warps
  // shuffle.
  const int seg = threadIdx.x / kSeg, sub = threadIdx.x % kSeg, segs = blockDim.x / kSeg;
  for (int first = 0; first < g.groups; first += segs) {
    const int group = first + seg;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    if (group < g.groups) {
      const long long at = ((long long)image * g.groups + group) * g.chunks;
#pragma unroll 4
      for (int c = sub; c < g.chunks; c += kSeg) {
        chan_merge(n, mean, m2, part.count[at + c], part.mean[at + c], part.m2[at + c]);
      }
    }
    segment_merge(n, mean, m2);
    if (group < g.groups && sub == 0) {
      s_mean[group] = mean;
      s_rstd[group] = rsqrtf(m2 / n + eps);
    }
  }
  __syncthreads();

  if (!loads) return;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = v * V + i;
    const int grp = c / g.cpg;
    scale[i] *= s_rstd[grp];
    shift[i] = fmaf(-scale[i], s_mean[grp], shift[i]);
  }
  const long long offset = (long long)image * g.hw * g.channels + v * V;
  const T* col = x + offset;
  T* out = y + offset;
  const int row_end = min((k + 1) * g.chunk, g.hw);
  for (int row = k * g.chunk + r; row < row_end; row += kUnroll * g.rows) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = row + u * g.rows;
      if (rr < row_end) raw[u] = *reinterpret_cast<const uint4*>(col + (long long)rr * g.channels);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = row + u * g.rows;
      if (rr >= row_end) break;
      float f[V];
      Pack<T>::unpack(raw[u], f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[i] = Pack<T>::round(fmaf(f[i], scale[i], shift[i]));
        if (silu) f[i] = f[i] / (1.f + expf(-f[i]));
      }
      *reinterpret_cast<uint4*>(out + (long long)rr * g.channels) = Pack<T>::pack(f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, int param_f32,
                   float* partials, void* y, const Geometry& g, float eps, int silu,
                   cudaStream_t stream) {
  const int threads = (g.rows * g.vpr + 31) / 32 * 32;
  const dim3 grid(g.chunks, g.batch);
  const long long plane = (long long)g.batch * g.groups * g.chunks;
  const Partials part{partials, partials + plane, partials + 2 * plane};
  const int stats_smem = (2 * g.rows * g.channels + g.rows) * (int)sizeof(float);
  group_norm_stats_kernel<T><<<grid, threads, stats_smem, stream>>>(static_cast<const T*>(x),
                                                                    part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_norm_apply_kernel<T><<<grid, threads, 2 * g.groups * (int)sizeof(float), stream>>>(
      static_cast<const T*>(x), gamma, beta, param_f32, part, static_cast<T*>(y), g, eps, silu);
  return cudaGetLastError();
}

}  // namespace riffgn

// x and y: (batch, H*W, channels) contiguous (a channels_last tensor's
// storage), 16-byte aligned; gamma and beta: (channels,) bf16 or fp32
// (param_f32); partials: 3 * batch * groups * chunks fp32 of scratch.
// dtype: 0 = bfloat16, 1 = float32. rows, chunk and chunks as
// ops/group_norm.py `tiling` gives them. Returns a cudaError_t value: 0 when
// both launches were accepted.
extern "C" int riff_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                               float* partials, int batch, int hw, int channels, int groups,
                               int rows, int chunk, int chunks, float eps, int silu, int dtype,
                               int param_f32, int device, void* stream) {
  using namespace riffgn;
  const int V = dtype == 0 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 65535 || hw <= 0 || channels <= 0 ||
      groups <= 0 || channels % groups != 0 || channels % V != 0 || rows <= 0 || chunk <= 0 ||
      chunks <= 0 || (long long)(chunks - 1) * chunk >= hw || (long long)chunks * chunk < hw ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{batch, hw, channels, groups, channels / groups, channels / V, rows, chunk, chunks};
  if ((g.rows * g.vpr + 31) / 32 * 32 > kMaxThreads ||
      (2 * g.rows * g.channels + g.rows) * (long long)sizeof(float) > kMaxSmem ||
      2 * groups * (long long)sizeof(float) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  // Each library carries its own (static) CUDA runtime, whose current device
  // is not PyTorch's: select the operands' device before launching.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch<__nv_bfloat16>(x, gamma, beta, param_f32, partials, y, g, eps,
                                                 silu, st)
                    : (int)launch<float>(x, gamma, beta, param_f32, partials, y, g, eps, silu,
                                         st);
}
