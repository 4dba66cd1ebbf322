// AdamW over a model's parameters in one pass, reading each gradient where
// the backward left it, for Hopper (sm_90a). Built by
// riffusion_tpu_torch/ops/attention.py build_kernels (in the trainer's
// round, ops.attention.TRAIN_KERNELS) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point, riff_adamw, launched
// by riffusion_tpu_torch/ops/adamw.py.
//
// What it replaces. No TPU kernel: the JAX trainer's step is one jitted
// program, and XLA fuses optax's AdamW into it. The port's fine-tuning step
// ran torch's capturable foreach AdamW on fp32 master gradients: first 686
// casts that widen the working copy's bf16 gradients into fresh fp32
// tensors, then about eight multi-tensor passes over the fp32 state (the
// decay, the lerp of m, v's multiply and addcmul, the square root, the
// division and the epsilon into a temporary, the addcdiv), about 80 bytes
// of traffic a parameter.
//
// What it computes, per element, all in fp32 (ops/adamw.py
// adamw_reference is the same arithmetic in torch operations):
//   g = the gradient, widened from bf16 exactly as .to(float32) widens it
//   s = the leaf's step count + 1
//   p = p * (1 - lr * wd)
//   m = m + (1 - b1) * (g - m)            (torch's lerp at a weight < 0.5)
//   v = v * b2 + (1 - b2) * g * g
//   p = p - (lr / (1 - b1^s)) * m / (sqrt(v) / sqrt(1 - b2^s) + eps)
// with the bias corrections 1 - b^s in double, rounded to fp32 once (as
// torch's AdamW computes them on the host from a Python step; in fp32,
// 1 - 0.999^s would keep only about four digits at the first steps), lr
// read from a device scalar and each leaf's step count from its own
// device scalar, so that a captured graph replays the update at each
// step's rate; after a launch's update a second launch adds 1 to the step
// counts of that launch's leaves.
//
// What bounds it on this card. Memory. An element reads its gradient (2
// bytes at bf16, 4 at fp32), its master, m and v (12) and writes the three
// (12): 26 bytes a parameter where the gradient is bf16. At SD v1's 859.5 M
// parameters that is 22.3 GB a step, 6.7 ms at 3.35 TB/s.
//
// What the design does about it.
//   - One pass: the gradient hand-off (the casts) and the update are the
//     same read of the gradient, and no temporary reaches device memory.
//   - Many leaves a launch: the leaves' addresses, sizes, gradient types and
//     step counters travel in the launch's parameters (a Batch of up to
//     kMaxLeaves leaves, under the 4 KB parameter limit), so nothing is
//     uploaded to the device and a capture records the launch as it is.
//     686 leaves take 10 launches of the update and 10 of the counts.
//   - A block takes chunks of kChunk elements of one leaf in a grid-stride
//     loop over the launch's chunks, finding a chunk's leaf by a binary
//     search over the cumulative chunk counts; the grid is sized by the
//     wrapper (ops/adamw.py BLOCKS_PER_SM, whose comment says how it was
//     chosen).
//   - 16-byte loads and stores (4 fp32 elements; 8 bytes of a bf16
//     gradient), kUnroll of each of the four streams in flight a thread,
//     coalesced across the warp; a leaf's last, partial chunk, and any leaf
//     whose addresses are not aligned, goes element by element.
//
// Each launch checks cudaGetLastError; a refused launch returns its error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace riffadam {

constexpr int kThreads = 256;
constexpr int kVec = 4;     // fp32 elements a 16-byte access
constexpr int kUnroll = 4;  // vectors of each stream in flight a thread
constexpr int kChunk = kThreads * kVec * kUnroll;  // elements a block updates at once
constexpr int kMaxLeaves = 72;                      // leaves a launch

// One launch's leaves and hyperparameters, passed by value.
struct Batch {
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* step[kMaxLeaves];
  long long n[kMaxLeaves];
  int chunk_end[kMaxLeaves];  // chunks of leaves 0..i
  unsigned char bf16[kMaxLeaves];  // the gradient's type: 1 bf16, 0 fp32
  int leaves;
  const float* lr;
  double b1, b2;
  float eps, wd;
};
static_assert(sizeof(Batch) <= 4000, "a launch's parameters must stay under 4 KB");

struct Coef {
  float decay, b1c, b2, b2c, step_size, bc2_sqrt, eps;
};

__device__ __forceinline__ void update(float& p, float& m, float& v, float g, const Coef& k) {
  p = p * k.decay;
  m = m + k.b1c * (g - m);
  v = v * k.b2 + k.b2c * g * g;
  p = p - k.step_size * m / (sqrtf(v) / k.bc2_sqrt + k.eps);
}

__device__ __forceinline__ float4 load4(const float* g) {
  return *reinterpret_cast<const float4*>(g);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* g) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float load1(const float* g) { return *g; }
__device__ __forceinline__ float load1(const __nv_bfloat16* g) { return __bfloat162float(*g); }

template <typename G>
__device__ __forceinline__ void run_chunk(float* p, float* m, float* v, const G* g, int count,
                                          const Coef& k) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                       reinterpret_cast<uintptr_t>(g) % (kVec * sizeof(G)) == 0;
  if (count == kChunk && aligned) {
    float4 P[kUnroll], M[kUnroll], V[kUnroll], Gr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = (u * kThreads + threadIdx.x) * kVec;
      P[u] = *reinterpret_cast<const float4*>(p + e);
      M[u] = *reinterpret_cast<const float4*>(m + e);
      V[u] = *reinterpret_cast<const float4*>(v + e);
      Gr[u] = load4(g + e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      update(P[u].x, M[u].x, V[u].x, Gr[u].x, k);
      update(P[u].y, M[u].y, V[u].y, Gr[u].y, k);
      update(P[u].z, M[u].z, V[u].z, Gr[u].z, k);
      update(P[u].w, M[u].w, V[u].w, Gr[u].w, k);
      const int e = (u * kThreads + threadIdx.x) * kVec;
      *reinterpret_cast<float4*>(p + e) = P[u];
      *reinterpret_cast<float4*>(m + e) = M[u];
      *reinterpret_cast<float4*>(v + e) = V[u];
    }
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads) {
      float pe = p[e], me = m[e], ve = v[e];
      update(pe, me, ve, load1(g + e), k);
      p[e] = pe;
      m[e] = me;
      v[e] = ve;
    }
  }
}

__global__ void __launch_bounds__(kThreads) adamw_kernel(const __grid_constant__ Batch b) {
  // the constants rounded to fp32 from the host's doubles, as torch's
  // operations round a Python scalar
  const float lr = *b.lr;
  const float decay = 1.0f - __fmul_rn(lr, b.wd);
  const float b1c = (float)(1.0 - b.b1), b2 = (float)b.b2, b2c = (float)(1.0 - b.b2);
  float s_done = 0.0f, step_size = 0.0f, bc2_sqrt = 0.0f;  // the bias corrections of s_done
  const int chunks = b.chunk_end[b.leaves - 1];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    int lo = 0, hi = b.leaves - 1;  // the first leaf whose chunks end after c
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (b.chunk_end[mid] > c) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int i = lo;
    const long long first = (long long)(c - (i ? b.chunk_end[i - 1] : 0)) * kChunk;
    const int count = (int)min((long long)kChunk, b.n[i] - first);
    const float s = *b.step[i] + 1.0f;
    if (s != s_done) {  // once a block where the leaves share their count
      step_size = lr / (float)(1.0 - pow(b.b1, (double)s));
      bc2_sqrt = sqrtf((float)(1.0 - pow(b.b2, (double)s)));
      s_done = s;
    }
    const Coef k{decay, b1c, b2, b2c, step_size, bc2_sqrt, b.eps};
    if (b.bf16[i]) {
      run_chunk(b.p[i] + first, b.m[i] + first, b.v[i] + first,
                static_cast<const __nv_bfloat16*>(b.g[i]) + first, count, k);
    } else {
      run_chunk(b.p[i] + first, b.m[i] + first, b.v[i] + first,
                static_cast<const float*>(b.g[i]) + first, count, k);
    }
  }
}

// After the launch's update has read them: each leaf's step count + 1.
__global__ void adamw_count_kernel(const __grid_constant__ Batch b) {
  for (int i = threadIdx.x; i < b.leaves; i += blockDim.x) *b.step[i] += 1.0f;
}

}  // namespace riffadam

// One AdamW step over `leaves` leaves: leaf i is params[i], exp_avgs[i],
// exp_avg_sqs[i] (fp32, numels[i] elements each), its gradient grads[i]
// (bf16 where grad_bf16[i], else fp32) and its step count steps[i] (an fp32
// scalar); lr is an fp32 device scalar. Launches go in batches of
// kMaxLeaves leaves, each update on a grid of at most `max_blocks` blocks,
// followed by its count launch. Returns 0 or the first CUDA error.
extern "C" int riff_adamw(void* const* params, void* const* exp_avgs, void* const* exp_avg_sqs,
                          const void* const* grads, void* const* steps, const long long* numels,
                          const int* grad_bf16, int leaves, const void* lr, double beta1,
                          double beta2, float eps, float weight_decay, int max_blocks, int device,
                          void* stream) {
  using namespace riffadam;
  if (leaves < 0 || max_blocks <= 0 || lr == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  // Each library carries its own (static) CUDA runtime, whose current device
  // is not PyTorch's: select the operands' device before launching.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int lo = 0; lo < leaves; lo += kMaxLeaves) {
    Batch b;
    b.leaves = leaves - lo < kMaxLeaves ? leaves - lo : kMaxLeaves;
    b.lr = static_cast<const float*>(lr);
    b.b1 = beta1;
    b.b2 = beta2;
    b.eps = eps;
    b.wd = weight_decay;
    long long chunks = 0;
    for (int j = 0; j < b.leaves; ++j) {
      const int i = lo + j;
      if (numels[i] < 0 || params[i] == nullptr || exp_avgs[i] == nullptr ||
          exp_avg_sqs[i] == nullptr || grads[i] == nullptr || steps[i] == nullptr) {
        return (int)cudaErrorInvalidValue;
      }
      b.p[j] = static_cast<float*>(params[i]);
      b.m[j] = static_cast<float*>(exp_avgs[i]);
      b.v[j] = static_cast<float*>(exp_avg_sqs[i]);
      b.g[j] = grads[i];
      b.step[j] = static_cast<float*>(steps[i]);
      b.n[j] = numels[i];
      b.bf16[j] = grad_bf16[i] ? 1 : 0;
      chunks += (numels[i] + kChunk - 1) / kChunk;
      if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      b.chunk_end[j] = (int)chunks;
    }
    if (chunks > 0) {
      const int grid = chunks < max_blocks ? (int)chunks : max_blocks;
      adamw_kernel<<<grid, kThreads, 0, st>>>(b);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    adamw_count_kernel<<<1, 128, 0, st>>>(b);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
