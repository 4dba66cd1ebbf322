// dK and dV of K1's attention, O = softmax(Q K^T * scale) V, over packed
// (b, s, h*d) operands, for Hopper (sm_90a). Built by
// riffusion_tpu_torch/ops/attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point, riff_attention_bwd_dkv.
//
// What it replaces. The first of the two Pallas kernels of the custom VJP of
// jax's TPU flash_attention (jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_bwd_dkv), which the JAX package's
// fine-tuning runs at every self-attention site of the UNet that takes K1
// (riffusion_tpu/models/layers.py, the flash branch) when it differentiates
// the train step. attention_dq.cu is the second.
//
// What bounds it on this card. It recomputes S = Q K^T and forms dP = dO V^T
// (the forward's work twice over) and adds dV = P^T dO and dK = dS^T Q: four
// products, 8*b*h*s*s*d FLOP, 172 GFLOP at the fine-tuning site
// (4, 4096, 8*40), against about 64 MB of operands and outputs: far above
// the card's ~295 bf16 FLOP/byte ridge, so tensor-core issue bounds it, and
// beside it the one exp2 per logit (537M there, about 0.13 ms of the SFUs).
//
// What the design does about it (attention_bwd.cuh holds the body and says
// more). One block of two warpgroups per (128-row K/V tile, head, batch
// row): the K and V tile is copied once into shared memory, and 64-row Q and
// dO tiles with their LSE and delta rows stream through a 4-stage cp.async
// ring. S^T and dP^T are wgmma products from shared memory; P^T and dS^T go
// from the accumulators, rounded to bf16, into the register A operand of
// dV += P^T dO and dK += dS^T Q, which read the same Q and dO tiles MN-major
// (no transposed copy). dK and dV stay in registers until the end, so each
// output row is written once, by one block, and no atomics are needed. The
// scale is applied once, on dK.
//
// An fp32 instance (one thread per K/V row, plain FMAs) exists so the kernel
// can be held against its plain version at fp32 tolerance.

#include "attention_bwd.cuh"

extern "C" int riff_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* g0, void* g1,
                                      long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                                      long long v_sb, long long v_ss, long long do_sb, long long do_ss,
                                      long long g_sb, long long g_ss, int batch, int s_q, int s_kv,
                                      int num_heads, int head_dim, float scale, int dtype, int device,
                                      void* stream) {
  return riff::attention_backward<riff::BwdKernel::kDkv>(
      q, k, v, dout, lse, delta, g0, g1, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, g_sb,
      g_ss, batch, s_q, s_kv, num_heads, head_dim, scale, dtype, device, stream);
}
