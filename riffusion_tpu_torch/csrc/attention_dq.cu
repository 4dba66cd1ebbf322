// dQ of K1's attention, O = softmax(Q K^T * scale) V, over packed
// (b, s, h*d) operands, for Hopper (sm_90a). Built by
// riffusion_tpu_torch/ops/attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point, riff_attention_bwd_dq.
//
// What it replaces. The second of the two Pallas kernels of the custom VJP
// of jax's TPU flash_attention (jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_bwd_dq), run by the JAX package's
// fine-tuning at every self-attention site that takes K1; attention_dkv.cu
// is the first.
//
// What bounds it on this card. It recomputes S = Q K^T, forms dP = dO V^T
// and adds dQ = dS K: three products, 6*b*h*s*s*d FLOP, 129 GFLOP at the
// fine-tuning site (4, 4096, 8*40), against about 53 MB of operands and
// output: bound by tensor-core issue and, as much, by the one exp2 per logit
// (537M there, about 0.13 ms of the SFUs).
//
// What the design does about it (attention_bwd.cuh holds the body and says
// more). One block of two warpgroups per (128-row Q tile, head, batch row):
// Q and dO are copied once into shared memory with the rows' LSE and delta
// in registers, and 64-row K and V tiles stream through a 4-stage cp.async
// ring. S and dP are wgmma products from shared memory; dS goes from the
// accumulators, rounded to bf16, into the register A operand of dQ += dS K,
// which reads the same K tile MN-major (no transposed copy). dQ stays in
// registers and is written once, scaled, by its block: recomputing S here
// instead of sharing dS with the dK/dV kernel is what keeps both free of
// atomics, as the TPU's split does.
//
// An fp32 instance (one thread per query row, plain FMAs) exists so the
// kernel can be held against its plain version at fp32 tolerance.

#include "attention_bwd.cuh"

extern "C" int riff_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                     const float* lse, const float* delta, void* g0, void* g1,
                                     long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss, long long do_sb, long long do_ss,
                                     long long g_sb, long long g_ss, int batch, int s_q, int s_kv,
                                     int num_heads, int head_dim, float scale, int dtype, int device,
                                     void* stream) {
  return riff::attention_backward<riff::BwdKernel::kDq>(
      q, k, v, dout, lse, delta, g0, g1, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, g_sb,
      g_ss, batch, s_q, s_kv, num_heads, head_dim, scale, dtype, device, stream);
}
