// Non-causal multi-head attention forward, O = softmax(Q K^T * scale) V, for
// Hopper (sm_90a), writing each query row's log-sum-exp when training asks
// for it. Built by riffusion_tpu_torch/ops/attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point, riff_attention_forward.
//
// What it replaces. The JAX package runs UNet self-attention as Pallas on
// the TPU in two places:
//   K1  jax.experimental.pallas.ops.tpu.flash_attention, called from
//       riffusion_tpu/models/layers.py Attention.__call__ (flash branch) at
//       UNet batch <= 8 (the single-clip path, fine-tuning) and at the
//       seq-1024 sites above it (the batched path);
//   K2  riffusion_tpu/ops/attention.py full_row_attention, the batched
//       serving path's seq-4096 sites (UNet batch > 8).
// This file is the Hopper counterpart of K1 (row_attention.cu is K2's). It
// keeps Q, K, V and O in the packed (b, s, h*d) layout the to_q / to_k /
// to_v projections emit, read through (batch, seq) strides with the head
// picked by a column offset; no transpose or pad copy exists. With an LSE
// buffer it writes the (b, h, s_q) fp32 natural-log log-sum-exp that the
// backward kernels (attention_dkv.cu, attention_dq.cu) read.
//
// What bounds it on this card. At the single path's seq-4096 sites
// (2, 4096, 8*40) one call is 4*b*h*s*s*d = 43 GFLOP (0.043 ms at
// 989 TFLOP/s) against 21 MB of operands and output (0.006 ms at
// 3.35 TB/s) and one exp2 per logit, 268M of them: 0.064 ms at the SFUs'
// 16 a clock on each of 132 SMs at 1980 MHz. At d = 40 the exponentials set
// the bound; at the d = 80 sites the tensor cores do.
//
// What the design does about it. K1 runs attention_fwd.cuh's bf16 body, the
// one K2 runs: wgmma for both products with P fed from registers, a 3-stage
// cp.async K/V ring, one FFMA and one ex2.approx per logit (that file says
// more). Two warpgroups per block, 128 query rows, at every shape: one
// warpgroup (64 rows, twice the blocks, each copying its own K/V tiles) was
// slower at every shape K1's paths give it, although two leave SMs idle at
// (2, 1024, 8*80) (128 blocks) and end in a partial wave at
// (2, 4096, 8*40) (512 blocks for 396 slots). On an H100 80GB HBM3 at
// 700 W (scripts/time_kernel_variants.py --kernel attention, two rounds in
// one call, ms; one warpgroup / two / the mma.sync body before it):
//   (2, 4096, 8*40)          0.353-0.354 / 0.222-0.226 / 0.507-0.509
//   (2, 1024, 8*80)          0.081-0.083 / 0.052-0.062 / 0.090-0.104
//   (32, 1024, 8*80)         0.665-0.671 / 0.394-0.400 / 0.906-0.907
//   (4, 4096, 8*40) with LSE 0.655-0.660 / 0.402-0.413 / 1.064-1.080
//   (4, 1024, 8*80) with LSE 0.141-0.144 / 0.072-0.087 / 0.149-0.152
// One warpgroup doubles the K/V copies per query row, and at these sizes
// the copies cost more than the extra blocks win. The serving instances
// are compiled without the LSE write.
//
// An fp32 instance (attention_common.cuh's attention_f32_kernel: plain
// FMA, one thread per query row, the same online softmax) exists so the
// kernel can be held against its plain version at fp32 tolerance; the
// serving and training paths run the bf16 instances.

#include "attention_fwd.cuh"

extern "C" int riff_attention_forward(const void* q, const void* k, const void* v, void* o,
                                      float* lse, long long q_sb, long long q_ss, long long k_sb,
                                      long long k_ss, long long v_sb, long long v_ss,
                                      long long o_sb, long long o_ss, int batch, int s_q,
                                      int s_kv, int num_heads, int head_dim, float scale,
                                      int dtype, int device, void* stream) {
  riff::Params p;
  const int rc = riff::fwd_params(p, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                                  o_ss, batch, s_q, s_kv, num_heads, head_dim, scale, dtype,
                                  device);
  if (rc != 0) return rc;
  return lse != nullptr ? riff::fwd_launch<2, true>(p, dtype, batch, num_heads, stream)
                        : riff::fwd_launch<2, false>(p, dtype, batch, num_heads, stream);
}
