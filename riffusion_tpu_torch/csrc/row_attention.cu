// Full-row attention forward for the batched UNet's large-sequence sites,
// O = softmax(Q K^T * scale) V over packed (b, s, h*d) operands, for Hopper
// (sm_90a). Built by riffusion_tpu_torch/ops/attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with one plain C entry point,
// riff_row_attention_forward.
//
// What it replaces. K2, riffusion_tpu/ops/attention.py full_row_attention
// (the pallas_call in _forward, body _make_kernel). The JAX package takes it
// at self-attention with lq >= 2048, lq % 512 == 0 and UNet batch > 8
// (models/layers.py Attention): the five seq-4096, 8-head, d=40 sites of the
// batched serving path, q/k/v (32, 4096, 320) bf16 at serving batch 16. On
// the TPU it stages one batch row's whole K and V (4096 x 320 bf16, 5.2 MB)
// in VMEM once, reuses it for all eight 512-row q blocks, and takes a
// one-pass softmax over a 512 x 4096 fp32 logits block (8 MB).
//
// What bounds it on this card. Neither fits an SM (227 KB of shared memory,
// 64K registers), so the softmax is online, over 64-row K/V tiles. At
// (32, 4096, 8*40) one call does 4*b*h*s*s*d = 687 GFLOP of products
// (0.69 ms at 989 TFLOP/s; 0.76 ms with Q K^T's reduction padded to 48)
// against 335 MB of operands and output (0.10 ms at 3.35 TB/s), and one
// exp2 per logit, 4.3e9 of them: 1.03 ms at the SFUs' 16 a clock on each
// of 132 SMs at 1980 MHz. At d = 40 the exponentials set the bound, so
// every instruction per logit besides the exp2 counts.
//
// What the design does about it (attention_fwd.cuh holds the body, which K1
// runs too, and says more):
//   - Tensor cores: wgmma, S = Q K^T from shared memory and O += P V with P
//     fed from the S accumulators as the register A operand, so the logits
//     never leave registers. V is read MN-major from the tile as it was
//     copied (no transposed copy) and P V runs 40 wide at d = 40.
//   - Copies: K and V stream through a 3-stage cp.async ring, two tiles
//     ahead of the products, one barrier per tile; d = 40 is zero-filled to
//     48 by the copies.
//   - Per logit: one FFMA (the scale*log2(e) fold), one ex2.approx, a max
//     and an add; the ragged-tail mask only on the last tile; the division
//     by the row sum once, on the (128, d) output after P V. The TPU kernel
//     folds the scale into q in bf16 instead; that rounds the scaled q and
//     costs up to 0.18 max abs error at large logits against the plain
//     version (tests/test_torch_attention.py emulates both).
//   - K/V reuse: a 128-row query tile (two warpgroups of 64 rows), so each
//     K/V tile serves 128 query rows; the query tile varies fastest, then
//     the head, then the batch row, so one batch row's 5.2 MB of K/V stays
//     in the 50 MB L2 while its 8 x 32 tiles run. (32, 4096, 8*40) is
//     32 x 8 x 32 = 8,192 blocks, three on each SM at once.
//   - Layout and bounds: Q, K, V and O are read through their (batch, seq)
//     strides with the head picked by a column offset; a ragged s_q and
//     s_kv are masked. One instance per padded width, 16 to 128.
//
// Times on an H100 80GB HBM3 at 700 W (scripts/time_attention_kernels.py,
// parent / change / change / parent in one call): at (32, 4096, 8*40)
// 2.649-2.673 ms, 257-259 TFLOP/s (the mma.sync body before it:
// 6.183-6.324 ms), against the library forward's 2.459-2.556 ms in the same
// call and the 1.027 ms exp2 bound: 39% of the bound. What holds it there is
// the latency of each warpgroup's chain (S, wait, exponentials, P V, wait),
// not the tensor cores or the SFUs (PERF.md section 6).
//
// The fp32 instance (attention_common.cuh's attention_f32_kernel, 128 rows
// per block) exists so the kernel can be held against its plain version at
// fp32 tolerance; the serving path runs the bf16 instance.

#include "attention_fwd.cuh"

// K2 writes no log-sum-exp (its gradient is the plain recompute): a buffer
// for one is refused. Two warpgroups per block, 128 query rows.
extern "C" int riff_row_attention_forward(const void* q, const void* k, const void* v, void* o,
                                          float* lse, long long q_sb, long long q_ss, long long k_sb,
                                          long long k_ss, long long v_sb, long long v_ss,
                                          long long o_sb, long long o_ss, int batch, int s_q,
                                          int s_kv, int num_heads, int head_dim, float scale,
                                          int dtype, int device, void* stream) {
  if (lse != nullptr) return (int)cudaErrorInvalidValue;
  riff::Params p;
  const int rc = riff::fwd_params(p, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                                  o_ss, batch, s_q, s_kv, num_heads, head_dim, scale, dtype,
                                  device);
  if (rc != 0) return rc;
  return riff::fwd_launch<2, false>(p, dtype, batch, num_heads, stream);
}
