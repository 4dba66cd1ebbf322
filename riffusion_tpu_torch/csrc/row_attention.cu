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
// What bounds it on this card. Neither fits: an SM has 227 KB of shared
// memory and 64K registers. The arithmetic is 4*b*h*s*s*d = 687 GFLOP per
// call at (32, 4096, 8*40) against 2 * 84 MB of operands and output; with
// K/V re-read from L2 by every query tile, what limits this kernel is
// tensor-core issue and the shared-memory traffic of staging K/V tiles,
// not device memory.
//
// What the design does about it. The kernel body is attention_common.cuh's
// attention_bf16_kernel, which K1 (attention.cu) shares; what this file
// sets is its shape:
//   - Softmax: online, over 64-row K/V tiles, with the running max and sum
//     in fp32 in the log2 domain, in place of the one-pass row.
//   - K/V reuse: 8 warps per block, a 128-row query tile (8 x 16 rows), so
//     each staged K/V tile serves 128 query rows (K1's kernel: 64), halving
//     the K/V reads from L2; and the block order q tile fastest, then head,
//     then batch row, so one batch row's 5.2 MB of K/V stays in the 50 MB L2
//     while its 8 x 32 tiles run. (32, 4096, 8*40) is 32 x 8 x 32 = 8,192
//     blocks.
//   - K2's arithmetic: the scale*log2(e) fold, exp2, unnormalized P cast to
//     bf16 for P V, and the division by the row sum once, on the (128, d)
//     output after P V. The fold is one fp32 FFMA that forms the exp2
//     argument (s * c - m * c) from the fp32 logits accumulator. K2 folds
//     it into q in bf16 instead; on this card that buys nothing (the FFMA
//     forms the argument either way) and rounds the scaled q to bf16, which
//     costs up to 0.18 max abs error at large logits against the plain
//     version (tests/test_torch_attention.py emulates both).
//   - Tensor cores: mma.sync m16n8k16 bf16 with fp32 accumulation for Q K^T
//     and P V; d is zero-padded to a multiple of 16 in shared memory
//     (40 -> 48), which is exact. One instance per padded width, 16 to 128.
//   - Layout and bounds: Q, K, V and O are read through their (batch, seq)
//     strides with the head picked by a column offset; a ragged s_q and
//     s_kv are masked.
// wgmma, TMA and a K/V ring are later work: this version loads a tile,
// synchronizes, and computes.
//
// An fp32 instance (attention_common.cuh, 128 rows per block) exists so the
// kernel can be held against its plain version at fp32 tolerance; the
// serving path runs the bf16 instance.

#include "attention_common.cuh"

namespace {
constexpr int kWarps = 8;  // 16 query rows per warp: a 128-row query tile
}  // namespace

extern "C" int riff_row_attention_forward(const void* q, const void* k, const void* v, void* o,
                                          float* lse, long long q_sb, long long q_ss, long long k_sb,
                                          long long k_ss, long long v_sb, long long v_ss,
                                          long long o_sb, long long o_ss, int batch, int s_q,
                                          int s_kv, int num_heads, int head_dim, float scale,
                                          int dtype, int device, void* stream) {
  return riff::attention_forward<kWarps>(q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                         o_sb, o_ss, batch, s_q, s_kv, num_heads, head_dim,
                                         scale, dtype, device, stream);
}
