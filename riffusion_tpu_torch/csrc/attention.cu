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
// This file is the Hopper counterpart of K1 (row_attention.cu is K2's). Like
// K2, it keeps Q, K, V and O in the packed (b, s, h*d) layout the
// to_q / to_k / to_v projections emit. The kernel reads them through
// (batch, seq) strides with the head picked by a column offset; no transpose
// or pad copy exists.
//
// What bounds it on this card. At the slice's largest sites (b=2, h=8,
// s=4096, d=40) one call is 4*b*h*s*s*d = 43 GFLOP against about 21 MB of
// operands: ~2000 FLOP per byte, far above the H100's ~295 bf16 FLOP/byte
// ridge. The kernel is bound by tensor-core issue, not by memory.
//
// What the design does about it. The TPU kernel keeps K/V blocks in VMEM; an
// SM has 227 KB of shared memory, so this is an online-softmax (flash)
// kernel that streams 64-row K/V tiles, with d zero-padded to a multiple of
// 16 in shared memory (40 -> 48, exact) and both products on the tensor
// cores (mma.sync m16n8k16 bf16, fp32 accumulation); the logits never leave
// registers. The kernel body is attention_common.cuh's
// attention_bf16_kernel, which K2 shares; this file launches it with 4 warps
// per block (a 64-row query tile), which at UNet batch 2 gives 1,024 blocks
// at the seq-4096 sites, enough to fill the card's 132 SMs. wgmma, TMA and
// a multi-stage pipeline are later work: this version loads a tile,
// synchronizes, and computes.
//
// An fp32 instance (plain FMA, one thread per query row, same online
// softmax) exists so the kernel can be held against its plain version at
// fp32 tolerance; the serving path runs the bf16 instance.

#include "attention_common.cuh"

namespace {
constexpr int kWarps = 4;  // 16 query rows per warp: a 64-row query tile
}  // namespace

extern "C" int riff_attention_forward(const void* q, const void* k, const void* v, void* o,
                                      long long q_sb, long long q_ss, long long k_sb,
                                      long long k_ss, long long v_sb, long long v_ss,
                                      long long o_sb, long long o_ss, int batch, int s_q,
                                      int s_kv, int num_heads, int head_dim, float scale,
                                      int dtype, int device, void* stream) {
  return riff::attention_forward<kWarps>(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                                         o_ss, batch, s_q, s_kv, num_heads, head_dim, scale,
                                         dtype, device, stream);
}
