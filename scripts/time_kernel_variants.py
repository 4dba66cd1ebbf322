#!/usr/bin/env python3
"""
Time K2's kernel (`row_attention`) at the batched path's (32, 4096, 8*40)
bf16 shape, built from each of several copies of riffusion_tpu_torch/csrc/,
in turns, in one process on one CUDA card:

    python3 scripts/time_kernel_variants.py DIR [DIR ...]

Each DIR is a full copy of the kernel sources with one change to try (make
them under a directory .gitignore lists, e.g. .chipwork/). For each DIR the
script prints the ptxas registers and spills of the d = 40 instance
(attention_fwd_bf16_kernel<48, 40>) and the number of ptxas notes that it
injected a warpgroup.arrive (a register of a wgmma operand written between
two wgmma), and holds two batch rows of the output to the plain version
(ops.attention.compare_to_plain). Then it prints two rounds of the median of
20 calls (CUDA events, after 3 warm-up calls) for every DIR in turn, and the
library forward (torch's scaled_dot_product_attention on heads-first copies)
as the yardstick, with the card's name and power limit first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
B, S, H, D = 32, 4096, 8, 40


def _median_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    samples = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def main(argv) -> int:
    if not argv:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernel_variants: no CUDA device")
    sys.path.insert(0, str(REPO))
    from riffusion_tpu_torch.ops import attention as attn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    entry = attn.KERNELS["row_attention"][1]
    fns = {}
    for d in argv:
        attn.KERNELS["row_attention"] = (Path(d) / "row_attention.cu", entry)
        attn._built.pop("row_attention", None)
        built = attn.build_kernels(("row_attention",))["row_attention"]
        fns[d] = built.fn
        log = built.compiler_log.splitlines()
        for i, line in enumerate(log):
            if "Compiling entry function '_ZN4riff25attention_fwd_bf16_kernelILi48ELi40E" in line:
                print(d, log[i + 2].strip(), "|", log[i + 3].strip(), flush=True)
        print(d, "ptxas notes of an injected warpgroup.arrive:",
              sum("warpgroup.arrive is injected" in line for line in log), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, S, H * D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    ref = attn.attention_reference(q[:2], k[:2], v[:2], num_heads=H, scale=D**-0.5)

    def run(fn):
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                out.stride(0), out.stride(1), B, S, S, H, D, D**-0.5, 0, dev.index or 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    for d in argv:
        out = run(fns[d])
        torch.cuda.synchronize()
        print(d, "(max abs, rel RMS, ok) against the plain version:",
              attn.compare_to_plain(out[:2], ref), flush=True)
    for round_ in range(2):
        for d in argv:
            print(round_, d, "K2 ms", _median_ms(torch, lambda: run(fns[d])), flush=True)
    qh, kh, vh = (x.view(B, S, H, D).transpose(1, 2).contiguous() for x in (q, k, v))
    print("library forward ms", _median_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                         scale=D**-0.5)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
