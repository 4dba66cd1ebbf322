#!/usr/bin/env python3
"""
Time one forward kernel, built from each of several copies of
riffusion_tpu_torch/csrc/, in turns, at the shapes its paths give it, in
one process on one CUDA card:

    python3 scripts/time_kernel_variants.py [--kernel attention] DIR [DIR ...]

`--kernel row_attention` (the default) is K2, timed at the batched path's
(32, 4096, 8*40) bf16; `--kernel attention` is K1, timed at (2, 4096, 8*40)
and (2, 1024, 8*80) (the single-clip path), (32, 1024, 8*80) (the batched
path's seq-1024 sites) and, writing the log-sum-exp, at (4, 4096, 8*40) and
(4, 1024, 8*80) (fine-tuning). Each DIR is a full copy of the kernel sources
with one change to try (make them under a directory .gitignore lists, e.g.
.chipwork/); the kernel's C entry point must take the same arguments in
every DIR. For each DIR the script prints every instance's ptxas registers
and spills and the number of ptxas notes that it injected a
warpgroup.arrive (a register of a wgmma operand written between two
wgmma), and holds two batch rows of each shape's output (and of its
log-sum-exp, where it writes one) to the plain version. Then it prints two
rounds of the median of 20 calls (CUDA events, after 3 warm-up calls) for
every DIR in turn at each shape, and the library forward (torch's
scaled_dot_product_attention on heads-first copies) as the yardstick, with
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = {  # kernel -> (batch, seq, heads, head_dim, writes the log-sum-exp)
    "row_attention": ((32, 4096, 8, 40, False),),
    "attention": ((2, 4096, 8, 40, False), (2, 1024, 8, 80, False), (32, 1024, 8, 80, False),
                  (4, 4096, 8, 40, True), (4, 1024, 8, 80, True)),
}


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(SHAPES), default="row_attention")
    parser.add_argument("dirs", nargs="+")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernel_variants: no CUDA device")
    sys.path.insert(0, str(REPO))
    from riffusion_tpu_torch.ops import attention as attn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    name = args.kernel
    source, entry = attn.KERNELS[name]
    fns = {}
    for d in args.dirs:
        attn.KERNELS[name] = (Path(d) / source.name, entry)
        attn._built.pop(name, None)
        built = attn.build_kernels((name,))[name]
        fns[d] = built.fn
        for instance, registers, spills in attn.ptxas_instances(built.compiler_log):
            print(d, instance, registers, "|", spills, flush=True)
        print(d, "ptxas notes of an injected warpgroup.arrive:",
              sum("warpgroup.arrive is injected" in line for line in built.compiler_log.splitlines()),
              flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, s, h, d, with_lse in SHAPES[name]:
        scale = d**-0.5
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lse = torch.empty(b, h, s, device=dev) if with_lse else None
        ref = attn.attention_reference(q[:2], k[:2], v[:2], num_heads=h, scale=scale)
        ref_lse = torch.logsumexp(torch.einsum(
            "bqhd,bkhd->bhqk", q[:2].float().view(2, s, h, d), k[:2].float().view(2, s, h, d))
            * scale, dim=-1) if with_lse else None

        def run(fn):
            out = torch.empty_like(q)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                    out.stride(0), out.stride(1), b, s, s, h, d, scale, 0, dev.index or 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
            return out

        shape = f"({b}, {s}, {h}*{d}{', LSE' if with_lse else ''})"
        for dir_ in args.dirs:
            out = run(fns[dir_])
            torch.cuda.synchronize()
            lse_err = "" if lse is None else \
                f"; LSE max abs error {float((lse[:2] - ref_lse).abs().max()):.3e}"
            print(dir_, shape, "(max abs, rel RMS, ok) against the plain version:",
                  attn.compare_to_plain(out[:2], ref), lse_err, flush=True)
        for round_ in range(2):
            for dir_ in args.dirs:
                print(round_, dir_, shape, name, "ms", _median_ms(torch, lambda: run(fns[dir_])),
                      flush=True)
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2).contiguous() for x in (q, k, v))
        print(shape, "library forward ms", _median_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                             scale=scale)),
            flush=True)
        del q, k, v, lse, ref, ref_lse, qh, kh, vh
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
