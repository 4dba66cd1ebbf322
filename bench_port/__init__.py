"""The benchmark of riffusion_tpu_torch on the H100 (BENCHMARK.json)."""
