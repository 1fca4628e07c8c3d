"""Microbenchmarks of the port's kernels on the card.

Counterparts of the JAX package's ``tools/bench_quant_matvec.py`` and
``tools/bench_unpack_ceiling.py``: the int4 serving matvec taken apart
into the byte stream, the unpack, three nibble unpacks, int8 weights and
output-major weights, each a hand-written CUDA kernel
(``sea_tpu_torch/csrc/quant_bench.cu``) with its plain PyTorch version
beside it. Run ``python -m sea_tpu_torch.tools.bench_quant_matvec`` or
``python -m sea_tpu_torch.tools.bench_unpack_ceiling``.
"""
