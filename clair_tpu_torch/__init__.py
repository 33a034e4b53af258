"""clair_tpu_torch — the calling path of clair_tpu in PyTorch, for an NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``clair_tpu`` stays the reference. This package ports what
touches JAX on the calling path and imports the rest, which is host code
free of JAX (pileup, decode, VCF, the runners):

- ``clair_tpu_torch.models``    checkpoint IO, SELU, the plain BiLSTM, ClairNet
- ``clair_tpu_torch.ops``       hand-written CUDA kernels and their wrappers
- ``clair_tpu_torch/csrc/``     the kernels' CUDA C++ sources (built by nvcc)
- ``clair_tpu_torch.pipeline``  the calling Predictor
- ``clair_tpu_torch.cli``       ``python -m clair_tpu_torch call_bam ...``

It imports torch and never jax.
"""
