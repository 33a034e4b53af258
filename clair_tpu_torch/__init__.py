"""clair_tpu_torch — clair_tpu in PyTorch, for an NVIDIA H100 (Hopper,
sm_90a): calling (BAM/CRAM -> VCF) and training.

The JAX package ``clair_tpu`` stays the reference. This package imports
nothing of it: it keeps its own copy of the host side (the same relative
paths, the imports pointing here), and ports what touches JAX:

- ``clair_tpu_torch.params``, ``task``, ``utils``, ``io``, ``data``
                                the host side: parameters, labels, BAM/CRAM/
                                FASTA/VCF IO, pileup, bins
- ``clair_tpu_torch.native``    the C++ pileup and decode engine (built by
                                g++ at first use into build/)
- ``clair_tpu_torch.models``    checkpoint IO, SELU, the plain BiLSTM, ClairNet
- ``clair_tpu_torch.ops``       hand-written CUDA kernels and their wrappers
- ``clair_tpu_torch/csrc/``     the kernels' CUDA C++ sources (built by nvcc)
- ``clair_tpu_torch.pipeline``  the calling Predictor and runners, training
- ``clair_tpu_torch.cli``       ``python -m clair_tpu_torch call_bam ...``

It imports torch and never jax.
"""
