"""PyTorch/CUDA port of nanopore_tpu for NVIDIA Hopper cards.

The JAX package ``nanopore_tpu`` stays the reference; this package
mirrors its module names.  It imports torch and nothing of JAX or of
the reference package.  Entry points run on the card (``cuda``) unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper
runs its plain PyTorch version.

This slice covers the mapping main path (FASTQ -> SAM): host seeding
and chaining, the on-device band pack, the fused realign in decode
mode and the MEA walker, each a hand-written CUDA kernel under
``csrc/``.
"""
