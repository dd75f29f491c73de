"""PyTorch + CUDA port of the batched halo2 aggregation verifier and the
accelerated prover.

The JAX package `halo2_snark_aggregator_tpu` stays the reference; this
package keeps its own copies of the framework-free host layer (the same
relative paths; tests/test_torch_host_copies.py holds them equal) and runs
the device stages through hand-written CUDA kernels (`csrc/`) for an
NVIDIA H100. It imports neither jax nor the JAX package.
"""
