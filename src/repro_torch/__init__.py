"""PyTorch + CUDA port of the offline CoCaR pipeline (paper Alg. 1 +
Sec. V-D) for one NVIDIA H100.

Module names follow the JAX package ``repro`` so each counterpart is easy
to find; this package imports neither JAX nor ``repro``.  Every public
entry point takes ``device=`` (default ``"cuda"``) and raises when no card
is present instead of moving to the CPU; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.
"""
