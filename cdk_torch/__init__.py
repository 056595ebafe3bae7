"""cdk_torch — the E3SM codesign-kernels suite on PyTorch and CUDA (Hopper).

The port of ``cdk_tpu`` to an NVIDIA H100: the same kernels, variant names,
deterministic inputs, verification norms and run protocol, with plain
PyTorch in place of ``jnp``/XLA and hand-written CUDA C++ (``csrc/``,
``sm_90a``) in place of each Pallas kernel on the main path.

It imports torch and numpy only, never jax: the parity tests are the one
place that loads both packages.

Kernels:
  - biharmonic: HOMME spectral-element tensor-hyperviscosity weak Laplacian
  - mpdata: SAM/MMF MPDATA positive-definite monotonic 2-D tracer advection
"""

__version__ = "0.1.0"
