"""Kernel implementations: biharmonic, mpdata.

Importing this package registers all variants in cdk_torch.core.registry."""

from cdk_torch.kernels import biharmonic, mpdata  # noqa: F401
