"""Kernel implementations: biharmonic (and its DSS families), mpdata, cke.

Importing this package registers all variants in cdk_torch.core.registry."""

from cdk_torch.kernels import biharmonic, cke, mpdata  # noqa: F401
