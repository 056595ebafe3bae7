# imported in the JAX package's order, so the variants register (and run) in
# the same order in both packages
from cdk_torch.kernels.cke import gather_peradv, gather_selfold, onehot_mxu, lanegather, onehot, rows, staged  # noqa: F401,I001
from cdk_torch.kernels.cke.problem import CkeData, init_data  # noqa: F401
