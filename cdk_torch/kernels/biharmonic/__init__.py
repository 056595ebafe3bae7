from cdk_torch.kernels.biharmonic import (  # noqa: F401
    cube,
    dss,
    dss2d,
    dss2d_resident,
    dss2d_rowchain,
    dss_cube,
    dss_resident,
    operator,
    problem,
    reference,
    resident,
    fused,  # after resident: the variants list in the JAX package's order
)
from cdk_torch.kernels.biharmonic.problem import BiharmonicData, init_data  # noqa: F401
