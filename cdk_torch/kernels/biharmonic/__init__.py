from cdk_torch.kernels.biharmonic import operator, problem, reference, resident  # noqa: F401
from cdk_torch.kernels.biharmonic.problem import BiharmonicData, init_data  # noqa: F401
