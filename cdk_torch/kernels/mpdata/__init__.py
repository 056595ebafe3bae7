from cdk_torch.kernels.mpdata import problem, reference, resident  # noqa: F401
from cdk_torch.kernels.mpdata.problem import MpdataData, init_data  # noqa: F401
