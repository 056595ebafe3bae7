"""Fault hooks of traffic `xsplit` (test_faults.py): the masked kernel K23,
launched a step at a time on each shard, and the f strips' exchange between
the shards (left out on two shards: one has no neighbour to hear from)."""

import torch

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.mpdata.masked", "masked_step_xmajor_split")
ANSWER = STEP
# (module, attribute) of the exchange between shards, and the traffic keys
# under which there is a neighbour to exchange with
EXCHANGE = ("cdk_torch.dist.mesh", "exchange_strips")
EXCHANGE_TRAFFIC = {"shards": 2}


def unchanged(f_loc, *a, **k):
    """STEP's stand-in: the state handed back unchanged, no flux."""
    return f_loc, f_loc.new_zeros(f_loc.shape[0], f_loc.shape[2])


def no_exchange(x, h, out=None):
    """EXCHANGE's stand-in: zero strips where the neighbours' would be."""
    return torch.zeros_like(x[:, :, :h]), torch.zeros_like(x[:, :, :h])
