"""Domain-decomposed forms (the port of ``cdk_tpu.dist``).

`mesh` is a single-process mesh of P logical shards on one torch.device;
`mpdata` is the x-decomposed MPDATA with halo exchange and the slice-batch
loop on it."""
