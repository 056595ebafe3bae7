"""Domain-decomposed forms (the port of ``cdk_tpu.dist``).

`mesh` is a single-process mesh of P logical shards on one torch.device
(and a (pi, pj) grid of them); `mpdata` is the x-decomposed MPDATA with
halo exchange and the slice-batch loop on it; `biharmonic` the
element-sharded biharmonic and the decomposed ring- and torus-DSS forms."""
