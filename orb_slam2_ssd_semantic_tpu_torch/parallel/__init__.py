"""Multi-device code on torch.distributed (counterpart of the JAX package's
`parallel/`): the mesh and its collectives, sharded bundle adjustment,
keyframe-sharded place recognition and X-slab occupancy."""
