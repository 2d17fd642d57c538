"""The vertex/tile partition, the R x C mesh on torch.distributed, the
multi-process runtime and the rank launcher."""
