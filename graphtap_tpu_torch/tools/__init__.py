"""Conversion between the JAX package's arrays and the port's tensors,
and the on-disk cache of host-built plans."""
