"""Tools around the engine: conversion between the JAX package's arrays
and the port's tensors, the on-disk artifact cache (plans, tile sets,
RMAT edge lists), checkpoints, the edge-list converter, phase timing and
the tracer, the state statistics oracle, the device-memory probes
(``bw_probe``, ``route_cost_probe``), and the kernel lab (``kernel_lab``,
``lab_table``)."""
