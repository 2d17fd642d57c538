"""Plain references of the benchmark's vertex programs: NumPy (and, for
the lower-precision controls, plain PyTorch) over the stored edge list,
independent of the program under test."""
