"""The benchmark of the PyTorch and CUDA port (``graphtap_tpu_torch``):
one cell run once by ``python3 -m benchmark.run``; see ``harness.py``."""
