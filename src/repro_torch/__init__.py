"""PyTorch/CUDA port of the SWIS serving stack.

The package mirrors the JAX reference package ``repro`` module for module
(``configs``, ``core``, ``kernels``, ``models``, ``serve``) and imports only
``torch`` and ``numpy``. Its two hot kernels, the SWIS bit-plane matmul and
paged attention, are hand-written CUDA C++ for Hopper (``csrc/``), built
with ``nvcc`` at first use. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version instead.
"""
