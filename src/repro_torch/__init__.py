"""FreshDiskANN in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference): the same
module layout (``core/``, ``kernels/``, ``storage/``, ``checkpoint/``,
``serving/``, ``distributed/``, ``launch/``, ``data/``, ``models/``,
``optim/``, ``training/``), plain PyTorch
around nine kernels written by hand in CUDA C++ for ``sm_90a``.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version instead.
"""
