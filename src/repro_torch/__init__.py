"""``repro_torch`` — the PyTorch/CUDA port of the VEGETA reproduction.

A package beside the JAX reference ``repro``, with the same layout
(``core/``, ``kernels/``, ``models/``, ``serving/``, ``configs/``,
``launch/``) so each module's counterpart is found by name.  It imports
``torch`` and numpy only, never ``jax`` or ``repro``.  Every linear layer
of the serving path runs through a hand-written CUDA kernel for Hopper
(``kernels/csrc``); plain torch ops are the reference tier.
"""
