"""diffuscene-tpu, PyTorch/CUDA port for NVIDIA Hopper.

Second package beside the JAX reference ``diffuscene_tpu``; module paths
mirror it (``diffusion/``, ``models/``, ``ops/``, ``utils/``) so each part of
the port sits where its counterpart does.  Hand-written CUDA sources live in
``csrc/`` and are built at first use (``ops/build.py``).

This package imports torch and numpy only: never jax, flax, yaml or the
JAX package.
"""

__version__ = "0.1.0"
