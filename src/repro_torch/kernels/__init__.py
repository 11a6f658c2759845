"""Hopper kernels of the port, one subpackage per reference Pallas kernel
(``kernel.py`` binding / ``ops.py`` wrapper / ``ref.py`` plain version);
CUDA sources live in ``csrc/`` and are built by ``_build.py``."""
