"""qsvc_tpu_torch — the PyTorch/CUDA port of the qsvc_tpu video codec.

Mirrors the layout of the JAX package (``ops/``, ``mctf/``, ``codec/``,
``io/``, ``scal/``, ``utils/``, ``parallel/``, ``config.py``, ``api.py``,
``cli.py``) and never imports it or JAX.  Tensors stay on the device the caller names on the ``api`` entry
points; on a CUDA device the motion search, prediction and update run in
the hand-written kernels under ``csrc/``, on the CPU in their plain
PyTorch versions.  The native EBCOT coder is built from the port's own
copy of the JAX package's C++ source (``native/ebcot.cpp``, held
byte-identical by a test), so both packages write byte-identical
containers.
"""

__version__ = "0.1.0"
