"""Hand-written CUDA kernels for the compute layers on the RIMMS path.

Each kernel subpackage ships:
  <name>.py — the kernel's launcher (``csrc/<name>.cu`` through ctypes)
              and its plain torch version
  ops.py    — the public wrapper: checks, reshapes, and dispatch — the
              plain version for a CPU tensor, the kernel for a CUDA
              tensor, an error for anything else
  ref.py    — the torch oracle used by the tests

``_build`` compiles ``csrc/*.cu`` with nvcc on first use.
"""
