"""nomad_tpu_torch: the PyTorch and CUDA port of nomad-tpu.

The placement path of the ``jax-binpack`` scheduler (fleet tensors,
constraint masks, the placement kernels, the host finish, the usage
mirror) runs here on an NVIDIA GPU through kernels written by hand in
CUDA C++ (``csrc/``).  The package imports nothing of JAX or of the
JAX package ``nomad_tpu``, which stays the reference it is tested
against.
"""

__version__ = "0.1.0"
