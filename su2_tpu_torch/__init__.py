"""su2_tpu_torch — the coupled REACTIVE_RANS step of su2_tpu (explicit or
implicit flow), ported to PyTorch with hand-written CUDA kernels for the
NVIDIA H100.

The JAX package (su2_tpu) stays the reference.  This package imports no JAX
and no su2_tpu module: the NumPy host modules (config, io, geometry,
chemistry/host) are carried over as copies, the solver layers are torch,
and every TPU kernel on the ported path is a CUDA kernel under csrc/
(built by kernels.py).  On CPU tensors each kernel's plain torch version
runs instead.
"""
