"""Hand-written CUDA kernels of the port, one package per TPU kernel of
the reference.

Each kernel package ships three pieces:
  ``csrc/<name>.cu`` — the CUDA C++ kernel for ``sm_90a`` with a plain C
                       launch function, built by ``_build.py``;
  ``ops.py``         — the wrapper: checks, allocation, launch on the
                       current stream, a ``launches`` counter;
  ``ref.py``         — the plain PyTorch version, which the wrapper runs
                       for CPU tensors and the tests compare against.

``fused_refine`` (B7) replaces no TPU kernel (the reference's fused refine
is jnp); its plain version is the eager chunk loop of
``spatial.refine.fused_refine_lanes``, which dispatches between the two.
"""
