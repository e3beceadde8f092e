"""PyTorch port of the NK ocean-tracer Jacobian preconditioner solver.

The JAX package ``nk_ocn_tracer_jacobian_precond_tpu`` stays the reference;
this package runs its stage 1 (``drivers.gen_a``: assemble the Jacobian
matrix file) and its stage 2 (the ``solve`` workflow: factor the gen_A
matrix once, solve every tracer right-hand side, write the results in
place) on one CUDA device. The host layers (``io``, ``grid``, ``ops``,
``testdata``, ``native``, ``utils``, the symbolic analysis and memory plan
under ``solver``, ``drivers.config`` and ``drivers.gen_a``) are copies of
the reference's numpy and C++ host code; the numeric phase is PyTorch plus
the hand-written CUDA kernels under ``csrc/``. Nothing here imports jax or
the reference package.
"""

__version__ = "0.1.0"
