"""block_lanczos_tpu — exact sparse linear algebra over GF(p) in JAX.

A from-scratch JAX/XLA framework with the capability set of the
reference C project (`block-lanczos-algorithm-parallelization`): computing a
block of kernel vectors of x*M == 0 (mod p) (or M*x == 0) for large sparse
integer matrices via the block Lanczos algorithm of E. Thome, with exact
modular arithmetic, multi-device sharding, checkpoint/resume, an independent
checker, and a benchmark harness.

Layout (mirrors SURVEY.md section 7):
  ops/       exact GF(p) field arithmetic, sparse & dense mod-p kernels
  models/    the block Lanczos solver driver (single-chip and sharded)
  parallel/  device mesh, sharding, exact mod-p collectives
  utils/     MatrixMarket IO, xoshiro256+ RNG, checkpointing, CLI, checker
  native/    C acceleration for host-side IO/RNG (optional, ctypes)
"""

from block_lanczos_tpu.ops.gfp import GFp

__version__ = "0.1.0"

__all__ = ["GFp", "__version__"]
