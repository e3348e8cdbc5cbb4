"""Multi-chip sharded block Lanczos via shard_map over a device mesh.

Replaces the reference's entire MPI layer (mpi/lanczos_modp.c:505-1409) with
a stateless SPMD design on a ("rows", "cols") grid mesh:

  * data stays sharded on device between iterations — there is NO root rank
    and NO per-iteration re-scatter (the reference's root re-sends v, Av, p
    slices every iteration: mpi/lanczos_modp.c:1152-1286),
  * the SpMV partial reductions are exact limb-split psums: tmp over the
    "rows" axis, Av over the "cols" axis (a no-op for a 1D rows-only mesh);
    the two n x n Gram reductions psum over "rows",
  * the tiny semi-inverse is computed redundantly on every device from the
    replicated Gram matrix — deterministic, so all devices agree on d/winv
    and the stop flag (the reference does the same on every rank:
    mpi/lanczos_modp.c:1764),
  * the whole iteration is ONE jitted shard_map program; per-iteration
    host traffic is the replicated stop flag only.

Bit-exactness holds for ANY grid shape because mod-p addition is
associative and commutative and every reduction is exact (SURVEY.md
section 2).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from block_lanczos_tpu.models import lanczos as single
from block_lanczos_tpu.models.lanczos import SolveResult
from block_lanczos_tpu.ops import dense, spmm
from block_lanczos_tpu.ops.gfp import GFp, u32
from block_lanczos_tpu.ops.semi_inverse import semi_inverse_device
from block_lanczos_tpu.parallel import sharding as shard_lib
from block_lanczos_tpu.parallel.collectives import psum_mod
from block_lanczos_tpu.parallel.mesh import COLS_AXIS, ROWS_AXIS
from block_lanczos_tpu.parallel.multihost import fetch_global, put_global
from block_lanczos_tpu.utils.mmio import COOMatrix
from block_lanczos_tpu.utils.rng import Xoshiro256Plus


def _local_step(f: GFp, ops: shard_lib.ShardedOps, check: bool,
                first_leaves, second_leaves, v_local, p_local):
    """Per-device body of one Lanczos iteration (runs under shard_map)."""
    first = ops.local_first(first_leaves)
    second = ops.local_second(second_leaves)

    tmp_partial = spmm.apply_op(f, first, v_local, out_rows=ops.mband)
    tmp = psum_mod(f, tmp_partial, ROWS_AXIS)   # sharded by cols
    av_partial = spmm.apply_op(f, second, tmp, out_rows=ops.band)
    Av_local = psum_mod(f, av_partial, COLS_AXIS)  # sharded by rows

    n = v_local.shape[1]
    grams = psum_mod(f, dense.gram_mod(
        f, jnp.concatenate([v_local, Av_local], axis=1), Av_local), ROWS_AXIS)
    vtAv, vtAAv = grams[:n], grams[n:]

    winv, d, npiv = semi_inverse_device(f, vtAv)  # redundant on every device
    stop = npiv == 0
    inv_ok = (single.check_invariants_device(f, vtAv, vtAAv, winv, d)
              if check else jnp.bool_(True))

    v_next, p_next = single.orthogonalize_device(
        f, v_local, Av_local, p_local, d, vtAv, vtAAv, winv)
    v_out = jnp.where(stop, v_local, v_next)
    p_out = jnp.where(stop, p_local, p_next)
    return v_out, p_out, tmp, vtAv, vtAAv, winv, d, stop, inv_ok


def _local_multi_step(f: GFp, ops: shard_lib.ShardedOps, check: bool,
                      first_leaves, second_leaves, v_local, p_local,
                      max_steps):
    """Per-device body: up to max_steps iterations in one lax.while_loop.

    Same host-sync amortization as models.lanczos.multi_iteration_step.
    The loop condition is identical on every device (stop/inv_ok derive from
    psum'd — replicated — n x n matrices), so collectives inside the loop
    stay aligned across the mesh.
    """
    n = v_local.shape[1]
    zed = jnp.zeros((n, n), u32)
    # tmp stays col-sharded across iterations -> its zero init must carry
    # the matching varying-manual-axes type ({V:cols})
    tmp0 = jax.lax.pcast(jnp.zeros((ops.mband, n), u32), (COLS_AXIS,),
                         to="varying")
    zeros = (tmp0, zed, zed, zed, jnp.zeros((n,), u32))
    return single.run_multi_step(
        lambda v, p: _local_step(f, ops, check, first_leaves,
                                 second_leaves, v, p),
        zeros, v_local, p_local, max_steps)


def _local_step_overlap(f: GFp, ops, check: bool,
                        fa, fb, sa, sb, v_local, p_local):
    """Chunked per-device iteration: each SpMV direction is split in two,
    so chunk A's exact psum is independent of chunk B's local compute and
    XLA's async collective scheduler can overlap them (the reference has
    no comm/compute overlap at all — SURVEY.md section 2 item 7)."""
    first_a = ops._local(ops.first_a, ops.ha, ops.band, fa)
    first_b = ops._local(ops.first_b, ops.mband - ops.ha, ops.band, fb)
    second_a = ops._local(ops.second_a, ops.hb, ops.mband, sa)
    second_b = ops._local(ops.second_b, ops.band - ops.hb, ops.mband, sb)

    tmp = jnp.concatenate([
        psum_mod(f, spmm.apply_op(f, first_a, v_local, out_rows=ops.ha),
                 ROWS_AXIS),
        psum_mod(f, spmm.apply_op(f, first_b, v_local,
                                  out_rows=ops.mband - ops.ha), ROWS_AXIS),
    ], axis=0)
    Av_local = jnp.concatenate([
        psum_mod(f, spmm.apply_op(f, second_a, tmp, out_rows=ops.hb),
                 COLS_AXIS),
        psum_mod(f, spmm.apply_op(f, second_b, tmp,
                                  out_rows=ops.band - ops.hb), COLS_AXIS),
    ], axis=0)

    n = v_local.shape[1]
    grams = psum_mod(f, dense.gram_mod(
        f, jnp.concatenate([v_local, Av_local], axis=1), Av_local), ROWS_AXIS)
    vtAv, vtAAv = grams[:n], grams[n:]
    winv, d, npiv = semi_inverse_device(f, vtAv)
    stop = npiv == 0
    inv_ok = (single.check_invariants_device(f, vtAv, vtAAv, winv, d)
              if check else jnp.bool_(True))
    v_next, p_next = single.orthogonalize_device(
        f, v_local, Av_local, p_local, d, vtAv, vtAAv, winv)
    v_out = jnp.where(stop, v_local, v_next)
    p_out = jnp.where(stop, p_local, p_next)
    return v_out, p_out, tmp, vtAv, vtAAv, winv, d, stop, inv_ok


def _local_multi_step_overlap(f: GFp, ops, check: bool,
                              fa, fb, sa, sb, v_local, p_local, max_steps):
    n = v_local.shape[1]
    zed = jnp.zeros((n, n), u32)
    tmp0 = jax.lax.pcast(jnp.zeros((ops.mband, n), u32), (COLS_AXIS,),
                         to="varying")
    zeros = (tmp0, zed, zed, zed, jnp.zeros((n,), u32))
    return single.run_multi_step(
        lambda v, p: _local_step_overlap(f, ops, check, fa, fb, sa, sb,
                                         v, p),
        zeros, v_local, p_local, max_steps)


class ShardedBlockLanczos:
    """Drop-in multi-device variant of models.BlockLanczos.

    `mesh` is a ("rows", "cols") grid (see parallel.mesh); a rows-only 1D
    factorization is the default and costs one collective per iteration.
    """

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 mesh: jax.sharding.Mesh | None = None,
                 pad_multiple: int = 8, check_invariants: bool = True,
                 sync_every: int | None = None, overlap: bool = False):
        from block_lanczos_tpu.parallel.mesh import make_mesh
        self.mesh = mesh if mesh is not None else make_mesh()
        self.f = GFp.make(M.prime)
        self.n = int(n)
        self.right = bool(right)
        self.check_invariants = check_invariants
        self.overlap = bool(overlap)
        if self.overlap:
            self.ops = shard_lib.partition_matrix_overlap(
                self.f, M, right, self.mesh, pad_multiple=pad_multiple)
        else:
            self.ops = shard_lib.partition_matrix(
                self.f, M, right, self.mesh, pad_multiple=pad_multiple,
                n=self.n)
        self.n_eff = self.ops.n_eff
        self.m_eff = self.ops.m_eff
        self.np_rows = self.ops.np_rows
        self.row_map = self.ops.row_map   # band layout of the kernel dim
        self.col_map = self.ops.col_map   # band layout of the other dim
        self.expected_iterations = 1 + self.m_eff // self.n
        self._rng = Xoshiro256Plus()
        self._vec_sharding = NamedSharding(self.mesh, P(ROWS_AXIS, None))

        nnz_spec = P(ROWS_AXIS, COLS_AXIS)
        v_spec = P(ROWS_AXIS, None)
        tmp_spec = P(COLS_AXIS, None)
        rep2 = P(None, None)
        out_specs = (v_spec, v_spec, tmp_spec, rep2, rep2, rep2,
                     P(None), P(), P())
        if self.overlap:
            op_specs = tuple(
                (nnz_spec,) * len(d.leaves())
                for d in (self.ops.first_a, self.ops.first_b,
                          self.ops.second_a, self.ops.second_b))
            mbody = partial(_local_multi_step_overlap, self.f, self.ops,
                            check_invariants)
            donate = (4, 5)
            self._step = None  # overlap mode is blocked-iteration only
        else:
            op_specs = tuple(
                (nnz_spec,) * len(d.leaves())
                for d in (self.ops.first, self.ops.second))
            body = partial(_local_step, self.f, self.ops, check_invariants)
            smapped = jax.shard_map(
                body, mesh=self.mesh,
                in_specs=(*op_specs, v_spec, v_spec),
                out_specs=out_specs)
            self._step = jax.jit(smapped, donate_argnums=(2, 3))
            mbody = partial(_local_multi_step, self.f, self.ops,
                            check_invariants)
            donate = (2, 3)
        msmapped = jax.shard_map(
            mbody, mesh=self.mesh,
            in_specs=(*op_specs, v_spec, v_spec, P()),
            out_specs=(*out_specs, P()))
        self._multi_step = jax.jit(msmapped, donate_argnums=donate)
        self.sync_every = sync_every

    def initial_block(self):
        """Global v0 from the sequential xoshiro stream, then shard.

        The xoshiro block is defined over TRUE kernel rows (bit-exact with
        the reference); row_map.scatter places it into this mesh's (possibly
        nnz-balanced) band layout — the iterates are layout-independent
        because mod-p arithmetic is exact."""
        block = self._rng.fill_mod(self.n_eff * self.n, self.f.p)
        v0 = self.row_map.scatter(block.reshape(self.n_eff, self.n))
        return put_global(v0, self._vec_sharding)

    def _step_args(self):
        if self.overlap:
            return self.ops.leaves()
        return (self.ops.first.leaves(), self.ops.second.leaves())

    def solve(self, stop_after: int = -1, verbose: bool = False,
              on_iteration: Callable | None = None,
              resume_state: dict | None = None) -> SolveResult:
        """Run to convergence (or `stop_after` iterations).

        `on_iteration` fires once per device-side iteration block (adaptive,
        up to 1024 iterations per dispatch under the default sync_every=None),
        not once per Lanczos iteration; construct with sync_every=1 for strict
        per-iteration callbacks (see models.lanczos.blocked_solve_loop).
        """
        ops = self.ops
        if resume_state is None:
            v = self.initial_block()
            p_blk = put_global(
                np.zeros((self.np_rows, self.n), np.uint32),
                self._vec_sharding)
            n_iterations = 0
        else:
            v = put_global(self.row_map.scatter(single.fit_rows(
                single.state_rows(resume_state, "v"), self.n_eff)),
                self._vec_sharding)
            p_blk = put_global(self.row_map.scatter(single.fit_rows(
                single.state_rows(resume_state, "p"), self.n_eff)),
                self._vec_sharding)
            n_iterations = int(resume_state["iteration"])
        if verbose:
            R, C = ops.grid
            print(f"Block Lanczos [sharded {R}x{C}]")
            if ops.stats is not None:
                print(ops.stats.summary())
            print(f"  - Expecting {self.expected_iterations} iterations")
            print("  - Main loop")

        args = self._step_args()

        def inv_fail(diag, iteration):
            vtAv, vtAAv, winv, d = diag
            single.check_invariants(self.f.p, vtAv, vtAAv, winv, d)

        v, p_blk, tmp, n_iterations, stopped_by_limit, start = \
            single.blocked_solve_loop(
                lambda v, p, k: self._multi_step(*args, v, p, np.uint32(k)),
                v, p_blk, n_iterations, stop_after, self.sync_every,
                on_iteration=on_iteration,
                inv_fail=inv_fail if self.check_invariants else None,
                solver=self)
        elapsed = time.time() - start
        v_host = self.row_map.gather(fetch_global(v))   # true row order
        v_nonzero = product_zero = None
        vtM = None
        if not stopped_by_limit:
            tmp_host = self.col_map.gather(fetch_global(tmp))
            v_nonzero, product_zero = single.final_check(
                v_host, tmp_host, self.n_eff, self.m_eff, verbose)
            if product_zero is False:
                vtM = tmp_host[:self.m_eff]
        if verbose:
            print(f"  - Terminated in {elapsed:.1f}s after "
                  f"{n_iterations} iterations")
        return SolveResult(kernel=v_host[:self.n_eff],
                           iterations=n_iterations,
                           v_nonzero=v_nonzero, product_zero=product_zero,
                           elapsed=elapsed, stopped_by_limit=stopped_by_limit,
                           vtM=vtM)
