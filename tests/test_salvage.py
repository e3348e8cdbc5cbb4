"""Kernel salvage from partially-converged blocks (beyond the reference,
which just reports KO — sequential/lanczos_modp.c:560-582)."""

import numpy as np

from block_lanczos_tpu.models.lanczos import BlockLanczos
from block_lanczos_tpu.models.lanczos_gf2 import BlockLanczosGF2
from block_lanczos_tpu.utils import mmio
from block_lanczos_tpu.utils.gen import random_sparse
from block_lanczos_tpu.utils.salvage import salvage_kernel


def spmv_oracle(p, M, X):
    y = np.zeros((M.ncols, X.shape[1]), dtype=object)
    Xo = X.astype(object)
    for a, b, c in zip(M.i, M.j, M.x):
        y[b] = (y[b] + int(c) * Xo[a]) % p
    return y


def test_salvage_known_p2_breakdown():
    """The seed-9 p=2 n=32 right-kernel instance fails the final check for
    BOTH this framework (with the reference's verbatim operator,
    dedup=False) and the reference; salvage recovers verified kernel
    vectors from the same block."""
    i, j, x = random_sparse(64, 96, 5, seed=9)
    M = mmio.COOMatrix(64, 96, len(x), i.astype(np.int32), j.astype(np.int32),
                       (x % 2).astype(np.uint32), 2)
    res = BlockLanczosGF2(M, n=32, right=True, check_invariants=False,
                          dedup=False).solve()
    assert res.product_zero is False and res.vtM is not None  # the breakdown
    got = salvage_kernel(res.kernel, res.vtM, 2)
    assert got.shape[1] > 0
    # verify each salvaged column exactly: x^T M == 0 with M transposed
    # (right kernel: columns live on ncols, product over rows)
    Mt = mmio.COOMatrix(M.ncols, M.nrows, M.nnz, M.j, M.i, M.x, 2)
    y = spmv_oracle(2, Mt, got)
    assert (y == 0).all() and (got != 0).any()


def test_dedup_cures_known_p2_breakdown():
    """The same seed-9 instance under the default dedup=True: duplicate
    lines are dropped, rank(A) is restored, and the solve CONVERGES with a
    full verified kernel block — no salvage needed.  This is the
    production contract that replaces the reference's KO (PARITY.md
    'GF(2) dedup')."""
    i, j, x = random_sparse(64, 96, 5, seed=9)
    M = mmio.COOMatrix(64, 96, len(x), i.astype(np.int32), j.astype(np.int32),
                       (x % 2).astype(np.uint32), 2)
    solver = BlockLanczosGF2(M, n=32, right=True, check_invariants=False)
    assert solver.dedup_dropped[0] > 0  # duplicates actually exist here
    res = solver.solve()
    assert res.product_zero is True and res.v_nonzero is True
    Mt = mmio.COOMatrix(M.ncols, M.nrows, M.nnz, M.j, M.i, M.x, 2)
    y = spmv_oracle(2, Mt, res.kernel)
    assert (y == 0).all() and (res.kernel != 0).any()


def test_salvage_converged_block_is_identity():
    """On a fully-converged block, salvage returns (up to basis) n columns
    that are still exact kernel vectors."""
    p = 65537
    i, j, x = random_sparse(96, 64, 5, seed=7)
    M = mmio.COOMatrix(96, 64, len(x), i.astype(np.int32), j.astype(np.int32),
                       (x % p).astype(np.uint32), p)
    res = BlockLanczos(M, n=4).solve()
    assert res.product_zero and res.vtM is None
    # simulate: vtM == 0 -> every combination is a kernel vector
    vtM = np.zeros((M.ncols, 4), np.uint32)
    got = salvage_kernel(res.kernel, vtM, p)
    assert got.shape[1] == 4
    y = spmv_oracle(p, M, got)
    assert (y == 0).all()


def test_salvage_no_kernel_in_block():
    """A block with full-rank vtM has nothing to salvage."""
    p = 65537
    rng = np.random.default_rng(3)
    kernel = rng.integers(0, p, size=(30, 4)).astype(np.uint32)
    vtM = rng.integers(1, p, size=(20, 4)).astype(np.uint32)  # full rank whp
    got = salvage_kernel(kernel, vtM, p)
    assert got.shape[1] == 0


def test_combine_kernel_blocks_rank_filter():
    """Exact rank filter: dependent columns are dropped, independent kept
    (GF(2) bit-packed path and odd-p u64 path)."""
    from block_lanczos_tpu.utils.salvage import combine_kernel_blocks

    # GF(2): c2 = c0 ^ c1 is dependent; c3 duplicates c0
    rng = np.random.default_rng(5)
    c0 = rng.integers(0, 2, size=70).astype(np.uint32)
    c1 = rng.integers(0, 2, size=70).astype(np.uint32)
    blocks = [np.stack([c0, c1], axis=1),
              np.stack([(c0 ^ c1), c0], axis=1)]
    got = combine_kernel_blocks(blocks, 2)
    assert got.shape == (70, 2)
    np.testing.assert_array_equal(got[:, 0], c0)
    np.testing.assert_array_equal(got[:, 1], c1)

    # odd p: 3*c0 + 2*c1 dependent, c2 independent
    p = 65537
    a0 = rng.integers(0, p, size=50).astype(np.uint32)
    a1 = rng.integers(0, p, size=50).astype(np.uint32)
    a2 = rng.integers(0, p, size=50).astype(np.uint32)
    dep = ((3 * a0.astype(np.uint64) + 2 * a1) % p).astype(np.uint32)
    got = combine_kernel_blocks(
        [np.stack([a0, a1], axis=1), np.stack([dep, a2], axis=1)], p)
    assert got.shape == (50, 3)
    np.testing.assert_array_equal(got[:, 2], a2)

    # all-zero / empty edges
    assert combine_kernel_blocks([np.zeros((10, 2), np.uint32)], 2).shape[1] == 0
    assert combine_kernel_blocks([], 2).shape == (0, 0)


def test_salvage_restarts_meet_or_beat_single_yield():
    """On the seed-9 p=2 breakdown (reference-verbatim operator), restarts
    with fresh v0 blocks combine to AT LEAST the single-run salvage yield,
    every column exactly verified and exactly independent (the reference
    just KOs)."""
    from block_lanczos_tpu.utils.salvage import salvage_with_restarts

    i, j, x = random_sparse(64, 96, 5, seed=9)
    M = mmio.COOMatrix(64, 96, len(x), i.astype(np.int32), j.astype(np.int32),
                       (x % 2).astype(np.uint32), 2)
    solver = BlockLanczosGF2(M, n=32, right=True, check_invariants=False,
                             dedup=False)
    first = solver.solve()
    assert first.product_zero is False
    single = salvage_kernel(first.kernel, first.vtM, 2)

    combined = salvage_with_restarts(lambda: solver.solve(), first, 2, 32,
                                     restarts=2)
    assert combined.shape[1] >= single.shape[1] > 0
    # every combined column is an exact kernel vector
    Mt = mmio.COOMatrix(M.ncols, M.nrows, M.nnz, M.j, M.i, M.x, 2)
    y = spmv_oracle(2, Mt, combined)
    assert (y == 0).all() and (combined != 0).any(axis=0).all()


def test_cli_salvage_restarts_end_to_end(tmp_path):
    """--salvage-restarts through the CLI: the seed-9 breakdown instance
    (verbatim operator) produces a checker-verified kernel file whose
    column count >= the single-salvage yield."""
    from block_lanczos_tpu.utils import checker, cli

    i, j, x = random_sparse(64, 96, 5, seed=9)
    mtx = str(tmp_path / "m.mtx")
    mmio.write_coo_mtx(mtx, 64, 96, i, j, x)
    out = str(tmp_path / "k.mtx")
    rc = cli.main(["--matrix", mtx, "--prime", "2", "--n", "32", "--right",
                   "--single", "--no-checks", "--no-dedup", "--salvage",
                   "--salvage-restarts", "2", "--output-file", out])
    assert rc == 0
    assert checker.check_kernel_file(mtx, out, 2, right=True) is True


def test_sharded_solver_repeated_solve_fresh_blocks():
    """salvage_with_restarts re-calls solve() on the SAME solver object:
    the mesh solver must survive a second dispatch (matrix leaves are not
    donated) and produce a DIFFERENT v0 (the xoshiro stream continues)."""
    from block_lanczos_tpu.parallel.distributed_gf2 import (
        ShardedBlockLanczosGF2)
    from block_lanczos_tpu.parallel.mesh import make_mesh

    i, j, x = random_sparse(64, 96, 5, seed=9)
    M = mmio.COOMatrix(64, 96, len(x), i.astype(np.int32), j.astype(np.int32),
                       (x % 2).astype(np.uint32), 2)
    solver = ShardedBlockLanczosGF2(M, n=32, right=True, mesh=make_mesh(4),
                                    check_invariants=False, dedup=False)
    a = solver.solve(stop_after=2)
    b = solver.solve(stop_after=2)
    assert not np.array_equal(a.kernel, b.kernel)
