"""CI-scale structured golden: a downsized gen_structured instance through
the full CLI solve + independent checker on the 8-device virtual mesh.

This exercises the skew-balanced mesh path end-to-end on the instance
*class* the chip bench targets (benchmarks/gen_structured.py:
power-law Zipf column popularity, alpha=1.2 — the shape of factorization
relation matrices).  The reference's published numbers are on structured
course matrices, not uniform random (reference benchmarks/times.txt),
and its test discipline runs the challenge instance class end to end
(doc/sujet.pdf section 4); this is our CPU-sized analogue of the
skew1Mx750k solve + checker (ROADMAP A7).
"""

import numpy as np

from block_lanczos_tpu.utils import checker, cli, mmio
from block_lanczos_tpu.utils.gen import random_sparse_skewed

# Downsized gen_structured config: same generator, same alpha/density/seed
# class, 4:3 aspect (rows > cols so the left kernel is wide).
NROWS, NCOLS, DENSITY, SEED, ALPHA = 3000, 2250, 14, 9, 1.2


def _write_structured(path):
    i, j, x = random_sparse_skewed(NROWS, NCOLS, DENSITY, seed=SEED,
                                   alpha=ALPHA)
    mmio.write_coo_mtx(str(path), NROWS, NCOLS,
                       i.astype(np.int64), j.astype(np.int64), x)


def test_structured_gf2_cli_mesh_solve_and_check(tmp_path, capsys):
    """GF(2) n=32 on the 8-device mesh (the chip job's field/config class):
    rc=0, skew-balanced partition engaged, independent checker passes."""
    mtx = tmp_path / "skew_ci.mtx"
    out = tmp_path / "skew_ci_kernel.mtx"
    _write_structured(mtx)

    # 2x4 grid: the Zipf-skewed axis (columns) is actually partitioned, so
    # the balanced band maps must engage (an 8x1 grid would leave the
    # skewed axis unsplit)
    rc = cli.main(["--matrix", str(mtx), "--prime", "2", "--n", "32",
                   "--grid", "2", "4", "--salvage",
                   "--output-file", str(out)])
    captured = capsys.readouterr().out
    assert rc == 0, captured
    # the skew-balanced partitioner must actually engage on this class
    assert "balanced" in captured, captured
    assert checker.check_kernel_file(str(mtx), str(out), 2) is True
    # kernel files are array-format (column-major, reference-compatible);
    # the size line is the first non-comment line: "nrows ncols"
    with open(out) as fh:
        size = next(ln for ln in fh if not ln.startswith("%"))
    assert int(size.split()[1]) >= 1  # non-trivial kernel found


def test_structured_narrow_cli_mesh_solve_and_check(tmp_path, capsys):
    """Narrow field on the same structured class (n=4, smaller instance so
    the CPU-suite cost stays bounded); checker-validated."""
    i, j, x = random_sparse_skewed(900, 640, 10, seed=SEED, alpha=ALPHA)
    mtx = tmp_path / "skew_ci_p.mtx"
    out = tmp_path / "skew_ci_p_kernel.mtx"
    mmio.write_coo_mtx(str(mtx), 900, 640, i.astype(np.int64),
                       j.astype(np.int64), x)

    rc = cli.main(["--matrix", str(mtx), "--prime", "1073741789",
                   "--n", "4", "--grid", "2", "4",
                   "--output-file", str(out)])
    captured = capsys.readouterr().out
    assert rc == 0, captured
    assert "balanced" in captured, captured
    assert checker.check_kernel_file(str(mtx), str(out), 1073741789) is True
