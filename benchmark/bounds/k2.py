"""K2 (csrc/blocklu.cu blocklu_solve_kernel): the work that one launch's
function needs at B lanes of order n: each entry of the n x n factor
read once (the off-diagonal blocks of the LU and the needed triangles of
the diagonal blocks' inverses: n^2 floats in all), b read and x written;
one FMA an entry.  As chip_smoke.py's k2_work."""

KERNEL = "blocklu_solve_kernel"


def work(B, n):
    return B * 2 * n * n, B * 4 * (n * n + 2 * n)
