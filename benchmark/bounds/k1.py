"""K1 (csrc/blocklu.cu blocklu_factor_kernel): the work that one launch's
function needs, whatever the algorithm, at B lanes of an n x n system
held in N x N (n padded to whole 64-wide blocks).

Flop: the no-pivot LU (at a trailing size m, m multipliers and an m x m
rank-1 update: m + 2 m^2, about 2/3 n^3 in all) and, for each diagonal
block of real size s, the inverses of its unit-lower (s(s-1)(s-2)/3) and
upper (s(s-1)(s+1)/3 + s) triangles.  Bytes: A read once; the factor
and both blocks' inverses written once.  As chip_smoke.py's k1_work."""

KERNEL = "blocklu_factor_kernel"
BK = 64


def padded(n):
    return -(-n // BK) * BK


def work(B, n):
    N = padded(n)
    flop = sum(m + 2 * m * m for m in range(n))
    for kb in range(0, n, BK):
        s = min(BK, n - kb)
        flop += s * (s - 1) * (s - 2) // 3 + s * (s - 1) * (s + 1) // 3 + s
    nbytes = 4 * (n * n + N * N + 2 * N * BK)
    return B * flop, B * nbytes
