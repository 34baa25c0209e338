"""The reference's rate coefficients, right-hand side and Jacobian of the
network, for one cell, in plain numpy.

A frozen copy of the arithmetic of the repository's independent
chemistry oracle (tests/oracle_chem.py: oracle_rates, oracle_rhs,
oracle_jac), which re-derives the formulas of the reference Fortran
(src/chemistry.f90:591-966 chem_cal_rates, src/disk.f90:4569-4659
chem_ode_f) from the parsed network tables and shares no code with the
port.  Its per-reaction loops are written here once per reaction type
over index arrays, and the stoichiometry is a sparse matrix, so that a
cell integrates in seconds; each expression is the oracle's.

`dtype` is the precision of the rate coefficients and the fluxes
(float64; float32 in the control).
"""

import numpy as np
import scipy.sparse as sp

# pinned to the reference's values (src/sub_global_variables.f90:12-25)
kB = 1.3806503e-16
mP = 1.67262158e-24
hbar = 1.054571628e-27
kB_SI = 1.3806503e-23
qe_SI = 1.602176487e-19
coulomb_SI = 8.9875517873681764e9
SECONDS_PER_YEAR = 3600.0 * 24.0 * 365.0
CR0 = 1.36e-17
CR_ATTEN_N = 5.75e25
COS_DESORP_PREFACTOR = 3.16e-19
COS_DESORP_T = 70.0
HABING_PHOTON_FLUX = 6e7
UVEXT2AV = 2.6
SHIELDED = ("H2", "CO", "H2O", "OH")
# the flux categories of oracle_rhs
TWO = (5, 6, 21, 64)
ONE = (1, 2, 3, 13, 61, 20, 0)
DESORB = (62, 75)


def sticking(mass_num, T):
    r = T / (mass_num * 0.5 * (52.0 + 25.0))
    return (1.0 + 2.5 * r) / ((1.0 + r) ** 2 * np.sqrt(1.0 + r))


def mobility(vibfreq, mass_num, Edes, Tdust, diff2des):
    a = -Edes * diff2des / Tdust
    b = -2e-8 / hbar * np.sqrt(
        2.0 * mass_num * (mP * kB * diff2des) * np.maximum(Edes, 0.0))
    return np.nan_to_num(vibfreq * np.exp(np.maximum(a, b)))


class Oracle:
    """The network's per-reaction index arrays and stoichiometry."""

    def __init__(self, net):
        self.net = net
        it = net.itype
        self.nR, self.nS = net.n_reactions, net.n_species
        self.of = {t: np.nonzero(it == t)[0] for t in np.unique(it)}
        r1 = np.clip(net.reac[:, 0], 0, None)
        r2 = np.clip(net.reac[:, 1], 0, None)
        self.r1, self.r2 = r1, r2
        name1 = np.array([net.species[i] if i >= 0 else ""
                          for i in net.reac[:, 0]])
        self.name1 = name1
        # itype 21: the non-grain partner's mass and the Coulomb factor
        i21 = self.idx(21)
        e = net.elements
        id3 = np.where(e[r1[i21], 2] == 0, r1[i21], r2[i21])
        self.m21 = net.mass_num[id3] * mP
        self.np21 = e[r1[i21], 0] * e[r2[i21], 0] == -1
        self.two_body = (net.n_reac == 2) & (it < 60)
        groups = {}
        for i in range(self.nR):
            if net.dupli_group[i] >= 0:
                groups.setdefault(int(net.dupli_group[i]), []).append(i)
        self.groups = [np.array(m) for m in groups.values()]
        # fluxes: which reactions, of which category
        self.cat_two = np.nonzero(np.isin(it, TWO))[0]
        self.cat_one = np.nonzero(np.isin(it, ONE))[0]
        self.cat_des = np.nonzero(np.isin(it, DESORB))[0]
        self.cat_sq = np.nonzero(it == 63)[0]
        self.des_c = np.where(it[self.cat_des] == 75,
                              net.abc[self.cat_des, 2], 1.0)
        rows, cols, vals = [], [], []
        for i in np.nonzero(np.isin(it, TWO + ONE + DESORB + (63,)))[0]:
            for j in range(net.n_reac[i]):
                rows.append(net.reac[i, j]), cols.append(i), vals.append(-1.0)
            for j in range(net.n_prod[i]):
                rows.append(net.prod[i, j]), cols.append(i), vals.append(1.0)
        self.S = sp.csr_matrix(sp.coo_matrix(
            (vals, (rows, cols)), shape=(self.nS, self.nR)))
        self._S = {}

    def idx(self, t):
        return self.of.get(t, np.zeros(0, np.int64))

    def rates(self, env, Tgas, diff2des=0.5, dtype=np.float64):
        """k[nR] (yr^-1, per unit abundance for 2-body gas reactions) at
        the cell env (a dict of floats, with the shielding factors in
        fss_ism and fss_star by species name) and gas temperature Tgas."""
        net = self.net

        def a(v):                  # one-element arrays keep `dtype`
            return np.asarray([v], dtype)

        with np.errstate(all="ignore"):
            return self._rates(net, env, a, a(Tgas), a(diff2des), dtype)

    def _rates(self, net, env, a, T, diff2des, dtype):
        A = net.abc[:, 0].astype(dtype)
        B = net.abc[:, 1].astype(dtype)
        C = net.abc[:, 2].astype(dtype)
        Tl = net.T_range[:, 0].astype(dtype)
        Tu = net.T_range[:, 1].astype(dtype)
        mass = net.mass_num.astype(dtype)
        vib = net.vib_freq.astype(dtype)
        edes = net.Edesorb.astype(dtype)
        Td = a(env["Tdust"])
        sig = a(env["sigdust_ave"])
        d2h = a(env["ratioDust2HnucNum"])
        spg = a(env["SitesPerGrain"])
        k = np.zeros(self.nR, dtype)
        r1, r2 = self.r1, self.r2

        Tred = kB_SI * T / (qe_SI ** 2 * coulomb_SI
                            / (a(env["GrainRadius_CGS"]) * 1e-2))
        J_np = (1.0 + 1.0 / Tred) * (1.0 + np.sqrt(2.0 / (2.0 + Tred)))
        J_cn = 1.0 + np.sqrt(np.pi / 2.0 / Tred)
        cr = a(env["zeta_cosmicray_H2"]) / CR0 * np.exp(
            -a(env["Ncol_toISM"]) / CR_ATTEN_N)
        xr = a(env["zeta_Xray_H2"]) / CR0
        dustless = bool(sig[0] <= 1e-30)

        i = self.idx(5)
        Te = np.where(C[i] < 0.0,
                      np.where(Tl[i] > T, Tl[i], np.where(Tu[i] < T, Tu[i], T)),
                      T)
        k[i] = A[i] * (Te / 300.0) ** B[i] * np.exp(-C[i] / Te)
        i = self.idx(6)
        k[i] = np.where((Tl[i] <= T) & (T <= Tu[i]),
                        A[i] * (T / 300.0) ** B[i] * np.exp(-C[i] / T), 0.0)
        i = self.idx(1)
        k[i] = A[i] * (cr + xr)
        i = np.concatenate([self.idx(2), self.idx(20)])
        k[i] = A[i] * (C[i] / (1.0 - a(env["omega_albedo"])) * cr + xr)
        i = self.idx(3)
        si = self.shield(env["fss_ism"], i, dtype)
        ss = self.shield(env["fss_star"], i, dtype)
        ism = a(env["G0_UV_toISM"]) * np.exp(-C[i] * a(env["Av_toISM"])) * si
        star = np.where(self.name1[i] == "H2", a(env["G0_UV_H2phd"]) * ss,
                        a(env["G0_UV_toStar"])
                        * np.exp(-C[i] * a(env["Av_toStar"])) * ss)
        k[i] = A[i] * (ism + star)
        i = self.idx(13)
        k[i] = a(env["phflux_Lya"]) * A[i] \
            * self.shield(env["fss_star"], i, dtype)
        i = self.idx(21)
        k[i] = np.sqrt(8.0 * kB / np.pi * T / self.m21.astype(dtype)) * sig \
            * np.where(self.np21, J_np, J_cn)
        i = self.idx(0)
        k[i] = 0.5 * sticking(mass[r1[i]], T) * sig \
            * np.sqrt(8.0 / np.pi * kB * T / mP) * d2h
        i = self.idx(61)
        k[i] = sticking(mass[r1[i]], T) * A[i] * sig * a(env["ndust_tot"]) \
            * np.sqrt(8.0 / np.pi * kB * T / (mass[r1[i]] * mP))
        i = self.idx(62)
        k[i] = vib[r1[i]] * (np.exp(-C[i] / Td) + COS_DESORP_PREFACTOR * cr
                             * np.exp(-C[i] / COS_DESORP_T))
        if dustless:
            k[i] = 0.0
        k[i] = k[i] * spg * d2h
        for t in (63, 64):
            i = self.idx(t)
            mob = mobility(vib[r1[i]], mass[r1[i]], edes[r1[i]], Td, diff2des)
            if t == 64:
                mob = mob + mobility(vib[r2[i]], mass[r2[i]], edes[r2[i]],
                                     Td, diff2des)
            br = np.where(C[i] != 0.0, A[i] * np.exp(np.maximum(
                -C[i] / Td,
                -2.0 * B[i] * 1e-8 / hbar
                * np.sqrt(2.0 * Tl[i] * mP * kB * C[i]))), A[i])
            k[i] = mob / spg / d2h * br if t == 63 \
                else mob / (spg * d2h) * br
        i = self.idx(75)
        k[i] = (a(env["G0_UV_toStar_photoDesorb"]) * HABING_PHOTON_FLUX
                + a(env["G0_UV_toISM"]) * HABING_PHOTON_FLUX
                * np.exp(-UVEXT2AV * a(env["Av_toISM"]))) \
            * sig * d2h * (A[i] + B[i] * Td)
        if dustless:
            for t in (21, 0, 61, 64, 75):
                k[self.idx(t)] = 0.0

        k = k * SECONDS_PER_YEAR
        k = np.where(self.two_body, k * a(env["n_gas"]), k)
        # duplicates: the closest T_range endpoint wins (ties: the first)
        for m in self.groups:
            d = np.minimum(np.abs(Tl[m] - T), np.abs(Tu[m] - T))
            lose = m[m != m[int(np.argmin(d))]]
            k[lose] = 0.0
        return k

    def shield(self, fss, i, dtype):
        return np.array([fss.get(n, 1.0) for n in self.name1[i]], dtype)

    def fluxes(self, k, y, nlayer):
        """(r [nR], dr/dy as (reaction, species, value) triplets)."""
        dt = k.dtype
        r = np.zeros(self.nR, dt)
        rows, cols, vals = [], [], []
        i = self.cat_two
        y1, y2 = y[self.r1[i]], y[self.r2[i]]
        s = np.where((y1 < 0.0) & (y2 < 0.0), -1.0, 1.0).astype(dt)
        r[i] = s * k[i] * y1 * y2
        rows += [i, i]
        cols += [self.r1[i], self.r2[i]]
        vals += [s * k[i] * y2, s * k[i] * y1]
        i = self.cat_one
        r[i] = k[i] * y[self.r1[i]]
        rows.append(i), cols.append(self.r1[i]), vals.append(k[i])
        i = self.cat_des
        t1 = (nlayer * self.des_c).astype(dt)
        pos = t1 > 0.0
        x = y[self.r1[i]] / np.where(pos, t1, 1.0)
        thin = x <= 1e-4
        with np.errstate(all="ignore"):
            r[i] = np.where(pos, np.where(thin, k[i] * x,
                                          k[i] * (1.0 - np.exp(-x))), k[i])
            d = np.where(thin, k[i] / t1, k[i] / t1 * np.exp(-x))
        rows.append(i[pos]), cols.append(self.r1[i][pos])
        vals.append(d[pos])
        i = self.cat_sq
        y1 = y[self.r1[i]]
        s = np.where(y1 < 0.0, -1.0, 1.0).astype(dt)
        r[i] = s * k[i] * y1 * y1
        rows.append(i), cols.append(self.r1[i]), vals.append(s * 2.0 * k[i] * y1)
        return r, (np.concatenate(rows), np.concatenate(cols),
                   np.concatenate(vals))

    def rhs(self, k, y, d2h, spg):
        """ydot [nS] in k's precision."""
        r, _ = self.fluxes(k, y, d2h * spg)
        return self.stoich(k.dtype) @ r

    def jac(self, k, y, d2h, spg):
        """The dense analytic Jacobian [nS, nS] in k's precision."""
        _, (rows, cols, vals) = self.fluxes(k, y, d2h * spg)
        D = sp.csr_matrix((vals.astype(k.dtype), (rows, cols)),
                          shape=(self.nR, self.nS))
        return (self.stoich(k.dtype) @ D).toarray()

    def stoich(self, dtype):
        if dtype not in self._S:
            self._S[dtype] = self.S.astype(dtype)
        return self._S[dtype]
