"""Chemical-pathway analysis: reaction contributions + element residence.

Rebuild of the reference introspection tools (reference:
src/disk.f90:4036-4300 ``chem_analyse``/``load_ana_species_list``,
src/chemistry.f90:1593-1640 ``chem_elemental_residence``, :1643-1775
``get_species_produ_destr``/``get_contribution_each``): for chosen cells
and species, report the top production/destruction reactions with their
instantaneous rates, and where each element resides.

Counterpart of the JAX package's ``ops/analysis.py``: the per-reaction
bookkeeping on the host in numpy, the rate coefficients and the
heating/cooling budget of the chosen cell from this package's
``rates.compute_rates`` and ``ThermalBalance.rates`` on the model's
device (a batch of one cell).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.umist import ChemNet, ELEMENTS
from .network import CAT_BILIN, CAT_DES, CAT_LIN, CAT_PDES, CAT_SURF2, \
    _CAT_OF_ITYPE


def reaction_rates(net: ChemNet, k, y, ratioDust2HnucNum, SitesPerGrain):
    """Instantaneous per-reaction fluxes [yr^-1] (host-side numpy)."""
    k = np.asarray(k)
    y = np.asarray(y)
    r1 = np.clip(net.reac[:, 0], 0, None)
    r2 = np.clip(net.reac[:, 1], 0, None)
    cat = np.array([_CAT_OF_ITYPE.get(int(t), 0) for t in net.itype])
    y1 = y[r1]
    y2 = y[r2]
    nl = ratioDust2HnucNum * SitesPerGrain
    rate = np.zeros(net.n_reactions)
    rate[cat == CAT_LIN] = (k * y1)[cat == CAT_LIN]
    rate[cat == CAT_BILIN] = (k * y1 * y2)[cat == CAT_BILIN]
    x = y1 / max(nl, 1e-300)
    rate[cat == CAT_DES] = (k * np.where(x <= 1e-4, x, 1 - np.exp(-x)))[
        cat == CAT_DES]
    x2 = y1 / np.maximum(nl * net.abc[:, 2], 1e-300)
    rate[cat == CAT_PDES] = (k * np.where(x2 <= 1e-4, x2,
                                          1 - np.exp(-x2)))[cat == CAT_PDES]
    rate[cat == CAT_SURF2] = (k * y1 * y1)[cat == CAT_SURF2]
    return rate


def format_reaction(net: ChemNet, i):
    lhs = " + ".join(net.species[s] for s in net.reac[i] if s >= 0)
    rhs = " + ".join(net.species[s] for s in net.prod[i] if s >= 0)
    return f"{lhs} -> {rhs} [itype {net.itype[i]}]"


def species_contributions(net: ChemNet, rates, species: str, n_top=20):
    """Top producing/destroying reactions of one species.

    Returns (produce, destroy): lists of (rate, contribution_fraction,
    reaction_string), like the ana/ output files of the reference.
    """
    i_spe = net.species.index(species)
    prod_r, dest_r = [], []
    for i in range(net.n_reactions):
        n_as_reac = int((net.reac[i][:net.n_reac[i]] == i_spe).sum())
        n_as_prod = int((net.prod[i][:net.n_prod[i]] == i_spe).sum())
        if n_as_prod > n_as_reac and rates[i] != 0:
            prod_r.append((rates[i] * (n_as_prod - n_as_reac), i))
        elif n_as_reac > n_as_prod and rates[i] != 0:
            dest_r.append((rates[i] * (n_as_reac - n_as_prod), i))

    def fmt(lst):
        lst.sort(key=lambda t: -abs(t[0]))
        tot = sum(abs(r) for r, _ in lst) or 1.0
        return [(r, abs(r) / tot, format_reaction(net, i))
                for r, i in lst[:n_top]]

    return fmt(prod_r), fmt(dest_r)


def elemental_residence(net: ChemNet, y, n_top=10):
    """Where each element resides (reference chem_elemental_residence)."""
    y = np.asarray(y)[:net.n_species]
    out = {}
    for ie, ele in enumerate(ELEMENTS):
        contrib = y * net.elements[:, ie]
        tot = np.abs(contrib).sum()
        if tot <= 0:
            continue
        order = np.argsort(-np.abs(contrib))[:n_top]
        out[ele] = [(net.species[j], contrib[j] / tot)
                    for j in order if abs(contrib[j]) > 1e-90 * tot]
    return out


def analyse_model_points(model, points, species_list, out_dir, n_top=20):
    """Write the reference's ana/ introspection files for chosen (r, z)
    points of an iterated DiskModel (reference chem_analyse,
    src/disk.f90:4036-4300 + points_to_analyse.dat): per point, the cell
    state, the top production/destruction reactions for each requested
    species, the heating/cooling budget, and the elemental residence.

    Returns the list of written file paths.
    """
    import pathlib

    from .rates import compute_rates

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    g = model.grid
    net = model.net
    written = []
    for (r_au, z_au) in points:
        # nearest active cell by center distance (the reference walks the
        # tree; cells here are few enough for a direct argmin)
        rc, zc = g.centers()
        act = np.nonzero(g.using)[0]
        i = int(act[np.argmin((rc[act] - r_au) ** 2 + (zc[act] - z_au) ** 2)])
        env, tenv = model.assemble_envs(np.array([i]))     # a batch of 1
        y = np.concatenate([model.X[:, i], [model.Tgas[i]]])
        Tg = model._t(model.Tgas[i:i + 1], torch.float64)
        kt = compute_rates(model.ode.tab, env, Tg)
        k = kt[0].cpu().numpy()
        rates = reaction_rates(net, k, y, float(env.ratioDust2HnucNum[0]),
                               float(env.SitesPerGrain[0]))
        # XLA flushes subnormal intermediates of the rate coefficients to
        # zero, so the JAX package lists no reaction whose flux is
        # subnormal (1e-315 yr^-1); neither does this one
        rates = np.where(np.abs(rates) < np.finfo(np.float64).tiny, 0.0,
                         rates)
        path = out / f"ana_r{r_au:g}_z{z_au:g}.txt"
        with open(path, "w") as f:
            f.write(f"# point ({r_au}, {z_au}) AU -> cell {i} "
                    f"[{g.rmin[i]:.3g},{g.rmax[i]:.3g}]x"
                    f"[{g.zmin[i]:.3g},{g.zmax[i]:.3g}]\n")
            f.write(f"n_gas = {g.n0[i]:.6e} cm^-3\n")
            f.write(f"Tgas  = {model.Tgas[i]:.2f} K\n")
            f.write(f"Tdust = {model.Tdust[i]:.2f} K\n\n")
            for spe in species_list:
                if spe not in net.species:
                    continue
                f.write(f"== {spe}  X = {model.X[net.idx[spe], i]:.6e} ==\n")
                prod, dest = species_contributions(net, rates, spe, n_top)
                f.write("  production:\n")
                for rate, frac, s in prod:
                    f.write(f"    {rate: .6e}  {frac:6.1%}  {s}\n")
                f.write("  destruction:\n")
                for rate, frac, s in dest:
                    f.write(f"    {rate: .6e}  {frac:6.1%}  {s}\n")
            if model.thermal is not None and model.fields is not None:
                hc = model.thermal.rates(
                    model._t(y[None, :], torch.float64), Tg, env, tenv, kt)
                f.write("\n== heating/cooling [erg cm^-3 s^-1] ==\n")
                for name in hc._fields:
                    v = float(getattr(hc, name)[0])
                    f.write(f"  {name:32s} {v: .6e}\n")
                f.write(f"  {'net':32s} {float(hc.net()[0]): .6e}\n")
            f.write("\n== elemental residence ==\n")
            for ele, lst in elemental_residence(net, y).items():
                f.write(f"  {ele}: " + ", ".join(
                    f"{s} ({v:.1%})" for s, v in lst) + "\n")
        written.append(str(path))
    return written
