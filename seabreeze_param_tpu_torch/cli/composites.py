"""Seasonal / diurnal composite analysis — the ``plot.py`` equivalent; a
copy of ``seabreeze_param_tpu.cli.composites`` on top of the port's
:mod:`..io` (matplotlib is imported only by :func:`plot_maps`).

Capability-parity with the reference analysis driver
(``python_wrapper/plot.py:5-131``): accumulate daily-mean diurnal cycles of
``sb_con``/``thc``/surface temperature per season (DJF/MAM/JJA/SON), write
the composite as CF netCDF, and render global maps.

Design differences (intentional):
  * the reference calls the name-mangled ``M.get_dates()`` which does not
    exist (``plot.py:38`` vs ``configdir.py:82`` — a latent crash); here
    dates are discovered in ``Meta.__init__`` and just used;
  * maps use plain matplotlib ``pcolormesh`` over lon/lat with a drawn
    coastline contour from the land-sea mask (Basemap is dead upstream);
  * pure functions + a thin CLI, so the composite math is unit-testable
    (the reference's is not).
"""
from __future__ import annotations

import os
import sys
from datetime import datetime

import numpy as np

from ..io import Config, Dataset, Meta, num2date

SEASONS = ("DJF", "MAM", "JJA", "SON")
MON2SEAS = {1: "DJF", 2: "DJF", 3: "MAM", 4: "MAM", 5: "MAM", 6: "JJA",
            7: "JJA", 8: "JJA", 9: "SON", 10: "SON", 11: "SON", 12: "DJF"}
#: representative mid-season month for the composite time axis (plot.py:42)
SEAS_MONTH = {"DJF": 1, "MAM": 4, "JJA": 6, "SON": 10}


def diurnal_mean(path: str, varname: str) -> np.ndarray:
    """Mean diurnal cycle of one dated file: (steps_per_day, nlat, nlon).

    Reference ``get_data`` (plot.py:21-32): reshape the (time, lat, lon)
    series into (days, steps/day, lat, lon) and average over days.
    """
    with Dataset(path) as f:
        var = f.variables[varname]
        tname = var.dimensions[0]
        tvar = f.variables[tname]
        times = num2date(tvar[:], tvar.units)
        dt = int((times[1] - times[0]).total_seconds())
        data = np.ma.getdata(var[:])
        nstep = data.shape[0]
        per_day = 86400 // dt
        nday = (dt * nstep) // 86400
        return data[:nday * per_day].reshape(
            nday, per_day, data.shape[-2], data.shape[-1]).mean(axis=0)


def seasonal_composites(meta: Meta, cfg: Config, progress=sys.stdout):
    """Accumulate per-season diurnal composites over ``meta.dates``.

    Returns ``(data, counts, per_day)`` where ``data[var][season]`` is the
    summed (steps_per_day, nlat, nlon) diurnal cycle and ``counts[season]``
    the number of contributing files (plot.py:44-60 accumulation; the
    normalization ``data/count`` happens in :func:`write_composites`).
    """
    vtheta = cfg.vtheta
    data, counts, per_day = None, dict.fromkeys(SEASONS, 1), None
    for tstring in meta.dates:
        mon = int(tstring.split("_")[1])
        season = MON2SEAS[mon]
        f_sb = meta.input_path("sb", tstring)
        f_th = meta.input_path(vtheta, tstring)
        if progress:
            progress.write(f"Adding information from {tstring} to "
                           f"{season}... ")
        sources = {"sb_con": f_sb, "thc": f_sb, vtheta: f_th}
        for var, path in sources.items():
            cycle = diurnal_mean(path, var)
            if data is None:
                per_day = cycle.shape[0]
                data = {v: {s: 0.0 for s in SEASONS} for v in sources}
            data[var][season] = data[var][season] + cycle
        counts[season] += 1
        if progress:
            progress.write("ok\n")
    return data, counts, per_day


def write_composites(meta: Meta, cfg: Config, data, counts, per_day,
                     ncout: str):
    """Write the normalized composites stacked season-major (plot.py:62-79)
    with times anchored at the 15th of each season's key month."""
    hours = np.arange(0, 24, 24 // per_day)
    shape = next(np.asarray(c).shape for v in data.values()
                 for c in v.values() if np.ndim(c) == 3)
    for var in data:
        name = "temp" if var == cfg.vtheta else var
        stack, times = [], []
        for season in SEASONS:
            # seasons with no contributing files stay all-zero (the
            # reference zero-initialized every season, plot.py:18)
            stack.append(np.broadcast_to(
                np.asarray(data[var][season] / counts[season],
                           np.float32), shape))
            times.extend(datetime(2017, SEAS_MONTH[season], 15, int(h))
                         for h in hours)
        meta.create_nc(np.concatenate(stack, axis=0), ncout, name, times)
    return ncout


def plot_maps(meta: Meta, ncout: str, outdir: str, lsm=None,
              progress=sys.stdout):
    """Seasonal 2x2 diurnal map panels of sb_con (plot.py:109-130)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    written = []
    with Dataset(ncout) as f:
        sb = np.ma.getdata(f.variables["sb_con"][:])
        per_day = sb.shape[0] // len(SEASONS)
        hours = np.arange(0, 24, 24 // per_day)
        tt = 0
        for season in SEASONS:
            fig, axes = plt.subplots(2, 2, figsize=(14.22, 8.875))
            for h, ax in zip(hours, axes.ravel()):
                field = np.ma.masked_greater(sb[tt], 1.0e19)
                im = ax.pcolormesh(meta.lon, meta.lat, field, vmin=-5.0,
                                   vmax=5.0, cmap="RdBu_r", shading="auto")
                if lsm is not None:
                    ax.contour(meta.lon, meta.lat, lsm, levels=[0.5],
                               colors="k", linewidths=0.25)
                ax.set_title("Subgrid Sea-Breeze Convergence at "
                             f"{h:02d} UTC ({season})")
                tt += 1
            fig.colorbar(im, ax=axes.ravel().tolist(), shrink=0.95,
                         pad=0.01, aspect=80)
            path = os.path.join(outdir, f"composite_{season}.png")
            fig.savefig(path, dpi=150, bbox_inches="tight")
            plt.close(fig)
            written.append(path)
            if progress:
                progress.write(f"Plotting data for {season} ... ok\n")
    return written


def main(config, outdir=None, plot=True, progress=sys.stdout):
    cfg = Config(config)
    meta = Meta(cfg)
    ncout = os.path.join(meta.datadir, f"{meta.prefix}sb_con.nc")
    if not os.path.isfile(ncout):
        data, counts, per_day = seasonal_composites(meta, cfg, progress)
        write_composites(meta, cfg, data, counts, per_day, ncout)
    maps = []
    if plot:
        maps = plot_maps(meta, ncout, outdir or meta.datadir,
                         lsm=meta.landfrac, progress=progress)
    return ncout, maps


def cli(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {"config": os.path.join(os.getcwd(), "run.conf")}
    for arg in argv:
        key, _, value = arg.lstrip("-").partition("=")
        if key.lower() == "help" or not value:
            sys.exit(__doc__)
        kwargs[key.lower()] = value
    main(**kwargs)


if __name__ == "__main__":
    cli()
