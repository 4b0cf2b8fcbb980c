"""Batch production driver — the ``test_run.py`` equivalent; counterpart of
``seabreeze_param_tpu.cli.run``.

End-to-end pipeline (``python_wrapper/test_run.py:8-57``): config file ->
static metadata -> per-dated-file loop -> ``diag`` over each file's time
axis on the card -> CF netCDF output ``{prefix}sb_{date}.nc`` (classic
netCDF, see :mod:`..io.netcdf`), with the persistent state triple threaded
across files.

Run as::

    python -m seabreeze_param_tpu_torch.cli.run --config=run.conf

CLI contract as the reference (``test_run.py:72-110``): ``--option=value``
pairs, ``--help`` prints usage; unknown options are passed through to
``diag`` as keyword arguments (science-parameter overrides such as
``--maxdist=250``, and ``--device``, ``--use_kernels``, ``--mesh``).

Several processes (``torchrun --nproc_per_node 2 -m
seabreeze_param_tpu_torch.cli.run --config=run.conf``, or ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set by hand)
run one decomposed run over all of them, as the JAX package's driver
does: every process reads the input files (its own rows of the series),
``diag`` runs over the global mesh (``parallel.distributed``), and only
process 0 writes output files, progress and metrics.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import api
from ..io import Config, Meta, read_nc


def main(config, progress=sys.stdout, ckpt_dir=None, save_every=1,
         max_retries=2, watchdog_s=None, metrics_file=None, **diag_kwargs):
    """Run the batch pipeline; returns ``(tt, thc, ws, wd, written)``, the
    final state as an int and host arrays plus the output files written.

    With ``ckpt_dir`` the per-file loop runs under the elastic-recovery
    runner (``utils.resilience``): the state is checkpointed every
    ``save_every`` files, transient failures retry from the last
    checkpoint, and a rerun pointed at the same directory resumes the
    series after the last completed file.
    """
    from ..core.state import TriggerState
    from ..io.native_nc import PrefetchPool
    from ..utils.metrics import StepMetrics

    from ..parallel import distributed as dist

    # A multi-process launch (WORLD_SIZE > 1) joins the process group here;
    # api.diag then runs every file over all processes.  With ckpt_dir the
    # state saved is the gathered global state, the same on every process:
    # process 0 writes it and the others wait (core.checkpoint), so a
    # relaunch of all processes resumes from it.  A failure in one process
    # only inside a collective needs that relaunch.
    dist.initialize()
    primary = dist.rank() == 0
    if not primary:
        progress = None
        metrics_file = None
    if watchdog_s and not ckpt_dir:
        # The watchdog's abort path re-enters the unit from the last
        # checkpoint; without a checkpoint directory there is nothing to
        # restore to, so the option would be silently inert.
        import warnings
        warnings.warn("watchdog_s requires ckpt_dir (the stall recovery "
                      "restores from checkpoint); ignoring watchdog_s")
    cfg = Config(config)
    meta = Meta(cfg)
    shape = (len(meta.lat), len(meta.lon))
    written = []
    metrics_stream = open(metrics_file, "a") if metrics_file else None
    metrics = StepMetrics(grid_points=shape[0] * shape[1],
                          stream=metrics_stream)
    invars = (cfg.vv, cfg.vu, cfg.vtheta, cfg.vci)
    pool = PrefetchPool(2)   # no-op when no native toolchain
    date_index = {t: i for i, t in enumerate(meta.dates)}

    def process(state, tstring):
        """One dated file: read -> diag -> CF output.  The recovery unit."""
        step = date_index[tstring]
        # Warm the NEXT file set into the page cache on native C++ threads
        # while this step computes (the reference reads cold and serially,
        # test_run.py:18-30).
        if step + 1 < len(meta.dates):
            nxt = meta.dates[step + 1]
            pool.prefetch(*(meta.input_path(v, nxt) for v in invars))
        f_sb = meta.input_path("sb", tstring)
        if progress:
            progress.write("Creating sea-breeze data for "
                           f"{os.path.basename(f_sb)} ... ")
            progress.flush()
        nc_data = read_nc(meta.input_path(cfg.vv, tstring),
                          meta.input_path(cfg.vu, tstring),
                          meta.input_path(cfg.vtheta, tstring),
                          meta.input_path(cfg.vci, tstring),
                          vv=cfg.vv, vu=cfg.vu, vtheta=cfg.vtheta,
                          vci=cfg.vci, vpres=cfg.vpres, vtime=cfg.vtime)
        try:
            t_start = time.perf_counter()
            tt, sb_con, thc, windspeed, winddir, outs = api.diag(
                int(state.tt), meta.landfrac, meta.z, meta.std, meta.lon,
                meta.lat, nc_data.pres, meta=nc_data, ws=state.windspeed,
                wd=state.winddir, thc=state.thc, full_output=True,
                **diag_kwargs)
            metrics.record(time.perf_counter() - t_start, sb_con.shape[0])
            if metrics_stream:
                # pipeline-cache stats: after the first file these should
                # be all hits — a miss on a later file means new distance
                # tables (e.g. the ring bound grew); see api._CACHE
                metrics.add(
                    file=os.path.basename(f_sb),
                    exec_cache_hits=api.CACHE_STATS["pipeline_hits"],
                    exec_cache_misses=api.CACHE_STATS["pipeline_misses"])
                metrics.emit()
            if primary:
                meta.create_nc(sb_con, f_sb, "sb_con", nc_data.time)
                # per-step sea-level temperature, under the reference's
                # production name "thc" (the out[1] quirk — plot.py:97-99
                # reads it from the sb files)
                meta.create_nc(outs["t0"], f_sb, "thc", nc_data.time)
                written.append(f_sb)
        finally:
            for f in nc_data.nc.values():
                f.close()
        if progress:
            progress.write("ok\n")
            progress.flush()
        return TriggerState(tt=int(tt), thc=thc, windspeed=windspeed,
                            winddir=winddir)

    state = TriggerState(tt=1, thc=np.zeros(shape, np.float32),
                         windspeed=np.zeros(shape, np.float32),
                         winddir=np.zeros(shape, np.float32))
    try:
        if ckpt_dir:
            from ..utils.resilience import run_resilient
            state, _ = run_resilient(
                list(meta.dates), process, state, str(ckpt_dir),
                save_every=int(save_every), max_retries=int(max_retries),
                watchdog_deadline_s=(float(watchdog_s) if watchdog_s
                                     else None))
        else:
            for tstring in meta.dates:
                state = process(state, tstring)
    finally:
        pool.close()
        if metrics_stream:
            metrics_stream.close()
    return (int(state.tt), np.asarray(state.thc),
            np.asarray(state.windspeed), np.asarray(state.winddir), written)


HELP = """
Batch driver for the sea-breeze trigger pipeline on a CUDA card.

Usage:
    python -m seabreeze_param_tpu_torch.cli.run --option=value

Options:
    config           : path to the run configuration (data directory, static
                       files, variable names, date range; default: ./run.conf)
    ckpt_dir         : checkpoint directory; enables elastic recovery +
                       resume across reruns (default: off)
    save_every       : checkpoint cadence in files (default: 1)
    max_retries      : transient-failure retries per file (default: 2)
    watchdog_s       : liveness deadline in seconds — a file making no
                       progress for this long is aborted (async exception
                       in the runner thread; a call hung inside the device
                       runtime instead needs a process-level restart, which
                       resumes from the checkpoint) and retried from the
                       last checkpoint.  Requires ckpt_dir (default: off)
    metrics_file     : append one JSON metrics line per processed file
                       (per-step wall time, grid-points/s; default: off)
    mesh             : decomposed run over the cards — "auto" (one shard
                       per card) or "PYxPX", e.g. --mesh=2x4, whose shards
                       split evenly over the cards (default: no
                       decomposition).  In a multi-process launch
                       (WORLD_SIZE > 1, e.g. torchrun) the global mesh over
                       all processes, whose rows split evenly over them,
                       each process's block over its --device (default: one
                       row per process and device; over a list of n
                       devices, near-square n per process)
    device           : torch device of the run (default: the current card,
                       and for --mesh every visible card); a comma-separated
                       list, e.g. cuda:0,cuda:1, lays the mesh (under
                       torchrun each process's block of it) over those
                       devices, one group of shards per entry (an entry may
                       repeat: several groups on one card)
    use_kernels      : false runs the plain torch path instead of the
                       hand-written kernels (default: the kernels on CUDA)
    any diag kwarg   : science-parameter override, e.g. --maxdist=250
"""


def cli(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {"config": os.path.join(os.getcwd(), "run.conf")}
    for arg in argv:
        try:
            key, value = arg.lstrip("-").split("=")
        except ValueError:
            sys.exit(HELP)
        if key.lower() == "help":
            sys.exit(HELP)
        if value.lower() in ("true", "false"):
            value = value.lower() == "true"
        elif key.lower() == "device" and "," in value:
            value = value.split(",")
        else:
            try:
                value = float(value)
            except ValueError:
                pass
        kwargs[key.lower()] = value
    main(**kwargs)


if __name__ == "__main__":
    cli()
