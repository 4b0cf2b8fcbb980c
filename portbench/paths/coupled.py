"""Entry path ``coupled``: a model that calls the trigger every timestep,
``CoupledTrigger.physics`` once a model step with its 3-D pressure, and
``prepare_mask`` (coastline and distance) when the sea ice changes, every
``ice_period_steps`` steps.  One caller in a closed loop: each step ends
when its outputs are ready on the card, where the model's fields live.

Set-up makes ``field_sets`` model steps' fields (theta; u, v and p on
every level) and ``ice_variants`` sea-ice fields on the card from the
seed, and runs ``warmup_steps`` steps; the window goes on stepping, the
fields fed in turn and the ice variants in turn at each ice update.  Each
step is timed on the card by CUDA events, from its call to its outputs.

The window keeps a sample of ``check_samples`` steps' outputs, drawn from
the seed (reservoir sampling).  The reference then works out the
distance of each ice variant, replays the state (it changes only at the
first step and every ``target_time``), and recomputes each sampled step.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from portbench import compare, roofline, world
from portbench.harness import Outcome
from portbench.reference import trigger as ref
from portbench.trace import Window


@dataclasses.dataclass
class State:
    """The state the caller hands the first step (a model's cold start)."""

    tt: int
    thc: torch.Tensor
    windspeed: torch.Tensor
    winddir: torch.Tensor


def _fields(ctx):
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    lon, lat = world.grid(cfg["grid"])
    h, w = len(lat), len(lon)
    nlev = cfg["nlev"]
    g = world.generator(ctx.seed, dev)
    lsm, z, std = world.make_world(h, w, g, dev)
    sets = [dict(theta=world.noise((h, w), 5.0, 288.0, g, dev),
                 u=world.noise((nlev, h, w), 6.0, 0.0, g, dev),
                 v=world.noise((nlev, h, w), 6.0, 0.0, g, dev),
                 p=world.pressure_3d(nlev, z, g, dev))
            for _ in range(wl["field_sets"])]
    base = h // wl["ice_rows_div"]
    ice = [world.ice_field(h, w, base + e, dev)
           for e in range(wl["ice_variants"])]
    return lon, lat, lsm, z, std, sets, ice


def control_system(ctx):
    """The control: ``CoupledTrigger``'s interface over the plain reference
    computed one precision below the configuration's float32."""
    prec = ref.BFLOAT16
    lon, lat = world.grid(ctx.config["grid"])
    settings = ref.Settings(**ctx.config["params"])

    class Control:
        def prepare_mask(self, land, ice):
            return ref.distance_field(land, ice, lon, lat, settings, prec)[0]

        def physics(self, state, p, u, v, theta, z, sigma, mask):
            st = ref.State(int(state.tt), state.thc, state.windspeed,
                           state.winddir)
            smod = ref.sigmoid_weight(sigma, prec)
            st, out, _ = ref.trigger_step(st, theta, u, v, p, z, smod, mask,
                                          settings, prec)
            return st, out
    return Control()


def run(ctx) -> Outcome:
    wl = ctx.workload
    lon, lat, lsm, z, std, sets, ice = _fields(ctx)
    params = dict(ctx.config["params"])
    if ctx.system is None:
        from seabreeze_param_tpu_torch.core.grid import Grid
        from seabreeze_param_tpu_torch.core.params import Params
        from seabreeze_param_tpu_torch.coupling import CoupledTrigger
        system = CoupledTrigger(grid=Grid(lon=lon, lat=lat),
                                params=Params(**params),
                                nn_max=ctx.config.get("coupled_nn_max"),
                                device=ctx.device)
    else:
        system = ctx.system
    period, nset, nice = (wl["ice_period_steps"], wl["field_sets"],
                          wl["ice_variants"])
    cuda = ctx.device.type == "cuda"
    zeros = [torch.zeros_like(lsm) for _ in range(3)]
    holder = {"state": State(1, *zeros), "mask": None, "s": 0}

    def step():
        s = holder["s"]
        if s % period == 0:
            holder["mask"] = system.prepare_mask(lsm, ice[(s // period)
                                                           % nice])
        f = sets[s % nset]
        holder["state"], out = system.physics(
            holder["state"], f["p"], f["u"], f["v"], f["theta"], z, std,
            holder["mask"])
        holder["s"] = s + 1
        return out

    for _ in range(wl["warmup_steps"]):
        step()
    if cuda:
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    first = holder["s"]

    kept = compare.Reservoir(wl["check_samples"], ctx.seed)
    lat_ms = []
    with Window(ctx.trace, cuda) as win:
        n = 0
        while True:
            s = holder["s"]
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step()
                end.record()
                end.synchronize()
                lat_ms.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                out = step()
                lat_ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
            kept.offer(s, lambda: {k: v.clone() for k, v in out.items()})
            if win.elapsed() >= ctx.seconds:
                break
    steps = n
    last = holder["s"]
    sample = kept.items
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    del system, holder
    if cuda:
        torch.cuda.empty_cache()

    # the reference: each ice variant's distance, the state replayed over
    # every step taken, each sampled step recomputed
    settings = ref.Settings(**params)
    smod = ref.sigmoid_weight(std)
    dist = [ref.distance_field(lsm, ci, lon, lat, settings) for ci in ice]
    st = ref.State(1, *(torch.zeros_like(lsm) for _ in range(3)))
    judge = compare.Judge(wl["limits"])
    for s in range(last):
        e = (s // period) % nice
        first_or_refresh = any(ref.cadence(st.tt, settings))
        if s not in sample and not first_or_refresh:
            st = ref.State(st.tt + 1, st.thc, st.windspeed, st.winddir)
            continue
        f = sets[s % nset]
        st, out_ref, _ = ref.trigger_step(st, f["theta"], f["u"], f["v"],
                                          f["p"], z, smod, dist[e][0],
                                          settings)
        if s in sample:
            got = sample[s]
            judge.judge(got["sb_con"], out_ref["sb_con"], got, out_ref)
    print(f"portbench: {ctx.cell} seed {ctx.seed}: {steps} steps, "
          f"{judge.judged} checked, worst {judge.worst}",
          file=sys.stderr, flush=True)

    work = {}
    if ctx.trace:                       # the roofline readers' work
        h, w = lsm.shape
        per_b4, per_b3 = [], []
        for cd, reach, k in dist:       # ring radii depend on cdist alone
            coastal = cd.abs() <= float(np.float32(settings.maxdist))
            coastal[-1] = False
            per_b4.append(roofline.b4_work(ref.ring_means(
                torch.zeros_like(lsm), cd, coastal)[1]))
            per_b3.append(roofline.b3_work(h, w, k, int(reach.sum())))
        b4, b3 = [0, 0], [0, 0]
        for s in range(first, last):
            e = (s // period) % nice
            for i in (0, 1):
                b4[i] += per_b4[e][i]
                b3[i] += per_b3[e][i] if s % period == 0 else 0
        work = {"b4": tuple(b4), "b3": tuple(b3)}
    return Outcome(
        setup_s=setup_s,
        end_to_end={"coupled_step_ms": win.wall_s * 1e3 / steps,
                    "coupled_step_p99_ms": float(np.percentile(lat_ms, 99))},
        attempted=steps, failed=judge.failed, compared=judge.compared(),
        window=win, steps=steps, work=work,
        memory_peak_bytes=int(peak))
