"""Entry path ``diag``: the batch user's call, ``api.diag`` over host
arrays, one call a file of ``steps_per_call`` steps, the state (thc,
windspeed, winddir) carried from call to call as the batch driver carries
it.

Set-up makes one file's fields on the card from the seed, copies them to
pageable host arrays (where a user's arrays start), and makes two calls
(the first from a cold state at tt = 1).  The window then calls ``diag``
on the same file, back to back, for ``--seconds``, and keeps
``check_samples`` of its calls' answers, drawn from the seed.  A call's
wind state refreshes at the same steps of every call, so from the second
call on the state at each call's start, and so every answer, is the same:
the reference replays the first two calls and judges each kept answer
against its second, once the window has closed.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import compare, roofline, world
from portbench.harness import Outcome
from portbench.reference import trigger as ref
from portbench.trace import Window


def _fields(ctx):
    """The file's fields on the device: ``dict`` of lsm, z, std, pres
    (the configuration's levels ``pres_hpa``, 1-D, or else a static 3-D
    pressure on ``nlev`` model levels), theta (T, h, w), u, v (T, nlev, h,
    w), ci (T, h, w) or None."""
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    lon, lat = world.grid(cfg["grid"])
    h, w = len(lat), len(lon)
    T, nlev = wl["steps_per_call"], cfg["nlev"]
    g = world.generator(ctx.seed, dev)
    lsm, z, std = world.make_world(h, w, g, dev)
    if "pres_hpa" in cfg:
        pres = 100.0 * torch.tensor(cfg["pres_hpa"], dtype=torch.float32,
                                    device=dev)
        if len(pres) != nlev:
            raise ValueError("pres_hpa must list nlev levels")
    else:
        pres = world.pressure_3d(nlev, z, g, dev)
    f = dict(lsm=lsm, z=z, std=std, lon=lon, lat=lat, pres=pres,
             theta=world.noise((T, h, w), 5.0, 288.0, g, dev),
             u=world.noise((T, nlev, h, w), 6.0, 0.0, g, dev),
             v=world.noise((T, nlev, h, w), 6.0, 0.0, g, dev), ci=None)
    if wl["ice"] == "every_step":
        base = h // wl["ice_rows_div"]
        f["ci"] = torch.stack([world.ice_field(
            h, w, base + t // wl["ice_move_steps"], dev) for t in range(T)])
    return f


def _params(ctx):
    p = dict(ctx.config["params"])
    if "timestep_min" in ctx.workload:
        p["timestep"] = ctx.workload["timestep_min"]
    return p


def control_system(ctx):
    """The control: ``api.diag``'s interface over the plain reference
    computed one precision below the configuration's float32."""
    prec = ref.BFLOAT16

    def diag(tt, lsm, z, std, lon, lat, pres, u, v, theta, ci, *, ws=None,
             wd=None, thc=None, device=None, **params):
        dev = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def h(a):                       # time-varying: a step at a time
            return torch.from_numpy(np.asarray(a, np.float32))
        zeros = torch.zeros(np.shape(lsm), device=dev)
        st = ref.State(max(1, int(tt)), *(zeros if a is None else t(a)
                                          for a in (thc, ws, wd)))
        st, sb, _ = ref.diag(st, t(lsm), t(z), t(std), lon, lat, t(pres),
                             h(u), h(v), h(theta),
                             None if ci is None else h(ci),
                             ref.Settings(**params), prec)
        return (st.tt, sb.float().cpu().numpy(),
                *(a.float().cpu().numpy() for a in (st.thc, st.windspeed,
                                                    st.winddir)))
    return diag


def run(ctx) -> Outcome:
    f = _fields(ctx)
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in f.items()}
    # the time-varying fields live on the host alone from here, as a
    # user's do; the reference takes them back to the card a step at a time
    for key in ("theta", "u", "v", "ci"):
        if f[key] is not None:
            f[key] = torch.from_numpy(host[key])
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    params = _params(ctx)
    T = ctx.workload["steps_per_call"]
    if (T * params["timestep"]) % (params["target_time"] * 60.0):
        raise ValueError("a call must span whole wind-refresh periods, so "
                         "that every call after the first starts from the "
                         "same state")
    if ctx.system is None:
        from seabreeze_param_tpu_torch import api
        system = api.diag
    else:
        system = ctx.system

    def call(state):
        tt, sb, thc, ws, wd = system(
            state[0], host["lsm"], host["z"], host["std"], host["lon"],
            host["lat"], host["pres"], host["u"], host["v"], host["theta"],
            host["ci"], ws=state[3], wd=state[2], thc=state[1],
            device=ctx.device, **params)
        return (tt, thc, wd, ws), sb

    state = (1, None, None, None)
    for _ in range(2):                        # warm-up: tt = 1, then 1 + T
        state, _ = call(state)
    if cuda:
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    kept = compare.Reservoir(ctx.workload["check_samples"], ctx.seed)
    calls = 0
    with Window(ctx.trace, cuda) as win:
        while True:
            with torch.profiler.record_function("portbench.diag_call"):
                state, sb = call(state)
            kept.offer(calls, lambda: (sb, state))
            calls += 1
            if win.elapsed() >= ctx.seconds:
                break
    steps = calls * T
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    if ctx.system is None:
        api.clear_exec_cache()
    if cuda:
        torch.cuda.empty_cache()

    # the reference: calls 1 and 2 from a cold state; every later call
    # starts from the state the second call starts from
    settings = ref.Settings(**params)
    static = (f["lsm"], f["z"], f["std"], f["lon"], f["lat"], f["pres"])
    st = ref.State(1, *(torch.zeros_like(f["lsm"]) for _ in range(3)))
    for _ in range(2):
        st, sb_ref, work = ref.diag(st, *static, f["u"], f["v"],
                                    f["theta"], f["ci"], settings)
    state_ref = {"t0": st.thc, "windspeed": st.windspeed,
                 "winddir": st.winddir}
    judge = compare.Judge(ctx.workload["limits"])
    for sb, (_, thc, wd, ws) in kept.items.values():
        judge.judge(sb, sb_ref, {"t0": thc, "windspeed": ws, "winddir": wd},
                    state_ref)
    print(f"portbench: {ctx.cell} seed {ctx.seed}: {calls} calls, "
          f"{judge.judged} checked, worst {judge.worst}",
          file=sys.stderr, flush=True)

    h, w = f["lsm"].shape
    k = work["k"]
    b1 = [roofline.b1_work(r) for r in work["radii"]]
    b3 = [roofline.b3_work(h, w, k, int(r.sum())) for r in work["reach"]]
    if f["ci"] is None:
        b3 = b3[:1] * 2                     # the probe's build and the run's
    else:
        b3 = b3 + b3[:1]                    # every step's, and the probe's
    work_win = {name: tuple(calls * sum(x[i] for x in per) for i in (0, 1))
                for name, per in (("b1", b1), ("b3", b3))}
    return Outcome(
        setup_s=setup_s,
        end_to_end={"diag_ms_per_step": win.wall_s * 1e3 / steps},
        attempted=calls, failed=judge.failed, compared=judge.compared(),
        window=win, steps=steps, work=work_win, memory_peak_bytes=int(peak))
