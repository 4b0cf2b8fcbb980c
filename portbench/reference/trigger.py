"""Plain reference of the sea-breeze trigger, in plain PyTorch.

It follows the Fortran reference (``sobel.f90``'s ``get_edges`` and
``get_dist``, ``seabreeze_diag_python.f90``'s ``diag`` and ``sigmoid``, the
wrapper's time loop) as the loop-faithful NumPy oracle of the repository's
tests transcribes it, written over whole fields so that it runs at a
deployment's size.  It imports nothing of the program under test, and works
out again from the inputs everything the program derives: the coastline,
the signed distance, the ring radius, the wind state.

Where the order of a float32 sum cannot matter to the semantics it is taken
exactly instead (``Precision.geo``, float64): the haversine of the nearest
coast cell, the ring window's means (from integral images, whatever radius
a cell needs: no ring bound), and the orography statistics.  Every field
the Fortran stores (distances, t0, winds, the trigger's arithmetic and the
state) is rounded to ``Precision.field``, float32, as the Fortran's ``real``.

The distance takes, for each source row, the coast cell nearest in index on
each side of a target column within the window (the haversine rises with
the index offset on either side, and a cell reached across a regional
grid's seam is farther than 2 * maxdist, where every candidate gives the
sentinel), then the least over the window's rows: the same minimum as the
reference's scatter over every tap.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

F32 = np.float32
R_EARTH = F32(6370.9989)          # sobel.f90:115
PI = F32(3.1415926)               # sobel.f90:116
D2R = PI / F32(180.0)
RAD2DEG = F32(57.2957)            # seabreeze_diag_python.f90:125
GMMA = F32(-0.0060956)            # seabreeze_diag_python.f90:126
MISSING = F32(2.0e20)             # seabreeze_diag_python.f90:173
SENTINEL = F32(12000.0)           # sobel.f90:145, 188


@dataclasses.dataclass(frozen=True)
class Settings:
    """The trigger's parameters (the reference's f2py defaults)."""

    target_plev: float = 700.0     # hPa
    thresh_wind: float = 11.0      # m/s
    thresh_winddir: float = 90.0   # deg
    thresh_windch: float = 5.0     # m/s
    thresh_thc: float = 0.75       # K
    target_time: float = 6.0       # h
    timestep: float = 24.0         # min
    maxdist: float = 180.0         # km


@dataclasses.dataclass(frozen=True)
class Precision:
    """``field``: the type of every stored field and of the trigger's
    arithmetic; ``geo``: of the haversine, the window means and the
    orography statistics.  Sums over windows and fields accumulate in
    float64 whatever the two are."""

    field: torch.dtype = torch.float32
    geo: torch.dtype = torch.float64


REFERENCE = Precision()
#: The control: the reference computed one precision below the
#: configuration's float32.
BFLOAT16 = Precision(torch.bfloat16, torch.bfloat16)


def search_radius(lon, lat, maxdist) -> int:
    """k = int(maxdist / dx(70 deg)), in float32 (sobel.f90:129-137)."""
    lon = np.asarray(lon, F32)
    lat = np.asarray(lat, F32)
    phi = (D2R * lat).astype(F32)
    lam = (D2R * lon).astype(F32)
    t = int(np.argmin(np.abs(F32(70.0) - lat)))
    if t + 1 >= lat.shape[0]:
        t = lat.shape[0] - 2
    dphi = F32(phi[t + 1] - phi[t])
    dlam = F32(lam[1] - lam[0])
    a = F32(np.sin(dphi / 2, dtype=F32) ** 2
            + np.cos(phi[t + 1], dtype=F32)
            * (np.cos(phi[t], dtype=F32) * np.sin(dlam / 2, dtype=F32) ** 2))
    dx = R_EARTH * F32(2.0) * np.arctan2(np.sqrt(a, dtype=F32),
                                         np.sqrt(F32(1.0) - a, dtype=F32),
                                         dtype=F32)
    return max(0, min(int(F32(maxdist) / dx), max(len(lat), len(lon))))


def _lon_quirky(j, n):
    """Fortran ``max(1, modulo(j, nlons))`` on 0-based j (sobel.f90:68,
    seabreeze_diag_python.f90:202): column n-1 reads column 0."""
    return torch.clamp(torch.remainder(j + 1, n), min=1) - 1


def _frame(field, pad):
    """``field`` (h, w) widened by ``pad`` on every side as the reference's
    windows read it: rows clamped, columns through the quirky map."""
    h, w = field.shape
    dev = field.device
    rows = torch.clamp(torch.arange(-pad, h + pad, device=dev), 0, h - 1)
    cols = _lon_quirky(torch.arange(-pad, w + pad, device=dev), w)
    return field.index_select(0, rows).index_select(1, cols)


def coastline(lsm, ci=None):
    """``get_edges`` (sobel.f90:19-89): 1 where the Sobel gradient of the
    binarised land + ice mask is nonzero."""
    m = lsm if ci is None else lsm + ci
    p = _frame((m > 0.4).to(torch.int32), 1)
    h, w = lsm.shape
    wgt = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
    px = torch.zeros((h, w), dtype=torch.int32, device=lsm.device)
    py = torch.zeros_like(px)
    for di in (-1, 0, 1):          # lat offset
        for dj in (-1, 0, 1):      # lon offset
            tap = p[1 + di:1 + di + h, 1 + dj:1 + dj + w]
            px += wgt[di + 1][dj + 1] * tap
            py += wgt[dj + 1][di + 1] * tap
    return ((px != 0) | (py != 0)).to(torch.float32)


def _branched(lon):
    """Longitudes re-branched to (-180, 180], in radians (sobel.f90:165)."""
    lon = np.asarray(lon, F32)
    return np.where(lon > F32(180.0), D2R * (lon - F32(360.0)),
                    D2R * lon).astype(F32)


def coast_distance(coast, lsm, lon, lat, maxdist, k, prec=REFERENCE):
    """``get_dist`` (sobel.f90:91-193): the signed km distance to the
    nearest coast cell within the (2k+1)^2 window (rows clamped out of the
    grid, columns periodic), positive where lsm > 0, 12000 where no coast
    cell is in reach or the distance passes 2 * maxdist.  Returns
    ``(cdist, reach)``: cdist in ``prec.field``, and where a coast cell is
    in reach."""
    h, w = coast.shape
    dev = coast.device
    geo = prec.geo
    phi = torch.as_tensor((D2R * np.asarray(lat, F32)).astype(F32),
                          device=dev).to(geo)
    lonb = torch.as_tensor(_branched(lon), device=dev).to(geo)

    # per row, the nearest coast column at or left / right of each column
    pos = torch.arange(w + 2 * k, device=dev)
    ext = (coast > 0)[:, torch.remainder(pos - k, w)]
    big = w + 4 * k + 1
    left = torch.cummax(torch.where(ext, pos, -big), dim=1).values
    right = torch.flip(torch.cummin(torch.flip(
        torch.where(ext, pos, 2 * big), [1]), dim=1).values, [1])
    centre = torch.arange(w, device=dev) + k
    inf = torch.tensor(float("inf"), dtype=geo, device=dev)

    def sdlam2(near, ok):
        src = torch.remainder(torch.clamp(near, 0, w + 2 * k - 1) - k, w)
        d = lonb[src] - lonb[None, :]
        return torch.where(ok, torch.sin(d / 2) ** 2, inf)

    L = left[:, centre]
    R = right[:, centre]
    s = torch.minimum(sdlam2(L, L >= centre - k), sdlam2(R, R <= centre + k))

    amin = torch.full((h, w), float("inf"), dtype=geo, device=dev)
    cphi = torch.cos(phi)
    for dy in range(-k, k + 1):
        y0, y1 = max(0, -dy), min(h, h - dy)    # targets whose row y+dy is in
        if y0 >= y1:
            continue
        tgt = phi[y0:y1]
        src = phi[y0 + dy:y1 + dy]
        sphi = torch.sin((src - tgt) / 2) ** 2
        po = torch.clamp(cphi[y0 + dy:y1 + dy] * cphi[y0:y1], min=0.0)
        row = s[y0 + dy:y1 + dy]
        a = torch.where(torch.isfinite(row), sphi[:, None] + po[:, None] * row,
                        inf)
        amin[y0:y1] = torch.minimum(amin[y0:y1], a)

    reach = torch.isfinite(amin)
    a = torch.clamp(torch.where(reach, amin, 0.0), 0.0, 1.0)
    c = (2 * float(R_EARTH)) * torch.atan2(torch.sqrt(a), torch.sqrt(1 - a)) \
        + 0.5
    c = c.to(prec.field)
    sign = torch.where(lsm > 0, 1.0, -1.0).to(prec.field)
    sent = torch.tensor(float(SENTINEL), dtype=prec.field, device=dev)
    cd = torch.where(reach & (c < sent), sign * c, sent)
    cap = float(F32(2.0) * F32(maxdist))
    return torch.where(cd.abs() > cap, sent, cd), reach


def sigmoid_weight(std, prec=REFERENCE):
    """``sigmoid`` (seabreeze_diag_python.f90:287-311)."""
    a = std.to(prec.geo)
    n = a.numel()
    mean = a.to(torch.float64).sum() / n
    var = ((a.to(torch.float64) - mean) ** 2).sum()
    s = (2.0 / torch.sqrt(var / n)).to(prec.geo)
    r = ((a.max() - a.min()) / 4.0).to(prec.geo)
    return (1.0 / (1.0 + torch.exp(-s * (a - r)))).to(prec.field)


def wind_at_level(u, v, pres, target_pa, prec=REFERENCE):
    """Speed and direction at the level nearest the target pressure, the
    first such level, per column for a 3-D pressure (UM/.../
    sea_breeze_diag.F90:265-274; seabreeze_diag_python.f90:228-232)."""
    dist = (pres.to(torch.float32) - float(target_pa)).abs()
    if pres.dim() == 1:
        lev = int(torch.argmin(dist))
        ul, vl = u[lev], v[lev]
    else:
        lev = torch.argmin(dist, dim=0, keepdim=True)
        ul = torch.gather(u, 0, lev)[0]
        vl = torch.gather(v, 0, lev)[0]
    ul, vl = ul.to(prec.field), vl.to(prec.field)
    return (torch.sqrt(ul * ul + vl * vl),
            torch.atan2(-ul, -vl) * float(RAD2DEG))


def ring_means(t0, cdist, targets):
    """The expanding-ring search (seabreeze_diag_python.f90:187-221) for
    every ``targets`` cell, whatever radius it needs: the first nn whose
    (2nn+1)^2 window holds a land (cdist >= 0) and a sea cell, and the
    window's mean t0 over each class, exactly, from integral images.
    Returns ``(mean_land - mean_sea, radius)``, float64 and int64 (radius 0
    off ``targets``)."""
    h, w = t0.shape
    dev = t0.device
    land = cdist >= 0
    if not bool(targets.any()):
        return (torch.zeros((h, w), dtype=torch.float64, device=dev),
                torch.zeros((h, w), dtype=torch.int64, device=dev))
    pad = 8
    while True:
        def image(f):
            return F.pad(_frame(f, pad).cumsum(0).cumsum(1), (1, 0, 1, 0))

        il = image(land.to(torch.int64))
        radius = torch.zeros((h, w), dtype=torch.int64, device=dev)
        done = ~targets
        for nn in range(1, pad + 1):
            a, b = pad - nn, pad + nn + 1
            cnt = (il[b:b + h, b:b + w] - il[a:a + h, b:b + w]
                   - il[b:b + h, a:a + w] + il[a:a + h, a:a + w])
            ok = (cnt > 0) & (cnt < (2 * nn + 1) ** 2) & ~done
            radius = torch.where(ok, nn, radius)
            done = done | ok
            if nn % 16 == 0 and bool(done.all()):
                break
        if bool(done.all()):
            break
        if pad >= 2 * max(h, w):
            raise RuntimeError("ring search: a cell's window never holds "
                               "both land and sea")
        pad *= 2

    it = image(torch.where(land, t0.to(torch.float64), 0.0))
    ia = image(t0.to(torch.float64))
    r = torch.clamp(radius, min=1)
    y = torch.arange(h, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    y0, y1, x0, x1 = y + pad - r, y + pad + r + 1, x + pad - r, x + pad + r + 1

    def box(img):
        return img[y1, x1] - img[y0, x1] - img[y1, x0] + img[y0, x0]

    n_l = box(il).to(torch.float64)
    t_l = box(it)
    n_s = (2 * r + 1).to(torch.float64) ** 2 - n_l
    t_s = box(ia) - t_l
    return t_l / n_l.clamp(min=1) - t_s / n_s.clamp(min=1), radius


def cadence(tt: int, settings: Settings):
    """(is_first, refresh) of timestep tt (seabreeze_diag_python.f90:236,
    271), in float32 as the reference computes it."""
    step_s = F32(settings.timestep) * F32(60.0)
    target_s = F32(settings.target_time) * F32(60.0) ** 2
    return tt < 2, bool(np.mod(F32(tt) * step_s, target_s) < F32(1.0e-4))


@dataclasses.dataclass
class State:
    """The state the reference threads between steps: the step counter and
    the thc / windspeed / winddir fields (thc carries t0, as the
    reference's wrapper threads it)."""

    tt: int
    thc: torch.Tensor
    windspeed: torch.Tensor
    winddir: torch.Tensor


def trigger_step(state: State, theta, u, v, pres, z, smod, cdist,
                 settings: Settings, prec=REFERENCE):
    """One ``diag`` timestep (seabreeze_diag_python.f90:49-285) on the
    signed distance ``cdist``.  Returns ``(new_state, outputs, radius)``:
    outputs ``sb_con``, ``t0``, ``windspeed``, ``winddir`` (zero in the
    last latitude row, which the reference never writes, and whose state
    stays frozen), and each coastal cell's ring radius."""
    fld = prec.field
    h, w = theta.shape
    dev = theta.device
    theta, z = theta.to(fld), z.to(fld)
    t0 = theta - (float(GMMA) * z * smod)
    ws_new, wd_new = wind_at_level(u, v, pres, F32(settings.target_plev)
                                   * F32(100.0), prec)
    maxdist = float(F32(settings.maxdist))
    coastal = cdist.abs() <= maxdist
    row_ok = (torch.arange(h, device=dev) < h - 1)[:, None]
    means, radius = ring_means(t0, cdist, coastal & row_ok)
    mul = torch.where(cdist >= 0, 1.0, -1.0).to(torch.float64)
    n_thc = (mul * means).to(fld)

    is_first, refresh = cadence(state.tt, settings)
    ws_st, wd_st = state.windspeed.to(fld), state.winddir.to(fld)
    seed = coastal if is_first else torch.zeros_like(coastal)
    ws_base = torch.where(seed, ws_new, ws_st)
    wd_base = torch.where(seed, wd_new, wd_st)
    thc_abs = n_thc.abs()
    mws = (ws_base + ws_new) / 2.0
    dws = (ws_base - ws_new).abs()
    dwd = (torch.remainder((wd_base - wd_new) + 180.0, 360.0) - 180.0).abs()
    s = settings
    cond = ((dwd < float(F32(s.thresh_winddir)))
            & (dws < float(F32(s.thresh_windch)))
            & (mws < float(F32(s.thresh_wind)))
            & (thc_abs > float(F32(s.thresh_thc))))
    scale_wind = (float(F32(s.thresh_wind)) - mws) / torch.clamp(mws, min=1.0)
    scale_thc = (thc_abs - float(F32(s.thresh_thc))) / torch.where(
        n_thc == 0, 1.0, n_thc)
    zero = torch.zeros((), dtype=fld, device=dev)
    sb = torch.where(coastal, torch.where(cond, scale_thc * scale_wind, zero),
                     torch.tensor(float(MISSING), dtype=fld, device=dev))
    take = coastal & row_ok & (is_first or refresh)
    ws_st = torch.where(take, ws_new, ws_st)
    wd_st = torch.where(take, wd_new, wd_st)
    out = {"sb_con": torch.where(row_ok, sb, zero),
           "t0": torch.where(row_ok, t0, zero),
           "windspeed": torch.where(row_ok, ws_st, zero),
           "winddir": torch.where(row_ok, wd_st, zero)}
    new = State(state.tt + 1, out["t0"], ws_st, wd_st)
    return new, out, torch.where(coastal & row_ok, radius, 0)


def distance_field(lsm, ci, lon, lat, settings: Settings, prec=REFERENCE):
    """Coastline and signed distance of one (land, sea-ice) pair: the
    coupling's ``prepare_mask``.  Returns ``(cdist, reach, k)``."""
    k = search_radius(lon, lat, settings.maxdist)
    cd, reach = coast_distance(coastline(lsm, ci), lsm, lon, lat,
                               settings.maxdist, k, prec)
    return cd, reach, k


def diag(state: State, lsm, z, std, lon, lat, pres, u_t, v_t, theta_t, ci_t,
         settings: Settings, prec=REFERENCE):
    """The wrapper's time loop (python_wrapper ``__init__.py:219-245``):
    per step the coastline and distance from the step's sea ice (once, from
    land alone, where ``ci_t`` is None), then :func:`trigger_step`, the
    state threaded forward; the time-varying fields may lie on the host,
    and are taken to ``lsm``'s device a step at a time.  Returns
    ``(state, sb_con (T, h, w), work)``, work per step the ring radii and
    the distance's reach, and the distance's radius k."""
    smod = sigmoid_weight(std, prec)
    lsm = lsm.to(torch.float32)
    dev = lsm.device
    sb, radii, reach = [], [], []
    cd = None
    k = search_radius(lon, lat, settings.maxdist)
    for t in range(theta_t.shape[0]):
        if ci_t is not None or cd is None:
            cd, rch, k = distance_field(
                lsm, None if ci_t is None else ci_t[t].to(dev, torch.float32),
                lon, lat, settings, prec)
        state, out, rad = trigger_step(state, theta_t[t].to(dev),
                                       u_t[t].to(dev), v_t[t].to(dev),
                                       pres, z, smod, cd, settings, prec)
        sb.append(out["sb_con"])
        radii.append(rad)
        reach.append(rch)
    return state, torch.stack(sb), {"radii": radii, "reach": reach, "k": k}
