"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use (never at import: machines without ``nvcc`` import
every module of the package) into ``build/kernels/`` beside the package,
under a name keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.

Flags: ``-O3`` and IEEE float semantics — no ``--use_fast_math``; the
kernels pin their roundings with ``__fadd_rn``/``__fmul_rn`` where an FMA
contraction would change a result.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
_GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*_GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*_GENCODE, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signatures of the launchers; each returns ``cudaGetLastError()``
#: (the ``*_limits`` functions, which read constants, return 0).
SIGNATURES = {
    # mmin, sdphi2, po, row_mono, out, h, w, k, stream
    "sbz_pass2_min": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # &max_staged_k: the widest k of the launcher's staged build
    "sbz_pass2_min_limits": (_P,),
    # mmin, mmax, sdphi2, po, out, h, w, k, scratch, stream: the
    # two-extremum form
    "sbz_pass2_min_two": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    # &max_staged_k: the widest k of its staged build
    "sbz_pass2_min_two_limits": (_P,),
    # h, w, k, &floats: the device scratch of its pruned build
    "sbz_pass2_min_two_scratch": (_I, _I, _I, _P),
    # &cols_per_lane, &group: the unstaged build's layout
    "sbz_pass2_min_layout": (_P, _P),
    # cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k, stream
    "sbz_min_haversine": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # &max_k: the widest k the launcher above takes
    "sbz_min_haversine_limits": (_P,),
    # h, w, k, &floats: the device scratch of the large build below
    "sbz_min_haversine_scratch": (_I, _I, _I, _P),
    # cpad, sdphi2, po, sdlam2, row_mono, out, h, w, k, scratch, stream:
    # the large build, k past the limit above
    "sbz_min_haversine_large": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    # t0_pad, cd_pad, cd, ws_new, wd_new, ws_state, wd_state, ever,
    # sb_buf, ws_buf, wd_buf, h, w, nn, step, is_first, upd, row_offset,
    # nlat_total, skip_last_row, maxdist, thresh_wind, thresh_winddir,
    # thresh_windch, thresh_thc, scratch, stream
    "sbz_ring_trigger_stacked": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _F, _F, _F, _F, _F, _P, _P),
    # t0_pad, cd_pad, cd, ws_new, wd_new, ws_state, wd_state, sb_out,
    # ws_out, wd_out, h, w, nn, is_first, upd, row_offset, nlat_total,
    # skip_last_row, maxdist, thresh_wind, thresh_winddir, thresh_windch,
    # thresh_thc, scratch, stream
    "sbz_ring_trigger_padded": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _F, _F, _F, _P, _P),
    # t0_pad, cd_pad, cd, n_thc, h, w, nn, maxdist, scratch, stream
    "sbz_ring_thc_padded": (_P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
    # &large_from, &max_nn, &max_cells: the ring radii the three launchers
    # above take and the most cells of a padded field (long long)
    "sbz_ring_limits": (_P, _P, _P),
    # h, w, nn, &ints: the int32 scratch the three launchers need
    "sbz_ring_scratch": (_I, _I, _I, _P),
    # cd_pad, ii, ph, pw, stream: the launchers' integral image of land alone
    "sbz_ring_land_image": (_P, _P, _I, _I, _P),
    # src[S], dst[S] (host pointer arrays), py, px, c, h, w, hy, hx,
    # zero_fill, exact_lon, stream
    "sbz_halo_exchange": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # as above, then top, bot (the strips of a process edge, or null), s0,
    # s1 (the launch's group of destination shards; dst holds their s1 - s0
    # pointers), stream
    "sbz_halo_exchange_range": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P, _P, _I, _I, _P),
    # dev, peer: let kernels on card dev read card peer's memory
    "sbz_enable_peer": (_I, _I),
}

#: Seconds the last build took in this process (0.0 when it was cached).
BUILD_STATS = {"seconds": 0.0, "log": ""}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsbz_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; return (return codes, joined output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix=f"{lib.stem}.", dir=BUILD_DIR))
    try:
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [str(work / f"{s.stem}.o") for s in srcs]
        t0 = time.perf_counter()
        rcs, log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", o, str(s)]
                             for s, o in zip(srcs, objs)])
        if not any(rcs):
            tmp = str(work / lib.name)
            link_rcs, link_log = _run_all([[nvcc, *LINK_FLAGS, "-o", tmp,
                                            *objs]])
            rcs, log = rcs + link_rcs, log + link_log
        BUILD_STATS["seconds"] = time.perf_counter() - t0
        BUILD_STATS["log"] = log
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({rcs}):\n{log}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def require(t, name: str, shape, device, dtype=torch.float32):
    """Validate a tensor handed to a launcher: on ``device``, of ``dtype``
    and ``shape``, C-contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check(err: int, name: str):
    """Raise if a launcher reported a CUDA error (a ``cudaError_t`` code)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
