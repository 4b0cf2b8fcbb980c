#!/usr/bin/env python3
"""Whether kernels compiled into two shared libraries are the same machine
code: for each kernel whose mangled name matches a pattern, its SASS
(``cuobjdump -sass``) in library A against library B, instruction for
instruction, with the addresses and the kernel's own name left out.

    python3 tools/sass_compare.py [--rename-b OLD=NEW ...] LIB_A LIB_B
                                  PATTERN [PATTERN ...]

e.g. the ring kernels' small builds of this tree and of a parent checkout,
as built by ``tools/compare_designs.py``:

    python3 tools/sass_compare.py build/designs/lib_B1_this.so \\
        build/designs/lib_B1_parent.so 'ring_kernelILi[012]ELi4ELi3E' \\
        'ring_kernelILi[012]ELi9ELi5E'

``--rename-b OLD=NEW`` rewrites library B's kernel names (a regular
expression and its replacement) before they are paired, for a kernel whose
mangled name changed with its signature only, e.g. B2's pass-2 routine,
which gained a last parameter that its single form never reads:

    python3 tools/sass_compare.py --rename-b 'iPfiii$=iPfiiiS3_' \
        build/designs/lib_B2_this.so build/designs/lib_B2_parent.so \
        'pass2_pruned_kernelILb0E'

Prints one line per kernel (identical, or the first differing line) and
exits 1 when a kernel differs or is missing from either library.  Needs the
CUDA toolkit's ``cuobjdump``.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")


def kernels(lib: str) -> dict[str, list[str]]:
    """Mangled kernel name -> its SASS instructions, addresses and
    encodings dropped.  The hash nvcc puts in the name of a source's
    anonymous namespace, which differs between two builds of one file, is
    left out of the name."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__",
                          m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            funcs[name].append(m.group(1))
    return funcs


def main(argv) -> int:
    renames = []
    while argv[:1] == ["--rename-b"] and len(argv) > 1:
        old, new = argv[1].split("=", 1)
        renames.append((re.compile(old), new))
        argv = argv[2:]
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = kernels(argv[0]), kernels(argv[1])
    for old, new in renames:
        b = {old.sub(new, n): sass for n, sass in b.items()}
    bad = 0
    for pat in argv[2:]:
        names = sorted(n for n in set(a) | set(b) if re.search(pat, n))
        if not names:
            print(f"{pat}: no kernel matches")
            bad += 1
        for n in names:
            if n not in a or n not in b:
                print(f"{n}: only in {'B' if n not in a else 'A'}")
                bad += 1
                continue
            diff = next((i for i, (x, y) in enumerate(zip(a[n], b[n]))
                         if x != y), None)
            if diff is None and len(a[n]) == len(b[n]):
                print(f"{n}: identical ({len(a[n])} instructions)")
                continue
            bad += 1
            i = diff if diff is not None else min(len(a[n]), len(b[n]))
            print(f"{n}: differs at instruction {i} of {len(a[n])} / "
                  f"{len(b[n])}: {a[n][i:i + 1]} vs {b[n][i:i + 1]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
