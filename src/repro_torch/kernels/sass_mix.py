"""Instruction mix of the built kernels, from their SASS.

Usage, on a machine with ``nvcc`` (the kernels are built first)::

    python -m repro_torch.kernels.sass_mix [NAME ...]

prints, for every kernel whose mangled name holds one of the NAMEs (all
kernels without arguments), its opcode counts from ``cuobjdump -sass`` of
the built library. This is where the INT32-pipe operation count of a
threefry2x32 hash in ``chip_smoke.py`` (K4's bound) comes from: the SHF,
LOP3 and IADD3 of the threefry2x32 hashes in ``threefry_chunked_kernel``
(``sass_mix threefry``).
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict

from repro_torch.kernels import _build


def sass_mix(lib_path: Path) -> Dict[str, Dict[str, int]]:
    """{kernel's mangled name: {opcode: count}} of a built library."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    mix = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name, code = body.split("\n", 1)
        ops = re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", code)
        mix[name.strip()] = dict(collections.Counter(ops).most_common())
    return mix


def main(argv=None) -> None:
    names = sys.argv[1:] if argv is None else argv
    for kernel, ops in sass_mix(_build.build()).items():
        if names and not any(n in kernel for n in names):
            continue
        print(f"{kernel}: {sum(ops.values())} instructions")
        print("  " + ", ".join(f"{op} {n}" for op, n in ops.items()))


if __name__ == "__main__":
    main()
