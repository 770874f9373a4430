"""Compare the machine code (SASS) of the CUDA kernels in two checkouts of
the repository.

    python tools/sass_diff.py OLD_ROOT NEW_ROOT

For each root the script builds the port's kernel library (it calls
``pycsou_tpu_torch.kernels._build.library()`` in a subprocess run from that
root) and disassembles it with ``cuobjdump -sass``.  For every kernel that
both libraries hold it prints the instruction count in each and whether the
instructions are the same once their addresses and encodings are stripped;
it lists the kernels that only one library holds.  It exits 1 if a kernel
of both differs.  It needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit).
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _library(root: Path) -> Path:
    code = "from pycsou_tpu_torch.kernels import _build; print(_build.library()._name)"
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"building the kernels of {root} failed:\n{out.stderr[-6000:]}")
    return Path(out.stdout.strip().splitlines()[-1])


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).is_file():
        raise SystemExit("cuobjdump not found (PATH, /usr/local/cuda/bin)")
    return found


def kernels(so: Path) -> dict:
    """{mangled kernel name: [instruction text, ...]} of a library."""
    text = subprocess.run([_cuobjdump(), "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.match(line)
        if m and name is not None:
            out[name].append(m.group(1))
    return out


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__)
        return 2
    old, new = (kernels(_library(Path(r).resolve())) for r in argv)
    differ = 0
    for name in sorted(old.keys() & new.keys()):
        same = old[name] == new[name]
        differ += not same
        print(f"{'same' if same else 'DIFFERS'} {len(old[name])} -> {len(new[name])} instructions  {name}")
    for name in sorted(old.keys() - new.keys()):
        print(f"old only  {name}")
    for name in sorted(new.keys() - old.keys()):
        print(f"new only  {name}")
    print(f"{len(old.keys() & new.keys())} kernels in both, {differ} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
