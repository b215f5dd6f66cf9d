"""Registers and spills of the port's CUDA kernels, as ptxas reports them.

    python -m vsn_tpu_torch.probes.ptxas [CSRC_DIR] [SOURCE ...]

Compiles each source (default: every ``*.cu`` of ``vsn_tpu_torch/csrc``, or
of CSRC_DIR, e.g. another checkout's) with the library's nvcc flags plus
``-Xptxas -v``, one nvcc per source in parallel, and prints one line per
kernel: ``source  registers  spill-store-bytes  spill-load-bytes  name``
(the name demangled by ``cu++filt`` where the toolkit has it). Needs nvcc,
not a card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from vsn_tpu_torch.ops._build import CSRC, NVCC_FLAGS, _nvcc

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse(text: str):
    """[(mangled kernel name, registers, spill stores, spill loads)] from
    the ``-Xptxas -v`` output of one compilation."""
    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = _SPILL.search(line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


def _demangle(names):
    tool = shutil.which("cu++filt") or str(Path(_nvcc()).parent / "cu++filt")
    if not Path(tool).exists():
        return list(names)
    res = subprocess.run([tool, *names], capture_output=True, text=True)
    got = res.stdout.splitlines()
    return got if len(got) == len(names) else list(names)


def report(sources):
    """{source name: parse(...)} for each source, compiled in parallel."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for src in sources]
        out = {}
        for src, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{err}")
            out[src.name] = parse(err)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    csrc = Path(argv[0]) if argv else CSRC
    names = argv[1:]
    sources = ([csrc / n for n in names] if names
               else sorted(csrc.glob("*.cu")))
    for src, kernels in report(sources).items():
        pretty = _demangle([k[0] for k in kernels])
        for (_, regs, st, ld), name in zip(kernels, pretty):
            print(f"{src}  {regs:3d}  {st:4d}  {ld:4d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
