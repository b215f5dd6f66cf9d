"""Registers and spills of the port's CUDA kernels, as ptxas reports them.

    python -m vsn_tpu_torch.probes.ptxas [CSRC_DIR] [SOURCE ...]
    python -m vsn_tpu_torch.probes.ptxas --against PARENT_CSRC [SOURCE ...]

Compiles each source (default: every ``*.cu`` of ``vsn_tpu_torch/csrc``, or
of CSRC_DIR, e.g. another checkout's) with the library's nvcc flags plus
``-Xptxas -v``, one nvcc per source in parallel, and prints one line per
kernel: ``source  registers  spill-store-bytes  spill-load-bytes  name``
(the name demangled by ``cu++filt`` where the toolkit has it). With
``--against``, compiles the sources of this checkout and of PARENT_CSRC
(another checkout's csrc, e.g. the parent commit's) and prints, for every
kernel both compile, ``source  registers  parent-registers  spills  name``
and ``same`` or ``DIFFERENT``: the check that a body kept statement for
statement keeps its registers. Needs nvcc, not a card.
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


def against(parent: Path, names):
    """[(source, name, registers, parent registers, spills here)] for every
    kernel that both this checkout's and ``parent``'s sources compile."""
    names = names or [src.name for src in sorted(CSRC.glob("*.cu"))
                      if (parent / src.name).exists()]
    here = report([CSRC / n for n in names])
    there = report([parent / n for n in names])
    rows = []
    for src in names:  # by demangled name: an anonymous namespace's
        # mangled name differs from one source tree to another
        old = dict(zip(_demangle([k[0] for k in there[src]]),
                       (k[1] for k in there[src])))
        new = zip(_demangle([k[0] for k in here[src]]), here[src])
        rows += [(src, name, regs, old[name], st + ld)
                 for name, (_, regs, st, ld) in new if name in old]
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--against"]:
        for src, name, regs, old, spills in against(Path(argv[1]), argv[2:]):
            print(f"{src}  {regs:3d}  {old:3d}  {spills:4d}  "
                  f"{'same' if regs == old else 'DIFFERENT'}  {name}")
        return 0
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
