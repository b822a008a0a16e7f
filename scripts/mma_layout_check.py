"""Check that a change to the port's shared CUDA headers leaves the kernels
it did not mean to touch compiled exactly as before.

    python3 scripts/mma_layout_check.py --old DIR [--sources gram lora_matmul]

``DIR`` holds ``csrc`` as it was: its headers (``mma.cuh``,
``common.cuh``, ...) and any ``.cu`` that changed too, e.g. from ``git
show <rev>:src/repro_torch/csrc/mma.cuh``.  Each source of
``src/repro_torch/csrc`` named (default: every source that includes
``mma.cuh``) is compiled twice to a cubin for sm_90a with the flags the
port's build uses: as it is now, and as ``DIR`` has it (its own ``.cu``
where ``DIR`` holds one, else the current one, against ``DIR``'s
headers).  The SASS of every function present in both builds is compared
instruction by instruction; a function only the current build has (a
new template instantiation) is listed apart.  Both builds compile from
one path, and names are compared with the anonymous namespace's hash
dropped.  Exits 1 if any shared function differs.
Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit): run it on the GPU
machine.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

FLAGS = [f for f in _build.NVCC_FLAGS
         if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]


def sass_by_function(cubin: Path) -> dict:
    """{mangled name: SASS instructions with addresses and encodings
    dropped} of every function in ``cubin``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON",
                          hit.group(1))
            out[name] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and ins:
            out[name].append(ins.group(1))
    return out


def compile_cubin(src: Path, include: Path, out: Path) -> None:
    cmd = [_build._nvcc(), *FLAGS, "-cubin", "-I", str(include), "-o",
           str(out), str(src)]
    subprocess.run(cmd, check=True, timeout=900)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the old headers")
    ap.add_argument("--sources", nargs="*", default=None,
                    help="csrc sources to compare (default: those that "
                         "include mma.cuh)")
    args = ap.parse_args()
    names = args.sources or sorted(
        p.stem for p in _build.CSRC.glob("*.cu")
        if '#include "mma.cuh"' in p.read_text())
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in names:
            builds = {}
            for tag, headers in (("new", _build.CSRC), ("old", args.old)):
                # the .cu beside the headers it is to see first, at one path
                work = tmp / "csrc"
                shutil.rmtree(work, ignore_errors=True)
                work.mkdir()
                for h in headers.glob("*.cuh"):
                    shutil.copy(h, work / h.name)
                cu = headers / f"{name}.cu"
                shutil.copy(cu if cu.exists() else _build.CSRC / f"{name}.cu",
                            work / f"{name}.cu")
                cubin = tmp / f"{name}-{tag}.cubin"
                compile_cubin(work / f"{name}.cu", work, cubin)
                builds[tag] = sass_by_function(cubin)
            new, old = builds["new"], builds["old"]
            shared = sorted(set(new) & set(old))
            differ = [f for f in shared if new[f] != old[f]]
            only_new = sorted(set(new) - set(old))
            print(f"{name}: {len(shared)} functions in both builds, "
                  f"{len(shared) - len(differ)} with identical SASS "
                  f"({sum(len(new[f]) for f in shared)} instructions); "
                  f"differ: {differ or 'none'}; only in the new build: "
                  f"{only_new or 'none'}", flush=True)
            bad += len(differ) + (not shared)     # nothing to compare fails
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
