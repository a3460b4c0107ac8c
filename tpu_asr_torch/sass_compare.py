"""Compare the SASS of the kernels of two checkouts on one CUDA machine.

    python -m tpu_asr_torch.sass_compare --root OTHER_TREE [--match TEXT]

Builds (or finds) each tree's kernel library (ops/_kernels.build), dumps
its SASS with cuobjdump, and for every kernel of this tree whose name holds
--match prints whether its code is line for line the other tree's kernel
of the same name, addresses left out. A kernel that gained a trailing bool
template argument is matched to the other tree's kernel without it when
the argument is false (`dq_mma_kernel<48, false>` against
`dq_mma_kernel<48>`): the way to show that a new mode compiled as a
template parameter left the old instantiation as it was.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys

from tpu_asr_torch.profile_forward import short_symbol

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def library(tree: str) -> str:
    """Path of `tree`'s built kernel library (built if missing)."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from tpu_asr_torch.ops import _kernels; print(_kernels.build())"],
        cwd=tree, capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def functions(path: str) -> dict:
    """{short kernel name: [SASS lines without addresses]} of a library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_symbol(m.group(1))
            out[name] = []
        elif name is not None:
            code = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if code and not code.startswith(".") and code != "{":
                out[name].append(code)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="the other checkout")
    ap.add_argument("--match", default="", help="compare kernels whose "
                    "name holds this text")
    args = ap.parse_args(argv)
    mine = functions(library(HERE))
    other = functions(library(os.path.abspath(args.root)))
    for name in sorted(k for k in mine if args.match in k):
        twin = name if name in other else name.replace(", false>", ">")
        if twin not in other:
            print(f"SASS {name}: not in {args.root}")
            continue
        a, b = other[twin], mine[name]
        diff = [d for d in difflib.unified_diff(a, b, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        print(f"SASS {name} ({len(b)} lines) against {twin} in {args.root} "
              f"({len(a)} lines): "
              f"{'identical' if not diff else f'{len(diff)} lines differ'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
