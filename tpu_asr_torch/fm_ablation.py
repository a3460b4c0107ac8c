"""What bounds the wide bf16 FM kernels: csrc/fm.cu with one piece of work
taken out at a time, each copy built with nvcc and timed on one CUDA card.

    python3 tpu_asr_torch/fm_ablation.py [--variants a,b,...] [--out FILE]

Each variant is csrc/fm.cu with a text patch (a copy under
build/fm_ablation/<variant>/, built into its own library and called through
the same C entry points as the port). At flowkd_large's FM shape (rows 72 =
4 x 18 layers, T'=376, C=256, H=128, 8 steps) and at the KD step's at
XLarge's widths (rows 32, C=512, 24 steps), bf16, it prints the time of one
forward and one backward call (CUDA events around 10 and 5 calls, the
median of 3 such runs) beside the largest difference from the base
variant's outputs (a variant that takes out needed work is wrong on
purpose: its time says what that work costs, its errors are not a check).

  base          the kernels as they are
  ring2, ring8  a ring of 2 or 8 weight windows (the block shape follows)
  no_sync       the ring's barrier before each window removed
  no_mma        the window products removed
  no_mma_issue  no_mma, and the ring issues no copies
  no_mma_epi    no_mma, and the forward's (and the replay's) epilogues
                skipped
  no_mma_issue_epi  all three
  no_slot       the walk's gx slot read as zeros
  no_store      the walk's workspace stores of h_j, round(dp), round(dv)
                removed
  no_reload     the walk's reload of x_{j-1} from the workspace removed
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tpu_asr_torch" / "csrc" / "fm.cu"
BUILD = ROOT / "build" / "fm_ablation"
SHAPES = ((72, 256, 128, 8), (32, 512, 128, 24))   # rows, C, H, steps


def _rep(old: str, new: str):
    def patch(src: str) -> str:
        if old not in src:
            raise ValueError(f"fm_ablation: patch target not found: {old!r}")
        return src.replace(old, new)
    return patch


def _chain(*patches):
    def patch(src: str) -> str:
        for p in patches:
            src = p(src)
        return src
    return patch


NO_MMA = _rep("  const bf16* w = reinterpret_cast<const bf16*>(slot);\n"
              "  uint32_t af[2][4]",
              "  return;\n  const bf16* w = reinterpret_cast<const bf16*>"
              "(slot);\n  uint32_t af[2][4]")
NO_ISSUE = _chain(
    _rep("    if (nx < total) issue_win(", "    if (false) issue_win("),
    _rep("    if (s < total) issue_win(", "    if (false) issue_win("))
NO_EPI = _rep("          if (kp + 1 < kn) return;\n          if (ph) {",
              "          return;\n          if (ph) {")
VARIANTS = {
    "base": lambda s: s,
    "ring2": _rep("constexpr int kRing = 4;", "constexpr int kRing = 2;"),
    "ring8": _rep("constexpr int kRing = 4;", "constexpr int kRing = 8;"),
    "no_sync": _rep("    __syncthreads();   // window i landed; window i - 1"
                    " consumed\n", ""),
    "no_mma": NO_MMA,
    "no_mma_issue": _chain(NO_MMA, NO_ISSUE),
    "no_mma_epi": _chain(NO_MMA, NO_EPI),
    "no_mma_issue_epi": _chain(NO_MMA, NO_ISSUE, NO_EPI),
    "no_slot": _rep("            const float4 o = sp[i2];",
                    "            const float4 o = make_float4(0.f, 0.f, 0.f,"
                    " 0.f);"),
    "no_store": _chain(
        _rep("                if (in) {", "                if (false) {"),
        _rep("      if (col < cc)\n        *reinterpret_cast<uint32_t*>(wdv",
             "      if (false)\n        *reinterpret_cast<uint32_t*>(wdv")),
    "no_reload": _rep("              tile_in(xs, lx, wk.x + row_at(j - 1) * cc,"
                      " 0, kTile, cc, lane);", "              ;"),
}


def build(names):
    """{variant: library path}, all nvcc runs started together."""
    from tpu_asr_torch.ops import _kernels as K

    text = SRC.read_text().replace('#include "gemm.cuh"',
                                   f'#include "{SRC.parent / "gemm.cuh"}"')
    cmds, libs = [], {}
    for name in names:
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fm.cu").write_text(VARIANTS[name](text))
        libs[name] = d / "lib.so"
        cmds.append([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                     str(libs[name]), str(d / "fm.cu")])
    log, failed = K._run_all(cmds)
    (BUILD / "nvcc.log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from tpu_asr_torch.ops.cuda_fm import _BWD_ARGS, _FWD_ARGS, _SCRATCH_ARGS

    if not torch.cuda.is_available():
        print("fm_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    if names[0] != "base":
        names = ["base"] + [n for n in names if n != "base"]
    libs = build(names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16

    def timed(fn, n):
        runs = []
        for _ in range(3):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / n)
        return statistics.median(runs)

    def entry(lib, fn, argtypes):
        f = getattr(lib, fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
        return f

    lines = [f"fm_ablation: {smi}; bf16, T'=376, per call (CUDA events)"]
    for rows, c, h, ms in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(9)
        nrm = lambda *s, sc=1.0: torch.randn(*s, generator=gen,
                                             device="cuda") * sc
        x0, gx, gv = (nrm(rows, 376, c).to(bf) for _ in range(3))
        n = torch.full((rows,), float(ms), device="cuda")
        w1, w2 = nrm(c, h, sc=c ** -0.5).to(bf), nrm(h, c, sc=h ** -0.5).to(bf)
        a, cv, b2 = nrm(h, sc=0.3), nrm(h, sc=0.1), nrm(c, sc=0.1)
        dims = (rows, 376, c, h, ms)
        base = None
        for name in names:
            lib = ctypes.CDLL(str(libs[name]))
            size = ctypes.c_longlong(0)
            if entry(lib, "tat_fm_bwd_scratch", _SCRATCH_ARGS)(
                    1, *dims, ctypes.addressof(size), stream):
                raise RuntimeError(f"fm_ablation: {name}: no scratch plan")
            scratch = torch.empty(size.value, dtype=torch.uint8,
                                  device="cuda")
            xo, vo, dx = (torch.empty_like(x0) for _ in range(3))
            out = torch.empty(2 * c * h + 2 * h + c, device="cuda")
            fwd_c = entry(lib, "tat_fm_fwd", _FWD_ARGS)
            bwd_c = entry(lib, "tat_fm_bwd", _BWD_ARGS)
            fwd = lambda: fwd_c(1, *(z.data_ptr() for z in (
                x0, n, w1, a, cv, w2, b2, xo, vo)), *dims, stream)
            bwd = lambda: bwd_c(1, *(z.data_ptr() for z in (
                x0, n, w1, a, cv, w2, b2, gx, gv, dx, scratch, out)), *dims,
                stream)
            if fwd() or bwd():
                raise RuntimeError(f"fm_ablation: {name} failed to launch")
            torch.cuda.synchronize()
            got = [z.float().clone() for z in (xo, vo, dx, out)]
            if base is None:
                base = got
            err = max((g - b).abs().max().item() for g, b in zip(got, base))
            ms_f, ms_b = timed(fwd, 10), timed(bwd, 5)
            lines.append(f"C={c} rows={rows} steps={ms} {name:17s} fwd "
                         f"{ms_f:.4f} ms, bwd {ms_b:.4f} ms; max |diff| from "
                         f"base {err:.2e}")
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
