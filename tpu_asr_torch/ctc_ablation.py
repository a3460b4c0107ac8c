"""What bounds the CTC kernels: csrc/ctc.cu with one piece of work taken
out at a time, each copy built with nvcc and timed on one CUDA card.

    python3 tpu_asr_torch/ctc_ablation.py [--variants a,b,...] [--out FILE]

Each variant is csrc/ctc.cu with a text patch (a copy under
build/ctc_ablation/<variant>/, built into its own library and called through
the same C entry points as the port). At the student's CTC shape (fp32,
B=32, T'=376, V=129, S=48) it prints the median device time of 20 launches
of each kernel (CUDA events around the 20) and the forward's cycles a step
at the card's maximum SM clock, beside the errors against the plain versions
(a variant that takes out needed work is wrong on purpose: its time says
what that work costs, its errors are not a check).

  base        the kernels as they are
  no_mufu     ex2 / lg2 replaced by a register move
  no_shuffle  the recursion's neighbour shuffles replaced by own values
  no_store    the forward's alpha stores removed
  no_stage    the recursion's staged-row reads after the first removed
  no_loads    the loaders issue no copies
  no_writers  the backward's writers only zero their frames
  no_repeats  the backward's walk over repeated labels skipped
  all_but_alu no_mufu + no_shuffle + no_store + no_stage
  default_regs  __launch_bounds__ without the one-block-an-SM hint
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tpu_asr_torch" / "csrc" / "ctc.cu"
BUILD = ROOT / "build" / "ctc_ablation"


def _rep(old: str, new: str):
    def patch(src: str) -> str:
        if old not in src:
            raise ValueError(f"ctc_ablation: patch target not found: {old!r}")
        return src.replace(old, new)
    return patch


def _chain(*patches):
    def patch(src: str) -> str:
        for p in patches:
            src = p(src)
        return src
    return patch


NO_MUFU = _chain(_rep("ex2.approx.ftz.f32 %0, %1;", "mov.f32 %0, %1;"),
                 _rep("lg2.approx.ftz.f32 %0, %1;", "mov.f32 %0, %1;"))
NO_SHUFFLE = _chain(
    _rep("      u = __shfl_up_sync(0xffffffffu, a[P - 1], 1);\n      arow",
         "      u = a[P - 1];\n      arow"),
    _rep("      d1 = __shfl_down_sync(0xffffffffu, be[0], 1);\n"
         "      d2 = __shfl_down_sync(0xffffffffu, be[1], 1);\n#pragma",
         "      d1 = be[0];\n      d2 = be[1];\n#pragma"))
NO_STORE = _rep("      arow += lpad;\n      write_row<P>(arow, a, nq);",
                "      arow += lpad;")
NEXT_ROW = "min(f + 1, nf - 1) * Lt::kRow, lane);\n"
NO_STAGE = _chain(
    _rep("      read_row<P>(xn, stage + " + NEXT_ROW, ""),
    _rep("      read_row<P>(xn, lst + " + NEXT_ROW
         + "      read_row<P>(aln, ast + " + NEXT_ROW, ""))
NO_LOADS = _chain(
    _rep("      if (sl.col[i] != -1)\n", "      if (false)\n"),
    _rep("          if (apos[i] >= 0)\n", "          if (false)\n"))
VARIANTS = {
    "base": lambda s: s,
    "no_mufu": NO_MUFU,
    "no_shuffle": NO_SHUFFLE,
    "no_store": NO_STORE,
    "no_stage": NO_STAGE,
    "no_loads": NO_LOADS,
    "no_writers": _rep("      if (live && nm > 0) {", "      if (false) {"),
    "no_repeats": _rep("        if (repeats) {", "        if (false) {"),
    "all_but_alu": _chain(NO_MUFU, NO_SHUFFLE, NO_STORE, NO_STAGE),
    "default_regs": _chain(
        _rep("(kFwdThreads, 1)", "(kFwdThreads)"),
        _rep("(kBwdThreads, 1)", "(kBwdThreads)")),
}


def build(names):
    """{variant: library path}, all nvcc runs started together."""
    from tpu_asr_torch.ops import _kernels as K

    text = SRC.read_text().replace('#include "mma.cuh"',
                                   f'#include "{SRC.parent / "mma.cuh"}"')
    text += ('\nextern "C" const char* tat_error_string(int code) '
             '{ return cudaGetErrorString((cudaError_t)code); }\n')
    cmds, libs = [], {}
    for name in names:
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ctc.cu").write_text(VARIANTS[name](text))
        libs[name] = d / "lib.so"
        cmds.append([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                     str(libs[name]), str(d / "ctc.cu")])
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

    from tpu_asr_torch.ops.cuda_ctc import (_BWD_ARGS, _FWD_ARGS,
                                            ctc_alpha_plain,
                                            ctc_nll_bwd_plain)

    if not torch.cuda.is_available():
        print("ctc_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    libs = build(names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    m = re.search(r"(\d+) MHz", smi)
    clock = float(m.group(1)) * 1e6 if m else float("nan")  # the maximum
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, t, v, s = 32, 376, 129, 48
    lp = torch.log_softmax(torch.randn(b, t, v, generator=gen,
                                       device="cuda") * 2.0, dim=-1)
    tg = torch.randint(0, v - 1, (b, s), generator=gen, device="cuda")
    il = torch.full((b,), t, device="cuda")
    tl = torch.full((b,), s, device="cuda")
    lpad = (2 * s + 4) // 4 * 4
    g = torch.rand(b, generator=gen, device="cuda") + 0.5
    with torch.no_grad():
        alpha_p, _ = ctc_alpha_plain(lp, tg, il, tl, v - 1)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [z.data_ptr() for z in (lp, tg, il, tl)]

    def timed(fn, n=20):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    lines = [f"ctc_ablation: {smi}; fp32 B={b}, T'={t}, V={v}, S={s}"]
    want_d = None
    for name in names:
        lib = ctypes.CDLL(str(libs[name]))
        fwd, bwd = lib.tat_ctc_fwd, lib.tat_ctc_bwd
        fwd.argtypes, bwd.argtypes = list(_FWD_ARGS), list(_BWD_ARGS)
        fwd.restype = bwd.restype = ctypes.c_int
        alpha = torch.empty(b, t, lpad, device="cuda")
        nll = torch.empty(b, device="cuda")
        dlp = torch.empty(b, t, v, device="cuda")
        f = lambda: fwd(*ptrs, alpha.data_ptr(), nll.data_ptr(), b, t, v, s,
                        lpad, v - 1, 7, stream)
        bk = lambda: bwd(*ptrs, alpha.data_ptr(), nll.data_ptr(),
                         g.data_ptr(), dlp.data_ptr(), b, t, v, s, lpad,
                         v - 1, 7, stream)
        if f() or bk():
            raise RuntimeError(f"ctc_ablation: {name} failed to launch")
        torch.cuda.synchronize()
        if want_d is None:
            want_d = ctc_nll_bwd_plain(lp, tg, il, tl, alpha, nll, g, v - 1)
        err_a = (alpha[:, :, :2 * s + 1] - alpha_p).abs().max().item()
        err_d = (dlp - want_d).abs().max().item()
        ms_f, ms_b = timed(f), timed(bk)
        cycles = ms_f * 1e-3 * clock / (t - 1)
        lines.append(
            f"{name:13s} fwd {ms_f:.4f} ms ({cycles:.0f} cycles a step), "
            f"bwd {ms_b:.4f} ms; alpha err {err_a:.2e}, d log-probs err "
            f"{err_d:.2e}")
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
