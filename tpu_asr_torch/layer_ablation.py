"""Where the bf16 layer kernel's time goes: csrc/layer.cu with phases of
layer_mma_kernel taken out, each copy built with nvcc and timed on one
CUDA card.

    python3 tpu_asr_torch/layer_ablation.py [--variants a,b,...] [--out FILE]

Each variant is csrc/layer.cu with a text patch (a copy under
build/layer_ablation/<variant>/, built into its own library and called
through the same C entry point as the port). At chip_smoke.py phase 14's
shape (bf16, B=32, T'=376, D=176, 4 heads, d_ff 704, k=31, ragged lengths)
it prints the median device time of 20 launches (CUDA events around the
20) and the output's max error against the plain version (a variant that
takes out needed work is wrong on purpose: its time says what the work
left costs, its error is not a check).

  base      the kernel as it is
  a, b, c, d  only that phase (A: FFN1, q/k/v and P; B: the attention core;
            C: W_o, LN, pointwise 1, GLU; D: depthwise, pointwise 2, FFN2,
            final LN); the three grid barriers stay
  barriers  no phase, only the launch and the three grid barriers
  no_ffn    phases A and D without their FFN halves' products
  no_wait   the B stream's consumer does not wait for its copies
  no_sync   ... nor passes the block barrier a stage (data races)
  no_copy   the B stream copies nothing
  no_mma    the row phases' products replaced by one add of their operands
  guarded   the products' tile loops with a runtime test before each
            product that never fails (the kernel's loops have none)
  lds_first a stage's B fragments all loaded before its products
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "tpu_asr_torch" / "csrc"
BUILD = ROOT / "build" / "layer_ablation"
PHASES = {
    "a": "  for (int i = blockIdx.x; i < row_tiles + pos_tiles; i += gridDim.x) {",
    "b": "  for (int i = blockIdx.x; i < H * row_tiles; i += gridDim.x) {",
    "c": "  for (int i = blockIdx.x; i < row_tiles; i += gridDim.x)\n"
         "    mma_phase_c",
    "d": "  for (int i = blockIdx.x; i < row_tiles; i += gridDim.x) {\n"
         "    __syncthreads();  // the previous tile's depthwise rows",
}


def _skip(*phases):
    def patch(src: str) -> str:
        for ph in phases:
            old = PHASES[ph]
            if old not in src:
                raise ValueError(f"layer_ablation: patch target not found: "
                                 f"{old!r}")
            src = src.replace(old, old.replace("i = blockIdx.x;",
                                               "i = 1 << 30;", 1))
        return src
    return patch


def _no_ffn(src: str) -> str:
    old = "  for (int c = 0; c < fp / kFC; ++c) {\n    float h[8][4];"
    if old not in src:
        raise ValueError("layer_ablation: patch target not found (FFN)")
    # the products and their stages skipped (the products after them read
    # other stages)
    return src.replace(old, old.replace("c < fp / kFC", "c < 0"))


def _chain(*patches):
    def patch(src: str) -> str:
        for p in patches:
            src = p(src)
        return src
    return patch


def _rep(old: str, new: str):
    def patch(src: str) -> str:
        if old not in src:
            raise ValueError(f"layer_ablation: patch target not found: "
                             f"{old!r}")
        return src.replace(old, new)
    return patch


NEXT = "    cp_async_wait<kStages - 2>();\n    __syncthreads();\n"
FAKE_MMA = """
__device__ __forceinline__ void fake_mma(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  c[0] += __uint_as_float((a[0] ^ b0 ^ b1) & 0x3f800000u);
}
"""


def _no_mma(src: str) -> str:
    at = src.index("// Fragment-packed weights.")
    head, tail = src[:at], src[at:]
    return head + FAKE_MMA + tail.replace("mma_bf16(", "fake_mma(")


VARIANTS = {
    "base": lambda s: s,
    "a": _skip("b", "c", "d"),
    "b": _skip("a", "c", "d"),
    "c": _skip("a", "b", "d"),
    "d": _skip("a", "b", "c"),
    "barriers": _skip("a", "b", "c", "d"),
    "no_ffn": _no_ffn,
    "no_wait": _rep(NEXT, "    __syncthreads();\n"),
    "no_sync": _rep(NEXT, ""),
    "no_copy": _rep("    for (int o = 16 * threadIdx.x; o < 256 * pc.tiles;",
                    "    for (int o = 16 * threadIdx.x; o < 0;"),
    "no_mma": _no_mma,
    "guarded": _chain(
        _rep("    for (int j = 0; j < NT; ++j) {\n      const uint2 f = b[32 * j];\n"
             "      mma_bf16(acc[j], af, f.x, f.y);\n    }",
             "    for (int j = 0; j < NT; ++j)\n      if (j < ks + NT) {\n"
             "        const uint2 f = b[32 * j];\n"
             "        mma_bf16(acc[j], af, f.x, f.y);\n      }"),
        _rep("      for (int j = 0; j < NT; ++j) {  // past nd: as in tile_mma\n",
             "      for (int j = 0; j < NT; ++j)\n        if (j < fp) {\n")),
    "lds_first": _rep(
        "    for (int j = 0; j < NT; ++j) {\n      const uint2 f = b[32 * j];\n"
        "      mma_bf16(acc[j], af, f.x, f.y);\n    }",
        "    uint2 f[NT];\n#pragma unroll\n    for (int j = 0; j < NT; ++j) "
        "f[j] = b[32 * j];\n#pragma unroll\n    for (int j = 0; j < NT; ++j)\n"
        "      mma_bf16(acc[j], af, f[j].x, f[j].y);"),
}


def build(names):
    """{variant: library path}, all nvcc runs started together."""
    from tpu_asr_torch.ops import _kernels as K

    text = (CSRC / "layer.cu").read_text()
    text += ('\nextern "C" const char* tat_error_string(int code) '
             '{ return cudaGetErrorString((cudaError_t)code); }\n')
    cmds, libs = [], {}
    for name in names:
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "layer.cu").write_text(VARIANTS[name](text))
        libs[name] = d / "lib.so"
        cmds.append([K._nvcc(), *K.NVCC_FLAGS, "-I", str(CSRC), "-shared",
                     "-o", str(libs[name]), str(d / "layer.cu")])
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

    from tpu_asr_torch.ops import cuda_layer as L
    from tpu_asr_torch.profile_kernels import conformer_layer_args

    if not torch.cuda.is_available():
        print("layer_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    libs = build(names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _, x, mask, _, (_, _, prm, h, k, pad_l, norm) = conformer_layer_args(
        torch)
    b, t, d = x.shape
    dff = prm["w11"].shape[0]
    with torch.no_grad():
        want = L.conformer_layer_plain(x, mask, prm, h, k, pad_l,
                                       norm).float()
    _, ptrs = L._weights(2, prm, d, h, k)
    m8 = mask.contiguous().view(torch.uint8)
    pe = L.position_table(t, d, x.device)
    ws = torch.empty(L.workspace_bytes(2, b, t, d), dtype=torch.uint8,
                     device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

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

    lines = [f"layer_ablation: {smi}; bf16 B={b}, T'={t}, D={d}, {h} heads, "
             f"d_ff {dff}, k={k}"]
    for name in names:
        fn = ctypes.CDLL(str(libs[name])).tat_conformer_layer
        fn.argtypes, fn.restype = list(L._ARGS), ctypes.c_int
        call = lambda: fn(2, ptrs, len(ptrs), x.data_ptr(), m8.data_ptr(),
                          pe.data_ptr(), out.data_ptr(), ws.data_ptr(),
                          ws.numel(), b, t, d, h, dff, k, pad_l, 0, -1, -1,
                          None, stream)
        if call():
            raise RuntimeError(f"layer_ablation: {name} failed to launch")
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        lines.append(f"{name:9s} {timed(call):.4f} ms a launch; max |err| "
                     f"{err:.2e}")
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
