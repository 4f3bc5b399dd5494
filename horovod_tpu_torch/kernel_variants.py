"""Time variants of a kernel's source on the card, in one process, in
turns: the comparisons behind PERF.md's design notes.

    python -m horovod_tpu_torch.kernel_variants k3 [--source NAME=PATH ...]
    python -m horovod_tpu_torch.kernel_variants dq [--source NAME=PATH ...]

`k3`: K3 (`csrc/tiled_matmul.cu`) at the ZeRO-3 head chunk, (16384,
512) @ (512, 512) f32, b the transposed view of a weight band.  Each
variant is a copy of the source with one design choice undone (a
constant or a line replaced, `VARIANTS`), called through the same C
entry, `hvd_tiled_matmul`; the design's strided load path is one more
row.  Every variant is checked against `tiled_matmul_plain` (1e-5, as
chip_smoke.py's K3_RTOL) before it is timed; each row carries its
build's ptxas registers and spills (f32, the vector path) beside cuBLAS
SGEMM (TF32 off) and the f32 bound.

`dq`: K5 on the tensor cores (`hvd_flash_bwd_dq_sm90`) at (1, 16384, 8,
64) and (1, 16384, 4, 128) bf16 causal, the source in the tree against
each `--source` (another revision of `csrc/flash_attention_sm90.cu`),
each checked against `flash_bwd_dq_plain` (chip_smoke.py's FLASH_RTOL,
max-relative and row by row) before it is timed.

`--source NAME=PATH` adds a whole other source (an older revision of
the kernel) under NAME.  Builds go to `build/kernel_variants/`.  Rows
are timed in turns, forward then backward through the list, 10 launches
after 2 each time; each row is the mean of the two passes.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import torch

from . import _build
from .ops import flash_attention as FA
from .ops import matmul_kernels as MK

OUT = os.path.join(_build.BUILD_DIR, "kernel_variants")
HEAD_CHUNK = (16384, 512, 512)  # M, K, N

# name -> [(old text, new text)] applied to csrc/tiled_matmul.cu (128 x
# 128 block tiles, 64-deep stages, three of them, one block of up to 255
# registers per thread on each SM).
VARIANTS = {
    "design": [],
    "strided_loads": "strided",  # the same build, its strided path
    "stages2": [("kStages = 3;", "kStages = 2;")],
    "bk32": [("kBK = 64;", "kBK = 32;")],
    "bk32_stages4": [("kBK = 64;", "kBK = 32;"),
                     ("kStages = 3;", "kStages = 4;")],
    "bk16_stages4": [("kBK = 64;", "kBK = 16;"),
                     ("kStages = 3;", "kStages = 4;")],
    # Two blocks of 128 registers per thread on each SM (32-deep stages,
    # so that both fit in shared memory).
    "two_blocks_per_sm": [("__launch_bounds__(kThreads, 1)",
                           "__launch_bounds__(kThreads, 2)"),
                          ("kBK = 64;", "kBK = 32;")],
    # 256 x 128 block tiles: 16 x 8 sums per thread, 24 values read from
    # shared memory per 128 products where 8 x 8 reads 16 per 64.
    "bm256_bk32": [("kBM = 128;", "kBM = 256;"), ("kBK = 64;", "kBK = 32;")],
}


def _build_all(texts):
    """Build each {name: source text}, all nvccs started together;
    return {name: (library, ptxas lines)}."""
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, text in texts.items():
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{name}.so")
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        built[name] = (ctypes.CDLL(so), out.splitlines())
    return built


def _ptxas(lines, entry: str) -> str:
    """Registers and spills of the entry functions whose mangled name
    contains `entry`."""
    got, current = [], None
    for line in lines:
        if "Compiling entry function" in line:
            current = line
        elif current and entry in current and re.search(
                r"registers|spill", line):
            got.append(line.split(":", 1)[-1].strip())
    return "; ".join(got)


def _time_ms(fn) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def _in_turns(runs: dict) -> dict:
    """{name: fn} timed forward then backward through the names: {name:
    [ms, ms]}."""
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(_time_ms(runs[name]))
    return times


def _sources(args, default: dict) -> dict:
    texts = dict(default)
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            texts[name] = f.read()
    return texts


def k3(args) -> None:
    with open(os.path.join(_build.CSRC, "tiled_matmul.cu")) as f:
        base = f.read()
    texts = {}
    for name, edits in VARIANTS.items():
        if edits == "strided":
            continue
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"kernel_variants {name}: {old!r} not found")
            text = text.replace(old, new)
        texts[name] = text
    built = _build_all(_sources(args, texts))
    libs = {}
    for name, (lib, _) in built.items():
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.hvd_tiled_matmul.argtypes = [p, p, p] + [i64] * 8 + [i32, i32, p]
        lib.hvd_tiled_matmul.restype = i32
        libs[name] = lib
    libs["strided_loads"] = libs["design"]

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(777)
    m, k, n = HEAD_CHUNK
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((n, k), generator=gen, device=dev).t()
    c = torch.empty((m, n), device=dev)
    want = MK.tiled_matmul_plain(a, b)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(name):
        vec = int(name != "strided_loads")
        rc = libs[name].hvd_tiled_matmul(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
            a.stride(1), b.stride(0), b.stride(1), c.stride(0), vec, 0,
            stream)
        if rc:
            raise SystemExit(f"{name}: CUDA error {rc} at launch")

    for name in libs:
        c.zero_()
        run(name)
        torch.cuda.synchronize()
        rel = float((c - want).abs().max() / want.abs().max())
        if not rel <= 1e-5:
            raise SystemExit(f"{name}: relative error {rel} > 1e-5")
    runs = {name: (lambda name=name: run(name)) for name in libs}
    runs["cublas"] = lambda: torch.matmul(a, b, out=c)
    times = _in_turns(runs)
    bound = max(4 * (m * k + k * n + m * n) / 3.35e12,
                2 * m * n * k / 67e12) * 1e3
    for name, ts in times.items():
        ms = sum(ts) / 2
        lines = built.get("design" if name == "strided_loads" else name,
                          (None, []))[1]
        # The f32 kernel of the path timed (older sources have one).
        entry = ("IfLb0E" if name == "strided_loads" else "IfLb1E"
                 if any("Lb1E" in l for l in lines) else "IfEE")
        print(json.dumps({"variant": name, "ms": ms, "passes": ts,
                          "share_of_bound": bound / ms,
                          "ptxas": _ptxas(lines, entry)}), flush=True)
    print(json.dumps({"bound_ms": bound, "shape": HEAD_CHUNK}), flush=True)


def dq(args) -> None:
    with open(os.path.join(_build.CSRC, "flash_attention_sm90.cu")) as f:
        texts = _sources(args, {"design": f.read()})
    built = _build_all(texts)
    for lib, _ in built.values():
        lib.hvd_flash_bwd_dq_sm90.argtypes = [ctypes.c_void_p] * 8 + \
            FA._SHAPE
        lib.hvd_flash_bwd_dq_sm90.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    for shape in ((1, 16384, 8, 64), (1, 16384, 4, 128)):
        B, T, H, D = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .bfloat16() for _ in range(4))
        lse = FA.flash_fwd_plain(q, k, v, True)[1]
        delta = torch.randn((B, T, H), generator=gen, device=dev)
        want = FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, True)
        runs = {}
        for name, (lib, lines) in built.items():
            def run(lib=lib):
                FA._c_libs["sm90"] = lib
                return FA.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                       sm90=True)
            got = run()
            torch.cuda.synchronize()
            rel = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            size = want.double().norm(dim=-1)
            row = float(((got.double() - want.double()).norm(dim=-1)
                         / size.clamp_min(2 ** -8 * float(
                             size.square().mean().sqrt()))).max())
            if not (rel <= 2 ** -6 and row <= 2 ** -6):
                raise SystemExit(f"{name} {shape}: dq error {rel}, rows "
                                 f"{row} > {2 ** -6}")
            runs[name] = run
        times = _in_turns(runs)
        work = 6 * D * B * H * T * (T + 1) // 2
        bound = work / 989e12 * 1e3
        for name, ts in times.items():
            ms = sum(ts) / 2
            entry = f"bwd_dq_sm90ILi{D}ELi1E"
            print(json.dumps({"kernel": "flash_bwd_dq_sm90", "shape": shape,
                              "variant": name, "ms": ms, "passes": ts,
                              "share_of_bound": bound / ms,
                              "ptxas": _ptxas(built[name][1], entry)}),
                  flush=True)
    FA._c_libs.pop("sm90", None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("k3", "dq"))
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another revision of the source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    (k3 if args.kernel == "k3" else dq)(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
