#!/usr/bin/env python3
"""A/B timing of the port's bf16 flash kernels against other builds of
the same C interface, on one CUDA card.

    python3 tools/flash_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu is a variant of ``paddle_tpu_torch/csrc/flash_fwd.cu`` or
``flash_bwd.cu`` (a copy with another tile configuration, say) exporting
`flash_fwd` or `flash_bwd` with the package's signature.  It is built
with the package's nvcc flags (its own directory searched for headers
first, then ``csrc/``), and then, at the main paths' shapes in bf16 --
causal B8 S1024 H12 D64 (GPT-125M train), full B32 S512 H12 D64 (the
ernie_base encoder), full B8 S1024 H16 D128 (the gpt_1p3b fused serving
block) and causal B1 S1008 H16 D128 (an engine prefill) -- each variant
is run in turns with the package's kernel (variant, package, package,
variant; CUDA-event means of 20 calls after 2 warm-ups).  Printed: the
card, the registers and spills of every tensor-core kernel of each
build, whether the outputs are bit-identical, and the four times.  SDPA's
forward time is printed beside them as the yardstick.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SHAPES = (("causal B8 S1024 H12 D64", 8, 1024, 12, 64, True),
          ("full B32 S512 H12 D64", 32, 512, 12, 64, False),
          ("full B8 S1024 H16 D128", 8, 1024, 16, 128, False),
          ("causal B1 S1008 H16 D128", 1, 1008, 16, 128, True))


def build_variants(paths, package, sigs, parse=None):
    """Build each variant source in `paths` with the package's nvcc flags
    (its own directory searched for headers first, then csrc/) while the
    package's sources `package` build, print the kernels of every build
    that `parse` reads from a `ptxas -v` log (default: the bf16
    tensor-core kernels, `chip_smoke._tc_kernels`), and load the
    variants: {file name: CDLL}, with the C functions of `sigs` ({name:
    argtypes}) that each exports bound, or None when a variant fails to
    build."""
    import chip_smoke as C
    from paddle_tpu_torch.ops.kernels import _build

    parse = parse or C._tc_kernels

    procs = {}
    for path in paths:
        path = os.path.abspath(path)
        so = os.path.splitext(path)[0] + ".so"
        procs[path] = (so, subprocess.Popen(
            [_build.nvcc_path()] + _build.ARCH_FLAGS + _build.NVCC_FLAGS
            + ["-I", os.path.dirname(path), "-I", _build.CSRC, "-o", so,
               path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    _build.build(package)
    for n in package:
        with open(os.path.join(_build.BUILD_DIR, f"{n}.log")) as f:
            print(f"package {n}:", parse(f.read()))
    libs = {}
    for path, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {path}:\n{log[-3000:]}",
                  file=sys.stderr)
            return None
        print(f"{os.path.basename(path)}:", parse(log))
        lib = ctypes.CDLL(so)
        for fn, argtypes in sigs.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[os.path.basename(path)] = lib
    return libs

def main(paths):
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    libs = build_variants(paths, ["flash_fwd", "flash_bwd"],
                          {**FA._SIG, **FA._BWD_SIG})
    if libs is None:
        return 1

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd_with(lib, q, k, v, causal):
        b, sq, hq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(b, hq, sq, device="cuda", dtype=torch.float32)
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                            out.data_ptr(), lse.data_ptr(), b, sq,
                            k.shape[1], hq, k.shape[2], d, 0, 0, 0,
                            int(causal), 1.0 / math.sqrt(d), 1, stream())
        _build.check(err, "flash_fwd (variant)")
        return out, lse

    def bwd_with(lib, q, k, v, out, lse, do, causal):
        b, sq, hq, d = q.shape
        delta = torch.empty(b, hq, sq, device="cuda", dtype=torch.float32)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                            out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), b, sq, k.shape[1], hq,
                            k.shape[2], d, 0, 0, 0, int(causal),
                            1.0 / math.sqrt(d), 1, stream())
        _build.check(err, "flash_bwd (variant)")
        return dq, dk, dv

    def turns(other, package):
        t = [C.time_ms(other, 20), C.time_ms(package, 20),
             C.time_ms(package, 20), C.time_ms(other, 20)]
        return " ".join(f"{x:.4f}" for x in t)

    g = torch.Generator(device="cuda").manual_seed(0)
    for label, b, s, h, d, causal in SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        out, lse = FA.flash_fwd(q, k, v, causal=causal)
        grads = FA.flash_bwd(q, k, v, out, lse, do, causal=causal)
        print(f"{label}: SDPA forward "
              f"{C.time_ms(C._sdpa_library(q, k, v, None, causal), 20):.4f}"
              " ms")
        for name, lib in libs.items():
            if hasattr(lib, "flash_fwd"):
                o1, l1 = fwd_with(lib, q, k, v, causal)
                print(f"  {name} forward bit-identical "
                      f"{torch.equal(o1, out) and torch.equal(l1, lse)}; "
                      "ms (variant, package, package, variant) " + turns(
                          lambda lib=lib: fwd_with(lib, q, k, v, causal),
                          lambda: FA.flash_fwd(q, k, v, causal=causal)))
            if hasattr(lib, "flash_bwd"):
                g1 = bwd_with(lib, q, k, v, out, lse, do, causal)
                print(f"  {name} backward bit-identical "
                      f"{all(torch.equal(a, r) for a, r in zip(g1, grads))}"
                      "; ms (variant, package, package, variant) " + turns(
                          lambda lib=lib: bwd_with(lib, q, k, v, out, lse,
                                                   do, causal),
                          lambda: FA.flash_bwd(q, k, v, out, lse, do,
                                               causal=causal)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
