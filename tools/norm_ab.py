#!/usr/bin/env python3
"""A/B timing of the port's fused norm kernel against other builds of the
same C interface, on one CUDA card.

    python3 tools/norm_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu is a variant of ``paddle_tpu_torch/csrc/fused_norm.cu``
exporting `fused_norm` with the package's signature (an earlier copy of
the source, or a copy with another value of a constant such as
``FV_NV``).  It is
built with the package's nvcc flags (``tools/flash_ab.py``'s
`build_variants`: its own directory searched for headers first, then
``csrc/``).  Then, in bf16 and f32, at the four shapes of
``chip_smoke.py`` phase 3 (`fused_norm_cases`: LayerNorm at gpt_1p3b's
[8192, 2048] and ernie_base's [16384, 768], RMS with bias and residual at
[8192, 2048], LayerNorm at an odd width [4096, 1000]), each variant is
run in turns with the package's kernel (variant, package, package,
variant), each time as the profiled device time of one launch
(`chip_smoke.device_ms`, 20 launches after 2 warm-ups): these kernels
are short, and a CUDA-event time would read the host.  Printed: the
card, the registers and spills of every vector kernel of each build,
whether the variant's y and z equal the package's bit for bit (and their
largest difference), the four device times, the library call's
(`F.layer_norm` / `F.rms_norm` on the precomputed sum, as phase 3) and
the byte bound.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(paths):
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.ops.kernels import fused_norm as FN
    from paddle_tpu_torch.ops.kernels import _build
    from tools.flash_ab import build_variants

    if not torch.cuda.is_available():
        print("norm_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    libs = build_variants(paths, ["fused_norm"], FN._SIG, C._row_kernels)
    if libs is None:
        return 1

    def with_lib(lib, x, w, b, bias, res, eps, kind):
        y = torch.empty_like(x)
        z = torch.empty_like(x) if bias is not None or res is not None \
            else None
        d = x.shape[-1]
        wd = {t.dtype for t in (w, b) if t is not None}
        wd = wd.pop() if wd else x.dtype
        err = lib.fused_norm(
            *(None if t is None else t.data_ptr()
              for t in (x, w, b, bias, res, y, z)), x.numel() // d, d, eps,
            int(kind == "rms"), FN._DTYPES[x.dtype], FN._DTYPES[wd],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(err, "fused_norm (variant)")
        return y, z

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for case in C.fused_norm_cases(torch, dtype):
            _, label, run, _, lib_call, nbytes, flops, ops_dtype, _ = case
            x, w, b, bias, res, kind = run.__defaults__
            eps = 1e-5
            ref = run()
            bms, _ = C.bound_ms(nbytes, flops, ops_dtype)
            lms = C.device_ms(lib_call)
            print(f"{label} {dname}: library device {lms:.4f} ms, bound "
                  f"{bms:.5f} ms")
            for name, lib in libs.items():
                def other(lib=lib):
                    return with_lib(lib, x, w, b, bias, res, eps, kind)
                got = other()
                pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
                same = all(torch.equal(a, r) for a, r in pairs)
                diff = max((a.float() - r.float()).abs().max().item()
                           for a, r in pairs)
                t = [C.device_ms(other), C.device_ms(run),
                     C.device_ms(run), C.device_ms(other)]
                print(f"  {name}: bit-identical {same} (max diff "
                      f"{diff:.3g}); device ms (variant, package, package,"
                      f" variant) " + " ".join(f"{v:.4f}" for v in t))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
