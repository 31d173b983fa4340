#!/usr/bin/env python3
"""A/B timing of the port's bf16 vision kernels against other builds of
the same C interface, on one CUDA card.

    python3 tools/vision_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu is a variant of ``paddle_tpu_torch/csrc/conv_bn_act.cu``
(exporting `conv_bn_act`), of ``window_attention.cu`` (exporting
`window_attention`: an earlier copy, or a copy with another value of a
constant such as ``WF_BLOCKS_PER_SM``) or of ``window_attention_bwd.cu``
(exporting `window_attention_bwd`, and `window_attention_bwd_groups`
where its dbias partials are per group of windows; without it, per
batch), with
the package's signature.  It is built with the package's nvcc flags (its
own directory searched for headers first, then ``csrc/``).  Then, in
bf16, at every dense `conv_bn_act` shape one batch-64 forward of
ResNet-50 and MobileNetV2 gives it, at every `window_attention` shape one
batch-64 forward of Swin-T gives it and at every `window_attention_bwd`
shape one Swin-T train step at batch 128 gives it (all recorded from
those runs, as ``chip_smoke.py`` phase 3 records them), each variant is
run in turns with the package's kernel (variant, package, package,
variant; CUDA-event means of 20 calls after 2 warm-ups; for the window
forward, whose stage-4 calls are short, the profiled device time of one
launch, `chip_smoke.device_ms`).  Printed: the card, the registers and
spills of every tensor-core kernel of each build (``tools/flash_ab.py``'s
`build_variants`), whether the variant's outputs equal the package's bit
for bit (and their largest difference), the four times and the library
call's
(cuDNN `F.conv2d`; SDPA, forward or backward, on the partitioned
windows), and each column summed over ResNet-50's 49 convs, Swin-T's 12
forward calls and its 12 backward calls.
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
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import conv_norm as CN
    from paddle_tpu_torch.ops.kernels import window_attention as WA
    from tools.flash_ab import build_variants

    if not torch.cuda.is_available():
        print("vision_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    libs = build_variants(paths, ["conv_bn_act", "window_attention",
                                  "window_attention_bwd"],
                          {**CN._SIG, **WA._SIG, **WA._BWD_SIG})
    if libs is None:
        return 1

    torch.backends.cudnn.allow_tf32 = False
    vision = C._vision_launches(C.VISION_BATCH)
    train = C._swin_train_launches(C.SWIN_TRAIN_BATCH)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def conv_with(lib, x, w, sc, sh, st, pad, act):
        b, cin, h, wd = x.shape
        cout, _, kh, kw = w.shape
        ho = (h + 2 * pad[0] - kh) // st[0] + 1
        wo = (wd + 2 * pad[1] - kw) // st[1] + 1
        out = torch.empty(b, cout, ho, wo, dtype=x.dtype, device=x.device)
        err = lib.conv_bn_act(x.data_ptr(), w.data_ptr(), sc.data_ptr(),
                              sh.data_ptr(), out.data_ptr(), b, cin, h, wd,
                              cout, kh, kw, st[0], st[1], pad[0], pad[1],
                              ho, wo, CN._ACTS[act], 0, 1, stream())
        _build.check(err, "conv_bn_act (variant)")
        return out

    def wfwd_with(lib, qkv, bias, mask, ws, shift, heads):
        b, h, w, c3 = qkv.shape
        out = torch.empty(b, h, w, c3 // 3, dtype=qkv.dtype,
                          device=qkv.device)
        err = lib.window_attention(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), b, h,
            w, c3 // 3, heads, ws, shift,
            ctypes.c_float((c3 // 3 // heads) ** -0.5), 1, stream())
        _build.check(err, "window_attention (variant)")
        return out

    def wbwd_with(lib, qkv, bias, mask, g, ws, shift, heads):
        b, h, w, c3 = qkv.shape
        groups = (lib.window_attention_bwd_groups(b, h, w, heads, ws, 1)
                  if hasattr(lib, "window_attention_bwd_groups") else 1)
        dqkv = torch.empty_like(qkv)
        part = torch.empty(b * groups, heads, ws * ws, ws * ws,
                           device=qkv.device)
        err = lib.window_attention_bwd(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), part.data_ptr(), b, h, w, c3 // 3, heads, ws,
            shift, ctypes.c_float((c3 // 3 // heads) ** -0.5), 1, stream())
        _build.check(err, "window_attention_bwd (variant)")
        return dqkv, part.sum(dim=0)

    def turns(other, package):
        return [C.time_ms(other, 20), C.time_ms(package, 20),
                C.time_ms(package, 20), C.time_ms(other, 20)]

    def compare(name, got, ref, label, t, lib_ms, uses):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        same = all(torch.equal(a, r) for a, r in zip(got, ref))
        diff = max((a.float() - r.float()).abs().max().item()
                   for a, r in zip(got, ref))
        print(f"  {name} {label}: bit-identical {same} (max diff "
              f"{diff:.3g}); ms (variant, package, package, variant) "
              + " ".join(f"{x:.4f}" for x in t) + f"; library {lib_ms:.4f}"
              f"; x{uses}")

    cases = {c[1]: c for c in C.conv_cases(torch, torch.bfloat16, vision)}
    resnet = {C._vision_label(k, sig): u.get("resnet50", 0)
              for k, sig, u in vision if k == "conv_bn_act"}
    fcases = {c[1]: c for c in C.window_cases(torch, torch.bfloat16,
                                              vision)}
    fuses = {C._vision_label(k, sig): u.get("swin_t", 0)
             for k, sig, u in vision if k == "window_attention"}
    wcases = {c[1]: c for c in C.window_bwd_cases(torch, torch.bfloat16,
                                                  train)}
    wuses = {C._vision_label("window_attention", sig): n
             for sig, n in train}
    for name, lib in libs.items():
        if hasattr(lib, "conv_bn_act"):
            tot = [0.0] * 5
            for label, case in cases.items():
                if label.endswith(" dw"):
                    continue
                run, lib_call = case[2], case[4]
                x, w, sc, sh, st, pad, act = run.__defaults__
                t = turns(lambda: conv_with(lib, x, w, sc, sh, st, pad, act),
                          run)
                lms = C.time_ms(lib_call, 20)
                compare(name, conv_with(lib, x, w, sc, sh, st, pad, act),
                        run(), label, t, lms, resnet.get(label, 0))
                for i, v in enumerate(t + [lms]):
                    tot[i] += resnet.get(label, 0) * v
            print(f"  {name} ResNet-50 B{C.VISION_BATCH} sum over 49 convs "
                  "(variant, package, package, variant, library): "
                  + " ".join(f"{x:.3f}" for x in tot))
        if hasattr(lib, "window_attention"):
            tot = [0.0] * 5
            for label, case in fcases.items():
                run, lib_call = case[2], case[4]
                qkv, bias, mask, heads, ws, sh = run.__defaults__
                def other(lib=lib, qkv=qkv, bias=bias, mask=mask, ws=ws,
                          sh=sh, heads=heads):
                    return wfwd_with(lib, qkv, bias, mask, ws, sh, heads)
                t = [C.device_ms(other), C.device_ms(run),
                     C.device_ms(run), C.device_ms(other)]
                lms = C.device_ms(lib_call)
                compare(name, other(), run(), label, t, lms, fuses[label])
                for i, v in enumerate(t + [lms]):
                    tot[i] += fuses[label] * v
            print(f"  {name} Swin-T B{C.VISION_BATCH} forward, sum over 12 "
                  "calls, device ms (variant, package, package, variant, "
                  "library): " + " ".join(f"{x:.3f}" for x in tot))
        if hasattr(lib, "window_attention_bwd"):
            tot = [0.0] * 5
            for label, case in wcases.items():
                run, lib_call = case[2], case[4]
                qkv, bias, mask, d, heads, ws, sh = run.__defaults__
                t = turns(lambda: wbwd_with(lib, qkv, bias, mask, d, ws, sh,
                                            heads), run)
                lms = C.time_ms(lib_call, 20)
                compare(name, wbwd_with(lib, qkv, bias, mask, d, ws, sh,
                                        heads), run(), label, t, lms,
                        wuses[label])
                for i, v in enumerate(t + [lms]):
                    tot[i] += wuses[label] * v
            print(f"  {name} Swin-T B{C.SWIN_TRAIN_BATCH} train step, sum "
                  "over 12 backward calls (variant, package, package, "
                  "variant, library): " + " ".join(f"{x:.3f}" for x in tot))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
