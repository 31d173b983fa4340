#!/usr/bin/env python3
"""A/B timing of the port's decode kernels (`paged_attention` over bf16 /
f32 pools and over int8 pools, `decode_attention`) and of its rope kernel
against other builds of the same C interfaces, on one CUDA card.

    python3 tools/decode_ab.py [--set NAME=V[,NAME=V ...] ...] [OLD_DIR ...]

Each OLD_DIR holds another copy of ``paddle_tpu_torch/csrc``'s
``paged_attention.cu``, ``decode_attention.cu`` and ``rope.cu`` with the
headers they include (an earlier commit's decode core, say); each
``--set`` adds a
copy of the package's two sources whose ``decode_common.cuh`` gives the
named ``constexpr int`` constants other values: ``--set DEC_SPLIT=4``
(the CTAs a cluster), ``DEC_STAGES`` (the ring's tiles),
``DEC_STAGE_BYTES`` (a tile's bytes, which sets the keys a tile).
Every variant is built with the package's nvcc flags, its own directory
searched for headers first, then ``csrc/`` (``tools/flash_ab.py``'s
`build_variants`).  Then, in bf16 and f32, each variant runs in turns
with the package's kernel (variant, package, package, variant), each
time as the profiled device time of one launch (`chip_smoke.device_ms`,
20 launches after 2 warm-ups), at the shapes of ``chip_smoke.py`` phase
3 -- the gpt_1p3b paged row (B4 over the default pool of 513 pages of
16, 16 heads of 128, pos 1031 / 330 / 551 / 0) and dense row (B4 cap 256
left-padded), both at GQA 32/2, the llama_7b decode step's paged and
dense rows (B4, 32 kv heads of 128, ~1000 keys a row) -- at the lengths
of the llama_7b engine decode step that ``chip_smoke.py --profile``
profiles (prompts of 37 / 128 / 300 / 517 tokens, ~8 generated), and at
rows that part a launch's cost: one key a row (the fixed cost) and one
llama_7b row of 129 or 1041 keys alone (one sequence's rate).  The int8
tier's kernel (`paged_attention_int8`, codes and f32 scales from the
codec) runs at phase 3's gpt_1p3b and llama_7b int8 rows, at the
profiled int8 step's lengths and at one key a row.  rope runs at q and k
of a llama_7b layer (32 + 32 heads of 128, views of the fused qkv
projection) at the ragged decode step (B4 S1, per-row phases) and at the
prefill (B1 S1008): the package rotates both in one launch; a variant
whose ``rope`` C function takes one tensor (the earlier interface) runs
two launches, q then k, and its device time is the pair's.  Printed: the
card, each build's registers and spills, whether each variant's output
equals the package's bit for bit (else its largest difference), the four
device times and the byte bound.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCES = ("paged_attention", "decode_attention", "rope")


def _variant_dirs(olds, sets, root):
    """{tag: {source: path}} of the variants: each OLD_DIR's sources and
    headers copied under `root`, and the package's sources with the
    constants of each of `sets` ({name: value}) edited.  File names carry
    the tag, so every library has a name of its own."""
    from paddle_tpu_torch.ops.kernels import _build

    out = {}

    def add(tag, src_dir, edit=None):
        dst = os.path.join(root, tag)
        os.makedirs(dst)
        for fn in os.listdir(src_dir):
            if fn.endswith(".cuh"):
                with open(os.path.join(src_dir, fn)) as f:
                    text = f.read()
                if edit and fn == "decode_common.cuh":
                    text = edit(text)
                with open(os.path.join(dst, fn), "w") as f:
                    f.write(text)
        out[tag] = {}
        for name in SOURCES:
            path = os.path.join(dst, f"{name}_{tag}.cu")
            shutil.copy(os.path.join(src_dir, f"{name}.cu"), path)
            out[tag][name] = path

    for i, old in enumerate(olds):
        add(f"old{i}", old)
    for consts in sets:
        def edit(text, consts=consts):
            for name, value in consts.items():
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
                if n != 1:
                    raise SystemExit(f"decode_ab: no constant {name} in "
                                     "decode_common.cuh")
            return text
        add("-".join(f"{k[4:].lower()}{v}" for k, v in consts.items()),
            _build.CSRC, edit)
    return out


def _regs(text):
    """The exact-tier decode kernels of a build (chip_smoke's
    `_split_kernels`), or, for an older core, the registers and spill
    bytes of every kernel."""
    import chip_smoke as C

    split = C._split_kernels(text)
    if split:
        spilled = [f"{t} CHP{chp} GM{gm}: {r}/{sp}"
                   for _, t, chp, gm, r, sp in split if sp]
        return (f"{len(split)} kernels, registers max "
                f"{max(r for *_, r, _ in split)}, spilling: {spilled}")
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores", text)
    return [f"{r}/{sp}" for r, sp in zip(regs, spills)]


def _rows(torch, dtype):
    """(label, kernel, args of the wrapper, bytes) at phase 3's shapes."""
    import chip_smoke as C

    g = torch.Generator(device="cuda").manual_seed(C.SEED)
    isz = torch.empty((), dtype=dtype).element_size()
    d, ps, npool, p = 128, 16, 4 * 128 + 1, 128
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    for label, hq, hkv, pos in (
            ("gpt_1p3b paged B4 pool513x16x16x128", 16, 16,
             (1031, 330, 551, 0)),
            ("paged GQA 32/2 B4 pool513x2x16x128", 32, 2,
             (1031, 330, 551, 0)),
            ("llama_7b paged B4 pool513x32x16x128", 32, 32,
             (1040, 1000, 960, 1020)),
            ("llama_7b paged B4 at the profiled engine step", 32, 32,
             (45, 136, 308, 525)),
            ("llama_7b paged B4, one key a row (fixed cost)", 32, 32,
             (0, 0, 0, 0)),
            ("llama_7b paged B1, 129 keys (one short row)", 32, 32,
             (128,)),
            ("llama_7b paged B1, 1041 keys (one row's rate)", 32, 32,
             (1040,))):
        q = randn(len(pos), hq, d)
        kp, vp = randn(npool, hkv, ps, d), randn(npool, hkv, ps, d)
        pt = C._paged_table(torch, g, pos, npool, p, ps)
        keys = sum(x + 1 for x in pos)
        rows.append((label, "paged_attention", (q, kp, vp, pt, i32(pos)),
                     2 * keys * hkv * d * isz
                     + 2 * len(pos) * hq * d * isz + pt.numel() * 4
                     + 4 * len(pos)))
    from paddle_tpu_torch.ops.quant import quantize_vectors

    for label, hq, hkv, pos in (
            ("gpt_1p3b int8 B4 pool513x16x16x128", 16, 16,
             (1031, 330, 551, 0)),
            ("llama_7b int8 B4 pool513x32x16x128", 32, 32,
             (1040, 1000, 960, 1020)),
            ("llama_7b int8 B4 at the profiled engine step", 32, 32,
             (45, 136, 308, 525)),
            ("llama_7b int8 B4, one key a row (fixed cost)", 32, 32,
             (0, 0, 0, 0))):
        q = randn(len(pos), hq, d)
        kq, ks = quantize_vectors(torch.randn(npool, hkv, ps, d, generator=g,
                                              device="cuda"))
        vq, vs = quantize_vectors(torch.randn(npool, hkv, ps, d, generator=g,
                                              device="cuda"))
        pt = C._paged_table(torch, g, pos, npool, p, ps)
        keys = sum(x + 1 for x in pos)
        rows.append((label, "paged_attention_int8",
                     (q, kq, vq, pt, i32(pos), ks, vs),
                     keys * hkv * (2 * d + 2 * 4)
                     + 2 * len(pos) * hq * d * isz + pt.numel() * 4
                     + 4 * len(pos)))
    for label, b, s_, per_row in (
            ("rope q+k decode B4 S1 H32+32 D128 per-row", 4, 1, True),
            ("rope q+k prefill B1 S1008 H32+32 D128", 1, 1008, False)):
        qkv = randn(b, s_, 3 * 32 * d)
        q = qkv[..., :32 * d].reshape(b, s_, 32, d)
        k = qkv[..., 32 * d:64 * d].reshape(b, s_, 32, d)
        ang = torch.rand(b if per_row else 1, s_, 1, d, generator=g,
                         device="cuda") * 6
        cos, sin = torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
        rows.append((label, "rope", (q, k, cos, sin),
                     2 * 2 * q.numel() * isz + 2 * cos.numel() * isz))
    for label, hq, hkv, cap, pos, start in (
            ("gpt_1p3b dense B4 cap256 left-pad", 16, 16, 256, 150,
             (0, 28, 64, 111)),
            ("dense GQA 32/2 B4 cap256 left-pad", 32, 2, 256, 150,
             (0, 28, 64, 111)),
            ("llama_7b dense B4 cap1088 left-pad", 32, 32, 1088, 1040,
             (0, 40, 80, 20))):
        q = randn(4, hq, d)
        kc, vc = randn(4, hkv, cap, d), randn(4, hkv, cap, d)
        keys = sum(pos - s + 1 for s in start)
        rows.append((label, "decode_attention",
                     (q, kc, vc, i32([pos] * 4), i32(start)),
                     2 * keys * hkv * d * isz + 2 * 4 * hq * d * isz + 32))
    return rows


def main(argv):
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.ops.kernels import rope as RP
    from tools.flash_ab import build_variants

    sets, olds = [], []
    args = list(argv)
    while args:
        a = args.pop(0)
        if a == "--set":
            sets.append({k: int(v) for k, v in (
                kv.split("=") for kv in args.pop(0).split(","))})
        else:
            olds.append(a)
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    root = tempfile.mkdtemp(prefix="decode_ab_")
    try:
        variants = _variant_dirs(olds, sets, root)
        paths = [p for v in variants.values() for p in v.values()]
        sigs = {**PA._SIG, **PA._INT8_SIG, **DA._SIG}
        libs = build_variants(paths, list(SOURCES), sigs, _regs)
        if libs is None:
            return 1
        # `rope`: the package's paired interface, or the earlier one of a
        # single tensor (x, cos, sin, out, B, S, H, D, 4 strides, flags)
        for v in variants.values():
            with open(v["rope"]) as f:
                paired = "const void* x2" in f.read()
            lib = libs[os.path.basename(v["rope"])]
            lib.paired = paired
            lib.rope.argtypes = RP._SIG["rope"] if paired else (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_int64] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
            lib.rope.restype = ctypes.c_int

        def stream():
            return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def rope_with(lib, a):
            """One launch for q and k (the package's interface), or two
            (a variant whose `rope` takes one tensor)."""
            q, k, cos, sin = a
            b, s_, h, d = q.shape
            spb = s_ * d if cos.shape[0] > 1 else 0
            cs, sn = (t.reshape(t.shape[0], s_, d) for t in (cos, sin))
            vec = 16 // q.element_size()
            outs = [torch.empty(x.shape, dtype=q.dtype, device=q.device)
                    for x in (q, k)]
            st = [[x.stride(i) for i in range(3)] for x in (q, k)]
            dt = RP._DTYPES[q.dtype]
            if lib.paired:
                err = lib.rope(q.data_ptr(), k.data_ptr(), cs.data_ptr(),
                               sn.data_ptr(), outs[0].data_ptr(),
                               outs[1].data_ptr(), b, s_, h, k.shape[2], d,
                               *st[0], *st[1], spb, 0, 0, vec, dt, stream())
            else:
                for x, o, sx in zip((q, k), outs, st):
                    err = lib.rope(x.data_ptr(), cs.data_ptr(),
                                   sn.data_ptr(), o.data_ptr(), b, s_,
                                   x.shape[2], d, *sx, spb, 0, 0, vec, dt,
                                   stream())
                    _build.check(err, "rope (variant)")
            _build.check(err, "rope (variant)")
            return tuple(outs)

        def with_lib(lib, kernel, a):
            if kernel == "rope":
                return rope_with(lib, a)
            q = a[0]
            b, hq, d = q.shape
            out = torch.empty_like(q)
            ptrs = [x.data_ptr() for x in a] + [out.data_ptr()]
            if kernel == "paged_attention_int8":
                q, kq, vq, pt, pos, ks, vs = a
                err = lib.paged_attention_int8(
                    q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                    ks.data_ptr(), vs.data_ptr(), pt.data_ptr(),
                    pos.data_ptr(), out.data_ptr(), b, hq, kq.shape[1],
                    kq.shape[2], pt.shape[1], d, 1.0 / d ** 0.5,
                    PA._DTYPES[q.dtype], stream())
            elif kernel == "paged_attention":
                err = lib.paged_attention(
                    *ptrs, b, hq, a[1].shape[1], a[1].shape[2],
                    a[3].shape[1], d, 1.0 / d ** 0.5, PA._DTYPES[q.dtype],
                    stream())
            else:
                err = lib.decode_attention(
                    *ptrs, b, hq, a[1].shape[1], a[1].shape[2], d,
                    1.0 / d ** 0.5, DA._DTYPES[q.dtype], stream())
            _build.check(err, f"{kernel} (variant)")
            return out

        def paired_rope(q, k, cos, sin):
            return RP.rope(q, cos, sin, k=k)

        def flat(x):       # rope's (q, k) as one tensor, for the compare
            return torch.cat([o.flatten() for o in x]) \
                if isinstance(x, tuple) else x

        wrappers = {"paged_attention": PA.paged_attention,
                    "paged_attention_int8": lambda q, kq, vq, pt, pos, ks,
                    vs: PA.paged_attention(q, kq, vq, pt, pos, k_scales=ks,
                                           v_scales=vs),
                    "decode_attention": DA.decode_attention,
                    "rope": paired_rope}
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for label, kernel, a, nbytes in _rows(torch, dtype):
                def run(kernel=kernel, a=a):
                    return wrappers[kernel](*a)
                ref = flat(run())
                bms, _ = C.bound_ms(nbytes, 0, dname)
                print(f"{label} {dname}: bound {bms:.5f} ms")
                source = "rope" if kernel == "rope" else \
                    "paged_attention" if kernel.startswith("paged") \
                    else kernel
                for tag, srcs in variants.items():
                    lib = libs[os.path.basename(srcs[source])]

                    def other(lib=lib, kernel=kernel, a=a):
                        return with_lib(lib, kernel, a)
                    got = flat(other())
                    same = torch.equal(got, ref)
                    diff = (got.float() - ref.float()).abs().max().item()
                    t = [C.device_ms(other), C.device_ms(run),
                         C.device_ms(run), C.device_ms(other)]
                    print(f"  {tag}: bit-identical {same} (max diff "
                          f"{diff:.3g}); device ms (variant, package, "
                          "package, variant) "
                          + " ".join(f"{v:.4f}" for v in t))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
