#!/usr/bin/env python3
"""A/B timing of the port's exact-tier decode kernels (`paged_attention`,
`decode_attention`) against other builds of the same C interface, on one
CUDA card.

    python3 tools/decode_ab.py [--set NAME=V[,NAME=V ...] ...] [OLD_DIR ...]

Each OLD_DIR holds another copy of ``paddle_tpu_torch/csrc``'s
``paged_attention.cu`` and ``decode_attention.cu`` with the headers they
include (an earlier commit's decode core, say); each ``--set`` adds a
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
llama_7b row of 129 or 1041 keys alone (one sequence's rate).  Printed:
the card, each build's registers and spills, whether each variant's
output equals the package's bit for bit (else its largest difference),
the four device times and the byte bound.
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

SOURCES = ("paged_attention", "decode_attention")


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
        sigs = {**PA._SIG, **DA._SIG}
        libs = build_variants(paths, list(SOURCES), sigs, _regs)
        if libs is None:
            return 1

        def stream():
            return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def with_lib(lib, kernel, a):
            q = a[0]
            b, hq, d = q.shape
            out = torch.empty_like(q)
            ptrs = [x.data_ptr() for x in a] + [out.data_ptr()]
            if kernel == "paged_attention":
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

        wrappers = {"paged_attention": PA.paged_attention,
                    "decode_attention": DA.decode_attention}
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for label, kernel, a, nbytes in _rows(torch, dtype):
                def run(kernel=kernel, a=a):
                    return wrappers[kernel](*a)
                ref = run()
                bms, _ = C.bound_ms(nbytes, 0, dname)
                print(f"{label} {dname}: bound {bms:.5f} ms")
                for tag, srcs in variants.items():
                    lib = libs[os.path.basename(srcs[kernel])]

                    def other(lib=lib, kernel=kernel, a=a):
                        return with_lib(lib, kernel, a)
                    got = other()
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
