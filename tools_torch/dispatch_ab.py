#!/usr/bin/env python3
"""Host cost of the port's forward kernel wrappers, another tree against
this one, on one card.

    python3 tools_torch/dispatch_ab.py OTHER_DIR [--iters 200] [--reps 5]

OTHER_DIR holds another commit's ``paddle_tpu_torch/`` and
``chip_smoke.py`` (for example ``git archive PARENT paddle_tpu_torch
chip_smoke.py | tar -x -C _tree_check/parent``).  Both trees build the
sources of the six forward wrappers at once, each in its own process;
then, in turns (other, this, this, other), a fresh interpreter imports a
tree's package and times each wrapper with that tree's
`chip_smoke.host_us`: `iters` calls back to back with no synchronize
between them, so the wrapper's Python, its dispatch and the launch, not
the kernel.  Each turn keeps the median of `reps` such timings per
wrapper.  The shapes are small (bf16), so the kernels finish inside the
host's time.  Prints each turn as a JSON line, then the mean of each
tree's two turns per wrapper and the difference.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["flash_fwd", "rope", "conv_bn_act", "window_attention",
           "fused_norm"]

_CHILD = r"""
import json, os, statistics, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as CS
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build

_build.build(SOURCES)
if MODE == "build":
    sys.exit(0)
g = torch.Generator(device="cuda").manual_seed(0)


def r(*shape):
    return torch.randn(*shape, device="cuda", generator=g).bfloat16()


q, ph = r(1, 128, 12, 64), r(1, 128, 1, 64)
x, w = r(1, 64, 14, 14), r(64, 64, 3, 3)
sc = torch.ones(64, device="cuda")
qkv, bias = r(1, 56, 56, 288), torch.zeros(3, 49, 49, device="cuda")
xn, wn = r(128, 2048), r(2048)
qv = r(256, 12, 64)
cu = torch.tensor([0, 100, 256], dtype=torch.int32, device="cuda")
cases = {
    "flash_fwd": lambda: K.flash_attention.flash_fwd(q, q, q, causal=True),
    "rope": lambda: K.rope.rope(q, ph, ph),
    "conv_bn_act": lambda: K.conv_norm.conv_bn_act(x, w, sc, sc, 1, 1),
    "window_attention": lambda: K.window_attention.window_attention(
        qkv, bias, None, 7, 0, 3),
    "fused_norm": lambda: K.fused_norm.fused_norm(xn, wn, kind="rms"),
    "varlen_fwd": lambda: K.varlen_attention.varlen_fwd(
        qv, qv, qv, cu, cu, causal=True),
}
with torch.no_grad():
    out = {n: statistics.median(CS.host_us(f, iters=ITERS, warmup=5)
                                for _ in range(REPS))
           for n, f in cases.items()}
print("RESULT " + json.dumps(out), flush=True)
"""


def _child(tree, mode, iters, reps):
    code = (f"SOURCES = {SOURCES!r}\nMODE = {mode!r}\nITERS = {iters}\n"
            f"REPS = {reps}\n" + _CHILD)
    return subprocess.Popen([sys.executable, "-c", code], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(proc, what):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"dispatch_ab: {what} failed "
                         f"(rc {proc.returncode}):\n{out[-4000:]}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    trees = {"other": os.path.abspath(a.other), "this": HERE}
    builds = {k: _child(t, "build", a.iters, a.reps)
              for k, t in trees.items()}
    for k, p in builds.items():
        _wait(p, f"the {k} tree's build")
    got = {"other": [], "this": []}
    for k in ("other", "this", "this", "other"):
        out = _wait(_child(trees[k], "time", a.iters, a.reps),
                    f"the {k} tree's timing")
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        row = json.loads(line[-1][len("RESULT "):])
        got[k].append(row)
        print(json.dumps({"tree": k, "host_us": row}), flush=True)
    print(f"{'wrapper':18s} {'other us':>10s} {'this us':>10s} "
          f"{'this - other':>13s}")
    for name in got["this"][0]:
        o = sorted(r[name] for r in got["other"])
        t = sorted(r[name] for r in got["this"])
        om, tm = sum(o) / 2, sum(t) / 2
        print(f"{name:18s} {om:10.1f} {tm:10.1f} {tm - om:13.1f}  "
              f"(turns: other {o[0]:.1f}-{o[1]:.1f}, this "
              f"{t[0]:.1f}-{t[1]:.1f})")


if __name__ == "__main__":
    main()
