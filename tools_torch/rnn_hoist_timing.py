#!/usr/bin/env python3
"""The seq2seq encoder's input projection hoisted out of its time loop,
against a cell call a step, on one card.

    python3 tools_torch/rnn_hoist_timing.py [--rounds 2] [--steps 6]

The model is ``chip_smoke.py``'s PaddleNLP base seq2seq at its published
widths (a 2 x 512 `nn.LSTM` encoder, vocab 17,191 / 7,709, f32, TF32
off) at B128 x 50.  Two forms of the same encoder:

* ``per_step``: the port's `nn.LSTM` with a no-op forward pre-hook on
  each cell, so that `nn.RNN` calls the cell once a step (a hooked cell
  is always called, whatever else `RNN` does);
* ``hoisted``: the same cells' weights run by a loop written here: ``x @
  W_ih.T + b_ih`` for all 50 steps as one GEMM per layer, then ``h @
  W_hh.T + b_hh`` and the gates a step.

First both forms' encoder outputs and states on one batch, dropout off,
within 1e-5 of the largest value.  Then, in turns (per_step, hoisted,
hoisted, per_step for each round), the encoder's forward + backward and
the whole training step (`chip_smoke._s2s_steps`: loss, backward, Adam
under ClipGradByGlobalNorm(5.0), dropout 0.2), each timed with CUDA
events over `steps` calls after one warm-up call.  Prints each turn as a
JSON line, then the mean ms of each form and the hoisted form's ratio to
the per-step form.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hoisted_encoder(lstm):
    """`lstm.forward` (a forward-direction multi-layer `nn.LSTM`) with
    each layer's input projection for every step as one GEMM."""
    import torch

    from paddle_tpu_torch.nn import functional as F

    def forward(x, initial_states=None, sequence_length=None):
        hs, cs = [], []
        for layer, cell in enumerate(lstm.cells):
            xw = x @ cell.weight_ih.T + cell.bias_ih            # [B, T, 4H]
            h = torch.zeros(x.shape[0], cell.hidden_size, dtype=x.dtype,
                            device=x.device)
            c = torch.zeros_like(h)
            outs = []
            for t in range(x.shape[1]):
                gates = xw[:, t] + h @ cell.weight_hh.T + cell.bias_hh
                i, f, g, o = gates.chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(h)
            x = torch.stack(outs, 1)
            if lstm.dropout and layer < lstm.num_layers - 1:
                x = F.dropout(x, lstm.dropout, training=lstm.training)
            hs.append(h)
            cs.append(c)
        return x, (torch.stack(hs, 0), torch.stack(cs, 0))
    return forward


def set_form(model, form, hooks):
    for h in hooks:
        h.remove()
    hooks.clear()
    model.encoder.__dict__.pop("forward", None)
    if form == "hoisted":
        model.encoder.forward = hoisted_encoder(model.encoder)
    else:
        hooks.extend(cell.register_forward_pre_hook(lambda m, i: None)
                     for cell in model.encoder.cells)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("rnn_hoist_timing: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    S = CS.S2S
    batch = tuple(torch.from_numpy(a).cuda() for a in CS._s2s_batch(
        S["batch"], S["max_len"], CS.SEED + 47))
    hooks = []

    model = CS._s2s("cuda", 0.0)
    model.eval()
    got = {}
    with torch.no_grad():
        emb = model.src_emb(batch[0])
        for form in ("per_step", "hoisted"):
            set_form(model, form, hooks)
            out, (h, c) = model.encoder(emb)
            got[form] = torch.cat([out.flatten(), h.flatten(), c.flatten()])
    err = float((got["hoisted"] - got["per_step"]).abs().max()
                / got["per_step"].abs().max())
    if not err <= 1e-5:
        print(f"rnn_hoist_timing: the forms differ by {err:.3g}",
              file=sys.stderr)
        return 1

    model = CS._s2s("cuda", S["dropout"])
    model.train()
    opt = CS._s2s_opt(model)

    def encoder_fb():
        out, (h, c) = model.encoder(model.src_emb(batch[0]))
        (out.sum() + h.sum() + c.sum()).backward()
        opt.clear_grad()

    def train_step():
        CS._s2s_steps(model, opt, batch, 1)

    turns = []
    for _ in range(args.rounds):
        for form in ("per_step", "hoisted", "hoisted", "per_step"):
            set_form(model, form, hooks)
            row = dict(form=form, card=card)
            for what, fn in (("encoder_fwd_bwd_ms", encoder_fb),
                             ("train_step_ms", train_step)):
                row[what] = CS.time_ms(fn, iters=args.steps, warmup=1)
            turns.append(row)
            print(json.dumps(row), flush=True)
    summary = dict(card=card, batch=S["batch"], length=S["max_len"],
                   hidden=S["hidden"], layers=S["layers"],
                   parity_rel_err=err)
    for what in ("encoder_fwd_bwd_ms", "train_step_ms"):
        for form in ("per_step", "hoisted"):
            summary[f"{form}_{what}"] = float(np.mean(
                [t[what] for t in turns if t["form"] == form]))
        summary[f"hoisted_over_per_step_{what[:-3]}"] = (
            summary[f"hoisted_{what}"] / summary[f"per_step_{what}"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
