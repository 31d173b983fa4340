#!/usr/bin/env python3
"""Where a captured train step's device memory goes, on one CUDA card.

    python3 tools/graph_memory.py

GPT-125M as `chip_smoke.py` phase 8 trains it (12 layers, bf16 AMP over
f32 masters, AdamW, batch 8 x 1024, seed 0), twice in one process from
fresh models: 12 calls of the step's eager body
(`DistributedTrainStep._step`, what every step ran before the step was a
CUDA graph), then 12 calls of the step (an eager first step, the
capture, replays).  After each run: the peak allocated memory, the
memory allocated after the steps, the live blocks of the caching
allocator by memory pool (the general pool, or a graph's private pool)
and stream, and the largest live blocks with the code that allocated
them; then how much the cuBLAS workspaces (one per stream that ran a
GEMM) hold.  Prints the card's name and power limit first.

    python3 tools/graph_memory.py --phases

runs `chip_smoke.py`'s phases 4 to 7 (serve and generate on gpt_1p3b,
parity, train_parity) first, collecting garbage after each, and reports
what is still allocated after each of them: what a later phase of that
script finds on the card before it starts.
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GIB = 2 ** 30


def _frame(frames):
    """The innermost frame of the repository's code, else the first."""
    for f in frames:
        if "paddle_tpu_torch" in f["filename"] or "chip_smoke" in \
                f["filename"] or "tools/" in f["filename"]:
            return f"{os.path.basename(f['filename'])}:{f['line']} " \
                f"{f['name']}"
    return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "?"


def _report(torch, what):
    snap = torch.cuda.memory._snapshot()
    pools, blocks = {}, []
    for seg in snap["segments"]:
        key = (tuple(seg.get("segment_pool_id", (0, 0))), seg["stream"])
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                pools[key] = pools.get(key, 0) + b["size"]
                blocks.append((b["size"], _frame(b.get("frames", []))))
    peak = torch.cuda.max_memory_allocated() / GIB
    print(f"[{what}] peak allocated {peak:.3f} GiB, allocated now "
          f"{torch.cuda.memory_allocated() / GIB:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / GIB:.3f} GiB")
    for (pool, stream), size in sorted(pools.items(), key=lambda kv: -kv[1]):
        print(f"[{what}]   live in pool {pool} stream {stream:#x}: "
              f"{size / GIB:.3f} GiB")
    by_site = {}
    for size, site in blocks:
        by_site[site] = by_site.get(site, 0) + size
    for site, size in sorted(by_site.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{what}]   {size / GIB:.3f} GiB allocated at {site}")
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        print(f"[{what}]   cuBLAS workspaces: not measured (this torch "
              "cannot clear them)")
        return
    before = torch.cuda.memory_allocated()
    clear()
    print(f"[{what}]   cuBLAS workspaces held "
          f"{(before - torch.cuda.memory_allocated()) / 2**20:.1f} MiB")


def main():
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    if not torch.cuda.is_available():
        print("graph_memory: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=1024, fused_head_ce=True)
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, cfg.vocab_size, (
        8, 1024)).astype(np.int32)).cuda() for _ in range(2))
    torch.cuda.memory._record_memory_history(max_entries=200000)
    if "--phases" in sys.argv[1:]:
        import chip_smoke as CS
        from paddle_tpu_torch.models.gpt import gpt_1p3b

        big = gpt_1p3b()
        model = GPTForCausalLM(big, device="cuda", dtype=torch.bfloat16,
                               seed=CS.SEED)
        CS.phase_serve(model, big, "gpt_1p3b")
        _report(torch, "after serve")
        CS.phase_generate(model, big, "gpt_1p3b")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        _report(torch, "after generate")
        big.num_layers = 2
        CS.phase_parity(GPTForCausalLM, big, "gpt_1p3b")
        gc.collect()
        _report(torch, "after parity")
        CS.phase_train_parity(GPTForCausalLM, CS._gpt125m(2), "GPT-125M",
                              2, 256, ("flash_fwd", "flash_bwd"))
        gc.collect()
        _report(torch, "after train_parity")
    for what in ("eager body", "graph"):
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        step = build_train_step(model, AdamW(learning_rate=1e-4),
                                GPTPretrainingCriterion(model=model),
                                amp_dtype="bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if what == "graph":
            losses = [step(ids, labels) for _ in range(12)]
        else:
            batch = step._place((ids, labels))
            step._lr.fill_(step.optimizer.get_lr())
            losses = [step._step(batch) for _ in range(12)]
        torch.cuda.synchronize()
        print(f"[{what}] losses {float(losses[0]):.4f} -> "
              f"{float(losses[-1]):.4f}")
        _report(torch, what)
        del model, step, losses
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.memory._record_memory_history(enabled=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
