#!/usr/bin/env python3
"""An earlier tree against this one, in turns on one CUDA card: what the
CUDA graphs of the engine's prefills, `generate()`'s decode chunks and
`jit.to_static` should move, measured through entry points both trees
have.

    python3 tools/graph_ab.py PARENT_DIR [--chunks]

PARENT_DIR holds an earlier checkout (its `paddle_tpu_torch/`), e.g.
`git archive PARENT | tar -x -C _tree_check/parent`.  The kernels are
built once in this tree and their libraries copied into PARENT_DIR's
build directory (a library's name is the hash of its sources, so equal
sources load; others build there).  Then four turns (parent, this tree,
this tree, parent), each a fresh process that imports `paddle_tpu_torch`
from its tree and the measurements from this tree's `chip_smoke.py`:

  * serve: gpt_1p3b, llama_7b and llama_7b under kv_precision="int8"
    (bf16, full depth, seeded weights, the default EngineConfig), the 8
    requests x 32 tokens of chip_smoke phase 4 served twice with the
    prefix cache cleared in between (`_serve_passes`): per round
    tokens/s, TTFT p50 and max, the mean decode step, the mean prefill
    wall by bucket; the peak allocated and reserved memory of the run;
  * generate: gpt_1p3b and llama_7b, B4 x 128 + 32 tokens, on a call
    after a warm-up call (`_generate_rate`): tokens/s, decode ms a step;
  * vision: ResNet-50, MobileNetV2, Swin-T in bf16 at B64 224x224,
    images/s eager, and through `jit.to_static` where the tree has it;
  * prefill: llama_7b cold prefills at S1008 and S48 under
    torch.profiler (`_profile_cold_prefill`): wall, device busy share,
    host launch calls.

--chunks adds, in this tree only: phase 4's serving (gpt_1p3b) with
PADDLE_TPU_ENGINE_DECODE_CHUNK at 1, 4 and 8, one process each; and the
host work around a llama_7b decode replay (4 slots busy): the graph's
launch without the profiler, `_batch_arrays`, the three copies of its
arrays from pageable memory, the read-back of the tokens, the whole
`_run_decode`.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import gc
import glob
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VISION = ("resnet50", "mobilenet_v2", "swin_t")


def _load(tree):
    """This tree's chip_smoke, with `paddle_tpu_torch` imported from
    `tree`."""
    sys.path.insert(0, HERE)
    import chip_smoke as C

    sys.path.insert(0, os.path.abspath(tree))
    import paddle_tpu_torch

    where = os.path.dirname(os.path.dirname(paddle_tpu_torch.__file__))
    assert os.path.samefile(where, tree), (where, tree)
    return C


def _release():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _serve(C, model, cfg, name, kv=None):
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    _release()
    prompts = C._prompts(cfg.vocab_size)
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, EngineConfig(kv_precision=kv))
    eng.generate([prompts[1][:16]], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds = C._serve_passes(eng, prompts)
    peak, reserved = (torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_reserved())
    what = f"{name} kv {kv or 'full'} chunk {eng.config.decode_chunk}"
    for i, r in enumerate(rounds):
        C.log(f"[ab serve] {what} round {i + 1}: {C._round_line(r)}")
    C.log(f"[ab serve] {what} memory: peak allocated {peak / 2**30:.3f} "
          f"GiB, reserved {reserved / 2**30:.3f} GiB, model "
          f"{base / 2**30:.3f} GiB")
    del eng
    _release()


def _generate(C, model, cfg, name):
    import numpy as np

    ids = np.random.RandomState(C.SEED + 1).randint(
        0, cfg.vocab_size, (4, 128)).astype(np.int32)
    r = C._generate_rate(model, ids)
    C.log(f"[ab generate] {name} B4 x 128 +32: {r['tokens_per_s']:.1f} "
          f"tokens/s, {r['wall_ms']:.2f} ms a call, decode "
          f"{r['decode_ms']:.3f} ms a step")
    _release()


def _vision(C):
    import torch

    try:
        from paddle_tpu_torch.jit import to_static
    except ImportError:              # a tree from before jit.to_static
        to_static = None
    g = torch.Generator(device="cuda").manual_seed(C.SEED + 7)
    x = torch.randn(C.VISION_BATCH, 3, 224, 224, generator=g,
                    device="cuda", dtype=torch.bfloat16)
    for name in VISION:
        model = C._vision_model(name, "cuda", torch.bfloat16)
        with torch.inference_mode():
            rate, ms, _ = C._vision_rate(model, x, 10)
            line = f"eager {rate:.1f} images/s ({ms:.2f} ms/batch)"
            if to_static is not None:
                to_static(model)
                rate, ms, _ = C._vision_rate(model, x, 10)
                line += f", to_static {rate:.1f} images/s ({ms:.2f} " \
                    "ms/batch)"
        C.log(f"[ab vision] {name} bf16 B{C.VISION_BATCH}: {line}")
        del model
        _release()


def run_tree(tree):
    C = _load(tree)
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    C.log(f"[ab] tree {tree}")
    cfg = gpt_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=C.SEED)
    _serve(C, model, cfg, "gpt_1p3b")
    _generate(C, model, cfg, "gpt_1p3b")
    del model
    lcfg = llama_7b()
    model = LlamaForCausalLM(lcfg, device="cuda", dtype=torch.bfloat16,
                             seed=C.SEED)
    _serve(C, model, lcfg, "llama_7b")
    _serve(C, model, lcfg, "llama_7b", "int8")
    _generate(C, model, lcfg, "llama_7b")
    for n in (1000, 37):
        C._profile_cold_prefill(model, lcfg, n)
        _release()
    del model
    _release()
    _vision(C)


def run_chunk():
    """Phase 4's serving at the decode chunk the environment sets."""
    C = _load(HERE)
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b

    cfg = gpt_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=C.SEED)
    _serve(C, model, cfg, "gpt_1p3b")


def run_host_work():
    """The host work around one llama_7b decode replay, 4 slots busy."""
    C = _load(HERE)
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = llama_7b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=C.SEED)
    eng = InferenceEngine(model, EngineConfig())
    for p in C._prompts(cfg.vocab_size)[1:5]:
        eng.submit(p, max_new_tokens=400)
    for _ in range(3):
        eng.step()
    running = eng.scheduler.running_seqs()
    tok, pt, lengths = eng._batch_arrays(running)
    prog = eng._decode_program(1)
    torch.cuda.synchronize()
    rows = {"_batch_arrays": C.host_us(lambda: eng._batch_arrays(running),
                                       200)}

    def copies():
        for dst, src in ((prog.tok, tok), (prog.pt, pt),
                         (prog.lengths, lengths)):
            dst.copy_(torch.from_numpy(src), non_blocking=True)

    with torch.inference_mode():
        rows["three copies"] = C.host_us(copies, 200)
        rows["toks.to('cpu')"] = C.host_us(
            lambda: prog.toks.to("cpu", copy=True), 200)
        # the graph's own launch, without the counters or the profiler:
        # enqueue time of back-to-back replays, then each replay's wall
        rows["cudaGraphLaunch (enqueue, 20 back to back)"] = C.host_us(
            prog.graph.graph.replay, 20)

        def replay_wall():
            prog.graph.graph.replay()
            torch.cuda.synchronize()

        rows["replay + synchronize"] = C.host_us(replay_wall, 20)
        rows["_run_decode (copies, replay, read-back)"] = C.host_us(
            lambda: eng._run_decode(1, tok, pt, lengths), 20)
    for k, us in rows.items():
        C.log(f"[ab host] llama_7b decode step, 4 slots: {k} {us:.1f} us")


def _run(args, env=None, timeout=900):
    cmd = [sys.executable, os.path.abspath(__file__)] + args
    print(f"[ab] $ {' '.join(args)}", flush=True)
    proc = subprocess.run(cmd, env=env, timeout=timeout)
    if proc.returncode:
        raise SystemExit(f"[ab] {args} exited {proc.returncode}")


def main(argv):
    if argv[:1] == ["--run"]:
        return run_tree(argv[1])
    if argv[:1] == ["--chunk"]:
        return run_chunk()
    if argv[:1] == ["--host-work"]:
        return run_host_work()
    parent = os.path.abspath(argv[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[ab] card: {smi.stdout.strip()}", flush=True)
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    f"{HERE!r}); import chip_smoke; chip_smoke.phase_build()"],
                   check=True, timeout=900)
    built = os.path.join(parent, "paddle_tpu_torch", "_build")
    os.makedirs(built, exist_ok=True)
    for so in glob.glob(os.path.join(HERE, "paddle_tpu_torch", "_build",
                                     "*.so")):
        shutil.copy(so, built)
    for tree in (parent, HERE, HERE, parent):
        _run(["--run", tree])
    if "--chunks" in argv:
        for n in (1, 4, 8):
            _run(["--chunk"], env=dict(os.environ,
                                       PADDLE_TPU_ENGINE_DECODE_CHUNK=str(n)))
        _run(["--host-work"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
