"""The port's train step with dropout, recompute and the guard off, on
one tree: GPT-125M as `chip_smoke.py`'s phase 8 (bf16 O2, B8 x 1024,
AdamW 1e-4) and at 2 layers in f32 (B2 x 256) with AdamW, Adam and
Momentum (weight decay 0.01 as an L2 term for the last two), 2 calls
then `run_steps(repeat=5)`: the losses as hex floats, a sha256 of every
tensor the step holds (parameters, slots, step, rate, buffers) after the
steps, the graphs and the launches; and the serving path: greedy
`generate()` of the 2-layer model in bf16 (32 new tokens on 2 prompts of
64) and its launches.  Run it on two trees in turns in one chip call
and compare the JSON files: equal hashes and tokens mean bit-identical
training and serving.

    cd _tree_check
    python3 ../tools/train_step_ab.py PARENT_TREE parent.json
    python3 ../tools/train_step_ab.py CHANGE_TREE change.json

TREE is a directory holding a `chip_smoke.py` and its `paddle_tpu_torch`
(`git archive REV | tar -x -C TREE`).  It needs one CUDA card."""
import hashlib
import json
import os
import sys

tree, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(tree))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from paddle_tpu_torch.distributed import build_train_step  # noqa: E402
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTForCausalLM, GPTPretrainingCriterion,
)
from paddle_tpu_torch.ops import kernels as K  # noqa: E402
from paddle_tpu_torch.optimizer import Adam, Momentum  # noqa: E402

assert C.__file__.startswith(os.path.abspath(tree)), C.__file__
res = {}
for name, layers, amp, batch, seq, opt in (
        ("phase8_bf16", 12, "bfloat16", 8, 1024, None),
        ("f32_2L", 2, None, 2, 256, None),
        ("f32_2L_adam", 2, None, 2, 256,
         lambda: Adam(learning_rate=1e-4, weight_decay=0.01)),
        ("f32_2L_momentum", 2, None, 2, 256,
         lambda: Momentum(learning_rate=1e-3, weight_decay=0.01))):
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPTForCausalLM(C._gpt125m(layers), device="cuda", seed=0)
    if opt is None:
        step = C._train_step(model, amp_dtype=amp)
    else:
        step = build_train_step(model, opt(),
                                GPTPretrainingCriterion(model=model))
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, 50304, (batch, seq))
                                    .astype(np.int32)).cuda()
                   for _ in range(2))
    K.reset_launches()
    losses = [step(ids, labels) for _ in range(2)]
    losses += list(step.run_steps(ids, labels, repeat=5))
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in step._state_tensors():
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes() if t.dim() else t.detach().reshape(1)
                 .view(torch.uint8).cpu().numpy().tobytes())
    res[name] = {"losses": [float(x).hex() for x in losses],
                 "state_sha256": h.hexdigest(),
                 "n_state": len(step._state_tensors()),
                 "graphs": len(step._graphs),
                 "launches": {k: v for k, v in K.launch_counts().items() if v}}
    del step, model
    torch.cuda.empty_cache()
model = GPTForCausalLM(C._gpt125m(2), device="cuda", dtype=torch.bfloat16,
                       seed=0)
prompts = torch.from_numpy(np.random.RandomState(1).randint(
    0, 50304, (2, 64)).astype(np.int32)).cuda()
K.reset_launches()
with torch.inference_mode():
    toks = model.generate(prompts, max_new_tokens=32)
res["serve_generate"] = {
    "tokens": toks.cpu().numpy().tolist(),
    "launches": {k: v for k, v in K.launch_counts().items() if v}}
with open(out, "w") as f:
    json.dump(res, f, indent=1)
print(json.dumps(res))
