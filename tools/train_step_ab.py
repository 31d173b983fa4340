"""The port's train step with dropout, recompute and the guard off, on
one tree: GPT-125M as `chip_smoke.py`'s phase 8 (bf16 O2, B8 x 1024,
AdamW 1e-4) and at 2 layers in f32 (B2 x 256), 2 calls then
`run_steps(repeat=5)`: the losses as hex floats, a sha256 of every
tensor the step holds (parameters, slots, step, rate, buffers) after the
steps, the graphs and the launches.  Run it on two trees in turns in one
chip call and compare the JSON files: equal hashes mean bit-identical
training.

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
from paddle_tpu_torch.models.gpt import GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.ops import kernels as K  # noqa: E402

assert C.__file__.startswith(os.path.abspath(tree)), C.__file__
res = {}
for name, layers, amp, batch, seq in (("phase8_bf16", 12, "bfloat16", 8, 1024),
                                       ("f32_2L", 2, None, 2, 256)):
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPTForCausalLM(C._gpt125m(layers), device="cuda", seed=0)
    step = C._train_step(model, amp_dtype=amp)
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
with open(out, "w") as f:
    json.dump(res, f, indent=1)
print(json.dumps(res))
