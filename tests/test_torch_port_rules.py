"""Rules of the PyTorch port (`paddle_tpu_torch`), checked on the CPU.

  * importing the port pulls in neither `jax` nor any `paddle_tpu`
    module (checked in a fresh interpreter and by scanning the imports
    of every module and of ``chip_smoke.py``);
  * the JAX-free modules the port copies equal their reference sources;
  * entry points run on the CUDA device by default and raise, naming
    ``device="cpu"``, on a host without CUDA; the serving fleet spawns
    the port's replica module, whose `gpt` replicas run on the card
    unless told otherwise;
  * a CUDA graph capture that fails raises through its timing
    (`core.graphs.capture`), which records nothing for it;
  * every kernel wrapper has a plain version and a launch counter, and
    only a CPU tensor reaches the plain version: the wrappers hold no
    try/except, the plain call sits under the CPU test, and a tensor on
    any other device raises instead of running it; the forward wrappers
    that are custom ops (``paddle_tpu_torch::<kernel>``, `_op.py`) call
    their op, whose CPU implementation registered with torch is the
    plain version and whose CUDA implementation never reaches one;
  * every wrapper takes float16 (its dtype table, and the source's
    `PT_F16` branch) and converts no input to another floating dtype on
    its way to the kernel;
  * attention's and rope's gradients on the card go through their
    kernels only, and every serving entry runs under
    ``torch.inference_mode()`` (the parameters are trainable, so serving
    must build no graph);
  * dropout and the train step's clipping: dropout is plain ops on every
    device (no try/except, no test of the device, no identity on CUDA),
    and nothing on the clipped step's path reads a device value back to
    the host;
  * the vision path: the fused conv reaches only the `conv_bn_act`
    wrapper (the kernel on CUDA), Swin's attention only the
    `window_attention` wrapper, which sends inputs that require grad
    through `WindowAttentionCore` before it could run anything;
    that function's forward and backward reach only the two window
    wrappers (the kernels on CUDA), never a plain version.
"""
from __future__ import annotations

import ast
import inspect
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _op

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                  "ml_dtypes")


def test_import_leaves_jax_and_paddle_tpu_out():
    code = textwrap.dedent("""
        import sys
        import paddle_tpu_torch
        import paddle_tpu_torch.incubate
        import paddle_tpu_torch.inference.engine
        import paddle_tpu_torch.models
        import paddle_tpu_torch.models.ernie
        import paddle_tpu_torch.nn.clip
        import paddle_tpu_torch.nn.layers_transformer
        import paddle_tpu_torch.ops.kernels
        import paddle_tpu_torch.observability
        import paddle_tpu_torch.optimizer.lr
        import paddle_tpu_torch.core.rng
        import paddle_tpu_torch.vision.models.vit
        import paddle_tpu_torch.inference.serving
        import paddle_tpu_torch.inference.router
        import paddle_tpu_torch.inference.fleet
        import paddle_tpu_torch.inference.autoscaler
        import paddle_tpu_torch.distributed.store
        import paddle_tpu_torch.distributed.fleet.elastic
        import paddle_tpu_torch.resilience
        import paddle_tpu_torch.resilience.watchdog
        import paddle_tpu_torch.distributed.recompute
        import paddle_tpu_torch.distributed.checkpoint
        import paddle_tpu_torch.observability.step_stats
        import paddle_tpu_torch.framework
        import paddle_tpu_torch.io
        import paddle_tpu_torch.io.shm_queue
        import paddle_tpu_torch.native
        import paddle_tpu_torch.metric
        import paddle_tpu_torch.hapi
        import paddle_tpu_torch.jit
        import paddle_tpu_torch.distributed.env
        import paddle_tpu_torch.static
        import paddle_tpu_torch.static.nn
        import paddle_tpu_torch.inference.capi_bridge
        import paddle_tpu_torch.native.capi
        import paddle_tpu_torch.ops
        import paddle_tpu_torch.linalg
        import paddle_tpu_torch.core.surface
        import paddle_tpu_torch.nn.layers_rnn
        import paddle_tpu_torch.nn.utils
        import paddle_tpu_torch.nn.quant
        paddle_tpu_torch.concat, paddle_tpu_torch.seed, paddle_tpu_torch.grad
        paddle_tpu_torch.Model, paddle_tpu_torch.save, paddle_tpu_torch.flops
        paddle_tpu_torch.enable_static, paddle_tpu_torch.in_dynamic_mode
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                            "ml_dtypes"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_paddle_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (
            f"{os.path.relpath(path, REPO)}:{node.lineno} imports {names}")


# JAX-free modules the port carries as copies: their code must not drift
# from the reference sources (comments and docstrings may differ)
COPIES = ["observability/metrics.py", "observability/trace.py",
          "observability/flight.py", "observability/tenant_ledger.py",
          "observability/timeseries.py", "inference/qos.py",
          "inference/engine/paging.py", "inference/engine/prefix.py",
          "inference/engine/scheduler.py",
          "resilience/overload.py", "resilience/retry.py",
          "resilience/faults.py", "resilience/preemption.py",
          "observability/lifecycle.py", "observability/request_trace.py",
          "observability/slo.py", "observability/export.py",
          "inference/router.py", "inference/autoscaler.py",
          "distributed/fleet/elastic.py", "resilience/watchdog.py",
          "distributed/checkpoint/metadata.py",
          "distributed/checkpoint/__init__.py",
          "observability/goodput.py",
          "io/dataset.py", "io/sampler.py", "hapi/callbacks.py",
          # the ring's C++ source and the C ABI's header, compared byte
          # for byte (capi.cc differs in its bridge module's name only:
          # test_capi_source_is_the_reference_but_the_bridge_name)
          "native/src/shm_ring.cc", "native/src/paddle_tpu_capi.h",
          # modules copied but for the top-level definitions named after
          # "-", which the port replaces with its own (torch in place of
          # jax, the CUDA allocator in place of PJRT's, the metadata
          # pickle's module names, bf16 as raw words): every other
          # function and class of the reference module is a copy
          "resilience/guards.py -tree_finite -tree_select",
          "observability/step_stats.py -_device_peak_bytes",
          "distributed/checkpoint/api.py -_proc_id -_np_dtype "
          "-_snapshot_host -load_state_dict -_owned_copy",
          # the rank and world size from torch.distributed, not jax; the
          # ring's workers spawned without the TPU environment, their
          # batches as torch tensors
          "distributed/env.py -get_rank -get_world_size",
          "io/shm_queue.py -run_process_workers -_to_numpy_tree "
          "-_from_numpy_tree",
          # the static and predictor modules: the defaults, the guard,
          # the scope, the pool and the constants are copies; the
          # Variable (a meta tensor), the recorded calls and their
          # replay, the predictor on its device, the bridge's bfloat16
          # words and its device knob are the port's own
          "static/framework.py -Variable -OpRecord -Program -data "
          "-InputSpec",
          "static/executor.py -_replay -_apply_grad_clip -_backward_reach "
          "-_build -Executor",
          "inference/__init__.py -Config -PredictorTensor -Predictor "
          "-convert_to_mixed_precision -get_version -XpuConfig",
          "inference/capi_bridge.py -create -_decode -_encode -run"]
# the port's train step carries these functions of the JAX module as
# copies
COPIED_DEFS = {"distributed/train_step.py": ("save_train_checkpoint",
                                             "load_train_checkpoint")}


def _code(path):
    """The module's AST with every docstring dropped, dumped."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _defs(path):
    """The module's top-level functions and classes by name, each
    dumped with its docstrings dropped."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if isinstance(body, list) and body \
                        and isinstance(body[0], ast.Expr) \
                        and isinstance(body[0].value, ast.Constant) \
                        and isinstance(body[0].value.value, str):
                    sub.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    rel, *skip = rel.split(" -")
    port, ref = os.path.join(PKG, rel), os.path.join(REPO, "paddle_tpu", rel)
    if not rel.endswith(".py"):
        with open(port, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), \
                f"paddle_tpu_torch/{rel} drifted from paddle_tpu/{rel}"
        return
    if not skip:
        assert _code(port) == _code(ref), \
            f"paddle_tpu_torch/{rel} drifted from paddle_tpu/{rel}"
        return
    mine, theirs = _defs(port), _defs(ref)
    assert set(skip) <= set(theirs), skip
    for name in sorted(set(theirs) - set(skip)):
        assert mine.get(name) == theirs[name], \
            f"paddle_tpu_torch/{rel}: {name} drifted from paddle_tpu/{rel}"


@pytest.mark.parametrize("rel", sorted(COPIED_DEFS))
def test_copied_functions_match_reference(rel):
    mine = _defs(os.path.join(PKG, rel))
    theirs = _defs(os.path.join(REPO, "paddle_tpu", rel))
    for name in COPIED_DEFS[rel]:
        assert mine[name] == theirs[name], \
            f"paddle_tpu_torch/{rel}: {name} drifted from paddle_tpu/{rel}"


@pytest.mark.parametrize("name,kw", [
    ("resnet18", dict(num_classes=10)),
    ("MobileNetV2", dict(scale=0.25, num_classes=10)),
    ("SwinTransformer", dict(img_size=56, embed_dim=24, depths=(2, 2),
                             num_heads=(1, 2), window_size=7,
                             num_classes=10)),
])
def test_vision_entry_points_default_to_cuda_in_eval_mode(name, kw):
    from paddle_tpu_torch.vision import models as V

    ctor = getattr(V, name)
    if torch.cuda.is_available():
        model = ctor(**kw)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ctor(**kw)
        model = ctor(**kw, device="cpu")
    assert not model.training and not any(m.training
                                          for m in model.modules())


def test_entry_points_default_to_cuda():
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    entries = [(GPTForCausalLM, GPTConfig(vocab_size=16, hidden_size=8,
                                          num_layers=1, num_heads=2,
                                          max_seq_len=8)),
               (LlamaForCausalLM, llama_tiny(vocab_size=16, hidden_size=8,
                                             num_layers=1, ffn_hidden=16))]
    for cls, cfg in entries:
        if torch.cuda.is_available():
            assert cls(cfg).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cls(cfg)
        assert cls(cfg, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(None)


def _nn_constructors():
    """One seeded construction of every parameterised `nn` layer class
    of the port (the ones that make a parameter or buffer)."""
    from paddle_tpu_torch import nn as tnn

    return {
        "Linear": lambda **kw: tnn.Linear(4, 8, bias_attr=False, **kw),
        "Embedding": lambda **kw: tnn.Embedding(10, 4, padding_idx=0, **kw),
        "Conv1D": lambda **kw: tnn.Conv1D(3, 4, 3, **kw),
        "Conv2D": lambda **kw: tnn.Conv2D(3, 4, 3, data_format="NHWC",
                                          **kw),
        "Conv3DTranspose": lambda **kw: tnn.Conv3DTranspose(2, 2, 2, **kw),
        "BatchNorm2D": lambda **kw: tnn.BatchNorm2D(
            4, use_global_stats=True, **kw),
        "GroupNorm": lambda **kw: tnn.GroupNorm(2, 4, **kw),
        "InstanceNorm2D": lambda **kw: tnn.InstanceNorm2D(4, **kw),
        "LayerNorm": lambda **kw: tnn.LayerNorm(8, **kw),
        "RMSNorm": lambda **kw: tnn.RMSNorm(8, **kw),
        "PReLU": lambda **kw: tnn.PReLU(4, **kw),
        "Bilinear": lambda **kw: tnn.Bilinear(2, 3, 4, **kw),
        "SpectralNorm": lambda **kw: tnn.SpectralNorm([4, 5], **kw),
        "HSigmoidLoss": lambda **kw: tnn.HSigmoidLoss(4, 6, **kw),
        "MultiHeadAttention": lambda **kw: tnn.MultiHeadAttention(8, 2,
                                                                  **kw),
        "Transformer": lambda **kw: tnn.Transformer(8, 2, 1, 1, 16, **kw),
        "LSTM": lambda **kw: tnn.LSTM(4, 8, 2, "bidirect", **kw),
        "GRUCell": lambda **kw: tnn.GRUCell(4, 8, **kw),
        "WeightOnlyLinear": lambda **kw: tnn.quant.WeightOnlyLinear(
            8, 4, **kw),
    }


@pytest.mark.parametrize("name", sorted(_nn_constructors()))
def test_nn_layers_default_to_cuda(name):
    """Every port layer targets the CUDA device unless told otherwise:
    on a host without it the constructor raises naming
    ``device="cpu"``, and builds on the CPU with ``device="cpu"`` or
    after ``set_device("cpu")`` (ROADMAP C2.35), which `get_device`
    reports back in Paddle's names."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.core import device as D

    make = _nn_constructors()[name]
    if torch.cuda.is_available():
        layer = make()
        assert all(t.device.type == "cuda" for t in layer.state_dict()
                   .values())
        return
    assert D.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    layer = make(device="cpu")
    assert isinstance(layer, tnn.Layer)
    assert all(t.device.type == "cpu" for t in layer.state_dict().values())
    prev = D._default
    try:
        assert D.set_device("cpu") == "cpu" and D.get_device() == "cpu"
        assert all(t.device.type == "cpu"
                   for t in make().state_dict().values())
        assert D.set_device("gpu:1") == "gpu:1"
        assert D.resolve_device("cpu").type == "cpu"
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    finally:
        D._default = prev
    import paddle_tpu_torch as PT

    assert PT.set_device is D.set_device and PT.get_device is D.get_device


def test_nn_modules_are_the_ported_files_only():
    """The layer surface's files import neither jax nor paddle_tpu (the
    package-wide rule above reads them too) and catch no exception:
    nothing falls back from a kernel to a plain version."""
    import paddle_tpu_torch.nn as tnn

    nn_dir = os.path.dirname(tnn.__file__)
    for root, _, files in os.walk(nn_dir):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(root, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    assert not (isinstance(node, ast.Try)
                                and node.handlers), fn
                    continue
                assert not any(n.split(".")[0] in ("jax", "paddle_tpu")
                               for n in names), (fn, names)


def _op_surface_files():
    ops_dir = os.path.join(PKG, "ops")
    return sorted([os.path.join(ops_dir, f) for f in os.listdir(ops_dir)
                   if f.endswith(".py") and f != "quant.py"]
                  + [os.path.join(PKG, "linalg.py"),
                     os.path.join(PKG, "core", "surface.py")])


@pytest.mark.parametrize("path", _op_surface_files(),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_op_surface_files_catch_no_exception(path):
    """The op surface's files (``ops/*.py``, ``linalg.py``,
    ``core/surface.py``) import neither jax nor paddle_tpu and catch no
    exception: no op falls back to another path."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.Try) and node.handlers), \
            f"{os.path.relpath(path, REPO)}:{node.lineno}"
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in ("jax", "paddle_tpu")
                       for n in names), (path, names)


def test_op_table_copy_matches_reference():
    """``ops/_op_table.py`` is the JAX module's data (PUBLIC_OPS,
    TENSOR_METHODS, GRAD_CHECKED, INPLACE_OPS) without its `validate()`,
    which imports the JAX package."""
    def assigns(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        return {t.id: ast.dump(node.value) for node in tree.body
                if isinstance(node, ast.Assign) for t in node.targets}

    mine = assigns(os.path.join(PKG, "ops", "_op_table.py"))
    theirs = assigns(os.path.join(REPO, "paddle_tpu", "ops", "_op_table.py"))
    assert set(mine) == set(theirs) == {"PUBLIC_OPS", "TENSOR_METHODS",
                                        "GRAD_CHECKED", "INPLACE_OPS"}
    for name in theirs:
        assert mine[name] == theirs[name], \
            f"paddle_tpu_torch/ops/_op_table.py: {name} drifted"


def test_file_and_loop_entry_points_default_to_cuda(tmp_path):
    """`DataLoader`, `load`, `jit.load` and `Model` (for a network
    without parameters) target the CUDA device unless told otherwise."""
    import paddle_tpu_torch as PT
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    ds = TensorDataset([np.arange(4, dtype=np.float32)])
    path = str(tmp_path / "m")
    net = torch.nn.Linear(2, 2)
    jit.save(net, path, input_spec=[torch.zeros(1, 2)])
    entries = [lambda **kw: DataLoader(ds, **kw).device,
               lambda **kw: next(iter(PT.load(path + ".pdparams",
                                              **kw).values())).device,
               lambda **kw: next(iter(jit.load(path, **kw)._state.values()))
               .device,
               lambda **kw: PT.Model(torch.nn.ReLU(), **kw).device]
    for entry in entries:
        if torch.cuda.is_available():
            assert entry().type == "cuda"
            continue
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry()
        assert entry(device="cpu").type == "cpu"
    assert PT.Model(net).device == next(net.parameters()).device


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_has_plain_version_counter_and_source(name):
    k = K.KERNELS[name]
    assert callable(getattr(k.module, k.wrapper))
    assert callable(getattr(k.module, k.plain))
    assert isinstance(getattr(k.module, k.counter), int)
    assert os.path.exists(os.path.join(REPO, k.source)), k.source
    with open(os.path.join(REPO, k.source)) as f:
        head = f.read(4000)
    # the source's note names the TPU kernel it replaces and its bound
    assert "Replaces:" in head and "Bound on this card" in head
    assert k.replaces.split(":")[0] in head
    # each kernel counts on a counter of its own
    assert sum(o.module is k.module and o.counter == k.counter
               for o in K.KERNELS.values()) == 1


def _translation_unit(name):
    """The code of ``csrc/<name>`` and of the csrc headers it includes,
    recursively, with comments stripped."""
    seen, parts = set(), []

    def add(fn):
        if fn in seen:
            return
        seen.add(fn)
        with open(os.path.join(PKG, "csrc", fn)) as f:
            text = f.read()
        for inc in re.findall(r'#include "([^"]+)"', text):
            add(inc)
        parts.append(re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S))

    add(name)
    return "\n".join(parts)


def _atomics_only_into_dbias(name, code):
    """The only atomic adds in the CUDA sources are flash_bwd.cu's dBias
    mode's into the bias gradient (`db*` pointers, ROADMAP C1.2): dQ,
    dK, dV and every other kernel's outputs rerun bit-identically."""
    targets = re.findall(r"atomic\w*\(\s*([^,]+),", code)
    assert code.count("atomic") == len(targets)
    assert all(t.startswith("db") for t in targets), targets
    assert (name == "flash_bwd.cu") == bool(targets)


@pytest.mark.parametrize("name", ["flash_fwd.cu", "flash_bwd.cu"])
def test_flash_sources_run_bf16_on_tensor_cores(name):
    """Every bf16 entry of the two flash sources reaches the tensor-core
    core (mma.sync on bf16 fragments, ldmatrix, cp.async staging): no
    bf16 instantiation of the scalar f32 kernels is left.  No atomics in
    dQ, dK or dV (reruns are bit-identical): the only atomic adds are the
    dBias mode's into the bias gradient (`db*` pointers, ROADMAP C1.2).
    No library kernel: the sources include only the CUDA toolkit's
    runtime and bf16 headers besides their own."""
    code = _translation_unit(name)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    # float16 (the dense modes) on the same tensor-core core
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in code
    assert "dispatch_tc<f16, true, false>" in code \
        and "dispatch_tc<f16, false, false>" in code
    assert "dispatch<__half" not in code and "launch<__half" not in code
    assert "cp.async.cg.shared.global" in code and "ldmatrix" in code
    assert "dispatch<__nv_bfloat16" not in code
    assert "launch<__nv_bfloat16" not in code
    assert code.count("dispatch_tc<") >= 3  # native / biased, packed, hm
    _atomics_only_into_dbias(name, code)
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


@pytest.mark.parametrize("name,entry,dispatch", [
    ("conv_bn_act.cu", "conv_dense_tc<",
     r"if constexpr \(sizeof\(T\) == 2\) \{[^}]*launch_tc<KH_, KW_>"),
    ("window_attention_bwd.cu", "window_attention_bwd_tc<",
     r"launch_tc<D, E>.*?if \(dtype == PT_BF16\)\s*return dispatch16<bf16>"),
])
def test_vision_sources_run_bf16_on_tensor_cores(name, entry, dispatch):
    """The bf16 dense conv and the bf16 window backward reach their
    tensor-core kernels (mma.sync on bf16 fragments, ldmatrix): the
    bf16 branch of each dispatch launches `launch_tc`, and the CUDA-core
    dense conv and window backward are instantiated for f32 only.  No
    atomics (reruns are bit-identical) and no library kernel."""
    code = _translation_unit(name)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    assert "ldmatrix" in code and entry in code
    assert re.search(dispatch, code, re.S), dispatch
    # the CUDA-core dense conv sits in the f32 branch only
    assert re.search(r"\} else \{[^}]*conv_dense_kernel<T, KH_, KW_>",
                     code) or name != "conv_bn_act.cu"
    assert "launch<__nv_bfloat16" not in code \
        or name == "conv_bn_act.cu"   # the conv's goes through launch_one
    _atomics_only_into_dbias(name, code)
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


@pytest.mark.parametrize("name,fast,general,dispatch", [
    # the bf16 (and f16) window forward: the tensor-core tile for the
    # windows it holds, the CUDA-core kernel for other 16-bit shapes and
    # for f32
    ("window_attention.cu", "window_attention_tc<",
     "window_attention_kernel<",
     r"if \(ws \* ws <= WF_T && hd <= 64 && "
     r"hd % 8 == 0 && tc_aligned\(qkv\) &&\s*tc_aligned\(out\)\) \{"
     r".*?launch_tc<D, E>.*?\}\s*return launch<E>.*?"
     r"if \(dtype == PT_BF16\)\s*return dispatch16<bf16>"),
    # the fused norm: rows held in registers when they are 16-byte
    # multiples at aligned pointers, the scalar kernel otherwise
    ("fused_norm.cu", "fused_norm_rows<", "fused_norm_kernel<",
     r"const bool vec = d % EPV == 0 && tc_aligned\(x\).*?if \(vec\) \{"
     r".*?launch_rows<T, W, R, N>.*?\}\s*if \(rms\)\s*return launch<"),
])
def test_redesigned_kernels_dispatch_by_shape(name, fast, general,
                                              dispatch):
    """The two kernels redesigned for this card keep their earlier kernel
    for what the new one cannot take, chosen by the C launcher from the
    shape and the pointers (a dispatch between two hand-written kernels,
    not a fallback to a plain version); the window forward's tile is on
    the tensor cores (mma.sync, ldmatrix, cp.async), the norm's rows move
    as 16-byte vectors.  No atomics and no library kernel."""
    code = _translation_unit(name)
    assert fast in code and general in code
    assert re.search(dispatch, code, re.S), dispatch
    if name == "window_attention.cu":
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
        assert "ldmatrix" in code and "cp.async.cg.shared.global" in code
    else:
        assert "uint4" in code and "extern __shared__ float zs[]" in code
    _atomics_only_into_dbias(name, code)
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


def _registered(op):
    """The Python functions torch runs for ``paddle_tpu_torch::<op>``:
    the dispatcher has kernels on the CPU and CUDA keys (and the fake
    one) and on no composite or autograd key that could take the call
    first; a call on CPU tensors runs the registered CPU function (read
    from the interpreter's call events) and never the CUDA one."""
    qual = f"{_op.NAMESPACE}::{op}"
    for key, want in (("CPU", True), ("CUDA", True), ("Meta", True),
                      ("CompositeImplicitAutograd", False),
                      ("CompositeExplicitAutograd", False),
                      ("Autograd", False), ("AutogradCUDA", False)):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key) \
            is want, (qual, key)
    calls = []

    def profile(frame, event, arg):
        if event == "call":
            calls.append(frame.f_code)

    args = _op_cases()[op][0]
    sys.setprofile(profile)
    try:
        getattr(torch.ops.paddle_tpu_torch, op).default(*args)
    finally:
        sys.setprofile(None)
    impls = _op.IMPLS[op]
    assert impls["cpu"].__code__ in calls
    assert impls["cuda"].__code__ not in calls
    return impls


def _plain_calls(fn, plain):
    """(call, enclosing nodes) of every call of `plain` in `fn`."""
    calls = []

    def visit(node, parents):
        if isinstance(node, ast.Call) and \
                ast.unparse(node.func).endswith(plain):
            calls.append((node, list(parents)))
        for child in ast.iter_child_nodes(node):
            visit(child, parents + [node])

    visit(fn, [])
    return calls


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_wrapper_reaches_plain_only_for_cpu(name):
    """A wrapper that launches through `ctypes` itself: every call of
    its plain version sits in the body of an `if <tensor>.device.type ==
    "cpu":` branch.  A wrapper that is a custom op: it calls no plain
    version, checks the device first, then calls its op; torch
    dispatches the op's CPU tensors to the implementation that is (or
    calls) the plain version and its CUDA tensors to the one that, with
    the module's helpers it calls, never reaches a plain version.  None
    of them catches and falls back."""
    k = K.KERNELS[name]
    plain = k.plain
    fn = ast.parse(textwrap.dedent(inspect.getsource(getattr(k.module,
                                                              k.wrapper))))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn)), \
        f"{k.wrapper} must not catch and fall back"
    if k.wrapper in _op.IMPLS:
        impls = _registered(k.wrapper)
        assert not _plain_calls(fn, "_reference"), k.wrapper
        body = fn.body[0].body
        calls = [ast.unparse(n) for n in body]
        check = next(i for i, c in enumerate(calls)
                     if "_op.check_device(" in c)
        call = next(i for i, c in enumerate(calls)
                    if f"_{k.wrapper}_op(" in c)
        assert check < call, calls
        cpu = impls["cpu"]
        assert cpu is getattr(k.module, plain) or _plain_calls(
            ast.parse(textwrap.dedent(inspect.getsource(cpu))), plain)
        for helper in _module_helpers(impls["cuda"], k.module):
            tree = ast.parse(textwrap.dedent(inspect.getsource(helper)))
            assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
            assert not _plain_calls(tree, "_reference"), helper.__name__
        return
    calls = _plain_calls(fn, plain)
    assert calls, f"{k.wrapper} never calls {plain}"
    for call, parents in calls:
        guards = [p for p in parents if isinstance(p, ast.If)
                  and any(call in ast.walk(s) for s in p.body)]
        assert guards and all("device.type == 'cpu'" in ast.unparse(g.test)
                              for g in guards), ast.unparse(call)


def _op_cases():
    """Small CPU arguments of each custom op, in its schema's order."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    cu = torch.tensor([0, 2, 6], dtype=torch.int32)
    return {
        "flash_fwd": [(r(1, 8, 2, 16), r(1, 8, 1, 16), r(1, 8, 1, 16),
                       None, True, False),
                      (r(1, 2, 8, 16), r(1, 8, 2, 16), r(1, 8, 2, 16),
                       None, False, True),
                      (r(2, 4, 2, 8), r(2, 6, 2, 8), r(2, 6, 2, 8),
                       torch.ones(2, 1, 1, 6, dtype=torch.bool), False,
                       False)],
        "rope": [(r(1, 8, 2, 16), r(1, 8, 1, 16), r(1, 8, 1, 16), False,
                  False, r(1, 8, 1, 16)),
                 (r(2, 4, 3, 8), r(1, 4, 1, 8), r(1, 4, 1, 8), True, True,
                  None)],
        "conv_bn_act": [(r(2, 4, 7, 7), r(8, 4, 3, 3), r(8), r(8), [2, 2],
                         [1, 1], "relu"),
                        (r(1, 4, 5, 5), r(4, 1, 3, 3), r(4), r(4), [1, 1],
                         [1, 1], None)],
        "window_attention": [(r(1, 4, 4, 24), r(2, 16, 16), None, 4, 0, 2),
                             (r(1, 8, 8, 24), r(2, 16, 16), r(4, 16, 16), 4,
                              2, 2)],
        "fused_norm": [(r(4, 8), r(8), None, None, r(4, 8), 1e-6, "rms"),
                       (r(3, 6), r(6), r(6), None, None, 1e-5, "ln")],
        "varlen_fwd": [(r(6, 2, 8), r(6, 2, 8), r(6, 2, 8), cu, cu, None,
                        True)],
    }


@pytest.mark.parametrize("name", sorted(_op.IMPLS))
def test_kernel_ops_trace_with_their_output_shapes(name):
    """Each custom op is ``paddle_tpu_torch::<name>``; its fake
    implementation gives the shapes and dtypes its CPU implementation
    returns (what `torch.export` traces is what runs); a CPU call counts
    no launch; its CUDA implementation adds one to a launch counter of
    its module, which is how a loaded program's launches are counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = getattr(torch.ops.paddle_tpu_torch, name).default
    assert op.name() == f"paddle_tpu_torch::{name}"
    K.reset_launches()
    for args in _op_cases()[name]:
        real = op(*args)
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in args])
        real = list(real) if isinstance(real, (list, tuple)) else [real]
        fake = list(fake) if isinstance(fake, (list, tuple)) else [fake]
        assert [(tuple(t.shape), t.dtype) for t in fake] == \
            [(tuple(t.shape), t.dtype) for t in real]
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
    src = inspect.getsource(_op.IMPLS[name]["cuda"])
    assert re.search(r"\b(bwd_)?launches \+= 1", src), src


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_wrapper_takes_float16(name):
    """Every kernel's wrapper lists float16 in its dtype table: a CUDA
    float16 tensor launches the kernel's own f16 instantiation (the C
    launchers' PT_F16 branch, dtype code 2) instead of raising.  The
    relayouts take no dtype code: they move 16-bit rows as bf16 rows,
    by width."""
    k = K.KERNELS[name]
    table = k.module._DTYPES
    assert torch.float16 in table, f"{k.module.__name__}._DTYPES"
    if isinstance(table, dict):
        assert table[torch.float16] == 2     # PT_F16 in csrc/common.cuh
        src = _translation_unit(os.path.basename(k.source))
        assert re.search(r"dtype == PT_F16\)", src), k.source


def _module_helpers(fn, module, seen=None):
    """`fn` and the functions of its own module that it calls, by name,
    recursively (the wrapper's checks and launch helpers)."""
    seen = [] if seen is None else seen
    if fn in seen:
        return seen
    seen.append(fn)
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            f = getattr(module, node.func.id, None)
            if inspect.isfunction(f) and f.__module__ == module.__name__ \
                    and not f.__name__.endswith("_reference"):
                _module_helpers(f, module, seen)
    return seen


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_wrapper_converts_no_cuda_tensor_before_its_launch(name):
    """No wrapper changes a tensor's floating dtype on its way to the
    kernel (no `.float()`, `.half()`, `.bfloat16()`, `.double()`, and no
    `.to(<dtype>)` of an input): a float16 input reaches an f16
    instantiation as float16 bits.  The one exception is an f32 operand
    by contract, the attention bias and the shift mask (`.to(torch.
    float32)`), which every dtype's kernel reads in f32.  The CPU branch
    (the plain version) is left out; for a custom op, its CUDA
    implementation and its helpers are read too."""
    k = K.KERNELS[name]
    fns = _module_helpers(getattr(k.module, k.wrapper), k.module)
    if k.wrapper in _op.IMPLS:     # and the op's CUDA implementation
        fns = _module_helpers(_op.IMPLS[k.wrapper]["cuda"], k.module, fns)
    for fn in fns:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):   # drop the plain versions' CPU branch
            if isinstance(node, ast.If) and \
                    "device.type == 'cpu'" in ast.unparse(node.test):
                node.body = [ast.Pass()]
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr, text = node.func.attr, ast.unparse(node)
            assert attr not in ("float", "half", "bfloat16", "double"), \
                f"{fn.__name__}: {text}"
            if attr == "to":
                receiver = ast.unparse(node.func.value)
                args = [ast.unparse(a) for a in node.args]
                # the dBias mode's f32 output, cast to the mask's dtype
                # after its launch
                if receiver.startswith("dbias.") and args == ["mask.dtype"]:
                    continue
                assert receiver in ("bias", "mask") and \
                    args == ["torch.float32"], f"{fn.__name__}: {text}"


def test_non_cpu_tensors_never_run_plain_versions():
    meta = dict(device="meta")
    q = torch.empty(1, 4, 2, 8, **meta)
    with pytest.raises(ValueError, match="device"):
        K.flash_attention.flash_fwd(q, q, q)
    lse = torch.empty(1, 2, 4, **meta)
    with pytest.raises(ValueError, match="device"):
        K.flash_attention.flash_bwd(q, q, q, q, lse, q)
    q3 = torch.empty(1, 2, 8, **meta)
    pools = torch.empty(2, 2, 4, 8, **meta)
    idx = torch.empty(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="device"):
        K.paged_attention.paged_attention(q3, pools, pools,
                                          idx.reshape(1, 1), idx)
    with pytest.raises(ValueError, match="device"):
        K.decode_attention.decode_attention(
            q3, torch.empty(1, 2, 8, 8, **meta),
            torch.empty(1, 2, 8, 8, **meta), idx)
    phases = torch.empty(1, 4, 1, 8, **meta)
    for adjoint in (False, True):
        with pytest.raises(ValueError, match="device"):
            K.rope.rope(q, phases, phases, adjoint=adjoint)
    x = torch.empty(1, 4, 6, 6, **meta)
    sc = torch.empty(8, **meta)
    with pytest.raises(ValueError, match="device"):
        K.conv_norm.conv_bn_act(x, torch.empty(8, 4, 3, 3, **meta), sc, sc)
    qkv, bias = torch.empty(1, 4, 4, 24, **meta), torch.empty(2, 16, 16,
                                                                **meta)
    with pytest.raises(ValueError, match="device"):
        K.window_attention.window_attention(qkv, bias, None, 4, 0, 2)
    with pytest.raises(ValueError, match="device"):
        K.window_attention.window_attention(
            qkv.requires_grad_(), bias, None, 4, 0, 2)
    with pytest.raises(ValueError, match="device"):
        K.window_attention.window_attention_bwd(
            qkv.detach(), bias, None, torch.empty(1, 4, 4, 8, **meta), 4, 0,
            2)
    codes = torch.empty(2, 2, 4, 16, dtype=torch.int8, **meta)
    scales = torch.empty(2, 2, 4, **meta)
    with pytest.raises(ValueError, match="device"):
        K.paged_attention.paged_attention(
            torch.empty(1, 2, 16, **meta), codes, codes, idx.reshape(1, 1),
            idx, k_scales=scales, v_scales=scales)
    for fn in (K.relayout.to_head_major, K.relayout.from_head_major):
        with pytest.raises(ValueError, match="device"):
            fn(q)
    with pytest.raises(ValueError, match="device"):
        K.flash_attention.flash_fwd(q, q, q, head_major=True)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_sdpa_routes_cuda_to_flash_kernel_only():
    from paddle_tpu_torch.nn.functional import attention as A

    fn = ast.parse(textwrap.dedent(
        inspect.getsource(A.scaled_dot_product_attention)))
    src = ast.unparse(fn)
    assert "_sdpa_ref" in src and "FlashAttention.apply" in src
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and any(
                "_sdpa_ref" in ast.unparse(s) for s in node.body):
            # the CPU route, or the math tier sdp_kernel chose
            test = ast.unparse(node.test)
            assert test == ("query.device.type == 'cpu' or not "
                            "_sdp_policy['flash']"), test
    # the port never calls PyTorch's own attention operator
    for path in _port_files():
        if path.endswith("chip_smoke.py"):
            continue  # times it as a yardstick (library_ms) only
        with open(path) as f:
            tree = ast.parse(f.read())
        torch_f = {"torch.nn.functional"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                torch_f |= {a.asname for a in node.names
                            if a.name == "torch.nn.functional" and a.asname}
            elif isinstance(node, ast.ImportFrom) and \
                    node.module == "torch.nn":
                torch_f |= {a.asname or a.name for a in node.names
                            if a.name == "functional"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr == "scaled_dot_product_attention":
                assert ast.unparse(node.value) not in torch_f, path


def test_flash_attention_backward_reaches_only_flash_bwd():
    """The autograd function's gradient runs the flash_bwd wrapper (the
    kernel on CUDA) and no plain version, with nothing caught."""
    fa = K.flash_attention
    for method, wrapper in ((fa.FlashAttention.forward, "flash_fwd"),
                            (fa.FlashAttention.backward, "flash_bwd")):
        fn = ast.parse(textwrap.dedent(inspect.getsource(method)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
        called = {ast.unparse(n.func) for n in ast.walk(fn)
                  if isinstance(n, ast.Call)}
        assert wrapper in called, called
        assert not any(c.endswith("_reference") or "_sdpa_ref" in c
                       for c in called), called


def test_flash_kv_tier_reaches_only_kernels():
    """The `kv` layout tier's autograd function: its forward runs the
    to-head-major relayout, the head-major flash forward and the relayout
    back; its backward the same with flash_bwd; the relayout functions'
    forward and backward run the relayout wrappers (the kernels on CUDA),
    each the other's adjoint.  No plain version, nothing caught."""
    fa, rl = K.flash_attention, K.relayout
    for method, want in (
            (fa.FlashAttentionKV.forward,
             {"to_head_major", "flash_fwd", "from_head_major"}),
            (fa.FlashAttentionKV.backward,
             {"to_head_major", "flash_bwd", "from_head_major"}),
            (rl.ToHeadMajor.forward, {"to_head_major"}),
            (rl.ToHeadMajor.backward, {"from_head_major"}),
            (rl.FromHeadMajor.forward, {"from_head_major"}),
            (rl.FromHeadMajor.backward, {"to_head_major"})):
        called = _calls(method)
        assert want <= called, (method, called)
        assert not any(c.endswith("_reference") or "_sdpa_ref" in c
                       for c in called), called
    src = inspect.getsource(fa.FlashAttentionKV)
    assert src.count("head_major=True") == 2


def test_rope_backward_reaches_only_the_kernel():
    """`RoPE`'s forward and backward each run the rope wrapper once (the
    kernel on CUDA; the backward with ``adjoint=True``), for q and k
    together (the second tensor rides the same call), and no plain
    version, with nothing caught.  The functional rotates every style
    through `RoPE`, q with k in one call; both model families rotate a
    layer's q and k through `rotate_qk`, one `RoPE` call."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.nn.functional import attention as A

    for method, adjoint, second in ((K.rope.RoPE.forward, False, "k"),
                                    (K.rope.RoPE.backward, True, "gk")):
        fn = ast.parse(textwrap.dedent(inspect.getsource(method)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        called = {ast.unparse(n.func) for n in calls}
        assert "rope" in called, called
        assert not any(c.endswith("_reference") for c in called), called
        ropes = [n for n in calls if ast.unparse(n.func) == "rope"]
        assert len(ropes) == 1, [ast.unparse(n) for n in ropes]
        kw = {k.arg: ast.unparse(k.value) for k in ropes[0].keywords}
        assert kw.get("adjoint") == ("True" if adjoint else None), kw
        assert kw.get("k") == second, kw
    src = inspect.getsource(A.fused_rotary_position_embedding)
    assert "RoPE.apply" in src and "_reference" not in src
    assert "q, k = RoPE.apply(q, cos, sin, interleaved, k)" in src
    assert "return RoPE.apply(q, cos, sin, False, k)" in inspect.getsource(
        A.rotate_qk)
    for attn in (L.LlamaAttention.forward, G.GPTAttention.forward):
        src = inspect.getsource(attn)
        assert src.count("F.rotate_qk(q, k, rope)") == 1, src
        assert "fused_rotary_position_embedding" not in src


def test_serving_entries_run_under_inference_mode():
    """generate(), the engine inline and the engine's loop thread run
    every model call with inference mode on: no autograd graph, though
    the parameters require grad.  Both families: GPT and LLaMA."""
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    gpt = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=16,
                                   num_layers=1, num_heads=2,
                                   max_seq_len=32), device="cpu")
    llama = LlamaForCausalLM(llama_tiny(vocab_size=64, hidden_size=16,
                                        num_layers=1, ffn_hidden=32,
                                        max_seq_len=32), device="cpu")
    for model, body in ((gpt, gpt.gpt), (llama, llama.model)):
        assert all(p.requires_grad for p in model.parameters())
        seen = []
        body.register_forward_hook(
            lambda mod, args, out, seen=seen: seen.append(
                (torch.is_inference_mode_enabled(),
                 torch.is_grad_enabled())))
        prompt = np.arange(5, dtype=np.int32)
        model.generate(prompt[None], max_new_tokens=3)
        eng = InferenceEngine(model, EngineConfig(page_size=4, max_slots=2,
                                                  max_seq_len=32))
        eng.generate([prompt], max_new_tokens=3)
        eng.start()
        try:
            assert len(eng.submit(prompt, max_new_tokens=3).result(
                timeout=60)) == 8
        finally:
            eng.stop()
        assert len(seen) >= 9
        assert all(s == (True, False) for s in seen), seen


def _calls(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    return {ast.unparse(n.func) for n in ast.walk(tree)
            if isinstance(n, ast.Call)}


def test_conv_bn_act_reaches_only_the_kernel():
    """The fused route of the vision models: `_fused.conv_bn_act` folds
    and calls `ConvBNAct.apply`, whose forward calls the wrapper (the
    kernel on CUDA) and no plain version; the backward is the plain
    version's autograd, as the JAX custom VJP's."""
    from paddle_tpu_torch.vision.models import _fused

    called = _calls(_fused.conv_bn_act)
    assert "ConvBNAct.apply" in called
    assert not any(c.endswith("_reference") for c in called), called
    fwd = _calls(K.conv_norm.ConvBNAct.forward)
    assert "conv_bn_act" in fwd
    assert not any(c.endswith("_reference") for c in fwd), fwd
    assert "conv_bn_act_reference" in _calls(
        K.conv_norm.ConvBNAct.backward)


def test_window_attention_refuses_grad_on_cuda_before_any_work():
    """Inputs that require grad leave the wrapper for the autograd
    function before any work: in the wrapper the device check comes
    first, then the grad check, whose branch returns
    `WindowAttentionCore.apply`, then the op; in the op's CUDA
    implementation the input checks come before the library.  The
    function's forward calls only the wrapper and its backward only
    `window_attention_bwd` (the kernels on CUDA), with nothing caught
    and no plain version; Swin's attention calls only the wrapper."""
    from paddle_tpu_torch.vision.models import swin

    wa = K.window_attention
    fn = ast.parse(textwrap.dedent(inspect.getsource(
        wa.window_attention))).body[0]
    stmts = [ast.unparse(n) for n in fn.body]
    tests = [ast.unparse(n.test) if isinstance(n, ast.If) else None
             for n in fn.body]
    dev = next(i for i, t in enumerate(stmts) if "check_device" in t)
    grad = next(i for i, t in enumerate(tests) if t and "requires_grad" in t)
    op = next(i for i, t in enumerate(stmts)
              if "_window_attention_op(" in t)
    assert dev < grad < op
    routed = fn.body[grad].body[0]
    assert isinstance(routed, ast.Return) and \
        ast.unparse(routed.value.func) == "WindowAttentionCore.apply"
    cuda = ast.parse(textwrap.dedent(inspect.getsource(
        _op.IMPLS["window_attention"]["cuda"]))).body[0]
    work = next(i for i, n in enumerate(cuda.body)
                if "_checked" in ast.unparse(n))
    lib = next(i for i, n in enumerate(cuda.body)
               if "_build.library" in ast.unparse(n))
    assert work < lib
    for method, wrapper in ((wa.WindowAttentionCore.forward,
                             "window_attention"),
                            (wa.WindowAttentionCore.backward,
                             "window_attention_bwd")):
        called = _calls(method)
        assert wrapper in called, called
        assert not any(c.endswith("_reference") for c in called), called
    called = _calls(swin.WindowAttention.forward)
    assert "window_attention" in called
    assert not any(c.endswith("_reference") for c in called), called


def test_new_wrappers_refuse_non_cpu_tensors():
    """The packed-attention and fused-norm wrappers: a tensor on any
    device but the CPU raises before any work, and nothing counts."""
    meta = dict(device="meta")
    q = torch.empty(6, 2, 8, **meta)
    cu = torch.empty(3, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="device"):
        K.varlen_attention.varlen_fwd(q, q, q, cu, cu)
    with pytest.raises(ValueError, match="device"):
        K.varlen_attention.varlen_bwd(q, q, q, q, torch.empty(2, 6, **meta),
                                      q, cu, cu)
    with pytest.raises(ValueError, match="device"):
        K.fused_norm.fused_norm(torch.empty(4, 8, **meta))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_varlen_and_fused_norm_autograd_reach_only_their_wrappers():
    """`VarlenAttention` runs `varlen_fwd` forward and `varlen_bwd`
    backward (the kernels on CUDA), `FusedNorm` runs `fused_norm`
    forward; nothing caught, no plain version called.  The entry points
    go through these functions only."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn.functional import attention as A

    va = K.varlen_attention
    for method, wrapper in ((va.VarlenAttention.forward, "varlen_fwd"),
                            (va.VarlenAttention.backward, "varlen_bwd"),
                            (K.fused_norm.FusedNorm.forward, "fused_norm")):
        called = _calls(method)
        assert wrapper in called, called
        assert not any(c.endswith("_reference") for c in called), called
    assert "VarlenAttention.apply" in _calls(A.flash_attn_unpadded)
    for fn in (IF.fused_rms_norm, IF.fused_layer_norm):
        called = _calls(fn)
        assert "FusedNorm.apply" in called
        assert not any(c.endswith("_reference") for c in called), called


def test_masked_mha_reaches_only_decode_attention_on_kernel_shapes():
    """A `masked_multihead_attention` with no mask and a shape the kernel
    takes calls `decode_attention` (the kernel on CUDA) and returns: the
    branch holds that one call, its test is JAX's condition, nothing is
    caught.  On a tensor that is not on the CPU the call reaches the
    wrapper's device check: the plain version never runs."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    fn = ast.parse(textwrap.dedent(
        inspect.getsource(IF.masked_multihead_attention)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    branches = [n for n in ast.walk(fn) if isinstance(n, ast.If) and any(
        "decode_attention(" in ast.unparse(s) for s in n.body)]
    assert len(branches) == 1
    test = ast.unparse(branches[0].test)
    assert test == "src_mask is None and decode_kernel_takes(cache_kv.shape)"
    called = {ast.unparse(c.func) for s in branches[0].body
              for c in ast.walk(s) if isinstance(c, ast.Call)}
    assert called <= {"decode_attention", "q.contiguous", "out.reshape"}, \
        called
    assert isinstance(branches[0].body[-1], ast.Return)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="decode_attention: unsupported "
                       "device meta"):
        IF.masked_multihead_attention(
            torch.empty(2, 3 * 4 * 16, **meta),
            cache_kv=torch.empty(2, 2, 4, 32, 16, **meta),
            sequence_lengths=torch.zeros(2, dtype=torch.int32, **meta))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_varlen_mem_eff_reaches_only_flash_attention():
    """`variable_length_memory_efficient_attention` runs
    `FlashAttention.apply` (the biased flash kernels on CUDA) on every
    device, with no plain attention of its own, no branch on the device
    and nothing caught; a tensor that is not on the CPU reaches the
    flash wrapper's device check."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    fn = IF.variable_length_memory_efficient_attention
    called = _calls(fn)
    assert "FlashAttention.apply" in called
    assert not any(c.endswith("_reference") or "_sdpa_ref" in c
                   or c.startswith("torch.softmax") or "einsum" in c
                   for c in called), called
    assert "device.type" not in inspect.getsource(fn)
    meta = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="flash_fwd: unsupported device"):
        fn(meta, meta, meta, kv_seq_lens=torch.ones(1, device="meta"))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("wrapper", ["decode_attention", "paged_attention"])
def test_decode_wrappers_take_any_gqa_group(wrapper):
    """The kernels split a GQA group into chunks of at most 8 query heads
    (a grid dimension), so the wrappers compare the group against no
    bound: the `> 8` refusal is gone."""
    fn = getattr(getattr(K, wrapper), wrapper)
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            assert "hq // hkv" not in ast.unparse(node), ast.unparse(node)


@pytest.mark.parametrize("name,kernel", [
    ("paged_attention.cu", "paged_attention_kernel<T, CHP, GM>"),
    ("decode_attention.cu", "decode_attention_kernel<T, CHP, GM>"),
])
def test_exact_decode_kernels_split_keys_across_a_cluster(name, kernel):
    """Both KV tiers' decode kernels run the one core `decode_split`: K /
    V rows copied 16 bytes a lane (`cp.async` into a ring of
    shared-memory tiles, read back as 16-byte vectors), one launch on
    clusters of DEC_SPLIT CTAs whose partials rank 0 merges through
    distributed shared memory, between the core's two cluster barriers.
    The split is a plain compile-time constant, never derived from the
    batch: the grid is Hkv x DEC_SPLIT along x.  The exact tier calls the
    core with KV = T; the int8 tier (the paged source only) with KV =
    int8_t, its codes copied as the exact rows are, and its scales four
    rows a 16-byte copy where the launcher finds PS % 4 == 0 and aligned
    tables, else 4 bytes a row.  The old cores are gone: the 2-byte-lane
    exact core and the int8 tier's block-per-head kernel
    (`decode_rows_q8`).  No atomics, no library kernel, only the
    toolkit's headers."""
    code = _translation_unit(name)
    paged = name == "paged_attention.cu"
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in code
    assert "reinterpret_cast<const uint4*>" in code
    assert f"decode_cluster_launch(\n      {kernel}" in code
    assert "cudaLaunchAttributeClusterDimension" in code
    assert "attr[0].val.clusterDim.x = DEC_SPLIT;" in code
    assert "cudaLaunchKernelEx" in code
    assert "mapa.shared::cluster.u32" in code
    assert "ld.shared::cluster.f32" in code
    # one core for both tiers, with exactly two cluster barriers
    assert code.count("dec_cluster_sync();") == 2
    assert code.count("__device__ __forceinline__ void decode_split(") == 1
    assert re.search(r"decode_split<T, T, CHP, GM>\(q \+ qo, k\w, v\w, "
                     r"nullptr, nullptr, false, rows,", code)
    split = re.findall(r"constexpr int DEC_SPLIT = (\w+);", code)
    assert split in (["2"], ["4"], ["8"]), split
    assert code.count("dim3(Hkv * DEC_SPLIT, B, decode_chunks(group))") \
        == (2 if paged else 1)
    assert not re.search(r"DEC_SPLIT\s*=|#\s*define\s+DEC_SPLIT",
                         code.replace("constexpr int DEC_SPLIT = "
                                      f"{split[0]};", ""))
    assert "decode_rows" not in code and "pt_nj(D)" not in code
    assert "DEC_WARPS" not in code and "paged_attention_q8_kernel" not in code
    # the int8 tier: the same cluster launch and core over int8 codes
    assert ("decode_cluster_launch(\n      paged_attention_int8_kernel<T, "
            "CHP, GM>" in code) == paged
    assert bool(re.search(r"decode_split<T, int8_t, CHP, GM>\(q \+ qo, kp, "
                          r"vp, ks, vs, scales16 != 0,", code)) == paged
    assert ("__launch_bounds__(DEC_THREADS, GM == 1 ? DEC_Q8_MIN_CTAS : 1)\n"
            "    paged_attention_int8_kernel(" in code) == paged
    assert ("const int v16 = PS % 4 == 0 && tc_aligned(ks) && "
            "tc_aligned(vs);" in code) == paged
    # its rows through the exact tier's 16-byte copy, its scales in the
    # same ring stage: 16 bytes for four rows, else 4 bytes a row
    assert "dec_cp16(dst, kb + off, ok);" in code
    assert "dec_cp16(dst, ks + ri, ok);" in code
    assert "dec_cp16(dst + L::TK * 4, vs + ri, ok);" in code
    assert "cp.async.ca.shared.global [%0], [%1], 4, %2;" in code
    assert "if (cc == 0 && (!scales16 || row % 4 == 0)) {" in code
    # int8 codes read 8 a lane, turned into f32 by a byte permute and an
    # add (no integer-to-float conversion), the key's scales applied to
    # its score and its weight
    assert code.count("dec_codes8(src, ") == 2
    assert "static constexpr int RB = sizeof(T) == 1 ? 8 : 16;" in code
    assert "__byte_perm(word[i], 0x4B000000u," in code
    assert "if constexpr (Q8) dot *= kst[row];" in code
    assert "const float pv = Q8 ? p * vsc : p;" in code
    _atomics_only_into_dbias(name, code)
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


_HOST_READS = ("item", "tolist", "cpu", "numpy")


def _host_reads(fn):
    """The calls in `fn` that read a tensor back to the host: `.item()`,
    `.tolist()`, `.cpu()`, `.numpy()`, and `float` / `int` / `bool` of a
    value; a `torch.tensor(...)` made on the host and read there is
    left out."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
            recv = ast.unparse(f.value)
            if recv.startswith("torch.tensor(") and "device" not in recv:
                continue
            out.append(ast.unparse(node))
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and node.args and not isinstance(node.args[0], ast.Constant):
            out.append(ast.unparse(node))
    return out


def test_dropout_is_plain_ops_on_every_device():
    """The JAX package computes dropout outside Pallas, and so does the
    port, on the CPU and the card alike: no try/except, no branch on the
    device (which could turn into the identity on CUDA), the mask drawn
    from `core.rng`'s generator of the tensor's device, and no host read
    of a device value (a CUDA graph replays it)."""
    from paddle_tpu_torch.nn import layers_common as LC
    from paddle_tpu_torch.nn.functional import common as C

    for fn in (C.dropout, C.alpha_dropout, C._keep, C.dropout2d,
               C.dropout3d, LC.Dropout.forward, LC.Dropout2D.forward,
               LC.Dropout3D.forward):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        text = ast.unparse(tree)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn
        assert "device.type" not in text and "is_cuda" not in text, fn
        assert "NotImplementedError" not in text, fn
        assert not _host_reads(fn), (fn, _host_reads(fn))
    assert "generator=rng.generator(x.device)" in inspect.getsource(C._keep)


def test_clipped_train_step_reads_nothing_back_to_the_host():
    """`grad_clip_norm` stays on the device: the step body, the norm and
    the scale hold no host read, and the scale is a tensor (a `min` on
    the device, no Python branch on the norm)."""
    from paddle_tpu_torch.distributed import train_step as TS
    from paddle_tpu_torch.nn import clip

    for fn in (TS.DistributedTrainStep._step, clip.global_norm_sq,
               clip.global_norm_scale):
        assert not _host_reads(fn), (fn, _host_reads(fn))
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, (ast.If, ast.IfExp)) and
                       "gsq" in ast.unparse(n.test) for n in ast.walk(tree))
    src = inspect.getsource(TS.DistributedTrainStep._step)
    assert "global_norm_scale(" in src and "global_norm_sq(" in src
    assert "grad_clip_norm" not in TS._UNPORTED
    gsq = clip.global_norm_sq([torch.ones(3), torch.ones(2, 2)])
    scale = clip.global_norm_scale(gsq, 1.0)
    assert isinstance(scale, torch.Tensor) and scale.dim() == 0
    assert torch.allclose(scale, torch.tensor(1 / 7 ** 0.5))


def test_fleet_replicas_run_the_port_on_the_card_by_default(tmp_path,
                                                           monkeypatch):
    """The fleet spawns the port's replica module, whose `--device`
    defaults to cuda; a `gpt` fleet resolves its device at construction
    and, on a host without CUDA, raises naming device="cpu"."""
    from paddle_tpu_torch.inference import fleet as FL

    fleet = FL.ReplicaFleet(num_replicas=1, kind="echo", heartbeat=False,
                            workdir=str(tmp_path))
    handle = fleet._handles[0]
    handle.announce = str(tmp_path / "r0.addr")
    cmd = fleet._replica_cmd(handle)
    assert cmd[1:3] == ["-m", "paddle_tpu_torch.inference.fleet"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert "JAX_PLATFORMS" not in fleet._replica_environ(handle)
    args = FL._replica_parser().parse_args(
        ["--replica", "--rank", "0", "--announce", "a", "--kind", "gpt"])
    assert args.device == "cuda"
    fleet.router._httpd.server_close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            FL.ReplicaFleet(num_replicas=1, kind="gpt", heartbeat=False)
        ok = FL.ReplicaFleet(num_replicas=1, kind="gpt", device="cpu",
                             heartbeat=False)
        assert ok.device == "cpu"
        ok.router._httpd.server_close()


def test_a_failed_capture_raises_through_its_timing(monkeypatch):
    """`core.graphs.capture` times the warm-up and the capture, and a
    capture that fails raises through the timing: nothing catches it,
    nothing is recorded for it, and the span it opened is closed."""
    from paddle_tpu_torch.core import graphs as GR
    from paddle_tpu_torch.observability import capture_cost as CC
    from paddle_tpu_torch.observability import lifecycle, trace

    class Boom(RuntimeError):
        pass

    def failing_graph(body, stream, pool=None, generators=()):
        raise Boom("operation not permitted when stream is capturing")

    monkeypatch.setattr(GR, "warm_up", lambda body, stream: body())
    monkeypatch.setattr(GR, "Graph", failing_graph)
    lifecycle.reset()
    trace.enable()
    try:
        with pytest.raises(Boom):
            GR.capture(lambda: 1, "stream", "decode_n1")
        assert lifecycle.get_ledger().record()["compiles"] == {}
        assert trace.current_span() is None
        assert not any(isinstance(n, ast.Try) for n in ast.walk(
            ast.parse(inspect.getsource(CC))))
        # a capture that succeeds records under its label
        monkeypatch.setattr(GR, "Graph", lambda body, stream, pool=None,
                            generators=(): "graph")
        assert GR.capture(lambda: 7, "stream", "decode_n1") == (7, "graph")
        assert lifecycle.get_ledger().record()["compiles"]["decode_n1"][
            "count"] == 1
    finally:
        trace.disable()
        lifecycle.reset()


# ------------------------------------------------ static programs (PR 25)
def test_capi_source_is_the_reference_but_the_bridge_name():
    with open(os.path.join(REPO, "paddle_tpu", "native", "src",
                           "capi.cc")) as f:
        ref = f.read()
    with open(os.path.join(PKG, "native", "src", "capi.cc")) as f:
        mine = f.read()
    assert "paddle_tpu.inference.capi_bridge" in ref
    assert mine == ref.replace("paddle_tpu.inference.capi_bridge",
                               "paddle_tpu_torch.inference.capi_bridge")


def test_saved_model_entry_points_default_to_cuda(tmp_path):
    """`inference.Config()`, `static.Executor()`, `load_inference_model`,
    `create_predictor`, `InferenceServer(model_path=)`, the `static.nn`
    builders and `ReplicaFleet(kind="model")` target the CUDA device
    unless told otherwise; a `model` replica's `--device` defaults to
    cuda."""
    import paddle_tpu_torch as PT
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch import static
    from paddle_tpu_torch.inference import fleet as FL
    from paddle_tpu_torch.inference import serving as S

    prefix = str(tmp_path / "m")
    static.reset_default_programs()
    PT.enable_static()
    try:
        x = static.data("x", [-1, 2], "float32")
        static.save_inference_model(prefix, [x], [x * 2])
    finally:
        PT.disable_static()
        static.reset_default_programs()
    args = FL._replica_parser().parse_args(
        ["--replica", "--rank", "0", "--announce", "a", "--kind", "model"])
    assert args.device == "cuda"
    assert TI.Config(prefix).use_gpu()
    if torch.cuda.is_available():
        assert TI.Config(prefix).device().type == "cuda"
        assert static.Executor().device.type == "cuda"
        return
    entries = [lambda: TI.Config(prefix).device(),
               lambda: static.Executor(),
               lambda: static.load_inference_model(prefix),
               lambda: TI.create_predictor(TI.Config(prefix)),
               lambda: S.InferenceServer(model_path=prefix),
               lambda: static.create_parameter([2], "float32"),
               lambda: FL.ReplicaFleet(num_replicas=1, kind="model",
                                       model_path=prefix, heartbeat=False)]
    for entry in entries:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry()
    assert static.Executor("cpu").device.type == "cpu"
    assert static.Executor(static.cpu_places()).device.type == "cpu"
    ok = FL.ReplicaFleet(num_replicas=1, kind="model", model_path=prefix,
                         device="cpu", heartbeat=False)
    assert ok.device == "cpu"
    ok.router._httpd.server_close()


def _recorded_gpt_and_resnet():
    """The recorded programs of a tiny GPT and a small ResNet (the fused
    conv route), and the launch counts the recording left."""
    import paddle_tpu_torch as PT
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.vision import models as TV

    gpt = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=16,
                                   num_layers=2, num_heads=2,
                                   max_seq_len=16), device="cpu")
    res = TV.resnet18(num_classes=4, device="cpu")
    K.reset_launches()
    progs = []
    PT.enable_static()
    try:
        for build in (lambda: gpt(static.data("ids", [2, 8], "int64")),
                      lambda: res(static.data("img", [-1, 3, 16, 16],
                                              "float32"))):
            prog = static.Program()
            with static.program_guard(prog):
                progs.append((prog, build()))
    finally:
        PT.disable_static()
    return progs, K.launch_counts()


def test_recording_counts_no_launch_and_records_the_ops():
    """A Program records the kernels at their op boundary: the GPT's
    attention as ``paddle_tpu_torch::flash_fwd`` (one a layer), the fused
    convs as ``paddle_tpu_torch::conv_bn_act``, never a plain version
    (`flash_fwd_reference`, `_sdpa_ref`'s einsum, `conv_bn_act_reference`);
    recording runs and counts no kernel."""
    from paddle_tpu_torch.nn.functional import attention as A

    progs, counts = _recorded_gpt_and_resnet()
    assert counts == {k: 0 for k in K.KERNELS}
    plain = {K.flash_attention.flash_fwd_reference, A._sdpa_ref,
             K.conv_norm.conv_bn_act_reference, torch.einsum}
    flash = torch.ops.paddle_tpu_torch.flash_fwd.default
    conv = torch.ops.paddle_tpu_torch.conv_bn_act.default
    (gpt, _), (res, _) = progs
    assert [op.fn for op in gpt.ops].count(flash) == 2
    # ResNet-18: the stem and two convs in each of its eight blocks
    assert [op.fn for op in res.ops].count(conv) == 1 + 8 * 2
    for prog in (gpt, res):
        assert not plain & {op.fn for op in prog.ops}
        assert not any("einsum" in op.name for op in prog.ops)


def test_static_replays_reach_the_ops_only(tmp_path):
    """On a CUDA tensor the Executor's and the Predictor's replays reach
    the ``paddle_tpu_torch::`` ops and never a plain version: a replay
    calls the recorded functions (the ops, whose CUDA implementation
    launches the kernel or raises), the saved program holds the ops as
    nodes, and the replay paths hold no try/except and no test of the
    device beyond the CPU's eager branch."""
    import paddle_tpu_torch as PT
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import executor as EX
    from paddle_tpu_torch.static import io as SIO

    progs, _ = _recorded_gpt_and_resnet()
    for (prog, out), op in zip(progs, ("flash_fwd", "conv_bn_act")):
        prefix = str(tmp_path / op)
        PT.enable_static()
        try:
            with static.program_guard(prog):
                static.save_inference_model(
                    prefix, list(prog.feed_vars.values()), [out],
                    program=prog)
        finally:
            PT.disable_static()
        loaded, _, _ = static.load_inference_model(prefix, device="cpu")
        targets = {str(n.target) for n in loaded.exported.graph.nodes}
        assert f"paddle_tpu_torch.{op}.default" in targets
        assert not any("einsum" in t for t in targets)
    for fn in (EX.Executor._run_at, EX._build, EX._replay,
               SIO._ExportedInferenceProgram.run_tensors,
               SIO._ExportedInferenceProgram.call, TI.Predictor.run):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn
        assert "reference" not in ast.unparse(tree), fn
