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
    any other device raises instead of running it;
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
    `window_attention` wrapper, which on CUDA sends inputs that require
    grad through `WindowAttentionCore` before it could run anything;
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


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
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
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
          "distributed/fleet/elastic.py"]


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


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert _code(os.path.join(PKG, rel)) == \
        _code(os.path.join(REPO, "paddle_tpu", rel)), \
        f"paddle_tpu_torch/{rel} drifted from paddle_tpu/{rel}"


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


@pytest.mark.parametrize("name", ["flash_fwd.cu", "flash_bwd.cu"])
def test_flash_sources_run_bf16_on_tensor_cores(name):
    """Every bf16 entry of the two flash sources reaches the tensor-core
    core (mma.sync on bf16 fragments, ldmatrix, cp.async staging): no
    bf16 instantiation of the scalar f32 kernels is left.  No atomics
    (reruns are bit-identical) and no library kernel: the sources include
    only the CUDA toolkit's runtime and bf16 headers besides their own."""
    code = _translation_unit(name)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    assert "cp.async.cg.shared.global" in code and "ldmatrix" in code
    assert "dispatch<__nv_bfloat16" not in code
    assert "launch<__nv_bfloat16" not in code
    assert code.count("dispatch_tc<") >= 3  # native / biased, packed, hm
    assert "atomic" not in code
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


@pytest.mark.parametrize("name,entry,dispatch", [
    ("conv_bn_act.cu", "conv_dense_tc<",
     r"if constexpr \(sizeof\(T\) == 2\) \{[^}]*launch_tc<KH_, KW_>"),
    ("window_attention_bwd.cu", "window_attention_bwd_tc<",
     r"if \(dtype == PT_BF16\) \{[^}]*launch_tc<D>"),
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
    assert "atomic" not in code
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


@pytest.mark.parametrize("name,fast,general,dispatch", [
    # the bf16 window forward: the tensor-core tile for the windows it
    # holds, the CUDA-core kernel for other bf16 shapes and for f32
    ("window_attention.cu", "window_attention_tc<",
     "window_attention_kernel<",
     r"if \(dtype == PT_BF16\) \{.*?if \(ws \* ws <= WF_T && hd <= 64 && "
     r"hd % 8 == 0 && tc_aligned\(qkv\) &&\s*tc_aligned\(out\)\) \{"
     r".*?launch_tc<D>.*?\}\s*return launch<__nv_bfloat16>"),
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
    assert "atomic" not in code
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|scaled_dot_product",
                         code, re.I)


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_wrapper_reaches_plain_only_for_cpu(name):
    k = K.KERNELS[name]
    plain = k.plain
    fn = ast.parse(textwrap.dedent(inspect.getsource(getattr(k.module,
                                                              k.wrapper))))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn)), \
        f"{k.wrapper} must not catch and fall back"
    # every call of the plain version sits in the body of an
    # `if <tensor>.device.type == "cpu":` branch
    calls = []

    def visit(node, parents):
        if isinstance(node, ast.Call) and \
                ast.unparse(node.func).endswith(plain):
            calls.append((node, list(parents)))
        for child in ast.iter_child_nodes(node):
            visit(child, parents + [node])

    visit(fn, [])
    assert calls, f"{k.wrapper} never calls {plain}"
    for call, parents in calls:
        guards = [p for p in parents if isinstance(p, ast.If)
                  and any(call in ast.walk(s) for s in p.body)]
        assert guards and all("device.type == 'cpu'" in ast.unparse(g.test)
                              for g in guards), ast.unparse(call)


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
            assert "device.type == 'cpu'" in ast.unparse(node.test)
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
    """Inputs that require grad on CUDA leave the wrapper for the
    autograd function before any work: in the wrapper the CPU branch
    comes first, then the grad check, whose branch returns
    `WindowAttentionCore.apply`, then the input checks and the library.
    The function's forward calls only the wrapper and its backward only
    `window_attention_bwd` (the kernels on CUDA), with nothing caught
    and no plain version; Swin's attention calls only the wrapper."""
    from paddle_tpu_torch.vision.models import swin

    wa = K.window_attention
    fn = ast.parse(textwrap.dedent(inspect.getsource(
        wa.window_attention))).body[0]
    tests = [ast.unparse(n.test) if isinstance(n, ast.If) else None
             for n in fn.body]
    cpu = tests.index("qkv.device.type == 'cpu'")
    grad = next(i for i, t in enumerate(tests) if t and "requires_grad" in t)
    work = next(i for i, n in enumerate(fn.body)
                if "_checked" in ast.unparse(n))
    lib = next(i for i, n in enumerate(fn.body)
               if "_build.library" in ast.unparse(n))
    assert cpu < grad < work < lib
    routed = fn.body[grad].body[0]
    assert isinstance(routed, ast.Return) and \
        ast.unparse(routed.value.func) == "WindowAttentionCore.apply"
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
    assert "atomic" not in code
    assert set(re.findall(r"#include <([^>]+)>", code)) <= {
        "cuda_bf16.h", "cuda_runtime.h", "stdint.h"}
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
