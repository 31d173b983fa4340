"""`generate()`'s sampling and beam search in the port, on the CPU,
against the JAX package.

  * `_sample` given JAX's own Gumbel noise (``jax.random.gumbel(sub,
    shape, f32)``, the draw inside ``jax.random.categorical``): the same
    token as JAX `_sample` with that key, at T in {1, 0.7} and top_k in
    {0, 1, 5, vocab + 3}, with a row tied at the k-th value (ties are
    kept, and the rest set to -1e30);
  * the noise: finite f32 Gumbel draws from a `torch.Generator`;
  * beam search: `generate(num_beams in {2, 4}, length_penalty in {1.0,
    0.6})` with and without eos, tokens equal to JAX's on the same
    weights (f32, a GPT of vocab 128, width 32, two layers); `_top`
    keeps the lower index first among ties, as `jax.lax.top_k`;
  * sampled `generate()`: a seed gives the same tokens chunked and one
    step at a time, with and without an eos, through the stand-in graph
    as eagerly; top_k=1 gives the greedy tokens; seed=None draws from
    `core.rng`; the chunk and beam graphs' capture path.

Sampled tokens are not compared with JAX's: the JAX package threads a
PRNG key, the port a `torch.Generator`.
"""
from __future__ import annotations

import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.models import generation as JGEN
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.core import graphs as GR
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.models import generation as GEN
from paddle_tpu_torch.models.gpt import (
    GPTConfig, GPTForCausalLM, load_reference_state,
)
from test_torch_graphs import _BodyGraph, _cpu_replay

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
GM = GEN.GenerationMixin


@pytest.fixture(scope="module")
def models():
    P.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(0).randint(0, 128, (3, 7)).astype(np.int32)


# ---------------------------------------------------------------- _sample

@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_k", [0, 1, 5, 131])
def test_sample_equals_jax_given_its_noise(temperature, top_k):
    """Exact tokens: the port's rule on JAX's noise is JAX's `_sample`.
    Row 2 ties ten logits at the top (top_k 1 and 5 keep all ten), row 3
    ties three at the 5th largest value (top_k 5 keeps all seven)."""
    rs = np.random.RandomState(int(temperature * 10) + top_k)
    key = jax.random.PRNGKey(top_k)
    for _ in range(3):
        logits = (rs.randn(4, 128) * 2).astype(np.float32)
        logits[2, :10] = 9.0
        logits[3, 3:7] = [10.0, 11.0, 12.0, 13.0]
        logits[3, :3] = 9.5                        # the 5th..7th largest
        key, sub = jax.random.split(key)
        want = np.asarray(JGEN._sample(jnp.asarray(logits), sub, True,
                                       temperature, top_k))
        # pt-lint: ok[PT003] (the key of JAX's own draw, on purpose: the port's rule is fed the noise that `_sample` drew)
        noise = np.array(jax.random.gumbel(sub, logits.shape, jnp.float32))
        got = GEN._sample(torch.from_numpy(logits), torch.from_numpy(noise),
                          True, temperature, top_k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if top_k in (1, 5):
            assert got[2] < 10          # only the tied top ten survive
        if top_k == 5:
            assert 0 <= int(got[3]) < 7
    greedy = GEN._sample(torch.from_numpy(logits), None, False,
                         temperature, top_k)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_gumbel_noise_is_finite_and_seeded():
    """f32 draws on [tiny, 1): finite, Gumbel-distributed (mean near the
    Euler-Mascheroni constant), equal for equal seeds."""
    g = torch.Generator().manual_seed(5)
    x = GEN.gumbel_noise((64, 1024), g, "cpu")
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert abs(x.mean().item() - 0.5772) < 0.02
    y = GEN.gumbel_noise((64, 1024), torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(x, y)


def test_top_keeps_the_lower_index_first_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 1.0]])
    vals, idx = GEN._top(x, 3)
    assert idx.tolist() == [[1, 2, 4], [4, 0, 1]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ------------------------------------------------------------ beam search

@pytest.mark.parametrize("num_beams,length_penalty,eos", [
    (2, 1.0, None), (2, 1.0, 5), (2, 0.6, 5),
    (4, 1.0, None), (4, 1.0, 5), (4, 0.6, 5)])
def test_beam_search_equals_jax(models, ids, num_beams, length_penalty,
                                eos):
    """Exact tokens against JAX `_beam_search`, without an eos and with
    one that the beams emit (the finished pool, its length-normalised
    scores and the backtrack; without an eos every beam has one length,
    so the penalty cannot reorder them)."""
    jm, tm = models
    want = np.asarray(jm.generate(
        P.to_tensor(ids, "int32"), max_new_tokens=9, num_beams=num_beams,
        length_penalty=length_penalty, eos_token_id=eos)._value)
    got = tm.generate(ids, max_new_tokens=9, num_beams=num_beams,
                      length_penalty=length_penalty,
                      eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    if eos is not None:
        assert (want[:, 7:] == eos).any()        # the pool was used


def test_beam_step_graph_replays_its_body(models, ids, monkeypatch):
    """Through the stand-in graph: the first beam step runs the body and
    captures it as ``beam_step_b{b}_n{n}``, the others replay it, and the
    tokens equal the eager CPU path; one max_new_tokens=1 call takes no
    step."""
    _, tm = models
    want = tm.generate(ids, max_new_tokens=6, num_beams=3,
                       eos_token_id=5).numpy()
    _cpu_replay(monkeypatch)
    # the CUDA path of a step, on the CPU
    monkeypatch.setattr(GM, "_run_beam_step", GM._replay_beam)
    labels = []
    real = GR.capture

    def capture(body, stream, label, pool=None, generators=()):
        labels.append(label)
        return real(body, stream, label, pool=pool, generators=generators)

    monkeypatch.setattr(GR, "capture", capture)
    got = tm.generate(ids, max_new_tokens=6, num_beams=3,
                      eos_token_id=5).numpy()
    np.testing.assert_array_equal(got, want)
    assert labels == ["beam_step_b3_n3"]
    assert len(_BodyGraph.made) == 1 and _BodyGraph.made[0].replays == 4
    GEN._generation(tm).beam = None


# -------------------------------------------------------- sampled generate

def _per_step(tm, ids, new, seed, temperature, top_k, eos=None):
    """Sampled decoding one token at a time over fresh caches, drawing
    from a generator seeded with `seed`."""
    g = torch.Generator().manual_seed(seed)
    b, s0 = ids.shape
    with torch.inference_mode():
        caches = tm.init_kv_caches(b, s0 + new)
        x = torch.from_numpy(ids)
        logits, _ = tm(x, kv_caches=caches, cache_pos=0)
        tok = GEN.sample(logits[:, -1], True, temperature, top_k, g)
        finished = torch.zeros(b, dtype=torch.bool)
        if eos is not None:
            finished = tok == eos
        out = [tok]
        for i in range(1, new):
            logits, _ = tm(tok[:, None], kv_caches=caches,
                           cache_pos=s0 + i - 1)
            tok = GEN.sample(logits[:, -1], True, temperature, top_k, g)
            if eos is not None:
                tok = torch.where(finished, eos, tok)
                finished = finished | (tok == eos)
            out.append(tok)
    return torch.cat([x, torch.stack(out, dim=1)], dim=1).numpy()


def test_sampled_generate_same_seed_same_tokens(models, ids):
    """One seed: the chunk programs (one chunk of 39 steps without an
    eos, chunks of 32 with one) equal the per-step loop; a second call
    gives the same tokens, another seed others; top_k=1 is greedy; every
    token in vocabulary."""
    _, tm = models
    kw = dict(do_sample=True, temperature=0.8, top_k=20)
    a = tm.generate(ids, max_new_tokens=40, seed=3, **kw).numpy()
    np.testing.assert_array_equal(a, _per_step(tm, ids, 40, 3, 0.8, 20))
    np.testing.assert_array_equal(
        a, tm.generate(ids, max_new_tokens=40, seed=3, **kw).numpy())
    # an eos that never comes: chunks of 32 and 7, the same stream
    np.testing.assert_array_equal(
        a, tm.generate(ids, max_new_tokens=40, seed=3, eos_token_id=1000,
                       **kw).numpy())
    assert not np.array_equal(
        a, tm.generate(ids, max_new_tokens=40, seed=4, **kw).numpy())
    eos = int(a[0, 7 + 4])
    e = tm.generate(ids, max_new_tokens=40, seed=3, eos_token_id=eos,
                    **kw).numpy()
    np.testing.assert_array_equal(
        e, _per_step(tm, ids, 40, 3, 0.8, 20, eos)[:, :e.shape[1]])
    np.testing.assert_array_equal(e[0, :7 + 5], a[0, :7 + 5])
    greedy = tm.generate(ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(
        greedy, tm.generate(ids, max_new_tokens=12, do_sample=True,
                            temperature=0.8, top_k=1, seed=9).numpy())
    assert ((a >= 0) & (a < 128)).all()


def test_sampled_generate_draws_from_core_rng_without_a_seed(models, ids):
    _, tm = models
    kw = dict(max_new_tokens=10, do_sample=True, top_k=0)
    rng.seed(11)
    a = tm.generate(ids, **kw).numpy()
    b = tm.generate(ids, **kw).numpy()          # the generator moved on
    rng.seed(11)
    np.testing.assert_array_equal(a, tm.generate(ids, **kw).numpy())
    assert not np.array_equal(a, b)
    rng.seed(0)


def test_sampling_chunk_graph_registers_its_generator(models, ids,
                                                      monkeypatch):
    """Through the stand-in graph: a sampling chunk program captures
    with its generator registered, as ``decode_chunk_n{n}_sample``, and
    its replays give the eager tokens of the same seed; a greedy chunk
    registers none."""
    _, tm = models
    kw = dict(max_new_tokens=9, do_sample=True, temperature=0.7, top_k=5)
    want = tm.generate(ids, seed=2, **kw).numpy()
    greedy = tm.generate(ids, max_new_tokens=9).numpy()
    _cpu_replay(monkeypatch)
    # the CUDA path of a chunk, on the CPU
    monkeypatch.setattr(GM, "_run_decode_chunk", GM._replay_chunk)
    labels = []
    real = GR.capture

    def capture(body, stream, label, pool=None, generators=()):
        labels.append((label, generators))
        return real(body, stream, label, pool=pool, generators=generators)

    monkeypatch.setattr(GR, "capture", capture)
    for _ in range(2):
        np.testing.assert_array_equal(tm.generate(ids, seed=2, **kw).numpy(),
                                      want)
    np.testing.assert_array_equal(tm.generate(ids, max_new_tokens=9).numpy(),
                                  greedy)
    st = GEN._generation(tm).state
    assert [lb for lb, _ in labels] == ["decode_chunk_n8_sample",
                                        "decode_chunk_n8"]
    assert labels[0][1] == (st.generator,) and labels[1][1] == ()
    assert [g.replays for g in _BodyGraph.made] == [1, 0]
    GEN._generation(tm).state = None


def _tree(fn):
    return ast.parse(textwrap.dedent(inspect.getsource(fn)))


def test_beam_capture_path_never_falls_back():
    """The beam step's capture and replay path holds to the rule of the
    chunk programs (`test_torch_graphs.py`): one partial of the body,
    through `GR.capture` on the capture stream in the state's pool, no
    try/except, no device test or environment; `_run_beam_step` branches
    once, a CPU device to the body and anything else to the replay."""
    rep = _tree(GM._replay_beam)
    text = ast.unparse(rep)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(rep))
    assert "cpu" not in text and "environ" not in text
    assert text.count("functools.partial(self._beam_step_body") == 1
    calls = [n for n in ast.walk(rep) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "GR.capture"]
    assert len(calls) == 1 and len(calls[0].args) == 3
    assert "pool" in [k.arg for k in calls[0].keywords]
    assert "GR.capture_stream(" in text
    run = _tree(GM._run_beam_step)
    ifs = [n for n in ast.walk(run) if isinstance(n, ast.If)]
    assert len(ifs) == 1
    assert ast.unparse(ifs[0].test) == "self.device.type == 'cpu'"
    assert "self._beam_step_body" in ast.unparse(
        ast.Module(ifs[0].body, []))
    assert "self._replay_beam" in ast.unparse(ast.Module(ifs[0].orelse, []))
    assert "generators=" in ast.unparse(_tree(GM._replay_chunk))
