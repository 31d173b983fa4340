"""The port's recurrent family (`paddle_tpu_torch.nn.layers_rnn`) against
the JAX package's, on the CPU.

Every cell and every full-sequence layer is built in both packages with
the same arguments; the port's parameters are the JAX layer's
(`load_reference_state` from ``functional_state()``) and both run on the
same seeded numpy inputs: outputs and final states within rtol 1e-5 /
atol 1e-5, and the inputs' and every parameter's gradient within 1e-4
of ``jax.grad`` of the JAX layer's `functional_call`.  `dynamic_decode`'s
ids equal JAX's bit for bit and its scores within 1e-5, in cases with
finished beams and tied candidates.  The sequence-to-sequence model of
``chip_smoke.py``'s `seq2seq_*` phases (PaddleNLP's base seq2seq: an
`nn.LSTM` encoder, a stacked `LSTMCell` decoder, a vocabulary head) at
tiny widths: its loss and gradients against ``jax.grad``, a 3-step Adam
+ `ClipGradByGlobalNorm` trajectory against the JAX eager loop, and its
beam search.  Also pinned: the behaviour copied from JAX (ROADMAP
C2.42: `sequence_length` ignored, `impute_finished` and ``**kwargs``
ignored) and the tie order of the beam search (C2.43).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as JN
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch as PT
import paddle_tpu_torch.nn as TN
from paddle_tpu_torch.core import device as D
from paddle_tpu_torch.nn.layer_base import load_reference_state

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = D._default
    D.set_device("cpu")
    yield
    D._default = prev


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_value", x))


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [x]


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _pair(jcls, tcls, args, kw):
    P.seed(0)
    jm, tm = jcls(*args, **kw), tcls(*args, **kw)
    params, buffers = jm.functional_state()
    load_reference_state(tm, params, buffers)
    jm.eval()
    tm.eval()
    return jm, tm


def _held(name, args, kw, inputs, states=None, fkw=None, build=None):
    """`name` built in both packages, run on `inputs` (and `states`, a
    nested tuple of arrays or None): outputs and states compared, then
    the gradients of sum(out * g) over every output leaf."""
    fkw = fkw or {}
    jcls, tcls = build or (getattr(JN, name), getattr(TN, name))
    jm, tm = _pair(jcls, tcls, args, kw)

    def tree(st, f):
        if st is None:
            return None
        if isinstance(st, (tuple, list)):
            return type(st)(tree(s, f) for s in st)
        return f(st)

    want = jm(*(Tensor(jnp.asarray(a)) for a in inputs),
              tree(states, lambda a: Tensor(jnp.asarray(a))), **fkw)
    got = tm(*(torch.from_numpy(a) for a in inputs),
             tree(states, torch.from_numpy), **fkw)
    _close(got, want, what=name)
    gs = [np.random.RandomState(90 + i).randn(*_np(w).shape).astype(
        np.float32) for i, w in enumerate(_flat(want))]
    params, buffers = jm.functional_state()

    def loss(p, *xs):
        out, _ = jm.functional_call(
            p, buffers, *(Tensor(x) for x in xs),
            tree(states, lambda a: Tensor(jnp.asarray(a))), **fkw)
        return sum(jnp.sum(getattr(o, "_value", o) * g)
                   for o, g in zip(_flat(out), gs))

    jg = jax.grad(loss, argnums=tuple(range(1 + len(inputs))))(
        params, *(jnp.asarray(a) for a in inputs))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = tm(*ts, tree(states, torch.from_numpy), **fkw)
    sum((o * torch.from_numpy(g)).sum()
        for o, g in zip(_flat(out), gs)).backward()
    for t, w in zip(ts, jg[1:]):
        _close(t.grad, w, GRAD_TOL, GRAD_TOL, f"{name} dx")
    for n, p in tm.named_parameters():
        _close(p.grad, jg[0][n], GRAD_TOL, GRAD_TOL, f"{name} d{n}")
    return jm, tm


X = _f(3, 5, 4, seed=1)          # [B, T, in]
X_TM = _f(5, 3, 4, seed=2)       # [T, B, in]


@pytest.mark.parametrize("name,args,kw,states", [
    ("SimpleRNNCell", (4, 6), {}, None),
    ("SimpleRNNCell", (4, 6), dict(activation="relu"), _f(3, 6, seed=3)),
    ("LSTMCell", (4, 6), {}, None),
    ("LSTMCell", (4, 6), {}, (_f(3, 6, seed=4), _f(3, 6, seed=5))),
    ("GRUCell", (4, 6), {}, None),
    ("GRUCell", (4, 6), {}, _f(3, 6, seed=6)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_cell_matches_jax(name, args, kw, states):
    _, tm = _held(name, args, kw, (_f(3, 4, seed=7),), states)
    assert tm.state_shape


def _lstm_states(layers, dirs, seed):
    n = layers * dirs
    return (_f(n, 3, 6, seed=seed), _f(n, 3, 6, seed=seed + 1))


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
def test_multi_layer_rnn_matches_jax(name, direction, time_major):
    dirs = 2 if direction == "bidirect" else 1
    kw = dict(num_layers=2, direction=direction, time_major=time_major,
              dropout=0.3)
    x = X_TM if time_major else X
    if name == "LSTM":
        states = _lstm_states(2, dirs, 10)
    else:
        states = _f(2 * dirs, 3, 6, seed=12)
    _held(name, (4, 6), kw, (x,), states)
    _held(name, (4, 6), kw, (x,), None)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_rnn_wrapper_matches_jax(cell, is_reverse):
    def build(nn):
        return lambda: nn.RNN(getattr(nn, cell)(4, 6),
                              is_reverse=is_reverse)

    _held("RNN", (), {}, (X,), None, build=(build(JN), build(TN)))


def test_birnn_matches_jax():
    def build(nn):
        return lambda: nn.BiRNN(nn.LSTMCell(4, 6), nn.GRUCell(4, 6))

    _held("BiRNN", (), {}, (X,), None, build=(build(JN), build(TN)))


class _Counted(TN.LSTMCell):
    """A user cell whose class replaces `forward` (and counts its
    calls)."""
    calls = 0

    def forward(self, inputs, states=None):
        type(self).calls += 1
        return super().forward(inputs, states)


class _Projected(TN.LSTMCell):
    """The library cell's `forward`, its input projections recorded."""
    shapes = []

    def project(self, x):
        type(self).shapes.append(tuple(x.shape))
        return super().project(x)


def test_rnn_hoists_the_input_projection_unless_the_cell_is_hooked():
    """One GEMM for every step's input projection where calling the cell
    is its `project` then its `step`: a library cell with no hook.  A
    hooked cell, and a cell whose class replaces `forward`, are called
    every step, as JAX's `RNN` calls its cell; all three give the same
    output here."""
    x = torch.from_numpy(X)
    cell = _Projected(4, 6)
    _Projected.shapes.clear()
    plain, _ = TN.RNN(cell)(x)
    assert _Projected.shapes == [X.shape]
    _Projected.shapes.clear()
    cell.register_forward_pre_hook(lambda m, i: None)
    hooked, _ = TN.RNN(cell)(x)
    assert _Projected.shapes == [(X.shape[0], X.shape[2])] * X.shape[1]
    counted = _Counted(4, 6)
    counted.load_state_dict(cell.state_dict())
    _Counted.calls = 0
    own, _ = TN.RNN(counted)(x)
    assert _Counted.calls == X.shape[1]
    torch.testing.assert_close(hooked, plain, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(own, plain, rtol=1e-6, atol=1e-6)


def _leaky(nn):
    class Leaky(nn.GRUCell):
        """A user cell: the GRU's new state averaged with the old."""

        def forward(self, inputs, states=None):
            h, _ = super().forward(inputs, states)
            if states is not None:
                h = h * 0.5 + states * 0.5
            return h, h
    return Leaky


@pytest.mark.parametrize("is_reverse", [False, True])
def test_rnn_runs_a_cell_that_replaces_forward_as_jax(is_reverse):
    """A subclass of a library cell that replaces `forward` (Paddle's
    idiom for a custom cell) runs its own `forward` every step inside
    `RNN`, as in JAX: outputs, states and gradients against JAX's, and
    not the plain GRU's."""
    def build(nn):
        return lambda: nn.RNN(_leaky(nn)(4, 6), is_reverse=is_reverse)

    _, tm = _held("RNN", (), {}, (X,), None, build=(build(JN), build(TN)))
    plain = TN.RNN(TN.GRUCell(4, 6), is_reverse=is_reverse)
    plain.cell.load_state_dict(tm.cell.state_dict())
    x = torch.from_numpy(X)
    assert not torch.allclose(tm(x)[0], plain(x)[0], atol=1e-3)


class _Elman(TN.RNNCellBase):
    """A cell built on `RNNCellBase` with a `forward` and no `step`."""

    def __init__(self):
        super().__init__(4, 6, 1)

    def forward(self, inputs, states=None):
        h = torch.zeros(inputs.shape[0], 6) if states is None else states
        h = torch.tanh(inputs @ self.weight_ih.T + h @ self.weight_hh.T)
        return h, h


def test_rnn_runs_a_base_cell_with_forward_only():
    cell = _Elman()
    x = torch.from_numpy(X)
    out, last = TN.RNN(cell)(x)
    h = torch.zeros(X.shape[0], 6)
    for t in range(X.shape[1]):
        h, _ = cell(x[:, t], None if t == 0 else h)
        torch.testing.assert_close(out[:, t], h, rtol=0, atol=0)
    torch.testing.assert_close(last, h, rtol=0, atol=0)


def test_sequence_length_is_ignored_as_in_jax():
    """ROADMAP C2.42: `RNN`, `BiRNN` and the multi-layer layers ignore
    `sequence_length` (JAX :149, :203, :263): the outputs with lengths
    equal those without, in both packages."""
    lens = np.array([2, 5, 1], np.int64)
    jm, tm = _pair(JN.LSTM, TN.LSTM, (4, 6), dict(num_layers=2))
    x = torch.from_numpy(X)
    a, _ = tm(x, None, torch.from_numpy(lens))
    b, _ = tm(x)
    assert torch.equal(a, b)
    ja, _ = jm(Tensor(jnp.asarray(X)), None, Tensor(jnp.asarray(lens)))
    jb, _ = jm(Tensor(jnp.asarray(X)))
    np.testing.assert_array_equal(_np(ja), _np(jb))
    _close(a, ja)
    bi = TN.BiRNN(TN.GRUCell(4, 6), TN.GRUCell(4, 6))
    assert torch.equal(bi(x, None, torch.from_numpy(lens))[0], bi(x)[0])


def test_dropout_between_layers_in_training():
    """Dropout 0.5 between the two layers in training draws from the
    port's generator: `seed` repeats it, eval mode leaves it out."""
    lstm = TN.LSTM(4, 6, num_layers=2, dropout=0.5)
    x = torch.from_numpy(X)
    lstm.train()
    PT.seed(3)
    a, _ = lstm(x)
    PT.seed(3)
    b, _ = lstm(x)
    assert torch.equal(a, b)
    lstm.eval()
    c, _ = lstm(x)
    assert not torch.equal(a, c)


def test_cell_parameters_keep_the_jax_names_and_init():
    """`cells.{i}.weight_ih` ... as in JAX (state dicts cross packages),
    drawn from U(-1/sqrt(h), 1/sqrt(h)) biases included."""
    jm = JN.GRU(4, 8, num_layers=2, direction="bidirect")
    tm = TN.GRU(4, 8, num_layers=2, direction="bidirect")
    assert sorted(jm.functional_state()[0]) == sorted(
        n for n, _ in tm.named_parameters())
    bound = 1 / np.sqrt(8)
    for n, p in tm.named_parameters():
        assert p.abs().max() <= bound, n
        assert p.abs().max() > bound / 2, n


# ------------------------------------------------------------ beam search
def _decoder_pair(vocab, emb, hidden, beam, end, seed):
    P.seed(seed)
    jemb, jcell, jout = (JN.Embedding(vocab, emb), JN.LSTMCell(emb, hidden),
                         JN.Linear(hidden, vocab))
    temb, tcell, tout = (TN.Embedding(vocab, emb), TN.LSTMCell(emb, hidden),
                         TN.Linear(hidden, vocab))
    for j, t in ((jemb, temb), (jcell, tcell), (jout, tout)):
        load_reference_state(t, *j.functional_state())
    jdec = JN.BeamSearchDecoder(jcell, 1, end, beam, jemb, jout)
    tdec = TN.BeamSearchDecoder(tcell, 1, end, beam, temb, tout)
    return jdec, tdec


@pytest.mark.parametrize("vocab,beam,end,steps,seed", [
    (12, 4, 0, 6, 0),      # more candidates than beams
    (5, 8, 2, 7, 1),       # fewer: tied -1e9 candidates from step 1
    (4, 6, 3, 9, 2),       # finished beams and ties at every step
])
def test_dynamic_decode_matches_jax_bit_for_bit(vocab, beam, end, steps,
                                                seed):
    jdec, tdec = _decoder_pair(vocab, 6, 8, beam, end, seed)
    h, c = _f(3, 8, seed=seed + 20), _f(3, 8, seed=seed + 21)
    jids, jscores, jlen = JN.dynamic_decode(
        jdec, (Tensor(jnp.asarray(h)), Tensor(jnp.asarray(c))),
        max_step_num=steps, return_length=True)
    tids, tscores, tlen = TN.dynamic_decode(
        tdec, (torch.from_numpy(h), torch.from_numpy(c)),
        max_step_num=steps, return_length=True)
    np.testing.assert_array_equal(tids.numpy(), _np(jids))
    assert tids.dtype == torch.int32 and tuple(tids.shape) == _np(jids).shape
    np.testing.assert_allclose(tscores.numpy(), _np(jscores), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tlen.numpy(), _np(jlen))
    if vocab < beam:
        # after one step, the beams that are not live yet offer tied
        # -1e9 candidates: the lower flat index wins, as in
        # jax.lax.top_k
        j1, js1 = JN.dynamic_decode(
            jdec, (Tensor(jnp.asarray(h)), Tensor(jnp.asarray(c))),
            max_step_num=1)
        t1, ts1 = TN.dynamic_decode(
            tdec, (torch.from_numpy(h), torch.from_numpy(c)), max_step_num=1)
        np.testing.assert_array_equal(t1.numpy(), _np(j1))
        np.testing.assert_allclose(ts1.numpy(), _np(js1), rtol=1e-5,
                                   atol=1e-5)
        assert (ts1.numpy() < -1e8).any()
    if end in (2, 3):
        assert (tids.numpy() == end).any()


def test_dynamic_decode_ignores_impute_finished_and_kwargs():
    """ROADMAP C2.42: as JAX's (:293-295), `impute_finished`, `is_test`
    and any other keyword change nothing; time-major output is [T, B,
    W]."""
    _, tdec = _decoder_pair(5, 6, 8, 3, 2, 4)
    h, c = (torch.from_numpy(_f(2, 8, seed=s)) for s in (30, 31))
    a = TN.dynamic_decode(tdec, (h, c), max_step_num=5)
    b = TN.dynamic_decode(tdec, (h, c), max_step_num=5, impute_finished=True,
                          is_test=True, memory=torch.ones(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    tm = TN.dynamic_decode(tdec, (h, c), max_step_num=5,
                           output_time_major=True)
    assert torch.equal(tm[0].movedim(0, 1), a[0])


def test_dynamic_decode_ties_break_to_the_lower_index():
    """ROADMAP C2.43: equal totals are ordered lower flat index first,
    as `jax.lax.top_k` orders them (`torch.topk` fixes no order): a cell
    whose logits are all equal picks tokens 0, 1, 2 of beam 0."""
    class Flat(TN.Layer):
        def forward(self, x, states):
            return torch.zeros(x.shape[0], 7), states

    dec = TN.BeamSearchDecoder(Flat(), 0, 6, 3)
    ids, scores = TN.dynamic_decode(dec, torch.zeros(2, 1), max_step_num=1)
    assert ids[:, 0].tolist() == [[0, 1, 2], [0, 1, 2]]
    torch.testing.assert_close(scores, torch.full((2, 3), -np.log(7.0)))


# ------------------------------------------------------------ seq2seq
def _seq2seq(nn, vocab_src=11, vocab_tgt=9, hidden=8, layers=2,
             dropout=0.0):
    """PaddleNLP's base seq2seq (no attention) in `nn` (either package):
    an embedding and an `LSTM` encoder, a stacked `LSTMCell` decoder cell
    whose states are one flat tuple (h0, c0, h1, c1, ...), a head."""
    class Stacked(nn.Layer):
        def __init__(self):
            super().__init__()
            self.cells = nn.LayerList([nn.LSTMCell(hidden, hidden)
                                       for _ in range(layers)])
            self.drop = nn.Dropout(dropout)

        def forward(self, x, states):
            new = []
            for i, cell in enumerate(self.cells):
                x, (h, c) = cell(x, (states[2 * i], states[2 * i + 1]))
                new += [h, c]
                if i < layers - 1:
                    x = self.drop(x)
            return x, tuple(new)

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(vocab_src, hidden)
            self.tgt_emb = nn.Embedding(vocab_tgt, hidden)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers,
                                   dropout=dropout)
            self.decoder = nn.RNN(Stacked())
            self.head = nn.Linear(hidden, vocab_tgt)

        def init_states(self, src):
            _, (h, c) = self.encoder(self.src_emb(src))
            return tuple(t for i in range(layers) for t in (h[i], c[i]))

        def forward(self, src, tgt_in, tgt_out, mask):
            out, _ = self.decoder(self.tgt_emb(tgt_in),
                                  self.init_states(src))
            ce = nn.functional.cross_entropy(self.head(out), tgt_out,
                                             reduction="none")
            return (ce * mask).sum() / src.shape[0]

    return Seq2Seq()


def _batch(seed, b=3, s=5, t=6, vs=11, vt=9):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, vs, (b, s)).astype(np.int64)
    tgt = rs.randint(2, vt, (b, t + 1)).astype(np.int64)
    lens = rs.randint(2, t + 1, b)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return src, tgt[:, :-1].copy(), tgt[:, 1:, None].copy(), mask


def _jb(arrays):
    return [Tensor(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                               else a)) for a in arrays]


def _seq2seq_pair():
    P.seed(0)
    jm, tm = _seq2seq(JN), _seq2seq(TN)
    load_reference_state(tm, *jm.functional_state())
    return jm, tm


def test_seq2seq_loss_and_gradients_match_jax():
    jm, tm = _seq2seq_pair()
    batch = _batch(0)
    params, buffers = jm.functional_state()

    def loss(p):
        out, _ = jm.functional_call(p, buffers, *_jb(batch))
        return getattr(out, "_value", out)

    jl, jg = jax.value_and_grad(loss)(params)
    tl = tm(*(torch.from_numpy(a) for a in batch))
    tl.backward()
    _close(tl, jl, what="loss")
    for n, p in tm.named_parameters():
        _close(p.grad, jg[n], GRAD_TOL, GRAD_TOL, f"seq2seq d{n}")


def test_seq2seq_adam_clip_trajectory_matches_jax():
    """Three eager steps of Adam (lr 1e-2) under ClipGradByGlobalNorm(5.0)
    on three batches: the losses within 1e-5 and every parameter within
    1e-5 after the last step."""
    jm, tm = _seq2seq_pair()
    jopt = P.optimizer.Adam(learning_rate=1e-2, parameters=jm.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(5.0))
    topt = PT.optimizer.Adam(learning_rate=1e-2,
                             parameters=list(tm.parameters()),
                             grad_clip=TN.ClipGradByGlobalNorm(5.0))
    for step in range(3):
        batch = _batch(step + 1)
        jl = jm(*_jb(batch))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tm(*(torch.from_numpy(a) for a in batch))
        tl.backward()
        topt.step()
        topt.clear_grad()
        _close(tl, jl, what=f"loss step {step}")
    params, _ = jm.functional_state()
    for n, p in tm.named_parameters():
        _close(p, params[n], 1e-5, 1e-5, n)


def test_seq2seq_beam_search_matches_jax():
    """The model's decoder under `BeamSearchDecoder(beam_size=4)` from the
    encoder's states: ids bit for bit, scores within 1e-5."""
    jm, tm = _seq2seq_pair()
    src = _batch(5)[0]
    jdec = JN.BeamSearchDecoder(jm.decoder.cell, 1, 2, 4, jm.tgt_emb,
                                jm.head)
    tdec = TN.BeamSearchDecoder(tm.decoder.cell, 1, 2, 4, tm.tgt_emb,
                                tm.head)
    jids, jsc = JN.dynamic_decode(jdec, jm.init_states(_jb([src])[0]),
                                  max_step_num=8)
    tids, tsc = TN.dynamic_decode(tdec, tm.init_states(
        torch.from_numpy(src)), max_step_num=8)
    np.testing.assert_array_equal(tids.numpy(), _np(jids))
    np.testing.assert_allclose(tsc.numpy(), _np(jsc), rtol=1e-5, atol=1e-5)
