"""Recurrent layers (``paddle_tpu/nn/layers_rnn.py`` counterpart).

The cells compute what the JAX cells' bodies compute (:60-66, :88-97,
:121-129): gates ``x @ wi.T + bi + h @ wh.T + bh``, split i / f / g / o
for the LSTM and r / z / c for the GRU with ``(h - c) * z + c``.  No
cuDNN RNN: its fused cell rounds and drops out otherwise.  The
full-sequence layers loop over time as JAX's `RNN.forward` does
(:149-164); for the library cells the input projection ``x @ wi.T +
bi`` of every step is one GEMM before the loop (the cell adds ``h @
wh.T + bh`` to it in the JAX order).  A cell whose class replaces
`forward`, or that carries a hook, is called once a step, as JAX calls
it.

Copied from JAX, and written down as ROADMAP C2.42: `sequence_length`
is ignored by `RNN`, `BiRNN` and the multi-layer layers (:149, :203,
:263), and `dynamic_decode` ignores `impute_finished` and ``**kwargs``
(:293-295).  `dynamic_decode` orders equal candidates as
`jax.lax.top_k` does, the lower flat index first (C2.43).
"""
from __future__ import annotations

import math

import torch

from .functional.common import dropout as _dropout
from .initializer import Uniform
from .layer_base import Layer
from .layers_common import LayerList

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU", "RNNCellBase", "BeamSearchDecoder",
           "dynamic_decode"]


class RNNCellBase(Layer):
    """(JAX `_RNNCellBase`, public as `RNNCellBase`.)  The four
    parameters of a cell, `weight_ih` [G, in], `weight_hh`
    [G, hidden], `bias_ih` / `bias_hh` [G] (G = gates x hidden), drawn
    from U(-1/sqrt(hidden), 1/sqrt(hidden)) as in JAX (:26-40)."""

    def __init__(self, input_size, hidden_size, gate_mult, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        g = gate_mult * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], attr=weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], attr=weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], attr=bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], attr=bias_hh_attr, is_bias=True, default_initializer=init)

    def project(self, x):
        """``x @ wi.T + bi``, the part of the gates that needs no state
        (for every step at once when `x` has a time axis)."""
        return x @ self.weight_ih.T + self.bias_ih

    def _recur(self, h):
        return h @ self.weight_hh.T + self.bias_hh

    def _zeros(self, xw):
        return torch.zeros(xw.shape[0], self.hidden_size, dtype=xw.dtype,
                           device=xw.device)

    def forward(self, inputs, states=None):
        return self.step(self.project(inputs), states)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        super().__init__(input_size, hidden_size, 1, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)
        self.activation = activation

    def step(self, xw, states=None):
        h = self._zeros(xw) if states is None else states
        z = xw + h @ self.weight_hh.T + self.bias_hh
        h = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **kw):
        super().__init__(input_size, hidden_size, 4, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)

    def step(self, xw, states=None):
        if states is None:
            z = self._zeros(xw)
            states = (z, z.clone())
        h, c = states
        gates = xw + h @ self.weight_hh.T + self.bias_hh
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **kw):
        super().__init__(input_size, hidden_size, 3, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)

    def step(self, xw, states=None):
        h = self._zeros(xw) if states is None else states
        ir, iz, ic = xw.chunk(3, -1)
        hr, hz, hc = self._recur(h).chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h = (h - c) * z + c
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _hoistable(cell):
    """Whether `RNN` may run `cell` as its `project` over every step and
    then its `step` a step: only where that is what calling the cell
    does, that is, its class keeps `RNNCellBase.forward` and no hook
    sits on it."""
    return (isinstance(cell, RNNCellBase)
            and type(cell).forward is RNNCellBase.forward
            and not (cell._forward_hooks or cell._forward_pre_hooks))


class RNN(Layer):
    """Runs a cell over the time axis (JAX :138)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        t_axis = 0 if self.time_major else 1
        steps = inputs.shape[t_axis]
        idxs = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        cell = self.cell
        hoist = _hoistable(cell)
        xs = cell.project(inputs) if hoist else inputs
        outs, states = [], initial_states
        for i in idxs:
            x_t = xs.select(t_axis, i)
            out, states = cell.step(x_t, states) if hoist \
                else cell(x_t, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, t_axis), states


class _MultiLayerRNN(Layer):
    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.n_dir = 2 if self.bidirect else 1
        kw = dict(device=device, generator=generator)
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)

        def make_cell(in_sz):
            if self.MODE == "LSTM":
                return LSTMCell(in_sz, hidden_size, *attrs, **kw)
            if self.MODE == "GRU":
                return GRUCell(in_sz, hidden_size, *attrs, **kw)
            return SimpleRNNCell(in_sz, hidden_size, activation, *attrs,
                                 **kw)

        self.cells = LayerList([
            make_cell(input_size if layer == 0
                      else hidden_size * self.n_dir)
            for layer in range(num_layers) for _ in range(self.n_dir)])

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x, final_h, final_c = inputs, [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.n_dir):
                idx = layer * self.n_dir + d
                init = None
                if initial_states is not None:
                    if self.MODE == "LSTM":
                        h0, c0 = initial_states
                        init = (h0[idx], c0[idx])
                    else:
                        init = initial_states[idx]
                out, st = RNN(self.cells[idx], is_reverse=(d == 1),
                              time_major=self.time_major)(x, init)
                outs.append(out)
                if self.MODE == "LSTM":
                    final_h.append(st[0])
                    final_c.append(st[1])
                else:
                    final_h.append(st)
            x = outs[0] if len(outs) == 1 else torch.cat(outs, -1)
            if self.dropout and layer < self.num_layers - 1:
                x = _dropout(x, self.dropout, training=self.training)
        h = torch.stack(final_h, 0)
        if self.MODE == "LSTM":
            return x, (h, torch.stack(final_c, 0))
        return x, h


class SimpleRNN(_MultiLayerRNN):
    MODE = "RNN"


class LSTM(_MultiLayerRNN):
    MODE = "LSTM"


class GRU(_MultiLayerRNN):
    MODE = "GRU"


class BiRNN(Layer):
    """`cell_fw` forward and `cell_bw` reversed over time, the outputs
    concatenated on the feature axis (JAX :194)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_init, bw_init = (initial_states if initial_states is not None
                            else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, fw_init, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw_init, sequence_length)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


class BeamSearchDecoder(Layer):
    """Beam search over a cell (JAX :219): `dynamic_decode` runs it."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _tree_map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return obj


@torch.no_grad()
def dynamic_decode(decoder, inits=None, max_step_num=32,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run a `BeamSearchDecoder` to its end (JAX :293): beams folded into
    the batch, start scores ``[0, -1e9, ...]``, a finished beam extended
    by `end_token` at no cost, the states and the ids emitted so far
    regathered by beam after each step, and a stop once every beam has
    finished.  Returns ([B, T, W] int32 ids, [B, W] f32 scores), and
    [B, T] full-length ``lengths`` with `return_length`.  Like JAX's it
    is not differentiable (JAX reads the raw logits)."""
    cell, W = decoder.cell, decoder.beam_size
    if inits is None:
        raise ValueError("dynamic_decode needs initial states")
    flat = inits[0] if isinstance(inits, (tuple, list)) else inits
    b, dev = flat.shape[0], flat.device
    states = _tree_map(lambda t: torch.repeat_interleave(t, W, 0), inits)
    ids = torch.full((b * W,), decoder.start_token, dtype=torch.int32,
                     device=dev)
    scores = torch.tensor([0.0] + [-1e9] * (W - 1), dtype=torch.float32,
                          device=dev).repeat(b)
    finished = torch.zeros(b * W, dtype=torch.bool, device=dev)
    base = torch.arange(b, device=dev)[:, None] * W
    emitted = torch.empty((0, b * W), dtype=torch.int32, device=dev)
    end_only = None
    for _ in range(max_step_num):
        inp = decoder.embedding_fn(ids) if decoder.embedding_fn \
            else ids.to(torch.float32).unsqueeze(-1)
        out, states_new = cell(inp, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        logp = torch.log_softmax(logits.to(torch.float32), -1)   # [B*W, V]
        v = logp.shape[-1]
        if end_only is None:
            # a finished beam only extends with end_token, at zero cost
            end_only = torch.full((v,), -1e9, device=dev)
            end_only[decoder.end_token] = 0.0
        logp = torch.where(finished[:, None], end_only[None, :], logp)
        total = (scores[:, None] + logp).reshape(b, W * v)
        # jax.lax.top_k: the W largest, equal values lower index first
        top_scores, top_idx = torch.sort(total, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :W], top_idx[:, :W]
        tok = (top_idx % v).to(torch.int32).reshape(-1)
        gather = (base + top_idx // v).reshape(-1)
        states = _tree_map(lambda t: t[gather], states_new)
        scores = top_scores.reshape(-1)
        finished = finished[gather] | (tok == decoder.end_token)
        ids = tok
        # the ids emitted so far follow their beams
        emitted = torch.cat([emitted[:, gather], tok[None]], 0)
        if bool(finished.all()):
            break
    pred = emitted.reshape(-1, b, W)                              # [T, B, W]
    if not output_time_major:
        pred = pred.movedim(0, 1)                                  # [B, T, W]
    result = (pred, scores.reshape(b, W))
    if return_length:
        steps = pred.shape[0 if output_time_major else 1]
        return result + (torch.full((b, W), steps, dtype=torch.int32,
                                    device=dev),)
    return result
