"""ERNIE, the bidirectional encoder with MLM + NSP pretraining heads
(``paddle_tpu/models/ernie.py`` counterpart: `ErnieConfig` :28,
`ErnieEmbeddings` :45, `ErnieModel` :73, `ErnieForPretraining` :112,
`ErniePretrainingCriterion` :141, the presets :162-181).

The encoder is the port's `nn.TransformerEncoder` of post-LN
`TransformerEncoderLayer`s (gelu, erf form).  A ``[B, S]`` attention
mask (1 on real tokens, 0 on padding; by default ``input_ids !=
pad_token_id``) becomes the additive f32 bias ``(1 - mask) * -1e4`` of
shape ``[B, 1, 1, S]``, detached, so on the card every layer's attention
runs the biased flash kernels forward and backward (`flash_fwd` /
`flash_bwd` with a bias that gets no gradient); a 4-D mask the caller
passes is used as it is.  The MLM decoder is tied to the word
embeddings: the logits are ``h @ word_embeddings.weight.T + mlm_bias``
over the whole ``[B, S, V]``, as in the JAX model, and under the train
step's O2 cast the one bf16 copy of the weight feeds the gather and the
decoder, so both gradients reach the one f32 master.  Dropout
(`ErnieConfig.dropout`, 0.1 by default) acts in training mode on the
embeddings and in every layer; the attention's own rate is applied to
nothing (ROADMAP C2.6).  Names and shapes equal the JAX model's
``functional_state()``; models are built in eval mode on `device`
(``None`` = CUDA), with parameters drawn from a generator seeded with
`seed`.
"""
from __future__ import annotations

import torch

from .. import nn
from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layer_base import Layer

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErniePretrainingCriterion", "ernie_tiny", "ernie_base",
           "ernie_3_0_medium"]


class ErnieConfig:
    def __init__(self, vocab_size=40000, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden=None, max_position=2048,
                 type_vocab_size=4, dropout=0.1, layer_norm_eps=1e-12,
                 pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden = ffn_hidden or 4 * hidden_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id


class ErnieEmbeddings(Layer):
    def __init__(self, cfg, *, kw):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position,
                                                cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps,
                                       device=kw["device"], dtype=kw["dtype"])
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int32, device=input_ids.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.int32,
                                         device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


def _build_kw(device, dtype, seed, generator):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    return dict(device=dev, dtype=dtype, generator=generator)


class ErnieModel(Layer):
    """Encoder trunk: (sequence_output [B, S, H], pooled_output [B, H])."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0, *,
                 generator=None):
        super().__init__()
        kw = _build_kw(device, dtype, seed, generator)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, kw=kw)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.ffn_hidden,
            dropout=cfg.dropout, activation="gelu",
            layer_norm_eps=cfg.layer_norm_eps, **kw)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.eval()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is None:
            attention_mask = (input_ids != self.cfg.pad_token_id).float()
        if attention_mask.dim() == 2:
            # the mask built here carries no gradient (the biased flash
            # tier's contract); a caller's 4-D bias keeps its own
            attention_mask = ((1.0 - attention_mask.float()) * -1e4) \
                .detach()[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, attention_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ErnieForPretraining(Layer):
    """MLM (decoder tied to the word embeddings) and NSP heads: (MLM
    logits [B, S, V], NSP logits [B, 2])."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        kw = _build_kw(device, dtype, seed, None)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, generator=kw["generator"],
                                device=kw["device"], dtype=dtype)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                       **kw)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps,
                                     device=kw["device"], dtype=dtype)
        self.mlm_bias = torch.nn.Parameter(torch.zeros(
            cfg.vocab_size, device=kw["device"], dtype=dtype))
        self.nsp_head = nn.Linear(cfg.hidden_size, 2, **kw)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        w = self.ernie.embeddings.word_embeddings.weight       # [V, H]
        logits = torch.matmul(h, w.t()) + self.mlm_bias
        return logits, self.nsp_head(pooled)


class ErniePretrainingCriterion(Layer):
    """The MLM cross entropy over the positions whose label is not
    `ignore_index`, plus the NSP cross entropy when its labels are
    given; each a mean, summed."""

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.ce = nn.CrossEntropyLoss(ignore_index=ignore_index)
        self.nsp_ce = nn.CrossEntropyLoss()

    def forward(self, prediction_logits, nsp_logits, masked_lm_labels,
                next_sentence_labels=None):
        v = prediction_logits.shape[-1]
        mlm = self.ce(prediction_logits.reshape(-1, v),
                      masked_lm_labels.reshape(-1))
        if next_sentence_labels is None:
            return mlm
        return mlm + self.nsp_ce(nsp_logits,
                                 next_sentence_labels.reshape(-1))


def ernie_tiny(**kw):
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_position", 128)
    return ErnieConfig(**kw)


def ernie_base(**kw):
    kw.setdefault("vocab_size", 40000)
    kw.setdefault("hidden_size", 768)
    kw.setdefault("num_layers", 12)
    kw.setdefault("num_heads", 12)
    return ErnieConfig(**kw)


def ernie_3_0_medium(**kw):
    kw.setdefault("num_layers", 6)
    return ernie_base(**kw)
