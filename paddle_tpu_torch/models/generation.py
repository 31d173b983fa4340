"""Auto-regressive generation over static and paged KV caches.

Counterpart of ``paddle_tpu/models/generation.py``: the attention bodies
the model families call with a cache (`_static_cache_attention`,
`_paged_cache_attention`), position helpers, `init_kv_caches`, the
token rule `_sample`, and `generate()`: greedy, sampled and beam search.
The caches are written IN PLACE (the JAX functions return updated
buffers; here the returned buffers are the same tensors).  `generate()`
runs its prefill eagerly and its decode as the JAX package's
`_decode_chunk_program`: chunks of up to `DECODE_CHUNK` steps, each one
fixed-shape program per (n, mask, eos, sampling rule) over caches and
carried tensors that the model keeps for its last (batch, capacity); on
a CUDA device each program is a CUDA graph (`core.graphs`).  Beam search
(JAX `_beam_search`) runs its prefill eagerly and then one fixed-shape
beam step per token, a CUDA graph on the card, over caches of B x
num_beams rows that each step reorders by parent.  Attention runs through
the port's kernels: `flash_fwd` for prefill (causal, with a pad-key bias
for left-padded rows), `decode_attention` for the dense decode step,
`paged_attention` for the engine's paged step (its int8 kernel under the
quantized KV tier).

Sampling draws its Gumbel noise from a `torch.Generator`: `seed=n`
seeds the model's own generator with n for the call, `seed=None` draws
from `core.rng.generator(device)`.  The JAX package threads a PRNG key
instead, so a seed gives other tokens than there; the rule that maps
logits and noise to a token is JAX's (`_sample`), and a sampling chunk
graph registers its generator with the capture, so a replay draws the
next numbers as the eager steps would.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref

import numpy as np
import torch

from ..core import graphs as GR
from ..core import rng
from ..nn import functional as F
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.paged_attention import paged_attention
from ..ops.quant import quantize_vectors

# finite mask value of the JAX package (generation.py:170): a fully
# masked left-pad row stays finite instead of turning NaN
NEG_INF = -1e30

# decode steps per chunk program when an eos can end the loop early (JAX
# generation.py:35); without an eos one chunk takes up to 128 steps
DECODE_CHUNK = 32

# --- warm (cached-prefix) tail prefill -------------------------------------
# Inside `warm_prefill_guard(C)` a multi-token cached forward is a WARM
# TAIL PREFILL: the dense cache buffers arrive holding a cached prefix
# in their first C rows, of which the first `cache_pos` are real; the
# fresh tokens write at [C, C+S), and every query attends the real
# prefix plus the causal fresh span.  The key count C + S and the write
# offset are fixed by C, so a device `cache_pos` gives one fixed-shape
# program per C.  Thread-local, as in the JAX package, so no model
# forward signature grows a parameter.
_WARM_PREFILL = threading.local()


@contextlib.contextmanager
def warm_prefill_guard(prefix_cap):
    """`prefix_cap`: int — rows of the dense cache buffers that hold the
    cached prefix, [0, C); the prefix's real length is the forward's
    `cache_pos` (<= C), the rows past it are hidden keys."""
    prev = getattr(_WARM_PREFILL, "value", None)
    _WARM_PREFILL.value = int(prefix_cap)
    try:
        yield
    finally:
        _WARM_PREFILL.value = prev


def _is_row_vector(cache_pos) -> bool:
    return isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1


def _write_rows(buf, new, at):
    """buf [B, H, cap, D] rows [at, at + S) = new [B, S, H, D], in
    place: a slice for an int `at`, an `index_copy_` along the cache
    axis for a 0-dim device tensor (which a graph replays at whatever
    position the tensor then holds)."""
    new = new.transpose(1, 2).to(buf.dtype)
    if isinstance(at, torch.Tensor):
        rows = at.long() + torch.arange(new.shape[2], device=buf.device)
        buf.index_copy_(2, rows, new)
    else:
        buf[:, :, at:at + new.shape[2]] = new


def _static_cache_attention(q, k, v, kv_cache, cache_pos, attn_start=None):
    """q [B,S,Hq,D]; k/v [B,S,Hkv,D]; kv_cache (k_buf, v_buf)
    [B,Hkv,cap,D] written in place at [cache_pos, cache_pos+S);
    cache_pos an int or a 0-dim int tensor on q's device (the same
    bits); attn_start optional [B] int32 — first non-pad position per
    row.  Prefill (S > 1) assumes cache_pos == 0 and attends the fresh
    K/V (causal, or through the pad mask); decode (S == 1) reads the
    cache through `decode_attention`, keys attn_start..cache_pos.  Under
    `warm_prefill_guard` see there.  A 3-tuple cache ``(k_pages,
    v_pages, page_table)``, or the int8 tier's 5-tuple ``(k_pages,
    v_pages, page_table, k_scales, v_scales)``, with a [B] cache_pos
    routes to `_paged_cache_attention`.  Returns (out [B,S,Hq,D],
    kv_cache)."""
    if isinstance(kv_cache, (tuple, list)) and len(kv_cache) in (3, 5):
        return _paged_cache_attention(q, k, v, kv_cache, cache_pos)
    b, s, hq, d = q.shape
    kb, vb = kv_cache
    on_device = isinstance(cache_pos, torch.Tensor)
    p = cache_pos if on_device else int(cache_pos)
    wp = getattr(_WARM_PREFILL, "value", None)
    if s == 1 or wp is None:
        _write_rows(kb, k, p)
        _write_rows(vb, v, p)
    if s == 1:
        if on_device:
            pos = p.to(torch.int32).reshape(1).expand(b).contiguous()
        else:
            pos = torch.full((b,), p, dtype=torch.int32, device=q.device)
        out = decode_attention(q.reshape(b, hq, d).contiguous(), kb, vb,
                               pos, start=attn_start)
        return out.reshape(b, 1, hq, d), (kb, vb)
    # Prefill attention is causal (bottom-right aligned, so the kernel
    # skips the key blocks past the diagonal) plus, for left-padded rows,
    # a pad-only bias [B, 1, 1, Sk] that hides the pad keys.  Pad query
    # rows then see no valid key; the finite NEG_INF keeps them finite
    # and no real row reads them.
    if wp is not None:
        # WARM tail prefill: keys come from the cache buffer — the prefix
        # rows [0, C) plus the tail written at [C, C+S).  Keys past the
        # written span are cut off; causal with off = Sk - Sq = C lets
        # query row i attend every prefix row and fresh keys j-C <= i,
        # and the pad bias hides the prefix rows past its real length
        # (cache_pos) and the fresh keys below the tail's start.
        _write_rows(kb, k, wp)
        _write_rows(vb, v, wp)
        kk = kb[:, :, :wp + s].transpose(1, 2).contiguous()  # [B,C+S,H,D]
        vv = vb[:, :, :wp + s].transpose(1, 2).contiguous()
        mask = None
        if attn_start is not None or on_device or p != wp:
            j = torch.arange(wp + s, device=q.device)[None, :]
            st = 0 if attn_start is None else attn_start.long()[:, None]
            valid = (j < p) | (j - wp >= st)
            mask = torch.where(valid, 0.0, NEG_INF).expand(
                b, wp + s)[:, None, None]
        out = F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                             is_causal=True)
        return out, (kb, vb)
    mask = None
    if attn_start is not None:
        j = torch.arange(s, device=q.device)[None, :]       # key pos
        valid = j >= attn_start.long()[:, None]
        mask = torch.where(valid, 0.0, NEG_INF)[:, None, None]  # [B,1,1,S]
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         is_causal=True)
    return out, (kb, vb)


def _paged_cache_attention(q, k, v, kv_cache, cache_pos):
    """Paged decode attention (engine tier).  q [B,1,Hq,D]; k/v
    [B,1,Hkv,D]; kv_cache (k_pages, v_pages, page_table): pools
    [num_pages,Hkv,page_size,D], page_table [B,P] int32; cache_pos [B]
    int32, each row's write index.  The current token's K/V goes to
    (page_table[b, pos//ps], pos % ps) in place, then `paged_attention`
    attends keys 0..pos[b].  Free slots ride along with pos 0 and an
    all-scratch table: they all write page 0, slot 0.

    Quantized KV tier: a 5-tuple ``(k_pages, v_pages, page_table,
    k_scales, v_scales)`` with int8 pools and f32 scale tables
    [num_pages,Hkv,page_size].  Each fresh K/V head vector quantizes on
    its own (`quantize_vectors`: no neighbour is requantized, so a write
    stays one slot), its codes and scale go to the same slot in place,
    and `paged_attention` dequantizes inside the kernel."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if s != 1:
        raise ValueError(
            "paged KV cache serves single-token decode steps; prefill "
            "runs the dense path and packs into pages afterwards")
    quantized = len(kv_cache) == 5
    if quantized:
        kp, vp, pt, ks, vs = kv_cache
    else:
        kp, vp, pt = kv_cache
        ks = vs = None
    ps = kp.shape[2]
    pos = cache_pos
    rows = torch.arange(b, device=q.device)
    page_ids = pt[rows, (pos // ps).long()].long()
    slots = (pos % ps).long()
    k1, v1 = k.reshape(b, hkv, d), v.reshape(b, hkv, d)
    # plain indexed assignment, never accumulate=True: duplicate indices
    # (every free slot hits page 0, slot 0) then just leave one of the
    # writes — the scratch page's content is garbage by design
    if quantized:
        # K and V through one codec pass (each vector its own scale)
        codes, sc = quantize_vectors(torch.stack((k1, v1)))
        kp[page_ids, :, slots, :] = codes[0]        # [B,Hkv,D]
        vp[page_ids, :, slots, :] = codes[1]
        ks[page_ids, :, slots] = sc[0]              # [B,Hkv]
        vs[page_ids, :, slots] = sc[1]
    else:
        kp[page_ids, :, slots, :] = k1.to(kp.dtype)
        vp[page_ids, :, slots, :] = v1.to(vp.dtype)
    out = paged_attention(q.reshape(b, hq, d).contiguous(), kp, vp, pt,
                          pos, k_scales=ks, v_scales=vs)
    new_cache = (kp, vp, pt, ks, vs) if quantized else (kp, vp, pt)
    return out.reshape(b, 1, hq, d), new_cache


def decode_position_ids(cache_pos, b, s, attn_start=None, device=None):
    """[B, S] position ids for a cached forward: cache_pos an int or a
    0-dim int32 device tensor (dense lockstep cache; the same bits) or a
    [B] vector (paged ragged cache); left-pad shift applied when
    attn_start is given."""
    if _is_row_vector(cache_pos):
        pos = torch.arange(s, dtype=torch.int32, device=cache_pos.device)
        position_ids = cache_pos[:, None] + pos[None, :]
    else:
        pos = torch.arange(s, dtype=torch.int32, device=device)
        if not isinstance(cache_pos, torch.Tensor):
            cache_pos = int(cache_pos)
        position_ids = (pos + cache_pos)[None, :].expand(b, s)
    return shift_positions(position_ids, attn_start)


def forward_phases(x, head_dim, kv_caches=None, cache_pos=None,
                   attn_start=None, base=10000.0):
    """The rotary (cos, sin) of one model forward of embeddings x [B, S,
    H], in x's dtype, computed once and handed to every layer (the rope
    families' attention rotates q and k by them).  Cached forwards
    continue from cache_pos (an int, or a [B] vector on the paged path);
    left-padded rows put their first real token at rotary position 0."""
    b, s, _ = x.shape
    position_ids = None if kv_caches is None else decode_position_ids(
        cache_pos, b, s, attn_start, device=x.device)
    return F.rotary_phases(head_dim, s, position_ids, base, x.device,
                           x.dtype)


def shift_positions(position_ids, attn_start):
    """Left-padded rows: each row's first real token sits at position 0
    (pad positions clip to 0)."""
    if attn_start is None:
        return position_ids
    return torch.clamp(position_ids - attn_start[:, None], min=0)


def init_kv_caches(num_layers, batch, num_heads, head_dim, max_len,
                   dtype=torch.float32, device=None):
    """Fixed-shape per-layer KV buffers [B, H, cap, D]; capacity rounds
    up to a multiple of 128 as in the JAX package (the tail is masked by
    position)."""
    cap = -(-int(max_len) // 128) * 128
    return [(torch.zeros(batch, num_heads, cap, head_dim, dtype=dtype,
                         device=device),
             torch.zeros(batch, num_heads, cap, head_dim, dtype=dtype,
                         device=device))
            for _ in range(num_layers)]


def gumbel_noise(shape, generator, device):
    """f32 Gumbel(0, 1) noise as `jax.random.gumbel` draws it: uniforms on
    [tiny, 1) (so no value is infinite), then -log(-log(u))."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample(logits, noise, do_sample, temperature, top_k):
    """JAX `_sample` as a function of the logits [B, V] and f32 Gumbel
    noise [B, V] (None when greedy): [B] int32 next tokens.  The logits
    go to f32; greedy takes their argmax.  Sampling divides by max(T,
    1e-6) where T != 1, keeps every logit >= the k-th largest (ties
    included; top_k clamped to V, 0 keeps all) and sets the rest to
    -1e30, then takes argmax(logits + noise), which is what
    `jax.random.categorical` computes from its own Gumbel draw."""
    logits = logits.float()
    if not do_sample:
        return logits.argmax(-1).to(torch.int32)
    if temperature != 1.0:
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by the reciprocal instead
        logits = logits / torch.full_like(logits,
                                          max(float(temperature), 1e-6))
    if top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    return (logits + noise).argmax(-1).to(torch.int32)


def sample(logits, do_sample, temperature, top_k, generator):
    """`_sample` with the noise drawn from `generator` ([B, V] f32,
    one draw a call; none when greedy)."""
    noise = gumbel_noise(logits.shape, generator, logits.device) \
        if do_sample else None
    return _sample(logits, noise, do_sample, temperature, top_k)


def _top(x, n):
    """The n largest of each row of x [B, M] and their indices, equal
    values in index order (as `jax.lax.top_k`): a stable descending
    sort, not `torch.topk`, which fixes no order for ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _left_pad_starts(attention_mask, b, s0):
    """[B] first real position per row of a LEFT-padded 0/1 mask."""
    mh = np.asarray(attention_mask.cpu() if isinstance(
        attention_mask, torch.Tensor) else attention_mask).astype(np.int32)
    if mh.shape != (b, s0):
        raise ValueError(f"attention_mask must be [B, S0]={b, s0}, got "
                         f"{tuple(mh.shape)}")
    if not (mh[:, -1] == 1).all():
        raise ValueError(
            "attention_mask must be LEFT-padded (last column all ones): "
            "right padding would put a pad token at the next-token "
            "prediction position")
    starts = mh.argmax(axis=1)
    if not ((np.arange(s0)[None, :] >= starts[:, None])
            == mh.astype(bool)).all():
        raise ValueError("attention_mask must be contiguous left padding "
                         "(zeros then ones per row)")
    return starts


class _Generation:
    """A model's `generate()` state: the lock that serializes its calls,
    its current `_ChunkState` and its current `_BeamState` (None before
    the first call of each)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.state = None
        self.beam = None


# model -> its _Generation; weak, so a dropped model frees its caches
# and graphs (nothing here refers back to the model)
_GENERATIONS = weakref.WeakKeyDictionary()
_GENERATIONS_LOCK = threading.Lock()


def _generation(model) -> _Generation:
    with _GENERATIONS_LOCK:
        return _GENERATIONS.setdefault(model, _Generation())


class _ChunkState:
    """What the decode-chunk programs of one (batch, capacity) signature
    of a model hold, at fixed addresses on its device: the KV caches,
    the carried token `tok` [B], the left-pad starts `start` [B], the
    `finished` flags [B] and the chunk's first position `pos0` (0-dim),
    the programs by (n, has_mask, eos, sampling rule, generator), the
    generator that `seed=n` seeds (made at the first seeded call), and on
    a CUDA device the memory pool their graphs share.  `bound` is what
    the graphs hold of the model's parameters and buffers."""

    def __init__(self, key, caches, b, bound, device):
        self.key, self.caches, self.bound = key, caches, bound
        self.tok = torch.zeros(b, dtype=torch.int32, device=device)
        self.start = torch.zeros(b, dtype=torch.int32, device=device)
        self.finished = torch.zeros(b, dtype=torch.bool, device=device)
        self.pos0 = torch.zeros((), dtype=torch.int32, device=device)
        self.programs = {}
        self.generator = None
        self.pool = None


class _ChunkProgram:
    """One decode chunk of n steps under a sampling rule (do_sample,
    temperature, top_k) and the generator it draws from (None when
    greedy): its outputs toks [B, n] (int32) and fin [n] (every row
    finished after step j), and on a CUDA device its graph."""

    def __init__(self, b, n, device, rule=(False, 1.0, 0), generator=None):
        self.n, self.rule, self.generator = n, rule, generator
        self.toks = torch.zeros(b, n, dtype=torch.int32, device=device)
        self.fin = torch.zeros(n, dtype=torch.bool, device=device)
        self.graph = None


class _BeamState:
    """What the beam step of one (batch, beams, capacity) signature of a
    model holds at fixed addresses: the caches of B * N rows (beam i of
    row b at b * N + i), the live beams' tokens `tok`, running log-prob
    `scores`, generated `lengths` (f32) and the step's `parent` [B, N],
    the finished pool `fin_norm` / `fin_step` / `fin_beam` [B], the
    step's cache position `pos` and index `step` (0-dim, advanced by the
    step itself), the step graphs by (eos, length_penalty), and on a
    CUDA device their memory pool.  `bound` as `_ChunkState`'s."""

    def __init__(self, key, caches, b, n, bound, device):
        self.key, self.caches, self.bound = key, caches, bound

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tok, self.parent = zeros(b, n), zeros(b, n)
        self.scores = zeros(b, n, dtype=torch.float32)
        self.lengths = zeros(b, n, dtype=torch.float32)
        self.fin_norm = zeros(b, dtype=torch.float32)
        self.fin_step, self.fin_beam = zeros(b), zeros(b)
        self.pos, self.step = zeros(), zeros()
        self.programs = {}
        self.pool = None


class GenerationMixin:
    """Mixed into *ForCausalLM models that implement
    `init_kv_caches(batch, max_len)` and
    `forward(ids, kv_caches=, cache_pos=, attn_start=) -> (logits,
    caches)`, and expose `device`.

    `generate()` keeps one (batch, capacity) signature's caches and
    decode-chunk programs per model, and one beam signature's (a call at
    another signature frees the older one's first), so calls of one
    model do not overlap: a lock of the model's serializes them."""

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, eos_token_id=None, seed=None,
                 attention_mask=None, num_beams=1, length_penalty=1.0):
        """input_ids [B, S0] ints (tensor or array).  Returns int32 [B, S0
        + n_generated] on the model's device.  Greedy unless `do_sample`
        (`_sample`: temperature, top_k, noise from the generator of
        `seed`).  With eos_token_id, finished rows repeat eos and the loop
        stops once every row has finished (checked once per chunk, then
        trimmed to the step where it happened).  attention_mask: optional
        [B, S0] 0/1 mask for LEFT-padded prompts.  num_beams > 1 is beam
        search (greedy scoring; finished hypotheses kept in a pool, the
        best length_penalty-normalised one wins; not with do_sample or
        attention_mask)."""
        dev = self.device
        gen = _generation(self)
        with gen.lock, torch.inference_mode():
            ids = torch.as_tensor(np.asarray(input_ids.cpu())
                                  if isinstance(input_ids, torch.Tensor)
                                  else np.asarray(input_ids))
            ids = ids.to(device=dev, dtype=torch.int32)
            b, s0 = ids.shape
            if max_new_tokens <= 0:
                return ids
            if num_beams > 1:
                if do_sample:
                    raise ValueError("beam search with do_sample is not "
                                     "supported; use num_beams=1 for "
                                     "sampling")
                if attention_mask is not None:
                    raise ValueError("beam search over left-padded ragged "
                                     "batches is not supported yet")
            start = None
            if attention_mask is not None:
                start = torch.as_tensor(
                    _left_pad_starts(attention_mask, b, s0),
                    dtype=torch.int32).to(dev)
            was_training = self.training
            self.eval()
            try:
                if num_beams > 1:
                    return self._beam_search(gen, ids, max_new_tokens,
                                             num_beams, eos_token_id,
                                             float(length_penalty))
                rule = (bool(do_sample), float(temperature), int(top_k))
                return self._generate(gen, ids, max_new_tokens, rule, seed,
                                      eos_token_id, start)
            finally:
                if was_training:
                    self.train()

    def _generate(self, gen, ids, max_new_tokens, rule, seed, eos_token_id,
                  start):
        """Greedy or sampled decoding (rule = (do_sample, temperature,
        top_k)): the prefill eagerly, then the chunk programs."""
        b, s0 = ids.shape
        st = self._chunk_state(gen, b, s0 + max_new_tokens)
        generator = None
        if rule[0]:
            if seed is None:
                generator = rng.generator(self.device)
            else:
                if st.generator is None:
                    st.generator = torch.Generator(device=self.device)
                generator = st.generator
                generator.manual_seed(int(seed))
        # the prefill runs eagerly, once a call (JAX `_gen_programs`),
        # into the programs' caches
        logits, _ = self(ids, kv_caches=st.caches, cache_pos=0,
                         attn_start=start)
        tok = sample(logits[:, -1], *rule, generator)
        st.tok.copy_(tok)
        if start is not None:
            st.start.copy_(start)
        if eos_token_id is None:
            st.finished.zero_()
            chunk = max(1, min(max_new_tokens - 1, 128))
        else:
            st.finished.copy_(tok == eos_token_id)
            chunk = DECODE_CHUNK
        out, fins = [tok[:, None]], [st.finished.all()[None]]
        i = 1
        while i < max_new_tokens:
            if eos_token_id is not None and bool(st.finished.all()):
                break
            n = min(chunk, max_new_tokens - i)
            st.pos0.fill_(s0 + i - 1)
            prog = self._chunk_program(st, n, start is not None,
                                       eos_token_id, rule, generator)
            self._run_decode_chunk(st, prog, start is not None,
                                   eos_token_id)
            # clones: the next chunk rewrites the buffers
            out.append(prog.toks.clone())
            fins.append(prog.fin.clone())
            i += n
        gen_toks = torch.cat(out, dim=1)
        if eos_token_id is not None and gen_toks.shape[1] > 1:
            # the per-token loop stops BEFORE step j + 1 when every row
            # had finished after step j: keep j + 1 tokens
            hits = np.flatnonzero(torch.cat(fins).cpu().numpy())
            if hits.size:
                gen_toks = gen_toks[:, :int(hits[0]) + 1]
        return torch.cat([ids, gen_toks], dim=1)

    def _bound(self) -> tuple:
        """What a graph of `generate()` holds of the model's parameters
        and buffers."""
        return GR.addresses(list(self.parameters()) + list(self.buffers()))

    def _chunk_state(self, gen, b, max_len) -> "_ChunkState":
        """The caches and carried tensors of the (b, capacity) signature
        of `max_len` tokens: `gen`'s current ones, or new ones (the
        older signature's caches and graphs freed first).  Parameters or
        buffers rebound since the state was made drop it too: its graphs
        hold their addresses."""
        cap = -(-int(max_len) // 128) * 128
        bound = self._bound()
        st = gen.state
        if st is None or st.key != (b, cap) or st.bound != bound:
            gen.state = st = None
            gen.state = _ChunkState((b, cap), self.init_kv_caches(b, cap), b,
                                    bound, self.device)
        return gen.state

    def _decode_chunk_body(self, st, prog, has_mask, eos_token_id):
        """The body of `_decode_chunk_program`: prog.n steps from st.tok
        at positions st.pos0 + j over st.caches (in place), each step's
        tokens (`sample` under prog's rule and generator) into
        prog.toks[:, j] and whether every row has finished into
        prog.fin[j]; st.tok and st.finished carry the last step's.
        Finished rows keep emitting eos."""
        tok, finished = st.tok, st.finished
        start = st.start if has_mask else None
        for j in range(prog.n):
            logits, _ = self(tok[:, None], kv_caches=st.caches,
                             cache_pos=st.pos0 + j, attn_start=start)
            tok = sample(logits[:, -1], *prog.rule, prog.generator)
            if eos_token_id is not None:
                tok = torch.where(finished, eos_token_id, tok)
                finished = finished | (tok == eos_token_id)
            prog.toks[:, j] = tok
            prog.fin[j] = finished.all()
        st.tok.copy_(tok)
        st.finished.copy_(finished)

    def _chunk_program(self, st, n, has_mask, eos_token_id,
                       rule=(False, 1.0, 0), generator=None):
        """`_decode_chunk_program`: st's program of the key (n, has_mask,
        eos, rule, generator) (the batch and capacity are st's), made at
        its first use."""
        key = (n, has_mask, eos_token_id, rule, generator)
        if key not in st.programs:
            st.programs[key] = _ChunkProgram(st.tok.shape[0], n,
                                             self.device, rule, generator)
        return st.programs[key]

    def _run_decode_chunk(self, st, prog, has_mask, eos_token_id) -> None:
        """One chunk of prog.n decode steps from st's carried tensors;
        prog.toks / prog.fin hold its results."""
        if self.device.type == "cpu":
            self._decode_chunk_body(st, prog, has_mask, eos_token_id)
        else:
            self._replay_chunk(st, prog, has_mask, eos_token_id)

    def _replay_chunk(self, st, prog, has_mask, eos_token_id) -> None:
        """The CUDA path of `_run_decode_chunk`: the program's graph
        replayed, or at the first chunk of its key the body run eagerly
        on the capture stream (this chunk's result) and then captured in
        the state's pool, timed as `decode_chunk_n{n}` (``_sample`` added
        for a sampling one; the JAX package does not time its chunk
        programs).  A sampling graph registers its generator, so every
        replay draws the next numbers.  A failed capture raises."""
        if prog.graph is not None:
            prog.graph.replay()
            return
        body = functools.partial(self._decode_chunk_body, st, prog, has_mask,
                                 eos_token_id)
        stream = GR.capture_stream(self.device)
        if st.pool is None:
            st.pool = torch.cuda.graph_pool_handle()
        label = f"decode_chunk_n{prog.n}" + ("_sample" if prog.rule[0]
                                             else "")
        _, prog.graph = GR.capture(
            body, stream, label, pool=st.pool,
            generators=() if prog.generator is None else (prog.generator,))

    # ---- beam search ----
    def _beam_state(self, gen, b, n, max_len) -> "_BeamState":
        """The beam step's tensors of the (b, n, capacity) signature of
        `max_len` tokens: `gen`'s current ones or new ones, as
        `_chunk_state`."""
        cap = -(-int(max_len) // 128) * 128
        bound = self._bound()
        st = gen.beam
        if st is None or st.key != (b, n, cap) or st.bound != bound:
            gen.beam = st = None
            gen.beam = _BeamState((b, n, cap),
                                  self.init_kv_caches(b * n, cap), b, n,
                                  bound, self.device)
        return gen.beam

    @staticmethod
    def _beam_pool_update(st, step, tok, scores, length_penalty, eos_id):
        """JAX `pool_update`: each row's best hypothesis that just emitted
        eos (by score / max(length, 1) ** length_penalty) replaces the
        row's finished one where it is better, and its beam leaves the
        search (score -1e30).  Returns the new scores."""
        done = tok == eos_id
        norm = scores / st.lengths.clamp(min=1.0) ** length_penalty
        cand = torch.where(done, norm, float("-inf"))
        best_c = cand.argmax(dim=1)
        best_v = cand.gather(1, best_c[:, None])[:, 0]
        better = best_v > st.fin_norm
        st.fin_norm.copy_(torch.where(better, best_v, st.fin_norm))
        st.fin_step.copy_(torch.where(better, step, st.fin_step))
        st.fin_beam.copy_(torch.where(better, best_c.to(torch.int32),
                                      st.fin_beam))
        return torch.where(done, NEG_INF, scores)

    def _beam_step_body(self, st, eos_id, length_penalty) -> None:
        """One beam step (JAX `beam_step`) at st.pos: score every
        continuation of every live beam, keep the N best of each row
        (`_top`), reorder the caches by parent, extend the lengths, move
        what emitted eos into the pool, and advance st.pos and st.step.
        Everything in place, at fixed shapes."""
        b, n = st.tok.shape
        logits, _ = self(st.tok.reshape(b * n, 1), kv_caches=st.caches,
                         cache_pos=st.pos)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        v = logp.shape[-1]
        total = st.scores[:, :, None] + logp.reshape(b, n, v)
        scores, flat = _top(total.reshape(b, n * v), n)
        parent = torch.div(flat, v, rounding_mode="floor")
        tok = (flat % v).to(torch.int32)
        rows = (torch.arange(b, device=flat.device)[:, None] * n
                + parent).reshape(-1)
        for kb, vb in st.caches:
            kb.copy_(kb.index_select(0, rows))
            vb.copy_(vb.index_select(0, rows))
        st.lengths.copy_(st.lengths.gather(1, parent) + 1.0)
        if eos_id is not None:
            scores = self._beam_pool_update(st, st.step, tok, scores,
                                            length_penalty, eos_id)
        st.tok.copy_(tok)
        st.scores.copy_(scores)
        st.parent.copy_(parent)
        st.pos.add_(1)
        st.step.add_(1)

    def _run_beam_step(self, st, eos_id, length_penalty) -> None:
        """One beam step from st's tensors, in place."""
        if self.device.type == "cpu":
            self._beam_step_body(st, eos_id, length_penalty)
        else:
            self._replay_beam(st, eos_id, length_penalty)

    def _replay_beam(self, st, eos_id, length_penalty) -> None:
        """The CUDA path of `_run_beam_step`: the graph of (eos,
        length_penalty) replayed, or at its first step the body run on
        the capture stream (this step's result) and captured in the
        state's pool, as ``beam_step_b{b}_n{n}``.  A failed capture
        raises."""
        graph = st.programs.get((eos_id, length_penalty))
        if graph is not None:
            graph.replay()
            return
        b, n = st.tok.shape
        body = functools.partial(self._beam_step_body, st, eos_id,
                                 length_penalty)
        stream = GR.capture_stream(self.device)
        if st.pool is None:
            st.pool = torch.cuda.graph_pool_handle()
        _, st.programs[(eos_id, length_penalty)] = GR.capture(
            body, stream, f"beam_step_b{b}_n{n}", pool=st.pool)

    def _beam_search(self, gen, ids, max_new_tokens, num_beams, eos_id,
                     length_penalty):
        """JAX `_beam_search`: the prefill at batch B, its N best first
        tokens, then max_new_tokens - 1 beam steps; the host backtracks
        each row's winner (the best finished hypothesis, or the best live
        beam where it scores at least as well)."""
        b, s0 = ids.shape
        n, steps = num_beams, max_new_tokens
        st = self._beam_state(gen, b, n, s0 + max_new_tokens)
        caches = self.init_kv_caches(b, st.key[2])
        logits, caches = self(ids, kv_caches=caches, cache_pos=0)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        scores, tok = _top(logp, n)
        for (kb, vb), (k1, v1) in zip(st.caches, caches):
            kb.copy_(k1.repeat_interleave(n, dim=0))
            vb.copy_(v1.repeat_interleave(n, dim=0))
        del caches
        st.lengths.fill_(1.0)                 # one generated token so far
        st.fin_norm.fill_(float("-inf"))
        st.fin_step.zero_()
        st.fin_beam.zero_()
        tok = tok.to(torch.int32)
        if eos_id is not None:
            scores = self._beam_pool_update(st, 0, tok, scores,
                                            length_penalty, eos_id)
        st.tok.copy_(tok)
        st.scores.copy_(scores)
        st.pos.fill_(s0)
        st.step.fill_(1)
        toks = [tok]
        parents = [torch.arange(n, dtype=torch.int32,
                                device=tok.device).expand(b, n)]
        for _ in range(steps - 1):
            self._run_beam_step(st, eos_id, length_penalty)
            # clones: the next step rewrites the buffers
            toks.append(st.tok.clone())
            parents.append(st.parent.clone())
        live_norm = st.scores / st.lengths.clamp(min=1.0) ** length_penalty
        live_best = live_norm.argmax(dim=1)
        live_val = live_norm.gather(1, live_best[:, None])[:, 0]
        use_fin = st.fin_norm >= live_val
        sel_step = torch.where(use_fin, st.fin_step, steps - 1).cpu().numpy()
        sel_beam = torch.where(use_fin, st.fin_beam,
                               live_best.to(torch.int32)).cpu().numpy()
        toks_all = torch.stack(toks).cpu().numpy()          # [steps, B, N]
        parents_all = torch.stack(parents).cpu().numpy()
        # rows whose winner finished at sel_step keep an eos-filled tail
        out = np.full((b, steps), eos_id if eos_id is not None else 0,
                      np.int32)
        beam = sel_beam.copy()
        rows = np.arange(b)
        for t in range(steps - 1, -1, -1):
            take = t <= sel_step
            out[take, t] = toks_all[t][rows[take], beam[take]]
            beam[take] = parents_all[t][rows[take], beam[take]]
        return torch.cat([ids, torch.from_numpy(out).to(ids.device)], dim=1)
