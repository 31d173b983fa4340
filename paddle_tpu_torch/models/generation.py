"""Auto-regressive generation over static and paged KV caches.

Counterpart of ``paddle_tpu/models/generation.py``: the attention bodies
the model families call with a cache (`_static_cache_attention`,
`_paged_cache_attention`), position helpers, `init_kv_caches`, and greedy
`generate()`.  The caches are written IN PLACE (the JAX functions
return updated buffers; here the returned buffers are the same
tensors).  `generate()` runs its prefill eagerly and its decode as the
JAX package's `_decode_chunk_program`: chunks of up to `DECODE_CHUNK`
steps, each one fixed-shape program per (n, batch, capacity, mask,
eos) over caches and carried tensors that the model keeps for its last
(batch, capacity); on a CUDA device each program is a CUDA graph
(`core.graphs`).  Attention
runs through the port's kernels: `flash_fwd` for prefill (causal, with
a pad-key bias for left-padded rows), `decode_attention` for the
dense decode step, `paged_attention` for the engine's paged step (its
int8 kernel under the quantized KV tier).

Sampling and beam search are not ported yet (ROADMAP Queue A5).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref

import numpy as np
import torch

from ..core import graphs as GR
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
    """A model's `generate()` state: the lock that serializes its calls
    and its current `_ChunkState` (None before the first call)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.state = None


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
    the programs by (n, has_mask, eos), and on a CUDA device the memory
    pool their graphs share.  `bound` is what the graphs hold of the
    model's parameters and buffers."""

    def __init__(self, key, caches, b, bound, device):
        self.key, self.caches, self.bound = key, caches, bound
        self.tok = torch.zeros(b, dtype=torch.int32, device=device)
        self.start = torch.zeros(b, dtype=torch.int32, device=device)
        self.finished = torch.zeros(b, dtype=torch.bool, device=device)
        self.pos0 = torch.zeros((), dtype=torch.int32, device=device)
        self.programs = {}
        self.pool = None


class _ChunkProgram:
    """One decode chunk of n steps: its outputs toks [B, n] (int32) and
    fin [n] (every row finished after step j), and on a CUDA device its
    graph."""

    def __init__(self, b, n, device):
        self.n = n
        self.toks = torch.zeros(b, n, dtype=torch.int32, device=device)
        self.fin = torch.zeros(n, dtype=torch.bool, device=device)
        self.graph = None


class GenerationMixin:
    """Mixed into *ForCausalLM models that implement
    `init_kv_caches(batch, max_len)` and
    `forward(ids, kv_caches=, cache_pos=, attn_start=) -> (logits,
    caches)`, and expose `device`.

    `generate()` keeps one (batch, capacity) signature's caches and
    decode-chunk programs per model (a call at another signature frees
    them first), so calls of one model do not overlap: a lock of the
    model's serializes them."""

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 eos_token_id=None, attention_mask=None, num_beams=1):
        """Greedy decoding.  input_ids [B, S0] ints (tensor or array).
        Returns int32 [B, S0 + n_generated] on the model's device.  With
        eos_token_id, finished rows repeat eos and the loop stops once
        every row has finished (checked once per chunk, then trimmed to
        the step where it happened).  attention_mask: optional [B, S0]
        0/1 mask for LEFT-padded prompts."""
        if do_sample or num_beams > 1:
            raise NotImplementedError(
                "sampling and beam search are not ported yet (ROADMAP "
                "Queue A5); paddle_tpu_torch generate() is greedy")
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
            start = None
            if attention_mask is not None:
                start = torch.as_tensor(
                    _left_pad_starts(attention_mask, b, s0),
                    dtype=torch.int32).to(dev)
            was_training = self.training
            self.eval()
            try:
                st = self._chunk_state(gen, b, s0 + max_new_tokens)
                # the prefill runs eagerly, once a call (JAX
                # `_gen_programs`), into the programs' caches
                logits, _ = self(ids, kv_caches=st.caches, cache_pos=0,
                                 attn_start=start)
                tok = logits[:, -1].float().argmax(-1).to(torch.int32)
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
                                               eos_token_id)
                    self._run_decode_chunk(st, prog, start is not None,
                                           eos_token_id)
                    # clones: the next chunk rewrites the buffers
                    out.append(prog.toks.clone())
                    fins.append(prog.fin.clone())
                    i += n
                gen = torch.cat(out, dim=1)
                if eos_token_id is not None and gen.shape[1] > 1:
                    # the per-token loop stops BEFORE step j + 1 when every
                    # row had finished after step j: keep j + 1 tokens
                    hits = np.flatnonzero(torch.cat(fins).cpu().numpy())
                    if hits.size:
                        gen = gen[:, :int(hits[0]) + 1]
                return torch.cat([ids, gen], dim=1)
            finally:
                if was_training:
                    self.train()

    def _chunk_state(self, gen, b, max_len) -> "_ChunkState":
        """The caches and carried tensors of the (b, capacity) signature
        of `max_len` tokens: `gen`'s current ones, or new ones (the
        older signature's caches and graphs freed first).  Parameters or
        buffers rebound since the state was made drop it too: its graphs
        hold their addresses."""
        cap = -(-int(max_len) // 128) * 128
        bound = GR.addresses(list(self.parameters()) + list(self.buffers()))
        st = gen.state
        if st is None or st.key != (b, cap) or st.bound != bound:
            gen.state = st = None
            gen.state = _ChunkState((b, cap), self.init_kv_caches(b, cap), b,
                                    bound, self.device)
        return gen.state

    def _decode_chunk_body(self, st, prog, has_mask, eos_token_id):
        """The body of `_decode_chunk_program`: prog.n greedy steps from
        st.tok at positions st.pos0 + j over st.caches (in place), each
        step's tokens into prog.toks[:, j] and whether every row has
        finished into prog.fin[j]; st.tok and st.finished carry the last
        step's.  Finished rows keep emitting eos."""
        tok, finished = st.tok, st.finished
        start = st.start if has_mask else None
        for j in range(prog.n):
            logits, _ = self(tok[:, None], kv_caches=st.caches,
                             cache_pos=st.pos0 + j, attn_start=start)
            tok = logits[:, -1].float().argmax(-1).to(torch.int32)
            if eos_token_id is not None:
                tok = torch.where(finished, eos_token_id, tok)
                finished = finished | (tok == eos_token_id)
            prog.toks[:, j] = tok
            prog.fin[j] = finished.all()
        st.tok.copy_(tok)
        st.finished.copy_(finished)

    def _chunk_program(self, st, n, has_mask, eos_token_id):
        """`_decode_chunk_program`: st's program of the key (n, has_mask,
        eos) (the batch and capacity are st's), made at its first use."""
        key = (n, has_mask, eos_token_id)
        if key not in st.programs:
            st.programs[key] = _ChunkProgram(st.tok.shape[0], n, self.device)
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
        the state's pool, timed as `decode_chunk_n{n}` (the JAX package
        does not time its chunk programs).  A failed capture raises."""
        if prog.graph is not None:
            prog.graph.replay()
            return
        body = functools.partial(self._decode_chunk_body, st, prog, has_mask,
                                 eos_token_id)
        stream = GR.capture_stream(self.device)
        if st.pool is None:
            st.pool = torch.cuda.graph_pool_handle()
        _, prog.graph = GR.capture(body, stream, f"decode_chunk_n{prog.n}",
                                   pool=st.pool)
