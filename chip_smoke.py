#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`paddle_tpu_torch`) on one card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # + torch.profiler breakdowns of
                                     #   the engine's decode step (and
                                     #   its paged kernel's device ms a
                                     #   launch and share), of cold
                                     #   prefills at S1008 and S48, of
                                     #   one GPT train step, of one
                                     #   batch of each vision model
                                     #   (under to_static) and of one
                                     #   Swin-T train step

Phases (one line per phase, seconds included; any failure exits
non-zero and prints no result):

  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: every CUDA kernel with nvcc for sm_90a, one nvcc per source
     (ten), all started together; registers and spills per source, per
     bf16 and f16 tensor-core kernel, per fused-norm vector kernel and
     per decode kernel on a cluster, each with its element type (a spill
     fails: flash at head dims up to 128, every conv tile and window
     tile, forward and backward, every register-held norm kernel, every
     paged / dense / int8 decode kernel, in every type);
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, in bf16 and f32 (and in float16 at its main shape:
     `f16_cases`, within 1e-2), with its time, the plain version's,
     one PyTorch library call's where one computes the same function,
     and the roofline bound (rope and its adjoint at the llama_7b
     prefill q, a ragged per-row-phase decode, the 70B-width GQA k and
     q and k of a llama_7b layer in one call at the prefill and the
     decode step, each bit for bit its plain version, with profiled
     device times;
     conv_bn_act and window_attention at every distinct shape that one
     bf16 forward of ResNet-50, MobileNetV2 and Swin-T at batch 64 gives
     them, recorded from that forward, and each kernel's summed time per
     model forward; window_attention_bwd at every distinct shape one bf16
     Swin-T train step at batch 128 gives it, recorded from that step,
     dqkv and dbias each held relative to its largest reference
     gradient, and its summed time per step);
  4. serve: gpt_1p3b (full width, 24 layers, bf16, seeded random
     weights) behind `InferenceEngine` with the default EngineConfig;
     8 requests at once, three sharing a 512-token prefix (warm
     prefill), served twice with the prefix cache cleared in between;
     every request must finish with 32 tokens and both rounds give the
     same streams; the decode step replays one captured CUDA graph, and
     each prefill bucket's program (cold, or warm per prefix bucket:
     the prefill and its pack) runs eagerly at its first prefill in the
     first round, is captured then and replayed after it (the model's
     forward runs only for that first run and the capture); TTFT p50 and max, tokens/s and the
     mean prefill wall by bucket of each round, the engine's peak and
     reserved memory; then 4 decode steps of every slot through the
     replay and through the eager body from equal copies of the pools
     give equal tokens and bit-identical pools, and each prefill program
     replayed and run eagerly on the same inputs gives the same first
     token and pools (scratch page 0 left out: garbage by design);
 4b. http_serve: the same model behind `InferenceServer` (POST
     /generate over HTTP on 127.0.0.1): (a) with the prefix cache off,
     the 8 requests x 32 tokens through `engine.submit` in the process
     and as 8 concurrent `InferenceClient` streams, bit for bit, each
     stream its final record; (b) with the default config, after a
     round that captures the prefill programs, the 8 requests in the
     process and over HTTP, twice in turns: client-side TTFT p50 / p95,
     inter-token gap p50 / p99, tokens/s; (c) `tools/loadgen.py` (loaded
     by its path) fires an open-loop Poisson schedule, 4 tenants over
     512-token system prompts and 16-488-token suffixes, 32-token
     streams, 4 a second for 10 s: no admitted failure, 32 tokens in
     every ok stream; (d) /health and /ready carry the engine's stats,
     /metrics renders, 20 polls of /metrics and /ready launch no kernel,
     the lifecycle record names the captured programs (decode_n1,
     prefill_s*, cprefill_s*_p*) with their warm-up and capture ms, a
     queue_depth=0 server with 4 streams running sheds a fifth with 429
     and Retry-After, a client that disconnects mid-stream is cancelled,
     and the engine ends drained; flash_fwd, paged_attention (and rope)
     launched once a layer per prefill and decode step;
  5. generate: greedy `generate()` on the same model, an equal-length
     batch (causal flash_fwd) and a left-padded one (causal flash_fwd
     with a pad bias, then decode_attention), each call a prefill and a
     31-step decode-chunk program (a CUDA graph, captured at its first
     run); a second call replays it, equal bit for bit to the first and
     to the per-token eager loop at host positions; tokens/s and decode
     ms a step on a call after a warm-up; bf16 logits against the f32
     upcast of the same weights;
 5a. sample_beam: `generate()` sampling and beam search on gpt_1p3b at
     full width with an untied head (a random model with the preset's
     tied N(0, 1) embedding repeats its last token), bf16: do_sample,
     temperature 0.8, top_k 50, one seed, B4 x 128 + 64 twice (the same
     tokens, tokens/s of the second call, decode_attention 24 a step);
     top_k=1 against greedy (equal, or apart only at an exact tie at the
     top of that step's logits); num_beams=4 at B2 x 128 + 32 twice
     (tokens/s; the beam step a CUDA graph, its replay == its eager body
     bit for bit over 57 state tensors); at 2 layers in f32: every
     sampled token in the top-50 of its step's teacher-forced logits,
     ties included, and the card's beams (with an eos) equal to the
     CPU port's on the same weights (or the two winners' CPU scores
     within 1e-3);
 5b. spec_serve: speculative decoding at gpt_1p3b full width, bf16,
     spec_tokens=4, the 8 requests of phase 4 x 64 tokens served twice:
     an agreeing 2-layer draft (bench.py's: the target's first two
     layers, its other blocks' out_proj / down_proj zeroed; >= 90% of the
     proposals accepted, its spec graph replay == eager body bit for
     bit) and an independent seeded 2-layer draft with an untied head;
     acceptance, tokens/s, ms a pass, paged_attention exactly 2 * (k +
     1) + 24 a pass; the non-spec engine's tokens/s beside them;
  6. parity: gpt_1p3b widths at 2 layers in f32, the 8 prompts of phase
     4 (two warm prefills) — engine streams must equal generate()
     streams (a divergence passes only at a top-2 logit margin below
     1e-3, and is reported); the replay against the eager body as in
     phase 4, in f32;
 6a. tiers_parity: the same widths and prompts in f32: the int8-weight
     engine against `generate()` over its `effective_params()`, the spec
     engine (k=3; a tied 1-layer draft, accepted, and an untied one,
     rejected) against the non-spec engine on both KV tiers, by phase
     6's near-tie rule; the int8-weight decode and prefill graphs, the
     spec graphs and the draft's prefill graphs replayed == their eager
     bodies bit for bit; int8 weights + int8 KV + spec run twice, bit
     for bit;
  7. train_parity: GPT-125M widths (hidden 768, 12 heads, vocab 50304)
     at 2 layers in f32, batch 2 x 256, one seed: 3 AdamW steps on the
     card through the kernels and the same 3 on the CPU through the
     plain versions; the losses agree within 1e-3; then 3 more steps
     replayed against 3 eager bodies from equal copies of the state:
     losses, parameters, slots and buffers bit for bit (f32);
  8. train: GPT-125M at full width and depth (12 layers, seq 1024),
     f32 master weights, bf16 AMP, fused head + CE, AdamW lr 1e-4, batch
     8 on one fixed batch (bench.py's step): 2 warm-up steps, then
     `run_steps(repeat=10)` timed between synchronizes: tokens/s, ms per
     step, MFU against the 989 TFLOP/s bf16 peak, peak memory, launches
     per step.  The loss must stay finite and fall; the first call ran
     the model's forward and every later one replayed the step's graph;
     then `run_steps(repeat=10)` replayed against 10 eager bodies from
     equal copies of the state, bit for bit (bf16);
 8a. kv_layout_parity: GPT-125M widths at 2 layers in f32, batch 2 x
     256: 3 AdamW steps under FLAGS_flash_layout=kv and 3 on the native
     tier from the same weights; losses and every parameter after the
     steps bit-identical; 2 + 2 relayout launches per layer per step;
     then (kv_layout_parity_f16) the same with amp_dtype="float16": the
     f16 relayouts and head-major flash kernels, bit for bit the native
     tier's f16 steps;
 8b. train_kv_layout: phase 8 under FLAGS_flash_layout=kv (the `kv`
     layout tier: relayouts around the head-major flash kernels), with
     exactly 24 relayout_to_hm + 24 relayout_from_hm per step;
  9. llama_serve: llama_7b (hidden 4096, 32 layers, 32 heads of 128, ffn
     11008, vocab 32000, untied head) in bf16 with seeded weights, as
     phase 4: 8 requests x 32 tokens, twice, >= 2 prefix hits a round,
     rope launched 32 times per model forward (q and k of a layer in
     one launch);
 9a. llama_serve_int8: the same model and requests behind
     EngineConfig(kv_precision="int8"): int8 page pools with f32 scales,
     paged_attention_int8 launched 32 times per decode forward and the
     bf16 paged_attention never; page bytes of both tiers; phase 4's
     graph checks (the prefill programs' staging buffers of the exact
     page copies too);
 9b. llama_http_serve: (a) and (b) of phase 4b on llama_7b, the exact
     tier, rope launched once a layer per prefill and decode step;
 9c. weight_tiers: llama_7b bf16 behind the exact tier,
     weight_precision="int8" and "bf16" in turns, phase 9's requests
     twice each: tokens/s and TTFT p50 of the replayed round, the decode
     step's profiled device time (4 live slots); the int8 store (codes
     and scales) against the same weights in bf16; the peak memory the
     decode graph's warm-up and capture add (int8: under a quarter of
     the model's bf16 weights: each weight is dequantized where it is
     used); the bf16 tier's streams equal the exact tier's; the int8
     decode and prefill graphs replayed == their eager bodies;
 10. llama_generate: as phase 5 on llama_7b (the f32 copy at full depth);
 10a. llama_f16: the same llama_7b cast in place to float16 (`_cast16`):
     each of phase 4's prompts alone through greedy generate()
     (llama_f16_refs); over those streams, the largest |logit| and its
     f16 ulp at each step, the smallest top-2 margin, and the largest
     gap between generate()'s decode route's logits and one full
     forward's, in ulps, which must stay under half NEAR_TIE_ULPS
     (llama_f16_ties); then phase 9 (llama_f16_serve) and phase 9a
     (llama_f16_serve_int8: f16 queries over int8 pages) on it, the
     replayed round's streams held to those sequential streams by the
     near-tie rule, NEAR_TIE_ULPS ulps of the step's largest |logit|
     (every token on the exact tier, the first on the int8 tier, where
     each stream's equal length is logged), and phase 10
     (llama_f16_generate); every kernel of the path in float16;
 11. llama_parity: llama2_70b_shapes widths (hidden 8192, 64 heads over 8
     kv heads, ffn 28672) at 2 layers in f32, as phase 6: a GQA group of
     8 through paged_attention, decode_attention and flash_fwd;
 11a. int8_parity: the same widths under kv_precision="int8": two
     engine runs bit-identical, the replay against the eager body as in
     phase 4 (f32), every first token equal to the exact
     engine's, the card's int8 codec bit for bit the CPU's on one dense
     K buffer, and every page a 1000-token prefill packs, dequantized,
     within absmax / 127 of its dense rows;
 12. llama_train_parity: llama_7b widths at 1 layer in f32, batch 1 x
     128: 3 AdamW steps with `LlamaPretrainingCriterion` on the card
     (rope and its adjoint, flash_fwd and flash_bwd at D=128) and on the
     CPU; the losses agree within 1e-3;
 13. vision_parity: ResNet-50, MobileNetV2 and Swin-T (224x224, 1000
     classes, full depth) in f32 at batch 2 with seeded weights and batch
     norm statistics: the card's logits against the CPU port's plain
     forward within 1e-3 relative L2; conv_bn_act 49 / 35 and
     window_attention 12 launches per forward;
 14. vision_serve: the same three in bf16 at batch 64 under
     inference_mode, eager and then through `jit.to_static(model)` (one
     CUDA graph of the forward, replayed per call): images/s of each
     over 10 batches after 2 warm-ups, ms per batch, peak memory, exact
     launches per to_static call; the replayed logits equal the eager
     ones bit for bit, and against the CPU port's plain f32 forward of
     the same weights and batch within 5% relative L2; then each model
     cast in place to float16 and served the same way, held to the same
     f32 forward (vision_serve_f16: the f16 conv and window kernels);
 15. vision_train_parity: Swin-T, ResNet-50 and ViT-B/16 (224x224, 1000
     classes, full depth) in f32 at batch 2: 3 Momentum steps with
     CrossEntropyLoss on the card through the kernels (TF32 off) and on
     the CPU through the plain versions, each step from the CPU's state
     (free-running ResNet-50 trajectories part after one step; that gap
     is logged); the losses agree within 1e-3, ResNet-50's running
     statistics within 1e-3 relative L2; window forward and backward
     12 + 12 launches per Swin-T step, conv_bn_act 0 per ResNet-50 step
     (training batch norm is not folded), flash_fwd and flash_bwd 12 +
     12 per ViT-B/16 step;
 16. vision_train: bench.py's vision rows, Swin-T at batch 128,
     ResNet-50 at batch 256 and ViT-B/16 at batch 128 (S = 197: the
     native flash tier at a length that is not a multiple of 8; a
     profiler split of one of its steps), f32 masters, bf16 O2,
     Momentum(1e-3, 0.9),
     CrossEntropyLoss, seeded numpy images and labels: 2 warm-up steps,
     then `run_steps(repeat=10)` timed between synchronizes: images/s,
     ms per step, MFU (bench.py's flops per image over 989 TFLOP/s),
     peak memory, exact launches per step.  The loss must stay finite
     and fall; the graph replayed and equal to the eager body bit for
     bit, as in phase 8; then (vision_train_f16) Swin-T's model in a
     second step, O2 in float16: images/s, launches a step, the loss
     finite and falling;

 17. varlen: `nn.functional.flash_attn_unpadded` forward and backward on
     one packed batch at GPT-125M attention widths (12 heads of 64, 8192
     tokens in 9 sequences of 1 to 4180 and an empty one): causal, not
     causal, and not causal over keys packed twice as long (16384), in
     bf16 and f32; one varlen_fwd and one varlen_bwd launch each, held
     against the dense flash kernels run on each sequence alone; 17a
     (varlen_f16): the same in float16;
 18. fused_transformer_parity: `FusedMultiTransformer` (eval) and a
     stack of two `FusedTransformerEncoderLayer`s (training, every
     gradient) at width 256, 4 heads, 2 layers, f32: the card against
     the CPU within 1e-4 relative L2, exact launches;
 19. fused_transformer_serve: `FusedMultiTransformer` at gpt_1p3b widths
     (2048, 16 heads, ffn 8192, 24 layers, gelu, pre-LN) in bf16, batch
     8 x 1024: ms per forward, tokens/s, peak memory, 48 fused_norm and
     24 flash_fwd launches per forward, a profiler split of one forward;
     the output against the f32 forward of the same weights within 5%;
     then the model cast to float16 (fused_transformer_serve_f16: f16 x,
     w and b through the fused norm);
 20. fused_encoder_train: 12 `FusedTransformerEncoderLayer`s at
     ernie_base widths (768, 12 heads, ffn 3072, gelu, post-LN), batch
     32 x 512, bf16 O2 over f32 masters, AdamW, a mean-squared-error
     loss against a seeded target: tokens/s, ms per step, MFU, peak
     memory, 24 fused_norm + 12 flash_fwd + 12 flash_bwd launches per
     step, a profiler split of one step; the loss must fall over 10
     steps;
 21. ernie_train: ERNIE-base MLM + NSP pretraining as its recipe runs it
     (`ernie_base` widths, vocab 40000, 12 layers, dropout 0.1), f32
     masters under bf16 O2, batch 32 x 512 with real lengths 256-512
     (the pad bias: the biased flash tier forward and backward), MLM
     labels on 15% of the real tokens, NSP labels,
     AdamW(LinearWarmup(PolynomialDecay), weight decay 0.01) with
     grad_clip_norm 1.0, through `build_train_step(loss_fn=None)`: 2
     warm-up steps, then `run_steps(repeat=10)`: tokens/s, ms per step,
     MFU, peak memory, exactly 12 flash_fwd + 12 flash_bwd launches per
     step, a profiler split of one step; the loss finite and falling;
     the replays equal the eager body bit for bit from the same state
     and dropout generator state, and two replays from one state and two
     generator states give different updates.
 22. fleet: `ReplicaFleet(num_replicas=2, kind="gpt")` behind the port's
     `Router`, both replicas on the card (each the fleet's seeded small
     GPT, `_build_gpt_engine`): every replica announces after its
     warm-up, and its lifecycle record names the captured programs
     (decode_n2, prefill_s16); streams through the router equal an
     in-process engine's tokens on the card, and each replica's own
     launch counters (reset at its announce, read from its
     /debug/telemetry) hold flash_fwd to its prefills x layers and
     paged_attention to its decode steps x chunk x layers; the replica
     serving a stream is killed with 3 tokens through the router (the
     stream completes on the survivor or is resumable from
     StreamInterrupted, an exact prefix of the true sequence either
     way), the monitor relaunches it, and a replica drained with a
     stream in flight finishes it and exits 0; the fleet lifecycle's
     spawn -> announce -> first-routable ms.
 23. recompute_parity: GPT-125M widths at 2 layers in f32, batch 2 x
     256, dropout 0.1: 3 AdamW steps without recompute and under each
     policy (full, dots, dots_no_batch) from the same weights and
     generator state, losses and parameters within 1e-5 (bit for bit is
     logged), the dropout generator where the plain run left it,
     flash_fwd twice a layer a step; a guarded step (and a guarded
     recomputed one) bit for bit the unguarded; every such graph's
     replay == its eager body bit for bit;
 24. train_resilient: phase 8's GPT-125M step with dropout 0.1, timed
     in the four combinations of recompute and guard (tokens/s, ms per
     step, peak memory, 24 / 12 flash launches a step with recompute,
     12 / 12 without); on the step with both and a CheckpointManager:
     a NaN injected at one step (`train.step`) skipped with the state
     bit-equal, the next loss equal to a step from the pre-fault state;
     save, 3 steps, rollback: the state bit-equal to the save; save,
     3 steps, and a freshly built step resumed from the save with the
     generator set back gives the same 3 losses bit for bit; save and
     restore ms;
 25. train_1p3b_recompute: `gpt_1p3b(fused_head_ce=True,
     recompute=True)` bf16 O2 at B8 x 2048, and the same model without
     recompute (B halved while it does not fit): tokens/s, MFU, peak
     memory, 48 / 24 flash_fwd a step;
 26. train_llama_recompute: LLaMA at llama_7b widths with 2 layers, B1
     x 2048, bf16 O2, recompute_policy="dots_no_batch" against no
     recompute: the losses (within 1e-3; bit for bit is logged), flash
     and rope twice a layer forward with recompute, their adjoints once;
 27. train_eager_amp: GPT-125M (12 layers, B8 x 1024, the fused head +
     CE) in the eager loop under bf16 O2: `amp.decorate(model,
     AdamW(multi_precision=True), level="O2")`, ClipGradByGlobalNorm(1.0),
     `auto_cast`, ``loss.backward(); opt.step(); opt.clear_grad()`` for
     20 steps; the same loop from the same weights through
     `jit.to_static(model)` in training for 10 steps (one program, its
     forward and backward graphs replayed from the second call: losses
     bit for bit the eager loop's); phase 8's graphed step from the same
     weights (the bf16 casts `decorate` starts the eager loop's masters
     from; clip 1.0): its first 3 losses within 2e-2 relative of the
     eager loop's; tokens/s and peak memory of the three, 12 + 12 flash
     launches a step;
 28. train_fp16_scaler: the same model in float16 O1 (f32 parameters,
     `auto_cast(dtype="float16")`), AdamW + clip behind
     `GradScaler(init_loss_scaling=2**16)` attached to a StepGuard, 20
     eager steps, the loss times inf at step 7: that step leaves the
     parameters, the slots and the step count bit for bit, halves the
     scale, one "amp" skip and no escalation; tokens/s against phase
     27's eager loop, the scale's trajectory, the last loss against the
     bf16 run's, 12 + 12 f16 flash launches a step;
 28a. llama_o1_f16: LLaMA at llama_7b widths, 2 layers, B1 x 2048, in
     float16 O1 behind GradScaler(2**16, incr_every_n_steps=2), 8 eager
     AdamW steps, the loss times inf at step 3 (the state bit for bit),
     the scale before every step the scaler's rule for the steps that
     overflowed; tokens/s; rope, rope_bwd, flash_fwd and flash_bwd in
     f16 once a layer a step;
 29. optimizer_zoo: SGD, Momentum, Adagrad, Adam (amsgrad), AdamW,
     Adamax, RMSProp (centered), Lamb, Adadelta and Rprop each in
     GPT-125M's graphed train step at B8 x 1024, bf16 AMP: 5 replayed
     steps timed (tokens/s), the rule's profiled device ms a step (its
     `apply_gradients` over the 12-layer model's f32 masters) and its
     slot memory; and in f32 at 2 layers (batch 2 x 256, lr 1e-5) 4 steps
     of the graphed step (3 of them replays) against 4 eager `.step()`s
     of the same rule: losses and parameters within 1e-4.
 30. gpt6p7b_serve: `gpt_6p7b` (hidden 4096, 32 layers, 32 heads of 128,
     vocab 50304, learned positions, LayerNorm, GELU, a tied head) in
     bf16 with seeded weights, full depth: phases 4 and 5 on it (their
     checks and launches per layer: flash_fwd 32 a prefill, paged 32 a
     decode step, decode_attention 32 a `generate()` step), then the
     engine's decode step at 4 live slots: wall and profiled device ms,
     its bound, and the peak memory;
 31. incubate_decode: `masked_multihead_attention` at gpt_6p7b's
     attention width (B8, 32 heads of 128, a 2048-slot cache), 64 steps
     from mixed starts, bf16 and f32: decode_attention once a step, each
     step against the einsum route (a zero mask) within 2e-2 / 1e-5,
     both caches equal; `block_multihead_attention` over the same
     contents in shuffled 64-token blocks within 1e-5 of the f32 run;
     ms a call of each at the last step;
     `variable_length_memory_efficient_attention` at B8 H32 S1024 D128,
     bf16, causal, key lengths 256-1024: flash_fwd once, flash_bwd once
     under a backward, output and gradients within 2e-2 of `_sdpa_ref`
     in f32 on the card;
 32. incubate_moe: `FusedEcMoe` at hidden 1024, inter 4096, 8 experts, B8
     x 512, bf16 against its f32 forward within 5% relative L2; ms a
     forward;
 33. incubate_train: phase 27's GPT-125M eager bf16 O2 loop with its 48
     projection weights pruned 2:4, `asp.decorate(LookAhead(AdamW, k=5))`
     and a `ModelAverage` beside it, 10 steps: the loss falls, 2:4
     sparsity holds after every step, `apply()` / `restore()` gives the
     live weights back bit for bit, 12 + 12 flash launches a step;
     tokens/s beside phase 27's;
 34. save_load: `paddle_tpu_torch.save` of a GPT-125M bf16 state (12
     layers) to a `.pdparams` file in the JAX package's format and `load`
     back onto the card, bit for bit; seconds and the file's size;
 35. hapi_fit: `Model(GPT-125M)` prepared with AdamW, CrossEntropyLoss,
     `metric.Accuracy` and ``amp_configs={"level": "O2", "dtype":
     "bfloat16"}``, `.fit` for 8 steps at B8 x 1024 through
     `DataLoader(num_workers=2)` on the shared-memory route (asserted):
     losses bit for bit the eager O2 loop's on the same batches from the
     same weights, 12 flash_fwd + 12 flash_bwd a step, tokens/s of both;
     `Model.save` -> a new `Model` -> `load` -> `evaluate` equal;
 36. hapi_vision: `Model(resnet50())` f32 `.evaluate` and `.predict` over
     2 x 64 images of 224² through a `DataLoader`: 49 conv_bn_act a
     forward, predictions and loss bit for bit the eager model's;
 37. jit_save: `jit.save` -> `jit.load` of ResNet-50 (f32, [8, 3, 224,
     224]) and a GPT-125M forward (bf16, [1, 1024] int64), then
     `llama_tiny` and a narrow Swin-T: each loaded program bit for bit
     the eager forward, its graph holding the ``paddle_tpu_torch::``
     nodes (conv_bn_act, flash_fwd, rope, window_attention) and
     launching them (49, 12, 2 + 2, 4 a call); ms a call of the loaded
     program beside the eager forward's;
 38. static_program: gpt_1p3b (bf16, 24 layers, [8, 1024] ids) and
     ResNet-50 (f32 and bf16, [8, 3, 224, 224]) recorded as static
     Programs (no launch while recording) and run by `static.Executor()`
     on the card: the first run (eager) and the graph replays bit for
     bit the eager forward, 24 flash_fwd / 49 conv_bn_act a call; ms a
     call of the eager forward, the first run and a replay;
 39. saved_model: `save_inference_model` -> `create_predictor` of each:
     `Predictor.run` bit for bit `Executor.run` with the same launches;
     file sizes, save / load seconds, ms a call; ResNet-50 f32 saved on
     [-1, 3, 224, 224] run at batches 1, 8 and 32 bit for bit the eager
     forward; the C ABI (`PD_PredictorCreate` / `PD_PredictorRun` via
     ctypes) bit for bit the Predictor;
 40. saved_model_serve: `InferenceServer(model_path=)` of the ResNet-50
     f32 program over HTTP: 32 `/predict` requests of batch 8 bit for
     bit `Predictor.run`; p50 / p99 request ms and the server's added ms;
 41. fleet_model: two `kind="model"` replicas of a gpt_1p3b program
     saved on [1, 128] ids (fetch: the last position's logits in f32)
     behind the `Router`: routed `/predict` bit for bit the in-process
     predictor, 24 flash_fwd a run; lifecycle phases and spawn ->
     routable ms; a replica killed with SIGKILL relaunched (heal ms); a
     drained replica exits 0.
 42. transformer_train: Transformer-base built from the port's `nn` (a
     shared `nn.Embedding(37000, 512)` scaled by sqrt(512), sinusoid
     positions, `nn.Transformer()` at its defaults, a 37000-way
     `nn.Linear`): the model cut to 2 + 2 layers in f32 (no dropout), 3
     AdamW steps on the card and on the CPU from one set of weights,
     losses within 1e-5, every parameter's first gradient within 2e-5
     of its largest CPU value (the key biases', zero in exact
     arithmetic, under 1e-6 of the largest gradient), 6 + 6 flash
     launches a step; then full depth, dropout 0.1, bf16 O2 through
     `amp.decorate`,
     `CrossEntropyLoss(ignore_index=pad, label_smoothing=0.1)`, B64,
     sources of 128-256 tokens under a [B, 1, 1, 256] pad mask, targets
     of 96-192 under `generate_square_subsequent_mask(192)`: 5 timed
     steps on one batch, tokens/s, ms/step, peak memory, exactly 18
     flash_fwd + 18 flash_bwd a step (the biased tier), the loss finite
     and falling;
 43. transformer_decode: 8 seeded sources, 64 greedy steps in f32 through
     `TransformerDecoder.gen_cache` against a loop that recomputes the
     full decoder each step: equal tokens (a divergence passes only at a
     top-2 margin below 1e-4), 12 flash_fwd a cached step, tokens/s of
     each;
 44. nn_layers_card: every `nn` class and the functionals of
     `_functional_cases` (with the in-place forms and
     `class_center_sample`) at small seeded shapes, forward and backward
     on the card against the CPU (f32, TF32 off) within 1e-4 relative; how
     many ran and the largest error per family;
 45. c1_card: a trainable mask's gradient through
     `scaled_dot_product_attention` (the flash backward's dBias mode) and
     `variable_length_memory_efficient_attention` on the card against
     the CPU; a CPU-built static program run by `Executor()` on the card
     after `set_program_state` / `static.load`, and fed at a new batch;
     `jit.save` of gpt_1p3b: the `.pdmodel`'s size (no weights in it);
 46. seq2seq_train: PaddleNLP's base seq2seq (IWSLT'15 En-Vi, no
     attention) at its published widths: an `nn.LSTM` encoder and a
     stacked `nn.LSTMCell` decoder, 2 layers of 512, vocab 17,191 /
     7,709, f32, Adam under ClipGradByGlobalNorm(5.0): 2 steps card vs
     CPU at B32 x 50 (losses, every gradient), then 10 steps at B128 x 50
     with dropout 0.2 (ms/step, target tokens/s, the loss falling; no
     kernel launches: no TPU kernel lies on this path);
 47. seq2seq_beam: `BeamSearchDecoder(beam_size=10)` + `dynamic_decode`
     over 50 steps of 16 seeded sentences, card against a CPU copy (ids
     equal, but where the two decodes part at a near tie of the CPU's
     candidates, reported; the other sentences' scores within 5e-4); ms
     a decode step, sentences/s;
 48. ops_card: every case of ``tools_torch/op_cases.py`` (each public op
     of the JAX op table and each in-place twin) on the card against the
     CPU, the GRAD_CHECKED ops' gradients too; how many ran and the
     largest error by kind;
 49. quant_card: `nn.quant` at llama_7b's MLP width (4096 -> 11008):
     int8 / int4 / LLM.int8 codes per channel and g128 card == CPU bit
     for bit, `weight_only_linear` / `llm_int8_linear` outputs within
     1e-4, their ms beside `F.linear`.

Phase 3 also holds flash_bwd's dBias mode (a mask that requires grad)
at ERNIE-base's shape with [B, 1, 1, S] and [B, H, S, S] masks and at
Transformer-base's cross attention with a [1, H, Sq, Sk] mask, each
beside the same backward without dBias and SDPA's backward with a
trainable `attn_mask` (library), in f32, bf16 and f16 (`dbias_cases`;
the rows ride on flash_bwd's JSON row as "dbias").
It holds flash_fwd and flash_bwd at the shapes and masks of phases 42
and 43 too (`transformer_cases`): Transformer-base's encoder
self-attention (B64 S256 under the [B, 1, 1, 256] pad mask), decoder
self-attention (B64 S192 under the [192, 192] -inf causal mask) and
cross attention (Sq192 Sk256 under the pad mask), and the cached decode
step's flash_fwd at Sq 1 (self-attention with no mask over 1, 37 and 64
keys; cross attention over 128 keys under an [8, 1, 1, 128] pad mask).
It also holds paged_attention_int8 (the gpt_1p3b row's pool in int8, and
a llama_7b decode step, 32 kv heads over ~1000 keys each, with profiled
device times; two runs bit-identical and each sequence alone bit for bit
in the batch, bf16 and f32) and relayout_to_hm / relayout_from_hm at the
GPT-125M train shape [8, 1024, 12, 64] (library: the same transpose on
the card), each of their rows and each fused_norm row also with its
profiled device time, the library call's, and the wrapper's host
microseconds; flash_fwd and flash_bwd at the encoder step's shape (phase
20: full B32 S512 H12 D64) and flash_fwd at the fused serving block's
(phase 19: full B8 S1024 H16 D128); flash_fwd and flash_bwd at ERNIE-
base's shape with its pad bias (phase 21: full B32 S512 H12 D64, [B, 1,
1, S] f32, lengths 256-512; library: SDPA with the bias as its mask) and
at ViT-B/16's (phase 16: full B128 S197 H12 D64); a check that two bf16
runs of flash_fwd / flash_bwd at the train shape, of varlen_bwd on the
causal packing, of conv_bn_act at ResNet-50's 3x3/s1 256->256 @14 (B64),
of window_attention and window_attention_bwd at Swin-T's stage 1 (B128,
no shift) and of fused_norm at [16384, 768] are bit-identical; flash_fwd
and flash_bwd in float16 at the train shape (causal B8 S1024 H12 D64:
phase 28's) against their plain versions within 1e-2, beside SDPA in f16
(the JSON row's "float16" entry); varlen_fwd / varlen_bwd on the packed
batch of phase 17 (library yardstick: SDPA on `torch.nested` jagged
tensors, or with a block-diagonal mask where this PyTorch cannot
dispatch those; the form is logged), fused_norm at the norms of phases
19 and 20, an RMS norm with bias and residual and an odd width of 1000,
and decode_attention and paged_attention at a GQA group of 16 (32 query
heads over 2 kv heads) and at llama_7b's decode width (B4, 32 kv heads
of 128: the paged row at pos 1040 / 1000 / 960 / 1020, the dense row
left-padded to ~1000 keys a row), every paged_attention and
decode_attention row with its profiled device time, the wrapper's host
microseconds and, for decode, SDPA's (decode_attention also at phase
31's masked-MHA shape, B8 cap 2048, its last step's keys); bf16 reruns
of both at the llama_7b rows bit-identical; and, in bf16 and f32 at
gpt_1p3b widths over a shuffled page table, paged_attention bit for bit
decode_attention over the same keys gathered dense (start 0 and start
37) and each sequence alone bit for bit the same sequence in the batch
of 4, for both kernels.

Launch counters are reset just before the driven part of phases 4, 4b,
5, 5a (its sampled and its beam calls), 5b (each engine), 8, 8a (each
dtype), 8b, 9, 9a, 9b, 9c (each tier), 10, 10a (each of its phases),
11a, 12, 14 and 16 (each dtype), 17, 17a, 19 (each dtype), 20, 21, 22
(its in-process engine: the replicas count theirs in their own
processes), 24, 25 and 26 (their timed steps with recompute), 27 (the timed
eager steps), 28 and 28a (the timed f16 steps) and 29 (each rule's timed
replays), 30 (as 4 and 5), 31 (its kernel-route loops and its
variable-length call), 33 (the timed steps), 35 (the fit), 36 (evaluate
and predict), 37 (each loaded program's checked call), 42 (the timed
bf16 steps), 43 (the cached decoding) and 45 (the trainable-mask
backwards) and read just after each; every kernel of each path must
have launched, every kernel on a float16 path too.  A replayed
CUDA graph (the engine's decode step, the train step) adds the launches
its capture recorded to the counters, once a replay.  Under --profile
each profiled path also prints its host launch calls a step
(cudaLaunchKernel and cudaGraphLaunch, count and host ms).  The line before last is the
JSON kernel table (`launches` summed over those paths, `paths` each
path's own count, `float16` the kernel's f16 row of phase 3 with its
launches on the f16 paths); the last line is the device JSON.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

F32_TOL = 1e-4      # f32 kernel vs plain: reduction-order noise
BF16_TOL = 2e-2     # bf16: both round the f32 result to bf16 (8 bits)
F16_TOL = 1e-2      # f16: both round the f32 result to f16 (11 bits)
# a 16-bit engine stream may leave sequential generate()'s at a step whose
# top-2 logits lie within this many ulps of its largest |logit|: twice
# the largest difference measured between two routes' logits
# (`_tie_readings`), with room
NEAR_TIE_ULPS = 8
PEAK_BYTES = 3.35e12                      # H100 SXM HBM3, bytes/s
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float16": 989e12,          # dense tensor-core f16
              "float32": 67e12}           # f32 outside the tensor cores
SEED = 0


def log(msg):
    print(msg, flush=True)


class Fail(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=2):
    """Mean device time of one call of `fn`: the self device time of every
    CUDA kernel and copy it ran, summed by torch.profiler over `iters`
    calls (as `_log_profile` reads device time).  Unlike `time_ms` it
    leaves out the host's time between launches, which is what a CUDA
    event pair measures when a short kernel's wrapper takes longer than
    the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / iters / 1e3


def host_us(fn, iters=50, warmup=2):
    """Host microseconds of one call of `fn`: the wall time of `iters`
    calls enqueued back to back (no synchronize between them), so the
    wrapper's own Python and launch cost, not the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _dn(dtype):
    """torch.bfloat16 -> "bf16" (f16, f32): the dtype's name in a log."""
    return {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}[
        str(dtype).split(".")[1]]


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ----------------------------------------------------------------- phase 1
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return card, name


# ----------------------------------------------------------------- phase 2
def phase_build():
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build

    names = [os.path.splitext(os.path.basename(k.source))[0]
             for k in K.KERNELS.values()]
    t0 = time.perf_counter()
    secs = _build.build(names)
    log(f"[build] {json.dumps({n: round(s, 1) for n, s in secs.items()})}"
        f" wall {time.perf_counter() - t0:.1f}s")
    for n in dict.fromkeys(names):
        # ptxas -v: one "Used N registers" and one spill line per kernel
        with open(os.path.join(_build.BUILD_DIR, f"{n}.log")) as f:
            text = f.read()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"[build] {n}: {len(regs)} kernels, registers max "
            f"{max(regs, default=0)}, kernels spilling "
            f"{sum(x > 0 for x in spills)} (max {max(spills, default=0)} "
            "bytes of spill stores)")
        tc = _tc_kernels(text)
        if tc:
            log(f"[build] {n} bf16 / f16 tensor-core kernels (type, tile "
                "width, mode: registers / spill bytes): " + ", ".join(
                    f"{k} {t} DT{dt} {mode}: {r}/{sp}"
                    for k, t, dt, mode, r, sp in tc))
            spilled = [(k, t, dt, mode) for k, t, dt, mode, _, sp in tc
                       if sp and dt <= 128]
            check(not spilled, f"{n}: bf16 / f16 tensor-core kernels spill "
                  f"(flash at head dims <= 128, every conv and window "
                  f"kernel): {spilled}")
        rows = _row_kernels(text)
        if rows:
            log(f"[build] {n} register-held row kernels (x / w types, "
                "kind, vectors a thread: registers / spill bytes): "
                + ", ".join(f"{t} {k} NV{nv}: {r}/{sp}"
                            for t, k, nv, r, sp in rows))
            spilled = [(t, k, nv) for t, k, nv, _, sp in rows if sp]
            check(not spilled, f"{n}: the vector kernels, which hold rows "
                  f"in registers, spill: {spilled}")
        dec = _split_kernels(text)
        if dec:
            log(f"[build] {n} decode kernels on a cluster (type, 16-byte "
                "chunks a row, query rows: registers / spill bytes): "
                + ", ".join(f"{t} CHP{chp} GM{gm}: {r}/{sp}"
                            for _, t, chp, gm, r, sp in dec))
            spilled = [(t, chp, gm) for _, t, chp, gm, _, sp in dec if sp]
            check(not spilled, f"{n}: the decode kernels on a cluster "
                  f"spill: {spilled}")


# element types as they appear in the mangled kernel names of `ptxas -v`
_MANGLED = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
_T16 = "(13__nv_bfloat16|6__half)"     # a 16-bit tensor-core element type


def _tc_kernels(text):
    """[(kernel, type, DT, mode, registers, spill store bytes)] of the
    16-bit (bf16 and f16) tensor-core kernels in one source's `ptxas -v`
    log, entry names demangled from their template arguments: the flash
    kernels' <E, DT, BIAS, PACKED, HM[, DBIAS]>, the conv's <E, BM, BN, WM, WN,
    KH, KW, BK, A16, MINB> (DT: the tile's BM; mode: "BMxBN KHxKW bkBK",
    0x0 for a kernel size read at run time, "w-regs" where the weights go
    through registers) and the window forward's and backward's <DT,
    E>."""
    out = []
    for part in text.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if not regs:
            continue
        m = re.search(r"(flash_\w+?_tc)I" + _T16
                      + r"Li(\d+)ELb(\d)ELb(\d)ELb(\d)E(?:Lb(\d)E)?", part)
        c = re.search(r"(conv_dense_tc)I" + _T16 + r"Li(\d+)ELi(\d+)"
                      r"ELi\d+ELi\d+ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)", part)
        w = re.search(r"(window_attention(?:_bwd)?_tc)ILi(\d+)E" + _T16,
                      part)
        if m:
            bias, packed, hm = (m.group(i) == "1" for i in (4, 5, 6))
            kernel, t, dt = m.group(1), m.group(2), int(m.group(3))
            mode = ("bias" if bias else "packed" if packed
                    else "head-major" if hm else "dense")
            if m.group(7) == "1":
                mode += "+dbias"
        elif c:
            kernel, t, dt = c.group(1), c.group(2), int(c.group(3))
            mode = (f"{c.group(3)}x{c.group(4)} {c.group(5)}x{c.group(6)} "
                    f"bk{c.group(7)}" + ("" if c.group(8) == "1"
                                         else " w-regs"))
        elif w:
            kernel, dt, t = w.group(1), int(w.group(2)), w.group(3)
            mode = "window bwd" if "bwd" in kernel else "window fwd"
        else:
            continue
        out.append((kernel, _MANGLED[t], dt, mode, int(regs.group(1)),
                    int(spill.group(1)) if spill else 0))
    return out


def _row_kernels(text):
    """[(x / w types, kind, NV, registers, spill store bytes)] of the
    fused norm's vector kernels `fused_norm_rows<T, W, RMS, NV>` in one
    source's `ptxas -v` log (W mangled as a substitution, S0_, when it
    is T)."""
    out = []
    for part in text.split("Compiling entry function")[1:]:
        m = re.search(r"fused_norm_rowsI(13__nv_bfloat16|6__half|f)"
                      r"(13__nv_bfloat16|6__half|f|S\d*_)Lb(\d)ELi(\d+)E",
                      part)
        regs = re.search(r"Used (\d+) registers", part)
        if not (m and regs):
            continue
        spill = re.search(r"(\d+) bytes spill stores", part)
        t = _MANGLED[m.group(1)]
        w = _MANGLED.get(m.group(2), t)
        out.append((f"{t}/{w}", "rms" if m.group(3) == "1" else "ln",
                    int(m.group(4)), int(regs.group(1)),
                    int(spill.group(1)) if spill else 0))
    return out


def _split_kernels(text):
    """[(kernel, type, CHP, GM, registers, spill store bytes)] of the
    decode kernels on a cluster, `paged_attention_kernel<T, CHP, GM>`,
    `paged_attention_int8_kernel<T, CHP, GM>` and
    `decode_attention_kernel<T, CHP, GM>` (decode_common.cuh,
    `decode_split`), in one source's `ptxas -v` log; the int8 tier's
    types read "int8/bf16", "int8/f16" and "int8/f32" (codes / q and
    out)."""
    out = []
    for part in text.split("Compiling entry function")[1:]:
        m = re.search(r"((?:paged|decode)_attention(?:_int8)?_kernel)I"
                      r"(13__nv_bfloat16|6__half|f)Li(\d+)ELi(\d+)E", part)
        regs = re.search(r"Used (\d+) registers", part)
        if not (m and regs):
            continue
        spill = re.search(r"(\d+) bytes spill stores", part)
        t = _MANGLED[m.group(2)]
        out.append((m.group(1), ("int8/" + t) if "int8" in m.group(1) else t,
                    int(m.group(3)), int(m.group(4)), int(regs.group(1)),
                    int(spill.group(1)) if spill else 0))
    return out


# ----------------------------------------------------------------- phase 3
def _sdpa_mask(torch, q, k, bias, causal):
    """The causal mask (bottom-right aligned) and the bias as one
    additive mask in q's dtype, for F.scaled_dot_product_attention."""
    sq, sk = q.shape[1], k.shape[1]
    mask = bias
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        mask = bias + torch.where(keep, 0.0, -1e30)
    return mask.to(q.dtype)


def _sdpa_library(q, k, v, bias, causal):
    """One PyTorch call computing flash_fwd's output (yardstick only): the
    causal mask and the bias go in as one additive mask, built here,
    outside the timed call."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if bias is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    mask = _sdpa_mask(torch, q, k, bias, causal)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)


def _sdpa_bwd_library(q, k, v, dout, bias, causal):
    """The backward of one F.scaled_dot_product_attention call on the same
    inputs (yardstick only): its forward runs here, outside the timed
    call, and the timed call computes dq, dk, dv from the kept graph.
    GQA kv heads are expanded first, so its dk / dv are per query head."""
    import torch
    import torch.nn.functional as F

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(rep, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    if bias is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    else:
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=_sdpa_mask(torch, q, k, bias, causal))
    dt = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dt,
                                       retain_graph=True)


def _pad_bias(torch, valid):
    """[Sk] bool of keys a query may see -> the prefill's pad-only f32
    bias [1, 1, 1, Sk] (broadcast over queries: stride 0 in the kernel)."""
    return torch.where(valid, 0.0, -1e30)[None, None, None]


def _causal_pairs(torch, sq, valid):
    """(query, key) pairs the causal mask (bottom-right) and `valid`
    leave: the work the function needs."""
    sk = valid.numel()
    keep = torch.ones(sq, sk, dtype=torch.bool,
                      device=valid.device).tril(sk - sq)
    return int((keep & valid[None]).sum())


def kernel_cases(torch, dtype, vision, train, main=False):
    """(name, label, run_kernel, run_plain, library_fn, nbytes, flops,
    ops_dtype, real) at the main path's shapes: gpt_1p3b heads 16 x
    head_dim 128, then the other paths' (`vision`: the launches recorded
    by `_vision_launches`; `train`: those of `_swin_train_launches`).
    Each kernel's first case is its main-path row (each builder's
    `first` keeps only that one); with `main`, only those are built,
    flash's left out (`f16_cases` takes the train step's).  `ops_dtype` names the peak rate that bounds
    the operations (float32 where they cannot run on the tensor cores,
    whatever the storage type).
    `real` is the first query row that sees a valid key: rows before it
    are left pad, whose output no real row reads; the kernel skips the
    key blocks past the diagonal and the plain version does not, so the
    two average different keys there, and only finiteness is checked."""
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    h, d = 16, 128
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    cases = []
    if not main:
        # flash_fwd, causal: generate() prefill of an equal-length batch
        b, s = 4, 128
        q, k, v = randn(b, s, h, d), randn(b, s, h, d), randn(b, s, h, d)
        pairs = b * s * (s + 1) // 2
        cases.append(("flash_fwd", f"causal B{b} S{s}",
                      lambda: FA.flash_fwd(q, k, v, causal=True),
                      lambda: FA.flash_fwd_reference(q, k, v, causal=True),
                      _sdpa_library(q, k, v, None, True),
                      4 * b * s * h * d * isz + b * h * s * 4,
                      4 * pairs * h * d, dname, 0))
        # flash_fwd, causal + pad bias: the engine's cold prefill of a
        # 1000-token prompt (bucket 1008, 8 pad rows)
        sb, start = 1008, 8
        qb, kb, vb = randn(1, sb, h, d), randn(1, sb, h, d), randn(1, sb, h, d)
        valid = torch.arange(sb, device=dev) >= start
        bias = _pad_bias(torch, valid)
        cases.append(("flash_fwd", f"causal+pad B1 S{sb}",
                      lambda: FA.flash_fwd(qb, kb, vb, bias=bias, causal=True),
                      lambda: FA.flash_fwd_reference(qb, kb, vb, bias=bias,
                                                     causal=True),
                      _sdpa_library(qb, kb, vb, bias, True),
                      4 * sb * h * d * isz + sb * 4 + h * sb * 4,
                      4 * _causal_pairs(torch, sb, valid) * h * d, dname,
                      start))
        # flash_fwd, warm tail prefill: a 48-token bucket (8 pad rows) over a
        # 512-token cached prefix, keys cut to prefix + tail (560)
        sq, plen, tstart = 48, 512, 8
        sk = plen + sq
        qw, kw, vw = randn(1, sq, h, d), randn(1, sk, h, d), randn(1, sk, h, d)
        jw = torch.arange(sk, device=dev)
        wvalid = (jw < plen) | (jw - plen >= tstart)
        wbias = _pad_bias(torch, wvalid)
        cases.append(("flash_fwd", f"causal+pad-warm Sq{sq} Sk{sk}",
                      lambda: FA.flash_fwd(qw, kw, vw, bias=wbias,
                                           causal=True),
                      lambda: FA.flash_fwd_reference(qw, kw, vw, bias=wbias,
                                                     causal=True),
                      _sdpa_library(qw, kw, vw, wbias, True),
                      (2 * sq + 2 * sk) * h * d * isz + sk * 4 + h * sq * 4,
                      4 * _causal_pairs(torch, sq, wvalid) * h * d, dname, 0))
    # paged_attention: a serving decode step, 4 slots, page 16, the pool
    # of the default EngineConfig (4 * 128 + 1 pages)
    ps, npool, p = 16, 4 * 128 + 1, 128
    qp = randn(4, h, d)
    kp, vp = randn(npool, h, ps, d), randn(npool, h, ps, d)
    pos = torch.tensor([1031, 330, 551, 0], dtype=torch.int32, device=dev)
    pt = torch.zeros(4, p, dtype=torch.int32, device=dev)
    perm = torch.randperm(npool - 1, generator=g, device=dev) + 1
    used = 0
    for r in range(3):
        n = int(pos[r]) // ps + 1
        pt[r, :n] = perm[used:used + n].int()
        used += n
    keys = int((pos + 1).sum())
    cases.append(("paged_attention", "B4 pool513x16x16x128",
                  lambda: PA.paged_attention(qp, kp, vp, pt, pos),
                  lambda: PA.paged_attention_reference(qp, kp, vp, pt, pos),
                  None,
                  2 * keys * h * d * isz + 2 * 4 * h * d * isz
                  + pt.numel() * 4 + 16, 4 * keys * h * d, dname, 0))
    # decode_attention: generate() decode over a left-padded batch
    bd, capd = 4, 256
    qd = randn(bd, h, d)
    kc, vc = randn(bd, h, capd, d), randn(bd, h, capd, d)
    posd = torch.full((bd,), 150, dtype=torch.int32, device=dev)
    std = torch.tensor([0, 28, 64, 111], dtype=torch.int32, device=dev)
    keysd = int((posd - std + 1).sum())
    cases.append(("decode_attention", f"B{bd} cap{capd} left-pad",
                  lambda: DA.decode_attention(qd, kc, vc, posd, std),
                  lambda: DA.decode_attention_reference(qd, kc, vc, posd,
                                                        std),
                  _dense_decode_library(qd, kc, vc, posd, std),
                  2 * keysd * h * d * isz + 2 * bd * h * d * isz + 32,
                  4 * keysd * h * d, dname, 0))
    if not main:
        cases += (gqa16_cases(torch, dtype) + llama_decode_cases(torch, dtype)
                  + bwd_cases(torch, dtype) + encoder_cases(torch, dtype))
    return (cases + rope_cases(torch, dtype, main)
            + conv_cases(torch, dtype, vision, main)
            + window_cases(torch, dtype, vision, main)
            + window_bwd_cases(torch, dtype, train, main)
            + varlen_cases(torch, dtype, main)
            + fused_norm_cases(torch, dtype, first=main)
            + int8_cases(torch, dtype, main) + relayout_cases(torch, dtype))


def _paged_table(torch, g, pos, npool, p, ps):
    """[B, p] page table over distinct random pages of a pool of npool
    (page 0 the scratch page) for rows of pos[b] + 1 keys; rows with pos
    0 keep the all-scratch row of a free slot."""
    pt = torch.zeros(len(pos), p, dtype=torch.int32, device="cuda")
    perm = torch.randperm(npool - 1, generator=g, device="cuda") + 1
    used = 0
    for r, n in enumerate(int(x) // ps + 1 for x in pos):
        if int(pos[r]):
            pt[r, :n] = perm[used:used + n].int()
            used += n
    return pt


def int8_cases(torch, dtype, first=False):
    """paged_attention_int8 (int8 pools, f32 scales per token and kv head,
    q and out in `dtype`): the gpt_1p3b row's shape (B4 over the default
    pool, 16 heads of 128) and a llama_7b decode step (B4, 32 kv heads of
    128, ~1000 keys each).  Bound: each live row's codes and scales of K
    and V once, q and out once."""
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.ops.quant import quantize_vectors

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    cases = []
    for label, h, pos in (
            ("B4 pool513x16x16x128", 16, (1031, 330, 551, 0)),
            ("llama_7b B4 pool513x32x16x128", 32,
             (1040, 1000, 960, 1020)))[:1 if first else None]:
        ps, npool, p, d = 16, 4 * 128 + 1, 128, 128
        q = torch.randn(4, h, d, generator=g, device="cuda", dtype=dtype)
        kq, ks = quantize_vectors(torch.randn(npool, h, ps, d, generator=g,
                                              device="cuda"))
        vq, vs = quantize_vectors(torch.randn(npool, h, ps, d, generator=g,
                                              device="cuda"))
        posd = torch.tensor(pos, dtype=torch.int32, device="cuda")
        pt = _paged_table(torch, g, pos, npool, p, ps)
        keys = sum(x + 1 for x in pos)
        cases.append((
            "paged_attention_int8", label,
            lambda q=q, kq=kq, vq=vq, pt=pt, pos=posd, ks=ks, vs=vs:
                PA.paged_attention(q, kq, vq, pt, pos, k_scales=ks,
                                   v_scales=vs),
            lambda q=q, kq=kq, vq=vq, pt=pt, pos=posd, ks=ks, vs=vs:
                PA.paged_attention_reference(q, kq, vq, pt, pos, ks, vs),
            None,
            keys * h * (2 * d + 2 * 4) + 2 * 4 * h * d * isz
            + pt.numel() * 4 + 16, 4 * keys * h * d, "float32", 0))
    return cases


def relayout_cases(torch, dtype):
    """relayout_to_hm / relayout_from_hm at the GPT-125M train shape
    [8, 1024, 12, 64] (the kv tier's Q, O, dO and dQ).  Library: the same
    `transpose(1, 2).contiguous()` on the card.  Bound: every element read
    once and written once."""
    from paddle_tpu_torch.ops.kernels import relayout as RL

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    b, s, h, d = 8, 1024, 12, 64
    x = torch.randn(b, s, h, d, generator=g, device="cuda", dtype=dtype)
    xt = torch.randn(b, h, s, d, generator=g, device="cuda", dtype=dtype)
    nbytes = 2 * b * s * h * d * isz
    return [("relayout_to_hm", f"[{b},{s},{h},{d}] -> head-major",
             lambda: RL.to_head_major(x),
             lambda: RL.to_head_major_reference(x),
             lambda: x.transpose(1, 2).contiguous(), nbytes, 0, dname, 0),
            ("relayout_from_hm", f"[{b},{h},{s},{d}] -> native",
             lambda: RL.from_head_major(xt),
             lambda: RL.from_head_major_reference(xt),
             lambda: xt.transpose(1, 2).contiguous(), nbytes, 0, dname, 0)]


def gqa16_cases(torch, dtype):
    """decode_attention and paged_attention at a GQA group of 16 (32
    query heads over 2 kv heads, head_dim 128): the group runs as two
    chunks of 8 query heads, each reading the kv head's keys once.  The
    shapes of the gpt_1p3b rows otherwise: paged B4 over the default
    pool, decode B4 cap 256 left-padded."""
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    dev = "cuda"
    hq, hkv, d = 32, 2, 128
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    ps, npool, p = 16, 4 * 128 + 1, 128
    qp = randn(4, hq, d)
    kp, vp = randn(npool, hkv, ps, d), randn(npool, hkv, ps, d)
    pos = torch.tensor([1031, 330, 551, 0], dtype=torch.int32, device=dev)
    pt = torch.zeros(4, p, dtype=torch.int32, device=dev)
    perm = torch.randperm(npool - 1, generator=g, device=dev) + 1
    used = 0
    for r in range(3):
        n = int(pos[r]) // ps + 1
        pt[r, :n] = perm[used:used + n].int()
        used += n
    keys = int((pos + 1).sum())
    cases = [("paged_attention", "GQA 32/2 B4 pool513x2x16x128",
              lambda: PA.paged_attention(qp, kp, vp, pt, pos),
              lambda: PA.paged_attention_reference(qp, kp, vp, pt, pos),
              None,
              # each kv row read once per chunk of 8 heads is the kernel's
              # cost; the function needs it once
              2 * keys * hkv * d * isz + 2 * 4 * hq * d * isz
              + pt.numel() * 4 + 16, 4 * keys * hq * d, dname, 0)]
    bd, capd = 4, 256
    qd = randn(bd, hq, d)
    kc, vc = randn(bd, hkv, capd, d), randn(bd, hkv, capd, d)
    posd = torch.full((bd,), 150, dtype=torch.int32, device=dev)
    std = torch.tensor([0, 28, 64, 111], dtype=torch.int32, device=dev)
    keysd = int((posd - std + 1).sum())
    cases.append(("decode_attention", f"GQA 32/2 B{bd} cap{capd} left-pad",
                  lambda: DA.decode_attention(qd, kc, vc, posd, std),
                  lambda: DA.decode_attention_reference(qd, kc, vc, posd,
                                                        std),
                  _dense_decode_library(qd, kc, vc, posd, std),
                  2 * keysd * hkv * d * isz + 2 * bd * hq * d * isz + 32,
                  4 * keysd * hq * d, dname, 0))
    return cases


def _dense_decode_library(q, kc, vc, pos, start):
    """One F.scaled_dot_product_attention call for decode_attention's
    output (yardstick only): keys start..pos as a boolean mask, GQA kv
    heads expanded first, both built here, outside the timed call."""
    import torch
    import torch.nn.functional as F

    ids = torch.arange(kc.shape[2], device=q.device)[None, :]
    mask = ((ids <= pos[:, None]) & (ids >= start[:, None]))[:, None, None]
    rep = q.shape[1] // kc.shape[1]
    kce, vce = (c.repeat_interleave(rep, dim=1) if rep > 1 else c
                for c in (kc, vc))
    return lambda: F.scaled_dot_product_attention(q[:, :, None], kce, vce,
                                                  attn_mask=mask)


def llama_decode_cases(torch, dtype):
    """paged_attention and decode_attention at llama_7b's decode width (B4,
    32 kv heads of 128): the paged row at the int8 row's lengths (pos 1040
    / 1000 / 960 / 1020 over the default pool of 513 pages of 16, a
    shuffled table), the dense row as `generate()` leaves a left-padded
    batch (cap 1088, pos 1040, starts 0 / 40 / 80 / 20: 1041 / 1001 / 961
    / 1021 keys), and a dense row at phase 31's masked-MHA shape (B8, cap
    2048, its last step's positions).  Bound: each live row's K and V
    once, q and out once."""
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    h, d, ps, npool, p = 32, 128, 16, 4 * 128 + 1, 128
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    pos = (1040, 1000, 960, 1020)
    qp = randn(4, h, d)
    kp, vp = randn(npool, h, ps, d), randn(npool, h, ps, d)
    posp = torch.tensor(pos, dtype=torch.int32, device="cuda")
    pt = _paged_table(torch, g, pos, npool, p, ps)
    keys = sum(x + 1 for x in pos)
    cases = [("paged_attention", "llama_7b B4 pool513x32x16x128",
              lambda: PA.paged_attention(qp, kp, vp, pt, posp),
              lambda: PA.paged_attention_reference(qp, kp, vp, pt, posp),
              None,
              2 * keys * h * d * isz + 2 * 4 * h * d * isz
              + pt.numel() * 4 + 16, 4 * keys * h * d, dname, 0)]
    cap = 1088
    qd = randn(4, h, d)
    kc, vc = randn(4, h, cap, d), randn(4, h, cap, d)
    posd = torch.full((4,), 1040, dtype=torch.int32, device="cuda")
    std = torch.tensor([0, 40, 80, 20], dtype=torch.int32, device="cuda")
    keysd = int((posd - std + 1).sum())
    cases.append(("decode_attention", f"llama_7b B4 cap{cap} left-pad",
                  lambda: DA.decode_attention(qd, kc, vc, posd, std),
                  lambda: DA.decode_attention_reference(qd, kc, vc, posd,
                                                        std),
                  _dense_decode_library(qd, kc, vc, posd, std),
                  2 * keysd * h * d * isz + 2 * 4 * h * d * isz + 32,
                  4 * keysd * h * d, dname, 0))
    # the dense row at phase 31's masked-MHA shape, its last decode step
    # (B8, cap 2048, 32 heads of 128; bound: the valid keys)
    mb, mcap = MMHA["batch"], MMHA["cap"]
    qm = randn(mb, h, d)
    km, vm = randn(mb, h, mcap, d), randn(mb, h, mcap, d)
    posm = torch.tensor(MMHA_STARTS, dtype=torch.int32, device="cuda") \
        + MMHA["steps"] - 1
    stm = torch.zeros_like(posm)
    keysm = int((posm + 1).sum())
    cases.append(("decode_attention", f"masked-MHA B{mb} cap{mcap} H{h}",
                  lambda: DA.decode_attention(qm, km, vm, posm),
                  lambda: DA.decode_attention_reference(qm, km, vm, posm),
                  _dense_decode_library(qm, km, vm, posm, stm),
                  2 * keysm * h * d * isz + 2 * mb * h * d * isz + 4 * mb,
                  4 * keysm * h * d, dname, 0))
    return cases


def _decode_bits(torch):
    """The exact-tier decode kernels' split depends on a sequence's own
    keys only, counted from its first valid key: in bf16 and f32, at
    gpt_1p3b's widths (16 heads of 128) over a shuffled page table, (a)
    paged_attention equals decode_attention over the same keys gathered
    into a dense cache, with start = 0 and with the keys shifted right by
    start = 37, and (b) each sequence run alone equals the same sequence
    inside the batch of 4, for both kernels.  All bit for bit."""
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    h, d, ps, npool, p, shift = 16, 128, 16, 4 * 128 + 1, 128, 37
    pos = (1031, 330, 551, 0)
    for dtype in (torch.bfloat16, torch.float32):
        kw = dict(generator=g, device="cuda", dtype=dtype)
        q = torch.randn(4, h, d, **kw)
        kp, vp = (torch.randn(npool, h, ps, d, **kw) for _ in range(2))
        posp = torch.tensor(pos, dtype=torch.int32, device="cuda")
        pt = _paged_table(torch, g, pos, npool, p, ps)
        paged = PA.paged_attention(q, kp, vp, pt, posp)
        # the same keys, gathered: [B, P, Hkv, PS, D] -> [B, Hkv, P*PS, D]
        k, v = (x[pt.long()].transpose(1, 2).reshape(4, h, p * ps, d)
                for x in (kp, vp))
        same0 = torch.equal(DA.decode_attention(q, k, v, posp), paged)
        ks, vs = (torch.cat([torch.randn(4, h, shift, d, **kw), x], 2)
                  for x in (k, v))
        st = torch.full((4,), shift, dtype=torch.int32, device="cuda")
        dense = DA.decode_attention(q, ks, vs, posp + shift, st)
        same1 = torch.equal(dense, paged)
        check(same0 and same1, f"paged_attention != decode_attention on "
              f"the same keys ({str(dtype)[6:]}; start 0: {same0}, start "
              f"{shift}: {same1})")
        alone = []
        for i in range(4):
            one = PA.paged_attention(q[i:i + 1].contiguous(), kp, vp,
                                     pt[i:i + 1].contiguous(),
                                     posp[i:i + 1].contiguous())
            two = DA.decode_attention(q[i:i + 1].contiguous(),
                                      ks[i:i + 1].contiguous(),
                                      vs[i:i + 1].contiguous(),
                                      posp[i:i + 1] + shift, st[i:i + 1])
            alone.append((torch.equal(one[0], paged[i]),
                          torch.equal(two[0], dense[i])))
        check(all(a and b for a, b in alone), f"a sequence alone differs "
              f"from the same sequence in the batch ({str(dtype)[6:]}; "
              f"(paged, dense) equal per row: {alone})")
    log("[kernels] exact decode split: paged_attention == decode_attention "
        f"bit for bit on the same keys (start 0 and {shift}) and each "
        "sequence alone == in the batch of 4, both kernels, bf16 and f32, "
        "gpt_1p3b widths, pos 1031 / 330 / 551 / 0")


def _int8_bits(torch):
    """paged_attention_int8 at the llama_7b decode row (B4, 32 kv heads of
    128, pos 1040 / 3 / 520 / 0 over a shuffled table of the default
    pool), bf16 and f32: two runs bit-identical, and each sequence alone
    bit for bit the same sequence in the batch."""
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.ops.quant import quantize_vectors

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    h, d, ps, npool, p = 32, 128, 16, 4 * 128 + 1, 128
    pos = (1040, 3, 520, 0)
    kq, ks = quantize_vectors(torch.randn(npool, h, ps, d, generator=g,
                                          device="cuda"))
    vq, vs = quantize_vectors(torch.randn(npool, h, ps, d, generator=g,
                                          device="cuda"))
    posp = torch.tensor(pos, dtype=torch.int32, device="cuda")
    pt = _paged_table(torch, g, pos, npool, p, ps)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(4, h, d, generator=g, device="cuda", dtype=dtype)
        batch = PA.paged_attention(q, kq, vq, pt, posp, k_scales=ks,
                                   v_scales=vs)
        again = torch.equal(PA.paged_attention(q, kq, vq, pt, posp,
                                               k_scales=ks, v_scales=vs),
                            batch)
        alone = [torch.equal(PA.paged_attention(
            q[i:i + 1].contiguous(), kq, vq, pt[i:i + 1].contiguous(),
            posp[i:i + 1].contiguous(), k_scales=ks, v_scales=vs)[0],
            batch[i]) for i in range(4)]
        check(again and all(alone), f"paged_attention_int8 "
              f"({str(dtype)[6:]}): rerun bit-identical {again}, alone == "
              f"in the batch per row {alone}")
    log("[kernels] int8 decode split: paged_attention_int8 reruns bit for "
        "bit and each sequence alone == in the batch of 4, bf16 and f32, "
        "llama_7b widths, pos 1040 / 3 / 520 / 0")


# the packed batch of the varlen rows and phase: GPT-125M attention widths
# (12 heads of 64), 9 sequences of 8192 tokens with an empty one between
# the 255 and 513 ones (a repeated cu_seqlens entry)
VARLEN_LENS = (1, 7, 64, 100, 255, 0, 513, 1024, 2048, 4180)
VARLEN_H, VARLEN_D = 12, 64


def _varlen_batch(torch, dtype, unequal=False, seed=0):
    """(q, k, v, dout, cu_q, cu_k, q lengths, k lengths): k lengths twice
    the q lengths when `unequal` (16384 keys)."""
    lq = list(VARLEN_LENS)
    lk = [2 * n for n in lq] if unequal else lq
    g = torch.Generator(device="cuda").manual_seed(SEED + 30 + seed)

    def randn(t):
        return torch.randn(t, VARLEN_H, VARLEN_D, generator=g,
                           device="cuda", dtype=dtype)

    q, dout = randn(sum(lq)), randn(sum(lq))
    k, v = randn(sum(lk)), randn(sum(lk))

    def cu(lens):
        return torch.tensor([0] + np.cumsum(lens).tolist(),
                            dtype=torch.int32, device="cuda")
    return q, k, v, dout, cu(lq), cu(lk), lq, lk


def _varlen_pairs(lq, lk, causal):
    """The (query, key) pairs the packing leaves (the work it needs)."""
    return sum(a * (a + 1) // 2 if causal else a * b
               for a, b in zip(lq, lk))


VARLEN_LIBRARY = {}     # which SDPA form the card's PyTorch dispatches


def _varlen_library(torch, q, k, v, dout, cu_q, cu_k, causal):
    """(forward, backward) of one PyTorch SDPA call on the same packed
    batch, yardsticks only: on `torch.nested` jagged tensors where this
    PyTorch dispatches them (empty sequences dropped), else with a
    block-diagonal boolean mask built here, outside the timed call.  The
    form taken is recorded in VARLEN_LIBRARY and logged."""
    import torch.nn.functional as F

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def njt(x, cu):
        offs = torch.unique_consecutive(cu.long())
        return torch.nested.nested_tensor_from_jagged(x, offs) \
            .transpose(1, 2)

    key = (str(q.dtype), causal, bool(torch.equal(cu_q, cu_k)))
    form = VARLEN_LIBRARY.get(key)
    if form is None:
        form = "nested jagged"
        try:   # probe only: the yardstick's form, not a result
            qn, kn, vn = (njt(x, c) for x, c in zip(leaves,
                                                     (cu_q, cu_k, cu_k)))
            out = F.scaled_dot_product_attention(qn, kn, vn,
                                                 is_causal=causal)
            torch.autograd.grad(out.transpose(1, 2).values(), leaves,
                                dout)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, ValueError, TypeError,
                AttributeError) as e:
            form = f"block-diagonal mask ({type(e).__name__}: " \
                f"{str(e).splitlines()[0][:80]})"
        VARLEN_LIBRARY[key] = form
    if form == "nested jagged":
        qn, kn, vn = (njt(x, c) for x, c in zip(leaves, (cu_q, cu_k, cu_k)))
        fwd = (lambda: F.scaled_dot_product_attention(
            qn, kn, vn, is_causal=causal))
        out = fwd().transpose(1, 2).values()
    else:
        tq, tk = q.shape[0], k.shape[0]
        sq = torch.searchsorted(cu_q, torch.arange(tq, device="cuda"),
                                right=True)
        sk = torch.searchsorted(cu_k, torch.arange(tk, device="cuda"),
                                right=True)
        mask = sq[:, None] == sk[None, :]
        if causal:
            mask &= torch.ones(tq, tk, dtype=torch.bool,
                               device="cuda").tril(tk - tq)
        qt, kt, vt = (x.transpose(0, 1)[None] for x in leaves)
        fwd = (lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask))
        out = fwd()[0].transpose(0, 1)
    return fwd, (lambda: torch.autograd.grad(out, leaves, dout,
                                             retain_graph=True))


def varlen_cases(torch, dtype, first=False):
    """varlen_fwd and varlen_bwd on the packed batch: causal and not,
    and not causal over keys packed twice as long (cu_q != cu_k).
    Bytes: q, k, v, o (and dO, dq, dk, dv) once each, the LSE; operations:
    4 (forward) or 10 (backward) * D per visible pair of the packing."""
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    h, d = VARLEN_H, VARLEN_D
    cases = []
    for label, causal, unequal in (
            ("causal T8192", True, False), ("full T8192", False, False),
            ("full Tq8192 Tk16384", False, True))[:1 if first else None]:
        q, k, v, dout, cq, ck, lq, lk = _varlen_batch(torch, dtype, unequal)
        pairs = _varlen_pairs(lq, lk, causal)
        tq, tk = sum(lq), sum(lk)
        lib_fwd, lib_bwd = _varlen_library(torch, q, k, v, dout, cq, ck,
                                           causal)
        cases.append((
            "varlen_fwd", f"{label} H12 D64",
            lambda q=q, k=k, v=v, a=cq, b=ck, c=causal:
                VA.varlen_fwd(q, k, v, a, b, causal=c),
            lambda q=q, k=k, v=v, a=cq, b=ck, c=causal:
                VA.varlen_fwd_reference(q, k, v, a, b, causal=c),
            lib_fwd, 2 * (tq + tk) * h * d * isz + h * tq * 4,
            4 * pairs * h * d, dname, 0))
        out, lse = VA.varlen_fwd(q, k, v, cq, ck, causal=causal)
        cases.append((
            "varlen_bwd", f"{label} H12 D64",
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, a=cq, b=ck,
            c=causal: VA.varlen_bwd(q, k, v, o, l, g, a, b, causal=c),
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, a=cq, b=ck,
            c=causal: VA.varlen_bwd_reference(q, k, v, o, l, g, a, b,
                                              causal=c),
            lib_bwd, 4 * (tq + tk) * h * d * isz + h * tq * 4,
            10 * pairs * h * d, dname, 0))
    return cases


def fused_norm_cases(torch, dtype, wdtype=None, first=False):
    """fused_norm at the fused paths' shapes: the gpt_1p3b serving block's
    LayerNorm [8 * 1024, 2048] (weight and shift, no residual), the
    ernie_base encoder's [32 * 512, 768], an RMS norm with bias and
    residual at [8192, 2048] (z written too) and an odd width of 1000;
    w and b in x's dtype, or in `wdtype` (f32: the labels say so).
    Bytes: x (and residual) read, y (and z) written, the vectors once;
    the f32 statistics bound nothing.  Library: F.layer_norm / F.rms_norm
    on the precomputed sum."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import fused_norm as FN

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    isz = torch.empty((), dtype=dtype).element_size()
    wd = dtype if wdtype is None else wdtype
    tag = "" if wdtype is None else f" w/b {str(wd).split('.')[1]}"
    cases = []
    for label, rows, d, kind, with_res in (
            ("ln gpt_1p3b [8192,2048]", 8 * 1024, 2048, "ln", False),
            ("ln ernie_base [16384,768]", 32 * 512, 768, "ln", False),
            ("rms+bias+res [8192,2048]", 8192, 2048, "rms", True),
            ("ln odd d [4096,1000]", 4096, 1000, "ln",
             False))[:1 if first else None]:
        label += tag
        x = torch.randn(rows, d, generator=g, device="cuda", dtype=dtype)
        w = 1 + 0.1 * torch.randn(d, generator=g, device="cuda", dtype=wd)
        b = None if kind == "rms" else 0.1 * torch.randn(
            d, generator=g, device="cuda", dtype=wd)
        bias = res = None
        if with_res:
            bias = torch.randn(d, generator=g, device="cuda", dtype=dtype)
            res = torch.randn(rows, d, generator=g, device="cuda",
                              dtype=dtype)
        z = FN.fused_norm_reference(x, None, None, bias, res, kind=kind)[1]
        z = x if z is None else z
        eps = 1e-5
        # the library call takes w / b in z's dtype
        wl, bl = (None if t is None else t.to(dtype) for t in (w, b))
        lib = (lambda z=z, w=wl, b=bl, d=d: F.layer_norm(z, (d,), w, b,
                                                        eps)) \
            if kind == "ln" else \
            (lambda z=z, w=wl, d=d: F.rms_norm(z, (d,), w, eps))
        nbytes = (2 + 2 * with_res) * rows * d * isz \
            + (2 * torch.empty((), dtype=wd).element_size()
               + with_res * isz) * d
        cases.append((
            "fused_norm", label,
            lambda x=x, w=w, b=b, bi=bias, r=res, k=kind:
                FN.fused_norm(x, w, b, bi, r, eps=eps, kind=k),
            lambda x=x, w=w, b=b, bi=bias, r=res, k=kind:
                FN.fused_norm_reference(x, w, b, bi, r, eps=eps, kind=k),
            lib, nbytes, 8 * rows * d, "float32", 0))
    return cases


def _vision_launches(batch):
    """Every distinct call that one bf16 forward of ResNet-50,
    MobileNetV2 and Swin-T at `batch` x 224x224 makes of `conv_bn_act`
    (x and w shapes, stride, padding, act) and of `window_attention`
    (qkv shape, heads, window, shift, whether a mask is passed), in the
    order first made: [(kernel, signature, {model: calls per forward})].
    The calls are recorded by wrapping the two wrappers for that forward;
    the kernel rows of phase 3 run at exactly these shapes."""
    import importlib
    from unittest import mock

    import torch

    from paddle_tpu_torch.ops.kernels import conv_norm as CN

    SW = importlib.import_module("paddle_tpu_torch.vision.models.swin")
    conv, win = CN.conv_bn_act, SW.window_attention
    seen = {}
    model = None

    def record(kernel, sig):
        uses = seen.setdefault((kernel, sig), {})
        uses[model] = uses.get(model, 0) + 1

    def conv_rec(x, w, scale, shift, stride=1, padding=0, act="relu"):
        record("conv_bn_act", (tuple(x.shape), tuple(w.shape),
                               CN._pair(stride), CN._pair(padding), act))
        return conv(x, w, scale, shift, stride, padding, act)

    def win_rec(qkv, bias, mask, window_size, shift, num_heads):
        record("window_attention", (tuple(qkv.shape), num_heads,
                                    window_size, shift, mask is not None))
        return win(qkv, bias, mask, window_size, shift, num_heads)

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(batch, 3, 224, 224, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    with mock.patch.object(CN, "conv_bn_act", conv_rec), \
            mock.patch.object(SW, "window_attention", win_rec), \
            torch.inference_mode():
        for model, kernel, per_fwd in VISION:
            _vision_model(model, "cuda", torch.bfloat16)(x)
            calls = sum(u.get(model, 0) for (k, _), u in seen.items()
                        if k == kernel)
            check(calls == per_fwd, f"kernels: {model} called {kernel} "
                  f"{calls} times in one forward, expected {per_fwd}")
    torch.cuda.empty_cache()
    return [(k, sig, uses) for (k, sig), uses in seen.items()]


def _swin_train_launches(batch):
    """Every distinct call that one bf16 O2 Swin-T train step at `batch` x
    224x224 (bench.py's step: Momentum, CrossEntropyLoss) makes of
    `window_attention_bwd` (qkv shape, heads, window, shift, whether a
    mask is passed), recorded by wrapping the wrapper for that step:
    [(signature, calls per step)].  The backward rows of phase 3 run at
    exactly these shapes."""
    from unittest import mock

    import torch

    from paddle_tpu_torch.ops.kernels import window_attention as WA

    bwd = WA.window_attention_bwd
    seen = {}

    def rec(qkv, bias, mask, g, window_size, shift, num_heads):
        sig = (tuple(qkv.shape), num_heads, window_size, shift,
               mask is not None)
        seen[sig] = seen.get(sig, 0) + 1
        return bwd(qkv, bias, mask, g, window_size, shift, num_heads)

    step, imgs, labels = _vision_train_step("swin_t", batch)
    with mock.patch.object(WA, "window_attention_bwd", rec):
        step._step(step._place((imgs, labels)))     # the eager body
    torch.cuda.synchronize()
    calls = sum(seen.values())
    check(calls == 12, f"kernels: one Swin-T train step called "
          f"window_attention_bwd {calls} times, expected 12")
    del step
    torch.cuda.empty_cache()
    # in the forward's order (the backward records stage 4 first): stage
    # 1 unshifted, the main row, comes first
    return sorted(seen.items(), key=lambda kv: (-kv[0][0][1], kv[0][3]))


def _vision_label(kernel, sig):
    if kernel == "conv_bn_act":
        (b, cin, h, _), (cout, cin_g, k, _), (st, _), _, act = sig
        dw = " dw" if cin_g == 1 and cout == cin else ""
        return f"B{b} {k}x{k}/s{st} {cin}->{cout} @{h} {act or 'none'}{dw}"
    (b, h, w, c3), heads, ws, shift, masked = sig
    return (f"B{b} {h}x{w} C{c3 // 3} h{heads} w{ws} shift{shift}"
            + (" mask" if masked else ""))


def conv_cases(torch, dtype, vision, first=False):
    """conv_bn_act at every shape `vision` recorded (ResNet-50's and
    MobileNetV2's at the served batch).  Weights scaled by 1/sqrt(fan_in),
    scale near 1 and shift near 0, so outputs stay below 4 (a bf16
    rounding there is under 2e-2).  Bytes: x, w, scale, shift read once
    and the output written once; operations: 2 per multiply-add, at the
    f32 rate for depthwise (no tensor cores).  Library yardstick: one
    F.conv2d(x, w * scale, shift) and the activation, the weight folded
    outside the timed call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import conv_norm as CN

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dev = "cuda"
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    cases = []
    for kernel, sig, _ in vision:
        if kernel != "conv_bn_act" or first and cases:
            continue
        xs, wsh, st, pad, act = sig
        b, cin = xs[:2]
        cout, cin_g, kh, kw = wsh
        dw = cin_g == 1 and cout == cin
        x = torch.randn(*xs, generator=g, device=dev, dtype=dtype)
        w = (torch.randn(*wsh, generator=g, device=dev)
             / math.sqrt(cin_g * kh * kw)).to(dtype)
        sc = 0.5 + 0.5 * torch.rand(cout, generator=g, device=dev)
        sh = 0.1 * torch.randn(cout, generator=g, device=dev)
        ho = (xs[2] + 2 * pad[0] - kh) // st[0] + 1
        wo = (xs[3] + 2 * pad[1] - kw) // st[1] + 1
        wf = (w.float() * sc[:, None, None, None]).to(dtype)
        bf = sh.to(dtype)
        groups = cin if dw else 1
        nbytes = (x.numel() + w.numel() + b * cout * ho * wo) * isz \
            + 2 * cout * 4
        flops = 2 * b * cout * ho * wo * cin_g * kh * kw
        cases.append((
            "conv_bn_act", _vision_label(kernel, sig),
            lambda x=x, w=w, sc=sc, sh=sh, st=st, pad=pad, act=act:
                CN.conv_bn_act(x, w, sc, sh, st, pad, act),
            lambda x=x, w=w, sc=sc, sh=sh, st=st, pad=pad, act=act, dw=dw:
                CN.conv_bn_act_reference(x, w, sc, sh, st, pad, act, dw),
            lambda x=x, wf=wf, bf=bf, st=st, pad=pad, act=act, gr=groups:
                CN._apply_act(F.conv2d(x, wf, bf, st, pad, 1, gr), act),
            nbytes, flops, "float32" if dw else dname, 0))
    return cases


def window_cases(torch, dtype, vision, first=False):
    """window_attention at every shape `vision` recorded (Swin-T's four
    stages at the served batch, shifted with the mask and not, stage 4
    one window with no shift); a seeded bias.  Bytes: qkv, bias, mask
    read once, the output written once; operations: 4 * ws^4 * head_dim
    per window and head.  Library yardstick:
    F.scaled_dot_product_attention on the partitioned [B*nW, heads, ws^2,
    head_dim] q, k, v with bias + mask as attn_mask; its time leaves out
    the roll and the partition, done outside the timed call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import window_attention as WA
    from paddle_tpu_torch.vision.models.swin import _shift_mask

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    dev = "cuda"
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    cases = []
    for kernel, sig, _ in vision:
        if kernel != "window_attention" or first and cases:
            continue
        (b, h, w, c3), heads, ws, shift, masked = sig
        c, p = c3 // 3, ws * ws
        qkv = torch.randn(b, h, w, c3, generator=g, device=dev, dtype=dtype)
        bias = torch.randn(heads, p, p, generator=g, device=dev)
        mask = torch.from_numpy(_shift_mask((h, w), ws, shift)).to(dev) \
            if masked else None
        nw = (h // ws) * (w // ws)
        x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
        wins = WA.window_partition(x, ws).reshape(b * nw, p, 3, heads,
                                                  c // heads)
        q, k, v = (wins[:, :, i].transpose(1, 2).contiguous()
                   for i in range(3))
        full = bias[None] if mask is None else bias[None] + mask[:, None]
        am = full.to(dtype).repeat(b, 1, 1, 1) if mask is not None \
            else full.to(dtype)
        nbytes = qkv.numel() * isz + bias.numel() * 4 \
            + (0 if mask is None else mask.numel() * 4) + b * h * w * c * isz
        flops = 4 * b * nw * heads * p * p * (c // heads)
        cases.append((
            "window_attention", _vision_label(kernel, sig),
            lambda qkv=qkv, bias=bias, mask=mask, heads=heads, ws=ws,
            sh=shift: WA.window_attention(qkv, bias, mask, ws, sh, heads),
            lambda qkv=qkv, bias=bias, mask=mask, heads=heads, ws=ws,
            sh=shift: WA.window_attention_reference(qkv, bias, mask, ws, sh,
                                                    heads),
            lambda q=q, k=k, v=v, am=am:
                F.scaled_dot_product_attention(q, k, v, attn_mask=am),
            nbytes, flops, dname, 0))
    return cases


def window_bwd_cases(torch, dtype, train, first=False):
    """window_attention_bwd at every shape `train` recorded (Swin-T's
    four stages in one bf16 train step at batch 128, shifted with the
    mask and not, stage 4 one window with no shift); a seeded bias and
    cotangent.  Bytes: qkv, g, bias, mask read once, dqkv and the summed
    dbias written once; operations: 10 * ws^4 * head_dim per window and
    head (the replayed scores, dP, dV, dQ, dK).  Library yardstick: the
    backward of F.scaled_dot_product_attention on the partitioned [B*nW,
    heads, ws^2, head_dim] q, k, v with bias + mask as attn_mask (no
    bias gradient); its forward, the roll and the partition run outside
    the timed call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import window_attention as WA
    from paddle_tpu_torch.vision.models.swin import _shift_mask

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    dev = "cuda"
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    cases = []
    for sig, _ in train[:1 if first else None]:
        (b, h, w, c3), heads, ws, shift, masked = sig
        c, p, hd = c3 // 3, ws * ws, c3 // 3 // heads
        qkv = torch.randn(b, h, w, c3, generator=g, device=dev, dtype=dtype)
        dout = torch.randn(b, h, w, c, generator=g, device=dev, dtype=dtype)
        bias = torch.randn(heads, p, p, generator=g, device=dev)
        mask = torch.from_numpy(_shift_mask((h, w), ws, shift)).to(dev) \
            if masked else None
        nw = (h // ws) * (w // ws)

        def parts(x, ch, shift=shift):
            x = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
            return WA.window_partition(x, ws).reshape(b * nw, p, ch, heads,
                                                      hd)

        wins = parts(qkv, 3)
        q, k, v = (wins[:, :, i].transpose(1, 2).contiguous()
                   .requires_grad_() for i in range(3))
        gt = parts(dout, 1)[:, :, 0].transpose(1, 2).contiguous()
        full = bias[None] if mask is None else bias[None] + mask[:, None]
        am = full.to(dtype).repeat(b, 1, 1, 1) if mask is not None \
            else full.to(dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        nbytes = (2 * qkv.numel() + dout.numel()) * isz \
            + 2 * bias.numel() * 4 \
            + (0 if mask is None else mask.numel() * 4)
        flops = 10 * b * nw * heads * p * p * hd
        cases.append((
            "window_attention_bwd", _vision_label("window_attention", sig),
            lambda qkv=qkv, bias=bias, mask=mask, d=dout, heads=heads, ws=ws,
            sh=shift: WA.window_attention_bwd(qkv, bias, mask, d, ws, sh,
                                              heads),
            lambda qkv=qkv, bias=bias, mask=mask, d=dout, heads=heads, ws=ws,
            sh=shift: WA.window_attention_bwd_reference(qkv, bias, mask, d,
                                                        ws, sh, heads),
            lambda out=out, q=q, k=k, v=v, gt=gt: torch.autograd.grad(
                out, (q, k, v), gt, retain_graph=True),
            nbytes, flops, dname, 0))
    return cases


def rope_cases(torch, dtype, first=False):
    """rope and its adjoint at the LLaMA path's shapes: the llama_7b
    prefill q [1, 1008, 32, 128] as the attention gives it (a strided
    view of the fused qkv projection, phases broadcast over the batch),
    a ragged decode step [4, 1, 32, 128] with per-row phases, the
    70B-width GQA k [1, 1008, 8, 128], and q and k of a llama_7b layer
    together, as the model launches them (one call, 32 + 32 heads of the
    fused qkv views): at the prefill and at the ragged decode step.
    Bytes: x read and the output written once, the phases once;
    operations: 3 per element."""
    from paddle_tpu_torch.nn.functional.attention import _rope_phases
    from paddle_tpu_torch.ops.kernels import rope as RP

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dev = "cuda"
    isz = torch.empty((), dtype=dtype).element_size()
    d, sb = 128, 1008
    qkv = torch.randn(1, sb, 3 * 32 * d, generator=g, device=dev,
                      dtype=dtype)
    q = qkv[..., :32 * d].reshape(1, sb, 32, d)
    k = qkv[..., 32 * d:64 * d].reshape(1, sb, 32, d)
    kv70 = torch.randn(1, sb, (64 + 16) * d, generator=g, device=dev,
                       dtype=dtype)
    k70 = kv70[..., 64 * d:72 * d].reshape(1, sb, 8, d)
    xd = torch.randn(4, 1, 32, d, generator=g, device=dev, dtype=dtype)
    qkvd = torch.randn(4, 1, 3 * 32 * d, generator=g, device=dev,
                       dtype=dtype)
    qd = qkvd[..., :32 * d].reshape(4, 1, 32, d)
    kd = qkvd[..., 32 * d:64 * d].reshape(4, 1, 32, d)
    start = 8                       # the bucket's 8 left-pad rows
    pos = torch.clamp(torch.arange(sb, device=dev) - start, min=0)[None]
    ragged = torch.tensor([[1031], [330], [551], [0]], device=dev)
    cases = []
    for label, x, second, ids in (
            ("prefill q B1 S1008 H32 D128 (qkv view)", q, None, pos),
            ("decode B4 S1 H32 D128 per-row", xd, None, ragged),
            ("70B GQA k B1 S1008 H8 D128 (qkv view)", k70, None, pos),
            ("q+k prefill B1 S1008 H32+32 D128 (qkv views)", q, k, pos),
            ("q+k decode B4 S1 H32+32 D128 per-row (qkv views)", qd, kd,
             ragged))[:1 if first else None]:
        cos, sin = (p.to(dtype) for p in _rope_phases(d, x.shape[1], 1e4,
                                                      ids, dev))
        n = x.numel() + (0 if second is None else second.numel())
        nbytes = 2 * n * isz + 2 * cos.numel() * isz
        for name, adj in (("rope", False), ("rope_bwd", True)):
            cases.append((
                name, label,
                lambda x=x, c=cos, s=sin, a=adj, k=second: RP.rope(
                    x, c, s, adjoint=a, k=k),
                lambda x=x, c=cos, s=sin, a=adj, k=second: (
                    RP.rope_reference(x, c, s, adjoint=a) if k is None
                    else (RP.rope_reference(x, c, s, adjoint=a),
                          RP.rope_reference(k, c, s, adjoint=a))),
                None, nbytes, 3 * n, "float32", 0))
    return cases


def bwd_cases(torch, dtype, first=False):
    """flash_fwd and flash_bwd at the train step's shape (GPT-125M: B8
    S1024 H12 D64, causal), flash_bwd at a GQA + pad-bias case (B2
    S1024, 12 query heads over 4 kv heads, keys before each row's start
    masked, causal), both at the encoder step's shape (phase 20:
    ernie_base, B32 S512 H12 D64, full) and flash_fwd at the fused
    serving block's (phase 19: gpt_1p3b, B8 S1024 H16 D128, full).  Pad
    query rows, which see no key, get a zero cotangent, as a loss that
    ignores pad positions gives them; then every row is compared."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dev = "cuda"
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    cases = []
    for label, b, s, hq, hkv, d, causal, starts, bwd in (
            ("causal B8 S1024 H12 D64 (train)", 8, 1024, 12, 12, 64, True,
             None, True),
            ("GQA 12/4 causal+pad B2 S1024 D64", 2, 1024, 12, 4, 64, True,
             (0, 100), True),
            ("full B32 S512 H12 D64 (encoder)", 32, 512, 12, 12, 64, False,
             None, True),
            ("full B8 S1024 H16 D128 (fused serve)", 8, 1024, 16, 16, 128,
             False, None, False))[:1 if first else None]:
        q, dout = (torch.randn(b, s, hq, d, generator=g, device=dev,
                               dtype=dtype) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev,
                            dtype=dtype) for _ in range(2))
        bias, bias_bytes = None, 0
        if starts is None:
            pairs = b * s * (s + 1) // 2 if causal else b * s * s
        else:
            st = torch.tensor(starts, device=dev)
            valid = torch.arange(s, device=dev)[None] >= st[:, None]
            bias = torch.where(valid, 0.0, -1e30)[:, None, None]
            bias_bytes = b * s * 4
            # causal: row i sees keys start..i, so rows before the start
            # see none (pad rows)
            dout = dout * valid[:, :, None, None].to(dtype)
            pairs = sum(_causal_pairs(torch, s, valid[i]) for i in range(b))
        if starts is None:
            cases.append((
                "flash_fwd", label,
                lambda q=q, k=k, v=v, c=causal: FA.flash_fwd(q, k, v,
                                                             causal=c),
                lambda q=q, k=k, v=v, c=causal: FA.flash_fwd_reference(
                    q, k, v, causal=c),
                _sdpa_library(q, k, v, None, causal),
                # q, k, v, o once each, lse
                4 * b * s * hq * d * isz + b * hq * s * 4,
                4 * pairs * hq * d, dname, 0))
        if not bwd:
            continue
        out, lse = FA.flash_fwd(q, k, v, bias=bias, causal=causal)
        cases.append((
            "flash_bwd", label,
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, m=bias, c=causal:
                FA.flash_bwd(q, k, v, o, l, g, bias=m, causal=c),
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, m=bias, c=causal:
                FA.flash_bwd_reference(q, k, v, o, l, g, bias=m, causal=c),
            _sdpa_bwd_library(q, k, v, dout, bias, causal),
            # q, o, dO, dq and k, v, dk, dv once each, lse, the bias
            4 * b * s * (hq + hkv) * d * isz + b * hq * s * 4 + bias_bytes,
            10 * pairs * hq * d, dname, 0))
    return cases


ERNIE_BATCH, ERNIE_SEQ = 32, 512     # phase 21's batch
VIT_BATCH, VIT_SEQ = 128, 197         # phase 16's ViT-B/16 row


def _ernie_lengths(rs, batch, seq):
    """Real lengths of an ERNIE batch: uniform in [seq / 2, seq], the
    tail padded."""
    return rs.randint(seq // 2, seq + 1, batch)


def encoder_cases(torch, dtype):
    """flash_fwd and flash_bwd at the encoder family's training shapes:
    ERNIE-base's (phase 21: full B32 S512 H12 D64 with the model's pad
    bias, (1 - mask) * -1e4 as [B, 1, 1, S] f32, real lengths 256-512:
    the biased tier, `_fwd_tb` / `_bwd_tb`) and ViT-B/16's (phase 16:
    full B128 S197 H12 D64, no mask: the native tier at a length that
    is not a multiple of 8).  Every key is read (a finite bias masks
    nothing out of the work), so the bound counts every pair; the
    library yardstick is SDPA with the bias as its `attn_mask`."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    h, d = 12, 64
    lens = torch.from_numpy(_ernie_lengths(np.random.RandomState(SEED),
                                           ERNIE_BATCH, ERNIE_SEQ)).cuda()
    mask = (torch.arange(ERNIE_SEQ, device="cuda")[None]
            < lens[:, None]).float()
    ernie_bias = ((1.0 - mask) * -1e4)[:, None, None, :]
    cases = []
    for label, b, s, bias in (
            (f"ernie full+pad B{ERNIE_BATCH} S{ERNIE_SEQ} H12 D64",
             ERNIE_BATCH, ERNIE_SEQ, ernie_bias),
            (f"vit full B{VIT_BATCH} S{VIT_SEQ} H12 D64", VIT_BATCH,
             VIT_SEQ, None)):
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device="cuda",
                                     dtype=dtype) for _ in range(4))
        pairs = b * s * s
        bias_bytes = 0 if bias is None else b * s * 4
        cases.append((
            "flash_fwd", label,
            lambda q=q, k=k, v=v, m=bias: FA.flash_fwd(q, k, v, bias=m),
            lambda q=q, k=k, v=v, m=bias: FA.flash_fwd_reference(
                q, k, v, bias=m),
            _sdpa_library(q, k, v, bias, False),
            4 * b * s * h * d * isz + b * h * s * 4 + bias_bytes,
            4 * pairs * h * d, dname, 0))
        out, lse = FA.flash_fwd(q, k, v, bias=bias)
        cases.append((
            "flash_bwd", label,
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, m=bias:
                FA.flash_bwd(q, k, v, o, l, g, bias=m),
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, m=bias:
                FA.flash_bwd_reference(q, k, v, o, l, g, bias=m),
            _sdpa_bwd_library(q, k, v, dout, bias, False),
            8 * b * s * h * d * isz + b * h * s * 4 + bias_bytes,
            10 * pairs * h * d, dname, 0))
    return cases


def _sdpa_dbias_library(q, k, v, dout, bias):
    """The backward of one F.scaled_dot_product_attention call whose
    `attn_mask` requires grad (yardstick only): dq, dk, dv and the
    mask's gradient from the kept graph (the mask in q's dtype, as SDPA
    takes it)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mt = bias.to(q.dtype).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mt)
    dt = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt, mt), dt,
                                       retain_graph=True)


TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT = 64, 256, 192


def dbias_cases(torch, dtype):
    """flash_bwd's dBias mode (a mask that requires grad, ROADMAP C1.2)
    at ERNIE-base's shape (B32 S512 H12 D64, full) with a [B, 1, 1, S]
    key-pad mask (-1e4 past each row's length, small trainable values
    elsewhere) and a [B, H, S, S] mask, and at Transformer-base's cross
    attention (B64 Sq192 Sk256 H8 D64) with a [1, H, Sq, Sk] mask; each
    beside the same backward without dBias ("no dBias": the mask as a
    constant bias).  The bound adds the mask's f32 read and its f32
    gradient's write to the backward's bytes; the yardstick is SDPA's
    backward with a `requires_grad` `attn_mask`."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    lens = torch.from_numpy(_ernie_lengths(np.random.RandomState(SEED),
                                           ERNIE_BATCH, ERNIE_SEQ)).cuda()
    keep = torch.arange(ERNIE_SEQ, device="cuda")[None] < lens[:, None]
    pad = torch.where(keep, 0.1 * torch.randn(
        keep.shape, generator=g, device="cuda"), -1e4)[:, None, None]
    b, s, h = ERNIE_BATCH, ERNIE_SEQ, 12
    tb, tq, tk = TRANSFORMER_BATCH, TRANSFORMER_TGT, TRANSFORMER_SRC
    cases = []
    for label, b, sq, sk, h, mask in (
            (f"ernie [B,1,1,S] B{b} S{s} H12 D64", b, s, s, h, pad),
            (f"ernie [B,H,S,S] B{b} S{s} H12 D64", b, s, s, h,
             0.5 * torch.randn(b, h, s, s, generator=g, device="cuda")),
            (f"transformer [1,H,Sq,Sk] B{tb} Sq{tq} Sk{tk} H8 D64", tb, tq,
             tk, 8, 0.5 * torch.randn(1, 8, tq, tk, generator=g,
                                      device="cuda"))):
        q, dout = (torch.randn(b, sq, h, 64, generator=g, device="cuda",
                               dtype=dtype) for _ in range(2))
        k, v = (torch.randn(b, sk, h, 64, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        out, lse = FA.flash_fwd(q, k, v, bias=mask)
        io = (4 * b * (sq + sk) * h * 64 * isz + b * h * sq * 4
              + mask.numel() * 4)
        for dbias in (True, False):
            cases.append((
                "flash_bwd", f"{'dBias' if dbias else 'no dBias'} {label}",
                lambda q=q, k=k, v=v, o=out, l=lse, d=dout, m=mask,
                dbias=dbias: FA.flash_bwd(q, k, v, o, l, d, bias=m,
                                          bias_grad=dbias),
                lambda q=q, k=k, v=v, o=out, l=lse, d=dout, m=mask,
                dbias=dbias: FA.flash_bwd_reference(q, k, v, o, l, d,
                                                    bias=m, bias_grad=dbias),
                _sdpa_dbias_library(q, k, v, dout, mask) if dbias
                else _sdpa_bwd_library(q, k, v, dout, mask, False),
                io + (mask.numel() * 4 if dbias else 0),
                10 * b * sq * sk * h * 64, dname, 0))
    return cases


def transformer_cases(torch, dtype):
    """flash_fwd and flash_bwd at the shapes and masks that phases 42 and
    43 give them, the mask in the inputs' dtype as the AMP gate casts
    it.  Phase 42 (B64 H8 D64, `_seq2seq_batch`'s lengths): the encoder
    self-attention (S256, the [B, 1, 1, 256] pad mask, -1e9 past each
    source), the decoder self-attention (S192,
    `generate_square_subsequent_mask(192)`: [192, 192], -inf above the
    diagonal, batch and head strides 0) and the cross attention (Sq192
    Sk256, the pad mask).  Phase 43's cached step (B8 H8 D64, Sq 1):
    flash_fwd of the self-attention with no mask over the first, a
    middle and the last step's keys (1, 37, 64) and of the cross
    attention over the 128 source keys under its [8, 1, 1, 128] pad
    mask.  A bias masks nothing out of the work, so the bound counts
    every pair; the yardstick is SDPA with the mask as its
    `attn_mask`."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    isz = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).split(".")[1]
    h, d = 8, 64
    b, sl, tl = TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT
    pad = torch.from_numpy(_seq2seq_batch(b, sl, tl)[3]).cuda().to(dtype)
    causal = torch.triu(torch.full((tl, tl), float("-inf"), device="cuda"),
                        1).to(dtype)
    dpad = torch.from_numpy(_seq2seq_batch(DECODE_SOURCES, DECODE_SRC, 8,
                                           seed=SEED + 3)[3]).cuda().to(dtype)
    cases = []
    for label, b, sq, sk, mask, bwd in (
            (f"transformer enc self [B,1,1,S] B{b} S{sl} H8 D64", b, sl, sl,
             pad, True),
            (f"transformer dec self [S,S] -inf B{b} S{tl} H8 D64", b, tl,
             tl, causal, True),
            (f"transformer cross [B,1,1,Sk] B{b} Sq{tl} Sk{sl} H8 D64", b,
             tl, sl, pad, True),
            (f"decode self B{DECODE_SOURCES} Sq1 Sk1 H8 D64", DECODE_SOURCES,
             1, 1, None, False),
            (f"decode self B{DECODE_SOURCES} Sq1 Sk37 H8 D64",
             DECODE_SOURCES, 1, 37, None, False),
            (f"decode self B{DECODE_SOURCES} Sq1 Sk{DECODE_STEPS} H8 D64",
             DECODE_SOURCES, 1, DECODE_STEPS, None, False),
            (f"decode cross [B,1,1,Sk] B{DECODE_SOURCES} Sq1 "
             f"Sk{DECODE_SRC} H8 D64", DECODE_SOURCES, 1, DECODE_SRC, dpad,
             False)):
        q, dout = (torch.randn(b, sq, h, d, generator=g, device="cuda",
                               dtype=dtype) for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        pairs = b * sq * sk
        # the kernels read the mask as f32
        mask_bytes = 0 if mask is None else mask.numel() * 4
        cases.append((
            "flash_fwd", label,
            lambda q=q, k=k, v=v, m=mask: FA.flash_fwd(q, k, v, bias=m),
            lambda q=q, k=k, v=v, m=mask: FA.flash_fwd_reference(
                q, k, v, bias=m),
            _sdpa_library(q, k, v, mask, False),
            # q, k, v, o once each, lse, the mask
            2 * b * (sq + sk) * h * d * isz + b * h * sq * 4 + mask_bytes,
            4 * pairs * h * d, dname, 0))
        if not bwd:
            continue
        out, lse = FA.flash_fwd(q, k, v, bias=mask)
        cases.append((
            "flash_bwd", label,
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, m=mask:
                FA.flash_bwd(q, k, v, o, l, g, bias=m),
            lambda q=q, k=k, v=v, o=out, l=lse, g=dout, m=mask:
                FA.flash_bwd_reference(q, k, v, o, l, g, bias=m),
            _sdpa_bwd_library(q, k, v, dout, mask, False),
            # q, o, dO, dq and k, v, dk, dv once each, lse, the mask
            4 * b * (sq + sk) * h * d * isz + b * h * sq * 4 + mask_bytes,
            10 * pairs * h * d, dname, 0))
    return cases


def _reruns_bit_identical(torch):
    """No atomics: two bf16 runs of flash_fwd and flash_bwd at the train
    shape (causal B8 S1024 H12 D64), of varlen_bwd on the packed batch
    (causal), of conv_bn_act at ResNet-50's 3x3/s1 256->256 @14 (B64),
    of window_attention and window_attention_bwd at Swin-T's stage 1
    (B128 56x56 C96, 3 heads, no shift), of fused_norm at the
    encoder's [16384, 768] (LayerNorm with bias and residual, y and z)
    and of paged_attention and decode_attention at the llama_7b decode
    rows give the same bits."""
    from paddle_tpu_torch.ops.kernels import conv_norm as CN
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import fused_norm as FN
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA
    from paddle_tpu_torch.ops.kernels import window_attention as WA

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v, dout = (torch.randn(8, 1024, 12, 64, generator=g,
                                 device="cuda", dtype=torch.bfloat16)
                     for _ in range(4))
    runs = []
    for _ in range(2):
        out, lse = FA.flash_fwd(q, k, v, causal=True)
        runs.append((out, lse) + FA.flash_bwd(q, k, v, out, lse, dout,
                                              causal=True))
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    check(all(same), f"flash_fwd / flash_bwd reruns differ (out, lse, dq, "
          f"dk, dv equal: {same})")
    q, k, v, dout, cq, ck, _, _ = _varlen_batch(torch, torch.bfloat16)
    out, lse = VA.varlen_fwd(q, k, v, cq, ck, causal=True)
    runs = [VA.varlen_bwd(q, k, v, out, lse, dout, cq, ck, causal=True)
            for _ in range(2)]
    same_v = [torch.equal(a, b) for a, b in zip(*runs)]
    check(all(same_v), f"varlen_bwd reruns differ (dq, dk, dv equal: "
          f"{same_v})")
    bf = dict(generator=g, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(64, 256, 14, 14, **bf)
    w = torch.randn(256, 256, 3, 3, **bf) / 48
    sc, sh = torch.rand(256, device="cuda") + 0.5, torch.zeros(
        256, device="cuda")
    same_c = torch.equal(CN.conv_bn_act(x, w, sc, sh, 1, 1, "relu"),
                         CN.conv_bn_act(x, w, sc, sh, 1, 1, "relu"))
    check(same_c, "conv_bn_act reruns differ (3x3/s1 256->256 @14 B64)")
    qkv = torch.randn(128, 56, 56, 288, **bf)
    dout = torch.randn(128, 56, 56, 96, **bf)
    bias = torch.randn(3, 49, 49, generator=g, device="cuda")
    runs = [WA.window_attention_bwd(qkv, bias, None, dout, 7, 0, 3)
            for _ in range(2)]
    same_w = [torch.equal(a, b) for a, b in zip(*runs)]
    check(all(same_w), f"window_attention_bwd reruns differ (dqkv, dbias "
          f"equal: {same_w})")
    check(torch.equal(WA.window_attention(qkv, bias, None, 7, 0, 3),
                      WA.window_attention(qkv, bias, None, 7, 0, 3)),
          "window_attention reruns differ (stage 1 B128)")
    x, res = (torch.randn(32 * 512, 768, **bf) for _ in range(2))
    w, b, bi = (torch.randn(768, **bf) for _ in range(3))
    runs = [FN.fused_norm(x, w, b, bi, res, eps=1e-5, kind="ln")
            for _ in range(2)]
    same_n = [torch.equal(a, b) for a, b in zip(*runs)]
    check(all(same_n), f"fused_norm reruns differ (y, z equal: {same_n})")
    dec = llama_decode_cases(torch, torch.bfloat16)
    same_d = [torch.equal(run(), run()) for _, _, run, *_ in dec]
    check(all(same_d), f"paged_attention / decode_attention reruns differ "
          f"(llama_7b widths, equal: {same_d})")
    log("[kernels] bf16 reruns bit-identical: flash_fwd (out, lse), "
        "flash_bwd (dq, dk, dv) at causal B8 S1024 H12 D64, varlen_bwd "
        "on the causal T8192 packing, conv_bn_act at 3x3/s1 256->256 @14 "
        "B64, window_attention and window_attention_bwd (dqkv, dbias) at "
        "stage 1 B128, fused_norm (y, z) at LN + bias + residual "
        "[16384,768], paged_attention and decode_attention at the "
        "llama_7b decode rows")


def f16_cases(torch, vision, train):
    """The float16 rows of phase 3: flash_fwd and flash_bwd at the train
    shape (phase 28's O1 loop), then every other kernel at its main
    path's shape (its bf16 JSON row's), forward and backward; fused_norm
    also with w / b in f32 beside the first case's f16 (the fused
    serving block's)."""
    f16 = torch.float16
    return (bwd_cases(torch, f16, first=True)
            + kernel_cases(torch, f16, vision, train, main=True)
            + fused_norm_cases(torch, f16, wdtype=torch.float32, first=True))


# phase 3 rows that also get profiled device times and host times
DEVICE_TIMED = ("fused_norm", "relayout_to_hm", "relayout_from_hm",
                "paged_attention", "decode_attention",
                "paged_attention_int8", "rope", "rope_bwd")


def phase_kernels():
    """Every case of `kernel_cases` in f32 and bf16: held against its
    plain version, then timed.  Returns {(kernel, dtype): row} (the
    first case of each kernel, flash_fwd's cold prefill, with the worst
    error over all its cases) for the JSON line."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vision = _vision_launches(VISION_BATCH)
    train = _swin_train_launches(SWIN_TRAIN_BATCH)
    table, worst, times = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[1]
        tol = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL,
               torch.float16: F16_TOL}[dtype]
        cases = (kernel_cases(torch, dtype, vision, train)
                 if dtype != torch.float16 else
                 f16_cases(torch, vision, train)) \
            + dbias_cases(torch, dtype) + transformer_cases(torch, dtype)
        for name, label, run, plain, lib, nbytes, flops, ops_dtype, real \
                in cases:
            got, want = run(), plain()
            rel = None
            if name == "window_attention_bwd":    # (dqkv, dbias)
                check(all(bool(torch.isfinite(x).all()) for x in got),
                      f"{name} [{label} {dname}] non-finite gradient")
                errs = [(a.float() - r.float()).abs().max().item()
                        for a, r in zip(got, want)]
                # each held relative to its largest reference gradient
                refs = [r.float().abs().max().item() for r in want]
                err = max(errs)
                i = max(range(2), key=lambda i: errs[i] / refs[i])
                rel, ref_max = errs[i] / refs[i], refs[i]
            elif name == "fused_norm":     # (y, z or None)
                check(bool(torch.isfinite(got[0]).all()),
                      f"{name} [{label} {dname}] non-finite output")
                err = (got[0].float() - want[0].float()).abs().max().item()
                if want[1] is not None:    # the same rounded adds
                    err = max(err, (got[1].float() - want[1].float())
                              .abs().max().item())
                    if dtype != torch.float32:
                        check(torch.equal(got[1], want[1]),
                              f"{name} [{label} {dname}] z differs from "
                              "the plain version's bit for bit")
                # held relative to the largest |y|: bf16 rounds values
                # up to ~5 here, where one ulp exceeds 2e-2
                ref_max = want[0].float().abs().max().item()
                rel = err / ref_max
            elif name in ("flash_bwd", "varlen_bwd") and len(got) == 4:
                # the dBias mode: (dq, dk, dv, dbias), each held relative
                # to its largest reference gradient
                check(all(bool(torch.isfinite(x).all()) for x in got),
                      f"{name} [{label} {dname}] non-finite gradient")
                check(got[3].shape == want[3].shape,
                      f"{name} [{label} {dname}] dbias shape")
                errs = [(a.float() - r.float()).abs().max().item()
                        for a, r in zip(got, want)]
                refs = [r.float().abs().max().item() for r in want]
                err = max(errs)
                i = max(range(4), key=lambda i: errs[i] / refs[i])
                rel, ref_max = errs[i] / refs[i], refs[i]
            elif name in ("flash_bwd", "varlen_bwd"):   # (dq, dk, dv)
                check(all(bool(torch.isfinite(x).all()) for x in got),
                      f"{name} [{label} {dname}] non-finite gradient")
                err = max((a.float() - r.float()).abs().max().item()
                          for a, r in zip(got, want))
                # held relative to the largest reference gradient
                ref_max = max(r.float().abs().max().item() for r in want)
                rel = err / ref_max
            elif name in ("rope", "rope_bwd"):   # a tensor or (q, k)
                pairs = list(zip(got, want)) if isinstance(got, tuple) \
                    else [(got, want)]
                err = max((a.float() - r.float()).abs().max().item()
                          for a, r in pairs)
                # f32 math rounded once, in the plain version's order
                check(all(torch.equal(a, r) for a, r in pairs),
                      f"{name} [{label} {dname}] differs from the plain "
                      f"version bit for bit (max_abs_err {err:.3g})")
            elif isinstance(got, tuple):   # flash / varlen: (out, lse)
                check(bool(torch.isfinite(got[0]).all())
                      and bool(torch.isfinite(got[1]).all()),
                      f"{name} [{label} {dname}] non-finite output")
                err = (got[0][:, real:].float()
                       - want[0][:, real:].float()).abs().max().item()
                # the LSE is f32 from the same inputs in both dtypes
                lerr = (got[1][..., real:] - want[1][..., real:]).abs() \
                    .max().item()
                check(math.isfinite(lerr) and lerr <= F32_TOL,
                      f"{name} [{label} {dname}] lse max_abs_err "
                      f"{lerr:.3g} > {F32_TOL}")
                err = max(err, lerr)
            else:
                err = (got.float() - want.float()).abs().max().item()
            torch.cuda.synchronize()
            held = err if rel is None else rel
            check(math.isfinite(held) and held <= tol,
                  f"{name} [{label} {dname}] "
                  f"{'max_abs_err' if rel is None else 'max_rel_err'} "
                  f"{held:.3g} > {tol}")
            ms = time_ms(run)
            pms = time_ms(plain)
            lms = time_ms(lib) if lib is not None else None
            bms, by = bound_ms(nbytes, flops, ops_dtype)
            times[(name, label, dname)] = (ms, pms, lms, bms)
            if name in DEVICE_TIMED:
                # short kernels: the CUDA events read the wrapper's host
                # time, so the profiler's device time beside them
                lib_dev = "null" if lib is None else \
                    f"{device_ms(lib):.4f}"
                lib_host = "null" if lib is None else f"{host_us(lib):.1f}"
                log(f"[kernels] {name:16s} {label:36s} {dname:8s} device_ms"
                    f" kernel {device_ms(run):.4f} library {lib_dev} "
                    f"(CUDA-event {ms:.4f} / "
                    f"{'null' if lms is None else f'{lms:.4f}'}); wrapper "
                    f"host_us {host_us(run):.1f}, library call host_us "
                    f"{lib_host}")
            log(f"[kernels] {name:16s} {label:36s} {dname:8s} max_abs_err "
                f"{err:.3g}"
                + ("" if rel is None else
                   f" (rel {rel:.3g} of max |ref| {ref_max:.3g})")
                + f" (tol {tol}) kernel_ms {ms:.4f} plain_ms "
                f"{pms:.4f} library_ms "
                f"{'null' if lms is None else f'{lms:.4f}'} bound_ms "
                f"{bms:.5f} ({by})")
            # the JSON row: each kernel at its bf16 main-path shape (the
            # first case of each kernel; flash_fwd's cold prefill is kept
            # as the serving path's case)
            key = (name, dname)
            worst[key] = max(worst.get(key, 0.0), err)
            row = dict(name=name, case=label, dtype=dname, ms=ms,
                       plain_ms=pms, library_ms=lms, bound_ms=bms,
                       bound_by=by)
            if name == "flash_fwd" and dname != "float16":
                if "pad B1" in label:
                    table[key] = row
            elif "dBias" in label:
                # the dBias rows ride on flash_bwd's JSON row
                table.setdefault(("flash_bwd dbias", dname), []).append(
                    dict(row, max_abs_err=err))
                continue
            else:
                table.setdefault(key, row)
    for key, row in table.items():
        if key in worst:
            row["max_abs_err"] = worst[key]
    # each vision kernel's time in one forward: its rows weighted by the
    # calls each model makes at that shape
    for model, kernel, per_fwd in VISION:
        for dname in ("float32", "bfloat16"):
            tot = [0.0, 0.0, 0.0, 0.0]
            for k, sig, uses in vision:
                if model in uses:
                    t = times[(k, _vision_label(k, sig), dname)]
                    for i in range(4):
                        tot[i] += uses[model] * t[i]
            log(f"[kernels] {model} B{VISION_BATCH} {dname}: {kernel} x"
                f"{per_fwd} per forward, kernel {tot[0]:.3f} ms, plain "
                f"{tot[1]:.3f} ms, library {tot[2]:.3f} ms, bound "
                f"{tot[3]:.4f} ms")
    # the backward kernel's time in one Swin-T train step
    for dname in ("float32", "bfloat16"):
        tot = [0.0, 0.0, 0.0, 0.0]
        for sig, calls in train:
            t = times[("window_attention_bwd",
                       _vision_label("window_attention", sig), dname)]
            for i in range(4):
                tot[i] += calls * t[i]
        log(f"[kernels] swin_t train step B{SWIN_TRAIN_BATCH} {dname}: "
            f"window_attention_bwd x{sum(c for _, c in train)} per step, "
            f"kernel {tot[0]:.3f} ms, plain {tot[1]:.3f} ms, library "
            f"{tot[2]:.3f} ms, bound {tot[3]:.4f} ms")
    for key, form in VARLEN_LIBRARY.items():
        log(f"[kernels] varlen library yardstick {key}: SDPA on {form}")
    _reruns_bit_identical(torch)
    _decode_bits(torch)
    _int8_bits(torch)
    K.reset_launches()   # comparison launches do not count
    return table


# ----------------------------------------------------------------- phase 4
def _prompts(vocab):
    rs = np.random.RandomState(SEED)
    solo = {n: rs.randint(0, vocab, (n,)).astype(np.int32)
            for n in (37, 128, 300, 517, 1000)}
    prefix = rs.randint(0, vocab, (512,)).astype(np.int32)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, (40,)).astype(
        np.int32)]) for _ in range(3)]
    # the first shared-prefix request rides the first admission wave, so
    # its committed prefix is cached when the other two are admitted
    return [shared[0], solo[37], solo[128], solo[300], solo[517],
            solo[1000], shared[1], shared[2]]


def _count_forwards(model):
    """A list that grows by one per model forward (the engine's and
    generate()'s calls alike), and the hook handle to remove."""
    calls = []
    return calls, model.register_forward_hook(
        lambda mod, args, out: calls.append(1))


def _rope_launches_per_forward(counts, cfg, forwards, what):
    """rope rotates q and k of every layer of every forward in one launch
    a layer; a model without rope launches it never."""
    uses_rope = getattr(cfg, "use_rope", True)
    want = cfg.num_layers * forwards if uses_rope else 0
    check(counts["rope"] == want,
          f"{what}: rope launched {counts['rope']} times in {forwards} "
          f"forwards, expected {want}")


def _serve_passes(eng, prompts, passes=2, new_tokens=32):
    """`passes` rounds of the same requests, all submitted at once to the
    engine's loop thread, the prefix cache cleared before each round (so
    every round makes the same prefills: the first captures their
    programs, the later ones replay them).  Per round: the wall time,
    each request's time to its first token, the outputs and handles, the
    wall ms of each prefill (`engine._prefill`, which ends reading the
    first token back) by (cold / warm, bucket), the decode steps' (or
    spec passes') wall ms, the prefix-cache hits, and the prefill
    programs the engine holds after it (0 where the engine keeps
    none)."""
    import torch

    rounds, prefill = [], eng._prefill
    decode, spec = eng._decode, eng._spec_decode
    step_ms, prefill_ms = [], {}

    def timed(step):
        def run(running):
            t = time.perf_counter()
            step(running)         # ends in a device->host token copy
            step_ms.append((time.perf_counter() - t) * 1e3)
        return run

    def timed_prefill(seq):
        shared = int(seq.shared_len or 0)
        key = ("warm" if shared else "cold",
               eng._bucket(seq.resume_prompt().size - shared))
        t = time.perf_counter()
        prefill(seq)
        prefill_ms.setdefault(key, []).append(
            (time.perf_counter() - t) * 1e3)

    eng._decode, eng._spec_decode = timed(decode), timed(spec)
    eng._prefill = timed_prefill
    try:
        for _ in range(passes):
            eng.clear_prefix_cache()
            step_ms.clear()
            prefill_ms.clear()
            hits0 = eng.prefix_cache_stats()["hits"]
            torch.cuda.synchronize()
            eng.start()
            try:
                t0 = time.perf_counter()
                handles = [eng.submit(p, max_new_tokens=new_tokens)
                           for p in prompts]
                first = [None] * len(handles)

                def watch(i, h):
                    for _ in h.stream(timeout=600):
                        if first[i] is None:
                            first[i] = time.perf_counter() - t0

                threads = [threading.Thread(target=watch, args=(i, h),
                                            daemon=True)
                           for i, h in enumerate(handles)]
                for t in threads:
                    t.start()
                outs = [h.result(timeout=600) for h in handles]
                for t in threads:
                    t.join(timeout=60)
                wall = time.perf_counter() - t0
            finally:
                eng.stop()
            torch.cuda.synchronize()
            rounds.append(dict(
                wall=wall, ttft=sorted(first), outs=outs, handles=handles,
                gen=sum(len(o) - len(p) for p, o in zip(prompts, outs)),
                step_ms=list(step_ms),
                prefill_ms={k: list(v) for k, v in prefill_ms.items()},
                hits=eng.prefix_cache_stats()["hits"] - hits0,
                programs=len(getattr(eng, "_prefills", {}))))
    finally:
        eng._decode, eng._spec_decode, eng._prefill = decode, spec, prefill
    return rounds


def _round_line(r):
    """One serving round as text: tokens/s, TTFT p50 and max, the mean
    decode step, the mean prefill wall by (kind, bucket)."""
    ttft = r["ttft"]
    pre = ", ".join(f"{kind} S{sb} {np.mean(v):.2f} (x{len(v)})"
                    for (kind, sb), v in sorted(r["prefill_ms"].items(),
                                                key=lambda kv: kv[0][1]))
    return (f"{r['gen'] / r['wall']:.1f} tokens/s in {r['wall']:.3f}s, TTFT "
            f"p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms (max "
            f"{1e3 * ttft[-1]:.1f}), mean decode step "
            f"{np.mean(r['step_ms']):.2f} ms over {len(r['step_ms'])} steps,"
            f" prefix hits {r['hits']}; prefill wall ms by bucket: {pre}")


def phase_serve(model, cfg, name, kv_precision=None, refs=None):
    """The engine with the default EngineConfig (and `kv_precision`):
    the 8 requests x 32 tokens served twice, the prefix cache cleared in
    between (the first round captures the prefill programs of its
    buckets, the second replays them): TTFT and tokens/s of each round,
    the mean prefill wall by bucket, the engine's peak and reserved
    memory.  Every decode forward launches the tier's paged kernel once
    per layer and the other tier's never; the model's forward runs only
    for the first run and the capture of each new prefill program (every
    decode step and every later prefill replays a graph).  With `refs`
    (each prompt's sequential greedy `generate()` stream, 32 tokens) the
    streams are held to them by the near-tie rule, relative to the
    step's largest logit (`_near_ties`, NEAR_TIE_ULPS): every token on
    the exact tier, the first (the prefill's, before any int8 page is
    read) on the int8 tier, whose streams' equal lengths are logged."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.ops import kernels as K

    prompts = _prompts(cfg.vocab_size)
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, EngineConfig(kv_precision=kv_precision))
    check((eng.config.page_size, eng.config.max_slots,
           eng.config.decode_chunk, eng.config.prefill_bucket,
           eng.config.prefix_cache) == (16, 4, 1, 16, True),
          "EngineConfig defaults changed")
    # warm-up request (allocator, cuBLAS handles, the decode program and
    # the 16-token bucket's prefill program), not measured
    eng.generate([prompts[1][:16]], max_new_tokens=2)
    programs0 = len(eng._prefills)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards, hook = _count_forwards(model)
    K.reset_launches()
    rounds = _serve_passes(eng, prompts)
    counts = K.launch_counts()
    hook.remove()
    peak, reserved = (torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_reserved())
    for r in rounds:
        for p, o, h in zip(prompts, r["outs"], r["handles"]):
            check(len(o) == len(p) + 32 and h.finish_reason == "length",
                  f"request {h.request_id} finished {h.finish_reason} with "
                  f"{len(o) - len(p)} tokens")
            check(((o >= 0) & (o < cfg.vocab_size)).all(),
                  "token out of vocab")
        check(r["hits"] >= 2, f"prefix cache hits {r['hits']}: warm "
              "prefill did not run")
    for a, b in zip(*(r["outs"] for r in rounds)):
        check(np.array_equal(a, b), "serve: the replayed round's streams "
              "differ from the capturing round's")
    paged, other = ("paged_attention_int8", "paged_attention") \
        if kv_precision == "int8" else ("paged_attention",
                                        "paged_attention_int8")
    steps = sum(len(r["step_ms"]) for r in rounds)
    prefills = sum(len(v) for r in rounds for v in r["prefill_ms"].values())
    new = len(eng._prefills) - programs0
    check(counts["flash_fwd"] > 0, "serving path never launched flash_fwd")
    # decode_chunk 1: one model forward per decode step
    check(counts[paged] == cfg.num_layers * steps,
          f"serve: {paged} launched {counts[paged]} times in "
          f"{steps} decode forwards, expected {cfg.num_layers} "
          "per forward")
    check(counts[other] == 0, f"serve: {other} launched {counts[other]} "
          f"times under kv_precision={kv_precision}")
    # the model's forward hook fires for the first run and the capture of
    # each new prefill program, never for a replay
    check(len(forwards) == 2 * new and len(eng._programs) == 1
          and rounds[1]["programs"] == rounds[0]["programs"],
          f"serve: {len(forwards)} model calls for {new} new prefill "
          f"programs ({rounds[0]['programs']} after the first round, "
          f"{rounds[1]['programs']} after the second), "
          f"{len(eng._programs)} decode programs: a step did not replay")
    # a new program's first prefill runs eagerly before its capture (the
    # capture launches nothing); every later one is a replay
    check(counts["flash_fwd"] == cfg.num_layers * prefills,
          f"serve: flash_fwd launched {counts['flash_fwd']} times for "
          f"{prefills} prefills")
    _rope_launches_per_forward(counts, cfg, prefills + steps
                               * eng.config.decode_chunk, "serve")
    st = eng.stats()
    dn = _dn(model.dtype)
    log(f"[serve] {name} {dn} {cfg.num_layers}L kv {st['kv_precision']}: "
        f"{len(prompts)} requests x 32 tokens, twice; page_bytes "
        f"{st['page_bytes']} x {eng.config.num_pages} pages, "
        f"{len(forwards)} forwards ({new} prefill programs captured), "
        f"{paged} {counts[paged] / max(1, steps):.0f} per decode "
        f"forward, launches {json.dumps(counts)}")
    for i, r in enumerate(rounds):
        log(f"[serve] {name} kv {st['kv_precision']} round {i + 1} "
            f"({'captures' if i == 0 else 'replays'}): {_round_line(r)}")
    log(f"[serve] {name} kv {st['kv_precision']} memory: peak allocated "
        f"{peak / 2**30:.2f} GiB, reserved {reserved / 2**30:.2f} GiB, "
        f"{base / 2**30:.2f} GiB allocated before the engine")
    what = f"serve {name} {dn} kv {st['kv_precision']}"
    if refs is not None:
        same, near = _near_ties(
            model, prompts, rounds[1]["outs"], refs, what, "generate()",
            ulps=NEAR_TIE_ULPS, first=1 if kv_precision else None)
        # how far each stream runs equal to generate() (the int8 tier's
        # later tokens read quantized pages: a reading, not a check)
        agree = [int(np.argmax(np.append(o[len(p):] != r[len(p):], True)))
                 for p, o, r in zip(prompts, rounds[1]["outs"], refs)]
        log(f"[serve] {what}: {same}/{len(prompts)} streams equal to "
            f"sequential greedy generate() "
            f"({'first tokens' if kv_precision else 'every token'}); "
            f"near-ties (prompt length, token, top-2 margin; limit "
            f"{NEAR_TIE_ULPS} ulps of the step's max |logit|) {near}; "
            f"tokens equal before the first difference, per stream {agree}")
    _engine_replay_equals_eager(eng, what)
    _prefill_replay_equals_eager(eng, what)
    return counts


def _prefill_replay_equals_eager(eng, what):
    """Each prefill program of the engine replayed on seeded inputs and
    its eager body run on the same static inputs from equal pools: the
    first token, every pool and scale table without scratch page 0
    (garbage by design: the pack writes it once per scratch entry, in no
    defined order) and the int8 tier's staging buffers, bit for bit.  With
    a draft model, its prefill graph (replayed after the target's) and
    its body too, and its pools."""
    import torch

    rs = np.random.RandomState(SEED + 9)
    ps = eng.config.page_size
    state = eng._prefill_tensors()
    n_pools = len(eng._pool_tensors())
    n = 0
    with torch.inference_mode():
        for prog in eng._prefills.values():
            sb, npp = prog.sb, prog.npp
            npb = prog.pages.numel()
            ids = rs.randint(0, eng._model.cfg.vocab_size, (1, sb)).astype(
                np.int32)
            pages = np.append(rs.permutation(npb - 1) + 1, 0).astype(np.int32)
            plen, prefix = 0, None
            if npp is not None:
                plen = npp * ps - ps // 2
                prefix = np.append(np.arange(npb, npb + npp - 1), 0).astype(
                    np.int32)
                if eng._quant:
                    for t in eng._stage_k + eng._stage_v:
                        t[:npp].normal_()
            start = [t.clone() for t in state]
            eng._load_prefill(prog, ids, min(3, sb - 1), pages, plen,
                              None if prog.prefix_pages is None else prefix)
            eng._replay_prefill(prog)
            tok, after = int(prog.tok[0]), [t.clone() for t in state]
            for t, s in zip(state, start):
                t.copy_(s)
            del start
            eng._prefill_body_all(prog)
            torch.cuda.synchronize()
            check(tok == int(prog.tok[0]), f"{what}: prefill S{sb} p{npp} "
                  f"replayed first token {tok} != the eager body's "
                  f"{int(prog.tok[0])}")
            diff = [i for i, (a, t) in enumerate(zip(after, state))
                    if not (torch.equal(a[1:], t[1:]) if i < n_pools
                            else torch.equal(a, t))]
            del after
            check(not diff, f"{what}: prefill S{sb} p{npp}: {len(diff)} of "
                  f"{len(state)} pools / scale tables / staging buffers "
                  f"differ between the replay and the eager body (first "
                  f"#{diff[:1]}; page 0 left out)")
            n += 1
    log(f"[graphs] {what}: {n} prefill programs (cold and warm"
        f"{', each with its draft graph' if eng._draft else ''}), replay == "
        f"eager body bit for bit (first token, {n_pools} pools / scale "
        f"tables without scratch page 0, {len(state) - n_pools} staging "
        "buffers)")


def _engine_replay_equals_eager(eng, what, steps=4):
    """`steps` decode steps of every slot through the engine's captured
    program (`_run_decode`, a graph replay each) and the same steps
    through its eager body (`_decode_body`) from equal copies of the
    pools: the tokens, and every pool and scale table after the steps,
    bit for bit.  Every slot is live on pages of its own, so no two rows
    write one pool slot (free slots share scratch page 0, where the last
    of several writes is not defined)."""
    import torch

    s_, p_ = eng.config.max_slots, eng.max_pages_per_seq
    n = eng.config.decode_chunk
    check(s_ * p_ < eng.config.num_pages, f"{what}: the pool cannot hold "
          f"{s_} slots of {p_} pages")
    rs = np.random.RandomState(SEED + 5)
    pt = (1 + np.arange(s_ * p_, dtype=np.int32)).reshape(s_, p_)
    lengths0 = rs.randint(0, eng.config.max_seq_len - steps * n,
                          s_).astype(np.int32)
    tok0 = rs.randint(0, eng._model.cfg.vocab_size, s_).astype(np.int32)
    pools = eng._pool_tensors()
    dev = eng._device

    def run(one):
        out, tok, lengths = [], tok0, lengths0
        for _ in range(steps):
            toks = one(tok, lengths)
            out.append(toks)
            tok, lengths = toks[:, -1].copy(), lengths + n
        return np.stack(out)

    def eager(tok, lengths):
        toks = torch.zeros(s_, n, dtype=torch.int32, device=dev)
        eng._decode_body(n, *(torch.from_numpy(a).to(dev)
                              for a in (tok, pt, lengths)), toks)
        return toks.cpu().numpy()

    with torch.inference_mode():
        start = [p.clone() for p in pools]
        replayed = run(lambda tok, lengths: eng._run_decode(n, tok, pt,
                                                            lengths))
        after = [p.clone() for p in pools]
        for p, s in zip(pools, start):
            p.copy_(s)
        del start
        direct = run(eager)
        torch.cuda.synchronize()
        diff = [i for i, (a, p) in enumerate(zip(after, pools))
                if not torch.equal(a, p)]
    check(np.array_equal(replayed, direct), f"{what}: replayed decode "
          f"tokens {replayed[:, :, -1].tolist()} differ from the eager "
          f"body's {direct[:, :, -1].tolist()}")
    check(not diff, f"{what}: {len(diff)} of {len(pools)} pools and scale "
          f"tables differ between the replay and the eager body (first "
          f"#{diff[:1]})")
    log(f"[graphs] {what}: {steps} decode steps x {s_} slots, replay == "
        f"eager body bit for bit (tokens and {len(pools)} pools / scale "
        "tables)")


# ----------------------------------------------------------------- phase 5
def _generate_loop(model, ids, max_new, start=None):
    """The per-token eager decode loop at host int positions over fresh
    caches (what `generate()` ran before its decode became chunk
    programs), greedy, no eos."""
    import torch

    b, s0 = ids.shape
    caches = model.init_kv_caches(b, s0 + max_new)
    logits, caches = model(ids, kv_caches=caches, cache_pos=0,
                           attn_start=start)
    tok = logits[:, -1].float().argmax(-1).to(torch.int32)
    out = [tok]
    for i in range(1, max_new):
        logits, caches = model(tok[:, None], kv_caches=caches,
                               cache_pos=s0 + i - 1, attn_start=start)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def _generate_rate(model, ids, new_tokens=32):
    """`generate()` timed on a call after a warm-up call of the same
    shapes: tokens/s of the whole call (prefill included), the call's
    wall ms, and the decode ms a step (the call's wall less that of a
    prefill-only call, over new_tokens - 1 steps)."""
    import torch

    walls = {}
    for n in (new_tokens, 1):
        model.generate(ids, max_new_tokens=n)          # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate(ids, max_new_tokens=n)
        torch.cuda.synchronize()
        walls[n] = time.perf_counter() - t
    b = ids.shape[0]
    return dict(tokens_per_s=b * new_tokens / walls[new_tokens],
                wall_ms=1e3 * walls[new_tokens],
                decode_ms=1e3 * (walls[new_tokens] - walls[1])
                / (new_tokens - 1))


def phase_generate(model, cfg, name):
    import torch

    from paddle_tpu_torch.ops import kernels as K

    rs = np.random.RandomState(SEED + 1)
    K.reset_launches()
    ids = rs.randint(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    out = model.generate(ids, max_new_tokens=32).cpu().numpy()
    check(out.shape == (4, 160), f"generate shape {out.shape}")
    causal_counts = K.launch_counts()
    lens = (128, 100, 64, 17)
    mask = np.zeros((4, 128), np.int32)
    for r, n in enumerate(lens):
        mask[r, 128 - n:] = 1
    ids_p = np.where(mask == 1, ids, 0).astype(np.int32)
    out_p = model.generate(ids_p, max_new_tokens=32,
                           attention_mask=mask).cpu().numpy()
    check(out_p.shape == (4, 160), f"padded generate shape {out_p.shape}")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for k in ("flash_fwd", "decode_attention"):
        check(counts[k] > 0, f"generate path never launched {k}")
    check(counts["flash_fwd"] > causal_counts["flash_fwd"],
          "the left-padded prefill did not launch flash_fwd")
    # each call: one prefill and a chunk program of 31 steps, whose first
    # run (the warm-up before its capture) is eager: 32 forwards
    forwards = 2 * 32
    check(counts["decode_attention"] == cfg.num_layers * 2 * 31,
          f"generate: decode_attention launched "
          f"{counts['decode_attention']} times in 62 decode forwards")
    _rope_launches_per_forward(counts, cfg, forwards, "generate")
    # the chunk programs replayed (a second call of each) against the
    # per-token eager loop at host positions, bit for bit
    start = torch.as_tensor(128 - np.array(lens), dtype=torch.int32).cuda()
    K.reset_launches()
    with torch.inference_mode():
        for x, st, first in ((ids, None, out), (ids_p, start, out_p)):
            again = model.generate(x, max_new_tokens=32,
                                   attention_mask=None if st is None
                                   else mask).cpu().numpy()
            loop = _generate_loop(model, torch.from_numpy(x).cuda(), 32,
                                  st).cpu().numpy()
            check(np.array_equal(again, first) and np.array_equal(again,
                                                                  loop),
                  f"generate {name}: the replayed chunk's tokens differ "
                  "from the first call's or the per-token eager loop's")
    replayed = K.launch_counts()["decode_attention"]
    check(replayed == 2 * 2 * 31 * cfg.num_layers,
          f"generate: {replayed} decode_attention launches in two replays "
          f"and two eager loops of 31 steps")
    log(f"[graphs] generate {name}: the chunk program (31 steps) replayed "
        "== the first call == the per-token eager loop, bit for bit, "
        "equal-length and left-padded")
    rate = _generate_rate(model, ids)
    # 16-bit logits against the f32 upcast of the same weights, copied one
    # parameter at a time (no second full-size copy in flight)
    f32 = type(model)(cfg, device="cuda", dtype=torch.float32)
    with torch.no_grad():
        for pf, pb in zip(f32.parameters(), model.parameters()):
            pf.copy_(pb)
    with torch.inference_mode():
        x = torch.from_numpy(ids[:1, :64]).cuda()
        lb = model(x).float()
        lf = f32(x)
    rel = ((lb - lf).norm() / lf.norm()).item()
    del f32
    torch.cuda.empty_cache()
    check(math.isfinite(rel) and rel < 0.05,
          f"{_dn(model.dtype)} logits relative L2 error {rel:.3g} >= 0.05 "
          "vs f32")
    log(f"[generate] {name}: equal-length 4x128 and left-padded {lens} "
        f"+32 tokens ok; {_dn(model.dtype)} vs f32 logits rel L2 "
        f"{rel:.4f} (tol 0.05); "
        f"{forwards} forwards, launches {json.dumps(counts)}")
    log(f"[generate] {name} B4 x 128 +32 (second call): "
        f"{rate['tokens_per_s']:.1f} tokens/s, {rate['wall_ms']:.2f} ms a "
        f"call, decode {rate['decode_ms']:.3f} ms a step")
    return counts


# ----------------------------------------------------------------- phase 6
def _ulp(v, dtype):
    """One ulp of a value of magnitude `v` (> 0, normal) in `dtype`."""
    import torch

    return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(v))


def _near_ties(model, prompts, outs, refs, what, against, tol=1e-3,
               ulps=None, first=None):
    """Streams `outs` against reference streams `refs` of the same
    prompts (their first `first` new tokens, or all): equal, or the
    first different token at a near-tie, where the top-2 logits of
    `model`'s full forward over the reference prefix differ by less than
    `tol` (f32), or with `ulps` by less than that many ulps, in the
    model's dtype, of the step's largest |logit| (a 16-bit model's
    logits carry rounding of that order, cuBLAS rounding a row of the
    batched engine otherwise than the sequential call's; `_tie_readings`
    measures it).  Returns the count of equal streams and the near-ties
    as (prompt length, token, margin)."""
    import torch

    near, same = [], 0
    for p, o, ref in zip(prompts, outs, refs):
        n = len(ref) if first is None else len(p) + first
        diff = np.flatnonzero(ref[:n] != o[:n])
        if not diff.size:
            same += 1
            continue
        at = int(diff[0])
        with torch.inference_mode():
            logits = model(torch.from_numpy(ref[None, :at]).cuda())[0, -1]
        logits = logits.float()
        top = torch.topk(logits, 2).values
        margin = (top[0] - top[1]).item()
        limit = tol if ulps is None else \
            ulps * _ulp(logits.abs().max().item(), model.dtype)
        check(margin < limit, f"{what} diverged from {against} at token "
              f"{at - len(p)} of a {len(p)}-token prompt, top-2 margin "
              f"{margin:.3g} >= {limit:.3g}")
        near.append((len(p), at - len(p), round(margin, 5)))
    return same, near


def _tie_readings(model, prompts, refs):
    """How near sequential greedy `generate()`'s streams `refs` came to
    a tie, and how far two routes' rounding moves a 16-bit model's
    logits.  Each stream is replayed over its own tokens by generate()'s
    route (an eager prefill into dense caches, then one decode forward
    a token: the decode kernel) and by one full forward over the stream
    (flash); at each new token's step: the largest |logit|, its ulp in
    the model's dtype, the top-2 margin of the full forward in those
    ulps, and the largest difference between the two routes' logits in
    those ulps.  Returns a dict of the extremes over every step."""
    import torch

    dt = model.dtype
    r = dict(steps=0, max_logit=[math.inf, 0.0], ulp=[math.inf, 0.0],
             min_margin_ulps=math.inf, max_gap_ulps=0.0, argmax_equal=0)
    with torch.inference_mode():
        for p, ref in zip(prompts, refs):
            lp, ids = len(p), torch.from_numpy(ref).cuda()[None]
            full = model(ids[:, :-1])[0, lp - 1:].float()
            caches = model.init_kv_caches(1, ids.shape[1])
            step, _ = model(ids[:, :lp], kv_caches=caches, cache_pos=0)
            dec = [step[0, -1]]
            for j in range(lp, ids.shape[1] - 1):
                step, _ = model(ids[:, j:j + 1], kv_caches=caches,
                                cache_pos=j)
                dec.append(step[0, -1])
            dec = torch.stack(dec).float()
            big = full.abs().amax(-1)
            ulp = torch.finfo(dt).eps * torch.exp2(torch.floor(
                torch.log2(big)))
            top = torch.topk(full, 2, dim=-1).values
            margin = (top[:, 0] - top[:, 1]) / ulp
            gap = ((dec - full).abs().amax(-1) / ulp)
            r["steps"] += full.shape[0]
            r["max_logit"] = [min(r["max_logit"][0], big.min().item()),
                              max(r["max_logit"][1], big.max().item())]
            r["ulp"] = [min(r["ulp"][0], ulp.min().item()),
                        max(r["ulp"][1], ulp.max().item())]
            r["min_margin_ulps"] = min(r["min_margin_ulps"],
                                       margin.min().item())
            r["max_gap_ulps"] = max(r["max_gap_ulps"], gap.max().item())
            r["argmax_equal"] += int((dec.argmax(-1) == ids[0, lp:]).sum())
    return r


def phase_tie_readings(model, cfg, name, refs):
    """`_tie_readings` of the sequential streams `refs` of phase 4's
    prompts, logged; the near-tie limit must cover twice the largest
    difference between the two routes' logits (a tie flips only where
    the margin is under the two logits' differences together)."""
    r = _tie_readings(model, _prompts(cfg.vocab_size), refs)
    dn = _dn(model.dtype)
    log(f"[ties] {name} {dn}: {r['steps']} steps of generate()'s streams: "
        f"max |logit| {r['max_logit'][0]:.4g} to {r['max_logit'][1]:.4g}, "
        f"one ulp {r['ulp'][0]:.4g} to {r['ulp'][1]:.4g}; smallest top-2 "
        f"margin {r['min_margin_ulps']:.4g} ulps; largest gap between the "
        f"decode route's and the full forward's logits "
        f"{r['max_gap_ulps']:.4g} ulps; decode-route argmax equal to the "
        f"stream {r['argmax_equal']}/{r['steps']}; near-tie limit "
        f"{NEAR_TIE_ULPS} ulps")
    check(2 * r["max_gap_ulps"] <= NEAR_TIE_ULPS,
          f"ties {name} {dn}: two routes' logits differ by "
          f"{r['max_gap_ulps']:.4g} ulps, more than half the near-tie "
          f"limit of {NEAR_TIE_ULPS}")
    return r


def phase_parity(cls, cfg, name):
    """`cls(cfg)` in f32 (depth cut by the caller): engine streams
    against generate() streams."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model = cls(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    prompts = _prompts(cfg.vocab_size)
    eng = InferenceEngine(model, EngineConfig())
    outs = eng.generate(prompts, max_new_tokens=16)
    hits = eng.prefix_cache_stats()["hits"]
    # the two later shared-prefix prompts must take the warm prefill, so
    # its streams are held against generate() too
    check(hits >= 2, f"parity prefix cache hits {hits}: warm prefill did "
          "not run")
    refs = [model.generate(p[None], max_new_tokens=16).cpu().numpy()[0]
            for p in prompts]
    same, near = _near_ties(model, prompts, outs, refs, "engine",
                            "generate()")
    _engine_replay_equals_eager(eng, f"parity f32 {name} widths")
    log(f"[parity] f32 {name} widths {cfg.num_layers}L: {same}/"
        f"{len(prompts)} engine "
        f"streams identical to generate(); near-ties {near}; prefix hits "
        f"{hits}")


def phase_int8_parity(cls, cfg, name, new_tokens=8):
    """`cls(cfg)` in f32 (depth cut by the caller) behind the engine with
    kv_precision="int8": two runs bit-identical, every first token equal
    to the exact engine's (it comes off the exact dense prefill, warm
    ones off the exact sidecar), the int8 kernel only; the card's codec
    bit for bit the CPU's on one dense K buffer; and every page a pack
    writes, dequantized, within absmax / 127 of its dense rows."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.quant import (
        dequantize_vectors, quantize_vectors,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model = cls(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    prompts = _prompts(cfg.vocab_size)
    exact = InferenceEngine(model, EngineConfig()).generate(
        prompts, max_new_tokens=new_tokens)
    K.reset_launches()
    runs = []
    for _ in range(2):
        eng = InferenceEngine(model, EngineConfig(kv_precision="int8"))
        runs.append(eng.generate(prompts, max_new_tokens=new_tokens))
        hits = eng.prefix_cache_stats()["hits"]
        check(hits >= 2, f"int8_parity prefix cache hits {hits}: warm "
              "prefill did not run")
    counts = K.launch_counts()
    check(counts["paged_attention_int8"] > 0
          and counts["paged_attention"] == 0,
          f"int8_parity launches {json.dumps(counts)}")
    for a, b, e, p in zip(*runs, exact, prompts):
        check(np.array_equal(a, b), f"int8 engine not bit-stable on a "
              f"{p.size}-token prompt")
        check(np.array_equal(a[:p.size + 1], e[:p.size + 1]),
              f"int8 first token differs from the exact engine's on a "
              f"{p.size}-token prompt")
    same = sum(np.array_equal(a, e) for a, e in zip(runs[0], exact))
    _engine_replay_equals_eager(eng, f"int8_parity f32 {name} widths")
    # one cold prefill packed by a fresh int8 engine into pages 1..n
    eng = InferenceEngine(model, EngineConfig(kv_precision="int8"))
    prompt = prompts[5]                           # 1000 tokens
    s0, ps = prompt.size, eng.config.page_size
    sb = eng._bucket(s0)
    start = sb - s0
    ids = np.zeros((1, sb), np.int32)
    ids[0, start:] = prompt
    worst = 0.0
    with torch.inference_mode():
        _, kbufs, vbufs = eng._run_prefill(sb, ids, start)
        x = kbufs[0][0]
        got, want = quantize_vectors(x), quantize_vectors(x.cpu())
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              "int8_parity: the card's codec differs from the CPU's")
        pages = np.arange(1, -(-sb // ps) + 1, dtype=np.int32)
        eng._run_pack(kbufs, vbufs, pages, start)
        pg = torch.from_numpy(pages).long().cuda()
        for li in range(eng._layers):
            for pools, scales, bufs in (
                    (eng._k_pools, eng._k_scales, kbufs),
                    (eng._v_pools, eng._v_scales, vbufs)):
                deq = dequantize_vectors(pools[li][pg], scales[li][pg])
                deq = deq.transpose(0, 1).reshape(
                    eng._hkv, -1, eng._hd)[:, :s0]
                dense = bufs[li][0, :, start:start + s0].float()
                bound = dense.abs().amax(-1, keepdim=True) / 127.0
                ratio = ((deq - dense).abs() / bound.clamp_min(1e-30)) \
                    .max().item()
                worst = max(worst, ratio)
    check(worst <= 1.0, f"int8_parity: a packed page is {worst:.3g} x "
          "absmax / 127 off its dense rows")
    log(f"[int8_parity] f32 {name} widths {cfg.num_layers}L, kv int8: 2 "
        f"runs bit-identical, first tokens equal the exact engine's, "
        f"{same}/{len(prompts)} whole streams equal it ({new_tokens} "
        f"tokens); codec card == cpu; packed pages within "
        f"{worst:.3f} x absmax/127 of the dense rows; launches "
        f"{json.dumps(counts)}")


# ---------------------------------------- the weight and speculative tiers
def _live_decode_inputs(eng, lengths):
    """Host inputs of a decode step with every slot live on pages of its
    own at `lengths` (for timing a step on garbage pools)."""
    s_, p_ = eng.config.max_slots, eng.max_pages_per_seq
    pt = (1 + np.arange(s_ * p_, dtype=np.int32)).reshape(s_, p_)
    tok = np.arange(s_, dtype=np.int32) + 1
    return tok, pt, np.asarray(lengths, np.int32)


def _weight_store(eng, model):
    """(bytes the engine stores for its narrow weights: codes and
    scales, or a cast that is not the weight itself; bytes of the same
    weights in bf16; bytes of every model parameter in bf16)."""
    stored = sum(t.numel() * t.element_size()
                 for w, (q, scales, _) in eng._wq.items()
                 for t in (q, scales)
                 if t is not None and t.data_ptr() != w.data_ptr())
    same = sum(w.numel() * 2 for w in eng._wq)
    whole = sum(p.numel() * 2 for p in model.parameters())
    return stored, same, whole


def phase_weight_tiers(model, cfg, name):
    """The weight tiers at full width: the 8 requests x 32 tokens of
    phase 9 served twice (the first round captures the prefill programs,
    the second replays them) by the exact tier and by
    weight_precision="int8" and "bf16" in turns: tokens/s and TTFT p50
    of the replayed round, the decode step's profiled device time (every
    slot live, ~730-token contexts); the int8 store against the bf16
    weights; the peak memory the decode graph's warm-up and capture add,
    which under int8 must stay below a quarter of the model's bf16
    weights (each weight is dequantized where it is used); the bf16 tier
    of a bf16 model stores nothing new, so its streams equal the exact
    tier's; replay == eager body bit for bit for the int8 decode and
    prefill graphs."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.ops import kernels as K

    prompts = _prompts(cfg.vocab_size)
    counts, rows, capture, outs = {}, {}, {}, {}
    for prec in (None, "int8", "bf16"):
        tier = prec or "exact"
        torch.cuda.synchronize()
        eng = InferenceEngine(model, EngineConfig(weight_precision=prec))
        if prec == "int8":
            stored, same, whole = _weight_store(eng, model)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():            # as the engine's step
            eng._decode_program(1)              # warm-up and capture
        torch.cuda.synchronize()
        capture[tier] = torch.cuda.max_memory_allocated() - base
        eng.generate([prompts[1][:16]], max_new_tokens=2)     # warm-up
        K.reset_launches()
        rounds = _serve_passes(eng, prompts)
        counts[tier] = K.launch_counts()
        for r in rounds:
            for p, o, h in zip(prompts, r["outs"], r["handles"]):
                check(len(o) == len(p) + 32 and h.finish_reason == "length",
                      f"weight_tiers {tier}: request {h.request_id} "
                      f"finished {h.finish_reason}")
        for a, b in zip(*(r["outs"] for r in rounds)):
            check(np.array_equal(a, b), f"weight_tiers {tier}: the "
                  "replayed round's streams differ from the first's")
        steps = sum(len(r["step_ms"]) for r in rounds)
        check(counts[tier]["paged_attention"] == cfg.num_layers * steps,
              f"weight_tiers {tier}: paged_attention launched "
              f"{counts[tier]['paged_attention']} times in {steps} steps")
        if prec == "int8":
            what = f"weight_tiers {name} bf16 weights int8"
            _engine_replay_equals_eager(eng, what)
            _prefill_replay_equals_eager(eng, what)
        with torch.inference_mode():
            prog = eng._decode_program(1)
            for dst, src in zip((prog.tok, prog.pt, prog.lengths),
                                _live_decode_inputs(eng, (1040, 560, 330,
                                                          1000))):
                dst.copy_(torch.from_numpy(src))
            step_dev = device_ms(prog.graph.replay, iters=10)
        r = rounds[1]
        outs[tier] = r["outs"]
        rows[tier] = dict(tps=r["gen"] / r["wall"],
                          ttft=1e3 * r["ttft"][len(r["ttft"]) // 2],
                          step_wall=float(np.mean(r["step_ms"])),
                          step_dev=step_dev)
        del eng, prog
        gc.collect()
        torch.cuda.empty_cache()
    check(all(np.array_equal(a, b) for a, b in zip(outs["bf16"],
                                                   outs["exact"])),
          "weight_tiers: the bf16 tier of a bf16 model changed the streams")
    same_int8 = sum(np.array_equal(a, b) for a, b in zip(outs["int8"],
                                                         outs["exact"]))
    check(capture["int8"] < whole / 4, f"weight_tiers: the int8 decode "
          f"graph's capture added {capture['int8'] / 2**30:.2f} GiB, over a "
          f"quarter of the {whole / 2**30:.2f} GiB of bf16 weights")
    for tier, r in rows.items():
        log(f"[weight_tiers] {name} bf16 weights {tier}: {r['tps']:.1f} "
            f"tokens/s, TTFT p50 {r['ttft']:.1f} ms (replayed round), "
            f"decode step {r['step_wall']:.2f} ms wall, "
            f"{r['step_dev']:.3f} ms device (4 slots, ~730-token contexts)")
    log(f"[weight_tiers] {name} weight store: int8 {stored / 2**30:.3f} GiB "
        f"(codes + scales) for {same / 2**30:.3f} GiB of the same weights "
        f"in bf16 ({stored / same:.3f}), model {whole / 2**30:.3f} GiB in "
        f"bf16; the decode graph's warm-up and capture added at peak "
        + ", ".join(f"{t} {c / 2**20:.1f} MiB" for t, c in capture.items())
        + f" (int8: {capture['int8'] / whole:.4f} of the model)")
    log(f"[weight_tiers] {name} decode step device ms int8 / exact "
        f"{rows['int8']['step_dev'] / rows['exact']['step_dev']:.3f}, bf16 /"
        f" exact {rows['bf16']['step_dev'] / rows['exact']['step_dev']:.3f};"
        f" streams: bf16 == exact 8/8, int8 == exact {same_int8}/8")
    return {k: sum(c[k] for c in counts.values()) for k in counts["exact"]}


def _agreeing_draft(cfg, layers=2):
    """bench.py's agreeing pair at the widths of `cfg` in bf16: a target
    whose blocks past the first `layers` have their out_proj and
    down_proj (weight and bias) zeroed, so each is the identity, and a
    `layers`-layer draft holding the target's weights of those layers."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    target = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                            seed=SEED)
    dcfg = copy.copy(cfg)
    dcfg.num_layers = layers
    draft = GPTForCausalLM(dcfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    own = dict(target.named_parameters())
    with torch.no_grad():
        for n, p in draft.named_parameters():
            p.copy_(own[n])
        for blk in target.gpt.h[layers:]:
            for lin in (blk.attn.out_proj, blk.mlp.down_proj):
                lin.weight.zero_()
                lin.bias.zero_()
    return target, draft


def _acceptance(eng):
    """Wrap the engine's spec pass: the committed counts of every live
    slot, for the acceptance rate (accepted over proposed)."""
    seen, run = [], eng._run_spec

    def rec(k, tok, pt, lengths, limits):
        g, counts = run(k, tok, pt, lengths, limits)
        seen.extend((counts[limits > 0] - 1).tolist())
        return g, counts

    eng._run_spec = rec
    return seen


def phase_spec_serve(model, cfg, name, k=4, new_tokens=64):
    """Speculative decoding at full width: the 8 requests of phase 4 x 64
    tokens, served twice, with spec_tokens=k and two 2-layer drafts, an
    agreeing one (bench.py's: the target's first two layers, its other
    blocks' residual projections zeroed; at least 90% of the proposals
    accepted) and an independent seeded one over `model` with an untied
    head (a random model with the preset's tied N(0, 1) embedding repeats
    its last token, its own logit ~hidden_size above the rest, so any
    tied draft would agree); the non-spec engine beside them.  Every spec
    pass launches paged_attention 2 * (k + 1) times for the draft and
    once a layer for the target."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels as K

    prompts = _prompts(cfg.vocab_size)
    total, lines = None, []
    agree_t, agree_d = _agreeing_draft(cfg)
    dcfg = copy.copy(cfg)
    dcfg.num_layers, dcfg.tie_embeddings = 2, False
    indep = GPTForCausalLM(dcfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED + 1)
    for label, target, draft in (("none", model, None),
                                 ("agreeing", agree_t, agree_d),
                                 ("independent", model, indep)):
        spec = draft is not None
        eng = InferenceEngine(target, EngineConfig(
            spec_tokens=k if spec else None), draft_model=draft)
        eng.generate([prompts[1][:16]], max_new_tokens=2)     # warm-up
        accepted = _acceptance(eng) if spec else []
        passes0 = eng.spec_passes
        K.reset_launches()
        rounds = _serve_passes(eng, prompts, new_tokens=new_tokens)
        counts = K.launch_counts()
        total = counts if total is None else {
            n: total[n] + counts[n] for n in total}
        for r in rounds:
            for p, o, h in zip(prompts, r["outs"], r["handles"]):
                check(len(o) == len(p) + new_tokens
                      and h.finish_reason == "length",
                      f"spec_serve {label}: request {h.request_id} finished "
                      f"{h.finish_reason} with {len(o) - len(p)} tokens")
        for a, b in zip(*(r["outs"] for r in rounds)):
            check(np.array_equal(a, b), f"spec_serve {label}: the replayed "
                  "round's streams differ from the first's")
        r = rounds[1]
        line = (f"{label} draft: {r['gen'] / r['wall']:.1f} tokens/s, "
                f"TTFT p50 {1e3 * r['ttft'][len(r['ttft']) // 2]:.1f} ms, "
                f"{np.mean(r['step_ms']):.2f} ms a "
                f"{'pass' if spec else 'step'} (replayed round)")
        if spec:
            passes = eng.spec_passes - passes0
            want = passes * (2 * (k + 1) + cfg.num_layers)
            check(counts["paged_attention"] == want,
                  f"spec_serve {label}: paged_attention launched "
                  f"{counts['paged_attention']} times in {passes} passes, "
                  f"expected {want}")
            rate = sum(accepted) / max(1, k * len(accepted))
            if label == "agreeing":
                check(rate >= 0.9, f"spec_serve: the agreeing draft's "
                      f"acceptance {rate:.3f} < 0.9")
            per_pass = counts["paged_attention"] / passes
            line += (f", acceptance {rate:.3f} ({sum(accepted)} of "
                     f"{k * len(accepted)}), {passes} passes, "
                     f"paged_attention {per_pass:.0f} a pass, "
                     f"{np.mean(accepted) + 1:.2f} tokens a slot a pass")
            if label == "agreeing":
                _spec_replay_equals_eager(eng, f"spec_serve {name} bf16")
        lines.append(line)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del agree_t, agree_d, indep
    gc.collect()
    torch.cuda.empty_cache()
    for line in lines:
        log(f"[spec_serve] {name} bf16 k={k}, 8 requests x {new_tokens} "
            f"tokens: {line}")
    return total


def _spec_replay_equals_eager(eng, what, passes=3):
    """`passes` spec passes of every slot through the engine's captured
    program (`_run_spec`, a graph replay each) and through its eager
    body (`_spec_body`) from equal copies of the pools (the draft's
    included): the tokens, the counts and every pool, bit for bit.  Each
    slot lives on pages of its own; its limit cuts its last pass short,
    so the limit mask runs too."""
    import torch

    cfg = eng.config
    s_, p_, k = cfg.max_slots, eng.max_pages_per_seq, cfg.spec_tokens
    check(s_ * p_ < cfg.num_pages, f"{what}: the pool cannot hold {s_} "
          f"slots of {p_} pages")
    rs = np.random.RandomState(SEED + 7)
    pt = (1 + np.arange(s_ * p_, dtype=np.int32)).reshape(s_, p_)
    lengths0 = rs.randint(16, cfg.max_seq_len // 2, s_).astype(np.int32)
    limits = (lengths0 + passes * (k + 1) - 2).astype(np.int32)
    tok0 = rs.randint(0, eng._model.cfg.vocab_size, s_).astype(np.int32)
    pools = eng._pool_tensors()
    prog = eng._spec_program(k)

    def eager(tok, pt_, lengths, limits_):
        for dst, src in ((prog.tok, tok), (prog.pt, pt_),
                         (prog.lengths, lengths), (prog.limits, limits_)):
            dst.copy_(torch.from_numpy(src))
        eng._spec_body(prog)
        return prog.g.cpu().numpy(), prog.counts.cpu().numpy()

    def run(one):
        out, tok, lengths = [], tok0, lengths0
        for _ in range(passes):
            g, counts = one(tok, pt, lengths, limits)
            out.append(np.concatenate([g, counts[:, None]], axis=1))
            tok = g[np.arange(s_), counts - 1].astype(np.int32)
            lengths = (lengths + counts).astype(np.int32)
        return np.stack(out)

    with torch.inference_mode():
        start = [p.clone() for p in pools]
        replayed = run(lambda *a: eng._run_spec(k, *a))
        after = [p.clone() for p in pools]
        for p, s in zip(pools, start):
            p.copy_(s)
        del start
        direct = run(eager)
        torch.cuda.synchronize()
        diff = [i for i, (a, p) in enumerate(zip(after, pools))
                if not torch.equal(a[1:], p[1:])]
    check(np.array_equal(replayed, direct), f"{what}: replayed spec passes "
          f"{replayed[:, :, -1].tolist()} differ from the eager body's "
          f"{direct[:, :, -1].tolist()}")
    check(not diff, f"{what}: {len(diff)} of {len(pools)} pools differ "
          f"between the spec replay and the eager body (first #{diff[:1]};"
          " page 0 left out)")
    log(f"[graphs] {what}: {passes} spec passes (k={k}) x {s_} slots, "
        f"replay == eager body bit for bit (tokens, counts and {len(pools)} "
        "pools, the draft's included, without scratch page 0)")


def phase_tiers_parity(cls, cfg, name, new_tokens=16):
    """`cls(cfg)` in f32 (depth cut by the caller): the int8-weight
    engine's streams against `generate()` of a copy of the model holding
    the engine's `effective_params()`; the spec engine (k=3) against the
    non-spec engine on both KV tiers with two seeded 1-layer drafts, one
    tied (it repeats the last token, as the random tied target does: its
    proposals are accepted) and one untied (rejected); a divergence only
    at a near-tie (top-2 margin < 1e-3); the int8-weight
    decode and prefill graphs, the spec graph and the draft's prefill
    graphs replayed against their eager bodies bit for bit; all tiers
    composed (int8 weights, int8 KV, spec) twice, bit for bit."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model = cls(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    drafts = {}
    for tied in (True, False):
        dcfg = copy.copy(cfg)
        dcfg.num_layers, dcfg.tie_embeddings = 1, tied
        drafts["tied" if tied else "untied"] = cls(
            dcfg, device="cuda", dtype=torch.float32, seed=SEED + 1)
    prompts = _prompts(cfg.vocab_size)
    notes = []
    # the int8 weight tier against generate() over its weights
    eng = InferenceEngine(model, EngineConfig(weight_precision="int8"))
    outs = eng.generate(prompts, max_new_tokens=new_tokens)
    ref = cls(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    eff = eng.effective_params()
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(eff[n])
    del eff
    refs = [ref.generate(p[None], max_new_tokens=new_tokens).cpu().numpy()[0]
            for p in prompts]
    same, near = _near_ties(ref, prompts, outs, refs, "int8-weight engine",
                            "generate() over effective_params()")
    notes.append(f"int8 weights == generate(effective_params) {same}/"
                 f"{len(prompts)}, near-ties {near}")
    what = f"tiers_parity f32 {name} widths int8 weights"
    _engine_replay_equals_eager(eng, what)
    _prefill_replay_equals_eager(eng, what)
    del eng, ref
    gc.collect()
    # spec against non-spec, both KV tiers, both drafts
    for kv in (None, "int8"):
        base = InferenceEngine(model, EngineConfig(kv_precision=kv)) \
            .generate(prompts, max_new_tokens=new_tokens)
        for label, draft in drafts.items():
            eng = InferenceEngine(model, EngineConfig(kv_precision=kv,
                                                      spec_tokens=3),
                                  draft_model=draft)
            accepted = _acceptance(eng)
            outs = eng.generate(prompts, max_new_tokens=new_tokens)
            check(eng.prefix_cache_stats()["hits"] >= 2, "tiers_parity: "
                  "the spec engine's warm prefills did not run")
            what = f"spec engine kv {kv or 'full'}, {label} draft"
            same, near = _near_ties(model, prompts, outs, base, what,
                                    "the non-spec engine")
            rate = sum(accepted) / max(1, 3 * len(accepted))
            notes.append(f"{what} == non-spec {same}/{len(prompts)}, "
                         f"near-ties {near}, acceptance {rate:.3f}")
            what = f"tiers_parity f32 {name} widths {what}"
            _spec_replay_equals_eager(eng, what)
            _prefill_replay_equals_eager(eng, what)
            del eng
            gc.collect()
    # every tier at once, twice
    runs = [InferenceEngine(model, EngineConfig(
        weight_precision="int8", kv_precision="int8", spec_tokens=3),
        draft_model=drafts["untied"]).generate(prompts,
                                               max_new_tokens=new_tokens)
        for _ in range(2)]
    for a, b in zip(*runs):
        check(np.array_equal(a, b), "tiers_parity: int8 weights + int8 KV "
              "+ spec not bit-stable run to run")
    notes.append("all tiers composed: 2 runs bit-identical")
    for n in notes:
        log(f"[tiers_parity] f32 {name} widths {cfg.num_layers}L: {n}")


def _teacher_logits(model, ids, toks):
    """f32 logits [steps, B, V] of the eager per-token decode loop fed
    `toks` [B, steps] (what the chunk programs compute at each step: the
    prefill's last row, then each step's)."""
    import torch

    b, s0 = ids.shape
    steps = toks.shape[1]
    with torch.inference_mode():
        caches = model.init_kv_caches(b, s0 + steps)
        logits, _ = model(ids, kv_caches=caches, cache_pos=0)
        out = [logits[:, -1].float()]
        for i in range(1, steps):
            logits, _ = model(toks[:, i - 1:i], kv_caches=caches,
                              cache_pos=s0 + i - 1)
            out.append(logits[:, -1].float())
    return torch.stack(out)


def _beam_replay_equals_eager(model, what, steps=3):
    """After a beam call: `steps` beam steps through the graph the call
    captured and through the eager body from equal copies of the beam
    state: every state tensor (caches included) bit for bit."""
    import torch

    from paddle_tpu_torch.models import generation as GEN

    st = GEN._generation(model).beam
    (eos, lp), graph = next(iter(st.programs.items()))
    state = [t for c in st.caches for t in c] + [
        st.tok, st.parent, st.scores, st.lengths, st.fin_norm, st.fin_step,
        st.fin_beam, st.pos, st.step]
    with torch.inference_mode():
        start = [t.clone() for t in state]
        for _ in range(steps):
            graph.replay()
        after = [t.clone() for t in state]
        for t, s in zip(state, start):
            t.copy_(s)
        del start
        for _ in range(steps):
            model._beam_step_body(st, eos, lp)
        torch.cuda.synchronize()
        diff = [i for i, (a, t) in enumerate(zip(after, state))
                if not torch.equal(a, t)]
    check(not diff, f"{what}: {len(diff)} of {len(state)} beam state "
          f"tensors differ between the replay and the eager body (first "
          f"#{diff[:1]})")
    log(f"[graphs] {what}: {steps} beam steps replayed == eager body bit "
        f"for bit ({len(state)} state tensors)")


def _untied(cfg):
    """`cfg` with an untied LM head: seeded at random, the preset's tied
    N(0, 1) embedding makes the model repeat its last token (its own
    logit ~hidden_size above the rest), so sampling and beam search
    would choose among nothing; an untied head spreads the logits."""
    out = copy.copy(cfg)
    out.tie_embeddings = False
    return out


def phase_sample_beam(cfg, name, cut):
    """Sampling and beam search through `generate()` at the full width of
    `cfg` with an untied head (`_untied`), bf16:
    do_sample=True, temperature 0.8, top_k 50, one seed, B4 x 128 + 64
    tokens twice (the same tokens; tokens/s of the second call), top_k=1
    against greedy (equal, or different only where the step's logits tie
    at the top); num_beams=4 at B2 x 128 + 32 (tokens/s), its step graph
    against the eager body.  At f32 and `cut` depth: every sampled token
    in the top-50 of its step's teacher-forced logits, ties included, and
    the card's beams equal to the port's CPU run on the same weights (or
    a near-tie: the two winners' CPU scores within 1e-3)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels as K

    model = GPTForCausalLM(_untied(cfg), device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    rs = np.random.RandomState(SEED + 3)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 128)).astype(
        np.int32)).cuda()
    kw = dict(do_sample=True, temperature=0.8, top_k=50, seed=SEED + 5)
    K.reset_launches()
    outs, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(model.generate(ids, max_new_tokens=64, **kw).cpu().numpy())
        walls.append(time.perf_counter() - t)
    counts = K.launch_counts()
    check(np.array_equal(*outs), "sample_beam: one seed gave two streams")
    check(outs[0].shape == (4, 192) and ((outs[0] >= 0)
                                         & (outs[0] < cfg.vocab_size)).all(),
          f"sample_beam: sampled shape {outs[0].shape} or token range")
    check(counts["decode_attention"] == 2 * 63 * cfg.num_layers,
          f"sample_beam: decode_attention {counts['decode_attention']} in 2 "
          "sampled calls of 63 steps")
    sample_counts = dict(counts)
    for _ in range(2):            # the second call timed, as the sampled
        torch.cuda.synchronize()
        t = time.perf_counter()
        greedy = model.generate(ids, max_new_tokens=64).cpu().numpy()
        greedy_wall = time.perf_counter() - t
    one = model.generate(ids, max_new_tokens=64, do_sample=True,
                         temperature=0.8, top_k=1, seed=SEED).cpu().numpy()
    ties = []
    rows = np.flatnonzero((greedy != one).any(axis=1))
    if rows.size:
        # each row's logits depend on its own history only: the greedy
        # stream's, up to the row's first difference
        logits = _teacher_logits(model, ids,
                                 torch.from_numpy(greedy[:, 128:]).cuda())
    for r in rows:
        t = int(np.flatnonzero(greedy[r] != one[r])[0]) - 128
        row = logits[t, r]
        check(row[int(greedy[r, 128 + t])] == row[int(one[r, 128 + t])],
              f"sample_beam: top_k=1 left greedy at row {r} step {t} "
              "without a tie at the top")
        ties.append((int(r), t))
    K.reset_launches()
    bids = ids[:2]
    beams, bwalls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        beams.append(model.generate(bids, max_new_tokens=32,
                                    num_beams=4).cpu().numpy())
        bwalls.append(time.perf_counter() - t)
    bcounts = K.launch_counts()
    check(np.array_equal(*beams) and beams[0].shape == (2, 160),
          "sample_beam: two beam calls differ")
    check(bcounts["decode_attention"] == 2 * 31 * cfg.num_layers,
          f"sample_beam: decode_attention {bcounts['decode_attention']} in 2 "
          "beam calls of 31 steps")
    _beam_replay_equals_eager(model, f"sample_beam {name} bf16 beam B2 N4")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sample_beam] {name} untied bf16 sampled T0.8 top_k50 B4 x 128 +64: "
        f"{4 * 64 / walls[1]:.1f} tokens/s ({1e3 * walls[1]:.1f} ms a call, "
        f"second call; greedy {4 * 64 / greedy_wall:.1f} tokens/s, "
        f"{1e3 * greedy_wall:.1f} ms), same seed same tokens; top_k=1 == "
        f"greedy but at "
        f"{len(ties)} exact ties {ties}; decode_attention "
        f"{sample_counts['decode_attention']} in 2 calls")
    log(f"[sample_beam] {name} untied bf16 beam N4 B2 x 128 +32: "
        f"{2 * 32 / bwalls[1]:.1f} tokens/s ({1e3 * bwalls[1]:.1f} ms a call,"
        f" second call); decode_attention {bcounts['decode_attention']} in 2 "
        "calls")
    _sample_beam_parity(_untied(cut), name)
    return {n: sample_counts[n] + bcounts[n] for n in bcounts}


def _sample_beam_parity(cfg, name):
    """f32 at the depth of `cfg`: sampled tokens in their steps' top-50,
    and beams (with an eos) against the CPU port."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    rs = np.random.RandomState(SEED + 4)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 128)).astype(
        np.int32)).cuda()
    out = model.generate(ids, max_new_tokens=64, do_sample=True,
                         temperature=0.8, top_k=50, seed=SEED + 6)
    toks = out[:, 128:]
    logits = _teacher_logits(model, ids, toks)            # [64, B, V]
    # the order the filter sees: logits / T, as `_sample` divides
    logits = logits / torch.full_like(logits, 0.8)
    kth = torch.sort(logits, dim=-1).values[..., -50]
    picked = logits.gather(-1, toks.T.long()[..., None])[..., 0]
    ranks = (logits > picked[..., None]).sum(-1)
    check(bool((picked >= kth).all()), f"sample_beam: a sampled token "
          f"outside its step's top-50 (worst rank {int(ranks.max())})")
    greedy = model.generate(ids[:2], max_new_tokens=8).cpu().numpy()
    eos = int(greedy[0, 128 + 3])
    card = model.generate(ids[:2], max_new_tokens=32, num_beams=4,
                          eos_token_id=eos).cpu().numpy()
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=SEED)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), model.parameters()):
            pc.copy_(pg)
    want = cpu.generate(ids[:2].cpu(), max_new_tokens=32, num_beams=4,
                        eos_token_id=eos).numpy()
    near = []
    for r in np.flatnonzero((card != want).any(axis=1)):
        got_s, want_s = (_beam_score(cpu, seq, 128, eos)
                         for seq in (card[r], want[r]))
        check(abs(got_s - want_s) < 1e-3, f"sample_beam: the card's beam "
              f"winner of row {r} scores {got_s:.6f} on the CPU, the CPU's "
              f"{want_s:.6f}")
        near.append((int(r), round(got_s - want_s, 7)))
    del cpu
    log(f"[sample_beam] f32 {name} widths {cfg.num_layers}L untied: 64 "
        f"sampled tokens x 4 rows in their steps' top-50 (worst rank "
        f"{int(ranks.max())}); beams N4 (eos {eos}) card == CPU for "
        f"{2 - len(near)}/2 rows, near-ties {near}")


def _beam_score(model, seq, s0, eos):
    """The length-normalised (penalty 1) log-prob of `seq`'s generated
    tokens under `model` (CPU), up to and with its first eos."""
    import torch

    gen = seq[s0:]
    hit = np.flatnonzero(gen == eos)
    n = int(hit[0]) + 1 if hit.size else gen.size
    with torch.inference_mode():
        logp = torch.log_softmax(model(torch.from_numpy(
            seq[None, :s0 + n - 1]))[0].float(), dim=-1)
    rows = torch.arange(s0 - 1, s0 + n - 1)
    return float(logp[rows, torch.from_numpy(gen[:n]).long()].sum()) / n


# ----------------------------------------------------------------- phase 7
def _gpt125m(layers, **kw):
    from paddle_tpu_torch.models.gpt import GPTConfig

    # bench.py:66-68; the port's GPTConfig defaults are these widths
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=layers,
                     num_heads=12, max_seq_len=1024, fused_head_ce=True,
                     **kw)


def _train_step(model, amp_dtype=None, **kw):
    """AdamW(1e-4) on the model's pretraining criterion; `kw` goes to
    `build_train_step` (guard, checkpoint_manager, ...)."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    crit = GPTPretrainingCriterion(model=model) \
        if getattr(model.cfg, "fused_head_ce", False) \
        else LlamaPretrainingCriterion()
    return build_train_step(model, AdamW(learning_rate=1e-4), crit,
                            amp_dtype=amp_dtype, **kw)


def phase_kv_layout_parity(steps=3, amp_dtype=None):
    """GPT-125M widths at 2 layers in f32 (or with `amp_dtype`, f32
    masters: float16 runs the f16 relayouts and head-major flash
    kernels), batch 2 x 256: `steps` AdamW steps under
    FLAGS_flash_layout=kv and the same steps on the native tier, from the
    same weights and batch.  The losses and every parameter after the
    steps must be bit-identical (the head-major kernels differ from the
    native ones only in addressing)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _gpt125m(2)
    rs = np.random.RandomState(SEED)
    ids, labels = (torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 256))
                                    .astype(np.int32)).cuda()
                   for _ in range(2))
    runs = {}
    for layout in (None, "kv"):
        with _layout(layout):
            model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
            K.reset_launches()
            losses = _train_step(model, amp_dtype=amp_dtype).run_steps(
                ids, labels, repeat=steps)
            torch.cuda.synchronize()
            runs[layout] = (losses.cpu(), K.launch_counts(),
                            [p.detach().clone() for p in model.parameters()])
            del model
    (ln, cn, pn), (lk, ck, pk) = runs[None], runs["kv"]
    check(torch.isfinite(ln).all().item(), f"kv_layout_parity losses {ln}")
    check(torch.equal(ln, lk), f"kv_layout_parity: losses native "
          f"{ln.tolist()} vs kv {lk.tolist()}")
    diff = [i for i, (a, b) in enumerate(zip(pn, pk)) if not torch.equal(a, b)]
    check(not diff, f"kv_layout_parity: {len(diff)} of {len(pn)} parameters "
          f"differ after {steps} steps (first: #{diff[:1]})")
    per = 2 * cfg.num_layers * steps
    check(cn["relayout_to_hm"] == cn["relayout_from_hm"] == 0
          and ck["relayout_to_hm"] == ck["relayout_from_hm"] == per
          and cn["flash_fwd"] == ck["flash_fwd"] > 0,
          f"kv_layout_parity launches native {json.dumps(cn)} kv "
          f"{json.dumps(ck)}")
    log(f"[kv_layout_parity] {amp_dtype or 'f32'} GPT-125M widths 2L B2 "
        f"S256, {steps} AdamW "
        f"steps: losses {lk.tolist()} bit-identical on both tiers, "
        f"{len(pk)} parameters bit-identical; kv launches {json.dumps(ck)}")
    return ck


def phase_train_parity(cls, cfg, name, batch, seq, kernels):
    """3 f32 AdamW steps of `cls(cfg)` on the card and on the CPU from
    the same weights and batch; `kernels` must launch on the card.
    Returns the card run's launch counts."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(SEED)
    ids, labels = (rs.randint(0, cfg.vocab_size, (batch, seq))
                   .astype(np.int32) for _ in range(2))
    cpu = cls(cfg, device="cpu", seed=SEED)
    gpu = cls(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    K.reset_launches()
    step = _train_step(gpu)
    lg = step.run_steps(ids, labels, repeat=3).cpu().numpy()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    _train_replay_equals_eager(step, (ids, labels), 3,
                               f"train_parity f32 {name} widths")
    del gpu, step
    lc = _train_step(cpu).run_steps(ids, labels, repeat=3).numpy()
    gap = float(np.abs(lg - lc).max())
    check(np.isfinite(lg).all() and np.isfinite(lc).all(),
          f"train_parity non-finite losses {lg} / {lc}")
    check(gap <= 1e-3, f"train_parity card {lg} vs cpu {lc}: max gap "
          f"{gap:.3g} > 1e-3")
    for k in kernels:
        check(counts[k] > 0, f"train_parity never launched {k}")
    log(f"[train_parity] f32 {name} widths {cfg.num_layers}L B{batch} "
        f"S{seq}, 3 AdamW steps: card {lg.tolist()} cpu {lc.tolist()} max "
        f"gap {gap:.3g} (tol 1e-3); launches {json.dumps(counts)}")
    return counts


def _train_replay_equals_eager(step, batch, steps, what):
    """`run_steps(*batch, repeat=steps)` through the train step's captured
    graph against `steps` calls of its eager body (`_step`) from equal
    copies of the state and of the dropout generator's state: the
    losses, every parameter, optimizer slot, the step count and every
    buffer after the steps, and the generator's state, bit for bit."""
    import torch

    placed = step._place(batch)
    key = tuple((b.shape, b.dtype) for b in placed)
    check(key in step._graphs, f"{what}: no graph captured for the batch")
    state = step._state_tensors()
    with torch.no_grad():
        start = [t.clone() for t in state]
    gen_start = step.generator.get_state()
    # the optimizer's current rate for every step (a scheduler is left
    # where it is), refilled before each eager body as `run_steps` does
    rates = [step.optimizer.get_lr()] * steps
    replayed = step.run_steps(*batch, repeat=steps, lrs=rates)
    gen_after = step.generator.get_state()
    with torch.no_grad():
        after = [t.clone() for t in state]
        for t, s in zip(state, start):
            t.copy_(s)
    del start
    step.generator.set_state(gen_start)
    direct = []
    for rate in rates:
        step._lr.fill_(rate)
        direct.append(step._step(placed))
    direct = torch.stack(direct)
    torch.cuda.synchronize()
    diff = [i for i, (a, t) in enumerate(zip(after, state))
            if not torch.equal(a, t)]
    check(torch.equal(replayed, direct), f"{what}: replayed losses "
          f"{replayed.tolist()} differ from the eager body's "
          f"{direct.tolist()}")
    check(not diff, f"{what}: {len(diff)} of {len(state)} state tensors "
          f"differ between the replay and the eager body (first "
          f"#{diff[:1]})")
    check(torch.equal(gen_after, step.generator.get_state()),
          f"{what}: the replays and the eager bodies left the dropout "
          "generator in different states")
    log(f"[graphs] {what}: run_steps(repeat={steps}) replay == {steps} "
        f"eager bodies bit for bit (losses, {len(state)} parameters, "
        "slots, step and buffers, and the dropout generator's state)")


# ----------------------------------------------------------------- phase 8
class _layout:
    """FLAGS_flash_layout set for the body of a with-statement (None: the
    default tier), restored after it."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.prev = os.environ.pop("FLAGS_flash_layout", None)
        if self.value is not None:
            os.environ["FLAGS_flash_layout"] = self.value

    def __exit__(self, *exc):
        os.environ.pop("FLAGS_flash_layout", None)
        if self.prev is not None:
            os.environ["FLAGS_flash_layout"] = self.prev


def _graph_replayed(step, forwards, steps, what):
    """The train step's `steps` calls ran the model's forward in Python
    twice, for the eager first step of the batch's signature and for the
    capture, and replayed one graph for the rest."""
    check(len(forwards) == 2 and len(step._graphs) == 1,
          f"{what}: {len(forwards)} model forwards in {steps} steps and "
          f"{len(step._graphs)} graphs: the step did not replay one graph")


def phase_train(card, layout=None):
    """bench.py's GPT-125M step; `layout` "kv" runs it under
    FLAGS_flash_layout=kv (the relayouts around the head-major flash
    kernels: 2 + 2 per layer per step)."""
    with _layout(layout):
        return _train_phase(card, layout)


def _train_phase(card, layout):
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels as K

    cfg = _gpt125m(12)
    batch, seq, iters = 8, 1024, 10
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
    step = _train_step(model, amp_dtype="bfloat16")
    rs = np.random.RandomState(0)                 # bench.py:87
    ids, labels = (torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).cuda()
        for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards, hook = _count_forwards(model)
    warm = [float(step(ids, labels)) for _ in range(2)]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = step.run_steps(ids, labels, repeat=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    hook.remove()
    losses = losses.cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    steady = torch.cuda.memory_allocated()
    _graph_replayed(step, forwards, 2 + iters, "train")
    n_params = sum(p.numel() for p in model.parameters())  # bench.py:174
    tps = batch * seq * iters / dt
    peak_flops = PEAK_FLOPS["bfloat16"]
    mfu = 6 * n_params * tps / peak_flops
    check(np.isfinite(warm).all() and np.isfinite(losses).all(),
          f"train: non-finite loss {warm} {losses.tolist()}")
    check(losses[-1] < warm[0], f"train: loss did not fall ({warm[0]} -> "
          f"{losses[-1]})")
    want = {"flash_fwd": 1, "flash_bwd": 1, "relayout_to_hm": 0,
            "relayout_from_hm": 0}
    if layout == "kv":
        want.update(relayout_to_hm=2, relayout_from_hm=2)
    for k, per_layer in want.items():
        check(counts[k] == per_layer * cfg.num_layers * iters,
              f"train: {k} launched {counts[k]} times in {iters} steps, "
              f"expected {per_layer * cfg.num_layers} per step")
    log(f"[train] GPT-125M bf16 AMP 12L B{batch} S{seq} flash layout "
        f"{layout or 'native'} ({card}): "
        f"{tps:.1f} tokens/s, {1e3 * dt / iters:.2f} ms/step, MFU "
        f"{100 * mfu:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"(N={n_params}), peak memory {peak / 2**30:.2f} GiB (reserved "
        f"{reserved / 2**30:.2f}, allocated after the steps "
        f"{steady / 2**30:.2f}); loss "
        f"{warm[0]:.4f} -> {losses[-1]:.4f}; launches per step "
        f"{json.dumps({k: v / iters for k, v in counts.items()})}")
    _train_replay_equals_eager(step, (ids, labels), iters,
                               f"train GPT-125M bf16 layout "
                               f"{layout or 'native'}")
    return counts, step, ids, labels


# ------------------------------------------------------- phases 13 and 14
# (constructor, kwargs, kernel, launches per forward): ResNet-50 runs 49
# eval-mode conv_bn_act (the stem and 3 per bottleneck; the 4 downsample
# projections are plain convs), MobileNetV2 35 (17 of them depthwise),
# Swin-T one window_attention per block
VISION = (("resnet50", "conv_bn_act", 49), ("mobilenet_v2", "conv_bn_act", 35),
          ("swin_t", "window_attention", 12))
VISION_BATCH = 64   # served batch; phase 3's vision rows take its shapes
# the vision train step (bench.py:229-291, its first batch candidates,
# :1322-1340): (model, batch, flops per image, launches per step)
VISION_TRAIN = (("swin_t", 128, 3 * 4.5e9,
                 {"window_attention": 12, "window_attention_bwd": 12}),
                ("resnet50", 256, 3 * 4.09e9, {}),
                ("vit_b_16", VIT_BATCH, 3 * 17.6e9,
                 {"flash_fwd": 12, "flash_bwd": 12}))
SWIN_TRAIN_BATCH = VISION_TRAIN[0][1]  # phase 3's backward rows take it


def _vision_model(name, device, dtype):
    """A seeded model with its batch-norm running statistics drawn from
    the seed too (means N(0, 0.1), variances U(0.5, 2)), so the fused
    path folds non-trivial statistics."""
    import torch

    from paddle_tpu_torch.vision import models as V

    model = getattr(V, name)(device=device, dtype=dtype, seed=SEED)
    rs = np.random.RandomState(SEED + 5)
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "_variance"):
                n = mod._mean.numel()
                mod._mean.copy_(torch.from_numpy(
                    rs.normal(0, 0.1, n).astype(np.float32)))
                mod._variance.copy_(torch.from_numpy(
                    rs.uniform(0.5, 2.0, n).astype(np.float32)))
    return model


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_vision_parity(batch=2):
    """f32 at full width and depth: the card's forward through the
    kernels against the CPU port's plain forward, same weights and
    statistics (TF32 off for the card's plain convs and matmuls)."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(SEED + 6).randn(
        batch, 3, 224, 224).astype(np.float32))
    for name, kernel, per_fwd in VISION:
        cpu = _vision_model(name, "cpu", torch.float32)
        gpu = _vision_model(name, "cuda", torch.float32)
        gpu.load_state_dict(cpu.state_dict())
        K.reset_launches()
        with torch.inference_mode():
            lg = gpu(x.cuda())
            torch.cuda.synchronize()
            counts = K.launch_counts()
            lc = cpu(x)
        rel = _rel_l2(lg.cpu(), lc)
        check(lg.shape == (batch, 1000) and bool(torch.isfinite(lg).all()),
              f"vision_parity {name}: logits {tuple(lg.shape)} not finite")
        check(rel <= 1e-3, f"vision_parity {name}: card vs cpu logits rel "
              f"L2 {rel:.3g} > 1e-3")
        check(counts[kernel] == per_fwd,
              f"vision_parity {name}: {kernel} launched {counts[kernel]} "
              f"times in one forward, expected {per_fwd}")
        log(f"[vision_parity] {name} f32 B{batch} 224: card vs cpu logits "
            f"rel L2 {rel:.3g} (tol 1e-3), max |logit| "
            f"{lc.abs().max().item():.4g}; {kernel} {counts[kernel]} "
            f"launches")
        del cpu, gpu


def _vision_rate(model, x, iters):
    """images/s and ms a batch of `model(x)` over `iters` calls after 2
    warm-ups (inside inference mode), timed between synchronizes; the
    last call's logits."""
    import torch

    for _ in range(2):
        model(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        logits = model(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return x.shape[0] * iters / dt, 1e3 * dt / iters, logits


def _serve_vision(model, x, name, kernel, per_fwd, iters):
    """`model` served eager and then through `jit.to_static(model)`
    (inside inference mode): (to_static images/s, ms a batch, eager
    images/s, ms a batch, the replayed logits, the launch counts of the
    to_static calls, their peak memory).  The replayed logits equal the
    eager ones bit for bit, with `per_fwd` launches of `kernel` a call
    (a replay calls no forward hook) and no other kernel."""
    import torch

    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.ops import kernels as K

    eager, eager_ms, eager_logits = _vision_rate(model, x, iters)
    to_static(model)
    model(x)                          # warm-up, capture, replay
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    rate, ms, logits = _vision_rate(model, x, iters)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    calls = iters + 2
    dn = _dn(x.dtype)
    check(logits.shape == (x.shape[0], 1000)
          and bool(torch.isfinite(logits).all()),
          f"vision_serve {name} {dn}: bad logits")
    check(torch.equal(logits, eager_logits),
          f"vision_serve {name} {dn}: the replayed logits differ from the "
          "eager forward's")
    check(counts[kernel] == per_fwd * calls,
          f"vision_serve {name} {dn}: {kernel} launched {counts[kernel]} "
          f"times in {calls} to_static calls, expected {per_fwd} per call")
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(not others, f"vision_serve {name} {dn}: other kernels {others}")
    return rate, ms, eager, eager_ms, logits, counts, peak


def _cast16(model, dtype):
    """Cast `model`'s bf16 parameters and buffers to `dtype` in place
    (f32 ones, such as batch-norm statistics, stay f32, as in a model
    built in `dtype`); its graphs and generate() programs see new
    addresses and capture again."""
    import torch

    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.dtype == torch.bfloat16:
                t.data = t.data.to(dtype)
    torch.cuda.empty_cache()


def phase_vision_serve(card, batch=VISION_BATCH, iters=10, profile=False):
    """bf16 serving of the three models, eager and then through
    `jit.to_static(model)` (a CUDA graph of the forward, replayed per
    call): images/s of each over `iters` batches after 2 warm-ups; the
    replayed logits equal the eager ones bit for bit; exact launches per
    `StaticFunction` call (a replay calls no forward hook); the card's
    bf16 logits against the CPU port's plain f32 forward of the same
    weights and batch (no kernel on that side).  Then each model cast in
    place to float16 (`_cast16`) and served again the same way, its
    logits held to the same f32 CPU forward (the bf16 weights and batch
    are f16 values too, but for the tiniest weights' bits).  Returns the
    launch counts of the bf16 and of the f16 to_static calls."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(batch, 3, 224, 224, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    totals = ({}, {})
    for name, kernel, per_fwd in VISION:
        model = _vision_model(name, "cuda", torch.bfloat16)
        with torch.inference_mode():
            rate, ms, eager, eager_ms, logits, counts, peak = \
                _serve_vision(model, x, name, kernel, per_fwd, iters)
            cpu = _vision_model(name, "cpu", torch.float32)
            cpu.load_state_dict(model.state_dict())
            t_cpu = time.perf_counter()
            ref = cpu(x.float().cpu())
            rel = _rel_l2(logits.cpu(), ref)
            t_cpu = time.perf_counter() - t_cpu
            del cpu
            if profile:
                _profile_forward(model, x, f"{name} bf16 B{batch} forward "
                                 "(to_static)")
        check(math.isfinite(rel) and rel < 0.05,
              f"vision_serve {name}: bf16 card vs f32 cpu logits rel L2 "
              f"{rel:.3g} >= 0.05")
        for k, v in counts.items():
            totals[0][k] = totals[0].get(k, 0) + v
        calls = iters + 2
        log(f"[vision_serve] {name} bf16 B{batch} 224 ({card}): to_static "
            f"{rate:.1f} images/s, {ms:.2f} ms/batch; eager {eager:.1f} "
            f"images/s, {eager_ms:.2f} ms/batch, over {iters} batches; "
            f"replay == eager logits bit for bit; peak memory "
            f"{peak / 2**30:.2f} GiB; bf16 card vs f32 cpu plain logits rel "
            f"L2 {rel:.4f} (tol 0.05, cpu forward {t_cpu:.1f}s); {kernel} "
            f"{counts[kernel] // calls} launches per call")
        del model.forward            # the eager forward again
        _cast16(model, torch.float16)
        x16 = x.to(torch.float16)
        with torch.inference_mode():
            rate, ms, eager, eager_ms, logits, counts, peak = \
                _serve_vision(model, x16, name, kernel, per_fwd, iters)
        rel = _rel_l2(logits.cpu(), ref)
        check(math.isfinite(rel) and rel < 0.05,
              f"vision_serve {name}: f16 card vs f32 cpu logits rel L2 "
              f"{rel:.3g} >= 0.05")
        for k, v in counts.items():
            totals[1][k] = totals[1].get(k, 0) + v
        log(f"[vision_serve] {name} f16 B{batch} 224 ({card}): to_static "
            f"{rate:.1f} images/s, {ms:.2f} ms/batch; eager {eager:.1f} "
            f"images/s, {eager_ms:.2f} ms/batch, over {iters} batches; "
            f"replay == eager logits bit for bit; peak memory "
            f"{peak / 2**30:.2f} GiB; f16 card vs f32 cpu plain logits rel "
            f"L2 {rel:.4f} (tol 0.05); {kernel} "
            f"{counts[kernel] // calls} launches per call")
        del model, ref
        torch.cuda.empty_cache()
    return totals


def _vision_train_step(name, batch, amp_dtype="bfloat16", device="cuda"):
    """bench.py's vision train step (:252-264): the model in f32 masters
    with seeded weights, Momentum(lr 1e-3, momentum 0.9),
    CrossEntropyLoss, `amp_dtype` O2; images and labels made with numpy
    from seed 0, as bench.py makes them.  Returns (step, images,
    labels), the batch on `device`."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as V

    model = getattr(V, name)(device=device, seed=SEED)
    step = build_train_step(model, Momentum(learning_rate=1e-3,
                                            momentum=0.9),
                            nn.CrossEntropyLoss(), amp_dtype=amp_dtype)
    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(rs.randn(batch, 3, 224, 224).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(
        np.int32)).to(device)
    return step, imgs, labels


def _launches_per_step(counts, want, steps, what):
    """Exactly `want[kernel]` launches per step of every kernel named
    there, and none of the others."""
    for k, v in counts.items():
        check(v == want.get(k, 0) * steps,
              f"{what}: {k} launched {v} times in {steps} steps, expected "
              f"{want.get(k, 0)} per step")


def phase_vision_train_parity(batch=2, steps=3):
    """f32 at full width and depth: `steps` Momentum steps of Swin-T,
    ResNet-50 and ViT-B/16 on the card through the kernels (TF32 off in
    cuBLAS and cuDNN) and on the CPU through the plain versions, from
    the same weights, batch-norm statistics and batch.

    Free-running, ResNet-50's trajectories part after the first step
    whatever computes them: at batch 2 its loss falls from 8.3 by more
    than 1 per step, and rounding in the batch-norm backward moves the
    next steps' losses by ~0.1 (the free-running gap is logged, not
    held).  So every held step starts from one state: before it, the
    card's parameters, running statistics and Momentum velocities are
    set to the CPU's.  Held: each step's losses within 1e-3, then the
    running statistics after the last step within 1e-3 relative L2, and
    the launches per step exactly."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import Momentum

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(SEED + 9)
    x = rs.randn(batch, 3, 224, 224).astype(np.float32)
    labels = rs.randint(0, 1000, (batch,)).astype(np.int32)

    def steps_of(*models):
        return [build_train_step(m, Momentum(learning_rate=1e-3,
                                             momentum=0.9),
                                 nn.CrossEntropyLoss()) for m in models]

    for name, _, _, want in VISION_TRAIN:
        cpu = _vision_model(name, "cpu", torch.float32)
        gpu = _vision_model(name, "cuda", torch.float32)
        init = {k: v.clone() for k, v in cpu.state_dict().items()}
        gpu.load_state_dict(init)
        free = [s.run_steps(x, labels, repeat=steps).cpu().numpy()
                for s in steps_of(gpu, cpu)]
        free_gap = float(np.abs(free[0] - free[1]).max())
        for m in (gpu, cpu):
            m.load_state_dict(init)
        sg, sc = steps_of(gpu, cpu)
        lg, lc = [], []
        K.reset_launches()
        for _ in range(steps):
            gpu.load_state_dict(cpu.state_dict())
            for n, slot in sc._state["slots"].items():
                sg._state["slots"][n]["velocity"].copy_(slot["velocity"])
            lg.append(float(sg(x, labels)))
            lc.append(float(sc(x, labels)))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        lg, lc = np.array(lg), np.array(lc)
        gap = float(np.abs(lg - lc).max())
        check(np.isfinite(lg).all() and np.isfinite(lc).all(),
              f"vision_train_parity {name}: non-finite losses {lg} / {lc}")
        check(gap <= 1e-3, f"vision_train_parity {name}: card {lg} vs cpu "
              f"{lc}: max gap {gap:.3g} > 1e-3")
        _launches_per_step(counts, want, steps,
                           f"vision_train_parity {name}")
        stats = [(n, _rel_l2(a.cpu(), b)) for (n, a), b in
                 zip(gpu.named_buffers(), cpu.buffers())
                 if n.endswith(("_mean", "_variance"))]
        worst = max(stats, key=lambda t: t[1], default=("none", 0.0))
        check(worst[1] <= 1e-3, f"vision_train_parity {name}: running "
              f"statistic {worst[0]} rel L2 {worst[1]:.3g} > 1e-3")
        log(f"[vision_train_parity] {name} f32 B{batch} 224, {steps} "
            f"Momentum steps from the CPU's state each: card {lg.tolist()} "
            f"cpu {lc.tolist()} max gap {gap:.3g} (tol 1e-3); "
            f"{len(stats)} running statistics, worst rel L2 {worst[1]:.3g} "
            f"({worst[0]}, tol 1e-3); free-running card {free[0].tolist()} "
            f"cpu {free[1].tolist()} gap {free_gap:.3g} (not held); "
            f"launches per step "
            f"{json.dumps({k: v / steps for k, v in counts.items() if v})}")
        del cpu, gpu, sg, sc
        gc.collect()
        torch.cuda.empty_cache()


def phase_vision_train(card, iters=10, profile=False):
    """bench.py's vision rows on the card: Swin-T at batch 128,
    ResNet-50 at batch 256 and ViT-B/16 at batch 128 (a profiler split
    of one ViT step), bf16 O2 over f32 masters, 2 warm-up steps,
    then `run_steps(repeat=iters)` timed between synchronizes: images/s,
    ms per step, MFU (images/s x bench.py's flops per image / 989
    TFLOP/s), peak memory, exact launches per step.  The loss must stay
    finite and fall.  Returns the launch counts of the timed runs."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    total = {}
    for name, batch, flops_per_image, want in VISION_TRAIN:
        step, imgs, labels = _vision_train_step(name, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        forwards, hook = _count_forwards(step.model)
        warm = [float(step(imgs, labels)) for _ in range(2)]
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        losses = step.run_steps(imgs, labels, repeat=iters)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        hook.remove()
        losses = losses.cpu().numpy()
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        steady = torch.cuda.memory_allocated()
        _graph_replayed(step, forwards, 2 + iters, f"vision_train {name}")
        ips = batch * iters / dt
        mfu = ips * flops_per_image / PEAK_FLOPS["bfloat16"]
        check(np.isfinite(warm).all() and np.isfinite(losses).all(),
              f"vision_train {name}: non-finite loss {warm} "
              f"{losses.tolist()}")
        check(losses[-1] < warm[0], f"vision_train {name}: loss did not "
              f"fall ({warm[0]} -> {losses[-1]})")
        _launches_per_step(counts, want, iters, f"vision_train {name}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log(f"[vision_train] {name} bf16 O2 B{batch} 224 ({card}): "
            f"{ips:.1f} images/s, {1e3 * dt / iters:.2f} ms/step over "
            f"{iters} steps, MFU {100 * mfu:.2f}% of "
            f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s ({flops_per_image:.4g}"
            f" flops/image), peak memory {peak / 2**30:.2f} GiB (reserved "
            f"{reserved / 2**30:.2f}, allocated after the steps "
            f"{steady / 2**30:.2f}); loss "
            f"{warm[0]:.4f} -> {losses[-1]:.4f}; launches per step "
            f"{json.dumps({k: v / iters for k, v in counts.items() if v})}")
        _train_replay_equals_eager(step, (imgs, labels), iters,
                                   f"vision_train {name} bf16 O2 B{batch}")
        if name == "vit_b_16" or (profile and name == "swin_t"):
            phase_profile_train(step, (imgs, labels), steps=1,
                                what=f"{name} bf16 B{batch} train step")
        if name == "swin_t":
            f16 = _vision_train_f16(card, step.model, imgs, labels,
                                    flops_per_image, want, iters)
        del step, imgs, labels
        gc.collect()
        torch.cuda.empty_cache()
    return total, f16


def _vision_train_f16(card, model, imgs, labels, flops_per_image, want,
                      iters):
    """The same model (its f32 masters where the bf16 steps left them)
    in a second train step, O2 in float16 (the f16 window kernels,
    forward and backward): 2 warm-up steps, then `run_steps(repeat=
    iters)` timed: images/s, ms per step, peak memory, the launches a
    step of the bf16 step; finite losses that fall; every later call a
    replay.  Returns the timed steps' launch counts."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import Momentum

    batch = imgs.shape[0]
    step = build_train_step(model, Momentum(learning_rate=1e-3,
                                            momentum=0.9),
                            nn.CrossEntropyLoss(), amp_dtype="float16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards, hook = _count_forwards(model)
    warm = [float(step(imgs, labels)) for _ in range(2)]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = step.run_steps(imgs, labels, repeat=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    hook.remove()
    losses = losses.cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    _graph_replayed(step, forwards, 2 + iters, "vision_train swin_t f16")
    check(np.isfinite(warm).all() and np.isfinite(losses).all()
          and losses[-1] < warm[0],
          f"vision_train swin_t f16: losses {warm} {losses.tolist()}")
    _launches_per_step(counts, want, iters, "vision_train swin_t f16")
    ips = batch * iters / dt
    log(f"[vision_train] swin_t f16 O2 B{batch} 224 ({card}): {ips:.1f} "
        f"images/s, {1e3 * dt / iters:.2f} ms/step over {iters} steps, MFU "
        f"{100 * ips * flops_per_image / PEAK_FLOPS['float16']:.2f}%, peak "
        f"memory {peak / 2**30:.2f} GiB; loss {warm[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches per step "
        f"{json.dumps({k: v / iters for k, v in counts.items() if v})}")
    del step
    return counts


# ------------------------------------------------------ phases 17 to 20
def phase_varlen(card, dtypes=None):
    """`flash_attn_unpadded` forward and backward on the packed batch
    (causal and not, and not causal over keys packed twice as long), in
    bf16 and f32 (or `dtypes`: phase 17a runs float16): exactly one
    varlen_fwd and one varlen_bwd launch each, held against the port's
    dense `FlashAttention` run on each sequence alone (the dense
    kernels: an independent check of the packed indexing).  Returns the launch counts of the packed calls."""
    import torch

    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.flash_attention import FlashAttention

    total = {}
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for label, causal, unequal in (("causal", True, False),
                                       ("full", False, False),
                                       ("full, k packed 2x", False, True)):
            q, k, v, dout, cq, ck, lq, lk = _varlen_batch(torch, dtype,
                                                          unequal, seed=1)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            out, _ = flash_attn_unpadded(*leaves, cq, ck, max(lq), max(lk),
                                         None, causal=causal)
            out.backward(dout)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = K.launch_counts()
            _launches_per_step(counts, {"varlen_fwd": 1, "varlen_bwd": 1},
                               1, f"varlen {label} {dname}")
            for kk, n in counts.items():
                total[kk] = total.get(kk, 0) + n
            grads = [x.grad for x in leaves]
            check(bool(torch.isfinite(out).all()) and all(
                bool(torch.isfinite(g_).all()) for g_ in grads),
                f"varlen {label} {dname}: non-finite output or gradient")
            # each sequence alone through the dense flash kernels
            errs, tops = [0.0] * 4, [0.0] * 4
            bq, bk = cq.tolist(), ck.tolist()
            for i in range(len(lq)):
                if lq[i] == 0:
                    continue
                sq, sk = slice(bq[i], bq[i + 1]), slice(bk[i], bk[i + 1])
                dl = [x.detach()[s_][None].requires_grad_()
                      for x, s_ in ((q, sq), (k, sk), (v, sk))]
                o = FlashAttention.apply(*dl, None, causal)
                o.backward(dout[sq][None])
                for j, (a, b) in enumerate(zip(
                        (out[sq], grads[0][sq], grads[1][sk], grads[2][sk]),
                        (o[0], dl[0].grad[0], dl[1].grad[0],
                         dl[2].grad[0]))):
                    errs[j] = max(errs[j], (a.float() - b.float()).abs()
                                  .max().item())
                    tops[j] = max(tops[j], b.float().abs().max().item())
            # out absolute, gradients relative to the largest, as phase 3
            tol = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL,
                   torch.float16: F16_TOL}[dtype]
            held = [errs[0]] + [e / t for e, t in zip(errs[1:], tops[1:])]
            check(all(math.isfinite(h) and h <= tol for h in held),
                  f"varlen {label} {dname}: packed vs per-sequence dense "
                  f"(out abs, dq dk dv rel) {held} > {tol}")
            launched = {k_: n for k_, n in counts.items() if n}
            log(f"[varlen] {label} {dname} T{sum(lq)} Tk{sum(lk)} H12 D64 "
                f"({card}): fwd+bwd {ms:.2f} ms (first call, host clock); "
                f"packed vs per-sequence dense flash: out max_abs_err "
                f"{held[0]:.3g}, dq/dk/dv rel "
                f"{', '.join(f'{h:.3g}' for h in held[1:])} (tol {tol}); "
                f"launches {json.dumps(launched)}")
    return total


def _mse():
    """The encoder train step's loss: mean squared error against a seeded
    target, in f32 (no new loss in the package)."""
    import torch

    class MSE(torch.nn.Module):
        def forward(self, out, target):
            return (out.float() - target.float()).square().mean()
    return MSE()


def _encoder(n, width, heads, ffn, device, seed=SEED):
    """n post-LN `FusedTransformerEncoderLayer`s (gelu, dropout 0), f32,
    each seeded from `seed` + its index."""
    import torch

    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    return torch.nn.Sequential(*[FusedTransformerEncoderLayer(
        width, heads, ffn, dropout_rate=0.0, activation="gelu",
        device=device, seed=seed + i) for i in range(n)])


def phase_fused_transformer_parity():
    """f32, width 256, 4 heads, ffn 1024, 2 layers, seeded with the JAX
    package's initialiser rule: `FusedMultiTransformer` (eval) and a
    stack of two `FusedTransformerEncoderLayer`s (training: outputs and
    every gradient of a seeded linear functional of the output) on the
    card through
    the kernels against the same modules on the CPU through the plain
    versions, within 1e-4 relative L2 (TF32 off); exact launches."""
    import torch

    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(SEED + 50).randn(
        2, 128, 256).astype(np.float32))
    cpu = FusedMultiTransformer(256, 4, 1024, num_layers=2, device="cpu",
                                seed=SEED).eval()
    gpu = FusedMultiTransformer(256, 4, 1024, num_layers=2,
                                seed=SEED).eval()
    gpu.load_state_dict(cpu.state_dict())
    K.reset_launches()
    with torch.inference_mode():
        yg = gpu(x.cuda())
        torch.cuda.synchronize()
        counts = K.launch_counts()
        yc = cpu(x)
    rel = _rel_l2(yg.cpu(), yc)
    check(math.isfinite(rel) and rel <= 1e-4,
          f"fused_transformer_parity FusedMultiTransformer: rel L2 "
          f"{rel:.3g} > 1e-4")
    _launches_per_step(counts, {"fused_norm": 4, "flash_fwd": 2}, 1,
                       "fused_transformer_parity FusedMultiTransformer")
    cpu, gpu = _encoder(2, 256, 4, 1024, "cpu"), _encoder(2, 256, 4, 1024,
                                                          "cuda")
    gpu.load_state_dict(cpu.state_dict())
    outs, grads = [], []
    # a fixed linear functional of the output (the mean square of a
    # post-LN output hardly depends on the weights: f32 rounding then
    # decides its gradients)
    gy = torch.from_numpy(np.random.RandomState(SEED + 51).randn(
        *x.shape).astype(np.float32))
    K.reset_launches()
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        m.train()
        out = m(x.to(dev))
        # the post-LN layers leave their pre-LN scales unread: zero
        grads.append(torch.autograd.grad((out * gy.to(dev)).mean(),
                                         list(m.parameters()),
                                         allow_unused=True,
                                         materialize_grads=True))
        outs.append(out.detach().cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            ecounts = K.launch_counts()
    erel = _rel_l2(outs[0], outs[1])
    worst = max(((n, _rel_l2(a.cpu(), b)) for n, a, b in zip(
        dict(cpu.named_parameters()), *grads)), key=lambda t: t[1])
    check(erel <= 1e-4 and worst[1] <= 1e-4,
          f"fused_transformer_parity encoder: out rel L2 {erel:.3g}, worst "
          f"gradient {worst[0]} rel L2 {worst[1]:.3g} (tol 1e-4)")
    _launches_per_step(ecounts, {"fused_norm": 4, "flash_fwd": 2,
                                 "flash_bwd": 2}, 1,
                       "fused_transformer_parity encoder")
    log(f"[fused_transformer_parity] f32 W256 H4 F1024 2 layers, B2 S128: "
        f"FusedMultiTransformer card vs cpu rel L2 {rel:.3g}; encoder "
        f"stack out rel L2 {erel:.3g}, worst of "
        f"{len(grads[1])} gradients {worst[1]:.3g} ({worst[0]}) (tol "
        f"1e-4); launches {json.dumps({k: v for k, v in counts.items() if v})}"
        f" / {json.dumps({k: v for k, v in ecounts.items() if v})}")


# the fused serving block at gpt_1p3b widths and the encoder train step
# at ernie_base widths (paddle_tpu/models/ernie.py:171)
SERVE_BLOCK = dict(embed=2048, heads=16, ffn=8192, layers=24, batch=8,
                   seq=1024)
ENCODER = dict(width=768, heads=12, ffn=3072, layers=12, batch=32, seq=512)


def _fused_serve_run(model, x, ref, card, iters, profile):
    """`iters` timed forwards of the fused block at x's dtype after 2
    warm-ups (inference mode), held to the f32 output `ref` within 5%
    relative L2 and to exactly 2 fused_norm and 1 flash_fwd launches a
    layer a forward.  Returns the launch counts."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    c = SERVE_BLOCK
    dn = _dn(x.dtype)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rel = _rel_l2(out, ref)
        if profile:
            _profile_forward(model, x, "fused_transformer_serve forward "
                             f"(B{c['batch']} S{c['seq']} {dn})", steps=1)
    check(out.shape == x.shape and bool(torch.isfinite(out).all()),
          f"fused_transformer_serve {dn}: non-finite output")
    check(math.isfinite(rel) and rel < 0.05,
          f"fused_transformer_serve: {dn} vs f32 rel L2 {rel:.3g} >= 0.05")
    _launches_per_step(counts, {"fused_norm": 2 * c["layers"],
                                "flash_fwd": c["layers"]}, iters,
                       f"fused_transformer_serve {dn}")
    tokens = c["batch"] * c["seq"] * iters
    log(f"[fused_transformer_serve] FusedMultiTransformer gpt_1p3b widths "
        f"{c['layers']}L {dn} B{c['batch']} S{c['seq']} ({card}): "
        f"{1e3 * dt / iters:.2f} ms/forward, {tokens / dt:.1f} tokens/s "
        f"over {iters} forwards, peak memory {peak / 2**30:.2f} GiB; {dn} "
        f"vs f32 rel L2 {rel:.4f} (tol 0.05); launches per forward "
        f"{json.dumps({k: v / iters for k, v in counts.items() if v})}")
    return counts


def phase_fused_transformer_serve(card, iters=10):
    """`FusedMultiTransformer` at gpt_1p3b widths (embed 2048, 16 heads,
    ffn 8192, 24 layers, gelu, pre-LN) in bf16, eval, batch 8 x 1024:
    ms per forward and tokens/s over `iters` forwards after 2 warm-ups,
    peak memory, exactly 48 fused_norm and 24 flash_fwd launches per
    forward, a profiler split of one forward; the output against the f32
    forward of the same weights on the card within 5% relative L2.  Then
    the same model cast to float16 in place (its norms' w and b too: the
    f16 fused-norm and flash kernels), the same checks.  Returns the
    launch counts of the bf16 and of the f16 timed forwards."""
    import torch

    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    c = SERVE_BLOCK
    torch.backends.cuda.matmul.allow_tf32 = False
    model = FusedMultiTransformer(c["embed"], c["heads"], c["ffn"],
                                  num_layers=c["layers"], activation="gelu",
                                  seed=SEED).eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    x = torch.randn(c["batch"], c["seq"], c["embed"], generator=g,
                    device="cuda")
    with torch.inference_mode():
        ref = model(x)                      # f32 through the kernels
    out = []
    for dtype in (torch.bfloat16, torch.float16):
        model.to(dtype)
        out.append(_fused_serve_run(model, x.to(dtype), ref, card, iters,
                                    dtype == torch.bfloat16))
    del model, ref
    return tuple(out)


def phase_fused_encoder_train(card, iters=10):
    """12 `FusedTransformerEncoderLayer`s at ernie_base widths (768, 12
    heads, ffn 3072, gelu, post-LN, dropout 0), batch 32 x 512, f32
    masters, bf16 O2, AdamW(lr 1e-3), `build_train_step`, the mean
    squared error against a seeded target: 2 warm-up steps, then
    `run_steps(repeat=iters)` timed between synchronizes: tokens/s, ms
    per step, MFU (6 N tokens/s over 989 TFLOP/s, as phase 8), peak
    memory, exactly 24 fused_norm, 12 flash_fwd and 12 flash_bwd launches
    per step, a profiler split of one step.  The loss must stay finite
    and fall.  Returns the launch counts of the timed steps."""
    import torch

    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW

    c = ENCODER
    model = _encoder(c["layers"], c["width"], c["heads"], c["ffn"], "cuda")
    step = build_train_step(model, AdamW(learning_rate=1e-3), _mse(),
                            amp_dtype="bfloat16")
    rs = np.random.RandomState(SEED + 70)
    x, target = (torch.from_numpy(rs.randn(
        c["batch"], c["seq"], c["width"]).astype(np.float32)).cuda()
        for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = [float(step(x, target)) for _ in range(2)]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = step.run_steps(x, target, repeat=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    losses = losses.cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    tps = c["batch"] * c["seq"] * iters / dt
    mfu = 6 * n_params * tps / PEAK_FLOPS["bfloat16"]
    check(np.isfinite(warm).all() and np.isfinite(losses).all(),
          f"fused_encoder_train: non-finite loss {warm} {losses.tolist()}")
    check(losses[-1] < warm[0], f"fused_encoder_train: loss did not fall "
          f"({warm[0]} -> {losses[-1]})")
    _launches_per_step(counts, {"fused_norm": 2 * c["layers"],
                                "flash_fwd": c["layers"],
                                "flash_bwd": c["layers"]}, iters,
                       "fused_encoder_train")
    log(f"[fused_encoder_train] {c['layers']} x FusedTransformerEncoderLayer "
        f"ernie_base widths bf16 O2 B{c['batch']} S{c['seq']} ({card}): "
        f"{tps:.1f} tokens/s, {1e3 * dt / iters:.2f} ms/step over {iters} "
        f"steps, MFU {100 * mfu:.2f}% of "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s (N={n_params}), peak "
        f"memory {peak / 2**30:.2f} GiB; loss {warm[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches per step "
        f"{json.dumps({k: v / iters for k, v in counts.items() if v})}")
    phase_profile_train(step, (x, target), steps=1,
                        what=f"fused_encoder_train step (B{c['batch']} "
                        f"S{c['seq']} bf16 O2)")
    del step, model
    return counts


def _ernie_objective(model):
    """ERNIE pretraining as a model that returns its own loss (the train
    step's ``loss_fn=None``): MLM and NSP logits into
    `ErniePretrainingCriterion`."""
    import torch

    from paddle_tpu_torch.models.ernie import ErniePretrainingCriterion

    class Objective(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model
            self.crit = ErniePretrainingCriterion()

        def forward(self, ids, token_types, mlm_labels, nsp_labels):
            logits, nsp_logits = self.model(ids, token_types)
            return self.crit(logits, nsp_logits, mlm_labels, nsp_labels)

    return Objective()


def _ernie_batch(cfg, batch, seq, seed):
    """An MLM + NSP batch: real lengths 256-512 (the tail padded with
    id 0), two segments (token type 1 from the middle of the real
    tokens), MLM labels on 15% of the real positions (-100 elsewhere),
    NSP labels 0 / 1; numpy from `seed`."""
    rs = np.random.RandomState(seed)
    lens = _ernie_lengths(rs, batch, seq)
    pos = np.arange(seq)[None]
    real = pos < lens[:, None]
    ids = np.where(real, rs.randint(1, cfg.vocab_size, (batch, seq)), 0)
    types = ((pos >= lens[:, None] // 2) & real).astype(np.int32)
    picked = real & (rs.rand(batch, seq) < 0.15)
    mlm = np.where(picked, rs.randint(1, cfg.vocab_size, (batch, seq)),
                   -100).astype(np.int64)
    nsp = rs.randint(0, 2, batch).astype(np.int64)
    return ids.astype(np.int32), types, mlm, nsp, int(picked.sum())


def phase_ernie_train(card, iters=10):
    """ERNIE-base pretraining as its recipe trains it: `ernie_base`
    widths (vocab 40000, hidden 768, 12 layers of 12 heads, ffn 3072,
    max position 2048), dropout 0.1, f32 masters under bf16 O2, batch 32
    x 512 with real lengths 256-512 (the pad bias runs the biased flash
    tier), MLM labels on 15% of the real tokens and NSP labels,
    AdamW(LinearWarmup(PolynomialDecay)) with weight decay 0.01 and
    ``grad_clip_norm=1.0``, through `build_train_step(loss_fn=None)` on a
    model that returns the criterion: 2 warm-up steps (the scheduler
    stepped after each), then `run_steps(repeat=iters)` timed between
    synchronizes: tokens/s (every position, pad included), ms per step,
    MFU (6 N tokens/s over 989 TFLOP/s, N with the tied word embedding
    counted once), peak memory, exactly 12 flash_fwd and 12 flash_bwd
    launches a step (each replay counted), a profiler split of one
    step.  The loss must stay finite and fall; the replays equal the
    eager body bit for bit from the same state and generator state, and
    a replay from the same state but the generator where the last one
    left it gives another loss (other masks).  Returns the launch counts
    of the timed steps."""
    import torch

    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.ernie import ErnieForPretraining, ernie_base
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as L

    cfg = ernie_base(dropout=0.1)
    model = ErnieForPretraining(cfg, device="cuda", seed=SEED)
    sched = L.LinearWarmup(L.PolynomialDecay(1e-4, decay_steps=1000,
                                             end_lr=0.0),
                           warmup_steps=2, start_lr=0.0, end_lr=1e-4)
    step = build_train_step(_ernie_objective(model),
                            AdamW(learning_rate=sched, weight_decay=0.01),
                            amp_dtype="bfloat16", grad_clip_norm=1.0)
    *batch, n_mlm = _ernie_batch(cfg, ERNIE_BATCH, ERNIE_SEQ, SEED + 21)
    batch = tuple(torch.from_numpy(b).cuda() for b in batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards, hook = _count_forwards(model)
    warm = []
    for _ in range(2):
        warm.append(float(step(*batch)))
        sched.step()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = step.run_steps(*batch, repeat=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    hook.remove()
    losses = losses.cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    _graph_replayed(step, forwards, 2 + iters, "ernie_train")
    n_params = sum(p.numel() for p in model.parameters())
    tps = ERNIE_BATCH * ERNIE_SEQ * iters / dt
    mfu = 6 * n_params * tps / PEAK_FLOPS["bfloat16"]
    check(np.isfinite(warm).all() and np.isfinite(losses).all(),
          f"ernie_train: non-finite loss {warm} {losses.tolist()}")
    check(losses[-1] < warm[0], f"ernie_train: loss did not fall "
          f"({warm[0]} -> {losses[-1]})")
    _launches_per_step(counts, {"flash_fwd": cfg.num_layers,
                                "flash_bwd": cfg.num_layers}, iters,
                       "ernie_train")
    log(f"[ernie_train] ERNIE-base MLM+NSP dropout {cfg.dropout} bf16 O2 "
        f"B{ERNIE_BATCH} S{ERNIE_SEQ} ({n_mlm} MLM labels), AdamW + "
        f"LinearWarmup(PolynomialDecay), grad_clip_norm 1.0 ({card}): "
        f"{tps:.1f} tokens/s, {1e3 * dt / iters:.2f} ms/step over {iters} "
        f"steps, MFU {100 * mfu:.2f}% of "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s (N={n_params}, the "
        f"tied embedding once), peak memory {peak / 2**30:.2f} GiB "
        f"(reserved {reserved / 2**30:.2f}); loss {warm[0]:.4f} -> "
        f"{losses[-1]:.4f} (rate {sched():.3g} after the steps); "
        f"launches per step "
        f"{json.dumps({k: v / iters for k, v in counts.items() if v})}")
    _train_replay_equals_eager(step, batch, iters,
                               "ernie_train ERNIE-base dropout 0.1 bf16")
    # the same state twice, the generator where the last replay left it:
    # other masks, so other gradients and another update (the bf16 loss
    # itself may round to one value)
    state = step._state_tensors()
    with torch.no_grad():
        start = [t.clone() for t in state]
    rate = [step.optimizer.get_lr()]
    first = step.run_steps(*batch, repeat=1, lrs=rate)
    with torch.no_grad():
        updated = [t.clone() for t in state]
        for t, s in zip(state, start):
            t.copy_(s)
    del start
    second = step.run_steps(*batch, repeat=1, lrs=rate)
    moved = sum(not torch.equal(a, t) for a, t in zip(updated, state))
    del updated
    check(moved > 0, "ernie_train: two replays from one state and two "
          "generator states updated every tensor alike: the masks did not "
          "change")
    log(f"[graphs] ernie_train: one state, two generator states: {moved} "
        f"of {len(state)} state tensors differ after the step (losses "
        f"{first.item():.4f} / {second.item():.4f})")
    phase_profile_train(step, batch, steps=1,
                        what=f"ernie_train step (B{ERNIE_BATCH} "
                        f"S{ERNIE_SEQ} bf16 O2, dropout {cfg.dropout})")
    del step, model
    return counts


# ------------------------------------------------------- phases 23-26
RESILIENT_DROPOUT = 0.1
RESILIENT_STEPS = 10


def _state_clone(step):
    import torch

    with torch.no_grad():
        return [t.clone() for t in step.train_state_dict().values()]


def _state_equal(step, saved):
    import torch

    return [i for i, (a, t) in enumerate(
        zip(saved, step.train_state_dict().values()))
        if not torch.equal(a, t)]


def _release_card():
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _timed_steps(step, batch, iters):
    """2 warm-up calls (the eager first step and its capture, one
    replay), then `run_steps(repeat=iters)` between synchronizes, its
    launch counts read around it: (warm losses, losses, seconds,
    counts)."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    warm = [float(step(*batch)) for _ in range(2)]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = step.run_steps(*batch, repeat=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return warm, losses.cpu().numpy(), dt, K.launch_counts()


def phase_recompute_parity(steps=3):
    """GPT-125M widths at 2 layers in f32 (TF32 off), batch 2 x 256,
    dropout 0.1, AdamW: `steps` steps (the eager first step, then
    replays) without recompute and under each policy (full, dots,
    dots_no_batch) from the same weights, batch and generator state.
    Each policy's losses and parameters within 1e-5 of the
    no-recompute run's (relative to the largest value), the dropout
    generator left where the no-recompute run left it (the replays drew
    from the step's replay generators), flash_fwd launched twice a layer
    a step and flash_bwd once.  A guarded step (guard=True) with and
    without recompute equals the unguarded one bit for bit.  Every such
    graph (recompute, guarded, both) replayed equals its eager body bit
    for bit from the same state and generator state."""
    import torch

    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(SEED)
    ids, labels = (torch.from_numpy(rs.randint(0, 50304, (2, 256))
                                    .astype(np.int32)).cuda()
                   for _ in range(2))
    layers, tol = 2, 1e-5
    runs = {}
    for name, policy, guard in (("none", None, False),
                                ("full", "full", False),
                                ("dots", "dots", False),
                                ("dots_no_batch", "dots_no_batch", False),
                                ("guard", None, True),
                                ("guard+full", "full", True)):
        cfg = _gpt125m(layers, dropout=RESILIENT_DROPOUT,
                       recompute=policy is not None,
                       recompute_policy=policy)
        model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
        step = _train_step(model, guard=guard or None)
        rng.seed(SEED)
        K.reset_launches()
        losses = step.run_steps(ids, labels, repeat=steps)
        torch.cuda.synchronize()
        runs[name] = (losses.cpu(), K.launch_counts(),
                      [p.detach().clone() for p in model.parameters()],
                      step.generator.get_state())
        if name != "none" and name != "dots":
            _train_replay_equals_eager(step, (ids, labels), steps,
                                       f"recompute_parity {name} f32 "
                                       f"dropout {RESILIENT_DROPOUT}")
        del model, step
        _release_card()
    base_l, base_c, base_p, base_g = runs["none"]
    check(torch.isfinite(base_l).all().item(),
          f"recompute_parity: non-finite losses {base_l.tolist()}")
    report = {}
    for name, (l, c, p, g) in runs.items():
        if name == "none":
            continue
        ref_l, ref_p = (runs["full"][0], runs["full"][2]) \
            if name == "guard+full" else (base_l, base_p)
        if name.startswith("guard"):
            check(torch.equal(l, ref_l) and all(
                torch.equal(a, b) for a, b in zip(p, ref_p)),
                f"recompute_parity: the fault-free {name} step differs "
                f"from the unguarded one: {l.tolist()} vs {ref_l.tolist()}")
            report[name] = "bit for bit"
            continue
        lgap = float((l - base_l).abs().max() / base_l.abs().max())
        pgap = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(p, base_p))
        check(lgap <= tol and pgap <= tol,
              f"recompute_parity {name}: losses {l.tolist()} vs "
              f"{base_l.tolist()} (gap {lgap:.3g}), parameters gap "
              f"{pgap:.3g} > {tol}")
        check(torch.equal(g, base_g), f"recompute_parity {name}: the "
              "replays advanced the dropout generator")
        check(c["flash_fwd"] == 2 * layers * steps
              and c["flash_bwd"] == layers * steps,
              f"recompute_parity {name}: launches {json.dumps(c)}")
        report[name] = (f"loss gap {lgap:.3g}, parameter gap {pgap:.3g}, "
                        f"bit for bit {torch.equal(l, base_l)}")
    check(base_c["flash_fwd"] == base_c["flash_bwd"] == layers * steps,
          f"recompute_parity none: launches {json.dumps(base_c)}")
    log(f"[recompute_parity] f32 GPT-125M widths {layers}L B2 S256 dropout "
        f"{RESILIENT_DROPOUT}, {steps} AdamW steps: losses "
        f"{base_l.tolist()}; against no recompute (tol {tol}): "
        f"{json.dumps(report)}; flash_fwd / flash_bwd launches "
        f"{runs['full'][1]['flash_fwd']} / {runs['full'][1]['flash_bwd']} "
        f"with recompute, {base_c['flash_fwd']} / {base_c['flash_bwd']} "
        "without")


def phase_train_resilient(card, iters=RESILIENT_STEPS):
    """GPT-125M as phase 8 trains it (12 layers, B8 x 1024, bf16 O2,
    AdamW, fused head + CE) with dropout 0.1, in the four combinations
    of recompute=True and guard=True, each timed as phase 8 (2 warm-up
    calls, `run_steps(repeat=iters)`): tokens/s, peak memory, flash
    launches a step (24 / 12 with recompute, 12 / 12 without).  On the
    step with both, and a `CheckpointManager` in a temporary directory:
    a NaN injected at one step (`faults.inject("train.step",
    kind="nan")`) is skipped (state bit-equal to before it) and the next
    loss equals a step from the pre-fault state with the generator where
    the fault left it; a checkpoint saved, 3 steps, `rollback()`: the
    state bit-equal to the save; `save_train_state`, 3 steps, then
    `load_train_state` into a freshly built step with the generator set
    back: its 3 losses equal the original's bit for bit.  Save and
    restore ms.  Returns the launch counts of the timed steps of the
    step with both."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.resilience import StepGuard, faults

    batch, seq = 8, 1024
    rs = np.random.RandomState(0)                 # bench.py:87
    data = tuple(torch.from_numpy(rs.randint(0, 50304, (batch, seq))
                                  .astype(np.int32)).cuda()
                 for _ in range(2))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def build(recompute, guard, seed=SEED):
        cfg = _gpt125m(12, dropout=RESILIENT_DROPOUT, recompute=recompute)
        model = GPTForCausalLM(cfg, device="cuda", seed=seed)
        g = StepGuard(name="chip_smoke") if guard else None
        return model, _train_step(
            model, amp_dtype="bfloat16", guard=g,
            checkpoint_manager=CheckpointManager(root) if guard else None)

    rates, step = {}, None
    try:
        for recompute, guard in ((False, False), (True, False),
                                 (False, True), (True, True)):
            _release_card()
            model, step = build(recompute, guard)
            warm, losses, dt, counts = _timed_steps(step, data, iters)
            peak = torch.cuda.max_memory_allocated()
            check(np.isfinite(warm).all() and np.isfinite(losses).all()
                  and losses[-1] < warm[0],
                  f"train_resilient recompute={recompute} guard={guard}: "
                  f"losses {warm} {losses.tolist()}")
            fwd = 24 if recompute else 12
            _launches_per_step(counts, {"flash_fwd": fwd, "flash_bwd": 12},
                               iters, f"train_resilient recompute="
                               f"{recompute} guard={guard}")
            rates[(recompute, guard)] = (batch * seq * iters / dt,
                                         1e3 * dt / iters, peak)
            if not (recompute and guard):
                del model, step
        n_params = sum(p.numel() for p in model.parameters())
        # a NaN at one step: skipped, the state kept
        guard = step.guard
        before = _state_clone(step)
        with faults.inject("train.step", kind="nan", at=1):
            bad = float(step(*data))
        gen_after = step.generator.get_state()
        diff = _state_equal(step, before)
        check(math.isnan(bad) and not diff and guard.total_bad == 1,
              f"train_resilient: the poisoned step gave {bad}, changed "
              f"{len(diff)} state tensors, guard {guard.state_dict()}")
        after = float(step(*data))
        with torch.no_grad():
            for t, s in zip(step.train_state_dict().values(), before):
                t.copy_(s)
        step.generator.set_state(gen_after)
        ref = float(step(*data))
        check(after == ref, f"train_resilient: the step after the skipped "
              f"one gave {after}, a step from the pre-fault state {ref}")
        del before
        # save, 3 steps, rollback
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = step.save_checkpoint()
        save_ms = 1e3 * (time.perf_counter() - t0)
        saved = _state_clone(step)
        step.run_steps(*data, repeat=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = step.rollback()
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        diff = _state_equal(step, saved)
        check(not diff, f"train_resilient: rollback to {path} left "
              f"{len(diff)} state tensors apart from the save")
        del saved
        # exact resume in a fresh step
        state_dir = os.path.join(root, "resume")
        step.save_train_state(state_dir)
        gen = step.generator.get_state()
        ahead = step.run_steps(*data, repeat=3).cpu()
        del model, step
        _release_card()
        model, fresh = build(True, True, seed=SEED + 1)
        t0 = time.perf_counter()
        fresh.load_train_state(state_dir)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        fresh.generator.set_state(gen)
        resumed = torch.stack([fresh(*data) for _ in range(3)]).cpu()
        check(torch.equal(ahead, resumed), f"train_resilient: resumed "
              f"losses {resumed.tolist()} vs the original's "
              f"{ahead.tolist()}")
        line = "; ".join(
            f"recompute={r} guard={g}: {tps:.1f} tokens/s, {ms:.2f} "
            f"ms/step, peak {peak / 2**30:.2f} GiB"
            for (r, g), (tps, ms, peak) in rates.items())
        log(f"[train_resilient] GPT-125M 12L bf16 O2 B{batch} S{seq} dropout "
            f"{RESILIENT_DROPOUT} ({card}), {iters} replayed steps each "
            f"(N={n_params}): {line}; flash_fwd / flash_bwd a step 24 / 12 "
            f"with recompute, 12 / 12 without; NaN at one step skipped "
            f"(state bit-equal, guard {guard.state_dict()}), next loss "
            f"{after:.6f} == {ref:.6f}; checkpoint save {save_ms:.0f} ms, "
            f"rollback {restore_ms:.0f} ms (checkpoint {restored}), "
            f"load_train_state {load_ms:.0f} ms; resumed losses "
            f"{resumed.tolist()} == the original's bit for bit")
        del model, fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def phase_train_1p3b_recompute(card, iters=5, seq=2048):
    """`gpt_1p3b(fused_head_ce=True, recompute=True)` (the configuration
    `tools/memory_report.py` sizes), bf16 O2, AdamW, at B8 x 2048 (B
    halved while a step does not fit), and the same model without
    recompute at the largest batch from 8 down that fits: tokens/s, ms
    per step, peak memory of each, timed as phase 8 over `iters`
    replayed steps.  Returns the recomputed run's launch counts."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b

    out = {}
    for recompute in (True, False):
        batch = 8
        while True:
            _release_card()
            model = step = None
            try:
                model = GPTForCausalLM(
                    gpt_1p3b(fused_head_ce=True, recompute=recompute),
                    device="cuda", seed=SEED)
                step = _train_step(model, amp_dtype="bfloat16")
                rs = np.random.RandomState(SEED)
                data = tuple(torch.from_numpy(rs.randint(
                    0, 50304, (batch, seq)).astype(np.int32)).cuda()
                    for _ in range(2))
                warm, losses, dt, counts = _timed_steps(step, data, iters)
                break
            except torch.cuda.OutOfMemoryError:
                del model, step
                log(f"[train_1p3b_recompute] recompute={recompute} B{batch} "
                    f"S{seq} does not fit on the card; halving the batch")
                batch //= 2
                check(batch >= 1, "train_1p3b_recompute: B1 does not fit")
        peak = torch.cuda.max_memory_allocated()
        check(np.isfinite(warm).all() and np.isfinite(losses).all(),
              f"train_1p3b_recompute: losses {warm} {losses.tolist()}")
        fwd = 2 * 24 if recompute else 24
        _launches_per_step(counts, {"flash_fwd": fwd, "flash_bwd": 24},
                           iters, f"train_1p3b_recompute recompute="
                           f"{recompute}")
        n_params = sum(p.numel() for p in model.parameters())
        out[recompute] = (batch, batch * seq * iters / dt, 1e3 * dt / iters,
                          peak, counts, n_params, losses[-1])
        del model, step
    _release_card()
    line = "; ".join(
        f"recompute={r}: B{b} S{seq}, {tps:.1f} tokens/s, {ms:.1f} ms/step, "
        f"MFU {100 * 6 * n * tps / PEAK_FLOPS['bfloat16']:.2f}%, peak "
        f"{peak / 2**30:.2f} GiB, last loss {last:.4f}"
        for r, (b, tps, ms, peak, _, n, last) in out.items())
    log(f"[train_1p3b_recompute] gpt_1p3b fused head + CE bf16 O2 AdamW "
        f"({card}), {iters} replayed steps (N={out[True][5]}): {line}; "
        f"flash_fwd a step {out[True][4]['flash_fwd'] / iters:.0f} with "
        f"recompute, {out[False][4]['flash_fwd'] / iters:.0f} without")
    return out[True][4]


def phase_train_llama_recompute(card, iters=5, seq=2048):
    """LLaMA at `llama_7b` widths with 2 layers, B1 x 2048, bf16 O2,
    AdamW, `recompute_policy="dots_no_batch"` against the same step
    without recompute from the same weights and batch: the losses of 2
    warm-up calls and `iters` replayed steps (within 1e-3 relative;
    bit for bit is logged), launches a step: flash_fwd and rope twice a
    layer with recompute (the forward and the replay), flash_bwd and
    rope_bwd once.  Returns the recomputed run's launch counts."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    out = {}
    for recompute in (True, False):
        _release_card()
        cfg = llama_7b(num_layers=2, recompute=recompute,
                       recompute_policy="dots_no_batch" if recompute
                       else None)
        model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
        step = _train_step(model, amp_dtype="bfloat16")
        rs = np.random.RandomState(SEED)
        data = tuple(torch.from_numpy(rs.randint(
            0, cfg.vocab_size, (1, seq)).astype(np.int32)).cuda()
            for _ in range(2))
        warm, losses, dt, counts = _timed_steps(step, data, iters)
        per = 2 if recompute else 1
        _launches_per_step(counts, {"flash_fwd": per * 2, "rope": per * 2,
                                    "flash_bwd": 2, "rope_bwd": 2}, iters,
                           f"train_llama_recompute recompute={recompute}")
        out[recompute] = (np.array(warm + losses.tolist()), counts,
                          seq * iters / dt,
                          torch.cuda.max_memory_allocated())
        del model, step
    _release_card()
    (lr, cr, tr, pr), (ln, _, tn, pn) = out[True], out[False]
    check(np.isfinite(lr).all() and np.isfinite(ln).all(),
          f"train_llama_recompute: losses {lr} {ln}")
    gap = float(np.abs(lr - ln).max() / np.abs(ln).max())
    check(gap <= 1e-3, f"train_llama_recompute: losses with recompute "
          f"{lr.tolist()} vs without {ln.tolist()} (gap {gap:.3g})")
    log(f"[train_llama_recompute] llama_7b widths 2L B1 S{seq} bf16 O2 "
        f"AdamW ({card}): dots_no_batch losses {lr.tolist()}, without "
        f"recompute {ln.tolist()} (gap {gap:.3g}, bit for bit "
        f"{bool(np.array_equal(lr, ln))}); {tr:.1f} / {tn:.1f} tokens/s, "
        f"peak {pr / 2**30:.2f} / {pn / 2**30:.2f} GiB; launches a step "
        f"with recompute {json.dumps({k: v / iters for k, v in cr.items() if v})}")
    return cr


def _profile_forward(model, x, what, steps=3):
    """torch.profiler over `steps` forwards (inside inference mode)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    _log_profile(prof, what, wall_ms, steps)


# ------------------------------------------------- optional: --profile
def phase_profile_train(step, batch, steps=3, what="train step"):
    """torch.profiler over `steps` train steps on `batch` (the step's
    leaves): device busy share and the device rows that hold the
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step.run_steps(*batch, repeat=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    _log_profile(prof, what, wall_ms, steps)


def _log_profile(prof, what, wall_ms, steps):
    import torch

    rows = prof.key_averages()
    # device rows are the kernels and copies themselves (an aten op's
    # row would count its kernels a second time)
    kernels = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev(e):
        return e.self_device_time_total / 1e3

    busy = sum(dev(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"[profile] {steps} x {what}: wall {wall_ms / steps:.2f} ms/step, "
        f"device busy {busy / steps:.3f} ms/step "
        f"({100 * busy / wall_ms:.1f}% busy), {launches / steps:.0f} device"
        f" ops/step")
    # the host's launch calls: kernels one by one, or graphs
    api = {}
    for e in rows:
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch"):
            api[e.key] = (e.count / steps,
                          e.self_cpu_time_total / 1e3 / steps)
    log("[profile] host launch calls a step: " + (", ".join(
        f"{k} {n:.0f} ({ms:.3f} ms)" for k, (n, ms) in sorted(api.items()))
        or "none recorded"))
    # device time by kind: the window kernels, the port's other kernels,
    # cuBLAS GEMMs and cuDNN convs, the optimizer's foreach kernels,
    # norms / activations / reductions, copies and casts, the rest
    kinds = {"window fwd": 0.0, "window bwd": 0.0, "port kernels": 0.0,
             "gemm/conv": 0.0, "optimizer": 0.0, "norm/act/reduce": 0.0,
             "copy/cast": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        kind = ("window bwd" if "window_attention_bwd" in name
                else "window fwd" if "window_attention_kernel" in name
                or "window_attention_tc" in name
                else "port kernels" if "flash_" in name or "_attention_kernel"
                in name or "_attention_int8" in name
                or "relayout_kernel" in name or "rope_" in name
                or "conv_dense" in name or "conv_depthwise" in name
                or "fused_norm" in name
                else "gemm/conv" if "nvjet" in name or "gemm" in name
                or "conv" in name or "cudnn" in name or "sm90" in name
                else "optimizer" if "multi_tensor" in name
                or "foreach" in name
                else "norm/act/reduce" if "reduce" in name or "norm" in name
                or "gelu" in name or "softmax" in name
                else "copy/cast" if "copy" in name else "other")
        kinds[kind] += dev(e) / steps
    log("[profile] device by kind (ms/step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in kinds.items()))
    for e in sorted(kernels, key=dev, reverse=True)[:12]:
        log(f"[profile] device {dev(e) / steps:8.3f} ms/step  "
            f"x{e.count // steps:<5d} {e.key[:90]}")
    for e in sorted(rows, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"[profile] host   {e.self_cpu_time_total / 1e3 / steps:8.3f} "
            f"ms/step  x{e.count // steps:<5d} {e.key[:90]}")


def phase_profile(model, cfg, steps=10, kv_precision=None):
    """torch.profiler over `steps` steady decode steps of the engine (4
    slots busy; `kv_precision` its KV tier), each a replay of the
    captured decode program: device busy share and the ops that hold
    the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    eng = InferenceEngine(model, EngineConfig(kv_precision=kv_precision))
    for p in _prompts(cfg.vocab_size)[1:5]:
        eng.submit(p, max_new_tokens=steps + 8)
    for _ in range(3):            # prefills, then two decode steps
        eng.step()
    # each step's host lengths, for the paged kernel's bound (the
    # replayed forwards call no wrapper whose inputs could be kept)
    calls, run = [], eng._run_decode

    def rec(n, tok, pt, lengths):
        calls.append((n, lengths.copy()))
        return run(n, tok, pt, lengths)

    eng._run_decode = rec
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    _log_profile(prof, f"engine decode step (4 slots, kv "
                 f"{kv_precision or 'full'})", wall_ms, steps)
    # the paged kernel of the step's tier: device time a launch beside
    # its bound (each live key's K and V rows once, int8 codes and f32
    # scales in the int8 tier; q, out and the table once), its launches
    # and its share of the step's device time
    name = ("paged_attention_int8_kernel" if kv_precision == "int8"
            else "paged_attention_kernel")
    b, hq, hkv = eng.config.max_slots, cfg.num_heads, eng._hkv
    d, item = eng._hd, torch.empty((), dtype=eng._dtype).element_size()
    row = 2 * d + 8 if kv_precision == "int8" else 2 * d * item
    forwards = [lengths + j for n, lengths in calls for j in range(n)]
    nbytes = sum(int((pos + 1).sum()) * hkv * row + 2 * b * hq * d * item
                 + b * eng.max_pages_per_seq * 4 + 4 * b
                 for pos in forwards)
    bms, _ = bound_ms(nbytes / max(len(forwards), 1), 0, "bfloat16")
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [e for e in dev if name in e.key]
    ms = sum(e.self_device_time_total for e in rows) / 1e3
    n = sum(e.count for e in rows)
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    check(n > 0, f"profile: no {name} launch in the decode steps")
    log(f"[profile] {name}: device {ms / n:.4f} ms a launch (bound "
        f"{bms:.5f} ms, bytes), {n / steps:.0f} launches a step, "
        f"{ms / steps:.3f} of {busy / steps:.3f} ms of device time a step "
        f"({100 * ms / busy:.1f}%); the step {100 * busy / wall_ms:.1f}% "
        "busy")
    # the rope kernel of a rope model: its launches and device time a step
    rope = [e for e in dev if "rope_" in e.key]
    if rope:
        rms = sum(e.self_device_time_total for e in rope) / 1e3
        rn = sum(e.count for e in rope)
        log(f"[profile] rope: device {rms / rn:.4f} ms a launch, "
            f"{rn / steps:.0f} launches a step, {rms / steps:.3f} ms of "
            "device time a step")


def _profile_cold_prefill(model, cfg, n_tokens, steps=3):
    """torch.profiler over `steps` cold prefills of one `n_tokens` prompt
    (`generate([prompt], max_new_tokens=1)` on a fresh engine, the
    prefix cache cleared between them; the bucket warmed up first):
    wall, device busy share, host launch calls.  Returns the mean wall
    ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    prompt = np.random.RandomState(SEED + 8).randint(
        0, cfg.vocab_size, (n_tokens,)).astype(np.int32)
    eng = InferenceEngine(model, EngineConfig())
    eng.generate([prompt], max_new_tokens=1)
    eng.clear_prefix_cache()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            eng.generate([prompt], max_new_tokens=1)
            eng.clear_prefix_cache()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    _log_profile(prof, f"engine cold prefill S{eng._bucket(n_tokens)} "
                 f"({n_tokens} tokens, one request)", wall_ms, steps)
    return wall_ms / steps


def phase_profile_prefill(model, cfg):
    """`_profile_cold_prefill` at the 1008-token bucket and the 48-token
    one."""
    for n in (1000, 37):
        _profile_cold_prefill(model, cfg, n)


# ----------------------------------------------------------------- main
# ------------------------------------------- phases 4b, 9b, 22: serving
def _load_loadgen():
    """`tools/loadgen.py`, loaded by its path (it imports nothing of the
    repo: it drives a server from outside, as traffic does)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "loadgen", os.path.join(HERE, "tools", "loadgen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pct(vals, q):
    """The q-quantile of `vals`, linearly interpolated."""
    v = sorted(vals)
    pos = q * (len(v) - 1)
    i = int(pos)
    return v[i] if i + 1 >= len(v) else v[i] + (pos - i) * (v[i + 1] - v[i])


def _stream_round(prompts, new_tokens, start):
    """`prompts` streamed at once, one thread each: `start(i, on_token)`
    submits request i and blocks until it is done, returning (streamed
    tokens, output ids, finish reason).  Per request: the time to its
    first token and the gaps between tokens, from the moment its thread
    submits.  Returns the per-request results and the round's wall."""
    res = [None] * len(prompts)
    errors = []

    def one(i):
        times = []
        try:
            t0 = time.perf_counter()
            toks, out, reason = start(
                i, lambda tok: times.append(time.perf_counter()))
            res[i] = dict(tokens=toks, out=out, reason=reason,
                          ttft=times[0] - t0 if times else None,
                          gaps=list(np.diff(times)))
        except Exception as e:      # reported by the caller's check
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and all(r is not None for r in res),
          f"a stream failed: {errors}")
    return res, wall


def _inprocess_round(eng, prompts, new_tokens=32):
    """The requests through `engine.submit` in this process (the engine's
    loop thread running): tokens as the handle streams them."""
    def start(i, on_token):
        h = eng.submit(prompts[i], max_new_tokens=new_tokens)
        toks = []
        for tok in h.stream(timeout=600):
            on_token(tok)
            toks.append(int(tok))
        return toks, h.result(timeout=600), h.finish_reason

    return _stream_round(prompts, new_tokens, start)


def _http_round(address, prompts, new_tokens=32):
    """The same requests as concurrent `InferenceClient.generate`
    streams over HTTP (`on_token` per streamed token)."""
    from paddle_tpu_torch.inference.serving import InferenceClient

    def start(i, on_token):
        toks = []

        def got(tok):
            on_token(tok)
            toks.append(int(tok))

        r = InferenceClient(address, timeout=600).generate(
            prompts[i], max_new_tokens=new_tokens, on_token=got)
        return toks, r["output_ids"], r["finish_reason"]

    return _stream_round(prompts, new_tokens, start)


def _round_stats(res, wall):
    ttft = [1e3 * r["ttft"] for r in res]
    gaps = [1e3 * g for r in res for g in r["gaps"]]
    toks = sum(len(r["tokens"]) for r in res)
    return (f"TTFT p50 {_pct(ttft, 0.5):.1f} p95 {_pct(ttft, 0.95):.1f} ms, "
            f"inter-token gap p50 {_pct(gaps, 0.5):.2f} p99 "
            f"{_pct(gaps, 0.99):.2f} ms, {toks / wall:.1f} tokens/s "
            f"({toks} tokens in {wall:.3f}s)")


def _count_engine_steps(eng):
    """Counts of the engine's prefills and decode steps from now on (the
    loop thread looks both up on the instance), and a restore."""
    n = {"prefill": 0, "decode": 0}
    prefill, decode = eng._prefill, eng._decode

    def counted_prefill(seq):
        n["prefill"] += 1
        prefill(seq)

    def counted_decode(running):
        n["decode"] += 1
        decode(running)

    eng._prefill, eng._decode = counted_prefill, counted_decode

    def restore():
        eng._prefill, eng._decode = prefill, decode
    return n, restore


def _check_path_launches(counts, n, cfg, what):
    """Every prefill launches flash_fwd once per layer, every decode step
    (decode_chunk 1) the exact tier's paged kernel once per layer, rope
    (where the model has it) once per layer of each forward."""
    check(counts["flash_fwd"] == cfg.num_layers * n["prefill"],
          f"{what}: flash_fwd launched {counts['flash_fwd']} times for "
          f"{n['prefill']} prefills")
    check(counts["paged_attention"] == cfg.num_layers * n["decode"],
          f"{what}: paged_attention launched {counts['paged_attention']} "
          f"times in {n['decode']} decode steps")
    check(counts["paged_attention_int8"] == 0,
          f"{what}: the int8 kernel launched on the exact tier")
    _rope_launches_per_forward(counts, cfg, n["prefill"] + n["decode"], what)


def _drained(eng, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st, pages = eng.stats(), eng.pool.stats()
        if st["running"] == 0 and st["waiting"] == 0 \
                and pages["logical_pages"] == pages["used"]:
            return True
        time.sleep(0.02)
    return False


def phase_http_serve(model, cfg, name, traffic=True):
    """`POST /generate` over HTTP through `InferenceServer` and the
    engine: (a) with the prefix cache off, the 8 requests of phase 4 x
    32 tokens in the process and then as 8 concurrent HTTP streams, bit
    for bit; (b) with the default config, the same requests in the
    process and over HTTP, twice in turns after a round that captures
    the prefill programs: TTFT, inter-token gap and tokens/s at the
    client; with `traffic`, (c) an open-loop Poisson schedule from
    `tools/loadgen.py` and (d) the plane's contracts.  Returns the
    launches of the driven parts."""
    import torch

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.inference.serving import InferenceServer
    from paddle_tpu_torch.ops import kernels as K

    prompts = _prompts(cfg.vocab_size)
    total = {k: 0 for k in K.KERNELS}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    obs.attach(crash_hook=False)
    try:
        # (a) exactness, prefix cache off
        eng = InferenceEngine(model, EngineConfig(prefix_cache=False))
        eng.generate([prompts[1][:16]], max_new_tokens=2)
        srv = InferenceServer(engine=eng, request_timeout=600.0).start()
        try:
            n, restore = _count_engine_steps(eng)
            K.reset_launches()
            local, _ = _inprocess_round(eng, prompts)
            http, _ = _http_round(srv.address, prompts)
            counts = K.launch_counts()
            restore()
        finally:
            srv.shutdown()
        add(counts)
        _check_path_launches(counts, n, cfg, f"http_serve {name} (a)")
        for i, (p, a, b) in enumerate(zip(prompts, local, http)):
            check(b["tokens"] == a["tokens"]
                  and np.array_equal(b["out"], a["out"]),
                  f"http_serve {name}: request {i}'s HTTP stream differs "
                  f"from its in-process tokens")
            check(b["tokens"] == [int(t) for t in b["out"][len(p):]]
                  and len(b["tokens"]) == 32 and b["reason"] == "length",
                  f"http_serve {name}: request {i}'s stream does not equal "
                  f"its final record ({b['reason']})")
        log(f"[http_serve] {name} (a) prefix cache off: 8 HTTP streams x 32 "
            f"tokens equal the in-process tokens bit for bit "
            f"({n['prefill']} prefills, {n['decode']} decode steps)")
        del eng, srv
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the plane's cost, default config
        eng = InferenceEngine(model, EngineConfig())
        eng.generate([prompts[1][:16]], max_new_tokens=2)
        srv = InferenceServer(engine=eng, request_timeout=600.0).start()
        try:
            eng.clear_prefix_cache()
            _inprocess_round(eng, prompts)        # captures the buckets
            n, restore = _count_engine_steps(eng)
            K.reset_launches()
            for turn in range(2):
                for how in ("in-process", "HTTP"):
                    eng.clear_prefix_cache()
                    res, wall = (_inprocess_round(eng, prompts)
                                 if how == "in-process"
                                 else _http_round(srv.address, prompts))
                    check(all(len(r["tokens"]) == 32 for r in res),
                          f"http_serve {name} (b): a stream fell short")
                    log(f"[http_serve] {name} (b) turn {turn + 1} {how}: "
                        f"{_round_stats(res, wall)}")
            counts = K.launch_counts()
            restore()
            add(counts)
            _check_path_launches(counts, n, cfg, f"http_serve {name} (b)")
            if traffic:
                add(_open_loop(srv, eng, cfg, name))
                _plane_contracts(srv, eng, name)
        finally:
            srv.shutdown()
        if traffic:
            _saturation_and_disconnect(eng, prompts, name)
            check(_drained(eng), f"http_serve {name}: the engine is not "
                  f"drained at the end: {eng.stats()}")
            eng.clear_prefix_cache()
            check(eng.pool.used_pages == 0, f"http_serve {name}: "
                  f"{eng.pool.used_pages} pages in use after the cache "
                  "was cleared")
            log(f"[http_serve] {name} (d) drained: no running or waiting "
                "sequence, every page free but the prefix cache's")
    finally:
        obs.detach()
    return total


def _open_loop(srv, eng, cfg, name):
    """(c) `tools/loadgen.py`'s open-loop Poisson schedule at the server:
    4 tenants sharing 512-token system prompts, suffixes of 16-488
    tokens, every request a 32-token stream, 4 a second for 10 s."""
    from paddle_tpu_torch.ops import kernels as K

    lg = _load_loadgen()
    wl = lg.SharedPrefixWorkload(
        seed=0, tenants=4, system_prompt_tokens=512, suffix_tokens=(16, 488),
        vocab=cfg.vocab_size, generate_frac=1.0, max_new_tokens=32)
    runner = lg.OpenLoopRunner(srv.address, wl,
                               phases=[lg.Phase("steady", 10.0, 4.0)],
                               timeout=120.0)
    K.reset_launches()
    report = runner.run()
    counts = K.launch_counts()
    s = report.summary()
    check(s["admitted_failures"] == 0, f"http_serve {name} (c): admitted "
          f"failures {s['failure_detail']}")
    short = [r for r in report.rows
             if r["status"] == "ok" and r.get("tokens") != 32]
    check(not short and s["ok"] > 0, f"http_serve {name} (c): {len(short)} "
          f"ok streams without 32 tokens, {s['ok']} ok")
    counts_line = {k: s[k] for k in (
        "requests", "status", "ok", "shed", "admitted_failures", "tokens",
        "tokens_per_sec", "wall_s")}
    log(f"[http_serve] {name} (c) open loop 4 req/s x 10 s: "
        f"{json.dumps(counts_line)}"
        f"; latency_ms {json.dumps(s['latency_ms'])}; itl_ms "
        f"{json.dumps(s['itl_ms'])}; tpot_ms {json.dumps(s['tpot_ms'])}; "
        f"prefix hit rate {eng.prefix_cache_stats().get('hit_rate')}")
    return counts


def _get_json(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _plane_contracts(srv, eng, name):
    """(d) on the idle server: /health and /ready carry the engine's
    stats, /metrics renders, polling /metrics and /ready alone launches
    no kernel, and the lifecycle record names the captured programs with
    their warm-up and capture ms."""
    import urllib.request

    from paddle_tpu_torch.ops import kernels as K

    check(_drained(eng), f"http_serve {name}: not idle before (d)")
    code, health = _get_json(srv.address + "/health")
    check(code == 200 and health["engine"]["max_slots"] == 4
          and "pages" in health["engine"], f"/health: {code} {health}")
    code, ready = _get_json(srv.address + "/ready")
    check(code == 200 and ready["engine"]["max_slots"] == 4
          and ready["engine"]["prefix_cache"]["enabled"]
          and ready["engine"]["kv_precision"] == "full",
          f"/ready: {code} {ready}")
    K.reset_launches()
    for _ in range(20):
        with urllib.request.urlopen(srv.address + "/metrics",
                                    timeout=60) as r:
            text = r.read().decode()
        _get_json(srv.address + "/ready")
    moved = {k: v for k, v in K.launch_counts().items() if v}
    check(not moved, f"polling /metrics and /ready launched {moved}")
    check("serving_requests" in text and "engine_tokens" in text,
          "/metrics lacks the serving and engine series")
    code, snap = _get_json(srv.address + "/debug/telemetry")
    comp = snap["lifecycle"]["compiles"]
    check(code == 200 and "decode_n1" in comp
          and any(k.startswith("prefill_s") for k in comp)
          and any(k.startswith("cprefill_s") for k in comp)
          and all(c["lower_ms"] > 0 and c["compile_ms"] > 0
                  for c in comp.values()),
          f"the lifecycle record's captured programs: {comp}")
    shown = {k: (round(c["lower_ms"], 1), round(c["compile_ms"], 1))
             for k, c in sorted(comp.items())}
    log(f"[http_serve] {name} (d) /health, /ready and /metrics render; 20 "
        f"polls of /metrics + /ready launched no kernel; lifecycle compiles "
        f"(warm-up ms, capture ms): {json.dumps(shown)}")


def _saturation_and_disconnect(eng, prompts, name):
    """(d) a queue_depth=0 server with its 4 slots streaming sheds the
    next request with 429 and Retry-After; a client that disconnects
    mid-stream gets its sequence cancelled."""
    import socket
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.inference.serving import (
        InferenceClient, InferenceServer,
    )

    srv = InferenceServer(engine=eng, request_timeout=600.0,
                          queue_depth=0).start()
    cancelled, cancel = [], eng.cancel
    eng.cancel = lambda rid: cancelled.append(rid) or cancel(rid)
    try:
        done = []
        threads = [threading.Thread(target=lambda p=p: done.append(
            InferenceClient(srv.address, timeout=600).generate(
                p[:64], max_new_tokens=512)), daemon=True)
            for p in prompts[:4]]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while srv.gen_admission.stats()["inflight"] < 4:
            check(time.monotonic() < deadline, "the 4 streams never ran")
            time.sleep(0.005)
        req = urllib.request.Request(
            srv.address + "/generate", headers={
                "Content-Type": "application/json"},
            data=json.dumps({"input_ids": [1, 2, 3],
                             "max_new_tokens": 4}).encode())
        try:
            urllib.request.urlopen(req, timeout=60)
            shed = None
        except urllib.error.HTTPError as e:
            shed = (e.code, e.headers.get("Retry-After"))
        check(shed is not None and shed[0] == 429 and shed[1] is not None,
              f"saturated queue_depth=0 server answered {shed}")
        for t in threads:
            t.join(timeout=600)
        check(len(done) == 4 and all(len(r["tokens"]) == 512 for r in done),
              "the saturating streams did not finish")
        host, port = srv.address[len("http://"):].split(":")
        body = json.dumps({"input_ids": [int(x) for x in prompts[2][:64]],
                           "max_new_tokens": 1024}).encode()
        with socket.create_connection((host, int(port)), timeout=60) as s:
            s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            got = b""
            while b'{"token"' not in got:
                chunk = s.recv(4096)
                check(chunk, "the stream closed before its first token")
                got += chunk
        deadline = time.monotonic() + 60
        while not cancelled:
            check(time.monotonic() < deadline, "a client that disconnected "
                  "mid-stream was never cancelled")
            time.sleep(0.01)
        check(_drained(eng), f"after the disconnect: {eng.stats()}")
        log(f"[http_serve] {name} (d) 5th request on a saturated "
            f"queue_depth=0 server: {shed[0]} Retry-After {shed[1]}; a "
            "client that disconnected mid-stream was cancelled and its "
            "slot and pages freed")
    finally:
        eng.cancel = cancel
        srv.shutdown()


class _PausedStreams:
    """Wraps a router's transport: the next streamed response pauses
    after its third line until `release`, with `paused` set, so a
    replica can be killed or drained with a stream in flight."""

    def __init__(self, router):
        self.router, self.real = router, router.transport.stream
        self.armed, self.paused = threading.Event(), threading.Event()
        self.release, self.address = threading.Event(), None
        router.transport.stream = self.stream

    def stream(self, address, path, body, headers=None, timeout=30.0):
        resp = self.real(address, path, body, headers=headers,
                         timeout=timeout)
        if not self.armed.is_set():
            return resp
        self.armed.clear()
        self.address, lines = address, resp.lines

        def paused_lines():
            for i, line in enumerate(lines()):
                yield line
                if i == 2:
                    self.paused.set()
                    self.release.wait(timeout=120)

        resp.lines = paused_lines
        return resp

    def arm(self):
        self.paused.clear()
        self.release.clear()
        self.armed.set()

    def restore(self):
        self.release.set()
        self.router.transport.stream = self.real


def phase_fleet():
    """A `ReplicaFleet` of two `gpt` replicas (the fleet's seeded small
    GPT, `_build_gpt_engine`) on the card behind the port's `Router`:
    each replica announces after its warm-up captured its programs (its
    lifecycle record names them), the router's streams equal an
    in-process engine's tokens, a replica killed mid-stream holds the
    failover contract (the stream an exact prefix of the true sequence,
    completed or resumable), the monitor relaunches it, and a drained
    replica finishes its in-flight stream and exits 0.  Returns the
    launches the replicas report for the routed round: each resets its
    counters when it announces and serves them, beside its prefill and
    decode-step counts, on /debug/telemetry."""
    import torch

    from paddle_tpu_torch.inference import fleet as FL
    from paddle_tpu_torch.inference.serving import (
        InferenceClient, StreamInterrupted,
    )
    from paddle_tpu_torch.ops import kernels as K

    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 12, 23, 30)]
    long_prompt, long_new = prompts[0], 88            # 93 of 96 positions
    # the reference tokens only: its launches are not the fleet's
    ref = FL._build_gpt_engine(seed=0)
    want = [ref.generate([p], max_new_tokens=48)[0] for p in prompts]
    true = ref.generate([long_prompt], max_new_tokens=long_new)[0][
        len(long_prompt):].tolist()
    mcfg, chunk = ref._model.cfg, ref.config.decode_chunk
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = FL.ReplicaFleet(num_replicas=2, kind="gpt", launch_timeout=300)
    fleet.start(ready_timeout=300)
    paused = _PausedStreams(fleet.router)
    try:
        log(f"[fleet] 2 gpt replicas on the card routable in "
            f"{time.perf_counter() - t0:.1f}s")
        for rec in fleet.lifecycle.fleet_view()["records"]:
            rep = rec.get("replica") or {}
            comp, ph = rep.get("compiles", {}), rep.get("phases", {})
            check({"decode_n2", "prefill_s16"} <= set(comp)
                  and all(c["compile_ms"] > 0 for c in comp.values())
                  and ph["warmup"]["mono_ms"] <= ph["announce"]["mono_ms"],
                  f"replica {rec['rid']}: lifecycle {rep}")
        def replica_kernels():
            out = {}
            for h in list(fleet._handles.values()):
                code, snap = _get_json(h.address + "/debug/telemetry")
                check(code == 200 and "kernels" in snap,
                      f"replica {h.rid}: /debug/telemetry {code}")
                out[h.rid] = snap["kernels"]
            return out

        before = replica_kernels()
        check(all(r["prefills"] == r["decode_steps"] == 0
                  and not any(r["launches"].values())
                  for r in before.values()),
              f"fleet: the replicas launched before the routed round: "
              f"{before}")
        cli = InferenceClient(fleet.router.address, timeout=300, retries=2)
        outs, _ = _stream_round(prompts, 48, lambda i, cb: (
            lambda r: (r["tokens"], r["output_ids"], r["finish_reason"]))(
                cli.generate(prompts[i], max_new_tokens=48, on_token=cb)))
        for i, (r, w) in enumerate(zip(outs, want)):
            check(np.array_equal(r["out"], w), f"fleet: request {i} through "
                  "the router differs from the in-process engine's tokens")
        after = replica_kernels()
        counts = {k: 0 for k in K.KERNELS}
        for rid, r in sorted(after.items()):
            check(r["decode_chunk"] == chunk, f"replica {rid}: decode_chunk "
                  f"{r['decode_chunk']}")
            _check_path_launches(
                r["launches"], {"prefill": r["prefills"],
                                "decode": r["decode_steps"] * chunk},
                mcfg, f"fleet replica {rid}")
            for k, v in r["launches"].items():
                counts[k] += v
            log(f"[fleet] replica {rid}: {r['prefills']} prefills, "
                f"{r['decode_steps']} decode steps of {chunk}: "
                f"flash_fwd {r['launches']['flash_fwd']}, paged_attention "
                f"{r['launches']['paged_attention']}")
        check(sum(r["prefills"] for r in after.values()) == len(prompts),
              f"fleet: {len(prompts)} routed requests, prefills {after}")

        def stream(out, got):
            try:
                out["r"] = cli.generate(long_prompt, max_new_tokens=long_new,
                                        on_token=got.append)
            except StreamInterrupted as e:
                out["e"] = e

        # kill the serving replica with 3 tokens through the router
        out, got = {}, []
        paused.arm()
        th = threading.Thread(target=stream, args=(out, got), daemon=True)
        th.start()
        check(paused.paused.wait(timeout=120), "the stream never started")
        victim = next(h for h in list(fleet._handles.values())
                      if h.address == paused.address)
        proc = victim.proc
        fleet.kill_replica(victim.rank)
        t1 = time.perf_counter()
        proc.wait(timeout=60)
        paused.release.set()
        th.join(timeout=300)
        check(not th.is_alive(), "the killed stream hung")
        if "r" in out:
            check(out["r"]["tokens"] == true and out["r"]["resumed"] >= 1,
                  f"fleet: the failed-over stream {out['r']['tokens']} "
                  f"(resumed {out['r']['resumed']}) is not the true one")
            how = f"completed on the survivor (resumed {out['r']['resumed']})"
        else:
            e = out["e"]
            check(e.tokens == true[:len(e.tokens)]
                  and list(e.output_ids) == long_prompt.tolist() + e.tokens,
                  "fleet: the interrupted stream is not an exact prefix")
            rest = cli.generate(e.output_ids,
                                max_new_tokens=long_new - len(e.tokens))
            check(e.tokens + rest["tokens"] == true,
                  "fleet: the resumed stream is not the true sequence")
            how = (f"interrupted after {len(e.tokens)} tokens, resumed "
                   "through StreamInterrupted's output_ids")
        check(got == true[:len(got)], "fleet: delivered tokens are not a "
              "prefix of the true sequence")
        log(f"[fleet] replica r{victim.rank} killed mid-stream: {how}; "
            f"{len(got)} tokens delivered, an exact prefix")
        deadline = time.monotonic() + 300
        while not any(ev["kind"] == "replica_relaunched"
                      for ev in fleet.events):
            check(time.monotonic() < deadline, f"fleet: the killed replica "
                  f"was not relaunched: {fleet.describe()}")
            time.sleep(0.05)
        check(fleet.wait_ready(n=2, timeout=300), f"fleet: the relaunched "
              f"replica is not routable: {fleet.describe()}")
        log(f"[fleet] the monitor relaunched r{victim.rank}: routable again "
            f"{time.perf_counter() - t1:.1f}s after the kill")

        # drain the serving replica with a stream in flight
        out, got = {}, []
        paused.arm()
        th = threading.Thread(target=stream, args=(out, got), daemon=True)
        th.start()
        check(paused.paused.wait(timeout=120), "the stream never started")
        busy = next(h for h in list(fleet._handles.values())
                    if h.address == paused.address)
        drain = threading.Thread(target=fleet.drain_replica,
                                 args=(busy.rank,), kwargs={"grace": 120.0},
                                 daemon=True)
        drain.start()
        deadline = time.monotonic() + 30
        while fleet.router.replica_summary().get(busy.rid) != "draining":
            check(time.monotonic() < deadline, "the drain never began")
            time.sleep(0.01)
        paused.release.set()
        th.join(timeout=300)
        drain.join(timeout=300)
        check(out.get("r") is not None and out["r"]["tokens"] == true,
              f"fleet: the drained replica's in-flight stream {out}")
        deadline = time.monotonic() + 120
        while not any(ev["kind"] == "replica_exit" and ev.get("drained")
                      for ev in fleet.events):
            check(time.monotonic() < deadline, "the drained replica never "
                  "exited")
            time.sleep(0.05)
        rc = [ev["rc"] for ev in fleet.events
              if ev["kind"] == "replica_exit" and ev.get("drained")]
        check(rc == [0], f"fleet: the drained replica exited {rc}")
        log(f"[fleet] r{busy.rank} drained with a stream in flight: the "
            f"stream finished ({len(true)} tokens), the replica exited 0")
        for rec in fleet.lifecycle.fleet_view()["records"]:
            sup = rec.get("supervisor_ms", {})
            phases = {k: round(v, 1) for k, v in (
                rec.get("replica") or {}).get("durations_ms", {}).items()}
            log(f"[fleet] lifecycle {rec['rid']}: spawn -> announce "
                f"{sup.get('announce', float('nan')):.1f} ms -> first probe "
                f"up {sup.get('first_probe_up', float('nan')):.1f} ms -> "
                f"first routable request "
                f"{sup.get('first_routable_request', float('nan')):.1f} ms; "
                f"replica phases {json.dumps(phases)}")
    finally:
        paused.restore()
        fleet.stop()
    return counts


# ------------------------------------------------------- phases 27 - 29
EAGER_STEPS = 20         # the bf16 eager loop (phase 27)
STATIC_STEPS = 10        # its to_static run
FP16_STEPS = 20          # phase 28
FP16_OVERFLOW_STEP = 7   # the step whose loss is multiplied by inf
ZOO_STEPS = 5            # phase 29: replayed steps of each rule


def _gpt125m_batch(cfg, batch, seq):
    """Phase 8's batch (bench.py:87's seed)."""
    import torch

    rs = np.random.RandomState(0)
    return tuple(torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).cuda()
        for _ in range(2))


def _eager_loop(model, opt, crit, batch, steps, cast):
    """`steps` iterations of ``loss.backward(); opt.step();
    opt.clear_grad()`` under ``amp.auto_cast(**cast)``.  Returns (the
    losses, the seconds of the steps after the first, the launch counts
    of those steps)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels as K

    ids, labels = batch
    losses, t0 = [], None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
        with amp.auto_cast(**cast):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return torch.stack(losses).float().cpu().numpy(), dt, K.launch_counts()


def _o2_model(cfg, lr):
    """GPT at `cfg`, seeded, with AdamW(lr, multi_precision, clip 1.0)
    under `amp.decorate` O2 bf16, in training mode."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model.train(), opt


def phase_train_eager_amp(card, batch=8, seq=1024, lr=1e-4):
    """27. GPT-125M in the eager loop under bf16 O2: `amp.decorate`,
    AdamW(multi_precision) with ClipGradByGlobalNorm(1.0),
    `auto_cast`, ``loss.backward(); opt.step(); opt.clear_grad()``;
    then the same loop from the same weights through
    `jit.to_static(model)` in training (its losses bit for bit the
    eager loop's), and phase 8's graphed step from the same weights (the
    bf16 casts `decorate` gives the eager loop, from which its masters
    start) with the same clip: its first 3 losses within BF16_TOL,
    relative, of the eager loop's.  Tokens/s and peak memory of the three; flash
    launches a step.  Returns the eager loop's launch counts."""
    import torch

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW

    cfg = _gpt125m(12)
    ids, labels = _gpt125m_batch(cfg, batch, seq)
    cast = dict(level="O2", dtype="bfloat16")
    rows = {}
    _release_card()
    model, opt = _o2_model(cfg, lr)
    crit = GPTPretrainingCriterion(model=model)
    eager, dt, counts = _eager_loop(model, opt, crit, (ids, labels),
                                       EAGER_STEPS, cast)
    rows["eager"] = (batch * seq * (EAGER_STEPS - 1) / dt,
                     torch.cuda.max_memory_allocated())
    per = {k: v / (EAGER_STEPS - 1) for k, v in counts.items() if v}
    check(per.get("flash_fwd") == cfg.num_layers
          and per.get("flash_bwd") == cfg.num_layers,
          f"train_eager_amp: launches a step {json.dumps(per)}, expected "
          f"{cfg.num_layers} flash_fwd and flash_bwd")
    check(np.isfinite(eager).all() and eager[-1] < eager[0],
          f"train_eager_amp: eager losses {eager.tolist()}")
    del model, opt, crit
    _release_card()
    model, opt = _o2_model(cfg, lr)
    jit.to_static(model)
    crit = GPTPretrainingCriterion(model=model)
    static, sdt, scounts = _eager_loop(model, opt, crit, (ids, labels),
                                          STATIC_STEPS, cast)
    rows["to_static"] = (batch * seq * (STATIC_STEPS - 1) / sdt,
                         torch.cuda.max_memory_allocated())
    progs = list(model.forward._cache.values())
    check(len(progs) == 1 and progs[0].calls == STATIC_STEPS - 1,
          f"train_eager_amp: to_static kept {len(progs)} programs "
          f"({[p.calls for p in progs]} replays); expected one replayed "
          f"{STATIC_STEPS - 1} times")
    check(np.array_equal(static, eager[:STATIC_STEPS]),
          f"train_eager_amp: to_static losses {static.tolist()} differ "
          f"from the eager loop's {eager[:STATIC_STEPS].tolist()}")
    sper = {k: v / (STATIC_STEPS - 1) for k, v in scounts.items() if v}
    del model, opt, crit
    _release_card()
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
    with torch.no_grad():
        # the eager loop's weights: `decorate` cast them to bf16, and its
        # f32 masters start from those casts
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    step = build_train_step(model, AdamW(learning_rate=lr),
                            GPTPretrainingCriterion(model=model),
                            amp_dtype="bfloat16", grad_clip_norm=1.0)
    first = [float(step(ids, labels)) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.run_steps(ids, labels, repeat=STATIC_STEPS)
    torch.cuda.synchronize()
    rows["graphed train step"] = (
        batch * seq * STATIC_STEPS / (time.perf_counter() - t0),
        torch.cuda.max_memory_allocated())
    gap = max(abs(a - b) / abs(b) for a, b in zip(eager[:3], first))
    check(gap <= BF16_TOL, f"train_eager_amp: eager losses "
          f"{eager[:3].tolist()} vs the graphed step's {first}: relative "
          f"gap {gap:.3g} > {BF16_TOL}")
    del model, step
    _release_card()
    for what, (tps, peak) in rows.items():
        log(f"[train_eager_amp] GPT-125M bf16 O2 12L B{batch} S{seq} "
            f"({card}) {what}: {tps:.1f} tokens/s, "
            f"{batch * seq / tps * 1e3:.2f} ms/step, peak memory "
            f"{peak / 2**30:.2f} GiB")
    log(f"[train_eager_amp] eager losses {eager.tolist()}; to_static "
        f"losses == the first {STATIC_STEPS} bit for bit; graphed step's "
        f"first 3 {first} (max relative gap {gap:.3g}, tol {BF16_TOL}); "
        f"launches a step eager {json.dumps(per)} to_static "
        f"{json.dumps(sper)}; eager / graphed tokens/s "
        f"{rows['eager'][0] / rows['graphed train step'][0]:.3f}")
    return counts, rows["eager"][0], eager


def _opt_state(model, opt):
    """Clones of the parameters, the optimizer's slots and its step."""
    import torch

    with torch.no_grad():
        return ([p.detach().clone() for p in model.parameters()],
                [v.clone() for v in opt.state_dict().values()
                 if isinstance(v, torch.Tensor)], opt._step_count)


def _scaler_steps(model, opt, crit, scaler, batch, steps, forced, what):
    """`steps` eager f16 O1 steps of ``scaler.scale(loss).backward();
    scaler.step(opt); scaler.update(); opt.clear_grad()`` under
    ``auto_cast(dtype="float16")``, the loss of step `forced` times inf:
    that step must overflow and leave the parameters, the optimizer's
    slots and its step count bit for bit.  Returns (the losses, the scale
    before each step, the steps that overflowed, the seconds of the steps
    after the first, the launch counts of those steps)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels as K

    ids, labels = batch
    losses, scales, overflowed = [], [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
        with amp.auto_cast(dtype="float16"):
            loss = crit(model(ids), labels)
        scales.append(scaler._scale)
        if i == forced:
            loss = loss * float("inf")
            before = _opt_state(model, opt)
        scaler.scale(loss).backward()
        scaler.step(opt)
        if scaler._found_inf:
            overflowed.append(i)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.detach())
        if i == forced:
            after = _opt_state(model, opt)
            check(i in overflowed and after[2] == before[2] and all(
                torch.equal(a, b) for a, b in zip(before[0] + before[1],
                                                  after[0] + after[1])),
                  f"{what}: the overflow step {i} (loss x inf) did not "
                  "overflow or changed the parameters, the optimizer's "
                  "slots or its step count")
            del before, after
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (torch.stack(losses).float().cpu().numpy(), scales, overflowed,
            dt, K.launch_counts())


def phase_train_fp16_scaler(card, bf16_tps, bf16_losses, batch=8,
                            seq=1024, lr=1e-4):
    """28. The same model in float16 O1 (f32 parameters,
    ``auto_cast(dtype="float16")``), AdamW(1e-4) with
    ClipGradByGlobalNorm(1.0) behind ``GradScaler(init_loss_scaling=
    2**16)`` attached to a StepGuard, FP16_STEPS eager steps, the loss
    times inf at FP16_OVERFLOW_STEP: that step leaves the parameters,
    the AdamW slots and the step count bit for bit, halves the scale
    and counts one "amp" skip without escalating.  Tokens/s against the
    bf16 eager loop's, the scale's trajectory, the loss at the last step
    against the bf16 run's, and 12 + 12 f16 flash launches a step (each
    step's backward runs, the skipped one's too).  Returns the launch
    counts."""
    import torch

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.gpt import (
        GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import StepGuard

    cfg = _gpt125m(12)
    ids, labels = _gpt125m_batch(cfg, batch, seq)
    _release_card()
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED).train()
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    guard = StepGuard(max_consecutive_bad=3, raise_without_rollback=False)
    scaler = GradScaler(init_loss_scaling=2.0 ** 16).attach_guard(guard)
    crit = GPTPretrainingCriterion(model=model)
    forced = FP16_OVERFLOW_STEP
    losses, scales, overflowed, dt, counts = _scaler_steps(
        model, opt, crit, scaler, (ids, labels), FP16_STEPS, forced,
        "train_fp16_scaler")
    check(scales[forced + 1] == scales[forced] / 2,
          f"train_fp16_scaler: scale {scales[forced]} -> "
          f"{scales[forced + 1]} at the overflow, expected halved")
    # every overflow, the forced one's too, is one "amp" skip of the guard
    check(guard.total_bad == len(overflowed) and guard.consecutive_bad == 0,
          f"train_fp16_scaler: guard total_bad {guard.total_bad} "
          f"consecutive {guard.consecutive_bad} for overflows at "
          f"{overflowed}")
    tps = batch * seq * (FP16_STEPS - 1) / dt
    peak = torch.cuda.max_memory_allocated()
    good = [j for j in range(FP16_STEPS) if j not in overflowed]
    check(np.isfinite(losses[good]).all() and losses[-1] < losses[0],
          f"train_fp16_scaler: losses {losses.tolist()}")
    check(guard.rollbacks == 0, f"train_fp16_scaler: the guard escalated "
          f"({guard.rollbacks} rollbacks)")
    per = {k: v / (FP16_STEPS - 1) for k, v in counts.items() if v}
    check(per.get("flash_fwd") == cfg.num_layers
          and per.get("flash_bwd") == cfg.num_layers,
          f"train_fp16_scaler: launches a step {json.dumps(per)}")
    log(f"[train_fp16_scaler] GPT-125M f16 O1 12L B{batch} S{seq} ({card}):"
        f" {tps:.1f} tokens/s ({tps / bf16_tps:.3f}x the bf16 O2 eager "
        f"loop's {bf16_tps:.1f}), {batch * seq / tps * 1e3:.2f} ms/step, "
        f"peak memory {peak / 2**30:.2f} GiB; scale before each step "
        f"{scales} (after the last {scaler._scale}); overflowing steps "
        f"{overflowed} (forced: {forced}, the state bit for bit, the scale "
        f"halved, one amp skip, no escalation); loss at step {FP16_STEPS} "
        f"{losses[-1]:.4f} vs bf16 O2 {bf16_losses[FP16_STEPS - 1]:.4f}; "
        f"f16 launches a step {json.dumps(per)}; guard total_bad "
        f"{guard.total_bad} rollbacks {guard.rollbacks}")
    del model, opt, crit
    _release_card()
    return counts


LLAMA_O1_STEPS = 8       # phase 28a's eager steps
LLAMA_O1_OVERFLOW = 3    # ... the one whose loss is multiplied by inf


def _scale_rule(scale, overflowed, steps, incr_every):
    """The scale before each of `steps` steps under GradScaler's rule
    (halved at each overflowing step, doubled after `incr_every` clean
    ones in a row) from `scale`, given the steps that overflowed."""
    out, good = [], 0
    for i in range(steps):
        out.append(scale)
        if i in overflowed:
            scale, good = max(scale * 0.5, 1.0), 0
        else:
            good += 1
            if good >= incr_every:
                scale, good = scale * 2.0, 0
    return out, scale


def phase_llama_o1_f16(card, seq=2048, lr=1e-4, incr_every=2):
    """28a. LLaMA at `llama_7b` widths with 2 layers, B1 x 2048, in
    float16 O1 (f32 parameters, ``auto_cast(dtype="float16")``), AdamW
    behind ``GradScaler(init_loss_scaling=2**16, incr_every_n_steps=2)``
    in the eager loop, LLAMA_O1_STEPS steps, the loss times inf at step
    LLAMA_O1_OVERFLOW: that step leaves the parameters, the AdamW slots
    and the step count bit for bit; the scale before every step follows
    the scaler's rule from the steps that overflowed (halved, doubled
    after 2 clean steps); the losses of the other steps finite; rope,
    flash_fwd, flash_bwd and rope_bwd in f16 once a layer a step (q and
    k in one rope launch each way).  Tokens/s of the steps after the
    first.  Returns the launch counts of those steps."""
    import torch

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM, LlamaPretrainingCriterion, llama_7b,
    )
    from paddle_tpu_torch.optimizer import AdamW

    _release_card()
    cfg = llama_7b(num_layers=2)
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED).train()
    opt = AdamW(learning_rate=lr, parameters=model.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 16,
                        incr_every_n_steps=incr_every)
    crit = LlamaPretrainingCriterion()
    rs = np.random.RandomState(SEED)
    batch = tuple(torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (1, seq)).astype(np.int32)).cuda()
        for _ in range(2))
    forced = LLAMA_O1_OVERFLOW
    losses, scales, overflowed, dt, counts = _scaler_steps(
        model, opt, crit, scaler, batch, LLAMA_O1_STEPS, forced,
        "llama_o1_f16")
    tps = seq * (LLAMA_O1_STEPS - 1) / dt
    peak = torch.cuda.max_memory_allocated()
    want, last = _scale_rule(2.0 ** 16, set(overflowed), LLAMA_O1_STEPS,
                             incr_every)
    check(scales == want and scaler._scale == last,
          f"llama_o1_f16: scales {scales} (then {scaler._scale}), the rule "
          f"gives {want} (then {last}) for overflows at {overflowed}")
    good = [j for j in range(LLAMA_O1_STEPS) if j not in overflowed]
    check(len(good) >= LLAMA_O1_STEPS - 2
          and np.isfinite(losses[good]).all(),
          f"llama_o1_f16: losses {losses.tolist()}, overflows {overflowed}")
    per = {k: v / (LLAMA_O1_STEPS - 1) for k, v in counts.items() if v}
    check(all(per.get(k) == cfg.num_layers for k in
              ("flash_fwd", "flash_bwd", "rope", "rope_bwd")),
          f"llama_o1_f16: launches a step {json.dumps(per)}")
    log(f"[llama_o1_f16] llama_7b widths 2L f16 O1 B1 S{seq} AdamW + "
        f"GradScaler ({card}): {tps:.1f} tokens/s, "
        f"{seq / tps * 1e3:.2f} ms/step over {LLAMA_O1_STEPS - 1} eager "
        f"steps, peak memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(float(x), 4) for x in losses]}; scale before each step "
        f"{scales} (after the last {scaler._scale}), the rule's for "
        f"overflows at {overflowed} (forced: {forced}, the state bit for "
        f"bit); f16 launches a step {json.dumps(per)}")
    del model, opt, crit
    _release_card()
    return counts


def _generate_refs(model, cfg, new_tokens=32):
    """Each of phase 4's prompts alone through greedy `generate()`:
    the sequential streams the engine's must equal."""
    return [model.generate(p[None], max_new_tokens=new_tokens)
            .cpu().numpy()[0] for p in _prompts(cfg.vocab_size)]


def _zoo():
    """Phase 29's rules: (label, optimizer class name, kwargs)."""
    return (("SGD", "SGD", {}),
            ("Momentum", "Momentum", dict(momentum=0.9)),
            ("Adagrad", "Adagrad", dict(initial_accumulator_value=0.1)),
            ("Adam amsgrad", "Adam", dict(amsgrad=True)),
            ("AdamW", "AdamW", {}),
            ("Adamax", "Adamax", {}),
            ("RMSProp centered", "RMSProp", dict(centered=True,
                                                 momentum=0.5)),
            ("Lamb", "Lamb", {}),
            ("Adadelta", "Adadelta", {}),
            ("Rprop", "Rprop", {}))


def _zoo_equivalence(cls, kw, label, steps=4, lr=1e-5):
    """A 2-layer GPT-125M-width model in f32, batch 2 x 256: `steps`
    steps of the graphed train step (the eager first step and its
    capture, then replays) against `steps` eager ``.step()``s of the
    same rule from the same weights.  Losses and parameters within
    F32_TOL (relative to the largest value); returns the largest
    parameter gap."""
    import torch

    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTForCausalLM, GPTPretrainingCriterion,
    )

    cfg = _gpt125m(2)
    ids, labels = _gpt125m_batch(cfg, 2, 256)
    graphed = GPTForCausalLM(cfg, device="cuda", seed=SEED)
    step = build_train_step(graphed, cls(learning_rate=lr, **kw),
                            GPTPretrainingCriterion(model=graphed))
    lg = torch.cat([step(ids, labels)[None],
                    step.run_steps(ids, labels, repeat=steps - 1)])
    check(len(step._graphs) == 1, f"optimizer_zoo {label}: the step did "
          "not replay one graph")
    eager = GPTForCausalLM(cfg, device="cuda", seed=SEED).train()
    opt = cls(learning_rate=lr, parameters=eager.parameters(), **kw)
    crit = GPTPretrainingCriterion(model=eager)
    le = []
    for _ in range(steps):
        loss = crit(eager(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        le.append(loss.detach())
    le = torch.stack(le)
    lgap = ((lg - le).abs() / le.abs()).max().item()
    gap = max(((a - b).abs().max() / a.abs().max().clamp(min=1.0)).item()
              for a, b in zip(graphed.parameters(), eager.parameters()))
    check(lgap <= F32_TOL and gap <= F32_TOL,
          f"optimizer_zoo {label}: {steps} replayed steps vs eager "
          f".step()s: losses {lg.tolist()} / {le.tolist()}, parameter gap "
          f"{gap:.3g} (tol {F32_TOL})")
    return gap, bool(torch.equal(lg, le))


def phase_optimizer_zoo(card, batch=8, seq=1024, lr=1e-4):
    """29. Each functional rule in GPT-125M's graphed train step at B8 x
    1024, bf16 AMP: the eager first step and its capture, then
    ZOO_STEPS replayed steps timed (tokens/s), the rule's device ms a
    step (torch.profiler over its `apply_gradients` on the model's f32
    masters with the step's gradient sizes) and its slot memory; the
    loss must fall.  Then, per rule, `_zoo_equivalence` in f32.  Returns
    the launch counts of the timed replays of all the rules."""
    import torch

    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import optimizer as O

    cfg = _gpt125m(12)
    ids, labels = _gpt125m_batch(cfg, batch, seq)
    total = {}
    for label, name, kw in _zoo():
        _release_card()
        cls = getattr(O, name)
        model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
        rule = cls(learning_rate=lr, **kw)
        step = build_train_step(model, rule,
                                GPTPretrainingCriterion(model=model),
                                amp_dtype="bfloat16")
        first = float(step(ids, labels))
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        losses = step.run_steps(ids, labels, repeat=ZOO_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        losses = losses.cpu().numpy()
        check(np.isfinite(losses).all() and losses[-1] < first,
              f"optimizer_zoo {label}: losses {first} -> {losses.tolist()}")
        check(counts["flash_fwd"] == cfg.num_layers * ZOO_STEPS,
              f"optimizer_zoo {label}: launches {json.dumps(counts)}")
        slot_bytes = sum(t.numel() * t.element_size()
                         for s in step._state["slots"].values()
                         for t in s.values())
        params = step._params
        grads = {n: torch.randn_like(p) * 1e-3 for n, p in params.items()}
        with torch.no_grad():
            saved = [p.clone() for p in params.values()]
        state = rule.init_state(params)
        opt_ms = device_ms(lambda: rule.apply_gradients(
            params, grads, state, lr=step._lr), iters=5, warmup=1)
        with torch.no_grad():
            for p, s in zip(params.values(), saved):
                p.copy_(s)
        del grads, state, saved
        gap, bits = _zoo_equivalence(cls, kw, label)
        log(f"[optimizer_zoo] {label:16s} GPT-125M bf16 12L B{batch} "
            f"S{seq} ({card}): {batch * seq * ZOO_STEPS / dt:.1f} tokens/s, "
            f"{1e3 * dt / ZOO_STEPS:.2f} ms/step, optimizer device_ms "
            f"{opt_ms:.3f} a step, slots {slot_bytes / 2**20:.1f} MiB; loss "
            f"{first:.4f} -> {losses[-1]:.4f}; f32 2L: 4 replayed steps vs "
            f"4 eager .step()s max parameter gap {gap:.3g} (tol {F32_TOL}"
            f"{', losses bit for bit' if bits else ''})")
        del model, step, rule
    _release_card()
    return total


# ---------------------------------------------------------- phases 30-33
# phase 31's decode loop: gpt_6p7b's attention width over a dense cache
MMHA = dict(batch=8, heads=32, head_dim=128, cap=2048, steps=64, block=64)
MMHA_STARTS = (100, 1900, 1000, 37, 1500, 250, 1983, 640)
# phase 31 (c): variable_length_memory_efficient_attention's batch
VLMEA = dict(batch=8, heads=32, seq=1024, head_dim=128, lens=(1024, 256))
# phase 32: FusedEcMoe's block
EC_MOE = dict(hidden=1024, inter=4096, experts=8, batch=8, seq=512)
INCUBATE_STEPS = 10      # phase 33's eager steps


def _sum_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_gpt6p7b_serve(model, cfg, name="gpt_6p7b"):
    """30. gpt_6p7b (hidden 4096, 32 layers, 32 heads of 128, learned
    positions, LayerNorm, GELU, a tied head) in bf16 with seeded weights
    on the card: phase 4 (the engine, its launches per layer and replays
    included) and phase 5 (`generate()`, against the per-token loop and
    the f32 upcast) on it, then the engine's decode step at 4 live slots
    (~730-token contexts): wall ms of the replayed graph and its profiled
    device ms, and the phase's peak memory.  Returns both phases' launch
    counts."""
    import torch

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    counts = _sum_counts(phase_serve(model, cfg, name),
                         phase_generate(model, cfg, name))
    peak = torch.cuda.max_memory_allocated()
    eng = InferenceEngine(model, EngineConfig())
    with torch.inference_mode():
        prog = eng._decode_program(1)
        for dst, src in zip((prog.tok, prog.pt, prog.lengths),
                            _live_decode_inputs(eng, (1040, 560, 330,
                                                      1000))):
            dst.copy_(torch.from_numpy(src))
        wall = time_ms(prog.graph.replay, iters=20)
        dev = device_ms(prog.graph.replay, iters=10)
    # the step's least work: every weight and live K/V row read once, 2
    # operations a parameter a token for 4 tokens
    keys = 1041 + 561 + 331 + 1001
    kv_bytes = 2 * keys * cfg.num_layers * cfg.hidden_size * 2
    bms, by = bound_ms(weights + kv_bytes, 2 * (weights // 2) * 4,
                       "bfloat16")
    log(f"[gpt6p7b_serve] {name} bf16 {cfg.num_layers}L: weights "
        f"{weights / 2**30:.2f} GiB; decode step (4 live slots, "
        f"1041/561/331/1001 keys) {wall:.3f} ms wall (graph replay, CUDA "
        f"events), {dev:.3f} ms device; bound {bms:.3f} ms ({by}: the "
        f"weights and the live KV once); peak allocated over phases 4 and "
        f"5 {peak / 2**30:.2f} GiB (phase 5's f32 copy included)")
    del eng, prog
    return counts


def _mmha_loop(IF, cache, xs, starts, mask=None):
    """`masked_multihead_attention` over the steps of `xs` from `starts`
    on `cache` (written in place): the outputs."""
    return [IF.masked_multihead_attention(x, cache_kv=cache, src_mask=mask,
                                          sequence_lengths=starts + i)[0]
            for i, x in enumerate(xs)]


def _rel_max(got, want):
    """Largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _to_blocks(dense, table, bs):
    """A block pool [num_blocks, H, bs, D] holding the dense cache
    [B, H, S, D] at the blocks `table` [B, S / bs] names."""
    import torch

    b, h, s, d = dense.shape
    pool = torch.empty(table.numel(), h, bs, d, device=dense.device,
                       dtype=dense.dtype)
    pool[table.reshape(-1).long()] = dense.reshape(b, h, s // bs, bs, d) \
        .movedim(2, 1).reshape(-1, h, bs, d)
    return pool


def phase_incubate_decode(card):
    """31. The incubate decode functionals at gpt_6p7b's attention width
    (B8, 32 heads of 128, a 2048-slot cache), 64 steps from starts
    `MMHA_STARTS`: (a) `masked_multihead_attention` in bf16 and in f32:
    decode_attention launched once a step, each step's output against
    the einsum route of the same inputs (a zero `src_mask`) within
    BF16_TOL (bf16) or 1e-5 (f32) of its largest value, both routes'
    caches equal bit for bit; (b) `block_multihead_attention` over the
    same contents in 64-token blocks of a shuffled f32 pool: each step
    within 1e-5 of (a)'s f32 output; the last step of each timed; (c)
    `variable_length_memory_efficient_attention` at B8 H32 S1024 D128,
    bf16, causal, key lengths 256-1024: flash_fwd once and flash_bwd
    once under a backward, output and gradients within BF16_TOL of
    `_sdpa_ref` in f32 on the card.  Returns the launch counts."""
    import torch

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.ops import kernels as K

    b, h, d, cap = (MMHA[k] for k in ("batch", "heads", "head_dim", "cap"))
    steps, bs = MMHA["steps"], MMHA["block"]
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    starts = torch.tensor(MMHA_STARTS, dtype=torch.int32, device=dev)
    last = starts + steps - 1
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    total, outs, ms = [], {}, {}
    try:
        with torch.no_grad():
            filled = torch.arange(cap, device=dev)[None, :] < starts[:, None]
            dense = torch.randn(2, b, h, cap, d, generator=g, device=dev) \
                * filled[None, :, None, :, None]
            xs32 = torch.randn(steps, b, 3 * h * d, generator=g, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
                ck, xs = dense.to(dtype), xs32.to(dtype)
                ce = ck.clone()
                zero = torch.zeros(b, 1, 1, cap, device=dev)
                K.reset_launches()
                got = _mmha_loop(IF, ck, xs, starts)
                counts = K.launch_counts()
                want = _mmha_loop(IF, ce, xs, starts, zero)
                check(K.launch_counts() == counts
                      and counts["decode_attention"] == steps,
                      f"incubate_decode {dname}: decode_attention launched "
                      f"{counts['decode_attention']} times in {steps} "
                      "steps (the einsum route must launch none)")
                total.append(counts)
                worst = max(_rel_max(a, w) for a, w in zip(got, want))
                check(worst <= tol, f"incubate_decode {dname}: the kernel "
                      f"route vs the einsum route {worst:.3g} > {tol}")
                check(torch.equal(ck, ce), f"incubate_decode {dname}: the "
                      "two routes wrote different caches")
                outs[dname] = (got, worst)
                ms[f"mmha kernel {dname}"] = time_ms(
                    lambda: IF.masked_multihead_attention(
                        xs[-1], cache_kv=ck, sequence_lengths=last))
                ms[f"mmha einsum {dname}"] = time_ms(
                    lambda: IF.masked_multihead_attention(
                        xs[-1], cache_kv=ce, src_mask=zero,
                        sequence_lengths=last))
                del ck, ce
            # (b) the same contents in a shuffled pool of 64-token blocks
            nblk = cap // bs
            perm = torch.randperm(b * nblk,
                                  generator=torch.Generator().manual_seed(
                                      SEED))
            table = perm.reshape(b, nblk).to(device=dev, dtype=torch.int32)
            kc, vc = _to_blocks(dense[0], table, bs), \
                _to_blocks(dense[1], table, bs)
            enc = torch.zeros(b, dtype=torch.int32, device=dev)
            this = torch.ones(b, dtype=torch.int32, device=dev)

            def block(x, lens):
                return IF.block_multihead_attention(
                    x, kc, vc, enc, lens, this, block_tables=table,
                    block_size=bs)[0]

            bworst = max(_rel_max(block(x, starts + i), w) for i, (x, w)
                         in enumerate(zip(xs32, outs["float32"][0])))
            check(bworst <= 1e-5, f"incubate_decode: block_multihead_"
                  f"attention vs masked_multihead_attention (f32) "
                  f"{bworst:.3g} > 1e-5")
            ms["block f32"] = time_ms(lambda: block(xs32[-1], last))
            del kc, vc, dense
        # (c) variable-length attention through the biased flash kernels
        vb, vh, vs, vd = (VLMEA[k] for k in ("batch", "heads", "seq",
                                             "head_dim"))
        hi, lo = VLMEA["lens"]
        lens = torch.linspace(hi, lo, vb, device=dev).round().int()
        q, k, v, dout = (torch.randn(vb, vh, vs, vd, generator=g, device=dev,
                                     dtype=torch.bfloat16)
                         for _ in range(4))
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        K.reset_launches()
        out = IF.variable_length_memory_efficient_attention(
            *qkv, kv_seq_lens=lens, causal=True)
        fwd = K.launch_counts()
        out.backward(dout)
        counts = K.launch_counts()
        check((fwd["flash_fwd"], fwd["flash_bwd"], counts["flash_fwd"],
               counts["flash_bwd"]) == (1, 0, 1, 1),
              f"incubate_decode (c): launches forward "
              f"{ {k: v for k, v in fwd.items() if v} }, with the backward "
              f"{ {k: v for k, v in counts.items() if v} }")
        total.append(counts)
        refs = [t.float().requires_grad_() for t in (q, k, v)]
        pad = torch.where(torch.arange(vs, device=dev)[None, :]
                          < lens[:, None], 0.0, IF._KV_PAD)[:, None, None]
        ref = _sdpa_ref(*(t.transpose(1, 2) for t in refs), pad,
                        True).transpose(1, 2)
        ref.backward(dout.float())
        verr = [_rel_max(out, ref)] + [_rel_max(a.grad, r.grad)
                                       for a, r in zip(qkv, refs)]
        check(max(verr) <= BF16_TOL, f"incubate_decode (c): output, dq, dk,"
              f" dv vs _sdpa_ref in f32 {[f'{e:.3g}' for e in verr]} > "
              f"{BF16_TOL}")
        del refs, ref
        with torch.no_grad():
            ms["vlmea fwd bf16"] = time_ms(
                lambda: IF.variable_length_memory_efficient_attention(
                    q, k, v, kv_seq_lens=lens, causal=True))

        def fwd_bwd():
            o = IF.variable_length_memory_efficient_attention(
                *qkv, kv_seq_lens=lens, causal=True)
            o.backward(dout)

        ms["vlmea fwd+bwd bf16"] = time_ms(fwd_bwd, iters=5)
        K.reset_launches()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    keys = int((last + 1).sum())
    kv_bytes = 2 * keys * h * d * 2
    log(f"[incubate_decode] masked_multihead_attention B{b} H{h} D{d} cap"
        f"{cap}, {steps} steps from {list(MMHA_STARTS)} ({card}): "
        f"decode_attention {steps} launches a run; kernel vs einsum route "
        f"bf16 {outs['bfloat16'][1]:.3g} (tol {BF16_TOL}), f32 "
        f"{outs['float32'][1]:.3g} (tol 1e-5) of the largest output; "
        f"block_multihead_attention (blocks of {bs}, shuffled) vs the f32 "
        f"run {bworst:.3g} (tol 1e-5)")
    log(f"[incubate_decode] ms a call at the last step ({keys} valid keys, "
        f"bf16 K+V {kv_bytes / 1e6:.1f} MB, bound "
        f"{kv_bytes / PEAK_BYTES * 1e3:.4f} ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items() if "vlmea" not in k))
    log(f"[incubate_decode] variable_length_memory_efficient_attention "
        f"B{vb} H{vh} S{vs} D{vd} bf16 causal, kv lengths "
        f"{lens.tolist()}: flash_fwd 1 + flash_bwd 1; output, dq, dk, dv "
        f"vs _sdpa_ref f32 {[float(f'{e:.3g}') for e in verr]} (tol "
        f"{BF16_TOL}); fwd {ms['vlmea fwd bf16']:.4f} ms, fwd+bwd "
        f"{ms['vlmea fwd+bwd bf16']:.4f} ms")
    return _sum_counts(*total)


def phase_incubate_moe(card):
    """32. `FusedEcMoe` at hidden 1024, inter 4096, 8 experts, B8 x 512:
    bf16 against the f32 forward of the same weights within 5% relative
    L2 (TF32 off), ms a forward of each (CUDA events) and the achieved
    TFLOP/s of the bf16 one (every expert sees every token)."""
    import torch

    from paddle_tpu_torch.incubate.nn import FusedEcMoe

    hid, inter, e, b, s = (EC_MOE[k] for k in ("hidden", "inter",
                                               "experts", "batch", "seq"))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m32 = FusedEcMoe(hid, inter, e, device="cuda", seed=SEED)
        m16 = FusedEcMoe(hid, inter, e, device="cuda",
                         dtype=torch.bfloat16, seed=SEED)
        m16.load_state_dict({n: t.to(torch.bfloat16)
                             for n, t in m32.state_dict().items()})
        g = torch.Generator(device="cuda").manual_seed(SEED + 32)
        x = torch.randn(b, s, hid, generator=g, device="cuda")
        xb = x.to(torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ref, out = m32(x), m16(xb)
            rel = ((out.float() - ref).norm() / ref.norm()).item()
            ms16 = time_ms(lambda: m16(xb))
            ms32 = time_ms(lambda: m32(x), iters=3)
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    check(bool(torch.isfinite(out).all()) and rel <= 0.05,
          f"incubate_moe: bf16 vs f32 relative L2 {rel:.4g} > 0.05")
    flops = 2 * e * b * s * (2 * hid * inter + hid) + 2 * b * s * hid * e
    log(f"[incubate_moe] FusedEcMoe H{hid} I{inter} E{e} B{b} x {s} "
        f"({card}): bf16 vs f32 rel L2 {rel:.4g} (tol 0.05); bf16 "
        f"{ms16:.3f} ms a forward ({flops / ms16 / 1e9:.1f} TFLOP/s), f32 "
        f"{ms32:.3f} ms; peak {peak / 2**30:.2f} GiB")


def phase_incubate_train(card, bf16_tps, batch=8, seq=1024, lr=1e-4):
    """33. GPT-125M (12 layers, B8 x 1024) in the eager bf16 O2 loop of
    phase 27 under the incubate extras: its 48 projection weights pruned
    2:4 (`asp.prune_model`), `asp.decorate(LookAhead(AdamW, alpha 0.5,
    k 5))`, and a `ModelAverage` (window 4) stepped beside it, for
    INCUBATE_STEPS steps.  The loss falls; `check_sparsity` holds on
    every pruned weight after every step; `apply()` changes the weights
    and `restore()` gives back the live ones bit for bit; flash_fwd and
    flash_bwd launch 12 each a step.  Tokens/s (the steps after the
    first, the sparsity reads left out) beside phase 27's AdamW eager
    loop.  Returns the launch counts of the timed steps."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate.optimizer import LookAhead, ModelAverage
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.ops import kernels as K

    cfg = _gpt125m(12)
    ids, labels = _gpt125m_batch(cfg, batch, seq)
    _release_card()
    model, adamw = _o2_model(cfg, lr)
    asp.reset_excluded_layers()
    pruned = asp.prune_model(model)
    weights = asp._prunable_params(model)
    check(len(pruned) == len(weights) == 4 * cfg.num_layers
          and all(asp.check_sparsity(w) for w in weights),
          f"incubate_train: {len(pruned)} weights pruned 2:4")
    opt = asp.decorate(LookAhead(adamw, alpha=0.5, k=5))
    ma = ModelAverage(0.15, parameters=list(model.parameters()),
                      max_average_window=4)
    crit = GPTPretrainingCriterion(model=model)
    losses, dt = [], 0.0
    for i in range(INCUBATE_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            K.reset_launches()
        t = time.perf_counter()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        ma.step()
        losses.append(loss.detach())
        torch.cuda.synchronize()
        if i:
            dt += time.perf_counter() - t
            counts = K.launch_counts()
        check(all(asp.check_sparsity(w) for w in weights),
              f"incubate_train: 2:4 sparsity lost after step {i}")
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"incubate_train: losses {losses.tolist()}")
    per = {k: v / (INCUBATE_STEPS - 1) for k, v in counts.items() if v}
    check(per.get("flash_fwd") == cfg.num_layers
          and per.get("flash_bwd") == cfg.num_layers,
          f"incubate_train: launches a step {json.dumps(per)}")
    with torch.no_grad():
        live = [p.detach().clone() for p in model.parameters()]
        ma.apply()
        moved = sum(not torch.equal(p, q)
                    for p, q in zip(model.parameters(), live))
        ma.restore()
        back = all(torch.equal(p, q)
                   for p, q in zip(model.parameters(), live))
    check(moved > 0 and back, f"incubate_train: ModelAverage apply moved "
          f"{moved} tensors, restore bit for bit {back}")
    tps = batch * seq * (INCUBATE_STEPS - 1) / dt
    log(f"[incubate_train] GPT-125M bf16 O2 12L B{batch} S{seq} ({card}): "
        f"{len(weights)} weights 2:4 (density "
        f"{asp.calculate_density(weights[0]):.3f}), LookAhead(AdamW, k 5) "
        f"through asp.decorate, ModelAverage(window 4): {tps:.1f} tokens/s "
        f"({tps / bf16_tps:.3f}x phase 27's AdamW eager loop "
        f"{bf16_tps:.1f}), {dt / (INCUBATE_STEPS - 1) * 1e3:.2f} ms/step; "
        f"losses {losses.tolist()}; sparsity held after every step; "
        f"apply moved {moved} tensors, restore bit for bit; launches a "
        f"step {json.dumps(per)}")
    asp.reset_excluded_layers()
    del model, opt, adamw, ma, crit
    _release_card()
    return counts


# ------------------------------------------------------------ phases 34-37
HAPI_STEPS = 8           # phase 35: Model.fit's steps, and the eager loop's
HAPI_EVAL_BATCHES = 2    # phase 35: batches of the evaluation set
VISION_EVAL_BATCHES = 2  # phase 36: batches of 64 images
# phase 37's narrow Swin-T: 2 stages of 2 blocks at 56²
SWIN_NARROW = dict(img_size=56, embed_dim=24, depths=(2, 2), num_heads=(1, 2),
                   window_size=7, num_classes=10)


def _tmpdir(what):
    """A scratch directory for the files a phase writes, under the
    checkout (removed by the phase)."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"chip_smoke_{what}_", dir=HERE)


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _tensors_equal(a, b):
    """Two dicts of tensors: the same names, each bit for bit."""
    import torch

    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def phase_save_load(card):
    """34. save_load: `paddle_tpu_torch.save` of a GPT-125M state in bf16
    (bench.py's widths, 12 layers, seeded) to a `.pdparams` file in the
    JAX package's format, and `load` back onto the card: every tensor bit
    for bit, its dtype and shape kept.  Seconds of each and the file's
    size."""
    import shutil

    import torch

    import paddle_tpu_torch as PT
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(_gpt125m(12), device="cuda",
                           dtype=torch.bfloat16, seed=SEED)
    state = model.state_dict()
    d = _tmpdir("save")
    try:
        path = os.path.join(d, "gpt125m.pdparams")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        PT.save(state, path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = PT.load(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(all(t.device.type == "cuda" for t in back.values()),
          "save_load: load() put a tensor off the card")
    check(_tensors_equal(state, back),
          "save_load: the loaded GPT-125M state differs from the saved one")
    n = sum(t.numel() for t in state.values())
    log(f"[save_load] GPT-125M bf16 state ({len(state)} tensors, {n} "
        f"values, {card}): save {t_save:.3f} s, load to the card "
        f"{t_load:.3f} s, file {size / 2**20:.1f} MiB; bit for bit")
    del model, state, back
    _release_card()


def _hapi_cfg():
    """GPT-125M (bench.py's widths, 12 layers) with the LM head's logits
    out: no fused head."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_seq_len=1024, fused_head_ce=False)


def _hapi_gpt(seed):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    cfg = _hapi_cfg()
    return GPTForCausalLM(cfg, device="cuda", seed=seed), cfg


def _hapi_tokens(cfg, n, seq, seed):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (n, seq + 1)).astype(np.int64)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


def _hapi_model(net, lr):
    from paddle_tpu_torch import Model, metric, nn
    from paddle_tpu_torch.optimizer import AdamW

    m = Model(net)
    m.prepare(AdamW(learning_rate=lr, parameters=net.parameters()),
              nn.CrossEntropyLoss(), metric.Accuracy(),
              amp_configs={"level": "O2", "dtype": "bfloat16"})
    return m


def phase_hapi_fit(card, batch=8, seq=1024, lr=1e-4):
    """35. hapi_fit: `Model(GPT-125M, fused_head_ce=False)` prepared with
    AdamW, `nn.CrossEntropyLoss`, `metric.Accuracy` and ``amp_configs=
    {"level": "O2", "dtype": "bfloat16"}``, `.fit` for HAPI_STEPS steps
    over a seeded in-memory token `TensorDataset` at B8 x 1024 through
    `DataLoader(num_workers=2)`, which must take the shared-memory route
    (spawned workers, the native ring).  Its per-step losses equal, bit
    for bit, the eager O2 loop's (`amp.decorate`, `auto_cast`,
    ``loss.backward(); opt.step(); opt.clear_grad()``) on the same
    batches from the same seeded weights; flash_fwd and flash_bwd launch
    12 each a step.  Tokens/s of both (steps 3 on; the fit runs first, so
    it meets the colder allocator).  Then
    `Model.save` -> a new `Model` of other weights -> `load` ->
    `evaluate` on HAPI_EVAL_BATCHES other batches equals the first
    model's `evaluate`.  Returns the fit's launch counts."""
    import shutil

    import torch

    from paddle_tpu_torch import amp, metric, nn
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.times, self.first = [], [], None

        def on_train_batch_begin(self, step, logs=None):
            if self.first is None:       # the first batch has arrived
                self.first = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"][0])   # a host read: synced
            self.times.append(time.perf_counter())

    _release_card()
    net, cfg = _hapi_gpt(SEED)
    x, y = _hapi_tokens(cfg, batch * HAPI_STEPS, seq, SEED)
    loader = DataLoader(TensorDataset([x, y]), batch_size=batch,
                        num_workers=2)
    model = _hapi_model(net, lr)
    rec = Steps()
    K.reset_launches()
    t_start = time.perf_counter()
    model.fit(loader, epochs=1, callbacks=[rec])
    t_fit = time.perf_counter() - t_start
    counts = K.launch_counts()
    check(loader.route == "shm", f"hapi_fit: the DataLoader took the "
          f"{loader.route!r} route, not the shared-memory workers")
    check(len(rec.losses) == HAPI_STEPS, f"hapi_fit: {len(rec.losses)} "
          f"steps, expected {HAPI_STEPS}")
    per = {k: v / HAPI_STEPS for k, v in counts.items() if v}
    check(per == {"flash_fwd": cfg.num_layers, "flash_bwd": cfg.num_layers},
          f"hapi_fit: launches a step {json.dumps(per)}, expected "
          f"{cfg.num_layers} flash_fwd and flash_bwd")
    # steps 3 on: the first two grow the allocator's pools
    fit_tps = batch * seq * (HAPI_STEPS - 2) / (rec.times[-1] - rec.times[1])
    peak = torch.cuda.max_memory_allocated()
    # Model.save -> a new Model -> load -> evaluate
    ex, ey = _hapi_tokens(cfg, batch * HAPI_EVAL_BATCHES, seq, SEED + 1)
    evals = TensorDataset([ex, ey])
    want = model.evaluate(evals, batch_size=batch)
    d = _tmpdir("hapi")
    try:
        path = os.path.join(d, "gpt125m")
        t0 = time.perf_counter()
        model.save(path)
        t_save = time.perf_counter() - t0
        size = _dir_bytes(d)
        del model, net
        _release_card()
        other, _ = _hapi_gpt(SEED + 7)
        model2 = _hapi_model(other, lr)
        t0 = time.perf_counter()
        model2.load(path)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = model2.evaluate(evals, batch_size=batch)
    check(got == want, f"hapi_fit: the loaded Model's evaluate {got} "
          f"differs from the saved one's {want}")
    del model2, other
    _release_card()
    # the eager O2 loop on the same batches from the same weights
    net, _ = _hapi_gpt(SEED)
    opt = AdamW(learning_rate=lr, parameters=net.parameters())
    net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    net.train()
    crit = nn.CrossEntropyLoss()
    losses, times = [], []
    for i in range(HAPI_STEPS):
        ids = torch.from_numpy(x[i * batch:(i + 1) * batch]).cuda()
        labels = torch.from_numpy(y[i * batch:(i + 1) * batch]).cuda()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(net(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        times.append(time.perf_counter())
    eager_tps = batch * seq * (HAPI_STEPS - 2) / (times[-1] - times[1])
    # what the fit's step does beside the eager loop's: the metric's
    # top-1 over [B * S, vocab] bf16 logits and its host read
    with torch.no_grad():
        logits = net(ids)
    acc = metric.Accuracy()
    acc_ms = time_ms(lambda: acc.update(acc.compute(logits, labels)))
    check(losses == rec.losses, f"hapi_fit: Model.fit losses "
          f"{rec.losses} differ from the eager O2 loop's {losses}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"hapi_fit: losses {losses}")
    del net, opt, logits
    _release_card()
    log(f"[hapi_fit] GPT-125M bf16 O2 12L B{batch} S{seq} ({card}): "
        f"Model.fit {fit_tps:.1f} tokens/s (the fit call {t_fit:.2f} s, "
        f"{rec.first - t_start:.2f} s of it to the first batch through the "
        f"workers, {rec.times[0] - rec.first:.2f} s the first step), eager "
        f"O2 loop {eager_tps:.1f} tokens/s "
        f"(fit / eager {fit_tps / eager_tps:.3f}; Accuracy's compute + "
        f"update {acc_ms:.2f} ms a step); peak memory "
        f"{peak / 2**30:.2f} GiB; losses bit for bit the eager loop's "
        f"{losses}; launches a step {json.dumps(per)}; DataLoader route "
        f"{loader.route}")
    log(f"[hapi_fit] Model.save {t_save:.3f} s ({size / 2**20:.1f} MiB: "
        f".pdparams + .pdopt), a new Model's load {t_load:.3f} s; evaluate "
        f"equal: {json.dumps(want)}")
    return counts


def phase_hapi_vision(card, batch=VISION_BATCH):
    """36. hapi_vision: `Model(resnet50())` (seeded weights and batch-norm
    statistics, f32, eval mode) with `nn.CrossEntropyLoss` and
    `metric.Accuracy(topk=(1, 5))`: `.evaluate` and `.predict` over
    VISION_EVAL_BATCHES seeded batches of 64 x 3 x 224² through a
    `DataLoader`.  conv_bn_act launches 49 a forward; the predictions and
    the evaluation loss equal the eager model's on the same batches bit
    for bit.  Returns the launch counts of evaluate and predict."""
    import torch

    from paddle_tpu_torch import Model, metric, nn
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.ops import kernels as K

    net = _vision_model("resnet50", "cuda", torch.float32)
    rs = np.random.RandomState(SEED + 3)
    n = batch * VISION_EVAL_BATCHES
    imgs = rs.randn(n, 3, 224, 224).astype(np.float32)
    labels = rs.randint(0, 1000, (n,)).astype(np.int64)
    loader = DataLoader(TensorDataset([imgs, labels]), batch_size=batch)
    model = Model(net)
    model.prepare(loss=nn.CrossEntropyLoss(),
                  metrics=metric.Accuracy(topk=(1, 5)))
    K.reset_launches()
    t0 = time.perf_counter()
    res = model.evaluate(loader)
    pred = model.predict(loader, stack_outputs=True)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    per = {k: v / (2 * VISION_EVAL_BATCHES) for k, v in counts.items()
           if v}
    check(per == {"conv_bn_act": 49}, f"hapi_vision: launches a forward "
          f"{json.dumps(per)}, expected 49 conv_bn_act")
    crit = nn.CrossEntropyLoss()
    eager, loss = [], 0.0
    with torch.no_grad():
        for i in range(VISION_EVAL_BATCHES):
            sl = slice(i * batch, (i + 1) * batch)
            out = net(torch.from_numpy(imgs[sl]).cuda())
            loss += float(crit(out, torch.from_numpy(labels[sl]).cuda()))
            eager.append(out.cpu().numpy())
    eager = np.concatenate(eager)
    check(pred.shape == (n, 1000) and np.array_equal(pred, eager),
          f"hapi_vision: predict differs from the eager forward (max "
          f"{float(np.abs(pred - eager).max()):.3g})")
    check(res["loss"] == loss / VISION_EVAL_BATCHES,
          f"hapi_vision: evaluate loss {res['loss']} vs the eager "
          f"{loss / VISION_EVAL_BATCHES}")
    log(f"[hapi_vision] ResNet-50 f32 B{batch} x {VISION_EVAL_BATCHES} "
        f"({card}): evaluate + predict {wall:.2f} s, "
        f"{2 * n / wall:.1f} images/s through the DataLoader; "
        f"{json.dumps(res)}; predictions and loss bit for bit the eager "
        f"model's; launches a forward {json.dumps(per)}")
    del net, model
    _release_card()
    return counts


def _program_ops(layer):
    return sorted({str(n.target).split(".")[1]
                   for n in layer._exported.graph.nodes
                   if str(n.target).startswith("paddle_tpu_torch.")})


def _jit_round_trip(card, what, net, x, want_ops, per_call, iters=10,
                    exact=True):
    """`jit.save` of `net` at `x`'s shape, `jit.load` onto the card, one
    call: its output bit for bit the eager forward's (`exact`; else
    within F32_TOL of the largest |output|, the eager forward run twice
    and the gap logged), its program holding `want_ops` nodes, launching
    `per_call` a call.  Times both.  Returns the call's launch counts."""
    import shutil

    import torch

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import kernels as K

    d = _tmpdir("jit")
    try:
        path = os.path.join(d, what)
        t0 = time.perf_counter()
        jit.save(net, path, input_spec=[x])
        t_save = time.perf_counter() - t0
        size = _dir_bytes(d)
        t0 = time.perf_counter()
        loaded = jit.load(path)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ops = _program_ops(loaded)
    check(set(want_ops) <= set(ops), f"jit_save: {what}'s program holds "
          f"{ops}, expected {want_ops}")
    with torch.no_grad():
        want = net(x)
        torch.cuda.synchronize()
        K.reset_launches()
        got = loaded(x)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        per = {k: v for k, v in counts.items() if v}
        check(per == per_call, f"jit_save: {what}'s loaded program "
              f"launched {json.dumps(per)}, expected {per_call}")
        gap = (got.float() - want.float()).abs().max().item()
        if exact:
            check(torch.equal(got, want), f"jit_save: {what}'s loaded "
                  f"program differs from the eager forward (max {gap:.3g})")
            held = "output bit for bit"
        else:
            scale = want.float().abs().max().item()
            check(gap <= F32_TOL * scale, f"jit_save: {what}'s loaded "
                  f"program is {gap:.3g} from the eager forward (largest "
                  f"|output| {scale:.3g}, tol {F32_TOL} of it)")
            again = net(x)
            held = (f"output within {gap:.3g} of the eager forward's "
                    f"(largest |output| {scale:.3g}; eager twice bit for "
                    f"bit: {torch.equal(again, want)}, loaded twice: "
                    f"{torch.equal(loaded(x), got)})")
        ms_loaded = time_ms(lambda: loaded(x), iters)
        ms_eager = time_ms(lambda: net(x), iters)
    log(f"[jit_save] {what} {tuple(x.shape)} {str(x.dtype)[6:]} ({card}): "
        f"save {t_save:.2f} s ({size / 2**20:.1f} MiB), load "
        f"{t_load:.2f} s; program ops {ops}; loaded {ms_loaded:.3f} ms a "
        f"call, eager forward {ms_eager:.3f} ms; {held}; launches a call "
        f"{json.dumps(per)}")
    return counts


def phase_jit_save(card):
    """37. jit_save: `jit.save` -> `jit.load` of ResNet-50 (f32, input
    spec [8, 3, 224, 224]) and of a GPT-125M forward (bf16, [1, 1024]
    int64), both at full width, then of `llama_tiny` and a narrow Swin-T
    (SWIN_NARROW, 56²): each loaded program's output equals the eager
    model's bit for bit on the card (Swin's within F32_TOL of its largest
    output, the gap logged), its exported graph holds the
    ``paddle_tpu_torch::`` nodes (conv_bn_act, flash_fwd, rope,
    window_attention) and launches them (ResNet-50 49 conv_bn_act, GPT
    12 flash_fwd, llama_tiny 2 rope, Swin 4 window_attention a call);
    the loaded program's ms a call beside the eager forward's.  Returns
    the summed launch counts of the loaded programs' checked calls."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.vision import models as V

    total = dict.fromkeys(K.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    rs = np.random.RandomState(SEED + 4)
    net = _vision_model("resnet50", "cuda", torch.float32)
    x = torch.from_numpy(rs.randn(8, 3, 224, 224).astype(np.float32)).cuda()
    add(_jit_round_trip(card, "resnet50", net, x, ["conv_bn_act"],
                        {"conv_bn_act": 49}))
    del net
    _release_card()
    net = GPTForCausalLM(_hapi_cfg(), device="cuda", dtype=torch.bfloat16,
                         seed=SEED)
    ids = torch.from_numpy(rs.randint(0, 50304, (1, 1024)).astype(
        np.int64)).cuda()
    add(_jit_round_trip(card, "gpt125m", net, ids, ["flash_fwd"],
                        {"flash_fwd": 12}))
    del net
    _release_card()
    net = LlamaForCausalLM(llama_tiny(), device="cuda", seed=SEED)
    ids = torch.from_numpy(rs.randint(0, net.cfg.vocab_size, (2, 64))
                           .astype(np.int64)).cuda()
    add(_jit_round_trip(card, "llama_tiny", net, ids, ["flash_fwd", "rope"],
                        {"flash_fwd": net.cfg.num_layers,
                         "rope": net.cfg.num_layers}))
    net = V.SwinTransformer(**SWIN_NARROW, device="cuda", seed=SEED)
    x = torch.from_numpy(rs.randn(2, 3, 56, 56).astype(np.float32)).cuda()
    # the patch embedding is a cuDNN convolution, outside the kernels:
    # held to the f32 tolerance, its gap logged
    add(_jit_round_trip(card, "swin_narrow", net, x, ["window_attention"],
                        {"window_attention": sum(SWIN_NARROW["depths"])},
                        exact=False))
    del net
    _release_card()
    return total



# ------------------------------------------------------- phases 38 - 41
SERVE_REQUESTS = 32      # phase 40: /predict requests of a batch of 8
FLEET_SEQ = 128          # phase 41: the replicas' saved ids [1, 128]


def _counts_add(total, counts):
    for k, v in counts.items():
        total[k] += v


def _record(model, shape, dtype, tail=None):
    """`model` recorded as a static Program on `static.data("x", shape,
    dtype)` (then `tail` of its output, recorded too): (program, feed
    Variable, fetch Variable, record seconds).  Recording launches
    nothing."""
    import paddle_tpu_torch as PT
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import kernels as K

    prog = static.Program()
    K.reset_launches()
    t0 = time.perf_counter()
    PT.enable_static()
    try:
        with static.program_guard(prog):
            x = static.data("x", shape, dtype)
            y = model(x)
            if tail is not None:
                y = tail(y)
    finally:
        PT.disable_static()
    t = time.perf_counter() - t0
    check(not any(K.launch_counts().values()),
          f"static_program: recording launched {K.launch_counts()}")
    return prog, x, y, t


def _per_call(counts, calls, want, what):
    per = {k: v / calls for k, v in counts.items() if v}
    check(per == want, f"{what}: launches a call {json.dumps(per)}, "
          f"expected {want}")
    return per


def _static_cases(torch):
    """(name, model, the fed tensor, its declared shape and dtype name,
    the launches one call makes) of phases 38-40: gpt_1p3b bf16 on
    [8, 1024] ids, ResNet-50 f32 and bf16 on [8, 3, 224, 224]."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b

    rs = np.random.RandomState(SEED + 6)
    cfg = gpt_1p3b()
    gpt = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                         seed=SEED)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (8, 1024))
                           .astype(np.int64)).cuda()
    imgs = torch.from_numpy(rs.randn(8, 3, 224, 224).astype(
        np.float32)).cuda()
    out = [("gpt_1p3b bf16", gpt, ids, "int64",
            {"flash_fwd": cfg.num_layers})]
    for dtype in (torch.float32, torch.bfloat16):
        net = _vision_model("resnet50", "cuda", dtype)
        out.append((f"resnet50 {_dn(dtype)}", net, imgs.to(dtype),
                    str(dtype).split(".")[1], {"conv_bn_act": 49}))
    return out


def phase_static_program(card, cases):
    """38. static_program: each case (gpt_1p3b bf16 at full width, 24
    layers, seeded, on `static.data("x", [8, 1024], "int64")`; ResNet-50
    f32 and bf16 on [8, 3, 224, 224]) recorded as a static Program (no
    launch while recording), then `static.Executor()` on the card: its
    first run (the eager warm-up of the capture) and two graph replays
    each equal the eager forward bit for bit, 24 flash_fwd or 49
    conv_bn_act launches a call; ms a call of the eager forward, the
    Executor's first run and its replay.  Returns the programs (for
    phases 39-40) and the launch counts of the checked runs."""
    import torch

    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import kernels as K

    total = dict.fromkeys(K.KERNELS, 0)
    programs = []
    exe = static.Executor()
    for name, model, x, dtype, want in cases:
        with torch.no_grad():
            eager = model(x)
            ms_eager = time_ms(lambda: model(x), iters=5)
        prog, fx, fy, t_rec = _record(model, list(x.shape), dtype)
        feed = {"x": x}
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        (first,) = exe.run(prog, feed=feed, fetch_list=[fy],
                           return_numpy=False)
        torch.cuda.synchronize()
        ms_first = (time.perf_counter() - t0) * 1e3
        outs = [first]
        for _ in range(2):
            outs += exe.run(prog, feed=feed, fetch_list=[fy],
                            return_numpy=False)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        _per_call(counts, 3, want, f"static_program {name}")
        _counts_add(total, counts)
        for i, o in enumerate(outs):
            check(torch.equal(o, eager), f"static_program {name}: run {i} "
                  f"(0 eager, then replays) differs from the eager forward "
                  f"(max {(o.float() - eager.float()).abs().max().item():.3g})")
        ms_replay = time_ms(lambda: exe.run(prog, feed=feed, fetch_list=[fy],
                                            return_numpy=False), iters=5)
        log(f"[static_program] {name} {tuple(x.shape)} ({card}): "
            f"{len(prog.ops)} recorded ops, {len(prog.captures)} captures, "
            f"recorded in {t_rec:.2f} s with no launch; eager forward "
            f"{ms_eager:.3f} ms, Executor first run (eager warm-up + "
            f"capture) {ms_first:.1f} ms, replay {ms_replay:.3f} ms a call; "
            f"first run and replays bit for bit the eager forward; "
            f"launches a call {json.dumps(want)}")
        programs.append((name, model, x, prog, fx, fy, want, ms_eager))
        del eager, outs, first
    del exe
    _release_card()
    return programs, total


def _saved(prefix, prog, fx, fy):
    """save_inference_model of `prog`: (seconds, .pdmodel and .pdiparams
    bytes)."""
    from paddle_tpu_torch import static

    t0 = time.perf_counter()
    static.save_inference_model(prefix, [fx], [fy], program=prog)
    t = time.perf_counter() - t0
    return t, os.path.getsize(prefix + ".pdmodel"), \
        os.path.getsize(prefix + ".pdiparams")


def phase_saved_model(card, programs):
    """39. saved_model: `save_inference_model` -> `create_predictor(
    Config(prefix))` of each phase-38 program: `Predictor.run` (its first
    run, the capture's warm-up, and a replay) equals `Executor.run` bit
    for bit, with the same launches; `.pdmodel` / `.pdiparams` bytes, save
    and load seconds, the predictor's ms a call beside the eager
    forward's.  Then ResNet-50 f32 recorded on [-1, 3, 224, 224] and
    saved with a dynamic batch: the predictor at batches 1, 8 and 32
    (each a graph of its own) equals the eager forward bit for bit, 49
    conv_bn_act a call; and the C ABI (`PD_PredictorCreate` /
    `PD_PredictorRun` through ctypes, the library built with g++) on the
    ResNet-50 f32 program equals the Predictor bit for bit.  Returns the
    ResNet-50 f32 prefix's directory and prefix, and the launch
    counts."""
    import ctypes

    import torch

    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch import static
    from paddle_tpu_torch.native import capi
    from paddle_tpu_torch.ops import kernels as K

    total = dict.fromkeys(K.KERNELS, 0)
    d = _tmpdir("saved")
    exe = static.Executor()
    keep = None
    for name, model, x, prog, fx, fy, want, ms_eager in programs:
        prefix = os.path.join(d, name.replace(" ", "_"))
        t_save, n_model, n_params = _saved(prefix, prog, fx, fy)
        (ref,) = exe.run(prog, feed={"x": x}, fetch_list=[fy],
                         return_numpy=False)
        t0 = time.perf_counter()
        pred = TI.create_predictor(TI.Config(prefix))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        (fin,) = pred.get_input_names()
        (fout,) = pred.get_output_names()
        pred.get_input_handle(fin).copy_from_cpu(x)
        K.reset_launches()
        outs = []
        for _ in range(2):
            pred.run()
            outs.append(pred.get_output_handle(fout)._value)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        _per_call(counts, 2, want, f"saved_model {name}")
        _counts_add(total, counts)
        for i, o in enumerate(outs):
            check(torch.equal(o, ref), f"saved_model {name}: Predictor run "
                  f"{i} differs from Executor.run")
        ms_pred = time_ms(pred.run, iters=5)
        log(f"[saved_model] {name} ({card}): .pdmodel "
            f"{n_model / 2**20:.2f} MiB, .pdiparams {n_params / 2**20:.1f} "
            f"MiB, save {t_save:.2f} s, create_predictor {t_load:.2f} s; "
            f"Predictor.run {ms_pred:.3f} ms a call beside the eager "
            f"forward's {ms_eager:.3f} ms; first run and replay bit for bit "
            f"Executor.run; launches a call {json.dumps(want)}")
        if name == "resnet50 f32":
            keep = (prefix, model, x, pred)
        else:
            del pred
        del ref, outs
        _release_card()
    # the dynamic batch
    prefix, model, x, pred = keep
    dprog, dx, dy, _ = _record(model, [-1, 3, 224, 224], "float32")
    dprefix = prefix + "_dyn"
    t_save, n_model, _ = _saved(dprefix, dprog, dx, dy)
    dpred = TI.create_predictor(TI.Config(dprefix))
    check(dpred.input_specs()["x"][0] == [-1, 3, 224, 224],
          f"saved_model: the dynamic program takes "
          f"{dpred.input_specs()['x']}")
    rs = np.random.RandomState(SEED + 7)
    sizes = []
    for b in (1, 8, 32):
        xb = torch.from_numpy(rs.randn(b, 3, 224, 224).astype(
            np.float32)).cuda()
        with torch.no_grad():
            eager = model(xb)
        K.reset_launches()
        (o,) = dpred._prog.run_tensors([xb])
        (o2,) = dpred._prog.run_tensors([xb])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        _per_call(counts, 2, {"conv_bn_act": 49}, f"saved_model batch {b}")
        _counts_add(total, counts)
        check(torch.equal(o, eager) and torch.equal(o2, eager),
              f"saved_model: the dynamic-batch program at batch {b} differs "
              f"from the eager forward (max "
              f"{(o - eager).abs().max().item():.3g})")
        sizes.append((b, time_ms(lambda: dpred._prog.run_tensors([xb]),
                                 iters=5)))
    log(f"[saved_model] resnet50 f32 [-1, 3, 224, 224] ({card}): saved in "
        f"{t_save:.2f} s (.pdmodel {n_model / 2**20:.2f} MiB, one Dim); "
        f"batches 1 / 8 / 32 each bit for bit the eager forward, 49 "
        f"conv_bn_act a call; ms a call "
        + ", ".join(f"B{b} {ms:.3f}" for b, ms in sizes))
    del dpred
    # the C ABI on the f32 program
    lib = capi.load()
    h = lib.PD_PredictorCreate(prefix.encode())
    check(h > 0, f"capi: PD_PredictorCreate: {lib.PD_LastError()}")
    xs = x.cpu().numpy()
    (want_np,) = pred.run([xs])
    td = capi.np_to_td(xs)
    outs = (capi.PD_TensorData * 2)()
    K.reset_launches()
    got = []
    for _ in range(2):
        n = lib.PD_PredictorRun(h, ctypes.byref(td), 1, outs, 2)
        check(n == 1, f"capi: PD_PredictorRun gave {n}: "
              f"{lib.PD_LastError()}")
        got.append(capi.td_to_np(outs[0]))
        lib.PD_ReleaseOutputs(outs, n)
    counts = K.launch_counts()
    _per_call(counts, 2, {"conv_bn_act": 49}, "saved_model C ABI")
    _counts_add(total, counts)
    for i, g in enumerate(got):
        check(g.dtype == want_np.dtype and np.array_equal(g, want_np),
              f"capi: run {i} differs from Predictor.run")
    t0 = time.perf_counter()
    for _ in range(5):
        lib.PD_PredictorRun(h, ctypes.byref(td), 1, outs, 2)
        lib.PD_ReleaseOutputs(outs, 1)
    ms_c = (time.perf_counter() - t0) / 5 * 1e3
    check(lib.PD_PredictorDestroy(h) == 1, "capi: PD_PredictorDestroy")
    log(f"[saved_model] C ABI on resnet50 f32 ({card}): PD_PredictorRun "
        f"bit for bit Predictor.run ({want_np.shape} {want_np.dtype}), "
        f"{ms_c:.3f} ms a call host to host; 49 conv_bn_act a call")
    del pred, exe
    _release_card()
    return (d, prefix), total


def phase_saved_model_serve(card, saved):
    """40. saved_model_serve: `InferenceServer(model_path=)` of phase 39's
    ResNet-50 f32 program over HTTP on 127.0.0.1: SERVE_REQUESTS
    `/predict` requests of a seeded batch of 8 each equal an in-process
    `Predictor.run` of the same batch bit for bit, 49 conv_bn_act a
    request; p50 / p99 request ms, the in-process call's ms and the
    server's added ms.  Returns the launch counts."""
    import torch

    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch.inference import serving as S
    from paddle_tpu_torch.ops import kernels as K

    _, prefix = saved
    rs = np.random.RandomState(SEED + 8)
    batches = [rs.randn(8, 3, 224, 224).astype(np.float32)
               for _ in range(SERVE_REQUESTS)]
    pred = TI.create_predictor(TI.Config(prefix))
    want = [pred.run([b])[0] for b in batches]
    inproc = []
    for b in batches[:8]:
        t0 = time.perf_counter()
        pred.run([b])
        inproc.append((time.perf_counter() - t0) * 1e3)
    srv = S.InferenceServer(model_path=prefix)
    srv.start()
    try:
        cli = S.InferenceClient(srv.address, timeout=120, retries=0)
        cli.predict(x=batches[0])     # the server's predictor captures
        torch.cuda.synchronize()
        K.reset_launches()
        ms = []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            got = cli.predict(x=b)
            ms.append((time.perf_counter() - t0) * 1e3)
            (out,) = got.values()
            check(np.array_equal(out, want[i]), f"saved_model_serve: "
                  f"request {i} differs from Predictor.run")
        counts = K.launch_counts()
    finally:
        srv.shutdown()
    _per_call(counts, SERVE_REQUESTS, {"conv_bn_act": 49},
              "saved_model_serve")
    p50, p99 = _pct(ms, 0.5), _pct(ms, 0.99)
    base = float(np.median(inproc))
    log(f"[saved_model_serve] resnet50 f32 B8 over HTTP ({card}): "
        f"{SERVE_REQUESTS} /predict requests bit for bit Predictor.run; "
        f"request p50 {p50:.2f} ms, p99 {p99:.2f} ms; in-process "
        f"Predictor.run (numpy in and out) {base:.2f} ms; the server adds "
        f"{p50 - base:.2f} ms at p50; 49 conv_bn_act a request")
    del pred
    _release_card()
    return counts


def phase_fleet_model(card, saved):
    """41. fleet_model: gpt_1p3b (full width, 24 layers, bf16, seeded)
    recorded on [1, FLEET_SEQ] ids with the last position's logits in f32
    as its fetch (``logits[:, -1].float()``, recorded in the Program) and
    saved; a `ReplicaFleet` of two ``kind="model"`` replicas on the card
    behind the `Router`: each warms up at the saved signature before it
    announces (lifecycle phases logged, spawn -> routable ms); `/predict`
    through the router equals an in-process predictor bit for bit; one
    replica killed with SIGKILL is relaunched by the monitor (kill ->
    routable again: the heal ms); a drained replica exits 0.  Returns the
    replicas' launch counts over the routed requests (24 flash_fwd a
    run, from their /debug/telemetry)."""
    import shutil

    import torch

    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch.inference import fleet as FL
    from paddle_tpu_torch.inference.serving import InferenceClient
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.ops import kernels as K

    d, _ = saved
    cfg = gpt_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    prog, fx, fy, _ = _record(model, [1, FLEET_SEQ], "int64",
                              tail=lambda y: y[:, -1].float())
    prefix = os.path.join(d, "gpt_1p3b_last")
    t_save, n_model, n_params = _saved(prefix, prog, fx, fy)
    del model, prog, fx, fy
    _release_card()
    rs = np.random.RandomState(SEED + 9)
    reqs = [rs.randint(0, cfg.vocab_size, (1, FLEET_SEQ)).astype(np.int64)
            for _ in range(4)]
    pred = TI.create_predictor(TI.Config(prefix))
    want = [pred.run([r])[0] for r in reqs]
    check(want[0].shape == (1, cfg.vocab_size)
          and want[0].dtype == np.float32
          and all(np.isfinite(w).all() for w in want),
          f"fleet_model: in-process fetch {want[0].shape} {want[0].dtype}")
    del pred
    _release_card()
    t0 = time.perf_counter()
    fleet = FL.ReplicaFleet(num_replicas=2, kind="model", model_path=prefix,
                            launch_timeout=300)
    counts = dict.fromkeys(K.KERNELS, 0)
    try:
        fleet.start(ready_timeout=300)
        t_up = time.perf_counter() - t0
        cli = InferenceClient(fleet.router.address, timeout=120, retries=2)
        for rnd in range(2):
            for i, r in enumerate(reqs):
                (out,) = cli.predict(x=r).values()
                check(np.array_equal(out, want[i]), f"fleet_model: round "
                      f"{rnd} request {i} through the router differs from "
                      "the in-process predictor")
        runs = 0
        for h in list(fleet._handles.values()):
            code, snap = _get_json(h.address + "/debug/telemetry")
            check(code == 200 and "kernels" in snap,
                  f"replica {h.rid}: /debug/telemetry {code}")
            k = snap["kernels"]
            check(k["launches"]["flash_fwd"] == cfg.num_layers
                  * k["predictor_runs"]
                  and sum(k["launches"].values())
                  == k["launches"]["flash_fwd"],
                  f"replica {h.rid}: launches {k}")
            runs += k["predictor_runs"]
            _counts_add(counts, k["launches"])
        check(runs == 2 * len(reqs), f"fleet_model: {runs} replica runs")
        view = fleet.lifecycle.fleet_view()["records"]
        for rec in view:
            rep = rec.get("replica") or {}
            ph = rep.get("phases", {})
            check(ph["warmup"]["mono_ms"] <= ph["announce"]["mono_ms"],
                  f"replica {rec['rid']}: lifecycle {rep}")
            sup = rec.get("supervisor_ms", {})
            log(f"[fleet_model] replica {rec['rid']} ({card}): spawn -> "
                f"announce {sup.get('announce', float('nan')):.1f} ms, -> "
                f"first probe up "
                f"{sup.get('first_probe_up', float('nan')):.1f} ms; "
                f"phases (ms) " + json.dumps(
                    {k: round(v, 1) for k, v in
                     rep.get("durations_ms", {}).items()}))
        # kill -9 one replica: the monitor relaunches it
        victim = fleet._handles[0]
        proc = victim.proc
        t1 = time.perf_counter()
        fleet.kill_replica(victim.rank)
        proc.wait(timeout=60)
        deadline = time.monotonic() + 300
        while not any(ev["kind"] == "replica_relaunched"
                      for ev in fleet.events):
            check(time.monotonic() < deadline, f"fleet_model: the killed "
                  f"replica was not relaunched: {fleet.describe()}")
            time.sleep(0.05)
        check(fleet.wait_ready(n=2, timeout=300), f"fleet_model: the "
              f"relaunched replica is not routable: {fleet.describe()}")
        t_heal = time.perf_counter() - t1
        (out,) = cli.predict(x=reqs[0]).values()
        check(np.array_equal(out, want[0]), "fleet_model: after the heal "
              "the router's answer differs")
        # drain the other replica: it exits 0
        fleet.drain_replica(fleet._handles[1].rank, grace=60.0)
        deadline = time.monotonic() + 120
        while not any(ev["kind"] == "replica_exit" and ev.get("drained")
                      for ev in fleet.events):
            check(time.monotonic() < deadline, "fleet_model: the drained "
                  "replica never exited")
            time.sleep(0.05)
        rc = [ev["rc"] for ev in fleet.events
              if ev["kind"] == "replica_exit" and ev.get("drained")]
        check(rc == [0], f"fleet_model: the drained replica exited {rc}")
    finally:
        fleet.stop()
        shutil.rmtree(d, ignore_errors=True)
    log(f"[fleet_model] gpt_1p3b bf16 saved on [1, {FLEET_SEQ}] ids, fetch "
        f"logits[:, -1] f32 ({card}): save {t_save:.1f} s (.pdmodel "
        f"{n_model / 2**20:.2f} MiB, .pdiparams {n_params / 2**20:.0f} MiB); "
        f"2 model replicas spawn -> routable {t_up * 1e3:.1f} ms; "
        f"{2 * len(reqs)} routed /predict bit for bit the in-process "
        f"predictor, {cfg.num_layers} flash_fwd a run; kill -9 -> routable "
        f"again (heal) {t_heal * 1e3:.1f} ms; the drained replica exited 0")
    _release_card()
    return counts


# ------------------------------------------------------ phases 42-46
TRANSFORMER_VOCAB, TRANSFORMER_PAD, TRANSFORMER_BOS = 37000, 0, 1
TRANSFORMER_STEPS = 5
DECODE_SOURCES, DECODE_SRC, DECODE_STEPS = 8, 128, 64


def _seq2seq(layers=(6, 6), dropout=0.1, device="cuda", seed=SEED,
             max_len=512):
    """Transformer-base as the port's `nn` builds it (Vaswani et al. 2017,
    WMT14 En-De, shared BPE): one `nn.Embedding(37000, 512)` for source
    and target (N(0, 512^-0.5) through a `ParamAttr`, the pad row zero)
    scaled by sqrt(512), sinusoid positions, `nn.Transformer` at its
    defaults (`layers` cut for the parity and the CPU), and a 37000-way
    `nn.Linear`."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import initializer as I

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(seed)
            kw = dict(device=device, generator=gen)
            d = 512
            self.embed = nn.Embedding(
                TRANSFORMER_VOCAB, d, padding_idx=TRANSFORMER_PAD,
                weight_attr=nn.ParamAttr(initializer=I.Normal(0.0,
                                                              d ** -0.5)),
                **kw)
            self.transformer = nn.Transformer(
                d, 8, layers[0], layers[1], 2048, dropout, **kw)
            self.out = nn.Linear(d, TRANSFORMER_VOCAB, **kw)
            pos = torch.arange(max_len, dtype=torch.float32)[:, None]
            inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                            * (-math.log(10000.0) / d))
            table = torch.zeros(max_len, d)
            table[:, 0::2], table[:, 1::2] = (torch.sin(pos * inv),
                                              torch.cos(pos * inv))
            self.register_buffer("pos", table.to(device), persistable=False)
            self.scale = d ** 0.5

        def _embed(self, ids, start=0):
            x = self.embed(ids) * self.scale
            return x + self.pos[start:start + ids.shape[1]].to(x.dtype)

        def encode(self, src, src_mask):
            return self.transformer.encoder(self._embed(src), src_mask)

        def forward(self, src, tgt, src_mask, tgt_mask):
            memory = self.encode(src, src_mask)
            h = self.transformer.decoder(self._embed(tgt), memory, tgt_mask,
                                         src_mask)
            return self.out(h)

    return Seq2Seq()


def _seq2seq_batch(batch, src, tgt, seed=SEED):
    """Seeded token ids: source lengths in [src / 2, src], target
    lengths in [tgt / 2, tgt], padded with the pad id; the labels are
    the next target tokens (pad past each length: ignored).  Returns
    (src, tgt, labels, [B, 1, 1, src] pad mask) as numpy."""
    rs = np.random.RandomState(seed)
    v, pad = TRANSFORMER_VOCAB, TRANSFORMER_PAD
    sl = rs.randint(src // 2, src + 1, batch)
    tl = rs.randint(tgt // 2, tgt + 1, batch)
    s = rs.randint(2, v, (batch, src)).astype(np.int64)
    t = rs.randint(2, v, (batch, tgt + 1)).astype(np.int64)
    s[np.arange(src)[None] >= sl[:, None]] = pad
    t[np.arange(tgt + 1)[None] > tl[:, None]] = pad
    mask = np.where(np.arange(src)[None] < sl[:, None], 0.0, -1e9) \
        .astype(np.float32).reshape(batch, 1, 1, src)
    return s, t[:, :-1].copy(), t[:, 1:].copy(), mask


def _seq2seq_steps(model, opt, batch, steps, cast, device, grads=None):
    """`steps` AdamW steps of label-smoothed CE (ignore the pad) on one
    batch under ``amp.auto_cast(**cast)`` (none: f32); `grads`, a list,
    receives the first step's gradients on the CPU by parameter name.
    Returns (the losses, the seconds of the steps after the first, the
    launch counts of those steps)."""
    import torch

    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.ops import kernels as K

    src, tgt, labels, mask = (torch.from_numpy(a).to(device) for a in batch)
    tmask = nn.Transformer.generate_square_subsequent_mask(
        tgt.shape[1], device=device)
    crit = nn.CrossEntropyLoss(ignore_index=TRANSFORMER_PAD,
                               label_smoothing=0.1)
    losses, t0 = [], None
    for i in range(steps):
        if i == 1 and device != "cpu":
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
        with amp.auto_cast(**cast) if cast else contextlib.nullcontext():
            loss = crit(model(src, tgt, mask, tmask), labels)
        loss.backward()
        if i == 0 and grads is not None:
            grads.append({n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()
                          if p.grad is not None})
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0 if t0 is not None else 0.0
    return (torch.stack(losses).float().cpu().numpy(), dt,
            K.launch_counts())


def phase_transformer_train(card, steps=TRANSFORMER_STEPS):
    """42. Transformer-base built from the port's `nn` (`_seq2seq`):
    first the same model cut to 2 + 2 layers in f32 (TF32 off, no
    dropout), 3 AdamW steps on the card and on the CPU from one set of
    weights at B2, sources 32 / targets 24 (losses within 1e-5, every
    parameter's first gradient within 2e-5 of its largest CPU value, the
    key biases' under 1e-6 of the largest gradient, 6 + 6 flash
    launches a step); then full depth (6 + 6), dropout 0.1, bf16
    O2 through `amp.decorate` (AdamW multi_precision, lr 3e-4),
    `CrossEntropyLoss(ignore_index=pad, label_smoothing=0.1)`, B64 with
    source lengths 128-256 under a [B, 1, 1, 256] pad mask and target
    lengths 96-192 under `generate_square_subsequent_mask(192)`: `steps`
    timed steps after one warm-up on a repeated batch, tokens/s (source
    and target slots, and the real tokens), ms/step, peak memory;
    exactly 18 flash_fwd and 18 flash_bwd a step (6 encoder self, 6
    decoder self, 6 cross attentions, all on the biased tier); the loss
    finite and falling.  Returns the full run's launch counts."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    batch = _seq2seq_batch(2, 32, 24, seed=SEED + 1)
    cpu = _seq2seq((2, 2), 0.0, "cpu")
    gpu = _seq2seq((2, 2), 0.0, "cuda")
    gpu.set_state_dict(cpu.state_dict())
    g_card, g_cpu = [], []
    lg, _, counts = _seq2seq_steps(
        gpu, AdamW(learning_rate=1e-4, parameters=gpu.parameters()), batch,
        3, None, "cuda", g_card)
    lc, _, _ = _seq2seq_steps(
        cpu, AdamW(learning_rate=1e-4, parameters=cpu.parameters()), batch,
        3, None, "cpu", g_cpu)
    gap = float(np.abs(lg - lc).max())
    check(np.isfinite(lg).all() and gap <= 1e-5,
          f"transformer parity: card {lg.tolist()} cpu {lc.tolist()}, gap "
          f"{gap:.3g} > 1e-5")
    # every parameter's first gradient, relative to its largest CPU
    # value: a wrong dQ, dK or dV in any attention shows here.  The key
    # projections' biases have a zero gradient in exact arithmetic (a
    # softmax over keys ignores a shift shared by all of them), so they
    # are held to rounding noise against the largest gradient instead
    check(g_card[0].keys() == g_cpu[0].keys(),
          "transformer parity: the card and the CPU differ in which "
          "parameters have gradients")
    top = max(c.abs().max().item() for c in g_cpu[0].values())
    kbias = {n: max(g_card[0][n].abs().max().item(),
                    c.abs().max().item()) / top
             for n, c in g_cpu[0].items() if n.endswith("k_proj.bias")}
    check(kbias and max(kbias.values()) <= 1e-6,
          f"transformer parity: key-bias gradients not at noise "
          f"{json.dumps(kbias)}")
    rel = {n: ((g_card[0][n] - c).abs().max() / c.abs().max()).item()
           for n, c in g_cpu[0].items() if n not in kbias}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 2e-5, f"transformer parity: gradient {worst} card "
          f"vs CPU {rel[worst]:.3g} > 2e-5")
    attn = max(v for n, v in rel.items() if "attn" in n)
    per = {k: v / 2 for k, v in counts.items() if v}
    check(per.get("flash_fwd") == 6 and per.get("flash_bwd") == 6,
          f"transformer parity: launches a step {json.dumps(per)}")
    log(f"[transformer_train] parity f32 2+2 layers B2 S32/24, 3 AdamW "
        f"steps: card {lg.tolist()} cpu {lc.tolist()} max gap {gap:.3g} "
        f"(tol 1e-5); first-step gradients of {len(rel)} parameters, "
        f"largest relative gap {rel[worst]:.3g} ({worst}; attention "
        f"projections {attn:.3g}; tol 2e-5), the {len(kbias)} key "
        f"biases' (zero in exact arithmetic) at most "
        f"{max(kbias.values()):.3g} of the largest gradient (tol 1e-6); "
        f"launches a step {json.dumps(per)}")
    del cpu, gpu
    _release_card()
    torch.backends.cuda.matmul.allow_tf32 = True
    b, sl, tl = TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT
    batch = _seq2seq_batch(b, sl, tl)
    model = _seq2seq()
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    model.train()
    losses, dt, counts = _seq2seq_steps(
        model, opt, batch, steps + 1, dict(level="O2", dtype="bfloat16"),
        "cuda")
    peak = torch.cuda.max_memory_allocated()
    per = {k: v / steps for k, v in counts.items() if v}
    check(per.get("flash_fwd") == 18 and per.get("flash_bwd") == 18,
          f"transformer_train: launches a step {json.dumps(per)}, expected "
          f"18 flash_fwd and 18 flash_bwd")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"transformer_train: losses {losses.tolist()}")
    slots = b * (sl + tl)
    real = int((batch[0] != TRANSFORMER_PAD).sum()
               + (batch[1] != TRANSFORMER_PAD).sum())
    log(f"[transformer_train] Transformer-base 6+6 d512 h8 ffn2048 vocab "
        f"{TRANSFORMER_VOCAB} ({n_params / 1e6:.1f}M parameters) bf16 O2 "
        f"B{b} src {sl} tgt {tl} ({card}): {slots * steps / dt:.1f} token "
        f"slots/s ({real * steps / dt:.1f} real tokens/s), "
        f"{dt / steps * 1e3:.2f} ms/step, peak memory "
        f"{peak / 2**30:.2f} GiB; losses {losses.tolist()}; launches a "
        f"step {json.dumps(per)}")
    del model, opt
    _release_card()
    return counts


def _greedy(model, src, mask, steps, cached):
    """Greedy decoding from BOS for `steps` tokens: through
    `TransformerDecoder.gen_cache` (one position a step, the memory's
    `StaticCache`), or recomputing the full decoder on the prefix under
    the causal mask each step.  Returns (tokens [B, steps], the last
    step's top-2 logit margins [steps, B], seconds)."""
    import torch

    from paddle_tpu_torch import nn

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        memory = model.encode(src, mask)
        dec = model.transformer.decoder
        seq = torch.full((src.shape[0], 1), TRANSFORMER_BOS,
                         device=src.device)
        cache = dec.gen_cache(memory) if cached else None
        margins = []
        for t in range(steps):
            if cached:
                y = model._embed(seq[:, -1:], t)
                h, cache = dec(y, memory, None, mask, cache)
            else:
                h = dec(model._embed(seq), memory,
                        nn.Transformer.generate_square_subsequent_mask(
                            t + 1, device=src.device), mask)
            logits = model.out(h[:, -1])
            top = logits.topk(2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            seq = torch.cat([seq, logits.argmax(-1, keepdim=True)], 1)
    torch.cuda.synchronize()
    return (seq[:, 1:].cpu().numpy(), torch.stack(margins).cpu().numpy(),
            time.perf_counter() - t0)


def phase_transformer_decode(card):
    """43. Greedy incremental decoding of 8 seeded sources (lengths
    64-128 under a [8, 1, 1, 128] pad mask) for 64 steps through
    `TransformerDecoder.gen_cache` on the Transformer-base of phase 42
    (full depth, seeded, eval) in f32 (TF32 off), against a greedy loop
    that recomputes the full decoder each step: the tokens must be
    equal (a divergence passes only at a top-2 margin below 1e-4 in the
    recomputed loop's logits, and is reported).  12 flash_fwd a cached
    step (6 self-attentions on the unmasked tier, 6 cross-attentions on
    the biased one).  Tokens/s of each.  Returns the cached loop's
    launch counts."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    model = _seq2seq(dropout=0.0).eval()
    s, _, _, m = _seq2seq_batch(DECODE_SOURCES, DECODE_SRC, 8,
                                seed=SEED + 3)
    src, mask = torch.from_numpy(s).cuda(), torch.from_numpy(m).cuda()
    _greedy(model, src, mask, 2, True)        # builds and loads
    K.reset_launches()
    toks, _, dt = _greedy(model, src, mask, DECODE_STEPS, True)
    counts = K.launch_counts()
    full, margins, fdt = _greedy(model, src, mask, DECODE_STEPS, False)
    # the encoder's 6 launches once, then the cached steps'
    per = (counts["flash_fwd"] - 6) / DECODE_STEPS
    check(per == 12, f"transformer_decode: {per} flash_fwd a cached step")
    diverged = np.argwhere(toks != full)
    if len(diverged):
        i, t = (int(x) for x in diverged[0])
        check(margins[t, i] < 1e-4,
              f"transformer_decode: cached tokens leave the recomputed "
              f"ones at source {i} step {t} (margin {margins[t, i]:.3g})")
        log(f"[transformer_decode] near tie: source {i} step {t} margin "
            f"{margins[t, i]:.3g}")
    n = DECODE_SOURCES * DECODE_STEPS
    log(f"[transformer_decode] Transformer-base 6+6 f32 ({card}), "
        f"{DECODE_SOURCES} sources x {DECODE_STEPS} greedy steps: cached "
        f"{n / dt:.1f} tokens/s, recomputed {n / fdt:.1f} tokens/s; "
        f"tokens equal: {not len(diverged)}; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    del model
    _release_card()
    return counts


def _randn(torch, rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


def _ints(torch, a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _layer_cases(torch, nn):
    """(family, name, layer builder, inputs builder) for
    `phase_nn_layers_card`: every layer class of the port's `nn` at a
    small shape; the inputs builder makes the seeded CPU inputs from a
    `np.random.RandomState`."""
    X, SEQ, VOL = (2, 4, 5, 6), (2, 3, 9), (2, 2, 4, 5, 3)
    ids = np.array([[0, 3, 9, 0], [5, 0, 1, 2]])
    lab = np.array([0, 4, 2, 1])

    def randn(rs, *shape):
        return _randn(torch, rs, *shape)

    def shapes(*ss):
        return lambda rs: [randn(rs, *sh) for sh in ss]

    def bits(rs, *shape):
        return torch.from_numpy((rs.rand(*shape) > 0.5).astype(np.float32))

    def signs(rs, *shape):
        return torch.from_numpy(np.sign(rs.randn(*shape)).astype(np.float32))

    def unpool(shape, n):
        # distinct flat positions of the unpooled output per (n, c)
        def build(rs):
            k = int(np.prod(shape[2:]))
            idx = np.stack([rs.choice(n, k, replace=False)
                            for _ in range(shape[0] * shape[1])])
            return [randn(rs, *shape), _ints(torch, idx.reshape(shape))]
        return build

    cases = [("activation", n, (lambda n=n: getattr(nn, n)()), shapes(X))
             for n in ("ReLU", "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU",
                       "GELU", "Silu", "Swish", "Mish", "Hardswish",
                       "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
                       "Tanhshrink", "Softsign", "Softplus", "Softmax",
                       "LogSoftmax", "LogSigmoid", "Sigmoid", "Tanh", "GLU",
                       "Maxout", "ThresholdedReLU", "Softmax2D")]
    cases += [
        ("activation", "PReLU", lambda: nn.PReLU(4), shapes(X)),
        ("common", "Linear", lambda: nn.Linear(6, 3), shapes(X)),
        ("common", "Embedding", lambda: nn.Embedding(10, 4, padding_idx=0),
         lambda rs: [_ints(torch, ids)]),
        ("common", "Bilinear", lambda: nn.Bilinear(3, 4, 2),
         shapes((5, 3), (5, 4))),
        ("common", "Flatten", lambda: nn.Flatten(), shapes(X)),
        ("common", "Unflatten", lambda: nn.Unflatten(1, [2, 2]), shapes(X)),
        ("common", "Identity", lambda: nn.Identity(), shapes(X)),
        ("common", "Upsample", lambda: nn.Upsample(size=[7, 9],
                                                   mode="bilinear"),
         shapes(X)),
        ("common", "UpsamplingBilinear2D",
         lambda: nn.UpsamplingBilinear2D(scale_factor=2), shapes(X)),
        ("common", "UpsamplingNearest2D",
         lambda: nn.UpsamplingNearest2D(scale_factor=2), shapes(X)),
        ("common", "Pad1D", lambda: nn.Pad1D(2, mode="reflect"),
         shapes(SEQ)),
        ("common", "Pad2D", lambda: nn.Pad2D([1, 0, 2, 1],
                                             mode="replicate"), shapes(X)),
        ("common", "Pad3D", lambda: nn.Pad3D(1, mode="circular"),
         shapes(VOL)),
        ("common", "ZeroPad2D", lambda: nn.ZeroPad2D([1, 1, 0, 2]),
         shapes(X)),
        ("common", "CosineSimilarity", lambda: nn.CosineSimilarity(2),
         shapes(X, X)),
        ("common", "PairwiseDistance", lambda: nn.PairwiseDistance(),
         shapes(X, X)),
        ("common", "PixelShuffle", lambda: nn.PixelShuffle(2), shapes(X)),
        ("common", "PixelUnshuffle", lambda: nn.PixelUnshuffle(2),
         shapes((2, 3, 4, 6))),
        ("common", "ChannelShuffle", lambda: nn.ChannelShuffle(2),
         shapes(X)),
        ("common", "Unfold", lambda: nn.Unfold([2, 3], paddings=1),
         shapes(X)),
        ("common", "Fold", lambda: nn.Fold([5, 6], 2), shapes((2, 16, 20))),
        ("common", "Dropout", lambda: nn.Dropout(0.3), shapes(X)),
        ("common", "Dropout2D", lambda: nn.Dropout2D(0.3), shapes(X)),
        ("common", "Dropout3D", lambda: nn.Dropout3D(0.3), shapes(VOL)),
        ("common", "AlphaDropout", lambda: nn.AlphaDropout(0.3), shapes(X)),
        ("common", "Sequential", lambda: nn.Sequential(
            nn.Linear(6, 4), nn.ReLU(), nn.Linear(4, 2)), shapes(X)),
        ("common", "LayerList", lambda: nn.Sequential(*nn.LayerList(
            [nn.Linear(6, 4), nn.Tanh()])), shapes(X)),
        ("common", "LayerDict", lambda: nn.Sequential(*nn.LayerDict(
            {"a": nn.Linear(6, 2)}).values()), shapes(X)),
        ("pool", "MaxUnPool1D", lambda: nn.MaxUnPool1D(2),
         unpool((2, 3, 4), 8)),
        ("pool", "MaxUnPool2D", lambda: nn.MaxUnPool2D(2),
         unpool((2, 3, 2, 3), 24)),
        ("pool", "MaxUnPool3D", lambda: nn.MaxUnPool3D(2),
         unpool((1, 2, 1, 2, 2), 32)),
        ("norm", "LayerNorm", lambda: nn.LayerNorm([5, 6]), shapes(X)),
        ("norm", "RMSNorm", lambda: nn.RMSNorm(6), shapes(X)),
        ("norm", "GroupNorm", lambda: nn.GroupNorm(3, 6,
                                                   data_format="NHWC"),
         shapes(X)),
        ("norm", "InstanceNorm1D", lambda: nn.InstanceNorm1D(3),
         shapes(SEQ)),
        ("norm", "InstanceNorm2D", lambda: nn.InstanceNorm2D(4), shapes(X)),
        ("norm", "InstanceNorm3D", lambda: nn.InstanceNorm3D(2),
         shapes(VOL)),
        ("norm", "LocalResponseNorm", lambda: nn.LocalResponseNorm(3),
         shapes(X)),
        ("norm", "SpectralNorm", lambda: nn.SpectralNorm([4, 5, 6], 1, 2),
         shapes((4, 5, 6))),
        ("norm", "BatchNorm1D", lambda: nn.BatchNorm1D(3), shapes(SEQ)),
        ("norm", "BatchNorm2D", lambda: nn.BatchNorm2D(
            6, data_format="NHWC"), shapes(X)),
        ("norm", "BatchNorm3D", lambda: nn.BatchNorm3D(2), shapes(VOL)),
        ("norm", "BatchNorm", lambda: nn.BatchNorm(4), shapes(X)),
        ("norm", "SyncBatchNorm", lambda: nn.SyncBatchNorm(4), shapes(X)),
        ("conv", "Conv1D", lambda: nn.Conv1D(3, 4, 3, 2, 1), shapes(SEQ)),
        ("conv", "Conv2D", lambda: nn.Conv2D(6, 4, 3, padding=1, groups=2,
                                             data_format="NHWC"),
         shapes(X)),
        ("conv", "Conv3D", lambda: nn.Conv3D(2, 3, 2, padding=1),
         shapes(VOL)),
        ("conv", "Conv1DTranspose", lambda: nn.Conv1DTranspose(
            3, 2, 3, stride=2, output_padding=1), shapes(SEQ)),
        ("conv", "Conv2DTranspose", lambda: nn.Conv2DTranspose(
            4, 6, 3, stride=2, padding=1, groups=2), shapes(X)),
        ("conv", "Conv3DTranspose", lambda: nn.Conv3DTranspose(2, 2, 2,
                                                               stride=2),
         shapes(VOL)),
    ]
    for n, args in (("AvgPool1D", (3, 2, 1)), ("AvgPool2D", (2, 1, 1)),
                    ("AvgPool3D", (2,)), ("MaxPool1D", (2,)),
                    ("MaxPool2D", (3, 2, 1)), ("MaxPool3D", (2, 1)),
                    ("AdaptiveAvgPool1D", (4,)), ("AdaptiveAvgPool2D",
                                                  ([3, 4],)),
                    ("AdaptiveAvgPool3D", (2,)), ("AdaptiveMaxPool1D", (4,)),
                    ("AdaptiveMaxPool2D", (2,)), ("AdaptiveMaxPool3D",
                                                  ([3, 2, 1],))):
        shape = SEQ if "1D" in n else VOL if "3D" in n else X
        cases.append(("pool", n, lambda n=n, a=args: getattr(nn, n)(*a),
                      shapes(shape)))
    pair = shapes((4, 3), (4, 3))
    for n, ins in (
            ("MSELoss", pair), ("L1Loss", pair), ("SmoothL1Loss", pair),
            ("CrossEntropyLoss", lambda rs: [randn(rs, 4, 5),
                                             _ints(torch, lab)]),
            ("NLLLoss", lambda rs: [randn(rs, 4, 5), _ints(torch, lab)]),
            ("BCEWithLogitsLoss", lambda rs: [randn(rs, 4, 3),
                                              bits(rs, 4, 3)]),
            ("BCELoss", lambda rs: [torch.sigmoid(randn(rs, 4, 3)),
                                    bits(rs, 4, 3)]),
            ("KLDivLoss", lambda rs: [torch.log_softmax(randn(rs, 4, 3), -1),
                                      torch.softmax(randn(rs, 4, 3), -1)]),
            ("MarginRankingLoss", lambda rs: [randn(rs, 5), randn(rs, 5),
                                              signs(rs, 5)]),
            ("CosineEmbeddingLoss", lambda rs: [randn(rs, 4, 6),
                                                randn(rs, 4, 6),
                                                signs(rs, 4)]),
            ("TripletMarginLoss", shapes((3, 5), (3, 5), (3, 5))),
            ("TripletMarginWithDistanceLoss", shapes((3, 5), (3, 5),
                                                     (3, 5))),
            ("SoftMarginLoss", lambda rs: [randn(rs, 4, 3),
                                           signs(rs, 4, 3)]),
            ("MultiLabelSoftMarginLoss", lambda rs: [randn(rs, 4, 3),
                                                     bits(rs, 4, 3)]),
            ("MultiMarginLoss", lambda rs: [randn(rs, 4, 5),
                                            _ints(torch, lab)]),
            ("HingeEmbeddingLoss", lambda rs: [randn(rs, 4, 3),
                                               signs(rs, 4, 3)]),
            ("PoissonNLLLoss", lambda rs: [randn(rs, 4, 3), torch.from_numpy(
                rs.poisson(2.0, (4, 3)).astype(np.float32))]),
            ("GaussianNLLLoss", lambda rs: [randn(rs, 4, 3), randn(rs, 4, 3),
                                            torch.from_numpy(rs.rand(4, 3)
                                                             .astype(
                                                                 np.float32)
                                                             + 0.1)]),
            ("HSigmoidLoss", lambda rs: [randn(rs, 5, 4),
                                         _ints(torch, [0, 5, 3, 2, 1])]),
            ("CTCLoss", lambda rs: [torch.log_softmax(randn(rs, 8, 2, 5), -1),
                                    _ints(torch, [[1, 2, 3], [4, 4, 1]]),
                                    _ints(torch, [8, 6]),
                                    _ints(torch, [3, 2])]),
            ("RNNTLoss", lambda rs: [randn(rs, 2, 4, 3, 5),
                                     _ints(torch, [[1, 2], [3, 0]]),
                                     _ints(torch, [4, 3]),
                                     _ints(torch, [2, 1])])):
        args = {"HSigmoidLoss": (4, 6)}.get(n, ())
        kw = {"RNNTLoss": dict(fastemit_lambda=0.0)}.get(n, {})
        cases.append(("loss", n, lambda n=n, a=args, k=kw:
                      getattr(nn, n)(*a, **k), ins))
    cases += [
        ("transformer", "MultiHeadAttention",
         lambda: nn.MultiHeadAttention(32, 4), shapes((2, 5, 32))),
        ("transformer", "TransformerEncoderLayer",
         lambda: nn.TransformerEncoderLayer(32, 4, 64, 0.0),
         shapes((2, 5, 32))),
        ("transformer", "TransformerEncoder",
         lambda: nn.TransformerEncoder(nn.TransformerEncoderLayer(
             32, 4, 64, 0.0), 2), shapes((2, 5, 32))),
        ("transformer", "TransformerDecoderLayer",
         lambda: nn.TransformerDecoderLayer(32, 4, 64, 0.0),
         shapes((2, 5, 32), (2, 7, 32))),
        ("transformer", "TransformerDecoder",
         lambda: nn.TransformerDecoder(nn.TransformerDecoderLayer(
             32, 4, 64, 0.0), 2), shapes((2, 5, 32), (2, 7, 32))),
        ("transformer", "Transformer",
         lambda: nn.Transformer(32, 4, 1, 1, 64, 0.0),
         shapes((2, 7, 32), (2, 5, 32))),
        # the recurrent family (returning outputs and states) and the
        # reparametrisations of `nn.utils`
        ("recurrent", "SimpleRNNCell", lambda: nn.SimpleRNNCell(8, 16),
         shapes((4, 8), (4, 16))),
        ("recurrent", "LSTMCell", lambda: nn.LSTMCell(8, 16),
         shapes((4, 8))),
        ("recurrent", "GRUCell", lambda: nn.GRUCell(8, 16),
         shapes((4, 8), (4, 16))),
        ("recurrent", "RNN", lambda: nn.RNN(nn.GRUCell(8, 16),
                                            is_reverse=True),
         shapes((3, 7, 8))),
        ("recurrent", "SimpleRNN", lambda: nn.SimpleRNN(
            8, 16, 2, "bidirect"), shapes((3, 7, 8))),
        ("recurrent", "LSTM", lambda: nn.LSTM(8, 16, 2, time_major=True),
         shapes((7, 3, 8))),
        ("recurrent", "GRU", lambda: nn.GRU(8, 16, 2, "bidirect"),
         shapes((3, 7, 8))),
        ("recurrent", "BiRNN", lambda: nn.BiRNN(nn.LSTMCell(8, 16),
                                                nn.GRUCell(8, 16)),
         shapes((3, 7, 8))),
        ("utils", "weight_norm", lambda: nn.utils.weight_norm(
            nn.Linear(6, 5)), shapes((4, 6))),
        ("utils", "weight_norm_conv", lambda: nn.utils.weight_norm(
            nn.Conv2D(3, 4, 3), dim=1), shapes((2, 3, 7, 7))),
        ("utils", "spectral_norm", lambda: nn.utils.spectral_norm(
            nn.Linear(6, 5)), shapes((4, 6))),
        ("utils", "WeightOnlyLinear", lambda: nn.quant.WeightOnlyLinear
         .from_linear(nn.Linear(64, 16), "int4", 64), shapes((4, 64))),
    ]
    return cases


def _functional_cases(torch):
    """(name, inputs builder, kwargs) for `phase_nn_layers_card`: the
    functionals that no layer of `_layer_cases` calls with these options,
    and the in-place forms (a trailing `_`)."""
    def randn(rs, *shape):
        return _randn(torch, rs, *shape)

    def shapes(*ss, then=()):
        return lambda rs: [randn(rs, *sh) for sh in ss] + list(then)

    def randint(rs, lo, hi, shape):
        return _ints(torch, rs.randint(lo, hi, shape))

    def bits(rs, *shape):
        return (randn(rs, *shape) > 0).float()

    img, vol = (2, 3, 6, 7), (2, 2, 4, 5, 3)
    cases = [
        ("linear", shapes((4, 6), (6, 5), (5,)), {}),
        ("bilinear", shapes((4, 3), (4, 5), (2, 3, 5), (2,)), {}),
        ("embedding", lambda rs: [randint(rs, 0, 10, (3, 5)),
                                  randn(rs, 10, 4)], dict(padding_idx=0)),
        ("pad", shapes(img, then=[[2, 1, 1, 2]]), dict(mode="reflect")),
        ("zeropad2d", shapes(img, then=[[1, 0, 2, 1]]), {}),
        ("unfold", shapes(img, then=[[2, 3]]), dict(paddings=1)),
        ("fold", shapes((2, 12, 20), then=[[5, 6], [2, 2]]), {}),
        ("cosine_similarity", shapes((4, 6), (4, 6)), {}),
        ("pairwise_distance", shapes((4, 6), (4, 6)), {}),
        ("label_smooth", shapes((3, 5)), dict(epsilon=0.2)),
        ("one_hot", lambda rs: [randint(rs, 0, 5, (4,))],
         dict(num_classes=5)),
        ("sequence_mask", lambda rs: [randint(rs, 0, 5, (3,))],
         dict(maxlen=5)),
        ("class_center_sample", lambda rs: [randint(rs, 0, 20, (8,))],
         dict(num_classes=20, num_samples=12)),
        ("normalize", shapes((3, 5)), {}),
        ("temporal_shift", shapes((6, 8, 3, 3)), dict(seg_num=3)),
        ("gather_tree", lambda rs: [randint(rs, 0, 9, (5, 2, 3)),
                                    randint(rs, 0, 3, (5, 2, 3))], {}),
        ("conv1d", shapes((2, 3, 9), (4, 3, 3)), dict(padding="SAME")),
        ("conv2d", shapes(img, (4, 3, 3, 2)), dict(padding=[1, 0, 2, 1])),
        ("conv3d", shapes(vol, (3, 2, 2, 3, 2)), dict(padding=1)),
        ("conv1d_transpose", shapes((2, 3, 9), (3, 4, 3)), dict(stride=2)),
        ("conv2d_transpose", shapes(img, (3, 2, 3, 3)),
         dict(stride=2, padding=1, output_padding=1)),
        ("conv3d_transpose", shapes(vol, (2, 3, 2, 2, 2)), dict(stride=2)),
        ("avg_pool2d", shapes(img, then=[3]), dict(stride=2,
                                                    padding="SAME")),
        ("max_pool2d", shapes(img, then=[2]), dict(return_mask=True)),
        ("max_pool3d", shapes(vol, then=[2]), {}),
        ("adaptive_max_pool2d", shapes(img, then=[[4, 3]]), {}),
        ("group_norm", shapes((2, 6, 4, 3), then=[3]), {}),
        ("instance_norm", shapes(img), {}),
        ("local_response_norm", shapes((2, 7, 3, 3), then=[3]), {}),
        ("layer_norm", shapes(img, then=[[6, 7]]), {}),
        ("interpolate", shapes(img), dict(size=[11, 5], mode="bicubic")),
        ("pixel_shuffle", shapes((2, 8, 3, 3), then=[2]), {}),
        ("channel_shuffle", shapes((2, 6, 2, 3), then=[3]), {}),
        ("affine_grid", shapes((2, 2, 3), then=[[2, 3, 4, 5]]), {}),
        ("grid_sample", shapes(img, (2, 4, 5, 2)), {}),
        ("sparse_attention", lambda rs: [
            randn(rs, 2, 2, 6, 8), randn(rs, 2, 2, 6, 8),
            randn(rs, 2, 2, 6, 8),
            _ints(torch, np.tile(np.arange(0, 13, 2), (2, 2, 1))),
            randint(rs, 0, 6, (2, 2, 12))], {}),
        ("ctc_loss", lambda rs: [
            torch.log_softmax(randn(rs, 8, 2, 5), -1),
            randint(rs, 1, 5, (2, 3)), [8, 6], [3, 2]], {}),
        ("dice_loss", lambda rs: [torch.softmax(randn(rs, 2, 2, 5), -1),
                                  randint(rs, 0, 5, (2, 2, 1))], {}),
        ("sigmoid_focal_loss", lambda rs: [randn(rs, 4, 3),
                                           bits(rs, 4, 3)], {}),
        ("margin_cross_entropy", lambda rs: [torch.tanh(randn(rs, 4, 5)),
                                             randint(rs, 0, 5, (4,))], {}),
        ("npair_loss", lambda rs: [randn(rs, 4, 3), randn(rs, 4, 3),
                                   randint(rs, 0, 3, (4,))], {}),
        ("log_loss", lambda rs: [torch.softmax(randn(rs, 4, 3), -1),
                                 bits(rs, 4, 3)], {}),
        ("square_error_cost", shapes((4, 3), (4, 3)), {}),
        ("gumbel_softmax", shapes((4, 6)), {}),
        ("rrelu", shapes((4, 6)), {}),
        ("flash_attention", shapes((2, 16, 2, 16), (2, 16, 2, 16),
                                   (2, 16, 2, 16)), dict(causal=True)),
    ]
    cases += [(n, shapes((4, 6)), kw) for n, kw in (
        ("relu_", {}), ("elu_", dict(alpha=0.7)), ("hardtanh_", {}),
        ("leaky_relu_", dict(negative_slope=0.2)), ("softmax_", {}),
        ("tanh_", {}), ("thresholded_relu_", dict(threshold=0.3)))]
    return cases


def _in_place(fn, x, *args, **kw):
    """An in-place functional on a copy of `x` (a leaf that requires
    grad cannot be written in place): it must return that copy, written,
    and gradients flow back through it to `x`."""
    y = x * 1.0
    out = fn(y, *args, **kw)
    check(out is y, f"{fn.__name__}: did not return its argument")
    return out


def phase_nn_layers_card():
    """44. nn_layers_card: every layer class of the port's `nn` (the
    layer surface of `_layer_cases`, in training mode where it has one;
    the recurrent family and `nn.utils`' weight and spectral norm and
    an int4 `WeightOnlyLinear` among them)
    and the functionals of `_functional_cases` (the ones no layer calls
    with these options, and the in-place forms, each on a copy it must
    return written) at small seeded shapes, f32 with TF32 off:
    forward and backward on the card against the same call on the CPU
    from the same weights (the layer deep-copied to the card); outputs
    and every floating input's and parameter's gradient within 1e-4
    relative to the largest CPU value.  The random ones (the dropouts,
    RReLU, rrelu, gumbel_softmax) are held to their shape and
    finiteness, the card drawing its own numbers.  Prints how many ran
    and the largest error per family."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import device as D
    from paddle_tpu_torch.nn import functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    random = {"Dropout", "Dropout2D", "Dropout3D", "AlphaDropout", "RReLU",
              "gumbel_softmax", "rrelu"}
    worst, ran = {}, 0

    def flat(out):
        # a recurrent layer returns (output, states), the states nested
        if isinstance(out, (tuple, list)):
            return tuple(t for o in out for t in flat(o))
        return (out,)

    def held(family, name, cpu_out, gpu_out, cpu_in, gpu_in, params):
        nonlocal ran
        outs, gouts = flat(cpu_out), flat(gpu_out)
        err = 0.0
        for c, g in zip(outs, gouts):
            check(tuple(c.shape) == tuple(g.shape),
                  f"nn_layers_card {name}: shape {tuple(g.shape)} vs "
                  f"{tuple(c.shape)}")
            if name in random:
                check(bool(torch.isfinite(g.float()).all()),
                      f"nn_layers_card {name}: non-finite")
                continue
            scale = max(1.0, c.float().abs().max().item())
            err = max(err, (g.float().cpu() - c.float()).abs().max().item()
                      / scale)
        for c, g in list(zip(cpu_in, gpu_in)) + params:
            if name in random or (c.grad is None and g.grad is None):
                continue
            cg = c.grad if c.grad is not None else torch.zeros_like(c)
            gg = g.grad.cpu() if g.grad is not None else torch.zeros_like(c)
            scale = max(1.0, cg.abs().max().item())
            err = max(err, (gg - cg).abs().max().item() / scale)
        check(err <= 1e-4, f"nn_layers_card {family}/{name}: card vs CPU "
              f"{err:.3g} > 1e-4")
        worst[family] = max(worst.get(family, 0.0), err)
        ran += 1

    def run(fn, ins):
        out = fn(*ins)
        outs = flat(out)
        loss = sum((o.float() * (1 + torch.arange(o.numel(), device=o.device)
                                 .reshape(o.shape) % 7)).sum()
                   for o in outs if torch.is_tensor(o)
                   and o.is_floating_point() and o.requires_grad)
        if torch.is_tensor(loss):
            loss.backward()
        return out

    rs = np.random.RandomState(SEED)
    for family, name, build, inputs in _layer_cases(torch, nn):
        cpu_in = inputs(rs)
        prev = D._default
        D.set_device("cpu")       # built on the CPU, then copied over
        try:
            layer = build()
        finally:
            D._default = prev
        card_layer = copy.deepcopy(layer).cuda()
        gpu_in = [x.cuda() for x in cpu_in]
        for x in cpu_in + gpu_in:
            if x.is_floating_point():
                x.requires_grad_()
        co, go = run(layer, cpu_in), run(card_layer, gpu_in)
        params = list(zip(layer.parameters(), card_layer.parameters()))
        held(family, name, co, go, cpu_in, gpu_in, params)
    for name, inputs, kw in _functional_cases(torch):
        cpu_in = inputs(rs)
        gpu_in = [x.cuda() if torch.is_tensor(x) else x for x in cpu_in]
        for x in cpu_in + gpu_in:
            if torch.is_tensor(x) and x.is_floating_point():
                x.requires_grad_()
        fn = getattr(F, name)
        call = (functools.partial(_in_place, fn) if name.endswith("_")
                else fn)
        co = run(lambda *a: call(*a, **kw), cpu_in)
        go = run(lambda *a: call(*a, **kw), gpu_in)
        if name == "flash_attention":
            co, go = co[0], go[0]
        tin = [(c, g) for c, g in zip(cpu_in, gpu_in) if torch.is_tensor(c)]
        held("functional", name, co, go, [c for c, _ in tin],
             [g for _, g in tin], [])
    log(f"[nn_layers_card] {ran} classes and functionals forward + backward "
        f"on the card against the CPU (f32, TF32 off); largest relative "
        f"error by family {json.dumps(worst)}")


def phase_c1_card(card):
    """45. c1_card: (a) a trainable mask's gradient through
    `scaled_dot_product_attention` (the dBias mode, [B, 1, 1, Sk] and
    [B, H, Sq, Sk], bf16 and f32) and through
    `variable_length_memory_efficient_attention` ([B, 1, Sq, Sk] with key
    lengths) on the card against the same calls on the CPU; (b) ROADMAP
    C1.4: a CPU-built static program run by `Executor()` on the card,
    `static.load` of another state after the first run, the next run
    reading it; (c) C1.5: that program fed at a new batch; (d) C1.3:
    `jit.save` of gpt_1p3b (bf16, full depth) writes a .pdmodel of about
    a megabyte beside its .pdparams.  Returns the launch counts of (a)."""
    import torch

    from paddle_tpu_torch import jit, nn, static
    from paddle_tpu_torch import enable_static, disable_static
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(SEED + 45)
    K.reset_launches()
    errs = {}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        td = getattr(torch, dtype)
        for shape in ((4, 1, 1, 96), (4, 8, 80, 96)):
            q = rs.randn(4, 80, 8, 64).astype(np.float32)
            k, v = (rs.randn(4, 96, 8, 64).astype(np.float32)
                    for _ in range(2))
            m = (0.5 * rs.randn(*shape)).astype(np.float32)
            grads = []
            for dev in ("cuda", "cpu"):
                mt = torch.from_numpy(m).to(dev).requires_grad_()
                out = F.scaled_dot_product_attention(
                    *(torch.from_numpy(a).to(dev, td) for a in (q, k, v)),
                    attn_mask=mt)
                out.float().square().sum().backward()
                grads.append(mt.grad.float().cpu())
            err = ((grads[0] - grads[1]).abs().max()
                   / grads[1].abs().max()).item()
            check(err <= tol, f"c1_card sdpa dmask {shape} {dtype}: {err:.3g}")
            errs[f"sdpa {list(shape)} {dtype}"] = err
    q, k, v = (rs.randn(2, 4, 64, 32).astype(np.float32) for _ in range(3))
    m = rs.randn(2, 1, 64, 64).astype(np.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        mt = torch.from_numpy(m).to(dev).requires_grad_()
        out = IF.variable_length_memory_efficient_attention(
            *(torch.from_numpy(a).to(dev) for a in (q, k, v)),
            kv_seq_lens=torch.tensor([64, 40], device=dev), mask=mt,
            causal=True)
        out.square().sum().backward()
        grads.append(mt.grad.cpu())
    err = ((grads[0] - grads[1]).abs().max() / grads[1].abs().max()).item()
    check(err <= F32_TOL, f"c1_card varlen mem-eff dmask: {err:.3g}")
    errs["varlen_mem_eff f32"] = err
    counts = K.launch_counts()
    check(counts["flash_bwd"] == 5, f"c1_card: {counts['flash_bwd']} "
          "flash_bwd launches for 5 trainable-mask backwards")
    # (b), (c): a program built on the CPU, run on the card
    tmp = _tmpdir("c1_card")
    enable_static()
    try:
        x = static.data("x", [2, 4], "float32")
        y = static.nn.fc(x, 3, device="cpu")
    finally:
        disable_static()
    prog = static.default_main_program()
    static.save(prog, os.path.join(tmp, "prog"))
    state = static.load_program_state(os.path.join(tmp, "prog"))
    exe = static.Executor()
    feed = rs.rand(2, 4).astype(np.float32)
    (first,) = exe.run(feed={"x": feed}, fetch_list=[y])
    static.set_program_state(prog, {n: v * 0 + 1 for n, v in state.items()})
    (ones,) = exe.run(feed={"x": feed}, fetch_list=[y])
    check(np.allclose(ones, feed.sum(1, keepdims=True) + 1, atol=1e-5),
          f"c1_card: the loaded state did not reach the card's run {ones}")
    static.load(prog, os.path.join(tmp, "prog"))
    (again,) = exe.run(feed={"x": feed}, fetch_list=[y])
    check(np.array_equal(again, first), "c1_card: static.load did not "
          "bring the saved state back to the card's run")
    wide = rs.rand(3, 4).astype(np.float32)
    (three,) = exe.run(feed={"x": wide}, fetch_list=[y])
    check(three.shape == (3, 3), f"c1_card: a [3, 4] feed gave {three.shape}")
    # (d)
    cfg = gpt_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    t0 = time.perf_counter()
    jit.save(model, os.path.join(tmp, "gpt"),
             input_spec=[torch.zeros(1, 128, dtype=torch.int64,
                                     device="cuda")])
    save_s = time.perf_counter() - t0
    pdmodel = os.path.getsize(os.path.join(tmp, "gpt.pdmodel"))
    pdparams = os.path.getsize(os.path.join(tmp, "gpt.pdparams"))
    check(pdmodel < 16 * 2**20, f"c1_card: gpt_1p3b .pdmodel is "
          f"{pdmodel / 2**20:.1f} MiB")
    del model
    shutil.rmtree(tmp, ignore_errors=True)
    _release_card()
    log(f"[c1_card] ({card}) trainable-mask gradients card vs CPU "
        f"(relative to the largest): {json.dumps(errs)}; a CPU-built "
        f"program on the card: the loaded state reached the next run, a "
        f"[3, 4] feed gave {three.shape}; jit.save gpt_1p3b bf16 24L: "
        f".pdmodel {pdmodel / 2**20:.2f} MiB, .pdparams "
        f"{pdparams / 2**20:.1f} MiB, save {save_s:.2f} s")
    return counts


# ------------------- the seq2seq LSTM, the op surface and nn.quant
# PaddleNLP's base seq2seq (PaddlePaddle/models, PaddleNLP `seq2seq` on
# IWSLT'15 English-Vietnamese, no attention): its run flags
S2S = dict(src_vocab=17191, tgt_vocab=7709, hidden=512, layers=2,
           dropout=0.2, init_scale=0.1, max_grad_norm=5.0, batch=128,
           max_len=50, beam=10, lr=1e-3, bos=0, eos=1)
S2S_STEPS = 10
S2S_BEAM_SENTENCES = 16


def _profile_calls(fn, what):
    """One call of `fn` under torch.profiler: wall, device busy, launches
    and the device split by kind (`_log_profile`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, what, wall, 1)


def _s2s(device, dropout, seed=SEED, hidden=S2S["hidden"],
         layers=S2S["layers"], src_vocab=S2S["src_vocab"],
         tgt_vocab=S2S["tgt_vocab"]):
    """The base seq2seq from the port's `nn`: `nn.Embedding` and an
    `nn.LSTM` encoder, a decoder cell of stacked `nn.LSTMCell`s (dropout
    between them) run by `nn.RNN`, whose states are one flat tuple (h0,
    c0, h1, c1) seeded by the encoder's final states, and an
    `nn.Linear(hidden, tgt_vocab)` head without bias.  Every weight from
    U(-init_scale, init_scale) of a numpy seed (PaddleNLP's
    `init_scale`), so a CPU and a card copy start equal."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import device as D

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
            self.src_emb = nn.Embedding(src_vocab, hidden)
            self.tgt_emb = nn.Embedding(tgt_vocab, hidden)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers,
                                   dropout=dropout)
            self.decoder = nn.RNN(Stacked())
            self.head = nn.Linear(hidden, tgt_vocab, bias_attr=False)

        def init_states(self, src):
            _, (h, c) = self.encoder(self.src_emb(src))
            return tuple(t for i in range(layers) for t in (h[i], c[i]))

        def forward(self, src, tgt_in):
            out, _ = self.decoder(self.tgt_emb(tgt_in),
                                  self.init_states(src))
            return self.head(out)

    prev = D._default
    D.set_device("cpu")
    try:
        model = Seq2Seq()
    finally:
        D._default = prev
    rs = np.random.RandomState(seed)
    scale = S2S["init_scale"]
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.copy_(torch.from_numpy(rs.uniform(
                -scale, scale, tuple(p.shape)).astype(np.float32)))
    return model.to(device)


def _s2s_batch(batch, length, seed=SEED):
    """Seeded token ids (ids 0 and 1 are bos and eos): source [B, L],
    target input (bos first) and labels [B, L], target lengths in
    [L / 5, L] and the [B, L] float mask of the labels within them."""
    rs = np.random.RandomState(seed)
    src = rs.randint(2, S2S["src_vocab"], (batch, length)).astype(np.int64)
    tgt = rs.randint(2, S2S["tgt_vocab"], (batch, length + 1)) \
        .astype(np.int64)
    tgt[:, 0] = S2S["bos"]
    lens = rs.randint(length // 5, length + 1, batch)
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.float32)
    return src, tgt[:, :-1].copy(), tgt[:, 1:].copy(), mask


def _s2s_loss(model, batch):
    """PaddleNLP's criterion: the masked token CE, summed over time of
    its mean over the batch."""
    from paddle_tpu_torch.nn import functional as F

    src, tgt_in, labels, mask = batch
    ce = F.cross_entropy(model(src, tgt_in), labels[..., None],
                         reduction="none").squeeze(-1)
    return (ce * mask).sum() / src.shape[0]


def _s2s_opt(model):
    from paddle_tpu_torch import nn, optimizer

    return optimizer.Adam(learning_rate=S2S["lr"],
                          parameters=list(model.parameters()),
                          grad_clip=nn.ClipGradByGlobalNorm(
                              S2S["max_grad_norm"]))


def _s2s_steps(model, opt, batch, steps, grads=None):
    losses = []
    for i in range(steps):
        loss = _s2s_loss(model, batch)
        loss.backward()
        if i == 0 and grads is not None:
            grads.update({n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def phase_seq2seq_train(card, steps=S2S_STEPS):
    """46. seq2seq_train: PaddleNLP's base seq2seq at its published
    widths (`_s2s`: 2-layer LSTM encoder and stacked-cell decoder at
    hidden 512, vocab 17,191 / 7,709), f32, Adam under
    ClipGradByGlobalNorm(5.0).  First a card-vs-CPU parity at B32 x 50
    with dropout 0 and TF32 off: 2 steps from one set of weights, the
    losses within 1e-6 relative and every first-step gradient within
    2e-5 of the largest CPU gradient of its parameter (readings 6.77e-08
    and 1.38e-06 on the H100 when these limits were set).  Then `steps`
    steps at B128 x 50 with dropout 0.2 on one seeded batch: the loss
    must fall; ms a step and target tokens/s over the steps after the
    first.  No TPU kernel lies on this path: it launches none.  Returns
    the trained model."""
    import torch

    from paddle_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = _s2s_batch(32, S2S["max_len"], SEED + 46)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = _s2s(dev, 0.0)
        batch = tuple(torch.from_numpy(a).to(dev) for a in small)
        grads = {}
        runs[dev] = (_s2s_steps(model, _s2s_opt(model), batch, 2, grads),
                     grads)
        del model
    (gl, gg), (cl, cg) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    check(loss_err <= 1e-6, f"seq2seq_train: card losses {gl} vs CPU {cl}")
    grad_err = max(float((gg[n] - cg[n]).abs().max()
                         / max(cg[n].abs().max(), 1e-30)) for n in cg)
    check(grad_err <= 2e-5, f"seq2seq_train: gradients card vs CPU "
          f"{grad_err:.3g} > 2e-5")
    _release_card()
    batch = tuple(torch.from_numpy(a).cuda() for a in _s2s_batch(
        S2S["batch"], S2S["max_len"], SEED + 47))
    model = _s2s("cuda", S2S["dropout"])
    model.train()
    opt = _s2s_opt(model)
    K.reset_launches()
    losses = _s2s_steps(model, opt, batch, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += _s2s_steps(model, opt, batch, steps - 1)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (steps - 1)
    launched = sum(K.launch_counts().values())
    check(launched == 0, f"seq2seq_train: {launched} kernel launches")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _profile_calls(lambda: _s2s_steps(model, opt, batch, 1),
                   "seq2seq B128x50 train step")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"seq2seq_train: the loss did not fall {losses}")
    tokens = float(batch[3].sum())
    log(f"[seq2seq_train] ({card}) PaddleNLP base seq2seq "
        f"{S2S['layers']}x{S2S['hidden']} LSTM, vocab "
        f"{S2S['src_vocab']}/{S2S['tgt_vocab']}, f32 Adam + clip 5.0: "
        f"parity B32x50 card vs CPU losses {gl} / {cl} (rel {loss_err:.3g}"
        f"), gradients {grad_err:.3g} of the largest; B{S2S['batch']}x"
        f"{S2S['max_len']} dropout {S2S['dropout']}: losses "
        f"{[round(v, 4) for v in losses]}, {dt * 1e3:.2f} ms/step, "
        f"{tokens / dt:.1f} target tokens/s ({tokens:.0f} a step), peak "
        f"{peak:.2f} GiB, 0 kernel launches")
    return model.eval()


def _s2s_tie_at_divergence(b, decs, inits, eos, beam, steps):
    """Sentence `b` decodes to other ids on the card than on the CPU
    over `steps` steps.  Finds the first step after which the two
    decodes' ids for it differ (bisecting `max_step_num`), and returns
    the least gap between adjacent values among the CPU's W + 1 best
    candidate totals at that step (a small gap is a near tie that a
    rounding difference may flip), with the step."""
    import torch

    from paddle_tpu_torch import nn

    def ids(dev, m):
        return nn.dynamic_decode(decs[dev], inits[dev],
                                 max_step_num=m)[0][b].cpu()

    lo, hi = 0, steps
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if torch.equal(ids("cuda", mid), ids("cpu", mid)):
            lo = mid
        else:
            hi = mid
    step = hi - 1                      # the two agree for `step` steps
    dec = decs["cpu"]
    seen = []
    hook = dec.output_fn.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        nn.dynamic_decode(dec, inits["cpu"], max_step_num=step + 1)
    finally:
        hook.remove()
    rows = slice(b * beam, (b + 1) * beam)
    logp = torch.log_softmax(seen[-1][rows].float(), -1)
    if step == 0:
        scores = torch.tensor([0.0] + [-1e9] * (beam - 1))
        done = torch.zeros(beam, dtype=torch.bool)
    else:
        prev, sc = nn.dynamic_decode(dec, inits["cpu"], max_step_num=step)
        scores, done = sc[b], prev[b, -1] == eos
    end_only = torch.full((logp.shape[-1],), -1e9)
    end_only[eos] = 0.0
    total = scores[:, None] + torch.where(done[:, None], end_only, logp)
    best = torch.sort(total.flatten(), descending=True).values[:beam + 1]
    return float((best[:-1] - best[1:]).min()), step


def phase_seq2seq_beam(card, model, sentences=S2S_BEAM_SENTENCES):
    """47. seq2seq_beam: `BeamSearchDecoder(beam_size=10)` over the
    trained model's decoder cell, `dynamic_decode(max_step_num=50)` from
    the encoder's states of 16 seeded source sentences, f32 with TF32
    off, on the card and on a CPU copy of the same weights: the ids
    equal, but for a sentence whose decodes part at a step where the
    CPU's W + 1 best candidates hold a near tie (two within 1e-4), which
    a rounding difference may flip (`_s2s_tie_at_divergence`; such
    sentences are reported); the final scores of the sentences whose
    ids equal within 5e-4 (a reading of 6.1e-05 when this limit was
    set).  Then ms a decode step and sentences/s on the card (a second,
    timed decode)."""
    import torch

    from paddle_tpu_torch import nn

    torch.backends.cuda.matmul.allow_tf32 = False
    src = _s2s_batch(sentences, S2S["max_len"], SEED + 48)[0]
    cpu = _s2s("cpu", S2S["dropout"])
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    decs, inits, outs = {}, {}, {}
    for dev, m in (("cuda", model), ("cpu", cpu)):
        decs[dev] = nn.BeamSearchDecoder(m.decoder.cell, S2S["bos"],
                                         S2S["eos"], S2S["beam"],
                                         m.tgt_emb, m.head)
        with torch.no_grad():
            inits[dev] = m.init_states(torch.from_numpy(src).to(dev))
        outs[dev] = nn.dynamic_decode(decs[dev], inits[dev],
                                      max_step_num=S2S["max_len"])
    gids, gsc = (t.cpu() for t in outs["cuda"])
    cids, csc = outs["cpu"]
    check(tuple(gids.shape) == tuple(cids.shape),
          f"seq2seq_beam: ids {tuple(gids.shape)} vs {tuple(cids.shape)}")
    differ = [b for b in range(sentences) if not torch.equal(gids[b],
                                                             cids[b])]
    ties = {}
    for b in differ:
        gap, step = _s2s_tie_at_divergence(b, decs, inits, S2S["eos"],
                                           S2S["beam"], cids.shape[1])
        check(gap < 1e-4, f"seq2seq_beam: sentence {b}'s ids part at step "
              f"{step} with no near tie (the CPU's best candidates "
              f"{gap:.3g} apart)")
        ties[b] = (step, gap)
    same = [b for b in range(sentences) if b not in ties]
    check(same, "seq2seq_beam: every sentence parted at a near tie")
    score_err = float((gsc[same] - csc[same]).abs().max())
    check(score_err <= 5e-4, f"seq2seq_beam: scores card vs CPU "
          f"{score_err:.3g}")
    dec, init = decs["cuda"], inits["cuda"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _ = nn.dynamic_decode(dec, init, max_step_num=S2S["max_len"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = ids.shape[1]
    _profile_calls(lambda: nn.dynamic_decode(
        dec, init, max_step_num=S2S["max_len"]),
        f"beam-10 decode of {sentences} sentences ({steps} steps)")
    log(f"[seq2seq_beam] ({card}) beam {S2S['beam']}, {sentences} "
        f"sentences of {S2S['max_len']} tokens, {steps} decode steps: "
        f"ids card == CPU for {len(same)}/{sentences} (parted at a near "
        f"tie, sentence: (step, gap) {ties}), scores of the others within "
        f"{score_err:.3g} (largest |score| {float(csc.abs().max()):.2f}); "
        f"{dt / steps * 1e3:.3f} ms a decode step, {sentences / dt:.2f} "
        f"sentences/s")


def _op_cases():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools_torch import op_cases
    from paddle_tpu_torch.ops import _op_table

    return op_cases, op_cases.cases(_op_table.PUBLIC_OPS["paddle_tpu"],
                                    _op_table.INPLACE_OPS), \
        _op_table.GRAD_CHECKED


def phase_ops_card(card):
    """48. ops_card: every case of ``tools_torch/op_cases.py`` (each
    public op of the JAX op table and each in-place twin, at small seeded
    shapes) through the port on the card and on the CPU, f32 with TF32
    off: outputs equal in shape, integer and boolean outputs equal, float
    outputs within 1e-4 of the largest CPU value (1e-3 for the cases
    whose CPU tolerance against JAX is 1e-4: solvers and special
    functions), the GRAD_CHECKED ops' gradients too; in-place forms
    return their written argument; the random ops held to their shape
    and support on the card's own draw, and to their law (`LAWS`: the
    case's parameters repeated 20,000 times, every element's sample mean
    and variance, or each outcome's frequency, within 5 standard errors
    of the law's); the decompositions to their invariants.  Prints how
    many ran and the largest error by kind (for the laws, the largest
    |z|)."""
    import torch

    import paddle_tpu_torch as PT
    from paddle_tpu_torch.core import device as D

    torch.backends.cuda.matmul.allow_tf32 = False
    op_cases, cases, grad_checked = _op_cases()

    def conv(a, dev, grad=False):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(np.array(a)).to(dev)
            return t.requires_grad_() if grad and t.is_floating_point() \
                else t
        if isinstance(a, list):
            return [conv(v, dev, grad) for v in a]
        if isinstance(a, tuple):
            return tuple(conv(v, dev, grad) for v in a)
        return a

    def leaves(x):
        if isinstance(x, (list, tuple)):
            return [v for e in x for v in leaves(e)]
        return [x]

    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    def call(case, args, kw, dev, grad=False, seed=True):
        prev = D._default
        D.set_device(dev)
        try:
            if seed:
                PT.seed(SEED)
            a = conv(args, dev, grad)
            return a, getattr(PT, case.op)(*a, **kw)
        finally:
            D._default = prev

    worst, ran, grads = {}, 0, 0
    for case in cases:
        args, kw = case.make(np.random.RandomState(SEED + 48))
        cin, cpu = call(case, args, kw, "cpu")
        gin, gpu = call(case, args, kw, "cuda")
        what = f"ops_card {case.name}"
        if case.written is not None:
            check(gpu is gin[case.written], f"{what}: not written in place")
        c, g = leaves(cpu), leaves(gpu)
        check(len(c) == len(g), f"{what}: {len(g)} outputs vs {len(c)}")
        for a, b in zip(g, c):
            check(np.shape(host(a)) == np.shape(host(b)),
                  f"{what}: shape {np.shape(host(a))} vs "
                  f"{np.shape(host(b))}")
            if torch.is_tensor(a):
                check(a.device.type == "cuda" or not torch.is_tensor(b)
                      or b.device.type == "cpu",
                      f"{what}: output on {a.device}")
        if case.kind == "random":
            outs = [host(a) for a in g]
            err = case.check(outs if len(outs) > 1 else outs[0], args,
                             None)
            PT.seed(SEED)
            z = op_cases.moment_z(case, args, kw, lambda a, k: [
                host(o) for o in leaves(call(case, a, k, "cuda",
                                             seed=False)[1])])
            check(z <= op_cases.Z_LIMIT, f"{what}: the card's draw is "
                  f"{z:.3g} standard errors off its law")
            worst["law_z"] = max(worst.get("law_z", 0.0), z)
        elif case.kind == "decomp":
            err = case.check([host(a) for a in g] if len(g) > 1
                             else host(g[0]), args,
                             [host(b) for b in c] if len(c) > 1
                             else host(c[0]))
        else:
            err = 0.0
            for a, b in zip(g, c):
                an, bn = host(a), host(b)
                if bn.dtype.kind in "biuU" or not np.size(bn):
                    err = max(err, 0.0 if np.array_equal(an, bn) else 1.0)
                    continue
                fin = np.isfinite(bn)
                check(np.array_equal(fin, np.isfinite(an)),
                      f"{what}: non-finite entries differ")
                if fin.any():
                    err = max(err, float(np.abs(an[fin] - bn[fin]).max()
                                         / max(1.0, np.abs(bn[fin]).max())))
        limit = 0.0 if case.kind == "random" else (
            case.tol if case.kind == "decomp" else 10 * case.tol)
        check(err <= limit, f"{what}: card vs CPU {err:.3g} > {limit:g}")
        worst[case.kind] = max(worst.get(case.kind, 0.0), err)
        ran += 1
        if case.name in grad_checked:
            got = []
            for dev in ("cpu", "cuda"):
                ins, out = call(case, args, kw, dev, grad=True)
                out.backward(torch.ones_like(out))
                got.append([t.grad.detach().cpu() for t in ins
                            if torch.is_tensor(t) and t.requires_grad])
            for a, b in zip(got[1], got[0]):
                gerr = float((a - b).abs().max()
                             / max(1.0, b.abs().max()))
                check(gerr <= 1e-4, f"{what}: gradient card vs CPU "
                      f"{gerr:.3g}")
                worst["grad"] = max(worst.get("grad", 0.0), gerr)
            grads += 1
    log(f"[ops_card] ({card}) {ran} cases of {len({c.op for c in cases})} "
        f"ops (every public op and in-place twin) on the card against the "
        f"CPU, {grads} GRAD_CHECKED gradients; largest error by kind "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}")


def phase_quant_card(card, d_in=4096, d_out=11008, rows=16):
    """49. quant_card: `nn.quant` at llama_7b's MLP width (4096 ->
    11008, seeded N(0, 0.02) weights): `weight_quantize` for
    weight_only_int8 / weight_only_int4 / llm.int8, per channel and
    with groups of 128, on the card and the CPU: codes and scales equal
    bit for bit; `weight_only_linear` (int8 and int4) and
    `llm_int8_linear` (an outlier channel past the threshold) at [16,
    4096] f32 inputs within 1e-4 of the largest CPU output; the card's
    ms of `weight_only_linear` against `F.linear` of the f32 weight, in
    turns."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import quant as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(SEED + 49)
    w = torch.from_numpy((rs.randn(d_in, d_out) * 0.02).astype(np.float32))
    x = torch.from_numpy(rs.randn(rows, d_in).astype(np.float32))
    x[:, 11] *= 40.0
    wg, xg = w.cuda(), x.cuda()
    errs, times = {}, {}
    for algo, group in (("weight_only_int8", -1), ("weight_only_int8", 128),
                        ("weight_only_int4", -1), ("weight_only_int4", 128),
                        ("llm.int8", -1)):
        cq, cs = Q.weight_quantize(w, algo, group_size=group)
        gq, gs = Q.weight_quantize(wg, algo, group_size=group)
        tag = f"{algo} g{group}"
        check(torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu(), cs),
              f"quant_card {tag}: card codes or scales differ from the CPU")
        if algo == "llm.int8":
            cy = Q.llm_int8_linear(x, cq, None, cs, 6.0)
            fn = functools.partial(Q.llm_int8_linear, xg, gq, None, gs, 6.0)
        else:
            wd = "int4" if algo.endswith("int4") else "int8"
            cy = Q.weight_only_linear(x, cq, None, cs, wd, group_size=group)
            fn = functools.partial(Q.weight_only_linear, xg, gq, None, gs,
                                   wd, group_size=group)
        gy = fn().cpu()
        errs[tag] = float((gy - cy).abs().max() / cy.abs().max())
        check(errs[tag] <= 1e-4, f"quant_card {tag}: card vs CPU "
              f"{errs[tag]:.3g}")
        times[tag] = time_ms(fn, iters=20)
    plain = time_ms(lambda: F.linear(xg, wg), iters=20)
    times["f32 F.linear"] = plain
    log(f"[quant_card] ({card}) {d_in}->{d_out}, codes and scales card == "
        f"CPU bit for bit; outputs card vs CPU (relative to the largest) "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
        f"ms at [{rows}, {d_in}] f32 (dequantize + matmul) "
        f"{json.dumps({k: round(v, 4) for k, v in times.items()})}")


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs one CUDA card", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch.models.gpt import (
            GPTForCausalLM, gpt_1p3b, gpt_6p7b,
        )
        from paddle_tpu_torch.models.llama import (
            LlamaForCausalLM, llama2_70b_shapes, llama_7b,
        )
        from paddle_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing next "
              f"to this script: {e}", file=sys.stderr)
        return 3
    t_all = time.perf_counter()
    phases = {}

    def run(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        phases[name] = time.perf_counter() - t
        log(f"[{name}] done in {phases[name]:.1f}s")
        return r

    def release():
        # engines hold their page pools through reference cycles
        gc.collect()
        torch.cuda.empty_cache()

    def load(cls, cfg, name):
        t = time.perf_counter()
        model = cls(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
        torch.cuda.synchronize()
        log(f"[model] {name} bf16 seeded weights on the card in "
            f"{time.perf_counter() - t:.1f}s")
        return model

    profile = "--profile" in sys.argv[1:]
    # each driven path's launch counts (reset just before it, read just
    # after), by phase
    paths = {}

    def path(name, fn, *a):
        paths[name] = run(name, fn, *a)
        return paths[name]

    try:
        card, kind = run("device", phase_device)
        run("build", phase_build)
        table = run("kernels", phase_kernels)
        cfg = gpt_1p3b()
        cut = gpt_1p3b()
        cut.num_layers = 2          # the preset fixes the depth; cut it
        model = load(GPTForCausalLM, cfg, "gpt_1p3b")
        path("serve", phase_serve, model, cfg, "gpt_1p3b")
        path("generate", phase_generate, model, cfg, "gpt_1p3b")
        release()
        path("sample_beam", phase_sample_beam, cfg, "gpt_1p3b", cut)
        release()
        path("spec_serve", phase_spec_serve, model, cfg, "gpt_1p3b")
        release()
        path("http_serve", phase_http_serve, model, cfg, "gpt_1p3b")
        if profile:
            run("profile", phase_profile, model, cfg)
            run("profile_prefill", phase_profile_prefill, model, cfg)
        del model
        release()
        run("parity", phase_parity, GPTForCausalLM, cut, "gpt_1p3b")
        release()
        run("tiers_parity", phase_tiers_parity, GPTForCausalLM, cut,
            "gpt_1p3b")
        release()
        run("train_parity", phase_train_parity, GPTForCausalLM,
            _gpt125m(2), "GPT-125M", 2, 256, ("flash_fwd", "flash_bwd"))
        train, step, ids, labels = run("train", phase_train, card)
        paths["train"] = train
        if profile:
            run("profile_train", phase_profile_train, step, (ids, labels))
        del step
        release()
        path("kv_layout_parity", phase_kv_layout_parity)
        release()
        path("kv_layout_parity_f16", phase_kv_layout_parity, 3, "float16")
        release()
        train, step, ids, labels = run("train_kv_layout", phase_train, card,
                                       "kv")
        paths["train_kv_layout"] = train
        if profile:
            with _layout("kv"):
                run("profile_train_kv", phase_profile_train, step,
                    (ids, labels), 3, "train step, flash layout kv")
        del step
        release()
        lcfg = llama_7b()
        model = load(LlamaForCausalLM, lcfg, "llama_7b")
        path("llama_serve", phase_serve, model, lcfg, "llama_7b")
        path("llama_serve_int8", phase_serve, model, lcfg, "llama_7b", "int8")
        release()
        path("weight_tiers", phase_weight_tiers, model, lcfg, "llama_7b")
        release()
        path("llama_generate", phase_generate, model, lcfg, "llama_7b")
        release()
        path("llama_http_serve", phase_http_serve, model, lcfg, "llama_7b",
             False)
        if profile:
            run("llama_profile", phase_profile, model, lcfg)
            run("llama_profile_int8", phase_profile, model, lcfg, 10,
                "int8")
            run("llama_profile_prefill", phase_profile_prefill, model, lcfg)
        release()
        # the same llama_7b cast in place to float16: both KV tiers and
        # generate(), the engine's streams held to sequential generate()
        _cast16(model, torch.float16)
        refs = run("llama_f16_refs", _generate_refs, model, lcfg)
        run("llama_f16_ties", phase_tie_readings, model, lcfg, "llama_7b",
            refs)
        path("llama_f16_serve", phase_serve, model, lcfg, "llama_7b", None,
             refs)
        path("llama_f16_serve_int8", phase_serve, model, lcfg, "llama_7b",
             "int8", refs)
        release()
        path("llama_f16_generate", phase_generate, model, lcfg,
             "llama_7b f16")
        del model, refs
        release()
        run("llama_parity", phase_parity, LlamaForCausalLM,
            llama2_70b_shapes(num_layers=2), "llama2_70b_shapes")
        release()
        run("int8_parity", phase_int8_parity, LlamaForCausalLM,
            llama2_70b_shapes(num_layers=2), "llama2_70b_shapes")
        release()
        path("llama_train_parity", phase_train_parity, LlamaForCausalLM,
             llama_7b(num_layers=1), "llama_7b", 1, 128,
             ("flash_fwd", "flash_bwd", "rope", "rope_bwd"))
        release()
        run("vision_parity", phase_vision_parity)
        paths["vision_serve"], paths["vision_serve_f16"] = run(
            "vision_serve", phase_vision_serve, card, VISION_BATCH, 10,
            profile)
        release()
        run("vision_train_parity", phase_vision_train_parity)
        paths["vision_train"], paths["vision_train_f16"] = run(
            "vision_train", phase_vision_train, card, 10, profile)
        release()
        path("varlen", phase_varlen, card)
        path("varlen_f16", phase_varlen, card, (torch.float16,))
        run("fused_transformer_parity", phase_fused_transformer_parity)
        release()
        (paths["fused_transformer_serve"],
         paths["fused_transformer_serve_f16"]) = run(
            "fused_transformer_serve", phase_fused_transformer_serve, card)
        release()
        path("fused_encoder_train", phase_fused_encoder_train, card)
        release()
        path("ernie_train", phase_ernie_train, card)
        release()
        run("recompute_parity", phase_recompute_parity)
        release()
        path("train_resilient", phase_train_resilient, card)
        release()
        path("train_1p3b_recompute", phase_train_1p3b_recompute, card)
        release()
        path("train_llama_recompute", phase_train_llama_recompute, card)
        release()
        eager_counts, bf16_tps, bf16_losses = run(
            "train_eager_amp", phase_train_eager_amp, card)
        paths["train_eager_amp"] = eager_counts
        release()
        path("train_fp16_scaler", phase_train_fp16_scaler, card, bf16_tps,
             bf16_losses)
        release()
        path("llama_o1_f16", phase_llama_o1_f16, card)
        release()
        path("optimizer_zoo", phase_optimizer_zoo, card)
        release()
        c6 = gpt_6p7b()
        model = load(GPTForCausalLM, c6, "gpt_6p7b")
        path("gpt6p7b_serve", phase_gpt6p7b_serve, model, c6)
        del model
        release()
        path("incubate_decode", phase_incubate_decode, card)
        release()
        run("incubate_moe", phase_incubate_moe, card)
        release()
        path("incubate_train", phase_incubate_train, card, bf16_tps)
        release()
        run("save_load", phase_save_load, card)
        path("hapi_fit", phase_hapi_fit, card)
        path("hapi_vision", phase_hapi_vision, card)
        path("jit_save", phase_jit_save, card)
        release()
        programs, paths["static_program"] = run(
            "static_program", phase_static_program, card,
            _static_cases(torch))
        saved, paths["saved_model"] = run("saved_model", phase_saved_model,
                                          card, programs)
        del programs
        release()
        path("saved_model_serve", phase_saved_model_serve, card, saved)
        path("fleet_model", phase_fleet_model, card, saved)
        release()
        path("transformer_train", phase_transformer_train, card)
        path("transformer_decode", phase_transformer_decode, card)
        run("nn_layers_card", phase_nn_layers_card)
        path("c1_card", phase_c1_card, card)
        release()
        s2s = run("seq2seq_train", phase_seq2seq_train, card)
        run("seq2seq_beam", phase_seq2seq_beam, card, s2s)
        del s2s
        release()
        run("ops_card", phase_ops_card, card)
        run("quant_card", phase_quant_card, card)
        release()
        path("fleet", phase_fleet)
        rows = []
        for name, k in K.KERNELS.items():
            row = table[(name, "bfloat16")]
            errs = [table[(name, d)]["max_abs_err"]
                    for d in ("bfloat16", "float32")]
            by_path = {p: c[name] for p, c in paths.items() if c[name]}
            launched = sum(by_path.values())
            check(launched > 0, f"{name} never launched on the main paths")
            f16_paths = sum(n for p, n in by_path.items() if "f16" in p)
            check(f16_paths > 0, f"{name} never launched on a float16 path")
            rows.append(dict(
                name=name, route="cuda", source=k.source,
                replaces=k.replaces, launches=launched,
                max_abs_err=max(errs), ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                shape=row["case"], paths=by_path))
            if name == "flash_bwd":
                # the dBias mode's rows (with and without dBias) by dtype
                rows[-1]["dbias"] = {
                    d: table[("flash_bwd dbias", d)]
                    for d in ("float32", "bfloat16", "float16")}
            f16 = table[(name, "float16")]
            rows[-1]["float16"] = dict(
                {k: f16[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by",
                                     "max_abs_err")},
                launches=f16_paths)
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[total] {time.perf_counter() - t_all:.1f}s "
        f"{json.dumps({k: round(v, 1) for k, v in phases.items()})}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
