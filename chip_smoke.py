"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and no network; imports
nothing of JAX. Phases, each raising on failure (non-zero exit):

  1. the card's name and power limit; build the hand-written kernels from
     vlrlhf_torch/csrc/ with nvcc for sm_90a, one nvcc per source, all at
     once (build seconds and ptxas reports printed)
  2. each kernel against its plain PyTorch version on the card, at the
     serving and DPO paths' shapes, bf16 in, plain computed in f32 on the
     same values; max abs error against 2e-2 (times max(1, max |ref|) for
     the backward) and relative Frobenius error against 1e-2, with the
     median |ref| printed; kernel, plain and yardstick times and each
     kernel's bound max(FLOPs / 989.4e12, bytes / 3.35e12); the flash
     forward and backward kernels, the int4 matmuls and the decode and
     chunk attention kernels are timed alone (their C entry points on
     preallocated outputs) and through their wrappers, and each wrapper's
     host microseconds per call are printed. Decode attention on a bf16 and an int8 cache, timed at
     length 640 and at a full cache (1023); chunk attention at the
     speculative verify shape (B=8, C=4) and a chat turn's (B=1, C=64),
     bf16 and int8 caches; the attention timings rotate over cache layers
     so each launch reads device memory (SDPA with an explicit mask over
     the dequantized cache as yardstick);
     the int4 matmul (kernel 6) at decode (T=8), verify (T=32), prefill
     (T=1280) and T=2048 and its transpose (kernel 7) at T=2048,
     LLaVA-1.5-7B's 4096 -> 11008 and 11008 -> 4096 (and, for kernel 7,
     the attention projections' 4096 -> 4096), plus edge shapes (cuBLAS
     bf16 on the dequantized weight as yardstick); and the shapes one rank
     of --mesh_model 2 gives them ("tp" in the kernels line): the flash
     forward and backward at H = 16 (LLaVA's 32 heads split) and GQA
     16 / 4 (Mistral's 32 / 8) on the DPO pair's S = 1024 and, under
     --sequence_parallel_axis model (phase 17a), at H = 16 over 14b's
     whole S = 4096 pair (rows of 4,084 / 3,884), the int4
     kernels at T = 2048 on gate / up column shards (out 5,504) and the
     repacked down and wo row shards (in 5,504 and 2,048), kernel 6 at
     T = 8 on the gate and down shards (ppo's rollouts under QLoRA int4),
     decode at H = 16 / 16 (B = 8, length 640) and mistral's GQA 16 / 4
     over ~3,000 tokens, bf16 and int8, and chunk verify at H = 16 (B = 8,
     C = 4), bf16 and int8; and the shape one pipeline microbatch gives
     kernels 1-3 under --mesh_pipe 2 ("pipe": B = 1, S = 1024, H = 32,
     D = 128, one row of 1,000 tokens)
  3. serving at full LLaVA-1.5-7B widths but 2 LM / 2 tower layers: the
     same seeded weights on the card (bf16, kernels) and on the CPU (f32,
     plain path), one image prefill + 8 greedy tokens; logit error and
     token agreement; prefill_chunk logits (C=4, then C=64) into a bf16
     and an int8 cache; speculative (K=3) vs plain greedy continuous
     batching on the card, where any divergence must be a top-2 tie of the
     CPU's teacher-forced logits; then the LM int4 (the same codes on both
     sides): prefill + 8 greedy tokens again, and fused (--fuse_decode)
     against unfused tokens on the card
  4. full-width LLaVA-1.5-7B with seeded random bf16 weights served over
     HTTP through cli.main.build_server (8 slots, cache_len 1024): 8
     concurrent /generate requests with 336x336 images, 32 new tokens;
     kernel launch counts of that run; then prefill ms, decode tokens/s,
     peak device memory, and one profiled prefill and decode step
  4b. the same model served through build_server with --quantize int8
     --kv_cache_dtype int8 --speculative_k 3 --chat_sessions 4: 8
     concurrent /generate requests whose prompts echo their question, then
     a 2-turn /chat, each run's kernel launch counts; then tokens per
     verify iteration, verify ms vs plain decode ms per step, peak memory
  4c. the same model served with --quantize int4 --fuse_decode true (129
     int4 linears): 8 concurrent /generate requests and their launch
     counts, resident weights, decode ms per step beside 4's and 4b's, one
     profiled decode step
  5. DPO at full widths but 2 LM / 2 tower layers, seeded adapters with a
     non-zero b: one loss and backward on the card (bf16, kernels) and on
     the CPU (f32, plain); relative loss error and the cosine of the LoRA
     gradients; again with the LM's linears int4 (QLoRA, the same codes on
     both sides)
  6. full-width LLaVA-1.5-7B DPO through cli.main.build_dpo (LoRA r64/a16
     on all 7 LM linears, 1 pair of 1024 tokens with an image, 'attn'
     remat, logits_chunk 256, precomputed reference logps): 5 steps on one
     batch with their loss / grad-norm checks and kernel launch counts, then
     step ms, pairs/s, MFU, peak device memory and one profiled step
  6b. the same with --q_lora true --bits 4 (224 int4 LM linears): 3 steps
     with their checks and launch counts, then step ms, pairs/s, MFU, peak
     memory beside phase 6's, and one profiled step; then cli.main
     finish_run's merged save over the int4 base, checked on sampled
     linears against the dequantized weight plus scale (A B)^T
  7. the `dpo` trainer's functions (cli.main build_dpo, make_eval_hook,
     train_dpo, finish_run) at full LLaVA-1.5-7B width with 16 of its 32
     LM layers (PHASE7_LAYERS) on phase 6's pair: (a) 3 steps under each remat policy (full, attn, dots, mlp,
     mlp1, acts) from the same adapters: step-1 loss ln 2, loss within
     1e-3 and grad norm within 1e-2 of attn's, median step ms and peak
     memory, the peaks ordered full <= attn <= mlp1 <= mlp <= acts; (b)
     --freeze_vision_tower false with LoRA on the LM's 7 linears and the
     tower's wq|wk|wv|wo: 3 steps, every tower adapter of the layers run
     with a non-zero gradient from step 2, the D = 64 backward kernels'
     launches, one profiled step; (c) 16 pairs, --eval_steps 2
     --eval_ratio 0.125 --eval_samples 2: eval/* finite at steps 0 and 2,
     the step-0 policy and reference samples identical; (d) 4 steps
     straight against 2 steps, a checkpoint, --resume_from_checkpoint auto
     and 2 more (losses within 1e-3), checkpoint bytes, save and restore
     ms; (e) --merge_adapter_after_training: the merged file equals
     W + scale (A B)^T on sampled linears
  8. `eval` and the serving leftovers at full LLaVA-1.5-7B width and depth
     (seeded random bf16 weights) over an MME-shaped TSV (32 yes/no rows,
     16 images as base64 blobs that a seeded loader maps to pixels by file
     name) and a SEEDBench json (16 questions x 4 choices): (a) cli.main
     build_eval / run_eval on MME three ways, static batch 16,
     --continuous_batching true with 8 slots and --speculative_k 3, 16 new
     tokens: images/s each, verify_calls and tokens per row verify, the
     three paths' tokens equal up to top-2 ties of the card's
     teacher-forced logits; (b) CE ranking, 64 SEEDBench rows in batches of
     16, every ppl finite, rows/s; the launch counts of (a) + (b) are the
     "eval" path, which must launch kernels 1, 4 and 5; (c) two r64
     adapter sets with a non-zero b, written by train/checkpoint.py and
     served by build_server --adapter a=... --adapter b=...: 8 concurrent
     /generate requests over a, b and the base model, each equal to an
     engine holding only its set (tie rule); /score through
     EndpointRunner.run_vqa_ppl against the in-process run_vqa_ppl (1e-3
     relative); `eval --endpoint` on MME against (a)'s continuous tokens;
     again with --fuse_decode true, the fused adapter layout against the
     unfused tokens; (d) the EvalRunner at 2 LM / 2 tower layers on the
     card (bf16) and the CPU (f32): ppl within PPL_REL_TOL (two broken
     controls, no causal mask and labels one token off, must fail it),
     greedy tokens equal up to top-2 ties of the CPU's logits
  9. a checkpoint on disk: full-width, full-depth LLaVA-1.5-7B with seeded
     random bf16 weights written as an HF checkpoint (utils/hf_export.py,
     the published llava-hf/llava-1.5-7b-hf config.json, a seeded llama
     tokenizer.json) and read back by cli.main.load_bundle: bf16 equal to
     the model in memory, tensor for tensor and in the greedy tokens of 8
     image requests (after 8 more over HTTP); int8 (--kv_cache_dtype int8
     --speculative_k 3) and int4, quantized while they stream in, equal to
     the in-memory model quantized after; each import's ms, GB/s and peak
     memory over the resident model (at most one LM layer more); `dpo`'s
     functions from a plain_dpo dataset of the JPEG fixtures (step-1 loss ln
     2, finite) with step ms; then at 2 LM / 2 tower layers QLoRA int4 dpo,
     eval mmvet with the checkpoint as its own judge and `merge
     --export_format hf`, reloaded bit-equal with equal logits. The JPEGs go
     through the native loader where it builds; where it does not (no
     libjpeg), the finding is printed and tests/fixtures' .npz (the CPU
     box's decode of the same files) is fed instead
  10. the sft, rm and ppo trainers: (a) at full widths but 2 LM / 2 tower
     layers, the same seeded weights and non-zero adapters on the card
     (bf16, kernels) and the CPU (f32, plain), short text rows: an sft
     step's loss and LoRA gradients; rm from the zero head (step-1 loss ln
     2 on both), then step 2's loss and head + adapter gradients; ppo's
     stats (logprobs, values, advantages over 4 rows, one with an empty
     response) and one update's loss and gradients, without and with value
     adapters; losses and stats within LOSS_REL_TOL, gradient cosines at
     least GRAD_COS_MIN. (b) full LLaVA-1.5-7B width at PHASE10_LAYERS =
     8 of its 32 LM layers (the script's time limit), seeded
     random bf16 weights, through cli.main's build_sft / build_rm /
     build_ppo, train_steps / train_ppo and finish_run: sft 3 steps on 2
     image rows of ~1000 tokens (attn remat, logits_chunk 256), step ms and
     MFU; rm 3 steps on 2 image pairs (step-1 loss ln 2 within 1e-6), its
     adapters/ saved; ppo with that rm as --reward_model_path: 8 image
     prompts, 32 sampled tokens, --ppo_epochs 2 --minibatch_size 4, 2 outer
     steps of static rollouts, a checkpoint, then a resumed third step with
     continuous rollouts: no skipped step, every metric finite, each step's
     first minibatch at ratio 1 within 1e-2 with nothing clipped, the
     policy adapters bit-equal around each reward forward; rollout tokens/s,
     reward / stats / update / outer-step ms, peak memory, GAE's host ms,
     one profiled outer step. (c) ppo --q_lora true --bits 4 at 2 LM
     layers: one outer step, kernels 6 and 7 launched
  11. the LLaVA-Next and InstructBLIP families: (a) llava_next_mistral and
     instructblip at their 7B widths but 1 LM / 2 tower layers
     (FAMILY_CHECK_LAYERS), the same
     seeded weights on the card (bf16) and the CPU (f32): an image prompt's
     logits and 8 greedy tokens (a 336 x 336 anyres image in 3 tiles; a
     Q-Former instruction read through a seeded WordPiece tokenizer), one
     DPO pair's loss and LoRA gradients (LOGIT_REL_TOL, LOSS_REL_TOL,
     GRAD_COS_MIN); InstructBLIP again with --freeze_vision_tower false and
     LoRA on the EVA tower's attention (the D = 88 backward kernels, their
     launches counted); LLaVA-Next mistral int4 with --fuse_decode (the
     fused GQA wqkv), card against CPU and fused against unfused. (b)
     full-width, full-depth LLaVA-Next mistral 7B (seeded random bf16
     weights) through cli.main.build_server: 8 anyres image prompts of mixed
     aspect ratios (1,476-2,928 image tokens, named <h>x<w> and made from a
     seed as decoded arrays: the card machine has no libjpeg), 8 slots, 32
     greedy tokens, the cache sized for the largest anyres image; TTFT of a
     lone request; then build_dpo on one pair with a 672 x 672 image padded
     to 4096 tokens (attn remat, precomputed reference): step-1 loss ln 2,
     step ms, MFU, peak memory; then --quantize int8 --kv_cache_dtype int8
     --speculative_k 3 on echo prompts. (c) full-width, full-depth
     InstructBLIP-Vicuna-7B: 8 image prompts with their Q-Former ids over
     HTTP, one DPO pair whose frozen-tower features take the pair's
     instruction, one CE ranking batch of 16 rows through build_eval
  12. the Qwen-VL and InternLM-XC2 families, each with its tokenizer in
     the published layout (the full-size qwen.tiktoken; a 92,544-piece
     sentencepiece tokenizer.model) read by the port's readers: (a) both at
     7B widths but 1 LM / 2 tower layers (FAMILY_CHECK_LAYERS), card bf16
     against CPU f32 (XC2
     with a 24 x 24 table resized in the forward, r = 256 PLoRA and 224-px
     images): two image prompts' logits and 8 greedy tokens, one DPO pair's
     loss and gradients, int4 LM linears with --fuse_decode against
     unfused and the CPU (fused may leave unfused only at a top-2 tie,
     `fused_tie_or_raise`),
     and for XC2 a PLoRA control (zeroing PLoRA must move the card's
     logits past LOGIT_REL_TOL) and a QLoRA int4 DPO step (kernel 7 under
     PLoRA). (b) full-width, full-depth Qwen-VL-Chat (9.66 B, seeded
     random bf16): the tower and resampler's kernel-1 launches, 8
     concurrent 448 x 448 ChatML requests over HTTP, one DPO pair padded
     to 1024 (LoRA on QWEN_TARGETS), int8 --speculative_k 3 serving. (c)
     full-width, full-depth XComposer2-VL-7B with r = 256 PLoRA: 8
     concurrent 490 x 490 requests of ~1,700 tokens, one DPO pair padded
     to 2048 with PLoRA and LoRA, CE ranking of 16 rows
  13. multi-GPU training, part 1 (vlrlhf_torch/core: the (data, fsdp,
     model) mesh, FSDP2 units, tensor parallelism): (a) an in-process NCCL
     group of one on cuda:0 and the mesh of --mesh_fsdp -1; full-width,
     full-depth LLaVA-1.5-7B on phase 6's pair and seeds through cli.main
     build_dpo (every LlamaLayer and the VLM FSDP2 units) and train_steps,
     3 steps with a checkpoint at step 3: step-1 loss ln 2, losses within
     1e-3 and grad norms within 1e-2 of phase 6's, the launches of kernels
     1-3 ("mesh_dpo"), the checkpoint restored in a plain model (phase 6's
     path) equal to the live adapters; then the mesh and the plain run take
     turns through train_steps from that state for ms per step and peak
     memory, and one step of each is profiled; (b) `torchrun --standalone
     --nproc_per_node 1 -m vlrlhf_torch.cli.main dpo --synthetic 8
     --mesh_fsdp -1 --sequence_parallel_axis fsdp --max_steps 2` (NCCL, a
     ring of one): exit 0, finite metrics; (c) eval of
     phase 8's MME rows at full width and 2 LM / 2 tower layers, two ranks
     under torchrun sharing the card over gloo (this script with
     --mesh13c-worker), each on its half of the rows, against the same
     eval in this process: the same rows and launches ("mesh_eval"); (d)
     two ranks sharing the card over gloo (this script with
     --mesh13d-worker, torchrun's environment): --mesh_fsdp 2, then
     --mesh_fsdp 1 --mesh_model 2, at full width and 2 LM / 2 tower
     layers, 2 pairs per global batch, 3 updates each: the first update's
     gradients leaf by leaf within MESH_GRAD_TOL of the two-pair world-1
     run (and fsdp = 2's of one process accumulating the same one-pair
     micro-batches, whose losses it must hold within MESH_LOSS_TOL),
     step-1 loss ln 2 and gradient norms within 1e-2; model = 2 with its
     row-parallel all-reduce skipped (a planted fault) must fail
     MESH_GRAD_TOL; model = 2's launches are "mesh_dpo_tp"; fsdp = 2 and
     model = 2 also save a checkpoint at the last update and, through
     finish_run, adapters/ and merged/ from the gathered shards: each rank
     restores the checkpoint into its layout bit for bit, and merged/
     equals a world-1 merge of the same adapters bit for bit; 13b-d's
     processes start at once; (e) ppo through build_ppo / train_ppo on two
     ranks sharing the card over gloo (this script with --mesh13e-worker)
     at full width and 2 LM / 2 tower layers: one outer step of 4 image
     prompts, 16 greedy tokens, a seeded reward model held as the named
     set "reward", one update, at model = 2, fsdp = 2 and two planted
     faults (advantages whitened per rank at fsdp = 2; decode steps without
     the row-parallel all-reduce at model = 2), against world 1 in this
     process: the rollout tokens token for token and the first update's
     gradients within PPO_GRAD_TOL at every leaf; each fault must exceed
     it; model = 2's launches (kernels 1-4) are "mesh_ppo"
  14. ring attention over the sequence (vlrlhf_torch/ops/ring_attention.py,
     --sequence_parallel_axis fsdp): (a) in this process, the per-block
     functions looped as a ring of n = 2 and 4 (kernel 1 causal on the
     diagonal block and non-causal before it, the partials merged by
     log-add-exp, kernels 2-3 per block fed the merged LSE and di) on
     LLaVA-1.5-7B's attention, B = 1, S = 4096, H = 32, D = 128, and GQA
     32 / 8, one row of 3,800 tokens: O, dQ, dK, dV against the
     whole-sequence kernels and against the plain ring on the card, at
     TOL; each block of the most loaded (last) rank, its critical path and
     the whole-sequence kernels timed beside their bounds ("ring" in the
     kernels line); (b) started with 13b-e: two ranks sharing the card
     over gloo (this script with --mesh14-worker, torchrun's environment),
     `dpo` through build_dpo / train_steps under --mesh_fsdp 2
     --sequence_parallel_axis fsdp at full width and 2 LM / 2 tower layers,
     one pair at S = 4096, no gradient clipping, against world 1 in this
     process: the first update's gradients leaf by leaf within
     MESH_GRAD_TOL, step-1 loss ln 2, the gradient norm within 1e-2, each
     rank's resident and step peak memory beside world 1's; a planted
     fault (the ring's gradient partials averaged, not summed) must fail
     MESH_GRAD_TOL; rank 0's launches are "mesh_dpo_sp"; 14a also times
     the library calls at the blocks' shapes (SDPA, the aten flash
     backward)
  15. the GPipe pipeline (vlrlhf_torch/models/lm/pipeline.py,
     --mesh_pipe): (a) in this process, `pipeline_local` (both stages here,
     M = 2) against the plain stack on the card at LLaVA-1.5-7B's widths
     and 4 layers, LoRA r64, attn remat: the output and the gradients of
     the embeddings and adapters within MESH_GRAD_TOL; (b) started with
     13b-e and 14b: two ranks sharing the card over gloo (this script with
     --mesh15-worker, torchrun's environment), `dpo` through build_dpo /
     train_steps under --mesh_pipe 2 --pipeline_microbatches 2 (stage 0
     holding LM layers 0-1, stage 1 layers 2-3) at full width and 4 LM / 2
     tower layers, phase 6's pair at S = 1024, no gradient clipping,
     against world 1 in this process: the first update's gradients leaf
     by leaf within MESH_GRAD_TOL, step-1 loss ln 2, the gradient norm
     within 1e-2, each stage's launches of kernels 1-3 at the schedule's
     counts, each rank's resident and step peak memory beside world 1's;
     a planted fault (each hop hands over the previous microbatch) must
     fail MESH_GRAD_TOL; rank 0's launches are "mesh_dpo_pipe"
  16. ppo and dpo's --eval_samples under the pipeline, started with
     13b-e, 14b and 15b: two ranks sharing the card over gloo (this script
     with --mesh16-worker, torchrun's environment) under --mesh_pipe 2
     --pipeline_microbatches 2 at full width and 4 LM / 2 tower layers:
     13e's ppo outer step (4 image prompts, 16 greedy tokens, a seeded
     reward model at 4 layers as the named set "reward", one update)
     through build_ppo / train_ppo, the rollouts on the whole stack
     (core/partitioning.py whole_stack: each rank joins the other stage's
     layers for the block) and the reward, stats and update through the
     schedule, against world 1 in this process: the tokens equal world 1's
     or part only at a top-2 tie, the scores within PPO_SCORE_TOL, the
     first update's gradients within PPO_GRAD_TOL of world 1's replay at
     every leaf; a planted fault (the stack joined in reverse stage order)
     must fail; each rank's kernels 1-4 at the design's counts (kernel 4
     decode steps x all 4 layers on every rank, kernels 2-3 updates x M x
     L / S); each rank's resident memory and rollout and update peaks
     beside world 1's; then `dpo --eval_samples 2` (build_dpo,
     make_eval_hook) under the same layout: the greedy policy and
     reference samples equal world 1's or part only at a tie; rank 0's
     launches are "mesh_ppo_pipe"
  17. the sequence split over the tensor-parallel ranks
     (--sequence_parallel_axis model: each layer gathers its normed slice
     before the column linears, runs kernels 1-3 on its 16 heads over the
     whole sequence, reduce-scatters after the row linears), started with
     13b-e, 14b, 15b and 16: two ranks sharing the card over gloo (this
     script with --mesh17-worker, torchrun's environment). (a) `dpo` at
     (1, 1, 2) on 14b's pair (S = 4096) at full width and 2 LM / 2 tower
     layers, beside --mesh_model 2 alone on the same pair, against 14b's
     world 1: the first update's gradients leaf by leaf within
     MESH_GRAD_TOL (both layouts), step-1 loss ln 2 and the gradient norm
     within 1e-2, each rank's kernels 1-3 launches equal to --mesh_model
     2's, each rank's resident and step peak memory beside --mesh_model 2's;
     a planted fault (the replicated leaves' gradient partials not summed
     over the group) must fail MESH_GRAD_TOL; rank 0's launches are
     "mesh_dpo_sp_model". (b) 13e's ppo outer step at (1, 1, 2) under the
     model split and at (1, 2, 1) under the fsdp ring (generation unsplit,
     the stats pass and update on the slices), against 13e's world 1: the
     tokens equal or part only at a top-2 tie, the scores within
     PPO_SCORE_TOL, the first update within PPO_GRAD_TOL of world 1's
     replay, kernel 4 on every rank at world 1's count (decode steps x
     layers); the model split's rank 0 launches are "mesh_ppo_sp"

A profiled step prints the card's busy and idle time and its kernel time by
group (torch.profiler; the flash groups split by head dim). Phase 2's
backward cases include the tower's (B=2, S=577, H=16, D=64, non-causal)
and take the aten flash backward as yardstick everywhere (under GQA on K
and V expanded to the query heads, without the group sum). Phase 2 also
holds the eval path's shapes: the flash forward on 16 right-padded rows
of S = 640 (the CE ranking forward), decode at B=16 (the static
Generator) and chunk at B=16, C=4 (the static speculative verify), and
ppo's: the flash forward and backward on its update minibatch (4
right-padded rows of 660-720 tokens, S = 768) and decode at B=8 over
caches of ~650-700 tokens, and phase 11's ("families" in the kernels
line): the flash forward on the anyres tower's 10 tiles (S = 577, D = 64),
the EVA tower (B = 16, S = 257, H = 16, D = 88, forward and backward) and
LLaVA-Next mistral's DPO pair (GQA 32/8, causal, S = 4096, a 3,800-token
row; forward and backward), decode at B = 8 under GQA 32/8 over caches of
2,900-3,100 tokens and the verify chunk at g * C = 16 over the same, and
phase 12's: the flash forward on Qwen's tower (B = 8, S = 1024, H = 16,
D = 104), on its resampler's non-square call (256 queries over 1,024
keys, H = 32, D = 128) and on XC2's tower (B = 8, S = 1,226, D = 64). The
line before the last is {"kernels": [...]}
(launches summed over the serve, speculative int8 serve, /chat, int4
serve, DPO, QLoRA, trainer, eval, multi-adapter serving, phase 9's runs
(ckpt_*), phase 10's (sft, rm, ppo, ppo_qlora4) and phase 11's
(next_serve, next_dpo, next_serve_int8_spec, blip_serve, blip_dpo,
blip_eval) and phase 12's (qwen_int4_reduced, internlm_int4_reduced,
xc2_qlora4_reduced, qwen_serve, qwen_dpo, qwen_serve_int8_spec,
xc2_serve, xc2_dpo, xc2_eval), phase 13's (mesh_dpo, mesh_eval,
mesh_dpo_tp, mesh_ppo), phase 14's (mesh_dpo_sp), phase 15's
(mesh_dpo_pipe), phase 16's (mesh_ppo_pipe) and phase 17's
(mesh_dpo_sp_model, mesh_ppo_sp), split in
launches_by_path; the eval and ppo shapes' times under "eval" and "ppo");
the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch

TOL = 2e-2  # bf16 kernel vs f32 plain on identical bf16 inputs
# ||got - ref||_F / ||ref||_F, kernel vs plain: scale-free, so it also holds
# the many small entries that a max-abs tolerance set by the largest misses
# (bf16 rounding of P, dS and the outputs alone gives a few 1e-3)
REL_TOL = 1e-2
LOGIT_REL_TOL = 5e-2  # bf16 model on the card vs the f32 model on the CPU
# eval's mean answer CE, card bf16 vs CPU f32 at 2 layers: 2.5x the gap of
# sound runs (3.919e-4 on an H100, every run). Random weights put every
# row's CE near ln V, so LOGIT_REL_TOL would pass a wrong mask; phase 8d's
# broken controls must fail this limit (no causal mask: 2.648e-3)
PPL_REL_TOL = 1e-3
LOSS_REL_TOL = 5e-2  # bf16 DPO loss on the card vs the f32 loss on the CPU
GRAD_COS_MIN = 0.99  # cosine of the flattened LoRA gradients, card vs CPU
PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
KERNELS = ("flash_fwd", "decode_attention", "flash_bwd", "chunk_attention", "int4_matmul")
# eval's batch of 16 rows: prompt lengths around an image prompt's ~600 tokens
EVAL_LENS = (598, 604, 611, 617, 622, 629, 633, 640, 645, 651, 656, 662, 668, 673, 681, 690)
CE_LENS = tuple(min(n, 640) - 9 * (i % 3) for i, n in enumerate(EVAL_LENS))  # S = 640 bucket
# ppo's update minibatch: 4 rows of prompt + response in a 768-token batch,
# and its rollout decode: 8 slots over caches of ~650-700 tokens
PPO_LENS = (660, 683, 702, 720)
PPO_DECODE_LENS = (648, 655, 662, 670, 677, 684, 692, 700)
# phase 11's shapes: LLaVA-Next mistral's GQA 32/8 LM on a DPO pair padded
# to S = 4096 (one row 3,800 tokens), its serving decode and verify over
# 8 caches of ~3,000 tokens (anyres prompts), the anyres tower's tiles
# (2 requests x 5 tiles of 577 tokens, D = 64) and InstructBLIP's EVA
# tower (D = 88, S = 257, 16 images)
MISTRAL_LENS = (4096, 3800)
MISTRAL_DECODE_LENS = (2900, 2930, 2960, 2990, 3020, 3050, 3080, 3100)
MISTRAL_SC = 3200
# phase 11b's anyres images, (height, width): mixed aspect ratios, so the
# plans differ (672 x 672 -> 2,928 image tokens, 336 x 1008 -> 2,328)
ANYRES_SIZES = ((672, 672), (336, 1008), (1008, 336), (480, 640), (640, 480), (500, 333),
                (720, 1280), (600, 600))


# phase 2's kernel shapes on one rank of --mesh_model 2 (phase 13's layout):
# flash at 16 heads (LLaVA's 32 split) and at 16 / 4 (Mistral's GQA 32 / 8),
# S = 1024 with the DPO pair's lengths
TP2_FLASH_CASES = (
    ("tp2_dpo_lm_causal", True, 2, 1024, 16, 16, 128, (1000, 900)),
    ("tp2_gqa_1024", True, 2, 1024, 16, 4, 128, (1024, 960)),
    # phase 17a: a rank's heads over the whole S = 4096 pair (rows of 4,084
    # and 3,884 tokens) under --sequence_parallel_axis model
    ("tp2_sp_4096", True, 2, 4096, 16, 16, 128, (4084, 3884)),
)
# int4 on a rank's shards at the DPO step's T = 2048: gate / up column
# shards (out 11008 -> 5504), the repacked down row shard (in 5504) and
# wo's (in 4096 -> 2048)
# kernel 6 at decode (T = 8) on the same two shards: ppo's rollouts under
# --mesh_model 2 --q_lora true --bits 4 (the T <= 64 cluster kernel)
# phase 15: one pipeline microbatch of phase 6's pair under --mesh_pipe 2
# (M = 2: one row of its two; the chosen row's 1,000 tokens stand for it)
PIPE_FLASH_CASES = (("pipe_microbatch", True, 1, 1024, 32, 32, 128, (1000,)),)
TP2_INT4_DECODE_CASES = (
    ("tp2_decode_gate", 8, 4096, 5504),
    ("tp2_decode_down", 8, 5504, 4096),
)
TP2_INT4_CASES = (
    ("tp2_dpo_gate", 2048, 4096, 5504),
    ("tp2_dpo_down", 2048, 5504, 4096),
    ("tp2_dpo_wo", 2048, 2048, 4096),
)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def seeded_image(path, size, mode="shortest_edge_crop"):
    """Image loader for synthetic requests: the path names a seed."""
    rng = np.random.default_rng(zlib.crc32(str(path).encode()))
    return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)


def phase_build():
    from vlrlhf_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all(KERNELS)
    print("build seconds:", json.dumps(_build.build_seconds), flush=True)
    for name, info in _build.ptxas_info.items():  # nvcc -Xptxas -v, all instantiations
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", info))
        serial = sorted(set(re.findall(r"\((C75\d\d)\)", info)))  # "wgmma ... serialized"
        print(f"ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores, wgmma serialization warnings "
              f"{serial or 'none'}", flush=True)


def check_close(what: str, got: torch.Tensor, ref: torch.Tensor, atol: float) -> tuple:
    """Kernel output vs its f32 plain version: max abs error <= atol and
    relative Frobenius error <= REL_TOL. Returns (max abs err, rel err,
    a report that names the median |ref| beside the tolerances)."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    err = float(diff.abs().max())
    rel = float(diff.norm() / ref.norm())
    med = float(ref.abs().median())
    if not (np.isfinite(err) and np.isfinite(rel)) or err > atol or rel > REL_TOL:
        raise AssertionError(f"{what}: max abs err {err:.3e} (tol {atol:.3e}), rel err "
                             f"{rel:.3e} (tol {REL_TOL}), median |ref| {med:.3e}")
    return err, rel, (f"max_abs_err={err:.3e} (tol {atol:.3e}) rel_err={rel:.3e} "
                      f"(tol {REL_TOL}) median|ref|={med:.3e}")


def _flash_bytes(lens, s, h, hkv, d, grads: str) -> int:
    """Bytes a flash launch must move on rows of valid lengths `lens` padded
    to `s`: each valid row's inputs read once (bf16 tensors, f32 LSE / di),
    the segment ids read in full, each output written in full (a padded
    row's output is 0 or -inf, but is written)."""
    n, n_all = sum(lens), len(lens) * s
    q, kv, row = h * d * 2, hkv * d * 2, h * 4
    seg = 2 * n_all * 4
    if grads == "fwd":  # q, k, v, seg -> o, lse
        return n * (q + 2 * kv) + seg + n_all * (q + row)
    if grads == "dkv":  # q, k, v, do, lse, di, seg -> dk, dv
        return n * (2 * q + 2 * kv + 2 * row) + seg + n_all * 2 * kv
    return n * (2 * q + 2 * kv + 2 * row) + seg + n_all * q  # dq


def _flash_flops(lens, h, d, causal: bool) -> float:
    """Matmul FLOPs of one attention forward (QK^T and PV) on rows of valid
    lengths `lens`: a row of length L attends L(L+1)/2 (query, key) pairs
    when causal, L^2 when not; padded rows and keys need none."""
    return 4.0 * h * d * sum(n * (n + 1) / 2 if causal else n * n for n in lens)


def flash_kernel_call(q, k, v, seg_q, seg_kv, causal: bool, scale: float):
    """A closure that launches the flash kernel's C entry point on outputs
    allocated once: the kernel's own time, without the wrapper's checks,
    allocations and segment ids (host ~10 us; no launch is counted)."""
    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.flash_attention import _FWD_ARGS

    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.fn("flash_fwd", "flash_fwd_bf16", _FWD_ARGS)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    return lambda: _build.check(fn(*args), "flash_fwd_bf16")


def flash_bwd_kernel_call(symbol: str, q, k, v, do, lse, di, seg_q, seg_kv, causal: bool,
                          scale: float):
    """A closure that launches flash backward entry point `symbol`
    (flash_bwd_dkv_bf16 or flash_bwd_dq_bf16) on outputs allocated once: the
    kernel's own time, without the wrapper's checks and allocations (no
    launch is counted)."""
    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.flash_attention import _BWD_ARGS, _bwd_args

    dq = torch.empty_like(q) if symbol == "flash_bwd_dq_bf16" else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if dq is None else (None, None)
    fn = _build.fn("flash_bwd", symbol, _BWD_ARGS)
    args = _bwd_args(q, k, v, do, lse, di, seg_q, seg_kv, dq, dk, dv, causal, scale)
    return lambda: _build.check(fn(*args), symbol)


def int4_kernel_call(name: str, a, d_c: int, d_in: int, d_out: int):
    """A closure (packed, scale) -> None launching int4 kernel `name`'s C
    entry point on an output allocated once (no launch is counted)."""
    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.int4 import _ARGS

    c = torch.empty((a.shape[0], d_c), dtype=torch.bfloat16, device=a.device)
    fn = _build.fn("int4_matmul", name, _ARGS)
    stream = torch.cuda.current_stream().cuda_stream

    def call(packed, scale):
        _build.check(fn(a.data_ptr(), packed.data_ptr(), scale.data_ptr(), c.data_ptr(),
                        a.shape[0], d_in, d_out, packed.shape[1], scale.shape[1], stream), name)
    return call


def phase_kernels():
    import torch.nn.functional as F

    from vlrlhf_torch.ops.flash_attention import (
        KV_PAD_SEG, Q_PAD_SEG, flash_attention, flash_attention_bwd_plain,
        flash_attention_plain, flash_bwd_dkv, flash_bwd_dq, make_segments,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    def segs(b, s, lens):
        lens_t = torch.tensor(lens or (s,) * b, device=dev)
        pad = torch.arange(s, device=dev)[None] < lens_t[:, None]
        return lens_t, pad, make_segments(b, s, dev, None, pad, Q_PAD_SEG), \
            make_segments(b, s, dev, None, pad, KV_PAD_SEG)

    flash_cases = [
        # (label, causal, B, S, H, Hkv, D, prompt lengths or None)
        ("vit_noncausal", False, 2, 577, 16, 16, 64, None),
        ("lm_causal_padded", True, 4, 640, 32, 32, 128, (600, 613, 627, 640)),
        ("lm_causal_gqa", True, 2, 640, 32, 8, 128, (640, 601)),
        ("dpo_lm_causal", True, 2, 1024, 32, 32, 128, (1000, 900)),
        # the CE ranking forward of eval: 16 right-padded rows of uneven length
        ("ce_rows_padded", True, 16, 640, 32, 32, 128, CE_LENS),
        # ppo's stats and update forwards: a minibatch of 4 right-padded rows
        ("ppo_update_padded", True, 4, 768, 32, 32, 128, PPO_LENS),
        # phase 11: the anyres tower (2 prefill requests x 5 tiles), the EVA
        # tower (D = 88: TMA zero-fills to 128) and the mistral LM's DPO pair
        ("anyres_tiles_noncausal", False, 10, 577, 16, 16, 64, None),
        ("eva_noncausal_d88", False, 16, 257, 16, 16, 88, None),
        ("mistral_gqa_4096", True, 2, 4096, 32, 8, 128, MISTRAL_LENS),
        # phase 12: Qwen's ViT-bigG (D = 104, 13 x 16 bytes in the 128-wide
        # tile) and XC2's CLIP at 490 px (S = 1,226), 8 images each (a
        # serving group); the resampler's non-square call follows below
        ("qwen_tower_d104", False, 8, 1024, 16, 16, 104, None),
        ("xc2_tower_s1226", False, 8, 1226, 16, 16, 64, None),
        # phase 13: a rank's heads under --mesh_model 2 (LLaVA 32 -> 16,
        # Mistral's GQA 32/8 -> 16/4) on the DPO pair's S = 1024
        *TP2_FLASH_CASES,
        # phase 15: a stage's microbatch under --mesh_pipe 2
        *PIPE_FLASH_CASES,
    ]
    errs, times = [], {}
    for label, causal, b, s, h, hkv, d, lens in flash_cases:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_t, pad, seg_q, seg_kv = segs(b, s, lens)
        out = flash_attention(q, k, v, causal=causal, pad_mask_q=pad, pad_mask_kv=pad)
        torch.cuda.synchronize()
        ref, _ = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv,
                                       causal, d**-0.5)
        err, _, report = check_close(f"flash {label}", out[pad], ref[pad], TOL)  # valid rows
        # the kernel alone (segment ids built once, outside the timing) and
        # the wrapper as the model calls it (segment ids built per call)
        k_ms = time_ms(flash_kernel_call(q, k, v, seg_q, seg_kv, causal, d**-0.5))
        w_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, pad_mask_q=pad,
                                               pad_mask_kv=pad))
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, seg_q, seg_kv, causal,
                                                     d**-0.5), iters=5)
        # yardstick: PyTorch's SDPA on the same (B, H, S, D) views and the
        # same function: rows with padding take one boolean mask, causal
        # and the keys' pad mask together
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if lens is not None:
            mask = pad[:, None, None, :]
            if causal:
                mask = mask & torch.ones((s, s), dtype=torch.bool, device=dev).tril()
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != hkv))
        flops = _flash_flops(lens or (s,) * b, h, d, causal)
        b_ms, b_by = bound(flops, _flash_bytes(lens or (s,) * b, s, h, hkv, d, "fwd"))
        print(f"flash {label} B={b} S={s} H={h} Hkv={hkv} D={d}: {report}; "
              f"kernel alone {k_ms:.4f} ms ({flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{k_ms / l_ms:.2f}x sdpa), wrapper {w_ms:.4f} ms "
              f"({flops / (w_ms * 1e-3) / 1e12:.1f} TFLOP/s, {w_ms / l_ms:.2f}x sdpa), "
              f"plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms "
              f"({flops / (l_ms * 1e-3) / 1e12:.1f} TFLOP/s), bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        errs.append(err)
        times[label] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by}
    err, times["resampler_256x1024"] = resampler_flash_case(randn)
    errs.append(err)
    main = times["dpo_lm_causal"]
    results["flash_fwd"] = {"max_abs_err": max(errs), **main, "cases": times,
                            "eval": times["ce_rows_padded"], "ppo": times["ppo_update_padded"],
                            "families": {k: times[k] for k in (
                                "anyres_tiles_noncausal", "eva_noncausal_d88", "mistral_gqa_4096",
                                "qwen_tower_d104", "resampler_256x1024", "xc2_tower_s1226")},
                            "tp": {c[0]: times[c[0]] for c in TP2_FLASH_CASES},
                            "pipe": {c[0]: times[c[0]] for c in PIPE_FLASH_CASES}}

    # backward: the DPO path's LM case, a GQA case and an unfrozen tower's
    # (D = 64, non-causal, the 2 tiled rows of one pair)
    bwd_cases = [
        ("dpo_lm_causal", True, 2, 1024, 32, 32, 128, (1000, 900)),
        ("lm_causal_gqa", True, 2, 640, 32, 8, 128, (640, 601)),
        ("vit_noncausal", False, 2, 577, 16, 16, 64, (577, 577)),
        ("ppo_update_padded", True, 4, 768, 32, 32, 128, PPO_LENS),
        # phase 11: an unfrozen EVA tower (D = 88) and the mistral DPO pair
        ("eva_noncausal_d88", False, 16, 257, 16, 16, 88, (257,) * 16),
        ("mistral_gqa_4096", True, 2, 4096, 32, 8, 128, MISTRAL_LENS),
        *TP2_FLASH_CASES,
        *PIPE_FLASH_CASES,
    ]
    bwd = {"dkv": {}, "dq": {}}
    bwd_errs = {"dkv": [], "dq": []}
    for label, causal, b, s, h, hkv, d, lens in bwd_cases:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_t, pad, seg_q, seg_kv = segs(b, s, lens)
        do = torch.where(pad[..., None, None], randn(b, s, h, d), 0).contiguous()
        o, lse = flash_attention(q, k, v, causal=causal, pad_mask_q=pad, pad_mask_kv=pad,
                                 return_lse=True)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        scale = d**-0.5
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        torch.cuda.synchronize()
        rq, rk, rv = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                               lse, di, seg_q, seg_kv, causal, scale)
        checks = {"dq": (dq[pad].float(), rq[pad]), "dk": (dk.float(), rk),
                  "dv": (dv.float(), rv)}
        line = []
        for name, (got, ref) in checks.items():
            err, _, report = check_close(f"flash backward {label} {name}", got, ref,
                                         TOL * max(1.0, float(ref.abs().max())))
            bwd_errs["dq" if name == "dq" else "dkv"].append(err)
            line.append(f"{name} {report}")
        args = (q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        # each kernel alone (its C entry point on outputs allocated once) and
        # through its wrapper, as FlashAttention.backward calls it
        ms = {"dkv": time_ms(flash_bwd_kernel_call("flash_bwd_dkv_bf16", *args)),
              "dq": time_ms(flash_bwd_kernel_call("flash_bwd_dq_bf16", *args))}
        w_ms = {"dkv": time_ms(lambda: flash_bwd_dkv(*args)),
                "dq": time_ms(lambda: flash_bwd_dq(*args))}
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(*args), iters=3, warmup=1)
        # yardsticks: SDPA forward+backward, and its flash backward alone
        # (one aten call computing dQ, dK, dV from O and the LSE). It takes
        # as many K / V heads as query heads, so under GQA K and V are
        # expanded to H heads before the timed call; its dK / dV then come
        # per query head, without the group sum the kernels do
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=h != hkv)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        fb_ms = time_ms(sdpa_fwd_bwd)
        ke, ve = (t.detach().repeat_interleave(h // hkv, dim=1) for t in (kt, vt))
        with torch.no_grad():
            fo = torch.ops.aten._scaled_dot_product_flash_attention(
                qt.detach(), ke, ve, 0.0, causal, False, scale=scale)
        lib_bwd_ms = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt.detach(), ke, ve, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0, causal,
            fo[6], fo[7], scale=scale))
        fwd_flops = _flash_flops(lens, h, d, causal)
        bounds = {"dkv": bound(2.0 * fwd_flops, _flash_bytes(lens, s, h, hkv, d, "dkv")),
                  "dq": bound(1.5 * fwd_flops, _flash_bytes(lens, s, h, hkv, d, "dq"))}
        pair_bound = bound(2.5 * fwd_flops, _flash_bytes(lens, s, h, hkv, d, "dkv") + b * s * h * d * 2)
        flops = {"dkv": 2.0 * fwd_flops, "dq": 1.5 * fwd_flops}
        kern = ", ".join(
            f"{kname} kernel alone / wrapper {ms[kname]:.4f} / {w_ms[kname]:.4f} ms "
            f"({flops[kname] / (ms[kname] * 1e-3) / 1e12:.1f} TFLOP/s alone, bound "
            f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]}), "
            f"{bounds[kname][0] / ms[kname]:.2f} of it)" for kname in ("dkv", "dq"))
        print(f"flash backward {label} causal={causal} B={b} S={s} H={h} Hkv={hkv} D={d}: "
              + ", ".join(line)
              + f"; {kern}; pair alone {ms['dkv'] + ms['dq']:.4f} ms, through the wrappers "
              f"{w_ms['dkv'] + w_ms['dq']:.4f} ms (bound at 2.5x forward "
              f"{pair_bound[0]:.4f} ms); plain {plain_ms:.4f} ms; sdpa fwd+bwd {fb_ms:.4f} ms, "
              f"aten flash backward alone {lib_bwd_ms:.4f} ms"
              + (f" (K / V expanded to {h} heads, no group sum)" if h != hkv else ""),
              flush=True)
        for kname in ("dkv", "dq"):
            bwd[kname][label] = (ms[kname], plain_ms, lib_bwd_ms, *bounds[kname], fb_ms,
                                 w_ms[kname])
        del qt, kt, vt, ke, ve, fo
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "sdpa_fwd_bwd_ms",
            "wrapper_ms")
    for kname in ("dkv", "dq"):
        results[f"flash_bwd_{kname}"] = {
            "max_abs_err": max(bwd_errs[kname]),
            **dict(zip(keys, bwd[kname]["dpo_lm_causal"])), "cases": bwd[kname],
            "ppo": dict(zip(keys, bwd[kname]["ppo_update_padded"])),
            "families": {k: dict(zip(keys, bwd[kname][k]))
                         for k in ("eva_noncausal_d88", "mistral_gqa_4096")},
            "tp": {c[0]: dict(zip(keys, bwd[kname][c[0]])) for c in TP2_FLASH_CASES},
            "pipe": {c[0]: dict(zip(keys, bwd[kname][c[0]])) for c in PIPE_FLASH_CASES},
        }

    results["decode_attention"] = decode_kernel_checks(randn)
    results["chunk_attention"] = chunk_kernel_checks(randn)
    results.update(int4_kernel_checks(gen))
    wrapper_host_us()
    return results


def resampler_flash_case(randn, b: int = 8, sq: int = 256, skv: int = 1024, h: int = 32,
                         d: int = 128) -> tuple:
    """Kernel 1 at Qwen-VL's resampler shape: 256 queries over 1,024 keys,
    32 heads of 128, no mask (the non-square contract of a non-causal
    call), 8 images; kernel alone, through the wrapper, plain, SDPA and the
    bound (each input read once, O written once). Returns (max abs err,
    times)."""
    import torch.nn.functional as F

    from vlrlhf_torch.ops.flash_attention import (
        KV_PAD_SEG, Q_PAD_SEG, flash_attention, flash_attention_plain, make_segments,
    )

    dev = torch.device("cuda")
    q, k, v = randn(b, sq, h, d), randn(b, skv, h, d), randn(b, skv, h, d)
    seg_q = make_segments(b, sq, dev, None, None, Q_PAD_SEG)
    seg_kv = make_segments(b, skv, dev, None, None, KV_PAD_SEG)
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    ref, _ = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv, False,
                                   d**-0.5)
    err, _, report = check_close("flash resampler_256x1024", out, ref, TOL)
    k_ms = time_ms(flash_kernel_call(q, k, v, seg_q, seg_kv, False, d**-0.5))
    w_ms = time_ms(lambda: flash_attention(q, k, v, causal=False))
    p_ms = time_ms(lambda: flash_attention_plain(q, k, v, seg_q, seg_kv, False, d**-0.5),
                   iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4.0 * b * h * sq * skv * d
    b_ms, b_by = bound(flops, 2 * (2 * b * sq * h * d + 2 * b * skv * h * d))
    print(f"flash resampler_256x1024 B={b} Sq={sq} Skv={skv} H={h} D={d} (non-causal): {report}; "
          f"kernel alone {k_ms:.4f} ms ({flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{k_ms / l_ms:.2f}x sdpa), wrapper {w_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa "
          f"{l_ms:.4f} ms ({flops / (l_ms * 1e-3) / 1e12:.1f} TFLOP/s), bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    return err, {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms, "library_ms": l_ms,
                 "bound_ms": b_ms, "bound_by": b_by}


def int4_kernel_checks(gen) -> dict:
    """Kernels 6 and 7 (csrc/int4_matmul.cu) against their plain versions on
    the same bf16 operands, f32 plain: LLaVA-1.5-7B's gate/up (4096 ->
    11008) and down (11008 -> 4096) at decode (T=8), a verify chunk (T=32),
    a B=2 prefill (T=1280; kernel 6 only) and the DPO step (T=2048; for
    kernel 7 also the attention projections, 4096 -> 4096, 125 of its 221
    launches a QLoRA step), and edge shapes (in 384: odd n_lo and a padded
    half; out 200; T=5 on the cluster kernel and the dx kernel's smallest
    tile, T=65 and 129 on the wgmma ones). Operands are scaled so outputs
    have unit variance. Times: the kernel alone (its C entry point on a
    preallocated output) and through its wrapper, plain, and cuBLAS bf16 on the weight dequantized once
    outside the timing (library_ms), beside the bound. At T <= 32 the
    weights rotate over 4 copies (96 MB, more than the 50 MB L2), as a step
    reads 225 distinct weights. The main entries are decode gate/up (kernel
    6, the serving path) and the DPO gate (kernel 7)."""
    import itertools

    from vlrlhf_torch.ops.int4 import (
        dequantize_int4, int4_matmul, int4_matmul_plain, int4_matmul_t, int4_matmul_t_plain,
        quantize_int4,
    )

    dev = torch.device("cuda")
    weights = {}

    def weight(d_in, d_out):
        if (d_in, d_out) not in weights:
            w = torch.randn((d_out, d_in), device=dev, generator=gen) * d_in**-0.5
            packed, scale = quantize_int4(w)
            weights[(d_in, d_out)] = (packed, scale, dequantize_int4(packed, scale))
        return weights[(d_in, d_out)]

    fwd = [("decode_gate", 8, 4096, 11008), ("decode_down", 8, 11008, 4096),
           ("verify_gate", 32, 4096, 11008), ("verify_down", 32, 11008, 4096),
           ("prefill_gate", 1280, 4096, 11008), ("prefill_down", 1280, 11008, 4096),
           ("dpo_gate", 2048, 4096, 11008), ("dpo_down", 2048, 11008, 4096),
           ("edge", 5, 384, 200), ("edge_wgmma", 65, 384, 200), *TP2_INT4_CASES,
           *TP2_INT4_DECODE_CASES]
    bwd = [("dpo_gate", 2048, 4096, 11008), ("dpo_down", 2048, 11008, 4096),
           ("dpo_attn", 2048, 4096, 4096), ("edge", 5, 384, 200), ("edge_wgmma", 129, 384, 200),
           *TP2_INT4_CASES]
    results = {}
    for name, cases, kern, plain in (("int4_matmul", fwd, int4_matmul, int4_matmul_plain),
                                     ("int4_matmul_t", bwd, int4_matmul_t, int4_matmul_t_plain)):
        by_case, errs = {}, []
        for label, t, d_in, d_out in cases:
            packed, scale, wdeq = weight(d_in, d_out)
            width, scale_a = (d_in, 1.0) if name == "int4_matmul" else (d_out, (d_in / d_out) ** 0.5)
            a = (torch.randn((t, width), device=dev, generator=gen) * scale_a).to(torch.bfloat16)
            got = kern(a, packed, scale)
            torch.cuda.synchronize()
            err, rel, report = check_close(f"{name} {label}", got, plain(a.float(), packed, scale),
                                           TOL)
            # the kernel alone (its C entry point) and through its wrapper
            alone = int4_kernel_call(name, a, d_out if name == "int4_matmul" else d_in, d_in,
                                     d_out)
            if label.startswith(("decode", "verify", "tp2_decode")):
                copies = itertools.cycle([(packed, scale)] + [(packed.clone(), scale.clone())
                                                              for _ in range(3)])
                k_ms = time_ms(lambda: alone(*next(copies)), iters=40)
                w_ms = time_ms(lambda: kern(a, *next(copies)), iters=40)
            else:
                k_ms = time_ms(lambda: alone(packed, scale), iters=10)
                w_ms = time_ms(lambda: kern(a, packed, scale), iters=10)
            p_ms = time_ms(lambda: plain(a, packed, scale), iters=3, warmup=1)
            if name == "int4_matmul":
                l_ms = time_ms(lambda: a @ wdeq.T, iters=10)
            else:
                l_ms = time_ms(lambda: a @ wdeq, iters=10)
            w_bytes = packed.numel() + 2 * scale.numel()
            nbytes = w_bytes + 2 * t * (d_in + d_out)
            b_ms, b_by = bound(2.0 * t * d_in * d_out, nbytes)
            print(f"{name} {label} T={t} in={d_in} out={d_out}: {report}; kernel alone "
                  f"{k_ms:.4f} ms ({k_ms / l_ms:.2f}x cublas), wrapper {w_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms cublas bf16 on the dequantized weight {l_ms:.4f} ms "
                  f"bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.3f} MB, "
                  f"{2.0 * t * d_in * d_out / 1e9:.3f} GFLOP); {nbytes / (k_ms * 1e-3) / 1e9:.1f} "
                  f"GB/s, {2.0 * t * d_in * d_out / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s", flush=True)
            errs.append(err)
            by_case[label] = {"max_abs_err": err, "rel_err": rel, "ms": k_ms, "wrapper_ms": w_ms,
                              "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                              "bound_by": b_by}
        main = by_case["decode_gate" if name == "int4_matmul" else "dpo_gate"]
        results[name] = {**{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")},
                         "max_abs_err": max(errs), "cases": by_case,
                         "tp": {c[0]: by_case[c[0]] for c in cases if c[0].startswith("tp2")}}
    weights.clear()
    torch.cuda.empty_cache()
    return results


def decode_kernel_checks(randn) -> dict:
    """Decode attention vs its plain version, bf16 and int8 caches, nh =
    nkv = 32, hd 128, a stacked 32-layer cache of 1024 slots read at layer
    17, at two shapes: the serve's B=8 (rows of lengths 0, S - 1, 1 and in
    between; 256 CTAs, S not split) and a /chat session's B=1 (lengths 0
    and 613; S split across a cluster of CTAs, merged with the self term
    in distributed shared memory). Times at every row's length 640 and S - 1
    (B=8) and 613 (B=1): the kernel alone (its C entry point on an output
    allocated once) and through its wrapper, each launch on the next of
    layers 17-20 so the cache comes from device memory as it does on the
    path, beside plain, SDPA of the one query over the live slots (over
    the dequantized cache for int8; the self term has no counterpart
    there) and the bound. The main entry is B=8 bf16 at length 640; "int8"
    holds the B=8 int8 one, "chat" both B=1 ones, "eval" the B=16 bf16 one
    (eval's static Generator; rows of EVAL_LENS, on an 8-layer cache read
    at layers 2-5), "ppo" the B=8 bf16 one of ppo's rollouts (rows of
    PPO_DECODE_LENS, timed at 672), "families" phase 11b's LLaVA-Next
    mistral slots (B=8, GQA nh 32 / nkv 8, 3,200-slot caches on 4 layers,
    rows of MISTRAL_DECODE_LENS, timed at 3,000), bf16 and int8; "tp" one
    rank's heads under --mesh_model 2 (ppo's rollouts and dpo's eval
    samples): B=8 at nh = nkv = 16 (length 640) and mistral's GQA 16 / 4
    over ~3,000 tokens, bf16 and int8."""
    import torch.nn.functional as F

    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.decode_attention import (
        _ARGS, c_args, decode_attention, decode_attention_plain,
    )
    from vlrlhf_torch.ops.quant import dequantize_kv, quantize_kv

    dev = torch.device("cuda")
    nh, hd = 32, 128
    fn = _build.fn("decode_attention", "decode_attention", _ARGS)
    results = {}
    for shape, b, L, layer, nkv, sc, checked, timed, kinds in (
            ("serve", 8, 32, 17, 32, 1024, [(0, 1023, 600, 613, 1, 640, 827, 128)],
             (640, 1023), ("bf16", "int8")),
            ("chat", 1, 32, 17, 32, 1024, [(0,), (613,)], (613,), ("bf16", "int8")),
            # eval's static Generator: 16 rows of ~600-700 tokens
            ("eval", 16, 8, 2, 32, 1024, [EVAL_LENS, (0, 1023) * 8], (640,), ("bf16",)),
            # ppo's rollouts: 8 slots of ~650-700 tokens
            ("ppo", 8, 8, 2, 32, 1024, [PPO_DECODE_LENS], (672,), ("bf16",)),
            # phase 11b: LLaVA-Next mistral's 8 slots, GQA 32/8 (g = 4), over
            # ~3,000-token anyres caches
            ("mistral", 8, 4, 0, 8, MISTRAL_SC,
             [MISTRAL_DECODE_LENS, (0, MISTRAL_SC - 1, 1, 2999, 3000, 3001, 1500, 3100)],
             (3000,), ("bf16", "int8")),
            # one rank of --mesh_model 2: 16 of LLaVA-1.5-7B's 32 heads, and
            # 16 / 4 of LLaVA-Next mistral's GQA 32 / 8 (g = 4)
            ("tp_h16", 8, 8, 2, 16, 1024, [PPO_DECODE_LENS, (0, 1023, 600, 613, 1, 640, 827, 128)],
             (640,), ("bf16", "int8")),
            ("tp_gqa", 8, 4, 0, 4, MISTRAL_SC, [MISTRAL_DECODE_LENS], (3000,), ("bf16", "int8"))):
        nh = 16 if shape.startswith("tp") else 32
        timed_layers = range(layer, layer + 4)
        q = randn(b, nh, hd)
        kc, vc = randn(L, b, nkv, sc, hd), randn(L, b, nkv, sc, hd)
        k_cur, v_cur = randn(b, nkv, hd), randn(b, nkv, hd)
        o = torch.empty_like(q)
        qs = q[:, :, None]
        for kind in kinds:
            if kind == "int8":
                # the int8 cache of the speculative int8 serve and /chat: the
                # same values quantized per vector; plain and SDPA read the codes
                (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
            else:
                ks = vs = None
            lks = None if ks is None else ks[layer]
            lvs = None if vs is None else vs[layer]
            errs, rels = [], []
            for lens in checked:
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                out = decode_attention(q, kc, vc, k_cur, v_cur, lengths, layer=layer,
                                       k_scale=ks, v_scale=vs)
                torch.cuda.synchronize()
                ref = decode_attention_plain(q.float(), kc[layer].float(), vc[layer].float(),
                                             k_cur.float(), v_cur.float(), lengths, hd**-0.5,
                                             lks, lvs)
                err, rel, report = check_close(f"decode {shape} {kind} lengths {list(lens)}",
                                               out, ref, TOL)
                print(f"decode {shape} {kind} B={b} lengths {list(lens)}: {report}", flush=True)
                errs.append(err)
                rels.append(rel)
            kd = [kc[i] if ks is None else dequantize_kv(kc[i], ks[i], torch.bfloat16)
                  for i in timed_layers]
            vd = [vc[i] if vs is None else dequantize_kv(vc[i], vs[i], torch.bfloat16)
                  for i in timed_layers]
            cases = {}
            for length in timed:
                lengths_t = torch.full((b,), length, dtype=torch.int32, device=dev)
                alone = _build.Rotating(fn, [c_args(q, kc, vc, k_cur, v_cur, lengths_t, o,
                                                    hd**-0.5, i, ks, vs) for i in timed_layers],
                                        "decode_attention")
                k_ms = time_ms(alone, iters=100, warmup=8)
                wrap = itertools.cycle(timed_layers)
                w_ms = time_ms(lambda: decode_attention(q, kc, vc, k_cur, v_cur, lengths_t,
                                                        layer=next(wrap), k_scale=ks, v_scale=vs),
                               iters=100, warmup=8)
                p_ms = time_ms(lambda: decode_attention_plain(q, kc[layer], vc[layer], k_cur,
                                                              v_cur, lengths_t, hd**-0.5, lks, lvs))
                live = (torch.arange(sc, device=dev) < length)[None, None, None, :]
                pairs = itertools.cycle(list(zip(kd, vd)))
                l_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, *next(pairs), attn_mask=live, enable_gqa=nh != nkv), iters=100)
                row = hd + 2 if ks is not None else 2 * hd  # int8: codes and one bf16 scale
                live_bytes = 2 * b * nkv * length * row
                b_ms, b_by = bound(4.0 * b * nh * (length + 1) * hd,
                                   live_bytes + 2 * b * nkv * hd * 2 + 2 * b * nh * hd * 2 + b * 4)
                print(f"decode {shape} {kind} B={b} L={L} nh={nh} nkv={nkv} hd={hd} Sc={sc} layers "
                      f"{timed_layers[0]}-{timed_layers[-1]} length {length}: kernel alone "
                      f"{k_ms:.4f} ms ({live_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s of live k/v, "
                      f"{k_ms / l_ms:.2f}x sdpa), wrapper {w_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"sdpa ({'dequantized ' if ks is not None else ''}cache, masked) "
                      f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
                cases[f"length_{length}"] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                                             "library_ms": l_ms, "bound_ms": b_ms,
                                             "bound_by": b_by}
            results[f"{shape}_{kind}"] = {"max_abs_err": max(errs), "rel_err": max(rels),
                                          **cases[f"length_{timed[0]}"], "cases": cases}
            del kd, vd
        del kc, vc, ks, vs
        torch.cuda.empty_cache()
    return {**results["serve_bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "int8": results["serve_int8"],
            "chat": {"bf16": results["chat_bf16"], "int8": results["chat_int8"]},
            "eval": results["eval_bf16"], "ppo": results["ppo_bf16"],
            "families": {"bf16": results["mistral_bf16"], "int8": results["mistral_int8"]},
            "tp": {k: results[f"tp_{k}"] for k in ("h16_bf16", "h16_int8", "gqa_bf16",
                                                   "gqa_int8")}}


def wrapper_host_us() -> dict:
    """Host microseconds per wrapper call: 200 calls enqueued without a
    synchronize on tiny shapes (the card never holds the host back), wall
    clock over the count. Includes the Python checks, allocations and the
    ctypes call; the kernels' prototypes are set once per library."""
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import _launch as flash_launch
    from vlrlhf_torch.ops.flash_attention import flash_attention, make_segments
    from vlrlhf_torch.ops.int4 import int4_matmul, quantize_int4

    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    q, k, v = (torch.randn((1, 64, 2, 64), **bf) for _ in range(3))
    pad = torch.ones((1, 64), dtype=torch.bool, device=dev)
    seg = make_segments(1, 64, dev, None, None, 0)
    packed, scale = quantize_int4(torch.randn((256, 1024), device=dev))
    x = torch.randn((8, 1024), **bf)
    kc, vc = torch.randn((2, 1, 2, 64, 64), **bf), torch.randn((2, 1, 2, 64, 64), **bf)
    qd, cur = torch.randn((1, 2, 64), **bf), torch.randn((1, 2, 64), **bf)
    qc = torch.randn((1, 4, 2, 64), **bf)
    lengths = torch.full((1,), 30, dtype=torch.int32, device=dev)
    calls = {
        "flash_fwd wrapper": lambda: flash_attention(q, k, v, causal=True, pad_mask_q=pad,
                                                     pad_mask_kv=pad),
        "flash_fwd _launch": lambda: flash_launch(q, k, v, seg, seg, True, 0.125),
        "int4_matmul": lambda: int4_matmul(x, packed, scale),
        "decode_attention": lambda: decode_attention(qd, kc, vc, cur, cur, lengths, layer=1),
        "chunk_attention": lambda: chunk_attention(qc, kc, vc, lengths, layer=1),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print("wrapper host us per call (200 calls, no synchronize, tiny shapes): "
          + json.dumps({n: round(us, 2) for n, us in out.items()}), flush=True)
    return out


def _chunk_work(lengths, c, nh, nkv, hd, sc, int8: bool) -> tuple[float, int]:
    """(FLOPs, bytes) one chunk launch needs: QK^T and PV of each query over
    the slots it attends; q read and o written once (bf16), each live k and
    v row read once (int8 codes and a bf16 scale, or bf16), the lengths."""
    attended = sum(min(n + i + 1, sc) for n in lengths for i in range(c))
    live = sum(min(n + c, sc) for n in lengths)
    row = hd + 2 if int8 else 2 * hd
    b = len(lengths)
    return 4.0 * nh * hd * attended, 2 * b * c * nh * hd * 2 + 2 * nkv * live * row + 4 * b


def chunk_kernel_checks(randn) -> dict:
    """Chunk attention vs its plain version at the speculative verify shape
    (B=8, C=4 = K+1; the CUDA-core path, S not split), a chat turn's (B=1,
    C=64; the tensor-core path) and a short chat turn's (B=1, C=16: 16 rows
    on the CUDA cores with S split across a cluster of CTAs), nh = nkv =
    32, hd 128, Sc 1024, lengths ~600-700, on a stacked cache (4 layers
    for verify, 8 for chat) checked at layer 2; bf16 and int8 caches. Times: the kernel alone (its C entry point on
    an output allocated once) and through its wrapper, each launch on the
    next layer (more than the L2 in all), beside plain, SDPA with an
    explicit mask (over the dequantized cache for int8) and the bound. The
    main entry is the int8 verify shape (the speculative int8 serve's);
    "eval" holds B=16, C=4 (the static speculative verify over eval's
    batch), bf16 and int8; "families" phase 11b's mistral verify (B=8, C=4,
    GQA 32/8 so g * C = 16, caches of ~3,000 tokens in 3,200 slots); "tp"
    one rank's 16 heads of --mesh_model 2 at the verify shape (no mesh path
    reaches kernel 5: checked at kernel level)."""
    import torch.nn.functional as F

    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.chunk_attention import (
        _ARGS, c_args, chunk_attention, chunk_attention_plain,
    )
    from vlrlhf_torch.ops.quant import dequantize_kv, quantize_kv

    dev = torch.device("cuda")
    nh, hd, layer = 32, 128, 2
    fn = _build.fn("chunk_attention", "chunk_attention", _ARGS)
    cases, errs = {}, []
    for label, lens, c, L, nkv, sc in (
            ("verify", (600, 613, 627, 640, 655, 671, 688, 700), 4, 4, 32, 1024),
            ("chat", (620,), 64, 8, 32, 1024), ("chat_short", (620,), 16, 8, 32, 1024),
            # the static SpeculativeGenerator's verify over eval's batch
            ("eval_verify", EVAL_LENS, 4, 4, 32, 1024),
            # phase 11b's speculative verify on mistral: g * C = 4 * 4 = 16
            # rows per KV head, the CUDA-core path's limit
            ("mistral_verify", MISTRAL_DECODE_LENS, 4, 4, 8, MISTRAL_SC),
            # one rank of --mesh_model 2 at the verify shape: 16 of 32 heads
            ("tp_verify", (600, 613, 627, 640, 655, 671, 688, 700), 4, 4, 16, 1024)):
        nh = 16 if label.startswith("tp") else 32
        b = len(lens)
        q = randn(b, c, nh, hd)
        kc, vc = randn(L, b, nkv, sc, hd), randn(L, b, nkv, sc, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        limit = lengths[:, None] + torch.arange(c, device=dev)[None]
        attend = torch.arange(sc, device=dev)[None, None, :] <= limit[:, :, None]  # (B, C, Sc)
        qt = q.transpose(1, 2)  # SDPA's (B, nh, C, hd)
        o = torch.empty_like(q)
        (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
        for kind, (kk, vv, ksc, vsc) in (("bf16", (kc, vc, None, None)),
                                         ("int8", (kq, vq, ks, vs))):
            lks = None if ksc is None else ksc[layer]
            lvs = None if vsc is None else vsc[layer]
            out = chunk_attention(q, kk, vv, lengths, layer=layer, k_scale=ksc, v_scale=vsc)
            torch.cuda.synchronize()
            ref = chunk_attention_plain(q.float(), kk[layer], vv[layer], lengths, hd**-0.5,
                                        lks, lvs)
            err, rel, report = check_close(f"chunk {label} {kind}", out, ref, TOL)
            alone = _build.Rotating(fn, [c_args(q, kk, vv, lengths, o, hd**-0.5, i, ksc, vsc)
                                         for i in range(L)], "chunk_attention")
            k_ms = time_ms(alone, iters=100, warmup=8)
            wrap = itertools.cycle(range(L))
            w_ms = time_ms(lambda: chunk_attention(q, kk, vv, lengths, layer=next(wrap),
                                                   k_scale=ksc, v_scale=vsc), iters=100, warmup=8)
            p_ms = time_ms(lambda: chunk_attention_plain(q, kk[layer], vv[layer], lengths,
                                                         hd**-0.5, lks, lvs), iters=10)
            kd = [kk[i] if ksc is None else dequantize_kv(kk[i], ksc[i], torch.bfloat16)
                  for i in range(L)]
            vd = [vv[i] if vsc is None else dequantize_kv(vv[i], vsc[i], torch.bfloat16)
                  for i in range(L)]
            pairs = itertools.cycle(list(zip(kd, vd)))
            l_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, *next(pairs), attn_mask=attend[:, None], enable_gqa=nh != nkv), iters=100)
            del kd, vd
            flops, nbytes = _chunk_work(lens, c, nh, nkv, hd, sc, ksc is not None)
            b_ms, b_by = bound(flops, nbytes)
            print(f"chunk {label} {kind} B={b} C={c} L={L} nh={nh} nkv={nkv} hd={hd} Sc={sc} "
                  f"lengths {list(lens)}: {report}; kernel alone {k_ms:.4f} ms "
                  f"({k_ms / l_ms:.2f}x sdpa, {flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{nbytes / (k_ms * 1e-3) / 1e9:.1f} GB/s), wrapper {w_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, sdpa (masked, {'dequantized ' if ksc is not None else ''}cache) "
                  f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.3f} MB)", flush=True)
            errs.append(err)
            cases[f"{label}_{kind}"] = {"max_abs_err": err, "rel_err": rel, "ms": k_ms,
                                        "wrapper_ms": w_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                        "bound_ms": b_ms, "bound_by": b_by}
        del kc, vc, kq, vq, ks, vs
        torch.cuda.empty_cache()
    main = cases["verify_int8"]
    return {"max_abs_err": max(errs), "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "cases": cases,
            "eval": {"bf16": cases["eval_verify_bf16"], "int8": cases["eval_verify_int8"]},
            "families": {"bf16": cases["mistral_verify_bf16"],
                         "int8": cases["mistral_verify_int8"]},
            "tp": {"verify_bf16": cases["tp_verify_bf16"], "verify_int8": cases["tp_verify_int8"]}}


def make_processor(cfg):
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES

    family = FAMILIES[cfg.family]
    pcfg = ProcessorConfig(
        **{**family.processor_defaults, "image_token_id": 3,  # ToyTokenizer <image>
           "num_image_tokens": cfg.num_image_tokens}
    )
    # word ids below the 32064-row vocabulary
    return VLProcessor(ToyTokenizer(vocab_size=32000), family.template, pcfg)


def phase_reduced_depth():
    import dataclasses

    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device, prefill
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    full = _llava_7b(torch.float32)
    cfg32 = dataclasses.replace(
        full,
        lm=dataclasses.replace(full.lm, num_layers=2),
        vision=dataclasses.replace(full.vision, num_layers=2),
    )
    cfg16 = dataclasses.replace(
        cfg32,
        lm=dataclasses.replace(cfg32.lm, dtype=torch.bfloat16),
        vision=dataclasses.replace(cfg32.vision, dtype=torch.bfloat16),
    )
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    gpu = VLM(cfg16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    proc = make_processor(cfg32)
    prompt = proc.format_multimodal_prompt("describe the picture in detail", 1)
    ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
    batch = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)(
        [{"input_ids": ids, "img_path": "reduced.png"}]
    )
    gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    logits = {}
    tokens = {}
    with torch.inference_mode():
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            _, _, _, _, _, last = prefill(
                model, gen_cfg, 768, t["input_ids"], t["pad_mask"], t["prompt_lens"],
                t["pixel_values"], t["image_positions"], None,
            )
            logits[name] = last.float().cpu()
            tokens[name] = Generator(model, gen_cfg)(batch).cpu()[0].tolist()
    ref, got = logits["cpu"], logits["cuda"]
    if not torch.isfinite(got).all():
        raise AssertionError("reduced-depth logits on the card are not finite")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    agree = sum(int(a == b) for a, b in zip(tokens["cuda"], tokens["cpu"]))
    top2 = torch.topk(ref[0], 2).values
    gap = float(top2[0] - top2[1])
    print(f"reduced depth (2 LM / 2 tower layers, full widths, prompt "
          f"{int(batch['prompt_lens'][0])} tokens): logit max_abs_err={err:.4e} "
          f"rel={rel:.3e} (tol {LOGIT_REL_TOL}); greedy tokens agree {agree}/8; "
          f"cuda {tokens['cuda']} cpu {tokens['cpu']}", flush=True)
    if rel > LOGIT_REL_TOL:
        raise AssertionError(f"reduced-depth logits differ: rel {rel} > {LOGIT_REL_TOL}")
    if gap > 2 * err and tokens["cuda"][0] != tokens["cpu"][0]:
        raise AssertionError("first greedy token differs though its margin exceeds the error")
    with torch.inference_mode():
        reduced_depth_chunks(cpu, gpu, batch)
        reduced_depth_spec(cpu, gpu, proc, err)
    reduced_depth_int4(cpu, gpu, batch)
    del cpu, gpu
    torch.cuda.empty_cache()


def share_int4(cpu, gpu, patterns, what: str) -> int:
    """Quantize the CPU model's linears that match `patterns` to int4 once,
    on the CPU from its f32 weights, and hand the same packed codes and
    scales to the card model (whose bf16 weights are dropped); returns the
    number of int4 linears."""
    from vlrlhf_torch.models.common import Linear
    from vlrlhf_torch.ops.quant import quantize_params

    quantize_params(cpu, patterns, bits=4)
    mods = dict(gpu.named_modules())
    n = 0
    for name, mod in cpu.named_modules():
        if isinstance(mod, Linear) and mod.weight_q4 is not None:
            mods[name].set_quantized4_(mod.weight_q4.cuda(), mod.weight_scale4.cuda())
            n += 1
    print(f"{what}: {n} linears int4, the same codes on the CPU and the card", flush=True)
    return n


def reduced_depth_int4(cpu, gpu, batch, label: str = "", tie_rule: bool = False,
                       head: bool = True) -> None:
    """int4 serving at reduced depth: the LM linears and lm_head int4
    (DEFAULT_QUANT_PATTERNS; with head=False the LM linears alone,
    TRAIN_QUANT_PATTERNS: the CPU's plain int4 lm_head dequantizes a
    150k-row head per call), the same codes on the card (bf16 activations,
    kernel 6) and the CPU (f32, plain); image prefill + 8 greedy tokens,
    logit error and token agreement; then the card model fused
    (--fuse_decode) must give the same tokens as unfused. The batch may
    carry a family's anyres / Q-Former fields. With `tie_rule` fused
    tokens may leave the unfused ones only at a top-2 tie of the fused
    card's teacher-forced logits (`fused_tie_or_raise`): kernel 6 splits a
    decode step's contraction by the output width, so a fused and an
    unfused linear sum in another order."""
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device, prefill
    from vlrlhf_torch.models.lm.fuse import fuse_lm_
    from vlrlhf_torch.models.vlm import image_inputs
    from vlrlhf_torch.ops.quant import DEFAULT_QUANT_PATTERNS, TRAIN_QUANT_PATTERNS

    n4 = share_int4(cpu, gpu, DEFAULT_QUANT_PATTERNS if head else TRAIN_QUANT_PATTERNS,
                    "reduced-depth int4 serving")
    if n4 != 7 * cpu.cfg.lm.num_layers + int(head):
        raise AssertionError(f"expected every LM linear{' and lm_head' if head else ''} int4, "
                             f"got {n4}")
    gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    logits, tokens = {}, {}
    with torch.inference_mode():
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            cache_len = -(-(t["input_ids"].shape[1] + 8) // 128) * 128
            *_, last = prefill(model, gen_cfg, cache_len, t["input_ids"], t["pad_mask"],
                               t["prompt_lens"], t["pixel_values"], t["image_positions"], None,
                               **image_inputs(t))
            logits[name] = last.float().cpu()
            tokens[name] = Generator(model, gen_cfg)(batch).cpu()[0].tolist()
    fuse_lm_(gpu.lm)
    with torch.inference_mode():
        fused = Generator(gpu, gen_cfg)(batch).cpu()[0].tolist()
    ref, got = logits["cpu"], logits["cuda"]
    if not torch.isfinite(got).all():
        raise AssertionError("reduced-depth int4 logits on the card are not finite")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    agree = sum(int(a == b) for a, b in zip(tokens["cuda"], tokens["cpu"]))
    top2 = torch.topk(ref[0], 2).values
    print(f"reduced-depth int4 serving{label} (2 LM / 2 tower layers, full widths): logit "
          f"max_abs_err={err:.4e} rel={rel:.3e} (tol {LOGIT_REL_TOL}); greedy tokens agree "
          f"{agree}/8; cuda {tokens['cuda']} cpu {tokens['cpu']}; fused on the card "
          f"{fused} ({'identical' if fused == tokens['cuda'] else 'DIFFERENT'})", flush=True)
    if rel > LOGIT_REL_TOL:
        raise AssertionError(f"reduced-depth int4 logits differ: rel {rel} > {LOGIT_REL_TOL}")
    if float(top2[0] - top2[1]) > 2 * err and tokens["cuda"][0] != tokens["cpu"][0]:
        raise AssertionError("first int4 greedy token differs though its margin exceeds the error")
    if fused != tokens["cuda"]:
        if not tie_rule:
            raise AssertionError(f"fused int4 tokens {fused} differ from unfused "
                                 f"{tokens['cuda']}")
        print(f"fused int4{label}: a top-2 tie (position, unfused, fused, gap) "
              f"{fused_tie_or_raise(gpu, batch, tokens['cuda'], fused)}", flush=True)


def fused_tie_or_raise(model, batch, ref: list, got: list):
    """The first divergence of row 0's greedy tokens `got` from `ref` must
    be a top-2 tie of `model`'s logits teacher-forced on the prompt and
    ref's common prefix: both tokens its top two, their gap within
    LOGIT_REL_TOL of the largest |logit|. Returns (position, ref token,
    got token, gap)."""
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill
    from vlrlhf_torch.models.vlm import image_inputs

    j, a, b = divergence(ref, got, -1)
    n = int(batch["prompt_lens"][0])
    ids = np.concatenate([np.asarray(batch["input_ids"][0, :n]), np.asarray(ref[:j])])
    one = {"input_ids": ids[None].astype(np.int32), "pad_mask": np.ones((1, len(ids)), bool),
           "prompt_lens": np.asarray([len(ids)], np.int32),
           **{k: np.asarray(batch[k])[:1] for k in ("pixel_values", "image_positions")},
           **{k: np.asarray(v)[:1] for k, v in image_inputs(batch).items()}}
    t = batch_to_device(one, model.device)
    with torch.inference_mode():
        *_, last = prefill(model, GenerateConfig(max_new_tokens=1, pad_token_id=-1),
                           -(-len(ids) // 128) * 128, t["input_ids"], t["pad_mask"],
                           t["prompt_lens"], t["pixel_values"], t["image_positions"], None,
                           **image_inputs(t))
    logits = last[0].float().cpu()
    top2 = torch.topk(logits, 2)
    gap = float((logits[a] - logits[b]).abs())
    limit = LOGIT_REL_TOL * float(logits.abs().max())
    if {a, b} != set(top2.indices.tolist()) or gap > limit:
        raise AssertionError(f"fused tokens diverge at {j} ({a} vs {b}) and it is no top-2 tie: "
                             f"top-2 {top2.indices.tolist()} {top2.values.tolist()}, gap {gap} "
                             f"(limit {limit})")
    return j, a, b, round(gap, 5)


def reduced_depth_chunks(cpu, gpu, batch) -> None:
    """prefill_chunk after an image prefill, the verify chunk (C=4) and then
    a chat turn (C=64), into a bf16 (f32 on the CPU) and an int8 cache: all
    logits, card bf16 vs CPU f32."""
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill

    rng = np.random.default_rng(3)
    chunks = [rng.integers(16, 31000, (1, 4)), rng.integers(16, 31000, (1, 64))]
    for kv in ("bf16", "int8"):
        gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1, kv_cache_dtype=kv)
        got = {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            cache, lengths, *_ = prefill(model, gen_cfg, 768, t["input_ids"], t["pad_mask"],
                                         t["prompt_lens"], t["pixel_values"],
                                         t["image_positions"], None)
            got[name] = []
            for ids in chunks:
                ids_t = torch.as_tensor(ids, dtype=torch.int32, device=model.device)
                clens = torch.full((1,), ids.shape[1], dtype=torch.int32, device=model.device)
                logits, lengths = model.lm.prefill_chunk(ids_t, clens, lengths, cache,
                                                         return_all_logits=True)
                got[name].append(logits.float().cpu())
        for ids, g, r in zip(chunks, got["cuda"], got["cpu"]):
            if not torch.isfinite(g).all():
                raise AssertionError(f"prefill_chunk logits on the card are not finite ({kv})")
            err = float((g - r).abs().max())
            rel = err / float(r.abs().max())
            print(f"reduced-depth prefill_chunk {kv} cache, C={ids.shape[1]}: logit "
                  f"max_abs_err={err:.4e} rel={rel:.3e} (tol {LOGIT_REL_TOL})", flush=True)
            if rel > LOGIT_REL_TOL:
                raise AssertionError(f"prefill_chunk logits differ ({kv}, C={ids.shape[1]}): "
                                     f"rel {rel} > {LOGIT_REL_TOL}")


def image_requests(proc, questions, max_new_tokens: int, tag: str):
    """Engine Requests for image prompts (the collator expands the image
    token); returns (requests, the unexpanded prompt ids, image paths)."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.generate.continuous import Request

    coll = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)
    reqs, ids_list, paths = [], [], []
    for j, question in enumerate(questions):
        prompt = proc.format_multimodal_prompt(question, 1)
        ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        path = f"{tag}{j}.png"
        b1 = coll([{"input_ids": ids, "img_path": path}])
        n = int(b1["prompt_lens"][0])
        reqs.append(Request(input_ids=b1["input_ids"][0, :n],
                            pixel_values=b1["pixel_values"][0, 0],
                            image_positions=b1["image_positions"][0],
                            max_new_tokens=max_new_tokens))
        ids_list.append(list(ids))
        paths.append(path)
    return reqs, ids_list, paths


def echo_question(i: int) -> str:
    """A prompt that repeats a phrase, so prompt-lookup drafts find it."""
    words = " ".join(f"w{100 + 7 * i + k}" for k in range(6))
    return f"request {i}: repeat after me: {words}. again: {words}. again: {words}. again:"


def reduced_depth_spec(cpu, gpu, proc, logit_err: float) -> None:
    """Speculative (K=3) vs plain greedy continuous batching on the card,
    bf16 and int8 caches. Where the two differ, the first differing
    position must be a top-2 tie under teacher forcing: both tokens are the
    top two of the CPU f32 model's logits after the plain prefix, and their
    gap is within twice the card-vs-CPU logit error measured above."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill

    reqs, ids_list, paths = image_requests(proc, [echo_question(i) for i in range(4)], 24, "spec")
    coll = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)
    ref_cfg = GenerateConfig(max_new_tokens=1, pad_token_id=-1)  # the f32 model's own cache
    for kv in ("bf16", "int8"):
        gen_cfg = GenerateConfig(max_new_tokens=24, pad_token_id=-1, kv_cache_dtype=kv)
        plain = ContinuousEngine(gpu, gen_cfg, n_slots=4, cache_len=768).run(reqs)
        eng = ContinuousEngine(gpu, gen_cfg, n_slots=4, cache_len=768, speculative_k=3,
                               speculative_adaptive=False)
        spec = eng.run(reqs)
        same, ties = 0, []
        for r, (p, s) in enumerate(zip(plain, spec)):
            j = next((i for i in range(max(len(p), len(s)))
                      if i >= min(len(p), len(s)) or p[i] != s[i]), None)
            if j is None:
                same += 1
                continue
            if j >= min(len(p), len(s)):
                raise AssertionError(f"spec {kv} request {r}: lengths differ without a token "
                                     f"difference: plain {p} spec {s}")
            t = batch_to_device(coll([{"input_ids": ids_list[r] + p[:j], "img_path": paths[r]}]),
                                "cpu")
            *_, ref = prefill(cpu, ref_cfg, t["input_ids"].shape[1], t["input_ids"],
                              t["pad_mask"], t["prompt_lens"], t["pixel_values"],
                              t["image_positions"], None)
            top2 = torch.topk(ref[0], 2)
            gap = float(abs(ref[0, p[j]] - ref[0, s[j]]))
            tie = {p[j], s[j]} == set(top2.indices.tolist()) and gap <= 2 * logit_err
            ties.append((r, j, p[j], s[j], round(gap, 5)))
            if not tie:
                raise AssertionError(
                    f"spec {kv} request {r} diverges from plain greedy at {j} ({p[j]} vs {s[j]}) "
                    f"and it is no top-2 tie: reference top-2 {top2.indices.tolist()} "
                    f"{top2.values.tolist()}, gap {gap} > {2 * logit_err} or not the top two")
        n_tok = sum(len(x) for x in spec)
        print(f"reduced-depth speculative greedy ({kv} cache, K=3, 4 requests, 24 tokens): "
              f"{same}/4 token-identical to plain, divergences (request, position, plain, spec, "
              f"reference gap) {ties} all top-2 ties; {n_tok} tokens in "
              f"{eng.last_verify_steps} verify steps", flush=True)


def serve_args(**kw):
    """The `serve` CLI's arguments as build_server reads them: 8 slots,
    cache_len 1024, 32 new tokens, greedy."""
    import argparse

    base = dict(
        max_new_tokens=32, synthetic=0, do_sample=False, temperature=1.0, top_k=None,
        top_p=None, max_length=992, slots=8, seed=0, host="127.0.0.1", port=0,
        quantize="false", kv_cache_dtype="bf16", speculative_k=0, chat_sessions=0,
        fuse_decode=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def post_json(url: str, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_concurrently(url: str, bodies: list) -> list:
    """POST every body to url at once, one thread each; raises on any
    failure or a response without text."""
    results: list = [None] * len(bodies)
    errors: list = []

    def post(i):
        try:
            results[i] = post_json(url, bodies[i])
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    clients = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    if errors or any(c.is_alive() for c in clients):
        raise AssertionError(f"serving failed: {errors}")
    if any(not isinstance(r, dict) or "text" not in r for r in results):
        raise AssertionError(f"bad responses: {results}")
    return results


def phase_serve():
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.generate.engine import batch_to_device, prefill
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention

    torch.cuda.reset_peak_memory_stats()
    cfg = _llava_7b(torch.bfloat16)
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"full-width LLaVA-1.5-7B: {n_params / 1e9:.3f} B params bf16, random init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    proc = make_processor(cfg)
    httpd, srv = build_server(cfg, model, proc, serve_args(), seeded_image)
    engine = srv.engine
    assert engine.cache_len == 1024
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    n_req = 8
    bodies = [{"question": f"request {i}: what does this image show? answer in detail",
               "image": f"img{i}.png", "max_new_tokens": 32} for i in range(n_req)]
    try:
        flash_attention.launches = 0
        decode_attention.launches = 0
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash_attention.launches,
                    "decode_attention": decode_attention.launches}
        tokens = [r.get("tokens") for r in results]
        steps = engine.last_decode_steps
        print(f"served {n_req}/{n_req} /generate requests in {wall:.3f} s "
              f"({sum(tokens)} tokens; per request {tokens}); admits "
              f"{engine.last_admits}, bursts {engine.last_bursts}, decode steps {steps}; "
              f"launches {json.dumps(launches)}", flush=True)
        if launches["flash_fwd"] < engine.last_admits * (
            cfg.vision.layers_run + cfg.lm.num_layers
        ):
            raise AssertionError(f"too few flash launches: {launches}")
        if steps == 0 or launches["decode_attention"] < cfg.lm.num_layers * steps:
            raise AssertionError(f"too few decode launches for {steps} steps: {launches}")
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("/health reports the scheduler dead")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError("server threads did not stop")

    # measurements on the same model, outside the counted run
    from vlrlhf_torch.data.processor import make_single_turn_conv

    prompt_ids = []
    for i in range(8):
        prompt = proc.format_multimodal_prompt(f"request {i}: what does this image show?", 1)
        ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        prompt_ids.append(ids)
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator

    coll = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)
    with torch.inference_mode():
        prefill_ms = {}
        for bp in (1, 2):
            batch = batch_to_device(
                coll([{"input_ids": ids, "img_path": f"m{j}.png"}
                      for j, ids in enumerate(prompt_ids[:bp])]), "cuda")
            run = lambda: prefill(  # noqa: E731
                model, engine.gen_cfg, batch["input_ids"].shape[1], batch["input_ids"],
                batch["pad_mask"], batch["prompt_lens"], batch["pixel_values"],
                batch["image_positions"], None,
            )
            _, _, _, _, _, last = run()
            if not torch.isfinite(last).all():
                raise AssertionError("prefill logits are not finite")
            prefill_ms[bp] = time_ms(run, iters=3, warmup=1)
        # decode: all 8 slots active, one 31-step burst
        reqs, _, _ = image_requests(
            proc, [f"request {i}: what does this image show?" for i in range(8)], 32, "d")
        cache, pending, state, hist = engine._fresh_buffers()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)], reqs, gen)
        logits, _ = model.lm.decode(state[1].clone(), state[0].clone(), cache, pending)
        if not torch.isfinite(logits).all():
            raise AssertionError("decode logits are not finite")
        torch.cuda.synchronize()
        engine.last_decode_steps = 0
        t0 = time.perf_counter()
        _, _, packed, _ = engine._burst(cache, pending, state, hist, 0, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = engine.last_decode_steps
        decode_tok_s = 8 * steps / dt
        profile_breakdown(run, f"prefill B=2 ({batch['input_ids'].shape[1]}-token bucket)")
        profile_breakdown(lambda: model.lm.decode(state[1].clone(), state[0].clone(), cache,
                                                  pending), "decode step (8 slots)")
    peak = torch.cuda.max_memory_allocated()
    print(f"prefill (ViT + projector + 32-layer LM, {batch['input_ids'].shape[1]}-token "
          f"bucket): B=1 {prefill_ms[1]:.3f} ms, B=2 {prefill_ms[2]:.3f} ms; "
          f"decode 8 slots x {steps} steps: {dt * 1e3 / steps:.3f} ms/step, "
          f"{decode_tok_s:.2f} tokens/s; peak memory {peak / 2**30:.3f} GiB", flush=True)
    return launches, dt * 1e3 / steps


def phase_serve_spec_int8():
    """Full-width LLaVA-1.5-7B served as `serve --quantize int8
    --kv_cache_dtype int8 --speculative_k 3 --chat_sessions 4`: the bf16
    model is quantized in place by build_server (never a second copy).
    Returns the launch counts of the /generate run and of the /chat run."""
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.generate.continuous import device_draft
    from vlrlhf_torch.models.common import Linear, init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "chunk_attention": chunk_attention}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    args = serve_args(quantize="int8", kv_cache_dtype="int8", speculative_k=3, chat_sessions=4)
    httpd, srv = build_server(cfg, model, proc, args, seeded_image)
    engine = srv.engine
    n_int8 = sum(1 for m in model.modules() if isinstance(m, Linear) and m.weight is None)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"int8 serving model: {n_int8} linears int8 (W8A16), {weights / 2**30:.3f} GiB of "
          f"weights after in-place quantization, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated ({before / 2**30:.3f} GiB before the model); engine cache "
          f"{engine.gen_cfg.kv_cache_dtype}, "
          f"speculative_k {engine.speculative_k}, adaptive gate {engine.speculative_adaptive}",
          flush=True)
    if n_int8 != 7 * cfg.lm.num_layers + 1 or engine.gen_cfg.kv_cache_dtype != "int8":
        raise AssertionError(f"expected every LM linear and lm_head int8, got {n_int8}")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [{"question": echo_question(i), "image": f"spec{i}.png", "max_new_tokens": 32}
              for i in range(8)]
    try:
        reset()
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        spec_launches = read()
        tokens = [r.get("tokens") for r in results]
        print(f"speculative int8 serve: {len(results)}/8 /generate requests in {wall:.3f} s "
              f"({sum(tokens)} tokens; per request {tokens}); admits {engine.last_admits}, "
              f"bursts {engine.last_bursts} ({engine.last_spec_bursts} speculative), verify "
              f"steps {engine.last_verify_steps}, plain decode steps "
              f"{engine.last_decode_steps}; launches {json.dumps(spec_launches)}", flush=True)
        if spec_launches["chunk_attention"] < cfg.lm.num_layers * max(engine.last_verify_steps, 1):
            raise AssertionError(f"too few chunk launches: {spec_launches}")

        reset()
        t0 = time.perf_counter()
        turn1 = post_json(url + "/chat", {"message": "what does this image show? describe it",
                                          "image": "chat0.png"})
        turn2 = post_json(url + "/chat", {"message": "and what else? repeat: w5 w6 w7",
                                          "session_id": turn1["session_id"]})
        wall = time.perf_counter() - t0
        chat_launches = read()
        print(f"/chat: 2 turns of session {turn1['session_id']} in {wall:.3f} s; turn texts "
              f"{len(turn1['text'])} and {len(turn2['text'])} chars; launches "
              f"{json.dumps(chat_launches)}", flush=True)
        if turn2["session_id"] != turn1["session_id"]:
            raise AssertionError(f"/chat turn 2 opened a new session: {turn1} {turn2}")
        if chat_launches["chunk_attention"] < cfg.lm.num_layers or \
                chat_launches["decode_attention"] < cfg.lm.num_layers:
            raise AssertionError(f"/chat did not run the chunk and int8 decode kernels: "
                                 f"{chat_launches}")
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("/health reports the scheduler dead")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError("server threads did not stop")

    # measurements outside the counted runs: 8 admitted slots, one burst of
    # each kind in turns (plain, spec, spec, plain), each on a fresh admission
    reqs, _, _ = image_requests(proc, [echo_question(i) for i in range(8)], 32, "m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings = {"plain": [], "spec": []}
    with torch.inference_mode():
        for kind in ("plain", "spec", "spec", "plain"):
            cache, pending, state, hist = engine._fresh_buffers()
            for g in range(0, 8, 2):
                engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)],
                                    reqs, gen)
            lengths0 = state[0].cpu().numpy()
            engine.last_decode_steps = engine.last_verify_steps = 0
            burst = engine._spec_burst if kind == "spec" else engine._burst
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, packed, _ = burst(cache, pending, state, hist, 0, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = engine.last_verify_steps if kind == "spec" else engine.last_decode_steps
            emitted = int((packed[:, -1] - lengths0).sum())
            if steps == 0 or emitted == 0:
                raise AssertionError(f"{kind} burst emitted nothing")
            readings[kind].append((dt * 1e3 / steps, emitted / steps, steps, emitted))
            del cache
        peak = torch.cuda.max_memory_allocated()  # before the profiled steps
        # one profiled int8 decode step and one verify chunk on 8 admitted slots
        cache, pending, state, hist = engine._fresh_buffers()
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)], reqs, gen)
        last, lengths = state[1].clone(), state[0].clone()
        chunk = torch.cat([last[:, None], device_draft(hist, lengths + 1, 3, 0)], dim=1)
        clens = torch.full((8,), 4, dtype=torch.int32, device="cuda")
        profile_breakdown(lambda: model.lm.decode(last, lengths, cache, pending),
                          "int8 decode step (8 slots, W8A16 linears, int8 KV)")
        profile_breakdown(lambda: model.lm.prefill_chunk(chunk, clens, lengths, cache,
                                                         return_all_logits=True),
                          "int8 verify step (8 slots x 4 tokens, W8A16 linears, int8 KV)")
        del cache
    for kind, rows in readings.items():
        print(f"int8 {kind} burst, 8 slots: " + "; ".join(
            f"{ms:.3f} ms per {'verify' if kind == 'spec' else 'decode'} step, {tps:.3f} tokens "
            f"per step ({tps / 8:.3f} per slot), {n} steps, {e} tokens" for ms, tps, n, e in rows),
            flush=True)
    print(f"speculative int8 serving peak memory {peak / 2**30:.3f} GiB (the bf16 weights "
          f"before their in-place quantization included)", flush=True)
    del model, engine, srv, httpd
    return spec_launches, chat_launches, [r[0] for r in readings["plain"]]


def phase_serve_int4(bf16_ms: float, int8_ms: list) -> dict:
    """Full-width LLaVA-1.5-7B served as `serve --quantize int4 --fuse_decode
    true`: build_server quantizes the bf16 model's LM linears and lm_head to
    int4 in place, then fuses each layer (129 int4 linears). 8 concurrent
    image /generate requests, 32 new tokens, greedy, with their launch
    counts; resident weights; decode ms per step (8 slots, one burst) beside
    phases 4 and 4b of this run; one profiled decode step. Returns the
    launch counts of the /generate run."""
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.models.common import Linear, init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention
    from vlrlhf_torch.ops.int4 import int4_matmul

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "int4_matmul": int4_matmul}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    t0 = time.perf_counter()
    httpd, srv = build_server(cfg, model, proc, serve_args(quantize="int4", fuse_decode=True),
                              seeded_image)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine = srv.engine
    n4 = sum(1 for m in model.modules() if isinstance(m, Linear) and m.weight_q4 is not None)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    lm_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                   if n.startswith("lm.") and "embed" not in n)
    print(f"int4 serving model: {n4} int4 linears (fused wqkv / wo / gateup / down per layer and "
          f"lm_head), quantized and fused in place in {setup_s:.2f} s; weights "
          f"{weights / 2**30:.3f} GiB ({lm_bytes / 2**30:.3f} GiB of LM linears, norms and "
          f"lm_head; the rest the bf16 tower, projector and embedding); "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated ({before / 2**30:.3f} GiB "
          f"before the model); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    if n4 != 4 * cfg.lm.num_layers + 1 or model.lm.layers[0].wq is not None:
        raise AssertionError(f"expected 129 fused int4 linears, got {n4}")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [{"question": f"request {i}: what does this image show? answer in detail",
               "image": f"img{i}.png", "max_new_tokens": 32} for i in range(8)]
    try:
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        tokens = [r.get("tokens") for r in results]
        steps = engine.last_decode_steps
        print(f"int4 serve: {len(results)}/8 /generate requests in {wall:.3f} s ({sum(tokens)} "
              f"tokens; per request {tokens}); admits {engine.last_admits}, bursts "
              f"{engine.last_bursts}, decode steps {steps}; launches {json.dumps(launches)}",
              flush=True)
        if steps == 0 or launches["int4_matmul"] < n4 * steps:
            raise AssertionError(f"too few int4 launches for {steps} decode steps: {launches}")
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("/health reports the scheduler dead")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError("server threads did not stop")

    # measurement outside the counted run: 8 admitted slots, one burst
    reqs, _, _ = image_requests(
        proc, [f"request {i}: what does this image show?" for i in range(8)], 32, "q")
    with torch.inference_mode():
        cache, pending, state, hist = engine._fresh_buffers()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)], reqs, gen)
        logits, _ = model.lm.decode(state[1].clone(), state[0].clone(), cache, pending)
        if not torch.isfinite(logits).all():
            raise AssertionError("int4 decode logits are not finite")
        torch.cuda.synchronize()
        engine.last_decode_steps = 0
        t0 = time.perf_counter()
        engine._burst(cache, pending, state, hist, 0, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = engine.last_decode_steps
        profile_breakdown(lambda: model.lm.decode(state[1].clone(), state[0].clone(), cache,
                                                  pending),
                          "int4 decode step (8 slots, fused W4A16 linears)")
        del cache
    print(f"decode ms per step, 8 slots, this run: int4 fused {dt * 1e3 / steps:.3f} "
          f"({steps} steps); bf16 {bf16_ms:.3f} (phase 4); int8 W8A16 + int8 KV plain bursts "
          f"{', '.join(f'{x:.3f}' for x in int8_ms)} (phase 4b)", flush=True)
    del model, engine, srv, httpd
    return launches


def profile_breakdown(fn, label: str, host_top: int = 0):
    """Run fn() once under torch.profiler and print where the card's time
    went: wall ms, busy ms (kernel durations summed; one stream), idle
    share, and kernel time by group and by name; with `host_top`, that many
    host ops by their own CPU time too. Returns the busy ms (None when the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device events but the ranges a library annotates (FSDP2's), which
    # span kernels already counted
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"profile {label}: the profiler saw no device time", flush=True)
        return None
    groups = {"flash_fwd": ("flash_fwd_kernel",), "flash_bwd_dkv": ("flash_bwd_dkv_",),
              "flash_bwd_dq": ("flash_bwd_dq_",), "decode": ("decode_split_kernel",),
              "chunk": ("chunk_split_kernel", "chunk_mma_kernel"),  # short / long chunks
              "int4_matmul_t": ("int4_matmul_t_",),  # before int4_matmul: both designs
              "int4_matmul": ("int4_matmul_kernel",),  # T <= 64
              "int4_matmul_wgmma": ("int4_matmul_wgmma_kernel",)}
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        name = e.name
        grp = next((g for g, keys in groups.items() if any(k in name for k in keys)), None)
        dim = re.search(r"kernel<(\d+)", name)
        if grp is not None and grp.startswith("flash") and dim:
            grp += f"[D={dim.group(1)}]"  # the tower's D = 64 apart from the LM's 128
        if grp is None:
            low = name.lower()
            grp = "matmul" if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass")) \
                else "other"
        n, t = by_group.get(grp, (0, 0.0))
        by_group[grp] = (n + 1, t + us)
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    busy = sum(t for _, t in by_group.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {label}: wall {wall:.3f} ms (profiled), card busy {busy:.3f} ms, idle "
          f"{max(0.0, 1 - busy / wall):.3f}; {len(kernels)} kernels; by group (count, ms) "
          + json.dumps({g: (n, round(t / 1e3, 3)) for g, (n, t) in
                        sorted(by_group.items(), key=lambda kv: -kv[1][1])})
          + "; top kernels " + json.dumps([(nm[:60], n, round(t / 1e3, 3)) for nm, (n, t) in top]),
          flush=True)
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:host_top]
        print(f"profile {label}: top host ops by own CPU ms (count) "
              + json.dumps([(e.key[:60], e.count, round(e.self_cpu_time_total / 1e3, 3))
                            for e in ops]), flush=True)
    return busy


def pair_row(i: int, prompt_words: int, chosen_words: int, rejected_words: int) -> dict:
    """A seeded synthetic preference pair with an image."""
    rng = np.random.default_rng(1000 + i)

    def words(n):
        return " ".join(f"w{int(x)}" for x in rng.integers(16, 31000, n))

    return {"prompt": f"pair {i}: {words(prompt_words)}", "img_path": f"pair{i}.png",
            "chosen": words(chosen_words), "rejected": words(rejected_words)}


def dpo_args(**kw):
    """The `dpo` CLI's arguments as build_dpo reads them."""
    import argparse

    base = dict(
        lora_r=64, lora_alpha=16.0, lora_dropout=0.0, seed=0, learning_rate=1e-5,
        warmup_ratio=0.2, max_steps=5, lr_scheduler_type="cosine", weight_decay=0.0,
        max_grad_norm=1.0, gradient_accumulation_steps=1, beta=0.1, label_smoothing=0.0,
        loss_type="sigmoid", reference_free=False, precompute_ref_logps=True,
        logits_chunk=256, max_length=1024, per_device_train_batch_size=1, synthetic=0,
        q_lora=False, bits=8, q_lora_vision=False, use_lora=True, lora_target_modules="auto",
        freeze_vision_tower=True, eval_steps=0, eval_ratio=0.005, eval_samples=0,
        save_steps=500, resume_from_checkpoint=None, merge_adapter_after_training=False,
        output_dir=None, logging_steps=1, num_train_epochs=1.0,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def reduced_depth_models():
    """(cfg32, cpu, gpu): LLaVA-1.5-7B's widths at 2 LM / 2 tower layers,
    attn remat, the same seeded weights in f32 on the CPU and in bf16 on
    the card."""
    import dataclasses

    from vlrlhf_torch.cli.main import with_remat_policy
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    full = with_remat_policy(_llava_7b(torch.float32), "attn")
    cfg32 = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_layers=2),
                                vision=dataclasses.replace(full.vision, num_layers=2))
    cfg16 = dataclasses.replace(cfg32, lm=dataclasses.replace(cfg32.lm, dtype=torch.bfloat16),
                                vision=dataclasses.replace(cfg32.vision, dtype=torch.bfloat16))
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    gpu = VLM(cfg16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cfg32, cpu, gpu


def shared_adapters(cpu, gpu, adapter_set: str = "", patterns=None):
    """r64 / alpha 16 adapters on the 7 LM linears of both models (or on
    `patterns`; the named set `adapter_set` if given), seeded on the CPU
    with a non-zero b (policy != reference) and copied to the card.
    Returns the LoraConfig."""
    from vlrlhf_torch.lora.lora import LM_ALL_LINEARS, LoraConfig, init_lora, lora_parameters

    lcfg = LoraConfig(r=64, alpha=16.0, dropout=0.0,
                      target_patterns=tuple(patterns or LM_ALL_LINEARS))
    gen = torch.Generator().manual_seed(2 + len(adapter_set))
    init_lora(cpu, lcfg, gen, adapter_set=adapter_set)
    init_lora(gpu, lcfg, torch.Generator(device="cuda").manual_seed(2), adapter_set=adapter_set)
    with torch.no_grad():
        for (name, pc), (_, pg) in zip(lora_parameters(cpu, adapter_set),
                                       lora_parameters(gpu, adapter_set)):
            if name.endswith("lora_b"):
                pc.normal_(0.0, 0.02, generator=gen)
            pg.copy_(pc)
    return lcfg


def phase_reduced_depth_dpo(bits: int = 0):
    """One DPO loss + backward at full widths, 2 LM / 2 tower layers, the
    same seeded weights and non-zero adapters on the card (bf16, kernels)
    and on the CPU (f32, plain path). bits=4: QLoRA, the LM's attention and
    MLP linears int4 (TRAIN_QUANT_PATTERNS) with the same codes on both
    before the adapters attach, so kernels 6 and 7 run on the card."""
    from vlrlhf_torch.data.collators import CollatorConfig, DPOCollator
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    cfg32, cpu, gpu = reduced_depth_models()
    label = "DPO"
    if bits:
        from vlrlhf_torch.ops.quant import TRAIN_QUANT_PATTERNS

        label = "QLoRA int4 DPO"
        if share_int4(cpu, gpu, TRAIN_QUANT_PATTERNS, f"reduced-depth {label}") != 14:
            raise AssertionError("expected the 14 LM linears of 2 layers int4")
    lcfg = shared_adapters(cpu, gpu)
    proc = make_processor(cfg32)
    coll = DPOCollator(proc, CollatorConfig(image_size=336), seeded_image)
    batch = coll([proc.tokenize_row_dpo(pair_row(0, 12, 40, 30))])
    dcfg = DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=256)
    ocfg = OptimizerConfig(learning_rate=1e-5)
    loss, grads = {}, {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        state = init_train_state(adapter_params(model), ocfg)
        m = dpo_step(model, dcfg, ocfg, state, batch_to_device(batch, model.device))
        loss[name] = float(m["loss"])
        grads[name] = torch.cat([p.grad.float().flatten().cpu() for p in state.trainable])
    g, r = grads["cuda"], grads["cpu"]
    if not (np.isfinite(loss["cuda"]) and torch.isfinite(g).all()):
        raise AssertionError(f"reduced-depth {label} on the card is not finite")
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    cos = float(torch.dot(g.double(), r.double()) / (g.double().norm() * r.double().norm()))
    print(f"reduced-depth {label} (2 LM / 2 tower layers, full widths, 1 pair of "
          f"{batch['input_ids'].shape[1]} tokens): loss cuda {loss['cuda']:.6f} cpu "
          f"{loss['cpu']:.6f} rel err {rel:.3e} (tol {LOSS_REL_TOL}); LoRA gradient cosine "
          f"{cos:.6f} (min {GRAD_COS_MIN}) over {g.numel()} entries", flush=True)
    if rel > LOSS_REL_TOL:
        raise AssertionError(f"reduced-depth {label} loss differs: rel {rel} > {LOSS_REL_TOL}")
    if cos < GRAD_COS_MIN:
        raise AssertionError(f"reduced-depth {label} LoRA gradients differ: cosine {cos} < "
                             f"{GRAD_COS_MIN}")
    del cpu, gpu
    torch.cuda.empty_cache()


def phase_dpo():
    """Full-width LLaVA-1.5-7B DPO through cli.main.build_dpo."""
    import math
    import statistics

    from vlrlhf_torch.cli.main import build_dpo, with_remat_policy
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from vlrlhf_torch.train.dpo import batch_to_device, make_ref_logps_fn
    from vlrlhf_torch.train.loop import read_metrics

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cfg = with_remat_policy(_llava_7b(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    args = dpo_args()
    rows = [pair_row(7, 150, 260, 250)]
    run = build_dpo(cfg, model, proc, args, rows, seeded_image)
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    real = batch_np["pad_mask"].sum(1).tolist()  # the 128-token bucket pads them to 1024
    if batch_np["input_ids"].shape[1] != 1024 or min(real) < 960:
        raise AssertionError(f"DPO rows hold {real} real tokens of "
                             f"{batch_np['input_ids'].shape[1]}; want >= 960 of 1024")
    batch = batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    n_adapter = sum(p.numel() for p in run.state.trainable)
    print(f"full-width DPO: LLaVA-1.5-7B bf16 random init + {n_adapter / 1e6:.1f} M LoRA "
          f"params (r{run.lcfg.r}, alpha {run.lcfg.alpha}, {len(run.state.trainable) // 2} "
          f"linears), reference logps precomputed "
          f"({run.rows[0]['ref_chosen_logp']:.3f}, {run.rows[0]['ref_rejected_logp']:.3f}); "
          f"rows of {real} real tokens padded to 1024; set-up {time.perf_counter() - t0:.1f} s; "
          f"{resident / 2**30:.3f} GiB allocated on the card before the model", flush=True)

    counts = (flash_attention, flash_bwd_dkv, flash_bwd_dq)
    for fn in counts:
        fn.launches = 0
    n_steps = 5
    history, snap = [], None
    for i in range(n_steps):
        if i == 1:
            snap = [p.detach().clone() for p in run.state.trainable]
        m = read_metrics(run.step(batch))
        history.append(m)
        if i == 1:
            changed = any(not torch.equal(p, s) for p, s in zip(run.state.trainable, snap))
            if not changed:
                raise AssertionError("the adapters did not change at step 2")
    launches = {"flash_fwd": flash_attention.launches, "flash_bwd_dkv": flash_bwd_dkv.launches,
                "flash_bwd_dq": flash_bwd_dq.launches}
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    print(f"DPO steps 1-{n_steps}: loss {losses}; grad_norm {norms}; launches "
          f"{json.dumps(launches)}", flush=True)
    if abs(losses[0] - math.log(2.0)) > 1e-3:
        raise AssertionError(f"step-1 loss {losses[0]} is not ln 2 within 1e-3")
    if not all(np.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"non-finite loss or zero/non-finite grad norm: {losses} {norms}")
    per_step_fwd = cfg.vision.layers_run + cfg.lm.num_layers  # tower + the LM's recompute
    if launches["flash_bwd_dkv"] < cfg.lm.num_layers * n_steps or \
            launches["flash_bwd_dq"] < cfg.lm.num_layers * n_steps or \
            launches["flash_fwd"] < per_step_fwd * n_steps:
        raise AssertionError(f"too few kernel launches for {n_steps} steps: {launches}")

    # timing: the steps that follow, each ending in a synchronize
    step_ms = []
    for _ in range(6):
        t1 = time.perf_counter()
        m = run.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    if not np.isfinite(read_metrics(m)["loss"]):
        raise AssertionError("DPO loss is not finite in the timed steps")
    peak = torch.cuda.max_memory_allocated()  # before the profiled step
    profile_breakdown(lambda: run.step(batch), "DPO step")
    med = statistics.median(step_ms)
    tokens = int(np.prod(batch_np["input_ids"].shape))
    flops = run.flops_per_token * tokens + run.flops_per_image * batch_np["pixel_values"].shape[0]

    # the CLI default: the reference forward online, adapters off. Its logps
    # match the precomputed ones (same kernels, same base weights; 1e-3
    # relative) and steps with it stay finite
    online = {k: v for k, v in batch.items() if not k.startswith("ref_")}
    c, r = make_ref_logps_fn(model, run.dcfg)(online)
    want = (run.rows[0]["ref_chosen_logp"], run.rows[0]["ref_rejected_logp"])
    got = (float(c[0]), float(r[0]))
    online_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        m = read_metrics(run.step(online))  # the read synchronizes
        online_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"online reference: logps {got} vs precomputed {want}; 3 steps "
          f"{[round(x, 3) for x in online_ms]} ms, last loss {m['loss']:.6g} grad_norm "
          f"{m['grad_norm']:.6g}", flush=True)
    if any(abs(g - w) > 1e-3 * max(1.0, abs(w)) for g, w in zip(got, want)):
        raise AssertionError(f"online reference logps {got} differ from the precomputed {want}")
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        raise AssertionError("online-reference DPO step is not finite")
    print(f"DPO step (1 pair, seq 1024, attn remat, logits_chunk 256, precomputed ref): "
          f"median {med:.3f} ms over {len(step_ms)} steps {[round(x, 3) for x in step_ms]}; "
          f"{1e3 / med:.4f} pairs/s; MFU {flops / (med * 1e-3) / PEAK_FLOPS:.4f} "
          f"({flops / 1e12:.3f} TFLOP per step, train/flops.py); peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del run, model, batch
    torch.cuda.empty_cache()
    return launches, {"median_ms": med, "pairs_per_s": 1e3 / med,
                      "mfu": flops / (med * 1e-3) / PEAK_FLOPS, "peak_gib": peak / 2**30,
                      "losses": losses, "norms": norms}


def phase_dpo_qlora4(bf16: dict) -> dict:
    """Full-width LLaVA-1.5-7B QLoRA DPO through cli.main.build_dpo with
    --q_lora true --bits 4 at phase 6's shape: the bf16 model's 224 LM
    linears go int4 in place before the adapters attach (lm_head stays
    bf16). 3 steps with step-1 loss ln 2, finite norms and adapters that
    change at step 2, and their launch counts (kernel 6 in the forward and
    its recompute, kernel 7 in the backward); then step ms, pairs/s, MFU
    and peak memory beside phase 6's, and one profiled step."""
    import math
    import statistics

    from vlrlhf_torch.cli.main import build_dpo, with_remat_policy
    from vlrlhf_torch.models.common import Linear, init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    import tempfile

    from vlrlhf_torch.ops.int4 import dequantize_int4, int4_matmul, int4_matmul_t
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.loop import read_metrics

    torch.cuda.reset_peak_memory_stats()
    cfg = with_remat_policy(_llava_7b(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    run = build_dpo(cfg, model, proc, dpo_args(q_lora=True, bits=4, max_steps=3),
                    [pair_row(7, 150, 260, 250)], seeded_image)
    n4 = sum(1 for m in model.modules() if isinstance(m, Linear) and m.weight_q4 is not None)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    batch = batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    print(f"full-width QLoRA DPO: {n4} LM linears int4 (lm_head bf16), weights "
          f"{weights / 2**30:.3f} GiB with the adapters, set-up {time.perf_counter() - t0:.1f} s; "
          f"rows of {batch_np['pad_mask'].sum(1).tolist()} real tokens padded to "
          f"{batch_np['input_ids'].shape[1]}", flush=True)
    if n4 != 7 * cfg.lm.num_layers:
        raise AssertionError(f"expected 224 int4 LM linears, got {n4}")

    counted = {"flash_fwd": flash_attention, "flash_bwd_dkv": flash_bwd_dkv,
               "flash_bwd_dq": flash_bwd_dq, "int4_matmul": int4_matmul,
               "int4_matmul_t": int4_matmul_t}
    for fn in counted.values():
        fn.launches = 0
    history, snap = [], None
    for i in range(3):
        if i == 1:
            snap = [p.detach().clone() for p in run.state.trainable]
        history.append(read_metrics(run.step(batch)))
        if i == 1 and all(torch.equal(p, q) for p, q in zip(run.state.trainable, snap)):
            raise AssertionError("the adapters did not change at step 2")
    launches = {name: fn.launches for name, fn in counted.items()}
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    print(f"QLoRA int4 DPO steps 1-3: loss {losses}; grad_norm {norms}; launches "
          f"{json.dumps(launches)}", flush=True)
    if abs(losses[0] - math.log(2.0)) > 1e-3:
        raise AssertionError(f"QLoRA step-1 loss {losses[0]} is not ln 2 within 1e-3")
    if not all(np.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"non-finite loss or zero/non-finite grad norm: {losses} {norms}")
    if launches["int4_matmul"] < 3 * n4 or launches["int4_matmul_t"] <= 0:
        raise AssertionError(f"too few int4 launches for 3 steps: {launches}")

    step_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        m = run.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    if not np.isfinite(read_metrics(m)["loss"]):
        raise AssertionError("QLoRA DPO loss is not finite in the timed steps")
    peak = torch.cuda.max_memory_allocated()
    profile_breakdown(lambda: run.step(batch), "QLoRA int4 DPO step")
    med = statistics.median(step_ms)
    tokens = int(np.prod(batch_np["input_ids"].shape))
    flops = run.flops_per_token * tokens + run.flops_per_image * batch_np["pixel_values"].shape[0]
    print(f"QLoRA int4 DPO step (phase 6's shape): median {med:.3f} ms over 3 steps "
          f"{[round(x, 3) for x in step_ms]}; {1e3 / med:.4f} pairs/s; MFU "
          f"{flops / (med * 1e-3) / PEAK_FLOPS:.4f}; peak memory {peak / 2**30:.3f} GiB "
          f"(the bf16 model before its in-place quantization included) | bf16 DPO (phase 6): "
          f"median {bf16['median_ms']:.3f} ms, {bf16['pairs_per_s']:.4f} pairs/s, MFU "
          f"{bf16['mfu']:.4f}, peak {bf16['peak_gib']:.3f} GiB", flush=True)

    # the merged save over the int4 base: W is the dequantized q * s (no gbias
    # in a base quantized here), rounded to bf16 as dequantize_params does
    names = ("lm.layers.0.wq", f"lm.layers.{cfg.lm.num_layers - 1}.down")
    dense = {}
    for n in names:
        lin = model.get_submodule(n)
        if lin.weight_gbias is not None:
            raise AssertionError(f"{n}: an int4 base quantized here holds no gbias")
        dense[n] = dequantize_int4(lin.weight_q4, lin.weight_scale4,
                                   torch.float32).to(torch.bfloat16)
    want = sampled_merges(model, run.lcfg.scale, names, dense)
    with tempfile.TemporaryDirectory() as tmp:
        finish_timed(run, dpo_args(q_lora=True, bits=4, merge_adapter_after_training=True,
                                   output_dir=tmp), want, "phase 7e merge over int4 (6b's run)")
    del run, model, batch
    torch.cuda.empty_cache()
    return launches


TOWER_TARGETS = ("lm/.*attn/(wq|wk|wv|wo)/,lm/.*mlp/(gate|up|down)/,"
                 "vision/.*attn/(wq|wk|wv|wo)/")


def drop_adapters(model) -> None:
    """Detach every LoRA adapter, so the next build_dpo starts clean."""
    from vlrlhf_torch.models.common import Linear

    for m in model.modules():
        if isinstance(m, Linear):
            m.lora_a = m.lora_b = None


def timed_steps(run, batch, n: int):
    """n steps on one batch, each ending in a synchronize: (metrics, ms)."""
    from vlrlhf_torch.train.loop import read_metrics

    hist, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        hist.append(read_metrics(run.step(batch)))  # the read synchronizes
        ms.append((time.perf_counter() - t0) * 1e3)
    return hist, ms


def merged_check(path: str, sampled: dict, what: str) -> None:
    """The saved merged weights of the sampled linears equal the expected
    W + scale (A B)^T, bit for bit (the same expression on the same card)."""
    from vlrlhf_torch.train.checkpoint import load_params

    merged = load_params(path, mmap=True)
    for name, want in sampled.items():
        got = merged[f"{name}.weight"].to("cuda")
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"{what}: merged {name} differs from W + s (A B)^T by {err}")
    print(f"{what}: merged weights in {path} ({len(merged)} tensors) equal W + s (A B)^T on "
          f"{', '.join(sampled)}", flush=True)


def sampled_merges(model, scale: float, names, dense: dict) -> dict:
    """W + scale (A B)^T in W's dtype for the named linears; `dense` gives
    each one's W (its dense weight, or its int4 weight dequantized to bf16)."""
    out = {}
    for name in names:
        lin = model.get_submodule(name)
        delta = (lin.lora_a.float() @ lin.lora_b.float()) * scale
        out[name] = (dense[name].float() + delta.T).to(dense[name].dtype)
    return out


def forward_memory(run, batch) -> dict:
    """GiB the policy forward (adapters on) leaves allocated for its
    backward ("kept"), and the peaks of that forward and of the backward
    above what each found: the part of the step the remat policy sets."""
    from vlrlhf_torch.models.common import Ctx
    from vlrlhf_torch.train.dpo import forward_logps, pair_image_features

    feats = pair_image_features(run.model, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logps, _ = forward_logps(run.model, run.dcfg, batch, Ctx(True, run.dcfg.lora_scale), feats)
    kept = torch.cuda.memory_allocated() - base
    fwd_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    after_fwd = torch.cuda.memory_allocated()
    logps.sum().backward()
    bwd_peak = torch.cuda.max_memory_allocated() - after_fwd
    for p in run.state.trainable:
        p.grad = None
    return {"kept": kept / 2**30, "fwd_peak": fwd_peak / 2**30, "bwd_peak": bwd_peak / 2**30}


def finish_timed(run, args, want: dict, what: str) -> None:
    """cli.main.finish_run (adapters and merged weights), timed, then the
    merged file checked on the sampled linears."""
    from vlrlhf_torch.cli.main import finish_run

    t0 = time.perf_counter()
    finish_run(run, args)
    ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(args.output_dir, "merged")
    size = os.path.getsize(os.path.join(path, "params.pt"))
    print(f"{what}: finish_run {ms:.3f} ms, merged file {size / 2**30:.3f} GiB", flush=True)
    merged_check(path, want, what)


PHASE7_LAYERS = 8  # phase 7's LM depth, a quarter of LLaVA-1.5-7B's: the script's time limit


def trainer_model(layers: int = 0):
    """Phases 7 and 10b's model: LLaVA-1.5-7B at full width and depth (or
    `layers` LM layers), bf16, random weights from seed 0, on the card;
    (cfg, model, processor)."""
    import dataclasses

    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    cfg = _llava_7b(torch.bfloat16)
    if layers:
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=layers))
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    return cfg, model, make_processor(cfg)


def host_grads(state) -> list:
    """This step's gradient of every trainable leaf of a TrainState, f32 on
    the host (a leaf that got none counts as zeros)."""
    return [(p.grad if p.grad is not None else torch.zeros_like(p)).to("cpu", torch.float32,
                                                                        copy=True)
            for p in state.trainable]


def worst_leaf_gap(got: list, want: list) -> tuple[float, int]:
    """The largest relative L2 difference |g - w| / |w| over gradient
    leaves, and its leaf's index (a leaf whose w is zero counts 0 if g is
    zero too, else inf)."""
    worst, at = 0.0, -1
    for i, (g, w) in enumerate(zip(got, want)):
        wn, dn = float(w.norm()), float((g - w).norm())
        gap = dn / wn if wn > 0 else (0.0 if dn == 0 else math.inf)
        if gap > worst:
            worst, at = gap, i
    return worst, at


# the worst leaf's relative L2 gradient difference a remat policy may show
# against attn's from the same state, at phase 7a's bf16 shape: about twice
# the largest seen on an H100 (mlp1 0.0229, mlp and acts 0.017; full and
# dots 0), far below a dropped (1) or mis-signed (2) leaf
LEAF_GAP_BOUND = 5e-2


def trainer_remat(cfg, model, proc):
    """Phase 7a: 3 DPO steps under each remat policy, every step from
    attn's state before it (the same adapters, moments, batch and seed), so
    the comparison holds remat alone, not Adam's amplification of bf16
    rounding along a trajectory (its first updates are sign(g) * lr on
    every entry). Each step's loss, and each leaf's gradient, must agree
    with attn's; the forward / backward peaks must be ordered as the
    policies keep more. Returns (per-policy results, the device batch)."""
    import dataclasses
    import statistics

    from vlrlhf_torch.cli.main import build_dpo
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.train_state import load_state_tree_

    def set_policy(policy):
        model.lm.cfg = dataclasses.replace(model.lm.cfg, remat_policy=policy)

    run = build_dpo(cfg, model, proc, dpo_args(max_steps=3), [pair_row(7, 150, 260, 250)],
                    seeded_image)
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    real = batch_np["pad_mask"].sum(1).tolist()
    batch = batch_to_device(batch_np, "cuda")
    states, ref_grads, res = [], [], {}
    for policy in ("attn", "full", "dots", "mlp", "mlp1", "acts"):
        set_policy(policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hist, ms, gaps = [], [], []
        for k in range(3):
            if policy == "attn":  # held on the host: the card's peaks stay the step's
                states.append({g: {n: t.to("cpu", copy=True) for n, t in v.items()}
                               if isinstance(v, dict) else v
                               for g, v in run.state_tree().items()})
            else:
                load_state_tree_(run.state, run.keys, states[k])
            h, t = timed_steps(run, batch, 1)
            hist += h
            ms += t
            if policy == "attn":
                ref_grads.append(host_grads(run.state))
            else:
                gaps.append(worst_leaf_gap(host_grads(run.state), ref_grads[k]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms += timed_steps(run, batch, 3)[1]  # 3 more, timed only
        mem = forward_memory(run, batch)
        gap, at = max(gaps, default=(0.0, -1))
        res[policy] = {"loss": [h["loss"] for h in hist], "norm": [h["grad_norm"] for h in hist],
                       "leaf_gaps": [g for g, _ in gaps], "leaf_gap": gap,
                       "leaf": run.keys[at] if at >= 0 else None,
                       "ms": statistics.median(ms), "peak": peak, **mem,
                       "fb_peak": max(mem["fwd_peak"], mem["kept"] + mem["bwd_peak"])}
        print(f"remat {policy}: loss {res[policy]['loss']}; grad_norm {res[policy]['norm']}; "
              f"worst leaf's relative L2 gradient gap to attn per step {res[policy]['leaf_gaps']} "
              f"({res[policy]['leaf']}); "
              f"step ms {[round(x, 3) for x in ms]} (median {res[policy]['ms']:.3f}); step peak "
              f"{peak:.3f} GiB; the policy forward keeps {mem['kept']:.3f} GiB for the backward "
              f"(forward peak +{mem['fwd_peak']:.3f}, backward peak +{mem['bwd_peak']:.3f} over "
              f"what the forward left; forward / backward peak +{res[policy]['fb_peak']:.3f})",
              flush=True)
        res[policy]["busy"] = profile_breakdown(lambda: run.step(batch),
                                                f"DPO step, {policy} remat")
    ref = res["attn"]
    for policy, r in res.items():
        if abs(r["loss"][0] - math.log(2.0)) > 1e-3:
            raise AssertionError(f"remat {policy}: step-1 loss {r['loss'][0]} is not ln 2")
        for a, b in zip(r["loss"], ref["loss"]):
            if abs(a - b) > 1e-3 * abs(b):
                raise AssertionError(f"remat {policy}: loss {r['loss']} vs attn {ref['loss']}")
        for a, b in zip(r["norm"], ref["norm"]):
            if not (np.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
                raise AssertionError(f"remat {policy}: grad_norm {r['norm']} vs attn "
                                     f"{ref['norm']}")
        if not r["leaf_gap"] <= LEAF_GAP_BOUND:
            raise AssertionError(f"remat {policy}: leaf {r['leaf']}'s gradient differs from "
                                 f"attn's by {r['leaf_gap']} (relative L2), bound "
                                 f"{LEAF_GAP_BOUND}")
    # the peak a policy sets is its forward / backward's; the step's own
    # peak can sit in the AdamW update (temporaries the size of 2 adapter
    # copies), the same under every policy that keeps less than that
    order = ("full", "attn", "mlp1", "mlp", "acts")
    peaks = [res[p]["fb_peak"] for p in order]
    if peaks != sorted(peaks):
        raise AssertionError(f"forward / backward peaks are not ordered {' <= '.join(order)}: "
                             f"{peaks}")
    print(f"phase 7a remat policies (rows of {real} real tokens padded to 1024): loss within "
          f"1e-3, grad norm within 1e-2 and every leaf's gradient within {LEAF_GAP_BOUND} "
          f"(relative L2) of attn's from the same states, step-1 ln 2, "
          f"forward / backward peaks ordered {' <= '.join(order)}: " + json.dumps(
              {p: {"median_ms": round(r["ms"], 3), "busy_ms": r["busy"] and round(r["busy"], 3),
                   "step_peak_gib": round(r["peak"], 3), "kept_gib": round(r["kept"], 3),
                   "fwd_bwd_peak_gib": round(r["fb_peak"], 3),
                   "worst_leaf_gap": r["leaf_gap"]} for p, r in res.items()}),
          flush=True)
    set_policy("attn")
    return res, batch


def phase_trainer():
    """Phase 7: the `dpo` trainer's functions at full LLaVA-1.5-7B width
    (PHASE7_LAYERS LM layers, the whole tower) on phase 6's pair (bf16): (a) the remat policies, (b) an unfrozen
    tower with tower LoRA targets, (c) the eval pass and its samples, (d)
    checkpoint, resume and the straight run they must equal, (e) the merged
    save. Returns the kernel launch counts of the phase."""
    import statistics
    import tempfile

    from vlrlhf_torch.cli.main import build_dpo, make_eval_hook, train_dpo
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.metrics import MetricsLogger
    from vlrlhf_torch.train.train_state import load_state_tree_

    cfg, model, proc = trainer_model(PHASE7_LAYERS)
    counted = {"flash_fwd": flash_attention, "flash_bwd_dkv": flash_bwd_dkv,
               "flash_bwd_dq": flash_bwd_dq, "decode_attention": decode_attention}
    for fn in counted.values():
        fn.launches = 0

    # (a) every remat policy from the same states
    res, batch = trainer_remat(cfg, model, proc)

    # (b) unfrozen tower, LoRA on the LM's 7 linears and the tower's 4
    drop_adapters(model)
    run = build_dpo(cfg, model, proc, dpo_args(max_steps=3, freeze_vision_tower=False,
                                               lora_target_modules=TOWER_TARGETS),
                    [pair_row(7, 150, 260, 250)], seeded_image)
    tower = [(n, p) for n, p in model.named_parameters()
             if n.startswith("vision.layers.") and "lora_" in n
             and int(n.split(".")[2]) < cfg.vision.layers_run]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bwd0 = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    hist, ms = [], []
    for i in range(3):
        h, t = timed_steps(run, batch, 1)
        hist += h
        ms += t
        if i >= 1 and not all(p.grad is not None and bool(p.grad.any()) for _, p in tower):
            raise AssertionError(f"unfrozen tower: a tower adapter has no gradient at step {i + 1}")
    bwd = (flash_bwd_dkv.launches - bwd0[0], flash_bwd_dq.launches - bwd0[1])
    losses = [h["loss"] for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if abs(losses[0] - math.log(2.0)) > 1e-3 or not all(np.isfinite(losses)):
        raise AssertionError(f"unfrozen tower: losses {losses}")
    want = 3 * (cfg.lm.num_layers + cfg.vision.layers_run)
    if min(bwd) < want:
        raise AssertionError(f"unfrozen tower: {bwd} dK/dV, dQ launches in 3 steps, want {want}")
    print(f"phase 7b unfrozen tower ({len(tower)} tower adapter leaves of {cfg.vision.layers_run} "
          f"layers, all with non-zero gradients at steps 2-3): loss {losses}; grad_norm "
          f"{[h['grad_norm'] for h in hist]}; step ms {[round(x, 3) for x in ms]} (median "
          f"{statistics.median(ms):.3f}; attn remat frozen tower {res['attn']['ms']:.3f}); "
          f"peak {peak:.3f} GiB; flash backward launches (dK/dV, dQ) {bwd}", flush=True)
    profile_breakdown(lambda: run.step(batch), "unfrozen-tower DPO step")

    with tempfile.TemporaryDirectory() as tmp:
        # (c) the eval pass and its samples: 16 pairs, 2 held out
        drop_adapters(model)
        rows = [pair_row(300 + i, 150, 260, 250) for i in range(16)]
        args = dpo_args(max_steps=2, eval_steps=2, eval_ratio=0.125, eval_samples=2,
                        output_dir=os.path.join(tmp, "eval"))
        run = build_dpo(cfg, model, proc, args, rows, seeded_image)
        logger = MetricsLogger(args.output_dir, "dpo")
        dec0 = decode_attention.launches
        make_eval_hook(run, proc, args, logger)(0)  # adapters still zero
        dec = decode_attention.launches - dec0
        train_dpo(run, proc, args, logger)
        logger.close()
        lines = [json.loads(x) for x in open(logger.path).read().splitlines()]
        evals = {r["step"]: r for r in lines if "eval/loss" in r}
        samples = [json.loads(x) for x in
                   open(os.path.join(args.output_dir, "dpo_samples.jsonl")).read().splitlines()]
        at0 = [x for x in samples if x["step"] == 0]
        if sorted(evals) != [0, 2] or not all(np.isfinite(v) for r in evals.values()
                                              for v in r.values()):
            raise AssertionError(f"eval lines: {evals}")
        if len(at0) != 2 or any(x["policy"] != x["ref"] or not x["policy"] for x in at0):
            raise AssertionError(f"step-0 policy and reference samples differ: {at0}")
        if dec < 2 * cfg.lm.num_layers or len(samples) != 4:
            raise AssertionError(f"eval samples: {dec} decode launches, {len(samples)} samples")
        print(f"phase 7c eval ({len(run.eval_rows)} of 16 pairs held out): eval/* at steps 0 "
              f"and 2 {json.dumps({k: {m: round(v, 6) for m, v in r.items() if m != 'step'} for k, r in evals.items()})}; "
              f"step-0 policy == reference samples ({len(at0[0]['policy'].split())} and "
              f"{len(at0[1]['policy'].split())} words); {dec} decode launches at step 0",
              flush=True)

        # (d) 4 steps straight; 2 steps + a checkpoint, a resume, 2 more
        def leg(out, epochs, **kw):
            drop_adapters(model)
            a = dpo_args(max_steps=4, num_train_epochs=epochs, lora_dropout=0.05,
                         output_dir=os.path.join(tmp, out), **kw)
            r = build_dpo(cfg, model, proc, a, [pair_row(7, 150, 260, 250)], seeded_image)
            lg = MetricsLogger(a.output_dir, "dpo")
            last = train_dpo(r, proc, a, lg)
            lg.close()
            losses = {x["step"]: x["loss"] for x in map(json.loads, open(lg.path))}
            return r, a, last, losses

        _, _, _, straight = leg("straight", 100)
        first, a1, last, _ = leg("resumed", 2, save_steps=2)
        ck = os.path.join(tmp, "resumed", "checkpoints")
        nbytes = os.path.getsize(os.path.join(ck, "2", "state.pt"))
        mgr = CheckpointManager(os.path.join(tmp, "timing"))
        t0 = time.perf_counter()
        mgr.save(2, first.state_tree())
        mgr.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tree, _ = mgr.restore(2)
        load_state_tree_(first.state, first.keys, tree)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        del tree
        resumed, a2, last2, losses = leg("resumed", 100, resume_from_checkpoint="auto",
                                         merge_adapter_after_training=True)
        if last != 2 or last2 != 4 or sorted(os.listdir(ck)) != ["2"]:
            raise AssertionError(f"save / resume: legs ended at {last}, {last2}; "
                                 f"checkpoints {os.listdir(ck)}")
        for step in (3, 4):
            if abs(losses[step] - straight[step]) > 1e-3 * abs(straight[step]):
                raise AssertionError(f"resumed step {step} loss {losses[step]} vs straight "
                                     f"{straight[step]}")
        print(f"phase 7d save / resume: straight losses {straight}; resumed "
              f"{ {k: losses[k] for k in (3, 4)} } (within 1e-3); checkpoint "
              f"{nbytes / 2**20:.3f} MiB ({len(first.keys)} adapter leaves with their moments), "
              f"save {save_ms:.3f} ms (host copy and write), restore {restore_ms:.3f} ms",
              flush=True)

        # (e) the merged save of the resumed run
        n_layers = cfg.lm.num_layers
        names = ("lm.layers.0.wq", f"lm.layers.{n_layers // 2}.gate",
                 f"lm.layers.{n_layers - 1}.down")
        want = sampled_merges(model, resumed.lcfg.scale, names,
                              {n: model.get_submodule(n).weight for n in names})
        finish_timed(resumed, a2, want, "phase 7e merge")
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"phase 7 launches {json.dumps(launches)}", flush=True)
    del run, model, batch
    return launches


EVAL_SLOTS = 8  # phase 8: the continuous path's slots (the static batch is 16)
EVAL_NEW = 16  # phase 8: new tokens per row


def eval_image(path, size, mode="shortest_edge_crop"):
    """Image loader for eval rows: the file name names a seed (each run
    decodes its TSV into a directory of its own)."""
    return seeded_image(os.path.basename(str(path)), size, mode)


def write_eval_data(tmp: str) -> tuple[str, str]:
    """An MME-shaped TSV (32 yes/no rows over 16 images; an image's second
    row names the first's index, as MME's TSV does) and a SEEDBench json
    (16 questions x 4 choices). The images are seeded blobs that
    `eval_image` maps to pixels by file name."""
    import base64

    rng = np.random.default_rng(8)
    cats = ("existence", "count", "position", "color", "OCR", "commonsense_reasoning")
    mme = os.path.join(tmp, "mme.tsv")
    with open(mme, "w") as f:
        f.write("index\timage\tquestion\tanswer\tcategory\n")
        for i in range(16):
            blob = base64.b64encode(rng.integers(0, 256, 96, dtype=np.uint8).tobytes()).decode()
            for j in range(2):
                q = (f"Is there a w{100 + i} {('red', 'blue')[j]} object in the image? "
                     "Please answer yes or no.")
                f.write(f"{i}-{j}\t{blob if j == 0 else f'{i}-0'}\t{q}\t"
                        f"{('Yes', 'No')[(i + j) % 2]}\t{cats[i % len(cats)]}\n")
    seed = os.path.join(tmp, "seed.json")
    with open(seed, "w") as f:
        json.dump({"questions": [
            {"question_id": f"q{i}", "question": f"What does the picture w{200 + i} show?",
             "choice_a": f"a dog w{i}", "choice_b": "a cat on a mat", "choice_c": "two birds",
             "choice_d": f"a fish in water w{3 * i}", "answer": "ABCD"[i % 4],
             "data_id": f"seed{i}.jpg", "question_type_id": 1 + i % 9} for i in range(16)]}, f)
    return mme, seed


def eval_args(**kw):
    """`eval`'s arguments as build_eval / run_eval read them: batch 16,
    EVAL_NEW new tokens, greedy."""
    import argparse

    base = dict(benchmark="mme", data_file="", image_root="", output_dir="", sqlite_db=None,
                tag="phase8", max_new_tokens=EVAL_NEW, per_device_train_batch_size=16,
                quantize="false", fuse_decode=False, kv_cache_dtype="bf16",
                continuous_batching=False, speculative_k=0, do_sample=False, temperature=1.0,
                top_k=None, top_p=None, synthetic=0, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


def record_tokens(runner, eos: set) -> list:
    """Wrap runner._decode so each row's generated ids, cut at the first
    stop token, are appended (in row order) to the returned list."""
    seen: list = []
    decode = runner._decode

    def wrapped(toks):
        ids = [int(t) for t in toks]
        cut = next((i for i, t in enumerate(ids) if t in eos), len(ids))
        seen.append(ids[:cut])
        return decode(toks)

    runner._decode = wrapped
    return seen


def divergence(ref: list, got: list, eos: int):
    """(position, ref token, got token) where two token lists first differ
    (past the shorter's end its token is the stop token), or None."""
    for j in range(max(len(ref), len(got))):
        a = ref[j] if j < len(ref) else eos
        b = got[j] if j < len(got) else eos
        if a != b:
            return j, a, b
    return None


def tie_or_raise(what: str, model, proc, ids: list, img, ref: list, got: list, eos: int,
                 ctx=None):
    """None when `got` equals `ref`. Else the first divergence must be a
    top-2 tie of `model`'s teacher-forced logits after ref's common
    prefix (under `ctx`'s adapters): both tokens are its top two and their
    gap is within LOGIT_REL_TOL of the largest |logit|. Returns (position,
    ref token, got token, gap)."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill

    d = divergence(ref, got, eos)
    if d is None:
        return None
    j, a, b = d
    coll = GenerationCollator(proc, CollatorConfig(image_size=model.cfg.vision.image_size),
                              eval_image)
    t = batch_to_device(coll([{"input_ids": list(ids) + list(ref[:j]), "img_path": img}]),
                        model.device)
    with torch.inference_mode():
        *_, last = prefill(model, GenerateConfig(max_new_tokens=1, pad_token_id=-1),
                           t["input_ids"].shape[1], t["input_ids"], t["pad_mask"],
                           t["prompt_lens"], t["pixel_values"], t["image_positions"], None, ctx)
    logits = last[0].float().cpu()
    top2 = torch.topk(logits, 2)
    gap = float((logits[a] - logits[b]).abs())
    limit = LOGIT_REL_TOL * float(logits.abs().max())
    if {a, b} != set(top2.indices.tolist()) or gap > limit:
        raise AssertionError(f"{what}: diverges at {j} ({a} vs {b}) and it is no top-2 tie: "
                             f"top-2 {top2.indices.tolist()} {top2.values.tolist()}, gap {gap} "
                             f"(limit {limit})")
    return j, a, b, round(gap, 5)


def text_ids(text: str) -> list:
    """The ids of a ToyTokenizer text (it prints id i >= 16 as "w<i>" and
    drops the specials and reserved ids below 16)."""
    return [int(w[1:]) for w in text.split()]


def visible(ids: list) -> list:
    return [t for t in ids if t >= 16]


def adapter_set(model, seed: int) -> dict:
    """A LoRA r64 set on the LM's 7 linears, keyed as a dpo run's adapters
    file: a ~ N(0, 1/r), b ~ N(0, 0.01^2), so its delta moves the tokens."""
    from vlrlhf_torch.lora.lora import LM_ALL_LINEARS, match_lora_targets, module_path

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, mod in match_lora_targets(model, LM_ALL_LINEARS):
        key = module_path(name)[: -len("/kernel")]
        out[f"{key}/a"] = torch.randn((mod.d_in, 64), generator=gen, device="cuda") / 8.0
        out[f"{key}/b"] = 0.01 * torch.randn((64, mod.d_out), generator=gen, device="cuda")
    return out


def phase_eval():
    """Phase 8: `eval` and the serving leftovers at full LLaVA-1.5-7B width
    and depth (seeded random bf16 weights), then the harness at reduced
    depth against the CPU. Returns the launch counts of (a) + (b), the
    "eval" path, and of (c)'s servers, "serve_adapters"; tie checks and
    reference runs are not counted."""
    import tempfile
    from contextlib import nullcontext

    from vlrlhf_torch.cli.main import build_eval, build_server, collator_config, main, run_eval
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.server import EndpointRunner, RequestBuilder
    from vlrlhf_torch.lora.lora import lend_adapters
    from vlrlhf_torch.models.common import Ctx, init_random_
    from vlrlhf_torch.models.config import FAMILIES, _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention
    from vlrlhf_torch.train.checkpoint import save_params

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "chunk_attention": chunk_attention}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    family = FAMILIES[cfg.family]
    with tempfile.TemporaryDirectory() as tmp:
        mme, seed = write_eval_data(tmp)
        # (a) generation paths, (b) CE ranking: the "eval" path's launches
        reset()
        paths = {"static": {}, "continuous": dict(continuous_batching=True,
                                                  per_device_train_batch_size=EVAL_SLOTS),
                 "speculative": dict(speculative_k=3)}
        toks, texts, prompts = {}, {}, None
        for name, kw in paths.items():
            args = eval_args(data_file=mme, output_dir=os.path.join(tmp, name), **kw)
            runner = build_eval(cfg, model, proc, args, eval_image)
            eos = set(runner.gen_cfg.eos_token_ids)
            toks[name] = record_tokens(runner, eos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run_eval(runner, args, progress=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(tmp, name, "mme.json")) as f:
                rows = json.load(f)
            texts[name] = [r["response"] for r in rows]
            if prompts is None:
                prompts = [runner.processor.generation_row(r["question"],
                                                           os.path.basename(r["img"]))
                           for r in rows]
            n_tok = sum(len(t) for t in toks[name])
            extra = ""
            if name == "speculative":
                g = runner._gen
                extra = (f"; verify_calls {g.verify_calls}, {g.verify_rows} row verifies, "
                         f"{g.verify_tokens / max(g.verify_rows, 1):.3f} tokens per row "
                         f"verify (K=3)")
            print(f"phase 8a eval mme {name} ({len(rows)} rows, "
                  f"{'8 slots' if name == 'continuous' else 'batch 16'}, {EVAL_NEW} new "
                  f"tokens): {len(rows) / wall:.3f} images/s ({wall:.3f} s, {n_tok} tokens)"
                  f"{extra}; metrics {json.dumps(metrics)}", flush=True)
            if len(rows) != 32 or any(len(t) == 0 for t in toks[name]):
                raise AssertionError(f"eval {name}: {len(rows)} rows, empty responses")
        stop = runner.gen_cfg.eos_token_ids[-1]
        args = eval_args(benchmark="seedbench", data_file=seed, output_dir=os.path.join(tmp, "ce"))
        runner = build_eval(cfg, model, proc, args, eval_image)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_eval(runner, args, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "ce", "seedbench.json")) as f:
            ce_rows = json.load(f)
        ppl = np.asarray([r["ppl"] for r in ce_rows])
        print(f"phase 8b CE ranking (seedbench, {len(ce_rows)} rows in batches of 16): "
              f"{len(ce_rows) / wall:.3f} rows/s ({wall:.3f} s); ppl min {ppl.min():.4f} max "
              f"{ppl.max():.4f}; metrics {json.dumps(metrics)}", flush=True)
        if len(ce_rows) != 64 or not np.isfinite(ppl).all():
            raise AssertionError(f"CE ranking: {len(ce_rows)} rows, finite {np.isfinite(ppl).all()}")
        eval_launches = read()
        print(f"phase 8 eval path launches {json.dumps(eval_launches)}", flush=True)
        # the checks below run teacher-forced prefills: after the count
        for name in ("continuous", "speculative"):
            ties = [(i, tie) for i, (p, r, g) in enumerate(zip(prompts, toks["static"],
                                                                 toks[name]))
                    if (tie := tie_or_raise(f"eval {name} row {i}", model, proc,
                                            p["input_ids"], p["img_path"], r, g, stop))]
            print(f"phase 8a {name} vs static: {32 - len(ties)}/32 rows token-identical; "
                  f"divergences (row, (position, static, {name}, gap)) {ties}, all top-2 ties",
                  flush=True)

        # (c) multi-adapter serving, /score, eval --endpoint, the fused layout;
        # the "serve_adapters" path counts what the servers launch, from
        # build to stop, and not the reference engines and tie checks
        adapter_launches = dict.fromkeys(counted, 0)
        sets = {"a": adapter_set(model, 11), "b": adapter_set(model, 12)}
        specs = []
        for name, tree in sets.items():
            save_params(os.path.join(tmp, name, "adapters"), tree)
            specs.append(f"{name}={os.path.join(tmp, name, 'adapters')}")
        questions = [(f"request {i}: what does this image show? answer in detail",
                      f"ad{i}.png", ("a", "b", None)[i % 3]) for i in range(8)]
        http = {}
        for fused in (False, True):
            sargs = serve_args(adapter=specs, lora_r=64, lora_alpha=16.0,
                               max_new_tokens=EVAL_NEW, fuse_decode=fused)
            reset()
            httpd, srv = build_server(cfg, model, proc, sargs, eval_image)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                bodies = [dict({"question": q, "image": img, "max_new_tokens": EVAL_NEW},
                               **({"adapter": a} if a else {})) for q, img, a in questions]
                t0 = time.perf_counter()
                http[fused] = [text_ids(r["text"]) for r in
                               post_concurrently(url + "/generate", bodies)]
                wall = time.perf_counter() - t0
                print(f"phase 8c {'fused' if fused else 'unfused'} multi-adapter serve: 8 "
                      f"/generate requests over a, b and the base model in {wall:.3f} s",
                      flush=True)
                if not fused:
                    score_rows = [{"question": r["question"], "answer": r["answer"],
                                   "img": os.path.basename(r["img"])} for r in ce_rows[:16]]
                    remote = EndpointRunner(url).run_vqa_ppl(score_rows)
                    main(["eval", "--endpoint", url, "--benchmark", "mme", "--data_file", mme,
                          "--output_dir", os.path.join(tmp, "endpoint")])
            finally:
                httpd.shutdown()
                httpd.server_close()
                srv.stop()
                thread.join(timeout=60)
            if thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
                raise AssertionError("server threads did not stop")
            for name, n in read().items():
                adapter_launches[name] += n
            gen_cfg = srv.engine.gen_cfg
            builder = RequestBuilder(proc, collator_config(cfg, family, proc, sargs), eval_image)
            stop = gen_cfg.eos_token_ids[-1]
            ids = [proc.process_conv(make_single_turn_conv(proc.format_multimodal_prompt(q, 1),
                                                           ""))["input_ids"]
                   for q, _, _ in questions]
            ties = []
            if not fused:
                local = EvalRunner(model, proc, gen_cfg, collator_config(cfg, family, proc, sargs),
                                   eval_image).run_vqa_ppl(score_rows)
                rel = max(abs(r["ppl"] - w["ppl"]) / abs(w["ppl"]) for r, w in zip(remote, local))
                print(f"phase 8c /score via EndpointRunner vs in-process run_vqa_ppl (16 rows): "
                      f"max rel diff {rel:.3e} (tol 1e-3)", flush=True)
                if rel > 1e-3:
                    raise AssertionError(f"/score differs from run_vqa_ppl: rel {rel}")
                with open(os.path.join(tmp, "endpoint", "mme.json")) as f:
                    remote_rows = json.load(f)
                eties = [(i, tie) for i, (p, r, row) in enumerate(zip(prompts, toks["continuous"],
                                                                       remote_rows))
                         if (tie := tie_or_raise(f"eval --endpoint row {i}", model, proc,
                                                 p["input_ids"], p["img_path"], visible(r),
                                                 text_ids(row["response"]), stop))]
                print(f"phase 8c eval --endpoint mme vs in-process continuous: "
                      f"{32 - len(eties)}/32 rows identical, divergences {eties}", flush=True)
                for name in ("a", "b", None):
                    idx = [i for i, q in enumerate(questions) if q[2] == name]
                    reqs = [builder.build(questions[i][0], questions[i][1], EVAL_NEW,
                                          adapter_idx=None if name is None else 0) for i in idx]
                    eng = ContinuousEngine(model, gen_cfg, n_slots=EVAL_SLOTS,
                                           cache_len=srv.engine.cache_len,
                                           adapter_sets=None if name is None else [sets[name]],
                                           lora_scale=0.25)
                    want = eng.run(reqs)
                    ctx = None if name is None else Ctx(adapters=True, lora_scale=0.25,
                                                        adapter_mix=torch.ones((1, 1),
                                                                               device="cuda"))
                    # a tie check's prefill runs the engine's set, lent again
                    with (nullcontext() if name is None
                          else lend_adapters(model, eng.adapter_sets)):
                        for i, w in zip(idx, want):
                            tie = tie_or_raise(f"adapter {name} request {i}", model, proc,
                                               ids[i], questions[i][1], visible(w),
                                               http[False][i], stop, ctx)
                            if tie:
                                ties.append((i, name, tie))
                print(f"phase 8c multi-adapter tokens vs one-set engines: {8 - len(ties)}/8 "
                      f"identical, divergences {ties}", flush=True)
            else:
                names = ["a", "b"]
                with lend_adapters(model, srv.engine.adapter_sets):  # the server's fused sets
                    for i, (q, img, name) in enumerate(questions):
                        mix = torch.zeros((1, 2), device="cuda")
                        if name is not None:
                            mix[0, names.index(name)] = 1.0
                        tie = tie_or_raise(f"fused adapter {name} request {i}", model, proc,
                                           ids[i], img, http[False][i], http[True][i], stop,
                                           Ctx(adapters=True, lora_scale=0.25, adapter_mix=mix))
                        if tie:
                            ties.append((i, name, tie))
                print(f"phase 8c fused (--fuse_decode true) vs unfused adapter tokens: "
                      f"{8 - len(ties)}/8 identical, divergences {ties}", flush=True)
        print(f"phase 8c launches {json.dumps(adapter_launches)}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    eval_reduced_depth()
    return eval_launches, adapter_launches


def eval_reduced_depth():
    """Phase 8d: EvalRunner at full widths but 2 LM / 2 tower layers, the
    same seeded weights on the card (bf16, kernels) and the CPU (f32,
    plain): 4 image questions (8 greedy tokens) and 8 CE rows. ppl within
    PPL_REL_TOL relative; greedy tokens equal up to top-2 ties of the
    CPU's teacher-forced logits. Two broken controls on the card must fail
    PPL_REL_TOL, or the check could not catch a wrong path: the LM's
    attention without its causal mask, and the answer labels one token
    off."""
    import dataclasses

    import vlrlhf_torch.models.lm.llama as llama

    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    full = _llava_7b(torch.float32)
    cfg32 = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_layers=2),
                                vision=dataclasses.replace(full.vision, num_layers=2))
    cfg16 = dataclasses.replace(cfg32, lm=dataclasses.replace(cfg32.lm, dtype=torch.bfloat16),
                                vision=dataclasses.replace(cfg32.vision, dtype=torch.bfloat16))
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    gpu = VLM(cfg16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    proc = make_processor(cfg32)
    gen_rows = [{"question": f"Is there a w{300 + i} in the image? Please answer yes or no.",
                 "img": f"d{i}.jpg"} for i in range(4)]
    ce_rows = [{"question": f"What does the picture w{400 + i // 4} show?",
                "answer": f"The answer is: {('a dog', 'a cat', 'two birds', 'a fish')[i % 4]}",
                "img": f"d{i // 4}.jpg"} for i in range(8)]
    out, runners = {}, {}
    for name, model in (("card", gpu), ("host", cpu)):
        runner = runners[name] = EvalRunner(
            model, proc, GenerateConfig(max_new_tokens=8, pad_token_id=0),
            CollatorConfig(image_size=cfg32.vision.image_size), eval_image)
        toks = record_tokens(runner, set())
        runner.run_vqa(gen_rows, batch_size=4)
        ppl = [r["ppl"] for r in runner.run_vqa_ppl(ce_rows, batch_size=8)]
        out[name] = (toks, np.asarray(ppl))

    def rel_err(ppl):
        return float(np.max(np.abs(ppl - out["host"][1]) / np.abs(out["host"][1])))

    def card_ppl():
        return np.asarray([r["ppl"] for r in runners["card"].run_vqa_ppl(ce_rows, batch_size=8)])

    rel = rel_err(out["card"][1])
    controls = {}
    mha = llama.multi_head_attention
    llama.multi_head_attention = lambda q, k, v, causal=True, **kw: mha(q, k, v, causal=False,
                                                                        **kw)
    try:
        controls["no causal mask"] = rel_err(card_ppl())
    finally:
        llama.multi_head_attention = mha
    ce = runners["card"].ce
    runners["card"].ce = lambda batch: ce(dict(batch,
                                               labels=np.roll(np.asarray(batch["labels"]), 1, 1)))
    try:
        controls["labels one token off"] = rel_err(card_ppl())
    finally:
        del runners["card"].ce
    ties = []
    for i, (r, g) in enumerate(zip(out["host"][0], out["card"][0])):
        p = runner.processor.generation_row(gen_rows[i]["question"], gen_rows[i]["img"])
        tie = tie_or_raise(f"reduced-depth eval row {i}", cpu, proc, p["input_ids"],
                           p["img_path"], r, g, 2)
        if tie:
            ties.append((i, tie))
    print(f"phase 8d reduced-depth EvalRunner (2 LM / 2 tower layers, full widths), card bf16 "
          f"vs CPU f32: ppl max rel err {rel:.3e} (tol {PPL_REL_TOL}), ppl card "
          f"{np.round(out['card'][1], 4).tolist()}; broken controls' max rel err "
          f"{ {k: f'{v:.3e}' for k, v in controls.items()} } (each must exceed the tol); "
          f"greedy tokens {4 - len(ties)}/4 rows identical, divergences {ties}", flush=True)
    if not np.isfinite(out["card"][1]).all() or rel > PPL_REL_TOL:
        raise AssertionError(f"reduced-depth ppl differs: rel {rel} > {PPL_REL_TOL}")
    if min(controls.values()) <= PPL_REL_TOL:
        raise AssertionError(f"a broken control passes PPL_REL_TOL, so the ppl check cannot "
                             f"catch it: {controls}")
    del cpu, gpu
    torch.cuda.empty_cache()


# ───────────────────────── phase 9: a checkpoint on disk ─────────────────────────

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
FIXTURE_ARRAYS = "fx_336_shortest_edge_crop.npz"  # the CPU box's native decode of the JPEGs
CKPT_QUESTIONS = [f"request {i}: what is shown in the image? describe it in detail"
                  for i in range(8)]


def fixture_jpegs() -> list:
    return sorted(os.path.join(FIXTURES, n) for n in os.listdir(FIXTURES) if n.endswith(".jpg"))


def phase9_image_loader():
    """The loader phase 9 feeds its JPEG fixtures through: the port's native
    loader where it builds (then None, the collators' default, and the
    decode rate of load_batch), else the arrays the CPU box decoded from
    the same files with it. The second is this harness's choice of input,
    not a fallback of the program: the native loader still raises here."""
    from vlrlhf_torch.data import native_image

    with np.load(os.path.join(FIXTURES, FIXTURE_ARRAYS)) as npz:  # read once: the HTTP
        arrays = {k: npz[k] for k in npz.files}  # threads load concurrently
    try:
        native_image._library()
    except RuntimeError as e:
        reason = " | ".join(str(e).strip().splitlines()[:3])
        try:
            native_image.load_image(fixture_jpegs()[0], 336)
        except RuntimeError:
            pass
        else:
            raise AssertionError("the native loader decoded a JPEG after its build failed")
        print(f"phase 9 finding: the native JPEG loader does not build on this machine "
              f"({reason}); the JPEG fixtures are fed as {FIXTURE_ARRAYS}, the CPU box's "
              f"decode of the same files, and load_batch images/s is not measured", flush=True)

        def load(path, size, mode="shortest_edge_crop"):
            if size != 336 or mode != "shortest_edge_crop":
                raise ValueError(f"{FIXTURE_ARRAYS} holds 336-px shortest_edge_crop decodes only")
            return arrays[os.path.basename(path)]

        return load, None
    paths = fixture_jpegs() * 16
    native_image.load_batch(paths[:6], 336)
    t0 = time.perf_counter()
    out = native_image.load_batch(paths, 336)
    rate = len(paths) / (time.perf_counter() - t0)
    worst = max(int(np.abs(out[i].astype(int) - arrays[os.path.basename(p)].astype(int)).max())
                for i, p in enumerate(paths[:6]))
    print(f"phase 9 native JPEG loader: load_batch {len(paths)} images of 6 fixtures at 336 px "
          f"in 8 threads: {rate:.1f} images/s; max |this machine - the CPU box's decode| "
          f"{worst}", flush=True)
    return None, rate


def ckpt_requests(proc, loader):
    """The 8 image requests of phase 9 (fixture JPEGs in turn)."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.generate.continuous import Request

    coll = GenerationCollator(proc, CollatorConfig(pad_token_id=proc.tokenizer.pad_token_id,
                                                   image_size=336), loader)
    jpegs = fixture_jpegs()
    reqs = []
    for j, question in enumerate(CKPT_QUESTIONS):
        ids = proc.process_conv(make_single_turn_conv(
            proc.format_multimodal_prompt(question, 1), ""))["input_ids"]
        b1 = coll([{"input_ids": ids, "img_path": jpegs[j % len(jpegs)]}])
        n = int(b1["prompt_lens"][0])
        reqs.append(Request(input_ids=b1["input_ids"][0, :n],
                            pixel_values=b1["pixel_values"][0, 0],
                            image_positions=b1["image_positions"][0], max_new_tokens=32))
    return reqs


def ckpt_serve(model, proc, args, loader, http: bool) -> tuple:
    """build_server over `model` (which applies --quantize in place); with
    `http` the 8 requests over /generate and their kernel launch counts;
    then, the scheduler stopped, the engine's greedy tokens for them in
    batch mode (a fixed admission order). Returns (tokens, launches)."""
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention
    from vlrlhf_torch.ops.int4 import int4_matmul

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "chunk_attention": chunk_attention, "int4_matmul": int4_matmul}
    httpd, srv = build_server(model.cfg, model, proc, args, loader)
    launches = None
    thread = None
    try:
        if http:
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
            jpegs = fixture_jpegs()
            bodies = [{"question": q, "image": jpegs[j % len(jpegs)], "max_new_tokens": 32}
                      for j, q in enumerate(CKPT_QUESTIONS)]
            for fn in counted.values():
                fn.launches = 0
            results = post_concurrently(url, bodies)
            launches = {k: fn.launches for k, fn in counted.items() if fn.launches}
            if not all(r["tokens"] > 0 for r in results):
                raise AssertionError(f"an empty response: {results}")
    finally:
        if thread is not None:
            httpd.shutdown()
            thread.join(timeout=60)
        httpd.server_close()
        srv.stop()
    if thread is not None and thread.is_alive():
        raise AssertionError("the HTTP thread did not stop")
    tokens = srv.engine.run(ckpt_requests(proc, loader),
                            torch.Generator(device=model.device).manual_seed(0))
    del srv
    return [list(map(int, t)) for t in tokens], launches


def ckpt_import(args) -> tuple:
    """load_bundle (the CLI's loader) with the card's peak memory during the
    import over what was allocated before it. Returns (bundle, ms, peak
    bytes over the baseline, resident bytes of the model)."""
    from vlrlhf_torch.cli.main import load_bundle

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = load_bundle(args, torch.device("cuda"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - before
    resident = sum(t.numel() * t.element_size() for t in bundle[2].state_dict().values())
    return bundle, ms, peak, resident


def same_state(a, b, what: str) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    bad = [k for k in sa if k not in sb or sa[k].dtype != sb[k].dtype or
           not torch.equal(sa[k], sb[k])]
    if bad or sa.keys() != sb.keys():
        raise AssertionError(f"{what}: {len(bad)} tensors differ, e.g. {bad[:4]}")


def same_tokens(got: list, want: list, what: str) -> None:
    same = sum(g == w for g, w in zip(got, want))
    print(f"phase 9 {what}: greedy tokens {same}/{len(want)} requests identical", flush=True)
    if same != len(want):
        raise AssertionError(f"{what}: tokens differ: {got} vs {want}")


def ckpt_dpo(args, loader, counted: dict) -> tuple:
    """`dpo` from a checkpoint and a dataset through the CLI's functions
    (load_rows, load_bundle, build_dpo, train_dpo, finish_run): the step
    metrics, the launch counts and the run; the JPEGs through `loader`."""
    from vlrlhf_torch.cli.main import build_dpo, finish_run, load_bundle, load_rows, train_dpo
    from vlrlhf_torch.train.metrics import MetricsLogger

    rows = load_rows(args)
    _, cfg, model, proc = load_bundle(args, torch.device("cuda"))
    run = build_dpo(cfg, model, proc, args, rows, loader)
    logger = MetricsLogger(args.output_dir, "dpo", flops_per_token=run.flops_per_token,
                           flops_per_image=run.flops_per_image)
    for fn in counted.values():
        fn.launches = 0
    try:
        train_dpo(run, proc, args, logger)
    finally:
        logger.close()
    launches = {k: fn.launches for k, fn in counted.items() if fn.launches}
    finish_run(run, args)
    with open(os.path.join(args.output_dir, "dpo_metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    losses = [m["loss"] for m in metrics if "loss" in m]
    if len(losses) != args.max_steps or abs(losses[0] - math.log(2.0)) > 1e-3 or \
            not all(np.isfinite(v) for m in metrics for v in m.values() if isinstance(v, float)):
        raise AssertionError(f"dpo from the checkpoint: step-1 loss {losses} is not ln 2 within "
                             f"1e-3 or a metric is not finite: {metrics}")
    return run, losses, launches


def phase_checkpoint(dpo_ms: float) -> dict:
    """Phase 9: a full-width, full-depth LLaVA-1.5-7B checkpoint written to
    disk (seeded random weights through utils/hf_export.py, the published
    llava-hf/llava-1.5-7b-hf config.json, the seeded llama tokenizer.json)
    and read back through the CLI's loader: served bf16, int8 (speculative,
    int8 KV) and int4, each quantized while it streams in, against the same
    weights built in memory (and quantized after); DPO from a plain_dpo
    dataset of the JPEG fixtures; then at 2 LM / 2 tower layers QLoRA int4
    DPO, eval mmvet with the checkpoint as its judge, and merge
    --export_format hf reloaded. Returns the kernel launch counts by path."""
    import dataclasses
    import shutil

    from vlrlhf_torch.cli.loading import config_from_hf
    from vlrlhf_torch.cli.loading import make_processor as bundle_processor
    from vlrlhf_torch.cli.main import build_eval, build_parser, load_judge, main as cli, run_eval
    from vlrlhf_torch.data.tokenizer import JsonTokenizer
    from vlrlhf_torch.eval.judge import EngineJudge
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from vlrlhf_torch.ops.int4 import int4_matmul, int4_matmul_t
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.train.checkpoint import load_params
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.utils.synthetic_checkpoint import (
        LLAVA_15_7B_CONFIG, write_llava_checkpoint,
    )

    loader, imgs_per_s = phase9_image_loader()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"phase9-{os.getpid()}")
    full = os.path.join(root, "llava-1.5-7b")
    launches: dict = {}
    train_counted = {"flash_fwd": flash_attention, "flash_bwd_dkv": flash_bwd_dkv,
                     "flash_bwd_dq": flash_bwd_dq, "int4_matmul": int4_matmul,
                     "int4_matmul_t": int4_matmul_t}

    def serve_ns(**kw):
        return serve_args(model_name_or_path=full, bf16=True, device="cuda", adapter=None, **kw)

    try:
        # the published config.json's model (its projector_hidden_act "gelu"
        # is erf), so the in-memory twin computes what the import computes
        cfg = config_from_hf(LLAVA_15_7B_CONFIG, torch.bfloat16)[1]

        def in_memory():
            m = VLM(cfg, "cuda")
            return init_random_(m, torch.Generator(device="cuda").manual_seed(0))

        model = in_memory()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = write_llava_checkpoint(full, model.state_dict(), cfg, config=LLAVA_15_7B_CONFIG)
        write_ms = (time.perf_counter() - t0) * 1e3
        print(f"phase 9 checkpoint: {nbytes} bytes ({nbytes / 1e9:.3f} GB) of model.safetensors "
              f"written in {write_ms:.1f} ms ({nbytes / write_ms / 1e6:.3f} GB/s), the published "
              f"llava-1.5-7b-hf config.json, a {JsonTokenizer(full).vocab_size}-token "
              f"tokenizer.json", flush=True)
        proc = bundle_processor(FAMILIES["llava"], JsonTokenizer(full), cfg,
                                max_length=992, max_prompt_length=512)
        want_bf16, _ = ckpt_serve(model, proc, serve_ns(), loader, http=False)

        # bf16: the import against the same weights in memory
        layer = sum(t.numel() * t.element_size() for t in model.lm.layers[0].state_dict().values())

        def check_peak(what, peak, resident):
            print(f"phase 9 import {what}: peak {peak / 2**30:.3f} GiB over "
                  f"{resident / 2**30:.3f} GiB resident, +{(peak - resident) / 2**20:.1f} MiB "
                  f"(one LM layer is {layer / 2**20:.1f} MiB)", flush=True)
            if peak - resident > layer:
                raise AssertionError(f"the {what} import held more than a layer beyond the model")

        bundle, ms, peak, resident = ckpt_import(serve_ns())
        imported = bundle[2]
        same_state(imported, model, "bf16 import vs the in-memory model")
        print(f"phase 9 import bf16: {ms:.1f} ms, {nbytes / ms / 1e6:.3f} GB/s", flush=True)
        check_peak("bf16", peak, resident)
        got, launches["ckpt_serve"] = ckpt_serve(imported, bundle[3], serve_ns(), loader, True)
        same_tokens(got, want_bf16, "bf16 serve from the checkpoint vs in memory")
        del bundle, imported
        gc.collect()
        torch.cuda.empty_cache()

        for bits, kw in ((8, dict(quantize="int8", kv_cache_dtype="int8", speculative_k=3)),
                         (4, dict(quantize="int4"))):
            if bits == 4:
                model = in_memory()
            want, _ = ckpt_serve(model, proc, serve_ns(**kw), loader, http=False)  # after
            bundle, ms, peak, resident = ckpt_import(serve_ns(**kw))  # during
            same_state(bundle[2], model, f"int{bits} import vs quantizing after")
            print(f"phase 9 import int{bits} (quantized on the host while streaming): {ms:.1f} "
                  f"ms, {nbytes / ms / 1e6:.3f} GB/s of checkpoint", flush=True)
            check_peak(f"int{bits}", peak, resident)
            got, launches[f"ckpt_serve_int{bits}"] = ckpt_serve(bundle[2], bundle[3],
                                                               serve_ns(**kw), loader, True)
            same_tokens(got, want, f"int{bits} serve, quantized during the import vs after")
            del bundle, model
            gc.collect()
            torch.cuda.empty_cache()

        # DPO from a plain_dpo dataset over the JPEG fixtures
        jpegs = [os.path.basename(p) for p in fixture_jpegs()]
        data = os.path.join(root, "pairs.json")
        with open(data, "w") as f:
            json.dump([{"prompt": f"question {i}: what is shown in the image?",
                        "image": jpegs[i % len(jpegs)],
                        "chosen": f"a dog is sitting on the table {i}",
                        "rejected": f"a red car in the street {i}"} for i in range(4)], f)
        dargs = build_parser().parse_args([
            "dpo", "--device", "cuda", "--model_name_or_path", full, "--dataset_name",
            "plain_dpo", "--data_path", data, "--image_root", FIXTURES, "--max_steps", "2",
            "--per_device_train_batch_size", "1", "--logging_steps", "1", "--output_dir",
            os.path.join(root, "dpo"), "--remat_policy", "attn"])
        run, losses, launches["ckpt_dpo"] = ckpt_dpo(dargs, loader, train_counted)
        batch = batch_to_device(run.collator([run.tokenize_fn(r) for r in run.rows[:1]]), "cuda")
        step_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            run.step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 9 dpo from the checkpoint (plain_dpo, 4 pairs of the JPEG fixtures, "
              f"{batch['input_ids'].shape[1]}-token rows): losses {losses}; step ms "
              f"{[round(x, 3) for x in step_ms]} (phase 6's 1024-token step {dpo_ms:.3f}); "
              f"launches {json.dumps(launches['ckpt_dpo'])}", flush=True)
        del run, batch
        gc.collect()
        torch.cuda.empty_cache()

        # reduced depth, full widths: 2 LM / 2 tower layers
        small = os.path.join(root, "llava-1.5-7b-2layers")
        scfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=2),
                                   vision=dataclasses.replace(cfg.vision, num_layers=2))
        conf = json.loads(json.dumps(LLAVA_15_7B_CONFIG))
        conf["text_config"]["num_hidden_layers"] = conf["vision_config"]["num_hidden_layers"] = 2
        smodel = init_random_(VLM(scfg, "cuda"), torch.Generator(device="cuda").manual_seed(1))
        write_llava_checkpoint(small, smodel.state_dict(), scfg, config=conf)
        del smodel
        qargs = build_parser().parse_args([
            "dpo", "--device", "cuda", "--model_name_or_path", small, "--dataset_name",
            "plain_dpo", "--data_path", data, "--image_root", FIXTURES, "--max_steps", "2",
            "--per_device_train_batch_size", "1", "--logging_steps", "1", "--output_dir",
            os.path.join(root, "qlora"), "--q_lora", "true", "--bits", "4", "--lora_dropout",
            "0"])
        run, qlosses, launches["ckpt_qlora4"] = ckpt_dpo(qargs, loader, train_counted)
        n4 = sum(1 for m in run.model.modules() if getattr(m, "weight_q4", None) is not None)
        print(f"phase 9 QLoRA int4 dpo from the 2-layer checkpoint ({n4} int4 linears): losses "
              f"{qlosses}; launches {json.dumps(launches['ckpt_qlora4'])}", flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()

        mmvet = os.path.join(root, "mmvet.json")
        with open(mmvet, "w") as f:
            json.dump({f"v{i}": {"imagename": jpegs[i % len(jpegs)],
                                 "question": f"what is shown in picture {i}?",
                                 "answer": ["a dog", "a red car", ""][i % 3]}
                       for i in range(6)}, f)
        eargs = build_parser().parse_args([
            "eval", "--device", "cuda", "--model_name_or_path", small, "--judge_model_path",
            small, "--benchmark", "mmvet", "--data_file", mmvet, "--image_root", FIXTURES,
            "--output_dir", os.path.join(root, "eval"), "--max_new_tokens", "16"])
        graded: list = []
        grade = EngineJudge.grade

        def counting_grade(self, rows):
            graded.append(len(rows))
            return grade(self, rows)

        EngineJudge.grade = counting_grade
        try:
            from vlrlhf_torch.cli.main import load_bundle

            _, ecfg, emodel, eproc = load_bundle(eargs, torch.device("cuda"))
            eval_counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention}
            for fn in eval_counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            metrics = run_eval(build_eval(ecfg, emodel, eproc, eargs, loader), eargs,
                               progress=False, judge=load_judge(eargs, torch.device("cuda")))
            eval_s = time.perf_counter() - t0
        finally:
            EngineJudge.grade = grade
        launches["ckpt_eval"] = {k: fn.launches for k, fn in eval_counted.items()}
        if graded != [4]:
            raise AssertionError(f"the judge graded {graded}, want the 4 rows with an answer")
        print(f"phase 9 eval mmvet (2-layer checkpoint, the same checkpoint as its judge): "
              f"{metrics} in {eval_s:.3f} s, the judge's LM graded {graded[0]} rows", flush=True)
        del emodel
        gc.collect()
        torch.cuda.empty_cache()

        merged = os.path.join(root, "merge")
        cli(["merge", "--device", "cuda", "--model_name_or_path", small, "--adapter_path",
             os.path.join(root, "qlora", "adapters"), "--output_dir", merged])
        from vlrlhf_torch.cli.loading import load_model_bundle
        from vlrlhf_torch.lora.lora import merge_lora, set_adapters_

        _, _, base, _ = load_model_bundle(small, device="cuda")
        set_adapters_(base, load_params(os.path.join(root, "qlora", "adapters")))
        state = merge_lora(base, 16.0 / 64)
        set_adapters_(base, None)
        base.load_state_dict(state)
        _, _, back, bproc = load_model_bundle(os.path.join(merged, "merged_hf"), device="cuda")
        same_state(back, base, "merge --export_format hf reloaded vs merged in memory")
        reqs = ckpt_requests(bproc, loader)[:2]
        ids = torch.as_tensor(np.stack([r.input_ids[:64] for r in reqs])).cuda()
        px = torch.as_tensor(np.stack([r.pixel_values for r in reqs]))[:, None].cuda()
        pos = torch.as_tensor(np.stack([r.image_positions for r in reqs])).cuda()
        pos = torch.where(pos < 64, pos, torch.full_like(pos, -1))
        with torch.inference_mode():
            logits = [m.head(m(ids, px, pos, torch.ones_like(ids, dtype=torch.bool))[0])
                      for m in (back, base)]
        if not torch.equal(logits[0], logits[1]) or not torch.isfinite(logits[0]).all():
            raise AssertionError("the reloaded merge's logits differ from the merged model's")
        print(f"phase 9 merge --export_format hf: {len(state)} merged tensors reloaded "
              f"bit-equal; logits on 2 x 64 tokens identical", flush=True)
        del base, back, state
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 9 launches {json.dumps(launches)}; load_batch images/s "
          f"{'not measured' if imgs_per_s is None else round(imgs_per_s, 1)}", flush=True)
    return launches


# phase 10: the sft, rm and ppo trainers
# phase 10b's 8 image prompts: 576 image tokens + the template + these
# words, about 650-690 tokens; with 32 new tokens, rows of about 650-720
# valid tokens in a 768-token batch (phase 2's PPO shapes)
PPO_PROMPT_WORDS = (60, 65, 70, 75, 80, 85, 90, 95)


def trainer_args(**kw):
    """The sft / rm / ppo CLI's arguments as build_sft / build_rm /
    build_ppo, train_steps / train_ppo and finish_run read them: dpo_args
    with 3 steps of 2 rows, no warmup and ppo's flags."""
    base = dict(
        warmup_ratio=0.0, max_steps=3, per_device_train_batch_size=2, run_name=None,
        reward_model_path=None, init_kl_coef=0.2, max_new_tokens=32, ppo_epochs=2,
        minibatch_size=4, rollout_chunk_size=8, rollout_continuous_batching=False,
        use_value_adapter=False, use_score_scaling=False, use_score_norm=False, score_clip=None,
    )
    base.update(kw)
    return dpo_args(**base)


def sft_row(i: int, prompt_words: int, answer_words: int) -> dict:
    """A seeded synthetic SFT row with an image."""
    rng = np.random.default_rng(2000 + i)

    def words(n):
        return " ".join(f"w{int(x)}" for x in rng.integers(16, 31000, n))

    return {"prompt": f"row {i}: {words(prompt_words)}", "img_path": f"sft{i}.png",
            "answer": words(answer_words)}


def ppo_prompt(i: int, words: int, image: bool = True) -> dict:
    rng = np.random.default_rng(3000 + i)
    return {"prompt": f"prompt {i}: " + " ".join(f"w{int(x)}" for x in
                                                  rng.integers(16, 31000, words)),
            "img_path": f"ppo{i}.png" if image else None}


def drop_all_adapters(model) -> None:
    """Detach every adapter, the named sets too."""
    from vlrlhf_torch.models.common import Linear

    drop_adapters(model)
    for m in model.modules():
        if isinstance(m, Linear):
            m.lora_sets.clear()


def grads_of(state) -> torch.Tensor:
    return torch.cat([g.flatten() for g in host_grads(state)])


def compare(what: str, card: dict, host: dict) -> None:
    """Card (bf16, kernels) against CPU (f32, plain) at reduced depth: each
    loss within LOSS_REL_TOL, each stats tensor within LOSS_REL_TOL relative
    (Frobenius), the gradients' cosine at least GRAD_COS_MIN."""
    parts = []
    for k, c in card.items():
        h = host[k]
        if k == "grads":
            cos = float(torch.dot(c.double(), h.double()) / (c.double().norm() * h.double().norm()))
            parts.append(f"gradient cosine {cos:.6f} (min {GRAD_COS_MIN}) over {c.numel()}")
            if not (torch.isfinite(c).all() and cos >= GRAD_COS_MIN):
                raise AssertionError(f"{what}: gradients differ, cosine {cos} < {GRAD_COS_MIN}")
            continue
        c, h = torch.as_tensor(c).double().cpu(), torch.as_tensor(h).double().cpu()
        rel = float((c - h).norm() / h.norm().clamp(min=1e-12))
        parts.append(f"{k} rel err {rel:.3e}" + (f" ({float(c):.6f} vs {float(h):.6f})"
                                                  if c.dim() == 0 else ""))
        if not (torch.isfinite(c).all() and rel <= LOSS_REL_TOL):
            raise AssertionError(f"{what}: {k} differs, rel {rel} > {LOSS_REL_TOL}")
    print(f"reduced-depth {what}: " + "; ".join(parts) + f" (tol {LOSS_REL_TOL})", flush=True)


def phase_reduced_depth_trainers():
    """Phase 10a: sft, rm and ppo steps at full widths, 2 LM / 2 tower
    layers, the same seeded weights and non-zero adapters on the card
    (bf16, kernels) and on the CPU (f32, plain path), on short text rows
    (the CPU's f32 model is slow on 576 image tokens; phase 10b runs the
    tower)."""
    from vlrlhf_torch.cli.main import prompt_row
    from vlrlhf_torch.data.collators import (
        CollatorConfig, GenerationCollator, RMCollator, SFTCollator,
    )
    from vlrlhf_torch.lora.lora import lora_parameters
    from vlrlhf_torch.models.vlm import init_rm_head
    from vlrlhf_torch.train import ppo as tp
    from vlrlhf_torch.train.dpo import adapter_params, batch_to_device
    from vlrlhf_torch.train.rm import RMConfig, rm_step
    from vlrlhf_torch.train.sft import SFTConfig, sft_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    cfg32, cpu, gpu = reduced_depth_models()
    models = {"card": gpu, "host": cpu}
    lcfg = shared_adapters(cpu, gpu)
    proc = make_processor(cfg32)
    ccfg = CollatorConfig(image_size=cfg32.vision.image_size, bucket_multiple=32)
    ocfg = OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0)

    # SFT: one loss and backward
    sft_batch = SFTCollator(proc, ccfg, seeded_image)([proc.tokenize_row_sft(
        {"prompt": "row: " + " ".join(f"w{i}" for i in range(40, 70)), "img_path": None,
         "answer": " ".join(f"w{i}" for i in range(300, 360))})])
    out = {}
    for name, model in models.items():
        state = init_train_state(adapter_params(model), ocfg)
        m = sft_step(model, SFTConfig(lora_scale=lcfg.scale, logits_chunk=256), ocfg, state,
                     batch_to_device(sft_batch, model.device))
        out[name] = {"loss": float(m["loss"]), "grads": grads_of(state)}
    compare(f"SFT (1 row of {sft_batch['input_ids'].shape[1]} tokens)", out["card"], out["host"])

    # RM: step 1 from the zero head is ln 2 on both; step 2's loss and
    # gradients (head and adapters) after one update
    pairs = [{"prompt": f"pair {j}: " + " ".join(f"w{40 * j + i}" for i in range(20)),
              "img_path": None, "chosen": " ".join(f"w{500 + i}" for i in range(30 + j)),
              "rejected": " ".join(f"w{900 + i}" for i in range(20 + 3 * j))} for j in range(2)]
    rm_batch = RMCollator(proc, ccfg, seeded_image)([proc.tokenize_row_dpo(r) for r in pairs])
    out = {}
    for name, model in models.items():
        snap = [p.detach().clone() for p in adapter_params(model)]
        head = init_rm_head(cfg32.lm.hidden_size, model.device)["kernel"]
        state = init_train_state(adapter_params(model) + [head], ocfg)
        tb = batch_to_device(rm_batch, model.device)
        m1 = rm_step(model, RMConfig(lora_scale=lcfg.scale), ocfg, state, head, tb)
        if abs(float(m1["loss"]) - math.log(2.0)) > 1e-6:
            raise AssertionError(f"RM step-1 loss on {name} is {float(m1['loss'])}, not ln 2")
        m2 = rm_step(model, RMConfig(lora_scale=lcfg.scale), ocfg, state, head, tb)
        out[name] = {"loss": float(m2["loss"]), "grads": grads_of(state)}
        with torch.no_grad():  # the PPO checks start from the same adapters again
            for p, s in zip(adapter_params(model), snap):
                p.copy_(s)
    compare(f"RM step 2 (2 pairs of {rm_batch['input_ids'].shape[1]} tokens, step 1 ln 2 on "
            f"both)", out["card"], out["host"])

    # PPO: 4 text prompts with responses of 8, 0 (a first-token stop), 5 and
    # 12 tokens; the stats and one update, without and with value adapters
    pb = GenerationCollator(proc, ccfg, seeded_image)(
        [prompt_row(proc, ppo_prompt(i, 12 + 5 * i, False)) for i in range(4)])
    rng = np.random.default_rng(5)
    tokens = rng.integers(16, 31000, (4, 12)).astype(np.int32)
    batch = tp.rollout_to_batch(pb, tokens, 0, resp_lens=[8, 0, 5, 12])
    scores = (rng.normal(size=4) * 3).astype(np.float32)
    kernel = torch.from_numpy((rng.normal(size=(cfg32.lm.hidden_size, 1)) * 0.01)
                              .astype(np.float32))
    for value_adapters in (False, True):
        if value_adapters:
            shared_adapters(cpu, gpu, tp.VALUE_SET)
        pcfg = tp.PPOConfig(lora_scale=lcfg.scale)
        out = {}
        for name, model in models.items():
            v_head = {"kernel": torch.nn.Parameter(kernel.clone().to(model.device))}
            leaves = adapter_params(model) + [v_head["kernel"]]
            if value_adapters:
                leaves += [p for _, p in lora_parameters(model, tp.VALUE_SET)]
            state = init_train_state(leaves, ocfg)
            tb = batch_to_device(batch, model.device)
            stats = tp.compute_rollout_stats(model, pcfg, v_head, tb,
                                             torch.from_numpy(scores).to(model.device),
                                             pcfg.init_kl_coef, value_adapters)
            m = tp.ppo_update(model, pcfg, ocfg, state, v_head, tb, stats, value_adapters)
            out[name] = {"logprobs": stats.logprobs * stats.response_mask,
                         "values": stats.values, "advantages": stats.advantages,
                         "loss": float(m["ppo/loss/total"]), "grads": grads_of(state)}
        compare(f"PPO stats + update ({'with' if value_adapters else 'without'} value adapters, "
                f"4 rows of {batch['input_ids'].shape[1]} tokens)", out["card"], out["host"])
    del cpu, gpu, models
    gc.collect()
    torch.cuda.empty_cache()


def counted(names=("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention",
                   "chunk_attention", "int4_matmul", "int4_matmul_t")):
    """The wrappers whose launch counts a path reads, by kernel name."""
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from vlrlhf_torch.ops.int4 import int4_matmul, int4_matmul_t

    fns = {"flash_fwd": flash_attention, "flash_bwd_dkv": flash_bwd_dkv,
           "flash_bwd_dq": flash_bwd_dq, "decode_attention": decode_attention,
           "chunk_attention": chunk_attention, "int4_matmul": int4_matmul,
           "int4_matmul_t": int4_matmul_t}
    return {n: fns[n] for n in names}


def zero_counts(fns: dict) -> None:
    for fn in fns.values():
        fn.launches = 0


def read_counts(fns: dict) -> dict:
    return {n: fn.launches for n, fn in fns.items()}


def train_timed(run, args, what: str, launches_out: dict, path: str):
    """cli.main.train_steps over the run's rows (counts zeroed just before,
    read just after); per-step ms from the metrics log's step times."""
    from vlrlhf_torch.cli.main import train_steps
    from vlrlhf_torch.train.metrics import MetricsLogger

    fns = counted()
    logger = MetricsLogger(args.output_dir, what, flops_per_token=run.flops_per_token,
                           flops_per_image=run.flops_per_image)
    zero_counts(fns)
    t0 = time.perf_counter()
    try:
        steps = train_steps(run, args, logger)
    finally:
        logger.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_out[path] = read_counts(fns)
    with open(logger.path) as f:
        recs = [json.loads(line) for line in f]
    return steps, recs, wall


PHASE10_LAYERS = 8  # phase 10b's LM depth, a quarter of LLaVA-1.5-7B's: the script's time limit


def phase_trainers() -> dict:
    """Phase 10b: sft, rm and ppo at full LLaVA-1.5-7B width and
    PHASE10_LAYERS LM layers, seeded random bf16 weights, through
    cli.main's build_* / train_* / finish_run; 10c: ppo --q_lora true
    --bits 4 at 2 LM layers. Returns the launch counts of paths sft, rm,
    ppo and ppo_qlora4."""
    import dataclasses
    import shutil

    from vlrlhf_torch.cli.main import build_ppo, build_rm, build_sft, finish_run, train_ppo
    from vlrlhf_torch.lora.lora import lora_parameters
    from vlrlhf_torch.train.metrics import MetricsLogger
    from vlrlhf_torch.train.ppo import gae_host

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"phase10-{os.getpid()}")
    launches: dict = {}
    try:
        cfg, model, proc = trainer_model(PHASE10_LAYERS)
        model.lm.cfg = dataclasses.replace(model.lm.cfg, remat_policy="attn")

        # sft: 3 steps on 2 image rows of ~1000 tokens
        # 2 rows make one batch an epoch: 3 epochs give 3 steps
        args = trainer_args(output_dir=os.path.join(root, "sft"), num_train_epochs=3.0)
        rows = [sft_row(i, 150, 260) for i in range(2)]
        run = build_sft(cfg, model, proc, args, rows, seeded_image)
        batch = run.collator([run.tokenize_fn(r) for r in rows])
        real = batch["pad_mask"].sum(1).tolist()
        _, recs, wall = train_timed(run, args, "sft", launches, "sft")
        losses = [r["loss"] for r in recs]
        step_ms = [r["perf/step_time_s"] * 1e3 for r in recs if "perf/step_time_s" in r]
        mfu = [r["perf/mfu"] for r in recs if "perf/mfu" in r]
        print(f"phase 10b sft: 2 image rows of {real} tokens padded to "
              f"{batch['input_ids'].shape[1]}, attn remat, logits_chunk 256: losses {losses}; "
              f"step ms {[round(x, 3) for x in step_ms]}; MFU {mfu}; {len(recs)} steps in "
              f"{wall:.1f} s; launches {json.dumps(launches['sft'])}", flush=True)
        if len(recs) != 3 or not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"sft: {recs}")
        del run
        drop_all_adapters(model)

        # rm: 3 steps on 2 image pairs from ln 2; adapters/ saved for ppo
        args = trainer_args(output_dir=os.path.join(root, "rm"), learning_rate=1e-4,
                            num_train_epochs=3.0)
        rows = [pair_row(20 + i, 40, 60 + 10 * i, 50) for i in range(2)]
        run = build_rm(cfg, model, proc, args, rows, seeded_image)
        _, recs, wall = train_timed(run, args, "rm", launches, "rm")
        print(f"phase 10b rm: 2 image pairs: " + "; ".join(
            f"step {r['step']} loss {r['loss']!r} accuracy {r['accuracy']} chosen "
            f"{r['reward/chosen']:.6g} rejected {r['reward/rejected']:.6g} grad_norm "
            f"{r['grad_norm']:.6g}" for r in recs) + f"; {wall:.1f} s; launches "
              f"{json.dumps(launches['rm'])}", flush=True)
        if abs(recs[0]["loss"] - math.log(2.0)) > 1e-6:
            raise AssertionError(f"rm step-1 loss {recs[0]['loss']} is not ln 2 within 1e-6")
        if len(recs) != 3 or not all(np.isfinite(v) for r in recs for v in r.values()):
            raise AssertionError(f"rm: {recs}")
        finish_run(run, args)
        rm_path = os.path.join(args.output_dir, "adapters")
        del run
        drop_all_adapters(model)

        # ppo: 8 image prompts, 32 sampled tokens, the rm above as reward; 2
        # outer steps of static rollouts, a checkpoint, then a resumed third
        # step with continuous rollouts
        torch.cuda.reset_peak_memory_stats()
        args = trainer_args(output_dir=os.path.join(root, "ppo"), reward_model_path=rm_path,
                            per_device_train_batch_size=8, max_steps=2, save_steps=2,
                            logits_chunk=0)
        rows = [ppo_prompt(i, w) for i, w in enumerate(PPO_PROMPT_WORDS)]
        run = build_ppo(cfg, model, proc, args, rows, seeded_image)
        policy = [p for _, p in lora_parameters(model)]
        reward_fn = run.reward_fn
        bit_equal = []

        def reward_checked(tb):
            before = [p.detach().clone() for p in policy]
            out = reward_fn(tb)
            bit_equal.append(all(torch.equal(a, p) for a, p in zip(before, policy)))
            return out

        run.reward_fn = reward_checked
        infos = []
        fns = counted()
        logger = MetricsLogger(args.output_dir, "ppo", flops_per_token=run.flops_per_token,
                               flops_per_image=run.flops_per_image)
        zero_counts(fns)
        try:
            train_ppo(run, proc, args, logger, on_step=lambda s, info: infos.append(info))
            args.rollout_continuous_batching = True
            args.max_steps, args.resume_from_checkpoint = 3, "auto"
            train_ppo(run, proc, args, logger, on_step=lambda s, info: infos.append(info))
        finally:
            logger.close()
        launches["ppo"] = read_counts(fns)
        peak = torch.cuda.max_memory_allocated()
        with open(logger.path) as f:
            recs = [json.loads(line) for line in f]
        ppo_report(recs, infos, bit_equal, launches["ppo"], peak)
        # the host cost of GAE at this run's stats shape (B, L - 1)
        n = infos[0]["shape"][1] - 1
        mask = np.ones((len(rows), n), np.float32)
        deltas = np.random.default_rng(0).normal(size=(len(rows), n)).astype(np.float32)
        t0 = time.perf_counter()
        for _ in range(10):
            gae_host(deltas, mask, 0.95)
        print(f"phase 10b gae_host ({len(rows)} x {n}, f32 numpy on the host): "
              f"{(time.perf_counter() - t0) * 100:.3f} ms a call", flush=True)
        # one profiled outer step (static rollouts)
        args.rollout_continuous_batching = False
        args.max_steps, args.resume_from_checkpoint, args.save_steps = 1, None, 100
        logger = MetricsLogger(os.path.join(root, "ppo_profiled"), "ppo")
        try:
            profile_breakdown(lambda: train_ppo(run, proc, args, logger), "PPO outer step")
        finally:
            logger.close()
        del run, policy, reward_fn
        drop_all_adapters(model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        launches["ppo_qlora4"] = phase_ppo_qlora4(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def ppo_report(recs, infos, bit_equal, launches, peak) -> None:
    """Phase 10b's PPO checks and numbers: no skipped step, every metric
    finite, each step's first minibatch at ratio 1 (within bf16's 1e-2) and
    nothing clipped, the policy adapters bit-equal around each reward
    forward, kernels 1-4 launched."""
    import statistics

    if any("ppo/skipped" in r for r in recs) or len(infos) != 3:
        raise AssertionError(f"a PPO step was skipped: {recs}")
    bad = [(r["step"], k) for r in recs for k, v in r.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite PPO metrics: {bad}")
    first = [info["history"][0] for info in infos]
    devs = [f["ppo/ratio_max_abs_dev"] for f in first]
    clips = [f["ppo/policy/clipfrac"] for f in first]
    if max(devs) > 1e-2 or max(clips) != 0.0:
        raise AssertionError(f"first minibatch ratio deviation {devs} (max 1e-2) or clipfrac "
                             f"{clips} (want 0)")
    if not bit_equal or not all(bit_equal):
        raise AssertionError(f"the policy adapters changed across the reward forward: {bit_equal}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"ppo did not launch {name}: {launches}")
    for i, (r, info) in enumerate(zip(recs, infos)):
        n_mb = len(info["history"])
        print(f"phase 10b ppo step {i + 1} ({'continuous' if i == 2 else 'static'} rollouts): "
              f"resp_lens {info['resp_lens'].tolist()}, rollout {info['rollout_s'] * 1e3:.3f} ms "
              f"({r['ppo/rollout_tok_s']:.1f} tokens/s), reward {info['reward_s'] * 1e3:.3f} ms, "
              f"stats {info['stats_s'] * 1e3:.3f} ms, update {info['update_s'] * 1e3:.3f} ms "
              f"({info['update_s'] * 1e3 / n_mb:.3f} ms per minibatch x {n_mb}), outer step "
              f"{info['step_s'] * 1e3:.3f} ms; first minibatch ratio_max_abs_dev {devs[i]!r} "
              f"clipfrac {clips[i]}; kl {r['ppo/kl']:.6g} mean_score {r['ppo/mean_score']:.6g} "
              f"loss {r['ppo/loss/total']:.6g} grad_norm {r['grad_norm']:.6g}"
              + (f" mfu {r['perf/mfu']:.4f}" if "perf/mfu" in r else ""), flush=True)
    print(f"phase 10b ppo: median outer step "
          f"{statistics.median(i['step_s'] for i in infos) * 1e3:.3f} ms; peak memory "
          f"{peak / 2**30:.3f} GiB; policy adapters bit-equal around {len(bit_equal)} reward "
          f"forwards; launches {json.dumps(launches)}", flush=True)


def phase_ppo_qlora4(root: str) -> dict:
    """Phase 10c: ppo --q_lora true --bits 4 at full widths, 2 LM / 2 tower
    layers (the LM's 14 linears int4 before the adapters attach), the
    synthetic length reward, one outer step of 4 image prompts; kernels 6
    and 7 must launch. Returns its launch counts."""
    import dataclasses

    from vlrlhf_torch.cli.main import build_ppo, train_ppo
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.metrics import MetricsLogger

    full = _llava_7b(torch.bfloat16)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_layers=2,
                                                           remat_policy="attn"),
                              vision=dataclasses.replace(full.vision, num_layers=2))
    model = init_random_(VLM(cfg, "cuda"), torch.Generator(device="cuda").manual_seed(3))
    proc = make_processor(cfg)
    args = trainer_args(output_dir=os.path.join(root, "ppo_qlora4"), q_lora=True, bits=4,
                        synthetic=1, per_device_train_batch_size=4, max_steps=1,
                        max_new_tokens=16, ppo_epochs=1, minibatch_size=0)
    run = build_ppo(cfg, model, proc, args, [ppo_prompt(i, 20) for i in range(4)], seeded_image)
    n4 = sum(1 for m in model.modules() if getattr(m, "weight_q4", None) is not None)
    fns = counted()
    logger = MetricsLogger(args.output_dir, "ppo")
    infos = []
    zero_counts(fns)
    try:
        train_ppo(run, proc, args, logger, on_step=lambda s, info: infos.append(info))
    finally:
        logger.close()
    launches = read_counts(fns)
    with open(logger.path) as f:
        recs = [json.loads(line) for line in f]
    print(f"phase 10c ppo QLoRA int4 (2 LM layers, {n4} int4 linears): {json.dumps(recs)}; "
          f"launches {json.dumps(launches)}", flush=True)
    if n4 != 14 or len(infos) != 1 or any("ppo/skipped" in r for r in recs) or \
            not all(np.isfinite(v) for r in recs for v in r.values()):
        raise AssertionError(f"ppo QLoRA int4: {n4} int4 linears, {recs}")
    if launches["int4_matmul"] <= 0 or launches["int4_matmul_t"] <= 0:
        raise AssertionError(f"ppo QLoRA int4 did not launch kernels 6 and 7: {launches}")
    del run, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ─────────────────────── phase 11: LLaVA-Next and InstructBLIP ───────────────────────


def anyres_image(path, size, mode="shortest_edge_crop"):
    """Image loader of phase 11: in 'raw' mode (the anyres collator's whole
    image) a file name "<tag>_<h>x<w>_<i>.png" gives a seeded (h, w, 3)
    uint8 image of that size; other modes are seeded_image's."""
    if mode != "raw":
        return seeded_image(path, size, mode)
    m = re.search(r"_(\d+)x(\d+)_", os.path.basename(str(path)))
    if m is None:
        raise ValueError(f"{path}: an anyres image name carries its <h>x<w>")
    rng = np.random.default_rng(zlib.crc32(str(path).encode()))
    return rng.integers(0, 256, (int(m.group(1)), int(m.group(2)), 3), dtype=np.uint8)


def qformer_tokenizer(vocab_size: int):
    """A seeded BERT WordPiece tokenizer of `vocab_size` pieces (+ [DEC])
    written under build/ and read by the port's JsonTokenizer, as a
    checkpoint's qformer_tokenizer/ is."""
    import shutil

    from vlrlhf_torch.data.tokenizer import JsonTokenizer
    from vlrlhf_torch.utils.synthetic_checkpoint import write_bert_tokenizer

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"phase11-qtok-{os.getpid()}")
    write_bert_tokenizer(path, vocab_size)
    try:
        return JsonTokenizer(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def family_processor(cfg, qtok=None):
    """make_processor for a phase 11 family, with InstructBLIP's Q-Former
    tokenizer."""
    proc = make_processor(cfg)
    proc.qformer_tokenizer = qtok
    return proc


def family_collator_config(cfg):
    from vlrlhf_torch.data.collators import CollatorConfig

    return CollatorConfig(image_size=cfg.vision.image_size, anyres=bool(cfg.grid_pinpoints),
                          grid_pinpoints=cfg.grid_pinpoints,
                          tile_grid=cfg.vision.image_size // cfg.vision.patch_size)


# phases 11a and 12a's LM depth: the CPU's f32 passes at full width take
# most of their time (the script's time limit)
FAMILY_CHECK_LAYERS = 1


def family_models(family: str, prep=None, image_size: int = 0):
    """(cfg32, cpu, gpu): `family`'s 7B widths at FAMILY_CHECK_LAYERS LM / 2
    tower layers (the Q-Former whole), attn remat, the same seeded weights
    in f32 on the CPU
    and bf16 on the card. `prep(cpu)` adds what a checkpoint holds beyond
    the config (XC2's PLoRA and 24 x 24 table) before the copy;
    `image_size` shrinks the image (and the image token count) where the
    tower takes any patch grid."""
    import dataclasses

    from vlrlhf_torch.cli.main import with_remat_policy
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.vlm import VLM

    full = with_remat_policy(FAMILIES[family].make_config(torch.float32), "attn")
    cfg32 = dataclasses.replace(full, lm=dataclasses.replace(full.lm,
                                                             num_layers=FAMILY_CHECK_LAYERS),
                                vision=dataclasses.replace(full.vision, num_layers=2))
    if image_size:  # a smaller image: fewer image tokens, the same widths
        grid = image_size // cfg32.vision.patch_size
        cfg32 = dataclasses.replace(
            cfg32, vision=dataclasses.replace(cfg32.vision, image_size=image_size),
            num_image_tokens=grid * grid)
    bf = torch.bfloat16
    cfg16 = dataclasses.replace(
        cfg32, lm=dataclasses.replace(cfg32.lm, dtype=bf),
        vision=dataclasses.replace(cfg32.vision, dtype=bf),
        qformer=None if cfg32.qformer is None else dataclasses.replace(cfg32.qformer, dtype=bf))
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    if prep is not None:
        prep(cpu)
    gpu = VLM(cfg16, "cuda")
    like_layout_(cpu, gpu)
    gpu.load_state_dict(cpu.state_dict())
    return cfg32, cpu, gpu


def like_layout_(src, dst) -> None:
    """Give `dst` the PLoRA leaves and position-table shape `src` holds,
    so load_state_dict can copy them."""
    from vlrlhf_torch.models.common import Linear

    if dst.vision.pos_embed.shape != src.vision.pos_embed.shape:
        dst.vision.set_pos_embed_(torch.empty(src.vision.pos_embed.shape, device=dst.device))
    mods = dict(dst.named_modules())
    for name, mod in src.named_modules():
        if isinstance(mod, Linear) and mod.plora_a is not None:
            dt = dst.cfg.lm.dtype
            mods[name].set_plora_(torch.empty(mod.plora_a.shape, device=dst.device, dtype=dt),
                                  torch.empty(mod.plora_b.shape, device=dst.device, dtype=dt))


def card_vs_cpu_logits(cpu, gpu, batch, label: str) -> float:
    """Image prefill + 8 greedy tokens of every row of `batch` on both
    models: last-prompt logits within LOGIT_REL_TOL, each row's first token
    equal where its margin exceeds twice the error. Returns the max abs
    logit error."""
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device, prefill
    from vlrlhf_torch.models.vlm import image_inputs

    gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    logits, tokens = {}, {}
    with torch.inference_mode():
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            cache_len = -(-(t["input_ids"].shape[1] + 8) // 128) * 128
            *_, last = prefill(model, gen_cfg, cache_len, t["input_ids"], t["pad_mask"],
                               t["prompt_lens"], t["pixel_values"], t["image_positions"], None,
                               **image_inputs(t))
            logits[name] = last.float().cpu()
            tokens[name] = Generator(model, gen_cfg)(batch).cpu().tolist()
    ref, got = logits["cpu"], logits["cuda"]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: logits on the card are not finite")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    agree = [sum(int(a == b) for a, b in zip(c, h))
             for c, h in zip(tokens["cuda"], tokens["cpu"])]
    print(f"{label} (2 LM / 2 tower layers, full widths, {len(agree)} prompts of "
          f"{batch['prompt_lens'].tolist()} tokens): logit max_abs_err={err:.4e} rel={rel:.3e} "
          f"(tol {LOGIT_REL_TOL}); greedy tokens agree {agree} of 8; cuda {tokens['cuda']} cpu "
          f"{tokens['cpu']}", flush=True)
    if rel > LOGIT_REL_TOL:
        raise AssertionError(f"{label}: logits differ: rel {rel} > {LOGIT_REL_TOL}")
    for row in range(len(agree)):
        top2 = torch.topk(ref[row], 2).values
        if float(top2[0] - top2[1]) > 2 * err and tokens["cuda"][row][0] != tokens["cpu"][row][0]:
            raise AssertionError(f"{label}: row {row}'s first greedy token differs though its "
                                 "margin exceeds the error")
    return err


def card_vs_cpu_dpo(cpu, gpu, batch, dcfg, label: str, counts=None):
    """One DPO loss + backward on both models (adapters already shared):
    loss within LOSS_REL_TOL, LoRA gradient cosine at least GRAD_COS_MIN.
    `counts` (counted() wrappers) are zeroed before the card's step and
    read after it; returns those launches (None without `counts`)."""
    from vlrlhf_torch.train.dpo import adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    ocfg = OptimizerConfig(learning_rate=1e-5)
    loss, grads, launches = {}, {}, None
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        state = init_train_state(adapter_params(model), ocfg)
        if counts is not None and name == "cuda":
            zero_counts(counts)
        m = dpo_step(model, dcfg, ocfg, state, batch_to_device(batch, model.device))
        loss[name] = float(m["loss"])
        if counts is not None and name == "cuda":
            launches = read_counts(counts)
        grads[name] = torch.cat([p.grad.float().flatten().cpu() for p in state.trainable])
    g, r = grads["cuda"], grads["cpu"]
    if not (np.isfinite(loss["cuda"]) and torch.isfinite(g).all()):
        raise AssertionError(f"{label} on the card is not finite")
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    cos = float(torch.dot(g.double(), r.double()) / (g.double().norm() * r.double().norm()))
    print(f"{label} (2 LM / 2 tower layers, full widths, 1 pair of {batch['input_ids'].shape[1]} "
          f"tokens): loss cuda {loss['cuda']:.6f} cpu {loss['cpu']:.6f} rel err {rel:.3e} (tol "
          f"{LOSS_REL_TOL}); LoRA gradient cosine {cos:.6f} (min {GRAD_COS_MIN}) over "
          f"{g.numel()} entries" + (f"; launches {json.dumps(launches)}" if launches else ""),
          flush=True)
    if rel > LOSS_REL_TOL:
        raise AssertionError(f"{label}: loss differs: rel {rel} > {LOSS_REL_TOL}")
    if cos < GRAD_COS_MIN:
        raise AssertionError(f"{label}: LoRA gradients differ: cosine {cos} < {GRAD_COS_MIN}")
    return launches


def phase_families_reduced_depth() -> None:
    """Phase 11a: llava_next_mistral and instructblip at FAMILY_CHECK_LAYERS
    LM / 2 tower layers, full widths, card bf16 against CPU f32: two image
    prompts'
    logits and 8 greedy tokens in one batch (anyres images of 336 x 336 and
    336 x 672, 3 tiles each but plans of 1,176 and 1,752 tokens, so one row
    is padded; Q-Former instructions of two lengths), one DPO pair's loss
    and LoRA gradients; then
    InstructBLIP with an unfrozen tower and LoRA on its attention (the
    D = 88 backward kernels) and LLaVA-Next mistral int4 with --fuse_decode
    (kernel 6 on the fused GQA wqkv, N = 4096 + 1024 + 1024)."""
    from vlrlhf_torch.data.collators import DPOCollator, GenerationCollator
    from vlrlhf_torch.train.dpo import DPOConfig

    for family in ("llava_next_mistral", "instructblip"):
        t0 = time.perf_counter()
        cfg32, cpu, gpu = family_models(family)
        qtok = qformer_tokenizer(cfg32.qformer.vocab_size - 1) if cfg32.qformer else None
        proc = family_processor(cfg32, qtok)
        ccfg = family_collator_config(cfg32)
        batch = GenerationCollator(proc, ccfg, anyres_image)(
            [proc.generation_row("describe the picture in detail", "r11_336x336_0.png"),
             proc.generation_row("what is on the left side of this wide picture?",
                                 "r11_336x672_1.png")])
        if family == "instructblip" and batch["qformer_mask"].all():
            raise AssertionError("the InstructBLIP batch should pad one row's Q-Former ids")
        if family != "instructblip" and not (batch["anyres_gather"][0] == -2).any():
            raise AssertionError("the anyres batch should pad its first row's gather map")
        card_vs_cpu_logits(cpu, gpu, batch, f"reduced-depth {family} serving")
        lcfg = shared_adapters(cpu, gpu)
        dbatch = DPOCollator(proc, ccfg, anyres_image)([proc.tokenize_row_dpo(
            dict(pair_row(0, 12, 40, 30), img_path="p11_336x336_0.png"))])
        dcfg = DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=256)
        card_vs_cpu_dpo(cpu, gpu, dbatch, dcfg, f"reduced-depth {family} DPO")
        if family == "instructblip":
            drop_adapters(cpu)
            drop_adapters(gpu)
            lcfg = shared_adapters(cpu, gpu, patterns=(
                r"lm/.*attn/(wq|wk|wv|wo)/", r"vision/.*attn/(wq|wk|wv|wo)/"))
            counts = counted(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
            launches = card_vs_cpu_dpo(
                cpu, gpu, dbatch, DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=256,
                                            frozen_vision=False),
                "reduced-depth instructblip DPO, unfrozen EVA tower (D = 88)", counts)
            # policy backward: the LM's layers and the tower's 2 (the
            # reference forward runs under no_grad)
            want = cfg32.lm.num_layers + cfg32.vision.layers_run
            if min(launches["flash_bwd_dkv"], launches["flash_bwd_dq"]) < want:
                raise AssertionError(f"the unfrozen tower's backward kernels did not all run: "
                                     f"{launches}, want >= {want} each")
        else:
            drop_adapters(cpu)
            drop_adapters(gpu)
            reduced_depth_int4(cpu, gpu, batch, f" {family} (fused GQA wqkv)")
        print(f"phase 11a {family}: {time.perf_counter() - t0:.1f} s", flush=True)
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()


def serve_family(cfg, model, proc, args, bodies: list, what: str, loader) -> tuple:
    """Serve `bodies` at once over HTTP through cli.main.build_server; the
    kernel counts zeroed just before, read just after. Returns (launches,
    results, wall s, engine stats, TTFT ms of a lone 1-token request)."""
    from vlrlhf_torch.cli.main import build_server

    httpd, srv = build_server(cfg, model, proc, args, loader)
    engine = srv.engine
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    fns = counted(("flash_fwd", "decode_attention", "chunk_attention"))
    try:
        zero_counts(fns)
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        launches = read_counts(fns)
        stats = {"admits": engine.last_admits, "bursts": engine.last_bursts,
                 "decode_steps": engine.last_decode_steps,
                 "verify_steps": engine.last_verify_steps, "cache_len": engine.cache_len}
        ttft = []
        for _ in range(3):  # an idle server: admit, prefill, first token, reply
            t1 = time.perf_counter()
            post_json(url + "/generate", dict(bodies[0], max_new_tokens=1))
            ttft.append((time.perf_counter() - t1) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError(f"{what}: server threads did not stop")
    tokens = [r.get("tokens") for r in results]
    print(f"{what}: {len(bodies)} /generate requests in {wall:.3f} s, {sum(tokens)} tokens "
          f"({sum(tokens) / wall:.2f} tokens/s; per request {tokens}); engine "
          f"{json.dumps(stats)}; launches {json.dumps(launches)}; TTFT (idle server, one "
          f"1-token request) {[round(x, 3) for x in ttft]} ms", flush=True)
    if launches["flash_fwd"] < stats["admits"] * (cfg.vision.layers_run + cfg.lm.num_layers):
        raise AssertionError(f"{what}: too few flash launches: {launches}")
    if stats["decode_steps"] and launches["decode_attention"] < cfg.lm.num_layers * \
            stats["decode_steps"]:
        raise AssertionError(f"{what}: too few decode launches: {launches}")
    return launches, results, wall, stats, sorted(ttft)[1]


def family_dpo(cfg, model, proc, rows, loader, what: str, pad_to: int = 0, steps: int = 3,
               profile: bool = False):
    """cli.main.build_dpo on `rows` (precomputed reference logps, attn
    remat, logits_chunk 256), `steps` steps with their counts, step-1 loss
    ln 2 within 1e-3, then 3 timed steps (and with `profile` one profiled
    step): (launches, {median ms, MFU, peak GiB, seq})."""
    import statistics

    from vlrlhf_torch.cli.main import build_dpo
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.flops import dpo_flops_per_token, vision_flops_per_image
    from vlrlhf_torch.train.loop import read_metrics

    torch.cuda.reset_peak_memory_stats()
    run = build_dpo(cfg, model, proc, dpo_args(max_length=1024), rows, loader)
    if pad_to:
        run.collator.cfg.pad_to = pad_to
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    real = batch_np["pad_mask"].sum(1).tolist()
    batch = batch_to_device(batch_np, "cuda")
    fns = counted(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    zero_counts(fns)
    losses = [read_metrics(run.step(batch))["loss"] for _ in range(steps)]
    launches = read_counts(fns)
    if abs(losses[0] - math.log(2.0)) > 1e-3 or not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: step-1 loss {losses[0]} is not ln 2 within 1e-3, or a "
                             f"loss is not finite: {losses}")
    if min(launches["flash_bwd_dkv"], launches["flash_bwd_dq"]) < cfg.lm.num_layers * steps:
        raise AssertionError(f"{what}: too few backward launches: {launches}")
    step_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        m = run.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    if not np.isfinite(read_metrics(m)["loss"]):
        raise AssertionError(f"{what}: a timed step's loss is not finite")
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_breakdown(lambda: run.step(batch), f"{what} step")
    med = statistics.median(step_ms)
    s = batch_np["input_ids"].shape[1]
    tokens = int(np.prod(batch_np["input_ids"].shape))
    images = int(np.prod(batch_np["pixel_values"].shape[:2]))  # pairs x (images | tiles)
    flops = (dpo_flops_per_token(cfg, s, ref_forward=False) * tokens
             + vision_flops_per_image(cfg.vision) * images)
    mfu = flops / (med * 1e-3) / PEAK_FLOPS
    print(f"{what}: 1 pair, rows of {real} real tokens padded to {s}, {images} tower images; "
          f"steps 1-{steps} loss {losses}; launches {json.dumps(launches)}; step median "
          f"{med:.3f} ms {[round(x, 3) for x in step_ms]}, {tokens / (med * 1e-3):.1f} tokens/s, "
          f"MFU {mfu:.4f} ({flops / 1e12:.3f} TFLOP per step, train/flops.py); peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del run, batch
    drop_adapters(model)
    return launches, {"median_ms": med, "mfu": mfu, "peak_gib": peak / 2**30, "seq": s}


def phase_llava_next() -> dict:
    """Phase 11b: full-width, full-depth LLaVA-Next mistral 7B (seeded random
    bf16 weights): 8 anyres image prompts of mixed aspect ratios served over
    HTTP (8 slots, 32 greedy tokens), one DPO pair with an anyres image
    padded to 4096 tokens, then the same model served with --quantize int8
    --kv_cache_dtype int8 --speculative_k 3. Returns the launch counts by
    path."""
    from vlrlhf_torch.cli.main import with_remat_policy
    from vlrlhf_torch.models.anyres import anyres_plan
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_next_mistral_7b
    from vlrlhf_torch.models.vlm import VLM

    torch.cuda.reset_peak_memory_stats()
    cfg = with_remat_policy(_llava_next_mistral_7b(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    proc = family_processor(cfg)
    plans = {hw: anyres_plan(hw, cfg.grid_pinpoints)["n_tokens"] for hw in ANYRES_SIZES}
    print(f"full-width LLaVA-Next mistral 7B: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
          f" B params bf16, init {time.perf_counter() - t0:.1f} s; anyres image tokens by "
          f"(h, w): {plans}", flush=True)
    bodies = [{"question": f"request {i}: what does this image show? answer in detail",
               "image": f"any_{h}x{w}_{i}.png", "max_new_tokens": 32}
              for i, (h, w) in enumerate(ANYRES_SIZES)]
    serve_l, _, _, stats, ttft = serve_family(cfg, model, proc, serve_args(), bodies,
                                              "phase 11b LLaVA-Next mistral bf16 serve",
                                              anyres_image)
    if stats["cache_len"] < max(plans.values()) + 32:
        raise AssertionError(f"the serving cache ({stats['cache_len']}) cannot hold an anyres "
                             "prompt")
    pair = dict(pair_row(11, 300, 640, 600), img_path="dpo_672x672_0.png")
    dpo_l, dpo_stats = family_dpo(cfg, model, proc, [pair], anyres_image,
                                  "phase 11b LLaVA-Next mistral DPO (anyres pair)", pad_to=4096,
                                  profile=True)
    if dpo_stats["seq"] != 4096:
        raise AssertionError(f"the anyres DPO pair is not padded to 4096: {dpo_stats}")
    spec_bodies = [{"question": echo_question(i), "image": f"any_{h}x{w}_{i}.png",
                    "max_new_tokens": 32} for i, (h, w) in enumerate(ANYRES_SIZES)]
    spec_l, _, _, spec_stats, _ = serve_family(
        cfg, model, proc, serve_args(quantize="int8", kv_cache_dtype="int8", speculative_k=3),
        spec_bodies, "phase 11b LLaVA-Next mistral int8 --speculative_k 3 serve", anyres_image)
    if spec_l["chunk_attention"] <= 0:
        raise AssertionError(f"the speculative serve ran no verify chunks: {spec_l}")
    print(f"phase 11b summary: TTFT {ttft:.3f} ms (bf16), DPO step {dpo_stats['median_ms']:.3f} "
          f"ms MFU {dpo_stats['mfu']:.4f} peak {dpo_stats['peak_gib']:.3f} GiB; "
          f"peak memory of the phase {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"next_serve": serve_l, "next_dpo": dpo_l, "next_serve_int8_spec": spec_l}


def phase_instructblip() -> dict:
    """Phase 11c: full-width, full-depth InstructBLIP-Vicuna-7B (seeded
    random bf16 weights, a seeded WordPiece Q-Former tokenizer): 8 image
    prompts served over HTTP with their Q-Former ids, one DPO pair whose
    frozen-tower features take the pair's instruction, one CE eval batch of
    16 rows. Returns the launch counts by path."""
    from vlrlhf_torch.cli.main import build_eval, with_remat_policy
    from vlrlhf_torch.generate.server import RequestBuilder
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _instructblip_vicuna_7b
    from vlrlhf_torch.models.vlm import VLM

    torch.cuda.reset_peak_memory_stats()
    cfg = with_remat_policy(_instructblip_vicuna_7b(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    proc = family_processor(cfg, qformer_tokenizer(cfg.qformer.vocab_size - 1))
    print(f"full-width InstructBLIP-Vicuna-7B: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    req = RequestBuilder(proc, family_collator_config(cfg), seeded_image).build(
        "what is in the image?", "q.png")
    if req.qformer_input_ids is None or req.input_ids[0] != proc.cfg.image_token_id:
        raise AssertionError("an InstructBLIP request lacks its Q-Former ids or image prefix")
    bodies = [{"question": f"request {i}: what does this image show? answer in detail",
               "image": f"blip{i}.png", "max_new_tokens": 32} for i in range(8)]
    serve_l, _, _, _, ttft = serve_family(cfg, model, proc, serve_args(), bodies,
                                          "phase 11c InstructBLIP bf16 serve", seeded_image)
    pair = pair_row(12, 150, 260, 250)
    dpo_l, dpo_stats = family_dpo(cfg, model, proc, [pair], seeded_image,
                                  "phase 11c InstructBLIP DPO (frozen tower, per-pair Q-Former)")
    runner = build_eval(cfg, model, proc, eval_args(), seeded_image)
    rows = [{"question": f"question {i}: is there a dog in the picture?",
             "answer": ("yes", "no", "a dog", "two cats")[i % 4], "img": f"ce{i // 4}.png"}
            for i in range(16)]
    fns = counted(("flash_fwd",))
    zero_counts(fns)
    t1 = time.perf_counter()
    out = runner.run_vqa_ppl(rows, batch_size=16)
    ce_s = time.perf_counter() - t1
    ce_l = read_counts(fns)
    ppl = [r["ppl"] for r in out]
    print(f"phase 11c InstructBLIP CE ranking: 16 rows in {ce_s * 1e3:.3f} ms "
          f"({16 / ce_s:.2f} rows/s), ppl {[round(x, 4) for x in ppl]}; launches "
          f"{json.dumps(ce_l)}", flush=True)
    if not all(np.isfinite(ppl)) or ce_l["flash_fwd"] < cfg.vision.layers_run + cfg.lm.num_layers:
        raise AssertionError(f"CE ranking: non-finite ppl or too few launches: {ppl} {ce_l}")
    print(f"phase 11c summary: TTFT {ttft:.3f} ms, DPO step {dpo_stats['median_ms']:.3f} ms MFU "
          f"{dpo_stats['mfu']:.4f} peak {dpo_stats['peak_gib']:.3f} GiB; peak memory of the "
          f"phase {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del model, runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"blip_serve": serve_l, "blip_dpo": dpo_l, "blip_eval": ce_l}


# ───────────── phase 12: the Qwen-VL and InternLM-XC2 families ─────────────

XC2_TABLE_GRID = 24  # CLIP-L/14-336's position grid, resized to 35 x 35 at 490 px
XC2_PLORA_R = 256  # the released checkpoint's PLoRA rank on its seven LM linears


def xc2_checkpoint_layout_(model, seed: int = 5, r: int = XC2_PLORA_R) -> None:
    """What an XC2 checkpoint holds beyond the family config: the tower's
    24 x 24 (+ class) table, which the forward resizes, and seeded r-rank
    PLoRA on every LM layer's seven linears (lora.init_plora_)."""
    from vlrlhf_torch.lora.lora import init_plora_

    gen = torch.Generator(device=model.device).manual_seed(seed)
    h = model.cfg.vision.hidden_size
    model.vision.set_pos_embed_(
        (torch.randn((XC2_TABLE_GRID**2 + 1, h), generator=gen, device=model.device) * 0.02))
    init_plora_(model, r, gen)


def word_text(rng, n: int) -> str:
    """`n` seeded English words (the synthetic vocabularies are built from
    them, as a trained one would cover them)."""
    from vlrlhf_torch.utils.synthetic_checkpoint import _WORDS

    return " ".join(rng.choice(_WORDS, n))


def word_pair(i: int, prompt_words: int, chosen_words: int, rejected_words: int) -> dict:
    """A seeded preference pair of English words with an image."""
    rng = np.random.default_rng(2000 + i)
    return {"prompt": f"pair {i}: {word_text(rng, prompt_words)}", "img_path": f"wpair{i}.png",
            "chosen": word_text(rng, chosen_words), "rejected": word_text(rng, rejected_words)}


def family_tokenizer(family: str):
    """`family`'s seeded tokenizer in its published layout (Qwen-VL's full
    151,643-rank qwen.tiktoken, XC2's 92,544-piece sentencepiece
    tokenizer.model), written under build/ and read back by
    data/tokenizer.load_tokenizer."""
    import shutil

    from vlrlhf_torch.data.tokenizer import load_tokenizer
    from vlrlhf_torch.utils.synthetic_checkpoint import write_family_tokenizer

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"phase12-tok-{family}-{os.getpid()}")
    t0 = time.perf_counter()
    write_family_tokenizer(path, family)
    try:
        tok = load_tokenizer(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    print(f"{family} tokenizer: {type(tok).__name__}, {tok.vocab_size} tokens, written and read "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return tok


def family12_processor(cfg, tok, max_length: int = 1024, max_prompt_length: int = 512):
    """(cfg, processor) as cli.loading.load_model_bundle builds them: Qwen's
    <imgpad> placeholder inside "Picture 1: <img>...</img>", XC2's
    <ImageHere> added to the tokenizer as the image token."""
    import dataclasses

    from vlrlhf_torch.cli.loading import make_processor as bundle_processor
    from vlrlhf_torch.models.config import FAMILIES

    over = {"image_token": "<imgpad>"} if cfg.family == "qwen_vl" else {}
    if cfg.family == "internlm_xc2":
        cfg = dataclasses.replace(cfg, image_token_id=tok.add_special_token("<ImageHere>"))
    return cfg, bundle_processor(FAMILIES[cfg.family], tok, cfg, max_length=max_length,
                                 max_prompt_length=max_prompt_length, **over)


def plora_control(cpu, gpu, batch, err: float) -> None:
    """PLoRA is on: the card's last-prompt logits with every PLoRA b zeroed
    must move past the card-vs-CPU tolerance, and back when restored."""
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill
    from vlrlhf_torch.models.common import Linear

    gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)

    def last_logits():
        t = batch_to_device(batch, "cuda")
        cache_len = -(-(t["input_ids"].shape[1] + 8) // 128) * 128
        with torch.inference_mode():
            *_, last = prefill(gpu, gen_cfg, cache_len, t["input_ids"], t["pad_mask"],
                               t["prompt_lens"], t["pixel_values"], t["image_positions"], None)
        return last.float().cpu()

    held = [(m, m.plora_b) for m in gpu.modules() if isinstance(m, Linear) and m.plora_b is not None]
    with_plora = last_logits()
    for m, b in held:
        m.plora_b = torch.nn.Parameter(torch.zeros_like(b), requires_grad=False)
    without = last_logits()
    for m, b in held:
        m.plora_b = b
    moved = float((with_plora - without).abs().max()) / float(with_plora.abs().max())
    print(f"phase 12a internlm_xc2 PLoRA control: {len(held)} PLoRA linears; the card's logits "
          f"with PLoRA zeroed move by rel {moved:.3e} (must exceed {LOGIT_REL_TOL}; the "
          f"card-vs-CPU max abs error was {err:.4e})", flush=True)
    if moved <= LOGIT_REL_TOL:
        raise AssertionError(f"PLoRA does not act: zeroing it moves the logits by {moved}")


def phase_families12_reduced_depth() -> dict:
    """Phase 12a: qwen_vl and internlm_xc2 at their 7B widths but
    FAMILY_CHECK_LAYERS LM / 2 tower layers, card bf16 against CPU f32 on
    the same seeded weights (XC2
    with a 24 x 24 table and r = 256 PLoRA, its images at 224 px so the
    CPU's rows stay short): two image prompts of different
    lengths in one batch (logits, 8 greedy tokens), one DPO pair's loss and
    LoRA gradients; for XC2 the PLoRA control and a QLoRA int4 DPO step
    (kernel 7); then int4 --fuse_decode against unfused and the CPU
    (Qwen's biased fused wqkv, XC2's GQA wqkv under PLoRA). Returns the
    card's int4 launches by path (the XC2 QLoRA step, each family's int4
    serving)."""
    from vlrlhf_torch.data.collators import CollatorConfig, DPOCollator, GenerationCollator
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.ops.quant import TRAIN_QUANT_PATTERNS
    from vlrlhf_torch.train.dpo import DPOConfig

    paths = {}
    for family in ("qwen_vl", "internlm_xc2"):
        t0 = time.perf_counter()
        xc2 = family == "internlm_xc2"
        # XC2 at 224 px (256 image tokens, its 24 x 24 table resized to 16 x
        # 16): the CPU's f32 passes over ~1,700-token rows cost minutes
        cfg32, cpu, gpu = family_models(family, xc2_checkpoint_layout_ if xc2 else None,
                                        224 if xc2 else 0)
        cfg32, proc = family12_processor(cfg32, family_tokenizer(family), 2048, 1600)
        ccfg = CollatorConfig(image_size=cfg32.vision.image_size, resize_mode="squash")
        batch = GenerationCollator(proc, ccfg, seeded_image)(
            [proc.generation_row("describe the picture in detail", "r12_0.png"),
             proc.generation_row("what is on the left side of this picture, and what colour "
                                 "is the object in its middle?", "r12_1.png")])
        if batch["pad_mask"].all():
            raise AssertionError("phase 12a's batch should pad one row")
        err = card_vs_cpu_logits(cpu, gpu, batch, f"reduced-depth {family} serving")
        print(f"phase 12a {family} serving checked at {time.perf_counter() - t0:.1f} s",
              flush=True)
        if xc2:
            plora_control(cpu, gpu, batch, err)
        targets = FAMILIES[family].lora_targets
        lcfg = shared_adapters(cpu, gpu, patterns=targets)
        dbatch = DPOCollator(proc, ccfg, seeded_image)([proc.tokenize_row_dpo(
            word_pair(0, 12, 40, 30))])
        dcfg = DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=256)
        card_vs_cpu_dpo(cpu, gpu, dbatch, dcfg, f"reduced-depth {family} DPO")
        print(f"phase 12a {family} DPO checked at {time.perf_counter() - t0:.1f} s", flush=True)
        drop_adapters(cpu)
        drop_adapters(gpu)
        if xc2:
            if share_int4(cpu, gpu, TRAIN_QUANT_PATTERNS,
                          "reduced-depth XC2 QLoRA int4") != 7 * cfg32.lm.num_layers:
                raise AssertionError(f"expected the 7 LM linears of each of "
                                     f"{cfg32.lm.num_layers} layers int4")
            lcfg = shared_adapters(cpu, gpu, patterns=targets)
            counts = counted(("int4_matmul", "int4_matmul_t"))
            launches = card_vs_cpu_dpo(
                cpu, gpu, dbatch, DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=256),
                "reduced-depth internlm_xc2 QLoRA int4 DPO (PLoRA on int4 bases)", counts)
            if min(launches.values()) <= 0:
                raise AssertionError(f"the XC2 QLoRA step did not launch kernels 6 and 7: "
                                     f"{launches}")
            paths["xc2_qlora4_reduced"] = launches
            print(f"phase 12a QLoRA checked at {time.perf_counter() - t0:.1f} s", flush=True)
            drop_adapters(cpu)
            drop_adapters(gpu)
        counts = counted(("int4_matmul",))
        zero_counts(counts)
        reduced_depth_int4(cpu, gpu, batch, f" {family} (fused wqkv"
                           + (", PLoRA)" if xc2 else " with biases)"), tie_rule=True, head=False)
        paths[f"{family.split('_')[0]}_int4_reduced"] = read_counts(counts)
        print(f"phase 12a {family}: {time.perf_counter() - t0:.1f} s; int4 launches "
              f"{json.dumps(paths)}", flush=True)
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def tower_launches(model, image_size: int) -> dict:
    """Kernel-1 launches of one encode_images call on 2 images: the tower's
    layers, plus the resampler's one for Qwen-VL."""
    fns = counted(("flash_fwd",))
    px = torch.from_numpy(np.stack([seeded_image(f"t{i}.png", image_size) for i in range(2)]))
    zero_counts(fns)
    with torch.inference_mode():
        model.encode_images(px.cuda())
    return read_counts(fns)


def family12_model(family: str):
    """Full-width, full-depth `family` with seeded random bf16 weights on the
    card (XC2 with its checkpoint layout), attn remat."""
    from vlrlhf_torch.cli.main import with_remat_policy
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.vlm import VLM

    cfg = with_remat_policy(FAMILIES[family].make_config(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    if family == "internlm_xc2":
        xc2_checkpoint_layout_(model)
    torch.cuda.synchronize()
    print(f"full-width {family}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, model


def phase_qwen_vl() -> dict:
    """Phase 12b: full-width, full-depth Qwen-VL-Chat (seeded random bf16
    weights, the full-size qwen.tiktoken): 8 concurrent 448 x 448 image
    requests of ~300-token ChatML prompts over HTTP (8 slots, 32 greedy
    tokens), one DPO pair padded to 1024 (attn remat, r64 LoRA on
    QWEN_TARGETS), then --quantize int8 --kv_cache_dtype int8
    --speculative_k 3. Returns the launch counts by path."""
    torch.cuda.reset_peak_memory_stats()
    cfg, model = family12_model("qwen_vl")
    cfg, proc = family12_processor(cfg, family_tokenizer("qwen_vl"))
    tl = tower_launches(model, cfg.vision.image_size)
    print(f"phase 12b Qwen-VL encode_images of 2 images: launches {json.dumps(tl)} (the tower's "
          f"{cfg.vision.layers_run} layers + the resampler's 1)", flush=True)
    if tl["flash_fwd"] != cfg.vision.layers_run + 1:
        raise AssertionError(f"the tower and resampler should launch kernel 1 "
                             f"{cfg.vision.layers_run + 1} times: {tl}")
    rng = np.random.default_rng(12)
    bodies = [{"question": f"request {i}: {word_text(rng, 16)}", "image": f"qwen{i}.png",
               "max_new_tokens": 32} for i in range(8)]
    n_prompt = len(proc.generation_row(bodies[0]["question"], "x.png")["input_ids"]) - 1 + \
        cfg.num_image_tokens + 2
    print(f"phase 12b prompt: {n_prompt} tokens with the image span", flush=True)
    serve_l, _, _, _, ttft = serve_family(cfg, model, proc, serve_args(), bodies,
                                          "phase 12b Qwen-VL-Chat bf16 serve", seeded_image)
    pair = word_pair(13, 40, 170, 150)
    dpo_l, dpo_stats = family_dpo(cfg, model, proc, [pair], seeded_image,
                                  "phase 12b Qwen-VL-Chat DPO (QWEN_TARGETS)", pad_to=1024)
    spec_bodies = [{"question": echo_question(i), "image": f"qwen{i}.png",
                    "max_new_tokens": 32} for i in range(8)]
    spec_l, _, _, _, _ = serve_family(
        cfg, model, proc, serve_args(quantize="int8", kv_cache_dtype="int8", speculative_k=3),
        spec_bodies, "phase 12b Qwen-VL-Chat int8 --speculative_k 3 serve", seeded_image)
    if spec_l["chunk_attention"] <= 0:
        raise AssertionError(f"the speculative serve ran no verify chunks: {spec_l}")
    print(f"phase 12b summary: prompt {n_prompt} tokens, TTFT {ttft:.3f} ms (bf16), DPO step "
          f"{dpo_stats['median_ms']:.3f} ms MFU {dpo_stats['mfu']:.4f} peak "
          f"{dpo_stats['peak_gib']:.3f} GiB; peak memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"qwen_serve": serve_l, "qwen_dpo": dpo_l, "qwen_serve_int8_spec": spec_l}


def phase_internlm_xc2() -> dict:
    """Phase 12c: full-width, full-depth InternLM-XComposer2-VL-7B (seeded
    random bf16 weights, r = 256 PLoRA on all seven LM linears, the 24 x 24
    table resized to 35 x 35, the 92,544-piece tokenizer.model): 8
    concurrent 490 x 490 image requests (1,225 image tokens, ~1,400-token
    prompts, a cache of at least 1,532 slots), one DPO pair padded to 2048
    with PLoRA and trainable LoRA together, CE ranking on 16 rows through
    build_eval. Returns the launch counts by path."""
    from vlrlhf_torch.cli.main import build_eval

    torch.cuda.reset_peak_memory_stats()
    cfg, model = family12_model("internlm_xc2")
    cfg, proc = family12_processor(cfg, family_tokenizer("internlm_xc2"), 2048, 1800)
    tl = tower_launches(model, cfg.vision.image_size)
    print(f"phase 12c XC2 encode_images of 2 images: launches {json.dumps(tl)}", flush=True)
    if tl["flash_fwd"] != cfg.vision.layers_run:
        raise AssertionError(f"the XC2 tower should launch kernel 1 {cfg.vision.layers_run} "
                             f"times: {tl}")
    rng = np.random.default_rng(13)
    bodies = [{"question": f"request {i}: {word_text(rng, 12)}", "image": f"xc{i}.png",
               "max_new_tokens": 32} for i in range(8)]
    n_prompt = len(proc.generation_row(bodies[0]["question"], "x.png")["input_ids"]) - 1 + \
        cfg.num_image_tokens
    args = serve_args(max_length=1792)
    print(f"phase 12c prompt: {n_prompt} tokens with the image span", flush=True)
    serve_l, _, _, stats, ttft = serve_family(cfg, model, proc, args, bodies,
                                              "phase 12c XComposer2-VL bf16 serve", seeded_image)
    if stats["cache_len"] < max(1500, n_prompt) + 32 or n_prompt > args.max_length:
        raise AssertionError(f"prompt {n_prompt} tokens, cache {stats['cache_len']}")
    pair = word_pair(14, 60, 120, 100)
    dpo_l, dpo_stats = family_dpo(cfg, model, proc, [pair], seeded_image,
                                  "phase 12c XComposer2-VL DPO (PLoRA + LoRA)", pad_to=2048)
    runner = build_eval(cfg, model, proc, eval_args(), seeded_image)
    rows = [{"question": f"question {i}: is there a dog in the picture?",
             "answer": ("yes", "no", "a dog", "two cats")[i % 4], "img": f"xce{i // 4}.png"}
            for i in range(16)]
    fns = counted(("flash_fwd",))
    zero_counts(fns)
    t1 = time.perf_counter()
    out = runner.run_vqa_ppl(rows, batch_size=16)
    ce_s = time.perf_counter() - t1
    ce_l = read_counts(fns)
    ppl = [r["ppl"] for r in out]
    print(f"phase 12c XC2 CE ranking: 16 rows in {ce_s * 1e3:.3f} ms ({16 / ce_s:.2f} rows/s), "
          f"ppl {[round(x, 4) for x in ppl]}; launches {json.dumps(ce_l)}", flush=True)
    if not all(np.isfinite(ppl)) or ce_l["flash_fwd"] < cfg.vision.layers_run + cfg.lm.num_layers:
        raise AssertionError(f"CE ranking: non-finite ppl or too few launches: {ppl} {ce_l}")
    print(f"phase 12c summary: prompt {n_prompt} tokens, TTFT {ttft:.3f} ms, DPO step "
          f"{dpo_stats['median_ms']:.3f} ms MFU {dpo_stats['mfu']:.4f} peak "
          f"{dpo_stats['peak_gib']:.3f} GiB; peak memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del model, runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"xc2_serve": serve_l, "xc2_dpo": dpo_l, "xc2_eval": ce_l}



# ---------------------------------------------------------------------------
# Phase 13: multi-GPU training, part 1 (core/mesh.py, dist.py, partitioning.py)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _build_dir(name: str) -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"{name}-{os.getpid()}")
    os.makedirs(path, exist_ok=True)
    return path


def _metrics_lines(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


TIMED13A = 4  # 13a: steps per timed train_steps call (4 calls: mesh, plain, plain, mesh)


def loop_turn(run, args, out: str, steps: int = TIMED13A) -> dict:
    """`steps` steps of `run` through cli.main train_steps (the loop a user
    runs: prefetched batches, the metrics read at every logging step, no
    checkpoint): ms per step (wall over the call / steps, the card synced
    at both ends), the step's peak memory above what was resident before
    it, and the logged losses."""
    import argparse

    from vlrlhf_torch.cli.main import make_logger, train_steps

    ns = argparse.Namespace(**{**vars(args), "max_steps": steps, "output_dir": out,
                               "num_train_epochs": float(steps), "save_steps": 10**9,
                               "run_name": None})
    logger = make_logger(ns, "dpo", run)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_steps(run, ns, logger)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    logger.close()
    losses = [r["loss"] for r in _metrics_lines(os.path.join(out, "dpo_metrics.jsonl"))]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"13a: {steps} steps logged {losses}")
    return {"ms": ms, "peak_gib": peak, "losses": losses}


def phase_mesh_dpo(dpo6: dict) -> dict:
    """13a: an NCCL process group of one on cuda:0 (made here, as torchrun's
    rank would) and the (data, fsdp, model) = (1, 1, 1) mesh; full-width,
    full-depth LLaVA-1.5-7B (phase 6's seeds, pair and arguments) through
    cli.main build_dpo (which places the model: FSDP2 units) and
    train_steps, 3 steps with a checkpoint at step 3 (rank 0's state.pt of
    the world-1 tensors). Losses within 1e-3 and grad norms within 1e-2
    relative of phase 6's first 3. Then a plain model of the same seeds,
    built by build_dpo with no mesh registered (phase 6's path), restores
    the checkpoint and must hold the live adapters; from that one state
    the two runs take turns through train_steps (mesh, plain, plain, mesh;
    TIMED13A steps each, losses equal within 1e-3) for ms per step and the
    step's peak memory above the resident, and one step of each is
    profiled (card busy time, idle share, the top host ops)."""
    import shutil
    import statistics

    import torch.distributed as tdist
    from torch.distributed.fsdp import FSDPModule

    from vlrlhf_torch.cli.main import build_dpo, train_steps, with_remat_policy
    from vlrlhf_torch.core.mesh import MeshConfig, make_mesh, set_global_mesh
    from vlrlhf_torch.core.partitioning import full_state_tree
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.metrics import MetricsLogger
    from vlrlhf_torch.train.train_state import load_state_tree_

    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                             world_size=1, rank=0, device_id=torch.device("cuda", 0))
    out = _build_dir("phase13a")
    fns = counted(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    try:
        mesh = make_mesh(MeshConfig(fsdp=-1), "cuda")
        cfg = with_remat_policy(_llava_7b(torch.bfloat16), "attn")
        model = VLM(cfg, "cuda")
        init_random_(model, torch.Generator(device="cuda").manual_seed(0))
        args = dpo_args(output_dir=out, num_train_epochs=3.0, save_steps=3)
        rows = [pair_row(7, 150, 260, 250)]
        run = build_dpo(cfg, model, make_processor(cfg), args, rows, seeded_image)
        units = [m for m in model.modules() if isinstance(m, FSDPModule)]
        if not (isinstance(model, FSDPModule) and all(isinstance(layer, FSDPModule)
                                                       for layer in model.lm.layers)):
            raise AssertionError("13a: the VLM and every LlamaLayer must be FSDP2 units")
        logger = MetricsLogger(out, "dpo")
        zero_counts(fns)
        t0 = time.perf_counter()
        train_steps(run, args, logger)  # the schedule of phase 6's 5 steps, 3 of them
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = read_counts(fns)
        logger.close()
        lines = _metrics_lines(os.path.join(out, "dpo_metrics.jsonl"))
        losses, norms = [r["loss"] for r in lines], [r["grad_norm"] for r in lines]
        print(f"13a mesh DPO (NCCL world 1, mesh (data, fsdp, model) = "
              f"{(mesh.data, mesh.fsdp, mesh.model)}, {len(units)} FSDP2 units): losses "
              f"{losses} vs phase 6's {dpo6['losses'][:3]}; grad norms {norms} vs "
              f"{dpo6['norms'][:3]}; launches {json.dumps(launches)}; 3 steps through "
              f"train_steps with the step-3 checkpoint {loop_s:.3f} s", flush=True)
        if len(losses) != 3 or abs(losses[0] - math.log(2.0)) > 1e-3:
            raise AssertionError(f"13a: step-1 loss {losses[:1]} is not ln 2 within 1e-3")
        for a, b in zip(losses, dpo6["losses"]):
            if abs(a - b) > 1e-3:
                raise AssertionError(f"13a losses {losses} differ from phase 6's by > 1e-3")
        for a, b in zip(norms, dpo6["norms"]):
            if abs(a - b) > 1e-2 * abs(b):
                raise AssertionError(f"13a grad norms {norms} differ from phase 6's by > 1e-2")
        if min(launches.values()) <= 0:
            raise AssertionError(f"13a: a flash kernel was not launched: {launches}")

        # the step-3 checkpoint in a plain model: phase 6's path, no mesh
        tree, _ = CheckpointManager(os.path.join(out, "checkpoints")).restore()
        live = full_state_tree(run.state_tree(), mesh)
        set_global_mesh(None)
        plain_model = VLM(cfg, "cuda")
        init_random_(plain_model, torch.Generator(device="cuda").manual_seed(0))
        plain = build_dpo(cfg, plain_model, make_processor(cfg),
                          dpo_args(output_dir=out, num_train_epochs=3.0), rows, seeded_image)
        load_state_tree_(plain.state, plain.keys, tree)
        set_global_mesh(mesh)
        same = plain.keys == run.keys and all(
            torch.equal(p, live["trainable"][k]) for k, p in zip(plain.keys, plain.state.trainable))
        files = sorted(os.listdir(os.path.join(out, "checkpoints", "3")))
        ckpt_bytes = sum(os.path.getsize(os.path.join(out, "checkpoints", "3", f)) for f in files)
        print(f"13a checkpoint: step {tree['step']}, files {files}, {ckpt_bytes / 1e9:.3f} GB; "
              f"restored in a plain model: adapters equal to the live ones {same}", flush=True)
        if not same or tree["step"] != 3:
            raise AssertionError("13a: the restored checkpoint's adapters differ from the live")
        del tree, live

        turns = []
        for i, (name, r, m) in enumerate((("mesh", run, mesh), ("plain", plain, None),
                                          ("plain", plain, None), ("mesh", run, mesh))):
            set_global_mesh(m)
            turns.append((name, loop_turn(r, args, os.path.join(out, f"turn{i}"))))
        set_global_mesh(mesh)
        got = {k: [t for n, t in turns if n == k] for k in ("mesh", "plain")}
        for a, b in zip(got["mesh"], got["plain"]):  # the same steps from the same state
            if max(abs(x - y) for x, y in zip(a["losses"], b["losses"])) > 1e-3:
                raise AssertionError(f"13a: mesh and plain losses differ: {turns}")
        med = {k: statistics.median(t["ms"] for t in v) for k, v in got.items()}
        peak = {k: max(t["peak_gib"] for t in v) for k, v in got.items()}
        print(f"13a DPO step through train_steps (1 pair, seq 1024, {TIMED13A} steps a turn, "
              f"mesh / plain / plain / mesh): ms per step "
              f"{[(n, round(t['ms'], 3)) for n, t in turns]}; mesh {med['mesh']:.3f} vs plain "
              f"{med['plain']:.3f} ({med['mesh'] / med['plain']:.3f}x); step peak above the "
              f"resident mesh {peak['mesh']:.3f} GiB vs plain {peak['plain']:.3f} GiB; phase 6's "
              f"run.step median {dpo6['median_ms']:.3f} ms", flush=True)
        for name, r in (("mesh", run), ("plain", plain)):
            set_global_mesh(mesh if name == "mesh" else None)
            batch = batch_to_device(r.collator([r.tokenize_fn(x) for x in r.rows]), "cuda")
            r.step(batch)  # warm
            profile_breakdown(lambda: r.step(batch), f"13a {name} DPO step (world 1)",
                              host_top=6)
        set_global_mesh(mesh)
        del run, model, plain, plain_model, batch
    finally:
        set_global_mesh(None)
        tdist.destroy_process_group()
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"mesh_dpo": launches}, {"median_ms": med["mesh"], "plain_ms": med["plain"],
                                    "peak_gib": peak["mesh"]}


def torchrun_cmd(nproc: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(nproc), *args]


def start_logged(cmd: list, env=None) -> tuple:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=os.path.dirname(os.path.abspath(__file__))), \
        time.perf_counter()


def finish_logged(started: tuple, what: str, timeout: float = 400) -> str:
    proc, t0 = started
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{out[-4000:]}")
    print(f"{what}: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_launchers() -> dict:
    """13b-d, their processes started at once. 13b: `torchrun --standalone
    --nproc_per_node 1 -m vlrlhf_torch.cli.main dpo --synthetic 8
    --mesh_fsdp -1 --max_steps 2` (NCCL, cuda:0): exit 0, finite metrics.
    13c: `eval` on phase 8's MME rows (seeded image blobs, `eval_image`)
    with LLaVA-1.5-7B's widths at 2 LM / 2 tower layers, two ranks under
    torchrun sharing the card over gloo (this script with
    --mesh13c-worker: each rank evaluates its contiguous half of the rows,
    rank 0 gathers, scores and writes), against the same eval in this
    process: the same rows; the ranks' launches are the "mesh_eval" path.
    13d: two ranks sharing the card over gloo (NCCL puts one rank on a
    device; gloo carries FSDP2's all-gather / reduce-scatter and the
    tensor-parallel all-reduces on CUDA tensors), this script with
    --mesh13d-worker and torchrun's environment, each MESH13D layout in
    turn at full width and 2 layers, against runs in this process. Held:
    the first update's gradients (Adam's first moment after it, 0.1 x the
    clipped gradient, gathered to the world-1 layout) leaf by leaf within
    MESH_GRAD_TOL (relative L2) of the two-pair world-1 run for fsdp = 2
    and model = 2, and of one process accumulating the same one-pair
    forwards for fsdp = 2, whose three losses must also be within
    MESH_LOSS_TOL of that control; every layout's step-1 loss ln 2 and
    step-1 gradient norm within 1e-2 of world 1's. A planted fault, model
    = 2 with the row-parallel base product's all-reduce skipped, must fail
    MESH_GRAD_TOL.
    (Later losses of a layout whose forward shapes differ from world 1's
    are not held to it: Adam's first update is about lr x sign(g), so bf16
    noise in the small gradients moves them by ~2e-3, a third of what
    three updates move them.) Returns the launch counts of 13c and of
    13d's model = 2 rank 0 ("mesh_dpo_tp"), with 13e's, 14b's, 15's, 16's
    and 17's (their ranks started here too)."""
    import shutil

    from vlrlhf_torch.cli.main import main as cli_main

    out = _build_dir("phase13")
    procs = {}
    try:
        dpo_out = os.path.join(out, "dpo")
        mme, seed = write_eval_data(out)
        os.makedirs(os.path.join(out, "ranks"), exist_ok=True)
        got13d = os.path.join(out, "ranks", "13d.pt")
        env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
        rm_dir = mesh13e_reward(os.path.join(out, "rm"))
        env13e = dict(env, MASTER_PORT=str(_free_port()))
        got14 = os.path.join(out, "ranks", "14b.pt")
        env14 = dict(env, MASTER_PORT=str(_free_port()))
        got15 = os.path.join(out, "ranks", "15.pt")
        env15 = dict(env, MASTER_PORT=str(_free_port()))
        rm16 = mesh13e_reward(os.path.join(out, "rm16"), layers=PHASE16_LAYERS)
        env16 = dict(env, MASTER_PORT=str(_free_port()))
        ranks16 = os.path.join(out, "ranks16")
        os.makedirs(ranks16, exist_ok=True)
        env17 = dict(env, MASTER_PORT=str(_free_port()))
        ranks17 = os.path.join(out, "ranks17")
        os.makedirs(ranks17, exist_ok=True)
        procs = {
            "13b": start_logged(torchrun_cmd(
                1, "-m", "vlrlhf_torch.cli.main", "dpo", "--synthetic", "8", "--mesh_fsdp",
                "-1", "--sequence_parallel_axis", "fsdp", "--max_steps", "2", "--logging_steps",
                "1", "--per_device_train_batch_size", "1", "--output_dir", dpo_out)),
            "13c": start_logged(torchrun_cmd(
                2, os.path.abspath(__file__), "--mesh13c-worker", mme, seed,
                os.path.join(out, "two"))),
            **{f"13d rank {r}": start_logged(
                [sys.executable, os.path.abspath(__file__), "--mesh13d-worker", got13d],
                env=dict(env, RANK=str(r))) for r in range(2)},
            "13e": [start_logged([sys.executable, os.path.abspath(__file__), "--mesh13e-worker",
                                  os.path.join(out, "ranks"), rm_dir],
                                 env=dict(env13e, RANK=str(r))) for r in range(2)],
            **{f"14b rank {r}": start_logged(
                [sys.executable, os.path.abspath(__file__), "--mesh14-worker", got14],
                env=dict(env14, RANK=str(r))) for r in range(2)},
            **{f"15 rank {r}": start_logged(
                [sys.executable, os.path.abspath(__file__), "--mesh15-worker", got15],
                env=dict(env15, RANK=str(r))) for r in range(2)},
            "16": [start_logged([sys.executable, os.path.abspath(__file__), "--mesh16-worker",
                                 ranks16, rm16], env=dict(env16, RANK=str(r)))
                   for r in range(2)],
            "17": [start_logged([sys.executable, os.path.abspath(__file__), "--mesh17-worker",
                                 ranks17, rm_dir], env=dict(env17, RANK=str(r)))
                   for r in range(2)],
        }
        one = mesh13c_eval(mme, seed, os.path.join(out, "one"))
        world1 = mesh13d_run(os.path.join(out, "world1"))
        # the control of fsdp = 2: one process, each forward on one pair as
        # a rank's, the two pairs' gradients met by accumulation
        accum = mesh13d_run(os.path.join(out, "accum"), per_device=1, accumulate=2)
        world13e = mesh13e_run(os.path.join(out, "ppo_world1"), None, len(PPO13E_WORDS), None,
                               rm_dir)
        world14 = mesh14_run(os.path.join(out, "sp_world1"), False)
        world15 = mesh15_run(os.path.join(out, "pipe_world1"), False)
        pipeline_local_check()
        world16 = mesh13e_run(os.path.join(out, "ppo16_world1"), None, len(PPO13E_WORDS), None,
                              rm16, layers=PHASE16_LAYERS)
        samples16 = mesh16_samples(os.path.join(out, "samples16_world1"), None)
        for what in [w for w in procs if w not in ("13e", "16", "17")]:
            finish_logged(procs.pop(what), what)

        lines = _metrics_lines(os.path.join(dpo_out, "dpo_metrics.jsonl"))
        vals = [v for r in lines for v in r.values() if isinstance(v, float)]
        print(f"13b torchrun dpo --synthetic 8 --mesh_fsdp -1 --sequence_parallel_axis fsdp (NCCL, a "
              f"ring of one): {len(lines)} logged steps, "
              f"losses {[r['loss'] for r in lines]}", flush=True)
        if len(lines) != 2 or not all(np.isfinite(vals)) or \
                not os.path.exists(os.path.join(dpo_out, "adapters", "params.pt")):
            raise AssertionError(f"13b: want 2 finite logged steps and adapters/: {lines}")

        rows = {}
        for k in ("one", "two"):  # each run decodes the TSV's images into its own temp dir
            for bench in ("mme", "seedbench"):
                with open(os.path.join(out, k, f"{bench}.json")) as f:
                    rows[k, bench] = [dict(r, img=os.path.basename(str(r.get("img"))))
                                      for r in json.load(f)]
        with open(os.path.join(out, "two", "launches.json")) as f:
            eval_launches = json.load(f)
        same = {b: rows["one", b] == rows["two", b] for b in ("mme", "seedbench")}
        ppl = [r["ppl"] for r in rows["two", "seedbench"]]
        print(f"13c torchrun eval, 2 ranks over gloo on one card (LLaVA-1.5-7B widths, 2 "
              f"layers): MME {len(rows['two', 'mme'])} rows, seedbench "
              f"{len(rows['two', 'seedbench'])} rows (ppl {min(ppl):.4f}-{max(ppl):.4f}, "
              f"{len(set(ppl))} distinct), equal to the in-process run's {same}; launches "
              f"(both ranks) {json.dumps(eval_launches)}, in-process {json.dumps(one)}",
              flush=True)
        if not all(same.values()) or len(rows["one", "mme"]) != 32 or len(ppl) != 64:
            raise AssertionError("13c: the torchrun eval rows differ from the in-process run's")
        if eval_launches != one:
            raise AssertionError("13c: the ranks' launches differ from the in-process run's")

        got = torch.load(got13d, weights_only=False)
        print(f"13d two ranks on one card (gloo), losses / grad norms per update: world 1 "
              f"{world1['losses']} / {world1['norms']}; world 1 accumulating 2 x 1 pair "
              f"{accum['losses']}; "
              + "; ".join(f"{k} {v['losses']} / {v['norms']}" for k, v in got.items()),
              flush=True)
        gaps = {"fsdp2 vs accum": grad_gap(got["fsdp2"], accum),
                "fsdp2 vs world1": grad_gap(got["fsdp2"], world1),
                "model2 vs world1": grad_gap(got["model2"], world1),
                "planted vs world1": grad_gap(got["model2_planted"], world1)}
        loss_gap = max(abs(a - b) for a, b in zip(got["fsdp2"]["losses"], accum["losses"]))
        print("13d first update's gradients, worst leaf's relative L2 gap (leaf) "
              + json.dumps({k: (round(v, 6), leaf) for k, (v, leaf) in gaps.items()})
              + f", tol {MESH_GRAD_TOL} (the planted fault, model = 2 without the row-parallel "
              f"all-reduce, must exceed it); fsdp2 vs accum losses max |diff| {loss_gap:.3e} "
              f"(tol {MESH_LOSS_TOL})", flush=True)
        for k, (v, leaf) in gaps.items():
            if (v > MESH_GRAD_TOL) != k.startswith("planted"):
                raise AssertionError(f"13d {k}: the first update's gradients are {v} apart at "
                                     f"{leaf} (tol {MESH_GRAD_TOL})")
        if loss_gap > MESH_LOSS_TOL:
            raise AssertionError(f"13d fsdp2: losses {got['fsdp2']['losses']} against the "
                                 f"accumulating control {accum['losses']}")
        for name in ("fsdp2", "model2"):
            g = got[name]
            if len(g["losses"]) != 3 or not np.isfinite(g["losses"]).all() or \
                    abs(g["losses"][0] - math.log(2.0)) > 1e-6 or \
                    abs(g["norms"][0] - world1["norms"][0]) > 1e-2 * world1["norms"][0]:
                raise AssertionError(f"13d {name}: {g['losses']} / {g['norms']}: step 1 must "
                                     f"read ln 2 and world 1's norm {world1['norms'][0]}")
        mesh13d_saves(os.path.join(out, "ranks"), got)
        got13e = mesh13e_check(os.path.join(out, "ranks"), procs.pop("13e"), world13e, rm_dir)
        return {"mesh_eval": eval_launches, "mesh_dpo_tp": got["model2"]["launches"],
                "mesh_ppo": got13e, "mesh_dpo_sp": mesh14_check(got14, world14),
                "mesh_dpo_pipe": mesh15_check(got15, world15),
                "mesh_ppo_pipe": mesh16_check(ranks16, procs.pop("16"), world16, samples16,
                                              rm16),
                **mesh17_check(ranks17, procs.pop("17"), world14, world13e, rm_dir)}
    finally:
        for started in procs.values():
            for proc, _ in (started if isinstance(started, list) else [started]):
                proc.kill()
                proc.communicate()
        shutil.rmtree(out, ignore_errors=True)


def grad_gap(got: dict, ref: dict, skip=()) -> tuple:
    """(the largest relative L2 gap over the leaves of two runs' first-update
    gradients, but those in `skip`, its leaf); a leaf both hold at zero
    (LoRA's a, whose gradient is 0 while b is) counts 0."""
    worst = (0.0, None)
    for k, w in ref["grads"].items():
        if k in skip:
            continue
        g = got["grads"][k]
        num, den = float((g - w).norm()), float(w.norm())
        gap = num / den if den > 0 else (0.0 if num == 0 else math.inf)
        worst = max(worst, (gap, k), key=lambda t: t[0])
    return worst


MESH13D = (("fsdp2", (1, 2, 1), 1, 3, False), ("model2", (1, 1, 2), 2, 3, False),
           ("model2_planted", (1, 1, 2), 2, 1, True))
MESH13D_SAVED = ("fsdp2", "model2")  # the layouts that save, restore and merge
MESH_LOSS_TOL = 1e-3  # 13d: fsdp = 2's losses against its same-arithmetic control
MESH_GRAD_TOL = 2e-2  # 13d: a layout's first-update gradients against world 1's, per leaf
MESH13D_LR = 1e-6  # keeps 13d's three losses between ln 2 and 0 (1e-4 took step 2 to 1e-4)


def mesh_2layer_cfg():
    """LLaVA-1.5-7B's widths at 2 LM / 2 tower layers, attn remat (13c, 13d)."""
    import dataclasses

    from vlrlhf_torch.cli.main import with_remat_policy
    from vlrlhf_torch.models.config import _llava_7b

    full = with_remat_policy(_llava_7b(torch.bfloat16), "attn")
    return dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_layers=2),
                               vision=dataclasses.replace(full.vision, num_layers=2))


def mesh13c_eval(mme: str, seed: str, out: str) -> dict:
    """13c's eval (phase 8's static MME run and its seedbench CE ranking at
    2 layers, seeded weights): build_eval and run_eval for each; under a
    process group each rank runs its shard of the rows. Returns the
    launches summed over the ranks."""
    from vlrlhf_torch.cli.main import build_eval, run_eval
    from vlrlhf_torch.core import dist as vdist
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM

    cfg = mesh_2layer_cfg()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    fns = counted(("flash_fwd", "decode_attention", "chunk_attention"))
    zero_counts(fns)
    for bench, data in (("mme", mme), ("seedbench", seed)):
        args = eval_args(benchmark=bench, data_file=data, output_dir=out)
        runner = build_eval(cfg, model, make_processor(cfg), args, eval_image)
        run_eval(runner, args, progress=False)
    counts = read_counts(fns)
    per_rank = vdist.gather_objects([counts])
    del runner, model
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c[n] for c in per_rank) for n in counts}


def mesh13c_worker(mme: str, seed: str, out: str) -> int:
    """A rank of 13c (started by torchrun): gloo on cuda:0; rank 0 writes
    the launches beside the rows."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    launches = mesh13c_eval(mme, seed, out)
    if tdist.get_rank() == 0:
        with open(os.path.join(out, "launches.json"), "w") as f:
            json.dump(launches, f)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def mesh13d_run(out: str, shape=None, per_device: int = 2, accumulate: int = 1,
                updates: int = 3, save: bool = False, sp: str = "", rows=None,
                max_length: int = 1024, clip: bool = True, layers: int = 2,
                micro: int = 0) -> dict:
    """One 13d run: LLaVA-1.5-7B's widths at 2 LM / 2 tower layers (seeded
    bf16 on cuda:0), 2 pairs per global batch, build_dpo (precomputed
    reference logps) and train_steps for `updates` updates; returns rank
    0's logged {"losses", "norms"} per update, "grads": the first update's
    gradients (Adam's first moment after it, gathered to the world-1
    layout, on the host) and the flash kernels' "launches". With `shape`,
    under that (data, fsdp, model) mesh of the process group; with
    `accumulate` > 1 in one process, --gradient_accumulation_steps over
    micro-batches of `per_device` pairs (an update's loss is its
    micro-batches' mean). With `save`, a checkpoint at the last update and
    finish_run's adapters/ and merged/ (--merge_adapter_after_training),
    written by rank 0 from the gathered world-1 tensors; every rank then
    restores the checkpoint into its layout (shard_full) and "resumes_exact"
    says whether each of its live shards came back bit for bit. 14b's runs
    pass `sp` (the mesh's --sequence_parallel_axis), their own `rows` and
    `max_length` (the processor's), and `clip` False (no gradient
    clipping, so Adam's first moment holds the gradients' scale);
    "resident_gib" is each rank's device memory after build_dpo (the placed
    model, adapters and optimizer state) and "peak_gib" its peak above that
    while train_steps runs. 15's runs pass `layers` (the LM's depth) and,
    under a `shape` with pipe > 1, `micro` (--pipeline_microbatches); a
    stage's gradients are joined with the other stages' (every layer's
    leaf on rank 0)."""
    import argparse

    from vlrlhf_torch.cli.main import build_dpo, finish_run, make_logger, train_steps
    from vlrlhf_torch.core.dist import gather_objects, is_main_process, local_tensor
    from vlrlhf_torch.core.mesh import MeshConfig, make_mesh, set_global_mesh
    from vlrlhf_torch.core.partitioning import shard_full, tp_dim
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM

    cfg = mesh_2layer_cfg()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=layers))
    mesh = make_mesh(MeshConfig(*shape), "cuda", sp, micro) if shape is not None else None
    fns = counted(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    try:
        model = VLM(cfg, "cuda")
        init_random_(model, torch.Generator(device="cuda").manual_seed(1))
        args = dpo_args(output_dir=out, per_device_train_batch_size=per_device,
                        gradient_accumulation_steps=accumulate, num_train_epochs=6.0,
                        max_steps=3, learning_rate=MESH13D_LR, warmup_ratio=0.0, run_name=None,
                        save_steps=updates * accumulate if save else 500,
                        merge_adapter_after_training=save, max_length=max_length,
                        max_grad_norm=1.0 if clip else 1e30)
        proc = make_processor(cfg)
        proc.cfg = dataclasses.replace(proc.cfg, max_length=max(max_length, proc.cfg.max_length),
                                       max_prompt_length=max(max_length // 2,
                                                             proc.cfg.max_prompt_length))
        run = build_dpo(cfg, model, proc, args,
                        rows or [pair_row(7, 150, 260, 250), pair_row(8, 140, 240, 270)],
                        seeded_image)
        logger = make_logger(args, "dpo", run)
        grads = {}

        def first_update(step, _metrics):
            if step == accumulate:  # collective under a mesh: every rank is here
                grads.update({k: host_full(v, tp_dim(k), mesh) / (1 - run.ocfg.b1)
                              for k, v in run.state_tree()["mu"].items()})
                if mesh is not None and mesh.pp is not None:  # every stage's layers
                    import torch.distributed as tdist

                    stages = [None] * mesh.pipe
                    tdist.all_gather_object(stages, dict(grads), group=mesh.pipe_group)
                    for g in stages:
                        grads.update(g)

        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # the placed model, adapters and optimizer state
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fns)
        # the optimizer's schedule counts 3 updates (build_dpo read max_steps 3)
        train_steps(run, argparse.Namespace(**{**vars(args), "max_steps": updates * accumulate}),
                    logger, on_step=first_update)
        launches = read_counts(fns)
        logger.close()
        got = {"losses": [], "norms": [], "grads": grads, "launches": launches,
               "rank_launches": gather_objects([launches]),
               "peak_gib": gather_objects([(torch.cuda.max_memory_allocated() - base) / 2**30]),
               "resident_gib": gather_objects([base / 2**30]),
               "seq": run.collator([run.tokenize_fn(r) for r in run.rows])["input_ids"].shape[1]}
        if save:
            t0 = time.perf_counter()
            finish_run(run, args)  # adapters/, merged/; every rank leaves it together
            got["save_s"] = time.perf_counter() - t0
            tree, _ = CheckpointManager(os.path.join(out, "checkpoints")).restore()
            live = run.state_tree()
            exact = all(
                torch.equal(local_tensor(t).cpu(),
                            (tree[g][k] if mesh is None else
                             shard_full(tree[g][k], t, tp_dim(k), mesh)).cpu())
                for g in ("trainable", "mu", "nu") for k, t in live[g].items())
            got["resumes_exact"] = gather_objects([bool(exact)])
        if is_main_process():
            lines = _metrics_lines(os.path.join(out, "dpo_metrics.jsonl"))
            for k in ("losses", "norms"):
                vals = [r["loss" if k == "losses" else "grad_norm"] for r in lines]
                got[k] = [sum(vals[i:i + accumulate]) / accumulate
                          for i in range(0, len(vals), accumulate)]
        del run, model
    finally:
        set_global_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
    return got


def host_full(t: torch.Tensor, dim, mesh) -> torch.Tensor:
    """A leaf's world-1 value in f32 on the host: its FSDP2 shards, then its
    tensor-parallel parts along `dim`, joined from CPU copies
    (all_gather_object). 13d's ranks share the card over gloo, and there
    DTensor.full_tensor of a CUDA shard took a rank down (SIGSEGV) on the
    H100."""
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor

    def joined(x, group, d):
        parts = [None] * tdist.get_world_size(group)
        tdist.all_gather_object(parts, x, group=group)
        return torch.cat(parts, dim=d)

    x = (t.to_local() if isinstance(t, DTensor) else t).detach().float().cpu()
    if mesh is not None and isinstance(t, DTensor) and mesh.fsdp > 1:
        x = joined(x, mesh.fsdp_group, 0)
    if mesh is not None and dim is not None and mesh.model > 1:
        x = joined(x, mesh.tp_group, dim)
    return x


@contextlib.contextmanager
def row_reduce_skipped():
    """13d's planted fault for the block: a row-parallel Linear's product
    (wo, down) is not summed over the model group (models/common.py's
    reduce_from_tp is the identity)."""
    from vlrlhf_torch.models import common

    kept = common.reduce_from_tp
    common.reduce_from_tp = lambda y, group: y
    try:
        yield
    finally:
        common.reduce_from_tp = kept


def mesh13d_saves(ranks: str, got: dict) -> None:
    """13d's saves: each MESH13D_SAVED layout's checkpoint restored into its
    own layout bit for bit on every rank, its adapters/ equal to the
    checkpoint's trainable leaves, and its merged/ (gathered from the
    shards, merged by rank 0) equal bit for bit to a world-1 merge of the
    same adapters: the seeded 2-layer model in this process, the adapters
    file set on it, save_merged with no mesh."""
    import shutil

    from vlrlhf_torch.cli.main import save_merged
    from vlrlhf_torch.lora.lora import set_adapters_
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.checkpoint import CheckpointManager, load_params

    cfg = mesh_2layer_cfg()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(1))
    args = dpo_args()
    report = {}
    for name in MESH13D_SAVED:
        d = os.path.join(ranks, name)
        adapters = load_params(os.path.join(d, "adapters"))
        tree, _ = CheckpointManager(os.path.join(d, "checkpoints")).restore()
        same_adapters = tree["trainable"].keys() == adapters.keys() and all(
            torch.equal(tree["trainable"][k], adapters[k]) for k in adapters)
        set_adapters_(model, adapters)
        w1 = os.path.join(ranks, f"{name}_world1")
        t0 = time.perf_counter()
        save_merged(model, args.lora_alpha / args.lora_r, dpo_args(output_dir=w1))
        w1_s = time.perf_counter() - t0
        a, b = load_params(os.path.join(d, "merged")), load_params(os.path.join(w1, "merged"))
        diff = [k for k in b if k not in a or not torch.equal(a[k], b[k])]
        report[name] = {"resumes_exact": got[name]["resumes_exact"],
                        "adapters_equal_checkpoint": same_adapters,
                        "merged_leaves": len(b), "merged_bytes": sum(t.numel() * t.element_size()
                                                                     for t in b.values()),
                        "merged_differ": diff[:4], "save_s": round(got[name]["save_s"], 3),
                        "world1_merge_s": round(w1_s, 3)}
        shutil.rmtree(w1, ignore_errors=True)
        shutil.rmtree(os.path.join(d, "merged"), ignore_errors=True)
    print("13d saves (checkpoint at the last update, adapters/, merged/, through train_steps "
          "and finish_run on the two ranks): " + json.dumps(report), flush=True)
    for name, r in report.items():
        if not all(r["resumes_exact"]) or not r["adapters_equal_checkpoint"] or \
                r["merged_differ"] or r["merged_leaves"] == 0:
            raise AssertionError(f"13d {name}: the multi-rank save or merged save is not world "
                                 f"1's bit for bit: {r}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


# 13e: ppo on two gloo ranks sharing the card, each layout against world 1.
# (name, (data, fsdp, model), rows per data-parallel rank, planted fault)
MESH13E = (("model2", (1, 1, 2), 4, None), ("fsdp2", (1, 2, 1), 2, None),
           ("fsdp2_whitened_per_rank", (1, 2, 1), 2, "whiten"),
           ("model2_decode_unreduced", (1, 1, 2), 4, "decode"))
# 13e's bound, fixed before its first card run: a layout's first-update
# gradients (Adam's first moment / 0.1) within 5e-2 relative L2 of world
# 1's on the same tokens and scores at every leaf
PPO_GRAD_TOL = 5e-2
# a layout's reward scores within this of world 1's, relative to world 1's
# largest |score| (bf16 noise read up to 2.55e-2 at seeds 2-6 before it was
# set); each planted fault must fail tokens, scores or gradients
PPO_SCORE_TOL = 5e-2
PPO13E_WORDS = (60, 70, 80, 90)  # four image prompts, one global batch of 4 rows


def mesh13e_reward(out: str, seed: int = 1, layers: int = 2) -> str:
    """A seeded reward model for 13e (from 20 + `seed`), written as an rm
    run's adapters/: r8 LoRA with non-zero b on the family's targets of the
    model of `layers` LM layers (13e's 2, 16's 4) and an (H, 1) rm_head,
    so its scores differ row by row."""
    from vlrlhf_torch.lora.lora import match_lora_targets, module_path
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.checkpoint import save_params

    cfg = mesh_2layer_cfg()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=layers))
    model = VLM(cfg, "meta")  # shapes only
    g = torch.Generator().manual_seed(20 + seed)
    tree = {}
    for name, mod in match_lora_targets(model, FAMILIES[cfg.family].lora_targets):
        key = f"adapters/{module_path(name)[: -len('/kernel')]}"
        tree[f"{key}/a"] = torch.randn((mod.d_in, 8), generator=g) * mod.d_in**-0.5
        tree[f"{key}/b"] = torch.randn((8, mod.d_out), generator=g) * 0.02
    tree["rm_head/kernel"] = torch.randn((cfg.lm.hidden_size, 1), generator=g) * 0.05
    save_params(os.path.join(out, "adapters"), tree)
    return os.path.join(out, "adapters")


@contextlib.contextmanager
def ppo_fault(kind):
    """13e's and 16's planted faults: "whiten" whitens the advantages over
    the rank's rows (train/ppo.py's masked_whiten without its group);
    "decode" skips the row-parallel all-reduce in every decode step of the
    rollouts; "stage_order" joins the whole stack for the rollouts with
    each layer's stage copies in reverse stage order
    (core/partitioning.py whole_stack: stage 1's layers run first)."""
    from vlrlhf_torch.core import partitioning
    from vlrlhf_torch.models.lm.llama import LlamaDecoder
    from vlrlhf_torch.train import ppo

    if kind is None:
        yield
        return
    if kind == "stage_order":
        copies = partitioning._stage_copies
        partitioning._stage_copies = lambda layer, mesh: copies(layer, mesh)[::-1]
        try:
            yield
        finally:
            partitioning._stage_copies = copies
        return
    if kind == "whiten":
        kept = ppo.masked_whiten
        ppo.masked_whiten = lambda x, mask, group=None: kept(x, mask)
        try:
            yield
        finally:
            ppo.masked_whiten = kept
        return
    kept = LlamaDecoder.decode

    def decode(self, *a, **k):
        with row_reduce_skipped():
            return kept(self, *a, **k)

    LlamaDecoder.decode = decode
    try:
        yield
    finally:
        LlamaDecoder.decode = kept


def mesh13e_ties(run, rows: list, layout: dict, ref_tokens: list, adapters: bool = True) -> dict:
    """{"ties": [(row, position, world 1's token, the layout's, gap)],
    "not_tie": [...]}: each row where the layout's greedy tokens differ from
    world 1's, judged as tie_or_raise judges one, on `run`'s world-1 model
    (its adapters on, or off with `adapters` False): both tokens its top
    two after world 1's common prefix, their gap within LOGIT_REL_TOL of
    the largest |logit|."""
    from vlrlhf_torch.cli.main import prompt_row
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill
    from vlrlhf_torch.models.common import Ctx

    out = {"ties": [], "not_tie": []}
    proc = run.gen_collator.processor
    for i, (ref, got) in enumerate(zip(ref_tokens, layout["tokens"])):
        d = divergence(ref, got, -1)
        if d is None:
            continue
        j, a, b = d
        prow = prompt_row(proc, rows[i])
        t = batch_to_device(run.gen_collator([dict(prow, input_ids=list(prow["input_ids"])
                                                   + list(ref[:j]))]), run.model.device)
        with torch.inference_mode():
            *_, last = prefill(run.model, GenerateConfig(max_new_tokens=1, pad_token_id=-1),
                               t["input_ids"].shape[1], t["input_ids"], t["pad_mask"],
                               t["prompt_lens"], t["pixel_values"], t["image_positions"],
                               None, Ctx(adapters=adapters, lora_scale=run.lcfg.scale))
        logits = last[0].float().cpu()
        gap = float((logits[a] - logits[b]).abs())
        tie = {a, b} == set(torch.topk(logits, 2).indices.tolist()) and \
            gap <= LOGIT_REL_TOL * float(logits.abs().max())
        out["ties" if tie else "not_tie"].append((i, j, a, b, round(gap, 5)))
    return out


@contextlib.contextmanager
def rollouts_replayed(layout):
    """train_ppo's static rollouts replaced by `layout`'s global tokens and
    response lengths (world 1 only); None leaves them."""
    from vlrlhf_torch.cli import main as cli

    if layout is None:
        yield
        return
    kept = cli.static_rollouts
    cli.static_rollouts = lambda gen, pb, chunk_sz, generator: (
        np.asarray(layout["tokens"], np.int32), np.asarray(layout["resp_lens"]))
    try:
        yield
    finally:
        cli.static_rollouts = kept


@contextlib.contextmanager
def ppo_probes(got: dict, base: int):
    """16's probes on a train_ppo run: the decode steps taken (each
    generate/engine.py decode_step call) and the card's peak memory above
    `base` (the resident placed model, adapters and optimizer state)
    during the rollouts (cli.main static_rollouts, the whole stack joined)
    and during the update (train/ppo.py ppo_update_epochs), in GiB."""
    from vlrlhf_torch.cli import main as cli
    from vlrlhf_torch.generate import engine
    from vlrlhf_torch.train import ppo

    kept = (cli.static_rollouts, ppo.ppo_update_epochs, engine.decode_step)
    got["decode_steps"] = 0

    def peak_of(fn, key):
        def probed(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            got[key] = (torch.cuda.max_memory_allocated() - base) / 2**30
            return res
        return probed

    def step(*a, **k):
        got["decode_steps"] += 1
        return kept[2](*a, **k)

    cli.static_rollouts = peak_of(kept[0], "rollout_peak_gib")
    ppo.ppo_update_epochs = peak_of(kept[1], "update_peak_gib")
    engine.decode_step = step
    try:
        yield
    finally:
        cli.static_rollouts, ppo.ppo_update_epochs, engine.decode_step = kept


def mesh13e_run(out: str, shape, per_device: int, fault, rm_dir: str, seed: int = 1,
                replay=None, layers: int = 2, micro: int = 0, sp: str = "") -> dict:
    """One 13e run through cli.main build_ppo and train_ppo: LLaVA-1.5-7B's
    widths at 2 LM / 2 tower layers (bf16 on cuda:0, weights from `seed`),
    one outer step of a global batch of 4 image prompts (PPO13E_WORDS;
    prompts 4 (seed - 1) to 4 seed - 1), 16 greedy tokens (build_ppo's
    GenerateConfig with do_sample off), the seeded reward model of
    `rm_dir` as a named set on the same base, one update on the full batch.
    With `shape` under that mesh of the process group. Returns the global
    rollout tokens, the first update's gradients (world-1 layout, host),
    rank 0's logged metrics and the launches of kernels 1-4 (this rank's).

    `replay` (world 1 only) is (a layout's result, world 1's tokens): where
    the two rollouts differ, each row's first divergence is checked for a
    top-2 tie of this model's teacher-forced logits ("ties"; any other
    divergence goes to "not_tie" and the step is not run); then the step
    runs on the layout's tokens and raw reward scores, so its gradients
    are world 1's on the same rollout and rewards.

    16's runs pass `layers` (the LM's depth) and, under a `shape` with pipe
    > 1, `micro` (--pipeline_microbatches); a stage's gradients are joined
    with the other stages'. 17b's pass `sp` (the mesh's
    --sequence_parallel_axis). Outside a replay the result also holds every
    rank's launches ("rank_launches"), decode steps, resident memory and
    rollout and update peaks (`ppo_probes`)."""
    import dataclasses

    from vlrlhf_torch.cli.main import build_ppo, make_logger, train_ppo
    from vlrlhf_torch.core.dist import gather_objects, is_main_process
    from vlrlhf_torch.core.mesh import MeshConfig, make_mesh, set_global_mesh
    from vlrlhf_torch.core.partitioning import tp_dim
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM

    cfg = mesh_2layer_cfg()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=layers))
    mesh = (make_mesh(MeshConfig(*shape), "cuda", sp, microbatches=micro)
            if shape is not None else None)
    fns = counted(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention"))
    got = {}
    try:
        model = VLM(cfg, "cuda")
        init_random_(model, torch.Generator(device="cuda").manual_seed(seed))
        args = trainer_args(output_dir=out, per_device_train_batch_size=per_device, max_steps=1,
                            ppo_epochs=1, minibatch_size=0, max_new_tokens=16,
                            reward_model_path=rm_dir, learning_rate=MESH13D_LR)
        rows = [ppo_prompt(len(PPO13E_WORDS) * (seed - 1) + i, w)
                for i, w in enumerate(PPO13E_WORDS)]
        run = build_ppo(cfg, model, make_processor(cfg), args, rows, seeded_image)
        # greedy: each data-parallel rank samples its own rows, so only greedy
        # rollouts repeat world 1 under every layout
        run.gen_cfg = dataclasses.replace(run.gen_cfg, do_sample=False)
        if replay is not None:
            got.update(mesh13e_ties(run, rows, replay[0], replay[1]))
            if got["not_tie"]:
                return got
            replayed = torch.as_tensor(np.asarray(replay[0]["raw_scores"], np.float32))
            run.reward_fn = lambda batch: replayed
        logger = make_logger(args, "ppo", run)

        def first(step, info):  # collective under a mesh: every rank is here
            grads = {k: host_full(v, tp_dim(k), mesh) / (1 - run.ocfg.b1)
                     for k, v in run.state_tree()["mu"].items()}
            if mesh is not None and mesh.pp is not None:  # every stage's layers
                import torch.distributed as tdist

                stages = [None] * mesh.pipe
                tdist.all_gather_object(stages, dict(grads), group=mesh.pipe_group)
                for g in stages:
                    grads.update(g)
            got.update(tokens=np.asarray(info["tokens"]).tolist(),
                       resp_lens=np.asarray(info["resp_lens"]).tolist(),
                       scores=[round(float(x), 6) for x in info["scores"]],
                       # the raw scores: 13e scales, norms and clips none
                       raw_scores=np.asarray(info["scores"], np.float32),
                       grads=grads)

        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # the placed model, adapters and optimizer state
        probes = {"resident_gib": base / 2**30}
        zero_counts(fns)
        t0 = time.perf_counter()
        with ppo_fault(fault), rollouts_replayed(replay and replay[0]), \
                ppo_probes(probes, base) if replay is None else contextlib.nullcontext():
            train_ppo(run, make_processor(cfg), args, logger, on_step=first)
        got["step_s"] = time.perf_counter() - t0
        got["launches"] = read_counts(fns)
        if replay is None:
            got["rank_launches"] = gather_objects([got["launches"]])
            got["ranks"] = gather_objects([probes])
        logger.close()
        if is_main_process():
            got["metrics"] = _metrics_lines(os.path.join(out, "ppo_metrics.jsonl"))
        del run, model
    finally:
        set_global_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
    return got


def mesh13e_worker(ranks: str, rm_dir: str, seed: str = "1") -> int:
    """A rank of 13e: gloo on cuda:0, each MESH13E layout in turn; rank 0
    writes {name: mesh13e_run's result} to <ranks>/13e.pt."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    got = {}
    for name, shape, per_device, fault in MESH13E:
        got[name] = mesh13e_run(os.path.join(ranks, f"ppo_{name}"), shape, per_device, fault,
                                rm_dir, int(seed))
    if tdist.get_rank() == 0:
        torch.save(got, os.path.join(ranks, "13e.pt"))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def ppo_layouts_report(got: dict, names: list, world1: dict, out: str, rm_dir: str,
                       seed: int = 1, layers: int = 2) -> dict:
    """{name: report} of each layout's run in `got` against world 1: the
    rollout tokens equal, or where they part a top-2 tie on world 1's
    replay (mesh13e_ties), the raw scores' gap relative to world 1's
    largest |score|, the first update's gradients' worst leaf against
    world 1's replay of the layout's tokens and scores (and the worst but
    the value head's, "other"); "passes" when the tokens hold, the scores
    are within PPO_SCORE_TOL and the gradients within PPO_GRAD_TOL."""
    report, replays = {}, {}
    w1 = np.asarray(world1["raw_scores"], np.float64)
    for name in names:
        g = got[name]
        key = (repr(g["tokens"]), g["raw_scores"].tobytes())
        if key not in replays:  # a fault in the update shares its layout's rollout
            replays[key] = mesh13e_run(os.path.join(out, f"replay_{name}"), None,
                                       len(PPO13E_WORDS), None, rm_dir, seed,
                                       replay=(g, world1["tokens"]), layers=layers)
        ref = replays[key]
        gap, leaf = grad_gap(g, ref) if "grads" in ref else (math.inf, "tokens")
        score_gap = float(np.abs(np.asarray(g["raw_scores"], np.float64) - w1).max()
                          / np.abs(w1).max())
        report[name] = {"tokens_equal": g["tokens"] == world1["tokens"],
                        "ties": ref["ties"], "not_tie": ref["not_tie"],
                        "score_gap": score_gap, "grad_gap": gap, "leaf": leaf,
                        "other": grad_gap(g, ref, skip=("v_head/kernel",))
                        if "grads" in ref else None,
                        "scores": g["scores"], "step_s": round(g["step_s"], 3),
                        "kl_coef": g["metrics"][-1].get("ppo/kl_coef"),
                        "mean_score": g["metrics"][-1].get("ppo/mean_score")}
        report[name]["passes"] = not ref["not_tie"] and score_gap <= PPO_SCORE_TOL and \
            gap <= PPO_GRAD_TOL
    return report


def mesh13e_check(ranks: str, started: list, world1: dict, rm_dir: str, seed: int = 1) -> dict:
    """13e's checks once its ranks are done, for each layout: the greedy
    rollout tokens equal world 1's, or differ only from a top-2 tie on
    (mesh13e_ties); the reward scores within PPO_SCORE_TOL of world 1's;
    the first update's gradients within PPO_GRAD_TOL at every leaf of
    world 1's replay of the layout's tokens and scores (whitened
    advantages magnify the rewards' bf16 noise by the batch's score
    spread, so the update is held on the same inputs). model = 2 and fsdp
    = 2 pass all three, each planted fault fails one; kernels 1-4 launched
    on model = 2's rank 0 ("mesh_ppo"). Each layout's line also reads the
    worst leaf but the value head ("other"). Returns those launches."""
    for i, st in enumerate(started):
        finish_logged(st, f"13e rank {i}")
    got = torch.load(os.path.join(ranks, "13e.pt"), weights_only=False)
    report = ppo_layouts_report(got, [name for name, *_ in MESH13E], world1, ranks, rm_dir,
                                seed)
    print(f"13e (seed {seed}) ppo on two ranks sharing the card (gloo), one outer step of "
          f"{len(PPO13E_WORDS)} image prompts, 16 greedy tokens: world 1 resp_lens "
          f"{world1['resp_lens']} scores {world1['scores']} mean_score "
          f"{world1['metrics'][-1]['ppo/mean_score']:.6g} step {world1['step_s']:.3f} s; "
          + json.dumps(report) + f"; bounds: scores {PPO_SCORE_TOL}, gradients {PPO_GRAD_TOL} "
          f"(each planted fault must fail one); "
          f"model2 rank 0 launches {json.dumps(got['model2']['launches'])}", flush=True)
    for name, _, _, fault in MESH13E:
        r = report[name]
        if fault is None and not r["passes"]:
            raise AssertionError(f"13e {name}: against world 1: {r}")
        if fault is not None and r["passes"]:
            raise AssertionError(f"13e {name}: the planted fault ({fault}) passed: {r}")
    launches = got["model2"]["launches"]
    if any(launches[n] <= 0 for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                                      "decode_attention")):
        raise AssertionError(f"13e (mesh_ppo) must launch kernels 1-4: {launches}")
    return launches


def study_13e(seeds=(2, 3, 4, 5, 6, 7, 8, 9)) -> None:
    """13e at other seeds, each against its own world 1 at the same
    bounds, with both planted faults: seed s takes the model's
    weights from s, the reward model from 20 + s and prompts 4 (s - 1) to
    4 s - 1 (13e itself is seed 1). Prints each seed's 13e line; raises
    at the end if any seed failed. Not part of the script's run; on the
    card: `python -c "import chip_smoke as c; c.phase_build();
    c.study_13e()"`."""
    import shutil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = _build_dir("study13e")
    failed = []
    try:
        for seed in seeds:
            ranks = os.path.join(out, f"seed{seed}")
            os.makedirs(ranks)
            rm_dir = mesh13e_reward(os.path.join(ranks, "rm"), seed)
            env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(_free_port()))
            started = [start_logged([sys.executable, os.path.abspath(__file__),
                                     "--mesh13e-worker", ranks, rm_dir, str(seed)],
                                    env=dict(env, RANK=str(r))) for r in range(2)]
            try:
                world1 = mesh13e_run(os.path.join(ranks, "ppo_world1"), None,
                                     len(PPO13E_WORDS), None, rm_dir, seed)
                mesh13e_check(ranks, started, world1, rm_dir, seed)
            except AssertionError as e:
                failed.append(f"seed {seed}: {str(e)[:2000]}")
                print(f"13e seed {seed} FAILED: {str(e)[:2000]}", flush=True)
            finally:
                for proc, _ in started:
                    if proc.poll() is None:
                        proc.kill()
                        proc.communicate()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if failed:
        raise AssertionError("13e at other seeds: " + "; ".join(failed))


# 14b: dpo under --sequence_parallel_axis fsdp on two gloo ranks sharing the
# card (mesh (1, 2, 1): both ranks read the pair, each holds 2,048 of its
# 4,096 positions), against world 1 in this process. pair_row's words make
# rows of 4,084 and 3,884 tokens (576 image tokens among them): S = 4096,
# LLaVA-1.5-7B's position table, so the ring's two shards split at 2,048.
MESH14_PAIR = (14, 1200, 2300, 2100)
MESH14 = (("sp2", False, 3), ("sp2_planted", True, 1))  # (name, planted fault, updates)


@contextlib.contextmanager
def sp_partials_averaged():
    """14b's planted fault for the block: dpo_step's loss is not scaled by
    the ring's size, so FSDP2's mean over the fsdp ranks averages the
    ring's gradient partials instead of summing them."""
    from vlrlhf_torch.train import dpo

    kept = dpo.ring_size
    dpo.ring_size = lambda: 1
    try:
        yield
    finally:
        dpo.ring_size = kept


def mesh14_run(out: str, sp: bool, updates: int = 3) -> dict:
    """One 14b run (mesh13d_run): the S = 4096 pair, one pair per global
    batch, no gradient clipping; under the sequence-parallel mesh (1, 2, 1)
    with `sp`, else world 1."""
    return mesh13d_run(out, (1, 2, 1) if sp else None, per_device=1, updates=updates,
                       sp="fsdp" if sp else "", rows=[pair_row(*MESH14_PAIR)], max_length=4096,
                       clip=False)


def mesh14_worker(out: str) -> int:
    """A rank of 14b (started by phase_launchers with torchrun's
    environment): gloo on cuda:0, each MESH14 run in turn; rank 0 writes
    {name: mesh13d_run's result} to `out` (torch.save)."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    got = {}
    for name, planted, updates in MESH14:
        with sp_partials_averaged() if planted else contextlib.nullcontext():
            got[name] = mesh14_run(os.path.join(os.path.dirname(out), name), True, updates)
    if tdist.get_rank() == 0:
        torch.save(got, out)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def mesh14_check(got14: str, world1: dict) -> dict:
    """14b's checks: the first update's gradients leaf by leaf within
    MESH_GRAD_TOL of world 1's and the planted fault beyond it, step-1
    loss ln 2, the step-1 gradient norm within 1e-2 of world 1's, kernels
    1-3 launched on rank 0; prints each rank's peak memory beside world
    1's. Returns rank 0's launches ("mesh_dpo_sp")."""
    got = torch.load(got14, weights_only=False)
    sp2 = got["sp2"]
    gaps = {k: grad_gap(got[k], world1) for k in ("sp2", "sp2_planted")}
    print(f"14b dpo --mesh_fsdp 2 --sequence_parallel_axis fsdp, two gloo ranks on one card "
          f"(LLaVA-1.5-7B widths, 2 LM / 2 tower layers, one pair at S = {sp2['seq']}, the ring "
          f"of two): losses / grad norms {sp2['losses']} / {sp2['norms']} vs world 1 "
          f"{world1['losses']} / {world1['norms']} (S = {world1['seq']}); first update's "
          f"gradients, worst leaf's relative L2 gap (leaf) "
          + json.dumps({k: (round(v, 6), leaf) for k, (v, leaf) in gaps.items()})
          + f", tol {MESH_GRAD_TOL} (the planted fault, the ring's partials averaged, must exceed "
          f"it); per rank resident {[round(x, 3) for x in sp2['resident_gib']]} GiB and the "
          f"steps' peak above it {[round(x, 3) for x in sp2['peak_gib']]} GiB vs world 1 "
          f"{round(world1['resident_gib'][0], 3)} / {round(world1['peak_gib'][0], 3)} GiB; "
          f"launches rank 0 {json.dumps(sp2['launches'])}",
          flush=True)
    for k, (v, leaf) in gaps.items():
        if (v > MESH_GRAD_TOL) != k.endswith("planted"):
            raise AssertionError(f"14b {k}: the first update's gradients are {v} apart at {leaf} "
                                 f"(tol {MESH_GRAD_TOL})")
    if sp2["seq"] != 4096 or world1["seq"] != 4096:
        raise AssertionError(f"14b: the pair is not at S = 4096: {sp2['seq']} / {world1['seq']}")
    if len(sp2["losses"]) != 3 or not np.isfinite(sp2["losses"]).all() or \
            abs(sp2["losses"][0] - math.log(2.0)) > 1e-6 or \
            abs(sp2["norms"][0] - world1["norms"][0]) > 1e-2 * world1["norms"][0]:
        raise AssertionError(f"14b: {sp2['losses']} / {sp2['norms']}: step 1 must read ln 2 and "
                             f"world 1's norm {world1['norms'][0]}")
    if min(sp2["launches"].values()) <= 0:
        raise AssertionError(f"14b: a flash kernel was not launched: {sp2['launches']}")
    return sp2["launches"]


# 15: dpo under --mesh_pipe 2 (the GPipe pipeline, 2 microbatches) on two
# gloo ranks sharing the card: mesh (1, 1, 1, 2), stage 0 holding LM layers
# 0-1 and stage 1 layers 2-3, both reading phase 6's pair (rows of 994 and
# 984 tokens at S = 1024: a microbatch is one row), LLaVA-1.5-7B's widths
# at 4 LM / 2 tower layers, against world 1 in this process.
PHASE15_LAYERS, PHASE15_MICRO = 4, 2
MESH15 = (("pipe2", False, 3), ("pipe2_planted", True, 1))  # (name, planted fault, updates)


@contextlib.contextmanager
def hop_off_by_one():
    """15's planted fault for the block: each hop hands the receiving stage
    the previous microbatch's tensor (the first of each direction its
    own), so stage 1 runs microbatch i's rows on microbatch i - 1's
    activations and stage 0 backpropagates microbatch i + 1's gradient."""
    from vlrlhf_torch.models.lm import pipeline

    kept = pipeline.pipe_recv
    last = {}

    def shifted(shape, dtype, device, pp, stage):
        got = kept(shape, dtype, device, pp, stage)
        prev = last.get(stage, got)
        last[stage] = got
        return prev if prev.shape == got.shape else got

    pipeline.pipe_recv = shifted
    try:
        yield
    finally:
        pipeline.pipe_recv = kept


def mesh15_run(out: str, pipe: bool, updates: int = 3) -> dict:
    """One 15 run (mesh13d_run): phase 6's pair, one pair per global batch,
    no gradient clipping, 4 LM layers; under the pipeline (1, 1, 1, 2) with
    PHASE15_MICRO microbatches with `pipe`, else world 1."""
    return mesh13d_run(out, (1, 1, 1, 2) if pipe else None, per_device=1, updates=updates,
                       rows=[pair_row(7, 150, 260, 250)], clip=False, layers=PHASE15_LAYERS,
                       micro=PHASE15_MICRO if pipe else 0)


def mesh15_worker(out: str) -> int:
    """A rank of 15 (started by phase_launchers with torchrun's
    environment): gloo on cuda:0, each MESH15 run in turn; rank 0 writes
    {name: mesh13d_run's result} to `out` (torch.save)."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    got = {}
    for name, planted, updates in MESH15:
        with hop_off_by_one() if planted else contextlib.nullcontext():
            got[name] = mesh15_run(os.path.join(os.path.dirname(out), name), True, updates)
    if tdist.get_rank() == 0:
        torch.save(got, out)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def pipeline_local_check() -> dict:
    """15a, in this process: models/lm/pipeline.py's schedule with both
    stages here (`pipeline_local`, S = 2, M = 2) against the plain stack
    (`run_layers` on the whole batch), on the card with the kernels, at
    15's shapes: LLaVA-1.5-7B's widths at 4 layers, LoRA r64 on every
    linear (b seeded non-zero), attn remat, random embeddings of phase 6's
    two rows (994 and 984 tokens at S = 1024). The stack's output and the
    gradients of the embeddings and of every adapter leaf within
    MESH_GRAD_TOL (relative L2; the microbatches' products are one row
    each, the plain stack's two, so cuBLAS may sum otherwise), and each
    path's kernel launches. Returns the gaps and the launches."""
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora, lora_parameters
    from vlrlhf_torch.models.common import Ctx, init_random_
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.lm.llama import LlamaDecoder
    from vlrlhf_torch.models.lm.pipeline import pipeline_local
    from vlrlhf_torch.ops.rope import rope_frequencies

    cfg = mesh_2layer_cfg().lm
    cfg = dataclasses.replace(cfg, num_layers=PHASE15_LAYERS)
    holder = torch.nn.Module()
    holder.lm = init_random_(LlamaDecoder(cfg, "cuda"), torch.Generator(device="cuda").manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    init_lora(holder, LoraConfig(r=64, alpha=16.0, target_patterns=FAMILIES["llava"].lora_targets),
              gen)
    params = [p for _, p in lora_parameters(holder)]
    with torch.no_grad():
        for p in params[1::2]:
            p.copy_(1e-3 * torch.randn(p.shape, device="cuda", generator=gen))
    b, s = 2, 1024
    x0 = torch.randn((b, s, cfg.hidden_size), device="cuda", generator=gen).to(cfg.dtype)
    pad = torch.arange(s, device="cuda")[None] < torch.tensor([994, 984], device="cuda")[:, None]
    cos, sin = rope_frequencies(cfg.rope, torch.arange(s, device="cuda")[None].expand(b, s),
                                seq_len=s)
    ctx = Ctx(adapters=True, lora_scale=0.25).sub("lm").sub("layers_scanned")
    dy = torch.randn((b, s, cfg.hidden_size), device="cuda", generator=gen).to(cfg.dtype)
    fns = counted(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    got = {}
    for name in ("plain", "pipeline_local"):
        x = x0.clone().requires_grad_()
        for p in params:
            p.grad = None
        zero_counts(fns)
        if name == "plain":
            h = holder.lm.run_layers(x, cos, sin, pad, ctx)
        else:
            h = pipeline_local(holder.lm, 2, PHASE15_MICRO, x, cos, sin, pad, ctx)
        h.backward(dy)
        torch.cuda.synchronize()
        got[name] = (h.detach().float(), x.grad.float(), [p.grad.float().clone() for p in params],
                     read_counts(fns))

    def gap(a, w):
        return float((a - w).norm() / w.norm()) if float(w.norm()) > 0 else float((a - w).norm())

    (ho, xo, go, lo), (hp, xp, gp, lp) = got["plain"], got["pipeline_local"]
    gaps = {"out": gap(hp[pad], ho[pad]), "dx": gap(xp[pad], xo[pad]),
            "adapters": max(gap(a, w) for a, w in zip(gp, go))}
    print(f"15a pipeline_local (S = 2, M = 2) vs the plain stack on the card (LLaVA-1.5-7B "
          f"widths, {PHASE15_LAYERS} layers, LoRA r64, attn remat, rows of 994 / 984 at "
          f"S = 1024): relative L2 gaps {json.dumps({k: round(v, 6) for k, v in gaps.items()})} "
          f"(tol {MESH_GRAD_TOL}); launches plain {json.dumps(lo)}, pipeline_local "
          f"{json.dumps(lp)}", flush=True)
    if max(gaps.values()) > MESH_GRAD_TOL or min(lp.values()) <= 0:
        raise AssertionError(f"15a: pipeline_local departs from the plain stack: {gaps} {lp}")
    del holder, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"gaps": gaps, "launches": lp}


def mesh15_check(got15: str, world1: dict) -> dict:
    """15's checks: the first update's gradients leaf by leaf within
    MESH_GRAD_TOL of world 1's and the planted fault beyond it, step-1
    loss ln 2, the step-1 gradient norm within 1e-2 of world 1's, each
    stage's launches of kernels 1-3 at the counts the schedule implies
    (per update: M x L / S layer calls of kernels 2 and 3, twice that of
    kernel 1 under attn remat, plus the tower's, which world 1 shows);
    prints each rank's resident and step peak beside world 1's. Returns
    rank 0's launches ("mesh_dpo_pipe")."""
    got = torch.load(got15, weights_only=False)
    p2 = got["pipe2"]
    gaps = {k: grad_gap(got[k], world1) for k in ("pipe2", "pipe2_planted")}
    updates, n_layers = len(p2["losses"]), PHASE15_LAYERS
    lm_calls = updates * PHASE15_MICRO * (n_layers // 2)
    tower = world1["launches"]["flash_fwd"] - 2 * updates * n_layers
    want = {"flash_fwd": 2 * lm_calls + tower, "flash_bwd_dkv": lm_calls, "flash_bwd_dq": lm_calls}
    print(f"15 dpo --mesh_pipe 2 --pipeline_microbatches {PHASE15_MICRO}, two gloo ranks on one "
          f"card (LLaVA-1.5-7B widths, {n_layers} LM / 2 tower layers, one pair at S = "
          f"{p2['seq']}, bubble {1 / (PHASE15_MICRO + 1):.4f} of the steps): losses / grad norms "
          f"{p2['losses']} / {p2['norms']} vs world 1 {world1['losses']} / {world1['norms']}; "
          f"first update's gradients, worst leaf's relative L2 gap (leaf) "
          + json.dumps({k: (round(v, 6), leaf) for k, (v, leaf) in gaps.items()})
          + f", tol {MESH_GRAD_TOL} (the planted fault, the hop off by one microbatch, must "
          f"exceed it); per rank resident {[round(x, 3) for x in p2['resident_gib']]} GiB and "
          f"the steps' peak above it {[round(x, 3) for x in p2['peak_gib']]} GiB vs world 1 "
          f"{round(world1['resident_gib'][0], 3)} / {round(world1['peak_gib'][0], 3)} GiB; "
          f"launches per rank {json.dumps(p2['rank_launches'])} (the schedule's "
          f"{json.dumps(want)}), world 1 {json.dumps(world1['launches'])}", flush=True)
    for k, (v, leaf) in gaps.items():
        if (v > MESH_GRAD_TOL) != k.endswith("planted"):
            raise AssertionError(f"15 {k}: the first update's gradients are {v} apart at {leaf} "
                                 f"(tol {MESH_GRAD_TOL})")
    if len(p2["grads"]) != len(world1["grads"]):
        raise AssertionError(f"15: {len(p2['grads'])} gradient leaves joined from the stages, "
                             f"world 1 has {len(world1['grads'])}")
    if len(p2["losses"]) != 3 or not np.isfinite(p2["losses"]).all() or \
            abs(p2["losses"][0] - math.log(2.0)) > 1e-6 or \
            abs(p2["norms"][0] - world1["norms"][0]) > 1e-2 * world1["norms"][0]:
        raise AssertionError(f"15: {p2['losses']} / {p2['norms']}: step 1 must read ln 2 and "
                             f"world 1's norm {world1['norms'][0]}")
    if any(r != want for r in p2["rank_launches"]):
        raise AssertionError(f"15: the stages' launches {p2['rank_launches']} are not the "
                             f"schedule's {want}")
    return p2["launches"]


# 16: ppo and dpo's --eval_samples under the pipeline, two gloo ranks
# sharing the card: mesh (1, 1, 1, 2) with PHASE16_MICRO microbatches,
# stage 0 holding LM layers 0-1 and stage 1 layers 2-3, LLaVA-1.5-7B's
# widths at 4 LM / 2 tower layers; the rollouts and the samples on the whole
# stack (core/partitioning.py whole_stack), the reward, stats and update
# through the schedule; against world 1 in this process.
PHASE16_LAYERS, PHASE16_MICRO = 4, 2
MESH16 = (("pipe2", None), ("pipe2_stage_order", "stage_order"))  # (name, planted fault)
MESH16_PAIRS = 4  # 16's dpo rows: 2 train pairs and a holdout of 2 (--eval_ratio 0.5)


@contextlib.contextmanager
def generated_ids(out: list):
    """Each Generator call's (adapters on, tokens on the host) appended to
    `out`: the token ids behind make_eval_hook's decoded samples."""
    from vlrlhf_torch.generate.engine import Generator

    kept = Generator.__call__

    def call(self, *a, **k):
        res = kept(self, *a, **k)
        out.append((self.adapters, (res[0] if isinstance(res, tuple) else res).cpu().tolist()))
        return res

    Generator.__call__ = call
    try:
        yield
    finally:
        Generator.__call__ = kept


def mesh16_samples(out: str, shape, against=None) -> dict:
    """16's `dpo --eval_samples 2`: LLaVA-1.5-7B's widths at PHASE16_LAYERS
    LM / 2 tower layers (seeded bf16 on cuda:0), MESH16_PAIRS image pairs
    of which 2 are held out (--eval_steps 1 --eval_ratio 0.5), build_dpo
    and make_eval_hook's call at step 1: the holdout's eval pass (through
    the schedule under `shape`'s pipeline) and the greedy 64-token policy
    and reference samples (on the whole stack under the pipeline),
    dpo_samples.jsonl written by rank 0. Returns the samples' tokens
    {"policy", "ref"} (one list per holdout row) and the eval pass's
    metrics. With `against` (world 1 only: a layout's result) also
    {"ties", "not_tie"} of each row whose tokens differ (mesh13e_ties, the
    adapters on for the policy's, off for the reference's)."""
    import types

    from vlrlhf_torch.cli.main import build_dpo, make_eval_hook, make_logger
    from vlrlhf_torch.core.mesh import MeshConfig, make_mesh, set_global_mesh
    from vlrlhf_torch.data.collators import GenerationCollator
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM

    cfg = mesh_2layer_cfg()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=PHASE16_LAYERS))
    mesh = (make_mesh(MeshConfig(*shape), "cuda", microbatches=PHASE16_MICRO)
            if shape is not None else None)
    try:
        model = VLM(cfg, "cuda")
        init_random_(model, torch.Generator(device="cuda").manual_seed(1))
        args = dpo_args(output_dir=out, eval_steps=1, eval_ratio=0.5, eval_samples=2,
                        precompute_ref_logps=False, run_name=None)
        proc = make_processor(cfg)
        rows = [pair_row(20 + i, 60 + 10 * i, 40, 50) for i in range(MESH16_PAIRS)]
        run = build_dpo(cfg, model, proc, args, rows, seeded_image)
        os.makedirs(out, exist_ok=True)
        logger = make_logger(args, "dpo", run)
        ids: list = []
        with generated_ids(ids):
            make_eval_hook(run, proc, args, logger)(1)
        logger.close()
        got = {"adapters": [on for on, _ in ids], "policy": ids[0][1], "ref": ids[1][1],
               "metrics": _metrics_lines(os.path.join(out, "dpo_metrics.jsonl"))
               if os.path.exists(os.path.join(out, "dpo_metrics.jsonl")) else []}
        if against is not None:
            like = types.SimpleNamespace(
                model=run.model, lcfg=run.lcfg,
                gen_collator=GenerationCollator(proc, run.collator.cfg, run.collator.image_loader))
            got["ties"], got["not_tie"] = [], []
            for kind in ("policy", "ref"):
                t = mesh13e_ties(like, run.eval_rows, {"tokens": against[kind]}, got[kind],
                                 adapters=kind == "policy")
                got["ties"] += [(kind, *x) for x in t["ties"]]
                got["not_tie"] += [(kind, *x) for x in t["not_tie"]]
        del run, model
    finally:
        set_global_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
    return got


def mesh16_worker(out: str, rm_dir: str) -> int:
    """A rank of 16 (started by phase_launchers with torchrun's
    environment): gloo on cuda:0; each MESH16 ppo run (mesh13e_run under
    (1, 1, 1, 2), PHASE16_MICRO microbatches, PHASE16_LAYERS layers), then
    the dpo samples (mesh16_samples); rank 0 writes {name: result,
    "samples": ...} to <out>/16.pt."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    got = {}
    for name, fault in MESH16:
        got[name] = mesh13e_run(os.path.join(out, f"ppo_{name}"), (1, 1, 1, 2),
                                len(PPO13E_WORDS), fault, rm_dir, layers=PHASE16_LAYERS,
                                micro=PHASE16_MICRO)
    got["samples"] = mesh16_samples(os.path.join(out, "samples"), (1, 1, 1, 2))
    if tdist.get_rank() == 0:
        torch.save(got, os.path.join(out, "16.pt"))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def mesh16_check(out: str, started: list, world1: dict, samples1: dict, rm_dir: str) -> dict:
    """16's checks once its ranks are done: for ppo under the pipeline, the
    greedy rollout tokens equal world 1's or part only at a top-2 tie, the
    reward scores within PPO_SCORE_TOL and the first update's gradients
    within PPO_GRAD_TOL at every leaf of world 1's replay
    (ppo_layouts_report), and the planted fault (the whole stack joined in
    reverse stage order) fails them; each rank's launches at the design's
    counts: kernel 4 decode steps x all PHASE16_LAYERS layers (the whole
    stack on every rank), kernels 2 and 3 updates x M x L / S, kernel 1 the
    rollout's prefill on L layers plus (reward, stats' policy and
    reference passes, the update's forward twice under attn remat) x M x
    L / S, plus the tower's calls, which world 1 shows; each rank's
    resident memory, rollout and update peaks beside world 1's; the dpo
    samples' tokens equal world 1's or part only at a tie. Returns rank
    0's launches ("mesh_ppo_pipe")."""
    for i, st in enumerate(started):
        finish_logged(st, f"16 rank {i}")
    got = torch.load(os.path.join(out, "16.pt"), weights_only=False)
    report = ppo_layouts_report(got, [name for name, _ in MESH16], world1, out, rm_dir,
                                layers=PHASE16_LAYERS)
    p2, n_layers, stages, micro = got["pipe2"], PHASE16_LAYERS, 2, PHASE16_MICRO
    updates = 1
    per_pass = micro * (n_layers // stages)
    tower = world1["launches"]["flash_fwd"] - n_layers * (1 + 3 + 2 * updates)
    want = [{"flash_fwd": tower + n_layers + (3 + 2 * updates) * per_pass,
             "flash_bwd_dkv": updates * per_pass, "flash_bwd_dq": updates * per_pass,
             "decode_attention": r["decode_steps"] * n_layers} for r in p2["ranks"]]
    samples = got["samples"]
    same = {k: samples[k] == samples1[k] for k in ("policy", "ref")}
    ties = {"ties": [], "not_tie": []}
    if not all(same.values()):
        ties = mesh16_samples(os.path.join(out, "samples_ties"), None, against=samples)
    w1 = world1["ranks"][0]
    mem_keys = ("resident_gib", "rollout_peak_gib", "update_peak_gib")
    mem = [[round(r[k], 3) for k in mem_keys] for r in p2["ranks"]]
    print(f"16 ppo --mesh_pipe 2 --pipeline_microbatches {micro}, two gloo ranks on one card "
          f"(LLaVA-1.5-7B widths, {n_layers} LM / 2 tower layers, one outer step of "
          f"{len(PPO13E_WORDS)} image prompts, 16 greedy tokens on the whole stack): world 1 "
          f"resp_lens {world1['resp_lens']} scores {world1['scores']} step "
          f"{world1['step_s']:.3f} s; " + json.dumps(report)
          + f"; bounds: scores {PPO_SCORE_TOL}, gradients {PPO_GRAD_TOL} (the planted fault, "
          f"the stack joined in reverse stage order, must fail one); per rank resident / "
          f"rollout peak / update peak above it {mem} GiB vs world 1 "
          f"{[round(w1[k], 3) for k in mem_keys]} GiB; decode steps per rank {[r['decode_steps'] for r in p2['ranks']]} (world 1 "
          f"{w1['decode_steps']}); launches per rank {json.dumps(p2['rank_launches'])} (the "
          f"design's {json.dumps(want)}), world 1 {json.dumps(world1['launches'])}", flush=True)
    print(f"16 dpo --eval_samples 2 under --mesh_pipe 2: greedy 64-token samples of the 2 "
          f"holdout prompts equal world 1's {same}, ties {ties['ties']}, not ties "
          f"{ties['not_tie']}; eval pass {samples['metrics']} vs world 1 {samples1['metrics']}",
          flush=True)
    for name, fault in MESH16:
        r = report[name]
        if fault is None and not r["passes"]:
            raise AssertionError(f"16 {name}: against world 1: {r}")
        if fault is not None and r["passes"]:
            raise AssertionError(f"16 {name}: the planted fault ({fault}) passed: {r}")
    if p2["rank_launches"] != want or min(r["decode_steps"] for r in p2["ranks"]) <= 0 or \
            any(r["decode_steps"] != w1["decode_steps"] for r in p2["ranks"]):
        raise AssertionError(f"16: the ranks' launches {p2['rank_launches']} are not the "
                             f"design's {want}, or their decode steps differ from world 1's")
    if ties["not_tie"] or samples["adapters"] != [True, False] or len(samples["policy"]) != 2:
        raise AssertionError(f"16: the pipeline's dpo samples part from world 1's, not at a tie: "
                             f"{ties['not_tie']}")
    return p2["launches"]


# 17: the sequence split over the tensor-parallel ranks
# (--sequence_parallel_axis model) on two gloo ranks sharing the card.
# 17a: 14b's S = 4096 pair and 2 LM / 2 tower layers at (1, 1, 2) under
# the split, beside --mesh_model 2 alone on the same pair and a planted
# fault, each against 14b's world 1. 17b: 13e's ppo outer step at
# (1, 1, 2) under the model split and at (1, 2, 1) under the fsdp ring,
# each against 13e's world 1.
# (name, --sequence_parallel_axis, planted fault, updates)
MESH17A = (("sp_model2", "model", False, 2), ("model2", "", False, 2),
           ("sp_model2_planted", "model", True, 1))
# (name, (data, fsdp, model), --sequence_parallel_axis): 4 rows per
# data-parallel rank, the global batch of 4 either way
MESH17B = (("sp_model2", (1, 1, 2), "model"), ("sp_fsdp2", (1, 2, 1), "fsdp"))


@contextlib.contextmanager
def tp_partials_unsummed():
    """17a's planted fault for the block: the gradients of the leaves
    replicated over model (a rank's slice's partials under the model
    split) are not summed over the tensor-parallel group
    (train/train_state.py tp_sum dropped)."""
    from vlrlhf_torch.core import partitioning

    kept = partitioning.attach_norm_groups_

    def unsummed(state, keys, mesh):
        kept(state, keys, mesh)
        state.tp_sum = None

    partitioning.attach_norm_groups_ = unsummed
    try:
        yield
    finally:
        partitioning.attach_norm_groups_ = kept


def mesh17_worker(out: str, rm_dir: str) -> int:
    """A rank of 17 (started by phase_launchers with torchrun's
    environment): gloo on cuda:0; each MESH17A dpo run (mesh13d_run on
    14b's pair under (1, 1, 2)), then each MESH17B ppo run (mesh13e_run);
    rank 0 writes {"dpo": {name: result}, "ppo": {name: result}} to
    <out>/17.pt."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    got = {"dpo": {}, "ppo": {}}
    for name, axis, planted, updates in MESH17A:
        with tp_partials_unsummed() if planted else contextlib.nullcontext():
            got["dpo"][name] = mesh13d_run(
                os.path.join(out, f"dpo_{name}"), (1, 1, 2), per_device=1, updates=updates,
                sp=axis, rows=[pair_row(*MESH14_PAIR)], max_length=4096, clip=False)
    for name, shape, axis in MESH17B:
        got["ppo"][name] = mesh13e_run(os.path.join(out, f"ppo_{name}"), shape,
                                       len(PPO13E_WORDS), None, rm_dir, sp=axis)
    if tdist.get_rank() == 0:
        torch.save(got, os.path.join(out, "17.pt"))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def mesh17_check(out: str, started: list, world14: dict, world13e: dict, rm_dir: str) -> dict:
    """17's checks once its ranks are done. 17a: the first update's
    gradients leaf by leaf within MESH_GRAD_TOL of 14b's world 1 under the
    split and under --mesh_model 2 alone, the planted fault (the
    replicated leaves' partials not summed) beyond it, step-1 loss ln 2 and
    the gradient norm within 1e-2 of world 1's, each rank's kernels 1-3
    launches equal to --mesh_model 2's (one call per layer and pass, not
    one per ring block), each rank's resident and step peak memory beside
    --mesh_model 2's. 17b: ppo_layouts_report against 13e's world 1 (the
    tokens equal or part only at a top-2 tie, the scores within
    PPO_SCORE_TOL, the first update within PPO_GRAD_TOL), kernel 4 on
    every rank at 13e's world-1 count (decode steps x layers). Returns
    rank 0's launches: 17a's under the split ("mesh_dpo_sp_model") and
    17b's under the model split ("mesh_ppo_sp")."""
    for i, st in enumerate(started):
        finish_logged(st, f"17 rank {i}")
    got = torch.load(os.path.join(out, "17.pt"), weights_only=False)
    dpo = got["dpo"]
    sp, tp = dpo["sp_model2"], dpo["model2"]
    gaps = {k: grad_gap(dpo[k], world14) for k in ("sp_model2", "model2", "sp_model2_planted")}
    print(f"17a dpo --mesh_model 2 --sequence_parallel_axis model, two gloo ranks on one card "
          f"(LLaVA-1.5-7B widths, 2 LM / 2 tower layers, one pair at S = {sp['seq']}): losses / "
          f"grad norms {sp['losses']} / {sp['norms']}, --mesh_model 2 alone {tp['losses']} / "
          f"{tp['norms']}, world 1 {world14['losses']} / {world14['norms']}; first update's "
          f"gradients, worst leaf's relative L2 gap to world 1 (leaf) "
          + json.dumps({k: (round(v, 6), leaf) for k, (v, leaf) in gaps.items()})
          + f", tol {MESH_GRAD_TOL} (the planted fault, the replicated leaves' partials not "
          f"summed over the group, must exceed it); per rank resident "
          f"{[round(x, 3) for x in sp['resident_gib']]} GiB and the steps' peak above it "
          f"{[round(x, 3) for x in sp['peak_gib']]} GiB vs --mesh_model 2 alone "
          f"{[round(x, 3) for x in tp['resident_gib']]} / {[round(x, 3) for x in tp['peak_gib']]} "
          f"GiB and world 1 {round(world14['resident_gib'][0], 3)} / "
          f"{round(world14['peak_gib'][0], 3)} GiB; launches per rank "
          f"{json.dumps(sp['rank_launches'])}, --mesh_model 2 alone "
          f"{json.dumps(tp['rank_launches'])}", flush=True)
    for k, (v, leaf) in gaps.items():
        if (v > MESH_GRAD_TOL) != k.endswith("planted"):
            raise AssertionError(f"17a {k}: the first update's gradients are {v} apart at "
                                 f"{leaf} (tol {MESH_GRAD_TOL})")
    if sp["seq"] != 4096:
        raise AssertionError(f"17a: the pair is not at S = 4096: {sp['seq']}")
    for name, r in (("sp_model2", sp), ("model2", tp)):
        if not np.isfinite(r["losses"]).all() or abs(r["losses"][0] - math.log(2.0)) > 1e-6 or \
                abs(r["norms"][0] - world14["norms"][0]) > 1e-2 * world14["norms"][0]:
            raise AssertionError(f"17a {name}: {r['losses']} / {r['norms']}: step 1 must read "
                                 f"ln 2 and world 1's norm {world14['norms'][0]}")
    if sp["rank_launches"] != tp["rank_launches"] or min(sp["launches"].values()) <= 0:
        raise AssertionError(f"17a: the split's launches {sp['rank_launches']} are not "
                             f"--mesh_model 2's {tp['rank_launches']}")
    ppo = got["ppo"]
    report = ppo_layouts_report(ppo, [name for name, *_ in MESH17B], world13e, out, rm_dir)
    w1 = world13e["ranks"][0]
    want4 = w1["decode_steps"] * 2  # 2 LM layers, every rank decoding every row of its group
    print(f"17b ppo under the sequence split, two gloo ranks on one card (13e's outer step: "
          f"{len(PPO13E_WORDS)} image prompts, 16 greedy tokens generated unsplit): "
          + json.dumps(report) + f"; bounds: scores {PPO_SCORE_TOL}, gradients {PPO_GRAD_TOL}; "
          f"launches per rank " + json.dumps({k: v["rank_launches"] for k, v in ppo.items()})
          + f", decode steps per rank "
          + json.dumps({k: [r["decode_steps"] for r in v["ranks"]] for k, v in ppo.items()})
          + f" (world 1 {w1['decode_steps']}), resident / rollout peak / update peak GiB per "
          f"rank " + json.dumps({k: [[round(r[m], 3) for m in ("resident_gib", "rollout_peak_gib",
                                                               "update_peak_gib")]
                                     for r in v["ranks"]] for k, v in ppo.items()}), flush=True)
    for name, *_ in MESH17B:
        if not report[name]["passes"]:
            raise AssertionError(f"17b {name}: against world 1: {report[name]}")
        counts = [r["decode_attention"] for r in ppo[name]["rank_launches"]]
        if counts != [want4] * len(counts):
            raise AssertionError(f"17b {name}: kernel 4 launched {counts} times per rank, "
                                 f"the design's {want4} (decode steps x layers)")
    launches = ppo["sp_model2"]["launches"]
    if any(launches[n] <= 0 for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                                      "decode_attention")):
        raise AssertionError(f"17b (mesh_ppo_sp) must launch kernels 1-4: {launches}")
    return {"mesh_dpo_sp_model": sp["launches"], "mesh_ppo_sp": launches}


def mesh13d_worker(out: str) -> int:
    """A rank of 13d (started by phase_launchers with torchrun's
    environment): gloo on cuda:0, each MESH13D layout in turn; rank 0
    writes {name: mesh13d_run's result} to `out` (torch.save)."""
    import faulthandler

    import torch.distributed as tdist

    faulthandler.enable()
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo")
    got = {}
    for name, shape, per_device, updates, planted in MESH13D:
        with row_reduce_skipped() if planted else contextlib.nullcontext():
            got[name] = mesh13d_run(os.path.join(os.path.dirname(out), name), shape,
                                    per_device, updates=updates, save=name in MESH13D_SAVED)
    if tdist.get_rank() == 0:
        torch.save(got, out)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


RING14_S, RING14_LEN = 4096, 3800  # 14a: LLaVA-1.5-7B's position table, a row ending in shard 2


def _ring_block_work(nq: int, nk: int, c: int, h: int, hkv: int, d: int, diagonal: bool,
                     part: str) -> tuple[float, int]:
    """(FLOPs, bytes) one ring block's launch needs: `nq` valid queries
    of a c-row shard against `nk` valid keys (the diagonal block causal,
    its pairs nq(nq+1)/2), each valid input read once (bf16 tensors, f32
    LSE / di), both segment vectors read, each output written in full.
    `part`: "fwd" (QK^T, PV), "dkv" (2x the forward's FLOPs) or "dq"
    (1.5x), as phase 2 counts them."""
    pairs = nq * (nq + 1) / 2 if diagonal else nq * nk
    fwd = 4.0 * h * d * pairs
    q, kv, row, seg = h * d * 2, hkv * d * 2, h * 4, 2 * c * 4
    if part == "fwd":
        return fwd, nq * q + nk * 2 * kv + seg + c * (q + row)
    ins = nq * (2 * q + 2 * row) + nk * 2 * kv + seg
    if part == "dkv":
        return 2.0 * fwd, ins + c * 2 * kv
    return 1.5 * fwd, ins + c * q


def ring_library_ms(q, k, v, do, pad_q, pad_kv, causal: bool, scale: float) -> dict:
    """The library calls that compute a ring block's (or the whole
    sequence's) functions on its inputs, timed: {"fwd": SDPA with the
    block's boolean mask (the keys' pad mask, and the causal triangle on a
    diagonal block), "dkv" and "dq": the aten flash backward, one call for
    dQ, dK and dV (K / V expanded to the query heads under GQA, as phase
    2 times it)}."""
    import torch.nn.functional as F

    h, hkv = q.shape[2], k.shape[2]
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    mask = pad_kv[:, None, None, :]
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = mask & torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril()
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=h != hkv))
    ke, ve = (t.repeat_interleave(h // hkv, dim=1) for t in (kt, vt))
    with torch.no_grad():
        fo = torch.ops.aten._scaled_dot_product_flash_attention(qt, ke, ve, 0.0, causal, False,
                                                                scale=scale)
    bwd = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, ke, ve, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0, causal, fo[6], fo[7],
        scale=scale))
    return {"fwd": fwd, "dkv": bwd, "dq": bwd}


def phase_ring_kernels() -> dict:
    """14a: the ring's kernel path in one process, no process group:
    ops/ring_attention.py's per-block functions looped over the n sources
    of each query shard (`ring_attention_local`: kernel 1 causal on the
    diagonal block, non-causal before it, merged by log-add-exp; kernels
    2 and 3 per block fed the merged LSE and di) at n = 2 and 4, on
    LLaVA-1.5-7B's attention (B = 1, S = 4096, H = 32, D = 128) and GQA
    32 / 8, one row of 3,800 real tokens. O, dQ, dK and dV against kernels
    1-3 on the whole sequence and against the plain ring (the plain
    versions on the card, f32, through the same loop), at phase 2's TOL
    (times max(1, max |ref|) for the gradients). Times: each block of the
    last rank (the most loaded: contiguous shards give rank n - 1 one
    diagonal and n - 1 off-diagonal blocks), its critical path (the sum of
    its blocks) and the whole-sequence kernels, each beside its bound and
    the library call computing the same function on the same inputs
    (`ring_library_ms`: SDPA for the forward, the aten flash backward for
    kernels 2 and 3). Returns {kernel: {case: numbers}} for the kernels
    line's "ring"."""
    from vlrlhf_torch.ops.flash_attention import (
        KV_PAD_SEG, Q_PAD_SEG, flash_attention, flash_attention_bwd_plain,
        flash_attention_plain, make_segments,
    )
    from vlrlhf_torch.ops.ring_attention import ring_attention_local

    gen = torch.Generator(device="cuda").manual_seed(14)
    b, s, h, d, L = 1, RING14_S, 32, 128, RING14_LEN
    scale = d**-0.5
    out = {"flash_fwd": {}, "flash_bwd_dkv": {}, "flash_bwd_dq": {}}
    for label, hkv in (("mha", 32), ("gqa", 8)):
        def randn(*shape):
            return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

        q, k, v, do = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d), randn(b, s, h, d)
        pad = torch.arange(s, device="cuda")[None] < L
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        whole, lse = flash_attention(qr, kr, vr, pad_mask_q=pad, pad_mask_kv=pad, return_lse=True)
        whole.backward(do)
        whole = whole.detach()
        seg_q = make_segments(b, s, "cuda", None, pad, Q_PAD_SEG)
        seg_kv = make_segments(b, s, "cuda", None, pad, KV_PAD_SEG)
        di = (whole.detach().float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        t_whole = {"fwd": time_ms(flash_kernel_call(q, k, v, seg_q, seg_kv, True, scale)),
                   **{p: time_ms(flash_bwd_kernel_call(f"flash_bwd_{p}_bf16", q, k, v, do, lse, di,
                                                       seg_q, seg_kv, True, scale))
                      for p in ("dkv", "dq")}}
        l_whole = ring_library_ms(q, k, v, do, pad, pad, True, scale)
        b_whole = {"fwd": bound(_flash_flops([L], h, d, True), _flash_bytes([L], s, h, hkv, d,
                                                                           "fwd"))[0],
                   **{p: bound((2.0 if p == "dkv" else 1.5) * _flash_flops([L], h, d, True),
                               _flash_bytes([L], s, h, hkv, d, p))[0] for p in ("dkv", "dq")}}
        for n in (2, 4):
            what = f"14a {label} n = {n}"
            o, grads = ring_attention_local(q, k, v, pad, n, do=do)
            po, pgrads = ring_attention_local(q.float(), k.float(), v.float(), pad, n,
                                              do=do.float(), attend=flash_attention_plain,
                                              attend_bwd=flash_attention_bwd_plain)
            errs = {}
            for name, got, w, p in (("O", o, whole, po), *zip(("dQ", "dK", "dV"), grads,
                                                              (qr.grad, kr.grad, vr.grad), pgrads)):
                atol = TOL if name == "O" else TOL * max(1.0, float(p.abs().max()))
                errs[name] = (check_close(f"{what} {name} vs the whole-sequence kernels", got, w,
                                          atol)[0],
                              check_close(f"{what} {name} vs the plain ring", got, p, atol)[0])
            del po, pgrads
            c = s // n
            lo = (n - 1) * c  # the last rank's queries: L - lo of them valid
            nq = L - lo
            sl = (lambda t, j: t[:, j * c:(j + 1) * c].contiguous())
            blocks = {}
            for kind, src in (("diag", n - 1), ("off", 0)):
                diagonal = kind == "diag"
                args = (sl(q, n - 1), sl(k, src), sl(v, src))
                segs = (sl(seg_q, n - 1), sl(seg_kv, src))
                blse = lse[..., lo:].contiguous()
                bdi = di[..., lo:].contiguous()
                bdo = sl(do, n - 1)
                nk = nq if diagonal else c
                t = {"fwd": time_ms(flash_kernel_call(*args, *segs, diagonal, scale)),
                     **{p: time_ms(flash_bwd_kernel_call(f"flash_bwd_{p}_bf16", *args, bdo, blse,
                                                         bdi, *segs, diagonal, scale))
                        for p in ("dkv", "dq")}}
                bd = {p: bound(*_ring_block_work(nq, nk, c, h, hkv, d, diagonal, p))[0]
                      for p in ("fwd", "dkv", "dq")}
                lib = ring_library_ms(*args, bdo, sl(pad, n - 1), sl(pad, src), diagonal, scale)
                blocks[kind] = (t, bd, lib)
            for p, name in (("fwd", "flash_fwd"), ("dkv", "flash_bwd_dkv"), ("dq", "flash_bwd_dq")):
                td, bdd, ld = (blocks["diag"][j][p] for j in range(3))
                to, bdo_, lo_ = (blocks["off"][j][p] for j in range(3))
                crit, crit_bound = td + (n - 1) * to, bdd + (n - 1) * bdo_
                out[name][f"{label}_n{n}"] = {
                    "diag_ms": round(td, 4), "diag_bound_ms": round(bdd, 4),
                    "diag_library_ms": round(ld, 4),
                    "off_ms": round(to, 4), "off_bound_ms": round(bdo_, 4),
                    "off_library_ms": round(lo_, 4),
                    "last_rank_ms": round(crit, 4), "last_rank_bound_ms": round(crit_bound, 4),
                    "last_rank_library_ms": round(ld + (n - 1) * lo_, 4),
                    "whole_ms": round(t_whole[p], 4), "whole_bound_ms": round(b_whole[p], 4),
                    "whole_library_ms": round(l_whole[p], 4)}
            print(f"{what} (B = 1, S = {s}, H = {h}, Hkv = {hkv}, D = {d}, one row of {L}): max abs "
                  f"err (vs whole-sequence kernels, vs plain ring) "
                  + json.dumps({k2: [float(f"{x:.3e}") for x in e] for k2, e in errs.items()})
                  + f" (tol {TOL}, x max(1, max |ref|) for the gradients); the last rank's blocks "
                  f"and critical path vs the whole sequence, ms (bound ms): "
                  + json.dumps({nm: v[f"{label}_n{n}"] for nm, v in out.items()}), flush=True)
        del q, k, v, do, qr, kr, vr, whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vlrlhf_torch  # noqa: F401 — fails here when run without the port

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--mesh13d-worker"]:  # a rank of phase 13d, started below
        return mesh13d_worker(sys.argv[2])
    if sys.argv[1:2] == ["--mesh13c-worker"]:  # a rank of phase 13c, started below
        return mesh13c_worker(*sys.argv[2:5])
    if sys.argv[1:2] == ["--mesh13e-worker"]:  # a rank of phase 13e, started below
        return mesh13e_worker(*sys.argv[2:5])
    if sys.argv[1:2] == ["--mesh14-worker"]:  # a rank of phase 14b, started below
        return mesh14_worker(sys.argv[2])
    if sys.argv[1:2] == ["--mesh15-worker"]:  # a rank of phase 15, started below
        return mesh15_worker(sys.argv[2])
    if sys.argv[1:2] == ["--mesh16-worker"]:  # a rank of phase 16, started below
        return mesh16_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--mesh17-worker"]:  # a rank of phase 17, started below
        return mesh17_worker(*sys.argv[2:4])
    t_start = time.perf_counter()

    def mark(label: str) -> None:
        print(f"wall: phase {label} done {time.perf_counter() - t_start:.1f} s after the start",
              flush=True)

    phase_build()
    mark("1")
    kernels = phase_kernels()
    mark("2")
    phase_reduced_depth()
    mark("3")
    serve_launches, bf16_decode_ms = phase_serve()
    gc.collect()  # the bf16 serving model and cache go before the int8 one
    torch.cuda.empty_cache()
    spec_launches, chat_launches, int8_decode_ms = phase_serve_spec_int8()
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = phase_serve_int4(bf16_decode_ms, int8_decode_ms)
    mark("4")
    gc.collect()  # the serving models and caches go before any training model
    torch.cuda.empty_cache()
    phase_reduced_depth_dpo()
    phase_reduced_depth_dpo(bits=4)
    mark("5")
    dpo_launches, dpo_stats = phase_dpo()
    gc.collect()
    torch.cuda.empty_cache()
    qlora_launches = phase_dpo_qlora4(dpo_stats)
    mark("6")
    gc.collect()
    torch.cuda.empty_cache()
    trainer_launches = phase_trainer()
    mark("7")
    gc.collect()
    torch.cuda.empty_cache()
    eval_launches, adapter_launches = phase_eval()
    mark("8")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_launches = phase_checkpoint(dpo_stats["median_ms"])
    mark("9")
    gc.collect()
    torch.cuda.empty_cache()
    phase_reduced_depth_trainers()
    trainer10_launches = phase_trainers()
    mark("10")
    gc.collect()
    torch.cuda.empty_cache()
    phase_families_reduced_depth()
    mark("11a")
    next_launches = phase_llava_next()
    blip_launches = phase_instructblip()
    mark("11")
    int4_12 = phase_families12_reduced_depth()
    mark("12a")
    qwen_launches = phase_qwen_vl()
    xc2_launches = phase_internlm_xc2()
    mark("12")
    mesh_launches, _ = phase_mesh_dpo(dpo_stats)
    mark("13a")
    mesh_launches.update(phase_launchers())
    mark("13")
    ring = phase_ring_kernels()
    mark("14")
    runs = {"serve": serve_launches, "serve_int8_spec": spec_launches, "chat_int8": chat_launches,
            "serve_int4": int4_launches, "dpo": dpo_launches, "dpo_qlora4": qlora_launches,
            "dpo_trainer": trainer_launches, "eval": eval_launches,
            "serve_adapters": adapter_launches, **ckpt_launches, **trainer10_launches,
            **next_launches, **blip_launches, **int4_12, **qwen_launches, **xc2_launches,
            **mesh_launches}
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention", "chunk_attention",
             "int4_matmul", "int4_matmul_t")
    by_path = {name: {path: counts[name] for path, counts in runs.items() if name in counts}
               for name in names}
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    sources = {
        "flash_fwd": ("vlrlhf_torch/csrc/flash_fwd.cu",
                      "vlrlhf_tpu/ops/flash_attention.py:51"),
        "flash_bwd_dkv": ("vlrlhf_torch/csrc/flash_bwd.cu",
                          "vlrlhf_tpu/ops/flash_attention.py:195"),
        "flash_bwd_dq": ("vlrlhf_torch/csrc/flash_bwd.cu",
                         "vlrlhf_tpu/ops/flash_attention.py:278"),
        "decode_attention": ("vlrlhf_torch/csrc/decode_attention.cu",
                             "vlrlhf_tpu/ops/decode_attention.py:56"),
        "chunk_attention": ("vlrlhf_torch/csrc/chunk_attention.cu",
                            "vlrlhf_tpu/ops/chunk_attention.py:46"),
        "int4_matmul": ("vlrlhf_torch/csrc/int4_matmul.cu", "vlrlhf_tpu/ops/int4.py:219"),
        "int4_matmul_t": ("vlrlhf_torch/csrc/int4_matmul.cu", "vlrlhf_tpu/ops/int4.py:323"),
    }
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the paths driven")
    if by_path["chunk_attention"].get("serve_int8_spec", 0) <= 0 or \
            by_path["chunk_attention"].get("chat_int8", 0) <= 0:
        raise AssertionError(f"chunk_attention must run in both the speculative serve and /chat: "
                             f"{by_path['chunk_attention']}")
    if any(by_path[name].get("eval", 0) <= 0
           for name in ("flash_fwd", "decode_attention", "chunk_attention")):
        raise AssertionError(f"kernels 1, 4 and 5 must run on the eval path: "
                             f"{ {n: by_path[n].get('eval') for n in by_path} }")
    if by_path["int4_matmul"].get("serve_int4", 0) <= 0 or \
            by_path["int4_matmul"].get("dpo_qlora4", 0) <= 0 or \
            by_path["int4_matmul_t"].get("dpo_qlora4", 0) <= 0:
        raise AssertionError(f"int4 kernels must run in the int4 serve and the QLoRA step: "
                             f"{by_path['int4_matmul']} {by_path['int4_matmul_t']}")
    want9 = {"ckpt_serve": ("flash_fwd", "decode_attention"),
             "ckpt_serve_int8": ("flash_fwd", "chunk_attention"),
             "ckpt_serve_int4": ("flash_fwd", "decode_attention", "int4_matmul"),
             "ckpt_dpo": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
             "ckpt_qlora4": ("int4_matmul", "int4_matmul_t"),
             "ckpt_eval": ("flash_fwd", "decode_attention")}
    missing9 = [(path, name) for path, names in want9.items() for name in names
                if by_path[name].get(path, 0) <= 0]
    if missing9:
        raise AssertionError(f"phase 9 paths that did not launch their kernels: {missing9}")
    want10 = {"sft": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
              "rm": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
              "ppo": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention"),
              "ppo_qlora4": ("int4_matmul", "int4_matmul_t")}
    missing10 = [(path, name) for path, names in want10.items() for name in names
                 if by_path[name].get(path, 0) <= 0]
    if missing10:
        raise AssertionError(f"phase 10 paths that did not launch their kernels: {missing10}")
    want11 = {"next_serve": ("flash_fwd", "decode_attention"),
              "next_dpo": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
              "next_serve_int8_spec": ("flash_fwd", "chunk_attention"),
              "blip_serve": ("flash_fwd", "decode_attention"),
              "blip_dpo": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
              "blip_eval": ("flash_fwd",)}
    missing11 = [(path, name) for path, names in want11.items() for name in names
                 if by_path[name].get(path, 0) <= 0]
    if missing11:
        raise AssertionError(f"phase 11 paths that did not launch their kernels: {missing11}")
    want12 = {"qwen_serve": ("flash_fwd", "decode_attention"),
              "qwen_dpo": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
              "qwen_serve_int8_spec": ("flash_fwd", "chunk_attention"),
              "xc2_serve": ("flash_fwd", "decode_attention"),
              "xc2_dpo": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
              "xc2_eval": ("flash_fwd",),
              "qwen_int4_reduced": ("int4_matmul",), "internlm_int4_reduced": ("int4_matmul",),
              "xc2_qlora4_reduced": ("int4_matmul", "int4_matmul_t")}
    missing12 = [(path, name) for path, names in want12.items() for name in names
                 if by_path[name].get(path, 0) <= 0]
    if missing12:
        raise AssertionError(f"phase 12 paths that did not launch their kernels: {missing12}")
    if any(by_path[name].get("mesh_dpo", 0) <= 0
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")):
        raise AssertionError(f"phase 13a (mesh_dpo) must launch kernels 1-3: "
                             f"{ {n: by_path[n].get('mesh_dpo') for n in by_path} }")
    if any(by_path[name].get("mesh_dpo_tp", 0) <= 0
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")) or \
            any(by_path[name].get("mesh_eval", 0) <= 0 for name in ("flash_fwd", "decode_attention")):
        raise AssertionError(f"phase 13c (mesh_eval) must launch kernels 1 and 4, 13d "
                             f"(mesh_dpo_tp) kernels 1-3: {by_path}")
    if any(by_path[name].get("mesh_dpo_sp", 0) <= 0
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")):
        raise AssertionError(f"phase 14b (mesh_dpo_sp) must launch kernels 1-3: {by_path}")
    if any(by_path[name].get("mesh_dpo_pipe", 0) <= 0
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")):
        raise AssertionError(f"phase 15 (mesh_dpo_pipe) must launch kernels 1-3: {by_path}")
    if any(by_path[name].get("mesh_ppo_pipe", 0) <= 0
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention")):
        raise AssertionError(f"phase 16 (mesh_ppo_pipe) must launch kernels 1-4: {by_path}")
    if any(by_path[name].get("mesh_dpo_sp_model", 0) <= 0
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")) or \
            any(by_path[name].get("mesh_ppo_sp", 0) <= 0
                for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention")):
        raise AssertionError(f"phase 17 must launch kernels 1-3 (mesh_dpo_sp_model) and 1-4 "
                             f"(mesh_ppo_sp): {by_path}")
    for name, cases in ring.items():
        kernels[name]["ring"] = cases
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "launches_by_path": by_path[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"],
         **{k: kernels[name][k] for k in ("int8", "chat", "eval", "ppo", "families", "tp",
                                          "ring", "pipe")
            if k in kernels[name]}}
        for name in names
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
