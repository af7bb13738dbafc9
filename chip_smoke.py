#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA device is required (no CPU fallback);
  2. build: one nvcc per vap_tpu_torch/csrc/*.cu, all started together, for
     sm_90a; ptxas's registers and spills per kernel, the backward instances
     on a path (K5 at D=64, K6) listed apart; the HGMMA (wgmma) and UTMALDG
     (TMA load) instructions in the SASS of K1, K2 and K5 at D=64, of K4,
     K2 and K6 at D=128 and of K9/K10's bf16 GEMM kernels, and IGMMA (int8
     wgmma) in K2's and in K3's and K9's int8 GEMM kernels, counted by
     cuobjdump per kernel function, K2's int32 -> f32 conversions (I2F,
     I2FP) printed, and no wgmma serialised and no wait injected by ptxas
     there (C7512, C7513, C7517, any C751x);
  3. kernel parity: K1 (flash, D=64: the wgmma kernel of
     flash_fwd_sm90_d64.cu), K4 (flash, D=128) and K2 (sage, D=64
     and D=128: the wgmma kernels of sage_fwd_sm90_d64.cu and
     sage_fwd_sm90.cu, after the pre-pass kernel of sage_quant.cu) against
     their plain PyTorch versions in bf16, at unaligned
     shapes and at the main-path shapes (CogVideoX joint [1,48,35552,64];
     Wan joint [1,40,40560,128], Wan cross [1,40,20280,128] x 512 and
     x 257 keys, and for K4 also Wan training's self-attention
     [1,40,20280,128] x 20280), each with a planted fault that must break
     the limit; the
     kernel's time, the plain version's, torch's SDPA flash backend's (a
     yardstick only, never called by the port) and the card's bound, for
     K4 and K2 also at Wan's two cross shapes, and for K2 its pre-pass's
     time apart at every timed shape; then the pre-pass kernel against the
     plain sage_quantize (q_i8 equal, k_i8 within one step, sqk within rtol
     1e-6, with and without kv_lens over a NaN suffix; a planted fault, q
     rows rolled, must break the equality), its time and bound;
     then K3 (the W8A8 linear) against its plain version, bit for bit, at
     unaligned shapes, at the three projection shapes of a CogVideoX step
     ([35552, 3072] x [3072, 3072 | 12288], [35552, 12288] x [12288, 3072])
     and at the six of a Wan2.1-14B step ([40560 | 1024, 5120] x [5120,
     5120], [40560, 5120] x [5120, 13824], [40560, 13824] x [13824, 5120],
     [514, 1280] x [1280, 1280 | 5120]; N = 5120 ends on a ragged 128-column
     tile), a planted fault each time, its quantise pass and GEMM timed
     apart (profiler device time),
     and K9 and K10 (the GEMM rate probe) in int8 (bit for bit) and bf16,
     each with its times, bound and yardsticks; then the rate probe's entry
     point (linear_bench --impl diag) with its launch counts; then K7, the
     varlen forward (per-sample key lengths), in K4 and K2 at D=128 and in
     K1 at D=64 against their plain versions, at the unaligned shapes with
     B=2 and lengths (Skv, 0) and (Skv-37, 1), and in K4 and K2 at
     HunyuanVideo's joint shape [1,24,32656,128] with the valid key count
     its pipeline call gives (phase 11); the key suffix past each length is
     NaN and must not move the output, exact zero rows and the lse -1e4
     where a sample has no key; two planted faults (the kernel without
     kv_lens on a suffix of 1e4, and V rolled inside each tile) must break
     the limit; times at the joint shape beside the plain version (K2's
     pre-pass apart), the bound over the valid keys and SDPA's
     memory-efficient backend with a boolean key mask (a yardstick only);
     then K8, the packed-segment
     forward (the wgmma kernels of K1 at D=64 and K4 at D=128, in their
     segmented instances, which walk only the key tiles whose id ranges
     meet the query block's), against its
     plain version at three full-width cases: CogVideoX's joint stream
     [1,48,35552,64] as target and reference segments (its last 64 tokens
     padding), Wan's [1,40,40560,128] as two halves, and the Hunyuan LoRA
     stream [1,24,18976,128] with its padded text slots as padding (there
     also against K7 at kv_lens = the valid tokens); in-range rows within
     the limits, padding rows finite, a planted fault (one key's id
     flipped) that must break the limit; times beside the plain version,
     the bound over the same-segment pairs and SDPA's memory-efficient
     backend with a boolean [1,1,S,S] mask (a yardstick only), each case's
     share of tile pairs the tile rule walks (the rule's count), and the K8
     instances' registers; the kernels' tile sizes held against the rule's,
     and in each case NaN in the v rows of every tile a block's run leaves
     out must not move that block's rows (no tile outside the rule read);
     then the ring body of sequence-parallel
     attention on one card (its key blocks passed on by a local rotation)
     over 2 and 4 blocks of the CogVideoX and Hunyuan cases, and once with
     kv_lens, against one kernel call, and the time of one block call whose
     queries and keys share a segment beside one whose share none; then
     K8's backward (the wgmma kernels of K5 at D=64 and K6 at D=128, in
     their segmented instances, entries of their own) against its
     plain version at the unaligned shapes (B=2, three segments, one
     crossing a 64-row tile edge, a padded tail, a query segment with no
     key, Sq != Skv) and at the same three full-width cases with dout zero
     on the padding rows: dq, dk and dv within the limit, dq = 0 where a
     query's segment has no key, a flipped key id that must break the
     limit, the Hunyuan case also against K7's backward at kv_lens = its
     valid tokens (and whether the two are bit-equal); times beside the
     plain version, the bound over the same-segment pairs, SDPA's
     memory-efficient backward with a boolean [1,1,S,S] mask (a yardstick
     only), the shares of tile pairs the rule walks (dq and dk/dv kernels),
     the same NaN check (in k for dq, in dout for dk/dv) and the
     registers; then sequence-parallel attention's step on
     one card: the ring body, then its backward (ring_backward_steps run in
     lockstep: each block passed on with its dk/dv accumulators, which
     arrive home after n passes) from the merged out and lse, over 2 and 4
     blocks of the CogVideoX case with and without segment ids and of the
     Hunyuan case with kv_lens and with segment ids, each against one
     backward call over all keys; its launches are K8's (forward and
     backward) in the kernels line;
  4. CogVideoX, "flash": a small pipeline held against plain dense attention
     (with where its largest error sits and why), and a small W8A8 pipeline
     under DPM and the adaptive step cache, K3 against its plain version;
     the other sampling modes on a small pipeline, each against plain dense
     attention: ablation_single_branch, baseline_single_condition, plain
     image-to-video, text-to-video (a T2V-shaped model),
     discrete_long_reference, the MoT options (reference_independent, the
     reference-slot embeddings, ablation_single_encoder,
     ablation_residual_addition) and CogVideoX 1.5 (patch_size_t 2, ofs
     embedding, 9 frames: a padded latent frame); plain equal to
     baseline_single_condition, model offload equal to resident and the
     tiled and sliced decode of one tile equal to the default decode, to
     the bit; the tiled decode and the tiled encode of a 2 x 2 tile grid on
     the card against the CPU;
     then CogVideoX-5B VAP at full width (42 blocks, MoT in 0-40, T5-XXL,
     the full VAE) at 49 frames of 480x720, random bf16 weights from a
     seed, through CogVideoXVAPPipeline.__call__, cut to 2 DDIM steps of
     the path's 50;
  5. CogVideoX, "sage": the same call with 1 step; then the bench
     configuration on the same pipeline: its 498 projections quantised in
     place to W8A8 (chunk form, K3), sage, the step cache "uniform:2:1:1"
     over 4 DDIM steps (K3 and K2 launch on steps 0, 1 and 3 only, the
     reuse step costs under 5% of a computed one), then 1 step in the row
     form (before it, on the bf16 pipeline: 1 step, latents out, under
     "flash" and under "ring" with the mesh of a one-rank NCCL process
     group installed, make_mesh(MeshConfig()) on cuda, with one rotate
     method, which at one rank is the same local kernel call as the other
     two: the latents equal flash's bit for bit, with the same 42 K1
     launches);
  5c. checkpoints in and out: after the main path's flash, sage and ring
     runs, its latents under flash (2 steps), then the pipeline's
     transformer, VAE and T5 written as a diffusers-layout directory under
     build/ (config.json per component, the transformer and T5 in 5 GB
     shards with an index; a disk too short fails here); after the bench
     configuration, one step of it (sage, W8A8 chunk form) to latents; then
     the pipeline built again from the directory (build_pipeline, onto the
     card one tensor at a time) runs the same two calls, each with the
     counts at 0 before it: K1's 84 launches, then K2's 42 and K3's 498,
     latents bit-equal to the resident pipeline's; bytes, seconds and GB/s
     of the write and the load, host RSS and its peak, peak card memory;
     then the tiled VAE encode (vae_encode_tiled: 3 x 3 tiles of 240 x 360)
     of the main path's 49-frame reference video, its seconds and peak card
     memory beside vae_encode's;
  5d. CogVideoX streamed block offload: the pipeline built a third time from
     that directory with build_pipeline(offload_blocks_chunk=6), so that
     every weight lands in host memory; the pages of its blocks' tensors
     page-locked in place (cudaHostRegister; seconds, bytes and host RSS
     before and after), 8 chunks, then the main path's flash call (2 steps, latents)
     with the blocks streamed on a copy stream: K1's 84 launches, latents
     bit-equal to the resident pipeline's; peak card memory, seconds per
     step, bytes copied host -> card per step and their GB/s, the share of
     the copies that overlapped compute (the copy stream's events);
  5e. CogVideoX 1.5 VAP at full width and cut depth: cogvideox_5b_i2v_vap
     with CogVideoX1.5-5B-I2V's transformer fields (patch_size_t 2,
     ofs_embed_dim 512, sample 300 x 300 x 81, no learned position table)
     at 4 of its 42 blocks (MoT in 0-2, the plain tail block),
     its VAE (invert_scale_latents, scaling 0.7) and T5-XXL, random bf16
     weights from a seed, on the card: 81 frames of 768x1360 (21 latent
     frames padded to 22), one reference, CFG batch 2, one DDIM step under
     flash (4 K1 launches: 3 MoT blocks at [2,48,90212,64], the plain
     tail block at [2,48,45106,64], the shapes read from the calls), decoded
     to 81 frames; the step, encode and decode seconds and the peak card
     memory; then K1 on the last inputs of each shape held against its
     plain version on heads 0-7 and 40-47, under phase 1's limits;
  6. Wan: a small pipeline on the card held against plain dense attention
     under flash and sage, then Wan2.1-I2V-14B VAP at full width and cut
     depth (20 of its 40 blocks, MoT in all 20, 40x128 heads, UMT5-XXL, CLIP
     ViT-H/14, the Wan VAE) at
     49 frames of 480x832, one reference, FlowMatch shift 3, guidance 5,
     random bf16 weights from a seed, through WanVAPPipeline.__call__ with
     model offload (one component on the card at a time), cut to 1 step
     under flash and 1 under sage; then (6d) the same flash step with
     offload_blocks_chunk=4: the 20 blocks page-locked in place and streamed
     in 5 chunks on a copy stream, K4's 200 launches, latents bit-equal to
     the resident run's, with the figures of 5d, then the pages unlocked
     (close_streamed); then (6b) its
     bench configuration on the
     same pipeline: the 404 projections of its 20 blocks (804 at 40)
     quantised to W8A8 (chunk form) on the card, one weight at a time, the
     int8 copies kept in host memory; sage, UniPC (shift 3, guidance 5), the
     step cache "uniform:2:1:1" over 4 steps, decoded; per step K3's
     launches (404 on a computed step), the
     row form's calls (0), K2's and its pre-pass's; K3 and K2 launch on
     steps 0, 1 and 3 only and the reuse step costs under 5% of a computed
     one; then (6c) the Wan checkpoint at full width and cut depth: the first
     4 blocks of that transformer (taken before 6b quantises it) with its
     UMT5, CLIP and VAE, in host memory, run one step under flash to
     latents, are written as a diffusers-layout directory under build/
     (the transformer in 5 GB shards with an index), and the pipeline built
     again from it (wan_vap.build_pipeline, the weights into host memory,
     the depth from its config.json) runs the same step with the counts at
     0 before it: K4's 20 launches, latents bit-equal; bytes, seconds and
     GB/s of the write and the load, host RSS and peak card memory; the
     UMT5, CLIP and VAE read back go on to phase 10b;
  7. K5 (the flash backward, D=64: the wgmma kernels of
     flash_bwd_sm90_d64.cu) against its plain PyTorch version in bf16 at
     the unaligned shapes and at the main-path shape [1,48,35552,64], dq, dk
     and dv each within a limit of max|ref|, with a planted fault (dout rows
     out of place inside each 64-query tile) that must break it, and bit-
     equal from run to run at the main-path shape; its time, the plain
     version's, the backward of torch's SDPA flash backend (a yardstick
     only) and the card's bound;
  8. CogVideoX-5B VAP training at full width (42 blocks, MoT in 0-40,
     random bf16 weights from a seed) from clips on disk, the released
     recipe's data path (vap_mot/train_single_node.sh): three seeded clips
     written with the port's writer (49 frames of 512x768 and 448x672 at 16
     fps, 74 of 512x640 at 24 fps: the fps resample, INTER_AREA, the linear
     taps and the area-mode taps of the bucket fit to 480x720), a
     vap_data.csv over them, a training.json shaped like the recipe's and a
     validation.json pointing at a one-row benchmark CSV (2 DDIM steps);
     T5-XXL and the VAE built on the card from the seed (the spec);
     SFTTrainer(args, model, spec).run: the datasets on the prefetch thread,
     decode (the decoder that served is printed), bucket fit, T5 and VAE
     encodes online, batch 1: AdamW (beta 0.9 / 0.99, weight decay 1e-4,
     clip 1.0, a constant lr of 1e-5), remat "full", 2 optimizer steps (the
     first a warm-up), then validation sampling with the live weights
     (validation_steps = 2); per step the loss, grad_norm, seconds and the
     forward / backward / update split; the timing/* spans of the encodes,
     the steps and validation and the peak device memory of each; K1 and K5
     launches (84 and 42 a step, 42 a validation denoise step), the
     validation video finite, 49 frames, written to
     validation/000002/sample_0.mp4, the frozen trunk bit-identical and the
     MoT expert moved; before the steps, one item encoded (its seconds), and
     one grad_fn on it under "flash" and under the trainer's own attention
     context (``_attn_ctx``) with a one-rank NCCL group's mesh and
     ``attn_provider_training="ring"``: the loss and every expert gradient
     bit-equal, with the same K1 and K5 launches; then trainer.export() (the
     full transformer in diffusers names) read back with the port's reader:
     every tensor equal to the trained one; then one step of the released
     DPO recipe (vap_mot/train_single_node_dpo.sh: --dpo, rank 32, alpha
     32, lr 5e-5 constant) on the same model, T5 and VAE, the expert's
     AdamW state and gradients freed first: a dpo.csv over the same clips
     (scores 100, 95, 5 in one kind), the lose video encoded in the win
     video's bucket, a LoRA policy on the expert's six projections at
     batch 2 (win, lose): the reference pass with the adapters bypassed,
     the policy's forward and backward, the update, their seconds and the
     step's peak memory; at step 1 the policy's per-sample losses equal the
     reference's to the bit and the loss ln 2 x dpo_weight, A's gradients
     zero and B's finite and non-zero exactly where they reach the loss,
     the frozen weights bit-equal to the export, K1 126 (reference, forward,
     recompute) and K5 42 launches, every attention call at batch 2; then
     K1 and K5 at [2,48,35552,64] against their plain versions on heads 0
     and 47 of both batch rows (a dout with its rows swapped must break
     K5's limit in row 1); before the export, an ``adamw-8bit`` update of
     the expert on the first item (its AdamW state freed first): the int8
     state's bytes a parameter, the update's seconds, the peak, the loss of
     the step after; then (8b) the data path's small
     check at tiny widths on the card: CogVideoX (head_dim 64) trained 3
     steps online and under enable_precomputation (the encode pass into a
     cache, the encoders sent to host memory and brought back for a
     validation every step), losses bit-equal; Wan VAP (head_dim 128) and
     the HunyuanVideo LoRA (head_dim 128) trained one step from clips with
     one validation sample each, K4 / K6 and K7's launches counted; then
     the training objectives one step each from clips at tiny width with
     their K1 / K5 launches: the single-branch ablation (whole model and
     LoRA), baseline_single_condition, the plain CogVideoX LoRA,
     reference_independent with and without random_refer_noise, CogVideoX
     1.5 (patch_size_t 2), DPO resumed from a checkpoint equal to the
     uninterrupted run, and Wan DPO (head_dim 128: K4 and K6); then (8a)
     the same model, its DPO adapters taken out, under the released 3-ref
     HSDP recipe (vap_mot/train_single_node_3ref.sh) read through the
     port's parser with its degrees folded to one rank (data 1, fsdp 1) and
     no warm-up: one step (AdamW, clip) on the first item unsharded, then,
     from the same weights, sharded by FSDP2 over a one-rank NCCL
     (data, fsdp) mesh (SFTTrainer(..., shard=True): DTensor parameters, the
     sharded optimizer and clip) and the full-state gather
     (trainable_state_dict), both steps with the reference time
     embedding's gradient summed over the 41 MoT blocks in float64 (FSDP2's
     hooks change the order of that bf16 sum): the loss and every updated
     tensor of the expert equal to the bit, the grad norms within 1e-6 of
     each other, K1 84 and K5 42 launches each, the seconds and peaks;
  9. K6 (the flash backward, D=128) as K5 in phase 7, at the unaligned
     shapes and at the main-path shapes of Wan training, [1,40,20280,128]
     x 20280 (self-attention), x 512 (UMT5) and x 257 (CLIP) keys; its
     times at the three shapes; then K7's backward, K6 (D=128) and
     K5 (D=64) given kv_lens, against their plain versions at the unaligned
     shapes with B=2 and lengths (Skv, 0) and (Skv-37, 1), and at
     HunyuanVideo training's joint shape [1,24,18976,128] (K5's form at
     D=64) with the phase-11 prompt's valid key count: dq, dk and dv within
     the limit, a NaN key suffix that moves no output, exact zero dk and dv
     rows past each length and dq = 0 for an empty sample, a planted fault
     (forward and backward without kv_lens on a suffix of 1e4) that breaks
     the limit; times beside the plain version, the bound over the valid
     keys and SDPA's memory-efficient backward with a boolean key mask (a
     yardstick only); then (9c) the released Wan control recipe
     (control/wan/image_condition/train.sh): K6 at its self-attention
     [1,12,20280,128] against the plain version (with the planted fault),
     then Wan2.1-T2V-1.3B (30 blocks, 12x128 heads, ffn 8960, random bf16
     weights from a seed) widened to 33 input channels by the entry point,
     phase 6c's UMT5 and VAE on the card for the phase, a ControlTrainer of
     the recipe (control_type none, frame conditioning index 0 with the
     mask, control_lora rank 64 / alpha 64 with the injection weight and
     the QK norms trained directly, AdamW, remat "full") 2 steps from 2
     clips at 49 frames of 480x832 with the encodes online, then one
     validation sample (2 FlowMatch steps at CFG batch 2, decoded): the
     seconds, the peaks, K4 360 and K6 120 launches, the export's two
     files; on the first batch and draws, one step under remat "ops" and
     "block_skip:2" against "full" (the loss to the bit, the gradients
     within 2e-2 of max|full| and whether to the bit, K4 120 / 120 / 90
     a step, the seconds and peaks; a recompute fed half its input must
     break the limit); one control_full_finetune step of a fresh 1.3B
     model under Adafactor (seconds, peak, the state's bytes);
 10. Wan2.1-I2V-14B LoRA SFT at full width and depth (40 blocks, no MoT:
     the plain structure of the recipe's config_plain.json, 40x128 heads,
     ffn 13,824, 36 input channels, random bf16 weights from a seed) on a
     random precomputed item at 49 frames of 480x832, batch 1, through
     SFTTrainer.run: rank 16, alpha 32 on to_q, to_k, to_v and to_out,
     logit-normal sigmas, AdamW (beta 0.9 / 0.99, weight decay 1e-4, clip
     1.0, a constant lr of 1e-4), remat "full", 2 optimizer steps (the first
     a warm-up); per step the loss, grad_norm and the forward / backward /
     update seconds, the peak device memory, K4 and K6 launches (240 and 120
     a step), the frozen trunk bit-identical, every adapter's B moved at
     step 1 and its A at step 2, the second step (10a) under the one-rank
     ``ring cross:flash`` (a one-rank NCCL group's mesh installed) inside
     the trainer's profiling window (--profile_dir), its loss and adapter
     gradients equal to the bit to one grad_fn under flash on the same item
     and draws, the trace's top device kernels; the share of adapted
     weight elements the bf16 merge changes; then (10b) that trained model, its adapters in
     place, sampled through WanVAPPipeline.__call__ without a reference
     (plain image-to-video) with phase 6c's UMT5, CLIP and VAE under
     offload, 49 frames of 480x832, UniPC, 1 step under flash, latents
     out: K4's launches (self-attention at [2,40,20280,128] and the two
     cross-attentions of each block, 120 a step) and the peak memory;
     (10c) the adapters, written after training as a PEFT file, merged into
     the frozen weights (merge_lora_into_state_dict: f32 add, then bf16):
     where delta is at least 8 bf16 ulps of the base, each merged weight
     within 2 bf16 ulps of the trained one (ulps of the largest of the two,
     the base and delta), while three faulty merges made on the card (no
     delta, delta transposed, alpha / r dropped) must land outside it; a
     forward at a short clip [1,2,30,52,36] within 2e-2 of max |out| of the
     trained model's, which the faulty merges' forwards must exceed; (10d)
     that model's frozen base, its adapters taken out, given to an
     SFTTrainer under --training_type lora --layerwise_upcasting_modules
     transformer (float8_e4m3fn, the JAX package's default skip patterns),
     which casts it, installs new adapters and takes one step from phase
     10's item: the frozen bytes before and after, the step's seconds and
     peak, the loss beside the bf16 base's on the same item and draws;
 11. HunyuanVideo T2V: a small pipeline on the card at head_dim 128 under
     flash and sage (K7 in K4 and in K2) held against the plain masked
     dense attention, then HunyuanVideo at full width and depth (20 dual +
     40 single blocks, 24x128 heads, LLaMA-8B text states from hidden
     layer -3, CLIP-L text, the causal VAE's decoder) with random bf16
     weights from a seed, through HunyuanVideoPipeline.__call__ with model
     offload, at 33 frames of 720x1280 (the released default is 129: see
     hunyuan_path), 2 FlowMatch steps under flash (decoded) and 1 under
     sage (latents); the prompt leaves the text mask padded, so K7 masks
     keys: 60 launches a step;
 12. the Hunyuan VAE's encoder: the tiny encoder on the card against the
     CPU in float32, then a seeded random clip of 49 frames at 480x768
     through phase 11's VAE (prepare_latents: the scaled mean, [1,16,13,60,
     96]) with its seconds and peak memory;
 13. HunyuanVideo LoRA SFT at full width and depth on phase 11's
     transformer (20 dual + 40 single blocks, 24x128 heads, random bf16
     weights) on one precomputed item at 49f@480x768 (phase 12's latents,
     random LLaMA and CLIP states, phase 11's prompt mask: 18,763 of 18,976
     joint keys valid), batch 1, through SFTTrainer.run: the
     modal_labs_dissolve recipe's rank 32, alpha 32 on to_q, to_k, to_v and
     to_out (208 adapters), logit-normal sigmas, AdamW (beta 0.9 / 0.99,
     weight decay 1e-4, clip 1.0, a constant lr of 3e-5), remat "full", 2
     optimizer steps; per step the loss, grad_norm and the forward /
     backward / update seconds, the peak device memory, K7's launches in K4
     (120 a step: forward and recompute) and in K6 (60), the frozen trunk
     bit-identical, every adapter's B moved at step 1 and its A at step 2,
     the second step (13a) under the one-rank ``ring`` (K7 reached through
     it, with the prompt's kv_lens) inside the profiling window, held to
     the bit against a grad_fn under flash as in 10a; the share of adapted
     weight elements the bf16 merge changes.

At the phase boundaries from 4 on, a "[host memory, ...]" line gives the
seconds since the smoke began, the process's RSS and its peak so far, the
sandbox's charged memory, which the machine's 96 GiB limit reads, and the
free bytes glibc keeps in its heap for reuse.

The last three lines are a JSON object with each kernel's launches in its
main-path run (K7 in K4, K2, K6 and K5 and K8 in K1, K4, K5 and K6 listed apart
from them; K8 is on no model's path: its launches are those of the ring's
forward and backward on one card; K3 twice, "w8a8" at CogVideoX's shapes
with phase 5's launches, "w8a8_wan" at Wan's with phase 6b's), its largest error
against the plain version, and its times and bound at its main-path shape;
the card's name and power limit as nvidia-smi gives them; and
{"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import ctypes.util
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NUM_FRAMES = 49
STEPS = 2
HEIGHT, WIDTH = 480, 720
WAN_HEIGHT, WAN_WIDTH = 480, 832
WAN_STEPS = 1
PARITY_SHAPES = [(300, 200), (128, 257), (64, 77)]
MAIN_SHAPE = (1, 48, 35552, 64)  # B, H, S, D of one CogVideoX joint attention at 49f@480x720
# Wan at 49f@480x832: 13 latent frames of 30x52 tokens = 20,280 per branch
WAN_JOINT = (1, 40, 40560, 128)
WAN_CROSS = [(1, 40, 20280, 512, 128), (1, 40, 20280, 257, 128)]  # B, H, Sq, Skv, D
# kernel vs plain version, bf16 output, held as max|out - ref| / max|ref|:
# both round P to bf16, against different running maxima, which moves an
# output by about one bf16 ulp, at most 2^-7 of max|ref|. A planted fault
# (V rows rolled by one inside each 64-key tile) must read above the limit.
OUT_REL_TOL = 2e-2
LSE_ATOL = 1e-2
KV_TILE = 64  # keys per tile of the kernels
# small-pipeline check: final latents (max ~2) under the kernels vs the plain
# dense attention. bf16 activations through a few blocks and 2 steps, with
# the CFG difference amplified up to 7x; sage adds its int8 score error. A
# wrong layout or mask gives errors of order 1.
E2E_ATOL = {"flash": 0.1, "sage": 0.2}
# the small Wan pipeline: FlowMatch's first of 2 steps moves the latents by
# ~0.99 v with v = u + 5 (c - u), so one bf16 ulp of c (2^-6 at |c| in
# [2, 4)) moves a latent by ~0.08; the limit allows about three such flips
WAN_E2E_ATOL = {"flash": 0.25, "sage": 0.35}
# K5 vs plain version: dq, dk and dv each held as max|err| / max|ref|. Both
# round ds and p to bf16 at the same points from the same out and lse; exp2
# and the summation order differ, which flips a rounding by one bf16 ulp
# (2^-8 relative) now and then, and each output is itself rounded to bf16.
# A planted fault (dout rows rolled by one inside each 64-query tile) must
# read above the limit in all three.
GRAD_REL_TOL = 2e-2
Q_TILE = 64  # queries per tile of the dk/dv kernel
TRAIN_STEPS = 2  # optimizer steps of phases 8, 10 and 13: 1 warm-up, 1 timed
VAL_STEPS = 2  # phase 8's validation sampling: DDIM steps (the recipe's JSON says 50)
TRAIN_LR = 1e-5  # the recipe's lr, constant: the first update is not at lr 0
# the Wan LoRA recipe (examples/training/sft/wan/crush_smol_lora/train.sh):
# rank 16 on to_q, to_k, to_v and to_out of every attention, lr 1e-4
# (constant here, not over its 100 warmup steps: the first update is not at
# lr 0), logit-normal sigmas, the plain structure of config_plain.json; alpha
# 32 where the recipe has 16, so that 10c's merge scales delta by 2 and a
# merge that drops alpha / r shows
WAN_LORA = dict(rank=16, lora_alpha=32, target_modules="to_q to_k to_v to_out", lr=1e-4,
                flow_weighting_scheme="logit_normal")
WAN_STRUCTURE = "examples/training/sft/wan/crush_smol_lora/config_plain.json"
# the HunyuanVideo LoRA recipe (examples/training/sft/hunyuan_video/
# modal_labs_dissolve/train.sh): rank 32, alpha 32 on to_q, to_k, to_v and
# to_out, lr 3e-5 (constant here: under its 1000 warmup steps, which count
# updates, 2 steps would stay near lr 0), logit-normal sigmas
HUNYUAN_LORA = dict(rank=32, lora_alpha=32, target_modules="to_q to_k to_v to_out", lr=3e-5,
                    flow_weighting_scheme="logit_normal")
# the tiny VAE encoder in float32 on the card against the CPU: the same
# convs in another summation order (cuDNN, TF32 off), about 1e-6 of the
# latents' scale
VAE_CARD_ATOL = 1e-4
# K6's main-path shapes (B, H, Sq, Skv, D): one Wan branch at 49f@480x832
# attends its own 20,280 tokens, then 512 UMT5 and 257 CLIP keys
WAN_TRAIN_ATTN = [(1, 40, 20280, 20280, 128), (1, 40, 20280, 512, 128),
                  (1, 40, 20280, 257, 128)]
NEVER = 2**31 - 1  # checkpointing_steps: no checkpoint (a full-width one holds ~32 GB)
# H100 SXM dense peaks (NVIDIA data sheet): the bound of each kernel
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12
PEAK_F32 = 67e12  # float32 outside the tensor cores: K3's quantise and fold
# K3 (W8A8): a CFG-2 CogVideoX step at 49f@480x720 runs every projection on
# M = 2 * (226 text + 13 * 30 * 45 video tokens) rows of its branch
W8A8_M = 2 * (226 + 13 * 30 * 45)
# (K, N) of the projections and their launches per CFG step: q, k, v and out
# (4 x 83 branch-blocks), the feed-forward's in and out (83 each)
W8A8_SHAPES = {(3072, 3072): 332, (3072, 12288): 83, (12288, 3072): 83}
W8A8_PARITY = [(300, k, n) for k in (256, 3072) for n in (128, 384)]  # M, K, N
# K3 at Wan2.1-I2V-14B's projections (the Wan bench configuration, 49f@480x832,
# one reference, CFG batch 2): (M, K, N) and the launches per computed step.
# Each branch (target, reference) runs 2 x 20,280 video rows through attn1's
# q, k, v, out and attn2's q, out (6 x 80 branch-blocks), 2 x 512 text rows
# through attn2's k, v (2 x 80), the FFN up and down (80 each); each image
# embedder 2 x 257 CLIP rows through its two (K, N = 1280 | 5120). N = 5120
# leaves a ragged last column tile of 128 (26 x 192 + 128).
def wan_w8a8_shapes(layers):
    """(M, K, N) -> K3's launches a computed step of a Wan VAP transformer
    of ``layers`` MoT blocks: per block 12, 4, 2 and 2; the image embedders
    2 and 2."""
    return {(40560, 5120, 5120): 12 * layers, (1024, 5120, 5120): 4 * layers,
            (40560, 5120, 13824): 2 * layers, (40560, 13824, 5120): 2 * layers,
            (514, 1280, 1280): 2, (514, 1280, 5120): 2}


# at the released depth (40 blocks): 804 a step, whose time phase 3 gives
WAN_W8A8_SHAPES = wan_w8a8_shapes(40)
# K3 vs plain version: per chunk the int32 product is exact on both sides
# and the f32 steps are the same, uncontracted, in the same order, so the
# bf16 outputs are equal to the bit; they are also held as max|err| /
# max|ref| within one bf16 ulp, 2^-7 of the element (8 significant bits),
# the limit a planted fault (the weight's rows rolled by one inside each
# 128-row tile) must read above.
W8A8_REL_TOL = 2.0 ** -7
W8A8_TILE = 128
# K9 and K10 at the rate-probe script's shape (M, K, N); int8 is held bit
# for bit against an exact int64 product; bf16 sums in f32 in another order
# than the plain version, so an output may round to the neighbouring bf16
# value, one ulp, at most 2^-7 of it. K10 takes M in multiples of 16: its
# parity shapes trim M to one
PROBE_SHAPE = (71168, 3072, 3072)
PROBE_PARITY = [(300, 256, 128), (144, 3072, 384)]
GEMM_BF16_REL_TOL = 2.0 ** -7
# the bench configuration (bench.py's default: sage, W8A8, 42 blocks): DDIM
# with dynamic CFG over 4 steps under the step cache, which computes 0, 1, 3
BENCH_STEPS = 4
BENCH_CACHE = "uniform:2:1:1"
BENCH_COMPUTED = [0, 1, 3]
REUSE_STEP_SHARE = 0.05  # a reuse step costs under 5% of a computed one
# the wgmma kernels of K4, K6 and K2 at D=128 (384 threads, one block an
# SM) launch at 168, the most that lets setmaxnreg give the two consumer
# warpgroups 232 and the producer 40; K1's and K2's at D=64 (512 threads:
# three consumer warpgroups) at 128, setmaxnreg 160 / 32; K5's at D=64 (384
# threads) at 168; K8's segmented instances of K1, K4, K5 and K6 as the
# kernels they are instances of. The build fails past these counts or on a
# spill
PINNED_REGISTERS = {"flash_fwd_sm90_kernel": 168, "flash_bwd_sm90_dq_kernel": 168,
                    "flash_bwd_sm90_dkv_kernel": 168, "flash_fwd_sm90_d64_kernel": 128,
                    "flash_bwd_sm90_d64_dq_kernel": 168, "flash_bwd_sm90_d64_dkv_kernel": 168,
                    "flash_fwd_sm90_d64_seg_kernel": 128, "flash_fwd_sm90_seg_kernel": 168,
                    "flash_bwd_sm90_d64_seg_dq_kernel": 168,
                    "flash_bwd_sm90_d64_seg_dkv_kernel": 168,
                    "flash_bwd_sm90_seg_dq_kernel": 168, "flash_bwd_sm90_seg_dkv_kernel": 168,
                    "sage_fwd_sm90_kernel": 168, "sage_fwd_sm90_d64_kernel": 128,
                    "w8a8_gemm_sm90_kernel": 168, "gemm_probe_i8_kernel": 168,
                    "gemm_probe_bf16_kernel": 168, "gemm_probe_bf16_t_kernel": 168}
# the forward instances on a path: K1 at D=64 and K4 (fixed length and K7),
# K8 (their segmented instances) at D=64 and D=128, and K2 at D=64 and D=128
# (and K7 in it), printed with their registers and spills; they also go
# into the kernels line
FORWARD_INSTANCES = {"flash_fwd": "flash_fwd_sm90_d64_kernel",
                     "flash_fwd_d128": "flash_fwd_sm90_kernel",
                     "flash_fwd_seg": "flash_fwd_sm90_d64_seg_kernel",
                     "flash_fwd_seg_d128": "flash_fwd_sm90_seg_kernel",
                     "sage_fwd": "sage_fwd_sm90_d64_kernel",
                     "sage_fwd_d128": "sage_fwd_sm90_kernel"}
# the backward instances on a path or held (K5 at D=64 and K6, each with
# and without kv_lens, K8), printed with their registers and spills
BACKWARD_INSTANCES = ("flash_bwd_sm90_d64_dq_kernel", "flash_bwd_sm90_d64_dkv_kernel",
                      "flash_bwd_sm90_dq_kernel", "flash_bwd_sm90_dkv_kernel",
                      "flash_bwd_sm90_d64_seg_dq_kernel", "flash_bwd_sm90_d64_seg_dkv_kernel",
                      "flash_bwd_sm90_seg_dq_kernel", "flash_bwd_sm90_seg_dkv_kernel")
# the wgmma kernels (K1, K2 and K5 at D=64, K4, K2 and K6 at D=128, K8's
# instances of K1, K4, K5 and K6; K3's GEMM and K9/K10's three, 384
# threads, setmaxnreg 40 / 232, pinned at 168) by source, whose SASS and
# ptxas logs the build phase reads per kernel function
WGMMA_KERNELS = {"flash_fwd_sm90_d64": ("flash_fwd_sm90_d64_kernel",
                                        "flash_fwd_sm90_d64_seg_kernel"),
                 "flash_bwd_sm90_d64": ("flash_bwd_sm90_d64_dq_kernel",
                                        "flash_bwd_sm90_d64_dkv_kernel",
                                        "flash_bwd_sm90_d64_seg_dq_kernel",
                                        "flash_bwd_sm90_d64_seg_dkv_kernel"),
                 "flash_fwd_sm90": ("flash_fwd_sm90_kernel", "flash_fwd_sm90_seg_kernel"),
                 "flash_bwd_sm90": ("flash_bwd_sm90_dq_kernel", "flash_bwd_sm90_dkv_kernel",
                                    "flash_bwd_sm90_seg_dq_kernel",
                                    "flash_bwd_sm90_seg_dkv_kernel"),
                 "sage_fwd_sm90_d64": ("sage_fwd_sm90_d64_kernel",),
                 "sage_fwd_sm90": ("sage_fwd_sm90_kernel",),
                 "w8a8": ("w8a8_gemm_sm90_kernel",),
                 "gemm_probe": ("gemm_probe_i8_kernel", "gemm_probe_bf16_kernel",
                                "gemm_probe_bf16_t_kernel")}
# K2's wgmma kernels: their Q K^T on the int8 tensor cores (IGMMA) besides
# the bf16 P V (HGMMA); the int32 -> f32 conversions (I2F, and I2FP, which
# ptxas may emit for it) counted in their SASS and printed
INT8_WGMMA_KERNELS = ("sage_fwd_sm90_d64_kernel", "sage_fwd_sm90_kernel")
# the int8 GEMMs (K3, K9 and K10 in int8): int8 wgmma (IGMMA) only
INT8_GEMM_KERNELS = ("w8a8_gemm_sm90_kernel", "gemm_probe_i8_kernel")
# the GEMM kernels whose registers go into the kernels line
GEMM_INSTANCES = {"w8a8": {"gemm": "w8a8_gemm_sm90_kernel"},
                  "gemm_probe": {"int8": "gemm_probe_i8_kernel", "bf16": "gemm_probe_bf16_kernel"},
                  "gemm_probe_t": {"bf16": "gemm_probe_bf16_t_kernel",
                                   "int8 transpose": "transpose_i8_kernel"}}
# K5's and K6's wgmma kernels, and K8's backward (their segmented
# instances, entries of their own) at D=64 and D=128: their dq and dk/dv
# instances, whose registers go into the kernels line
BACKWARD_PAIRS = {
    "flash_bwd": {"dq": "flash_bwd_sm90_d64_dq_kernel", "dkv": "flash_bwd_sm90_d64_dkv_kernel"},
    "flash_bwd_d128": {"dq": "flash_bwd_sm90_dq_kernel", "dkv": "flash_bwd_sm90_dkv_kernel"},
    "flash_bwd_seg": {"dq": "flash_bwd_sm90_d64_seg_dq_kernel",
                      "dkv": "flash_bwd_sm90_d64_seg_dkv_kernel"},
    "flash_bwd_seg_d128": {"dq": "flash_bwd_sm90_seg_dq_kernel",
                           "dkv": "flash_bwd_sm90_seg_dkv_kernel"}}
# HunyuanVideo T2V at 33 frames of 720x1280, cut from the released 129
# frames (hunyuan_path): 9 latent frames of 90x160, 32,400 image tokens
# after the 2x2 patch, then 256 text tokens; 24 heads of 128
HUNYUAN_FRAMES, HUNYUAN_HEIGHT, HUNYUAN_WIDTH = 33, 720, 1280
HUNYUAN_STEPS = 2
HUNYUAN_TEXT = 256
HUNYUAN_IMAGE_TOKENS = ((HUNYUAN_FRAMES - 1) // 4 + 1) * (HUNYUAN_HEIGHT // 16) * (HUNYUAN_WIDTH // 16)
HUNYUAN_SHAPE = (1, 24, HUNYUAN_IMAGE_TOKENS + HUNYUAN_TEXT, 128)  # B, H, S, D of the joint attention
HUNYUAN_PROMPT = "a red fox runs through fresh snow"
# K7 parity at the unaligned shapes: B = 2, lengths (Skv, 0) and (Skv - 37, 1)
K7_LENS = [lambda skv: [skv, 0], lambda skv: [skv - 37, 1]]
K7_FLOOR_LSE = -1e4  # the lse of a sample with no valid key (the floored running max)
# HunyuanVideo LoRA SFT (examples/training/sft/hunyuan_video/
# modal_labs_dissolve/train.sh): the 49x480x768 bucket is 13 latent frames
# of 60x96, 13 x 30 x 48 = 18,720 image tokens after the 2x2 patch, then the
# 256 text tokens of phase 11's prompt
HUNYUAN_TRAIN_FRAMES, HUNYUAN_TRAIN_HEIGHT, HUNYUAN_TRAIN_WIDTH = 49, 480, 768
HUNYUAN_TRAIN_IMAGE_TOKENS = (((HUNYUAN_TRAIN_FRAMES - 1) // 4 + 1) * (HUNYUAN_TRAIN_HEIGHT // 16)
                              * (HUNYUAN_TRAIN_WIDTH // 16))
HUNYUAN_TRAIN_SHAPE = (1, 24, HUNYUAN_TRAIN_IMAGE_TOKENS + HUNYUAN_TEXT, 128)
# K7's backward in K5's form, on no model's path (Hunyuan's head_dim is
# 128): held and timed at the training shape with head_dim 64
HUNYUAN_TRAIN_SHAPE_D64 = HUNYUAN_TRAIN_SHAPE[:3] + (64,)
# the small Hunyuan pipeline (no CFG: guidance is an embedding) against the
# plain masked dense attention: FlowMatch's steps move the latents by
# 0.125 and 0.875 of the predicted velocity (shift 7 over 2 steps), so one
# bf16 ulp of a velocity near 1 (2^-7) moves a latent by ~0.007. Both
# providers measured 2^-7 on the H100; the limit is about three times that.
# The planted fault (flash with the transformer's kv_lens dropped, so the
# padded text keys are attended) must break it
HUNYUAN_E2E_ATOL = 0.025
# K8 (packed segments) at full width, bf16, each case (shape, segment
# lengths from token 0, num_segments; the tokens past them are padding, -1):
# (a) CogVideoX's joint stream, the target [text||video] segment 0 and the
#     reference [ref_text||ref_video] segment 1, its last 64 tokens padding;
# (b) Wan's joint stream, its two 20,280-token halves;
# (c) the Hunyuan LoRA stream: its valid tokens segment 0 (the count comes
#     from phase 11's prompt at run time), the 213 padded text slots -1
SEG_CASES = {"a": (MAIN_SHAPE, (MAIN_SHAPE[2] // 2, MAIN_SHAPE[2] // 2 - 64), 2),
             "b": (WAN_JOINT, (WAN_JOINT[2] // 2, WAN_JOINT[2] // 2), 2),
             "c": (HUNYUAN_TRAIN_SHAPE, None, 1)}
# the ring body on one card: key blocks of cases (a) and (c)
RING_BLOCKS = (2, 4)
# the CogVideoX main path under "ring" on a one-rank NCCL group: 1 step, one
# rotate method (at one rank each method is the same local kernel call)
RING_STEPS = 1
RING_METHOD = "allgather"


# the small chunk-form pipeline under DPM and the adaptive cache, K3 against
# its plain version: both give the same bf16 projections up to an output
# rounding, which a step moves by at most a few bf16 ulps of the latents
W8A8_E2E_ATOL = 0.05


def log(msg):
    print(msg, flush=True)


def power_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def mem_total_gib():
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


class FakeTokenizer:
    """Deterministic character ids in the vocabulary, padded to max_length.
    With ``eos`` that id follows the text (CLIP pools at it); with
    ``prefix`` a text starting with it maps the prefix to ``prefix_tokens``
    ids, as a real tokenizer maps HunyuanVideo's llava template to its
    crop_start tokens."""

    def __init__(self, vocab_size, eos=None, prefix=None, prefix_tokens=0):
        self.vocab_size = vocab_size
        self.eos, self.prefix, self.prefix_tokens = eos, prefix, prefix_tokens

    def _ids(self, text):
        head = []
        if self.prefix and text.startswith(self.prefix):
            n = len(self.prefix)
            head = [sum(map(ord, self.prefix[j * n // self.prefix_tokens:
                                             (j + 1) * n // self.prefix_tokens]))
                    for j in range(self.prefix_tokens)]
            text = text[n:]
        ids = [(c * 7 + j) % (self.vocab_size - 1) + 1
               for j, c in enumerate(head + [ord(ch) for ch in text])]
        return ids + ([self.eos] if self.eos is not None else [])

    def __call__(self, texts, padding=None, max_length=226, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = self._ids(t)[:max_length]
            ids[i, :len(row)] = row
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def decoded_frames(latent_frames, frame_batch=2):
    """Frames the CogVideoX decoder gives for a latent count: an odd chunk
    keeps its first frame and upsamples the rest 4x; an even one 4x."""
    n = max(latent_frames // frame_batch, 1)
    rem = latent_frames % frame_batch
    sizes = [frame_batch + rem] + [frame_batch] * (n - 1)
    return sum(1 + 4 * (c - 1) if c % 2 else 4 * c for c in sizes)


def n_params(module):
    return sum(p.numel() for p in module.parameters())


# ---------------------------------------------------------------------------
# phase 3: kernel parity and times
# ---------------------------------------------------------------------------

def time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kind, b, h, sq, skv, d):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    the kernel's function on these shapes. Operations: 4*B*H*Sq*Skv*D
    (QK^T and PV), all at the bf16 peak for flash, the QK^T half at the int8
    peak for sage. Bytes: q, k, v and out in bf16 and lse in f32, each moved
    once."""
    flops = 4 * b * h * sq * skv * d
    t_ops = flops / PEAK_BF16 if kind == "flash" else flops / 2 / PEAK_INT8 + flops / 2 / PEAK_BF16
    t_bytes = (2 * b * h * (2 * sq + 2 * skv) * d + 4 * b * h * sq) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_bound(b, h, sq, skv, d):
    """(ms, "operations" or "bytes") for K5 and K6: 10*B*H*Sq*Skv*D operations (q k^T,
    dout v^T, ds k, p^T dout, ds^T q) at the bf16 peak; bytes: q, k, v, out,
    dout, dq, dk, dv in bf16 and lse in f32, each moved once."""
    t_ops = 10 * b * h * sq * skv * d / PEAK_BF16
    t_bytes = (2 * b * h * d * (4 * sq + 4 * skv) + 4 * b * h * sq) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


BWD_SPECS = {
    "flash_bwd": dict(source="vap_tpu_torch/csrc/flash_bwd_sm90_d64.cu",
                      replaces="vap_tpu/ops/flash_attention.py:1131"),
    "flash_bwd_d128": dict(source="vap_tpu_torch/csrc/flash_bwd_sm90.cu",
                           replaces="vap_tpu/ops/flash_attention.py:1271"),
}
W8A8_SPECS = {
    "w8a8": dict(source="vap_tpu_torch/csrc/w8a8.cu", replaces="vap_tpu/ops/int8_matmul.py:73"),
    "w8a8_wan": dict(source="vap_tpu_torch/csrc/w8a8.cu",
                     replaces="vap_tpu/ops/int8_matmul.py:73"),
    "gemm_probe": dict(source="vap_tpu_torch/csrc/gemm_probe.cu",
                       replaces="scripts/linear_bench.py:99"),
    "gemm_probe_t": dict(source="vap_tpu_torch/csrc/gemm_probe.cu",
                         replaces="scripts/linear_bench.py:142"),
}


def kernel_specs():
    """The kernels of the main paths, each with its wrapper, plain version,
    launch counter, parity shapes and the main-path shape it is timed at."""
    from vap_tpu_torch.ops import flash_attention as fa

    flash = (fa.flash_attention_forward, fa.flash_attention_forward_plain)
    sage = (fa.flash_attention_int8_forward, fa.flash_attention_int8_forward_plain)
    d64 = [(1, 48, sq, skv, 64) for sq, skv in PARITY_SHAPES] + [MAIN_SHAPE[:3] + MAIN_SHAPE[2:]]
    d128 = ([(1, 40, sq, skv, 128) for sq, skv in PARITY_SHAPES] + [WAN_JOINT[:3] + WAN_JOINT[2:]]
            + WAN_CROSS)
    # K4 also runs Wan training's self-attention (one branch, 20,280 tokens)
    flash_d128 = d128 + WAN_TRAIN_ATTN[:1]
    src = "vap_tpu_torch/csrc/"
    ref = "vap_tpu/ops/flash_attention.py:"
    return {
        "flash_fwd": dict(fns=flash, kind="flash", counter="launches_d64", shapes=d64,
                          timed=MAIN_SHAPE, source=src + "flash_fwd_sm90_d64.cu",
                          replaces=ref + "479"),
        "flash_fwd_d128": dict(fns=flash, kind="flash", counter="launches_d128", shapes=flash_d128,
                               timed=WAN_JOINT, source=src + "flash_fwd_sm90.cu",
                               replaces=ref + "225", timed_cross=WAN_CROSS),
        "sage_fwd": dict(fns=sage, kind="sage", counter="launches", shapes=d64,
                         timed=MAIN_SHAPE, source=src + "sage_fwd_sm90_d64.cu",
                         replaces=ref + "816"),
        "sage_fwd_d128": dict(fns=sage, kind="sage", counter="launches", shapes=d128,
                              timed=WAN_JOINT, source=src + "sage_fwd_sm90.cu",
                              replaces=ref + "816", timed_cross=WAN_CROSS),
    }


def prepass_ms(q, k, kv_lens=None):
    """K2's pre-pass kernel alone on these inputs, ms a call."""
    from vap_tpu_torch.ops import flash_attention as fa

    return time_ms(lambda: fa.sage_prepass(q, k, q.shape[-1] ** -0.5, kv_lens), iters=5, warmup=2)


def kernel_parity(dev):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, h, sq, skv, d):
        return [torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                for s in (sq, skv, skv)]

    def rolled_in_tiles(v):
        """v with its rows rolled by one inside every full kv tile."""
        n = v.shape[2] // KV_TILE * KV_TILE
        tiles = v[:, :, :n].unflatten(2, (-1, KV_TILE)).roll(1, dims=3).flatten(2, 3)
        return torch.cat([tiles, v[:, :, n:]], dim=2)

    def compare(name, kernel, plain, q, k, v):
        out, lse = kernel(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = plain(q, k, v)
        ref_max = ref_out.float().abs().max().item()
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        fault = (kernel(q, k, rolled_in_tiles(v))[0].float() - ref_out.float()).abs().max().item()
        log(f"  {name} {tuple(q.shape)} x {k.shape[2]}: out max|err| {err:.3e}, "
            f"/ max|ref| {ref_max:.3e} = {err / ref_max:.3e} (tol {OUT_REL_TOL}; planted fault "
            f"{fault / ref_max:.3e}), lse max|err| {lse_err:.3e} (tol {LSE_ATOL}), finite {finite}")
        if not (finite and err <= OUT_REL_TOL * ref_max and lse_err <= LSE_ATOL):
            raise AssertionError(f"{name} disagrees with its plain version")
        if fault <= OUT_REL_TOL * ref_max:
            raise AssertionError(f"{name}: the out limit does not catch V rows out of place")
        return err

    results = {}
    for name, spec in kernel_specs().items():
        kernel, plain = spec["fns"]
        errs = []
        for b, h, sq, skv, d in spec["shapes"]:
            errs.append(compare(name, kernel, plain, *qkv(b, h, sq, skv, d)))
            torch.cuda.empty_cache()
        b, h, s, d = spec["timed"]
        q, k, v = qkv(b, h, s, s, d)
        ms = time_ms(lambda: kernel(q, k, v), iters=5, warmup=2)
        # the parity loop above ran the plain version at this shape already
        plain_ms = time_ms(lambda: plain(q, k, v), iters=1, warmup=0)
        library_ms = None
        if spec["kind"] == "flash":  # one PyTorch call with the same function: a yardstick
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5,
                                     warmup=2)
        bound_ms, bound_by = bound(spec["kind"], b, h, s, s, d)
        tflops = 4 * b * h * s * s * d / (ms * 1e-3) / 1e12
        # K2's time includes its pre-pass kernel, timed alone beside it
        pre = prepass_ms(q, k) if spec["kind"] == "sage" else None
        log(f"  {name} at {spec['timed']}: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s)"
            + (f" of which the pre-pass {pre:.3f} ms" if pre is not None else "")
            + f", plain {plain_ms:.3f} ms, SDPA flash "
            f"{library_ms if library_ms is None else round(library_ms, 3)} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by})")
        results[name] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "shape": list(spec["timed"])}
        if pre is not None:
            results[name]["prepass_ms"] = pre
        del q, k, v
        torch.cuda.empty_cache()
        cross = []
        for b, h, sq, skv, d in spec.get("timed_cross", ()):  # K4 and K2 at Wan's cross shapes
            q, k, v = qkv(b, h, sq, skv, d)
            c_ms = time_ms(lambda: kernel(q, k, v), iters=5, warmup=2)
            c_plain = time_ms(lambda: plain(q, k, v), iters=1, warmup=0)  # run in the parity loop
            c_lib = c_pre = None
            if spec["kind"] == "flash":
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    c_lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5,
                                    warmup=2)
            else:
                c_pre = prepass_ms(q, k)
            c_bound, c_by = bound(spec["kind"], b, h, sq, skv, d)
            log(f"  {name} at {(b, h, sq, d)} x {skv}: kernel {c_ms:.3f} ms"
                + (f" of which the pre-pass {c_pre:.3f} ms" if c_pre is not None else "")
                + f", plain {c_plain:.3f} ms, SDPA flash "
                f"{c_lib if c_lib is None else round(c_lib, 3)} ms, bound {c_bound:.3f} ms ({c_by})")
            cross.append({"shape": [b, h, sq, skv, d], "ms": c_ms, "plain_ms": c_plain,
                          "library_ms": c_lib, "bound_ms": c_bound, "bound_by": c_by})
            if c_pre is not None:
                cross[-1]["prepass_ms"] = c_pre
            del q, k, v
        if cross:
            results[name]["cross"] = cross
    return results


# K2's pre-pass (csrc/sage_quant.cu), the quantisation of
# _flash_attention_forward_t_i8 (:835-852) that ran in XLA outside its
# Pallas kernel
PREPASS_SPECS = {
    "sage_quant": dict(source="vap_tpu_torch/csrc/sage_quant.cu",
                       replaces="vap_tpu/ops/flash_attention.py:835"),
}


def prepass_bound(b, h, sq, skv, d):
    """(ms, "bytes"): q and k read once in bf16, q_i8 and k_i8 written once
    and sqk in f32, over the card's memory rate."""
    return 1e3 * (b * h * (sq + skv) * d * 3 + 4 * b * h) / HBM_BYTES_PER_S, "bytes"


def prepass_parity(dev):
    """K2's pre-pass kernel against ``sage_quantize`` at the parity shapes
    (D=64 and 128, B=2, with and without kv_lens over a NaN suffix) and at
    the main-path shape: q_i8 equal, k_i8 within one step (the k mean summed
    in another order), sqk within rtol 1e-6; a planted fault (q rows rolled
    by one) must break the equality. Its time beside the plain version's
    and the bound at CogVideoX's joint shape."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    steps = []

    def compare(b, h, sq, skv, d, lens):
        q, k = [torch.randn((b, h, n, d), generator=gen, device=dev).to(torch.bfloat16)
                for n in (sq, skv)]
        k = k + torch.linspace(-2, 2, d, device=dev).to(torch.bfloat16)  # channel offsets
        if lens is not None:
            lens = torch.tensor(lens, device=dev)
            pad = torch.arange(skv, device=dev)[None, :] >= lens[:, None]
            k = k.masked_fill(pad[:, None, :, None], float("nan"))
        got = fa.sage_prepass(q, k, d ** -0.5, lens)
        torch.cuda.synchronize()
        ref = fa.sage_quantize(q, k, d ** -0.5, lens)
        q_equal = torch.equal(got[0], ref[0])
        step = (got[1].int() - ref[1].int()).abs().max().item()
        sqk_rel = ((got[2] - ref[2]).abs() / ref[2]).max().item()
        fault = torch.equal(fa.sage_prepass(q.roll(1, dims=2), k, d ** -0.5, lens)[0], ref[0])
        log(f"  sage_quant {(b, h, sq, d)} x {skv}, kv_lens {None if lens is None else lens.tolist()}: "
            f"q_i8 equal {q_equal}, k_i8 max step {step}, sqk max rel err {sqk_rel:.3e} (tol 1e-6); "
            f"planted fault (q rows rolled) q_i8 equal {fault}")
        if not (q_equal and step <= 1 and sqk_rel <= 1e-6 and bool(torch.isfinite(got[2]).all())):
            raise AssertionError("sage_quant disagrees with sage_quantize")
        if fault:
            raise AssertionError("sage_quant: the check misses q rows out of place")
        steps.append(step)
        return q, k

    for d in (64, 128):
        for sq, skv in PARITY_SHAPES:
            for lens in (None, *(fn(skv) for fn in K7_LENS)):
                compare(2, 8, sq, skv, d, lens)
    b, h, s, d = MAIN_SHAPE
    q, k = compare(b, h, s, s, d, None)
    ms = prepass_ms(q, k)
    plain_ms = time_ms(lambda: fa.sage_quantize(q, k, d ** -0.5), iters=2, warmup=1)
    bound_ms, bound_by = prepass_bound(b, h, s, s, d)
    log(f"  sage_quant at {MAIN_SHAPE}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by})")
    return {"max_abs_err": max(steps), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": list(MAIN_SHAPE)}


# ---------------------------------------------------------------------------
# phase 3c: K7, the varlen forward in K1, K4 and K2
# ---------------------------------------------------------------------------

VARLEN_SPECS = {
    "flash_fwd_d128_varlen": dict(source="vap_tpu_torch/csrc/flash_fwd_sm90.cu",
                                  replaces="vap_tpu/ops/flash_attention.py:1471"),
    "sage_fwd_d128_varlen": dict(source="vap_tpu_torch/csrc/sage_fwd_sm90.cu",
                                 replaces="vap_tpu/ops/flash_attention.py:957"),
}


def hunyuan_tokenizers():
    """The LLaMA tokenizer (the llava template's prefix as exactly
    crop_start tokens, so the prompt leaves the 256 text slots padded) and
    the CLIP one (EOS after the prompt)."""
    from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig
    from vap_tpu_torch.models.text_encoders.llama import LlamaConfig
    from vap_tpu_torch.pipelines.hunyuan_video import CROP_START, DEFAULT_PROMPT_TEMPLATE_PREFIX

    clip = CLIPTextConfig.clip_vit_l()
    return (FakeTokenizer(LlamaConfig.llava_llama_8b().vocab_size,
                          prefix=DEFAULT_PROMPT_TEMPLATE_PREFIX, prefix_tokens=CROP_START),
            FakeTokenizer(clip.vocab_size, eos=clip.eos_token_id))


def hunyuan_text_len():
    """The valid text tokens of phase 11's prompt (template suffix
    included) in the 256 text slots."""
    from vap_tpu_torch.pipelines.hunyuan_video import (CROP_START, DEFAULT_PROMPT_TEMPLATE_PREFIX,
                                                       DEFAULT_PROMPT_TEMPLATE_SUFFIX)

    text = DEFAULT_PROMPT_TEMPLATE_PREFIX + HUNYUAN_PROMPT + DEFAULT_PROMPT_TEMPLATE_SUFFIX
    mask = hunyuan_tokenizers()[0]([text], max_length=HUNYUAN_TEXT + CROP_START)["attention_mask"]
    return int(mask[0, CROP_START:].sum())


def hunyuan_kv_len(image_tokens=HUNYUAN_IMAGE_TOKENS):
    """The joint attention's valid key count of a Hunyuan call with phase
    11's prompt: every image token and the prompt's text tokens."""
    return image_tokens + hunyuan_text_len()


def varlen_parity(dev, kv_len):
    """K7 against its plain version in K1 (D=64), K4 and K2 (D=128) at the
    unaligned shapes with B=2, and in K4 and K2 at the Hunyuan joint shape
    with ``kv_len`` valid keys: a NaN suffix that must not move the output,
    zero rows and the floored lse where a sample has no key, two planted
    faults; then the times at the joint shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    flash = (fa.flash_attention_forward, fa.flash_attention_forward_plain)
    sage = (fa.flash_attention_int8_forward, fa.flash_attention_int8_forward_plain)
    b, h, s, d = HUNYUAN_SHAPE
    specs = {"flash_fwd_varlen": (flash, "flash", 64, False),
             "flash_fwd_d128_varlen": (flash, "flash", 128, True),
             "sage_fwd_d128_varlen": (sage, "sage", 128, True)}

    def suffix(x, lens, fill):
        pad = torch.arange(x.shape[2], device=dev)[None, :] >= lens[:, None]
        return x.masked_fill(pad[:, None, :, None], fill)

    def rolled_in_tiles(v):
        n = v.shape[2] // KV_TILE * KV_TILE
        tiles = v[:, :, :n].unflatten(2, (-1, KV_TILE)).roll(1, dims=3).flatten(2, 3)
        return torch.cat([tiles, v[:, :, n:]], dim=2)

    def compare(name, kernel, plain, shape, lens):
        q, k, v = [torch.randn(shape[:2] + (n, shape[-1]), generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (shape[2], shape[3], shape[3])]
        lens = torch.tensor(lens, device=dev, dtype=torch.int32)
        k_nan, v_nan = suffix(k, lens, float("nan")), suffix(v, lens, float("nan"))
        out, lse = kernel(q, k_nan, v_nan, kv_lens=lens)
        torch.cuda.synchronize()
        ref_out, ref_lse = plain(q, k_nan, v_nan, kv_lens=lens)
        ref_max = ref_out.float().abs().max().item()
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        still = torch.equal(out, kernel(q, k, v, kv_lens=lens)[0])  # a random suffix instead
        empty = lens == 0
        zero_rows = bool((out[empty] == 0).all()) and bool(
            ((lse[empty] - K7_FLOOR_LSE).abs() <= LSE_ATOL).all())
        fault_lens = (kernel(q, suffix(k, lens, 1e4), suffix(v, lens, 1e4))[0].float()
                      - ref_out.float()).abs().max().item()
        fault_roll = (kernel(q, k, rolled_in_tiles(v), kv_lens=lens)[0].float()
                      - ref_out.float()).abs().max().item()
        log(f"  {name} {tuple(q.shape)} x {k.shape[2]}, kv_lens {lens.tolist()}: out max|err| "
            f"{err:.3e} / max|ref| {ref_max:.3e} = {err / ref_max:.3e} (tol {OUT_REL_TOL}; planted "
            f"faults: no kv_lens {fault_lens / ref_max:.3e}, V rolled {fault_roll / ref_max:.3e}), "
            f"lse max|err| {lse_err:.3e} (tol {LSE_ATOL}), finite {finite}, NaN suffix leaves the "
            f"output unchanged {still}, empty samples zero with lse {K7_FLOOR_LSE:g} {zero_rows}")
        if not (finite and still and zero_rows and err <= OUT_REL_TOL * ref_max
                and lse_err <= LSE_ATOL):
            raise AssertionError(f"{name} disagrees with its plain version")
        if fault_lens <= OUT_REL_TOL * ref_max or fault_roll <= OUT_REL_TOL * ref_max:
            raise AssertionError(f"{name}: the out limit misses a planted fault")
        return err, (q, k, v, lens)

    results = {}
    for name, ((kernel, plain), kind, dim, on_path) in specs.items():
        errs = []
        for sq, skv in PARITY_SHAPES:
            for lens in K7_LENS:
                errs.append(compare(name, kernel, plain, (2, 8, sq, skv, dim), lens(skv))[0])
        if not on_path:  # K1's varlen form: held, on no model's path
            continue
        err, (q, k, v, lens) = compare(name, kernel, plain, (b, h, s, s, d), [kv_len])
        errs.append(err)
        ms = time_ms(lambda: kernel(q, k, v, kv_lens=lens), iters=5, warmup=2)
        # the same kernel over all S keys: what the shorter key loop saves
        fixed_ms = time_ms(lambda: kernel(q, k, v), iters=5, warmup=2)
        plain_ms = time_ms(lambda: plain(q, k, v, kv_lens=lens), iters=1, warmup=1)
        # one PyTorch call with the same function, a yardstick: SDPA's
        # memory-efficient backend takes a boolean key mask (flash takes none)
        keep = (torch.arange(s, device=dev) < kv_len)[None, None, None, :]
        library_ms = None
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
                                     iters=5, warmup=2)
        except RuntimeError as exc:  # the backend refuses these inputs: no yardstick
            log(f"  {name}: SDPA memory-efficient with a key mask refused: {exc}")
        bound_ms, bound_by = bound(kind, b, h, s, kv_len, d)
        tflops = 4 * b * h * s * kv_len * d / (ms * 1e-3) / 1e12
        pre = prepass_ms(q, k, lens) if kind == "sage" else None
        log(f"  {name} at {HUNYUAN_SHAPE}, {kv_len} valid keys: kernel {ms:.3f} ms ({tflops:.1f} "
            f"TFLOP/s over the valid keys"
            + (f"; of which the pre-pass {pre:.3f} ms" if pre is not None else "")
            + f"; without kv_lens, all {s} keys, {fixed_ms:.3f} ms), plain "
            f"{plain_ms:.3f} ms, SDPA memory-efficient with a key mask "
            f"{library_ms if library_ms is None else round(library_ms, 3)} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by})")
        results[name] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "shape": list(HUNYUAN_SHAPE), "kv_len": kv_len,
                         "fixed_length_ms": fixed_ms}
        if pre is not None:
            results[name]["prepass_ms"] = pre
        del q, k, v
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3d: K8, the packed-segment forward in K1 and K4, and the ring body
# ---------------------------------------------------------------------------

SEG_SPECS = {
    "flash_fwd_seg": dict(source="vap_tpu_torch/csrc/flash_fwd_sm90_d64.cu",
                          replaces="vap_tpu/ops/flash_attention.py:1572"),
    "flash_fwd_seg_d128": dict(source="vap_tpu_torch/csrc/flash_fwd_sm90.cu",
                               replaces="vap_tpu/ops/flash_attention.py:1572"),
}


def walked_share(ids, d, kernel):
    """The share of (block, tile) pairs the tile rule (``segment_tile_span``)
    lets K8's wgmma kernel ``kernel`` ("fwd", "dq" or "dkv") walk at
    head_dim d for the same ids on both sides: the rule's count, not a
    measurement; ``walk_checked`` shows that the kernel reads no tile
    outside it."""
    from vap_tpu_torch.ops import flash_attention as fa

    walked = fa.segment_tile_span(ids, ids, *fa.SEGMENT_TILES[(d, kernel)])
    return walked.float().mean().item()


# the input a K8 kernel reads in the tiles it walks, poisoned by
# walk_checked: v for the forward, k for the dq kernel, dout for the dk/dv
# kernel (index in (q, k, v, out, lse, dout))
POISONED_INPUT = {"fwd": 2, "dq": 1, "dkv": 5}


def walk_checked(name, kernel, d, args, q_ids, kv_ids, num_segments, clean):
    """K8's walk held to the tile rule: per round of ``segment_walk_rounds``
    (at the kernel's tile sizes), the rows of the tiles the round's blocks
    leave out set to NaN in the input ``kernel`` reads there
    (POISONED_INPUT); the blocks' rows must equal ``clean`` (the outputs
    of ``args`` = (q, k, v[, out, lse, dout]): (out, lse), (dq,) or (dk, dv))
    to the bit, as a tile the kernel loaded and scored would multiply a zero
    p by NaN. Then NaN in the tiles the first round's blocks walk must reach
    their rows (the check can see). Returns the number of rounds."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    seg = (q_ids, kv_ids, num_segments)

    def run(a):
        if kernel == "fwd":
            return fa.flash_attention_segmented_forward(*a[:3], *seg)
        dq, dk, dv = fa.flash_attention_backward(*a, segment_ids=seg)
        return (dq,) if kernel == "dq" else (dk, dv)

    def poisoned(rows):
        a = list(args)
        x = POISONED_INPUT[kernel]
        a[x] = a[x].masked_fill(rows[:, None, :, None], float("nan"))
        return run(a)

    blocks, tiles = (kv_ids, q_ids) if kernel == "dkv" else (q_ids, kv_ids)
    rounds = fa.segment_walk_rounds(blocks, tiles, *fa.SEGMENT_TILES[(d, kernel)])
    for r, (in_round, skipped) in enumerate(rounds):
        if not all(torch.equal(got.transpose(1, 2)[in_round], want.transpose(1, 2)[in_round])
                   for got, want in zip(poisoned(skipped), clean)):
            raise AssertionError(f"{name} {kernel}: a block read a tile the rule leaves out "
                                 f"(round {r})")
        if r == 0:
            walked = ~skipped & in_round.any(1, keepdim=True)
            got = poisoned(walked)[0].transpose(1, 2)[in_round]
            if walked.any() and bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {kernel}: NaN in the tiles walked did not show")
            del got
    return len(rounds)


def segment_ids(s, lengths, dev):
    """[1, s] int32 ids: segment g over its ``lengths[g]`` tokens from token
    0 on, -1 (padding) after them."""
    import torch

    ids = torch.full((1, s), -1, dtype=torch.int32, device=dev)
    pos = 0
    for g, n in enumerate(lengths):
        ids[0, pos:pos + n] = g
        pos += n
    return ids


def seg_bound(h, s, d, ids, num_segments):
    """(ms, "operations" or "bytes") for K8 with the same ids for queries and
    keys: 4*H*D*sum_g |q_g|*|k_g| operations over the same-segment pairs at
    the bf16 peak; bytes: q, k, v, out in bf16, lse in f32 and the two id
    rows in int32, each moved once."""
    pairs = sum(int((ids == g).sum()) ** 2 for g in range(num_segments))
    t_ops = 4 * h * d * pairs / PEAK_BF16
    t_bytes = (2 * h * 4 * s * d + 4 * h * s + 4 * 2 * s) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def ring_on_one_card(q, k, v, n, q_seg=None, kv_seg=None, num_segments=None, kv_lens=None):
    """Every rank's ``ring_attention_body`` of an n-rank ring, run in turn on
    one card: rank i holds query block i and starts with key block i, and
    its "pass on" step hands it block (i - t) mod n at step t, the block a
    send to rank i + 1 and a receive from rank i - 1 would bring. The ranks'
    (out, lse) concatenated along S."""
    import torch

    from vap_tpu_torch.parallel import ring_attention_body

    sq, skv = q.shape[2] // n, k.shape[2] // n

    def block(x, j, size, dim=2):  # what rank j holds: a contiguous copy
        return x.narrow(dim, j * size, size).contiguous()

    keys = [(block(k, j, skv), block(v, j, skv))
            + (() if kv_seg is None else (block(kv_seg, j, skv, 1),)) for j in range(n)]
    outs, lses = [], []
    for my in range(n):
        held = [my]

        def pass_on(blocks, my=my, held=held):
            held[0] = (held[0] - 1) % n
            return keys[held[0]]

        seg = {} if q_seg is None else dict(q_seg=block(q_seg, my, sq, 1), kv_seg=keys[my][2],
                                            num_segments=num_segments)
        out, lse = ring_attention_body(block(q, my, sq), *keys[my][:2], n, my, pass_on,
                                       kv_lens=kv_lens, **seg)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def held_on_rows(name, out, lse, ref_out, ref_lse, rows):
    """(err, lse_err, ref_max) of out and lse against the reference on the
    query rows ``rows`` [S] (bool); raises past OUT_REL_TOL of max|ref| or
    LSE_ATOL, or if any output (padding rows too) is not finite."""
    import torch

    got, want = out[:, :, rows].float(), ref_out[:, :, rows].float()
    ref_max = want.abs().max().item()
    err = (got - want).abs().max().item()
    lse_err = (lse[:, :, rows] - ref_lse[:, :, rows]).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    if not (finite and err <= OUT_REL_TOL * ref_max and lse_err <= LSE_ATOL):
        raise AssertionError(f"{name}: out max|err| {err:.3e} (max|ref| {ref_max:.3e}), lse "
                             f"{lse_err:.3e}, finite {finite}")
    return err, lse_err, ref_max


def segmented_parity(dev, train_kv_len, registers):
    """K8 against its plain version at the three full-width cases of
    SEG_CASES: in-range rows within the limits, padding rows finite, a
    planted fault (one key's id flipped) that must break the limit, case (c)
    against K7 at kv_lens = its valid tokens; times beside the plain
    version, the bound over the same-segment pairs and SDPA's
    memory-efficient backend with a boolean [1, 1, S, S] mask (a yardstick
    only). Then the ring body on one card over RING_BLOCKS key blocks of
    cases (a) and (c), and once with kv_lens, against one kernel call."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    kernel, plain = fa.flash_attention_segmented_forward, fa.flash_attention_segmented_forward_plain
    built = fa.segment_tiles_built()
    if built != fa.SEGMENT_TILES:
        raise AssertionError(f"K8's kernels tile by {built}, the tile rule by {fa.SEGMENT_TILES}")
    log(f"  K8's (block, tile) rows as the built kernels give them, equal to the tile rule's: "
        f"{ {f'{kern} D={d}': rows for (d, kern), rows in built.items()} }")
    results, ring = {}, {}
    ring_launches = 0
    for case, (shape, lengths, num_segments) in SEG_CASES.items():
        b, h, s, d = shape
        lengths = lengths or (train_kv_len,)
        q, k, v = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3)]
        ids = segment_ids(s, lengths, dev)
        rows = ids[0] >= 0
        out, lse = kernel(q, k, v, ids, ids, num_segments)
        torch.cuda.synchronize()
        ref_out, ref_lse = plain(q, k, v, ids, ids, num_segments)
        name = "flash_fwd_seg_d128" if d == 128 else "flash_fwd_seg"
        err, lse_err, ref_max = held_on_rows(f"{name} ({case})", out, lse, ref_out, ref_lse, rows)
        rounds = walk_checked(f"{name} ({case})", "fwd", d, (q, k, v), ids, ids, num_segments,
                              (out, lse))
        # the planted fault: the key of segment 0 (among its first 256) with
        # the largest score for a segment-0 query moved to another id
        q0 = q[0][:, ids[0] == 0].float()
        j = int((q0 @ k[0, :, :256].float().transpose(-1, -2)).amax(dim=(0, 1)).argmax())
        flipped = ids.clone()
        flipped[0, j] = 1 if num_segments > 1 else -1
        fault = (kernel(q, k, v, ids, flipped, num_segments)[0][:, :, rows].float()
                 - ref_out[:, :, rows].float()).abs().max().item()
        del q0, ref_out, ref_lse
        line = (f"  {name} ({case}) {tuple(shape)}, segments {list(lengths)} + "
                f"{s - sum(lengths)} padding: out max|err| {err:.3e} / max|ref| {ref_max:.3e} = "
                f"{err / ref_max:.3e} (tol {OUT_REL_TOL}; planted fault, key {j}'s id flipped, "
                f"{fault / ref_max:.3e}), lse max|err| {lse_err:.3e} (tol {LSE_ATOL}) on the "
                f"in-range rows, padding rows finite; no tile outside the rule read (NaN in "
                f"those tiles' v, {rounds} rounds, bit-equal)")
        if fault <= OUT_REL_TOL * ref_max:
            raise AssertionError(f"{name} ({case}): the out limit misses a flipped key id")
        entry = {"shape": list(shape), "segments": list(lengths), "max_abs_err": err}
        if case == "c":  # the same function as K7 at kv_lens = the valid tokens
            lens = torch.tensor([sum(lengths)], device=dev, dtype=torch.int32)
            out7, lse7 = fa.flash_attention_forward(q, k, v, kv_lens=lens)
            k7_err = held_on_rows(f"{name} ({case}) vs K7", out, lse, out7, lse7, rows)[0]
            same = torch.equal(out[:, :, rows], out7[:, :, rows])
            line += f"; against K7 at kv_lens {sum(lengths)}: {k7_err:.3e}, bit-equal {same}"
            entry["k7_max_abs_err"] = k7_err
            del out7, lse7
        log(line)
        ms = time_ms(lambda: kernel(q, k, v, ids, ids, num_segments), iters=5, warmup=2)
        plain_ms = time_ms(lambda: plain(q, k, v, ids, ids, num_segments), iters=1, warmup=1)
        library_ms = None
        try:  # one PyTorch call with the same function, a yardstick the port never makes
            mask = (ids[0][:, None] == ids[0][None, :])[None, None]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                     iters=3, warmup=1)
            del mask
        except (RuntimeError, torch.OutOfMemoryError) as exc:  # refused: no yardstick
            log(f"  {name} ({case}): SDPA memory-efficient with a [1,1,S,S] mask refused: {exc}")
        bound_ms, bound_by, pairs = seg_bound(h, s, d, ids, num_segments)
        tflops = 4 * h * d * pairs / (ms * 1e-3) / 1e12
        share = walked_share(ids, d, "fwd")
        log(f"  {name} ({case}): kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s over the same-segment "
            f"pairs, {100 * bound_ms / ms:.1f}% of the bound; the rule walks {100 * share:.1f}% "
            f"of the tile pairs; ptxas {registers.get(name, {})}), plain {plain_ms:.3f} ms, SDPA "
            f"memory-efficient with a [1,1,S,S] mask "
            f"{library_ms if library_ms is None else round(library_ms, 3)} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by})")
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
        if case in ("a", "b"):
            results[name] = {**entry, "registers": registers.get(name, {})}
        else:  # the second D = 128 case rides in K4's form's entry
            results[name]["hunyuan_case"] = entry
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        if case in ("a", "c"):
            counts = fa.flash_attention_segmented_forward
            before = counts.launches + counts.launches_d64 + counts.launches_d128
            for n in RING_BLOCKS:
                r_out, r_lse = ring_on_one_card(q, k, v, n, q_seg=ids, kv_seg=ids,
                                                num_segments=num_segments)
                ring[f"{case}{n}"] = held_on_rows(f"ring body ({case}, n={n})", r_out, r_lse, out,
                                                  lse, rows)[0]
            ring_launches += (counts.launches + counts.launches_d64 + counts.launches_d128
                              - before)
            if case == "a":
                ring_calls = ring_block_times(q, k, v, ids, num_segments)
        if case == "c":  # and once with kv_lens, against one K7 call
            out7, lse7 = fa.flash_attention_forward(q, k, v, kv_lens=lens)
            r_out, r_lse = ring_on_one_card(q, k, v, RING_BLOCKS[-1], kv_lens=lens)
            ring[f"kv_lens{RING_BLOCKS[-1]}"] = held_on_rows(
                "ring body (kv_lens)", r_out, r_lse, out7, lse7, torch.ones_like(rows))[0]
            del out7, lse7
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    log(f"  the ring body on one card (local rotation) against one kernel call, out max|err|: "
        f"{ {key: f'{e:.3e}' for key, e in ring.items()} }; K8 launches there {ring_launches}")
    for name in results:
        results[name]["ring_body_max_abs_err"] = max(ring.values())
        results[name]["ring_body_launches"] = ring_launches
    results["flash_fwd_seg"]["ring_block_calls_ms"] = ring_calls
    return results


def ring_block_times(q, k, v, ids, num_segments):
    """{"n=..": {"shared": ms, "none": ms}}: K8's forward and backward on
    one ring block call of case (a) over RING_BLOCKS blocks, query block 0
    against its own key block (one segment on both sides) and against the
    last key block (no segment in common: no tile walked)."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    fwd, bwd = fa.flash_attention_segmented_forward, fa.flash_attention_backward
    times = {}
    for n in RING_BLOCKS:
        blk = q.shape[2] // n

        def block(x, j, dim=2):
            return x.narrow(dim, j * blk, blk).contiguous()

        q0, ids0 = block(q, 0), block(ids, 0, 1)
        dout = torch.ones_like(q0)
        got = {}
        for which, j in (("shared", 0), ("none", n - 1)):
            kj, vj, idsj = block(k, j), block(v, j), block(ids, j, 1)
            if which == "none" and bool(torch.isin(ids0, idsj).any()):
                raise AssertionError(f"ring blocks 0 and {j} of {n} share a segment")
            out, lse = fwd(q0, kj, vj, ids0, idsj, num_segments)
            seg = (ids0, idsj, num_segments)
            got[which] = (time_ms(lambda: fwd(q0, kj, vj, ids0, idsj, num_segments), 5, 1),
                          time_ms(lambda: bwd(q0, kj, vj, out, lse, dout, segment_ids=seg), 3, 1))
        times[f"n={n}"] = {w: {"forward_ms": f, "backward_ms": b} for w, (f, b) in got.items()}
        log(f"  ring block call, case (a) over {n} blocks, query block 0 of {blk} rows: "
            + "; ".join(f"{w} segment: forward {f:.3f} ms, backward {b:.3f} ms"
                        for w, (f, b) in got.items()))
    return times


# ---------------------------------------------------------------------------
# phase 3e: K8's backward in K5 and K6, and the ring body's backward
# ---------------------------------------------------------------------------

SEG_BWD_SPECS = {
    "flash_bwd_seg": dict(source="vap_tpu_torch/csrc/flash_bwd_sm90_d64.cu",
                          replaces="vap_tpu/ops/flash_attention.py:1581"),
    "flash_bwd_seg_d128": dict(source="vap_tpu_torch/csrc/flash_bwd_sm90.cu",
                               replaces="vap_tpu/ops/flash_attention.py:1581"),
}


def seg_bwd_bound(h, s, d, ids, num_segments):
    """(ms, "operations" or "bytes") for K8's backward with the same ids for
    queries and keys: 10*H*D*sum_g |q_g|*|k_g| operations (q k^T, dout v^T,
    ds k, p^T dout, ds^T q over the same-segment pairs) at the bf16 peak;
    bytes: q, k, v, out, dout, dq, dk, dv in bf16, lse in f32 and the two
    id rows in int32, each moved once."""
    pairs = sum(int((ids == g).sum()) ** 2 for g in range(num_segments))
    t_ops = 10 * h * d * pairs / PEAK_BF16
    t_bytes = (2 * h * 8 * s * d + 4 * h * s + 4 * 2 * s) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def unaligned_seg_ids(sq, skv, dev):
    """[2, Sq] and [2, Skv] ids at an unaligned shape: sample 0 three
    segments over every token (the second crosses a 64-row tile edge);
    sample 1 three query segments, the third with no key, and a padded
    tail on both sides."""
    import torch

    def ids(s, lengths):
        return segment_ids(s, lengths, dev)[0]

    return (torch.stack([ids(sq, [sq // 3, sq // 3, sq - 2 * (sq // 3)]),
                         ids(sq, [sq // 2, sq // 4, sq // 8])]),
            torch.stack([ids(skv, [skv // 3, skv // 3, skv - 2 * (skv // 3)]),
                         ids(skv, [skv // 2, skv // 4])]))


def grad_errors(got, ref):
    """[(max|err|, max|ref|)] of dq, dk and dv."""
    return [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
            for g, r in zip(got, ref)]


def segmented_backward_parity(dev, train_kv_len, registers):
    """K8's backward (K5's form at D=64, K6's at D=128) against its plain
    version: at the unaligned shapes with B=2 (empty segment, padded tail,
    Sq != Skv), then at the three full-width cases of SEG_CASES with dout
    zero on the padding rows; dq, dk and dv within GRAD_REL_TOL of max|ref|,
    dq = 0 where a query's segment has no key, a planted fault (one key's
    id flipped) that must break the limit; case (c) also against K7's
    backward at kv_lens = its valid tokens (and whether the two are
    bit-equal). Times at each case beside the plain version's, the bound
    over the same-segment pairs, SDPA's memory-efficient backward with a
    boolean [1, 1, S, S] mask (a yardstick only) and the registers."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    plain = fa.flash_attention_segmented_backward_plain

    def inputs(b, h, sq, skv, d, q_ids, kv_ids, num_segments):
        q, k, v, dout = [torch.randn((b, h, n, d), generator=gen, device=dev).to(torch.bfloat16)
                         for n in (sq, skv, skv, sq)]
        out, lse = fa.flash_attention_segmented_forward(q, k, v, q_ids, kv_ids, num_segments)
        return q, k, v, out, lse, dout.masked_fill((q_ids < 0)[:, None, :, None], 0)

    def compare(name, args, q_ids, kv_ids, num_segments):
        seg = (q_ids, kv_ids, num_segments)
        got = fa.flash_attention_backward(*args, segment_ids=seg)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ref = plain(*args, *seg)
        errs = grad_errors(got, ref)
        # no key in a query's segment (the kv side has none of its id): dq = 0
        lonely = torch.stack([~torch.isin(q_ids[i], kv_ids[i]) for i in range(len(q_ids))])
        lonely &= q_ids >= 0  # [B, Sq]
        empty = not got[0].transpose(1, 2)[lonely].any()
        # the planted fault: the key of segment 0 (among its first 256) with
        # the largest score for a segment-0 query moved to another id
        q, k = args[0], args[1]
        q0 = q[0][:, q_ids[0] == 0].float()
        scores = (q0 @ k[0, :, :256].float().transpose(-1, -2)).amax(dim=(0, 1))
        j = int(torch.where(kv_ids[0, :256] == 0, scores, -float("inf")).argmax())
        flipped = kv_ids.clone()
        flipped[0, j] = 1 if num_segments > 1 else -1
        fault = grad_errors(fa.flash_attention_backward(*args, segment_ids=(q_ids, flipped,
                                                                             num_segments)), ref)
        worst_fault = max(e / m for e, m in fault)
        log(f"  {name} {tuple(q.shape)} x {k.shape[2]}: " + ", ".join(
            f"d{n} max|err| {e:.3e} / max|ref| {m:.3e} = {e / m:.3e}" for n, (e, m) in
            zip("qkv", errs)) + f" (tol {GRAD_REL_TOL}; planted fault, key {j}'s id flipped, "
            f"{worst_fault:.3e}), finite {finite}, dq of queries with no key exactly 0 {empty}")
        if not (finite and empty and all(e <= GRAD_REL_TOL * m for e, m in errs)):
            raise AssertionError(f"{name} disagrees with its plain version")
        if worst_fault <= GRAD_REL_TOL:
            raise AssertionError(f"{name}: the limit misses a flipped key id")
        return max(e for e, _ in errs), got

    results = {}
    for name, d in (("flash_bwd_seg", 64), ("flash_bwd_seg_d128", 128)):
        errs = []
        for sq, skv in PARITY_SHAPES:
            q_ids, kv_ids = unaligned_seg_ids(sq, skv, dev)
            args = inputs(2, 8, sq, skv, d, q_ids, kv_ids, 3)
            errs.append(compare(name, args, q_ids, kv_ids, 3)[0])
        results[name] = {"unaligned_max_abs_err": max(errs)}
    for case, (shape, lengths, num_segments) in SEG_CASES.items():
        b, h, s, d = shape
        lengths = lengths or (train_kv_len,)
        name = "flash_bwd_seg_d128" if d == 128 else "flash_bwd_seg"
        ids = segment_ids(s, lengths, dev)
        args = inputs(b, h, s, s, d, ids, ids, num_segments)
        err, got = compare(f"{name} ({case})", args, ids, ids, num_segments)
        rounds = {kern: walk_checked(f"{name} ({case})", kern, d, args, ids, ids, num_segments,
                                     clean) for kern, clean in (("dq", got[:1]), ("dkv", got[1:]))}
        log(f"  {name} ({case}): no tile outside the rule read (NaN in those tiles' k for dq, "
            f"dout for dk/dv; rounds {rounds}, bit-equal)")
        entry = {"shape": list(shape), "segments": list(lengths), "max_abs_err": err}
        line = ""
        if case == "c":  # the same function as K7's backward at kv_lens = the valid tokens
            q, k, v, _, _, dout = args
            lens = torch.tensor([sum(lengths)], device=dev, dtype=torch.int32)
            out7, lse7 = fa.flash_attention_forward(q, k, v, kv_lens=lens)
            got7 = fa.flash_attention_backward(q, k, v, out7, lse7, dout, kv_lens=lens)
            k7_err = max(e / m for e, m in grad_errors(got, got7))
            same = all(torch.equal(g, r) for g, r in zip(got, got7))
            line = f"; against K7's backward at kv_lens {sum(lengths)}: {k7_err:.3e} of max|K7|, " \
                   f"bit-equal {same}"
            if k7_err > GRAD_REL_TOL:
                raise AssertionError(f"{name} ({case}) disagrees with K7's backward")
            entry.update(k7_max_rel_err=k7_err, k7_bit_equal=same)
            del out7, lse7, got7
        del got
        seg = (ids, ids, num_segments)
        ms = time_ms(lambda: fa.flash_attention_backward(*args, segment_ids=seg), iters=3,
                     warmup=1)
        plain_ms = time_ms(lambda: plain(*args, *seg), iters=1, warmup=0)
        library_ms = None
        try:  # one PyTorch call with the same function, a yardstick the port never makes
            mask = (ids[0][:, None] == ids[0][None, :])[None, None]
            leaves = [t.detach().requires_grad_() for t in args[:3]]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            library_ms = time_ms(lambda: torch.autograd.grad(o, leaves, args[5], retain_graph=True),
                                 iters=3, warmup=1)
            del mask, leaves, o
        except (RuntimeError, torch.OutOfMemoryError) as exc:  # refused: no yardstick
            log(f"  {name} ({case}): SDPA memory-efficient backward with a [1,1,S,S] mask "
                f"refused: {exc}")
        bound_ms, bound_by, pairs = seg_bwd_bound(h, s, d, ids, num_segments)
        tflops = 10 * h * d * pairs / (ms * 1e-3) / 1e12
        shares = {kernel: walked_share(ids, d, kernel) for kernel in ("dq", "dkv")}
        log(f"  {name} ({case}) {tuple(shape)}, segments {list(lengths)} + {s - sum(lengths)} "
            f"padding: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s over the same-segment pairs, "
            f"{100 * bound_ms / ms:.1f}% of the bound; the rule walks {100 * shares['dq']:.1f}% "
            f"of the tile pairs in dq, {100 * shares['dkv']:.1f}% in dk/dv; "
            f"ptxas {registers.get(name, {})}), plain {plain_ms:.3f} ms, SDPA memory-efficient "
            f"backward with a [1,1,S,S] mask "
            f"{library_ms if library_ms is None else round(library_ms, 3)} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by})" + line)
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
        if case in ("a", "b"):
            unaligned = results[name]["unaligned_max_abs_err"]
            results[name] = {**entry, "max_abs_err": max(err, unaligned),
                             "registers": registers.get(name, {})}
        else:  # the second D = 128 case rides in K6's form's entry
            results[name]["hunyuan_case"] = entry
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        del args
        torch.cuda.empty_cache()
    return results


def ring_backward_on_one_card(q, k, v, out, lse, dout, n, kv_lens=None, ids=None,
                              num_segments=None):
    """Every rank's ring backward (``ring_backward_steps``) of an n-rank
    ring, run in lockstep on one card: rank i holds query block i and key
    block i, and at each pass receives what rank i - 1 sent (the next key
    block with its dk/dv accumulators, then the accumulators coming home).
    The ranks' dq, dk and dv concatenated along S."""
    import torch

    from vap_tpu_torch.parallel import ring_backward_steps

    blk = q.shape[2] // n

    def block(x, j, dim=2):  # what rank j holds: a contiguous copy
        return x.narrow(dim, j * blk, blk).contiguous()

    steps = []
    for my in range(n):
        seg = {} if ids is None else dict(q_seg=block(ids, my, 1), kv_seg=block(ids, my, 1),
                                          num_segments=num_segments)
        steps.append(ring_backward_steps(block(q, my), block(k, my), block(v, my),
                                         block(out, my), block(lse, my), block(dout, my), n, my,
                                         kv_lens=kv_lens, **seg))
    sent = [next(step) for step in steps]
    done = [None] * n
    while None in done:
        received = [sent[(my - 1) % n] for my in range(n)]
        for my, step in enumerate(steps):
            try:
                sent[my] = step.send(received[my])
            except StopIteration as stop:
                done[my] = stop.value
    return [torch.cat([d[i] for d in done], dim=2) for i in range(3)]


# the ring backward on one card: (case of SEG_CASES, mask) over RING_BLOCKS
RING_BWD_CASES = (("a", "segments"), ("a", "none"), ("c", "kv_lens"), ("c", "segments"))


def ring_backward_path(dev, train_kv_len):
    """Sequence-parallel attention's step on one card: the ring body over
    RING_BLOCKS key blocks of cases (a) and (c) (K8, the fixed-length
    kernel and K7 in each block), then its backward from the merged out and
    lse, each against one forward and one backward call over all keys: the
    path K8's forward and backward take in sequence-parallel training.
    Counts are zeroed after the references and read after the ring runs:
    n^2 block calls a run, forward and backward. Returns the launches and
    the largest gradient error."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    prepared = []
    for case, mask in RING_BWD_CASES:
        shape, lengths, num_segments = SEG_CASES[case]
        lengths = lengths or (train_kv_len,)
        q, k, v, dout = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                         for _ in range(4)]
        ids = segment_ids(shape[2], lengths, dev)
        kw = {}
        if mask == "segments":
            out, lse = fa.flash_attention_segmented_forward(q, k, v, ids, ids, num_segments)
            dout = dout.masked_fill((ids < 0)[:, None, :, None], 0)
            kw = dict(segment_ids=(ids, ids, num_segments))
        else:
            if mask == "kv_lens":
                kw = dict(kv_lens=torch.tensor([sum(lengths)], device=dev, dtype=torch.int32))
            out, lse = fa.flash_attention_forward(q, k, v, **kw)
        want = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        prepared.append((case, mask, (q, k, v), dout, kw, ids, num_segments, want))
        del out, lse
    torch.cuda.synchronize()
    reset_counts()
    errs = {}
    t0 = time.perf_counter()
    for case, mask, (q, k, v), dout, kw, ids, num_segments, want in prepared:
        seg = {} if mask != "segments" else dict(q_seg=ids, kv_seg=ids, num_segments=num_segments)
        for n in RING_BLOCKS:
            out, lse = ring_on_one_card(q, k, v, n, kv_lens=kw.get("kv_lens"), **seg)
            got = ring_backward_on_one_card(q, k, v, out, lse, dout, n, kv_lens=kw.get("kv_lens"),
                                            ids=ids if mask == "segments" else None,
                                            num_segments=num_segments)
            e = grad_errors(got, want)
            errs[f"{case}/{mask}/n={n}"] = max(x / m for x, m in e)
            if any(x > GRAD_REL_TOL * m for x, m in e):
                raise AssertionError(f"ring backward ({case}, {mask}, n={n}) disagrees with one "
                                     f"kernel call: {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    per_run = sum(n * n for n in RING_BLOCKS)
    check_launches(launches, {name: per_run for name in (
        "flash_fwd_seg", "flash_bwd_seg", "flash_fwd", "flash_bwd", "flash_fwd_d128_varlen",
        "flash_bwd_d128_varlen", "flash_fwd_seg_d128", "flash_bwd_seg_d128")})
    log(f"  the ring forward and backward on one card (the backward's passes in lockstep) "
        f"against one kernel call each, dq/dk/dv max|err| / max|ref|: "
        f"{ {key: f'{e:.3e}' for key, e in errs.items()} } (tol {GRAD_REL_TOL}); "
        f"{wall:.3f} s for the {len(errs)} runs; launches {launches}")
    del prepared
    torch.cuda.empty_cache()
    return launches, max(errs.values())


# ---------------------------------------------------------------------------
# phase 5b: the CogVideoX main path under "ring" on a one-rank NCCL group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def one_rank_nccl_group(dev):
    """A one-rank NCCL process group on ``dev`` (a free localhost port), and
    the mesh of ``make_mesh(MeshConfig())`` over it; destroyed on exit."""
    import socket

    import torch
    import torch.distributed as dist

    from vap_tpu_torch.parallel import MeshConfig, make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(MeshConfig(), device_type="cuda")
    finally:
        dist.destroy_process_group()


def ring_main_path(pipe, dev):
    """CogVideoXVAPPipeline.__call__ for RING_STEPS step (latents out) under
    "flash", then under "ring" with the mesh of a one-rank NCCL process group
    installed (RING_METHOD; at one rank every rotate method is the same
    local kernel call, so one run stands for the three): the latents equal
    flash's bit for bit, with the same K1 launches (one joint attention a
    block a step) and no other kernel's."""
    import torch

    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.parallel import attention_mesh

    args = main_path_args(RING_STEPS)
    want = {"flash_fwd": RING_STEPS * pipe.transformer.config.num_layers}

    def run(provider):
        reset_counts()
        t0 = time.perf_counter()
        with attention_provider(provider):
            latents = pipe(**args, output_type="latent")
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(launches, want)
        return latents, time.perf_counter() - t0, launches

    ref, wall, _ = run("flash")
    log(f"  flash: latents {tuple(ref.shape)}, {wall:.3f} s")
    with one_rank_nccl_group(dev) as mesh, attention_mesh(mesh, "seq", RING_METHOD):
        latents, wall, launches = run("ring")
    same = torch.equal(latents, ref)
    log(f"  ring ({RING_METHOD}, seq={mesh.size(2)}): {wall:.3f} s, latents equal flash's bit "
        f"for bit {same}; launches {launches}")
    if not same:
        raise AssertionError(f"ring ({RING_METHOD}) latents differ from flash's")


def ring_training_check(trainer, dev, batch):
    """One ``grad_fn`` of phase 8's trainer on ``batch``, with the draws of
    its first step's generator, under "flash" (the trainer's attention
    context, ``auto``), then under the trainer's attention context with the
    mesh of a one-rank NCCL group as its mesh and ``attn_provider_training``
    "ring" (seq = 1: the local kernel's autograd function): the
    loss and every expert gradient bit-equal, with the same K1 and K5
    launches. Leaves no gradient and no data position behind."""
    import torch

    from vap_tpu_torch.training.train_step import draw_step_noise
    from vap_tpu_torch.training.trainer import step_generator

    args, model = trainer.args, trainer.model
    draws = draw_step_noise(trainer.step_cfg, batch["latents"].shape,
                            step_generator(args.seed, 1, dev), dev)
    layers = model.config.num_layers
    mot = len(model.config.block_idx_with_mot_ref)
    want = {"flash_fwd": 2 * layers, "flash_bwd": layers}  # forward and recompute; backward

    def run(ctx):
        reset_counts()
        t0 = time.perf_counter()
        with ctx:
            loss = trainer._grad(model, batch, None, None, **draws)["loss"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        check_launches(launches, want)
        grads = [p.grad for p in trainer.optimizer.params]
        for p in trainer.optimizer.params:
            p.grad = None
        return loss, grads, wall, launches

    loss, grads, wall, _ = run(trainer._attn_ctx())
    with one_rank_nccl_group(dev) as mesh:
        # the trainer's own context: its mesh installed, the provider "ring"
        trainer.mesh = mesh
        trainer.args = dataclasses.replace(args, attn_provider_training="ring",
                                           cp_rotate_method=RING_METHOD)
        try:
            ring_loss, ring_grads, ring_wall, launches = run(trainer._attn_ctx())
        finally:
            trainer.mesh, trainer.args = None, args
    same_loss = torch.equal(loss, ring_loss)
    same = sum((g is None and r is None) or (g is not None and r is not None
                                             and torch.equal(g, r))
               for g, r in zip(grads, ring_grads))
    log(f"  one grad_fn under flash {wall:.3f} s, loss {loss.item():.6f}; under ring "
        f"({RING_METHOD}, seq={mesh.size(2)}, one-rank NCCL group) {ring_wall:.3f} s, loss "
        f"bit-equal {same_loss}, expert gradients bit-equal {same} of {len(grads)}; launches "
        f"each {launches}")
    if not (same_loss and same == len(grads)):
        raise AssertionError("the training step under ring differs from flash's")
    del grads, ring_grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9b: K7's backward, K6 and K5 given kv_lens
# ---------------------------------------------------------------------------

VARLEN_BWD_SPECS = {
    "flash_bwd_d128_varlen": dict(source="vap_tpu_torch/csrc/flash_bwd_sm90.cu",
                                  replaces="vap_tpu/ops/flash_attention.py:1499"),
    "flash_bwd_varlen": dict(source="vap_tpu_torch/csrc/flash_bwd_sm90_d64.cu",
                             replaces="vap_tpu/ops/flash_attention.py:1131"),
}
# the kernels line's K7 forward whose out and lse the backward form is given
# (K1's varlen form, which feeds K5's, is held but has no entry of its own)
FORWARD_OF = {"flash_bwd_d128_varlen": "flash_fwd_d128_varlen"}


def varlen_backward_parity(dev, kv_len):
    """K7's backward against its plain version: K6's form (D=128) and K5's
    (D=64) at the unaligned shapes with B=2, then K6's at the Hunyuan
    training shape with ``kv_len`` valid keys (and K5's at the same shape
    with D=64). dq, dk and dv within GRAD_REL_TOL of max|ref|; a NaN key
    suffix that must not move any output; exact zero dk and dv rows past
    each length and dq = 0 for a sample with none; the K7 forward that
    feeds it (K4 or K1) within OUT_REL_TOL and LSE_ATOL of its plain
    version at every shape, the training shape included; a planted fault
    (forward and backward without kv_lens on a suffix of 1e4) that must
    break the limit; then the times at the training shape beside the plain
    version, the bound over the valid keys and SDPA's memory-efficient
    backward with a boolean key mask (a yardstick only). Returns the
    results and K4's varlen max|err| at the training shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    specs = {"flash_bwd_d128_varlen": (fa.flash_attention_backward_rows_plain,
                                       HUNYUAN_TRAIN_SHAPE),
             "flash_bwd_varlen": (fa.flash_attention_backward_plain, HUNYUAN_TRAIN_SHAPE_D64)}

    def suffix(x, lens, fill):
        pad = torch.arange(x.shape[2], device=dev)[None, :] >= lens[:, None]
        return x.masked_fill(pad[:, None, :, None], fill)

    def inputs(shape, lens):
        b, h, sq, skv, d = shape
        q, k, v, dout = [torch.randn((b, h, n, d), generator=gen, device=dev).to(torch.bfloat16)
                         for n in (sq, skv, skv, sq)]
        return q, k, v, dout, torch.tensor(lens, device=dev, dtype=torch.int32)

    def errors(got, ref):
        return [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
                for g, r in zip(got, ref)]

    def compare(name, plain, shape, lens):
        q, k, v, dout, lens = inputs(shape, lens)
        k_nan, v_nan = suffix(k, lens, float("nan")), suffix(v, lens, float("nan"))
        out, lse = fa.flash_attention_forward(q, k_nan, v_nan, kv_lens=lens)
        got = fa.flash_attention_backward(q, k_nan, v_nan, out, lse, dout, kv_lens=lens)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        # the forward that feeds the backward, held against its own plain
        # version at this shape: the backward's check takes out and lse as given
        ref_out, ref_lse = fa.flash_attention_forward_plain(q, k_nan, v_nan, kv_lens=lens)
        (fwd_err, fwd_max), = errors([out], [ref_out])
        lse_err = (lse - ref_lse).abs().max().item()
        ref = plain(q, k_nan, v_nan, out, lse, dout, kv_lens=lens)
        errs = errors(got, ref)
        # the random suffix in place of the NaN one: no output may move
        still = all(torch.equal(g, r) for g, r in zip(
            got, fa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens)))
        dq, dk, dv = got
        zeros = all(not dk[b, :, n:].any() and not dv[b, :, n:].any() and (n > 0 or not dq[b].any())
                    for b, n in enumerate(lens.tolist()))
        k_big, v_big = suffix(k, lens, 1e4), suffix(v, lens, 1e4)
        out_f, lse_f = fa.flash_attention_forward(q, k_big, v_big)
        # the reference reads no key past the lengths: it holds for this suffix too
        fault = errors(fa.flash_attention_backward(q, k_big, v_big, out_f, lse_f, dout), ref)
        log(f"  {name} {tuple(q.shape)} x {k.shape[2]}, kv_lens {lens.tolist()}: " + ", ".join(
            f"d{n} max|err| {e:.3e} / max|ref| {m:.3e} = {e / m:.3e}" for n, (e, m) in
            zip("qkv", errs)) + f" (tol {GRAD_REL_TOL}; planted fault, no kv_lens on a 1e4 "
            f"suffix: {max(e / m for e, m in fault):.3e}), finite {finite}, NaN suffix leaves "
            f"every output unchanged {still}, dk/dv rows past each length and dq of an empty "
            f"sample exactly 0 {zeros}; its forward: out max|err| {fwd_err:.3e} / max|ref| "
            f"{fwd_max:.3e} = {fwd_err / fwd_max:.3e} (tol {OUT_REL_TOL}), lse max|err| "
            f"{lse_err:.3e} (tol {LSE_ATOL})")
        if not (finite and still and zeros and all(e <= GRAD_REL_TOL * m for e, m in errs)):
            raise AssertionError(f"{name} disagrees with its plain version")
        if not (fwd_err <= OUT_REL_TOL * fwd_max and lse_err <= LSE_ATOL):
            raise AssertionError(f"{name}: the forward it is given disagrees with its plain version")
        if not max(e / m for e, m in fault) > GRAD_REL_TOL:
            raise AssertionError(f"{name}: the limit misses a backward without kv_lens")
        return max(e for e, _ in errs), fwd_err, (q, k, v, out, lse, dout, lens)

    results, forward_errs = {}, {}
    for name, (plain, timed) in specs.items():
        d = timed[-1]
        errs = []
        for sq, skv in PARITY_SHAPES:
            for lens in K7_LENS:
                errs.append(compare(name, plain, (2, 8, sq, skv, d), lens(skv))[0])
        b, h, s, _ = timed
        err, fwd_err, (q, k, v, out, lse, dout, lens) = compare(name, plain, (b, h, s, s, d),
                                                                [kv_len])
        errs.append(err)
        if name in FORWARD_OF:
            forward_errs[FORWARD_OF[name]] = fwd_err
        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens),
                     iters=3, warmup=1)
        fixed_ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), iters=3,
                           warmup=1)
        plain_ms = time_ms(lambda: plain(q, k, v, out, lse, dout, kv_lens=lens), iters=1, warmup=1)
        # one PyTorch call with the same function, a yardstick: the backward
        # of SDPA's memory-efficient backend with a boolean key mask
        keep = (torch.arange(s, device=dev) < kv_len)[None, None, None, :]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        library_ms = None
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
            library_ms = time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                                 iters=3, warmup=1)
            del o
        except RuntimeError as exc:  # the backend refuses these inputs: no yardstick
            log(f"  {name}: SDPA memory-efficient backward with a key mask refused: {exc}")
        bound_ms, bound_by = bwd_bound(b, h, s, kv_len, d)
        tflops = 10 * b * h * s * kv_len * d / (ms * 1e-3) / 1e12
        log(f"  {name} at {(b, h, s, d)}, {kv_len} valid keys: kernel {ms:.3f} ms ({tflops:.1f} "
            f"TFLOP/s over the valid keys; without kv_lens, all {s} keys, {fixed_ms:.3f} ms), "
            f"plain {plain_ms:.3f} ms, SDPA memory-efficient backward with a key mask "
            f"{library_ms if library_ms is None else round(library_ms, 3)} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by})")
        results[name] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "shape": [b, h, s, s, d], "kv_len": kv_len, "fixed_length_ms": fixed_ms}
        del q, k, v, out, lse, dout, leaves
        torch.cuda.empty_cache()
    return results, forward_errs


# ---------------------------------------------------------------------------
# phase 3b: K3 (W8A8), K9 and K10 (the GEMM rate probe)
# ---------------------------------------------------------------------------

def gemm_bound(m, k, n, in_bytes, out_bytes, peak, extra_ops_f32=0, extra_bytes=0):
    """(ms, "operations" or "bytes") of an [m, k] x [k, n] product: 2mnk
    tensor-core operations at ``peak`` (plus any float32 elementwise work at
    the float32 peak); bytes: both inputs read once, the output written
    once, plus ``extra_bytes``."""
    t_ops = 2 * m * n * k / peak + extra_ops_f32 / PEAK_F32
    t_bytes = ((m * k + n * k) * in_bytes + m * n * out_bytes + extra_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def w8a8_bound(m, k, n):
    """K3: the int8 GEMM, plus per x element an abs, a max, a multiply and a
    rounding and per output element a fold per chunk and the epilogue's
    multiply-add in float32; bytes: x in bf16, w in int8, s_w and the bias
    in f32, the output in bf16."""
    from vap_tpu_torch.ops.int8_matmul import BLOCK_K, _pick

    chunks = k // _pick(k, BLOCK_K)
    # in_bytes 1 for w; x, in bf16, adds its second byte through extra_bytes
    return gemm_bound(m, k, n, 1, 2, PEAK_INT8, extra_ops_f32=4 * m * k + 2 * m * n * (chunks + 1),
                      extra_bytes=m * k + 8 * n)


def w8a8_inputs(gen, dev, m, k, n, bias=True):
    import torch

    from vap_tpu_torch.models.common import quantize_linear_int8

    x = (2 * torch.randn((m, k), generator=gen, device=dev)).to(torch.bfloat16)
    w = (0.02 * torch.randn((n, k), generator=gen, device=dev)).to(torch.bfloat16)
    w_i8, s_w = quantize_linear_int8(w)
    b = torch.randn((n,), generator=gen, device=dev) if bias else None
    return x, w, w_i8, s_w, b


def w8a8_parity(dev):
    """K3 against its plain version at unaligned shapes and at the main-path
    shapes of CogVideoX's and Wan's W8A8 steps, equal to the bit (and within
    the limit), a planted fault each time; times at the main-path shapes
    beside the plain version, the bound and two yardsticks the port never
    calls: torch._int_mm on the operands quantised beforehand, and the bf16
    F.linear that W8A8 replaces; the quantise pass and the GEMM apart
    (device time by kernel name). Returns the "w8a8" (CogVideoX) and
    "w8a8_wan" entries of the kernels line."""
    import torch
    import torch.nn.functional as F

    from vap_tpu_torch.ops import int8_matmul as ti8
    from vap_tpu_torch.scripts.attention_ab import device_ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    models = {"w8a8": {(W8A8_M, k, n): per for (k, n), per in W8A8_SHAPES.items()},
              "w8a8_wan": WAN_W8A8_SHAPES}
    timed = {shape: (name, per) for name, main in models.items() for shape, per in main.items()}
    worst = dict.fromkeys(models, 0.0)
    by_shape = {name: {} for name in models}
    for i, (m, k, n) in enumerate(W8A8_PARITY + list(timed)):
        x, w, w_i8, s_w, b = w8a8_inputs(gen, dev, m, k, n, bias=i % 2 == 0)
        out = ti8.int8_linear_chunk(x, w_i8, s_w, b)
        torch.cuda.synchronize()
        ref = ti8.int8_linear_chunk_plain(x, w_i8, s_w, b)
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        equal = (out == ref).float().mean().item()
        rolled = w_i8.unflatten(0, (-1, W8A8_TILE)).roll(1, dims=1).flatten(0, 1).contiguous()
        fault = (ti8.int8_linear_chunk(x, rolled, s_w, b).float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        log(f"  w8a8 [{m},{k}]x[{k},{n}] bias {b is not None}: max|err| {err:.3e} / max|ref| "
            f"{ref_max:.3e} = {err / ref_max:.3e} (tol {W8A8_REL_TOL:.3e}; planted fault "
            f"{fault / ref_max:.3e}), {equal:.6f} of outputs equal to the bit, finite {finite}")
        if not (finite and err <= W8A8_REL_TOL * ref_max and torch.equal(out, ref)):
            raise AssertionError("w8a8 disagrees with its plain version (it must equal it to "
                                 "the bit)")
        if fault <= W8A8_REL_TOL * ref_max:
            raise AssertionError("w8a8: the limit does not catch weight rows out of place")
        if (m, k, n) in timed:
            name, per_step = timed[m, k, n]
            worst[name] = max(worst[name], err)
            x_i8, _ = ti8.quantize_chunks(x, ti8._pick(k, ti8.BLOCK_K))
            ms = time_ms(lambda: ti8.int8_linear_chunk(x, w_i8, s_w, b), iters=10, warmup=2)
            plain_ms = time_ms(lambda: ti8.int8_linear_chunk_plain(x, w_i8, s_w, b), iters=2,
                               warmup=1)
            int_mm_ms = time_ms(lambda: torch._int_mm(x_i8, w_i8.T), iters=10, warmup=2)
            b16 = None if b is None else b.to(torch.bfloat16)  # the model's bias dtype
            bf16_ms = time_ms(lambda: F.linear(x, w, b16), iters=10, warmup=2)
            parts = device_ms(lambda: ti8.int8_linear_chunk(x, w_i8, s_w, b), 5,
                              ("w8a8_quantize", "w8a8_gemm"))
            bound_ms, bound_by = w8a8_bound(m, k, n)
            tops = 2 * m * n * k / (ms * 1e-3) / 1e12
            log(f"  w8a8 at [{m},{k}]x[{k},{n}] ({per_step} a step): kernel {ms:.3f} ms "
                f"({tops:.1f} TOP/s; quantise pass {parts['w8a8_quantize']:.3f} ms, GEMM "
                f"{parts['w8a8_gemm']:.3f} ms), plain {plain_ms:.3f} ms, torch._int_mm on "
                f"quantised operands {int_mm_ms:.3f} ms, bf16 F.linear {bf16_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by})")
            by_shape[name][f"{m}x{k}x{n}"] = {
                "ms": ms, "quantize_ms": parts["w8a8_quantize"], "gemm_ms": parts["w8a8_gemm"],
                "plain_ms": plain_ms, "int_mm_ms": int_mm_ms, "bf16_linear_ms": bf16_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "per_step": per_step}
        del x, w, w_i8, s_w, b, out, ref, rolled
        torch.cuda.empty_cache()
    entries = {}
    for name, main in models.items():
        rows = by_shape[name].values()
        step = {key: sum(r[key] * r["per_step"] for r in rows)
                for key in ("ms", "bound_ms", "bf16_linear_ms")}
        log(f"  {name} per computed CFG step ({sum(main.values())} launches): kernel "
            f"{step['ms']:.3f} ms, bound {step['bound_ms']:.3f} ms, the same products as bf16 "
            f"F.linear {step['bf16_linear_ms']:.3f} ms")
        first_shape = next(iter(main))
        first = by_shape[name]["x".join(map(str, first_shape))]
        entries[name] = {
            "max_abs_err": worst[name],
            **{key: first[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "quantize_ms")},
            "library_ms": None, "shape": list(first_shape),
            "yardsticks": {"int_mm_ms": first["int_mm_ms"],
                           "bf16_linear_ms": first["bf16_linear_ms"]},
            "per_step_ms": step["ms"], "per_step_bound_ms": step["bound_ms"],
            "by_shape": by_shape[name]}
    return entries


def probe_parity(dev):
    """K9 (x [M, K]) and K10 (x given as xt [K, M]) against their plain
    versions in int8 (bit for bit) and bf16, at small shapes and at the
    probe's shape, where they are timed beside one PyTorch call with the
    same function (torch._int_mm, torch.matmul) and the bound."""
    import torch

    from vap_tpu_torch.ops import gemm_probe as gp

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)

    def operands(dtype, m, k, n):
        if dtype == torch.int8:
            return [torch.randint(-128, 128, s, generator=gen, device=dev, dtype=dtype)
                    for s in ((m, k), (n, k))]
        return [torch.randn(s, generator=gen, device=dev).to(dtype) for s in ((m, k), (n, k))]

    def timed(name, kernel, trans, dtype, x, a, w):
        m, k, n = PROBE_SHAPE
        if dtype == torch.int8:
            # torch._int_mm takes a row-major A: K10's xt.T is copied first
            lib, how = ((lambda: torch._int_mm(a.T.contiguous(), w.T)),
                        "torch._int_mm on xt.T copied to row-major") if trans else (
                        (lambda: torch._int_mm(x, w.T)), "torch._int_mm")
            bound_ms, bound_by = gemm_bound(m, k, n, 1, 4, PEAK_INT8)
        else:
            lib, how = ((lambda: torch.matmul(a.T, w.T)), "torch.matmul on xt.T (a view)") if trans \
                else ((lambda: torch.matmul(x, w.T)), "torch.matmul")
            bound_ms, bound_by = gemm_bound(m, k, n, 2, 2, PEAK_BF16)
        ms = time_ms(lambda: kernel(a, w), iters=10, warmup=2)
        plain_ms = time_ms(lambda: gp.gemm_probe_plain(x, w), iters=2, warmup=1)
        library_ms = time_ms(lib, iters=10, warmup=2)
        log(f"  {name} {str(dtype)[6:]} at {PROBE_SHAPE}: kernel {ms:.3f} ms "
            f"({2 * m * n * k / (ms * 1e-3) / 1e12:.1f} TOP/s), plain {plain_ms:.3f} ms, {how} "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    results = {}
    for name, kernel, trans in (("gemm_probe", gp.gemm_probe, False),
                                ("gemm_probe_t", gp.gemm_probe_t, True)):
        per_type = {}
        for dtype in (torch.int8, torch.bfloat16):
            worst = 0.0
            for m, k, n in PROBE_PARITY + [PROBE_SHAPE]:
                if trans:
                    m -= m % 16
                x, w = operands(dtype, m, k, n)
                a = x.T.contiguous() if trans else x
                out = kernel(a, w)
                torch.cuda.synchronize()
                ref = gp.gemm_probe_plain(x, w)
                err = (out.float() - ref.float()).abs().max().item()
                ref_max = ref.float().abs().max().item()
                exact = dtype == torch.int8
                log(f"  {name} {str(dtype)[6:]} [{m},{k}]x[{k},{n}]: max|err| {err:.3e} / max|ref| "
                    f"{ref_max:.3e} ({'bit for bit' if exact else f'tol {GEMM_BF16_REL_TOL:.3e}'}), "
                    f"{(out == ref).float().mean().item():.6f} equal to the bit")
                if not (torch.equal(out, ref) if exact else err <= GEMM_BF16_REL_TOL * ref_max):
                    raise AssertionError(f"{name} ({dtype}) disagrees with its plain version")
                worst = max(worst, err)
                if (m, k, n) == PROBE_SHAPE:
                    per_type[dtype] = {"max_abs_err": worst,
                                       **timed(name, kernel, trans, dtype, x, a, w)}
                del x, w, a, out, ref
                torch.cuda.empty_cache()
        results[name] = {**per_type[torch.int8], "shape": list(PROBE_SHAPE),
                         "bf16": per_type[torch.bfloat16]}
    return results


def rate_probe_path():
    """The rate probe's own entry point, ``python -m
    vap_tpu_torch.scripts.linear_bench --impl diag``, driven once: K9 and K10
    in int8 and bf16 at its default shape, each a warm-up and 5 timed calls."""
    from vap_tpu_torch.scripts import linear_bench

    reset_counts()
    lines = linear_bench.main(["--impl", "diag"])
    launches = read_counts()
    per = (1 + linear_bench.REPS) * 2
    check_launches(launches, {"gemm_probe": per, "gemm_probe_t": per})
    if len(lines) != 4:
        raise AssertionError(f"linear_bench --impl diag printed {lines}")
    return launches


# ---------------------------------------------------------------------------
# phases 4-5: CogVideoX
# ---------------------------------------------------------------------------

def small_pipeline_check(dev):
    """A small CogVideoX pipeline on the card: kernels vs the plain dense
    attention, with where the largest difference sits."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import (CogVideoXVAPPipeline,
                                                           dynamic_cfg_schedule)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    t_cfg = CogVideoXMOTConfig.tiny(num_attention_heads=2, attention_head_dim=64, in_channels=8,
                                    out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
                                    use_learned_positional_embeddings=True)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    pipe = CogVideoXVAPPipeline(
        build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, bf16, gen),
        build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig.tiny(), dev, bf16, gen),
        build_random(T5EncoderModel, txt_cfg, dev, bf16, gen),
        FakeTokenizer(txt_cfg.vocab_size), dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(image=rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 64, 64, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=64, width=64, num_frames=9,
                num_inference_steps=STEPS, max_sequence_length=t_cfg.max_text_seq_length,
                output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, 8, 8)).astype(np.float32)))
    # The latents are quantised: the last DDIM step (v-prediction, a_t = 0)
    # gives x0 = sqrt(ab) x - sqrt(1 - ab) v with v = u + g (c - u), so one
    # bf16 ulp (2^-7 at |v| in [1, 2)) of the conditional prediction moves a
    # latent by 2^-7 * g * sqrt(1 - ab): the error quantum below.
    ts = pipe.scheduler.timesteps(STEPS).astype(np.float32)
    g_last = dynamic_cfg_schedule(ts, 6.0, STEPS)[-1]
    ab_last = pipe.scheduler.step_coefficients(STEPS)[2][-1]
    quantum = 2.0 ** -7 * float(g_last) * float(np.sqrt(1.0 - ab_last))
    with attention_provider("xla"):
        ref = pipe(**args)
    got = {}
    for provider, kernel, counter in (("flash", fa.flash_attention_forward, "launches_d64"),
                                      ("sage", fa.flash_attention_int8_forward, "launches")):
        before = getattr(kernel, counter)
        with attention_provider(provider):
            got[provider] = pipe(**args)
        launched = getattr(kernel, counter) - before
        diff = (got[provider] - ref).abs()
        err = diff.max().item()
        at = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
        log(f"  small pipeline, {provider} vs plain dense attention: final latents "
            f"max|err| {err:.6e} (tol {E2E_ATOL[provider]}) at [b, f, c, h, w] = {at}, "
            f"ref {ref[at].item():.6f}, got {got[provider][at].item():.6f}; "
            f"{err / quantum:.4f} quanta of {quantum:.6e}; {int((diff > 0).sum())} of "
            f"{diff.numel()} latents differ; max|ref| {ref.abs().max().item():.3f}, "
            f"{launched} launches")
        if launched != STEPS * t_cfg.num_layers:
            raise AssertionError(f"small pipeline under {provider}: {launched} kernel launches, "
                                 f"expected {STEPS * t_cfg.num_layers}")
        if not (torch.isfinite(got[provider]).all() and err <= E2E_ATOL[provider]):
            raise AssertionError(f"small pipeline under {provider} disagrees with plain attention")
    diff = (got["flash"] - got["sage"]).abs()
    log(f"  small pipeline, flash vs sage: max|diff| {diff.max().item():.6e} "
        f"({diff.max().item() / quantum:.4f} quanta), {int((diff == 0).sum())} of "
        f"{diff.numel()} latents equal to the bit")


def build_main_pipeline(dev):
    """CogVideoX-5B VAP at full width (42 blocks, MoT in 0-40, T5-XXL, the
    default VAE) with random bf16 weights from SEED, on the card."""
    import torch

    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    t_cfg = CogVideoXMOTConfig.cogvideox_5b_i2v_vap()
    txt_cfg = T5Config.t5_xxl()
    pipe = CogVideoXVAPPipeline(
        build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, torch.bfloat16, gen),
        build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig(), dev, torch.bfloat16, gen),
        build_random(T5EncoderModel, txt_cfg, dev, torch.bfloat16, gen),
        FakeTokenizer(txt_cfg.vocab_size), dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    counts = {name: n_params(m) for name, m in (("transformer", pipe.transformer),
                                                ("text_encoder", pipe.text_encoder),
                                                ("vae", pipe.vae))}
    log(f"main path weights: {counts} bf16, {time.perf_counter() - t0:.2f} s to build; "
        f"{t_cfg.num_layers} blocks, MoT in {min(t_cfg.block_idx_with_mot_ref)}-"
        f"{max(t_cfg.block_idx_with_mot_ref)}, {t_cfg.num_attention_heads}x"
        f"{t_cfg.attention_head_dim} heads")
    return pipe


def main_path_args(steps, height=HEIGHT, width=WIDTH, frames=NUM_FRAMES):
    """The main path's call: a synthetic 480x720 image, a 49-frame reference
    video, two prompts, DDIM with dynamic CFG at guidance 6 (5e's at its
    own size)."""
    import numpy as np

    yy, xx = np.meshgrid(np.linspace(-1, 1, height), np.linspace(-1, 1, width), indexing="ij")
    image = np.stack([xx, yy, xx * yy], -1).astype(np.float32)
    t = np.linspace(0, 1, frames)[:, None, None, None]
    ref_video = np.clip(np.sin(3 * image[None] + 4 * t), -1, 1).astype(np.float32)
    return dict(image=image, prompt="a red fox runs through fresh snow", ref_videos=[ref_video],
                prompt_mot_ref=["the camera orbits the subject"], height=height, width=width,
                num_frames=frames, num_inference_steps=steps, guidance_scale=6.0,
                use_dynamic_cfg=True, seed=SEED)


def reset_counts():
    from vap_tpu_torch.models import common
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops import gemm_probe as gp
    from vap_tpu_torch.ops import int8_matmul as ti8

    fa.flash_attention_forward.launches = 0
    fa.flash_attention_forward.launches_d64 = 0
    fa.flash_attention_forward.launches_d128 = 0
    fa.flash_attention_forward.launches_varlen = 0
    fa.flash_attention_forward.launches_d64_varlen = 0
    fa.flash_attention_forward.launches_d128_varlen = 0
    fa.flash_attention_segmented_forward.launches = 0
    fa.flash_attention_segmented_forward.launches_d64 = 0
    fa.flash_attention_segmented_forward.launches_d128 = 0
    fa.flash_attention_int8_forward.launches = 0
    fa.flash_attention_int8_forward.launches_varlen = 0
    fa.flash_attention_int8_forward.launches_mma = 0
    fa.flash_attention_int8_forward.launches_mma_varlen = 0
    fa.sage_prepass.launches = 0
    fa.flash_attention_backward.launches = 0
    fa.flash_attention_backward.launches_d64 = 0
    fa.flash_attention_backward.launches_d128 = 0
    fa.flash_attention_backward.launches_varlen = 0
    fa.flash_attention_backward.launches_d64_varlen = 0
    fa.flash_attention_backward.launches_d128_varlen = 0
    fa.flash_attention_backward.launches_seg = 0
    fa.flash_attention_backward.launches_d64_seg = 0
    fa.flash_attention_backward.launches_d128_seg = 0
    ti8.int8_linear_chunk.launches = 0
    common.int8_linear_row.calls = 0
    gp.gemm_probe.launches = 0
    gp.gemm_probe_t.launches = 0


def read_counts():
    """Each kernel's launches (K7 on the ``*_varlen`` counters of the kernel
    it runs in, K8 on ``flash_fwd_seg*`` and ``flash_bwd_seg*``; K1, K5 and
    K8 at D=64, the wgmma kernels, on ``flash_fwd``, ``flash_bwd`` and
    ``*_seg``, their ``mma.sync`` forms at the other head dims below 128 on
    ``*_mma``, which no path may reach; K2 at D=64 and 128, the wgmma kernels, on
    ``sage_fwd``, its ``mma.sync`` form at 32 and 96 on ``sage_fwd_mma``;
    K2's pre-pass on ``sage_quant``), and the calls of the W8A8 row form (no
    kernel of its own: XLA's product in the JAX package, torch._int_mm
    here)."""
    from vap_tpu_torch.models import common
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops import gemm_probe as gp
    from vap_tpu_torch.ops import int8_matmul as ti8

    return {"flash_fwd": fa.flash_attention_forward.launches_d64,
            "flash_fwd_mma": fa.flash_attention_forward.launches,
            "flash_fwd_d128": fa.flash_attention_forward.launches_d128,
            "flash_fwd_varlen": fa.flash_attention_forward.launches_d64_varlen,
            "flash_fwd_mma_varlen": fa.flash_attention_forward.launches_varlen,
            "flash_fwd_d128_varlen": fa.flash_attention_forward.launches_d128_varlen,
            "flash_fwd_seg": fa.flash_attention_segmented_forward.launches_d64,
            "flash_fwd_seg_mma": fa.flash_attention_segmented_forward.launches,
            "flash_fwd_seg_d128": fa.flash_attention_segmented_forward.launches_d128,
            "sage_fwd": fa.flash_attention_int8_forward.launches,
            "sage_fwd_varlen": fa.flash_attention_int8_forward.launches_varlen,
            "sage_fwd_mma": fa.flash_attention_int8_forward.launches_mma,
            "sage_fwd_mma_varlen": fa.flash_attention_int8_forward.launches_mma_varlen,
            "sage_quant": fa.sage_prepass.launches,
            "flash_bwd": fa.flash_attention_backward.launches_d64,
            "flash_bwd_mma": fa.flash_attention_backward.launches,
            "flash_bwd_d128": fa.flash_attention_backward.launches_d128,
            "flash_bwd_varlen": fa.flash_attention_backward.launches_d64_varlen,
            "flash_bwd_mma_varlen": fa.flash_attention_backward.launches_varlen,
            "flash_bwd_d128_varlen": fa.flash_attention_backward.launches_d128_varlen,
            "flash_bwd_seg": fa.flash_attention_backward.launches_d64_seg,
            "flash_bwd_seg_mma": fa.flash_attention_backward.launches_seg,
            "flash_bwd_seg_d128": fa.flash_attention_backward.launches_d128_seg,
            "w8a8": ti8.int8_linear_chunk.launches,
            "w8a8_row_calls": common.int8_linear_row.calls,
            "gemm_probe": gp.gemm_probe.launches,
            "gemm_probe_t": gp.gemm_probe_t.launches}


def check_launches(launches, want):
    """Exactly ``want`` launches of the named counters and none of the rest;
    K2's pre-pass once with every K2 launch."""
    want = dict(want, sage_quant=sum(n for name, n in want.items() if name.startswith("sage_fwd")))
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")


def main_path(pipe, provider, steps, dev):
    import numpy as np
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    args = main_path_args(steps)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with attention_provider(provider):
        video = pipe(**args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    cfg = pipe.transformer.config
    expected = (1, decoded_frames((NUM_FRAMES - 1) // 4 + 1), HEIGHT, WIDTH, 3)
    st = pipe.stage_seconds
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, "
        f"denoise steps {[round(s, 3) for s in st['denoise_steps']]}, "
        f"vae_decode {st['vae_decode']:.3f}; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"main path output {video.shape} (expected {expected}) or not finite")
    kernel = "flash_fwd" if provider == "flash" else "sage_fwd"
    # one joint (MoT) or self attention per block per step
    check_launches(launches, {kernel: steps * cfg.num_layers})
    return launches[kernel]


def counted_call(pipe, args, provider, dev):
    """``pipe(**args)`` under ``provider`` with every count at 0 before, its
    scheduler swapped for a subclass that reads the counts at each step
    (after that step's forward, if any). Returns the output, the call's
    seconds, the peak device memory, the launches and each step's share."""
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    at_step = []
    scheduler = pipe.scheduler

    class Counting(type(scheduler)):
        def step(self, *a, **kw):
            at_step.append(read_counts())
            return super().step(*a, **kw)

    pipe.scheduler = Counting(**{f.name: getattr(scheduler, f.name)
                                 for f in dataclasses.fields(scheduler)})
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    try:
        with attention_provider(provider):
            out = pipe(**args)
    finally:
        pipe.scheduler = scheduler
    wall = time.perf_counter() - t0
    launches = read_counts()
    deltas = [{k: v - (at_step[i - 1][k] if i else 0) for k, v in c.items()}
              for i, c in enumerate(at_step)]
    return out, wall, torch.cuda.max_memory_allocated(dev), launches, deltas


def check_reuse_steps(step_seconds, deltas):
    """The step cache's reuse steps (those not in BENCH_COMPUTED) launch no
    kernel and each costs under REUSE_STEP_SHARE of the fastest computed
    step."""
    reuse = [i for i in range(BENCH_STEPS) if i not in BENCH_COMPUTED]
    if any(v for i in reuse for v in deltas[i].values()):
        raise AssertionError(f"a reuse step launched kernels: {deltas}")
    computed_min = min(step_seconds[i] for i in BENCH_COMPUTED)
    if any(step_seconds[i] >= REUSE_STEP_SHARE * computed_min for i in reuse):
        raise AssertionError(f"a reuse step took {[step_seconds[i] for i in reuse]} s, not "
                             f"under {REUSE_STEP_SHARE} of a computed step ({computed_min:.3f} s)")
    log(f"  reuse step {reuse}: {[round(step_seconds[i], 4) for i in reuse]} s, "
        f"{max(step_seconds[i] for i in reuse) / computed_min:.5f} of the fastest computed step")


def bench_config_path(pipe, dev):
    """The bench configuration on the full-width pipeline: the projections
    quantised in place to W8A8 in the chunk form, then
    CogVideoXVAPPipeline.__call__ under sage, DDIM with dynamic CFG, the
    step cache "uniform:2:1:1" over 4 steps; then the row form, 1 step.
    Returns K3's launches in the cached run."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.common import quantize_transformer_linears, set_int8_act_scale
    from vap_tpu_torch.ops.attention import attention_provider

    cfg = pipe.transformer.config
    t0 = time.perf_counter()
    names = quantize_transformer_linears(pipe.transformer, act_scale="chunk")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  {len(names)} projections quantised in place in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated after")
    per_step = sum(W8A8_SHAPES.values())
    if len(names) != per_step:
        raise AssertionError(f"{len(names)} projections quantised, expected {per_step}")

    args = dict(main_path_args(BENCH_STEPS), step_cache=BENCH_CACHE)
    video, wall, peak, launches, deltas = counted_call(pipe, args, "sage", dev)
    st = pipe.stage_seconds
    steps = st["denoise_steps"]
    per_step_launches = [{k: v for k, v in d.items() if v} for d in deltas]
    expected = (1, decoded_frames((NUM_FRAMES - 1) // 4 + 1), HEIGHT, WIDTH, 3)
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, "
        f"denoise steps {[round(x, 3) for x in steps]} (computed {st['computed_steps']}), "
        f"vae_decode {st['vae_decode']:.3f}; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}; per step "
        f"{per_step_launches}")
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"bench configuration output {video.shape} (expected {expected}) "
                             f"or not finite")
    if st["computed_steps"] != BENCH_COMPUTED:
        raise AssertionError(f"computed steps {st['computed_steps']}, expected {BENCH_COMPUTED}")
    n = len(BENCH_COMPUTED)
    check_launches(launches, {"sage_fwd": n * cfg.num_layers, "w8a8": n * per_step})
    check_reuse_steps(steps, deltas)

    # the row form on the same int8 weights: no K3 launch, 498 row-form calls
    set_int8_act_scale(pipe.transformer, "row")
    reset_counts()
    with attention_provider("sage"):
        latents = pipe(**dict(main_path_args(1), output_type="latent"))
    row = read_counts()
    log(f"  row form, 1 step: {pipe.stage_seconds['denoise_steps'][0]:.3f} s; launches {row}")
    check_launches(row, {"sage_fwd": cfg.num_layers, "w8a8_row_calls": per_step})
    if not torch.isfinite(latents).all():
        raise AssertionError("row form: latents not finite")
    return launches["w8a8"]


def small_w8a8_check(dev):
    """A small CogVideoX pipeline on the card in the W8A8 chunk form, under
    DPM and the adaptive step cache: K3 against its plain version through
    the pipeline (the plain version swapped in for the reference run only),
    with the same computed steps."""
    import numpy as np
    import torch

    from vap_tpu_torch.models import common
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops import int8_matmul as ti8
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.ops.schedulers import CogVideoXDPMScheduler
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    t_cfg = CogVideoXMOTConfig.tiny(num_attention_heads=2, attention_head_dim=64, in_channels=8,
                                    out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
                                    use_learned_positional_embeddings=True)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    transformer = build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, bf16, gen)
    n_proj = len(common.quantize_transformer_linears(transformer, act_scale="chunk"))
    inputs = []

    class Recording(CogVideoXDPMScheduler):
        def step(self, model_output, sample, *rest):
            inputs.append(sample.clone())
            return super().step(model_output, sample, *rest)

    pipe = CogVideoXVAPPipeline(
        transformer, build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig.tiny(), dev, bf16, gen),
        build_random(T5EncoderModel, txt_cfg, dev, bf16, gen), FakeTokenizer(txt_cfg.vocab_size),
        scheduler=Recording(), dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(image=rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 64, 64, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=64, width=64, num_frames=9,
                num_inference_steps=BENCH_STEPS, max_sequence_length=t_cfg.max_text_seq_length,
                output_type="latent", seed=SEED)

    def relative_l1(i):
        return ((inputs[i] - inputs[i - 1]).abs().mean() / (inputs[i - 1].abs().mean() + 1e-8)).item()

    # an uncached run gives the relative change of the inputs at steps 1 and
    # 2; a threshold between d1 and d1 + d2 skips step 1 and computes step 2
    with attention_provider("flash"):
        pipe(**args)
    d1, d2 = relative_l1(1), relative_l1(2)
    spec = f"adaptive:{d1 + d2 / 2:.6g}:1:1"
    got = {}
    for version, fn in (("plain", ti8.int8_linear_chunk_plain), ("kernel", ti8.int8_linear_chunk)):
        common.int8_linear_chunk = fn  # the reference run swaps in the plain version
        reset_counts()
        try:
            with attention_provider("flash"):
                got[version] = (pipe(**args, step_cache=spec),
                                list(pipe.stage_seconds["computed_steps"]), read_counts())
        finally:
            common.int8_linear_chunk = ti8.int8_linear_chunk
    (ref, ref_steps, _), (out, steps, launches) = got["plain"], got["kernel"]
    err = (out - ref).abs().max().item()
    log(f"  small W8A8 pipeline, DPM, {spec} (d1 {d1:.4f}, d2 {d2:.4f}): computed steps {steps} "
        f"(plain {ref_steps}); K3 vs its plain version: final latents max|err| {err:.6e} (tol "
        f"{W8A8_E2E_ATOL}), {int((out != ref).sum())} of {out.numel()} differ, max|ref| "
        f"{ref.abs().max().item():.3f}; launches {launches}")
    if steps != ref_steps or steps != [0, 2, BENCH_STEPS - 1]:
        raise AssertionError(f"adaptive cache computed {steps} (plain {ref_steps}), expected "
                             f"[0, 2, {BENCH_STEPS - 1}]")
    check_launches(launches, {"flash_fwd": len(steps) * t_cfg.num_layers,
                              "w8a8": len(steps) * n_proj})
    if not (torch.isfinite(out).all() and err <= W8A8_E2E_ATOL):
        raise AssertionError("small W8A8 pipeline: K3 disagrees with its plain version")


def small_modes_check(dev):
    """The CogVideoX pipeline's other sampling modes on a small pipeline on
    the card, each held against the same call under plain dense attention
    (the limit of ``small_pipeline_check``), with K1's launches: the
    single-branch ablation (the trunk over target ‖ reference, six latent
    frames where the learned table holds three), baseline_single_condition,
    plain image-to-video, text-to-video on a T2V-shaped model, the
    discrete_long_reference RoPE, the MoT options (reference_independent,
    the reference-slot embeddings, the two block ablations, each on a
    transformer of its own) and CogVideoX 1.5 (patch_size_t 2, the ofs
    embedding, a padded latent frame); plain equal to
    baseline_single_condition, model offload equal to resident and the
    tiled and sliced decode of a single tile equal to the default decode,
    each to the bit; the tiled decode and the tiled encode of a 2 x 2 tile
    grid in float32 on the card against the CPU."""
    import copy

    import numpy as np
    import torch

    from vap_tpu_torch.models.cogvideox import vae as cvae
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    tiny = dict(num_attention_heads=2, attention_head_dim=64, num_layers=3,
                use_learned_positional_embeddings=True)
    t_cfg = CogVideoXMOTConfig.tiny(in_channels=8, out_channels=4, block_idx_with_mot_ref=(0, 1),
                                    **tiny)
    t2v_cfg = CogVideoXMOTConfig.tiny(in_channels=4, out_channels=4, block_idx_with_mot_ref=(),
                                      **tiny)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    vae = build_random(cvae.AutoencoderKLCogVideoX, cvae.CogVideoXVAEConfig.tiny(), dev, bf16, gen)
    text = build_random(T5EncoderModel, txt_cfg, dev, bf16, gen)
    transformer = build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, bf16, gen)
    t2v = build_random(CogVideoXTransformer3DMOTModel, t2v_cfg, dev, bf16, gen)

    def pipeline(model, **kw):
        return CogVideoXVAPPipeline(model, vae, text, FakeTokenizer(txt_cfg.vocab_size),
                                    dtype=bf16, device=dev, **kw)

    pipe = pipeline(transformer)
    rng = np.random.default_rng(SEED)
    base = dict(image=rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 64, 64, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=64, width=64, num_frames=9,
                num_inference_steps=STEPS, max_sequence_length=t_cfg.max_text_seq_length,
                output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, 8, 8)).astype(np.float32)))
    plain = dict(ref_videos=None, prompt_mot_ref=None)
    layers = t_cfg.num_layers

    def option(**kw):
        """The pipeline on a small transformer with the MoT option ``kw``."""
        cfg = dataclasses.replace(t_cfg, **kw)
        return pipeline(build_random(CogVideoXTransformer3DMOTModel, cfg, dev, bf16, gen))

    # CogVideoX 1.5: 9 frames give 3 latent frames, padded to 4
    cog15 = option(patch_size_t=2, ofs_embed_dim=t_cfg.time_embed_dim,
                   use_learned_positional_embeddings=False)
    latents15 = torch.from_numpy(rng.standard_normal((1, 4, 4, 8, 8)).astype(np.float32))
    # mode: (pipeline, call, K1 launches a step); an ablation block runs the
    # reference's own attention and then the target's
    modes = {"ablation_single_branch": (pipe, dict(ablation_single_branch=True), layers),
             "baseline_single_condition": (pipe, dict(baseline_single_condition=True), layers),
             "plain i2v": (pipe, plain, layers),
             "t2v": (pipeline(t2v), dict(plain, image=None), layers),
             "discrete_long_reference": (pipe, dict(ref_type="discrete_long_reference"), layers),
             "reference_independent": (option(reference_train_mode="reference_independent"), {},
                                       layers),
             "ref_embeddings": (option(num_ref_embeddings=2), {}, layers),
             "ablation_single_encoder": (option(ablation_single_encoder=True), {}, layers + 2),
             "ablation_residual_addition": (option(ablation_residual_addition=True), {},
                                            layers + 2),
             "cogvideox 1.5": (cog15, dict(latents=latents15), layers)}
    got = {}
    for mode, (p, extra, per_step) in modes.items():
        args = dict(base, **extra)
        with attention_provider("xla"):
            ref = torch.as_tensor(p(**args))
        reset_counts()
        with attention_provider("flash"):
            out = torch.as_tensor(p(**args))
        launches = read_counts()
        err = (out.float() - ref.float()).abs().max().item()
        got[mode] = out
        log(f"  {mode}: {tuple(out.shape)}, flash vs plain dense attention max|err| {err:.4e} "
            f"(tol {E2E_ATOL['flash']}), max|ref| {ref.abs().max().item():.3f}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        check_launches(launches, {"flash_fwd": STEPS * per_step})
        if not (torch.isfinite(out).all() and err <= E2E_ATOL["flash"]):
            raise AssertionError(f"small pipeline, {mode}: flash disagrees with plain attention")
    if not torch.equal(got["plain i2v"], got["baseline_single_condition"]):
        raise AssertionError("plain sampling differs from baseline_single_condition")
    offloaded = CogVideoXVAPPipeline(copy.deepcopy(transformer).cpu(), copy.deepcopy(vae).cpu(),
                                     copy.deepcopy(text).cpu(), FakeTokenizer(txt_cfg.vocab_size),
                                     dtype=bf16, device=dev, enable_model_offload=True)
    tiled = pipeline(transformer, enable_vae_tiling=True, enable_vae_slicing=True)
    with attention_provider("flash"):
        resident = pipe(**base)
        moved = offloaded(**base)
        video = pipe(**dict(base, output_type="np"))
        tiled_video = tiled(**dict(base, output_type="np"))
    log(f"  plain == baseline_single_condition to the bit; offload vs resident: equal to the bit "
        f"{torch.equal(moved, resident)}, staged {sorted(offloaded.stage_seconds['staging'])}; "
        f"tiled + sliced decode of one tile vs the default decode: {video.shape}, equal to the "
        f"bit {np.array_equal(tiled_video, video)}")
    if not torch.equal(moved, resident):
        raise AssertionError("model offload changed the latents")
    if not (np.isfinite(video).all() and np.array_equal(tiled_video, video)):
        raise AssertionError("the tiled and sliced decode of one tile differs from the default")

    vae32 = build_random(cvae.AutoencoderKLCogVideoX, cvae.CogVideoXVAEConfig.tiny(), "cpu",
                         torch.float32, torch.Generator().manual_seed(SEED + 6))
    z = torch.from_numpy(rng.standard_normal((1, 2, 32, 40, 4)).astype(np.float32))
    with torch.no_grad():
        ref = cvae.vae_decode_tiled(vae32, z)
        out = cvae.vae_decode_tiled(vae32.to(dev), z.to(dev)).cpu()
    err = (out - ref).abs().max().item()
    log(f"  tiled decode, 2 x 2 tiles, card vs CPU (float32): {tuple(out.shape)}, max|err| "
        f"{err:.3e} (tol {VAE_CARD_ATOL}), max|ref| {ref.abs().max().item():.3f}")
    if not err <= VAE_CARD_ATOL:
        raise AssertionError("the tiled decode on the card disagrees with the CPU")
    # the tiled encode, 2 x 2 tiles of 240 x 360 every 200 x 288
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 256, 320, 3)).astype(np.float32))
    with torch.no_grad():
        ref = cvae.vae_encode_tiled(vae32.cpu(), x)
        out = cvae.vae_encode_tiled(vae32.to(dev), x.to(dev)).cpu()
    err = (out - ref).abs().max().item()
    log(f"  tiled encode, 2 x 2 tiles, card vs CPU (float32): {tuple(out.shape)}, max|err| "
        f"{err:.3e} (tol {VAE_CARD_ATOL}), max|ref| {ref.abs().max().item():.3f}")
    if not err <= VAE_CARD_ATOL:
        raise AssertionError("the tiled encode on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 5c: checkpoints in and out
# ---------------------------------------------------------------------------

CKPT_SHARD_BYTES = 5 * 10**9  # the transformer and T5 in shards of up to 5 GB, with an index
CKPT_COMPONENTS = (("transformer", "CogVideoXTransformer3DMOTModel", "diffusion_pytorch_model"),
                   ("vae", "AutoencoderKLCogVideoX", "diffusion_pytorch_model"),
                   ("text_encoder", "T5EncoderModel", "model"))


SMOKE_START = [time.perf_counter()]  # main() sets it when the smoke begins


def rss_gib():
    """This process's resident host memory now and its peak so far."""
    import resource

    with open("/proc/self/status") as fh:
        now = next(int(line.split()[1]) for line in fh if line.startswith("VmRSS:"))
    return now / 2**20, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def charged_gib():
    """The memory the machine's limit counts for this sandbox (its cgroup's
    usage), which under gVisor stays charged for memory the process freed."""
    for path in ("/sys/fs/cgroup/memory.current", "/sys/fs/cgroup/memory/memory.usage_in_bytes"):
        try:
            with open(path) as fh:
                return int(fh.read()) / 2**30
        except OSError:
            pass
    return float("nan")


class _MallInfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks", "uordblks",
        "fordblks", "keepcost")]


def host_memory(phase):
    """Logs host memory at a phase boundary, after the freed Python objects
    are collected: the seconds since the smoke began, RSS and its peak so
    far, the sandbox's charged memory (what the machine's limit reads), and
    glibc's heap: the free bytes it keeps for reuse (mallinfo2 fordblks)
    and the bytes of live mmapped blocks (hblkhd)."""
    import gc

    gc.collect()
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    heap = "n/a"
    if hasattr(libc, "mallinfo2"):
        libc.mallinfo2.restype = _MallInfo2
        info = libc.mallinfo2()
        heap = (f"{info.fordblks / 2**30:.2f} GiB free in the heap, {info.hblkhd / 2**30:.2f} "
                f"GiB mmapped")
    now, peak = rss_gib()
    log(f"[host memory, {phase}, {time.perf_counter() - SMOKE_START[0]:.1f} s] RSS {now:.2f} "
        f"GiB, peak {peak:.2f} GiB; charged {charged_gib():.2f} GiB (MemTotal "
        f"{mem_total_gib():.2f} GiB); glibc: {heap}")


def state_bytes(module):
    return sum(t.numel() * t.element_size() for t in module.state_dict().values())


def write_checkpoint(pipe, root, components=CKPT_COMPONENTS):
    """The pipeline's ``components`` as a diffusers-layout directory: per
    component a config.json (every field of its configuration) and its
    weights, from the card (or host memory) one tensor at a time. Returns
    the bytes written."""
    from vap_tpu_torch.utils.safetensors import save_sharded

    written = 0
    for name, class_name, file in components:
        module = getattr(pipe, name)
        d = os.path.join(root, name)
        os.makedirs(d)
        config = {"_class_name": class_name, **json.loads(json.dumps(
            dataclasses.asdict(module.config)))}
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump(config, fh)
        written += save_sharded(module.state_dict(), d, name=file,
                                max_shard_bytes=CKPT_SHARD_BYTES)
    return written


def resident_latents(pipe, provider, steps):
    """Latents of the main path's call (``steps`` steps under ``provider``)."""
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    with attention_provider(provider):
        latents = pipe(**dict(main_path_args(steps), output_type="latent"))
    torch.cuda.synchronize()
    return latents.cpu()


def timed_write(pipe, components):
    """``components`` of ``pipe`` written as a checkpoint directory under
    build/, timed. Fails where the disk is short. Returns (the directory,
    the bytes)."""
    import tempfile

    import torch

    need = sum(state_bytes(getattr(pipe, name)) for name, _, _ in components)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(HERE, "build"))
    free = shutil.disk_usage(root).free
    log(f"  checkpoint of {need / 1e9:.3f} GB to write; {free / 1e9:.1f} GB free under build/")
    if free < need + 2**30:
        raise RuntimeError(f"the disk is short: {free} bytes free for a {need}-byte checkpoint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = write_checkpoint(pipe, root, components)
    seconds = time.perf_counter() - t0
    now, peak = rss_gib()
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    log(f"  written {written} bytes ({written / 1e9:.3f} GB) in {seconds:.2f} s, "
        f"{written / seconds / 1e9:.2f} GB/s (into the page cache; no fsync), files {files}; "
        f"host RSS {now:.2f} GiB, peak {peak:.2f} GiB; {power_line()}")
    return root, written


def checkpoint_write_path(pipe, dev):
    """Before the bench configuration quantises the main pipeline: its
    latents under flash (STEPS steps), then its weights written as a
    checkpoint directory under build/. Returns (the directory, the bytes,
    the latents)."""
    want_flash = resident_latents(pipe, "flash", STEPS)
    return (*timed_write(pipe, CKPT_COMPONENTS), want_flash)


def timed_build(build, written, dev, **kwargs):
    """``build(**kwargs)`` (a ``build_pipeline``) timed, with the host's and
    the card's memory around it. Returns the pipeline."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rss0 = rss_gib()[0]
    t0 = time.perf_counter()
    pipe = build(**kwargs, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    now, peak = rss_gib()
    where = "into host memory" if pipe.enable_model_offload else "onto the card"
    log(f"  loaded {written} bytes in {seconds:.2f} s, {written / seconds / 1e9:.2f} GB/s (the "
        f"files read warm, from the page cache), {where} one tensor at a time; host RSS "
        f"{rss0:.2f} -> {now:.2f} GiB, peak {peak:.2f} GiB; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {power_line()}")
    return pipe


def bench_latents(pipe):
    """Latents of one step of the bench configuration (sage, W8A8 in the
    chunk form) on the quantised pipeline."""
    from vap_tpu_torch.models.common import set_int8_act_scale

    set_int8_act_scale(pipe.transformer, "chunk")
    return resident_latents(pipe, "sage", 1)


def checkpoint_load_path(root, written, want_flash, want_bench, dev):
    """The pipeline built again from the directory (build_pipeline, onto the
    card one tensor at a time), then the main path's call under flash
    (STEPS steps, K1) and, once quantised, one step of the bench
    configuration (K2, K3): each with every count at 0 before it, its
    launches checked, its latents bit-equal to the resident pipeline's."""
    import torch

    from vap_tpu_torch.infer.cog_vap import build_pipeline
    from vap_tpu_torch.models.common import quantize_transformer_linears
    from vap_tpu_torch.models.text_encoders.t5 import T5Config

    pipe = timed_build(build_pipeline, written, dev, model_path=root, dtype_str="bfloat16",
                       tokenizer=FakeTokenizer(T5Config.t5_xxl().vocab_size))
    cfg = pipe.transformer.config
    for provider, steps, want, expected in (
            ("flash", STEPS, want_flash, {"flash_fwd": STEPS * cfg.num_layers}),
            ("sage", 1, want_bench, {"sage_fwd": cfg.num_layers,
                                     "w8a8": sum(W8A8_SHAPES.values())})):
        if provider == "sage":
            names = quantize_transformer_linears(pipe.transformer, act_scale="chunk")
            log(f"  {len(names)} projections quantised in place")
        reset_counts()
        got = resident_latents(pipe, provider, steps)
        launches = read_counts()
        check_launches(launches, expected)
        same = torch.equal(got, want)
        log(f"  {provider}, {steps} step(s): latents {tuple(got.shape)} bit-equal to the resident "
            f"pipeline's: {same}; launches {({k: v for k, v in launches.items() if v})}")
        if not same:
            raise AssertionError(f"checkpoint path, {provider}: latents differ from the resident "
                                 f"pipeline's by up to {(got - want).abs().max().item()}")
    del pipe
    torch.cuda.empty_cache()


def tiled_encode_path(vae, dev):
    """The tiled VAE encode (vae_encode_tiled, 240 x 360 tiles: 3 x 3 at
    480 x 720) of the main path's 49-frame reference video on the main
    pipeline's VAE, beside the plain encode: the seconds, the peak card
    memory, finite moments of the plain encode's shape."""
    import torch

    from vap_tpu_torch.models.cogvideox.vae import vae_encode, vae_encode_tiled

    video = torch.from_numpy(main_path_args(1)["ref_videos"][0])[None].to(dev, torch.bfloat16)
    out = {}
    with torch.inference_mode():
        for name, fn in (("vae_encode", vae_encode), ("vae_encode_tiled", vae_encode_tiled)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out[name] = fn(vae, video)
            torch.cuda.synchronize()
            out[name + "_s"] = time.perf_counter() - t0
            out[name + "_peak"] = torch.cuda.max_memory_allocated(dev) / 2**30
    plain, tiled = out["vae_encode"], out["vae_encode_tiled"]
    diff = (tiled.float() - plain.float()).abs().max().item()
    log(f"  tiled encode of {tuple(video.shape)}: moments {tuple(tiled.shape)} in "
        f"{out['vae_encode_tiled_s']:.3f} s, peak {out['vae_encode_tiled_peak']:.2f} GiB; "
        f"vae_encode {out['vae_encode_s']:.3f} s, peak {out['vae_encode_peak']:.2f} GiB; "
        f"max|tiled - plain| {diff:.4f} (the tiles' edges and blends), max|plain| "
        f"{plain.abs().max().item():.3f}; {power_line()}")
    if tiled.shape != plain.shape or not torch.isfinite(tiled).all():
        raise AssertionError(f"tiled encode {tuple(tiled.shape)} against {tuple(plain.shape)}, "
                             f"or not finite")


# ---------------------------------------------------------------------------
# phases 5d and 6d: streamed block offload; phase 5e: CogVideoX 1.5
# ---------------------------------------------------------------------------

COG_STREAM_CHUNK = 6  # 5d's blocks a chunk: 8 chunks of the 42 (MoT 0-40, a plain 41)
WAN_STREAM_CHUNK = 4  # 6d's, the figure of vap_tpu/pipelines/streamed.py:17-18


def pin_blocks(pipe):
    """``pipe``'s transformer blocks page-locked in place
    (``pinned_blocks``), with host RSS around it. Returns the store."""
    rss0, charged0 = rss_gib()[0], charged_gib()
    store = pipe.pinned_blocks()
    now, peak = rss_gib()
    log(f"  {len(store.chunks)} chunks of up to {pipe.offload_blocks_chunk} blocks: "
        f"{store.nbytes} bytes ({store.nbytes / 2**30:.2f} GiB) page-locked in place "
        f"(cudaHostRegister over {len(store.spans)} page ranges) in {store.pin_seconds:.2f} s, "
        f"after {store.edge_bytes} bytes of their page edges were copied in "
        f"{store.edge_seconds:.2f} s; "
        f"two card slots of {store.slot_bytes} bytes; host RSS {rss0:.2f} -> {now:.2f} GiB, "
        f"peak {peak:.2f} GiB; the sandbox's charged memory {charged0:.2f} -> "
        f"{charged_gib():.2f} GiB")
    if not store.pinned or not store.spans:
        raise AssertionError("the blocks are not page-locked")
    return store


def streamed_run(pipe, args, want, expected, dev):
    """``pipe(**args)`` under flash with its blocks streamed, every count at
    0 before it: ``expected`` launches, latents bit-equal to ``want``. Logs
    and returns the figures: peak card memory, seconds per step, bytes
    copied host -> card per step and their GB/s, the share of the copies
    that overlapped compute (the last step's events)."""
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with attention_provider("flash"):
        got = pipe(**dict(args, output_type="latent"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    runner = pipe._streamed
    stats = runner.copy_stats()
    steps = pipe.stage_seconds["denoise_steps"]
    per_step = runner.bytes_copied // runner.num_forwards
    fig = {"peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "step_s": steps,
           "bytes_per_step": per_step, "copy_gb_s": per_step / stats["copy_ms"] * 1e-6,
           "overlap_share": stats["overlap_ms"] / stats["copy_ms"], **stats}
    got = got.cpu()
    same = torch.equal(got, want)
    log(f"  streamed, {len(steps)} step(s): latents {tuple(got.shape)} bit-equal to the resident "
        f"run's: {same}; launches { {k: v for k, v in launches.items() if v} }; max_staged "
        f"{runner.max_staged}, {runner.num_forwards} forwards")
    log(f"  peak card memory {fig['peak_gib']:.2f} GiB; seconds per step "
        f"{[round(x, 3) for x in steps]} (call {wall:.3f}); host -> card {per_step} bytes "
        f"({per_step / 1e9:.3f} GB) a step at {fig['copy_gb_s']:.2f} GB/s over "
        f"{stats['copy_ms']:.1f} ms of copies, {fig['overlap_share']:.4f} of them during compute "
        f"(blocks {stats['compute_ms']:.1f} ms of the last step's {stats['blocks_ms']:.1f}); "
        f"{power_line()}")
    check_launches(launches, expected)
    if not same:
        raise AssertionError(f"streamed latents differ from the resident run's by up to "
                             f"{(got - want).abs().max().item()}")
    return fig


def streamed_cog_path(root, written, want_flash, dev):
    """Phase 5d: the pipeline built a third time from the checkpoint
    directory with build_pipeline(offload_blocks_chunk=COG_STREAM_CHUNK),
    every weight in host memory, then the main path's flash call (STEPS
    steps) with the blocks streamed: K1's launches, latents bit-equal to the
    resident pipeline's. Returns the figures."""
    import torch

    from vap_tpu_torch.infer.cog_vap import build_pipeline
    from vap_tpu_torch.models.text_encoders.t5 import T5Config

    pipe = timed_build(build_pipeline, written, dev, model_path=root, dtype_str="bfloat16",
                       offload_blocks_chunk=COG_STREAM_CHUNK,
                       tokenizer=FakeTokenizer(T5Config.t5_xxl().vocab_size))
    if not pipe.enable_model_offload:
        raise AssertionError("offload_blocks_chunk did not imply model offload")
    pin_blocks(pipe)
    fig = streamed_run(pipe, main_path_args(STEPS), want_flash,
                       {"flash_fwd": STEPS * pipe.transformer.config.num_layers}, dev)
    del pipe
    torch.cuda.empty_cache()
    return fig


COG15_HEIGHT, COG15_WIDTH, COG15_FRAMES = 768, 1360, 81
# 5e's depth: MoT in blocks 0-2 and the plain tail block (the released 42,
# MoT in 0-40, cut to leave the time limit room for phases 8a, 10a and 13a;
# every width and both K1 shapes are the released model's)
COG15_LAYERS = 4
COG15_HELD_HEADS = (slice(0, 8), slice(40, 48))  # 5e's K1 output held on these heads


class KeptAttention:
    """Within the block, the flash call of ``full_attention`` records the
    shape of every (q, k, v) it hands K1's wrapper and, with ``keep``, keeps
    the last call's tensors of each q shape (on the card) in ``qkv``; the
    wrapper and its count are untouched."""

    def __init__(self, keep=True):
        self.keep = keep

    def __enter__(self):
        from vap_tpu_torch.ops import attention

        self.module, self.fn = attention, attention.flash_attention
        self.shapes, self.qkv = [], {}

        def recording(q, k, v, scale=None, kv_lens=None):
            self.shapes.append((tuple(q.shape), tuple(k.shape), kv_lens is None))
            if self.keep:
                self.qkv[tuple(q.shape)] = (q, k, v, scale)
            return self.fn(q, k, v, scale, kv_lens)

        attention.flash_attention = recording
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.fn


def held_on_heads(name, q, k, v, scale, heads):
    """K1's wrapper on (q, k, v) on the card, its out and lse held against
    the plain version on each head slice of ``heads`` (both batch
    elements), under phase 1's limits. Returns the out's max|err|."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    err = lse_err = ref_max = 0.0
    t0 = time.perf_counter()
    for hs in heads:
        ref_out, ref_lse = fa.flash_attention_forward_plain(q[:, hs], k[:, hs], v[:, hs], scale)
        ref_max = max(ref_max, ref_out.float().abs().max().item())
        err = max(err, (out[:, hs].float() - ref_out.float()).abs().max().item())
        lse_err = max(lse_err, (lse[:, hs] - ref_lse).abs().max().item())
        del ref_out, ref_lse
    n = sum(h.stop - h.start for h in heads)
    log(f"  {name} {tuple(q.shape)} x {k.shape[2]}, held on {n} of {q.shape[1]} heads "
        f"{[(h.start, h.stop) for h in heads]} (plain {time.perf_counter() - t0:.1f} s): out "
        f"max|err| {err:.3e}, / max|ref| {ref_max:.3e} = {err / ref_max:.3e} (tol "
        f"{OUT_REL_TOL}), lse max|err| {lse_err:.3e} (tol {LSE_ATOL}), finite {finite}")
    if not (finite and err <= OUT_REL_TOL * ref_max and lse_err <= LSE_ATOL):
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def cog15_path(dev):
    """Phase 5e: CogVideoX 1.5 VAP at full width (cogvideox_5b_i2v_vap with
    CogVideoX1.5-5B-I2V's transformer fields, its VAE and T5-XXL, random
    bf16 weights from SEED, on the card) at 81 frames of 768x1360, one
    reference, CFG batch 2: one DDIM step under flash, decoded."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    t_cfg = CogVideoXMOTConfig.cogvideox_5b_i2v_vap(
        patch_size_t=2, ofs_embed_dim=512, sample_height=300, sample_width=300, sample_frames=81,
        use_learned_positional_embeddings=False, num_layers=COG15_LAYERS,
        block_idx_with_mot_ref=tuple(range(COG15_LAYERS - 1)))
    txt_cfg = T5Config.t5_xxl()
    pipe = CogVideoXVAPPipeline(
        build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, bf16, gen),
        build_random(AutoencoderKLCogVideoX,
                     CogVideoXVAEConfig(invert_scale_latents=True, scaling_factor=0.7), dev, bf16,
                     gen),
        build_random(T5EncoderModel, txt_cfg, dev, bf16, gen),
        FakeTokenizer(txt_cfg.vocab_size), dtype=bf16, device=dev)
    torch.cuda.synchronize()
    log(f"  CogVideoX 1.5 weights: transformer {n_params(pipe.transformer)} bf16 (pt "
        f"{t_cfg.patch_size_t}, ofs {t_cfg.ofs_embed_dim}, sample {t_cfg.sample_height}x"
        f"{t_cfg.sample_width}x{t_cfg.sample_frames}), {time.perf_counter() - t0:.2f} s to build")
    args = main_path_args(1, COG15_HEIGHT, COG15_WIDTH, COG15_FRAMES)
    lat_f = (COG15_FRAMES - 1) // 4 + 1
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with KeptAttention() as kept, attention_provider("flash"):
        video = pipe(**args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    st = pipe.stage_seconds
    tokens = 2 * (t_cfg.max_text_seq_length
                  + (lat_f + 1) // 2 * (COG15_HEIGHT // 16) * (COG15_WIDTH // 16))
    # the MoT blocks attend over target and reference, the plain tail block
    # over the target alone
    joint = (2, t_cfg.num_attention_heads, tokens, t_cfg.attention_head_dim)
    target = (2, t_cfg.num_attention_heads, tokens // 2, t_cfg.attention_head_dim)
    n_mot = len(t_cfg.block_idx_with_mot_ref)
    want_calls = {(joint, joint, True): n_mot, (target, target, True): t_cfg.num_layers - n_mot}
    received = {s: kept.shapes.count(s) for s in dict.fromkeys(kept.shapes)}
    log(f"  {COG15_FRAMES} frames of {COG15_HEIGHT}x{COG15_WIDTH}: {lat_f} latent frames padded to "
        f"{lat_f + lat_f % 2}; K1's wrapper received (q, k, no kv_lens): calls {received} "
        f"(expected {want_calls}); output {video.shape}, finite "
        f"{bool(np.isfinite(video).all())}, range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, "
        f"denoise step {[round(x, 3) for x in st['denoise_steps']]}, vae_decode "
        f"{st['vae_decode']:.3f}; call {wall:.3f}; peak card memory {peak:.2f} GiB (with a "
        f"joint and a target-only q, k and v kept from their blocks on); launches "
        f"{ {k: v for k, v in launches.items() if v} }; {power_line()}")
    expected = (1, COG15_FRAMES, COG15_HEIGHT, COG15_WIDTH, 3)
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"CogVideoX 1.5 output {video.shape} (expected {expected}) or "
                             f"not finite")
    check_launches(launches, {"flash_fwd": t_cfg.num_layers})
    if received != want_calls:
        raise AssertionError(f"K1 received {received}, not {want_calls}")
    del pipe, video
    torch.cuda.empty_cache()
    # K1 at these shapes against its plain version, on the last block's
    # inputs of each (block 40's joint attention, block 41's target-only)
    k1_err = max(held_on_heads(f"K1 on 5e's {what} attention", *kept.qkv[shape],
                               COG15_HELD_HEADS)
                 for what, shape in (("joint", joint), ("target-only", target)))
    kept.qkv = None
    torch.cuda.empty_cache()
    return {"step_s": st["denoise_steps"][0], "vae_encode_s": st["vae_encode"],
            "vae_decode_s": st["vae_decode"], "peak_gib": peak, "k1_max_abs_err": k1_err}


def wan_streamed_path(pipe, want, dev):
    """Phase 6d, on phase 6's pipeline (its weights in host memory) before
    6b quantises it: the same WAN_STEPS flash steps with
    offload_blocks_chunk=WAN_STREAM_CHUNK, latents bit-equal to phase 6's,
    K4's launches; then the pages unlocked.
    Returns the figures."""
    pipe.offload_blocks_chunk = WAN_STREAM_CHUNK
    pin_blocks(pipe)
    fig = streamed_run(pipe, wan_args(WAN_STEPS), want,
                       {"flash_fwd_d128": WAN_STEPS * pipe.transformer.config.num_layers * 5}, dev)
    t0 = time.perf_counter()
    pipe.close_streamed()
    pipe.offload_blocks_chunk = None
    log(f"  close_streamed (the pages unlocked) in {time.perf_counter() - t0:.2f} s; host RSS "
        f"{rss_gib()[0]:.2f} GiB, charged {charged_gib():.2f} GiB")
    return fig


class LastLatents:
    """Within the block, ``pipe``'s scheduler is a subclass whose step keeps
    the latents it returns: ``latents`` holds the final step's, on the host."""

    def __init__(self, pipe):
        self.pipe, self.latents = pipe, None

    def __enter__(self):
        scheduler, keeper = self.pipe.scheduler, self

        class Keeping(type(scheduler)):
            def step(self, *a, **kw):
                out = super().step(*a, **kw)
                keeper.latents = out
                return out

        self.scheduler = scheduler
        self.pipe.scheduler = Keeping(**{f.name: getattr(scheduler, f.name)
                                         for f in dataclasses.fields(scheduler)})
        return self

    def __exit__(self, *exc):
        self.pipe.scheduler = self.scheduler
        self.pipe = self.scheduler = None  # the pipeline goes when its phase lets go of it
        if self.latents is not None:
            self.latents = self.latents.cpu()


def export_check(trainer):
    """trainer.export() read back with the port's reader: every tensor equal
    to the trained model's. Returns the file's path (the caller removes
    it)."""
    import torch

    from vap_tpu_torch.training.checkpoint import load_safetensors

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = trainer.export()
    seconds = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    state = load_safetensors(path)
    model = trainer.model.state_dict()
    if set(state) != set(model):
        raise AssertionError(f"export: keys {sorted(set(state) ^ set(model))[:5]} differ")
    differ = [k for k, v in model.items() if not torch.equal(v, state[k].to(v.device))]
    read = time.perf_counter() - t0
    now, peak = rss_gib()
    log(f"  export: {size} bytes ({size / 1e9:.3f} GB), {len(state)} tensors, written in "
        f"{seconds:.2f} s ({size / seconds / 1e9:.2f} GB/s into the page cache), read back and "
        f"compared on the card in {read:.2f} s; tensors that differ from the trained model: "
        f"{len(differ)}; host RSS {now:.2f} GiB, peak {peak:.2f} GiB; {power_line()}")
    if differ:
        raise AssertionError(f"export: {differ[:5]} differ from the trained model")
    return path


# 10c holds each merged bf16 weight against the trained one where the
# adapters' delta is at least LORA_SIGNIFICANT_ULPS bf16 ulps of the frozen
# weight W (two steps leave most of delta below half an ulp, where any
# merge, or none, gives W): there a sound merge lands within
# LORA_MERGE_ULPS of the trained weight (both round W + delta to bf16, the
# trained one after rounding delta too; the products of A and B sum in other
# orders), in ulps of the largest of W, delta and the two merged weights,
# while a merge that drops delta, transposes it or drops alpha / r
# (WAN_LORA's alpha is 2 r) lands at least about half of
# LORA_SIGNIFICANT_ULPS off. The forward through the merged weights is held
# within LORA_FORWARD_REL (max |diff| / max |out|) of the trained model's:
# the bf16 noise of its activations, 0.012-0.015 from a sound merge, while
# the faulty ones read 0.48-0.80 on the H100. Each faulty merge is read by
# both measures in every run, and must fail both
LORA_SIGNIFICANT_ULPS = 8
LORA_MERGE_ULPS = 2
LORA_FORWARD_REL = 2e-2


def write_lora(trainer, work):
    """The trainer's adapters as PEFT safetensors (what ``export`` writes
    beside the full weights under LoRA). Returns the path."""
    from vap_tpu_torch.training.checkpoint import export_lora_safetensors

    path = os.path.join(work, "pytorch_lora_weights.safetensors")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    n = export_lora_safetensors(trainer.lora, path, rank=trainer.args.rank,
                                alpha=float(trainer.args.lora_alpha))
    log(f"  PEFT adapters: {n} bytes in {time.perf_counter() - t0:.2f} s; {power_line()}")
    return path


def bf16_ulp(x):
    """One bf16 ulp of |x| (of the smallest normal at 0)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2**-126))) - 7)


def lora_merge_check(model, path, dev):
    """The PEFT file merged into the frozen base (merge_lora_into_state_dict:
    f32 add, then bf16), held against the trained model (W + delta rounded
    in its own order): each merged weight where delta is significant (see
    LORA_SIGNIFICANT_ULPS), and one forward through the merged weights on a
    short clip. Three faulty merges, made on the card from W, A and B (no
    delta, delta transposed, delta without alpha / r), are read by both
    measures and must fail both. The model is changed in place: it ends
    with the merged weights."""
    import numpy as np
    import torch

    from vap_tpu_torch.training.checkpoint import load_lora_metadata, merge_lora_into_state_dict
    from vap_tpu_torch.training.lora import LoRALinear

    cfg = model.config
    rng = np.random.default_rng(SEED + 12)
    x = {"hidden_states": rng.standard_normal((1, 2, 30, 52, cfg.in_channels), dtype=np.float32),
         "timestep": np.array([500.0], np.float32),
         "encoder_hidden_states": rng.standard_normal((1, cfg.text_len, cfg.text_dim),
                                                      dtype=np.float32),
         "encoder_hidden_states_image": rng.standard_normal((1, 257, cfg.image_dim),
                                                            dtype=np.float32)}
    x = {k: torch.from_numpy(v).to(dev, torch.bfloat16 if v.ndim > 1 else torch.float32)
         for k, v in x.items()}
    adapted = {n: m for n, m in model.named_modules() if isinstance(m, LoRALinear)}
    base = {n: m.weight.detach() for n, m in adapted.items()}
    scales = {m.scale for m in adapted.values()}
    if scales == {1.0} or any(m.weight.shape[0] != m.weight.shape[1] for m in adapted.values()):
        raise AssertionError(f"10c needs a scale alpha / r other than 1 (got {scales}) and square "
                             f"weights, so that a dropped scale or a transposed delta shows")

    def delta(m):
        return (m.lora_A @ m.lora_B).t() * m.scale

    faulty = {"no delta": lambda w, m: w,
              "delta transposed": lambda w, m: (w.float() + delta(m).t()).to(w.dtype),
              "alpha / r dropped": lambda w, m: (w.float() + delta(m) / m.scale).to(w.dtype)}

    def forward(weights):
        """The model's output with each adapted layer running ``weights``
        alone (its adapter scaled by 0)."""
        kept = {n: m.scale for n, m in adapted.items()}
        for n, m in adapted.items():
            m.weight.data, m.scale = weights[n], 0.0
        out = model(**x).float()
        for n, m in adapted.items():
            m.weight.data, m.scale = base[n], kept[n]
        return out

    with torch.no_grad():
        want = model(**x).float()
        t0 = time.perf_counter()
        merged = merge_lora_into_state_dict({f"{n}.weight": w for n, w in base.items()}, path)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        merged = {n: merged.pop(f"{n}.weight") for n in adapted}
        ulps = dict.fromkeys(["merge", *faulty], 0.0)
        significant = 0
        for n, m in adapted.items():
            trained, d, w = m.merged_weight().float(), delta(m), base[n]
            sig = d.abs() >= LORA_SIGNIFICANT_ULPS * bf16_ulp(w.float())
            significant += int(sig.sum())
            trained, mag = trained[sig], torch.maximum(w.float()[sig].abs(), d[sig].abs())
            for name, got in (("merge", merged[n]), *((k, f(w, m)) for k, f in faulty.items())):
                got = got.float()[sig]
                # ulps of the largest of the four: where W + delta cancels,
                # delta's own rounding is what the two merges differ by
                ulp = bf16_ulp(torch.maximum(mag, torch.maximum(got.abs(), trained.abs())))
                off = (got - trained).abs() / ulp
                ulps[name] = max(ulps[name], off.max().item() if off.numel() else 0.0)
        errs = {"merge": ((forward(merged) - want).abs().max() / want.abs().max()).item()}
        for name, f in faulty.items():
            out = forward({n: f(base[n], m) for n, m in adapted.items()})
            errs[name] = ((out - want).abs().max() / want.abs().max()).item()
        for n, m in adapted.items():  # the LoRALinear now runs the merged weight alone
            m.weight.data = merged[n]
            m.lora_B.zero_()
    total = sum(w.numel() for w in base.values())
    log(f"  PEFT file (lora_config {load_lora_metadata(path)}) merged into {len(adapted)} frozen "
        f"weights in {seconds:.2f} s; {significant} of {total} adapted elements with |delta| of "
        f"{LORA_SIGNIFICANT_ULPS} bf16 ulps of W or more; there, merged vs trained weights: max "
        f"{ulps['merge']:g} bf16 ulps (limit {LORA_MERGE_ULPS}); forward through the merged "
        f"weights at {tuple(x['hidden_states'].shape)}: max |diff| / max |out| "
        f"{errs['merge']:.4g} (limit {LORA_FORWARD_REL}); {power_line()}")
    log("  faulty merges, which must fail both: " + "; ".join(
        f"{name}: {ulps[name]:g} ulps, forward {errs[name]:.4g}" for name in faulty))
    if not significant:
        raise AssertionError("LoRA merge: no element of delta is significant, so no merge could "
                             "fail the weight check")
    if ulps["merge"] > LORA_MERGE_ULPS or not errs["merge"] <= LORA_FORWARD_REL:
        raise AssertionError(f"LoRA merge: weights {ulps['merge']} ulps (limit "
                             f"{LORA_MERGE_ULPS}), forward {errs['merge']} (limit "
                             f"{LORA_FORWARD_REL})")
    passed = [name for name in faulty
              if ulps[name] <= LORA_MERGE_ULPS or errs[name] <= LORA_FORWARD_REL]
    if passed:
        raise AssertionError(f"LoRA merge: the faulty merges {passed} pass a limit, which so "
                             f"cannot tell them from a sound one")


# ---------------------------------------------------------------------------
# phase 6: Wan
# ---------------------------------------------------------------------------

def wan_small_check(dev):
    """A small Wan pipeline on the card at head_dim 128 (so K4 and K2 at
    D=128 run): kernels vs the plain dense attention, and launch counts."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    t_cfg = WanMOTConfig.tiny(attention_head_dim=128, in_channels=12, out_channels=4,
                              text_dim=32, image_dim=24, added_kv_proj_dim=256, ffn_dim=512)
    pipe = WanVAPPipeline(
        build_random(WanTransformer3DMOTModel, t_cfg, dev, bf16, gen),
        build_random(AutoencoderKLWan, WanVAEConfig.tiny(), dev, bf16, gen),
        build_random(T5EncoderModel, T5Config.tiny(per_layer_relative_bias=True), dev, bf16, gen),
        build_random(CLIPVisionModel, CLIPVisionConfig.tiny(), dev, bf16, gen),
        FakeTokenizer(128), dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(image=rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 32, 32, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=32, width=32, num_frames=9,
                num_inference_steps=STEPS, guidance_scale=5.0, max_sequence_length=16,
                output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)))
    with attention_provider("xla"):
        ref = pipe(**args)
    # per MoT block and step: the joint attention and four cross-attentions
    want = STEPS * t_cfg.num_layers * 5
    for provider, kernel in (("flash", "flash_fwd_d128"), ("sage", "sage_fwd")):
        reset_counts()
        with attention_provider(provider):
            got = pipe(**args)
        launches = read_counts()
        err = (got - ref).abs().max().item()
        log(f"  small Wan pipeline, {provider} vs plain dense attention: final latents "
            f"max|err| {err:.4e} (tol {WAN_E2E_ATOL[provider]}), max|ref| "
            f"{ref.abs().max().item():.3f}, launches {launches}")
        check_launches(launches, {kernel: want})
        if not (torch.isfinite(got).all() and err <= WAN_E2E_ATOL[provider]):
            raise AssertionError(f"small Wan pipeline under {provider} disagrees with plain attention")


# the Wan generation phases (6, 6b, 6c, 6d) run the first 20 of the released
# 40 blocks, MoT in each (cut to leave the time limit room for phases 8a, 10a
# and 13a; every width is the released one, and phase 10 trains all 40)
WAN_GEN_LAYERS = 20


def build_wan_pipeline(dev):
    """Wan2.1-I2V-14B VAP at full width and WAN_GEN_LAYERS of its 40 blocks,
    with random bf16 weights from SEED, each component built on the card and
    kept in host memory (model offload)."""
    import torch

    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    t_cfg = WanMOTConfig.wan_14b_i2v_vap(num_layers=WAN_GEN_LAYERS,
                                         block_idx_with_mot_ref=tuple(range(WAN_GEN_LAYERS)))
    txt_cfg = T5Config.umt5_xxl()
    parts = {}
    for name, cls, cfg in (("transformer", WanTransformer3DMOTModel, t_cfg),
                           ("vae", AutoencoderKLWan, WanVAEConfig()),
                           ("text_encoder", T5EncoderModel, txt_cfg),
                           ("image_encoder", CLIPVisionModel, CLIPVisionConfig())):
        parts[name] = build_random(cls, cfg, dev, bf16, gen, host=True)
        torch.cuda.empty_cache()
    pipe = WanVAPPipeline(**parts, tokenizer=FakeTokenizer(txt_cfg.vocab_size), dtype=bf16,
                          device=dev, enable_model_offload=True)
    counts = {name: n_params(m) for name, m in parts.items()}
    log(f"Wan weights: {counts} bf16 in host memory ({sum(counts.values()) * 2 / 2**30:.2f} GiB; "
        f"host MemTotal {mem_total_gib():.2f} GiB), {time.perf_counter() - t0:.2f} s to build; "
        f"{t_cfg.num_layers} blocks, MoT in {len(t_cfg.block_idx_with_mot_ref)}, "
        f"{t_cfg.num_attention_heads}x{t_cfg.attention_head_dim} heads, ffn {t_cfg.ffn_dim}")
    return pipe


def wan_args(steps):
    """The Wan main path's call (infer/wan_vap.py): a synthetic 480x832
    image, a 49-frame reference video, two prompts, guidance 5."""
    import numpy as np

    yy, xx = np.meshgrid(np.linspace(-1, 1, WAN_HEIGHT), np.linspace(-1, 1, WAN_WIDTH),
                         indexing="ij")
    image = np.stack([xx, yy, xx * yy], -1).astype(np.float32)
    t = np.linspace(0, 1, NUM_FRAMES)[:, None, None, None]
    ref_video = np.clip(np.sin(3 * image[None] + 4 * t), -1, 1).astype(np.float32)
    return dict(image=image, prompt="a red fox runs through fresh snow", ref_videos=[ref_video],
                prompt_mot_ref=["the camera orbits the subject"], height=WAN_HEIGHT,
                width=WAN_WIDTH, num_frames=NUM_FRAMES, num_inference_steps=steps,
                guidance_scale=5.0, seed=SEED)


def wan_main_path(pipe, provider, steps, dev):
    import numpy as np
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    args = wan_args(steps)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with attention_provider(provider):
        video = pipe(**args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = pipe.stage_seconds
    expected = (1, NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3)
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, image_encode "
        f"{st['image_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, denoise steps "
        f"{[round(s, 3) for s in st['denoise_steps']]}, vae_decode {st['vae_decode']:.3f}, "
        f"host->card staging { {k: round(v, 3) for k, v in st['staging'].items()} }; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"Wan output {video.shape} (expected {expected}) or not finite")
    kernel = "flash_fwd_d128" if provider == "flash" else "sage_fwd"
    # per MoT block and step: the joint attention and four cross-attentions
    want = steps * pipe.transformer.config.num_layers * 5
    check_launches(launches, {kernel: want})
    return launches[kernel]


def wan_bench_path(pipe, dev):
    """Phase 6b, the Wan bench configuration on phase 6's pipeline (its
    weights in host memory): the projections quantised to W8A8 in the chunk
    form, each weight on the card and its int8 copy back in host memory, then
    WanVAPPipeline.__call__ under sage, UniPC (shift 3, guidance 5) and the
    step cache "uniform:2:1:1" over 4 steps, decoded. K3 and K2 (with its
    pre-pass) launch on the computed steps 0, 1 and 3 only, the row form
    never, and the reuse step costs under 5% of a computed one. Returns K3's
    launches."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.common import quantize_transformer_linears
    from vap_tpu_torch.ops.schedulers import UniPCScheduler

    if pipe._staged and pipe._staged[0][0] == "transformer":
        raise AssertionError("the transformer is staged: quantise its host weights, not a copy")
    model = pipe.transformer
    t0 = time.perf_counter()
    names = quantize_transformer_linears(model, act_scale="chunk", device=dev)
    quantize_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    n_int8 = sum(model.get_submodule(n).w_i8.numel() for n in names)
    log(f"  {len(names)} projections "
        f"({n_int8} weights) quantised on the card, int8 kept in host memory, in {quantize_s:.2f} "
        f"s; the transformer now {sum(t.numel() * t.element_size() for t in model.state_dict().values()) / 2**30:.2f} GiB")
    per_step = sum(wan_w8a8_shapes(model.config.num_layers).values())
    if len(names) != per_step:
        raise AssertionError(f"{len(names)} projections quantised, expected {per_step}")

    flow_match, pipe.scheduler = pipe.scheduler, UniPCScheduler(shift=3.0)
    try:
        video, wall, peak, launches, deltas = counted_call(
            pipe, dict(wan_args(BENCH_STEPS), step_cache=BENCH_CACHE), "sage", dev)
    finally:
        pipe.scheduler = flow_match
    st = pipe.stage_seconds
    steps = st["denoise_steps"]
    shown = ("w8a8", "w8a8_row_calls", "sage_fwd", "sage_quant")
    expected = (1, NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3)
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, image_encode "
        f"{st['image_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, denoise steps "
        f"{[round(x, 3) for x in steps]} (computed {st['computed_steps']}), vae_decode "
        f"{st['vae_decode']:.3f}, host->card staging "
        f"{ {k: round(v, 3) for k, v in st['staging'].items()} }; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; per step " + "; ".join(
        f"step {i}: " + ", ".join(f"{k} {d[k]}" for k in shown) for i, d in enumerate(deltas)))
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"Wan bench configuration output {video.shape} (expected "
                             f"{expected}) or not finite")
    if st["computed_steps"] != BENCH_COMPUTED:
        raise AssertionError(f"computed steps {st['computed_steps']}, expected {BENCH_COMPUTED}")
    n = len(BENCH_COMPUTED)
    # per MoT block and step: the joint attention and four cross-attentions
    check_launches(launches, {"sage_fwd": n * model.config.num_layers * 5, "w8a8": n * per_step})
    check_reuse_steps(steps, deltas)
    return launches["w8a8"]


# phase 6c: the Wan checkpoint, at full width and cut depth: the first
# WAN_CKPT_LAYERS blocks of phase 6's transformer (each with its MoT expert)
# with its UMT5, CLIP and VAE
WAN_CKPT_LAYERS = 4
WAN_CKPT_COMPONENTS = (("transformer", "WanTransformer3DMOTModel", "diffusion_pytorch_model"),
                       ("vae", "AutoencoderKLWan", "diffusion_pytorch_model"),
                       ("text_encoder", "UMT5EncoderModel", "model"),
                       ("image_encoder", "CLIPVisionModelWithProjection", "model"))


def wan_cut_transformer(model, dev):
    """The first WAN_CKPT_LAYERS blocks of ``model``, with its embedders and
    its head, on the card (``load_model`` reads the blocks the cut model
    has and ignores the others)."""
    import torch

    from vap_tpu_torch.models.loading import load_model

    mot = tuple(i for i in model.config.block_idx_with_mot_ref if i < WAN_CKPT_LAYERS)
    cfg = dataclasses.replace(model.config, num_layers=WAN_CKPT_LAYERS, block_idx_with_mot_ref=mot)
    return load_model(type(model), cfg, model.state_dict(), dev, torch.bfloat16)


def wan_latents(pipe, dev, want_launches):
    """Latents of one step of the Wan main path's call under flash, with
    every count at 0 before it and exactly ``want_launches`` K4 launches."""
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    reset_counts()
    with attention_provider("flash"):
        latents = pipe(**dict(wan_args(1), output_type="latent"))
    torch.cuda.synchronize()
    launches = read_counts()
    check_launches(launches, {"flash_fwd_d128": want_launches})
    pipe._staged.clear()  # the slot's card copy goes now
    return latents.cpu(), launches


def wan_checkpoint_write_path(pipe, cut, dev):
    """Phase 6c, out: phase 6's UMT5, CLIP and VAE with ``cut`` as a
    pipeline in host memory, as phase 6's is; its latents (one step under
    flash), then its four components written as a checkpoint directory
    under build/. Returns (the directory, the bytes, the latents)."""
    import torch

    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    pipe._staged.clear()
    torch.cuda.empty_cache()
    resident = WanVAPPipeline(transformer=cut.to("cpu"), vae=pipe.vae,
                              text_encoder=pipe.text_encoder, image_encoder=pipe.image_encoder,
                              tokenizer=pipe.tokenizer, dtype=torch.bfloat16, device=dev,
                              enable_model_offload=True)
    want, launches = wan_latents(resident, dev, WAN_CKPT_LAYERS * 5)
    log(f"  {WAN_CKPT_LAYERS} blocks ({n_params(cut)} parameters), 1 step: latents "
        f"{tuple(want.shape)}, finite {bool(torch.isfinite(want).all())}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return (*timed_write(resident, WAN_CKPT_COMPONENTS), want)


def wan_checkpoint_load_path(root, written, want, dev):
    """Phase 6c, in: wan_vap.build_pipeline from that directory (the weights
    into host memory, as phase 6's), the transformer's depth from its
    config.json; one step's latents under flash with every count at 0
    before it, K4's launches checked, bit-equal to the resident pipeline's.
    Returns its UMT5, CLIP and VAE, which go on to phase 10b."""
    import torch

    from vap_tpu_torch.infer.wan_vap import build_pipeline
    from vap_tpu_torch.models.text_encoders.t5 import T5Config

    pipe = timed_build(build_pipeline, written, dev, model_path=root, dtype_str="bfloat16",
                       enable_model_offload=True,
                       tokenizer=FakeTokenizer(T5Config.umt5_xxl().vocab_size))
    depth = pipe.transformer.config.num_layers
    if depth != WAN_CKPT_LAYERS:
        raise AssertionError(f"the rebuilt transformer has {depth} blocks, its config.json "
                             f"{WAN_CKPT_LAYERS}")
    got, launches = wan_latents(pipe, dev, WAN_CKPT_LAYERS * 5)
    same = torch.equal(got, want)
    log(f"  flash, 1 step: latents {tuple(got.shape)} bit-equal to the resident pipeline's: "
        f"{same}; launches { {k: v for k, v in launches.items() if v} }")
    if not same:
        raise AssertionError(f"Wan checkpoint path: latents differ from the resident pipeline's "
                             f"by up to {(got - want).abs().max().item()}")
    parts = {name: getattr(pipe, name) for name in ("vae", "text_encoder", "image_encoder")}
    del pipe
    shutil.rmtree(root)
    return parts


def wan_plain_sampling_path(model, parts, dev):
    """Phase 10b: phase 10's trained plain transformer (40 blocks, its LoRA
    adapters in place, on the card) sampled through WanVAPPipeline.__call__
    without a reference, with phase 6's UMT5, CLIP and VAE under offload:
    plain image-to-video at 49f@480x832, UniPC (shift 3, guidance 5), 2
    steps under flash, latents out. K4 runs each block's self-attention
    ([2,40,20280,128]) and its two cross-attentions (512 text, 257 CLIP
    keys): 120 launches a step."""
    import torch

    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.ops.schedulers import UniPCScheduler
    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    pipe = WanVAPPipeline(model.eval(), parts["vae"], parts["text_encoder"],
                          parts["image_encoder"],
                          FakeTokenizer(parts["text_encoder"].config.vocab_size),
                          scheduler=UniPCScheduler(shift=3.0), dtype=torch.bfloat16, device=dev,
                          enable_model_offload=True)
    args = dict(wan_args(WAN_STEPS), ref_videos=None, prompt_mot_ref=None, output_type="latent")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with attention_provider("flash"):
        latents = pipe(**args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = pipe.stage_seconds
    cfg = model.config
    expected = (1, (NUM_FRAMES - 1) // 4 + 1, WAN_HEIGHT // 8, WAN_WIDTH // 8, cfg.out_channels)
    log(f"  latents {tuple(latents.shape)}, finite {bool(torch.isfinite(latents).all())}, max "
        f"{latents.abs().max().item():.3f}; stage seconds: text_encode {st['text_encode']:.3f}, "
        f"image_encode {st['image_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, denoise "
        f"steps {[round(x, 3) for x in st['denoise_steps']]}, host->card staging "
        f"{ {k: round(v, 3) for k, v in st['staging'].items()} }; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if tuple(latents.shape) != expected or not torch.isfinite(latents).all():
        raise AssertionError(f"plain Wan sampling: latents {tuple(latents.shape)} (expected "
                             f"{expected}) or not finite")
    check_launches(launches, {"flash_fwd_d128": WAN_STEPS * cfg.num_layers * 3})
    pipe._staged.clear()  # the slot's host references go with the pipeline


# ---------------------------------------------------------------------------
# phase 7: K5, the flash backward
# ---------------------------------------------------------------------------

def backward_parity(dev, d128=False):
    """K5 (head_dim 64) or K6 (``d128``: head_dim 128) against its plain
    version at the unaligned shapes and the main-path shapes, with the
    planted fault; then its times at the first main-path shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + (9 if d128 else 7))
    name = "flash_bwd_d128" if d128 else "flash_bwd"
    plain = fa.flash_attention_backward_rows_plain if d128 else fa.flash_attention_backward_plain

    def inputs(b, h, sq, skv, d):
        q, k, v, dout = [torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                         for s in (sq, skv, skv, sq)]
        out, lse = fa.flash_attention_forward(q, k, v)
        return q, k, v, out, lse, dout

    def rolled_in_q_tiles(x):
        n = x.shape[2] // Q_TILE * Q_TILE
        tiles = x[:, :, :n].unflatten(2, (-1, Q_TILE)).roll(1, dims=3).flatten(2, 3)
        return torch.cat([tiles, x[:, :, n:]], dim=2).contiguous()

    def errors(got, ref):
        return [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
                for g, r in zip(got, ref)]

    if d128:  # Wan's self-attention, then its text and CLIP cross-attentions
        shapes = [(1, 40, sq, skv, 128) for sq, skv in PARITY_SHAPES] + WAN_TRAIN_ATTN
    else:
        shapes = ([(1, 48, sq, skv, 64) for sq, skv in PARITY_SHAPES]
                  + [MAIN_SHAPE[:3] + MAIN_SHAPE[2:]])
    worst = 0.0
    for b, h, sq, skv, d in shapes:
        q, k, v, out, lse, dout = inputs(b, h, sq, skv, d)
        got = fa.flash_attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ref = plain(q, k, v, out, lse, dout)
        errs = errors(got, ref)
        del got
        fault = errors(fa.flash_attention_backward(q, k, v, out, lse, rolled_in_q_tiles(dout)), ref)
        log(f"  {name} {(b, h, sq, d)} x {skv}: " + ", ".join(
            f"d{n} max|err| {e:.3e} / max|ref| {m:.3e} = {e / m:.3e} (planted fault {fe / m:.3e})"
            for n, (e, m), (fe, _) in zip("qkv", errs, fault)) + f" (tol {GRAD_REL_TOL}), "
            f"finite {finite}")
        if not (finite and all(e <= GRAD_REL_TOL * m for e, m in errs)):
            raise AssertionError(f"{name} disagrees with its plain version")
        if not all(fe > GRAD_REL_TOL * m for (fe, m) in fault):
            raise AssertionError(f"{name}: the limit does not catch dout rows out of place")
        worst = max([worst] + [e for e, _ in errs])
        del q, k, v, out, lse, dout, ref
        torch.cuda.empty_cache()

    b, h, sq, skv, d = shapes[len(PARITY_SHAPES)]
    q, k, v, out, lse, dout = inputs(b, h, sq, skv, d)
    # every sum in one block in a fixed order: two runs give the same bits
    first = fa.flash_attention_backward(q, k, v, out, lse, dout)
    same = all(torch.equal(a, c) for a, c in
               zip(first, fa.flash_attention_backward(q, k, v, out, lse, dout)))
    log(f"  {name} at {(b, h, sq, d)} x {skv}: two runs bit-equal {same}")
    if not same:
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    del first
    ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), iters=3, warmup=1)
    plain_ms = time_ms(lambda: plain(q, k, v, out, lse, dout), iters=1, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):  # one PyTorch call: a yardstick
        o = F.scaled_dot_product_attention(*leaves)
    library_ms = time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), iters=3,
                         warmup=1)
    bound_ms, bound_by = bwd_bound(b, h, sq, skv, d)
    tflops = 10 * b * h * sq * skv * d / (ms * 1e-3) / 1e12
    log(f"  {name} at {(b, h, sq, d)} x {skv}: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, SDPA flash backward {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by})")
    del q, k, v, out, lse, dout, leaves, o
    torch.cuda.empty_cache()
    result = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms, "shape": [b, h, sq, skv, d]}
    if d128:  # K6 at Wan's cross shapes (512 UMT5 and 257 CLIP keys) as well
        result["cross"] = []
        for b, h, sq, skv, d in shapes[len(PARITY_SHAPES) + 1:]:
            q, k, v, out, lse, dout = inputs(b, h, sq, skv, d)
            c_ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), iters=5,
                           warmup=2)
            c_plain = time_ms(lambda: plain(q, k, v, out, lse, dout), iters=1, warmup=1)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                o = F.scaled_dot_product_attention(*leaves)
            c_lib = time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                            iters=5, warmup=2)
            c_bound, c_by = bwd_bound(b, h, sq, skv, d)
            log(f"  {name} at {(b, h, sq, d)} x {skv}: kernel {c_ms:.3f} ms, plain {c_plain:.3f} "
                f"ms, SDPA flash backward {c_lib:.3f} ms, bound {c_bound:.3f} ms ({c_by})")
            result["cross"].append({"shape": [b, h, sq, skv, d], "ms": c_ms, "plain_ms": c_plain,
                                    "library_ms": c_lib, "bound_ms": c_bound, "bound_by": c_by})
            del q, k, v, out, lse, dout, leaves, o
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8: the full-width CogVideoX VAP training step
# ---------------------------------------------------------------------------

# the recipe's clips: (frames, height, width, fps); each fits the 49x480x720
# bucket differently (the height decides cv2's mode): 512x768 shrinks
# (INTER_AREA), 448x672 grows (INTER_LINEAR), 512x640 shrinks its height and
# grows its width (INTER_AREA's area-mode taps), and 74 frames at 24 fps
# resample to 49 at 16
TRAIN_CLIPS = ((NUM_FRAMES, 512, 768, 16), (NUM_FRAMES, 448, 672, 16), (74, 512, 640, 24))


def seeded_clip(seed, frames, h, w):
    """A smooth seeded clip, uint8 [F, H, W, 3]: a coarse random pattern,
    upsampled, drifting a few pixels a frame (cheap to encode)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3), dtype=np.uint8)
    big = np.repeat(np.repeat(base, 16, axis=0), 16, axis=1)
    return np.stack([big[(2 * f) % 16:(2 * f) % 16 + h, f % 16:f % 16 + w]
                     for f in range(frames)])


def log_video_io():
    """Log the video I/O the data path uses on this machine (OpenCV; the
    package raises, naming it, where it is missing)."""
    import cv2

    log(f"  video I/O: OpenCV {cv2.__version__}")


def write_training_data(root, clips=TRAIN_CLIPS, steps=VAL_STEPS, size=(NUM_FRAMES, HEIGHT, WIDTH)):
    """The recipe's data directory: the clips, a vap_data.csv over them
    (each row's reference the next clip), a training.json shaped like the
    recipe's, and a validation.json over a one-row benchmark.csv whose
    target and reference are two more clips at the generation size (the
    validation rows are not resized, as in JAX). Returns (training.json,
    validation.json)."""
    import csv

    from vap_tpu_torch.data.video import export_to_video

    os.makedirs(root, exist_ok=True)
    names = []
    for i, (frames, h, w, fps) in enumerate(clips + ((size + (16,),) * 2)):
        names.append(f"clip_{i}.mp4")
        export_to_video(seeded_clip(SEED + i, frames, h, w), os.path.join(root, names[-1]), fps=fps)
    bench = names[len(clips):]
    names = names[:len(clips)]
    rows = [{"video_paths": n, "tar_video_caption": f"The video shows effect {i} on a scene",
             "ref_video_paths": json.dumps([names[(i + 1) % len(names)]]), "kind": "fx",
             "split": "train", "reference_alignment_score": 9.0} for i, n in enumerate(names)]
    bench_row = dict(rows[0], video_paths=bench[0], ref_video_paths=json.dumps([bench[1]]),
                     ref_video_caption="the reference")
    for name, table in (("vap_data.csv", rows), ("benchmark.csv", [bench_row])):
        with open(os.path.join(root, name), "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(table[0]))
            writer.writeheader()
            writer.writerows(table)
    training = os.path.join(root, "training.json")
    with open(training, "w") as fh:
        json.dump({"datasets": [{"dataset_type": "video", "video_resolution_buckets": [list(size)],
                                 "reshape_mode": "bicubic",
                                 "remove_common_llm_caption_prefixes": True,
                                 "frames_selection": "evenly", "meta_df_name": "vap_data.csv"}]},
                  fh)
    validation = os.path.join(root, "validation.json")
    with open(validation, "w") as fh:
        json.dump({"csv": "benchmark.csv", "num_frames": size[0], "height": size[1],
                   "width": size[2], "num_inference_steps": steps, "guidance_scale": 6.0,
                   "use_dynamic_cfg": True}, fh)
    return training, validation


def recipe_args(root, out, steps, **kw):
    """The recipe's trainer flags (vap_mot/train_single_node.sh) at a
    constant lr, on the data directory ``root``."""
    from vap_tpu_torch.training.args import TrainingArgs

    training, validation = (os.path.join(root, "training.json"),
                            os.path.join(root, "validation.json"))
    base = dict(data_root=root, dataset_config=training, validation_dataset_file=validation,
                validation_steps=steps, video_resolution_buckets=((NUM_FRAMES, HEIGHT, WIDTH),),
                output_dir=out, seed=SEED, train_steps=steps, optimizer="adamw", lr=TRAIN_LR,
                lr_scheduler="constant", lr_warmup_steps=0, beta1=0.9, beta2=0.99,
                weight_decay=1e-4, max_grad_norm=1.0, gradient_checkpointing=True,
                checkpointing_steps=NEVER, logging_steps=1)
    base.update(kw)
    return TrainingArgs(**base)


def build_trainer(dev, work, steps):
    """CogVideoX-5B VAP at full width with random bf16 weights from SEED on
    the card, T5-XXL and the VAE beside it (the spec), and an SFTTrainer of
    the recipe for ``steps`` optimizer steps on the clips under
    ``work``/data, validating at the last step."""
    import shutil

    import torch

    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.training.specs import CogVideoXSpec
    from vap_tpu_torch.training.trainer import SFTTrainer

    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_training_data(os.path.join(work, "data"))
    log(f"  {len(TRAIN_CLIPS)} clips {[c[:3] for c in TRAIN_CLIPS]}, 2 benchmark clips at "
        f"{NUM_FRAMES}x{HEIGHT}x{WIDTH} and the recipe's JSON files written in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = CogVideoXMOTConfig.cogvideox_5b_i2v_vap()
    model = build_random(CogVideoXTransformer3DMOTModel, cfg, dev, torch.bfloat16,
                         torch.Generator(device=dev).manual_seed(SEED + 8))
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    txt_cfg = T5Config.t5_xxl()
    spec = CogVideoXSpec(model, FakeTokenizer(txt_cfg.vocab_size), dtype=torch.bfloat16, device=dev,
                         vae=build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig(), dev,
                                          torch.bfloat16, gen),
                         text_encoder=build_random(T5EncoderModel, txt_cfg, dev, torch.bfloat16,
                                                   gen))
    args = recipe_args(os.path.join(work, "data"), os.path.join(work, "out"), steps)
    return SFTTrainer(args, model, spec, track_stage_peaks=True)


def first_item_batch(trainer):
    """The first item of the trainer's stream, encoded (its seconds), as a
    batch; the tracker's spans and the stage peaks it left are cleared."""
    from vap_tpu_torch.data.config import build_datasets_from_config
    from vap_tpu_torch.data.sampler import ResolutionSampler

    args = trainer.args
    sample = next(iter(build_datasets_from_config(args.dataset_config, args,
                                                  family=args.model_name)))
    t0 = time.perf_counter()
    cond, lat = trainer._preprocess(sample)
    seconds = time.perf_counter() - t0
    spans = trainer.tracker._drain_timings()
    peaks = dict(trainer.stage_peaks)
    trainer.stage_peaks.clear()
    batch = trainer._batch(iter([(cond, lat)]), ResolutionSampler(1))
    trainer.data_position = 0
    log(f"  one item encoded (bucket fit, T5 on 2 prompts, the VAE on the target, its first "
        f"frame, the reference and its first frame) in {seconds:.3f} s: "
        f"{ {k: round(v, 3) for k, v in spans.items()} }, peak card memory "
        f"{ {k: round(v / 2**30, 2) for k, v in peaks.items()} } GiB; latents "
        f"{tuple(lat['latents'].shape)}, text {tuple(cond['encoder_hidden_states'].shape)}")
    return batch


def training_path(dev):
    import gc
    import shutil

    import numpy as np
    import torch

    from vap_tpu_torch.data import video

    work = os.path.join(HERE, "build", "chip_smoke_train")
    t0 = time.perf_counter()
    log_video_io()
    trainer = build_trainer(dev, work, TRAIN_STEPS)
    model, cfg, spec = trainer.model, trainer.model.config, trainer.spec
    params = dict(model.named_parameters())
    before = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    n_train = sum(params[n].numel() for n in trainer.trainable_names)
    log(f"  {cfg.num_layers} blocks, MoT in {min(cfg.block_idx_with_mot_ref)}-"
        f"{max(cfg.block_idx_with_mot_ref)}: {n_params(model)} bf16 parameters, {n_train} "
        f"trainable in {len(trainer.trainable_names)} tensors, T5 {n_params(spec.text_encoder)} "
        f"and VAE {n_params(spec.vae)} on the card, remat {trainer.step_cfg.remat!r}, AdamW "
        f"fused {trainer.optimizer.inner.defaults['fused']}; "
        f"{time.perf_counter() - t0:.2f} s to build")
    batch0 = first_item_batch(trainer)
    ring_training_check(trainer, dev, batch0)
    videos = []
    validation = spec.validation

    def kept(sample, **kw):  # the validation video, kept for the checks
        videos.append(validation(sample, **kw))
        return videos[-1]

    spec.validation = kept
    decodes = dict(video.DECODES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    launches = read_counts()
    path = os.path.join(trainer.args.output_dir, "validation", f"{TRAIN_STEPS:06d}",
                        "sample_0.mp4")
    written = video.load_video(path)[0] if os.path.exists(path) else None
    decoded = {k: v - decodes[k] for k, v in video.DECODES.items()}
    # each span resets the peak: the run's is the largest span's
    peak = max(trainer.stage_peaks.values(), default=0)
    for r, entry in zip(trainer.history, trainer.tracker.history):
        total = r["forward_s"] + r["backward_s"] + r["update_s"]
        log(f"  step {r['step']}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, lr "
            f"{r['lr']:.1e}, {total:.3f} s = forward {r['forward_s']:.3f} + backward "
            f"{r['backward_s']:.3f} + update {r['update_s']:.3f}; spans "
            f"{ {k: round(v, 3) for k, v in entry.items() if k.startswith('timing/')} }")
    spans = {k for entry in trainer.tracker.history for k in entry if k.startswith("timing/")}
    peaks = {k: round(v / 2**30, 2) for k, v in trainer.stage_peaks.items()}
    want_k1 = 2 * cfg.num_layers * TRAIN_STEPS + cfg.num_layers * VAL_STEPS
    log(f"  {TRAIN_STEPS} steps and a validation in {wall:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB, by span {peaks} GiB; videos decoded in the run {decoded}; "
        f"launches {launches}: K1 {launches['flash_fwd']} (expected {want_k1}: "
        f"{2 * cfg.num_layers} a training step, forward and recompute, and {cfg.num_layers} a "
        f"validation DDIM step at CFG batch 2) and K5 {launches['flash_bwd']} (expected "
        f"{cfg.num_layers * TRAIN_STEPS})")
    check_launches(launches, {"flash_fwd": want_k1, "flash_bwd": cfg.num_layers * TRAIN_STEPS})
    if not (len(trainer.history) == TRAIN_STEPS == trainer.optimizer.count
            and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in trainer.history)):
        raise AssertionError(f"training: {trainer.optimizer.count} updates, history "
                             f"{trainer.history}")
    need = {"timing/prepare_conditions", "timing/prepare_latents", "timing/train_step",
            "timing/validation"}
    if not need <= spans:
        raise AssertionError(f"training: spans {sorted(spans)} lack {sorted(need - spans)}")
    out = videos[0] if len(videos) == 1 else None
    log(f"  validation video: {None if out is None else out.shape}, finite "
        f"{out is not None and bool(np.isfinite(out).all())}, range "
        f"[{out.min():.3f}, {out.max():.3f}]; {path} read back "
        f"{None if written is None else written.shape}")
    if (out is None or out.shape != (NUM_FRAMES, HEIGHT, WIDTH, 3) or not np.isfinite(out).all()
            or written is None or written.shape != (NUM_FRAMES, HEIGHT, WIDTH, 3)):
        raise AssertionError("training: the validation video is missing, not finite or not "
                             f"{NUM_FRAMES} frames of {HEIGHT}x{WIDTH}")
    trainable = set(trainer.trainable_names)
    frozen_changed = [n for n, p in params.items()
                      if n not in trainable and not torch.equal(p.detach().cpu(), before[n])]
    moved = {n: int((params[n].detach().cpu() != before[n]).sum()) for n in trainable}
    # What must move: a bf16 weight moves only where an lr-sized step passes
    # half its ulp, so the LayerNorm scales (all 1.0, ulp 2^-7) cannot at lr
    # 1e-5; and the last MoT block's reference queries, output projection
    # and feed-forward feed only the reference stream, which no loss reads:
    # their gradients are zero and they must stay as they were.
    last = max(cfg.block_idx_with_mot_ref)
    dead = tuple(f"transformer_blocks.{last}.{m}" for m in (
        "attn1_mot_ref.to_q", "attn1_mot_ref.norm_q", "attn1_mot_ref.to_out", "norm2_mot_ref",
        "ff_mot_ref"))
    scales = ("norm.weight", "norm_q.weight", "norm_k.weight")
    must = [n for n in trainable if not n.startswith(dead) and not n.endswith(scales)]
    log(f"  frozen tensors changed: {len(frozen_changed)} of {len(params) - len(trainable)}; "
        f"trainable tensors moved: {sum(c > 0 for c in moved.values())} of {len(trainable)} "
        f"({len(must)} must move), {sum(moved.values())} of {n_train} elements "
        f"({sum(moved.values()) / n_train:.4f}); the last MoT block's reference-only tensors "
        f"moved: {sum(moved[n] > 0 for n in trainable if n.startswith(dead))}")
    stuck = [n for n in must if moved[n] == 0]
    woke = [n for n in trainable if n.startswith(dead) and moved[n]]
    if frozen_changed or stuck or woke:
        raise AssertionError(f"training: frozen tensors changed {frozen_changed[:5]}, trainable "
                             f"tensors that did not move {stuck[:5]}, reference-only tensors "
                             f"that moved {woke[:5]}")
    del params, before, videos
    opt8 = adam8bit_check(trainer, batch0, dev)
    t0 = time.perf_counter()
    exported = export_check(trainer)
    seconds = time.perf_counter() - t0
    # the DPO step runs on the same model, T5 and VAE: the expert's AdamW
    # state and gradients go first; the export holds the weights it starts
    # from
    spec.validation = validation
    trainer.optimizer.inner.state.clear()
    for p in model.parameters():
        p.grad = None
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    dpo = dpo_path(model, spec, dev, work, exported)
    os.remove(exported)
    strip_lora(model)  # the DPO adapters out: phase 8a trains the expert again
    log("the sharded trainer (8a): the 3-ref HSDP recipe folded to one rank, unsharded then "
        "FSDP2 over a one-rank NCCL mesh:")
    sharded = sharded_training_check(model, spec, dev, work, batch0)
    del model, spec, batch0
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_bwd"], seconds, dpo, opt8, sharded


# the released 3-ref HSDP recipe (data 4 x fsdp 2); phase 8a reads its
# arguments through the port's parser with the degrees folded to one rank
THREE_REF_RECIPE = "examples/training/sft/cogvideox/vap_mot/train_single_node_3ref.sh"
# the grad norms' tolerance, relative: the sharded norm is sqrt of the sum
# of squares all-reduced over the shard groups, the unsharded one the norm
# of the per-tensor norms, which round apart in the last float32 bits
SHARDED_NORM_RTOL = 1e-6


# FSDP2 passes each unit's inputs through an autograd node of its own, so the
# two terms a MoT block gives the reference time embedding's bf16 gradient
# are summed in that node before the 41 blocks' sums reach the embedding
# (without FSDP2 all 82 terms are summed there, one by one): the sums round
# apart by a few bf16 ulps. Phase 8a takes both steps with that one sum in
# float64 (``ref_embedding_summed_in_f64``): each block's two terms still
# meet in bf16 (a + b, one rounding whichever comes first), and a float64
# sum of 41 bf16 values is exact unless an element's terms span more than
# 38 binades, so the embedding's gradient, and with it every gradient, must
# be the same to the bit on both paths; the loss and every updated tensor
# of the expert are held so
@contextlib.contextmanager
def ref_embedding_summed_in_f64():
    """CogVideoX's MoT blocks given the reference time embedding through a
    float64 copy of it (one a forward; each block reads its bf16 cast), so
    that autograd sums the blocks' gradients in float64 and casts the sum
    to bf16 once; yields the list of the blocks whose gradient reached it
    (one entry a block)."""
    from vap_tpu_torch.models.cogvideox import transformer_mot

    plain = transformer_mot.run_block
    held, terms = [None, None], []

    def run_block(block, remat, *args):
        emb_ref = args[6]  # (hs, ehs, emb, rope, hs_ref, ehs_ref, emb_ref, ...)
        if emb_ref is not None and block.with_mot:
            if held[0] is not emb_ref:
                held[:] = [emb_ref, emb_ref.double()]
            cast = held[1].to(emb_ref.dtype)
            cast.register_hook(lambda g, block=block: terms.append(block))
            args = args[:6] + (cast,) + args[7:]
        return plain(block, remat, *args)

    transformer_mot.run_block = run_block
    try:
        yield terms
    finally:
        transformer_mot.run_block = plain
        held[:] = [None, None]


def recipe_argv(path, **flags):
    """The ``python train.py`` arguments of a launch script, ``flags``
    replacing or adding values (``--name value``)."""
    import shlex

    with open(path) as f:
        text = f.read()
    argv = shlex.split(text.split("python train.py", 1)[1].replace("\\\n", " ").split("\n\n")[0])
    for name, value in flags.items():
        key = f"--{name}"
        if key in argv:
            argv[argv.index(key) + 1] = str(value)
        else:
            argv += [key, str(value)]
    return argv


def sharded_training_check(model, spec, dev, work, batch):
    """Phase 8a: one step of the 3-ref recipe unsharded, then sharded over
    a one-rank NCCL mesh from the same weights and draws (see the module's
    docstring). The model stays sharded: the caller drops it."""
    import gc

    import numpy as np
    import torch

    from vap_tpu_torch.parallel.sharding import is_sharded
    from vap_tpu_torch.train import _parser
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.train_step import draw_step_noise
    from vap_tpu_torch.training.trainer import SFTTrainer, step_generator

    argv = recipe_argv(os.path.join(HERE, THREE_REF_RECIPE), data_degree=1, fsdp_degree=1,
                       data_root=os.path.join(work, "data"),
                       output_dir=os.path.join(work, "sharded"), lr_warmup_steps=0,
                       resume_from_checkpoint="", pretrained_model_name_or_path="")
    ns = vars(_parser().parse_args(argv))
    ns.pop("device"), ns.pop("model_config")
    args = TrainingArgs(**ns)
    layers = model.config.num_layers
    mot = len(model.config.block_idx_with_mot_ref)
    want = {"flash_fwd": 2 * layers, "flash_bwd": layers}  # forward and recompute; backward
    for module in spec.encoders().values():  # T5 and the VAE wait in host memory
        module.to("cpu")
    torch.cuda.empty_cache()
    draws = {}  # step 1's draws, once the trainer's step config exists

    def step(trainer):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        with trainer._attn_ctx(), ref_embedding_summed_in_f64() as terms:
            loss = trainer._grad(model, batch, None, None, **draws)["loss"].detach().clone()
        norm = trainer._apply(1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        check_launches(launches, want)
        if len(terms) != mot:
            raise AssertionError(f"{len(terms)} blocks' gradients reached the reference time "
                                 f"embedding, not {mot}")
        return loss, norm, wall, torch.cuda.max_memory_allocated(dev), launches

    trainer = SFTTrainer(args, model, spec)
    draws.update(draw_step_noise(trainer.step_cfg, batch["latents"].shape,
                                 step_generator(args.seed, 1, dev), dev))
    names = trainer.trainable_names
    params = dict(model.named_parameters())
    start = {n: params[n].detach().to("cpu", copy=True) for n in names}
    loss, norm, wall, peak, launches = step(trainer)
    updated = {n: params[n].detach().clone() for n in names}
    with torch.no_grad():
        for n in names:
            params[n].copy_(start[n])
    trainer.optimizer.inner.state.clear()
    for p in model.parameters():
        p.grad = None
    del trainer, start, params
    gc.collect()
    torch.cuda.empty_cache()
    with one_rank_nccl_group(dev):
        t0 = time.perf_counter()
        trainer = SFTTrainer(args, model, spec, shard=True)
        build = time.perf_counter() - t0
        sharded = sum(is_sharded(p) for p in model.parameters())
        s_loss, s_norm, s_wall, s_peak, s_launches = step(trainer)
        t0 = time.perf_counter()
        state = trainer.trainable_state_dict()
        gather = time.perf_counter() - t0
        differ = [n for n in names if not torch.equal(state[n], updated[n].cpu())]
        del state
    norm_gap = abs(s_norm.item() - norm.item()) / norm.item()
    log(f"  the 3-ref recipe ({THREE_REF_RECIPE}, degrees folded to 1 x 1; sample_ref_videos_num "
        f"{args.sample_ref_videos_num}, optimizer {args.optimizer}, lr {args.lr}) on phase 8's "
        f"first item (one reference: three at full width do not fit one card beside the "
        f"unsharded state), {len(names)} trained tensors, the reference time embedding's "
        f"gradient summed over the {mot} MoT blocks in float64 on both paths:")
    log(f"  unsharded: loss {loss.item():.6f}, grad_norm {norm.item():.6f}, {wall:.3f} s, peak "
        f"{peak / 2**30:.2f} GiB; K1 {launches['flash_fwd']}, K5 {launches['flash_bwd']}")
    log(f"  sharded (FSDP2 over a one-rank NCCL (data, fsdp) mesh, {sharded} of "
        f"{len(list(model.parameters()))} parameters DTensors, built in {build:.2f} s): loss "
        f"{s_loss.item():.6f}, bit-equal {torch.equal(s_loss, loss)}; grad_norm "
        f"{s_norm.item():.6f}, relative difference {norm_gap:.3e} (tol {SHARDED_NORM_RTOL}); "
        f"{s_wall:.3f} s, peak {s_peak / 2**30:.2f} GiB; K1 {s_launches['flash_fwd']}, K5 "
        f"{s_launches['flash_bwd']}; the full-state gather in {gather:.2f} s: updated expert "
        f"tensors bit-equal to the unsharded step's {len(names) - len(differ)} of {len(names)}"
        f"{f' (not {differ[:5]})' if differ else ''}; {power_line()}")
    if not (torch.equal(s_loss, loss) and norm_gap <= SHARDED_NORM_RTOL and not differ
            and sharded == len(list(model.parameters())) and np.isfinite(loss.item())):
        raise AssertionError("the sharded step differs from the unsharded one")
    del trainer, updated
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss.item(), "grad_norm": [norm.item(), s_norm.item()],
            "seconds": [wall, s_wall], "peak_gib": [peak / 2**30, s_peak / 2**30],
            "k1": s_launches["flash_fwd"],
            "k5": s_launches["flash_bwd"]}


# the released DPO recipe (vap_mot/train_single_node_dpo.sh); its
# --target_modules regex is passed, and ignored as JAX's DPO ignores it
DPO_RECIPE = dict(dpo=True, rank=32, lora_alpha=32, lr=5e-5, lr_scheduler="constant",
                  target_modules="(transformer_blocks|single_transformer_blocks).*"
                                 "(to_q|to_k|to_v|to_out.0)",
                  sample_ref_videos_num=1, mask_ref_ratio=0.0, mask_caption_ratio=0.02)
DPO_SCORES = (100, 95, 5)  # one kind: a stage-1 pair (>= 90, <= 10) and a reference


def write_dpo_csv(root, names, name="dpo.csv"):
    """A DPO table over the clips ``names`` in ``root``: one kind, the
    scores of DPO_SCORES, each row's reference the next clip."""
    import csv

    rows = [{"video_paths": n, "tar_video_caption": f"The video shows effect {i} on a scene",
             "ref_video_paths": json.dumps([names[(i + 1) % len(names)]]), "kind": "fx",
             "split": "train", "reference_alignment_score": score}
            for i, (n, score) in enumerate(zip(names, DPO_SCORES))]
    with open(os.path.join(root, name), "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return name


def dpo_path(model, spec, dev, work, start):
    """Phase 8's DPO step: the released recipe (DPO_RECIPE) on phase 8's
    CogVideoX-5B VAP model, T5-XXL and VAE, one full step on a win / lose
    pair of its clips (the lose video encoded in the win video's bucket):
    the reference pass with the adapters bypassed, the policy's forward and
    backward at batch 2, the update. At step 1 B = 0, so the policy is the
    reference: their per-sample losses must be equal to the bit and the loss
    ln 2 mean(dpo_weight); the A gradients zero, the B gradients finite and
    not all zero; every frozen weight bit-identical after the update to the
    weights it started from (``start``: phase 8's export, read back); K1
    3 x 42 (reference, forward, recompute) and K5 42 launches, all at
    batch 2. Returns what it measured."""
    import gc
    import math

    import torch

    from vap_tpu_torch.training.checkpoint import load_safetensors
    from vap_tpu_torch.training.trainer import SFTTrainer

    root = os.path.join(work, "data")
    meta = write_dpo_csv(root, [f"clip_{i}.mp4" for i in range(len(TRAIN_CLIPS))])
    args = recipe_args(root, os.path.join(work, "dpo"), 1, dataset_config=None,
                       validation_dataset_file=None, meta_df_name=meta, **DPO_RECIPE)
    layers = model.config.num_layers
    t0 = time.perf_counter()
    trainer = SFTTrainer(args, model, spec, track_stage_peaks=True)
    lora = trainer.lora
    n_lora = sum(t.numel() for ab in lora.values() for t in ab.values())
    log(f"  DPO: rank {args.rank}, alpha {args.lora_alpha}, {len(lora)} adapted projections "
        f"(the MoT expert's six of {len(model.config.block_idx_with_mot_ref)} blocks), "
        f"{n_lora} adapter parameters, installed in {time.perf_counter() - t0:.2f} s")
    grads = {}
    apply = trainer._apply

    def largest(t):  # max|grad|; a tensor the backward never reached has none
        return t.new_zeros(()) if t.grad is None else t.grad.abs().max()

    def kept_apply(scale):  # the adapters' gradients, read before the update
        a = torch.stack([largest(ab["A"]) for ab in lora.values()])
        b = torch.stack([largest(ab["B"]) for ab in lora.values()])
        finite = torch.stack([torch.isfinite(b)])
        grads.update(a_max=a.max().item(), b_max=b.max().item(), b_finite=bool(finite.all()),
                     b_live={n for n, x in zip(lora, b.tolist()) if x > 0})
        return apply(scale)

    trainer._apply = kept_apply
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with KeptAttention(keep=False) as seen:  # the batch of every attention call
        trainer.run()
    wall = time.perf_counter() - t0
    launches = read_counts()
    r, m = trainer.history[0], trainer.last_metrics
    same = torch.equal(m["policy_losses"], m["ref_losses"])
    weight = m["dpo_weight"].item()
    want_loss = math.log(2) * weight
    loss_err = abs(r["loss"] - want_loss)
    peak = trainer.stage_peaks.get("timing/train_step", 0)
    step = r["reference_s"] + r["forward_s"] + r["backward_s"] + r["update_s"]
    spans = {k: round(v, 3) for k, v in trainer.tracker.history[0].items()
             if k.startswith("timing/")}
    log(f"  DPO step 1 in {wall:.3f} s (encodes included): {step:.3f} s = reference "
        f"{r['reference_s']:.3f} + forward {r['forward_s']:.3f} + backward "
        f"{r['backward_s']:.3f} + update {r['update_s']:.3f}; spans {spans}; peak card memory "
        f"{peak / 2**30:.2f} GiB in the step, by span "
        f"{ {k: round(v / 2**30, 2) for k, v in trainer.stage_peaks.items()} } GiB")
    log(f"  per-sample losses: policy {m['policy_losses'].tolist()}, reference "
        f"{m['ref_losses'].tolist()}, bit-equal {same}; loss {r['loss']!r} against ln 2 x "
        f"dpo_weight {weight!r} = {want_loss!r} (|diff| {loss_err:.3e}); model_diff "
        f"{r['model_diff']!r}, ref_diff {r['ref_diff']!r}, grad_norm {r['grad_norm']!r}")
    # the last MoT block's reference queries, output projection and
    # feed-forward feed only the reference stream, which no loss reads: their
    # B gradients are zero, every other one is not
    last = max(model.config.block_idx_with_mot_ref)
    dead = {n for n in lora if n.startswith(tuple(
        f"transformer_blocks.{last}.{m}" for m in ("attn1_mot_ref.to_q", "attn1_mot_ref.to_out",
                                                   "ff_mot_ref")))}
    live = set(lora) - dead
    log(f"  adapter gradients: max|grad A| {grads.get('a_max')}, max|grad B| "
        f"{grads.get('b_max')}, B non-zero in {len(grads.get('b_live', ()))} of {len(lora)} (the "
        f"{len(live)} that reach the loss), finite {grads.get('b_finite')}; launches K1 {launches['flash_fwd']} (expected {3 * layers}: "
        f"reference, forward and recompute), K5 {launches['flash_bwd']} (expected {layers}); "
        f"attention batch sizes {sorted({q[0] for q, _, _ in seen.shapes})}")
    check_launches(launches, {"flash_fwd": 3 * layers, "flash_bwd": layers})
    t0 = time.perf_counter()
    before = load_safetensors(start)
    params = {n: p for n, p in model.named_parameters() if n in before}
    if len(params) + 2 * len(lora) != len(list(model.parameters())):
        raise AssertionError("DPO: the model's frozen weights are not the export's")
    changed = [n for n, p in params.items() if not torch.equal(p, before[n].to(p.device))]
    moved = {n for n, ab in lora.items() if ab["B"].detach().any()}
    log(f"  frozen tensors changed by the update: {len(changed)} of {len(before)} (compared in "
        f"{time.perf_counter() - t0:.2f} s, against phase 8's export read back); adapters "
        f"whose B moved off 0: {len(moved)} of "
        f"{len(lora)} (those that reach the loss: {moved == live})")
    if not (same and loss_err <= 4 * 2**-24 * max(want_loss, 1.0) and grads
            and grads["a_max"] == 0.0 and grads["b_finite"] and grads["b_live"] == live
            and not changed and moved == live and {q[0] for q, _, _ in seen.shapes} == {2}):
        raise AssertionError(f"DPO step: policy == reference {same}, loss error {loss_err}, "
                             f"gradients {grads}, frozen tensors changed {changed[:5]}, "
                             f"adapters moved {moved}, shapes {set(seen.shapes)}")
    del before, params, trainer, lora
    gc.collect()
    return {"step_s": step, "reference_s": r["reference_s"], "forward_s": r["forward_s"],
            "backward_s": r["backward_s"], "update_s": r["update_s"], "peak_gib": peak / 2**30,
            "k1": launches["flash_fwd"], "k5": launches["flash_bwd"]}


def adam8bit_check(trainer, batch, dev):
    """Phase 8's expert under ``--optimizer adamw-8bit`` (the AdamW state
    freed first): the trainer builds its step again (``_build_step``: the
    optimizer of ``args.optimizer`` over JAX's leaves, and its grad / apply
    pair), then one update on ``batch`` with the draws of step 1's
    generator, and the loss of the step after (a forward on the same batch
    and draws); the state's bytes per trained parameter, the update's
    seconds and the peak (the encoders resident, as in the run)."""
    import numpy as np
    import torch

    from vap_tpu_torch.training.optim8bit import Adam8bit
    from vap_tpu_torch.training.train_step import cogvideox_vap_loss, draw_step_noise
    from vap_tpu_torch.training.trainer import step_generator

    args, model = trainer.args, trainer.model
    trainer.optimizer.inner.state.clear()
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    args.optimizer = "adamw-8bit"
    trainer._build_step()
    opt, grad_fn, apply_fn = trainer.optimizer, trainer._grad, trainer._apply
    if not isinstance(opt.inner, Adam8bit):
        raise AssertionError(f"--optimizer adamw-8bit built {type(opt.inner).__name__}")
    draws = draw_step_noise(trainer.step_cfg, batch["latents"].shape,
                            step_generator(args.seed, 1, dev), dev)
    n = sum(p.numel() for p in opt.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with trainer._attn_ctx():
        losses = [grad_fn(model, batch, None, None, **draws)["loss"].item()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    norm = apply_fn().item()
    torch.cuda.synchronize()
    updates = [time.perf_counter() - t0]
    peak = torch.cuda.max_memory_allocated(dev)
    with trainer._attn_ctx(), torch.no_grad():
        losses.append(cogvideox_vap_loss(model, trainer.step_cfg, batch, **draws)[0].item())
    state = opt.state_bytes()
    log(f"  adamw-8bit on the expert ({n} parameters, {len(opt.inner.leaves)} JAX leaves): "
        f"state {state} bytes = "
        f"{state / n:.4f} a parameter (AdamW's two moments in bf16: 4), update "
        f"{updates[0]:.3f} s, peak {peak / 2**30:.2f} GiB (AdamW: 57.06 resident, "
        f"66.34 from clips, on an H100 80GB HBM3), loss {losses[0]:.6f}, the step after {losses[1]:.6f}, "
        f"grad_norm {norm:.6f}")
    if not (np.isfinite(losses).all() and opt.count == 1 and losses[1] != losses[0]):
        raise AssertionError(f"adamw-8bit: losses {losses}, {opt.count} updates")
    opt.inner.state.clear()
    del opt
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    return {"state_bytes_per_param": state / n, "update_s": updates, "peak_gib": peak / 2**30,
            "loss": losses}


def k5_batch2_parity(dev):
    """K1 and K5 at batch 2, [2, 48, 35552, 64] (the DPO step's shape), on
    random inputs: each held against its plain version on heads 0 and 47 of
    both batch rows, under phase 3's and phase 7's limits; a dout whose two rows
    are swapped must fail K5's limit in row 1. Returns K5's max|err|."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    shape = (2,) + MAIN_SHAPE[1:]
    q, k, v, dout = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(4)]
    heads = [slice(0, 1), slice(shape[1] - 1, shape[1])]
    held_on_heads("flash_fwd (K1) at batch 2", q, k, v, None, heads)
    out, lse = fa.flash_attention_forward(q, k, v)
    t0 = time.perf_counter()
    got = fa.flash_attention_backward(q, k, v, out, lse, dout)
    swapped = fa.flash_attention_backward(q, k, v, out, lse, dout.flip(0).contiguous())
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    worst, fault = 0.0, {}
    rows = []
    for hs in heads:
        ref = fa.flash_attention_backward_plain(q[:, hs], k[:, hs], v[:, hs], out[:, hs],
                                                lse[:, hs], dout[:, hs])
        for b in range(2):
            for name, g, sw, r in zip("qkv", got, swapped, ref):
                ref_max = r[b].float().abs().max().item()
                err = (g[b, hs].float() - r[b].float()).abs().max().item()
                rows.append((hs.start, b, name, err, ref_max))
                worst = max(worst, err)
                if b == 1:
                    fault[(hs.start, name)] = (
                        (sw[b, hs].float() - r[b].float()).abs().max().item() / ref_max)
        del ref
    ok = finite and all(e <= GRAD_REL_TOL * m for *_, e, m in rows)
    caught = all(f > GRAD_REL_TOL for f in fault.values())
    log(f"  flash_bwd (K5) at batch 2 {shape} x {shape[2]}, held on heads "
        f"{[(h.start, h.stop) for h in heads]} of both rows ({time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"h{h} row {b} d{n} {e / m:.3e}" for h, b, n, e, m in rows)
        + f" (max|err| / max|ref|, tol {GRAD_REL_TOL}); finite {finite}; dout rows swapped, "
        f"row 1: {min(fault.values()):.3e} at least (must exceed the tol)")
    if not ok:
        raise AssertionError("K5 at batch 2 disagrees with its plain version")
    if not caught:
        raise AssertionError("K5 at batch 2: the limit does not catch dout rows swapped")
    del q, k, v, dout, out, lse, got, swapped
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phase 8b: the data path at tiny widths (precompute, Wan, HunyuanVideo)
# ---------------------------------------------------------------------------

SMALL_CLIPS = ((9, 40, 40, 16), (9, 24, 48, 16), (14, 32, 32, 24))  # 14 at 24 fps: 9 at 16


def small_cog_trainer(dev, root, out, cfg_kw=None, frames=9, steps=3, **kw):
    """A tiny CogVideoX VAP (head_dim 64, so K1 and K5 run; ``cfg_kw``
    overrides its fields) with a tiny T5 and VAE on the card, random from
    the seed; the recipe's trainer on ``root`` at ``frames``x32x32 for
    ``steps`` steps with ``kw``."""
    import torch

    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.training.specs import CogVideoXSpec
    from vap_tpu_torch.training.trainer import SFTTrainer

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    cfg = CogVideoXMOTConfig.tiny(**{**dict(in_channels=8, out_channels=4, num_layers=3,
                                            attention_head_dim=64,
                                            block_idx_with_mot_ref=(0, 1)), **(cfg_kw or {})})
    model = build_random(CogVideoXTransformer3DMOTModel, cfg, dev, bf16, gen)
    spec = CogVideoXSpec(model, FakeTokenizer(128), dtype=bf16, device=dev,
                         vae=build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig.tiny(), dev,
                                          bf16, gen),
                         text_encoder=build_random(T5EncoderModel,
                                                   T5Config.tiny(d_model=cfg.text_embed_dim),
                                                   dev, bf16, gen))
    args = recipe_args(root, out, steps, video_resolution_buckets=((frames, 32, 32),), lr=1e-3,
                       **kw)
    return SFTTrainer(args, model, spec)


def data_small_check(dev):
    """Phase 8b. CogVideoX online against enable_precomputation (the encode
    pass into a cache, the encoders to host memory, back for each
    validation): losses bit-equal, a validation every step in the second;
    then Wan VAP and the HunyuanVideo LoRA, one step from clips and one
    validation sample each, with K4 / K6 and K7's launches."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
    from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
    from vap_tpu_torch.models.hunyuan_video.vae import (AutoencoderKLHunyuanVideo,
                                                        HunyuanVideoVAEConfig)
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.llama import LlamaConfig, LlamaModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.pipelines.hunyuan_video import CROP_START, DEFAULT_PROMPT_TEMPLATE_PREFIX
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.specs import HunyuanVideoSpec, WanSpec
    from vap_tpu_torch.training.trainer import SFTTrainer

    work = os.path.join(HERE, "build", "chip_smoke_data_small")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "data")
    bf16 = torch.bfloat16
    t_start = time.perf_counter()
    write_training_data(root, clips=SMALL_CLIPS, steps=2, size=(9, 32, 32))

    # CogVideoX: online, then the precompute pass and its replay
    reset_counts()
    online = small_cog_trainer(dev, root, os.path.join(work, "online"))
    online.run()
    on_launches = read_counts()
    reset_counts()
    pre = small_cog_trainer(dev, root, os.path.join(work, "pre"), validation_steps=1,
                            enable_precomputation=True,
                            precomputation_dir=os.path.join(work, "cache"),
                            precomputation_once=True)
    pre.run()
    pre_launches = read_counts()
    losses = [r["loss"] for r in online.history], [r["loss"] for r in pre.history]
    where = {p.device.type for m in pre.spec.encoders().values() for p in m.parameters()}
    videos = sorted(os.listdir(os.path.join(work, "pre", "validation")))
    log(f"  CogVideoX (head_dim 64) online losses {losses[0]}, under enable_precomputation "
        f"{losses[1]}: bit-equal {losses[0] == losses[1]}; the encoders after the run on {where}; "
        f"validations {videos}; launches online {on_launches['flash_fwd']} K1 / "
        f"{on_launches['flash_bwd']} K5, precomputed {pre_launches['flash_fwd']} / "
        f"{pre_launches['flash_bwd']}")
    layers = online.model.config.num_layers
    check_launches(on_launches, {"flash_fwd": 2 * layers * 3 + layers * 2,
                                 "flash_bwd": layers * 3})
    check_launches(pre_launches, {"flash_fwd": 2 * layers * 3 + layers * 2 * 3,
                                  "flash_bwd": layers * 3})
    if not (losses[0] == losses[1] and all(np.isfinite(losses[0])) and where == {"cpu"}
            and videos == ["000001", "000002", "000003"]):
        raise AssertionError("the precompute mode differs from the online run")
    del online, pre

    # Wan VAP (head_dim 128): one step from the clips, one validation sample
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    w_cfg = WanMOTConfig.tiny(attention_head_dim=128, in_channels=12, out_channels=4,
                              text_dim=32, image_dim=24, added_kv_proj_dim=256, ffn_dim=512)
    model = build_random(WanTransformer3DMOTModel, w_cfg, dev, bf16, gen)
    spec = WanSpec(model, FakeTokenizer(128), dtype=bf16, device=dev,
                   vae=build_random(AutoencoderKLWan, WanVAEConfig.tiny(), dev, bf16, gen),
                   text_encoder=build_random(T5EncoderModel,
                                             T5Config.tiny(per_layer_relative_bias=True), dev,
                                             bf16, gen),
                   image_encoder=build_random(CLIPVisionModel, CLIPVisionConfig.tiny(), dev, bf16,
                                              gen))
    args = recipe_args(root, os.path.join(work, "wan"), 1, model_name="wan",
                       video_resolution_buckets=((9, 32, 32),), lr=1e-3)
    reset_counts()
    trainer = SFTTrainer(args, model, spec)
    trainer.run()
    launches = read_counts()
    # per MoT block: the joint attention and four cross-attentions, forward
    # and recompute in the step, at CFG batch 2 in each of the validation's 2
    # steps; backward for all but the last block's two reference
    # cross-attentions, which feed no loss
    per = w_cfg.num_layers * 5
    log(f"  Wan VAP (head_dim 128): loss {trainer.history[0]['loss']:.6f}, validation "
        f"{sorted(os.listdir(os.path.join(work, 'wan', 'validation')))}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check_launches(launches, {"flash_fwd_d128": 2 * per + 2 * per, "flash_bwd_d128": per - 2})
    if not np.isfinite(trainer.history[0]["loss"]):
        raise AssertionError("Wan VAP from clips: the loss is not finite")
    del trainer, model, spec

    # the HunyuanVideo LoRA (head_dim 128, the text mask padded: K7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    vae_cfg = HunyuanVideoVAEConfig.tiny()
    h_cfg = HunyuanVideoConfig.tiny(attention_head_dim=128, in_channels=vae_cfg.latent_channels,
                                    out_channels=vae_cfg.latent_channels, text_embed_dim=32,
                                    rope_axes_dim=(32, 48, 48))
    clip_cfg = CLIPTextConfig.tiny(hidden_size=h_cfg.pooled_projection_dim)
    model = build_random(HunyuanVideoTransformer3DModel, h_cfg, dev, bf16, gen)
    spec = HunyuanVideoSpec(
        model, FakeTokenizer(64, prefix=DEFAULT_PROMPT_TEMPLATE_PREFIX, prefix_tokens=CROP_START),
        FakeTokenizer(clip_cfg.vocab_size, eos=clip_cfg.eos_token_id), dtype=bf16, device=dev,
        vae=build_random(AutoencoderKLHunyuanVideo, vae_cfg, dev, bf16, gen),
        text_encoder=build_random(LlamaModel, LlamaConfig.tiny(hidden_size=h_cfg.text_embed_dim),
                                  dev, bf16, gen),
        text_encoder_2=build_random(CLIPTextModel, clip_cfg, dev, bf16, gen))
    pairs = os.path.join(work, "pairs")
    os.makedirs(pairs)
    from vap_tpu_torch.data.video import export_to_video

    for i in range(2):
        export_to_video(seeded_clip(SEED + 30 + i, 9, 32, 32), os.path.join(pairs, f"c{i}.mp4"))
        with open(os.path.join(pairs, f"c{i}.txt"), "w") as fh:
            fh.write(f"The video shows a vase dissolving, take {i}")
    val = os.path.join(work, "hunyuan_validation.json")
    with open(val, "w") as fh:
        json.dump({"num_samples": 1, "data": [{"caption": "MODAL_DISSOLVE a vase", "height": 32,
                                                "width": 32, "num_frames": 9,
                                                "num_inference_steps": 2}]}, fh)
    args = TrainingArgs(model_name="hunyuan_video", training_type="lora", rank=4, lora_alpha=4,
                        target_modules="to_q to_k to_v to_out", data_root=pairs,
                        id_token="MODAL_DISSOLVE", remove_common_llm_caption_prefixes=True,
                        output_dir=os.path.join(work, "hunyuan"),
                        video_resolution_buckets=((9, 32, 32),), lr=1e-3, lr_scheduler="constant",
                        flow_weighting_scheme="logit_normal", gradient_checkpointing=True,
                        checkpointing_steps=NEVER, seed=SEED, train_steps=1, validation_steps=1,
                        validation_dataset_file=val, logging_steps=1)
    reset_counts()
    trainer = SFTTrainer(args, model, spec)
    trainer.run()
    launches = read_counts()
    per = h_cfg.num_layers + h_cfg.num_single_layers  # one joint attention a block
    log(f"  HunyuanVideo LoRA (head_dim 128): loss {trainer.history[0]['loss']:.6f}, validation "
        f"{sorted(os.listdir(os.path.join(work, 'hunyuan', 'validation')))}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check_launches(launches, {"flash_fwd_d128_varlen": 2 * per + 2 * per,
                              "flash_bwd_d128_varlen": per})
    if not np.isfinite(trainer.history[0]["loss"]):
        raise AssertionError("the Hunyuan LoRA from clips: the loss is not finite")
    del trainer, model, spec
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  phase 8b in {time.perf_counter() - t_start:.1f} s")


# the rest of phase 8b: the training objectives at tiny widths. Each case:
# (the tiny CogVideoX's config fields, the trainer's flags, its data
# directory, buckets); one step each under gradient checkpointing
SMALL_OBJECTIVES = {
    "ablation_single_branch (full)": (dict(block_idx_with_mot_ref=()), dict(
        ablation_single_branch=True, target_modules="none"), "vap", 9),
    "ablation_single_branch (LoRA)": (dict(block_idx_with_mot_ref=()), dict(
        ablation_single_branch=True, rank=4, lora_alpha=4,
        target_modules="(transformer_blocks).*(to_q|to_k|to_v|to_out.0)"), "vap", 9),
    "baseline_single_condition": (dict(block_idx_with_mot_ref=()), dict(
        ablation_single_branch=True, target_modules="none", baseline_single_condition="fx"),
        "vap", 9),
    "plain LoRA (config_plain.json)": (dict(block_idx_with_mot_ref=()), dict(
        training_type="lora", rank=4, lora_alpha=4, target_modules="to_q to_k to_v to_out"),
        "plain", 9),
    "reference_independent": (dict(reference_train_mode="reference_independent"), dict(
        reference_train_mode="reference_independent"), "vap", 9),
    "reference_independent + random_refer_noise": (
        dict(reference_train_mode="reference_independent"),
        dict(reference_train_mode="reference_independent", random_refer_noise=True), "vap", 9),
    # 13 frames: 4 latent frames, which patch_size_t = 2 divides
    "CogVideoX 1.5 (patch_size_t 2)": (dict(patch_size_t=2), {}, "vap13", 13),
}


def objectives_small_check(dev):
    """Phase 8b's training objectives: the single-branch ablation (full and
    LoRA), baseline_single_condition, the plain CogVideoX LoRA,
    reference_independent with and without random_refer_noise and
    CogVideoX 1.5 at tiny width from clips, one step each with their K1 / K5
    launches; DPO from a checkpoint after one step equal to two steps
    uninterrupted; Wan DPO (head_dim 128: K4 and K6)."""
    import numpy as np
    import torch

    from vap_tpu_torch.data.video import export_to_video
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.training.specs import WanSpec
    from vap_tpu_torch.training.trainer import SFTTrainer

    work = os.path.join(HERE, "build", "chip_smoke_objectives")
    shutil.rmtree(work, ignore_errors=True)
    t_start = time.perf_counter()
    roots = {"vap": os.path.join(work, "vap"), "vap13": os.path.join(work, "vap13"),
             "plain": os.path.join(work, "plain")}
    write_training_data(roots["vap"], clips=SMALL_CLIPS, steps=2, size=(9, 32, 32))
    names = [f"clip_{i}.mp4" for i in range(len(SMALL_CLIPS))]
    dpo_csv = write_dpo_csv(roots["vap"], names)
    write_training_data(roots["vap13"], clips=((13, 32, 32, 16), (13, 40, 40, 16)), steps=2,
                        size=(13, 32, 32))
    os.makedirs(roots["plain"])
    for i in range(2):
        export_to_video(seeded_clip(SEED + 40 + i, 9, 32, 32),
                        os.path.join(roots["plain"], f"c{i}.mp4"))
        with open(os.path.join(roots["plain"], f"c{i}.txt"), "w") as fh:
            fh.write(f"a vase dissolving, take {i}")

    plain = dict(dataset_config=None, validation_dataset_file=None)  # vap_data.csv, no validation
    for name, (cfg_kw, kw, data, frames) in SMALL_OBJECTIVES.items():
        trainer = small_cog_trainer(dev, roots[data], os.path.join(work, "out"), cfg_kw, frames,
                                    steps=1, **plain, **kw)
        reset_counts()
        trainer.run()
        launches = read_counts()
        layers = trainer.model.config.num_layers
        loss = trainer.history[0]["loss"]
        what = ("adapters" if trainer.lora_mode else "of the MoT expert"
                if trainer.model.config.block_idx_with_mot_ref else "of the whole model")
        log(f"  {name}: loss {loss:.6f}, {len(trainer.trainable_names)} tensors {what} train; "
            f"launches K1 {launches['flash_fwd']} / K5 {launches['flash_bwd']}")
        check_launches(launches, {"flash_fwd": 2 * layers, "flash_bwd": layers})
        if not np.isfinite(loss):
            raise AssertionError(f"{name}: the loss is not finite")
        del trainer
        shutil.rmtree(os.path.join(work, "out"), ignore_errors=True)

    # DPO: two steps, then one step + a checkpoint + one resumed step
    dpo_kw = dict(dpo=True, rank=4, lora_alpha=4, meta_df_name=dpo_csv)
    runs = []
    for i, (steps, ckpt, resume) in enumerate(((2, NEVER, None), (1, 1, None),
                                               (2, 1, "latest"))):
        out = os.path.join(work, "dpo_whole" if i == 0 else "dpo_resumed")
        trainer = small_cog_trainer(dev, roots["vap"], out, steps=steps, checkpointing_steps=ckpt,
                                    resume_from_checkpoint=resume, **plain, **dpo_kw)
        reset_counts()
        trainer.run()
        launches = read_counts()
        layers = trainer.model.config.num_layers
        ran = len(trainer.history)
        check_launches(launches, {"flash_fwd": 3 * layers * ran, "flash_bwd": layers * ran})
        runs.append([r["loss"] for r in trainer.history])
        del trainer
    log(f"  DPO (head_dim 64): two steps {runs[0]}, one step, a checkpoint and one resumed "
        f"step {runs[1] + runs[2]}: equal {runs[0] == runs[1] + runs[2]}; K1 3 x 3 and K5 3 "
        f"a step")
    if runs[0] != runs[1] + runs[2] or not np.isfinite(runs[0]).all():
        raise AssertionError("DPO resumed from a checkpoint differs from the uninterrupted run")

    # Wan DPO (head_dim 128)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    w_cfg = WanMOTConfig.tiny(attention_head_dim=128, in_channels=12, out_channels=4,
                              text_dim=32, image_dim=24, added_kv_proj_dim=256, ffn_dim=512)
    model = build_random(WanTransformer3DMOTModel, w_cfg, dev, bf16, gen)
    spec = WanSpec(model, FakeTokenizer(128), dtype=bf16, device=dev,
                   vae=build_random(AutoencoderKLWan, WanVAEConfig.tiny(), dev, bf16, gen),
                   text_encoder=build_random(T5EncoderModel,
                                             T5Config.tiny(per_layer_relative_bias=True), dev,
                                             bf16, gen),
                   image_encoder=build_random(CLIPVisionModel, CLIPVisionConfig.tiny(), dev, bf16,
                                              gen))
    args = recipe_args(roots["vap"], os.path.join(work, "wan_dpo"), 1, model_name="wan",
                       video_resolution_buckets=((9, 32, 32),), lr=1e-3, dataset_config=None,
                       validation_dataset_file=None, flow_weighting_scheme="logit_normal",
                       **dpo_kw)
    trainer = SFTTrainer(args, model, spec)
    reset_counts()
    trainer.run()
    launches = read_counts()
    per = w_cfg.num_layers * 5  # the joint attention and four cross-attentions a block
    r = trainer.history[0]
    log(f"  Wan DPO (head_dim 128): loss {r['loss']:.6f}, model_diff {r['model_diff']!r}, "
        f"ref_diff {r['ref_diff']!r}; launches { {k: v for k, v in launches.items() if v} }")
    check_launches(launches, {"flash_fwd_d128": 3 * per, "flash_bwd_d128": per - 2})
    if not (np.isfinite(r["loss"]) and r["model_diff"] == r["ref_diff"]):
        raise AssertionError("Wan DPO: the first step's policy is not its reference")
    del trainer, model, spec
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  the objectives of phase 8b in {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# phase 9c: the Wan control recipe at full width
# (examples/training/control/wan/image_condition/train.sh)
# ---------------------------------------------------------------------------

CONTROL_RECIPE = dict(model_name="wan", training_type="control_lora", control_type="none",
                      frame_conditioning_type="index", frame_conditioning_index=0,
                      frame_conditioning_concatenate_mask=True, rank=64, lora_alpha=64,
                      train_qk_norm=True, flow_weighting_scheme="logit_normal", optimizer="adamw",
                      lr=3e-5, lr_scheduler="constant", lr_warmup_steps=0,
                      gradient_checkpointing=True)
CONTROL_CLIPS = 2  # clips with captions (the plain video layout), 49x480x832 at 16 fps
CONTROL_VAL_STEPS = 2  # the validation JSON's num_inference_steps (the recipe's: 30)
# K6 at the control path's self-attention: Wan2.1-T2V-1.3B, 12 heads of 128
CONTROL_ATTN = (1, 12, ((NUM_FRAMES - 1) // 4 + 1) * (WAN_HEIGHT // 16) * (WAN_WIDTH // 16), 128)
REMAT_MODES = ("ops", "block_skip:2")


def write_control_data(root):
    """The recipe's data: CONTROL_CLIPS clips with a caption file each, its
    training.json and a validation.json whose one entry's control video is
    one more clip at 49x480x832, sampled in CONTROL_VAL_STEPS steps."""
    from vap_tpu_torch.data.video import export_to_video

    os.makedirs(root, exist_ok=True)
    for i in range(CONTROL_CLIPS + 1):
        export_to_video(seeded_clip(SEED + 40 + i, NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH),
                        os.path.join(root, f"clip_{i}.mp4"), fps=16)
        if i < CONTROL_CLIPS:
            with open(os.path.join(root, f"clip_{i}.txt"), "w") as fh:
                fh.write(f"The video shows a ship sailing on a stormy sea, take {i}")
    with open(os.path.join(root, "training.json"), "w") as fh:
        json.dump({"datasets": [{"dataset_type": "video", "video_resolution_buckets":
                                 [[NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH]], "reshape_mode": "bicubic",
                                 "remove_common_llm_caption_prefixes": True}]}, fh)
    with open(os.path.join(root, "validation.json"), "w") as fh:
        json.dump({"data": [{"caption": "a ship sailing on a stormy sea",
                             "control_video": f"clip_{CONTROL_CLIPS}.mp4",
                             "num_inference_steps": CONTROL_VAL_STEPS}]}, fh)


def control_k6_parity(dev):
    """K6 against its plain version at the control path's self-attention,
    [1, 12, 20280, 128], with the planted fault (dout rows out of place in
    their q tiles); its time, the plain version's and SDPA's."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    b, h, s, d = CONTROL_ATTN
    q, k, v, dout = [torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(4)]
    out, lse = fa.flash_attention_forward(q, k, v)
    got = fa.flash_attention_backward(q, k, v, out, lse, dout)
    ref = fa.flash_attention_backward_rows_plain(q, k, v, out, lse, dout)
    n = s // Q_TILE * Q_TILE
    rolled = torch.cat([dout[:, :, :n].unflatten(2, (-1, Q_TILE)).roll(1, dims=3).flatten(2, 3),
                        dout[:, :, n:]], dim=2).contiguous()
    fault = fa.flash_attention_backward(q, k, v, out, lse, rolled)
    errs = [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
            for g, r in zip(got, ref)]
    faults = [(f.float() - r.float()).abs().max().item() for f, r in zip(fault, ref)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del got, fault, rolled
    ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), iters=3, warmup=1)
    plain_ms = time_ms(lambda: fa.flash_attention_backward_rows_plain(q, k, v, out, lse, dout),
                       iters=1, warmup=0)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(*leaves)
    library_ms = time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                         iters=3, warmup=1)
    bound_ms, bound_by = bwd_bound(b, h, s, s, d)
    log(f"  flash_bwd_d128 (K6) at the control path's {CONTROL_ATTN}: " + ", ".join(
        f"d{x} max|err| {e:.3e} / max|ref| {m:.3e} = {e / m:.3e} (planted fault {fe / m:.3e})"
        for x, (e, m), fe in zip("qkv", errs, faults)) + f" (tol {GRAD_REL_TOL}), finite "
        f"{finite}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA flash backward "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
    if not (finite and all(e <= GRAD_REL_TOL * m for e, m in errs)):
        raise AssertionError("K6 disagrees with its plain version at the control shape")
    if not all(fe > GRAD_REL_TOL * m for fe, (_, m) in zip(faults, errs)):
        raise AssertionError("K6 at the control shape: the limit does not catch dout rows out "
                             "of place")
    del q, k, v, out, lse, dout, ref, leaves, o
    torch.cuda.empty_cache()
    return {"shape": list(CONTROL_ATTN[:3]) + [s, d], "max_abs_err": max(e for e, _ in errs),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def build_control_trainer(dev, work, text_encoder, vae):
    """The recipe's ControlTrainer: Wan2.1-T2V-1.3B built by the entry point
    (``train.build_control_transformer``: random bf16 weights from SEED,
    widened to 33 input channels), UMT5 and the Wan VAE given (phase 6c's,
    read back), on the clips under ``work``/data, validating after step 2."""
    import torch

    from vap_tpu_torch.train import build_control_transformer
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.control_specs import WanControlSpec
    from vap_tpu_torch.training.control_trainer import ControlTrainer

    root = os.path.join(work, "data")
    write_control_data(root)
    args = TrainingArgs(data_root=root, dataset_config=os.path.join(root, "training.json"),
                        validation_dataset_file=os.path.join(root, "validation.json"),
                        validation_steps=TRAIN_STEPS,
                        video_resolution_buckets=((NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH),),
                        output_dir=os.path.join(work, "out"), seed=SEED, train_steps=TRAIN_STEPS,
                        checkpointing_steps=NEVER, logging_steps=1, **CONTROL_RECIPE)
    model = build_control_transformer(args, None, dev)  # bf16 on the card
    spec = WanControlSpec(model, FakeTokenizer(text_encoder.config.vocab_size),
                          dtype=next(model.parameters()).dtype, device=dev, vae=vae,
                          text_encoder=text_encoder)
    return ControlTrainer(args, model, spec, track_stage_peaks=True)


def remat_variants(trainer, batch, draws):
    """One step's loss and gradients under "full", each of REMAT_MODES and
    a planted fault ("full" with block 0's recompute fed half its input),
    from the same weights, batch and draws: the losses equal to the bit,
    each mode's gradients within GRAD_REL_TOL of max|full| per tensor (and
    whether they are equal to the bit), K4's and K6's launches, seconds and
    peak; the fault must fail the gradient check."""
    import dataclasses

    import torch

    from vap_tpu_torch.training.control_trainer import wan_control_loss

    model, dev = trainer.model, trainer.device
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    block0 = model.blocks[0]
    real_forward = block0.forward
    calls = [0]

    def halved_on_recompute(hs, *args):
        calls[0] += 1
        return real_forward(hs * 0.5 if calls[0] == 2 else hs, *args)

    def step(mode, fault=False):
        for _, p in params:
            p.grad = None
        if fault:
            calls[0] = 0
            block0.forward = halved_on_recompute
        cfg = dataclasses.replace(trainer.step_cfg, remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        try:
            loss, _ = wan_control_loss(model, cfg, batch, **draws)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            block0.forward = real_forward
        seconds = time.perf_counter() - t0
        launches = read_counts()
        grads = {n: p.grad.detach().clone() for n, p in params}
        return (loss.detach(), grads, seconds, torch.cuda.max_memory_allocated(dev),
                launches["flash_fwd_d128"], launches["flash_bwd_d128"])

    def held(grads, ref):
        worst, equal = 0.0, True
        for n, g in ref.items():
            scale = g.float().abs().max().item()
            err = (grads[n].float() - g.float()).abs().max().item()
            worst = max(worst, err / scale if scale else err)
            equal = equal and torch.equal(grads[n], g)
        return worst, equal

    per_block = 2  # self-attention and the text cross-attention
    layers = model.config.num_layers
    loss_full, ref, seconds, peak, k4, k6 = step("full")
    log(f"  remat full: loss {loss_full.item():.6f}, {seconds:.3f} s, peak {peak / 2**30:.2f} GiB, "
        f"K4 {k4} (expected {2 * per_block * layers}), K6 {k6} (expected {per_block * layers})")
    out = {"full": {"s": seconds, "peak_gib": peak / 2**30, "k4": k4}}
    if (k4, k6) != (2 * per_block * layers, per_block * layers):
        raise AssertionError(f"remat full: K4 {k4}, K6 {k6}")
    checkpointed = {"ops": layers, "block_skip:2": (layers - layers % 2) // 2}
    for mode in REMAT_MODES:
        loss, grads, seconds, peak, k4, k6 = step(mode)
        worst, equal = held(grads, ref)
        want_k4 = per_block * (layers + checkpointed[mode])
        log(f"  remat {mode}: loss {loss.item():.6f} (equal to full's {torch.equal(loss, loss_full)}"
            f"), gradients max|diff| / max|full| {worst:.3e} (tol {GRAD_REL_TOL}; equal to the bit "
            f"{equal}), {seconds:.3f} s, peak {peak / 2**30:.2f} GiB, K4 {k4} (expected {want_k4}),"
            f" K6 {k6}")
        out[mode] = {"s": seconds, "peak_gib": peak / 2**30, "k4": k4, "grad_rel": worst,
                     "bit_equal": equal}
        if not torch.equal(loss, loss_full) or worst > GRAD_REL_TOL:
            raise AssertionError(f"remat {mode}: loss {loss.item()} vs {loss_full.item()}, "
                                 f"gradients {worst:.3e} of max|full|")
        if (k4, k6) != (want_k4, per_block * layers):
            raise AssertionError(f"remat {mode}: K4 {k4} (expected {want_k4}), K6 {k6}")
        del grads
    loss, grads, _, _, _, _ = step("full", fault=True)
    worst, _ = held(grads, ref)
    log(f"  planted fault (block 0's recompute on half its input): loss equal "
        f"{torch.equal(loss, loss_full)}, gradients max|diff| / max|full| {worst:.3e}")
    if worst <= GRAD_REL_TOL:
        raise AssertionError("remat check: the limit does not catch a faulty recompute")
    for _, p in params:
        p.grad = None
    return out


def adafactor_step(trainer, batch, draws, dev):
    """control_full_finetune under ``adafactor``: a fresh 1.3B model (the
    entry point's, widened), one step on the same batch and draws; its
    seconds, peak and the optimizer state's bytes."""
    import dataclasses

    import torch

    from vap_tpu_torch.train import build_control_transformer
    from vap_tpu_torch.training.control_trainer import make_control_step, wan_control_loss
    from vap_tpu_torch.training.optimizer import get_lr_schedule, get_optimizer, jax_layout

    args = dataclasses.replace(trainer.args, training_type="control_full_finetune",
                               optimizer="adafactor")
    model = build_control_transformer(args, None, dev)

    def make_optimizer(params):
        params = list(params)
        return get_optimizer("adafactor", params, get_lr_schedule("constant", args.lr),
                             max_grad_norm=args.max_grad_norm, layout=jax_layout(model, params))

    _, opt, grad_fn, apply_fn = make_control_step(
        wan_control_loss, trainer.step_cfg, model, make_optimizer, family="wan",
        full_finetune=True)
    n = sum(p.numel() for p in opt.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    metrics = grad_fn(model, batch, None, None, **draws)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grad_norm = apply_fn()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    state = opt.state_bytes()
    log(f"  control_full_finetune, adafactor: {n} trained parameters (bf16), loss "
        f"{metrics['loss'].item():.6f}, grad_norm {grad_norm.item():.6f}, {t2 - t0:.3f} s = "
        f"forward + backward {t1 - t0:.3f} + update {t2 - t1:.3f}; peak {peak / 2**30:.2f} GiB; "
        f"optimizer state {state} bytes ({state / n:.4f} a parameter; AdamW in bf16: 4)")
    if not (torch.isfinite(metrics["loss"]) and torch.isfinite(grad_norm) and opt.count == 1):
        raise AssertionError("adafactor step: not finite, or no update")
    del model, opt
    torch.cuda.empty_cache()
    return {"s": t2 - t0, "update_s": t2 - t1, "peak_gib": peak / 2**30,
            "state_bytes_per_param": state / n}


def control_training_path(dev, parts):
    """Phase 9c: the released control recipe at full width, UMT5 and the VAE
    of ``parts`` (phase 6c's, in host memory) on the card for the phase.
    Two steps from clips (UMT5 and the VAE online), one validation (2
    FlowMatch steps at CFG batch 2, decoded); then the remat modes and the
    Adafactor full finetune on the first step's batch and draws."""
    import gc
    import shutil

    import numpy as np
    import torch

    work = os.path.join(HERE, "build", "chip_smoke_control")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    text_encoder, vae = parts["text_encoder"].to(dev), parts["vae"].to(dev)
    trainer = build_control_trainer(dev, work, text_encoder, vae)
    model, cfg = trainer.model, trainer.model.config
    n_train = sum(p.numel() for n, p in model.named_parameters() if n in trainer.trainable_names)
    log(f"  Wan2.1-T2V-1.3B: {cfg.num_layers} blocks, {cfg.num_attention_heads}x"
        f"{cfg.attention_head_dim} heads, ffn {cfg.ffn_dim}, {cfg.in_channels} input channels; "
        f"{n_params(model)} bf16 parameters, {len(trainer.lora)} adapters (rank "
        f"{trainer.args.rank}) and {len(trainer.trainable_names) - 2 * len(trainer.lora)} "
        f"tensors trained directly: {n_train} trained parameters; remat "
        f"{trainer.step_cfg.remat!r}; UMT5 and the VAE moved to the card; "
        f"{time.perf_counter() - t0:.2f} s to build")
    record = []
    grad = trainer._grad

    def recording(model, batch, generator=None, clock=None, **draws):
        if not record:
            record.append(({k: v.detach().clone() for k, v in batch.items()},
                           {k: v.detach().clone() for k, v in draws.items()}))
        return grad(model, batch, generator, clock, **draws)

    trainer._grad = recording
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = max(trainer.stage_peaks.values(), default=0)
    for r in trainer.history:
        total = r["forward_s"] + r["backward_s"] + r["update_s"]
        log(f"  step {r['step']}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, "
            f"{total:.3f} s = forward {r['forward_s']:.3f} + backward {r['backward_s']:.3f} + "
            f"update {r['update_s']:.3f}")
    per_step = 2 * cfg.num_layers  # self- and text cross-attention per block
    want = {"flash_fwd_d128": 2 * per_step * TRAIN_STEPS + per_step * CONTROL_VAL_STEPS,
            "flash_bwd_d128": per_step * TRAIN_STEPS}
    peaks = {k: round(v / 2**30, 2) for k, v in trainer.stage_peaks.items()}
    log(f"  {TRAIN_STEPS} steps and a validation in {wall:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB, by span {peaks} GiB; launches: K4 {launches['flash_fwd_d128']} "
        f"(expected {want['flash_fwd_d128']}: {2 * per_step} a step, forward and recompute, and "
        f"{per_step} a validation step at CFG batch 2), K6 {launches['flash_bwd_d128']} (expected "
        f"{want['flash_bwd_d128']})")
    check_launches(launches, want)
    if not (len(trainer.history) == TRAIN_STEPS == trainer.optimizer.count
            and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in trainer.history)):
        raise AssertionError(f"control training: history {trainer.history}")
    path = os.path.join(trainer.args.output_dir, "validation", f"{TRAIN_STEPS:06d}",
                        "sample_0.mp4")
    from vap_tpu_torch.data import video

    written = video.load_video(path)[0] if os.path.exists(path) else None
    log(f"  validation video {path}: {None if written is None else written.shape}")
    if written is None or written.shape != (NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3):
        raise AssertionError("control validation: no video of 49 frames at 480x832")
    batch, draws = record[0]
    remat = remat_variants(trainer, batch, draws)
    export = trainer.export()
    files = sorted(os.listdir(os.path.dirname(export)))
    log(f"  export: {files}")
    if files != ["control_injection_layers.safetensors", "pytorch_lora_weights.safetensors"]:
        raise AssertionError(f"control export: {files}")
    steps = [r["forward_s"] + r["backward_s"] + r["update_s"] for r in trainer.history]
    result = {"step_s": steps, "peak_gib": peak / 2**30, "trained": n_train,
              "k4": launches["flash_fwd_d128"], "k6": launches["flash_bwd_d128"], "remat": remat}
    trainer.optimizer.inner.state.clear()
    result["adafactor"] = adafactor_step(trainer, batch, draws, dev)
    del trainer, model, batch, draws, record
    parts["text_encoder"], parts["vae"] = text_encoder.to("cpu"), vae.to("cpu")
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 10: Wan2.1-I2V-14B LoRA SFT at full width
# ---------------------------------------------------------------------------

def wan_training_batch(cfg):
    """One random precomputed item at 49f@480x832, batch 1, in WanSpec's
    layout: latents [1,13,60,104,16]; condition [1,13,60,104,20] (the
    first-frame mask, then the latent of the first frame and zeros); UMT5
    states [1,512,4096], zero past a 40-token prompt; CLIP states
    [1,257,1280]."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    frames = (NUM_FRAMES - 1) // 4 + 1
    lat = (1, frames, WAN_HEIGHT // 8, WAN_WIDTH // 8, cfg.out_channels)
    cond = np.zeros(lat[:-1] + (cfg.in_channels - cfg.out_channels,), np.float32)
    cond[:, 0, ..., :4] = 1.0  # the mask: the first frame is given
    cond[:, 0, ..., 4:] = rng.standard_normal(cond[:, 0, ..., 4:].shape, dtype=np.float32)
    text = np.zeros((1, cfg.text_len, cfg.text_dim), np.float32)
    text[:, :40] = rng.standard_normal((1, 40, cfg.text_dim), dtype=np.float32)
    return ({"encoder_hidden_states": text, "encoder_hidden_states_image":
             rng.standard_normal((1, 257, cfg.image_dim), dtype=np.float32)},
            {"latents": rng.standard_normal(lat, dtype=np.float32), "condition": cond})


def build_wan_trainer(dev, work):
    """Wan2.1-I2V-14B in the recipe's plain structure, random bf16 weights
    from SEED on the card, and an SFTTrainer of the LoRA recipe with remat
    "full", on one random item written as a precomputed cache under ``work``."""
    import shutil

    import torch

    from vap_tpu_torch.data.precomputation import write_precomputed
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.train import structure_overrides
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.trainer import SFTTrainer

    shutil.rmtree(work, ignore_errors=True)
    args = TrainingArgs(model_name="wan", training_type="lora",
                        model_structure_config=os.path.join(HERE, WAN_STRUCTURE),
                        precomputation_dir=os.path.join(work, "cache"),
                        output_dir=os.path.join(work, "out"), seed=SEED, train_steps=1,
                        optimizer="adamw", lr_scheduler="constant", lr_warmup_steps=0,
                        beta1=0.9, beta2=0.99, weight_decay=1e-4, max_grad_norm=1.0,
                        gradient_checkpointing=True, checkpointing_steps=NEVER,
                        logging_steps=1, **WAN_LORA)
    cfg = WanMOTConfig.wan_14b_i2v_vap(**structure_overrides(WanMOTConfig,
                                                             args.model_structure()))
    write_precomputed(args.precomputation_dir, [wan_training_batch(cfg)])
    model = build_random(WanTransformer3DMOTModel, cfg, dev, torch.bfloat16,
                         torch.Generator(device=dev).manual_seed(SEED + 10))
    return SFTTrainer(args, model)


def top_device_kernels(prof, n=8):
    """The card's time in a profiler's window (the trainer's traces only the
    card): (ms busy in all, [(kernel name, ms in all, calls)] of the ``n``
    with the most)."""
    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted((e for e in prof.key_averages() if device_us(e) > 0), key=device_us,
                  reverse=True)
    busy = sum(device_us(e) for e in rows) / 1e3
    return busy, [(e.key[:60], round(device_us(e) / 1e3, 3), e.count) for e in rows[:n]]


# 10a / 13a: the one-rank ring runs the flash step's kernels through the
# ring's route (attention_with_lse), so its loss and gradients should be
# flash's to the bit (phase 8's ring_training_check reads them so at
# D=64); held within one bf16 ulp of the largest gradient of each tensor
# (2^-7 of it), what a flipped rounding of a bf16 attention output gives,
# and the loss within RING_LOSS_RTOL
RING_GRAD_RTOL = 2**-7
RING_LOSS_RTOL = 1e-6


def ring_profiled_step(trainer, provider, work):
    """The next step of a LoRA trainer under ``provider`` (the ``ring``
    provider at one rank: a one-rank NCCL group's mesh installed as the
    trainer's) inside its profiling window (``--profile_dir``, the run's
    first step), held against one grad_fn under ``flash`` on the same item
    and draws: the loss and every adapter gradient within RING_LOSS_RTOL and
    RING_GRAD_RTOL, and whether to the bit. Returns (the ring step's
    launches, what it measured)."""
    import torch

    from vap_tpu_torch.data.precomputation import PrecomputedReader
    from vap_tpu_torch.data.sampler import ResolutionSampler

    args, model = trainer.args, trainer.model
    step = trainer.train_state.step + 1
    position = trainer.data_position
    batch = trainer._batch(PrecomputedReader(args.precomputation_dir).stream(position),
                           ResolutionSampler(1))
    trainer.data_position = position
    draws = trainer._draws(batch, step)
    with trainer._attn_ctx():
        loss = trainer._grad(model, batch, None, None, **draws)["loss"].item()
    params = trainer.optimizer.params

    def grads():  # an adapter the loss does not reach has none: zeros, as the update reads it
        return [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                for p in params]

    want = grads()
    for p in params:
        p.grad = None
    got = []
    apply = trainer._apply

    def kept(scale=1.0):  # the gradients the update reads
        got.extend(grads())
        return apply(scale)

    trace = os.path.join(work, "trace")
    ring_args = dataclasses.replace(args, attn_provider_training=provider, profile_dir=trace,
                                    profile_start_step=1, profile_num_steps=1)
    with one_rank_nccl_group(trainer.device) as mesh:
        trainer.mesh, trainer.args, trainer._apply = mesh, ring_args, kept
        try:
            reset_counts()
            trainer.run()
            launches = read_counts()
        finally:
            trainer.mesh, trainer.args, trainer._apply = None, args, apply
    ring_loss = trainer.history[-1]["loss"]
    same = sum(torch.equal(g, w) for g, w in zip(got, want))
    worst = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                for g, w in zip(got, want))
    loss_err = abs(ring_loss - loss) / max(abs(loss), 1e-30)
    busy, top = top_device_kernels(trainer.profile)
    record = trainer.history[-1]
    wall = record["forward_s"] + record["backward_s"] + record["update_s"]
    path = os.path.join(trace, "trace_rank0.json")
    log(f"  step {step} under {provider!r} (one-rank NCCL mesh) in the profiling window: loss "
        f"{ring_loss!r} against flash's {loss!r} (bit-equal {ring_loss == loss}), adapter "
        f"gradients bit-equal {same} of {len(params)}, the largest max|diff| / max|flash| "
        f"{worst:.3e} (tol {RING_GRAD_RTOL:.3e}); the step {wall:.3f} s, the card busy "
        f"{busy / 1e3:.3f} s of it (idle {1 - busy / 1e3 / wall:.3f}); the trace "
        f"({os.path.getsize(path) if os.path.exists(path) else 0} bytes) top device kernels "
        f"(name, ms, calls): {top}")
    if not (loss_err <= RING_LOSS_RTOL and worst <= RING_GRAD_RTOL and os.path.exists(path)
            and len(got) == len(want)):
        raise AssertionError(f"the {provider} step differs from flash's or wrote no trace")
    shutil.rmtree(trace, ignore_errors=True)
    return launches, {"loss": [loss, ring_loss], "grads_bit_equal": [same, len(params)],
                      "grad_max_rel_diff": worst, "step_s": wall, "busy_s": busy / 1e3,
                      "top_device_kernels": top}


def run_lora_training(trainer, want_launches, ring, work):
    """``TRAIN_STEPS`` optimizer steps of a LoRA trainer on the card, one
    ``run()`` each, the last under ``ring`` (``ring_profiled_step``, its
    trace under ``work``), each step's launches counted from 0: per
    step the loss, grad_norm and the forward / backward / update seconds;
    the peak device memory; exactly ``want_launches`` per step (none of any
    other kernel); the frozen trunk bit-identical (a host copy); every
    adapter's B moved at step 1 and its A at step 2, none at step 1; the
    share of adapted weight elements the bf16 merge changes. Returns (the
    launches, the ring step's readings)."""
    import numpy as np
    import torch

    model, dev = trainer.model, trainer.device
    params = dict(model.named_parameters())
    trainable = set(trainer.trainable_names)
    before = {n: p.detach().to("cpu", copy=True) for n, p in params.items() if n not in trainable}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = {n: ab["A"].detach().clone() for n, ab in trainer.lora.items()}
    snapshots = []
    launches = dict.fromkeys(read_counts(), 0)
    t0 = time.perf_counter()
    for step in range(1, TRAIN_STEPS + 1):  # one run() per step, to see what each moved
        trainer.args.train_steps = step
        if step == TRAIN_STEPS:
            counted, ring_result = ring_profiled_step(trainer, ring, work)
        else:
            reset_counts()
            trainer.run()
            counted = read_counts()
        launches = {k: launches[k] + counted[k] for k in launches}
        snapshots.append({n: {k: v.detach().clone() for k, v in ab.items()}
                          for n, ab in trainer.lora.items()})
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for r in trainer.history:
        total = r["forward_s"] + r["backward_s"] + r["update_s"]
        log(f"  step {r['step']}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, lr "
            f"{r['lr']:.1e}, {total:.3f} s = forward {r['forward_s']:.3f} + backward "
            f"{r['backward_s']:.3f} + update {r['update_s']:.3f}")
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}, per step " + ", ".join(
            f"{name} {launches[name] / TRAIN_STEPS:g} (expected {n})"
            for name, n in want_launches.items()))
    check_launches(launches, {name: n * TRAIN_STEPS for name, n in want_launches.items()})
    if not (len(trainer.history) == TRAIN_STEPS == trainer.optimizer.count
            and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in trainer.history)):
        raise AssertionError(f"LoRA training: {trainer.optimizer.count} updates, history "
                             f"{trainer.history}")
    frozen_changed = [n for n, p in params.items()
                      if n not in trainable and not torch.equal(p.detach().cpu(), before[n])]
    # B starts at 0, so A's gradient is 0 at step 1: every B moves at step 1
    # and no A (weight decay at these lr moves A by under 1e-8 of itself,
    # below half an f32 ulp); at step 2 every A moves
    b_still = [n for n in start if not snapshots[0][n]["B"].any()]
    a_early = [n for n in start if not torch.equal(snapshots[0][n]["A"], start[n])]
    a_still = [n for n in start if torch.equal(snapshots[1][n]["A"], start[n])]
    log(f"  frozen tensors changed: {len(frozen_changed)} of {len(before)}; adapters whose B "
        f"moved at step 1: {len(start) - len(b_still)} of {len(start)}, whose A moved at step 1: "
        f"{len(a_early)}, at step 2: {len(start) - len(a_still)}")
    if frozen_changed or b_still or a_early or a_still:
        raise AssertionError(f"LoRA training: frozen tensors changed {frozen_changed[:5]}, B that "
                             f"did not move {b_still[:5]}, A that moved early {a_early[:5]} or "
                             f"not at step 2 {a_still[:5]}")
    # the merge rounds W + delta to bf16: a delta below half an ulp of W is lost
    with torch.no_grad():
        kept = sum(int((model.get_submodule(n).merged_weight() != params[f"{n}.weight"]).sum())
                   for n in trainer.lora)
    total = sum(params[f"{n}.weight"].numel() for n in trainer.lora)
    log(f"  after step {TRAIN_STEPS}: {kept} of {total} adapted weight elements "
        f"({kept / total:.4f}) differ from the frozen base once merged in bf16")
    return launches, ring_result


def strip_lora(model):
    """Phase 10's adapters taken out: each ``LoRALinear`` of ``model`` gives
    way to an ``nn.Linear`` holding its frozen weight and bias (no copy)."""
    import torch

    from vap_tpu_torch.training.lora import LoRALinear

    for name, m in [(n, m) for n, m in model.named_modules() if isinstance(m, LoRALinear)]:
        lin = torch.nn.Linear(m.weight.shape[1], m.weight.shape[0], bias=m.bias is not None,
                              device="meta")
        lin.weight, lin.bias = m.weight, m.bias
        model.set_submodule(name, lin)


def wan_float8_check(model, dev, work):
    """Phase 10's frozen base (its adapters taken out) trained by an
    ``SFTTrainer`` of the LoRA recipe under ``--layerwise_upcasting_modules
    transformer`` (float8_e4m3fn, the JAX package's default skip patterns):
    the trainer casts the base, installs its adapters and takes one step
    from phase 10's item, written as a precomputed cache under ``work``.
    Before it, the bf16 base's loss on that item with the draws of the
    trainer's step 1. Logs the frozen bytes before and after, the step's
    seconds and peak, and its loss against the bf16 one (float8 changes
    the weights: no limit, the difference is logged)."""
    import shutil

    import numpy as np
    import torch

    from vap_tpu_torch.data.precomputation import write_precomputed
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.lora import LoRALinear
    from vap_tpu_torch.training.train_step import draw_step_noise, wan_vap_loss
    from vap_tpu_torch.training.trainer import SFTTrainer, _make_step_config, step_generator

    strip_lora(model)
    model.requires_grad_(False)
    cfg = model.config
    shutil.rmtree(work, ignore_errors=True)
    args = TrainingArgs(model_name="wan", training_type="lora",
                        layerwise_upcasting_modules="transformer",
                        layerwise_upcasting_storage_dtype="float8_e4m3fn",
                        model_structure_config=os.path.join(HERE, WAN_STRUCTURE),
                        precomputation_dir=os.path.join(work, "cache"),
                        output_dir=os.path.join(work, "out"), seed=SEED, train_steps=1,
                        optimizer="adamw", lr_scheduler="constant", lr_warmup_steps=0,
                        beta1=0.9, beta2=0.99, weight_decay=1e-4, max_grad_norm=1.0,
                        gradient_checkpointing=True, checkpointing_steps=NEVER,
                        logging_steps=1, **WAN_LORA)
    item = wan_training_batch(cfg)
    write_precomputed(args.precomputation_dir, [item])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {**item[0], **item[1]}.items()}
    step_cfg = _make_step_config("wan", args, cfg)
    draws = draw_step_noise(step_cfg, batch["latents"].shape, step_generator(args.seed, 1, dev),
                            dev)
    model.train()
    with torch.no_grad():
        bf16_loss = wan_vap_loss(model, step_cfg, batch, **draws)[0].item()
    del batch, draws
    frozen = lambda: sum(p.numel() * p.element_size() for p in model.parameters()
                         if not p.requires_grad)
    before = frozen()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = SFTTrainer(args, model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    after = frozen()
    lin = sum(isinstance(m, LoRALinear) and m.weight.dtype == torch.float8_e4m3fn
              for m in model.modules())
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    (r,) = trainer.history
    loss, norm = r["loss"], r["grad_norm"]
    log(f"  the trainer (lora, --layerwise_upcasting_modules transformer): "
        f"{len(trainer.layerwise_cast)} tensors cast, {lin} of {len(trainer.lora)} adapted "
        f"linears over float8, built in {build_s:.3f} s; frozen bytes {before} -> {after} "
        f"({after / before:.4f}); one step {seconds:.3f} s (forward {r['forward_s']:.3f} + "
        f"backward {r['backward_s']:.3f} + update {r['update_s']:.3f}), peak "
        f"{peak / 2**30:.2f} GiB (bf16 storage: 46.71 on an H100 80GB HBM3), loss {loss:.6f} against the bf16 "
        f"storage's {bf16_loss:.6f} on the same item and draws (diff {loss - bf16_loss:+.3e}), "
        f"grad_norm {norm:.6f}")
    if not (np.isfinite([loss, norm]).all() and after < before and lin == len(trainer.lora)
            and trainer.optimizer.count == 1):
        raise AssertionError(f"float8 storage: loss {loss}, grad_norm {norm}, bytes {after}, "
                             f"{lin} float8 linears of {len(trainer.lora)}")
    trainer.optimizer.inner.state.clear()
    del trainer
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"frozen_bytes": [before, after], "peak_gib": peak / 2**30, "step_s": seconds,
            "forward_s": r["forward_s"], "backward_s": r["backward_s"],
            "update_s": r["update_s"], "loss": loss, "bf16_loss": bf16_loss}


def describe_lora(trainer, t0):
    trainable = set(trainer.trainable_names)
    n_lora = sum(p.numel() for n, p in trainer.model.named_parameters() if n in trainable)
    return (f"{n_params(trainer.model) - n_lora} bf16 parameters frozen, {len(trainer.lora)} "
            f"adapters (rank {trainer.args.rank}) with {n_lora} f32 parameters, remat "
            f"{trainer.step_cfg.remat!r}, AdamW fused {trainer.optimizer.inner.defaults['fused']}; "
            f"{time.perf_counter() - t0:.2f} s to build")


def wan_training_path(dev):
    import shutil

    import torch

    work = os.path.join(HERE, "build", "chip_smoke_wan_train")
    t0 = time.perf_counter()
    trainer = build_wan_trainer(dev, work)
    cfg = trainer.model.config
    log(f"  {cfg.num_layers} blocks, MoT in {list(cfg.block_idx_with_mot_ref)}, "
        f"{cfg.num_attention_heads}x{cfg.attention_head_dim} heads, ffn {cfg.ffn_dim}, "
        f"{cfg.in_channels} input channels: {describe_lora(trainer, t0)}")
    per_step = 3 * cfg.num_layers  # self, text and image attention per block
    # K4 runs each attention in the forward and again in the recompute; step
    # 2 (10a) under the one-rank ring, the cross-attentions local
    launches, ring = run_lora_training(trainer, {"flash_fwd_d128": 2 * per_step,
                                                 "flash_bwd_d128": per_step},
                                       ring="ring cross:flash", work=work)
    peft = write_lora(trainer, os.path.join(HERE, "build", "chip_smoke_lora"))
    # the model goes on to phases 10b and 10c; its gradients and the optimizer state do not
    model = trainer.model
    for p in model.parameters():
        p.grad = None
    del trainer
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches["flash_bwd_d128"], model, peft, ring


# ---------------------------------------------------------------------------
# phase 11: HunyuanVideo T2V
# ---------------------------------------------------------------------------

def hunyuan_small_check(dev):
    """A small HunyuanVideo pipeline on the card at head_dim 128, with a
    padded text mask: K7 in K4 (flash) and in K2 (sage) against the plain
    masked dense attention, and their launch counts."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.hunyuan_video import transformer as hv_transformer
    from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
    from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
    from vap_tpu_torch.models.hunyuan_video.vae import (AutoencoderKLHunyuanVideo,
                                                        HunyuanVideoVAEConfig)
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
    from vap_tpu_torch.models.text_encoders.llama import LlamaConfig, LlamaModel
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.hunyuan_video import HunyuanVideoPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bf16 = torch.bfloat16
    vae_cfg = HunyuanVideoVAEConfig.tiny()
    t_cfg = HunyuanVideoConfig.tiny(attention_head_dim=128, in_channels=vae_cfg.latent_channels,
                                    out_channels=vae_cfg.latent_channels, text_embed_dim=32,
                                    rope_axes_dim=(32, 48, 48))
    clip_cfg = CLIPTextConfig.tiny(hidden_size=t_cfg.pooled_projection_dim)
    pipe = HunyuanVideoPipeline(
        build_random(HunyuanVideoTransformer3DModel, t_cfg, dev, bf16, gen),
        build_random(AutoencoderKLHunyuanVideo, vae_cfg, dev, bf16, gen),
        build_random(LlamaModel, LlamaConfig.tiny(hidden_size=t_cfg.text_embed_dim), dev, bf16, gen),
        build_random(CLIPTextModel, clip_cfg, dev, bf16, gen),
        FakeTokenizer(64), FakeTokenizer(clip_cfg.vocab_size, eos=clip_cfg.eos_token_id),
        dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(prompt="a cat", height=32, width=32, num_frames=9, num_inference_steps=STEPS,
                max_sequence_length=64, use_template=False, output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 4, 3, 16, 16)).astype(np.float32)))
    with attention_provider("xla"):
        ref = pipe(**args)
    want = STEPS * (t_cfg.num_layers + t_cfg.num_single_layers)
    for provider, counter in (("flash", "flash_fwd_d128_varlen"), ("sage", "sage_fwd_varlen")):
        reset_counts()
        with attention_provider(provider):
            got = pipe(**args)
        launches = read_counts()
        err = (got - ref).abs().max().item()
        log(f"  small Hunyuan pipeline (5 of 64 text tokens valid), {provider} vs plain masked "
            f"dense attention: final latents max|err| {err:.4e} (tol {HUNYUAN_E2E_ATOL}), "
            f"max|ref| {ref.abs().max().item():.3f}, launches {launches}")
        check_launches(launches, {counter: want})
        if not (torch.isfinite(got).all() and err <= HUNYUAN_E2E_ATOL):
            raise AssertionError(f"small Hunyuan pipeline under {provider} disagrees with plain "
                                 f"attention")
    # planted fault: the joint attention without the transformer's kv_lens
    masked = hv_transformer.full_attention
    hv_transformer.full_attention = lambda *a, kv_lens=None, **kw: masked(*a, **kw)
    try:
        with attention_provider("flash"):
            err = (pipe(**args) - ref).abs().max().item()
    finally:
        hv_transformer.full_attention = masked
    log(f"  planted fault (flash, kv_lens dropped): max|err| {err:.4e} (must exceed "
        f"{HUNYUAN_E2E_ATOL})")
    if not err > HUNYUAN_E2E_ATOL:
        raise AssertionError("the small Hunyuan check does not see the key masking")


def build_hunyuan_pipeline(dev):
    """HunyuanVideo T2V at full width and depth with random bf16 weights
    from SEED, each component built on the card and kept in host memory
    (model offload)."""
    import torch

    from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
    from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
    from vap_tpu_torch.models.hunyuan_video.vae import (AutoencoderKLHunyuanVideo,
                                                        HunyuanVideoVAEConfig)
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
    from vap_tpu_torch.models.text_encoders.llama import LlamaConfig, LlamaModel
    from vap_tpu_torch.pipelines.hunyuan_video import HunyuanVideoPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    t0 = time.perf_counter()
    t_cfg = HunyuanVideoConfig.hunyuan_video_t2v()
    parts = {}
    for name, cls, cfg in (("transformer", HunyuanVideoTransformer3DModel, t_cfg),
                           ("vae", AutoencoderKLHunyuanVideo, HunyuanVideoVAEConfig.hunyuan_video()),
                           ("text_encoder", LlamaModel, LlamaConfig.llava_llama_8b()),
                           ("text_encoder_2", CLIPTextModel, CLIPTextConfig.clip_vit_l())):
        parts[name] = build_random(cls, cfg, dev, torch.bfloat16, gen, host=True)
        torch.cuda.empty_cache()
    tok, clip_tok = hunyuan_tokenizers()
    pipe = HunyuanVideoPipeline(**parts, tokenizer=tok, clip_tokenizer=clip_tok,
                                dtype=torch.bfloat16, device=dev, enable_model_offload=True)
    counts = {name: n_params(m) for name, m in parts.items()}
    log(f"Hunyuan weights: {counts} bf16 in host memory ({sum(counts.values()) * 2 / 2**30:.2f} "
        f"GiB; host MemTotal {mem_total_gib():.2f} GiB), {time.perf_counter() - t0:.2f} s to "
        f"build; {t_cfg.num_layers} dual + {t_cfg.num_single_layers} single blocks, "
        f"{t_cfg.num_attention_heads}x{t_cfg.attention_head_dim} heads; the VAE's encoder runs in "
        f"phase 12")
    return pipe


def hunyuan_path(pipe, provider, steps, dev, kv_len):
    """``HunyuanVideoPipeline.__call__`` at 33 frames of 720x1280. The cut:
    the released default of 129 frames gives 118,800 image tokens, about
    10.4 PFLOP of joint attention a step, ~82 s a step at K4's 127 TFLOP/s,
    and a VAE mid attention over 475,200 voxels. Under flash the video is
    decoded; under sage the latents are returned. Returns K7's launches."""
    import numpy as np
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    text_lens = []
    hook = pipe.transformer.register_forward_pre_hook(
        lambda m, a, kw: text_lens.append(int(kw["encoder_attention_mask"].sum().item())),
        with_kwargs=True)
    output = "np" if provider == "flash" else "latent"
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    try:
        with attention_provider(provider):
            out = pipe(HUNYUAN_PROMPT, height=HUNYUAN_HEIGHT, width=HUNYUAN_WIDTH,
                       num_frames=HUNYUAN_FRAMES, num_inference_steps=steps,
                       max_sequence_length=HUNYUAN_TEXT, seed=SEED, output_type=output)
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = pipe.stage_seconds
    if output == "np":
        expected = (1, HUNYUAN_FRAMES, HUNYUAN_HEIGHT, HUNYUAN_WIDTH, 3)
        finite = bool(np.isfinite(out).all())
        log(f"  video {out.shape}, finite {finite}, range [{out.min():.3f}, {out.max():.3f}]")
    else:
        expected = (1, 16, (HUNYUAN_FRAMES - 1) // 4 + 1, HUNYUAN_HEIGHT // 8, HUNYUAN_WIDTH // 8)
        finite = bool(torch.isfinite(out).all())
        log(f"  latents {tuple(out.shape)}, finite {finite}, max|x| {out.abs().max().item():.3f}")
    valid = sorted(set(HUNYUAN_IMAGE_TOKENS + n for n in text_lens))
    log(f"  joint attention: {HUNYUAN_IMAGE_TOKENS} image + {HUNYUAN_TEXT} text tokens, valid "
        f"keys {valid} (text {sorted(set(text_lens))} of {HUNYUAN_TEXT}; expected {kv_len})")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, denoise steps "
        f"{[round(x, 3) for x in st['denoise_steps']]}, vae_decode "
        f"{st.get('vae_decode', float('nan')):.3f}, host->card staging "
        f"{ {k: round(v, 3) for k, v in st['staging'].items()} }; call {wall:.3f}")
    counter = "flash_fwd_d128_varlen" if provider == "flash" else "sage_fwd_varlen"
    cfg = pipe.transformer.config
    per_step = cfg.num_layers + cfg.num_single_layers
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}, K7 per step "
        f"{launches[counter] / steps:g} (expected {per_step})")
    if tuple(out.shape) != expected or not finite:
        raise AssertionError(f"Hunyuan output {tuple(out.shape)} (expected {expected}) or not "
                             f"finite")
    if valid != [kv_len]:
        raise AssertionError(f"Hunyuan valid keys {valid}, expected [{kv_len}] (a padded text mask)")
    check_launches(launches, {counter: steps * per_step})
    return launches[counter]


# ---------------------------------------------------------------------------
# phases 12-13: HunyuanVideo's VAE encode and LoRA SFT at full width
# ---------------------------------------------------------------------------

def hunyuan_encode_path(vae, dev):
    """A seeded random clip of 49 frames at 480x768 in [-1, 1], made on the
    card, through the port's encoder (``prepare_latents``: the scaled mean,
    channel-first) with its seconds and peak memory; first the tiny encoder
    on the card in float32 against the same on the CPU (the strided,
    frame-chunked convs on CUDA). Returns the latents [1, 16, 13, 60, 96]."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.hunyuan_video import vae as hvae
    from vap_tpu_torch.models.random_init import build_random

    tiny = build_random(hvae.AutoencoderKLHunyuanVideo, hvae.HunyuanVideoVAEConfig.tiny(), "cpu",
                        torch.float32, torch.Generator().manual_seed(SEED + 14))
    clip = torch.rand((9, 12, 10, 3), generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    ref = hvae.prepare_latents(tiny, {"video": clip}, torch.float32)["latents"]
    got = hvae.prepare_latents(tiny.to(dev), {"video": clip}, torch.float32)["latents"]
    err = float(np.abs(got - ref).max())
    log(f"  tiny encoder, card vs CPU (float32): latents {got.shape}, max|err| {err:.3e} (tol "
        f"{VAE_CARD_ATOL}), max|ref| {np.abs(ref).max():.3f}")
    if not err <= VAE_CARD_ATOL:
        raise AssertionError("the tiny VAE encoder on the card disagrees with the CPU")

    vae.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    shape = (HUNYUAN_TRAIN_FRAMES, HUNYUAN_TRAIN_HEIGHT, HUNYUAN_TRAIN_WIDTH, 3)
    video = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    latents = hvae.prepare_latents(vae, {"video": video})["latents"]
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    expected = (1, 16, (HUNYUAN_TRAIN_FRAMES - 1) // 4 + 1, HUNYUAN_TRAIN_HEIGHT // 8,
                HUNYUAN_TRAIN_WIDTH // 8)
    finite = bool(np.isfinite(latents).all())
    log(f"  clip {shape} bf16 -> latents {latents.shape} (scaled mean), finite {finite}, "
        f"std {latents.std():.4f}, max|x| {np.abs(latents).max():.3f}; {secs:.3f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if latents.shape != expected or not finite:
        raise AssertionError(f"Hunyuan encode gave {latents.shape} (expected {expected}) or "
                             f"non-finite latents")
    vae.to("cpu")
    del video
    torch.cuda.empty_cache()
    return latents


def hunyuan_training_item(cfg, latents, text_len):
    """One cache item in ``HunyuanVideoSpec``'s layout for the transformer
    config ``cfg``: ``latents`` (the encoded clip, [1, 16, 13, 60, 96]),
    random LLaMA states [1, 256, 4096], the prompt's mask [1, 256]
    (``text_len`` ones, then padding) and random CLIP pooled states
    [1, 768], from SEED."""
    import numpy as np

    rng = np.random.default_rng(SEED + 16)
    mask = (np.arange(HUNYUAN_TEXT) < text_len).astype(np.float32)[None]
    return ({"encoder_hidden_states": rng.standard_normal((1, HUNYUAN_TEXT, cfg.text_embed_dim),
                                                          np.float32),
             "prompt_attention_mask": mask,
             "pooled_projections": rng.standard_normal((1, cfg.pooled_projection_dim),
                                                       np.float32)},
            {"latents": np.asarray(latents, np.float32)})


def build_hunyuan_trainer(model, work, latents):
    """An SFTTrainer of the HunyuanVideo LoRA recipe with remat "full" on
    ``model`` (on the card), reading one item written as a precomputed cache
    under ``work``: ``latents`` with the phase-11 prompt's text mask."""
    import shutil

    from vap_tpu_torch.data.precomputation import write_precomputed
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.trainer import SFTTrainer

    shutil.rmtree(work, ignore_errors=True)
    args = TrainingArgs(model_name="hunyuan_video", training_type="lora",
                        precomputation_dir=os.path.join(work, "cache"),
                        output_dir=os.path.join(work, "out"), seed=SEED, train_steps=1,
                        optimizer="adamw", lr_scheduler="constant", lr_warmup_steps=0,
                        beta1=0.9, beta2=0.99, weight_decay=1e-4, max_grad_norm=1.0,
                        gradient_checkpointing=True, checkpointing_steps=NEVER,
                        logging_steps=1, **HUNYUAN_LORA)
    write_precomputed(args.precomputation_dir,
                      [hunyuan_training_item(model.config, latents, hunyuan_text_len())])
    return SFTTrainer(args, model)


def hunyuan_training_path(model, latents, dev):
    """HunyuanVideo LoRA SFT at full width and depth on phase 11's
    transformer (moved to the card): TRAIN_STEPS steps at 49f@480x768 through
    ``SFTTrainer.run``, the last under the one-rank ``ring`` (13a). Returns
    K7's launches in K4 and in K6, and the ring step's readings."""
    import shutil

    import torch

    work = os.path.join(HERE, "build", "chip_smoke_hunyuan_train")
    t0 = time.perf_counter()
    model.to(dev)
    trainer = build_hunyuan_trainer(model, work, latents)
    cfg = model.config
    log(f"  {cfg.num_layers} dual + {cfg.num_single_layers} single blocks, "
        f"{cfg.num_attention_heads}x{cfg.attention_head_dim} heads, joint attention "
        f"{HUNYUAN_TRAIN_SHAPE} with {hunyuan_kv_len(HUNYUAN_TRAIN_IMAGE_TOKENS)} valid keys: "
        f"{describe_lora(trainer, t0)}")
    per_step = cfg.num_layers + cfg.num_single_layers  # one joint attention a block
    # K7 in K4 runs each attention in the forward and again in the recompute;
    # step 2 (13a) under the one-rank ring, kv_lens through it
    launches, ring = run_lora_training(trainer, {"flash_fwd_d128_varlen": 2 * per_step,
                                                 "flash_bwd_d128_varlen": per_step},
                                       ring="ring", work=work)
    del trainer
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, ring


def serialised_wgmma(log_text, kernels):
    """[(kernel, line)] for every warning in a ptxas log that it serialised
    the wgmma (C7513: an input defined while a product is in flight; C7512:
    too few registers; any C751x): the kernel of ``kernels`` whose name the
    line holds, else the one ptxas was compiling, else "unattributed".
    ptxas prints the mangled names of kernels in an anonymous namespace, so
    a kernel is found by its name inside the line."""
    hits, current = [], "unattributed"
    for line in log_text.splitlines():
        named = next((k for k in kernels if k in line), None)
        if "Compiling entry function" in line:
            current = named or "unattributed"
        elif re.search(r"\bC751\d\b", line):
            hits.append((named or current, line.strip()))
    return hits


def sass_needs(kernel):
    """The SASS instructions a wgmma kernel must hold: TMA loads (UTMALDG)
    and its wgmma, IGMMA for the int8 GEMMs, HGMMA for the others (K2's
    also IGMMA)."""
    if kernel in INT8_GEMM_KERNELS:
        return ("IGMMA", "UTMALDG")
    return ("HGMMA", "UTMALDG") + (("IGMMA",) if kernel in INT8_WGMMA_KERNELS else ())


def build_kernels():
    """One nvcc per source, all started together; ptxas's registers and
    spills per kernel, from the compilers' logs. Fails if an instance in
    PINNED_REGISTERS spills or takes more registers than its cap. Returns
    the registers and spills of FORWARD_INSTANCES, of BACKWARD_PAIRS
    ({"dq": ..., "dkv": ...}) and of GEMM_INSTANCES, by kernel name."""
    from vap_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{[os.path.relpath(p, HERE) for p in libs.values()]}")
    seen = {}
    for lib in libs.values():
        kernel_name = "?"
        for line in lib.with_suffix(".log").read_text().splitlines():
            # the mangled name, and its template arguments if any
            found = re.search(r"\d+([a-z0-9_]+_kernel)(?:I(\w*?)EEv)?", line)
            if "Compiling entry function" in line and found:
                kernel_name = found[1] + (f"<{found[2]}>" if found[2] else "")
            elif "registers" in line or "spill stores" in line:
                log(f"  ptxas {kernel_name}: {line.replace('ptxas info    :', '').strip()}")
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill stores", r"(\d+) bytes spill stores")):
                    if re.search(pat, line):
                        seen.setdefault(kernel_name, {})[key] = int(re.search(pat, line)[1])
    held = {}
    for kernel_name, cap in PINNED_REGISTERS.items():
        # the logged names carry the mangled prefix of the anonymous namespace
        got = next((v for k, v in seen.items() if k.endswith(kernel_name)), {})
        held[kernel_name] = got
        if got.get("registers", cap + 1) > cap or got.get("spill stores", 1) != 0:
            raise AssertionError(f"ptxas gave {kernel_name} {got}: it must take at most {cap} "
                                 f"registers and no spill")
    log(f"  occupancy held: {held}")
    log("  backward instances: " + ", ".join(
        f"{name} {next((v for k, v in seen.items() if k.endswith(name)), {})}"
        for name in BACKWARD_INSTANCES))
    forward = {name: next((v for k, v in seen.items() if k.endswith(instance)), {})
               for name, instance in FORWARD_INSTANCES.items()}
    log("  forward instances (K1, K4 with K7, K8 and K2 with K7 at D=64 and D=128): " + ", ".join(
        f"{name} {got}" for name, got in forward.items()))
    for name, parts in {**BACKWARD_PAIRS, **GEMM_INSTANCES}.items():
        forward[name] = {part: next((v for k, v in seen.items() if k.endswith(instance)), {})
                         for part, instance in parts.items()}
    # ptxas serialises a wgmma kernel's products when another instruction
    # defines a wgmma input while products are in flight (warning C7513) or
    # registers run short (C7512): any such warning in a wgmma source's log
    # fails the build
    for source, kernels in WGMMA_KERNELS.items():
        hits = serialised_wgmma(libs[source].with_suffix(".log").read_text(), kernels)
        if hits:
            raise AssertionError(f"{source}: ptxas serialised the wgmma (C751x) of " + "; ".join(
                f"{kernel}: {line}" for kernel, line in hits))
    # each wgmma kernel's SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        for source, kernels in WGMMA_KERNELS.items():
            sass = subprocess.run([cuobjdump, "-sass", str(libs[source])], capture_output=True,
                                  text=True, check=True, timeout=120).stdout
            functions = re.split(r"\n\s*Function : ", sass)[1:]
            for kernel in kernels:
                body = next((f for f in functions if kernel in f.split("\n", 1)[0]), "")
                need = sass_needs(kernel)
                ops = {op: len(re.findall(rf"\b{op}\.", body)) for op in need}
                conv = ({op: len(re.findall(rf"\b{op}[.\s]", body)) for op in ("I2F", "I2FP")}
                        if kernel in INT8_WGMMA_KERNELS else {})
                log(f"  {kernel}: SASS instructions {ops}" + (f", conversions {conv}" if conv else ""))
                if not all(ops.values()):
                    raise AssertionError(f"{kernel}: no {'/'.join(need)} in its SASS: {ops}")
    else:
        log(f"  no cuobjdump: the SASS of {list(WGMMA_KERNELS)} is not checked")
    return forward


def main():
    import gc

    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only on the GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = power_line()
    log(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    sys.path.insert(0, HERE)
    import vap_tpu_torch

    if not os.path.abspath(vap_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit(f"chip_smoke: vap_tpu_torch comes from {vap_tpu_torch.__file__}, "
                         f"not from this checkout")
    t_start = SMOKE_START[0] = time.perf_counter()

    # 2. build
    registers = build_kernels()

    # 3. kernel parity
    log("kernel parity (bf16, vs plain PyTorch):")
    results = kernel_parity(dev)
    log("K2's pre-pass (sage_quant) parity (vs plain PyTorch's sage_quantize):")
    results["sage_quant"] = prepass_parity(dev)
    log("W8A8 (K3) parity (vs plain PyTorch), at CogVideoX's and Wan's projections:")
    results.update(w8a8_parity(dev))
    log("GEMM rate probe (K9, K10) parity (vs plain PyTorch):")
    results.update(probe_parity(dev))
    log("the rate probe's entry point (linear_bench --impl diag):")
    launches = rate_probe_path()
    kv_len = hunyuan_kv_len()
    log(f"K7, the varlen forward, parity (bf16, vs plain PyTorch; Hunyuan's {kv_len} valid keys "
        f"of {HUNYUAN_SHAPE[2]}):")
    results.update(varlen_parity(dev, kv_len))
    train_kv_len = hunyuan_kv_len(HUNYUAN_TRAIN_IMAGE_TOKENS)
    log("K8, the packed-segment forward, parity (bf16, vs plain PyTorch), and the ring body on "
        "one card:")
    results.update(segmented_parity(dev, train_kv_len, registers))
    log("K8's backward (K5 and K6 given segment ids) parity (bf16, vs plain PyTorch):")
    results.update(segmented_backward_parity(dev, train_kv_len, registers))
    log(f"sequence-parallel attention's step on one card, the ring over {RING_BLOCKS} key "
        f"blocks, forward and backward (the path K8 takes in sequence-parallel training):")
    ring_bwd_launches, ring_bwd_err = ring_backward_path(dev, train_kv_len)
    for name in SEG_BWD_SPECS:
        launches[name] = ring_bwd_launches[name]
        results[name]["ring_body_backward_max_rel_err"] = ring_bwd_err

    # 4-5. CogVideoX
    host_memory("before 4")
    streamed = {}
    log("small pipeline check:")
    small_pipeline_check(dev)
    log("small W8A8 pipeline check (DPM, adaptive step cache):")
    small_w8a8_check(dev)
    log("small pipeline, the other sampling modes:")
    small_modes_check(dev)
    pipe = build_main_pipeline(dev)
    log(f"main path, flash ({NUM_FRAMES} frames, {STEPS} steps):")
    launches["flash_fwd"] = main_path(pipe, "flash", STEPS, dev)
    log(f"main path, sage ({NUM_FRAMES} frames, 1 step):")
    launches["sage_fwd"] = main_path(pipe, "sage", 1, dev)
    launches["sage_quant"] = read_counts()["sage_quant"]  # K2's pre-pass in that run
    # the phases this slice added (the tiled encode, 5d, 5e, 6d), timed together
    t0 = time.perf_counter()
    log(f"the tiled VAE encode of the main path's reference video ({NUM_FRAMES} frames of "
        f"{HEIGHT}x{WIDTH}):")
    tiled_encode_path(pipe.vae, dev)
    slice_seconds = time.perf_counter() - t0
    # before the bench configuration, which quantises the pipeline in place
    log(f"main path under ring, one-rank NCCL group ({NUM_FRAMES} frames, {RING_STEPS} step, "
        f"latents):")
    ring_main_path(pipe, dev)
    # K8's forward is on no model's path (the ring generation step reads 0):
    # its launches are those of the sequence-parallel attention step above
    for name in SEG_SPECS:
        launches[name] = ring_bwd_launches[name]
    # 5c, before the bench configuration quantises the pipeline in place
    log(f"checkpoint out: the main path's latents under flash ({STEPS} steps), then the "
        f"pipeline's transformer, VAE and T5 written as a diffusers-layout directory:")
    t0 = time.perf_counter()
    ckpt_root, ckpt_bytes, want_flash = checkpoint_write_path(pipe, dev)
    ckpt_seconds = time.perf_counter() - t0
    log(f"bench configuration, sage + W8A8 ({NUM_FRAMES} frames, {BENCH_STEPS} steps, "
        f"step cache {BENCH_CACHE}):")
    launches["w8a8"] = bench_config_path(pipe, dev)
    t0 = time.perf_counter()
    want_bench = bench_latents(pipe)
    del pipe
    torch.cuda.empty_cache()
    log(f"checkpoint in: build_pipeline from that directory, then the main path's call under "
        f"flash ({STEPS} steps) and one step of the bench configuration (sage, W8A8), latents "
        f"against the resident pipeline's:")
    checkpoint_load_path(ckpt_root, ckpt_bytes, want_flash, want_bench, dev)
    ckpt_seconds += time.perf_counter() - t0
    host_memory("before 5d")
    t0 = time.perf_counter()
    log(f"streamed block offload (5d): build_pipeline from that directory with "
        f"offload_blocks_chunk={COG_STREAM_CHUNK}, the main path's call under flash ({STEPS} "
        f"steps, latents) with the blocks streamed, against the resident pipeline's:")
    streamed["cogvideox"] = streamed_cog_path(ckpt_root, ckpt_bytes, want_flash, dev)
    shutil.rmtree(ckpt_root)
    torch.cuda.empty_cache()
    host_memory("after 5d")
    log(f"CogVideoX 1.5 VAP (5e; {COG15_FRAMES} frames of {COG15_HEIGHT}x{COG15_WIDTH}, 1 step "
        f"under flash, decoded):")
    cog15 = cog15_path(dev)
    slice_seconds += time.perf_counter() - t0
    results["flash_fwd"]["cog15_joint_max_abs_err"] = cog15["k1_max_abs_err"]
    results["flash_fwd"]["max_abs_err"] = max(results["flash_fwd"]["max_abs_err"],
                                              cog15["k1_max_abs_err"])
    host_memory("after 5e")

    # 6. Wan
    host_memory("before 6")
    log("small Wan pipeline check:")
    wan_small_check(dev)
    torch.cuda.empty_cache()
    pipe = build_wan_pipeline(dev)
    log(f"Wan main path, flash ({NUM_FRAMES} frames of {WAN_HEIGHT}x{WAN_WIDTH}, {WAN_STEPS} steps):")
    with LastLatents(pipe) as flash_run:
        launches["flash_fwd_d128"] = wan_main_path(pipe, "flash", WAN_STEPS, dev)
    log(f"Wan main path, sage ({NUM_FRAMES} frames, 1 step):")
    launches["sage_fwd_d128"] = wan_main_path(pipe, "sage", 1, dev)
    # 6d, before the bench configuration quantises the blocks in place
    t0 = time.perf_counter()
    log(f"Wan streamed block offload (6d): the same {WAN_STEPS} flash steps with "
        f"offload_blocks_chunk={WAN_STREAM_CHUNK}, latents against the resident run's:")
    streamed["wan"] = wan_streamed_path(pipe, flash_run.latents, dev)
    slice_seconds += time.perf_counter() - t0
    host_memory("after 6d")
    log(f"the phases of streamed offload, CogVideoX 1.5 and the tiled encode (5d, 5e, 6d, the "
        f"tiled encode): {slice_seconds:.1f} s in all; streamed peaks "
        f"{ {k: round(v['peak_gib'], 2) for k, v in streamed.items()} } GiB, CogVideoX 1.5 "
        f"step {cog15['step_s']:.2f} s")
    # 6c's transformer, before the bench configuration quantises phase 6's in place
    cut = wan_cut_transformer(pipe.transformer, dev)
    log(f"Wan bench configuration, sage + W8A8 + UniPC ({NUM_FRAMES} frames, {BENCH_STEPS} "
        f"steps, step cache {BENCH_CACHE}):")
    launches["w8a8_wan"] = wan_bench_path(pipe, dev)
    log(f"Wan checkpoint out (6c): the first {WAN_CKPT_LAYERS} blocks of that transformer with "
        f"its UMT5, CLIP and VAE, their latents under flash (1 step), then written as a "
        f"diffusers-layout directory:")
    t0 = time.perf_counter()
    wan_root, wan_bytes, want_wan = wan_checkpoint_write_path(pipe, cut, dev)
    del pipe, cut
    torch.cuda.empty_cache()
    host_memory("before 6c's load")
    log("Wan checkpoint in (6c): wan_vap.build_pipeline from that directory, latents against the "
        "resident pipeline's:")
    # UMT5, CLIP and the VAE, read back, stay in host memory for phase 10b
    wan_parts = wan_checkpoint_load_path(wan_root, wan_bytes, want_wan, dev)
    ckpt_seconds += time.perf_counter() - t0
    torch.cuda.empty_cache()
    host_memory("before 7")

    # 7. K5
    log("flash backward parity (bf16, vs plain PyTorch):")
    results["flash_bwd"] = backward_parity(dev)

    # 8. training
    host_memory("before 8")
    log(f"training, CogVideoX-5B VAP from clips on disk ({NUM_FRAMES} frames of {HEIGHT}x"
        f"{WIDTH}, batch 1, {TRAIN_STEPS} optimizer steps, then validation, {VAL_STEPS} DDIM "
        f"steps):")
    launches["flash_bwd"], seconds, dpo, opt8, sharded = training_path(dev)
    results["flash_bwd"]["adamw_8bit"] = opt8
    results["flash_bwd"]["sharded_step"] = sharded
    ckpt_seconds += seconds
    log("K1 and K5 at the DPO step's batch of 2 (bf16, vs plain PyTorch, both rows):")
    results["flash_bwd"]["batch2_max_abs_err"] = k5_batch2_parity(dev)
    results["flash_bwd"]["dpo_step"] = dpo
    host_memory("before 8b")
    log("the data path at tiny widths (8b): CogVideoX online and under enable_precomputation, "
        "Wan VAP and the HunyuanVideo LoRA from clips, each validated:")
    data_small_check(dev)
    log("the training objectives at tiny widths (8b): the single-branch ablations, "
        "baseline_single_condition, the plain CogVideoX LoRA, reference_independent, "
        "CogVideoX 1.5, a DPO resume and Wan DPO:")
    objectives_small_check(dev)

    # 9. K6
    log("flash backward at head_dim 128 (K6) parity (bf16, vs plain PyTorch):")
    results["flash_bwd_d128"] = backward_parity(dev, d128=True)
    log(f"K7's backward (K6 and K5 given kv_lens) parity (bf16, vs plain PyTorch; Hunyuan "
        f"training's {train_kv_len} valid keys of {HUNYUAN_TRAIN_SHAPE[2]}):")
    bwd_results, forward_errs = varlen_backward_parity(dev, train_kv_len)
    results.update(bwd_results)
    for name, err in forward_errs.items():  # K7's forward at the training shape as well
        results[name]["train_shape_max_abs_err"] = err
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    # 9c. the Wan control recipe (UMT5 and the VAE of 6c, on the card for the phase)
    host_memory("before 9c")
    t0 = time.perf_counter()
    log(f"K6 at the control path's self-attention {CONTROL_ATTN} (bf16, vs plain PyTorch):")
    results["flash_bwd_d128"]["control"] = control_k6_parity(dev)
    log(f"training, the Wan control recipe: Wan2.1-T2V-1.3B widened to 33 channels, "
        f"control_lora from clips ({NUM_FRAMES} frames of {WAN_HEIGHT}x{WAN_WIDTH}, batch 1, "
        f"{TRAIN_STEPS} steps, then validation, {CONTROL_VAL_STEPS} FlowMatch steps at CFG "
        f"batch 2, decoded); remat {', '.join(REMAT_MODES)} against full; "
        f"control_full_finetune under adafactor:")
    control = control_training_path(dev, wan_parts)
    results["flash_fwd_d128"]["control_launches"] = control["k4"]
    results["flash_bwd_d128"]["control_launches"] = control["k6"]
    results["flash_bwd_d128"]["control_recipe"] = control
    log(f"  phase 9c: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 10. Wan LoRA training
    host_memory("before 10")
    log(f"training, Wan2.1-I2V-14B LoRA ({NUM_FRAMES} frames of {WAN_HEIGHT}x{WAN_WIDTH}, "
        f"batch 1, {TRAIN_STEPS} optimizer steps):")
    launches["flash_bwd_d128"], model, peft, ring = wan_training_path(dev)
    results["flash_bwd_d128"]["ring_profiled_step"] = ring
    torch.cuda.empty_cache()
    host_memory("before 10b")
    log(f"plain Wan I2V sampling of the trained LoRA model ({NUM_FRAMES} frames of "
        f"{WAN_HEIGHT}x{WAN_WIDTH}, UniPC, {WAN_STEPS} steps, latents):")
    wan_plain_sampling_path(model, wan_parts, dev)
    log("the LoRA model's PEFT file merged into its frozen base (10c):")
    t0 = time.perf_counter()
    lora_merge_check(model, peft, dev)
    shutil.rmtree(os.path.dirname(peft))
    ckpt_seconds += time.perf_counter() - t0
    log("one step of the LoRA trainer over that model's base in float8_e4m3fn storage (10d):")
    results["flash_bwd_d128"]["float8_storage"] = wan_float8_check(
        model, dev, os.path.join(HERE, "build", "chip_smoke_wan_float8"))
    log(f"checkpoint phase (5c, 6c, 8's export, 10's PEFT file and 10c): {ckpt_seconds:.1f} s "
        f"in all")
    del model, wan_parts
    torch.cuda.empty_cache()
    host_memory("before 11")

    # 11. HunyuanVideo
    log("small Hunyuan pipeline check:")
    hunyuan_small_check(dev)
    torch.cuda.empty_cache()
    pipe = build_hunyuan_pipeline(dev)
    log(f"Hunyuan main path, flash ({HUNYUAN_FRAMES} frames of {HUNYUAN_HEIGHT}x{HUNYUAN_WIDTH}, "
        f"{HUNYUAN_STEPS} steps):")
    launches["flash_fwd_d128_varlen"] = hunyuan_path(pipe, "flash", HUNYUAN_STEPS, dev, kv_len)
    log(f"Hunyuan main path, sage ({HUNYUAN_FRAMES} frames, 1 step):")
    launches["sage_fwd_d128_varlen"] = hunyuan_path(pipe, "sage", 1, dev, kv_len)
    # the transformer and the VAE go on to phases 12-13; the text encoders
    # and the offload slot's host copies go with the pipeline
    transformer, vae = pipe.transformer, pipe.vae
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # 12. the Hunyuan VAE encode
    log(f"Hunyuan VAE encode ({HUNYUAN_TRAIN_FRAMES} frames of {HUNYUAN_TRAIN_HEIGHT}x"
        f"{HUNYUAN_TRAIN_WIDTH}):")
    latents = hunyuan_encode_path(vae, dev)
    del vae
    gc.collect()

    # 13. HunyuanVideo LoRA training
    log(f"training, HunyuanVideo LoRA ({HUNYUAN_TRAIN_FRAMES} frames of {HUNYUAN_TRAIN_HEIGHT}x"
        f"{HUNYUAN_TRAIN_WIDTH}, batch 1, {TRAIN_STEPS} optimizer steps):")
    train_launches, ring = hunyuan_training_path(transformer, latents, dev)
    results["flash_bwd_d128_varlen"]["ring_profiled_step"] = ring
    launches["flash_bwd_d128_varlen"] = train_launches["flash_bwd_d128_varlen"]
    # K7's backward in K5 is held, on no model's path: the run checked its count is 0
    launches["flash_bwd_varlen"] = train_launches["flash_bwd_varlen"]
    del transformer
    host_memory("at the end")
    log(f"smoke: {time.perf_counter() - t_start:.1f} s after start-up")

    # the wgmma kernels' registers (their K7 forms are the same kernels)
    for name, kernel in (("flash_fwd", "flash_fwd"), ("flash_bwd", "flash_bwd"),
                         ("flash_bwd_varlen", "flash_bwd"),
                         ("flash_fwd_d128", "flash_fwd_d128"), ("flash_bwd_d128", "flash_bwd_d128"),
                         ("flash_fwd_d128_varlen", "flash_fwd_d128"),
                         ("flash_bwd_d128_varlen", "flash_bwd_d128"), ("sage_fwd", "sage_fwd"),
                         ("sage_fwd_d128", "sage_fwd_d128"),
                         ("sage_fwd_d128_varlen", "sage_fwd_d128")):
        results[name]["registers"] = registers[kernel]
    for name in GEMM_INSTANCES:  # K3's GEMM, K9's and K10's kernels
        results[name]["registers"] = registers[name]
    results["w8a8_wan"]["registers"] = registers["w8a8"]
    specs = {**kernel_specs(), **PREPASS_SPECS, **BWD_SPECS, **W8A8_SPECS, **VARLEN_SPECS,
             **VARLEN_BWD_SPECS, **SEG_SPECS, **SEG_BWD_SPECS}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
         "launches": launches[name], **results[name]} for name, spec in specs.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
