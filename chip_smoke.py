"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # one card

Phases, in this order (each prints its own lines; any failure exits
non-zero):
  device      - the card's name and power limit; TF32 off for fp32 references
  build       - nvcc builds the kernels from qwen3_tts_tpu_torch/csrc/, one
                process per source, in parallel, while this process writes
                the 0.6B dir; then one spawned child process (DirWriter)
                writes the later phases' dirs (the pre-quantized, modes and
                verify 0.6B dirs, the 1.7B dir and its 4-bit packed copy) while
                the phases before them run, and each of those phases waits
                for its dir
  megakernels - K1 (talker step, C = 260 with a wrapped ring, a trimmed
                window of ~200 slots and one of 3 slots), K2 (code-predictor
                frame, with and without the repetition penalty) and K2g
                (Gumbel sampler: same draws as its plain version, chi-square
                of 100k draws) at 0.6B; K1 and K2 are each one persistent
                cooperative launch: their grids and shared memory, one device
                kernel per call (profiler), repeated runs bit-identical, the
                weight bytes per second they reach, the cost of one grid
                barrier (a launch of n barriers) times the barriers a step
                and a frame make; K2's time at temperature 0 (no noise
                drawn) and 0.85, in turns
  kernels     - K3, K4, K4a, K5, K6, K7 and the SEANet blocks' upsample
                against their plain PyTorch versions at the 0.6B main path's
                shapes, fp32 and bf16, with times and bounds (K3 at M = 1,
                2, 3, 4, 8, 16, 64, 300 and 512, the text projection's 114;
                K7 at 4 and 6 bits on the mixed mode's linears, and one 2-,
                3- and 8-bit shape, each at M = 1, 2, 3, 4, 8, 16 and 300,
                and the 4-bit text projection at 114; only the M = 1, 3,
                114 and 300 calls (and K3's 2 and 64) summed in the kernels
                line, as before); on either side of M0 two calls
                bit-identical; each bf16 call at M <= 16 also timed cold
                (one CUDA graph of a call per copy of the weights, the
                copies over 64 MB, so that the 50 MB L2 holds none of them
                when its call comes) beside its warm time (a graph of one
                call), its bound and the floor of an empty launch timed the
                same cold way; K7's 4-bit product beside its library call,
                torch._weight_int4pack_mm, at M = 1 gate/up, o and down and
                the text projection at 3 and 114 (held against K7's
                output), both timed warm and (M <= 16) cold; one device
                kernel a call (profiler) for the GEMV and the tile, and a
                dense bf16 torch.matmul of the same shape as a yardstick
                past M0; K3 and K7 at every width and group size, with and
                without biases, at ragged shapes, on both sides of M0;
                M0's sweep, the GEMV against the tile, both cold, over the
                serving step's and the text projection's shapes for M = 1,
                2, 3, 4, 8 and 16, logged beside each wrapper's M0; K4a at T = 26 and
                110, B = 1 and 2, and at T = 300, also against K4 on the
                same weights (bf16: bit for bit, the same persistent launch;
                fp32: the exact sequences), one device kernel a call with
                bf16 weights (profiler); K4, K5 and K6 with bf16 weights (the
                persistent launches and the tensor-core conv) at T = 26 and
                110 (K4, K6 also B = 2; K4, K5, K6 and the blocks' upsample
                also at B = 8, at a serve window's T = 26 and at
                generate_many's T = 110; K5 from fp32 and bf16 input), their
                TFLOP/s (K5 also its share of the bytes bound), K4's and
                K5's event against their profiler device time and one
                device kernel a call; the blocks' upsample (the 2-tap
                tensor-core conv) at blocks 0-3, at K6's shapes; and one
                bf16 torch conv1d of block 0's first 7-tap conv beside K6's
                launch of it, as a yardstick for the tile (the port never
                calls conv1d); at B = 32's shapes (b32_kernels, the kernels
                line's "at_b32"): K4, K5 and every block's upsample and K6
                at B = 32 for T = 26 and 48, K6 and the upsample on block 3
                at 40 and 64 rows of T = 110 (past the old 65,535-tile grid
                cap: one launch a conv, rows 0, 38, 39, 40 and the last
                against the plain versions), K3 and K7 (4 / 6 bits) at M =
                32 and 64 on the step's linears, warm, K7's 4-bit calls
                beside torch._weight_int4pack_mm
  fused-pretransformer - K4a's own entry point, pre_transformer_fused, on
                the 0.6B vocoder's pre-transformer (no pipeline path runs
                it, in this port or in the JAX package): launch counts, and
                its outputs equal K4's on the same weights
  sampler     - K2g's own entry point, gumbel_sample, on the code
                predictor's 2048 logits: a frame's 15 draws, sampled and
                greedy, from fp32 and bf16 logits and from a row 4 bytes
                off 16-byte alignment (no pipeline path launches
                its kernel: K2 makes the draws with its device function
                inside its own launch): launch counts
  pipeline    - the default configuration (megakernels on): a random-weight
                0.6B model dir, Qwen3TTSPipeline in bf16, generate() and
                generate_stream(); checks the audio and that K1, K2,
                K3 (text projection), K4, K5, K6 and the blocks' upsample ran
                (K2g's kernel not, its draws made inside K2); generate.
                prefill's ms (in every pipeline phase); K3 timed at the
                text projection's own shapes; a decode chunk with no
                host sync; K1/K2 against their plain versions teacher-forced
                over the first TF_FRAMES (16) generated frames; the kernel
                vocoder against the plain one, with fp32 and with bf16
                kernel weights; the
                device time of a 26-frame and a 110-frame vocoder window by
                kernel; a profile of the frame loop
  serving     - batched lockstep serving on the pipeline phase's model
                (megakernel configuration's weights; the batched path drops
                the megakernels and runs the `w8r` product at M = B):
                generate_many on 8 texts of different lengths at
                temperature 0 and 0.85 (SERVE_TOKENS, 48 frames a
                stream), generate_many_stream on the 8
                (batch_size=8) and on 6 through 4 slots (2 admitted
                mid-flight); each lockstep step one CUDA graph replay; the
                audio checked, K4, K5, K6, the blocks' upsample and K3 (text
                projection) launched, K1 and K2 not; every stream vocoder
                call [batch_size, 16, 26]; then the step at B = 1, 8, 16 and
                32 by graph and eagerly (wall; the graph's device time at
                8 and 32, the eager step's at 32; capture s, graph pool
                bytes, frames/s), the graph against the eager step at
                temperature 0 (same frames and state), and B = 8 against
                B = 1 teacher-forced (TOL_BATCH, no code-0 flip outside a
                near-tie); the `w8r` product against the fp32 product it
                replaced (TF32 off) at the step's shapes, M = 8
  serving-32  - the same model at B = 32, the JAX package's serving batch:
                generate_many of 32 texts at T = 0.85 and MANY_32_TOKENS
                (120) frames, its one vocoder call at least 40 rows of 110
                frames (past K6's old grid cap), generate_many_stream of
                the 32 at batch_size=32 ([32, 16, 26] windows), the audio
                checked, K3-K6 and the upsample launched, K1 / K2 not; the
                `w8r` product at M = 32; the B = 32 graph bit for bit its
                eager step; B = 32 against B = 1 teacher-forced over 8
                steps beside the fp32 twin (BATCH_ROUNDING's checks)
  service-32  - server.serve(batch_size=32, warmup=True) on the same model:
                a burst of 32 streamed requests of 48 frames at T = 0, every
                response well formed, /stats identities after the drain, no
                capture after warmup, K1 / K2 idle, streams 0 and 31
                teacher-forced against B = 1 beside the fp32 twin; first
                PCM byte (min, median, max), burst RTF
  k3-pipeline - the same with the megakernels off (every linear on K3),
                4 frames (host-bound: few, for the script's time); then 16
                lockstep steps at B = 8 from one graph (K3's
                wrapper counts the warm-up and the capture, twice a step's
                launches at M = 8 and 16; the replays' K3 kernels are
                counted by name in a profile of 5 replays: a step's
                launches each)
  k3-serving-32 - the K3 step at B = 32: 428 K3 a step, all past M0 on the
                tile (M = 32, 64 on the code predictor's first pass) in the
                graph, counted at the wrapper (twice a step's) and by the
                tile's name in 5 replays; the step's times; B = 32 against
                B = 1 beside the fp32 twin; the graph bit for bit its eager
                step
  mixed-pipeline - runtime_quantization_mode="mixed_4_6" with the
                megakernels off on the same dir, 4 frames: every talker and
                code-predictor linear on K7 at 4 or 6 bits, K1-K3 idle, K7's
                launches a decoded frame equal to the tree's packed linears
                (428); a decode chunk with no host sync, a profile of the
                frame loop (K7's kernels a frame by name: one name a bit
                width and row tile), and the prefill logits with K7 against
                those with its plain version swapped in, in a bf16 model and
                in its fp32 twin (the same trees widened: what an fp32 load
                builds)
  mixed-serving - the mixed pipeline batched: 16 lockstep steps at B = 8
                from one graph with every linear on K7 at M = 8 (K7's
                wrapper counts the warm-up and the capture, twice a step's
                428 launches; the replays' K7 kernels counted by name in a
                profile of 5 replays), the step's times, B = 8 against
                B = 1 beside the fp32 twin, the graph bit for bit the eager
                step, generate_many of 8 texts at temperature 0.85
  mixed-serving-32 - the same at B = 32: 428 K7 a step on the tile at 4 and
                6 bits, as k3-serving-32
  prequant-pipeline - a 0.6B dir pre-quantized to 4 bits, group 64 (MLX's
                layout, written by write_prequantized_model_dir), in the
                default configuration: K1, K2, K7 (text projection),
                K4-K6 ran and K3 and K2g's kernel did not; a decode chunk with no host sync
                (packed embedding gathers in the frame loop); K7 timed at
                the text projection's own shapes; K1/K2
                teacher-forced on the kernel trees built from packed weights
                (TF_FRAMES frames); a profile of the frame loop
  modes-pipeline - a 0.6B dir with the speaker and audio encoders at full
                width, default configuration: generate_voice_design,
                generate_custom_voice, a streamed VoiceDesign run, a speaker
                embedding and reference codes of a 5 s clip it generated
                (held against the port's CPU run in fp32), generate with that
                embedding, generate_icl, generate_batch on three sentences,
                generate_to_file, warmup; RTF per mode, encoder times,
                resident bytes, and K1, K2, K3, K4, K5, K6 and the blocks'
                upsample launched,
                K2g's kernel, K4a and K7 not
  service-modes - the always-on service over HTTP on localhost with the
                voice modes, on the modes-pipeline phase's pipeline (no
                second load; its talker, code predictor and vocoder are the
                pipeline phase's, the same seed): server.serve(batch_size=8,
                warmup=True), then the mode burst into the idle batch
                (testing.MODE_BURST: two VoiceDesign descriptions of different
                token lengths, two CustomVoice requests, a speaker-embedding
                clone and an ICL request from a 5 s clip of its VoiceDesign
                audio sent as base64 WAV, an OpenAI-route request with
                `instructions`, a built-in speaker; 48 streamed frames each
                at temperature 0), then, while two long requests keep the
                batch running, 4 staggered arrivals (one at 0.85), a client
                that hangs up after its first audio, a /v1/audio/speech pcm
                request and a /tts_many of 2 texts beside the busy service;
                every response well formed, /stats identities after the
                drain (one cancel, no failure, no restart), the graphs of
                the service's keys unchanged by the traffic, K3-K6 and the
                blocks' upsample launched and K1 / K2 not, each burst
                stream teacher-forced against B = 1 with BATCH_ROUNDING's
                checks (the fp32 twin's B = 8 against its B = 1 at
                TOL["float32"], bf16 under the derived bound, near ties
                judged on the twin's scores), the service's greedy graph
                bit for bit its eager step on the burst's mixed batch;
                first PCM byte per request and by mode, serving RTF and
                frames/s over the burst, warmup seconds; an ICL
                request on a 9 s clip (its prompt past the default 128-row
                bucket) refused at submit with the JAX service's message,
                then served by a service at the first prompt bucket that
                holds it (ring capacity bucket + RING_SLACK)
  verify      - the checkpoint tools at full width: write_golden_model_dir
                at 0.6B (packed at 4 / 6 / 8 bits, group 64, dense
                stragglers, both encoders at full width); the audit script
                passes on it; collect_report's exact report on the card
                (fp32, TF32 off, kernels off) is the golden; the production
                report (default configuration, bf16: K1, K2, K7, K4-K6 and
                the blocks' upsample launched, K2g's and K4a's own entry
                points not) passes tpu-bf16 and fails cpu-fp32, each
                checksum's error beside its limit, and the golden frames
                through the production vocoder pass; codec_head.scales x1.5
                fails tpu-bf16; speech_tokenizer_decode at B = 2 (one
                stream padded) with the kernels against the plain vocoder;
                decode_chunk_batched at B = 4 with the megakernels off (K7
                at M = 4 on the codec head: the loader dequantizes the
                layers, whose q / k / v, gate / up and layers differ in
                width) against four single-stream chunks, greedy, a
                departure allowed only at a near-tie, and its device ms a
                chunk; the native BPE core against the Python path; a
                PhaseTimer over the stages and a trace() window over one
                vocoder decode
  tp          - tensor-parallel inference at 0.6B, full width and depth, in
                the dense bf16 configuration (no runtime quantization, K1
                off): two spawned ranks share the card over gloo at tp = 2
                (8 / 4 heads and 1,536 MLP columns a rank); generate() of
                8 greedy frames on every rank (K2 once a frame on each, K4,
                K5, K6 and the blocks' upsample on the vocode), teacher-
                forced against the unsharded run (TOL_TP; the same weights
                in fp32 at TOL["float32"]), free-running departures only at
                a near tie (code 0 within NEAR_TIE, a code-predictor code
                within NEAR_TIE_CP); the serving cycle at B = 8
                (two 4-step chunks, park_slot, admit_stream, a chunk), eager,
                teacher-forced against the unsharded eager step; a dp
                vocode of codes [8, 16, 110] split 4 + 4 against the
                unsharded decode; TTSService with rank 0 serving and rank 1
                following (a burst of 3, one arrival into the running batch,
                12 frames each) against the unsharded service; ms a frame
                and a step with all-reduces counted, sharded and unsharded;
                a one-process NCCL tp = 1 mesh through the sharded code,
                its frames the unsharded run's; NCCL tp = 2 across cards
                when the machine has two or more (else said not run)
  train       - the joint TTS train step (parallel/train.py) at 0.6B, full
                depth, fp32 params from a seed, B = 2, T = 256, TF32 off:
                five steps with remat off and on (the loss finite and
                falling, the first step's loss equal), step ms, peak bytes,
                the matmul FLOPs' share of the fp32 peak; at full width and
                2 + 2 layers the step on the card against the card
                machine's CPU, shard_params and the step on a one-process
                NCCL (dp = 1, tp = 1) mesh against the plain step, and a
                checkpoint saved, restored bit for bit and resumed; no
                kernel of the port launched (dense torch matmuls and
                autograd, as the JAX step is dense jnp)
  1.7b        - the 1.7B model (Qwen3TTSConfig.standard_1_7b(): talker
                hidden 2048, intermediate 6144, the 1024-wide code predictor
                through small_to_mtp_projection), random weights from seed
                0 in bf16, full depth, default configuration:
                generate() and generate_stream() of 320 frames each (past
                the window's trims and the ring's wrap), the audio checked,
                K1 and K2 launched once a frame, K3 (text projection) and
                K4-K6 and the blocks' upsample, K7 and K2g's kernel not; K3
                at the text projection's shapes; K1 on the pipeline's tree
                (C = 260, window starts 99 and 297, fp32 and bf16) and K2
                with the projection (T = 0.85 with and without the penalty,
                and T = 0) against their plain versions at TOL_W8A8, their
                plans and bit-identical repeats (the one-kernel check is
                the megakernels phase's); the frame loop teacher-forced
                over frames 216-231 (a trim and the wrap); a profile of 8
                frames; K3 and K7 (4 and 6 bits) at every 1.7B linear and
                the text projection at M = 1, 3, 8, 9, 16 and 114, and K3
                and K7 4-bit at small_to_mtp_projection (2,048 -> 1,024) at M
                = 1, 2, 8, 16 and 32, fp32 and bf16, warm and cold, K7's
                4-bit calls beside torch._weight_int4pack_mm; K3 and K7 (4 and
                6 bits) at a B = 32 step's 1.7B shapes (every talker linear
                and the projection at M = 32 and 64, bf16, warm, with
                their bounds; K7 4-bit beside torch._weight_int4pack_mm);
                M0's sweep over
                the 1.7B shapes; the dir carries both encoders (the speaker
                encoder's enc_dim 2048, the talker's width)
  modes-1.7b  - every generation mode at 1.7B on the 1.7b phase's pipeline:
                VoiceDesign, CustomVoice, a streamed VoiceDesign (first
                audio), the 2048-wide x-vector of a 5 s clip and generate
                with it, generate_icl on that clip's codes, 96 frames each;
                RTF per mode, the encoders' seconds, K1 and K2 once a frame,
                K3 (text projection) and K4-K6 and the upsample launched, K7
                and K2g's kernel not; the x-vector against the card
                machine's CPU run in fp32
  serving-1.7b - the 1.7B model batched at the JAX package's serving
                widths (bench.py's B = 32 and its service at B = 16), on
                the 1.7b phase's dir and loaded pipeline (megakernel
                configuration's weights: the `w8r` product at M = B,
                small_to_mtp_projection on K3): generate_many on 32 texts at
                temperature 0.85 (120 frames, at least 40 vocoder rows in
                one call) and generate_many_stream at batch_size=32, the
                audio checked, K3 (projection, text projection) and K4-K6
                and the blocks' upsample launched, K1, K2, K2g's kernel and
                K7 not; the step at B = 1, 8 and 32 (wall, capture s, pool
                bytes; device time and kernels at B = 32), K3 15 launches a
                step (the projection: M = 2B once, then B; at B = 32 both on
                the tile), counted by the tile's name in a profile of 5
                replays at B = 32; the B = 32 graph bit for bit the eager
                step; B = 32 against B = 1 teacher-forced over 8 steps with
                BATCH_ROUNDING's checks (the same on an fp32 twin of the
                tree at TOL["float32"], bf16 at the larger of TOL_BATCH and
                the derived bound); the service over HTTP at bench.py's
                shape (batch_size=16, trailing_bucket=128, after warmup): a
                burst of 16 (the mode burst on a 5 s clip of the 1.7B
                model's own VoiceDesign speech and 8 built-in requests of
                bench.py's text, 40 streamed frames each at temperature 0),
                first PCM byte by mode, the modes' streams and two built-in
                ones against B = 1 beside the twin's prefill of the burst,
                near ties judged on its scores at the limit derived from
                the rounding it measures, the greedy graph bit for bit its
                eager step on the burst's mixed batch; then 12 long streams
                (320 frames, T = 0.9) keep the batch busy while 4 arrivals
                (two built-in, an x-vector clone and an ICL clone of the
                clip, 40 frames) come 2 s later, each arrival's first PCM
                byte by mode, then the long streams are cancelled; /stats
                identities (the cancellations counted, no slot active), no
                capture after warmup; one fp32 twin serves both parts; then
                the K3 configuration from the same dir: generate and
                generate_stream of 4 frames (K3's launches a decoded frame
                beside the 0.6B figure), 16 lockstep steps at B = 32 from
                one graph (443 K3 a step, all on the tile, counted by the
                tile's name in 5 replays), the graph bit for bit the eager
                step, B = 32 against B = 1 as above
  mixed-1.7b  - the 1.7B dir loaded runtime_quantization_mode="mixed_4_6"
                with the megakernels off: generate() and generate_stream() of
                4 frames, K7 443 launches a decoded frame (every talker and
                code-predictor linear, small_to_mtp_projection at 4 bits: M
                = 2 once a frame, then 1), K1-K3 idle; a profile of the frame
                loop; the prefill logits with K7 against its plain version in
                bf16 and on the fp32 twin; the lockstep step at B = 32 from
                one graph (443 K7 a step, all on the tile, the projection M
                = 64 once, then 32, counted by the tile's name in 5
                replays), B = 32 against B = 1 beside the twin, the graph
                bit for bit the eager step
  prequant-1.7b - a copy of the 1.7B dir packed to 4 bits, group 64 (MLX's
                layout, testing._pack_talker_weights), on the default
                configuration: generate() and generate_stream() of 96 frames
                with K1 and K2 built from the packed weights and launched
                once a frame, K7 in the text projection only, K3 and K2g's
                kernel idle; K7 timed at the text projection's shapes; K1 /
                K2 teacher-forced over TF_FRAMES (16); the resident bytes
                beside the int8 dir's; a profile of the frame loop; the `w8r`
                lockstep step at B = 8 from one graph with the projection on
                K7 (15 a step: M = 16 once, then 8, counted by name in 5
                replays), B = 8 against B = 1 beside the fp32 twin, the graph
                bit for bit the eager step
The line before the last is {"kernels": [...]} (each row with its launches on
every path: "launches" on the pipeline phase, "launches_<path>" on the
others, "launches_serving" on the serving runs, "launches_service_modes"
on service-modes' traffic and its long reference, "launches_modes_1_7b"
on the modes-1.7b phase's five runs, "launches_verify" on the verify
phase and
"launches_train" on the train phase, 0 for
every kernel, and "launches_tp" on the tp phase's generate() on rank 0, "launches_1_7b" on the
1.7b phase's generate() and generate_stream(), "launches_serving_1_7b" on the
serving-1.7b phase's counted runs summed (its serving run, the service's
traffic, the K3 configuration's pipeline and its lockstep graph's warm-up
and capture; each in "launches_serving_1_7b_by_run"), "launches_1_7b_b32"
on the 1.7B B = 32 runs summed (serving-1.7b's serving run, its K3 B = 32
graph's and mixed-1.7b's B = 32 graph's warm-up and capture),
"launches_service_1_7b_b16" on service-1.7b's traffic, "launches_mixed_serving"
on the mixed-serving phase's graph warm-up and capture and its
generate_many, "launches_mixed_1_7b" and "launches_prequant_1_7b" on those
phases' pipelines and lockstep graphs (each run in "..._by_run"),
"launches_serving_32" on the B = 32 runs summed (serving-32's counted run,
service-32's traffic, the K3 and mixed B = 32 graphs' warm-up and capture;
each in "launches_serving_32_by_run"):
the wrappers' calls, eager and captured, not the graph replays; the rows held
at the 1.7B shapes (K1, K2, K3, K7) also "at_1_7b", their error, times,
bounds and library time there, and max_abs_err over both models (K7's
also "shapes": each bf16 call at small_to_mtp_projection, M = 1-32, and
at the 1.7B linears at M = 8, warm, cold, bound and library); K7's
row also has its library call's time, torch._weight_int4pack_mm at its
4-bit shapes, beside its own there, warm and cold; K3's and K7's rows also
their GEMV's M = 1 main-path calls summed warm, cold and as a bound, the
cold floor, M0 and the sweep's M0; K3's, K7's, K4's, K5's, K6's and the
upsample's rows also "at_b32", each call at B = 32's shapes with its error,
times and bound, and K3's and K7's "at_1_7b_b32", the same at a B = 32
step's 1.7B shapes) and the last is {"ok": true, "device": {...}}.

Times: a call whose back-to-back CUDA-event time is under 50 us is timed
again by replaying a CUDA graph of it (device time, without Python's
dispatch); each kernel line says which method it used. Bounds: the larger of
the bytes a call must move over 3.35 TB/s and its operations over the
card's peak rate for their type (989 TFLOP/s bf16, 67 TFLOP/s fp32 outside
the tensor cores, 1,979 TOP/s int8).
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# fp32 tolerances: different summation orders over K <= 7 * 1536 terms in
# fp32 give rel RMS ~1e-6; bf16: outputs are rounded to bf16 (2^-9 relative)
# and both sides read the same bf16 weights
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# W8A8 (K1, K2): both sides quantize activations to int8, a discontinuous
# step. fp32 sums in another order put an activation on the other side of a
# rounding boundary about twice per 0.6B talker step; that moves the GEMV's
# output by ~1e-3 and every later layer then rounds its own activations
# apart. Measured on the card: K/V rows agree to ~1e-7 per layer up to the
# first such step (layer 16 of 28), then drift to 1.7e-2 by the last layer;
# logits 1.6e-2. So K1 is held to more than this limit (phase_megakernels):
# in fp32 its K/V rows must agree to ROW_TOL through layer 1, and a case
# with a 3-slot window gives the current token's own term a large weight.
TOL_W8A8 = {"float32": 5e-2, "bfloat16": 5e-2}
# K4a against K4 on the same weights. fp32: both are exact fp32 paths, sums
# in another order only. bf16: both are the same persistent launch, K4a
# reading its per-head arrays in place: the same items, K order and
# roundings, so the outputs are equal bit for bit.
K4A_VS_K4 = {"float32": 1e-4, "bfloat16": 0.0}
# The vocoder with bf16 kernel weights against the fp32 plain vocoder: bf16
# rounding of the weights and of every product's operands (2^-9 each) over
# ~25 products in a row (8 pre-transformer layers, 2 upsample stages, 4
# blocks of 3 units) adds up like a random walk to ~1e-2; held at 5x that.
TOL_VOCODER_BF16 = 5e-2
ROW_TOL = 1e-5  # K/V rows before any rounding step: fp32 sum order only
NEAR_TIE = 1e-2  # a code may differ only where the scores are this close
HBM = 3.35e12
RATE = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
KERNELS = {
    "int8_matmul": ("qwen3_tts_tpu_torch/csrc/quant_matmul.cu",
                    "qwen3_tts_tpu/ops/pallas/quant_matmul.py:221"),
    "pre_transformer": ("qwen3_tts_tpu_torch/csrc/pretransformer.cu",
                        "qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py:209"),
    "upsample_stage": ("qwen3_tts_tpu_torch/csrc/upsample.cu",
                       "qwen3_tts_tpu/ops/pallas/upsample_kernel.py:152"),
    "residual_units": ("qwen3_tts_tpu_torch/csrc/vocoder_units.cu",
                       "qwen3_tts_tpu/ops/pallas/vocoder_kernels.py:205"),
    "talker_step": ("qwen3_tts_tpu_torch/csrc/talker_step.cu",
                    "qwen3_tts_tpu/ops/pallas/talker_megakernel.py:50"),
    "cp_frame": ("qwen3_tts_tpu_torch/csrc/cp_frame.cu",
                 "qwen3_tts_tpu/ops/pallas/cp_megakernel.py:217"),
    "gumbel_sample": ("qwen3_tts_tpu_torch/csrc/cp_frame.cu",
                      "qwen3_tts_tpu/ops/pallas/cp_megakernel.py:185"),
    "packed_matmul": ("qwen3_tts_tpu_torch/csrc/packed_matmul.cu",
                      "qwen3_tts_tpu/ops/pallas/quant_matmul.py:93"),
    "pre_transformer_fused": ("qwen3_tts_tpu_torch/csrc/pretransformer.cu",
                              "qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py:51"),
    # the counterpart of plain XLA (seanet_block_fused's two products), not
    # of a Pallas kernel: K6's tensor-core conv with 2 taps
    "block_upsample": ("qwen3_tts_tpu_torch/csrc/vocoder_units.cu",
                       "qwen3_tts_tpu/ops/pallas/vocoder_kernels.py:410"),
}
PLAIN_XLA = {"block_upsample"}  # KERNELS entries that replace plain XLA code
# (K, O, M) where K7's 4-bit product is timed beside its library call: M = 1
# gate/up, o and down (the mixed mode's step), the text projection's fc1
# and fc2 at M = 3 and 114 (the pre-quantized prompt)
K7_LIBRARY_SHAPES = {(1024, 6144, 1), (2048, 1024, 1), (3072, 1024, 1), (2048, 2048, 3),
                     (2048, 1024, 3), (2048, 2048, 114), (2048, 1024, 114)}
TEXT = ("The quick brown fox jumps over the lazy dog, and then it runs far "
        "away into the quiet green forest.")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def counters() -> dict:
    """kernel name -> (wrapper module, name of its launch count)."""
    from qwen3_tts_tpu_torch.ops.cuda import (
        cp_megakernel,
        gumbel_sampler,
        packed_matmul,
        pretransformer_kernel,
        quant_matmul,
        talker_megakernel,
        upsample_kernel,
        vocoder_kernels,
    )

    return {"int8_matmul": (quant_matmul, "launches"),
            "pre_transformer": (pretransformer_kernel, "launches"),
            "upsample_stage": (upsample_kernel, "launches"),
            "residual_units": (vocoder_kernels, "launches"),
            "talker_step": (talker_megakernel, "launches"),
            "cp_frame": (cp_megakernel, "launches"),
            "gumbel_sample": (gumbel_sampler, "launches"),
            "packed_matmul": (packed_matmul, "launches"),
            "pre_transformer_fused": (pretransformer_kernel, "fused_launches"),
            "block_upsample": (vocoder_kernels, "upsample_launches")}


def reset_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def check_counts(label: str, launches: dict, need, idle) -> None:
    log(f"[{label}] kernel launches during this run: {launches}")
    missing = [k for k in need if not launches[k]]
    if missing or any(launches[k] for k in idle):
        raise SystemExit(f"[{label}] kernels not launched: {missing}, or launched where "
                         f"they should not be: {[k for k in idle if launches[k]]}")


def rel_rms(got, ref) -> float:
    g, r = got.double(), ref.double()
    return float(((g - r) ** 2).mean().sqrt() / (r ** 2).mean().sqrt().clamp_min(1e-30))


def _events_ms(fn) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int) -> tuple[float, str]:
    """(ms per call, method). Back-to-back calls between CUDA events; a call
    under 50 us reads the host's dispatch rate that way, so it is timed again
    by replaying a CUDA graph of one call (torch.profiler's device total if
    the call cannot be captured)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = _events_ms(lambda: [fn() for _ in range(iters)]) / iters
    if ms >= 0.05:
        return ms, "events"
    try:
        return graph_ms(fn, iters), "graph"
    except RuntimeError:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return device_us(prof) / 1e3 / iters, "profiler"


def device_us(prof) -> float:
    """Summed device time (us) of every kernel in a torch.profiler run."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return total


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least ms on the card, "bytes" or "operations") for `nbytes` moved and
    ops {type: count}."""
    t_bytes = nbytes / HBM
    t_ops = sum(n / RATE[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Record:
    """Worst error and summed times / bounds per kernel over its comparisons
    (times and bounds over the bf16 ones, the pipeline's working type);
    `tag` opens its log lines."""

    def __init__(self, tag: str = "kernels"):
        self.tag = tag
        self.rows = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "t_bytes": 0.0, "t_ops": 0.0, "library_ms": None} for k in KERNELS}
        self.b32: dict = {}  # kernel -> its calls at the B = 32 shapes (b32_kernels)

    def add(self, name, label, dtype, err, abs_err, tol, timing, plain_timing, nb, ops,
            extra="", timed=True):
        """`timed`: the call is the main path's, so its times and bound count
        in the kernel's row."""
        ok = err == err and err <= tol  # NaN fails
        (ms, how), (pms, phow) = timing, plain_timing
        b_ms, b_by = bound(nb, ops)
        log(f"[{self.tag}] {name} {label} {dtype}: rel_rms={err:.3e} (tol {tol:g}) "
            f"max_abs={abs_err:.3e}{extra} kernel {ms:.4f} ms ({how}) plain {pms:.4f} ms "
            f"({phow}) bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel {name} {label} {dtype} disagrees with its plain version")
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        if dtype == "bfloat16" and timed:
            row["ms"] += ms
            row["plain_ms"] += pms
            row["bound_ms"] += b_ms
            row["t_bytes"] += nb / HBM
            row["t_ops"] += sum(n / RATE[k] for k, n in ops.items())

    def compare(self, name, label, dtype, got, ref, timing, plain_timing, nb, ops, timed=True):
        import torch

        err = rel_rms(got.float(), ref.float())
        abs_err = float((got.float() - ref.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            err = float("nan")
        self.add(name, label, dtype, err, abs_err, TOL[dtype], timing, plain_timing, nb, ops,
                 timed=timed)

    def at_b32(self, name, label, got, ref, timing, plain_timing, nb, ops, rows_checked="all",
               dtype="bfloat16", **extra):
        """One call at B = 32 serving's shapes (the kernels line's
        "at_b32"), held against its plain version on rows_checked (its time
        is "plain_ms" only where that is every row); not counted in the
        kernel's row."""
        whole = rows_checked == "all"
        note = "" if whole else f"; the plain version on rows {rows_checked}"
        self.compare(name, f"{label} (B = 32 shapes{note})", dtype, got, ref, timing,
                     plain_timing, nb, ops, timed=False)
        b_ms, b_by = bound(nb, ops)
        self.b32.setdefault(name, []).append({
            "shape": label, "dtype": dtype, "rel_rms": rel_rms(got.float(), ref.float()),
            "ms": timing[0],
            "plain_ms" if whole else "plain_ms_on_rows_checked": plain_timing[0],
            "rows_checked": rows_checked, "bound_ms": b_ms, "bound_by": b_by, **extra})


def weight_numel(kp: dict, names) -> int:
    return sum(kp[n].numel() for n in names if n in kp)


def phase_kernels(rec: Record) -> None:
    import torch

    from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
    from qwen3_tts_tpu_torch.ops.cuda import (
        packed_matmul as pm,
        pretransformer_kernel as ptk,
        quant_matmul as qm,
        upsample_kernel as upk,
        vocoder_kernels as vk,
    )
    from qwen3_tts_tpu_torch.testing import random_vocoder_params

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # K4 with bf16 weights is one cooperative launch a call: shown by the
    # profiler first (see one_kernel_per_call)
    cfg = TokenizerDecoderConfig()
    dense = random_vocoder_params(cfg, seed=0, device=dev)
    kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, torch.bfloat16)
    mats = weight_numel(kp, ("wi", "wqkv", "wo", "wgu", "wd", "wout"))
    kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
    # K3 and K7 are one device kernel a call: the GEMV at M <= M0 (gate/up
    # at M = 1; fc2 at M = 8, its K split across warps), past M0 the
    # tensor-core tile with K split (fc1 at M = 114) or not (gate/up at
    # M = 300); the kernel named is the one M0 picks
    for name, k, o, m, bits in (("gate_up", 1024, 6144, 1, None), ("gate_up", 1024, 6144, 1, 4),
                                ("fc2", 2048, 1024, 8, None), ("fc1", 2048, 2048, 114, None),
                                ("gate_up", 1024, 6144, 300, 4)):
        x = randn(m, k).to(torch.bfloat16)
        w, s, b = qmm_weights(gen, dev, bits, k, o)
        if bits is None:
            call = lambda: qm.int8_matmul_kernel(x, w, s, b)  # noqa: E731
        else:
            call = lambda: pm.packed_matmul_kernel(x, w, s, b, bits, 64)  # noqa: E731
        for _ in range(3):  # the first calls load the kernel and size the counters
            call()
        gemv = m <= (qm.M0 if bits is None else pm.M0)
        one_kernel_per_call("int8_matmul" if bits is None else f"packed_matmul {bits}-bit",
                            f"{'GEMV' if gemv else 'tile'}, {name} M={m} K={k} O={o}", call,
                            time_ms(call, 20)[0], 2 * m * k * o,
                            expect="qt_qmm_gemv_kernel" if gemv else "qt_qmm_tile_kernel")
    fp = ptk.build_pretransformer_fused_params(dense["pre_transformer"], cfg, torch.bfloat16)
    for b, t in ((1, 26), (1, 110), (2, 110)):
        x = randn(b, t, cfg.latent_dim).to(torch.bfloat16)
        attn = 2 * kp["wqkv"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
        one_kernel_per_call("pre_transformer", f"B={b} T={t}",
                            lambda: ptk.pre_transformer_kernel(kp, x, **kw),
                            time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 20)[0],
                            b * (2 * t * mats + attn))
        # K4a with bf16 weights: the same persistent kernel, one launch a call
        one_kernel_per_call("pre_transformer_fused", f"B={b} T={t}",
                            lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw),
                            time_ms(lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw),
                                    20)[0],
                            b * (2 * t * mats + attn), expect="qt_pt_persistent_kernel")
    # K5 with bf16 weights is one cooperative launch a stage call, from the
    # pipeline's fp32 input and from bf16 input
    stages = dense["upsample"]
    ups = {dt: [upk.build_upsample_stage_params(
        st, dt, initial_conv=dense["decoder"]["initial_conv"] if i == len(stages) - 1 else None)
        for i, st in enumerate(stages)] for dt in (torch.float32, torch.bfloat16)}
    for i, sp in enumerate(ups[torch.bfloat16]):
        for xdt in (torch.float32, torch.bfloat16):
            t = 26 * 2 ** i
            x = randn(1, t, cfg.latent_dim).to(xdt)
            one_kernel_per_call("upsample_stage", f"stage{i} T={t} x {str(xdt)[6:]}",
                                lambda: upk.upsample_stage_kernel(sp, x),
                                time_ms(lambda: upk.upsample_stage_kernel(sp, x), 20)[0],
                                upsample_ops(sp, t))
    for t in (26, 110):
        x = randn(1, t, cfg.latent_dim)
        for i, sp in enumerate(ups[torch.bfloat16]):
            x = upsample_phases(sp, x, f"stage{i} T={x.shape[1]}")

    # K3 at every linear shape of the 0.6B talker / code predictor
    # (qkv, o, gate/up, down, codec_head, text fc1, fc2, cp lm_head), and at
    # the text projection's own rows (M = 3 and 114) on fc1 and fc2; on
    # either side of M0 two calls give the same bits. K3 and K7 are timed
    # by CUDA-graph replay: at 0.01-0.06 ms a call their back-to-back event
    # time reads the wrapper's host dispatch (0.03-0.17 ms). Each bf16 call
    # at M <= 16 is also timed cold (cold_ms: the weights in copies over 64
    # MB), beside the floor of an empty launch timed the same way
    floors = {(blocks, store): launch_floor_ms(blocks, store)
              for blocks in (1, 264) for store in (False, True)}
    log("[kernels] floor: an empty kernel launched the cold way (one CUDA graph of 64 "
        "launches) " + ", ".join(f"{v:.4f} ms at {n} block(s) of 256 threads"
                                 f"{' writing a float a block' if st else ''}"
                                 for (n, st), v in floors.items()))
    for name in ("int8_matmul", "packed_matmul"):
        rec.rows[name]["floor_cold_ms"] = floors[264, False]
        rec.rows[name]["floor_store_cold_ms"] = floors[264, True]
    shapes = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024),
              (1024, 3072), (2048, 2048), (1024, 2048)]
    for k, o in shapes:
        w8, s, b = qmm_weights(gen, dev, None, k, o)
        copies = cold_copies(w8, s, b)
        rows = ((1, 2, 3, 4, 8, 16, 64, 114, 300, 512) if k == 2048
                else (1, 2, 3, 4, 8, 16, 64, 300, 512))
        for dtype in ("float32", "bfloat16"):
            for m in rows:
                x = randn(m, k).to(getattr(torch, dtype))
                got = qm.int8_matmul_kernel(x, w8, s, b)
                ref = qm.int8_matmul_plain(x, w8, s, b)
                it = 50 if m <= 3 else 10
                nb = nbytes(x, w8, s, b, got)
                warm = graph_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b))
                rec.compare("int8_matmul", f"M={m} K={k} O={o}", dtype, got, ref,
                            (warm, "graph"),
                            time_ms(lambda: qm.int8_matmul_plain(x, w8, s, b), it),
                            nb, {dtype: 2 * m * k * o}, timed=m not in (4, 8, 16, 512))
                same_bits("int8_matmul", f"M={m} K={k} O={o} {dtype}", got,
                          lambda: qm.int8_matmul_kernel(x, w8, s, b))
                if dtype == "bfloat16" and m <= 16:
                    cold_row(rec, "int8_matmul", ("K3", k, o, m), m <= qm.M0, warm,
                             cold_ms([lambda c=c: qm.int8_matmul_kernel(x, *c) for c in copies]),
                             nb, {dtype: 2 * m * k * o}, len(copies))
                if dtype == "bfloat16" and m in (114, 300):
                    dense_yardstick("int8_matmul", x, o, f"M={m} K={k} O={o}")
        del copies

    # K7 at the mixed 4/6-bit mode's 0.6B linears (4-bit gate/up, o, down;
    # 6-bit qkv and codec head: the main path's, timed) and one 2-, 3- and
    # 8-bit shape (text fc1, cp lm_head, down), group 64; random bit
    # patterns are valid packed values at every width
    # and the pre-quantized configuration's text projection (fc1 2048 ->
    # 2048, fc2 2048 -> 1024 at 4 bits) at its own rows, M = 3 and 114
    packed = [(4, 1024, 6144, True), (4, 2048, 1024, True), (4, 3072, 1024, True),
              (6, 1024, 4096, True), (6, 1024, 3072, True), (4, 2048, 2048, True),
              (2, 2048, 2048, False), (3, 1024, 2048, False), (8, 3072, 1024, False)]
    for bits, k, o, main in packed:
        wq, s, b = qmm_weights(gen, dev, bits, k, o)
        copies = cold_copies(wq, s, b)
        rows = (1, 2, 3, 4, 8, 16, 114, 300) if (bits, k) == (4, 2048) else (1, 2, 3, 4, 8, 16,
                                                                               300)
        for dtype in ("float32", "bfloat16"):
            for m in rows:
                x = randn(m, k).to(getattr(torch, dtype))
                got = pm.packed_matmul_kernel(x, wq, s, b, bits, 64)
                ref = pm.packed_matmul_plain(x, wq, s, b, bits, 64)
                it = 50 if m <= 3 else 10
                err = rel_rms(got.float(), ref.float())
                if not bool(torch.isfinite(got.float()).all()):
                    err = float("nan")
                nb = nbytes(x, wq, s, b, got)
                k7_ms = graph_ms(lambda: pm.packed_matmul_kernel(x, wq, s, b, bits, 64))
                rec.add("packed_matmul", f"{bits}-bit M={m} K={k} O={o}", dtype, err,
                        float((got.float() - ref.float()).abs().max()), TOL[dtype],
                        (k7_ms, "graph"),
                        time_ms(lambda: pm.packed_matmul_plain(x, wq, s, b, bits, 64), it),
                        nb, {dtype: 2 * m * k * o}, timed=main and m in (1, 3, 114, 300))
                same_bits("packed_matmul", f"{bits}-bit M={m} K={k} O={o} {dtype}", got,
                          lambda: pm.packed_matmul_kernel(x, wq, s, b, bits, 64))
                k7_cold = None
                if dtype == "bfloat16" and m <= 16:
                    k7_cold = cold_ms([lambda c=c: pm.packed_matmul_kernel(x, *c, bits, 64)
                                       for c in copies])
                    cold_row(rec, "packed_matmul", (f"K7 {bits}-bit", k, o, m), m <= pm.M0,
                             k7_ms, k7_cold, nb, {dtype: 2 * m * k * o}, len(copies), main)
                if bits == 4 and dtype == "bfloat16" and (k, o, m) in K7_LIBRARY_SHAPES:
                    int4pack_library(rec, x, wq, s, b, got, k7_ms, copies, k7_cold)
                if dtype == "bfloat16" and m in (114, 300) and bits == 4:
                    dense_yardstick("packed_matmul", x, o, f"{bits}-bit M={m} K={k} O={o}")
        del copies
        torch.cuda.empty_cache()
    qmm_widths(rec, gen, dev)
    rec.m0_swept = m0_sweep(gen, dev)

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, dt)
        mats = weight_numel(kp, ("wi", "wqkv", "wo", "wgu", "wd", "wout"))
        for b, t in ((1, 26), (1, 110), (2, 110), (8, 26), (8, 110)):
            x = randn(b, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            got = ptk.pre_transformer_kernel(kp, x, **kw)
            attn = 2 * kp["wqkv"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
            ops = b * (2 * t * mats + attn)
            rec.compare("pre_transformer", f"B={b} T={t}", dtype, got,
                        ptk.pre_transformer_plain(kp, x, **kw),
                        time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 20),
                        time_ms(lambda: ptk.pre_transformer_plain(kp, x, **kw), 5),
                        nbytes(x, got, *kp.values()), {dtype: ops}, timed=b == 1)

        # K4a: the same function over the per-head layout, at the shapes of
        # the vocoder's stream window and blocking rows, B = 1 (timed) and
        # 2; against its plain version and against K4 on the same weights
        # (bf16: bit for bit)
        fp = ptk.build_pretransformer_fused_params(dense["pre_transformer"], cfg, dt)
        fmats = weight_numel(fp, ("wi", "wq", "wk", "wv", "wo", "wg", "wu", "wd", "wout"))
        for b, t in ((1, 26), (1, 110), (2, 26), (2, 110), (1, 300)):
            x = randn(b, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            got = ptk.pre_transformer_fused_kernel(fp, x, **kw)
            k4 = ptk.pre_transformer_kernel(kp, x, **kw)
            vs_k4 = rel_rms(got.float(), k4.float())
            if dtype == "bfloat16" and not torch.equal(got, k4):
                vs_k4 = float("nan")
            attn = 2 * fp["wq"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
            rec.compare("pre_transformer_fused", f"B={b} T={t}", dtype, got,
                        ptk.pre_transformer_fused_plain(fp, x, **kw),
                        time_ms(lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw), 5),
                        time_ms(lambda: ptk.pre_transformer_fused_plain(fp, x, **kw), 5),
                        nbytes(x, got, *fp.values()), {dtype: b * (2 * t * fmats + attn)},
                        timed=b == 1 and t != 300)
            log(f"[kernels] pre_transformer_fused B={b} T={t} {dtype}: against K4 on the same "
                f"weights rel_rms={vs_k4:.3e} (tol {K4A_VS_K4[dtype]:g}"
                f"{', bit for bit' if dtype == 'bfloat16' else ''})")
            if not vs_k4 <= K4A_VS_K4[dtype]:
                raise SystemExit("K4a disagrees with K4 on the same weights")

        # K5 at the stream window's and the generate window's rows, B = 1
        # and the serving paths' 8; the pipeline hands it fp32 input
        # (timed), bf16 input checked beside it
        for b, t in ((1, 26), (1, 110), (8, 26), (8, 110)):
            for xdt in (dt,) if dtype == "float32" else (torch.float32, torch.bfloat16):
                x = randn(b, t, cfg.latent_dim).to(xdt)
                for i, sp in enumerate(ups[dt]):
                    got = upk.upsample_stage_kernel(sp, x)
                    ti = x.shape[1]
                    timing = time_ms(lambda: upk.upsample_stage_kernel(sp, x), 10)
                    nb = nbytes(x, got, *sp.values())
                    rec.compare("upsample_stage", f"stage{i} B={b} T={ti} x {str(xdt)[6:]}",
                                dtype, got, upk.upsample_stage_plain(sp, x), timing,
                                time_ms(lambda: upk.upsample_stage_plain(sp, x), 5),
                                nb, {dtype: b * upsample_ops(sp, ti)},
                                timed=xdt == torch.float32 and b == 1)
                    if dtype == "bfloat16" and b == 1:
                        b_ms = bound(nb, {dtype: upsample_ops(sp, ti)})[0]
                        log(f"[kernels] upsample_stage stage{i} T={ti} x {str(xdt)[6:]} bf16: "
                            f"{upsample_ops(sp, ti) / timing[0] / 1e9:.1f} TFLOP/s of the card's "
                            f"989, {100 * b_ms / timing[0]:.1f}% of the bytes bound "
                            f"({nb / timing[0] / 1e9:.3f} TB/s of 3.35)")
                    x = got

        blocks = dense["decoder"]["blocks"]
        for b, t in ((1, 26), (1, 110), (2, 26), (8, 26), (8, 110)):
            x = randn(b, 4 * t, cfg.decoder_dim, scale=0.5).to(dt)
            for i, (block, rate) in enumerate(zip(blocks, cfg.upsample_rates)):
                tail = None
                if i == len(blocks) - 1:
                    tail = {"snake": dense["decoder"]["out_snake"],
                            "conv": dense["decoder"]["out_conv"]}
                bp = vk.build_seanet_block_params(block, rate, dt, tail=tail)
                y = vk.block_upsample_kernel(bp, x, rate=rate)
                up_ops = 2 * x.shape[0] * x.shape[1] * bp["up_w"].numel()
                rec.compare("block_upsample", f"block{i} B={b} T={x.shape[1]}", dtype, y,
                            vk.block_upsample_plain(bp, x, rate=rate),
                            time_ms(lambda: vk.block_upsample_kernel(bp, x, rate=rate), 10),
                            time_ms(lambda: vk.block_upsample_plain(bp, x, rate=rate), 3),
                            nbytes(x, y, bp["up_w"], bp["up_b"], bp["snake_a"],
                                   bp["snake_binv"]), {dtype: up_ops}, timed=b == 1)
                if dtype == "bfloat16" and b == 1:
                    upsample_yardstick(bp, x, rate, f"block{i} T={x.shape[1]}")
                got = vk.residual_units_kernel(bp, y)
                rows = y.shape[0] * y.shape[1]
                ops = 2 * rows * weight_numel(bp, ("u_w1", "u_w2", "t_w"))
                units = [v for k, v in bp.items() if k.startswith(("u_", "t_"))]
                timing = time_ms(lambda: vk.residual_units_kernel(bp, y), 5)
                rec.compare("residual_units", f"block{i} B={b} S={y.shape[1]}", dtype, got,
                            vk.residual_units_plain(bp, y), timing,
                            time_ms(lambda: vk.residual_units_plain(bp, y), 3),
                            nbytes(y, got, *units), {dtype: ops}, timed=b == 1)
                if dtype == "bfloat16":
                    log(f"[kernels] residual_units block{i} B={b} S={y.shape[1]} bf16: "
                        f"{ops / timing[0] / 1e9:.1f} TFLOP/s of the card's 989")
                    if i == 0 and b == 1 and t == 26:
                        conv_yardstick(bp, y)
                x = got if got.dim() == 3 else None
    torch.cuda.synchronize()
    b32_kernels(rec, dense, cfg, gen)


# the lockstep step's linears at 0.6B, (name, K, O, K7's bits): 4-bit
# gate/up, o and down, 6-bit qkv, codec head and cp lm head (the mixed mode)
STEP_LINEARS = (("qkv", 1024, 4096, (6,)), ("o", 2048, 1024, (4,)),
                ("gate/up", 1024, 6144, (4,)), ("down", 3072, 1024, (4,)),
                ("codec head", 1024, 3072, (6,)), ("cp lm head", 1024, 2048, (6,)))
# block 3's rows of 110 frames past the old grid cap (39 rows), and the rows
# held against the plain versions there (both sides of the cap, the last)
CAP_ROWS, CAP_CHECKED = (40, 64), (0, 38, 39, 40)
FP32_CAP_ROWS = 20  # past the fp32 GEMM's old cap (19 rows of 110 frames)


def b32_kernels(rec: Record, dense: dict, cfg, gen) -> None:
    """The kernels at B = 32 serving's shapes, bf16 weights, each against
    its plain version at TOL bf16 with its time and bound, into rec.b32
    (the kernels line's "at_b32"): K4, K5 (fp32 input, as the pipeline
    gives it) and, per SEANet block, its upsample and K6 at B = 32 for a
    serve window's T = 26 and serving_rtf's vocode of T = 48; K6 and the
    upsample on block 3 at 40 and 64 rows of T = 110 (the repaired shapes:
    one launch a conv, counted at the C entry; rows 0, 38, 39, 40 and the
    last held against the plain versions, which need ~5 GB a tensor at 64
    rows whole); K3 and K7 (4 and 6 bits) at M = 32 and 64 on the lockstep
    step's linears, warm (a graph of one call), K7's 4-bit calls beside
    torch._weight_int4pack_mm."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import (
        _build,
        pretransformer_kernel as ptk,
        upsample_kernel as upk,
        vocoder_kernels as vk,
    )

    dev, dt = torch.device("cuda"), "bfloat16"

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    t_part = time.perf_counter()
    kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
    kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, torch.bfloat16)
    mats = weight_numel(kp, ("wi", "wqkv", "wo", "wgu", "wd", "wout"))
    stages = dense["upsample"]
    ups = [upk.build_upsample_stage_params(
        st, torch.bfloat16,
        initial_conv=dense["decoder"]["initial_conv"] if i == len(stages) - 1 else None)
        for i, st in enumerate(stages)]
    blocks = dense["decoder"]["blocks"]
    bps = [vk.build_seanet_block_params(
        block, rate, torch.bfloat16,
        tail=({"snake": dense["decoder"]["out_snake"], "conv": dense["decoder"]["out_conv"]}
              if i == len(blocks) - 1 else None))
        for i, (block, rate) in enumerate(zip(blocks, cfg.upsample_rates))]

    def block_rows(i, bp, x, label, check=None, dtype=dt):
        """block i's upsample and K6 on x; `check`: the rows held against
        the plain versions (all when None). With fp32 weights (`dtype`) the
        exact fp32 GEMM of csrc/gemm.cuh runs, whose grid is counted by
        launches of qt_units_gemm: 1 + 7."""
        rate = cfg.upsample_rates[i]
        lib, entry = _build.lib(), "qt_units_conv" if dtype == dt else "qt_units_gemm"
        real, convs = getattr(lib, entry), []

        def counting(*args):
            convs.append(args)
            return real(*args)

        setattr(lib, entry, counting)
        try:
            y = vk.block_upsample_kernel(bp, x, rate=rate)
            got = vk.residual_units_kernel(bp, y)
            torch.cuda.synchronize()
        finally:
            setattr(lib, entry, real)
        if len(convs) != 7 + ("t_w" in bp and dtype != dt):
            raise SystemExit(f"[kernels] block{i} {label}: {len(convs)} launches of {entry}, "
                             "not one a conv")
        checked = "all" if check is None else list(check)
        sl = slice(None) if check is None else checked
        up_ops = 2 * x.shape[0] * x.shape[1] * bp["up_w"].numel()
        rec.at_b32("block_upsample", f"block{i} {label}", y[sl],
            vk.block_upsample_plain(bp, x[sl], rate=rate),
            time_ms(lambda: vk.block_upsample_kernel(bp, x, rate=rate), 3),
            time_ms(lambda: vk.block_upsample_plain(bp, x[sl], rate=rate), 2),
            nbytes(x, y, bp["up_w"], bp["up_b"], bp["snake_a"], bp["snake_binv"]),
            {dtype: up_ops}, rows_checked=checked, dtype=dtype)
        rows = y.shape[0] * y.shape[1]
        units = [v for k, v in bp.items() if k.startswith(("u_", "t_"))]
        rec.at_b32("residual_units", f"block{i} {label}", got[sl],
                   vk.residual_units_plain(bp, y[sl]),
            time_ms(lambda: vk.residual_units_kernel(bp, y), 3),
            time_ms(lambda: vk.residual_units_plain(bp, y[sl]), 2), nbytes(y, got, *units),
            {dtype: 2 * rows * weight_numel(bp, ("u_w1", "u_w2", "t_w"))},
            rows_checked=checked, dtype=dtype)
        return got

    for t in (26, 48):
        x = randn(32, t, cfg.latent_dim).to(torch.bfloat16)
        got = ptk.pre_transformer_kernel(kp, x, **kw)
        attn = 2 * kp["wqkv"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
        rec.at_b32("pre_transformer", f"B=32 T={t}", got, ptk.pre_transformer_plain(kp, x, **kw),
            time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 10),
            time_ms(lambda: ptk.pre_transformer_plain(kp, x, **kw), 2),
            nbytes(x, got, *kp.values()), {dt: 32 * (2 * t * mats + attn)})
        x = randn(32, t, cfg.latent_dim)
        for i, sp in enumerate(ups):
            got, ti = upk.upsample_stage_kernel(sp, x), x.shape[1]
            rec.at_b32("upsample_stage", f"stage{i} B=32 T={ti}", got,
                       upk.upsample_stage_plain(sp, x),
                time_ms(lambda: upk.upsample_stage_kernel(sp, x), 5),
                time_ms(lambda: upk.upsample_stage_plain(sp, x), 2),
                nbytes(x, got, *sp.values()), {dt: 32 * upsample_ops(sp, ti)})
            x = got
        x = randn(32, 4 * t, cfg.decoder_dim, scale=0.5).to(torch.bfloat16)
        for i, bp in enumerate(bps):
            x = block_rows(i, bp, x, f"B=32 T={x.shape[1]}")
        del x, got
        torch.cuda.empty_cache()
    i = len(bps) - 1
    t_in = 4 * 110 * int(np.prod(cfg.upsample_rates[:-1]))
    for rows in CAP_ROWS:
        x = randn(rows, t_in, bps[i]["snake_a"].shape[0], scale=0.5).to(torch.bfloat16)
        block_rows(i, bps[i], x, f"{rows} rows of T=110 (S={t_in})",
                   check=sorted({r for r in CAP_CHECKED if r < rows} | {rows - 1}))
        del x
        torch.cuda.empty_cache()
    # the exact fp32 path (fp32 weights) had the same cap on its GEMM's grid
    # at 65,535 row tiles of 64: 19 rows of 110 frames on block 3
    bp32 = vk.build_seanet_block_params(
        blocks[i], cfg.upsample_rates[i], torch.float32,
        tail={"snake": dense["decoder"]["out_snake"], "conv": dense["decoder"]["out_conv"]})
    x = randn(FP32_CAP_ROWS, t_in, bp32["snake_a"].shape[0], scale=0.5)
    block_rows(i, bp32, x, f"{FP32_CAP_ROWS} rows of T=110 (S={t_in})",
               check=(0, FP32_CAP_ROWS - 1), dtype="float32")
    del x, bp32
    torch.cuda.empty_cache()
    log(f"[kernels] K4, K5, K6 and the upsample at the B = 32 shapes and block 3 at "
        f"{CAP_ROWS} rows of 110 frames: {time.perf_counter() - t_part:.1f} s")

    qmm_b32(rec, gen, dev, STEP_LINEARS)


def qmm_b32(rec: Record, gen, dev, linears) -> None:
    """K3 and K7 at M = 32 and 64 (a B = 32 lockstep step's linears at M =
    B, the code predictor's first pass at 2B) on `linears` ((name, K, O,
    K7's bit widths)), bf16 x, group 64: each call against its plain
    version at TOL bf16, timed warm (a graph of one call) with its bound,
    into rec.b32; K7's 4-bit calls beside torch._weight_int4pack_mm on the
    same weights."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    dt = "bfloat16"
    for name, k, o, widths in linears:
        w8, s8, b8 = qmm_weights(gen, dev, None, k, o)
        packed = {bits: qmm_weights(gen, dev, bits, k, o) for bits in widths}
        lib_w = int4pack_weights(*packed[4], k) if 4 in packed else None
        for m in (32, 64):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            got = qm.int8_matmul_kernel(x, w8, s8, b8)
            rec.at_b32("int8_matmul", f"{name} M={m} K={k} O={o}", got,
                       qm.int8_matmul_plain(x, w8, s8, b8),
                       (graph_ms(lambda: qm.int8_matmul_kernel(x, w8, s8, b8)), "graph"),
                       time_ms(lambda: qm.int8_matmul_plain(x, w8, s8, b8), 5),
                       nbytes(x, w8, s8, b8, got), {dt: 2 * m * k * o})
            for bits, (wq, sq, bq) in packed.items():
                got = pm.packed_matmul_kernel(x, wq, sq, bq, bits, 64)
                extra = {}
                if bits == 4:
                    lib = torch._weight_int4pack_mm(x, lib_w[0], 64, lib_w[1])
                    err = rel_rms(lib.float(), got.float())
                    if not err <= TOL[dt]:
                        raise SystemExit(f"torch._weight_int4pack_mm disagrees with K7 "
                                         f"({err:.3e})")
                    extra = {"library_ms": graph_ms(
                        lambda: torch._weight_int4pack_mm(x, lib_w[0], 64, lib_w[1])),
                        "library_call": "torch._weight_int4pack_mm", "library_rel_rms": err}
                rec.at_b32("packed_matmul", f"{bits}-bit {name} M={m} K={k} O={o}", got,
                           pm.packed_matmul_plain(x, wq, sq, bq, bits, 64),
                           (graph_ms(lambda: pm.packed_matmul_kernel(x, wq, sq, bq, bits, 64)),
                            "graph"),
                           time_ms(lambda: pm.packed_matmul_plain(x, wq, sq, bq, bits, 64), 5),
                           nbytes(x, wq, sq, bq, got), {dt: 2 * m * k * o}, **extra)
                if extra:
                    k7 = rec.b32["packed_matmul"][-1]["ms"]
                    log(f"[{rec.tag}] library, packed_matmul 4-bit {name} M={m}: "
                        f"torch._weight_int4pack_mm {extra['library_ms']:.4f} ms (graph) "
                        f"against K7 {k7:.4f} ms: K7 "
                        f"{'no slower' if k7 <= extra['library_ms'] else 'SLOWER'}; rel_rms "
                        f"against K7 {extra['library_rel_rms']:.3e}")
        del w8, packed, lib_w
        torch.cuda.empty_cache()
    for name in ("int8_matmul", "packed_matmul"):
        rs = rec.b32[name]
        log(f"[{rec.tag}] {name} at the B = 32 step's linears, M = 32 / 64 (the tile): "
            f"{sum(r['ms'] for r in rs):.4f} ms summed over {len(rs)} calls against a bound of "
            f"{sum(r['bound_ms'] for r in rs):.4f} ms")


def int4pack_library(rec: Record, x, wq, s, b, got, k7_ms: float, copies=None,
                     k7_cold: float | None = None) -> tuple[float, float | None]:
    """The library call for K7's 4-bit product: torch._weight_int4pack_mm
    on the same weights. MLX's w = s q + b is its (q - 8) scale + zero with
    scale = s and zero = b + 8 s, in bf16 [K / 64, O, 2]; the nibbles go
    two a byte, the even column high, then into its tile layout. Held
    against K7's output at TOL["bfloat16"] (scale and zero rounded to bf16
    are another function by ~2^-9 of a weight) and timed as K7 was: by
    graph replay, and where K7 was timed cold (`k7_cold`) cold too, on its
    own copies of the same weights. Returns (its warm ms, its cold ms or
    None)."""
    import torch

    m, k = x.shape
    packed, sz = int4pack_weights(wq, s, b, k)
    lib = torch._weight_int4pack_mm(x, packed, 64, sz)
    err = rel_rms(lib.float(), got.float())
    ms = graph_ms(lambda: torch._weight_int4pack_mm(x, packed, 64, sz))
    ok = err <= TOL["bfloat16"]
    cold, lib_cold = "", None
    row = rec.rows["packed_matmul"]
    if k7_cold is not None:
        packs = [int4pack_weights(*c, k) for c in copies]
        lib_cold = cold_ms([lambda pz=pz: torch._weight_int4pack_mm(x, pz[0], 64, pz[1])
                            for pz in packs])
        del packs
        cold = (f"; cold {lib_cold:.4f} ms against K7 {k7_cold:.4f} ms: K7 "
                f"{'no slower' if k7_cold <= lib_cold else 'SLOWER'}")
        row["library_cold_ms"] = row.get("library_cold_ms", 0.0) + lib_cold
        row["cold_ms_at_library_shapes"] = row.get("cold_ms_at_library_shapes", 0.0) + k7_cold
    log(f"[{rec.tag}] library, packed_matmul 4-bit M={m} K={k} O={got.shape[1]}: "
        f"torch._weight_int4pack_mm {ms:.4f} ms (graph) against K7 {k7_ms:.4f} ms: K7 "
        f"{'no slower' if k7_ms <= ms else 'SLOWER'}{cold}; rel_rms against K7 {err:.3e} "
        f"(tol {TOL['bfloat16']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("torch._weight_int4pack_mm disagrees with K7")
    row["library_ms"] = (row["library_ms"] or 0.0) + ms
    row["ms_at_library_shapes"] = row.get("ms_at_library_shapes", 0.0) + k7_ms
    return ms, lib_cold


# cold ms of the bf16 calls at M <= 16: (kernel, K, O, M) -> ms, kernel "K3"
# or "K7 <bits>-bit" (cold_row), and "tile ..." (m0_sweep); M0's sweep reads it
COLD: dict = {}


def cold_row(rec: Record, name: str, key: tuple, gemv: bool, warm: float, cold: float,
             nb: int, ops: dict, copies: int, main: bool = True) -> None:
    """Logs one bf16 call's cold time beside its warm one, its bound and the
    floor, keeps it in COLD, and adds the main path's M = 1 GEMV calls to
    the kernel's row (gemv_warm_ms, gemv_cold_ms, gemv_bound_ms)."""
    b_ms, b_by = bound(nb, ops)
    row = rec.rows[name]
    kern, k, o, m = key
    log(f"[{rec.tag}] {name} cold, {kern} M={m} K={k} O={o} bf16 ({'GEMV' if gemv else 'tile'}): "
        f"cold {cold:.4f} ms ({copies} copies of the weights in one graph), warm {warm:.4f} ms "
        f"(graph of one call); bound {b_ms:.4f} ms ({b_by}): {cold / b_ms:.2f}x cold, "
        f"{warm / b_ms:.2f}x warm; floor {row['floor_cold_ms']:.4f} ms, "
        f"{row['floor_store_cold_ms']:.4f} ms writing")
    COLD[(kern if gemv else "tile " + kern), k, o, m] = cold
    if gemv and main and m == 1:
        for field, v in (("gemv_warm_ms", warm), ("gemv_cold_ms", cold), ("gemv_bound_ms", b_ms)):
            row[field] = row.get(field, 0.0) + v


def int4pack_weights(wq, s, b, k: int):
    """K7's 4-bit weights (group 64) as torch._weight_int4pack_mm takes
    them: (packed tiles, [K / 64, O, 2] bf16 scale and zero)."""
    import torch

    from qwen3_tts_tpu_torch.ops.quant import unpack_bits_torch

    q = unpack_bits_torch(wq, 4, k).to(torch.int32)
    packed = torch._convert_weight_to_int4pack(((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([s, b + 8 * s], dim=-1).transpose(0, 1).contiguous().to(torch.bfloat16)
    return packed, sz


def qmm_weights(gen, dev, bits: int | None, k: int, o: int):
    """Random K3 (bits None: uint8 [o, k]) or K7 (MLX words of `bits`)
    weights, group 64, with fp32 scales and biases; random bit patterns are
    valid packed values at every width."""
    import torch

    if bits is None:
        w = torch.randint(0, 256, (o, k), generator=gen, device=dev, dtype=torch.uint8)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * 1e-3
        return w, s, torch.randn(o, k // 64, generator=gen, device=dev) * 0.02
    w = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    s = torch.rand(o, k // 64, generator=gen, device=dev) * (2e-2 / 2 ** bits)
    return w, s, torch.randn(o, k // 64, generator=gen, device=dev) * 0.01


def same_bits(name: str, label: str, got, call) -> None:
    """A second call gives the same bits (the tile's split-K sum is
    fixed-order)."""
    import torch

    if not torch.equal(call(), got):
        raise SystemExit(f"{name} {label}: two calls differ")


def dense_yardstick(name: str, x, o: int, label: str) -> None:
    """One dense bf16 torch.matmul of the same shape, beside the kernel's
    time: a yardstick only (not the same function; no port path calls
    it)."""
    import torch

    w = torch.randn(x.shape[1], o, device=x.device).to(torch.bfloat16)
    ms = graph_ms(lambda: x @ w)
    log(f"[kernels] yardstick, {name} {label}: one dense bf16 torch.matmul {ms:.4f} ms (graph, "
        f"{2 * x.shape[0] * x.shape[1] * o / ms / 1e9:.1f} TFLOP/s)")


def qmm_widths(rec: Record, gen, dev) -> None:
    """K3 and K7 at every width they take, on both sides of M0: K3, and K7
    at 2, 3, 4, 6 and 8 bits, group sizes 32, 64 and 128, with and without
    biases, at ragged shapes (O = 200 columns, K = 352 at group 32: half a
    tile K step past the last whole one), fp32 and bf16 x, against their
    plain versions: the GEMV at M = 1, 3 and 8 rows (where M0 reaches them),
    the tile at M = M0 + 1 and 130; every call is one launch of the path
    M0 gives it and two calls give the same bits."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    o, worst, n = 200, {}, 0
    past = max(qm.M0, pm.M0) + 1
    for m in (1, 3, 8, past, 130):
        for dtype in (torch.float32, torch.bfloat16):
            cases = []
            x = torch.randn(m, 320, generator=gen, device=dev).to(dtype)
            w8, s, b = qmm_weights(gen, dev, None, 320, o)
            cases.append(("int8_matmul", "K=320", qm,
                          lambda x=x, w8=w8, s=s, b=b: qm.int8_matmul_kernel(x, w8, s, b),
                          lambda x=x, w8=w8, s=s, b=b: qm.int8_matmul_plain(x, w8, s, b)))
            for bits in (2, 3, 4, 6, 8):
                for gs in (32, 64, 128):
                    k = 352 if gs == 32 else 384
                    wq = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=gen,
                                       device=dev, dtype=torch.int64).to(torch.int32)
                    s = torch.rand(o, k // gs, generator=gen, device=dev) * 1e-2
                    b = torch.randn(o, k // gs, generator=gen, device=dev) * 0.1
                    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                    for bb in (b, None):
                        args = (x, wq, s, bb, bits, gs)
                        cases.append(("packed_matmul", f"{bits}-bit gs={gs} K={k} biases="
                                      f"{bb is not None}", pm,
                                      lambda a=args: pm.packed_matmul_kernel(*a),
                                      lambda a=args: pm.packed_matmul_plain(*a)))
            for name, label, mod, kernel, plain in cases:
                path = "GEMV" if m <= mod.M0 else "tile"
                if path == "GEMV" and m not in (1, 3, 8) or path == "tile" and m < past:
                    continue
                label = f"{label} M={m} {str(dtype)[6:]}"
                before = mod.launches
                got = kernel()
                if mod.launches != before + 1:
                    raise SystemExit(f"[kernels] {path} {name} {label}: not one launch")
                ref = plain()
                err = rel_rms(got.float(), ref.float())
                tol = TOL[str(dtype)[6:]]
                if not (err <= tol and bool(torch.isfinite(got.float()).all())):
                    raise SystemExit(f"[kernels] {path} {name} {label}: rel RMS {err:.3e} "
                                     f"(tol {tol:g})")
                same_bits(name, label, got, kernel)
                row = rec.rows[name]
                row["max_abs_err"] = max(row["max_abs_err"],
                                         float((got.float() - ref.float()).abs().max()))
                key = (path, name, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), err)
                n += 1
    log(f"[kernels] K3 and K7 at every width on both sides of M0 (K3 {qm.M0}, K7 {pm.M0}): "
        f"{n} calls (K3; K7 at 2/3/4/6/8 bits, groups 32/64/128, with and without biases; the "
        f"GEMV at M = 1, 3, 8, the tile at M = {past} and 130; O = 200, K = 320-384), worst "
        f"rel RMS " + ", ".join(f"{k[0]} {k[1]} {k[2]} {e:.3e}" for k, e in sorted(worst.items()))
        + " (tol 1e-4 fp32, 2e-2 bf16); two calls bit-identical in each")


# (name, K, O): the shapes M0's sweep sums over: the serving step's (qkv,
# o, gate/up, down, codec head, cp lm head) and the text projection's fc1
# and fc2
M0_SHAPES = (("qkv", 1024, 4096), ("o", 2048, 1024), ("gate/up", 1024, 6144),
             ("down", 3072, 1024), ("codec head", 1024, 3072), ("cp lm head", 1024, 2048),
             ("fc1", 2048, 2048), ("fc2", 2048, 1024))
M0_ROWS = (1, 2, 3, 4, 8, 16)


def m0_sweep(gen, dev, shapes=M0_SHAPES, tag: str = "kernels") -> dict:
    """M0's sweep: the GEMV against the tile at `shapes` for M = 1, 2, 3,
    4, 8 and 16, bf16 x, K3 and K7 at 4 bits, both cold (cold_ms; the
    GEMV's times are the kernels phase's where it took them, COLD). The M0
    it gives a kernel is the largest M at which the GEMV, summed over the
    shapes, is faster than the tile there and at every smaller M swept;
    logged beside each wrapper's M0. Returns {kernel: swept M0}."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    keep = qm.M0, pm.M0
    total: dict = {}
    try:
        for name, k, o in shapes:
            weights = {"K3": qmm_weights(gen, dev, None, k, o),
                       "K7 4-bit": qmm_weights(gen, dev, 4, k, o)}
            copies = {kern: cold_copies(*w) for kern, w in weights.items()}
            for m in M0_ROWS:
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                t = {}
                for kern, cps in copies.items():
                    def fns():
                        if kern == "K3":
                            return [lambda c=c: qm.int8_matmul_kernel(x, *c) for c in cps]
                        return [lambda c=c: pm.packed_matmul_kernel(x, *c, 4, 64) for c in cps]

                    qm.M0 = pm.M0 = 1 << 30
                    t[kern, "gemv"] = COLD.get((kern, k, o, m)) or cold_ms(fns())
                    qm.M0 = pm.M0 = 0
                    t[kern, "tile"] = COLD.get(("tile " + kern, k, o, m)) or cold_ms(fns())
                    COLD["tile " + kern, k, o, m] = t[kern, "tile"]
                    for path in ("gemv", "tile"):
                        total[kern, path, m] = total.get((kern, path, m), 0.0) + t[kern, path]
                log(f"[{tag}] M0 sweep, {name} M={m} (cold): K3 GEMV {t['K3', 'gemv']:.4f} ms, "
                    f"tile {t['K3', 'tile']:.4f}; K7 4-bit GEMV {t['K7 4-bit', 'gemv']:.4f}, "
                    f"tile {t['K7 4-bit', 'tile']:.4f}")
            del copies, weights
            torch.cuda.empty_cache()
    finally:
        qm.M0, pm.M0 = keep
    swept = {}
    for kern in ("K3", "K7 4-bit"):
        m0 = 0
        for m in M0_ROWS:
            if total[kern, "gemv", m] >= total[kern, "tile", m]:
                break
            m0 = m
        swept[kern] = m0
        log(f"[{tag}] M0 sweep, {kern} summed over {len(shapes)} shapes (cold): "
            + ", ".join(f"M={m} GEMV {total[kern, 'gemv', m]:.4f} / tile "
                        f"{total[kern, 'tile', m]:.4f} ms" for m in M0_ROWS))
    log(f"[{tag}] M0 sweep: the GEMV is faster summed over the shapes up to M = "
        f"{swept['K3']} (K3), {swept['K7 4-bit']} (K7 4-bit); the wrappers' M0: K3 {qm.M0}, "
        f"K7 {pm.M0}")
    return swept


def graph_ms(fn, iters: int = 50) -> float:
    """ms a call by replaying a CUDA graph of one call (device time)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(lambda: [graph.replay() for _ in range(iters)]) / iters


# the weights of a cold call: copies that together pass the 50 MB L2
COLD_BYTES = 64 << 20


def cold_copies(*tensors, min_copies: int = 4) -> list:
    """Copies of `tensors` (a call's weights), as many as it takes for the
    copies together to pass COLD_BYTES: a call on one copy finds its bytes
    evicted by the calls on the others."""
    n = max(min_copies, -(-COLD_BYTES // max(nbytes(*tensors), 1)) + 1)
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def cold_ms(fns, reps: int = 3) -> float:
    """ms a call with its weights cold, amortised: one CUDA graph of
    len(fns) calls, each fn on its own copy of the weights (cold_copies),
    replayed; the least of `reps` replays over the calls. The graph also
    drops the host's launch from each call."""
    import torch

    for fn in fns[:2]:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = min(_events_ms(graph.replay) for _ in range(reps))
    del graph
    return best / len(fns)


def launch_floor_ms(blocks: int, store: bool = False, n: int = 64) -> float:
    """An empty kernel of `blocks` blocks of 256 threads (csrc/
    launch_floor.cu), writing one float a block where `store`, launched n
    times in one CUDA graph as cold_ms launches a call: the floor under a
    GEMV's cold time."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import _build

    outs = [torch.empty(blocks, device="cuda") if store else None for _ in range(n)]

    def launch(out):
        _build.check(_build.lib().qt_empty_launch(blocks, 256, _build.ptr(out), _build.stream()),
                     "qt_empty_launch")

    return cold_ms([lambda o=o: launch(o) for o in outs])


def upsample_ops(sp: dict, t: int) -> int:
    """2 x the multiply-adds of one K5 stage call on [1, t, C]: the up
    GEMM, the depthwise taps and the 2t-row pointwise GEMMs (and the
    initial conv)."""
    c = sp["dw"].shape[1]
    return (2 * t * sp["up_w"].numel()
            + 2 * 2 * t * (weight_numel(sp, ("pw1_w", "pw2_w", "ic_w")) + 7 * c))


def upsample_phases(sp: dict, x, label: str):
    """K5's time by phase (bf16 weights, fp32 input as the pipeline's):
    the kernel's own clock at each phase boundary (upsample_stage_kernel's
    `stamps`), the median of 9 calls; returns the stage's output."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import upsample_kernel as upk

    names = upk.stage_phases("ic_w" in sp, x.dtype == torch.float32)
    stamps = torch.zeros(len(names) + 1, dtype=torch.int64, device=x.device)
    runs = []
    for _ in range(9):
        out = upk.upsample_stage_kernel(sp, x, stamps=stamps)
        torch.cuda.synchronize()
        runs.append(stamps.diff().double().cpu() / 1e3)
    us = torch.stack(runs).median(0).values.tolist()
    log(f"[kernels] upsample_stage {label} bf16 by phase (us, each up to and with its barrier; "
        f"median of 9): " + ", ".join(f"{n} {v:.1f}" for n, v in zip(names, us))
        + f"; sum {sum(us):.1f}")
    return out


def profiled_kernels(call, n: int, with_device_us: bool = False):
    """The device kernels of n calls in one torch.profiler window, and the
    records each window saw. A window can come back with fewer records than
    kernels ran (0 of 1 or 3 of 4, in about one chip_smoke run of six, on
    this tree and its parents alike; cp_frame's first two windows of forty
    once saw 2 and 3 of 4 while its 300 runs were bit-identical and every
    later window saw 4), so a window short of n records of one name is
    taken again, up to five windows; more records, or another
    kernel's, end the windows at once and the caller fails on them. Returns
    (names of the last window, records per window[, its device us])."""
    import torch

    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        seen.append(len(kernels))
        if len(kernels) >= n or len(set(kernels)) > 1:
            break
    return (kernels, seen, device_us(prof)) if with_device_us else (kernels, seen)


def one_kernel_per_call(name: str, label: str, call, event_ms: float, ops: int,
                        expect: str | None = None) -> None:
    """A call is one device kernel: torch.profiler over 4 calls sees 4
    device kernels of one name; its profiler device time beside its
    CUDA-event time (the gap is host dispatch), and the bf16 TFLOP/s it
    reaches. A profiler window taken later in the kernels phase, after its
    K3 / K7 timings, has lost the record of one of the 4 kernels, in every
    window (the same calls profiled at the start of the phase, or in a
    process of their own, show all 4; why is not known), so the check runs
    at the start of the phase (windows: profiled_kernels)."""
    call()
    kernels, seen, dev_us = profiled_kernels(call, 4, with_device_us=True)
    if len(kernels) > 4 or len(set(kernels)) > 1:
        raise SystemExit(f"{name} is not one device kernel per call: {kernels}")
    if expect and not all(expect in k for k in kernels):
        raise SystemExit(f"{name} {label} did not launch {expect}: {kernels}")
    dev_ms = dev_us / 1e3 / max(len(kernels), 1)
    log(f"[kernels] {name} {label} bf16: 4 calls ran {len(kernels)} device kernels "
        f"({sorted(set(kernels))}; records per window {seen}); device time {dev_ms:.4f} ms a "
        f"call (profiler) against {event_ms:.4f} ms (events); {ops / event_ms / 1e9:.1f} "
        f"TFLOP/s of the card's 989")
    if len(kernels) != 4:
        raise SystemExit(f"{name}: no profiler window saw one device kernel per call")


def conv_yardstick(bp: dict, y) -> None:
    """K6's launch of block 0's first 7-tap conv (d = 1, bf16 weights and
    operand, its SnakeBeta epilogue) beside one bf16 torch conv1d (cuDNN)
    of the same conv on the same operand: a yardstick for the tile, not
    K6's function (conv1d has no causal zeroing or SnakeBeta epilogue),
    and no port path calls conv1d."""
    import torch
    import torch.nn.functional as F

    from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

    b, s, c = y.shape
    a = vk._snake(y.float(), bp["u_a1"][0], bp["u_binv1"][0]).to(torch.bfloat16)
    flat = a.reshape(b * s, c)
    a2 = torch.empty_like(flat)

    def kernel():
        vk._conv(flat, bp["u_w1"][0], b=b, s=s, taps=7, dil=1, bias=bp["u_b1"][0], act=a2,
                 snake=(bp["u_a2"][0], bp["u_binv2"][0]))

    w = bp["u_w1"][0].reshape(7, c, c).permute(2, 1, 0).contiguous()  # [out, in, k]
    xin = F.pad(a.transpose(1, 2), (6, 0))
    ops = 2 * b * s * 7 * c * c
    k_ms, k_how = time_ms(kernel, 20)
    l_ms, l_how = time_ms(lambda: F.conv1d(xin, w), 20)
    log(f"[kernels] yardstick, block 0's first 7-tap conv at S={s}, C={c}: K6's launch "
        f"{k_ms:.4f} ms ({k_how}, {ops / k_ms / 1e9:.1f} TFLOP/s), one bf16 torch conv1d "
        f"{l_ms:.4f} ms ({l_how}, {ops / l_ms / 1e9:.1f} TFLOP/s)")


def upsample_yardstick(bp: dict, x, rate: int, label: str) -> None:
    """The block upsample's 2-tap conv beside the form it replaced: SnakeBeta
    and two bf16 torch matmuls whose bf16 products are summed (not the JAX
    package's function, which keeps the products in fp32; no port path
    calls it)."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

    b, t, cin = x.shape

    def matmuls():
        xs = vk._snake(x.float(), bp["snake_a"], bp["snake_binv"]).bfloat16()
        prev = torch.nn.functional.pad(xs, (0, 0, 1, 0))[:, :t]
        acc = (xs @ bp["up_w"][cin:]).float() + (prev @ bp["up_w"][:cin]).float()
        return (acc + bp["up_b"]).reshape(b, t * rate, -1).to(x.dtype)

    k_ms, k_how = time_ms(lambda: vk.block_upsample_kernel(bp, x, rate=rate), 20)
    m_ms, m_how = time_ms(matmuls, 20)
    log(f"[kernels] yardstick, block_upsample {label}: the 2-tap conv {k_ms:.4f} ms ({k_how}), "
        f"the SnakeBeta + two bf16 torch matmuls it replaced {m_ms:.4f} ms ({m_how})")


def chisq_pvalue(counts, probs) -> float:
    """Chi-square goodness of fit with bins of expectation below 5 merged."""
    from scipy import stats

    counts = np.asarray(counts, np.float64)
    exp = np.asarray(probs, np.float64) * counts.sum()
    order = np.argsort(exp)
    counts, exp = counts[order], exp[order]
    while len(exp) > 2 and exp[0] < 5.0:
        exp[1] += exp[0]
        counts[1] += counts[0]
        exp, counts = exp[1:], counts[1:]
    exp *= counts.sum() / exp.sum()
    return float(stats.chisquare(counts, exp).pvalue)


def talker_case(rec: Record, tkp: dict, cfg, gen, dt, ws: int, main: bool,
                tag: str = "megakernels"):
    """K1 against its plain version at C = 260, position 300, window start
    `ws`: h, logits and the new K/V rows within TOL_W8A8; every other ring
    slot untouched and pos[slot] written; in fp32 on the main case, the K/V
    rows of layers 0 and 1 within ROW_TOL (a fault in layer 0's attention,
    such as a lost current-token column or a wrong window, shows there).
    Returns (ms, weight bytes, the call's inputs)."""
    import torch

    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    dev = torch.device("cuda")
    dtype = str(dt).split(".")[-1]
    nl, kvw, hc = cfg.num_hidden_layers, cfg.num_key_value_heads * cfg.head_dim, cfg.hidden_size
    c_len, position = 260, 300
    slots = torch.arange(c_len, device=dev)
    pos = torch.where(slots < position % c_len, slots + c_len, slots)
    n_valid = int(((pos >= 0) & (pos >= ws)).sum())
    cos, sin = talker_mod.rope_cos_sin(cfg, torch.full((1, 1), position, device=dev))
    cos, sin = cos[0, 0], sin[0, 0]
    pos_t, ws_t = torch.tensor(position, device=dev), torch.tensor(ws, device=dev)
    slot = position % c_len
    cache = {"k2": (torch.randn(nl, c_len, kvw, generator=gen, device=dev) * 0.3).to(dt),
             "v2": (torch.randn(nl, c_len, kvw, generator=gen, device=dev) * 0.3).to(dt),
             "pos": pos}
    embed = (torch.randn(1, 1, hc, generator=gen, device=dev) * 0.5).to(dt)
    ck = {k: v.clone() for k, v in cache.items()}
    cp = {k: v.clone() for k, v in cache.items()}
    hk, lk, _ = tmk.talker_step_kernel(tkp, embed, ck, pos_t, ws_t, cos, sin, cfg)
    hp, lp, _ = tmk.talker_step_plain(tkp, embed, cp, pos_t, ws_t, cos, sin, cfg)
    torch.cuda.synchronize()
    errs = [rel_rms(hk.float(), hp.float()), rel_rms(lk, lp)]
    for name in ("k2", "v2"):
        errs.append(rel_rms(ck[name][:, slot].float(), cp[name][:, slot].float()))
    untouched = all(torch.equal(torch.cat([ck[n][:, :slot], ck[n][:, slot + 1:]], 1),
                                torch.cat([cache[n][:, :slot], cache[n][:, slot + 1:]], 1))
                    for n in ("k2", "v2"))
    pos_ok = torch.equal(ck["pos"], cp["pos"]) and int(ck["pos"][slot]) == position
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (hk, lk))
    per_layer = [max(rel_rms(ck[n][l, slot].float(), cp[n][l, slot].float())
                     for n in ("k2", "v2")) for l in range(nl)]
    apart = [e > ROW_TOL for e in per_layer]
    first = apart.index(True) if any(apart) else nl
    rows_ok = not (main and dt == torch.float32) or first >= 2
    err = max(errs) if (untouched and pos_ok and finite and rows_ok) else float("nan")
    flip = int(torch.argmax(lk)) != int(torch.argmax(lp))
    log(f"[{tag}] talker_step {dtype} window={ws}: K/V row rel RMS per layer, kernel vs "
        "plain: " + " ".join(f"{e:.1e}" for e in per_layer))
    esize = torch.finfo(dt).bits // 8
    w_names = [f"{p}_{s}" for p in ("qkv", "o", "gu", "dn", "ch") for s in "qsm"]
    w_bytes = nbytes(*(tkp[n] for n in w_names),
                     *(tkp[n] for n in ("in_ln", "post_ln", "q_ln", "k_ln", "fin_ln")))
    int8_ops = 2 * sum(tkp[f"{p}_q"].numel() for p in ("qkv", "o", "gu", "dn", "ch"))
    nb = w_bytes + (n_valid * 2 + 2) * nl * kvw * esize + 2 * hc * esize + lk.numel() * 4
    attn_ops = 4 * cfg.num_attention_heads * cfg.head_dim * (n_valid + 1) * nl
    timing = time_ms(lambda: tmk.talker_step_kernel(tkp, embed, ck, pos_t, ws_t, cos, sin, cfg),
                     20)
    rec.add("talker_step", f"C={c_len} pos={position} window={ws} ({n_valid} slots)", dtype,
            err, float((lk - lp).abs().max()), TOL_W8A8[dtype], timing,
            time_ms(lambda: tmk.talker_step_plain(tkp, embed, cp, pos_t, ws_t, cos, sin, cfg),
                    3),
            nb, {"int8": int8_ops, "float32": attn_ops},
            extra=f" (h, logits, k row, v row: {', '.join(f'{e:.1e}' for e in errs)}; "
                  f"argmax {'differs' if flip else 'agrees'}; K/V rows agree to {ROW_TOL:g} "
                  f"through layer {first - 1}"
                  f"{'' if rows_ok else ', need layer 1'}; ring and pos "
                  f"{'ok' if untouched and pos_ok else 'WRONG'})",
            timed=main)
    return timing[0], w_bytes, (embed, cache, pos_t, ws_t, cos, sin)


def cp_bytes(ckp: dict) -> tuple[int, int]:
    """K2's layer-set bytes (int8 weights, scales, norms) and lm-head bytes."""
    lay_names = [f"{p}_{s}" for p in ("qkv", "o", "gu", "dn") for s in "qsm"]
    lay = nbytes(*(ckp[n] for n in lay_names),
                 *(ckp[n] for n in ("in_ln", "post_ln", "q_ln", "k_ln", "fin_ln")))
    return lay, nbytes(ckp["head_q"], ckp["head_s"], ckp["head_m"])


def cp_inputs(cfg, gen, dt):
    """K2's inputs in dtype dt: the talker's hidden state and code 0's
    embedding [1, 1, talker hidden], and a seen set [ng, V] (30% marked)."""
    import torch

    cc, dev = cfg.code_predictor_config, gen.device
    hidden = torch.randn(1, 1, cfg.hidden_size, generator=gen, device=dev).to(dt)
    code0 = (torch.randn(1, 1, cfg.hidden_size, generator=gen, device=dev) * 0.5).to(dt)
    seen = torch.rand(cc.num_code_groups - 1, cc.vocab_size, generator=gen, device=dev) < 0.3
    return hidden, code0, seen


def cp_case(rec: Record, ckp: dict, cfg, inputs, seed, temp: float, track: bool,
            timed: bool | None = None):
    """K2 against its plain version on one frame at temperature `temp`,
    with (`track`) or without the repetition penalty: the plain version
    replays the kernel's codes; each of its own picks (its logits, the
    penalty and the same Gumbel noise) must be the kernel's except at a
    near tie; the embedding sum and the seen set equal; the logits within
    TOL_W8A8. Returns ((ms, method), inputs). `timed` (default: `track`)
    puts the time in the kernel's row."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs

    cc, dev = cfg.code_predictor_config, seed.device
    ng, v, chc = cc.num_code_groups - 1, cc.vocab_size, cc.hidden_size
    hidden, code0, seen = inputs
    dtype = str(hidden.dtype).split(".")[-1]
    th = ckp["embr_q"].shape[-1]
    lay_bytes, head_bytes = cp_bytes(ckp)
    cp_ops = (2 * (ng + 1) * sum(ckp[f"{p}_q"].numel() for p in ("qkv", "o", "gu", "dn"))
              + 2 * ckp["head_q"].numel())
    sk = seen.clone() if track else None
    lk = torch.empty(ng, v, device=dev)
    codes, ek, sk = cpk.predict_frame_kernel(ckp, hidden, code0, seed, temp, sk, cc, 1.05,
                                             None, lk)
    sp = seen.clone() if track else None
    lp = torch.empty(ng, v, device=dev)
    _, ep, sp = cpk.predict_frame_plain(ckp, hidden, code0, seed, temp, sp, cc, 1.05, codes, lp)
    torch.cuda.synchronize()
    noise = temp * gs.gumbel_noise(seed, ng, v) if temp > 0 else None
    agree, ties, bad = 0, 0, 0
    for k in range(ng):
        score = lp[k] / torch.where(seen[k], 1.05, 1.0) if track else lp[k]
        if noise is not None:
            score = score + noise[k]
        pick, want = int(torch.argmax(score)), int(codes[k])
        if pick == want:
            agree += 1
        elif float(score[pick] - score[want]) <= NEAR_TIE * float(score.abs().max()):
            ties += 1
        else:
            bad += 1
    same = torch.equal(ek, ep) and (not track or torch.equal(sk, sp))
    err = rel_rms(lk, lp)
    if bad or not same or not bool(torch.isfinite(lk).all()):
        err = float("nan")
    esize = hidden.element_size()
    nb = (lay_bytes + head_bytes + nbytes(ckp["cos"], ckp["sin"]) + 2 * chc * 4
          + (ng - 1) * (chc + 8) + ng * (th + 8) + 2 * th * esize + lk.numel() * 4 + ng * 8
          + (2 * ng * v if track else 0))
    sk2 = seen.clone() if track else None
    sp2 = seen.clone() if track else None
    timing = time_ms(lambda: cpk.predict_frame_kernel(ckp, hidden, code0, seed, temp, sk2, cc),
                     10)
    rec.add("cp_frame", f"penalty={'on' if track else 'off'} T={temp:g} th={th}", dtype, err,
            float((lk - lp).abs().max()), TOL_W8A8[dtype], timing,
            time_ms(lambda: cpk.predict_frame_plain(ckp, hidden, code0, seed, temp, sp2, cc),
                    2),
            nb, {"int8": cp_ops},
            extra=f" (codes: {agree}/{ng} picked alike, {ties} near ties; embedding sum "
                  f"[{th}] {'equal' if torch.equal(ek, ep) else 'DIFFERS'})",
            timed=track if timed is None else timed)
    return timing, inputs



def phase_megakernels(rec: Record, card: str, talker_dense: dict, cp_dense: dict) -> None:
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.convert import to_torch
    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    dev = torch.device("cuda")
    cfg = qt.Qwen3TTSConfig.standard()
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    tkp = to_torch(tmk.build_talker_kernel_params(talker_dense, cfg), dev)
    ckp = to_torch(cpk.build_cp_kernel_params(cp_dense, cfg.code_predictor_config), dev)
    log(f"[megakernels] built the 0.6B K1 / K2 trees in {time.perf_counter() - t0:.1f} s")

    # K1: ring of C = 260 (prompt 36 + 224) at position 300: slots 0..39 hold
    # 260..299 (wrapped), and slot 40, where the token goes, holds 40 (masked,
    # as in decoding). Window start 99 (trimmed at step 255, ~200 valid
    # slots) is the main path's case; window start 297 leaves 3 valid slots,
    # so the current token's own term carries about a quarter of each head's
    # attention and a fault in it moves the logits far past TOL_W8A8.
    k1 = {}
    for dtype in ("float32", "bfloat16"):
        for ws in (99, 297):
            k1[dtype, ws] = talker_case(rec, tkp, cfg, gen, getattr(torch, dtype), ws,
                                        main=ws == 99)

    # K2: one frame, temperature 0.85, with and without the penalty; the
    # plain version replays the kernel's codes and its own picks must match
    # except at near ties
    seed = torch.tensor([20240607], device=dev)
    k2 = {}
    for dtype in ("float32", "bfloat16"):
        inputs = cp_inputs(cfg, gen, getattr(torch, dtype))
        for track in (True, False):
            k2[dtype, track] = cp_case(rec, ckp, cfg, inputs, seed, 0.85, track)
    cc = cfg.code_predictor_config
    v = cc.vocab_size
    persistent_checks(card, cfg, tkp, ckp, seed, k1[("bfloat16", 99)], k2[("bfloat16", True)])

    # K2's draws: a frame at temperature 0, where the pick skips Philox and
    # both logs, against one at 0.85, in turns (bf16, penalty on)
    hidden, code0, seen = k2[("bfloat16", True)][1]
    by_temp = {0.0: [], 0.85: []}
    for _ in range(3):
        for temp in (0.0, 0.85, 0.85, 0.0):
            s2 = seen.clone()
            by_temp[temp].append(time_ms(lambda: cpk.predict_frame_kernel(
                ckp, hidden, code0, seed, temp, s2, cc), 20)[0])
    med = {temp: float(np.median(v)) for temp, v in by_temp.items()}
    log(f"[megakernels] cp_frame bf16 penalty on: {med[0.0]:.4f} ms at temperature 0, "
        f"{med[0.85]:.4f} ms at 0.85 (medians of 6 in turns; runs {by_temp}): the draws' "
        f"noise {(med[0.85] - med[0.0]) * 1e3:.2f} us a frame ({card})")

    # K2g: the kernel draws exactly the plain version's codes; 100k draws
    # follow softmax(lg / T)
    logits = torch.randn(v, generator=gen, device=dev) * 2.0
    gseed = torch.tensor([7], device=dev)
    got = gs.gumbel_sample_kernel(logits, gseed, 0.85, 100_000)
    ref = gs.gumbel_sample_plain(logits, gseed, 0.85, 4096)
    torch.cuda.synchronize()
    lb = logits.bfloat16()  # logits as a bf16 model hands them over
    same = (int((got[:4096] != ref).sum())
            + int((gs.gumbel_sample(lb, gseed, 0.85, 4096)
                   != gs.gumbel_sample_plain(lb, gseed, 0.85, 4096)).sum()))
    p = torch.softmax(logits.double() / 0.85, 0).cpu().numpy()
    pval = chisq_pvalue(np.bincount(got.cpu().numpy(), minlength=v), p)
    greedy_ok = bool((gs.gumbel_sample_kernel(logits, gseed, 0.0, 64) == torch.argmax(logits))
                     .all())
    log(f"[megakernels] gumbel_sample: 100000 draws over V={v} at T=0.85: chi-square p = "
        f"{pval:.4f} (need >= 1e-3); the first 4096 draws from fp32 and from bf16 logits "
        f"differ from the plain version's in {same}; greedy draws are the argmax: "
        f"{greedy_ok}")
    if pval < 1e-3 or same or not greedy_ok:
        raise SystemExit("the Gumbel sampler kernel is off")
    one = logits.clone()
    ops = v * 110  # Philox-4x32-10 (~100 integer operations), two logs, select
    rec.add("gumbel_sample", f"1 draw V={v} (as in K2)", "bfloat16", 0.0, 0.0, 0.0,
            time_ms(lambda: gs.gumbel_sample_kernel(one, gseed, 0.85, 1), 50),
            time_ms(lambda: gs.gumbel_sample_plain(one, gseed, 0.85, 1), 20),
            v * 4 + 16, {"float32": ops})
    torch.cuda.synchronize()


def device_kernels(prof) -> list[str]:
    """Names of the device activities (kernels, copies) a profiler run saw."""
    import torch

    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def window_device(prof, n: int, label: str, what: str, top: int = 0) -> tuple[float, float]:
    """(device ms, device kernels) a call of a profiler window of n calls
    (`what`); logs its `top` rows by device time."""
    rows = []
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / n / 1e3, e.count // n, e.key[:60]))
    for ms, k, key in sorted(rows, reverse=True)[:top]:
        log(f"[{label}]   {what}: {ms:.3f} ms in {k} launches: {key}")
    return device_us(prof) / 1e3 / n, len(device_kernels(prof)) / n


def persistent_checks(card: str, cfg, tkp: dict, ckp: dict, seed, k1_main, k2_main,
                      tag: str = "megakernels", one_kernel: bool = True) -> None:
    """K1 and K2 as persistent cooperative launches at cfg's widths, bf16
    (the main cases): each launch's grid and dynamic shared memory; one device kernel
    per call (torch.profiler; where `one_kernel`); two runs bit for bit alike; the weight bytes
    per second each achieves; and the cost of one grid barrier, timed as a
    launch of n barriers (csrc/grid_barrier.cu), times the barriers a step
    and a frame make: the design's floor."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import persistent as ps
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    dev = torch.device("cuda")
    cc = cfg.code_predictor_config
    k1_ms, k1_bytes, (embed, cache, pos_t, ws_t, cos, sin) = k1_main
    (k2_ms, _), (hidden, code0, seen) = k2_main
    tplan, cplan = ps.talker_plan(cfg, cache["pos"].shape[0], dev), ps.cp_plan(cc, dev)
    for name, pl in (("talker_step (K1)", tplan), ("cp_frame (K2)", cplan)):
        log(f"[{tag}] {name}: one cooperative launch of {pl.grid} blocks x {ps.PK_NT} "
            f"threads, {pl.smem} bytes of dynamic shared memory ({pl.buf} per weight buffer), "
            f"attention in {pl.nch} chunk(s) of {pl.S} slots per kv head")

    def k1():
        c = {k: v.clone() for k, v in cache.items()}
        h, lg, c = tmk.talker_step_kernel(tkp, embed, c, pos_t, ws_t, cos, sin, cfg)
        return h, lg, c["k2"], c["v2"], c["pos"]

    def k2():
        lg = torch.empty(cc.num_code_groups - 1, cc.vocab_size, device=dev)
        codes, esum, s = cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85,
                                                  seen.clone(), cc, logits_out=lg)
        return codes, esum, s, lg

    calls = (lambda: tmk.talker_step_kernel(tkp, embed, cache, pos_t, ws_t, cos, sin, cfg),
             lambda: cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85, None, cc))
    for name, fn, call in (("talker_step", k1, calls[0]), ("cp_frame", k2, calls[1])):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        differ = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
        call()
        torch.cuda.synchronize()
        if differ:
            raise SystemExit(f"{name}: two runs on the same inputs differ in outputs {differ}")
        if not one_kernel:
            log(f"[{tag}] {name}: two runs bit-identical: True ({card})")
            continue
        kernels, windows = profiled_kernels(call, 4)
        log(f"[{tag}] {name}: two runs bit-identical: True; 4 calls ran "
            f"{len(kernels)} device kernels ({sorted(set(kernels))}; records per window "
            f"{windows}) ({card})")
        if len(kernels) != 4 or len(set(kernels)) != 1:
            raise SystemExit(f"{name} is not one device kernel per call: {kernels} "
                             f"(records per window {windows})")


    n_pass = cc.num_code_groups
    per_step = 5 * cfg.num_hidden_layers
    per_frame = n_pass * 5 * cc.num_hidden_layers + (n_pass - 1)
    ps.grid_barriers(16)
    torch.cuda.synchronize()
    n = 4000
    t0 = min(_events_ms(lambda: ps.grid_barriers(0)) for _ in range(5))
    tn = min(_events_ms(lambda: ps.grid_barriers(n)) for _ in range(5))
    us = (tn - t0) / n * 1e3
    log(f"[{tag}] grid barrier: {us:.3f} us each ({n} in one launch of "
        f"{tplan.grid} blocks, less an empty launch); {per_step} per talker step = "
        f"{per_step * us / 1e3:.4f} ms, {per_frame} per code-predictor frame = "
        f"{per_frame * us / 1e3:.4f} ms ({card})")
    lay_bytes, head_bytes = cp_bytes(ckp)
    once = lay_bytes + head_bytes
    streamed = n_pass * lay_bytes + head_bytes
    log(f"[{tag}] talker_step bf16: {k1_ms:.4f} ms for {k1_bytes} weight bytes = "
        f"{k1_bytes / k1_ms / 1e9:.3f} TB/s of the card's 3.35; cp_frame bf16: {k2_ms:.4f} ms: "
        f"{once} weight bytes read once = {once / k2_ms / 1e9:.3f} TB/s, {streamed} streamed "
        f"over the {n_pass} passes = {streamed / k2_ms / 1e9:.3f} TB/s ({card})")


def _counting(gen_mod):
    """Wrap gen_mod.filter_valid_frames to record the frames kept."""
    kept: list[int] = []
    filt = gen_mod.filter_valid_frames

    def counting_filter(frames):
        out = filt(frames)
        kept.append(len(out))
        return out

    gen_mod.filter_valid_frames = counting_filter
    return kept, filt


def run_pipeline(card: str, d: str, label: str, configuration, need: tuple[str, ...],
                 idle: tuple[str, ...], frames: int = 96):
    """Load, generate (`frames` frames) and stream on one configuration;
    returns (pipeline, launch counts of this run, metrics)."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    spf = qt.TokenizerDecoderConfig().total_upsample
    kept, filt = _counting(gen_mod)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = qt.Qwen3TTSPipeline(d, configuration, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        audio = pl.generate(TEXT, speaker="aiden", max_tokens=frames, seed=0)
        gen_s = time.perf_counter() - t0
        frames = kept[-1]
        ok = bool(np.isfinite(audio).all()) and len(audio) == frames * spf
        log(f"[{label}] generate: {frames} valid frames, {len(audio)} samples "
            f"(expect {frames} x {spf}), finite={bool(np.isfinite(audio).all())} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok or frames == 0:
            raise SystemExit("generate() output is wrong")
        dur = len(audio) / pl.sample_rate

        kept.clear()
        t0 = time.perf_counter()
        first = None
        chunks = []
        for ch in pl.generate_stream(TEXT, speaker="aiden", max_tokens=frames, seed=0):
            if first is None and len(ch.samples):
                first = time.perf_counter() - t0
            chunks.append(ch)
        stream_s = time.perf_counter() - t0
        pos = 0
        for ch in chunks:
            a, b = ch.token_range
            if (a != pos or len(ch.samples) != (b - a) * spf
                    or not np.isfinite(ch.samples).all()):
                raise SystemExit(f"stream chunk {ch.token_range} does not tile the frames")
            pos = b
        if pos != sum(kept) or not chunks[-1].is_final or len(chunks[-1].samples):
            raise SystemExit(f"stream covered {pos} frames of {sum(kept)}")
        launches = read_counts()
    finally:
        gen_mod.filter_valid_frames = filt
    prefill = prefill_ms(pl, label, card)
    metrics = {"load_s": load_s, "generate_s": gen_s, "rtf": gen_s / dur,
               "stream_rtf": stream_s / (pos * spf / pl.sample_rate),
               "first_audio_s": first, "resident_bytes": pl.model_resident_bytes(),
               "prefill_ms": prefill}
    log(f"[{label}] load {load_s:.2f} s, generate {gen_s:.2f} s for {dur:.2f} s of audio, "
        f"RTF {metrics['rtf']:.3f}; generate_stream: {len(chunks)} chunks over {pos} frames, "
        f"first audio {first:.2f} s, RTF {metrics['stream_rtf']:.3f}; resident "
        f"{metrics['resident_bytes']} bytes ({card}, bf16)")
    check_counts(label, launches, need, idle)
    return pl, launches, metrics


def text_projection(pl, card: str, label: str, kernel: str) -> None:
    """K3 (kernel "K3") or K7 ("K7") at the shapes the prompt's text
    projection hands it on this configuration (K3's only launches in the
    megakernel configuration, K7's in the pre-quantized one): each shape's
    time beside its bound and its plain version's, from the calls one
    prompt assembly makes."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    mod, attr, plain = ((qm, "int8_matmul_kernel", qm.int8_matmul_plain) if kernel == "K3"
                        else (pm, "packed_matmul_kernel", pm.packed_matmul_plain))
    calls = []
    fn = getattr(mod, attr)

    def recording(*args):
        calls.append(args)
        return fn(*args)

    setattr(mod, attr, recording)
    try:
        pl._assemble(TEXT, "aiden")
    finally:
        setattr(mod, attr, fn)
    torch.cuda.synchronize()
    seen = {}
    for args in calls:
        x, w = args[0], args[1]
        seen.setdefault((x.shape[0], x.shape[1], w.shape[0], str(x.dtype)[6:]), []).append(args)
    for (m, k, o, dt), same in seen.items():
        args = same[0]
        ms = graph_ms(lambda: fn(*args))
        ev = _events_ms(lambda: [fn(*args) for _ in range(20)]) / 20
        p_ms, p_how = time_ms(lambda: plain(*args), 10)
        nb = (nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
              + m * o * args[0].element_size())
        b_ms, b_by = bound(nb, {dt: 2 * m * k * o})
        log(f"[{label}] {kernel} in the text projection: M={m} K={k} O={o} {dt}, {len(same)} "
            f"launch(es) a prompt ({'GEMV' if m <= mod.M0 else 'tile'}): {ms:.4f} ms (graph; "
            f"{ev:.4f} by events with the host's dispatch) against a bound of {b_ms:.4f} ms "
            f"({b_by}); plain {p_ms:.4f} ms ({p_how}) ({card})")


def prefill_ms(pl, label: str, card: str) -> float:
    """generate.prefill's wall time on this configuration (after the
    prompt's assembly, each run ended by a device sync): the median of 7."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    pd = pl._assemble(TEXT, "aiden")
    gen_mod.prefill(pl.params, pd, pl.config)
    runs = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_mod.prefill(pl.params, pd, pl.config)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(runs))
    log(f"[{label}] generate.prefill of the {pd.input_embeds.shape[1]}-row prompt: {med:.3f} ms "
        f"(median of 7, {min(runs):.3f}-{max(runs):.3f}) ({card}, bf16)")
    return med


def no_sync_chunk(pl, label: str) -> None:
    """A 3-frame decode chunk queues without a host sync."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    state = gen_mod.prefill(pl.params, pl._assemble(TEXT, "aiden"), pl.config)
    kw = dict(steps=3, temperature=0.85, track_cp_penalty=True,
              generator=torch.Generator(device="cuda").manual_seed(0))
    gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[{label}] a 3-frame decode chunk ran with torch's sync debug mode set to error: "
        "no host sync inside the chunk")


def _clone_state(state: dict) -> dict:
    """A copy of a decode state that steps on its own (the masks are read
    only and stay shared)."""
    return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.clone() if hasattr(v, "clone") else v)
            for k, v in state.items()}


# The 0.6B frame loops and the pre-quantized 1.7B one are teacher-forced
# over their first 16 frames, for the script's time (the plain K1 / K2
# steps cost ~0.3 s a frame). None of 96 reached a window trim or the
# ring's wrap at 0.6B (the 1.7b phase's frames 216-231 do); the W8A8 drift
# grows with the steps, so the shorter run reads less of it (3.5e-2 at
# most over 96 at 0.6B).
TF_FRAMES = 16
# The K3 and mixed pipelines' frames: host-bound at ~0.15-0.26 s a frame
HOST_BOUND_FRAMES = 4


def teacher_forced(pl, card: str, label: str = "pipeline", frames: int = 96,
                   start: int = 0) -> dict:
    """K1 + K2 against their plain versions, teacher-forced over the frames
    generate() makes (up to `frames`): both decode the same frames from
    their own states; the talker logits after each step are compared. The
    two rings drift apart by the W8A8 rounding steps of every earlier step,
    so the tolerance is TOL_W8A8's (measured 3.3e-2 at most over the 96
    frames at 0.6B). With `start`, the kernels alone decode the first
    `start` frames and the plain state starts as a copy of theirs, so that
    the compared frames reach the window's trims and the ring's wrap at the
    price of the plain stepping over the compared frames only."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    pd = pl._assemble(TEXT, "aiden")
    codes = torch.from_numpy(gen_mod.generate_codes(
        pl.params, pl.cp_params, pl.config, pd, temperature=0.85, max_tokens=frames, seed=0,
        chunk_steps=12, track_cp_penalty=True,
    )).long().cuda()
    sk = gen_mod.prefill(pl.params, pd, pl.config)
    kw = dict(temperature=0.0, generator=None, track_cp_penalty=True)
    t0 = time.perf_counter()
    for f in codes[:start]:
        gen_mod.decode_step(pl.params, pl.cp_params, sk, pl.config, forced_frame=f, **kw)
    sp = _clone_state(sk) if start else gen_mod.prefill(pl.params, pd, pl.config)
    ws0 = int(sk["window_start"])
    errs, flips = [], 0
    for f in codes[start:]:
        gen_mod.decode_step(pl.params, pl.cp_params, sk, pl.config, forced_frame=f, **kw)
        talker, frame = tmk.talker_step, cpk.predict_frame
        tmk.talker_step, cpk.predict_frame = tmk.talker_step_plain, cpk.predict_frame_plain
        try:
            gen_mod.decode_step(pl.params, pl.cp_params, sp, pl.config, forced_frame=f, **kw)
        finally:
            tmk.talker_step, cpk.predict_frame = talker, frame
        errs.append(rel_rms(sk["logits"], sp["logits"]))
        flips += int(torch.argmax(sk["logits"]) != torch.argmax(sp["logits"]))
    torch.cuda.synchronize()
    if not errs:
        raise SystemExit(f"[{label}] teacher forcing compared no frame ({len(codes)} decoded)")
    out = {"frames": [start, len(codes)], "worst": max(errs), "mean": float(np.mean(errs)),
           "flips": flips, "window_start": [ws0, int(sk["window_start"])],
           "total_len": int(sk["total_len"]), "capacity": int(sk["cache"]["pos"].shape[0]),
           "s": time.perf_counter() - t0}
    log(f"[{label}] teacher-forced over generated frames {start}-{len(codes) - 1}, kernels "
        f"vs plain versions (bf16 model): talker logits rel RMS max {out['worst']:.3e} mean "
        f"{out['mean']:.3e} (tol {TOL_W8A8['bfloat16']:g}), code-0 argmax flips "
        f"{flips}/{len(errs)}; window start {ws0} -> {out['window_start'][1]}, "
        f"{out['total_len']} positions in a ring of {out['capacity']} slots; {out['s']:.1f} s "
        f"({card})")
    if not out["worst"] <= TOL_W8A8["bfloat16"]:
        raise SystemExit("the megakernel decode disagrees with its plain version")
    return out


def mixed_prefill_check(pl, card: str, dtype: str, label: str = "mixed-pipeline") -> float:
    """Prompt assembly and prefill with K7 against the same with K7's plain
    version swapped into the dispatch: talker logits within TOL[dtype] (the
    model's dtype). Returns the rel RMS."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm

    def logits():
        return gen_mod.prefill(pl.params, pl._assemble(TEXT, "aiden"), pl.config)["logits"]

    got = logits()
    kernel = pm.packed_matmul_kernel
    pm.packed_matmul_kernel = pm.packed_matmul_plain
    try:
        ref = logits()
    finally:
        pm.packed_matmul_kernel = kernel
    torch.cuda.synchronize()
    err = rel_rms(got, ref)
    log(f"[{label}] prefill logits, K7 vs its plain version in every packed linear "
        f"({dtype} model): rel RMS {err:.3e} (tol {TOL[dtype]:g}), argmax "
        f"{'agrees' if int(torch.argmax(got)) == int(torch.argmax(ref)) else 'differs'} "
        f"({card})")
    if not err <= TOL[dtype]:
        raise SystemExit(f"[{label}] prefill with K7 disagrees with its plain version")
    return err


def vocoder_check(pl) -> None:
    """The kernel vocoder path against the plain torch vocoder on generated
    codes: with fp32 kernel weights (the exact paths, tol 1e-3), and with
    the pipeline's bf16 kernel weights (K4 and K6 on the tensor cores; tol
    TOL_VOCODER_BF16)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import vocoder as voc

    codes = torch.from_numpy(np.ascontiguousarray(gen_mod.filter_valid_frames(
        gen_mod.generate_codes(pl.params, pl.cp_params, pl.config, pl._assemble(TEXT, "aiden"),
                               temperature=0.85, max_tokens=18, seed=0)).T[None])).long().cuda()
    dense = {k: v for k, v in pl.vocoder_params.items() if k != "kernel"}
    cfg = pl.speech_config.decoder_config
    ref = voc.decode_frames(dense, codes, cfg)
    for dt, tol in ((torch.float32, 1e-3), (torch.bfloat16, TOL_VOCODER_BF16)):
        kern = dict(dense, kernel=voc.build_vocoder_kernel_params(dense, cfg, dt))
        err = rel_rms(voc.decode_frames(kern, codes, cfg), ref)
        log(f"[pipeline] vocoder kernels ({dt} weights) vs plain torch vocoder (fp32) on "
            f"{codes.shape[2]} generated frames: rel_rms={err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise SystemExit("kernel vocoder path disagrees with the plain vocoder")


def vocoder_windows(pl, card: str) -> None:
    """Device time of one vocoder window by kernel (torch.profiler), at the
    stream's 26 rows (18 frames + 8 of context) and generate's 110 (100 +
    10), on the pipeline's kernel vocoder."""
    import torch

    from qwen3_tts_tpu_torch.models import vocoder as voc

    cfg = pl.speech_config.decoder_config
    gen = torch.Generator(device="cuda").manual_seed(5)
    for t in (26, 110):
        codes = torch.randint(0, cfg.codebook_size, (1, cfg.num_quantizers, t), generator=gen,
                              device="cuda")
        voc.decode_frames(pl.vocoder_params, codes, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voc.decode_frames(pl.vocoder_params, codes, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            voc.decode_frames(pl.vocoder_params, codes, cfg)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us / 1e3, e.count, e.key[:60]))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        log(f"[pipeline] one {t}-frame vocoder window: {total:.3f} ms of device time in "
            f"{sum(r[1] for r in rows)} device kernels, {wall:.3f} ms wall ({card})")
        for ms, n, key in rows[:10]:
            log(f"[pipeline]   {ms:.3f} ms in {n} launches: {key}")


def profile_frames(pl, label: str, card: str, steps: int = 8) -> dict:
    """Wall time per frame of a decode chunk against the device time the
    profiler sees in it, and the kernels that take it; returns them (ms a
    frame; "kernels": the top eight by device time; "qmm_by_name": K3's
    and K7's kernels a frame by name)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    state = gen_mod.prefill(pl.params, pl._assemble(TEXT, "aiden"), pl.config)
    kw = dict(temperature=0.85, track_cp_penalty=True,
              generator=torch.Generator(device="cuda").manual_seed(0))
    gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, steps=2, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, steps=steps, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, steps=steps, **kw)
        torch.cuda.synchronize()
    dev_ms = device_us(prof) / 1e3 / steps
    names = device_kernels(prof)
    per_frame = len(names) / steps
    # K3's and K7's kernels a frame by name: each template instance (bits,
    # rows of x a block, x's dtype) is a name of its own
    qmm = {}
    for name, pat in QMM_NAMES.items():
        hits = [k for k in names if pat.search(k)]
        qmm[name] = {k: hits.count(k) / steps for k in sorted(set(hits))}
        if hits:
            log(f"[{label}] {name} kernels a frame by name, {len(hits) / steps:g} in all: "
                + ", ".join(f"{n:g} {k[:60]}" for k, n in qmm[name].items()))
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / steps / 1e3, e.count // steps, e.key[:48]))
    rows.sort(reverse=True)
    if dev_ms > 0:
        log(f"[{label}] frame loop over {steps} frames: wall {wall:.3f} ms/frame, device busy "
            f"{dev_ms:.3f} ms/frame (profiler), idle {100 * (1 - dev_ms / wall):.1f}%, "
            f"{per_frame:.1f} device kernels/frame ({card})")
    else:
        log(f"[{label}] frame loop: wall {wall:.2f} ms/frame; device time not measured "
            "(the profiler saw no device activity)")
    for ms, n, key in rows[:8]:
        log(f"[{label}]   {ms:.3f} ms/frame in {n} launches/frame: {key}")
    return {"wall_ms": wall, "device_ms": dev_ms, "kernels_a_frame": per_frame,
            "kernels": rows[:8], "qmm_by_name": qmm}


def phase_fused_path(card: str) -> dict:
    """K4a through its entry point, pre_transformer_fused, at the 0.6B
    vocoder's width (bf16 weights, fp32 residual input as the vocoder gives
    it): a stream window, a blocking row and two blocking rows. Counts are
    set to 0 just before and read just after."""
    import torch

    from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
    from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
    from qwen3_tts_tpu_torch.testing import random_vocoder_params

    dev = torch.device("cuda")
    cfg = TokenizerDecoderConfig()
    pt = random_vocoder_params(cfg, seed=1, device=dev)["pre_transformer"]
    fp = ptk.build_pretransformer_fused_params(pt, cfg, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = [torch.randn(b, t, cfg.latent_dim, generator=gen, device=dev)
          for b, t in ((1, 26), (1, 110), (2, 110))]
    kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [ptk.pre_transformer_fused(fp, x, **kw) for x in xs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    k4 = ptk.build_pretransformer_params(pt, cfg, torch.bfloat16)
    ok = all(o.shape == x.shape and bool(torch.isfinite(o).all())
             and torch.equal(o, ptk.pre_transformer_kernel(k4, x, **kw))
             for o, x in zip(outs, xs))
    log(f"[fused-pretransformer] pre_transformer_fused on [1, 26], [1, 110], [2, 110] x "
        f"{cfg.latent_dim}: {wall * 1e3:.1f} ms in all, outputs finite, shaped and equal to "
        f"K4's on the same weights {'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise SystemExit("pre_transformer_fused output is wrong")
    check_counts("fused-pretransformer", launches, need=("pre_transformer_fused",),
                 idle=tuple(k for k in KERNELS if k != "pre_transformer_fused"))
    return launches


def phase_sampler_path(card: str) -> dict:
    """K2g through its entry point, gumbel_sample, at the code predictor's
    vocabulary: a frame's draws (one per code group) from one seed, sampled
    and greedy, from fp32 and from bf16 logits; each against its plain
    version. Counts are set to 0 just before and read just after."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs

    dev = torch.device("cuda")
    cc = qt.Qwen3TTSConfig.standard().code_predictor_config
    ng, v = cc.num_code_groups - 1, cc.vocab_size
    gen = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn(v, generator=gen, device=dev) * 2.0
    seed = torch.tensor([11], device=dev)
    off = torch.randn(v + 1, generator=gen, device=dev)[1:]  # 4 bytes off: scalar loads
    cases = [(lg, temp) for lg in (logits, logits.bfloat16(), off) for temp in (0.85, 0.0)]
    torch.cuda.synchronize()
    reset_counts()
    outs = [gs.gumbel_sample(lg, seed, temp, ng) for lg, temp in cases]
    torch.cuda.synchronize()
    launches = read_counts()
    ok = all(o.shape == (ng,) and torch.equal(o, gs.gumbel_sample_plain(lg, seed, temp, ng))
             for o, (lg, temp) in zip(outs, cases))
    log(f"[sampler] gumbel_sample: {ng} draws over V={v}, T=0.85 and greedy, fp32 and bf16 "
        f"logits and an unaligned row: the plain version's codes {'ok' if ok else 'FAIL'} "
        f"({card})")
    if not ok:
        raise SystemExit("gumbel_sample disagrees with its plain version")
    check_counts("sampler", launches, need=("gumbel_sample",),
                 idle=tuple(k for k in KERNELS if k != "gumbel_sample"))
    return launches


LONG = ("The first sentence of this long text talks about the weather, which was calm and "
        "bright all through the quiet morning hours before anyone in the small town woke "
        "up. The second sentence moves on to the busy market, where people bought bread and "
        "fruit and talked with their neighbours for a long while in the sun. The third "
        "sentence ends the story as the sun goes down slowly over the hills and the children "
        "walk home along the river for their supper.")


def _timed(fn):
    """(fn(), its seconds between two device syncs)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check_audio(label: str, name: str, audio, spf: int, frames=None) -> None:
    ok = (audio.dtype == np.float32 and len(audio) > 0 and bool(np.isfinite(audio).all())
          and (frames is None or len(audio) == frames * spf))
    if not ok:
        raise SystemExit(f"[{label}] {name}: {len(audio)} samples, not the audio expected")


def every_mode(pl, card: str, label: str, m: dict, frames: int = 96):
    """The single-stream generation modes on a loaded pipeline with both
    encoders, at the default temperature, seeded: VoiceDesign,
    CustomVoice, a streamed VoiceDesign run (first audio), the speaker
    embedding and the reference codes of a 5 s clip of the VoiceDesign
    audio (tiled if shorter), generate with that embedding, generate_icl;
    each `frames` frames, its audio checked (1,920 samples a frame, finite)
    and its RTF, first audio and the encoders' seconds put in m. Returns
    (the VoiceDesign audio, the 5 s clip, its speaker embedding, its
    codes)."""
    from qwen3_tts_tpu_torch.testing import REFERENCE_TRANSCRIPT

    spf = pl._samples_per_frame
    desc = "A warm, low narrator voice."

    def rtf(name, fn):
        audio, secs = _timed(fn)
        _check_audio(label, name, audio, spf, frames)
        m[f"{name}_rtf"] = secs / (len(audio) / 24000)
        log(f"[{label}] {name}: {secs:.2f} s for {len(audio) / 24000:.2f} s of audio, "
            f"RTF {m[f'{name}_rtf']:.3f} ({card})")
        return audio

    design = rtf("voice_design", lambda: pl.generate_voice_design(
        TEXT, desc, max_tokens=frames, seed=0))
    rtf("custom_voice", lambda: pl.generate_custom_voice(
        TEXT, "aiden", "Speak cheerfully.", max_tokens=frames, seed=0))

    t0 = time.perf_counter()
    first, n = None, 0
    for ch in pl.generate_stream_voice_design(TEXT, desc, max_tokens=frames, seed=0):
        if first is None and len(ch.samples):
            first = time.perf_counter() - t0
        if len(ch.samples):
            _check_audio(label, "stream chunk", ch.samples, spf,
                         ch.token_range[1] - ch.token_range[0])
        n += len(ch.samples)
    m["stream_first_audio_s"], m["stream_rtf"] = first, (time.perf_counter() - t0) / (n / 24000)
    log(f"[{label}] streamed VoiceDesign: first audio {first:.2f} s, RTF {m['stream_rtf']:.3f} "
        f"({card})")

    ref = np.resize(design, int(REF_S * 24000))  # a 5 s clip of generated speech
    emb, m["speaker_encoder_s"] = _timed(lambda: pl.extract_speaker_embedding(ref))
    codes, m["audio_encoder_s"] = _timed(lambda: pl.encode_reference_audio(ref))
    log(f"[{label}] 5 s clip: speaker embedding {emb.shape} in {m['speaker_encoder_s']:.3f} s, "
        f"reference codes {len(codes)} x {len(codes[0])} in {m['audio_encoder_s']:.3f} s "
        f"({card}, fp32)")
    if emb.shape != (pl.config.hidden_size,) or not np.isfinite(emb).all():
        raise SystemExit(f"[{label}] the speaker embedding is {emb.shape}, not "
                         f"({pl.config.hidden_size},) and finite")
    rtf("speaker_embedding", lambda: pl.generate(TEXT, speaker_embedding=emb, max_tokens=frames,
                                                 seed=0))
    rtf("icl", lambda: pl.generate_icl(TEXT, REFERENCE_TRANSCRIPT, codes, max_tokens=frames,
                                       seed=0))
    return design, ref, emb, codes


def phase_modes(card: str, d: str):
    """Every generation mode on the default configuration of a 0.6B dir
    with the speaker and audio encoders; returns (launch counts over the
    whole phase, metrics, the loaded pipeline, which service-modes serves,
    and its VoiceDesign audio)."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.frontend.chunker import chunk_text
    from qwen3_tts_tpu_torch.io import safetensors_io
    from qwen3_tts_tpu_torch.io.wav import parse_wav
    from qwen3_tts_tpu_torch.models import audio_encoder as aenc
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    from qwen3_tts_tpu_torch.pipeline import resident_bytes

    label = "modes-pipeline"
    m: dict = {}

    def rtf(name, fn, frames=None):
        audio, secs = _timed(fn)
        _check_audio(label, name, audio, spf, frames)
        m[f"{name}_rtf"] = secs / (len(audio) / 24000)
        log(f"[{label}] {name}: {secs:.2f} s for {len(audio) / 24000:.2f} s of audio, "
            f"RTF {m[f'{name}_rtf']:.3f}")
        return audio

    reset_counts()
    pl, m["load_s"] = _timed(lambda: qt.Qwen3TTSPipeline(d, device="cuda"))
    spf = pl._samples_per_frame
    if not (pl.supports_voice_cloning and pl.supports_icl):
        raise SystemExit(f"[{label}] the encoders did not load")
    m["resident_bytes"] = pl.model_resident_bytes()
    enc_bytes = resident_bytes(pl.speaker_encoder.params, pl.audio_encoder.params)
    log(f"[{label}] load {m['load_s']:.2f} s; resident {m['resident_bytes']} bytes, of which "
        f"the encoders {enc_bytes} (fp32)")
    design, ref, emb, codes = every_mode(pl, card, label, m)

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    chunks = chunk_text(LONG)
    kept, filt = _counting(gen_mod)  # valid frames of each chunk
    try:
        long_audio = rtf("generate_batch", lambda: pl.generate_batch(LONG, "aiden", seed=0))
        batch_frames = list(kept)
        kept.clear()
        with tempfile.TemporaryDirectory() as out_dir:
            path = f"{out_dir}/long.wav"
            count, secs = _timed(lambda: pl.generate_to_file(LONG, path, "aiden", seed=0))
            with open(path, "rb") as f:
                samples, rate, channels = parse_wav(f.read())
        file_frames = list(kept)
    finally:
        gen_mod.filter_valid_frames = filt
    # chunks of at most 600 frames, joined by 480-sample crossfades
    want = sum(batch_frames) * spf - 480 * (sum(1 for n in batch_frames if n) - 1)
    log(f"[{label}] generate_batch: {len(chunks)} chunks of {batch_frames} frames")
    if len(chunks) != 3 or len(long_audio) != want or max(batch_frames) > 600:
        raise SystemExit(f"[{label}] generate_batch: {len(chunks)} chunks, {len(long_audio)} "
                         f"samples, expected 3 and {want}")
    if (count != sum(file_frames) * spf or len(samples) != count
            or (rate, channels) != (24000, 1)):
        raise SystemExit(f"[{label}] generate_to_file wrote {count} samples / {len(samples)}")
    m["generate_to_file_rtf"] = secs / (count / 24000)
    log(f"[{label}] generate_to_file: {count} samples in {secs:.2f} s, RTF "
        f"{m['generate_to_file_rtf']:.3f}")
    _, m["warmup_s"] = _timed(pl.warmup)
    log(f"[{label}] warmup: {m['warmup_s']:.2f} s")
    launches = read_counts()
    check_counts(label, launches, need=("talker_step", "cp_frame", "int8_matmul",
                                        "pre_transformer", "upsample_stage", "residual_units",
                                        "block_upsample"),
                 idle=("gumbel_sample", "packed_matmul", "pre_transformer_fused"))

    # the card's encoders (fp32, TF32 off) against the port's CPU run
    t0 = time.perf_counter()
    spk_cpu = spk.SpeakerEncoder.from_weights(
        {k: v for k, v in safetensors_io.load_file(f"{d}/model.safetensors").items()
         if k.startswith("speaker_encoder.")}, device="cpu")
    st = safetensors_io.load_file(f"{d}/speech_tokenizer/model.safetensors")
    enc_cpu = aenc.AudioEncoder.from_weights({k: v for k, v in st.items() if "encoder." in k},
                                             pl.speech_config, device="cpu")
    emb_err = rel_rms(torch.from_numpy(emb), torch.from_numpy(spk_cpu.extract_embedding(ref)))
    x = torch.from_numpy(ref)[None]
    with torch.no_grad():
        h_card = aenc.encode_hidden(pl.audio_encoder.params, x.cuda(), pl.audio_encoder.cfg)
        h_cpu = aenc.encode_hidden(enc_cpu.params, x, enc_cpu.cfg)
    h_err = rel_rms(h_card.cpu(), h_cpu)
    cpu_codes = enc_cpu.encode(ref)
    same = float((np.stack(codes) == cpu_codes).mean())
    log(f"[{label}] card vs CPU (fp32): speaker embedding rel_rms={emb_err:.3e}, encoder "
        f"hidden states rel_rms={h_err:.3e} (tol 1e-4 each), reference codes equal in "
        f"{100 * same:.2f}% (need 99%) ({time.perf_counter() - t0:.1f} s)")
    if not (emb_err <= 1e-4 and h_err <= 1e-4 and same >= 0.99):
        raise SystemExit("the encoders on the card disagree with their CPU run")
    m["codes_equal"] = same
    return launches, m, pl, design


SERVE_TEXTS = (
    "Good morning.",
    "The train leaves at half past nine from the second platform.",
    "Please remember to water the plants on the balcony before you go out tonight.",
    "A short one.",
    TEXT,
    "Numbers like twelve, forty and three hundred are read out in full by the voice.",
    "The museum opens its new wing to the public next week, with paintings from four "
    "centuries and a garden of sculptures behind the old library.",
    "Thank you for calling, we will be with you shortly.",
)
# B = 8 against B = 1, teacher-forced: both read the same bf16 weights, but
# the `w8r` product's fp32 sums run in another order at M = 8 (and 512 in
# prefill) than at M = 1 (and 64), and each layer's output is rounded to
# bf16 before the next reads it: a sum that lands on the other side of a
# rounding boundary moves that element by 2^-9, and the random-weight
# layers carry it on, as the W8A8 steps of TOL_W8A8's note do (1.6e-2 on
# the logits there). Held at TOL["bfloat16"]; in fp32 on the CPU the two
# widths agree to ~2e-7
TOL_BATCH = TOL["bfloat16"]
# At 1.7B more activations a step cross a rounding boundary (the frame
# loop teacher-forced, K1 / K2 against their plain versions: 3.857e-2), so
# B = 8 against B = 1 may read above TOL_BATCH there. TOL_BATCH is not raised;
# the 1.7B comparisons (batch_vs_single with an fp32 twin of the tree) make
# two checks instead. (1) The same comparison on the fp32 twin (the same
# bf16-valued weights, fp32 activations) at TOL["float32"]: only the sum
# order differs there, so a slot or routing fault, which moves the logits
# by ~1e-1, shows. (2) bf16 B = 8 against B = 1 at the larger of TOL_BATCH
# and BATCH_ROUNDING times the rel RMS of the B = 1 bf16 step against the
# B = 1 fp32 step on the same frames, measured in the same run: the B = 8
# and B = 1 bf16 steps are two bf16 evaluations of one fp32 function, each
# e away from it, with roundings that fall independently, so they lie
# about sqrt(2) e apart. Code-0 flips stay refused outside a near tie.
BATCH_ROUNDING = 2 ** 0.5


def _serving_state(pl, texts, statics):
    """A prefilled B = len(texts) serving state of `texts` (built-in speaker),
    the trailing text padded to its bucket."""
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import serving as srv

    pds = [pl._assemble(t, "aiden") for t in texts]
    t_bucket = gen_mod.pick_bucket(max(pd.trailing_hidden.shape[1] for pd in pds),
                                   gen_mod.TRAILING_BUCKETS)
    e, tr, lengths, totals = srv._pad_prompts(pds, statics.capacity - gen_mod.RING_SLACK,
                                              t_bucket)
    return srv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                               srv._device_ints(range(len(texts)), e.device), statics)


def _statics(pl, chunk: int):
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    # prompt bucket 64: the built-in speaker's 9-row prompts
    return gen_mod.GenStatics(config=pl.config, capacity=64 + gen_mod.RING_SLACK,
                              chunk_steps=chunk, track_cp_penalty=False)


def _state_diff(a: dict, b: dict) -> tuple[float, bool]:
    """(largest rel RMS over the float arrays, every integer / bool array equal)."""
    import torch

    worst, same = 0.0, True
    for k, v in a.items():
        if isinstance(v, dict):
            w, s = _state_diff(v, b[k])
            worst, same = max(worst, w), same and s
        elif v.is_floating_point():
            worst = max(worst, rel_rms(v.float(), b[k].float()))
        else:
            same = same and bool(torch.equal(v, b[k]))
    return worst, same


# the kernel function each of K3's and K7's wrappers launches through
QMM_FNS = {"int8_matmul": "int8_matmul_kernel", "packed_matmul": "packed_matmul_kernel"}


@contextlib.contextmanager
def kernel_rows():
    """Yields {"int8_matmul": [...], "packed_matmul": [...]}, lists that
    receive (M, the weight's data pointer) of each K3 / K7 kernel call made
    inside."""
    calls = {name: [] for name in QMM_FNS}
    real = {name: getattr(counters()[name][0], fn) for name, fn in QMM_FNS.items()}

    def recording(name):
        def call(x, w, *args):
            calls[name].append((x.shape[0], w.data_ptr()))
            return real[name](x, w, *args)
        return call

    for name, fn in QMM_FNS.items():
        setattr(counters()[name][0], fn, recording(name))
    try:
        yield calls
    finally:
        for name, fn in QMM_FNS.items():
            setattr(counters()[name][0], fn, real[name])


def m_per_step(calls: list, weight=None) -> dict:
    """M -> calls a step, from kernel_rows' list over a graph's warm-up and
    capture (each step's calls made twice); `weight` (a tensor): its calls
    only."""
    ms = [m for m, ptr in calls if weight is None or ptr == weight.data_ptr()]
    return {m: ms.count(m) // 2 for m in sorted(set(ms))}


def _texts(b: int) -> tuple:
    """b of SERVE_TEXTS, repeated past 8."""
    return (SERVE_TEXTS * (-(-b // len(SERVE_TEXTS))))[:b]


def step_times(pl, card: str, label: str, widths=(1, 4, 8), profiled=None,
               eager_profiled: bool = False) -> dict:
    """The lockstep step at each batch width: graph capture s and pool
    bytes; K3's and K7's launches the capture recorded and the M of each
    (k3_per_step, k3_m, k7_per_step, k7_m: M -> launches a step); wall ms a
    step by graph replay (20 replays ended by a sync) and by the eager step
    (1 step); at each width of `profiled` (all when None) device ms a step
    of the graph (profiler: 1 replay) and device kernels a step, and with
    `eager_profiled` at the widest of them device ms of the eager step (1
    step)."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    out = {}
    statics = _statics(pl, 1)
    p, cp = srv._drop_kernel(pl.params), srv._drop_kernel(pl.cp_params)
    profiled = widths if profiled is None else profiled
    for b in widths:
        t_width = time.perf_counter()
        state = _serving_state(pl, _texts(b), statics)
        eager = srv._clone(state)
        with kernel_rows() as calls:
            g_state = srv.bind(pl.params, pl.cp_params, state, statics, True)
        g = g_state.graph
        g.set_temps(np.full(b, 0.85, np.float32))
        temps = torch.full((b,), 0.85, device=state["logits"].device)

        def wall(fn, n):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        def device(fn, n, top=0):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            return window_device(prof, n, label, f"B={b} graph step", top)

        def eager_step():
            srv.lockstep_step(p, cp, eager, temps, statics, True)

        def dev_ms(v):
            return f"{v:.3f} ms" if v > 0 else "not measured (the profiler saw no device time)"

        check_pool(g, label)
        r = {"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
             "graph_ms": wall(g.replay, 20), "eager_ms": wall(eager_step, 1),
             "graph_events_ms": _events_ms(lambda: [g.replay() for _ in range(20)]) / 20}
        # one step a window: the profiler's host work on ~12,000 kernel
        # records a step is most of this function's time, so only the
        # widths of `profiled` take one
        r["graph_device_ms"], r["kernels"] = None, None
        if b in profiled:
            r["graph_device_ms"], r["kernels"] = device(g.replay, 1,
                                                        top=8 if b in (8, 32) else 0)
        # the eager step's device time at one width of one phase: its window
        # holds ~24,000 records (each kernel and its launch), ~4 s of the
        # profiler's host work
        eager_dev = "not profiled at this width"
        if eager_profiled and b == max(profiled):
            r["eager_device_ms"], r["eager_kernels"] = device(eager_step, 1)
            eager_dev = (f"{dev_ms(r['eager_device_ms'])} in {r['eager_kernels']:.0f} device "
                         "kernels")
        r["frames_per_s"] = b / r["graph_ms"] * 1e3
        for k, name in (("k3", "int8_matmul"), ("k7", "packed_matmul")):
            r[f"{k}_per_step"] = g.step_launches[srv._COUNTED.index(counters()[name][0])]
            r[f"{k}_m"] = m_per_step(calls[name])

        graph_dev = (f"{dev_ms(r['graph_device_ms'])} in {r['kernels']:.0f} device kernels"
                     if b in profiled else "not profiled at this width")
        log(f"[{label}] lockstep step B={b} (T=0.85): graph {r['graph_ms']:.3f} ms wall, "
            f"{r['graph_events_ms']:.3f} ms by events over 20 replays, device "
            f"{graph_dev}; eager "
            f"{r['eager_ms']:.3f} ms wall, device {eager_dev}; capture {r['capture_s']:.3f} s, "
            f"graph pool {r['pool_bytes']} bytes; {r['frames_per_s']:.1f} frames/s; K3 launches "
            f"a step {r['k3_per_step']} (M: launches {r['k3_m']}), K7 {r['k7_per_step']} "
            f"(M: launches {r['k7_m']}); "
            f"{time.perf_counter() - t_width:.1f} s to measure ({card}, bf16)")
        out[b] = r
        del g_state, state, eager
        torch.cuda.empty_cache()
    return out


def graph_vs_eager(pl, card: str, steps: int = 8, label: str = "serving", b: int = 8,
                   state=None, statics=None):
    """B = b (_texts(b)) at temperature 0, or a given prefilled `state` of
    `statics` (a service's burst: its chunk_steps steps): a chunk of graph
    replays against the same steps run eagerly from a copy of the state:
    the same frames and state, bit for bit (the same kernels on the same
    inputs). Returns the frames."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    if state is None:
        statics = _statics(pl, steps)
        state = _serving_state(pl, _texts(b), statics)
    b, steps = state["logits"].shape[0], statics.chunk_steps
    eager = srv._clone(state)
    frames, _, _, state = srv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.0, statics)
    p, cp = srv._drop_kernel(pl.params), srv._drop_kernel(pl.cp_params)
    temps = torch.zeros(b, device=eager["logits"].device)
    ref = []
    for _ in range(steps):
        srv.lockstep_step(p, cp, eager, temps, statics, False)
        ref.append(eager["frame"].clone())
    ref = torch.stack(ref, dim=1)
    worst, same = _state_diff(state, eager)
    codes_equal = bool(torch.equal(frames, ref))
    log(f"[{label}] graph vs eager, B={b}, {steps} steps at temperature 0: frames "
        f"{'equal' if codes_equal else 'DIFFER'}; state: integer arrays "
        f"{'equal' if same else 'DIFFER'}, float arrays rel RMS max {worst:.3e} "
        f"({'bit for bit' if worst == 0.0 else 'not bit for bit'}) ({card})")
    if not (codes_equal and same and worst == 0.0):
        raise SystemExit(f"[{label}] the lockstep step's CUDA graph disagrees with the eager "
                         "step")
    return frames


def batch_vs_single(pl, card: str, frames, label: str = "serving", pl32=None) -> dict:
    """B = len(frames) (_texts(B): 8, or 32) against B = 1, teacher-forced
    over the graph run's frames: the talker logits after each step of
    streams 0 and 6 (the shortest and the longest text), and at B > 8 the
    last, at B = 1 against the same stream's at B. With `pl32`
    (fp32_twin(pl)), BATCH_ROUNDING's two checks: the same comparison on
    the twin at TOL["float32"], then the bf16 one at the derived bound.
    Returns held_against_single's figures ("bound": the bf16 bound held;
    "fp32": the twin's)."""
    valid = (frames[..., 0] >= 0).all(0)  # steps every stream emitted
    steps = int(valid.long().cumprod(0).sum())
    if steps < 4:
        raise SystemExit(f"[{label}] only {steps} steps where every stream emitted")
    b = frames.shape[0]
    texts, rows = _texts(b), (0, 6) if b <= 8 else (0, 6, b - 1)
    ref, fp32 = None, None
    if pl32 is not None:
        ref, statics = {}, _statics(pl32, steps)
        fp32 = held_against_single(
            pl32, card, label, statics, _serving_state(pl32, texts, statics),
            {j: _serving_state(pl32, texts[j:j + 1], statics) for j in rows},
            frames[:, :steps], tol=TOL["float32"], keep=ref)
    statics = _statics(pl, steps)
    wide = _serving_state(pl, texts, statics)
    singles = {j: _serving_state(pl, texts[j:j + 1], statics) for j in rows}
    out = held_against_single(pl, card, label, statics, wide, singles, frames[:, :steps],
                              ref=ref)
    out["fp32"] = fp32
    return out


class ForcedStep:
    """A greedy lockstep step of `state` teacher-forced with a given frame,
    replayed from one CUDA graph captured over the state's own tensors (the
    state steps in place, as the eager step leaves it: a replay runs the
    eager step's kernels, bit for bit its output, graph_vs_eager). The
    teacher-forced comparisons replay it: an eager step dispatches ~12,000
    kernels from the host (0.2-0.4 s), a replay takes the step's device
    time (20-50 ms); the capture costs about two eager steps.
    step(frame [B, 16])."""

    def __init__(self, pl, state: dict, statics):
        import torch

        from qwen3_tts_tpu_torch.models import serving as srv

        p, cp = srv._drop_kernel(pl.params), srv._drop_kernel(pl.cp_params)
        b = state["logits"].shape[0]
        self.forced = torch.zeros_like(state["frame"])
        self.temps = torch.zeros(b, device=state["logits"].device)
        warm = srv._clone(state)  # the warm-up steps a copy: plans, constants
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            srv.lockstep_step(p, cp, warm, self.temps, statics, False, forced=self.forced)
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        del warm
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            srv.lockstep_step(p, cp, state, self.temps, statics, False, forced=self.forced)

    def __call__(self, frame) -> None:
        self.forced.copy_(frame)
        self.graph.replay()


def _greedy_scores(state: dict, statics):
    """The scores a greedy lockstep step takes its code 0 from (as
    serving.lockstep_step: the eos / pad mask while text remains, the
    repetition penalty on seen codes, the validity mask), [B, V] fp32."""
    from qwen3_tts_tpu_torch.parallel.dryrun import greedy_scores

    return greedy_scores(state, statics.config, "total_texts", statics.repetition_penalty)


# Beside an fp32 twin (held_against_single's `ref`), a B = 8 / B = 1 code-0
# flip is a near tie when the twin's scores of the two codes lie within
# NEAR_TIE of its largest score: the bf16 scores of the pair carry the
# rounding that made the flip. A bf16 logit holds 8 significant bits, so a
# pair 0.35% apart in fp32 read 1.2% apart in bf16 (the 1.7B service
# burst's step 6 on an H100, every stream: the fp32 B = 8 and B = 1 steps
# both picked one code, the bf16 B = 8 step the other).
def _gap_of_top(scores, a: int, w: int) -> float:
    """|score a - score w| over the largest finite |score| (inf when w's
    score is not finite)."""
    import torch

    if not bool(torch.isfinite(scores[w])):
        return float("inf")
    top = float(scores[torch.isfinite(scores)].abs().max())
    return float((scores[a] - scores[w]).abs()) / top


def _near_tie(scores, a: int, w: int) -> bool:
    """Scores a and w within NEAR_TIE of the largest finite score."""
    return _gap_of_top(scores, a, w) <= NEAR_TIE


# Beside the fp32 twin the near-tie limit is also derived from the rounding
# measured at that step: the bf16 B = 1 run's largest error on any finite
# score against the twin's, m. A bf16 run puts each score within about m of
# the twin's, so two bf16 runs may order a pair differently only where the
# twin's scores of the pair lie within 2m; the limit is the larger of
# NEAR_TIE and 2m, both over the twin's largest score. (The 1.7B mode burst
# on a clip of the 1.7B model's own speech, on an H100: a flip at 1.104% of
# the top score, over NEAR_TIE, the fp32 twin's B = 8 and B = 1 agreeing
# to 1.8e-6 with no flip.)
def _rounding_tie(twin, bf16, a: int, w: int) -> tuple[bool, float, float]:
    """(a near tie, the twin's gap of a and w over its top score, the
    limit: max(NEAR_TIE, 2 max |bf16 - twin| over the top score))."""
    import torch

    finite = torch.isfinite(twin) & torch.isfinite(bf16)
    top = float(twin[finite].abs().max())
    limit = max(NEAR_TIE, 2 * float((bf16.float() - twin)[finite].abs().max()) / top)
    gap = _gap_of_top(twin, a, w)
    return gap <= limit, gap, limit


def held_against_single(pl, card: str, label: str, statics, wide, singles: dict, frames,
                        emitted: bool = False, tol: float = TOL_BATCH, keep=None,
                        ref=None) -> dict:
    """Steps the B = len(frames) state `wide` and the B = 1 states
    `singles` (row -> state) by ForcedSteps (the singles one after another
    through one a state shape, each copied into its state), teacher-forced
    with frames [B, steps, 16], and holds each single's talker logits after
    every step against its row of the wide ones: rel RMS <= tol, and a
    code-0 argmax that differs only at a near-tie (the two scores within
    NEAR_TIE of the largest score; beside a twin, _rounding_tie's limit).
    `emitted` (greedy streams' own frames): also each frame's code 0
    against the greedy pick of its single's state before that step, off
    only at a near-tie, so a frame the run computed or routed wrongly fails.
    `keep` (a dict) receives each single's logits after every step by
    (row, step) and its greedy scores before it by
    ("scores", row, step); `ref`, such a dict from the same singles on an
    fp32 twin of the tree (batch_vs_single), gives their
    rounding error (rel RMS against it), the bound becomes the larger of
    tol and BATCH_ROUNDING times the largest one, and a near tie is judged
    on the twin's scores of the two codes (the note above _gap_of_top) at
    the limit _rounding_tie derives from that step's rounding. Returns
    {"worst", "mean", "bound", "rounding" (None without ref), "flips",
    "ties", "tie_gaps": each tie's (row, step, gap, limit)}."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    b, steps = frames.shape[:2]
    dt = "bf16" if wide["h_last"].dtype == torch.bfloat16 else "fp32"
    step_wide = ForcedStep(pl, wide, statics)
    wide_logits = []
    for i in range(steps):
        step_wide(frames[:, i])
        wide_logits.append(wide["logits"].clone())
    del step_wide
    def shapes(tree):
        return tuple((k, shapes(v) if isinstance(v, dict) else tuple(v.shape))
                     for k, v in tree.items())

    # the singles one after another through one B = 1 graph a shape (their
    # trailing buckets may differ), each copied into the state the graph
    # was captured over (the same kernels, as serving.bind does)
    graphs = {}
    errs, flips, ties, rounding, far, by_row = [], 0, 0, [], [], {}
    picks, misses, miss_ties, tie_gaps = 0, [], 0, []

    def judged(bf16, twin, j, i, a, w) -> tuple[bool, float]:
        """(a near tie, the gap) of codes a and w: on the bf16 scores at
        NEAR_TIE without a twin, else on the twin's at _rounding_tie's limit."""
        if twin is None:
            return _near_tie(bf16, a, w), _gap_of_top(bf16, a, w)
        tie, gap, limit = _rounding_tie(twin, bf16, a, w)
        if tie:
            tie_gaps.append((j, i, round(gap, 5), round(limit, 5)))
        return tie, gap

    for j, single in singles.items():
        shape = shapes(single)
        if shape not in graphs:
            one = srv._clone(single)
            graphs[shape] = one, ForcedStep(pl, one, statics)
        one, step_one = graphs[shape]
        srv._copy_into(one, single)
        for i in range(steps):
            if emitted or keep is not None:
                sc = _greedy_scores(one, statics)[0]
                if keep is not None:
                    keep["scores", j, i] = sc.float().clone()
                if emitted:
                    a, got = int(torch.argmax(sc)), int(frames[j, i, 0])
                    picks += 1
                    if a != got:
                        tie, gap = judged(sc, None if ref is None else ref["scores", j, i],
                                          j, i, a, got)
                        if tie:
                            miss_ties += 1
                        else:
                            misses.append((j, i, got, a, round(gap, 5)))
            step_one(frames[j:j + 1, i])
            lg, wl = one["logits"][0], wide_logits[i][j]
            if keep is not None:
                keep[j, i] = lg.float().clone()
            if ref is not None:
                rounding.append(rel_rms(lg.float(), ref[j, i]))
                by_row[j] = max(by_row.get(j, 0.0), rounding[-1])
            errs.append(rel_rms(lg, wl))
            a, w = int(torch.argmax(lg)), int(torch.argmax(wl))
            if a != w:
                tie, gap = judged(lg, None if ref is None else ref[j, i], j, i, a, w)
                if tie:
                    ties += 1
                else:
                    flips += 1
                    far.append((j, i, a, w, round(gap, 5)))
    worst, bound = max(errs), tol
    if ref is not None:
        bound = max(tol, BATCH_ROUNDING * max(rounding))
        log(f"[{label}] B=1 {dt} against the fp32 twin's steps on the same frames: talker "
            f"logits rel RMS max {max(rounding):.3e} mean {float(np.mean(rounding)):.3e}; "
            f"bound for B={b} vs B=1: max(TOL_BATCH {tol:g}, sqrt(2) x {max(rounding):.3e}) "
            f"= {bound:.3e}; by row: "
            + ", ".join(f"{j} {e:.3e}" for j, e in sorted(by_row.items())))
    log(f"[{label}] B={b} vs B=1 teacher-forced over {steps} steps, streams "
        f"{sorted(singles)}: talker logits rel RMS max {worst:.3e} mean "
        f"{float(np.mean(errs)):.3e} (tol {bound:.3g}), code-0 argmax flips {flips} "
        f"(+{ties} at near-ties) of {len(errs)} ({card}, {dt})"
        + (f"; (row, step, B=1 code, B={b} code, their gap over the top score): {far[:4]}"
           if far else ""))
    if emitted:
        log(f"[{label}] emitted code 0 against the B=1 greedy pick before its step: "
            f"{len(misses)} off (+{miss_ties} at near-ties) of {picks}"
            + (f"; first (row, step, emitted, pick, their gap over the top score): "
               f"{misses[:4]}" if misses else ""))
    if tie_gaps:
        log(f"[{label}] near ties on the fp32 twin's scores (row, step, gap, limit over the "
            f"top score; NEAR_TIE {NEAR_TIE:g}): {tie_gaps}")
    if not worst <= bound or flips:
        raise SystemExit(f"[{label}] the B = {b} lockstep step disagrees with B = 1 ({dt})")
    if misses:
        raise SystemExit(f"[{label}] the emitted frames disagree with the B = 1 greedy picks")
    return {"worst": worst, "mean": float(np.mean(errs)), "bound": bound,
            "rounding": max(rounding) if rounding else None, "flips": flips, "ties": ties,
            "tie_gaps": tie_gaps}


SERVING_VOCODER = ("pre_transformer", "upsample_stage", "residual_units", "block_upsample")
SERVE_TOKENS = 48  # frames a stream in serving_runs (few, for the script's time)


def serving_runs(pl, card: str, label: str, temps, streams,
                 need=("int8_matmul",) + SERVING_VOCODER,
                 idle=("talker_step", "cp_frame", "gumbel_sample", "packed_matmul",
                       "pre_transformer_fused"), texts=SERVE_TEXTS,
                 max_tokens: int = SERVE_TOKENS, stream_tokens: int = SERVE_TOKENS,
                 min_rows: int = 0):
    """The counted run of batched serving: generate_many on `texts` (the 8
    serving texts) at each temperature of `temps` (max_tokens frames),
    generate_many_stream on each (texts, batch_size) of `streams` (the 8
    through 8 slots; 6 through 4 admit 2 mid-flight; stream_tokens frames),
    each output checked; generate_many's vocoder rows (chunked_decode's one
    decode_frames call) at least `min_rows`, and every vocoder call of a
    stream [batch_size, 16, 26]; the kernels of `need` launched and those
    of `idle` not (the megakernel configuration's weights: K3 in the text
    projections, K4-K6 and the blocks' upsample); the graphs' pools.
    Returns (launch counts of the run, metrics)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import serving as srv
    from qwen3_tts_tpu_torch.models import vocoder as voc

    spf, m = pl._samples_per_frame, {}
    kept, filt = _counting(gen_mod)
    admit, admits = srv.admit_stream, []
    decode, vocoded = voc.decode_frames, []

    def counting_admit(*args, **kwargs):
        admits.append(args[1])
        return admit(*args, **kwargs)

    def recording_decode(params, codes, cfg):
        vocoded.append(tuple(codes.shape))
        return decode(params, codes, cfg)

    srv.admit_stream, voc.decode_frames = counting_admit, recording_decode
    t_run = time.perf_counter()
    try:
        torch.cuda.synchronize()
        reset_counts()
        graphs_before = sum(len(v) for v in srv.graphs(pl.params).values())
        for temp in temps:
            kept.clear()
            vocoded.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = pl.generate_many(list(texts), "aiden", temperature=temp,
                                    max_tokens=max_tokens, seed=0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rows = vocoded[0][0] if len(vocoded) == 1 else -1
            ok = (len(kept) == len(texts) and all(n > 0 for n in kept)
                  and all(len(o) == n * spf and np.isfinite(o).all()
                          for o, n in zip(outs, kept)) and rows >= min_rows)
            audio_s = sum(len(o) for o in outs) / pl.sample_rate
            m[f"generate_many_rtf_t{temp}"] = secs / audio_s
            m[f"generate_many_rows_t{temp}"] = rows
            log(f"[{label}] generate_many, {len(texts)} texts, T={temp}, max_tokens "
                f"{max_tokens}: {kept} valid frames, the vocoder's calls {vocoded} ({rows} rows in "
                f"one call, at least {min_rows} asked), {secs:.3f} s for {audio_s:.2f} s of "
                f"audio, serving RTF {secs / audio_s:.4f}, {sum(kept) / secs:.1f} frames/s with "
                f"the vocoder {'ok' if ok else 'FAIL'} ({card}, bf16)")
            if not ok:
                raise SystemExit(f"generate_many output is wrong at T={temp}")
        for stream_texts, width in streams:
            admits.clear()
            vocoded.clear()
            first, got = {}, {i: [] for i in range(len(stream_texts))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, ch in pl.generate_many_stream(list(stream_texts), "aiden", temperature=0.85,
                                                 max_tokens=stream_tokens, batch_size=width,
                                                 seed=0):
                if len(ch.samples) and i not in first:
                    first[i] = time.perf_counter() - t0
                got[i].append(ch)
            secs = time.perf_counter() - t0
            audio_s = 0.0
            for i, cs in got.items():
                pos = 0
                for c in cs:
                    if (c.token_range[0] != pos or not np.isfinite(c.samples).all()
                            or len(c.samples) != (c.token_range[1] - pos) * spf):
                        raise SystemExit(f"[{label}] stream chunk {c.token_range} of text {i} "
                                         "does not tile its frames")
                    pos = c.token_range[1]
                    audio_s += len(c.samples) / pl.sample_rate
                if sum(c.is_final for c in cs) != 1 or not cs[-1].is_final or pos == 0:
                    raise SystemExit(f"[{label}] text {i}: not one final chunk, or no audio")
            m[f"stream_rtf_b{width}"] = secs / audio_s
            m[f"stream_first_audio_b{width}"] = [first[i] for i in sorted(first)]
            windows = sorted(set(vocoded))
            log(f"[{label}] generate_many_stream, {len(stream_texts)} texts, batch_size={width}: "
                f"{len(admits)} admitted mid-flight, {secs:.3f} s for {audio_s:.2f} s of audio, "
                f"serving RTF {secs / audio_s:.4f}; {len(vocoded)} vocoder calls of "
                f"{windows}; first audio per text (s): "
                + ", ".join(f"{first[i]:.3f}" for i in sorted(first)) + f" ({card}, bf16)")
            if width == 4 and len(admits) < 2:
                raise SystemExit(f"[{label}] {len(admits)} admissions; expected at least 2")
            if windows != [(width, 16, 26)]:
                raise SystemExit(f"[{label}] the stream's vocoder windows are {windows}, not "
                                 f"[{width}, 16, 26]")
        launches = read_counts()
    finally:
        gen_mod.filter_valid_frames = filt
        srv.admit_stream, voc.decode_frames = admit, decode
    check_counts(label, launches, need=need, idle=idle)
    pool = srv.graphs(pl.params)
    for key, gs in pool.items():
        for g in gs:
            check_pool(g, label)
            log(f"[{label}] graph B={key[0]} capacity={key[1]} trailing={key[2]} "
                f"chunk_steps={key[4].chunk_steps} sampled={key[5]}: captured in "
                f"{g.capture_s:.3f} s, pool {g.pool_bytes} bytes")
    log(f"[{label}] graphs captured in the counted run: "
        f"{sum(len(v) for v in pool.values()) - graphs_before}")
    log(f"[{label}] the counted run: {time.perf_counter() - t_run:.1f} s")
    return launches, m


def phase_serving(pl, card: str, label: str = "serving", temps=(0.0, 0.85),
                  streams=((SERVE_TEXTS, 8), (SERVE_TEXTS[:6], 4)), widths=(1, 8, 16, 32),
                  pl32=None, w8r: bool = True, profiled=(8, 32), eager_profiled: bool = True,
                  b: int = 8, **run_kw):
    """Batched serving on the megakernel configuration's weights (the
    megakernels idle: the batched path runs the `w8r` product at M = B):
    serving_runs' counted run of `temps` and `streams` (`run_kw`: its
    texts, frames and vocoder rows); then, outside it, the `w8r` product's
    check at M = b (`w8r`), the step's times at each of `widths` (its
    device time at those of `profiled`, the eager step's at the widest with
    `eager_profiled`), graph against eager at B = b, B = b against B = 1
    (with `pl32`, an fp32 twin, BATCH_ROUNDING's checks). Returns (launch
    counts of the counted run, metrics)."""
    launches, m = serving_runs(pl, card, label, temps, streams, **run_kw)
    t_part = time.perf_counter()
    if w8r:
        m["w8r_product"] = w8r_product(pl, card, m=b)
    m["steps"] = step_times(pl, card, label, widths, profiled, eager_profiled)
    frames = graph_vs_eager(pl, card, label=label, b=b)
    t_tf = time.perf_counter()
    m["batch_vs_single"] = batch_vs_single(pl, card, frames, label, pl32)
    log(f"[{label}] steps, graph against eager: {t_tf - t_part:.1f} s; B = {b} against B = 1: "
        f"{time.perf_counter() - t_tf:.1f} s")
    return launches, m


# B = 32, the JAX package's serving batch (bench.py's SERVE_BATCH):
# generate_many runs MANY_32_TOKENS frames a stream, past chunked_decode's
# 100-frame chunk, so a stream that runs that long decodes two 110-frame
# rows, and its one vocoder call holds up to 64 rows, past the 39 that K6's
# old grid cap took (MIN_ROWS_32 asked); generate_many_stream runs
# STREAM_32_TOKENS frames through [32, 16, 26] windows
MANY_32_TOKENS, MIN_ROWS_32, STREAM_32_TOKENS = 120, 40, 48


# phase_serving's B = 32 run (serving-32 at 0.6B, serving-1.7b): the 32
# texts through generate_many at T = 0.85 and generate_many_stream at
# batch_size=32
SERVE_32 = {"temps": (0.85,), "streams": ((_texts(32), 32),), "b": 32, "texts": _texts(32),
            "max_tokens": MANY_32_TOKENS, "stream_tokens": STREAM_32_TOKENS,
            "min_rows": MIN_ROWS_32}


# The `w8r` product against the fp32 product it replaced, and with TF32
# allowed against not: exact operands, so only fp32 sum order separates
# them (1.4-2.5e-7 on the card); a product that dropped x's third bf16 part
# would be off by ~2^-17 (8e-6), one rounded to TF32 by ~1e-3
TOL_W8R = 1e-6


def w8r_product(pl, card: str, m: int = 8) -> dict:
    """The `w8r` product (fp32 GEMMs of bf16-valued parts; no precision
    flag read or written) against the product it replaced (the fp32 GEMM
    of x, TF32 off as main() sets it) at a lockstep step's shapes, M = m:
    talker layer 0's linears, the codec head and the code predictor's
    layer 0 on bf16 x (one part, the same GEMM: bit for bit), and its
    group-0 lm head on fp32 x (three parts). Then, on every shape, fp32 x
    that is not bf16-valued (three parts), against the old product and
    with TF32 allowed against without, compared before any bf16 rounding.
    Prints each shape's rel RMS and both times (CUDA events); fails past
    TOL_W8R. Returns the worst rel RMS of each comparison and the summed
    times."""
    import torch

    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.ops import linear as lin

    def old(entry, x):
        q = entry["w8r"]
        y = torch.matmul(x.float(), q.float().transpose(-1, -2))
        return (y * entry["s"][0].float() + entry["m"][0].float()
                * x.float().sum(-1, keepdim=True)).to(x.dtype)

    cases = [(f"talker {k}", e, torch.bfloat16)
             for k, e in talker_mod._layer(pl.params["layers"], 0).items() if "w8r" in e]
    cases.append(("codec head", pl.params["codec_head"], torch.bfloat16))
    cases += [(f"cp {k}", e, torch.bfloat16)
              for k, e in talker_mod._layer(pl.cp_params["layers"], 0).items() if "w8r" in e]
    cases.append(("cp lm_head[0]", {k: v[0] for k, v in pl.cp_params["lm_head"].items()},
                  torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {"vs_old": 0.0, "fp32_vs_old": 0.0, "tf32_on": 0.0, "ms": 0.0, "old_ms": 0.0}
    for name, entry, dt in cases:
        k = entry["w8r"].shape[1]
        x = torch.randn(m, 1, k, device="cuda", generator=gen).to(dt)
        err = rel_rms(lin._w8r_linear(entry, x).float(), old(entry, x).float())
        xf = torch.randn(m, 1, k, device="cuda", generator=gen)
        exact = lin._w8r_linear(entry, xf)
        err32 = rel_rms(exact, old(entry, xf))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = rel_rms(lin._w8r_linear(entry, xf), exact)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        (ms, how), (oms, ohow) = (time_ms(lambda: lin._w8r_linear(entry, x), 50),
                                  time_ms(lambda: old(entry, x), 50))
        for key, v in (("vs_old", err), ("fp32_vs_old", err32), ("tf32_on", tf32)):
            out[key] = max(out[key], v)
        out["ms"] += ms
        out["old_ms"] += oms
        log(f"[serving] w8r product M={m} {name} {tuple(entry['w8r'].shape)} x {dt}: rel RMS "
            f"against the fp32 (TF32 off) product {err:.3e}; fp32 x (not bf16-valued): "
            f"against it {err32:.3e}, TF32 allowed against not {tf32:.3e}; {ms:.4f} ms "
            f"({how}) against {oms:.4f} ms ({ohow}) ({card})")
    log(f"[serving] w8r product: worst rel RMS against the old product {out['vs_old']:.3e} "
        f"(fp32 x not bf16-valued: {out['fp32_vs_old']:.3e}), TF32 allowed against not "
        f"{out['tf32_on']:.3e} (tol {TOL_W8R:g}); summed {out['ms']:.4f} ms against "
        f"{out['old_ms']:.4f} ms at M = {m} ({card})")
    if not max(out["vs_old"], out["fp32_vs_old"], out["tf32_on"]) <= TOL_W8R:
        raise SystemExit("the w8r product disagrees with the fp32 product")
    return out


# The service phases: a burst of requests of BURST_TOKENS frames each into
# the idle batch (service-modes' and service-1.7b's: mode_burst); then,
# in service-modes, while two long requests
# keep the batch running, 4 staggered arrivals (one sampled), a client that
# hangs up after its first audio, an OpenAI-style pcm request and a
# /tts_many of 2 texts. Each text's
# trailing tokens fit the service's default trailing bucket (64) with the
# test model dir's character-level tokenizer
SERVICE_TEXTS = (
    "Good morning.",
    "The train leaves at half past nine.",
    "Please water the plants tonight.",
    "A short one.",
    "The quick brown fox jumps over the dog.",
    "Numbers like twelve are read in full.",
    "The museum opens its new wing next week.",
    "Thank you, we will be with you shortly.",
)
BURST_TOKENS = 48  # few, for the script's time
LATE_TEXTS = ("A late arrival takes a freed slot.", "A sampled request joins later.",
              "The third late arrival.", "Last of the late arrivals.")
# The mode burst (service-modes at 0.6B, service-1.7b's burst):
# testing.MODE_BURST, the CPU tests' burst, sent over HTTP as 8 streamed
# requests at temperature 0, one of each prompt layout a voice-design or
# cloning service batches together (two VoiceDesign descriptions of
# different token lengths, two CustomVoice requests, a speaker-embedding
# clone and an ICL request from one 5 s reference clip (REF_S), the OpenAI
# route's `voice` + `instructions`, a built-in speaker). MODE_NAMES names
# each in order; the clip goes as base64 16-bit WAV, which the server turns
# into a speaker embedding (no transcript) or ICL codes (with one) on the
# request's thread. The texts' trailing tokens fit the default trailing
# bucket (64), and an ICL prompt of a 5 s clip's 63 codes the default
# prompt bucket (128)
MODE_NAMES = ("voice_design", "voice_design_long", "custom_voice", "custom_voice_2",
              "speaker_embedding", "icl", "openai_instructions", "builtin")
REF_S, LONG_REF_S = 5.0, 9.0  # the long clip's ICL prompt passes the 128-row bucket
LONG_REF_TEXT = "A long reference clip to clone."


# bench.py's service_ttfa (bench.py:836-960), the JAX package's service
# measure at 1.7B: TTSService(batch_size=16, trailing_bucket=128), its text
# (74 trailing tokens with the test dirs' character-level tokenizer: past
# the default bucket of 64), a burst of 16 requests of SERVICE_16_TOKENS
# frames into the idle service; then STEADY_LONG long streams of
# STEADY_LONG_TOKENS frames at STEADY_TEMP (bench.py's default temperature)
# keep the batch busy, 4 arrivals of SERVICE_16_TOKENS frames come
# STEADY_WAIT_S later into the freed slots, and the long streams are then
# cancelled (TTSRequest.cancel)
BENCH_TEXT = "Sixteen concurrent users each want their first chunk fast."
SERVICE_16, SERVICE_16_TRAILING, SERVICE_16_TOKENS = 16, 128, 40
STEADY_LONG, STEADY_LONG_TOKENS, STEADY_TEMP, STEADY_WAIT_S = 12, 320, 0.9, 2.0
# the burst rows held against B = 1: the 8 modes and the first and last of
# the 8 built-in requests (one prompt: their B = 1 singles are alike)
SERVICE_16_TF_ROWS = (*range(8), 8, 15)


def _clip_b64(clip) -> str:
    """A clip (float PCM at 24 kHz) as base64 16-bit WAV, as a client sends it."""
    from qwen3_tts_tpu_torch.io.wav import wav_data

    return base64.b64encode(wav_data(np.asarray(clip, np.float32), 24000)).decode()


def bench_burst(clip) -> list:
    """service-1.7b's burst of SERVICE_16: mode_burst's 8 requests, then 8
    built-in ones of bench.py's text (speaker aiden), as (mode, path, body)."""
    return mode_burst(clip) + [("bench", "/tts?stream=1", {"text": BENCH_TEXT,
                                                           "speaker": "aiden"})] * 8


def steady_arrivals(clip) -> list:
    """The 4 arrivals into the busy batch, as (mode, path, body): bench.py's
    text from two built-in requests, a clone by x-vector and an ICL clone,
    both of the 5 s `clip`."""
    from qwen3_tts_tpu_torch import testing

    b64 = _clip_b64(clip)
    builtin = {"text": BENCH_TEXT, "speaker": "aiden"}
    return [("builtin", "/tts?stream=1", builtin), ("builtin", "/tts?stream=1", builtin),
            ("speaker_embedding", "/tts?stream=1", {"text": BENCH_TEXT,
                                                    "reference_audio_b64": b64}),
            ("icl", "/tts?stream=1", {"text": BENCH_TEXT, "reference_audio_b64": b64,
                                      "reference_transcript": testing.REFERENCE_TRANSCRIPT})]


def mode_burst(clip) -> list:
    """testing.MODE_BURST as (mode, path, body) HTTP requests, the clip
    (float PCM at 24 kHz) as base64 16-bit WAV, as a client sends it."""
    from qwen3_tts_tpu_torch import testing

    b64 = _clip_b64(clip)
    out = []
    for mode, (text, speaker, kw) in zip(MODE_NAMES, testing.MODE_BURST, strict=True):
        if mode == "openai_instructions":
            out.append((mode, "/v1/audio/speech", {
                "input": text, "voice": speaker, "instructions": kw["instruct"],
                "response_format": "pcm", "stream_format": "audio"}))
            continue
        body = {"text": text, **({"speaker": speaker} if speaker else {})}
        if "instruct" in kw:
            body["instruct"] = kw["instruct"]
        if "speaker_embedding" in kw or "reference_audio_codes" in kw:
            body["reference_audio_b64"] = b64
        if "reference_transcript" in kw:
            body["reference_transcript"] = kw["reference_transcript"]
        out.append((mode, "/tts?stream=1", body))
    return out


def burst_prompts(pl, burst: list) -> list:
    """(text, speaker, prompt kwargs) of each burst request on `pl`, as the
    server maps it (the OpenAI route's `voice` / `instructions` to speaker /
    instruct; server._prompt_kwargs runs the encoders on `pl`)."""
    from qwen3_tts_tpu_torch import server

    out = []
    for _, path, body in burst:
        if path == "/v1/audio/speech":
            body = {"text": body["input"], "speaker": body["voice"],
                    "instruct": body["instructions"]}
        out.append((body["text"], body.get("speaker", ""), server._prompt_kwargs(body, pl)))
    return out


def _http_client(port: int, path: str, body: dict, out: dict, hang_up: bool = False) -> None:
    """POST `body`; records status, headers, the whole body, and the time
    to the first PCM byte (after a WAV header of a streamed wav). hang_up:
    close the socket right after the first PCM byte."""
    import http.client
    import socket

    t0 = time.perf_counter()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out.update(status=r.status, headers={k.lower(): v for k, v in r.getheaders()})
        streamed = out["headers"].get("transfer-encoding") == "chunked"
        head = r.read(44) if streamed and out["headers"].get("content-type") == "audio/wav" else b""
        first = r.read(1)
        out["first_s"] = time.perf_counter() - t0
        if hang_up:
            conn.sock.shutdown(socket.SHUT_RDWR)
            conn.close()
            out["body"] = head + first
            return
        out["body"] = head + first + r.read()
        out["end"] = time.perf_counter()
        conn.close()
    except Exception as e:  # checked by the caller
        out["error"] = f"{type(e).__name__}: {e}"


def _pcm_ok(data: bytes, spf: int) -> tuple[bool, int]:
    """(whole frames of finite, non-silent 16-bit PCM, sample count)."""
    pcm = np.frombuffer(data, np.int16) if len(data) % 2 == 0 else np.zeros(0, np.int16)
    return bool(len(pcm) and len(pcm) % spf == 0 and np.abs(pcm).max() > 0), len(pcm)


def phase_service(pl, card: str, label: str = "service", mixed: bool = True, pl32=None,
                  batch_size: int = 8, burst_tokens: int = BURST_TOKENS, tf_rows=None,
                  burst=None, trailing_bucket=None, steady=None):
    """The always-on service over HTTP on localhost (server.serve at B =
    batch_size, warmup=True; `trailing_bucket` its trailing bucket, the
    default when None): a burst of batch_size streamed requests
    (SERVICE_TEXTS in turn, or `burst`: (mode, path, body) of each slot,
    mode_burst's prompt layouts in one batch; burst_tokens
    frames) at temperature 0 into the idle batch; then (`mixed`), while two
    long requests keep the batch
    running, 4 staggered arrivals (one at 0.85), a client that hangs up
    after its first audio, an OpenAI-style pcm request and a /tts_many of 2
    texts beside the busy service; or (`steady`: (mode, path, body) of
    each arrival) bench.py's steady traffic: STEADY_LONG streams of
    BENCH_TEXT submitted to the service (STEADY_LONG_TOKENS frames at
    STEADY_TEMP) keep the batch busy, the arrivals come over HTTP
    STEADY_WAIT_S later (burst_tokens frames at temperature 0; each one's
    first PCM byte by mode), then every long stream is cancelled
    (TTSRequest.cancel) and must end with one final chunk. Checks every
    response, the /stats identities after the drain (the cancellations
    counted: the hang-up's, each long stream's cancelled before its end;
    no slot left active), that the traffic
    captured no graph of the service's keys, the launch counts, and each
    greedy burst stream (those of `tf_rows`, when given) teacher-forced
    against B = 1 on its own frames (a
    smoke tool records them: a wrapped filter_valid_frames hands the
    service worker's raw frames to a recording _RowPacker); with `pl32`
    (fp32_twin(pl)) BATCH_ROUNDING's two checks: the twin's B = batch_size
    against its B = 1 prefills of the same requests at TOL["float32"], then
    the bf16 comparison under the derived bound. With `burst`, also the
    service's greedy graph against the eager step bit for bit on the
    burst's own mixed batch, and each mode's first PCM byte. Returns
    (launch counts of the traffic, metrics)."""
    import http.client

    import torch

    from qwen3_tts_tpu_torch import server
    from qwen3_tts_tpu_torch.io.wav import streaming_wav_header
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import prompt as prompt_mod
    from qwen3_tts_tpu_torch.models import serving as srv

    spf, m = pl._samples_per_frame, {}
    raw, last = {}, {}
    filt, packer_cls = gen_mod.filter_valid_frames, srv._RowPacker

    def recording_filter(frames):
        last[threading.get_ident()] = frames
        return filt(frames)

    class RecordingPacker(packer_cls):
        def feed(self, key, valid, done):
            raw.setdefault(key, []).append(last.pop(threading.get_ident()))
            return super().feed(key, valid, done)

    gen_mod.filter_valid_frames, srv._RowPacker = recording_filter, RecordingPacker
    httpd = None
    try:
        pool = srv.graphs(pl.params)
        keys_before = set(pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        httpd = server.serve(pl, port=0, batch_size=batch_size, warmup=True,
                             **({} if trailing_bucket is None
                                else {"trailing_bucket": trailing_bucket}))
        warm_s = time.perf_counter() - t0
        svc, port = httpd.tts_service, httpd.server_address[1]
        ours = {k: [(id(g), g.capture_s) for g in gs] for k, gs in pool.items()
                if k[4] == svc.statics and k[0] == batch_size}
        log(f"[{label}] serve(batch_size={batch_size}, warmup=True): {warm_s:.2f} s; graphs of the "
            f"service's keys: " + ", ".join(f"B={k[0]} capacity={k[1]} trailing={k[2]} "
                                            f"sampled={k[5]} captured in {gs[0][1]:.3f} s"
                                            for k, gs in ours.items())
            + f"; {len(set(pool) - keys_before)} keys new in the warmup ({card})")
        if sorted(k[5] for k in ours) != [False, True] or any(len(v) != 1 for v in ours.values()):
            raise SystemExit(f"[{label}] warmup left graphs {ours}; expected one greedy and "
                             "one sampled")
        keys_warm = set(pool)
        torch.cuda.synchronize()
        reset_counts()
        outs = {}

        def go(name, path, body, **kw):
            outs[name] = {}
            th = threading.Thread(target=_http_client, args=(port, path, body, outs[name]),
                                  kwargs=kw)
            th.start()
            return th

        # the burst alone, into the idle batch
        t_burst = time.perf_counter()
        if burst is None:
            threads = [go(f"burst{i}", "/tts?stream=1", {
                "text": SERVICE_TEXTS[i % len(SERVICE_TEXTS)], "speaker": "aiden",
                "temperature": 0.0, "max_tokens": burst_tokens, "seed": 100 + i})
                for i in range(batch_size)]
        else:
            threads = [go(f"burst{i}", path, {**body, "temperature": 0.0,
                                              "max_tokens": burst_tokens, "seed": 100 + i})
                       for i, (_, path, body) in enumerate(burst)]
        for th in threads:
            th.join(timeout=600)
        longs = _steady_traffic(svc, steady, go, burst_tokens, label) if steady else {}
        # two long requests keep the batch running; once they decode, the
        # staggered arrivals, a hang-up, /v1 and /tts_many
        carriers = 2 if mixed else 0
        threads = [go(f"carrier{i}", "/tts?stream=1", {
            "text": SERVICE_TEXTS[4 + i], "speaker": "aiden", "temperature": 0.0,
            "max_tokens": 120, "seed": 400 + i}) for i in range(carriers)]
        t_carrier = time.perf_counter()
        while (not all("first_s" in outs[f"carrier{i}"] or "error" in outs[f"carrier{i}"]
                       for i in range(carriers)) and time.perf_counter() - t_carrier < 120):
            time.sleep(0.005)
        for i, text in enumerate(LATE_TEXTS if mixed else ()):
            threads.append(go(f"late{i}", "/tts?stream=1", {
                "text": text, "speaker": "aiden", "temperature": 0.85 if i == 1 else 0.0,
                "max_tokens": 48, "seed": 200 + i}))
            if i == 0:
                threads.append(go("hangup", "/tts?stream=1", {
                    "text": SERVICE_TEXTS[6], "speaker": "aiden", "temperature": 0.0,
                    "max_tokens": 240, "seed": 300}, hang_up=True))
                threads.append(go("speech_pcm", "/v1/audio/speech", {
                    "input": SERVICE_TEXTS[2], "voice": "aiden", "response_format": "pcm",
                    "temperature": 0.0, "max_tokens": 36, "seed": 301}))
                threads.append(go("tts_many", "/tts_many", {
                    "texts": [SERVICE_TEXTS[1], SERVICE_TEXTS[3]], "speaker": "aiden",
                    "temperature": 0.0, "max_tokens": 36, "batch_size": 2, "seed": 302}))
            time.sleep(0.3)
        for th in threads:
            th.join(timeout=600)
        deadline = time.perf_counter() + 120
        while True:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/stats")
            stats = json.loads(conn.getresponse().read())
            conn.close()
            done = stats["requests_completed"] + stats["requests_failed"] + stats[
                "requests_cancelled"]
            if ((done == stats["requests_submitted"] and not stats["active_slots"])
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.1)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        gen_mod.filter_valid_frames, srv._RowPacker = filt, packer_cls
        if httpd is not None:
            httpd.shutdown()
    log(f"[{label}] /stats after the drain: {json.dumps(stats)}")
    bad = [n for n, o in outs.items() if "error" in o or o.get("status") != 200]
    if bad:
        raise SystemExit(f"[{label}] requests failed: {[(n, outs[n]) for n in bad]}")
    # well-formed responses
    header = streaming_wav_header(pl.sample_rate)
    burst_audio_s, burst_frames, firsts = 0.0, 0, []
    for name, o in outs.items():
        h = o["headers"]
        if name == "tts_many":
            wavs = json.loads(o["body"])["wavs"]
            pcm = [base64.b64decode(w)[44:] for w in wavs]
            ok = len(wavs) == 2 and all(_pcm_ok(x, spf)[0] for x in pcm)
        elif name == "speech_pcm":
            ok = h.get("content-type") == "audio/pcm" and _pcm_ok(o["body"], spf)[0]
        elif name == "hangup":
            ok = o["body"][:44] == header and len(o["body"]) == 45
        elif h.get("content-type") == "audio/pcm":  # a burst's streamed OpenAI request
            n = _pcm_ok(o["body"], spf)[1]
            ok = h.get("transfer-encoding") == "chunked" and _pcm_ok(o["body"], spf)[0]
            burst_audio_s += n / pl.sample_rate
            burst_frames += n // spf
            firsts.append(o["first_s"])
        else:
            ok = (h.get("transfer-encoding") == "chunked" and o["body"][:44] == header
                  and _pcm_ok(o["body"][44:], spf)[0])
            if name.startswith("burst"):
                n = _pcm_ok(o["body"][44:], spf)[1]
                burst_audio_s += n / pl.sample_rate
                burst_frames += n // spf
                firsts.append(o["first_s"])
        if not ok:
            raise SystemExit(f"[{label}] {name}: malformed response {h} "
                             f"({len(o.get('body', b''))} bytes)")
    m["warmup_s"] = warm_s
    m["burst_first_audio_s"] = firsts
    m["late_first_audio_s"] = [outs[f"late{i}"]["first_s"] for i in range(4 if mixed else 0)]
    burst_s = max(outs[f"burst{i}"]["end"] for i in range(batch_size)) - t_burst
    m["burst_rtf"] = burst_s / burst_audio_s
    m["burst_frames_per_s"] = burst_frames / burst_s
    m["burst_first_audio_min_median_max_s"] = [min(firsts), float(np.median(firsts)),
                                               max(firsts)]
    log(f"[{label}] burst of {batch_size} streamed requests into the idle batch (T=0, "
        f"max_tokens {burst_tokens}): "
        f"{burst_s:.3f} s for {burst_audio_s:.2f} s of audio, serving RTF "
        f"{m['burst_rtf']:.4f}, {m['burst_frames_per_s']:.1f} frames/s; first PCM byte "
        f"over HTTP per request (s): " + ", ".join(f"{x:.3f}" for x in firsts)
        + f"; min {min(firsts):.3f}, median {np.median(firsts):.3f}, max {max(firsts):.3f} "
        f"({card}, bf16)")
    def by_mode(prefix, reqs):
        """{mode: [first PCM byte s, ...]}, {mode: [frames, ...]} of reqs."""
        first, frames = {}, {}
        for i, (mode, path, _) in enumerate(reqs):
            o = outs[f"{prefix}{i}"]
            first.setdefault(mode, []).append(o["first_s"])
            frames.setdefault(mode, []).append(_pcm_ok(o["body"][
                0 if path == "/v1/audio/speech" else 44:], spf)[1] // spf)
        log(f"[{label}] {prefix}: first PCM byte over HTTP (s) and frames by mode: "
            + ", ".join(f"{mode} " + "/".join(f"{x:.3f}" for x in xs)
                        + f" ({'/'.join(map(str, frames[mode]))})" for mode, xs in first.items())
            + f" ({card}, bf16)")
        return first, frames

    if burst is not None:
        m["first_audio_by_mode_s"], m["frames_by_mode"] = by_mode("burst", burst)
    if steady:
        m["steady"] = longs
        m["steady_first_audio_by_mode_s"], m["steady_frames_by_mode"] = by_mode("steady", steady)
    if mixed:
        log(f"[{label}] staggered arrivals into the running batch (two requests of 120 "
            f"frames decoding): first PCM byte (s): "
            + ", ".join(f"{x:.3f}" for x in m["late_first_audio_s"])
            + f"; hang-up after {outs['hangup']['first_s']:.3f} s ({card}, bf16)")
    # the drain and its identities
    ident = stats["requests_submitted"] == (stats["requests_completed"]
                                            + stats["requests_failed"]
                                            + stats["requests_cancelled"])
    cancelled = int(mixed) + longs.get("cancelled", 0)  # the hang-up, the long streams
    if (not ident or stats["worker_restarts"] or stats["requests_failed"]
            or stats["requests_cancelled"] != cancelled or stats["active_slots"]):
        raise SystemExit(f"[{label}] /stats after the drain breaks its identities: {stats}")
    # no capture of the service's keys after warmup; /tts_many's own keys
    after = {k: [(id(g), g.capture_s) for g in gs] for k, gs in pool.items()
             if k[4] == svc.statics and k[0] == batch_size}
    new = {k: len(pool[k]) for k in set(pool) - keys_warm}
    log(f"[{label}] graphs of the service's keys after the traffic: "
        f"{'unchanged' if after == ours else 'CHANGED'}; keys captured by /tts_many beside "
        f"it: {[(k[0], k[1], k[2], k[5], n) for k, n in new.items()]}")
    if after != ours or any(k[4] == svc.statics or n != 1 for k, n in new.items()):
        raise SystemExit(f"[{label}] the traffic captured a lockstep graph of the service")
    check_counts(label, launches, need=("int8_matmul", "pre_transformer", "upsample_stage",
                                        "residual_units", "block_upsample"),
                 idle=("talker_step", "cp_frame", "gumbel_sample", "packed_matmul",
                       "pre_transformer_fused"))
    # each greedy burst stream, teacher-forced against B = 1
    reqs = sorted((r for r in raw if 100 <= getattr(r, "seed", -1) < 100 + batch_size),
                  key=lambda r: r.seed)
    if len(reqs) != batch_size:
        raise SystemExit(f"[{label}] recorded {len(reqs)} burst streams of {batch_size}")
    streams = [np.concatenate(raw[r]) for r in reqs]
    steps = min(8, min(len(f) for f in streams))
    frames = torch.from_numpy(np.stack([f[:steps] for f in streams]).astype(np.int64)).cuda()
    wide = svc._prefill_bootstrap(dict(enumerate(reqs)))
    singles = {j: svc._prefill(r) for j, r in enumerate(reqs)
               if tf_rows is None or j in tf_rows}
    ref, t_tf = None, time.perf_counter()
    if pl32 is not None:  # BATCH_ROUNDING's two checks, as batch_vs_single makes them
        prompts = None if burst is None else burst_prompts(pl32, burst)
        ref = {}
        m["batch_vs_single_fp32"] = held_against_single(
            pl32, card, label, svc.statics, _service_bootstrap(pl32, svc, reqs, prompts),
            {j: _service_bootstrap(pl32, svc, [reqs[j]], prompts) for j in singles},
            frames, tol=TOL["float32"], keep=ref)
    m["batch_vs_single"] = held_against_single(pl, card, label, svc.statics, wide, singles,
                                               frames, emitted=True, ref=ref)
    log(f"[{label}] B = {batch_size} against B = 1: {time.perf_counter() - t_tf:.1f} s")
    if burst is not None:  # the service's own greedy graph on the mixed layouts
        lengths = [prompt_mod.pd_lengths(r.pd)[0] for r in reqs]
        log(f"[{label}] the burst's prompt rows by slot: {lengths} (bucket "
            f"{svc.prompt_bucket})")
        graph_vs_eager(pl, card, label=label, state=svc._prefill_bootstrap(dict(enumerate(
            reqs))), statics=svc.statics)
    return launches, m


def _steady_traffic(svc, arrivals: list, go, tokens: int, label: str) -> dict:
    """phase_service's steady traffic (bench.py's): STEADY_LONG streams of
    BENCH_TEXT submitted to `svc` keep the batch busy, each drained on its
    own thread; once every one has audio and STEADY_WAIT_S have passed
    since the submits, the `arrivals` go over HTTP at once (`go`, tokens
    frames at temperature 0, names steady0...); after they end, every long
    stream is cancelled and must end with one final chunk. Returns
    {"arrivals_s", "still_decoding", "cancelled" (the long streams whose
    terminal push came after their cancel, as the service counts them),
    "frames" (each long stream's, to its end)}."""
    from qwen3_tts_tpu_torch import service as service_mod

    push, terminal = service_mod.TTSRequest._push, {}

    def recording_push(req, item):
        if isinstance(item, Exception) or item.is_final:
            terminal.setdefault(req, req.cancelled)
        return push(req, item)

    service_mod.TTSRequest._push = recording_push
    try:
        longs = [svc.submit(BENCH_TEXT, "aiden", temperature=STEADY_TEMP,
                            max_tokens=STEADY_LONG_TOKENS, seed=500 + i)
                 for i in range(STEADY_LONG)]
        got = {i: [] for i in range(STEADY_LONG)}

        def drain(i):
            try:
                for c in longs[i].chunks():
                    got[i].append(c)
            except Exception as e:  # checked below
                got[i].append(e)

        drains = [threading.Thread(target=drain, args=(i,)) for i in range(STEADY_LONG)]
        for th in drains:
            th.start()
        t0 = time.perf_counter()
        while ((not all(got.values()) or time.perf_counter() - t0 < STEADY_WAIT_S)
               and time.perf_counter() - t0 < 120):
            time.sleep(0.005)
        t_arrive = time.perf_counter() - t0
        threads = [go(f"steady{i}", path, {**body, "temperature": 0.0, "max_tokens": tokens,
                                           "seed": 600 + i})
                   for i, (_, path, body) in enumerate(arrivals)]
        for th in threads:
            th.join(timeout=600)
        still = sum(not any(getattr(c, "is_final", False) for c in got[i]) for i in got)
        for req in longs:
            req.cancel()
        for th in drains:
            th.join(timeout=120)
    finally:
        service_mod.TTSRequest._push = push
    ends = [sum(getattr(c, "is_final", False) for c in got[i]) for i in got]
    frames = [sum(c.token_range[1] - c.token_range[0] for c in got[i]
                  if not isinstance(c, Exception)) for i in got]
    if (any(isinstance(c, Exception) for cs in got.values() for c in cs) or ends != [1] * len(got)
            or any(req not in terminal for req in longs)):
        raise SystemExit(f"[{label}] the long streams did not each end with one final chunk "
                         f"after the cancel: {ends}, {[len(cs) for cs in got.values()]}")
    cancelled = sum(terminal[req] for req in longs)
    log(f"[{label}] steady traffic: {STEADY_LONG} long streams ({STEADY_LONG_TOKENS} frames, "
        f"T={STEADY_TEMP}) decoding; {len(arrivals)} arrivals sent {t_arrive:.3f} s after their "
        f"submits; long streams still decoding when the arrivals ended: {still}; cancelled: "
        f"{cancelled}; frames of each long stream to its end: {frames}")
    return {"arrivals_s": t_arrive, "still_decoding": still, "cancelled": cancelled,
            "frames": frames}


def _service_bootstrap(pl, svc, burst: list, prompts=None):
    """The full-B prefill svc._prefill_bootstrap makes of `burst` (slot j:
    burst[j], speaker aiden, its text the SERVICE_TEXTS entry its seed
    names, in turn; or prompts[seed - 100], a (text, speaker, prompt
    kwargs) of burst_prompts), on pl's trees: prompts padded to svc's
    buckets, svc's statics."""
    import torch

    from qwen3_tts_tpu_torch import service as service_mod
    from qwen3_tts_tpu_torch.models import prompt as prompt_mod

    def prompt(seed):  # a burst request's seed is 100 + its slot
        if prompts is not None:
            return prompts[seed - 100]
        return SERVICE_TEXTS[(seed - 100) % len(SERVICE_TEXTS)], "aiden", {}

    pds = [prompt_mod.assemble_prompt_padded(
        pl.params, pl.config, pl.tokenizer, prompt(r.seed)[0], speaker=prompt(r.seed)[1],
        prompt_bucket=svc.prompt_bucket, trailing_bucket=svc.trailing_bucket,
        **prompt(r.seed)[2]) for r in burst]
    lengths, totals = zip(*(prompt_mod.pd_lengths(pd) for pd in pds))
    return service_mod._prefill_rows(
        pl.params, torch.cat([pd.input_embeds for pd in pds]),
        torch.cat([pd.trailing_hidden for pd in pds]), list(lengths), list(totals),
        [r.seed for r in burst], pds[0].tts_pad_embed, svc.statics)


def long_reference(pl, card: str, label: str, clip) -> tuple[dict, dict]:
    """The ICL request whose reference is `clip` (LONG_REF_S seconds): its
    prompt passes the default 128-row bucket, so a default service refuses
    it at submit with the JAX service's ValueError and message
    (qwen3_tts_tpu/service.py: "prompt (p embeds / t trailing) exceeds
    service buckets (pb/tb); ..."), and a service built with the first
    PROMPT_BUCKETS entry that holds its rows (its ring capacity that bucket
    + RING_SLACK) serves it at temperature 0 beside a built-in speaker in
    one batch. Returns (launch counts of the served pair, metrics)."""
    import torch

    from qwen3_tts_tpu_torch import service as service_mod
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import prompt as prompt_mod
    from qwen3_tts_tpu_torch.testing import REFERENCE_TRANSCRIPT

    spf, m = pl._samples_per_frame, {}
    codes, m["audio_encoder_s"] = _timed(lambda: pl.encode_reference_audio(clip))
    kw = {"reference_transcript": REFERENCE_TRANSCRIPT, "reference_audio_codes": codes}
    p, t = prompt_mod.pd_lengths(prompt_mod.assemble_prompt(
        pl.params, pl.config, pl.tokenizer, LONG_REF_TEXT, **kw))
    svc = service_mod.TTSService(pl, batch_size=8)
    want = (f"prompt ({p} embeds / {t} trailing) exceeds service buckets "
            f"({svc.prompt_bucket}/{svc.trailing_bucket}); shorten the text or run a service "
            "with larger buckets")
    try:
        svc.submit(LONG_REF_TEXT, temperature=0.0, max_tokens=BURST_TOKENS, **kw)
        got = "accepted"
    except ValueError as e:
        got = str(e)
    finally:
        svc.close()
    log(f"[{label}] an ICL request on a {len(clip) / 24000:.1f} s clip ({len(codes[0])} codes, "
        f"encoded in {m['audio_encoder_s']:.3f} s): {p} prompt rows; the default service "
        f"(prompt bucket {svc.prompt_bucket}): {got!r} "
        f"{'ok' if got == want else 'FAIL (expected ' + repr(want) + ')'}")
    if got != want:
        raise SystemExit(f"[{label}] the default service did not refuse the long reference as "
                         "the JAX service does")
    bucket = gen_mod.pick_bucket(p)
    wide = service_mod.TTSService(pl, batch_size=8, prompt_bucket=bucket)
    try:
        if wide.statics.capacity != bucket + gen_mod.RING_SLACK:
            raise SystemExit(f"[{label}] ring capacity {wide.statics.capacity}, not "
                             f"{bucket} + RING_SLACK")
        torch.cuda.synchronize()
        reset_counts()
        held: list = []
        t0 = time.perf_counter()
        wide.submit(LONG_REF_TEXT, temperature=0.0, max_tokens=BURST_TOKENS, seed=0,
                    _hold=held, **kw)
        wide.submit(SERVICE_TEXTS[1], "aiden", temperature=0.0, max_tokens=BURST_TOKENS,
                    seed=1, _hold=held)
        wide._enqueue(held)
        audio = [r.audio() for r in held]
        m["served_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts()
        s = wide.stats()
    finally:
        wide.close()
    for name, a in zip(("long_icl", "builtin"), audio):
        _check_audio(label, name, a, spf)
    frames = [len(a) // spf for a in audio]
    log(f"[{label}] a service at prompt bucket {bucket} (ring capacity {bucket} + RING_SLACK) "
        f"served it beside a built-in speaker: {frames[0]} and {frames[1]} frames in "
        f"{m['served_s']:.2f} s, its first graph captured in it; completed "
        f"{s['requests_completed']} of {s['requests_submitted']} ({card})")
    if s["requests_completed"] != 2 or s["requests_failed"]:
        raise SystemExit(f"[{label}] the larger-bucket service did not serve both: {s}")
    check_counts(label + " long reference", launches,
                 need=("int8_matmul",) + SERVING_VOCODER,
                 idle=("talker_step", "cp_frame", "gumbel_sample", "packed_matmul",
                       "pre_transformer_fused"))
    m.update(rows=p, bucket=bucket, frames=frames)
    return launches, m


def phase_service_modes(pl, card: str, design) -> tuple[dict, dict]:
    """The voice modes through the lockstep service, on the modes-pipeline
    phase's 0.6B pipeline (both encoders; its talker, code predictor and
    vocoder are the pipeline phase's, the same seed: the megakernel
    configuration's weights, the `w8r` product at M = B in the step's
    graph): phase_service with mode_burst on a 5 s clip of `design` (its
    VoiceDesign audio) and the mixed traffic after it (staggered arrivals,
    a hang-up, /v1/audio/speech, /tts_many), beside the fp32 twin
    (BATCH_ROUNDING's checks, near ties judged on its scores), the
    service's greedy graph bit for bit its eager step on the burst's mixed
    batch; then long_reference on a LONG_REF_S clip (`design` tiled).
    Returns (launch counts summed over the service's traffic and the long
    reference's service, metrics)."""
    t_phase = time.perf_counter()
    label, m = "service-modes", {}
    clip = np.resize(design, int(REF_S * 24000))
    launches, m["service"] = phase_service(pl, card, label, pl32=fp32_twin(pl),
                                           burst=mode_burst(clip))
    long_launches, m["long_reference"] = long_reference(
        pl, card, label, np.resize(design, int(LONG_REF_S * 24000)))
    m["phase_s"] = time.perf_counter() - t_phase
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    return _summed(launches, long_launches), m


def k3_step_launches(cfg) -> int:
    """K3's launches in one frame of the K3 configuration, the single
    stream's or a lockstep step's: the talker's four linears a layer and its
    codec head, and on each of the code predictor's 15 passes its four
    linears a layer, the pass's lm head and, where the code predictor is
    narrower than the talker, small_to_mtp_projection (428 at 0.6B, 443 at
    1.7B)."""
    cc = cfg.code_predictor_config
    proj = int(cc.hidden_size != cfg.hidden_size)
    return (4 * cfg.num_hidden_layers + 1
            + (cc.num_code_groups - 1) * (4 * cc.num_hidden_layers + 1 + proj))


# the weight key each of K3 and K7 runs: int8 group rows, packed words
QMM_KEYS = {"int8_matmul": "w8", "packed_matmul": "wq"}


def tree_launches(pl, name: str) -> int:
    """The launches of K3 or K7 (`name`) in one frame, a lockstep step's or
    a decoded one's, counted from pl's trees: the talker's layer linears
    and codec head whose entries hold the kernel's key (QMM_KEYS), and on
    each of the code predictor's 15 passes its layer linears, the pass's lm
    head and small_to_mtp_projection that do. Every linear of a tree on
    one kernel: k3_step_launches."""
    key, cfg = QMM_KEYS[name], pl.config
    cc = cfg.code_predictor_config
    lins = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")

    def count(tree, layers, heads):
        return (layers * sum(key in tree["layers"].get(n, {}) for n in lins)
                + sum(key in tree.get(h, {}) for h in heads))

    return (count(pl.params, cfg.num_hidden_layers, ("codec_head",))
            + (cc.num_code_groups - 1) * count(pl.cp_params, cc.num_hidden_layers,
                                                ("lm_head", "small_to_mtp_projection")))


def serving_step(pl, card: str, label: str, name: str = "int8_matmul", pl32=None,
                 tf_steps: int = 16, projection: dict | None = None,
                 every_linear: bool = True, b: int = 8):
    """16 lockstep steps at B = b (8, or 32) from one graph on a tree whose
    quantized linears run K3 or K7 (`name`): at M = b (the code predictor's
    first pass at 2b); past M0 (b = 32) every call on the tile, whose
    kernels alone are counted by name. The counts are set to 0 before the
    graph's warm-up and
    capture and read after the steps: the wrapper counts the warm-up's and
    the capture's calls, twice the launches the capture recorded (the M of
    each call is recorded), tree_launches a step, and with `every_linear`
    (every talker and code-predictor linear on the kernel: the K3 and mixed
    configurations) k3_step_launches too. A replay launches the
    recorded kernels without the wrapper: the kernel's device kernels are
    counted by name (QMM_NAMES) in a profile of 5 replays and must be the
    capture's launches each; that window gives the step's device time.
    `projection`: the M -> launches a step that small_to_mtp_projection's
    calls must show. Then the step's times at B = b
    and B = b against B = 1 over the first `tf_steps` steps (`pl32`:
    batch_vs_single's fp32 twin). Returns (the counts, metrics)."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    statics = _statics(pl, 16)
    state = _serving_state(pl, _texts(b), statics)
    torch.cuda.synchronize()
    reset_counts()
    with kernel_rows() as calls:
        state = srv.bind(pl.params, pl.cp_params, state, statics, True)
    g = state.graph
    check_pool(g, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, counts, _, state = srv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.85,
                                                        statics)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    hist = m_per_step(calls[name])
    launched = g.step_launches[srv._COUNTED.index(counters()[name][0])]
    expect = tree_launches(pl, name)
    every = k3_step_launches(pl.config) if every_linear else expect
    tile = b > counters()[name][0].M0
    dev: dict = {}  # the replays' device time: step_times profiles no window
    replayed = replayed_kernels(g, 5, name, label, tile=tile, out=dev)
    proj = None
    if projection is not None:
        proj = m_per_step(calls[name], pl.cp_params["small_to_mtp_projection"][QMM_KEYS[name]])
    ok = (launches[name] == 2 * launched > 0 and launched == expect == every
          and replayed == 5 * launched and bool((frames[..., 0] >= 0).all()) and b in hist
          and proj == projection)
    kern = "K3" if name == "int8_matmul" else "K7"
    log(f"[{label}] 16 lockstep steps at B={b} (T=0.85) from one graph: {secs * 1e3:.1f} ms, "
        f"{secs / 16 * 1e3:.3f} ms a step; {kern}'s wrapper {launches[name]} calls in the "
        f"warm-up and the capture ({launched} a step, expected {expect} from the tree"
        + (f" and {every}, every linear" if every_linear else "") + f"; M of a "
        f"step's launches: {hist}"
        + ("" if projection is None else f"; small_to_mtp_projection's: {proj}, expected "
           f"{projection}") + f"); {kern} {'tile ' if tile else ''}kernels in a profile of 5 "
        f"replays {replayed} "
        f"(expected {5 * launched}); graph captured in {g.capture_s:.3f} s, pool "
        f"{g.pool_bytes} bytes {'ok' if ok else 'FAIL'} ({card}, bf16)")
    if not ok:
        raise SystemExit(f"[{label}] the lockstep steps did not run {kern} at M = {b} in every "
                         "replay")
    check_counts(label, launches, need=(name,), idle=tuple(k for k in KERNELS if k != name))
    m = {"per_step": launched, "m": hist, "replayed": replayed, "projection_m": proj,
         "steps": step_times(pl, card, label, widths=(b,), profiled=())}
    m["steps"][b].update(dev)
    # B = 8 runs the kernel at M = 8 (the GEMV where M0 >= 8, else the tile),
    # B = 32 the tile, B = 1 the GEMV at M = 1: the same bound as the `w8r`
    # serving step
    m["batch_vs_single"] = batch_vs_single(pl, card, frames[:, :tf_steps], label, pl32)
    return launches, m


# K3's and K7's device kernels: the shared GEMV and tile at 8 bits for K3
# (K7's 8-bit ones have the same names; no tree here holds both), at 2-6
# bits for K7
QMM_NAMES = {"int8_matmul": re.compile(r"qt_qmm_(gemv|tile)_kernel<8,"),
             "packed_matmul": re.compile(r"qt_qmm_(gemv|tile)_kernel<[2346],")}


def replayed_kernels(g, n: int, name: str, label: str, tile: bool = False,
                     out: dict | None = None) -> int:
    """K3's or K7's (`name`) device kernels in a torch.profiler window of n
    replays of graph g (`tile`: the tile's kernels only). A window short of
    n times the capture's launches is taken again, up to five windows, as
    profiled_kernels does (a profiler window can lose records, more often
    late in the script); the last window's count is returned. `out`
    receives the window's device ms and device kernels a replay
    ("graph_device_ms", "kernels"), its top 8 rows logged, so the step's
    device time needs no window of its own."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    want = n * g.step_launches[srv._COUNTED.index(counters()[name][0])]
    for window in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                g.replay()
            torch.cuda.synchronize()
        names = [k for k in device_kernels(prof) if QMM_NAMES[name].search(k)
                 and (not tile or "qt_qmm_tile_kernel" in k)]
        got = len(names)
        if got >= want:
            log(f"[{label}] {name} kernels in {n} replays by name: "
                + ", ".join(f"{names.count(k)} {k[:70]}" for k in sorted(set(names))))
            if out is not None:
                out["graph_device_ms"], out["kernels"] = window_device(
                    prof, n, label, f"graph step ({n} replays)", top=8)
                log(f"[{label}] graph step: device {out['graph_device_ms']:.3f} ms in "
                    f"{out['kernels']:.0f} device kernels a replay ({n} replays profiled)")
            break
        log(f"[{label}] profile window {window}: {got} {name} kernels of {want}")
    return got


def check_pool(g, label: str) -> None:
    """A graph's pool must have grown at its capture."""
    if g.pool_bytes <= 0:
        raise SystemExit(f"[{label}] graph pool read {g.pool_bytes} bytes at its capture")


# the train phase: the joint TTS step at 0.6B, fp32 (TF32 off)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 2, 256, 5
# card against the card machine's CPU, both fp32 with TF32 off: the same
# math with sums in another order (K up to 3,072 a product; the embedding
# gradients' index_add in another order on the card): loss and parts rel
# 1e-5, every leaf's gradient rel RMS 1e-4, as the CPU tests hold the port
# against JAX. The one-process mesh step runs the unfused products (other
# GEMM shapes): the same tolerances. A step resumed from a checkpoint reads
# params equal bit for bit, so its loss is held at 1e-6 and its params at
# rel RMS 1e-6 (the embedding gradients' atomics).
# the verify phase: frame-dependent checksums (their input is the greedy
# frames, which bf16 drift may legitimately change on random weights)
FRAME_CHECKSUMS = ("wav",)
VERIFY_TEXTS = SERVICE_TEXTS[1:5]  # decode_chunk_batched's four streams
VERIFY_STEPS = 4


def _summed(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b[k] for k in b}


def _checksum_errors(got: dict, golden: dict, tier: str) -> dict:
    """checksum -> (its worst |have - want| past atol over |want|, the tier's
    rtol): the relative error np.allclose holds against the limit."""
    from qwen3_tts_tpu_torch.io import verify

    policy = verify.TOLERANCE_TIERS[tier]
    out = {}
    for name, want in golden["checksums"].items():
        h, w = np.asarray(got["checksums"][name]), np.asarray(want)
        err = np.max(np.maximum(np.abs(h - w) - policy["atol"], 0.0) / np.abs(w).clip(1e-30))
        out[name] = (float(err), policy["rtol"].get(name, policy["rtol"]["default"]))
    return out


def _run_script(path: str, args: list[str]) -> tuple[int, str]:
    """(exit code, standard output) of the script at `path` run as __main__
    in this process with `args` (no interpreter start-up)."""
    import contextlib
    import io
    import runpy

    argv, buf, rc = sys.argv, io.StringIO(), 0
    sys.argv = [path, *args]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        sys.argv = argv
    return rc, buf.getvalue()


def _broken_copy(d: str, out: str) -> str:
    """`out` (a new directory inside `d`) holding `d`'s files (links) but a
    model.safetensors whose talker codec_head scales are x1.5 (a wrong
    dequantization scale)."""
    import os

    from qwen3_tts_tpu_torch.io import safetensors_io

    os.makedirs(out)
    for name in os.listdir(d):
        if name not in ("model.safetensors", "golden.json", os.path.basename(out)):
            os.symlink(os.path.join(d, name), os.path.join(out, name))
    w = safetensors_io.load_file(os.path.join(d, "model.safetensors"))
    key = next(k for k in sorted(w) if k.endswith("codec_head.scales"))
    w[key] = w[key] * np.float32(1.5)
    safetensors_io.save_file(w, os.path.join(out, "model.safetensors"))
    return out


def _tie_at(pl, pd, cap: int, step: int, single, batched) -> bool:
    """Whether the first code where a stream's batched frame `batched`
    departs from its single-stream frame `single` (at `step`) is a near-tie
    of the single stream's own scores there: code 0's greedy scores, or the
    departing code-predictor group's logits with its repetition penalty
    (that group's inputs are the single's own, equal up to it)."""
    import torch

    from qwen3_tts_tpu_torch.models import code_predictor as cp_mod
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.ops.sampling import NEG_INF

    cfg = pl.config
    st = gen_mod.prefill(pl.params, pd, cfg, capacity=cap)
    if step:
        gen_mod.decode_chunk(pl.params, pl.cp_params, st, cfg, steps=step, temperature=0.0,
                             generator=None, track_cp_penalty=True)
    g = int(np.nonzero(single != batched)[0][0])
    if g == 0:
        eos_pad_mask, valid_mask = st["masks"]
        has_text = st["trailing_idx"] < st["total_text"]
        lg = (st["logits"] + torch.where(has_text, eos_pad_mask, 0.0)).float()
        lg = lg / torch.where(st["seen_code0"], 1.05, 1.0)
        scores = torch.where(valid_mask & (lg > float(NEG_INF) / 2), lg, float("-inf"))
    else:  # the departing group's logits, on the single stream's own codes before it
        seen = st["seen_cp"].clone()
        logits: list = []
        code0 = torch.tensor(int(single[0]), device=st["logits"].device)
        cp_mod.predict_frame(pl.cp_params, st["h_last"],
                             talker_mod.encode_audio(pl.params, code0.reshape(1, 1)), None,
                             0.0, st["seen_cp"], cfg.code_predictor_config,
                             forced_codes=torch.from_numpy(single[1:]).to(code0.device),
                             logits_out=logits)
        scores = logits[g - 1].float() / torch.where(seen[g - 1], 1.05, 1.0)
    return _near_tie(scores.cpu(), int(single[g]), int(batched[g]))


def batched_chunk(pl, card: str) -> tuple[dict, dict]:
    """decode_chunk_batched at B = 4 (VERIFY_TEXTS, one ring capacity)
    against four single-stream decode_chunk calls, greedy, VERIFY_STEPS
    frames: each stream's frames equal up to its first departure, which
    must be a near-tie of the single stream's own scores (_tie_at), after
    which the two may differ; counts and EOS equal where no frame departs.
    Times one batched and one single chunk (events; the profiler's summed
    device time). Returns (launch counts of the batched chunk, metrics)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    label = "verify"
    kw = dict(temperature=0.0, track_cp_penalty=True)
    pds = [pl._assemble(t, "aiden") for t in VERIFY_TEXTS]
    cap = max(pd.input_embeds.shape[1] for pd in pds) + gen_mod.RING_SLACK

    def single(pd):
        st = gen_mod.prefill(pl.params, pd, pl.config, capacity=cap)
        return gen_mod.decode_chunk(pl.params, pl.cp_params, st, pl.config, steps=VERIFY_STEPS,
                                    generator=None, **kw)

    def batched():
        states = gen_mod.stack_states([gen_mod.prefill(pl.params, pd, pl.config, capacity=cap)
                                       for pd in pds])
        return gen_mod.decode_chunk_batched(pl.params, pl.cp_params, states, pl.config,
                                            steps=VERIFY_STEPS, **kw)

    singles = [tuple(x.cpu() for x in single(pd)) for pd in pds]
    reset_counts()
    torch.cuda.synchronize()
    frames, counts, eos = (x.cpu() for x in batched())
    torch.cuda.synchronize()
    launches = read_counts()
    departed, ties = [], 0
    for j, (fs, cs, es) in enumerate(singles):
        diff = (fs != frames[j]).any(1).nonzero()
        if len(diff) == 0:
            if int(cs) != int(counts[j]) or bool(es) != bool(eos[j]):
                raise SystemExit(f"[{label}] stream {j}: equal frames, counts {int(counts[j])} "
                                 f"vs {int(cs)}, eos {bool(eos[j])} vs {bool(es)}")
            continue
        i = int(diff[0])
        if not _tie_at(pl, pds[j], cap, i, fs[i].numpy(), frames[j, i].numpy()):
            departed.append((j, i))
        ties += 1
    log(f"[{label}] decode_chunk_batched B={len(pds)} x {VERIFY_STEPS} frames against 4 "
        f"single-stream chunks (greedy): {len(pds) - ties} streams equal in every frame, "
        f"count and EOS; {ties} departed, {ties - len(departed)} of them at a near-tie "
        f"(within {NEAR_TIE:g} of the top score); counts {counts.tolist()}; K7 launches "
        f"{launches['packed_matmul']}, K3 {launches['int8_matmul']} ({card}, bf16)")
    if departed:
        raise SystemExit(f"[{label}] batched frames depart from the single streams away from "
                         f"a near-tie: (stream, step) {departed}")

    def timed(fn) -> tuple[float, float]:
        fn()
        torch.cuda.synchronize()
        ev = _events_ms(fn)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return ev, device_us(prof) / 1e3

    m = {}
    m["batched_event_ms"], m["batched_device_ms"] = timed(batched)
    m["single_event_ms"], m["single_device_ms"] = timed(lambda: single(pds[0]))
    log(f"[{label}] a {VERIFY_STEPS}-frame chunk (prefill included): B=4 batched "
        f"{m['batched_event_ms']:.1f} ms by events, {m['batched_device_ms']:.1f} ms of device "
        f"time; one stream {m['single_event_ms']:.1f} / {m['single_device_ms']:.1f} ms ({card}, "
        f"bf16; K7 on the codec head at M=4 / M=1)")
    return launches, m


def phase_verify(card: str, d: str, writer: "DirWriter") -> tuple[dict, dict]:
    """The checkpoint tools at full width on `d`, written by
    write_golden_model_dir at Qwen3TTSConfig.standard() (the default
    decoder, the full-width speaker and audio encoders, widths 4 / 6 / 8,
    group 64, seed 0; DirWriter's "golden" job, waited for in the timer's
    "write" stage); the audit
    script must pass on it; collect_report's exact report on the card
    (fp32, TF32 off, kernels off) saved as the golden; the production report
    (default configuration, bf16) must pass tpu-bf16 and fail cpu-fp32,
    each checksum's error printed beside its limit (a frame-dependent
    checksum may miss only where the frames departed and the golden frames
    through the production vocoder pass), launching K1, K2, K7, K4-K6 and
    the blocks' upsample, not K2g's nor K4a's own entry points; the same
    checkpoint with codec_head.scales x1.5 must fail tpu-bf16;
    speech_tokenizer_decode at B = 2 (the production frames, and them with
    the last third padded) with the kernels against the plain vocoder;
    decode_chunk_batched at B = 4 (batched_chunk) with the megakernels off
    (K7 at M = B on the codec head, which stays packed; the mixed-width
    layers load dequantized); the native BPE core against the
    Python path; a PhaseTimer over the stages and a trace() window over one
    production vocoder decode. Returns (launch counts over the phase,
    metrics)."""
    import os

    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.config import SpeechTokenizerConfig
    from qwen3_tts_tpu_torch.convert import to_torch
    from qwen3_tts_tpu_torch.frontend.tokenizer import Qwen3Tokenizer
    from qwen3_tts_tpu_torch.io import checkpoint as ckpt
    from qwen3_tts_tpu_torch.io import safetensors_io, verify
    from qwen3_tts_tpu_torch.models import vocoder as voc
    from qwen3_tts_tpu_torch.utils.postprocess import sanitize_samples
    from qwen3_tts_tpu_torch.utils.profiling import PhaseTimer, trace

    label = "verify"
    timer, m, total = PhaseTimer(), {}, {}
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with contextlib.nullcontext(d):
        with timer.phase("write"):
            m["write_s"] = writer.wait(d, label)["s"]
        with timer.phase("audit"):  # the script, run in this process
            rc, out = _run_script(f"{root}/scripts/torch_audit_checkpoint.py", [d])
        keys = [ln.strip() for ln in out.splitlines() if ln.startswith(("dense", "quant"))]
        log(f"[{label}] torch_audit_checkpoint.py on a 0.6B dir packed at 4 / 6 / 8 bits: rc "
            f"{rc}, {keys}, last line {out.strip().splitlines()[-1:]}")
        if rc != 0 or '"audit": "pass"' not in out:
            raise SystemExit(f"[{label}] the audit failed:\n{out[-3000:]}")

        reset_counts()
        with timer.phase("exact_report"):
            golden = verify.collect_report(d, device="cuda")
        total = _summed(total, read_counts())
        verify.save_golden(golden, f"{d}/golden.json")
        golden = verify.load_golden(f"{d}/golden.json")
        reset_counts()
        with timer.phase("production_report"):
            prod = verify.collect_report(d, production=True, device="cuda")
        launches = read_counts()
        total = _summed(total, launches)
        check_counts(label, launches,
                     need=("talker_step", "cp_frame", "packed_matmul", "pre_transformer",
                           "upsample_stage", "residual_units", "block_upsample"),
                     idle=("gumbel_sample", "pre_transformer_fused"))
        errs = verify.compare_reports(prod, golden, tier="tpu-bf16")
        strict = verify.compare_reports(prod, golden, tier="cpu-fp32")
        for name, (err, lim) in _checksum_errors(prod, golden, "tpu-bf16").items():
            log(f"[{label}]   {name}: rel err {err:.3e} (tpu-bf16 limit {lim:g}) "
                f"{'ok' if err <= lim else 'MISS'}")
        n_frames = len(golden["frames"])
        same = sum(a == b for a, b in zip(prod["frames"], golden["frames"]))
        log(f"[{label}] production report (bf16, default configuration) against the card's "
            f"exact golden: tpu-bf16 {'PASS' if not errs else errs}; cpu-fp32 fails on "
            f"{len(strict)} items; frames {len(prod['frames'])} vs {n_frames}, {same} equal "
            f"({card})")

        # stage by stage: the golden's own frames through the production vocoder
        with open(f"{d}/speech_tokenizer/config.json") as f:
            dec = SpeechTokenizerConfig.from_json(f.read()).decoder_config
        dense = to_torch(ckpt.load_vocoder_checkpoint(
            safetensors_io.load_file(f"{d}/speech_tokenizer/model.safetensors"), dec,
            dtype=np.float32), "cuda", torch.float32)
        kern = dict(dense, kernel=voc.build_vocoder_kernel_params(dense, dec, torch.bfloat16))
        gf = np.asarray(golden["frames"], np.int64)
        tf_wav = sanitize_samples(voc.speech_tokenizer_decode(kern, gf[None], dec,
                                                              device="cuda")[0][0])
        tf_got = {"checksums": {"wav": verify._stat(tf_wav)}}
        tf_want = {"checksums": {"wav": golden["checksums"]["wav"]}}
        tf_errs = verify.compare_reports(tf_got, tf_want, tier="tpu-bf16")
        tf_err, tf_lim = _checksum_errors(tf_got, tf_want, "tpu-bf16")["wav"]
        log(f"[{label}] the golden frames through the production vocoder (K4-K6, bf16): wav "
            f"rel err {tf_err:.3e} (limit {tf_lim:g}) {'PASS' if not tf_errs else 'MISS'}")
        frame_dep = [e for e in errs if e.startswith(tuple(f"checksum {n!r}"
                                                          for n in FRAME_CHECKSUMS))]
        m["gated"] = frame_dep
        if [e for e in errs if e not in frame_dep] or not strict or (
                frame_dep and (same == n_frames or tf_errs)):
            raise SystemExit(f"[{label}] the production report against the golden: "
                             f"tpu-bf16 {errs}, cpu-fp32 failures {len(strict)}, golden frames "
                             f"through the production vocoder {tf_errs}")
        if frame_dep:
            log(f"[{label}] GATED: {frame_dep} miss(es) only after {n_frames - same} of "
                f"{n_frames} greedy frames departed; the golden frames pass through the "
                f"production vocoder")

        with timer.phase("corrupt_report"):
            broken = _broken_copy(d, f"{d}/broken")
            bad = verify.collect_report(broken, production=True, device="cuda")
        bad_errs = verify.compare_reports(bad, golden, tier="tpu-bf16")
        log(f"[{label}] codec_head.scales x1.5: production report fails tpu-bf16 on "
            f"{[e.split(':')[0] for e in bad_errs]}")
        if not bad_errs:
            raise SystemExit(f"[{label}] the corrupted checkpoint passed the tpu-bf16 tier")

        # speech_tokenizer_decode at B = 2: kernels against the plain vocoder
        pf = np.asarray(prod["frames"], np.int64)
        codes = np.stack([pf, pf])
        codes[1, 2 * len(pf) // 3:] = 0  # stream 1 padded (code 0 = 0 counts for nothing)
        reset_counts()
        with timer.phase("speech_tokenizer_decode"):
            wav, lengths = voc.speech_tokenizer_decode(kern, codes, dec, device="cuda")
        total = _summed(total, read_counts())
        pwav, plengths = voc.speech_tokenizer_decode(dense, codes, dec, device="cuda")
        err = rel_rms(torch.from_numpy(wav), torch.from_numpy(pwav))
        log(f"[{label}] speech_tokenizer_decode B=2 x {len(pf)} frames, kernels (bf16) vs "
            f"plain (fp32): rel_rms={err:.3e} (tol {TOL_VOCODER_BF16:g}), lengths "
            f"{lengths.tolist()} vs {plengths.tolist()}")
        if not (err <= TOL_VOCODER_BF16 and lengths.tolist() == plengths.tolist()
                and lengths[1] < lengths[0]):
            raise SystemExit(f"[{label}] speech_tokenizer_decode disagrees with its plain path")
        with tempfile.TemporaryDirectory() as tdir:
            with trace(tdir) as prof:
                voc.speech_tokenizer_decode(kern, codes[:1], dec, device="cuda")
            files = [f for f in os.listdir(tdir) if f.endswith(".json")]
            n_dev = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
            log(f"[{label}] trace() over one production vocoder decode: {files}, "
                f"{sum(os.path.getsize(f'{tdir}/{f}') for f in files)} bytes, {n_dev} device "
                f"events")
            if not files or not n_dev:
                raise SystemExit(f"[{label}] trace() wrote no trace of the decode")

        # native BPE on the golden text, against the Python path
        text = f"<|im_start|>assistant\n{verify.GOLDEN_TEXT}<|im_end|>\n<|im_start|>assistant\n"
        t0 = time.perf_counter()
        tok = Qwen3Tokenizer(d, native=True)
        m["native_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = Qwen3Tokenizer(d)  # the default: the Python path
        m["python_load_s"] = time.perf_counter() - t0
        ids, py_ids = tok.encode(text), py.encode(text)
        m["native_bpe"] = tok._native is not None
        for name, t in (("native", tok), ("python", py)):
            t0 = time.perf_counter()
            for _ in range(200):
                t.encode(text)
            m[f"{name}_encode_us"] = (time.perf_counter() - t0) / 200 * 1e6
        log(f"[{label}] native BPE core built and used: {m['native_bpe']}; {len(ids)} ids on "
            f"the golden text equal the Python path's: {ids == py_ids}; encode "
            f"{m['native_encode_us']:.1f} us native, {m['python_encode_us']:.1f} us Python "
            f"(mean of 200, host); tokenizer load {m['native_load_s']:.3f} s native, "
            f"{m['python_load_s']:.3f} s Python")
        if ids != py_ids:
            raise SystemExit(f"[{label}] native BPE ids differ from the Python path's")

        off = qt.Qwen3TTSPipelineConfiguration(use_talker_megakernel=False,
                                               use_cp_megakernel=False)
        pl = qt.Qwen3TTSPipeline(d, off, device="cuda")
        with timer.phase("decode_chunk_batched"):
            batch_launches, m["batched"] = batched_chunk(pl, card)
        total = _summed(total, batch_launches)
        if not batch_launches["packed_matmul"]:
            raise SystemExit(f"[{label}] decode_chunk_batched launched no K7")
        del pl
        torch.cuda.empty_cache()
    m["timer"] = {k: timer.totals[k] for k in timer.totals}
    m["phase_s"] = time.perf_counter() - t_phase
    for line in timer.summary().splitlines():
        log(f"[{label}] PhaseTimer {line}")
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    return total, m


TOL_TRAIN = {"loss": 1e-5, "grad": 1e-4, "resume": 1e-6}
FP32_PEAK = RATE["float32"]


def train_flops(cfg, b: int, t: int) -> int:
    """Matmul FLOPs of one train step (forward + backward = 3 x forward; a
    remat step's recomputed forward not counted): every linear, the talker's
    codec head, the cp's 15 lm heads and the attention products over full
    T x T (and 16 x 16) score blocks, as the step computes them."""
    def stack(c, n_tok: int, seq: int) -> int:
        hd, nq, nkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
        h, inter = c.hidden_size, c.intermediate_size
        per_tok = h * (nq + 2 * nkv) * hd + nq * hd * h + 3 * h * inter
        attn = 4 * nq * seq * hd * n_tok  # q k^T and p v, each seq keys per query
        return c.num_hidden_layers * (2 * n_tok * per_tok + attn)

    cc = cfg.code_predictor_config
    n, ng = b * t, cc.num_code_groups
    fwd = stack(cfg, n, t) + 2 * n * cfg.hidden_size * cfg.vocab_size
    fwd += stack(cc, n * ng, ng) + 2 * n * (ng - 1) * cc.vocab_size * cc.hidden_size
    if cc.hidden_size != cfg.hidden_size:
        fwd += 2 * n * ng * cfg.hidden_size * cc.hidden_size
    return 3 * fwd


def _tree_rel(got: dict, ref: dict, tol: float, label: str) -> float:
    """Worst rel RMS over the leaves (zero where the reference is zero),
    on got's device; SystemExit past tol."""
    from qwen3_tts_tpu_torch.parallel import train

    paths, gl = train._flatten(got)
    worst = 0.0
    for path, g, r in zip(paths, gl, train._flatten(ref)[1], strict=True):
        g, r = g.detach(), r.detach().to(g.device)
        err = rel_rms(g, r) if bool(r.any()) else (0.0 if not bool(g.any()) else float("inf"))
        if not err <= tol:  # NaN fails
            raise SystemExit(f"[train] {label}: leaf {'.'.join(path)} rel RMS {err:.3e} > {tol:g}")
        worst = max(worst, err)
    return worst


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


GEMM_NAME = re.compile(r"gemm|cutlass|xmma|sm90_", re.IGNORECASE)


def profile_train_step(step, both, state, batch, wall_ms: float, card: str) -> dict:
    """One more step under torch.profiler: device busy ms (the device
    activities' summed durations) against the step's event ms (the idle
    share), the GEMMs' share of the device time (kernels named like cuBLAS /
    CUTLASS GEMMs), and the kernels that take the most."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(both, state, batch)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():  # device activities only: an aten op's row repeats its kernels'
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    dev_ms = sum(r[0] for r in rows)
    gemm_ms = sum(r[0] for r in rows if GEMM_NAME.search(r[2]))
    if dev_ms <= 0:
        log("[train] profile: device time not measured (the profiler saw no device activity)")
        return {}
    log(f"[train] profile of one step (remat off): device busy {dev_ms:.2f} ms against the "
        f"step's {wall_ms:.2f} ms (idle {100 * (1 - dev_ms / wall_ms):.1f}%), "
        f"{sum(r[1] for r in rows)} device kernels; GEMMs {gemm_ms:.2f} ms "
        f"({100 * gemm_ms / dev_ms:.1f}%); {card}")
    for ms, n, key in rows[:8]:
        log(f"[train]   {ms:.3f} ms in {n} launches: {key[:90]}")
    return {"device_ms": dev_ms, "gemm_ms": gemm_ms, "kernels": sum(r[1] for r in rows),
            "top": [[ms, n, key[:90]] for ms, n, key in rows[:8]]}


def phase_train(card: str) -> tuple[dict, dict]:
    """The joint TTS train step at Qwen3TTSConfig.standard(), full depth,
    fp32 params from seed 0 (talker) and 1 (cp), a random batch (B = 2, T
    = 256, embeds and codes from seed 1), TF32 off: TRAIN_STEPS steps with
    remat off and on (the loss finite and falling, the first step's loss
    and parts equal), step ms (CUDA events, median of steps 2-5), peak
    bytes, the matmul FLOPs over the step's ms against the fp32 peak; then
    at full width and 2 + 2 layers: one step on the card against the card
    machine's CPU (loss, parts, every leaf's gradient), shard_params and
    the step on a one-process NCCL (dp = 1, tp = 1) mesh against the plain
    step, and a checkpoint saved and restored on the card (bit for bit, on
    the template's device and dtype; a resumed step against an
    uninterrupted one). Launches no kernel of the port. Returns (launch
    counts over the phase, metrics)."""
    import dataclasses
    import os
    import statistics

    import torch
    import torch.distributed as dist

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.convert import to_torch
    from qwen3_tts_tpu_torch.parallel import checkpoint as ck
    from qwen3_tts_tpu_torch.parallel import sharding as sh
    from qwen3_tts_tpu_torch.parallel import train
    from qwen3_tts_tpu_torch.testing import random_host_cp_params, random_host_talker_params

    dev = torch.device("cuda")
    cfg = qt.Qwen3TTSConfig.standard()
    reset_counts()
    t_phase = t0 = time.perf_counter()

    def tlog(msg: str) -> None:  # each line with the phase's elapsed time
        log(f"{msg} (phase +{time.perf_counter() - t_phase:.1f} s)")

    host = {"talker": random_host_talker_params(cfg, 0), "cp": random_host_cp_params(cfg, 1)}
    rng = np.random.default_rng(1)
    batch_np = {
        "embeds": rng.standard_normal((TRAIN_B, TRAIN_T, cfg.hidden_size), dtype=np.float32),
        "frames": rng.integers(0, cfg.vocab_size,
                               (TRAIN_B, TRAIN_T, cfg.code_predictor_config.num_code_groups)),
        "mask": np.ones((TRAIN_B, TRAIN_T), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    init = to_torch(host, dev)
    n_params = sum(x.numel() for x in train._flatten(init)[1])
    flops = train_flops(cfg, TRAIN_B, TRAIN_T)
    tlog(f"[train] 0.6B fp32 params ({n_params:,}) and a B = {TRAIN_B}, T = {TRAIN_T} batch "
        f"on the card in {time.perf_counter() - t0:.1f} s; {flops / 1e12:.3f} TFLOP of "
        f"matmuls a step")

    metrics = {"params": n_params, "flops": flops}
    first = {}
    for remat in (False, True):
        both = train._map(torch.clone, init)
        optimizer, step = train.make_tts_train_step(cfg, remat=remat)
        state = optimizer.init(both)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            both, state, loss, parts = step(both, state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
            if i == 0:
                first[remat] = (float(loss), {k: float(v) for k, v in parts.items()})
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(ms[1:5])
        share = flops / (med / 1e3) / FP32_PEAK
        key = "remat" if remat else "plain"
        metrics[key] = {"losses": losses, "step_ms": ms, "step_ms_median_2_5": med,
                        "peak_bytes": peak, "fp32_peak_share": share}
        tlog(f"[train] remat={remat}: losses {[round(x, 5) for x in losses]}; step ms "
            f"{[round(x, 2) for x in ms]}, median of steps 2-5 {med:.2f} ms; peak "
            f"max_memory_allocated {peak:,} B; {flops / 1e12:.3f} TFLOP / {med:.2f} ms = "
            f"{flops / med / 1e9:.1f} TFLOP/s, {100 * share:.1f}% of the fp32 peak "
            f"({FP32_PEAK / 1e12:.0f} TFLOP/s); {card}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"[train] remat={remat}: the loss is not finite and falling: {losses}")
        if not remat:
            metrics["profile"] = profile_train_step(step, both, state, batch, med, card)
        del both, state, optimizer, step
        torch.cuda.empty_cache()
    (l0, p0), (l1, p1) = first[False], first[True]
    errs = [_rel(l1, l0)] + [_rel(p1[k], p0[k]) for k in p0]
    tlog(f"[train] first step, remat on against off: loss {l1!r} vs {l0!r}, parts {p1} vs {p0}; "
        f"worst rel {max(errs):.3e} (tol {TOL_TRAIN['resume']:g}), bit for bit: {l1 == l0}")
    if not max(errs) <= TOL_TRAIN["resume"]:
        raise SystemExit("[train] remat changed the first step's loss")
    metrics["remat_first_step_rel"] = max(errs)
    del init
    torch.cuda.empty_cache()

    # full width, 2 talker + 2 code-predictor layers
    n = 2
    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=n, code_predictor_config=dataclasses.replace(
        cfg.code_predictor_config, num_hidden_layers=n))
    cut = {part: {k: ({kk: {x: w[:n] for x, w in vv.items()} for kk, vv in v.items()}
                      if k == "layers" else v) for k, v in tree.items()}
           for part, tree in host.items()}
    del host
    cpu_both = to_torch(cut, "cpu")
    cpu_batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    t0 = time.perf_counter()
    closs, cparts, cgrads = train.tts_value_and_grad(cpu_both, cpu_batch, cut_cfg)
    cpu_s = time.perf_counter() - t0
    both = train._map(lambda x: x.to(dev), cpu_both)
    gloss, gparts, ggrads = train.tts_value_and_grad(both, batch, cut_cfg)
    errs = [_rel(gloss, closs)] + [_rel(gparts[k], cparts[k]) for k in cparts]
    if not max(errs) <= TOL_TRAIN["loss"]:
        raise SystemExit(f"[train] card against CPU: loss / parts rel {errs}")
    worst = _tree_rel(ggrads, cgrads, TOL_TRAIN["grad"], "card against CPU, gradient")
    tlog(f"[train] full width, {n} + {n} layers, card against the CPU ({cpu_s:.1f} s there): "
        f"loss {float(gloss)!r} vs {float(closs)!r}, loss / parts worst rel {max(errs):.3e} "
        f"(tol {TOL_TRAIN['loss']:g}); every leaf's gradient, worst rel RMS {worst:.3e} "
        f"(tol {TOL_TRAIN['grad']:g})")
    metrics["card_vs_cpu"] = {"loss_rel": max(errs), "grad_rel_rms": worst}
    del cpu_both, cgrads, ggrads

    # shard_params and the step on a one-process NCCL mesh
    with tempfile.TemporaryDirectory() as d:
        sh.init_process_group("cuda", 0, 1, f"file://{d}/rendezvous", timeout_s=60)
        try:
            mesh = sh.make_mesh()
            sharded = {"talker": sh.shard_params(both["talker"], mesh, config=cut_cfg),
                       "cp": train._map(torch.clone, both["cp"])}
            sbatch = sh.shard_batch(batch, mesh)
            optimizer, step = train.make_tts_train_step(cut_cfg)
            sharded, _, sloss, sparts = step(sharded, optimizer.init(sharded), sbatch)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    plain = train._map(torch.clone, both)
    plain, _, ploss, pparts = step(plain, optimizer.init(plain), batch)
    errs = [_rel(sloss, ploss)] + [_rel(sparts[k], pparts[k]) for k in pparts]
    if not max(errs) <= TOL_TRAIN["loss"]:
        raise SystemExit(f"[train] mesh step against the plain step: loss / parts rel {errs}")
    full = train._map(lambda x: x.full_tensor() if isinstance(x, sh.DTensor) else x, sharded)
    worst = _tree_rel(full, dict(plain, talker=sh.unfuse_qkv_gateup(plain["talker"], cut_cfg)),
                      TOL_TRAIN["loss"], "mesh step against the plain step, params")
    tlog(f"[train] shard_params + step on a one-process {backend} mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} against the plain step: loss / "
        f"parts worst rel {max(errs):.3e}, updated params worst rel RMS {worst:.3e} (tol "
        f"{TOL_TRAIN['loss']:g})")
    metrics["mesh_vs_plain"] = {"loss_rel": max(errs), "param_rel_rms": worst}
    del sharded, full, plain

    # a checkpoint on the card, and a resumed step
    optimizer, step = train.make_tts_train_step(cut_cfg)
    state = {"params": both, "opt_state": optimizer.init(both)}
    step(state["params"], state["opt_state"], batch)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ck.save_train_state(d, 1, state)
        save_s = time.perf_counter() - t0
        saved_bytes = sum(os.path.getsize(os.path.join(r, f))
                          for r, _, fs in os.walk(d) for f in fs)
        snapshot = train._map(torch.clone, state)
        _, _, loss_a, _ = step(state["params"], state["opt_state"], batch)
        t0 = time.perf_counter()
        _, restored = ck.restore_train_state(d, train._map(torch.empty_like, snapshot))
        restore_s = time.perf_counter() - t0
    paths, rl = train._flatten(restored)
    for path, r, s in zip(paths, rl, train._flatten(snapshot)[1], strict=True):
        if r.device != s.device or r.dtype != s.dtype or not torch.equal(r, s):
            raise SystemExit(f"[train] checkpoint round trip: leaf {'.'.join(path)} differs")
    _, _, loss_b, _ = step(restored["params"], restored["opt_state"], batch)
    worst = _tree_rel(restored, state, TOL_TRAIN["resume"], "resumed step, params")
    err = _rel(loss_b, loss_a)
    tlog(f"[train] checkpoint of the {n} + {n}-layer state on the card: {saved_bytes:,} B saved "
        f"in {save_s:.1f} s, restored in {restore_s:.1f} s, every leaf bit for bit on "
        f"{r.device} in {r.dtype}; the resumed step against the uninterrupted one: loss rel "
        f"{err:.3e} (bit for bit: {float(loss_b) == float(loss_a)}), params worst rel RMS "
        f"{worst:.3e} (tol {TOL_TRAIN['resume']:g})")
    if not err <= TOL_TRAIN["resume"]:
        raise SystemExit("[train] the resumed step's loss differs")
    metrics["checkpoint"] = {"bytes": saved_bytes, "save_s": save_s, "restore_s": restore_s,
                             "resume_loss_rel": err, "resume_param_rel_rms": worst}
    del state, snapshot, restored, both
    torch.cuda.empty_cache()
    launches = read_counts()
    check_counts("train", launches, need=(), idle=tuple(KERNELS))
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase: {metrics['phase_s']:.1f} s")
    return launches, metrics


# ---------------------------------------------------------------------------
# tp: tensor-parallel inference on two ranks that share the card
# ---------------------------------------------------------------------------

TP_FRAMES = 8  # the single stream's greedy frames (few, for the script's time)
TP_CHUNK = 4  # the serving cycle's chunk: two chunks, park / admit, one more
TP_SERVICE_TOKENS = 12
TP_TIMED_FRAMES = 8


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()

# The tp = 2 talker against the unsharded one, teacher-forced, bf16: each
# rank's o_proj and down_proj partial sums are bf16 products over half of K,
# each rounded to bf16 before the fp32 all-reduce, where the unsharded
# product rounds once (and the column-parallel products run other GEMM
# shapes); an element that lands on the other side of a rounding boundary
# moves by 2^-9 and the random-weight layers carry it on, as TOL_BATCH's
# note says of B = 8 against B = 1. In fp32 the two agree to ~7e-7 (the
# phase checks it). Derived from the first card run (1.755e-2 on the single
# stream; over the first runs 1.578-1.755e-2 single, 1.608-1.802e-2
# serving, NVIDIA H100 80GB HBM3, 700 W) and held at TOL_BATCH's value.
TOL_TP = TOL["bfloat16"]
# A free-running departure of a code-predictor code (codes 1-15, K2's
# W8A8 scores) counts as a near tie within TOL_W8A8 of the top score: K2
# rounds its activations to int8, so the talker's bf16 difference above
# moves its logits as TOL_W8A8's note says (departures measured on the
# card at 1.71e-2 and 3.36e-2 of the top score); code 0 keeps NEAR_TIE.
NEAR_TIE_CP = TOL_W8A8["bfloat16"]


def _tp_single(pl, plain: dict, sharded: dict, rank: int, out: dict) -> None:
    """generate() on every rank with the sharded tree (the counted run);
    the sharded raw frames against the unsharded ones, teacher-forced on
    the unsharded frames: talker logits rel RMS a step, and a departure of
    the free-running frames allowed at a near-tie of the unsharded run's
    own scores only (code 0 from the talker's scores, codes 1-15 from K2's
    logits of the unsharded state); then ms a frame of a decode chunk,
    sharded and (rank 0 alone) unsharded, with the all-reduces a frame."""
    import torch
    import torch.distributed as dist

    from qwen3_tts_tpu_torch.models import code_predictor as cp_mod
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.parallel import sharding as sh
    from qwen3_tts_tpu_torch.parallel.dryrun import greedy_scores

    cfg, cc = pl.config, pl.config.code_predictor_config
    spf = pl.speech_config.decoder_config.total_upsample
    pl.params = sharded
    codes = gen_mod.generate_codes
    made: list = []

    def keep(*args, **kwargs):  # generate()'s raw frames
        made.append(codes(*args, **kwargs))
        return made[-1]

    gen_mod.generate_codes = keep
    try:
        reset_counts()
        sh.Parallel.reduces = 0
        _sync()
        t0 = time.perf_counter()
        audio = pl.generate(TEXT, "aiden", temperature=0.0, max_tokens=TP_FRAMES, seed=0)
        _sync()
        gen_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        gen_mod.generate_codes = codes
    reduces = sh.Parallel.reduces
    pd = pl._assemble(TEXT, "aiden")
    (raw,) = made
    kept = len(gen_mod.filter_valid_frames(raw))
    ok = bool(np.isfinite(audio).all()) and len(audio) == kept * spf and kept > 0
    out["single"] = {"generate_s": gen_s, "launches": launches, "reduces": reduces,
                     "frames": len(raw), "kept": kept, "audio_ok": ok}
    if rank == 0:
        log(f"[tp] generate on the tp = 2 tree (every rank): {len(raw)} frames, {kept} valid, "
            f"{len(audio)} samples, finite {bool(np.isfinite(audio).all())}, {gen_s:.2f} s; "
            f"{reduces} all-reduces; kernel launches on rank 0: {launches}")
    if not ok:
        raise SystemExit(f"[tp] rank {rank}: generate() on the sharded tree is wrong")

    # the unsharded frames from rank 0, padded to TP_FRAMES rows (-1) after
    # a row holding their count, so every rank forces the same frames
    buf = torch.full((TP_FRAMES + 1, cc.num_code_groups), -1, dtype=torch.int64)
    if rank == 0:
        plain_raw = gen_mod.generate_codes(plain, pl.cp_params, cfg, pd, temperature=0.0,
                                           max_tokens=TP_FRAMES)
        buf[0, 0] = len(plain_raw)
        buf[1:1 + len(plain_raw)] = torch.from_numpy(plain_raw).long()
    dist.broadcast(buf, 0)
    plain_raw = buf[1:1 + int(buf[0, 0])]
    raw_t = torch.from_numpy(raw).long()
    n = min(len(raw_t), len(plain_raw))
    diff = (raw_t[:n] != plain_raw[:n]).any(1).nonzero()
    same = not len(diff) and len(raw_t) == len(plain_raw)
    depart = int(diff[0]) if len(diff) else n  # n: one run stopped (EOS) before the other

    def code(frames, i, k):  # the code a run took at step i (EOS once it stopped)
        return int(frames[i, k]) if i < len(frames) else cfg.codec_eos_token_id

    forced = plain_raw.to(pl.device)
    kw = dict(temperature=0.0, generator=None, track_cp_penalty=True)
    ss = gen_mod.prefill(sharded, pd, cfg)
    sp = gen_mod.prefill(plain, pd, cfg) if rank == 0 else None
    errs, tie = [], None
    for i in range(len(forced) + 1):
        if rank == 0:
            errs.append(rel_rms(ss["logits"], sp["logits"]))
            if i == depart and not same:  # the unsharded state's own scores there
                # the first code that departs, in the frame's order (each
                # code-predictor group reads the codes before it)
                g = next(k for k in range(cc.num_code_groups)
                         if code(plain_raw, i, k) != code(raw_t, i, k))
                a, w = code(plain_raw, i, g), code(raw_t, i, g)
                if g == 0:
                    dep = _tie_gap(greedy_scores(sp, cfg, "total_text"), 0, a, w)
                    dep["limit"] = NEAR_TIE
                else:  # K2's logits of the unsharded state, its own codes before g
                    f = forced[i]
                    lg: list = []
                    cp_mod.predict_frame(
                        pl.cp_params, sp["h_last"], talker_mod.encode_audio(plain, f[:1][None]),
                        None, 0.0, sp["seen_cp"].clone(), cc, forced_codes=f[1:], logits_out=lg)
                    score = lg[g - 1].float() / torch.where(sp["seen_cp"][g - 1], 1.05, 1.0)
                    dep = _tie_gap(score, g, a, w)
                    dep["limit"] = NEAR_TIE_CP
                tie = dep["gap"] <= dep["limit"]
                out["single"]["departure_code"] = dep
        if i == len(forced):
            break
        gen_mod.decode_step(sharded, pl.cp_params, ss, cfg, forced_frame=forced[i], **kw)
        if rank == 0:
            gen_mod.decode_step(plain, pl.cp_params, sp, cfg, forced_frame=forced[i], **kw)
    if rank == 0:
        out["single"].update(tf_worst=max(errs), tf_mean=float(np.mean(errs)),
                             tf_prefill=errs[0], frames_equal=same,
                             departure=None if same else depart, near_tie=tie)
        log(f"[tp] single stream teacher-forced on the unsharded {len(forced)} frames: talker "
            f"logits rel RMS max {max(errs):.3e} mean {float(np.mean(errs)):.3e}, after the "
            f"prefill {errs[0]:.3e} (tol {TOL_TP:g}); free-running frames "
            + ("equal" if same else f"depart at frame {depart}, first at "
               f"{out['single'].get('departure_code')} (the two codes' gap in the unsharded "
               f"scores over the top score, its limit), a near tie: {tie}"))
        if not max(errs) <= TOL_TP or not (same or tie):
            raise SystemExit("[tp] the sharded single stream disagrees with the unsharded one")

    # ms a frame, sharded (both ranks) and unsharded (rank 0 alone)
    def chunk_ms(tree):
        """(ms a frame of a timed decode chunk, all-reduces a frame)"""
        st = gen_mod.prefill(tree, pd, cfg)
        gen_mod.decode_chunk(tree, pl.cp_params, st, cfg, steps=2, **kw)
        _sync()
        sh.Parallel.reduces = 0
        t0 = time.perf_counter()
        gen_mod.decode_chunk(tree, pl.cp_params, st, cfg, steps=TP_TIMED_FRAMES, **kw)
        _sync()
        return ((time.perf_counter() - t0) * 1e3 / TP_TIMED_FRAMES,
                sh.Parallel.reduces / TP_TIMED_FRAMES)

    out["single"]["ms_frame_tp"], out["single"]["reduces_frame"] = chunk_ms(sharded)
    dist.barrier()
    if rank == 0:
        out["single"]["ms_frame_plain"] = chunk_ms(plain)[0]
        log(f"[tp] single stream decode chunk: {out['single']['ms_frame_tp']:.2f} ms a frame at "
            f"tp = 2 (two ranks on one card, gloo), {out['single']['reduces_frame']:.0f} "
            f"all-reduces a frame; unsharded {out['single']['ms_frame_plain']:.2f} ms a frame "
            f"(rank 0 alone) ({out['card']}, {out['dtype']})")
    dist.barrier()


def _tie_gap(scores, k: int, a: int, w: int) -> dict:
    """Code k's departure: the unsharded pick a, the sharded w and their
    score gap over the largest finite score (_near_tie's measure)."""
    import torch

    top = float(scores[torch.isfinite(scores)].abs().max())
    gap = float((scores[a] - scores[w]).abs()) / top if bool(torch.isfinite(scores[w])) \
        else float("inf")
    return {"code": k, "unsharded": a, "sharded": w, "gap": gap}


def _tp_fp32(pl, plain: dict, mesh, rank: int, out: dict) -> None:
    """The same weights in fp32 (TF32 off): the prefill's logits of the
    tp = 2 tree against the unsharded tree's, where only the sum order
    differs, so the bf16 gap is rounding, not the split."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import prompt as prompt_mod
    from qwen3_tts_tpu_torch.parallel import sharding as sh
    from qwen3_tts_tpu_torch.parallel.train import _map

    cfg = pl.config
    t32 = _map(lambda x: x.float(), plain)
    s32 = sh.shard_params(t32, mesh, config=cfg)
    pd = prompt_mod.assemble_prompt(t32, cfg, pl.tokenizer, TEXT, speaker="aiden")
    got = gen_mod.prefill(s32, pd, cfg)["logits"]
    if rank == 0:
        err = rel_rms(got, gen_mod.prefill(t32, pd, cfg)["logits"])
        out["fp32_prefill_rel"] = err
        log(f"[tp] the same weights in fp32: prefill logits at tp = 2 against unsharded rel "
            f"RMS {err:.3e} (tol {TOL['float32']:g}: the sum order only)")
        if not err <= TOL["float32"]:
            raise SystemExit("[tp] the fp32 tp = 2 prefill disagrees with the unsharded one")
    del t32, s32
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _tp_serving(pl, plain: dict, sharded: dict, rank: int, out: dict) -> None:
    """The serving cycle at B = 8 (two chunks, park_slot(0), a B = 1 prefill
    admitted into slot 0, one more chunk): free-running on the sharded tree
    (decode_chunk_serving, eager), the unsharded eager step on rank 0, and
    the sharded step teacher-forced on the unsharded frames: talker logits
    rel RMS a step over the rows that emitted, code-0 departures only at a
    near-tie of the unsharded scores. Then the eager B = 8 step's ms,
    sharded and unsharded (rank 0 alone)."""
    import torch
    import torch.distributed as dist

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import serving as srv
    from qwen3_tts_tpu_torch.parallel import sharding as sh
    from qwen3_tts_tpu_torch.parallel.dryrun import greedy_scores

    cfg = pl.config
    statics = gen_mod.GenStatics(config=cfg, capacity=64 + gen_mod.RING_SLACK,
                                 chunk_steps=TP_CHUNK, track_cp_penalty=False)
    dev = pl.device
    cp = srv._drop_kernel(pl.cp_params)
    b = len(SERVE_TEXTS)
    zeros = torch.zeros(b, device=dev)

    tb = gen_mod.pick_bucket(max(pl._assemble(t, "aiden").trailing_hidden.shape[1]
                                 for t in (*SERVE_TEXTS, LATE_TEXTS[0])),
                             gen_mod.TRAILING_BUCKETS)

    def state(tree, texts, seeds):
        pds = [pl._assemble(t, "aiden") for t in texts]
        e, tr, lengths, totals = srv._pad_prompts(pds, 64, tb)
        return srv.prefill_batched(tree, e, lengths, tr, totals, pds[0].tts_pad_embed,
                                   srv._device_ints(seeds, dev), statics)

    def cycle(tree, step):
        """The cycle's 3 chunks; step(st, i) runs step i; returns the state."""
        st, i = state(tree, SERVE_TEXTS, range(b)), 0
        for c in range(3):
            if c == 2:
                srv.park_slot(st, 0)
                srv.admit_stream(st, 0, state(tree, LATE_TEXTS[:1], [99]), statics)
            for _ in range(TP_CHUNK):
                st = step(st, i) or st
                i += 1
        return st

    t0 = time.perf_counter()
    got = []

    def free_chunked(st, i):
        if i % TP_CHUNK == 0:
            frames, _, _, st = srv.decode_chunk_serving(sharded, pl.cp_params, st, 0.0, statics)
            got.append(frames.cpu())
        return st

    cycle(sharded, free_chunked)
    _sync()
    free_s = time.perf_counter() - t0
    sh_frames = torch.cat(got, 1)  # [B, 18, 16]
    steps = sh_frames.shape[1]
    ref = torch.zeros_like(sh_frames)
    logits_ref, scores_ref = [], []
    if rank == 0:
        def plain_step(st, i):
            scores_ref.append(greedy_scores(st, cfg, "total_texts"))
            srv.lockstep_step(plain, cp, st, zeros, statics, False)
            ref[:, i] = st["frame"].cpu()
            logits_ref.append(st["logits"].clone())

        cycle(plain, plain_step)
    dist.broadcast(ref, 0)
    forced = ref.to(dev)
    errs = []

    def forced_step(st, i):
        srv.lockstep_step(sharded, cp, st, zeros, statics, False,
                          forced=forced[:, i].clamp_min(0))
        if rank == 0:
            rows = forced[:, i, 0] >= 0
            if rows.any():
                errs.append(rel_rms(st["logits"][rows], logits_ref[i][rows]))

    cycle(sharded, forced_step)
    if rank == 0:
        ties, off, cp_off = 0, [], 0
        for j in range(b):
            d = (sh_frames[j] != ref[j]).any(1).nonzero()
            if not len(d):
                continue
            i = int(d[0])
            a, w = int(ref[j, i, 0]), int(sh_frames[j, i, 0])
            if a == w:
                cp_off += 1  # a code-predictor code departs (its scores: not kept)
            elif a >= 0 and w >= 0 and _near_tie(scores_ref[i][j], a, w):
                ties += 1
            else:
                off.append((j, i, w, a))
        worst = max(errs)
        out["serving"] = {"free_s": free_s, "steps": steps, "tf_worst": worst,
                          "tf_mean": float(np.mean(errs)),
                          "rows_equal": b - ties - cp_off - len(off),
                          "code0_near_ties": ties, "cp_departures": cp_off}
        log(f"[tp] serving cycle B = {b} ({steps} steps: 2 chunks of {TP_CHUNK}, park_slot, "
            f"admit_stream, a chunk), eager, sharded free run {free_s:.2f} s; teacher-forced on "
            f"the unsharded eager step's frames: talker logits rel RMS max {worst:.3e} mean "
            f"{float(np.mean(errs)):.3e} (tol {TOL_TP:g}); rows equal to the unsharded run "
            f"{out['serving']['rows_equal']} of {b}, code-0 departures at a near tie {ties}, "
            f"code-predictor departures {cp_off}, others {off}")
        if not worst <= TOL_TP or off:
            raise SystemExit("[tp] the sharded serving cycle disagrees with the unsharded one")

    def step_ms(tree, n=3):
        """(ms of an eager step, all-reduces a step)"""
        st = state(tree, SERVE_TEXTS, range(b))
        srv.lockstep_step(tree, cp, st, zeros, statics, False)
        _sync()
        sh.Parallel.reduces = 0
        t0 = time.perf_counter()
        for _ in range(n):
            srv.lockstep_step(tree, cp, st, zeros, statics, False)
        _sync()
        return (time.perf_counter() - t0) * 1e3 / n, sh.Parallel.reduces / n

    ms_tp, reduces = step_ms(sharded)
    dist.barrier()
    if rank == 0:
        ms_plain = step_ms(plain)[0]
        out["serving"].update(step_ms_tp=ms_tp, step_ms_plain=ms_plain, reduces_step=reduces)
        log(f"[tp] eager lockstep step B = {b}: {ms_tp:.1f} ms at tp = 2 ({reduces:.0f} "
            f"all-reduces a step), unsharded {ms_plain:.1f} ms (rank 0 alone) "
            f"({out['card']}, {out['dtype']})")
    dist.barrier()


def _tp_vocode(pl, mesh, rank: int, out: dict) -> None:
    """decode_frames of codes [8, 16, 110] placed on "dp" (4 rows a rank)
    against the unsharded decode of all 8 rows (rank 0)."""
    import torch

    from qwen3_tts_tpu_torch.models import vocoder as voc
    from qwen3_tts_tpu_torch.parallel import sharding as sh

    dec = pl.speech_config.decoder_config
    codes = torch.from_numpy(np.random.default_rng(5).integers(
        0, dec.codebook_size, (8, dec.num_quantizers, 110)))
    placed = sh._place(codes.to(pl.device), mesh, ("dp", None, None))
    before = read_counts()
    _sync()
    t0 = time.perf_counter()
    wav = voc.decode_frames(pl.vocoder_params, placed, dec)
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v - before[k] for k, v in read_counts().items()}
    full = sh.gather_rows(wav)
    if rank == 0:
        ref = voc.decode_frames(pl.vocoder_params, codes.to(pl.device), dec).cpu()
        err, mad = rel_rms(full, ref), float((full - ref).abs().max())
        out["vocode"] = {"rows_a_rank": wav.to_local().shape[0], "rel_rms": err,
                         "max_abs": mad, "ms": ms, "launches": launches}
        log(f"[tp] dp vocode on a (dp = 2, tp = 1) mesh: codes {tuple(codes.shape)}, "
            f"{wav.to_local().shape[0]} rows a rank, {ms:.1f} ms on rank 0; gathered on the "
            f"host against the unsharded decode of all 8 rows: rel RMS {err:.3e}, max abs "
            f"{mad:.3e} (tol {TOL_VOCODER_BF16:g}); launches on rank 0: {launches}")
        if not err <= TOL_VOCODER_BF16:
            raise SystemExit("[tp] the dp-sharded vocode disagrees with the unsharded one")


def _tp_service(pl, plain: dict, sharded: dict, rank: int, out: dict) -> None:
    """TTSService on the tp = 2 tree (rank 0 serves, rank 1 follows): a
    burst of 3 requests, then one arrival into the running batch, B = 8,
    TP_SERVICE_TOKENS frames each, greedy; then rank 0 alone runs the same
    traffic through an unsharded service. Per request: token ranges and
    audio length (equal where every frame agrees), and the audio's rel RMS
    over the leading frames that agree (TOL_VOCODER_BF16: the vocoder's
    rows batched otherwise)."""
    import torch.distributed as dist

    from qwen3_tts_tpu_torch.models import serving as srv
    from qwen3_tts_tpu_torch.service import TTSService

    kw = dict(batch_size=8, chunk_steps=6)
    if rank != 0:
        pl.params = sharded
        TTSService.follow(pl, **kw)
        dist.barrier()
        return

    def serve(tree):
        pl.params = tree
        frames: dict = {}
        feed = srv._RowPacker.feed

        def keep(self, key, valid, done):  # each request's frames as routed
            frames.setdefault(id(key), []).append(np.asarray(valid))
            return feed(self, key, valid, done)

        srv._RowPacker.feed = keep
        svc = TTSService(pl, **kw)
        try:
            t0 = time.perf_counter()
            opts = dict(temperature=0.0, max_tokens=TP_SERVICE_TOKENS)
            burst: list = []
            for i, text in enumerate(SERVICE_TEXTS[:3]):
                svc.submit(text, "aiden", seed=i, _hold=burst, **opts)
            svc._enqueue(burst)
            streams = [r.chunks() for r in burst]
            heads = [[next(streams[0])]] + [[] for _ in burst[1:]]
            late = svc.submit(LATE_TEXTS[0], "aiden", seed=3, **opts)
            reqs = burst + [late]
            res = []
            for r, h, s in zip(reqs, heads + [[]], streams + [late.chunks()]):
                chunks = h + list(s)
                parts = [c.samples for c in chunks if len(c.samples)]
                res.append((np.concatenate(parts) if parts else np.zeros(0, np.float32),
                            [c.token_range for c in chunks],
                            np.concatenate(frames.get(id(r), [np.zeros((0, 16))]))))
            wall = time.perf_counter() - t0
            stats = svc.stats()
        finally:
            svc.close()
            srv._RowPacker.feed = feed
        return res, wall, stats

    got, wall, stats = serve(sharded)
    ref, ref_wall, _ = serve(plain)
    pl.params = plain
    spf = pl.speech_config.decoder_config.total_upsample
    rows = []
    for i, ((a, r, f), (ja, jr, jf)) in enumerate(zip(got, ref)):
        n = min(len(f), len(jf))
        agree = int(np.argmin(np.r_[(f[:n] == jf[:n]).all(1), False]))  # leading frames equal
        same = agree == len(f) == len(jf)
        m = min(agree * spf, len(a), len(ja))  # their samples (the vocoder is causal)
        rows.append({"ranges_equal": r == jr, "len": len(a), "len_ref": len(ja),
                     "frames_equal": same, "frames_agree": agree,
                     "audio_rel_rms": rel_rms_np(a[:m], ja[:m]) if m else None})
    out["service"] = {"requests": rows, "wall_s": wall, "wall_s_plain": ref_wall,
                      "completed": stats["requests_completed"]}
    log(f"[tp] TTSService at tp = 2 (rank 0 serves, rank 1 follows), B = 8: a burst of 3 then "
        f"one arrival into the running batch, {TP_SERVICE_TOKENS} frames each, greedy: "
        f"{wall:.2f} s (unsharded service {ref_wall:.2f} s); per request against the unsharded "
        f"service: {rows}")
    bad = [x for x in rows if x["len"] == 0
           or (x["frames_equal"] and not (x["ranges_equal"] and x["len"] == x["len_ref"]))
           or (x["audio_rel_rms"] is not None and not x["audio_rel_rms"] <= TOL_VOCODER_BF16)]
    if bad or stats["requests_completed"] != 4:
        raise SystemExit(f"[tp] the sharded service disagrees with the unsharded one: {bad}")
    dist.barrier()


def rel_rms_np(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))


def _tp_nccl_one(pl, plain: dict, root: str, out: dict) -> None:
    """A one-process NCCL (dp = 1, tp = 1) mesh through the sharded code: a
    prefill and 8 frames equal to the unsharded (unfused) tree's, the
    logits within TOL_TP."""
    import torch
    import torch.distributed as dist

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.parallel import sharding as sh

    cfg = pl.config
    pd = pl._assemble(TEXT, "aiden")
    kw = dict(temperature=0.0, generator=None, track_cp_penalty=True)
    sh.init_process_group(pl.device, 0, 1, f"file://{root}/nccl_rendezvous", timeout_s=120)
    try:
        mesh = sh.make_mesh(1, tp=1)
        placed = sh.shard_params(plain, mesh, config=cfg)
        backend = dist.get_backend()
        res = []
        for tree in (placed, sh.unfuse_qkv_gateup(plain, cfg)):
            st = gen_mod.prefill(tree, pd, cfg)
            logits0 = st["logits"].clone()
            frames, count, _ = gen_mod.decode_chunk(tree, pl.cp_params, st, cfg, steps=8, **kw)
            res.append((logits0, frames, int(count), st["logits"]))
    finally:
        dist.destroy_process_group()
    (l0, f0, c0, e0), (l1, f1, c1, e1) = res
    same = torch.equal(f0, f1) and c0 == c1
    bitwise = torch.equal(l0, l1) and torch.equal(e0, e1)
    out["nccl_tp1"] = {"backend": backend, "frames_equal": same, "bitwise": bitwise,
                       "logits_rel": max(rel_rms(l0, l1), rel_rms(e0, e1))}
    err = max(rel_rms(l0, l1), rel_rms(e0, e1))
    log(f"[tp] one-process {backend} mesh (dp = 1, tp = 1), the sharded code: prefill + 8 "
        f"frames {'equal' if same else 'DIFFER'} to the unsharded tree's, logits "
        + ("bit for bit" if bitwise else f"rel RMS {err:.3e} (tol {TOL_TP:g}: the "
           "row-parallel products in fp32, rounded once, against bf16 GEMMs)"))
    if not same or not err <= TOL_TP:
        raise SystemExit("[tp] the one-process NCCL mesh differs from the unsharded run")


def _tp_worker(rank: int, world: int, d: str, root: str, card: str, backend: str,
               device: str = "cuda") -> None:
    """One rank of phase_tp: the dense bf16 pipeline from `d`, its talker
    placed on a (dp = 1, tp = world) mesh over `backend`; with gloo (two
    ranks on one card) every step, with nccl (a card a rank) the single
    stream only. Rank 0 writes its results to root/tp.json, every rank its
    launches to root/launches<rank>.json. device="cpu" rehearses the steps
    at a tiny width on the CPU in fp32 (the one-process mesh then over
    gloo)."""
    import json as _json
    import os

    import torch
    import torch.distributed as dist

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.parallel import sharding as sh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)  # two ranks and the parent share the host's cores
    sh.init_process_group(device, rank, world, f"file://{root}/rendezvous", timeout_s=300,
                          backend=backend)
    out = {"card": card, "dtype": "bfloat16" if device == "cuda" else "float32"}
    try:
        t0 = time.perf_counter()
        dense = qt.Qwen3TTSPipelineConfiguration(apply_runtime_quantization=False,
                                                 use_talker_megakernel=False)
        pl = qt.Qwen3TTSPipeline(d, dense, device=device, dtype=getattr(torch, out["dtype"]))
        plain, cfg = pl.params, pl.config
        mesh = sh.make_mesh(world, tp=world)
        sharded = sh.shard_params(plain, mesh, config=cfg)
        lay = sh.local_params(sharded)[1]["layers"]
        heads = (lay["qkv_proj"]["q"]["w"].shape[1] // cfg.head_dim,
                 lay["qkv_proj"]["k"]["w"].shape[1] // cfg.head_dim,
                 lay["gateup_proj"]["gate"]["w"].shape[1])
        out.update(load_s=time.perf_counter() - t0, backend=dist.get_backend(),
                   local_heads=heads, kernel_in_cp="kernel" in pl.cp_params,
                   kernel_in_talker="kernel" in plain)
        if rank == 0:
            log(f"[tp] {world} ranks on {torch.cuda.device_count()} card(s), backend "
                f"{dist.get_backend()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; "
                f"dense {out['dtype']} model loaded in {out['load_s']:.1f} s; rank 0 holds "
                f"{heads[0]} q / {heads[1]} kv heads and {heads[2]} MLP columns; K2's tree "
                f"{'present' if out['kernel_in_cp'] else 'ABSENT'}, K1's "
                f"{'present' if out['kernel_in_talker'] else 'absent'}")
        _tp_fp32(pl, plain, mesh, rank, out)
        _tp_single(pl, plain, sharded, rank, out)
        if backend == "gloo":
            _tp_serving(pl, plain, sharded, rank, out)
            _tp_vocode(pl, sh.make_mesh(world, tp=1), rank, out)
            _tp_service(pl, plain, sharded, rank, out)
        with open(os.path.join(root, f"launches{rank}.json"), "w") as f:
            _json.dump(out["single"]["launches"], f)
    finally:
        dist.destroy_process_group()
    if rank == 0 and backend == "gloo":
        _tp_nccl_one(pl, plain, root, out)
    if rank == 0:
        with open(os.path.join(root, "tp.json"), "w") as f:
            _json.dump(out, f)


def phase_tp(card: str, d: str) -> tuple[dict, dict]:
    """Tensor-parallel inference at 0.6B, full width and depth, on the
    model dir `d` (random weights from seed 0) in the dense bf16
    configuration (no runtime quantization, K1 off; K2 on for the single
    stream, K4-K6 in the vocoder): two spawned ranks share the card over
    gloo at tp = 2 (_tp_worker): generate() on every rank, teacher-forced
    against the unsharded run; the serving cycle at B = 8, eager; a dp
    vocode of [8, 16, 110]; TTSService with rank 0 serving and rank 1
    following; ms a frame and a step, sharded and unsharded; then a
    one-process NCCL tp = 1 mesh against the unsharded run. NCCL tp = 2 across cards when the
    machine has two or more. Returns (rank 0's launch counts over the
    sharded generate(), metrics)."""
    import json as _json
    import os

    import torch

    from qwen3_tts_tpu_torch.parallel.dryrun import spawn_group

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        spawn_group(_tp_worker, (2, d, root, card, "gloo"), 2, 900.0, "[tp] gloo tp = 2")
        with open(os.path.join(root, "tp.json")) as f:
            metrics = _json.load(f)
        launches = [_json.load(open(os.path.join(root, f"launches{r}.json"))) for r in (0, 1)]
    for r, got in enumerate(launches):
        check_counts(f"tp rank {r}", got, need=("cp_frame", "pre_transformer", "upsample_stage",
                                                "residual_units", "block_upsample"),
                     idle=("talker_step", "int8_matmul", "packed_matmul", "gumbel_sample",
                           "pre_transformer_fused"))
        if got["cp_frame"] != TP_FRAMES:  # generate() decodes one chunk of TP_FRAMES steps
            raise SystemExit(f"[tp] rank {r}: K2 launched {got['cp_frame']} times for "
                             f"{TP_FRAMES} steps")
    log(f"[tp] K2 once a frame on each rank ({launches[0]['cp_frame']} and "
        f"{launches[1]['cp_frame']} for a chunk of {TP_FRAMES} steps)")
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as root:
            spawn_group(_tp_worker, (2, d, root, card, "nccl"), 2, 600.0, "[tp] nccl tp = 2")
            with open(os.path.join(root, "tp.json")) as f:
                metrics["nccl_tp2"] = _json.load(f)["single"]
    else:
        log("[tp] NCCL tp = 2 across cards: not run, the machine has one card")
        metrics["nccl_tp2"] = "not run: one card"
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase: {metrics['phase_s']:.1f} s")
    return launches[0], metrics


# ---- the 1.7B phase ----

# (name, K, O) of the 1.7B linears that K3 and K7 are held at: the talker's
# four layer GEMVs and codec head; the text projection's fc1 and fc2 are
# both 2,048 -> 2,048, o's shape (the code predictor's are 0.6B's)
LINEARS_1_7B = (("qkv", 2048, 4096), ("o / fc1 / fc2", 2048, 2048),
                ("gate/up", 2048, 12288), ("down", 6144, 2048), ("codec head", 2048, 3072))
# the GEMV at M <= M0 (16), the tile at 114; M = 8 is a lockstep step's at
# B = 8 in the K3 and mixed configurations
ROWS_1_7B = (1, 3, 8, 9, 16, 114)
# small_to_mtp_projection (K3 or K7 on the lockstep steps, K7 at 4 bits in
# the mixed and pre-quantized trees) at a frame's or a step's M: 2 then 1
# in a single stream's frame, 2B then B in a step at B = 8 and 16
PROJECTION_1_7B = (("projection", 2048, 1024), (1, 2, 8, 16, 32))
# M0's sweep at 1.7B: the serving step's shapes and the text projection's
M0_SHAPES_1_7B = (("qkv", 2048, 4096), ("o", 2048, 2048), ("gate/up", 2048, 12288),
                  ("down", 6144, 2048), ("codec head", 2048, 3072),
                  ("cp lm head", 1024, 2048), ("fc1", 2048, 2048), ("fc2", 2048, 2048))
# a B = 32 lockstep step's 1.7B shapes (qmm_b32 at M = 32 and 64): the
# talker's linears and small_to_mtp_projection, K7 at 4 and 6 bits each
# (the code predictor's linears are STEP_LINEARS' 0.6B widths)
STEP_LINEARS_1_7B = (("qkv", 2048, 4096, (4, 6)), ("o", 2048, 2048, (4, 6)),
                     ("gate/up", 2048, 12288, (4, 6)), ("down", 6144, 2048, (4, 6)),
                     ("codec head", 2048, 3072, (4, 6)), ("projection", 2048, 1024, (4, 6)))
FRAMES_1_7B = 320  # past the 192-slot window's trims and the ring's wrap
# teacher forcing at 1.7B: the kernels alone to frame 216, then both over
# frames 216-231, which hold the window's trim at step 225 and, with the
# 9-row prompt, the ring's wrap at step 224 (16 frames: the plain K1 / K2
# steps cost ~0.3 s a frame)
TF_1_7B = (216, 232)


def qmm_1_7b(rec: Record, gen, dev) -> None:
    """K3 (int8) and K7 (4 and 6 bits), group 64, at the 1.7B linears
    (LINEARS_1_7B) and M in ROWS_1_7B, and K3 and K7 4-bit at the projection
    (PROJECTION_1_7B): fp32 and bf16 x against their plain versions, each
    call one launch of the path M0 gives it and two calls bit-identical;
    every bf16 call timed warm (a graph of one call) with its bound, and at
    M <= 16 (the projection at every M) cold (cold_ms); K7's 4-bit calls
    beside torch._weight_int4pack_mm on the same weights (int4pack_library).
    Every bf16 call counts in the kernel's 1.7B row; K7's at the projection
    and at M = 8 are also listed in it ("shapes")."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    shapes_k7 = rec.rows["packed_matmul"].setdefault("shapes", [])
    for bits in (None, 4, 6):  # None: K3
        name, mod = ("int8_matmul", qm) if bits is None else ("packed_matmul", pm)
        kern = "K3" if bits is None else f"K7 {bits}-bit"
        shapes = [(shape, ROWS_1_7B) for shape in LINEARS_1_7B]
        if bits != 6:
            shapes.append(PROJECTION_1_7B)
        for (label, k, o), rows in shapes:
            weights = qmm_weights(gen, dev, bits, k, o)
            copies = cold_copies(*weights)

            def call(x, w=weights, bits=bits):
                if bits is None:
                    return qm.int8_matmul_kernel(x, *w)
                return pm.packed_matmul_kernel(x, *w, bits, 64)

            def plain(x, w=weights, bits=bits):
                if bits is None:
                    return qm.int8_matmul_plain(x, *w)
                return pm.packed_matmul_plain(x, *w, bits, 64)

            for dtype in ("float32", "bfloat16"):
                for m in rows:
                    x = torch.randn(m, k, generator=gen, device=dev).to(getattr(torch, dtype))
                    tag = f"{kern} {label} M={m} K={k} O={o}"
                    before = mod.launches
                    got = call(x)
                    if mod.launches != before + 1:
                        raise SystemExit(f"[1.7b] {tag} {dtype}: not one launch")
                    nb, ops = nbytes(x, *weights, got), {dtype: 2 * m * k * o}
                    warm = graph_ms(lambda: call(x))
                    rec.compare(name, tag, dtype, got, plain(x), (warm, "graph"),
                                time_ms(lambda: plain(x), 10 if m <= 16 else 5), nb, ops)
                    same_bits(name, f"{tag} {dtype}", got, lambda: call(x))
                    if dtype != "bfloat16":
                        continue
                    cold = lib = None
                    if m <= 16 or rows is PROJECTION_1_7B[1]:
                        cold = cold_ms([lambda c=c: call(x, c) for c in copies])
                        cold_row(rec, name, (kern, k, o, m), m <= mod.M0, warm, cold, nb, ops,
                                 len(copies))
                    if bits == 4:
                        lib = int4pack_library(rec, x, *weights, got, warm,
                                               copies if cold is not None else None, cold)
                    if bits is not None and (m == 8 or rows is PROJECTION_1_7B[1]):
                        shapes_k7.append({"shape": tag, "warm_ms": warm, "cold_ms": cold,
                                          "bound_ms": bound(nb, ops)[0],
                                          "library_ms": lib and lib[0],
                                          "library_cold_ms": lib and lib[1]})
            del copies, weights
            torch.cuda.empty_cache()


@contextlib.contextmanager
def decoded_frames(gen_mod):
    """Counts generate.decode_step's calls, one a decoded frame, and K3's
    and K7's launches inside them: yields {"frames", "int8_matmul",
    "packed_matmul"}."""
    out = {"frames": 0, **{name: 0 for name in QMM_FNS}}
    step = gen_mod.decode_step

    def counting_step(*args, **kwargs):
        before = read_counts()
        try:
            return step(*args, **kwargs)
        finally:
            out["frames"] += 1
            after = read_counts()
            for name in QMM_FNS:
                out[name] += after[name] - before[name]

    gen_mod.decode_step = counting_step
    try:
        yield out
    finally:
        gen_mod.decode_step = step


def phase_1_7b(card: str, floors: tuple[float, float], d: str, write_s: float):
    """The 1.7B model (Qwen3TTSConfig.standard_1_7b(): talker hidden 2048,
    intermediate 6144, the 1024-wide code predictor behind
    small_to_mtp_projection), random weights from seed 0 in bf16, full
    depth: the pipeline on the default (megakernel) configuration decodes
    FRAMES_1_7B frames through generate() and generate_stream() (counts set
    to 0 just before and read just after: K1 and K2 once a frame, K3 in the
    text projection, K4-K6 and the blocks' upsample in the vocoder; K7 and
    K2g's kernel idle); K3 at the text projection's shapes; K1 on the
    pipeline's tree against its plain version (C = 260, window starts 99
    and 297, fp32 and bf16) and K2 with the projection (temperature 0.85
    with and without the penalty, and 0); the two launches' plans, two
    runs bit-identical; the frame loop teacher-forced
    across the window's trims and the ring's wrap (TF_1_7B); a profile of
    8 frames; K3 and K7 at the 1.7B linears (qmm_1_7b; at a B = 32 step's
    M, qmm_b32 over STEP_LINEARS_1_7B, into rec.b32) and M0's sweep over
    the 1.7B shapes, logged beside the wrappers' M0. `floors`: the empty
    launch's cold floor (plain, writing), from the kernels phase; `d`: the
    1.7B model dir (written from seed 0 by DirWriter in `write_s` seconds),
    which the serving-1.7b phase reads again. Returns (launch counts,
    metrics, the 1.7B Record, the swept M0s, the loaded pipeline, which the
    serving-1.7b phase serves)."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    t_phase = time.perf_counter()
    rec = Record("1.7b")
    for name in ("int8_matmul", "packed_matmul"):
        rec.rows[name]["floor_cold_ms"], rec.rows[name]["floor_store_cold_ms"] = floors
    cfg = qt.Qwen3TTSConfig.standard_1_7b()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    vocoder = ("pre_transformer", "upsample_stage", "residual_units", "block_upsample")
    log(f"[1.7b] a random-weight 1.7B model dir (hidden {cfg.hidden_size}, "
        f"intermediate {cfg.intermediate_size}, code predictor "
        f"{cfg.code_predictor_config.hidden_size} through small_to_mtp_projection), written in "
        f"{write_s:.1f} s")
    with decoded_frames(gen_mod) as steps:
        pl, launches, metrics = run_pipeline(
            card, d, "1.7b", None,
            need=("talker_step", "cp_frame", "int8_matmul") + vocoder,
            idle=("gumbel_sample", "packed_matmul"), frames=FRAMES_1_7B)
    metrics["write_s"] = write_s
    k1, k2 = launches["talker_step"], launches["cp_frame"]
    log(f"[1.7b] generate() and generate_stream() decoded {steps['frames']} frames (expect "
        f"{2 * FRAMES_1_7B}): K1 launched {k1} times, K2 {k2} ({card})")
    if not k1 == k2 == steps["frames"] == 2 * FRAMES_1_7B:
        raise SystemExit("[1.7b] K1 and K2 did not run once a frame over the decode")
    text_projection(pl, card, "1.7b", "K3")

    tkp, ckp = pl.params["kernel"], pl.cp_params["kernel"]
    k1_cases = {}
    for dtype in ("float32", "bfloat16"):
        for ws in (99, 297):
            k1_cases[dtype, ws] = talker_case(rec, tkp, cfg, gen, getattr(torch, dtype), ws,
                                              main=ws == 99, tag="1.7b")
    seed = torch.tensor([20240607], device=dev)
    k2_cases = {}
    for dtype in ("float32", "bfloat16"):
        inputs = cp_inputs(cfg, gen, getattr(torch, dtype))
        for temp, track in ((0.85, True), (0.85, False), (0.0, True)):
            k2_cases[dtype, temp, track] = cp_case(rec, ckp, cfg, inputs, seed, temp, track,
                                                   timed=(temp, track) == (0.85, True))
    # the profiler's one-kernel check is the megakernels phase's, on the
    # same launch code: this late in the script its windows lost every
    # K1 record (0 of 4 in five windows after the train phase)
    persistent_checks(card, cfg, tkp, ckp, seed, k1_cases["bfloat16", 99],
                      k2_cases["bfloat16", 0.85, True], tag="1.7b", one_kernel=False)
    tf = teacher_forced(pl, card, "1.7b", frames=TF_1_7B[1], start=TF_1_7B[0])
    if tf["window_start"][1] <= tf["window_start"][0] or tf["total_len"] <= tf["capacity"]:
        raise SystemExit("[1.7b] the teacher-forced frames reached no window trim or no "
                         "wrap of the ring")
    metrics["teacher_forced"] = tf
    metrics["profile"] = profile_frames(pl, "1.7b", card)
    del tkp, ckp
    torch.cuda.empty_cache()
    qmm_1_7b(rec, gen, dev)
    qmm_b32(rec, gen, dev, STEP_LINEARS_1_7B)
    swept = m0_sweep(gen, dev, M0_SHAPES_1_7B, tag="1.7b")
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"[1.7b] phase: {metrics['phase_s']:.1f} s ({card})")
    return launches, metrics, rec, swept, pl


MODE_FRAMES_1_7B = 96  # each 1.7B single-stream mode's frames, as the 0.6B modes'


def phase_modes_1_7b(pl, card: str) -> tuple[dict, dict, np.ndarray]:
    """Every generation mode at 1.7B on the 1.7b phase's pipeline and dir
    (default configuration, both encoders: the speaker encoder's enc_dim
    2048, read from its fc weight): every_mode's single streams of
    MODE_FRAMES_1_7B frames (VoiceDesign, CustomVoice, a streamed
    VoiceDesign with its first audio, the 2048-wide x-vector of a 5 s clip
    and generate with it, generate_icl), counts set to 0 before and read
    after: K1 and K2 once a decoded frame, K3 (the text projection, the
    instruct rows with it), K4-K6 and the blocks' upsample launched, K7 and
    K2g's kernel not; the x-vector against the same speaker encoder on
    the card's machine's CPU (fp32, rel RMS 1e-4). Returns (launch counts,
    metrics, the 5 s clip of its VoiceDesign audio: service-1.7b's burst
    clones it)."""
    import copy

    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    t_phase = time.perf_counter()
    label, m = "modes-1.7b", {}
    enc_dim = pl.speaker_encoder.config.enc_dim
    log(f"[{label}] the 1.7B dir's speaker encoder: enc_dim {enc_dim} (from fc.weight), the "
        f"talker's hidden {pl.config.hidden_size}")
    if enc_dim != pl.config.hidden_size or not pl.supports_icl:
        raise SystemExit(f"[{label}] the 1.7B encoders did not load at the talker's width")
    torch.cuda.synchronize()
    reset_counts()
    with decoded_frames(gen_mod) as steps:
        _, ref, emb, _ = every_mode(pl, card, label, m, MODE_FRAMES_1_7B)
    torch.cuda.synchronize()
    launches = read_counts()
    k1, k2 = launches["talker_step"], launches["cp_frame"]
    log(f"[{label}] {steps['frames']} frames decoded over the five runs: K1 {k1}, K2 {k2}, "
        f"K3 {launches['int8_matmul']} (text projections) ({card})")
    if not (k1 == k2 == steps["frames"] == 5 * MODE_FRAMES_1_7B):
        raise SystemExit(f"[{label}] K1 and K2 did not run once a frame")
    check_counts(label, launches, need=("talker_step", "cp_frame", "int8_matmul")
                 + SERVING_VOCODER, idle=("gumbel_sample", "packed_matmul",
                                          "pre_transformer_fused"))
    t0 = time.perf_counter()

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [to_cpu(v) for v in t]
        return t.cpu()

    cpu = copy.copy(pl.speaker_encoder)
    cpu.params, cpu.device = to_cpu(cpu.params), torch.device("cpu")
    m["xvector_vs_cpu"] = rel_rms(torch.from_numpy(emb),
                                  torch.from_numpy(cpu.extract_embedding(ref)))
    log(f"[{label}] the {emb.shape[0]}-wide x-vector on the card against the CPU (fp32): rel "
        f"RMS {m['xvector_vs_cpu']:.3e} (tol 1e-4) ({time.perf_counter() - t0:.1f} s)")
    if not m["xvector_vs_cpu"] <= 1e-4:
        raise SystemExit(f"[{label}] the 2048-wide speaker encoder disagrees with its CPU run")
    m["phase_s"] = time.perf_counter() - t_phase
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    return launches, m, ref


def fp32_twin(pl):
    """pl with every bf16 tensor of its talker and code-predictor trees
    widened to fp32 (int8 weights, fp32 scales and the kernel trees shared,
    not copied): the same bf16-valued weights, run with fp32 activations.
    BATCH_ROUNDING's checks compare against it."""
    import copy

    import torch

    def widen(t):
        if isinstance(t, dict):
            return {k: widen(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(widen(v) for v in t)
        return t.float() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 else t

    twin = copy.copy(pl)
    twin.params, twin.cp_params = widen(pl.params), widen(pl.cp_params)
    twin._dtype = torch.float32
    return twin


K3_1_7B_FRAMES = 4  # host-bound (RTF ~5), as mixed-1.7b's


def k3_configuration_1_7b(d: str, card: str, k3_per_frame_06: float, runs: dict,
                          m: dict) -> None:
    """serving-1.7b's K3 configuration, loaded from the 1.7B dir `d`:
    generate and generate_stream of K3_1_7B_FRAMES frames with K3's launches a decoded
    frame (k3_step_launches; 0.6B's beside it), serving_step at B = 32 (443
    K3 a step, all on the tile, counted by the tile's name in 5 replays)
    with the fp32 twin, its graph bit for bit the eager step. Fills runs /
    m["k3"] and ["k3_serving_b32"]."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    off = qt.Qwen3TTSPipelineConfiguration(use_talker_megakernel=False,
                                           use_cp_megakernel=False)
    vocoder = ("pre_transformer", "upsample_stage", "residual_units", "block_upsample")
    with decoded_frames(gen_mod) as steps:
        pk, runs["k3"], m["k3"] = run_pipeline(
            card, d, "k3-1.7b", off, need=("int8_matmul",) + vocoder,
            idle=("talker_step", "cp_frame", "gumbel_sample", "packed_matmul"),
            frames=K3_1_7B_FRAMES)
    per_frame = steps["int8_matmul"] / steps["frames"]
    expect = k3_step_launches(pk.config)
    log(f"[k3-1.7b] K3 launches a decoded frame: {per_frame:g} over {steps['frames']} frames "
        f"(expected {expect}; 0.6B: {k3_per_frame_06:g}) "
        f"{'ok' if per_frame == expect else 'FAIL'} ({card})")
    if per_frame != expect:
        raise SystemExit("[k3-1.7b] the frame loop did not run every linear on K3")
    m["k3"]["k3_per_frame"] = per_frame
    # B = 32, the JAX package's serving batch (its B = 8 step is k3-serving's
    # at 0.6B and K3's GEMV at the 1.7B M = 8 shapes qmm_1_7b's): every
    # linear at M = 32 and the first pass's projection at 64, on the tile;
    # teacher-forced over 8 steps (beside the fp32 twin a comparison steps
    # six states)
    runs["k3_serving_b32"], m["k3_serving_b32"] = serving_step(
        pk, card, "k3-serving-1.7b", pl32=fp32_twin(pk), tf_steps=8, b=32)
    graph_vs_eager(pk, card, label="k3-serving-1.7b", b=32)
    del pk
    torch.cuda.empty_cache()


def phase_serving_1_7b(pl, d: str, card: str, k3_per_frame_06: float, clip):
    """The 1.7B model batched at the JAX package's serving widths, on the
    1.7b phase's pipeline (megakernel configuration's weights: every
    talker and code-predictor linear the `w8r` product at M = B,
    small_to_mtp_projection on K3) and its dir: generate_many of 32 texts
    (T = 0.85, MANY_32_TOKENS frames, at least MIN_ROWS_32 vocoder rows in
    one call) and generate_many_stream at batch_size=32, the step at B = 1,
    8 and 32 with K3 the projection's 15 launches a step (M = 2B once,
    then B), 5 replays of the B = 32 step with its 75 K3 kernels counted
    by the tile's name, the B = 32 graph bit for bit the eager step, B = 32
    against B = 1 with BATCH_ROUNDING's checks; the service at bench.py's
    shape over HTTP (phase_service at SERVICE_16 slots, trailing bucket
    SERVICE_16_TRAILING: bench_burst, mode_burst on the 5 s `clip` of the
    1.7B model's own VoiceDesign speech beside 8 built-in requests, every
    mode's prompt layout in one batch, beside the fp32 twin's prefill of
    the same burst, its greedy graph bit for bit the eager step on that
    batch; then steady_arrivals behind STEADY_LONG long streams); one fp32
    twin of the tree serves both; then the K3 configuration loaded from the
    dir (k3_configuration_1_7b: its step at B = 32). Returns (launch counts
    summed over the counted runs, the counts of each, metrics)."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    t_phase = time.perf_counter()
    label, runs, m = "serving-1.7b", {}, {}
    twin = fp32_twin(pl)
    runs["serving_b32"], m["serving_b32"] = phase_serving(
        pl, card, label, widths=(1, 8, 32), pl32=twin, w8r=False, profiled=(),
        eager_profiled=False, **SERVE_32)
    expect = pl.config.code_predictor_config.num_code_groups - 1  # a projection a pass
    for b, r in m["serving_b32"]["steps"].items():
        ok = r["k3_per_step"] == expect and r["k3_m"] == {2 * b: 1, b: expect - 1}
        log(f"[{label}] B={b}: K3 launches a step {r['k3_per_step']} (expected {expect}: the "
            f"projection, M = {2 * b} once, then {b}), M: launches {r['k3_m']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[{label}] the B = {b} step did not run the projection on K3")
    statics = _statics(pl, 1)  # step_times' key: its B = 32 graph, free again
    state = srv.bind(pl.params, pl.cp_params, _serving_state(pl, _texts(32), statics), statics,
                     True)
    # the step's device time at B = 32 from this window (step_times takes none)
    replayed = replayed_kernels(state.graph, 5, "int8_matmul", label, tile=True,
                                out=m["serving_b32"]["steps"][32])
    log(f"[{label}] K3 tile kernels in 5 replays of the B=32 step: {replayed} (expected "
        f"{5 * expect}) {'ok' if replayed == 5 * expect else 'FAIL'}")
    if replayed != 5 * expect:
        raise SystemExit(f"[{label}] the replays did not launch K3's tile {expect} times each")
    m["replayed_k3"] = replayed
    del state
    torch.cuda.empty_cache()
    log(f"[{label}] serving part: {time.perf_counter() - t_phase:.1f} s")
    runs["service_b16"], m["service_b16"] = phase_service(
        pl, card, "service-1.7b", mixed=False, pl32=twin, batch_size=SERVICE_16,
        burst_tokens=SERVICE_16_TOKENS, burst=bench_burst(clip), tf_rows=SERVICE_16_TF_ROWS,
        trailing_bucket=SERVICE_16_TRAILING, steady=steady_arrivals(clip))
    del twin
    torch.cuda.empty_cache()
    log(f"[{label}] serving and service parts: {time.perf_counter() - t_phase:.1f} s")
    k3_configuration_1_7b(d, card, k3_per_frame_06, runs, m)
    m["phase_s"] = time.perf_counter() - t_phase
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    total = {k: sum(r[k] for r in runs.values()) for k in KERNELS}
    return total, runs, m


# ---- packed trees batched, and the packed configurations at 1.7B ----


def phase_mixed_serving(pl, card: str, label: str = "mixed-serving"):
    """Lockstep serving on the mixed 4/6-bit tree at 0.6B (the mixed-pipeline
    phase's pipeline: every talker and code-predictor linear on K7 at M =
    B): serving_step with K7 (16 steps at B = 8 from one graph, 428 launches
    a step, the tree's packed linears and the K3 configuration's count, its
    replays' K7 kernels counted by name at every width, B = 8 against B = 1
    beside the fp32 twin); the graph bit for bit the eager step;
    generate_many of the 8 serving texts at T = 0.85 with K7 counted
    (serving_runs). Returns (launch counts summed over the counted runs,
    metrics)."""
    t_phase = time.perf_counter()
    runs, m = {}, {}
    runs["step"], m["step"] = serving_step(pl, card, label, "packed_matmul", pl32=fp32_twin(pl))
    graph_vs_eager(pl, card, label=label)
    runs["generate_many"], m["generate_many"] = serving_runs(
        pl, card, label, temps=(0.85,), streams=(),
        need=("packed_matmul",) + SERVING_VOCODER,
        idle=("talker_step", "cp_frame", "gumbel_sample", "int8_matmul",
              "pre_transformer_fused"))
    m["phase_s"] = time.perf_counter() - t_phase
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    return {k: sum(r[k] for r in runs.values()) for k in KERNELS}, m


def frame_calls(pl, steps: dict, calls: list, label: str) -> dict:
    """K7's launches a decoded frame (decoded_frames' `steps`) against
    tree_launches, and small_to_mtp_projection's calls among kernel_rows'
    `calls`: M = 2 once a frame (the first pass's two rows), then M = 1 on
    each later pass. Returns them."""
    ng = pl.config.code_predictor_config.num_code_groups - 1
    per_frame = steps["packed_matmul"] / steps["frames"]
    expect = tree_launches(pl, "packed_matmul")
    ptr = pl.cp_params["small_to_mtp_projection"]["wq"].data_ptr()
    ms = [mm for mm, p in calls if p == ptr]
    proj = {mm: ms.count(mm) for mm in sorted(set(ms))}
    want = {1: (ng - 1) * steps["frames"], 2: steps["frames"]}
    ok = per_frame == expect and proj == want
    log(f"[{label}] K7 launches a decoded frame: {per_frame:g} over {steps['frames']} frames "
        f"(expected {expect} from the tree); small_to_mtp_projection's calls by M: {proj} "
        f"(expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[{label}] the frame loop did not run every packed linear on K7 once "
                         "a frame")
    return {"k7_per_frame": per_frame, "projection_m": proj}


def phase_mixed_1_7b(d: str, card: str):
    """The mixed 4/6-bit pipeline at 1.7B, loaded from the 1.7b phase's
    dense dir `d` (runtime_quantization_mode="mixed_4_6", megakernels off:
    every talker and code-predictor linear on K7, small_to_mtp_projection
    at 4 bits): generate and generate_stream of HOST_BOUND_FRAMES frames
    (frame_calls: K7 tree_launches a decoded frame, the projection at M = 2
    once and then 1 a frame); a profile of the frame loop with K7's kernels
    by name; mixed_prefill_check in bf16 and on the fp32 twin; serving_step
    at B = 32 with K7 (443 a step, all on the tile, counted by the tile's
    name in 5 replays; the projection M = 64 once, then 32) beside the
    twin; the graph bit for bit the eager step. Returns (launch counts summed over
    the counted runs, the counts of each, metrics)."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    t_phase = time.perf_counter()
    label, runs, m = "mixed-1.7b", {}, {}
    mixed = qt.Qwen3TTSPipelineConfiguration(runtime_quantization_mode="mixed_4_6",
                                             use_talker_megakernel=False,
                                             use_cp_megakernel=False)
    with decoded_frames(gen_mod) as steps, kernel_rows() as calls:
        pl, runs["pipeline"], m["pipeline"] = run_pipeline(
            card, d, label, mixed, need=("packed_matmul",) + SERVING_VOCODER,
            idle=("talker_step", "cp_frame", "gumbel_sample", "int8_matmul"),
            frames=HOST_BOUND_FRAMES)
    if tree_launches(pl, "packed_matmul") != k3_step_launches(pl.config):
        raise SystemExit(f"[{label}] the mixed tree does not pack every linear")
    m["frames"] = frame_calls(pl, steps, calls["packed_matmul"], label)
    del calls
    m["profile"] = profile_frames(pl, label, card, steps=2)
    pl32 = fp32_twin(pl)
    m["prefill"] = {dt: mixed_prefill_check(p, card, dt, label)
                    for dt, p in (("bfloat16", pl), ("float32", pl32))}
    ng = pl.config.code_predictor_config.num_code_groups - 1
    # B = 32 (its B = 8 step is mixed-serving's at 0.6B and K7's GEMV at the
    # 1.7B M = 8 shapes qmm_1_7b's)
    runs["step_b32"], m["step_b32"] = serving_step(
        pl, card, "mixed-serving-1.7b", "packed_matmul", pl32=pl32, tf_steps=8,
        projection={32: ng - 1, 64: 1}, b=32)
    graph_vs_eager(pl, card, label="mixed-serving-1.7b", b=32)
    del pl, pl32
    torch.cuda.empty_cache()
    m["phase_s"] = time.perf_counter() - t_phase
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    return {k: sum(r[k] for r in runs.values()) for k in KERNELS}, runs, m


PREQUANT_1_7B_FRAMES = 96  # generate and generate_stream of the prequant-1.7b phase


def phase_prequant_1_7b(q: str, card: str, int8_resident: int, written: dict):
    """A pre-quantized 4-bit group-64 1.7B dir (MLX's layout) on the default
    configuration: `q`, a copy of the 1.7b phase's dir packed by
    testing._pack_talker_weights (every talker and code-predictor linear
    and table; DirWriter's "packed-1.7b" job, its seconds `written`).
    generate and generate_stream of PREQUANT_1_7B_FRAMES frames
    with K1 and K2 built from the packed weights and launched once a
    decoded frame, K7 in the text projection only, K3 and K2g's kernel
    idle; K7 at the text projection's shapes; K1 / K2 teacher-forced over
    TF_FRAMES; the resident bytes beside the int8 dir's (`int8_resident`);
    a profile of the frame loop; serving_step at B = 8 on the `w8r` views
    with small_to_mtp_projection on K7 (15 launches a step: M = 16 once,
    then 8) beside the fp32 twin; the graph bit for bit the eager step.
    Returns (launch counts summed over the counted runs, the counts of
    each, metrics)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    t_phase = time.perf_counter()
    label, runs, m = "prequant-1.7b", {}, {}
    with contextlib.nullcontext(q):
        m["copy_s"], m["pack_s"] = written["copy_s"], written["pack_s"]
        log(f"[{label}] a copy of the 1.7b dir ({m['copy_s']:.1f} s) packed to 4 bits, group 64 "
            f"(MLX's layout) in {m['pack_s']:.1f} s")
        with decoded_frames(gen_mod) as steps:
            pl, runs["pipeline"], m["pipeline"] = run_pipeline(
                card, q, label, None,
                need=("talker_step", "cp_frame", "packed_matmul") + SERVING_VOCODER,
                idle=("gumbel_sample", "int8_matmul"), frames=PREQUANT_1_7B_FRAMES)
    k1, k2 = runs["pipeline"]["talker_step"], runs["pipeline"]["cp_frame"]
    ok = (k1 == k2 == steps["frames"] == 2 * PREQUANT_1_7B_FRAMES
          and steps["packed_matmul"] == steps["int8_matmul"] == 0)
    log(f"[{label}] generate() and generate_stream() decoded {steps['frames']} frames (expect "
        f"{2 * PREQUANT_1_7B_FRAMES}): K1 launched {k1} times, K2 {k2}, K7 "
        f"{steps['packed_matmul']} and K3 {steps['int8_matmul']} times inside them; K7 "
        f"{runs['pipeline']['packed_matmul']} in all (the text projection) "
        f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise SystemExit(f"[{label}] K1 and K2 did not run once a frame with K7 in the text "
                         "projection only")
    text_projection(pl, card, label, "K7")
    m["teacher_forced"] = teacher_forced(pl, card, label, frames=TF_FRAMES)
    res = m["pipeline"]["resident_bytes"]
    log(f"[{label}] resident {res} bytes against the int8 1.7B dir's {int8_resident} "
        f"({res / int8_resident:.3f}x) ({card})")
    m["profile"] = profile_frames(pl, label, card)
    ng = pl.config.code_predictor_config.num_code_groups - 1
    if tree_launches(pl, "packed_matmul") != ng:
        raise SystemExit(f"[{label}] the batched step's packed linears are not the projection's")
    runs["step"], m["step"] = serving_step(pl, card, "prequant-serving-1.7b", "packed_matmul",
                                           pl32=fp32_twin(pl), tf_steps=8,
                                           projection={8: ng - 1, 16: 1}, every_linear=False)
    graph_vs_eager(pl, card, label="prequant-serving-1.7b")
    del pl
    torch.cuda.empty_cache()
    m["phase_s"] = time.perf_counter() - t_phase
    log(f"[{label}] phase: {m['phase_s']:.1f} s ({card})")
    return {k: sum(r[k] for r in runs.values()) for k in KERNELS}, runs, m


# ---- model dirs written beside the phases ----


def _write_dirs(jobs: list) -> None:
    """A child process's work: each (kind, path, source) job in turn, each
    marked done by `path`.written (JSON: its seconds). Kinds: "prequant"
    (the 0.6B dir pre-quantized to 4 bits, group 64), "modes" (0.6B with
    both encoders), "golden" (verify's 0.6B dir packed at 4 / 6 / 8 bits
    with both encoders), "1.7b" (the 1.7B dir with both encoders, its speaker
    encoder's enc_dim 2048), "packed-1.7b" (a copy of the
    1.7B dir `source`, written by an earlier job, packed to 4 bits, group
    64, by testing._pack_talker_weights). Host work only: no CUDA."""
    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.testing import (
        _pack_talker_weights,
        write_golden_model_dir,
        write_model_dir,
        write_prequantized_model_dir,
    )

    dec = qt.TokenizerDecoderConfig()
    for kind, path, source in jobs:
        t0, times = time.perf_counter(), {}
        if kind == "prequant":
            write_prequantized_model_dir(path, qt.Qwen3TTSConfig.standard(), dec, widths=(4,),
                                         group_size=64)
        elif kind == "modes":
            write_model_dir(path, qt.Qwen3TTSConfig.standard(), dec, seed=0, with_encoders=True,
                            tts_model_type="base")
        elif kind == "golden":
            write_golden_model_dir(path, qt.Qwen3TTSConfig.standard(), dec, widths=(4, 6, 8),
                                   group_size=64, seed=0)
        elif kind == "1.7b":  # with both encoders: the speaker encoder 2048 wide
            write_model_dir(path, qt.Qwen3TTSConfig.standard_1_7b(), dec, seed=0,
                            with_encoders=True, tts_model_type="base")
        elif kind == "packed-1.7b":
            shutil.copytree(source, path, dirs_exist_ok=True)
            times["copy_s"] = time.perf_counter() - t0
            _pack_talker_weights(path, (4,), 64)
            times["pack_s"] = time.perf_counter() - t0 - times["copy_s"]
        else:
            raise ValueError(f"unknown dir kind {kind}")
        times["s"] = time.perf_counter() - t0
        with open(path + ".part", "w") as f:
            json.dump(times, f)
        os.replace(path + ".part", path + ".written")


class DirWriter:
    """The later phases' model dirs, written by one spawned child process
    (_write_dirs) while the earlier phases run on the card: host work beside
    the card's, so a phase that reads a dir waits only for what is left of
    its writing. wait(path) returns the job's seconds; close() ends the
    child."""

    def __init__(self, jobs: list):
        import multiprocessing as mp

        self.proc = mp.get_context("spawn").Process(target=_write_dirs, args=(jobs,),
                                                    daemon=True)
        self.proc.start()

    def wait(self, path: str, label: str) -> dict:
        t0 = time.perf_counter()
        while not os.path.exists(path + ".written"):
            if not self.proc.is_alive() and not os.path.exists(path + ".written"):
                raise SystemExit(f"[{label}] the dir writer ended (exit code "
                                 f"{self.proc.exitcode}) without writing {path}")
            time.sleep(0.2)
        with open(path + ".written") as f:
            times = json.load(f)
        log(f"[{label}] its model dir written beside the earlier phases in {times['s']:.1f} s "
            f"(a child process); waited {time.perf_counter() - t0:.1f} s for it")
        return times

    def close(self) -> None:
        self.proc.join(timeout=60)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from qwen3_tts_tpu_torch.ops.cuda import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.testing import write_model_dir

    t_start = time.perf_counter()
    card = card_line()
    log(card)  # nvidia-smi --query-gpu=name,power.limit, as it prints them
    log(f"[device] torch.cuda: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # nvcc builds the kernels (one process a source) while this process
    # writes the 0.6B dir; then a child process writes the later phases'
    # dirs (DirWriter) while the phases before them run
    t0, built = time.perf_counter(), {}

    def build() -> None:
        try:
            _build.build(force=True)
            built["s"] = time.perf_counter() - t0
        except BaseException as e:  # raised again below
            built["error"] = e

    build_thread = threading.Thread(target=build)
    build_thread.start()

    rec = Record()
    results, launches, runs32 = {}, {}, {}
    marks = []

    def mark(name: str) -> None:
        """Logs the seconds since the last mark: the script's time by phase."""
        marks.append(time.perf_counter())
        log(f"[time] {name}: {marks[-1] - marks[-2]:.1f} s (at {marks[-1] - t_start:.1f} s)")

    vocoder = ("pre_transformer", "upsample_stage", "residual_units", "block_upsample")
    megakernels = ("talker_step", "cp_frame")
    sampler = ("gumbel_sample",)  # its kernel: K2 draws inside its own launch
    main_dir = tempfile.TemporaryDirectory()  # the 0.6B dir, kept for the tp phase
    later = tempfile.TemporaryDirectory()  # the dirs DirWriter writes
    dirs = {k: os.path.join(later.name, k)
            for k in ("prequant", "modes", "golden", "1.7b", "packed-1.7b")}
    with contextlib.nullcontext(main_dir.name) as d:
        t1 = time.perf_counter()
        talker_dense, cp_dense, _ = write_model_dir(
            d, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(), seed=0)
        log(f"[pipeline] wrote a random-weight 0.6B model dir in "
            f"{time.perf_counter() - t1:.1f} s (beside the build)")
        build_thread.join()
        if "error" in built:
            raise built["error"]
        _build.lib()
        log(f"[build] nvcc sm_90a build of {len(_build.sources())} sources in parallel: "
            f"{built['s']:.1f} s -> {_build.build_dir()}; with the dir's writing "
            f"{time.perf_counter() - t0:.1f} s")
        writer = DirWriter([(k, dirs[k], dirs["1.7b"]) for k in dirs])
        marks.append(time.perf_counter())
        phase_megakernels(rec, card, talker_dense, cp_dense)
        del talker_dense, cp_dense
        mark("megakernels")
        phase_kernels(rec)
        mark("kernels")
        launches["fused_path"] = phase_fused_path(card)
        launches["sampler_path"] = phase_sampler_path(card)
        mark("fused-pretransformer, sampler")

        pl, launches["megakernels"], results["megakernels"] = run_pipeline(
            card, d, "pipeline", None, need=megakernels + ("int8_matmul",) + vocoder,
            idle=sampler + ("packed_matmul",))
        no_sync_chunk(pl, "pipeline")
        text_projection(pl, card, "pipeline", "K3")
        teacher_forced(pl, card, frames=TF_FRAMES)
        vocoder_check(pl)
        vocoder_windows(pl, card)
        profile_frames(pl, "pipeline", card)
        mark("pipeline")
        launches["serving"], results["serving"] = phase_serving(pl, card)
        mark("serving")
        twin = fp32_twin(pl)
        # its step's times at B = 32 are the serving phase's
        runs32["w8r"], results["serving_32"] = phase_serving(pl, card, "serving-32", widths=(),
                                                             pl32=twin, **SERVE_32)
        mark("serving-32")
        runs32["service"], results["service_32"] = phase_service(
            pl, card, "service-32", mixed=False, pl32=twin, batch_size=32,
            burst_tokens=STREAM_32_TOKENS, tf_rows=(0, 31))
        mark("service-32")
        del pl, twin
        torch.cuda.empty_cache()

        off = qt.Qwen3TTSPipelineConfiguration(use_talker_megakernel=False,
                                               use_cp_megakernel=False)
        # the host-bound configurations (RTF 2.5-3.7) decode HOST_BOUND_FRAMES
        # frames, not 96, so the script keeps its margin under its time
        # limit with the tp and serving-1.7b phases added
        with decoded_frames(gen_mod) as steps:
            pl, launches["k3_path"], results["k3"] = run_pipeline(
                card, d, "k3-pipeline", off, need=("int8_matmul",) + vocoder,
                idle=megakernels + sampler + ("packed_matmul",), frames=HOST_BOUND_FRAMES)
        results["k3"]["k3_per_frame"] = steps["int8_matmul"] / steps["frames"]
        log(f"[k3-pipeline] K3 launches a decoded frame: {results['k3']['k3_per_frame']:g} "
            f"over {steps['frames']} frames")
        no_sync_chunk(pl, "k3-pipeline")
        profile_frames(pl, "k3-pipeline", card, steps=2)
        launches["serving_k3"], results["k3_serving"] = serving_step(pl, card, "k3-serving")
        mark("k3-pipeline, k3-serving")
        runs32["k3_step"], results["k3_serving_32"] = serving_step(
            pl, card, "k3-serving-32", pl32=fp32_twin(pl), tf_steps=8, b=32)
        graph_vs_eager(pl, card, label="k3-serving-32", b=32)
        mark("k3-serving-32")
        del pl
        torch.cuda.empty_cache()

        mixed = qt.Qwen3TTSPipelineConfiguration(runtime_quantization_mode="mixed_4_6",
                                                 use_talker_megakernel=False,
                                                 use_cp_megakernel=False)
        with decoded_frames(gen_mod) as steps:
            pl, launches["mixed"], results["mixed"] = run_pipeline(
                card, d, "mixed-pipeline", mixed, need=("packed_matmul",) + vocoder,
                idle=megakernels + sampler + ("int8_matmul",), frames=HOST_BOUND_FRAMES)
        results["mixed"]["k7_per_frame"] = steps["packed_matmul"] / steps["frames"]
        log(f"[mixed-pipeline] K7 launches a decoded frame: "
            f"{results['mixed']['k7_per_frame']:g} over {steps['frames']} frames (expected "
            f"{tree_launches(pl, 'packed_matmul')} from the tree; its kernels by name a frame "
            "in the profile below)")
        if results["mixed"]["k7_per_frame"] != tree_launches(pl, "packed_matmul"):
            raise SystemExit("[mixed-pipeline] the frame loop did not run every linear on K7")
        no_sync_chunk(pl, "mixed-pipeline")
        results["mixed"]["profile"] = profile_frames(pl, "mixed-pipeline", card, steps=4)
        mixed_prefill_check(pl, card, "bfloat16")
        # the same in an fp32 model, where no output rounds to bf16: the dir's
        # weights are bf16, so the bf16 model's trees widened (fp32_twin) are
        # the trees an fp32 load builds, packed words and scales alike,
        # without a second load's ~30 s of numpy packing
        mixed_prefill_check(fp32_twin(pl), card, "float32")
        mark("mixed-pipeline")
        launches["mixed_serving"], results["mixed_serving"] = phase_mixed_serving(pl, card)
        mark("mixed-serving")
        runs32["mixed_step"], results["mixed_serving_32"] = serving_step(
            pl, card, "mixed-serving-32", "packed_matmul", pl32=fp32_twin(pl), tf_steps=8, b=32)
        graph_vs_eager(pl, card, label="mixed-serving-32", b=32)
        mark("mixed-serving-32")
        del pl
        torch.cuda.empty_cache()

    with contextlib.nullcontext(dirs["prequant"]) as d:
        writer.wait(d, "prequant-pipeline")
        log("[prequant-pipeline] a random-weight 0.6B model dir pre-quantized to 4 bits, group 64")
        pl, launches["prequant"], results["prequant"] = run_pipeline(
            card, d, "prequant-pipeline", None,
            need=megakernels + ("packed_matmul",) + vocoder, idle=sampler + ("int8_matmul",))
        no_sync_chunk(pl, "prequant-pipeline")
        text_projection(pl, card, "prequant-pipeline", "K7")
        teacher_forced(pl, card, "prequant-pipeline", frames=TF_FRAMES)
        profile_frames(pl, "prequant-pipeline", card)
        del pl
        torch.cuda.empty_cache()

    with contextlib.nullcontext(dirs["modes"]) as d:
        writer.wait(d, "modes-pipeline")
        log("[modes-pipeline] a random-weight 0.6B model dir with the speaker encoder "
            "(SpeakerEncoderConfig()) and the audio encoder (TokenizerEncoderConfig())")
        mark("prequant-pipeline")
        launches["modes"], results["modes"], pl, design = phase_modes(card, d)
        mark("modes-pipeline")
        launches["service_modes"], results["service_modes"] = phase_service_modes(
            pl, card, design)
        del pl
        torch.cuda.empty_cache()
        mark("service-modes")
    launches["verify"], results["verify"] = phase_verify(card, dirs["golden"], writer)
    mark("verify")
    launches["tp"], results["tp"] = phase_tp(card, main_dir.name)
    mark("tp")
    main_dir.cleanup()
    launches["train"], results["train"] = phase_train(card)
    mark("train")
    floors = (rec.rows["int8_matmul"]["floor_cold_ms"],
              rec.rows["int8_matmul"]["floor_store_cold_ms"])
    with contextlib.nullcontext(dirs["1.7b"]) as d:  # the 1.7B dir, read again by serving-1.7b
        write_s = writer.wait(d, "1.7b")["s"]
        launches["1_7b"], results["1_7b"], rec17, m0_1_7b, pl = phase_1_7b(card, floors, d,
                                                                           write_s)
        mark("1.7b")
        launches["modes_1_7b"], results["modes_1_7b"], clip_1_7b = phase_modes_1_7b(pl, card)
        mark("modes-1.7b")
        (launches["serving_1_7b"], serving_1_7b_runs,
         results["serving_1_7b"]) = phase_serving_1_7b(pl, d, card,
                                                        results["k3"]["k3_per_frame"], clip_1_7b)
        del pl
        torch.cuda.empty_cache()
        mark("serving-1.7b")
        (launches["mixed_1_7b"], mixed_1_7b_runs,
         results["mixed_1_7b"]) = phase_mixed_1_7b(d, card)
        mark("mixed-1.7b")
        (launches["prequant_1_7b"], prequant_1_7b_runs,
         results["prequant_1_7b"]) = phase_prequant_1_7b(
            dirs["packed-1.7b"], card, results["1_7b"]["resident_bytes"],
            writer.wait(dirs["packed-1.7b"], "prequant-1.7b"))
        mark("prequant-1.7b")
    writer.close()
    later.cleanup()
    log(f"[done] {time.perf_counter() - t_start:.1f} s; pipeline metrics "
        f"{json.dumps(results)}")

    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = rec.rows[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches["megakernels"][name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": "bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
               "library_ms": r["library_ms"]}
        if name == "packed_matmul":  # the library covers its 4-bit shapes only
            row["library_call"] = "torch._weight_int4pack_mm"
            row["library_shapes"] = sorted(K7_LIBRARY_SHAPES)
            row["ms_at_library_shapes"] = r["ms_at_library_shapes"]
        if name == "packed_matmul":  # its two paths
            row["launches"] = launches["prequant"][name] + launches["mixed"][name]
        if name in ("int8_matmul", "packed_matmul"):  # the GEMV at M <= M0, cold and warm
            for field in ("gemv_warm_ms", "gemv_cold_ms", "gemv_bound_ms", "floor_cold_ms",
                          "floor_store_cold_ms", "library_cold_ms",
                          "cold_ms_at_library_shapes"):
                if field in r:
                    row[field] = r[field]
            mod = "K3" if name == "int8_matmul" else "K7 4-bit"
            row["m0"] = counters()[name][0].M0
            row["m0_swept"] = rec.m0_swept[mod]
        if name == "pre_transformer_fused":  # its own entry point
            row["launches"] = launches["fused_path"][name]
        if name == "gumbel_sample":  # its own entry point
            row["launches"] = launches["sampler_path"][name]
        if name in PLAIN_XLA:
            row["counterpart_of"] = "plain XLA"
        for path in ("k3_path", "mixed", "prequant", "modes", "verify"):
            row[f"launches_{path}"] = launches[path][name]
        row["launches_serving"] = launches["serving"][name] + launches["serving_k3"][name]
        row["launches_service_modes"] = launches["service_modes"][name]
        row["launches_modes_1_7b"] = launches["modes_1_7b"][name]
        row["launches_train"] = launches["train"][name]  # the training path launches none
        row["launches_tp"] = launches["tp"][name]  # rank 0's, on the tp = 2 generate()
        row["launches_1_7b"] = launches["1_7b"][name]
        row["launches_serving_1_7b"] = launches["serving_1_7b"][name]
        row["launches_serving_1_7b_by_run"] = {k: v[name] for k, v in serving_1_7b_runs.items()}
        # the 1.7B model at the JAX package's serving widths: B = 32 on the
        # `w8r`, K3 and mixed layouts; the service at B = 16
        row["launches_1_7b_b32"] = (serving_1_7b_runs["serving_b32"][name]
                                    + serving_1_7b_runs["k3_serving_b32"][name]
                                    + mixed_1_7b_runs["step_b32"][name])
        row["launches_service_1_7b_b16"] = serving_1_7b_runs["service_b16"][name]
        if name in rec17.b32:  # K3, K7 at a B = 32 step's 1.7B shapes
            row["at_1_7b_b32"] = rec17.b32[name]
        row["launches_mixed_serving"] = launches["mixed_serving"][name]
        row["launches_serving_32"] = sum(r[name] for r in runs32.values())
        row["launches_serving_32_by_run"] = {k: v[name] for k, v in runs32.items()}
        if name in rec.b32:  # K3, K7, K4, K5, K6, the upsample at B = 32's shapes
            row["at_b32"] = rec.b32[name]
        for path, runs in (("mixed_1_7b", mixed_1_7b_runs), ("prequant_1_7b", prequant_1_7b_runs)):
            row[f"launches_{path}"] = launches[path][name]
            row[f"launches_{path}_by_run"] = {k: v[name] for k, v in runs.items()}
        r17 = rec17.rows[name]
        if r17["ms"] or r17["max_abs_err"]:  # held at 1.7B's shapes: K1, K2, K3, K7
            row["max_abs_err"] = max(row["max_abs_err"], r17["max_abs_err"])
            row["at_1_7b"] = {
                k: r17[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
                                    "gemv_warm_ms", "gemv_cold_ms", "gemv_bound_ms",
                                    "library_cold_ms", "cold_ms_at_library_shapes",
                                    "ms_at_library_shapes", "shapes") if k in r17}
            row["at_1_7b"]["bound_by"] = ("bytes" if r17["t_bytes"] >= r17["t_ops"]
                                          else "operations")
            if name in ("int8_matmul", "packed_matmul"):
                row["at_1_7b"]["m0_swept"] = m0_1_7b[
                    "K3" if name == "int8_matmul" else "K7 4-bit"]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
