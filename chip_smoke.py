#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. device   — the card's name, device count, and ``nvidia-smi``'s name and
              power limit;
2. build    — nvcc builds every CUDA kernel from ``src/repro_torch/kernels/
              csrc`` into the git-ignored ``build/``, one nvcc per source,
              all started together (ptxas report printed);
3. kernels  — each kernel against its plain PyTorch version on CUDA tensors.
              Paged kernels at qwen2-0.5b shapes (KV 2, G 7, D 64, page 16)
              and gemma2-2b shapes (KV 4, G 2, D 288, window 4096 with
              longer contexts, softcap 50), with ragged lengths,
              trash/garbage table entries and q_len == 0 rows.  The flash
              kernel at qwen2-0.5b training shapes (B 8, S 1024, H 14, KV 2,
              D 64, causal: the tensor-core kernel), zamba2-1.2b's (B 8, S
              1024, H = KV = 32, D 64: MHA) and gemma2-2b shapes
              (B 1, S 4150 — past the window and not a tile multiple — H 8,
              KV 4, D 288, window 4096, softcap 50: the tensor-core kernel
              in 32-key tiles):
              output, logsumexp, and dQ/dK/dV through the autograd Function
              against autograd through the plain version.  The flash and
              paged decode outputs are held element by element to a bound
              derived from each kernel's rounding of P (``ref.
              rounding_bound_ratio``: 2^-8 (|P| @ |V|) / l for P in bf16 on
              the tensor cores, 2^-14 for P in f32, plus one bf16 ulp of the
              plain output), and broken kernels must fail it: paged prefill
              (the tensor-core kernel at qwen2's D = 64 and at gemma2's
              288, each checked to be the one launched) with a
              split's partial left out of the combine (tensor cores), the
              causal mask one key late, each row's last partial page
              dropped, the padding rows written as queries, gemma2's window
              one key wider or narrower; flash with the
              causal mask one key late, each row's last partial tile
              dropped, kv head h % KV (h + 1 at MHA), l not rescaled,
              gemma2's window one key wider or narrower (and l not
              rescaled there); decode with a split's partial left out
              of the combine, each row's newest key missed, a trash entry
              read unmasked, gemma2's window one key wider or narrower.
              The f32 routes of both paged kernels at the same two shape
              sets (the decode kernel's f32 instantiation and the
              CUDA-core prefill kernel, each checked to be the one
              launched) within 2^-14 (|P| @ |V|) / l + one f32 ulp, with
              the same broken variants above that bound.  The flash
              kernel's D tail (head dims padded to a multiple of 32 in
              the wrapper, ``flash_attention.run_padded``) at gemma2-27b's
              head layout (B 2, S 640, H 32, KV 16, D 144: tensor cores,
              at the padded 160) and
              at D 80 (B 2, S 600, H 8, KV 2: tensor cores), output, lse
              and gradients as above, and two broken D tails must fail
              (the scale of the padded D, junk in the padded columns).
              The SSD scan at mamba2-1.3b shapes (b 2, S 1024, H 64, P 64,
              N 128, G 1, chunk 256) on what a fresh full-width layer feeds
              it, and with G = 2 and S = 1000 (not a chunk multiple)
              through ``ops.ssd``, and on what a fresh full-width
              zamba2-1.2b layer feeds it (b 2, S 1024, H 64, P 64, N 64),
              each checked to take the tensor-core
              scan: output element by element within 2^-8 mix + 2^-7
              |plain| (mix the plain scan of |x|, |B|, |C|; ``ref.
              rounding_bound_ratio``) and within 2e-2 max(1, |plain|),
              gradients; broken scans must fail the bound: the carried
              state dropped, dt 5% off, the mask one row late, h_enter one
              chunk late, the chunk decay exp(seg) left out, and at G = 2
              head h reading group h % G.  The CUDA-core scan (f32) at the
              same widths (b 1, S 1024), checked to be the one launched,
              within 2^-14 mix + one f32 ulp and 2e-2 max(1, |plain|);
              the carried state dropped or dt 5% off must fail.  RMSNorm at d 896 / 2048 / 2304
              / 4096 / 8192, bf16 -> bf16, f32 -> bf16 and f32 -> f32, a
              row count that is not a block multiple, each on the one-pass
              kernel, within one bf16 ulp element by element (1e-6
              relative for f32 out) and 2e-2 max(1, |plain|); broken
              kernels must fail the ulp rule: the gain read as scale, at d
              4096 one warp's partial left out of the row's sum, at d 2304
              the last pack not written; the two-pass kernel, checked to
              be the one launched, at d 16384 (packs of 8), d 100 and rows
              off 16-byte alignment (element by element), within one ulp;
              and its gradients; the decode rows, 1 and 8 at d 2,048 and
              4,096, within one ulp, the broken variants failing.  The int8
              flash kernel at the dense serving
              path's decode shapes (q (8, 1, 14, 64) bf16, int8 K/V
              (8, 2048, 2, 64) quantized by the model's quantizer, bf16
              scales, lengths 1-2048), at zamba2-1.2b's (MHA, G = 1: q (8,
              1, 32, 64), K/V (8, 1024, 32, 64), lengths 1-1024; and the
              B = 1 prompt replay, kv_len 78; both with qwen2's broken
              variants), at gemma2-2b's D = 288 with window
              and softcap, and at the TPU kernel's own test shapes (f32,
              q_start 0, kv_len Skv), element by element; kernels that
              left a split's partial out of the combine, ignored the scales
              or the per-row lengths, dropped each row's last partial tile
              or its newest key, moved gemma2's window by one key either
              way, or kept K unrounded must fail the check.  At
              qwen3-moe-30b-a3b's attention (KV 4, G 8, D 128): paged
              decode q (8, 4, 8, 128) at contexts 512-2048 with trash
              entries, paged prefill q (4, 4, C*8, 128) at C = 16 and 64,
              starts 0-1,024, q_len = 0 rows and zero padding rows (each
              checked to take the tensor-core kernel), the int8 kernel at
              q (8, 1, 32, 128) over int8 K/V (8, 2048, 4, 128) and the
              B = 1 replay, with qwen2's broken variants.  The flash
              kernel without the causal mask and with Sq != Skv at
              whisper-small's shapes (``CROSS_SETS``: the encoder, q, k,
              v (8, 1500, 12, 64); cross-attention, q (8, 448, 12, 64)
              over k/v (8, 1500, 12, 64); decode cross-attention, one
              query over 1,500), forward and backward, and at
              qwen2-vl-72b's (2, 1024, 64 / 8, 128), causal, each within
              the bound; broken variants above it: a causal mask where
              none was asked, the last partial key tile dropped, Skv
              taken as Sq (and the causal ones above for qwen2-vl); the
              int8 kernel at whisper's dense int8 decode (q (8, 1, 12,
              64) over int8 K/V (8, 448, 12, 64)) with qwen2's broken
              variants;
4. times    — each kernel at the main path's shapes (decode: B = 8,
              contexts 512-2048; prefill: B = 4, C = 64, and the launcher's
              B = 4, C = 16; flash: the qwen2 training shapes above; int8
              flash: the decode shapes above, and the dense prefill
              replay's B = 1 against a 1,024-position stripe, kv_len
              1-128; SSD: mamba2-1.3b training, b 8; RMSNorm: mamba2's
              gated norm, 8,192 x 4,096 f32 -> bf16; the unembedding's
              split: a 32,736 x 5,312 chunk of the training cell's
              32,736 x 151,936 cotangent, aligned (vector route) and
              one column on (scalar route), bit for bit) with CUDA
              events, L2 flushed before every launch and a spin kernel
              after the flush so the host's enqueue is not timed, the
              same elementwise checks as phase 3, beside its plain
              version, the
              library yardstick (gather + scaled_dot_product_attention;
              scaled_dot_product_attention on K/V dequantized beforehand;
              ``F.rms_norm``; none for the SSD scan; used nowhere in the
              port) and its bound (bytes at 3.35 TB/s or flops at 989
              TFLOP/s, whichever is larger); the tensor-core SSD scan also
              launch by launch (each kernel's device time in whole scans,
              from ``torch.profiler``), and RMSNorm also at the qwen2 step's
              8,192 x 896 f32 -> bf16; then at zamba2-1.2b's shapes: flash
              (8, 1024, 32, 64), the int8 kernel at its decode and B = 1
              replay shapes, the SSD scan at N 64 (b 8, also launch by
              launch), RMSNorm at 8,192 x 2,048 f32 -> bf16; then the
              repaired routes as entries of their own: the f32 decode and
              CUDA-core f32 prefill at the launcher's kernel-profile shapes
              (``serving/profiling.py::paged_profile_cases``: 8 slots of
              1,024, 513 pages, C = 8; bound with f32 flops at 67 TFLOP/s)
              and the flash D tail at gemma2-27b's layout (B 2, S 2048, D
              144), whose ``launches`` in the kernels line is the sum of
              its own counter (``flash_d_tail``) over every path run;
              then qwen3-moe-30b-a3b's shapes of phase 3 (decode, prefill
              at C = 16 and 64, int8 decode and B = 1 replay); then
              whisper-small's (flash at the encoder, cross-attention,
              decode cross-attention and the decoder's causal (8, 448,
              12, 64), against SDPA with ``is_causal`` as the call asks;
              the int8 kernel at its decode) and qwen2-vl-72b's (flash at
              (2, 1024, 64 / 8, 128); paged decode q (8, 8, 8, 128) at
              contexts 512-2048; paged prefill at C = 16; RMSNorm on
              2,048 x 8,192 training rows, the one-pass kernel's widest);
5. serving  — full-width qwen2-0.5b (random weights, seed 0), paged: (a)
              the port's launcher ``repro_torch.launch.serve.main``; (b)
              the scheduler and engine driven directly with 8 prompts of
              320-1024 tokens sharing a 256-token prefix.  Every round is a
              replay of one of the engine's two CUDA graphs (decode,
              paged prefill), each captured once (in (b) the engine is
              marked warm once both exist, and nothing is captured or
              recompiled after).  Every kernel's launch counter is zeroed
              just before each part; the counts (replays x each capture's
              launches) must be exactly 24 paged-decode launches a decode
              round, 24 prefill launches a prefill round, all on the
              tensor-core kernel, and 49 one-pass RMSNorms a round; every
              request completes, the prefix cache hits, nothing leaks.
              Then a B = 8 decode step at contexts 512-2048 as one graph
              replay (and eagerly, for comparison), timed like the
              kernels, and 5 serving-like steps (inputs from the host,
              replay, greedy sample to the host) under ``torch.profiler``:
              device kernels a step and the card's busy share;
6. dense int8 — the same weights in dense mode with the int8 KV cache
              (8 slots, max_seq_len 1024, prefill chunk 16, 64 prefix
              blocks): 12 greedy prompts of 32 shared + 16-96 own tokens,
              32 new each, every decode round and every 16-token prompt
              chunk a replay of the engine's two graphs (decode, dense
              chunk), each captured once, none after warm-up, with exactly
              24 x (decode steps + prefill tokens executed) int8-kernel
              launches, 49 RMSNorms a step, and no other attention kernel,
              nothing leaked; then the first 4 with the bf16 dense cache
              (no int8 launch), and the int8 / bf16 KV bytes ratio;
7. card vs CPU — the same weights on the CPU (plain kernel versions): one
              48-token prompt, last-position logits within tolerance and 4
              equal greedy tokens through the paged engine (scheduler), 8
              through the dense int8 engine (its decode steps driven
              directly); then, paged and dense int8, one replayed decode
              round against an eager ``decode_step`` on the same inputs
              with the same kernels: identical logits;
8. training — full-width qwen2-0.5b through the port's launcher
              ``repro_torch.launch.train.main`` (seq 1024, batch 8, 8 AdamW
              steps; ``--strategy dp``, as in phases 10, 12 and 20: an NCCL
              group at world size 1 and the gradients through
              ``hvd.allreduce``): every loss finite, the last below the first, the
              flash kernel launched on every layer of every step, each
              launch on the tensor-core kernel, and RMSNorm on every norm,
              each on the one-pass kernel (counters zeroed just before);
              then one step under ``torch.profiler`` for where the device
              time goes;
9. training card vs CPU — one train step of a 2-layer full-width qwen2 at
              seq 128, batch 2, on the same weights on both: loss and the
              gradient's global norm within tolerance;
10. training mamba2-1.3b, full width, through the launcher (seq 1024,
              batch 8, ``RECURRENT_TRAIN_STEPS`` AdamW steps): losses
              finite and falling, exactly
              96 SSD scans (48 layers x 2 with remat), every one on the
              tensor-core route, and 193 RMSNorm launches in every step,
              every one on the one-pass kernel, step time, tokens/s, peak
              memory; one step under ``torch.profiler``;
11. mamba2 training card vs CPU — one step of a 2-layer full-width mamba2
              at seq 512 (two chunks: the state carries), batch
              ``RECURRENT_CPU_BATCH``, on the
              same weights on both: loss and gradient norm within
              tolerance;
12. training zamba2-1.2b, full width, through the launcher (seq 1024,
              batch 8, ``RECURRENT_TRAIN_STEPS`` AdamW steps, remat per
              mamba layer and per
              application of the shared block): losses finite and falling,
              exactly 12 flash launches (6 applications x 2), 76 SSD scans
              (38 layers x 2) and 177 RMSNorms in every step, each on the
              tensor-core / one-pass route, step time, tokens/s, peak
              memory; one step under ``torch.profiler``;
13. zamba2 training card vs CPU — one step of an 8-layer full-width zamba2
              (one group of six and the shared block, a tail of two) at
              seq 512, batch ``RECURRENT_CPU_BATCH``: loss and gradient
              norm within tolerance;
14. dense serving of mamba2-1.3b and zamba2-1.2b, full width — phase 6's
              workload cut to ``RECURRENT_REQUESTS`` prompts (8 slots x
              1,024, chunk 16, 64 prefix blocks asked
              for: the engine keeps none) for zamba2 with int8 KV, zamba2
              with bf16 KV (first 4 prompts) and mamba2: every round a
              replay of the engine's two programs, captured once; exactly
              6 int8 launches (int8 zamba2), no SSD or other attention
              launch and 2 L + 2 G + 1 one-pass RMSNorms per step (decode
              steps + prompt tokens executed); nothing leaked; a B = 8
              decode round replayed (CUDA events) and held bit for bit
              against the eager round from the same cache; then card
              against CPU at cut depth (zamba2 8 layers, int8; mamba2 4):
              last logits within tolerance and 8 equal greedy tokens;
15. 3dgan training, full width, Horovod DP — ``hvd.init("cuda")`` makes
              an NCCL process group at world size 1 (``file://`` store) and
              the backend is printed; ``GAN3DConfig()`` at seeds 0 / 1 must
              count 719,053 G and 334,403 D parameters; three (D, G) RMSProp
              step pairs (batch 8) through ``hvd.make_train_step`` on the
              card against the same pairs on the CPU from the same weights,
              batches and z (losses and parameters within the GAN_*
              tolerances below); one D step and one G step must hand the
              ``data`` group exactly two all_reduces each, of 334,403 x 4 +
              16 and 719,053 x 4 + 12 bytes (the fused gradient, then the
              metrics); the entry point ``repro_torch.launch.train_3dgan``
              at batch 8 and 64 (ms per (D, G) pair, ms making a batch,
              images/s, peak memory), the gradient all_reduces of a pair
              timed with CUDA events, one pair at each batch under
              ``torch.profiler`` (the card's busy share) beside its bound
              (``gan_flops_per_image``: f32 operations over 67 TFLOP/s), and
              the physics-validation flow's five rows;
16. deployment — the paper's path: ``DeploymentPipeline.deploy`` of the
              PyTorch image (``core/deploy.py::pytorch_image``: resolved
              against the port's offline index, flattened, transferred,
              unpacked under ``build/chip_smoke/deploy``), the pipeline log
              and the rendered 1-node and 32-node launch lines; inside the
              capsule (``Deployment.run``, world size 1 on NCCL) the
              launcher at qwen2-0.5b full width, ``--strategy dp``, seq
              1024, batch 8, 8 AdamW steps: losses finite and falling,
              exactly 48 flash launches (all tensor cores) and 97 one-pass
              RMSNorms a step, exactly one f32 gradient all_reduce of 4 x
              (parameter count) bytes and one of the four metrics (16
              bytes) a step, the image tree hash unchanged; step time,
              tokens/s and peak memory beside phase 8's bare run; the
              gradient all_reduce timed with CUDA events; then
              ``benchmarks/container_overhead.run`` at the full 3DGAN,
              batch 64 (three bare and three capsule rounds of 50 D steps,
              interleaved): its four rows and the peak device memory row;
17. the serving fleet, full-width qwen2-0.5b (random weights, seed 0,
              paged, bf16): (a) the launcher ``--paged --replicas 3
              --max-slots 8 --max-seq-len 1024 --requests 24 --max-new 32
              --shared-prefix 256 --greedy --tenant a,b --slo-config ...
              --metrics-out ... --metrics-interval-steps 8 --trace-out ...
              --profile``: every request completes, the prefix's hash owner
              hits its cache, the replicas share one set of weights, every
              replica's two programs are captured once and never again,
              each decode replay launches 24 paged-decode kernels (bf16)
              and each prefill replay 24 tensor-core prefills, the counts
              over the run are exactly replays x 24 plus the kernel
              profiles' launches (bf16, the engine's KV dtype; printed
              beside their bounds), and the
              merged trace passes the schema; (b) failover: three engines
              on one set of weights, ``replica1`` crashing at its step 4,
              18 greedy requests of 256-896 prompt and 16-32 new tokens (12
              before the crash): ``replica1`` DEAD, one failover, every
              output token for token the fault-free run's on one replica,
              the survivors leak nothing and capture nothing twice; (c)
              ``repro_torch.benchmarks.fabric`` (three worker processes
              sharing the card, one SIGKILLed mid-burst, outputs equal to
              the parent's oracle), then a fault-free fabric burst with the
              default health ladder and waits: no health transition, no
              failover; (d) ``repro_torch.benchmarks.fault_tolerance`` at
              its reference size.  Each part prints tokens/s, TTFT p50/p95,
              the decode gap p95, recovery_wall_s, peak device memory and
              its wall time;
18. MoE serving, qwen3-moe-30b-a3b at full width and depth (48 layers,
              128 experts top-8, 61.09 GB of bf16 weights drawn on the
              card at seed 0, one copy resident at a time): (a) the
              launcher ``--paged --max-slots 8 --max-seq-len 1024
              --requests 8 --max-new 32 --shared-prefix 256 --greedy``;
              (b) the scheduler and engine on phase 5 (b)'s workload:
              every round a replay of one of two programs, each captured
              once, exactly 48 paged-decode launches a decode round, 48
              tensor-core prefills a prefill round and 97 one-pass
              RMSNorms a round, prefix hits, no leaks; (c) one B = 8
              decode round at contexts 512-2048, replayed and eager (bit
              for bit), timed with CUDA events, 5 served steps profiled
              (kernels a step, busy share) and one eager step's device
              time split into expert GEMMs, dispatch, attention and the
              rest; (d) dense int8 on phase 6's first 4 prompts: exactly
              48 int8 launches and 97 RMSNorms a step, no other attention
              kernel; (e) card against CPU at 2 layers on weights copied
              from the card: last logits within ``CPU_LOGIT_TOL``, 4
              equal greedy tokens, and per layer the share of (token, k)
              expert choices that agree on the same layer inputs, with
              the smallest top-K margin.  Init seconds, weight bytes,
              peaks, tokens/s, TTFT and decode gap are printed.
19. qwen2-vl-72b at full width (d 8,192, 64 / 8 heads of 128, vocab
              152,064, M-RoPE, 256 patch embeddings; weights drawn on
              the card at seed 0): (a) training through
              ``stepfn.make_train_step`` (the launcher's step, AdamW in
              place)
              at 1 layer (2 exceed the card's 79 GiB: ``PERF.md`` §4):
              AdamW, B 2, S 1,024 (256 patches + 768 text), remat, 8
              steps, step ms, tokens/s, peak, exactly 2 flash and 4 + 1
              one-pass RMSNorm launches a layer a step, the loss
              falling; the launcher ``--smoke`` on the card; (b) paged
              serving at 32 layers (61.2 GB) through the scheduler and
              engine on phase 5 (b)'s workload: 32 paged-decode / 32
              tensor-core prefill launches a replay, 65 one-pass
              RMSNorms a round, prefix hits, no leak, two captures; a
              B = 8 decode round replayed == eager, timed against every
              weight read once; (c) card against CPU at 2 layers:
              text logits with the patch prefix and M-RoPE within
              ``CPU_LOGIT_TOL``, the loss within ``TRAIN_LOSS_RTOL``,
              4 equal greedy tokens of a paged serve;
20. whisper-small whole (12 + 12 layers, d 768, 1,500 frames): (a) the
              launcher ``--seq-len 448 --global-batch 8 --steps 8``:
              exactly 72 flash launches a step (48 without the causal
              mask), the loss falling; (b) dense serving through the
              scheduler and engine, bf16 then int8 KV: 8 requests, each
              with its own frames, 4-token prompts, 64 new tokens, 8
              slots of 448; exact launches (one cross-attention flash a
              layer a step, 12 encoder flashes a request, one int8 call
              a layer a step in int8), two captures, the encoder's ms a
              request, a B = 8 decode round replayed == eager; paged
              mode refused; (c) card against CPU at full depth, bf16
              and int8: equal greedy tokens, last prompt logits within
              ``CPU_LOGIT_TOL``, other frames other tokens.
21. sharded training at full width, cut in depth (weights drawn on the
              card at seed 0, f32 masters, AdamW in place at lr 1e-4): (a)
              gemma2-27b at 2 layers (one local / global pair; d 4,608,
              32 / 16 heads of 144, vocab 256,000, softcaps 50 / 30), (b)
              deepseek-coder-33b at 4 (56 / 8 heads of 128, d 7,168), (c)
              qwen3-moe-30b-a3b at 2 (128 experts top-8, the aux loss in
              the loss), each through the launcher's step
              (``stepfn.make_train_step``, ``family_batch``) on
              ``launch.mesh.make_host_mesh``'s (1, 1) groups under the
              config's default strategy (``fsdp_tp``), B 2 x S 2,048, 8
              steps: step ms, tokens/s, peak, the loss falling, exactly
              2 L flash launches a step (all tensor cores; gemma2's all
              through the D tail's 160), 2 x (2 or 4) L + 1 one-pass
              RMSNorms, the data group's all_gathers and reduce_scatters a
              step exactly the specs' (``sharded_data_formula``), the data
              and model groups' collectives printed; (d) the D 160 route
              with gemma2-27b's window 4,096 and softcap 50 at (1, 8,192,
              32 / 16, 144), where the window binds, and at (a)'s shape:
              within the tensor-core bound, the D-tail and window broken
              variants above it, gradients, timed beside SDPA, the plain
              version and the bound; (e) card against CPU, from f32
              weights drawn on the CPU at seed 1, at
              ``SHARDED_CPU_LAYERS`` (gemma2-27b's 2 layers,
              deepseek-coder-33b's and qwen3-moe's cut to 1 to keep the
              script within its time limit),
              one ``fsdp_tp`` step at ``SHARDED_CPU_SEQ``, batch 1:
              loss and
              gradient norm within the phase 9 tolerances; (f) qwen2-0.5b
              at full width on the (1, 1) mesh: ``dp_tp`` and ``fsdp_tp``
              against ``dp`` after 2 steps (losses within
              ``TRAIN_LOSS_RTOL``, params within ``AT_ONE_PARAM_ATOL``;
              ``dp_tp`` and ``fsdp_tp`` bit for bit), then the launcher
              with no ``--strategy`` (its reference default, ``dp_tp``):
              step time beside phase 8's ``dp`` run.
22. the steps by input shape (``stepfn.make_step_for_shape``) on the
    (1, 1) mesh under the config's default strategy (``dp_tp``), weights
    from ``init_params`` at seed 0 (f32, drawn on the card), inputs from
    ``synthesize_inputs`` (drawn on the card): (a) qwen2-0.5b whole (24
    layers, d 896) at ``decode_32k`` (B 128 x 32,768: 51.5 GB of bf16
    cache, then the int8 cache), ``long_500k`` (B 1 x 524,288, window
    8,192) — eight serve steps each from 8 before the end of the cache —,
    ``prefill_32k`` whole (B 32 x 32,768) and
    ``train_4k`` with its batch cut from 256 to ``STEP_TRAIN_B`` (the f32
    logits of 256 x 4,096 x 151,936 words do not fit): ms a step,
    tokens/s, the peak, exact launches a step (flash 24 a prefill, 48 a
    train step; int8 24 a serve step; RMSNorm 49, 97 in training); (b)
    deepseek-coder-33b at full width cut to ``STEP_DEEPSEEK_LAYERS``
    layers at ``long_500k``, the window on every layer; (c) the window is
    real: at qwen2's ``long_500k`` the cache positions older than
    ``pos - 8,191`` filled with garbage leave the logits bit for bit with
    ``long_context`` and move them without it; (d) card against CPU at 2
    layers: the prefill step and the serve step (bf16 and int8 caches)
    within ``CPU_LOGIT_TOL``; (e) the dry-run (``launch.dryrun.
    count_step``, on ``meta``) of (a)'s four step kinds at (1, 1):
    ``argument_size`` equal to the bytes handed to the step, and
    ``peak_memory_per_device`` within ``DRYRUN_PEAK_RTOL`` of the card's
    peak over a step (``max_memory_allocated`` after
    ``reset_peak_memory_stats`` with the arguments resident, less what
    else was resident), both printed with the gap.  After each step of
    (a) and (b), every kernel it launched is held against its plain
    version at the step's shape, at phase 3's tolerances, with phase 3's
    broken variants failing: the int8 kernel on layer 0's cache as the
    step left it (B 128 x 32,768, the split plan of that shape) with a
    query at the timed positions and at positions spread over the
    stripe; flash at prefill's (1, 32,768, 14 / 2,
    64) on its first 512 and last 2,048 query rows (the plain version
    chunked by query rows) and at train's (2, 4,096) whole with its
    gradients; RMSNorm at the step's rows.
23. the chunked cross-entropy sharded, ``remat_policy``, the examples
    (weights from ``init_params`` at seed 0, drawn on the card): (a)
    gemma2-27b at 2 layers under ``fsdp_tp`` (the tied vocabulary of
    256,000) and qwen3-moe-30b-a3b at 2 under ``dp_tp`` (the untied
    head, the aux loss), B 2 x S 2,048 at ``seq_chunk`` 512, and
    qwen2-0.5b whole under ``dp`` at B 8 x S 1,024 at ``seq_chunk`` 256,
    on the (1, 1) mesh, the plain loss against
    ``loss_variant="chunked_ce"`` (``make_step_for_shape``): at the same
    params and batch the losses within ``CHUNK_LOSS_RTOL`` (and three
    broken chunked losses, ``chunk_faults``, above it) and the
    gradients' global norms within ``CHUNK_GNORM_RTOL``, then one timed
    step each: ms, the card's peak beside the dry-run's (``count_step``
    with the same options, within ``DRYRUN_PEAK_RTOL``,
    ``argument_size`` exact, where its peak is reached); where the f32
    logits set the step's peak (qwen2-0.5b) the chunked peak at least one
    (B, S, V) f32 logits tensor below the plain one on the card and in
    the dry-run, elsewhere the chunked dry-run peak not above the plain
    one; exact flash and RMSNorm launches; (b) ``remat_policy``
    ``"dots"`` against ``"nothing"``: qwen2-0.5b's ``dp`` step at B 8 x
    S 1,024 and qwen3-moe at 2 layers under ``fsdp_tp`` at B 2 x S
    2,048: from the same params and batch the loss and every gradient
    bit for bit (else within ``TRAIN_LOSS_RTOL`` / ``GRAD_TOL``), the
    forward products the backward re-ran (none under ``"dots"``), then
    one timed step of the launcher's step each: ms, peak, equal
    launches; (c) the three examples in this process through their
    ``main(argv)``: ``torch_train_lm`` at ``LM_EXAMPLE_ARGS`` for 30
    steps with a checkpoint at 15, then resumed from it (its steps 15-29
    within ``TRAIN_LOSS_RTOL`` of the first run's, "(DOWN)" both times,
    20 flash launches a step), ``torch_serve_lm --chat --turns 3``
    (paged kernels launched, prefix hits), ``torch_train_3dgan --steps
    5`` in its capsule (img/s, "capsule run complete").  After each
    example every kernel it launched is held against its plain version
    at its shapes, at phase 3's tolerances, with phase 3's broken
    variants failing (``hold_lm_example``: flash whole with its
    gradients, RMSNorm at its rows; ``hold_serve_example``: paged decode
    and prefill at the smoke widths, the turns' contexts and chunks);
    the readings go into the kernels line (``example_shapes``).
24. gemma2-2b at full width and depth (26 layers, d 2,304, 8 / 4 heads of
    288, vocab 256,000, window 4,096 on the 13 local layers, softcaps 50 /
    30, tied embedding; weights from ``init_params`` at seed 0): (a) the
    launcher ``--arch gemma2-2b --seq-len 2048 --global-batch 2 --steps
    8`` (its default ``dp_tp`` on the (1, 1) mesh): losses finite and
    falling, exactly 52 flash launches a step, all on the tensor-core
    counter, and 209 one-pass RMSNorms (4 a layer twice, remat, and the
    final one); step ms, tokens/s, the launcher's peak; the same step
    again from weights drawn on the card: its peak measured as phase 22
    does beside the dry-run's (``count_step`` on ``meta``), then one step
    under ``torch.profiler``; (b) flash at D 288 (``GEMMA_FLASH_SETS``: (a)'s
    (2, 2,048), and (1, 8,192) with the window 4,096 and without,
    softcap 50): within the 2^-8 bound, the lse, gradients through the
    autograd Function, broken variants above the bound (the causal mask
    one key late, the last partial 32-key tile dropped, the kv head, l
    not rescaled, the window one key wider or narrower), timed beside
    the CUDA-core route at the same inputs (which must be slower), SDPA
    (causal only), the plain version and the bound; (c) paged serving:
    the launcher at phase 5 (a)'s flags, then the scheduler and engine
    with 8 greedy prompts of 4,200-6,000 tokens sharing a 256-token
    prefix in 8,192-position slots (the window binds), 32 new tokens
    each: every round a replay of one of two programs, each captured
    once, exactly 26 paged-decode launches a decode round and 26
    tensor-core prefills a prefill round (none on the CUDA-core kernel),
    105 one-pass RMSNorms a round, prefix hits, no leak; a B = 8 decode
    round at contexts 4,200-6,000 replayed == eager, timed against every
    weight read once; (d) dense serving on phase 6's workload, int8 (26
    int8 launches a step, no other attention kernel) then bf16, the KV
    bytes ratio; (e) card against CPU at 2 layers on weights copied from
    the card: paged and dense int8 last logits within ``CPU_LOGIT_TOL``
    and 4 equal greedy tokens, one train step (seq ``GEMMA_CPU_SEQ``,
    batch 1) within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GNORM_RTOL``; (f) after
    (a), (c) and (d) the kernels they launched held at their shapes
    (RMSNorm at the step's rows, flash there being (b)'s; paged decode
    and prefill at the engine's D 288 tiles; the int8 kernel at B 4 over
    1,024-position stripes) at phase 3's tolerances, broken variants
    failing.  Phase 4 times the four attention kernels at gemma2-2b's
    shapes (``gemma2_kernel_times``), the CUDA-core flash and prefill at
    the same inputs beside them.

The CPU halves of the card-against-CPU checks (phases 7, 9, 11, 13, 14,
19 (c), 20 (c), 21 (e) and 24 (e)) run in one spawned process (``CpuSide``,
on ``CPU_SIDE_THREADS`` of the host's cores) while the card's phases go
on, on the same weights in shared memory.  The weights that phases 9, 11,
13, 14 and 24 (e) draw on the CPU (``CPU_WEIGHTS``) are drawn there while
phases 2-4 run; phase 21 (e)'s CPU steps, on weights drawn there as well
(``fsdp_draw_step``), are queued after phase 4 and read in phase 21.
Phase 24 (e) queues its serving halves in (c) and reads them in (e); the
other pairs are checked when the CPU's half is done (at the next phase's
start, or at the end).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero before
printing any result.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
KERNEL_TOL = 2e-2              # bf16 output: one bf16 ulp at |x| ~ 4, plus
                               # f32 summation order; outputs are convex
                               # mixes of N(0, 1) values
CPU_LOGIT_TOL = 5e-2           # 24 layers of bf16 GEMMs summed in another
                               # order (cuBLAS vs CPU), logits of std ~0.6
LSE_TOL = 1e-3                 # f32 logsumexp, summed in another order
INT8_BF16_RTOL = 2.0 ** -7     # the int8 kernel's bf16 output, element
INT8_FLOOR = 2.0 ** -4         # by element: |got - plain| <= RTOL x
                               # max(|plain|, FLOOR), one bf16 ulp (f32
                               # sums in another order can flip a rounding;
                               # 4.9e-4 absolute below |plain| 1/16)
INT8_F32_TOL = 1e-5            # the int8 kernel with f32 q and scales,
                               # absolute: f32 sums and exps in another order
NORM_F32_RTOL = 1e-6           # RMSNorm's f32 output, relative: the same f32
                               # products, the sum of squares in another
                               # order and rsqrtf (a few f32 roundings); its
                               # bf16 output is held to one ulp, as int8's
GRAD_TOL = 2e-2                # max |grad err| / max |grad|: bf16 grads
                               # (one ulp is 2**-8 = 3.9e-3 relative) from
                               # f32 sums in another order
TRAIN_LOSS_RTOL = 1e-3         # one train step, card vs CPU: a mean over
                               # 254 token losses of bf16-computed logits
TRAIN_GNORM_RTOL = 2e-2        # the gradient's global norm, same step
AT_ONE_PARAM_ATOL = 1.2012e-3  # dp against dp_tp / fsdp_tp at (1, 1) after
                               # 2 AdamW steps at lr 3e-4: the
                               # cross-entropies round differently
                               # (log_softmax against a max and a sum of
                               # exponentials), and AdamW moves an entry by
                               # up to lr |m^| / sqrt(v^) a step whatever
                               # its gradient's size (at most 1 at step 1,
                               # 1.0003 at step 2), so an entry whose
                               # gradient is near 0 may move either way:
                               # two runs part by at most 4.004 lr
# 3DGAN, card against CPU: three (D, G) RMSProp step pairs in f32 (cuDNN
# with TF32 off on the card, PyTorch's native convolutions on the CPU,
# ``models/gan3d.py::_ieee_f32``: the same sums in another order; these
# bounds were set before the first run on the card and have not moved;
# on the CPU the port and the reference's XLA convolutions gave
# losses within 1e-7 relative, gradients within 7e-6 of each leaf's largest
# and parameters within 1.8e-6 after three pairs).  RMSProp moves an entry
# by lr g / (sqrt(nu) + 1e-8), about lr sign(g) / sqrt(0.1) in the first
# step whatever small error g carries, so the parameters agree to rounding
# except entries whose gradient lies within rounding of 0 (or near eps),
# which may move apart by up to 2 lr / sqrt(1 - 0.9) a step.  Hence: every
# entry within 3 x 2 x lr / sqrt(0.1) (the most three pairs can part
# them), and at most a 1e-3 share of each tree's entries beyond 1e-5.
GAN_LOSS_RTOL = 1e-4           # d_loss, g_loss at each pair (f32 means)
GAN_TOTAL_E_RTOL = 1e-3        # fake_total_e: 25^3 positive cells an image,
                               # moved 2.5e-5 by the eps-region entries on
                               # the CPU against XLA
GAN_PARAM_ATOL = 1e-5
GAN_PARAM_SHARE = 1e-3
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# The SSD scan's and RMSNorm's bf16 outputs reach |y| ~ 20 and ~ 6, where
# one bf16 ulp is 0.125 and 3.1e-2: their error is taken element by
# element as |got - plain| / max(1, |plain|) against KERNEL_TOL (2.5-5
# ulps relative above 1, 2e-2 absolute below; f32 sums in another order can
# flip a rounding)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()
CPU_SIDE = None                # the running CpuSide, set by main


def phase(name: str) -> None:
    if CPU_SIDE is not None:
        CPU_SIDE.poll()
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# the CPU halves of the card-against-CPU checks, beside the card's phases
# ---------------------------------------------------------------------------

CPU_SIDE_THREADS = 6           # of the host's 8 cores; the rest drive the card


def cpu_worker(jobs, done, threads: int, src: str) -> None:
    """Run ``CpuSide``'s jobs one at a time on the CPU: ``(i, name, kw)``
    calls ``name(torch, "cpu", **kw)`` and answers ``(i, result, error,
    seconds)``; ``None`` ends it.  The card is hidden from this process."""
    import os
    import traceback
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(threads)
    while True:
        job = jobs.get()
        if job is None:
            return
        i, name, kw = job
        t0 = time.perf_counter()
        try:
            done.put((i, globals()[name](torch, "cpu", **kw), None,
                      time.perf_counter() - t0))
        except BaseException:
            done.put((i, None, traceback.format_exc(),
                      time.perf_counter() - t0))
        del job, kw


class CpuSide:
    """One spawned process that runs the CPU halves of the card-against-CPU
    checks while the card's phases go on.  ``submit`` queues a job (its
    tensors go in shared memory, see ``shared_cpu``) with the function that
    checks its result against the card's; ``poll`` runs the checks of the
    jobs that are done, ``close`` waits for the rest and stops the
    process.  A job that raised, or a process that died, fails the run."""

    def __init__(self, threads: int = CPU_SIDE_THREADS):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.jobs, self.done = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=cpu_worker, daemon=True,
                                args=(self.jobs, self.done, threads,
                                      str(SRC)))
        self.proc.start()
        self.finish = {}
        self.checked = set()
        self.kept = {}
        self.report = {}
        self.waited_s = 0.0

    def submit(self, label: str, name: str, finish, **kw) -> None:
        i = len(self.finish)
        self.finish[i] = (label, finish)
        self.jobs.put((i, name, kw))
        print(f"{label}: the CPU half queued (CPU-side job {i})", flush=True)

    def _take(self, block: bool) -> bool:
        import queue
        try:
            i, res, err, s = self.done.get(timeout=5 if block else 0.001)
        except queue.Empty:
            check(self.proc.is_alive(), "the CPU-side process died with "
                  f"{len(self.finish) - len(self.checked)} jobs open")
            return False
        label, finish = self.finish[i]
        self.checked.add(i)
        check(err is None, f"{label}: the CPU half raised:\n{err}")
        print(f"{label}: the CPU half took {s:.1f} s (done at "
              f"{time.perf_counter() - _T0:.1f} s)", flush=True)
        self.report[label] = dict(finish(res) or {}, cpu_s=s)
        return True

    def prefetch(self, label: str, name: str, **kw) -> None:
        """Queue a job whose result ``fetch(label)`` hands back."""
        self.submit(label, name, lambda res: self.kept.__setitem__(label,
                                                                   res), **kw)

    def fetch(self, label: str):
        while label not in self.kept:
            self._take(True)
        return self.kept.pop(label)

    def poll(self) -> None:
        while len(self.checked) < len(self.finish) and self._take(False):
            pass

    def close(self) -> None:
        t0 = time.perf_counter()
        while len(self.checked) < len(self.finish):
            self._take(True)
        self.waited_s = time.perf_counter() - t0
        self.jobs.put(None)
        self.proc.join(60)
        check(self.proc.exitcode == 0, "the CPU-side process did not stop")


# the card-vs-CPU checks whose weights are drawn on the CPU (seed 1):
# (arch, layers, f32 weights), drawn by CpuSide while phases 2-6 run
CPU_WEIGHTS = (("qwen2-0.5b", 2, True), ("mamba2-1.3b", 2, True),
               ("zamba2-1.2b", 8, True), ("zamba2-1.2b", 8, False),
               ("mamba2-1.3b", 4, False), ("gemma2-2b", 2, True))


def weights_label(arch: str, layers: int, f32: bool) -> str:
    return (f"{arch} {layers}-layer weights ({'f32' if f32 else 'bf16'}, "
            "CPU seed 1)")


def draw_weights(torch, where, arch: str, layers: int, f32: bool):
    """``init_params`` of ``arch`` cut to ``layers`` on the CPU's
    generator at seed 1 (f32 leaves, or the config's dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    return T.init_params(get_config(arch).with_(num_layers=layers),
                         torch.Generator().manual_seed(1),
                         weight_dtype=torch.float32 if f32 else None)


def shared_cpu(torch, tree):
    """``tree``'s tensors copied once into shared host memory, for a
    ``CpuSide`` job (no further copy on the way)."""
    def one(t):
        c = torch.empty(t.shape, dtype=t.dtype).share_memory_()
        return c.copy_(t)
    return _map(tree, one)


def engine_greedy(torch, where, cfg, params, prompt, *, new: int,
                  generate: bool, engine_kw: dict, frames=None,
                  other_frames=None):
    """One request on a one-slot ``ServingEngine`` on ``where`` (it copies
    ``params`` there): the prompt's last logits, then ``new`` greedy
    tokens, through ``generate`` after the slot is freed, or decoded in
    the prompt's slot.  ``other_frames``: the same request's tokens on
    other encoder frames (encdec), or None."""
    import numpy as np
    from repro_torch.serving import Request, SamplingParams, ServingEngine
    e = ServingEngine(cfg, params, max_seq_len=64, max_slots=1,
                      device=where, **engine_kw)
    slot, last = (e.prefill_into_slot(prompt) if frames is None
                  else e.prefill_into_slot(prompt, frames))

    def request(enc):
        return Request(prompt, SamplingParams(max_new_tokens=new,
                                              greedy=True),
                       encoder_input=enc)
    if generate:
        e.free_slot(slot)
        toks = e.generate([request(frames)])[0].tolist()
    else:
        logits, toks = torch.from_numpy(last)[None], []
        for i in range(new):
            t = e.sample_tokens(logits, np.ones(1, np.float32),
                                np.ones(1, bool))
            toks.append(int(t[0]))
            logits = e.decode_once(t, np.array([len(prompt) + i], np.int32))
    other = (None if other_frames is None
             else e.generate([request(other_frames)])[0].tolist())
    return last, toks, other


def engine_pair(label: str, lg, tg, shape, *, diff_name: str = "last "
                "logits", extra: str = ""):
    """The check of ``engine_greedy``'s CPU result against the card's
    ``(lg, tg)``: finite logits of ``shape`` within ``CPU_LOGIT_TOL`` and
    the same greedy tokens."""
    import numpy as np

    def finish(res):
        lc, tc, _ = res
        check(np.isfinite(lg).all() and lg.shape == shape,
              f"{label}: card logits not finite or of the wrong shape")
        diff = float(np.abs(lg - lc).max())
        print(f"{label}, card vs CPU: {diff_name} max |diff| {diff:.3e} (tol "
              f"{CPU_LOGIT_TOL}); greedy card {tg} cpu {tc}{extra}",
              flush=True)
        check(diff <= CPU_LOGIT_TOL, f"{label}: card and CPU logits "
              "disagree")
        check(tg == tc, f"{label}: card and CPU greedy tokens differ")
        return dict(logit_diff=diff, tokens_card=tg, tokens_cpu=tc)
    return finish


def train_step_metrics(torch, where, cfg, params, seq: int, batch: int):
    """One AdamW train step of ``cfg`` (the launcher's ``dp`` step at world
    size 1, NCCL or gloo) on ``where`` from ``params`` (copied there; on
    the CPU updated in place): (loss, gradient norm)."""
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    data = SyntheticTokenSource(TokenDatasetSpec(
        cfg.vocab_size, seq, batch)).batch(0)
    p = optim.tree_map(lambda t: t.to(where), params)
    o = optim.adamw(3e-4, clip_norm=1.0)
    with hvd.init(where):
        _, _, m = stepfn.make_train_step(
            cfg, o, hvd.axis_groups({"data": 1}), device=where)(
                p, o.init(p), data)
    return float(m["loss"]), float(m["grad_norm"])


def fsdp_step_metrics(torch, where, cfg, params, seq: int, batch: int):
    """One SGD ``fsdp_tp`` step of ``cfg`` on the (1, 1) host mesh on
    ``where`` from ``params`` (already there; updated in place): (loss,
    gradient norm, seconds)."""
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    data = SyntheticTokenSource(TokenDatasetSpec(
        cfg.vocab_size, seq, batch)).batch(0)
    t0 = time.perf_counter()
    o = optim.sgd(3e-4, clip_norm=1.0)
    with hvd.init(where):
        groups = make_host_mesh()
        p, s = stepfn.shard_state(params, cfg, o, "fsdp_tp", groups)
        _, _, m = stepfn.make_train_step(
            cfg, o, groups, strategy="fsdp_tp", device=where)(p, s, data)
    return (float(m["loss"]), float(m["grad_norm"]),
            time.perf_counter() - t0)


def vlm_forward_greedy(torch, where, cfg, params, batch, prompt):
    """qwen2-vl on ``where`` (``params`` copied there): the text positions'
    logits and the loss of ``batch``, then 4 greedy tokens of ``prompt``
    through a one-slot paged engine."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, SamplingParams, ServingEngine
    p = _map(params, lambda t: t.to(where))
    b = {k: v.to(where) for k, v in batch.items()}
    P = cfg.num_patches
    with torch.no_grad():
        logits = T.forward(p, cfg, b)[0][0, P:].float().cpu()
        loss = float(T.lm_loss(p, cfg, b)[0])
    e = ServingEngine(cfg, p, max_seq_len=64, max_slots=1, paged=True,
                      prefill_batch=1, device=where)
    toks = e.generate([Request(prompt, SamplingParams(
        max_new_tokens=4, greedy=True))])[0].tolist()
    return logits, loss, toks


# ---------------------------------------------------------------------------
# kernel inputs, plain versions, library yardsticks
# ---------------------------------------------------------------------------

def decode_case(torch, rng, dev, *, B, KV, G, D, page, lengths, window=None,
                softcap=None, garbage=True, dtype="bfloat16"):
    """Random decode inputs in ``dtype`` with ragged ``lengths``; each row
    owns its own pages; entries past a row's extent name the trash page
    (the last) or, with ``garbage``, out-of-range ids the kernel must clamp
    and mask."""
    pps = max(1, -(-max(lengths) // page))
    NP = B * pps + 1
    tables = rng.permutation(NP - 1)[:B * pps].reshape(B, pps)
    for b, n in enumerate(lengths):
        used = -(-n // page)
        tables[b, used:] = NP - 1
        if garbage and used < pps:
            tables[b, pps - 1] = NP + 5 + b          # clamped, masked
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dt,
                                 device=dev)
    return dict(q=mk(B, KV, G, D), k_pages=mk(NP, page, KV, D),
                v_pages=mk(NP, page, KV, D),
                block_tables=torch.tensor(tables, dtype=torch.int32,
                                          device=dev),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
                window=window, softcap=softcap)


def prefill_case(torch, rng, dev, *, B, KV, G, D, page, C, starts, q_lens,
                 window=None, softcap=None, dtype="bfloat16"):
    ends = [s + C for s in starts]
    case = decode_case(torch, rng, dev, B=B, KV=KV, G=G, D=D, page=page,
                       lengths=ends, window=window, softcap=softcap,
                       dtype=dtype)
    case["q"] = torch.tensor(rng.standard_normal((B, KV, C * G, D)),
                             dtype=getattr(torch, dtype), device=dev)
    case.pop("lengths")
    case["start_pos"] = torch.tensor(starts, dtype=torch.int32, device=dev)
    case["q_lens"] = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    case["group"] = G
    return case


def gather_dense(torch, pages, tables):
    NP, page, KV, D = pages.shape
    B, pps = tables.shape
    idx = tables.long().clamp(0, NP - 1).reshape(-1)
    return pages.index_select(0, idx).reshape(B, pps * page, KV, D)


def library_decode(torch, F, case):
    """One library call for the same function: gather the pages dense,
    then scaled_dot_product_attention with a length/window mask (no
    softcap support there, so it is timed only where softcap is None)."""
    q, tables, lengths = case["q"], case["block_tables"], case["lengths"]
    B, KV, G, D = q.shape
    k = gather_dense(torch, case["k_pages"], tables).permute(0, 2, 1, 3)
    v = gather_dense(torch, case["v_pages"], tables).permute(0, 2, 1, 3)
    T = k.shape[2]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if case["window"]:
        mask &= (lengths[:, None] - 1 - kpos) < case["window"]
    out = F.scaled_dot_product_attention(
        q.reshape(B, KV * G, 1, D), k, v, attn_mask=mask[:, None, None, :],
        enable_gqa=True)
    return out.reshape(B, KV, G, D)


def library_prefill(torch, F, case):
    q, tables = case["q"], case["block_tables"]
    B, KV, CG, D = q.shape
    G = case["group"]
    C = CG // G
    k = gather_dense(torch, case["k_pages"], tables).permute(0, 2, 1, 3)
    v = gather_dense(torch, case["v_pages"], tables).permute(0, 2, 1, 3)
    T = k.shape[2]
    qh = q.reshape(B, KV, C, G, D).permute(0, 1, 3, 2, 4).reshape(
        B, KV * G, C, D)
    qpos = case["start_pos"][:, None] + torch.arange(C, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if case["window"]:
        mask &= (qpos[:, :, None] - kpos[None, None, :]) < case["window"]
    out = F.scaled_dot_product_attention(qh, k, v, attn_mask=mask[:, None],
                                         enable_gqa=True)
    return out.reshape(B, KV, G, C, D).permute(0, 1, 3, 2, 4).reshape(
        B, KV, CG, D)


def flash_case(torch, rng, dev, *, B, S, H, KV, D, window=None,
               softcap=None):
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                                 device=dev)
    return dict(q=mk(B, S, H, D), k=mk(B, S, KV, D), v=mk(B, S, KV, D),
                dout=mk(B, S, H, D), kw=dict(causal=True, window=window,
                                             softcap=softcap))


def unembed_split_cases(torch, dev, *, rows: int = 32 * 1023,
                        vocab: int = 151_936, d: int = 896,
                        seed: int = 3) -> list:
    """The tied unembedding's backward split at the training cell's shape:
    the cotangent the cross-entropy hands it (softmax minus one-hot over
    the rows) of (rows x vocab) f32 logits drawn at qwen2-0.5b's scale
    (std 0.6), and two cases of it, each ``g`` with its two outputs
    ``out`` and ``out_plain``: the second chunk of
    ``unembed.chunk_cols(rows, d)`` columns (row stride ``vocab``; the
    kernel's vector route), and that chunk one column on and one column
    shorter (unaligned start, odd width: the scalar route)."""
    from repro_torch.kernels import unembed as ue
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = torch.empty((rows, vocab), dtype=torch.float32, device=dev)
    for r0 in range(0, rows, 4096):
        blk = full[r0:r0 + 4096]
        n = blk.shape[0]
        blk.copy_(torch.softmax(0.6 * torch.randn(
            (n, vocab), generator=gen, device=dev), -1))
        blk[torch.arange(n, device=dev), torch.randint(
            0, vocab, (n,), generator=gen, device=dev)] -= 1
    full.div_(rows)
    cols = ue.chunk_cols(rows, d)
    cases = []
    for g in (full[:, cols:2 * cols], full[:, cols + 1:2 * cols]):
        mk = lambda: torch.empty((rows, 3, g.shape[1]),
                                 dtype=torch.bfloat16, device=dev)
        cases.append(dict(g=g, out=mk(), out_plain=mk()))
    return cases


def library_flash(torch, F, case):
    """scaled_dot_product_attention on the same (causal, no window, no
    softcap) inputs, back in the model layout."""
    q, k, v = (case[n].transpose(1, 2) for n in "qkv")
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True).transpose(1, 2)


def flash_cost(case):
    """(bytes, flops) of a causal flash call: the kernel's own count,
    ``flash_attention.cost``."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = case["q"].shape
    return fa.cost(B, S, case["k"].shape[1], H, case["k"].shape[2], D,
                   causal=True, window=case["kw"]["window"],
                   itemsize=case["q"].element_size())


def int8_case(torch, rng, dev, *, Sq, H, KV, D, Skv, q_start, kv_len,
              window=None, softcap=None, dtype="bfloat16"):
    """Inputs of the int8 attention: q (B, Sq, H, D) and K/V (B, Skv, KV,
    D) drawn N(0, 1) in ``dtype``, K/V quantized per (token, kv head).
    bf16: with the model's quantizer (``attention.quantize_kv``, bf16
    scales), as the serving path writes its cache; f32: with f32 scales,
    as the TPU kernel's own test quantizes."""
    from repro_torch.models.attention import quantize_kv
    dt = getattr(torch, dtype)
    B = len(q_start)
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dt,
                                 device=dev)

    def quant(x):
        if dt == torch.bfloat16:
            return quantize_kv(x)
        s = x.abs().amax(dim=-1) / 127.0 + 1e-8
        return torch.round(x / s[..., None]).to(torch.int8), s

    k8, ks = quant(mk(B, Skv, KV, D))
    v8, vs = quant(mk(B, Skv, KV, D))
    ints = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return dict(q=mk(B, Sq, H, D), k8=k8, k_scale=ks, v8=v8, v_scale=vs,
                q_start=ints(q_start), kv_len=ints(kv_len),
                kw=dict(window=window, softcap=softcap))


def int8_rel_err(got, ref) -> float:
    """max |got - ref| / max(|ref|, INT8_FLOOR), element by element."""
    g, r = got.float(), ref.float()
    return ((g - r).abs() / r.abs().clamp(min=INT8_FLOOR)).max().item()


def int8_args(case):
    return (case["q"], case["k8"], case["k_scale"], case["v8"],
            case["v_scale"], case["q_start"], case["kv_len"])


def int8_cost(case):
    """(bytes, flops) of an int8 call for this run's q_start and kv_len:
    the kernel's own count, ``flash_attention.int8_cost``."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, D = case["q"].shape
    Skv, KV = case["k8"].shape[1], case["k8"].shape[2]
    return fa.int8_cost(B, Sq, H, KV, D, Skv,
                        q_start=case["q_start"].tolist(),
                        kv_len=case["kv_len"].tolist(),
                        window=case["kw"]["window"],
                        itemsize=case["q"].element_size(),
                        scale_bytes=case["k_scale"].element_size())


def library_int8(torch, F, case, kd, vd):
    """scaled_dot_product_attention over K/V dequantized beforehand (kd,
    vd: (B, KV, Skv, D) in q's dtype, not timed) with the per-row length
    and causal mask: one PyTorch call, a yardstick the port never makes."""
    q = case["q"]
    B, Sq, H, D = q.shape
    Skv = kd.shape[2]
    qpos = case["q_start"][:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = (kpos[None, None, :] < case["kv_len"][:, None, None]) & (
        kpos[None, None, :] <= qpos[:, :, None])
    if case["kw"]["window"]:
        mask &= (qpos[:, :, None] - kpos[None, None, :]) < case["kw"][
            "window"]
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), kd, vd, attn_mask=mask[:, None], enable_gqa=True)
    return out.transpose(1, 2)


def dequantized_kv(case):
    """The yardstick's K/V: codes times scales, (B, KV, Skv, D) bf16."""
    return tuple((c.float() * s.float()[..., None]).bfloat16().transpose(1, 2)
                 .contiguous() for c, s in ((case["k8"], case["k_scale"]),
                                            (case["v8"], case["v_scale"])))


def ssd_case(torch, rng, dev, *, b, S, H, P, G, N):
    """SSD inputs in the model layout, x, B and C in bf16, dt and A f32:
    N(0, 1) x, B and C, dt = softplus(z), A = -exp(z) (slow decays: the
    carried state matters in every head)."""
    import numpy as np
    bf = lambda *sh: torch.tensor(rng.standard_normal(sh),
                                  dtype=torch.bfloat16, device=dev)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    dt = np.logaddexp(rng.standard_normal((b, S, H)), 0.0)
    A = -np.exp(rng.standard_normal(H))
    return dict(x=bf(b, S, H, P), dt=f32(dt), A=f32(A), B=bf(b, S, G, N),
                C=bf(b, S, G, N), dy=bf(b, S, H, P))


def mamba_scan_case(torch, rng, dev, *, b, S, seed, arch="mamba2-1.3b"):
    """What the first layer of a freshly initialised full-width ``arch``
    (mamba2-1.3b: N 128; zamba2-1.2b: N 64) feeds the SSD scan
    (``ssm.scan_inputs``: in_proj, causal conv, softplus dt) for unit-rms
    rows of bf16 input, as its pre-norm hands them over.  Its 64 heads
    decay from A = -1 to -64: exp(cum) underflows in most, the first ones
    carry the state across chunks."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(seed)
    p = ssm.init_mamba2(cfg, gen, device=dev, weight_dtype=torch.bfloat16)
    u = torch.randn((b, S, cfg.d_model), generator=gen).to(dev,
                                                           torch.bfloat16)
    with torch.no_grad():
        _, x, dt, A, B, C, _ = ssm.scan_inputs(p, cfg, u)
    dy = torch.tensor(rng.standard_normal(x.shape), dtype=torch.bfloat16,
                      device=dev)
    return dict(x=x.contiguous(), dt=dt.contiguous(), A=A.contiguous(),
                B=B.contiguous(), C=C.contiguous(), dy=dy)


def ssd_cost(case, chunk):
    """(bytes, flops) of one scan: the kernel's own count,
    ``ssd_scan.cost``."""
    from repro_torch.kernels import ssd_scan
    b, S, H, P = case["x"].shape
    G, N = case["B"].shape[2], case["B"].shape[3]
    return ssd_scan.cost(b, S, H, P, G, N, min(chunk, S),
                         case["x"].element_size())


def ssd_bound(ssd, args, chunk):
    """The plain output and the plain scan of |x|, |B| and |C| in f32 (the
    same dt and A: every decay is positive, so it bounds each output's sum
    of magnitudes, the carried state's included) for the SSD check."""
    x, dt, A, B, C = args
    return (ssd.ssd_scan_plain(*args, chunk),
            ssd.ssd_scan_plain(x.float().abs(), dt, A, B.float().abs(),
                               C.float().abs(), chunk))


def ssd_wrongs(ssd, ref, args, chunk):
    """Broken SSD scans, as plain versions on changed inputs and the
    tensor-core scan's decomposition (``ref.ssd_tiles_ref``) broken one way
    each: [(what, () -> y)].  ``args`` with S a multiple of the chunk; the
    group variant where G > 1."""
    x, dt, A, B, C = args
    b, S = x.shape[:2]
    G = B.shape[2]
    L = min(chunk, S)
    cut = lambda t: t.reshape(b * S // L, L, *t.shape[2:])
    out = [("dropped the state carried across chunks",
            lambda: ssd.ssd_scan_plain(cut(x), cut(dt), A, cut(B), cut(C),
                                       L).reshape(x.shape)),
           ("took dt 5% off", lambda: ssd.ssd_scan_plain(x, 1.05 * dt, A, B,
                                                         C, L))]
    for what in ref.SSD_WRONGS:
        if what != "group h % G" or G > 1:
            out.append((f"had {what}", lambda w=what: ref.ssd_tiles_ref(
                x, dt, A, B, C, L, wrong=w)))
    return out


def ulp_ratio(got, plain) -> float:
    """max |got - plain| / bound, element by element: one bf16 ulp,
    2^-7 max(|plain|, 2^-4), for a bf16 output; 1e-6 |plain| for f32.  A
    reading above 1 fails."""
    g, r = got.float(), plain.float()
    if got.element_size() == 2:                       # bf16
        bound = INT8_BF16_RTOL * r.abs().clamp(min=INT8_FLOOR)
    else:
        bound = NORM_F32_RTOL * r.abs() + 2.0 ** -30
    return ((g - r).abs() / bound).max().item()


def rmsnorm_wrongs(rn, ref, x, scale, out_dtype):
    """Broken one-pass RMSNorm kernels (``ref.rmsnorm_one_pass_ref`` at the
    kernel's plan): the gain read as scale; at d 4,096 also the row's last
    warp's partial left out of its sum; at d 2,304 (288 packs over 160
    threads) the row's last pack not written.  [(what, () -> y)]."""
    d = x.shape[-1]
    plan = rn.one_pass_plan(d)
    wrongs = ["gain read as scale"]
    if d == 4096:
        wrongs.append("one warp's partial left out")
    if d == 2304:
        wrongs.append("last pack not written")
    return [(w, lambda w=w: ref.rmsnorm_one_pass_ref(
        x, scale, out_dtype=out_dtype, plan=plan, wrong=w)) for w in wrongs]


def rmsnorm_cost(case):
    """(bytes, flops) of one call: the kernel's own count,
    ``rmsnorm.cost``."""
    from repro_torch.kernels import rmsnorm
    x = case["x"]
    return rmsnorm.cost(x.numel() // x.shape[-1], x.shape[-1],
                        x.element_size(),
                        2 if case["out_dtype"] == "bfloat16" else 4)


def norm_err(got, ref) -> float:
    """max |got - ref| / max(1, |ref|), element by element (bf16 outputs:
    one ulp is at most 2**-7 of |ref| above 1, at most 3.9e-3 below)."""
    r = ref.float()
    return ((got.float() - r).abs() / r.abs().clamp(min=1.0)).max().item()


def flash_bound(fa, q, k, v, kw):
    """What the flash check needs beside the kernel's output: the plain
    output, (|P| @ |V|) / l (the same attention over |V| in f32) and the
    relative rounding of P of the kernel that (dtype, D) routes to."""
    plain = fa.flash_attention_plain(q, k, v, **kw)[0]
    mix = fa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   **kw)[0]
    return plain, mix, fa.p_rounding(q.dtype, q.shape[-1])


def flash_wrongs(torch, fa, ref, q, k, v, kw, tile: Optional[int] = None):
    """Broken flash kernels, as plain versions on changed inputs (and the
    kernel's tile loop without rescaling l): [(what, () -> out)].  The
    causal ones where ``kw`` is causal without a window, the window ones
    where it has a window; l not rescaled in either.  ``tile``: the
    kernel's keys per tile (None: the tensor-core kernel's at this head
    dim, ``ref.tc_key_tile``)."""
    S, H, KV = q.shape[1], q.shape[2], k.shape[2]
    tile = tile or ref.tc_key_tile(q.shape[-1])
    plain = lambda qq, kk, vv, **o: fa.flash_attention_plain(
        qq, kk, vv, **dict(kw, **o))[0]
    no_rescale = ("did not rescale the running sum l",
                  lambda: ref.flash_tiles_ref(q, k, v, **kw, block_k=tile,
                                              rescale_l=False)[0])
    if kw.get("window"):
        w = kw["window"]
        return [("saw one key more than the window",
                 lambda: plain(q, k, v, window=w + 1)),
                ("saw one key less than the window",
                 lambda: plain(q, k, v, window=w - 1)), no_rescale]

    def late():
        # row i sees keys 0..i+1: row i + 1 of a query one row longer
        return plain(torch.cat([q[:, :1], q], dim=1), k, v)[:, 1:]

    def drop_tile():
        # a row with n keys, n > tile and not a tile multiple, drops its
        # last partial tile: rows 64m..64m+62 see keys [0, 64m) only
        out = plain(q, k, v).clone()
        for k1 in range(tile, S, tile):
            r1 = min(k1 + tile - 1, S)
            out[:, k1:r1] = plain(q[:, k1:r1], k[:, :k1], v[:, :k1],
                                  causal=False)
        return out

    def head():
        # GQA: head h reads kv head h % KV; MHA (h % KV is h): h + 1
        idx = (torch.arange(H, device=k.device) + (H == KV)) % KV
        return plain(q, k[:, :, idx].contiguous(), v[:, :, idx].contiguous())

    return [("applied the causal mask one key late", late),
            ("dropped each row's last partial kv tile", drop_tile),
            ("read kv head h % KV instead of h // G" if H > KV
             else "read kv head h + 1 instead of h", head), no_rescale]


def flash_pad_wrongs(torch, fa, q, k, v, kw):
    """Broken D-tail paths of the flash wrapper (a head dim that is not a
    multiple of 32 runs padded with zero columns, ``fa.run_padded``), as
    the plain version run through the padding: [(what, () -> out)]."""
    D = q.shape[-1]
    Dp = fa.padded_head_dim(D)
    g = torch.Generator(device=q.device).manual_seed(7)

    def junk(t):
        # the pad columns left as whatever memory held: N(0, 1)
        pad = torch.randn(t.shape[:-1] + (Dp - D,), generator=g,
                          device=t.device).to(t.dtype)
        return torch.cat([t, pad], dim=-1)

    return [("took the scale from the padded head dim",
             lambda: fa.flash_attention_plain(
                 q, k, v, scale=1.0 / math.sqrt(Dp), **kw)[0]),
            ("left the padded columns of q and k unzeroed",
             lambda: fa.flash_attention_plain(
                 junk(q), junk(k), junk(v), scale=1.0 / math.sqrt(D),
                 **kw)[0][..., :D])]


def cross_case(torch, rng, dev, *, B, Sq, Skv, H, KV, D, causal=False):
    """Flash inputs with Sq queries over Skv keys (bf16, N(0, 1)): the
    encdec encoder (square, not causal), cross-attention and its decode
    (Sq < Skv, not causal), or a causal square case."""
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                                 device=dev)
    return dict(q=mk(B, Sq, H, D), k=mk(B, Skv, KV, D), v=mk(B, Skv, KV, D),
                dout=mk(B, Sq, H, D), kw=dict(causal=causal, window=None,
                                              softcap=None))


def library_cross(torch, F, case):
    """scaled_dot_product_attention on the same inputs, causal as the case
    asks (``is_causal=False`` for the encoder and cross-attention), K/V
    shared per group (``enable_gqa``), back in the model layout."""
    q, k, v = (case[n].transpose(1, 2) for n in "qkv")
    return F.scaled_dot_product_attention(
        q, k, v, is_causal=case["kw"]["causal"], enable_gqa=True
    ).transpose(1, 2)


def cross_cost(case):
    """(bytes, flops) of a flash call with Sq queries over Skv keys, with
    or without the causal mask: ``flash_attention.cost``."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, D = case["q"].shape
    return fa.cost(B, Sq, case["k"].shape[1], H, case["k"].shape[2], D,
                   causal=case["kw"]["causal"],
                   itemsize=case["q"].element_size())


def cross_wrongs(torch, fa, q, k, v, kw, tile: int = 64):
    """Broken non-causal flash kernels, as plain versions on the same
    inputs: [(what, () -> out)]: the causal mask applied where none was
    asked; the last partial key tile dropped (Skv not a tile multiple);
    Skv taken as Sq (only the first Sq keys read, where Sq < Skv)."""
    Sq, Skv = q.shape[1], k.shape[1]
    plain = lambda qq, kk, vv, **o: fa.flash_attention_plain(
        qq, kk, vv, **dict(kw, **o))[0]
    out = [("applied a causal mask where none was asked",
            lambda: plain(q, k, v, causal=True))]
    full = Skv // tile * tile
    if 0 < full < Skv:
        out.append(("dropped the last partial key tile",
                    lambda: plain(q, k[:, :full], v[:, :full])))
    if Sq < Skv:
        out.append(("took Skv as Sq",
                    lambda: plain(q, k[:, :Sq], v[:, :Sq])))
    return out


# the flash kernel's new calls (whisper-small's, non-causal, MHA, D 64):
# the encoder (1,500 frames, not a multiple of the 64-row tile), training's
# cross-attention (448 decoder positions over 1,500 frames) and decode's
# (one query over 1,500)
CROSS_SETS = {
    "whisper encoder": dict(B=8, Sq=1500, Skv=1500, H=12, KV=12, D=64),
    "whisper cross": dict(B=8, Sq=448, Skv=1500, H=12, KV=12, D=64),
    "whisper decode cross": dict(B=8, Sq=1, Skv=1500, H=12, KV=12, D=64),
}


def check_cross(torch, fa, kops, kref, case):
    """The flash kernel on ``case`` against its plain version: the route
    (tensor cores for bf16, D <= 128), the output element by element
    within ``ref.rounding_bound_ratio``'s bound, the logsumexp within
    LSE_TOL, dQ/dK/dV through the autograd Function within GRAD_TOL of the
    largest; every broken variant of ``cross_wrongs`` above the bound.
    Returns {route, tensor_cores (the route the rule asks for), err,
    ratio, lse_err, grad_err, misses: {what: ratio}} for the caller to
    check."""
    qkv, kw = (case["q"], case["k"], case["v"]), case["kw"]
    n_tc = fa.flash_fwd_tensor_core.launches
    out, lse = fa.flash_attention(*qkv, **kw)
    torch.cuda.synchronize()
    tc = fa.flash_fwd_tensor_core.launches > n_tc
    ref, mix, p_rel = flash_bound(fa, *qkv, kw)
    _, ref_lse = fa.flash_attention_plain(*qkv, **kw)
    res = dict(route="tensor cores" if tc else "CUDA cores",
               err=(out.float() - ref.float()).abs().max().item(),
               ratio=kref.rounding_bound_ratio(out, ref, mix, p_rel),
               lse_err=(lse - ref_lse).abs().max().item())
    ins = [t.clone().requires_grad_(True) for t in qkv]
    got = torch.autograd.grad(kops.mha_flash_attention(*ins, **kw), ins,
                              case["dout"])
    ins = [t.clone().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw)[0], ins,
                               case["dout"])
    res["grad_err"] = max(((g.float() - r.float()).abs().max()
                           / r.float().abs().max()).item()
                          for g, r in zip(got, want))
    res["tensor_cores"] = tc == fa.tensor_core_route(out.dtype,
                                                     out.shape[-1])
    res["misses"] = {what: kref.rounding_bound_ratio(wrong(), ref, mix, p_rel)
                     for what, wrong in cross_wrongs(torch, fa, *qkv, kw)}
    return res


def sm_count(pa, t) -> int:
    """The SMs the split plans size a call on ``t``'s device by."""
    return pa.device_sm_count(t.device) if t.is_cuda else pa.SM_COUNT


def drop_first_live(torch, ranges):
    """A (B, splits) keep-mask for a broken combine: each batch row's first
    live partial (a split whose range is not None) left out, where the row
    has more than one (or where no row has: then every row's only one)."""
    live = [[i for i, r in enumerate(rs) if r is not None] for rs in ranges]
    multi = any(len(x) > 1 for x in live)
    keep = torch.ones((len(ranges), len(ranges[0])), dtype=torch.bool)
    for b, x in enumerate(live):
        if x and (len(x) > 1 or not multi):
            keep[b, x[0]] = False
    return keep


def decode_args(case):
    return (case["q"], case["k_pages"], case["v_pages"],
            case["block_tables"], case["lengths"])


def decode_bound(pa, case):
    """The plain output and (|P| @ |V|) / l for the decode check."""
    q, kp, vp, tb, ln = decode_args(case)
    kw = dict(window=case["window"], softcap=case["softcap"])
    return (pa.paged_attention_plain(q, kp, vp, tb, ln, **kw),
            pa.paged_attention_plain(q.float(), kp.float(), vp.float().abs(),
                                     tb, ln, **kw))


def decode_wrongs(torch, pa, ref, case):
    """Broken decode kernels, as plain versions on changed inputs and the
    split-and-combine version with a partial left out: [(what, () ->
    out)].  The window ones where the case has a window; the newest-key
    and trash-entry ones where it has none."""
    q, kp, vp, tb, ln = decode_args(case)
    w, sc = case["window"], case["softcap"]
    B, KV, _, D = q.shape
    page, pps = kp.shape[1], tb.shape[1]
    plain = lambda lengths=ln, window=w: pa.paged_attention_plain(
        q, kp, vp, tb, lengths, window=window, softcap=sc)
    per, splits = pa.split_plan(B, KV, pps, page, D, sm_count(pa, q),
                                q.element_size())
    keep = drop_first_live(torch, [ref.paged_split_ranges(
        n, per, splits, page, pps, w) for n in ln.tolist()])
    out = [("dropped one split's partial from the combine",
            lambda: ref.paged_attention_split_ref(
                q, kp, vp, tb, ln, pages_per_split=per, window=w,
                softcap=sc, keep=keep))]
    if w:
        return out + [("saw one key more than the window",
                       lambda: plain(window=w + 1)),
                      ("saw one key less than the window",
                       lambda: plain(window=w - 1))]
    used = (ln + page - 1) // page
    trash = torch.where((ln % page == 0) & (used < pps), ln + page, ln)
    return out + [("missed each row's newest key",
                   lambda: plain(lengths=(ln - 1).clamp(min=0))),
                  ("read the trash-block entry past a row unmasked",
                   lambda: plain(lengths=trash))]


def prefill_args(case):
    return (case["q"], case["k_pages"], case["v_pages"],
            case["block_tables"], case["start_pos"], case["q_lens"])


def prefill_bound(pp, case):
    """The plain output, (|P| @ |V|) / l and the relative rounding of P
    of the prefill kernel that (dtype, D) routes to."""
    q, kp, vp, tb, st, ql = prefill_args(case)
    kw = dict(group=case["group"], window=case["window"],
              softcap=case["softcap"])
    return (pp.paged_prefill_plain(q, kp, vp, tb, st, ql, **kw),
            pp.paged_prefill_plain(q.float(), kp.float(), vp.float().abs(),
                                   tb, st, ql, **kw),
            pp.p_rounding(q.dtype, q.shape[-1]))


def prefill_wrongs(torch, pa, pp, ref, case):
    """Broken prefill kernels, as plain versions on changed inputs and, on
    the tensor-core route, the split-and-combine version with a partial
    left out: [(what, () -> out)].  The window ones where the case has a
    window."""
    q, kp, vp, tb, st, ql = prefill_args(case)
    G, w, sc = case["group"], case["window"], case["softcap"]
    page = kp.shape[1]
    B, _, CG, _ = q.shape
    C = CG // G
    plain = lambda starts=st, lens=ql, window=w: pp.paged_prefill_plain(
        q, kp, vp, tb, starts, lens, group=G, window=window, softcap=sc)

    def drop_page():
        # query c of row b at position p sees keys up to p; a kernel that
        # drops its last partial page sees keys up to p - cut, cut = p %
        # page + 1, with its window's first key unmoved: the plain version
        # one query at a time at position p - cut, window w - cut
        out = plain().clone()
        for b, (s, n) in enumerate(zip(st.tolist(), ql.tolist())):
            for c in range(n):
                p = s + c
                cut = p % page + 1
                if cut == page:
                    continue                      # its last page is full
                rows = slice(c * G, (c + 1) * G)
                if p - cut < 0 or (w is not None and w - cut < 1):
                    out[b, :, rows] = 0
                    continue
                out[b:b + 1, :, rows] = pp.paged_prefill_plain(
                    q[b:b + 1, :, rows].contiguous(), kp, vp, tb[b:b + 1],
                    st.new_tensor([p - cut]), ql.new_tensor([1]), group=G,
                    window=None if w is None else w - cut, softcap=sc)
        return out

    out = []
    if pp.tensor_core_route(q.dtype, q.shape[-1]):
        per, splits = pp.split_plan(B, q.shape[1], tb.shape[1], page,
                                    q.shape[-1], CG, sm_count(pa, q))
        keep = drop_first_live(torch, [ref.prefill_split_ranges(
            s_, n, tb.shape[1] * page, G, per, splits, row0=0, rows=CG,
            window=w) for s_, n in zip(st.tolist(), ql.tolist())])
        out.append(("dropped one split's partial from the combine",
                    lambda: ref.paged_prefill_tiles_ref(
                        q, kp, vp, tb, st, ql, group=G, keys_per_split=per,
                        window=w, softcap=sc, keep=keep)))
    out += [("applied the causal mask one key late",
            lambda: plain(starts=st + 1, window=None if w is None else w + 1)),
           ("dropped each row's last partial page", drop_page),
           ("wrote the padding rows (c >= q_len) as queries",
            lambda: plain(lens=torch.full_like(ql, C)))]
    if w:
        out += [("saw one key more than the window",
                 lambda: plain(window=w + 1)),
                ("saw one key less than the window",
                 lambda: plain(window=w - 1))]
    return out


def padding_rows_zero(got, case) -> bool:
    """Every padding row (c >= q_len) of the prefill output is zero."""
    G = case["group"]
    return all(bool((got[b, :, n * G:] == 0).all())
               for b, n in enumerate(case["q_lens"].tolist()))


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


PATH_COUNTS = []                # each path run's counts, read just after it


def read_counts(counters) -> dict:
    """The counts since ``zero_counts``, which every path run is driven
    just after; kept in ``PATH_COUNTS`` as well."""
    counts = {name: fn.launches for name, fn in counters.items()}
    PATH_COUNTS.append(counts)
    return counts


HOST_AHEAD_CYCLES = 2_000_000  # ~1 ms of device spin after the flush


def time_ms(torch, fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after the L2 cache is flushed (a 128 MB write).  A spin
    kernel (``torch.cuda._sleep``) after the flush keeps the card busy while
    the host enqueues the events and ``fn``'s launches, so the host's
    dispatch time (tens of microseconds for a wrapper) is not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def time_cases(torch, cases, model: str, key: str, by_name, flush) -> None:
    """Hold each ``(kernel, shapes, fn, plain, lib, cost, case, ok)`` of
    ``cases`` against its plain version (``ok(got, want)``), then time it
    beside the plain version, the library call (none where ``lib`` is
    None) and its bound; the numbers go to ``by_name[kernel][key]`` and
    are printed."""
    for kname, what, fn, plain, lib, cost, case, ok_of in cases:
        want, got = plain(), fn()
        err = (got.float() - want.float()).abs().max().item()
        check(ok_of(got, want), f"{kname} disagrees at {model}'s {what}")
        del want, got
        nbytes, flops = cost(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / BF16_FLOPS_PER_S * 1e3
        m = dict(shapes=what, ms=time_ms(torch, fn, flush),
                 plain_ms=time_ms(torch, plain, flush, reps=5),
                 library_ms=None if lib is None else time_ms(torch, lib,
                                                             flush),
                 bound_ms=max(t_bytes, t_flops),
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 max_abs_err=err)
        entry = by_name[kname]
        entry.setdefault(key, []).append(m)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        lib_txt = ("none" if m["library_ms"] is None
                   else f"{m['library_ms']:.4f} ms")
        print(f"{kname} at {model}'s {what}: kernel {m['ms']:.4f} ms, plain "
              f"{m['plain_ms']:.4f} ms, library {lib_txt}, bound "
              f"{m['bound_ms']:.5f} ms by {m['bound_by']}", flush=True)


def kernel_times_ms(torch, fn, names, flush, reps: int = 10) -> dict:
    """Mean device time per call of ``fn`` of each CUDA kernel whose name
    holds one of ``names``, from ``torch.profiler``'s device-side events
    over ``reps`` calls, each after the L2 flush and the host spin, as in
    ``time_ms``.  A name no kernel matched reads 0."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        for n in names:
            if n in e.key:
                out[n] += us / 1e3 / reps
    return out


def profile_breakdown(prof, wall_ms: float) -> dict:
    """Device time of one profiled step by kernel family: the device-side
    events' time (``self_device_time_total``, in us) summed over kernels;
    busy share = total kernel time / the step's wall time (the profiler's
    own overhead is in that wall time).  The program's and a caller's
    ranges (user annotations) are not kernels and are left out."""
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    fams = {"flash_attention": 0.0, "ssd_scan": 0.0, "rmsnorm": 0.0,
            "conv": 0.0, "nccl": 0.0, "gemm": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or e.key in ranges:
            continue                              # host-side op, a range
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        key = e.key.lower()
        fam = ("flash_attention" if "flash_fwd" in key else
               "ssd_scan" if "ssd_" in key else
               "rmsnorm" if "rmsnorm" in key else
               "conv" if any(t in key for t in ("conv", "fprop", "dgrad",
                                                "wgrad")) else
               "nccl" if "nccl" in key else
               "gemm" if any(t in key for t in ("gemm", "xmma", "cutlass",
                                                "cublas")) else "other")
        fams[fam] += us / 1e3
        top.append((us / 1e3, e.key[:80], e.count))
    total = sum(fams.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "kernel_ms": total,
            "busy_share": total / wall_ms if wall_ms else None,
            "by_family_ms": fams,
            "top": [{"ms": t, "kernel": k, "calls": c}
                    for t, k, c in top[:12]]}


# ---------------------------------------------------------------------------
# training helpers
# ---------------------------------------------------------------------------

def profile_train_step(torch, cfg, dev) -> dict:
    """Device time by kernel family of :func:`profiled_train_step` at
    batch 8."""
    return profile_breakdown(*profiled_train_step(torch, cfg, dev))


def profiled_train_step(torch, cfg, dev, batch: int = 8):
    """One full-width train step (seq 1024, ``batch`` rows, AdamW), the
    launcher's ``dp`` step (AdamW in place) at world size 1 on NCCL (its
    gradient all_reduce included), under ``torch.profiler``, after two
    unprofiled steps: the profiler and the step's wall time in ms."""
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, weight_dtype=torch.float32)
    opt = optim.adamw(3e-4, clip_norm=1.0)
    state = opt.init(params)
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 1024, batch))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with hvd.init(dev):
        step = stepfn.make_train_step(cfg, opt, hvd.axis_groups({"data": 1}),
                                      device=dev)
        for i in range(2):
            params, state, _ = step(params, state, src.batch(i))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            params, state, _ = step(params, state, src.batch(2))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def train_card_vs_cpu(torch, cfg, *, seq: int, batch: int, dev) -> None:
    """One train step of ``cfg`` on the card and on the CPU (``CpuSide``)
    from the same f32 weights (``CPU_WEIGHTS``) and batch (the launcher's
    ``dp`` step at world size 1, NCCL and gloo): loss and the gradient's
    global norm within tolerance."""
    import numpy as np
    host = CPU_SIDE.fetch(weights_label(cfg.name, cfg.num_layers, True))
    lg, ng = train_step_metrics(torch, dev, cfg, host, seq, batch)

    def finish(res):
        lc, nc = res
        print(f"{cfg.name} {cfg.num_layers}-layer full-width step, seq {seq}, "
              f"batch {batch}: loss cuda {lg:.6f} cpu {lc:.6f} (rtol "
              f"{TRAIN_LOSS_RTOL}); grad norm cuda {ng:.6f} cpu {nc:.6f} "
              f"(rtol {TRAIN_GNORM_RTOL})", flush=True)
        check(np.isfinite([lg, ng]).all(), "card train step not finite")
        check(abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc),
              f"{cfg.name}: card and CPU training losses disagree")
        check(abs(ng - nc) <= TRAIN_GNORM_RTOL * abs(nc),
              f"{cfg.name}: card and CPU gradient norms disagree")
        return {"loss": [lg, lc], "grad_norm": [ng, nc]}
    CPU_SIDE.submit(f"{cfg.name} {cfg.num_layers}-layer train step",
                    "train_step_metrics", finish, cfg=cfg, params=host,
                    seq=seq, batch=batch)


# ---------------------------------------------------------------------------
# 3dgan helpers
# ---------------------------------------------------------------------------

def gan_flops_per_image(cfg) -> float:
    """f32 operations of one D step plus one G step per training image,
    from the layer shapes: 2 x MACs of each conv (SAME: the output volume
    x cout x cin x k^3) and linear.  D step: G forward, D forward on real
    and fake, D backward on both (input and weight gradients, 2 x the
    forward); G step: G forward, D forward, D backward for the input
    gradient only (1 x), G backward (2 x)."""
    g, gb, db = cfg.grid, cfg.g_base, cfg.d_base

    def conv(n_out, cin, cout, k):
        return 2.0 * n_out ** 3 * cout * cin * k ** 3

    g_fwd = (2.0 * (cfg.latent_dim + 1) * 343 * cfg.g_fc_ch
             + conv(7, cfg.g_fc_ch, gb, 3) + conv(14, gb, gb // 2, 3)
             + conv(28, gb // 2, gb // 4, 3) + conv(g, gb // 4, 1, 3))
    d_fwd = (conv(13, 1, db, 5) + conv(7, db, 2 * db, 5)
             + conv(4, 2 * db, 4 * db, 5) + 3 * 2.0 * 64 * 4 * db)
    return (g_fwd + 2 * d_fwd + 2 * 2 * d_fwd) + (g_fwd + d_fwd + d_fwd
                                                  + 2 * g_fwd)


def gan_data(torch, cfg, batch: int, pairs: int):
    """``pairs`` calorimeter batches with the z of their D and G steps (one
    ``torch.Generator``, seed 2), on the CPU."""
    from repro_torch.data import CalorimeterSpec, generate_batch
    zgen = torch.Generator().manual_seed(2)
    out = []
    for i in range(pairs):
        b = {k: torch.from_numpy(v) for k, v in
             generate_batch(CalorimeterSpec(), batch, i).items()}
        out.append((b, torch.randn(batch, cfg.latent_dim, generator=zgen),
                    torch.randn(batch, cfg.latent_dim, generator=zgen)))
    return out


def gan_card_vs_cpu(torch, dev, *, batch: int, pairs: int,
                    full_width: bool = True) -> dict:
    """``pairs`` (D, G) step pairs through ``hvd.make_train_step`` on the
    card (inside an NCCL group) against the same pairs on the CPU, from
    the same weights (seeds 0 and 1), batches and z: the CPU side is the
    plain step (value and grad, RMSProp, ``apply_updates``), which is what
    the DP step computes at world size 1.  Checks the GAN_* tolerances and
    returns the card's collective counts of the first D and G steps."""
    import numpy as np
    from repro_torch import bridge, optim
    from repro_torch.configs.gan3d import CONFIG, SMOKE_CONFIG
    from repro_torch.core import hvd
    from repro_torch.distributed.stepfn import value_and_grad
    from repro_torch.models import gan3d as G
    cfg = CONFIG if full_width else SMOKE_CONFIG
    lr = 3e-4
    g0 = G.init_generator(cfg, torch.Generator().manual_seed(0))
    d0 = G.init_discriminator(cfg, torch.Generator().manual_seed(1))
    data = gan_data(torch, cfg, batch, pairs)

    def dl(d, g, b, z):
        return G.d_loss(d, g, cfg, b, z)

    def gl(g, d, b, z):
        return G.g_loss(g, d, cfg, b, z)

    d_opt = optim.rmsprop(lr * 0.5, clip_norm=1.0)
    g_opt = optim.rmsprop(lr, clip_norm=1.0)
    groups = hvd.axis_groups({"data": 1})
    d_step = hvd.make_train_step(dl, d_opt, groups)
    g_step = hvd.make_train_step(gl, g_opt, groups)
    gp, dp = (optim.tree_map(lambda t: t.to(dev), t) for t in (g0, d0))
    ds, gs = d_opt.init(dp), g_opt.init(gp)
    card, counts = [], []
    for b, z1, z2 in data:
        b = {k: v.to(dev) for k, v in b.items()}
        groups.reset_counts()
        dp, ds, dm = d_step(dp, ds, gp, b, z1.to(dev))
        counts.append(groups.counts()[("data",)])
        groups.reset_counts()
        gp, gs, gm = g_step(gp, gs, dp, b, z2.to(dev))
        counts.append(groups.counts()[("data",)])
        card.append({k: float(v) for k, v in {**dm, **gm}.items()})
    gp_card, dp_card = gp, dp

    gp, dp = g0, d0
    ds, gs = d_opt.init(dp), g_opt.init(gp)
    cpu = []
    for b, z1, z2 in data:
        _, dm, gr = value_and_grad(lambda p, a: dl(p, gp, a, z1), dp, b)
        u, ds = d_opt.update(gr, ds, dp)
        dp = optim.apply_updates(dp, u)
        _, gm, gr = value_and_grad(lambda p, a: gl(p, dp, a, z2), gp, b)
        u, gs = g_opt.update(gr, gs, gp)
        gp = optim.apply_updates(gp, u)
        cpu.append({k: float(v) for k, v in {**dm, **gm}.items()})

    out = {"batch": batch, "pairs": pairs, "config": cfg.name,
           "losses_card": card, "losses_cpu": cpu}
    for c, p in zip(card, cpu):
        for k, rtol in (("d_loss", GAN_LOSS_RTOL), ("g_loss", GAN_LOSS_RTOL),
                        ("fake_total_e", GAN_TOTAL_E_RTOL)):
            check(np.isfinite(c[k]) and abs(c[k] - p[k]) <= rtol * abs(p[k]),
                  f"3dgan card vs CPU: {k} {c[k]} against {p[k]} (rtol "
                  f"{rtol})")
    for name, got, want, tree_lr in (("G", gp_card, gp, lr),
                                     ("D", dp_card, dp, lr * 0.5)):
        a, b = bridge.to_flat(got), bridge.to_flat(want)
        diff = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])
        hard = pairs * 2 * tree_lr / math.sqrt(0.1)
        beyond = int((diff > GAN_PARAM_ATOL).sum())
        out[f"{name}_params"] = {"max_abs_diff": float(diff.max()),
                                 "beyond_atol": beyond, "of": diff.size,
                                 "hard_bound": hard}
        check(diff.max() <= hard, f"3dgan card vs CPU: a {name} parameter "
              f"moved {diff.max()} from the CPU's, past {hard}")
        check(beyond <= GAN_PARAM_SHARE * diff.size,
              f"3dgan card vs CPU: {beyond} of {diff.size} {name} "
              f"parameters beyond {GAN_PARAM_ATOL}")
    out["counts_first_pair"] = counts[:2]
    return out


def gan_allreduce_ms(torch, dev, groups, reps: int = 20) -> float:
    """Device time of the two gradient all_reduces of one (D, G) pair at
    full width (``hvd.allreduce`` of trees shaped as D's and G's
    gradients: the fusion copy, the NCCL all_reduce, the division, the
    unpacking), CUDA events around ``reps`` pairs."""
    from repro_torch.configs.gan3d import CONFIG
    from repro_torch.core import hvd
    from repro_torch.models import gan3d as G
    trees = [G.init_generator(CONFIG, torch.Generator().manual_seed(0), dev),
             G.init_discriminator(CONFIG, torch.Generator().manual_seed(1),
                                  dev)]
    for t in trees:
        hvd.allreduce(t, groups.world)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        for t in trees:
            hvd.allreduce(t, groups.world)
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def profile_gan_pair(torch, dev, batch: int) -> dict:
    """One full-width (D, G) pair through ``hvd.make_train_step`` under
    ``torch.profiler`` after two unprofiled pairs (the batch made
    beforehand); device time by kernel family and the busy share."""
    from repro_torch import optim
    from repro_torch.configs.gan3d import CONFIG
    from repro_torch.core import hvd
    from repro_torch.models import gan3d as G
    groups = hvd.axis_groups({"data": 1})
    d_opt = optim.rmsprop(1.5e-4, clip_norm=1.0)
    g_opt = optim.rmsprop(3e-4, clip_norm=1.0)
    d_step = hvd.make_train_step(
        lambda d, g, b, z: G.d_loss(d, g, CONFIG, b, z), d_opt, groups)
    g_step = hvd.make_train_step(
        lambda g, d, b, z: G.g_loss(g, d, CONFIG, b, z), g_opt, groups)
    gp = G.init_generator(CONFIG, torch.Generator().manual_seed(0), dev)
    dp = G.init_discriminator(CONFIG, torch.Generator().manual_seed(1), dev)
    ds, gs = d_opt.init(dp), g_opt.init(gp)
    data = [(({k: v.to(dev) for k, v in b.items()}), z1.to(dev), z2.to(dev))
            for b, z1, z2 in gan_data(torch, CONFIG, batch, 3)]
    for b, z1, z2 in data[:2]:
        dp, ds, _ = d_step(dp, ds, gp, b, z1)
        gp, gs, _ = g_step(gp, gs, dp, b, z2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    b, z1, z2 = data[2]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        dp, ds, _ = d_step(dp, ds, gp, b, z1)
        gp, gs, _ = g_step(gp, gs, dp, b, z2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_breakdown(prof, wall_ms)


def gan_phase(torch, dev) -> None:
    """Phase 12: NCCL, parameter counts, card against CPU, collective
    counts, the entry point's times at batch 8 and 64, the all_reduce time,
    the busy share, the physics-validation rows."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.benchmarks import physics_validation
    from repro_torch.configs.gan3d import CONFIG
    from repro_torch.core import hvd
    from repro_torch.launch import train_3dgan
    from repro_torch.models import gan3d as G
    with hvd.init("cuda") as gdev:
        backend = dist.get_backend()
        print(f"process group: backend {backend}, world size "
              f"{dist.get_world_size()}, device {gdev}", flush=True)
        check(backend == "nccl", f"hvd.init('cuda') made a {backend} group")
        n_g = G.param_count(G.init_generator(
            CONFIG, torch.Generator().manual_seed(0), gdev))
        n_d = G.param_count(G.init_discriminator(
            CONFIG, torch.Generator().manual_seed(1), gdev))
        print(f"3dgan parameters: G {n_g:,}, D {n_d:,}", flush=True)
        check((n_g, n_d) == (719_053, 334_403),
              f"3dgan parameter counts {n_g}, {n_d}")

        t0 = time.perf_counter()
        cmp = gan_card_vs_cpu(torch, gdev, batch=8, pairs=3)
        print(f"3dgan card vs CPU ({time.perf_counter() - t0:.1f} s): "
              + json.dumps(cmp), flush=True)
        # one D step, one G step: the fused gradient all_reduce, then the
        # metrics' (d_loss, acc_real, acc_fake, loss; g_loss, fake_total_e,
        # loss), f32
        want = [(2, 4 * n_d + 16), (2, 4 * n_g + 12)]
        check([tuple(c) for c in cmp["counts_first_pair"]] == want,
              f"3dgan collectives a step {cmp['counts_first_pair']}, want "
              f"{want}")

        flops = gan_flops_per_image(CONFIG)
        runs = {}
        for batch in (8, 64):
            run = train_3dgan.main(["--batch", str(batch), "--steps", "20"])
            pair_ms = 1e3 * sum(run["pair_s"][1:]) / (len(run["pair_s"]) - 1)
            data_ms = 1e3 * sum(run["data_s"][1:]) / (len(run["data_s"]) - 1)
            runs[batch] = {
                "pair_ms": pair_ms, "data_ms": data_ms,
                "images_per_s": run["images_per_s"],
                "pair_images_per_s": batch / pair_ms * 1e3,
                "bound_ms": flops * batch / F32_FLOPS_PER_S * 1e3,
                "max_memory_allocated": run["max_memory_allocated"],
                "d_losses": run["d_losses"], "g_losses": run["g_losses"],
                "energy_corr": run["energy_corr"]}
            check(np.isfinite(run["d_losses"] + run["g_losses"]).all(),
                  f"3dgan batch {batch}: a loss is not finite")
            check(all(c == {"calls": 4, "bytes": 4 * (n_d + n_g) + 28}
                      for c in run["collectives_per_step"]),
                  f"3dgan batch {batch}: collectives "
                  f"{run['collectives_per_step'][:2]}")
        groups = hvd.axis_groups({"data": 1})
        ar_ms = gan_allreduce_ms(torch, gdev, groups)
        print(f"3dgan flops per image (one D + one G step) {flops:.4e}; "
              f"gradient all_reduces a pair {ar_ms:.4f} ms", flush=True)
        for batch, r in runs.items():
            print(f"3dgan launcher batch {batch}: " + json.dumps(r),
                  flush=True)
            print(f"3dgan pair profile, batch {batch}: "
                  + json.dumps(profile_gan_pair(torch, gdev, batch)),
                  flush=True)
        rows = physics_validation.run(device=gdev)
        for row in rows:
            print("3dgan " + ",".join(str(x) for x in row), flush=True)
        check(len(rows) == 5 and np.isfinite(
            float(rows[-1][2].split()[0])), "physics validation rows")
    check(not dist.is_initialized(), "the NCCL group outlived its block")


# ---------------------------------------------------------------------------
# deployment helpers
# ---------------------------------------------------------------------------

def lm_allreduce_ms(torch, params, reps: int = 5) -> float:
    """Device time of the qwen2 step's gradient exchange: ``hvd.allreduce``
    of a tree shaped as the f32 master parameters (the fusion copy into
    one buffer, the NCCL all_reduce at world size 1, the division, the
    unpacking), CUDA events around ``reps`` calls."""
    from repro_torch.core import hvd
    with hvd.init("cuda"):
        world = hvd.axis_groups({"data": 1}).world
        hvd.allreduce(params, world)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            hvd.allreduce(params, world)
        e.record()
        e.synchronize()
    return s.elapsed_time(e) / reps


def deploy_phase(torch, counters, by_name, rms_paths, bare: dict) -> None:
    """Phase 16: the PyTorch image through the port's pipeline, the Slurm
    lines, the launcher's qwen2 DP step inside the capsule (launch counts,
    gradient bytes, image hash), its numbers beside phase 8's bare run,
    and the paper's Tables 2-3 at the full 3DGAN on the card."""
    import shutil

    import numpy as np
    from repro_torch.benchmarks import container_overhead
    from repro_torch.core import container as cc
    from repro_torch.core import deploy as D
    from repro_torch.launch import slurm
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import gan3d as G

    work = OUT / "deploy"
    shutil.rmtree(work, ignore_errors=True)
    steps = 8                   # phase 8's run: its loss falls by step 7
    argv = ["--arch", "qwen2-0.5b", "--strategy", "dp", "--seq-len", "1024",
            "--global-batch", "8", "--steps", str(steps)]
    payload = f"{D.LAUNCHER} {' '.join(argv)}"
    dep = D.DeploymentPipeline().deploy(D.pytorch_image("chip-smoke"), work,
                                        script=payload)
    for line in dep.log:
        print(f"pipeline: {line}")
    print(f"packages: {json.dumps(dep.image.packages, sort_keys=True)}")
    print(f"slurm, 1 node:   {dep.slurm_script.splitlines()[-1]}")
    line32 = slurm.render_script(
        job_name="chip-smoke", image_dir=str(dep.unpacked),
        entrypoint="python", nodes=32, script=payload).splitlines()[-1]
    print(f"slurm, 32 nodes: {line32}", flush=True)
    check(line32.startswith("mpiexec -n 32 -ppn 1 ch-run"),
          f"32-node launch line {line32}")

    pre = cc._tree_hash(dep.unpacked)
    zero_counts(counters)
    res = dep.run(train_launcher.main, argv)[0]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    run = res.value
    params = run.pop("params")
    n = sum(t.numel() for t in _leaves(params))
    check(cc._tree_hash(dep.unpacked) == pre,
          "the image tree changed during the capsule run")
    check((run["world_size"], run["backend"]) == (1, "nccl"),
          f"capsule run on {run['backend']} at world size "
          f"{run['world_size']}")
    losses, per_step = run["losses"], run["launches_per_step"]
    steady = run["step_s"][1:]
    inside = {"losses": losses, "step_s": run["step_s"],
              "step_ms": 1e3 * sum(steady) / len(steady),
              "tokens_per_s": run["tokens_per_s"],
              "max_memory_allocated": run["max_memory_allocated"],
              "launches_per_step": per_step,
              "collectives_per_step": run["collectives_per_step"],
              "capsule": res.image, "wall_s": res.wall_time_s}
    print("capsule training: " + json.dumps(inside), flush=True)
    b_steady = bare["step_s"][1:]
    b_ms = 1e3 * sum(b_steady) / len(b_steady)
    print(f"capsule vs bare (phase 8): step {inside['step_ms']:.2f} / "
          f"{b_ms:.2f} ms ({100 * (inside['step_ms'] / b_ms - 1):+.2f}%), "
          f"tokens/s {inside['tokens_per_s']:.0f} / "
          f"{bare['tokens_per_s']:.0f}, peak "
          f"{inside['max_memory_allocated'] / 2**30:.2f} / "
          f"{bare['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
    print("capsule vs bare losses, max |diff|: "
          f"{max(abs(a - b) for a, b in zip(losses, bare['losses'])):.3e}",
          flush=True)
    check(all(np.isfinite(losses)), "a capsule training loss is not finite")
    check(losses[-1] < losses[0], "the capsule loss did not fall")
    check(all(k == 48 for k in per_step["flash_attention"]),
          f"capsule flash launches per step {per_step['flash_attention']}")
    check(all(k == 97 for k in per_step["rmsnorm"]),
          f"capsule rmsnorm launches per step {per_step['rmsnorm']}")
    check(launches["flash_attention_tensor_core"]
          == launches["flash_attention"] == 48 * steps
          and launches["flash_attention_cuda_core"] == 0,
          "a capsule flash launch missed the tensor-core kernel")
    check(launches["rmsnorm_one_pass"] == launches["rmsnorm"] == 97 * steps,
          "a capsule norm missed the one-pass kernel")
    # one fused f32 gradient all_reduce and the four f32 metrics a step
    want = {"calls": 2, "bytes": 4 * n + 16}
    check(run["collectives_per_step"] == [want] * steps,
          f"capsule collectives {run['collectives_per_step']}, want {want}")
    for name in ("flash_attention", "rmsnorm"):
        k = by_name[name]
        k["launches_per_path"]["qwen2-0.5b dp in the capsule"] = \
            launches[name]
        k["launches"] = sum(k["launches_per_path"].values())
    ar_ms = lm_allreduce_ms(torch, params)
    print(f"qwen2 parameters {n:,}; gradient all_reduce {4 * n:,} bytes, "
          f"{ar_ms:.3f} ms a step (NCCL, world size 1)", flush=True)
    del params, run, res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    # 50 steps a round (the reference's 8 last ~0.1 s here, inside the
    # noise), three rounds a mode
    rows = container_overhead.run(steps=50, batch_size=64, rounds=3,
                                  cfg=G.GAN3DConfig(), device="cuda",
                                  work_dir=OUT / "deploy_bench")
    print(f"container overhead ({time.perf_counter() - t0:.1f} s):")
    for row in rows:
        print("  " + ",".join(str(x) for x in row), flush=True)
    check([r[0] for r in rows] == [
        "3dgan_d_step/with_capsule", "3dgan_d_step/bare",
        "capsule_overhead_pct", "rss_delta_mb", "device_peak_delta_mb"],
        f"container overhead rows {[r[0] for r in rows]}")
    check(rows[0][1] > 0 and rows[1][1] > 0, "container overhead times")


# ---------------------------------------------------------------------------
# the fleet (phase 17)
# ---------------------------------------------------------------------------

def fleet_report(torch, gw, label: str, wall_s: float, dev,
                 extra=None) -> dict:
    """One line of a fleet part's numbers: tokens/s, TTFT p50/p95 over
    every request the gateway's replicas served, the decode gap p95 (the
    merge's conservative max), the peak device memory of this process and
    the part's wall time."""
    import numpy as np
    tot = gw.stats()["totals"]
    ttft = [t * 1e3 for rep in gw.replicas
            for t in rep.scheduler.metrics.ttft_s()]
    out = {"requests": tot["requests_completed"],
           "new_tokens": tot["total_new_tokens"],
           "tokens_per_s": tot["tokens_per_s"],
           "ttft_ms_p50": float(np.percentile(ttft, 50)) if ttft else None,
           "ttft_ms_p95": float(np.percentile(ttft, 95)) if ttft else None,
           "decode_gap_ms_p95": tot["decode_gap_ms"]["p95"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "wall_s": wall_s, **(extra or {})}
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def fleet_phase(torch, dev, counters, by_name, rms_paths) -> dict:
    """Phase 17: the serving fleet on the card (see the module docstring).
    Returns the launch counts of part (a), the main path's launcher run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import (FaultPlan, FaultSpec, LocalProcessBackend,
                                     ReplicaGateway, Request, RequestFailed,
                                     SamplingParams, Scheduler, ServingEngine,
                                     launch_fabric_replicas, shutdown_fabric)
    from repro_torch.serving.fabric import build_engine
    from repro_torch.serving.health import DEAD
    from repro_torch.serving.tracing import validate_event
    from repro_torch.benchmarks import fabric as fabric_bench
    from repro_torch.benchmarks import fault_tolerance as ft_bench

    cfg = get_config("qwen2-0.5b")
    L = cfg.num_layers
    fleet = {}

    # (a) the launcher: three full-width replicas behind the gateway
    slo = OUT / "fleet_slo.json"
    slo.write_text(json.dumps({"default": {"ttft_p95_ms": 30000.0},
                               "tenants": {"b": {"gap_p95_ms": 1000.0}}}))
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    t0 = time.perf_counter()
    gw = launcher.main([
        "--arch", "qwen2-0.5b", "--paged", "--replicas", "3",
        "--max-slots", "8", "--max-seq-len", "1024", "--requests", "24",
        "--max-new", "32", "--shared-prefix", "256", "--greedy",
        "--tenant", "a,b", "--slo-config", str(slo),
        "--metrics-out", str(OUT / "fleet_totals.json"),
        "--metrics-interval-steps", "8",
        "--metrics-json", str(OUT / "fleet_metrics.json"),
        "--trace-out", str(OUT / "fleet_trace"), "--profile"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    print(f"(a) launcher, 3 replicas: kernel launches {launches}")
    stats = json.loads((OUT / "fleet_metrics.json").read_text())
    tot = json.loads((OUT / "fleet_totals.json").read_text())
    check(tot["requests_completed"] == 24 and all(
        len(gw.result(h)) == 32 for h in gw._requests),
        "(a) not every request completed")
    # the prefix's hash owner (the gateway's own rule) hits its cache
    kv0 = gw.replicas[0].scheduler.engine.kv
    head = np.asarray(launcher.make_prompts(cfg, 1, 256)[0][:kv0.block_size],
                      np.int32)
    owner = zlib.crc32(head.tobytes()) % len(gw.replicas)
    owner_pc = gw.replicas[owner].scheduler.metrics.summary()["prefix_cache"]
    print(f"(a) routed {[r.routed for r in gw.replicas]}; owner replica"
          f"{owner} prefix cache {json.dumps(owner_pc)}")
    check(owner_pc["hits"] > 0, "(a) no prefix hit on the owner replica")
    dec = pre = 0
    for rep in gw.replicas:
        eng = rep.scheduler.engine
        check_programs(eng, f"(a) {rep.name}", "prefill_paged",
                       eng.prefill_batch * eng.prefill_chunk)
        d, p = eng.programs["decode_step"], eng.programs["prefill_paged"]
        # what one replay of this replica's programs launches
        # (keyed by the wrappers' own names, as kernels/_build counts them)
        check(d.launches.get("paged_attention") == L
              and d.launches.get("decode_bf16") == L
              and "decode_f32" not in d.launches
              and p.launches.get("paged_prefill") == L
              and p.launches.get("prefill_tensor_core") == L
              and "prefill_cuda_core" not in p.launches,
              f"(a) {rep.name}: launches a replay {d.launches} / "
              f"{p.launches}")
        dec += d.replays
        pre += p.replays
    profs = stats["kernel_profiles"]
    n_prof = profs["paged_attention"]["reps"] + 1      # and the warm-up
    want = {"decode_bf16": L * dec + n_prof, "decode_f32": 0,
            "paged_decode_attention": L * dec + n_prof,
            "paged_prefill_tensor_core": L * pre + n_prof,
            "paged_prefill_cuda_core": 0,
            "paged_prefill_attention": L * pre + n_prof,
            "rmsnorm": (2 * L + 1) * (dec + pre),
            "rmsnorm_one_pass": (2 * L + 1) * (dec + pre)}
    got = {k: launches[k] for k in want}
    check(got == want, f"(a) launches {got}, want {want} from {dec} decode "
          f"and {pre} prefill replays over 3 replicas and the bf16 "
          f"profiles")
    for name, prof in profs.items():
        bound = max(prof["bytes_accessed"] / HBM_BYTES_PER_S,
                    prof["flops"] / BF16_FLOPS_PER_S) * 1e3
        print(f"(a) kernel profile {name} (bf16): "
              f"{prof['wall_ms_median']:.4f}"
              f" ms median of {prof['reps']}, bound {bound:.4f} ms "
              f"({prof['bytes_accessed']:.0f} B, {prof['flops']:.0f} flop)")
        check(prof["wall_ms_median"] > 0, f"(a) {name} profile not timed")
    events = [json.loads(line) for line in (
        OUT / "fleet_trace.jsonl").read_text().splitlines()]
    bad = [e for e in events if validate_event(e) is not None]
    check(events and not bad, f"(a) {len(bad)} trace events fail the schema")
    check({e.get("replica") for e in events} == {"replica0", "replica1",
                                                 "replica2"},
          "(a) the merged trace lacks a replica")
    fleet["launcher"] = fleet_report(torch, gw, "(a) launcher", wall, dev, {
        "trace_events": len(events), "prefill_replays": pre,
        "decode_replays": dec, "slo_breaches": tot.get("slo_breaches")})
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        by_name[name]["launches"] += L * (dec if "decode" in name else pre)
        by_name[name]["launches_per_part"].append(
            L * (dec if "decode" in name else pre))
    by_name["paged_decode_attention_f32"]["launches"] = launches["decode_f32"]
    by_name["paged_prefill_attention_f32"]["launches"] = \
        launches["paged_prefill_cuda_core"]
    rms_paths["fleet"] = launches["rmsnorm"]
    params = gw.replicas[0].scheduler.engine.params
    check(all(rep.scheduler.engine.params["embed"]["table"].data_ptr()
              == params["embed"]["table"].data_ptr() for rep in gw.replicas),
          "(a) replicas do not share weights")
    del gw
    torch.cuda.empty_cache()

    # (b) failover at full width: replica1 of three crashes at its step 4
    rs = np.random.default_rng(17)
    reqs = [Request(rs.integers(0, cfg.vocab_size, int(rs.integers(256, 897)),
                                dtype=np.int32),
                    SamplingParams(max_new_tokens=int(rs.integers(16, 33)),
                                   greedy=True)) for _ in range(18)]
    ekw = dict(max_seq_len=1024, max_slots=8, paged=True,
               greedy_tie_eps=1e-2, device=dev)
    oracle = Scheduler(ServingEngine(cfg, params, **ekw))
    orids = [oracle.submit(r) for r in reqs]
    oracle.run()
    want_out = [oracle.output(r).tolist() for r in orids]
    del oracle
    torch.cuda.reset_peak_memory_stats(dev)
    plan = FaultPlan([FaultSpec(kind="crash", replica="replica1", at_step=4)])
    gw = ReplicaGateway.from_engines(
        [ServingEngine(cfg, params, **ekw) for _ in range(3)],
        tracing=True, fault_plan=plan)
    t0 = time.perf_counter()
    handles = [gw.submit(r) for r in reqs[:12]]
    for _ in range(6):                     # let the crash land mid-burst
        gw.step()
    handles += [gw.submit(r) for r in reqs[12:]]
    gw.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [gw.result(h) for h in handles]
    check(not any(isinstance(o, RequestFailed) for o in outs),
          "(b) a request failed")
    check(gw.health[1].state == DEAD and gw.failovers == 1,
          f"(b) health {[m.state for m in gw.health]}, failovers "
          f"{gw.failovers}")
    same = [o.tolist() == w for o, w in zip(outs, want_out)]
    check(all(same), f"(b) {same.count(False)} output(s) differ from the "
          "fault-free run")
    for i in (0, 2):
        rep = gw.replicas[i]
        check_no_leaks(rep.scheduler, f"(b) {rep.name}")
        check_programs(rep.scheduler.engine, f"(b) {rep.name}",
                       "prefill_paged", 64)
    events = gw.trace_events()
    fo = next(e["ts"] for e in events if e["kind"] == "replica_failover")
    retried = {(e["replica"], e["rid"]) for e in events
               if e["kind"] == "replica_retry"}
    recovery = max((e["ts"] for e in events if e["kind"] == "retire"
                    and (e["replica"], e["rid"]) in retried),
                   default=fo) - fo
    fleet["failover"] = fleet_report(torch, gw, "(b) failover", wall, dev, {
        "recovery_wall_s": recovery, "retried": len(retried),
        "prompt_lens": [len(r.prompt) for r in reqs]})
    del gw, params
    torch.cuda.empty_cache()

    # (c) the fabric: three worker processes share the card
    t0 = time.perf_counter()
    rows = fabric_bench.run(quick=True, out_path=str(OUT / "fabric.json"),
                            device="cuda",
                            trace_out=str(OUT / "fabric_trace.jsonl"))
    rec = json.loads((OUT / "fabric.json").read_text())
    print("(c) " + "; ".join(f"{n}: {d}" for n, _, d in rows))
    check(rec["bit_identical_outputs"] and rec["failed_requests"] == 0
          and rec["requests_completed"] == rec["n_requests"],
          "(c) the fabric lost or changed a request")
    fleet["fabric_kill"] = dict(
        {k: rec[k] for k in ("requests_completed", "failovers", "wall_s",
                             "boot_wall_s", "recovery_wall_s")},
        phase_wall_s=time.perf_counter() - t0)
    print("(c) fabric with a SIGKILL: " + json.dumps(fleet["fabric_kill"]),
          flush=True)
    # a fault-free burst with the default health ladder and waits: no
    # transition and no failover (a capture longer than a step's wait
    # would read as a wedged worker)
    spool = OUT / "fleet_spool"
    shutil.rmtree(spool, ignore_errors=True)
    oracle_eng = build_engine(None)
    freqs = fabric_bench._workload(oracle_eng.cfg.vocab_size, 12)
    oracle = Scheduler(oracle_eng)
    orids = [oracle.submit(r) for r in freqs]
    oracle.run()
    fwant = [oracle.output(r).tolist() for r in orids]
    del oracle, oracle_eng
    backend = LocalProcessBackend()
    gw = launch_fabric_replicas(3, backend, spool, tracing=True)
    try:
        boot = fabric_bench.wait_for_workers(gw)
        t0 = time.perf_counter()
        handles = [gw.submit(r) for r in freqs]
        gw.drain()
        wall = time.perf_counter() - t0
        st = gw.stats()["fleet"]
        trans = {n: h["transitions"] for n, h in st["health"].items()}
        check(all(v == 0 for v in trans.values()) and st["failovers"] == 0,
              f"(c) fault-free burst: transitions {trans}, failovers "
              f"{st['failovers']}")
        check([gw.result(h).tolist() for h in handles] == fwant,
              "(c) fault-free fabric outputs differ from the oracle")
        fleet["fabric_clean"] = fleet_report(
            torch, gw, "(c) fabric, fault-free", wall, dev,
            {"boot_wall_s": boot, "transitions": trans})
    finally:
        shutdown_fabric(gw)
    check(all(p.poll() is not None for p in backend.procs.values()),
          "(c) a worker process outlived the shutdown")

    # (d) the fault-tolerance benchmark at its reference size
    t0 = time.perf_counter()
    rows = ft_bench.run(quick=True, out_path=str(OUT / "faults.json"),
                        device="cuda",
                        trace_out=str(OUT / "faults_trace.jsonl"))
    rec = json.loads((OUT / "faults.json").read_text())
    check(rec["bit_identical_outputs"] and rec["failed_requests"] == 0,
          "(d) the fault-tolerance benchmark lost or changed a request")
    fleet["fault_tolerance"] = dict(
        {k: rec[k] for k in ("requests_completed", "failovers", "wall_s",
                             "recovery_wall_s", "salvage_success_rate")},
        phase_wall_s=time.perf_counter() - t0)
    print("(d) fault tolerance: " + json.dumps(fleet["fault_tolerance"]),
          flush=True)
    return fleet


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------

def check_no_leaks(sched, label: str) -> None:
    eng = sched.engine
    kv = eng.kv
    check(not sched.queue and not sched.active and not sched.prefilling,
          f"{label}: work left in the scheduler")
    check(kv.free_slot_count == kv.max_slots,
          f"{label}: {kv.max_slots - kv.free_slot_count} slot(s) leaked")
    check(kv.pool.in_use == 0, f"{label}: {kv.pool.in_use} block(s) leaked")
    # no cursor left in flight, none holding the dense staging stripe
    check(not eng._inflight and eng._stripe_owner is None,
          f"{label}: a prefill cursor or the staging stripe leaked")
    pc = eng.prefix_cache
    if pc is not None:
        # with every request retired, evicting the whole tree must return
        # every prefix block: a block still held is a leaked pin
        pc.evict(kv.prefix_pool.num_blocks)
        check(kv.prefix_pool.in_use == 0,
              f"{label}: {kv.prefix_pool.in_use} prefix pin(s) leaked")


def run_marking_warm(sched) -> None:
    """``sched.run()``, marking the engine's shape telemetry warm as soon
    as both of its programs exist, so a later capture or novel program
    signature counts as a post-warm recompile."""
    eng = sched.engine
    while sched.has_work:
        sched.step()
        if not eng.recompiles.warm and len(eng.programs) == 2:
            eng.recompiles.mark_warm()


def check_programs(eng, label: str, prefill: str, rows: int) -> None:
    """Every round of ``eng`` ran as a replay of one of its two programs,
    each built (captured) once, with no post-warm recompile of either;
    ``rows``: executed prefill tokens a prefill replay.  Prints each
    program's captures, replays and capture seconds."""
    progs = eng.programs
    check(sorted(progs) == sorted(["decode_step", prefill]),
          f"{label}: programs {sorted(progs)}")
    check(all(p.captures == 1 for p in progs.values()),
          f"{label}: captures {[p.captures for p in progs.values()]}")
    check(progs["decode_step"].replays == eng.decode_steps,
          f"{label}: a decode round was not a replay")
    check(progs[prefill].replays * rows == eng.prefill_tokens_executed,
          f"{label}: a prefill round was not a replay")
    rc = eng.recompiles
    check(all(rc.post_warm.get(n, 0) == 0 and len(rc.signatures[n]) == 1
              for n in progs), f"{label}: a program recompiled")
    out = {n: {"captures": p.captures, "replays": p.replays,
               "capture_s": p.capture_s} for n, p in progs.items()}
    print(f"{label} programs: " + json.dumps(out), flush=True)


def check_round_launches(eng, launches, label: str, cfg) -> dict:
    """A paged serving run's kernel counts are its replays times each
    capture's launches: a decode round launches paged decode once a layer,
    a prefill round paged prefill once a layer (on the tensor-core
    kernel, none on the CUDA-core one), and a round of either one RMSNorm
    a norm (two a layer, four with gemma2's post-block norms, and the
    final one, each one pass).  Returns the paged kernels' measured
    launches per replay of their round's program."""
    L = cfg.num_layers
    norms = (4 if cfg.post_block_norm else 2) * L + 1
    dec = eng.programs["decode_step"].replays
    pre = eng.programs["prefill_paged"].replays
    want = {"paged_decode_attention": L * dec,
            "paged_prefill_attention": L * pre,
            "paged_prefill_tensor_core": L * pre,
            "paged_prefill_cuda_core": 0,
            "rmsnorm": norms * (dec + pre),
            "rmsnorm_one_pass": norms * (dec + pre)}
    got = {k: launches[k] for k in want}
    check(got == want, f"{label}: launches {got}, want {want} from {dec} "
          f"decode and {pre} prefill replays")
    return {"paged_decode_attention": got["paged_decode_attention"]
            / max(dec, 1),
            "paged_prefill_attention": got["paged_prefill_attention"]
            / max(pre, 1)}


def eager_vs_replay(torch, T, eng, tokens, positions) -> float:
    """One replayed decode round of ``eng`` against an eager
    ``decode_step`` on the same inputs from the same cache (snapshotted
    before the replay and restored before the eager step: a mamba layer's
    state advances a token a step): max |diff|."""
    import numpy as np
    from repro_torch.serving.kvcache import _leaves
    before = [t.clone() for _, t in _leaves(eng.kv.cache)]
    replayed = eng.decode_once(tokens, positions).clone()
    for (_, t), b in zip(_leaves(eng.kv.cache), before):
        t.copy_(b)
    del before
    batch = {"tokens": torch.from_numpy(
                 np.asarray(tokens, np.int32)[:, None]).to(eng.device),
             "positions": torch.from_numpy(
                 np.asarray(positions, np.int32)).to(eng.device),
             "cache": eng.kv.cache}
    if eng.paged:
        batch["block_tables"] = eng.kv.device_block_tables()
    if eng._enc_pool is not None:
        batch["encoder_output"] = eng._enc_pool
    eager = T.decode_step(eng.params, eng.cfg, batch)[0][:, 0]
    return float((replayed - eager).abs().max())


def serve_recurrent(torch, T, dev, counters, by_name, rms_paths) -> dict:
    """Dense serving of zamba2-1.2b (int8 KV, then bf16 KV on the first 4
    prompts) and mamba2-1.3b at full width with random weights (seed 0):
    phase 6's workload through the scheduler, every round a replay of
    the engine's two programs, exact launch counts, no prefix cache
    though blocks are asked for, nothing leaked; a replayed B = 8 decode
    round timed with CUDA events and held bit for bit against the eager
    round; then greedy tokens and last logits, card against CPU, at cut
    depth.  Adds each path's launches to ``by_name`` and ``rms_paths``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    kw = dict(paged=False, max_slots=8, max_seq_len=1024, prefill_chunk=16,
              prefix_cache_blocks=64)
    out, params = {}, {}
    for arch, kv_dtype, n_req in (("zamba2-1.2b", "int8",
                                   RECURRENT_REQUESTS),
                                  ("zamba2-1.2b", "bfloat16", 4),
                                  ("mamba2-1.3b", "bfloat16",
                                   RECURRENT_REQUESTS)):
        cfg = get_config(arch).with_(kv_cache_dtype=kv_dtype)
        label = f"dense {arch}" + (f" {kv_dtype}" if cfg.num_heads else "")
        if arch not in params:
            params = {arch: T.init_params(cfg, torch.Generator().manual_seed(
                0), device=dev)}
        rs = np.random.default_rng(3)
        shared = rs.integers(0, cfg.vocab_size, 32, dtype=np.int32)
        prompts = [np.concatenate([shared, rs.integers(
            0, cfg.vocab_size, int(rs.integers(16, 97)), dtype=np.int32)])
            for _ in range(12)][:n_req]
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ServingEngine(cfg, params[arch], device=dev, **kw)
        check(eng.prefix_cache is None and eng.kv.prefix_pool is None,
              f"{label}: a prefix store for a recurrent cache")
        sched = Scheduler(eng, profile=True)
        zero_counts(counters)
        rids = [sched.submit(Request(p, SamplingParams(
            max_new_tokens=32, greedy=True))) for p in prompts]
        run_marking_warm(sched)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        rep = report_serving(torch, sched, label, dev)
        outs = [sched.output(r) for r in rids]
        check(all(len(o) == 32 for o in outs),
              f"{label}: not every request completed")
        check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
              f"{label}: token ids out of range")
        check_no_leaks(sched, label)
        check(eng.recompiles.warm, f"{label}: the engine never held both "
              "programs")
        check_programs(eng, label, "prefill_chunk", eng.prefill_chunk)
        # every step (a decode round, or one replayed prompt token) runs
        # each mamba layer's recurrence (no scan kernel), two norms a
        # mamba layer, and zamba2's shared block once a group: its two
        # norms and, with the int8 cache, one int8 kernel launch
        steps = eng.decode_steps + eng.prefill_tokens_executed
        L = cfg.num_layers
        G = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        norms = 2 * L + 2 * G + 1
        want = {"flash_attention_int8kv": G * steps if kv_dtype == "int8"
                else 0, "ssd_scan": 0, "flash_attention": 0,
                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                "rmsnorm": norms * steps, "rmsnorm_one_pass": norms * steps}
        got = {k: launches[k] for k in want}
        check(got == want, f"{label}: launches {got}, want {want} from "
              f"{steps} steps")
        # a B = 8 decode round at position 512 on every row, replayed
        dec = eng.programs["decode_step"]
        dec.feed(tokens=np.ones((8, 1), np.int32),
                 positions=np.full(8, 512, np.int32))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        dec.replay()
        ev[0].record()
        for _ in range(20):
            dec.replay()
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1]) / 20
        # a replayed decode round against the eager one, 4 slots holding
        # prompts of 48-400 tokens
        ps = [rs.integers(0, cfg.vocab_size, n, dtype=np.int32)
              for n in (48, 400, 131, 256)]
        tokens = np.zeros(8, np.int32)
        positions = np.zeros(8, np.int32)
        slots = []
        for p, (slot, last) in zip(ps, eng.prefill_into_slots(ps)):
            tokens[slot] = int(np.argmax(last))
            positions[slot] = len(p)
            slots.append(slot)
        replay_diff = eager_vs_replay(torch, T, eng, tokens, positions)
        check(replay_diff == 0.0 and dec.captures == 1,
              f"{label}: a replayed decode round differs from the eager "
              f"one ({replay_diff})")
        for slot in slots:
            eng.free_slot(slot)
        progs = {n: {"captures": p.captures, "capture_s": p.capture_s}
                 for n, p in eng.programs.items()}
        out[label] = dict(rep, kv_bytes=eng.kv.kv_bytes(),
                          decode_steps=eng.decode_steps,
                          prefill_tokens_executed=eng.prefill_tokens_executed,
                          launches={k: v for k, v in got.items() if v},
                          decode_round_replay_ms=step_ms,
                          replay_vs_eager_max_diff=replay_diff,
                          programs=progs)
        print(f"{label}: kv_bytes {eng.kv.kv_bytes()}; B = 8 decode round "
              f"replayed {step_ms:.3f} ms; launches {got}", flush=True)
        if want["flash_attention_int8kv"]:
            k = by_name["flash_attention_int8kv"]
            k["launches_per_path"][f"dense serving {arch}"] = \
                launches["flash_attention_int8kv"]
            k["launches"] = sum(k["launches_per_path"].values())
            k["zamba2_launches_per_step"] = G
        rms_paths[label] = launches["rmsnorm"]
        del sched, eng, dec
        torch.cuda.empty_cache()
    z8, z16 = out["dense zamba2-1.2b int8"], out["dense zamba2-1.2b bfloat16"]
    D = get_config("zamba2-1.2b").resolved_head_dim
    print(f"zamba2 dense int8 / bf16 KV bytes "
          f"{z8['kv_bytes'] / z16['kv_bytes']:.4f} (the mamba state, f32, is "
          f"the same in both; the K/V stripes take (2D + 4) / (4D) = "
          f"{(2 * D + 4) / (4 * D):.4f})", flush=True)
    # card against CPU at full width and cut depth (zamba2: one group of
    # six and a tail of two, int8 KV; mamba2: four layers): one 48-token
    # prompt, last logits and 8 greedy tokens (tie-eps 1e-2)
    for arch, layers, kv_dtype in (("zamba2-1.2b", 8, "int8"),
                                   ("mamba2-1.3b", 4, "bfloat16")):
        cfg = get_config(arch).with_(num_layers=layers,
                                     kv_cache_dtype=kv_dtype)
        prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 48,
                                                   dtype=np.int32)
        p_cpu = CPU_SIDE.fetch(weights_label(arch, layers, False))
        kw = dict(paged=False)
        lg, tg, _ = engine_greedy(torch, dev, cfg, p_cpu, prompt, new=8,
                                  generate=False, engine_kw=kw)
        label = f"{arch} {layers}-layer full-width dense {kv_dtype}"
        CPU_SIDE.submit(label, "engine_greedy", engine_pair(
            label, lg, tg, (cfg.vocab_size,)), cfg=cfg, params=p_cpu,
            prompt=prompt, new=8, generate=False, engine_kw=kw)
        del p_cpu
    return out


# ---------------------------------------------------------------------------
# MoE serving (phase 18)
# ---------------------------------------------------------------------------

def moe_device_split(prof) -> dict:
    """Device time (ms) of one profiled eager MoE decode step: the expert
    GEMMs (kernels of ``aten::bmm``: the three expert einsums; every other
    product of the step is an ``aten::mm``), the dispatch (kernels of the
    ops under ``moe.DISPATCH_RANGE``: the router, the aux loss, the
    dispatch into the capacity buffer, the gather and combine of the
    slots), the attention kernels (paged decode and its split combine,
    launched through ctypes, so found by kernel name) and the rest; plus
    the 8 ops with the most device time of their own, and the kernel
    count."""
    from repro_torch.models.moe import DISPATCH_RANGE

    def under_range(e):
        while e is not None:
            if e.name == DISPATCH_RANGE:
                return True
            e = e.cpu_parent
        return False

    split = dict.fromkeys(("expert_gemms", "dispatch", "attention"), 0.0)
    total, n, own, calls = 0.0, 0, {}, {}
    for e in prof.events():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if e.name == DISPATCH_RANGE or getattr(e, "is_user_annotation",
                                                   False):
                continue        # the range's span on the device, no kernel
            total += us / 1e3
            n += 1
            low = e.name.lower()
            if "paged_decode" in low or "combine_kernel" in low:
                split["attention"] += us / 1e3
            continue
        own[e.name] = own.get(e.name, 0.0) + us / 1e3
        calls[e.name] = calls.get(e.name, 0) + 1
        if e.name == "aten::bmm":
            split["expert_gemms"] += us / 1e3
        elif under_range(e):
            split["dispatch"] += us / 1e3
    split["rest"] = total - sum(split.values())
    top = sorted(own, key=own.get, reverse=True)[:8]
    return dict(split, kernel_ms=total, kernels=n,
                top_ops=[{"op": k, "ms": own[k], "calls": calls[k]}
                         for k in top])


def moe_phase(torch, T, dev, counters, by_name, rms_paths) -> dict:
    """qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts,
    top-8) with random weights drawn on the card at seed 0, one copy
    resident at a time: (a) the launcher, paged; (b) the scheduler and
    engine on phase 5 (b)'s workload; (c) a B = 8 decode round replayed
    and eager, timed and profiled; (d) dense int8 on phase 6's first 4
    prompts; (e) card against CPU at 2 layers on weights copied from the
    card, with the routing agreement per layer.  Adds the paths' launches
    to ``by_name`` and ``rms_paths``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    from repro_torch.serving.programs import CapturedProgram
    arch = "qwen3-moe-30b-a3b"
    cfg = get_config(arch)
    L, K = cfg.num_layers, cfg.num_experts_per_tok
    out = {}

    # (a) the launcher, paged ---------------------------------------------
    before = held_bytes(torch, dev)
    check(before < 4 * 2**30, f"(a) {before} bytes held before the launcher")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    t0 = time.perf_counter()
    gw = launcher.main([
        "--arch", arch, "--paged", "--max-slots", "8", "--max-seq-len",
        "1024", "--requests", "8", "--max-new", "32", "--shared-prefix",
        "256", "--greedy", "--metrics-json", str(OUT / "moe_metrics.json")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = read_counts(counters)
    sched = gw.replicas[0].scheduler
    eng = sched.engine
    setup_s = json.loads((OUT / "moe_metrics.json").read_text())["setup_s"]
    rep = report_serving(torch, sched, "(a) moe launcher", dev)
    check(rep["requests"] == 8, "(a) moe: not every request completed")
    check(rep["prefix_hit_rate"] > 0, "(a) moe: no prefix-cache hit")
    check_no_leaks(sched, "(a) moe")
    check_programs(eng, "(a) moe", "prefill_paged",
                   eng.prefill_batch * eng.prefill_chunk)
    per_replay = {"launcher": check_round_launches(eng, launches_a,
                                                   "(a) moe", cfg)}
    check(eng.params["layers"]["moe"]["router"]["w"].dtype == torch.float32
          and eng.params["layers"]["moe"]["wi"].dtype == torch.bfloat16,
          "(a) moe: the router is not f32 or the experts not bf16")
    out["launcher"] = dict(rep, setup_s=setup_s, wall_s=wall,
                           weight_bytes=tree_bytes(eng.params),
                           programs={n: {"captures": p.captures,
                                         "replays": p.replays,
                                         "capture_s": p.capture_s}
                                     for n, p in eng.programs.items()})
    print(f"(a) moe launcher: setup (weights + engine) {setup_s:.2f} s, "
          f"weights {out['launcher']['weight_bytes']} bytes, wall "
          f"{wall:.1f} s", flush=True)
    del gw, sched, eng

    # (b) the scheduler and engine driven directly -------------------------
    before = held_bytes(torch, dev)
    check(before < 4 * 2**30, f"(b) {before} bytes still held before the "
          "weights are made (one copy at a time)")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    out["init"] = dict(init_s=time.perf_counter() - t0,
                       weight_bytes=tree_bytes(params),
                       init_peak_bytes=torch.cuda.max_memory_allocated(dev),
                       held_before=before)
    print(f"(b) moe: weights made on the card in {out['init']['init_s']:.2f}"
          f" s, {out['init']['weight_bytes']} bytes, peak "
          f"{out['init']['init_peak_bytes']} bytes ({before} held before)",
          flush=True)
    rs = np.random.default_rng(1)
    shared = rs.integers(0, cfg.vocab_size, 256, dtype=np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, int(rs.integers(64, 769)), dtype=np.int32)])
        for _ in range(8)]
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, params, max_seq_len=2048, max_slots=8,
                        prefix_cache_blocks=256, paged=True,
                        prefill_batch=4, device=dev)
    sched = Scheduler(eng, prefill_token_budget=512, profile=True)
    zero_counts(counters)
    rids = [sched.submit(Request(p, SamplingParams(max_new_tokens=32,
                                                   greedy=True)))
            for p in prompts]
    run_marking_warm(sched)
    torch.cuda.synchronize()
    launches_b = read_counts(counters)
    rep = report_serving(torch, sched, "(b) moe direct", dev)
    outs = [sched.output(r) for r in rids]
    check(all(len(o) == 32 for o in outs),
          "(b) moe: not every request completed")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
          "(b) moe: token ids out of range")
    check(rep["prefix_hit_rate"] > 0, "(b) moe: no prefix-cache hit")
    check_no_leaks(sched, "(b) moe")
    check(eng.recompiles.warm, "(b) moe: the engine never held both programs")
    check_programs(eng, "(b) moe", "prefill_paged",
                   eng.prefill_batch * eng.prefill_chunk)
    per_replay["engine"] = check_round_launches(eng, launches_b, "(b) moe",
                                                cfg)
    out["direct"] = dict(rep, prompts=[len(p) for p in prompts],
                         decode_replays=eng.programs["decode_step"].replays,
                         prefill_replays=eng.programs["prefill_paged"].replays)
    del sched, eng

    # (c) one B = 8 decode round: replayed and eager, timed, profiled -------
    lens = [512, 731, 950, 1170, 1389, 1609, 1828, 2048]
    dc = decode_case(torch, np.random.default_rng(18), dev, B=8,
                     KV=cfg.num_kv_heads, G=cfg.num_heads // cfg.num_kv_heads,
                     D=cfg.resolved_head_dim, page=16, lengths=lens,
                     garbage=False)
    shape = (L, 1, dc["k_pages"].shape[0], 16, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    step_cache = {"layers": {n: torch.randn(shape, dtype=torch.bfloat16,
                                            device=dev) for n in "kv"}}
    step_in = {"tokens": torch.zeros((8, 1), dtype=torch.int32, device=dev),
               "positions": (dc["lengths"] - 1).to(torch.int32),
               "block_tables": dc["block_tables"]}
    step = CapturedProgram("decode_step", lambda **b: T.decode_step(
        params, cfg, dict(b, cache=step_cache))[0], step_in)
    rs = np.random.default_rng(4)
    step.feed(tokens=rs.integers(0, cfg.vocab_size, (8, 1), dtype=np.int32))
    replayed = step.replay().clone()
    eager = T.decode_step(params, cfg, dict(step_in, cache=step_cache))[0]
    diff = float((replayed - eager).abs().max())
    check(diff == 0.0 and step.captures == 1,
          f"(c) moe: the replayed decode round differs from the eager one "
          f"({diff})")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(20):
        step.replay()
    ev[1].record()
    for _ in range(3):
        T.decode_step(params, cfg, dict(step_in, cache=step_cache))
    ev[2].record()
    torch.cuda.synchronize()
    replay_ms = ev[0].elapsed_time(ev[1]) / 20
    eager_ms = ev[1].elapsed_time(ev[2]) / 3

    def serve_step():
        step.feed(tokens=rs.integers(0, cfg.vocab_size, (8, 1),
                                     dtype=np.int32))
        torch.argmax(step.replay()[:, 0], dim=-1).cpu()

    for _ in range(3):
        serve_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        serve_step()
    served_ms = (time.perf_counter() - t0) * 1e3 / 10
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            serve_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    br = profile_breakdown(prof, wall_ms)
    n_kernels = sum(e.count for e in prof.key_averages() if str(getattr(
        e, "device_type", "")).endswith("CUDA")) / 5
    with torch.profiler.profile(activities=acts) as prof:
        T.decode_step(params, cfg, dict(step_in, cache=step_cache))
        torch.cuda.synchronize()
    split = moe_device_split(prof)
    weight_ms = tree_bytes(params) / HBM_BYTES_PER_S * 1e3
    out["decode_round"] = dict(
        replay_ms=replay_ms, eager_ms=eager_ms, capture_s=step.capture_s,
        served_step_ms=served_ms, kernels_per_step=n_kernels,
        kernel_ms_per_step=br["kernel_ms"] / 5,
        busy_share=br["kernel_ms"] / 5 / served_ms,
        profiled_busy_share=br["busy_share"], eager_split_ms=split,
        weights_read_bound_ms=weight_ms, replay_vs_eager_max_diff=diff,
        top=br["top"][:6])
    print("(c) moe B = 8 decode round (contexts 512-2048; replay and eager "
          "by CUDA events; served steps by the host clock, kernels and busy "
          "share from 5 under torch.profiler; the split from one eager step; "
          "bound: every weight read once): "
          + json.dumps(out["decode_round"]), flush=True)
    check(n_kernels > 0 and split["kernel_ms"] > 0,
          "(c) moe: the profiler saw no kernel")
    del step, step_cache, step_in, dc, prof, replayed, eager

    # (d) dense int8, 4 of phase 6's prompts ------------------------------
    cfg8 = cfg.with_(kv_cache_dtype="int8")
    rs = np.random.default_rng(3)
    shared = rs.integers(0, cfg.vocab_size, 32, dtype=np.int32)
    dense_prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, int(rs.integers(16, 97)), dtype=np.int32)])
        for _ in range(12)][:4]
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg8, params, paged=False, max_slots=8,
                        max_seq_len=1024, prefill_chunk=16,
                        prefix_cache_blocks=64, device=dev)
    sched = Scheduler(eng, profile=True)
    zero_counts(counters)
    rids = [sched.submit(Request(p, SamplingParams(max_new_tokens=32,
                                                   greedy=True)))
            for p in dense_prompts]
    run_marking_warm(sched)
    torch.cuda.synchronize()
    launches_d = read_counts(counters)
    rep = report_serving(torch, sched, "(d) moe dense int8", dev)
    outs = [sched.output(r) for r in rids]
    steps = eng.decode_steps + eng.prefill_tokens_executed
    check(all(len(o) == 32 for o in outs),
          "(d) moe dense int8: not every request completed")
    want = {"flash_attention_int8kv": L * steps,
            "rmsnorm": (2 * L + 1) * steps,
            "rmsnorm_one_pass": (2 * L + 1) * steps,
            "paged_decode_attention": 0, "paged_prefill_attention": 0,
            "flash_attention": 0}
    got = {k: launches_d[k] for k in want}
    check(got == want, f"(d) moe dense int8: launches {got}, want {want} "
          f"from {steps} steps (decode steps + prefill tokens executed)")
    check_no_leaks(sched, "(d) moe dense int8")
    check(eng.recompiles.warm,
          "(d) moe dense int8: the engine never held both programs")
    check_programs(eng, "(d) moe dense int8", "prefill_chunk",
                   eng.prefill_chunk)
    out["dense_int8"] = dict(rep, kv_bytes=eng.kv.kv_bytes(),
                             decode_steps=eng.decode_steps,
                             prefill_tokens_executed=(
                                 eng.prefill_tokens_executed),
                             capture_s={n: p.capture_s for n, p in
                                        eng.programs.items()})
    del sched, eng

    # the kernels line: this phase's main-path launches
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        n = launches_a[name] + launches_b[name]
        by_name[name]["launches"] += n
        by_name[name]["launches_per_part"].append(n)
        by_name[name]["moe_launches_per_replay"] = {
            part: r[name] for part, r in per_replay.items()}
    k = by_name["flash_attention_int8kv"]
    k["launches_per_path"][f"dense serving {arch}"] = \
        launches_d["flash_attention_int8kv"]
    k["launches"] = sum(k["launches_per_path"].values())
    rms_paths[f"serving {arch}"] = (launches_a["rmsnorm"]
                                    + launches_b["rmsnorm"]
                                    + launches_d["rmsnorm"])

    # (e) card against CPU at 2 layers, on weights copied from the card ----
    cfg2 = cfg.with_(num_layers=2)
    p_cpu = _map(dict(params, layers=_map(params["layers"],
                                          lambda t: t[:2])),
                 lambda t: t.cpu())
    del params
    before = held_bytes(torch, dev)
    check(before < 4 * 2**30, f"(e) {before} bytes held after freeing the "
          "full-depth weights")
    p_card = _map(p_cpu, lambda t: t.to(dev))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 48,
                                               dtype=np.int32)
    recorded = []
    inner = moe_lib.moe_block

    def recording(p, c, x, **kw):
        recorded.append(x.detach().clone())
        return inner(p, c, x, **kw)

    results = {}
    for where, p in ((dev, p_card), ("cpu", p_cpu)):
        e = ServingEngine(cfg2, p, max_seq_len=64, max_slots=1, paged=True,
                          prefill_batch=1, device=where)
        moe_lib.moe_block = recording if where == "cpu" else inner
        try:
            slot, last = e.prefill_into_slot(prompt)
        finally:
            moe_lib.moe_block = inner
        e.free_slot(slot)
        toks = e.generate([Request(prompt, SamplingParams(
            max_new_tokens=4, greedy=True))])[0]
        results[str(where)] = (last, toks.tolist())
        del e
    (lg, tg), (lc, tc) = results[str(dev)], results["cpu"]
    check(np.isfinite(lg).all() and lg.shape == (cfg.vocab_size,),
          "(e) moe: card logits not finite or of the wrong shape")
    logit_diff = float(np.abs(lg - lc).max())
    # routing on the same layer inputs (what the CPU prefill fed each MoE
    # block: 3 rounds of 16 tokens, layers in turn): card against CPU
    agree, margins, flips = [], [], []
    for li in range(2):
        h = torch.cat([recorded[r * 2 + li][0] for r in range(
            len(recorded) // 2)])[None]
        pl_cpu = T._index(p_cpu["layers"]["moe"], li, 0)
        pl_card = T._index(p_card["layers"]["moe"], li, 0)
        probs, _, e_cpu = moe_lib.route(pl_cpu, cfg2, h)
        _, _, e_card = moe_lib.route(pl_card, cfg2, h.to(dev))
        e_card = e_card.cpu()
        same = (e_card[..., :, None] == e_cpu[..., None, :]).any(-1)
        agree.append(float(same.float().mean()))
        top = torch.sort(probs, dim=-1, descending=True).values
        margin = top[..., K - 1] - top[..., K]
        margins.append(float(margin.min()))
        for t in torch.nonzero(~same.all(-1)[0]).flatten().tolist():
            flips.append(dict(layer=li, token=t,
                              margin=float(margin[0, t])))
    out["card_vs_cpu"] = dict(logit_diff=logit_diff, tokens_card=tg,
                              tokens_cpu=tc, routing_agreement=agree,
                              min_topk_margin=margins, flips=flips)
    print(f"(e) moe 2-layer full-width paged, card vs CPU: last logits max "
          f"|diff| {logit_diff:.3e} (tol {CPU_LOGIT_TOL}); greedy card {tg} "
          f"cpu {tc}; (token, k) expert choices that agree on the same "
          f"layer inputs, per layer: {agree}; min top-K margin per layer "
          f"{margins}; flips {flips}", flush=True)
    check(logit_diff <= CPU_LOGIT_TOL, "(e) moe: card and CPU logits disagree")
    check(tg == tc, "(e) moe: card and CPU greedy tokens differ")
    del p_card, p_cpu, recorded
    held_bytes(torch, dev)
    return out


# ---------------------------------------------------------------------------
# qwen2-vl-72b (phase 19) and whisper-small (phase 20)
# ---------------------------------------------------------------------------

def held_bytes(torch, dev) -> int:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def decode_round(torch, T, cfg, params, dev, extra=None, lens=None,
                 paged=True) -> dict:
    """One B = 8 decode round at full width, as ``moe_phase`` (c): paged
    at contexts 512-2048 on random K/V pages (or a dense random stripe of
    ``max(lens)`` positions), captured and replayed against one eager
    ``decode_step`` (bit for bit), both timed with CUDA events (20
    replays, 3 eager steps), beside the bound of reading every weight
    once.  ``extra``: more batch entries (the encoder pool)."""
    import numpy as np
    from repro_torch.serving.programs import CapturedProgram
    lens = lens or [512, 731, 950, 1170, 1389, 1609, 1828, 2048]
    KV, D = cfg.num_kv_heads, cfg.resolved_head_dim
    if paged:
        dc = decode_case(torch, np.random.default_rng(19), dev, B=8, KV=KV,
                         G=cfg.num_heads // KV, D=D, page=16, lengths=lens,
                         garbage=False)
        lead = tuple(T._cache_struct(cfg, 1, 16)["layers"]["k"][0][:-4])
        shape = lead + (dc["k_pages"].shape[0], 16, KV, D)
        cache = {"layers": {n: torch.randn(shape, dtype=torch.bfloat16,
                                           device=dev) for n in "kv"}}
        step_in = {"positions": (dc["lengths"] - 1).to(torch.int32),
                   "block_tables": dc["block_tables"]}
    else:
        cache = T.init_cache(cfg, 8, max(lens), device=dev)
        for t in _leaves(cache):
            t.copy_(torch.randint(-100, 100, t.shape, device=dev)
                    if t.dtype == torch.int8 else
                    torch.rand(t.shape, device=dev) * 0.02
                    if t.dim() == 4 else torch.randn(t.shape, device=dev))
        step_in = {"positions": torch.tensor([n - 1 for n in lens],
                                             dtype=torch.int32, device=dev)}
    step_in["tokens"] = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    extra = extra or {}
    step = CapturedProgram("decode_step", lambda **b: T.decode_step(
        params, cfg, dict(b, cache=cache, **extra))[0], step_in)
    rs = np.random.default_rng(4)
    step.feed(tokens=rs.integers(0, cfg.vocab_size, (8, 1), dtype=np.int32))
    before = [t.clone() for t in _leaves(cache)]
    replayed = step.replay().clone()
    for t, b in zip(_leaves(cache), before):
        t.copy_(b)
    del before
    eager = T.decode_step(params, cfg, dict(step_in, cache=cache,
                                            **extra))[0]
    diff = float((replayed - eager).abs().max())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    for _ in range(20):
        step.replay()
    ev[1].record()
    for _ in range(3):
        T.decode_step(params, cfg, dict(step_in, cache=cache, **extra))
    ev[2].record()
    torch.cuda.synchronize()
    return dict(replay_ms=ev[0].elapsed_time(ev[1]) / 20,
                eager_ms=ev[1].elapsed_time(ev[2]) / 3,
                capture_s=step.capture_s, captures=step.captures,
                replay_vs_eager_max_diff=diff,
                weights_read_bound_ms=tree_bytes(params) / HBM_BYTES_PER_S
                * 1e3, contexts=lens)


def vlm_phase(torch, T, dev, counters, by_name, rms_paths) -> dict:
    """qwen2-vl-72b at full width (d 8,192, 64 / 8 heads of 128, d_ff
    29,568, vocab 152,064, M-RoPE 16/24/24, 256 patch embeddings), random
    weights from seed 0 drawn on the card: (a) training through
    ``stepfn.make_train_step`` (the launcher's step, AdamW in place) at
    1 layer (2 exceed the card), AdamW, B 2, S 1,024 (256 patches + 768 text
    tokens), remat, 8 steps, then the launcher's smoke run; (b) paged
    serving at 32 layers (61.2 GB of bf16 weights) through the scheduler
    and engine on phase 5 (b)'s workload, a B = 8 decode round replayed
    and eager; (c) card against CPU at 2 layers: forward logits with the
    patch prefix and M-RoPE, the loss, greedy tokens of a short paged
    serve.  Adds the paths' launches to ``by_name`` and ``rms_paths``."""
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch import train as train_launcher
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    arch = "qwen2-vl-72b"
    full = get_config(arch)
    out = {}

    # (a) training at full width ------------------------------------------
    def train(L):
        cfg = full.with_(num_layers=L)
        torch.cuda.reset_peak_memory_stats(dev)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, weight_dtype=torch.float32)
        opt = optim.adamw(3e-4, clip_norm=1.0)     # the launcher's
        state = opt.init(params)
        src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 1024, 2))
        res = dict(layers=L, params=sum(t.numel() for t in _leaves(params)),
                   losses=[], step_s=[], flash=[], rmsnorm=[], one_pass=[])
        with hvd.init("cuda") as device:
            groups = hvd.axis_groups({"data": 1})
            step = stepfn.make_train_step(cfg, opt, groups, device=device)
            zero_counts(counters)
            for i in range(8):
                batch = train_launcher.family_batch(cfg, src.batch(i), i)
                n0 = {k: f.launches for k, f in counters.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                res["losses"].append(float(m["loss"]))
                res["step_s"].append(time.perf_counter() - t0)
                n1 = {k: f.launches for k, f in counters.items()}
                res["flash"].append(n1["flash_attention"]
                                    - n0["flash_attention"])
                res["rmsnorm"].append(n1["rmsnorm"] - n0["rmsnorm"])
                res["one_pass"].append(n1["rmsnorm_one_pass"]
                                       - n0["rmsnorm_one_pass"])
            launches = read_counts(counters)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        steady = res["step_s"][1:]
        res["step_ms"] = sum(steady) / len(steady) * 1e3
        res["tokens_per_s"] = 2 * 1024 / (res["step_ms"] / 1e3)
        res["launches"] = launches
        return res

    held = held_bytes(torch, dev)
    check(held < 4 * 2**30, f"(a) vlm: {held} bytes held before training")
    # one layer: the step peaks at ~20 bytes a parameter (f32 params,
    # AdamW state, gradients and the all_reduce's fused copy of them;
    # 68.87 GB at 1 layer, 3.37 B parameters), so two layers (4.25 B)
    # would need ~85 GB before any activation, all of the card's 85.5 GB
    # (PERF.md section 4)
    run = train(1)
    launches = run.pop("launches")
    L = run["layers"]
    out["train"] = run
    print("(a) vlm training (full width, make_train_step, AdamW in place, "
          "B 2, S 1024 = 256 patches + 768 text, remat): "
          + json.dumps(out["train"]), flush=True)
    check(all(np.isfinite(run["losses"])), "(a) vlm: a loss is not finite")
    check(run["losses"][-1] < run["losses"][0],
          "(a) vlm: the loss did not fall over 8 steps")
    # remat: each layer's attention twice a step, its two norms twice, the
    # final norm once; every norm on the one-pass kernel (d 8,192)
    check(run["flash"] == [2 * L] * 8, f"(a) vlm: flash launches a step "
          f"{run['flash']}, want {2 * L}")
    check(run["rmsnorm"] == [4 * L + 1] * 8 and run["one_pass"]
          == run["rmsnorm"], f"(a) vlm: rmsnorm launches a step "
          f"{run['rmsnorm']} (one pass {run['one_pass']}), want {4 * L + 1}")
    check(launches["flash_attention_tensor_core"]
          == launches["flash_attention"], "(a) vlm: a flash launch missed "
          "the tensor-core kernel")
    k = by_name["flash_attention"]
    k["launches_per_path"][f"training {arch} ({L} layers)"] = \
        launches["flash_attention"]
    k["launches"] = sum(k["launches_per_path"].values())
    rms_paths[f"training {arch}"] = launches["rmsnorm"]
    held_bytes(torch, dev)
    zero_counts(counters)
    smoke = train_launcher.main(["--arch", arch, "--smoke", "--device",
                                 "cuda", "--steps", "2"])
    del smoke["params"]
    lc = read_counts(counters)
    out["launcher_smoke"] = {k: smoke[k] for k in ("losses",
                                                    "launches_per_step")}
    print("(a) vlm launcher --smoke on the card: "
          + json.dumps(out["launcher_smoke"]), flush=True)
    check(all(np.isfinite(smoke["losses"])) and lc["flash_attention"] > 0
          and lc["rmsnorm"] > 0, "(a) vlm launcher smoke: no kernel ran or "
          "a loss is not finite")

    # (b) paged serving at 32 layers --------------------------------------
    held = held_bytes(torch, dev)
    check(held < 4 * 2**30, f"(b) vlm: {held} bytes held before serving")
    cfg32 = full.with_(num_layers=32)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    out["init"] = dict(init_s=time.perf_counter() - t0,
                       weight_bytes=tree_bytes(params),
                       init_peak_bytes=torch.cuda.max_memory_allocated(dev))
    print(f"(b) vlm: 32 layers' weights made on the card in "
          f"{out['init']['init_s']:.2f} s, {out['init']['weight_bytes']} "
          "bytes", flush=True)
    rs = np.random.default_rng(1)
    shared = rs.integers(0, cfg32.vocab_size, 256, dtype=np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, cfg32.vocab_size, int(rs.integers(64, 769)), dtype=np.int32)])
        for _ in range(8)]
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg32, params, max_seq_len=2048, max_slots=8,
                        prefix_cache_blocks=256, paged=True,
                        prefill_batch=4, device=dev)
    sched = Scheduler(eng, prefill_token_budget=512, profile=True)
    zero_counts(counters)
    rids = [sched.submit(Request(p, SamplingParams(max_new_tokens=32,
                                                   greedy=True)))
            for p in prompts]
    run_marking_warm(sched)
    torch.cuda.synchronize()
    launches_b = read_counts(counters)
    rep = report_serving(torch, sched, "(b) vlm paged, 32 layers", dev)
    outs = [sched.output(r) for r in rids]
    check(all(len(o) == 32 for o in outs), "(b) vlm: a request did not "
          "complete")
    check(rep["prefix_hit_rate"] > 0, "(b) vlm: no prefix-cache hit")
    check_no_leaks(sched, "(b) vlm")
    check_programs(eng, "(b) vlm", "prefill_paged",
                   eng.prefill_batch * eng.prefill_chunk)
    per_replay = check_round_launches(eng, launches_b, "(b) vlm", cfg32)
    out["serve"] = dict(rep, per_replay=per_replay,
                        decode_replays=eng.programs["decode_step"].replays,
                        prefill_replays=eng.programs["prefill_paged"].replays,
                        capture_s={n: p.capture_s for n, p in
                                   eng.programs.items()})
    del sched, eng
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        by_name[name]["launches"] += launches_b[name]
        by_name[name]["launches_per_part"].append(launches_b[name])
    rms_paths[f"serving {arch}"] = launches_b["rmsnorm"]
    out["decode_round"] = decode_round(torch, T, cfg32, params, dev)
    print("(b) vlm B = 8 decode round, 32 layers (contexts 512-2048; CUDA "
          "events; bound: every weight read once): "
          + json.dumps(out["decode_round"]), flush=True)
    check(out["decode_round"]["replay_vs_eager_max_diff"] == 0.0,
          "(b) vlm: the replayed decode round differs from the eager one")

    # (c) card against CPU at 2 layers, on weights copied from the card ----
    cfg2 = full.with_(num_layers=2)
    p_cpu = shared_cpu(torch, dict(params, layers=_map(params["layers"],
                                                       lambda t: t[:2])))
    del params
    held_bytes(torch, dev)
    p_card = _map(p_cpu, lambda t: t.to(dev))
    rng = np.random.default_rng(20)
    P, text = cfg2.num_patches, 16
    batch = {"patch_embeddings": torch.from_numpy((0.02 * rng.standard_normal(
                 (1, P, cfg2.d_model))).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(
                 0, cfg2.vocab_size, (1, text), dtype=np.int32)),
             "mrope_positions": torch.from_numpy(rng.integers(
                 0, P + text, (3, 1, P + text), dtype=np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg2.vocab_size, (1, P + text), dtype=np.int32))}
    prompt = rng.integers(0, cfg2.vocab_size, 48, dtype=np.int32)
    lg, ls_g, tg = vlm_forward_greedy(torch, dev, cfg2, p_card, batch,
                                      prompt)

    def finish(res):
        lc, ls_c, tc = res
        diff = float((lg - lc).abs().max())
        print(f"(c) vlm 2-layer full width, card vs CPU (256 patches + 16 "
              f"text tokens, M-RoPE): text logits max |diff| {diff:.3e} (tol "
              f"{CPU_LOGIT_TOL}); loss {ls_g:.6f} / {ls_c:.6f}; greedy "
              f"(paged, 48-token prompt) card {tg} cpu {tc}", flush=True)
        check(bool(torch.isfinite(lg).all())
              and lg.shape == (text, cfg2.vocab_size),
              "(c) vlm: card logits not finite or of the wrong shape")
        check(diff <= CPU_LOGIT_TOL, "(c) vlm: card and CPU logits disagree")
        check(abs(ls_g - ls_c) <= TRAIN_LOSS_RTOL * abs(ls_c),
              "(c) vlm: card and CPU losses disagree")
        check(tg == tc, "(c) vlm: card and CPU greedy tokens differ")
        return dict(logit_diff=diff, loss_card=ls_g, loss_cpu=ls_c,
                    tokens_card=tg, tokens_cpu=tc)
    CPU_SIDE.submit("(c) vlm 2-layer full width", "vlm_forward_greedy",
                    finish, cfg=cfg2, params=p_cpu, batch=batch,
                    prompt=prompt)
    del p_card, p_cpu
    held_bytes(torch, dev)
    return out


def whisper_phase(torch, T, dev, counters, by_name, rms_paths) -> dict:
    """whisper-small whole (12 + 12 layers, d 768, 12 heads of 64, 1,500
    frames, LayerNorm, GELU), random weights from seed 0: (a) the launcher
    ``--seq-len 448 --global-batch 8 --steps 8`` (flash launches a step
    split causal / non-causal); (b) dense serving through the scheduler
    and engine, bf16 KV then int8: 8 requests, each with its own frames
    (1,500 x 768 from a numpy seed), 4-token prompts, 64 new tokens, 8
    slots, max_seq_len 448 (whisper's decoder context); the encoder's ms
    a request; a B = 8 decode round replayed == eager; paged mode
    refused; (c) card against CPU at full depth, bf16 and int8: greedy
    tokens identical, last prompt logits within CPU_LOGIT_TOL, other
    frames other tokens.  Adds the paths' launches to ``by_name``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launcher
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    arch = "whisper-small"
    cfg = get_config(arch)
    L, E = cfg.num_layers, cfg.encoder_layers
    out = {}

    # (a) training through the launcher -----------------------------------
    held_bytes(torch, dev)
    zero_counts(counters)
    run = train_launcher.main(["--arch", arch, "--seq-len", "448",
                               "--global-batch", "8", "--steps", "8",
                               "--strategy", "dp"])
    del run["params"]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    per_step = run["launches_per_step"]
    non_causal = launches["flash_non_causal"]
    out["train"] = {k: run.get(k) for k in ("losses", "step_s",
                                            "tokens_per_s",
                                            "launches_per_step",
                                            "max_memory_allocated")}
    out["train"]["flash_non_causal_per_step"] = non_causal / 8
    print("(a) whisper training (launcher, B 8, S 448, 1,500 frames): "
          + json.dumps(out["train"]), flush=True)
    losses = run["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "(a) whisper: the loss did not fall over 8 steps")
    # remat: each encoder layer's attention, each decoder layer's self- and
    # cross-attention, twice a step; LayerNorm has no kernel
    want = 2 * (E + 2 * L)
    check(per_step["flash_attention"] == [want] * 8,
          f"(a) whisper: flash launches a step {per_step['flash_attention']}"
          f", want {want}")
    check(non_causal == 8 * 2 * (E + L), f"(a) whisper: {non_causal} "
          f"non-causal flash launches, want {8 * 2 * (E + L)}")
    check(launches["flash_attention_tensor_core"]
          == launches["flash_attention"] and launches["rmsnorm"] == 0,
          "(a) whisper: a flash launch missed the tensor-core kernel, or a "
          "norm ran RMSNorm")
    k = by_name["flash_attention"]
    k["launches_per_path"][f"training {arch}"] = launches["flash_attention"]
    k["launches"] = sum(k["launches_per_path"].values())

    # (b) dense serving, bf16 then int8 ------------------------------------
    held_bytes(torch, dev)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rs = np.random.default_rng(21)
    frames = [rs.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) for _ in range(8)]
    prompts = [rs.integers(0, cfg.vocab_size, 4, dtype=np.int32)
               for _ in range(8)]
    out["serve"] = {}
    for label, c in (("bf16", cfg), ("int8",
                                      cfg.with_(kv_cache_dtype="int8"))):
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ServingEngine(c, params, max_seq_len=448, max_slots=8,
                            prefill_chunk=16, prefix_cache_blocks=64,
                            device=dev)
        check(eng.prefix_cache is None, f"(b) whisper {label}: a prefix store")
        sched = Scheduler(eng, profile=True)
        zero_counts(counters)
        rids = [sched.submit(Request(p, SamplingParams(
            max_new_tokens=64, greedy=True), encoder_input=f))
            for p, f in zip(prompts, frames)]
        run_marking_warm(sched)
        torch.cuda.synchronize()
        lb = read_counts(counters)
        rep = report_serving(torch, sched, f"(b) whisper dense {label}", dev)
        outs = [sched.output(r) for r in rids]
        check(all(len(o) == 64 for o in outs),
              f"(b) whisper {label}: a request did not complete")
        check_no_leaks(sched, f"(b) whisper {label}")
        check(eng.recompiles.warm, f"(b) whisper {label}: the engine never "
              "held both programs")
        check_programs(eng, f"(b) whisper {label}", "prefill_chunk",
                       eng.prefill_chunk)
        steps = eng.decode_steps + eng.prefill_tokens_executed
        # a decode step: one cross-attention flash a layer (and one int8
        # call a layer for the int8 cache); the encoder at admission: one
        # non-causal flash an encoder layer a request
        want = {"flash_attention": L * steps + E * 8,
                "flash_non_causal": L * steps + E * 8,
                "flash_attention_int8kv": L * steps if label == "int8" else 0,
                "rmsnorm": 0, "paged_decode_attention": 0,
                "paged_prefill_attention": 0}
        got = {k: lb[k] for k in want}
        check(got == want, f"(b) whisper {label}: launches {got}, want {want}"
              f" from {steps} steps and 8 encoder runs")
        # the encoder at admission, one request at a time
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for i in range(4):
            eng._encode_into_slot(i, frames[i])
        ev[1].record()
        torch.cuda.synchronize()
        rnd = eager_vs_replay(torch, T, eng, [int(o[-1]) for o in outs],
                              [4 + 63] * 8)
        check(rnd == 0.0, f"(b) whisper {label}: the replayed decode round "
              f"differs from the eager one ({rnd})")
        out["serve"][label] = dict(
            rep, encoder_ms=ev[0].elapsed_time(ev[1]) / 4,
            decode_steps=eng.decode_steps,
            prefill_tokens_executed=eng.prefill_tokens_executed,
            kv_bytes=eng.kv.kv_bytes(), launches=got,
            programs={n: {"captures": p.captures, "replays": p.replays,
                          "capture_s": p.capture_s}
                      for n, p in eng.programs.items()})
        print(f"(b) whisper dense {label}: encoder "
              f"{out['serve'][label]['encoder_ms']:.3f} ms a request; "
              f"launches {got}", flush=True)
        if label == "int8":
            k = by_name["flash_attention_int8kv"]
            k["launches_per_path"][f"dense serving {arch}"] = \
                lb["flash_attention_int8kv"]
            k["launches"] = sum(k["launches_per_path"].values())
        k = by_name["flash_attention"]
        k["launches_per_path"][f"dense serving {arch} {label}"] = \
            lb["flash_attention"]
        k["launches"] = sum(k["launches_per_path"].values())
        out["decode_round_" + label] = decode_round(
            torch, T, c, params, dev, extra={"encoder_output": eng._enc_pool},
            lens=[1, 64, 128, 192, 256, 320, 384, 448], paged=False)
        print(f"(b) whisper B = 8 decode round, dense {label} (contexts "
              "1-448, the engine's encoder pool): "
              + json.dumps(out["decode_round_" + label]), flush=True)
        check(out["decode_round_" + label]["replay_vs_eager_max_diff"]
              == 0.0, f"(b) whisper {label}: the replayed decode round "
              "differs from the eager one")
        del sched, eng
    try:
        ServingEngine(cfg, params, max_seq_len=448, paged=True, device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"(b) whisper paged: refused ({refused})", flush=True)
    check(refused is not None and "non-positional" in refused,
          "(b) whisper: paged mode was not refused")

    # (c) card against CPU at full depth -----------------------------------
    # one request a mode (the CPU runs the encoder and every step's
    # 1,500-frame K/V projections in bf16 on its cores), its 4-token
    # prompt in one 4-token chunk
    p_cpu = shared_cpu(torch, params)
    kw = dict(prefill_chunk=4)
    for label, c in (("bf16", cfg), ("int8",
                                      cfg.with_(kv_cache_dtype="int8"))):
        lg, tg, og = engine_greedy(torch, dev, c, params, prompts[0], new=8,
                                   generate=True, engine_kw=kw,
                                   frames=frames[0], other_frames=frames[1])
        label = f"(c) whisper full depth {label}"
        check(og != tg, f"{label}: other frames gave the same tokens")
        CPU_SIDE.submit(label, "engine_greedy", engine_pair(
            label, lg, tg, lg.shape, diff_name="last prompt logits",
            extra=f"; other frames {og}"), cfg=c, params=p_cpu,
            prompt=prompts[0], new=8, generate=True, engine_kw=kw,
            frames=frames[0])
    del params, p_cpu
    held_bytes(torch, dev)
    return out


# mamba2-1.3b's and zamba2-1.2b's launcher steps (phases 10, 12) and their
# dense serving's requests over 8 slots (phase 14), cut from 8 and 12 for
# the script's time limit when phase 23 came: the checks are per step and
# per replay, and 10 requests still reuse two slots
RECURRENT_TRAIN_STEPS = 5
RECURRENT_REQUESTS = 10
# their card-vs-CPU train steps (phases 11, 13): one row of 512 tokens,
# cut from two beside phase 24 (the CPU's step is the slow part; at two
# rows the loss gaps read 2.6e-6 and 3.6e-5 against TRAIN_LOSS_RTOL 1e-3)
RECURRENT_CPU_BATCH = 1


# ---------------------------------------------------------------------------
# sharded training (phase 21)
# ---------------------------------------------------------------------------

# the big configs of phase 21, cut in depth only (the cut printed)
SHARDED_RUNS = (("gemma2-27b", 2), ("deepseek-coder-33b", 4),
                ("qwen3-moe-30b-a3b", 2))
SHARDED_SEQ, SHARDED_BATCH, SHARDED_STEPS = 2048, 2, 8
# AdamW's rate for (a)-(c): at the launcher's 3e-4 the loss of the cut
# deepseek-coder-33b rises over 8 steps under dp as under fsdp_tp
# (scripts/torch_sharded_probe.py, PERF.md section 6); at 1e-4 each
# falls.  qwen3-moe runs at 2 layers: at 4 (54.4 GB, it fits) its aux
# loss grows over 8 steps at 5e-5 and 1e-4 alike and the loss does not
# fall
SHARDED_LR = 1e-4
# phase 21 (e)'s depths on the CPU: deepseek-coder-33b cut from 2 to 1
# layer (the CPU's bf16 steps took 193 s at 2 each), qwen3-moe from 2 to
# 1 (42 s at 2, its loss gap 0.16 of the tolerance once the CPU held the
# card's initial weights; the 0.998 read at 1 layer before held the CPU's
# weights after one update)
SHARDED_CPU_LAYERS = {"gemma2-27b": 2, "deepseek-coder-33b": 1,
                      "qwen3-moe-30b-a3b": 1}
# and its sequence: 64 tokens, cut from 128 to keep the script within its
# time limit beside phase 24 (the CPU's bf16 step is the slow part; the
# loss a mean over 63 token losses; at 128 the gaps read 0.009-0.16 of
# TRAIN_LOSS_RTOL)
SHARDED_CPU_SEQ = 64
# the D tail's new route at gemma2-27b's local layers: the window binds at
# S 8,192, and at phase 21 (a)'s shape
D160_SETS = {
    "gemma2-27b local, S 8192": dict(B=1, S=8192, H=32, KV=16, D=144,
                                     window=4096, softcap=50.0),
    "gemma2-27b local, (a)'s shape": dict(B=2, S=2048, H=32, KV=16, D=144,
                                          window=4096, softcap=50.0),
}


STEP_TRAIN_B = 2               # train_4k's 256 rows cut to 2 (memory)
STEP_DEEPSEEK_LAYERS = 8       # deepseek-coder-33b's 62 layers cut to 8
STEP_SERVE_STEPS = 8
DRYRUN_PEAK_RTOL = 0.05        # the dry-run's peak against the card's


def _step_args(torch, cfg, shape, dev, params, seed=0):
    """The arguments of ``make_step_for_shape``'s step for ``shape``: the
    params, a fresh AdamW state (train), and ``synthesize_inputs`` drawn
    on the card at ``seed``; a serve step's rows all start 8 positions
    before the end of the cache."""
    from repro_torch import optim
    from repro_torch.configs.base import synthesize_inputs
    batch = synthesize_inputs(cfg, shape,
                              torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
    if shape.kind == "decode":
        batch["positions"].fill_(shape.seq_len - STEP_SERVE_STEPS)
    if shape.kind == "train":
        return (params, optim.adamw(1e-4).init(params), batch)
    return (params, batch)


def _timed(torch, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


STEP_FLASH_BLOCKS = ((0, 512), (-2048, None))   # prefill's query rows held


def rows_plain(torch, q, k, v, q0: int, *, absv: bool = False, hi=None,
               chunk: int = 256):
    """Plain causal attention of the query rows ``q`` (B, n, H, D), at
    positions ``q0 ..``, over k / v (B, Skv, KV, D), in f32, ``chunk``
    rows at a time (the (B, H, S, S) scores of a 32,768-position prompt
    do not fit).  ``absv``: over |V| (the bound's (|P| @ |V|) / l);
    ``hi``: a broken mask, ``hi(pos)`` the keys a row sees.  Returns (out
    (B, n, H, D) f32, lse (B, H, n) f32)."""
    B, n, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kf, vf = k.float(), (v.float().abs() if absv else v.float())
    kpos = torch.arange(Skv, device=q.device)
    outs, lses = [], []
    for c in range(0, n, chunk):
        qc = q[:, c:c + chunk].float()
        m = qc.shape[1]
        s = torch.einsum("bqkgd,btkd->bkgqt", qc.reshape(B, m, KV, G, D),
                         kf) / math.sqrt(D)
        qpos = q0 + c + torch.arange(m, device=q.device)
        lim = qpos + 1 if hi is None else hi(qpos)
        s = s.masked_fill(kpos[None, :] >= lim[:, None], float("-inf"))
        lses.append(torch.logsumexp(s, dim=-1).reshape(B, H, m))
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, -1),
                                 vf).reshape(B, m, H, D))
        del s
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def hold_flash_rows(torch, fa, kref, dev, rng, *, S, H, KV, D) -> dict:
    """Flash at a prompt of ``S`` (B 1, N(0, 1) bf16) against the plain
    version on the rows of ``STEP_FLASH_BLOCKS``: the rounding bound
    (phase 3's, fails above 1) and the lse within ``LSE_TOL``; phase 3's
    broken kernels (the causal mask one key late, a row's last partial kv
    tile dropped, the wrong kv head, l not rescaled) must each fail."""
    fc = flash_case(torch, rng, dev, B=1, S=S, H=H, KV=KV, D=D)
    q, k, v = fc["q"], fc["k"], fc["v"]
    del fc["dout"]
    out, lse = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    p_rel = fa.p_rounding(q.dtype, D)
    idx = (torch.arange(H, device=dev) + (H == KV)) % KV
    kh, vh = k[:, :, idx].contiguous(), v[:, :, idx].contiguous()
    # rows 64 m .. 64 m + 62 see keys [0, 64 m) (rows below 64 whole)
    tile = lambda p: torch.where(((p + 1) % 64 == 0) | (p < 64), p + 1,
                                 p // 64 * 64)
    no_rescale = kref.flash_tiles_ref(q, k, v, causal=True, block_k=64,
                                      rescale_l=False)[0]
    res = {"err": 0.0, "ratio": 0.0, "lse_err": 0.0, "misses": {}}
    for a, b in STEP_FLASH_BLOCKS:
        q0 = a % S
        rows = slice(q0, S if b is None else b)
        qb = q[:, rows]
        plain, plse = rows_plain(torch, qb, k, v, q0)
        plain = plain.to(q.dtype)
        mix, _ = rows_plain(torch, qb, k, v, q0, absv=True)
        got = out[:, rows]
        res["err"] = max(res["err"], (got.float() - plain.float()).abs()
                         .max().item())
        res["ratio"] = max(res["ratio"], kref.rounding_bound_ratio(
            got, plain, mix, p_rel))
        res["lse_err"] = max(res["lse_err"], (lse[..., rows] - plse).abs()
                             .max().item())
        wrongs = {
            "applied the causal mask one key late":
                lambda: rows_plain(torch, qb, k, v, q0 + 1)[0],
            "dropped each row's last partial kv tile":
                lambda: rows_plain(torch, qb, k, v, q0, hi=tile)[0],
            "read kv head h % KV instead of h // G":
                lambda: rows_plain(torch, qb, kh, vh, q0)[0],
            "did not rescale the running sum l":
                lambda: no_rescale[:, rows]}
        for what, wrong in wrongs.items():
            # the blocks are one output: a broken kernel fails where any
            # row reads above the bound
            miss = kref.rounding_bound_ratio(wrong().to(q.dtype), plain, mix,
                                             p_rel)
            res["misses"][what] = max(res["misses"].get(what, 0.0), miss)
        del plain, mix, plse
    return res


def hold_flash_whole(torch, fa, kops, kref, dev, rng, *, B, S, H, KV,
                     D) -> dict:
    """Flash at (B, S) whole, as phase 3 holds it: the rounding bound,
    the lse, dq / dk / dv through ``mha_flash_attention`` against the
    plain version's autograd (``GRAD_TOL``), and ``flash_wrongs``."""
    fc = flash_case(torch, rng, dev, B=B, S=S, H=H, KV=KV, D=D)
    qkv, kw = (fc["q"], fc["k"], fc["v"]), fc["kw"]
    out, lse = fa.flash_attention(*qkv, **kw)
    torch.cuda.synchronize()
    _, ref_lse = fa.flash_attention_plain(*qkv, **kw)
    ref, mix, p_rel = flash_bound(fa, *qkv, kw)
    res = {"err": (out.float() - ref.float()).abs().max().item(),
           "ratio": kref.rounding_bound_ratio(out, ref, mix, p_rel),
           "lse_err": (lse - ref_lse).abs().max().item()}
    del out, lse, ref_lse
    ins = [t.clone().requires_grad_(True) for t in qkv]
    got = torch.autograd.grad(kops.mha_flash_attention(*ins, **kw), ins,
                              fc["dout"])
    ins = [t.clone().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw)[0], ins,
                               fc["dout"])
    res["grad_err"] = max(((g.float() - r.float()).abs().max()
                           / r.float().abs().max()).item()
                          for g, r in zip(got, want))
    del ins, got, want
    res["misses"] = {what: kref.rounding_bound_ratio(wrong(), ref, mix, p_rel)
                     for what, wrong in flash_wrongs(torch, fa, kref, *qkv,
                                                     kw)}
    return res


def hold_int8_cache(torch, fa, kref, dev, rng, cache, positions) -> dict:
    """The int8 kernel on layer 0's cache leaves (B, Skv, KV, D), a N(0, 1)
    query (B, 1, H, D) in the scales' dtype at ``positions`` (q_start, and
    kv_len one past it), against ``attention_int8kv_ref`` (phase 3's
    element rule, ``INT8_BF16_RTOL``), and phase 3's broken kernels (one
    split's partial dropped from the combine of this shape's split plan,
    the scales ignored, kv_len ignored, a row's last partial 64-key tile
    dropped, its newest key missed), which must each fail."""
    k8, ks, v8, vs = (cache[n] for n in ("k", "k_scale", "v", "v_scale"))
    B, Skv, KV, D = k8.shape
    H = cache["heads"]
    G = H // KV
    q = torch.tensor(rng.standard_normal((B, 1, H, D)), dtype=ks.dtype,
                     device=dev)
    qs = positions.to(device=dev, dtype=torch.int32)
    n = qs + 1
    args = (q, k8, ks, v8, vs, qs, n)
    got = fa.flash_attention_int8kv(*args)
    torch.cuda.synchronize()
    ref = kref.attention_int8kv_ref(*args)
    per, splits = fa.int8_split_plan(B, KV, Skv, D, G,
                                     fa.device_sm_count(q.device))
    res = {"err": (got.float() - ref.float()).abs().max().item(),
           "rel": int8_rel_err(got, ref), "keys_per_split": per,
           "splits": splits}
    del got
    keep = drop_first_live(torch, [kref.int8kv_split_ranges(
        a, b, Skv, G, per, splits, row0=0, rows=G)
        for a, b in zip(qs.tolist(), n.tolist())])
    full = torch.full_like(n, Skv)
    tile = torch.where(n > 64, (n - 1) // 64 * 64, n)
    plain = kref.attention_int8kv_ref
    wrongs = {
        "dropped one split's partial from the combine":
            lambda: kref.int8kv_split_ref(*args, keys_per_split=per,
                                          keep=keep),
        "ignored the scales":
            lambda: plain(q, k8, torch.ones_like(ks), v8, torch.ones_like(vs),
                          qs, n),
        "ignored kv_len (the whole stripe)":
            lambda: plain(q, k8, ks, v8, vs, full - 1, full),
        "dropped each row's last partial 64-key tile":
            lambda: plain(q, k8, ks, v8, vs, qs, tile),
        "missed each row's newest key":
            lambda: plain(q, k8, ks, v8, vs, qs, (n - 1).clamp(min=1))}
    res["misses"] = {}
    for what, wrong in wrongs.items():
        res["misses"][what] = int8_rel_err(wrong(), ref)
    return res


def hold_rmsnorm_rows(torch, rn, kref, dev, rng, rows: int, d: int) -> dict:
    """RMSNorm at the step's ``rows`` x ``d`` (N(0, 1) inputs, a 0.1 N(0, 1)
    gain), bf16 and f32 in, bf16 out, and f32 to f32, on the one-pass
    kernel: within one ulp of the plain version (``ulp_ratio``), the
    broken ``rmsnorm_wrongs`` above it."""
    sc = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                      device=dev)
    x32 = torch.randn((rows, d), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(rows))
    res = {"err": 0.0, "ulp": 0.0, "misses": {}}
    for din, dout in ((torch.bfloat16, torch.bfloat16),
                      (torch.float32, torch.bfloat16),
                      (torch.float32, torch.float32)):
        x = x32.to(din)
        n_one = rn.rmsnorm_one_pass.launches
        got = rn.rmsnorm(x, sc, out_dtype=dout)
        torch.cuda.synchronize()
        check(rn.rmsnorm_one_pass.launches == n_one + 1,
              f"RMSNorm at {rows} x {d} missed the one-pass kernel")
        ref = rn.rmsnorm_ref(x, sc, out_dtype=dout)
        res["err"] = max(res["err"], (got.float() - ref.float()).abs()
                         .max().item())
        res["ulp"] = max(res["ulp"], ulp_ratio(got, ref))
        del got
        for what, wrong in rmsnorm_wrongs(rn, kref, x, sc, dout):
            res["misses"][what] = min(res["misses"].get(what, math.inf),
                                      ulp_ratio(wrong(), ref))
        del x, ref
    return res


def hold_step_kernels(torch, cfg, shape, dev, batch, label: str) -> dict:
    """Every kernel ``shape``'s step launched, held against its plain
    version at the step's shape (the module's docstring, phase 22), each
    check and each broken variant asserted; the launches made here are
    the comparison's, read after the step's counts.  The int8 query's
    rows: half at the timed serve calls' positions (where the steps wrote
    the model's own K/V), half spread over the stripe from position 0
    (where the cache holds the drawn codes, whose keys are large enough
    that one key more or less shows in the output)."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(22)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {}
    if shape.kind == "decode" and cfg.kv_cache_dtype == "int8":
        c = {n: t[0, 0] for n, t in batch["cache"]["layers"].items()}
        S, B = shape.seq_len, shape.global_batch
        timed = (S - STEP_SERVE_STEPS + 1
                 + torch.arange(B // 2) % (STEP_SERVE_STEPS - 1))
        spread = (torch.arange(B - B // 2) * (S - STEP_SERVE_STEPS)
                  // (B - B // 2))
        out["flash_attention_int8kv"] = r = hold_int8_cache(
            torch, fa, kref, dev, rng, dict(c, heads=H),
            torch.cat([timed, spread]))
        check(r["rel"] <= INT8_BF16_RTOL, f"{label}: the int8 kernel "
              f"disagrees on layer 0's cache ({r['rel']:.3e})")
    elif shape.kind == "prefill":
        out["flash_attention"] = r = hold_flash_rows(
            torch, fa, kref, dev, rng, S=shape.seq_len, H=H, KV=KV, D=D)
        check(r["ratio"] <= 1.0 and r["lse_err"] <= LSE_TOL,
              f"{label}: flash disagrees at S {shape.seq_len}")
    elif shape.kind == "train":
        out["flash_attention"] = r = hold_flash_whole(
            torch, fa, kops, kref, dev, rng, B=shape.global_batch,
            S=shape.seq_len, H=H, KV=KV, D=D)
        check(r["ratio"] <= 1.0 and r["lse_err"] <= LSE_TOL
              and r["grad_err"] <= GRAD_TOL,
              f"{label}: flash disagrees at (B {shape.global_batch}, S "
              f"{shape.seq_len})")
    held_bytes(torch, dev)
    rows = shape.global_batch * (1 if shape.kind == "decode"
                                 else shape.seq_len)
    out["rmsnorm"] = r = hold_rmsnorm_rows(torch, rn, kref, dev, rng, rows,
                                           cfg.d_model)
    check(r["ulp"] <= 1.0, f"{label}: RMSNorm disagrees at {rows} rows")
    print(f"{label}: kernels against their plain versions at the step's "
          "shape: " + json.dumps(out), flush=True)
    for name, r in out.items():
        tol = INT8_BF16_RTOL if name == "flash_attention_int8kv" else 1.0
        for what, miss in r["misses"].items():
            check(miss > tol, f"{label}: the {name} check misses a kernel "
                  f"that {what} ({miss:.3e})")
    held_bytes(torch, dev)
    return out


def run_shape(torch, T, cfg, shape, dev, groups, counters, params,
              label: str) -> dict:
    """(a)/(b)/(e) for one shape: the step, a warm-up call (not for
    prefill, whose call takes seconds and allocates nothing on its first
    run that it does not on the next), then ``STEP_SERVE_STEPS - 1`` serve
    steps (each at the next position) or one call, the first timed call's
    peak against the dry-run's and every timed call's launches, which
    are counted from 0 over them."""
    from repro_torch.distributed import stepfn
    from repro_torch.launch import dryrun
    step, _ = stepfn.make_step_for_shape(cfg, groups, "dp_tp", shape)
    args = _step_args(torch, cfg, shape, dev, params)
    arg_bytes = sum(tree_bytes(a) for a in args)
    rec = dryrun.count_step(cfg, shape, "dp_tp", {"data": 1, "model": 1})
    if shape.kind != "prefill":
        _timed(torch, step, *args)                  # warm-up
    if shape.kind == "decode":
        args[1]["positions"].add_(1)
    calls = STEP_SERVE_STEPS - 1 if shape.kind == "decode" else 1
    zero_counts(counters)
    secs = []
    for i in range(calls):
        if i == 0:
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        out, dt = _timed(torch, step, *args)
        if i == 0:
            card_peak = (torch.cuda.max_memory_allocated(dev) - held
                         + arg_bytes)
        secs.append(dt)
        if shape.kind == "decode":
            args[1]["positions"].add_(1)
    launches = read_counts(counters)
    logits = out[0] if shape.kind == "decode" else out
    if shape.kind == "train":
        logits = out[2]["loss"]
    check(bool(torch.isfinite(logits).all()), f"{label}: output not finite")
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    ms = sorted(secs)[len(secs) // 2] * 1e3
    gap = (rec["peak_memory_per_device"] - card_peak) / card_peak
    res = {"step_ms_median": ms, "step_ms": [t * 1e3 for t in secs],
           "tokens_per_s": tokens / (ms / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "argument_bytes": arg_bytes,
           "dryrun_argument_size": rec["argument_size"],
           "card_peak": card_peak,
           "dryrun_peak": rec["peak_memory_per_device"], "peak_gap": gap,
           "dryrun_flops": rec["flops"], "dryrun_trace_s": rec["trace_s"],
           "launches_per_call": {k: v // calls for k, v in launches.items()
                                 if v}}
    print(f"{label}: " + json.dumps(res), flush=True)
    check(rec["argument_size"] == arg_bytes,
          f"{label}: dry-run argument_size {rec['argument_size']} != "
          f"{arg_bytes} bytes handed to the step")
    check(abs(gap) <= DRYRUN_PEAK_RTOL,
          f"{label}: dry-run peak {rec['peak_memory_per_device']} vs the "
          f"card's {card_peak} ({gap:+.2%})")
    del out, step
    res["kernel_checks"] = hold_step_kernels(torch, cfg, shape, dev,
                                             args[-1], label)
    del args
    return res, launches


def step_phase(torch, T, dev, counters, by_name, rms_paths) -> dict:
    """Phase 22: the steps by input shape (the module's docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    qcfg = get_config("qwen2-0.5b")
    L = qcfg.num_layers
    check(held_bytes(torch, dev) < 4 * 2**30, "memory held before phase 22")
    want = {"decode_32k": {"flash_attention_int8kv": 0, "rmsnorm": 2 * L + 1},
            "decode_32k int8": {"flash_attention_int8kv": L,
                                "rmsnorm": 2 * L + 1},
            "long_500k": {"flash_attention": 0, "rmsnorm": 2 * L + 1},
            "prefill_32k": {"flash_attention": L, "rmsnorm": 2 * L + 1},
            "train_4k": {"flash_attention": 2 * L, "rmsnorm": 4 * L + 1}}
    with hvd.init("cuda"):
        groups = make_host_mesh()
        params = T.init_params(qcfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, weight_dtype=torch.float32)
        # (a), (e) ----------------------------------------------------------
        runs = (("decode_32k", "bfloat16", None), ("decode_32k", "int8", None),
                ("long_500k", "bfloat16", None),
                ("prefill_32k", "bfloat16", None),
                ("train_4k", "bfloat16", STEP_TRAIN_B))
        for name, kv, B in runs:
            base = SHAPES[name]
            shape = InputShape(name, base.seq_len, B or base.global_batch,
                               base.kind)
            key = name + (" int8" if kv == "int8" else "")
            label = (f"(a) qwen2-0.5b {key} (B {shape.global_batch} x S "
                     f"{shape.seq_len}"
                     + (f", batch cut from {base.global_batch}" if B else "")
                     + ")")
            res, launches = run_shape(torch, T, qcfg.with_(kv_cache_dtype=kv),
                                      shape, dev, groups, counters, params,
                                      label)
            for k, n in want[key].items():
                check(res["launches_per_call"].get(k, 0) == n,
                      f"{label}: {k} launched "
                      f"{res['launches_per_call'].get(k, 0)} times a call, "
                      f"want {n}")
            path = f"step {key} qwen2-0.5b"
            for k in ("flash_attention", "flash_attention_int8kv"):
                if launches[k]:
                    e = by_name[k]
                    e["launches_per_path"][path] = launches[k]
                    e["launches"] = sum(e["launches_per_path"].values())
            rms_paths[path] = launches["rmsnorm"]
            out[key] = res
            held_bytes(torch, dev)

        # (c) the window is real at long_500k -------------------------------
        shape = SHAPES["long_500k"]
        args = _step_args(torch, qcfg, shape, dev, params, seed=1)
        P = shape.seq_len - 1
        args[1]["positions"].fill_(P)
        windowed, _ = stepfn.make_step_for_shape(qcfg, groups, "dp_tp", shape)
        full = stepfn.make_serve_step(qcfg, groups, "dp_tp", shape,
                                      long_context=False)
        a = windowed(*args)[0].clone()
        old = P - qcfg.long_context_window + 1    # the oldest key it sees
        for leaf in _leaves(args[1]["cache"]):
            leaf[..., :old, :, :].normal_(0.0, 4.0)
        b = windowed(*args)[0].clone()
        c = full(*args)[0]
        torch.cuda.synchronize()
        moved = (c - b).abs().max().item()
        out["window"] = {"bitwise_with_long_context": bool(torch.equal(a, b)),
                         "max_change_without": moved}
        print(f"(c) qwen2-0.5b long_500k at position {P}: positions < {old} "
              f"filled with garbage: logits with long_context bit for bit "
              f"{out['window']['bitwise_with_long_context']}; without it "
              f"they move by {moved:.4f}", flush=True)
        check(torch.equal(a, b), "(c) the window leaked: garbage outside it "
              "moved the long_context logits")
        check(moved > 1e-3, "(c) without long_context the garbage changed "
              "nothing")
        del args, a, b, c, params, windowed, full
        held_bytes(torch, dev)

        # (b) deepseek-coder-33b at long_500k, cut in depth -----------------
        dfull = get_config("deepseek-coder-33b")
        dcfg = dfull.with_(num_layers=STEP_DEEPSEEK_LAYERS)
        dparams = T.init_params(dcfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, weight_dtype=torch.float32)
        label = (f"(b) deepseek-coder-33b long_500k (d {dcfg.d_model}, "
                 f"{dcfg.num_heads} / {dcfg.num_kv_heads} heads of "
                 f"{dcfg.resolved_head_dim}, window "
                 f"{dcfg.long_context_window} on every layer; cut from "
                 f"{dfull.num_layers} to {dcfg.num_layers} layers)")
        res, launches = run_shape(torch, T, dcfg, SHAPES["long_500k"], dev,
                                  groups, counters, dparams, label)
        check(res["launches_per_call"].get("rmsnorm", 0)
              == 2 * dcfg.num_layers + 1, f"{label}: rmsnorm launches")
        rms_paths["step long_500k deepseek-coder-33b"] = launches["rmsnorm"]
        out["deepseek long_500k"] = res
        del dparams
        held_bytes(torch, dev)

    # (d) card against CPU at 2 layers -------------------------------------
    out["card_vs_cpu"] = step_card_vs_cpu(torch, T, qcfg.with_(num_layers=2),
                                          dev)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())
    return out


def step_card_vs_cpu(torch, T, cfg, dev) -> dict:
    """(d): the prefill step (B 2 x S 64) and the serve step (B 2, a cache
    of 256, rows at 100 and 255; bf16 and int8 caches) at (1, 1) on the
    card and on the CPU (gloo) from the same f32 weights and inputs: the
    logits within ``CPU_LOGIT_TOL``."""
    from repro_torch.configs.base import InputShape, synthesize_inputs
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    params = T.init_params(cfg, torch.Generator().manual_seed(3),
                           weight_dtype=torch.float32)
    cases = {"prefill": (cfg, InputShape("prefill_32k", 64, 2, "prefill")),
             "serve": (cfg, InputShape("decode_32k", 256, 2, "decode")),
             "serve int8": (cfg.with_(kv_cache_dtype="int8"),
                            InputShape("decode_32k", 256, 2, "decode"))}
    got = {}
    for where in (dev, "cpu"):
        p = _map(params, lambda t: t.to(where))
        with hvd.init(where):
            groups = make_host_mesh()
            for key, (c, shape) in cases.items():
                batch = synthesize_inputs(c, shape,
                                          torch.Generator().manual_seed(4))
                if shape.kind == "decode":
                    batch["positions"] = torch.tensor([100, 255],
                                                      dtype=torch.int32)
                batch = _map(batch, lambda t: t.to(where))
                step, _ = stepfn.make_step_for_shape(c, groups, "dp_tp",
                                                     shape, device=where)
                o = step(p, batch)
                got.setdefault(key, []).append(
                    (o[0] if shape.kind == "decode" else o).float().cpu())
    res = {}
    for key, (card, cpu) in got.items():
        err = (card - cpu).abs().max().item()
        res[key] = err
        check(bool(torch.isfinite(card).all()) and err <= CPU_LOGIT_TOL,
              f"(d) {key}: card and CPU logits {err:.4f} apart")
    print(f"(d) qwen2-0.5b at 2 layers, full width, card vs CPU: max |logit "
          f"diff| " + json.dumps(res) + f" (tolerance {CPU_LOGIT_TOL})",
          flush=True)
    return res


def sharded_data_formula(cfg, specs, params):
    """The data group's all_gather and reduce_scatter (calls, bytes) a
    step at data size 1 from the specs: each leaf split over ``data``
    gathered one layer group at a time, in the forward and again in the
    remat's recompute (the leaves outside the stacks once), and each
    gather's gradient reduce-scattered once."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.transformer import layer_pattern
    groups = cfg.num_layers // len(layer_pattern(cfg))
    gathers = 2 if cfg.remat else 1
    ag, rs = [0, 0], [0, 0]

    def walk(t, s, top):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], top or k)
            return
        if "data" not in sh.axes_of(s):
            return
        n = t.numel() * t.element_size()
        g, per = (gathers, groups) if top == "layers" else (1, 1)
        ag[0] += g * per
        ag[1] += g * n
        rs[0] += per
        rs[1] += n
    walk(params, specs, None)
    return {"all_gather": ag, "reduce_scatter": rs}


def sharded_train(torch, T, cfg, dev, counters) -> dict:
    """``cfg`` (full width, cut in depth) trained through the launcher's
    step: ``stepfn.make_train_step`` with the launcher's AdamW and
    ``family_batch`` on ``launch.mesh.make_host_mesh``'s groups under the
    full config's default strategy, params from the port's
    ``init_params`` at seed 0 drawn on the card, cut into this rank's
    shards; AdamW at ``SHARDED_LR``.  Per step: loss, ms, kernel
    launches, the data and model groups' collectives."""
    from repro_torch import optim
    from repro_torch.configs import default_strategy, get_config
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    strategy = default_strategy(get_config(cfg.name))
    torch.cuda.reset_peak_memory_stats(dev)
    res = {"arch": cfg.name, "layers": cfg.num_layers, "strategy": strategy,
           "losses": [], "aux_losses": [], "step_s": [], "launches": [],
           "data": [], "model": []}
    names = ("flash_attention", "flash_attention_d_tail",
             "flash_attention_tensor_core", "rmsnorm", "rmsnorm_one_pass")
    with hvd.init("cuda") as device:
        groups = make_host_mesh()
        full = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, weight_dtype=torch.float32)
        res["params"] = sum(t.numel() for t in _leaves(full))
        opt = optim.adamw(SHARDED_LR, clip_norm=1.0)
        params, state = stepfn.shard_state(full, cfg, opt, strategy, groups)
        del full
        step = stepfn.make_train_step(cfg, opt, groups, strategy=strategy,
                                      device=device)
        src = SyntheticTokenSource(TokenDatasetSpec(
            cfg.vocab_size, SHARDED_SEQ, SHARDED_BATCH))
        zero_counts(counters)
        for i in range(SHARDED_STEPS):
            batch = train_launcher.family_batch(cfg, src.batch(i), i)
            n0 = {k: counters[k].launches for k in names}
            groups.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            res["losses"].append(float(m["loss"]))
            res["step_s"].append(time.perf_counter() - t0)
            res["aux_losses"].append(float(m["aux_loss"]))
            res["launches"].append({k: counters[k].launches - n0[k]
                                    for k in names})
            for axis in ("data", "model"):
                g = groups[axis]
                res[axis].append({kind: list(v)
                                  for kind, v in g.kinds.items()})
        launches = read_counts(counters)
        res["formula"] = sharded_data_formula(
            cfg, step.specs, stepfn.params_struct(cfg))
        res["mesh"] = groups.shape
        del params, state, step
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    steady = res["step_s"][1:]
    res["step_ms"] = sum(steady) / len(steady) * 1e3
    res["tokens_per_s"] = SHARDED_SEQ * SHARDED_BATCH / (res["step_ms"] / 1e3)
    return res, launches


def sharded_cpu_label(arch: str) -> str:
    return f"(e) {arch} {SHARDED_CPU_LAYERS[arch]}-layer fsdp_tp step"


def queue_sharded_cpu_steps() -> None:
    """Queue phase 21 (e)'s CPU halves (``fsdp_draw_step``); main queues
    them after phase 4's times, so that they run beside phases 5-14."""
    for arch, _ in SHARDED_RUNS:
        CPU_SIDE.prefetch(sharded_cpu_label(arch), "fsdp_draw_step",
                          arch=arch, layers=SHARDED_CPU_LAYERS[arch],
                          seq=SHARDED_CPU_SEQ, batch=1)


def fsdp_draw_step(torch, where, arch: str, layers: int, seq: int,
                   batch: int):
    """``arch`` cut to ``layers``, f32 weights on the CPU's generator at
    seed 1: a copy of them in shared memory (for the card's step), then
    ``fsdp_step_metrics`` on the CPU (which updates the originals)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).with_(num_layers=layers, remat=False)
    params = T.init_params(cfg, torch.Generator().manual_seed(1),
                           weight_dtype=torch.float32)
    keep = shared_cpu(torch, params)
    return keep, fsdp_step_metrics(torch, where, cfg, params, seq, batch)


def sharded_card_vs_cpu(torch, cfg, dev, *, seq: int = SHARDED_CPU_SEQ,
                        batch: int = 1) -> dict:
    """One ``fsdp_tp`` step of ``cfg`` on the card and on the CPU from the
    same f32 weights (drawn on the CPU at seed 1 by ``fsdp_draw_step``,
    queued by ``queue_sharded_cpu_steps``) and batch: loss and the
    gradient's global norm within ``TRAIN_LOSS_RTOL`` and
    ``TRAIN_GNORM_RTOL``.  Without remat on either side (it changes no
    value, and the CPU's bf16 step is the slow part); SGD, as the check
    reads the loss and the norm, which the update does not touch, and
    AdamW's f32 state and update are seconds more of the CPU's step."""
    import numpy as np
    cfg = cfg.with_(remat=False)
    label = sharded_cpu_label(cfg.name)
    host, (lc, nc, tc) = CPU_SIDE.fetch(label)
    card = _map(host, lambda t: t.to(dev))
    del host
    lg, ng, tg = fsdp_step_metrics(torch, dev, cfg, card, seq, batch)
    del card
    torch.cuda.empty_cache()
    print(f"(e) {cfg.name} {cfg.num_layers}-layer full-width fsdp_tp step, "
          f"seq {seq}, batch {batch}: loss cuda {lg:.6f} cpu {lc:.6f} (rtol "
          f"{TRAIN_LOSS_RTOL}); grad norm cuda {ng:.6f} cpu {nc:.6f} (rtol "
          f"{TRAIN_GNORM_RTOL}); {tg:.1f} s / {tc:.1f} s", flush=True)
    check(np.isfinite([lg, ng]).all(), f"(e) {cfg.name}: card step not "
          "finite")
    check(abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc),
          f"(e) {cfg.name}: card and CPU losses disagree")
    check(abs(ng - nc) <= TRAIN_GNORM_RTOL * abs(nc),
          f"(e) {cfg.name}: card and CPU gradient norms disagree")
    out = {"loss": [lg, lc], "grad_norm": [ng, nc], "seconds": [tg, tc]}
    CPU_SIDE.report[label].update(out)
    return out


def strategies_at_one(torch, T, cfg, dev, *, seq: int = 1024,
                      batch: int = 8, steps: int = 2) -> dict:
    """qwen2-0.5b at full width under ``dp``, ``dp_tp`` and ``fsdp_tp`` on
    the (1, 1) host mesh, from the same weights and batches: losses and
    the parameters (gathered) after ``steps`` AdamW steps."""
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, seq, batch))
    out = {}
    for strategy in ("dp", "dp_tp", "fsdp_tp"):
        with hvd.init("cuda") as device:
            groups = make_host_mesh()
            params = T.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                weight_dtype=torch.float32)
            opt = optim.adamw(3e-4, clip_norm=1.0)
            if strategy == "dp":
                state = opt.init(params)
            else:
                params, state = stepfn.shard_state(params, cfg, opt,
                                                   strategy, groups)
            step = stepfn.make_train_step(cfg, opt, groups,
                                          strategy=strategy, device=device)
            losses = []
            for i in range(steps):
                params, state, m = step(params, state, src.batch(i))
                losses.append(float(m["loss"]))
            if strategy != "dp":
                params = sh.unshard(params, step.specs, groups)
            out[strategy] = {"losses": losses, "params": params}
            del state, step
    return out


def flash_route_sets(torch, F, fa, kops, kref, dev, rng, sets, entry, key,
                     tag) -> dict:
    """Flash on its tensor-core route at each of ``sets`` (``flash_case``'s
    shapes with gemma2's window and softcap): the output element by
    element within the 2^-8 bound, the logsumexp, the gradients through
    the autograd Function against the plain version's, the broken
    variants above the bound (``flash_wrongs``: the window's where it
    binds, the causal ones where it does not; ``flash_pad_wrongs`` where
    the wrapper pads D); timed beside SDPA (causal, no window, no
    softcap: the nearest library call), the plain version and the bound.
    Where the kernels take D unpadded, the CUDA-core kernel at the same
    inputs too: within its 2^-14 bound, timed, and slower.  The readings
    go into the kernels-line ``entry`` under ``key``; ``tag`` heads the
    printed lines (phase 21 (d): gemma2-27b's D 144 through the D tail's
    160; phase 24 (b): gemma2-2b's D 288)."""
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    out = {}
    for label, s in sets.items():
        fc = flash_case(torch, rng, dev, **s)
        qkv, kw = (fc["q"], fc["k"], fc["v"]), fc["kw"]
        D = s["D"]
        padded = fa.padded_head_dim(D) != D
        n = (fa.flash_fwd_tensor_core.launches, fa.flash_d_tail.launches,
             fa.flash_fwd_cuda_core.launches)
        got, lse = fa.flash_attention(*qkv, **kw)
        torch.cuda.synchronize()
        check((fa.flash_fwd_tensor_core.launches, fa.flash_d_tail.launches,
               fa.flash_fwd_cuda_core.launches)
              == (n[0] + 1, n[1] + padded, n[2]),
              f"{tag} the D {D} call at {label} missed the tensor-core "
              "route")
        plain, mix, p_rel = flash_bound(fa, *qkv, kw)
        check(p_rel == 2.0 ** -8, f"{tag} the D {D} route's bound is not "
              "the tensor cores'")
        ratio = kref.rounding_bound_ratio(got, plain, mix, p_rel)
        _, want_lse = fa.flash_attention_plain(*qkv, **kw)
        lse_err = (lse - want_lse).abs().max().item()
        err = (got.float() - plain.float()).abs().max().item()
        del got, lse, want_lse
        cuda_core = None if padded else (
            lambda: flash_cuda_core(torch, fa, *qkv, kw)[0])
        cc_ratio = None if padded else kref.rounding_bound_ratio(
            cuda_core(), plain, mix, 2.0 ** -14)
        # the window's variants where it binds; where it does not (S at
        # most the window) the call is the causal one, and so are its
        # broken variants
        wkw = kw if s["S"] > (s["window"] or s["S"]) else dict(kw,
                                                               window=None)
        wrongs = flash_wrongs(torch, fa, kref, *qkv, wkw)
        if padded:
            wrongs += flash_pad_wrongs(torch, fa, *qkv, kw)
        misses = {what: kref.rounding_bound_ratio(wrong(), plain, mix, p_rel)
                  for what, wrong in wrongs}
        del plain, mix
        torch.cuda.empty_cache()
        ins = [t.clone().requires_grad_(True) for t in qkv]
        g_got = torch.autograd.grad(kops.mha_flash_attention(*ins, **kw),
                                    ins, fc["dout"])
        ins = [t.clone().requires_grad_(True) for t in qkv]
        g_want = torch.autograd.grad(
            fa.flash_attention_plain(*ins, **kw)[0], ins, fc["dout"])
        gerr = max(((g.float() - w.float()).abs().max()
                    / w.float().abs().max()).item()
                   for g, w in zip(g_got, g_want))
        del ins, g_got, g_want
        torch.cuda.empty_cache()
        nbytes, flops = flash_cost(fc)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"shape": s, "max_abs_err": err, "ratio": ratio,
             "lse_err": lse_err, "grad_err": gerr, "misses": misses,
             "ms": time_ms(torch, lambda: fa.flash_attention(*qkv, **kw),
                           flush),
             "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                 *qkv, **kw), flush, reps=3, warmup=1),
             "library_ms": time_ms(torch, lambda: library_flash(
                 torch, F, fc), flush),
             "bound_ms": max(t_bytes, t_flops),
             "bound_by": "bytes" if t_bytes >= t_flops else "operations",
             "bytes": nbytes, "flops": flops}
        r["tflops"] = flops / r["ms"] / 1e9
        cc_txt = ""
        if cuda_core is not None:
            r["cuda_core_ratio"] = cc_ratio
            r["cuda_core_ms"] = time_ms(torch, cuda_core, flush, reps=5,
                                        warmup=1)
            cc_txt = (f"; the CUDA-core kernel {cc_ratio:.3e} at 2^-14, "
                      f"{r['cuda_core_ms']:.4f} ms")
        route = f"D {D}" + (f" -> {fa.padded_head_dim(D)}" if padded else "")
        print(f"{tag} flash {route} on the tensor cores, {label} "
              f"{tuple(fc['q'].shape)} over KV {s['KV']}, window "
              f"{s['window']}, softcap {s['softcap']}: max |err| / bound "
              f"{ratio:.3e} (2^-8 (|P| @ |V|) / l + 2^-7 |plain|); lse "
              f"{lse_err:.3e}; grads {gerr:.3e} (tol {GRAD_TOL}); kernel "
              f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f} ms, SDPA (causal only) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}{cc_txt}; broken: "
              + ", ".join(f"a kernel that {w} would read {m:.3e}"
                          for w, m in misses.items()), flush=True)
        check(ratio <= 1.0 and lse_err <= LSE_TOL,
              f"{tag} the D {D} route disagrees at {label}")
        check(gerr <= GRAD_TOL, f"{tag} gradients disagree at {label}")
        for what, miss in misses.items():
            check(miss > 1.0, f"{tag} the check at {label} misses a kernel "
                  f"that {what}")
        if cuda_core is not None:
            check(cc_ratio <= 1.0, f"{tag} the CUDA-core kernel disagrees "
                  f"at {label}")
            check(r["ms"] < r["cuda_core_ms"], f"{tag} the tensor cores are "
                  f"slower than the CUDA cores at {label}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry.setdefault(key, {})[label] = {
            k: r[k] for k in ("ms", "cuda_core_ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by", "max_abs_err")
            if k in r}
        out[label] = r
        del fc, qkv
        torch.cuda.empty_cache()
    del flush
    return out


def sharded_phase(torch, F, T, dev, counters, by_name, rms_paths,
                  bare) -> dict:
    """Phase 21: sharded training at full width (the module's
    docstring)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import train as train_launcher
    out = {}

    # (a)-(c) -------------------------------------------------------------
    for arch, L in SHARDED_RUNS:
        full = get_config(arch)
        cfg = full.with_(num_layers=L)
        check(held_bytes(torch, dev) < 4 * 2**30,
              f"{arch}: memory held before training")
        run, launches = sharded_train(torch, T, cfg, dev, counters)
        print(f"({'abc'[len(out)]}) {arch} at full width (d {cfg.d_model}, "
              f"{cfg.num_heads} / {cfg.num_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}), cut from "
              f"{full.num_layers} to {L} layers, {run['strategy']} on mesh "
              f"{run['mesh']}, B {SHARDED_BATCH} x S {SHARDED_SEQ}, "
              f"{run['params']} parameters: "
              + json.dumps({k: run[k] for k in (
                  "losses", "aux_losses", "step_s", "step_ms",
                  "tokens_per_s", "max_memory_allocated")})
              + f"; launches a step {run['launches'][-1]}; data group a "
              f"step {run['data'][-1]}; model group a step "
              f"{run['model'][-1]}", flush=True)
        check(all(np.isfinite(run["losses"])), f"{arch}: a loss is not "
              "finite")
        check(run["losses"][-1] < run["losses"][0],
              f"{arch}: the loss did not fall over {SHARDED_STEPS} steps")
        if cfg.family == "moe":
            check(all(a > 0 for a in run["aux_losses"]),
                  f"{arch}: no aux loss in the loss")
        # remat: each layer's attention and norms twice a step, the final
        # norm once; every flash on the tensor cores (gemma2's D 144
        # through the D tail's 160), every norm on the one-pass kernel
        norms = 4 if cfg.post_block_norm else 2
        want = {"flash_attention": 2 * L,
                "flash_attention_d_tail": 2 * L if cfg.resolved_head_dim % 32
                else 0,
                "flash_attention_tensor_core": 2 * L,
                "rmsnorm": 2 * norms * L + 1,
                "rmsnorm_one_pass": 2 * norms * L + 1}
        for i, n in enumerate(run["launches"]):
            check(n == want, f"{arch}: launches at step {i} {n}, want "
                  f"{want}")
        for i, d in enumerate(run["data"]):
            check({k: d.get(k) for k in run["formula"]} == run["formula"],
                  f"{arch}: data-group gathers at step {i} {d}, want "
                  f"{run['formula']}")
            check(d == run["data"][0] and run["model"][i]
                  == run["model"][0], f"{arch}: collectives vary by step")
        k = by_name["flash_attention"]
        k["launches_per_path"][f"training {arch} ({L} layers, "
                               f"{run['strategy']})"] = \
            launches["flash_attention"]
        k["launches"] = sum(k["launches_per_path"].values())
        rms_paths[f"training {arch} ({run['strategy']})"] = \
            launches["rmsnorm"]
        out[arch] = {k: v for k, v in run.items() if k != "formula"}
        torch.cuda.empty_cache()

    # (d) the D 160 route where gemma2-27b's window binds ------------------
    rng = np.random.default_rng(21)
    out["d160"] = flash_route_sets(torch, F, fa, kops, kref, dev, rng,
                                   D160_SETS,
                                   by_name["flash_attention_d_tail"],
                                   "windowed", "(d)")

    # (e) card against CPU at full width, cut in depth
    out["card_vs_cpu"] = {}
    for arch, _ in SHARDED_RUNS:
        check(held_bytes(torch, dev) < 4 * 2**30,
              f"{arch}: memory held before the CPU check")
        out["card_vs_cpu"][arch] = sharded_card_vs_cpu(
            torch, get_config(arch).with_(
                num_layers=SHARDED_CPU_LAYERS[arch]), dev)

    # (f) the strategies at (1, 1) against dp, qwen2-0.5b at full width ----
    qcfg = get_config("qwen2-0.5b")
    held_bytes(torch, dev)
    at_one = strategies_at_one(torch, T, qcfg, dev)
    dp = at_one["dp"]
    res_f = {}
    for strategy in ("dp_tp", "fsdp_tp"):
        got = at_one[strategy]
        d_loss = max(abs(a - b) / abs(b) for a, b in
                     zip(got["losses"], dp["losses"]))
        d_par = max((a - b).abs().max().item() for a, b in
                    zip(_leaves(got["params"]), _leaves(dp["params"])))
        res_f[strategy] = {"losses": got["losses"], "loss_rel": d_loss,
                           "param_abs": d_par}
        check(d_loss <= TRAIN_LOSS_RTOL and d_par <= AT_ONE_PARAM_ATOL,
              f"(f) {strategy} at (1, 1) is not the dp step: losses "
              f"{d_loss:.3e}, params {d_par:.3e}")
    same = all(torch.equal(a, b) for a, b in
               zip(_leaves(at_one["dp_tp"]["params"]),
                   _leaves(at_one["fsdp_tp"]["params"])))
    res_f["dp_tp_equals_fsdp_tp_bitwise"] = same
    res_f["dp_losses"] = dp["losses"]
    print("(f) qwen2-0.5b full width at (1, 1), 2 steps, B 8 x S 1024: "
          + json.dumps(res_f) + f" (dp against *_tp: losses rtol "
          f"{TRAIN_LOSS_RTOL}, params within {AT_ONE_PARAM_ATOL})",
          flush=True)
    check(same, "(f) dp_tp and fsdp_tp at (1, 1) differ")
    del at_one, dp
    held_bytes(torch, dev)
    zero_counts(counters)
    run = train_launcher.main(["--arch", "qwen2-0.5b", "--seq-len", "1024",
                               "--global-batch", "8", "--steps", "8"])
    del run["params"]
    launches = read_counts(counters)
    res_f["launcher"] = {k: run[k] for k in (
        "strategy", "mesh", "losses", "step_s", "tokens_per_s",
        "launches_per_step", "collectives_per_step",
        "model_collectives_per_step", "max_memory_allocated")}
    steady = run["step_s"][1:]
    res_f["launcher"]["step_ms"] = sum(steady) / len(steady) * 1e3
    bsteady = bare["step_s"][1:]
    res_f["launcher"]["dp_step_ms"] = sum(bsteady) / len(bsteady) * 1e3
    print("(f) the launcher with no --strategy: "
          + json.dumps(res_f["launcher"]), flush=True)
    check(run["strategy"] == "dp_tp", "(f) the launcher's default is not "
          "dp_tp")
    check(all(np.isfinite(run["losses"]))
          and run["losses"][-1] < run["losses"][0],
          "(f) the dp_tp launcher's loss did not fall")
    check(all(n == 2 * qcfg.num_layers
              for n in run["launches_per_step"]["flash_attention"]),
          "(f) dp_tp flash launches a step")
    by_name["flash_attention"]["launches_per_path"][
        "training qwen2-0.5b (launcher, dp_tp)"] = launches["flash_attention"]
    by_name["flash_attention"]["launches"] = sum(
        by_name["flash_attention"]["launches_per_path"].values())
    rms_paths["training qwen2-0.5b (launcher, dp_tp)"] = launches["rmsnorm"]
    out["at_one"] = res_f
    return out


# ---------------------------------------------------------------------------
# the chunked cross-entropy sharded, remat_policy, the examples (phase 23)
# ---------------------------------------------------------------------------

# (arch, layers (None: whole), strategy, B, S, seq_chunk): the tied
# vocabulary of 256,000 split over model, the untied lm_head with the aux
# loss, and qwen2-0.5b whole under dp at phase 8's shape
CHUNK_RUNS = (("gemma2-27b", 2, "fsdp_tp", 2, 2048, 512),
              ("qwen3-moe-30b-a3b", 2, "dp_tp", 2, 2048, 512),
              ("qwen2-0.5b", None, "dp", 8, 1024, 256))
# the run whose step's peak the f32 logits set: there the chunked peak
# must sit at least one (B, S, V) f32 logits tensor below the plain one,
# on the card and in the dry-run.  In the cut configs at (1, 1) the peak
# is elsewhere (gemma2-27b: the tied embedding's f32 gradient in the
# FSDP reduce-scatter; qwen3-moe: the fused gradient all_reduce), and
# there the chunked loss must not raise the dry-run's peak
CHUNK_PEAK_RUN = "qwen2-0.5b"
# the plain and chunked losses at the same params and batch, relative:
# read 0 (gemma2-27b, qwen2-0.5b) and 7.7e-8 (qwen3-moe) apart on the
# H100 (PERF.md section 6); the broken chunked losses of
# ``chunk_faults`` read 2.3e-4 or more apart, each printed and held
# above it
CHUNK_LOSS_RTOL = 2e-5
# their gradients' global norms, relative: read 1.7e-7 apart where both
# losses take ``vocab_parallel_nll`` (gemma2-27b), 8.6e-5 and 1.3e-4
# where the plain one takes log_softmax and the chunked one logsumexp
# less the target's logit (qwen3-moe, qwen2-0.5b: f32 gradients that
# differ in their last bits round to another bf16 neighbour in places
# in the bf16 backward)
CHUNK_GNORM_RTOL = 1e-3


# remat_policy: qwen2-0.5b's dp step at phase 8's shape, and qwen3-moe at
# 2 layers under fsdp_tp (the reference's hill-climb case)
DOTS_RUNS = (("qwen2-0.5b", None, "dp", 1024, 8),
             ("qwen3-moe-30b-a3b", 2, "fsdp_tp", 2048, 2))
LM_EXAMPLE_STEPS = 30          # torch_train_lm --model 100m, checkpoint at 15
# its batch and rate: at the example's defaults (B 8 x S 128, lr 3e-3)
# 30 steps bring the 100m model's loss down neither in the port nor in
# the reference's examples/train_lm.py, on the CPU (PERF.md section 6)
LM_EXAMPLE_BATCH, LM_EXAMPLE_SEQ = 32, 256
LM_EXAMPLE_ARGS = ["--model", "100m", "--seq-len", str(LM_EXAMPLE_SEQ),
                   "--batch", str(LM_EXAMPLE_BATCH), "--lr", "1e-3"]


def chunk_faults(torch, T, cfg, strategy, groups, params, batch,
                 seq_chunk: int) -> dict:
    """What each of three broken chunked losses adds to the plain loss at
    ``params`` and ``batch``, from the plain forward's f32 token losses:
    one that leaves its padded positions unmasked (a padded position is a
    zero hidden state, logits 0 against target 0: log V each), one that
    takes the mean over the padded length, one that drops its last
    chunk."""
    from repro_torch.distributed import stepfn
    shards = (None if strategy == "dp"
              else stepfn.train_shards(cfg, groups, strategy))
    with torch.no_grad():
        logits = T.forward(params, cfg, batch, shards=shards)[0][:, :-1]
        tgt = batch["labels"][:, 1:].long()
        nll = (torch.logsumexp(logits.float(), -1) - torch.gather(
            logits, -1, tgt[..., None])[..., 0].float())
        del logits
    B, Sm = nll.shape
    pad = (-Sm) % seq_chunk
    ce = float(nll.double().sum()) / (B * Sm)
    last = float(nll[:, Sm + pad - seq_chunk:].double().sum()) / (B * Sm)
    return {"left its padding unmasked": pad * math.log(cfg.vocab_size)
            / Sm,
            "took the mean over the padded length": ce * Sm / (Sm + pad)
            - ce,
            "dropped its last chunk": -last}


def loss_grads(torch, T, cfg, params, batch, shards):
    """(loss, gradients, forward products, products the backward ran)
    of ``lm_loss`` at ``params`` (``transformer.DotsCounter``)."""
    from repro_torch.optim import tree_map
    leaves = []

    def alias(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]
    p = tree_map(alias, params)
    fwd, bwd = T.DotsCounter(), T.DotsCounter()
    with torch.enable_grad():
        with fwd:
            loss, _ = T.lm_loss(p, cfg, batch, shards)
        with bwd:
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, fwd, bwd


def chunked_pair(torch, T, cfg, strategy, batch: int, seq: int,
                 seq_chunk: int, dev, groups, counters) -> dict:
    """(a) one config's plain and chunked steps (``make_step_for_shape``
    at (1, 1)): the first from the same params and batch, its loss and
    the gradients' global norm (and, before the plain one,
    ``chunk_faults``); then one timed step each: ms, the card's peak over
    it (as phase 22 (e) takes it) beside the dry-run's, launches."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import stepfn
    from repro_torch.launch import dryrun
    shape = InputShape("train_4k", seq, batch, "train")
    out = {}
    for variant, kw in (("plain", {}), ("chunked_ce", {
            "loss_variant": "chunked_ce", "seq_chunk": seq_chunk})):
        check(held_bytes(torch, dev) < 4 * 2**30,
              f"(a) {cfg.name} {variant}: memory held before the step")
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, weight_dtype=torch.float32)
        args = _step_args(torch, cfg, shape, dev, params)
        if variant == "plain":
            out["fault_deltas"] = chunk_faults(torch, T, cfg, strategy,
                                               groups, params, args[-1],
                                               seq_chunk)
        step, _ = stepfn.make_step_for_shape(cfg, groups, strategy, shape,
                                             **kw)
        arg_bytes = sum(tree_bytes(a) for a in args)
        res, _ = _timed(torch, step, *args)         # at the initial params
        r = {"loss": float(res[2]["loss"]),
             "grad_norm": float(res[2]["grad_norm"])}
        del res
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(counters)
        res, dt = _timed(torch, step, *args)
        launches = read_counts(counters)
        card_peak = torch.cuda.max_memory_allocated(dev) - held + arg_bytes
        rec = dryrun.count_step(cfg, shape, strategy, {"data": 1,
                                                       "model": 1}, **kw)
        r.update({"step_ms": dt * 1e3, "step_loss": float(res[2]["loss"]),
                  "card_peak": card_peak,
                  "dryrun_peak": rec["peak_memory_per_device"],
                  "dryrun_peak_at": rec["peak_at"],
                  "peak_gap": (rec["peak_memory_per_device"] - card_peak)
                  / card_peak,
                  "dryrun_argument_size": rec["argument_size"],
                  "argument_bytes": arg_bytes,
                  "launches": {k: v for k, v in launches.items() if v}})
        check(math.isfinite(r["loss"]) and math.isfinite(r["step_loss"]),
              f"(a) {cfg.name} {variant}: loss not finite")
        check(abs(r["peak_gap"]) <= DRYRUN_PEAK_RTOL,
              f"(a) {cfg.name} {variant}: dry-run peak "
              f"{rec['peak_memory_per_device']} vs the card's {card_peak} "
              f"({r['peak_gap']:+.2%})")
        check(rec["argument_size"] == arg_bytes,
              f"(a) {cfg.name} {variant}: dry-run argument_size")
        out[variant] = r
        del params, args, step, res
    return out


def dots_pair(torch, T, arch, layers, strategy, seq, batch, dev, groups,
              counters) -> dict:
    """(b) one config under ``remat_policy`` "nothing" and "dots" from the
    same params and batch: the loss and every gradient (bit for bit),
    the forward products the backward re-ran, then 2 steps of the
    launcher's step (``make_train_step``, AdamW 1e-4): the second's ms
    and peak, launches."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    base = get_config(arch)
    if layers:
        base = base.with_(num_layers=layers)
    src = SyntheticTokenSource(TokenDatasetSpec(base.vocab_size, seq,
                                                batch))
    tb = {k: torch.as_tensor(v).to(dev) for k, v in src.batch(0).items()}
    out, first = {}, None
    for pol in ("nothing", "dots"):
        cfg = base.with_(remat_policy=pol)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, weight_dtype=torch.float32)
        loss, grads, fwd, bwd = loss_grads(
            torch, T, cfg, params, tb,
            stepfn.train_shards(cfg, groups, strategy))
        r = out[pol] = {"loss": float(loss),
                        "forward_products": fwd.grad_on,
                        "recomputed_products": bwd.grad_on,
                        "gradient_products": bwd.grad_off}
        if first is None:
            first = (loss, grads)
        else:
            r["loss_bitwise"] = bool(torch.equal(loss, first[0]))
            r["grads_bitwise"] = all(torch.equal(a, b)
                                     for a, b in zip(grads, first[1]))
            r["max_grad_gap"] = max(((a - b).abs().max()
                                     / b.abs().max().clamp_min(1e-30)).item()
                                    for a, b in zip(grads, first[1]))
        del params, grads
    del first
    # the steps with nothing else held, each from fresh params
    for pol in ("nothing", "dots"):
        cfg = base.with_(remat_policy=pol)
        check(held_bytes(torch, dev) < 4 * 2**30,
              f"(b) {arch} {pol}: memory held")
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, weight_dtype=torch.float32)
        r = out[pol]
        opt = optim.adamw(1e-4, clip_norm=1.0)
        if strategy == "dp":
            state = opt.init(params)
        else:
            params, state = stepfn.shard_state(params, cfg, opt, strategy,
                                               groups)
        step = stepfn.make_train_step(cfg, opt, groups, strategy=strategy,
                                      device=dev)
        host = src.batch(0)
        _timed(torch, step, params, state, host)    # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(counters)
        res, dt = _timed(torch, step, params, state, host)
        launches = read_counts(counters)
        del res                 # the step's (params, state, metrics)
        r.update({"step_ms": dt * 1e3,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(
                      dev),
                  "launches": {k: v for k, v in launches.items() if v}})
        del params, state, step
    return out


def load_example(name: str):
    """``examples/<name>.py`` as a module, its ``main`` not run (the
    tests load the examples through it too)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv, counters):
    """``examples/<name>.py``'s ``main(argv)`` in this process, its
    standard output kept (and printed, indented) and its launches counted
    from 0: (result, output, launches)."""
    import contextlib
    import io
    buf = io.StringIO()
    zero_counts(counters)
    try:
        with contextlib.redirect_stdout(buf):
            res = load_example(name).main(argv)
    finally:
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"    | {line[:200]}")
        sys.stdout.flush()
    return res, text, read_counts(counters)


def hold_lm_example(torch, dev, cfg) -> dict:
    """The kernels ``torch_train_lm`` at ``LM_EXAMPLE_ARGS`` launched,
    against their plain versions at its shapes (phase 3's checks and
    broken variants, as ``hold_step_kernels``): flash whole with its
    gradients at (B, S, H / KV, D), RMSNorm at its B x S rows of
    ``d_model``."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(23)
    B, S = LM_EXAMPLE_BATCH, LM_EXAMPLE_SEQ
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {"flash_attention": hold_flash_whole(
        torch, fa, kops, kref, dev, rng, B=B, S=S, H=H, KV=KV, D=D),
        "rmsnorm": hold_rmsnorm_rows(torch, rn, kref, dev, rng, B * S,
                                     cfg.d_model)}
    out["flash_attention"]["shapes"] = (f"q ({B}, {S}, {H}, {D}), k/v ({B}, "
                                        f"{S}, {KV}, {D}) bf16, causal")
    out["rmsnorm"]["shapes"] = f"{B * S} x {cfg.d_model}"
    r = out["flash_attention"]
    check(r["ratio"] <= 1.0 and r["lse_err"] <= LSE_TOL
          and r["grad_err"] <= GRAD_TOL,
          f"(c) torch_train_lm: flash disagrees at (B {B}, S {S})")
    check(out["rmsnorm"]["ulp"] <= 1.0,
          f"(c) torch_train_lm: RMSNorm disagrees at {B * S} rows")
    return out


def hold_serve_example(torch, dev, cfg, turns, slots: int, chunk: int,
                       page: int) -> dict:
    """The paged kernels ``torch_serve_lm --chat`` launched, against their
    plain versions at its shapes (phase 3's bounds and broken variants):
    the smoke config's heads over ``page``-token pages; decode over the
    engine's ``slots`` rows at each turn's last context (its prompt and
    reply), a free slot at length 0; prefill of a ``chunk``-token chunk
    over ``slots`` rows, each turn's last recomputed chunk (its start and
    length), a row with nothing to prefill."""
    import numpy as np
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(23)
    KV, D = cfg.num_kv_heads, cfg.resolved_head_dim
    G = cfg.num_heads // KV
    turns = turns[:slots]
    free = [0] * (slots - len(turns))
    lengths = [t["prompt"] + len(t["reply"]) for t in turns] + free
    starts, q_lens = [], []
    for t in turns:
        k = (t["recomputed"] - 1) // chunk
        starts.append(t["prompt"] - t["recomputed"] + k * chunk)
        q_lens.append(t["recomputed"] - k * chunk)
    starts, q_lens = starts + free, q_lens + free
    out = {}
    dc = decode_case(torch, rng, dev, B=slots, KV=KV, G=G, D=D, page=page,
                     lengths=lengths)
    got = pa.paged_attention(*decode_args(dc), window=None, softcap=None)
    torch.cuda.synchronize()
    ref_, mix = decode_bound(pa, dc)
    r = out["paged_decode_attention"] = {
        "shapes": f"q ({slots}, {KV}, {G}, {D}) bf16, {page}-token pages, "
                  f"contexts {lengths}",
        "err": (got.float() - ref_.float()).abs().max().item(),
        "ratio": kref.rounding_bound_ratio(got, ref_, mix, pa.P_ROUNDING),
        "misses": {what: kref.rounding_bound_ratio(wrong(), ref_, mix,
                                                   pa.P_ROUNDING)
                   for what, wrong in decode_wrongs(torch, pa, kref, dc)}}
    zero_ok = all(bool((got[b] == 0).all())
                  for b, n in enumerate(lengths) if n == 0)
    check(r["ratio"] <= 1.0 and zero_ok, "(c) torch_serve_lm: the decode "
          f"kernel disagrees at its shapes ({r['ratio']:.3e})")
    del dc, got, ref_, mix
    pc_ = prefill_case(torch, rng, dev, B=slots, KV=KV, G=G, D=D, page=page,
                       C=chunk, starts=starts, q_lens=q_lens)
    got = pp.paged_prefill(*prefill_args(pc_), group=G, window=None,
                           softcap=None)
    torch.cuda.synchronize()
    ref_, mix, p_rel = prefill_bound(pp, pc_)
    r = out["paged_prefill_attention"] = {
        "shapes": f"q ({slots}, {KV}, {chunk}*{G}, {D}) bf16, C = {chunk}, "
                  f"starts {starts}, q_lens {q_lens}",
        "err": (got.float() - ref_.float()).abs().max().item(),
        "ratio": kref.rounding_bound_ratio(got, ref_, mix, p_rel),
        "misses": {what: kref.rounding_bound_ratio(wrong(), ref_, mix, p_rel)
                   for what, wrong in prefill_wrongs(torch, pa, pp, kref,
                                                     pc_)}}
    check(r["ratio"] <= 1.0 and padding_rows_zero(got, pc_),
          "(c) torch_serve_lm: the prefill kernel disagrees at its shapes "
          f"({r['ratio']:.3e})")
    return out


def record_holds(by_name, holds: dict, label: str) -> None:
    """Print ``holds`` (kernel -> readings), fail where a broken variant
    reads within its bound, and add the readings to the kernels line
    (``example_shapes``)."""
    print(f"(c) {label}: kernels against their plain versions at its "
          "shapes: " + json.dumps(holds), flush=True)
    for name, r in holds.items():
        for what, miss in r["misses"].items():
            check(miss > 1.0, f"(c) {label}: the {name} check misses a "
                  f"kernel that {what} ({miss:.3e})")
        e = {k: v for k, v in r.items() if k != "misses"}
        e["max_abs_err"] = e.pop("err")
        by_name[name].setdefault("example_shapes", []).append(
            dict(e, path=label))


def chunked_phase(torch, T, dev, counters, by_name, rms_paths) -> dict:
    """Phase 23: the chunked cross-entropy sharded, ``remat_policy``, the
    examples (the module's docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core import hvd
    from repro_torch.launch.mesh import make_host_mesh
    out = {"chunked": {}, "dots": {}, "examples": {}}

    def add_path(path, launches):
        for k in ("flash_attention",):
            if launches.get(k):
                e = by_name[k]
                e["launches_per_path"][path] = launches[k]
                e["launches"] = sum(e["launches_per_path"].values())
        if launches.get("rmsnorm"):
            rms_paths[path] = launches["rmsnorm"]

    # (a) the chunked loss against the plain one, sharded ----------------
    with hvd.init("cuda"):
        groups = make_host_mesh()
        for arch, L, strategy, B, S, seq_chunk in CHUNK_RUNS:
            full = get_config(arch)
            cfg = full.with_(num_layers=L) if L else full
            L = cfg.num_layers
            r = chunked_pair(torch, T, cfg, strategy, B, S, seq_chunk, dev,
                             groups, counters)
            p, c = r["plain"], r["chunked_ce"]
            gap = abs(c["loss"] - p["loss"]) / abs(p["loss"])
            gnorm_gap = abs(c["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
            faults = {what: abs(d) / abs(p["loss"])
                      for what, d in r.pop("fault_deltas").items()}
            logits = B * S * cfg.vocab_size * 4
            r.update({"loss_gap": gap, "loss_rtol": CHUNK_LOSS_RTOL,
                      "broken_loss_gaps": faults, "grad_norm_gap": gnorm_gap,
                      "grad_norm_rtol": CHUNK_GNORM_RTOL,
                      "peak_saved": p["card_peak"] - c["card_peak"],
                      "dryrun_peak_saved": p["dryrun_peak"]
                      - c["dryrun_peak"], "logits_bytes": logits})
            cut = f"cut to {L} layers" if L < full.num_layers else "whole"
            print(f"(a) {arch} at full width {cut}, {strategy} at (1, 1), "
                  f"B {B} x S {S}, seq_chunk {seq_chunk}: loss plain "
                  f"{p['loss']:.6f} chunked {c['loss']:.6f} (gap "
                  f"{gap:.3e}, rtol {CHUNK_LOSS_RTOL:.0e}; broken chunked "
                  f"losses: " + ", ".join(f"{w} {g:.3e}" for w, g in
                                          faults.items())
                  + f"); grad norm plain {p['grad_norm']:.6f} chunked "
                  f"{c['grad_norm']:.6f} (gap {gnorm_gap:.3e}, rtol "
                  f"{CHUNK_GNORM_RTOL:.0e}); step ms plain "
                  f"{p['step_ms']:.1f} chunked {c['step_ms']:.1f}; peak GB "
                  f"plain {p['card_peak'] / 1e9:.3f} (dry-run "
                  f"{p['dryrun_peak'] / 1e9:.3f}) chunked "
                  f"{c['card_peak'] / 1e9:.3f} (dry-run "
                  f"{c['dryrun_peak'] / 1e9:.3f}); saved "
                  f"{r['peak_saved'] / 1e9:.3f} GB (dry-run "
                  f"{r['dryrun_peak_saved'] / 1e9:.3f}) against the "
                  f"{logits / 1e9:.3f} GB of f32 logits; the dry-run's "
                  f"peak at {p['dryrun_peak_at']} (plain), "
                  f"{c['dryrun_peak_at']} (chunked): " + json.dumps(r),
                  flush=True)
            check(gap <= CHUNK_LOSS_RTOL, f"(a) {arch}: chunked and plain "
                  f"losses {gap:.3e} apart")
            for what, g in faults.items():
                check(g > CHUNK_LOSS_RTOL, f"(a) {arch}: the loss check "
                      f"misses a chunked loss that {what} ({g:.3e})")
            check(gnorm_gap <= CHUNK_GNORM_RTOL, f"(a) {arch}: gradient "
                  f"norms {gnorm_gap:.3e} apart")
            if arch == CHUNK_PEAK_RUN:
                check(r["peak_saved"] >= logits
                      and r["dryrun_peak_saved"] >= logits,
                      f"(a) {arch}: the chunked loss saved "
                      f"{r['peak_saved']} bytes of peak (dry-run "
                      f"{r['dryrun_peak_saved']}), less than the {logits} "
                      f"of f32 logits")
            else:
                # the peak is not the loss's (CHUNK_PEAK_RUN); in the
                # dry-run's exact count the chunked loss must not raise
                # it (the card's moves by the allocator's blocks)
                check(r["dryrun_peak_saved"] >= 0, f"(a) {arch}: the "
                      f"chunked loss raised the dry-run's peak by "
                      f"{-r['dryrun_peak_saved']} bytes")
            norms = 4 if cfg.post_block_norm else 2
            want = {"flash_attention": 2 * L,
                    "rmsnorm": 2 * norms * L + 1}
            for v in (p, c):
                got = {k: v["launches"].get(k, 0) for k in want}
                check(got == want, f"(a) {arch}: launches {got}, want "
                      f"{want}")
                add_path(f"step {arch} ({L} layers, {strategy}, "
                         f"{'chunked' if v is c else 'plain'})",
                         v["launches"])
            out["chunked"][arch] = r
            held_bytes(torch, dev)

        # (b) remat_policy "dots" against "nothing" ------------------------
        for arch, L, strategy, seq, batch in DOTS_RUNS:
            r = dots_pair(torch, T, arch, L, strategy, seq, batch, dev,
                          groups, counters)
            n, d = r["nothing"], r["dots"]
            print(f"(b) {arch}{f' cut to {L} layers' if L else ''}, "
                  f"{strategy}, B {batch} x S {seq}: \"dots\" against "
                  f"\"nothing\": loss bit for bit {d['loss_bitwise']}, "
                  f"gradients bit for bit {d['grads_bitwise']} (largest "
                  f"gap {d['max_grad_gap']:.3e}); forward products re-run "
                  f"in the backward {n['recomputed_products']} / "
                  f"{d['recomputed_products']}; step ms "
                  f"{n['step_ms']:.1f} / {d['step_ms']:.1f}; peak GB "
                  f"{n['max_memory_allocated'] / 1e9:.3f} / "
                  f"{d['max_memory_allocated'] / 1e9:.3f}: " + json.dumps(r),
                  flush=True)
            check(d["loss_bitwise"] or abs(d["loss"] - n["loss"])
                  <= TRAIN_LOSS_RTOL * abs(n["loss"]),
                  f"(b) {arch}: losses differ")
            check(d["grads_bitwise"] or d["max_grad_gap"] <= GRAD_TOL,
                  f"(b) {arch}: gradients differ by {d['max_grad_gap']}")
            check(d["recomputed_products"] == 0 < n["recomputed_products"],
                  f"(b) {arch}: \"dots\" re-ran "
                  f"{d['recomputed_products']} forward products")
            check(d["forward_products"] == n["forward_products"],
                  f"(b) {arch}: the forwards differ")
            check(n["launches"] == d["launches"],
                  f"(b) {arch}: launches differ by policy")
            for pol, v in r.items():
                add_path(f"step {arch} (remat {pol})", v["launches"])
            out["dots"][arch] = r
            held_bytes(torch, dev)

    # (c) the examples, in process ----------------------------------------
    ck = OUT / "lm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    half = LM_EXAMPLE_STEPS // 2
    a, text_a, la = run_example("torch_train_lm", LM_EXAMPLE_ARGS + [
        "--steps", str(LM_EXAMPLE_STEPS), "--ckpt-every", str(half),
        "--ckpt-dir", str(ck / "a")], counters)
    shutil.copytree(ck / "a" / f"step_{half:09d}",
                    ck / "b" / f"step_{half:09d}")
    b, text_b, lb = run_example("torch_train_lm", LM_EXAMPLE_ARGS + [
        "--steps", str(LM_EXAMPLE_STEPS), "--resume", "--ckpt-every", "0",
        "--ckpt-dir", str(ck / "b")], counters)
    shutil.rmtree(ck, ignore_errors=True)
    resumed_gap = max(abs(x - y) / abs(y) for x, y in
                      zip(b["losses"][:half], a["losses"][half:]))
    out["examples"]["train_lm"] = {
        "losses": a["losses"], "resumed_losses": b["losses"],
        "resumed_gap": resumed_gap, "tokens_per_s": a["tokens_per_s"],
        "params": a["params"], "max_memory_allocated":
        a.get("max_memory_allocated"), "launches": [la, lb]}
    print(f"(c) torch_train_lm {' '.join(LM_EXAMPLE_ARGS)} ({a['params']} "
          f"parameters): "
          f"{LM_EXAMPLE_STEPS} steps, checkpoints at {half} and "
          f"{LM_EXAMPLE_STEPS}, {a['tokens_per_s']:.0f} tok/s; resumed "
          f"from {half}: steps {half}-{LM_EXAMPLE_STEPS - 1} within "
          f"{resumed_gap:.3e} of the uninterrupted run's (rtol "
          f"{TRAIN_LOSS_RTOL}); launches {la}, {lb}", flush=True)
    check("(DOWN)" in text_a and "(DOWN)" in text_b, "(c) torch_train_lm: "
          "the loss did not go down")
    check(f"resumed from step {half}" in text_b and "tok/s" in text_a,
          "(c) torch_train_lm: markers missing")
    check(resumed_gap <= TRAIN_LOSS_RTOL, "(c) torch_train_lm: the resumed "
          "run left the uninterrupted one")
    check(la["flash_attention"] == 2 * 10 * LM_EXAMPLE_STEPS,
          f"(c) torch_train_lm: {la['flash_attention']} flash launches")
    for path, n in (("torch_train_lm 100m", la), ("torch_train_lm resumed",
                                                   lb)):
        add_path(path, n)
    record_holds(by_name, hold_lm_example(
        torch, dev, load_example("torch_train_lm").MODELS["100m"]),
        "torch_train_lm 100m")

    s, text_s, ls = run_example("torch_serve_lm", [
        "--chat", "--turns", "3"], counters)
    out["examples"]["serve_lm"] = {
        "turns": s["turns"], "prefix_cache": s["prefix_cache"],
        "paged": s["paged"], "launches": ls}
    print(f"(c) torch_serve_lm --chat --turns 3 (qwen2-0.5b smoke, paged): "
          f"recomputed {[t['recomputed'] for t in s['turns']]} of "
          f"{[t['prompt'] for t in s['turns']]}, hit rate "
          f"{s['prefix_cache']['hit_rate']:.2f}; launches {ls}", flush=True)
    check(s["paged"] and "prefix cache: hit rate" in text_s
          and s["prefix_cache"]["hit_rate"] > 0,
          "(c) torch_serve_lm: no prefix hit")
    check(all(0 < t["recomputed"] < t["prompt"] for t in s["turns"][1:]),
          "(c) torch_serve_lm: a later turn recomputed its whole prompt")
    check(ls["paged_decode_attention"] > 0
          and ls["paged_prefill_attention"] > 0,
          f"(c) torch_serve_lm: the paged kernels did not run ({ls})")
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        by_name[name]["launches"] += ls[name]
    add_path("torch_serve_lm --chat", ls)
    # the example's default slots, the engine's default chunk and page
    import inspect
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import ServingEngine
    eng = inspect.signature(ServingEngine).parameters
    record_holds(by_name, hold_serve_example(
        torch, dev, get_smoke_config("qwen2-0.5b"), s["turns"], slots=4,
        chunk=eng["prefill_chunk"].default,
        page=eng["kv_block_size"].default), "torch_serve_lm --chat")

    g, text_g, lg = run_example("torch_train_3dgan", ["--steps", "5"],
                                counters)
    out["examples"]["train_3dgan"] = {
        "d_losses": g["d_losses"], "g_losses": g["g_losses"],
        "images_per_s": g["images_per_s"], "image": g["image"],
        "wall_time_s": g["wall_time_s"]}
    print(f"(c) torch_train_3dgan --steps 5 in its capsule "
          f"({g['image']}): {g['images_per_s']:.1f} img/s, energy "
          f"correlation {g['energy_corr']:.3f}", flush=True)
    check("img/s" in text_g and "capsule run complete" in text_g
          and all(math.isfinite(x) for x in g["d_losses"]),
          "(c) torch_train_3dgan: markers missing")
    return out


# ---------------------------------------------------------------------------
# gemma2-2b at full width (phase 24)
# ---------------------------------------------------------------------------

GEMMA_ARCH = "gemma2-2b"
# (a): the launcher's step, B 2 x S 2,048, 8 AdamW steps
GEMMA_SEQ, GEMMA_BATCH, GEMMA_STEPS = 2048, 2, 8
# the B = 8 decode round's contexts and the prefill tiles' starts, past the
# local layers' window of 4,096
GEMMA_LENS = [4200, 4457, 4714, 4971, 5228, 5485, 5742, 6000]
# (b): flash at D 288 with gemma2's softcap 50, where the window binds (S
# 8,192: a local layer, window 4,096, and a global one) and at (a)'s step
# (its local layers' window spans the sequence: the causal call)
GEMMA_FLASH_SETS = {
    "step (2, 2048)": dict(B=2, S=2048, H=8, KV=4, D=288, window=None,
                           softcap=50.0),
    "local (1, 8192)": dict(B=1, S=8192, H=8, KV=4, D=288, window=4096,
                            softcap=50.0),
    "global (1, 8192)": dict(B=1, S=8192, H=8, KV=4, D=288, window=None,
                             softcap=50.0)}
# (c): the engine's prompts, a 256-token shared prefix and a tail to
# 4,200-6,000 tokens, 32 greedy tokens each, in 8,192-position slots
GEMMA_PROMPTS, GEMMA_PROMPT_LENS, GEMMA_MAX_SEQ = 8, (4200, 6000), 8192
# (e): the CPU's 2-layer train step, one row of 64 tokens (the CPU's bf16
# step over the 256,000-word tied embedding is the slow part)
GEMMA_CPU_SEQ = 64


def flash_cuda_core(torch, fa, q, k, v, kw):
    """The CUDA-core flash kernel on ``q, k, v`` (what bf16 at D 288 ran
    before its tensor-core route): (out, lse)."""
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fa.flash_fwd_cuda_core(q, k, v, out, lse, 1.0 / math.sqrt(D),
                           kw["causal"], kw["window"], kw["softcap"])
    return out, lse


def prefill_cuda_core(torch, pp, case):
    """The CUDA-core prefill kernel on ``case`` (D 288's route before)."""
    q = case["q"]
    out = torch.empty_like(q)
    pp.prefill_cuda_core(*prefill_args(case), out, case["group"],
                         1.0 / math.sqrt(q.shape[-1]), case["window"],
                         case["softcap"])
    return out


def gemma2_kernel_times(torch, F, rng, dev, by_name, flush,
                        int8_set) -> dict:
    """Phase 4 at gemma2-2b's D 288 (``main``'s comment there): each
    kernel checked and timed by ``time_cases`` under ``gemma2_shapes``;
    the flash and prefill calls on their tensor-core counters, their
    CUDA-core routes timed at the same inputs (``cuda_core_ms``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.ref import attention_int8kv_ref
    from repro_torch.serving.profiling import decode_cost, prefill_cost
    wk = dict(window=4096, softcap=50.0)
    dc = decode_case(torch, rng, dev, B=8, KV=4, G=2, D=288, page=16,
                     lengths=GEMMA_LENS, garbage=False, **wk)
    pc = prefill_case(torch, rng, dev, B=4, KV=4, G=2, D=288, page=16, C=16,
                      starts=GEMMA_LENS[::2], q_lens=[16] * 4, **wk)
    fc = flash_case(torch, rng, dev, **GEMMA_FLASH_SETS["step (2, 2048)"])
    ic = int8_case(torch, rng, dev, **int8_set)
    da, pa_, fqkv, ia = (decode_args(dc), prefill_args(pc),
                         (fc["q"], fc["k"], fc["v"]), int8_args(ic))
    pkw = dict(group=2, **wk)
    kd, vd = dequantized_kv(ic)

    def decode_ok(got, want):
        return kref.rounding_bound_ratio(got, want, decode_bound(pa, dc)[1],
                                         pa.P_ROUNDING) <= 1.0

    def prefill_ok(got, want):
        _, mix, p_rel = prefill_bound(pp, pc)
        return (p_rel == 2.0 ** -8 and padding_rows_zero(got, pc)
                and kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0)

    def flash_ok(got, want):
        _, mix, p_rel = flash_bound(fa, *fqkv, fc["kw"])
        return (p_rel == 2.0 ** -8
                and kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0)

    lens = ", ".join(map(str, GEMMA_LENS))
    cases = [
        ("paged_decode_attention", f"q (8, 4, 2, 288) bf16, 16-token pages, "
         f"contexts {lens}, window 4096, softcap 50",
         lambda: pa.paged_attention(*da, **wk),
         lambda: pa.paged_attention_plain(*da, **wk),
         lambda: library_decode(torch, F, dc), decode_cost, dc, decode_ok),
        ("paged_prefill_attention", "q (4, 4, 16*2, 288) bf16, C = 16, "
         f"starts {GEMMA_LENS[::2]}, window 4096, softcap 50",
         lambda: pp.paged_prefill(*pa_, **pkw),
         lambda: pp.paged_prefill_plain(*pa_, **pkw),
         lambda: library_prefill(torch, F, pc), prefill_cost, pc,
         prefill_ok),
        ("flash_attention", "q (2, 2048, 8, 288), k/v (2, 2048, 4, 288) "
         "bf16, causal, softcap 50",
         lambda: fa.flash_attention(*fqkv, **fc["kw"])[0],
         lambda: fa.flash_attention_plain(*fqkv, **fc["kw"])[0],
         lambda: library_flash(torch, F, fc), flash_cost, fc, flash_ok),
        ("flash_attention_int8kv", "q (4, 1, 8, 288) bf16, int8 K/V (4, "
         "5000, 4, 288), window 4096, softcap 50",
         lambda: fa.flash_attention_int8kv(*ia, **ic["kw"]),
         lambda: attention_int8kv_ref(*ia, **ic["kw"]),
         lambda: library_int8(torch, F, ic, kd, vd), int8_cost, ic,
         lambda got, want: int8_rel_err(got, want) <= INT8_BF16_RTOL)]
    n_tc = (pp.prefill_tensor_core.launches, fa.flash_fwd_tensor_core.launches)
    n_cc = (pp.prefill_cuda_core.launches, fa.flash_fwd_cuda_core.launches)
    pp.paged_prefill(*pa_, **pkw)
    fa.flash_attention(*fqkv, **fc["kw"])
    torch.cuda.synchronize()
    check((pp.prefill_tensor_core.launches, fa.flash_fwd_tensor_core.launches)
          == (n_tc[0] + 1, n_tc[1] + 1)
          and (pp.prefill_cuda_core.launches, fa.flash_fwd_cuda_core.launches)
          == n_cc, "gemma2-2b's D 288 prefill or flash call missed its "
          "tensor-core route")
    time_cases(torch, cases, "gemma2-2b", "gemma2_shapes", by_name, flush)
    # the CUDA-core routes at the same inputs, held to their own bound
    # (P in f32: 2^-14)
    cc = {}
    for kname, run, bound in (
            ("paged_prefill_attention", lambda: prefill_cuda_core(
                torch, pp, pc), lambda: prefill_bound(pp, pc)[:2]),
            ("flash_attention", lambda: flash_cuda_core(
                torch, fa, *fqkv, fc["kw"])[0],
             lambda: flash_bound(fa, *fqkv, fc["kw"])[:2])):
        plain, mix = bound()
        ratio = kref.rounding_bound_ratio(run(), plain, mix, 2.0 ** -14)
        del plain, mix
        check(ratio <= 1.0, f"the CUDA-core {kname} disagrees at gemma2-2b's "
              "shapes")
        rec = by_name[kname]["gemma2_shapes"][-1]
        rec["cuda_core_ms"] = cc[kname] = time_ms(torch, run, flush,
                                                  reps=5, warmup=1)
        print(f"{kname} at gemma2-2b's {rec['shapes']}: the CUDA-core route "
              f"{cc[kname]:.4f} ms (bound ratio {ratio:.3e} at 2^-14) "
              f"against the tensor cores' {rec['ms']:.4f} ms", flush=True)
        check(rec["ms"] < cc[kname], f"the tensor-core {kname} is slower "
              "than the CUDA-core route at gemma2-2b's shapes")
    del dc, pc, fc, ic, kd, vd
    torch.cuda.empty_cache()
    return cc


def hold_gemma2_paged(torch, pa, pp, kref, dev, rng) -> dict:
    """Phase 24 (f) after (c): paged decode and prefill at the engine's
    D 288 shapes (B = 8 decode at ``GEMMA_LENS``, the 4-row C = 16 prefill
    tile there, window 4,096, softcap 50) against their plain versions at
    phase 3's bounds, with phase 3's broken variants; the prefill call on
    the tensor-core counter."""
    wk = dict(window=4096, softcap=50.0)
    dc = decode_case(torch, rng, dev, B=8, KV=4, G=2, D=288, page=16,
                     lengths=GEMMA_LENS, **wk)
    pc = prefill_case(torch, rng, dev, B=4, KV=4, G=2, D=288, page=16, C=16,
                      starts=GEMMA_LENS[1::2], q_lens=[16, 7, 16, 0], **wk)
    res = {}
    got = pa.paged_attention(*decode_args(dc), **wk)
    plain, mix = decode_bound(pa, dc)
    res["paged_decode_attention"] = {
        "ratio": kref.rounding_bound_ratio(got, plain, mix, pa.P_ROUNDING),
        "misses": {w: kref.rounding_bound_ratio(f(), plain, mix,
                                                pa.P_ROUNDING)
                   for w, f in decode_wrongs(torch, pa, kref, dc)}}
    n_tc = pp.prefill_tensor_core.launches
    got = pp.paged_prefill(*prefill_args(pc), group=2, **wk)
    torch.cuda.synchronize()
    check(pp.prefill_tensor_core.launches == n_tc + 1,
          "(f) the D 288 prefill missed the tensor-core route")
    plain, mix, p_rel = prefill_bound(pp, pc)
    res["paged_prefill_attention"] = {
        "ratio": kref.rounding_bound_ratio(got, plain, mix, p_rel),
        "padding_zero": padding_rows_zero(got, pc),
        "misses": {w: kref.rounding_bound_ratio(f(), plain, mix, p_rel)
                   for w, f in prefill_wrongs(torch, pa, pp, kref, pc)}}
    del dc, pc, got, plain, mix
    check(res["paged_prefill_attention"]["padding_zero"],
          "(f) a D 288 prefill padding row is not zero")
    return res


def check_holds(holds: dict, label: str, tol: float = 1.0) -> None:
    """Each held kernel within its bound (``ratio``, ``ulp`` or ``rel``
    at or below ``tol``), each broken variant above it."""
    print(f"{label}: kernels against their plain versions: "
          + json.dumps(holds), flush=True)
    for name, r in holds.items():
        t = INT8_BF16_RTOL if name == "flash_attention_int8kv" else tol
        got = r.get("ratio", r.get("ulp", r.get("rel")))
        check(got <= t, f"{label}: {name} disagrees ({got:.3e})")
        for what, miss in r["misses"].items():
            check(miss > t, f"{label}: the {name} check misses a kernel "
                  f"that {what} ({miss:.3e})")


def gemma2_train_profile(torch, T, cfg, dev) -> dict:
    """The launcher's step (``dp_tp`` on the (1, 1) host mesh, AdamW in
    place, B 2 x S 2,048) from weights drawn on the card: one step's peak
    measured as phase 22 measures it against the dry-run (the card's
    ``max_memory_allocated`` over the step, less what was resident
    before it, plus the bytes handed to it), then one step under
    ``torch.profiler``: device time by kernel family."""
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, GEMMA_SEQ,
                                                GEMMA_BATCH))
    with hvd.init(dev):
        groups = make_host_mesh()
        opt = optim.adamw(3e-4, clip_norm=1.0)
        params, state = stepfn.shard_state(
            T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, weight_dtype=torch.float32),
            cfg, opt, "dp_tp", groups)
        step = stepfn.make_train_step(cfg, opt, groups, strategy="dp_tp",
                                      device=dev)
        arg_bytes = tree_bytes(params) + tree_bytes(state)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, _ = step(params, state, src.batch(0))
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated(dev) - held + arg_bytes
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            params, state, _ = step(params, state, src.batch(1))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        del params, state, step
    return dict(profile_breakdown(prof, wall_ms), step_peak=step_peak,
                argument_bytes=arg_bytes)


def gemma2_phase(torch, F, T, dev, counters, by_name, rms_paths) -> dict:
    """Phase 24: gemma2-2b at full width and depth (26 layers, d 2,304, 8 /
    4 heads of 288, vocab 256,000, window 4,096 on the 13 local layers,
    softcaps 50 / 30, tied embedding), random weights at seed 0: (a)
    training through the launcher, then one step profiled; (b) flash at
    D 288 (``flash_route_sets``); (c) paged serving through the launcher
    and the engine (long prompts: the window binds), a B = 8 decode round
    replayed and eager; (d) dense serving, int8 then bf16; (e) card
    against CPU at 2 layers; (f) after (a), (c) and (d) the kernels they
    launched held at their shapes.  Adds the paths' launches to
    ``by_name`` and ``rms_paths``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    cfg = get_config(GEMMA_ARCH)
    L, V = cfg.num_layers, cfg.vocab_size
    # a forward's RMSNorms: ln1, post_ln1, ln2 and post_ln2 a layer, and
    # the final norm (transformer._apply_layer, _stack)
    norms = 4 * L + 1
    rng = np.random.default_rng(24)
    out = {"seconds": {}}
    t_part = [time.perf_counter()]

    def lap(part):
        """The seconds ``part`` took (with its holds), into ``out``."""
        now = time.perf_counter()
        out["seconds"][part] = now - t_part[0]
        t_part[0] = now

    # (e)'s train step first, so that its CPU half runs beside (a)-(d)
    train_card_vs_cpu(torch, cfg.with_(num_layers=2, remat=False),
                      seq=GEMMA_CPU_SEQ, batch=1, dev=dev)
    torch.cuda.empty_cache()
    lap("e, the train step's card half")

    # (a) training through the launcher -----------------------------------
    shape = InputShape("train", GEMMA_SEQ, GEMMA_BATCH, "train")
    dry = dryrun.count_step(cfg, shape, "dp_tp", {"data": 1, "model": 1})
    before = held_bytes(torch, dev)
    check(before < 4 * 2**30, f"(a) {before} bytes held before training")
    zero_counts(counters)
    t0 = time.perf_counter()
    run = train_launcher.main(["--arch", GEMMA_ARCH, "--seq-len",
                               str(GEMMA_SEQ), "--global-batch",
                               str(GEMMA_BATCH), "--steps",
                               str(GEMMA_STEPS)])
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    del run["params"]
    held_bytes(torch, dev)
    steady = run["step_s"][1:]
    res = {k: run[k] for k in ("strategy", "mesh", "losses", "step_s",
                               "tokens_per_s", "launches_per_step",
                               "max_memory_allocated")}
    res.update(step_ms=sum(steady) / len(steady) * 1e3, wall_s=wall,
               held_before=before, dryrun_peak=dry["peak_memory_per_device"],
               dryrun_argument_bytes=dry["argument_size"],
               dryrun_peak_at=dry["peak_at"], params=cfg.param_count())
    print(f"(a) {GEMMA_ARCH} through the launcher, B {GEMMA_BATCH} x S "
          f"{GEMMA_SEQ}: " + json.dumps(res), flush=True)
    losses = res["losses"]
    check(res["strategy"] == "dp_tp", "(a) the launcher's default is not "
          "dp_tp")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "(a) the loss is not finite or did not fall")
    # remat: every layer's attention and norms twice a step, the final
    # norm once; every flash on the tensor cores, every norm one pass
    per = res["launches_per_step"]
    check(all(n == 2 * L for n in per["flash_attention"])
          and all(n == 2 * (norms - 1) + 1 for n in per["rmsnorm"]),
          f"(a) launches a step {per}, want {2 * L} flash and "
          f"{2 * (norms - 1) + 1} RMSNorm")
    want = {"flash_attention": 2 * L * GEMMA_STEPS,
            "flash_attention_tensor_core": 2 * L * GEMMA_STEPS,
            "flash_attention_cuda_core": 0, "flash_attention_d_tail": 0,
            "rmsnorm": (2 * (norms - 1) + 1) * GEMMA_STEPS,
            "rmsnorm_one_pass": (2 * (norms - 1) + 1) * GEMMA_STEPS}
    got = {k: launches[k] for k in want}
    check(got == want, f"(a) launches {got}, want {want}")
    k = by_name["flash_attention"]
    k["launches_per_path"][f"training {GEMMA_ARCH} (launcher, dp_tp)"] = \
        launches["flash_attention"]
    k["launches"] = sum(k["launches_per_path"].values())
    rms_paths[f"training {GEMMA_ARCH}"] = launches["rmsnorm"]
    res["profile"] = prof = gemma2_train_profile(torch, T, cfg, dev)
    res["step_peak_vs_dryrun"] = (prof["step_peak"]
                                  / dry["peak_memory_per_device"] - 1)
    print(f"(a) the step's peak {prof['step_peak']} bytes (arguments "
          f"{prof['argument_bytes']}) against the dry-run's "
          f"{dry['peak_memory_per_device']} (arguments "
          f"{dry['argument_size']}): {res['step_peak_vs_dryrun']:+.4f}; the "
          f"launcher's max_memory_allocated {res['max_memory_allocated']}; "
          "one step profiled: " + json.dumps(prof), flush=True)
    check(res["profile"]["by_family_ms"]["flash_attention"] > 0,
          "(a) the profiler saw no flash kernel")
    out["train"] = res
    held_bytes(torch, dev)
    # (f) the step's RMSNorm at its rows (its flash call is (b)'s first
    # shape, held there with its gradients and broken variants)
    out["train_holds"] = {"rmsnorm": hold_rmsnorm_rows(
        torch, rn, kref, dev, rng, GEMMA_BATCH * GEMMA_SEQ, cfg.d_model)}
    check_holds(out["train_holds"], "(f) after (a)")
    lap("a")

    # (b) flash at D 288 where the window binds ---------------------------
    out["d288"] = flash_route_sets(torch, F, fa, kops, kref, dev, rng,
                                   GEMMA_FLASH_SETS,
                                   by_name["flash_attention"], "d288", "(b)")
    lap("b")

    # (c) paged serving: the launcher, then the engine --------------------
    before = held_bytes(torch, dev)
    check(before < 4 * 2**30, f"(c) {before} bytes held before serving")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    gw = serve_launcher.main([
        "--arch", GEMMA_ARCH, "--paged", "--max-slots", "8",
        "--max-seq-len", "2048", "--prefill-batch", "4",
        "--prefill-token-budget", "512", "--prefix-cache-blocks", "256",
        "--shared-prefix", "256", "--requests", "12", "--max-new", "32",
        "--greedy", "--metrics-json", str(OUT / "gemma2_metrics.json")])
    torch.cuda.synchronize()
    launches_a = read_counts(counters)
    sched = gw.replicas[0].scheduler
    eng = sched.engine
    rep_a = report_serving(torch, sched, "(c) gemma2 launcher", dev)
    check(rep_a["requests"] == 12, "(c) launcher: not every request "
          "completed")
    check(rep_a["prefix_hit_rate"] > 0, "(c) launcher: no prefix-cache hit")
    check_no_leaks(sched, "(c) gemma2 launcher")
    check_programs(eng, "(c) gemma2 launcher", "prefill_paged",
                   eng.prefill_batch * eng.prefill_chunk)
    per_replay = {"launcher": check_round_launches(
        eng, launches_a, "(c) gemma2 launcher", cfg)}
    params = eng.params
    del gw, sched, eng
    torch.cuda.empty_cache()
    # (e)'s CPU halves, queued now to run beside (c) and (d): the paged
    # engine (4 tokens through generate) and the dense int8 one (4 in the
    # prompt's slot) at 2 layers, on these weights
    cfg2 = cfg.with_(num_layers=2)
    p_cpu = shared_cpu(torch, dict(params, layers=_map(params["layers"],
                                                       lambda t: t[:2])))
    e_prompt = np.random.default_rng(2).integers(0, V, 48, dtype=np.int32)
    e_runs = [(f"(e) gemma2 2-layer full-width {mode}", c,
               dict(paged=mode == "paged", prefill_batch=1))
              for mode, c in (("paged", cfg2), ("dense int8", cfg2.with_(
                  kv_cache_dtype="int8")))]
    for label, c, kw in e_runs:
        CPU_SIDE.prefetch(label, "engine_greedy", cfg=c, params=p_cpu,
                          prompt=e_prompt, new=4, generate=kw["paged"],
                          engine_kw=kw)

    rs = np.random.default_rng(24)
    shared = rs.integers(0, V, 256, dtype=np.int32)
    lo, hi = GEMMA_PROMPT_LENS
    prompts = [np.concatenate([shared, rs.integers(
        0, V, int(rs.integers(lo - 256, hi - 255)), dtype=np.int32)])
        for _ in range(GEMMA_PROMPTS)]
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, params, max_seq_len=GEMMA_MAX_SEQ,
                        max_slots=GEMMA_PROMPTS, prefix_cache_blocks=256,
                        paged=True, prefill_batch=4, device=dev)
    sched = Scheduler(eng, prefill_token_budget=512, profile=True)
    zero_counts(counters)
    t0 = time.perf_counter()
    rids = [sched.submit(Request(p, SamplingParams(max_new_tokens=32,
                                                   greedy=True)))
            for p in prompts]
    run_marking_warm(sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_b = read_counts(counters)
    rep_b = report_serving(torch, sched, "(c) gemma2 engine", dev)
    outs = [sched.output(r) for r in rids]
    check(all(len(o) == 32 for o in outs),
          "(c) engine: not every request completed")
    check(all(((o >= 0) & (o < V)).all() for o in outs),
          "(c) engine: token ids out of range")
    check(rep_b["prefix_hit_rate"] > 0, "(c) engine: no prefix-cache hit")
    check_no_leaks(sched, "(c) gemma2 engine")
    check(eng.recompiles.warm, "(c) engine: never held both programs")
    check_programs(eng, "(c) gemma2 engine", "prefill_paged",
                   eng.prefill_batch * eng.prefill_chunk)
    per_replay["engine"] = check_round_launches(eng, launches_b,
                                                "(c) gemma2 engine", cfg)
    kv_bytes = eng.kv.kv_bytes()
    out["paged"] = dict(launcher=rep_a, engine=rep_b, wall_s=wall,
                        prompts=[len(p) for p in prompts], kv_bytes=kv_bytes,
                        kv_bytes_per_token=kv_bytes / (
                            GEMMA_PROMPTS * GEMMA_MAX_SEQ),
                        launches_per_replay=per_replay,
                        decode_replays=eng.programs["decode_step"].replays,
                        prefill_replays=eng.programs["prefill_paged"]
                        .replays)
    print(f"(c) gemma2 engine: prompts {out['paged']['prompts']}, KV cache "
          f"{kv_bytes} bytes ({out['paged']['kv_bytes_per_token']:.0f} a "
          f"position), wall {wall:.2f} s, launches per replay "
          f"{per_replay}", flush=True)
    del sched, eng
    torch.cuda.empty_cache()
    rd = decode_round(torch, T, cfg, params, dev, lens=GEMMA_LENS)
    rd["tokens_per_s"] = 8 / rd["replay_ms"] * 1e3
    out["decode_round"] = rd
    print("(c) gemma2 B = 8 decode round (replay and eager by CUDA events; "
          "bound: every weight read once): " + json.dumps(rd), flush=True)
    check(rd["replay_vs_eager_max_diff"] == 0.0 and rd["captures"] == 1,
          "(c) the replayed decode round differs from the eager one")
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        n = launches_a[name] + launches_b[name]
        by_name[name]["launches"] += n
        by_name[name]["launches_per_part"].append(n)
        by_name[name]["gemma2_launches_per_replay"] = {
            part: r[name] for part, r in per_replay.items()}
    rms_paths[f"serving {GEMMA_ARCH}"] = (launches_a["rmsnorm"]
                                          + launches_b["rmsnorm"])
    out["paged_holds"] = hold_gemma2_paged(torch, pa, pp, kref, dev, rng)
    check_holds(out["paged_holds"], "(f) after (c)")
    lap("c")

    # (d) dense serving, int8 then bf16 -----------------------------------
    rs = np.random.default_rng(3)
    dshared = rs.integers(0, V, 32, dtype=np.int32)
    dense_prompts = [np.concatenate([dshared, rs.integers(
        0, V, int(rs.integers(16, 97)), dtype=np.int32)]) for _ in range(12)]
    dense = {}
    for label, c, prompts_ in (
            ("int8", cfg.with_(kv_cache_dtype="int8"), dense_prompts),
            ("bf16", cfg, dense_prompts[:4])):
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ServingEngine(c, params, paged=False, max_slots=8,
                            max_seq_len=1024, prefill_chunk=16,
                            prefix_cache_blocks=64, device=dev)
        sched = Scheduler(eng, profile=True)
        zero_counts(counters)
        rids = [sched.submit(Request(p, SamplingParams(
            max_new_tokens=32, greedy=True))) for p in prompts_]
        run_marking_warm(sched)
        torch.cuda.synchronize()
        ld = read_counts(counters)
        rep = report_serving(torch, sched, f"(d) gemma2 dense {label}", dev)
        outs = [sched.output(r) for r in rids]
        steps = eng.decode_steps + eng.prefill_tokens_executed
        check(all(len(o) == 32 for o in outs),
              f"(d) dense {label}: not every request completed")
        check(rep["prefix_hit_rate"] > 0, f"(d) dense {label}: no prefix "
              "hit")
        want = {"flash_attention_int8kv": L * steps if label == "int8" else 0,
                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                "flash_attention": 0, "rmsnorm": norms * steps,
                "rmsnorm_one_pass": norms * steps}
        got = {k: ld[k] for k in want}
        check(got == want, f"(d) dense {label}: launches {got}, want {want} "
              f"from {steps} steps (decode steps + prefill tokens)")
        check_no_leaks(sched, f"(d) gemma2 dense {label}")
        check(eng.recompiles.warm, f"(d) dense {label}: never held both "
              "programs")
        check_programs(eng, f"(d) gemma2 dense {label}", "prefill_chunk",
                       eng.prefill_chunk)
        dense[label] = dict(rep, kv_bytes=eng.kv.kv_bytes(),
                            launches=ld["flash_attention_int8kv"],
                            steps=steps, rmsnorm=ld["rmsnorm"])
        del sched, eng
        torch.cuda.empty_cache()
    D = cfg.resolved_head_dim
    dense["kv_bytes_ratio"] = ratio = (dense["int8"]["kv_bytes"]
                                       / dense["bf16"]["kv_bytes"])
    print(f"(d) gemma2 dense int8 / bf16 KV bytes {ratio:.4f} (the layout's "
          f"(2D + 4) / (4D) = {(2 * D + 4) / (4 * D):.4f})", flush=True)
    check(abs(ratio - (2 * D + 4) / (4 * D)) < 1e-9,
          "(d) int8 / bf16 KV bytes off the layout's ratio")
    out["dense"] = dense
    k = by_name["flash_attention_int8kv"]
    k["launches_per_path"][f"dense serving {GEMMA_ARCH}"] = \
        dense["int8"]["launches"]
    k["launches"] = sum(k["launches_per_path"].values())
    rms_paths[f"dense serving {GEMMA_ARCH}"] = (dense["int8"]["rmsnorm"]
                                                + dense["bf16"]["rmsnorm"])
    # (f) the int8 kernel at the dense decode's D 288: B 4 over stripes of
    # 1,024 positions, as the engine's
    ic = int8_case(torch, rng, dev, Sq=1, H=8, KV=4, D=D, Skv=1024,
                   q_start=[0, 127, 500, 1023], kv_len=[1, 128, 501, 1024])
    out["int8_hold"] = r = hold_int8_cache(
        torch, fa, kref, dev, rng, {"k": ic["k8"], "k_scale": ic["k_scale"],
                                    "v": ic["v8"], "v_scale": ic["v_scale"],
                                    "heads": 8},
        ic["q_start"])
    check_holds({"flash_attention_int8kv": r}, "(f) after (d)")
    del ic
    lap("d")

    # (e) card against CPU at 2 layers, on weights copied from the card ----
    # (their CPU halves queued in (c); the train step's at the start)
    del params
    before = held_bytes(torch, dev)
    check(before < 4 * 2**30, f"(e) {before} bytes held after freeing the "
          "full-depth weights")
    p_card = _map(p_cpu, lambda t: t.to(dev))
    for label, c, kw in e_runs:
        lg, tg, _ = engine_greedy(torch, dev, c, p_card, e_prompt, new=4,
                                  generate=kw["paged"], engine_kw=kw)
        res = CPU_SIDE.fetch(label)
        CPU_SIDE.report[label].update(engine_pair(label, lg, tg, (V,))(res))
    del p_card, p_cpu
    held_bytes(torch, dev)
    lap("e")
    print(f"phase 24's parts, seconds: {json.dumps(out['seconds'])}",
          flush=True)
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def report_serving(torch, sched, label: str, dev) -> dict:
    s = sched.metrics.summary()
    out = {"requests": s["requests_completed"],
           "new_tokens": s["total_new_tokens"],
           "tokens_per_s": s["tokens_per_s"],
           "ttft_ms_p50": s["ttft_ms"]["p50"],
           "ttft_ms_p95": s["ttft_ms"]["p95"],
           "decode_gap_ms_p50": s["decode_gap_ms"]["p50"],
           "decode_gap_ms_p95": s["decode_gap_ms"]["p95"],
           "prefix_hit_rate": s["prefix_cache"]["hit_rate"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    if sched.profiler is not None:
        out["decode_step_ms_p50"] = \
            sched.profiler.summary()["decode_ms"]["p50"]
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    global CPU_SIDE
    CPU_SIDE = CpuSide()
    for arch, layers, f32 in CPU_WEIGHTS:
        CPU_SIDE.prefetch(weights_label(arch, layers, f32), "draw_weights",
                          arch=arch, layers=layers, f32=f32)

    # 1. device ------------------------------------------------------------
    phase("device")
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = (smi.stdout.strip().splitlines() or ["unavailable"])[0]
    print(f"device: {device_name}; device_count {count}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(smi_line, flush=True)

    # 2. build -------------------------------------------------------------
    phase("build")
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import unembed as ue
    from repro_torch.kernels.ref import attention_int8kv_ref
    counters = {"paged_decode_attention": pa.paged_attention,
                "decode_bf16": pa.DTYPE_LAUNCHES[torch.bfloat16],
                "decode_f32": pa.DTYPE_LAUNCHES[torch.float32],
                "paged_prefill_attention": pp.paged_prefill,
                "paged_prefill_tensor_core": pp.prefill_tensor_core,
                "paged_prefill_cuda_core": pp.prefill_cuda_core,
                "flash_attention": fa.flash_attention,
                "flash_attention_tensor_core": fa.flash_fwd_tensor_core,
                "flash_attention_cuda_core": fa.flash_fwd_cuda_core,
                "flash_attention_d_tail": fa.flash_d_tail,
                "flash_non_causal": fa.FLASH_NON_CAUSAL,
                "flash_attention_int8kv": fa.flash_attention_int8kv,
                "ssd_scan": ssd.ssd_scan,
                "ssd_tensor_core": ssd.ssd_tensor_core,
                "ssd_cuda_core": ssd.ssd_cuda_core, "rmsnorm": rn.rmsnorm,
                "rmsnorm_one_pass": rn.rmsnorm_one_pass,
                "rmsnorm_two_pass": rn.rmsnorm_two_pass,
                "unembed_tensor_core": ue.unembed_tensor_core,
                "unembed_split": ue.unembed_split}
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc wall {_build.build_seconds})")
    for src, log in sorted(_build.ptxas_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")
    sys.stdout.flush()

    # 3. kernel vs plain ----------------------------------------------------
    phase("kernels vs plain")
    rng = np.random.default_rng(0)
    shape_sets = {
        "qwen2-0.5b": dict(KV=2, G=7, D=64, page=16, window=None,
                           softcap=None, lengths=[1, 17, 300, 0, 512, 33],
                           starts=[0, 40, 129, 300], C=16,
                           q_lens=[16, 9, 0, 1]),
        "gemma2-2b": dict(KV=4, G=2, D=288, page=16, window=4096,
                          softcap=50.0, lengths=[4097, 5000, 100, 0],
                          starts=[4090, 4500, 0, 4200], C=16,
                          q_lens=[16, 5, 16, 0]),
    }
    # qwen3-moe-30b-a3b's attention (KV 4, G 8, D 128) at the shapes its
    # serving rounds give the paged kernels: a B = 8 decode round at
    # contexts 512-2048, and the launcher's prefill tile (4 rows, C = 16)
    # and phase 5's (C = 64), starts 0-1,024, with q_len = 0 rows (their
    # decode part runs once, under the first label)
    moe_lens = [512, 731, 950, 1170, 1389, 1609, 1828, 2048]
    moe_sets = {
        "qwen3-moe-30b-a3b C 16": dict(
            KV=4, G=8, D=128, page=16, window=None, softcap=None,
            lengths=moe_lens, starts=[0, 341, 683, 1024], C=16,
            q_lens=[16, 9, 0, 16]),
        "qwen3-moe-30b-a3b C 64": dict(
            KV=4, G=8, D=128, page=16, window=None, softcap=None,
            lengths=None, starts=[0, 256, 640, 1024], C=64,
            q_lens=[64, 0, 37, 64]),
    }
    worst = {}
    for label, s in {**shape_sets, **moe_sets}.items():
        if s["lengths"]:
            dc = decode_case(torch, rng, dev, B=len(s["lengths"]),
                             KV=s["KV"], G=s["G"], D=s["D"], page=s["page"],
                             lengths=s["lengths"], window=s["window"],
                             softcap=s["softcap"])
            got = pa.paged_attention(*decode_args(dc), window=dc["window"],
                                     softcap=dc["softcap"])
            torch.cuda.synchronize()
            ref_, mix = decode_bound(pa, dc)
            err = (got.float() - ref_.float()).abs().max().item()
            ratio = kref.rounding_bound_ratio(got, ref_, mix, pa.P_ROUNDING)
            zero_ok = (bool((got[3] == 0).all()) if 0 in s["lengths"]
                       else True)
            print(f"decode  {label}: max_abs_err {err:.3e}; max |err| / "
                  f"bound {ratio:.3e} (bound 2^-14 (|P| @ |V|) / l + 2^-7 "
                  f"|plain|, fails above 1); length-0 row zeros: {zero_ok}")
            check(ratio <= 1.0 and zero_ok,
                  f"decode kernel disagrees at {label} shapes")
            worst["paged_decode_attention"] = max(
                worst.get("paged_decode_attention", 0.0), err)
            # the check's power: broken decode kernels, as plain versions
            # on changed inputs, must each fail it
            for what, wrong in decode_wrongs(torch, pa, kref, dc):
                miss = kref.rounding_bound_ratio(wrong(), ref_, mix,
                                                 pa.P_ROUNDING)
                print(f"decode  {label}: a kernel that {what} would read "
                      f"{miss:.3e}")
                check(miss > 1.0,
                      f"the decode check misses a kernel that {what}")
            del dc, got, ref_, mix

        pc_ = prefill_case(torch, rng, dev, B=len(s["starts"]), KV=s["KV"],
                           G=s["G"], D=s["D"], page=s["page"], C=s["C"],
                           starts=s["starts"], q_lens=s["q_lens"],
                           window=s["window"], softcap=s["softcap"])
        kw = dict(group=pc_["group"], window=pc_["window"],
                  softcap=pc_["softcap"])
        n_tc = pp.prefill_tensor_core.launches
        got = pp.paged_prefill(*prefill_args(pc_), **kw)
        torch.cuda.synchronize()
        tc = pp.prefill_tensor_core.launches > n_tc
        check(tc == pp.tensor_core_route(got.dtype, got.shape[-1])
              and (tc or label not in moe_sets),
              f"the prefill call at {label} shapes took the wrong kernel")
        ref_, mix, p_rel = prefill_bound(pp, pc_)
        err = (got.float() - ref_.float()).abs().max().item()
        ratio = kref.rounding_bound_ratio(got, ref_, mix, p_rel)
        pad_ok = padding_rows_zero(got, pc_)
        print(f"prefill {label} ({'tensor' if tc else 'CUDA'} cores): "
              f"max_abs_err {err:.3e}; max |err| / bound "
              f"{ratio:.3e} (bound 2^{int(math.log2(p_rel))} (|P| @ |V|) / l "
              f"+ 2^-7 |plain|, fails above 1); padding rows zeros: {pad_ok}")
        check(ratio <= 1.0 and pad_ok, f"prefill kernel disagrees at {label}")
        worst["paged_prefill_attention"] = max(
            worst.get("paged_prefill_attention", 0.0), err)
        # the check's power: broken prefill kernels, as plain versions on
        # changed inputs, must each fail it
        for what, wrong in prefill_wrongs(torch, pa, pp, kref, pc_):
            miss = kref.rounding_bound_ratio(wrong(), ref_, mix, p_rel)
            print(f"prefill {label}: a kernel that {what} would read "
                  f"{miss:.3e}")
            check(miss > 1.0, f"the prefill check misses a kernel that {what}")
        del pc_, got, ref_, mix

    # the f32 routes of both paged kernels (the launcher's kernel profiles
    # run them): the decode kernel's f32 instantiation and the CUDA-core
    # prefill kernel, each checked to be the one launched, element by
    # element within 2^-14 (|P| @ |V|) / l + one f32 ulp of the plain
    # output, and the broken variants above it
    for label, s in shape_sets.items():
        dc = decode_case(torch, rng, dev, B=len(s["lengths"]), KV=s["KV"],
                         G=s["G"], D=s["D"], page=s["page"],
                         lengths=s["lengths"], window=s["window"],
                         softcap=s["softcap"], dtype="float32")
        n32 = counters["decode_f32"].launches
        got = pa.paged_attention(*decode_args(dc), window=dc["window"],
                                 softcap=dc["softcap"])
        torch.cuda.synchronize()
        check(counters["decode_f32"].launches == n32 + 1
              and got.dtype == torch.float32,
              f"the f32 decode call at {label} missed the f32 kernel")
        ref_, mix = decode_bound(pa, dc)
        err = (got - ref_).abs().max().item()
        ratio = kref.rounding_bound_ratio(got, ref_, mix, pa.P_ROUNDING)
        print(f"decode  {label} f32: max_abs_err {err:.3e}; max |err| / "
              f"bound {ratio:.3e} (bound 2^-14 (|P| @ |V|) / l + 2^-23 "
              f"|plain|, fails above 1)")
        check(ratio <= 1.0, f"f32 decode kernel disagrees at {label}")
        worst["paged_decode_attention_f32"] = max(
            worst.get("paged_decode_attention_f32", 0.0), err)
        for what, wrong in decode_wrongs(torch, pa, kref, dc):
            miss = kref.rounding_bound_ratio(wrong(), ref_, mix,
                                             pa.P_ROUNDING)
            print(f"decode  {label} f32: a kernel that {what} would read "
                  f"{miss:.3e}")
            check(miss > 1.0, f"the f32 decode check misses a kernel that "
                  f"{what}")
        del dc, got, ref_, mix
        pc_ = prefill_case(torch, rng, dev, B=len(s["starts"]), KV=s["KV"],
                           G=s["G"], D=s["D"], page=s["page"], C=s["C"],
                           starts=s["starts"], q_lens=s["q_lens"],
                           window=s["window"], softcap=s["softcap"],
                           dtype="float32")
        kw = dict(group=pc_["group"], window=pc_["window"],
                  softcap=pc_["softcap"])
        n_cc = pp.prefill_cuda_core.launches
        got = pp.paged_prefill(*prefill_args(pc_), **kw)
        torch.cuda.synchronize()
        check(pp.prefill_cuda_core.launches == n_cc + 1
              and got.dtype == torch.float32,
              f"the f32 prefill call at {label} missed the CUDA-core kernel")
        ref_, mix, p_rel = prefill_bound(pp, pc_)
        err = (got - ref_).abs().max().item()
        ratio = kref.rounding_bound_ratio(got, ref_, mix, p_rel)
        pad_ok = padding_rows_zero(got, pc_)
        print(f"prefill {label} f32 (CUDA cores): max_abs_err {err:.3e}; "
              f"max |err| / bound {ratio:.3e} (bound 2^"
              f"{int(math.log2(p_rel))} (|P| @ |V|) / l + 2^-23 |plain|, "
              f"fails above 1); padding rows zeros: {pad_ok}")
        check(p_rel == 2.0 ** -14 and ratio <= 1.0 and pad_ok,
              f"f32 prefill kernel disagrees at {label}")
        worst["paged_prefill_attention_f32"] = max(
            worst.get("paged_prefill_attention_f32", 0.0), err)
        for what, wrong in prefill_wrongs(torch, pa, pp, kref, pc_):
            miss = kref.rounding_bound_ratio(wrong(), ref_, mix, p_rel)
            print(f"prefill {label} f32: a kernel that {what} would read "
                  f"{miss:.3e}")
            check(miss > 1.0, f"the f32 prefill check misses a kernel that "
                  f"{what}")
        del pc_, got, ref_, mix

    flash_sets = {
        "qwen2-0.5b": dict(B=8, S=1024, H=14, KV=2, D=64),
        "gemma2-2b": dict(B=1, S=4150, H=8, KV=4, D=288, window=4096,
                          softcap=50.0),
        # zamba2-1.2b's shared block in training: MHA, G = 1
        "zamba2-1.2b": dict(B=8, S=1024, H=32, KV=32, D=64),
        # head dims that are not multiples of 32 run padded (the D tail):
        # gemma2-27b's head layout (D 144, to 160) and D 80 (to 96), both on
        # the tensor cores
        "gemma2-27b D 144": dict(B=2, S=640, H=32, KV=16, D=144),
        "D 80": dict(B=2, S=600, H=8, KV=2, D=80),
        # qwen2-vl-72b's training call: GQA 64 / 8, D 128
        "qwen2-vl-72b": dict(B=2, S=1024, H=64, KV=8, D=128),
    }
    for label, s in flash_sets.items():
        fc = flash_case(torch, rng, dev, **s)
        qkv, kw = (fc["q"], fc["k"], fc["v"]), fc["kw"]
        n_tc = fa.flash_fwd_tensor_core.launches
        out, lse = fa.flash_attention(*qkv, **kw)
        torch.cuda.synchronize()
        tc = fa.flash_fwd_tensor_core.launches > n_tc
        route = "tensor cores" if tc else "CUDA cores"
        check(tc == fa.tensor_core_route(out.dtype, out.shape[-1]),
              f"the flash call at {label} shapes took the wrong kernel")
        _, ref_lse = fa.flash_attention_plain(*qkv, **kw)
        ref, mix, p_rel = flash_bound(fa, *qkv, kw)
        err = (out.float() - ref.float()).abs().max().item()
        ratio = kref.rounding_bound_ratio(out, ref, mix, p_rel)
        lse_err = (lse - ref_lse).abs().max().item()
        ins = [t.clone().requires_grad_(True) for t in qkv]
        got = torch.autograd.grad(kops.mha_flash_attention(*ins, **kw), ins,
                                  fc["dout"])
        torch.cuda.synchronize()
        ins = [t.clone().requires_grad_(True) for t in qkv]
        want = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw)[0],
                                   ins, fc["dout"])
        gerr = [((g.float() - r.float()).abs().max()
                 / r.float().abs().max()).item() for g, r in zip(got, want)]
        print(f"flash   {label} ({route}): out max_abs_err {err:.3e}; max "
              f"|err| / bound {ratio:.3e} (bound 2^{int(math.log2(p_rel))} "
              f"(|P| @ |V|) / l + 2^-7 |plain|, fails above 1); lse "
              f"{lse_err:.3e} (tol {LSE_TOL}); dq/dk/dv max err / max |grad| "
              f"{', '.join(f'{g:.3e}' for g in gerr)} (tol {GRAD_TOL})")
        check(ratio <= 1.0 and lse_err <= LSE_TOL,
              f"flash kernel disagrees at {label} shapes")
        check(max(gerr) <= GRAD_TOL,
              f"flash gradients disagree at {label} shapes")
        key = ("flash_attention_d_tail" if s["D"] % 32
               else "flash_attention")
        worst[key] = max(worst.get(key, 0.0), err)
        del ins, got, want, out, lse, ref_lse
        # the check's power: broken flash kernels, as plain versions on
        # changed inputs, must each fail it
        wrongs = flash_wrongs(torch, fa, kref, *qkv, kw)
        if s["D"] % 32:
            wrongs += flash_pad_wrongs(torch, fa, *qkv, kw)
        for what, wrong in wrongs:
            miss = kref.rounding_bound_ratio(wrong(), ref, mix, p_rel)
            print(f"flash   {label}: a kernel that {what} would read "
                  f"{miss:.3e}")
            check(miss > 1.0, f"the flash check misses a kernel that {what}")
        del fc, qkv, ref, mix
    torch.cuda.empty_cache()
    # the flash kernel without the causal mask and with Sq != Skv
    # (whisper-small's encoder, cross-attention and decode
    # cross-attention), forward and backward, and its broken variants
    for label, spec in CROSS_SETS.items():
        cc = cross_case(torch, rng, dev, **spec)
        r = check_cross(torch, fa, kops, kref, cc)
        print(f"flash   {label} ({r['route']}, q {tuple(cc['q'].shape)} over "
              f"k/v {tuple(cc['k'].shape)}, not causal): out max_abs_err "
              f"{r['err']:.3e}; max |err| / bound {r['ratio']:.3e}; lse "
              f"{r['lse_err']:.3e} (tol {LSE_TOL}); dq/dk/dv max err / max "
              f"|grad| {r['grad_err']:.3e} (tol {GRAD_TOL}); broken: "
              + ", ".join(f"a kernel that {w} would read {m:.3e}"
                          for w, m in r["misses"].items()), flush=True)
        check(r["tensor_cores"], f"the flash call at {label} took the wrong "
              "kernel")
        check(r["ratio"] <= 1.0 and r["lse_err"] <= LSE_TOL,
              f"flash kernel disagrees at {label}")
        check(r["grad_err"] <= GRAD_TOL,
              f"flash gradients disagree at {label}")
        for what, miss in r["misses"].items():
            check(miss > 1.0, f"the flash check at {label} misses a kernel "
                  f"that {what}")
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                       r["err"])
        del cc
    torch.cuda.empty_cache()

    # the int8 flash kernel: at the dense serving path's decode shapes
    # (qwen2-0.5b: B 8, one query, H 14 over KV 2, D 64, 2048-position
    # stripes, lengths 1-2048), at gemma2-2b's D = 288 with window and
    # softcap, and at the TPU kernel's own test shapes (heads folded,
    # q_start 0, kv_len Skv, f32 q and scales)
    path_lens = [1, 293, 586, 878, 1171, 1464, 1756, 2048]
    z_lens = [1, 147, 293, 439, 585, 731, 877, 1024]
    w_lens = [1, 64, 128, 192, 256, 320, 384, 448]
    int8_sets = {
        "qwen2-0.5b decode": dict(
            Sq=1, H=14, KV=2, D=64, Skv=2048, kv_len=path_lens,
            q_start=[n - 1 for n in path_lens]),
        "gemma2-2b decode": dict(
            Sq=1, H=8, KV=4, D=288, Skv=5000, q_start=[4096, 4999, 99, 0],
            kv_len=[4097, 5000, 100, 1], window=4096, softcap=50.0),
        # zamba2-1.2b's shared block (MHA, G = 1: one live row of a tile's
        # 16) over 1,024-position stripes, and the B = 1 prompt replay
        "zamba2-1.2b decode": dict(
            Sq=1, H=32, KV=32, D=64, Skv=1024, kv_len=z_lens,
            q_start=[n - 1 for n in z_lens]),
        "zamba2-1.2b replay": dict(
            Sq=1, H=32, KV=32, D=64, Skv=1024, q_start=[77], kv_len=[78]),
        # qwen3-moe-30b-a3b in dense int8 mode: G 8, D 128
        "qwen3-moe-30b-a3b decode": dict(
            Sq=1, H=32, KV=4, D=128, Skv=2048, kv_len=path_lens,
            q_start=[n - 1 for n in path_lens]),
        "qwen3-moe-30b-a3b replay": dict(
            Sq=1, H=32, KV=4, D=128, Skv=1024, q_start=[77], kv_len=[78]),
        # whisper-small's decoder self-attention in dense int8 mode: MHA
        # (G = 1), D 64, its 448-position context
        "whisper-small decode": dict(
            Sq=1, H=12, KV=12, D=64, Skv=448, kv_len=w_lens,
            q_start=[n - 1 for n in w_lens]),
        "TPU test (2, 1, 256, 64)": dict(
            Sq=1, H=1, KV=1, D=64, Skv=256, q_start=[0, 0],
            kv_len=[256, 256], dtype="float32"),
        "TPU test (2, 128, 128, 64)": dict(
            Sq=128, H=1, KV=1, D=64, Skv=128, q_start=[0, 0],
            kv_len=[128, 128], dtype="float32"),
        "TPU test (1, 1, 300, 128), window 64": dict(
            Sq=1, H=1, KV=1, D=128, Skv=300, q_start=[0], kv_len=[300],
            window=64, dtype="float32"),
    }
    rng8 = np.random.default_rng(8)      # its own draws: the same inputs
    for label, spec in int8_sets.items():   # whatever the phases before
        ic = int8_case(torch, rng8, dev, **spec)
        args, kw = int8_args(ic), ic["kw"]
        got = fa.flash_attention_int8kv(*args, **kw)
        torch.cuda.synchronize()
        ref = attention_int8kv_ref(*args, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        bf16 = spec.get("dtype") is None
        rel, tol = ((int8_rel_err(got, ref), INT8_BF16_RTOL) if bf16
                    else (err, INT8_F32_TOL))
        what_tol = ("|err| / max(|plain|, 2^-4)" if bf16 else "|err|")
        print(f"int8kv  {label}: max_abs_err {err:.3e}; max {what_tol} "
              f"{rel:.3e} (tol {tol:.3e}); max |plain| "
              f"{ref.float().abs().max().item():.3f}")
        check(rel <= tol, f"int8 kernel disagrees at {label}")
        worst["flash_attention_int8kv"] = max(
            worst.get("flash_attention_int8kv", 0.0), err)
        # the check's power: kernels that are wrong, grossly or by one key
        # or one rounding, computed as plain versions on the same inputs,
        # must each fail it
        q, k8, ks, v8, vs, qs, n = args
        wrongs = []
        if label in ("qwen2-0.5b decode", "zamba2-1.2b decode",
                     "zamba2-1.2b replay", "qwen3-moe-30b-a3b decode",
                     "qwen3-moe-30b-a3b replay", "whisper-small decode"):
            full = torch.full_like(n, spec["Skv"])
            tile = torch.where(n > 64, (n - 1) // 64 * 64, n)
            B8, _, H8, D8 = q.shape
            G8 = H8 // spec["KV"]
            per, splits = fa.int8_split_plan(B8, spec["KV"], spec["Skv"], D8,
                                             G8, sm_count(pa, q))
            keep = drop_first_live(torch, [kref.int8kv_split_ranges(
                a, b, spec["Skv"], G8, per, splits, row0=0, rows=G8)
                for a, b in zip(qs.tolist(), n.tolist())])
            wrongs = [
                ("dropped one split's partial from the combine",
                 lambda: kref.int8kv_split_ref(*args, keys_per_split=per,
                                               keep=keep, **kw)),
                ("ignored the scales", lambda: attention_int8kv_ref(
                    q, k8, torch.ones_like(ks), v8, torch.ones_like(vs), qs,
                    n, **kw)),
                ("ignored kv_len (the whole stripe)",
                 lambda: attention_int8kv_ref(q, k8, ks, v8, vs, full - 1,
                                              full, **kw)),
                ("dropped each row's last partial 64-key tile",
                 lambda: attention_int8kv_ref(q, k8, ks, v8, vs, qs, tile,
                                              **kw)),
                ("missed each row's newest key",
                 lambda: attention_int8kv_ref(q, k8, ks, v8, vs, qs,
                                              (n - 1).clamp(min=1), **kw))]
        elif label == "gemma2-2b decode":
            w = kw["window"]
            wrongs = [
                ("saw one key more than the window",
                 lambda: attention_int8kv_ref(*args, **dict(kw,
                                                            window=w + 1))),
                ("saw one key less than the window",
                 lambda: attention_int8kv_ref(*args, **dict(kw,
                                                            window=w - 1))),
                ("kept K in f32, unrounded to q's bf16",
                 lambda: attention_int8kv_ref(q.float(), k8, ks.float(), v8,
                                              vs.float(), qs, n, **kw))]
        for what, wrong in wrongs:
            miss = int8_rel_err(wrong(), ref)
            print(f"int8kv  {label}: a kernel that {what} would read "
                  f"{miss:.3e}")
            check(miss > tol, f"the int8 check misses a kernel that {what}")
        del ic, args, got, ref
    torch.cuda.empty_cache()

    ssd_sets = {
        "mamba2-1.3b": mamba_scan_case(torch, rng, dev, b=2, S=1024, seed=1),
        "G 2, S 1000": ssd_case(torch, rng, dev, b=1, S=1000, H=64, P=64,
                                G=2, N=128),
        "zamba2-1.2b (N 64)": mamba_scan_case(
            torch, rng, dev, b=2, S=1024, seed=3, arch="zamba2-1.2b"),
    }
    for label, sc in ssd_sets.items():
        args = (sc["x"], sc["dt"], sc["A"], sc["B"], sc["C"])
        S = args[0].shape[1]
        n_tc = ssd.ssd_tensor_core.launches
        got = kops.ssd(*args, chunk=256)
        torch.cuda.synchronize()
        tc = ssd.ssd_tensor_core.launches - n_tc
        check(tc == 1 and ssd.tensor_core_route(
            got.dtype, args[3].shape[3], got.shape[3], 256),
            f"the SSD call at {label} missed the tensor-core scan")
        # the plain version, its |.| scan and the broken ones on the inputs
        # padded to a chunk multiple, as ops.ssd pads them
        padded = kref.pad_to_chunks(args[0], args[1], args[3], args[4], 256)
        pargs = (padded[0], padded[1], args[2], padded[2], padded[3])
        ref, mix = (t[:, :S] for t in ssd_bound(ssd, pargs, 256))
        err = (got.float() - ref.float()).abs().max().item()
        rel = norm_err(got, ref)
        ratio = kref.rounding_bound_ratio(got, ref, mix, ssd.P_ROUNDING)
        ins = [t.clone().requires_grad_(True) for t in args]
        g_got = torch.autograd.grad(kops.ssd(*ins, chunk=256), ins, sc["dy"])
        torch.cuda.synchronize()
        ins = [t.clone().requires_grad_(True) for t in args]
        g_want = torch.autograd.grad(ssd.ssd_scan_plain(*ins, 256), ins,
                                     sc["dy"])
        gerr = [((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
                for g, w in zip(g_got, g_want)]
        print(f"ssd     {label} (tensor cores): max_abs_err {err:.3e}, / "
              f"max(1, |plain|) {rel:.3e} (tol {KERNEL_TOL}); max |err| / "
              f"bound {ratio:.3e} (bound 2^-8 mix + 2^-7 |plain|, mix the "
              f"plain scan of |x|, |B|, |C|; fails above 1); max |plain| "
              f"{ref.float().abs().max().item():.3e}, max mix "
              f"{mix.max().item():.3e}; dx/ddt/dA/dB/dC max err / max |grad| "
              f"{', '.join(f'{g:.1e}' for g in gerr)} (tol {GRAD_TOL})")
        check(rel <= KERNEL_TOL and ratio <= 1.0,
              f"SSD kernel disagrees at {label}")
        check(max(gerr) <= GRAD_TOL, f"SSD gradients disagree at {label}")
        worst["ssd_scan"] = max(worst.get("ssd_scan", 0.0), err)
        del ins, g_got, g_want
        # the check's power: broken scans must each fail it (read above 1,
        # or nan where the broken decay overflows: nan <= 1 is false too)
        for what, wrong in ssd_wrongs(ssd, kref, pargs, 256):
            miss = kref.rounding_bound_ratio(wrong()[:, :S], ref, mix,
                                             ssd.P_ROUNDING)
            print(f"ssd     {label}: a scan that {what} would read "
                  f"{miss:.3e}")
            check(not miss <= 1.0, f"the SSD check misses a scan that {what}")
        del sc, args, pargs, padded, got, ref, mix
    del ssd_sets
    # the CUDA-core scan (f32, and the smoke configs' shapes) at the mamba2
    # widths: its own counter, element by element within 2^-14 mix + one
    # f32 ulp and 2e-2 max(1, |plain|); the plain broken scans must fail
    sc = ssd_case(torch, rng, dev, b=1, S=1024, H=64, P=64, G=1, N=128)
    args = tuple(sc[k].float() for k in ("x", "dt", "A", "B", "C"))
    n_tc, n_cc = ssd.ssd_tensor_core.launches, ssd.ssd_cuda_core.launches
    got = kops.ssd(*args, chunk=256)
    torch.cuda.synchronize()
    check(ssd.ssd_cuda_core.launches == n_cc + 1
          and ssd.ssd_tensor_core.launches == n_tc,
          "the f32 SSD call missed the CUDA-core scan")
    ref, mix = ssd_bound(ssd, args, 256)
    err = (got - ref).abs().max().item()
    rel = norm_err(got, ref)
    ratio = kref.rounding_bound_ratio(got, ref, mix,
                                      ssd.CUDA_CORE_P_ROUNDING)
    print(f"ssd     f32, b 1, S 1024, H 64, P 64, N 128 (CUDA cores): "
          f"max_abs_err {err:.3e}, / max(1, |plain|) {rel:.3e} (tol "
          f"{KERNEL_TOL}); max |err| / bound {ratio:.3e} (bound 2^-14 mix "
          f"+ 2^-23 |plain|; fails above 1); max |plain| "
          f"{ref.abs().max().item():.3e}, max mix {mix.max().item():.3e}")
    check(rel <= KERNEL_TOL and ratio <= 1.0,
          "the CUDA-core SSD scan disagrees in f32")
    for what, wrong in ssd_wrongs(ssd, kref, args, 256)[:2]:
        miss = kref.rounding_bound_ratio(wrong(), ref, mix,
                                         ssd.CUDA_CORE_P_ROUNDING)
        print(f"ssd     f32: a scan that {what} would read {miss:.3e}")
        check(not miss <= 1.0, f"the f32 SSD check misses a scan that {what}")
    del sc, args, got, ref, mix
    torch.cuda.empty_cache()

    for d in (896, 2048, 2304, 4096, 8192):
        sc_ = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                           device=dev)
        for din, dout in ((torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.bfloat16),
                          (torch.float32, torch.float32)):
            x = torch.tensor(rng.standard_normal((1037, d)), dtype=din,
                             device=dev)
            n_one = rn.rmsnorm_one_pass.launches
            got = rn.rmsnorm(x, sc_, out_dtype=dout)
            torch.cuda.synchronize()
            check(rn.rmsnorm_one_pass.launches == n_one + 1,
                  f"RMSNorm at d {d} missed the one-pass kernel")
            ref = rn.rmsnorm_ref(x, sc_, out_dtype=dout)
            err = (got.float() - ref.float()).abs().max().item()
            rel = norm_err(got, ref)
            ulp = ulp_ratio(got, ref)
            print(f"rmsnorm d {d}, 1037 rows, {str(din)[6:]} -> "
                  f"{str(dout)[6:]} (one pass): max_abs_err {err:.3e}, / "
                  f"max(1, |plain|) {rel:.3e} (tol {KERNEL_TOL}); max |err| / "
                  f"one ulp {ulp:.3e} (fails above 1)")
            check(rel <= KERNEL_TOL and ulp <= 1.0,
                  f"RMSNorm disagrees at d {d}")
            worst["rmsnorm"] = max(worst.get("rmsnorm", 0.0), err)
            # the check's power: broken kernels must each fail the ulp rule
            for what, wrong in rmsnorm_wrongs(rn, kref, x, sc_, dout):
                miss = ulp_ratio(wrong(), ref)
                print(f"rmsnorm d {d}: a kernel with the {what} would read "
                      f"{miss:.3e}")
                check(miss > 1.0,
                      f"the RMSNorm check misses a kernel with the {what}")
    # the decode steps' rows: B = 1 (the prompt replay) and B = 8 at
    # zamba2's d 2,048 (residual norms) and 4,096 (the gated norm)
    for d in (2048, 4096):
        sc_ = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                           device=dev)
        for rows in (1, 8):
            for din in (torch.bfloat16, torch.float32):
                x = torch.tensor(rng.standard_normal((rows, d)), dtype=din,
                                 device=dev)
                n_one = rn.rmsnorm_one_pass.launches
                got = rn.rmsnorm(x, sc_, out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                check(rn.rmsnorm_one_pass.launches == n_one + 1,
                      f"RMSNorm at {rows} x {d} missed the one-pass kernel")
                ref = rn.rmsnorm_ref(x, sc_, out_dtype=torch.bfloat16)
                ulp = ulp_ratio(got, ref)
                print(f"rmsnorm {rows} x {d}, {str(din)[6:]} -> bfloat16 "
                      f"(one pass): max |err| / one ulp {ulp:.3e} (fails "
                      "above 1)")
                check(ulp <= 1.0, f"RMSNorm disagrees at {rows} x {d}")
                for what, wrong in rmsnorm_wrongs(rn, kref, x, sc_,
                                                  torch.bfloat16):
                    miss = ulp_ratio(wrong(), ref)
                    check(miss > 1.0, f"the RMSNorm check at {rows} x {d} "
                          f"misses a kernel with the {what}")
    # the two-pass kernel: d past the one-pass kernel's widest (packs of
    # 8), d % 8 != 0 and rows one element off 16-byte alignment (element
    # by element), each within one ulp on its own counter
    for d, skew, path in ((16384, 0, "packs of 8"), (100, 0, "scalar"),
                          (4096, 1, "scalar, misaligned rows")):
        sc_ = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                           device=dev)
        for din, dout in ((torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.bfloat16),
                          (torch.float32, torch.float32)):
            x = torch.tensor(rng.standard_normal(1037 * d + skew), dtype=din,
                             device=dev)[skew:].view(1037, d)
            n_two = rn.rmsnorm_two_pass.launches
            got = rn.rmsnorm(x, sc_, out_dtype=dout)
            torch.cuda.synchronize()
            check(rn.rmsnorm_two_pass.launches == n_two + 1,
                  f"RMSNorm at d {d} ({path}) missed the two-pass kernel")
            ref = rn.rmsnorm_ref(x, sc_, out_dtype=dout)
            err = (got.float() - ref.float()).abs().max().item()
            rel = norm_err(got, ref)
            ulp = ulp_ratio(got, ref)
            print(f"rmsnorm d {d}, 1037 rows, {str(din)[6:]} -> "
                  f"{str(dout)[6:]} (two pass, {path}): max_abs_err "
                  f"{err:.3e}, / max(1, |plain|) {rel:.3e} (tol "
                  f"{KERNEL_TOL}); max |err| / one ulp {ulp:.3e} (fails "
                  "above 1)")
            check(rel <= KERNEL_TOL and ulp <= 1.0,
                  f"RMSNorm (two pass, {path}) disagrees at d {d}")
    x = torch.tensor(rng.standard_normal((1037, 4096)), dtype=torch.float32,
                     device=dev)
    sc_ = torch.tensor(0.1 * rng.standard_normal(4096), dtype=torch.float32,
                       device=dev)
    dy = torch.randn((1037, 4096), dtype=torch.bfloat16, device=dev)
    ins = [t.clone().requires_grad_(True) for t in (x, sc_)]
    g_got = torch.autograd.grad(kops.rmsnorm(*ins, out_dtype=torch.bfloat16),
                                ins, dy)
    ins = [t.clone().requires_grad_(True) for t in (x, sc_)]
    g_want = torch.autograd.grad(
        rn.rmsnorm_ref(*ins, out_dtype=torch.bfloat16), ins, dy)
    gerr = [((g.float() - w.float()).abs().max() / w.float().abs().max())
            .item() for g, w in zip(g_got, g_want)]
    print(f"rmsnorm gradients (d 4096, f32 -> bf16): dx/dscale max err / max "
          f"|grad| {', '.join(f'{g:.1e}' for g in gerr)} (tol {GRAD_TOL})")
    check(max(gerr) <= GRAD_TOL, "RMSNorm gradients disagree")
    sys.stdout.flush()

    # 4. times at the main path's shapes -----------------------------------
    phase("times")
    from repro_torch.serving.profiling import decode_cost, prefill_cost
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    dcase = decode_case(torch, rng, dev, B=8, KV=2, G=7, D=64, page=16,
                        lengths=[512, 704, 896, 1088, 1280, 1472, 1664, 2048],
                        garbage=False)
    pcase = prefill_case(torch, rng, dev, B=4, KV=2, G=7, D=64, page=16,
                         C=64, starts=[0, 256, 640, 1024],
                         q_lens=[64, 64, 64, 64])
    dargs = (dcase["q"], dcase["k_pages"], dcase["v_pages"],
             dcase["block_tables"], dcase["lengths"])
    pargs = (pcase["q"], pcase["k_pages"], pcase["v_pages"],
             pcase["block_tables"], pcase["start_pos"], pcase["q_lens"])
    pkw = dict(group=pcase["group"])
    fcase = flash_case(torch, rng, dev, B=8, S=1024, H=14, KV=2, D=64)
    fargs = (fcase["q"], fcase["k"], fcase["v"])
    scase = mamba_scan_case(torch, rng, dev, b=8, S=1024, seed=2)
    sargs = (scase["x"], scase["dt"], scase["A"], scase["B"], scase["C"])
    # mamba2-1.3b's gated norm at training shapes: the unrounded f32
    # product in, bf16 out
    ncase = dict(x=torch.randn((8192, 4096), dtype=torch.float32,
                               device=dev),
                 scale=0.1 * torch.randn((4096,), dtype=torch.float32,
                                         device=dev),
                 out_dtype="bfloat16")
    gain = 1.0 + ncase["scale"]
    # the int8 kernel at the dense serving path's decode shapes (B = 8,
    # 2048-position stripes, lengths 1-2048); the yardstick reads K/V
    # dequantized beforehand, (B, KV, Skv, D) bf16, untimed
    icase = int8_case(torch, rng, dev, **int8_sets["qwen2-0.5b decode"])
    iargs, ikw = int8_args(icase), icase["kw"]
    kd, vd = dequantized_kv(icase)
    # the unembedding's backward split on the training cell's chunk, at
    # the vector route and, one column on, the scalar route
    ucase, uodd = unembed_split_cases(torch, dev)
    kernels = []
    for kname, fn, plain, lib, cost, case, src, tpu in (
            ("paged_decode_attention",
             lambda: pa.paged_attention(*dargs),
             lambda: pa.paged_attention_plain(*dargs),
             lambda: library_decode(torch, F, dcase), decode_cost, dcase,
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:97"),
            ("paged_prefill_attention",
             lambda: pp.paged_prefill(*pargs, **pkw),
             lambda: pp.paged_prefill_plain(*pargs, **pkw),
             lambda: library_prefill(torch, F, pcase), prefill_cost, pcase,
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:111"),
            ("flash_attention",
             lambda: fa.flash_attention(*fargs)[0],
             lambda: fa.flash_attention_plain(*fargs)[0],
             lambda: library_flash(torch, F, fcase), flash_cost, fcase,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:203"),
            ("flash_attention_int8kv",
             lambda: fa.flash_attention_int8kv(*iargs, **ikw),
             lambda: attention_int8kv_ref(*iargs, **ikw),
             lambda: library_int8(torch, F, icase, kd, vd), int8_cost, icase,
             "src/repro_torch/kernels/csrc/flash_attention_int8kv.cu",
             "src/repro/kernels/flash_attention.py:156"),
            ("ssd_scan",
             lambda: ssd.ssd_scan(*sargs, 256),
             lambda: ssd.ssd_scan_plain(*sargs, 256),
             None, lambda c: ssd_cost(c, 256), scase,
             "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:70"),
            ("rmsnorm",
             lambda: rn.rmsnorm(ncase["x"], ncase["scale"],
                                out_dtype=torch.bfloat16),
             lambda: rn.rmsnorm_ref(ncase["x"], ncase["scale"],
                                    out_dtype=torch.bfloat16),
             lambda: F.rms_norm(ncase["x"], (4096,), weight=gain, eps=1e-6),
             rmsnorm_cost, ncase,
             "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:24"),
            ("unembed_split",
             lambda: ue.unembed_split(ucase["g"], ucase["out"]),
             lambda: ue.unembed_split_plain(ucase["g"], ucase["out_plain"]),
             None, lambda c: ue.split_cost(*c["g"].shape), ucase,
             "src/repro_torch/kernels/csrc/unembed_split.cu", None),
            ("unembed_split_unaligned",
             lambda: ue.unembed_split(uodd["g"], uodd["out"]),
             lambda: ue.unembed_split_plain(uodd["g"], uodd["out_plain"]),
             None, lambda c: ue.split_cost(*c["g"].shape), uodd,
             "src/repro_torch/kernels/csrc/unembed_split.cu", None)):
        ref_t, got_t = plain(), fn()
        ref, out = ref_t.float(), got_t.float()
        err = (out - ref).abs().max().item()
        if kname == "ssd_scan":
            mix = ssd_bound(ssd, sargs, 256)[1]
            ok = (norm_err(out, ref) <= KERNEL_TOL and kref.rounding_bound_ratio(
                got_t, ref_t, mix, ssd.P_ROUNDING) <= 1.0)
            del mix
        elif kname == "rmsnorm":
            ok = (norm_err(out, ref) <= KERNEL_TOL
                  and ulp_ratio(got_t, ref_t) <= 1.0)
        elif kname == "flash_attention_int8kv":
            ok = int8_rel_err(out, ref) <= INT8_BF16_RTOL
        elif kname == "flash_attention":
            _, mix, p_rel = flash_bound(fa, *fargs, fcase["kw"])
            ok = kref.rounding_bound_ratio(got_t, ref_t, mix, p_rel) <= 1.0
            del mix
        elif kname.startswith("unembed_split"):
            ok = torch.equal(got_t.view(torch.int16),
                             ref_t.view(torch.int16))
        elif kname == "paged_decode_attention":
            mix = decode_bound(pa, dcase)[1]
            ok = kref.rounding_bound_ratio(got_t, ref_t, mix,
                                           pa.P_ROUNDING) <= 1.0
            del mix
        else:
            _, mix, p_rel = prefill_bound(pp, pcase)
            ok = kref.rounding_bound_ratio(got_t, ref_t, mix, p_rel) <= 1.0
            del mix
        lib_err = (None if lib is None
                   else (lib().float() - ref).abs().max().item())
        del ref, out, ref_t, got_t
        check(ok, f"{kname} disagrees at timing shapes")
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        lib_ms = None if lib is None else time_ms(torch, lib, flush)
        nbytes, flops = cost(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / BF16_FLOPS_PER_S * 1e3
        bound_by = "bytes" if t_bytes >= t_flops else "operations"
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": tpu, "tpu_kernel": tpu, "launches": 0,
                 "max_abs_err": max(err, worst.get(kname, 0.0)),
                 "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_flops), "bound_by": bound_by,
                 "library_ms": lib_ms, "bytes": nbytes, "flops": flops}
        kernels.append(entry)
        lib_txt = ("no single PyTorch call computes it" if lib is None else
                   f"{lib_ms:.4f} ms (err vs plain {lib_err:.2e})")
        print(f"{kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_txt}, bound {entry['bound_ms']:.4f} ms by "
              f"{bound_by} ({nbytes} B, {flops} flop)", flush=True)
    by_name = {k["name"]: k for k in kernels}
    by_name["ssd_scan"]["design"] = (
        f"tensor cores (mma.sync), {len(ssd.TC_KERNELS)} launches: "
        + ", ".join(ssd.TC_KERNELS))
    by_name["rmsnorm"]["design"] = "one pass, each row read once into registers"
    for name, route in (("unembed_split", "vector: split_vec_kernel"),
                        ("unembed_split_unaligned",
                         "scalar: split_scalar_kernel")):
        by_name[name]["replaces"] = ("src/repro/models/modules.py unembed "
                                     "(no pallas_call: XLA's dot)")
        by_name[name]["design"] = (
            f"{route}; the f32 cotangent read once, hi, mid and lo "
            "written once, equal to unembed_split_plain bit for bit")
    ucase.clear()
    uodd.clear()
    torch.cuda.empty_cache()

    # the int8 kernel and paged prefill also at the shapes their paths run
    # most: the dense prefill replay (B = 1, one query, a 1,024-position
    # staging stripe, kv_len 1-128: eight calls, one per length) and the
    # launcher's prefill round (B = 4 x C = 16, starts 0-1,024); means over
    # the calls
    def int8_fns(case):
        a, kw = int8_args(case), case["kw"]
        kd_, vd_ = dequantized_kv(case)
        return (lambda: fa.flash_attention_int8kv(*a, **kw),
                lambda: attention_int8kv_ref(*a, **kw),
                lambda: library_int8(torch, F, case, kd_, vd_))

    def prefill_fns(case):
        a, kw = prefill_args(case), dict(group=case["group"])
        return (lambda: pp.paged_prefill(*a, **kw),
                lambda: pp.paged_prefill_plain(*a, **kw),
                lambda: library_prefill(torch, F, case))

    def int8_ok(case, got, want):
        return int8_rel_err(got, want) <= INT8_BF16_RTOL

    def prefill_ok(case, got, want):
        _, mix, p_rel = prefill_bound(pp, case)
        return (kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0
                and padding_rows_zero(got, case))

    replay_lens = [1, 19, 37, 55, 74, 92, 110, 128]
    for kname, what, cases, fns, ok_of, cost in (
            ("flash_attention_int8kv",
             "q (1, 1, 14, 64) bf16, int8 K/V (1, 1024, 2, 64), kv_len "
             f"{replay_lens} (one call each)",
             [int8_case(torch, rng, dev, Sq=1, H=14, KV=2, D=64, Skv=1024,
                        q_start=[n - 1], kv_len=[n]) for n in replay_lens],
             int8_fns, int8_ok, int8_cost),
            ("paged_prefill_attention",
             "q (4, 2, 16*7, 64) bf16, C = 16, starts [0, 341, 683, 1024]",
             [prefill_case(torch, rng, dev, B=4, KV=2, G=7, D=64, page=16,
                           C=16, starts=[0, 341, 683, 1024],
                           q_lens=[16, 16, 16, 16])],
             prefill_fns, prefill_ok, prefill_cost)):
        t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        err, by = 0.0, set()
        for case in cases:
            fn, plain, lib = fns(case)
            want, got = plain(), fn()
            err = max(err, (got.float() - want.float()).abs().max().item())
            check(ok_of(case, got, want),
                  f"{kname} disagrees at its path shapes")
            del want, got
            nbytes, flops = cost(case)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / BF16_FLOPS_PER_S * 1e3
            by.add("bytes" if t_bytes >= t_flops else "operations")
            for key, f, reps in (("ms", fn, 20), ("plain_ms", plain, 5),
                                 ("library_ms", lib, 20)):
                t[key] += time_ms(torch, f, flush, reps=reps) / len(cases)
            t["bound_ms"] += max(t_bytes, t_flops) / len(cases)
        entry = by_name[kname]
        entry["path_shapes"] = dict(t, shapes=what, calls=len(cases),
                                    bound_by="/".join(sorted(by)))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"{kname} at {what}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.5f} ms by {'/'.join(sorted(by))} "
              f"(means over {len(cases)} calls)", flush=True)
        del cases
    xb = ncase["x"].bfloat16()
    bf_ms = time_ms(torch, lambda: rn.rmsnorm(xb, ncase["scale"]), flush)
    print(f"rmsnorm 8192 x 4096 bf16 -> bf16: kernel {bf_ms:.4f} ms, bound "
          f"{(xb.numel() * 4 + 4096 * 4) / HBM_BYTES_PER_S * 1e3:.4f} ms "
          "(bytes)", flush=True)
    # RMSNorm at the qwen2 training step's norms: 8,192 rows x 896, the f32
    # residual in, bf16 out
    qcase = dict(x=torch.randn((8192, 896), dtype=torch.float32, device=dev),
                 scale=0.1 * torch.randn((896,), dtype=torch.float32,
                                         device=dev),
                 out_dtype="bfloat16")
    qgain = 1.0 + qcase["scale"]
    qfn = lambda: rn.rmsnorm(qcase["x"], qcase["scale"],
                             out_dtype=torch.bfloat16)
    qplain = lambda: rn.rmsnorm_ref(qcase["x"], qcase["scale"],
                                    out_dtype=torch.bfloat16)
    check(ulp_ratio(qfn(), qplain()) <= 1.0,
          "rmsnorm disagrees at 8192 x 896")
    nbytes, flops = rmsnorm_cost(qcase)
    q = dict(ms=time_ms(torch, qfn, flush),
             plain_ms=time_ms(torch, qplain, flush, reps=5),
             library_ms=time_ms(torch, lambda: F.rms_norm(
                 qcase["x"], (896,), weight=qgain, eps=1e-6), flush),
             bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
             * 1e3, bound_by="bytes", shapes="8192 x 896 f32 -> bf16")
    by_name["rmsnorm"]["path_shapes"] = q
    print(f"rmsnorm at {q['shapes']} (qwen2's norms): kernel {q['ms']:.4f} ms, "
          f"plain {q['plain_ms']:.4f} ms, library {q['library_ms']:.4f} ms, "
          f"bound {q['bound_ms']:.4f} ms by bytes", flush=True)
    # the tensor-core SSD scan launch by launch at the timing shapes: each
    # kernel's device time in whole scans, from the profiler
    stages = kernel_times_ms(torch, lambda: ssd.ssd_scan(*sargs, 256),
                             ssd.TC_KERNELS, flush)
    by_name["ssd_scan"]["stages_ms"] = stages
    print("ssd_scan launches (tensor cores, b 8, profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stages.items()) + f"; sum "
        f"{sum(stages.values()):.4f} ms", flush=True)
    check(all(v > 0 for v in stages.values()),
          "the profiler saw no device time for an SSD launch")
    del scase, sargs, ncase, gain, xb, icase, iargs, kd, vd, qcase, qgain
    torch.cuda.empty_cache()

    # the kernels at zamba2-1.2b's shapes: flash in training (MHA, G = 1),
    # the int8 kernel at a B = 8 decode step and at the B = 1 prompt
    # replay, the SSD scan at N 64 (b 8), RMSNorm on the residual (8,192 x
    # 2,048, the f32 sum in, bf16 out); each checked as above, then timed
    # beside its plain version, its library call and its bound
    zf = flash_case(torch, rng, dev, B=8, S=1024, H=32, KV=32, D=64)
    zfa = (zf["q"], zf["k"], zf["v"])
    zs = mamba_scan_case(torch, rng, dev, b=8, S=1024, seed=4,
                         arch="zamba2-1.2b")
    zsa = (zs["x"], zs["dt"], zs["A"], zs["B"], zs["C"])
    zn = dict(x=torch.randn((8192, 2048), dtype=torch.float32, device=dev),
              scale=0.1 * torch.randn((2048,), dtype=torch.float32,
                                      device=dev),
              out_dtype="bfloat16")
    zgain = 1.0 + zn["scale"]

    def flash_ok(got, want):
        _, mix, p_rel = flash_bound(fa, *zfa, zf["kw"])
        return kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0

    def ssd_ok(got, want):
        mix = ssd_bound(ssd, zsa, 256)[1]
        return (norm_err(got, want) <= KERNEL_TOL and kref.rounding_bound_ratio(
            got, want, mix, ssd.P_ROUNDING) <= 1.0)

    zcases = [
        ("flash_attention", "q, k, v (8, 1024, 32, 64) bf16, causal",
         lambda: fa.flash_attention(*zfa)[0],
         lambda: fa.flash_attention_plain(*zfa)[0],
         lambda: library_flash(torch, F, zf), flash_cost, zf, flash_ok),
        ("ssd_scan", "x (8, 1024, 64, 64), B/C (8, 1024, 1, 64) bf16, "
         "chunk 256", lambda: ssd.ssd_scan(*zsa, 256),
         lambda: ssd.ssd_scan_plain(*zsa, 256), None,
         lambda c: ssd_cost(c, 256), zs, ssd_ok),
        ("rmsnorm", "8192 x 2048 f32 -> bf16",
         lambda: rn.rmsnorm(zn["x"], zn["scale"], out_dtype=torch.bfloat16),
         lambda: rn.rmsnorm_ref(zn["x"], zn["scale"],
                                out_dtype=torch.bfloat16),
         lambda: F.rms_norm(zn["x"], (2048,), weight=zgain, eps=1e-6),
         rmsnorm_cost, zn, lambda got, want: ulp_ratio(got, want) <= 1.0)]
    for label, what in (("zamba2-1.2b decode",
                         "q (8, 1, 32, 64) bf16, int8 K/V (8, 1024, 32, 64), "
                         f"kv_len {z_lens}"),
                        ("zamba2-1.2b replay",
                         "q (1, 1, 32, 64) bf16, int8 K/V (1, 1024, 32, "
                         "64), kv_len 78")):
        zc = int8_case(torch, rng, dev, **int8_sets[label])
        fn_, plain_, lib_ = int8_fns(zc)
        zcases.append(("flash_attention_int8kv", what, fn_, plain_, lib_,
                       int8_cost, zc, lambda got, want: int8_rel_err(
                           got, want) <= INT8_BF16_RTOL))
    time_cases(torch, zcases, "zamba2", "zamba2_shapes", by_name, flush)
    zstages = kernel_times_ms(torch, lambda: ssd.ssd_scan(*zsa, 256),
                              ssd.TC_KERNELS, flush)
    by_name["ssd_scan"]["zamba2_stages_ms"] = zstages
    print("ssd_scan launches at zamba2's N 64 (b 8, profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in zstages.items()), flush=True)
    del zf, zfa, zs, zsa, zn, zgain, zcases
    torch.cuda.empty_cache()

    # the paged kernels and the int8 kernel at qwen3-moe-30b-a3b's shapes
    # (KV 4, G 8, D 128): a B = 8 decode round at contexts 512-2048, the
    # prefill tile at C = 16 and C = 64, the dense int8 decode step and
    # the B = 1 prompt replay; each checked as in phase 3, then timed
    # beside its plain version, its library call and its bound
    mdc = decode_case(torch, rng, dev, B=8, KV=4, G=8, D=128, page=16,
                      lengths=moe_lens, garbage=False)

    def moe_decode_ok(got, want):
        return kref.rounding_bound_ratio(
            got, want, decode_bound(pa, mdc)[1], pa.P_ROUNDING) <= 1.0

    mcases = [("paged_decode_attention",
               f"q (8, 4, 8, 128) bf16, 16-token pages, contexts {moe_lens}",
               lambda: pa.paged_attention(*decode_args(mdc)),
               lambda: pa.paged_attention_plain(*decode_args(mdc)),
               lambda: library_decode(torch, F, mdc), decode_cost, mdc,
               moe_decode_ok)]
    for C, starts in ((16, [0, 341, 683, 1024]), (64, [0, 256, 640, 1024])):
        mpc = prefill_case(torch, rng, dev, B=4, KV=4, G=8, D=128, page=16,
                           C=C, starts=starts, q_lens=[C] * 4)
        fn_, plain_, lib_ = prefill_fns(mpc)
        mcases.append(("paged_prefill_attention",
                       f"q (4, 4, {C}*8, 128) bf16, C = {C}, starts "
                       f"{starts}", fn_, plain_, lib_, prefill_cost, mpc,
                       lambda got, want, c=mpc: prefill_ok(c, got, want)))
    for label, what in (("qwen3-moe-30b-a3b decode",
                         "q (8, 1, 32, 128) bf16, int8 K/V (8, 2048, 4, "
                         f"128), kv_len {path_lens}"),
                        ("qwen3-moe-30b-a3b replay",
                         "q (1, 1, 32, 128) bf16, int8 K/V (1, 1024, 4, "
                         "128), kv_len 78")):
        mic = int8_case(torch, rng, dev, **int8_sets[label])
        fn_, plain_, lib_ = int8_fns(mic)
        mcases.append(("flash_attention_int8kv", what, fn_, plain_, lib_,
                       int8_cost, mic, lambda got, want: int8_rel_err(
                           got, want) <= INT8_BF16_RTOL))
    time_cases(torch, mcases, "qwen3-moe", "moe_shapes", by_name, flush)
    del mdc, mcases
    torch.cuda.empty_cache()

    # the kernels at whisper-small's shapes (flash: the encoder, training's
    # cross-attention and decoder self-attention, decode's cross-attention;
    # the int8 kernel at its dense int8 decode step) and qwen2-vl-72b's
    # (flash in training, GQA 64 / 8, D 128; paged decode at a B = 8
    # round, contexts 512-2048; paged prefill at the engine's C = 16 tile;
    # RMSNorm on its 2,048 x 8,192 training rows, the f32 sum in, bf16
    # out: the one-pass route's widest rows); each checked as in phase 3,
    # then timed beside its plain version, its library call (SDPA,
    # is_causal as the call asks; the yardsticks of phase 4) and its bound
    def flash_fns(case):
        a, kw = (case["q"], case["k"], case["v"]), case["kw"]

        def ok(got, want):
            _, mix, p_rel = flash_bound(fa, *a, kw)
            return kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0
        return (lambda: fa.flash_attention(*a, **kw)[0],
                lambda: fa.flash_attention_plain(*a, **kw)[0],
                lambda: library_cross(torch, F, case), ok)

    wcases = []
    for what, spec in (
            ("encoder q, k, v (8, 1500, 12, 64) bf16, not causal",
             CROSS_SETS["whisper encoder"]),
            ("cross q (8, 448, 12, 64) over k/v (8, 1500, 12, 64) bf16, not "
             "causal", CROSS_SETS["whisper cross"]),
            ("decode cross q (8, 1, 12, 64) over k/v (8, 1500, 12, 64) bf16, "
             "not causal", CROSS_SETS["whisper decode cross"]),
            ("decoder self q, k, v (8, 448, 12, 64) bf16, causal",
             dict(B=8, Sq=448, Skv=448, H=12, KV=12, D=64, causal=True))):
        wc = cross_case(torch, rng, dev, **spec)
        fn_, plain_, lib_, ok_ = flash_fns(wc)
        wcases.append(("flash_attention", what, fn_, plain_, lib_,
                       cross_cost, wc, ok_))
    wic = int8_case(torch, rng, dev, **int8_sets["whisper-small decode"])
    fn_, plain_, lib_ = int8_fns(wic)
    wcases.append(("flash_attention_int8kv",
                   "q (8, 1, 12, 64) bf16, int8 K/V (8, 448, 12, 64), kv_len "
                   f"{w_lens}", fn_, plain_, lib_, int8_cost, wic,
                   lambda got, want: int8_rel_err(got, want)
                   <= INT8_BF16_RTOL))
    time_cases(torch, wcases, "whisper-small", "whisper_shapes", by_name,
               flush)
    del wcases, wic
    torch.cuda.empty_cache()
    vlm_lens = [512, 731, 950, 1170, 1389, 1609, 1828, 2048]
    vf = cross_case(torch, rng, dev, B=2, Sq=1024, Skv=1024, H=64, KV=8,
                    D=128, causal=True)
    fn_, plain_, lib_, ok_ = flash_fns(vf)
    vcases = [("flash_attention",
               "q (2, 1024, 64, 128), k/v (2, 1024, 8, 128) bf16, causal",
               fn_, plain_, lib_, cross_cost, vf, ok_)]
    vdc = decode_case(torch, rng, dev, B=8, KV=8, G=8, D=128, page=16,
                      lengths=vlm_lens, garbage=False)

    def vlm_decode_ok(got, want):
        return kref.rounding_bound_ratio(
            got, want, decode_bound(pa, vdc)[1], pa.P_ROUNDING) <= 1.0

    vcases.append(("paged_decode_attention",
                   f"q (8, 8, 8, 128) bf16, 16-token pages, contexts "
                   f"{vlm_lens}", lambda: pa.paged_attention(
                       *decode_args(vdc)),
                   lambda: pa.paged_attention_plain(*decode_args(vdc)),
                   lambda: library_decode(torch, F, vdc), decode_cost, vdc,
                   vlm_decode_ok))
    vpc = prefill_case(torch, rng, dev, B=4, KV=8, G=8, D=128, page=16, C=16,
                       starts=[0, 341, 683, 1024], q_lens=[16] * 4)
    fn_, plain_, lib_ = prefill_fns(vpc)
    vcases.append(("paged_prefill_attention",
                   "q (4, 8, 16*8, 128) bf16, C = 16, starts [0, 341, 683, "
                   "1024]", fn_, plain_, lib_, prefill_cost, vpc,
                   lambda got, want: prefill_ok(vpc, got, want)))
    vn = dict(x=torch.randn((2048, 8192), dtype=torch.float32, device=dev),
              scale=0.1 * torch.randn((8192,), dtype=torch.float32,
                                      device=dev), out_dtype="bfloat16")
    vgain = 1.0 + vn["scale"]
    n_one = rn.rmsnorm_one_pass.launches
    vcases.append(("rmsnorm", "2048 x 8192 f32 -> bf16 (one pass)",
                   lambda: rn.rmsnorm(vn["x"], vn["scale"],
                                      out_dtype=torch.bfloat16),
                   lambda: rn.rmsnorm_ref(vn["x"], vn["scale"],
                                          out_dtype=torch.bfloat16),
                   lambda: F.rms_norm(vn["x"], (8192,), weight=vgain,
                                      eps=1e-6),
                   rmsnorm_cost, vn,
                   lambda got, want: ulp_ratio(got, want) <= 1.0))
    time_cases(torch, vcases, "qwen2-vl-72b", "vlm_shapes", by_name, flush)
    check(rn.rmsnorm_one_pass.launches > n_one
          and rn.one_pass_route(8192, True),
          "RMSNorm at d 8192 missed the one-pass kernel")
    del vcases, vf, vdc, vpc, vn, vgain
    torch.cuda.empty_cache()

    # gemma2-2b's D 288 (KV 4, G 2, window 4,096, softcap 50) at its paths'
    # shapes: a B = 8 decode round and the engine's prefill tile (4 rows,
    # C = 16) at contexts 4,200-6,000, where the window binds; the flash
    # forward of a training step (2, 2048, 8 / 4) with the softcap (its
    # local layers' window spans the sequence); the dense int8 decode.
    # Each checked as in phase 3 (flash and prefill on the tensor-core
    # routes, checked by their counters), timed beside its plain version,
    # its library call (SDPA takes no softcap: gather + SDPA with the
    # masks, SDPA causal) and its bound; the CUDA-core routes the two
    # tensor-core ones replace, at the same inputs, timed beside them
    gemma2_shapes = gemma2_kernel_times(torch, F, rng, dev, by_name, flush,
                                        int8_sets["gemma2-2b decode"])

    # the repaired routes as kernels of their own: the f32 decode and
    # CUDA-core f32 prefill at the shapes the launcher's kernel profiles
    # give them (phase 17's engine: 8 slots of 1,024 positions, page 16,
    # 513 pages, qwen2-0.5b's heads; ``profiling.paged_profile_cases``), and
    # the flash D tail at gemma2-27b's head layout (D 144, padded to 160),
    # each checked as in phase 3 and timed beside its plain version, its
    # library call (gather + SDPA in f32; SDPA) and its bound (f32 flops at
    # 67 TFLOP/s, bf16 at 989); phase 21 (d) adds the D tail with gemma2's
    # window and softcap
    from repro_torch.serving.profiling import paged_profile_cases
    prof_cases = paged_profile_cases(
        slots=8, num_blocks=512, page=16, blocks_per_slot=64,
        max_seq_len=1024, num_heads=14, num_kv_heads=2, head_dim=64,
        device=dev)
    d32, p32 = prof_cases["paged_attention"], prof_cases["paged_prefill"]
    d32a, p32a = decode_args(d32), prefill_args(p32)
    p32kw = dict(group=p32["group"])
    tf = flash_case(torch, rng, dev, B=2, S=2048, H=32, KV=16, D=144)
    tfa = (tf["q"], tf["k"], tf["v"])

    def d32_ok(got, want):
        return kref.rounding_bound_ratio(got, want, decode_bound(pa, d32)[1],
                                         pa.P_ROUNDING) <= 1.0

    def p32_ok(got, want):
        _, mix, p_rel = prefill_bound(pp, p32)
        return (kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0
                and padding_rows_zero(got, p32))

    def tf_ok(got, want):
        _, mix, p_rel = flash_bound(fa, *tfa, tf["kw"])
        return kref.rounding_bound_ratio(got, want, mix, p_rel) <= 1.0

    for kname, what, fn, plain, lib, cost, case, ok_of, peak, src, tpu in (
            ("paged_decode_attention_f32",
             "q (8, 2, 7, 64) f32, pages (513, 16, 2, 64), lengths 1024",
             lambda: pa.paged_attention(*d32a),
             lambda: pa.paged_attention_plain(*d32a),
             lambda: library_decode(torch, F, d32), decode_cost, d32, d32_ok,
             F32_FLOPS_PER_S, "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:97"),
            ("paged_prefill_attention_f32",
             "q (8, 2, 8*7, 64) f32, C = 8, starts 0, pages (513, 16, 2, 64)",
             lambda: pp.paged_prefill(*p32a, **p32kw),
             lambda: pp.paged_prefill_plain(*p32a, **p32kw),
             lambda: library_prefill(torch, F, p32), prefill_cost, p32,
             p32_ok, F32_FLOPS_PER_S,
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:111"),
            ("flash_attention_d_tail",
             "q (2, 2048, 32, 144), k/v (2, 2048, 16, 144) bf16, causal "
             "(padded to D 160: tensor cores)",
             lambda: fa.flash_attention(*tfa)[0],
             lambda: fa.flash_attention_plain(*tfa)[0],
             lambda: library_flash(torch, F, tf), flash_cost, tf, tf_ok,
             BF16_FLOPS_PER_S, "src/repro_torch/kernels/flash_attention.py "
             "(run_padded) + csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:203")):
        want, got = plain(), fn()
        err = (got.float() - want.float()).abs().max().item()
        check(ok_of(got, want), f"{kname} disagrees at {what}")
        del want, got
        nbytes, flops = cost(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / peak * 1e3
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": tpu, "tpu_kernel": tpu, "launches": 0,
                 "max_abs_err": max(err, worst.get(kname, 0.0)),
                 "ms": time_ms(torch, fn, flush),
                 "plain_ms": time_ms(torch, plain, flush, reps=5),
                 "bound_ms": max(t_bytes, t_flops),
                 "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                 "library_ms": time_ms(torch, lib, flush), "bytes": nbytes,
                 "flops": flops, "shapes": what}
        entry["kernel_ms"] = entry["ms"]
        kernels.append(entry)
        by_name[kname] = entry
        print(f"{kname} at {what}: kernel {entry['ms']:.4f} ms, plain "
              f"{entry['plain_ms']:.4f} ms, library "
              f"{entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.5f} "
              f"ms by {entry['bound_by']} ({nbytes} B, {flops} flop)",
              flush=True)
    del prof_cases, d32, p32, d32a, p32a, tf, tfa
    torch.cuda.empty_cache()

    queue_sharded_cpu_steps()           # phase 21 (e)'s CPU halves

    # 5. serving at full width ---------------------------------------------
    phase("serving qwen2-0.5b, full width")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    cfg = get_config("qwen2-0.5b")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    sched_a = launcher.main([
        "--arch", "qwen2-0.5b", "--paged", "--max-slots", "8",
        "--max-seq-len", "2048", "--prefill-batch", "4",
        "--prefill-token-budget", "512", "--prefix-cache-blocks", "256",
        "--shared-prefix", "256", "--requests", "12", "--max-new", "32",
        "--greedy", "--metrics-json", str(OUT / "serve_metrics.json")
    ]).replicas[0].scheduler            # one replica behind the gateway
    torch.cuda.synchronize()
    launches_a = read_counts(counters)
    print(f"(a) launcher: kernel launches {launches_a}")
    rep_a = report_serving(torch, sched_a, "(a) launcher", dev)
    check(rep_a["requests"] == 12, "(a) not every request completed")
    serving_kernels = ("paged_decode_attention", "paged_prefill_attention",
                       "rmsnorm")
    check(all(launches_a[k] > 0 for k in serving_kernels),
          "(a) a kernel of the path was never launched")
    check(rep_a["prefix_hit_rate"] > 0, "(a) no prefix-cache hit")
    check(launches_a["paged_prefill_tensor_core"]
          == launches_a["paged_prefill_attention"],
          "(a) a prefill launch missed the tensor-core kernel")
    check_no_leaks(sched_a, "(a)")
    eng_a = sched_a.engine
    check_programs(eng_a, "(a)", "prefill_paged",
                   eng_a.prefill_batch * eng_a.prefill_chunk)
    check_round_launches(eng_a, launches_a, "(a)", cfg)
    params = eng_a.params
    del sched_a, eng_a
    torch.cuda.empty_cache()

    rs = np.random.default_rng(1)
    shared = rs.integers(0, cfg.vocab_size, 256, dtype=np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, int(rs.integers(64, 769)), dtype=np.int32)])
        for _ in range(8)]
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, params, max_seq_len=2048, max_slots=8,
                        prefix_cache_blocks=256, paged=True,
                        prefill_batch=4, device=dev)
    sched_b = Scheduler(eng, prefill_token_budget=512, profile=True)
    zero_counts(counters)
    rids = [sched_b.submit(Request(p, SamplingParams(max_new_tokens=32,
                                                     greedy=True)))
            for p in prompts]
    run_marking_warm(sched_b)
    torch.cuda.synchronize()
    launches_b = read_counts(counters)
    print(f"(b) long prompts {[len(p) for p in prompts]}: kernel launches "
          f"{launches_b}")
    rep_b = report_serving(torch, sched_b, "(b) direct", dev)
    outs = [sched_b.output(r) for r in rids]
    check(all(len(o) == 32 for o in outs), "(b) not every request completed")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
          "(b) token ids out of range")
    check(all(launches_b[k] > 0 for k in serving_kernels),
          "(b) a kernel of the path was never launched")
    check(rep_b["prefix_hit_rate"] > 0, "(b) no prefix-cache hit")
    check(launches_b["paged_prefill_tensor_core"]
          == launches_b["paged_prefill_attention"],
          "(b) a prefill launch missed the tensor-core kernel")
    check_no_leaks(sched_b, "(b)")
    check(eng.recompiles.warm, "(b) the engine never held both programs")
    check_programs(eng, "(b)", "prefill_paged",
                   eng.prefill_batch * eng.prefill_chunk)
    check_round_launches(eng, launches_b, "(b)", cfg)
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        k = by_name[name]                 # the serving path's own kernels
        k["launches"] = launches_a[name] + launches_b[name]
        k["launches_per_part"] = [launches_a[name], launches_b[name]]
    rms_paths = {"serving": launches_a["rmsnorm"] + launches_b["rmsnorm"]}
    del sched_b, eng
    torch.cuda.empty_cache()

    # where a decode step's time goes: one full-width decode_step at the
    # kernel-timing shapes (B = 8, contexts 512-2048, random KV) as one
    # graph replay, and eagerly, timed like the kernels, against its 24
    # decode-kernel launches
    from repro_torch.models import transformer as T
    from repro_torch.serving.programs import CapturedProgram
    shape = (cfg.num_layers, 1, dcase["k_pages"].shape[0], 16,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    step_cache = {"layers": {n: torch.randn(shape, dtype=torch.bfloat16,
                                            device=dev) for n in "kv"}}
    step_in = {"tokens": torch.zeros((8, 1), dtype=torch.int32, device=dev),
               "positions": (dcase["lengths"] - 1).to(torch.int32),
               "block_tables": dcase["block_tables"]}
    step = CapturedProgram("decode_step", lambda **b: T.decode_step(
        params, cfg, dict(b, cache=step_cache))[0], step_in)
    step.replay()
    step_ms = time_ms(torch, step.replay, flush, reps=20)
    eager_ms = time_ms(torch, lambda: T.decode_step(
        params, cfg, dict(step_in, cache=step_cache)), flush, reps=10)
    attn_ms = cfg.num_layers * by_name["paged_decode_attention"]["ms"]
    print(f"decode step, B=8, contexts 512-2048, full width: graph replay "
          f"{step_ms:.3f} ms (capture {step.capture_s:.2f} s), eager "
          f"{eager_ms:.3f} ms; {cfg.num_layers} decode-kernel launches "
          f"{attn_ms:.3f} ms ({attn_ms / step_ms:.1%} of the replay)",
          flush=True)
    # serving-like steps: tokens and positions from the host, the replay,
    # a greedy sample back to the host (the step's one sync)
    rs = np.random.default_rng(4)

    def serve_step():
        step.feed(tokens=rs.integers(0, cfg.vocab_size, (8, 1),
                                     dtype=np.int32))
        torch.argmax(step.replay()[:, 0], dim=-1).cpu()

    for _ in range(3):
        serve_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        serve_step()
    served_ms = (time.perf_counter() - t0) * 1e3 / 20
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            serve_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    br = profile_breakdown(prof, wall_ms)
    n_kernels = sum(e.count for e in prof.key_averages() if str(getattr(
        e, "device_type", "")).endswith("CUDA")) / 5
    decode_profile = {"step_ms": served_ms,
                      "kernels_per_step": n_kernels,
                      "kernel_ms_per_step": br["kernel_ms"] / 5,
                      "busy_share": br["kernel_ms"] / 5 / served_ms,
                      "profiled_step_ms": wall_ms / 5,
                      "profiled_busy_share": br["busy_share"],
                      "top": br["top"][:6]}
    print("decode step as served (B = 8; step ms the mean of 20 steps, "
          "kernels from 5 more under torch.profiler; busy share = kernel "
          "ms / step ms): " + json.dumps(decode_profile), flush=True)
    check(n_kernels > 0, "the profiler saw no kernel of a replayed step")
    del step, step_cache, step_in, flush, prof
    torch.cuda.empty_cache()

    # 6. dense-mode serving with the int8 KV cache -------------------------
    phase("serving qwen2-0.5b, full width, dense, int8 KV")
    cfg8 = cfg.with_(kv_cache_dtype="int8")
    rs = np.random.default_rng(3)
    shared = rs.integers(0, cfg.vocab_size, 32, dtype=np.int32)
    dense_prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, int(rs.integers(16, 97)), dtype=np.int32)])
        for _ in range(12)]
    dense_kw = dict(paged=False, max_slots=8, max_seq_len=1024,
                    prefill_chunk=16, prefix_cache_blocks=64, device=dev)
    dense = {}
    for label, c, prompts_ in (("int8", cfg8, dense_prompts),
                               ("bf16", cfg, dense_prompts[:4])):
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ServingEngine(c, params, **dense_kw)
        sched_d = Scheduler(eng, profile=True)
        zero_counts(counters)
        rids = [sched_d.submit(Request(p, SamplingParams(
            max_new_tokens=32, greedy=True))) for p in prompts_]
        run_marking_warm(sched_d)
        torch.cuda.synchronize()
        launches_d = read_counts(counters)
        rep = report_serving(torch, sched_d, f"dense {label}", dev)
        outs = [sched_d.output(r) for r in rids]
        steps = eng.decode_steps + eng.prefill_tokens_executed
        print(f"dense {label}: prompts {[len(p) for p in prompts_]}; "
              f"kv_bytes {eng.kv.kv_bytes()}; decode_steps "
              f"{eng.decode_steps}, prefill_tokens_executed "
              f"{eng.prefill_tokens_executed}; kernel launches "
              f"{launches_d}", flush=True)
        check(all(len(o) == 32 for o in outs),
              f"dense {label}: not every request completed")
        check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
              f"dense {label}: token ids out of range")
        check(rep["prefix_hit_rate"] > 0, f"dense {label}: no prefix hit")
        want = cfg.num_layers * steps if label == "int8" else 0
        check(launches_d["flash_attention_int8kv"] == want,
              f"dense {label}: {launches_d['flash_attention_int8kv']} int8 "
              f"kernel launches, want {want} = {cfg.num_layers} x "
              f"(decode steps + prefill tokens executed)")
        check(all(launches_d[k] == 0 for k in (
            "paged_decode_attention", "paged_prefill_attention",
            "flash_attention")),
            f"dense {label}: another attention kernel was launched")
        want_rms = (2 * cfg.num_layers + 1) * steps
        check(launches_d["rmsnorm"] == launches_d["rmsnorm_one_pass"]
              == want_rms, f"dense {label}: {launches_d['rmsnorm']} RMSNorm "
              f"launches, want {want_rms}, all one pass")
        check_no_leaks(sched_d, f"dense {label}")
        check(eng.recompiles.warm,
              f"dense {label}: the engine never held both programs")
        check_programs(eng, f"dense {label}", "prefill_chunk",
                       eng.prefill_chunk)
        dense[label] = dict(rep, kv_bytes=eng.kv.kv_bytes(),
                            launches=launches_d["flash_attention_int8kv"],
                            decode_steps=eng.decode_steps,
                            prefill_tokens_executed=(
                                eng.prefill_tokens_executed),
                            rmsnorm=launches_d["rmsnorm"])
        del sched_d, eng
        torch.cuda.empty_cache()
    ratio = dense["int8"]["kv_bytes"] / dense["bf16"]["kv_bytes"]
    D = cfg.resolved_head_dim
    print(f"dense int8 / bf16 KV bytes {ratio:.4f} (expected (2D + 4) / "
          f"(4D) = {(2 * D + 4) / (4 * D):.4f}); tokens/s int8 (12 "
          f"requests) {dense['int8']['tokens_per_s']:.1f}, bf16 (first 4) "
          f"{dense['bf16']['tokens_per_s']:.1f}", flush=True)
    check(abs(ratio - (2 * D + 4) / (4 * D)) < 1e-9,
          "int8 / bf16 KV bytes off the layout's ratio")
    by_name["flash_attention_int8kv"]["launches"] = dense["int8"]["launches"]
    by_name["flash_attention_int8kv"]["launches_per_path"] = {
        "dense serving qwen2-0.5b": dense["int8"]["launches"]}
    by_name["flash_attention_int8kv"]["launches_per_step"] = (
        dense["int8"]["launches"] / (dense["int8"]["decode_steps"]
                                     + dense["int8"]["prefill_tokens_executed"]))
    # the launches split by part of the path (the count above is exact, so
    # 24 a step splits it): prompt tokens replayed at B = 1, decode steps
    by_name["flash_attention_int8kv"]["launches_per_part"] = {
        "prefill replay, B = 1": cfg.num_layers
        * dense["int8"]["prefill_tokens_executed"],
        "decode": cfg.num_layers * dense["int8"]["decode_steps"]}
    rms_paths["dense serving"] = (dense["int8"]["rmsnorm"]
                                  + dense["bf16"]["rmsnorm"])

    # 7. card vs CPU --------------------------------------------------------
    phase("card vs CPU")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 48,
                                               dtype=np.int32)
    # the paged engine (4 tokens through generate), then the dense int8
    # engine (8 decoded in the prompt's slot: the card's int8 kernel
    # against the CPU's plain version under the whole model); the CPU
    # halves run beside the next phases
    host = shared_cpu(torch, params)
    for label, c, new, generate, kw in (
            ("qwen2-0.5b paged", cfg, 4, True,
             dict(paged=True, prefill_batch=1)),
            ("qwen2-0.5b dense int8", cfg8, 8, False, dict(paged=False))):
        lg, tg, _ = engine_greedy(torch, dev, c, params, prompt, new=new,
                                  generate=generate, engine_kw=kw)
        CPU_SIDE.submit(label, "engine_greedy", engine_pair(
            label, lg, tg, (cfg.vocab_size,)), cfg=c, params=host,
            prompt=prompt, new=new, generate=generate, engine_kw=kw)
    del host
    # a replayed decode round against the same round run eagerly, paged
    # (8 slots, 4 holding prompts of 48-400 tokens) and dense int8
    rs = np.random.default_rng(5)
    lens = (48, 400, 131, 256)
    replay_check = {}
    for label, c, paged in (("paged", cfg, True), ("dense int8", cfg8,
                                                   False)):
        e = ServingEngine(c, params, max_seq_len=512, max_slots=8,
                          paged=paged, prefill_batch=4, device=dev)
        ps = [rs.integers(0, cfg.vocab_size, n, dtype=np.int32)
              for n in lens]
        tokens = np.zeros(8, np.int32)
        positions = np.zeros(8, np.int32)
        for p, (slot, last) in zip(ps, e.prefill_into_slots(ps)):
            tokens[slot] = int(np.argmax(last))
            positions[slot] = len(p)
            e.kv.ensure_capacity(slot, len(p) + 1)
        e.decode_once(tokens, positions)          # capture, then replay
        replay_check[label] = eager_vs_replay(torch, T, e, tokens,
                                              positions)
        check(e.programs["decode_step"].captures == 1,
              f"{label}: decode captured again")
        del e
    print(f"replayed vs eager decode round, max |diff|: "
          f"{json.dumps(replay_check)}", flush=True)
    check(all(d == 0.0 for d in replay_check.values()),
          "a replayed decode round differs from the eager one")
    del params
    torch.cuda.empty_cache()

    # 8. training at full width ---------------------------------------------
    phase("training qwen2-0.5b, full width")
    from repro_torch.launch import train as train_launcher
    zero_counts(counters)
    run = train_launcher.main(["--arch", "qwen2-0.5b", "--seq-len", "1024",
                               "--global-batch", "8", "--steps", "8",
                               "--strategy", "dp"])
    del run["params"]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    losses = run["losses"]
    per_step = run["launches_per_step"]
    summary = {k: run[k] for k in ("losses", "step_s", "tokens_per_s",
                                   "launches_per_step",
                                   "collectives_per_step",
                                   "max_memory_allocated")}
    qwen2_bare = summary
    print("training: " + json.dumps(summary), flush=True)
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall over 8 steps")
    for name in ("flash_attention", "rmsnorm"):
        check(launches[name] > 0 and sum(per_step[name]) == launches[name],
              f"{name} was never launched in training")
    # remat: every layer's attention and norms run in the forward and again
    # in the backward's recompute; the final norm once
    check(all(n == 2 * cfg.num_layers for n in per_step["flash_attention"]),
          f"flash launches per step {per_step['flash_attention']}, want "
          f"{2 * cfg.num_layers}")
    want_rms = 2 * 2 * cfg.num_layers + 1
    check(all(n == want_rms for n in per_step["rmsnorm"]),
          f"rmsnorm launches per step {per_step['rmsnorm']}, want {want_rms}")
    # every flash launch of the run went to the tensor-core kernel
    print(f"training flash launches: {launches['flash_attention']}, tensor "
          f"cores {launches['flash_attention_tensor_core']}, CUDA cores "
          f"{launches['flash_attention_cuda_core']}", flush=True)
    check(launches["flash_attention_tensor_core"]
          == launches["flash_attention"]
          and launches["flash_attention_cuda_core"] == 0,
          "a training flash launch missed the tensor-core kernel")
    check(launches["rmsnorm_one_pass"] == launches["rmsnorm"],
          "a qwen2 training norm missed the one-pass kernel")
    by_name["flash_attention"]["launches"] = launches["flash_attention"]
    by_name["flash_attention"]["launches_per_path"] = {
        "training qwen2-0.5b": launches["flash_attention"]}
    rms_paths["training qwen2-0.5b"] = launches["rmsnorm"]

    # where one training step's device time goes (torch.profiler)
    prof_out = profile_train_step(torch, cfg, dev)
    print("train step profile: " + json.dumps(prof_out), flush=True)
    torch.cuda.empty_cache()

    # 9. training, card vs CPU ----------------------------------------------
    phase("training card vs CPU")
    train_card_vs_cpu(torch, cfg.with_(num_layers=2), seq=128, batch=2,
                      dev=dev)
    torch.cuda.empty_cache()

    # 10. training mamba2-1.3b at full width ---------------------------------
    phase("training mamba2-1.3b, full width")
    mcfg = get_config("mamba2-1.3b")
    zero_counts(counters)
    run = train_launcher.main(["--arch", "mamba2-1.3b", "--seq-len", "1024",
                               "--global-batch", "8", "--steps",
                               str(RECURRENT_TRAIN_STEPS), "--strategy",
                               "dp"])
    del run["params"]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    losses = run["losses"]
    per_step = run["launches_per_step"]
    summary = {k: run[k] for k in ("losses", "step_s", "tokens_per_s",
                                   "launches_per_step",
                                   "collectives_per_step",
                                   "max_memory_allocated")}
    print("training mamba2: " + json.dumps(summary), flush=True)
    check(all(np.isfinite(losses)), "a mamba2 training loss is not finite")
    check(losses[-1] < losses[0], "the mamba2 loss did not fall")
    for name in ("ssd_scan", "rmsnorm"):
        check(launches[name] > 0 and sum(per_step[name]) == launches[name],
              f"{name} was never launched in mamba2 training")
    # remat per layer: the scan runs in the forward and in the backward's
    # recompute (its backward is the plain version's VJP: no launch); two
    # norms per layer, both twice, plus the final norm
    want_ssd = 2 * mcfg.num_layers
    want_rms = 2 * 2 * mcfg.num_layers + 1
    check(all(n == want_ssd for n in per_step["ssd_scan"]),
          f"SSD launches per step {per_step['ssd_scan']}, want {want_ssd}")
    check(all(n == want_rms for n in per_step["rmsnorm"]),
          f"rmsnorm launches per step {per_step['rmsnorm']}, want {want_rms}")
    check(launches["flash_attention"] == 0, "flash launched in mamba2")
    # every scan of every step on the tensor-core route, every norm one pass
    print(f"mamba2 SSD scans: {launches['ssd_scan']}, tensor cores "
          f"{launches['ssd_tensor_core']}, CUDA cores "
          f"{launches['ssd_cuda_core']}; rmsnorm one pass "
          f"{launches['rmsnorm_one_pass']} of {launches['rmsnorm']}",
          flush=True)
    check(launches["ssd_tensor_core"] == launches["ssd_scan"]
          and launches["ssd_cuda_core"] == 0,
          "a mamba2 SSD scan missed the tensor-core route")
    check(launches["rmsnorm_one_pass"] == launches["rmsnorm"],
          "a mamba2 norm missed the one-pass kernel")
    by_name["ssd_scan"]["launches"] = launches["ssd_scan"]
    by_name["ssd_scan"]["launches_per_path"] = {
        "training mamba2-1.3b": launches["ssd_scan"]}
    by_name["rmsnorm"]["launches"] = launches["rmsnorm"]
    rms_paths["training mamba2-1.3b"] = launches["rmsnorm"]
    by_name["rmsnorm"]["launches_per_path"] = rms_paths
    print(f"rmsnorm launches by path {rms_paths}", flush=True)
    del run
    torch.cuda.empty_cache()
    prof_out = profile_train_step(torch, mcfg, dev)
    print("mamba2 train step profile: " + json.dumps(prof_out), flush=True)
    torch.cuda.empty_cache()

    # 11. mamba2 training, card vs CPU --------------------------------------
    phase("mamba2 training card vs CPU")
    train_card_vs_cpu(torch, mcfg.with_(num_layers=2), seq=512,
                      batch=RECURRENT_CPU_BATCH, dev=dev)
    torch.cuda.empty_cache()

    # 12. training zamba2-1.2b at full width ---------------------------------
    phase("training zamba2-1.2b, full width")
    zcfg = get_config("zamba2-1.2b")
    E, G = zcfg.hybrid_attn_every, zcfg.num_layers // zcfg.hybrid_attn_every
    zero_counts(counters)
    run = train_launcher.main(["--arch", "zamba2-1.2b", "--seq-len", "1024",
                               "--global-batch", "8", "--steps",
                               str(RECURRENT_TRAIN_STEPS), "--strategy",
                               "dp"])
    del run["params"]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    losses = run["losses"]
    per_step = run["launches_per_step"]
    summary = {k: run[k] for k in ("losses", "step_s", "tokens_per_s",
                                   "launches_per_step",
                                   "collectives_per_step",
                                   "max_memory_allocated")}
    print("training zamba2: " + json.dumps(summary), flush=True)
    check(all(np.isfinite(losses)), "a zamba2 training loss is not finite")
    check(losses[-1] < losses[0], "the zamba2 loss did not fall")
    for name in ("flash_attention", "ssd_scan", "rmsnorm"):
        check(launches[name] > 0 and sum(per_step[name]) == launches[name],
              f"{name} was never launched in zamba2 training")
    # remat per mamba layer and per application of the shared block: each
    # runs in the forward and again in the backward's recompute; a mamba
    # layer has two norms (its pre-norm and the gated norm), the shared
    # block two, and the final norm runs once
    want = {"flash_attention": 2 * G, "ssd_scan": 2 * zcfg.num_layers,
            "rmsnorm": 2 * (2 * zcfg.num_layers + 2 * G) + 1}
    for name, n in want.items():
        check(all(k == n for k in per_step[name]),
              f"zamba2 {name} launches per step {per_step[name]}, want {n}")
    print(f"zamba2 flash launches {launches['flash_attention']} (tensor "
          f"cores {launches['flash_attention_tensor_core']}), SSD scans "
          f"{launches['ssd_scan']} (tensor cores "
          f"{launches['ssd_tensor_core']}), rmsnorm one pass "
          f"{launches['rmsnorm_one_pass']} of {launches['rmsnorm']}",
          flush=True)
    check(launches["flash_attention_tensor_core"]
          == launches["flash_attention"],
          "a zamba2 flash launch missed the tensor-core kernel")
    check(launches["ssd_tensor_core"] == launches["ssd_scan"]
          and launches["ssd_cuda_core"] == 0,
          "a zamba2 SSD scan missed the tensor-core route")
    check(launches["rmsnorm_one_pass"] == launches["rmsnorm"],
          "a zamba2 norm missed the one-pass kernel")
    for name in ("flash_attention", "ssd_scan", "rmsnorm"):
        k = by_name[name]
        k["launches_per_path"]["training zamba2-1.2b"] = launches[name]
        k["launches"] = sum(k["launches_per_path"].values())
    del run
    torch.cuda.empty_cache()
    prof_out = profile_train_step(torch, zcfg, dev)
    print("zamba2 train step profile: " + json.dumps(prof_out), flush=True)
    torch.cuda.empty_cache()

    # 13. zamba2 training, card vs CPU --------------------------------------
    phase("zamba2 training card vs CPU")
    # one group of six mamba layers and the shared block, then a tail of
    # two; seq 512 (two chunks: the state carries)
    train_card_vs_cpu(torch, zcfg.with_(num_layers=8), seq=512,
                      batch=RECURRENT_CPU_BATCH, dev=dev)
    torch.cuda.empty_cache()

    # 14. dense serving of the ssm and hybrid families ------------------------
    phase("serving mamba2-1.3b and zamba2-1.2b, full width, dense")
    rec = serve_recurrent(torch, T, dev, counters, by_name, rms_paths)
    print("recurrent serving: " + json.dumps(rec), flush=True)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())

    # 15. the 3DGAN trained with Horovod-style DP ---------------------------
    phase("3dgan training, full width, Horovod DP")
    gan_phase(torch, dev)

    # 16. the paper's deployment path on the card ----------------------------
    phase("deployment on the card: the PyTorch capsule")
    deploy_phase(torch, counters, by_name, rms_paths, qwen2_bare)

    # 17. the serving fleet -------------------------------------------------
    phase("the serving fleet: gateway, failover, fabric, qwen2-0.5b")
    t17 = time.perf_counter()
    fleet = fleet_phase(torch, dev, counters, by_name, rms_paths)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())
    print(f"fleet phase {time.perf_counter() - t17:.1f} s: "
          + json.dumps(fleet), flush=True)

    # 18. MoE serving at full width ----------------------------------------
    phase("serving qwen3-moe-30b-a3b, full width, paged and dense int8")
    t18 = time.perf_counter()
    moe = moe_phase(torch, T, dev, counters, by_name, rms_paths)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())
    print(f"moe phase {time.perf_counter() - t18:.1f} s: " + json.dumps(moe),
          flush=True)

    # 19. qwen2-vl-72b at full width -----------------------------------------
    phase("qwen2-vl-72b, full width: training, paged serving, card vs CPU")
    t19 = time.perf_counter()
    vlm = vlm_phase(torch, T, dev, counters, by_name, rms_paths)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())
    print(f"vlm phase {time.perf_counter() - t19:.1f} s: " + json.dumps(vlm),
          flush=True)

    # 20. whisper-small whole --------------------------------------------------
    phase("whisper-small: training, dense serving bf16 and int8, card vs CPU")
    t20 = time.perf_counter()
    whisper = whisper_phase(torch, T, dev, counters, by_name, rms_paths)
    print(f"whisper phase {time.perf_counter() - t20:.1f} s: "
          + json.dumps(whisper), flush=True)

    # 21. sharded training ---------------------------------------------------
    phase("sharded training: gemma2-27b, deepseek-coder-33b, qwen3-moe at "
          "full width (fsdp_tp), the D 160 route, card vs CPU, (1, 1)")
    t21 = time.perf_counter()
    sharded = sharded_phase(torch, F, T, dev, counters, by_name, rms_paths,
                            qwen2_bare)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())
    print(f"sharded phase {time.perf_counter() - t21:.1f} s: "
          + json.dumps(sharded), flush=True)

    # 22. the steps by input shape -----------------------------------------
    phase("the steps by input shape: qwen2-0.5b decode_32k (bf16, int8), "
          "long_500k, prefill_32k, train_4k; deepseek-coder-33b long_500k; "
          "the window; card vs CPU; the dry-run against the card")
    t22 = time.perf_counter()
    steps = step_phase(torch, T, dev, counters, by_name, rms_paths)
    print(f"step phase {time.perf_counter() - t22:.1f} s: "
          + json.dumps(steps), flush=True)

    # 23. the chunked loss sharded, remat_policy, the examples -------------
    phase("the chunked cross-entropy under fsdp_tp / dp_tp, remat_policy "
          "\"dots\", the three examples")
    t23 = time.perf_counter()
    chunked = chunked_phase(torch, T, dev, counters, by_name, rms_paths)
    print(f"chunked phase {time.perf_counter() - t23:.1f} s: "
          + json.dumps(chunked), flush=True)

    # 24. gemma2-2b at full width -----------------------------------------
    phase("gemma2-2b, full width: training, flash at D 288, paged and dense "
          "serving, card vs CPU")
    t24 = time.perf_counter()
    gemma2 = gemma2_phase(torch, F, T, dev, counters, by_name, rms_paths)
    by_name["rmsnorm"]["launches"] = sum(rms_paths.values())
    print(f"gemma2 phase {time.perf_counter() - t24:.1f} s: "
          + json.dumps(gemma2), flush=True)

    # the D tail's launches over every path run (each zeroed just before
    # it): gemma2-27b's training in phase 21 (a)
    tail = by_name["flash_attention_d_tail"]
    tail["launches"] = sum(c["flash_attention_d_tail"] for c in PATH_COUNTS)
    tail["path_runs"] = len(PATH_COUNTS)
    print(f"flash D-tail launches over {len(PATH_COUNTS)} path runs: "
          f"{tail['launches']}", flush=True)
    check(tail["launches"] > 0, "the flash D tail never ran on a path")

    # the tied unembedding on the tensor cores (bf16 x on the card): the
    # backward's split kernel over every path run, beside the Function's
    # calls (forwards and backwards; its products are torch.mm's)
    split = by_name["unembed_split"]
    split["launches"] = sum(c["unembed_split"] for c in PATH_COUNTS)
    split["unembed_calls"] = sum(c["unembed_tensor_core"]
                                 for c in PATH_COUNTS)
    split["path_runs"] = len(PATH_COUNTS)
    print(f"unembedding on the tensor cores over {len(PATH_COUNTS)} path "
          f"runs: {split['unembed_calls']} forwards and backwards, "
          f"{split['launches']} split launches", flush=True)
    check(split["unembed_calls"] > 0,
          "the tied unembedding never took the tensor cores on a path")
    check(split["launches"] > 0, "the unembedding's split never ran")

    # the CPU halves of the card-against-CPU checks still open
    CPU_SIDE.close()
    print(f"card vs CPU, the CPU halves beside the phases (the last waited "
          f"for {CPU_SIDE.waited_s:.1f} s): " + json.dumps(CPU_SIDE.report),
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
