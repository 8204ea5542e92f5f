#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package (`src/repro`), and it has no CPU path: without CUDA, or outside a
checkout, it exits non-zero and prints no result.  Phases:

  1. device: the card's name and power limit, and its UUID and serial
     (nvidia-smi: which card a run's times come from), then every
     kernel of the port built from the sources in the checkout (one nvcc
     per source, all at once), each build's ptxas report (registers,
     spills);
  2. K1 (`kernels/compact_fused.py::fused_update`, the CUDA kernel) against
     its plain PyTorch version on the card, f32 and bf16 carries, at (a)
     the main path's shapes with operands from a real step, (b) n=256,
     K=256, Pc_pad=20864, B=4 with ragged counts, (c) edge cases (a full
     example, a one-row example, count_prev = 0); dead rows must be exactly
     zero.  Times at (a) and (b): kernel, plain version, the bound, and as
     `library_ms` a torch.baddbmm on pre-gathered tiles (a partial
     yardstick the port never calls), each by time_ms; besides, the kernel
     and the yardstick timed in turn (the median of 5 rounds), the device
     µs of both (profiler), at (a) the wrapper's host µs and its parts,
     and the kernel's launch shape (grid, threads, shared bytes,
     registers, spills, CTAs an SM);
  3. K2 (`kernels/influence.py::influence_update`, the CUDA kernel) against
     its plain version, at (a) the pallas main path's shapes with operands
     from a real step, full width (P_pad=1024) and column-compact
     (Pc_pad=256), (b) n=256, P=20864, B=4 with all four block skips in
     play, (c) edge cases (padding, a dead example, M all zero, no masks).
     Dead row and column blocks must be exactly zero, and the kernel's
     executed-block counter must equal `realized_block_savings` times the
     block count.  Times at (a) and (b): kernel, plain version, the bound,
     and as `library_ms` torch.baddbmm(M-bar, J-hat, M) with TF32 off, each
     by time_ms (one window of back-to-back calls); besides, the kernel and
     the library call timed in turn (the median of 5 rounds); the device µs
     of both from a torch.profiler trace; at (a) the wrapper's host µs and
     where they go (checks, allocation, stream, the ctypes call, the rest);
     the launch floor, an empty kernel through the same ctypes route, timed
     by time_ms; the host µs parts include the autograd check that every
     wrapper makes before its launch;
  4. the main paths: `repro_torch.launch.train --arch egru-spiral --online
     --rtrl-backend B --sparsity 0.8 --update-every 8 --steps 20
     --ckpt-every 0` on the card, in-process, for B = compact_fused (K1
     launches counted), pallas (K2 launches counted), dense and compact,
     each with every kernel's count set to 0 just before and read just
     after; then the first
     window's loss and gradients of every backend on the card, of pallas
     and compact on the CPU and of the BPTT oracle on the card must agree;
     then a torch.profiler trace of two more windows of compact_fused and
     of pallas (device busy share, launches per step);
  5. checkpoint, restart and the offline path, under a temporary directory
     that is removed at the end, every run with the counts set to 0 just
     before and read just after: (r1) the main path with compact_fused and
     `--ckpt-every 5 --fail-at 7`, and the same run without the crash:
     restarts 1 and 0, 160 stream steps each, K1 launches 176 (two windows
     replayed) and 160, the windows after the resume equal to the uncrashed
     run's and the final checkpoints, loaded through the port's
     load_checkpoint, bitwise on every leaf but the RNG key data; the same
     with a bf16 carry (the vals leaf on disk as its uint16 bits); (r2) the
     same with pallas and K2; (r3) the window after update 10 from the
     card's checkpoint on the CPU and on the card, and from a CPU run's
     checkpoint on the card and on the CPU, within 1e-5 (loss and
     gradients); (r4) the offline path (`--steps 20`, no --online) with
     compact_fused and pallas, crashed and uncrashed: 17 launches a step
     (340 uncrashed), final checkpoints bitwise, and the first step's loss
     and gradients against the offline compact backend's within 1e-5; then
     the bytes of a checkpoint and the ms of one save() and one restore,
     and the median offline step ms per backend;
  6. K3 (`kernels/event_matmul.py::event_matmul`, the CUDA kernel) against
     its plain version, f32 and bf16, at (a) the spiral main path's a_prev
     [32, 16] and the u gate's masked R [16, 16] from a real step, (b) B=32,
     n=256, m=768 with activity and parameter blocks at block density 0.5,
     (c) the shape (1, 40, 130) and an all-zero a; its executed-block
     counter against the host count; times at (a) and (b) beside the bound
     and `torch.matmul` in the same dtype (by time_ms, and in turn, as
     K2's), device
     µs of both (profiler) and the wrapper's host µs as for K2; then its
     entry point `kernels.ops.event_matmul`
     driven over the main path's first window (3 gates x 8 steps, counts
     reset before and read after), held against the dense a_prev @ R
     (no engine calls K3, as in the reference);
  7. RWKV6-3B serving at full width and depth (32 layers, d 2560, 40 x 64
     heads, d_ff 8960, vocab 65536, bf16, ~3.1 B parameters drawn on the
     card from a seeded generator): the main path with every count reset
     before and read after — `models.rwkv.prefill` of 4 prompts x 2048
     tokens (K4 launches = 32, finite logits), 16 greedy `decode_step`s from
     its cache, and `repro_torch.launch.serve.main(["--arch", "rwkv6-3b",
     "--requests", "6", "--max-new", "12", "--metrics-dir", D4])` (every
     request completes; (t4): D4 clean under the validator, its manifest's
     tokens the summary's);
     then prefill tokens/s, decode ms a step, profiler traces of a prefill
     and a decode step; every layer's bf16 time-mix output with the kernel
     and with the plain WKV on the same layer input, within 5 % of its
     largest magnitude (per layer, so no bf16 round-off builds up across
     layers); the prefill in f32 compute at full depth with the kernel and
     with the plain WKV, within 1e-4 of the largest logit; K4
     (`kernels/wkv.py::wkv`, the CUDA kernel) against its plain version on
     (a) layer 0's operands of that prefill (bf16 r/k/v), (b) the same from
     a non-zero S0, (c) T == L, T < L, and decays at both clip ends, o and
     S_final; K4's time beside its bound and its launch shape (grid,
     threads, shared bytes, registers, CTAs an SM); and at full width, 2
     layers, f32: prefill with the kernel vs the plain WKV and vs a
     teacher-forced decode over 64 tokens, each within 1e-4 of the largest
     logit;
  8. the stacked engine (`--layers L`, one K1 or K2 launch a layer a stream
     step), every run with the counts set to 0 just before and read just
     after: (s1) `--layers 2 --online --sparsity 0.8 --ckpt-every 0`, 20
     updates, with every backend and with compact_fused on a bf16 carry:
     K1 320 launches (compact_fused), K2 320 (pallas), overflow 0, finite
     losses, each first window's loss within the f32 bar of compact's (bf16
     one bf16 step); the first window's loss and gradients of compact_fused
     and pallas within 1e-5 of the stacked BPTT oracle and of the jacrev
     RTRL oracle, both run on the card, on surviving parameters; (s2)
     `--layers 3` compact_fused: K1 480 launches, and the same oracle
     check; (s3) K1 against its plain version at layer 1's operands of a
     `--layers 2` step (its M-bar rows carrying the cross term), f32 and
     bf16, and at layer 0's; K2 at layer 1's and layer 0's operands, its
     executed-block counter equal to realized_block_savings times the
     block count, layer 0 skipping the column blocks of layer 1's columns;
     K1's and K2's times there as in phases 2 and 3; (s4) crash and resume
     at `--layers 2`: online compact_fused and pallas (352 / 320
     launches), offline compact_fused (`--steps 20`, 748 / 680), final
     checkpoints bitwise, and the offline first step against offline
     compact; (s5) the median window per backend, traces of the
     compact_fused and pallas windows (device ops a stream step, idle
     share, K1 and K2 µs a launch) and `costs.stacked_influence_update_flops`
     at the first window's measured beta;
  9. dynamic sparsity and the stream guard, every run with the counts set
     to 0 just before and read just after: (d1) `--rtrl-backend pallas
     --rewire rigl --rewire-every 2 --rewire-frac 0.3` (20 updates): K2 160
     launches, 10 events, every W/R tensor's live count and Pc (244) kept
     at every event, finite losses; at the first step after each event the
     learner's K2 block masks equal those of the new masks and K2's
     executed-block counter equals realized_block_savings of the new masks
     times the blocks; from the carry right after event 0 one window within
     1e-5 of the dense restart oracle (`sparsity.migrate.restart_oracle`)
     on the card; the same with `--rewire set` and with `--col-compact off`
     (P_pad 1024); (d2) the same at `--layers 2` (K2 320); (d3) `--rewire
     rigl --rewire-every 3 --ckpt-every 5 --fail-at 7`, crashed and
     uncrashed: restarts 1 / 0, K2 176 / 160, 6 events each, final
     checkpoints (masks and layout included) bitwise; (d4) `--rtrl-backend
     compact_fused --rewire rigl` exits before any launch; (g1) `--guard`
     with compact_fused: K1 160, every window's loss and the final params
     bitwise the unguarded run's; (g2) `--guard --inject-corrupt-at 6`: one
     fault, one rollback, K1 168, losses and final params bitwise (g1)'s;
     (g3) `--guard --inject-nan-at 40 --inject-nan-len 8`: the ladder
     replay -> clip -> skip_update -> quarantine on window 5, K1 184,
     finite after it; (g4) `--guard --rewire rigl --rewire-every 2
     --inject-corrupt-at 5` with pallas: the masks at all 10 events and the
     final params bitwise the clean run's (K2 168 / 160); (c) the costs:
     median windows guarded and unguarded in turn, the device ops a stream
     step the guard adds (traces), rewire_ms split into scoring, host
     selection, migration and the block-mask rebuild, the µs of a snapshot
     push, carry_live_bytes before and after the events, and K2 (at event
     0's operands) and K1 (on (g2)'s replayed carry) against their plain
     versions and timed;
 10. the telemetry plane (`repro_torch.obs`), every run with the counts
     set to 0 just before and read just after, its metrics directories
     under a temporary root that is removed at the end: (t1) the main path
     with compact_fused and `--metrics-dir D --trace` against the same run
     without: K1 160 in both, every window's loss and the final params
     bitwise, `repro_torch.obs.validate` clean, 20 `window` events with
     every packed field of the engine, 20 `window` spans in trace.json;
     (t2) the same with pallas and `--rewire rigl --rewire-every 2`: K2
     160, 10 `rewire` events, `live_col_frac` finite (and the event's
     column density) after every event; (t3) `--guard --inject-corrupt-at
     6 --metrics-dir`: one fault, one rollback, one recovery, the registry
     counters equal to report(), K1 168, losses and final params bitwise
     phase 9's (g2); (t4), in phase 7: `launch.serve --metrics-dir` clean
     under the validator; (c) the costs: the median window with and
     without telemetry, 4 runs each in turn (`TELEMETRY_ROUNDS`; 12
     through PR 29), the device ops a stream step
     the pack adds and the device-to-host copies a window (traces), the K1
     launches in each `window` record_function span of the profiler trace,
     and the peak bytes, ms and device ops of the guard's health check and
     clip norm on the main path's carry, held as a regression guard (no
     copy of the tree; at most 16 and 8 device ops);
 11. the stream fleet (`repro_torch.runtime.fleet`), every run with the
     counts set to 0 just before and read just after: (f1) `launch.serve
     --fleet` at its defaults (n 96, batch 8 a session, sparsity 0.9,
     backend compact; 6 sessions, 4 slots, 12 windows each): every session
     completes, `fleet_windows` = the reference launcher's admission
     arithmetic (24); (f2) a compact_fused StreamFleet at that
     configuration, 4 slots, 12 windows with the live slots 4 -> 3 -> 4:
     K1 96 launches (8 a window whatever the live count); K1 called as the
     fleet calls it (vmapped, one launch, the slots folded into the
     examples) on the operands of a real fleet step against its plain
     version; three slots against the same sessions run alone through
     OnlineTrainer after 1 and 8 windows: bitwise, or within 1e-6 and 1e-5
     of each leaf's largest entry (printed: which held), and the first
     stage of a step and update where a slot parts from its solo run;
     (f3) the same with pallas and K2 (96 launches), its executed blocks on
     the folded call equal to the slots' realized_block_savings x blocks;
     (f4) bitwise on the card: a guest joining at window 2 and leaving at 5
     moves no bit of its neighbours, evict and resume into another slot
     ends where the never-evicted run ends, and a MetricPack fleet chunk's
     carry and optimizer state are the bare chunk's; (f5) the costs at
     the operating point of benchmarks/fleet_bench.py (n 16, n_in 8, one
     example a session, sparsity 0.9, k 8; compact_fused): for S = 1 and
     8 the fleet window against S solo windows stepped in turn with one
     readback each (median of 3 rounds in turn, `FLEET_ROUNDS`; 5
     through PR 29), sessions/s, device ops and idle share of a window
     from traces; S = 64 and 256 the fleet window alone (64 against its
     solo windows through PR 29: the script's time); (g) a 64-slot fleet's bytes and window peak against 64 x
     session_carry_bytes;
 12. the online token LM (`--arch {egru,rglru,snn}-lm --online` at the
     reference's defaults: width 64, vocab 64, batch 4, seq 64, k 8, lr
     3e-3, 20 updates), every run with the counts set to 0 just before and
     read just after, its checkpoints and metrics directories under a
     temporary root that is removed at the end: egru-lm with every
     backend at --sparsity 0.8 and pallas at 0 (K1 160 with compact_fused,
     K2 160 with pallas), rglru-lm at 0 and 0.5, snn-lm (no kernel), finite
     losses, overflow 0; (l1) K1 on the operands of a real egru-lm step
     (K, P, Pc, Pc_pad printed) against its plain version, dead rows 0;
     the first window of compact_fused, pallas and compact against dense
     and against the window BPTT oracle (a label a step, on the surviving
     parameters), and the card's compact_fused window against the CPU's;
     (l2) K2 on real steps' operands at --sparsity 0.8 (column-compact)
     and 0 (full width, P_pad 24,832): 0.0 against its plain version,
     executed blocks the host's; (l3) rglru-lm (0 and 0.5) within 1e-5 of
     its BPTT oracle, snn-lm's e-prop with cosine >= 0.9 on W and R (the
     readout within 1e-5), each against the CPU; (l4) crash and resume
     with `--ckpt-every 5 --fail-at 7` for egru-lm compact_fused (K1 176 /
     160) and rglru-lm 0.5, final checkpoints bitwise; (l5) `--metrics-dir
     --trace` on each arch: the validator clean, 20 `window` events with
     the engine's fields, losses bitwise the bare run's; (c) traces of
     egru-lm compact_fused and pallas and of rglru-lm (device ops a stream
     step, idle share, K1/K2 µs a launch), K1 at (l1)'s and K2 at (l2)'s
     operands timed as in phases 2 and 3, K1's launch shape there;
 13. the dense decoders and LM training, every launch with the counts set
     to 0 just before and read just after, K1-K4 0 in every run, the
     checkpoints under a temporary root removed at the end: (p1) gemma2-2b
     at full width and depth (2,614,341,888 parameters, bf16, drawn on the
     card), `transformer.prefill` of 4 x 2048 tokens with max_seq 2064
     and 16 greedy decode steps from its cache, `launch.serve.main([])`
     at its defaults and with `--arch qwen3-8b` (full size), every request
     completed; (p2) (a) the chunked flash attention against
     `flash_attention_ref` at gemma2's head shape (causal, and a window of
     1024 across chunk edges) and qwen3's (qk-normed), f32 and bf16; (b)
     gemma2-2b at full width, 2 layers, f32: prefill against the full
     forward and a 256-step teacher-forced decode, prefill of S then 16
     decode steps against the full forward over S + 16 at S 2048 and 8192
     (the local ring wraps), 1e-4 of the largest logit; (c) the same
     model's loss and gradients at B 1, S 32 (`CPU_S`; 64 through PR
     29), card against CPU (the
     gradients within 1e-5 or twice the CPU's own spread between one
     thread and its default, whichever is larger); (p3)
     `launch.train --arch gemma2-2b` and `--arch rwkv6-3b` as the launcher
     builds them, at full width and depth cut to 4 layers (10 steps,
     `CUT_STEPS`, 20 through PR 29; batch 4, seq 64, bf16): finite losses and gradient norms, K4 0 while
     training and 32 in a full-depth prefill after; rwkv6-
     3b at full width, 2 layers, f32, card against CPU; crash and resume
     (`--smoke --ckpt-every 5 --fail-at 7`) for both, final checkpoints
     bitwise; (p4) the costs: prefill tokens/s (CUDA events, best of 3
     after a warm run) and its achieved FLOP rate against the bf16 peak,
     decode ms a step (median of 16), the Engine's tok/s, median train
     step ms and peak allocation of both training runs, and traces of a
     prefill, a decode step and a train step (device ops, idle share,
     attention's and the GEMMs' share of device time);
 14. the MoE decoders and the Griffin RG-LRU LM, every launch with the
     counts set to 0 just before and read just after, K1-K4 0 in every
     run: (m1) olmoe-1b-7b at full size (6,919,100,416 parameters, bf16,
     drawn on the card), `transformer.prefill` of 4 x 2048 with max_seq
     2064 and 16 greedy decodes, `launch.serve.main(["--arch",
     "olmoe-1b-7b"])` with every request completed, kimi-k2-1t-a32b at
     full width and 1 of its 61 layers (19,395,138,560 parameters: 384
     experts, top-8), a prefill of 2 x 1024 and 4 decodes with finite
     logits; (m2) olmoe at full width, 2 layers, f32: prefill against the
     full forward, prefill then 16 decodes against the full forward over
     S + 16 at a capacity with no drop, 1e-4 of the largest logit; one
     block's dispatch against the dense oracle (1e-5); two dispatch
     forward+backward runs bitwise; loss and gradients card against CPU
     (as in phase 13); (m3) recurrentgemma-9b at full size
     (9,396,195,328 parameters), prefill 4 x 2048 and 16 decodes,
     `launch.serve.main(["--arch", "recurrentgemma-9b"])` at its 4 slots;
     (m4) recurrentgemma at full width, 5 layers (one unit and 2 rem
     layers), f32: prefill then 16 decodes against the full forward at S
     2048 and 4096 (the 2048-slot ring wraps), 1e-4; the scan against a
     sequential loop (1e-5); loss and gradients card against CPU ((m2)'s
     and (m4)'s on 1 x 32 tokens, `CPU_S`, (m4)'s on the model's one
     unit, the script's time); (m5) `launch.train`'s crash
     and resume (`--smoke --ckpt-every 5 --fail-at 7`) for both, final
     checkpoints bitwise (the full-width train step at cut depth, its ms
     and peak, is phase 20's one-rank reference); (c) the costs as in
     phase 13 (prefill tokens/s and its share of the bf16 peak, the MoE's
     counting only the active experts' FLOPs; decode ms a step; the
     Engine's tok/s) and traces of each model's prefill and decode step
     with the shares of kernel time in the MoE dispatch (its routing, and
     the experts' products inside it) and in the RG-LRU scan;
 15. the scaled sparse-RTRL engine (`core.scaled_rtrl`, the
     `ScaledLearner`) at the reference config's full width (n 1024, n_in
     128, n_out 8, batch 8, kind rnn, sparsity 0.9 in 8 x 8 blocks, eps
     0.3), every run with the counts set to 0 just before and read just
     after: (s1) capacity 1 (K 1024): `rtrl_grads` over 8 steps of N(0, 1)
     inputs with compact_fused (K1 8 launches) and compact, overflow 0 on
     every step, each against the card's BPTT on the surviving parameters
     (1e-5 of each leaf's largest entry, or twice the CPU's own 1- vs
     default-thread BPTT spread) and against each other; (s2) the default
     capacity 0.5 (K 512): each step's active rows, K_b and overflow, as
     they are; K1 against its plain version on a real step's operands (f32
     and bf16), its time against baddbmm on pre-gathered tiles (in turn
     too), device µs, the bound and its launch shape; (s3) an
     OnlineTrainer with masked adamw, k 8, 4 windows, compact_fused (K1
     32) and compact: the median window, peak allocation, carry bytes
     (allocated and live), device ops a stream step and idle share from a
     trace; (s4) L = 2: (s1)'s checks at n 512, capacity 1 (K1 16), and
     at n 1024, capacity 0.5 the reckoned peak, then (s3)'s measures over
     2 windows (K1 2 a stream step, 32); (s5) one RigL event on a
     rewirable compact scaled learner at n 256: the next 4 steps bitwise a
     fresh engine on the new masks with the migrated state, the event's
     ms;
 16. whisper-large-v3 (`models.encdec`), K1-K4 0 in every run: (w1) at
     full size (1,600,990,720 parameters, bf16, drawn on the card):
     encode 4 x 1500 frames, prefill 4 x 448 tokens with max_seq 464 and
     16 greedy decodes, every logit finite; (w2) full width, 2 encoder and
     2 decoder layers, f32: prefill against the full forward, prefill then
     16 decodes against the full forward over S + 16 (1e-4 of the largest
     logit), loss and gradients card against CPU (as in phase 13); (w3)
     `launch.train --arch whisper-large-v3` as the launcher builds it, full
     width, encoder and decoder cut to 4 of 32 layers (the script's time),
     10 steps (`CUT_STEPS`) of 4 x 64 tokens with 4 x 1500 frames
     (finite losses, median step ms, peak allocation), crash and resume at
     --smoke, final
     checkpoints bitwise; (c) prefill tokens/s and its share of the bf16
     peak (the encoder's and the decoder's FLOPs from the shapes), decode
     ms a step, and traces of a prefill and a decode step with
     attention's, the encoder's and the GEMMs' shares of kernel time;
 17. the shape suite's long-context cells at full size, bf16, weights
     drawn on the card, driven through `launch.steps.make_prefill_step` /
     `make_decode_step`, each run with the counts set to 0 just before
     and read just after, its dry-run record (`launch.dryrun_lib`, on the
     meta device, in a helper process started at phase 1: FLOPs, argument
     bytes, the reckoned peak) logged before it and
     `max_memory_allocated` after: (L1) rwkv6-3b `long_500k`: a prefill of
     524,256 tokens (16,383 chunks of 32), 32 greedy decodes to position
     524,287, K4 32 launches, every logit and state finite; prefill ms,
     tokens/s, the rate on the counted FLOPs, decode ms, and a trace of
     the prefill of the prompt's first 65,536 tokens (`L1_TRACE`; the
     whole prompt's through PR 29): K4's share of the kernel time, device
     ops, idle share;
     (L2) K4 on layer 0's operands of that prefill against its plain
     version (1e-5 of the largest magnitude; the errors at T 2,048 and
     65,536 beside it; the plain version's chunk replayed as a CUDA graph,
     itself held to the eager plain version at T 2,048), its ms a launch
     (CUDA events, 3 launches), its bound and its grid against the card's
     SMs; (L3) the long-context
     check in f32 at full width: rwkv6-3b at 2 layers, a prefill of S - 32
     then 32 decodes against a prefill of S, and recurrentgemma-9b with
     one (rec, rec, attention) unit, a prefill of S - 512 then 512
     decodes against a prefill of S (the flash blocks need S - n a
     multiple of 512), 1e-4 of the largest logit, S the longest up to
     524,288 whose reckoned peak fits 72 GB (80 less room for the
     allocator's fragmentation); (L4) recurrentgemma-9b `long_500k`:
     (L1)'s measures on a prompt of the smaller of 65,536 tokens (the
     script's time, `L4_PROMPT`) and the longest whose reckoned peak fits
     72 GB, the trace on its first 8,192 tokens (`L4_TRACE`; 16,384
     through PR 29), K1-K4 0; (D) rwkv6-3b and
     recurrentgemma-9b `decode_32k`:
     the caches filled by a prefill of 128 x 1,024 tokens (`D_PROMPT`;
     2,048 through PR 29; in row groups
     where the reckoned peak of one does not fit), 16 decodes of batch
     128, ms a step and tokens/s, K1-K4 0;
 18. the sharded carry on two ranks of one gloo process group that share
     the card (`launch.mesh.spawn`, each rank `torch.cuda.set_device(0)`,
     a (data 1, model 2) mesh; gloo reduces a CUDA tensor on the host, so
     every collective is staged through it while the compute stays on
     the card; a join timeout of 300 s fails the phase), each check with
     the counts set to 0 just before and read just after: (h1) the scaled
     engine at (s1)'s configuration (n 1,024, capacity 1, compact_fused)
     on a carry placed by `sharded_step_specs`: 8 steps, K1 8 launches a
     rank each on its own 57,920 of the 115,840 columns, 0 collectives in
     the steps (an untimed window under CommDebugMode and the port's own
     collective counts), grads' collectives counted, the gathered carry
     and grads against the one-rank run (1e-5 of each leaf's largest
     entry), K1 on a real step's half-width operands (rank 0's local
     state and column layout; their launch bitwise the sharded step's
     vals) against its plain version, timed with the full width's as
     phase 15 times it (kernel, plain, baddbmm, bound), the window timed
     bare with both ranks at once, each rank alone and the one-rank run,
     and each rank's window traced alone in turn (device ops, idle
     share); (h2) L = 2 at n 512 (K1 16 a rank); (h3) one
     RigL event at n 256 on the sharded rewirable carry: the migrated vals
     bitwise the one-rank event's, the next 4 steps against the one-rank
     run, the event's collectives and ms; (h4) olmoe-1b-7b's MoE block at
     full width (bf16, 4 x 512 tokens): `moe_block_shardmap` over 2 ranks
     (32 experts each) against `dispatch` on one rank within 2 x 2^-7 of
     the largest output, run to run bitwise, the ms of each; (h5)
     `compressed_psum` over a 2-rank pod group, the accumulated
     deviation over 8 steps under 0.05, and (h3)'s carry written sharded
     by both ranks and restored on one rank, bitwise; (h6) (h1)'s
     configuration through `OnlineTrainer` on the placed carry: 2 windows
     of 8 steps (masked adamw), K1 8 launches a rank a window on its
     57,920 columns, the windows' losses and the parameters within 1e-5
     of the one-rank trainer's (rank 0, the other idle), each rank's
     window ms from the trainer's clock beside the one-rank window's, a
     run crashed after update 1 (a sharded checkpoint) resumed by a new
     trainer on the mesh, bitwise the uncrashed run;
 19. the LM's sharded steps on two ranks of one gloo group that share the
     card, as phase 18 runs them (a (data 1, model 2) mesh, a join timeout
     of 420 s that fails the phase), each check with the counts set to 0
     just before and read just after: (m1) rwkv6-3b at full width and
     depth, bf16, through `launch.steps.make_prefill_step(..., mesh=)`: a
     prefill of 4 x 512 tokens, K4 32 launches a rank each on its 20 of
     the 40 heads, the prefill's ms with both ranks at once (best of 2)
     and each rank's peak bytes beside the one-rank prefill's (rank 0,
     the other idle), the collectives it issues; K4 on layer 0's operands
     of each rank against its plain version, and on the two 20-head
     halves of the one-rank layer 0's operands bitwise the 40-head
     launch's same heads; every layer's bf16 time mix on the rank's
     heads, K4 against the plain WKV, within 5 %; f32 at 2 layers (4 x 256
     tokens): the gathered logits within 1e-5 of the largest one-rank
     logit; (m2) `Engine(mesh=...)` on rwkv6-3b, full width, 2 layers,
     f32: 4 prompts of 8 tokens and 16 greedy decodes each, the one-rank
     Engine's tokens, ms an engine step; (m3) `make_train_step(...,
     mesh=)` at full width and 2 layers, f32, sgdm, batch 2 x 256:
     rwkv6-3b and gemma2-2b pure data parallel, qwen3-8b tensor parallel
     over 'model'; 2 steps, loss and grad norm within 1e-5 and the
     gathered parameters within 1e-5 (rwkv6-3b 2e-4) of each leaf's
     largest entry against the one-rank step, each step's ms and
     collectives, each rank's peak bytes beside the one-rank step's; then
     rank 0's (m1) peak held within 10 % of the dry-run's reckoning of
     the same step on the same mesh (`dryrun_lib.count_rank` on rank 0's
     meta shards over a one-process fake group of 2 ranks, counted by a
     second helper process that phase 1 starts, `chip_smoke.py
     --reckon-sharded PATH`);
 20. the MoE decoders', the RG-LRU LM's and the encoder-decoder's
     sharded steps, run by phase 19's group after its own checks (one
     spawn for both phases; its join timeout of 420 s covers both, and
     phase 20's seconds are its parts'), each check with the counts set
     to 0 just before and read just after, K1-K4 0 launches in every one:
     (n1)
     olmoe-1b-7b at full width and depth, bf16, through
     `make_prefill_step(..., mesh=)`: a prefill of 4 x 512 tokens on the
     rank's 32 of the 64 experts (the shardmap form), its ms with both
     ranks at once (best of 2), each rank's peak bytes and collectives
     beside the one-rank prefill's (rank 0, the other idle); f32 at 2
     layers: the prefill and 8 greedy decodes (4 tokens a step, below one
     an expert: the global dispatch's fallback), the gathered logits
     within 1e-5 of the largest one-rank logit and the one-rank tokens;
     `make_train_step(..., mesh=)` at full width and 2 layers as phase
     19's (m3) (f32, sgdm, 2 x 256, 2 steps; loss, grad norm and the
     gathered parameters within 1e-5 of the one-rank step, the step's ms,
     collectives and each rank's peak beside the one-rank step's); (n2)
     recurrentgemma-9b at full width and 5 layers (one unit and both rem
     layers), f32: the same train step (tensor parallel over 'model', the
     LRU width split by channel), and `Engine(mesh=...)` with 4 prompts
     of 8 tokens and 16 greedy decodes each, the one-rank Engine's tokens
     and ms an engine step; (n3) whisper-large-v3 at full width, 2 + 2
     layers, f32: a prefill of 4 x 448 tokens with 4 x 1,500 frames and 8
     greedy decodes, the cross K/V split 750 positions a rank, the
     gathered logits within 1e-5 of the one-rank port's and its tokens;
     the train step pure DP at batch 2 and tensor parallel at batch 1 (2
     x 128 and 1 x 128 tokens with their frames), held as (n1)'s;
 21. one JSON line {"kernels": [...]} for every ported kernel (K1-K4),
     K1's and K2's with a "stacked" entry for phase 8's path, K1's with a
     "guard" and K2's with a "rewire" entry for phase 9's, both with a
     "telemetry" entry for phase 10's, a "fleet" entry for phase 11's and
     an "lm" entry for phase 12's, K1's with a "scaled" entry for phase
     15's and a "sharded" entry for phase 18's (its "trainer" entry
     (h6)'s launches), K4's with a "long" entry for phase 17's and a
     "sharded" entry for phase 19's, then the result
     line {"ok": true, "device": {...}}.

Tolerances: a float32 kernel result is within 1e-5 of the largest
magnitude of the plain version's (the sums associate differently); a bf16
result within one bf16 rounding step (2^-7 relative) more (phase 13's
attention: (1e-5 + 2^-7) of the largest magnitude).  Window
gradients across backends, devices and BPTT: 1e-5 of each leaf's largest
entry (BPTT on the surviving parameters: it also gives the pruned ones a
gradient, which the masked optimizer drops).
"""
import bisect
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12     # dense bf16 on the tensor cores
F32_REL = 1e-5
BF16_STEP = 2.0 ** -7


def main_argv(backend="compact_fused", *extra):
    """The main path's launcher arguments (no --device: it runs on CUDA)."""
    return ["--arch", "egru-spiral", "--online", "--rtrl-backend", backend,
            "--sparsity", "0.8", "--update-every", "8", "--steps", "20",
            "--seed", "0", *extra]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters, warmup=3):
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_alternating(torch, fns, iters, rounds=5):
    """Median ms per call of each of `fns` ({name: fn}) over `rounds` rounds
    of time_ms(iters), the fns taken in turn in every round, so that drift
    in the shared host's speed falls on all of them alike."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(time_ms(torch, fn, iters))
    return {name: statistics.median(v) for name, v in got.items()}


def device_us(torch, fn, calls=20):
    """Device µs per call of fn: every device kernel's time in a
    torch.profiler trace of `calls` back-to-back calls, summed, over the
    calls; None where the profiler records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    return sum(dev) / calls if dev else None


def host_us(torch, fn, iters=2000, warmup=20):
    """Host µs per call: the host clock over `iters` back-to-back calls,
    the device drained before; what the caller's thread spends to issue
    one call, where the device keeps up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def launch_path(torch, parts):
    """Host µs of a wrapper's call and of each part of its launch path,
    each timed alone ({name: fn} in, {name: µs} out); "rest" is what the
    call spends beyond the parts (argument handling, the counter)."""
    got = {name: host_us(torch, fn) for name, fn in parts.items()}
    got["rest"] = got["call"] - sum(v for k, v in got.items()
                                    if k not in ("call", "launch floor"))
    return got


def fmt_path(path):
    return (f"call {path['call']:.2f} us = " + " + ".join(
        f"{k} {v:.2f}" for k, v in path.items()
        if k not in ("call", "launch floor")) +
        f"; launch floor (empty kernel, same route) {path['launch floor']:.2f} us")


def k1_bound(torch, ops):
    """Least time (ms) for the fused update on these inputs: the larger of
    the bytes it must move over HBM bandwidth and its f32 FMA work over the
    CUDA-core peak, counting only what the live counts need."""
    J, vals, mbar, hp, idx_new, idx_prev, cn, cp = ops
    B, K, Pc = vals.shape
    es = vals.element_size()
    cn = cn.clamp(0, K).double().cpu()
    cp = cp.clamp(0, K).double().cpu()
    nbytes = float(cp.sum() * Pc * es            # live rows of vals, read
                   + cn.sum() * Pc * 4           # live rows of mbar, read
                   + (cn * cp).sum() * 4         # gathered J entries
                   + cn.sum() * 4 + 2 * B * K * 4 + 2 * B * 4   # hp, idx, counts
                   + B * K * Pc * es)            # every output row, written
    flops = float((2 * cn * cp * Pc).sum() + 2 * cn.sum() * Pc)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def ragged_operands(torch, dev, B, K, n, Pc, count_new, count_prev, seed):
    """Operands honouring the carry contract with the given live counts."""
    g = torch.Generator().manual_seed(seed)
    idx_new = torch.full((B, K), -1, dtype=torch.int32)
    idx_prev = torch.full((B, K), -1, dtype=torch.int32)
    for b in range(B):
        idx_new[b, :count_new[b]] = torch.randperm(n, generator=g)[
            :count_new[b]].sort().values.int()
        idx_prev[b, :count_prev[b]] = torch.randperm(n, generator=g)[
            :count_prev[b]].sort().values.int()
    gd = torch.Generator(device=dev).manual_seed(seed)
    J = torch.randn((B, n, n), generator=gd, device=dev)
    vals = torch.randn((B, K, Pc), generator=gd, device=dev)
    mbar = torch.randn((B, K, Pc), generator=gd, device=dev)
    hp = torch.rand((B, K), generator=gd, device=dev)
    idx_new, idx_prev = idx_new.to(dev), idx_prev.to(dev)
    vals *= (idx_prev >= 0)[:, :, None]
    hp *= (idx_new >= 0)
    cn = torch.tensor(count_new, dtype=torch.int32, device=dev)
    cp = torch.tensor(count_prev, dtype=torch.int32, device=dev)
    return [J, vals, mbar, hp, idx_new, idx_prev, cn, cp]


def with_carry_dtype(torch, ops, dtype):
    ops = list(ops)
    ops[1] = ops[1].to(dtype).contiguous()
    return ops


def compare_k1(torch, CF, ops, label, out=None):
    """Kernel vs plain version on the card (`out`: the kernel's output on
    `ops`, launched by the caller; else launched here); returns max abs
    error."""
    if out is None:
        out = CF.fused_update(*ops)
    torch.cuda.synchronize()                    # a fault surfaces here
    ref = CF.fused_reference(*ops)
    check(out.dtype == ops[1].dtype and out.shape == ops[1].shape,
          f"{label}: output {out.dtype} {tuple(out.shape)}")
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
    err = (o - r).abs()
    scale = max(float(r.abs().max()), 1.0)
    if ops[1].dtype == torch.float32:
        ok = float(err.max()) <= F32_REL * scale
    else:
        ok = bool((err <= BF16_STEP * r.abs() + F32_REL * scale).all())
    check(ok, f"{label}: kernel vs plain max abs err {float(err.max()):.3e} "
              f"(scale {scale:.3e})")
    K = ops[1].shape[1]
    rows = torch.arange(K, device=o.device)[None, :]
    dead = rows >= ops[6].clamp(max=K)[:, None]
    check(bool((o[dead] == 0).all()), f"{label}: dead rows not exactly zero")
    log(f"K1 {label}: max_abs_err {float(err.max()):.3e} "
        f"(scale {scale:.3e}), dead rows exactly 0: "
        f"{int(dead.sum())} rows")
    return float(err.max())


def time_k1(torch, CF, CK, ops, iters, alt_iters, host=False):
    """(kernel ms, plain ms, library ms, bound ms, bound_by), each by
    time_ms (one window); the kernel and the partial yardstick (baddbmm on
    pre-gathered tiles) also timed in turn (alt_ms, alt_library_ms: the
    median of 5 rounds of alt_iters calls); the device µs of both
    (profiler); with `host` the wrapper's launch path in host µs."""
    from repro_torch.kernels import _build, influence as IN
    call = lambda: CF.fused_update(*ops)
    ms = time_ms(torch, call, iters)
    plain = time_ms(torch, lambda: CF.fused_reference(*ops), max(iters // 10, 3))
    J, vals, mbar, hp, idx_new, idx_prev = ops[:6]
    Jgg = CK.gather_j_tiles(J, idx_new, idx_prev).contiguous()
    vf = vals.float().contiguous()
    library = lambda: torch.baddbmm(mbar, Jgg, vf)
    lib = time_ms(torch, library, iters)
    alt = time_alternating(torch, {"ms": call, "lib": library}, alt_iters)
    bound, by, nbytes, flops = k1_bound(torch, ops)
    out = {"ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "flops": flops, "alt_ms": alt["ms"], "alt_library_ms": alt["lib"],
           "device_us": device_us(torch, call),
           "library_device_us": device_us(torch, library)}
    if host:
        B, K, Pc = vals.shape
        dev, args = vals.device, tuple(ops)
        kc = CF._call(B, J.shape[-1], K, Pc, vals.dtype, dev)
        y = torch.empty_like(vals)
        packed = kc.pack(*(t.data_ptr() for t in args), y.data_ptr(),
                         *kc.dims, _build.current_stream(dev))
        out["host_us"] = launch_path(torch, {
            "call": call,
            "checks": lambda: (kc.matches(args),
                               list(map(torch.Tensor.data_ptr, args))),
            "autograd check": lambda: _build.refuse_autograd(
                "fused_update", J, vals, mbar, hp),
            "allocation": lambda: torch.empty_like(vals),
            "stream": lambda: _build.current_stream(dev),
            "ctypes call": lambda: kc.fn(packed),
            "launch floor": lambda: IN.empty_launch(dev)})
    return out


def k1_launch_shape(CF, ops):
    """K1's launch on these operands: grid, threads, rows and shared bytes
    a CTA, registers, spills, residency (`fused_update`'s `geometry`), as
    one line."""
    B, K, Pc = ops[1].shape
    geo = CF.geometry(B, K, Pc, ops[1].dtype, ops[1].device)
    return (f"grid {geo['grid']} CTAs of {geo['threads']} threads "
            f"({geo['warps']} warps, {geo['rows']} rows x 128 columns), "
            f"{geo['smem_bytes']} shared bytes a CTA, {geo['registers']} "
            f"registers and {geo['spill_bytes']} spilled bytes a thread, "
            f"{geo['ctas_per_sm']} CTAs an SM, {geo['stages']} ring stages")


def main_path_operands(torch, TRAIN, SP, ON, dev, steps=5):
    """K1's operands at a live step of the main path: the launcher's run
    (same seed), stepped a few times from init, then the next step's
    kernel operands."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv()))
    cfg, learner = run["cfg"], run["learner"]
    xs, ys = stream_window(torch, run, steps + 1)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]),
                         t_total=8.0)
    carry, _, _, _ = ON.stream_grads(learner, carry, xs[:steps], ys[:steps])
    lcfg = cfg.layer_cfg(0)
    layout = SP.flat_layout(lcfg)
    cl = SP.col_layout(layout, run["masks"][0], device=dev)
    w = {k: v for k, v in carry["params"].items() if k != "out"}
    _, _, ops, _ = SP.fused_step_operands(lcfg, w, layout, carry["a"],
                                          carry["vals"], carry["idx"],
                                          xs[steps], cl=cl)
    return list(ops)


# ---------------------------------------------------------------------------
# phase 3: K2 against its plain version
# ---------------------------------------------------------------------------

def k2_masks(ops):
    return dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                jmask=ops[7])


def k2_bound(torch, ops):
    """Least time (ms) for the block-sparse update on these padded
    operands: the bytes it must move over HBM bandwidth — the live rows of
    M at live columns, the live blocks of M-bar, the J tiles of executed
    blocks, hp, and the whole output written — against 2*8*8*128 f32 FLOP
    per executed (b, kb, lb, pb) block over the CUDA-core peak."""
    from repro_torch.kernels import influence as IN
    hp, J, M, Mbar, row, prev, cols, jm = ops
    B, n_p, P_p = M.shape
    row, prev, jm = ((t != 0).double().cpu() for t in (row, prev, jm))
    live_cols = float((cols != 0).sum()) * IN.BP
    pairs = torch.einsum("bk,bl,kl->bkl", row, prev, jm)   # executed (kb, lb)
    m_rows = float((pairs.sum(dim=1) > 0).sum()) * IN.BL   # rows of M used
    out_rows = float(row.sum()) * IN.BK
    nbytes = (m_rows * live_cols * 4 + out_rows * live_cols * 4
              + float(pairs.sum()) * IN.BK * IN.BL * 4 + out_rows * 4
              + B * n_p * P_p * 4)
    blocks = int(IN.executed_blocks(*(ops[4:])))
    flops = float(blocks) * 2 * IN.BK * IN.BL * IN.BP
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def compare_k2(torch, IN, OPS, unpadded, label, quiet=False):
    """Kernel vs plain version on the card, dead blocks exactly zero, and
    the executed-block counter against realized_block_savings.  Returns
    (max abs error, padded operands); `quiet` logs nothing."""
    ops = OPS.influence_operands(*unpadded)
    masks = k2_masks(ops)
    count = torch.zeros(1, dtype=torch.int64, device=ops[2].device)
    out = IN.influence_update(*ops[:4], **masks, block_count=count)
    torch.cuda.synchronize()                    # a fault surfaces here
    ref = IN.influence_reference(*ops[:4], **masks)
    check(out.dtype == torch.float32 and out.shape == ops[2].shape,
          f"K2 {label}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"K2 {label}: non-finite output")
    err = float((out - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    check(err <= F32_REL * scale, f"K2 {label}: kernel vs plain max abs err "
                                  f"{err:.3e} (scale {scale:.3e})")
    live = (ops[4] != 0).repeat_interleave(IN.BK, 1)[:, :, None] \
        & (ops[6] != 0).repeat_interleave(IN.BP)
    check(bool((out[~live] == 0).all()),
          f"K2 {label}: dead row/column blocks not exactly zero")
    B = ops[2].shape[0]
    total = B * ops[4].shape[1] * ops[5].shape[1] * ops[6].shape[0]
    hp, _, M, _, jmask, col_mask = unpadded
    expect = OPS.realized_block_savings(hp, M, jmask, col_mask) * total
    check(abs(expect - round(expect)) < 1e-6 and int(count) == round(expect),
          f"K2 {label}: executed blocks {int(count)} vs "
          f"realized_block_savings x blocks {expect}")
    if not quiet:
        log(f"K2 {label}: B={B} n_p={ops[2].shape[1]} P_p={ops[2].shape[2]}, "
            f"max_abs_err {err:.3e} (scale {scale:.3e}), dead blocks exactly "
            f"0: {int((~live).sum())} elements, executed blocks {int(count)} "
            f"of {total} = realized_block_savings {expect / total:.6f}")
    return err, ops


def time_k2(torch, IN, ops, iters, alt_iters, host=True):
    """(kernel ms, plain ms, library ms, bound ms, bound_by), each by
    time_ms (one window); the kernel and the library call also timed in
    turn (alt_ms, alt_library_ms: the median of 5 rounds of alt_iters
    calls); the device µs of both (profiler); with `host` the wrapper's
    launch path in host µs."""
    from repro_torch.kernels import _build
    masks = k2_masks(ops)
    call = lambda: IN.influence_update(*ops[:4], **masks)
    ms = time_ms(torch, call, iters)
    plain = time_ms(torch, lambda: IN.influence_reference(*ops[:4], **masks),
                    max(iters // 10, 3))
    hp, J, M, Mbar = ops[:4]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library = lambda: torch.baddbmm(Mbar, J, M)
        lib = time_ms(torch, library, iters)
        alt = time_alternating(torch, {"ms": call, "lib": library},
                               alt_iters)
        lib_dev = device_us(torch, library)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bound, by, nbytes, flops = k2_bound(torch, ops)
    out = {"ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "flops": flops, "alt_ms": alt["ms"], "alt_library_ms": alt["lib"],
           "device_us": device_us(torch, call),
           "library_device_us": lib_dev}
    if host:
        B, n, P = M.shape
        dev, args = M.device, tuple(ops[:8])
        ptrs = [t.data_ptr() for t in args]
        kc = IN._call(B, n, P, dev, False)
        y = torch.empty_like(M)
        packed = kc.pack(*ptrs, y.data_ptr(), 0, *kc.dims,
                         _build.current_stream(dev))
        out["host_us"] = launch_path(torch, {
            "call": call,
            "checks": lambda: (kc.matches(args),
                               list(map(torch.Tensor.data_ptr, args))),
            "autograd check": lambda: _build.refuse_autograd(
                "influence_update", hp, J, M, Mbar),
            "allocation": lambda: torch.empty_like(M),
            "stream": lambda: _build.current_stream(dev),
            "ctypes call": lambda: kc.fn(packed),
            "launch floor": lambda: IN.empty_launch(dev)})
    return out


def k2_main_operands(torch, TRAIN, SP, ON, dev, *extra, steps=5):
    """K2's unpadded operands (hp, J-hat, M, M-bar, jmask, col_mask) at a
    live step of the pallas main path: the launcher's run (same seed),
    stepped a few times from init, then the next step's operands."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("pallas", *extra)))
    cfg, learner = run["cfg"], run["learner"]
    xs, ys = stream_window(torch, run, steps + 1)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]),
                         t_total=8.0)
    carry, _, _, _ = ON.stream_grads(learner, carry, xs[:steps], ys[:steps])
    lcfg, masks = cfg.layer_cfg(0), run["masks"][0]
    layout = SP.flat_layout(lcfg)
    compact = carry["M"].shape[-1] != layout.P_pad
    cl = SP.col_layout(layout, masks, device=dev) if compact else None
    w = {k: v for k, v in carry["params"].items() if k != "out"}
    _, _, ops = SP.pallas_step_operands(
        lcfg, w, layout, carry["a"], carry["M"], xs[steps], cl=cl,
        col_mask=cl.live if compact else SP.flat_col_mask(layout, masks,
                                                          device=dev),
        jmask=SP.flat_jmask(lcfg, masks))
    return list(ops)


def k2_synthetic(torch, dev, seed=1):
    """(b): B=4, n=256, P=20864 (K1's (b) width) with live new-row blocks
    32/18/12/1 and previous-row blocks 32/13/19/8 of 32, the J pattern and
    the column blocks at block density 0.5 (the J pattern asymmetric)."""
    B, n, P = 4, 256, 20864
    nb, npb = n // 8, P // 128
    g = torch.Generator().manual_seed(seed)

    def some_blocks(counts):
        m = torch.zeros((B, nb), dtype=torch.bool)
        for b, c in enumerate(counts):
            m[b, torch.randperm(nb, generator=g)[:c]] = True
        return m.repeat_interleave(8, 1).to(dev)

    rows, prev = some_blocks([32, 18, 12, 1]), some_blocks([32, 13, 19, 8])
    jb = torch.rand((nb, nb), generator=g) < 0.5
    jb[0, nb - 1], jb[nb - 1, 0] = True, False
    jmask = jb.repeat_interleave(8, 0).repeat_interleave(8, 1).float().to(dev)
    col_mask = (torch.rand((npb,), generator=g) < 0.5).repeat_interleave(
        128).float().to(dev)
    gd = torch.Generator(device=dev).manual_seed(seed)
    hp = torch.rand((B, n), generator=gd, device=dev) * rows
    Jhat = torch.randn((B, n, n), generator=gd, device=dev) * jmask.T
    M = torch.randn((B, n, P), generator=gd, device=dev)
    M *= prev[:, :, None]
    M *= col_mask
    Mbar = torch.randn((B, n, P), generator=gd, device=dev)
    Mbar *= col_mask
    return [hp, Jhat, M, Mbar, jmask, col_mask]


def k2_edges(torch, dev, seed=2):
    """(c): n=20 and P=130 (padded to 24 and 256): a masked case with an
    example whose rows are all dead, and the first step (M all zero) with
    neither jmask nor col_mask."""
    g = torch.Generator().manual_seed(seed)
    B, n, P = 3, 20, 130
    hp = torch.rand((B, n), generator=g)
    hp[torch.rand((B, n), generator=g) < 0.3] = 0.0
    hp[-1] = 0.0
    Jhat = torch.randn((B, n, n), generator=g)
    M = torch.randn((B, n, P), generator=g)
    M[torch.rand((B, n), generator=g) < 0.3] = 0.0
    Mbar = torch.randn((B, n, P), generator=g)
    jb = torch.rand((3, 3), generator=g) < 0.5
    jb[0, 2], jb[2, 0] = True, False
    jmask = jb.repeat_interleave(8, 0).repeat_interleave(8, 1)[:n, :n].float()
    col_mask = (torch.rand((P,), generator=g) < 0.5).float()
    masked = [hp, Jhat * jmask.T, M * col_mask, Mbar * col_mask, jmask,
              col_mask]
    first = [torch.rand((B, n), generator=g), Jhat, torch.zeros_like(M),
             Mbar, None, None]
    to = lambda ops: [None if t is None else t.to(dev) for t in ops]
    return to(masked), to(first)


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

def stream_window(torch, run, k):
    """The first k stream steps of a built run, on its device."""
    import numpy as np
    xs, ys = zip(*(run["stream"](t) for t in range(k)))
    return (torch.from_numpy(np.stack(xs)).to(run["device"]),
            torch.from_numpy(np.stack(ys)).to(run["device"]))


def first_window_grads(torch, TRAIN, ON, backend, *extra):
    """Loss and gradients of the main path's first window (k=8)."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv(backend, *extra)))
    xs, ys = stream_window(torch, run, 8)
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    return float(loss), grads


def tree_items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        return [i for k, v in tree.items() for i in tree_items(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [i for k, v in enumerate(tree)
                for i in tree_items(v, f"{prefix}/{k}")]
    return [] if tree is None else [(prefix, tree)]


def bptt_first_window(torch, TRAIN, BP, ST):
    """The BPTT oracle's loss and gradients on the main path's first window
    (same seed, params, masks, 8 steps and label) on the card, the pruned
    parameters' gradients masked as the optimizer masks them."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("dense")))
    xs, ys = stream_window(torch, run, 8)
    check(bool((ys == ys[0]).all()), "first window spans two sequences")
    params, cfg = run["params"], run["cfg"]
    single = dict(params["layers"][0], out=params["out"])
    loss, g, _ = BP.bptt_loss_and_grads(cfg.layer_cfg(0), single, xs, ys[0])
    grads = {"layers": [{k: v for k, v in g.items() if k != "out"}],
             "out": g["out"]}
    return float(loss), ST.apply_stacked_masks(grads, run["masks"])


def compare_grads(a, b, label, what="first-window gradients"):
    worst = 0.0
    ia, ib = tree_items(a), tree_items(b)
    check([k for k, _ in ia] == [k for k, _ in ib],
          f"{label}: gradient trees differ: {[k for k, _ in ia]} vs "
          f"{[k for k, _ in ib]}")
    for (_, x), (_, y) in zip(ia, ib):
        x, y = x.double().cpu(), y.double().cpu()
        scale = max(float(y.abs().max()), 1e-3)
        err = float((x - y).abs().max())
        check(err <= F32_REL * scale,
              f"{label}: gradient leaf differs by {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / scale)
    log(f"{what} {label}: max rel err {worst:.3e}")


# the telemetry plane's spans (repro_torch.obs, record_function names)
SPAN_NAMES = ("window", "rewire", "rollback_replay", "ckpt_write")
# phase 10 (c): runs of the main path each, bare and with --metrics-dir,
# taken in turn with the order flipped every round
TELEMETRY_ROUNDS = 4     # 12 through PR 29: cut for the script's time


def trace_main_path(torch, TRAIN, ON, backend, kernel, *extra, warm=2,
                    traced=2, k=8, telemetry=None, argv=None):
    """Where a main-path window's time goes: a torch.profiler trace of
    `traced` windows after `warm` untraced ones, in a run of its own (the
    window times come from the untraced run).  Reports device kernels per
    stream step, the device's busy and idle share of the traced wall time,
    the port kernel's device time per launch and the kernels that take the
    most time.  With `--guard` in `extra` the trainer runs the stream
    guard; `telemetry` (a repro_torch.obs.Telemetry) instruments it.
    Returns {"ops_per_step", "busy_us", "wall_us", "dtoh" (device-to-host
    copies in the traced run, its end included), "window_kernels" and
    "window_dtoh" (the port kernel's launches and the device-to-host
    copies inside each `window` record_function span; [] without spans)}
    (None where the profiler recorded no device event).  `argv` replaces
    the main path's arguments (the token LM's run, phase 12)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.guard import GuardConfig
    args = TRAIN.parse_args(argv or main_argv(backend, *extra))
    run = built_run(TRAIN, args)
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=warm * k, update_every=k),
        run["learner"], run["opt"], run["params"], run["masks"],
        run["stream"], device=run["device"],
        guard=GuardConfig() if args.guard else None, telemetry=telemetry)
    tr.run()
    tr.cfg.total_steps = (warm + traced) * k
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a record_function span also shows on the device timeline (as a user
    # annotation): not an op
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in SPAN_NAMES]
    if not dev:
        log("trace: the profiler recorded no device events: device busy "
            "share not measured")
        return None
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    steps = traced * k
    by_name = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    kern = [v for n, v in by_name.items() if kernel in n]
    kern_us = sum(v[0] for v in kern) / max(sum(v[1] for v in kern), 1)
    log(f"trace {backend}{''.join(' ' + a for a in extra)} ({traced} "
        f"windows, {steps} stream steps, profiler "
        f"on): {len(dev) / steps:.1f} device ops per stream step, device busy "
        f"{busy:.0f} us of {wall_us:.0f} us wall "
        f"(idle share {1 - busy / wall_us:.3f}), {kernel} device time "
        f"{kern_us:.2f} us per launch")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for n, (tot, cnt) in top:
        log(f"  {tot / steps:8.2f} us/step  x{cnt / steps:5.1f}/step  {n[:90]}")
    spans = [e.time_range for e in prof.events()
             if e.device_type != DeviceType.CUDA and e.name == "window"]

    def in_spans(match):
        starts = [e.time_range.start for e in dev if match in e.name]
        return len(starts), [sum(1 for t in starts if w.start <= t <= w.end)
                             for w in spans]

    dtoh, window_dtoh = in_spans("DtoH")
    return {"ops_per_step": len(dev) / steps, "busy_us": busy,
            "wall_us": wall_us, "dtoh": dtoh, "window_dtoh": window_dtoh,
            "window_kernels": in_spans(kernel)[1]}

# ---------------------------------------------------------------------------
# phase 5: checkpoint, restart and the offline path
# ---------------------------------------------------------------------------

def offline_argv(backend, *extra):
    """The offline path's launcher arguments (no --device: it runs on
    CUDA): 20 whole-sequence steps of 17 stream steps."""
    return ["--arch", "egru-spiral", "--rtrl-backend", backend,
            "--sparsity", "0.8", "--steps", "20", "--seed", "0", *extra]


def run_counted(TRAIN, argv):
    """One launcher run with every kernel's count set to 0 just before and
    read just after."""
    reset_counts()
    out = TRAIN.main(argv)
    return out, read_counts()


def built_run(TRAIN, args):
    """The launcher's online run of `args`: the token LM's (phase 12) or
    the spiral stream's."""
    return (TRAIN.build_lm if args.arch in TRAIN.LM_ARCHS
            else TRAIN.build_online)(args)


def ckpt_like(TRAIN, argv):
    """The checkpoint tree of a launcher run's trainer, for load_checkpoint."""
    args = TRAIN.parse_args(argv)
    if args.online:
        return TRAIN.online_trainers(args, built_run(TRAIN, args))(1) \
            ._ckpt_tree()
    return TRAIN.offline_trainers(args, TRAIN.build_offline(args))(1) \
        ._ckpt_tree()


def checkpoints_bitwise(torch, CKP, root_a, root_b, like, label):
    """The newest checkpoints under root_a and root_b, loaded through the
    port's load_checkpoint, equal bit for bit on every leaf but the RNG key
    data."""
    import numpy as np
    from repro_torch.tree import tree_flatten_with_path
    ta, sa = CKP.load_checkpoint(root_a, like)
    tb, sb = CKP.load_checkpoint(root_b, like)
    check(sa == sb >= 0, f"{label}: final checkpoints at {sa} and {sb}")
    n = 0
    for (path, a), (_, b) in zip(tree_flatten_with_path(ta),
                                 tree_flatten_with_path(tb)):
        if path == ("key",):
            continue
        if isinstance(a, torch.Tensor):
            same = torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))
        else:
            same = np.array_equal(a, b)
        check(same, f"{label}: leaf {path} differs between the crashed and "
                    "the uncrashed run")
        n += 1
    return n, tb


def crash_and_resume(torch, TRAIN, CKP, argv, kernel, root, label,
                     layers=1):
    """The run with one crash at update/step 7 (checkpoints every 5) and
    the same run without it: restarts 1 and 0, the launches of `kernel`
    (one a layer a stream step; the crashed run replays two windows or
    steps; None: a run that launches no kernel), the records after the
    resume equal to the uncrashed run's, and the final checkpoints bit for
    bit."""
    online = "--online" in argv
    a, ca = run_counted(TRAIN, [*argv, "--fail-at", "7", "--ckpt-dir",
                                str(root / "a")])
    b, cb = run_counted(TRAIN, [*argv, "--ckpt-dir", str(root / "b")])
    per = (8 if online else 17) * layers      # launches a window / step
    done = 160 if online else 20
    check((a["restarts"], b["restarts"]) == (1, 0),
          f"{label}: restarts {a['restarts']} / {b['restarts']}")
    check(a["final_step"] == b["final_step"] == done,
          f"{label}: final steps {a['final_step']} / {b['final_step']}")
    n_units = done // 8 if online else done
    check_counts(ca, {kernel: (n_units + 2) * per} if kernel else {},
                 f"{label} crashed")
    check_counts(cb, {kernel: n_units * per} if kernel else {},
                 f"{label} uncrashed")
    key, recs = ("update", "windows") if online else ("step", "steps")
    b_loss = {r[key]: r["loss"] for r in b[recs]}
    check([r[key] for r in a[recs]] == list(range(6, n_units + 1)),
          f"{label}: the restart did not resume at 5")
    check(all(r["loss"] == b_loss[r[key]] for r in a[recs]),
          f"{label}: losses after the resume differ from the uncrashed run")
    like = ckpt_like(TRAIN, [*argv, "--ckpt-dir", str(root / "like")])
    n, tree = checkpoints_bitwise(torch, CKP, root / "a", root / "b", like,
                                  label)
    launched = (f"{kernel} launches {ca[kernel]} / {cb[kernel]}" if kernel
                else "no kernel launches")
    log(f"resume {label}: restarts 1 / 0, {launched}, final step {done}, "
        f"{len(a[recs])} "
        f"records after the resume equal to the uncrashed run's, final "
        f"checkpoints bitwise on {n} leaves")
    return a, b, tree


def resumed_window(torch, TRAIN, ON, CKP, ckpt_root, device, root, step=10):
    """Loss and gradients of the window after update `step`, from the
    checkpoint of that update, on `device`."""
    import numpy as np
    argv = main_argv("compact_fused", "--ckpt-every", "5", "--ckpt-dir",
                     str(root / f"like-{device}"), "--device", device)
    args = TRAIN.parse_args(argv)
    run = TRAIN.build_online(args)
    tree, got = CKP.load_checkpoint(
        ckpt_root, TRAIN.online_trainers(args, run)(1)._ckpt_tree(),
        step=step)
    pos = int(tree["pos"])
    check(got == step and pos == 8 * step, f"checkpoint {got} at {pos}")
    xs, ys = zip(*(run["stream"](pos + t) for t in range(8)))
    xs = torch.from_numpy(np.stack(xs)).to(run["device"])
    ys = torch.from_numpy(np.stack(ys)).to(run["device"])
    _, loss, grads, _ = ON.stream_grads(run["learner"], tree["carry"], xs, ys)
    return float(loss), grads


def ckpt_costs(torch, TRAIN, CKP, argv, root):
    """What one checkpoint of a run's carry and optimizer state costs
    (median of 5): its bytes on disk; the ms until save() returns (the
    copies to the host, in the caller's thread) and until the background
    write is joined (np.save of every leaf and the rename); the ms of one
    restore onto the card, and of the newest-valid scan inside it (every
    leaf's header read)."""
    like = ckpt_like(TRAIN, [*argv, "--ckpt-dir", str(root / "like")])
    m = CKP.CheckpointManager(root / "timed", keep=1)
    times = {"save returns": [], "save joined": [], "restore": [],
             "valid-step scan": []}
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.save(i, like)
        t1 = time.perf_counter()
        m.wait()
        t2 = time.perf_counter()
        CKP.load_checkpoint(root / "timed", like)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        CKP.valid_steps(root / "timed")
        t4 = time.perf_counter()
        for key, dt in zip(times, (t1 - t0, t2 - t0, t3 - t2, t4 - t3)):
            times[key].append(dt * 1e3)
    step_dir = root / "timed" / "step_00000004"
    nbytes = sum(f.stat().st_size for f in step_dir.glob("*.npy"))
    return nbytes, len(list(step_dir.glob("*.npy"))), {
        k: statistics.median(v) for k, v in times.items()}


def checkpoint_phase(torch, TRAIN, ON, CKP):
    """(r1)-(r4) of the checkpoint, restart and offline paths, under a
    temporary directory that is removed at the end."""
    import shutil
    import tempfile
    import numpy as np
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        # (r1) crash and resume with K1, f32 and bf16
        _, b_fused, _ = crash_and_resume(
            torch, TRAIN, CKP, main_argv("compact_fused", "--ckpt-every",
                                         "5"),
            "compact_fused", root / "r1", "online compact_fused f32")
        _, _, tree = crash_and_resume(
            torch, TRAIN, CKP, main_argv("compact_fused", "--ckpt-every", "5",
                                         "--influence-dtype", "bfloat16"),
            "compact_fused", root / "r1bf", "online compact_fused bf16")
        vals = tree["carry"]["vals"]
        step_dir = root / "r1bf" / "b" / "step_00000020"
        raw = np.load(step_dir / "carry__vals.s_full.npy")
        entry = [e for e in json.loads((step_dir / "manifest.json")
                                       .read_text())["leaves"]
                 if e["name"] == "carry__vals"][0]
        check(vals.dtype == torch.bfloat16 and raw.dtype == np.uint16
              and entry["dtype"] == "bfloat16"
              and np.array_equal(raw, vals.view(torch.int16).cpu().numpy()
                                 .view(np.uint16)),
              "bf16 carry: the vals leaf is not its uint16 bits on disk")
        log(f"resume bf16: carry__vals {tuple(vals.shape)} on disk as "
            f"{raw.dtype} under manifest dtype {entry['dtype']}, bitwise")
        # (r2) the same with K2
        crash_and_resume(torch, TRAIN, CKP,
                         main_argv("pallas", "--ckpt-every", "5"),
                         "influence", root / "r2", "online pallas")
        # (r3) across devices, from the checkpoint of update 10
        b_root = root / "r1" / "b"
        lg, gg = resumed_window(torch, TRAIN, ON, CKP, b_root, "cuda", root)
        lc, gc = resumed_window(torch, TRAIN, ON, CKP, b_root, "cpu", root)
        b_next = [w["loss"] for w in b_fused["windows"] if w["update"] == 11]
        check(lg == b_next[0], f"card checkpoint resumed on the card: window "
                               f"11 loss {lg} vs the uncrashed run's {b_next}")
        check(abs(lc - lg) <= F32_REL * abs(lg),
              f"card checkpoint on the CPU: loss {lc} vs {lg}")
        compare_grads(gc, gg, "card checkpoint resumed on the CPU vs the card",
                      "window-11 gradients")
        TRAIN.main(main_argv("compact_fused", "--ckpt-every", "10", "--steps",
                             "10", "--device", "cpu", "--ckpt-dir",
                             str(root / "r3cpu")))
        lc2, gc2 = resumed_window(torch, TRAIN, ON, CKP, root / "r3cpu",
                                  "cpu", root)
        lg2, gg2 = resumed_window(torch, TRAIN, ON, CKP, root / "r3cpu",
                                  "cuda", root)
        check(abs(lg2 - lc2) <= F32_REL * abs(lc2),
              f"CPU checkpoint on the card: loss {lg2} vs {lc2}")
        compare_grads(gg2, gc2, "CPU checkpoint resumed on the card vs the CPU",
                      "window-11 gradients")
        log(f"resume across devices: window 11 loss card {lg:.8f} (the "
            f"uncrashed run's {b_next[0]:.8f}), CPU {lc:.8f}; from the CPU's "
            f"checkpoint CPU {lc2:.8f}, card {lg2:.8f}")
        # (r4) offline, with K1 and K2
        offline = {}
        for backend, kernel in (("compact_fused", "compact_fused"),
                                ("pallas", "influence")):
            _, offline[backend], _ = crash_and_resume(
                torch, TRAIN, CKP, offline_argv(backend, "--ckpt-every", "5"),
                kernel, root / f"r4{backend}", f"offline {backend}")
        firsts = {}
        for backend in ("compact", "compact_fused", "pallas"):
            run = TRAIN.build_offline(TRAIN.parse_args(offline_argv(backend)))
            xs, ys = run["data_at"](0)
            loss, grads, _ = run["loss_and_grads"](run["params"], xs, ys)
            firsts[backend] = (float(loss), grads)
        lc, gc = firsts["compact"]
        for backend in ("compact_fused", "pallas"):
            lb, gb = firsts[backend]
            check(abs(lb - lc) <= F32_REL * abs(lc),
                  f"offline first step {backend} {lb} vs compact {lc}")
            compare_grads(gb, gc, f"{backend} vs compact (cuda)",
                          "offline first-step gradients")
        for backend, out in offline.items():
            s = out["summary"]
            log(f"offline {backend}: median step {s['median_step_ms']:.3f} ms "
                f"(17 stream steps and the update; {len(out['steps'])} "
                f"steps), first loss {s['first_loss']:.6f}, final loss "
                f"{s['final_loss']:.6f}")
        # what a checkpoint costs
        for backend in ("compact_fused", "pallas"):
            nbytes, files, ms = ckpt_costs(
                torch, TRAIN, CKP, main_argv(backend, "--ckpt-every", "5"),
                root / f"cost-{backend}")
            log(f"checkpoint online {backend}: {nbytes} bytes on disk in "
                f"{files} files; ms (median of 5): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in ms.items()))
    finally:
        shutil.rmtree(root, ignore_errors=True)

# ---------------------------------------------------------------------------
# phase 8: the stacked engine (--layers 2 and 3)
# ---------------------------------------------------------------------------

def stacked_window(torch, TRAIN, ON, backend, layers, *extra):
    """The first window (k=8) of `--layers L` on the card: (loss, grads,
    stats, run, xs, label)."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv(
        backend, "--layers", str(layers), *extra)))
    xs, ys = stream_window(torch, run, 8)
    check(bool((ys == ys[0]).all()), "first window spans two sequences")
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    _, loss, grads, stats = ON.stream_grads(run["learner"], carry, xs, ys)
    return float(loss), grads, stats, run, xs, ys[0]


def stacked_oracles(torch, BP, RT, ST, run, xs, label):
    """The stacked BPTT and jacrev RTRL oracles on a run's first window,
    on the card, masked as the optimizer masks the gradients."""
    out = {}
    for name, fn in (("stacked BPTT oracle", BP.stacked_bptt_loss_and_grads),
                     ("stacked jacrev oracle",
                      RT.stacked_rtrl_loss_and_grads)):
        t0 = time.perf_counter()
        loss, grads, _ = fn(run["cfg"], run["params"], xs, label)
        torch.cuda.synchronize()
        log(f"{name} on the card: {time.perf_counter() - t0:.2f} s")
        out[name] = (float(loss), ST.apply_stacked_masks(grads, run["masks"]))
    return out


def stacked_layer_operands(torch, TRAIN, SP, CF, ON, backend, *extra,
                           steps=5):
    """Layer 0's and layer 1's kernel operands at a live step of the
    `--layers 2` path: the launcher's run stepped a few times from init,
    then the next step replayed layer by layer.  compact_fused: K1's
    operand tuples, layer 1's M-bar rows carrying the cross term;
    pallas: K2's unpadded (hp, J-hat, M, M-bar, jmask, col_mask), layer
    1's M-bar carrying B-hat M^(0)_t, col_mask the layer's compact-axis
    liveness (the columns of layers above killed)."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv(
        backend, "--layers", "2", *extra)))
    cfg, learner = run["cfg"], run["learner"]
    xs, ys = stream_window(torch, run, steps + 1)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]),
                         t_total=8.0)
    carry, _, _, _ = ON.stream_grads(learner, carry, xs[:steps], ys[:steps])
    ws, sl, cl = carry["params"]["layers"], learner.slayout, learner._cl
    inp, below, out = xs[steps], None, []
    for l in range(2):
        lcfg, lay = cfg.layer_cfg(l), sl.layers[l]
        if backend == "compact_fused":
            a_new, _, ops, _ = SP.fused_step_operands(
                lcfg, ws[l], lay, carry["a"][l], carry["vals"][l],
                carry["idx"][l], inp, cl=cl, layer=l, below=below)
            below = (CF.fused_reference(*ops), ops[4])
        else:
            a_new, _, ops = SP.pallas_step_operands(
                lcfg, ws[l], lay, carry["a"][l], carry["M"][l], inp, cl=cl,
                col_mask=learner._klives[l],
                jmask=SP.flat_jmask(lcfg, run["masks"][l]), layer=l,
                M_below=below)
            hp, J, M, Mb = ops[:4]
            below = hp[:, :, None] * (torch.bmm(J, M) + Mb)
        out.append(list(ops))
        inp = a_new
    return out, learner


def stacked_phase(torch, TRAIN, ON, CKP, BP, RT, ST, SP, CF, CK, IN, OPS,
                  CO):
    """(s1)-(s6) of the stacked engine; returns K1's and K2's stacked
    entries for the kernels line."""
    import shutil
    import tempfile
    lay2 = ("--layers", "2")
    # (s1) online, --layers 2, every backend, and compact_fused in bf16
    runs, entries = {}, {}
    for backend, extra in (("compact_fused", ()), ("pallas", ()),
                           ("dense", ()), ("compact", ()),
                           ("compact_fused bf16",
                            ("--influence-dtype", "bfloat16"))):
        name = backend.split()[0]
        reset_counts()
        out = TRAIN.main(main_argv(name, *lay2, "--ckpt-every", "0", *extra))
        counts = read_counts()
        runs[backend] = out
        want = {"compact_fused": {"compact_fused": 320},
                "pallas": {"influence": 320}}.get(name, {})
        check_counts(counts, want, f"--layers 2 {backend}")
        check(out["final_step"] == 160, f"--layers 2 {backend}: "
                                         f"{out['final_step']} stream steps")
        losses = [w["loss"] for w in out["windows"]]
        check(all(math.isfinite(v) for v in losses),
              f"--layers 2 {backend}: non-finite loss {losses}")
        check(out["summary"]["overflow"] == 0,
              f"--layers 2 {backend}: overflow")
        log(f"--layers 2 {backend}: launches {counts} over 160 stream steps, "
            f"first window {losses[0]:.6f}, final loss {losses[-1]:.6f}, "
            f"median window {out['summary']['median_window_ms']:.3f} ms, "
            f"carry {out['carry_bytes']} bytes, row stats "
            f"{out.get('row_stats')}")
    l_ref = runs["compact"]["windows"][0]["loss"]
    for backend, out in runs.items():
        l_b = out["windows"][0]["loss"]
        tol = BF16_STEP if "bf16" in backend else F32_REL
        check(abs(l_b - l_ref) <= tol * abs(l_ref),
              f"--layers 2 first window loss: {backend} {l_b} vs compact "
              f"{l_ref}")
    # first-window gradients against both oracles, on the card
    first = {}
    for layers, backends in ((2, ("compact_fused", "pallas")),
                             (3, ("compact_fused",))):
        for backend in backends:
            first[layers, backend] = stacked_window(torch, TRAIN, ON, backend,
                                                    layers)
        _, _, _, run, xs, label = first[layers, "compact_fused"]
        oracles = stacked_oracles(torch, BP, RT, ST, run, xs, label)
        for oname, (lo, go) in oracles.items():
            for backend in backends:
                lb, gb = first[layers, backend][:2]
                check(abs(lb - lo) <= F32_REL * abs(lo),
                      f"--layers {layers} first window loss {backend} {lb} "
                      f"vs {oname} {lo}")
                compare_grads(ST.apply_stacked_masks(gb, run["masks"]), go,
                              f"--layers {layers} {backend} vs {oname}")
    _, _, stats2, run2, _, _ = first[2, "compact_fused"]
    # (s2) --layers 3 compact_fused
    reset_counts()
    out3 = TRAIN.main(main_argv("compact_fused", "--layers", "3",
                                "--ckpt-every", "0"))
    counts = read_counts()
    check_counts(counts, {"compact_fused": 480}, "--layers 3 compact_fused")
    check(out3["summary"]["overflow"] == 0, "--layers 3: overflow")
    check(all(math.isfinite(w["loss"]) for w in out3["windows"]),
          "--layers 3: non-finite loss")
    log(f"--layers 3 compact_fused: launches {counts} over "
        f"{out3['final_step']} stream steps, median window "
        f"{out3['summary']['median_window_ms']:.3f} ms, carry "
        f"{out3['carry_bytes']} bytes, row stats {out3.get('row_stats')}")
    # (s3) K1 and K2 against their plain versions at stacked operands
    k1_ops, fl = stacked_layer_operands(torch, TRAIN, SP, CF, ON,
                                        "compact_fused")
    B, K, Pc = k1_ops[1][1].shape
    log(f"K1 stacked layer 1: B={B} K={K} Pc_pad={Pc} (Pc {fl._cl.Pc}), "
        f"count_new {k1_ops[1][6].tolist()}, count_prev "
        f"{k1_ops[1][7].tolist()}")
    err_k1 = compare_k1(torch, CF, k1_ops[1], "stacked layer 1 f32")
    compare_k1(torch, CF, with_carry_dtype(torch, k1_ops[1], torch.bfloat16),
               "stacked layer 1 bf16")
    compare_k1(torch, CF, k1_ops[0], "stacked layer 0 f32")
    k2_ops, _ = stacked_layer_operands(torch, TRAIN, SP, CF, ON, "pallas")
    err_k2, k2_pad = compare_k2(torch, IN, OPS, k2_ops[1],
                                "stacked layer 1")
    _, k2_pad0 = compare_k2(torch, IN, OPS, k2_ops[0], "stacked layer 0")
    live_blocks = [int((ops[6] != 0).sum()) for ops in (k2_pad0, k2_pad)]
    n_blocks = k2_pad[6].numel()
    check(live_blocks[0] < live_blocks[1] <= n_blocks,
          f"K2 stacked: column blocks live at layer 0 / 1: {live_blocks} "
          f"of {n_blocks}")
    log(f"K2 stacked: column blocks executed at layer 0 {live_blocks[0]}, "
        f"layer 1 {live_blocks[1]}, of {n_blocks} (layer 0 skips the "
        f"blocks of layer 1's columns)")
    t1 = time_k1(torch, CF, CK, k1_ops[1], 500, 100)
    t2 = time_k2(torch, IN, k2_pad, 500, 100, host=False)
    for name, t in (("K1 stacked layer 1", t1), ("K2 stacked layer 1", t2)):
        log(f"{name} time: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, baddbmm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} "
            f"ms ({t['bound_by']}); in turn kernel {t['alt_ms']:.4f} ms, "
            f"baddbmm {t['alt_library_ms']:.4f} ms; device {t['device_us']} "
            f"us, baddbmm {t['library_device_us']} us")
    # (s4) crash and resume at --layers 2
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_stacked_"))
    try:
        for backend, kernel in (("compact_fused", "compact_fused"),
                                ("pallas", "influence")):
            crash_and_resume(torch, TRAIN, CKP,
                             main_argv(backend, *lay2, "--ckpt-every", "5"),
                             kernel, root / f"on-{backend}",
                             f"--layers 2 online {backend}", layers=2)
        _, off, _ = crash_and_resume(
            torch, TRAIN, CKP, offline_argv("compact_fused", *lay2,
                                            "--ckpt-every", "5"),
            "compact_fused", root / "off", "--layers 2 offline compact_fused",
            layers=2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    firsts = {}
    for backend in ("compact", "compact_fused"):
        run = TRAIN.build_offline(TRAIN.parse_args(offline_argv(backend,
                                                                *lay2)))
        xs, ys = run["data_at"](0)
        loss, grads, _ = run["loss_and_grads"](run["params"], xs, ys)
        firsts[backend] = (float(loss), grads)
    (lc, gc), (lf, gf) = firsts["compact"], firsts["compact_fused"]
    check(abs(lf - lc) <= F32_REL * abs(lc),
          f"--layers 2 offline first step compact_fused {lf} vs compact {lc}")
    compare_grads(gf, gc, "--layers 2 compact_fused vs compact (cuda)",
                  "offline first-step gradients")
    log(f"--layers 2 offline compact_fused: median step "
        f"{off['summary']['median_step_ms']:.3f} ms (17 stream steps x 2 "
        f"layers and the update)")
    # (s5) where the time goes, and what the update costs at the measured
    # activity
    for backend, out in runs.items():
        log(f"--layers 2 {backend}: median window "
            f"{out['summary']['median_window_ms']:.3f} ms")
    trace_main_path(torch, TRAIN, ON, "compact_fused", "fused_update_kernel",
                    *lay2)
    trace_main_path(torch, TRAIN, ON, "pallas", "influence_kernel", *lay2)
    sl = ST.stacked_layout(run2["cfg"])
    betas = stats2["beta_layers"].mean(dim=0).tolist()
    betas_prev = stats2["beta_prev"].mean(dim=0).tolist()
    omegas = [1.0 - ST.stacked_omega_tilde([m]) for m in run2["masks"]]
    acc = CO.stacked_influence_update_flops(
        run2["cfg"].layer_sizes, [lay.P for lay in sl.layers], betas,
        betas_prev, omegas)
    log(f"costs.stacked_influence_update_flops (--layers 2, first window's "
        f"measured beta {[round(b, 4) for b in betas]}, beta_prev "
        f"{[round(b, 4) for b in betas_prev]}, omega "
        f"{[round(o, 4) for o in omegas]}): dense {acc['dense']:.0f}, sparse "
        f"{acc['sparse']:.0f} FLOP a stream step, savings "
        f"{acc['savings']:.5f}")
    # (s6) the stacked path's numbers for the kernels line
    entries["compact_fused"] = {
        "path": "stacked --layers 2 / 3 (one launch a layer a stream step)",
        "launches": {"--layers 2": 320, "--layers 3": 480},
        "max_abs_err": err_k1, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
        "library_ms": t1["library_ms"]}
    entries["influence"] = {
        "path": "stacked --layers 2 (one launch a layer a stream step)",
        "launches": {"--layers 2": 320}, "max_abs_err": err_k2,
        "ms": t2["ms"], "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
        "library_ms": t2["library_ms"]}
    return entries


# ---------------------------------------------------------------------------
# phase 9: dynamic sparsity and the stream guard
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def observe_trainers(ON):
    """Record every OnlineTrainer that runs (under "trainers") and, at each
    rewire event, the trainer, its update and stream step and the carry
    right after the event, with every W/R tensor's live count before and
    after it (under "events").  Host work only; no kernel launches."""
    seen = {"trainers": [], "events": []}
    run0, rewire0 = ON.OnlineTrainer.run, ON.OnlineTrainer._maybe_rewire

    def live_counts(carry):
        masks = carry["rw"]["masks"]
        masks = masks if isinstance(masks, tuple) else (masks,)
        return [int(mk[g][t].sum()) for mk in masks
                for g in ("u", "r", "z") for t in ("W", "R")]

    def run(self):
        seen["trainers"].append(self)
        return run0(self)

    def maybe_rewire(self):
        before = live_counts(self.carry) if self.rewire_schedule else None
        rec = rewire0(self)
        if rec:
            seen["events"].append({
                "trainer": self, "update": self.update, "step": self.step,
                "carry": self.carry, "before": before,
                "after": live_counts(self.carry), **rec})
        return rec

    ON.OnlineTrainer.run, ON.OnlineTrainer._maybe_rewire = run, maybe_rewire
    try:
        yield seen
    finally:
        ON.OnlineTrainer.run, ON.OnlineTrainer._maybe_rewire = run0, rewire0


def observed_run(TRAIN, ON, argv):
    """A launcher run with every kernel's count set to 0 just before and
    read just after, its trainers and rewire events observed."""
    with observe_trainers(ON) as seen:
        out, counts = run_counted(TRAIN, argv)
    return out, counts, seen


def rewire_argv(backend="pallas", *extra):
    return main_argv(backend, "--ckpt-every", "0", "--rewire", "rigl",
                     "--rewire-every", "2", "--rewire-frac", "0.3", *extra)


def k2_event_operands(torch, SP, ST, learner, carry, x):
    """K2's unpadded operands of every layer at the first stream step after
    an event: (hp, J-hat, M, M-bar, jmask, col_mask) with the J pattern of
    the carry's (new) masks and the carry axis's column liveness.  Also
    checks that the learner's constant block masks, re-derived at the
    event, equal those of the new masks."""
    from repro_torch.core import cells as Cc
    from repro_torch.kernels import ops as OPS
    inner = getattr(learner, "inner", None)
    out = []
    if inner is not None:
        inner._sync(carry)
        jm = SP.flat_jmask(inner.cfg, carry["rw"]["masks"])
        _, _, ops = SP.pallas_step_operands(
            inner.cfg, Cc.rec_param_tree(carry["params"]), inner.layout,
            carry["a"], carry["M"], x, cl=inner._cl, col_mask=inner._colm,
            jmask=jm)
        want = OPS.constant_block_masks(inner.cfg.n_hidden,
                                        carry["M"].shape[-1], jm,
                                        inner._colm, device=x.device)
        check(all(torch.equal(a, b) for a, b in zip(inner._kmasks, want)),
              "K2 block masks not re-derived from the event's masks")
        return [list(ops)]
    learner._sync(carry)
    ws, sl, below, inp = carry["params"]["layers"], learner.slayout, None, x
    for l in range(learner.cfg.n_layers):
        lcfg, jm = learner.lcfgs[l], carry["rw"]["jms"][l]
        check(torch.equal(jm, SP.flat_jmask(lcfg, carry["rw"]["masks"][l])),
              f"layer {l}: the carry's J pattern is not the masks'")
        inp, _, ops = SP.pallas_step_operands(
            lcfg, ws[l], sl.layers[l], carry["a"][l], carry["M"][l], inp,
            cl=learner._cl, col_mask=learner._klives[l], jmask=jm, layer=l,
            offset=sl.offsets[l], total_pad=sl.P_pad, M_below=below)
        want = OPS.constant_block_masks(lcfg.n_hidden,
                                        carry["M"][l].shape[-1], jm,
                                        learner._klives[l], device=x.device)
        check(all(torch.equal(a, b) for a, b in
                  zip(learner._kmasks[l], want)),
              f"K2 layer {l} block masks not re-derived from the event's "
              "masks")
        below = ops[0][:, :, None] * (torch.bmm(ops[1], ops[2]) + ops[3])
        out.append(list(ops))
    return out


def check_rewire_run(torch, TRAIN, ON, SP, ST, IN, OPS, MG, argv, label,
                     layers=1):
    """(d1)/(d2): one rewired pallas run on the card.  K2 160 a layer, 10
    events, every W/R tensor's live count and Pc unchanged at every event,
    finite losses; at the first step after each event K2's executed-block
    counter equal to realized_block_savings of the new masks times the
    blocks; from the carry right after event 0 one window against the dense
    restart oracle.  Returns (out, counts, seen, worst K2 error, event-0
    operands of the last layer)."""
    import numpy as np
    out, counts, seen = observed_run(TRAIN, ON, argv)
    check_counts(counts, {"influence": 160 * layers}, label)
    events = seen["events"]
    check(out["rewire_events"] == len(events) == 10,
          f"{label}: {out['rewire_events']} rewire events, expected 10")
    check(all(e["before"] == e["after"] for e in events),
          f"{label}: a tensor's live count changed at an event")
    losses = [w["loss"] for w in out["windows"]]
    check(all(math.isfinite(v) for v in losses),
          f"{label}: non-finite loss {losses}")
    learner = events[0]["trainer"].learner
    cl = getattr(learner, "inner", learner)._cl
    stream, dev = events[0]["trainer"].stream, events[0]["trainer"].device
    worst, first_ops = 0.0, None
    for i, e in enumerate(events):
        x = torch.from_numpy(np.ascontiguousarray(
            stream(e["step"])[0])).to(dev)
        for l, ops in enumerate(k2_event_operands(torch, SP, ST, learner,
                                                  e["carry"], x)):
            err, padded = compare_k2(torch, IN, OPS, ops,
                                     f"{label} event {i} layer {l}",
                                     quiet=True)
            worst = max(worst, err)
            if i == 0:
                first_ops = padded
    pc = None if cl is None else cl.Pc
    if layers == 1 and cl is not None:
        check(pc == 244, f"{label}: Pc {pc}, expected 244")
    # the window after event 0 against the dense restart oracle
    e0 = events[0]
    xs, ys = zip(*(stream(e0["step"] + t) for t in range(8)))
    xs = torch.from_numpy(np.stack(xs)).to(dev)
    ys = torch.from_numpy(np.stack(ys)).to(dev)
    oracle, oc = MG.restart_oracle(learner, e0["carry"])
    _, loss, grads, _ = ON.stream_grads(learner, e0["carry"], xs, ys)
    _, oloss, ograds, _ = ON.stream_grads(oracle, oc, xs, ys)
    check(abs(float(loss) - float(oloss)) <= F32_REL * abs(float(oloss)),
          f"{label}: window after event 0 loss {float(loss)} vs the restart "
          f"oracle's {float(oloss)}")
    compare_grads(grads, ograds, f"{label} vs the dense restart oracle",
                  "window after event 0")
    ms = [e["rewire_ms"] for e in events]
    log(f"{label}: launches {counts}, {len(events)} events at updates "
        f"{[e['update'] for e in events]}, live counts kept "
        f"{events[0]['after']}, Pc {pc}, K2 after every event equal to its "
        f"plain version (worst {worst:.3e}) with executed blocks = "
        f"realized_block_savings x blocks of the new masks, rewire_ms median "
        f"{statistics.median(ms):.2f} (min {min(ms):.2f}, max {max(ms):.2f}), "
        f"carry_live_bytes after the events "
        f"{[e['carry_live_bytes'] for e in events][:3]}..., median window "
        f"{out['summary']['median_window_ms']:.3f} ms")
    return out, counts, seen, worst, first_ops


def rewire_breakdown(torch, DS, SP, learner, carry, reps=5):
    """The ms of one single-layer RigL event on the card in its four parts,
    each ended by a device sync, the median of `reps`: the dense scoring
    gradient, the host selection (its copies to the host included), the
    migration (new layout, plan, gathers, old-then-new param masking) and
    the learner's re-derivation of its block masks."""
    from repro_torch.core import cells as Cc
    inner = learner.inner
    inner._sync(carry)
    parts = {"scoring": [], "host selection": [], "migration": [],
             "block-mask rebuild": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = inner._rigl_scores(carry)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        old = carry["rw"]["masks"]
        new = DS.rewire_masks(old, Cc.rec_param_tree(carry["params"]), grads,
                              frac=0.3, key=(0, 0), method="rigl")
        t2 = time.perf_counter()
        params = SP.apply_masks(SP.apply_masks(carry["params"], old), new)
        new_cl = SP.col_layout(inner.layout, new, device=carry["M"].device)
        plan = DS.migration_plan(inner._cl, new_cl)
        M = DS.migrate_influence(inner._cl, new_cl, carry["M"], plan)
        gw = DS.migrate_influence(inner._cl, new_cl, carry["gw"], plan)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rw = dict(carry["rw"], masks=new, jmask=SP.flat_jmask(inner.cfg, new),
                  cl={f: getattr(new_cl, f) for f in
                      ("src", "layer", "gate", "q", "j", "live")})
        inner._bind(rw)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        inner._bind(carry["rw"])
        del params, M, gw
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(dt * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def guard_phase_runs(torch, TRAIN, ON, argv_extra, label, want_k1):
    """One guarded compact_fused run (observed, counted)."""
    out, counts, seen = observed_run(
        TRAIN, ON, main_argv("compact_fused", "--ckpt-every", "0", "--guard",
                             *argv_extra))
    check_counts(counts, {"compact_fused": want_k1}, label)
    check(out["final_step"] == 160, f"{label}: {out['final_step']} steps")
    return out, counts, seen["trainers"][-1]


def final_params(tr):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tr.learner.params_of(tr.carry))


def bitwise(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def dynamic_phase(torch, TRAIN, ON, CKP, SP, ST, CF, CK, IN, OPS):
    """(d1)-(d4) dynamic sparsity and (g1)-(g4) the stream guard on the
    card, then (c) their costs.  Returns the "rewire" entry of K2's record
    and the "guard" entry of K1's, for the kernels line, and (g2)'s result
    and trainer (phase 10 holds its instrumented run against them)."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import sparsity as DS
    from repro_torch.runtime import guard as G
    from repro_torch.sparsity import migrate as MG
    launches = {}
    # (d1) rewire, one layer: rigl, set, and rigl at full width
    d1 = {}
    for name, extra in (("rigl", ()), ("set", ()),
                        ("rigl full width", ("--col-compact", "off"))):
        argv = rewire_argv("pallas", *extra)
        if name == "set":
            argv[argv.index("rigl")] = "set"
        d1[name] = check_rewire_run(torch, TRAIN, ON, SP, ST, IN, OPS, MG,
                                    argv, f"(d1) rewire {name}")
        launches[f"d1 {name}"] = d1[name][1]["influence"]
    full = d1["rigl full width"][4]
    check(full[2].shape[-1] == 1024, f"(d1) full width P_pad "
                                     f"{full[2].shape[-1]}, expected 1024")
    # (d2) rewire, stacked
    d2 = check_rewire_run(torch, TRAIN, ON, SP, ST, IN, OPS, MG,
                          rewire_argv("pallas", "--layers", "2"),
                          "(d2) rewire --layers 2", layers=2)
    launches["d2 --layers 2"] = d2[1]["influence"]
    # (d3) crash and resume across events
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_rewire_"))
    try:
        argv = main_argv("pallas", "--ckpt-every", "5", "--rewire", "rigl",
                         "--rewire-every", "3")
        a, b, tree = crash_and_resume(torch, TRAIN, CKP, argv, "influence",
                                      root, "(d3) rewire rigl pallas")
        check(a["rewire_events"] == b["rewire_events"] == 6,
              f"(d3) rewire events {a['rewire_events']} / "
              f"{b['rewire_events']}")
        launches["d3 crashed"], launches["d3 uncrashed"] = 176, 160
        log(f"(d3) rewire_events {a['rewire_events']} / {b['rewire_events']};"
            f" the final checkpoints' masks, layout and J pattern among the "
            f"bitwise leaves")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # (d4) the refusal, before any launch
    reset_counts()
    try:
        TRAIN.main(main_argv("compact_fused", "--ckpt-every", "0",
                             "--rewire", "rigl"))
    except SystemExit as e:
        msg = str(e)
    else:
        raise SmokeFailure("(d4) --rewire with compact_fused ran")
    check("not supported with the compact_fused backend" in msg,
          f"(d4) refusal message: {msg}")
    check_counts(read_counts(), {}, "(d4) refusal")
    log(f"(d4) refused before any launch: {msg}")
    # (g1) guard, healthy, against the unguarded run of the same argv
    plain, counts_p, seen_p = observed_run(
        TRAIN, ON, main_argv("compact_fused", "--ckpt-every", "0"))
    check_counts(counts_p, {"compact_fused": 160}, "(g1) unguarded")
    g1, c1, t1 = guard_phase_runs(torch, TRAIN, ON, (), "(g1) guard healthy",
                                  160)
    l_plain = [w["loss"] for w in plain["windows"]]
    l_g1 = [w["loss"] for w in g1["windows"]]
    check(l_g1 == l_plain, "(g1) guarded window losses differ from the "
                           "unguarded run's")
    check(bitwise(torch, final_params(t1), final_params(seen_p["trainers"][-1])),
          "(g1) guarded final params differ from the unguarded run's")
    check(g1["guard"]["faults"] == 0, f"(g1) faults {g1['guard']}")
    log(f"(g1) guard healthy: launches {c1}, 20 window losses and the final "
        f"params bitwise the unguarded run's, faults 0")
    # (g2) guard, corrupted carry
    g2, c2, t2 = guard_phase_runs(torch, TRAIN, ON,
                                  ("--inject-corrupt-at", "6"),
                                  "(g2) guard corrupted carry", 168)
    rep = g2["guard"]
    check((rep["faults"], rep["rollbacks"]) == (1, 1)
          and rep["recoveries"] == [{"step": 48, "action": "replay",
                                     "attempts": 1}],
          f"(g2) guard report {rep}")
    check([w["loss"] for w in g2["windows"]] == l_g1,
          "(g2) window losses differ from (g1)'s")
    check(bitwise(torch, final_params(t2), final_params(t1)),
          "(g2) final params differ from (g1)'s")
    log(f"(g2) corrupt carry after update 6: launches {c2}, faults 1, "
        f"rollbacks 1, recovery {rep['recoveries']}, window losses and final "
        f"params bitwise (g1)'s")
    # (g3) guard, NaN inputs at stream steps 40-47 (window 5)
    g3, c3, t3 = guard_phase_runs(torch, TRAIN, ON,
                                  ("--inject-nan-at", "40", "--inject-nan-len",
                                   "8"), "(g3) guard NaN inputs", 184)
    rep = g3["guard"]
    ladder = [f["attempt"] for f in rep["fault_log"]]
    check(ladder == [1, 2, 3, 4] and all(f["step"] == 40
                                         for f in rep["fault_log"])
          and rep["recoveries"] == [{"step": 40, "action": "quarantine",
                                     "attempts": 4}]
          and rep["quarantined"] == [{"start": 40, "len": 8, "update": 5}],
          f"(g3) guard report {rep}")
    after = [w["loss"] for w in g3["windows"] if w["update"] > 6]
    check(len(after) == 14 and all(math.isfinite(v) for v in after),
          f"(g3) losses after the quarantine {after}")
    check(all(bool(torch.isfinite(p).all()) for p in final_params(t3)),
          "(g3) non-finite final params")
    log(f"(g3) NaN inputs at steps 40-47: launches {c3}, ladder replay -> "
        f"clip -> skip_update -> quarantine ({[f['reason'] for f in rep['fault_log']]}), "
        f"quarantined {rep['quarantined']}, 14 finite losses after it")
    # (g4) guard with rewire, pallas
    g4_argv = main_argv("pallas", "--ckpt-every", "0", "--guard", "--rewire",
                        "rigl", "--rewire-every", "2")
    clean, cc, sc = observed_run(TRAIN, ON, g4_argv)
    g4, c4, s4 = observed_run(TRAIN, ON, [*g4_argv, "--inject-corrupt-at",
                                          "5"])
    check_counts(cc, {"influence": 160}, "(g4) clean")
    check_counts(c4, {"influence": 168}, "(g4) corrupted")
    ev_c = [e["carry"]["rw"]["masks"] for e in sc["events"]]
    ev_4 = [e["carry"]["rw"]["masks"] for e in s4["events"]]
    from repro_torch.tree import tree_leaves
    check(len(ev_c) == len(ev_4) == 10 and all(
        bitwise(torch, tree_leaves(a), tree_leaves(b))
        for a, b in zip(ev_c, ev_4)), "(g4) masks differ at an event")
    check(bitwise(torch, final_params(s4["trainers"][-1]),
                  final_params(sc["trainers"][-1])),
          "(g4) final params differ from the clean run's")
    check(g4["guard"]["rollbacks"] == 1, f"(g4) guard {g4['guard']}")
    log(f"(g4) guard + rewire, corrupt after update 5: launches {c4} (clean "
        f"{cc}), masks at all 10 events and the final params bitwise the "
        f"clean run's, rollbacks 1")
    # (c) costs
    alt = {"unguarded": [], "guarded": []}
    for _ in range(3):
        for name, extra in (("unguarded", ()), ("guarded", ("--guard",))):
            out = TRAIN.main(main_argv("compact_fused", "--ckpt-every", "0",
                                       *extra))
            alt[name].append(out["summary"]["median_window_ms"])
    log(f"(c) median window compact_fused, 3 runs in turn: unguarded "
        f"{[round(v, 3) for v in alt['unguarded']]} ms, guarded "
        f"{[round(v, 3) for v in alt['guarded']]} ms (medians "
        f"{statistics.median(alt['unguarded']):.3f} / "
        f"{statistics.median(alt['guarded']):.3f})")
    tr_plain = trace_main_path(torch, TRAIN, ON, "compact_fused",
                               "fused_update_kernel")
    tr_guard = trace_main_path(torch, TRAIN, ON, "compact_fused",
                               "fused_update_kernel", "--guard")
    if tr_plain and tr_guard:
        log(f"(c) device ops a stream step: unguarded "
            f"{tr_plain['ops_per_step']:.1f}, guarded "
            f"{tr_guard['ops_per_step']:.1f} (the guard adds "
            f"{tr_guard['ops_per_step'] - tr_plain['ops_per_step']:.1f}); "
            f"device busy {tr_plain['busy_us'] / 16:.1f} / "
            f"{tr_guard['busy_us'] / 16:.1f} us a step")
    rigl = d1["rigl"]
    ev0 = rigl[2]["events"][0]
    parts = rewire_breakdown(torch, DS, SP, ev0["trainer"].learner,
                             ev0["carry"])
    ms = [e["rewire_ms"] for e in rigl[2]["events"]]
    log(f"(c) rewire_ms of (d1) rigl: median {statistics.median(ms):.2f} ms "
        f"over 10 events; one event split (median of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
    guard = G.StreamGuard(G.GuardConfig())
    pushes = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        guard.push(t1)
        torch.cuda.synchronize()
        pushes.append((time.perf_counter() - t0) * 1e6)
    snap_bytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(guard.ring[-1].tree)
                     if isinstance(x, torch.Tensor))
    log(f"(c) snapshot push (clone of the checkpoint tree, {snap_bytes} "
        f"bytes on the card): median {statistics.median(pushes):.1f} us "
        f"(min {min(pushes):.1f}) with the sync")
    run0 = TRAIN.build_online(TRAIN.parse_args(rewire_argv("pallas")))
    fresh = TRAIN.online_trainers(TRAIN.parse_args(rewire_argv("pallas")),
                                  run0)(0)
    live0 = fresh.carry_nbytes()
    live = [e["carry_live_bytes"] for e in rigl[2]["events"]]
    log(f"(c) carry_live_bytes (d1) rigl: before the events {live0['live']} "
        f"(alloc {live0['alloc']}), after each event {live}")
    # the kernels line's entries: K2 after an event, K1 on a replayed carry
    t_k2 = time_k2(torch, IN, rigl[4], 500, 100, host=False)
    snap = t2.guard._ready(t2.guard.ring[-1])
    carry = snap.tree["carry"]
    lcfg = t2.learner.inner.cfg
    layout = SP.flat_layout(lcfg)
    x = torch.from_numpy(np.ascontiguousarray(
        t2.stream(snap.step)[0])).to(t2.device)
    _, _, k1_ops, _ = SP.fused_step_operands(
        lcfg, {k: v for k, v in carry["params"].items() if k != "out"},
        layout, carry["a"], carry["vals"], carry["idx"], x,
        cl=t2.learner.inner._cl)
    err_k1 = compare_k1(torch, CF, list(k1_ops),
                        "(g2) after the rollback and replay")
    t_k1 = time_k1(torch, CF, CK, list(k1_ops), 500, 100)
    for name, t in (("K2 after event 0", t_k2), ("K1 on the replayed carry",
                                                  t_k1)):
        log(f"{name} time: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}"
            f" ms, baddbmm {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}); in turn kernel "
            f"{t['alt_ms']:.4f} ms, baddbmm {t['alt_library_ms']:.4f} ms")
    worst_k2 = max(d1[n][3] for n in d1)
    worst_k2 = max(worst_k2, d2[3])
    rewire_entry = {
        "path": "--rewire rigl/set --rewire-every 2, pallas, col-compact and "
                "full width, --layers 1 and 2; crash and resume across "
                "events (K2 at the first step after each event)",
        "launches": launches, "max_abs_err": worst_k2,
        "ms": t_k2["ms"], "plain_ms": t_k2["plain_ms"],
        "bound_ms": t_k2["bound_ms"], "bound_by": t_k2["bound_by"],
        "library_ms": t_k2["library_ms"]}
    guard_entry = {
        "path": "--guard compact_fused: healthy, corrupted carry (one "
                "window replayed), NaN inputs (ladder to quarantine)",
        "launches": {"g1 healthy": c1["compact_fused"],
                     "g2 corrupt": c2["compact_fused"],
                     "g3 nan": c3["compact_fused"]},
        "max_abs_err": err_k1, "ms": t_k1["ms"], "plain_ms": t_k1["plain_ms"],
        "bound_ms": t_k1["bound_ms"], "bound_by": t_k1["bound_by"],
        "library_ms": t_k1["library_ms"]}
    return rewire_entry, guard_entry, (g2, t2)


# ---------------------------------------------------------------------------
# phase 10: the telemetry plane
# ---------------------------------------------------------------------------

# the packed fields a window event carries on each path (the rest pack NaN
# there and are dropped): K1's compact carry has K_b and overflow, K2's
# rewirable carry the live column fraction
K1_FIELDS = ("loss", "grad_norm", "act_sparsity", "bwd_sparsity", "overflow",
             "kb_min", "kb_mean", "kb_max", "clip_factor", "health")
K2_REWIRE_FIELDS = ("loss", "grad_norm", "act_sparsity", "bwd_sparsity",
                    "live_col_frac", "clip_factor", "health")


def validated_dir(d, label):
    """`python -m repro_torch.obs.validate d` (its main, in process) must
    pass; returns the manifest."""
    from repro_torch.obs import validate as VAL
    check(VAL.main([str(d)]) == 0,
          f"{label}: {d} fails the validator: {VAL.validate_dir(d)}")
    return json.loads((Path(d) / "manifest.json").read_text())


def window_events(d):
    from repro_torch.obs import read_events
    evs = read_events(Path(d) / "events.jsonl")
    return evs, [e for e in evs if e["kind"] == "window"]


def check_window_fields(wins, fields, label):
    for w in wins:
        have = {f for f in fields if isinstance(w.get(f), (int, float))}
        check(have == set(fields), f"{label}: window {w.get('update')} "
                                   f"lacks {sorted(set(fields) - have)}")
        check(all(math.isfinite(w[f]) for f in fields),
              f"{label}: non-finite field in window {w}")


def device_ops(torch, fn, calls=5):
    """Device ops (kernels, copies, fills) per call of fn, torch.profiler
    over `calls` calls; None where the profiler records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n / calls if n else None


def peak_and_ms(torch, fn, iters=20):
    """Bytes the call allocates at its peak beyond what was allocated
    before it (torch.cuda.max_memory_allocated), and its mean ms."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return peak, time_ms(torch, fn, iters)


def guard_check_costs(torch, carry):
    """(c): the peak bytes, ms and device ops of one health check (of the
    tree as a carry) and one clip norm on the main path's carry, held as a
    regression guard: neither may copy the tree (peak under an eighth of
    its floating bytes) or grow past 16 (check) and 8 (norm) device ops;
    on an H100 they take 10.2 and 3.2 (PERF.md)."""
    from repro_torch.obs.metricpack import global_norm
    from repro_torch.runtime import guard as G
    from repro_torch.tree import tree_leaves
    loss = torch.zeros((), device="cuda")
    floats = [x for x in tree_leaves(carry)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    nbytes = sum(x.numel() * x.element_size() for x in floats)
    row = {"tree_bytes": nbytes}
    for name, fn, max_ops in (
            ("check", lambda: G.health_bits(loss, {}, carry), 16),
            ("norm", lambda: global_norm(floats), 8)):
        peak, ms = peak_and_ms(torch, fn)
        ops = device_ops(torch, fn)
        row[name] = [peak, ms, ops]
        check(peak * 8 < nbytes, f"(c) guard {name}: peak {peak} B on a "
                                 f"{nbytes} B tree (a copy of the tree?)")
        check(ops is None or ops <= max_ops,
              f"(c) guard {name}: {ops} device ops (at most {max_ops})")
    log(f"(c) guard checks, main path carry ({nbytes} bytes of floating "
        "leaves): " + ", ".join(
            f"{k} {v[0]} B peak {v[1]:.4f} ms {v[2]} device ops"
            for k, v in row.items() if k != "tree_bytes"))
    return row


def pack_host_costs(torch, TRAIN, ON, root):
    """(c): host µs of the window's metric paths on a real compact_fused
    window on the card — the pack's device ops issued (`pack`), the bare
    metrics' reductions, the readback of each (`unpack`, `scalar_metrics`,
    each waiting for the device) and `record_window` with its event
    write."""
    from repro_torch.obs import MetricPack, Telemetry
    from repro_torch.runtime.trainer import scalar_metrics
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("compact_fused")))
    xs, ys = stream_window(torch, run, 8)
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    carry, loss, grads, stats = ON.stream_grads(run["learner"], carry, xs, ys)
    pack = MetricPack.default()
    env = {"loss": loss, "grads": grads, "stats": stats, "carry": carry}

    def bare_metrics():
        m = {"loss": loss, "alpha": stats["alpha"].mean(),
             "beta": stats["beta"].mean(),
             "overflow": stats["overflow"].max()}
        return m

    vec, m = pack.pack(env), bare_metrics()
    obs = Telemetry.create(root / "host")
    pk = pack.unpack(vec)
    got = {"pack": host_us(torch, lambda: pack.pack(env), iters=500),
           "bare metrics": host_us(torch, bare_metrics, iters=500),
           "unpack": host_us(torch, lambda: pack.unpack(vec), iters=500),
           "scalar_metrics": host_us(torch, lambda: scalar_metrics(m),
                                     iters=500),
           "record_window": host_us(torch, lambda: obs.record_window(
               1, 8, 1.0, packed=pk), iters=500)}
    obs.finalize()
    log("(c) host us a call (the device drained before each batch): " +
        ", ".join(f"{k} {v:.1f}" for k, v in got.items()))
    return got


def pack_window_ab(torch, TRAIN, ON, root, Telemetry, windows=80):
    """(c): the pack's cost inside the timed window, free of the host's
    drift between runs: one instrumented compact_fused trainer whose
    windows take the packed path and the bare one in turn (the order
    flipped every pair; the pack only observes, so the run is the same
    either way).  Returns the window ms of each path."""
    import types
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("compact_fused")))
    obs = Telemetry.create(root / "ab")
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=windows * 8, update_every=8),
        run["learner"], run["opt"], run["params"], run["masks"],
        run["stream"], device=run["device"], telemetry=obs)
    pack, execute = tr._pack, tr._execute_window

    def toggled(self, start, k):
        pair, second = divmod(self.update, 2)
        self._pack = pack if (pair + second) % 2 else None
        return execute(start, k)

    tr._execute_window = types.MethodType(toggled, tr)
    tr.run()
    obs.finalize()
    ms = {"bare": [], "packed": []}
    for w in tr.windows[2:]:                 # the first pair warms up
        u = w["update"] - 1
        ms["packed" if (u // 2 + u % 2) % 2 else "bare"].append(w["ms"])
    diff = [p - b for b, p in zip(ms["bare"], ms["packed"])]
    log(f"(c) packed and bare windows in turn in one instrumented run "
        f"({len(diff)} pairs): median {statistics.median(ms['bare']):.3f} / "
        f"{statistics.median(ms['packed']):.3f} ms; packed minus bare "
        f"within each pair: median {statistics.median(diff):.3f} ms, "
        f"quartiles {[round(v, 3) for v in statistics.quantiles(diff)]}, "
        f"{sum(d > 0 for d in diff)} of {len(diff)} positive")
    return ms


def telemetry_phase(torch, TRAIN, ON, g2):
    """(t1)-(t3): the main path with `--metrics-dir` (and `--trace`) against
    the same runs without, with K1, K2, rewire events and the guard; (c)
    the costs.  (t4), the serving path's directory, runs in phase 7.
    Every run with the counts set to 0 just before and read just after;
    the directories are made under a temporary root, removed at the end.
    Returns the "telemetry" entries of K1's and K2's records."""
    import shutil
    import tempfile
    from repro_torch.obs import Telemetry
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    try:
        return _telemetry_checks(torch, TRAIN, ON, g2, root, Telemetry)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _telemetry_checks(torch, TRAIN, ON, g2, root, Telemetry):
    launches = {"compact_fused": {}, "influence": {}}
    # (t1) compact_fused with --metrics-dir --trace against the bare run
    base = main_argv("compact_fused", "--ckpt-every", "0")
    d1 = root / "t1"
    bare, cb, sb = observed_run(TRAIN, ON, base)
    inst, ci, si = observed_run(TRAIN, ON, [*base, "--metrics-dir", str(d1),
                                            "--trace"])
    check_counts(cb, {"compact_fused": 160}, "(t1) bare")
    check_counts(ci, {"compact_fused": 160}, "(t1) --metrics-dir --trace")
    t_bare, t_inst = sb["trainers"][-1], si["trainers"][-1]
    check(t_inst._pack is not None and t_bare._pack is None,
          "(t1) the pack is not on the instrumented path only")
    losses = [w["loss"] for w in inst["windows"]]
    check(losses == [w["loss"] for w in bare["windows"]],
          "(t1) window losses differ from the bare run's")
    check(bitwise(torch, final_params(t_inst), final_params(t_bare)),
          "(t1) final params differ from the bare run's")
    validated_dir(d1, "(t1)")
    _, wins = window_events(d1)
    check(len(wins) == 20, f"(t1) {len(wins)} window events")
    check_window_fields(wins, K1_FIELDS, "(t1)")
    check([w["loss"] for w in wins] == losses,
          "(t1) the window events' losses are not the run's")
    check(all("live_col_frac" not in w for w in wins),
          "(t1) live_col_frac on a carry without rw")
    spans = json.loads((d1 / "trace.json").read_text())["traceEvents"]
    n_spans = [e["name"] for e in spans].count("window")
    check(n_spans == 20, f"(t1) {n_spans} window spans in trace.json")
    launches["compact_fused"].update({"t1 bare": cb["compact_fused"],
                                      "t1 telemetry": ci["compact_fused"]})
    log(f"(t1) compact_fused --metrics-dir --trace: launches {ci} (bare "
        f"{cb}), 20 window losses and the final params bitwise the bare "
        f"run's; validator clean; 20 window events with {list(K1_FIELDS)}; "
        f"20 window spans; last window {json.dumps(wins[-1])}")

    # (t2) pallas + rewire with --metrics-dir against the bare run
    rbase = rewire_argv("pallas")
    d2 = root / "t2"
    rbare, rcb, rsb = observed_run(TRAIN, ON, rbase)
    rinst, rci, rsi = observed_run(TRAIN, ON, [*rbase, "--metrics-dir",
                                               str(d2), "--trace"])
    check_counts(rcb, {"influence": 160}, "(t2) bare")
    check_counts(rci, {"influence": 160}, "(t2) --metrics-dir")
    check([w["loss"] for w in rinst["windows"]]
          == [w["loss"] for w in rbare["windows"]],
          "(t2) window losses differ from the bare run's")
    check(bitwise(torch, final_params(rsi["trainers"][-1]),
                  final_params(rsb["trainers"][-1])),
          "(t2) final params differ from the bare run's")
    validated_dir(d2, "(t2)")
    evs, wins = window_events(d2)
    rewires = [e for e in evs if e["kind"] == "rewire"]
    check(len(rewires) == 10 == rinst["rewire_events"],
          f"(t2) {len(rewires)} rewire events")
    check_window_fields(wins, K2_REWIRE_FIELDS, "(t2)")
    by_update = {w["update"]: w for w in wins}
    after = []
    for j, e in enumerate(evs):
        if e["kind"] != "rewire":
            continue
        nxt = next((w for w in evs[j + 1:] if w["kind"] == "window"), None)
        if nxt is None:                     # the event after the last window
            continue
        after.append(nxt["live_col_frac"])
        check(math.isfinite(nxt["live_col_frac"])
              and abs(nxt["live_col_frac"] - e["col_density"]) <= 1e-6,
              f"(t2) live_col_frac {nxt['live_col_frac']} after event "
              f"{e['event']} (col_density {e['col_density']})")
    check(len(after) == 9 and len(by_update) == 20,
          f"(t2) {len(after)} windows after an event")
    launches["influence"].update({"t2 bare": rcb["influence"],
                                  "t2 telemetry": rci["influence"]})
    log(f"(t2) pallas --rewire rigl --rewire-every 2 --metrics-dir: launches "
        f"{rci} (bare {rcb}), losses and final params bitwise; 10 rewire "
        f"events; live_col_frac after each event {after} (= the event's "
        f"col_density)")

    # (t3) the guard with a corrupted carry, against phase 9's (g2)
    g2_out, g2_tr = g2
    d3 = root / "t3"
    gout, gc, gs = observed_run(TRAIN, ON, main_argv(
        "compact_fused", "--ckpt-every", "0", "--guard",
        "--inject-corrupt-at", "6", "--metrics-dir", str(d3), "--trace"))
    check_counts(gc, {"compact_fused": 168}, "(t3) guard corrupt")
    check([w["loss"] for w in gout["windows"]]
          == [w["loss"] for w in g2_out["windows"]],
          "(t3) window losses differ from (g2)'s")
    check(bitwise(torch, final_params(gs["trainers"][-1]),
                  final_params(g2_tr)), "(t3) final params differ from (g2)'s")
    man = validated_dir(d3, "(t3)")
    evs, wins = window_events(d3)
    kinds = [e["kind"] for e in evs]
    check([kinds.count(k) for k in ("fault", "rollback", "recovery")]
          == [1, 1, 1], f"(t3) event kinds {kinds}")
    rep = gout["guard"]
    met = man["metrics"]
    check(met["guard_faults_total"] == rep["faults"] == 1
          and met["guard_rollbacks_total"] == rep["rollbacks"] == 1
          and met["guard_recoveries_total"] == len(rep["recoveries"]) == 1,
          f"(t3) registry {met} against report {rep}")
    spans = json.loads((d3 / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in spans]
    check(names.count("rollback_replay") == 1 and names.count("window") == 21,
          f"(t3) spans: {names.count('window')} window, "
          f"{names.count('rollback_replay')} rollback_replay")
    check_window_fields(wins, K1_FIELDS, "(t3)")
    launches["compact_fused"]["t3 guard corrupt"] = gc["compact_fused"]
    fault = next(e for e in evs if e["kind"] == "fault")
    log(f"(t3) --guard --inject-corrupt-at 6 --metrics-dir: launches {gc}, "
        f"events fault/rollback/recovery 1/1/1 ({fault['reason']} at step "
        f"{fault['step']}), registry counters = report() (faults "
        f"{rep['faults']}, rollbacks {rep['rollbacks']}, recoveries "
        f"{len(rep['recoveries'])}), 21 window spans and one "
        f"rollback_replay; losses and final params bitwise (g2)'s")

    # (c) the costs
    alt = {"bare": [], "telemetry": []}
    for i in range(TELEMETRY_ROUNDS):     # in turn, the order flipped
        for name in (("bare", "telemetry") if i % 2 == 0
                     else ("telemetry", "bare")):
            extra = (("--metrics-dir", str(root / f"c{i}")) if name ==
                     "telemetry" else ())
            out = TRAIN.main([*base, *extra])
            alt[name].append(out["summary"]["median_window_ms"])
    diff = [t - b for b, t in zip(alt["bare"], alt["telemetry"])]
    log(f"(c) median window compact_fused, {TELEMETRY_ROUNDS} runs each in "
        f"turn (ABBA): bare {[round(v, 3) for v in alt['bare']]} ms, "
        f"--metrics-dir {[round(v, 3) for v in alt['telemetry']]} ms; "
        f"medians {statistics.median(alt['bare']):.3f} / "
        f"{statistics.median(alt['telemetry']):.3f} ms, quartiles "
        f"{[round(v, 3) for v in statistics.quantiles(alt['bare'])]} / "
        f"{[round(v, 3) for v in statistics.quantiles(alt['telemetry'])]}; "
        f"telemetry minus bare within each round: median "
        f"{statistics.median(diff):.3f} ms, range [{min(diff):.3f}, "
        f"{max(diff):.3f}], {sum(d > 0 for d in diff)} of {len(diff)} "
        f"positive")
    pack_host_costs(torch, TRAIN, ON, root)
    pack_window_ab(torch, TRAIN, ON, root, Telemetry)
    tr_bare = trace_main_path(torch, TRAIN, ON, "compact_fused",
                              "fused_update_kernel")
    obs = Telemetry.create(root / "trace", trace=True)
    tr_obs = trace_main_path(torch, TRAIN, ON, "compact_fused",
                             "fused_update_kernel", telemetry=obs)
    obs.finalize()
    if tr_bare and tr_obs:
        log(f"(c) device ops a stream step: bare {tr_bare['ops_per_step']:.2f}"
            f", packed {tr_obs['ops_per_step']:.2f} (the pack adds "
            f"{tr_obs['ops_per_step'] - tr_bare['ops_per_step']:.2f} a step, "
            f"{8 * (tr_obs['ops_per_step'] - tr_bare['ops_per_step']):.1f} a "
            f"window); device-to-host copies in the 2 traced windows and the "
            f"run's end (row_stats): bare {tr_bare['dtoh']}, packed "
            f"{tr_obs['dtoh']}, inside each window span {tr_obs['window_dtoh']}"
            f"; device busy {tr_bare['busy_us'] / 16:.1f} / "
            f"{tr_obs['busy_us'] / 16:.1f} us a step")
        check(tr_obs["window_dtoh"] == [1, 1]
              and tr_obs["dtoh"] == tr_bare["dtoh"],
              f"(c) readbacks: {tr_obs['window_dtoh']} in the window spans, "
              f"{tr_obs['dtoh']} in the packed run against "
              f"{tr_bare['dtoh']} bare")
        check(tr_obs["window_kernels"] == [8, 8] and
              tr_bare["window_kernels"] == [],
              f"(c) K1 launches in the window spans: "
              f"{tr_obs['window_kernels']} (bare {tr_bare['window_kernels']})")
        log(f"(c) the profiler's `window` record_function spans: "
            f"{len(tr_obs['window_kernels'])}, K1 launches in each "
            f"{tr_obs['window_kernels']}")
    costs = guard_check_costs(torch, si["trainers"][-1].carry)
    log("(c) guard checks json: " + json.dumps(costs))
    path = ("--metrics-dir --trace: compact_fused (t1), pallas with --rewire "
            "rigl --rewire-every 2 (t2), --guard --inject-corrupt-at 6 (t3)")
    return {k: {"path": path, "launches": v} for k, v in launches.items()}


# ---------------------------------------------------------------------------
# phase 11: the stream fleet
# ---------------------------------------------------------------------------

# (f2)/(f3): windows of the kernel fleets, and the windows after which each
# slot is held against the same session run alone
FLEET_WINDOWS = 12
FLEET_HELD = (1, 8)
# (f5): the fleet widths timed against as many solo windows, and the widest
FLEET_SLOTS = (1, 8)
# fleets timed alone, without their S solo windows (64 had them through
# PR 29: its 64 solo trainers and windows, for the script's time)
FLEET_ALONE = (64, 256)
FLEET_ROUNDS = 3    # (f5)'s rounds in turn (5 through PR 29: the script's time)


def admission_windows(sessions, slots, windows):
    """Fleet windows of the reference launcher's loop
    (`repro.launch.serve._fleet_main`) for a queue of `sessions` that need
    `windows` windows each, admitted into free slots as they free up."""
    queue, need, n = list(range(sessions)), {}, 0
    while queue or need:
        while queue and len(need) < slots:
            need[queue.pop(0)] = windows
        n += 1
        for s in list(need):
            need[s] -= 1
            if need[s] <= 0:
                del need[s]
    return n


def tree_gap(torch, a, b):
    """(bitwise, the largest |a - b| over a leaf's largest |b|) over the
    leaves of two trees of tensors."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"trees of {len(la)} and {len(lb)} leaves")
    same, worst = True, 0.0
    for x, y in zip(la, lb):
        same = same and torch.equal(x, y)
        x, y = x.double(), y.double()
        scale = max(float(y.abs().max()), 1e-30) if y.numel() else 1.0
        worst = max(worst, float((x - y).abs().max()) / scale
                    if x.numel() else 0.0)
    return same, worst


def launcher_fleet(torch, SERVE, FL, backend, slots, store=None,
                   telemetry=None):
    """A StreamFleet at `launch.serve --fleet`'s full configuration (n 96,
    batch 8 a session, sparsity 0.9, adamw 1e-3, the launcher's generators
    and streams) with `backend`.  Returns (fleet, params, stream_of)."""
    dev = torch.device("cuda")
    cfg, masks, learner, opt, params = SERVE.fleet_setup(96, dev, backend)
    stream_of = lambda i: SERVE.make_fleet_stream(i, 8, cfg.n_in, cfg.n_out)
    fleet = FL.StreamFleet(FL.FleetConfig(slots=slots, update_every=8,
                                          store_dir=store),
                           learner, opt, params, masks,
                           example=stream_of(0)(0), device=dev,
                           telemetry=telemetry)
    return fleet, params, stream_of


def fleet_step_operands(torch, SP, fleet, xs):
    """The kernel operands of one stream step of every slot of `fleet`
    (from its stacked carry, on the slots' inputs xs [S, B, n_in]), each
    [S, B, ...]: K1's (compact_fused) or K2's padded ones and their block
    masks (pallas), as the vmapped step builds them."""
    from repro_torch.kernels import ops as OPS
    lr = fleet.learner
    cfg = lr.cfg

    def one(carry, x):
        w = {k: v for k, v in carry["params"].items() if k != "out"}
        if lr.backend == "compact_fused":
            return SP.fused_step_operands(cfg, w, lr.layout, carry["a"],
                                          carry["vals"], carry["idx"], x,
                                          cl=lr._cl)[2]
        _, _, ops = SP.pallas_step_operands(
            cfg, w, lr.layout, carry["a"], carry["M"], x, cl=lr._cl,
            col_mask=lr._colm, jmask=lr._jm)
        return OPS.influence_operands(*ops[:4], block_masks=lr._kmasks)[:6]

    return torch.func.vmap(one)(fleet.carry, xs)


def fleet_kernel_check(torch, CF, IN, OPS, SP, fleet, xs):
    """K1 or K2 on the operands of a real fleet step, called as the fleet
    calls it (torch.func.vmap: one launch, the slots folded into the
    examples) against its plain version on the folded operands; K2's
    executed blocks against the sum over the slots of
    realized_block_savings x blocks.  Returns (max abs err, blocks)."""
    ops = fleet_step_operands(torch, SP, fleet, xs)
    S, B = ops[0].shape[:2]
    fold = lambda t: t.reshape(S * B, *t.shape[2:]).contiguous()
    if fleet.learner.backend == "compact_fused":
        before = CF.fused_update.launches
        out = torch.func.vmap(CF.fused_update)(*ops)
        torch.cuda.synchronize()
        check(CF.fused_update.launches == before + 1,
              "(f2) the vmapped K1 call launched "
              f"{CF.fused_update.launches - before} times")
        err = compare_k1(torch, CF, [fold(t) for t in ops],
                         f"(f2) folded fleet step, S={S}, one launch",
                         out=fold(out))
        return err, None
    kmasks = fleet.learner._kmasks
    count = torch.zeros(1, dtype=torch.int64, device=ops[0].device)
    before = IN.influence_update.launches
    out = torch.func.vmap(lambda hp, J, M, Mb, row, prev: IN.influence_update(
        hp, J, M, Mb, row_mask=row, prev_mask=prev, col_mask=kmasks[0],
        jmask=kmasks[1], block_count=count))(*ops)
    torch.cuda.synchronize()
    check(IN.influence_update.launches == before + 1,
          f"(f3) the vmapped K2 call launched "
          f"{IN.influence_update.launches - before} times")
    masks = dict(row_mask=fold(ops[4]), prev_mask=fold(ops[5]),
                 col_mask=kmasks[0], jmask=kmasks[1])
    ref = IN.influence_reference(*(fold(t) for t in ops[:4]), **masks)
    err, scale = within(fold(out), ref, False, f"(f3) folded fleet step, S={S}")
    live = (masks["row_mask"] != 0).repeat_interleave(IN.BK, 1)[:, :, None] \
        & (kmasks[0] != 0).repeat_interleave(IN.BP)
    check(bool((fold(out)[~live] == 0).all()),
          "(f3) dead row/column blocks not exactly zero")
    per_slot = [int(IN.executed_blocks(ops[4][s], ops[5][s], *kmasks))
                for s in range(S)]
    check(int(count) == sum(per_slot),
          f"(f3) executed blocks {int(count)} on the folded call, the slots "
          f"sum to {sum(per_slot)} ({per_slot})")
    # realized_block_savings x blocks of each slot, the host's count
    from repro_torch.tree import tree_map
    lr = fleet.learner
    total = B * ops[4].shape[2] * ops[5].shape[2] * kmasks[0].shape[0]
    for s in range(S):
        c = tree_map(lambda b: b[s], fleet.carry)
        w = {k: v for k, v in c["params"].items() if k != "out"}
        _, _, u = SP.pallas_step_operands(
            lr.cfg, w, lr.layout, c["a"], c["M"], xs[s], cl=lr._cl,
            col_mask=lr._colm, jmask=lr._jm)
        sav = OPS.realized_block_savings(u[0], u[2], u[4], u[5]) * total
        check(round(sav) == per_slot[s],
              f"(f3) slot {s}: {per_slot[s]} executed blocks, "
              f"realized_block_savings x blocks {sav}")
    log(f"K2 (f3) folded fleet step: S={S} B={B} n_p={ops[2].shape[2]} "
        f"P_p={ops[2].shape[3]}, one launch, max_abs_err {err:.3e} (scale "
        f"{scale:.3e}), executed blocks {int(count)} = the slots' "
        f"realized_block_savings x blocks {per_slot}")
    return err, int(count)


def first_fleet_difference(torch, ON, FL, fleet, xs, ys):
    """Where a slot of the vmapped fleet first parts from the same session
    computed alone: one stream step and one update, stage by stage, each
    stage from the same inputs, slot 0 of the fleet's S against the
    unbatched call.  Returns [(stage, bitwise, max relative gap)]."""
    import numpy as np
    from repro_torch.core import cells
    from repro_torch.tree import tree_map
    lr, opt = fleet.learner, fleet.opt
    S = fleet.cfg.slots
    one = tree_map(lambda b: b[0].clone(), fleet.carry)
    ost = tree_map(lambda b: b[0].clone(), fleet.opt_state)
    w = cells.rec_param_tree(fleet.carry["params"])
    x, y = xs[:, 0], ys[:, 0]
    rows = []

    def stage(name, solo, batched):
        same, gap = tree_gap(torch, tree_map(lambda b: b[0], batched), solo)
        rows.append((name, same, gap))

    W = w["u"]["W"]
    stage("slot_mm x @ W_u", cells.slot_mm(x[0], W[0]),
          torch.func.vmap(cells.slot_mm)(x, W))
    wp0 = cells.rec_param_tree(one["params"])
    stage("cell partials", lr.cell.partials(wp0, one["a"], x[0]),
          torch.func.vmap(lr.cell.partials)(w, fleet.carry["a"], x))
    stage("learner step (K1/K2 folded, the gradient extraction)",
          lr.step(one, x[0], y[0])[0],
          torch.func.vmap(lambda c, a, b: lr.step(c, a, b)[0])(
              fleet.carry, x, y))
    u0 = 3
    stage("window update (the step, adamw with per-slot bias corrections)",
          ON.online_update_chunk(lr, opt, one, ost, xs[0], ys[0], u0)[:2],
          torch.func.vmap(lambda c, o, a, b, u: ON.online_update_chunk(
              lr, opt, c, o, a, b, u)[:2])(fleet.carry, fleet.opt_state,
                                           xs, ys,
                                           opt.slot_steps([u0] * S, xs.device)))
    # the library calls the step does not take, for the record: a cuBLAS
    # product of two slot tensors, and a divisor that is a host scalar
    # (CUDA multiplies by its reciprocal) against the [S] slot tensor
    R, a = w["u"]["R"], fleet.carry["a"]
    lib = [("library a @ R_u (cuBLAS, batch 1 against S)", a[0] @ R[0],
            torch.func.vmap(torch.matmul)(a, R)),
           ("library m / c1, host scalar against the slot tensor",
            ost["m"]["u"]["R"] / float(np.float32(0.271)),
            torch.func.vmap(torch.div)(
                fleet.opt_state["m"]["u"]["R"],
                torch.full((S,), float(np.float32(0.271)),
                           device=xs.device)))]
    n_path = len(rows)
    for name, solo, batched in lib:
        stage(name, solo, batched)
    return rows[:n_path], rows[n_path:]


def fleet_kernel_phase(torch, SERVE, FL, ON, CF, IN, OPS, SP, backend,
                       kernel, label):
    """(f2) / (f3): a `backend` fleet at the launcher's configuration, 4
    slots, FLEET_WINDOWS windows with the live slots going 4 -> 3 -> 4,
    every count set to 0 just before and read just after; K1 or K2 on the
    operands of a real fleet step; the slots held against the same
    sessions run alone through OnlineTrainer; the first stage where a slot
    parts from its solo run.  Returns the kernels line's "fleet" entry."""
    fleet, params, stream_of = launcher_fleet(torch, SERVE, FL, backend, 4)
    for i in range(4):
        fleet.add_session(f"s{i}", stream_of(i))
    held = ("s0", "s1", "s2")
    snaps, live = {}, []
    reset_counts()
    for w in range(FLEET_WINDOWS):
        if w == 6:
            fleet.remove("s3")
        if w == 8:
            fleet.add_session("s4", stream_of(4))
        stats = fleet.step_window()
        live.append(len(stats))
        check(all(math.isfinite(v["loss"]) for v in stats.values()),
              f"{label}: non-finite loss {stats}")
        if w + 1 in FLEET_HELD:
            snaps[w + 1] = {sid: fleet.slot_state(sid) for sid in held}
    counts = read_counts()
    want = 8 * FLEET_WINDOWS
    check_counts(counts, {kernel: want}, f"{label} fleet")
    log(f"{label} {backend} StreamFleet, 4 slots, live {live}: launches "
        f"{counts} over {FLEET_WINDOWS} windows (8 a window whatever the "
        f"live count)")
    xs, ys, _, _ = fleet._gather(8)
    xs = torch.from_numpy(xs).cuda()
    ys = torch.from_numpy(ys).cuda()
    err, blocks = fleet_kernel_check(torch, CF, IN, OPS, SP, fleet, xs[:, 0])
    # each held slot against the same session run alone
    gaps = {}
    for i, sid in enumerate(held):
        tr = ON.OnlineTrainer(
            ON.OnlineTrainerConfig(total_steps=8 * FLEET_HELD[0],
                                   update_every=8),
            fleet.learner, fleet.opt, params, fleet.masks, stream_of(i),
            device=fleet.device)
        for n_win in FLEET_HELD:
            tr.cfg.total_steps = 8 * n_win
            tr.run()
            gaps[(sid, n_win)] = tree_gap(torch, snaps[n_win][sid],
                                          (tr.carry, tr.opt_state))
    stages, lib = first_fleet_difference(torch, ON, FL, fleet, xs, ys)
    first = next((name for name, same, _ in stages if not same), None)
    fmt = lambda rows: "; ".join(
        f"{name}: {'bitwise' if same else f'{gap:.3e}'}"
        for name, same, gap in rows)
    log(f"{label} stage by stage, fleet slot 0 of 4 against the unbatched "
        f"call on the same inputs: {fmt(stages)}; first to differ: {first}"
        f"; the library forms the step avoids: {fmt(lib)}")
    bitwise = all(same for same, _ in gaps.values())
    for (sid, n_win), (same, gap) in gaps.items():
        bar = 1e-6 if n_win == 1 else 1e-5
        check(same or gap <= bar,
              f"{label} {sid} after {n_win} windows: {gap:.3e} from the "
              f"session run alone (bar {bar:g})")
    held_note = ("bitwise" if bitwise else "within the bars: " + ", ".join(
        f"{sid}@{n}: {g:.3e}" for (sid, n), (_, g) in gaps.items()))
    log(f"{label} slots against the sessions run alone through "
        f"OnlineTrainer after {FLEET_HELD} windows: {held_note}")
    entry = {"path": f"StreamFleet {backend} at launch.serve --fleet's "
                     f"configuration (n 96, B 8), 4 slots, live {live}",
             "launches": counts[kernel], "windows": FLEET_WINDOWS,
             "max_abs_err": err, "held_alone": held_note,
             "first_difference": first}
    if blocks is not None:
        entry["executed_blocks"] = blocks
    return entry


def lane_exactness(torch, SERVE, FL, MetricPack, root):
    """(f4): on the card, bitwise: a guest joining at window 2 and leaving
    at window 5 moves no bit of the other slots; evict, then resume into
    another slot ends where the never-evicted run ends; a MetricPack fleet
    chunk's carry and optimizer state equal the bare chunk's."""
    def join_leave(guest):
        fleet, _, stream_of = launcher_fleet(torch, SERVE, FL,
                                             "compact_fused", 4)
        for i in range(3):
            fleet.add_session(f"s{i}", stream_of(i))
        for w in range(8):
            if guest and w == 2:
                fleet.add_session("guest", stream_of(9))
            if guest and w == 5:
                fleet.remove("guest")
            fleet.step_window()
        return [fleet.slot_state(f"s{i}") for i in range(3)]

    alone, shared = join_leave(False), join_leave(True)
    check(all(tree_gap(torch, a, b)[0] for a, b in zip(alone, shared)),
          "(f4) a guest joining at window 2 and leaving at 5 moved bits of "
          "its neighbours")

    def evict_resume(evict, store):
        fleet, _, stream_of = launcher_fleet(torch, SERVE, FL,
                                             "compact_fused", 2, store=store)
        fleet.add_session("a", stream_of(3))
        for _ in range(3):
            fleet.step_window()
        if evict:
            check(fleet.evict("a") == 24, "(f4) evicted at the wrong position")
            fleet.add_session("filler", stream_of(8))
            fleet.step_window()
            check(fleet.resume("a", stream_of(3)) == 1,
                  "(f4) resumed into the slot it left")
            fleet.remove("filler")
        for _ in range(3):
            fleet.step_window()
        return fleet.slot_state("a")

    ref = evict_resume(False, None)
    ev = evict_resume(True, str(root / "store"))
    check(tree_gap(torch, ev, ref)[0],
          "(f4) evict and resume did not end where the never-evicted run "
          "ends")
    fleet, _, stream_of = launcher_fleet(torch, SERVE, FL, "compact_fused", 4)
    for i in range(3):
        fleet.add_session(f"s{i}", stream_of(i))
    fleet.step_window()
    xs, ys, upd, live = fleet._gather(8)
    args = [fleet.carry, fleet.opt_state, *(torch.from_numpy(a).cuda()
                                            for a in (xs, ys)), upd,
            torch.from_numpy(live).cuda()]
    c_a, o_a, m_a = FL.fleet_update_chunk(fleet.learner, fleet.opt, *args)
    c_b, o_b, m_b = FL.fleet_update_chunk(fleet.learner, fleet.opt, *args,
                                          pack=MetricPack.default())
    check(tree_gap(torch, (c_b, o_b), (c_a, o_a))[0],
          "(f4) the packed fleet chunk's carry or optimizer state differs "
          "from the bare chunk's")
    check(torch.equal(m_b[:, :3], m_a), "(f4) the packed rows' verdict "
                                        "columns differ from the bare ones")
    log("(f4) on the card, bitwise: a guest joining at window 2 and leaving "
        "at 5 moves no bit of its 3 neighbours after 8 windows; evict after "
        "3 windows, a filler window, resume into the other slot, 3 more: "
        "the never-evicted run's state; the MetricPack fleet chunk's carry "
        "and optimizer state the bare chunk's, its verdict columns equal")


def bench_fleet(torch, FL, ON, slots):
    """A StreamFleet of `slots` at the operating point of
    benchmarks/fleet_bench.py (the reference's fleet bench): EGRU kind gru,
    n 16, n_in 8, n_out 4, eps 0.12, theta + 0.4, sparsity 0.9 in 8 x 8
    blocks, one example a session, k = 8, adamw 1e-3, here with
    compact_fused (K1) at capacity 1.  Every slot holds a session.
    Returns (fleet, make_solo); make_solo(i) builds session i as a solo
    OnlineTrainer."""
    import numpy as np
    from repro_torch.core import cells as C, sparse_rtrl as SP
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.optim import make_optimizer
    dev = torch.device("cuda")
    cfg = C.EGRUConfig(n_hidden=16, n_in=8, n_out=4, kind="gru", eps=0.12)
    params = C.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    params["theta"] = params["theta"] + 0.4
    masks = SP.make_masks(cfg, torch.Generator().manual_seed(9), 0.9,
                          device=dev, block=8)
    params = SP.apply_masks(params, masks)
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend="compact_fused"))
    opt = make_optimizer("adamw", lr=1e-3)

    def stream_of(i):
        def stream(step):
            rng = np.random.default_rng(i * 100003 + step)
            return ((4.0 * rng.standard_normal((1, 8))).astype(np.float32),
                    np.zeros((1,), np.int32))
        return stream

    fleet = FL.StreamFleet(FL.FleetConfig(slots=slots, update_every=8),
                           learner, opt, params, masks,
                           example=stream_of(0)(0), device=dev)
    for i in range(slots):
        fleet.add_session(f"s{i}", stream_of(i))

    def make_solo(i):
        return ON.OnlineTrainer(
            ON.OnlineTrainerConfig(total_steps=0, update_every=8),
            learner, opt, params, masks, stream_of(i), device=dev)

    return fleet, make_solo


def solo_windows(trainers):
    """One window of each solo trainer in turn, each read back once (the
    trainer's own window: gather, chunk, one readback)."""
    for tr in trainers:
        ok, _, _ = tr._execute_window(tr.step, 8)
        tr.step += 8
        tr.update += 1


def trace_calls(torch, fn, calls=3):
    """Device ops a call and the device's idle share of the wall time over
    `calls` calls of fn under torch.profiler (None where it records no
    device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in SPAN_NAMES]
    if not dev:
        return None
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"ops": len(dev) / calls, "busy_us": busy / calls,
            "idle": 1 - busy / wall_us}


def fleet_costs(torch, FL, ON):
    """(f5) and (g), measured, not gated: at the fleet bench's operating
    point, for S in FLEET_SLOTS the fleet window against S solo windows
    stepped in turn (one readback each), the median of FLEET_ROUNDS rounds
    taken in turn, and for S in FLEET_ALONE the fleet window alone;
    sessions/s, device ops a window and idle share from traces; the peak
    bytes of a 64-slot fleet's window against 64 x session_carry_bytes."""
    out = {}
    for S in FLEET_SLOTS:
        fleet, make_solo = bench_fleet(torch, FL, ON, S)
        solos = [make_solo(i) for i in range(S)]
        fleet.step_window()
        solo_windows(solos)
        got = {"fleet": [], "solo": []}
        for _ in range(FLEET_ROUNDS):
            t0 = time.perf_counter()
            fleet.step_window()
            got["fleet"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            solo_windows(solos)
            got["solo"].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in got.items()}
        tf = trace_calls(torch, fleet.step_window)
        ts = trace_calls(torch, lambda: solo_windows(solos[:1]))
        out[S] = {"fleet_ms": med["fleet"], "solo_ms": med["solo"],
                  "fleet_sessions_per_s": S / med["fleet"] * 1e3,
                  "solo_sessions_per_s": S / med["solo"] * 1e3,
                  "fleet_trace": tf, "solo_trace": ts,
                  "session_carry_bytes": fleet.session_carry_bytes}
        log(f"(f5) S={S}: fleet window {med['fleet']:.3f} ms against {S} "
            f"solo windows {med['solo']:.3f} ms (median of {FLEET_ROUNDS} "
            f"rounds in turn;"
            f" rounds {[round(v, 3) for v in got['fleet']]} / "
            f"{[round(v, 3) for v in got['solo']]}), sessions/s "
            f"{out[S]['fleet_sessions_per_s']:.1f} against "
            f"{out[S]['solo_sessions_per_s']:.1f}; trace of a fleet window "
            f"{tf}, of one solo window {ts}")
        del fleet, solos
    for S in FLEET_ALONE:
        fleet, _ = bench_fleet(torch, FL, ON, S)
        fleet.step_window()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fleet.step_window()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[S] = {"fleet_ms": statistics.median(ms),
                  "fleet_sessions_per_s": S / statistics.median(ms) * 1e3,
                  "fleet_trace": trace_calls(torch, fleet.step_window)}
        log(f"(f5) S={S}: fleet window {out[S]['fleet_ms']:.3f} ms (median "
            f"of 5: {[round(v, 3) for v in ms]}), sessions/s "
            f"{out[S]['fleet_sessions_per_s']:.1f}, trace "
            f"{out[S]['fleet_trace']}")
        del fleet
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fleet, _ = bench_fleet(torch, FL, ON, 64)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    fleet.step_window()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out["memory"] = {"stacked_bytes": held, "window_peak_bytes": peak,
                     "64 x session_carry_bytes":
                     64 * fleet.session_carry_bytes,
                     "fleet_carry_bytes": fleet.report()["fleet_carry_bytes"]}
    log(f"(g) a 64-slot fleet: {held} bytes allocated once built (carry, "
        f"optimizer state and the template), {peak} bytes at the peak of a "
        f"window, against 64 x session_carry_bytes = "
        f"{64 * fleet.session_carry_bytes}")
    return out


def fleet_phase(torch, SERVE, FL, ON, CF, IN, OPS, SP):
    """Phase 11, the stream fleet: (f1) the launcher; (f2) K1 and (f3) K2
    through fleets; (f4) lane exactness on the card; (f5) and (g) the
    costs.  Returns the "fleet" entries of K1's and K2's records."""
    import shutil
    import tempfile
    from repro_torch.obs import MetricPack
    # (f1) the launcher at its defaults, on the card
    reset_counts()
    out = SERVE.main(["--fleet"])
    counts = read_counts()
    s = out["summary"]
    want = admission_windows(6, 4, 12)
    check(sorted(out["completed"]) == [f"s{i}" for i in range(6)],
          f"(f1) completed {out['completed']}")
    check(s["fleet_windows"] == want == 24,
          f"(f1) fleet_windows {s['fleet_windows']}, the admission "
          f"arithmetic gives {want}")
    check_counts(counts, {}, "(f1) launch.serve --fleet (backend compact)")
    log(f"(f1) launch.serve --fleet (n 96, B 8, compact, 6 sessions, 4 "
        f"slots, 12 windows each): every session completed; summary "
        f"{json.dumps(s)}")
    entries = {
        "compact_fused": fleet_kernel_phase(torch, SERVE, FL, ON, CF, IN,
                                            OPS, SP, "compact_fused",
                                            "compact_fused", "(f2)"),
        "influence": fleet_kernel_phase(torch, SERVE, FL, ON, CF, IN, OPS,
                                        SP, "pallas", "influence", "(f3)")}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        lane_exactness(torch, SERVE, FL, MetricPack, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    costs = fleet_costs(torch, FL, ON)
    log("(f5) fleet costs json: " + json.dumps(
        {str(k): v for k, v in costs.items()}))
    return entries


# ---------------------------------------------------------------------------
# phase 12: the online token LM
# ---------------------------------------------------------------------------

# the packed fields a window event carries on each LM path (K1_FIELDS on
# egru-lm's compact_fused run)
LM_FIELDS = {"rglru-lm": ("loss", "grad_norm", "clip_factor", "health"),
             "snn-lm": ("loss", "grad_norm", "act_sparsity", "clip_factor",
                        "health")}


def lm_argv(arch="egru-lm", *extra):
    """The online token LM's launcher arguments at the reference's defaults
    (width 64, vocab 64, batch 4, seq 64, lr 3e-3; k 8, 20 updates; no
    --device: it runs on CUDA)."""
    return ["--arch", arch, "--online", "--update-every", "8", "--steps",
            "20", "--seed", "0", *extra]


def lm_first_window(torch, TRAIN, ON, BP, argv, oracle=False):
    """The first window (k=8) of an LM launcher run: (loss, grads), and
    with `oracle` also the BPTT oracle's (loss, grads) through the same
    window on the run's device, the pruned parameters' gradients masked
    as the optimizer masks them."""
    from repro_torch.cells import resolve_cell
    from repro_torch.tree import apply_mask_tree
    run = TRAIN.build_lm(TRAIN.parse_args(argv))
    xs, ys = stream_window(torch, run, 8)
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    if not oracle:
        return float(loss), grads
    bloss, bgrads = BP.window_bptt_loss_and_grads(resolve_cell(run["cfg"]),
                                                  run["params"], xs, ys)
    if run["masks"] is not None:
        bgrads = apply_mask_tree(run["masks"], bgrads)
    return (float(loss), grads), (float(bloss), bgrads)


def lm_step_carry(torch, TRAIN, ON, argv, steps=5):
    """An LM run stepped `steps` times from init: (run, carry, the next
    stream step's x)."""
    run = TRAIN.build_lm(TRAIN.parse_args(argv))
    xs, ys = stream_window(torch, run, steps + 1)
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    carry, _, _, _ = ON.stream_grads(run["learner"], carry, xs[:steps],
                                     ys[:steps])
    return run, carry, xs[steps]


def lm_k1_operands(torch, TRAIN, SP, ON):
    """K1's operands at a live step of egru-lm's compact_fused run (l1),
    its column layout and its influence columns P."""
    run, carry, x = lm_step_carry(torch, TRAIN, ON, lm_argv(
        "egru-lm", "--rtrl-backend", "compact_fused", "--sparsity", "0.8"))
    cfg = run["cfg"]
    layout = SP.flat_layout(cfg)
    cl = SP.col_layout(layout, run["masks"], device=run["device"])
    w = {k: v for k, v in carry["params"].items() if k != "out"}
    _, _, ops, _ = SP.fused_step_operands(cfg, w, layout, carry["a"],
                                          carry["vals"], carry["idx"], x,
                                          cl=cl)
    return list(ops), cl, layout.P


def lm_k2_operands(torch, TRAIN, SP, ON, sparsity):
    """K2's unpadded operands at a live step of egru-lm's pallas run (l2):
    column-compact at --sparsity 0.8, full width at 0."""
    run, carry, x = lm_step_carry(torch, TRAIN, ON, lm_argv(
        "egru-lm", "--rtrl-backend", "pallas", "--sparsity", sparsity))
    cfg, masks, dev = run["cfg"], run["masks"], run["device"]
    layout = SP.flat_layout(cfg)
    compact = carry["M"].shape[-1] != layout.P_pad
    cl = SP.col_layout(layout, masks, device=dev) if compact else None
    w = {k: v for k, v in carry["params"].items() if k != "out"}
    _, _, ops = SP.pallas_step_operands(
        cfg, w, layout, carry["a"], carry["M"], x, cl=cl,
        col_mask=cl.live if compact else SP.flat_col_mask(layout, masks,
                                                          device=dev),
        jmask=SP.flat_jmask(cfg, masks))
    return list(ops)


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def lm_metrics_run(torch, TRAIN, argv, bare, want, fields, root, label):
    """(l5): the run with `--metrics-dir D --trace`, counted: the launches
    `want`, D clean under the validator, 20 `window` events with `fields`,
    every window's loss bitwise the bare run's."""
    d = root / label.replace(" ", "_")
    out, counts = run_counted(TRAIN, [*argv, "--ckpt-every", "0",
                                      "--metrics-dir", str(d), "--trace"])
    check_counts(counts, want, f"(l5) {label}")
    validated_dir(d, f"(l5) {label}")
    _, wins = window_events(d)
    check(len(wins) == 20, f"(l5) {label}: {len(wins)} window events")
    check_window_fields(wins, fields, f"(l5) {label}")
    check([w["loss"] for w in out["windows"]]
          == [w["loss"] for w in bare["windows"]],
          f"(l5) {label}: the instrumented windows differ from the bare run")
    log(f"(l5) {label} --metrics-dir --trace: launches {counts}, the "
        f"validator clean, 20 window events with {', '.join(fields)}, "
        f"losses bitwise the bare run's")


def lm_phase(torch, TRAIN, ON, CKP, BP, SP, CF, CK, IN, OPS):
    """(l1)-(l5) and (c) of the online token LM, at the reference's
    defaults, its checkpoints and metrics directories under a temporary
    root that is removed at the end.  Returns K1's and K2's "lm" entries
    for the kernels line."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    try:
        return _lm_checks(torch, TRAIN, ON, CKP, BP, SP, CF, CK, IN, OPS,
                          root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _lm_checks(torch, TRAIN, ON, CKP, BP, SP, CF, CK, IN, OPS, root):
    fused = ("--rtrl-backend", "compact_fused", "--sparsity", "0.8")
    mains = {  # label -> (argv, the launches its run must make)
        "egru-lm compact_fused 0.8": (lm_argv("egru-lm", *fused),
                                      {"compact_fused": 160}),
        "egru-lm pallas 0.8": (lm_argv("egru-lm", "--rtrl-backend", "pallas",
                                       "--sparsity", "0.8"),
                               {"influence": 160}),
        "egru-lm pallas 0": (lm_argv("egru-lm", "--rtrl-backend", "pallas"),
                             {"influence": 160}),
        "egru-lm compact 0.8": (lm_argv("egru-lm", "--rtrl-backend",
                                        "compact", "--sparsity", "0.8"), {}),
        "egru-lm dense 0.8": (lm_argv("egru-lm", "--sparsity", "0.8"), {}),
        "rglru-lm 0": (lm_argv("rglru-lm"), {}),
        "rglru-lm 0.5": (lm_argv("rglru-lm", "--sparsity", "0.5"), {}),
        "snn-lm": (lm_argv("snn-lm"), {}),
    }
    runs = {}
    for label, (argv, want) in mains.items():
        out, counts = run_counted(TRAIN, [*argv, "--ckpt-every", "0"])
        check_counts(counts, want, f"LM {label}")
        check(out["final_step"] == 160,
              f"LM {label}: {out['final_step']} stream steps, not 160")
        losses = [w["loss"] for w in out["windows"]]
        check(all(math.isfinite(v) for v in losses),
              f"LM {label}: non-finite loss {losses}")
        check(out["summary"].get("overflow", 0) == 0, f"LM {label}: overflow")
        runs[label] = out
        s = out["summary"]
        log(f"LM {label}: launches {counts} over 160 stream steps; first "
            f"window {losses[0]:.6f}, last {losses[-1]:.6f}, median window "
            f"{s['median_window_ms']:.3f} ms, carry {s['carry_bytes']} bytes"
            + (f", act {s['act_sparsity']:.4f}" if "act_sparsity" in s else "")
            + (f", bwd {s['bwd_sparsity']:.4f}" if "bwd_sparsity" in s
               else ""))

    # (l1) K1 on a real step's operands; first windows against dense and
    # the BPTT oracle, and the card against the CPU
    k1_ops, cl, P = lm_k1_operands(torch, TRAIN, SP, ON)
    B, K, Pc_pad = k1_ops[1].shape
    log(f"(l1) K1 at egru-lm's operands: B={B} n={k1_ops[0].shape[-1]} K={K} "
        f"P={P} Pc={cl.Pc} Pc_pad={Pc_pad}, count_new "
        f"{k1_ops[6].tolist()}, count_prev {k1_ops[7].tolist()}")
    err_k1 = compare_k1(torch, CF, k1_ops, "(l1) egru-lm f32")
    firsts = {b: lm_first_window(torch, TRAIN, ON, BP, lm_argv(
        "egru-lm", "--rtrl-backend", b, "--sparsity", "0.8"))
        for b in ("compact_fused", "pallas", "compact")}
    (ld, gd), (lo, go) = lm_first_window(
        torch, TRAIN, ON, BP, lm_argv("egru-lm", "--sparsity", "0.8"),
        oracle=True)
    for b, (lb, gb) in firsts.items():
        check(abs(lb - ld) <= F32_REL * abs(ld),
              f"(l1) first window loss {b} {lb} vs dense {ld}")
        compare_grads(gb, gd, f"(l1) egru-lm {b} vs dense (cuda)")
        compare_grads(gb, go, f"(l1) egru-lm {b} vs the BPTT oracle (cuda)")
    check(abs(lo - ld) <= F32_REL * abs(ld),
          f"(l1) first window loss: BPTT {lo} vs dense {ld}")
    lc, gc = lm_first_window(torch, TRAIN, ON, BP,
                             lm_argv("egru-lm", *fused, "--device", "cpu"))
    lf, gf = firsts["compact_fused"]
    check(abs(lc - lf) <= F32_REL * abs(lc),
          f"(l1) first window loss cuda {lf} vs cpu {lc}")
    compare_grads(gf, gc, "(l1) egru-lm compact_fused cuda vs cpu")

    # (l2) K2 on real steps' operands, column-compact and full width
    k2 = {}
    for sp in ("0.8", "0"):
        err, ops = compare_k2(torch, IN, OPS,
                              lm_k2_operands(torch, TRAIN, SP, ON, sp),
                              f"(l2) egru-lm --sparsity {sp}")
        check(err == 0.0, f"(l2) K2 at --sparsity {sp}: {err:.3e}, not 0.0")
        k2[sp] = (err, ops)

    # (l3) rglru-lm and snn-lm against their oracles, the card against the
    # CPU
    for label, argv in (("rglru-lm 0", lm_argv("rglru-lm")),
                        ("rglru-lm 0.5", lm_argv("rglru-lm", "--sparsity",
                                                 "0.5")),
                        ("snn-lm", lm_argv("snn-lm"))):
        (l, g), (lo, go) = lm_first_window(torch, TRAIN, ON, BP, argv,
                                           oracle=True)
        check(abs(l - lo) <= F32_REL * abs(lo),
              f"(l3) {label}: first window loss {l} vs BPTT {lo}")
        if label.startswith("snn"):
            cos = {k: cosine(g[k], go[k]) for k in ("W", "R")}
            check(min(cos.values()) >= 0.9,
                  f"(l3) snn-lm: e-prop cosine with BPTT {cos}")
            compare_grads(g["out"], go["out"],
                          "(l3) snn-lm readout vs the BPTT oracle (cuda)")
            log(f"(l3) snn-lm: e-prop vs the surrogate BPTT oracle, cosine "
                f"W {cos['W']:.4f}, R {cos['R']:.4f} (bar 0.9)")
        else:
            compare_grads(g, go, f"(l3) {label} diag_exact vs the BPTT "
                                 "oracle (cuda)")
        lcpu, gcpu = lm_first_window(torch, TRAIN, ON, BP,
                                     [*argv, "--device", "cpu"])
        check(abs(l - lcpu) <= F32_REL * abs(lcpu),
              f"(l3) {label}: first window loss cuda {l} vs cpu {lcpu}")
        compare_grads(g, gcpu, f"(l3) {label} cuda vs cpu")

    # (l4) crash and resume
    crash_and_resume(torch, TRAIN, CKP, lm_argv("egru-lm", *fused,
                                                "--ckpt-every", "5"),
                     "compact_fused", root / "l4k1", "(l4) egru-lm "
                     "compact_fused")
    crash_and_resume(torch, TRAIN, CKP, lm_argv("rglru-lm", "--sparsity",
                                                "0.5", "--ckpt-every", "5"),
                     None, root / "l4rg", "(l4) rglru-lm 0.5")

    # (l5) the metrics directories
    lm_metrics_run(torch, TRAIN, lm_argv("egru-lm", *fused),
                   runs["egru-lm compact_fused 0.8"], {"compact_fused": 160},
                   K1_FIELDS, root, "egru-lm compact_fused")
    lm_metrics_run(torch, TRAIN, lm_argv("rglru-lm", "--sparsity", "0.5"),
                   runs["rglru-lm 0.5"], {}, LM_FIELDS["rglru-lm"], root,
                   "rglru-lm 0.5")
    lm_metrics_run(torch, TRAIN, lm_argv("snn-lm"), runs["snn-lm"], {},
                   LM_FIELDS["snn-lm"], root, "snn-lm")

    # (c) the costs: traces, and K1 / K2 timed at the LM's operands
    for label, backend, kernel, argv in (
            ("egru-lm compact_fused 0.8", "compact_fused",
             "fused_update_kernel", lm_argv("egru-lm", *fused)),
            ("egru-lm pallas 0.8", "pallas", "influence_kernel",
             lm_argv("egru-lm", "--rtrl-backend", "pallas", "--sparsity",
                     "0.8")),
            ("rglru-lm 0", "diag_exact", "(no port kernel)",
             lm_argv("rglru-lm"))):
        log(f"(c) trace of {label}:")
        trace_main_path(torch, TRAIN, ON, backend, kernel, argv=argv)
    t1 = time_k1(torch, CF, CK, k1_ops, 200, 50)
    t2 = {sp: time_k2(torch, IN, k2[sp][1], 200, 50, host=False)
          for sp in k2}
    for label, t in [("K1 (l1)", t1)] + [
            (f"K2 (l2) --sparsity {sp}", t2[sp]) for sp in t2]:
        lib = "baddbmm on pre-gathered tiles" if label.startswith("K1") \
            else "baddbmm"
        log(f"(c) {label} time: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {lib} {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.0f} B, "
            f"{t['flops']:.0f} FLOP); in turn kernel {t['alt_ms']:.4f} ms, "
            f"{lib} {t['alt_library_ms']:.4f} ms (median of 5 rounds); "
            f"device kernel {t['device_us']} us, {lib} "
            f"{t['library_device_us']} us (profiler, 20 calls)")
    log(f"(c) K1 launch shape (l1): {k1_launch_shape(CF, k1_ops)}")
    log("LM K1/K2 times json: " + json.dumps({"K1": t1, "K2": t2}))

    entry = lambda t: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}
    return {"compact_fused": {
                "path": "egru-lm --rtrl-backend compact_fused --sparsity 0.8 "
                        "(width 64, vocab 64, batch 4)",
                "launches": 160, "max_abs_err": err_k1, "K": K,
                "Pc": cl.Pc, "Pc_pad": Pc_pad, **entry(t1)},
            "influence": {
                "path": "egru-lm --rtrl-backend pallas at --sparsity 0 (full "
                        "width, P_pad 24832; the timed case) and 0.8 "
                        "(column-compact)",
                "launches": {"--sparsity 0": 160, "--sparsity 0.8": 160},
                "max_abs_err": max(k2["0"][0], k2["0.8"][0]),
                **entry(t2["0"]),
                "column_compact": entry(t2["0.8"])}}


# ---------------------------------------------------------------------------
# launch counts of every kernel wrapper
# ---------------------------------------------------------------------------

def counted_wrappers():
    from repro_torch.kernels import compact_fused as CF, event_matmul as EM
    from repro_torch.kernels import influence as IN, wkv as WK
    return {"compact_fused": CF.fused_update, "influence": IN.influence_update,
            "event_matmul": EM.event_matmul, "wkv": WK.wkv}


def reset_counts():
    for wrapper in counted_wrappers().values():
        wrapper.launches = 0


def read_counts():
    return {name: w.launches for name, w in counted_wrappers().items()}


def check_counts(counts, want, label):
    """Every wrapper's count equals `want` (0 where not named)."""
    expect = {name: want.get(name, 0) for name in counts}
    check(counts == expect, f"{label}: launches {counts}, expected {expect}")


def within(got, ref, bf16, label):
    """Kernel result vs plain version: f32 within F32_REL of the largest
    magnitude; with bf16 operands one bf16 rounding step more.  Returns
    the max abs error."""
    check(bool(got.float().isfinite().all()), f"{label}: non-finite output")
    err = (got.float() - ref.float()).abs()
    scale = max(float(ref.float().abs().max()), 1.0)
    if bf16:
        ok = bool((err <= BF16_STEP * ref.float().abs() + F32_REL * scale).all())
    else:
        ok = float(err.max()) <= F32_REL * scale
    check(ok, f"{label}: kernel vs plain max abs err {float(err.max()):.3e} "
              f"(scale {scale:.3e})")
    return float(err.max()), scale


# ---------------------------------------------------------------------------
# phase 6: K3 against its plain version, and its entry point on the main path
# ---------------------------------------------------------------------------

def k3_bound(torch, ops):
    """Least time (ms) for the event matmul on these padded operands: the
    bytes it must move — the live blocks of a, the blocks of R that some
    example's live blocks meet, both masks, y written — over HBM
    bandwidth, against 2*8*128 FLOP per executed (b, lb, mb) block over
    the card's peak for the operands' type."""
    from repro_torch.kernels import event_matmul as EM
    a, R, act, rm = ops
    es = R.element_size()
    actd, rmd = (act != 0).double().cpu(), (rm != 0).double().cpu()
    used_R = float(((actd.sum(0) > 0).double()[:, None] * rmd).sum())
    nbytes = (float(actd.sum()) * EM.BL * es + used_R * EM.BL * EM.BM * es
              + (act.numel() + rm.numel()) * 4 + a.shape[0] * R.shape[1] * es)
    flops = float((actd @ rmd).sum()) * 2 * EM.BL * EM.BM
    peak = F32_FLOP_S if R.dtype == torch.float32 else BF16_FLOP_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def compare_k3(torch, EM, OPS, a, R, rmask, label):
    """Kernel vs plain version on the card and the executed-block counter
    vs the host count sum_b sum act[b,lb] * rmask[lb,mb].  Returns (max
    abs error, padded operands)."""
    ops = OPS.event_matmul_operands(a, R, rmask)
    a_p, R_p, act, rm = ops
    count = torch.zeros(1, dtype=torch.int64, device=R.device)
    y = EM.event_matmul(a_p, R_p, act_mask=act, rmask=rm, block_count=count)
    torch.cuda.synchronize()                    # a fault surfaces here
    ref = EM.event_matmul_reference(a_p, R_p, act_mask=act, rmask=rm)
    check(y.dtype == R.dtype and y.shape == ref.shape,
          f"K3 {label}: output {y.dtype} {tuple(y.shape)}")
    err, scale = within(y, ref, R.dtype == torch.bfloat16, f"K3 {label}")
    actn, rmn = act.cpu().numpy().astype(bool), rm.cpu().numpy().astype(bool)
    host = int((actn[:, :, None] & rmn[None]).sum())
    check(int(count) == host, f"K3 {label}: executed blocks {int(count)} vs "
                              f"host count {host}")
    log(f"K3 {label}: B={a_p.shape[0]} n_p={R_p.shape[0]} m_p={R_p.shape[1]} "
        f"{R.dtype}, max_abs_err {err:.3e} (scale {scale:.3e}), executed "
        f"blocks {int(count)} of {actn.shape[0] * rmn.size} = host count")
    return err, ops


def time_k3(torch, EM, ops, iters):
    """K3's times as time_k2's, beside torch.matmul in the same dtype."""
    from repro_torch.kernels import _build, influence as IN
    a, R, act, rm = ops
    call = lambda: EM.event_matmul(a, R, act_mask=act, rmask=rm)
    ms = time_ms(torch, call, iters)
    plain = time_ms(torch, lambda: EM.event_matmul_reference(
        a, R, act_mask=act, rmask=rm), max(iters // 10, 3))
    library = lambda: torch.matmul(a, R)
    lib = time_ms(torch, library, iters)
    alt = time_alternating(torch, {"ms": call, "lib": library}, iters // 5)
    bound, by, nbytes, flops = k3_bound(torch, ops)
    B, n, m, dev = a.shape[0], a.shape[1], R.shape[1], R.device
    args = (R, a, act, rm)
    ptrs = [t.data_ptr() for t in args]
    kc = EM._call(B, n, m, R.dtype, dev, False)
    y = torch.empty_like(kc.out_like)
    packed = kc.pack(ptrs[1], ptrs[0], ptrs[2], ptrs[3], y.data_ptr(), 0,
                     *kc.dims, _build.current_stream(dev))
    host = launch_path(torch, {
        "call": call,
        "checks": lambda: (kc.matches(args),
                           list(map(torch.Tensor.data_ptr, args))),
        "autograd check": lambda: _build.refuse_autograd("event_matmul", a, R),
        "allocation": lambda: torch.empty_like(kc.out_like),
        "stream": lambda: _build.current_stream(dev),
        "ctypes call": lambda: kc.fn(packed),
        "launch floor": lambda: IN.empty_launch(dev)})
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "flops": flops,
            "alt_ms": alt["ms"], "alt_library_ms": alt["lib"],
            "device_us": device_us(torch, call),
            "library_device_us": device_us(torch, library), "host_us": host}


def k3_main_operands(torch, TRAIN, ON, steps=5):
    """(a_prev [32,16], the u gate's masked R [16,16], its mask) at a live
    step of the spiral main path (same seed, stepped a few times)."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("compact")))
    xs, ys = stream_window(torch, run, steps)
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    carry, _, _, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    return carry["a"], carry["params"]["u"]["R"], run["masks"][0]["u"]["R"]


def k3_synthetic(torch, dev, B=32, n=256, m=768, density=0.5, seed=3):
    """(b): activity blocks of a and parameter blocks of R both at block
    density 0.5 (a and R zero outside them, so the dense product is the
    same function)."""
    g = torch.Generator().manual_seed(seed)
    act = torch.rand((B, n // 8), generator=g) < density
    blocks = torch.rand((n // 8, m // 128), generator=g) < density
    rmask = blocks.repeat_interleave(8, 0).repeat_interleave(128, 1).float()
    a = torch.randn((B, n), generator=g) * act.repeat_interleave(8, 1)
    R = torch.randn((n, m), generator=g) * rmask
    return a.to(dev), R.to(dev), rmask.to(dev)


def k3_path(torch, TRAIN, OPS, steps=8):
    """K3's entry point `ops.event_matmul` driven over the spiral main
    path's first window (no engine calls it, as in the reference): at each
    stream step, every gate's a_prev @ R with the gate's parameter mask as
    rmask, held against the dense product.  Returns the launch counts."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("compact")))
    learner, masks = run["learner"], run["masks"][0]
    xs, ys = stream_window(torch, run, steps)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]),
                         t_total=8.0)
    worst = 0.0
    reset_counts()
    for t in range(steps):
        a, w = carry["a"], carry["params"]
        for gate in ("u", "r", "z"):
            y = OPS.event_matmul(a, w[gate]["R"], masks[gate]["R"])
            want = a @ w[gate]["R"]
            scale = max(float(want.abs().max()), 1.0)
            err = float((y - want).abs().max())
            check(err <= F32_REL * scale, f"K3 path step {t} gate {gate}: "
                                          f"max abs err {err:.3e}")
            worst = max(worst, err)
        carry, _ = learner.step(carry, xs[t], ys[t])
    counts = read_counts()
    check_counts(counts, {"event_matmul": 3 * steps}, "K3 path")
    log(f"K3 path (ops.event_matmul on the spiral main path, {steps} stream "
        f"steps x 3 gates): launches {counts}, max abs err vs a_prev @ R "
        f"{worst:.3e}")
    return counts


def k3_checks(torch, dev, TRAIN, ON, EM, OPS):
    """K3 against its plain version at (a) the spiral main path's a_prev and
    the u gate's masked R, (b) n=256, m=768 at block density 0.5, (c) odd
    shapes and an all-zero a, f32 and bf16; its times; then its entry point
    driven on the main path.  Returns K3's entry for the kernels line."""
    a_prev, R_u, rmask_u = k3_main_operands(torch, TRAIN, ON)
    log(f"K3 (a) main path: a_prev {tuple(a_prev.shape)} with "
        f"{int((a_prev != 0).sum())} events, R_u {tuple(R_u.shape)} with "
        f"{int((R_u != 0).sum())} live weights")
    err_k3, k3_main_ops = compare_k3(torch, EM, OPS, a_prev, R_u, rmask_u,
                                     "(a) f32")
    k3_main_bf16 = compare_k3(torch, EM, OPS, a_prev.bfloat16(), R_u.bfloat16(),
                              rmask_u, "(a) bf16")[1]
    a_b, R_b, rmask_b = k3_synthetic(torch, dev)
    _, k3_big_ops = compare_k3(torch, EM, OPS, a_b, R_b, rmask_b,
                               "(b) n=256 f32")
    _, k3_big_bf16 = compare_k3(torch, EM, OPS, a_b.bfloat16(), R_b.bfloat16(),
                                rmask_b, "(b) n=256 bf16")
    g3 = torch.Generator(device=dev).manual_seed(4)
    a_c = (torch.rand((1, 40), generator=g3, device=dev) > 0.7).float()
    R_c = torch.randn((40, 130), generator=g3, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        compare_k3(torch, EM, OPS, a_c.to(dt), R_c.to(dt), None,
                   f"(c) (1, 40, 130) {dt}")
        compare_k3(torch, EM, OPS, torch.zeros((4, 24), device=dev, dtype=dt),
                   torch.randn((24, 256), generator=g3, device=dev).to(dt), None,
                   f"(c) all-zero a {dt}")
    k3_times = {"(a) f32": time_k3(torch, EM, k3_main_ops, 500),
                "(a) bf16": time_k3(torch, EM, k3_main_bf16, 500),
                "(b) n=256 f32": time_k3(torch, EM, k3_big_ops, 200),
                "(b) n=256 bf16": time_k3(torch, EM, k3_big_bf16, 200)}
    for label, t in k3_times.items():
        dt = label.split()[-1]
        log(f"K3 time {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, torch.matmul ({dt}) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}: {t['bytes']:.0f} B, {t['flops']:.0f} FLOP)")
        log(f"K3 in turn {label}: kernel {t['alt_ms']:.4f} ms, torch.matmul "
            f"({dt}) {t['alt_library_ms']:.4f} ms (median of 5 rounds)")
        log(f"K3 device {label}: kernel {t['device_us']} us, torch.matmul "
            f"({dt}) {t['library_device_us']} us (profiler, 20 calls)")
        log(f"K3 host {label}: {fmt_path(t['host_us'])}")
    log("K3 times json: " + json.dumps(k3_times))
    k3_counts = k3_path(torch, TRAIN, OPS)
    t3 = k3_times["(a) f32"]
    return {"name": "event_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/event_matmul.cu",
            "replaces": "src/repro/kernels/event_matmul.py:38",
            "launches": k3_counts["event_matmul"], "max_abs_err": err_k3,
            "ms": t3["ms"], "plain_ms": t3["plain_ms"],
            "bound_ms": t3["bound_ms"], "bound_by": t3["bound_by"],
            "library_ms": t3["library_ms"]}


# ---------------------------------------------------------------------------
# phase 7: K4 against its plain version, and RWKV6-3B serving
# ---------------------------------------------------------------------------

def k4_bound(torch, ops, chunk):
    """Least time (ms) for the chunked WKV on these inputs: the bytes it
    must move (r/k/v, logw, u, S0 read; o and S written) over HBM
    bandwidth, against the f32 operations of the chunk algebra (the state
    and the decays are f32) over the CUDA-core f32 peak.  Per chunk of L
    steps and head of width D: the inter term and the state update
    2*L*D*D each, the decay of the state 2*D*D, A's strict triangle 5 per
    (pair, channel) (sub, min, exp, mul, fma) and its diagonal 3, A v
    2 per (pair, column) on the triangle, and 7*L*D for the cumulative
    sum, the exponentials and the scalings."""
    r, k, v, logw, u, S0 = ops
    B, H, T, D = r.shape
    L = chunk
    nbytes = float(3 * r.numel() * r.element_size() + 4 * logw.numel()
                   + 4 * u.numel() + (0 if S0 is None else 4 * S0.numel())
                   + 4 * B * H * T * D + 4 * B * H * D * D)
    per_chunk = (4 * L * D * D + 2 * D * D + 5 * D * L * (L - 1) // 2
                 + 3 * D * L + 2 * D * L * (L + 1) // 2 + 7 * L * D)
    flops = float(B * H * (T // L) * per_chunk)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def compare_k4(torch, WK, ops, chunk, label):
    """Kernel vs plain version on the card, o and S_final.  Returns (max
    abs error of o, S_final)."""
    o, S = WK.wkv(*ops, chunk=chunk)
    torch.cuda.synchronize()                    # a fault surfaces here
    o_ref, S_ref = WK.wkv_reference(*ops, chunk=chunk)
    bf16 = ops[0].dtype == torch.bfloat16
    errs = []
    for name, got, ref in (("o", o, o_ref), ("S_final", S, S_ref)):
        check(got.dtype == torch.float32 and got.shape == ref.shape,
              f"K4 {label}: {name} {got.dtype} {tuple(got.shape)}")
        errs.append(within(got, ref, bf16, f"K4 {label} {name}"))
    B, H, T, D = ops[0].shape
    log(f"K4 {label}: B={B} H={H} T={T} D={D} L={chunk} {ops[0].dtype}"
        f"{'' if ops[5] is None else ', S0 given'}: o max_abs_err "
        f"{errs[0][0]:.3e} (scale {errs[0][1]:.3e}), S_final max_abs_err "
        f"{errs[1][0]:.3e} (scale {errs[1][1]:.3e})")
    return errs[0][0], S


def time_k4(torch, WK, ops, chunk, iters):
    ms = time_ms(torch, lambda: WK.wkv(*ops, chunk=chunk), iters)
    plain = time_ms(torch, lambda: WK.wkv_reference(*ops, chunk=chunk), 3,
                    warmup=1)
    bound, by, nbytes, flops = k4_bound(torch, ops, chunk)
    return {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "flops": flops,
            "device_us": device_us(torch, lambda: WK.wkv(*ops, chunk=chunk))}


def k4_launch_shape(WK, ops, chunk):
    """K4's launch on these operands: grid, cluster, threads, shared bytes,
    registers, residency (`wkv.geometry`), as one line."""
    B, H, T, D = ops[0].shape
    geo = WK.geometry(B, H, D, chunk, ops[0].dtype, ops[0].device)
    return (f"grid {geo['grid']} CTAs ({geo['ctas_per_head']} a head, "
            f"clusters of {geo['cluster']}), {geo['threads']} threads, "
            f"{geo['smem_bytes']} shared bytes a CTA, {geo['registers']} "
            f"registers and {geo['spill_bytes']} spilled bytes a thread, "
            f"{geo['ctas_per_sm']} CTAs an SM, {geo['clusters_resident']} "
            f"clusters resident on the card, {geo['stages']} input stages")


@contextlib.contextmanager
def recorded_wkv(WK, calls):
    """Inside the block each K4 launch appends its heads to `calls`, the
    first launch its operands first: the recorder stands in for the
    module's `launch`, which the wrapper (`WK.wkv`, which counts itself)
    calls with its checked operands."""
    launch = WK.launch

    def recorded(call, args):
        if not calls:
            calls.append([t.clone() for t in args] + [None] * (6 - len(args)))
        calls.append(int(args[0].shape[1]))
        return launch(call, args)
    WK.launch = recorded
    try:
        yield
    finally:
        WK.launch = launch


@contextlib.contextmanager
def plain_wkv(WK):
    """Inside the block the RWKV6 model's WKV (`WK.wkv`, which `models.rwkv`
    calls) is its plain version: the way to hold a whole prefill on the
    card against it.  The package itself has no such switch."""
    kernel = WK.wkv
    WK.wkv = WK.wkv_reference
    try:
        yield
    finally:
        WK.wkv = kernel


def bf16_layers_vs_plain(torch, RW, WK, cfg, params, tokens, ctx=None):
    """Every layer's bf16 time-mix output with the kernel and with the plain
    WKV, both on the kernel path's layer input, so no round-off carries
    from one layer to the next.  Returns the largest max abs difference
    over the layer's largest magnitude.  With a mesh's `ctx`, on this
    rank's local shards (`params`): K4 on the rank's heads."""
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.module import NULL_CTX
    from repro_torch.models.transformer import _norm
    ctx = ctx or NULL_CTX
    top = ctx.use_top(params, lambda: RW.rwkv_model_specs(cfg))
    x = _norm(cfg, top["ln0"], embed_tokens(cfg, top["emb"], tokens, ctx))
    worst = 0.0
    for lp in RW._layers(cfg, params["units"]):
        lp = ctx.use(lp, RW.layer_specs(cfg))
        xin = _norm(cfg, lp["ln1"], x)
        h, _ = RW.time_mix(cfg, lp["tm"], xin, ctx=ctx)
        with plain_wkv(WK):
            h_plain, _ = RW.time_mix(cfg, lp["tm"], xin, ctx=ctx)
        h, h_plain = h.float(), h_plain.float()
        check(bool(h.isfinite().all()), "bf16 time-mix: non-finite output")
        worst = max(worst, float((h - h_plain).abs().max())
                    / float(h_plain.abs().max()))
        x = x + h.to(x.dtype)
        x = x + RW.channel_mix(cfg, lp["cm"], _norm(cfg, lp["ln2"], x),
                               ctx=ctx)[0]
    return worst


def k4_layer0_operands(torch, RW, cfg, params, tokens):
    """K4's operands at layer 0 of a real prefill of `tokens`: embedding,
    ln0, ln1, then the time-mix inputs, moved to [B, H, T, D]."""
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.transformer import _norm
    from repro_torch.tree import tree_map
    lp = tree_map(lambda t: t[0], params["units"])
    x = _norm(cfg, params["ln0"], embed_tokens(cfg, params["emb"], tokens))
    r, k, v, logw, _, _ = RW.time_mix_inputs(cfg, lp["tm"], _norm(cfg, lp["ln1"], x))
    tr = lambda t: t.transpose(1, 2).contiguous()
    return [tr(r), tr(k), tr(v), tr(logw), lp["tm"]["u"].contiguous(), None]


def k4_edges(torch, ops, S_final):
    """(c): f32 copies of (a)'s operands cut to T == L (16) and T < L (8,
    taken as L = T, as wkv_full does), and decays at both clip ends of
    decay_logw (ww = 10: logw = -e^10; ww = -20: logw = -e^-20) over 64
    steps from (a)'s final state.  Yields (label, operands, chunk)."""
    r, k, v, logw, u, _ = ops
    cut = lambda T: [t[:, :, :T].float().contiguous() for t in (r, k, v)]
    yield "(c) T == L f32", cut(16) + [logw[:, :, :16].contiguous(), u, None], 16
    yield "(c) T < L f32", cut(8) + [logw[:, :, :8].contiguous(), u, None], 8
    for ww in (10.0, -20.0):
        lw = torch.full_like(logw[:, :, :64], -math.exp(ww))
        yield (f"(c) ww={ww:g} (logw {-math.exp(ww):.6g}) f32, S0 given",
               cut(64) + [lw, u, S_final], 16)


def profile_device(torch, fn, label, kernel):
    """torch.profiler over one call of fn: device busy and idle share of
    the wall time, the named kernel's device time, the largest totals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"trace {label}: the profiler recorded no device events: device "
            "busy share not measured")
        return None
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    kern = sum(v[0] for n, v in by_name.items() if kernel in n)
    log(f"trace {label} (profiler on): {len(dev)} device ops, device busy "
        f"{busy:.0f} us of {wall_us:.0f} us wall (idle share "
        f"{1 - busy / wall_us:.3f}), {kernel} {kern:.0f} us "
        f"({kern / max(busy, 1e-9):.3f} of busy)")
    for n, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {tot:10.1f} us  x{cnt:5d}  {n[:90]}")
    total = sum(v[0] for v in by_name.values())
    return {"ops": len(dev), "busy_us": busy, "wall_us": wall_us,
            "idle": 1 - busy / wall_us, "kernel_us": kern,
            "kernel_share": kern / max(total, 1e-9)}


def rwkv_serving(torch, dev, WK):
    """RWKV6-3B at full width and depth, bf16, weights drawn on the card
    from a seeded generator: the serving main path (prefill of 4 x 2048
    tokens, 16 greedy decode steps from its cache, the launcher's Engine),
    K4 against its plain version on layer 0's operands, every layer's
    bf16 time mix and the full-depth f32-compute prefill against the plain
    WKV, and the f32 checks at full width and 2 layers.  Returns (K4's
    entry for the kernels line, the main path's counts)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SERVE
    from repro_torch.models import rwkv as RW
    from repro_torch.models.module import count_params, materialize
    from repro_torch.tree import tree_leaves

    cfg = get_config("rwkv6-3b")
    specs = RW.rwkv_model_specs(cfg)
    t0 = time.perf_counter()
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"RWKV6-3B: {cfg.n_layers} layers, d {cfg.d_model}, {RW.n_heads(cfg)}"
        f" x {cfg.head_dim} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{count_params(specs):,} parameters, {nbytes / 1e9:.3f} GB "
        f"({cfg.param_dtype}), drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    B, T, n_dec = 4, 2048, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(1)).to(dev)

    # -- the main path, counted ---------------------------------------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = RW.prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    first_prefill_s = time.perf_counter() - t0
    check(logits.shape == (B, cfg.vocab_size) and logits.dtype == torch.float32,
          f"prefill logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(logits.isfinite().all()), "prefill: non-finite logits")
    prefill_counts = read_counts()
    check_counts(prefill_counts, {"wkv": cfg.n_layers}, "prefill")
    tok, step_ms = logits.argmax(-1)[:, None], []
    dec_cache = cache
    for _ in range(n_dec):
        t1 = time.perf_counter()
        dlogits, dec_cache = RW.decode_step(cfg, params, tok, dec_cache, None)
        tok = dlogits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        check(bool(dlogits.isfinite().all()), "decode: non-finite logits")
    mdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        served = SERVE.main(["--arch", "rwkv6-3b", "--requests", "6",
                             "--max-new", "12", "--metrics-dir", str(mdir)])
        counts = read_counts()
        check_counts(counts, {"wkv": cfg.n_layers}, "serving main path")
        s = served["summary"]
        check(s["requests"] == 6 and s["failed"] == 0
              and served["failed_requests"] == []
              and all(len(o) == 12 for o in served["outputs"]),
              f"Engine: {s}, failed {served['failed_requests']}")
        # (t4): the decode path's metrics directory
        man = validated_dir(mdir, "(t4) launch.serve --metrics-dir")
        check(man["final"]["tokens"] == s["tokens"]
              and man["config"]["mode"] == "decode",
              f"(t4) manifest {man['final']} {man['config'].get('mode')}")
        log(f"(t4) launch.serve --metrics-dir: the validator clean, the "
            f"manifest's tokens {man['final']['tokens']} = the summary's")
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    log(f"serving main path (prefill {B} x {T}, {n_dec} decode steps, Engine): "
        f"launches {counts}; first prefill {first_prefill_s * 1e3:.1f} ms")
    log(f"decode: {n_dec} greedy steps of batch {B} from the prefill cache, "
        f"median {statistics.median(step_ms):.2f} ms a step (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), "
        f"{B * 1e3 / statistics.median(step_ms):.1f} tok/s")
    log(f"Engine (launch.serve, 6 requests, 12 new tokens, 4 slots): "
        f"{s['tokens']} tokens in {s['wall_s']} s, {s['tok_per_s']} tok/s")

    # -- prefill timing, and the prefill against the plain WKV ---------------
    prefill_ms = [time_ms(torch, lambda: RW.prefill(cfg, params, tokens), 1,
                          warmup=0) for _ in range(3)]
    log(f"prefill {B} x {T}: {min(prefill_ms):.2f} ms (runs "
        f"{', '.join(f'{x:.2f}' for x in prefill_ms)}), "
        f"{B * T * 1e3 / min(prefill_ms):.0f} tokens/s")
    profile_device(torch, lambda: RW.prefill(cfg, params, tokens),
                   f"prefill {B} x {T}", "wkv_kernel")
    profile_device(torch, lambda: RW.decode_step(cfg, params, tok, dec_cache, None),
                   f"decode step (batch {B})", "wkv_kernel")
    worst = bf16_layers_vs_plain(torch, RW, WK, cfg, params, tokens)
    check(worst <= 0.05, f"bf16 time mix, kernel vs plain WKV: {worst:.4g} of "
                         "the largest magnitude in some layer")
    log(f"bf16 time-mix output of each of the {cfg.n_layers} layers, kernel vs "
        f"plain WKV on the same layer input: largest max abs difference "
        f"{worst:.4g} of the layer's largest magnitude (bound 0.05)")
    cfg_f32 = cfg.replace(compute_dtype=torch.float32)
    f32_logits, _ = RW.prefill(cfg_f32, params, tokens)
    with plain_wkv(WK):
        f32_plain, _ = RW.prefill(cfg_f32, params, tokens)
    scale = float(f32_logits.abs().max())
    err_f32 = float((f32_logits - f32_plain).abs().max())
    check(err_f32 <= 1e-4 * scale, f"f32-compute prefill, kernel vs plain WKV: "
                                   f"{err_f32:.3e} (scale {scale:.4g})")
    log(f"f32-compute prefill (bf16 weights, full depth), kernel vs plain WKV: "
        f"last-position logits max abs err {err_f32:.3e} of {scale:.4g} "
        f"(bound 1e-4 of it)")

    # -- K4 against its plain version ----------------------------------------
    ops = k4_layer0_operands(torch, RW, cfg, params, tokens)
    err_a, S_a = compare_k4(torch, WK, ops, cfg.rwkv_chunk,
                            "(a) layer 0 of the prefill")
    compare_k4(torch, WK, ops[:5] + [S_a], cfg.rwkv_chunk,
               "(b) the same from a non-zero S0")
    for label, edge, chunk in k4_edges(torch, ops, S_a):
        compare_k4(torch, WK, edge, chunk, label)
    t4 = time_k4(torch, WK, ops, cfg.rwkv_chunk, 20)
    log(f"K4 time (a): kernel {t4['ms']:.4f} ms, plain {t4['plain_ms']:.4f} ms, "
        f"no library call computes WKV, bound {t4['bound_ms']:.4f} ms "
        f"({t4['bound_by']}: {t4['bytes']:.0f} B, {t4['flops']:.0f} FLOP); "
        f"device {t4['device_us']} us (profiler, 20 calls)")
    log(f"K4 launch (a): {k4_launch_shape(WK, ops, cfg.rwkv_chunk)}")
    log("K4 times json: " + json.dumps(t4))
    del params, cache, dec_cache, ops, S_a, logits, f32_logits, f32_plain
    torch.cuda.empty_cache()

    # -- f32 at full width, 2 layers -----------------------------------------
    cfg2 = cfg.replace(n_layers=2, param_dtype=torch.float32,
                       compute_dtype=torch.float32)
    p2 = materialize(RW.rwkv_model_specs(cfg2),
                     torch.Generator(device=dev).manual_seed(2))
    toks = tokens[:, :64]
    lk, _ = RW.prefill(cfg2, p2, toks)
    with plain_wkv(WK):
        lp, _ = RW.prefill(cfg2, p2, toks)
    scale = float(lp.abs().max())
    err_kp = float((lk - lp).abs().max())
    check(err_kp <= 1e-4 * scale, f"f32 prefill kernel vs plain: {err_kp:.3e} "
                                  f"(scale {scale:.3e})")
    dcache = RW.init_cache(cfg2, B, 65, dev)
    for t in range(toks.shape[1]):
        ld, dcache = RW.decode_step(cfg2, p2, toks[:, t:t + 1], dcache, None)
    err_tf = float((ld - lk).abs().max())
    check(err_tf <= 1e-4 * scale, f"f32 prefill vs teacher-forced decode: "
                                  f"{err_tf:.3e} (scale {scale:.3e})")
    log(f"f32, full width, 2 layers, {B} x 64 tokens: prefill kernel vs plain "
        f"{err_kp:.3e}, prefill vs teacher-forced decode {err_tf:.3e}, of the "
        f"largest logit {scale:.4g} (bound 1e-4 of it)")
    del p2
    torch.cuda.empty_cache()
    entry = {"name": "wkv", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/wkv.cu",
             "replaces": "src/repro/kernels/wkv.py:73",
             "launches": counts["wkv"], "max_abs_err": err_a,
             "ms": t4["ms"], "plain_ms": t4["plain_ms"],
             "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
             "library_ms": None}
    return entry, counts


# ---------------------------------------------------------------------------
# phase 13: the dense decoders and LM training
# ---------------------------------------------------------------------------

GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


@contextlib.contextmanager
def named_ranges(ranges):
    """Each call of the functions in `ranges` {name: [(module, attr), ...]}
    inside a profiler range of that name (the traces attribute device time
    to it); the module attributes are restored on exit."""
    from torch.profiler import record_function
    saved = [(m, a, getattr(m, a)) for fns in ranges.values() for m, a in fns]

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call
    for name, fns in ranges.items():
        for m, a in fns:
            setattr(m, a, ranged(name, getattr(m, a)))
    try:
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def profile_ranges(torch, fn, label, ranges, warm=True):
    """torch.profiler over one call of fn (after a warm call unless `warm`
    is false): device ops, the idle share of the wall time, and the shares
    of the kernel time taken by the kernels inside each named range of
    `ranges` (`named_ranges`; a forward's calls: a backward's kernels run
    outside them) and by GEMM kernels (by name).  Returns the numbers (None
    where the profiler recorded no device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with named_ranges(ranges), profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # the ranges show on the device timeline too, as annotations spanning
    # their kernels
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in ranges]
    if not dev:
        log(f"trace {label}: the profiler recorded no device events: shares "
            "not measured")
        return None
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kern = sum(e.time_range.elapsed_us() for e in dev)
    gemm = sum(e.time_range.elapsed_us() for e in dev
               if any(g in e.name.lower() for g in GEMM_NAMES))
    out = {"ops": len(dev), "busy_us": busy, "wall_us": wall_us,
           "idle": 1 - busy / wall_us, "gemm": gemm / kern}
    shares = []
    for name in ranges:
        windows = sorted((e.time_range.start, e.time_range.end) for e in events
                         if e.device_type == DeviceType.CUDA and e.name == name)
        starts = [w[0] for w in windows]

        def inside(e):
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            return i >= 0 and e.time_range.end <= windows[i][1]
        us = sum(e.time_range.elapsed_us() for e in dev if inside(e))
        out[name] = us / kern
        shares.append(f"{name}'s kernels {us:.0f} us ({out[name]:.3f})")
    log(f"trace {label} (profiler on): {len(dev)} device ops, device busy "
        f"{busy:.0f} us of {wall_us:.0f} us wall (idle share "
        f"{out['idle']:.3f}); of {kern:.0f} us kernel time, "
        + ", ".join(shares + [f"GEMM kernels {gemm:.0f} us "
                              f"({out['gemm']:.3f})"]))
    by_name = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    for n, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        log(f"  {tot:10.1f} us  x{cnt:5d}  {n[:90]}")
    return out


def attention(A):
    """The ranges of flash and decode attention (phase 13's split)."""
    return {"attention": [(A, "flash_attention"), (A, "decode_attention")]}


def profile_split(torch, A, fn, label):
    """`profile_ranges` with attention's range."""
    return profile_ranges(torch, fn, label, attention(A))


def matmul_flops(cfg, leaves):
    """2 a multiply-add of every weight matrix a token passes through: the
    2-D leaves whole (a depthwise conv's [K, w] taps too: K multiply-adds a
    channel), a MoE layer's [E, d, f] expert leaves at top_k of their E
    experts (the active experts only)."""
    n = 0
    for t in leaves:
        if t.dim() == 2:
            n += t.numel()
        elif t.dim() == 3:
            n += t.numel() * cfg.top_k // cfg.n_experts
    return 2 * n


def attention_flops(cfg, B, S, windows):
    """Causal attention's QK^T and P.V over the pairs each query needs, for
    one layer of each window in `windows` (0: global)."""
    pairs = 0
    for w in windows:
        pairs += sum(min(q + 1, w) if w else q + 1 for q in range(S))
    return 4 * B * cfg.n_heads * cfg.head_dim * pairs


def decoder_flops(cfg, params, B, S):
    """The prefill's FLOPs, counted from the shapes: every unit weight
    matrix for each of the B*S tokens (`matmul_flops`), the logits at the
    last position (B x d x V), and causal attention (a local layer's window
    included)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    mm = sum(matmul_flops(cfg, tree_leaves(unit))
             for unit in T._units(cfg, params["units"]))
    windows = [cfg.local_window if kind == "local" else 0
               for kind in T.unit_layout(cfg)] * T.n_units(cfg)
    return (mm * B * S + 2 * B * cfg.d_model * cfg.vocab_size
            + attention_flops(cfg, B, S, windows))


def flash_checks(torch, dev, A, REF, cfg_g, cfg_q):
    """(p2a) the chunked flash attention against flash_attention_ref on the
    card: gemma2's head shape causal and with a window of 1024, qwen3's
    qk-normed; f32 within 1e-5 of the largest magnitude, bf16 one bf16
    step more.  Returns the largest f32 error relative to its scale."""
    from repro_torch.models.layers import rmsnorm
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    cases = [("gemma2 causal", cfg_g, 0), ("gemma2 window 1024", cfg_g, 1024),
             ("qwen3 qk-norm", cfg_q, 0)]
    for label, cfg, window in cases:
        B, S = 4, 2048
        q, k, v = (torch.randn((B, S, h, cfg.head_dim), generator=gen,
                               device=dev)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        if cfg.qk_norm:
            ones = torch.ones(cfg.head_dim, device=dev)
            q, k = rmsnorm(q, ones), rmsnorm(k, ones)
        for dtype in (torch.float32, torch.bfloat16):
            c = cfg.replace(compute_dtype=dtype)
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = A.flash_attention(c, qd, kd, vd, causal=True, window=window)
            ref = REF.flash_attention_ref(qd, kd, vd, causal=True,
                                          window=window, scale=A._scale(c),
                                          cap=c.attn_softcap)
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            tol = F32_REL + (BF16_STEP if dtype == torch.bfloat16 else 0.0)
            check(bool(got.isfinite().all()) and err <= tol * scale,
                  f"(p2a) {label} {dtype}: chunked vs plain {err:.3e} "
                  f"(scale {scale:.4g})")
            if dtype == torch.float32:
                worst = max(worst, err / scale)
            log(f"(p2a) flash attention {label}, B {B} S {S} H {cfg.n_heads} "
                f"KV {cfg.n_kv_heads} Dh {cfg.head_dim} softcap "
                f"{cfg.attn_softcap} {str(dtype)[6:]}: chunked vs "
                f"flash_attention_ref {err:.3e} of {scale:.4g} (bound "
                f"{tol:.3g} of it)")
            del got, ref
    torch.cuda.empty_cache()
    return worst


# the tokens of the decoders' card-against-CPU gradients, (p2c), (p3),
# (m2) and (m4) (64 through PR 29: the CPU's passes over the full-width
# f32 model, at one thread and at its default count, were most of those
# checks' time; whisper's (w2) keeps 64, its 1,500 frames set its cost)
CPU_S = 32


def grads_card_vs_cpu(torch, loss_fn, cfg, params, batch, label):
    """Loss and gradients of `params` (on the card) and of their CPU copy:
    the loss within 1e-5; each gradient leaf within 1e-5 of its largest
    entry, or within twice the CPU's own spread, whichever is larger.  The
    spread is the largest leaf difference between the CPU's gradients at
    one thread and at its default thread count: the same f32 arithmetic
    summed in another order, which at full width moves these gradients by
    about 1e-5 (gemma2-2b, recurrentgemma) and 1e-4 (rwkv6-3b) of a leaf's
    largest entry; it is measured where a leaf sits past 1e-5, 0 taken
    elsewhere.  Returns (loss error, worst leaf error, the CPU's spread),
    relative."""
    from repro_torch.optim import microbatch_grads
    from repro_torch.tree import leaf_name, tree_flatten_with_path, tree_map
    fn = lambda p, b: loss_fn(cfg, p, b)
    ld, gd = microbatch_grads(fn, params, batch, 1)
    cpu = tree_map(lambda t: t.detach().cpu(), params)
    lc, gc = microbatch_grads(fn, cpu, {k: v.cpu() for k, v in batch.items()},
                              1)
    lerr = abs(float(ld) - float(lc)) / abs(float(lc))
    errs = sorted(((float((a.cpu() - b).abs().max())
                    / max(float(b.abs().max()), 1e-30), leaf_name(path))
                   for (path, b), a in zip(tree_flatten_with_path(gc),
                                           [x for _, x in
                                            tree_flatten_with_path(gd)])),
                  reverse=True)
    worst = errs[0][0]
    # the CPU against itself at one thread: the f32 spread of another
    # reduction order; it can only raise the bound above 1e-5, so it is
    # measured only where a gradient sits past 1e-5 (the one-thread pass
    # is the comparison's longest part)
    threads, spread, spread_msg = torch.get_num_threads(), 0.0, "not needed"
    if worst > F32_REL:
        torch.set_num_threads(1)
        try:
            l1, g1 = microbatch_grads(fn, cpu, {k: v.cpu() for k, v in
                                                batch.items()}, 1)
        finally:
            torch.set_num_threads(threads)
        spread = max(float((a - b).abs().max())
                     / max(float(b.abs().max()), 1e-30)
                     for (_, a), (_, b) in zip(tree_flatten_with_path(g1),
                                               tree_flatten_with_path(gc)))
        spread_msg = (f"loss {abs(float(l1) - float(lc)) / abs(float(lc)):.2e}"
                      f", gradients {spread:.2e}")
    log(f"{label}: loss card {float(ld):.7f} cpu {float(lc):.7f} (relative "
        f"{lerr:.2e}), gradients: worst leaves "
        f"{', '.join(f'{n} {e:.2e}' for e, n in errs[:3])} of their largest "
        f"entry; the CPU at 1 thread against {threads}: {spread_msg} (bound: "
        f"the larger of 1e-5 and twice that spread)")
    bound = max(F32_REL, 2 * spread)
    check(lerr <= F32_REL and worst <= bound,
          f"{label}: loss {lerr:.3e}, gradients {worst:.3e} (bound "
          f"{bound:.3e})")
    return lerr, worst, spread


def decode_vs_full(torch, T, cfg, params, toks, S, n):
    """Prefill of S tokens with room for n more, then n teacher-forced
    decode steps, against the full forward over S + n: the largest
    difference over the n + 1 logit rows, relative to the largest logit."""
    B = toks.shape[0]
    full = T.forward_logits(cfg, params, toks[:, :S + n], start=S - 1)
    lg, cache = T.prefill(cfg, params, toks[:, :S], max_seq=S + n)
    errs = [float((lg - full[:, 0]).abs().max())]
    for i in range(n):
        pos = torch.full((B,), S + i, device=toks.device)
        lg, cache = T.decode_step(cfg, params, toks[:, S + i:S + i + 1], cache,
                                  pos)
        errs.append(float((lg - full[:, i + 1]).abs().max()))
    return max(errs) / float(full.abs().max())


def decoder_serving(torch, dev, A, SERVE, T):
    """(p1) gemma2-2b at full width and depth, and (p4)'s serving costs.
    Returns the costs."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import count_params, materialize
    cfg = get_config("gemma2-2b")
    specs = T.decoder_specs(cfg)
    t0 = time.perf_counter()
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(specs)
    check(n_params == 2_614_341_888, f"gemma2-2b: {n_params:,} parameters")
    log(f"gemma2-2b: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} x "
        f"{cfg.head_dim} heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {n_params:,} parameters ({cfg.param_dtype}),"
        f" drawn on the card in {time.perf_counter() - t0:.2f} s")
    B, S, n_dec = 4, 2048, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    reset_counts()
    logits, cache = T.prefill(cfg, params, tokens, max_seq=S + n_dec)
    check(logits.shape == (B, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"gemma2-2b prefill logits {tuple(logits.shape)}")
    tok, step_ms = logits.argmax(-1)[:, None], []
    dcache = cache
    for i in range(n_dec):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pos = torch.full((B,), S + i, device=dev)
        dl, dcache = T.decode_step(cfg, params, tok, dcache, pos)
        tok = dl.argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        check(bool(dl.isfinite().all()), "gemma2-2b decode: non-finite logits")
    check_counts(read_counts(), {}, "gemma2-2b prefill and decode")
    served = {}
    for argv in ([], ["--arch", "qwen3-8b"]):
        reset_counts()
        out = SERVE.main(argv)
        check_counts(read_counts(), {}, f"launch.serve {argv}")
        s = out["summary"]
        check(s["requests"] == 6 and s["failed"] == 0
              and out["failed_requests"] == []
              and all(len(o) == 12 for o in out["outputs"]),
              f"launch.serve {argv}: {s}, failed {out['failed_requests']}")
        served[s["arch"]] = s
        log(f"(p1) launch.serve {' '.join(argv) or '(defaults)'}: "
            f"{s['arch']} at full size, {s['requests']} requests, "
            f"{s['tokens']} tokens in {s['wall_s']} s, {s['tok_per_s']} "
            f"tok/s, every request completed")
        del out
        torch.cuda.empty_cache()
    log(f"(p1) gemma2-2b: prefill {B} x {S} (max_seq {S + n_dec}) and "
        f"{n_dec} greedy decode steps from its cache, launches K1-K4 0")

    # (p4) the costs
    prefill = lambda: T.prefill(cfg, params, tokens, max_seq=S + n_dec)
    runs = [time_ms(torch, prefill, 1, warmup=1 if i == 0 else 0)
            for i in range(3)]
    flops = decoder_flops(cfg, params, B, S)
    best = min(runs)
    rate = flops / (best / 1e3)
    log(f"(p4) prefill {B} x {S}: {best:.2f} ms (runs "
        f"{', '.join(f'{x:.2f}' for x in runs)}), {B * S * 1e3 / best:.0f} "
        f"tokens/s; {flops:.4g} FLOP (matmuls, last-position logits, causal "
        f"attention) -> {rate / 1e12:.1f} TFLOP/s, {rate / BF16_FLOP_S:.3f} "
        f"of the 989 TFLOP/s bf16 peak (attention's products run in f32)")
    med = statistics.median(step_ms)
    log(f"(p4) decode: {n_dec} greedy steps of batch {B} from the 2064-slot "
        f"cache, median {med:.2f} ms a step (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}), {B * 1e3 / med:.1f} tok/s")
    pos = torch.full((B,), S, device=dev)
    tr_prefill = profile_split(torch, A, prefill, f"gemma2-2b prefill {B} x {S}")
    tr_decode = profile_split(torch, A, lambda: T.decode_step(
        cfg, params, tok, cache, pos), f"gemma2-2b decode step (batch {B})")
    return {"prefill_ms": best, "prefill_tok_s": B * S * 1e3 / best,
            "prefill_flop_share": rate / BF16_FLOP_S, "decode_ms": med,
            "engine_tok_s": {a: s["tok_per_s"] for a, s in served.items()},
            "trace_prefill": tr_prefill, "trace_decode": tr_decode}


def decoder_correctness(torch, dev, A, REF, T):
    """(p2): the chunked attention, gemma2-2b at full width and 2 layers in
    f32 (prefill, decode, the full forward), its gradients card vs CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import materialize
    cfg_g, cfg_q = get_config("gemma2-2b"), get_config("qwen3-8b")
    worst_flash = flash_checks(torch, dev, A, REF, cfg_g, cfg_q)
    cfg = cfg_g.replace(n_layers=2, param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    params = materialize(T.decoder_specs(cfg),
                         torch.Generator(device=dev).manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (2, 8192 + 16),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    reset_counts()
    # prefill against the full forward and a teacher-forced decode
    St = 256
    lg, _ = T.prefill(cfg, params, toks[:, :St])
    full = T.forward_logits(cfg, params, toks[:, :St], start=St - 1)[:, 0]
    scale = float(full.abs().max())
    err_full = float((lg - full).abs().max()) / scale
    c = T.init_cache(cfg, 2, St, dev)
    for t in range(St):
        ld, c = T.decode_step(cfg, params, toks[:, t:t + 1], c,
                              torch.full((2,), t, device=dev))
    err_tf = float((lg - ld).abs().max()) / scale
    check(err_full <= 1e-4 and err_tf <= 1e-4,
          f"(p2b) prefill vs full forward {err_full:.3e}, vs teacher-forced "
          f"decode {err_tf:.3e}")
    log(f"(p2b) gemma2-2b full width, 2 layers, f32, 2 x {St} tokens: prefill "
        f"vs the full forward {err_full:.2e}, vs a {St}-step teacher-forced "
        f"decode {err_tf:.2e} of the largest logit (bound 1e-4)")
    errs = {}
    for S, B in ((2048, 2), (8192, 1)):
        errs[S] = decode_vs_full(torch, T, cfg, params, toks[:B], S, 16)
        check(errs[S] <= 1e-4, f"(p2b) prefill {S} + 16 decode steps vs the "
                               f"full forward: {errs[S]:.3e}")
        log(f"(p2b) prefill of {B} x {S} (max_seq {S + 16}) then 16 decode "
            f"steps vs the full forward over {S + 16}: {errs[S]:.2e} of the "
            f"largest logit (bound 1e-4; window {cfg.local_window}"
            f"{', the ring wraps' if S > cfg.local_window else ''})")
    check_counts(read_counts(), {}, "(p2b) the 2-layer decoder")
    batch = {"tokens": toks[:1, :CPU_S], "labels": toks[:1, 1:CPU_S + 1]}
    grads = grads_card_vs_cpu(torch, T.loss_fn, cfg, params, batch,
                              "(p2c) gemma2-2b full width, 2 layers, f32, "
                              f"B 1 S {CPU_S}, card vs CPU")
    del params
    torch.cuda.empty_cache()
    return {"flash_rel": worst_flash, "prefill_vs_full": err_full,
            "prefill_vs_decode": err_tf, "decode_vs_full": errs,
            "grads": grads}


def free_disk_gb(path):
    import shutil
    return shutil.disk_usage(path).free / 1e9


def final_files(root, step):
    d = Path(root) / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".npy"}


def decoder_training(torch, dev, A, TRAIN, STEPS, T, RW, root):
    """(p3) training at full width and cut depth, the f32 check, crash and
    resume; (p4)'s training costs.  Checkpoints go under `root`."""
    import shutil
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.module import materialize
    costs = {}
    for arch in ("gemma2-2b", "rwkv6-3b"):
        ck = Path(root) / arch
        log(f"(p3) {arch}: {free_disk_gb(root):.1f} GB free under the "
            f"checkpoint root before the run writes its final checkpoint")
        # the depth cut to 4 layers keeps the script inside its time limit
        costs[arch] = cut_training(torch, TRAIN, STEPS, arch, 4, ck, "(p3)")
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if arch == "rwkv6-3b":
            params = materialize(RW.rwkv_model_specs(cfg),
                                 torch.Generator(device=dev).manual_seed(0))
            reset_counts()
            RW.prefill(cfg, params, torch.zeros((1, 64), dtype=torch.long,
                                                device=dev))
            counts = read_counts()
            check_counts(counts, {"wkv": cfg.n_layers}, "(p3) rwkv6-3b prefill "
                                                        "after training")
            log(f"(p3) rwkv6-3b: K4 0 launches in training, {counts['wkv']} in "
                f"a prefill after it")
            del params
        else:
            # one train step traced, on fresh parameters and moments
            params = materialize(T.decoder_specs(cfg),
                                 torch.Generator(device=dev).manual_seed(0))
            opt = STEPS.default_optimizer(cfg)
            state = [params, opt.init(params)]
            step_fn = STEPS.make_train_step(cfg, opt)
            batch = TRAIN.build_model_lm(TRAIN.parse_args(
                ["--arch", arch, "--ckpt-dir", str(ck)]))["data_at"](0)

            def one_step():
                state[0], state[1], m = step_fn(state[0], state[1], batch, 0)
                return m
            costs["trace_train"] = profile_split(
                torch, A, one_step, "gemma2-2b train step (4 x 64)")
            del params, state, opt
        torch.cuda.empty_cache()

    # rwkv6-3b at full width, 2 layers, f32: card against CPU
    cfg = get_config("rwkv6-3b").replace(n_layers=2, param_dtype=torch.float32,
                                         compute_dtype=torch.float32)
    params = materialize(RW.rwkv_model_specs(cfg),
                         torch.Generator(device=dev).manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (1, CPU_S + 1),
                         generator=torch.Generator().manual_seed(6)).to(dev)
    reset_counts()
    costs["rwkv_grads"] = grads_card_vs_cpu(
        torch, RW.loss_fn, cfg, params,
        {"tokens": toks[:, :CPU_S], "labels": toks[:, 1:]},
        f"(p3) rwkv6-3b full width, 2 layers, f32, B 1 S {CPU_S}, card vs "
        "CPU")
    check_counts(read_counts(), {}, "(p3) rwkv6-3b loss and gradients")
    del params
    torch.cuda.empty_cache()

    # crash and resume at --smoke
    for arch in ("gemma2-2b", "rwkv6-3b"):
        argv = ["--arch", arch, "--smoke", "--ckpt-every", "5"]
        a = TRAIN.main([*argv, "--fail-at", "7", "--ckpt-dir",
                        str(Path(root) / f"{arch}_a")])
        b = TRAIN.main([*argv, "--ckpt-dir", str(Path(root) / f"{arch}_b")])
        check((a["restarts"], b["restarts"]) == (1, 0)
              and a["final_step"] == b["final_step"] == 20,
              f"(p3) crash and resume {arch}: restarts {a['restarts']} / "
              f"{b['restarts']}, steps {a['final_step']} / {b['final_step']}")
        fa = final_files(Path(root) / f"{arch}_a", 20)
        fb = final_files(Path(root) / f"{arch}_b", 20)
        check(fa.keys() == fb.keys() and fa and all(fa[k] == fb[k] for k in fa),
              f"(p3) crash and resume {arch}: the final checkpoints differ")
        log(f"(p3) crash and resume {arch} --smoke --ckpt-every 5 --fail-at 7:"
            f" restarts 1 / 0, the final checkpoints' {len(fa)} leaves bitwise")
    return costs


def decoder_phase(torch, dev):
    """Phase 13: the dense decoders and LM training (module docstring)."""
    import shutil
    import tempfile
    from repro_torch.kernels import ref as REF
    from repro_torch.launch import serve as SERVE, steps as STEPS
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import attention as A, rwkv as RW
    from repro_torch.models import transformer as T
    serving = decoder_serving(torch, dev, A, SERVE, T)
    torch.cuda.empty_cache()
    correct = decoder_correctness(torch, dev, A, REF, T)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    try:
        training = decoder_training(torch, dev, A, TRAIN, STEPS, T, RW, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("phase 13 json: " + json.dumps({"serving": serving,
                                         "correctness": correct,
                                         "training": training}))


# ---------------------------------------------------------------------------
# phase 14: the MoE decoders and the Griffin RG-LRU LM
# ---------------------------------------------------------------------------

def moe_ranges(M):
    """The MoE block's dispatch (router output to combine, the experts'
    products inside it) and the experts' products alone."""
    return {"dispatch": [(M, "_dispatch")], "experts": [(M, "_expert_ffn")]}


def rglru_flops(cfg, params, R, B, S):
    """The rglru prefill's FLOPs from the shapes: every weight matrix of
    the units and the rem layers for each token (`matmul_flops`), the
    last position's logits, the local attention layers' pairs (the scan is
    elementwise and not counted)."""
    from repro_torch.tree import tree_leaves
    U, _ = R.n_units(cfg)
    mm = matmul_flops(cfg, [t for unit in R._units(cfg, params["units"])
                            for t in tree_leaves(unit)]
                      + tree_leaves(params["rem"]))
    return (mm * B * S + 2 * B * cfg.d_model * cfg.vocab_size
            + attention_flops(cfg, B, S, [cfg.local_window] * U))


def draw(torch, dev, specs, seed, label, want):
    """The parameters of `specs` drawn on the card from a seeded generator;
    checks the count against `want`."""
    from repro_torch.models.module import count_params, materialize
    t0 = time.perf_counter()
    params = materialize(specs, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n = count_params(specs)
    check(n == want, f"{label}: {n:,} parameters, expected {want:,}")
    log(f"{label}: {n:,} parameters, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return params


def prefill_decode(torch, dev, mod, cfg, params, B, S, n_dec, label):
    """Prefill of B x S with room for n_dec more, then n_dec greedy decodes
    from its cache, K1-K4 counted; every logit finite.  Returns
    (tokens, the cache after the prefill, the last token, decode ms)."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    reset_counts()
    logits, cache = mod.prefill(cfg, params, tokens, max_seq=S + n_dec)
    check(logits.shape == (B, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{label} prefill logits {tuple(logits.shape)}")
    tok, step_ms, dcache = logits.argmax(-1)[:, None], [], cache
    for i in range(n_dec):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dl, dcache = mod.decode_step(cfg, params, tok, dcache,
                                     torch.full((B,), S + i, device=dev))
        tok = dl.argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        check(bool(dl.isfinite().all()), f"{label} decode: non-finite logits")
    check_counts(read_counts(), {}, f"{label} prefill and decode")
    log(f"{label}: prefill {B} x {S} (max_seq {S + n_dec}) and {n_dec} greedy "
        f"decode steps from its cache, every logit finite, launches K1-K4 0")
    return tokens, cache, tok, step_ms


def serve_full(torch, SERVE, arch):
    """`launch.serve.main(["--arch", arch])` at its defaults (6 requests, 4
    slots, 12 new tokens), K1-K4 counted; every request completed."""
    reset_counts()
    out = SERVE.main(["--arch", arch])
    check_counts(read_counts(), {}, f"launch.serve --arch {arch}")
    s = out["summary"]
    check(s["requests"] == 6 and s["failed"] == 0
          and out["failed_requests"] == []
          and all(len(o) == 12 for o in out["outputs"]),
          f"launch.serve --arch {arch}: {s}, failed {out['failed_requests']}")
    log(f"launch.serve --arch {arch}: at full size, {s['requests']} requests "
        f"over {s['slots']} slots, {s['tokens']} tokens in {s['wall_s']} s, "
        f"{s['tok_per_s']} tok/s, every request completed")
    del out
    torch.cuda.empty_cache()
    return s["tok_per_s"]


def serving_costs(torch, dev, mod, cfg, params, tokens, cache, tok, step_ms,
                  flops, ranges, label):
    """The prefill's best of 3 (CUDA events, after a warm run), its tokens/s
    and share of the bf16 peak, decode's median ms, and traces of a prefill
    and a decode step with `ranges`."""
    B, S = tokens.shape
    n_dec = len(step_ms)
    prefill = lambda: mod.prefill(cfg, params, tokens, max_seq=S + n_dec)
    runs = [time_ms(torch, prefill, 1, warmup=1 if i == 0 else 0)
            for i in range(3)]
    best = min(runs)
    rate = flops / (best / 1e3)
    med = statistics.median(step_ms)
    log(f"(c) {label} prefill {B} x {S}: {best:.2f} ms (runs "
        f"{', '.join(f'{x:.2f}' for x in runs)}), {B * S * 1e3 / best:.0f} "
        f"tokens/s; {flops:.4g} FLOP -> {rate / 1e12:.1f} TFLOP/s, "
        f"{rate / BF16_FLOP_S:.3f} of the 989 TFLOP/s bf16 peak")
    log(f"(c) {label} decode: {n_dec} greedy steps of batch {B}, median "
        f"{med:.2f} ms a step (min {min(step_ms):.2f}, max {max(step_ms):.2f})")
    pos = torch.full((B,), S, device=dev)
    tr_p = profile_ranges(torch, prefill, f"{label} prefill {B} x {S}", ranges)
    tr_d = profile_ranges(torch, lambda: mod.decode_step(cfg, params, tok,
                                                         cache, pos),
                          f"{label} decode step (batch {B})", ranges)
    return {"prefill_ms": best, "prefill_tok_s": B * S * 1e3 / best,
            "prefill_flop_share": rate / BF16_FLOP_S, "decode_ms": med,
            "trace_prefill": tr_p, "trace_decode": tr_d}


def moe_serving(torch, dev, A, M, SERVE, T):
    """(m1) olmoe-1b-7b at full size and kimi-k2 at full width, 1 layer;
    (c)'s serving costs."""
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    params = draw(torch, dev, T.decoder_specs(cfg), 0, "(m1) olmoe-1b-7b",
                  6_919_100_416)
    B, S, n_dec = 4, 2048, 16
    tokens, cache, tok, step_ms = prefill_decode(
        torch, dev, T, cfg, params, B, S, n_dec, "(m1) olmoe-1b-7b")
    ranges = {**attention(A), **moe_ranges(M)}
    costs = serving_costs(torch, dev, T, cfg, params, tokens, cache, tok,
                          step_ms, decoder_flops(cfg, params, B, S), ranges,
                          "olmoe-1b-7b")
    del params, cache
    torch.cuda.empty_cache()
    costs["engine_tok_s"] = serve_full(torch, SERVE, "olmoe-1b-7b")

    kimi = get_config("kimi-k2-1t-a32b")
    # one unit, listed: stacking it would hold a second copy of each 11.3 GB
    # expert leaf while it is drawn
    cut = kimi.replace(n_layers=1, scan_layers=False)
    params = draw(torch, dev, T.decoder_specs(cut), 0,
                  f"(m1) kimi-k2-1t-a32b at full width, depth cut from "
                  f"{kimi.n_layers} to 1 layer", 19_395_138_560)
    log(f"(m1) kimi-k2: d {cut.d_model}, {cut.n_heads} x {cut.head_dim} heads, "
        f"{cut.n_kv_heads} KV heads, {cut.n_experts} experts top-{cut.top_k}, "
        f"d_ff {cut.d_ff}, vocab {cut.vocab_size}; 1 of its {kimi.n_layers} "
        f"layers (its 1.03 T parameters do not fit one card)")
    t0 = time.perf_counter()
    _, _, _, kms = prefill_decode(torch, dev, T, cut, params, 2, 1024, 4,
                                  "(m1) kimi-k2 1 layer")
    costs["kimi_s"] = time.perf_counter() - t0
    costs["kimi_decode_ms"] = statistics.median(kms)
    log(f"(m1) kimi-k2 1 layer: prefill 2 x 1024 and 4 decodes in "
        f"{costs['kimi_s']:.2f} s (the first calls), decode median "
        f"{costs['kimi_decode_ms']:.2f} ms a step")
    del params
    torch.cuda.empty_cache()
    return costs


def rglru_serving(torch, dev, A, R, SERVE):
    """(m3) recurrentgemma-9b at full size; (c)'s serving costs."""
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma-9b")
    params = draw(torch, dev, R.rglru_model_specs(cfg), 0,
                  "(m3) recurrentgemma-9b", 9_396_195_328)
    B, S, n_dec = 4, 2048, 16
    tokens, cache, tok, step_ms = prefill_decode(
        torch, dev, R, cfg, params, B, S, n_dec, "(m3) recurrentgemma-9b")
    ranges = {**attention(A), "scan": [(R, "rglru_scan")]}
    costs = serving_costs(torch, dev, R, cfg, params, tokens, cache, tok,
                          step_ms, rglru_flops(cfg, params, R, B, S), ranges,
                          "recurrentgemma-9b")
    del params, cache
    torch.cuda.empty_cache()
    costs["engine_tok_s"] = serve_full(torch, SERVE, "recurrentgemma-9b")
    return costs


def full_vs_decode(torch, mod, cfg, params, toks, S, n):
    """Prefill of S tokens with room for n more, then n teacher-forced
    decode steps, against `mod.forward_logits` over S + n: the largest
    difference over the n + 1 logit rows, relative to the largest logit."""
    B = toks.shape[0]
    full = mod.forward_logits(cfg, params, toks[:, :S + n], start=S - 1)
    lg, cache = mod.prefill(cfg, params, toks[:, :S], max_seq=S + n)
    errs = [float((lg - full[:, 0]).abs().max())]
    for i in range(n):
        pos = torch.full((B,), S + i, device=toks.device)
        lg, cache = mod.decode_step(cfg, params, toks[:, S + i:S + i + 1],
                                    cache, pos)
        errs.append(float((lg - full[:, i + 1]).abs().max()))
    return max(errs) / float(full.abs().max())


def block_grads(torch, M, cfg, p, x, w):
    """Gradients of sum(y * w) + aux through one MoE block, w.r.t. x and
    every parameter."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    y, aux = M.moe_block(cfg, p, x)
    ((y * w).sum() + aux).backward()
    return [x.grad] + [p[k].grad for k in sorted(p)]


def moe_correctness(torch, dev, M, T):
    """(m2) olmoe at full width, 2 layers, f32."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import materialize
    cfg = get_config("olmoe-1b-7b").replace(n_layers=2,
                                            param_dtype=torch.float32,
                                            compute_dtype=torch.float32)
    params = materialize(T.decoder_specs(cfg),
                         torch.Generator(device=dev).manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (2, 2048 + 16),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    reset_counts()
    S = 2048
    lg, _ = T.prefill(cfg, params, toks[:, :S])
    full = T.forward_logits(cfg, params, toks[:, :S], start=S - 1)[:, 0]
    err_p = float((lg - full).abs().max()) / float(full.abs().max())
    # decode over S + 16 tokens against the full forward: the capacity is
    # computed over a call's tokens, so the comparison runs at a capacity
    # where no pair is dropped (C >= T)
    ample = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    err_d = full_vs_decode(torch, T, ample, params, toks, S, 16)
    check(err_p <= 1e-4 and err_d <= 1e-4,
          f"(m2) olmoe prefill vs full {err_p:.3e}, prefill + 16 decodes vs "
          f"full {err_d:.3e}")
    log(f"(m2) olmoe-1b-7b full width, 2 layers, f32: prefill of 2 x {S} vs "
        f"the full forward at capacity_factor {cfg.capacity_factor} "
        f"{err_p:.2e}; prefill then 16 decodes vs the full forward over "
        f"{S + 16} at capacity_factor {ample.capacity_factor} (no drop) "
        f"{err_d:.2e} of the largest logit (bound 1e-4)")
    # one block: dispatch vs the dense oracle, and bitwise run to run
    lp = T._units(cfg, params["units"])[0]["global"]["mlp"]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev)
    y, aux = M.moe_block(ample, lp, x)
    yd, auxd = M.moe_block(ample.replace(moe_impl="dense"), lp, x)
    err_o = float((y - yd).abs().max()) / float(yd.abs().max())
    check(err_o <= F32_REL and float(abs(aux - auxd)) <= F32_REL * float(auxd),
          f"(m2) dispatch vs dense oracle {err_o:.3e}")
    g1 = block_grads(torch, M, cfg, lp, x, w)
    g2 = block_grads(torch, M, cfg, lp, x, w)
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    check(same, "(m2) two dispatch forward+backward runs differ")
    log(f"(m2) one MoE block, 2 x 512 tokens: dispatch vs the dense oracle at "
        f"ample capacity {err_o:.2e} of the largest output (bound 1e-5); two "
        f"dispatch forward+backward runs at capacity_factor "
        f"{cfg.capacity_factor} bitwise on x and all {len(g1) - 1} parameter "
        f"gradients")
    check_counts(read_counts(), {}, "(m2) the 2-layer olmoe")
    batch = {"tokens": toks[:1, :CPU_S], "labels": toks[:1, 1:CPU_S + 1]}
    grads = grads_card_vs_cpu(torch, T.loss_fn, cfg, params, batch,
                              "(m2) olmoe-1b-7b full width, 2 layers, f32, "
                              f"B 1 S {CPU_S}, card vs CPU")
    del params
    torch.cuda.empty_cache()
    return {"prefill_vs_full": err_p, "decode_vs_full": err_d,
            "dispatch_vs_dense": err_o, "bitwise": same, "grads": grads}


def rglru_correctness(torch, dev, R):
    """(m4) recurrentgemma at full width, 5 layers (one unit and 2 rem
    layers), f32."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import materialize
    cfg = get_config("recurrentgemma-9b").replace(
        n_layers=5, param_dtype=torch.float32, compute_dtype=torch.float32)
    params = materialize(R.rglru_model_specs(cfg),
                         torch.Generator(device=dev).manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (2, 4096 + 16),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    reset_counts()
    errs = {}
    for S, B in ((2048, 2), (4096, 1)):
        errs[S] = full_vs_decode(torch, R, cfg, params, toks[:B], S, 16)
        check(errs[S] <= 1e-4, f"(m4) prefill {S} + 16 decode steps vs the "
                               f"full forward: {errs[S]:.3e}")
        log(f"(m4) recurrentgemma full width, 5 layers, f32: prefill of {B} x "
            f"{S} (max_seq {S + 16}) then 16 decode steps vs the full forward "
            f"over {S + 16}: {errs[S]:.2e} of the largest logit (bound 1e-4; "
            f"window {cfg.local_window}"
            f"{', the ring wraps' if S + 16 > cfg.local_window else ''})")
    gen = torch.Generator(device=dev).manual_seed(9)
    la = -3.0 * torch.rand((2, 2048, cfg.lru_width), generator=gen, device=dev)
    xi = torch.randn((2, 2048, cfg.lru_width), generator=gen, device=dev)
    h0 = torch.randn((2, cfg.lru_width), generator=gen, device=dev)
    h, loop = h0, []
    for t in range(la.shape[1]):
        h = torch.exp(la[:, t]) * h + xi[:, t]
        loop.append(h)
    loop = torch.stack(loop, 1)
    err_s = float((R.rglru_scan(la, xi, h0) - loop).abs().max()) / float(
        loop.abs().max())
    check(err_s <= F32_REL, f"(m4) scan vs loop {err_s:.3e}")
    log(f"(m4) rglru_scan [2, 2048, {cfg.lru_width}] with h0 vs a sequential "
        f"loop on the card: {err_s:.2e} of the largest state (bound 1e-5)")
    check_counts(read_counts(), {}, "(m4) the 5-layer rglru model")
    # against the CPU: the model's one unit (its weights, the rem layers
    # left out: they are the unit's rec layer again, and the CPU's passes
    # over the whole model were most of the phase's time)
    unit = {**params, "rem": []}
    batch = {"tokens": toks[:1, :CPU_S], "labels": toks[:1, 1:CPU_S + 1]}
    grads = grads_card_vs_cpu(torch, R.loss_fn, cfg.replace(n_layers=3),
                              unit, batch, "(m4) recurrentgemma full width, "
                              f"one unit (3 layers), f32, B 1 S {CPU_S}, "
                              "card vs CPU")
    del params
    torch.cuda.empty_cache()
    return {"decode_vs_full": errs, "scan_vs_loop": err_s, "grads": grads}


# the launcher's steps in (p3) and (w3) (20, the launcher's default,
# through PR 29: the script's time)
CUT_STEPS = 10


def cut_training(torch, TRAIN, STEPS, arch, layers, ck, label,
                 enc_layers=None):
    """`launch.train --arch arch --steps CUT_STEPS --batch 4 --seq 64` with the
    depth cut to `layers` (and an encoder's to `enc_layers`): the
    launcher's own run (`build_model_lm`), its config's depth replaced
    before the step is built, through `model_lm_trainers` and
    `run_with_restart`, K1-K4 counted."""
    from repro_torch.runtime.trainer import run_with_restart
    args = TRAIN.parse_args(["--arch", arch, "--steps", str(CUT_STEPS),
                             "--batch", "4", "--seq", "64", "--ckpt-every",
                             "0", "--ckpt-dir", str(ck)])
    run = TRAIN.build_model_lm(args)
    full = run["cfg"].n_layers
    cut = {"n_layers": layers}
    if enc_layers is not None:
        cut["enc_layers"] = enc_layers
    run["cfg"] = run["cfg"].replace(**cut)
    run["step_fn"] = STEPS.make_train_step(run["cfg"], run["opt"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = run_with_restart(TRAIN.model_lm_trainers(args, run))
    check_counts(read_counts(), {}, f"{label} launch.train --arch {arch}")
    peak = torch.cuda.max_memory_allocated()
    steps = out["steps"]
    check(len(steps) == CUT_STEPS and out["final_step"] == CUT_STEPS
          and all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                  for s in steps), f"{label} {arch}: {len(steps)} steps")
    med = statistics.median(s["ms"] for s in steps[1:])
    log(f"{label} launch.train --arch {arch} --steps {CUT_STEPS} --batch 4 "
        f"--seq 64, full width, depth {layers} of {full} layers"
        f"{'' if enc_layers is None else f' (encoder {enc_layers})'}, bf16, "
        f"{run['cfg'].optimizer}: losses {steps[0]['loss']:.4f} -> "
        f"{steps[-1]['loss']:.4f}, all {CUT_STEPS} finite; median step "
        f"{med:.1f} ms (steps 2-{CUT_STEPS}, first {steps[0]['ms']:.1f} ms), "
        f"peak allocated {peak / 1e9:.2f} GB; K1-K4 launches 0")
    return {"layers": layers, "median_step_ms": med, "peak_bytes": peak}


def moe_rglru_training(torch, TRAIN, root):
    """(m5) `launch.train`'s crash and resume.  The full-width train step at
    cut depth is phase 20's one-rank reference (olmoe 2 layers,
    recurrentgemma 5, f32), with its ms and peak."""
    for arch in ("olmoe-1b-7b", "recurrentgemma-9b"):
        argv = ["--arch", arch, "--smoke", "--ckpt-every", "5"]
        reset_counts()
        a = TRAIN.main([*argv, "--fail-at", "7", "--ckpt-dir",
                        str(Path(root) / f"{arch}_a")])
        b = TRAIN.main([*argv, "--ckpt-dir", str(Path(root) / f"{arch}_b")])
        check_counts(read_counts(), {}, f"(m5) crash and resume {arch}")
        check((a["restarts"], b["restarts"]) == (1, 0)
              and a["final_step"] == b["final_step"] == 20,
              f"(m5) crash and resume {arch}: restarts {a['restarts']} / "
              f"{b['restarts']}, steps {a['final_step']} / {b['final_step']}")
        fa = final_files(Path(root) / f"{arch}_a", 20)
        fb = final_files(Path(root) / f"{arch}_b", 20)
        check(fa.keys() == fb.keys() and fa and all(fa[k] == fb[k] for k in fa),
              f"(m5) crash and resume {arch}: the final checkpoints differ")
        log(f"(m5) crash and resume {arch} --smoke --ckpt-every 5 --fail-at 7:"
            f" restarts 1 / 0, the final checkpoints' {len(fa)} leaves bitwise")


def moe_rglru_phase(torch, dev):
    """Phase 14: the MoE decoders and the Griffin RG-LRU LM (module
    docstring)."""
    import shutil
    import tempfile
    from repro_torch.launch import serve as SERVE
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import attention as A, moe as M, rglru as R
    from repro_torch.models import transformer as T
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    moe = moe_serving(torch, dev, A, M, SERVE, T)
    lap("m1")
    rglru = rglru_serving(torch, dev, A, R, SERVE)
    lap("m3")
    correct = {"moe": moe_correctness(torch, dev, M, T)}
    lap("m2")
    correct["rglru"] = rglru_correctness(torch, dev, R)
    lap("m4")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    try:
        moe_rglru_training(torch, TRAIN, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lap("m5")
    log("phase 14 seconds by part: " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in parts.items()))
    for label, c in (("olmoe-1b-7b", moe), ("recurrentgemma-9b", rglru)):
        shares = []
        for k in ("trace_prefill", "trace_decode"):
            tr = c[k]
            if tr is None:
                continue
            if "dispatch" in tr:
                shares.append(f"{k[6:]}: MoE routing (dispatch less the "
                              f"experts' products) {tr['dispatch'] - tr['experts']:.3f}, "
                              f"the experts' products {tr['experts']:.3f}")
            if "scan" in tr:
                shares.append(f"{k[6:]}: the RG-LRU scan {tr['scan']:.3f}")
        log(f"(c) {label}: prefill {c['prefill_tok_s']:.0f} tokens/s "
            f"({c['prefill_flop_share']:.3f} of the bf16 peak), decode "
            f"{c['decode_ms']:.2f} ms a step, the Engine "
            f"{c['engine_tok_s']} tok/s (the train step's ms and peak: "
            f"phase 20's one-rank reference); shares of kernel time: "
            f"{'; '.join(shares) or 'not measured'}")
    log("phase 14 json: " + json.dumps({"moe": moe, "rglru": rglru,
                                         "correctness": correct}))


# ---------------------------------------------------------------------------
# phase 15: the scaled sparse-RTRL engine at the reference's n = 1024
# ---------------------------------------------------------------------------

def scaled_setup(torch, SR, dev, n=1024, L=1, capacity=1.0, T=8, seed=0):
    """The reference's `ScaledRTRLConfig` defaults (n_in 128, n_out 8,
    batch 8, kind rnn, sparsity 0.9 in 8 x 8 blocks, eps 0.3) at width n,
    depth L and capacity: parameters and masks drawn from a seeded
    generator, T steps of N(0, 1) inputs drawn on the card, labels
    b % n_out."""
    cfg = SR.ScaledRTRLConfig(n=n, n_layers=L, beta_capacity=capacity)
    params, masks = SR.init_params(cfg, torch.Generator().manual_seed(seed),
                                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    xs = torch.randn((T, cfg.batch, cfg.n_in), generator=gen, device=dev)
    labels = torch.arange(cfg.batch, device=dev) % cfg.n_out
    return cfg, params, masks, xs, labels


def scaled_sizes(cfg, cl):
    """One line of the carry's sizes: K, m, the full and compact widths,
    and the f32 bytes of one layer's [B, K, Pc_pad] buffer."""
    P_pad = (cfg.slayout().P_pad if cfg.n_layers > 1
             else cfg.layout().P_pad)
    one = cfg.batch * cfg.K * cl.Pc_pad * 4
    return (f"n {cfg.n}, L {cfg.n_layers}, K {cfg.K}, m {cfg.m}, P_pad "
            f"{P_pad:,}, Pc {cl.Pc:,} (Pc_pad {cl.Pc_pad:,}), f32 carry "
            f"{one / 1e9:.3f} GB a layer"), one


def masked_grads(SP, ST, cfg, grads, masks):
    if cfg.n_layers > 1:
        return ST.apply_stacked_masks(grads, masks)
    return SP.apply_masks(grads, masks)


def leaf_gap(a, b):
    """The worst leaf of a against b, each relative to b's leaf's largest
    entry: (error, leaf name)."""
    from repro_torch.tree import leaf_name, tree_flatten_with_path
    return max((float((x.cpu() - y.cpu()).abs().max())
                / max(float(y.abs().max()), 1e-30), leaf_name(p))
               for (p, x), (_, y) in zip(tree_flatten_with_path(a),
                                         tree_flatten_with_path(b)))


def scaled_exactness(torch, SR, BP, SP, ST, dev, n, L, label):
    """rtrl_grads over 8 steps at capacity 1 (nothing can overflow) with
    compact_fused and compact, K1 counted (8 a layer); each backend's
    gradients on the surviving parameters against the card's BPTT within
    1e-5 of each leaf's largest entry, or twice the CPU's own BPTT spread
    between one thread and its default (phase 13's rule), and against each
    other."""
    cfg, params, masks, xs, labels = scaled_setup(torch, SR, dev, n=n, L=L)
    sizes, _ = scaled_sizes(cfg, cfg.col_layout(masks, device=dev))
    log(f"{label}: {sizes}")
    T = xs.shape[0]
    got = {}
    for backend in ("compact_fused", "compact"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loss, grads, stats = SR.rtrl_grads(cfg, params, xs, labels, masks,
                                           backend=backend)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        want = T * L if backend == "compact_fused" else 0
        check_counts(counts, {"compact_fused": want}, f"{label} {backend}")
        ov = stats["overflow"]
        check(int(ov.max()) == 0, f"{label} {backend}: overflow {ov.tolist()}")
        got[backend] = (float(loss), masked_grads(SP, ST, cfg, grads, masks))
        log(f"{label} {backend}: rtrl_grads over {T} steps in {sec:.2f} s "
            f"(the first call), K1 launches {counts['compact_fused']}, "
            f"overflow 0 on every step, peak allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del grads, stats
    bptt = BP.bptt_loss_and_grads if L == 1 else BP.stacked_bptt_loss_and_grads
    bcfg = cfg.cell_cfg() if L == 1 else cfg.stacked_cfg()
    lb, gb, _ = bptt(bcfg, params, xs, labels)
    gb = masked_grads(SP, ST, cfg, gb, masks)
    from repro_torch.tree import tree_map
    cpu = tree_map(lambda t: t.detach().cpu(), params)
    cmasks = tree_map(lambda t: None if t is None else t.cpu(), masks)
    _, gc, _ = bptt(bcfg, cpu, xs.cpu(), labels.cpu())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, g1, _ = bptt(bcfg, cpu, xs.cpu(), labels.cpu())
    finally:
        torch.set_num_threads(threads)
    spread, _ = leaf_gap(masked_grads(SP, ST, cfg, g1, cmasks),
                         masked_grads(SP, ST, cfg, gc, cmasks))
    bound = max(F32_REL, 2 * spread)
    errs = {}
    for backend, (loss, grads) in got.items():
        lerr = abs(loss - float(lb)) / abs(float(lb))
        errs[backend] = leaf_gap(grads, gb)
        check(lerr <= F32_REL and errs[backend][0] <= bound,
              f"{label} {backend} vs BPTT: loss {lerr:.3e}, gradients "
              f"{errs[backend]} (bound {bound:.3e})")
        log(f"{label} {backend} vs the card's BPTT on the surviving "
            f"parameters: loss {lerr:.2e}, gradients {errs[backend][0]:.2e} "
            f"({errs[backend][1]}) of the leaf's largest entry (bound "
            f"{bound:.2e}: the larger of 1e-5 and twice the CPU's BPTT "
            f"spread, 1 thread against {threads}, {spread:.2e})")
    fvc = leaf_gap(got["compact_fused"][1], got["compact"][1])
    check(fvc[0] <= bound, f"{label} fused vs compact {fvc}")
    log(f"{label} compact_fused vs compact: gradients {fvc[0]:.2e} ({fvc[1]})")
    return {"vs_bptt": {k: v[0] for k, v in errs.items()},
            "fused_vs_compact": fvc[0], "cpu_spread": spread,
            "launches": T * L}


def scaled_k1(torch, SR, SP, CF, CK, dev):
    """(s2) the default capacity 0.5 (K 512): the overflow and K_b of each
    of 8 steps of N(0, 1) inputs, as they are; K1 against its plain
    version on the operands of step 5, f32 and bf16; its time against
    baddbmm on pre-gathered tiles (in turn too), device µs, the bound and
    its launch shape."""
    cfg, params, masks, xs, _ = scaled_setup(torch, SR, dev, capacity=0.5)
    cl = cfg.col_layout(masks, device=dev)
    w = {k: v for k, v in params.items() if k != "out"}
    state = SR.init_state(cfg, cl, device=dev)
    trace, ops = [], None
    for t in range(xs.shape[0]):
        if t == 4:
            ops = list(SP.fused_step_operands(
                cfg.cell_cfg(), w, cfg.layout(), state["a"], state["vals"],
                state["idx"], xs[t], cl=cl)[2])
        state, ov = SR.compact_step(cfg, w, state, xs[t], cl=cl,
                                    backend="compact_fused")
        kb = (state["idx"] >= 0).sum(dim=1)
        trace.append({"overflow": ov.tolist(), "k_b": kb.tolist(),
                      "active": (kb + ov).tolist()})
    for t, s in enumerate(trace):
        log(f"(s2) step {t}: active rows an example {s['active']} (beta~ "
            f"{sum(s['active']) / (cfg.batch * cfg.n):.3f}), K_b {s['k_b']}, "
            f"overflow {s['overflow']} (K {cfg.K})")
    del state
    err = compare_k1(torch, CF, ops, "(s2) n=1024 step 5 f32")
    compare_k1(torch, CF, with_carry_dtype(torch, ops, torch.bfloat16),
               "(s2) n=1024 step 5 bf16")
    t = time_k1(torch, CF, CK, ops, 5, 3)
    shape = k1_launch_shape(CF, ops)
    log(f"K1 time (s2) n=1024: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, baddbmm on pre-gathered tiles "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {t['bytes']:.0f} B, {t['flops']:.0f} FLOP; "
        f"{t['flops'] / (t['ms'] * 1e9):.1f} TFLOP/s achieved)")
    log(f"K1 in turn (s2) n=1024: kernel {t['alt_ms']:.4f} ms, baddbmm "
        f"{t['alt_library_ms']:.4f} ms (median of 5 rounds); device: kernel "
        f"{t['device_us']} us, baddbmm {t['library_device_us']} us")
    log(f"K1 launch shape (s2) n=1024: {shape}")
    return {**t, "max_abs_err": err, "launch_shape": shape,
            "count_new": ops[6].tolist(), "count_prev": ops[7].tolist(),
            "steps": trace}


def scaled_trainer(torch, SR, ON, O, dev, backend, L=1, windows=4, k=8):
    """An OnlineTrainer of the scaled learner at the default capacity 0.5:
    masked adamw (lr 1e-3), an update every k steps, `windows` windows of
    the seeded N(0, 1) stream."""
    from repro_torch.core.learner import LearnerSpec, make_learner
    import numpy as np
    cfg, params, masks, _, _ = scaled_setup(torch, SR, dev, L=L,
                                            capacity=0.5)
    learner = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                       backend=backend))
    mask_tree = {"layers": masks, "out": None} if L > 1 else masks
    opt = O.masked(O.adamw(lr=1e-3), mask_tree)
    ys = (np.arange(cfg.batch) % cfg.n_out).astype(np.int32)

    def stream(t):
        rng = np.random.default_rng(1000 + t)
        return (rng.standard_normal((cfg.batch, cfg.n_in)).astype(np.float32),
                ys)

    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=windows * k, update_every=k,
                               ckpt_every=0, log_every=1),
        learner, opt, params, masks, stream, device=dev)
    return cfg, tr


def scaled_windows(torch, SR, ON, O, CO, dev, backend, label, L=1,
                   windows=4):
    """(s3)/(s4) the online windows: median window ms (the trainer's own
    clock, one readback a window), K1 launches, peak allocation, the
    carry's bytes (allocated, and live: the compact columns Pc of
    Pc_pad), and a trace of one more window (device ops a stream step,
    idle share)."""
    cfg, tr = scaled_trainer(torch, SR, ON, O, dev, backend, L, windows)
    k = tr.cfg.update_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = tr.run()
    counts = read_counts()
    steps = windows * k
    want = steps * L if backend == "compact_fused" else 0
    check_counts(counts, {"compact_fused": want},
                 f"{label} {backend} L {L} windows")
    peak = torch.cuda.max_memory_allocated()
    ms = [w["ms"] for w in tr.windows]
    losses = [w["loss"] for w in tr.windows]
    check(out["updates"] == windows and all(math.isfinite(v) for v in losses),
          f"{label} {backend} L {L}: {out['updates']} updates, {losses}")
    alloc = ON.carry_nbytes(tr.carry)
    cl = tr.learner._cl
    vals = tr.carry["state"]["vals"]
    vals = vals if isinstance(vals, tuple) else (vals,)
    dead = sum(CO.carry_footprint(v.shape[0], v.shape[1], cl.Pc_pad, cl.Pc,
                                  v.element_size())["alloc_bytes"]
               - CO.carry_footprint(v.shape[0], v.shape[1], cl.Pc_pad, cl.Pc,
                                    v.element_size())["live_bytes"]
               for v in vals)
    rows = tr.row_stats()
    xs = torch.randn((k, cfg.batch, cfg.n_in), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    ys = torch.zeros((k, cfg.batch), dtype=torch.long, device=dev)
    upd = tr.update + 1
    tr_out = profile_ranges(
        torch, lambda: ON.online_update_chunk(tr.learner, tr.opt, tr.carry,
                                              tr.opt_state, xs, ys, upd),
        f"{label} scaled {backend} L {L} window of {k} steps", {})
    med = statistics.median(ms)
    log(f"{label} scaled {backend} L {L} n {cfg.n} K {cfg.K}: {windows} "
        f"windows of {k} steps, K1 launches {counts['compact_fused']}, "
        f"median window {med:.2f} ms (windows "
        f"{', '.join(f'{x:.2f}' for x in ms)}), losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, overflow "
        f"{[w.get('overflow') for w in tr.windows]}, peak allocated "
        f"{peak / 1e9:.2f} GB, carry {alloc / 1e9:.3f} GB allocated, "
        f"{(alloc - dead) / 1e9:.3f} GB live, K_b {rows}")
    res = {"median_window_ms": med, "windows_ms": ms, "peak_bytes": peak,
           "carry_bytes": alloc, "carry_live_bytes": alloc - dead,
           "launches": counts["compact_fused"], "row_stats": rows}
    if tr_out is not None:
        res["ops_per_step"] = tr_out["ops"] / k
        res["idle"] = tr_out["idle"]
        log(f"{label} scaled {backend} L {L}: {res['ops_per_step']:.1f} "
            f"device ops a stream step, idle share {tr_out['idle']:.3f}")
    del tr
    torch.cuda.empty_cache()
    return res


def scaled_rewire(torch, SR, dev):
    """(s5) one RigL event on a rewirable compact scaled learner at n 256
    (capacity 1): the rewired carry continues bit for bit as a fresh
    engine built on the new masks with the migrated state; the event's ms
    (host clock, synchronised; median of 3 events from the same carry)."""
    from repro_torch.core.learner import LearnerSpec, make_learner
    cfg, params, masks, xs, labels = scaled_setup(torch, SR, dev, n=256)
    spec = LearnerSpec(engine="scaled", cfg=cfg, backend="compact",
                       col_compact=True, rewirable=True)
    learner = make_learner(spec)
    carry = learner.init(params, masks, (xs[0], labels), t_total=8.0)
    for t in range(4):
        carry, _ = learner.step(carry, xs[t], labels)
    carry = learner.reset_grads(carry)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mid = learner.rewire(carry, (0, 1), frac=0.3, method="rigl",
                             block=cfg.mask_block)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    from repro_torch.tree import tree_leaves
    moved = sum(int((a != b).sum()) for a, b in
                zip(tree_leaves(mid["rw"]["masks"]), tree_leaves(masks)))
    fresh = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                     backend="compact", col_compact=True))
    fc = fresh.init(mid["params"], mid["rw"]["masks"], (xs[0], labels),
                    t_total=8.0)
    fc["state"] = mid["state"]
    c2 = mid
    for t in range(4, 8):
        c2, _ = learner.step(c2, xs[t], labels)
        fc, _ = fresh.step(fc, xs[t], labels)
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(learner.grads(c2)) + tree_leaves(c2["state"]),
                   tree_leaves(fresh.grads(fc)) + tree_leaves(fc["state"])))
    check(same and moved > 0, f"(s5) rewired carry vs fresh engine: bitwise "
                              f"{same}, {moved} mask entries moved")
    med = statistics.median(ms)
    log(f"(s5) one RigL event (frac 0.3, 8 x 8 blocks) on the rewirable "
        f"compact scaled learner at n 256: {moved} mask entries moved, the "
        f"next 4 steps bitwise a fresh engine on the new masks with the "
        f"migrated state; the event {med:.2f} ms (events "
        f"{', '.join(f'{x:.2f}' for x in ms)})")
    return {"event_ms": med, "bitwise": same}


def scaled_phase(torch, dev, BP, SP, ST, CF, CK, ON, CO):
    """Phase 15: the scaled sparse-RTRL engine (module docstring).
    Returns K1's "scaled" entry of the kernels line."""
    from repro_torch.core import scaled_rtrl as SR
    from repro_torch.optim import optimizers as O
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    s1 = scaled_exactness(torch, SR, BP, SP, ST, dev, 1024, 1,
                          "(s1) n=1024 capacity 1")
    torch.cuda.empty_cache()
    lap("s1")
    s2 = scaled_k1(torch, SR, SP, CF, CK, dev)
    torch.cuda.empty_cache()
    lap("s2")
    s3 = {b: scaled_windows(torch, SR, ON, O, CO, dev, b, "(s3)")
          for b in ("compact_fused", "compact")}
    lap("s3")
    s4 = {"exact": scaled_exactness(torch, SR, BP, SP, ST, dev, 512, 2,
                                    "(s4) n=512 L=2 capacity 1")}
    torch.cuda.empty_cache()
    # reckon the peak before the card runs it: the masks as the trainer
    # draws them, their compact axis, and 7 buffers of [B, K, Pc_pad] f32 at
    # layer 1's update (the 2 carried, layer 0's new one, layer 1's M-bar
    # rows, its cross term and their sum, K1's output)
    cfg2 = SR.ScaledRTRLConfig(n_layers=2, beta_capacity=0.5)
    _, masks2 = SR.init_params(cfg2, torch.Generator().manual_seed(0),
                               device="cpu")
    sizes, one = scaled_sizes(cfg2, cfg2.col_layout(masks2, device="cpu"))
    log(f"(s4) n=1024 L=2 capacity 0.5: {sizes}; reckoned peak of a step "
        f"~ 7 such buffers = {7 * one / 1e9:.1f} GB")
    s4["window"] = scaled_windows(torch, SR, ON, O, CO, dev, "compact_fused",
                                  "(s4)", L=2, windows=2)
    lap("s4")
    s5 = scaled_rewire(torch, SR, dev)
    lap("s5")
    log("phase 15 seconds by part: " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in parts.items()))
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "alt_ms",
            "alt_library_ms", "device_us", "library_device_us",
            "max_abs_err", "launch_shape")
    entry = {k: s2[k] for k in keys}
    entry["launches"] = {"s1": s1["launches"],
                         "s3": s3["compact_fused"]["launches"],
                         "s4_per_step": s4["window"]["launches"] // 16}
    log("phase 15 json: " + json.dumps({
        "s1": s1, "s2": {k: v for k, v in s2.items() if k != "steps"},
        "s2_steps": s2["steps"], "s3": s3, "s4": s4, "s5": s5}))
    return entry


# ---------------------------------------------------------------------------
# phase 16: whisper-large-v3, the encoder-decoder
# ---------------------------------------------------------------------------

class _WithFrames:
    """`encdec`'s serving functions with the audio frames bound, in the
    (prefill, decode_step) form of the other families (`prefill_decode`,
    `serving_costs`)."""

    def __init__(self, E, frames):
        self.E, self.frames = E, frames
        self.decode_step = E.decode_step

    def prefill(self, cfg, params, tokens, max_seq=None):
        return self.E.prefill(cfg, params, tokens, self.frames,
                              max_seq=max_seq)


def encdec_flops(cfg, params, E, B, S):
    """The prefill's FLOPs from the shapes: the encoder's weight matrices
    for each of the B x enc_seq frames and its full attention; the
    decoder's for each of the B x S tokens but the cross K/V projections,
    which run over the frames; causal self-attention, cross-attention over
    the frames, and the last position's logits."""
    from repro_torch.tree import tree_leaves
    Se = cfg.enc_seq
    enc = sum(matmul_flops(cfg, tree_leaves(lp))
              for lp in E._layers(cfg, params["enc"], cfg.enc_layers))
    dec = kv = 0
    for lp in E._layers(cfg, params["dec"], cfg.n_layers):
        dec += matmul_flops(cfg, tree_leaves(lp))
        kv += matmul_flops(cfg, [lp["cross_attn"]["wk"], lp["cross_attn"]["wv"]])
    att = 4 * B * cfg.n_heads * cfg.head_dim
    return (enc * B * Se + att * Se * Se * cfg.enc_layers
            + (dec - kv) * B * S + kv * B * Se
            + attention_flops(cfg, B, S, [0] * cfg.n_layers)
            + att * S * Se * cfg.n_layers
            + 2 * B * cfg.d_model * cfg.vocab_size)


def whisper_serving(torch, dev, A, E):
    """(w1) whisper-large-v3 at full size, bf16: encode 4 x 1500 frames,
    prefill 4 x 448 tokens with max_seq 464 and 16 greedy decodes, every
    logit finite; (c) its serving costs and traces."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-large-v3")
    params = draw(torch, dev, E.encdec_specs(cfg), 0, "(w1) whisper-large-v3",
                  1_600_990_720)
    B, S, n_dec = 4, 448, 16
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = 0.02 * torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                                device=dev)
    mod = _WithFrames(E, frames)
    tokens, cache, tok, step_ms = prefill_decode(
        torch, dev, mod, cfg, params, B, S, n_dec, "(w1) whisper-large-v3")
    ranges = {**attention(A), "encoder": [(E, "encode")]}
    costs = serving_costs(torch, dev, mod, cfg, params, tokens, cache, tok,
                          step_ms, encdec_flops(cfg, params, E, B, S), ranges,
                          "whisper-large-v3")
    del params, cache
    torch.cuda.empty_cache()
    return costs


def whisper_correctness(torch, dev, E):
    """(w2) whisper at full width, 2 encoder and 2 decoder layers, f32:
    prefill against the full forward; prefill then 16 decodes against the
    full forward over S + 16 (1e-4 of the largest logit); loss and
    gradients card against CPU (phase 13's rule)."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import materialize
    cfg = get_config("whisper-large-v3").replace(
        n_layers=2, enc_layers=2, param_dtype=torch.float32,
        compute_dtype=torch.float32)
    params = materialize(E.encdec_specs(cfg),
                         torch.Generator(device=dev).manual_seed(3))
    B, S, n = 2, 448, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S + n + 1),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    frames = 0.02 * torch.randn((B, cfg.enc_seq, cfg.d_model),
                                generator=torch.Generator(device=dev)
                                .manual_seed(5), device=dev)
    reset_counts()
    full = E.forward_logits(cfg, params, toks[:, :S + n], frames, start=S - 1)
    scale = float(full.abs().max())
    lg, _ = E.prefill(cfg, params, toks[:, :S], frames)
    err_p = float((lg - full[:, 0]).abs().max()) / scale
    lg, cache = E.prefill(cfg, params, toks[:, :S], frames, max_seq=S + n)
    errs = [float((lg - full[:, 0]).abs().max())]
    for i in range(n):
        lg, cache = E.decode_step(cfg, params, toks[:, S + i:S + i + 1], cache,
                                  torch.full((B,), S + i, device=dev))
        errs.append(float((lg - full[:, i + 1]).abs().max()))
    err_d = max(errs) / scale
    check(err_p <= 1e-4 and err_d <= 1e-4,
          f"(w2) whisper prefill vs full {err_p:.3e}, prefill + {n} decodes "
          f"vs full {err_d:.3e}")
    log(f"(w2) whisper full width, 2 + 2 layers, f32, {cfg.enc_seq} frames: "
        f"prefill of {B} x {S} vs the full forward {err_p:.2e}; prefill "
        f"(max_seq {S + n}) then {n} decodes vs the full forward over "
        f"{S + n} {err_d:.2e} of the largest logit (bound 1e-4)")
    check_counts(read_counts(), {}, "(w2) the 2 + 2 layer whisper")
    batch = {"tokens": toks[:1, :64], "labels": toks[:1, 1:65],
             "frames": frames[:1]}
    grads = grads_card_vs_cpu(torch, E.loss_fn, cfg, params, batch,
                              "(w2) whisper full width, 2 + 2 layers, f32, "
                              "B 1 S 64, card vs CPU")
    del params
    torch.cuda.empty_cache()
    return {"prefill_vs_full": err_p, "decode_vs_full": err_d,
            "grads": grads}


def whisper_training(torch, TRAIN, STEPS, root):
    """(w3) `launch.train --arch whisper-large-v3` as the launcher builds
    it, full width, encoder and decoder cut to 4 of 32 layers, CUT_STEPS
    steps of 4 x 64 tokens with 1500 frames; crash and resume at --smoke, the final
    checkpoints bitwise."""
    import shutil
    arch = "whisper-large-v3"
    ck = Path(root) / arch
    cost = cut_training(torch, TRAIN, STEPS, arch, 4, ck, "(w3)", 4)
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    argv = ["--arch", arch, "--smoke", "--ckpt-every", "5"]
    reset_counts()
    a = TRAIN.main([*argv, "--fail-at", "7", "--ckpt-dir",
                    str(Path(root) / "a")])
    b = TRAIN.main([*argv, "--ckpt-dir", str(Path(root) / "b")])
    check_counts(read_counts(), {}, f"(w3) crash and resume {arch}")
    check((a["restarts"], b["restarts"]) == (1, 0)
          and a["final_step"] == b["final_step"] == 20,
          f"(w3) crash and resume: restarts {a['restarts']} / "
          f"{b['restarts']}, steps {a['final_step']} / {b['final_step']}")
    fa, fb = final_files(Path(root) / "a", 20), final_files(Path(root) / "b", 20)
    check(fa.keys() == fb.keys() and fa and all(fa[k] == fb[k] for k in fa),
          "(w3) crash and resume: the final checkpoints differ")
    log(f"(w3) crash and resume {arch} --smoke --ckpt-every 5 --fail-at 7: "
        f"restarts 1 / 0, the final checkpoints' {len(fa)} leaves bitwise")
    return cost


def whisper_phase(torch, dev):
    """Phase 16: whisper-large-v3 (module docstring)."""
    import shutil
    import tempfile
    from repro_torch.launch import steps as STEPS, train as TRAIN
    from repro_torch.models import attention as A, encdec as E
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    serving = whisper_serving(torch, dev, A, E)
    lap("w1")
    correct = whisper_correctness(torch, dev, E)
    lap("w2")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_whisper_"))
    try:
        training = whisper_training(torch, TRAIN, STEPS, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lap("w3")
    log("phase 16 seconds by part: " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in parts.items()))
    shares = []
    for k in ("trace_prefill", "trace_decode"):
        tr = serving[k]
        if tr is not None:
            shares.append(f"{k[6:]}: attention {tr['attention']:.3f}, GEMMs "
                          f"{tr['gemm']:.3f}, encoder {tr['encoder']:.3f}")
    log(f"(c) whisper-large-v3: prefill {serving['prefill_tok_s']:.0f} "
        f"tokens/s ({serving['prefill_flop_share']:.3f} of the bf16 peak), "
        f"decode {serving['decode_ms']:.2f} ms a step, train "
        f"{training['median_step_ms']:.1f} ms a step, peak "
        f"{training['peak_bytes'] / 1e9:.2f} GB; shares of kernel time: "
        f"{'; '.join(shares) or 'not measured'}")
    log("phase 16 json: " + json.dumps({"serving": serving,
                                         "correctness": correct,
                                         "training": training}))


# ---------------------------------------------------------------------------
# phase 17: the shape suite's long-context cells at full size
# ---------------------------------------------------------------------------

LONG_S = 524_288                 # long_500k's S
CARD_BYTES = 80e9                # the card's memory, as the dry-run decides
# where the phase picks a cut length: the card less room for the caching
# allocator's fragmentation (an f32 recurrentgemma prefill reckoned at
# 79.9 GB ran out with 6.63 GiB reserved but unallocated)
FIT_BYTES = 72e9
# (L4)'s prompt at most: the script's time (a prefill of 270,336 tokens,
# the longest that fits, took 33 s of the script's 1,200)
L4_PROMPT = 65_536
L1_TRACE = 65_536          # (L1)'s traced prefill, the prompt's first tokens
L4_TRACE = 8_192           # (L4)'s
# (D)'s prompt: the caches' fill (2,048 through PR 29: the script's time; a
# decode step's work is the same, a state and a 2,048-slot ring)
D_PROMPT = 1_024
LONG_CELLS = (("rwkv6-3b", "long_500k"), ("recurrentgemma-9b", "long_500k"),
              ("rwkv6-3b", "decode_32k"), ("recurrentgemma-9b", "decode_32k"))


def prefill_jobs(torch):
    """The prefills phase 17 runs, to reckon on meta: {key: (arch,
    overrides, batch, T, max_seq, FLOP points, peak points, peak layers)}
    (`dryrun_lib.reckon_prefill`: the FLOPs at full depth from two short
    lengths, the peak from two long ones at a cut depth plus the cut
    layers' exact bytes; two RWKV6 layers, one RG-LRU unit: counted at one
    layer, the RWKV6 peak misses the residual stream beside the layer's
    transients)."""
    f32 = {"param_dtype": torch.float32, "compute_dtype": torch.float32}
    rw, rg = "rwkv6-3b", "recurrentgemma-9b"
    return {
        "L1": (rw, {}, 1, LONG_S - 32, LONG_S, (32, 64), (8192, 16384), 2),
        "L3 rwkv6-3b": (rw, {"n_layers": 2, **f32}, 1, LONG_S, LONG_S,
                        (32, 64), (8192, 16384), 0),
        "L3 recurrentgemma-9b": (rg, {"n_layers": 3, **f32}, 1, LONG_S,
                                 LONG_S, (1024, 2048), (32768, 65536), 0),
        "L4": (rg, {}, 1, LONG_S - 32, LONG_S, (1024, 2048), (32768, 65536), 3),
        **{f"D {a} {b}": (a, {}, b, D_PROMPT, 32768, pts,
                          (D_PROMPT // 2, D_PROMPT), cut)
           for a, pts, cut in ((rw, (32, 64), 2), (rg, (512, 1024), 3))
           for b in (128, 64)},
    }


def reckon_main(path):
    """`chip_smoke.py --reckon PATH` (started by phase 1 as a helper
    process, on the CPU): the dry-run records of phase 17's cells
    (`run_cell` on the meta device) and the reckoned prefills, written to
    PATH as JSON."""
    import shutil
    import tempfile
    sys.path.insert(0, str(ROOT / "src"))
    os.nice(19)          # the card's phases keep the CPU they need
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun_lib as D
    out = {"cells": {}, "prefill": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        for arch, cell in LONG_CELLS:
            rec = D.run_cell(arch, cell, tmp)
            out["cells"][f"{arch} {cell}"] = {
                k: rec.get(k) for k in ("status", "error", "cost_analysis",
                                        "memory", "roofline", "total_s")}
        for key, (arch, over, B, T, max_seq, pts, ppts,
                  cut) in prefill_jobs(torch).items():
            whole = out["prefill"].get(key[:-3] + " 128")
            if key.endswith(" 64") and whole["peak_bytes"] <= FIT_BYTES:
                continue                # (D) fills in one group of 128 rows
            t0 = time.time()
            r = D.reckon_prefill(get_config(arch).replace(**over), B, T,
                                 max_seq, pts, ppts, cut)
            r["s"] = time.time() - t0
            out["prefill"][key] = r
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    Path(path).write_text(json.dumps(out, default=str))
    return 0


def reckon_sharded_main(path):
    """`chip_smoke.py --reckon-sharded PATH` (started by phase 1 as a
    second helper process, on the CPU): rank 0's dry-run count of phase
    19's (m1) prefill step on the same (data 1, model 2) mesh, over a
    one-process fake group of 2 ranks (`dryrun_lib.count_rank` on the
    rank's local meta shards), written to PATH as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    os.nice(19)
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.launch import dryrun_lib as D
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.time()
    B, T = M1_PREFILL
    with D.fake_group(2):
        mesh = make_host_mesh(1, 2, device="cpu")
        built = D.build_step(get_config("rwkv6-3b"),
                             ShapeSuite("p", T, B, "prefill"), "meta",
                             mesh=mesh)
        c = D.count_rank(built, "prefill", mesh)
    out = {k: c[k] for k in ("flops", "bytes", "peak_bytes", "collectives",
                             "collectives_raw")}
    out["argument_bytes"] = D.argument_bytes("prefill", c["args"])
    out["s"] = time.time() - t0
    Path(path).write_text(json.dumps(out))
    return 0


def start_reckoning(flag="--reckon"):
    """Phase 1 starts `reckon_main` (`flag` --reckon) and
    `reckon_sharded_main` (--reckon-sharded) in helper processes, which
    phases 17 and 19 wait for: their counts are single-threaded CPU work
    (minutes) that overlaps phases 2-16."""
    import tempfile
    fd, path = tempfile.mkstemp(prefix="chip_smoke_reckon_", suffix=".json")
    os.close(fd)
    log_path = path[:-5] + ".log"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 flag, path], stdout=logf,
                                stderr=subprocess.STDOUT, env=env)
    return {"proc": proc, "path": path, "log": log_path, "t0": time.time()}


def stop_reckoning(job):
    """Ends the helper if it still runs and removes its files."""
    if job is None:
        return
    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].wait()
    for p in (job["path"], job["log"]):
        Path(p).unlink(missing_ok=True)


def helper_result(job, label, timeout=900):
    """A reckoning helper's JSON, once it has ended (0, or the phase
    fails), and the seconds this waited for it."""
    t0 = time.perf_counter()
    try:
        rc = job["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    waited = time.perf_counter() - t0
    check(rc == 0, f"{label}: the dry-run helper ended with {rc}: "
                   + Path(job["log"]).read_text()[-2000:])
    return json.loads(Path(job["path"]).read_text()), waited


def read_reckoning(job, timeout=900):
    out, waited = helper_result(job, "phase 17", timeout)
    log(f"(dry-run) the helper's counts took {time.time() - job['t0']:.1f} s "
        f"of wall time beside phases 2-16 (phase 17 waited {waited:.1f} s); "
        + ", ".join(f"{k} {v['s']:.1f} s" for k, v in out["prefill"].items()))
    return out


def at_len(r, key, t):
    a, b = r["lines"][key]
    return a + b * t


def longest_fit(r, step, cap):
    """The longest S <= cap, a multiple of `step`, whose reckoned peak fits
    FIT_BYTES."""
    a, b = r["lines"]["peak_bytes"]
    s = min(cap, int((FIT_BYTES - a) / b))
    return s - s % step


def plain_wkv_replayed(torch, WK, ops, chunk):
    """`WK.wkv_reference`'s algebra, `wkv_chunk` chained over the T / chunk
    chunks from a zero state, with one chunk captured as a CUDA graph and
    replayed on each chunk's inputs copied into its buffers: the same
    kernels on the same values without the host time of ~100 eager ops a
    chunk (49.3 s at T 524,256 eager).  Returns (o, S_final)."""
    r, k, v, logw, u, _ = ops
    B, H, T, D = r.shape
    cut = lambda x, c: x[:, :, c:c + chunk]
    ins = [cut(x, 0).clone() for x in (r, k, v, logw)]
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            WK.wkv_chunk(*ins, u, S)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o_c, S_c = WK.wkv_chunk(*ins, u, S)
    o = torch.empty((B, H, T, D), dtype=torch.float32, device=r.device)
    for c0 in range(0, T, chunk):
        for dst, x in zip(ins, (r, k, v, logw)):
            dst.copy_(cut(x, c0))
        graph.replay()
        o[:, :, c0:c0 + chunk].copy_(o_c)
        S.copy_(S_c)
    return o, S


def log_cell(reck, name):
    rec = reck["cells"][name]
    check(rec["status"] == "ok", f"dry-run {name}: {rec.get('error')}")
    m, ca, ro = rec["memory"], rec["cost_analysis"], rec["roofline"]
    arg = m["argument_bytes"]
    log(f"(dry-run) {name}, one decode step on meta: {ca['flops']:.4g} FLOP "
        f"counted ({ro['model_flops_global']:.4g} model FLOPs), "
        f"{ca['bytes']:.4g} bytes, arguments {arg['total'] / 1e9:.3f} GB "
        f"(parameters {arg['params'] / 1e9:.3f}, cache "
        f"{arg.get('cache', 0) / 1e9:.3f}), reckoned peak "
        f"{m['peak_bytes'] / 1e9:.3f} GB, fits one card: {m['fits_one_card']}"
        f"; reckoned least time {max(ro['compute_s'], ro['memory_s']) * 1e3:.3f}"
        f" ms ({ro['dominant']})")
    return rec


def log_prefill_reckoning(r, label, B, T):
    log(f"(dry-run) {label}: prefill {B} x {T} reckoned on meta "
        f"({r['points']['peak_layers']} layers counted for the peak): "
        f"{at_len(r, 'flops', T):.4g} FLOP, arguments "
        f"{r['argument_bytes'] / 1e9:.3f} GB, peak "
        f"{at_len(r, 'peak_bytes', T) / 1e9:.3f} GB "
        f"({r['lines']['peak_bytes'][1] / 1e3:.1f} kB a token)")


def measured_peak(torch, label, reckoned):
    got = torch.cuda.max_memory_allocated()
    log(f"{label}: peak allocated {got / 1e9:.3f} GB measured "
        f"(max_memory_allocated), {reckoned / 1e9:.3f} GB reckoned on meta "
        f"(ratio {got / reckoned:.3f})")
    return got


def finite_tree(torch, tree):
    from repro_torch.tree import tree_leaves
    return all(bool(t.float().isfinite().all()) for t in tree_leaves(tree)
               if t.is_floating_point())


def greedy_decodes(torch, dec, params, tok, cache, start, n, label, B=1):
    """n greedy decode steps from position `start`; every logit finite.
    Returns (last logits, cache, ms a step)."""
    step_ms = []
    for i in range(n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dl, cache = dec(params, tok, cache,
                        torch.full((B,), start + i, dtype=torch.int32,
                                   device=tok.device))
        tok = dl.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        check(bool(dl.isfinite().all()), f"{label} decode {i}: non-finite")
    return dl, cache, step_ms


def timed(torch, fn):
    """(fn's result, its ms by CUDA events)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def long_rwkv(torch, dev, WK, STEPS, reck):
    """(L1) and (L2).  Returns (K4's "long" entry, the (L1) numbers)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import rwkv as RW
    cfg, shape = get_config("rwkv6-3b"), SHAPES["long_500k"]
    log_cell(reck, "rwkv6-3b long_500k")
    r = reck["prefill"]["L1"]
    T = LONG_S - 32
    log_prefill_reckoning(r, "(L1) rwkv6-3b", 1, T)
    check(r["peak_bytes"] <= CARD_BYTES,
          f"(L1) the reckoned peak {r['peak_bytes'] / 1e9:.2f} GB does not fit")
    params = draw(torch, dev, RW.rwkv_model_specs(cfg), 0, "(L1) rwkv6-3b",
                  3_094_451_200)
    tokens = torch.randint(0, cfg.vocab_size, (1, T), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    pre = STEPS.make_prefill_step(cfg, shape, dev).fn
    dec = STEPS.make_decode_step(cfg, shape, dev).fn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), ms = timed(torch, lambda: pre(params, {"tokens": tokens}))
    counts = read_counts()
    check_counts(counts, {"wkv": cfg.n_layers}, "(L1) prefill")
    check(logits.shape == (1, cfg.vocab_size) and finite_tree(torch, cache)
          and bool(logits.isfinite().all()), "(L1) prefill: non-finite")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    dl, dcache, step_ms = greedy_decodes(torch, dec, params, tok, cache, T, 32,
                                         "(L1)")
    check_counts(read_counts(), {"wkv": cfg.n_layers}, "(L1) prefill + decodes")
    check(finite_tree(torch, dcache), "(L1) decode state: non-finite")
    peak = measured_peak(torch, "(L1) prefill + 32 decodes", r["peak_bytes"])
    flops = r["flops"]
    med = statistics.median(step_ms)
    log(f"(L1) rwkv6-3b long_500k: prefill 1 x {T} ({T // 32} chunks of 32) "
        f"{ms:.1f} ms, {T * 1e3 / ms:.0f} tokens/s, {flops:.4g} FLOP counted "
        f"-> {flops / ms / 1e9:.1f} TFLOP/s, {flops / (ms / 1e3) / BF16_FLOP_S:.3f}"
        f" of the 989 TFLOP/s bf16 peak; 32 greedy decodes to position "
        f"{T + 31}: median {med:.2f} ms a step (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}); K4 {counts['wkv']} launches; every logit and "
        f"state finite")
    del logits, cache, dl, dcache
    torch.cuda.empty_cache()
    # the trace on the prompt's first L1_TRACE tokens (the whole prompt's
    # through PR 29: a second 16.5 s prefill under the profiler, for the
    # script's time; K4's work a chunk is the same at any T)
    trace = profile_device(torch, lambda: pre(params, {
        "tokens": tokens[:, :L1_TRACE]}), f"(L1) prefill 1 x {L1_TRACE} (the "
        f"prompt's first {L1_TRACE:,} tokens)", "wkv_kernel")

    # -- (L2): K4 on layer 0's operands --------------------------------------
    ops = k4_layer0_operands(torch, RW, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    chunk = cfg.rwkv_chunk
    small = [x[:, :, :2048].contiguous() for x in ops[:4]] + [ops[4], None]
    o_e, S_e = WK.wkv_reference(*small, chunk=chunk)
    o_g, S_g = plain_wkv_replayed(torch, WK, small, chunk)
    gap = max(float((o_g - o_e).abs().max()) / float(o_e.abs().max()),
              float((S_g - S_e).abs().max()) / float(S_e.abs().max()))
    check(gap <= F32_REL, f"(L2) the replayed plain WKV against the eager one "
                          f"at T 2048: {gap:.3e}")
    log(f"(L2) the plain version replayed as a CUDA graph against it run "
        f"eagerly, T 2048: {gap:.3e} of the largest magnitude")
    del small, o_e, S_e, o_g, S_g
    errs = {}
    for t in (2048, 65536, T):
        part = ops if t == T else (
            [x[:, :, :t].contiguous() for x in ops[:4]] + [ops[4], None])
        (o, S), k_ms = timed(torch, lambda: WK.wkv(*part, chunk=chunk))
        (o_ref, S_ref), plain_ms = timed(
            torch, lambda: plain_wkv_replayed(torch, WK, part, chunk))
        errs[t] = {"o": (float((o - o_ref).abs().max()),
                         float(o_ref.abs().max())),
                   "S": (float((S - S_ref).abs().max()),
                         float(S_ref.abs().max()))}
        e = errs[t]
        log(f"(L2) K4 vs its plain version on layer 0's operands at T {t}: o "
            f"max abs err {e['o'][0]:.3e} of {e['o'][1]:.4g} "
            f"({e['o'][0] / e['o'][1]:.3e}), S_final {e['S'][0]:.3e} of "
            f"{e['S'][1]:.4g} ({e['S'][0] / e['S'][1]:.3e}); the plain "
            f"version {plain_ms:.1f} ms (replayed)")
        if t != T:
            del part, o, S, o_ref, S_ref
    err = within(o, o_ref, False, f"(L2) K4 o at T {T}")[0]
    within(S, S_ref, False, f"(L2) K4 S_final at T {T}")
    del o, S, o_ref, S_ref
    ms3 = time_ms(torch, lambda: WK.wkv(*ops, chunk=chunk), 3, warmup=0)
    bound, by, nbytes, kflops = k4_bound(torch, ops, cfg.rwkv_chunk)
    geo = WK.geometry(1, RW.n_heads(cfg), cfg.head_dim, cfg.rwkv_chunk,
                      ops[0].dtype, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"(L2) K4 at T {T}: {ms3:.3f} ms a launch (CUDA events, 3 launches; "
        f"the first of the comparison {k_ms:.3f} ms), plain version "
        f"{plain_ms:.1f} ms (replayed), bound {bound:.3f} ms by {by} "
        f"({nbytes:.4g} B, {kflops:.4g} FLOP; {bound / ms3:.3f} of it); grid "
        f"{geo['grid']} CTAs "
        f"on the card's {sms} SMs ({geo['ctas_per_sm']} CTAs an SM fit)")
    del ops
    torch.cuda.empty_cache()
    entry = {"T": T, "launches": counts["wkv"], "ms": ms3,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "max_abs_err": err, "grid": geo["grid"], "sms": sms,
             "errs": {str(t): e for t, e in errs.items()}}
    return entry, {"prefill_ms": ms, "decode_ms": med, "peak": peak,
                   "trace": trace}


def teacher_forced(torch, STEPS, cfg, params, toks, n, label):
    """A prefill of S - n then n decodes fed the prompt's own tokens,
    against a prefill of all S (the last position's logits).  Returns the
    max abs error over the largest logit."""
    B, S = toks.shape
    from repro_torch.configs import ShapeSuite
    suite = ShapeSuite(label, S, B, "prefill")
    pre = STEPS.make_prefill_step(cfg, suite, toks.device).fn
    dec = STEPS.make_decode_step(cfg, suite, toks.device).fn
    torch.cuda.empty_cache()
    full, cache = pre(params, {"tokens": toks})
    del cache
    torch.cuda.empty_cache()
    lg, cache = pre(params, {"tokens": toks[:, :S - n]})
    for i in range(n):
        pos = torch.full((B,), S - n + i, dtype=torch.int32, device=toks.device)
        lg, cache = dec(params, toks[:, S - n + i:S - n + i + 1], cache, pos)
    check(bool(lg.isfinite().all()) and finite_tree(torch, cache),
          f"{label}: non-finite")
    scale = float(full.abs().max())
    err = float((lg - full).abs().max())
    check(err <= 1e-4 * scale, f"{label}: {err:.3e} of the largest logit "
                               f"{scale:.4g} (bound 1e-4 of it)")
    return err, scale


def long_f32_checks(torch, dev, STEPS, reck):
    """(L3)."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import materialize
    from repro_torch.models import get_model
    out = {}
    for arch, layers, n, step, label in (
            ("rwkv6-3b", 2, 32, 32, "(L3) rwkv6-3b 2 layers f32"),
            ("recurrentgemma-9b", 3, 512, 512,
             "(L3) recurrentgemma-9b 1 unit f32")):
        r = reck["prefill"][f"L3 {arch}"]
        cfg = get_config(arch).replace(n_layers=layers,
                                       param_dtype=torch.float32,
                                       compute_dtype=torch.float32)
        S = longest_fit(r, step, LONG_S)
        log_prefill_reckoning(r, label, 1, S)
        if S < LONG_S:
            log(f"{label}: cut: S {S}, the longest multiple of {step} up to "
                f"{LONG_S} whose reckoned peak fits {FIT_BYTES / 1e9:.0f} GB")
        params = materialize(get_model(cfg).specs(cfg),
                             torch.Generator(device=dev).manual_seed(2))
        toks = torch.randint(0, cfg.vocab_size, (1, S), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3)).to(dev)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        err, scale = teacher_forced(torch, STEPS, cfg, params, toks, n, label)
        counts = read_counts()
        check_counts(counts, {"wkv": 2 * layers} if arch == "rwkv6-3b" else {},
                     label)
        peak = measured_peak(torch, label, at_len(r, "peak_bytes", S))
        log(f"{label}: a prefill of {S - n} then {n} decodes fed its tokens "
            f"against a prefill of {S}: last logits {err:.3e} of the largest "
            f"{scale:.4g} ({err / scale:.3e}; bound 1e-4 of it), "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        out[arch] = {"S": S, "err": err, "scale": scale, "peak": peak}
        del params, toks
        torch.cuda.empty_cache()
    return out


def long_rglru(torch, dev, STEPS, A, reck):
    """(L4)."""
    from repro_torch.configs import ShapeSuite, get_config
    from repro_torch.models import rglru as R
    cfg = get_config("recurrentgemma-9b")
    log_cell(reck, "recurrentgemma-9b long_500k")
    r = reck["prefill"]["L4"]
    fit = longest_fit(r, 1024, LONG_S - 32)
    T = min(fit, L4_PROMPT)
    log_prefill_reckoning(r, "(L4) recurrentgemma-9b", 1, T)
    if T < LONG_S - 32:
        log(f"(L4) cut: a prompt of {T} tokens, the smaller of "
            f"{L4_PROMPT} (the script's time) and {fit}, the longest "
            f"multiple of 1024 whose reckoned peak fits "
            f"{FIT_BYTES / 1e9:.0f} GB (the long_500k prompt of "
            f"{LONG_S - 32} is reckoned at {r['peak_bytes'] / 1e9:.1f} GB)")
    shape = ShapeSuite("long_500k", T + 32, 1, "decode")
    params = draw(torch, dev, R.rglru_model_specs(cfg), 0,
                  "(L4) recurrentgemma-9b", 9_396_195_328)
    tokens = torch.randint(0, cfg.vocab_size, (1, T), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    pre = STEPS.make_prefill_step(cfg, shape, dev).fn
    dec = STEPS.make_decode_step(cfg, shape, dev).fn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), ms = timed(torch, lambda: pre(params, {"tokens": tokens}))
    check(bool(logits.isfinite().all()) and finite_tree(torch, cache),
          "(L4) prefill: non-finite")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    dl, dcache, step_ms = greedy_decodes(torch, dec, params, tok, cache, T, 32,
                                         "(L4)")
    check_counts(read_counts(), {}, "(L4) prefill + decodes")
    peak = measured_peak(torch, "(L4) prefill + 32 decodes",
                         at_len(r, "peak_bytes", T))
    flops = at_len(r, "flops", T)
    med = statistics.median(step_ms)
    log(f"(L4) recurrentgemma-9b long_500k: prefill 1 x {T} {ms:.1f} ms, "
        f"{T * 1e3 / ms:.0f} tokens/s, {flops:.4g} FLOP counted -> "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {flops / (ms / 1e3) / BF16_FLOP_S:.3f}"
        f" of the bf16 peak; 32 greedy decodes to position {T + 31}: median "
        f"{med:.2f} ms a step; K1-K4 0 launches; every logit and state finite")
    del logits, cache, dl, dcache
    torch.cuda.empty_cache()
    # the trace on the prompt's first L4_TRACE tokens: the whole prompt's
    # prefill issues ~2,000 device ops every 1,000 tokens (the flash query
    # chunks of a local layer at batch 1), whose events the profiler reads
    # slowly (~6 minutes at 270,336 tokens; 16,384 through PR 29)
    trace = profile_ranges(torch, lambda: pre(params, {
        "tokens": tokens[:, :L4_TRACE]}), f"(L4) prefill 1 x {L4_TRACE} (the "
        f"prompt's first {L4_TRACE:,} tokens)",
                           {**attention(A), "scan": [(R, "rglru_scan")]},
                           warm=False)
    del params
    torch.cuda.empty_cache()
    return {"T": T, "prefill_ms": ms, "decode_ms": med, "peak": peak,
            "trace": trace}


def cat_batch(axes, trees, path=()):
    """Caches of row groups joined along each leaf's batch axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: cat_batch(axes, [t[k] for t in trees], path + (k,))
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(cat_batch(axes, [t[i] for t in trees], path + (i,))
                           for i in range(len(first)))
    import torch
    return torch.cat(trees, dim=axes[path])


def decode_cells(torch, dev, STEPS, reck):
    """(D)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import get_model
    from repro_torch.runtime.serving import _batch_axes
    shape = SHAPES["decode_32k"]
    B, P = shape.global_batch, D_PROMPT
    out = {}
    for arch, n_params in (("rwkv6-3b", 3_094_451_200),
                           ("recurrentgemma-9b", 9_396_195_328)):
        cfg = get_config(arch)
        api = get_model(cfg)
        log_cell(reck, f"{arch} decode_32k")
        rows = next((b for b in (128, 64)
                     if reck["prefill"][f"D {arch} {b}"]["peak_bytes"]
                     <= FIT_BYTES), None)
        check(rows is not None, f"(D) {arch}: no row group of the prefill fits")
        r = reck["prefill"][f"D {arch} {rows}"]
        log_prefill_reckoning(r, f"(D) {arch}", rows, P)
        params = draw(torch, dev, api.specs(cfg), 0, f"(D) {arch}", n_params)
        tokens = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1)).to(dev)
        pre = STEPS.make_prefill_step(cfg, shape, dev).fn
        dec = STEPS.make_decode_step(cfg, shape, dev).fn
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        parts = [pre(params, {"tokens": tokens[i:i + rows]})
                 for i in range(0, B, rows)]
        axes = _batch_axes(api, cfg, shape.seq_len)
        logits = torch.cat([p[0] for p in parts])
        cache = cat_batch(axes, [p[1] for p in parts])
        del parts
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        fill = read_counts()
        check_counts(fill, {"wkv": cfg.n_layers * (B // rows)}
                     if arch == "rwkv6-3b" else {}, f"(D) {arch} prefill")
        reset_counts()
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        dl, cache, step_ms = greedy_decodes(torch, dec, params, tok, cache, P,
                                            16, f"(D) {arch}", B=B)
        check_counts(read_counts(), {}, f"(D) {arch} decodes")
        peak = measured_peak(torch, f"(D) {arch} prefill + 16 decodes",
                             r["peak_bytes"])
        med = statistics.median(step_ms)
        log(f"(D) {arch} decode_32k: the caches filled by a prefill of {B} x "
            f"{P} ({B // rows} group(s) of {rows} rows, {fill_s:.1f} s, "
            f"launches {fill}); 16 greedy decodes of batch {B}: median "
            f"{med:.2f} ms a step (min {min(step_ms):.2f}, max "
            f"{max(step_ms):.2f}), {B * 1e3 / med:.0f} tokens/s, K1-K4 0; cut: "
            f"the positions run {P}..{P + 15}, not 32,767 (a state and a "
            f"2,048-slot ring: the step's work does not grow with the "
            f"positions)")
        out[arch] = {"decode_ms": med, "tok_s": B * 1e3 / med, "peak": peak,
                     "rows": rows}
        del params, tokens, logits, cache, dl
        torch.cuda.empty_cache()
    return out


def long_context_phase(torch, dev, WK, job):
    """Phase 17; returns K4's "long" entry."""
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import attention as A
    reck = read_reckoning(job)
    t0 = time.perf_counter()
    entry, l1 = long_rwkv(torch, dev, WK, STEPS, reck)
    t1 = time.perf_counter()
    l3 = long_f32_checks(torch, dev, STEPS, reck)
    t2 = time.perf_counter()
    l4 = long_rglru(torch, dev, STEPS, A, reck)
    t3 = time.perf_counter()
    d = decode_cells(torch, dev, STEPS, reck)
    t4 = time.perf_counter()
    log(f"phase 17 parts: (L1)+(L2) {t1 - t0:.1f} s, (L3) {t2 - t1:.1f} s, "
        f"(L4) {t3 - t2:.1f} s, (D) {t4 - t3:.1f} s")
    log("phase 17 json: " + json.dumps({"L1": l1, "L2": entry, "L3": l3,
                                        "L4": l4, "D": d}))
    return entry


# ---------------------------------------------------------------------------
# phase 18: the sharded carry, two ranks of a gloo group on the one card
# ---------------------------------------------------------------------------

SHARDED_TIMEOUT = 300      # s: the group's join timeout, a failure past it

# the phase's widths: (s1)'s n for (h1), (s4)'s for (h2), a rewire at n 256
# for (h3), olmoe's MoE block on 4 x 512 tokens for (h4)
H1_N, H2_N, H3_N, MOE_TOKENS = 1024, 512, 256, (4, 512)


def rank_log(rank, *a):
    log(f"[rank {rank}]", *a)


def timed_ms(torch, fn):
    """(fn's result, its ms on the host clock with the card drained before
    and after): one run, bare."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def k1_timed(torch, CF, CK, ops, rank, label, name):
    """K1 on these operands timed by time_k1 (kernel, plain, baddbmm on
    pre-gathered tiles, bound), logged; its kernels-line numbers."""
    t = time_k1(torch, CF, CK, ops, 5, 3)
    Pc = ops[1].shape[-1]
    rank_log(rank, f"{label} K1 at the {name} width (Pc_pad {Pc:,}): kernel "
             f"{t['ms']:.4f} ms a launch, plain {t['plain_ms']:.4f} ms, "
             f"baddbmm on pre-gathered tiles {t['library_ms']:.4f} ms, bound "
             f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.0f} B, "
             f"{t['flops']:.0f} FLOP); in turn: kernel {t['alt_ms']:.4f}, "
             f"baddbmm {t['alt_library_ms']:.4f} ms; device: kernel "
             f"{t['device_us']} us, baddbmm {t['library_device_us']} us")
    return {**t, "Pc_pad": Pc}


def sharded_engine(torch, SH, mesh, rank, dev, n, L, label, k1=False):
    """(h1)/(h2): 8 steps of the scaled learner on a carry placed on
    (data 1, model 2) by sharded_step_specs, compact_fused, capacity 1.
    The window is timed bare with both ranks at once, K1 counted (a
    launch a layer a step on each rank's column half), then each rank's
    window alone (the other idle at a barrier), bare too; an untimed
    window under CommDebugMode and the port's own collective counts
    (`sharding.counts`) shows the update's collectives (0), then grads'.
    On rank 0: the gathered carry and grads against the one-rank run
    (1e-5 of each leaf's largest entry), whose warm window is timed bare
    as the sharded ones are.  With `k1`: K1's operands at step 5 built by
    `fused_step_operands`, at the half width from rank 0's local state and
    column layout (their launch is bitwise the sharded step's vals) and at
    the full width from the one-rank state, each against its plain version
    and timed by time_k1; then each rank's window traced alone in turn
    (device ops, idle share)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.core import scaled_rtrl as SR, sparse_rtrl as SP
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.kernels import compact as CK, compact_fused as CF
    from repro_torch.sharding import to_local
    cfg, params, masks, xs, labels = scaled_setup(torch, SR, dev, n=n, L=L)
    T = xs.shape[0]
    spec = LearnerSpec(engine="scaled", cfg=cfg, backend="compact_fused")
    lr = make_learner(spec)
    carry0 = lr.place(lr.init(params, masks, (xs[0], labels), t_total=T),
                      mesh)

    def steps(learner, c, t0, t1):
        for t in range(t0, t1):
            c, _ = learner.step(c, xs[t], labels)
        return c
    window = lambda: steps(lr, carry0, 0, T)
    window()                                     # warm: K1 and the host path
    SH.barrier()
    reset_counts()
    carry, window_ms = timed_ms(torch, window)
    counts = read_counts()
    check_counts(counts, {"compact_fused": T * L}, f"{label} rank {rank}")
    alone_ms = None
    SH.barrier()                # the other rank's window has ended too
    for r in range(2):
        if r == rank:
            _, alone_ms = timed_ms(torch, window)
        SH.barrier()
    SH.counts.clear()
    with CommDebugMode() as cm:
        window()
    upd = dict(SH.counts)
    check(cm.get_total_counts() == 0 and not upd,
          f"{label} rank {rank}: {cm.get_comm_counts()} / {upd} collectives "
          "in the influence update")
    vals = carry["state"]["vals"]
    local = tuple(to_local(vals[0] if L > 1 else vals).shape)
    SH.counts.clear()
    with CommDebugMode() as cg:
        grads = lr.grads(carry)
    grad_colls = dict(SH.counts)
    full = lr.gather(carry)
    res = {"launches": counts["compact_fused"], "local_vals": local,
           "window_ms": window_ms, "alone_window_ms": alone_ms,
           "update_collectives": 0, "grad_collectives": grad_colls,
           "grad_comm_ops": cg.get_total_counts()}
    rank_log(rank, f"{label} n {n} L {L}: {T} steps, K1 launches "
             f"{counts['compact_fused']} on vals {local} (its column half), "
             f"0 collectives in the steps, grads' collectives {grad_colls}; "
             f"window {window_ms:.2f} ms with both ranks at once, "
             f"{alone_ms:.2f} ms alone (bare, warm)")
    w = {k: v for k, v in params.items() if k != "out"}
    if k1:
        c = steps(lr, carry0, 0, 4)
        sh = lr._shards(mesh)
        st = sh.local(c)["state"]
        half = list(SP.fused_step_operands(
            cfg.cell_cfg(), w, cfg.layout(), st["a"], st["vals"], st["idx"],
            sh.rows(xs[4]), cl=sh.cl())[2])
        nxt, _ = lr.step(c, xs[4], labels)
        same = torch.equal(CF.fused_update(*half),
                           to_local(nxt["state"]["vals"]))
        check(same, f"{label} rank {rank}: K1 on the rebuilt half-width "
                    "operands differs from the sharded step's vals")
        del c, st, nxt
    SH.barrier()
    if rank == 0:
        one = make_learner(spec)
        init1 = lambda: one.init(params, masks, (xs[0], labels), t_total=T)
        c1 = steps(one, init1(), 0, T)
        g1 = one.grads(c1)
        st = device_gap(full["state"], c1["state"])
        gr = device_gap(grads, g1)
        lerr = abs(float(full["loss"]) - float(c1["loss"])) / abs(
            float(c1["loss"]))
        check(st[0] <= F32_REL and gr[0] <= F32_REL and lerr <= F32_REL,
              f"{label}: sharded vs one rank: state {st}, grads {gr}, loss "
              f"{lerr:.3e}")
        c = init1()
        _, one_ms = timed_ms(torch, lambda: steps(one, c, 0, T))
        del c
        res.update(state_vs_one=st[0], grads_vs_one=gr[0], loss_vs_one=lerr,
                   state_bitwise=st[2], grads_bitwise=gr[2],
                   one_rank_window_ms=one_ms)
        rank_log(rank, f"{label}: the gathered carry vs the one-rank run: "
                 f"state {st[0]:.2e} ({'bitwise' if st[2] else st[1]}), "
                 f"rtrl grads {gr[0]:.2e} ({'bitwise' if gr[2] else gr[1]}),"
                 f" loss {lerr:.2e} (bound 1e-5 of each leaf's largest "
                 f"entry); the one-rank window {one_ms:.2f} ms (bare, warm, "
                 "rank 1 idle)")
        if k1:
            c = steps(one, init1(), 0, 4)
            s1 = c["state"]
            whole = list(SP.fused_step_operands(
                cfg.cell_cfg(), w, cfg.layout(), s1["a"], s1["vals"],
                s1["idx"], xs[4], cl=cfg.col_layout(masks, device=dev))[2])
            del c, s1
            res["max_abs_err"] = compare_k1(torch, CF, half,
                                            f"{label} half width (rank 0)")
            compare_k1(torch, CF, whole, f"{label} full width")
            for name, ops in (("half", half), ("full", whole)):
                res[f"k1_{name}"] = k1_timed(torch, CF, CK, ops, rank, label,
                                             name)
            del whole
        del c1, g1
    if k1:
        del half
    SH.barrier()
    if k1:
        for r in range(2):
            if r == rank:
                tr = profile_ranges(torch, lambda: steps(lr, carry, 0, T),
                                    f"{label} rank {rank} window", {},
                                    warm=False)
                if tr is not None:
                    res["idle"], res["ops_per_step"] = tr["idle"], \
                        tr["ops"] / T
                    rank_log(rank, f"{label} window traced alone: "
                             f"{tr['ops'] / T:.1f} device ops a step, idle "
                             f"share {tr['idle']:.3f}, wall "
                             f"{tr['wall_us'] / 1e3:.2f} ms")
            SH.barrier()
    del carry, carry0, full, grads
    torch.cuda.empty_cache()
    return res


def tree_leaves_of(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def device_gap(a, b):
    """leaf_gap on the leaves' own device (the carry's GB-sized buffers
    stay on the card): (worst relative error, its leaf, all leaves
    bitwise)."""
    from repro_torch.tree import leaf_name, tree_flatten_with_path
    worst, name, same = 0.0, "", True
    for (p, x), (_, y) in zip(tree_flatten_with_path(a),
                              tree_flatten_with_path(b)):
        same = same and bool(x.shape == y.shape and (x == y).all())
        gap = float((x.float() - y.float()).abs().max()) / max(
            float(y.abs().max()), 1e-30)
        if gap >= worst:
            worst, name = gap, leaf_name(p)
    return worst, name, same


def sharded_rewire(torch, SH, mesh, rank, dev, n, root):
    """(h3) one RigL event on the sharded rewirable compact carry at n 256
    (capacity 1): the migrated vals bitwise the one-rank event's, the next
    4 steps against the one-rank run; then (h5b) the carry written sharded
    by both ranks and restored on one rank, bitwise."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import scaled_rtrl as SR
    from repro_torch.core.learner import LearnerSpec, make_learner
    cfg, params, masks, xs, labels = scaled_setup(torch, SR, dev, n=n)
    spec = LearnerSpec(engine="scaled", cfg=cfg, backend="compact",
                       col_compact=True, rewirable=True)
    lr, one = make_learner(spec), make_learner(spec)
    c2 = lr.place(lr.init(params, masks, (xs[0], labels), t_total=8.0), mesh)
    c1 = one.init(params, masks, (xs[0], labels), t_total=8.0)
    for t in range(4):
        c2, _ = lr.step(c2, xs[t], labels)
        c1, _ = one.step(c1, xs[t], labels)
    c2, c1 = lr.reset_grads(c2), one.reset_grads(c1)
    SH.counts.clear()
    c2, event_ms = timed_ms(torch, lambda: lr.rewire(
        c2, (0, 1), frac=0.3, method="rigl", block=cfg.mask_block))
    colls = dict(SH.counts)
    c1 = one.rewire(c1, (0, 1), frac=0.3, method="rigl", block=cfg.mask_block)
    mid = lr.gather(c2)
    mig = torch.equal(mid["state"]["vals"], c1["state"]["vals"])
    check(mig, f"(h3) rank {rank}: migrated vals differ from the one-rank "
               "event's")
    for t in range(4, 8):
        c2, _ = lr.step(c2, xs[t], labels)
        c1, _ = one.step(c1, xs[t], labels)
    end = lr.gather(c2)
    st = device_gap(end["state"], c1["state"])
    gr = device_gap(lr.grads(c2), one.grads(c1))
    same = st[2]
    check(st[0] <= F32_REL and gr[0] <= F32_REL,
          f"(h3) rank {rank}: after the event, state {st}, grads {gr}")
    rank_log(rank, f"(h3) RigL event (frac 0.3, 8 x 8 blocks) at n {n}: "
             f"{event_ms:.2f} ms, collectives {colls}; migrated vals bitwise "
             f"the one-rank event's; the next 4 steps: state "
             f"{'bitwise' if same else f'{st[0]:.2e}'}, grads {gr[0]:.2e} "
             "of the one-rank run's")
    # (h5b) a sharded checkpoint, restored whole on one rank
    ck = Path(root) / "ckpt"
    save_checkpoint(ck, 1, {"carry": c2})
    ck_ok = True
    if rank == 0:
        like = {"carry": end}
        got, step = load_checkpoint(ck, like)
        ck_ok = step == 1 and all(
            torch.equal(a, b) for a, b in zip(tree_leaves_of(got["carry"]),
                                              tree_leaves_of(end)))
        nfiles = len(list((ck / "step_00000001").glob("carry__state__vals.*")))
        check(ck_ok and nfiles == 2, f"(h5) checkpoint written by 2 ranks, "
              f"restored on one: bitwise {ck_ok}, vals files {nfiles}")
        rank_log(rank, "(h5) the carry written sharded by both ranks (vals in "
                 f"{nfiles} shard files) and restored on one rank: bitwise")
    SH.barrier()
    return {"event_ms": event_ms, "event_collectives": colls,
            "migrated_bitwise": mig, "after_state": st[0],
            "after_grads": gr[0], "after_bitwise": same,
            "ckpt_bitwise": ck_ok}


def sharded_moe(torch, SH, mesh, rank, dev):
    """(h4) one olmoe-1b-7b MoE block at full width (64 experts, d 2048,
    d_ff 1024, top 8, bf16): the shardmap form over 'model' (32 experts a
    rank) on MOE_TOKENS (4 x 512) against `dispatch` on one rank, within one
    bf16 step a rounding (2 roundings) of the largest output; run to run
    bitwise; each form's ms."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MO
    from repro_torch.models.module import materialize, tree_shardings
    cfg = get_config("olmoe-1b-7b").replace(moe_impl="shardmap")
    tokens = MOE_TOKENS
    p = materialize(MO.moe_specs(cfg),
                    torch.Generator(device=dev).manual_seed(8))
    x = torch.randn(tokens + (cfg.d_model,), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9)).to(
        cfg.compute_dtype)
    psh = tree_shardings(MO.moe_specs(cfg), SH.make_rules(cfg, mesh), mesh)
    placed = {k: SH.place(v, psh[k]) for k, v in p.items()}
    xp = SH.place(x, SH.NamedSharding(mesh, ("data", None, None)))
    ctx = SH.make_ctx(cfg, mesh)
    SH.counts.clear()
    y, aux = MO.moe_block(cfg, placed, xp, ctx)
    colls = dict(SH.counts)
    y2, aux2 = MO.moe_block(cfg, placed, xp, ctx)
    same = torch.equal(y.to_local(), y2.to_local()) and torch.equal(aux, aux2)
    check(same, f"(h4) rank {rank}: two shardmap runs differ")
    SH.barrier()
    ms = time_ms(torch, lambda: MO.moe_block(cfg, placed, xp, ctx), 5, 1)
    local = tuple(placed["wi"].to_local().shape)
    res = {"collectives": colls, "bitwise": same, "ms": ms,
           "local_wi": local}
    SH.barrier()
    if rank == 0:
        dcfg = cfg.replace(moe_impl="dispatch")
        yd, auxd = MO.moe_block(dcfg, p, x)
        err = float((y.to_local().float() - yd.float()).abs().max())
        scale = float(yd.float().abs().max())
        check(err <= 2 * BF16_STEP * scale and abs(float(aux - auxd))
              <= F32_REL * abs(float(auxd)),
              f"(h4) shardmap vs dispatch {err:.3e} of {scale:.3e}, aux "
              f"{float(aux)} vs {float(auxd)}")
        dms = time_ms(torch, lambda: MO.moe_block(dcfg, p, x), 5, 1)
        res.update(err=err, scale=scale, dispatch_ms=dms)
        rank_log(rank, f"(h4) olmoe-1b-7b MoE block, {tokens[0]} x "
                 f"{tokens[1]} tokens: shardmap "
                 f"(wi {local} a rank) vs dispatch on one rank {err:.3e} of "
                 f"the largest output {scale:.3e} (bound 2 x 2^-7 of it), aux "
                 f"{float(aux):.6f} vs {float(auxd):.6f}; collectives {colls}; "
                 f"two runs bitwise; shardmap {ms:.3f} ms a call (both ranks "
                 f"at once), dispatch {dms:.3f} ms (rank 0 alone)")
    SH.barrier()
    return res


def sharded_compression(torch, SH, rank, dev):
    """(h5a) compressed_psum over a 2-rank 'pod' group on the card: the
    accumulated update over 8 steps within 0.05 of the true mean's (the
    reference's test), the collectives a step."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.runtime import compression as CMP
    mesh = init_device_mesh(dev.type, (2, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    g = {"w": torch.linspace(-1.0, 1.0, 64, device=dev).reshape(8, 8)}
    err = CMP.init_error_state(g)
    total = torch.zeros(8, 8, device=dev)
    SH.counts.clear()
    for _ in range(8):
        g_hat, err = CMP.compressed_psum(g, err, mesh)
        total = total + g_hat["w"]
    dev_ = float((total - 8 * g["w"]).abs().max())
    check(dev_ < 0.05, f"(h5) compressed_psum deviation {dev_}")
    colls = dict(SH.counts)
    rank_log(rank, f"(h5) compressed_psum over a 2-rank pod group, 8 steps: "
             f"accumulated deviation {dev_:.2e} (bound 0.05); collectives "
             f"{colls}")
    return {"deviation": dev_, "collectives": colls}


def sharded_trainer(torch, SH, mesh, rank, dev, root):
    """(h6) the scaled engine at (s1)'s configuration (n 1,024, capacity 1,
    compact_fused) through `OnlineTrainer` on a (data 1, model 2) carry
    (`ScaledLearner.place`): 2 windows of 8 steps (masked adamw), K1
    counted (8 a rank a window, each on the rank's column half); the
    windows' losses and the parameters against the one-rank trainer's
    (rank 0, the other idle; 1e-5); each rank's window ms from the
    trainer's clock beside the one-rank window's; a run crashed after
    update 1 (a sharded checkpoint, each rank its shards) and resumed by
    a new trainer on the mesh (restored by the learner's target
    shardings), bitwise the uncrashed run's carry, parameters and
    optimizer state."""
    import numpy as np
    from repro_torch.core import scaled_rtrl as SR
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.optim import optimizers as O
    from repro_torch.runtime import online as ON
    from repro_torch.runtime.trainer import InjectedFailure
    cfg, params, masks, _, _ = scaled_setup(torch, SR, dev, n=H1_N)
    k, windows = 8, 2
    ys = (np.arange(cfg.batch) % cfg.n_out).astype(np.int32)

    def stream(t):
        rng = np.random.default_rng(1000 + t)
        return (rng.standard_normal((cfg.batch, cfg.n_in)).astype(np.float32),
                ys)

    def make(sharded, ckpt_every=0, fail_at=-1):
        lr = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                      backend="compact_fused"))
        tr = ON.OnlineTrainer(
            ON.OnlineTrainerConfig(total_steps=windows * k, update_every=k,
                                   ckpt_every=ckpt_every, keep=1,
                                   ckpt_dir=str(Path(root) / "h6"),
                                   fail_at_update=fail_at, log_every=1),
            lr, O.masked(O.adamw(lr=1e-3), masks), params, masks, stream,
            device=dev)
        if sharded:
            tr.carry = lr.place(tr.carry, mesh)
            tr.shardings = {"carry": lr.shardings(tr.carry, mesh)}
        return tr
    tr = make(True)
    SH.barrier()
    reset_counts()
    tr.run()
    counts = read_counts()
    check_counts(counts, {"compact_fused": windows * k},
                 f"(h6) rank {rank} trainer")
    losses = [w["loss"] for w in tr.windows]
    ms = [w["ms"] for w in tr.windows]
    local = tuple(SH.to_local(tr.carry["state"]["vals"]).shape)
    check(local[-1] * 2 == tr.learner._cl.Pc_pad,
          f"(h6) rank {rank}: local vals {local}")
    # a crash after update 1 and the resume, on the same mesh
    crashed = make(True, ckpt_every=1, fail_at=1)
    try:
        crashed.run()
        check(False, "(h6) the injected failure did not fire")
    except InjectedFailure:
        pass
    del crashed
    resumed = make(True, ckpt_every=windows)
    ok = resumed.try_resume() and (resumed.step, resumed.update) == (k, 1)
    resumed.run()
    same = ok and all(bitwise(torch, tree_leaves_of(a), tree_leaves_of(b))
                      for a, b in ((tr.learner.gather(tr.carry),
                                    resumed.learner.gather(resumed.carry)),
                                   (tr.opt_state, resumed.opt_state)))
    check(same, f"(h6) rank {rank}: the resumed run differs from the "
                "uncrashed one")
    del resumed
    res = {"launches": counts["compact_fused"], "windows": windows,
           "local_vals": local, "losses": losses, "window_ms": ms,
           "resumed_bitwise": same}
    SH.barrier()
    if rank == 0:
        one = make(False)
        one.run()
        one_losses = [w["loss"] for w in one.windows]
        lerr = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
        perr = device_gap(tr.carry["params"], one.carry["params"])
        check(lerr <= F32_REL and perr[0] <= F32_REL,
              f"(h6) trainer vs one rank: losses {lerr:.3e}, params {perr}")
        res.update(loss_vs_one=lerr, params_vs_one=perr[0],
                   one_rank_window_ms=[w["ms"] for w in one.windows])
        del one
    SH.barrier()
    rank_log(rank, f"(h6) OnlineTrainer on (1, 2), n {cfg.n}: {windows} "
             f"windows of {k} steps, K1 {counts['compact_fused']} launches "
             f"on vals {local}; losses {[f'{x:.6f}' for x in losses]}, "
             f"window ms {[f'{x:.2f}' for x in ms]} (the trainer's clock, "
             "both ranks at once); crash after update 1 and resume: "
             f"bitwise {same}" + ("" if rank else
                                  f"; vs the one-rank trainer: losses "
                                  f"{res['loss_vs_one']:.2e}, parameters "
                                  f"{res['params_vs_one']:.2e}, its window "
                                  f"ms {[f'{x:.2f}' for x in res['one_rank_window_ms']]}"))
    del tr
    torch.cuda.empty_cache()
    return res


def sharded_rank(rank, world, out_dir):
    """One rank of phase 18: both ranks on card 0, in a gloo group."""
    import torch
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    from repro_torch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2)
    res, parts, t0 = {}, {}, time.perf_counter()
    for name, fn in (
            ("h1", lambda: sharded_engine(torch, SH, mesh, rank, dev, H1_N,
                                          1, "(h1)", k1=True)),
            ("h2", lambda: sharded_engine(torch, SH, mesh, rank, dev, H2_N,
                                          2, "(h2)")),
            ("h3", lambda: sharded_rewire(torch, SH, mesh, rank, dev, H3_N,
                                          out_dir)),
            ("h4", lambda: sharded_moe(torch, SH, mesh, rank, dev)),
            ("h5", lambda: sharded_compression(torch, SH, rank, dev)),
            ("h6", lambda: sharded_trainer(torch, SH, mesh, rank, dev,
                                           out_dir))):
        res[name] = fn()
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    res["seconds"] = parts
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m == "repro" or m.startswith("repro."))
    check(not res["jax_imported"], f"rank {rank} imported {res['jax_imported']}")
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def sharded_phase(torch):
    """Phase 18 (module docstring): the two-rank group's run, then the
    ranks' results read back.  Returns K1's "sharded" entry of the kernels
    line."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        t0 = time.perf_counter()
        spawn(sharded_rank, 2, str(root), timeout=SHARDED_TIMEOUT)
        wall = time.perf_counter() - t0
        ranks = [json.loads((root / f"rank{r}.json").read_text())
                 for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    h1, h2 = ranks[0]["h1"], ranks[0]["h2"]
    for r in ranks:
        check(r["h1"]["launches"] == 8 and r["h2"]["launches"] == 16
              and r["h6"]["launches"] == 16,
              f"phase 18 launches {r['h1']['launches']}, "
              f"{r['h2']['launches']}, {r['h6']['launches']}")
    h6 = ranks[0]["h6"]
    log(f"phase 18 group: {wall:.1f} s wall (spawn, CUDA init and the checks)"
        f"; seconds by part (rank 0): " + ", ".join(
            f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items()))
    log("phase 18 json: " + json.dumps(ranks))
    return {"launches_per_rank": [r["h1"]["launches"] for r in ranks],
            "stacked_launches_per_rank": [r["h2"]["launches"] for r in ranks],
            "local_vals": h1["local_vals"],
            "update_collectives": 0,
            "grad_collectives": h1["grad_collectives"],
            "max_abs_err": h1["max_abs_err"],
            "half": h1["k1_half"], "full": h1["k1_full"],
            "vs_one_rank": {"h1": h1["grads_vs_one"], "h2": h2["grads_vs_one"]},
            "window_ms": [r["h1"]["window_ms"] for r in ranks],
            "alone_window_ms": [r["h1"]["alone_window_ms"] for r in ranks],
            "one_rank_window_ms": h1["one_rank_window_ms"],
            "idle": [r["h1"].get("idle") for r in ranks],
            "trainer": {"launches_per_rank": [r["h6"]["launches"]
                                              for r in ranks],
                        "windows": h6["windows"],
                        "window_ms": [r["h6"]["window_ms"] for r in ranks],
                        "one_rank_window_ms": h6["one_rank_window_ms"],
                        "loss_vs_one": h6["loss_vs_one"],
                        "params_vs_one": h6["params_vs_one"],
                        "resumed_bitwise": all(r["h6"]["resumed_bitwise"]
                                               for r in ranks)},
            "group_s": wall}


# ---------------------------------------------------------------------------
# phase 19: the LM's sharded steps, two ranks of a gloo group on the one card
# ---------------------------------------------------------------------------

LM_SHARDED_TIMEOUT = 420   # s: the group's join timeout, a failure past it
# (m1)'s prefill (batch, tokens), and how far rank 0's measured peak may lie
# from the dry-run's reckoning of it (phase 17's one-card reckonings met the
# card within 1.1-8.4 %)
M1_PREFILL = (4, 512)
PEAK_RECKON_REL = 0.10


def whole_leaf(SH, x):
    """A placed leaf whole on this rank, gathered with the port's own
    (counted, host-staged) all_gather over each mesh dim that shards it,
    minor dims first; a plain leaf as it is."""
    if not SH.is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    mesh, out = x.device_mesh, x.to_local()
    for name, p in reversed(list(zip(mesh.mesh_dim_names, x.placements))):
        if isinstance(p, Shard):
            out = SH.all_gather(out, mesh, name, axis=p.dim)
    return out


def rel_err(torch, got, want):
    """max |got - want| over max |want| (float64 on the card)."""
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def lm_sharded_prefill(torch, SH, mesh, rank, dev):
    """(m1): rwkv6-3b at full width on (data 1, model 2) through
    `make_prefill_step(..., mesh=)`: bf16 at full depth, 4 x 512 tokens,
    K4 counted (a launch a layer a rank, each on 20 of the 40 heads), its
    ms with both ranks at once and peak bytes against the one-rank
    prefill's (rank 0, the other rank idle); layer 0's K4 on the rank's
    operands against its plain version, and on the one-rank operands'
    halves bitwise the one-rank launch's heads; every layer's bf16 time
    mix against the plain WKV (5 %); f32 at 2 layers, 4 x 256 tokens: the
    gathered logits against the one-rank prefill's (1e-5 of the largest)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.kernels import wkv as WK
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import rwkv as RW
    from repro_torch.models.module import ShardCtx, materialize
    cfg = get_config("rwkv6-3b")
    H, L = RW.n_heads(cfg), cfg.n_layers
    B, T = M1_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    out = {}
    pre = STEPS.make_prefill_step(cfg, ShapeSuite("p", T, B, "prefill"), dev,
                                  mesh=mesh)
    draw = lambda: materialize(RW.rwkv_model_specs(cfg),
                               torch.Generator(device=dev).manual_seed(0))
    held = torch.cuda.memory_allocated()
    params = SH.place_tree(draw(), pre.shardings["params"])
    torch.cuda.empty_cache()
    calls = []
    batch = {"tokens": tokens}
    pre.fn(params, batch)                       # warm: the kernel's load
    runs, logits, cache = [], None, None
    for i in range(2):
        del logits, cache           # the peak is the run's, as reckoned
        SH.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls.clear()
        reset_counts()
        SH.counts.clear()
        with recorded_wkv(WK, calls):
            (logits, cache), ms = timed_ms(torch, lambda: pre.fn(params, batch))
        counts, colls = read_counts(), dict(SH.counts)
        runs.append(ms)
        check_counts(counts, {"wkv": L}, f"(m1) rank {rank} prefill")
        check(calls[1:] == [H // 2] * L,
              f"(m1) rank {rank}: K4 heads {calls[1:]}")
    peak = torch.cuda.max_memory_allocated() - held
    loc = SH.to_local(logits)
    check(tuple(loc.shape) == (B, cfg.vocab_size // 2)
          and bool(loc.isfinite().all()), f"(m1) logits {tuple(loc.shape)}")
    out.update(launches=counts["wkv"], heads=calls[1], prefill_ms=min(runs),
               prefill_runs_ms=runs, peak_bytes=peak, collectives=colls)
    ops = calls[0]
    err, _ = compare_k4(torch, WK, ops, cfg.rwkv_chunk,
                        f"(m1) rank {rank}: layer 0 of the sharded prefill")
    out["max_abs_err"] = err
    del logits, cache
    ctx = ShardCtx(mesh, SH.make_rules(cfg, mesh), seq=T)
    out["time_mix_vs_plain"] = bf16_layers_vs_plain(
        torch, RW, WK, cfg, SH.local_tree(params), tokens, ctx)
    check(out["time_mix_vs_plain"] <= 0.05,
          f"(m1) rank {rank} bf16 time mix vs plain: "
          f"{out['time_mix_vs_plain']:.4g}")
    del params
    torch.cuda.empty_cache()
    # -- the one-rank prefill and K4's heads, rank 0 alone ------------------
    SH.barrier()
    if rank == 0:
        held = torch.cuda.memory_allocated()
        full = draw()
        RW.prefill(cfg, full, tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one = [timed_ms(torch, lambda: RW.prefill(cfg, full, tokens))[1]
               for _ in range(2)]
        out["one_rank_peak_bytes"] = torch.cuda.max_memory_allocated() - held
        out["one_rank_prefill_ms"] = min(one)
        full_ops = k4_layer0_operands(torch, RW, cfg, full, tokens)
        o, S = WK.wkv(*full_ops, chunk=cfg.rwkv_chunk)
        bitwise = []
        for r in range(2):
            hs = slice(r * H // 2, (r + 1) * H // 2)
            half = [t[:, hs].contiguous() for t in full_ops[:4]] + \
                [full_ops[4][hs].contiguous(), None]
            o_r, S_r = WK.wkv(*half, chunk=cfg.rwkv_chunk)
            bitwise.append(bool(torch.equal(o_r, o[:, hs]))
                           and bool(torch.equal(S_r, S[:, hs])))
        check(all(bitwise), f"(m1) K4 on 20 heads vs the 40-head launch's "
                            f"same heads: bitwise {bitwise}")
        out["bitwise"] = bitwise
        hs = slice(0, H // 2)
        out["rank0_operands_vs_one_rank"] = max(
            rel_err(torch, a, b[:, hs]) for a, b in zip(ops[:4], full_ops[:4]))
        del full, full_ops, o, S
    SH.barrier()
    del ops
    calls.clear()
    torch.cuda.empty_cache()
    # -- f32 at 2 layers: the gathered logits against one rank --------------
    cfg32 = cfg.replace(n_layers=2, param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    p32 = materialize(RW.rwkv_model_specs(cfg32),
                      torch.Generator(device=dev).manual_seed(2))
    t32 = tokens[:, :256]
    pre32 = STEPS.make_prefill_step(cfg32, ShapeSuite("p", 256, B, "prefill"),
                                    dev, mesh=mesh)
    logits, cache = pre32.fn(SH.place_tree(p32, pre32.shardings["params"]),
                             {"tokens": t32})
    got = whole_leaf(SH, logits)
    if rank == 0:
        want, _ = RW.prefill(cfg32, p32, t32)
        out["f32_logits_rel"] = rel_err(torch, got, want)
        check(out["f32_logits_rel"] <= F32_REL,
              f"(m1) f32 sharded prefill vs one rank: {out['f32_logits_rel']:.3e}")
    del p32, logits, cache, got
    torch.cuda.empty_cache()
    rank_log(rank, f"(m1) rwkv6-3b prefill {B} x {T} on (1, 2), bf16: K4 "
             f"{out['launches']} launches on {out['heads']} of {H} heads, "
             f"{out['prefill_ms']:.2f} ms (runs {runs}), peak "
             f"{peak / 1e9:.3f} GB, collectives {colls}; K4 layer 0 vs plain "
             f"{err:.3e}; time mix vs plain {out['time_mix_vs_plain']:.4g}"
             + ("" if rank else
                f"; one rank: {out['one_rank_prefill_ms']:.2f} ms, peak "
                f"{out['one_rank_peak_bytes'] / 1e9:.3f} GB; K4 halves "
                f"bitwise {out['bitwise']}; f32 2-layer logits vs one rank "
                f"{out['f32_logits_rel']:.2e}"))
    return out


def lm_sharded_engine(torch, SH, mesh, rank, dev, arch="rwkv6-3b",
                      n_layers=2, tag="(m2)"):
    """(m2): `Engine(mesh=...)` on `arch` (rwkv6-3b) at full width,
    `n_layers` layers, f32: 4 prompts of 8 tokens, 16 greedy decodes each,
    the tokens against the one-rank Engine's (rank 0); ms an engine step;
    K1-K4 0 launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.module import materialize
    from repro_torch.runtime.serving import Engine, ServeConfig
    cfg = get_config(arch).replace(n_layers=n_layers,
                                   param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    params = materialize(get_model(cfg).specs(cfg),
                         torch.Generator(device=dev).manual_seed(4))
    rng = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (8,), generator=rng).tolist()
               for _ in range(4)]
    scfg = ServeConfig(batch_slots=4, max_seq=32)
    eng = Engine(cfg, scfg, params, mesh=mesh)
    eng.generate(prompts[:1], max_new=2)                  # warm
    eng = Engine(cfg, scfg, params, mesh=mesh)
    SH.barrier()
    SH.counts.clear()
    reset_counts()
    toks, ms = timed_ms(torch, lambda: eng.generate(prompts, max_new=16))
    check_counts(read_counts(), {}, f"{tag} rank {rank} Engine(mesh) {arch}")
    steps = 8 + 16 - 1
    out = {"ms_per_step": ms / steps, "collectives_per_step": {
        k: v / steps for k, v in SH.counts.items()}}
    check(all(len(t) == 16 for t in toks), f"{tag} tokens {toks}")
    SH.barrier()
    if rank == 0:
        one = Engine(cfg, scfg, params, device=dev)
        one.generate(prompts[:1], max_new=2)
        one = Engine(cfg, scfg, params, device=dev)
        want, one_ms = timed_ms(torch, lambda: one.generate(prompts,
                                                            max_new=16))
        check(toks == want, f"{tag} sharded Engine tokens {toks} vs one "
                            f"rank {want}")
        out["one_rank_ms_per_step"] = one_ms / steps
    SH.barrier()
    out["tokens_equal"] = True
    rank_log(rank, f"{tag} Engine(mesh) {arch} {n_layers} layers f32: 4 x 16 "
             f"greedy tokens, {out['ms_per_step']:.2f} ms an engine step, "
             f"collectives a step {out['collectives_per_step']}"
             + ("" if rank else f"; the one-rank Engine's tokens, "
                f"{out['one_rank_ms_per_step']:.2f} ms a step"))
    del params
    torch.cuda.empty_cache()
    return out


LM_SHARDED_TRAIN = (("rwkv6-3b", 2, 2e-4), ("gemma2-2b", 2, 1e-5),
                    ("qwen3-8b", 2, 1e-5))


def lm_sharded_train(torch, SH, mesh, rank, dev, arch, n_layers, prel, B=2,
                     S=256, tag="(m3)", enc_layers=None, spread=False):
    """(m3): `make_train_step(..., mesh=)` at full width and `n_layers` (an
    encoder's `enc_layers`), f32, sgdm (the update linear in the
    gradient), batch B x S (an encoder-decoder's with B x enc_seq frames
    of N(0, 0.02^2)): pure DP where the config asks for it and B divides
    the ranks (rwkv6-3b and gemma2-2b), TP over 'model' otherwise; 2
    steps, each timed with both ranks at once and its collectives and
    K1-K4 launches (0) counted; loss and grad norm (1e-5) and the gathered
    parameters (`prel` of each leaf's largest entry) against the one-rank
    step on rank 0; each rank's peak bytes beside the one-rank step's.
    With `spread`, the parameters' bound is the larger of `prel` and
    twice the one-rank step's own spread, measured in the same call: the
    one-rank step over the batch as 2 microbatches (its rows summed in
    another order) against the step over it whole, as phase 14 holds an
    ill-conditioned model's card against its CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import get_model
    from repro_torch.models.module import materialize
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaf_name, tree_flatten_with_path
    cut = {"n_layers": n_layers}
    if enc_layers is not None:
        cut["enc_layers"] = enc_layers
    cfg = get_config(arch).replace(param_dtype=torch.float32,
                                   compute_dtype=torch.float32, **cut)
    opt = make_optimizer("sgdm")
    rng = np.random.default_rng(6)
    batches = [{k: torch.from_numpy(rng.integers(lo, cfg.vocab_size, (B, S)))
                .to(dev) for k, lo in (("tokens", 0), ("labels", -1))}
               for _ in range(2)]
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(7)
        for b in batches:
            b["frames"] = 0.02 * torch.randn((B, cfg.enc_seq, cfg.d_model),
                                             generator=gen, device=dev)
    specs = get_model(cfg).specs(cfg)
    draw = lambda: materialize(specs, torch.Generator(device=dev).manual_seed(3))
    built = STEPS.make_train_step(cfg, opt, ShapeSuite("t", S, B, "train"),
                                  mesh=mesh)
    sh = built.shardings
    held = torch.cuda.memory_allocated()
    params = SH.place_tree(draw(), sh["params"])
    state = STEPS.init_opt_state(opt, params, sh["opt"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()      # the whole draw not counted
    metrics, ms, colls = [], [], []
    for i, b in enumerate(batches):
        SH.barrier()
        SH.counts.clear()
        reset_counts()
        (params, state, m), t = timed_ms(
            torch, lambda: built.fn(params, state, b, i))
        check_counts(read_counts(), {}, f"{tag} rank {rank} {arch} step {i}")
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        ms.append(t)
        colls.append(dict(SH.counts))
    peak = torch.cuda.max_memory_allocated() - held
    got = {p: whole_leaf(SH, x) for p, x in tree_flatten_with_path(params)}
    del params, state
    torch.cuda.empty_cache()
    out = {"pure_dp": sh["pure_dp"], "metrics": metrics, "step_ms": ms,
           "collectives": colls, "peak_bytes": peak}
    SH.barrier()
    if rank == 0:
        step = STEPS.make_train_step(cfg, opt)
        held = torch.cuda.memory_allocated()
        p1 = draw()
        s1, want, one_ms = opt.init(p1), [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches):
            (p1, s1, m), t = timed_ms(torch, lambda: step(p1, s1, b, i))
            want.append((float(m["loss"]), float(m["grad_norm"])))
            one_ms.append(t)
        out["one_rank_peak_bytes"] = torch.cuda.max_memory_allocated() - held
        out["one_rank_step_ms"] = one_ms
        for (gl, gn), (wl, wn) in zip(metrics, want):
            check(abs(gl - wl) <= F32_REL * abs(wl)
                  and abs(gn - wn) <= F32_REL * abs(wn),
                  f"{tag} {arch}: loss/grad norm {metrics} vs one rank {want}")
        errs = sorted(((rel_err(torch, got[p], x), leaf_name(p))
                       for p, x in tree_flatten_with_path(p1)), reverse=True)
        worst, bound = errs[0][0], prel
        del got, s1
        torch.cuda.empty_cache()
        if spread:
            step2 = STEPS.make_train_step(cfg.replace(n_microbatches=2), opt)
            p2 = draw()
            s2 = opt.init(p2)
            for i, b in enumerate(batches):
                p2, s2, _ = step2(p2, s2, b, i)
            out["one_rank_spread"] = max(
                rel_err(torch, a, x) for (_, x), (_, a) in zip(
                    tree_flatten_with_path(p1), tree_flatten_with_path(p2)))
            bound = max(prel, 2 * out["one_rank_spread"])
            del p2, s2
        check(worst <= bound, f"{tag} {arch}: params vs one rank {worst:.3e} "
                              f"(bound {bound:.3e}; worst leaves {errs[:3]})")
        out["params_rel"], out["params_bound"] = worst, bound
        out["worst_leaves"] = errs[:3]
        out["one_rank_metrics"] = want
        del p1
    else:
        del got
    torch.cuda.empty_cache()
    SH.barrier()
    rank_log(rank, f"{tag} {arch} full width, {n_layers} layers"
             f"{'' if enc_layers is None else f' (encoder {enc_layers})'}, "
             f"f32, batch {B} x {S}, "
             f"{'pure DP' if sh['pure_dp'] else 'TP over model'}: steps "
             f"{[f'{t:.1f}' for t in ms]} ms, peak {peak / 1e9:.3f} GB, "
             f"collectives a step {colls[-1]}"
             + ("" if rank else
                f"; one rank: steps {[f'{t:.1f}' for t in out['one_rank_step_ms']]}"
                f" ms, peak {out['one_rank_peak_bytes'] / 1e9:.3f} GB; "
                f"params vs one rank {out['params_rel']:.2e} (bound "
                f"{out['params_bound']:.2e}"
                + (f", the one-rank step's own spread "
                   f"{out['one_rank_spread']:.2e}" if spread else "")
                + f"; worst leaves {out['worst_leaves']})"))
    return out


def lm_sharded_rank(rank, world, out_dir):
    """One rank of phases 19 and 20: both ranks on card 0, in one gloo
    group for both phases (a group's start, two processes reaching the
    card, is paid once).  Each part's seconds by phase."""
    import torch
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    from repro_torch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2)
    res, parts, t0 = {}, {19: {}, 20: {}}, time.perf_counter()
    jobs = [("m1", lambda: lm_sharded_prefill(torch, SH, mesh, rank, dev)),
            ("m2", lambda: lm_sharded_engine(torch, SH, mesh, rank, dev))]
    jobs += [(f"m3 {a}", lambda a=a, n=n, p=p: lm_sharded_train(
        torch, SH, mesh, rank, dev, a, n, p)) for a, n, p in LM_SHARDED_TRAIN]
    jobs = [(19, name, fn) for name, fn in jobs]
    jobs += [(20, name, fn) for name, fn in
             families_sharded_jobs(torch, SH, mesh, rank, dev)]
    for phase, name, fn in jobs:
        res[name] = fn()
        parts[phase][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    res["seconds"] = parts
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m == "repro" or m.startswith("repro."))
    check(not res["jax_imported"], f"rank {rank} imported {res['jax_imported']}")
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def lm_sharded_phase(torch, job):
    """Phase 19 (module docstring): the two-rank group's run, which runs
    phase 20's parts too, then the ranks' results read back, and rank 0's
    (m1) peak held to the helper's reckoning of it (`job`,
    `reckon_sharded_main`; within PEAK_RECKON_REL).  Returns the ranks'
    results and K4's "sharded" entry of the kernels line."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_sharded_"))
    try:
        t0 = time.perf_counter()
        spawn(lm_sharded_rank, 2, str(root), timeout=LM_SHARDED_TIMEOUT)
        wall = time.perf_counter() - t0
        ranks = [json.loads((root / f"rank{r}.json").read_text())
                 for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    m1 = [r["m1"] for r in ranks]
    reck, waited = helper_result(job, "phase 19")
    peak = m1[0]["peak_bytes"]
    reck_rel = abs(peak - reck["peak_bytes"]) / peak
    log(f"(m1) rank 0's prefill peak {peak / 1e9:.4f} GB measured "
        f"(max_memory_allocated) against {reck['peak_bytes'] / 1e9:.4f} GB "
        f"reckoned on meta (its arguments {reck['argument_bytes']['total'] / 1e9:.4f} GB;"
        f" collectives {reck['collectives']}, result bytes "
        f"{reck['collectives_raw']}; FLOPs {reck['flops']:.4g}): "
        f"{100 * reck_rel:.2f} % apart (bound {100 * PEAK_RECKON_REL:.0f} %); "
        f"the helper took {reck['s']:.1f} s, phase 19 waited {waited:.1f} s")
    check(reck_rel <= PEAK_RECKON_REL,
          f"(m1) peak {peak} vs reckoned {reck['peak_bytes']}")
    parts = ranks[0]["seconds"]["19"]
    log(f"phases 19 and 20 group: {wall:.1f} s wall; phase 19's seconds by "
        "part (rank 0): " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    log("phase 19 json: " + json.dumps([{k: r[k] for k in parts}
                                         for r in ranks]))
    return ranks, {"launches_per_rank": [m["launches"] for m in m1],
            "heads_per_rank": m1[0]["heads"],
            "bitwise_vs_one_rank_heads": m1[0]["bitwise"],
            "max_abs_err": max(m["max_abs_err"] for m in m1),
            "prefill_ms": [m["prefill_ms"] for m in m1],
            "one_rank_prefill_ms": m1[0]["one_rank_prefill_ms"],
            "peak_bytes": [m["peak_bytes"] for m in m1],
            "reckoned_peak_bytes": reck["peak_bytes"],
            "peak_vs_reckoned": reck_rel,
            "one_rank_peak_bytes": m1[0]["one_rank_peak_bytes"],
            "f32_logits_rel": m1[0]["f32_logits_rel"],
            "engine_ms_per_step": ranks[0]["m2"]["ms_per_step"],
            "train": {a: {k: ranks[0][f"m3 {a}"][k] for k in
                          ("pure_dp", "step_ms", "peak_bytes",
                           "one_rank_step_ms", "one_rank_peak_bytes",
                           "params_rel")}
                      for a, _, _ in LM_SHARDED_TRAIN},
            "group_s": wall}


# ---------------------------------------------------------------------------
# phase 20: the MoE, RG-LRU and encoder-decoder families' sharded steps
# ---------------------------------------------------------------------------

def greedy_steps(torch, SH, dec, params, logits, cache, start, n):
    """n greedy decodes from `logits` (placed or plain) through `dec`: the
    whole logits of every step (the first is `logits`'), f32 on the card."""
    B = logits.shape[0]
    out = [whole_leaf(SH, logits).float()]
    for i in range(n):
        tok = out[-1].argmax(dim=-1)[:, None]
        pos = torch.full((B,), start + i, dtype=torch.long, device=tok.device)
        logits, cache = dec(params, tok, cache, pos)
        out.append(whole_leaf(SH, logits).float())
    return out


def logits_vs_one_rank(torch, got, want, tag):
    """Each step's gathered logits within 1e-5 of the largest one-rank
    logit, and the greedy tokens equal: (worst relative error, tokens)."""
    worst = max(rel_err(torch, g, w) for g, w in zip(got, want))
    toks = [g.argmax(-1).tolist() for g in got]
    check(worst <= F32_REL and toks == [w.argmax(-1).tolist() for w in want],
          f"{tag}: logits vs one rank {worst:.3e}, tokens equal "
          f"{toks == [w.argmax(-1).tolist() for w in want]}")
    return worst, toks


def fam_moe_prefill(torch, SH, mesh, rank, dev):
    """(n1) olmoe-1b-7b on (data 1, model 2) through
    `make_prefill_step(..., mesh=)`: bf16 at full width and depth, 4 x 512
    tokens (2,048 a rank, the shardmap form on its 32 of the 64 experts),
    its ms with both ranks at once (best of 2), each rank's peak bytes and
    the collectives beside the one-rank prefill's (rank 0, the other
    idle); f32 at 2 layers: the prefill and 8 greedy decodes (4 tokens a
    step, below one an expert: the global dispatch's fallback), the
    gathered logits within 1e-5 of the largest one-rank logit and the
    one-rank tokens.  K1-K4 0 launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TR
    from repro_torch.models.module import materialize
    cfg = get_config("olmoe-1b-7b")
    B, T, n = 4, 512, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    pre = STEPS.make_prefill_step(cfg, ShapeSuite("p", T, B, "prefill"), dev,
                                  mesh=mesh)
    draw = lambda: materialize(TR.decoder_specs(cfg),
                               torch.Generator(device=dev).manual_seed(0))
    held = torch.cuda.memory_allocated()
    params = SH.place_tree(draw(), pre.shardings["params"])
    torch.cuda.empty_cache()
    experts = tuple(SH.to_local(params["units"]["global"]["mlp"]["wi"]).shape)
    batch = {"tokens": tokens}
    runs = []
    for _ in range(2):
        SH.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        SH.counts.clear()
        (logits, cache), ms = timed_ms(torch, lambda: pre.fn(params, batch))
        check_counts(read_counts(), {}, f"(n1) rank {rank} prefill")
        colls = dict(SH.counts)
        runs.append(ms)
    peak = torch.cuda.max_memory_allocated() - held
    loc = SH.to_local(logits)
    check(tuple(loc.shape) == (B, cfg.vocab_size // 2)
          and bool(loc.isfinite().all()), f"(n1) logits {tuple(loc.shape)}")
    out = {"local_experts": experts, "prefill_ms": min(runs),
           "prefill_runs_ms": runs, "peak_bytes": peak, "collectives": colls}
    del params, logits, cache, loc
    torch.cuda.empty_cache()
    SH.barrier()
    if rank == 0:
        held = torch.cuda.memory_allocated()
        full = draw()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one = [timed_ms(torch, lambda: TR.prefill(cfg, full, tokens))[1]
               for _ in range(2)]
        out["one_rank_peak_bytes"] = torch.cuda.max_memory_allocated() - held
        out["one_rank_prefill_ms"] = min(one)
        del full
        torch.cuda.empty_cache()
    SH.barrier()
    # -- f32 at 2 layers: prefill, 8 greedy decodes, against one rank -------
    cfg32 = cfg.replace(n_layers=2, param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    p32 = materialize(TR.decoder_specs(cfg32),
                      torch.Generator(device=dev).manual_seed(2))
    shape = ShapeSuite("p", T + n, B, "prefill")
    pre32 = STEPS.make_prefill_step(cfg32, shape, dev, mesh=mesh)
    dec32 = STEPS.make_decode_step(cfg32, shape, dev, mesh=mesh)
    placed = SH.place_tree(p32, pre32.shardings["params"])
    reset_counts()
    lg, cache = pre32.fn(placed, batch)
    got = greedy_steps(torch, SH, dec32.fn, placed, lg, cache, T, n)
    check_counts(read_counts(), {}, f"(n1) rank {rank} f32 prefill + decodes")
    if rank == 0:
        lg, cache = TR.prefill(cfg32, p32, tokens, max_seq=T + n)
        want = greedy_steps(torch, SH, lambda p, t, c, q: TR.decode_step(
            cfg32, p, t, c, q), p32, lg, cache, T, n)
        out["f32_logits_rel"], _ = logits_vs_one_rank(
            torch, got, want, "(n1) olmoe 2 layers f32 prefill + 8 decodes")
    del p32, placed, lg, cache, got
    torch.cuda.empty_cache()
    SH.barrier()
    rank_log(rank, f"(n1) olmoe-1b-7b prefill {B} x {T} on (1, 2), bf16: "
             f"experts {experts} a rank, {out['prefill_ms']:.2f} ms (runs "
             f"{runs}), peak {peak / 1e9:.3f} GB, collectives {colls}"
             + ("" if rank else
                f"; one rank: {out['one_rank_prefill_ms']:.2f} ms, peak "
                f"{out['one_rank_peak_bytes'] / 1e9:.3f} GB; f32 2 layers, "
                f"prefill + {n} greedy decodes (the fallback) vs one rank "
                f"{out['f32_logits_rel']:.2e}, the same tokens"))
    return out


def fam_whisper_serve(torch, SH, mesh, rank, dev):
    """(n3) whisper-large-v3 at full width, 2 + 2 layers, f32, on (data 1,
    model 2): a prefill of 4 x 448 tokens with 4 x 1,500 frames and room
    for 8 decodes, then 8 greedy decodes, through `make_prefill_step` /
    `make_decode_step(..., mesh=)`; the cross K/V split along the encoder
    positions (750 a rank); the gathered logits within 1e-5 of the
    largest one-rank logit, the one-rank tokens (the port's own one-rank
    steps, which repair the reference's faults 10 and 11).  K1-K4 0."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as E
    from repro_torch.models.module import materialize
    cfg = get_config("whisper-large-v3").replace(
        n_layers=2, enc_layers=2, param_dtype=torch.float32,
        compute_dtype=torch.float32)
    B, T, n = 4, 448, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    frames = 0.02 * torch.randn((B, cfg.enc_seq, cfg.d_model), device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(3))
    params = materialize(E.encdec_specs(cfg),
                         torch.Generator(device=dev).manual_seed(5))
    shape = ShapeSuite("p", T + n, B, "prefill")
    pre = STEPS.make_prefill_step(cfg, shape, dev, mesh=mesh)
    dec = STEPS.make_decode_step(cfg, shape, dev, mesh=mesh)
    placed = SH.place_tree(params, pre.shardings["params"])
    SH.barrier()
    reset_counts()
    SH.counts.clear()
    (lg, cache), ms = timed_ms(torch, lambda: pre.fn(
        placed, {"tokens": tokens, "frames": frames}))
    colls = dict(SH.counts)
    cross = tuple(SH.to_local(cache["cross"]["k"]).shape)
    check(cross[2] == cfg.enc_seq // 2,
          f"(n3) rank {rank}: the cross K/V a rank {cross}")
    got = greedy_steps(torch, SH, dec.fn, placed, lg, cache, T, n)
    check_counts(read_counts(), {}, f"(n3) rank {rank} prefill + decodes")
    out = {"prefill_ms": ms, "cross_kv_local": cross, "collectives": colls}
    del lg, cache, placed
    if rank == 0:
        lg, cache = E.prefill(cfg, params, tokens, frames, max_seq=T + n)
        want = greedy_steps(torch, SH, lambda p, t, c, q: E.decode_step(
            cfg, p, t, c, q), params, lg, cache, T, n)
        out["logits_rel"], _ = logits_vs_one_rank(
            torch, got, want, "(n3) whisper 2 + 2 layers f32")
    del params, got
    torch.cuda.empty_cache()
    SH.barrier()
    rank_log(rank, f"(n3) whisper-large-v3 2 + 2 layers f32 on (1, 2): "
             f"prefill {B} x {T} with {B} x {cfg.enc_seq} frames "
             f"{ms:.1f} ms, cross K/V a rank {cross}, collectives {colls}"
             + ("" if rank else
                f"; prefill + {n} greedy decodes vs one rank "
                f"{out['logits_rel']:.2e}, the same tokens"))
    return out


def families_sharded_jobs(torch, SH, mesh, rank, dev):
    """Phase 20's parts, (name, fn) each, run by `lm_sharded_rank` in phase
    19's group."""
    return [
        ("n1 prefill", lambda: fam_moe_prefill(torch, SH, mesh, rank, dev)),
        ("n1 train", lambda: lm_sharded_train(
            torch, SH, mesh, rank, dev, "olmoe-1b-7b", 2, F32_REL,
            tag="(n1)")),
        ("n2 train", lambda: lm_sharded_train(
            torch, SH, mesh, rank, dev, "recurrentgemma-9b", 5, F32_REL,
            tag="(n2)", spread=True)),
        ("n2 engine", lambda: lm_sharded_engine(
            torch, SH, mesh, rank, dev, "recurrentgemma-9b", 5, "(n2)")),
        ("n3 serve", lambda: fam_whisper_serve(torch, SH, mesh, rank, dev)),
        ("n3 train dp", lambda: lm_sharded_train(
            torch, SH, mesh, rank, dev, "whisper-large-v3", 2, F32_REL, B=2,
            S=128, tag="(n3)", enc_layers=2)),
        ("n3 train tp", lambda: lm_sharded_train(
            torch, SH, mesh, rank, dev, "whisper-large-v3", 2, F32_REL, B=1,
            S=128, tag="(n3)", enc_layers=2))]


def families_sharded_phase(ranks) -> float:
    """Phase 20 (module docstring), run by phase 19's group: the ranks'
    results logged, and each train step's layout checked (pure DP for
    whisper at batch 2 only).  Returns its seconds (rank 0's parts)."""
    parts = ranks[0]["seconds"]["20"]
    log("phase 20 seconds by part (rank 0): "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    log("phase 20 json: " + json.dumps([{k: r[k] for k in parts}
                                         for r in ranks]))
    for name in ("n1 train", "n2 train", "n3 train dp", "n3 train tp"):
        r = ranks[0][name]
        check(r["pure_dp"] is (name == "n3 train dp"),
              f"phase 20 {name}: pure DP {r['pure_dp']}")
    return sum(parts.values())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    jobs = (start_reckoning(), start_reckoning("--reckon-sharded"))
    try:
        return run_phases(torch, *jobs)
    finally:
        for job in jobs:
            stop_reckoning(job)


def phase_time(n, what, t0) -> float:
    """Logs the seconds since t0 as phase n's ("phase{n} (what): s");
    returns the time now."""
    t = time.perf_counter()
    log(f"phase{n} ({what}): {t - t0:.1f} s")
    return t


def run_phases(torch, job, sharded_job):
    from repro_torch import checkpoint as CKP
    from repro_torch.core import bptt as BP, costs as CO, rtrl as RT
    from repro_torch.core import sparse_rtrl as SP, stacked_rtrl as ST
    from repro_torch.kernels import _build, compact as CK
    from repro_torch.kernels import compact_fused as CF, event_matmul as EM
    from repro_torch.kernels import influence as IN, ops as OPS, wkv as WK
    from repro_torch.launch import serve as SERVE, train as TRAIN
    from repro_torch.runtime import fleet as FL, online as ON

    # -- phase 1: device and build ------------------------------------------
    tp = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,serial", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    log(f"card (uuid, serial): {card}")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_s = _build.build()
    for k in _build.KERNELS:
        _build.load(k)
        log(f"built {k}: {_build.library_path(k).name}")
        for line in _build.build_log.get(k, "").splitlines():
            if "ptxas info" in line:
                log(f"  {line.strip()}")
    log(f"kernel build: {build_s:.2f} s (load {time.perf_counter() - t0:.2f} s)")

    # -- phase 2: K1 against its plain version ------------------------------
    main_ops = main_path_operands(torch, TRAIN, SP, ON, dev)
    B, K, Pc = main_ops[1].shape
    log(f"K1 (a) main path: B={B} n={main_ops[0].shape[-1]} K={K} "
        f"Pc_pad={Pc}, count_new {main_ops[6].tolist()}, "
        f"count_prev {main_ops[7].tolist()}")
    err_main = compare_k1(torch, CF, main_ops, "(a) f32")
    compare_k1(torch, CF, with_carry_dtype(torch, main_ops, torch.bfloat16),
               "(a) bf16")
    big = dict(B=4, K=256, n=256, Pc=20864, count_new=[256, 140, 96, 1],
               count_prev=[256, 100, 150, 60])
    big_ops = ragged_operands(torch, dev, seed=1, **big)
    compare_k1(torch, CF, big_ops, "(b) n=256 f32")
    big_bf16 = with_carry_dtype(torch, big_ops, torch.bfloat16)
    compare_k1(torch, CF, big_bf16, "(b) n=256 bf16")
    edge = ragged_operands(torch, dev, B=3, K=16, n=40, Pc=384,
                           count_new=[16, 1, 9], count_prev=[16, 7, 0],
                           seed=2)
    compare_k1(torch, CF, edge, "(c) edges f32")
    compare_k1(torch, CF, with_carry_dtype(torch, edge, torch.bfloat16),
               "(c) edges bf16")
    times = {"(a) f32": time_k1(torch, CF, CK, main_ops, 500, 100,
                                host=True),
             "(b) n=256 f32": time_k1(torch, CF, CK, big_ops, 20, 50),
             "(b) n=256 bf16": time_k1(torch, CF, CK, big_bf16, 20, 50)}
    for label, t in times.items():
        log(f"K1 time {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, baddbmm on pre-gathered tiles "
            f"(partial yardstick) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.0f} B, "
            f"{t['flops']:.0f} FLOP)")
        log(f"K1 in turn {label}: kernel {t['alt_ms']:.4f} ms, baddbmm "
            f"{t['alt_library_ms']:.4f} ms (median of 5 rounds)")
        log(f"K1 device {label}: kernel {t['device_us']} us, baddbmm "
            f"{t['library_device_us']} us (profiler, 20 calls)")
        if "host_us" in t:
            log(f"K1 host {label}: {fmt_path(t['host_us'])}")
    for label, ops in (("(a) f32", main_ops), ("(b) n=256 f32", big_ops),
                       ("(b) n=256 bf16", big_bf16)):
        log(f"K1 launch shape {label}: {k1_launch_shape(CF, ops)}")
    log("K1 times json: " + json.dumps(times))

    # -- phase 3: K2 against its plain version ------------------------------
    k2_full = k2_main_operands(torch, TRAIN, SP, ON, dev, "--col-compact", "off")
    k2_comp = k2_main_operands(torch, TRAIN, SP, ON, dev)
    _, k2_full_ops = compare_k2(torch, IN, OPS, k2_full, "(a) full width")
    err_k2, k2_comp_ops = compare_k2(torch, IN, OPS, k2_comp,
                                     "(a) column-compact")
    _, k2_big_ops = compare_k2(torch, IN, OPS, k2_synthetic(torch, dev),
                               "(b) n=256")
    edge_masked, edge_first = k2_edges(torch, dev)
    compare_k2(torch, IN, OPS, edge_masked, "(c) padded, dead example")
    compare_k2(torch, IN, OPS, edge_first, "(c) first step, no masks")
    k2_times = {"(a) full width": time_k2(torch, IN, k2_full_ops, 500, 100),
                "(a) column-compact": time_k2(torch, IN, k2_comp_ops, 500,
                                              100),
                # device-bound: its host path is the one timed at (a)
                "(b) n=256": time_k2(torch, IN, k2_big_ops, 20, 50,
                                     host=False)}
    del k2_big_ops
    for label, t in k2_times.items():
        log(f"K2 time {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, baddbmm {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.0f} B, "
            f"{t['flops']:.0f} FLOP)")
        log(f"K2 in turn {label}: kernel {t['alt_ms']:.4f} ms, baddbmm "
            f"{t['alt_library_ms']:.4f} ms (median of 5 rounds)")
        log(f"K2 device {label}: kernel {t['device_us']} us, baddbmm "
            f"{t['library_device_us']} us (profiler, 20 calls)")
        if "host_us" in t:
            log(f"K2 host {label}: {fmt_path(t['host_us'])}")
    log("launch floor: an empty kernel through the kernels' ctypes route, "
        f"{time_ms(torch, lambda: IN.empty_launch(dev), 2000):.5f} ms a call "
        "(time_ms)")
    log("K2 times json: " + json.dumps(k2_times))

    tp = phase_time("s 1-3", "device, build, K1 and K2", tp)

    # -- phase 4: the main paths --------------------------------------------
    runs, launches = {}, {}
    for backend in ("compact_fused", "pallas", "dense", "compact"):
        reset_counts()
        runs[backend] = TRAIN.main(main_argv(backend, "--ckpt-every", "0"))
        counts = read_counts()
        launches[backend] = (counts["compact_fused"], counts["influence"])
        out = runs[backend]
        steps = out["final_step"]
        log(f"main path {backend}: launches {counts} over {steps} stream "
            "steps")
        check(steps == 160, f"{backend}: {steps} stream steps, not 160")
        want = {"compact_fused": {"compact_fused": steps},
                "pallas": {"influence": steps}}.get(backend, {})
        check_counts(counts, want, f"main path {backend}")
        losses = [w["loss"] for w in out["windows"]]
        check(all(math.isfinite(v) for v in losses),
              f"{backend}: non-finite loss {losses}")
        check(out["summary"]["overflow"] == 0, f"{backend}: overflow")
    l_ref = runs["compact"]["windows"][0]["loss"]
    for backend, out in runs.items():
        l_b = out["windows"][0]["loss"]
        check(abs(l_b - l_ref) <= F32_REL * abs(l_ref),
              f"first window loss: {backend} {l_b} vs compact {l_ref}")
    firsts = {
        "compact_fused (cuda)": first_window_grads(torch, TRAIN, ON,
                                                   "compact_fused"),
        "pallas (cuda)": first_window_grads(torch, TRAIN, ON, "pallas"),
        "dense (cuda)": first_window_grads(torch, TRAIN, ON, "dense"),
        "pallas (cpu)": first_window_grads(torch, TRAIN, ON, "pallas",
                                           "--device", "cpu"),
        "compact (cpu)": first_window_grads(torch, TRAIN, ON, "compact",
                                            "--device", "cpu"),
        "BPTT oracle (cuda)": bptt_first_window(torch, TRAIN, BP, ST),
    }
    lc, gc = first_window_grads(torch, TRAIN, ON, "compact")
    for label, (lb, gb) in firsts.items():
        check(abs(lb - lc) <= F32_REL * abs(lc),
              f"first window loss {label} {lb} vs compact (cuda) {lc}")
        compare_grads(gb, gc, f"{label} vs compact (cuda)")
    for backend, out in runs.items():
        s = out["summary"]
        log(f"main path {backend}: first loss {s['first_loss']:.6f}, final "
            f"loss {s['final_loss']:.6f}, first window "
            f"{out['windows'][0]['loss']:.6f}, median window "
            f"{s['median_window_ms']:.3f} ms, carry {s['carry_bytes']} bytes")

    trace_main_path(torch, TRAIN, ON, "compact_fused", "fused_update_kernel")
    trace_main_path(torch, TRAIN, ON, "pallas", "influence_kernel")
    tp = phase_time(" 4", "the main paths", tp)

    # -- phase 5: checkpoint, restart and the offline path ------------------
    checkpoint_phase(torch, TRAIN, ON, CKP)
    tp = phase_time(" 5", "checkpoint, restart, offline", tp)

    # -- phase 6: K3 against its plain version, and its entry point ----------
    k3_entry = k3_checks(torch, dev, TRAIN, ON, EM, OPS)
    tp = phase_time(" 6", "K3", tp)

    # -- phase 7: RWKV6-3B serving with K4 ----------------------------------
    k4_entry, _ = rwkv_serving(torch, dev, WK)
    tp = phase_time(" 7", "RWKV6-3B serving", tp)

    # -- phase 8: the stacked engine, --layers 2 and 3 ----------------------
    stacked = stacked_phase(torch, TRAIN, ON, CKP, BP, RT, ST, SP, CF, CK, IN,
                            OPS, CO)
    tp = phase_time(" 8", "the stacked engine", tp)

    # -- phase 9: dynamic sparsity and the stream guard ---------------------
    rewire_entry, guard_entry, g2 = dynamic_phase(torch, TRAIN, ON, CKP, SP,
                                                  ST, CF, CK, IN, OPS)
    tp = phase_time(" 9", "dynamic sparsity and the guard", tp)

    # -- phase 10: the telemetry plane --------------------------------------
    telemetry = telemetry_phase(torch, TRAIN, ON, g2)
    tp = phase_time(" 10", "the telemetry plane", tp)

    # -- phase 11: the stream fleet -----------------------------------------
    fleet = fleet_phase(torch, SERVE, FL, ON, CF, IN, OPS, SP)
    phase_time(" 11", "the stream fleet", tp)

    # -- phase 12: the online token LM --------------------------------------
    t12 = time.perf_counter()
    lm = lm_phase(torch, TRAIN, ON, CKP, BP, SP, CF, CK, IN, OPS)
    log(f"phase 12 (the online token LM): {time.perf_counter() - t12:.1f} s")

    # -- phase 13: the dense decoders and LM training -----------------------
    t13 = time.perf_counter()
    decoder_phase(torch, dev)
    log(f"phase 13 (the dense decoders and LM training): "
        f"{time.perf_counter() - t13:.1f} s")

    # -- phase 14: the MoE decoders and the Griffin RG-LRU LM ---------------
    t14 = time.perf_counter()
    moe_rglru_phase(torch, dev)
    log(f"phase 14 (the MoE decoders and the RG-LRU LM): "
        f"{time.perf_counter() - t14:.1f} s")

    # -- phase 15: the scaled sparse-RTRL engine at n = 1024 ---------------
    t15 = time.perf_counter()
    scaled = scaled_phase(torch, dev, BP, SP, ST, CF, CK, ON, CO)
    log(f"phase 15 (the scaled engine): {time.perf_counter() - t15:.1f} s")

    # -- phase 16: whisper-large-v3 -----------------------------------------
    t16 = time.perf_counter()
    whisper_phase(torch, dev)
    log(f"phase 16 (whisper-large-v3): {time.perf_counter() - t16:.1f} s")

    # -- phase 17: the long-context cells at full size ---------------------
    t17 = time.perf_counter()
    k4_long = long_context_phase(torch, dev, WK, job)
    log(f"phase 17 (the long-context cells): {time.perf_counter() - t17:.1f} s")

    # -- phase 18: the sharded carry on two ranks of the card -------------
    t18 = time.perf_counter()
    sharded = sharded_phase(torch)
    log(f"phase 18 (the sharded carry, 2 ranks): "
        f"{time.perf_counter() - t18:.1f} s")

    # -- phases 19 and 20: the LM's sharded steps on two ranks of the card,
    # one group for both: phase 19 RWKV6 and the dense decoders, phase 20
    # the MoE decoders, the RG-LRU LM and the encoder-decoder
    t19 = time.perf_counter()
    ranks, lm_sharded = lm_sharded_phase(torch, sharded_job)
    s20 = families_sharded_phase(ranks)
    log(f"phase 19 (the LM's sharded steps, 2 ranks): "
        f"{time.perf_counter() - t19 - s20:.1f} s")
    phase_time(" 20", "the MoE, RG-LRU and encoder-decoder sharded steps, "
               "2 ranks", time.perf_counter() - s20)

    # -- phase 21: the kernels line and the result --------------------------
    t1, t2 = times["(a) f32"], k2_times["(a) column-compact"]
    kernels = [{"name": "compact_fused", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compact_fused.cu",
                "replaces": "src/repro/kernels/compact_fused.py:295",
                "launches": launches["compact_fused"][0],
                "max_abs_err": err_main,
                "ms": t1["ms"], "plain_ms": t1["plain_ms"],
                "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
                "library_ms": t1["library_ms"]},
               {"name": "influence", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/influence.cu",
                "replaces": "src/repro/kernels/influence.py:92",
                "launches": launches["pallas"][1],
                "max_abs_err": err_k2,
                "ms": t2["ms"], "plain_ms": t2["plain_ms"],
                "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
                "library_ms": t2["library_ms"]}]
    for entry in kernels:
        entry["stacked"] = stacked[entry["name"]]
    kernels[0]["guard"] = guard_entry
    kernels[1]["rewire"] = rewire_entry
    kernels[0]["telemetry"] = telemetry["compact_fused"]
    kernels[1]["telemetry"] = telemetry["influence"]
    kernels[0]["fleet"] = fleet["compact_fused"]
    kernels[1]["fleet"] = fleet["influence"]
    kernels[0]["lm"] = lm["compact_fused"]
    kernels[1]["lm"] = lm["influence"]
    kernels[0]["scaled"] = scaled
    kernels[0]["sharded"] = sharded
    k4_entry["long"] = k4_long
    k4_entry["sharded"] = lm_sharded
    kernels += [k3_entry, k4_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reckon"]:
        sys.exit(reckon_main(sys.argv[2]))
    if sys.argv[1:2] == ["--reckon-sharded"]:
        sys.exit(reckon_sharded_main(sys.argv[2]))
    sys.exit(main())
