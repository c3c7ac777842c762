#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mfas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. the device: nvidia-smi's name and power limit, SM clock and throttle
   reasons (card_state), torch and CUDA versions;
2. builds the input kernels (mfas_tpu_torch/csrc/input_kernels.cu) with nvcc;
3. K1 u8_normalize against its plain PyTorch version, bitwise, at
   (20,8,256,256,3) in f32 and bf16, and with the frame pick 24 -> 8;
4. K2 u8_gather_normalize against its plain version, bitwise, from a
   (50,24,256,256,3) store with B=20, T=8, in f32 and bf16; then K2 and K1
   launched from CUDA graph replays: the resident and the streamed batch
   preps each captured once (runtime/graphs.py::Step, the store passed
   through uncopied) and replayed on 3 new batches per dtype, every output
   bitwise its plain version, one launch counted per replay
   (replayed_preps);
5. times K1, K2, torch gather + K1 and the plain versions (median of CUDA
   event timings, L2 flushed between launches; under two timers, with and
   without a 1 ms spin of the card before each timed call, time_ms), f32
   and bf16; beside K1, its yardstick torch.addcmul(bias, x_u8, scale,
   out=...), the one PyTorch call that computes K1's function (the port
   never calls it), first checked against K1's plain version (f32 within
   1e-6 of its max |value|, bf16 within one bf16 ulp; library_err); prints
   the kernel rule's verdict, K1 against the call and each kernel's share
   of its bound; then the fused BatchNorm (bn_kernel_phase,
   ops/batchnorm.py, csrc/batchnorm.cu) against its plain version at the
   found net's channels-last layer1 and layer3 bn3 shapes (residual + ReLU)
   and AV-MNIST's 14x14 LeNet stage (ReLU), f32 and bf16, train mode,
   forward and backward, and its time beside the plain version's,
   F.batch_norm + add + ReLU's and the least time from bytes. Phases 7, 10
   and 12 (found-NTU training, the NTU searches, AV-MNIST's found training
   and search) check, run by run, that the BatchNorm kernels' launch counts
   are what a tally of the BatchNorm calls on the card gives, replays
   included (bn_path); phase 15's predicts that an artifact exported on the
   card runs them, once per recorded op node and batch;
6. the found-NTU --test_cp slice end to end at full width (ResNet-50 3-4-6-3
   at base width 64, HCN over 32 frames, found conf 4, random weights from a
   seed): a synthetic packed store at 256x256 (24 frames, 300 skeleton
   frames; train 40, dev 20, test 50 so the last test batch of 20 is
   ragged) and a torch.save'd checkpoint go through
   ``mfas_tpu_torch.main_found_ntu`` with --device_input_normalize (K1) and
   with --hbm_resident (K2), each twice (cold, then warm); each run must
   launch its kernel and print a finite Model Acc, and the two paths' fused
   logits must agree; the first two test clips are checked against the same
   net on the CPU;
7. found-NTU training at full width (the same net at the CLI's default
   --inner_representation_size 256, --batchsize 20, --random_backbones,
   --epochs 1, so phase 1 and phase 2 each run one epoch) on the same
   store: (a) --hbm_resident f32, writing a train state and a
   --save_checkpoint file; (b) --device_input_normalize f32; (c)
   --hbm_resident --bf16; (d) --hbm_resident --remat; (e) a resume of (a)'s
   state to --epochs 2 under --profile_dir, which must skip phase 1. Each
   run must print finite losses and Model Acc and launch its kernel exactly
   once per train, dev and test batch (bf16 output in (c)), from the
   engine's CUDA graphs: one train graph per phase and one eval graph per
   phase's dev split (and the resident test split's), replayed once per
   batch, --remat included (its segments' recomputation in the train
   graph); train clips/s and peak allocated memory are printed per phase;
8. steady-state train steps at full width, B=20, on the resident path:
   f32 phase 1 and phase 2, bf16 and remat phase 2, eager and graphed in one
   call (median of 5 after 2, remat 3 after 1, peak allocated and reserved
   memory, then 2 steps each under torch.profiler: device time per step by kernel class
   (convolution forward/dgrad/wgrad, elementwise, reductions, Adam, the
   input kernel, ...), busy share, kernels per step; K2 counted once per
   eager step and per replay; the graphed remat step's allocated peak,
   capture included, at most REMAT_PEAK_GIB);
   each graphed step then held to the eager one from the same state over
   two train steps and an eval step under cuDNN's deterministic algorithms
   (parameters, buffers, Adam state, losses, corrects, logits, generator):
   bitwise, or within twice the spread of two eager runs
   (graphed_vs_eager); the card's state after each mode;
9. one phase-2 train step at full width on 2 clips with --drpt 0, card
   against CPU: in f64 with --batchnorm, the loss within 1e-4 relative and
   every gradient and BatchNorm statistic within 1e-3 of its tensor's max;
   in f32, the loss within 1e-4 relative and the gradients no further from
   the CPU's f64 ones than the CPU's f32 ones are (card_vs_cpu says why),
   for the eager step and for the graphed one (a replay of the captured
   ``train_step``), both under cuDNN's default algorithms;
10. the NTU search at full width through ``mfas_tpu_torch.main_searchable_ntu``
   with the CLI's defaults (12 EPNAS steps, 197 candidates) on a store whose
   trainexp split is the train clips and whose dev split holds one clip of
   each class: (s1) default, (s2) --cache_features, (s3) a sequential
   --weightsharing step over 8 of its 32 rows, (s4) a search state written
   and resumed; each with
   K1's exact launch count and output dtype, the candidates trained, finite
   accuracies and the top-5, its wall time split into feature extraction,
   population steps, surrogate and sampler, and its CUDA graph captures
   and replays (every run replays the surrogate's fit and predict graphs;
   the bank runs (s2), (s4) replay the fused-epoch graphs once per epoch
   and phase; the streamed (s1) replays its features and train step once
   per train batch and its eval step once per dev batch; (s3)'s candidates
   replay the engine's) (search_phase); (s6) --cache_features --batchnorm
   --no_fused_epochs cut to one iteration of two steps, graphed and eager
   in one call: every accuracy and final parameter bitwise, one train and
   eval replay per batch (bank_per_step_search); the card's busy share
   over (s1)'s
   first two steps, from a trace (search_busy_share); then warm population
   train/eval steps and surrogate fit steps, timed and profiled apart,
   each both graphed and eager: the streamed per-batch steps eager and
   graphed (P=32, P=15) and held to each other (streamed_vs_eager), the
   graphed bank epoch, the bank's per-step train step (a gathered batch,
   then the step) eager and graphed, the eager fit epochs against the graphed fit, the
   streamed train-mode features at full width eager and graphed, held
   alike, one K1 launch per replay (search_step_times); (g) the graphs
   against eager calls of the same step functions (graphs_phase): (g1) a
   graphed 50-epoch surrogate fit on (s1)'s dataset and its predictions
   against the eager ones from the same state, (g2) two graphed bank
   epochs (P=32, B=20, a bf16 bank) against the eager program, both
   bitwise (else within 1e-6 of each tensor's max), and in float64 against
   the per-step loop (the same functional Adam) within 1e-9;
11. (s5) the search's device work, card against CPU: the extractor's taps
   on 2 clips in f32, eval mode and the streamed path's train mode, within
   1e-4 of each tensor's max, every backbone buffer unchanged; one
   population step (P=32, B=20, --batchnorm) in f64 within 1e-9 of each
   tensor's max;
12. the AV-MNIST vertical at full width (GP_LeNet_Deeper at --channels 32
   on 112x112 spectrograms, GP_LeNet on 28x28 digits, B=128) on synthetic
   stores written on the card (avmnist_phase): (v1) found conf 0 trained
   for one epoch per phase through ``mfas_tpu_torch.main_found_avmnist`` on
   55,000 train + 10,000 test samples with --save_checkpoint, whose
   --test_cp must print the same Model Acc (its engine's graphs: a train
   and an eval graph per phase), then warm phase-2 steps eager and graphed,
   timed and profiled, and held to each other (graphed_vs_eager); on 7,200
   train samples through
   ``mfas_tpu_torch.main_searchable_avmnist``: (v2) the EPNAS search at
   its defaults cut to one search iteration (75 candidates; the first
   step's accuracies not all equal, the best above 0.2), (v3)
   --cache_features, (v4) --randsearch written after
   its first iteration and resumed; (v5) the extractor's taps card against
   CPU in f32 (1e-4 of max, buffers unchanged) and one found phase-2 step in
   f64 (1e-3 of max). Neither input kernel may launch on this path;
13. the MM-IMDB vertical (mmimdb_phase) on a synthetic store in the
   reference layout written on the card (2,048 / 512 / 1,024 samples of
   256x160 posters and GloVe-like text): (m1) the default
   vggt_centralnet_v2 at full width (VGG-19, --channels 512,
   --text_first_hidden 256, B=64) trained one epoch through
   ``mfas_tpu_torch.main_found_mmimdb`` with --save_checkpoint (finite
   losses, dev F1 above the all-genres F1), whose --test_cp must print the
   same Model F1; (m2) --central_only, the non-central parameters as built
   and some central one moved;
   each run's engine replays its graphs (one train graph replayed per
   batch, one eval graph per split shape replayed per dev and test batch);
   (m3) warm whole-net and central steps eager and graphed in one call,
   timed and profiled, each graphed step held to the eager one under
   cuDNN's deterministic algorithms, and the loader's batch apart; (m6)
   the engine over a padded-sequence net (SimpleRecurrentModel and the
   poster) with text lengths 8 and 16 alternating: two train graphs alive
   on one set of gradients, the dead head without one, held to eager;
   (m4) the other four --model nets for one epoch;
   (m5) taps and heads card against CPU in f32 (1e-4 of max), a whole-net
   step in f64 (1e-3 of max; a gradient that vanishes on the CPU is named
   and must stay below 1e-12 of the largest on the card),
   SimpleRecurrentModel in f32 (1e-4). Neither
   input kernel may launch on this path;
14. the CIFAR vertical (cifar_phase) on cifar-10-batches-py stores written
   on the card (uint8 noise plus a colour per class): (c1) the found net at
   the CLI's defaults (fixed mode, --planes 36 doubling to 144, 8 cells,
   B=128, --drop_path 0.1 --drop_prob 0.2) trained one epoch through
   ``mfas_tpu_torch.main_found_cifar`` on 11,250 / 1,250 / 5,000 images
   with --use_intermediate --save_checkpoint (finite losses, Model Acc
   above 0.2; one train graph replayed per batch); (c2) its warm train
   steps eager and graphed, timed and profiled, the graphed step held to
   the eager one (DropPath and the zero-gradient skip inside the graph),
   and the loader's batch apart; (c5) the search- and fixed-mode nets card against
   CPU in f32 (1e-4 of max), a fixed-mode step in f64 (1e-3 of max, the
   parameters without a gradient as built), DropPath's kept share; (c3) a
   cut EPNAS search through ``mfas_tpu_torch.main_searchable_cifar`` (12
   of the 80 one-block rows + 4 whole-net candidates on 2,304 / 256
   images; each candidate captures its own train graph and replays it
   per batch), its state resumed after the first step to the
   uninterrupted run's confs and accuracies, and what a candidate's
   captures cost against the steps they save (cifar_capture_cost); (c4) a
   --weightsharing step whose store holds the last candidate's keys only.
   Neither input kernel may launch on this path;
15. NTU's default input paths and the serving loop (phase (i), on the
   stores the script already writes): (i1) the native host IO library
   (mfas_tpu_torch/data/native.py, g++ at first use) loaded, not its numpy
   fallback; its C++ skeleton parser against the numpy one on 40 files of
   300 frames and 2 persons, and gather_normalize_u8 at (20,24,256,256,3)
   against numpy within 1e-6, host clips/s of each; (i2) ``main_found_ntu
   --test_cp`` of the slice's checkpoint on the packed store normalized on
   the host (--no-multitask: Model Acc of the fused head), its fused logits
   within 1e-4 of their max of the K1 run's, 0 K1 launches; (i3) found
   training on it, one epoch per phase, train clips/s beside (b)'s; (i4)
   the NTU search at the CLI's defaults cut to one search iteration on
   (s1)'s store normalized on the host: 77 candidates, 0 K1 launches, the
   top-5; (i5) the raw-AVI
   --datadir, which without cv2 must stop in load_video naming cv2 and
   pack_ntu; (i6) for each vertical, ``mfas_tpu_torch.tools.export_model
   --polymorphic_batch --check`` of its found checkpoint (NTU (i2)'s, AV-
   MNIST (v1)'s, MM-IMDB (m1)'s, CIFAR (c1)'s) and ``mfas_tpu_torch.tools.
   predict`` over its test split (NTU's 50 clips, a ragged last batch):
   the printed top-1 (MM-IMDB: samples-F1) equal to the found CLI's test
   pass of the same checkpoint and output, the logits within 1e-4 of their
   max of that pass's, no input kernel launched; for NTU also --bf16: under
   0.75 of the f32 artifact's size, within 0.05 of max |logit| of it.
   Export seconds, artifact bytes and predict samples/s are printed;
16. the operator tools (phase (t), tools_phase): (t1)
   ``mfas_tpu_torch.tools.convert_torchvision`` as a subprocess on a
   full-width torchvision-layout ResNet-50 from a seed, center and mean
   inflation loaded strictly into ``inflated_resnet50`` on the card and
   checked bit for bit, the center net's 2-frame 224x224 clip against the
   single frame and against the CPU on every feature map (1e-4 of max),
   and vgg19_trunk into the MM-IMDB trunk; (t2)
   ``mfas_tpu_torch.tools.profile_step`` at its defaults (B=16, 256 px):
   found_train in f32 and --bf16 and visual_fwd, each one's ms/iter, busy
   ms/iter, kernels per iteration and classes; (t3)
   ``mfas_tpu_torch.tools.parity_kit --synthetic`` [READY] (exit 0), and
   [NOT READY] (exit 1) without checkpoints; (t4)
   ``mfas_tpu_torch.tools.search_report`` over (s4)'s search state and
   telemetry, listing the top-5 the search printed. Neither input kernel
   may launch on these paths;
17. multi-GPU data parallelism (phase (d), multi_gpu_phase; parallel/
   mesh.py). The card's machine has one H100 and NCCL refuses two ranks on
   one device, so: (d1) NCCL at world 1 through ``main_found_ntu``'s own
   --dist_coordinator/--dist_num_processes/--dist_process_id: the slice's
   --test_cp --hbm_resident with --use_dataparallel prints the plain run's
   Model Acc and logits bitwise, and all_reduce_grads, the synced
   BatchNorm (forward and backward) and gather_rows over the one-rank group
   equal their no-group versions bitwise; the steps captured as CUDA graphs
   over that NCCL group (d1_group_graphs; the CLIs' --use_dataparallel
   takes the one-rank group as its data group there): the full-width
   resident found net (conf 4, B=20, f32) over two train steps and an eval
   step, K2 inside, and MM-IMDB's padded-sequence net of (m6) at two text
   lengths, each graphed bitwise eager under cuDNN's deterministic
   algorithms and bitwise the same steps without a group; (d4)'s
   --cache_features --batchnorm --shard_feature_bank search, graphed
   (population_train_epoch replayed) and eager, its first step's confs
   and accuracies equal to the one-rank search's (d4_one, run before);
   and the same search streamed at one epoch (population_features and
   the streamed train and eval steps replayed), graphed, eager and
   without a group, equal; then two gloo ranks time-sharing
   the card (CUDA tensors staged through the host), each a subprocess: (d2)
   one warm phase-2 step of the full-width net (conf 4, B=20, 10 rows and
   one K2 launch per rank, --drpt 0) against the one-rank step, in float64
   under --remat (loss and statistics within 1e-12, every gradient within
   1e-9 of its tensor's max) and in float32 (loss and statistics within
   1e-5, the gradients against float64 no worse than one rank's: the f32
   step is ill-conditioned, rank_d2 says why), the ranks' parameters bitwise
   equal after each;
   (d3) ``main_found_ntu --use_dataparallel --hbm_resident
   --shard_resident_store`` one epoch per phase: the same Model Acc on both
   ranks, within 2 clips of 50 of (a)'s, K1 on each rank and K2 never, only
   rank 0's --save_checkpoint, which loads strictly; (d4)
   ``main_searchable_ntu --use_dataparallel --cache_features --batchnorm
   --shard_feature_bank`` cut to one search iteration on its own store with
   a class signal (write_d4_store, 4 classes): the same results on both
   ranks, the first-step confs and accuracies within 0.02 of the same
   search on one rank, at least 3 distinct first-step accuracies on each,
   and a resume from rank 0's state that agrees; (d5) the CIFAR found net with
   --drop_path 0.1, 3 steps at B=128: the ranks' parameters bitwise equal
   after each. Gloo runs its collectives on the host, so (d2)-(d5)
   capture nothing (their GRAPH_COUNTS stay empty). No rate of (d2)-(d5)
   is a scaling figure;
18. the rest of the NTU vertical (phase (n), ntu_rest_phase): (n1) each
   layout option of core/functional.py (conv_channels_last, conv3d_as_2d,
   conv1x1_as_matmul, pool_as_slices, pool_separable) at ResNet-50's layer
   shapes (B=2, 8 frames, 256 px) against the default, values and input
   gradients, within 1e-10 of max in float64 and 1e-4 in float32, each
   option's formulation seen to run (the pool on tie-free inputs); (n2)
   ``main_found_ntu --conv_channels_last --hbm_resident`` one epoch per
   phase on (a)'s store: 9 K2 launches, Model Acc within 2 clips of 50 of
   (a)'s; then warm phase-2 steps at B=20 in f32 and --bf16, NCDHW and
   channels-last in turns (plain, chlast, chlast, plain) with peak memory;
   (n3) ``mfas_tpu_torch.tools.bf16_sweep`` on five variants, each
   variant's formulation seen to run and its first-step loss within 1e-4
   (f32) / 5e-3 (bf16) relative of its precision's default; (n4)
   LateFusion, GMU and CentralNet at full width (ResNet-50 + HCN): eval
   forwards at B=20, 8 frames, 256 px on K1-normalized clips (CentralNet
   also at 224 px, where it downsamples the skeleton maps 32->28, 16->14),
   clips/s and peak memory; each card against the CPU in float64 at B=1, 2
   frames, 224 px: the forward within 1e-9 of max, one train step's
   gradients within 1e-6 of each tensor's max (CentralNet's central
   column; its unused and analytically vanishing tensors named);
19. the port's benchmark (phase (bench), bench_phase): ``python3 -m
   mfas_tpu_torch.bench`` in the lean profile, a process of its own with
   MFAS_BENCH_BUDGET_S=360 (killed after 480 s) and its sidecar in the work
   directory (so it carries nothing forward): the per-step proxy at full
   width (B=16, 256 px, K=15; the found net's train step and inference in
   f32 and bf16, its FLOPs and MFU), the tiny EPNAS search wall-clock
   (streamed and --cache_features, K1), the found net fed from the packed
   store (K1) and the resident store (K2, f32 and bf16) and the host
   gather + normalize.
   It must exit 0 with a record after each of its three sections, no
   errors and no partial last record, the card's name as device_kind, a
   finite positive headline and proxy, K1 and never K2 in the search,
   streamed and step-only paths, K2 and never K1 in the resident ones.

mfas_tpu_torch/scripts/archive_smoke.sh runs this script from a git archive
of the tree and alone in an empty directory.

TF32 is off throughout. Any failed check exits non-zero. Before the last
lines come {"slice": ...}, {"training": ...}, {"search": ...},
{"avmnist": ...}, {"mmimdb": ...}, {"cifar": ...}, {"serving": ...},
{"tools": ...}, {"multi_gpu": ...}, {"ntu_rest": ...} and {"bench": ...}
(the bench's last record line, launches and figures) with the measured
numbers; then {"kernels": [...]} with
each kernel's launches on the main paths, time, plain version's time and
bound; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.
"""

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
K1_SHAPE = (20, 8, 256, 256, 3)
K1_PICK_SHAPE = (20, 24, 256, 256, 3)
K2_STORE = (50, 24, 256, 256, 3)
SEED = 0


class SmokeFailure(Exception):
    pass


def free_card(torch):
    """Collect garbage, then hand the card's cached blocks back: a
    reference cycle (torch keeps the frames of its optimizers' first calls
    in a process until a collection) can hold an engine, and so its CUDA
    graphs' memory pool, after its run."""
    gc.collect()
    torch.cuda.empty_cache()


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


_T0 = time.time()


def phase(name):
    """Print the phase's name and the script's seconds so far."""
    print(f"== {name} (at {time.time() - _T0:.0f} s)", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


CARD_STATE = ("clocks.sm,clocks.max.sm,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")


def card_state(when):
    """nvidia-smi's SM clock, its maximum, temperature, power draw and
    throttle reasons, printed and returned: compute-bound times scale with
    the SM clock, so a time read on a throttled card says so beside it. A
    failed query is reported, not fatal."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_STATE}",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    line = (r.stdout.strip().splitlines() or [""])[0] if r.returncode == 0 \
        else f"nvidia-smi failed: {r.stderr.strip()[:200]}"
    print(f"card state {when} ({CARD_STATE}): {line}", flush=True)
    return line


# the kernel timer: median of TIME_ITERS CUDA-event timings after
# TIME_WARMUP calls; SPIN_CYCLES SM cycles are 1 ms at 1980 MHz
TIME_ITERS, TIME_WARMUP = 25, 3
SPIN_CYCLES = 2_000_000
TIMERS = ("flush", "spin")


def time_ms(torch, fn, timer):
    """Median device time of fn() from CUDA events. Before each timed call a
    256 MB read evicts the 50 MB L2 (the inputs are not cached) and leaves no
    dirty line whose write-back would land inside the timed call. Under the
    "spin" timer a spin of SPIN_CYCLES then keeps the card busy while the
    host enqueues the start event and fn's launches, so the host's launch
    latency is not timed (the 256 MB read alone, ~0.1 ms, does not cover a
    wrapper of several launches on a slow host). A host synchronize inside
    fn is timed under both."""
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(TIME_WARMUP):
        fn()
    times = []
    for _ in range(TIME_ITERS):
        flush.max()
        if timer == "spin":
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bitwise(torch, got, want, what):
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"{what}: not bitwise equal to the plain "
          f"version (max abs err {err})")
    print(f"{what}: bitwise equal to the plain version")
    return err


def kernel_phases(torch, tk):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = {"u8_normalize": 0.0, "u8_gather_normalize": 0.0}

    phase("K1 u8_normalize vs plain")
    x = torch.randint(0, 256, K1_SHAPE, dtype=torch.uint8, device=dev,
                      generator=g)
    for dt in (torch.float32, torch.bfloat16):
        e = bitwise(torch, tk.u8_normalize(x, MEAN, STD, out_dtype=dt),
                    tk.u8_normalize_plain(x, MEAN, STD, out_dtype=dt),
                    f"K1 {tuple(K1_SHAPE)} {dt}")
        err["u8_normalize"] = max(err["u8_normalize"], e)
    xp = torch.randint(0, 256, K1_PICK_SHAPE, dtype=torch.uint8, device=dev,
                       generator=g)
    pick = tk.linspace_frame_indices(K1_PICK_SHAPE[1], 8)
    for dt in (torch.float32, torch.bfloat16):
        e = bitwise(torch, tk.u8_normalize(xp, MEAN, STD, pick, out_dtype=dt),
                    tk.u8_normalize_plain(xp, MEAN, STD, pick, out_dtype=dt),
                    f"K1 pick {tuple(K1_PICK_SHAPE)}->T'=8 {dt}")
        err["u8_normalize"] = max(err["u8_normalize"], e)
    del xp

    phase("K2 u8_gather_normalize vs plain")
    store = torch.randint(0, 256, K2_STORE, dtype=torch.uint8, device=dev,
                          generator=g)
    B, T = K1_SHAPE[:2]
    sidx = torch.randint(0, K2_STORE[0], (B,), device=dev, generator=g)
    fidx = torch.randint(0, K2_STORE[1], (B, T), device=dev, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        e = bitwise(torch,
                    tk.u8_gather_normalize(store, sidx, fidx, MEAN, STD, dt),
                    tk.u8_gather_normalize_plain(store, sidx, fidx, MEAN, STD,
                                                 dt),
                    f"K2 store {tuple(K2_STORE)} B={B} T={T} {dt}")
        err["u8_gather_normalize"] = max(err["u8_gather_normalize"], e)

    err["replayed"] = replayed_preps(torch, tk, store, g)

    phase("K1's yardstick torch.addcmul vs plain")
    scale, bias = tk._device_affine(MEAN, STD, x.device)
    lib = {dt: torch.empty(x.shape, dtype=dt, device=dev)
           for dt in (torch.float32, torch.bfloat16)}
    err["u8_normalize_library"] = {
        str(dt)[6:]: library_err(torch, torch.addcmul(bias, x, scale,
                                                      out=y),
                                 tk.u8_normalize_plain(x, MEAN, STD,
                                                       out_dtype=dt))
        for dt, y in lib.items()}

    phase("kernel times")
    n = B * T * K1_SHAPE[2] * K1_SHAPE[3] * K1_SHAPE[4]
    ms = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        moved = n * (1 + dt.itemsize)   # uint8 read + output written
        y = lib[dt]
        fns = {
            "K1": lambda: tk.u8_normalize(x, MEAN, STD, out_dtype=dt),
            "K1_library": lambda: torch.addcmul(bias, x, scale, out=y),
            "K1_plain": lambda: tk.u8_normalize_plain(x, MEAN, STD,
                                                      out_dtype=dt),
            "K1_plain_copying": lambda: plain_copying(torch, tk, x, dt),
            "K2": lambda: tk.u8_gather_normalize(store, sidx, fidx, MEAN,
                                                 STD, dt),
            "gather_K1": lambda: tk.u8_normalize(
                store[sidx[:, None], fidx], MEAN, STD, out_dtype=dt),
            "K2_plain": lambda: tk.u8_gather_normalize_plain(
                store, sidx, fidx, MEAN, STD, dt),
        }
        ms[name] = t = {k: {tm: time_ms(torch, fn, tm) for tm in TIMERS}
                        for k, fn in fns.items()}
        for k, v in t.items():
            print(f"{name} {k}: " + ", ".join(
                f"{v[tm] * 1e3:.1f} us ({moved / v[tm] / 1e6:.1f} GB/s) "
                f"under the {tm} timer" for tm in TIMERS))
        t["bound"] = input_kernel_bound_ms(dt.itemsize)
        print(f"{name} bound: {t['bound'] * 1e3:.1f} us ({moved / 1e6:.0f} MB "
              f"at 3.35 TB/s); K1 at "
              f"{100 * t['bound'] / t['K1']['spin']:.0f} %, K2 at "
              f"{100 * t['bound'] / t['K2']['spin']:.0f} % of it (spin timer)")
    print("kernel_times_ms " + json.dumps(ms))
    card_state("after kernel times")
    return err, ms


# the fused BatchNorm's cases: (shape, channels-last, residual), the found
# NTU net's layer1 and layer3 bn3 at B=20, 8 frames of 256 px, and
# AV-MNIST's 14x14 LeNet stage at B=128; its epilogue is ReLU throughout
BN_CASES = {"r50_l1_bn3": ((20, 256, 8, 64, 64), True, True),
            "r50_l3_bn3": ((20, 1024, 8, 16, 16), True, True),
            "lenet_14": ((128, 64, 14, 14), False, False)}
# the forward's error against float64 may exceed the plain version's by
# half again and this much of the largest magnitude (a bf16 ulp at 1,
# f32's rounding); the backward's lies within BN_TOL_BWD of float64's
BN_FLOOR_FWD = {"f32": 1e-6, "bf16": 2.0 ** -8}
BN_TOL_BWD = {"f32": 1e-4, "bf16": 2e-2}


def _bn_rel(a, ref):
    ref = ref.double()
    return float((a.double() - ref).abs().max() / ref.abs().max())


def bn_kernel_phase(torch, tbn):
    """The fused BatchNorm (ops/batchnorm.py::batch_norm) against its plain
    version on the card at BN_CASES, f32 and bf16, train mode, forward and
    backward: the output no further from float64's than the plain
    version's, give or take rounding (BN_FLOOR_FWD); the running
    statistics within 1e-5 of the plain version's; dx, dweight and dbias
    within BN_TOL_BWD of the float64 closed form under the kernels' own
    ReLU mask and rounded statistics; the residual's gradient exactly dy
    where the output is positive; one launch of each kernel. Then each
    case's time, forward + backward, under the spin timer: the kernels,
    the plain version and torch.nn.functional.batch_norm + add + ReLU (the
    library's yardstick, called nowhere in the port), beside the least
    time from bytes at 3.35 TB/s (x, residual and y forward; dy, x, y, dx
    and the residual's gradient backward). -> (errors, times) by
    "<case>.<dtype>"."""
    phase("fused BatchNorm vs plain")
    dev = torch.device("cuda")
    errs, times = {}, {}
    for case, (shape, cl, with_res) in BN_CASES.items():
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            g = torch.Generator(device=dev).manual_seed(SEED)
            C = shape[1]
            cshape = [1, C] + [1] * (len(shape) - 2)
            fmt = torch.contiguous_format
            if cl:
                fmt = (torch.channels_last_3d if len(shape) == 5
                       else torch.channels_last)
            scale = torch.rand(cshape, generator=g, device=dev) * 2 + 0.25
            off = torch.randn(cshape, generator=g, device=dev)
            x, res, dy = (t.to(dt).contiguous(memory_format=fmt) for t in (
                torch.randn(shape, generator=g, device=dev) * scale + off,
                torch.randn(shape, generator=g, device=dev),
                torch.randn(shape, generator=g, device=dev)))
            if not with_res:
                res = None
            w = torch.rand(C, generator=g, device=dev) + 0.5
            b = torch.randn(C, generator=g, device=dev) * 0.1

            def state(dtype):
                return [torch.zeros(C, dtype=dtype, device=dev),
                        torch.ones(C, dtype=dtype, device=dev),
                        torch.zeros((), dtype=torch.long, device=dev)]

            def leaves(xs, ws, bs, rs):
                return [t.detach().clone().requires_grad_()
                        for t in (xs, ws, bs, rs) if t is not None]

            def call(fn, ls, st, rs):
                return fn(ls[0], ls[1], ls[2], *st, training=True,
                          momentum=0.1, eps=1e-5,
                          residual=ls[3] if rs is not None else None,
                          relu=True)

            def run(fn, xs, ws, bs, rs, dys, st):
                ls = leaves(xs, ws, bs, rs)
                y = call(fn, ls, st, rs)
                return y.detach(), torch.autograd.grad(y, ls, dys)

            what = f"BN {case} {tuple(shape)} {name}"
            tbn.reset_launch_counts()
            sk = state(torch.float32)
            yk, gk = run(tbn.batch_norm, x, w, b, res, dy, sk)
            torch.cuda.synchronize()
            check(tbn.launch_counts == {k: 1 for k in tbn.launch_counts},
                  f"{what}: launches {tbn.launch_counts}")
            sp = state(torch.float32)
            yp, _ = run(tbn.batch_norm_plain, x, w, b, res, dy, sp)
            s64 = state(torch.float64)
            y64, _ = run(tbn.batch_norm_plain, x.double(), w.double(),
                         b.double(), None if res is None else res.double(),
                         dy.double(), s64)
            e_fwd, e_plain = _bn_rel(yk, y64), _bn_rel(yp, y64)
            check(e_fwd <= 1.5 * e_plain + BN_FLOOR_FWD[name],
                  f"{what}: forward {e_fwd:.3e} from float64, the plain "
                  f"version {e_plain:.3e}")
            e_run = max(_bn_rel(a, c) for a, c in zip(sk[:2], sp[:2]))
            check(e_run <= 1e-5 and int(sk[2]) == int(sp[2]) == 1,
                  f"{what}: running statistics {e_run:.3e} from the plain "
                  "version's")
            del y64, yp
            x64 = x.double()
            mean, var, n, clamped = tbn.batch_statistics_plain(x64)
            mean = mean.to(dt).double()
            inv = torch.rsqrt(var.to(dt).double() + 1e-5).to(dt).double()
            want = tbn.batch_norm_backward_plain(
                dy.double(), x64, yk.double(), mean, inv,
                w.to(dt).double(), n, clamped, training=True, relu=True)
            e_bwd = max(_bn_rel(a, c) for a, c in zip(gk[:3], want[:3]))
            check(e_bwd <= BN_TOL_BWD[name],
                  f"{what}: dx, dweight, dbias {e_bwd:.3e} from float64")
            if with_res:
                check(torch.equal(gk[3], torch.where(
                    yk <= 0, torch.zeros_like(dy), dy)),
                      f"{what}: the residual's gradient is not dy masked "
                      "by the output")
            del x64, want, gk, yk
            free_card(torch)
            errs[f"{case}.{name}"] = {"fwd": e_fwd, "plain_fwd": e_plain,
                                      "running_stats": e_run, "bwd": e_bwd}

            def library(xs, ws, bs, rm, rv, nbt, *, training, momentum, eps,
                        residual, relu):
                y = torch.nn.functional.batch_norm(xs, rm, rv, ws, bs,
                                                   training, momentum, eps)
                return torch.relu(y if residual is None else y + residual)

            ls = leaves(x, w, b, res)
            st = state(torch.float32)
            t = {}
            for key, fn in (("ms", tbn.batch_norm),
                            ("plain_ms", tbn.batch_norm_plain),
                            ("library_ms", library)):
                t[key] = time_ms(torch, lambda fn=fn: torch.autograd.grad(
                    call(fn, ls, st, res), ls, dy), "spin")
            moved = (8 if with_res else 6) * x.numel() * x.element_size()
            t["bound_ms"] = moved / 3.35e12 * 1e3
            times[f"{case}.{name}"] = t
            print(f"{what}: forward {e_fwd:.2e} from float64 (plain "
                  f"{e_plain:.2e}), backward {e_bwd:.2e}; forward + "
                  f"backward {t['ms'] * 1e3:.1f} us, plain "
                  f"{t['plain_ms'] * 1e3:.1f} us, F.batch_norm + add + "
                  f"ReLU {t['library_ms'] * 1e3:.1f} us, bound "
                  f"{t['bound_ms'] * 1e3:.1f} us (spin timer)", flush=True)
            del x, res, dy, ls, st
            free_card(torch)
    print("bn_times_ms " + json.dumps(times))
    return errs, times


def _tally_batchnorms():
    """Wrap ``_BatchNorm.forward`` so that each call on a card tensor is
    tallied: "train" and "eval" forwards (counted before the call, as a
    recomputation that stops early stops after the kernels), and
    "backward" (a hook on the output's gradient), with "backward_dx" where
    x or the residual takes a gradient. A replay counter, as
    _tally_out_dtypes's tally is. Returns the tally and a function that
    puts the forward back."""
    from mfas_tpu_torch.core.layers import _BatchNorm
    from mfas_tpu_torch.runtime import graphs

    calls = {}
    graphs.count_replays(calls)
    orig = _BatchNorm.forward

    def add(key):
        calls[key] = calls.get(key, 0) + 1

    def forward(self, x, residual=None, relu=False):
        if x.is_cuda:
            add("train" if self.training else "eval")
        y = orig(self, x, residual=residual, relu=relu)
        if x.is_cuda and y.requires_grad:
            dx = x.requires_grad or (residual is not None
                                     and residual.requires_grad)

            def hook(grad):
                add("backward")
                if dx:
                    add("backward_dx")

            y.register_hook(hook)
        return y

    _BatchNorm.forward = forward

    def unwrap():
        graphs.uncount_replays(calls)
        _BatchNorm.forward = orig

    return calls, unwrap


# the BatchNorm kernels' launches on each path bn_path checked
BN_PATHS = {}


@contextlib.contextmanager
def bn_path(torch, name):
    """Around one run of a main path: the BatchNorm kernels' launch counts
    zeroed before and read after, held to the tally of the BatchNorm calls
    on the card (_tally_batchnorms): stats once per train-mode call,
    finalize and apply once per call, grad_stats and grad_finalize once
    per backward, grad_input once per backward into x or the residual; and
    at least one call. Recorded in BN_PATHS[name]."""
    from mfas_tpu_torch.ops import batchnorm as tbn

    tally, unwrap = _tally_batchnorms()
    tbn.reset_launch_counts()
    try:
        yield
        torch.cuda.synchronize()
        counts, calls = dict(tbn.launch_counts), dict(tally)
    finally:
        unwrap()
    forwards = calls.get("train", 0) + calls.get("eval", 0)
    want = {"stats": calls.get("train", 0), "finalize": forwards,
            "apply": forwards, "grad_stats": calls.get("backward", 0),
            "grad_finalize": calls.get("backward", 0),
            "grad_input": calls.get("backward_dx", 0)}
    check(counts == want and forwards > 0,
          f"{name}: BatchNorm kernel launches {counts}, want {want} from "
          f"the BatchNorm calls on the card {calls}")
    print(f"{name}: BatchNorm kernel launches {counts}, one per call "
          f"{calls}", flush=True)
    BN_PATHS[name] = counts


REPLAYED_BATCHES = 3


def replayed_preps(torch, tk, store, g):
    """K2 and K1 launched from CUDA graph replays: the resident batch prep
    (data/resident.py::make_resident_prep, K2, the store passed through
    uncopied) and the streamed inputs prep (data/ntu_pack.py::
    make_device_normalize_inputs_prep, K1), each captured once
    (runtime/graphs.py::Step) and replayed on REPLAYED_BATCHES new batches
    at (20,8,256,256,3) in f32 and bf16: every output bitwise its plain
    version, one launch counted per replay. Returns the max abs error."""
    from mfas_tpu_torch.data.ntu_pack import make_device_normalize_inputs_prep
    from mfas_tpu_torch.data.resident import make_resident_prep
    from mfas_tpu_torch.engine.classifier import RESIDENT_KEYS
    from mfas_tpu_torch.runtime import graphs

    phase("K1 and K2 inside captured preps, replayed on new batches")
    dev = store.device
    B, T = K1_SHAPE[:2]
    graphs.reset_graph_counts()
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        resident = make_resident_prep(fuse_gather=True, compute_dtype=dt)
        streamed = make_device_normalize_inputs_prep(dt)
        k2 = graphs.Step("resident_prep",
                         lambda b: (resident(b)["rgb"],),
                         resident=RESIDENT_KEYS)
        k1 = graphs.Step("streamed_prep", lambda b: streamed((b["rgb"],)))
        tk.reset_launch_counts()
        for i in range(REPLAYED_BATCHES):
            sidx = torch.randint(0, K2_STORE[0], (B,), device=dev,
                                 generator=g)
            fidx = torch.randint(0, K2_STORE[1], (B, T), device=dev,
                                 generator=g)
            (got,) = k2({"_idx": sidx, "rgb_t": fidx, "_rgb_store": store})
            err = max(err, bitwise(
                torch, got, tk.u8_gather_normalize_plain(
                    store, sidx, fidx, MEAN, STD, dt),
                f"K2 replay {i} {dt}"))
            x = torch.randint(0, 256, K1_SHAPE, dtype=torch.uint8,
                              device=dev, generator=g)
            (got,) = k1({"rgb": x})
            err = max(err, bitwise(
                torch, got, tk.u8_normalize_plain(x, MEAN, STD,
                                                  out_dtype=dt),
                f"K1 replay {i} {dt}"))
        want = {"u8_normalize": REPLAYED_BATCHES,
                "u8_gather_normalize": REPLAYED_BATCHES}
        check(tk.launch_counts == want,
              f"replayed preps {dt}: launches {tk.launch_counts}, want "
              f"{want}")
    want = {"captures": 2, "replays": 2 * REPLAYED_BATCHES}
    counts = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    check(counts == {"resident_prep": want, "streamed_prep": want},
          f"replayed preps: graph counts {counts}")
    print(f"K1 and K2 replayed from captured preps on {REPLAYED_BATCHES} new "
          f"batches per dtype: bitwise their plain versions, one launch per "
          f"replay; graph counts {counts}", flush=True)
    return err


def library_err(torch, got, want):
    """torch.addcmul's output against K1's plain version, checked to be the
    same function before it is timed as K1's yardstick: f32 within 1e-6 of
    the plain output's max |value| (the call may contract the affine into
    one FMA, which rounds once where the plain version rounds twice), bf16
    within one bf16 ulp of the plain output at every element. Returns the
    max abs error."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"addcmul: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    w = want.float()
    diff = (got.float() - w).abs()
    err = diff.max().item()
    if want.dtype == torch.float32:
        limit = 1e-6 * w.abs().max().item()
        ok = err <= limit
    else:
        # |w| in [2^(e-1), 2^e): bf16's 8 significant bits, ulp 2^(e-8)
        limit = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        ok = bool((diff <= limit).all())
    check(ok, f"addcmul {want.dtype}: max abs err {err} from the plain "
          "version, beyond the yardstick's tolerance: it computes another "
          "function")
    print(f"K1 yardstick torch.addcmul {tuple(got.shape)} {want.dtype}: max "
          f"abs err {err} from the plain version (f32: within 1e-6 of its "
          f"max |value|; bf16: within one bf16 ulp)")
    return err


def plain_copying(torch, tk, x, dt):
    """K1's plain version with its scale and bias copied to the card on
    every call, as it was before ops/input_kernels.py::_device_affine kept
    them there: each copy synchronizes the host with the card inside the
    timed call."""
    scale, bias = tk._affine_from_stats(MEAN, STD)
    return (x.float() * torch.as_tensor(scale, device=x.device)
            + torch.as_tensor(bias, device=x.device)).to(dt)


SPLITS = (("train", 40), ("dev", 20), ("test", 50))


def write_store(work):
    from mfas_tpu_torch.data.ntu_pack import make_synthetic_packed_ntu

    packed = os.path.join(work, "packed")
    t0 = time.time()
    for seed, (split, n) in enumerate(SPLITS):
        make_synthetic_packed_ntu(os.path.join(packed, split), n=n,
                                  frames=24, h=256, w=256, skel_frames=300,
                                  num_classes=60, seed=seed)
    print(f"synthetic packed store written in {time.time() - t0:.1f} s")
    return packed


def slice_phase(torch, work, packed):
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep)
    from mfas_tpu_torch.engine.classifier import valid_rows
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net
    from mfas_tpu_torch.ops import input_kernels as tk

    phase("found-NTU --test_cp slice, full width")
    argv = ["--checkpointdir", work, "--test_cp", "net.pt",
            "--packed_datadir", packed, "--conf", "4", "--num_outputs", "60",
            "--batchsize", "20", "--inner_representation_size", "128",
            "--batchnorm", "--vid_len", "8", "32"]
    args = tmain.parse_args(argv)
    net = Searchable_Skeleton_Image_Net(
        args, tmain.FOUND_CONFS[4], device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    state = net.state_dict()
    torch.save(state, os.path.join(work, "net.pt"))
    n_params = sum(v.numel() for k, v in state.items()
                   if not k.endswith("num_batches_tracked"))
    print(f"checkpoint: {len(state)} tensors, {n_params} values")
    del net

    # each path runs twice, in turns: the first pass of the process pays
    # cuDNN's and the loaders' first-call costs, the second is warm
    runs = {}
    for rep in ("cold", "warm"):
        for name, flag, kernel in (("packed", "--device_input_normalize",
                                    "u8_normalize"),
                                   ("resident", "--hbm_resident",
                                    "u8_gather_normalize")):
            free_card(torch)
            torch.cuda.reset_peak_memory_stats()
            tk.reset_launch_counts()
            run = tmain.main(argv + [flag])
            acc, rec = run.acc, run.eval
            counts = dict(tk.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            check(counts[kernel] > 0, f"{name}: {kernel} never launched "
                  f"({counts})")
            check(np.isfinite(acc), f"{name}: Model Acc {acc} is not finite")
            logits = valid_rows(rec)
            check(logits.shape == (50, 60) and np.isfinite(logits).all(),
                  f"{name}: fused logits {logits.shape}, finite="
                  f"{np.isfinite(logits).all()}")
            print(f"{name} ({rep}): Model Acc {acc}, launches {counts}, eval "
                  f"{rec.clips / rec.seconds:.2f} clips/s ({rec.clips} clips "
                  f"in {rec.seconds:.3f} s, loader + H2D + forward), peak "
                  f"{peak / 2**30:.2f} GiB allocated")
            r = runs.setdefault(name, dict(acc=acc, logits=logits,
                                           counts=counts, peak_bytes=peak,
                                           first=rec.fused_logits[0]))
            r[f"{rep}_clips_per_s"] = rec.clips / rec.seconds
            if rep == "warm":
                print(f"{name}: warm vs cold fused logits, max abs diff "
                      f"{np.abs(logits - r['logits']).max():.3e}")

    a, b = runs["packed"]["logits"], runs["resident"]["logits"]
    # the paths differ only in the skeleton lerp's float association (~1e-6
    # relative); the absolute floor is 1e-5 of the logits' range, for
    # entries near zero
    diff = np.abs(a - b)
    bound = 1e-4 * np.maximum(np.abs(a), np.abs(b)) + 1e-5 * np.abs(a).max()
    check(np.all(diff <= bound), f"packed vs resident fused logits differ: "
          f"max abs {diff.max()}, max |logit| {np.abs(a).max()}")
    check(runs["packed"]["acc"] == runs["resident"]["acc"],
          f"Model Acc differs: {runs['packed']['acc']} vs "
          f"{runs['resident']['acc']}")
    print(f"packed vs resident fused logits: max abs diff {diff.max():.3e} "
          f"(max |logit| {np.abs(a).max():.3e})")

    phase("reference: the same net on the CPU, first two test clips")
    cpu = Searchable_Skeleton_Image_Net(
        args, tmain.FOUND_CONFS[4], device="cpu",
        generator=torch.Generator().manual_seed(SEED + 1))
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    cpu.eval()
    ds = PackedNTU(os.path.join(packed, "test"),
                   Compose([NormalizeLen(args.vid_len)]), args,
                   device_normalize=True)
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
             for k in ("rgb", "ske")}
    batch = make_device_normalize_prep()(batch)
    with torch.inference_mode():
        ref = cpu((batch["rgb"], batch["ske"]))[0].double().numpy()
    got = runs["packed"]["first"][:2].double().cpu().numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"card vs CPU fused logits, 2 clips: max abs diff "
          f"{np.abs(got - ref).max():.3e}, relative to max |logit| {rel:.3e}")
    # f32 through ~70 layers, summed in other orders by cuDNN and oneDNN
    check(rel <= 1e-3, f"card vs CPU logits: relative error {rel}")
    return runs


# --inner_representation_size stays at the CLI's default (256)
TRAIN_ARGV = ["--conf", "4", "--num_outputs", "60", "--batchsize", "20",
              "--batchnorm", "--vid_len", "8", "32", "--epochs", "1",
              "--random_backbones"]
BATCHES = {"train": 2, "dev": 1, "test": 3}     # of 20, from SPLITS


def _tally_out_dtypes(tk):
    """Wrap the two kernel wrappers so each call's output dtype is tallied
    (the batch prep binds them when a run builds its engine). The tally is
    a replay counter (runtime/graphs.py::count_replays): a graph that
    captured a call adds it at every replay. Returns the tally and a
    function that puts the wrappers back."""
    from mfas_tpu_torch.runtime import graphs

    seen = {}
    graphs.count_replays(seen)
    orig = {n: getattr(tk, n) for n in ("u8_normalize",
                                         "u8_gather_normalize")}

    def wrap(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            key = (name, str(out.dtype))
            seen[key] = seen.get(key, 0) + 1
            return out
        return wrapped

    for n, fn in orig.items():
        setattr(tk, n, wrap(n, fn))

    def unwrap():
        graphs.uncount_replays(seen)
        for n, fn in orig.items():
            setattr(tk, n, fn)

    return seen, unwrap


def traced(torch, work, name, fn, calls, steps=None):
    """profile_summary of ``calls`` calls of fn under torch.profiler (CPU
    and card activity), per ``steps`` steps (default: per call), with
    ``wall_ms_traced``, the traced wall time per step. CUPTI now and then
    hands the profiler no kernel record at all; such a trace is taken once
    more before the run fails."""
    from torch.profiler import ProfilerActivity, profile

    from mfas_tpu_torch.runtime.profiler import profile_summary

    steps = steps or calls
    trace = os.path.join(work, f"{name}.json")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(trace)
        p = profile_summary(trace, steps=steps)
        os.remove(trace)
        if "busy_share" in p:
            p["wall_ms_traced"] = wall / steps * 1e3
            return p
        print(f"{name}: the trace holds no kernel; tracing again", flush=True)
    raise SmokeFailure(f"{name}: torch.profiler caught no kernel twice")


def _profiled_line(p):
    return (f"device busy {p['device_busy_ms']:.2f} ms "
            f"({100 * p['busy_share']:.0f} % of the kernel span), "
            f"{p['kernels_per_step']:.0f} kernels")


def paired_train_steps(torch, work, name, engine, model, prefixes, batch,
                       eta, steps, graphed=True):
    """``engine``'s train step on ``batch`` timed eager, then graphed, in
    one call: for each, the median wall time of steps[1] timed steps after
    steps[0] untimed ones (each ended by a synchronize; the graphed ones
    replay the graph the first captured), peak allocated memory over the
    timed steps and over all of them (capture included), then steps[2]
    steps under torch.profiler (busy share, kernels per step, device time
    by kernel class). Each mode gets a fresh Adam; its graphs are freed
    after it. ``graphed=False``: eager only (a step that stays eager by
    configuration). Returns {"eager": r, "graphed": r}."""
    import numpy as np

    from mfas_tpu_torch.engine.classifier import set_trainable

    n_warm, n_timed, n_prof = steps
    out = {}
    for mode in ("eager", "graphed") if graphed else ("eager",):
        engine.graphed = mode == "graphed"
        set_trainable(model, prefixes)
        model.train()
        opt = engine.make_optimizer()
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        times, peak_warm = [], 0
        for i in range(n_warm + n_timed):
            if i == n_warm:
                peak_warm = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = engine.train_step(batch, opt, eta)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(np.isfinite(float(loss)), f"{name} {mode}: loss {loss}")
        ms = float(np.median(times[n_warm:])) * 1e3
        peak = torch.cuda.max_memory_allocated()
        # a graph's pool stays reserved between replays, and its blocks
        # count as allocated only while the capture runs: the reserved
        # peak is what the step holds on the card
        r = {"step_ms": ms, "peak_bytes": peak,
             "peak_bytes_all": max(peak, peak_warm),
             "reserved_bytes": torch.cuda.max_memory_reserved(),
             "step_ms_all": [t * 1e3 for t in times]}
        r["profile"] = p = traced(
            torch, work, f"{name}_{mode}",
            lambda: engine.train_step(batch, opt, eta), n_prof)
        print(f"{name} {mode}: {ms:.2f} ms/step, peak {peak / 2**30:.2f} "
              f"GiB allocated ({r['peak_bytes_all'] / 2**30:.2f} with the "
              f"warm-up), {r['reserved_bytes'] / 2**30:.2f} GiB reserved; "
              f"traced {p['wall_ms_traced']:.2f} ms/step, "
              + _profiled_line(p) + "; " + ", ".join(
                  f"{c} {t:.2f}" for c, t in p["by_class_ms"].items()),
              flush=True)
        out[mode] = r
        engine.release_graphs()
        del opt
    engine.graphed = graphed
    free_card(torch)
    return out


def _rel(torch, a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def held_to_eager(torch, name, runs):
    """``runs``: the graphed run's tensors and two eager runs' from the same
    state (dicts of name -> tensor). Every graphed tensor is held to the
    first eager run's: bitwise when the two eager runs agree bitwise, else
    within twice their largest relative spread (cuDNN picks backward kernels
    that add in a varying order). Returns the figures."""
    g, e1, e2 = runs
    check(g.keys() == e1.keys() == e2.keys(),
          f"{name}: the graphed and eager runs hold other tensors")
    spread = max(_rel(torch, e2[k], e1[k]) for k in e1)
    dev = {k: _rel(torch, g[k], e1[k]) for k in e1}
    worst = max(dev, key=dev.get)
    r = {"max_rel_dev": dev[worst], "worst": worst, "eager_spread": spread,
         "bitwise": dev[worst] == 0.0, "tensors": len(dev)}
    check(dev[worst] <= 2 * spread,
          f"{name}: graphed {worst} {dev[worst]:.3e} of its max from eager, "
          f"beyond twice the eager runs' spread {spread:.3e}")
    print(f"{name}: graphed vs eager over {len(dev)} tensors: "
          + ("bitwise" if r["bitwise"] else
             f"max {dev[worst]:.3e} of max ({worst}), within twice the "
             f"eager spread {spread:.3e}"), flush=True)
    return r


def graphed_vs_eager(torch, name, engine, model, prefixes, batches, eta,
                     eval_batches=None, keep=False):
    """Train steps on ``batches`` and eval steps on ``eval_batches``
    (default: the first batch) from one state, graphed once and eager twice
    (``held_to_eager``): every parameter, buffer, Adam moment and step
    count, every output of each step (loss, corrects, eval logits, MM-IMDB's
    predictions) and the dropout generator's state. cuDNN runs its
    deterministic algorithms here: its default backward kernels add in a
    varying order, which Adam's first steps turn into differences of up to
    ~30 % of a moment between two eager runs of the full-width f32 step,
    too noisy a yardstick. The model and generator end as they started.
    ``keep``: also return the graphed run's tensors (name -> tensor)."""
    from mfas_tpu_torch.engine.classifier import set_trainable, snapshot

    start, gen = snapshot(model), engine.generator.get_state()
    was_graphed = engine.graphed
    names = {p: n for n, p in model.named_parameters()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for mode in ("graphed", "eager", "eager"):
            model.load_state_dict(start)
            engine.generator.set_state(gen)
            engine.graphed = mode == "graphed"
            set_trainable(model, prefixes)
            model.train()
            opt = engine.make_optimizer()
            got = {}
            for i, b in enumerate(batches):
                for j, t in enumerate(engine.train_step(b, opt, eta)):
                    got[f"train{i}/{j}"] = t
            model.eval()
            for i, b in enumerate(eval_batches or batches[:1]):
                for j, t in enumerate(engine.eval_step(b)):
                    got[f"eval{i}/{j}"] = t
            got.update({f"state/{k}": v.detach().clone()
                        for k, v in model.state_dict().items()})
            for p, st in opt.state.items():
                got.update({f"adam/{names[p]}/{k}": v.clone()
                            for k, v in st.items() if torch.is_tensor(v)})
            got["generator"] = engine.generator.get_state()
            engine.release_graphs()
            del opt
            runs.append(got)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    model.load_state_dict(start)
    engine.generator.set_state(gen)
    engine.graphed = was_graphed
    free_card(torch)
    held = held_to_eager(torch, name, runs)
    return (held, runs[0]) if keep else held


def training_phase(torch, work, packed):
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.runtime import graphs
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict
    from mfas_tpu_torch.runtime.profiler import profile_summary

    phase("found-NTU training, full width")
    state = os.path.join(work, "train_state.pt")
    prof = os.path.join(work, "profile")
    base = ["--checkpointdir", work, "--packed_datadir", packed, *TRAIN_ARGV]
    runs = [
        ("a_resident_f32", "--hbm_resident",
         ["--train_state", state, "--save_checkpoint"]),
        ("b_packed_f32", "--device_input_normalize", []),
        ("c_resident_bf16", "--hbm_resident", ["--bf16"]),
        ("d_resident_remat", "--hbm_resident", ["--remat"]),
        ("e_resume", "--hbm_resident",
         ["--train_state", state, "--resume", "--epochs", "2",
          "--profile_dir", prof]),
    ]
    seen, unwrap = _tally_out_dtypes(tk)
    out = {}
    try:
        for name, flag, extra in runs:
            kernel = ("u8_gather_normalize" if flag == "--hbm_resident"
                      else "u8_normalize")
            dt = "torch.bfloat16" if "--bf16" in extra else "torch.float32"
            free_card(torch)
            tk.reset_launch_counts()
            graphs.reset_graph_counts()
            seen.clear()
            t0 = time.time()
            with bn_path(torch, f"found_ntu_training_{name}"):
                run = tmain.main(base + [flag] + extra)
            wall = time.time() - t0
            counts = dict(tk.launch_counts)
            resumed = name == "e_resume"
            gc = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
            check(len(run.train) == (1 if resumed else 2),
                  f"{name}: {len(run.train)} training phases ran")
            if resumed:
                check([e["epoch"] for e in run.train[0].epochs] == [1, 1],
                      f"{name}: resumed epochs {run.train[0].epochs}")
            n_epochs = sum(e["phase"] == "train" for r in run.train
                           for e in r.epochs)
            want = (n_epochs * (BATCHES["train"] + BATCHES["dev"])
                    + BATCHES["test"])
            # one train graph per phase (the trainable set differs), one
            # eval graph per phase's dev split, each replayed once per
            # batch; the test split replays the last dev graph, except on
            # the resident path, whose test store (another address) is
            # another graph; --remat too (the recomputation in the graph)
            n_phases = len(run.train)
            want_graphs = {
                "ClassifierEngine_train": {
                    "captures": n_phases,
                    "replays": n_epochs * BATCHES["train"]},
                "ClassifierEngine_eval": {
                    "captures": n_phases + (flag == "--hbm_resident"),
                    "replays": n_epochs * BATCHES["dev"]
                    + BATCHES["test"]}}
            check(gc == want_graphs,
                  f"{name}: graph counts {gc}, want {want_graphs}")
            print(f"{name}: graph captures and replays {json.dumps(gc)}")
            check(counts[kernel] == want and sum(counts.values()) == want,
                  f"{name}: launches {counts}, want {want} of {kernel}")
            check(seen == {(kernel, dt): want},
                  f"{name}: kernel outputs {seen}, want {want} x {dt}")
            stats = [e for r in run.train for e in r.epochs]
            check(all(np.isfinite(e["loss"]) for e in stats),
                  f"{name}: non-finite loss in {stats}")
            check(np.isfinite(run.acc), f"{name}: Model Acc {run.acc}")
            phases = [{"phase": "central" if len(run.train) == 2 and i == 0
                       else "whole",
                       "train_clips_per_s": r.train_clips / r.train_seconds,
                       "train_clips": r.train_clips,
                       "train_seconds": r.train_seconds,
                       "peak_bytes": peak}
                      for i, (r, peak) in enumerate(zip(run.train,
                                                        run.train_peak_bytes))]
            for p in phases:
                print(f"{name} {p['phase']}: {p['train_clips_per_s']:.2f} "
                      f"train clips/s ({p['train_clips']} clips in "
                      f"{p['train_seconds']:.3f} s), peak "
                      f"{p['peak_bytes'] / 2**30:.2f} GiB allocated")
            eval_rate = run.eval.clips / run.eval.seconds
            print(f"{name}: Model Acc {run.acc}, launches {counts}, "
                  f"{want} x {dt} out, eval {eval_rate:.2f} clips/s, run "
                  f"{wall:.1f} s, losses "
                  f"{[round(e['loss'], 4) for e in stats]}")
            out[name] = {"model_acc": run.acc, "phases": phases,
                         "launches": counts[kernel], "run_seconds": wall,
                         "graph_counts": gc}
            if name == "a_resident_f32":
                sd = load_state_dict(run.saved)
                keys = {k[len("model/"):] for k in torch.load(
                    state, weights_only=True) if k.startswith("model/")}
                check(set(sd) == keys and all(
                    torch.isfinite(v.float()).all() for v in sd.values()),
                      "the saved checkpoint and the train state's model "
                      "differ in keys, or hold non-finite values")
                print(f"saved {os.path.basename(run.saved)}: {len(sd)} "
                      "tensors, the train state's keys")
            del run
    finally:
        unwrap()
    for f in ("trace.json", "ops.txt"):
        check(os.path.exists(os.path.join(prof, f)), f"--profile_dir: no {f}")
    summary = profile_summary(os.path.join(prof, "trace.json"))
    print("profile of e_resume (one phase-2 epoch + test): "
          + json.dumps(summary))
    out["e_resume"]["profile"] = summary
    return out


# warm steps: (untimed, timed, profiled) calls
WARM_STEPS = (2, 5, 2)
REMAT_WARM = (1, 3, 2)      # --remat's phase-2 step: 850 ms
# the graphed --remat phase-2 step's allocated peak, capture included
# (13.70 GiB eager and 36.42 GiB without remat on an H100, PERF.md)
REMAT_PEAK_GIB = 15.0
SEARCH_STEPS = (3, 20, 5)
FEATURE_STEPS = (2, 5, 2)   # the streamed features: 170 ms a call


def warm_train_steps(torch, work, packed):
    """Steady-state train step times at full width, B=20, on the resident
    path (K2 inside the step): f32 phase 1 (central weights) and phase 2
    (whole net), bf16 and remat phase 2, eager and then graphed in one call
    (``paired_train_steps``: median of the WARM_STEPS (REMAT_WARM) timed
    steps after the untimed ones, each ended by a synchronize, peak
    allocated memory, then profiled steps: device time per step by kernel
    class, busy share, kernels per step), K2 counted once per eager step and once per replay;
    --remat's graphed phase-2 peak (capture included) held to at most
    REMAT_PEAK_GIB. Then each graphed step held to the eager one from the
    same state (``graphed_vs_eager``: two train steps and an eval step;
    --remat with dropout on, the recomputation reusing its masks)."""
    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
    from mfas_tpu_torch.engine.classifier import place_batch
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.runtime import graphs

    phase("warm train steps, full width, B=20")
    out = {}
    for mode, extra in (("f32", []), ("bf16", ["--bf16"]),
                        ("remat", ["--remat"])):
        args = tmain.parse_args(["--packed_datadir", packed,
                                 "--hbm_resident", *TRAIN_ARGV, *extra])
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cuda")
        engine = tmain.make_engine(model, args, "cuda")
        engine.generator.manual_seed(SEED)
        store = ResidentNTUStore(os.path.join(packed, "train"), "cuda",
                                 args=args)
        loader = ResidentLoader(store, args.batchsize,
                                Compose([NormalizeLen(args.vid_len)]))
        batch = place_batch(next(iter(loader)), "cuda")
        check(engine.graphed, f"{mode}: engine.graphed {engine.graphed}")
        phases = (("central", model.central_params()), ("whole", None))
        warm = REMAT_WARM if mode == "remat" else WARM_STEPS
        for name, prefixes in phases[mode != "f32":]:
            tk.reset_launch_counts()
            graphs.reset_graph_counts()
            pair = paired_train_steps(
                torch, work, f"warm {mode} {name}", engine, model, prefixes,
                batch, args.eta_max, warm)
            steps = sum(warm)
            got = (tk.launch_counts["u8_gather_normalize"],
                   graphs.GRAPH_COUNTS["ClassifierEngine_train"])
            check(got == (2 * steps, {"captures": 1, "replays": steps}),
                  f"warm {mode} {name}: K2 launches and graph counts {got}, "
                  f"want {2 * steps} (eager and replayed) and {steps} "
                  "replays")
            r = dict(pair["eager"])
            r["train_clips_per_s"] = args.batchsize / r["step_ms"] * 1e3
            r["card_state"] = card_state(f"after warm {mode} {name}")
            r["graphed"] = g = pair["graphed"]
            r["k2_launches_eager_and_replayed"] = got[0]
            if mode == "remat" and name == "whole":
                gib = g["peak_bytes_all"] / 2**30
                check(gib <= REMAT_PEAK_GIB,
                      f"warm remat whole: graphed peak {gib:.2f} GiB "
                      f"allocated, capture included, over {REMAT_PEAK_GIB} "
                      "GiB")
                print(f"warm remat whole: graphed peak {gib:.2f} GiB "
                      f"allocated, capture included, within {REMAT_PEAK_GIB} "
                      "GiB", flush=True)
            r["graphed_vs_eager"] = graphed_vs_eager(
                torch, f"warm {mode} {name}", engine, model, prefixes,
                [batch, batch], args.eta_max)
            out[f"{mode}_{name}"] = r
        del model, engine, store, loader, batch
        free_card(torch)
    return out


def card_vs_cpu(torch, packed):
    """One phase-2 train step at full width on 2 clips, --drpt 0, on the
    card and on the CPU, in two parts.

    Agreement, in float64 with --batchnorm (so the fusion head's
    BatchNorm1d runs in train mode too), both sides fed the same float64
    clips normalized on the host: the loss within 1e-4 relative, and every
    parameter's gradient and every BatchNorm running statistic after the
    step within 1e-3 of that tensor's max |value|.

    Precision, in float32 (TF32 off), the card with K1 in the step: the
    gradients of a random 50-layer net with train-mode BatchNorm over 2
    clips are ill-conditioned. On the CPU alone, f32 against f64 differs by
    ~1e-1 of a tensor's max |grad| (~2e-2 norm-wise), so no f32 computation
    meets 1e-3 of max |grad| against another. The card's f32 step is held
    to what f32 can give: the loss within 1e-4 relative of the CPU's, the
    whole gradient's norm-wise error against the CPU's f64 gradient at most
    twice the CPU f32's (plus 1e-6), and no tensor's more than ten times
    the CPU f32's (plus 1e-5). This part runs without the head's
    BatchNorm1d, which over 2 samples of the nearly constant pooled
    features of random backbones is worse still in f32. The card's step
    runs twice from the same state, both under cuDNN's default algorithms
    (the ones a user runs): eager (``_train_step``) and graphed (a replay
    of ``train_step``'s capture, capturable Adam), each held to that
    rule."""
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep)
    from mfas_tpu_torch.engine.classifier import (WEIGHT_DECAY,
                                                  ClassifierEngine,
                                                  set_trainable)
    from mfas_tpu_torch.runtime import graphs

    phase("one phase-2 train step at full width, card vs CPU")
    argv = ["--packed_datadir", packed, "--device_input_normalize",
            *TRAIN_ARGV, "--drpt", "0"]
    args_bn = tmain.parse_args(argv)
    args = tmain.parse_args([a for a in argv if a != "--batchnorm"])
    ds = PackedNTU(os.path.join(packed, "train"),
                   Compose([NormalizeLen(args.vid_len)]), args,
                   device_normalize=True)
    host = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
            for k in ("rgb", "ske", "label")}
    host["_mask"] = torch.ones(2)
    host64 = make_device_normalize_prep(torch.float64)(
        {k: v.double() if v.is_floating_point() else v
         for k, v in host.items()})

    def step(name, args, dev, dt, batch, batch_prep, graphed=False):
        t0 = time.time()
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], dev).to(dt)
        engine = ClassifierEngine(model, dev, multitask=args.multitask,
                                  input_keys=("rgb", "ske"),
                                  batch_prep=batch_prep)
        set_trainable(model, None)
        model.train()
        placed = {k: v.to(dev) for k, v in batch.items()}
        if graphed:
            check(engine.graphed and not torch.backends.cudnn.deterministic,
                  f"{name}: not a graphed step under cuDNN's defaults")
            graphs.reset_graph_counts()
            opt = engine.make_optimizer()
            loss, _ = engine.train_step(placed, opt, args.eta_max)
            check(graphs.GRAPH_COUNTS == {"ClassifierEngine_train": {
                "captures": 1, "replays": 1}},
                f"{name}: graph counts {graphs.GRAPH_COUNTS}")
        else:
            opt = make_adam(model.parameters(), WEIGHT_DECAY)
            loss, _ = engine._train_step(placed, opt, args.eta_max)
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in model.named_parameters() if p.grad is not None}
        stats = {k: v.detach().cpu().double()
                 for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        print(f"{name}: loss {float(loss):.12f}, {len(grads)} grads, "
              f"{len(stats)} BatchNorm statistics, {time.time() - t0:.1f} s")
        engine.release_graphs()
        del model, engine, opt
        free_card(torch)
        return float(loss), grads, stats

    def max_dev(a, b):
        """The largest max|a - b| / max|b| over the tensors of b."""
        check(a.keys() == b.keys(), "the two steps differ in tensors")
        r = {n: float((a[n] - b[n]).abs().max()
                      / max(float(b[n].abs().max()), 1e-30)) for n in b}
        worst = max(r, key=r.get)
        return r[worst], worst

    prep32 = make_device_normalize_prep(torch.float32)
    l64c, g64c, s64c = step("card f64 --batchnorm", args_bn, "cuda",
                            torch.float64, host64, None)
    l64h, g64h, s64h = step("CPU f64 --batchnorm", args_bn, "cpu",
                            torch.float64, host64, None)
    check(any(n.startswith("fusion_layers.") and n.endswith(".2.weight")
              for n in g64h), "no head BatchNorm1d gradient in the "
          "--batchnorm step")
    loss64_rel = abs(l64c - l64h) / abs(l64h)
    grad64_dev, grad64_t = max_dev(g64c, g64h)
    stat64_dev, stat64_t = max_dev(s64c, s64h)
    print(f"card vs CPU, f64 --batchnorm: loss relative diff "
          f"{loss64_rel:.3e}; largest grad deviation {grad64_dev:.3e} of "
          f"max |grad| ({grad64_t}); largest BatchNorm statistic deviation "
          f"{stat64_dev:.3e} ({stat64_t})")
    check(loss64_rel <= 1e-4, f"f64 card vs CPU loss: relative diff "
          f"{loss64_rel}")
    check(grad64_dev <= 1e-3, f"f64 card vs CPU grad {grad64_t}: "
          f"{grad64_dev} of max |grad|")
    check(stat64_dev <= 1e-3, f"f64 card vs CPU statistic {stat64_t}: "
          f"{stat64_dev} of its max")

    lc, gc, _ = step("card f32", args, "cuda", torch.float32, host, prep32)
    lg, gg, _ = step("card f32 graphed", args, "cuda", torch.float32, host,
                     prep32, graphed=True)
    lh, gh, _ = step("CPU f32", args, "cpu", torch.float32, host, prep32)
    _, g64, _ = step("CPU f64", args, "cpu", torch.float64, host64, None)
    check(gc.keys() == gg.keys() == gh.keys() == g64.keys(),
          "grads differ in keys")
    names = sorted(g64)

    def norm_err(g):
        per = {n: float((g[n] - g64[n]).norm() / g64[n].norm().clamp_min(
            1e-30)) for n in names}
        whole = float(torch.cat([(g[n] - g64[n]).ravel() for n in names]
                                ).norm() / torch.cat(
            [g64[n].ravel() for n in names]).norm())
        return per, whole

    (pc, wc), (ph, wh) = norm_err(gc), norm_err(gh)
    loss_rel = abs(lc - lh) / abs(lh)
    dev_card, t_card = max_dev(gc, gh)
    dev_cpu, t_cpu = max_dev(gh, g64)
    ratio = {n: pc[n] / (10 * ph[n] + 1e-5) for n in names}
    worst = max(ratio, key=ratio.get)
    print(f"card vs CPU, f32: loss relative diff {loss_rel:.3e}; largest "
          f"grad deviation {dev_card:.3e} of max |grad| ({t_card}); CPU f32 "
          f"vs f64: {dev_cpu:.3e} ({t_cpu})")
    print(f"norm-wise error against f64: card {wc:.3e}, CPU f32 {wh:.3e} "
          f"(whole gradient); worst tensor {worst}: card {pc[worst]:.3e}, "
          f"CPU f32 {ph[worst]:.3e}")
    check(loss_rel <= 1e-4, f"card vs CPU loss: relative diff {loss_rel}")
    check(wc <= 2 * wh + 1e-6, f"card gradient error {wc} against f64 "
          f"exceeds twice the CPU f32's {wh}")
    check(ratio[worst] <= 1.0, f"card grad {worst}: error {pc[worst]} "
          f"against f64, CPU f32 {ph[worst]}")
    # the graphed step under cuDNN's default kernels, by the same rule
    pg, wg = norm_err(gg)
    loss_rel_g = abs(lg - lh) / abs(lh)
    ratio_g = {n: pg[n] / (10 * ph[n] + 1e-5) for n in names}
    worst_g = max(ratio_g, key=ratio_g.get)
    print(f"graphed card step (cuDNN defaults): loss relative diff "
          f"{loss_rel_g:.3e}; norm-wise error against f64 {wg:.3e} (eager "
          f"card {wc:.3e}, CPU f32 {wh:.3e}); worst tensor {worst_g}: "
          f"{pg[worst_g]:.3e}, CPU f32 {ph[worst_g]:.3e}; graphed vs eager "
          f"card, largest grad deviation {max_dev(gg, gc)[0]:.3e} of max",
          flush=True)
    check(loss_rel_g <= 1e-4, f"graphed card vs CPU loss: relative diff "
          f"{loss_rel_g}")
    check(wg <= 2 * wh + 1e-6, f"graphed card gradient error {wg} against "
          f"f64 exceeds twice the CPU f32's {wh}")
    check(ratio_g[worst_g] <= 1.0, f"graphed card grad {worst_g}: error "
          f"{pg[worst_g]} against f64, CPU f32 {ph[worst_g]}")
    return {"f64_batchnorm": {"loss_rel": loss64_rel,
                              "grad_dev": grad64_dev,
                              "grad_dev_tensor": grad64_t,
                              "stat_dev": stat64_dev},
            "f32": {"loss_rel": loss_rel, "grad_dev": dev_card,
                    "grad_dev_tensor": t_card,
                    "cpu32_vs_f64_grad_dev": dev_cpu,
                    "norm_err_card": wc, "norm_err_cpu32": wh},
            "f32_graphed": {"loss_rel": loss_rel_g, "norm_err_card": wg,
                            "worst_tensor": worst_g,
                            "worst_ratio": ratio_g[worst_g],
                            "vs_eager_card_grad_dev": max_dev(gg, gc)[0]}}


SEARCH_ARGV = ["--device_input_normalize", "--random_backbones",
               "--no-verbose", "--seed", str(SEED)]
SEARCH_DEV = 60     # one dev clip of each of the 60 classes
SEARCH_WS_ROWS = 8  # (s3): the first step cut to this many of its 32 rows


def write_search_store(work, packed):
    """The search's packed store: trainexp is the train split; dev holds
    one clip of each class. Random backbones pool nearly the same features
    from every random clip, so a candidate predicts about one class for the
    whole dev split and scores 0 unless that class is in it. The first
    EPNAS step samples --num_samples of its 32 confs without replacement
    with p ~ acc^(1/T), which fails with fewer nonzero accuracies than
    that; with every class in dev, such a candidate scores 1/60."""
    import numpy as np

    from mfas_tpu_torch.data.ntu_pack import make_synthetic_packed_ntu

    store = os.path.join(work, "search")
    dev = os.path.join(store, "dev")
    make_synthetic_packed_ntu(dev, n=SEARCH_DEV, frames=24, h=256, w=256,
                              skel_frames=300, num_classes=60, seed=3)
    np.save(os.path.join(dev, "labels.npy"),
            np.random.RandomState(3).permutation(60).astype(np.int32))
    os.symlink(os.path.join(packed, "train"),
               os.path.join(store, "trainexp"))
    return store


def _search_run(torch, tk, seen, name, argv, want_k1, want_dtype,
                want_candidates, capture=False):
    """One in-process ``mfas_tpu_torch.main_searchable_ntu`` run: launch
    counts zeroed just before and read just after; checks K1's count and
    output dtype, the candidates trained, and that every trained conf got a
    finite accuracy in [0, 1]. Returns the measured numbers, the run's
    standard output when ``capture`` keeps it (else it is printed) and its
    surrogate dataset."""
    import contextlib
    import io

    import numpy as np

    from mfas_tpu_torch import main_searchable_ntu as smain
    from mfas_tpu_torch.runtime import graphs

    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    tk.reset_launch_counts()
    graphs.reset_graph_counts()
    seen.clear()
    # bn_path outermost: its line stays out of the captured output
    with bn_path(torch, "ntu_search_" + name.replace(" ", "_")), \
            contextlib.redirect_stdout(buf) if capture else \
            contextlib.nullcontext():
        run = smain.main(argv)
    counts = dict(tk.launch_counts)
    graph_counts = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    out = buf.getvalue()
    accs = [a for _, entries in run.data.state() for _, a in entries]
    # the one-row confs are the first step's, trained for real
    first = [a for L, entries in run.data.state() if L == 1
             for _, a in entries]
    check(counts == {"u8_normalize": want_k1, "u8_gather_normalize": 0},
          f"{name}: launches {counts}, want {want_k1} of u8_normalize")
    check(seen == ({("u8_normalize", want_dtype): want_k1} if want_k1
                   else {}),
          f"{name}: kernel outputs {seen}, want {want_k1} x {want_dtype}")
    check(run.candidates == want_candidates,
          f"{name}: {run.candidates} candidates trained, want "
          f"{want_candidates}")
    check(len(run.top) == 5 and all(np.isfinite(a) and 0 <= a <= 1
                                    for a in accs),
          f"{name}: top {run.top}, accuracies {accs}")
    r = {"seconds": run.seconds, "split_seconds": run.split,
         "graphs": graph_counts, "candidates": run.candidates,
         "candidates_per_hour": run.candidates / run.seconds * 3600.0,
         "peak_bytes": peak, "k1_launches": counts["u8_normalize"],
         "k1_out": want_dtype, "confs_scored": len(accs),
         "first_step_above_0": sum(a > 0 for a in first),
         "first_step_distinct": len(set(first)),
         "top5": [[c.tolist(), float(a)] for c, a in run.top],
         # the first step's confs (one row each) and accuracies
         "first_step": [[c, a] for L, entries in run.data.state()
                        if L == 1 for c, a in entries]}
    print(f"{name}: {run.candidates} candidates in {run.seconds:.1f} s, "
          f"{r['candidates_per_hour']:.0f} candidates/hour; split (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in run.split.items())
          + f"; first step: {r['first_step_above_0']} of {len(first)} "
          f"accuracies above 0, {r['first_step_distinct']} distinct"
          + f"; peak {peak / 2**30:.2f} GiB allocated; K1 launches "
          f"{counts['u8_normalize']} ({want_dtype} out); CUDA graph "
          f"captures / replays {graph_counts}; top-5 "
          f"{[(c.tolist(), round(float(a), 4)) for c, a in run.top]}",
          flush=True)
    return r, out, run.data


def search_phase(torch, work, packed):
    """(s1)-(s4): the default NTU search at full width (ResNet-50 3-4-6-3 at
    base width 64, HCN over 32 frames, every default flag of the CLI:
    hidden 16, batch 20, 3 epochs, 15 samples, 3 iterations x 4 fusions,
    50 surrogate epochs) through ``mfas_tpu_torch.main_searchable_ntu``, on
    a store whose trainexp split is the train clips (40) and whose dev split
    holds 60 clips, one of each class (write_search_store says why).

    (s1) default: train-mode f32 features every train batch, dev features
         cached; K1 runs once per train batch of every epoch of each of the
         12 populations (inside the replayed features graph) and once per
         dev batch: 2 x 3 x 12 + 3 = 75;
    (s2) --cache_features --batchnorm: bf16 bank built once, K1 (bf16 out)
         once per train and dev batch over the whole search: 3;
    (s3) --weightsharing --search_iterations 1 --max_fusions 1 --epochs 1
         --num_samples 4 over the first SEARCH_WS_ROWS of the 32 one-layer
         rows (the step's closing sample draws 4 of them): candidates
         trained one at a time, K1 in each of their batches;
    (s4) (s2) with --search_iterations 1 --search_state F --jsonl_log L,
         then --search_iterations 2 --resume_search: the resume line, only
         iteration 1's four populations (60 candidates), one bank rebuild;
         F, L and the printed top-5 are what (t4) reads back.
    """
    from mfas_tpu_torch.fusion import ntu as f_ntu
    from mfas_tpu_torch.ops import input_kernels as tk

    phase("NTU search, full width")
    store = write_search_store(work, packed)
    base = ["--packed_datadir", store, "--checkpointdir", work,
            *SEARCH_ARGV]
    n_train, n_dev = dict(SPLITS)["train"], SEARCH_DEV
    bs, epochs, iters, fusions, k = 20, 3, 3, 4, 15
    tb, db = -(-n_train // bs), -(-n_dev // bs)
    pops = iters * fusions
    state = os.path.join(work, "search_state.pkl")
    jsonl = os.path.join(work, "search_log.jsonl")
    f32, bf16 = "torch.float32", "torch.bfloat16"
    seen, unwrap = _tally_out_dtypes(tk)
    out = {}
    try:
        out["s1_default"], _, s1_data = _search_run(
            torch, tk, seen, "s1 default search", base,
            tb * epochs * pops + db, f32, 32 + (pops - 1) * k)
        out["s2_cache_features"], _, _ = _search_run(
            torch, tk, seen, "s2 --cache_features --batchnorm",
            base + ["--cache_features", "--batchnorm"], tb + db, bf16,
            32 + (pops - 1) * k)
        rows = f_ntu.get_possible_layer_configurations(0)[:SEARCH_WS_ROWS]
        layer_confs = f_ntu.get_possible_layer_configurations
        f_ntu.get_possible_layer_configurations = lambda i: rows
        try:
            out["s3_weightsharing"], _, _ = _search_run(
                torch, tk, seen, "s3 sequential --weightsharing",
                base + ["--weightsharing", "--search_iterations", "1",
                        "--max_fusions", "1", "--epochs", "1",
                        "--num_samples", "4"],
                SEARCH_WS_ROWS * (tb + db), f32, SEARCH_WS_ROWS)
        finally:
            f_ntu.get_possible_layer_configurations = layer_confs
        bank = base + ["--cache_features", "--batchnorm", "--search_state",
                       state, "--jsonl_log", jsonl]
        out["s4_first"], _, _ = _search_run(
            torch, tk, seen, "s4 first run", bank + ["--search_iterations",
                                                      "1"],
            tb + db, bf16, 32 + (fusions - 1) * k)
        verbose = [a for a in bank if a != "--no-verbose"]
        out["s4_resume"], text, _ = _search_run(
            torch, tk, seen, "s4 resumed run",
            verbose + ["--search_iterations", "2", "--resume_search"],
            tb + db, bf16, fusions * k, capture=True)
        line = f"Resuming search after iteration 0 step {fusions - 1}"
        check(line in text, f"s4: no '{line}' in the resumed run's output")
        print(f"s4 resumed run printed: {line}")
        # what (t4) reads back: the state, the telemetry of both runs and
        # the CLI's printed top-5
        out["s4_resume"]["listing"] = text.split(
            "Now listing best architectures\n")[1].splitlines()
        out["s4_files"] = {"search_state": state, "jsonl_log": jsonl,
                           "epnas_steps": 2 * fusions}
    finally:
        unwrap()
    # every EPNAS fit replays the surrogate's graphs; the bank's epochs
    # replay the fused-epoch graphs once per epoch and phase (2 train and 3
    # dev steps, one graph each), the streamed path never; the streamed
    # path replays its features and train step once per train batch and
    # its eval step once per dev batch, captured once per population shape
    # (P=32, P=15) in the process and the features once per trainer; the
    # sequential candidates of (s3) replay the engine's graphs
    for name, pops_run in (("s1_default", 0), ("s2_cache_features", pops),
                           ("s4_first", fusions), ("s4_resume", fusions)):
        g = out[name]["graphs"]
        check(g.get("surrogate_fit", {}).get("replays", 0) > 0
              and g.get("surrogate_predict", {}).get("replays", 0) > 0,
              f"{name}: the surrogate's graphs did not run: {g}")
        for prog in ("population_train_epoch", "population_eval_epoch"):
            got = g.get(prog, {}).get("replays", 0)
            check(got == pops_run * epochs,
                  f"{name}: {got} {prog} replays, want {pops_run * epochs}")
        streamed = name == "s1_default"
        for prog, per_pop in (("population_features", tb),
                              ("population_train_step", tb),
                              ("population_eval_step", db)):
            got = g.get(prog, {"captures": 0, "replays": 0})
            want = per_pop * epochs * pops if streamed else 0
            check(got["replays"] == want and got["captures"] <= (
                (1 if prog == "population_features" else 2) if streamed
                else 0), f"{name}: {prog} {got}, want {want} replays")
    g = out["s3_weightsharing"]["graphs"]
    check(g.get("ClassifierEngine_train", {}).get("replays", 0)
          == SEARCH_WS_ROWS * tb,
          f"s3: the candidates' engine graphs {g}, want "
          f"{SEARCH_WS_ROWS * tb} train replays")
    out["s6_bank_per_step"] = bank_per_step_search(
        torch, tk, base, tb, db, epochs, k)
    s1, s2 = out["s1_default"], out["s2_cache_features"]
    print(f"s2 vs s1: {s1['seconds'] / s2['seconds']:.2f}x faster")
    out["busy_share"] = search_busy_share(torch, work, base)
    out["steps"] = search_step_times(torch, work, s1_data)
    out["g_graphs"] = graphs_phase(torch, s1_data)
    return out


def bank_per_step_search(torch, tk, base, tb, db, epochs, k):
    """(s6) ``--cache_features --batchnorm --no_fused_epochs`` cut to one
    search iteration of two fusion steps (32 + ``k`` candidates) on (s1)'s
    store: the bank's per-step loop, graphed (each bank batch gathered
    eagerly, then the per-batch train step replayed; each dev batch's eval
    step replayed) and eager (the trainers' graphed entries off), in one
    call from one seed: every accuracy the search scored and every
    population's final parameters and BatchNorm state bitwise; K1 once per
    bank and dev batch in each (the bank build); in the graphed run one
    train and one eval replay per batch, captured once per population
    shape."""
    from mfas_tpu_torch.search import population as pop

    phase("search (s6): the bank's per-step loop, graphed and eager")
    argv = base + ["--cache_features", "--batchnorm", "--no_fused_epochs",
                   "--search_iterations", "1", "--max_fusions", "2"]
    init, train = (pop.PopulationTrainer.__init__,
                   pop.PopulationTrainer.train_population)
    seen, unwrap = _tally_out_dtypes(tk)
    runs = {}
    try:
        for mode in ("graphed", "eager"):
            finals = []

            def made(self, *a, _graphed=mode == "graphed", **kw):
                init(self, *a, **kw)
                self.graphed = _graphed

            def recorded(self, *a, _finals=finals, **kw):
                result = train(self, *a, **kw)
                _finals.append(result)
                return result

            pop.PopulationTrainer.__init__ = made
            pop.PopulationTrainer.train_population = recorded
            try:
                r, _, data = _search_run(
                    torch, tk, seen, f"s6 --no_fused_epochs {mode}", argv,
                    tb + db, "torch.bfloat16", 32 + k)
            finally:
                pop.PopulationTrainer.__init__ = init
                pop.PopulationTrainer.train_population = train
            runs[mode] = (r, data.state(), finals)
    finally:
        unwrap()
    (g, g_data, g_finals), (e, e_data, e_finals) = (runs["graphed"],
                                                    runs["eager"])
    check(len(g_finals) == len(e_finals) == 2, "s6: two populations each")
    same = g_data == e_data and all(
        ga == ea and all(torch.equal(gt[n], et[n]) for gt, et in
                         zip(gs, es) for n in et)
        for (ga, *gs), (ea, *es) in zip(g_finals, e_finals))
    check(same, "s6: the graphed per-step search differs from the eager "
          "one in its accuracies or final parameters")
    for prog, per in (("population_train_step", tb),
                      ("population_eval_step", db)):
        got = g["graphs"].get(prog, {"captures": 0, "replays": 0})
        check(got["replays"] == per * epochs * 2 and got["captures"] <= 2
              and prog not in e["graphs"],
              f"s6: {prog} graphed {got}, eager {e['graphs'].get(prog)}; "
              f"want {per * epochs * 2} replays graphed, none eager")
    print(f"s6: graphed {g['seconds']:.2f} s against eager "
          f"{e['seconds']:.2f} s; every accuracy and final parameter "
          "bitwise", flush=True)
    return {"graphed": g, "eager": e, "bitwise": same,
            "k1_launches": g["k1_launches"] + e["k1_launches"]}


def search_busy_share(torch, work, base):
    """The card's busy share over a range of the default search: its first
    two EPNAS steps (--search_iterations 1 --max_fusions 2: 32 + 15
    candidates, two surrogate fits), run after (s1) so every program is
    warm, once untraced and once under torch.profiler with the card's
    activity only. profile_summary of the trace gives the device's busy
    time and its share of the kernel span (from the first kernel of the
    searcher's set-up to the last of the search); the two runs' wall times
    and sections give the tracing's cost."""
    import contextlib
    import io

    from torch.profiler import ProfilerActivity, profile

    from mfas_tpu_torch import main_searchable_ntu as smain
    from mfas_tpu_torch.runtime.profiler import profile_summary

    phase("search: the card's busy share over (s1)'s first two steps")
    argv = base + ["--search_iterations", "1", "--max_fusions", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        plain = smain.main(argv)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = smain.main(argv)
    trace = os.path.join(work, "search_range.json")
    prof.export_chrome_trace(trace)
    p = profile_summary(trace)
    os.remove(trace)
    r = {"candidates": traced.candidates, "seconds_untraced": plain.seconds,
         "split_untraced": plain.split, "seconds_traced": traced.seconds,
         "split_traced": traced.split, "kernels": p["kernels_per_step"],
         "device_busy_s": p["device_busy_ms"] / 1e3,
         "span_s": p["span_ms"] / 1e3, "busy_share_of_span": p["busy_share"],
         "by_class_s": {c: t / 1e3 for c, t in p["by_class_ms"].items()}}
    print(f"first two steps ({r['candidates']} candidates): untraced "
          f"{plain.seconds:.2f} s, traced {traced.seconds:.2f} s; device "
          f"busy {r['device_busy_s']:.2f} s in {r['kernels']:.0f} kernels, "
          f"{100 * r['busy_share_of_span']:.1f} % of the kernel span "
          f"({r['span_s']:.2f} s); sections untraced / traced (s): "
          + ", ".join(
              f"{k} {plain.split[k]:.2f} / {traced.split[k]:.2f}"
              for k in plain.split), flush=True)
    return r


def search_step_times(torch, work, s1_data):
    """The search's device loops apart, at the default search's shapes,
    each eager and graphed: a population train step and an eval step (B=20,
    hidden 16, drpt 0.5; P=32 as in the first EPNAS step, P=15 as in the
    others) of the streamed per-batch steps (f32 features, the functional
    Adam; eager, and graphed as (s1) runs them, then held to each other by
    ``streamed_vs_eager``) and of the graphed bank epoch (a bf16 bank of
    GRAPH_BANK rows, one epoch a call); the streamed train-mode features at
    full width (``streamed_features_times``);
    a surrogate fit step on (s1)'s final dataset (one Adam step on one
    sequence-length group, in fits of 10 epochs), graphed and as eager
    ``fit_epoch`` calls. Each: the median wall time of SEARCH_STEPS' timed
    calls after its untimed ones, each ended by a synchronize; then its
    profiled calls under torch.profiler give the device's busy share and
    kernels per step."""
    import numpy as np

    from mfas_tpu_torch import main_searchable_ntu as smain
    from mfas_tpu_torch.fusion.layers import enumerate_layer_confs
    from mfas_tpu_torch.fusion.ntu import tap_sizes
    from mfas_tpu_torch.search import population as pop
    from mfas_tpu_torch.search import surrogate as sur
    from mfas_tpu_torch.search.surrogate import SimpleRecurrentSurrogate

    phase("search: warm population steps and surrogate fit steps")
    dev = torch.device("cuda")

    def measure(name, fn, per=1, steps=SEARCH_STEPS):
        """fn's time, peak allocated memory and device busy share, per
        ``per`` steps it runs, over ``steps`` (untimed, timed, profiled)
        calls."""
        n_warm, n_timed, n_prof = steps
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n_warm + n_timed):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        p = traced(torch, work, "search_step", fn, n_prof, n_prof * per)
        r = {"ms": float(np.median(times[n_warm:])) * 1e3 / per,
             "busy_share": p["busy_share"],
             "device_busy_ms": p["device_busy_ms"],
             "kernels": p["kernels_per_step"], "peak_bytes": peak,
             "reserved_bytes": reserved}
        print(f"{name}: {r['ms']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms ({100 * r['busy_share']:.0f} % "
              f"of the kernel span), "
              f"{r['kernels']:.0f} kernels, peak {peak / 2**30:.2f} GiB "
              f"allocated, {reserved / 2**30:.2f} GiB reserved", flush=True)
        return r

    args = smain.parse_args(SEARCH_ARGV)
    ske, ims = tap_sizes(args)
    spec = pop.PopulationSpec(
        sizes_a=tuple(ske), sizes_b=tuple(ims),
        hidden=args.inner_representation_size, num_outputs=args.num_outputs,
        max_rows=args.max_progression_levels, drpt=args.drpt)
    rs = np.random.RandomState(SEED)
    rows = np.asarray(enumerate_layer_confs(4, 4, 2))
    B = args.batchsize
    g = torch.Generator(device=dev).manual_seed(SEED)
    batch = (torch.rand((B, 4, spec.cmax_a), device=dev, generator=g),
             torch.rand((B, 4, spec.cmax_b), device=dev, generator=g),
             torch.randn((B, 60), device=dev, generator=g),
             torch.randn((B, 60), device=dev, generator=g),
             torch.randint(0, 60, (B,), device=dev, generator=g),
             torch.ones(B, device=dev))
    out = {}
    # the streamed per-batch steps (``_StreamedSteps``), eager (the
    # per-step loop's functions) and graphed, as (s1) runs them
    for P in (32, 15):
        confs = [rows[rs.choice(32, 1 + p % 4)] for p in range(P)]
        params, bn = pop.init_population(confs, spec, seed=SEED, device=dev)
        conf = pop.conf_tensors(confs, spec, dev)
        for mode in ("eager", "graphed"):
            prog = pop._StreamedSteps(spec, params, bn, conf, device=dev,
                                      graphed=mode == "graphed")
            prog.load(params, bn, conf)
            key = "" if mode == "eager" else "_streamed_graphed"
            out[f"population_train_step_P{P}{key}"] = measure(
                f"population train step P={P}, {mode}",
                lambda: prog.train_batch(batch[:4], batch[4], batch[5],
                                         1e-3, g))
            out[f"population_eval_step_P{P}{key}"] = measure(
                f"population eval step P={P}, {mode}",
                lambda: prog.eval_batch(batch))
            del prog
    out["streamed_graphed_vs_eager"] = streamed_vs_eager(
        torch, spec, rows, rs, batch, dev)
    out.update(streamed_features_times(torch, args, measure, dev))

    # the bank's fused epoch, graphed, at the same shapes: one epoch of
    # GRAPH_BANK[0] / B steps per call
    bank, dev_bank = _graph_banks(torch, spec, dev, torch.bfloat16)
    for P in (32, 15):
        confs = [rows[rs.choice(32, 1 + p % 4)] for p in range(P)]
        params, bn = pop.init_population(confs, spec, seed=SEED, device=dev)
        conf = pop.conf_tensors(confs, spec, dev)
        prog = pop._FusedEpochs(spec, params, bn, conf, bank, dev_bank, B, B,
                                device=dev, graphed=True)
        prog.load(params, bn, conf, bank, dev_bank)
        take, wm = pop.PopulationTrainer._epoch_index_plan(
            GRAPH_BANK[0], B, np.random.RandomState(SEED))
        etas = np.full(take.shape[0], 1e-3, np.float32)
        out[f"population_train_step_P{P}_graphed"] = measure(
            f"population train step P={P}, graphed epoch",
            lambda: prog.train_epoch(take, wm, etas, g), per=take.shape[0])
        out[f"population_eval_step_P{P}_graphed"] = measure(
            f"population eval step P={P}, graphed epoch", prog.eval_epoch,
            per=-(-GRAPH_BANK[1] // B))

    # the bank's per-step loop (--no_fused_epochs): one batch gathered
    # from the bank (eagerly), then the per-batch train step, eager and
    # graphed, P=32
    gather = pop.PopulationTrainer(spec, torch.nn.Sequential(), device=dev)
    take, wm = pop.PopulationTrainer._epoch_index_plan(
        GRAPH_BANK[0], B, np.random.RandomState(SEED))
    confs = [rows[rs.choice(32, 1 + p % 4)] for p in range(32)]
    params, bn = pop.init_population(confs, spec, seed=SEED, device=dev)
    conf = pop.conf_tensors(confs, spec, dev)
    for mode in ("eager", "graphed"):
        prog = pop._StreamedSteps(spec, params, bn, conf, device=dev,
                                  graphed=mode == "graphed")
        prog.load(params, bn, conf)

        def bank_step():
            *feats, label, w = gather._bank_batch(bank, take[0], wm[0])
            prog.train_batch(feats, label, w, 1e-3, g)

        out[f"population_bank_step_P32_{mode}"] = measure(
            f"population train step P=32, bank per-step loop, {mode}",
            bank_step)
        del prog

    surrogate = SimpleRecurrentSurrogate(100, 3, 100, device=dev)
    confs, accs = s1_data.get_data()
    group = max(range(len(confs)), key=lambda i: confs[i].shape[1])
    sizes = [c.shape[1] for c in confs]
    what = (f"length {confs[group].shape[0]}, {sizes[group]} confs; groups "
            f"{sizes}")
    out["surrogate_fit_step_graphed"] = measure(
        f"surrogate fit step, graphed ({what})",
        lambda: surrogate.fit([confs[group]], [accs[group]], num_epochs=10,
                              lr=args.lr_surrogate), per=10)
    data = [torch.as_tensor(a, device=dev) for a in sur.pad_groups(
        [confs[group]], [accs[group]], surrogate.max_seq_len)]
    lr = torch.tensor(args.lr_surrogate, device=dev)

    def eager_fit():
        for _ in range(10):
            sur.fit_epoch(surrogate.net, surrogate.adam, data, lr)
        return float(surrogate.adam["step"])   # the fit's one host fetch

    out["surrogate_fit_step_eager"] = measure(
        f"surrogate fit step, eager ({what})", eager_fit, per=10)
    return out


def streamed_vs_eager(torch, spec, rows, rs, batch, dev):
    """The streamed train step (P=32) twice and an eval step, graphed once
    and eager twice from one state and generator seed, held to each other
    (``held_to_eager``): parameters, BatchNorm state, Adam state, correct
    counts and the generator's state."""
    from mfas_tpu_torch.search import population as pop

    confs = [rows[rs.choice(32, 1 + p % 4)] for p in range(32)]
    params, bn = pop.init_population(confs, spec, seed=SEED, device=dev)
    conf = pop.conf_tensors(confs, spec, dev)
    runs = []
    for mode in ("graphed", "eager", "eager"):
        prog = pop._StreamedSteps(spec, params, bn, conf, device=dev,
                                  graphed=mode == "graphed")
        prog.load(params, bn, conf)
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        got = {}
        for i in range(2):
            prog.train_batch(batch[:4], batch[4], batch[5], 1e-3, g)
            got[f"corr{i}"] = prog.counts("corr")
        prog.eval_batch(batch)
        got["dev_corr"] = prog.counts("dev_corr")
        p, b = prog.state()
        got.update({f"param/{k}": v for k, v in p.items()})
        got.update({f"bn/{k}": v for k, v in b.items()})
        got.update({f"adam/m{i}": t.clone()
                    for i, t in enumerate(prog.st["adam"]["m"])})
        got.update({f"adam/v{i}": t.clone()
                    for i, t in enumerate(prog.st["adam"]["v"])})
        got["adam/step"] = prog.st["adam"]["step"].clone()
        got["generator"] = g.get_state()
        runs.append(got)
        del prog
    return held_to_eager(torch, "streamed population step P=32", runs)


def streamed_features_times(torch, args, measure, dev):
    """The streamed path's train-mode features at (s1)'s shapes (B=20, 8
    frames of 256x256, the full-width backbones, K1 inside), eager and
    graphed (``PopulationTrainer.streamed_features``), timed by
    ``measure``; the graphed features held to the eager ones from one
    generator state, and one K1 launch per replay."""
    import numpy as np

    from mfas_tpu_torch.data.ntu_pack import make_device_normalize_inputs_prep
    from mfas_tpu_torch.fusion.ntu import NTUFeatureExtractor, tap_sizes
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.search import population as pop

    ske, ims = tap_sizes(args)
    spec = pop.PopulationSpec(
        sizes_a=tuple(ske), sizes_b=tuple(ims),
        hidden=args.inner_representation_size, num_outputs=args.num_outputs,
        max_rows=args.max_progression_levels, drpt=args.drpt)
    trainer = pop.PopulationTrainer(
        spec, NTUFeatureExtractor(
            args, device=dev, generator=torch.Generator().manual_seed(SEED)),
        device=dev, input_prep=make_device_normalize_inputs_prep())
    check(trainer.graphed, "the streamed trainer is not graphed on the card")
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, T = args.batchsize, args.vid_len[0]
    inputs = (torch.randint(0, 256, (B, T, 256, 256, 3), dtype=torch.uint8,
                            device=dev, generator=g),
              torch.randn((B, 3, args.vid_len[1], 25, 2), device=dev,
                          generator=g) * 0.3)
    out = {"streamed_features_eager": measure(
        "streamed features (train mode, K1), eager",
        lambda: trainer._features(inputs, True), steps=FEATURE_STEPS)}
    out["streamed_features_graphed"] = measure(
        "streamed features (train mode, K1), graphed",
        lambda: trainer.streamed_features(inputs), steps=FEATURE_STEPS)
    runs = []
    for mode in ("graphed", "eager", "eager"):
        trainer.generator.manual_seed(SEED + 5)
        tk.reset_launch_counts()
        feats = (trainer.streamed_features(inputs) if mode == "graphed"
                 else trainer._features(inputs, True))
        check(tk.launch_counts["u8_normalize"] == 1,
              f"streamed features {mode}: K1 launches {tk.launch_counts}")
        runs.append({**{f"feat{i}": f for i, f in enumerate(feats)},
                     "generator": trainer.generator.get_state()})
    out["streamed_features_graphed_vs_eager"] = held_to_eager(
        torch, "streamed features", runs)
    del trainer, inputs
    free_card(torch)
    return out


GRAPH_BANK = (400, 60)      # (g2) and the graphed timings: bank rows
GRAPH_FIT_EPOCHS = 50       # (g1): the default --epochs_surrogate


def _graph_banks(torch, spec, dev, dtype, seed=SEED):
    """Train and dev banks of GRAPH_BANK rows at the spec's tap widths:
    random features in ``dtype`` (zero past each tap's width), random
    logits and labels."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def bank(n):
        def taps(sizes):
            t = torch.randn((n, len(sizes), max(sizes)), device=dev,
                            generator=g)
            for i, c in enumerate(sizes):
                t[:, i, c:] = 0.0
            return t.to(dtype)
        return {"fa": taps(spec.sizes_a), "fb": taps(spec.sizes_b),
                "lb": torch.randn((n, spec.num_outputs), device=dev,
                                  generator=g).to(dtype),
                "la": torch.randn((n, spec.num_outputs), device=dev,
                                  generator=g).to(dtype),
                "label": torch.randint(0, spec.num_outputs, (n,), device=dev,
                                       generator=g)}
    return bank(GRAPH_BANK[0]), bank(GRAPH_BANK[1])


def _max_rel(torch, got, want):
    """max |got - want| over max |want| of one tensor (0 when equal)."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-300))


def graphs_phase(torch, s1_data):
    """(g) The search's CUDA graphs (mfas_tpu_torch/runtime/graphs.py)
    against eager calls of the same step functions on the card.

    (g1) the surrogate: from (s1)'s final dataset and a one-epoch Adam
         state, a graphed GRAPH_FIT_EPOCHS-epoch fit against the eager
         ``fit_epoch`` calls of the same padded groups from a copy of that
         state: parameters, moments and step bitwise (else within 1e-6 of
         each tensor's max), the last loss equal; then ``eval_models`` of
         every conf of the dataset graphed against the eager padded
         forward;
    (g2) the bank's fused epoch at the default search's shapes (P=32,
         B=20, hidden 16, --batchnorm, drpt 0.5, full-width taps, a bf16
         bank of GRAPH_BANK rows): two graphed train and dev epochs
         against the eager program on the same bank, plans, learning rates
         and generator seed: parameters, BatchNorm state, correct counts
         and the generator's state after, bitwise (else within 1e-6); then
         in float64 with --alphas at a learning rate of 1e-6, the graphed
         epoch against the per-step loop (``population.train_step``, the
         same ``adam_update``, batches gathered on the host's index rows):
         within 1e-9, the same correct counts and generator state.
    Captures and replays of each program are printed."""
    import dataclasses

    import numpy as np

    from mfas_tpu_torch import main_searchable_ntu as smain
    from mfas_tpu_torch.core.optim import adam_init
    from mfas_tpu_torch.fusion.layers import enumerate_layer_confs
    from mfas_tpu_torch.fusion.ntu import tap_sizes
    from mfas_tpu_torch.runtime import graphs
    from mfas_tpu_torch.search import population as pop
    from mfas_tpu_torch.search import surrogate as sur

    phase("(g) the search's CUDA graphs against eager calls")
    dev = torch.device("cuda")
    args = smain.parse_args(SEARCH_ARGV)
    graphs.reset_graph_counts()
    out = {}

    # (g1)
    confs, accs = s1_data.get_data()
    graphed = sur.SimpleRecurrentSurrogate(100, 3, 100, device=dev)
    graphed.fit(confs, accs, num_epochs=1, lr=args.lr_surrogate)
    eager = sur.SimpleRecurrentSurrogate(100, 3, 100, device=dev)
    eager.load_numpy(graphed.params_numpy(), graphed.opt_state_numpy())
    t0 = time.perf_counter()
    loss = graphed.fit(confs, accs, num_epochs=GRAPH_FIT_EPOCHS,
                       lr=args.lr_surrogate)
    t_graphed = time.perf_counter() - t0
    data = [torch.as_tensor(a, device=dev)
            for a in sur.pad_groups(confs, accs, eager.max_seq_len)]
    lr = torch.tensor(float(np.float32(args.lr_surrogate)), device=dev)
    t0 = time.perf_counter()
    for _ in range(GRAPH_FIT_EPOCHS):
        want = sur.fit_epoch(eager.net, eager.adam, data, lr)
    want = float(want)
    t_eager = time.perf_counter() - t0
    errs = {k: _max_rel(torch, v, eager.net.state_dict()[k])
            for k, v in graphed.net.state_dict().items()}
    for k in ("m", "v"):
        for i, (a, b) in enumerate(zip(graphed.adam[k], eager.adam[k])):
            errs[f"{k}{i}"] = _max_rel(torch, a, b)
    steps = int(graphed.adam["step"]), int(eager.adam["step"])
    flat = [c[:, i] for c in confs for i in range(c.shape[1])]
    got = torch.tensor(graphed.eval_models(flat))
    seq, lengths = sur.pad_confs(flat, eager.max_seq_len)
    with torch.no_grad():
        ref = eager.net(torch.as_tensor(seq, device=dev),
                        torch.as_tensor(lengths, device=dev))
    errs["eval_models"] = _max_rel(torch, got, ref[:len(flat), 0].cpu())
    worst = max(errs.values())
    G = len(confs)
    out["g1_surrogate"] = {
        "groups": [list(c.shape[:2]) for c in confs],
        "padded": list(data[0].shape), "epochs": GRAPH_FIT_EPOCHS,
        "bitwise": worst == 0.0 and loss == want, "max_rel_err": worst,
        "loss_graphed": loss, "loss_eager": want, "steps": steps,
        "fit_s_graphed": t_graphed, "fit_s_eager": t_eager,
        "ms_per_step_graphed": t_graphed / (GRAPH_FIT_EPOCHS * G) * 1e3,
        "ms_per_step_eager": t_eager / (GRAPH_FIT_EPOCHS * G) * 1e3,
        "confs_predicted": len(flat)}
    print(f"(g1) surrogate fit, {GRAPH_FIT_EPOCHS} epochs x {G} groups "
          f"padded to {list(data[0].shape)}: graphed {t_graphed:.3f} s, "
          f"eager {t_eager:.3f} s; loss {loss} / {want}, steps {steps}; "
          f"parameters, moments and {len(flat)} predictions: max rel err "
          f"{worst:.3e} ({'bitwise' if worst == 0.0 else 'not bitwise'})",
          flush=True)
    check(worst <= 1e-6 and abs(loss - want) <= 1e-6 * abs(want)
          and steps[0] == steps[1],
          f"(g1) graphed surrogate off its eager fit: {errs}, loss {loss} "
          f"/ {want}, steps {steps}")

    # (g2)
    ske, ims = tap_sizes(args)
    rows = np.asarray(enumerate_layer_confs(4, 4, 2))
    rs = np.random.RandomState(SEED)
    confs32 = [rows[rs.choice(32, 1 + p % 4)] for p in range(32)]
    B = args.batchsize
    n, n_dev = GRAPH_BANK

    def epochs(prog, params, bn, conf, bank, dev_bank, scale):
        prog.load(params, bn, conf, bank, dev_bank)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        plan_rs = np.random.RandomState(SEED + 17)
        corrs = []
        for e in range(2):
            take, wm = pop.PopulationTrainer._epoch_index_plan(n, B, plan_rs)
            etas = np.full(take.shape[0], scale / (e + 1), np.float32)
            corrs.append(prog.train_epoch(take, wm, etas, gen).clone())
            corrs.append(prog.eval_epoch().clone())
        return prog.state(), corrs, gen.get_state()

    spec = pop.PopulationSpec(
        sizes_a=tuple(ske), sizes_b=tuple(ims),
        hidden=args.inner_representation_size, num_outputs=args.num_outputs,
        max_rows=args.max_progression_levels, batchnorm=True,
        drpt=args.drpt)
    bank, dev_bank = _graph_banks(torch, spec, dev, torch.bfloat16)
    params, bn = pop.init_population(confs32, spec, seed=SEED, device=dev)
    conf = pop.conf_tensors(confs32, spec, dev)
    runs = [epochs(pop._FusedEpochs(spec, params, bn, conf, bank, dev_bank,
                                    B, B, device=dev, graphed=graphed),
                   params, bn, conf, bank, dev_bank, 1e-3)
            for graphed in (True, False)]
    (pg, bg), cg, sg = runs[0]
    (pe, be), ce, se = runs[1]
    errs = {**{k: _max_rel(torch, pg[k], pe[k]) for k in pg},
            **{f"bn_{k}": _max_rel(torch, bg[k], be[k]) for k in bg}}
    same_counts = all(torch.equal(a, b) for a, b in zip(cg, ce))
    worst = max(errs.values())
    out["g2_bank_epoch"] = {
        "P": 32, "batch": B, "bank_rows": list(GRAPH_BANK),
        "train_steps_per_epoch": -(-n // B), "bitwise": worst == 0.0,
        "max_rel_err": worst, "corrects_equal": same_counts,
        "generator_equal": bool(torch.equal(sg, se)),
        "train_corrects": [float(c.sum()) for c in cg[0::2]],
        "dev_corrects": [float(c.sum()) for c in cg[1::2]]}
    print(f"(g2) fused bank epoch P=32, B={B}, {n} / {n_dev} rows, 2 "
          f"epochs: graphed against eager max rel err {worst:.3e}, correct "
          f"counts equal {same_counts}, generator state equal "
          f"{out['g2_bank_epoch']['generator_equal']}", flush=True)
    check(worst <= 1e-6 and same_counts
          and out["g2_bank_epoch"]["generator_equal"],
          f"(g2) graphed fused epoch off its eager twin: {errs}")

    spec64 = dataclasses.replace(spec, use_alphas=True)
    bank, dev_bank = _graph_banks(torch, spec64, dev, torch.float64)
    params, bn = pop.init_population(confs32, spec64, seed=SEED, device=dev)
    params = {k: v.detach().double().requires_grad_()
              for k, v in params.items()}
    bn = {k: v.double() for k, v in bn.items()}
    prog = pop._FusedEpochs(spec64, params, bn, conf, bank, dev_bank, B, B,
                            device=dev, graphed=True)
    prog.load(params, bn, conf, bank, dev_bank)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    take, wm = pop.PopulationTrainer._epoch_index_plan(
        n, B, np.random.RandomState(SEED + 17))
    etas = np.full(take.shape[0], 1e-6, np.float32)
    corr = prog.train_epoch(take, wm, etas, gen).clone()
    (pg, bg) = prog.state()
    trainer = pop.PopulationTrainer(spec64, torch.nn.Sequential(),
                                    device=dev)
    adam = adam_init(list(params.values()))
    g_loop = torch.Generator(device=dev).manual_seed(SEED + 1)
    terms = []
    for take_s, wm_s, eta in zip(take, wm, etas):
        bn, _, c = pop.train_step(spec64, params, bn, adam, conf,
                                  trainer._bank_batch(bank, take_s, wm_s),
                                  float(eta), g_loop)
        terms.append(c)
    abs_err = max([float((pg[k] - v.detach()).abs().max())
                   for k, v in params.items()]
                  + [float((bg[k] - v).abs().max()) for k, v in bn.items()])
    same_counts = torch.equal(corr, sum(terms))
    same_gen = bool(torch.equal(gen.get_state(), g_loop.get_state()))
    out["g2_against_per_step_loop_f64"] = {
        "max_abs_err": abs_err, "corrects_equal": same_counts,
        "generator_equal": same_gen}
    print(f"(g2) f64 graphed epoch against the per-step loop: max abs err "
          f"{abs_err:.3e}, correct counts equal {same_counts}, generator "
          f"state equal {same_gen}", flush=True)
    check(abs_err <= 1e-9 and same_counts and same_gen,
          f"(g2) f64 graphed epoch off the per-step loop: {abs_err}")
    out["graph_counts"] = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    print(f"(g) CUDA graph captures / replays: {out['graph_counts']}",
          flush=True)
    return out


def search_card_vs_cpu(torch, packed):
    """(s5) The search's device work on the card against the CPU: the
    full-width extractor's padded taps and logits on 2 clips in f32, through
    the population trainer's feature pass (PopulationTrainer._features: the
    inputs prep with K1 on the card, no autograd), in eval mode and in the
    streamed path's train mode (batch-statistic BatchNorm, the HCN's
    Dropout2d an identity at --drpt 0), each tensor within 1e-4 of its max
    |value|, and the train-mode pass leaving every backbone buffer
    unchanged; one population train step at P=32, B=20, --batchnorm, drpt
    0, the default widths, in float64: loss, corrects, every gradient,
    parameter after Adam and BatchNorm statistic within 1e-9 of its
    tensor's max."""
    import numpy as np

    from mfas_tpu_torch import main_searchable_ntu as smain
    from mfas_tpu_torch.core.optim import adam_init
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (
        PackedNTU, make_device_normalize_inputs_prep)
    from mfas_tpu_torch.fusion.ntu import NTUFeatureExtractor, tap_sizes
    from mfas_tpu_torch.fusion.layers import enumerate_layer_confs
    from mfas_tpu_torch.search import population as pop

    phase("search: card vs CPU (extractor taps f32, population step f64)")
    args = smain.parse_args(["--packed_datadir", packed, *SEARCH_ARGV,
                             "--batchnorm", "--drpt", "0"])
    ske, ims = tap_sizes(args)
    spec = pop.PopulationSpec(
        sizes_a=tuple(ske), sizes_b=tuple(ims),
        hidden=args.inner_representation_size, num_outputs=args.num_outputs,
        max_rows=args.max_progression_levels, batchnorm=True, drpt=0.0)
    ds = PackedNTU(os.path.join(packed, "dev"),
                   Compose([NormalizeLen(args.vid_len)]), args,
                   device_normalize=True)
    clips = tuple(torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
                  for k in ("rgb", "ske"))
    feats = {}
    for dev in ("cuda", "cpu"):
        trainer = pop.PopulationTrainer(
            spec, NTUFeatureExtractor(
                args, device=dev,
                generator=torch.Generator().manual_seed(SEED)),
            device=dev, input_prep=make_device_normalize_inputs_prep())
        buffers = {k: v.clone() for k, v in trainer.extractor.named_buffers()}
        inputs = tuple(c.to(dev) for c in clips)
        for mode in ("eval", "train"):
            feats[mode, dev] = [t.double().cpu() for t in trainer._features(
                inputs, mode == "train")]
        check(all(torch.equal(v, buffers[k])
                  for k, v in trainer.extractor.named_buffers()),
              f"the train-mode feature pass on {dev} changed a backbone "
              "buffer")
        del trainer
    tap_dev = {}
    for mode in ("eval", "train"):
        tap_dev[mode] = max(
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(feats[mode, "cuda"], feats[mode, "cpu"]))
        print(f"extractor {mode} mode, 2 clips f32: largest deviation "
              f"{tap_dev[mode]:.3e} of a tensor's max over "
              f"{len(feats[mode, 'cpu'])} padded taps and logits")
    print("train-mode feature pass: every backbone buffer unchanged on "
          "both devices")
    for mode, d in tap_dev.items():
        check(d <= 1e-4, f"extractor {mode} mode card vs CPU: {d} of max")

    rs = np.random.RandomState(SEED)
    rows = np.asarray(enumerate_layer_confs(4, 4, 2))
    confs = [rows[rs.choice(32, 1 + p % 4)] for p in range(32)]
    B = 20
    fa = np.zeros((B, 4, spec.cmax_a))
    fb = np.zeros((B, 4, spec.cmax_b))
    for t, sizes in ((fa, ske), (fb, ims)):
        for i, c in enumerate(sizes):
            t[:, i, :c] = rs.rand(B, c) * 2.0
    batch_np = (fa, fb, rs.randn(B, 60), rs.randn(B, 60),
                rs.randint(0, 60, B), np.r_[np.ones(B - 3), np.zeros(3)])
    res = {}
    for dev in ("cuda", "cpu"):
        params, bn = pop.init_population(confs, spec, seed=SEED, device=dev)
        params = {k: v.detach().double().requires_grad_(True)
                  for k, v in params.items()}
        bn = {k: v.double() for k, v in bn.items()}
        adam = adam_init(list(params.values()))
        batch = tuple(torch.from_numpy(np.asarray(x)).to(dev)
                      for x in batch_np)
        t0 = time.time()
        new_bn, loss, corr = pop.train_step(
            spec, params, bn, adam, pop.conf_tensors(confs, spec, dev), batch,
            1e-3)
        out = {"loss": loss, "corrects": corr,
               **{f"grad/{k}": p.grad for k, p in params.items()},
               **{f"param/{k}": p.detach() for k, p in params.items()},
               **{f"bn/{k}": v for k, v in new_bn.items()}}
        res[dev] = {k: v.double().cpu() for k, v in out.items()}
        print(f"population step f64 on {dev}: {time.time() - t0:.2f} s, "
              f"mean loss {float(loss.mean()):.6f}")
    devs = {k: float((res["cuda"][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30))
            for k, v in res["cpu"].items()}
    worst = max(devs, key=devs.get)
    print(f"population step f64, P=32 B=20: largest deviation "
          f"{devs[worst]:.3e} of max ({worst}) over {len(devs)} tensors")
    check(devs[worst] <= 1e-9, f"population step card vs CPU {worst}: "
          f"{devs[worst]} of max")
    return {"extractor_tap_dev": tap_dev["eval"],
            "extractor_train_mode_tap_dev": tap_dev["train"],
            "step_f64_dev": devs[worst],
            "step_f64_dev_tensor": worst}


# AV-MNIST: the found-training store at the reference's split sizes
# (train 55,000, so the CLI takes dev = train[50000:55000]; test 10,000),
# the search's store cut to 7,200 train samples (6,300 train and 900 dev
# rows by the CLI's n//8 rule)
AV_FOUND_STORE = (55000, 10000)
AV_SEARCH_STORE = (7200, 16)
AV_CHUNK = 5000
AV_LABEL_STEP = 0.08        # make_synthetic_avmnist's image shift per class
AV_FOUND_ARGV = ["--conf", "0", "--random_backbones", "--epochs", "1"]
AV_SEARCH_ARGV = ["--random_backbones", "--no-verbose", "--seed", str(SEED)]
# (v2), (v3): the default 3 search iterations cut to 1, so the whole script
# keeps within its time with the CIFAR phase added
AV_SEARCH_ITERATIONS = "1"
AV_WARM = (3, 20, 3)        # warm phase-2 steps: untimed, timed, profiled


def write_avmnist_store(torch, root, n_train, n_test, seed):
    """A synthetic AV-MNIST store in the on-disk layout of
    mfas_tpu_torch/data/avmnist.py, with make_synthetic_avmnist's
    distribution (labels uniform over 10 classes; audio U(0, 0.1); image
    U(0, 1) + AV_LABEL_STEP x label), drawn on the card in chunks of
    AV_CHUNK rows and written through memory maps (the train audio of the
    found store alone is 2.76 GB)."""
    import numpy as np

    t0 = time.time()
    g = torch.Generator(device="cuda").manual_seed(seed)
    for sub in ("audio", "images"):
        os.makedirs(os.path.join(root, sub))
    for split, n in (("train", n_train), ("test", n_test)):
        labels = torch.randint(0, 10, (n,), device="cuda", generator=g)
        np.save(os.path.join(root, f"{split}_labels.npy"),
                labels.cpu().numpy())
        audio = np.lib.format.open_memmap(
            os.path.join(root, "audio", f"{split}_data.npy"), mode="w+",
            dtype=np.float32, shape=(n, 112, 112))
        image = np.lib.format.open_memmap(
            os.path.join(root, "images", f"{split}_data.npy"), mode="w+",
            dtype=np.float32, shape=(n, 784))
        for lo in range(0, n, AV_CHUNK):
            hi = min(n, lo + AV_CHUNK)
            audio[lo:hi] = (torch.rand((hi - lo, 112, 112), device="cuda",
                                       generator=g) * 0.1).cpu().numpy()
            image[lo:hi] = (torch.rand((hi - lo, 784), device="cuda",
                                       generator=g)
                            + labels[lo:hi, None] * AV_LABEL_STEP
                            ).cpu().numpy()
        audio.flush()
        image.flush()
        del audio, image
    print(f"AV-MNIST store {n_train} train + {n_test} test written in "
          f"{time.time() - t0:.1f} s")
    return root


def _quiet(fn, *a, **k):
    """fn's result and its standard output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def avmnist_found(torch, work, store):
    """(v1) ``mfas_tpu_torch.main_found_avmnist`` at full width (GP_LeNet_
    Deeper at --channels 32 on 112x112 spectrograms, GP_LeNet on 28x28
    digits, hidden 256, B=128, conf 0, random weights from seed 0) with
    --epochs 1 --save_checkpoint on the 55,000-sample store, then
    --test_cp of the saved file, which must print the same Model Acc
    without training."""
    import numpy as np

    from mfas_tpu_torch import main_found_avmnist as fmain
    from mfas_tpu_torch.data.avmnist import train_dev_split
    from mfas_tpu_torch.runtime import graphs

    phase("AV-MNIST (v1) found training, full width")
    base = ["--datadir", store, "--checkpointdir", work, *AV_FOUND_ARGV]
    free_card(torch)
    graphs.reset_graph_counts()
    t0 = time.time()
    run, out = _quiet(fmain.main, base + ["--save_checkpoint"])
    seconds = time.time() - t0
    gc = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    n_train = train_dev_split(AV_FOUND_STORE[0])[0]
    # a train graph per phase, replayed per batch; the dev and test splits
    # share their batch shape, so the eval graphs are captured per phase
    check(gc.get("ClassifierEngine_train") == {
        "captures": 2, "replays": 2 * -(-n_train // 128)}
        and gc.get("ClassifierEngine_eval", {}).get("captures") == 2,
        f"v1: graph counts {gc}")
    print(f"v1: graph captures and replays {gc}", flush=True)
    losses = [e["loss"] for r in run.train for e in r.epochs]
    check([r.train_clips for r in run.train] == [n_train, n_train],
          f"v1: train clips {[r.train_clips for r in run.train]}")
    check(all(np.isfinite(losses)) and np.isfinite(run.acc)
          and 0 <= run.acc <= 1, f"v1: losses {losses}, acc {run.acc}")
    check(run.saved and os.path.exists(run.saved), "v1: no checkpoint")
    again, out2 = _quiet(fmain.main, base + [
        "--test_cp", os.path.basename(run.saved)])
    check(again.train == [] and "Pretraining" not in out2,
          "v1: --test_cp trained")
    check(again.acc == run.acc, f"v1: --test_cp Model Acc {again.acc}, the "
          f"trained run's {run.acc}")
    r = {"seconds": seconds, "model_acc": run.acc,
         "test_cp_model_acc": again.acc,
         "epochs": [dict(e, phase_run=i) for i, t in enumerate(run.train)
                    for e in t.epochs],
         "train_clips_per_s": [t.train_clips / t.train_seconds
                               for t in run.train],
         "train_peak_bytes": run.train_peak_bytes,
         "eval_clips_per_s": run.eval.clips / run.eval.seconds,
         "test_cp_eval_clips_per_s": again.eval.clips / again.eval.seconds,
         "checkpoint": os.path.basename(run.saved), "graph_counts": gc}
    print(f"v1: {seconds:.1f} s; phase 1 / phase 2 train clips/s "
          f"{r['train_clips_per_s'][0]:.0f} / {r['train_clips_per_s'][1]:.0f}"
          f" (whole epochs, loader included), peak "
          + " / ".join(f"{b / 2**30:.2f}" for b in run.train_peak_bytes)
          + f" GiB; Model Acc {run.acc}, --test_cp {again.acc}; eval "
          f"{r['eval_clips_per_s']:.0f} clips/s; epochs "
          + ", ".join(f"{e['phase']} {e['loss']:.4f}/{e['acc']:.4f}"
                      for e in r["epochs"]), flush=True)
    return r


def avmnist_warm_steps(torch, work, store):
    """Warm phase-2 train steps of the (v1) net on one placed batch of 128,
    eager and then graphed (``paired_train_steps`` at AV_WARM), the graphed
    step held to the eager one from the same state (``graphed_vs_eager``);
    and the host side apart: the train ArrayLoader's batches (fancy index
    of 128 rows, 6.8 MB) placed on the card, per batch."""
    import numpy as np

    from mfas_tpu_torch import main_found_avmnist as fmain
    from mfas_tpu_torch.data.avmnist import load_avmnist_arrays
    from mfas_tpu_torch.data.loader import ArrayLoader
    from mfas_tpu_torch.engine.classifier import ClassifierEngine, place_batch

    phase("AV-MNIST warm phase-2 steps, full width, B=128")
    n_warm, n_timed, n_prof = AV_WARM
    args = fmain.parse_args(["--datadir", store, *AV_FOUND_ARGV])
    arrays = load_avmnist_arrays(store, "train")
    loader = ArrayLoader(arrays, args.batchsize, shuffle=True,
                         indices=np.arange(0, 50000))
    it = iter(loader)
    times = []
    for _ in range(n_warm + n_timed):
        t0 = time.perf_counter()
        batch = place_batch(next(it), "cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    loader_ms = float(np.median(times[n_warm:])) * 1e3

    model = fmain.build_model(args, fmain.FOUND_CONFS[0], "cuda")
    engine = ClassifierEngine(model, "cuda", multitask=args.multitask,
                              input_keys=("image", "audio"))
    engine.generator.manual_seed(SEED)
    pair = paired_train_steps(torch, work, "AV-MNIST warm phase 2", engine,
                              model, None, batch, args.eta_max, AV_WARM)
    r = dict(pair["eager"])
    r.update(train_clips_per_s=args.batchsize / r["step_ms"] * 1e3,
             loader_batch_ms=loader_ms, graphed=pair["graphed"])
    r["graphed_vs_eager"] = graphed_vs_eager(
        torch, "AV-MNIST phase 2", engine, model, None,
        [batch, place_batch(next(it), "cuda")], args.eta_max)
    r["card_state"] = card_state("after AV-MNIST warm steps")
    print(f"AV-MNIST warm phase 2: eager {r['step_ms']:.2f} ms/step, "
          f"graphed {r['graphed']['step_ms']:.2f} ms/step; ArrayLoader "
          f"batch placed on the card {loader_ms:.2f} ms", flush=True)
    del model, engine, batch, arrays
    free_card(torch)
    return r


def _cli_search(torch, smain, name, argv, want_candidates):
    """One in-process search through ``smain.main`` (a search CLI of the
    port): the candidates trained, every accuracy finite in [0, 1];
    returns the measured numbers, the run and its standard output."""
    import numpy as np

    from mfas_tpu_torch.runtime import graphs

    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_graph_counts()
    run, out = _quiet(smain.main, argv)
    graph_counts = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    accs = [a for _, entries in run.data.state() for _, a in entries]
    first = [a for L, entries in run.data.state() if L == 1
             for _, a in entries]
    check(run.candidates == want_candidates,
          f"{name}: {run.candidates} candidates, want {want_candidates}")
    check(all(np.isfinite(a) and 0 <= a <= 1 for a in accs),
          f"{name}: accuracies {accs}")
    r = {"seconds": run.seconds, "split_seconds": run.split,
         "graphs": graph_counts, "candidates": run.candidates,
         "candidates_per_hour": run.candidates / run.seconds * 3600.0,
         "peak_bytes": peak, "confs_scored": len(accs),
         "best_acc": max(accs), "first_step_distinct": len(set(first)),
         "first_step_min_max": [min(first), max(first)] if first else None,
         "top5": [[c.tolist(), float(a)] for c, a in run.top]}
    print(f"{name}: {run.candidates} candidates in {run.seconds:.1f} s, "
          f"{r['candidates_per_hour']:.0f} candidates/hour; split (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in run.split.items())
          + f"; best acc {r['best_acc']:.4f}; one-row confs "
          f"{len(first)} ({r['first_step_distinct']} distinct accuracies"
          + (f", {min(first):.4f}-{max(first):.4f}" if first else "")
          + f"); peak {peak / 2**30:.2f} GiB allocated; CUDA graph "
          f"captures / replays {graph_counts}; top-5 "
          f"{[(c.tolist(), round(float(a), 4)) for c, a in run.top]}",
          flush=True)
    return r, run, out


def avmnist_search(torch, work, store):
    """(v2) the EPNAS search at the CLI's defaults (--channels 32, hidden
    16, B=128, 3 epochs, 15 samples, 4 fusions) cut to --search_iterations
    1 (from 3; AV_SEARCH_ITERATIONS): 30 + 3 x 15 = 75 candidates, on
    streamed train-mode features; its first step's 30 accuracies must not
    all be equal and its best accuracy must beat 0.2 (chance is 0.1). (v3)
    the same with --cache_features (bf16 bank).
    (v4) --randsearch --search_iterations 1 (4 iterations of 15), its
    state copied after the first iteration, then resumed from that copy in
    a fresh main call: the resume line, the 3 remaining iterations, and
    the uninterrupted run's confs and accuracies."""
    import numpy as np

    from mfas_tpu_torch import main_searchable_avmnist as smain
    from mfas_tpu_torch.search import searcher as tsearcher

    phase("AV-MNIST (v2)-(v4) search, full width")
    base = ["--datadir", store, "--checkpointdir", work, *AV_SEARCH_ARGV]
    out = {}
    cut = ["--search_iterations", AV_SEARCH_ITERATIONS]
    r, run, _ = _cli_search(torch, smain, "v2 search", base + cut, 75)
    first = [a for L, e in run.data.state() if L == 1 for _, a in e]
    check(len(first) == 30 and r["first_step_distinct"] > 1,
          f"v2: first step accuracies {first} all equal")
    check(r["best_acc"] > 0.2, f"v2: best accuracy {r['best_acc']} <= 0.2")
    out["v2_search"] = r
    out["v3_cache_features"], _, _ = _cli_search(
        torch, smain, "v3 --cache_features", base + cut + ["--cache_features"], 75)

    state = os.path.join(work, "avmnist_rand.pkl")
    first_state = state + ".first"
    rand = base + ["--randsearch", "--search_iterations", "1",
                   "--search_state", state]
    orig = tsearcher.ModelSearcher._save_state

    def save(self, path, *a, **k):
        orig(self, path, *a, **k)
        if path and not os.path.exists(first_state):
            shutil.copy(path, first_state)

    tsearcher.ModelSearcher._save_state = save
    try:
        out["v4_randsearch"], full, _ = _cli_search(
            torch, smain, "v4 --randsearch", rand, 60)
    finally:
        tsearcher.ModelSearcher._save_state = orig
    resume = [a for a in base if a != "--no-verbose"] + [
        "--randsearch", "--search_iterations", "1", "--search_state",
        first_state, "--resume_search"]
    out["v4_resumed"], resumed, text = _cli_search(
        torch, smain, "v4 resumed", resume, 45)
    line = "Resuming random search after iteration 0"
    check(line in text, f"v4: no '{line}' in the resumed run's output")

    def pairs(data):
        return {np.asarray(c).tobytes(): a for _, e in data.state()
                for c, a in e}

    want, got = pairs(full.data), pairs(resumed.data)
    check(got.keys() == want.keys(), "v4: the resumed run trained other "
          "confs than the uninterrupted one")
    diff = max(abs(got[k] - want[k]) for k in want)
    out["v4_resumed"]["max_acc_diff_vs_uninterrupted"] = diff
    print(f"v4 resumed run printed '{line}'; its confs are the "
          f"uninterrupted run's, accuracies within {diff:.3e}")
    check(diff <= 1.0 / 900 + 1e-7, f"v4: resumed accuracies differ by "
          f"{diff} from the uninterrupted run's")
    return out


def avmnist_card_vs_cpu(torch, store):
    """(v5) The AV-MNIST device work on the card against the CPU, at full
    width: the extractor's padded taps and logits on 4 samples in f32,
    through PopulationTrainer._features, in eval mode and in the streamed
    path's train mode (batch-statistic BatchNorm), each tensor within 1e-4
    of its max |value|, every backbone buffer unchanged on both devices;
    one found phase-2 step of Searchable_Audio_Image_Net conf 0 (hidden
    256, --drpt 0, multitask) on 8 samples in float64, every gradient
    within 1e-3 of its tensor's max."""
    import numpy as np

    from mfas_tpu_torch import main_found_avmnist as fmain
    from mfas_tpu_torch import main_searchable_avmnist as smain
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.data.avmnist import load_avmnist_arrays
    from mfas_tpu_torch.engine.classifier import (WEIGHT_DECAY,
                                                  ClassifierEngine,
                                                  set_trainable)
    from mfas_tpu_torch.fusion.avmnist import (AVMnistFeatureExtractor,
                                               tap_sizes)
    from mfas_tpu_torch.search import population as pop

    phase("AV-MNIST (v5) card vs CPU (extractor taps f32, found step f64)")
    arrays = load_avmnist_arrays(store, "train")
    args = smain.parse_args(["--datadir", store, *AV_SEARCH_ARGV])
    aud, ims = tap_sizes(args)
    spec = pop.PopulationSpec(
        sizes_a=tuple(aud), sizes_b=tuple(ims),
        hidden=args.inner_representation_size, num_outputs=args.num_outputs,
        max_rows=args.max_progression_levels)
    clips = tuple(torch.from_numpy(arrays[k][:4]) for k in ("image", "audio"))
    feats = {}
    for dev in ("cuda", "cpu"):
        trainer = pop.PopulationTrainer(
            spec, AVMnistFeatureExtractor(
                args, device=dev,
                generator=torch.Generator().manual_seed(SEED)), device=dev)
        buffers = {k: v.clone() for k, v in trainer.extractor.named_buffers()}
        inputs = tuple(c.to(dev) for c in clips)
        for mode in ("eval", "train"):
            feats[mode, dev] = [t.double().cpu() for t in trainer._features(
                inputs, mode == "train")]
        check(all(torch.equal(v, buffers[k])
                  for k, v in trainer.extractor.named_buffers()),
              f"AV-MNIST train-mode feature pass on {dev} changed a buffer")
        del trainer
    tap_dev = {}
    for mode in ("eval", "train"):
        tap_dev[mode] = max(
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(feats[mode, "cuda"], feats[mode, "cpu"]))
        print(f"AV-MNIST extractor {mode} mode, 4 samples f32: largest "
              f"deviation {tap_dev[mode]:.3e} of a tensor's max")
    for mode, d in tap_dev.items():
        check(d <= 1e-4, f"AV-MNIST extractor {mode} card vs CPU: {d}")

    fargs = fmain.parse_args(["--datadir", store, *AV_FOUND_ARGV,
                              "--drpt", "0"])
    n = 8
    batch = {"image": torch.from_numpy(arrays["image"][:n]).double(),
             "audio": torch.from_numpy(arrays["audio"][:n]).double(),
             "label": torch.from_numpy(arrays["label"][:n]),
             "_mask": torch.ones(n, dtype=torch.float64)}
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        model = fmain.build_model(fargs, fmain.FOUND_CONFS[0], dev).double()
        engine = ClassifierEngine(model, dev, multitask=fargs.multitask,
                                  input_keys=("image", "audio"))
        set_trainable(model, None)
        model.train()
        opt = make_adam(model.parameters(), WEIGHT_DECAY)
        loss, _ = engine._train_step({k: v.to(dev) for k, v in batch.items()},
                                     opt, fargs.eta_max)
        losses[dev] = float(loss)
        grads[dev] = {k: p.grad.detach().cpu().double()
                      for k, p in model.named_parameters()
                      if p.grad is not None}
        print(f"AV-MNIST found step f64 on {dev}: loss {losses[dev]:.12f}, "
              f"{len(grads[dev])} grads, {time.time() - t0:.1f} s")
        del model, engine, opt
    check(grads["cuda"].keys() == grads["cpu"].keys(),
          "AV-MNIST found step: the two devices differ in gradients")
    devs = {k: float((grads["cuda"][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30))
            for k, v in grads["cpu"].items()}
    worst = max(devs, key=devs.get)
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"AV-MNIST found step f64, 8 samples: loss {loss_rel:.3e} "
          f"relative; largest gradient deviation {devs[worst]:.3e} of max "
          f"({worst}) over {len(devs)} tensors")
    check(devs[worst] <= 1e-3, f"AV-MNIST found step card vs CPU {worst}: "
          f"{devs[worst]} of max")
    free_card(torch)
    return {"extractor_tap_dev": tap_dev["eval"],
            "extractor_train_mode_tap_dev": tap_dev["train"],
            "found_step_f64_grad_dev": devs[worst],
            "found_step_f64_grad_dev_tensor": worst,
            "found_step_f64_loss_rel": loss_rel}


def avmnist_phase(torch, tk, work):
    """(v1)-(v5); the input kernels launch nowhere on this path."""
    tk.reset_launch_counts()
    out = {}
    found = write_avmnist_store(torch, os.path.join(work, "avmnist"),
                                *AV_FOUND_STORE, seed=5)
    with bn_path(torch, "avmnist_found_v1"):
        out["v1_found"] = v1 = avmnist_found(torch, work, found)
    from mfas_tpu_torch import main_found_avmnist as fmain
    # --no-multitask: Model Acc of the fused head, the served output
    out["i6_serving"] = serve(
        torch, tk, "AV-MNIST", work,
        ["avmnist", "--conf", "0", "--test_cp", v1["checkpoint"],
         "--checkpointdir", work],
        ["--datadir", found, "--batchsize", "128"],
        *found_eval(fmain.main, ["--datadir", found, "--checkpointdir", work,
                                 *AV_FOUND_ARGV, "--no-multitask",
                                 "--test_cp", v1["checkpoint"]]))
    out["warm_phase2"] = avmnist_warm_steps(torch, work, found)
    shutil.rmtree(found)
    search = write_avmnist_store(torch, os.path.join(work, "avmnist_search"),
                                 *AV_SEARCH_STORE, seed=6)
    with bn_path(torch, "avmnist_search_v2_v4"):
        out.update(avmnist_search(torch, work, search))
    out["v5_card_vs_cpu"] = avmnist_card_vs_cpu(torch, search)
    out["input_kernel_launches"] = dict(tk.launch_counts)
    check(sum(tk.launch_counts.values()) == 0,
          f"the AV-MNIST path launched {tk.launch_counts}")
    return out


# MM-IMDB: a store in the reference layout at the reference's poster size,
# cut from 15,552 / 2,608 / 7,799 samples to these
MM_SPLITS = {"train": 2048, "dev": 512, "test": 1024}
MM_POSTER = (160, 256, 3)   # stored (H, W, C); the loader makes it (3,256,160)
MM_GENRES = 23
MM_CHUNK = 256
MM_TEXT_SHIFT = 0.5         # each text row moves 0.5 along +-1 per genre
MM_ARGV = ["--text_first_hidden", "256", "--epochs", "1",
           *[a for k, n in MM_SPLITS.items()
             for a in (f"--{k}_size", str(n))]]
MM_SMALL = ["--epochs", "1", "--train_size", "256", "--dev_size", "64",
            "--test_size", "64", "--no-verbose"]
# the other four --model choices at widths each can be built at: the LeNet
# trunk grows to 16 x --channels; SimpleVT_CentralNet's classifier is 384
# wide for '13,25', which the gp5 tap (16 x 24) and the text net's second
# output (2 x 192) meet
MM_OTHERS = (("simplevt", ["--channels", "32"]),
             ("simplevt_centralnet", ["--channels", "24", "--fusingmix",
                                      "13,25", "--text_first_hidden", "192"]),
             ("vggvt", []),
             ("vggt_centralnet", ["--text_first_hidden", "256"]))
MM_WARM = (2, 8, 3)         # warm train steps: untimed, timed, profiled


def write_mmimdb_store(torch, root, seed):
    """A synthetic MM-IMDB store in the layout of mfas_tpu_torch/data/
    mm_imdb.py: U(0, 1) f32 posters, 1-2 genres of 23 per sample (as
    make_synthetic_mmimdb draws them), (T, 300) text with T in [5, 30)
    whose rows are N(0, 1) plus MM_TEXT_SHIFT times a fixed +-1 direction
    per genre of the sample, so the averaged text carries the labels and
    one epoch can beat predicting every genre. Drawn on ``device`` in
    chunks of MM_CHUNK samples."""
    import numpy as np

    t0 = time.time()
    g = torch.Generator(device="cuda").manual_seed(seed)
    dirs = torch.randint(0, 2, (MM_GENRES, 300), device="cuda",
                         generator=g).float() * 2 - 1
    for split, n in MM_SPLITS.items():
        base = os.path.join(root, split)
        os.makedirs(base)
        for lo in range(0, n, MM_CHUNK):
            m = min(n, lo + MM_CHUNK) - lo
            images = torch.rand((m, *MM_POSTER), device="cuda",
                                generator=g).cpu().numpy()
            labels = torch.zeros((m, MM_GENRES), device="cuda")
            labels.scatter_(1, torch.randint(0, MM_GENRES, (m, 2),
                                             device="cuda", generator=g), 1.0)
            lens = torch.randint(5, 30, (m,), device="cuda", generator=g)
            text = (torch.randn((m, 30, 300), device="cuda", generator=g)
                    + MM_TEXT_SHIFT * (labels @ dirs)[:, None, :])
            labels, lens, text = (x.cpu().numpy() for x in (labels, lens,
                                                            text))
            for i in range(m):
                name = "{:06}.npy".format(lo + i)
                np.save(os.path.join(base, "image_" + name), images[i])
                np.save(os.path.join(base, "label_" + name), labels[i])
                np.save(os.path.join(base, "text_" + name),
                        text[i, :lens[i]])
    print(f"MM-IMDB store {MM_SPLITS} written in {time.time() - t0:.1f} s")
    return root


def all_genres_f1(root, split):
    """The samples-F1 of predicting every genre for each sample."""
    import numpy as np

    from mfas_tpu_torch.data.mm_imdb import samples_f1

    labels = np.stack([np.load(os.path.join(root, split,
                                            "label_{:06}.npy".format(i)))
                       for i in range(MM_SPLITS[split])]) > 0.5
    return samples_f1(labels, np.ones_like(labels))


def _mm_graphs(train, dev, test, epochs=1):
    """The graph counts of a found MM-IMDB run over splits of ``train``,
    ``dev`` and ``test`` full batches (no training when ``train`` is 0):
    one train graph replayed per train batch; one eval graph (dev and test
    batches share their shapes at averaged text) replayed per dev and test
    batch."""
    want = {"MMIMDBEngine_eval": {"captures": 1,
                                  "replays": epochs * dev + test}}
    if train:
        want["MMIMDBEngine_train"] = {"captures": 1,
                                      "replays": epochs * train}
    return want


def _mmimdb_run(torch, name, argv, want_graphs):
    """One in-process ``mfas_tpu_torch.main_found_mmimdb`` run: its train
    and dev epochs (finite losses), test samples-F1 in [0, 1], wall time,
    samples/s, peak allocated memory and its engine's graph captures and
    replays, which must be ``want_graphs``."""
    import numpy as np

    from mfas_tpu_torch import main_found_mmimdb as mmain
    from mfas_tpu_torch.runtime import graphs

    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_graph_counts()
    t0 = time.time()
    run, out = _quiet(mmain.main, argv)
    seconds = time.time() - t0
    gc = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    check(gc == want_graphs, f"{name}: graph counts {gc}, want {want_graphs}")
    epochs = [e for r in run.train for e in r.epochs]
    losses = [e["loss"] for e in epochs if e["phase"] == "train"]
    check(all(np.isfinite(losses)) and 0.0 <= run.acc <= 1.0,
          f"{name}: losses {losses}, Model F1 {run.acc}")
    check(f"Model F1: {run.acc}" in out, f"{name}: no Model F1 line")
    r = {"seconds": seconds, "model_f1": run.acc, "epochs": epochs,
         "dev_f1": [e["f1"] for e in epochs if e["phase"] == "dev"],
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "eval_samples_per_s": run.eval.clips / run.eval.seconds,
         "saved": run.saved, "graphs": gc}
    if run.train:
        t = run.train[0]
        r["train_samples_per_s"] = t.train_clips / t.train_seconds
    print(f"{name}: {seconds:.1f} s; Model F1 {run.acc}; epochs "
          + ", ".join(f"{e['phase']} " + (f"loss {e['loss']:.4f}"
                                          if "loss" in e
                                          else f"F1 {e['f1']:.4f}")
                      for e in epochs)
          + (f"; {r['train_samples_per_s']:.0f} train samples/s (epoch, "
             f"loader included)" if run.train else "")
          + f"; test {r['eval_samples_per_s']:.0f} samples/s; peak "
          f"{r['peak_bytes'] / 2**30:.2f} GiB allocated; graph captures / "
          f"replays {json.dumps(gc)}", flush=True)
    return r, run


def mmimdb_found(torch, work, store):
    """(m1) the default model at full width (VGG-19 on 3x256x160 posters,
    --channels 512, --text_first_hidden 256, B=64) for one epoch with
    --save_checkpoint, then --test_cp of the file (the same Model F1, no
    training); dev F1 above the all-genres F1. (m2) --central_only: the
    non-central parameters as built, some central one moved. (m4) the other four --model choices
    for one epoch on 256/64/64 samples."""
    from mfas_tpu_torch import main_found_mmimdb as mmain
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    phase("MM-IMDB (m1) default model, full width")
    base = ["--datadir", store, "--checkpointdir", work]
    out = {}
    batches = {k: n // 64 for k, n in MM_SPLITS.items()}
    r, run = _mmimdb_run(torch, "m1", base + MM_ARGV + ["--save_checkpoint"],
                         _mm_graphs(**batches))
    floor = all_genres_f1(store, "dev")
    r["all_genres_dev_f1"] = floor
    check(r["dev_f1"][0] > floor, f"m1: dev F1 {r['dev_f1'][0]} not above "
          f"the all-genres F1 {floor}")
    again, _ = _mmimdb_run(torch, "m1 --test_cp", base + MM_ARGV + [
        "--test_cp", os.path.basename(run.saved)],
        _mm_graphs(0, 0, batches["test"]))
    check(again["epochs"] == [] and again["model_f1"] == r["model_f1"],
          f"m1: --test_cp Model F1 {again['model_f1']}, the trained run's "
          f"{r['model_f1']}")
    r["test_cp"] = again
    print(f"m1: dev F1 {r['dev_f1'][0]:.4f} against {floor:.4f} for every "
          f"genre; --test_cp printed the same Model F1", flush=True)
    out["m1_default"] = r

    phase("MM-IMDB (m2) --central_only")
    m2 = os.path.join(work, "m2")
    os.makedirs(m2)
    r, run = _mmimdb_run(torch, "m2", ["--datadir", store, "--checkpointdir",
                                       m2, *MM_ARGV, "--central_only",
                                       "--save_checkpoint"],
                         _mm_graphs(**batches))
    built = mmain.build_model(mmain.parse_args(MM_ARGV), "cpu")
    central = tuple(built.central_params())
    saved = load_state_dict(run.saved)
    frozen = [n for n, p in built.named_parameters()
              if not n.startswith(central)]
    check(all(torch.equal(saved[n], p.detach()) for n, p in
              built.named_parameters() if n in frozen),
          "m2: --central_only moved a non-central parameter")
    trained = {n: p for n, p in built.named_parameters()
               if n.startswith(central)}
    moved = [n for n, p in trained.items()
             if not torch.equal(saved[n], p.detach())]
    check(moved, "m2: --central_only saved every central parameter as built")
    r["central_moved"] = f"{len(moved)} of {len(trained)}"
    print(f"m2: the {len(frozen)} non-central parameters as built, "
          f"{len(moved)} of the {len(trained)} central ones moved")
    out["m2_central_only"] = r

    phase("MM-IMDB (m4) the other --model choices, one epoch on 256")
    for model, extra in MM_OTHERS:
        out[f"m4_{model}"], _ = _mmimdb_run(
            torch, f"m4 {model}", base + ["--model", model, *extra,
                                          *MM_SMALL], _mm_graphs(4, 1, 1))
    return out


def mmimdb_warm_steps(torch, work, store):
    """(m3) warm train steps of the (m1) net on one placed batch of 64,
    whole net and --central_only, eager and then graphed in one call
    (``paired_train_steps`` at MM_WARM: median ms, peak allocated and
    reserved memory, busy share and kernels per step), the graphed
    whole-net step held to the eager one from the same state under cuDNN's
    deterministic algorithms (``graphed_vs_eager``, dropout on); the host
    side apart: the
    train MMIMDBLoader's batch (64 posters read and collated, placed on the
    card)."""
    import numpy as np

    from mfas_tpu_torch import main_found_mmimdb as mmain
    from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader
    from mfas_tpu_torch.engine.classifier import place_batch
    from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine

    phase("MM-IMDB (m3) warm train steps, full width, B=64")
    n_warm, n_timed, _ = MM_WARM
    args = mmain.parse_args(["--datadir", store, *MM_ARGV])
    loader = MMIMDBLoader(MM_IMDB(store, stage="train", feat_dim=300,
                                  average_text=True,
                                  len_data=MM_SPLITS["train"]),
                          args.batchsize, shuffle=True)
    it = iter(loader)
    times = []
    for _ in range(n_warm + n_timed):
        t0 = time.perf_counter()
        batch = place_batch(next(it), "cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"loader_batch_ms": float(np.median(times[n_warm:])) * 1e3,
           "loader_batch_ms_all": [t * 1e3 for t in times]}

    model = mmain.build_model(args, "cuda")
    engine = MMIMDBEngine(model, "cuda")
    engine.generator.manual_seed(SEED)
    check(engine.graphed, "m3: the MM-IMDB engine is not graphed")
    for name, prefixes in (("whole", None),
                           ("central", model.central_params())):
        pair = paired_train_steps(torch, work, f"m3 {name}", engine, model,
                                  prefixes, batch, args.eta_max, MM_WARM)
        r = dict(pair["eager"])
        r["train_samples_per_s"] = args.batchsize / r["step_ms"] * 1e3
        r["graphed"] = pair["graphed"]
        r["card_state"] = card_state(f"after MM-IMDB warm {name} steps")
        if name == "whole":
            r["graphed_vs_eager"] = graphed_vs_eager(
                torch, f"m3 {name}", engine, model, prefixes, [batch, batch],
                args.eta_max)
        out[name] = r
    print(f"m3: MMIMDBLoader batch of 64 posters read, collated and placed "
          f"on the card {out['loader_batch_ms']:.2f} ms", flush=True)
    del model, engine, batch
    free_card(torch)
    out["m6_text_lengths"] = mmimdb_text_lengths(torch)
    return out


MM_TEXT_LENGTHS = (8, 16)   # (m6): the two pow-2 buckets alternating


def padded_mm(torch):
    """(m6)'s padded-sequence MM-IMDB net and batches: (args, a function
    that makes the net from SEED, the batches). The net is
    ``models/mm_imdb.py::SimpleRecurrentModel`` over (B, T, 300) GloVe-like
    rows, its lengths read from the -10 fill, plus a linear head on the
    3x256x160 poster's mean colour and a dead head the loss never reaches;
    the batches alternate MM_TEXT_LENGTHS twice, at the CLI's batch size."""
    from torch import nn

    from mfas_tpu_torch import main_found_mmimdb as mmain
    from mfas_tpu_torch.core import layers as L
    from mfas_tpu_torch.data.mm_imdb import TEXT_PAD_VALUE
    from mfas_tpu_torch.models.mm_imdb import SimpleRecurrentModel

    class PaddedNet(nn.Module):
        def __init__(self, args, generator):
            super().__init__()
            kw = dict(device="cuda", generator=generator)
            self.text = SimpleRecurrentModel(args, 100, 300, **kw)
            self.image = L.Linear(3, args.num_outputs, **kw)
            self.dead = L.Linear(3, args.num_outputs, **kw)

        def forward(self, text, image):
            lengths = (text != TEXT_PAD_VALUE).any(-1).sum(1)
            pooled = image.mean(dim=(2, 3))
            return self.dead(pooled), self.text(text, lengths) + self.image(
                pooled)

    args = mmain.parse_args([])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B = args.batchsize
    batches = []
    for T in MM_TEXT_LENGTHS * 2:
        lengths = torch.randint(T // 2 + 1, T + 1, (B, 1), device="cuda",
                                generator=g)
        rows = torch.arange(T, device="cuda")[None, :] < lengths
        text = torch.where(rows[..., None],
                           torch.randn((B, T, 300), device="cuda",
                                       generator=g), TEXT_PAD_VALUE)
        label = torch.zeros((B, MM_GENRES), device="cuda")
        label.scatter_(1, torch.randint(0, MM_GENRES, (B, 2), device="cuda",
                                        generator=g), 1.0)
        batches.append({
            "text": text, "label": label, "_mask": torch.ones(B, device="cuda"),
            "image": torch.rand((B, 3, MM_POSTER[1], MM_POSTER[0]),
                                device="cuda", generator=g),
            "textlen": lengths[:, 0].int()})
    return (args, lambda: PaddedNet(args, torch.Generator().manual_seed(SEED)),
            batches)


def mmimdb_text_lengths(torch):
    """(m6) ``MMIMDBEngine`` at the library level over ``padded_mm``'s net,
    train batches alternating MM_TEXT_LENGTHS: one train graph per length,
    both alive on one set of gradients, each replayed; one eval graph per
    length; the dead head without a gradient; held to the eager engine
    under ``graphed_vs_eager`` (dropout 0.666 on)."""
    from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
    from mfas_tpu_torch.runtime import graphs

    phase("MM-IMDB (m6) two text lengths through one graphed engine")
    args, build, batches = padded_mm(torch)
    model = build()
    engine = MMIMDBEngine(model, "cuda")
    engine.generator.manual_seed(SEED)
    graphs.reset_graph_counts()
    model.train()
    opt = engine.make_optimizer()
    losses = [float(engine.train_step(b, opt, args.eta_max)[0])
              for b in batches]
    held = engine._programs["train"]._held
    check(len(engine._programs["train"]) == len(MM_TEXT_LENGTHS)
          and all(p.grad is t for p, t in held.items())
          and model.dead.weight.grad is None,
          "m6: the train graphs do not share one set of gradients, or the "
          "dead head got one")
    gc = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    n = len(MM_TEXT_LENGTHS)
    check(gc == {"MMIMDBEngine_train": {"captures": n,
                                        "replays": len(batches)}},
          f"m6: graph counts {gc}")
    engine.release_graphs()
    r = {"losses": losses, "graphs": gc}
    r["graphed_vs_eager"] = graphed_vs_eager(
        torch, "m6 two text lengths", engine, model, None, batches,
        args.eta_max, eval_batches=batches[:n])
    print(f"m6: lengths {list(MM_TEXT_LENGTHS)} alternating, losses "
          f"{[round(x, 4) for x in losses]}, graph captures / replays "
          f"{json.dumps(gc)}", flush=True)
    del model, engine, batches
    free_card(torch)
    return r


# A gradient vanishes analytically, holding only rounding noise, where its
# parameter reaches the loss only as a per-channel constant ahead of a
# train-mode BatchNorm1d. V2's conv 34 bias reaches the loss only through
# ReLU 35, maxpool 36, the gp4 tap and bn4: its gradient on channel c is
# sum_i g_ic * s_ic, where the g_ic, bn4's input gradient, sum to 0 over
# the batch and s_ic is the share of sample i's pool windows whose max
# passes the ReLU. It vanishes where each channel's s_ic is the same in
# every sample; (m5) prints in how many channels it is. A tensor whose CPU
# gradient is below this fraction of the step's largest (f64 rounding
# noise of sums over the batch and the poster) is named with its max on
# both devices; it is not held to its own max, but must stay below that
# floor on the card too. Every other tensor is within 1e-3 of its max.
VANISHING = 1e-12


def mmimdb_card_vs_cpu(torch, store):
    """(m5) The MM-IMDB device work on the card against the CPU: the
    default net's VGG taps and three heads in eval mode on 2 posters in
    f32, each tensor within 1e-4 of its max |value|; one whole-net train
    step (MaxOut_MLP dropout 0) on 4 posters in float64 (train-mode
    BatchNorm1d over 4 samples is ill-conditioned in f32), every gradient
    within 1e-3 of its tensor's max apart from those that vanish on the
    CPU (VANISHING); SimpleRecurrentModel over a padded batch of 4 GloVe
    sequences in f32, within 1e-4 of max."""
    import numpy as np

    from mfas_tpu_torch import main_found_mmimdb as mmain
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader
    from mfas_tpu_torch.engine.classifier import set_trainable
    from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
    from mfas_tpu_torch.models.mm_imdb import SimpleRecurrentModel

    phase("MM-IMDB (m5) card vs CPU (taps and heads f32, step f64, GRU f32)")
    args = mmain.parse_args(["--datadir", store, *MM_ARGV])

    def first(n, average_text=True):
        ds = MM_IMDB(store, stage="train", feat_dim=300,
                     average_text=average_text, len_data=n)
        b = next(iter(MMIMDBLoader(ds, n)))
        return {k: torch.from_numpy(v) for k, v in b.items()}

    def rel_dev(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))

    def no_dropout(model):
        for op in ("op2", "op4"):
            getattr(model.text_net, op)[1].p = 0.0
        return model

    out = {}
    b2 = first(2)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = mmain.build_model(args, dev).eval()
        with torch.no_grad():
            img = b2["image"].to(dev)
            taps = model.image_net(img)[:4]
            heads = model(b2["text"].to(dev), img)
        outs[dev] = [t.cpu() for t in (*taps, *heads)]
        del model
    devs = [rel_dev(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
    out["eval_f32_dev"] = max(devs)
    print(f"m5 taps gp1-gp4 and heads (text, image, fusion), 2 posters f32: "
          f"deviations {', '.join(f'{d:.3e}' for d in devs)} of max")
    check(max(devs) <= 1e-4, f"m5: eval card vs CPU {devs}")

    b4 = {k: (v.double() if v.is_floating_point() else v)
          for k, v in first(4).items()}
    grads, losses, shares = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        model = no_dropout(mmain.build_model(args, dev).double())
        # per poster and channel, the share of pool windows whose max
        # passes conv 34's ReLU (the gp4 tap's input)
        hook = model.image_net.vgg[36].register_forward_hook(
            lambda m, i, o, dev=dev: shares.__setitem__(
                dev, (o > 0).double().mean((2, 3)).cpu()))
        engine = MMIMDBEngine(model, dev)
        set_trainable(model, None)
        model.train()
        opt = make_adam(model.parameters(), engine.weight_decay)
        losses[dev] = float(engine._train_step(
            {k: v.to(dev) for k, v in b4.items()}, opt, args.eta_max))
        hook.remove()
        grads[dev] = {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters() if p.grad is not None}
        print(f"m5 whole-net step f64 on {dev}: loss {losses[dev]:.12f}, "
              f"{len(grads[dev])} grads, {time.time() - t0:.1f} s",
              flush=True)
        del model, engine, opt
    check(grads["cuda"].keys() == grads["cpu"].keys(),
          "m5: the two devices differ in gradients")
    largest = max(float(v.abs().max()) for v in grads["cpu"].values())
    floor = VANISHING * largest
    vanished = {k: {"cpu_max": float(v.abs().max()),
                    "card_max": float(grads["cuda"][k].abs().max())}
                for k, v in grads["cpu"].items()
                if float(v.abs().max()) < floor}
    devs = {k: float((grads["cuda"][k] - v).abs().max() / v.abs().max())
            for k, v in grads["cpu"].items() if k not in vanished}
    worst = max(devs, key=devs.get)
    equal = {dev: int((s == s[0]).all(0).sum()) for dev, s in shares.items()}
    out["step_f64_loss_rel"] = abs(losses["cuda"] - losses["cpu"]) / abs(
        losses["cpu"])
    out["step_f64_grad_dev"], out["step_f64_grad_dev_tensor"] = (devs[worst],
                                                                  worst)
    out["step_f64_largest_grad"] = largest
    out["step_f64_vanished"] = vanished
    out["conv34_equal_share_channels"] = equal
    print(f"m5 step f64, 4 posters: loss {out['step_f64_loss_rel']:.3e} "
          f"relative; largest gradient deviation {devs[worst]:.3e} of max "
          f"({worst}) over {len(devs)} tensors; the largest gradient "
          f"{largest:.3e}")
    for k, v in vanished.items():
        print(f"m5 vanished, not compared: {k} max |grad| {v['cpu_max']:.3e} "
              f"on the CPU, {v['card_max']:.3e} on the card (floor "
              f"{floor:.3e})")
    print(f"m5 conv 34's ReLU share per channel the same in all 4 posters: "
          f"{equal['cpu']} of {shares['cpu'].shape[1]} channels on the CPU, "
          f"{equal['cuda']} on the card")
    check(devs[worst] <= 1e-3, f"m5: step card vs CPU {worst}: "
          f"{devs[worst]}")
    check(all(v["card_max"] < floor for v in vanished.values()),
          f"m5: a gradient vanished on the CPU but not on the card: "
          f"{vanished}")

    padded = first(4, average_text=False)
    rnn = {}
    for dev in ("cuda", "cpu"):
        model = SimpleRecurrentModel(
            args, number_input_feats=300, device=dev,
            generator=torch.Generator().manual_seed(SEED)).eval()
        with torch.no_grad():
            rnn[dev] = model(padded["text"].to(dev),
                             padded["textlen"].to(dev)).cpu()
    out["recurrent_f32_dev"] = rel_dev(rnn["cuda"], rnn["cpu"])
    print(f"m5 SimpleRecurrentModel over text {tuple(padded['text'].shape)} "
          f"(lengths {padded['textlen'].tolist()}), f32: deviation "
          f"{out['recurrent_f32_dev']:.3e} of max")
    check(out["recurrent_f32_dev"] <= 1e-4,
          f"m5: SimpleRecurrentModel card vs CPU {out['recurrent_f32_dev']}")
    free_card(torch)
    return out


def mmimdb_phase(torch, tk, work):
    """(m1)-(m5); the input kernels launch nowhere on this path."""
    tk.reset_launch_counts()
    store = write_mmimdb_store(torch, os.path.join(work, "mmimdb"), seed=7)
    out = mmimdb_found(torch, work, store)
    from mfas_tpu_torch import main_found_mmimdb as mmain
    cp = os.path.basename(out["m1_default"]["saved"])
    out["i6_serving"] = serve(
        torch, tk, "MM-IMDB", work,
        ["mmimdb", "--text_first_hidden", "256", "--test_cp", cp,
         "--checkpointdir", work],
        ["--datadir", store, "--len_data", str(MM_SPLITS["test"]),
         "--batchsize", "64"],
        *found_eval(mmain.main, ["--datadir", store, "--checkpointdir", work,
                                 *MM_ARGV, "--test_cp", cp]))
    out["m3_warm"] = mmimdb_warm_steps(torch, work, store)
    out["m5_card_vs_cpu"] = mmimdb_card_vs_cpu(torch, store)
    shutil.rmtree(store)
    out["input_kernel_launches"] = dict(tk.launch_counts)
    check(sum(tk.launch_counts.values()) == 0,
          f"the MM-IMDB path launched {tk.launch_counts}")
    return out


# CIFAR: cifar-10-batches-py stores drawn on the card, the CLIs' defaults
# otherwise (--planes 36, --net_str 1 1 2 1 1 2 1 1, B=128)
# (c1): 2,500 images per data_batch file (12,500: 11,250 train, 1,250
# dev), test 5,000, so the script keeps within its time with phases (d) and
# (bench)
CIFAR_FOUND_STORE = (2500, 5000)        # images per data_batch file, test
CIFAR_SEARCH_STORE = (512, 16)          # 2,560 train: 2,304 train, 256 dev
CIFAR_FOUND_ARGV = ["--epochs", "1", "--use_intermediate"]
CIFAR_SEARCH_ARGV = ["--epochs", "1", "--search_iterations", "1",
                     "--max_fusions", "2", "--num_samples", "4",
                     "--no-verbose", "--seed", str(SEED)]
CIFAR_WS_ROWS = 4           # (c4): the first step cut to this many rows
# (c3): the first step's block rows cut to the first 12 of the 80, so the
# script keeps near its time with phases (i) and (d) added
CIFAR_SEARCH_ROWS = 12
CIFAR_WARM = (3, 10, 3)     # warm train steps: untimed, timed, profiled
CIFAR_STEP_IMAGES = 16      # (c5) the f64 step's batch
CIFAR_DROPPATH_DRAWS = 2000


def write_cifar_store(torch, root, per_file, n_test, seed):
    """A cifar-10-batches-py store (5 train files of ``per_file`` images,
    a test file of ``n_test``) in the layout of mfas_tpu_torch/data/
    cifar.py, drawn on the card: uniform labels over 10 classes, each
    image uint8 noise U[0, 128) plus its class's colour, a shift in
    [0, 128) per channel drawn once, so one epoch can learn the classes."""
    import pickle

    t0 = time.time()
    g = torch.Generator(device="cuda").manual_seed(seed)
    colours = torch.randint(0, 128, (10, 3, 1), device="cuda", generator=g)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name, n in [(f"data_batch_{i}", per_file) for i in range(1, 6)] + [
            ("test_batch", n_test)]:
        labels = torch.randint(0, 10, (n,), device="cuda", generator=g)
        noise = torch.randint(0, 128, (n, 3, 1024), device="cuda",
                              generator=g)
        data = (noise + colours[labels]).to(torch.uint8).reshape(n, 3072)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": data.cpu().numpy(),
                         b"labels": labels.cpu().tolist()}, f)
    print(f"CIFAR store of 5 x {per_file} train + {n_test} test images "
          f"written in {time.time() - t0:.1f} s", flush=True)
    return root


def cifar_found(torch, work, store):
    """(c1) ``mfas_tpu_torch.main_found_cifar`` at the CLI's defaults
    (fixed mode, --planes 36 doubling to 144, 8 cells, B=128, --drop_path
    0.1 --drop_prob 0.2) with --epochs 1 --use_intermediate
    --save_checkpoint on 11,250 / 1,250 / 5,000 images: finite losses,
    Model Acc above 0.2 (chance is 0.1), the checkpoint loads into a fresh
    net with strict keys."""
    import numpy as np

    from mfas_tpu_torch import main_found_cifar as fmain
    from mfas_tpu_torch.data.cifar import train_split
    from mfas_tpu_torch.runtime import graphs
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    phase("CIFAR (c1) found net, full width")
    free_card(torch)
    graphs.reset_graph_counts()
    t0 = time.time()
    run, out = _quiet(fmain.main, ["--data_dir", store, "--checkpointdir",
                                   work, *CIFAR_FOUND_ARGV,
                                   "--save_checkpoint"])
    seconds = time.time() - t0
    gc = {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
    n_train = train_split(CIFAR_FOUND_STORE[0] * 5)[0]
    check(gc.get("CifarEngine_train") == {
        "captures": 1, "replays": -(-n_train // 128)},
        f"c1: graph counts {gc}")
    print(f"c1: graph captures and replays {gc}", flush=True)
    epochs = run.train[0].epochs
    losses = [e["loss"] for e in epochs]
    check(all(np.isfinite(losses)) and run.acc > 0.2,
          f"c1: losses {losses}, Model Acc {run.acc}")
    check(f"Model Acc: {run.acc}" in out, "c1: no Model Acc line")
    args = fmain.parse_args([])
    fresh = fmain.build_model(args, fmain.parse_conf(args.conf), "cpu")
    fresh.load_state_dict(load_state_dict(run.saved), strict=True)
    check(args.planes == 144, f"c1: --planes ended at {args.planes}")
    t = run.train[0]
    r = {"seconds": seconds, "model_acc": run.acc, "epochs": epochs,
         "train_samples_per_s": t.train_clips / t.train_seconds,
         "train_seconds": t.train_seconds,
         "peak_bytes": run.train_peak_bytes[0],
         "eval_samples_per_s": run.eval.clips / run.eval.seconds,
         "checkpoint": os.path.basename(run.saved),
         "parameters": sum(p.numel() for p in fresh.parameters()),
         "graph_counts": gc}
    print(f"c1: {seconds:.1f} s; Model Acc {run.acc}; epochs "
          + ", ".join(f"{e['phase']} {e['loss']:.4f}/{e['acc']:.4f}"
                      for e in epochs)
          + f"; {r['train_samples_per_s']:.0f} train samples/s (the epoch, "
          f"loader included), peak {r['peak_bytes'] / 2**30:.2f} GiB "
          f"allocated; test {r['eval_samples_per_s']:.0f} samples/s; "
          f"{r['parameters']} parameters; {run.saved} loads strict",
          flush=True)
    return r


def cifar_warm_steps(torch, work, store):
    """(c2) warm train steps of the (c1) net (--use_intermediate, train-
    mode DropPath and dropout) on one placed batch of 128, eager and then
    graphed (``paired_train_steps`` at CIFAR_WARM); the eager steps with
    torch's plain Adam step in place of the engine's skip of all-zero
    gradients; the graphed step held to the eager one from the same state
    (``graphed_vs_eager``: DropPath's draws and the skip inside the graph);
    and the host side apart: the train CifarLoader's batch (128 images
    cropped, flipped and normalized in numpy) placed on the card."""
    import numpy as np

    from mfas_tpu_torch import main_found_cifar as fmain
    from mfas_tpu_torch.data.cifar import (CifarLoader, load_cifar10_arrays,
                                           train_split)
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.engine.classifier import place_batch

    phase("CIFAR (c2) warm train steps, full width, B=128")
    n_warm, n_timed, n_prof = CIFAR_WARM
    args = fmain.parse_args(["--data_dir", store, *CIFAR_FOUND_ARGV])
    arrays = load_cifar10_arrays(store)
    loader = CifarLoader(arrays, args.batchsize, train=True,
                         indices=np.arange(0, train_split(
                             arrays["image"].shape[0])[0]))
    it = iter(loader)
    times = []
    for _ in range(n_warm + n_timed):
        t0 = time.perf_counter()
        batch = place_batch(next(it), "cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    loader_ms = float(np.median(times[n_warm:])) * 1e3

    model = fmain.build_model(args, fmain.parse_conf(args.conf), "cuda")
    engine = CifarEngine(model, "cuda", use_intermediate=True)
    engine.generator.manual_seed(SEED)
    pair = paired_train_steps(torch, work, "c2 warm", engine, model, None,
                              batch, args.eta_max, CIFAR_WARM)
    r = dict(pair["eager"])
    r.update(train_samples_per_s=args.batchsize / r["step_ms"] * 1e3,
             loader_batch_ms=loader_ms, graphed=pair["graphed"])
    # what the JAX package's skip-on-zero Adam rule costs: the same eager
    # steps with torch's plain Adam step (every parameter with a grad
    # stepped)
    engine._optimizer_step = lambda o: o.step()
    plain = paired_train_steps(torch, work, "c2 plain Adam", engine, model,
                               None, batch, args.eta_max,
                               (1, CIFAR_WARM[1], 1), graphed=False)
    r["plain_adam_step_ms"] = plain["eager"]["step_ms"]
    del engine._optimizer_step
    r["graphed_vs_eager"] = graphed_vs_eager(
        torch, "c2", engine, model, None,
        [batch, place_batch(next(it), "cuda")], args.eta_max)
    r["card_state"] = card_state("after CIFAR warm steps")
    print(f"c2: eager {r['step_ms']:.2f} ms/step, graphed "
          f"{r['graphed']['step_ms']:.2f} ms/step, "
          f"{r['train_samples_per_s']:.0f} train samples/s eager; "
          f"CifarLoader batch placed on the card {loader_ms:.2f} ms; with "
          f"torch's plain Adam step {r['plain_adam_step_ms']:.2f} ms/step "
          "eager", flush=True)
    del model, engine, batch, arrays
    free_card(torch)
    return r


def cifar_search(torch, work, store):
    """(c3) the EPNAS search at --planes 36 and the default --net_str
    (search mode: cells sum their blocks, no plane doubling), B=128, cut to
    --epochs 1 --search_iterations 1 --max_fusions 2 --num_samples 4 and
    to the first CIFAR_SEARCH_ROWS of the 80 one-block rows: those
    one-block confs, then 4 sampled two-block confs, each a whole net trained on
    2,304 images and ranked on 256. Its state is copied after
    the first step and resumed from that copy: the resume line, 4
    candidates, the uninterrupted run's confs, and its accuracies within
    one dev image (cuDNN's deterministic algorithms are on for both runs).
    (c4) a --weightsharing run of one step over CIFAR_WS_ROWS of the 80
    rows: the store it leaves holds the last candidate's keys only."""
    import numpy as np

    from mfas_tpu_torch import main_searchable_cifar as smain
    from mfas_tpu_torch.data.cifar import train_split
    from mfas_tpu_torch.fusion import cifar as f_cifar
    from mfas_tpu_torch.search import searcher as tsearcher
    from mfas_tpu_torch.search import trainers as ttrainers

    phase("CIFAR (c3) cut EPNAS search, full width")
    base = ["--data_dir", store, "--checkpointdir", work,
            *CIFAR_SEARCH_ARGV]
    state = os.path.join(work, "cifar_search.pkl")
    first_state = state + ".first"
    orig = tsearcher.ModelSearcher._save_state

    def save(self, path, *a, **k):
        orig(self, path, *a, **k)
        if path and not os.path.exists(first_state):
            shutil.copy(path, first_state)

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tsearcher.ModelSearcher._save_state = save
    layer_confs = f_cifar.get_possible_layer_configurations
    cut = layer_confs(0)[:CIFAR_SEARCH_ROWS]
    f_cifar.get_possible_layer_configurations = (
        lambda i: cut if i == 0 else layer_confs(i))
    try:
        out["c3_search"], full, _ = _cli_search(
            torch, smain, "c3 search", base + ["--search_state", state],
            CIFAR_SEARCH_ROWS + 4)
        tsearcher.ModelSearcher._save_state = orig
        resume = [a for a in base if a != "--no-verbose"] + [
            "--search_state", first_state, "--resume_search"]
        out["c3_resumed"], resumed, text = _cli_search(
            torch, smain, "c3 resumed", resume, 4)
    finally:
        tsearcher.ModelSearcher._save_state = orig
        f_cifar.get_possible_layer_configurations = layer_confs
        torch.backends.cudnn.deterministic = deterministic
    check(out["c3_search"]["first_step_distinct"] > 1,
          "c3: the first step's accuracies are all equal")
    line = "Resuming search after iteration 0 step 0"
    check(line in text, f"c3: no '{line}' in the resumed run's output")

    def pairs(data):
        return {np.asarray(c).tobytes(): a for _, e in data.state()
                for c, a in e}

    want, got = pairs(full.data), pairs(resumed.data)
    check(got.keys() == want.keys(), "c3: the resumed run trained other "
          "confs than the uninterrupted one")
    diff = max(abs(got[k] - want[k]) for k in want)
    out["c3_resumed"]["max_acc_diff_vs_uninterrupted"] = diff
    print(f"c3 resumed run printed '{line}'; its confs are the "
          f"uninterrupted run's, accuracies within {diff:.3e}", flush=True)
    check(diff <= 1.0 / 256 + 1e-7, f"c3: resumed accuracies differ by "
          f"{diff} from the uninterrupted run's")
    # every candidate captured its own train graph (JAX compiles each) and
    # replayed it once per train batch
    n_batches = -(-train_split(CIFAR_SEARCH_STORE[0] * 5)[0] // 128)
    for name, n in (("c3_search", CIFAR_SEARCH_ROWS + 4), ("c3_resumed", 4)):
        g = out[name]["graphs"].get("CifarEngine_train", {})
        check(g == {"captures": n, "replays": n * n_batches},
              f"{name}: CifarEngine_train graphs {g}, want {n} captures and "
              f"{n * n_batches} replays")
    out["c3_capture_cost"] = cifar_capture_cost(
        torch, smain.parse_args(base), cut[0])

    phase("CIFAR (c4) a sequential --weightsharing step")
    rows = layer_confs(0)[:CIFAR_WS_ROWS]
    ws_state = os.path.join(work, "cifar_ws.pkl")
    f_cifar.get_possible_layer_configurations = lambda i: rows
    try:
        out["c4_weightsharing"], _, _ = _cli_search(
            torch, smain, "c4 --weightsharing",
            base + ["--max_fusions", "1", "--num_samples", "2",
                    "--weightsharing", "--search_state", ws_state],
            CIFAR_WS_ROWS)
    finally:
        f_cifar.get_possible_layer_configurations = layer_confs
    store_keys = set(tsearcher.ModelSearcher.load_state(ws_state)[
        "shared_weights"])
    last = f_cifar.Searchable_MicroCNN(
        smain.parse_args(base), np.asarray(rows[-1]), device="cpu",
        generator=torch.Generator())
    want_keys = set(ttrainers.get_cifar_states(last))
    check(store_keys == want_keys, f"c4: the store holds "
          f"{sorted(store_keys ^ want_keys)} against the last candidate's "
          f"keys")
    out["c4_weightsharing"]["store_keys"] = len(store_keys)
    print(f"c4: the store holds the last candidate's {len(store_keys)} "
          f"keys only", flush=True)
    return out


def cifar_capture_cost(torch, args, conf):
    """What a (c3) candidate's graphs cost against the steps they save: the
    candidate net of ``conf`` (search mode, --planes 36) at B=128 on one
    batch of (c3)'s store; the first graphed train step (two warm-up
    steps, the capture and one replay) and the first eval step against the
    median of CIFAR_WARM[1] replays, and the median eager step, in one
    call. Break-even: the capture's extra time over the time a replay saves
    per step, against the steps a candidate trains."""
    import numpy as np

    from mfas_tpu_torch.data.cifar import (CifarLoader, load_cifar10_arrays,
                                           train_split)
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.engine.classifier import place_batch, set_trainable
    from mfas_tpu_torch.fusion.cifar import Searchable_MicroCNN
    from mfas_tpu_torch.search.trainers import CifarSearchTrainer

    arrays = load_cifar10_arrays(args.data_dir, train=True)
    split = train_split(arrays["image"].shape[0])[0]
    batch = place_batch(next(iter(CifarLoader(
        arrays, args.batchsize, train=True, seed=0,
        indices=np.arange(0, split)))), "cuda")
    model = CifarSearchTrainer(device="cuda").build_model(
        Searchable_MicroCNN, args, np.asarray([conf]))
    engine = CifarEngine(model, "cuda")
    set_trainable(model, None)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    r = {}
    for mode in ("eager", "graphed"):
        engine.graphed = mode == "graphed"
        model.train()
        opt = engine.make_optimizer()
        first = timed(lambda: engine.train_step(batch, opt, 1e-3))
        steps = [timed(lambda: engine.train_step(batch, opt, 1e-3))
                 for _ in range(CIFAR_WARM[1])]
        model.eval()
        first_eval = timed(lambda: engine.eval_step(batch))
        evals = [timed(lambda: engine.eval_step(batch)) for _ in range(5)]
        r[mode] = {"first_step_ms": first, "step_ms": float(np.median(steps)),
                   "first_eval_ms": first_eval,
                   "eval_ms": float(np.median(evals))}
        engine.release_graphs()
        del opt
    e, g = r["eager"], r["graphed"]
    capture = ((g["first_step_ms"] - g["step_ms"])
               + (g["first_eval_ms"] - g["eval_ms"]))
    saved = e["step_ms"] - g["step_ms"]
    steps = -(-split // args.batchsize)
    r.update(capture_ms=capture, saved_ms_per_step=saved,
             steps_per_candidate=steps,
             break_even_steps=capture / saved if saved > 0 else None)
    print(f"c3 capture cost: a candidate's train and eval captures take "
          f"{capture:.1f} ms over their replays; a replayed step "
          f"{g['step_ms']:.2f} ms against {e['step_ms']:.2f} eager saves "
          f"{saved:.2f} ms, so the captures pay back after "
          + (f"{capture / saved:.1f}" if saved > 0 else "no")
          + f" steps of the {steps} a candidate trains", flush=True)
    del model, engine, batch
    free_card(torch)
    return r


def cifar_card_vs_cpu(torch, store):
    """(c5) The CIFAR device work on the card against the CPU: the search-
    and fixed-mode nets at full width (eval mode, random weights from SEED)
    on 8 images in f32, logits and aux logits within 1e-4 of each tensor's
    max; one fixed-mode train step (--use_intermediate, drop-path 0,
    dropout 0) on CIFAR_STEP_IMAGES images in float64: the loss within 1e-4
    relative, every gradient and BatchNorm statistic within 1e-3 of its
    tensor's max apart from gradients that vanish on the CPU (below 1e-12
    of the largest: they are named and must stay below that on the card)
    and the analytically centred running means (named; below 1e-12 of the
    largest statistic on both devices), the parameters that get no
    gradient bitwise as built on both devices; the same step at DropPath
    keep ~1e-9 on the card: the dropped ops' parameters, moments and step
    counts untouched by Adam;
    DropPath's kept share over CIFAR_DROPPATH_DRAWS train-mode draws at
    keep 0.9 within 0.87-0.93, the second path never dropped with the
    first."""
    import numpy as np

    from mfas_tpu_torch import main_found_cifar as fmain
    from mfas_tpu_torch.core.layers import BatchNorm2d, set_dropout_generator
    from mfas_tpu_torch.data.cifar import load_cifar10_arrays, normalize
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.engine.classifier import set_trainable
    from mfas_tpu_torch.fusion.cifar import Searchable_MicroCNN
    from mfas_tpu_torch.models.enas_cell import CellBlock

    phase("CIFAR (c5) card vs CPU (nets f32, fixed-mode step f64, DropPath)")
    arrays = load_cifar10_arrays(store)
    images = torch.from_numpy(normalize(arrays["image"][:CIFAR_STEP_IMAGES]))
    labels = torch.from_numpy(arrays["label"][:CIFAR_STEP_IMAGES])
    conf = fmain.parse_conf(fmain.parse_args([]).conf)

    def net(dev, fixed, **kw):
        return Searchable_MicroCNN(
            fmain.parse_args([*CIFAR_FOUND_ARGV, *sum(
                ([f"--{k}", str(v)] for k, v in kw.items()), [])]),
            conf, fixed=fixed, device=dev,
            generator=torch.Generator().manual_seed(SEED))

    def rel_dev(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))

    out = {}
    for fixed in (False, True):
        outs = {}
        for dev in ("cuda", "cpu"):
            with torch.no_grad():
                outs[dev] = net(dev, fixed).eval()(images[:8].to(dev))
        devs = [rel_dev(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
        mode = "fixed" if fixed else "search"
        out[f"{mode}_eval_f32_dev"] = max(devs)
        print(f"c5 {mode}-mode net, 8 images f32: logits {devs[0]:.3e}, aux "
              f"logits {devs[1]:.3e} of max", flush=True)
        check(max(devs) <= 1e-4, f"c5: {mode}-mode card vs CPU {devs}")

    batch = {"image": images.double(), "label": labels,
             "_mask": torch.ones(CIFAR_STEP_IMAGES, dtype=torch.float64)}

    def f64_step(dev, drop_path):
        model = net(dev, True, drop_path=drop_path, drop_prob=0).double()
        built = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        engine = CifarEngine(model, dev, use_intermediate=True)
        set_trainable(model, None)
        model.train()
        opt = engine.make_optimizer()
        loss, _ = engine._train_step({k: v.to(dev) for k, v in
                                      batch.items()}, opt, 1e-3)
        return model, opt, built, float(loss)

    grads, losses, after, built, dead = {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        model, opt, built[dev], losses[dev] = f64_step(dev, 0)
        grads[dev] = {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters() if p.grad is not None}
        dead[dev] = {k for k, p in model.named_parameters()
                     if p.grad is None}
        after[dev] = {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}
        print(f"c5 fixed-mode step f64 on {dev}: loss {losses[dev]:.12f}, "
              f"{len(grads[dev])} grads, {len(dead[dev])} without, "
              f"{time.time() - t0:.1f} s", flush=True)
        del opt
    check(dead["cuda"] == dead["cpu"] and dead["cpu"]
          and all(k.startswith("pooled_layers.") for k in dead["cpu"]),
          f"c5: parameters without a gradient {dead}")
    for dev in ("cuda", "cpu"):
        check(all(torch.equal(after[dev][k], built[dev][k])
                  for k in dead[dev]),
              f"c5: a parameter without a gradient moved on {dev}")
    largest = max(float(v.abs().max()) for v in grads["cpu"].values())
    floor = VANISHING * largest
    vanished = {k: {"cpu_max": float(v.abs().max()),
                    "card_max": float(grads["cuda"][k].abs().max())}
                for k, v in grads["cpu"].items()
                if float(v.abs().max()) < floor}
    devs = {k: rel_dev(grads["cuda"][k], v)
            for k, v in grads["cpu"].items() if k not in vanished}
    # The first BatchNorm of an op that reads a cell's input sits behind a
    # bias-free 1x1 conv of a BatchNorm's output, which is centred over
    # the batch: its running mean is analytically 0 and holds rounding
    # noise on both devices. These are named and held below the floor
    # (VANISHING of the largest statistic); every other statistic is held
    # within 1e-3 of its own tensor's max.
    centred = set()
    for c, cell in enumerate(model.cell_array):
        for b, block in enumerate(cell.blocks):
            for j, src in enumerate(conf[b, 2:]):
                if src < 0:
                    op = getattr(block, f"op{j + 1}")
                    bn = next(n for n, m in op.named_modules()
                              if isinstance(m, BatchNorm2d))
                    centred.add(f"cell_array.{c}.blocks.{b}.op{j + 1}."
                                f"{bn}.running_mean")
    del model
    stat_keys = [k for k in after["cpu"]
                 if k.endswith(("running_mean", "running_var"))]
    stat_floor = VANISHING * max(float(after["cpu"][k].abs().max())
                                 for k in stat_keys)
    centred_max = {k: {"cpu_max": float(after["cpu"][k].abs().max()),
                       "card_max": float(after["cuda"][k].abs().max())}
                   for k in sorted(centred)}
    stats = {k: rel_dev(after["cuda"][k], after["cpu"][k])
             for k in stat_keys if k not in centred}
    worst, worst_stat = max(devs, key=devs.get), max(stats, key=stats.get)
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    out.update(step_f64_loss_rel=loss_rel, step_f64_grad_dev=devs[worst],
               step_f64_grad_dev_tensor=worst,
               step_f64_stat_dev=stats[worst_stat],
               step_f64_stat_dev_tensor=worst_stat,
               step_f64_largest_grad=largest, step_f64_vanished=vanished,
               step_f64_centred_means=centred_max,
               step_f64_stat_floor=stat_floor,
               step_f64_no_grad=sorted(dead["cpu"]))
    print(f"c5 step f64, {CIFAR_STEP_IMAGES} images: loss {loss_rel:.3e} "
          f"relative; largest gradient deviation {devs[worst]:.3e} of max "
          f"({worst}) over {len(devs)} tensors; BatchNorm statistics "
          f"{stats[worst_stat]:.3e} of max ({worst_stat}) over {len(stats)} "
          f"tensors; {len(centred)} centred running means below "
          f"{stat_floor:.3e} (largest {max(v['cpu_max'] for v in centred_max.values()):.3e} "
          f"CPU, {max(v['card_max'] for v in centred_max.values()):.3e} "
          f"card); {len(dead['cpu'])} parameters without a gradient, as "
          f"built on both devices", flush=True)
    for k, v in vanished.items():
        print(f"c5 vanished, not compared: {k} max |grad| {v['cpu_max']:.3e} "
              f"on the CPU, {v['card_max']:.3e} on the card (floor "
              f"{floor:.3e})")
    check(loss_rel <= 1e-4, f"c5: loss {loss_rel} relative")
    check(devs[worst] <= 1e-3, f"c5: gradient {worst}: {devs[worst]}")
    check(stats[worst_stat] <= 1e-3,
          f"c5: statistic {worst_stat}: {stats[worst_stat]}")
    check(all(v["card_max"] < floor for v in vanished.values()),
          f"c5: a gradient vanished on the CPU but not on the card: "
          f"{vanished}")
    check(centred and all(max(v.values()) < stat_floor
                          for v in centred_max.values()),
          f"c5: a centred running mean is not rounding noise: "
          f"{centred_max}")

    # the skip of all-zero gradients on the card: at keep ~1e-9 every
    # block's first path drops, so its op (and whatever only it reads)
    # gets an all-zero gradient and keeps its value, zero moments and step
    # count 0; every other parameter with a grad steps once
    model, opt, built_skip, _ = f64_step("cuda", 1.0 - 1e-9)
    skipped, stepped = set(), set()
    for k, p in model.named_parameters():
        if p.grad is None:
            continue
        st = opt.state[p]
        if not p.grad.any():
            check(torch.equal(p.detach().cpu(), built_skip[k])
                  and float(st["step"]) == 0 and not st["exp_avg"].any()
                  and not st["exp_avg_sq"].any(),
                  f"c5: {k}, with an all-zero gradient, was stepped on the "
                  f"card")
            skipped.add(k)
        else:
            check(float(st["step"]) == 1, f"c5: {k} was not stepped")
            stepped.add(k)
    op1 = {k for k in skipped | stepped if ".op1." in k}
    check(op1 and op1 <= skipped and stepped,
          f"c5: {sorted(op1 - skipped)} of the dropped ops got a gradient")
    skipped, stepped = len(skipped), len(stepped)
    out.update(skip_zero_grads_skipped=skipped,
               skip_zero_grads_stepped=stepped)
    print(f"c5 skip of all-zero gradients on the card, keep ~1e-9: "
          f"{skipped} parameters with all-zero gradients ({len(op1)} of the "
          f"dropped ops) unstepped (value, moments, step count), {stepped} "
          f"stepped once", flush=True)
    del model, opt

    block = CellBlock(0, 2, fmain.parse_args([]), device="cuda",
                      generator=torch.Generator()).train()
    set_dropout_generator(block, torch.Generator(device="cuda").manual_seed(
        SEED))
    x = torch.ones(1, 1, device="cuda")
    kept = both = 0
    for _ in range(CIFAR_DROPPATH_DRAWS):
        a, dropped = block.dp1(x)
        b, _ = block.dp2(x, dropped)
        kept += int(not bool(dropped))
        both += int(bool(dropped) and not bool(b.any()))
    share = kept / CIFAR_DROPPATH_DRAWS
    out.update(droppath_kept_share=share, droppath_both_dropped=both)
    print(f"c5 DropPath at keep 0.9 on the card: kept {kept} of "
          f"{CIFAR_DROPPATH_DRAWS} ({share:.4f}); second path dropped with "
          f"the first {both} times", flush=True)
    check(0.87 <= share <= 0.93 and both == 0,
          f"c5: DropPath kept share {share}, both dropped {both}")
    free_card(torch)
    return out


def cifar_test_eval(torch, store, path, want_acc):
    """The found CIFAR CLI's test pass (main_found_cifar has no --test_cp)
    of the (c1) checkpoint: its accuracy, which must be (c1)'s Model Acc,
    and the logits of its valid rows."""
    from mfas_tpu_torch import main_found_cifar as cmain
    from mfas_tpu_torch.data.cifar import CifarLoader, load_cifar10_arrays
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.engine.classifier import valid_rows
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    args = cmain.parse_args(["--data_dir", store])
    model = cmain.build_model(args, cmain.parse_conf(args.conf), "cuda")
    model.load_state_dict(load_state_dict(path), strict=True)
    engine = CifarEngine(model, "cuda")
    test = CifarLoader(load_cifar10_arrays(store, train=False),
                       args.batchsize)
    acc = engine.test_track_acc(test, test.dataset_size)
    check(acc == want_acc, f"CIFAR checkpoint's test accuracy {acc}, (c1)'s "
          f"Model Acc {want_acc}")
    return acc, valid_rows(engine.last_eval)


def cifar_phase(torch, tk, work):
    """(c1)-(c5); the input kernels launch nowhere on this path."""
    tk.reset_launch_counts()
    t0 = time.time()
    found = write_cifar_store(torch, os.path.join(work, "cifar"),
                              *CIFAR_FOUND_STORE, seed=8)
    out = {"c1_found": cifar_found(torch, work, found)}
    cp = out["c1_found"]["checkpoint"]
    out["i6_serving"] = serve(
        torch, tk, "CIFAR", work,
        ["cifar", "--net_str", "1", "1", "2", "1", "1", "2", "1", "1",
         "--test_cp", cp, "--checkpointdir", work],
        ["--datadir", found, "--batchsize", "128"],
        *cifar_test_eval(torch, found, os.path.join(work, cp),
                         out["c1_found"]["model_acc"]))
    out["c2_warm"] = cifar_warm_steps(torch, work, found)
    out["c5_card_vs_cpu"] = cifar_card_vs_cpu(torch, found)
    shutil.rmtree(found)
    search = write_cifar_store(torch, os.path.join(work, "cifar_search"),
                               *CIFAR_SEARCH_STORE, seed=9)
    out.update(cifar_search(torch, work, search))
    shutil.rmtree(search)
    out["input_kernel_launches"] = dict(tk.launch_counts)
    out["seconds"] = time.time() - t0
    print(f"CIFAR phase: {out['seconds']:.1f} s", flush=True)
    check(sum(tk.launch_counts.values()) == 0,
          f"the CIFAR path launched {tk.launch_counts}")
    return out


# --------------------------------------------------------------------------
# (i) NTU's default input paths and the export -> predict serving loop
# --------------------------------------------------------------------------
NATIVE_SKELETONS = (40, 300, 2)     # (i1): files, frames, persons
# (i4): the default 3 search iterations cut to 1, so the whole script keeps
# within its time with phase (bench) added
I4_SEARCH_ITERATIONS = "1"
NATIVE_GATHER = (20, 24)            # (i1): clips gathered, stored frames


def write_skeletons(root, n, frames, persons, seed):
    """n .skeleton files in the NTU text layout, random joints."""
    import numpy as np

    os.makedirs(root)
    rs = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        vals = rs.randn(frames, persons, 25, 3).astype(np.float32)
        lines = [str(frames)]
        for t in range(frames):
            lines.append(str(persons))
            for p in range(persons):
                lines += ["72057594037931101 0 1 1 1 1 0 0.2 0.1 2", "25"]
                lines += [f"{x:.6f} {y:.6f} {z:.6f} 0 0 0 0 0 0 0 0 2"
                          for x, y, z in vals[t, p]]
        path = os.path.join(root, f"S001C001P{i + 1:03d}R001A001.skeleton")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(path)
    return paths


def native_io(torch, work, packed):
    """(i1) the host IO library (data/native.py): built and loaded (not the
    numpy fallback); the C++ skeleton parser against the numpy one on
    NATIVE_SKELETONS files (rtol 1e-5, atol 1e-6) and the threaded
    gather_normalize_u8 at (20,24,256,256,3) from the packed train store
    against numpy (1e-6), with host clips/s of each."""
    import numpy as np

    from mfas_tpu_torch.data import native
    from mfas_tpu_torch.data.ntu import IMAGENET_MEAN, IMAGENET_STD

    phase("(i1) native host IO")
    t0 = time.time()
    lib = native.get_lib()
    check(lib is not None, "the native mfas_io library did not load: the "
          "numpy fallback would run")
    print(f"native library {native.library_path().name} built/loaded in "
          f"{time.time() - t0:.2f} s")
    n, frames, persons = NATIVE_SKELETONS
    paths = write_skeletons(os.path.join(work, "skeletons"), n, frames,
                            persons, seed=10)
    t0 = time.time()
    cpp = [native.parse_skeleton(p, frames) for p in paths]
    t_cpp = time.time() - t0
    t0 = time.time()
    ref = [native.parse_skeleton_numpy(p, frames) for p in paths]
    t_np = time.time() - t0
    err = 0.0
    for (a, na), (b, nb) in zip(cpp, ref):
        check(na == nb == frames, f"parsed {na} / {nb} frames of {frames}")
        check(np.allclose(a, b, rtol=1e-5, atol=1e-6),
              "C++ and numpy skeleton parsers disagree")
        err = max(err, float(np.abs(a - b).max()))
    shutil.rmtree(os.path.join(work, "skeletons"))

    store = np.load(os.path.join(packed, "train", "rgb.npy"), mmap_mode="r")
    B, T = NATIVE_GATHER
    check(store.shape[1] == T, f"store of {store.shape[1]} frames")
    idx = np.random.RandomState(11).randint(0, len(store), B)
    base = np.ascontiguousarray(store)
    t0 = time.time()
    got = native.gather_normalize_u8(base, idx, IMAGENET_MEAN, IMAGENET_STD)
    t_gather = time.time() - t0
    t0 = time.time()
    want = native.gather_normalize_u8_numpy(base, idx, IMAGENET_MEAN,
                                            IMAGENET_STD)
    t_gather_np = time.time() - t0
    gerr = float(np.abs(got - want).max())
    check(got.shape == (B, T, 256, 256, 3) and gerr <= 1e-6,
          f"gather_normalize_u8 {got.shape}: max abs err {gerr}")
    r = {"library": native.library_path().name,
         "skeleton_files": n, "skeleton_frames": frames,
         "skeleton_max_abs_err": err,
         "skeleton_files_per_s_cpp": n / t_cpp,
         "skeleton_files_per_s_numpy": n / t_np,
         "gather_shape": list(got.shape), "gather_max_abs_err": gerr,
         "gather_clips_per_s_cpp": B / t_gather,
         "gather_clips_per_s_numpy": B / t_gather_np,
         "threads": os.cpu_count()}
    print(f"i1: skeleton parse {r['skeleton_files_per_s_cpp']:.1f} files/s "
          f"C++ against {r['skeleton_files_per_s_numpy']:.1f} numpy (max abs "
          f"diff {err:.2e}); gather_normalize_u8 {tuple(got.shape)} "
          f"{r['gather_clips_per_s_cpp']:.1f} clips/s C++ "
          f"({os.cpu_count()} threads) against "
          f"{r['gather_clips_per_s_numpy']:.1f} numpy (max abs diff "
          f"{gerr:.2e})", flush=True)
    return r


def _eval_run(torch, tk, name, argv):
    """One in-process ``main_found_ntu`` run with the launch counts zeroed
    just before and read just after: Model Acc finite, no input kernel
    launched (the host normalizes)."""
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain

    free_card(torch)
    tk.reset_launch_counts()
    t0 = time.time()
    run, out = _quiet(tmain.main, argv)
    wall = time.time() - t0
    counts = dict(tk.launch_counts)
    check(sum(counts.values()) == 0, f"{name}: launches {counts}")
    check(np.isfinite(run.acc) and f"Model Acc: {run.acc}" in out,
          f"{name}: Model Acc {run.acc}")
    return run, counts, wall


def ntu_default_inputs(torch, tk, work, packed, runs, train):
    """(i2) ``main_found_ntu --test_cp`` of the slice's checkpoint on the
    packed store normalized on the host (no --device_input_normalize), with
    --no-multitask so that Model Acc is the fused head's, the serving
    surface that (i6) exports: the fused logits within 1e-4 of their max of
    the K1 run's (slice_phase), Model Acc the top-1 of the K1 run's fused
    logits, 0 K1 launches. (i3) found training on it, one epoch
    per phase, f32: finite losses, train clips/s beside (b)'s. (i5) the
    raw-AVI --datadir: without cv2 on this machine it must stop in
    load_video with the RuntimeError that names cv2 and pack_ntu."""
    import importlib.util

    import numpy as np

    from mfas_tpu_torch.engine.classifier import valid_rows

    phase("(i2) found-NTU --test_cp, packed store normalized on the host")
    argv = ["--checkpointdir", work, "--test_cp", "net.pt",
            "--packed_datadir", packed, "--conf", "4", "--num_outputs", "60",
            "--batchsize", "20", "--inner_representation_size", "128",
            "--batchnorm", "--vid_len", "8", "32", "--no-multitask"]
    run, counts, wall = _eval_run(torch, tk, "i2", argv)
    logits = valid_rows(run.eval)
    k1 = runs["packed"]["logits"]
    diff = float(np.abs(logits - k1).max())
    scale = float(np.abs(k1).max())
    check(logits.shape == (50, 60) and diff <= 1e-4 * scale,
          f"i2: fused logits {logits.shape} differ from the K1 run's by "
          f"{diff} (max |logit| {scale})")
    labels = np.load(os.path.join(packed, "test", "labels.npy"))
    k1_top1 = float(np.sum(k1.argmax(axis=1) == labels)) / len(labels)
    check(run.acc == k1_top1, f"i2: Model Acc {run.acc}, the top-1 of the "
          f"K1 run's fused logits {k1_top1}")
    i2 = {"model_acc": run.acc, "k1_launches": counts["u8_normalize"],
          "eval_clips_per_s": run.eval.clips / run.eval.seconds,
          "eval_clips_per_s_k1_warm": runs["packed"]["warm_clips_per_s"],
          "run_seconds": wall, "max_abs_diff_vs_k1": diff,
          "max_abs_logit": scale}
    print(f"i2: Model Acc {run.acc} (fused head; the K1 run's fused top-1 "
          f"{k1_top1}), "
          f"launches {counts}, eval {i2['eval_clips_per_s']:.2f} clips/s "
          f"(K1 path warm {i2['eval_clips_per_s_k1_warm']:.2f}), fused "
          f"logits within {diff:.2e} of the K1 run's (max |logit| "
          f"{scale:.3e})", flush=True)

    phase("(i3) found-NTU training, packed store normalized on the host")
    argv = ["--checkpointdir", work, "--packed_datadir", packed, *TRAIN_ARGV]
    trun, counts, wall = _eval_run(torch, tk, "i3", argv)
    stats = [e for r in trun.train for e in r.epochs]
    check(len(trun.train) == 2 and all(np.isfinite(e["loss"])
                                       for e in stats),
          f"i3: {len(trun.train)} phases, epochs {stats}")
    rates = [r.train_clips / r.train_seconds for r in trun.train]
    b_rates = [p["train_clips_per_s"]
               for p in train["b_packed_f32"]["phases"]]
    i3 = {"model_acc": trun.acc, "k1_launches": counts["u8_normalize"],
          "train_clips_per_s": rates, "train_clips_per_s_b_k1": b_rates,
          "peak_bytes": trun.train_peak_bytes,
          "losses": [e["loss"] for e in stats], "run_seconds": wall}
    print(f"i3: phase 1 / 2 train clips/s {rates[0]:.2f} / {rates[1]:.2f} "
          f"(K1 path (b): {b_rates[0]:.2f} / {b_rates[1]:.2f}); losses "
          f"{[round(x, 4) for x in i3['losses']]}; launches {counts}; run "
          f"{wall:.1f} s", flush=True)

    phase("(i5) the raw-AVI --datadir")
    raw = os.path.join(work, "raw")
    name = "S001C001P003R001A001"          # subject 3: the test split
    rgb_dir = os.path.join(raw, "nturgbd_rgb", "avi_256x256_30")
    os.makedirs(rgb_dir)
    avi = os.path.join(rgb_dir, name + "_rgb.avi")
    has_cv2 = importlib.util.find_spec("cv2") is not None
    if has_cv2:
        import cv2
        vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (256, 256))
        for t in range(8):
            vw.write(np.full((256, 256, 3), 30 * t, np.uint8))
        vw.release()
    else:
        open(avi, "wb").close()     # never opened: load_video stops first
    write_skeletons(os.path.join(raw, "nturgbd_skeletons"), 1, 8, 1, seed=12)
    os.rename(os.path.join(raw, "nturgbd_skeletons",
                           "S001C001P001R001A001.skeleton"),
              os.path.join(raw, "nturgbd_skeletons", name + ".skeleton"))
    argv = ["--checkpointdir", work, "--test_cp", "net.pt", "--datadir", raw,
            "--conf", "4", "--num_outputs", "60", "--batchsize", "20",
            "--inner_representation_size", "128", "--batchnorm",
            "--vid_len", "8", "32", "--j", "1"]
    if has_cv2:
        run, counts, _ = _eval_run(torch, tk, "i5", argv)
        i5 = {"cv2": True, "model_acc": run.acc}
        print(f"i5: cv2 is installed here; --datadir decoded the fixture: "
              f"Model Acc {run.acc}")
    else:
        from mfas_tpu_torch import main_found_ntu as tmain
        try:
            _quiet(tmain.main, argv)
        except RuntimeError as e:
            msg = str(e)
        else:
            msg = ""
        check("cv2" in msg and "pack_ntu" in msg,
              f"i5: --datadir without cv2 did not stop naming cv2 and "
              f"pack_ntu ({msg!r})")
        i5 = {"cv2": False, "error": msg}
        print(f"i5: no cv2 here; --datadir stopped: {msg}")
    shutil.rmtree(raw)
    return {"i2_found_eval": i2, "i3_found_training": i3,
            "i5_datadir": i5}, logits


def ntu_search_host(torch, tk, work):
    """(i4) the NTU search at the CLI's defaults cut to I4_SEARCH_ITERATIONS
    on (s1)'s store normalized on the host (no --device_input_normalize):
    32 + 3 x 15 = 77 candidates, 0 K1 launches, the top-5, seconds and
    candidates/hour."""
    phase("(i4) NTU search at the CLI's defaults, one iteration, normalized "
          "on the host")
    store = os.path.join(work, "search")
    argv = ["--packed_datadir", store, "--checkpointdir", work,
            *[a for a in SEARCH_ARGV if a != "--device_input_normalize"],
            "--search_iterations", I4_SEARCH_ITERATIONS]
    seen, unwrap = _tally_out_dtypes(tk)
    try:
        r, _, _ = _search_run(torch, tk, seen, "i4 search, host normalize",
                              argv, 0, "torch.float32",
                              32 + (int(I4_SEARCH_ITERATIONS) * 4 - 1) * 15)
    finally:
        unwrap()
    return r


def found_eval(main, argv):
    """A found CLI's ``--test_cp`` pass -> its Model Acc / F1 and the fused
    logits of its valid rows."""
    from mfas_tpu_torch.engine.classifier import valid_rows

    run, _ = _quiet(main, argv)
    check(not run.train, "a --test_cp run trained")
    return run.acc, valid_rows(run.eval)


def serve(torch, tk, name, work, export_argv, predict_argv, want,
          want_logits, bf16=False):
    """(i6) one vertical's serving loop on the card:
    ``mfas_tpu_torch.tools.export_model`` of its found checkpoint with
    --polymorphic_batch --check, then ``mfas_tpu_torch.tools.predict`` of
    the artifact over its test split (launch counts zeroed just before and
    read just after: no input kernel; the BatchNorm kernels' finalize and
    apply once a batch for each mfas::batch_norm_eval node of the
    artifact, its BatchNorms as the export on the card records them). The
    printed metric must equal ``want``, the
    found CLI's --test_cp Model Acc / F1 of the same checkpoint from the
    served (fused) output, and the logits lie within 1e-4 of their max of
    ``want_logits``, that run's. With ``bf16`` also a --bf16 artifact: its size
    against the f32 one's, and its logits on the first predict batch within
    0.05 of max |logit| of the f32 artifact's."""
    import numpy as np

    from mfas_tpu_torch.ops import batchnorm as tbn
    from mfas_tpu_torch.runtime.export import load_exported
    from mfas_tpu_torch.tools import export_model, predict

    phase(f"(i6) {name}: export, check, predict")
    vertical = export_argv[0]
    art = os.path.join(work, f"{vertical}.pt2")
    free_card(torch)
    rec, out = _quiet(export_model.main, export_argv + [
        "--polymorphic_batch", "--check", "--out", art])
    check("check OK: reloaded artifact ran on cuda" in out,
          f"{name}: export --check did not pass: {out[-300:]}")
    # predict's own count, zeroed just before it; the phase's running count
    # (checked at the phase's end) is put back after
    before = dict(tk.launch_counts)
    tk.reset_launch_counts()
    tbn.reset_launch_counts()
    res, _ = _quiet(predict.main, [vertical, "--artifact", art,
                                   *predict_argv])
    torch.cuda.synchronize()
    counts, bn = dict(tk.launch_counts), dict(tbn.launch_counts)
    for k, v in before.items():
        tk.launch_counts[k] += v
    check(sum(counts.values()) == 0, f"{name}: predict launched {counts}")
    # exported on the card, each BatchNorm is one mfas::batch_norm_eval
    # node, which runs finalize and apply once a batch
    nodes = sum(n.op == "call_function"
                and n.target is torch.ops.mfas.batch_norm_eval.default
                for n in torch.export.load(art).graph.nodes)
    batches = bn["apply"] // nodes if nodes else 0
    check(bn["finalize"] == bn["apply"] == nodes * batches
          and sum(bn.values()) == 2 * bn["apply"]
          and (batches > 0 or nodes == 0),
          f"{name}: predict's BatchNorm kernel launches {bn} for {nodes} "
          "batch_norm_eval nodes")
    BN_PATHS[f"predict_{vertical}_i6"] = bn
    print(f"{name}: predict ran the BatchNorm kernels of {nodes} "
          f"batch_norm_eval nodes {batches} times ({bn})", flush=True)
    logits = res["logits"]
    check(np.isfinite(logits).all(), f"{name}: non-finite logits")
    check(res["value"] == want, f"{name}: predict's {res['metric']} "
          f"{res['value']}, the found run's {want}")
    diff = float(np.abs(logits - want_logits).max())
    scale = float(np.abs(want_logits).max())
    check(logits.shape == want_logits.shape and diff <= 1e-4 * scale,
          f"{name}: predict's logits {logits.shape} differ by {diff} (max "
          f"|logit| {scale})")
    r = {"export_seconds": rec["seconds"], "artifact_bytes": rec["bytes"],
         "metric": res["metric"], "value": res["value"],
         "samples": res["samples"],
         "predict_samples_per_s": res["samples"] / res["seconds"],
         "input_kernel_launches": counts, "bn_kernel_launches": bn,
         "bn_nodes": nodes, "max_abs_diff_vs_found": diff,
         "max_abs_logit": scale}
    print(f"{name}: exported in {rec['seconds']:.1f} s, {rec['bytes']} "
          f"bytes; predict {res['samples']} samples at "
          f"{r['predict_samples_per_s']:.1f} samples/s, {res['metric']} "
          f"{res['value']} (the found run's {want}), logits within "
          f"{diff:.2e} of its (max |logit| {scale:.3e})", flush=True)
    if bf16:
        art16 = art.replace(".pt2", "_bf16.pt2")
        rec16, _ = _quiet(export_model.main, export_argv + [
            "--polymorphic_batch", "--bf16", "--out", art16])
        ratio = rec16["bytes"] / rec["bytes"]
        loader = predict.LOADERS[vertical](predict.parse_args(
            [vertical, "--artifact", art16, *predict_argv]))
        batch = next(iter(loader))
        inputs = [np.asarray(batch[k], np.float32)
                  for k in predict.INPUT_KEYS[vertical]]
        f32 = load_exported(art, "cuda").call(*inputs)
        b16 = load_exported(art16, "cuda").call(*inputs)
        check(b16.dtype == torch.float32, f"{name} bf16: {b16.dtype} out")
        d16 = float((b16 - f32).abs().max())
        s32 = float(f32.abs().max())
        check(ratio < 0.75 and d16 <= 0.05 * s32 and d16 > 0,
              f"{name} bf16: size ratio {ratio}, max abs diff {d16} "
              f"(max |logit| {s32})")
        r["bf16"] = {"artifact_bytes": rec16["bytes"], "size_ratio": ratio,
                     "export_seconds": rec16["seconds"],
                     "max_abs_diff_vs_f32": d16, "max_abs_logit": s32}
        print(f"{name} --bf16: {rec16['bytes']} bytes ({ratio:.3f} of f32), "
              f"first batch within {d16:.3e} of the f32 artifact (max "
              f"|logit| {s32:.3e})", flush=True)
        os.remove(art16)
    os.remove(art)
    return r


# --------------------------------------------------------------------------
# (t) the operator tools
# --------------------------------------------------------------------------
FRAME = 224         # (t1): the framewise check's frame size
PROFILE_RUNS = (("found_train_f32", ["--what", "found_train"]),
                ("found_train_bf16", ["--what", "found_train", "--bf16"]),
                ("visual_fwd", ["--what", "visual_fwd"]))
KIT_TINY = ["--resnet3d_layers", "1", "1", "1", "1", "--resnet3d_base_width",
            "16", "--num_outputs", "3", "--inner_representation_size", "8",
            "--no_batchnorm", "--vid_len", "2", "32"]


def write_resnet50_2d(torch, path, seed):
    """A torchvision-layout ResNet-50 state dict from a seed, written with
    torch.save (zip): the inflated template's keys with the 3D convs' time
    axis dropped (4D conv weights, He-scaled by fan-in), BatchNorm
    parameters and statistics near the identity, int64
    num_batches_tracked, and fc.*."""
    from mfas_tpu_torch.models.resnet3d import inflated_resnet50

    g = torch.Generator().manual_seed(seed)
    flat = {}
    for k, v in inflated_resnet50(
            device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict().items():
        if v.dim() >= 4:
            o, i, kh, kw = v.shape[0], v.shape[1], v.shape[-2], v.shape[-1]
            flat[k] = torch.randn(o, i, kh, kw, generator=g) * (
                2.0 / (i * kh * kw)) ** 0.5
        elif k.endswith("num_batches_tracked"):
            flat[k] = torch.tensor(100, dtype=torch.int64)
        elif k.endswith("running_var"):
            flat[k] = 1 + 0.1 * torch.rand(v.shape, generator=g)
        elif k.endswith("weight"):
            flat[k] = 1 + 0.1 * torch.randn(v.shape, generator=g)
        else:
            flat[k] = 0.1 * torch.randn(v.shape, generator=g)
    flat["fc.weight"] = 0.01 * torch.randn(1000, 2048, generator=g)
    flat["fc.bias"] = torch.zeros(1000)
    torch.save(flat, path)
    return flat


def run_tool(root, module, argv):
    """``python -m module argv`` from the checkout's root -> its standard
    output; a non-zero exit fails the run."""
    p = subprocess.run([sys.executable, "-m", module, *argv], cwd=root,
                       capture_output=True, text=True, timeout=600)
    check(p.returncode == 0, f"{module} {argv[0]}: exit {p.returncode}: "
          f"{p.stderr[-800:]}")
    return p.stdout


def conversion(torch, work, root):
    """(t1) ``mfas_tpu_torch.tools.convert_torchvision`` as a subprocess on
    a full-width torchvision-layout ResNet-50 from a seed: in center and in
    mean mode 318 tensors, loaded strictly into ``inflated_resnet50`` on the
    card, every 3D conv's slices the 2D weight's inflation bit for bit,
    every other tensor the 2D one's. Center mode, f32, TF32 off: a 2-frame
    time-replicated FRAMExFRAME clip against the single frame on the card,
    on each of the four feature maps, and the card's clip against the
    CPU's, each within 1e-4 of the map's max. vgg19_trunk: a fabricated
    torchvision VGG-19 (``features.*`` and ``classifier.6.*``) converts to
    32 ``vgg.*`` tensors, which load strictly into the MM-IMDB model's trunk
    and equal what ``main_found_mmimdb --vgg_cp``'s loader puts there from
    the source file."""
    from mfas_tpu_torch import main_found_mmimdb as mmain
    from mfas_tpu_torch.models.resnet3d import inflated_resnet50
    from mfas_tpu_torch.models.vgg import vgg19_features
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    tool = "mfas_tpu_torch.tools.convert_torchvision"
    phase("(t1) convert_torchvision resnet50_inflate, vgg19_trunk")
    src = os.path.join(work, "resnet50_2d.pth")
    flat = write_resnet50_2d(torch, src, seed=13)
    out = {"src_bytes": os.path.getsize(src)}
    inflated = {}
    for mode in ("center", "mean"):
        dst = os.path.join(work, f"resnet50_{mode}.pt")
        t0 = time.time()
        text = run_tool(root, tool, ["resnet50_inflate", "--src", src,
                                     "--dst", dst, "--inflation", mode])
        seconds = time.time() - t0
        check(text == f"wrote 318 tensors to {dst}\n", f"{mode}: {text!r}")
        sd = load_state_dict(dst)
        net = inflated_resnet50(device="cuda",
                                generator=torch.Generator().manual_seed(0))
        net.load_state_dict(sd, strict=True)
        check("fc.weight" not in sd and "fc.bias" not in sd, f"{mode}: fc.*")
        n3d = 0
        for k, w in sd.items():
            w2d = flat[k]
            if w.dim() != 5:
                check(torch.equal(w, w2d), f"{mode}: {k} is not the 2D one")
                continue
            n3d += 1
            kt = w.shape[2]
            for t in range(kt):
                want = (w2d / kt if mode == "mean" else w2d
                        if t == kt // 2 else torch.zeros_like(w2d))
                check(torch.equal(w[:, :, t], want),
                      f"{mode}: {k}[:, :, {t}] is not the inflation")
        out[mode] = {"seconds": seconds, "bytes": os.path.getsize(dst),
                     "conv3d_weights": n3d}
        print(f"t1 {mode}: converted in {seconds:.2f} s (a subprocess), "
              f"{out[mode]['bytes']} bytes; loaded strictly on the card; "
              f"{n3d} 3D conv weights inflated bit for bit", flush=True)
        inflated[mode] = (net, sd)
        os.remove(dst)
    os.remove(src)

    net, sd = inflated["center"]
    net.eval()
    cpu = inflated_resnet50(device="cpu",
                            generator=torch.Generator().manual_seed(0))
    cpu.load_state_dict(sd, strict=True)
    cpu.eval()
    frame = torch.randn(1, 3, 1, FRAME, FRAME,
                        generator=torch.Generator().manual_seed(14))
    clip = frame.repeat(1, 1, 2, 1, 1)
    with torch.no_grad():
        card_clip, card_frame = net(clip.cuda()), net(frame.cuda())
        cpu_clip = cpu(clip)
    maps = []
    for i, (fc, fs, fh) in enumerate(zip(card_clip, card_frame, cpu_clip)):
        scale = float(fh.abs().max())
        e_frames = max(float((fc[:, :, t] - fs[:, :, 0]).abs().max())
                       for t in range(2))
        e_cpu = float((fc.cpu() - fh).abs().max())
        check(fc.shape[2] == 2 and torch.isfinite(fc).all()
              and e_frames <= 1e-4 * scale and e_cpu <= 1e-4 * scale,
              f"t1 framewise fm{i + 1} {tuple(fc.shape)}: frames differ by "
              f"{e_frames}, card and CPU by {e_cpu} (max {scale})")
        maps.append({"shape": list(fc.shape), "max_abs": scale,
                     "frames_max_abs_diff": e_frames,
                     "card_vs_cpu_max_abs_diff": e_cpu})
    out["framewise"] = maps
    print("t1 framewise (center, f32, 2 frames of "
          f"{FRAME}x{FRAME}): " + "; ".join(
              f"fm{i + 1} {tuple(m['shape'])} frames within "
              f"{m['frames_max_abs_diff']:.2e}, card vs CPU "
              f"{m['card_vs_cpu_max_abs_diff']:.2e} of max "
              f"{m['max_abs']:.3e}" for i, m in enumerate(maps)), flush=True)
    del inflated, net, cpu, card_clip, card_frame, cpu_clip

    vsrc = os.path.join(work, "vgg19.pth")
    vdst = os.path.join(work, "vgg19_trunk.pt")
    g = torch.Generator().manual_seed(15)
    vflat = {f"features.{k}": v for k, v in vgg19_features(
        device="cpu", generator=g).state_dict().items()}
    vflat["classifier.6.weight"] = torch.randn(1000, 4096, generator=g)
    vflat["classifier.6.bias"] = torch.randn(1000, generator=g)
    torch.save(vflat, vsrc)
    t0 = time.time()
    text = run_tool(root, tool, ["vgg19_trunk", "--src", vsrc, "--dst",
                                 vdst])
    seconds = time.time() - t0
    check(text == f"wrote 32 tensors to {vdst}\n", f"vgg19_trunk: {text!r}")
    conv = load_state_dict(vdst)
    args = mmain.parse_args(["--text_first_hidden", "256"])
    a, b = (mmain.build_model(args, "cuda") for _ in range(2))
    a.image_net.vgg.load_state_dict(
        {k[len("vgg."):]: v for k, v in conv.items()}, strict=True)
    mmain.load_vgg_trunk(b, vsrc)
    want = b.image_net.vgg.state_dict()
    check(all(torch.equal(v, want[k])
              for k, v in a.image_net.vgg.state_dict().items()),
          "vgg19_trunk: the converted trunk differs from --vgg_cp's")
    out["vgg19_trunk"] = {"seconds": seconds, "tensors": len(conv),
                          "bytes": os.path.getsize(vdst)}
    print(f"t1 vgg19_trunk: converted in {seconds:.2f} s, {len(conv)} "
          "tensors, loaded strictly into the MM-IMDB trunk on the card, "
          "equal to --vgg_cp's", flush=True)
    os.remove(vsrc)
    os.remove(vdst)
    return out


def profile_runs(torch, tk):
    """(t2) ``mfas_tpu_torch.tools.profile_step`` at its defaults (B=16,
    256 px) in process: found_train in f32 and --bf16, visual_fwd; each
    must see kernels, a device-busy time within its wall time, report TF32
    off (as this script set it) and launch neither input kernel (counts
    zeroed just before, read just after)."""
    import numpy as np

    from mfas_tpu_torch.tools import profile_step

    out = {}
    for name, argv in PROFILE_RUNS:
        phase(f"(t2) profile_step {' '.join(argv)}")
        free_card(torch)
        tk.reset_launch_counts()
        t0 = time.time()
        r, text = _quiet(profile_step.main, argv)
        seconds = time.time() - t0
        counts = dict(tk.launch_counts)
        print(text, end="", flush=True)
        check(sum(counts.values()) == 0, f"t2 {name}: launches {counts}")
        check(np.isfinite(r["wall_ms"]) and r["kernels_per_iter"] > 0
              and 0 < r["busy_ms"] <= 1.01 * r["wall_ms"],
              f"t2 {name}: wall {r['wall_ms']} busy {r['busy_ms']} ms, "
              f"{r['kernels_per_iter']} kernels")
        check(r["tf32"] == {"matmul": False, "cudnn": False},
              f"t2 {name}: TF32 {r['tf32']}")
        r.update(input_kernel_launches=counts, seconds=seconds)
        out[name] = r
        print(f"t2 {name}: {r['wall_ms']:.2f} ms/iter, device busy "
              f"{r['busy_ms']:.2f} ({100 * r['busy_ms'] / r['wall_ms']:.0f} "
              f"%), {r['kernels_per_iter']:.0f} kernels/iter; top classes "
              + ", ".join(f"{c} {t:.2f}" for c, t in
                          list(r["by_class_ms"].items())[:4])
              + f"; {seconds:.1f} s", flush=True)
    return out


def kit_runs(work):
    """(t3) ``mfas_tpu_torch.tools.parity_kit``: --synthetic is [READY] with
    exit code 0; the same fixture with a checkpoint directory that holds
    none is [NOT READY], [missing], exit code 1."""
    from mfas_tpu_torch.tools import parity_kit

    phase("(t3) parity_kit --synthetic, and without checkpoints")
    syn = os.path.join(work, "kit")
    t0 = time.time()
    rc, text = _quiet(parity_kit.main, ["--synthetic", syn])
    seconds = time.time() - t0
    check(rc == 0 and "[READY] all preconditions pass" in text
          and "python -m mfas_tpu_torch.main_found_ntu" in text,
          f"t3 --synthetic: exit {rc}: {text[-600:]}")
    empty = os.path.join(work, "kit_empty")
    os.makedirs(empty)
    rc2, text2 = _quiet(parity_kit.main, ["--datadir", syn, "--checkpointdir",
                                          empty, *KIT_TINY])
    check(rc2 == 1 and "[NOT READY]" in text2 and "[missing]" in text2,
          f"t3 without checkpoints: exit {rc2}: {text2[-600:]}")
    shutil.rmtree(syn)
    shutil.rmtree(empty)
    print(f"t3: --synthetic [READY], exit 0 in {seconds:.2f} s; without "
          f"checkpoints [NOT READY] with {text2.count('[missing]')} "
          "[missing], exit 1", flush=True)
    return {"synthetic_rc": rc, "synthetic_seconds": seconds,
            "no_checkpoints_rc": rc2,
            "missing": text2.count("[missing]")}


def report_run(search):
    """(t4) ``mfas_tpu_torch.tools.search_report`` over (s4)'s search state
    and telemetry: its listing is the top-5 the resumed search printed, and
    it counts both runs' EPNAS steps."""
    from mfas_tpu_torch.tools import search_report

    phase("(t4) search_report over (s4)'s state and telemetry")
    files = search["s4_files"]
    _, text = _quiet(search_report.main, ["--search_state",
                                          files["search_state"], "--jsonl",
                                          files["jsonl_log"]])
    print(text, end="", flush=True)
    listing = text.split("Now listing best architectures\n")[1].split(
        "telemetry:")[0].splitlines()
    want = search["s4_resume"]["listing"]
    check(listing == want and len(want) == 5,
          f"t4: the report lists {listing}, the search printed {want}")
    steps = f"  epnas_step: {files['epnas_steps']}\n"
    check(steps in text, f"t4: no {steps!r} in the report")
    print(f"t4: the report's top-5 is the search's; {steps.strip()}",
          flush=True)
    return {"listing": listing, "epnas_steps": files["epnas_steps"]}


def tools_phase(torch, tk, work, root, search):
    """(t1)-(t4); the input kernels launch nowhere on these paths."""
    t0 = time.time()
    launches = {k: 0 for k in tk.launch_counts}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    tk.reset_launch_counts()
    out = {"t1_conversion": conversion(torch, work, root)}
    add(tk.launch_counts)
    free_card(torch)
    out["t2_profile_step"] = profile_runs(torch, tk)
    for r in out["t2_profile_step"].values():
        add(r["input_kernel_launches"])
    tk.reset_launch_counts()
    out["t3_parity_kit"] = kit_runs(work)
    out["t4_search_report"] = report_run(search)
    add(tk.launch_counts)
    check(sum(launches.values()) == 0, f"the tools' paths launched {launches}")
    out["input_kernel_launches"] = launches
    out["seconds"] = time.time() - t0
    print(f"tools phase: {out['seconds']:.1f} s", flush=True)
    return out


# the least time of the input kernels at (20,8,256,256,3): each uint8 byte
# read once and each output written once at 3.35 TB/s (their 2 operations
# per element at 67 TFLOP/s f32 take ~1 us: bytes bound them)
# --------------------------------------------------------------------------
# (d) multi-GPU data parallelism (parallel/mesh.py). The card's machine has
# one H100 and NCCL refuses two ranks on one device, so (d1) runs NCCL at
# world 1 and (d2)-(d5) run two gloo ranks that time-share the card (gloo
# stages CUDA tensors through the host). Every rank is a subprocess
# (``python3 chip_smoke.py --rank CASE RANK WORLD ADDR WORK``): this
# script's own process never holds a process group. No rate from (d2)-(d5)
# is a scaling figure.
# --------------------------------------------------------------------------
TIME_SHARING = "two processes time-sharing one H100 over gloo"
D_TIMEOUT = 300          # seconds, per multi-process run (and gloo's)
# (d2) runs without --batchnorm: over random backbones every clip pools
# nearly the same features, so the head's BatchNorm1d statistics cancel
# catastrophically in float32 (E[x^2] - E[x]^2 with std << mean). The f32
# step is ill-conditioned all the same (the deepest convolutions' small
# gradients move by percents of their max with the summation order), so
# two ranks are held to one exactly in float64, and in float32 to the
# float64 gradients no worse than one rank's f32 ones
D5_STEPS = 3
D5_ARGV = ["--drop_path", "0.1"]
# (d4)'s own store: D4_CLASSES classes, a train split of 40 and a dev split
# of 60 clips (10 and 15 of each class; K1 runs 2 + 3 times a rank, as on
# (s4)'s store), every clip's frames shifted by its class's colour and its
# skeleton by its class's pose, each with a per-clip jitter of the same
# size so the classes overlap. The two ranks' bank is not bitwise one
# rank's: each rank runs the bf16 ResNet-50 on its 10 of a batch's 20 rows,
# and cuDNN's kernels for that shape round the visual features differently
# (within a bf16 ulp). At this signal no first-step accuracy moves by that;
# at twice it, some moved by more than (d4)'s 0.02 (PERF.md §7)
D4_CLASSES = 4
D4_SPLITS = (("trainexp", 40), ("dev", 60))
D4_COLOUR = 24.0         # grey levels, per channel, of a class's colour
D4_POSE = 0.15           # of a class's pose, per joint coordinate
D4_NOISE = 48            # grey levels of each pixel's uniform noise
D4_MIN_DISTINCT = 3      # distinct first-step accuracies each rank needs


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank_processes(cases, world, work, timeout=D_TIMEOUT):
    """``world`` rank processes that run ``cases`` in turn, joined at a free
    localhost port (one group for all the cases); each rank writes
    {case: result} as JSON, returned per rank with its output. A rank that
    fails or outlives ``timeout`` fails the run, and every rank is
    stopped."""
    script = os.path.abspath(__file__)
    addr = f"127.0.0.1:{_free_port()}"
    name = "-".join(cases)
    logs = [os.path.join(work, f"{name}.{r}.log") for r in range(world)]
    procs = []
    t0 = time.time()
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, script, "--rank", ",".join(cases),
                     str(r), str(world), addr, work], stdout=log,
                    stderr=subprocess.STDOUT, cwd=os.path.dirname(script)))
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.time() - t0
    out = []
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            text = f.read()
        if p.returncode != 0:
            print(text[-6000:], flush=True)
        check(p.returncode == 0, f"({name}) rank {r} of {world} exited "
              f"{p.returncode} after {seconds:.1f} s")
        with open(os.path.join(work, f"{name}.{r}.json")) as f:
            out.append(json.load(f))
    print(f"({name}) {world} process(es) in {seconds:.1f} s", flush=True)
    return out, seconds


def rank_main(argv):
    """One process of phase (d): ``CASES RANK WORLD ADDR WORK``, CASES
    comma-separated. (d1) joins its group through the CLI's --dist_* flags;
    the others join one gloo group here, before any CLI or engine runs,
    which then uses it."""
    import datetime

    import torch
    import torch.distributed as dist

    cases, rank, world, addr, work = (argv[0].split(","), int(argv[1]),
                                      int(argv[2]), argv[3], argv[4])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if cases != ["d1"]:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{addr}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=D_TIMEOUT))
    from mfas_tpu_torch.runtime import graphs

    res = {}
    try:
        for case in cases:
            graphs.reset_graph_counts()
            res[case] = RANK_CASES[case](torch, rank, world, addr, work)
            res[case]["graph_counts"] = {
                k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()}
            free_card(torch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(work, f"{'-'.join(cases)}.{rank}.json"),
              "w") as f:
        json.dump(res, f)
    return 0


def _group(world):
    import torch.distributed as dist

    return dist.group.WORLD if world > 1 else None


def _flat_params(torch, model):
    return torch.cat([t.detach().reshape(-1).float()
                      for t in model.state_dict().values()])


def _equal_across_ranks(torch, t, group):
    """True on every rank when ``t`` is bitwise rank 0's (a broadcast, then
    a MIN of the per-rank verdicts)."""
    import torch.distributed as dist

    lead = t.clone()
    dist.broadcast(lead, src=0, group=group)
    same = torch.tensor([int(torch.equal(lead, t))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    return bool(same.item())


def _d1_slice_argv(work):
    return ["--checkpointdir", work, "--test_cp", "net.pt",
            "--packed_datadir", os.path.join(work, "packed"), "--conf", "4",
            "--num_outputs", "60", "--batchsize", "20",
            "--inner_representation_size", "128", "--batchnorm",
            "--vid_len", "8", "32", "--hbm_resident"]


def rank_d1(torch, rank, world, addr, work):
    """NCCL at world 1 through the CLI's own --dist_* flags: the --test_cp
    slice with --use_dataparallel against the plain run, bitwise; then
    all_reduce_grads, the synced BatchNorm (forward and backward) and
    gather_rows over the one-rank NCCL group against their no-group
    versions, bitwise; then the steps captured over it
    (d1_group_graphs)."""
    import numpy as np
    import torch.distributed as dist

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.core.layers import BatchNorm3d, set_data_group
    from mfas_tpu_torch.engine.classifier import valid_rows
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.parallel import mesh as pm

    argv = _d1_slice_argv(work)
    out = {"launches": {}}
    runs = {}
    for name, extra in (("plain", []), ("dataparallel", [
            "--use_dataparallel", "--dist_coordinator", addr,
            "--dist_num_processes", "1", "--dist_process_id", "0"])):
        tk.reset_launch_counts()
        run = tmain.main(argv + extra)
        out["launches"][name] = dict(tk.launch_counts)
        runs[name] = (run.acc, valid_rows(run.eval))
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1,
          "(d1) the CLI did not join a one-rank NCCL group")
    out["model_acc"] = [runs["plain"][0], runs["dataparallel"][0]]
    out["logits_bitwise"] = bool(np.array_equal(runs["plain"][1],
                                                runs["dataparallel"][1]))
    g = dist.group.WORLD
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda", torch.cuda.current_device())

    # all_reduce_grads: one flat buffer per dtype, SUM over one rank
    params = [torch.nn.Parameter(torch.zeros(s, device=dev, dtype=dt))
              for s, dt in (((512, 64), torch.float32), ((64,), torch.float32),
                            ((3, 5, 7), torch.bfloat16))]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
    want = [p.grad.clone() for p in params]
    pm.all_reduce_grads(params, g)
    out["all_reduce_grads_bitwise"] = all(
        torch.equal(p.grad, w) for p, w in zip(params, want))

    # the synced BatchNorm, forward and backward
    x0 = torch.randn((10, 64, 8, 56, 56), generator=gen, device=dev) * 2 + 1
    gy = torch.randn(x0.shape, generator=gen, device=dev)
    res = []
    for group in (None, g):
        bn = BatchNorm3d(64, device=dev)
        set_data_group(bn, group)
        x = x0.clone().requires_grad_()
        y = bn(x)
        (y * gy).sum().backward()
        res.append([y, x.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var])
    out["batchnorm_bitwise"] = all(torch.equal(a, b)
                                   for a, b in zip(*res))

    # gather_rows over the (one-rank) row-split store, with a frame pick
    store = np.random.RandomState(SEED).randint(
        0, 256, (12, 24, 64, 64, 3)).astype(np.uint8)
    local = torch.from_numpy(pm.split_rows(store, g)).to(dev)
    idx = torch.as_tensor([11, 0, 5, 5, 3, 7], device=dev)
    t = torch.as_tensor(np.random.RandomState(1).randint(0, 24, (6, 8)),
                        device=dev)

    def pick(st, rows):
        return st[rows[:, None], t]

    out["gather_rows_bitwise"] = bool(
        torch.equal(pm.gather_rows(local, idx, g),
                    pm.gather_rows(local, idx, None))
        and torch.equal(pm.gather_rows(local, idx, g, pick),
                        pm.gather_rows(local, idx, None, pick))
        and torch.equal(pm.gather_rows(local, idx, g).cpu(),
                        torch.from_numpy(store)[idx.cpu()]))
    free_card(torch)
    out["group_graphs"] = d1_group_graphs(torch, work, g)
    return out


@contextlib.contextmanager
def world_one_data_group():
    """The CLIs' --use_dataparallel takes the one-rank default group as its
    data group (their gate, ``parallel/mesh.py::data_group_from_args``,
    takes none below two processes), so they run their group paths over
    it."""
    import torch.distributed as dist

    from mfas_tpu_torch.parallel import mesh as pm

    real = pm.data_group_from_args
    pm.data_group_from_args = lambda args: (
        dist.group.WORLD if getattr(args, "use_dataparallel", False)
        else None)
    try:
        yield
    finally:
        pm.data_group_from_args = real


@contextlib.contextmanager
def forced_eager():
    """Every engine and trainer built inside runs its steps eagerly
    (``graphs.graphable`` says False): the eager reference of a graphed
    run."""
    from mfas_tpu_torch.runtime import graphs

    real = graphs.graphable
    graphs.graphable = lambda device, *groups: False
    try:
        yield
    finally:
        graphs.graphable = real


def _bitwise_runs(torch, a, b):
    """Whether two ``graphed_vs_eager(keep=True)`` runs hold the same
    tensors bitwise."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


D1_TIMED = 3    # (d1): timed train steps per mode, after a first
# (d1): (d4)'s search over the one-rank NCCL group, graphed and forced eager,
# with its bank and streamed, and streamed without the group
D1_SEARCHES = ("d4_bank_group", "d4_bank_group_eager", "d4_streamed_group",
               "d4_streamed_group_eager", "d4_streamed_no_group")


def d1_step_ms(torch, engine, model, batch, eta):
    """Median ms of D1_TIMED whole-net train steps after a first (the
    graphed mode's capture), eager then graphed, from one state."""
    import numpy as np

    from mfas_tpu_torch.engine.classifier import set_trainable, snapshot

    start, gen = snapshot(model), engine.generator.get_state()
    out = {}
    for mode in ("eager", "graphed"):
        model.load_state_dict(start)
        engine.generator.set_state(gen)
        engine.graphed = mode == "graphed"
        set_trainable(model, None)
        model.train()
        opt = engine.make_optimizer()
        times = []
        for _ in range(1 + D1_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.train_step(batch, opt, eta)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[mode] = float(np.median(times[1:])) * 1e3
        engine.release_graphs()
        del opt
        free_card(torch)
    model.load_state_dict(start)
    engine.generator.set_state(gen)
    engine.graphed = True
    return out


def d1_group_graphs(torch, work, group):
    """(d1)'s CUDA graphs over the one-rank NCCL ``group``: the full-width
    resident found step (K2 inside), MM-IMDB's two text lengths, and (d4)'s
    search with its bank and streamed. Each graphed run against its eager
    run under cuDNN's deterministic algorithms (``graphed_vs_eager``, the
    engines) or forced eager (the searches), and against the same steps or
    search without a group; the kernels' launches and the graph counts of
    each; the warm train steps' ms under the group (``d1_step_ms``; phase 8
    times the found net's step without one) and MM-IMDB's without."""
    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
    from mfas_tpu_torch.engine.classifier import place_batch, snapshot
    from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.runtime import graphs

    out = {}
    t0 = time.time()
    dev = torch.device("cuda", torch.cuda.current_device())

    def counted(name, fn):
        """``fn()`` with the kernels' launches and the graph counts from 0,
        both kept in ``out[name]``."""
        tk.reset_launch_counts()
        graphs.reset_graph_counts()
        r = fn()
        out[name] = {"launches": dict(tk.launch_counts),
                     "graphs": {k: dict(v)
                                for k, v in graphs.GRAPH_COUNTS.items()}}
        return r

    # the full-width resident found net, conf 4, B=20, f32, whole net
    args = tmain.parse_args(["--packed_datadir", os.path.join(work, "packed"),
                             *TRAIN_ARGV, "--hbm_resident",
                             "--use_dataparallel"])
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], dev)
    store = ResidentNTUStore(os.path.join(args.packed_datadir, "train"), dev,
                             args=args)
    loader = ResidentLoader(store, 20, d.Compose([
        d.AugCrop(), d.NormalizeLen(args.vid_len)]), shuffle=True)
    host = list(loader)
    start, runs = snapshot(model), {}
    for name, g in (("ntu_group", group), ("ntu_no_group", None)):
        model.load_state_dict(start)
        engine = tmain.make_engine(model, args, dev, g, store)
        engine.generator.manual_seed(SEED)
        check(engine.graphed, f"(d1) {name}: the engine is not graphed")
        batches = [place_batch(b, dev, g) for b in host]
        held, runs[name] = counted(name, lambda: graphed_vs_eager(
            torch, f"(d1) {name}", engine, model, None, batches,
            args.eta_max, keep=True))
        out[name]["graphed_vs_eager"] = held
        if g is not None:
            # phase 8 times the group-less step (warm f32 whole)
            out[name]["step_ms"] = d1_step_ms(torch, engine, model,
                                              batches[0], args.eta_max)
        del engine, batches
        free_card(torch)
    out["ntu_group_equals_no_group"] = _bitwise_runs(
        torch, runs["ntu_group"], runs["ntu_no_group"])
    del model, store, loader, runs
    free_card(torch)

    # MM-IMDB's padded-sequence net at two text lengths
    mm_args, build, mm_batches = padded_mm(torch)
    model = build()
    start, runs = snapshot(model), {}
    n = len(MM_TEXT_LENGTHS)
    for name, g in (("mm_group", group), ("mm_no_group", None)):
        model.load_state_dict(start)
        engine = MMIMDBEngine(model, dev, group=g)
        engine.generator.manual_seed(SEED)
        check(engine.graphed, f"(d1) {name}: the engine is not graphed")
        batches = [place_batch({k: v.cpu().numpy() for k, v in b.items()},
                               dev, g) for b in mm_batches]
        held, runs[name] = counted(name, lambda: graphed_vs_eager(
            torch, f"(d1) {name}", engine, model, None, batches,
            mm_args.eta_max, eval_batches=batches[:n], keep=True))
        out[name]["graphed_vs_eager"] = held
        out[name]["step_ms"] = d1_step_ms(torch, engine, model, batches[0],
                                          mm_args.eta_max)
        del engine, batches
        free_card(torch)
    out["mm_group_equals_no_group"] = _bitwise_runs(
        torch, runs["mm_group"], runs["mm_no_group"])
    del model, mm_batches, runs
    free_card(torch)

    # (d4)'s search over the group: the bank (fused epochs) and streamed
    bank = d4_argv(work) + ["--use_dataparallel", "--shard_feature_bank"]
    streamed = [a for a in bank if a not in (
        "--cache_features", "--shard_feature_bank")] + ["--epochs", "1"]
    argvs = {"d4_bank_group": bank, "d4_bank_group_eager": bank,
             "d4_streamed_group": streamed,
             "d4_streamed_group_eager": streamed,
             "d4_streamed_no_group": [a for a in streamed
                                      if a != "--use_dataparallel"]}
    with world_one_data_group():
        for name in D1_SEARCHES:
            argv, eager = argvs[name], name.endswith("_eager")
            with forced_eager() if eager else contextlib.nullcontext():
                out[name] = d4_search(torch, argv)
            free_card(torch)
    out["seconds"] = time.time() - t0
    return out


D2_ARGV = ["--conf", "4", "--num_outputs", "60", "--batchsize", "20",
           "--vid_len", "8", "32", "--drpt", "0",
           "--hbm_resident", "--random_backbones"]


def _d2_step(torch, tmain, args, init, group, dtype):
    """One phase-2 step in ``dtype`` (float64 under --remat), warm in
    float32 (a warm-up step, the weights and Adam reset, the measured
    step; float64 is not timed). Returns what it measured, the loss, the
    gradients and the BatchNorm statistics after it, and the model."""
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
    from mfas_tpu_torch.engine.classifier import place_batch, set_trainable
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda")
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], dev).to(dtype)
    store = ResidentNTUStore(os.path.join(args.packed_datadir, "train"), dev,
                             args=args)
    loader = ResidentLoader(store, 20, d.Compose([
        d.AugCrop(), d.NormalizeLen(args.vid_len)]), shuffle=True)
    batch = place_batch(next(iter(loader)), dev, group)
    engine = tmain.make_engine(model, args, dev, group, store)
    prep = engine.batch_prep
    engine.batch_prep = lambda b: {
        k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
        else v for k, v in prep(b).items()}
    set_trainable(model, None)
    model.train()
    for _ in ("warm-up", "measured")[dtype == torch.float64:]:
        model.load_state_dict(init)
        opt = engine.make_optimizer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = engine._train_step(batch, opt, 1e-3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out = {"launches": dict(tk.launch_counts), "step_ms": seconds * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "rows": int(batch["label"].shape[0])}
    grads = {n: p.grad for n, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return out, pm.reduce_sum(loss, group), grads, stats, model


def _d2_compare(torch, got, want):
    """Per tensor of ``got`` against ``want`` (both on the host): max |a -
    b| over the tensor's max, and the norm-wise relative error; and the
    whole gradient's norm-wise relative error."""
    out, num, den = {}, 0.0, 0.0
    for k, g in got.items():
        if g is None or want[k] is None:
            check(g is None and want[k] is None,
                  f"(d2) {k}: a gradient on one side only")
            continue
        w = want[k].double()
        d = g.double() - w
        out[k] = (float(d.abs().max() / w.abs().max().clamp_min(1e-300)),
                  float(d.norm() / w.norm().clamp_min(1e-300)))
        num += float(d.norm()) ** 2
        den += float(w.norm()) ** 2
    return out, (num / den) ** 0.5


def rank_d2(torch, rank, world, addr, work):
    """(d2) on ``world`` ranks from the weights in d2_init.pt, on the first
    resident train batch (B=20; 20 / world rows and one K2 launch per
    rank): one warm phase-2 step in float32, and one in float64 under
    --remat (the recomputation re-issues BatchNorm's reductions). World 1
    writes its results to d2_ref.pt; each rank of world 2 compares with
    them: in float64 every gradient within 1e-9 of its tensor's max, the
    loss within 1e-12 and the statistics within 1e-12 of their max; in
    float32 the loss within 1e-5, the statistics within 1e-5 of their max,
    and, against the float64 gradients, the whole gradient's norm-wise error
    at most twice one rank's float32 error (plus 1e-6) and no tensor's more
    than ten times (plus 1e-5; card_vs_cpu's rule); the ranks' parameters
    after each step bitwise equal."""
    from mfas_tpu_torch import main_found_ntu as tmain

    group = _group(world)
    init = torch.load(os.path.join(work, "d2_init.pt"), weights_only=True)
    res, out = {}, {}
    for name, dtype, extra in (("f32", torch.float32, []),
                               ("f64_remat", torch.float64, ["--remat"])):
        args = tmain.parse_args(["--packed_datadir",
                                 os.path.join(work, "packed"), *D2_ARGV,
                                 *extra])
        meta, loss, grads, stats, model = _d2_step(torch, tmain, args, init,
                                                   group, dtype)
        out[name] = meta
        res[name] = {"loss": float(loss),
                     "grads": {k: None if v is None else v.cpu()
                               for k, v in grads.items()},
                     "stats": {k: v.cpu() for k, v in stats.items()}}
        if group is not None:
            out[name]["params_bitwise_across_ranks"] = _equal_across_ranks(
                torch, _flat_params(torch, model), group)
        del model, grads, stats
        free_card(torch)
    if group is None:
        torch.save(res, os.path.join(work, "d2_ref.pt"))
        return {k: {**out[k], "loss": res[k]["loss"]} for k in out}
    ref = torch.load(os.path.join(work, "d2_ref.pt"), weights_only=True)
    for name in out:
        r, m = ref[name], res[name]
        out[name]["loss"] = m["loss"]
        out[name]["loss_rel"] = abs(m["loss"] - r["loss"]) / abs(r["loss"])
        out[name]["stats_err_rel_max"] = max(
            float((v - r["stats"][k]).abs().max() / r["stats"][k].abs().max())
            for k, v in m["stats"].items())
    f64, _ = _d2_compare(torch, res["f64_remat"]["grads"],
                         ref["f64_remat"]["grads"])
    out["f64_remat"]["grad_err_rel_max"] = max(v[0] for v in f64.values())
    truth = ref["f64_remat"]["grads"]
    mine, mine_all = _d2_compare(torch, res["f32"]["grads"], truth)
    one, one_all = _d2_compare(torch, ref["f32"]["grads"], truth)
    # per tensor, norm-wise: mine <= 10 x one rank's + 1e-5 (a floor: a
    # well-conditioned tensor's f32 error is 1e-7-1e-5, the whole
    # gradient's ~2.5e-2 here)
    excess = {k: mine[k][1] - 10 * one[k][1] for k in mine}
    worst = sorted(excess, key=excess.get, reverse=True)[:5]
    out["f32"].update(
        grad_err_vs_f64_worst={k: [mine[k][1], one[k][1]] for k in worst},
        grad_err_vs_f64_excess_max=excess[worst[0]],
        grad_err_vs_f64_ratio_max=max(mine[k][1] / one[k][1] for k in mine),
        grad_err_vs_f64_whole=[mine_all, one_all],
        grad_err_vs_one_rank_max=max(
            v[0] for v in _d2_compare(torch, res["f32"]["grads"],
                                      ref["f32"]["grads"])[0].values()),
        one_rank_vs_f64_max=max(v[0] for v in one.values()))
    return out


def rank_d3(torch, rank, world, addr, work):
    """``main_found_ntu --use_dataparallel --hbm_resident
    --shard_resident_store`` (one epoch per phase, --save_checkpoint) on
    this rank's part of the store: Model Acc, the kernels' launches, the
    file written."""
    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.ops import input_kernels as tk

    ck = os.path.join(work, "d3")
    argv = ["--checkpointdir", ck, "--packed_datadir",
            os.path.join(work, "packed"), *TRAIN_ARGV, "--hbm_resident",
            "--use_dataparallel", "--shard_resident_store",
            "--save_checkpoint"]
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    run = tmain.main(argv)
    return {"model_acc": run.acc, "launches": dict(tk.launch_counts),
            "saved": run.saved,
            "losses": [e["loss"] for r in run.train for e in r.epochs],
            "train_clips_per_s": [r.train_clips / r.train_seconds
                                  for r in run.train],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def write_d4_store(work):
    """(d4)'s packed store, in the pack_ntu layout, from SEED: labels
    balanced over D4_CLASSES; each clip's frames are grey 128 plus its
    class's colour (D4_COLOUR times a fixed direction per class) plus a
    per-clip colour jitter of the same size plus per-pixel uniform noise of
    +-D4_NOISE; its skeleton is (s4)'s N(0, 0.3) noise plus its class's pose
    (D4_POSE times a fixed N(0, 1) offset per joint coordinate and person)
    plus a per-clip jitter of the same size. Random frozen backbones then
    pool features that differ by class, so the first EPNAS step's
    candidates score apart, where on (s4)'s store every one scores 0 or
    1/60."""
    import numpy as np

    store = os.path.join(work, "d4_search")
    rs = np.random.RandomState(SEED + 4)
    colours = rs.uniform(-1, 1, (D4_CLASSES, 3)) * D4_COLOUR
    poses = rs.randn(D4_CLASSES, 3, 1, 25, 2) * D4_POSE
    frames, h, w, skel_frames = 24, 256, 256, 300
    for split, n in D4_SPLITS:
        out = os.path.join(store, split)
        os.makedirs(out)
        labels = rs.permutation(np.arange(n) % D4_CLASSES).astype(np.int32)
        rgb = np.lib.format.open_memmap(os.path.join(out, "rgb.npy"), "w+",
                                        np.uint8, (n, frames, h, w, 3))
        for i, c in enumerate(labels):
            base = 128.0 + colours[c] + rs.uniform(-1, 1, 3) * D4_COLOUR
            noise = rs.randint(-D4_NOISE, D4_NOISE + 1, (frames, h, w, 3),
                               dtype=np.int16)
            rgb[i] = np.clip(noise + np.round(base).astype(np.int16), 0,
                             255).astype(np.uint8)
        rgb.flush()
        del rgb
        ske = (rs.randn(n, 3, skel_frames, 25, 2) * 0.3 + poses[labels]
               + rs.randn(n, 3, 1, 25, 2) * D4_POSE).astype(np.float32)
        np.save(os.path.join(out, "ske.npy"), ske)
        np.save(os.path.join(out, "ske_len.npy"),
                np.full((n,), skel_frames, np.int32))
        np.save(os.path.join(out, "labels.npy"), labels)
        with open(os.path.join(out, "meta.json"), "w") as f:
            json.dump({"n": n, "frames": frames, "h": h, "w": w,
                       "max_skel_frames": skel_frames,
                       "stage": "synthetic"}, f)
    return store


def d4_argv(work):
    """(d4)'s search on one rank: ``--cache_features --batchnorm`` cut to
    one search iteration on write_d4_store's store."""
    return ["--packed_datadir", os.path.join(work, "d4_search"),
            "--checkpointdir", work, *SEARCH_ARGV, "--num_outputs",
            str(D4_CLASSES), "--cache_features", "--batchnorm",
            "--search_iterations", "1"]


def d4_search(torch, argv):
    """One in-process (d4) search: K1's launches and the graph counts (both
    from 0), the seconds, the candidates, the first step's confs and
    accuracies, the printed listing."""
    import io

    from mfas_tpu_torch import main_searchable_ntu as smain
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.runtime import graphs

    buf = io.StringIO()
    tk.reset_launch_counts()
    graphs.reset_graph_counts()
    with contextlib.redirect_stdout(buf):
        run = smain.main(argv)
    text = buf.getvalue()
    return {"launches": dict(tk.launch_counts),
            "graphs": {k: dict(v) for k, v in graphs.GRAPH_COUNTS.items()},
            "seconds": run.seconds,
            "candidates": run.candidates,
            "first_step": [[c, a] for L, entries in run.data.state()
                           if L == 1 for c, a in entries],
            "listing": text.split("Now listing best architectures\n")[1]
            .splitlines()}


def rank_d4(torch, rank, world, addr, work):
    """(d4) with ``--use_dataparallel --shard_feature_bank`` and a search
    state, then resumed from it: the first step's accuracies, the printed
    results, K1's launches."""
    argv = d4_argv(work) + ["--use_dataparallel", "--shard_feature_bank",
                            "--search_state",
                            os.path.join(work, "d4_state.pkl")]
    return {name: d4_search(torch, argv + extra)
            for name, extra in (("first", []),
                                ("resumed", ["--resume_search"]))}


def rank_d5(torch, rank, world, addr, work):
    """The CIFAR found net at the CLI's defaults with --drop_path 0.1:
    D5_STEPS train steps on one global batch of 128 (128 / world rows per
    rank); after each, the ranks' parameters and buffers must be bitwise
    equal (the same DropPath draws, the same reduced gradient)."""
    import numpy as np

    from mfas_tpu_torch import main_found_cifar as fmain
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.engine.classifier import place_batch, set_trainable

    group = _group(world)
    args = fmain.parse_args(["--data_dir", work, *D5_ARGV])
    model = fmain.build_model(args, fmain.parse_conf(args.conf), "cuda")
    engine = CifarEngine(model, "cuda", group=group)
    engine.generator.manual_seed(SEED)
    set_trainable(model, None)
    model.train()
    opt = engine.make_optimizer()
    rs = np.random.RandomState(SEED)
    batch = {"image": rs.randn(128, 3, 32, 32).astype(np.float32),
             "label": rs.randint(0, 10, 128).astype(np.int32),
             "_mask": np.ones(128, np.float32)}
    placed = place_batch(batch, "cuda", group)
    equal, times = [], []
    for _ in range(D5_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_step(placed, opt, 1e-3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        equal.append(_equal_across_ranks(torch, _flat_params(torch, model),
                                         group))
    return {"bitwise_after_each_step": equal, "step_ms": times,
            "rows": int(placed["label"].shape[0])}


RANK_CASES = {"d1": rank_d1, "d2": rank_d2, "d3": rank_d3, "d4": rank_d4,
              "d5": rank_d5}


def check_d1_group_graphs(r, d4_one):
    """(d1)'s CUDA graphs over the one-rank NCCL group (d1_group_graphs)
    against their eager runs, the runs without a group and the one-rank
    (d4) search ``d4_one``."""
    n = len(MM_TEXT_LENGTHS)
    want = {
        "ntu": ({"ClassifierEngine_train": {"captures": 1, "replays": 2},
                 "ClassifierEngine_eval": {"captures": 1, "replays": 1}},
                # K2 once per step: 3 replays, then 3 steps per eager run
                {"u8_normalize": 0, "u8_gather_normalize": 9}),
        "mm": ({"MMIMDBEngine_train": {"captures": n, "replays": 2 * n},
                "MMIMDBEngine_eval": {"captures": n, "replays": n}},
               {"u8_normalize": 0, "u8_gather_normalize": 0})}
    for net, (graphs_want, launches_want) in want.items():
        for name in (f"{net}_group", f"{net}_no_group"):
            check(r[name]["graphed_vs_eager"]["bitwise"],
                  f"(d1) {name}: graphed not bitwise eager: "
                  f"{r[name]['graphed_vs_eager']}")
            check(r[name]["graphs"] == graphs_want
                  and r[name]["launches"] == launches_want,
                  f"(d1) {name}: graphs {r[name]['graphs']}, launches "
                  f"{r[name]['launches']}")
        check(r[f"{net}_group_equals_no_group"],
              f"(d1) {net}: the group's graphed steps differ from the "
              "group-less ones")
    for name in ("d4_bank_group", "d4_bank_group_eager"):
        check(r[name]["first_step"] == d4_one["first_step"]
              and r[name]["listing"] == d4_one["listing"],
              f"(d1) {name}: the search differs from the one-rank (d4) "
              f"search: {r[name]['first_step']} vs {d4_one['first_step']}")
    streamed = ("d4_streamed_group", "d4_streamed_group_eager",
                "d4_streamed_no_group")
    for name in streamed[1:]:
        check(r[name]["first_step"] == r[streamed[0]]["first_step"]
              and r[name]["listing"] == r[streamed[0]]["listing"]
              and r[name]["launches"] == r[streamed[0]]["launches"],
              f"(d1) {name}: the streamed search differs from the graphed "
              f"one under the group")
    for name, programs in (
            ("d4_bank_group", ("population_train_epoch",
                               "population_eval_epoch")),
            ("d4_streamed_group", ("population_features",
                                   "population_train_step",
                                   "population_eval_step")),
            ("d4_streamed_no_group", ("population_features",
                                      "population_train_step",
                                      "population_eval_step"))):
        check(all(r[name]["graphs"].get(k, {}).get("replays", 0) > 0
                  for k in programs),
              f"(d1) {name}: graph counts {r[name]['graphs']}")
    for name in ("d4_bank_group_eager", "d4_streamed_group_eager"):
        check(not any(k.startswith("population_") for k in r[name]["graphs"]),
              f"(d1) {name}: captured {r[name]['graphs']}")
    check(r["d4_streamed_group"]["launches"]["u8_normalize"] > 0,
          f"(d1) the streamed search launched no K1: "
          f"{r['d4_streamed_group']['launches']}")
    ms = {k: r[k]["step_ms"] for k in ("ntu_group", "mm_group",
                                        "mm_no_group")}
    print(f"(d1) graphed over the one-rank NCCL group, bitwise eager and the "
          f"group-less steps: found NTU f32 B=20 "
          f"{json.dumps(r['ntu_group']['graphs'])}, K2 "
          f"{r['ntu_group']['launches']['u8_gather_normalize']}; MM-IMDB "
          f"lengths {list(MM_TEXT_LENGTHS)} "
          f"{json.dumps(r['mm_group']['graphs'])}; train step ms (median of "
          f"{D1_TIMED}, eager / graphed): {json.dumps(ms)}; (d4) bank search "
          f"{json.dumps(r['d4_bank_group']['graphs'])} equal to the one-rank "
          f"search, {r['d4_bank_group']['seconds']:.1f} s graphed, "
          f"{r['d4_bank_group_eager']['seconds']:.1f} s eager "
          f"({d4_one['seconds']:.1f} s without a group); streamed, one epoch:"
          f" {json.dumps(r['d4_streamed_group']['graphs'])}, "
          f"{r['d4_streamed_group']['seconds']:.1f} s graphed, "
          f"{r['d4_streamed_group_eager']['seconds']:.1f} s eager, "
          f"{r['d4_streamed_no_group']['seconds']:.1f} s without a group, "
          f"equal; {r['seconds']:.1f} s in all", flush=True)


def multi_gpu_phase(torch, work, train):
    """(d1)-(d5); returns the measured numbers and each run's kernel
    launches, by path."""
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    out = {"label": TIME_SHARING}
    t0 = time.time()
    free_card(torch)

    phase("(d4) its class-signal store and the one-rank search")
    t1 = time.time()
    write_d4_store(work)
    print(f"(d4) store written in {time.time() - t1:.1f} s", flush=True)
    d4_one = d4_search(torch, d4_argv(work))
    free_card(torch)

    phase("(d1) NCCL at world 1 through --dist_*")
    (d1,), out["d1_seconds"] = run_rank_processes(["d1"], 1, work)
    d1 = d1["d1"]
    check(d1["model_acc"][0] == d1["model_acc"][1] and d1["logits_bitwise"],
          f"(d1) --use_dataparallel at world 1 is not the plain run: {d1}")
    for k in ("all_reduce_grads_bitwise", "batchnorm_bitwise",
              "gather_rows_bitwise"):
        check(d1[k], f"(d1) {k}: False")
    check(all(c == {"u8_normalize": 0, "u8_gather_normalize": 3}
              for c in d1["launches"].values()),
          f"(d1) launches {d1['launches']}, want 3 of K2 per run")
    print(f"(d1) Model Acc {d1['model_acc']}, logits bitwise, primitives "
          f"bitwise over the one-rank NCCL group", flush=True)
    check_d1_group_graphs(d1["group_graphs"], d4_one)
    out["d1"] = d1

    phase("(d2) the one-rank step, full width, B=20")
    args = tmain.parse_args(["--packed_datadir", os.path.join(work, "packed"),
                             *D2_ARGV])
    net = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
    torch.save(net.state_dict(), os.path.join(work, "d2_init.pt"))
    del net
    (ref,), out["d2_one_rank_seconds"] = run_rank_processes(["d2"], 1,
                                                             work)
    ref = ref["d2"]
    # one pair of rank processes runs (d2)-(d5) in turn
    phase(f"(d2)-(d5) over two ranks ({TIME_SHARING})")
    os.makedirs(os.path.join(work, "d3"))
    ranks, out["d2_d5_seconds"] = run_rank_processes(
        ["d2", "d3", "d4", "d5"], 2, work)
    d2, d3, d4, d5 = ([r[c] for r in ranks] for c in ("d2", "d3", "d4", "d5"))
    # gloo runs its collectives on the host: nothing under it is captured
    for case, rs in (("d2", d2), ("d3", d3), ("d4", d4), ("d5", d5)):
        for i, r in enumerate(rs):
            check(r["graph_counts"] == {},
                  f"({case}) rank {i} captured under gloo: "
                  f"{r['graph_counts']}")
    print("(d2)-(d5) captured nothing under gloo", flush=True)
    for r in d2:
        for name in ("f32", "f64_remat"):
            m = r[name]
            check(m["launches"] == {"u8_normalize": 0,
                                    "u8_gather_normalize": 1}
                  and m["rows"] == 10, f"(d2) {name} launches/rows {m}")
            check(m["params_bitwise_across_ranks"],
                  f"(d2) {name}: the ranks' parameters differ after the step")
        f32, f64 = r["f32"], r["f64_remat"]
        check(f64["loss_rel"] <= 1e-12 and f64["stats_err_rel_max"] <= 1e-12
              and f64["grad_err_rel_max"] <= 1e-9,
              f"(d2) float64 two ranks against one: {f64}")
        check(f32["loss_rel"] <= 1e-5 and f32["stats_err_rel_max"] <= 1e-5,
              f"(d2) float32 loss / statistics: {f32}")
        mine, one = f32["grad_err_vs_f64_whole"]
        check(mine <= 2 * one + 1e-6 and f32["grad_err_vs_f64_excess_max"]
              <= 1e-5, f"(d2) float32 gradients of two ranks against float64:"
              f" whole {mine} vs one rank's {one}; worst tensors "
              f"{f32['grad_err_vs_f64_worst']}")
    f32, f64 = d2[0]["f32"], d2[0]["f64_remat"]
    print(f"(d2) float64 --remat: loss {f64['loss']:.12f} (one rank "
          f"{ref['f64_remat']['loss']:.12f}), gradients within "
          f"{f64['grad_err_rel_max']:.3e} of their max, statistics "
          f"{f64['stats_err_rel_max']:.3e}; float32: loss relative "
          f"{f32['loss_rel']:.3e}, statistics {f32['stats_err_rel_max']:.3e} "
          f"of their max, gradients {f32['grad_err_vs_one_rank_max']:.3e} of "
          f"their max from one rank's (one rank's f32 against f64: "
          f"{f32['one_rank_vs_f64_max']:.3e}), norm-wise against f64 "
          f"{f32['grad_err_vs_f64_whole'][0]:.3e} (one rank "
          f"{f32['grad_err_vs_f64_whole'][1]:.3e}), a tensor at most "
          f"{f32['grad_err_vs_f64_ratio_max']:.3f}x one rank's; f32 step "
          f"{[round(r['f32']['step_ms'], 1) for r in d2]} ms per rank vs "
          f"{ref['f32']['step_ms']:.1f} ms on one ({TIME_SHARING}); peak "
          f"{[round(r['f32']['peak_bytes'] / 2**30, 2) for r in d2]} GiB per "
          f"rank vs {ref['f32']['peak_bytes'] / 2**30:.2f}", flush=True)
    out["d2"] = {"one_rank": ref, "ranks": d2}

    want_acc = train["a_resident_f32"]["model_acc"]
    n_epochs = 2          # one per phase
    want_k1 = n_epochs * (BATCHES["train"] + BATCHES["dev"]) + BATCHES["test"]
    for r in d3:
        check(r["launches"] == {"u8_normalize": want_k1,
                                "u8_gather_normalize": 0},
              f"(d3) launches {r['launches']}, want {want_k1} of K1")
        check(all(np.isfinite(r["losses"])), f"(d3) losses {r['losses']}")
    check(d3[0]["model_acc"] == d3[1]["model_acc"],
          f"(d3) Model Acc differs across ranks: {d3}")
    check(abs(d3[0]["model_acc"] - want_acc) <= 2 / 50,
          f"(d3) Model Acc {d3[0]['model_acc']} vs one rank's {want_acc}")
    files = os.listdir(os.path.join(work, "d3"))
    check(d3[1]["saved"] is None and len(files) == 1 and d3[0]["saved"]
          and os.path.basename(d3[0]["saved"]) == files[0],
          f"(d3) checkpoints written: {files}, ranks {[r['saved'] for r in d3]}")
    args = tmain.parse_args(["--packed_datadir", "p", *TRAIN_ARGV])
    net = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
    net.load_state_dict(load_state_dict(d3[0]["saved"]), strict=True)
    del net
    print(f"(d3) Model Acc {d3[0]['model_acc']} on both ranks (one rank "
          f"{want_acc}); K1 {want_k1} launches per rank, K2 0; only rank 0 "
          f"wrote {files[0]}, which loads strictly; train clips/s per phase "
          f"{[[round(v, 2) for v in r['train_clips_per_s']] for r in d3]} "
          f"({TIME_SHARING})", flush=True)
    out["d3"] = {"ranks": d3, "one_rank_model_acc": want_acc}

    want_first = dict((tuple(map(tuple, c)), a)
                      for c, a in d4_one["first_step"])
    want_k1 = sum(-(-n // 20) for _, n in D4_SPLITS)
    check(d4_one["launches"] == {"u8_normalize": want_k1,
                                 "u8_gather_normalize": 0},
          f"(d4) one rank: launches {d4_one['launches']}, want {want_k1} "
          "of K1")
    for r in [{"first": d4_one}] + d4:
        first = r["first"]
        distinct = len(set(a for _, a in first["first_step"]))
        check(distinct >= D4_MIN_DISTINCT,
              f"(d4) {distinct} distinct first-step accuracies, want "
              f"{D4_MIN_DISTINCT}: the store's class signal did not reach "
              f"the candidates ({first['first_step']})")
        first["first_step_distinct"] = distinct
    for r in d4:
        first = r["first"]
        check(first["launches"] == {"u8_normalize": want_k1,
                                    "u8_gather_normalize": 0},
              f"(d4) launches {first['launches']}, want {want_k1} of K1")
        # the state holds the whole cut search: the resume trains nothing
        # and lists what the first run found
        check(r["resumed"]["listing"] == first["listing"]
              and r["resumed"]["candidates"] == 0,
              f"(d4) the resumed run: {r['resumed']}")
        got = dict((tuple(map(tuple, c)), a) for c, a in first["first_step"])
        check(set(got) == set(want_first), "(d4) other first-step confs")
        out.setdefault("d4_first_step_err_max", max(
            abs(got[c] - want_first[c]) for c in got))
    check(d4[0]["first"]["listing"] == d4[1]["first"]["listing"]
          and d4[0]["first"]["first_step"] == d4[1]["first"]["first_step"],
          "(d4) the ranks printed different results")
    check(out["d4_first_step_err_max"] <= 0.02,
          f"(d4) first-step accuracies {out['d4_first_step_err_max']} from "
          "the one-rank run's")
    accs = [a for _, a in d4[0]["first"]["first_step"]]
    print(f"(d4) {d4[0]['first']['candidates']} candidates per rank in "
          f"{d4[0]['first']['seconds']:.1f} s (one rank "
          f"{d4_one['seconds']:.1f} s); first-step accuracies "
          f"{min(accs):.4f}-{max(accs):.4f}, "
          f"{[r['first']['first_step_distinct'] for r in d4]} distinct per "
          f"rank ({d4_one['first_step_distinct']} on one), within "
          f"{out['d4_first_step_err_max']:.4f} of one rank's; both ranks "
          f"printed {d4[0]['first']['listing'][:1]}...; the resume agreed "
          f"({TIME_SHARING})", flush=True)
    out["d4"] = d4
    out["d4_one_rank"] = d4_one

    for r in d5:
        check(r["rows"] == 64 and r["bitwise_after_each_step"] ==
              [True] * D5_STEPS, f"(d5) {r}")
    print(f"(d5) parameters bitwise equal across ranks after each of "
          f"{D5_STEPS} steps; step ms per rank "
          f"{[[round(t, 1) for t in r['step_ms']] for r in d5]} "
          f"({TIME_SHARING})", flush=True)
    out["d5"] = d5
    out["seconds"] = time.time() - t0
    print(f"multi-GPU phase: {out['seconds']:.1f} s", flush=True)
    out["launches_by_path"] = {
        "u8_normalize": {
            **{f"multi_gpu_d3_sharded_store_rank{i}":
               r["launches"]["u8_normalize"] for i, r in enumerate(d3)},
            **{f"multi_gpu_d4_sharded_bank_search_rank{i}":
               r["first"]["launches"]["u8_normalize"]
               for i, r in enumerate(d4)},
            "multi_gpu_d4_search_one_rank":
            d4_one["launches"]["u8_normalize"],
            **{f"multi_gpu_d1_{k}": d1["group_graphs"][k]["launches"][
                "u8_normalize"] for k in D1_SEARCHES}},
        "u8_gather_normalize": {
            **{f"multi_gpu_d1_world1_{k}": v["u8_gather_normalize"]
               for k, v in d1["launches"].items()},
            **{f"multi_gpu_d1_{k}": d1["group_graphs"][k]["launches"][
                "u8_gather_normalize"] for k in ("ntu_group", "ntu_no_group")},
            **{f"multi_gpu_d2_{name}_step_rank{i}":
               r[name]["launches"]["u8_gather_normalize"]
               for i, r in enumerate(d2) for name in ("f32", "f64_remat")},
            **{f"multi_gpu_d2_{name}_step_one_rank":
               ref[name]["launches"]["u8_gather_normalize"]
               for name in ("f32", "f64_remat")}}}
    return out


# --------------------------------------------------------------------------
# phase (n): the rest of the NTU vertical (the layout options, the sweep,
# the fusion baselines)
# --------------------------------------------------------------------------
# (n1): ResNet-50's layer shapes at B=2, 8 frames, 256 px:
# (name, function, input shape, weight shape, kwargs, options)
N1_CONVS = (
    ("stem_conv2d", "conv2d", (16, 3, 256, 256), (64, 3, 7, 7),
     dict(stride=2, padding=3), ("conv_channels_last",)),
    ("layer1_conv1x1x1", "conv3d", (2, 64, 8, 64, 64), (64, 64, 1, 1, 1),
     {}, ("conv1x1_as_matmul", "conv3d_as_2d", "conv_channels_last")),
    ("layer1_conv3x3x3", "conv3d", (2, 64, 8, 64, 64), (64, 64, 3, 3, 3),
     dict(padding=1), ("conv3d_as_2d", "conv_channels_last")),
    ("layer2_downsample_s122", "conv3d", (2, 256, 8, 64, 64),
     (512, 256, 1, 1, 1), dict(stride=(1, 2, 2)),
     ("conv1x1_as_matmul", "conv3d_as_2d", "conv_channels_last")),
    ("layer4_conv3x3x3_s122", "conv3d", (2, 512, 8, 16, 16),
     (512, 512, 3, 3, 3), dict(stride=(1, 2, 2), padding=1),
     ("conv3d_as_2d", "conv_channels_last")),
)
N1_POOL = ("stem_max_pool", (16, 64, 128, 128), dict(kernel_size=3,
                                                     stride=2, padding=1),
           ("pool_as_slices", "pool_separable"))
N1_TOL = {"float64": 1e-10, "float32": 1e-4}    # of the default's max
N2_WARM = (1, 3)        # warm phase-2 steps per turn: untimed, timed
N3_VARIANTS = ["f32_B16", "bf16_B16", "bf16_B16_chlast", "bf16_B16_3das2d",
               "bf16_B16_seppool"]
N3_LOSS_TOL = {False: 1e-4, True: 5e-3}     # first-step loss, relative
N4_EVAL = (20, 8, 2, 5)     # B, frames, untimed, timed forwards
N4_PX = (256, 224)          # the eval forwards' px; CentralNet's second
N4_STEP = (1, 2, 224)       # card vs CPU: B, frames, px
N4_TOL = (1e-9, 1e-6)       # forward, gradients: of the CPU's max
BASELINES = ("LateFusion", "GMU", "CentralNet")


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-300)).item()


def layout_options_full_width(torch):
    """(n1): every option's formulation of each conv and of the stem's max
    pool against the default, values and input gradients (the gradient of
    sum(out * g) for a random g), in float64 and float32; the pool's input
    is tie-free (a permutation of 2^24 distinct values), since at tied
    maxima the options may route the gradient to another element."""
    from mfas_tpu_torch.core import functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}

    def run(fn, x, args, options):
        x = x.detach().requires_grad_(True)
        before = F.OPTION_CALLS.copy()
        with F.layout_options(**{o: True for o in options}):
            y = fn(x, *args)
            cot = torch.randn(y.shape, dtype=y.dtype, device="cuda",
                              generator=torch.Generator(
                                  device="cuda").manual_seed(SEED + 1))
            (gx,) = torch.autograd.grad(y, x, cot)
        torch.cuda.synchronize()
        return y.detach(), gx, F.OPTION_CALLS - before

    cases = [(name, getattr(F, fn), xs, (ws,), kw, opts)
             for name, fn, xs, ws, kw, opts in N1_CONVS]
    cases.append((N1_POOL[0], F.max_pool2d, N1_POOL[1], (), N1_POOL[2],
                  N1_POOL[3]))
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        for name, fn, xs, ws, kw, opts in cases:
            if ws:
                x = torch.randn(xs, dtype=dt, device="cuda", generator=g)
                w = torch.randn(ws[0], dtype=dt, device="cuda", generator=g)
                w = w / w[0].numel() ** 0.5
                args = (w, None)
            else:
                n = 1
                for d in xs:
                    n *= d
                x = (torch.randperm(n, device="cuda", generator=g)
                     .to(dt).reshape(xs) / n)
                args = ()

            def call(xx, *a):
                return fn(xx, *a, **kw)

            ref_y, ref_g, calls = run(call, x, args, ())
            check(not calls, f"(n1) {name}: the default took {calls}")
            for opt in opts:
                y, gx, calls = run(call, x, args, (opt,))
                check(calls[opt] > 0, f"(n1) {name} {opt}: the option's "
                      f"formulation never ran ({dict(calls)})")
                ev, eg = _rel_err(y, ref_y), _rel_err(gx, ref_g)
                tol = N1_TOL[dname]
                check(y.shape == ref_y.shape and ev <= tol and eg <= tol,
                      f"(n1) {name} {opt} {dname}: value {ev:.3e}, input "
                      f"gradient {eg:.3e} of the default's max (tol {tol})")
                out[f"{name}/{opt}/{dname}"] = {"value_err": ev,
                                                "grad_err": eg}
            del x, args
    worst = {d: max(max(v.values()) for k, v in out.items()
                    if k.endswith(d)) for d in N1_TOL}
    print(f"(n1) {len(out)} option/shape/dtype cases, values and input "
          f"gradients within {worst['float64']:.3e} (f64) and "
          f"{worst['float32']:.3e} (f32) of the default's max", flush=True)
    return {"cases": out, "worst": worst}


def _timed_train_steps(torch, engine, batch, opt, eta, n_warm, n_timed):
    """-> (median ms, peak bytes over the timed steps) of warm steps."""
    import numpy as np

    times = []
    for i in range(n_warm + n_timed):
        if i == n_warm:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = engine._train_step(batch, opt, eta)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(np.isfinite(float(loss)), f"(n2) loss {loss}")
    return (float(np.median(times[n_warm:])) * 1e3,
            torch.cuda.max_memory_allocated())


def channels_last_training(torch, tk, work, packed, train):
    """(n2): ``main_found_ntu --conv_channels_last --hbm_resident``, one
    epoch per phase on (a)'s store, against (a); then warm phase-2 steps in
    f32 and under --bf16, NCDHW and channels-last in turns (plain, chlast,
    chlast, plain), each turn's median and peak memory."""
    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.core import functional as F
    from mfas_tpu_torch.core.layers import to_channels_last
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
    from mfas_tpu_torch.engine.classifier import place_batch, set_trainable

    phase("(n2) --conv_channels_last training, full width")
    want_acc = train["a_resident_f32"]["model_acc"]
    base = ["--checkpointdir", work, "--packed_datadir", packed, *TRAIN_ARGV,
            "--hbm_resident"]
    free_card(torch)
    tk.reset_launch_counts()
    before = F.OPTION_CALLS["conv_channels_last"]
    t0 = time.time()
    run = tmain.main(base + ["--conv_channels_last"])
    wall = time.time() - t0
    counts = dict(tk.launch_counts)
    want = 2 * (BATCHES["train"] + BATCHES["dev"]) + BATCHES["test"]
    check(counts == {"u8_normalize": 0, "u8_gather_normalize": want},
          f"(n2) launches {counts}, want {want} of K2")
    check(F.OPTION_CALLS["conv_channels_last"] > before
          and not F.CONV_CHANNELS_LAST,
          "(n2) the run took no channels-last conv, or left the option on")
    check(abs(run.acc - want_acc) <= 2 / 50,
          f"(n2) Model Acc {run.acc} vs (a)'s {want_acc}")
    phases = [{"train_clips_per_s": r.train_clips / r.train_seconds,
               "peak_bytes": p}
              for r, p in zip(run.train, run.train_peak_bytes)]
    print(f"(n2) Model Acc {run.acc} ((a) {want_acc}), K2 {want} launches, "
          f"run {wall:.1f} s, train clips/s per phase "
          f"{[round(p['train_clips_per_s'], 2) for p in phases]}", flush=True)
    out = {"model_acc": run.acc, "a_model_acc": want_acc,
           "launches": counts["u8_gather_normalize"], "run_seconds": wall,
           "phases": phases}
    del run

    n_warm, n_timed = N2_WARM
    for mode, extra in (("f32", []), ("bf16", ["--bf16"])):
        args = tmain.parse_args(["--packed_datadir", packed,
                                 "--hbm_resident", *TRAIN_ARGV, *extra])
        store = ResidentNTUStore(os.path.join(packed, "train"), "cuda",
                                 args=args)
        loader = ResidentLoader(store, args.batchsize,
                                Compose([NormalizeLen(args.vid_len)]))
        batch = place_batch(next(iter(loader)), "cuda")
        nets = {}
        for layout in ("plain", "chlast"):
            model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cuda")
            if layout == "chlast":
                to_channels_last(model)
            engine = tmain.make_engine(model, args, "cuda")
            set_trainable(model, None)
            model.train()
            nets[layout] = (engine, engine.make_optimizer())
        turns = []
        for layout in ("plain", "chlast", "chlast", "plain"):
            engine, opt = nets[layout]
            with F.layout_options(conv_channels_last=layout == "chlast"):
                ms, peak = _timed_train_steps(torch, engine, batch, opt,
                                              args.eta_max, n_warm, n_timed)
            turns.append({"layout": layout, "step_ms": ms,
                          "peak_bytes": peak})
        out[f"warm_{mode}"] = turns
        print(f"(n2) warm phase-2 steps {mode}, B=20, in turns: "
              + ", ".join(f"{t['layout']} {t['step_ms']:.1f} ms "
                          f"({t['peak_bytes'] / 2**30:.2f} GiB)"
                          for t in turns), flush=True)
        del nets, engine, opt, store, loader, batch
        free_card(torch)
    return out


def sweep_run(torch):
    """(n3): the sweep tool on N3_VARIANTS; each variant's formulation ran,
    and its first-step loss is its precision's default's within
    N3_LOSS_TOL."""
    import numpy as np

    from mfas_tpu_torch.tools import bf16_sweep

    phase("(n3) mfas_tpu_torch.tools.bf16_sweep")
    res = bf16_sweep.main(N3_VARIANTS)
    names = {"chlast": "conv_channels_last", "3das2d": "conv3d_as_2d",
             "seppool": "pool_separable"}
    for name, r in res.items():
        check("error" not in r and np.isfinite(r["first_loss"]),
              f"(n3) {name}: {r}")
        named = {names[t] for t in name.split("_")[2:]}
        took = {o for o, n in r["option_calls"].items() if n}
        check(took == named, f"(n3) {name} took {took}, wants {named}")
        base = res["bf16_B16" if r["bf16"] else "f32_B16"]["first_loss"]
        rel = abs(r["first_loss"] - base) / abs(base)
        check(rel <= N3_LOSS_TOL[r["bf16"]],
              f"(n3) {name} first-step loss {r['first_loss']} vs {base}")
        r["first_loss_rel_err"] = rel
    print("(n3) first-step losses within "
          + ", ".join(f"{k} {v['first_loss_rel_err']:.2e}"
                      for k, v in res.items()), flush=True)
    return res


def _baseline(torch, name, args, device, seed=SEED):
    from mfas_tpu_torch.models import ntu as TN

    return getattr(TN, name)(args, device=device,
                             generator=torch.Generator().manual_seed(seed))


def baselines_phase(torch, tk):
    """(n4): LateFusion, GMU and CentralNet at full width: eval forwards at
    B=20, 8 frames, 256 px on K1-normalized clips (CentralNet also at 224
    px, where it aligns the skeleton maps by downsampling), clips/s and
    peak memory; then each card against the CPU in float64 at N4_STEP:
    the eval forward within 1e-9 of max, one train step's gradients within
    1e-6 of each tensor's max (LateFusion and GMU over every parameter,
    CentralNet over central_params()); the gradients that vanish
    analytically, named, below 1e-12 of the largest on both sides."""
    import types

    import numpy as np

    from mfas_tpu_torch.core.layers import set_dropout_generator
    from mfas_tpu_torch.engine.classifier import set_trainable

    phase("(n4) the NTU fusion baselines, full width")
    B, T, n_warm, n_timed = N4_EVAL
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ske = torch.randn((B, 3, 32, 25, 2), device="cuda", generator=g)
    out = {"eval": {}}
    tk.reset_launch_counts()
    for name, px in ([(n, N4_PX[0]) for n in BASELINES]
                     + [("CentralNet", N4_PX[1])]):
        args = types.SimpleNamespace(num_outputs=60, vid_len=(T, 32),
                                     drpt=0.4, num_classes=60)
        net = _baseline(torch, name, args, "cuda").eval()
        clips = torch.randint(0, 256, (B, T, px, px, 3), dtype=torch.uint8,
                              device="cuda", generator=g)
        times = []
        with torch.inference_mode():
            for i in range(n_warm + n_timed):
                if i == n_warm:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                logits = net((tk.u8_normalize(clips, MEAN, STD), ske))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        check(logits.shape == (B, 60) and bool(torch.isfinite(logits).all()),
              f"(n4) {name} at {px} px: logits {tuple(logits.shape)}")
        ms = float(np.median(times[n_warm:])) * 1e3
        r = {"forward_ms": ms, "eval_clips_per_s": B / ms * 1e3,
             "peak_bytes": torch.cuda.max_memory_allocated()}
        out["eval"][f"{name}_{px}px"] = r
        print(f"(n4) {name} at {px} px, B={B}: eval forward {ms:.1f} ms, "
              f"{r['eval_clips_per_s']:.2f} clips/s (K1 included), peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del net, clips, logits
        free_card(torch)
    counts = dict(tk.launch_counts)
    want = (len(BASELINES) + 1) * (n_warm + n_timed)
    check(counts == {"u8_normalize": want, "u8_gather_normalize": 0},
          f"(n4) launches {counts}, want {want} of K1")
    out["launches"] = counts["u8_normalize"]

    Bs, Ts, px = N4_STEP
    rs = np.random.RandomState(SEED)
    rgb = torch.from_numpy(rs.randn(Bs, Ts, px, px, 3)).double()
    sk = torch.from_numpy(rs.randn(Bs, 3, 32, 25, 2)).double()
    label = torch.tensor([7] * Bs)
    # parameters outside the loss's graph (no gradient): GMU reads the
    # skeleton's out7 and the video's pooled embedding, not their heads;
    # CentralNet uses three of its four alphas per list. CentralNet's
    # gradients that vanish analytically: alphas_c.0 weighs the zero
    # starting maps, a conv bias ahead of a train-mode BatchNorm leaves
    # with the batch mean
    unused = {"LateFusion": set(),
              "GMU": {f"{m}.{p}" for m in ("skeleton.fc7.0", "skeleton.fc8",
                                            "visual.classifier")
                      for p in ("weight", "bias")},
              "CentralNet": {"alphas_a.3", "alphas_v.3", "alphas_c.3"}}
    vanishing = {"alphas_c.0", "central_conv.0.0.bias",
                 "central_conv.1.0.bias"}
    out["card_vs_cpu"] = {}
    for name in BASELINES:
        args = types.SimpleNamespace(num_outputs=60, vid_len=(Ts, 32),
                                     drpt=0.0, num_classes=60)
        res = {}
        for dev in ("cuda", "cpu"):
            net = _baseline(torch, name, args, dev).double()
            x = (rgb.to(dev), sk.to(dev))
            with torch.no_grad():
                fwd = net.eval()(x)
            net.train()
            set_dropout_generator(net, torch.Generator(device=dev))
            set_trainable(net, net.central_params() if name == "CentralNet"
                          else None)
            torch.nn.functional.cross_entropy(net(x), label.to(dev)).backward()
            res[dev] = (fwd.cpu(), {k: (None if p.grad is None
                                        else p.grad.cpu())
                                    for k, p in net.named_parameters()
                                    if p.requires_grad})
            del net
        (fc, gc), (fp, gp) = res["cuda"], res["cpu"]
        fwd_err = _rel_err(fc, fp)
        check(fwd_err <= N4_TOL[0], f"(n4) {name} f64 forward card vs CPU "
              f"{fwd_err:.3e} of max")
        largest = max(v.abs().max().item() for v in gp.values()
                      if v is not None)
        errs, named = {}, []
        for k, want_g in gp.items():
            got_g = gc[k]
            if k in unused[name]:
                check(got_g is None and want_g is None,
                      f"(n4) {name} {k}: a gradient where none flows")
                named.append(k)
                continue
            if k in vanishing and name == "CentralNet":
                check(max(got_g.abs().max().item(), want_g.abs().max().item())
                      <= 1e-12 * largest, f"(n4) {name} {k} does not vanish")
                named.append(k)
                continue
            errs[k] = _rel_err(got_g, want_g)
        worst = max(errs, key=errs.get)
        check(errs[worst] <= N4_TOL[1], f"(n4) {name} f64 gradient {worst} "
              f"card vs CPU {errs[worst]:.3e} of its max")
        out["card_vs_cpu"][name] = {"forward_err": fwd_err,
                                    "grad_err_max": errs[worst],
                                    "worst": worst, "tensors": len(errs),
                                    "named_vanishing": named}
        print(f"(n4) {name} card vs CPU, f64, B={Bs}, {Ts} frames, {px} px: "
              f"forward {fwd_err:.3e} of max, {len(errs)} gradients within "
              f"{errs[worst]:.3e} ({worst}); named {named}", flush=True)
    return out


def ntu_rest_phase(torch, tk, work, packed, train):
    """Phase (n): (n1)-(n4); returns the numbers and the K1/K2 launches of
    (n2)'s CLI run and (n4)'s forwards."""
    t0 = time.time()
    phase("(n1) the layout options at full-width shapes")
    out = {"n1_layout_options": layout_options_full_width(torch)}
    free_card(torch)
    out["n2_channels_last"] = channels_last_training(torch, tk, work, packed,
                                                     train)
    out["n3_sweep"] = sweep_run(torch)
    free_card(torch)
    out["n4_baselines"] = baselines_phase(torch, tk)
    out["seconds"] = time.time() - t0
    print(f"phase (n): {out['seconds']:.1f} s", flush=True)
    return out


# (bench): the lean run takes ~175 s on the H100; its soft budget, and the
# limit after which the process is killed and the phase fails
BENCH_BUDGET_S = 360
BENCH_TIMEOUT_S = 480
BENCH_SECTIONS = ("bench_proxy", "bench_search_wallclock", "bench_e2e_input")
# (bench)'s K1/K2 paths: {kernel_launches entry: (K1 wanted, K2 wanted)}
BENCH_PATHS = {"bench_search_wallclock": (True, False),
               "bench_e2e_input/streamed": (True, False),
               "bench_e2e_input/resident": (False, True),
               "bench_e2e_input/resident_bf16": (False, True),
               "bench_e2e_input/step_only": (True, False)}


def _finite_positive(x):
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def bench_phase(kind, work, root):
    """Phase (bench): ``python3 -m mfas_tpu_torch.bench`` in the lean
    profile at full width (B=16, 256 px, K=15), a process of its own with
    its sidecar in ``work``; its record and its sections' kernel launches
    are checked.
    Returns the compact record, the sidecar's launches and figures."""
    phase("(bench) mfas_tpu_torch.bench, lean profile, full width")
    detail_file = os.path.join(work, "bench_detail.cuda.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MFAS_BENCH_")}
    env["MFAS_BENCH_BUDGET_S"] = str(BENCH_BUDGET_S)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "mfas_tpu_torch.bench", "--detail_file",
         detail_file], cwd=root, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    seconds = time.time() - t0
    records = []
    for line in proc.stdout.splitlines():
        if line.startswith('{"metric"'):
            records.append(json.loads(line))
            print(f"(bench) {line}", flush=True)
    if proc.returncode != 0 or not records:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
    check(proc.returncode == 0,
          f"(bench) the bench exited {proc.returncode} after {seconds:.1f} s")
    check(records, "(bench) the bench printed no record")
    last = records[-1]
    check("errors" not in last,
          f"(bench) section errors {last.get('error_keys')}")
    check("partial_after_section" not in last,
          f"(bench) the last record is partial: {last}")
    done = [r.get("partial_after_section") for r in records[:-1]]
    check(done == list(BENCH_SECTIONS),
          f"(bench) sections completed {done}, want {list(BENCH_SECTIONS)}")
    with open(detail_file) as f:
        detail = json.load(f)["detail"]
    check(detail["device_kind"] == kind,
          f"(bench) device_kind {detail['device_kind']!r}, want {kind!r}")
    check((detail["batch"], detail["img"], detail["K"]) == (16, 256, 15),
          f"(bench) the proxy ran at {detail['batch']}, {detail['img']} px, "
          f"K={detail['K']}")
    check(_finite_positive(last["value"])
          and _finite_positive(detail["search_speedup_proxy"]),
          f"(bench) headline {last['value']}, proxy "
          f"{detail['search_speedup_proxy']}")
    launches = detail["kernel_launches"]
    for path, (want_k1, want_k2) in BENCH_PATHS.items():
        got = launches[path]
        check((got["u8_normalize"] > 0) == want_k1
              and (got["u8_gather_normalize"] > 0) == want_k2,
              f"(bench) {path} launched {got}: want K1 {want_k1}, "
              f"K2 {want_k2}")
    print(f"(bench) the bench in {seconds:.1f} s: headline {last['value']} x, "
          f"proxy {detail['search_speedup_proxy']} x, launches "
          + ", ".join(f"{s} {launches[s]}" for s in BENCH_SECTIONS),
          flush=True)
    return {"record": last, "seconds": seconds, "kernel_launches": launches,
            "power_limit_w": detail["power_limit_w"],
            "kernel_build_s": detail["kernel_build_s"],
            "found_train_step_tflops": detail.get("found_train_step_tflops"),
            "mfu_estimate": detail.get("mfu_estimate"),
            "e2e_breakdown_per_batch_s":
            detail.get("e2e_breakdown_per_batch_s"),
            "search_wallclock_run_spreads_s":
            detail.get("search_wallclock_run_spreads_s")}


HBM_BYTES_PER_S = 3.35e12


def input_kernel_bound_ms(out_itemsize):
    n = 1
    for d in K1_SHAPE:
        n *= d
    return n * (1 + out_itemsize) / HBM_BYTES_PER_S * 1e3


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    from mfas_tpu_torch.ops import batchnorm as tbn
    from mfas_tpu_torch.ops import input_kernels as tk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    phase("device")
    smi = nvidia_smi()
    print(smi)
    card_state("at start")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")

    phase("kernel build")
    t0 = time.time()
    tk.load_library()
    print(f"input kernels built/loaded in {time.time() - t0:.2f} s")
    log = tk.build_log() or ""
    for line in log.splitlines():
        if "ptxas info" in line:
            print(line.strip())

    err, ms = kernel_phases(torch, tk)
    free_card(torch)
    t0 = time.time()
    for dt in (torch.float32, torch.bfloat16):
        tbn.load_library(dt)
    print(f"BatchNorm kernels (f32, bf16) built/loaded in "
          f"{time.time() - t0:.2f} s")
    bn_err, bn_ms = bn_kernel_phase(torch, tbn)

    work = os.path.join(root, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        packed = write_store(work)
        runs = slice_phase(torch, work, packed)
        free_card(torch)
        train = training_phase(torch, work, packed)
        free_card(torch)
        warm = warm_train_steps(torch, work, packed)
        step = card_vs_cpu(torch, packed)
        free_card(torch)
        search = search_phase(torch, work, packed)
        search["card_vs_cpu"] = search_card_vs_cpu(torch, packed)
        free_card(torch)
        serving = {"i1_native_io": native_io(torch, work, packed)}
        ntu, i2_logits = ntu_default_inputs(torch, tk, work, packed, runs,
                                            train)
        serving.update(ntu)
        serving["i4_search"] = ntu_search_host(torch, tk, work)
        serving["i6_ntu"] = serve(
            torch, tk, "NTU", work,
            ["ntu", "--conf", "4", "--inner_representation_size", "128",
             "--batchnorm", "--test_cp", "net.pt", "--checkpointdir", work],
            ["--packed_datadir", packed, "--batchsize", "20",
             "--vid_len", "8", "32"],
            serving["i2_found_eval"]["model_acc"], want_logits=i2_logits,
            bf16=True)
        free_card(torch)
        avmnist = avmnist_phase(torch, tk, work)
        free_card(torch)
        mmimdb = mmimdb_phase(torch, tk, work)
        free_card(torch)
        cifar = cifar_phase(torch, tk, work)
        free_card(torch)
        tools = tools_phase(torch, tk, work, root, search)
        free_card(torch)
        multi = multi_gpu_phase(torch, work, train)
        free_card(torch)
        rest = ntu_rest_phase(torch, tk, work, packed, train)
        free_card(torch)
        bench = bench_phase(kind, work, root)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"slice": {
        k: {"model_acc": r["acc"],
            "eval_clips_per_s_cold": r["cold_clips_per_s"],
            "eval_clips_per_s_warm": r["warm_clips_per_s"],
            "peak_bytes": r["peak_bytes"]} for k, r in runs.items()},
        "nvidia_smi": smi}))
    print(json.dumps({"training": train, "warm_train_steps": warm,
                      "card_vs_cpu_step": step, "nvidia_smi": smi}))
    print(json.dumps({"search": search, "nvidia_smi": smi}))
    print(json.dumps({"avmnist": avmnist, "nvidia_smi": smi}))
    print(json.dumps({"mmimdb": mmimdb, "nvidia_smi": smi}))
    print(json.dumps({"cifar": cifar, "nvidia_smi": smi}))
    for name, phase_out in (("avmnist", avmnist), ("mmimdb", mmimdb),
                            ("cifar", cifar)):
        serving[f"i6_{name}"] = phase_out["i6_serving"]
    print(json.dumps({"serving": serving, "nvidia_smi": smi}))
    print(json.dumps({"tools": tools, "nvidia_smi": smi}))
    print(json.dumps({"multi_gpu": multi, "nvidia_smi": smi}))
    print(json.dumps({"ntu_rest": rest, "nvidia_smi": smi}))
    print(json.dumps({"bench": bench, "nvidia_smi": smi}))
    src = "mfas_tpu_torch/csrc/input_kernels.cu"
    # launches: K1's on its two main paths (streamed training, one per
    # train, dev and test batch; the default search, s1) and in the bank
    # builds of the per-step bank search (s6, graphed and eager), K2's on
    # the resident training runs (f32, and --remat from its graph
    # replays); the AV-MNIST, MM-IMDB and CIFAR paths and the
    # operator tools' (t) launch neither. Phase (d) adds each rank's: K2 on
    # the replicated store ((d1), (d2); in (d1) also from the found step's
    # graph replays under the NCCL group and without it), K1 on the sharded
    # store (d3) and in the sharded-bank search's extraction (d4, each rank
    # and the one-rank reference; in (d1) each of its searches over the
    # group, the streamed ones from the features' replays). Phase (n) adds
    # K2 in --conv_channels_last training (n2) and K1 in the baselines'
    # eval forwards (n4). Phase (bench), the bench in its own process, adds K1
    # in its search and streamed-input sections and K2 in its resident one.
    # One PyTorch call computes K1's function: torch.addcmul(bias, x_u8,
    # scale), timed beside K1 as its yardstick (library_ms) and called
    # nowhere in the port. None computes K2's: a gather and then the
    # affine are two calls, so its library_ms is null (gather + K1 stands
    # beside K2 in the kernel_times line)
    others = {f"{name}_phase": {k: phase_out["input_kernel_launches"][k]
                                for k in ("u8_normalize",
                                          "u8_gather_normalize")}
              for name, phase_out in (("avmnist", avmnist),
                                      ("mmimdb", mmimdb),
                                      ("cifar", cifar), ("tools", tools))}
    # the host-normalized NTU paths and every predict of phase (i) launch
    # neither
    host = {"found_eval_host_normalize_i2":
            serving["i2_found_eval"]["k1_launches"],
            "found_training_host_normalize_i3":
            serving["i3_found_training"]["k1_launches"],
            "search_host_normalize_i4": serving["i4_search"]["k1_launches"]}
    predicts = {f"predict_{k[3:]}_i6": v["input_kernel_launches"]
                for k, v in serving.items() if k.startswith("i6_")}
    bench_paths = {k: bench["kernel_launches"][k] for k in BENCH_SECTIONS}
    k1_paths = {"found_training_packed_f32": train["b_packed_f32"]["launches"],
                "search_default_s1": search["s1_default"]["k1_launches"],
                "search_bank_per_step_s6":
                search["s6_bank_per_step"]["k1_launches"],
                **{k: v["u8_normalize"] for k, v in others.items()},
                **host,
                **{k: v["u8_normalize"] for k, v in predicts.items()},
                **multi["launches_by_path"]["u8_normalize"],
                "baselines_eval_n4": rest["n4_baselines"]["launches"],
                **{k: v["u8_normalize"] for k, v in bench_paths.items()}}
    k2_paths = {"found_training_resident_f32":
                train["a_resident_f32"]["launches"],
                "found_training_resident_remat":
                train["d_resident_remat"]["launches"],
                **{k: v["u8_gather_normalize"] for k, v in others.items()},
                **{k: 0 for k in host},
                **{k: v["u8_gather_normalize"]
                   for k, v in predicts.items()},
                **multi["launches_by_path"]["u8_gather_normalize"],
                "found_training_channels_last_n2":
                rest["n2_channels_last"]["launches"],
                **{k: v["u8_gather_normalize"]
                   for k, v in bench_paths.items()}}
    bound = input_kernel_bound_ms(4)
    f32 = ms["f32"]
    # the port's rule for a kernel: no slower than one PyTorch call for the
    # same function, and above half its bound
    print("kernel rule verdict (spin timer): " + "; ".join(
        f"{name} K1 {t['K1']['spin'] * 1e3:.1f} us vs torch.addcmul "
        f"{t['K1_library']['spin'] * 1e3:.1f} us ("
        + ("no slower" if t["K1"]["spin"] <= t["K1_library"]["spin"]
           else "SLOWER")
        + f"), K1 at {100 * t['bound'] / t['K1']['spin']:.0f} % and K2 at "
        f"{100 * t['bound'] / t['K2']['spin']:.0f} % of the bound"
        for name, t in ms.items()))
    # ms and plain_ms under the spin timer; both timers' readings beside
    print(json.dumps({"kernels": [
        {"name": "u8_normalize", "route": "cuda", "source": src,
         "replaces": "mfas_tpu/ops/input_kernels.py:71",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
         "max_abs_err": err["u8_normalize"], "ms": f32["K1"]["spin"],
         "plain_ms": f32["K1_plain"]["spin"], "bound_ms": bound,
         "bound_by": "bytes", "library_ms": f32["K1_library"]["spin"],
         "library": "torch.addcmul",
         "library_ms_by_dtype": {k: t["K1_library"] for k, t in ms.items()},
         "library_max_abs_err": err["u8_normalize_library"],
         "ms_by_timer": f32["K1"], "plain_ms_by_timer": f32["K1_plain"]},
        {"name": "u8_gather_normalize", "route": "cuda", "source": src,
         "replaces": "mfas_tpu/ops/input_kernels.py:174",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
         "max_abs_err": err["u8_gather_normalize"], "ms": f32["K2"]["spin"],
         "plain_ms": f32["K2_plain"]["spin"], "bound_ms": bound,
         "bound_by": "bytes", "library_ms": None,
         "ms_by_timer": f32["K2"], "plain_ms_by_timer": f32["K2_plain"]},
        # forward + backward at the found net's layer1 bn3 in f32; every
        # case and dtype of bn_kernel_phase under ms_by_case
        {"name": "batch_norm", "route": "cuda",
         "source": "mfas_tpu_torch/csrc/batchnorm.cu", "replaces": None,
         "launches": sum(sum(v.values()) for v in BN_PATHS.values()),
         "launches_by_path": BN_PATHS, "case": "r50_l1_bn3.f32",
         "max_rel_err": bn_err, **bn_ms["r50_l1_bn3.f32"],
         "bound_by": "bytes",
         "library": "torch.nn.functional.batch_norm + add + relu",
         "ms_by_case": bn_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:          # one process of phase (d)
        sys.exit(rank_main(sys.argv[2:]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
