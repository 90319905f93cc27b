"""Drive climate2weather_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Numbered phases, each printing one JSON line with its seconds:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build of every CUDA kernel from ``climate2weather_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
2. each kernel against its plain PyTorch version, with times of the kernel,
   the plain version and one PyTorch library call (``library_ms``) beside
   the least time the card could take (``bound_ms``): the attention forward
   and backward at the main paths' shapes (the forward also at the year
   path's [128, 64, 512], with an attention that drops a key as the fault
   its one-ulp limit must catch) and at T = 200, 256 and 1024
   (fp32 and bf16; both at C = 768; each bf16 forward also against float64,
   its mean distance at most ``LAUNCH_SLACK`` times the plain version's,
   which the plain output moved one ulp away from zero must exceed, with
   either product summed in float64 read beside; the forward timed at the
   training shape too, with its device time from a CUDA graph and its host
   time per call beside the back-to-back time; the backward also at T = 1
   and 65, called twice for the same bits, with a planted fault, dS without
   its row-sum term, that the check must catch, gradients reaching q, k and
   v, and its timed rows, the exact-guidance shape [96, 64, 512] among
   them, with their graph and host times and SDPA's backward from a
   graph); the Winograd conv at the 72.1M UNet's level-0 and level-4
   block shapes in bf16 with each ``pre``, ``vec`` and a residual and as
   level 0's conv0 (norm and ``vec``, no residual), at a ragged bf16 shape
   (C = 40, O = 20) and one fp32 shape: bf16 against float64, the mean
   distance at most ``WINO_SLACK`` times the plain version's and the max at
   most ``WINO_MAX_SLACK`` times the direct bf16 conv's, with planted
   faults that the mean limit must see (the top halo row not zeroed, the
   norm's ddof flipped, the output moved one ulp away from zero); fp32
   within 1e-5 of the plain version's scale, which the halo fault must
   exceed; gradients reaching x, the kernel, the bias, vec and the
   residual; timed at level 0's conv1 and conv0 and level 4's conv1
   (``timing_winograd``), each with its device time from a CUDA graph of
   the launch alone and the wrapper's host time per call; the channel
   norm's forward and backward kernels in bf16 at the main paths' rows
   (``NORM_SHAPES``: the 72.1M net's levels 0, 2, 3 and 4 at 480 windows,
   sda_unet_large's 768 channels), with the block's shift at ddof 0 and
   without it at ddof 1, each within one bf16 ulp of the plain version's
   scale and, against float64, its max and mean distance at most
   ``FORWARD_SLACK`` times the plain version's, which the output moved one
   ulp away from zero must exceed; the backward called twice for the same
   bits; both timed at each shape beside the plain version and
   ``F.layer_norm`` (``timing_channel_norm``; level 0 in the kernels line);
3. the 72.1M-parameter snapshot in ``artifacts/`` loaded through the port's
   own readers, one forward at [96, 128, 128, 52] with the kernel: each of its
   6 attention launches held to phase 2's limits on its own inputs (one bf16
   ulp of the plain version, which a dropped key must exceed; against
   float64, which the one-ulp-biased output must exceed), and the forward
   against the same net with its attention in float64, its max and mean
   distance at most ``FORWARD_SLACK`` times the plain forward's (beside, not
   gated: one moved output, either product summed in float64, the planted
   faults, and the old limit, what moving every attention output by one
   bf16 ulp does);
3b. one ModResidualBlock of the snapshot at level 0 and one at level 4 as
   two Winograd calls each (conv0 with the norm and the embedding's
   projection, conv1 with SiLU and the residual), against the two calls in
   float64: the mean distance at most ``WINO_SLACK`` times the block's as two
   plain Winograd calls, which a halo row not zeroed or the norm's ddof
   flipped must exceed, and the max at most ``WINO_MAX_SLACK`` times the
   port's cuDNN block's (beside: the cuDNN block's distance, and the old
   limit, what moving every conv output by one bf16 ulp does);
4. the main path: ``run_arrays`` at the settings of
   ``exp/configs/000_on-model-eval/s16_t6_spectral.yml`` (``num_samples``
   cut to 3, one ensemble group) on a synthetic 49-hour 128 x 128 trajectory,
   as its two steps ``load_net`` and ``sample_arrays`` timed apart, checked
   for finite samples, A(x) = y at the observed frames, and a kernel launch
   count of 6 attention and 40 channel-norm launches per UNet forward (no
   norm on the plain version);
5. training: ``training_loop`` on the 72.1M network of ``configs/sda_unet.yml``
   (flax-style init from the seed, bf16 compute, fp32 parameters) at
   128 x 128 from a [140, 4, 128, 128] training file written by the port's
   HDF5 writer and read through ``WindowDataset``, batch 64 in two
   microbatches of 32, to 1024 ndata with a checkpoint and a snapshot, then
   resumed to 2048: finite and falling losses, the checkpoint restored
   exactly, the first resumed step's draws and loss against an
   uninterrupted run's, 6 forward and 6 backward attention launches and 40
   forward and 40 backward channel-norm launches per microbatch, each
   backward launch of one step against the plain version, the fp16 snapshot loaded by ``load_net``, step time and peak memory;
6. ``predict`` from files with h5py made unimportable: the phase writes a
   49-hour 128 x 128 grid, its quantiles, a training file and a coarse
   observation grid with the port's writers, then runs
   ``exp/downscaling.run`` on copies of ``s16_t6_spectral.yml`` and
   ``s16_t6.yml`` (3 samples each, the PC run cut to 32 steps) and on the
   external-observation and ``guidance_off`` modes (8 steps), reading every
   ``.nc`` back: finite,
   A(x) = y where the config projects, 6 attention launches per forward;
   the committed ``tests/fixtures/observation_latest.nc`` (that
   observation written by h5py with ``libver='latest'``: a version-2
   B-tree chunk index, shuffle, lzf and fletcher32, compact coordinates)
   and ``observation_szip.nc`` (szip on a version-2 B-tree index, the
   coordinates in external raw storage beside it, found as
   ``HDF5_EXTFILE_PREFIX=${ORIGIN}`` finds them) are each held against the
   written observation bit for bit, and the external-observation run reads
   the szip one;
7. the canonical training drive, ``python -m climate2weather_tpu_torch.train``
   with ``configs/tiny_unet.yml`` at 32 x 32 (attention over 256 tokens,
   forward and backward) from a file the port wrote, 4 steps: finite losses
   and one step's attention launches against the plain versions;
8. the year path, h5py unimportable: (8a) ``exp/downscaling.run`` on
   ``exp/configs/001_clim-downscaling/year2014_meso128_winning.yml`` cut to
   523 hours (above the long path's 512), 32 steps and one sample, from
   files the port wrote: the long path taken, a finite sample, A(x) = y, the
   resume file
   written every 2 calls of 8 steps and removed, 6 attention launches per
   UNet forward, with sampling, I/O and peak memory; (8b) the long
   DPM-Solver++(2M) at 523 frames for 16 steps, crashed in its second call
   and resumed from its file, against two uninterrupted runs; (8c)
   ``sample_arrays`` on 4003 frames for 2 steps and the final denoise: a
   bf16 trajectory, A(x) = y within bf16 rounding, peak memory and the
   peak reckoned for 8737 frames; (8d) ``metrics run`` on 8a's directory:
   finite scores;
9. the other sampler and guidance modes, h5py unimportable: (9a)
   ``run_arrays`` at ``s16_t6_spectral.yml`` with ``use_exact_grad: true``,
   3 samples in one group (96 windows a chunk), 8 steps: finite, A(x) = y,
   the forward launches of both passes and the backward's (attention and
   channel norm), each backward
   launch of the first evaluation against the plain version, sampling time,
   window-evals/s and peak memory; then the exact gradient at full width in
   fp32 against a central difference of log p along a random direction,
   with the limit from the central difference's own spread, and a planted
   fault (the overwritten windows' cotangent counted twice) that must
   exceed it; (9b) ``exp/downscaling.run`` from files with
   ``sampler_kind: dpmpp3m`` (16 steps) and ``guidance_prolong: bilinear``
   (8 steps), checked as phase 6; (9c) the year config at 523 frames:
   DPM-Solver++(3M) crashed in its second call and resumed, bit for bit,
   then exact guidance for 1 step and the final denoise at chunks of 128
   windows; (9d) ``experiment hparam-sweep`` with 2 trials (8 steps): two
   numbered directories of finite samples; (9e) ``exp/fidelity.run`` with
   ``skip_figures`` (3 guided, 8 unconditional samples, 8 steps):
   ``FIDELITY.md`` and finite scores;
10. several processes (each a real process under a wall-clock limit, h5py
   unimportable): (10a) ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m climate2weather_tpu_torch.train`` (NCCL, a world of
   one) on the 72.1M net of ``configs/sda_unet.yml`` at 128 x 128 from phase
   5's synthetic file, batch 64 in 2 microbatches to 2048 ndata with a
   checkpoint at 1024, and the same command without the launcher: the final
   snapshot and checkpoint equal bit for bit (where not, a second plain run's
   spread is the limit), step ms of both; (10b) two ranks on the one card
   over gloo (each sees it as ``cuda:0``): one step on a fixed global batch of
   64 with fixed draws, 32 rows a rank, against the one-process step on that
   batch rank-major in 2 rounds of 32, parameters, AdamW moments and EMA
   equal bit for bit (where not, the one-process step's own spread over
   two runs is the limit), and a planted fault (rank 1 keeps its own
   gradient sum) that must break the ranks' agreement and exceed that
   limit; then ``train`` on 2 ranks, batch 128 (64 a rank in 2 rounds), 8
   steps to a checkpoint at 1024 and a 2-rank resume for 8 more: the ranks'
   final states equal bit for bit, rank 0 alone writing checkpoints and
   snapshots, falling losses, 12 forward and 12 backward attention
   launches a step on each rank; (10d, beside 10b) 10a's plain command under
   ``climate2weather_tpu_torch.training.supervisor`` (10 s stall timeout),
   its child stopped with SIGSTOP once the first checkpoint exists: one
   stall and one restart in the journal, the stall seen within the timeout,
   the resumed run's final snapshot and checkpoint equal to 10a's plain
   run's; (10c) ``experiment predict`` on phase 6's files with
   ``s16_t6_spectral.yml`` cut to 6 samples (3 a rank, one group each) and 8
   steps, on 2 ranks over gloo and in this process: the six samples equal
   file for file, ``ground_truth.nc`` and ``observation.nc`` written by rank
   0 alone, A(x) = y, 6 attention launches per UNet forward on each rank;
   (10e, 10c beside its ranks) one sample split over the 2 ranks of one
   sample group, each rank evaluating its share of every evaluation's
   windows, against the same run in this process: the year config at 523
   hours and 2 steps through ``experiment predict`` (4 chunks of 128
   windows, 2 dealt to a rank) equal bit for bit, launches 36 + 36 against
   72; ``s16_t6_spectral.yml`` at 49 hours and 2 steps (37 windows cut 19 /
   18) and with exact guidance at 19 hours and 2 steps (7 cut 4 / 3,
   forward and VJP), the net in fp32, within 5e-3 of the one-process
   sample's standard deviation, each rank's launches the one-process count
   and the windows split; rank 0 alone writing; planted on rank 1, windows
   shifted by one (bits broken, the limit exceeded) and a kept share (both
   ranks raise the group's disagreement error).
   Its line: step ms of the plain, world-of-one and 2-rank runs (two ranks
   time-slice the card, beside 10d: no production number) and each start's
   seconds to its first step, the ranks' peak memory, 10c's seconds on 2
   ranks and in one process, 10d's seconds to detect and to recover, 10e's
   readings against their limits and its seconds on 2 ranks.

11. the offline data layer on the card's host, with jax, flax, optax, h5py,
   scipy, click, netCDF4, xarray and the JAX package unimportable in this
   process and in every process it starts: (11a) the committed netCDF-C
   fixtures ``tests/fixtures/netcdf_c_{v108,latest}.nc`` (superblocks 2 and
   3, version-2 object headers, dense links and attributes in fractal heaps
   and version-2 B-trees, single-chunk, fixed-array and extensible-array
   chunk indexes) through ``io.hdf5.File`` and ``open_grid``, equal to
   ``netcdf_c_contents.npz`` bit for bit, and a flipped byte in each kind
   of checksummed structure raising ``ChecksumError``; then the committed
   fixtures of the structures h5py writes (``tests/fixtures/h5py_*.h5`` of
   ``tests/_h5py_layout_fixtures.py``: soft and external links in
   symbol-table and new-style groups, implicit, version-2 B-tree and
   swizzled extensible-array chunk indexes, compact and virtual layouts,
   fletcher32, lzf, n-bit and scale-offset filters, enum, array, compound
   and committed datatypes, h5py's selections; szip over float32/64 of
   either byte order, int8-64 and uint8/16, ``nn`` and ``ec``, 8-32
   pixels a block, 1-3-D with edge chunks and after shuffle, every chunk
   stored filtered; external raw storage in one and in several segments;
   a multi-year virtual dataset over printf-named yearly files and one
   growing by an unlimited mapping past a year no file holds; bitfields),
   every dataset and selection equal to ``h5py_layouts_contents.npz`` bit
   for bit, the dangling links listed and raising ``KeyError`` only when
   followed, a flipped byte in a fletcher32 chunk raising
   ``ChecksumError``, a szip chunk cut short and one with its stream's
   first byte flipped raising ``OSError`` naming the chunk (and every
   byte of it flipped in turn decoding or raising), the external fixture
   without its raw files raising as h5py raises, and the host codecs'
   decode rates on a year's chunk of bytes (szip, lzf, deflate); (11b)
   the drill of ``tests/test_cosmo_layout.py`` through ``python -m
   climate2weather_tpu_torch.data.cli``: a raw archive over 473 x 500 (four
   variables, a 2005 decoy, a missing tas hour), ``extract-patch-folder
   --years 2006-2014`` per variable and ``preproc-all`` (the 128 x 128
   patch, [24, 4, 128, 128] finite, the ``vars`` attribute, 12 test hours,
   the quantiles, the NaN hour in the audit file and repaired), then
   ``train`` at ``configs/tiny_unet.yml`` for 4 steps on the file it wrote
   (attention over 4,096 tokens, forward and backward, launches counted);
   (11c) ``synth --res 128 --spectrum mesoscale`` (train and eval hours cut
   to 240 and 56), a biased coarse climate model from the eval grid (16x
   block means every 6th hour; tas + 2 K, psl x 1.002, winds x 0.8) and
   ``debias`` against the train grid coarsened the same way: each
   variable's debiased quantiles (levels 0.01-0.99, in the reference's
   standard deviations) within a tenth of the biased ones' distance from
   the reference's; (11d) ``experiment predict`` with the 72.1M snapshot at
   a copy of ``qm_debiased_climate_mpi.yml`` naming 11c's files (the
   observation the debiased file; 49 hours, DPM-Solver++(2M), 8 steps, 3
   samples, with the confirmed setting's t=0 spectral projection): finite
   samples, the written observation the debiased file's frames, A(x) = y
   under phase 4's limit, 6 attention launches per UNet forward; then
   ``metrics run`` on the written directory: finite scores. 11c and 11d run
   on a thread beside 11b.
12. the model layer, with jax, flax, PyYAML, msgpack, h5py, ``scripts`` and
   the JAX package unimportable in this process and in the importer's:
   (12a) the 72.1M snapshot written as the reference's released pickle
   ``network-snapshot-0009437-0.999900.pkl`` (an fp16 EMA net of the
   reference's classes and names, ``tests/_reference_pickle.py``) and
   imported by ``python -m climate2weather_tpu_torch.import_reference_snapshot``:
   the inferred architecture the snapshot's plus ``norm_ddof: 1``, 72.1M
   parameters, every tensor equal, bit for bit, to the snapshot's rounded
   through fp16; (12b) ``load_net`` on the imported snapshot and one bf16
   forward at [96, 128, 128, 52], equal bit for bit to a net built from the
   fp16-rounded weights with ``norm_ddof: 1`` (and unequal with 0), 6
   attention launches; (12c) ``experiment.main(["predict", ...])`` in this
   process at a copy of ``s16_t6_spectral.yml`` naming the imported
   snapshot (49 hours, DPM-Solver++(2M), 8 steps, 3 samples): finite,
   A(x) = y under phase 4's limit, 6 launches per UNet forward; (12d) the
   snapshot with ``fused_upsample`` off and on: in fp32 (TF32 off) at
   batch 8 each against a float64 forward, the fused net within twice the
   plain one's distance, and both bf16 forwards at [96, 128, 128, 52] timed;
   (12e) a 1-D ScoreUNet on [8, 1024, 52] and a 3-D one on
   [2, 64, 64, 64, 52] at the 72.1M net's widths (64 tokens at level 4), one
   bf16 forward and backward each: every attention launch against the plain
   version under phase 2's limits, 6 each way, the layout each level's
   convs see, peak memory and seconds.

13. fill values, the zarr store and the figure data, with jax, flax, h5py,
   scipy, matplotlib, PIL, click, zarr, numcodecs, xarray and the JAX
   package unimportable in this process and in the one it starts: (13a) the
   committed partly written fixtures ``tests/fixtures/fill_{latest,earliest}.nc``
   (extensible-array, fixed-array and version-1 B-tree chunk indexes, a
   contiguous dataset never written; fill value and ``_FillValue``
   9.96921e36) through ``io.hdf5.File`` equal to ``fill_contents.npz`` bit
   for bit, and through ``open_grid`` NaN exactly where the fill value is;
   (13b) the blosc codec built anew by the host C++ compiler (named, with
   its seconds), the public-spec golden chunks decoded, the JAX-written
   stores ``tests/fixtures/jax_{zlib,blosc-lz4,none}.zarr`` (the last with a
   missing chunk) read equal to ``zarr_contents.npz`` bit for bit, the same
   grid written by the port into byte-equal files, and a corrupted blosc
   chunk raising an error that names the store and the chunk; (13c) phase
   6's ground truth in a blosc-lz4 store (``write_zarr``) and its coarse
   observation in a zlib store (``data.cli select-dates`` to a ``.zarr``
   path), the normalized inputs loaded from them equal to those from the
   ``.nc`` files bit for bit, ``experiment.main(["predict", ...])`` in this
   process at a copy of ``s16_t6_spectral.yml`` naming the stores (49 hours,
   DPM-Solver++(2M), 8 steps, 3 samples): finite, A(x) = y under phase 4's
   limit, 6 attention launches per UNet forward, then ``metrics run``;
   (13d) the data of every figure kind of ``exp/figures.KINDS`` from 13c's
   directory, and of ``downscaled_clim_dist`` against 12c's: finite, in the
   shapes the drawing takes, each kind's seconds; ``experiment figures``
   refusing with an error that names matplotlib and writing no file; (13e)
   ``print_module_summary``'s table of the 72.1M net, its total the
   snapshot's parameter count.
14. the host-streaming tier (``diffusion/host_stream.py``), h5py
   unimportable, with the 72.1M snapshot in bf16 at 128 x 128 and chunks
   of 128 windows: (14a) ``HostStreamingScoreFn``'s eps on a 523-frame
   trajectory (511 windows, 4 chunks) against the device ``WindowScoreFn``'s
   bit for bit, a chunk staged one frame late as the planted fault, 6
   attention launches per chunk; (14b) DPM-Solver++(2M) at eta 0 with the
   final denoise and COSMO guidance for 4 steps from one noise on the host
   tier and on the device long path: finite, both guidance residuals, both
   window-evals/s, the host tier's copy and numpy-update seconds an
   evaluation, host RSS growth, and the largest difference, printed only
   (bf16 rounding is chaotic under the COSMO gain); (14b-fp32) the same
   with the net in fp32 on the first 33 frames in 3 chunks of 8 windows:
   the largest difference within JAX's host-against-device bar, 5e-3 of
   the sample's standard deviation, which two planted faults must exceed
   (the second-order term dropped at the last step; the guidance's sign
   flipped); (14c) 140 frames (one chunk): the SDE form (eta 0.3, final
   denoise, 2 steps) twice with one seed, equal bit for bit, and a PC step
   with one corrector step, finite; (14d) the host tier's peak device
   memory at 523 frames within 2 % of its peak at 140 and below the device
   path's; (14e) ``experiment.main(["predict", ...])`` at a copy of
   ``s16_t6_spectral.yml`` on phase 6's files with ``host_streaming: true``,
   eta 0.3, the final denoise, no calibration or projection, 8 steps, 2
   samples: finite samples written, 6 launches per UNet forward.
15. the study and operations drivers of ``climate2weather_tpu_torch.scripts``
   at the 72.1M net's width, with jax, flax, yaml, msgpack, h5py, scipy,
   matplotlib, click, netCDF4, ``scripts`` and the JAX package unimportable
   in this process and, through a ``sitecustomize`` first on their path, in
   every process the phase starts and their children (each writes its
   attention launches to a log at its exit): (15a) ``fabricate_resume_state``
   (its ``main``, here) from the snapshot at ndata 9,433,984 and batch 64
   (fresh Adam, the schedule's count at step 147,406), then ``train`` resuming from it at
   128 x 128 for two steps: the run starts at the fabricated ndata, its LR
   the schedule's absolute value, its checkpoint holding Adam's count 2 and
   the schedule's count 147,408, and its two updates bit for bit a fresh
   AdamW's on the snapshot's parameters made in this process on the same
   batches and draws, the loader as it was (Adam's count forced to the
   step) the planted fault; (15b, in phase 10 beside 10e) ``soak_training``
   on 10a's plain command, its first start SIGKILLed once it has
   written the checkpoint at 1,024 and logged beyond it, the second resuming
   there: every logged loss equal to 10a's plain run's bit for bit, the
   replayed intervals to their replays, one loss moved by one float32 ulp
   the planted fault; (15c) ``likelihood_sweep`` in this process on
   ``s16_t6.yml`` at 4 steps and 2 samples: trial 0, trial 1 of base seed 99
   (98 draws another) and ``--uncond``, finite scores, the ranking, 6
   launches per UNet forward; (15d) ``sampler_ablation --only pc_corr0
   pc_corr1_tau05_ve`` at 4 steps: the table, finite scores, the launches;
   (15e) ``probe_watcher`` in a process on a run directory holding the
   snapshot under an on-cadence and an off-cadence name, one poll at
   interval 0 and one idle poll: exactly the due snapshot probed by its own
   process, ``progression_report`` tabulating it, a 2-Mi cadence and another
   EMA rate finding nothing; (15f) ``spectral_bands``, ``amplitude_ratio`` and
   ``calibration_design_study`` on 15c's and 15d's directories: every value
   finite, a NaN planted in one sample's copy seen. 15a's ``train`` and 15e
   run on threads while 15d and 15c sample here; the design study, a process,
   beside 15c.

Then one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU mode: without a card the script exits non-zero at once.
``--winograd-only`` stops after phase 2's Winograd part,
``--attention-bwd-only`` after phase 2's attention backward part,
``--checks-only`` after phases 2, 3 and 3b (each run even if one before it
failed; ten seeds fit one call), and
``--multi-process-only`` runs phases 0, 1 and 10 alone, ``--data-only``
phases 0, 1 and 11, ``--model-only`` phases 0, 1 and 12, ``--store-only``
phases 0, 1 and 13 (13d then compares 13c's directory with itself),
``--host-stream-only`` phases 0, 1 and 14, ``--study-only`` phases 0, 1 and 15
(15b then after its own plain run of 10a's command; no device line in any).
``--child ...`` is one process of phase 10 (``child_step``, ``child_cli``,
``child_split``), not for use by hand.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from climate2weather_tpu_torch.diffusion.process import VPCosineProcess

REPO = pathlib.Path(__file__).resolve().parent
SNAPSHOT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"
CONFIG = REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml"
MODEL_CONFIG = REPO / "configs" / "sda_unet.yml"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MAIN_SHAPE = (96, 64, 512)  # windows per call x tokens x channels at level 4
TRAIN_SHAPE = (32, 64, 512)  # microbatch x tokens x channels at level 4
YEAR_SHAPE = (128, 64, 512)  # the year path's windows per call (batch_size 128) at level 4
# T = 200 ragged, 128 (the old kernels' limit), 256 (tiny_unet at 32 x 32;
# sda_unet_large's level 4 at 256 x 256), 1024 (a 32 x 32 attention level),
# and a small ragged shape
LONG_SHAPES = ((4, 200, 64), (2, 128, 64), (8, 256, 32), (4, 256, 512), (2, 1024, 64), (3, 16, 40))
LONG_TIMED = (32, 256, 512)  # timed beside the main shapes: a training microbatch at T = 256
# sda_unet_large's level 5 (768 channels) at 256 x 256 (8 x 8 tokens) and
# 512 x 512 (16 x 16: three channel slices of the forward's tensor-core
# kernel, six of the backward's)
WIDE_SHAPES = ((4, 64, 768), (4, 256, 768))
# the backward's route edges beside T = 64 (TRAIN_SHAPE) and 16: the first T
# of the three-kernel route, and one token
BWD_EDGE_SHAPES = ((4, 65, 128), (6, 1, 64))
WINO_SHAPES = ((32, 128, 128, 128), (32, 8, 8, 512))  # the 72.1M blocks at levels 0 and 4
# C not a multiple of 16, O not a multiple of 8, ragged tile rows and columns
WINO_RAGGED = ((3, 10, 14, 40), 20)
# the timed Winograd calls: name, [N, H, W, C], O, pre, vec, residual. The
# first is the kernels line's row (level 0's conv1 as earlier versions
# timed it, vec included); then level 0's conv0 and level 4's conv1 as the
# ModResidualBlock calls them
WINO_TIMED = (("level0_conv1", WINO_SHAPES[0], 128, "silu", True, True),
              ("level0_conv0", WINO_SHAPES[0], 128, "norm", True, False),
              ("level4_conv1", WINO_SHAPES[1], 512, "silu", False, True))
# the channel norm's rows as the UNet hands them over, [B, C, *spatial]
# channels-last: the 72.1M net's levels 0 (the kernels line's row), 2, 3
# and 4 at a sampling forward's 480 windows, and sda_unet_large's level 5
# (768 channels at 256 x 256) at a training microbatch of 32
NORM_SHAPES = ((480, 128, 128, 128), (480, 256, 32, 32), (480, 384, 16, 16), (480, 512, 8, 8), (32, 768, 8, 8))
NORM_CHUNK = 2 ** 27  # values a float64 comparison takes at once


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3), **fields}), flush=True)


def timing_row(name, source, replaces, err, ms, plain_ms, library_ms, nbytes, flops, shape) -> dict:
    """One row of the kernels line; ``bound_ms`` is the larger of the bytes
    over the HBM rate and the operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": list(shape)}


def cuda_time_ms(fn, reps=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps=50, warmup=3) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed once between CUDA events. Where a call's host work (the Python
    wrapper, ctypes) outlasts its kernels, back-to-back calls time the host;
    the replay times the device alone. The capture is relaxed, so that a
    launcher that sets a kernel attribute on every call can be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return _replay_ms(graph, reps)


def _replay_ms(graph, reps) -> float:
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_bwd_graph_ms(inputs, do, reps=50, warmup=3) -> float:
    """Device time of SDPA's backward alone: fresh leaves and the forward on
    a side stream (autograd runs a backward on its forward's streams), then
    ``reps`` calls of ``torch.autograd.grad`` captured in one CUDA graph on
    that stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=1.0)
        for _ in range(warmup):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    return _replay_ms(graph, reps)


def host_time_ms(fn, reps=50, warmup=5) -> float:
    """Host time of one call: ``reps`` calls timed on the host's clock before
    the card is waited for (while the queue is not full, the host's work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / reps


def bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


# The float64 yardsticks of phases 2, 3 and 3b. A bf16 kernel is held to
# the exact function of its bf16 inputs, its distance from it against the
# plain version's: a limit of one ulp of the plain version's output scale
# is the bf16 noise floor, which refuses any other summation order and
# admits a kernel that moves every output one ulp the same way. Each slack
# is the smallest of 1.001, 1.002, 1.005, 1.01, 1.02, 1.05, 1.1, 1.2, 1.5
# and 2 whose excess over 1 is at least twice the largest excess read by
# the kernel or an other-order control, over the checks of seeds 0-9
# (``--checks-only --seed N``, NVIDIA H100 80GB HBM3 at 700 W). A ratio is
# a distance from float64 over the plain version's (or the direct conv's).
#
# Each bf16 attention launch (phases 2 and 3): mean distance at most this
# times the plain version's. The kernel and either product summed in
# float64 read 0.99999905-1.00000006 over 540 launches; the output moved
# one ulp away from zero 3.89-4.07 (and within the one-ulp max limit).
LAUNCH_SLACK = 1.001
# The 72.1M forward with the kernel (phase 3): max and mean distance from
# the same net with its attention in float64 at most this times the
# forward's with the plain attention. The kernel reads 1.0 (its outputs are
# the plain version's); either product summed in float64 reads 0.94-1.25 in
# max (the max moves by steps of the output's ulp) and 0.83-1.045 in mean.
# The planted faults stay under it (biased: max up to 1.5, mean 1.009-1.076;
# dropped key: 1.03, 1.015-1.084): the per-launch limits are what see them.
FORWARD_SLACK = 1.5
# Each bf16 Winograd call (phase 2) and block (phase 3b): mean distance at
# most this times the plain Winograd version's, which rounds as the kernel
# does. The kernel reads 0.99962-1.00029 (130 calls and blocks); the norm's
# ddof flipped 1.0099-1.0154 at 512 channels (1.23 at 128, 2.2 at 40), the
# one-ulp-biased output 1.45-2.04, the halo row 1.63-14.8.
WINO_SLACK = 1.001
# ... and max distance at most this times the direct bf16 conv's (cuDNN's;
# the JAX package's own test allows 4). The kernel reads 0.86-1.49 (the
# plain Winograd version alike); a fault one ulp wide reads as much, so
# this limit sees only gross faults (the halo row: 20-100).
WINO_MAX_SLACK = 2.0


def _diff(a, b) -> tuple:
    """Max and mean of |a - b|, in float64."""
    d = (a.double() - b.double()).abs()
    return float(d.max()), float(d.mean())


def _over(d, b) -> float:
    """A distance over a reference's; where the reference is exact, 1.0 for
    an exact candidate and infinity for any other."""
    return d / b if b else (1.0 if d == 0 else float("inf"))


def _ratio(y, exact, base) -> list:
    """``y``'s max and mean distance from ``exact`` over ``base``, the (max,
    mean) of the reference's."""
    return [_over(d, b) for d, b in zip(_diff(y, exact), base)]


def _norm_f64(x, eps=1e-5, ddof=0, dim=1):
    """The channel norm with its statistics in x's dtype (float64 here)."""
    mean = x.mean(dim=dim, keepdim=True)
    return (x - mean) * torch.rsqrt(x.var(dim=dim, keepdim=True, correction=ddof) + eps)


def _fused_norm_f64(x, shift=None, ddof=0, eps=1e-5, dim=1):
    """``fused_channel_norm``'s function with the add and the statistics in
    x's dtype (float64 here)."""
    if shift is not None:
        x = x + shift.reshape(*shift.shape, *(1,) * (x.dim() - 2))
    return _norm_f64(x, eps, ddof, dim)


def _attention_f64(q, k, v):
    """softmax((q s)(k s)^T) v in float64, not rounded."""
    s = q.shape[-1] ** (-0.25)
    return torch.softmax((q.double() * s) @ (k.double() * s).transpose(-1, -2), dim=-1) @ v.double()


def _winograd_f64(x, kernel, bias, vec=None, residual=None, pre=None, ddof=0):
    """residual + conv3x3_same(pre(x + vec), kernel) + bias in float64, not
    rounded: the port's direct composition on float64 operands, with the
    norm's statistics and SiLU in float64 too."""
    from climate2weather_tpu_torch.ops import winograd

    h = x.double()
    if vec is not None:
        h = h + vec.double()[:, None, None, :]
    if pre == "norm":
        h = _norm_f64(h, winograd.EPS, ddof, dim=-1)
    elif pre == "silu":
        h = h * torch.sigmoid(h)
    return winograd.conv3x3_reference(h, kernel.double(), bias.double(), None,
                                      None if residual is None else residual.double())


def _one_ulp_biased(y):
    """bf16 ``y`` with every nonzero value moved one ulp away from zero: a
    fault within one ulp of each output, so within any limit of one ulp of
    the output scale, that only a limit against float64 can see."""
    return (y.view(torch.int16) + (y != 0).to(torch.int16)).view(y.dtype)


def _wino_ratios(y, exact, plain, direct) -> list:
    """[``y``'s mean distance from ``exact`` over the plain Winograd
    version's, its max over the direct conv's], given their (max, mean)."""
    d = _diff(y, exact)
    return [_over(d[1], plain[1]), _over(d[0], direct[0])]


def _wino_gate(rec) -> None:
    """The float64 limits on a Winograd record's ratios: the kernel's mean
    within WINO_SLACK and max within WINO_MAX_SLACK; each fault's mean
    over WINO_SLACK. Appends to ``rec["failed"]``."""
    mean, top = rec["f64_ratios"]
    if mean > WINO_SLACK:
        rec["failed"].append("the kernel's mean distance from float64 is over WINO_SLACK")
    if top > WINO_MAX_SLACK:
        rec["failed"].append("the kernel's max distance from float64 is over WINO_MAX_SLACK")
    rec["failed"] += [f"the float64 limit cannot see {name}" for name, r in rec["faults"].items()
                      if r[0] <= WINO_SLACK]


def _raise_failed(what, records) -> None:
    """Raise naming every record with a failure, once the phase has printed
    them all."""
    bad = [r for r in records if r.get("failed")]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} check(s) failed: {bad}")


def phase0_card() -> dict:
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from climate2weather_tpu_torch.ops.build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    info = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc, "python": sys.version.split()[0]}
    emit(0, t0, **info)
    return info


def phase1_build() -> None:
    t0 = time.time()
    from climate2weather_tpu_torch.ops import attention, build, winograd

    build.build_all(build.SOURCES)  # one nvcc per source, all started together
    attention.build_kernel()
    winograd.build_kernel()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "smem" in ln or "spill" in ln]
             for src, log in build.build_logs.items()}
    emit(1, t0, built=sorted({**attention.launch_counts, **winograd.launch_counts}), ptxas=ptxas)


def _rowsum_dropped(q, k, v, do):
    """A faulty backward: dS = P o dP, without the row-sum term."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = q.shape[-1] ** (-0.25)
    p = torch.softmax((q32 * s) @ (k32 * s).transpose(-1, -2), dim=-1)
    ds = p * (do32 @ v32.transpose(-1, -2))
    return ((ds @ k32) * s * s).to(q.dtype), ((ds.transpose(-1, -2) @ q32) * s * s).to(q.dtype), \
        (p.transpose(-1, -2) @ do32).to(q.dtype)


def _grads_err(got, want):
    """Largest error over (dq, dk, dv) and each output's scale."""
    errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.float().abs().max()) for w in want]
    return errs, scales


def _bwd_tols(scales, dtype):
    # fp32: sums in another order, ~1e-5 of each output's scale; bf16: both
    # sides round one fp32 value, so they differ by at most one ulp
    return [1e-5 * sc if dtype == torch.float32 else bf16_ulp(sc) for sc in scales]


def phase2_backward(device: torch.device, g: torch.Generator) -> tuple:
    """The backward kernel against ``attention_bwd_reference`` at the
    training shape, the route's edges (T = 1, 16, 64, 65), ragged shapes,
    768 channels and the longest T, fp32 and bf16, with a planted fault that
    must fail and a second call that must give the same bits; gradients
    through ``fused_attention``. The training shape, ``LONG_TIMED`` and the
    exact-guidance shape ``MAIN_SHAPE`` are timed back to back (``ms``), from
    a CUDA graph (``graph_ms``, and SDPA's backward so as
    ``library_graph_ms``) and on the host (``host_ms``). Returns (checks, the
    kernels line's row, the ``LONG_TIMED`` row, the ``MAIN_SHAPE`` row)."""
    from climate2weather_tpu_torch.ops import attention

    checks, row = [], None
    timed = {}
    for shape in (TRAIN_SHAPE, *LONG_SHAPES, *BWD_EDGE_SHAPES, *WIDE_SHAPES, LONG_TIMED, MAIN_SHAPE):
        for dtype in ((torch.bfloat16,) if shape in (LONG_TIMED, MAIN_SHAPE) else (torch.float32, torch.bfloat16)):
            b, t, c = shape
            qkv = torch.randn((b, t, 3 * c), generator=g, device=device).to(dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            do = torch.randn((b, t, c), generator=g, device=device).to(dtype)
            got = attention.attention_bwd(q, k, v, do)
            again = attention.attention_bwd(q, k, v, do)
            want = attention.attention_bwd_reference(q, k, v, do)
            torch.cuda.synchronize()
            errs, scales = _grads_err(got, want)
            tols = _bwd_tols(scales, dtype)
            fault, _ = _grads_err(_rowsum_dropped(q, k, v, do), want)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            rec = {"shape": list(shape), "dtype": str(dtype), "max_abs_err": errs, "tol": tols,
                   "rowsum_dropped_err": fault, "same_bits_twice": same}
            checks.append(rec)
            if any(e > tl for e, tl in zip(errs, tols)):
                raise AssertionError(f"attention backward kernel disagrees: {rec}")
            if not same:
                raise AssertionError(f"attention backward gives other bits on a second call: {rec}")
            if fault[0] <= tols[0] or fault[1] <= tols[1]:
                raise AssertionError(f"the backward check cannot see a dropped row sum: {rec}")
            if shape in (TRAIN_SHAPE, LONG_TIMED, MAIN_SHAPE) and dtype == torch.bfloat16:
                s = c ** (-0.25)
                lib_in = [x.detach().clone().requires_grad_(True)
                          for x in ((q * s).contiguous(), (k * s).contiguous(), v.contiguous())]
                lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_in, scale=1.0)
                ms = cuda_time_ms(lambda: attention.attention_bwd(q, k, v, do))
                plain_ms = cuda_time_ms(lambda: attention.attention_bwd_reference(q, k, v, do))
                library_ms = cuda_time_ms(lambda: torch.autograd.grad(
                    lib_out, lib_in, do, retain_graph=True))
                # q, k, v, dO read once, dQ, dK, dV written once; the fp32
                # scratch is the kernel's own traffic, not the function's
                nbytes = 7 * b * t * c * q.element_size()
                flops = 10 * b * t * t * c  # QK^T, dO V^T, P^T dO, dS K, dS^T Q
                timed[shape] = timing_row(
                    "attention_bwd", "climate2weather_tpu_torch/csrc/attention_bwd.cu",
                    "climate2weather_tpu/ops/attention.py:89", max(errs), ms, plain_ms, library_ms,
                    nbytes, flops, shape)
                # beside the back-to-back times, the device time alone (the
                # wrapper and its launches from a CUDA graph; SDPA's backward
                # alone) and the wrapper's host time per call
                timed[shape].update(graph_ms=graph_time_ms(lambda: attention.attention_bwd(q, k, v, do)),
                                    library_graph_ms=sdpa_bwd_graph_ms(lib_in, do),
                                    host_ms=host_time_ms(lambda: attention.attention_bwd(q, k, v, do)))
    row = timed[TRAIN_SHAPE]
    # the repair: gradients reach q, k and v through fused_attention
    qkv = torch.randn((4, 64, 3 * 64), generator=g, device=device, requires_grad=True)
    do = torch.randn((4, 64, 64), generator=g, device=device)
    before = attention.launch_counts["attention_bwd"]
    attention.fused_attention(*qkv.chunk(3, dim=-1)).backward(do)
    torch.cuda.synchronize()
    want = torch.cat(attention.attention_bwd_reference(*qkv.detach().chunk(3, dim=-1), do), dim=-1)
    grad_err = float((qkv.grad - want).abs().max()) if qkv.grad is not None else None
    grad_check = {"launched": attention.launch_counts["attention_bwd"] - before,
                  "qkv_grad_err": grad_err, "tol": 1e-5 * float(want.abs().max())}
    if grad_err is None or grad_check["launched"] != 1 or grad_err > grad_check["tol"]:
        raise AssertionError(f"gradients do not reach q, k, v through the kernel: {grad_check}")
    checks.append({"fused_attention_grad": grad_check})
    return checks, row, timed[LONG_TIMED], timed[MAIN_SHAPE]


def phase2_kernels(device: torch.device, seed: int) -> tuple:
    """Each kernel against its plain version (the attention forward and the
    Winograd conv also against float64, with their planted faults; the
    phase prints every check before it raises on a failed one); returns the
    timing rows by kernel name, and the forward's row at the year path's
    shape."""
    from climate2weather_tpu_torch.ops.attention import attention_reference, fused_attention

    t0 = time.time()
    g = torch.Generator(device=device).manual_seed(seed)
    checks, timed = [], {}
    for shape in (MAIN_SHAPE, *LONG_SHAPES, *WIDE_SHAPES, TRAIN_SHAPE, LONG_TIMED, YEAR_SHAPE):
        for dtype in ((torch.bfloat16,) if shape in (TRAIN_SHAPE, LONG_TIMED, YEAR_SHAPE)
                      else (torch.float32, torch.bfloat16)):
            b, t, c = shape
            qkv = torch.randn((b, t, 3 * c), generator=g, device=device).to(dtype)
            q, k, v = qkv.chunk(3, dim=-1)  # strided thirds, as the UNet passes them
            got = fused_attention(q, k, v)
            torch.cuda.synchronize()
            # the dropped key planted at the year path's shape
            rec = _attention_launch(q, k, v, got, key_dropped=shape == YEAR_SHAPE)
            checks.append({"shape": list(shape), "dtype": str(dtype), **rec})
            err = rec["max_abs_err"]
            if shape in (MAIN_SHAPE, TRAIN_SHAPE, LONG_TIMED, YEAR_SHAPE) and dtype == torch.bfloat16:
                s = c ** (-0.25)
                qs, ks = (q * s).contiguous(), (k * s).contiguous()
                vc = v.contiguous()
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vc, scale=1.0)
                ms = cuda_time_ms(lambda: fused_attention(q, k, v))
                plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v))
                library_ms = cuda_time_ms(sdpa)
                nbytes = 4 * b * t * c * q.element_size()  # q, k, v read, o written
                flops = 4 * b * t * t * c  # QK^T and PV
                timed[shape] = timing_row(
                    "attention_fwd", "climate2weather_tpu_torch/csrc/attention_fwd.cu",
                    "climate2weather_tpu/ops/attention.py:71", err, ms, plain_ms, library_ms,
                    nbytes, flops, shape)
                # beside the back-to-back times (the method of every row), the
                # device time alone and the wrapper's host time per call
                timed[shape].update(graph_ms=graph_time_ms(lambda: fused_attention(q, k, v)),
                                    library_graph_ms=graph_time_ms(sdpa),
                                    host_ms=host_time_ms(lambda: fused_attention(q, k, v)))
    bwd_checks, bwd_row, bwd_long, bwd_exact = phase2_backward(device, g)
    wino_checks, wino_rows = phase2_winograd(device, g)
    norm_checks, norm_fwd, norm_bwd = phase2_channel_norm(device, g)
    rows = {"attention_fwd": timed[MAIN_SHAPE], "attention_bwd": bwd_row, "winograd_conv3x3": wino_rows[0],
            "channel_norm_fwd": norm_fwd[0], "channel_norm_bwd": norm_bwd[0]}
    emit(2, t0, checks=checks + bwd_checks + wino_checks + norm_checks, timing=list(rows.values()),
         timing_train_fwd=timed[TRAIN_SHAPE], timing_year_fwd=timed[YEAR_SHAPE],
         timing_t256=[timed[LONG_TIMED], bwd_long], timing_exact_bwd=bwd_exact,
         timing_winograd=wino_rows[1:], timing_channel_norm=norm_fwd[1:] + norm_bwd[1:])
    _raise_failed("phase 2", checks + wino_checks + norm_checks)
    return rows, timed[YEAR_SHAPE], bwd_exact


def _halo_unmasked(x, kernel, bias, vec, residual, pre, ddof=0):
    """A faulty Winograd conv: the top halo row at the image edge holds
    pre(x + vec) of row 0 (the row the Pallas kernel's clamped index map
    fetches) instead of the conv's zero padding."""
    from climate2weather_tpu_torch.ops import winograd

    h = winograd._kernel_pre(x, vec, pre, ddof)
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))
    hp[:, 0, 1:-1] = h[:, 0]
    u = winograd.transform_weights(kernel).to(x.dtype)
    return winograd.winograd_from_padded(hp, u, bias, residual)


def _winograd_launch(winograd, x, kernel, bias, vec, residual, pre, ddof=0):
    """The kernel's launch alone through its C entry point, U transformed
    beforehand: a CUDA graph of it replays the kernel's device time. The
    entry point and the wrapper's codes are those of every version of
    ``ops/winograd.py`` since the kernel came in, so this times an older
    checkout too."""
    n, h, w, c = x.shape
    o = kernel.shape[3]
    u = winograd.transform_weights(kernel).to(x.dtype).contiguous()
    b32 = bias.float().contiguous()
    out = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    lib = winograd._library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def launch():
        err = lib.c2w_winograd_conv3x3(
            x.data_ptr(), u.data_ptr(), b32.data_ptr(), ptr(vec), ptr(residual), out.data_ptr(),
            n, h, w, c, o, winograd._PRE_CODES[pre], ddof, winograd._DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"winograd_conv3x3 launch failed: cudaError {err}")
    return launch


def _winograd_inputs(g, device, shape, o, dtype, vec=True, residual=True):
    n, h, w, c = shape
    x = torch.randn((n, h, w, c), generator=g, device=device).to(dtype)
    kernel = torch.randn((3, 3, c, o), generator=g, device=device) / (3 * c ** 0.5)
    bias = 0.1 * torch.randn((o,), generator=g, device=device)
    v = torch.randn((n, c), generator=g, device=device).to(dtype) if vec else None
    res = torch.randn((n, h, w, o), generator=g, device=device).to(dtype) if residual else None
    return x, kernel, bias, v, res


def _winograd_check(winograd, args, rec):
    """The kernel on ``args`` (x, kernel, bias, vec, residual, pre) against
    ``winograd_reference``, into ``rec``, with planted faults: the top halo
    row not zeroed; for bf16 also the channel norm's ddof flipped (``pre``
    "norm") and the plain output moved one ulp away from zero. fp32: within
    1e-5 of the scale of the plain version, which the halo fault must
    exceed. bf16, against float64: a mean distance at most WINO_SLACK times
    the plain version's (which rounds as the kernel does), which every
    fault must exceed, and a max at most WINO_MAX_SLACK times the direct
    bf16 conv's; the one-ulp-of-scale distance to the plain version is
    printed beside. ``rec["failed"]`` names what failed. Returns the
    kernel's max distance to the plain version."""
    x, pre = args[0], args[5]
    got = winograd.winograd_fwd(*args)
    plain = winograd.winograd_reference(*args)
    err, scale = _diff(got, plain)[0], float(plain.float().abs().max())
    faults = {"halo_unmasked": _halo_unmasked(*args)}
    rec.update(max_abs_err=err, failed=[])
    if x.dtype == torch.float32:  # sums in another order, ~1e-5 of the scale
        tol = 1e-5 * scale
        rec.update(tol=tol, halo_unmasked_err=_diff(faults["halo_unmasked"], plain)[0])
        if err > tol:
            rec["failed"].append("the kernel is off the plain version by more than 1e-5 of the scale")
        if rec["halo_unmasked_err"] <= tol:
            rec["failed"].append("the limit cannot see an unmasked halo row")
        return err
    if pre == "norm":
        faults["ddof_flipped"] = winograd.winograd_reference(*args, 1)
    faults["one_ulp_biased"] = _one_ulp_biased(plain)
    exact = _winograd_f64(*args)
    base, direct = _diff(plain, exact), _diff(winograd.conv3x3_reference(*args), exact)
    rec.update(one_ulp=bf16_ulp(scale), plain_f64=list(base), direct_f64=list(direct),
               f64_ratios=_wino_ratios(got, exact, base, direct), plain_max_ratio=_over(base[0], direct[0]),
               slack=WINO_SLACK, max_slack=WINO_MAX_SLACK,
               faults={name: _wino_ratios(y, exact, base, direct) for name, y in faults.items()})
    _wino_gate(rec)
    return err


def phase2_winograd(device: torch.device, g: torch.Generator) -> tuple:
    """The Winograd kernel by ``_winograd_check`` at the 72.1M block shapes
    in bf16 with each ``pre``, ``vec`` and a residual, and as conv0 of a
    ModResidualBlock at level 0 (norm and ``vec``, no residual, which would
    raise the output scale over part of a fault), at a ragged bf16 shape and
    at one fp32 shape; the gradient through ``WinogradConv3x3``; then the
    three calls of ``WINO_TIMED``, each checked the same way and timed: back
    to back through the wrapper (``ms``, U's transform included, as earlier
    versions timed it), the kernel's launch alone from a CUDA graph
    (``graph_ms``), the wrapper's host time per call (``host_ms``), the
    plain version and cuDNN's conv with the plain epilogue. Returns (checks,
    timing rows in ``WINO_TIMED``'s order); the caller raises on a failed
    check once it has printed them."""
    from climate2weather_tpu_torch.ops import winograd

    checks = []
    # shape, O, dtype, pre, vec, residual
    cases = [(shape, shape[3], torch.bfloat16, pre, True, True)
             for shape in WINO_SHAPES for pre in (None, "norm", "silu")]
    cases.append((WINO_RAGGED[0], WINO_RAGGED[1], torch.bfloat16, "norm", True, True))
    cases.append(((4, 32, 32, 64), 64, torch.float32, "norm", True, True))
    cases.append((WINO_SHAPES[0], WINO_SHAPES[0][3], torch.bfloat16, "norm", True, False))
    for shape, o, dtype, pre, has_vec, has_res in cases:
        x, kernel, bias, vec, res = _winograd_inputs(g, device, shape, o, dtype, has_vec, has_res)
        rec = {"shape": list(shape), "o": o, "dtype": str(dtype), "pre": pre, "vec": has_vec, "residual": has_res}
        checks.append(rec)
        _winograd_check(winograd, (x, kernel, bias, vec, res, pre), rec)
    # the gradient reaches x, the kernel, the bias, vec and the residual
    n, h, w, c = 2, 16, 16, 32
    leaves = [torch.randn(s, generator=g, device=device).requires_grad_(True)
              for s in ((n, h, w, c), (3, 3, c, c), (c,), (n, c), (n, h, w, c))]
    gout = torch.randn((n, h, w, c), generator=g, device=device)
    before = winograd.launch_counts["winograd_conv3x3"]
    winograd.winograd_conv3x3(*leaves, "norm", 0).backward(gout)
    launched = winograd.launch_counts["winograd_conv3x3"] - before
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    winograd.conv3x3_reference(*ref, "norm", 0).backward(gout)
    grad_errs = [None if a.grad is None else float((a.grad - b.grad).abs().max()) for a, b in zip(leaves, ref)]
    grad_tols = [1e-5 * float(b.grad.abs().max()) for b in ref]
    grad_check = {"launched": launched, "grad_errs": grad_errs, "tols": grad_tols}
    checks.append({"winograd_grad": grad_check})
    if launched != 1 or any(e is None or e > tl for e, tl in zip(grad_errs, grad_tols)):
        raise AssertionError(f"gradients do not reach every input through the Winograd conv: {grad_check}")

    rows = []
    for name, shape, o, pre, has_vec, has_res in WINO_TIMED:
        x, kernel, bias, vec, res = _winograd_inputs(g, device, shape, o, torch.bfloat16, has_vec, has_res)
        args = (x, kernel, bias, vec, res, pre)
        rec = {"shape": list(shape), "o": o, "dtype": str(x.dtype), "pre": pre, "timed": name}
        checks.append(rec)
        err = _winograd_check(winograd, args, rec)
        ms = cuda_time_ms(lambda: winograd.winograd_fwd(*args))
        plain_ms = cuda_time_ms(lambda: winograd.winograd_reference(*args))
        # the yardstick: cuDNN's conv on the channels-last bf16 tensor, plus
        # the plain SiLU or norm, bias and residual (never called by the port)
        library_ms = cuda_time_ms(lambda: winograd.conv3x3_reference(*args))
        n, h, w, c = shape
        el = x.element_size()
        # x read, the output written, the residual read, U, vec and the bias
        nbytes = (n * h * w * c + n * h * w * o * (2 if has_res else 1) + 16 * c * o
                  + (n * c if has_vec else 0)) * el + 4 * o
        flops = 2 * 16 * n * (h // 2) * (w // 2) * c * o  # the 16 plane products
        row = timing_row("winograd_conv3x3", "climate2weather_tpu_torch/csrc/winograd_conv3x3.cu",
                         "climate2weather_tpu/ops/winograd.py:230", err, ms, plain_ms, library_ms,
                         nbytes, flops, shape)
        row.update(call=name, o=o, pre=pre, vec=has_vec, residual=has_res,
                   graph_ms=graph_time_ms(_winograd_launch(winograd, *args)),
                   host_ms=host_time_ms(lambda: winograd.winograd_fwd(*args)))
        rows.append(row)
    return checks, rows


def _chunked_f64(exact_fn, candidates: dict, b: int) -> dict:
    """(max, mean) distance of each candidate [B, ...] from ``exact_fn(i, j)``,
    the float64 yardstick of the batch rows [i, j), a few rows at a time."""
    n = next(iter(candidates.values())).numel()
    step = max(1, NORM_CHUNK * b // n)
    top, total = dict.fromkeys(candidates, 0.0), dict.fromkeys(candidates, 0.0)
    for i in range(0, b, step):
        exact = exact_fn(i, i + step)
        for k, y in candidates.items():
            d = (y[i:i + step].double() - exact).abs()
            top[k], total[k] = max(top[k], float(d.max())), total[k] + float(d.sum())
        del exact
    return {k: (top[k], total[k] / n) for k in candidates}


def _norm_gate(rec, got, plain, dists) -> None:
    """The channel norm's limits on one record: the kernel within one bf16
    ulp of the plain version's output scale, its max and mean distance from
    float64 at most ``FORWARD_SLACK`` times the plain version's, and the
    output moved one ulp away from zero over that limit. Appends to
    ``rec["failed"]``."""
    scale = float(plain.abs().max())
    base = dists["plain"]
    rec.update(max_abs_err=float((got.float() - plain.float()).abs().max()), one_ulp=bf16_ulp(scale),
               plain_f64=list(base), f64_ratios=[_over(d, b) for d, b in zip(dists["kernel"], base)],
               faults={"one_ulp_biased": [_over(d, b) for d, b in zip(dists["one_ulp_biased"], base)]},
               failed=[])
    if rec["max_abs_err"] > rec["one_ulp"]:
        rec["failed"].append("the kernel is more than one bf16 ulp of the output scale from the plain version")
    if max(rec["f64_ratios"]) > FORWARD_SLACK:
        rec["failed"].append("the kernel is farther from float64 than FORWARD_SLACK times the plain version")
    rec["failed"] += [f"the float64 limit cannot see {k}" for k, r in rec["faults"].items()
                      if max(r) <= FORWARD_SLACK]


def phase2_channel_norm(device: torch.device, g: torch.Generator) -> tuple:
    """The channel-norm kernels at ``NORM_SHAPES`` in bf16, channels-last:
    the forward with the block's shift at ddof 0 (the 72.1M net's) and
    without it at ddof 1 (imported snapshots'), and the backward on the
    forward's statistics, each against the plain version and float64 by
    ``_norm_gate``; the backward called twice for the same bits. Each
    shape's forward and backward with the shift at ddof 0 are timed back to
    back beside the plain version and ``F.layer_norm`` on the rounded sum
    (the library's norm, never called by the port), forward and backward.
    Returns (checks, timing rows: the forward's and the backward's at each
    shape, level 0's first); the caller raises on a failed check once it
    has printed them."""
    from climate2weather_tpu_torch.ops import channel_norm as cn

    checks, fwd_rows, bwd_rows = [], [], []
    for shape in NORM_SHAPES:
        b, c, *spatial = shape
        x = (torch.randn((b, *spatial, c), generator=g, device=device) * 2 + 0.5).to(torch.bfloat16).movedim(-1, 1)
        s = torch.randn((b, c), generator=g, device=device).to(torch.bfloat16)
        dy = torch.randn((b, *spatial, c), generator=g, device=device).to(torch.bfloat16).movedim(-1, 1)
        for shift, ddof in ((s, 0), (None, 1)):
            def h64(i, j):  # the sum rounded to bf16, as the kernel and x + proj round it
                return (x[i:j] if shift is None else x[i:j] + shift[i:j].reshape(-1, c, 1, 1)).double()

            y, mean, rstd = cn.channel_norm_fwd(x, shift, ddof, stats=True)
            plain = cn.channel_norm_reference(x, shift, ddof)
            fwd = {"kernel": "channel_norm_fwd", "shape": list(shape), "shift": shift is not None, "ddof": ddof}
            _norm_gate(fwd, y, plain, _chunked_f64(
                lambda i, j: _norm_f64(h64(i, j), ddof=ddof),
                {"kernel": y, "plain": plain, "one_ulp_biased": _one_ulp_biased(y)}, b))
            del y, plain
            dh = cn.channel_norm_bwd(dy, x, shift, mean, rstd, ddof)
            again = cn.channel_norm_bwd(dy, x, shift, mean, rstd, ddof)
            plain = cn.channel_norm_bwd_reference(dy, x, shift, ddof)
            bwd = {"kernel": "channel_norm_bwd", "shape": list(shape), "shift": shift is not None, "ddof": ddof}
            _norm_gate(bwd, dh, plain, _chunked_f64(
                lambda i, j: cn.channel_norm_bwd_reference(dy[i:j].double(), h64(i, j), None, ddof),
                {"kernel": dh, "plain": plain, "one_ulp_biased": _one_ulp_biased(dh)}, b))
            bwd["same_bits_twice"] = bool(torch.equal(dh, again))
            if not bwd["same_bits_twice"]:
                bwd["failed"].append("the backward gives other bits on a second call")
            checks += [fwd, bwd]
            del dh, again, plain, mean, rstd
        # timed: the block's norm, shift at ddof 0 (the errors of its checks,
        # checks[-4] and checks[-3], beside)
        _, mean, rstd = cn.channel_norm_fwd(x, s, 0, stats=True)
        rows = x.numel() // c
        hl = (x + s.reshape(b, c, 1, 1)).movedim(1, -1)  # [..., C] rows, contiguous
        lib_in = hl.detach().requires_grad_(True)
        lib_out = torch.nn.functional.layer_norm(lib_in, (c,))
        dyl = dy.movedim(1, -1)
        el = x.element_size()
        fwd_ms = cuda_time_ms(lambda: cn.channel_norm_fwd(x, s, 0))
        fwd_plain = cuda_time_ms(lambda: cn.channel_norm_reference(x, s, 0))
        fwd_lib = cuda_time_ms(lambda: torch.nn.functional.layer_norm(hl, (c,)))
        # x read and y written; about 7 operations a value (add, sum, subtract,
        # square, sum, subtract, multiply)
        fwd_rows.append(timing_row(
            "channel_norm_fwd", "climate2weather_tpu_torch/csrc/channel_norm.cu",
            "climate2weather_tpu/models/unet.py:40", checks[-4]["max_abs_err"], fwd_ms, fwd_plain, fwd_lib, 2 * x.numel() * el + s.numel() * el, 7 * x.numel(), shape))
        bwd_ms = cuda_time_ms(lambda: cn.channel_norm_bwd(dy, x, s, mean, rstd, 0))
        bwd_plain = cuda_time_ms(lambda: cn.channel_norm_bwd_reference(dy, x, s, 0))
        bwd_lib = cuda_time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dyl, retain_graph=True))
        # dy and x read, dh written, the row's mean and rstd read; about 12
        # operations a value (the add, xhat, two sums, the closed form)
        bwd_rows.append(timing_row(
            "channel_norm_bwd", "climate2weather_tpu_torch/csrc/channel_norm.cu",
            "climate2weather_tpu/models/unet.py:40", checks[-3]["max_abs_err"], bwd_ms, bwd_plain, bwd_lib,
            3 * x.numel() * el + s.numel() * el + 8 * rows, 12 * x.numel(), shape))
        del x, s, dy, mean, rstd, hl, lib_in, lib_out, dyl
        torch.cuda.empty_cache()
    return checks, fwd_rows, bwd_rows


def phase3b_winograd_blocks(snapshot_dir, device, batch=32, seed=0) -> dict:
    """One ModResidualBlock of the snapshot at level 0 and one at its last
    level as two Winograd calls each (conv0 with pre="norm" and vec =
    project(emb); conv1 with pre="silu" and the block input as residual),
    each held against the same two calls in float64 (the same weights and
    projection, float64 convs and norm, not rounded between them): its mean
    distance at most WINO_SLACK times that of the block as two
    ``winograd_reference`` calls, its max at most WINO_MAX_SLACK times the
    port's cuDNN block's. A first conv whose top halo row is not zeroed, or
    whose norm has its ddof flipped, must exceed the mean limit. Printed
    beside: the cuDNN block's distances, and the kernel's distance from the
    cuDNN block with what moving every conv output of the cuDNN block by one
    bf16 ulp does to it (the old limit). Returns the phase's record with the
    kernel's launches."""
    from climate2weather_tpu_torch.convert import conv_weight_hwio
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.ops import winograd

    t0 = time.time()
    net, cfg = load_net(str(snapshot_dir), device)
    nk = cfg["network_kwargs"]
    nlev = len(nk["hidden_channels"])
    g = torch.Generator(device=device).manual_seed(seed)
    res = 128
    cases = []
    for level in (0, nlev - 1):
        block = getattr(net.unet, f"down{level}_block0")
        c, side = int(nk["hidden_channels"][level]), res // 2 ** level
        xn = torch.randn((batch, side, side, c), generator=g, device=device).to(torch.bfloat16)
        emb = torch.randn((batch, block.project.in_features), generator=g, device=device)
        cases.append((level, block, xn, emb.to(torch.bfloat16)))

    def fused(block, xn, emb, first=winograd.winograd_conv3x3, second=winograd.winograd_conv3x3, ddof=None):
        proj = block.project(emb)
        k0, k1 = conv_weight_hwio(block.conv0.weight), conv_weight_hwio(block.conv1.weight)
        h = first(xn, k0, block.conv0.bias, proj, None, "norm", block.norm_ddof if ddof is None else ddof)
        return second(h, k1, block.conv1.bias, None, xn, "silu", 0)

    def moved(module, inputs, out):  # every conv output one bf16 ulp up or down
        step = torch.randint(0, 2, out.shape, generator=g, device=out.device, dtype=torch.int16) * 2 - 1
        return (out.view(torch.int16) + step * (out != 0)).view(out.dtype)

    plain = winograd.winograd_reference
    with torch.no_grad():
        # the path: the two fused calls of each block, counted alone
        if device.type == "cuda":
            torch.cuda.synchronize()
        winograd.launch_counts["winograd_conv3x3"] = 0
        outs = [fused(block, xn, emb) for _, block, xn, emb in cases]
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = winograd.launch_counts["winograd_conv3x3"]
        records = []
        for (level, block, xn, emb), got in zip(cases, outs):
            x = xn.permute(0, 3, 1, 2)  # the port's NCHW view of channels-last memory
            cudnn = block(x, emb).permute(0, 2, 3, 1)
            hooks = [m.register_forward_hook(moved) for m in (block.conv0, block.conv1)]
            try:
                ulp_off = block(x, emb).permute(0, 2, 3, 1)
            finally:
                for hk in hooks:
                    hk.remove()
            exact = fused(block, xn, emb, _winograd_f64, _winograd_f64)
            base, cudnn_f64 = _diff(fused(block, xn, emb, plain, plain), exact), _diff(cudnn, exact)
            faults = {"halo_unmasked": fused(block, xn, emb, _halo_unmasked, plain),
                      "ddof_flipped": fused(block, xn, emb, plain, plain, ddof=1 - block.norm_ddof)}
            rec = {"level": level, "shape": list(xn.shape), "finite": bool(torch.isfinite(got).all()),
                   "out_scale": float(exact.abs().max()), "plain_f64": list(base), "cudnn_f64": list(cudnn_f64),
                   "f64_ratios": _wino_ratios(got, exact, base, cudnn_f64), "slack": WINO_SLACK,
                   "max_slack": WINO_MAX_SLACK,
                   "faults": {name: _wino_ratios(y, exact, base, cudnn_f64) for name, y in faults.items()},
                   "vs_cudnn": list(_diff(got, cudnn)), "one_ulp": list(_diff(ulp_off, cudnn)), "failed": []}
            if not rec["finite"]:
                rec["failed"].append("non-finite Winograd block output")
            _wino_gate(rec)
            records.append(rec)
    emit("3b", t0, blocks=records, launches=launches)
    _raise_failed("phase 3b", records)
    expect = 2 * len(records) if device.type == "cuda" else 0
    if launches != expect:
        raise AssertionError(f"Winograd kernel launched {launches} times, want {expect}")
    return {"launches": launches, "blocks": records}


def _one_ulp_off(q, k, v, g):
    """The plain attention with every nonzero output moved one bf16 ulp up or
    down at random: the most the kernel may differ by in one call."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    out = attention_reference(q, k, v)
    step = torch.randint(0, 2, out.shape, generator=g, device=out.device, dtype=torch.int16) * 2 - 1
    return (out.view(torch.int16) + step * (out != 0)).view(out.dtype)


def _key_dropped(q, k, v):
    """A faulty attention that ignores the last key."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    return attention_reference(q, k[:, :-1], v[:, :-1])


def _one_output_moved(q, k, v, g):
    """The plain attention with one output, drawn at random, moved one bf16
    ulp: the least a kernel that is not the plain version can differ by."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    out = attention_reference(q, k, v).contiguous()
    flat = out.view(-1)
    i = int(torch.randint(0, flat.numel(), (1,), generator=g, device=out.device))
    flat.view(torch.int16)[i] += 1
    return out


def _logits_exact(q, k, v):
    """The plain attention with QK^T summed in float64 and rounded once to
    fp32: the logits that any summation order but the plain version's own
    comes near (tensor cores sum exact bf16 products in fp32 partial sums)."""
    s = q.shape[-1] ** (-0.25)
    logits = torch.matmul(q.double() * s, (k.double() * s).transpose(-1, -2)).float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return torch.matmul(e / e.sum(dim=-1, keepdim=True), v.float()).to(q.dtype)


def _pv_exact(q, k, v):
    """The plain attention with P V summed in float64 and rounded once to
    q's dtype."""
    from climate2weather_tpu_torch.ops.attention import _softmax_probs

    p = _softmax_probs(q.float(), k.float())
    return torch.matmul(p.double(), v.double()).to(q.dtype)


def _attention_launch(q, k, v, got, key_dropped=True) -> dict:
    """One attention launch, ``got`` from the kernel on q, k, v, against the
    plain version: its max distance within one bf16 ulp of the output scale
    (fp32: 1e-5), which an attention that drops a key must exceed. For bf16
    also against float64: its mean distance at most LAUNCH_SLACK times the
    plain version's, which the plain output moved one ulp away from zero
    must exceed (it stays within the one-ulp limit: ``biased_passes_max``);
    either product summed in float64 is read beside it. The record's
    ``failed`` names what failed."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    want = attention_reference(q, k, v)
    err, scale = _diff(got, want)[0], float(want.float().abs().max())
    # fp32: sums in another order, ~1e-5 relative; bf16: both sides round
    # one fp32 value, so they differ by at most one ulp
    tol = 1e-5 * max(scale, 1.0) if q.dtype == torch.float32 else bf16_ulp(scale)
    rec = {"max_abs_err": err, "tol": tol, "outputs_differ": int((got != want).sum()), "failed": []}
    if err > tol:
        rec["failed"].append("the kernel is off the plain version by more than one ulp")
    if key_dropped:
        rec["key_dropped_err"] = _diff(_key_dropped(q, k, v), want)[0]
        if rec["key_dropped_err"] <= tol:
            rec["failed"].append("the one-ulp limit cannot see a dropped key")
    if q.dtype == torch.bfloat16:
        exact = _attention_f64(q, k, v)
        base = _diff(want, exact)
        biased = _one_ulp_biased(want)
        rec.update(plain_f64=list(base), f64_ratio=_ratio(got, exact, base)[1], slack=LAUNCH_SLACK,
                   biased_err=_diff(biased, want)[0], biased_ratio=_ratio(biased, exact, base)[1],
                   controls={"logits_exact": _ratio(_logits_exact(q, k, v), exact, base)[1],
                             "pv_exact": _ratio(_pv_exact(q, k, v), exact, base)[1]})
        rec["biased_passes_max"] = rec["biased_err"] <= tol
        if rec["f64_ratio"] > LAUNCH_SLACK:
            rec["failed"].append("the kernel is farther from float64 than LAUNCH_SLACK allows")
        if rec["biased_ratio"] <= LAUNCH_SLACK:
            rec["failed"].append("the float64 limit cannot see outputs moved one ulp away from zero")
    return rec


def phase3_network(snapshot_dir, device, batch=96, res=128, seed=0, compare_plain=True) -> dict:
    """Load the snapshot through the port's readers and run one forward;
    with ``compare_plain``, hold every attention launch of that forward to
    phase 2's checks on its own inputs (``_attention_launch``), and the
    forward to the same net with its attention in float64: the max and mean
    distance at most FORWARD_SLACK times the forward's with the plain
    attention. Read beside, not gated: other summation orders, the planted
    faults and the old limit (what moving every attention output one ulp
    does to the plain forward)."""
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.models import unet
    from climate2weather_tpu_torch.models.unet import AttentionBlock
    from climate2weather_tpu_torch.ops.attention import (
        attention_reference,
        fused_attention,
        launch_counts,
    )

    t0 = time.time()
    net, cfg = load_net(str(snapshot_dir), device)
    n_params = sum(p.numel() for p in net.parameters())
    channels = int(cfg["network_kwargs"]["channels"])
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, res, res, channels), generator=g, device=device)
    t = torch.rand((batch,), generator=g, device=device)
    n_attn = sum(isinstance(m, AttentionBlock) for m in net.modules())
    expect = n_attn if device.type == "cuda" else 0
    calls = []

    def recorded(q, k, v):
        out = fused_attention(q, k, v)
        if compare_plain:
            calls.append((q, k, v, out))
        return out

    def forward(attend):
        unet.fused_attention = attend
        try:
            return net(x, t).float()
        finally:
            unet.fused_attention = fused_attention

    with torch.no_grad():
        before = launch_counts["attention_fwd"]
        out = forward(recorded)
        rose = launch_counts["attention_fwd"] - before
        if device.type == "cuda":
            torch.cuda.synchronize()
        if rose != expect:
            raise AssertionError(f"attention kernel launched {rose} times in one forward, want {expect}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite network output")
        result = {"params": n_params, "shape": list(out.shape), "attention_blocks": n_attn,
                  "launches": rose}
        if compare_plain:
            # each launch against the plain version and float64 on its own
            # inputs, as phase 2 holds them, with the dropped key planted
            per_call = [_attention_launch(q, k, v, got) for q, k, v, got in calls]
            plain = forward(attention_reference)
            # the yardstick: the same net with its attention in float64,
            # rounded once to the attention's output type
            exact = forward(lambda q, k, v: _attention_f64(q, k, v).to(q.dtype))
            base = _diff(plain, exact)
            # other attentions, read beside the gate and not gated: one
            # output moved one ulp, or either product summed in another
            # order than the plain version's (each a ratio to the plain
            # forward's distance from the yardstick, max and mean); and the
            # planted faults, which the per-launch checks above must see
            controls = {"one_output_moved": lambda q, k, v: _one_output_moved(q, k, v, g),
                        "logits_exact": _logits_exact, "pv_exact": _pv_exact}
            faults = {"one_ulp_biased": lambda q, k, v: _one_ulp_biased(attention_reference(q, k, v)),
                      "key_dropped": _key_dropped}
            controls, faults = ({k: _ratio(forward(fn), exact, base) for k, fn in d.items()}
                                for d in (controls, faults))
            ratios = _ratio(out, exact, base)
            result.update(per_call=per_call, out_scale=float(exact.abs().max()), plain_f64=list(base),
                          f64_ratios=ratios, slack=FORWARD_SLACK, controls=controls, faults=faults,
                          faults_fail_forward_gate={k: max(r) > FORWARD_SLACK for k, r in faults.items()},
                          # the old limit, printed: the kernel's distance from
                          # the plain forward beside what moving every
                          # attention output one ulp does to it
                          vs_plain=list(_diff(out, plain)),
                          one_ulp=list(_diff(forward(lambda q, k, v: _one_ulp_off(q, k, v, g)), plain)),
                          failed=[])
            if max(ratios) > FORWARD_SLACK:
                result["failed"].append("the kernel's forward is farther from the yardstick than FORWARD_SLACK")
            if device.type == "cuda":  # one forward each way, warm, CUDA events
                result["forward_plain_ms"] = cuda_time_ms(lambda: forward(attention_reference),
                                                          reps=3, warmup=1)
                result["forward_ms"] = cuda_time_ms(lambda: forward(fused_attention), reps=3, warmup=1)
    emit(3, t0, **result)
    _raise_failed("phase 3", [result, *result.get("per_call", [])])
    return result


def synthetic_inputs(L, H, W, C, n_train, seed):
    """A ground-truth trajectory with a power-law spectrum, smooth in time,
    and a stack of training frames [T, C, H, W] for the calibration target."""
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.fftfreq(W)[None, :]
    amp = (np.sqrt(ky**2 + kx**2) + 1.0 / H) ** (-1.5)

    def fields(n):
        spec = (rng.standard_normal((n, C, H, W)) + 1j * rng.standard_normal((n, C, H, W))) * amp
        f = np.fft.ifft2(spec, axes=(-2, -1)).real
        return (f / f.std(axis=(0, 2, 3), keepdims=True)).astype(np.float32)

    base = fields(L)
    gt = np.cumsum(base, axis=0) / np.sqrt(np.arange(1, L + 1))[:, None, None, None]
    return gt.transpose(0, 2, 3, 1).astype(np.float32), fields(n_train)


def phase4_slice(snapshot_dir, config_path, device, L=49, res=128, n_train=64, seed=0,
                 overrides=None) -> dict:
    """The main path: ``run_arrays`` at the config's settings, as its two
    steps ``load_net`` and ``sample_arrays``, timed apart."""
    from climate2weather_tpu_torch.diffusion.calibrate import climatological_annulus_psd
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
    from climate2weather_tpu_torch.exp.downscaling import load_net, sample_arrays
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts
    from climate2weather_tpu_torch.utils import trace

    t0 = time.time()
    cfg = yaml_load_file(config_path)
    cfg.update({"num_samples": 3, **(overrides or {})})
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    C = int(snap_cfg["dataset_kwargs"]["train"]["num_features"])
    gt, train = synthetic_inputs(L, res, res, C, n_train, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in launch_counts:
        launch_counts[k] = 0
    _reset_norm_counts()
    t_load = time.time()
    net, snap_cfg = load_net(str(snapshot_dir), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    trace.reset()
    trace.enable()  # the program's own count of the work and its spans (utils/trace.py), beside the arithmetic below
    t_sample = time.time()
    try:
        samples, nan_flags = sample_arrays(net, snap_cfg, cfg, gt, calib_frames=train, device=device)
    finally:
        trace.disable()
    t_end = time.time()  # sample_arrays ends in a copy to the host
    launches = dict(launch_counts)
    norm_launches = _norm_counts()
    counted = {k: trace.counters().get(k, 0) for k in ("window_evals", "forwards")}
    records = trace.records()
    trace.reset()
    groups = {r.id for r in records if r.name == "c2w.sample.group"}
    post = [r for r in records if r.name == "c2w.sample.postprocess"]
    t_psd = time.time()  # the host-side calibration target, which sample_arrays computes once
    climatological_annulus_psd(train, s_step=int(cfg["s_step"]))
    psd_s = time.time() - t_psd

    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    n_win, chunk = L - window + 1, int(cfg["batch_size"])
    per_call = n_win if n_win <= chunk else chunk  # windows per member per forward
    n_chunks = -(-n_win // per_call)
    evals = int(cfg["num_sampling_steps"]) + int(bool(cfg.get("denoise_final", False)))
    n_samples = int(cfg["num_samples"])
    forwards = -(-n_samples // int(cfg.get("ensemble_batch", 1))) * evals * n_chunks
    nk = snap_cfg["network_kwargs"]
    n_attn = 2 * sum(int(b) for i, b in enumerate(nk["hidden_blocks"])
                     if i in nk.get("attention_levels", ()))
    expect = n_attn * forwards if device.type == "cuda" else 0
    # every norm of every forward on the kernel, none on the plain version
    expect_norm = {"channel_norm_fwd": _norms_per_forward(nk) * forwards if device.type == "cuda" else 0,
                   "channel_norm_bwd": 0}
    window_evals = n_samples * evals * n_chunks * per_call
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    consistency, tol = _consistency(A, [torch.from_numpy(samples)], A(torch.from_numpy(gt)))
    x_max = float(np.abs(samples).max())
    result = {
        "samples_shape": list(samples.shape), "finite": bool(np.isfinite(samples).all()),
        "nan_flags": nan_flags.tolist(), "sample_abs_max": x_max,
        "A_x_minus_y_max": consistency, "A_tol": tol,
        "unet_forwards": forwards, "attention_launches": launches.get("attention_fwd", 0),
        "expected_launches": expect, "norm_launches": norm_launches, "expected_norm_launches": expect_norm,
        "load_s": t_sample - t_load, "sampling_s": t_end - t_sample,
        "calib_target_s": psd_s, "wall_s": t_end - t_load, "window_evals": window_evals,
        "window_evals_per_s": window_evals / (t_end - t_sample),
        "counted_window_evals": counted["window_evals"], "counted_forwards": counted["forwards"],
        "groups": len(groups), "postprocess_device_ms": [r.device_ms for r in post],
        "postprocess_host_ms": [(r.end_ns - r.start_ns) / 1e6 for r in post],
    }
    emit(4, t0, **result)
    if not result["finite"] or nan_flags.any():
        raise AssertionError(f"non-finite samples or NaN flags: {result}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y after the projection: {consistency} > {tol}")
    if launches.get("attention_fwd", 0) != expect:
        raise AssertionError(f"attention launches {launches} != 6 x forwards = {expect}")
    if norm_launches != expect_norm:
        raise AssertionError(f"channel-norm launches {norm_launches} != {expect_norm}")
    if (counted["window_evals"], counted["forwards"]) != (window_evals, forwards):
        raise AssertionError(f"the program counted {counted}, the config's shapes give "
                             f"{window_evals} window evaluations in {forwards} forwards")
    n_groups = -(-n_samples // int(cfg.get("ensemble_batch", 1)))
    if len(groups) != n_groups or sorted(r.parent for r in post) != sorted(groups):
        raise AssertionError(f"{len(post)} post-processing spans in {len(groups)} groups, "
                             f"one in each of {n_groups} groups expected")
    return {"launches": launches, **result}


def write_training_h5(path, lhwc: np.ndarray) -> None:
    """A training file of the layout ``merged_to_normed_h5`` writes: ``x``
    [T, C, H, W] float32 in chunks of 24 frames, with the ``vars`` and
    ``norm_mode`` attributes, through the port's own HDF5 writer."""
    from climate2weather_tpu_torch.io import hdf5

    x = np.ascontiguousarray(lhwc.transpose(0, 3, 1, 2), np.float32)
    with hdf5.Writer(path) as w:
        w.create_dataset("x", data=x, chunks=(min(24, x.shape[0]),) + x.shape[1:])
        w.attrs["vars"] = ["psl", "tas", "uas", "vas"][: x.shape[1]]
        w.attrs["norm_mode"] = "quant95"


class RecordingProcess(VPCosineProcess):
    """The training noise process, recording for phase 5 each microbatch's
    loss, its t and a fingerprint of its eps, and the synchronised start
    time of each step (the first microbatch's loss call)."""

    records: list = []
    rounds: int = 1

    def perturb(self, x, t, generator=None, eps=None):
        xt, eps = super().perturb(x, t, generator, eps)
        RecordingProcess.records.append({
            "t": t.detach().flatten().float().clone(),
            "eps_sum": eps.sum(dtype=torch.float64), "eps_head": eps.flatten()[:8].float(),
        })
        return xt, eps

    def loss(self, eps_model, x, forcing=None, generator=None, t=None, eps=None):
        if x.device.type == "cuda" and len(RecordingProcess.records) % RecordingProcess.rounds == 0:
            torch.cuda.synchronize()
        start = time.perf_counter()
        out = super().loss(eps_model, x, forcing, generator, t, eps)
        RecordingProcess.records[-1].update(loss=out.detach(), start=start)
        return out


def phase5_training(device, seed=0, model_config=MODEL_CONFIG, res=128, frames=140,
                    batch=64, batch_gpu=32, ndata=1024, compute_dtype=torch.bfloat16,
                    check_launches=True) -> dict:
    """Train with ``training_loop`` to ``ndata``, checkpoint and snapshot
    there, and resume to ``2 * ndata``; see the module docstring."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch.data.dataset import InfiniteSampler, WindowDataset
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.ops import attention
    from climate2weather_tpu_torch.training.checkpoint import CheckpointIO
    from climate2weather_tpu_torch.training.loop import training_loop
    from climate2weather_tpu_torch.training.state import (
        gather_windows,
        init_train_state,
        make_optimizer,
        step_generator,
        upload_dataset,
    )

    t0 = time.time()
    window, n_features = 13, 4  # the 72.1M snapshot's: 4 variables x 13 frames
    net_kwargs = {"class_name": "score_unet", "channels": n_features * window,
                  **yaml_load_file(model_config)}
    run_dir = tempfile.mkdtemp(prefix="c2w-train-")
    data_path = os.path.join(run_dir, "train.h5")
    write_training_h5(data_path, synthetic_inputs(frames, res, res, n_features, 1, seed)[0])
    data_kwargs = {"class_name": "cosmo_dataset", "data_path": data_path,
                   "num_features": n_features, "spatial_res": res, "window": window}
    rounds = batch // batch_gpu
    n_attn = 2 * sum(int(b) for i, b in enumerate(net_kwargs["hidden_blocks"])
                     if i in net_kwargs.get("attention_levels", ()))
    kwargs = dict(
        dataset_kwargs={"train": data_kwargs}, network_kwargs=net_kwargs,
        pipeline_kwargs={"class_name": "chip_smoke.RecordingProcess"},
        optimizer_kwargs={"class_name": "adamw", "lr": 2e-4, "weight_decay": 1e-3,
                          "betas": [0.9, 0.999]},
        lr_kwargs={"func_name": "lr/linear", "ref_lr": 2e-4, "total_ndata": 2 * ndata},
        batch_size=batch, batch_gpu=batch_gpu, log_ndata=None, status_ndata=ndata // 2,
        snapshot_ndata=ndata, checkpoint_ndata=ndata, valid_ndata=None,
        ema_kwargs={"rates": [0.9999]}, seed=seed, device=device, compute_dtype=compute_dtype,
        loader_threads=1,
    )
    RecordingProcess.rounds = rounds
    cuda = device.type == "cuda"
    try:
        # -- run 1: 0 -> ndata, checkpoint and snapshot at ndata ------------
        RecordingProcess.records = []
        for name in attention.launch_counts:
            attention.launch_counts[name] = 0
        _reset_norm_counts()
        if cuda:
            # torch keeps a cuBLAS workspace for every stream that ran cuBLAS
            # (phase 2's graph timings) allocated until cleared: not training's
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.reset_peak_memory_stats(device)
        state1 = training_loop(run_dir, total_ndata=ndata, **kwargs)
        launches1, norms1 = dict(attention.launch_counts), _norm_counts()
        records = list(RecordingProcess.records)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None

        # -- the checkpoint restores the state exactly ----------------------
        ckpt = os.path.join(run_dir, f"training-state-{ndata // 1000:07d}.ckpt")
        fresh_net = build_score_unet(net_kwargs, dtype=compute_dtype).to(device)
        fresh = init_train_state(fresh_net, make_optimizer(fresh_net.parameters(),
                                                           kwargs["optimizer_kwargs"]), [0.9999])
        CheckpointIO(state=fresh, meta={"batch_size": batch}).load(ckpt, verbose=False)
        mismatched = [k for k, v in state1.net.state_dict().items()
                      if not torch.equal(v, fresh_net.state_dict()[k])]
        p1, p2 = dict(state1.net.named_parameters()), dict(fresh_net.named_parameters())
        for k in p1:
            s1, s2 = state1.optimizer.state[p1[k]], fresh.optimizer.state[p2[k]]
            if not (torch.equal(s1["exp_avg"], s2["exp_avg"])
                    and torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])
                    and float(s1["step"]) == float(s2["step"])):
                mismatched.append(f"opt:{k}")
        for rk, ema in state1.emas.items():
            mismatched += [f"ema{rk}:{k}" for k, v in ema.items() if not torch.equal(v, fresh.emas[rk][k])]
        restored_exact = not mismatched and fresh.step == state1.step
        del fresh, fresh_net

        # -- what an uninterrupted run draws and computes at the next step -
        ds = WindowDataset(**{k: v for k, v in data_kwargs.items() if k != "class_name"})
        it = iter(InfiniteSampler(len(ds), seed=seed, start_idx=ndata))
        idx = torch.tensor([next(it) for _ in range(batch_gpu)], device=device)
        data = upload_dataset(ds._reader(), ds.raw_data_shape[0], device=device)
        RecordingProcess.records = []
        with torch.no_grad():
            RecordingProcess().loss(lambda xt, t, f: state1.net(xt, t),
                                    gather_windows(data, idx, window),
                                    generator=step_generator(seed, ndata // batch, device))
        uninterrupted = RecordingProcess.records[0]
        del state1, data

        # -- run 2: resume ndata -> 2 ndata; record the backward launches of
        # its first step
        bwd_calls = []
        plain_bwd = attention.attention_bwd

        def recorded_bwd(q, k, v, do):
            out = plain_bwd(q, k, v, do)
            if len(bwd_calls) < n_attn * rounds:  # the launches of one step
                bwd_calls.append((q, k, v, do.detach(), out))
            return out

        RecordingProcess.records = []
        for name in attention.launch_counts:
            attention.launch_counts[name] = 0
        _reset_norm_counts()
        attention.attention_bwd = recorded_bwd
        try:
            training_loop(run_dir, total_ndata=2 * ndata, **kwargs)
        finally:
            attention.attention_bwd = plain_bwd
        launches2, norms2 = dict(attention.launch_counts), _norm_counts()
        records += RecordingProcess.records
        resumed = RecordingProcess.records[0]
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(device))

        # -- checks ----------------------------------------------------------
        steps = len(records) // rounds
        losses = [float(sum(float(r["loss"]) for r in records[i * rounds:(i + 1) * rounds]) / rounds)
                  for i in range(steps)]
        draws_equal = bool(torch.equal(resumed["t"], uninterrupted["t"])
                           and float(resumed["eps_sum"]) == float(uninterrupted["eps_sum"])
                           and torch.equal(resumed["eps_head"], uninterrupted["eps_head"]))
        resume_loss_diff = abs(float(resumed["loss"]) - float(uninterrupted["loss"]))
        # the two forwards run the same kernels on the same bits
        resume_tol = 1e-6 * abs(float(uninterrupted["loss"]))
        per_run = n_attn * rounds * (ndata // batch) if cuda else 0
        remat = 2 if os.environ.get("C2W_REMAT", "0") == "1" else 1  # the forward again in the backward
        want_fwd = per_run * remat
        # the norms of every microbatch's forward and backward on the kernels
        norms = _norms_per_forward(net_kwargs) * rounds * (ndata // batch) if cuda else 0
        want_norm = {"channel_norm_fwd": norms * remat, "channel_norm_bwd": norms}
        per_launch = []
        with torch.no_grad():
            for q, k, v, do, got in bwd_calls:
                want = attention.attention_bwd_reference(q, k, v, do)
                errs, scales = _grads_err(got, want)
                tols = _bwd_tols(scales, q.dtype)
                fault, _ = _grads_err(_rowsum_dropped(q, k, v, do), want)
                per_launch.append({"max_abs_err": errs, "tol": tols,
                                   "rowsum_dropped_err": fault[:2]})
        starts = [records[i * rounds]["start"] for i in range(steps)]
        half = ndata // batch
        warm = [b - a for run in (starts[:half], starts[half:]) for a, b in zip(run[2:], run[3:])]
        snap = os.path.join(run_dir, f"network-snapshot-{ndata // 1000:07d}-0.999900")
        snap_net, _ = load_net(snap, device)
        with torch.no_grad():
            y = snap_net(torch.randn((2, res, res, n_features * window), generator=torch.Generator(
                device=device).manual_seed(seed), device=device), 0.5)
        result = {
            "params": sum(p.numel() for p in snap_net.parameters()), "steps": steps,
            "losses": losses, "first4_mean": float(np.mean(losses[:4])),
            "last4_mean": float(np.mean(losses[-4:])), "restored_exact": restored_exact,
            "restore_mismatches": mismatched[:5], "resume_draws_equal": draws_equal,
            "resume_loss": float(resumed["loss"]), "uninterrupted_loss": float(uninterrupted["loss"]),
            "resume_loss_diff": resume_loss_diff, "resume_tol": resume_tol,
            "launches_run1": launches1, "launches_run2": launches2,
            "expected_fwd": want_fwd, "expected_bwd": per_run,
            "norm_launches_run1": norms1, "norm_launches_run2": norms2, "expected_norm": want_norm,
            "bwd_per_launch": per_launch,
            "snapshot_forward_finite": bool(torch.isfinite(y.float()).all()),
            "step_ms_warm": [1e3 * w for w in warm],
            "step_ms_mean": 1e3 * float(np.mean(warm)) if warm else None,
            "samples_per_s": batch / float(np.mean(warm)) if warm else None,
            "max_memory_allocated": peak,
        }
        del snap_net
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    emit(5, t0, **result)
    if not all(np.isfinite(losses)) or not result["last4_mean"] < result["first4_mean"]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not restored_exact:
        raise AssertionError(f"checkpoint restore differs: {mismatched[:10]}")
    if not draws_equal or resume_loss_diff > resume_tol:
        raise AssertionError("the resumed step differs from the uninterrupted one: "
                             f"draws equal {draws_equal}, loss diff {resume_loss_diff}")
    if check_launches:
        for name, got, norms in (("run 1", launches1, norms1), ("run 2", launches2, norms2)):
            if got["attention_fwd"] != want_fwd or got["attention_bwd"] != per_run:
                raise AssertionError(f"{name}: launches {got}, want fwd {want_fwd} bwd {per_run}")
            if norms != want_norm:
                raise AssertionError(f"{name}: channel-norm launches {norms}, want {want_norm}")
    if len(bwd_calls) != n_attn * rounds or any(
            any(e > tl for e, tl in zip(c["max_abs_err"], c["tol"])) for c in per_launch):
        raise AssertionError(f"a backward launch in training disagrees: {per_launch}")
    if any(min(c["rowsum_dropped_err"]) <= max(c["tol"][:2]) for c in per_launch):
        raise AssertionError(f"the per-launch check cannot see a dropped row sum: {per_launch}")
    if not result["snapshot_forward_finite"]:
        raise AssertionError("the snapshot's forward is not finite")
    return {"launches": {k: launches1[k] + launches2[k] for k in launches1},
            "norm_launches": {k: norms1[k] + norms2[k] for k in norms1}, **result}


PREDICT_CONFIGS = REPO / "exp" / "configs" / "000_on-model-eval"
# (name of the run, config it copies, overrides): the confirmed dpmpp2m
# setting, PC cut from its 256 steps to 64, the external observation and
# guidance off
PREDICT_RUNS = (
    ("s16_t6_spectral", "s16_t6_spectral.yml", {"num_samples": 3}),
    ("s16_t6", "s16_t6.yml", {"num_samples": 3, "num_sampling_steps": 32}),
    ("external_observation", "s16_t6_spectral.yml",
     {"num_samples": 3, "num_sampling_steps": 8, "observation_path": "obs"}),
    ("guidance_off", "s16_t6_spectral.yml",
     {"num_samples": 3, "num_sampling_steps": 8, "guidance_off": True}),
)
# offset and scale of each variable in physical units (Pa, K, m/s)
PHYSICAL = {"psl": (101000.0, 800.0), "tas": (285.0, 5.0), "uas": (0.0, 4.0), "vas": (0.0, 4.0)}
# the external-observation run's files at 128 x 128 and 49 hours from seed 0:
# coarse_observation(predict_grid()) written by h5py (libver 'latest', a
# version-2 B-tree chunk index; tests/_h5py_layout_fixtures.py): shuffle +
# lzf + fletcher32 with compact coordinates, and szip with the coordinates
# in external raw storage (the run reads the last)
OBSERVATION_FIXTURE = REPO / "tests" / "fixtures" / "observation_latest.nc"
OBSERVATION_FIXTURES = (OBSERVATION_FIXTURE, REPO / "tests" / "fixtures" / "observation_szip.nc")


@contextlib.contextmanager
def extfile_origin():
    """External raw storage found beside the file naming it, as
    ``HDF5_EXTFILE_PREFIX=${ORIGIN}`` has HDF5 (and the port's reader) find
    it; the variable restored after."""
    before = os.environ.get("HDF5_EXTFILE_PREFIX")
    os.environ["HDF5_EXTFILE_PREFIX"] = "${ORIGIN}"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("HDF5_EXTFILE_PREFIX", None)
        else:
            os.environ["HDF5_EXTFILE_PREFIX"] = before


def predict_grid(res=128, hours=49, seed=0, start="2014-04-07T04"):
    """Phase 6's synthetic ``hours``-hour grid of psl, tas, uas, vas from
    ``start`` (a ``GridDataset`` in physical units)."""
    from climate2weather_tpu_torch.data.grid import GridDataset

    gt, _ = synthetic_inputs(hours, res, res, len(PHYSICAL), 1, seed)
    time_axis = np.datetime64(start, "ns") + np.arange(hours) * np.timedelta64(1, "h")
    coords = {"time": time_axis, "rlat": np.linspace(-5.0, 5.0, res), "rlon": np.linspace(-5.0, 5.0, res)}
    return GridDataset({v: (gt[..., i] * sc + off).astype(np.float32)
                        for i, (v, (off, sc)) in enumerate(sorted(PHYSICAL.items()))},
                       coords, {"source": "chip_smoke synthetic"})


def coarse_observation(ds):
    """A coarse observation of the grid ``ds``: the 16x block means every 6
    hours, tas biased by 1 K, as a climate model's would be."""
    obs = ds.coarsen_mean(16).isel_time(np.arange(0, len(ds.time), 6))
    return obs.map(lambda k, v: v + np.float32(1.0 if k == "tas" else 0.0))


def write_predict_inputs(root: pathlib.Path, res=128, hours=49, seed=0, start="2014-04-07T04") -> dict:
    """Phase 6's files, through the port's writers: the grid of
    :func:`predict_grid`, its quantile file, a training file normalized
    with them, and its :func:`coarse_observation`."""
    from climate2weather_tpu_torch.data.pipeline import compute_quantiles, merged_to_normed_h5

    ds = predict_grid(res, hours, seed, start)
    paths = {k: str(root / f) for k, f in (("data", "merged-allvars.nc"), ("quantiles", "quantiles.nc"),
                                          ("train", "train_normed.h5"), ("obs", "observation-coarse.nc"))}
    ds.to_file(paths["data"])
    compute_quantiles(ds).to_file(paths["quantiles"])
    merged_to_normed_h5(paths["data"], paths["quantiles"], paths["train"])
    coarse_observation(ds).to_file(paths["obs"])
    return paths


def _attention_blocks(network_kwargs: dict) -> int:
    """Attention launches per UNet forward: one per attention block, two
    blocks (down and up) per residual block of an attention level."""
    return 2 * sum(int(b) for i, b in enumerate(network_kwargs["hidden_blocks"])
                   if i in network_kwargs.get("attention_levels", ()))


def _norms_per_forward(network_kwargs: dict) -> int:
    """Channel-norm launches per UNet forward (and per backward): one per
    residual block (down and up), one per attention block, one per tail
    above level 0; 40 for the 72.1M net, 53 for sda_unet_large."""
    blocks = [int(b) for b in network_kwargs["hidden_blocks"]]
    return 2 * sum(blocks) + _attention_blocks(network_kwargs) + len(blocks) - 1


def _reset_norm_counts() -> None:
    from climate2weather_tpu_torch.ops import channel_norm

    for name in channel_norm.launch_counts:
        channel_norm.launch_counts[name] = 0


def _norm_counts() -> dict:
    from climate2weather_tpu_torch.ops import channel_norm

    return dict(channel_norm.launch_counts)


def _expected_forwards(cfg: dict, L: int, window: int) -> int:
    """UNet forwards of one run: groups x network evaluations x window chunks."""
    n_win, chunk = L - window + 1, int(cfg.get("batch_size", 16))
    n_chunks = -(-n_win // min(n_win, chunk))
    steps = int(cfg.get("num_sampling_steps", 256))
    if cfg.get("sampler_kind", "pc") == "pc":
        steps *= 1 + int(cfg.get("num_corrections", 2))
    evals = steps + int(bool(cfg.get("denoise_final", False)))
    groups = -(-int(cfg.get("num_samples", 1)) // max(1, int(cfg.get("ensemble_batch", 1))))
    return groups * evals * n_chunks


def _normed(ds, cfg: dict, quantiles) -> np.ndarray:
    """A grid read back from a run, normalized as the run normalized it:
    [L, H, W, C] float32."""
    from climate2weather_tpu_torch.data import pipeline

    x = pipeline.normalize_ds(ds, quantiles, cfg["data_norm_mode"])
    return pipeline.nchw_to_nhwc(pipeline.ds_to_sorted_np(x, sorted(cfg["data_vars"])))


def _written_consistency(out_dir, samples, cfg: dict, quantiles) -> tuple:
    """:func:`_consistency` of the written samples in normalized space, y
    being the observation the run wrote."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening

    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    y = torch.from_numpy(_normed(open_grid(str(out_dir / "observation.nc")), cfg, quantiles))
    xs = [torch.from_numpy(_normed(smp, cfg, quantiles)) for smp in samples]
    return _consistency(A, xs, y)


def _consistency(A, xs, y, bf16=False) -> tuple:
    """max |A(x) - y| over the samples ``xs`` and its limit: phase 4's (the
    fp32 round-off of the FFT passes relative to both fields' magnitudes),
    plus half a bf16 ulp of the largest value where the trajectory is bf16
    (the last projection pass rounds every value)."""
    err = max(float((A(x) - y).abs().max()) for x in xs)
    x_max = max(float(x.abs().max()) for x in xs)
    tol = 1e-4 * max(1.0, float(y.abs().max())) + 1e-6 * x_max
    return err, tol + (bf16_ulp(x_max) / 2 if bf16 else 0.0)


def samples_digest(samples) -> str:
    """The SHA-256 of written samples' values (each sample's variables in
    name order): two runs wrote the same bits where it is equal."""
    import hashlib

    digest = hashlib.sha256()
    for smp in samples:
        for k in sorted(smp.data_vars):
            digest.update(np.ascontiguousarray(smp.data_vars[k]).tobytes())
    return digest.hexdigest()


def _predict_runs(root, paths, snapshot_dir, device, runs, hours, steps_override=None) -> list:
    """``exp/downscaling.run`` on each ``(name, config, overrides)`` of
    ``runs`` from the files ``paths``: each output ``.nc`` read back with the
    port's reader and checked finite; where the config projects, A(x) = y in
    normalized space under phase 4's tolerance; the attention launches 6 per
    UNet forward on the card; the samples' digest (:func:`samples_digest`).
    Returns one record per run."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    n_attn = _attention_blocks(snap_cfg["network_kwargs"])
    records = []
    for name, base, overrides in runs:
        cfg = yaml_load_file(PREDICT_CONFIGS / base)
        cfg.update(model_path=str(snapshot_dir), data_path=paths["data"],
                   quantile_path=paths["quantiles"], observation_path=paths["data"])
        if cfg.get("spectral_calibrate"):
            cfg["spectral_calibrate"] = paths["train"]
        cfg.update({k: paths[v] if k == "observation_path" else v for k, v in overrides.items()})
        if steps_override:
            cfg["num_sampling_steps"] = min(int(cfg["num_sampling_steps"]), steps_override)
        config_path = root / f"{name}.yml"
        yaml_dump_file(cfg, config_path)
        for k in launch_counts:
            launch_counts[k] = 0
        t_run = time.time()
        out_dir = downscaling.run(str(root / "out"), str(config_path), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.time() - t_run
        launches = launch_counts["attention_fwd"]
        expect = n_attn * _expected_forwards(cfg, hours, window) if device.type == "cuda" else 0
        samples = [open_grid(str(out_dir / f"gen_sample_{i:03d}.nc")) for i in range(int(cfg["num_samples"]))]
        finite = all(bool(np.isfinite(v).all()) for smp in samples for v in smp.data_vars.values())
        rec = {"run": name, "seconds": seconds, "attention_launches": launches,
               "expected_launches": expect, "finite": finite,
               "outputs": sorted(p.name for p in out_dir.iterdir()), "samples_sha256": samples_digest(samples)}
        if cfg.get("t0_project"):
            consistency, tol = _written_consistency(out_dir, samples, cfg, paths["quantiles"])
            rec.update(A_x_minus_y_max=consistency, A_tol=tol)
        records.append(rec)
        if not finite:
            raise AssertionError(f"predict wrote non-finite samples: {rec}")
        if "A_tol" in rec and rec["A_x_minus_y_max"] > rec["A_tol"]:
            raise AssertionError(f"A(x) != y in the written samples: {rec}")
        if launches != expect:
            raise AssertionError(f"attention launches {launches} != 6 per UNet forward = {expect}: {rec}")
    return records


def phase6_predict(snapshot_dir, device, res=128, hours=49, seed=0, steps_override=None,
                   observation=OBSERVATION_FIXTURES) -> dict:
    """``exp/downscaling.run`` (the ``predict`` entry point) from files the
    phase writes with the port's writers, with h5py made unimportable: the
    runs of ``PREDICT_RUNS``, checked by :func:`_predict_runs`. Each file of
    ``observation`` must hold the observation written here, bit for bit
    (:func:`_fixture_observation`); the external-observation run reads the
    last. None keeps the written one, for sizes the committed fixtures are
    not made at."""
    import shutil
    import tempfile

    t0 = time.time()
    sys.modules["h5py"] = None  # the port reads and writes HDF5 without it
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-predict-"))
    try:
        paths = write_predict_inputs(root, res, hours, seed)
        with extfile_origin():
            observation = {"observation": "written by write_predict_inputs"} if observation is None else \
                _fixture_observation(paths, [pathlib.Path(p) for p in observation])
            records = _predict_runs(root, paths, snapshot_dir, device, PREDICT_RUNS, hours, steps_override)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(6, t0, runs=records, **observation)
    return {"runs": records, **observation}


def _fixture_observation(paths: dict, fixtures: list) -> dict:
    """Point ``paths["obs"]`` at the last of ``fixtures`` once each holds
    the observation :func:`write_predict_inputs` wrote, bit for bit: its
    variables, times, coordinates and attributes. Each one's largest value
    difference is recorded beside."""
    from climate2weather_tpu_torch.data.grid import open_grid

    written = open_grid(paths["obs"])
    rec = {"observation": os.path.relpath(fixtures[-1], REPO), "observation_fixtures": {}}
    for path in fixtures:
        fixture = open_grid(str(path))
        equal = {"vars": sorted(fixture.data_vars) == sorted(written.data_vars),
                 "attrs": fixture.attrs == written.attrs,
                 **{c: getattr(fixture, c).tobytes() == getattr(written, c).tobytes()
                    for c in ("time", "rlat", "rlon")},
                 **{v: fixture.data_vars[v].tobytes() == written.data_vars[v].tobytes() for v in written.data_vars
                    if v in fixture.data_vars}}
        rec["observation_fixtures"][path.name] = {
            "bits_equal": all(equal.values()), "unequal": [k for k, v in equal.items() if not v],
            "value_max_diff": max(float(np.abs(fixture.data_vars[v] - written.data_vars[v]).max())
                                  for v in written.data_vars if v in fixture.data_vars)}
    if not all(r["bits_equal"] for r in rec["observation_fixtures"].values()):
        raise AssertionError(f"an observation fixture is not phase 6's observation: {rec}")
    paths["obs"] = str(fixtures[-1])
    return rec


def phase7_tiny_training(device, seed=0, steps=4) -> dict:
    """The canonical training drive through the command line: ``python -m
    climate2weather_tpu_torch.train`` with ``configs/tiny_unet.yml`` at
    32 x 32 (attention over 16 x 16 = 256 tokens, forward and backward), from a
    ``train.h5`` the port's writer made, for ``steps`` steps of 64 in two
    microbatches, after the command's step-0 validation sampling. Every
    logged loss must be finite, and each attention launch of the first
    training step must agree with the plain version (one bf16 ulp)."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch import train
    from climate2weather_tpu_torch.ops import attention

    t0 = time.time()
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-tiny-"))
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = attention.attention_fwd, attention.attention_bwd
    batch_gpu, per_step = 32, 2 * 2  # two attention blocks x two microbatches
    # the step-0 validation: the PC sampler, 100 steps on one window, through
    # both attention blocks (forward only)
    valid_fwd = 2 * 100

    def rec_fwd(q, k, v):
        out = real_fwd(q, k, v)
        if q.shape[0] == batch_gpu and len(calls["fwd"]) < per_step:  # a training microbatch
            calls["fwd"].append((q.detach(), k.detach(), v.detach(), out))
        return out

    def rec_bwd(q, k, v, do):
        out = real_bwd(q, k, v, do)
        if len(calls["bwd"]) < per_step:
            calls["bwd"].append((q.detach(), k.detach(), v.detach(), do.detach(), out))
        return out

    try:
        write_training_h5(root / "train.h5", synthetic_inputs(64, 32, 32, 4, 1, seed)[0])
        ndata = str(64 * steps)
        argv = ["--run-dir", str(root / "runs"), "--run-id", "tiny", "--train-data", str(root / "train.h5"),
                "--spatial-res", "32", "--num-features", "4", "--markov-order", "2",
                "--model-config", str(REPO / "configs" / "tiny_unet.yml"), "--lr", "1e-3",
                "--total-ndata", ndata, "--batch", "64", "--batch-gpu", str(batch_gpu), "--status", "64",
                "--snapshot", "1024", "--checkpoint", "1024", "--logging", "64", "--seed", str(seed),
                "--device", device.type]
        for k in attention.launch_counts:
            attention.launch_counts[k] = 0
        attention.attention_fwd, attention.attention_bwd = rec_fwd, rec_bwd
        try:
            train.main(argv)
        finally:
            attention.attention_fwd, attention.attention_bwd = real_fwd, real_bwd
        launches = dict(attention.launch_counts)
        lines = (root / "runs" / "tiny" / "metrics.jsonl").read_text().splitlines()
        losses = [json.loads(ln)["train/loss"] for ln in lines if "train/loss" in json.loads(ln)]
        per_launch = []
        with torch.no_grad():
            for q, k, v, out in calls["fwd"]:
                want = attention.attention_reference(q, k, v).float()
                per_launch.append({"kernel": "fwd", "tokens": q.shape[1], "max_abs_err": [
                    float((out.float() - want).abs().max())], "tol": [bf16_ulp(float(want.abs().max()))]})
            for q, k, v, do, out in calls["bwd"]:
                errs, scales = _grads_err(out, attention.attention_bwd_reference(q, k, v, do))
                per_launch.append({"kernel": "bwd", "tokens": q.shape[1], "max_abs_err": errs,
                                   "tol": _bwd_tols(scales, q.dtype)})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cuda = device.type == "cuda"
    result = {"steps": steps, "losses": losses, "launches": launches, "per_launch": per_launch}
    emit(7, t0, **result)
    if len(losses) != steps or not all(x is not None and np.isfinite(x) for x in losses):
        raise AssertionError(f"the tiny drive's losses are missing or not finite: {losses}")
    want_bwd = per_step * steps if cuda else 0
    want_fwd = want_bwd + valid_fwd if cuda else 0
    if launches.get("attention_fwd") != want_fwd or launches.get("attention_bwd") != want_bwd:
        raise AssertionError(f"tiny drive launches {launches}, want fwd {want_fwd} bwd {want_bwd}")
    if len(per_launch) != 2 * per_step or any(q_tok != 256 for q_tok in (c["tokens"] for c in per_launch)) or any(
            any(e > tl for e, tl in zip(c["max_abs_err"], c["tol"])) for c in per_launch):
        raise AssertionError(f"an attention launch of the tiny drive disagrees: {per_launch}")
    return result


YEAR_CONFIG = REPO / "exp" / "configs" / "001_clim-downscaling" / "year2014_meso128_winning.yml"
YEAR_HOURS = 523  # 6 * 87 + 1: above the long path's threshold of 512 frames
YEAR_STEPS = 32  # 8a's steps, cut from the config's 64: 4 calls of 8, a resume file after the second
BF16_HOURS = 4003  # above the 4000 frames where DPM-Solver++(2M)'s trajectory goes bf16
FULL_YEAR_HOURS = 8737
# trajectory-sized buffers live at the peak of a DPM-Solver++(2M) step on the
# long path, counted from the code: the initial noise and the zero previous
# x0 (held by the sampler's initial state), the state's x and previous x0,
# and the step's eps and two outputs
TRAJECTORY_BUFFERS = 7


class Crash(Exception):
    """Raised by phase 8b's scorer to stop a run as a killed process stops."""


def _year_config(snapshot_dir, paths, hours, overrides=None) -> dict:
    """``year2014_meso128_winning.yml`` on the phase's files, cut to
    ``hours`` hours and one sample; ``overrides`` cut it further."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    cfg = yaml_load_file(YEAR_CONFIG)
    cfg.update(model_path=str(snapshot_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], spectral_calibrate=paths["train"], num_hours=hours,
               num_samples=1, **(overrides or {}))
    return cfg


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase8a_predict(root, snapshot_dir, device, res, hours, seed, overrides) -> dict:
    """``exp/downscaling.run`` on the year config cut to ``hours`` hours and
    one sample, from files the port wrote, h5py unimportable: the long path
    taken, a finite sample, A(x) = y at the observed frames, the resume file
    written every ``sample_resume_every`` calls of 8 steps and removed, the
    attention launches 6 per UNet forward; sampling, I/O and peak memory."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts
    from climate2weather_tpu_torch.utils import trace

    t0 = time.time()
    paths = write_predict_inputs(root, res, hours, seed, start="2014-01-01T00")
    inputs_written_s = time.time() - t0
    cfg = _year_config(snapshot_dir, paths, hours, overrides)
    config_path = root / "year.yml"
    yaml_dump_file(cfg, config_path)
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    stats = {}
    trace.reset()
    trace.enable()  # the resume files the long sampler wrote, by its own spans and counters (utils/trace.py)
    try:
        _peak_reset(device)
        for k in launch_counts:
            launch_counts[k] = 0
        t_run = time.time()
        out_dir = downscaling.run(str(root / "out"), str(config_path), device=device, stats=stats)
        peak = _peak(device)
        run_s = time.time() - t_run
        launches = launch_counts["attention_fwd"]
    finally:
        trace.disable()
    saves = [r.attrs["step"] for r in trace.records() if r.name == "c2w.sample.resume_save"]
    counted, saved_bytes = (trace.counters().get(k, 0) for k in ("resume_saves", "resume_bytes"))
    trace.reset()
    forwards = _expected_forwards({**cfg, "ensemble_batch": 1}, hours, window)
    per_call = min(hours - window + 1, int(cfg["batch_size"]))
    steps, every = int(cfg["num_sampling_steps"]), int(cfg["sample_resume_every"])
    calls = -(-steps // 8)
    sample = open_grid(str(out_dir / "gen_sample_000.nc"))
    consistency, tol = _written_consistency(out_dir, [sample], cfg, paths["quantiles"])
    rec = {
        "hours": hours, "res": res, "steps": steps, "long_path": stats["long_path"],
        "traj_dtype": stats["traj_dtype"], "finite": all(bool(np.isfinite(v).all()) for v in sample.data_vars.values()),
        "A_x_minus_y_max": consistency, "A_tol": tol,
        "resume_saves_at_step": saves, "resume_bytes": saved_bytes,
        "expected_saves": [8 * c for c in range(1, calls) if c % every == 0],
        "left_in_dir": sorted(p.name for p in out_dir.iterdir()),
        "attention_launches": launches, "unet_forwards": forwards,
        "expected_launches": _attention_blocks(snap_cfg["network_kwargs"]) * forwards if device.type == "cuda" else 0,
        "window_evals": forwards * per_call, "sampling_s": stats["sampling_s"],
        "window_evals_per_s": forwards * per_call / stats["sampling_s"],
        "input_s": stats["input_s"], "write_s": stats["write_s"], "io_s": stats["input_s"] + stats["write_s"],
        "load_net_s": stats["load_net_s"], "run_s": run_s, "inputs_written_s": inputs_written_s,
        "max_memory_allocated": peak,
    }
    emit("8a", t0, **rec)
    if not rec["long_path"] or not rec["finite"]:
        raise AssertionError(f"the year run did not take the long path or wrote non-finite values: {rec}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y in the year sample: {rec}")
    if saves != rec["expected_saves"] or counted != len(saves) or (saves and not saved_bytes) or any(n.startswith(".sample_resume") for n in rec["left_in_dir"]):
        raise AssertionError(f"resume files not written as configured or left behind: {rec}")
    if launches != rec["expected_launches"]:
        raise AssertionError(f"attention launches {launches} != 6 per UNet forward: {rec}")
    return {**rec, "out_dir": out_dir, "paths": paths, "cfg": cfg}


def phase8b_resume(root, net, snap_cfg, cfg, gt, device, steps=16, seed=0, order=2, label="8b") -> dict:
    """``sample_dpmpp2m_long`` at the config's guidance and SDE eta (at
    ``order=3``, DPM-Solver++(3M), without the SDE form) on ``gt``'s length
    for ``steps`` steps in calls of 8, a resume file after every call: twice
    uninterrupted, then crashed in its second call and resumed from the
    file. The resumed run must equal the uninterrupted one bit for bit, or,
    where two uninterrupted runs already differ, lie within their spread; the
    resumed run makes only the remaining calls."""
    from climate2weather_tpu_torch.diffusion import long_sampler
    from climate2weather_tpu_torch.diffusion.guidance import (
        GaussianGuidance,
        SpatioTemporalCoarsening,
        per_channel,
    )
    from climate2weather_tpu_torch.diffusion.process import construct_process
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

    t0 = time.time()
    L, H, W, C = gt.shape
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    guidance = GaussianGuidance(A=A, y=A(torch.from_numpy(gt).to(device)),
                                std=per_channel(cfg["likelihood_std"], C, device),
                                gamma=per_channel(cfg["likelihood_gamma"], C, device))
    forwards, crash = [], {"at": None}

    def eps_fn(windows, t):
        if len(forwards) == crash["at"]:
            raise Crash
        forwards.append(t)
        return net(windows, t)

    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    score = WindowScoreFn(eps_fn, window // 2, chunk_size=int(cfg["batch_size"]))
    chunks = -(-(L - window + 1) // min(L - window + 1, int(cfg["batch_size"])))
    path = str(root / ".sample_resume_000.npz")

    def sample(resume_path):
        forwards.clear()
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((L, H, W, C), generator=gen, device=device)
        out, nan = long_sampler.sample_dpmpp2m_long(
            construct_process(**snap_cfg["pipeline_kwargs"]), score, x, guidance=guidance, steps=steps,
            rng=gen, sde_eta=float(cfg["sde_eta"]) if order == 2 else 0.0, order=order, steps_per_call=8,
            resume_path=resume_path, resume_every=1)
        return out, bool(nan)

    first, nan1 = sample(None)
    second, nan2 = sample(None)
    crash["at"] = 8 * chunks  # the first network call of the second call
    try:
        sample(path)
        raise AssertionError("the crashing run did not crash")
    except Crash:
        pass
    with np.load(path) as f:
        saved_step = int(f["step"])
        carry = sorted(str(name) for name in f["names"])
    crash["at"] = None
    resumed, nan3 = sample(path)
    resumed_forwards = len(forwards)
    spread = float((first.float() - second.float()).abs().max())
    err = float((resumed.float() - first.float()).abs().max())
    rec = {"L": L, "order": order, "steps": steps, "window_chunks": chunks, "saved_step": saved_step,
           "resumed_forwards": resumed_forwards, "expected_forwards": (steps - 8) * chunks,
           "uninterrupted_equal": bool(torch.equal(first, second)), "uninterrupted_max_abs_diff": spread,
           "resumed_equal": bool(torch.equal(resumed, first)), "resumed_max_abs_diff": err,
           "finite": not (nan1 or nan2 or nan3), "file_left": os.path.exists(path), "carry": carry}
    emit(label, t0, **rec)
    if not rec["finite"] or saved_step != 8 or rec["file_left"]:
        raise AssertionError(f"the resume file was not written after the first call or not removed: {rec}")
    if order == 3 and not {"prev2_x0", "prev2_h"} <= set(carry):
        raise AssertionError(f"the order-3 resume file lacks the second-previous carry: {rec}")
    if resumed_forwards != rec["expected_forwards"]:
        raise AssertionError(f"the resumed run did not make only the remaining calls: {rec}")
    if not rec["resumed_equal"] and (rec["uninterrupted_equal"] or err > spread):
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {rec}")
    return rec


def phase8c_bf16(net, snap_cfg, cfg, gt, calib, device) -> dict:
    """``sample_arrays`` on a trajectory above 4000 frames at the config's
    settings for 2 steps and the final denoise: the trajectory in bf16, a
    finite sample, A(x) = y within bf16 rounding after the chunked
    calibration and projection; peak memory, and the peak reckoned for a
    year from it."""
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
    from climate2weather_tpu_torch.exp.downscaling import sample_arrays
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    L, H, W, C = gt.shape
    cfg = {**cfg, "num_sampling_steps": 2, "num_hours": L}
    stats = {}
    _peak_reset(device)
    for k in launch_counts:
        launch_counts[k] = 0
    t_sample = time.time()
    samples, nan = sample_arrays(net, snap_cfg, cfg, gt, calib_frames=calib, device=device, stats=stats)
    peak = _peak(device)
    sampling_s = time.time() - t_sample
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    forwards = _expected_forwards({**cfg, "ensemble_batch": 1}, L, window)
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    consistency, tol = _consistency(A, [torch.from_numpy(samples[0])], A(torch.from_numpy(gt)), bf16=True)
    frame_bytes = 2 * H * W * C
    rec = {"L": L, "long_path": stats["long_path"], "traj_dtype": stats["traj_dtype"],
           "finite": bool(np.isfinite(samples).all()) and not nan.any(),
           "A_x_minus_y_max": consistency, "A_tol": tol, "sampling_s": sampling_s,
           "attention_launches": launch_counts["attention_fwd"],
           "expected_launches": _attention_blocks(snap_cfg["network_kwargs"]) * forwards
           if device.type == "cuda" else 0,
           "max_memory_allocated": peak,
           "reckoned_peak_full_year": None if peak is None else
           peak + TRAJECTORY_BUFFERS * frame_bytes * (FULL_YEAR_HOURS - L)}
    emit("8c", t0, **rec)
    if rec["traj_dtype"] != "torch.bfloat16" or not rec["long_path"] or not rec["finite"]:
        raise AssertionError(f"the trajectory above 4000 frames is not a finite bf16 long-path run: {rec}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y beyond bf16 rounding: {rec}")
    if rec["attention_launches"] != rec["expected_launches"]:
        raise AssertionError(f"attention launches {rec['attention_launches']} != 6 per UNet forward: {rec}")
    return rec


def phase8d_metrics(out_dir, label="8d") -> dict:
    """``metrics run`` on 8a's directory (h5py unimportable): every score
    finite. Its line is ``label``'s."""
    from climate2weather_tpu_torch.exp import metrics

    t0 = time.time()
    scores = metrics.run(str(out_dir))
    values = [np.asarray(v) for kind, by_var in scores.items() if kind != "protocol"
              for entries in by_var.values() for v in entries.values()]
    rec = {"scores": len(values), "finite": all(bool(np.isfinite(v).all()) for v in values),
           "protocol": scores["protocol"], "metrics_s": time.time() - t0}
    emit(label, t0, **rec)
    if not values or not rec["finite"]:
        raise AssertionError(f"metrics of the run missing or not finite: {rec}")
    return rec


def phase8_year(snapshot_dir, device, res=128, hours=YEAR_HOURS, bf16_hours=BF16_HOURS, seed=0,
                overrides=None, resume_steps=16) -> dict:
    """The year path, 8a-8d (see the module docstring), in one scratch
    directory; ``overrides`` cut the year config further. Returns the
    attention launches of 8a's run and each part's record."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.exp.downscaling import load_net

    sys.modules["h5py"] = None  # the port reads and writes HDF5 without it
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-year-"))
    try:
        a = phase8a_predict(root, snapshot_dir, device, res, hours, seed,
                            {"num_sampling_steps": YEAR_STEPS, **(overrides or {})})
        gt = _normed(open_grid(str(a["out_dir"] / "ground_truth.nc")), a["cfg"], a["paths"]["quantiles"])
        net, snap_cfg = load_net(str(snapshot_dir), device)
        b = phase8b_resume(root, net, snap_cfg, a["cfg"], gt, device, steps=resume_steps, seed=seed)
        # a longer trajectory: the year's hours there and back again
        reps = -(-bf16_hours // hours)
        long_gt = np.concatenate([gt if i % 2 == 0 else gt[::-1] for i in range(reps)])[:bf16_hours]
        c = phase8c_bf16(net, snap_cfg, a["cfg"], np.ascontiguousarray(long_gt), a["paths"]["train"], device)
        del net
        d = phase8d_metrics(a["out_dir"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a = {k: v for k, v in a.items() if k not in ("out_dir", "paths", "cfg")}
    return {"launches": a["attention_launches"], "8a": a, "8b": b, "8c": c, "8d": d}


# phase 9: exact-gradient guidance, DPM-Solver++(3M), the bilinear
# prolongation, the likelihood sweep and the fidelity harness
EXACT_STEPS = 8
# the gradient check's trajectory: 22 frames are 10 windows of 13, in chunks
# of 8 ([0, 8) and [2, 10)); window 6, centred on the observed frame 12, is
# written by both, so a doubly counted overwrite shows in the gradient
GRAD_FRAMES, GRAD_CHUNK, GRAD_T = 22, 8, 0.5
GRAD_STEPS = (0.04, 0.02, 0.01)  # central-difference steps along v, largest first
PREDICT9_RUNS = (
    ("dpmpp3m", "s16_t6_spectral.yml",
     {"num_samples": 3, "sampler_kind": "dpmpp3m", "sde_eta": 0.0, "num_sampling_steps": 16}),
    ("bilinear", "s16_t6_spectral.yml",
     {"num_samples": 3, "guidance_prolong": "bilinear", "num_sampling_steps": 8}),
)


def _exact_launches(n_attn, evals, chunks, windows_per_chunk, device) -> tuple:
    """Expected (forward, backward) attention launches of exact guidance:
    per evaluation and window chunk one forward with no graph, then per
    sub-batch of the VJP one forward under grad and one backward."""
    from climate2weather_tpu_torch.diffusion import window

    if device.type != "cuda":
        return 0, 0
    subs = -(-windows_per_chunk // window.VJP_WINDOWS)
    return n_attn * evals * chunks * (1 + subs), n_attn * evals * chunks * subs


def phase9a_exact(snapshot_dir, device, L=49, res=128, n_train=64, seed=0, overrides=None) -> dict:
    """``run_arrays`` (as its two steps ``load_net`` and ``sample_arrays``)
    at ``s16_t6_spectral.yml`` with ``use_exact_grad: true``, 3 samples in
    one group and ``EXACT_STEPS`` steps: finite samples, A(x) = y, the
    attention launches of both passes, and every backward launch of the
    first evaluation against the plain version within phase 5's limit."""
    from climate2weather_tpu_torch.exp.downscaling import load_net, sample_arrays
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
    from climate2weather_tpu_torch.ops import attention

    t0 = time.time()
    cfg = yaml_load_file(CONFIG)
    cfg.update({"num_samples": 3, "use_exact_grad": True, "num_sampling_steps": EXACT_STEPS, **(overrides or {})})
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    C = int(snap_cfg["dataset_kwargs"]["train"]["num_features"])
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    n_attn = _attention_blocks(snap_cfg["network_kwargs"])
    gt, train = synthetic_inputs(L, res, res, C, n_train, seed)
    net, snap_cfg = load_net(str(snapshot_dir), device)
    n_win = L - window + 1
    per_call = min(n_win, int(cfg["batch_size"]))
    chunks = -(-n_win // per_call)
    members = min(int(cfg["num_samples"]), int(cfg["ensemble_batch"]))
    evals = int(cfg["num_sampling_steps"]) + int(bool(cfg.get("denoise_final", False)))
    want_fwd, want_bwd = _exact_launches(n_attn, evals, chunks, members * per_call, device)
    norm_fwd, norm_bwd = _exact_launches(_norms_per_forward(snap_cfg["network_kwargs"]), evals, chunks,
                                         members * per_call, device)
    want_norm = {"channel_norm_fwd": norm_fwd, "channel_norm_bwd": norm_bwd}
    plain_bwd, bwd_calls = attention.attention_bwd, []
    first_eval = want_bwd // evals

    def recorded_bwd(q, k, v, do):
        out = plain_bwd(q, k, v, do)
        if len(bwd_calls) < first_eval:
            bwd_calls.append((q, k, v, do.detach(), out))
        return out

    for k in attention.launch_counts:
        attention.launch_counts[k] = 0
    _reset_norm_counts()
    _peak_reset(device)
    attention.attention_bwd = recorded_bwd
    try:
        t_sample = time.time()
        samples, nan_flags = sample_arrays(net, snap_cfg, cfg, gt, calib_frames=train, device=device)
        sampling_s = time.time() - t_sample  # sample_arrays ends in a copy to the host
    finally:
        attention.attention_bwd = plain_bwd
    peak = _peak(device)
    launches = dict(attention.launch_counts)
    norm_launches = _norm_counts()
    per_launch = []
    with torch.no_grad():
        for q, k, v, do, got in bwd_calls:
            want = attention.attention_bwd_reference(q, k, v, do)
            errs, scales = _grads_err(got, want)
            fault, _ = _grads_err(_rowsum_dropped(q, k, v, do), want)
            per_launch.append({"shape": list(q.shape), "max_abs_err": errs, "tol": _bwd_tols(scales, q.dtype),
                               "rowsum_dropped_err": fault[:2]})
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    consistency, tol = _consistency(A, [torch.from_numpy(samples)], A(torch.from_numpy(gt)))
    window_evals = members * evals * chunks * per_call
    rec = {"samples_shape": list(samples.shape), "finite": bool(np.isfinite(samples).all()) and not nan_flags.any(),
           "A_x_minus_y_max": consistency, "A_tol": tol, "steps": int(cfg["num_sampling_steps"]),
           "attention_launches": launches, "expected_launches": {"attention_fwd": want_fwd,
                                                                 "attention_bwd": want_bwd},
           "norm_launches": norm_launches, "expected_norm_launches": want_norm,
           "bwd_checked": len(per_launch), "bwd_per_launch": per_launch, "sampling_s": sampling_s,
           "window_evals": window_evals, "window_evals_per_s": window_evals / sampling_s,
           "max_memory_allocated": peak}
    emit("9a", t0, **rec)
    if not rec["finite"]:
        raise AssertionError(f"exact guidance gave non-finite samples: {rec}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y after exact guidance: {rec}")
    if launches.get("attention_fwd", 0) != want_fwd or launches.get("attention_bwd", 0) != want_bwd:
        raise AssertionError(f"attention launches {launches} != {rec['expected_launches']}")
    if norm_launches != want_norm:
        raise AssertionError(f"channel-norm launches {norm_launches} != {want_norm}")
    if len(per_launch) != first_eval:
        raise AssertionError(f"{len(per_launch)} backward launches recorded, want {first_eval}")
    for one in per_launch:
        if any(e > tl for e, tl in zip(one["max_abs_err"], one["tol"])):
            raise AssertionError(f"an attention backward launch of exact guidance disagrees: {one}")
        if any(f <= tl for f, tl in zip(one["rowsum_dropped_err"], one["tol"])):
            raise AssertionError(f"the per-launch check cannot see a dropped row sum: {one}")
    return {"launches": launches, **rec}


def phase9a_gradient(snapshot_dir, device, res=128, seed=0, frames=GRAD_FRAMES, chunk=GRAD_CHUNK) -> dict:
    """The exact gradient at full width in fp32: the 72.1M snapshot in fp32
    on a trajectory of ``frames`` frames in window chunks of ``chunk`` (the
    last shifted back), at t = ``GRAD_T`` with the config's likelihood, and
    <grad log p, v> for a random direction v against the central difference
    of log p at the steps ``GRAD_STEPS``. The control is the central
    difference itself: the limit is 3x the most it moves between two of its
    steps. The gradient must meet the limit, and the planted fault, the
    cotangent of the windows the shifted last chunk overwrites counted
    twice, must exceed it."""
    from climate2weather_tpu_torch.diffusion import window as window_mod
    from climate2weather_tpu_torch.diffusion.guidance import (
        GaussianGuidance,
        SpatioTemporalCoarsening,
        per_channel,
    )
    from climate2weather_tpu_torch.diffusion.process import construct_process
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    t0 = time.time()
    cfg = yaml_load_file(CONFIG)
    net, snap_cfg = load_net(str(snapshot_dir), device, compute_dtype=torch.float32)
    C = int(snap_cfg["dataset_kwargs"]["train"]["num_features"])
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    process = construct_process(**snap_cfg["pipeline_kwargs"])
    gt, _ = synthetic_inputs(frames, res, res, C, 1, seed)
    gt = torch.from_numpy(gt).to(device)
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    guide = GaussianGuidance(A=A, y=A(gt), std=per_channel(cfg["likelihood_std"], C, device),
                             gamma=per_channel(cfg["likelihood_gamma"], C, device), exact_grad=True)
    score = window_mod.WindowScoreFn(net, window // 2, chunk_size=chunk)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    mu, sigma = float(process.mu(GRAD_T)), float(process.sigma(GRAD_T))
    x = mu * gt + sigma * torch.randn(gt.shape, generator=g, device=device)
    v = torch.randn(gt.shape, generator=g, device=device)
    var = (guide.std.double() ** 2 + guide.gamma.double() * (sigma / mu) ** 2)

    def log_p(xx):
        x0 = process.denoise(xx, GRAD_T, score(xx, GRAD_T))
        return float(-((guide.y.double() - A(x0).double()) ** 2 / var).sum() / 2)

    def directional():
        _, grad = guide.eps_and_grad(score, process, x, GRAD_T)
        return float((grad.double() * v.double()).sum())

    with torch.no_grad():
        got = directional()
        real_owned = window_mod.owned_windows
        window_mod.owned_windows = lambda ci, n_chunks, B, n: B  # every centre back-propagated
        try:
            fault = directional()
        finally:
            window_mod.owned_windows = real_owned
        fds = [(log_p(x + h * v) - log_p(x - h * v)) / (2 * h) for h in GRAD_STEPS]
    spread = max(abs(a - b) for a, b in zip(fds, fds[1:]))
    limit = 3 * spread
    rec = {"frames": frames, "windows": frames - window + 1, "chunk": chunk, "t": GRAD_T,
           "steps": list(GRAD_STEPS), "central_differences": fds, "directional": got,
           "err": abs(got - fds[-1]), "rel_err": abs(got - fds[-1]) / abs(fds[-1]), "control_spread": spread,
           "limit": limit, "double_count_directional": fault, "double_count_err": abs(fault - fds[-1])}
    emit("9a_gradient", t0, **rec)
    if not all(np.isfinite([got, fault, *fds])):
        raise AssertionError(f"non-finite gradient check: {rec}")
    if rec["err"] > limit:
        raise AssertionError(f"the exact gradient disagrees with the central difference: {rec}")
    if rec["double_count_err"] <= limit:
        raise AssertionError(f"the gradient check cannot see the overwritten windows counted twice: {rec}")
    return rec


def phase9c_long(root, snapshot_dir, device, res=128, hours=YEAR_HOURS, seed=0, resume_steps=16,
                 overrides=None) -> dict:
    """The year path at ``hours`` frames on the year config: DPM-Solver++(3M)
    crashed in its second call and resumed (phase 8b at ``order=3``), then
    ``sample_arrays`` with exact guidance for 1 step and the final denoise
    at the config's chunks of 128 windows: finite, A(x) = y, the attention
    launches of both passes, peak memory."""
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
    from climate2weather_tpu_torch.exp.downscaling import load_net, sample_arrays
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    C = int(snap_cfg["dataset_kwargs"]["train"]["num_features"])
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    gt, train = synthetic_inputs(hours, res, res, C, 16, seed)
    cfg = yaml_load_file(YEAR_CONFIG)
    cfg.update(num_hours=hours, num_samples=1, **(overrides or {}))
    net, snap_cfg = load_net(str(snapshot_dir), device)
    resume = phase8b_resume(root, net, snap_cfg, cfg, gt, device, steps=resume_steps, seed=seed, order=3,
                            label="9c_resume")
    cfg.update(use_exact_grad=True, num_sampling_steps=1)
    n_win = hours - window + 1
    per_call = min(n_win, int(cfg["batch_size"]))
    chunks = -(-n_win // per_call)
    want_fwd, want_bwd = _exact_launches(_attention_blocks(snap_cfg["network_kwargs"]), 2, chunks, per_call,
                                         device)
    for k in launch_counts:
        launch_counts[k] = 0
    _peak_reset(device)
    stats = {}
    t_sample = time.time()
    samples, nan = sample_arrays(net, snap_cfg, cfg, gt, calib_frames=train, device=device, stats=stats)
    sampling_s = time.time() - t_sample
    peak = _peak(device)
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    consistency, tol = _consistency(A, [torch.from_numpy(samples[0])], A(torch.from_numpy(gt)))
    rec = {"L": hours, "long_path": stats["long_path"], "window_chunks": chunks, "windows_per_chunk": per_call,
           "finite": bool(np.isfinite(samples).all()) and not nan.any(),
           "A_x_minus_y_max": consistency, "A_tol": tol, "sampling_s": sampling_s,
           "attention_launches": dict(launch_counts),
           "expected_launches": {"attention_fwd": want_fwd, "attention_bwd": want_bwd},
           "max_memory_allocated": peak}
    emit("9c_exact", t0, **rec)
    if not rec["long_path"] or not rec["finite"]:
        raise AssertionError(f"exact guidance on the long path: not taken or not finite: {rec}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y after exact guidance on the long path: {rec}")
    if rec["attention_launches"] != rec["expected_launches"]:
        raise AssertionError(f"attention launches of the long exact path: {rec}")
    return {"resume": resume, **rec}


def phase9d_sweep(root, paths, snapshot_dir, device, steps=EXACT_STEPS) -> dict:
    """``python -m climate2weather_tpu_torch.experiment hparam-sweep`` (its
    ``main``, in this process) with 2 trials on the phase's files,
    ``s16_t6_spectral.yml`` cut to ``steps`` steps: two numbered directories
    of 10 finite samples each, and the trials' (sigma, gamma) as printed."""
    import contextlib
    import io
    import re

    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file

    t0 = time.time()
    cfg = yaml_load_file(PREDICT_CONFIGS / "s16_t6_spectral.yml")
    cfg.update(model_path=str(snapshot_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], spectral_calibrate=paths["train"], num_sampling_steps=steps)
    config_path = root / "sweep.yml"
    yaml_dump_file(cfg, config_path)
    printed = io.StringIO()
    args = ["hparam-sweep", "--save-path", str(root / "sweep"), "--config-path", str(config_path), "--trials", "2"]
    if device.type != "cuda":
        args += ["--device", "cpu"]
    with contextlib.redirect_stdout(printed):
        code = experiment.main(args)
    text = printed.getvalue()
    trials = re.findall(r"^Trial (\d+): sigma = (.*), gamma = (.*)$", text, flags=re.M)
    dirs = sorted(p.name for p in (root / "sweep").iterdir())
    finite = [all(bool(np.isfinite(vals).all()) for i in range(10)
                  for vals in open_grid(str(root / "sweep" / d / f"gen_sample_{i:03d}.nc")).data_vars.values())
              for d in dirs]
    rec = {"exit_code": code, "trials": [{"trial": int(n), "sigma": sg, "gamma": float(gm)} for n, sg, gm in trials],
           "dirs": dirs, "finite": finite, "failed": "FAILED" in text}
    emit("9d", t0, **rec)
    if code != 0 or rec["failed"] or len(trials) != 2 or dirs != ["001_sweep", "002_sweep"] or not all(finite):
        raise AssertionError(f"the sweep did not give two trials of finite samples: {rec}\n{text[-2000:]}")
    return rec


def phase9e_fidelity(root, paths, snapshot_dir, device, steps=EXACT_STEPS, guided=3, uncond=8) -> dict:
    """``exp/fidelity.run`` with ``skip_figures`` on the phase's files:
    ``guided`` guided and ``uncond`` unconditional samples of ``steps``
    steps, their metrics and ``FIDELITY.md``, every score finite."""
    from climate2weather_tpu_torch.exp import fidelity

    t0 = time.time()
    out = fidelity.run(str(snapshot_dir), paths["data"], paths["quantiles"], str(root / "fidelity"),
                       "2014-04-07-04", num_samples=guided, uncond_samples=uncond, num_sampling_steps=steps,
                       skip_figures=True, device=device)
    report = root / "fidelity" / "FIDELITY.md"
    values = [np.asarray(val) for side in ("guided", "uncond") for kind, by_var in out[side].items()
              if kind != "protocol" for entries in by_var.values() for val in entries.values()]
    rows = [ln for ln in report.read_text().splitlines() if ln.startswith("| ") and "metric" not in ln] \
        if report.exists() else []
    rec = {"report": report.exists(), "rows": len(rows), "scores": len(values),
           "finite": bool(values) and all(bool(np.isfinite(val).all()) for val in values),
           "guided_samples": guided, "uncond_samples": uncond, "steps": steps}
    emit("9e", t0, **rec)
    if not rec["report"] or not rows or not rec["finite"]:
        raise AssertionError(f"FIDELITY.md missing or scores not finite: {rec}")
    return rec


def phase9_modes(snapshot_dir, device, res=128, hours=49, long_hours=YEAR_HOURS, seed=0, overrides=None,
                 long_overrides=None, resume_steps=16) -> dict:
    """Phase 9, 9a-9e (see the module docstring), h5py unimportable, in one
    scratch directory; ``overrides`` cut 9a's and 9b's config (the tests' CPU
    rehearsal), ``long_overrides`` 9c's. Returns each part's record."""
    import shutil
    import tempfile

    sys.modules["h5py"] = None  # the port reads and writes HDF5 without it
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-modes-"))
    try:
        a = phase9a_exact(snapshot_dir, device, L=hours, res=res, seed=seed, overrides=overrides)
        grad = phase9a_gradient(snapshot_dir, device, res=res, seed=seed)
        t0 = time.time()
        paths = write_predict_inputs(root, res, hours, seed)
        runs = [(name, base, {**over, **(overrides or {})}) for name, base, over in PREDICT9_RUNS]
        b = _predict_runs(root, paths, snapshot_dir, device, runs, hours)
        emit("9b", t0, runs=b)
        c = phase9c_long(root, snapshot_dir, device, res=res, hours=long_hours, seed=seed,
                         resume_steps=resume_steps, overrides=long_overrides)
        d = phase9d_sweep(root, paths, snapshot_dir, device)
        e = phase9e_fidelity(root, paths, snapshot_dir, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"9a": a, "9a_gradient": grad, "9b": b, "9c": c, "9d": d, "9e": e}


# ---------------------------------------------------------------------------
# phase 10: multi-process training and sample-striped predict over
# torch.distributed, and the restart supervisor. Every sub-phase launches
# real processes (the port's command lines, or this script's ``--child``
# harness around them), each under a wall-clock limit.

CHILD_PREFIX = "CHILD_RESULT "
CHILD_TIMEOUT = 300.0  # seconds, for each process phase 10 starts


def _child_env(device, rank=None, world=None, port=None) -> dict:
    """The environment of a child: this one without torchrun's variables,
    unbuffered; with ``rank``, a rank of ``world`` on the first card (or the
    CPU), its rendezvous at ``port`` on this host."""
    from climate2weather_tpu_torch.parallel import mesh

    env = {k: v for k, v in os.environ.items() if k not in mesh.LAUNCH_ENV}
    env.update(PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])))
    if device.type == "cuda":
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    else:  # two ranks share the CPU's cores; every run takes as many
        env["OMP_NUM_THREADS"] = str(max(1, torch.get_num_threads() // 2))
    if rank is not None:
        # every rank sees the one card as its cuda:0 (NCCL refuses two ranks
        # on one card, so several take gloo)
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(cmds, envs, timeout=CHILD_TIMEOUT, label="", beside=None) -> tuple:
    """Run the commands together to their end; each must exit 0 within
    ``timeout`` seconds. A failing one ends the rest at once (a rank that
    raised must not leave its peers waiting). ``beside``, a callable, runs
    in this process meanwhile (what it raises ends them too). Returns
    (outputs, seconds, each process's seconds to its first ``Status:`` line
    or None)."""
    import signal

    t0 = time.time()
    procs = [subprocess.Popen(cmd, env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True) for cmd, env in zip(cmds, envs)]
    outs = [[] for _ in procs]
    readers = [_pump(p.stdout, out) for p, out in zip(procs, outs)]
    deadline = time.monotonic() + timeout
    try:
        if beside is not None:
            beside()
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        for r in readers:
            r.join(timeout=10)
    seconds = time.time() - t0
    texts = ["".join(line for _, line in o) for o in outs]
    firsts = [next((at - t0 for at, line in o if "Status:" in line), None) for o in outs]
    for i, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise AssertionError(f"phase {label} process {i} exited {p.returncode} after {seconds:.1f} s:\n"
                                 f"{text[-6000:]}")
    return texts, seconds, firsts


def _pump(stream, sink: list):
    """A thread that copies ``stream``'s lines into ``sink`` with the time
    each arrived."""
    import threading

    def run():
        for line in iter(stream.readline, ""):
            sink.append((time.time(), line))
        stream.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _child_result(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith(CHILD_PREFIX)]
    if len(lines) != 1:
        raise AssertionError(f"a child printed {len(lines)} results:\n{text[-4000:]}")
    return json.loads(lines[0][len(CHILD_PREFIX):])


def _step_ms(text: str, batch: int) -> list:
    """Milliseconds a step from the ``Status:`` lines (sec/kdata x batch),
    the first tick (the run's set-up) left out."""
    ms = [float(part.split()[0]) * batch for line in text.splitlines() if "Status:" in line
          for part in line.split(" +++ ") if part.strip().endswith("sec/kdata")]
    return ms[1:]


def _train_argv(run_dir, data_path, model_config, res, batch, batch_gpu, total, seed, device,
                backend=None, snapshot=1024) -> list:
    argv = ["--run-dir", str(run_dir), "--run-id", "r", "--train-data", str(data_path),
            "--spatial-res", str(res), "--num-features", "4", "--markov-order", "6",
            "--model-config", str(model_config), "--lr", "2e-4", "--total-ndata", str(total),
            "--batch", str(batch), "--batch-gpu", str(batch_gpu), "--status", str(4 * batch),
            "--snapshot", str(snapshot), "--checkpoint", "1024", "--logging", str(batch), "--valid", "0",
            "--seed", str(seed), "--device", device.type]
    return argv + (["--dist-backend", backend] if backend else [])


def _flax_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flax_leaves(tree[k])]
    return [np.asarray(tree)]


def _snapshot_diff(a: pathlib.Path, b: pathlib.Path) -> float:
    """Largest difference between two snapshots' parameters (0.0: equal)."""
    from climate2weather_tpu_torch.io.snapshot import load_snapshot

    la, lb = (_flax_leaves(load_snapshot(str(d))[0]) for d in (a, b))
    return max(float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()) for x, y in zip(la, lb))


def _final(run_dir: pathlib.Path, kdata: int) -> tuple:
    """The final snapshot directory and checkpoint file of a run."""
    return (run_dir / "r" / f"network-snapshot-{kdata:07d}-0.999900",
            run_dir / "r" / f"training-state-{kdata:07d}.ckpt")


def _same_run(a: pathlib.Path, b: pathlib.Path, kdata: int) -> dict:
    """The final snapshot and checkpoint of two runs: equal bytes, and the
    snapshots' largest difference."""
    (sa, ca), (sb, cb) = _final(a, kdata), _final(b, kdata)
    return {"snapshot_equal": (sa / "params.msgpack").read_bytes() == (sb / "params.msgpack").read_bytes(),
            "checkpoint_equal": ca.read_bytes() == cb.read_bytes(), "snapshot_max_diff": _snapshot_diff(sa, sb)}


def phase10a_world_one(root, data_path, device, model_config, res, seed, backend) -> dict:
    """``train`` under ``torch.distributed.run`` with a world of one (NCCL on
    the card) and the same command without the launcher: the final snapshot
    and checkpoint equal bit for bit; where they are not, a second plain run
    measures the plain runs' own spread, which the launched run must sit
    within. Step ms of both from their ``Status:`` lines."""
    t0 = time.time()
    argv = lambda name: _train_argv(root / name, data_path, model_config, res, 64, 32, 2048, seed,  # noqa: E731
                                    device, backend, snapshot=2048)
    launched = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                "-m", "climate2weather_tpu_torch.train"] + argv("a_launched")
    (out_l,), sec_l, (first_l,) = _run_processes([launched], [_child_env(device)], label="10a launched")
    plain = [sys.executable, "-m", "climate2weather_tpu_torch.train"] + argv("a_plain")
    (out_p,), sec_p, (first_p,) = _run_processes([plain], [_child_env(device)], label="10a plain")
    same = _same_run(root / "a_launched", root / "a_plain", 2)
    # to_first_status_s: process start to the first Status line, the step
    # loop's start (imports, the group, the net, the optimizer, the data)
    rec = {"launched_step_ms": _step_ms(out_l, 64), "plain_step_ms": _step_ms(out_p, 64),
           "launched_s": sec_l, "plain_s": sec_p, "launched_to_first_status_s": first_l,
           "plain_to_first_status_s": first_p, **same, "plain_spread": None}
    rec["launched_start_line"] = [ln for ln in out_l.splitlines() if "Rank 0 of " in ln]
    if not (same["snapshot_equal"] and same["checkpoint_equal"]):
        plain2 = [sys.executable, "-m", "climate2weather_tpu_torch.train"] + argv("a_plain2")
        _run_processes([plain2], [_child_env(device)], label="10a second plain")
        rec["plain_spread"] = _snapshot_diff(_final(root / "a_plain", 2)[0], _final(root / "a_plain2", 2)[0])
    for k in ("launched_step_ms", "plain_step_ms"):
        rec[k + "_median"] = float(np.median(rec[k])) if rec[k] else None
    emit("10a", t0, **rec)
    want = "Rank 0 of 1 on cuda:0" if device.type == "cuda" else "Rank 0 of 1 on cpu"
    if len(rec["launched_start_line"]) != 1 or not rec["launched_start_line"][0].endswith(want):
        raise AssertionError(f"the launched run's start line: {rec['launched_start_line']}, want {want!r}")
    if rec["plain_spread"] is not None and not rec["snapshot_max_diff"] <= rec["plain_spread"]:
        raise AssertionError(f"the world-of-one run differs from the plain run beyond two plain runs: {rec}")
    return rec


def _step_setup(net_kwargs, seed, device, compute_dtype, batch=64, init=None):
    """Phase 10b's step: the net from the seed (or the state dict ``init``)
    with AdamW and an EMA, and the generator of a fixed global batch and its
    (t, eps), made on the CPU from the seed."""
    from climate2weather_tpu_torch.models.init import init_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.training.lr import make_schedule
    from climate2weather_tpu_torch.training.state import init_train_state, make_optimizer, make_train_step
    from climate2weather_tpu_torch.utils.seeding import derive_seed

    net = build_score_unet(net_kwargs, dtype=compute_dtype)
    if init is None:
        init_params(net, torch.Generator().manual_seed(derive_seed(seed, "phase10", "init")))
    else:
        net.load_state_dict(init)
    net = net.to(device)
    opt = make_optimizer(net.parameters(), {"weight_decay": 1e-3, "betas": [0.9, 0.999]})
    state = init_train_state(net, opt, (0.9999,))
    step = make_train_step(VPCosineProcess(), make_schedule(
        {"func_name": "lr/linear", "ref_lr": 2e-4, "total_ndata": 2048}, batch), (0.9999,))
    return state, step, torch.Generator().manual_seed(derive_seed(seed, "phase10", "batch"))


def _step_inputs(g, batch, res, channels, device):
    x = torch.randn((batch, res, res, channels), generator=g)
    t = torch.rand((batch, 1, 1, 1), generator=g)
    eps = torch.randn((batch, res, res, channels), generator=g)
    return x.to(device), t.to(device), eps.to(device)


def _flat_state(state) -> torch.Tensor:
    """Parameters, AdamW's two moments and the EMA, in one fp32 vector."""
    params = list(state.net.parameters())
    parts = [p.detach() for p in params]
    parts += [state.optimizer.state[p][m] for m in ("exp_avg", "exp_avg_sq") for p in params]
    parts += list(state.emas["0.999900"].values())
    return torch.cat([p.reshape(-1).float() for p in parts])


def _digest(flat: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def _reference_step(net_kwargs, res, seed, device, compute_dtype, batch=64) -> torch.Tensor:
    """The one-process step on the global batch laid out rank-major in 2
    rounds of ``batch // 2``: the flat state after it, on the host."""
    threads = torch.get_num_threads()
    if device.type == "cpu":  # the ranks' thread count (_child_env): CPU sums depend on it
        torch.set_num_threads(max(1, threads // 2))
    state, step, g = _step_setup(net_kwargs, seed, device, compute_dtype, batch)
    x, t, eps = _step_inputs(g, batch, res, net_kwargs["channels"], device)
    h = batch // 2
    step(state, x.view(2, h, *x.shape[1:]), draws=[(t[:h], eps[:h]), (t[h:], eps[h:])])
    torch.set_num_threads(threads)
    return _flat_state(state).cpu()


def child_step(argv) -> dict:
    """``--child step REF SEED RES DEVICE MODEL_CONFIG``: one rank of 10b's
    step check (gloo): the step on this rank's rows of the global batch with
    the global draws, then again from the same start with the planted fault
    on rank 1 (it keeps its own gradient sum, still joining the
    collective). Returns for each whether its state equals the reference and
    their largest difference; the process group stays up for the ``train``
    run that follows in the same process."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.parallel import mesh

    ref_path, seed, res, device_type, model_config = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    device = mesh.maybe_init_distributed(device_type, "gloo")
    rank, world = mesh.rank(), mesh.world_size()
    net_kwargs = {"class_name": "score_unet", "channels": 52, **yaml_load_file(model_config)}
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ref = torch.load(ref_path).to(device)
    real_all_reduce = mesh.all_reduce_grads

    def keep_own(params, extra):
        grads = [p.grad for p in params]
        bucket = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(1)])
        torch.distributed.all_reduce(bucket)
        return bucket[-1]

    out, init = {"rank": rank, "world": world}, None
    try:
        for variant in ("correct", "fault"):
            mesh.all_reduce_grads = keep_own if variant == "fault" and rank == 1 else real_all_reduce
            state, step, g = _step_setup(net_kwargs, seed, device, dtype, init=init)
            if init is None:  # both variants start from the same weights
                init = {k: v.detach().cpu().clone() for k, v in state.net.state_dict().items()}
            x, t, eps = _step_inputs(g, 64, res, 52, device)
            b = 64 // world
            step(state, x[rank * b:(rank + 1) * b][None], draws=[(t, eps)])
            flat = _flat_state(state)
            out[variant] = {"max_abs_diff": float((flat - ref).abs().max()), "equal": bool(torch.equal(flat, ref))}
            del state, step, x, t, eps, flat
    finally:
        mesh.all_reduce_grads = real_all_reduce
    return out


def child_cli(kind: str, argv) -> dict:
    """``--child train|predict ARGS``: the port's command line (``train.main``
    or ``experiment.main``) in this process; returns this rank's attention
    launches, peak device memory, the checkpoint, snapshot and grid files it
    wrote, and, for ``train``, the digest of its final state."""
    from climate2weather_tpu_torch import experiment, train
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.ops import attention
    from climate2weather_tpu_torch.training import loop

    writes, captured = [], {}
    real_loop, real_io, real_snapshot = loop.training_loop, loop.CheckpointIO, loop.save_snapshot
    real_to_file = GridDataset.to_file

    class RecordingIO(real_io):
        def save(self, path, verbose=True):
            writes.append(os.path.basename(path))
            return super().save(path, verbose)

    def recording_snapshot(run_dir, kdata, rate, *args, **kwargs):
        writes.append(f"network-snapshot-{kdata:07d}-{rate}")
        return real_snapshot(run_dir, kdata, rate, *args, **kwargs)

    def recording_to_file(self, path, *args, **kwargs):
        writes.append(os.path.basename(str(path)))
        return real_to_file(self, path, *args, **kwargs)

    def capturing_loop(*args, **kwargs):
        captured["state"] = real_loop(*args, **kwargs)
        captured["digest"] = _digest(_flat_state(captured["state"]))
        return captured["state"]

    loop.training_loop, loop.CheckpointIO, loop.save_snapshot = capturing_loop, RecordingIO, recording_snapshot
    GridDataset.to_file = recording_to_file
    for k in attention.launch_counts:
        attention.launch_counts[k] = 0
    if torch.cuda.is_available() and torch.cuda.is_initialized():  # after 10b's step check
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if kind == "train":
        train.main(argv)
    else:
        experiment.main(argv)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    out = {"rank": int(os.environ.get("RANK", 0)), "seconds": time.time() - t0,
           "launches": dict(attention.launch_counts), "writes": writes,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    if kind == "train":
        out.update(digest=captured["digest"], step=captured["state"].step)
    return out


def phase10b_two_ranks(root, data_path, device, model_config, res, seed) -> dict:
    """Two ranks on the one card over gloo: the step check against the
    one-process step (and its planted fault), then ``train`` on 2 ranks for
    8 steps of 128 (64 rows a rank in 2 rounds of 32) to a checkpoint at
    1024 ndata and a 2-rank resume for 8 more."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    t0 = time.time()
    net_kwargs = {"class_name": "score_unet", "channels": 52, **yaml_load_file(model_config)}
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ref = _reference_step(net_kwargs, res, seed, device, dtype)
    ref_path = root / "step_ref.pt"
    torch.save(ref, ref_path)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the step check, then in the same processes the first run; then the resume
    step_child = ["--child", "step", str(ref_path), str(seed), str(res), device.type, str(model_config), "--"]
    runs = {}
    for name, total, child in (("first", 1024, step_child), ("resumed", 2048, ["--child", "train"])):
        port = _free_port()
        argv = _train_argv(root / "b_ranks", data_path, model_config, res, 128, 32, total, seed, device, "gloo")
        outs, sec, _ = _run_processes(
            [[sys.executable, str(REPO / "chip_smoke.py")] + child + argv for _ in range(2)],
            [_child_env(device, r, 2, port) for r in range(2)], label=f"10b {name}")
        runs[name] = {"seconds": sec, "ranks": [_child_result(o) for o in outs],
                      "step_ms": _step_ms(outs[0], 128)}
    steps = [r.pop("step_check") for r in runs["first"]["ranks"]]
    # the limit: 0.0 (bits) where the ranks reproduce the reference; else the
    # one-process step's own spread, from a second run of it
    limit = 0.0
    if not all(st["correct"]["equal"] for st in steps):
        limit = float((_reference_step(net_kwargs, res, seed, device, dtype) - ref).abs().max())
    del ref
    lines = (root / "b_ranks" / "r" / "metrics.jsonl").read_text().splitlines()
    losses = [json.loads(ln)["train/loss"] for ln in lines if "train/loss" in json.loads(ln)]
    per_step = 12 if device.type == "cuda" else 0  # 6 attention blocks x 2 microbatches a rank
    launches = [{k: sum(runs[n]["ranks"][r]["launches"][k] for n in runs) for k in ("attention_fwd", "attention_bwd")}
                for r in range(2)]
    rec = {
        "step_check": {"limit": limit, "ranks": steps},
        "train": {n: {"seconds": v["seconds"], "step_ms": v["step_ms"],
                      "ranks": [{k: r[k] for k in ("rank", "digest", "step", "writes", "peak_bytes", "launches")}
                                for r in v["ranks"]]} for n, v in runs.items()},
        "losses": losses, "launches_per_rank": launches, "expected_per_rank": per_step * 16,
        "step_ms_median": float(np.median(runs["resumed"]["step_ms"])) if runs["resumed"]["step_ms"] else None,
        "peak_bytes": [None if device.type != "cuda" else max(runs[n]["ranks"][r]["peak_bytes"] for n in runs)
                       for r in range(2)],
    }
    emit("10b", t0, **rec)
    # rank agreement through the reference: both within the limit of it, or
    # (the fault) rank 0 within and rank 1 beyond
    good = [st["correct"] for st in steps]
    bad = [st["fault"] for st in steps]
    if any(g["max_abs_diff"] > limit for g in good):
        raise AssertionError(f"the 2-rank step differs from the one-process step: {steps}, limit {limit}")
    if not (bad[0]["max_abs_diff"] <= limit < bad[1]["max_abs_diff"]):
        raise AssertionError(f"the step check cannot see a rank that skips the all-reduce: {steps}")
    for n, v in runs.items():
        r0, r1 = v["ranks"]
        want_step = {"first": 8, "resumed": 16}[n]
        if r0["digest"] != r1["digest"] or r0["step"] != want_step or r1["step"] != want_step:
            raise AssertionError(f"the ranks disagree after the {n} run: {r0}, {r1}")
        want0 = [f"network-snapshot-{1 if n == 'first' else 2:07d}-0.999900",
                 f"training-state-{1 if n == 'first' else 2:07d}.ckpt"]
        if r1["writes"] or r0["writes"] != want0:
            raise AssertionError(f"{n}: rank 0 must write {want0} alone: {r0['writes']}, {r1['writes']}")
    if len(losses) != 16 or not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"the 2-rank losses do not fall: {losses}")
    if any(lr != {"attention_fwd": per_step * 16, "attention_bwd": per_step * 16} for lr in launches):
        raise AssertionError(f"attention launches per rank {launches}, want {per_step} a step")
    return rec


def phase10c_striped(root, paths, snapshot_dir, device, hours, seed, steps=8) -> dict:
    """``experiment predict`` on phase 6's files ``paths`` with
    ``s16_t6_spectral.yml`` cut to 6 samples (3 a rank, one group each) and
    ``steps`` steps, on 2 ranks over gloo and in this process: the samples
    equal bit for bit, the shared files written once, by rank 0, A(x) = y
    under phase 4's limit."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file

    t0 = time.time()
    cfg = yaml_load_file(CONFIG)
    cfg.update(model_path=str(snapshot_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], spectral_calibrate=paths["train"], num_samples=6,
               ensemble_batch=3, num_sampling_steps=steps, seed=seed)
    config_path = root / "striped.yml"
    yaml_dump_file(cfg, config_path)
    predict = lambda name: ["predict", "--save-path", str(root / name), "--config-path", str(config_path),  # noqa: E731
                            "--device", device.type]
    child = [sys.executable, str(REPO / "chip_smoke.py"), "--child", "predict"]
    port = _free_port()
    outs, ranks_s, _ = _run_processes([child + predict("c_ranks") + ["--dist-backend", "gloo"]] * 2,
                                   [_child_env(device, r, 2, port) for r in range(2)], label="10c ranks")
    ranks = [_child_result(o) for o in outs]
    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.ops import attention

    for k in attention.launch_counts:
        attention.launch_counts[k] = 0
    threads = torch.get_num_threads()
    if device.type == "cpu":  # the ranks' thread count (_child_env): CPU sums depend on it
        torch.set_num_threads(max(1, threads // 2))
    t_one = time.time()
    experiment.main(predict("c_one"))
    if device.type == "cuda":
        torch.cuda.synchronize()
    one = {"seconds": time.time() - t_one, "launches": dict(attention.launch_counts)}
    torch.set_num_threads(threads)
    got_dir, one_dir = root / "c_ranks" / "001_striped", root / "c_one" / "001_striped"
    names = sorted(p.name for p in one_dir.iterdir())
    equal = {n: (got_dir / n).read_bytes() == (one_dir / n).read_bytes() for n in names
             if n.startswith("gen_sample_")}
    samples = [open_grid(str(got_dir / f"gen_sample_{i:03d}.nc")) for i in range(6)]
    consistency, tol = _written_consistency(got_dir, samples, cfg, paths["quantiles"])
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    expect = (_attention_blocks(snap_cfg["network_kwargs"])
              * _expected_forwards({**cfg, "num_samples": 3}, hours, window) if device.type == "cuda" else 0)
    # ranks_wall_s: the launch of both ranks to their exit (process start
    # included); *_run_s: the predict command itself in each process
    rec = {"files": names, "ranks_files": sorted(p.name for p in got_dir.iterdir()), "samples_equal": equal,
           "writes": [r["writes"] for r in ranks], "ranks_wall_s": ranks_s,
           "ranks_run_s": [r["seconds"] for r in ranks], "one_run_s": one["seconds"],
           "launches_per_rank": [r["launches"] for r in ranks], "one_launches": one["launches"],
           "expected_per_rank": expect, "A_x_minus_y_max": consistency, "A_tol": tol}
    emit("10c", t0, **rec)
    if len(equal) != 6 or not all(equal.values()) or rec["ranks_files"] != names:
        raise AssertionError(f"the striped run differs from the one-process run: {rec}")
    shared = ["ground_truth.nc", "observation.nc"]
    if ranks[0]["writes"] != shared + [f"gen_sample_{i:03d}.nc" for i in range(3)] or \
            ranks[1]["writes"] != [f"gen_sample_{i:03d}.nc" for i in range(3, 6)]:
        raise AssertionError(f"the ranks' writes: {rec['writes']}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y in the striped samples: {consistency} > {tol}")
    if any(r["launches"]["attention_fwd"] != expect for r in ranks):
        raise AssertionError(f"attention launches per rank {rec['launches_per_rank']}, want {expect}")
    return rec


# phase 10e: one sample's window evaluations split over the two ranks of one
# sample group. The year path: 511 windows in 4 chunks of 128, 2 dealt to a
# rank (each forward the one-process batch: bits), 2 steps. The short path:
# 37 windows of one member in one chunk of up to 64, cut into 19 and 18, 2
# steps. Exact guidance: 7 windows (19 hours) in one chunk, cut into 4 and
# 3, forward and VJP, 2 steps.
SPLIT_YEAR = (YEAR_HOURS, 2)  # hours, steps
SPLIT_SHORT = (49, 2, 64)  # hours, steps, batch_size
SPLIT_EXACT = (19, 2, 64)
# the short and exact splits change the batches (and the VJP's sums): their
# samples are held to JAX's host-against-device bar (phase 14b-fp32), 5e-3
# of the one-process sample's standard deviation, with the net in fp32 (in
# bf16 the COSMO guidance's gain grows the batches' one-ulp differences to
# 0.05-0.12 of it on an NVIDIA H100)
SPLIT_LIMIT = 5e-3


def _split_fault(kind, rank: int):
    """Plant ``kind`` on rank 1 and return its undo: ``shift``, the rank's
    windows one later (the first of each of its ranges never evaluated: the
    group's sum consistent on both ranks and wrong); ``own``, the rank sums a
    copy and keeps its own share (it still joins every collective; the
    ranks' trajectories part)."""
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
    from climate2weather_tpu_torch.parallel import mesh

    if kind is None or rank != 1:
        return lambda: None
    if kind == "shift":
        real_work = WindowScoreFn._work

        def shifted(self, n_chunks, N):
            return [(ci, min(a + 1, N), min(b + 1, N)) for ci, a, b in real_work(self, n_chunks, N)]

        WindowScoreFn._work = shifted
        return lambda: setattr(WindowScoreFn, "_work", real_work)
    real_reduce = mesh.SampleGroups.all_reduce

    def keep_own(self, tensor):
        real_reduce(self, tensor.clone())

    mesh.SampleGroups.all_reduce = keep_own
    return lambda: setattr(mesh.SampleGroups, "all_reduce", real_reduce)


def _split_job(job: dict, device, rank: int) -> dict:
    """One predict of phase 10e in this process: ``experiment.main`` where
    ``job["cli"]``, else ``exp/downscaling.run`` with the net in
    ``job["dtype"]``; the job's fault planted on rank 1 (``own`` must end in
    the group's disagreement error, which is recorded). Returns the seconds,
    attention launches, windows through the net (forwards under grad
    included) and grid files written."""
    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.ops import attention

    windows, writes = [0], []
    real_load, real_to_file = downscaling.load_net, GridDataset.to_file

    def counting_load(*args, **kwargs):
        net, snap_cfg = real_load(*args, **kwargs)
        net.register_forward_pre_hook(lambda mod, inputs: windows.__setitem__(0, windows[0] + len(inputs[0])))
        return net, snap_cfg

    def recording_to_file(self, path, *args, **kwargs):
        writes.append(os.path.basename(str(path)))
        return real_to_file(self, path, *args, **kwargs)

    downscaling.load_net, GridDataset.to_file = counting_load, recording_to_file
    undo = _split_fault(job["fault"], rank)
    for k in attention.launch_counts:
        attention.launch_counts[k] = 0
    t0, error = time.time(), None
    try:
        if job["cli"]:
            experiment.main(["predict", "--save-path", job["save"], "--config-path", job["config"],
                             "--device", device.type, "--dist-backend", "gloo"])
        else:
            downscaling.run(job["save"], job["config"], device=device, compute_dtype=getattr(torch, job["dtype"]))
    except RuntimeError as e:
        if job["fault"] != "own":
            raise
        error = str(e)
    finally:
        undo()
        downscaling.load_net, GridDataset.to_file = real_load, real_to_file
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"name": job["name"], "seconds": time.time() - t0, "launches": dict(attention.launch_counts),
            "windows": windows[0], "writes": writes, "error": error}


def child_split(argv) -> dict:
    """``--child split SPEC``: one rank of phase 10e. The process group from
    torchrun's environment (gloo), then each job of the JSON file ``SPEC``
    in order, once its config exists (the last through ``experiment.main``,
    which ends the group); returns each job's record and the rank's peak
    device memory."""
    from climate2weather_tpu_torch.parallel import mesh

    spec = json.loads(pathlib.Path(argv[0]).read_text())
    rank = int(os.environ["RANK"])
    device = mesh.maybe_init_distributed(spec["device"], "gloo")
    jobs = []
    for job in spec["jobs"]:
        deadline = time.monotonic() + CHILD_TIMEOUT
        while not os.path.exists(job["config"]):  # the year's is written while the ranks run
            if time.monotonic() > deadline:
                raise TimeoutError(f"no config {job['config']}")
            time.sleep(0.1)
        jobs.append(_split_job(dict(job, save=job["save"] + "_ranks"), device, rank))
    cuda = device.type == "cuda"
    return {"rank": rank, "jobs": jobs, "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def _split_sample(out_dir: pathlib.Path, cfg: dict, quantiles) -> np.ndarray:
    from climate2weather_tpu_torch.data.grid import open_grid

    return _normed(open_grid(str(out_dir / "gen_sample_000.nc")), cfg, quantiles)


def phase10e_split(root, paths, snapshot_dir, device, res, seed, year=SPLIT_YEAR, short=SPLIT_SHORT,
                   exact=SPLIT_EXACT, year_overrides=None, beside=None) -> dict:
    """One sample of ``experiment predict`` split over 2 ranks of one sample
    group (gloo, both on the card) against the same run in this process
    (which runs beside the ranks, after ``beside``, a callable, if given):
    the year config at ``year`` (hours, steps; ``year_overrides`` cut it
    further) through ``experiment.main``, its sample equal bit for bit;
    ``s16_t6_spectral.yml`` at ``short`` and with exact guidance at
    ``exact`` (hours, steps, batch_size; phase 6's files ``paths``), the net
    in fp32, each sample within ``SPLIT_LIMIT`` of the one-process
    sample's standard deviation. Planted on rank 1: the shifted windows
    (year, short, exact), which must break the bits or exceed the limit, and
    the kept share (short, the net in bf16), which the group must catch. The
    ranks' attention launches and windows sum to the one-process counts,
    and rank 0 alone writes."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file

    t0 = time.time()
    cfgs = {}
    for name, (hours, steps, batch), extra in (("short", short, {}), ("exact", exact, {"use_exact_grad": True})):
        cfg = yaml_load_file(CONFIG)
        cfg.update(model_path=str(snapshot_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
                   observation_path=paths["data"], spectral_calibrate=paths["train"], num_hours=hours,
                   num_samples=1, num_sampling_steps=steps, batch_size=batch, seed=seed)
        cfgs[name] = {**cfg, **extra}
        yaml_dump_file(cfgs[name], root / f"split_{name}.yml")
    bases = {"short": "short", "short_shift": "short", "short_own": "short", "exact": "exact",
             "exact_shift": "exact", "year_shift": "year", "year": "year"}
    jobs = [{"name": name, "config": str(root / f"split_{base}.yml"), "fault": name.partition("_")[2] or None,
             "dtype": "bfloat16" if name in ("year", "year_shift", "short_own") else "float32", "cli": name == "year",
             "save": str(root / f"e_{name}")} for name, base in bases.items()]
    spec_path = root / "split.json"
    spec_path.write_text(json.dumps({"device": device.type, "jobs": jobs}))
    one, year_paths = {}, {}
    threads = torch.get_num_threads()

    def meanwhile():
        # the year's inputs, then its config (the ranks wait for a job's
        # config: they reach the year's last); ``beside``; the references
        (root / "e_year").mkdir()
        year_paths.update(write_predict_inputs(root / "e_year", res, year[0], seed, start="2014-01-01T00"))
        cfgs["year"] = _year_config(snapshot_dir, year_paths, year[0],
                                    {"num_sampling_steps": year[1], "seed": seed, **(year_overrides or {})})
        yaml_dump_file(cfgs["year"], root / "split_year.tmp")
        os.replace(root / "split_year.tmp", root / "split_year.yml")
        if beside is not None:
            beside()
        if device.type == "cpu":  # the ranks' thread count (_child_env): CPU sums depend on it
            torch.set_num_threads(max(1, threads // 2))
        try:
            for job in jobs:
                if job["fault"] is None:
                    one[job["name"]] = _split_job(dict(job, save=job["save"] + "_one"), device, 0)
        finally:
            torch.set_num_threads(threads)

    port = _free_port()
    outs, ranks_s, _ = _run_processes([[sys.executable, str(REPO / "chip_smoke.py"), "--child", "split",
                                        str(spec_path)]] * 2, [_child_env(device, r, 2, port) for r in range(2)],
                                      label="10e ranks", beside=meanwhile)
    ranks = [_child_result(o) for o in outs]
    by = [{j["name"]: j for j in r["jobs"]} for r in ranks]
    out_dir = lambda name, who: root / f"e_{name}_{who}" / f"001_split_{bases[name]}"  # noqa: E731
    q = {"year": year_paths["quantiles"]}
    rec = {"wall_s_two_ranks": ranks_s, "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks], "limit": SPLIT_LIMIT,
           "jobs": {}}
    for name in ("year", "short", "exact"):
        cfg, quant = cfgs[name], q.get(name, paths["quantiles"])
        grid = open_grid(str(out_dir(name, "ranks") / "gen_sample_000.nc"))
        want = _split_sample(out_dir(name, "one"), cfg, quant)
        got = _normed(grid, cfg, quant)
        bad = _split_sample(out_dir(f"{name}_shift", "ranks"), cfg, quant)
        std = float(want.std())
        job = {"bits_equal": (out_dir(name, "ranks") / "gen_sample_000.nc").read_bytes()
               == (out_dir(name, "one") / "gen_sample_000.nc").read_bytes(),
               "finite": bool(np.isfinite(got).all()), "max_abs_diff": float(np.abs(got - want).max()),
               "std": std, "fault_shift_max_abs_diff": float(np.abs(bad - want).max()),
               "fault_shift_bits_equal": (out_dir(f"{name}_shift", "ranks") / "gen_sample_000.nc").read_bytes()
               == (out_dir(name, "one") / "gen_sample_000.nc").read_bytes(),
               "seconds_two_ranks": [b[name]["seconds"] for b in by], "seconds_one": one[name]["seconds"],
               "launches_per_rank": [b[name]["launches"] for b in by], "launches_one": one[name]["launches"],
               "windows_per_rank": [b[name]["windows"] for b in by], "windows_one": one[name]["windows"],
               "writes": [b[name]["writes"] for b in by]}
        job["diff_in_std"] = job["max_abs_diff"] / std
        job["fault_shift_in_std"] = job["fault_shift_max_abs_diff"] / std
        if cfg.get("t0_project"):
            job["A_x_minus_y_max"], job["A_tol"] = _written_consistency(out_dir(name, "ranks"), [grid], cfg, quant)
        rec["jobs"][name] = job
    rec["fault_own_errors"] = [b["short_own"]["error"] for b in by]
    emit("10e", t0, **rec)
    for name, job in rec["jobs"].items():
        if not job["finite"] or job.get("A_x_minus_y_max", 0.0) > job.get("A_tol", 0.0):
            raise AssertionError(f"10e {name}: the split sample is not finite or misses A(x) = y: {job}")
        if name == "year":
            if not job["bits_equal"] or job["fault_shift_bits_equal"]:
                raise AssertionError(f"10e year: the split sample must equal the one-process sample bit for bit, "
                                     f"and the shifted windows must not: {job}")
        elif not job["diff_in_std"] <= SPLIT_LIMIT < job["fault_shift_in_std"]:
            raise AssertionError(f"10e {name}: the split sample must lie within {SPLIT_LIMIT} std of the "
                                 f"one-process sample and the shifted windows beyond: {job}")
        summed = lambda key: {k: sum(lr[k] for lr in job[key]) for k in job[key][0]}  # noqa: E731
        split_chunks = name == "year"  # whole chunks dealt: the launches split too
        if split_chunks and summed("launches_per_rank") != job["launches_one"] or \
                not split_chunks and any(lr != job["launches_one"] for lr in job["launches_per_rank"]):
            raise AssertionError(f"10e {name}: attention launches per rank {job['launches_per_rank']} against "
                                 f"{job['launches_one']} in one process")
        if sum(job["windows_per_rank"]) != job["windows_one"] or min(job["windows_per_rank"]) == 0:
            raise AssertionError(f"10e {name}: windows per rank {job['windows_per_rank']} do not split "
                                 f"{job['windows_one']}")
        if job["writes"] != [["ground_truth.nc", "observation.nc", "gen_sample_000.nc"], []]:
            raise AssertionError(f"10e {name}: rank 0 must write every file alone: {job['writes']}")
    if not all(e and "disagree" in e for e in rec["fault_own_errors"]):
        raise AssertionError(f"10e: a rank keeping its own share went unseen: {rec['fault_own_errors']}")
    return rec


def _children_of(pid: int) -> list:
    """Processes whose parent is ``pid`` (from /proc)."""
    kids = []
    for entry in pathlib.Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                stat = (entry / "stat").read_text()
            except OSError:
                continue
            if int(stat[stat.rindex(")") + 2:].split()[1]) == pid:
                kids.append(int(entry.name))
    return kids


def phase10d_supervisor(root, data_path, device, model_config, res, seed, plain_dir,
                        stall_timeout=10.0) -> dict:
    """10a's plain command under the supervisor: once its first checkpoint
    exists the child's process group is stopped (SIGSTOP, a wedge without
    a hook in the program); the supervisor must see the stall within
    ``stall_timeout``, kill the child and relaunch it, and the resumed run
    must end on 10a's plain run's final snapshot."""
    import signal

    t0 = time.time()
    run_dir, journal = root / "d_supervised", root / "d_journal.jsonl"
    cmd = [sys.executable, "-m", "climate2weather_tpu_torch.training.supervisor",
           "--stall-timeout", str(stall_timeout), "--startup-grace", "300", "--term-grace", "2",
           "--restart-delay", "1", "--max-restarts", "2", "--steady-pattern", "Status:",
           "--journal", str(journal), "--", sys.executable, "-m", "climate2weather_tpu_torch.train",
           ] + _train_argv(run_dir, data_path, model_config, res, 64, 32, 2048, seed, device, snapshot=2048)
    sup = subprocess.Popen(cmd, env=_child_env(device), cwd=str(REPO), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []
    reader = _pump(sup.stdout, lines)
    ckpt = run_dir / "r" / "training-state-0000001.ckpt"
    deadline = time.monotonic() + CHILD_TIMEOUT
    stopped_at = stopped = None
    try:
        while sup.poll() is None and time.monotonic() < deadline:
            if stopped is None and ckpt.exists():
                kids = _children_of(sup.pid)
                if len(kids) != 1:
                    raise AssertionError(f"the supervisor runs {len(kids)} children")
                os.killpg(kids[0], signal.SIGSTOP)
                stopped, stopped_at = kids[0], time.time()
            time.sleep(0.05)
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
        sup.wait()
        reader.join(timeout=10)
    text = "".join(line for _, line in lines)
    if sup.returncode != 0:
        raise AssertionError(f"the supervisor exited {sup.returncode}:\n{text[-6000:]}")
    events = [json.loads(ln) for ln in journal.read_text().splitlines()]
    kinds = [e["event"] for e in events]
    stall = next((e for e in events if e["event"] == "stall"), None)
    same = _same_run(run_dir, plain_dir, 2)
    rec = {"events": kinds, "stopped_pid": stopped,
           "detect_s": stall["ts"] - stopped_at if stall and stopped_at else None,
           "recover_s": events[-1]["ts"] - stopped_at if stopped_at else None,
           "stall": stall, **same}
    emit("10d", t0, **rec)
    if kinds != ["start", "stall", "killed", "start", "exit"]:
        raise AssertionError(f"supervisor journal {kinds}, want one stall and one restart")
    if not rec["detect_s"] <= stall_timeout + 2.0:  # its poll interval is stall_timeout / 10
        raise AssertionError(f"the stall was seen after {rec['detect_s']} s (timeout {stall_timeout})")
    return rec


def phase10_summary(ranks: dict) -> dict:
    """Phase 10's line: step ms of the plain, world-of-one and 2-rank runs
    (2 ranks time-slice one card: no production number), the ranks' peak
    memory, 10c's wall time on 2 ranks against one process, 10d's time to
    detect the stall and to recover, 10e's readings against their limits."""
    a, b, c, d, e = (ranks[k] for k in ("10a", "10b", "10c", "10d", "10e"))
    return {"step_ms_plain": a["plain_step_ms_median"], "step_ms_world_one": a["launched_step_ms_median"],
            "to_first_status_s_plain": a["plain_to_first_status_s"],
            "to_first_status_s_world_one": a["launched_to_first_status_s"],
            "step_ms_two_ranks_gloo": b["step_ms_median"], "two_ranks_batch": 128,
            "peak_bytes_per_rank": b["peak_bytes"], "world_one_equal": a["snapshot_equal"] and a["checkpoint_equal"],
            "predict_wall_s_two_ranks": c["ranks_wall_s"], "predict_run_s_two_ranks": c["ranks_run_s"],
            "predict_run_s_one_process": c["one_run_s"],
            "supervisor_detect_s": d["detect_s"], "supervisor_recover_s": d["recover_s"],
            "split_year_bits_equal": e["jobs"]["year"]["bits_equal"],
            "split_year_fault_shift_max_abs_diff": e["jobs"]["year"]["fault_shift_max_abs_diff"],
            **{f"split_{k}_{m}": e["jobs"][k][m] for k in ("short", "exact")
               for m in ("diff_in_std", "fault_shift_in_std")},
            "split_limit": e["limit"], "split_fault_own_caught": [bool(x) for x in e["fault_own_errors"]],
            "split_wall_s_two_ranks": e["wall_s_two_ranks"]}


def phase10_multi_process(snapshot_dir, device, model_config=MODEL_CONFIG, res=128, frames=140,
                          predict_res=128, hours=49, seed=0, predict_steps=8, split=None, soak=False) -> dict:
    """Phase 10, 10a-10e (see the module docstring), in one scratch
    directory, h5py unimportable in this process. 10d runs beside 10b (on a
    thread of this process; both are mostly process starts and checkpoint
    writes on the host): 10b's time-sliced step ms and 10d's seconds to
    recover include each other's work; 10c runs while 10e's ranks do, so
    their seconds include each other's too. With ``soak``, phase 15's 15b
    (the soak's chain, held against 10a's plain run) runs on a thread beside
    10e and 10c, and their seconds include its work. ``split`` holds keyword
    arguments of :func:`phase10e_split`. Returns each part's record."""
    import shutil
    import tempfile
    import threading

    sys.modules["h5py"] = None
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-ranks-"))
    if device.type == "cuda":  # what earlier phases left cached goes to the children
        torch.cuda.empty_cache()
    try:
        data_path = root / "train.h5"
        write_training_h5(data_path, synthetic_inputs(frames, res, res, 4, 1, seed)[0])
        a = phase10a_world_one(root, data_path, device, model_config, res, seed,
                               "nccl" if device.type == "cuda" else "gloo")
        beside = {}

        def run_d():
            try:
                beside["d"] = phase10d_supervisor(root, data_path, device, model_config, res, seed,
                                                  root / "a_plain")
            except BaseException as e:  # noqa: BLE001 - raised again on this thread
                beside["error"] = e

        thread = threading.Thread(target=run_d, daemon=True)
        thread.start()
        try:
            b = phase10b_two_ranks(root, data_path, device, model_config, res, seed)
        finally:
            thread.join()  # 10d ends within its own limit
        if "error" in beside:
            raise beside["error"]
        d = beside["d"]
        paths = write_predict_inputs(root, predict_res, hours, seed)
        if soak:  # 15b beside 10e and 10c, on 10a's plain run
            def run_b():
                try:
                    beside["15b"] = phase15b_soak(root, data_path, device, model_config, res, seed,
                                                  root / "a_plain" / "r", _study_env(device, root))
                except BaseException as e:  # noqa: BLE001 - raised again on this thread
                    beside["error"] = e

            thread = threading.Thread(target=run_b, daemon=True)
            thread.start()
        c = {}  # 10c beside 10e's ranks (both are mostly process starts on the host)
        try:
            e = phase10e_split(root, paths, snapshot_dir, device, predict_res, seed, **(split or {}),
                               beside=lambda: c.update(phase10c_striped(root, paths, snapshot_dir, device, hours,
                                                                        seed, predict_steps)))
        finally:
            if soak:
                thread.join()
        if "error" in beside:
            raise beside["error"]
        if a["plain_spread"] is not None and not d["snapshot_max_diff"] <= a["plain_spread"]:
            raise AssertionError(f"the supervised run differs from the plain run beyond two plain runs: {d}")
        if a["plain_spread"] is None and not (d["snapshot_equal"] and d["checkpoint_equal"]):
            raise AssertionError(f"the supervised run differs from the plain run: {d}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"10a": a, "10b": b, "10c": c, "10d": d, "10e": e, **({"15b": beside["15b"]} if soak else {})}


# ---------------------------------------------------------------------------
# phase 11: the offline data layer on the card's host, from a raw archive to
# a guided predict on the card. Every process it starts and this process
# from its start on have the packages of PHASE11_BLOCKED unimportable.

FIXTURES = REPO / "tests" / "fixtures"
FIXTURE_NAMES = ("v108", "latest")  # netCDF-C's 1.8 low bound; libver 'latest'
# every kind of checksummed structure of the 'latest' fixture (signatures)
CHECKSUMMED = (b"\x89HDF", b"OHDR", b"OCHK", b"FRHP", b"FHDB", b"FHIB", b"BTHD", b"BTLF", b"FAHD", b"FADB", b"EAHD",
               b"EAIB", b"EASB", b"EADB")
PHASE11_BLOCKED = ("jax", "flax", "optax", "h5py", "scipy", "click", "netCDF4", "xarray", "climate2weather_tpu")
# the HDF5 structures h5py writes (tests/_h5py_layout_fixtures.py): one file
# per kind, the external links' and virtual dataset's source beside them
LAYOUT_DANGLING = ("d", "de", "de2")  # links to nothing: listed, KeyError on access
# reads of the selections fixture as h5py takes them: label -> (dataset, key)
LAYOUT_SELECTIONS = {
    "step2": ("chunked", np.s_[::2]),
    "ellipsis": ("chunked", np.s_[...]),
    "ellipsis_int": ("chunked", np.s_[..., 3]),
    "rows": ("chunked", np.s_[[0, 3, 4, 8]]),
    "negative_rows": ("chunked", np.s_[[-7, -1]]),
    "mixed": ("chunked", np.s_[1, 1::2, [0, 2, 4]]),
    "strided_box": ("chunked", np.s_[1:8:3, ::4, 1:]),
    "array_index": ("contiguous", np.s_[:, np.array([1, 5])]),
    "contiguous_step": ("contiguous", np.s_[2::3, ::2]),
    "empty_list": ("contiguous", np.s_[[]]),
}
ARCHIVE_NAME = "{var}_EUR-6km_ECMWF-ERAINT_REA6_r1i1p1f1_COSMO_v1_{t0}-{t1}.nc"
# (start, hours, 12-digit start stamp, end stamp): a 2005 decoy that the
# year filter drops, two 2006 files (the second with a fully missing tas
# hour) and one 2014 file
ARCHIVE_FILES = (("2005-01-01T00", 1, "200501010000", "200501010000"),
                 ("2006-01-01T00", 12, "200601010000", "200601011100"),
                 ("2006-01-01T12", 12, "200601011200", "200601012300"),
                 ("2014-01-01T00", 12, "201401010000", "201401011100"))
ARCHIVE_NAN = ("tas", 2, 5)  # variable, file of ARCHIVE_FILES, hour
QM_CONFIG = REPO / "exp" / "configs" / "001_clim-downscaling" / "qm_debiased_climate_mpi.yml"
# the climate model's bias: (scale, offset) per variable
QM_BIAS = {"psl": (1.002, 0.0), "tas": (1.0, 2.0), "uas": (0.8, 0.0), "vas": (0.8, 0.0)}
QM_MARGIN = 0.1  # debiased quantile error at most this share of the biased one
SYNTH_HOURS = (240, 56)  # train, eval: the CLI's 8784 and 1488 cut to the phase's time
PHASE11_BLOCKER = r"""
import importlib.abc, runpy, sys

BLOCKED = set(sys.argv[1].split(","))


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked by chip_smoke: {name}")
        return None


sys.meta_path.insert(0, Blocker())
for name in BLOCKED:
    sys.modules[name] = None
kind, target, sys.argv = sys.argv[2], sys.argv[3], [sys.argv[3]] + sys.argv[4:]
if kind == "module":
    runpy.run_module(target, run_name="__main__", alter_sys=True)
else:
    runpy.run_path(target, run_name="__main__")
"""


def _blocked(kind: str, target: str, *argv, blocked=PHASE11_BLOCKED) -> list:
    """The command line of ``python -m target ARGS`` (``kind`` "module") or
    ``python target ARGS`` ("path") with the packages of ``blocked``
    unimportable."""
    return [sys.executable, "-c", PHASE11_BLOCKER, ",".join(blocked), kind, str(target), *map(str, argv)]


def _data_cli(device, label, *argv) -> float:
    """One command of ``python -m climate2weather_tpu_torch.data.cli`` in its
    own blocked process; its seconds."""
    _, seconds, _ = _run_processes([_blocked("module", "climate2weather_tpu_torch.data.cli", *argv)],
                                   [_child_env(device)], label=f"11 {label}")
    return seconds


def _read_all(path) -> dict:
    """Every dataset and attribute of an HDF5 file through the port's reader."""
    from climate2weather_tpu_torch.io import hdf5

    out = {}
    with hdf5.File(path) as f:
        out["/"] = dict(f.attrs)
        for k in f.keys():
            out[k] = (f[k][()], dict(f[k].attrs))
    return out


def sig_name(sig: bytes) -> str:
    """A structure's signature as text (the superblock's without its first byte)."""
    return sig.decode("latin-1").strip("\x89")


def checksummed_byte(raw: bytes, sig: bytes) -> int:
    """A byte of the first ``sig`` structure in ``raw`` that its checksum
    covers and that the reader uses only after verifying it: chunk 0's last
    byte of an object header, a field past the signature of the others."""
    at = raw.index(sig)
    if sig == b"OHDR":
        flags = raw[at + 5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        size_len = 1 << (flags & 3)
        return at + pos + size_len + int.from_bytes(raw[at + pos:at + pos + size_len], "little") - 1
    return at + {b"\x89HDF": 20, b"OCHK": 4, b"EAHD": 12, b"FAHD": 8}.get(sig, 6)


def phase11a_netcdf(root) -> dict:
    """The committed netCDF-C fixtures through ``io.hdf5.File`` and
    ``open_grid``: every array equal to the fixtures' ``.npz`` bit for bit,
    and a flipped byte in each kind of checksummed structure caught."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io import hdf5

    t0 = time.time()
    want = np.load(FIXTURES / "netcdf_c_contents.npz")
    rec = {}
    for name in FIXTURE_NAMES:
        path = FIXTURES / f"netcdf_c_{name}.nc"
        raw = path.read_bytes()
        read = _read_all(path)
        grid = open_grid(str(path))
        equal = {k: read[k][0].dtype == want[k].dtype and read[k][0].tobytes() == want[k].tobytes()
                 for k in want.files}
        equal.update({f"open_grid_{v}": grid.data_vars[v].tobytes() == want[v].tobytes() for v in grid.data_vars})
        rec[name] = {"superblock": raw[8], "bytes": len(raw), "equal": equal, "root_attrs": len(read["/"]),
                     "structures": {sig_name(s): raw.count(s) for s in CHECKSUMMED}}
        if not all(equal.values()) or len(equal) != len(want.files) + 4:
            raise AssertionError(f"the {name} fixture reads wrong: {rec[name]}")
    raw = (FIXTURES / "netcdf_c_latest.nc").read_bytes()
    caught = {}
    for sig in CHECKSUMMED:
        flipped = bytearray(raw)
        flipped[checksummed_byte(raw, sig)] ^= 0x10
        path = root / "flipped.nc"
        path.write_bytes(bytes(flipped))
        try:
            _read_all(path)
            caught[sig_name(sig)] = None
        except hdf5.ChecksumError as e:
            caught[sig_name(sig)] = str(e).split(": ", 1)[1]
    rec["checksum_faults"] = caught
    rec["h5py_layouts"] = _layout_fixtures(root)
    emit("11a", t0, **rec)
    if not all(caught.values()):
        raise AssertionError(f"a flipped byte in a checksummed structure went unseen: {caught}")
    return rec


# a year's training-file chunk: (24, 4, 128, 128) float32 (data/processing.py's
# chunk_hours of 24 at the 72.1M net's 128 x 128)
YEAR_CHUNK_SHAPE = (24, 4, 128, 128)
CODEC_RATE_FRAME = FIXTURES / "codec_rate_frame.h5"


def tiled_szip(chunk: bytes, copies: int, pad_bits: int) -> bytes:
    """A szip chunk of ``copies`` times the samples of ``chunk``: its AEC
    stream, less the ``pad_bits`` that end its last byte, repeated bit for
    bit (each copy's samples fill whole scanlines, so every copy starts a
    reference sample interval), after the decoded size."""
    bits = np.unpackbits(np.frombuffer(chunk, np.uint8, offset=4))
    stream = np.packbits(np.tile(bits[:bits.size - pad_bits], copies)).tobytes()
    return (int.from_bytes(chunk[:4], "little") * copies).to_bytes(4, "little") + stream


def tiled_szip_bytes(frame: bytes, copies: int, width: int) -> bytes:
    """What :func:`tiled_szip` decodes to where ``frame`` is pixels of
    ``width`` bytes coded as byte planes: the planes of every copy in turn,
    read back as planes of the whole."""
    planes = np.frombuffer(frame, np.uint8).reshape(-1, width).T.ravel()
    return np.tile(planes, copies).reshape(width, -1).T.tobytes()


def codec_rates(repeats: int = 3) -> dict:
    """The host codecs' decode rates (MB of decoded output a second, the
    best of ``repeats``) on a year's chunk of bytes from the committed frame
    (``tests/_h5py_layout_fixtures.write_codec_rate_frame``): its szip
    stream tiled bit for bit (:func:`tiled_szip`), its lzf stream (after
    shuffle) repeated (an LZF stream's matches are relative, so streams
    concatenate), and deflate at h5py's level 4 of what that lzf stream
    decodes to, one stream a frame (one deflate stream of the repeated
    frames would be mostly matches back one frame); each decoded output
    checked against one frame's."""
    import zlib

    from climate2weather_tpu_torch.data import native_blosc
    from climate2weather_tpu_torch.io import hdf5

    with hdf5.File(CODEC_RATE_FRAME) as f:
        frame = f["szip"][()]
        pad = int(f["szip"].attrs["pad_bits"])
        chunks = {name: (f._src.read(addr, size), f[name]._filters)
                  for name in ("szip", "lzf") for (_, _, size, addr) in f[name]._index}
    copies = int(np.prod(YEAR_CHUNK_SHAPE)) // frame.size
    szip_chunk, ((_, vals),) = chunks["szip"]
    lzf_chunk = chunks["lzf"][0]
    one = native_blosc.lzf_decompress(lzf_chunk, frame.nbytes)
    shuffled, deflated = one * copies, zlib.compress(one, 4)
    streams = {"szip": (tiled_szip(szip_chunk, copies, pad), tiled_szip_bytes(frame.tobytes(), copies, 4),
                        lambda raw, n: native_blosc.szip_decompress(raw, vals, n)),
               "lzf": (lzf_chunk * copies, shuffled, native_blosc.lzf_decompress),
               "deflate": (deflated * copies, shuffled,
                           lambda raw, n: b"".join(zlib.decompress(deflated) for _ in range(copies)))}
    rec = {"decoded_bytes": len(shuffled), "frame": list(frame.shape), "copies": copies}
    for name, (raw, want, decode) in streams.items():
        seconds = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = decode(raw, len(want))
            seconds.append(time.perf_counter() - t0)
            if out != want:
                raise AssertionError(f"the {name} codec decodes the tiled year chunk wrong")
        rec[name] = {"stored_bytes": len(raw), "best_s": min(seconds), "mb_s": len(want) / min(seconds) / 1e6}
    return rec


def _layout_fixtures(root) -> dict:
    """The committed fixtures of the HDF5 structures h5py writes
    (``tests/_h5py_layout_fixtures.py``) through ``io.hdf5.File``: every
    dataset, link followed, and every read of ``LAYOUT_SELECTIONS`` equal to
    ``h5py_layouts_contents.npz`` bit for bit; the dangling links listed
    and raising ``KeyError`` only when followed; a flipped byte in a
    fletcher32 chunk raising ``ChecksumError``; the checks of
    :func:`_storage_checks`; phase 6's observations through ``open_grid``.
    External raw storage is found as ``HDF5_EXTFILE_PREFIX=${ORIGIN}`` has
    it found."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io import hdf5

    want = np.load(FIXTURES / "h5py_layouts_contents.npz")
    equal = {}
    with extfile_origin():
        for key in want.files:
            kind, path = key.split("/", 1)
            with hdf5.File(FIXTURES / f"h5py_{kind}.h5") as f:
                name, sel = LAYOUT_SELECTIONS.get(path, (path, ())) if kind == "selections" else (path, ())
                equal[key] = _bits_equal(f[name][sel], want[key])
    with hdf5.File(FIXTURES / "h5py_links.h5") as f:
        listed = all(k in f.keys() and k in f for k in LAYOUT_DANGLING)
        dangling = {}
        for k in LAYOUT_DANGLING:
            try:
                f[k]
                dangling[k] = None
            except KeyError as e:
                dangling[k] = str(e)
    path = FIXTURES / "h5py_filters.h5"
    with hdf5.File(path) as f:
        _, _, size, addr = f["fletcher32"]._index[0]
    flipped = bytearray(path.read_bytes())
    flipped[addr + size // 2] ^= 0x10
    (root / "h5py_filters_flipped.h5").write_bytes(bytes(flipped))
    with hdf5.File(root / "h5py_filters_flipped.h5") as f:
        try:
            f["fletcher32"][()]
            fletcher = None
        except hdf5.ChecksumError as e:
            fletcher = str(e).rsplit(": ", 1)[1]
        intact = _bits_equal(f["lzf"][()], want["filters/lzf"])  # another dataset of the damaged file
    with extfile_origin():
        observations = [open_grid(str(p)) for p in OBSERVATION_FIXTURES]
    rec = {"datasets": len(equal), "equal": all(equal.values()), "unequal": [k for k, v in equal.items() if not v],
           "dangling_listed": listed, "dangling_raise": dangling, "fletcher32_fault": fletcher,
           "undamaged_read": intact, "observation": [len(observations[0].time),
                                                    *np.shape(observations[0].data_vars["tas"])[1:]],
           "observations_equal": all(a.tobytes() == b.tobytes() for a, b in zip(
               [observations[0].time, *observations[0].data_vars.values()],
               [observations[1].time, *observations[1].data_vars.values()])),
           "storage": _storage_checks(root)}
    if not rec["equal"] or len(equal) != len(want.files) or not listed or not all(dangling.values()) \
            or fletcher is None or not intact or rec["observation"] != [9, 8, 8] or not rec["observations_equal"]:
        raise AssertionError(f"the h5py layout fixtures read wrong: {rec}")
    return rec


def _storage_checks(root) -> dict:
    """The structures read since ROADMAP A 10's last: every chunk of the szip
    fixture stored szip-coded (filter mask 0: HDF5 skips the optional filter
    where it cannot shrink a chunk); the first chunk of ``f4_nn8`` cut to
    half and, in a copy of the file, its stream's first byte flipped, each
    raising ``OSError`` naming the dataset and the chunk, and each of its
    bytes flipped in turn decoding or raising, never crashing; the external
    fixture without its raw files raising ``OSError`` as h5py raises; the
    multi-year virtual datasets' extents and the year no file holds (NaN);
    the host codecs' decode rates (:func:`codec_rates`)."""
    import shutil

    from climate2weather_tpu_torch.io import hdf5

    path = FIXTURES / "h5py_szip.h5"
    with hdf5.File(path) as f:
        masks = {name: sorted({m for _, m, _, _ in f[name]._index}) for name in f}
        d = f["f4_nn8"]
        _, mask, size, addr = d._index[0]
        raw = f._src.read(addr, size)
        nbytes = int(np.prod(d.chunks)) * d._type.size

        def decode(stream: bytes):
            try:
                hdf5._unfilter(stream, d._filters, mask, d._type.size, nbytes, f"{d.name}: the chunk at {addr}")
            except OSError as e:
                return str(e)
            return None

        truncated = decode(raw[:size // 2])
        flips = [decode(raw[:i] + bytes([raw[i] ^ 0x10]) + raw[i + 1:]) for i in range(size)]
    damaged = bytearray(path.read_bytes())
    damaged[addr + 4] ^= 0x10  # the stream's first byte: its first block's option
    (root / "h5py_szip_flipped.h5").write_bytes(bytes(damaged))
    with hdf5.File(root / "h5py_szip_flipped.h5") as f:
        try:
            f["f4_nn8"][()]
            flipped = None
        except OSError as e:
            flipped = str(e).split(": ", 1)[1]
    shutil.copy(FIXTURES / "h5py_external.h5", root / "h5py_external.h5")  # without its raw files
    with extfile_origin(), hdf5.File(root / "h5py_external.h5") as f:
        try:
            f["one"][()]
            missing = None
        except OSError as e:
            missing = str(e).split(": ", 1)[1]
    with hdf5.File(FIXTURES / "h5py_multiyear.h5") as f:
        multiyear = {"x": list(f["x"].shape), "growing": list(f["growing"].shape),
                     "year_held_by_no_file_nan": bool(np.isnan(f["growing"][4:8]).all())}
    rec = {"szip_masks": sorted({m for v in masks.values() for m in v}), "szip_datasets": len(masks),
           "szip_truncated": truncated, "szip_flipped": flipped,
           "szip_byte_flips": {"bytes": size, "raised": sum(e is not None for e in flips)},
           "external_missing": missing, "multiyear": multiyear, "codec_rates": codec_rates()}
    if rec["szip_masks"] != [0] or not all(e and "the chunk at" in e and "szip decompress failed" in e
                                           for e in (truncated, flipped)) \
            or "unable to open external raw data file" not in (missing or "") \
            or multiyear != {"x": [12, 4, 6, 6], "growing": [12, 4, 6, 6], "year_held_by_no_file_nan": True}:
        raise AssertionError(f"the structures read since A 10's last read wrong: {rec}")
    return rec


def write_cosmo_archive(root: pathlib.Path, nlat=473, nlon=500, seed=7) -> pathlib.Path:
    """A raw archive in the reference's layout through the port's writer:
    one folder per variable of files named as the reference names them
    (ARCHIVE_FILES) over an ``nlat`` x ``nlon`` domain, one hour of tas
    missing (ARCHIVE_NAN)."""
    from climate2weather_tpu_torch.data.grid import GridDataset

    rng = np.random.default_rng(seed)
    coords = {"rlat": np.linspace(-21.0, 20.9, nlat), "rlon": np.linspace(-28.0, 21.9, nlon)}
    for var in sorted(PHYSICAL):
        (root / var).mkdir(parents=True)
        off, sc = PHYSICAL[var]
        for start, n, t0, t1 in ARCHIVE_FILES:
            field = (np.cumsum(rng.standard_normal((n, nlat, nlon), np.float32), axis=0) * 0.1 * sc + off
                     ).astype(np.float32)
            if (var, t0) == (ARCHIVE_NAN[0], ARCHIVE_FILES[ARCHIVE_NAN[1]][2]):
                field[ARCHIVE_NAN[2]] = np.nan
            time_axis = np.datetime64(start, "ns") + np.arange(n) * np.timedelta64(1, "h")
            GridDataset({var: field}, {"time": time_axis, **coords}).to_file(
                str(root / var / ARCHIVE_NAME.format(var=var, t0=t0, t1=t1)))
    return root


def phase11b_drill(root, device, model_config, nlat, nlon, patch, seed, steps) -> dict:
    """tests/test_cosmo_layout.py's drill through the port's command lines,
    each a blocked process: ``extract-patch-folder --years 2006-2014`` per
    variable, ``preproc-all``, then ``train`` for ``steps`` steps of 16 on the
    ``train_normed.h5`` it wrote (through this script's ``--child train``,
    which counts the attention launches)."""
    from climate2weather_tpu_torch.data.grid import QuantileDataset, open_grid
    from climate2weather_tpu_torch.io import hdf5

    t0 = time.time()
    archive, patches, proc = root / "archive", root / "patches", root / "preproc"
    write_cosmo_archive(archive, nlat, nlon, seed)
    archive_s = time.time() - t0
    size = sum(p.stat().st_size for p in archive.rglob("*.nc"))
    (lat0, lat1), (lon0, lon1) = patch
    cli_s = {}
    for var in sorted(PHYSICAL):
        cli_s[f"extract_{var}"] = _data_cli(device, f"extract {var}", "extract-patch-folder", "--var-folder",
                                            archive / var, "--out-folder", patches / var, "--years", "2006-2014",
                                            "--lat0", lat0, "--lat1", lat1, "--lon0", lon0, "--lon1", lon1)
    cli_s["preproc_all"] = _data_cli(device, "preproc-all", "preproc-all", "--raw-dir", patches, "--out-dir", proc)
    # the checks of tests/test_cosmo_layout.py
    hw = (lat1 - lat0, lon1 - lon0)
    kept = {v: sorted(p.name for p in (patches / v).glob("*.nc")) for v in PHYSICAL}
    var, i, hour = ARCHIVE_NAN
    name = ARCHIVE_NAME.format(var=var, t0=ARCHIVE_FILES[i][2], t1=ARCHIVE_FILES[i][3])
    stats = np.load(patches / var / (name[:-len(".nc")] + "_nan_stats.npz"))
    repaired = open_grid(str(patches / var / name))
    with hdf5.File(proc / "train_normed.h5") as f:
        x, x_vars = f["x"][()], [str(v) for v in f.attrs["vars"]]
    test_ds = open_grid(str(proc / "test_merged-allvars.nc"))
    quant = QuantileDataset.from_file(str(proc / "train_quantiles.nc"))
    rec = {"archive_bytes": size, "archive_s": archive_s, "cli_s": cli_s, "kept": {v: len(k) for v, k in kept.items()},
           "nan_audit": {"nr_of_times": int(stats[f"{var}_nr_of_times"]),
                         "which_times": stats[f"{var}_which_times"].tolist()},
           "repaired_finite": bool(np.isfinite(repaired.data_vars[var]).all()),
           "train_x_shape": list(x.shape), "train_x_finite": bool(np.isfinite(x).all()), "vars": x_vars,
           "test_hours": len(test_ds.time), "quantile_vars": sorted(quant.values)}
    want = {"kept": dict.fromkeys(PHYSICAL, 3), "nan_audit": {"nr_of_times": 1, "which_times": [hour]},
            "repaired_finite": True, "train_x_shape": [24, 4, *hw], "train_x_finite": True,
            "vars": sorted(PHYSICAL), "test_hours": 12, "quantile_vars": sorted(PHYSICAL)}
    wrong = {k: (rec[k], v) for k, v in want.items() if rec[k] != v}
    if wrong:
        raise AssertionError(f"the drill's files are wrong (got, want): {wrong}")
    # training on the file the drill wrote
    t_train = time.time()
    argv = ["--run-dir", root / "runs", "--run-id", "drill", "--train-data", proc / "train_normed.h5",
            "--spatial-res", hw[0], "--num-features", "4", "--markov-order", "1", "--model-config", model_config,
            "--lr", "1e-3", "--total-ndata", 16 * steps, "--batch", "16", "--batch-gpu", "16", "--status", "16",
            "--snapshot", "1024", "--checkpoint", "1024", "--logging", "16", "--valid", "0",
            "--seed", seed, "--device", device.type]
    (out,), train_s, _ = _run_processes([_blocked("path", REPO / "chip_smoke.py", "--child", "train", *argv)],
                                        [_child_env(device)], label="11b train")
    child = _child_result(out)
    lines = (root / "runs" / "drill" / "metrics.jsonl").read_text().splitlines()
    losses = [json.loads(ln)["train/loss"] for ln in lines if "train/loss" in json.loads(ln)]
    rec.update(train_s=train_s, train_wall_s=time.time() - t_train, losses=losses, train_launches=child["launches"],
               train_peak_bytes=child["peak_bytes"], train_steps=child["step"])
    emit("11b", t0, **rec)
    if len(losses) != steps or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"training on the drill's file: losses {losses}")
    return rec


def _quantile_error(ds, ref, levels=np.linspace(0.01, 0.99, 99)) -> dict:
    """Per variable, the mean distance of ``ds``'s quantiles from ``ref``'s
    over ``levels``, in units of ``ref``'s standard deviation."""
    return {v: float(np.mean(np.abs(np.quantile(ds.data_vars[v].astype(np.float64), levels)
                                    - np.quantile(r.astype(np.float64), levels))) / r.std())
            for v, r in ref.data_vars.items()}


def phase11c_synth_debias(root, device, res, hours, seed) -> dict:
    """``synth --spectrum mesoscale`` (train and eval hours cut to
    SYNTH_HOURS), a biased coarse "climate model" from the eval grid (16x
    block means every 6th hour, QM_BIAS), ``debias`` against the train grid
    coarsened the same way: every variable's debiased quantiles closer to the
    reference's than the biased ones, by QM_MARGIN."""
    from climate2weather_tpu_torch.data.grid import open_grid

    t0 = time.time()
    synth = root / "synth"
    train_h, eval_h = hours
    synth_s = _data_cli(device, "synth", "synth", "--out-dir", synth, "--train-hours", train_h, "--eval-hours", eval_h,
                        "--res", res, "--seed", seed, "--spectrum", "mesoscale")
    paths = {"model": root / "climate_model.nc", "reference": root / "reference_coarse.nc",
             "debiased": root / "debiased_qm.nc"}

    def coarse(path):
        ds = open_grid(str(path))
        return ds.coarsen_mean(16).isel_time(np.arange(0, len(ds.time), 6))

    model = coarse(synth / "eval_merged.nc").map(
        lambda k, v: (v * np.float32(QM_BIAS[k][0]) + np.float32(QM_BIAS[k][1])).astype(np.float32))
    model.to_file(str(paths["model"]))
    reference = coarse(synth / "train_merged.nc")
    reference.to_file(str(paths["reference"]))
    debias_s = _data_cli(device, "debias", "debias", "--model-path", paths["model"], "--reference-path",
                         paths["reference"], "--out-path", paths["debiased"])
    debiased = open_grid(str(paths["debiased"]))
    biased_err, debiased_err = _quantile_error(model, reference), _quantile_error(debiased, reference)
    rec = {"synth_s": synth_s, "debias_s": debias_s, "hours": {"train": train_h, "eval": eval_h},
           "model_frames": len(model.time), "reference_frames": len(reference.time),
           "quantile_error_biased": biased_err, "quantile_error_debiased": debiased_err, "margin": QM_MARGIN,
           "synth_bytes": sum(p.stat().st_size for p in synth.iterdir())}
    emit("11c", t0, **rec)
    if any(not debiased_err[v] <= QM_MARGIN * biased_err[v] for v in QM_BIAS):
        raise AssertionError(f"debiasing did not bring the quantiles {QM_MARGIN} of the way: {rec}")
    return {**rec, "paths": {k: str(v) for k, v in paths.items()}, "synth": str(synth)}


def phase11d_predict(root, snapshot_dir, device, synth_rec, steps, samples) -> dict:
    """``experiment predict`` (through ``--child predict``, which counts the
    attention launches) with the 72.1M snapshot at a copy of
    ``qm_debiased_climate_mpi.yml`` naming 11c's files, the observation the
    debiased file, 49 hours, DPM-Solver++(2M), with the confirmed setting's
    t=0 spectral projection (so A(x) = y): finite samples, the written
    observation the debiased file's frames, A(x) = y under phase 4's limit,
    6 attention launches per UNet forward on the card; then ``metrics run``
    on the written directory."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file

    t0 = time.time()
    synth = pathlib.Path(synth_rec["synth"])
    cfg = yaml_load_file(QM_CONFIG)
    cfg.update(model_path=str(snapshot_dir), data_path=str(synth / "eval_merged.nc"),
               quantile_path=str(synth / "quantiles.h5"), observation_path=synth_rec["paths"]["debiased"],
               num_hours=49, sampler_kind="dpmpp2m", num_sampling_steps=steps, num_samples=samples,
               t0_project="spectral", t0_project_iters=3)
    config_path = root / "qm_debiased.yml"
    yaml_dump_file(cfg, config_path)
    argv = ["predict", "--save-path", root / "predict", "--config-path", config_path, "--device", device.type]
    (out,), predict_s, _ = _run_processes([_blocked("path", REPO / "chip_smoke.py", "--child", "predict", *argv)],
                                          [_child_env(device)], label="11d predict")
    child = _child_result(out)
    out_dir = root / "predict" / sorted(p.name for p in (root / "predict").iterdir())[0]
    gens = [open_grid(str(out_dir / f"gen_sample_{i:03d}.nc")) for i in range(samples)]
    finite = all(bool(np.isfinite(v).all()) for g in gens for v in g.data_vars.values())
    consistency, tol = _written_consistency(out_dir, gens, cfg, cfg["quantile_path"])
    written, debiased = open_grid(str(out_dir / "observation.nc")), open_grid(synth_rec["paths"]["debiased"])
    frames = debiased.sel_time(written.time[0].astype("datetime64[s]").item(),
                               written.time[-1].astype("datetime64[s]").item())
    obs_err = max(float(np.abs(written.data_vars[v] - frames.data_vars[v]).max() / np.abs(frames.data_vars[v]).max())
                  for v in QM_BIAS)
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    expect = _attention_blocks(snap_cfg["network_kwargs"]) * _expected_forwards(cfg, 49, window) \
        if device.type == "cuda" else 0
    metrics = phase8d_metrics(out_dir, label="11d metrics")
    rec = {"predict_s": predict_s, "run_s": child["seconds"], "peak_bytes": child["peak_bytes"],
           "launches": child["launches"], "expected_attention_fwd": expect, "finite": finite,
           "A_x_minus_y_max": consistency, "A_tol": tol, "observation_frames": len(written.time),
           "observation_rel_err": obs_err, "metrics_scores": metrics["scores"], "metrics_s": metrics["metrics_s"],
           "outputs": sorted(p.name for p in out_dir.iterdir())}
    emit("11d", t0, **rec)
    if not finite or consistency > tol or child["launches"]["attention_fwd"] != expect:
        raise AssertionError(f"the guided predict from the debiased file failed its checks: {rec}")
    if len(written.time) != len(frames.time) or obs_err > 1e-6:
        raise AssertionError(f"the observation the run wrote is not the debiased file's: {rec}")
    return rec


def phase11_summary(data: dict) -> dict:
    """Phase 11's line: each step's seconds and sizes, and the launches."""
    b, c, d = data["11b"], data["11c"], data["11d"]
    return {"archive_bytes": b["archive_bytes"], "cli_s": b["cli_s"], "train_s": b["train_s"],
            "train_launches": b["train_launches"], "train_peak_bytes": b["train_peak_bytes"],
            "synth_s": c["synth_s"], "synth_bytes": c["synth_bytes"], "debias_s": c["debias_s"],
            "quantile_error_biased": c["quantile_error_biased"],
            "quantile_error_debiased": c["quantile_error_debiased"], "predict_s": d["predict_s"],
            "predict_run_s": d["run_s"], "predict_peak_bytes": d["peak_bytes"], "predict_launches": d["launches"],
            "A_x_minus_y_max": d["A_x_minus_y_max"], "metrics_s": d["metrics_s"],
            "loaded_before": data["loaded_before"]}


def phase11_data(snapshot_dir, device, model_config=REPO / "configs" / "tiny_unet.yml", nlat=473, nlon=500,
                 patch=((344, 472), (371, 499)), res=128, synth_hours=SYNTH_HOURS, seed=0, train_steps=4,
                 predict_steps=8, samples=3) -> dict:
    """Phase 11, 11a-11d (see the module docstring), in one scratch
    directory, with the packages of PHASE11_BLOCKED unimportable in this
    process and in every process it starts. 11c and then 11d run on a thread
    beside 11b (each is mostly its processes), so their seconds include each
    other's work. Returns each part's record."""
    import shutil
    import tempfile
    import threading

    loaded_before = sorted(m for m in PHASE11_BLOCKED if sys.modules.get(m) is not None)
    for name in PHASE11_BLOCKED:
        sys.modules[name] = None
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-data-"))
    try:
        a = phase11a_netcdf(root)
        beside = {}

        def run_cd():
            try:
                beside["c"] = phase11c_synth_debias(root, device, res, synth_hours, seed)
                beside["d"] = phase11d_predict(root, snapshot_dir, device, beside["c"], predict_steps, samples)
            except BaseException as e:  # noqa: BLE001 - raised again on this thread
                beside["error"] = e

        thread = threading.Thread(target=run_cd, daemon=True)
        thread.start()
        try:
            b = phase11b_drill(root, device, model_config, nlat, nlon, patch, seed, train_steps)
        finally:
            thread.join()
        if "error" in beside:
            raise beside["error"]
        c, d = beside["c"], beside["d"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"11a": a, "11b": b, "11c": c, "11d": d, "loaded_before": loaded_before}


# ---------------------------------------------------------------------------
# phase 12: the model layer made whole. The reference's released weight
# format imported on the card's host with the packages of PHASE12_BLOCKED
# unimportable (in this process from the phase on, and in the importer's
# process), the fused nearest-upsample tail, and the 1-D and 3-D nets.

PHASE12_BLOCKED = ("jax", "flax", "yaml", "msgpack", "h5py", "scripts", "climate2weather_tpu")
REFERENCE_PKL = "network-snapshot-0009437-0.999900.pkl"
DEFAULT_ARCH = {"noise_features": 32, "forcing_dim": 0}  # build_score_unet's defaults of keys a config may omit
# (spatial rank, input shape without channels): 64 tokens at level 4 in each
ND_CASES = ((1, (8, 1024)), (3, (2, 64, 64, 64)))
FUSED_SLACK = 2.0  # the fused tail's distance from float64 at most this times the plain tail's


def _fp16_rounded(tree):
    """A parameter tree with every leaf rounded through float16 (the
    reference's snapshot payload) back to float32."""
    return {k: _fp16_rounded(v) if isinstance(v, dict) else np.asarray(v).astype(np.float16).astype(np.float32)
            for k, v in tree.items()}


def _fixture_goldens(device) -> dict:
    """The committed reference pickles ``tests/fixtures/torch_snapshot_*.pkl``
    (made by the reference's code) through the port's importer in this
    torch, and the port's fp32 forward of each on ``device`` against the
    reference's own output ``torch_golden_*.npz`` at rtol/atol 2e-4 (the
    repository's bar): the largest error over that limit's scale."""
    from climate2weather_tpu_torch import import_reference_snapshot as importer

    out = {}
    for name in ("tiny", "prod"):
        sd, _ = importer.load_reference_snapshot(str(FIXTURES / f"torch_snapshot_{name}.pkl"))
        arch = importer.infer_architecture(sd)
        net = _built(arch, importer.convert_state_dict(sd, arch), torch.float32, device)
        golden = np.load(FIXTURES / f"torch_golden_{name}.npz")
        with torch.no_grad():
            got = net(torch.from_numpy(golden["x"]).to(device).movedim(1, -1),
                      torch.from_numpy(golden["t"]).to(device)).movedim(-1, 1).cpu().numpy()
        out[name] = float((np.abs(got - golden["out"]) / (2e-4 + 2e-4 * np.abs(golden["out"]))).max())
    return out


def phase12a_import(root, snapshot_dir, device) -> dict:
    """The committed reference pickles against their goldens
    (:func:`_fixture_goldens`); then the snapshot written as the reference's
    released pickle (fp16 EMA net, the reference's classes and names;
    ``tests/_reference_pickle.py``) and ``python -m
    climate2weather_tpu_torch.import_reference_snapshot`` on it in a process
    with the packages of PHASE12_BLOCKED unimportable: the inferred
    architecture the snapshot's plus ``norm_ddof: 1``, the parameter count,
    and every imported tensor equal, bit for bit, to the snapshot's rounded
    through float16."""
    sys.path.insert(0, str(REPO / "tests"))
    from _reference_pickle import write_reference_pickle
    from climate2weather_tpu_torch.convert import to_state_dict
    from climate2weather_tpu_torch.io.snapshot import load_snapshot

    t0 = time.time()
    goldens = _fixture_goldens(device)
    params, cfg = load_snapshot(str(snapshot_dir))
    nk, dk = cfg["network_kwargs"], cfg["dataset_kwargs"]["train"]
    pkl = root / REFERENCE_PKL
    t_write = time.time()
    nbytes = write_reference_pickle(pkl, to_state_dict(params), nk, {
        "class_name": "dataset.COSMODataset", "window": int(dk["window"]),
        "num_features": int(dk["num_features"]), "spatial_res": int(dk.get("spatial_res", 128))})
    write_s = time.time() - t_write
    out_dir = root / "imported" / pathlib.Path(snapshot_dir).name
    (out,), import_s, _ = _run_processes(
        [_blocked("module", "climate2weather_tpu_torch.import_reference_snapshot", "--snapshot", pkl, "--out",
                  out_dir, blocked=PHASE12_BLOCKED)], [_child_env(device)], label="12a import")
    imported, icfg = load_snapshot(str(out_dir))
    want_arch = {**DEFAULT_ARCH, **{k: v for k, v in nk.items() if k != "class_name"}, "norm_ddof": 1}
    got, want = to_state_dict(imported), to_state_dict(_fp16_rounded(params))
    n_params = sum(v.numel() for v in want.values())
    differ = sorted(k for k in want if k not in got or not torch.equal(got[k].view(torch.int32),
                                                                        want[k].view(torch.int32)))
    rec = {"fixture_golden_err_over_tol": goldens, "pickle_bytes": nbytes, "write_s": write_s,
           "import_s": import_s, "params": n_params,
           "tensors": len(want), "tensors_differ": differ, "extra_tensors": sorted(set(got) - set(want)),
           "architecture_equal": icfg["network_kwargs"] == want_arch, "norm_ddof": icfg["network_kwargs"]["norm_ddof"],
           "importer_said": [ln for ln in out.splitlines() if ln.startswith("Converted")],
           "snapshot": str(out_dir)}
    emit("12a", t0, **{k: v for k, v in rec.items() if k != "snapshot"})
    if any(e > 1.0 for e in goldens.values()):
        raise AssertionError(f"a committed reference pickle misses its golden output: {rec}")
    if differ or rec["extra_tensors"] or not rec["architecture_equal"]:
        raise AssertionError(f"the imported snapshot is not the fp16-rounded net: {rec} {icfg['network_kwargs']}")
    if rec["importer_said"] != [f"Converted {n_params / 1e6:.1f}M parameters"]:
        raise AssertionError(f"the importer did not report the net's size: {rec}")
    return rec


def _built(network_kwargs, weights, dtype, device):
    """A ScoreUNet of ``network_kwargs`` made on ``device`` and holding
    ``weights`` (a flax tree or a state dict), in eval mode without
    gradients."""
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    with torch.device(device):
        net = build_score_unet(network_kwargs, dtype=dtype)
    if any(isinstance(v, torch.Tensor) for v in weights.values()):
        net.load_state_dict(weights, strict=True)
    else:
        load_params(net, weights)
    return net.eval().requires_grad_(False)


def phase12b_forward(imported_dir, snapshot_dir, device, batch=96, res=128, seed=0) -> dict:
    """``load_net`` on the imported snapshot and one bf16 forward: equal, bit
    for bit, to the forward of a net built from the snapshot's fp16-rounded
    weights with ``norm_ddof: 1``, and 6 attention launches; the same
    weights with the snapshot's own ``norm_ddof: 0`` must differ (the
    check sees a dropped ddof)."""
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import load_snapshot
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    net, cfg = load_net(str(imported_dir), device)
    params, scfg = load_snapshot(str(snapshot_dir))
    rounded = _fp16_rounded(params)

    def built(ddof):
        return _built({**scfg["network_kwargs"], "norm_ddof": ddof}, rounded, torch.bfloat16, device)

    g = torch.Generator(device=device).manual_seed(seed)
    channels = int(cfg["network_kwargs"]["channels"])
    x = torch.randn((batch, res, res, channels), generator=g, device=device)
    t = torch.rand((batch,), generator=g, device=device)
    with torch.no_grad():
        if device.type == "cuda":
            torch.cuda.synchronize()
        for k in launch_counts:
            launch_counts[k] = 0
        out = net(x, t)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = launch_counts["attention_fwd"]
        want = built(1)(x, t)
        ddof0 = built(0)(x, t)
    expect = _attention_blocks(cfg["network_kwargs"]) if device.type == "cuda" else 0
    rec = {"shape": list(out.shape), "dtype": str(out.dtype), "finite": bool(torch.isfinite(out).all()),
           "bit_equal": torch.equal(out, want), "max_abs_diff": float((out.float() - want.float()).abs().max()),
           "ddof0_max_abs_diff": float((ddof0.float() - want.float()).abs().max()),
           "attention_fwd_launches": launches, "expected_launches": expect}
    emit("12b", t0, **rec)
    if not rec["finite"] or not rec["bit_equal"] or launches != expect:
        raise AssertionError(f"the imported net's forward is not the fp16-rounded net's: {rec}")
    if rec["ddof0_max_abs_diff"] == 0.0:
        raise AssertionError(f"the forward check cannot see norm_ddof: {rec}")
    return rec


def phase12c_predict(root, imported_dir, device, res=128, hours=49, steps=8, samples=3, seed=0) -> dict:
    """``experiment predict`` in this process with the imported snapshot, at
    a copy of ``s16_t6_spectral.yml`` naming it (49 hours, DPM-Solver++(2M),
    ``steps`` steps, ``samples`` samples) on phase 6's kind of files: finite
    samples, A(x) = y under phase 4's limit, 6 attention launches per UNet
    forward on the card."""
    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    (root / "inputs").mkdir()
    paths = write_predict_inputs(root / "inputs", res=res, hours=hours, seed=seed)
    cfg = yaml_load_file(CONFIG)
    cfg.update(model_path=str(imported_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], spectral_calibrate=paths["train"], num_hours=hours,
               num_sampling_steps=steps, num_samples=samples)
    config_path = root / "imported_predict.yml"
    yaml_dump_file(cfg, config_path)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in launch_counts:
        launch_counts[k] = 0
    t_run = time.time()
    experiment.main(["predict", "--save-path", str(root / "predict"), "--config-path", str(config_path),
                     "--device", device.type])
    if device.type == "cuda":
        torch.cuda.synchronize()
    predict_s = time.time() - t_run
    launches = launch_counts["attention_fwd"]
    snap_cfg = yaml_load_file(pathlib.Path(imported_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    expect = _attention_blocks(snap_cfg["network_kwargs"]) * _expected_forwards(cfg, hours, window) \
        if device.type == "cuda" else 0
    (out_dir,) = [p for p in (root / "predict").iterdir() if p.is_dir()]
    gens = [open_grid(str(out_dir / f"gen_sample_{i:03d}.nc")) for i in range(samples)]
    finite = all(bool(np.isfinite(v).all()) for gen in gens for v in gen.data_vars.values())
    consistency, tol = _written_consistency(out_dir, gens, cfg, paths["quantiles"])
    rec = {"predict_s": predict_s, "inputs_s": t_run - t0, "attention_fwd_launches": launches,
           "expected_launches": expect, "finite": finite, "A_x_minus_y_max": consistency, "A_tol": tol,
           "outputs": sorted(p.name for p in out_dir.iterdir())}
    emit("12c", t0, **rec)
    if not finite or consistency > tol or launches != expect:
        raise AssertionError(f"the guided predict from the imported snapshot failed its checks: {rec}")
    return {**rec, "out_dir": str(out_dir)}


def phase12d_fused(snapshot_dir, device, batch=8, timed_batch=96, res=128, seed=0, reps=5) -> dict:
    """The snapshot with ``fused_upsample`` off and on, same parameters: in
    fp32 (TF32 off) at ``batch``, each against a float64 forward of the same
    batch (every conv, norm and attention in float64), the fused net no
    farther from it than FUSED_SLACK times the plain one, in max and mean;
    then both bf16 forwards at ``timed_batch`` timed with CUDA events."""
    from climate2weather_tpu_torch.io.snapshot import load_snapshot
    from climate2weather_tpu_torch.models import unet

    t0 = time.time()
    params, cfg = load_snapshot(str(snapshot_dir))
    nk = cfg["network_kwargs"]

    def built(dtype, fused):
        return _built({**nk, "fused_upsample": fused}, params, dtype, device)

    g = torch.Generator(device=device).manual_seed(seed)
    channels = int(nk["channels"])
    x = torch.randn((batch, res, res, channels), generator=g, device=device)
    t = torch.rand((batch,), generator=g, device=device)
    with torch.no_grad():
        plain = built(torch.float32, False)(x, t)
        fused_net = built(torch.float32, True)
        fused = fused_net(x, t)
        n_fused = sum(isinstance(m, unet.NearestUpConv2x) for m in fused_net.modules())
        del fused_net
        real = unet.fused_channel_norm, unet.fused_attention
        unet.fused_channel_norm, unet.fused_attention = _fused_norm_f64, _attention_f64
        try:
            ref = built(torch.float64, False)(x, t)
        finally:
            unet.fused_channel_norm, unet.fused_attention = real
    (p_max, p_mean), (f_max, f_mean) = _diff(plain, ref), _diff(fused, ref)
    rec = {"fp32_batch": batch, "fused_tails": n_fused, "plain_vs_f64": [p_max, p_mean],
           "fused_vs_f64": [f_max, f_mean], "fused_vs_plain": list(_diff(fused, plain)),
           "out_scale": float(ref.abs().max()), "slack": FUSED_SLACK,
           "tf32": torch.backends.cudnn.allow_tf32 if device.type == "cuda" else None}
    if device.type == "cuda":
        xb = torch.randn((timed_batch, res, res, channels), generator=g, device=device)
        tb = torch.rand((timed_batch,), generator=g, device=device)
        nets = {"plain": built(torch.bfloat16, False), "fused": built(torch.bfloat16, True)}
        with torch.no_grad():
            outs = {k: n(xb, tb) for k, n in nets.items()}
            rec["bf16_fused_vs_plain"] = list(_diff(outs["fused"], outs["plain"]))
            times = {k: [] for k in nets}
            for _ in range(2):  # plain, fused, plain, fused
                for k, n in nets.items():
                    times[k].append(cuda_time_ms(lambda n=n: n(xb, tb), reps=reps, warmup=1))
        rec.update(bf16_shape=list(xb.shape), forward_plain_ms=times["plain"], forward_fused_ms=times["fused"])
        del nets, outs
    emit("12d", t0, **rec)
    if n_fused != len(nk["hidden_channels"]) - 1:
        raise AssertionError(f"fused_upsample built {n_fused} fused tails: {rec}")
    if f_max > FUSED_SLACK * p_max or f_mean > FUSED_SLACK * p_mean:
        raise AssertionError(f"the fused tail is farther from float64 than the plain one allows: {rec}")
    return rec


def _layout(x: torch.Tensor) -> str:
    """The memory layout of a conv's input: channels innermost or not."""
    if x.dim() >= 4 and x.is_contiguous(memory_format=(torch.channels_last, torch.channels_last_3d)[x.dim() - 4]):
        return "channels_last" if x.dim() == 4 else "channels_last_3d"
    if x.dim() == 3 and x.stride(1) == 1 and x.shape[1] > 1:
        return "channels_last"
    return "contiguous" if x.is_contiguous() else "strided"


def phase12e_nd(device, model_config=MODEL_CONFIG, cases=ND_CASES, channels=52, seed=0) -> dict:
    """A 1-D and a 3-D ScoreUNet at the widths of ``model_config`` (flax-style
    init from the seed), one bf16 forward and backward each: finite outputs
    and gradients, 6 forward and 6 backward attention launches each, every
    launch against the plain version on its own inputs under phase 2's
    limits (one bf16 ulp; a dropped key and a dropped row sum outside), the
    layout each level's convs see, peak memory and seconds."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.models.init import init_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.ops import attention

    t0 = time.time()
    nk = {**yaml_load_file(model_config), "channels": channels}
    records = {}
    for spatial, shape in cases:
        t_case = time.time()
        net = build_score_unet({**nk, "spatial": spatial}).to(device)
        init_params(net, torch.Generator(device=device).manual_seed(seed))
        layouts, hooks = {}, []

        def seen(name):
            def hook(module, args):
                layouts.setdefault(name, _layout(args[0]))
            return hook

        for name, m in net.unet.named_children():
            if name.startswith(("head", "tail")) or name.endswith("_block0"):
                conv = m.conv0 if name.endswith("_block0") else m
                hooks.append(conv.register_forward_pre_hook(seen(name)))
        g = torch.Generator(device=device).manual_seed(seed + spatial)
        x = torch.randn((*shape, channels), generator=g, device=device)
        t = torch.rand((shape[0],), generator=g, device=device)
        w = torch.randn((*shape, channels), generator=g, device=device)
        calls = {"fwd": [], "bwd": []}
        real_fwd, real_bwd = attention.attention_fwd, attention.attention_bwd

        def rec_fwd(q, k, v):
            out = real_fwd(q, k, v)
            calls["fwd"].append((q.detach(), k.detach(), v.detach(), out.detach()))
            return out

        def rec_bwd(q, k, v, do):
            out = real_bwd(q, k, v, do)
            calls["bwd"].append((q.detach(), k.detach(), v.detach(), do.detach(), [o.detach() for o in out]))
            return out

        _peak_reset(device)
        for k in attention.launch_counts:
            attention.launch_counts[k] = 0
        attention.attention_fwd, attention.attention_bwd = rec_fwd, rec_bwd
        try:
            t_run = time.time()
            out = net(x, t)
            (out.float() * w).sum().backward()
            if device.type == "cuda":
                torch.cuda.synchronize()
            run_s = time.time() - t_run
        finally:
            attention.attention_fwd, attention.attention_bwd = real_fwd, real_bwd
            for h in hooks:
                h.remove()
        launches = dict(attention.launch_counts)
        peak = _peak(device)
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())
        fwd_checks, bwd_checks = [], []
        for q, k, v, got in calls["fwd"]:
            want = attention.attention_reference(q, k, v).float()
            tol = bf16_ulp(float(want.abs().max()))
            fwd_checks.append({"shape": list(q.shape), "max_abs_err": float((got.float() - want).abs().max()),
                               "tol": tol, "key_dropped_err": float((_key_dropped(q, k, v).float() - want).abs().max())})
        for q, k, v, do, got in calls["bwd"]:
            want = attention.attention_bwd_reference(q, k, v, do)
            errs, scales = _grads_err(got, want)
            fault, _ = _grads_err(_rowsum_dropped(q, k, v, do), want)
            bwd_checks.append({"shape": list(q.shape), "max_abs_err": errs, "tol": _bwd_tols(scales, q.dtype),
                               "rowsum_dropped_err": fault})
        expect = _attention_blocks(nk) if device.type == "cuda" else 0
        rec = {"spatial": spatial, "input": [*shape, channels], "params": sum(p.numel() for p in net.parameters()),
               "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all()), "grads_finite": grads_finite,
               "launches": launches, "expected_each_way": expect, "run_s": run_s,
               "case_s": time.time() - t_case, "peak_bytes": peak, "conv_input_layouts": layouts,
               "fwd_checks": fwd_checks, "bwd_checks": bwd_checks}
        records[spatial] = rec
        del net, out, calls
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if not rec["finite"] or not grads_finite or rec["out_shape"] != [*shape, channels]:
            raise AssertionError(f"the {spatial}-D net's forward or gradients failed: {rec}")
        if launches["attention_fwd"] != expect or launches["attention_bwd"] != expect:
            raise AssertionError(f"the {spatial}-D net launched {launches}, want {expect} each way: {rec}")
        if len(fwd_checks) != _attention_blocks(nk) or len(bwd_checks) != _attention_blocks(nk):
            raise AssertionError(f"the {spatial}-D net's attention calls were not all checked: {rec}")
        for c in fwd_checks:
            if c["max_abs_err"] > c["tol"] or c["key_dropped_err"] <= c["tol"]:
                raise AssertionError(f"a forward attention launch of the {spatial}-D net disagrees: {c}")
        for c in bwd_checks:
            if any(e > tl for e, tl in zip(c["max_abs_err"], c["tol"])) or \
                    c["rowsum_dropped_err"][0] <= c["tol"][0] or c["rowsum_dropped_err"][1] <= c["tol"][1]:
                raise AssertionError(f"a backward attention launch of the {spatial}-D net disagrees: {c}")
    emit("12e", t0, **{f"{s}d": r for s, r in records.items()})
    return records


def phase12_summary(model: dict) -> dict:
    """Phase 12's line: each step's seconds and sizes, and the launches."""
    a, b, c, d, e = (model[k] for k in ("12a", "12b", "12c", "12d", "12e"))
    return {"pickle_bytes": a["pickle_bytes"], "pickle_write_s": a["write_s"], "import_s": a["import_s"],
            "params": a["params"], "forward_bit_equal": b["bit_equal"],
            "forward_launches": b["attention_fwd_launches"], "predict_s": c["predict_s"],
            "predict_launches": c["attention_fwd_launches"], "A_x_minus_y_max": c["A_x_minus_y_max"],
            "fused_vs_f64": d["fused_vs_f64"], "plain_vs_f64": d["plain_vs_f64"],
            "forward_plain_ms": d.get("forward_plain_ms"), "forward_fused_ms": d.get("forward_fused_ms"),
            "nd": {f"{s}d": {k: r[k] for k in ("input", "params", "launches", "run_s", "peak_bytes",
                                             "conv_input_layouts")} for s, r in e.items()},
            "loaded_before": model["loaded_before"]}


def phase12_model(snapshot_dir, device, res=128, batch=96, fused_batch=8, predict_steps=8, samples=3,
                  model_config=MODEL_CONFIG, nd_cases=ND_CASES, seed=0, keep_predict=None) -> dict:
    """Phase 12, 12a-12e (see the module docstring), in one scratch
    directory, with the packages of PHASE12_BLOCKED unimportable in this
    process and in the importer's. Returns each part's record; 12c's
    experiment directory is moved to ``keep_predict`` where one is given
    (phase 13 compares its figure data with it)."""
    import shutil
    import tempfile

    loaded_before = sorted(m for m in PHASE12_BLOCKED if sys.modules.get(m) is not None)
    for name in PHASE12_BLOCKED:
        sys.modules[name] = None
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-model-"))
    try:
        a = phase12a_import(root, snapshot_dir, device)
        b = phase12b_forward(a["snapshot"], snapshot_dir, device, batch=batch, res=res, seed=seed)
        c = phase12c_predict(root, a["snapshot"], device, res=res, steps=predict_steps, samples=samples, seed=seed)
        d = phase12d_fused(snapshot_dir, device, batch=fused_batch, timed_batch=batch, res=res, seed=seed)
        e = phase12e_nd(device, model_config=model_config, cases=nd_cases, seed=seed)
        if keep_predict is not None:
            shutil.move(c["out_dir"], str(keep_predict))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"12a": a, "12b": b, "12c": c, "12d": d, "12e": e, "loaded_before": loaded_before}


# ---------------------------------------------------------------------------
# phase 13: fill values in the HDF5 reader, the zarr store with its blosc
# codec, and the paper's figure data, on the card's host; a guided predict
# from zarr stores on the card. From the phase on, the packages of
# PHASE13_BLOCKED are unimportable in this process and in the processes it
# starts.

PHASE13_BLOCKED = ("jax", "flax", "h5py", "scipy", "matplotlib", "PIL", "click", "zarr", "numcodecs", "xarray",
                   "climate2weather_tpu")
FILL_VALUE = np.float32(9.96921e36)  # netCDF-C's default float fill, the fixtures' fill value
ZARR_COMPRESSORS = ("zlib", "blosc-lz4", "none")


def _bits_equal(got, want) -> bool:
    """Equal shapes, dtypes and bytes; a compound's members compared (the
    bytes between them hold no data)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype.names:
        return all(_bits_equal(got[n], want[n]) for n in got.dtype.names)
    return got.tobytes() == want.tobytes()


def _tree_bytes(root: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def phase13a_fill() -> dict:
    """The committed partly written fixtures ``tests/fixtures/fill_{latest,earliest}.nc``
    (extensible-array, fixed-array and version-1 B-tree chunk indexes, a
    contiguous dataset never written; written by h5py) through
    ``io.hdf5.File``: every dataset equal to ``fill_contents.npz`` bit for
    bit, the unwritten storage the fill value; through ``open_grid``: NaN
    exactly where the goldens hold the fill value."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io import hdf5

    t0 = time.time()
    goldens = np.load(FIXTURES / "fill_contents.npz")
    rec = {}
    for libver in ("latest", "earliest"):
        path = FIXTURES / f"fill_{libver}.nc"
        with hdf5.File(path) as f:
            equal = {k: _bits_equal(f[k][()], goldens[f"{libver}/{k}"]) for k in f.keys()}
            fills = {k: None if f[k].fillvalue is None else float(f[k].fillvalue) for k in f.keys()}
        ds = open_grid(str(path))
        nan_where_fill = {v: bool((np.isnan(x) == (goldens[f"{libver}/{v}"] == FILL_VALUE)).all())
                          for v, x in ds.data_vars.items()}
        unwritten = {v: int((goldens[f"{libver}/{v}"] == FILL_VALUE).all(axis=(1, 2)).sum()) for v in ds.data_vars}
        rec[libver] = {"equal": equal, "fill_values": fills, "nan_where_fill": nan_where_fill,
                       "unwritten_frames": unwritten, "bytes": path.stat().st_size}
    emit("13a", t0, **rec)
    for libver, r in rec.items():
        if len(r["equal"]) != 7 or not all(r["equal"].values()) or not all(r["nan_where_fill"].values()) \
                or not any(r["unwritten_frames"].values()) or r["fill_values"]["tas"] != float(FILL_VALUE):
            raise AssertionError(f"the {libver} fill-value fixture did not read as its goldens: {r}")
    return rec


def _golden_chunks() -> dict:
    """The public-spec blosc chunks of ``tests/test_blosc.py``: (chunk,
    payload) of a memcpy chunk, an all-literals LZ4 stream, and a match
    whose offset is below its length."""
    import struct

    def header(flags, typesize, nbytes, blocksize, cbytes):
        return bytes([2, 1, flags, typesize]) + struct.pack("<III", nbytes, blocksize, cbytes)

    def one_stream(stream, payload):
        return (header(1 << 5, 1, len(payload), len(payload), 24 + len(stream)) + struct.pack("<I", 20)
                + struct.pack("<I", len(stream)) + stream, payload)

    return {"memcpy": (header(0x2 | (1 << 5), 1, 8, 8, 24) + bytes(range(8)), bytes(range(8))),
            "literals": one_stream(bytes([8 << 4]) + b"abcdefgh", b"abcdefgh"),
            "match": one_stream(bytes([0x44]) + b"abab" + struct.pack("<H", 2), b"abab" + b"ab" * 4)}


def phase13b_stores(root) -> dict:
    """The codec built anew by the host C++ compiler (its name and seconds);
    the golden chunks decoded; the committed JAX-written stores
    ``tests/fixtures/jax_{zlib,blosc-lz4,none}.zarr`` (the last with a
    missing chunk) read equal to ``zarr_contents.npz`` bit for bit; the same
    grid written by the port into files byte-equal to the fixtures'; a
    corrupted byte of a blosc chunk raising an error that names the store
    and the chunk."""
    import shutil
    import struct

    from climate2weather_tpu_torch.data import native_blosc, zarr_store
    from climate2weather_tpu_torch.data.grid import GridDataset, open_grid

    t0 = time.time()
    native_blosc.load(rebuild=True)
    build = {k: native_blosc.build_info[k] for k in ("compiler", "version", "command", "seconds")}
    print(f"blosc codec built by {build['version']} ({build['compiler']}) in {build['seconds']:.3f} s", flush=True)
    goldens = {k: native_blosc.decompress(chunk) == payload for k, (chunk, payload) in _golden_chunks().items()}
    contents = np.load(FIXTURES / "zarr_contents.npz")
    reads, writes, timing = {}, {}, {}
    for comp in ZARR_COMPRESSORS:
        store = FIXTURES / f"jax_{comp}.zarr"
        t_read = time.time()
        ds = open_grid(str(store))
        timing[f"read_{comp}_s"] = time.time() - t_read
        reads[comp] = {v: _bits_equal(ds.data_vars[v], contents[f"{comp}/{v}"]) for v in ds.var_names()}
        reads[comp]["time"] = _bits_equal(ds.time, contents[f"{comp}/time"])
        grid = GridDataset({v: contents[v] for v in ds.var_names()}, dict(ds.coords), dict(ds.attrs))
        out = root / f"port_{comp}.zarr"
        t_write = time.time()
        zarr_store.write_zarr(grid, str(out), compressor=comp)
        timing[f"write_{comp}_s"] = time.time() - t_write
        want = {str(p.relative_to(store)): p.read_bytes() for p in store.rglob("*") if p.is_file()}
        got = {str(p.relative_to(out)): p.read_bytes() for p in out.rglob("*") if p.is_file()}
        writes[comp] = {"files": len(want), "extra": sorted(set(got) - set(want)),
                        "differ": sorted(k for k in want if got.get(k) != want[k]), "bytes": _tree_bytes(store)}
    bad = root / "corrupt.zarr"
    shutil.copytree(FIXTURES / "jax_blosc-lz4.zarr", bad)
    chunk = bad / "tas" / "0.0.0"
    raw = bytearray(chunk.read_bytes())
    raw[struct.unpack_from("<I", raw, 16)[0] + 3] ^= 0x40  # its first stream's size, past the chunk's end
    chunk.write_bytes(bytes(raw))
    try:
        open_grid(str(bad))
        corrupt = "no error"
    except ValueError as e:
        corrupt = str(e)
    rec = {"build": build, "goldens": goldens, "reads": reads, "writes": writes, "corrupt_error": corrupt, **timing}
    emit("13b", t0, **rec)
    if not all(goldens.values()) or not all(all(r.values()) and len(r) == 5 for r in reads.values()):
        raise AssertionError(f"a golden chunk or a JAX-written store did not read bit for bit: {rec}")
    if any(w["differ"] or w["extra"] not in ([], ["tas/1.0.0"]) for w in writes.values()) \
            or writes["none"]["extra"] != ["tas/1.0.0"]:
        raise AssertionError(f"the port's stores are not byte-equal to the JAX package's: {rec}")
    if str(bad) not in corrupt or str(chunk) not in corrupt or "blosc decompress failed" not in corrupt:
        raise AssertionError(f"a corrupted blosc chunk did not raise naming the store and the chunk: {rec}")
    return rec


def _normed_inputs(path, cfg) -> np.ndarray:
    """The [C, L, H, W] normalized grid ``exp/downscaling.run`` loads from
    ``path`` for ``cfg``."""
    from climate2weather_tpu_torch.data import pipeline

    names = sorted(cfg["data_vars"])
    ds = pipeline.load_processed(str(path), names, str(cfg["start_time"]), int(cfg["num_hours"]))
    return pipeline.ds_to_sorted_np(pipeline.normalize_ds(ds, cfg["quantile_path"], cfg["data_norm_mode"]), names)


def phase13c_predict(root, snapshot_dir, device, res=128, hours=49, steps=8, samples=3, seed=0) -> dict:
    """Phase 6's ground truth written to a blosc-lz4 store by ``write_zarr``
    and its coarse observation to a zlib store by ``python -m
    climate2weather_tpu_torch.data.cli select-dates`` (a ``.zarr`` output);
    the normalized inputs loaded from the stores equal those from the
    ``.nc`` files bit for bit; ``experiment.main(["predict", ...])`` in this
    process at a copy of ``s16_t6_spectral.yml`` naming the stores (49 hours,
    DPM-Solver++(2M), ``steps`` steps, ``samples`` samples): finite samples,
    A(x) = y under phase 4's limit, 6 attention launches per UNet forward on
    the card; then ``metrics run``: finite scores."""
    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.data import zarr_store
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    (root / "inputs").mkdir()
    paths = write_predict_inputs(root / "inputs", res=res, hours=hours, seed=seed)
    t_stores = time.time()
    stores = {"data": root / "merged-allvars.zarr", "obs": root / "observation-coarse.zarr"}
    zarr_store.write_zarr(open_grid(paths["data"]), str(stores["data"]), compressor="blosc-lz4")
    obs_nc = open_grid(paths["obs"])
    span = [str(t.astype("datetime64[h]")).replace("T", "-") for t in (obs_nc.time[0], obs_nc.time[-1])]
    _, select_s, _ = _run_processes([_blocked("module", "climate2weather_tpu_torch.data.cli", "select-dates",
                                              "--in-path", paths["obs"], "--out-path", stores["obs"],
                                              "--start", span[0], "--end", span[1], blocked=PHASE13_BLOCKED)],
                                    [_child_env(device)], label="13c select-dates")
    stores_s = time.time() - t_stores
    compressors = {k: json.loads((v / "tas" / ".zarray").read_text())["compressor"]["id"] for k, v in stores.items()}
    cfg = yaml_load_file(CONFIG)
    cfg.update(model_path=str(snapshot_dir), data_path=str(stores["data"]), quantile_path=paths["quantiles"],
               observation_path=str(stores["obs"]), spectral_calibrate=paths["train"], num_hours=hours,
               num_sampling_steps=steps, num_samples=samples)
    inputs_equal = {k: _bits_equal(_normed_inputs(stores[k], cfg), _normed_inputs(paths[k], cfg))
                    for k in ("data", "obs")}
    config_path = root / "zarr_predict.yml"
    yaml_dump_file(cfg, config_path)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in launch_counts:
        launch_counts[k] = 0
    t_run = time.time()
    experiment.main(["predict", "--save-path", str(root / "predict"), "--config-path", str(config_path),
                     "--device", device.type])
    if device.type == "cuda":
        torch.cuda.synchronize()
    predict_s = time.time() - t_run
    launches = launch_counts["attention_fwd"]
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    expect = _attention_blocks(snap_cfg["network_kwargs"]) * _expected_forwards(cfg, hours, window) \
        if device.type == "cuda" else 0
    (out_dir,) = [p for p in (root / "predict").iterdir() if p.is_dir()]
    gens = [open_grid(str(out_dir / f"gen_sample_{i:03d}.nc")) for i in range(samples)]
    finite = all(bool(np.isfinite(v).all()) for gen in gens for v in gen.data_vars.values())
    consistency, tol = _written_consistency(out_dir, gens, cfg, paths["quantiles"])
    metrics = phase8d_metrics(out_dir, label="13c metrics")
    rec = {"predict_s": predict_s, "inputs_s": t_stores - t0, "stores_s": stores_s, "select_dates_s": select_s,
           "store_bytes": {k: _tree_bytes(v) for k, v in stores.items()},
           "nc_bytes": {k: os.path.getsize(paths[k]) for k in stores}, "compressors": compressors,
           "inputs_equal": inputs_equal, "attention_fwd_launches": launches, "expected_launches": expect,
           "finite": finite, "A_x_minus_y_max": consistency, "A_tol": tol, "metrics_scores": metrics["scores"],
           "metrics_s": metrics["metrics_s"], "outputs": sorted(p.name for p in out_dir.iterdir())}
    emit("13c", t0, **rec)
    if compressors != {"data": "blosc", "obs": "zlib"} or not all(inputs_equal.values()):
        raise AssertionError(f"the stores did not load the .nc files' inputs bit for bit: {rec}")
    if not finite or consistency > tol or launches != expect:
        raise AssertionError(f"the guided predict from zarr stores failed its checks: {rec}")
    return {**rec, "out_dir": str(out_dir)}


def _figure_shapes(kind: str, data, S: int, T: int, To: int, hw: tuple, ohw: tuple) -> dict:
    """(got, want) shapes of the arrays the drawing of ``kind`` takes."""
    per_var = {
        "kde_and_pmf": lambda d: {"grid": (256,), "kde_gt": (256,), "kde_samples": (256,),
                                  "kde_members": (min(S, 5), 256), "bins": (80,), "hist_gt": (79,),
                                  "hist_samples": (79,)},
        "rapsd": lambda d: {"gt": d["freq"].shape, "samples": d["freq"].shape, "interp_obs": d["freq"].shape},
        "calibration": lambda d: {"freq": (S + 1,), "spread_skill": (To,)},
        "big_grid": lambda d: {"gt": (min(8, T), *hw), "sample": (min(8, T), *hw)},
    }
    whole = {
        "timeseries": lambda d: {"t_gt": (T,), "t_obs": (To,), **{
            f"{v}/{k}": (To if k == "obs" else T,) for v in d["vars"] for k in d["vars"][v]}},
        "storm_grid": lambda d: {"obs": (6, *ohw), "gt": (6, *hw), "samples": (min(S, 3), 6, *hw)},
        "climate_grid": lambda d: {"obs": (min(5, To), *ohw), "samples": (min(S, 3), min(5, To), *hw)},
        "windpower": lambda d: {"t": (T,), "ens": (S, T), "gt": (T,)},
        "windpower_dist": lambda d: {"grid": (256,), "kde_gt": (256,), "kde_samples": (256,),
                                     "kde_members": (min(S, 5), 256), "hist_gt": (59,), "hist_samples": (59,)},
    }

    def get(d, key):
        for part in key.split("/"):
            d = d["vars"][part] if "vars" in d and part in d["vars"] else d[part]
        return tuple(np.shape(d))

    if kind in per_var:
        want = {f"{v}/{k}": s for v, d in data.items() for k, s in per_var[kind](d).items()}
    else:
        want = whole[kind](data)
    return {k: get(data, k) for k in want}, want


def _all_finite(x) -> bool:
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_all_finite(v) for v in x)
    if isinstance(x, np.ndarray) and x.dtype.kind == "f":
        return bool(np.isfinite(x).all())
    return True


def phase13d_figures(exp_dir, compare_dir) -> dict:
    """Every kind of ``figures.KINDS`` computed from 13c's directory, and
    ``downscaled_clim_dist`` against ``compare_dir``: finite, in the shapes
    the drawing takes, each kind's seconds; then ``experiment figures
    kde_and_pmf`` refusing with an error that names matplotlib, writing no
    file."""
    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.exp import exputil, figures

    t0 = time.time()
    samples, gt, obs = exputil.setup(str(exp_dir))
    S, T, To = len(samples), gt.sizes["time"], obs.sizes["time"]
    hw, ohw = (gt.sizes["rlat"], gt.sizes["rlon"]), (obs.sizes["rlat"], obs.sizes["rlon"])
    kinds, seconds = {}, {}
    for kind in figures.KINDS:
        t_kind = time.time()
        data = figures.kind_data(kind, samples, gt, obs)
        seconds[kind] = time.time() - t_kind
        got, want = _figure_shapes(kind, data, S, T, To, hw, ohw)
        kinds[kind] = {"finite": _all_finite(data), "shapes_ok": got == want, "arrays": len(want)}
    t_kind = time.time()
    clim = figures.figure_data("downscaled_clim_dist", str(exp_dir), [str(compare_dir)])
    seconds["downscaled_clim_dist"] = time.time() - t_kind
    kinds["downscaled_clim_dist"] = {"finite": _all_finite(clim), "arrays": len(clim),
                                     "shapes_ok": all(d["kde"].shape == (2, 256) for d in clim.values())}
    try:
        experiment.main(["figures", "kde_and_pmf", str(exp_dir)])
        refusal = "no error"
    except ImportError as e:
        refusal = str(e)
    written = sorted(p.name for p in pathlib.Path(exp_dir).iterdir())
    rec = {"kinds": kinds, "kind_seconds": seconds, "members": S, "frames": T, "compare_dir": str(compare_dir),
           "refusal": refusal, "figures_dir_written": "figures" in written}
    emit("13d", t0, **rec)
    if not all(k["finite"] and k["shapes_ok"] for k in kinds.values()) or len(kinds) != len(figures.KINDS) + 1:
        raise AssertionError(f"a figure kind's data is not finite or not in the drawing's shapes: {rec}")
    if "matplotlib" not in refusal or rec["figures_dir_written"]:
        raise AssertionError(f"drawing without matplotlib did not refuse cleanly: {rec}")
    return rec


def phase13e_summary(snapshot_dir) -> dict:
    """``print_module_summary`` of the 72.1M net (built on the meta device:
    shapes only), its total the snapshot's parameter count."""
    from climate2weather_tpu_torch.io.snapshot import load_snapshot
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.utils.summary import param_counts, print_module_summary

    t0 = time.time()
    params, cfg = load_snapshot(str(snapshot_dir))

    def leaves(tree):
        return sum(leaves(v) if isinstance(v, dict) else int(np.asarray(v).size) for v in tree.values())

    with torch.device("meta"):
        net = build_score_unet(cfg["network_kwargs"])
    total = print_module_summary(net, name="score_unet")
    rec = {"total": total, "snapshot_params": leaves(params), "groups": len(param_counts(net))}
    emit("13e", t0, **rec)
    if total != rec["snapshot_params"]:
        raise AssertionError(f"the summary's total is not the snapshot's parameter count: {rec}")
    return rec


def phase13_summary(store: dict) -> dict:
    """Phase 13's line: each step's seconds and sizes, and the launches."""
    b, c, d = store["13b"], store["13c"], store["13d"]
    return {"codec_build_s": b["build"]["seconds"], "compiler": b["build"]["version"],
            "store_read_s": {k: b[f"read_{k}_s"] for k in ZARR_COMPRESSORS},
            "store_write_s": {k: b[f"write_{k}_s"] for k in ZARR_COMPRESSORS},
            "predict_s": c["predict_s"], "stores_s": c["stores_s"], "store_bytes": c["store_bytes"],
            "nc_bytes": c["nc_bytes"], "predict_launches": c["attention_fwd_launches"],
            "A_x_minus_y_max": c["A_x_minus_y_max"], "figure_data_s": d["kind_seconds"],
            "summary_total": store["13e"]["total"], "loaded_before": store["loaded_before"]}


def phase13_store(snapshot_dir, device, res=128, hours=49, steps=8, samples=3, seed=0, compare_dir=None,
                  summary_snapshot=SNAPSHOT) -> dict:
    """Phase 13, 13a-13e (see the module docstring), in one scratch
    directory, with the packages of PHASE13_BLOCKED unimportable in this
    process and in the one it starts. ``compare_dir`` is the experiment
    directory ``downscaled_clim_dist`` compares 13c's with (12c's on the
    full run; 13c's own where none is given). Returns each part's record."""
    import shutil
    import tempfile

    loaded_before = sorted(m for m in PHASE13_BLOCKED if sys.modules.get(m) is not None)
    for name in PHASE13_BLOCKED:
        sys.modules[name] = None
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-store-"))
    try:
        a = phase13a_fill()
        b = phase13b_stores(root)
        c = phase13c_predict(root, snapshot_dir, device, res=res, hours=hours, steps=steps, samples=samples,
                             seed=seed)
        d = phase13d_figures(c["out_dir"], compare_dir or c["out_dir"])
        e = phase13e_summary(summary_snapshot)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"13a": a, "13b": b, "13c": c, "13d": d, "13e": e, "loaded_before": loaded_before}


# ---------------------------------------------------------------------------
# phase 14: the host-streaming tier (diffusion/host_stream.py): the
# trajectory in host memory, window chunks of the 72.1M net on the card

STREAM_HOURS = (523, 140)  # 511 windows in 4 chunks of 128 (the last shifted back); 128 windows, one chunk
STREAM_BATCH = 128  # windows a chunk, the year config's batch_size
STREAM_STEPS = (4, 2)  # 14b's steps; 14c's
# 14b-fp32's frames and windows a chunk: 21 windows in 3 chunks of 8, the
# last shifted back (the fp32 net takes ~10x the bf16 one's time)
STREAM_EXACT = (33, 8)
STREAM_T = 0.5  # the time of 14a's eps
# 14b-fp32's limit: the JAX package's host-against-device bar in the
# sample's standard deviations (tests/test_host_stream.py:129-130, an fp32
# net)
JAX_BAR = 5e-3


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _host_peak(fn):
    """``(fn(), growth)``: the largest resident set seen while ``fn`` ran
    (sampled every 5 ms), less the one before it, in bytes."""
    import threading

    before, peak, stop = _rss_bytes(), [0], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], _rss_bytes())
            time.sleep(0.005)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        stop.set()
        th.join()
    return out, max(peak[0], _rss_bytes()) - before


def _chunk_off_by_one(chunk: int, *args, **kwargs):
    """14a's planted fault: a ``HostStreamingScoreFn`` that stages the frames
    of chunk ``chunk`` one frame late."""
    from climate2weather_tpu_torch.diffusion.host_stream import HostStreamingScoreFn

    class OffByOne(HostStreamingScoreFn):
        def _upload(self, x, start, stage):
            return super()._upload(x, start + 1 if start == chunk * self.batch_size else start, stage)

    return OffByOne(*args, **kwargs)


def _stream_setup(snapshot_dir, device, res, hours, seed, overrides=None, compute_dtype=torch.bfloat16,
                  sample_dtype=torch.float32):
    """The 72.1M net in ``compute_dtype`` (``net``) and in ``sample_dtype``
    (``net_sample``, 14b-fp32's), its process and guidance at ``s16_t6_spectral.yml``'s
    COSMO setting (``overrides`` change the config) with the observation y
    of a synthetic ground truth of ``hours`` frames, and a noise trajectory
    of ``hours`` frames drawn on the device and kept on the host."""
    from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance, SpatioTemporalCoarsening, per_channel
    from climate2weather_tpu_torch.diffusion.process import construct_process
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    net, snap_cfg = load_net(str(snapshot_dir), device, compute_dtype)
    net_sample = net if sample_dtype == compute_dtype else load_net(str(snapshot_dir), device, sample_dtype)[0]
    cfg = {**yaml_load_file(CONFIG), **(overrides or {})}
    C = int(snap_cfg["dataset_kwargs"]["train"]["num_features"])
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    # the synthetic ground truth made at its observed frames alone
    observed, _ = synthetic_inputs(A.out_times(hours), res, res, C, 1, seed)
    y = SpatioTemporalCoarsening(A.s_step, 1)(torch.from_numpy(observed).to(device))
    guidance = GaussianGuidance(A=A, y=y, std=per_channel(cfg["likelihood_std"], C, device),
                                gamma=per_channel(cfg["likelihood_gamma"], C, device))
    noise = torch.randn((hours, res, res, C), generator=torch.Generator(device=device).manual_seed(seed),
                        device=device).cpu().numpy()
    return {"net": net, "net_sample": net_sample, "process": construct_process(**snap_cfg["pipeline_kwargs"]),
            "guidance": guidance,
            "noise": noise, "markov_order": int(snap_cfg["dataset_kwargs"]["train"]["window"]) // 2,
            "n_attn": _attention_blocks(snap_cfg["network_kwargs"])}


def _host_guidance(s) -> dict:
    from climate2weather_tpu_torch.diffusion.host_stream import NumpyCoarsening

    g = s["guidance"]
    return dict(guidance_A=NumpyCoarsening(g.A.s_step, g.A.t_step), guidance_y=g.y.cpu().numpy(),
                guidance_std=g.std.cpu().numpy(), guidance_gamma=g.gamma.cpu().numpy())


def phase14a_eps(s, device, batch) -> dict:
    """eps of ``HostStreamingScoreFn`` on the noise trajectory at
    ``STREAM_T`` against the device ``WindowScoreFn``'s on the same frames:
    equal bit for bit (both give the net the same window batches); one chunk
    staged a frame late must differ; the attention launches of one host
    evaluation, 6 per chunk."""
    from climate2weather_tpu_torch.diffusion.host_stream import HostStreamingScoreFn
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    x, k = s["noise"], s["markov_order"]
    L = x.shape[0]
    n = L - 2 * k
    chunks = -(-n // min(n, batch))
    with torch.no_grad():
        for name in launch_counts:
            launch_counts[name] = 0
        host = HostStreamingScoreFn(s["net"], k, batch_size=batch, device=device)(x, STREAM_T)
        launches = launch_counts["attention_fwd"]
        dev = WindowScoreFn(s["net"], k, chunk_size=batch)(torch.from_numpy(x).to(device), STREAM_T).cpu().numpy()
        faulty = _chunk_off_by_one(min(1, chunks - 1), s["net"], k, batch_size=batch, device=device)(x, STREAM_T)
    rec = {"L": L, "windows": n, "chunks": chunks, "bits_equal": _bits_equal(host, dev),
           "max_abs_diff": float(np.abs(host - dev).max()), "fault_max_abs_diff": float(np.abs(faulty - dev).max()),
           "attention_launches": launches, "expected_launches": s["n_attn"] * chunks if device.type == "cuda" else 0}
    emit("14a", t0, **rec)
    if not rec["bits_equal"] or rec["fault_max_abs_diff"] == 0.0:
        raise AssertionError(f"the host tier's eps is not the device path's, or the planted fault passed: {rec}")
    if launches != rec["expected_launches"]:
        raise AssertionError(f"attention launches {launches} != 6 per chunk: {rec}")
    return rec


def _residual(guidance, x: np.ndarray) -> float:
    """max |A(x) - y| of a sample."""
    return float((guidance.A(torch.from_numpy(x).to(guidance.y.device)) - guidance.y).abs().max())


class _Replay:
    """14b's score function: the host tier's, each evaluation's eps kept,
    so that the planted faults rerun the sampler on the very eps of the good
    run (14a holds those bits to the device path's) and differ from it by
    the sampler's arithmetic alone, without a forward."""

    def __init__(self, score):
        self.score, self.kept, self.at = score, [], None

    def __call__(self, x, t):
        if self.at is None:
            eps = self.score(x, t)
            self.kept.append((t, eps.copy()))
            return eps
        t_kept, eps = self.kept[self.at]
        if t_kept != t:
            raise AssertionError(f"replay out of step: t {t} where the good run had {t_kept}")
        self.at += 1
        return eps.copy()

    def replay(self):
        self.at = 0
        return self


def _second_order_dropped(process, score, x, at, **kw):
    """14b's first planted fault: the host tier's DPM-Solver++(2M) with the
    second-order term dropped at step ``at`` (c_cur = 1, c_prev = 0: a
    first-order step there)."""
    from climate2weather_tpu_torch.diffusion import steprules
    from climate2weather_tpu_torch.diffusion.host_stream import sample_host_dpm

    real, calls = steprules.dpm_scalar_coeffs, []

    def coeffs(*args):
        h, sigma_ratio, growth, c_cur, c_prev = real(*args)
        calls.append(1)
        return (h, sigma_ratio, growth, 1.0, 0.0) if len(calls) - 1 == at else (h, sigma_ratio, growth, c_cur, c_prev)

    steprules.dpm_scalar_coeffs = coeffs
    try:
        return sample_host_dpm(process, score, x, **kw)
    finally:
        steprules.dpm_scalar_coeffs = real


def _sign_flipped(guidance_A):
    """14b's second planted fault: the coarsening whose adjoint has the wrong
    sign, so that guidance pushes away from y."""
    from climate2weather_tpu_torch.diffusion.host_stream import NumpyCoarsening

    class Flipped(NumpyCoarsening):
        def adjoint(self, v, out_len):
            return -super().adjoint(v, out_len)

    return Flipped(guidance_A.s_step, guidance_A.t_step)


def _first_frames(s, hours):
    """The noise's first ``hours`` frames, and ``s`` with its guidance cut
    to the observation rows of those frames."""
    from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance

    g = s["guidance"]
    cut = GaussianGuidance(A=g.A, y=g.y[: g.A.out_times(hours)], std=g.std, gamma=g.gamma)
    return np.ascontiguousarray(s["noise"][:hours]), dict(s, guidance=cut)


def phase14b_against_device(s, device, batch, steps) -> dict:
    """DPM-Solver++(2M), eta = 0, the final denoise and COSMO guidance for
    ``steps`` steps from the same noise, the net in 14a's bf16: the host
    tier and the device long path side by side. Their largest difference
    is printed, not held to a limit: in bf16 a one-ulp difference of the
    two tiers' fp32 updates flips the rounding of some of the net's inputs,
    and the COSMO gamma's gain carries that far past any bar (14b-fp32
    holds the samplers to JAX's). Checked: finite, the attention launches,
    and the host tier's peak device memory below the long path's. Also the
    guidance residual of both; window-evals/s of both, the host tier's
    seconds an evaluation in copies and in the numpy update; the peak device
    memory of each sampler call (the host tier's with the statistics reset
    after its noise is on the host); host RSS growth."""
    from climate2weather_tpu_torch.diffusion.host_stream import HostStreamingScoreFn, sample_host_dpm
    from climate2weather_tpu_torch.diffusion.long_sampler import sample_dpmpp2m_long
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    x, k, process = s["noise"], s["markov_order"], s["process"]
    L = x.shape[0]
    n = L - 2 * k
    per_call = min(n, batch)
    window_evals = (steps + 1) * -(-n // per_call) * per_call
    score = HostStreamingScoreFn(s["net"], k, batch_size=batch, device=device)
    for name in launch_counts:
        launch_counts[name] = 0
    _peak_reset(device)
    t_host = time.time()
    host, rss = _host_peak(lambda: sample_host_dpm(process, score, x, steps=steps, sde_eta=0.0, denoise_final=True,
                                                   **_host_guidance(s)))
    host_s = time.time() - t_host
    host_peak = _peak(device)
    launches = launch_counts["attention_fwd"]
    x_dev = torch.from_numpy(x).to(device)
    _peak_reset(device)
    t_dev = time.time()
    dev, nan = sample_dpmpp2m_long(process, WindowScoreFn(s["net"], k, chunk_size=batch), x_dev,
                                   guidance=s["guidance"], steps=steps, denoise_final=True)
    dev = dev.cpu().numpy()
    dev_s = time.time() - t_dev
    dev_peak = _peak(device)
    del x_dev
    scale = float(dev.std())
    evals = score.timings["evals"]
    traj = x.nbytes
    diff = float(np.abs(host - dev).max())
    rec = {"L": L, "steps": steps, "finite": bool(np.isfinite(host).all()) and not bool(nan),
           "max_abs_diff": diff, "scale_std": scale, "diff_in_std": diff / scale,
           "residual_host": _residual(s["guidance"], host), "residual_device": _residual(s["guidance"], dev),
           "window_evals": window_evals, "host_s": host_s, "device_s": dev_s,
           "window_evals_per_s_host": window_evals / host_s, "window_evals_per_s_device": window_evals / dev_s,
           "evals": evals, "score_s_per_eval": score.timings["eval_s"] / evals,
           "copy_s_per_eval": score.timings["copy_s"] / evals,
           "update_s_per_eval": (host_s - score.timings["eval_s"]) / evals,
           "attention_launches": launches,
           "expected_launches": s["n_attn"] * evals * -(-n // per_call) if device.type == "cuda" else 0,
           "peak_host_tier": host_peak, "peak_device_path": dev_peak,
           "host_rss_growth": rss, "host_rss_growth_trajectories": rss / traj, "trajectory_bytes": traj}
    emit("14b", t0, **rec)
    if not rec["finite"]:
        raise AssertionError(f"the host tier's sample is not finite: {rec}")
    if launches != rec["expected_launches"]:
        raise AssertionError(f"attention launches {launches} != 6 per chunk and evaluation: {rec}")
    if host_peak is not None and not host_peak < dev_peak:
        raise AssertionError(f"the host tier's peak device memory is not below the device path's: {rec}")
    return rec


class _Replay:
    """14b-fp32's score function: the host tier's, each evaluation's eps
    kept, so that the planted faults rerun the sampler on the very eps of
    the good run and differ from it by the sampler's arithmetic alone,
    without a forward."""

    def __init__(self, score):
        self.score, self.kept, self.at = score, [], None

    def __call__(self, x, t):
        if self.at is None:
            eps = self.score(x, t)
            self.kept.append((t, eps.copy()))
            return eps
        t_kept, eps = self.kept[self.at]
        if t_kept != t:
            raise AssertionError(f"replay out of step: t {t} where the good run had {t_kept}")
        self.at += 1
        return eps.copy()

    def replay(self):
        self.at = 0
        return self


def _second_order_dropped(process, score, x, at, **kw):
    """14b-fp32's first planted fault: the host tier's DPM-Solver++(2M) with
    the second-order term dropped at step ``at`` (c_cur = 1, c_prev = 0: a
    first-order step there)."""
    from climate2weather_tpu_torch.diffusion import steprules
    from climate2weather_tpu_torch.diffusion.host_stream import sample_host_dpm

    real, calls = steprules.dpm_scalar_coeffs, []

    def coeffs(*args):
        h, sigma_ratio, growth, c_cur, c_prev = real(*args)
        calls.append(1)
        return (h, sigma_ratio, growth, 1.0, 0.0) if len(calls) - 1 == at else (h, sigma_ratio, growth, c_cur, c_prev)

    steprules.dpm_scalar_coeffs = coeffs
    try:
        return sample_host_dpm(process, score, x, **kw)
    finally:
        steprules.dpm_scalar_coeffs = real


def _sign_flipped(guidance_A):
    """14b-fp32's second planted fault: the coarsening whose adjoint has the
    wrong sign, so that guidance pushes away from y."""
    from climate2weather_tpu_torch.diffusion.host_stream import NumpyCoarsening

    class Flipped(NumpyCoarsening):
        def adjoint(self, v, out_len):
            return -super().adjoint(v, out_len)

    return Flipped(guidance_A.s_step, guidance_A.t_step)


def phase14b_exact(s, device, hours, batch, steps) -> dict:
    """14b's run held to a limit, on the first ``hours`` frames in chunks
    of ``batch`` windows (the last shifted back, as at 523 frames in chunks
    of 128) with the net in fp32 (``net_sample``): the host tier's sample
    against the device long path's from the same noise within JAX's bar,
    ``JAX_BAR`` times the device sample's standard deviation. The two tiers
    give the net the same batches, so in fp32 they differ by the rounding of
    their updates and guidance alone. Two planted faults, rerun on the good
    run's eps, must exceed the bar: the second-order term dropped at the
    last step, and the guidance's sign flipped. Also both residuals."""
    from climate2weather_tpu_torch.diffusion.host_stream import HostStreamingScoreFn, sample_host_dpm
    from climate2weather_tpu_torch.diffusion.long_sampler import sample_dpmpp2m_long
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

    t0 = time.time()
    k, process, net = s["markov_order"], s["process"], s["net_sample"]
    x, short = _first_frames(s, hours)
    guided = _host_guidance(short)
    replay = _Replay(HostStreamingScoreFn(net, k, batch_size=batch, device=device))
    kw = dict(steps=steps, sde_eta=0.0, denoise_final=True)
    host = sample_host_dpm(process, replay, x, **kw, **guided)
    dev, nan = sample_dpmpp2m_long(process, WindowScoreFn(net, k, chunk_size=batch), torch.from_numpy(x).to(device),
                                   guidance=short["guidance"], steps=steps, denoise_final=True)
    dev = dev.cpu().numpy()
    faults = {
        "second_order_dropped": _second_order_dropped(process, replay.replay(), x, steps - 1, **kw, **guided),
        "guidance_sign_flipped": sample_host_dpm(process, replay.replay(), x, **kw,
                                                 **dict(guided, guidance_A=_sign_flipped(guided["guidance_A"]))),
    }
    scale = float(dev.std())
    diff = float(np.abs(host - dev).max())
    n = hours - 2 * k
    rec = {"L": hours, "chunks": -(-n // min(n, batch)), "steps": steps,
           "finite": bool(np.isfinite(host).all()) and not bool(nan), "max_abs_diff": diff, "scale_std": scale,
           "diff_in_std": diff / scale, "limit": JAX_BAR * scale,
           **{f"fault_{name}": float(np.abs(f - dev).max()) for name, f in faults.items()},
           "residual_host": _residual(short["guidance"], host), "residual_device": _residual(short["guidance"], dev)}
    emit("14b-fp32", t0, **rec)
    if not rec["finite"] or rec["max_abs_diff"] > rec["limit"]:
        raise AssertionError(f"the host tier's sample is not the device path's: {rec}")
    if not all(rec[f"fault_{name}"] > rec["limit"] for name in faults):
        raise AssertionError(f"a planted fault of the host sampler passed 14b's check: {rec}")
    return rec


def phase14c_short(s, device, batch, steps, hours) -> dict:
    """The first ``hours`` frames (one chunk of 128 windows): ``steps``
    steps of DPM-Solver++(2M) SDE (eta 0.3, the confirmed setting) with the
    final denoise, twice with one seed: equal bit for bit and finite, and its
    peak device memory; one PC step with one corrector step: finite."""
    from climate2weather_tpu_torch.diffusion.host_stream import HostStreamingScoreFn, sample_host, sample_host_dpm

    t0 = time.time()
    k, process = s["markov_order"], s["process"]
    x, short = _first_frames(s, hours)
    guided = _host_guidance(short)
    score = HostStreamingScoreFn(s["net"], k, batch_size=batch, device=device)
    _peak_reset(device)
    first = sample_host_dpm(process, score, x, steps=steps, sde_eta=0.3, denoise_final=True, seed=7, **guided)
    peak = _peak(device)
    second = sample_host_dpm(process, score, x, steps=steps, sde_eta=0.3, denoise_final=True, seed=7, **guided)
    pc = sample_host(process, score, x, steps=1, corrections=1, tau=0.5, seed=7, **guided)
    rec = {"L": hours, "sde_equal": _bits_equal(first, second), "sde_finite": bool(np.isfinite(first).all()),
           "pc_finite": bool(np.isfinite(pc).all()), "residual_sde": _residual(short["guidance"], first),
           "residual_pc": _residual(short["guidance"], pc), "peak_host_tier": peak}
    emit("14c", t0, **rec)
    if not (rec["sde_equal"] and rec["sde_finite"] and rec["pc_finite"]):
        raise AssertionError(f"the host tier's SDE run is not reproducible or a sample is not finite: {rec}")
    return rec


def phase14e_predict(root, snapshot_dir, device, res, hours, steps, samples, seed) -> dict:
    """``experiment.main(["predict", ...])`` in this process at a copy of
    ``s16_t6_spectral.yml`` on phase 6's files with ``host_streaming: true``,
    DPM-Solver++(2M) SDE 0.3, the final denoise and no calibration or
    projection: finite samples written, 6 attention launches per UNet forward
    (one sample at a time)."""
    from climate2weather_tpu_torch import experiment
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    paths = write_predict_inputs(root, res=res, hours=hours, seed=seed)
    cfg = {**yaml_load_file(CONFIG), "model_path": str(snapshot_dir), "data_path": paths["data"],
           "quantile_path": paths["quantiles"], "observation_path": paths["data"], "num_hours": hours,
           "host_streaming": True, "sampler_kind": "dpmpp2m", "sde_eta": 0.3, "denoise_final": True,
           "spectral_calibrate": "", "t0_project": "", "num_sampling_steps": steps, "num_samples": samples}
    config_path = root / "stream.yml"
    yaml_dump_file(cfg, config_path)
    for k in launch_counts:
        launch_counts[k] = 0
    t_run = time.time()
    experiment.main(["predict", "--save-path", str(root / "predict"), "--config-path", str(config_path),
                     "--device", device.type])
    if device.type == "cuda":
        torch.cuda.synchronize()
    predict_s = time.time() - t_run
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    expect = _attention_blocks(snap_cfg["network_kwargs"]) * _expected_forwards(
        {**cfg, "ensemble_batch": 1}, hours, window) if device.type == "cuda" else 0
    (out_dir,) = [p for p in (root / "predict").iterdir() if p.is_dir()]
    gens = [open_grid(str(out_dir / f"gen_sample_{i:03d}.nc")) for i in range(samples)]
    rec = {"predict_s": predict_s, "finite": all(bool(np.isfinite(v).all()) for g in gens for v in g.data_vars.values()),
           "attention_launches": launch_counts["attention_fwd"], "expected_launches": expect,
           "outputs": sorted(p.name for p in out_dir.iterdir())}
    emit("14e", t0, **rec)
    if not rec["finite"] or rec["attention_launches"] != expect:
        raise AssertionError(f"the host-streamed predict failed its checks: {rec}")
    return rec


def phase14d_memory(b, c, device) -> dict:
    """The bound the tier exists for, from 14b's and 14c's runs: the host
    tier's peak device memory at 523 frames equal to its peak at 140 within
    2 % (both run full chunks of 128 windows), below the device long path's;
    the device path's excess over it in trajectory buffers (the slope its
    length limit follows); host RSS growth in trajectory buffers."""
    t0 = time.time()
    rec = {"peak_long": b["peak_host_tier"], "peak_short": c["peak_host_tier"], "peak_device_path": b["peak_device_path"],
           "host_rss_growth_trajectories": b["host_rss_growth_trajectories"], "trajectory_bytes": b["trajectory_bytes"]}
    if device.type == "cuda":
        rec.update(peak_ratio=rec["peak_long"] / rec["peak_short"],
                   device_path_excess_trajectories=(rec["peak_device_path"] - rec["peak_long"]) / b["trajectory_bytes"],
                   total_memory=torch.cuda.get_device_properties(device).total_memory)
    emit("14d", t0, **rec)
    if device.type == "cuda" and not (abs(rec["peak_ratio"] - 1.0) <= 0.02 and rec["peak_long"] < rec["peak_device_path"]):
        raise AssertionError(f"the host tier's peak device memory grows with the trajectory or is not below "
                             f"the device path's: {rec}")
    return rec


def phase14_summary(stream: dict) -> dict:
    """Phase 14's line: the checks' readings, the rates and the peaks."""
    a, b, x, c, d, e = (stream[k] for k in ("14a", "14b", "14b-fp32", "14c", "14d", "14e"))
    return {"eps_bits_equal": a["bits_equal"], "eps_launches": a["attention_launches"],
            "sample_max_abs_diff": b["max_abs_diff"], "sample_fp32_max_abs_diff": x["max_abs_diff"],
            "sample_fp32_limit": x["limit"], "fault_second_order_dropped": x["fault_second_order_dropped"],
            "fault_guidance_sign_flipped": x["fault_guidance_sign_flipped"],
            "window_evals_per_s_host": b["window_evals_per_s_host"],
            "window_evals_per_s_device": b["window_evals_per_s_device"],
            "copy_s_per_eval": b["copy_s_per_eval"], "update_s_per_eval": b["update_s_per_eval"],
            "sde_equal": c["sde_equal"], "peak_long": d["peak_long"], "peak_short": d["peak_short"],
            "peak_device_path": d["peak_device_path"], "predict_s": e["predict_s"],
            "predict_launches": e["attention_launches"]}


def phase14_host_stream(snapshot_dir, device, res=128, hours=STREAM_HOURS, batch=STREAM_BATCH, steps=STREAM_STEPS,
                        exact=STREAM_EXACT, predict_hours=49, predict_steps=8, predict_samples=2, seed=0,
                        overrides=None, compute_dtype=torch.bfloat16, sample_dtype=torch.float32) -> dict:
    """Phase 14, 14a-14e (see the module docstring), h5py unimportable, in
    one scratch directory. ``hours`` and ``steps`` are 14b's and 14c's,
    ``exact`` 14b-fp32's frames and windows a chunk; ``overrides`` change
    the guidance config of 14a-14c, ``compute_dtype`` the net's of all but
    14b-fp32, which runs it in ``sample_dtype``. Returns each part's
    record."""
    import shutil
    import tempfile

    sys.modules["h5py"] = None
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-stream-"))
    try:
        s = _stream_setup(snapshot_dir, device, res, hours[0], seed, overrides, compute_dtype, sample_dtype)
        a = phase14a_eps(s, device, batch)
        b = phase14b_against_device(s, device, batch, steps[0])
        x = phase14b_exact(s, device, *exact, steps[0])
        c = phase14c_short(s, device, batch, steps[1], hours[1])
        d = phase14d_memory(b, c, device)
        del s
        e = phase14e_predict(root, snapshot_dir, device, res, predict_hours, predict_steps, predict_samples, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"14a": a, "14b": b, "14b-fp32": x, "14c": c, "14d": d, "14e": e}


# ---------------------------------------------------------------------------
# phase 15: the study and operations drivers (climate2weather_tpu_torch.scripts)
# at the 72.1M net's width. Every process the phase starts, and every process
# those start, has the packages of PHASE15_BLOCKED unimportable (a
# sitecustomize first on its path) and writes its attention launches to a log
# at its exit.

PHASE15_BLOCKED = PHASE12_BLOCKED + ("scipy", "matplotlib", "click", "netCDF4")
STUDY_TOTAL = 13631488  # the fabricated run's schedule total (the H3 extension's)
# the fabricated position: 1,024 x 9,213 - 128, just below the snapshot's
# 9,437,184, so that 2 steps of 64 end on a checkpoint multiple in the next kdata
STUDY_NDATA = 9433984
STUDY_STEPS = 4  # 15c's, 15d's and the probe's sampling steps
STUDY_START = "2014-04-07-04"
STUDY_ABLATION = ("pc_corr0", "pc_corr1_tau05_ve")
STUDY_SITE = r"""
import atexit, importlib.abc, importlib.machinery, importlib.util, json, os, sys

BLOCKED = set(os.environ["C2W_STUDY_BLOCKED"].split(","))


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked by chip_smoke: {name}")
        return None


sys.meta_path.insert(0, Blocker())
for name in BLOCKED:
    sys.modules[name] = None


def report():
    attention = sys.modules.get("climate2weather_tpu_torch.ops.attention")
    leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)
    with open(os.environ["C2W_STUDY_LOG"], "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv, "leaked": leaked,
                            "launches": dict(attention.launch_counts) if attention else None}) + "\n")


atexit.register(report)
# the host's own sitecustomize, where there is one further down the path
here = os.path.dirname(os.path.abspath(__file__))
for entry in sys.path:
    if os.path.abspath(entry or os.curdir) != here:
        spec = importlib.machinery.PathFinder.find_spec("sitecustomize", [entry])
        if spec is not None:
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            break
"""


def _study_env(device, root: pathlib.Path) -> dict:
    """The environment of phase 15's processes: :func:`_child_env` with the
    blocking ``sitecustomize`` of STUDY_SITE first on the path, and the log
    each process appends its launches to."""
    site = root / "study_site"
    if not site.is_dir():
        site.mkdir(parents=True)
        (site / "sitecustomize.py").write_text(STUDY_SITE)
    env = _child_env(device)
    env.update(PYTHONPATH=os.pathsep.join([str(site), env["PYTHONPATH"]]),
               C2W_STUDY_BLOCKED=",".join(PHASE15_BLOCKED), C2W_STUDY_LOG=str(root / "study_processes.jsonl"))
    return env


def _study_processes(env) -> list:
    """The records the phase's processes wrote at their exit."""
    path = pathlib.Path(env["C2W_STUDY_LOG"])
    return [json.loads(ln) for ln in path.read_text().splitlines()] if path.exists() else []


def _process_launches(env, *parts: str) -> dict:
    """The attention launches of the one process whose command line holds
    every one of ``parts``."""
    recs = [r for r in _study_processes(env) if all(any(p in a for a in r["argv"]) for p in parts)]
    if len(recs) != 1:
        raise AssertionError(f"{len(recs)} processes ran {parts}: {_study_processes(env)}")
    return recs[0]["launches"] or {"attention_fwd": 0, "attention_bwd": 0}


def _counts_zero():
    from climate2weather_tpu_torch.ops.attention import launch_counts

    for k in launch_counts:
        launch_counts[k] = 0
    return launch_counts


def _numbers(lines) -> list:
    """Every number in the cells of markdown table rows."""
    import re

    return [float(x) for ln in lines for x in re.findall(r"(?<![\w.])-?(?:\d+\.\d*|nan|inf)(?![\w.])", ln)]


def study_fabricate(root, snapshot_dir) -> dict:
    """15a's fabrication: ``scripts.fabricate_resume_state`` (its ``main``,
    in this process) from the snapshot at ndata STUDY_NDATA and batch 64.
    Returns what it printed, its seconds and the run directory."""
    import contextlib
    import io

    from climate2weather_tpu_torch.scripts import fabricate_resume_state

    t0 = time.time()
    run = root / "fab" / "r"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        fabricate_resume_state.main(["--snapshot", str(snapshot_dir), "--out-dir", str(run), "--ndata",
                                     str(STUDY_NDATA), "--batch", "64", "--lr", "2e-4", "--total-ndata",
                                     str(STUDY_TOTAL), "--ema-rates", "0.9999"])
    return {"fabricate_out": printed.getvalue(), "fabricate_s": time.time() - t0, "run": run}


def study_resume(rec, data_path, device, model_config, res, seed, env) -> dict:
    """15a's process: ``train`` resuming from the fabricated checkpoint for
    two steps (``--slice-data 128``). Returns ``rec`` with its output and
    seconds."""
    train = [sys.executable, "-m", "climate2weather_tpu_torch.train"] + _train_argv(
        rec["run"].parent, data_path, model_config, res, 64, 32, STUDY_TOTAL, seed, device, snapshot=0) + [
        "--slice-data", "128"]
    (train_out,), train_s, _ = _run_processes([train], [env], label="15a resume")
    return {**rec, "train_out": train_out, "train_s": train_s}


def _flat_named(state) -> torch.Tensor:
    """:func:`_flat_state` with the EMA taken in the parameters' order (a
    restored EMA keeps the checkpoint's order of names)."""
    names = [n for n, _ in state.net.named_parameters()]
    ema = state.emas["0.999900"]
    return torch.cat([_flat_state(state)[:-sum(ema[n].numel() for n in names)]]
                     + [ema[n].reshape(-1).float() for n in names])


def _study_state(net_kwargs, params, device, step):
    """A train state of the snapshot's fp32 parameters at ``step`` with a
    fresh AdamW and an EMA, made as the training loop makes its own."""
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.training.ema import ema_init
    from climate2weather_tpu_torch.training.state import TrainState, make_optimizer

    net = load_params(build_score_unet(net_kwargs, dtype=torch.bfloat16), params).to(device)  # train's compute
    opt = make_optimizer(net.parameters(), {"weight_decay": 1e-3, "betas": [0.9, 0.999]})
    return TrainState(step=step, net=net, optimizer=opt, emas=ema_init(dict(net.named_parameters()), (0.9999,)))


def _study_net_kwargs(snapshot_dir, model_config) -> dict:
    """``train``'s network kwargs for ``model_config`` at the snapshot's
    window (4 variables a frame)."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    window = int(yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")["dataset_kwargs"]["train"]["window"])
    return {"class_name": "score_unet", "channels": 4 * window,
            **{k: v for k, v in yaml_load_file(model_config).items() if k != "padding_mode"}}


def study_reference(snapshot_dir, data_path, device, model_config, res, seed) -> dict:
    """15a's yardstick, made here: a fresh AdamW on the snapshot's fp32
    parameters at step STUDY_NDATA / 64, two steps on the batches and draws
    ``train`` takes there (the sampler's stream and the step's generator),
    and the same from the loader as it was (Adam's count forced to the step,
    over zero moments), the planted fault. Returns both states, flat, and
    the fresh run's losses."""
    from climate2weather_tpu_torch.data import dataset  # noqa: F401 (registers cosmo_dataset)
    from climate2weather_tpu_torch.data.dataset import InfiniteSampler
    from climate2weather_tpu_torch.training.checkpoint import load_snapshot
    from climate2weather_tpu_torch.training.lr import make_schedule
    from climate2weather_tpu_torch.training.state import (
        make_device_data_train_step,
        step_generator,
        upload_dataset,
    )
    from climate2weather_tpu_torch.utils.registry import construct_class_by_name

    t0 = time.time()
    step0 = STUDY_NDATA // 64
    sched = make_schedule({"func_name": "lr/linear", "ref_lr": 2e-4, "total_ndata": STUDY_TOTAL}, 64)
    params, _ = load_snapshot(str(snapshot_dir))
    net_kwargs = _study_net_kwargs(snapshot_dir, model_config)
    window = net_kwargs["channels"] // 4
    ds = construct_class_by_name(class_name="cosmo_dataset", data_path=str(data_path), num_features=4,
                                 spatial_res=res, cached=False, window=window, flatten=True)
    data = upload_dataset(ds._reader(), ds.raw_data_shape[0], dtype=torch.float32, device=device)
    step_fn = make_device_data_train_step(VPCosineProcess(), sched, window, (0.9999,))

    def two_steps(state):
        it = iter(InfiniteSampler(dataset_size=len(ds), shuffle=True, seed=seed, start_idx=STUDY_NDATA))
        losses = []
        for _ in range(2):
            idx = np.fromiter((next(it) for _ in range(64)), np.int64, count=64).reshape(2, -1)
            state, loss = step_fn(state, data, torch.from_numpy(idx).to(device),
                                  step_generator(seed, state.step, device))
            losses.append(float(loss))
        return _flat_named(state), losses

    threads = torch.get_num_threads()
    if device.type == "cpu":  # the child's thread count (_child_env): CPU sums depend on it
        torch.set_num_threads(max(1, threads // 2))
    try:
        fresh, losses = two_steps(_study_state(net_kwargs, params, device, step0))
        old = _study_state(net_kwargs, params, device, step0)
        for p in old.net.parameters():  # the loader as it was: Adam's count = step, moments zero
            old.optimizer.state[p] = {"step": torch.tensor(float(step0)), "exp_avg": torch.zeros_like(p),
                                      "exp_avg_sq": torch.zeros_like(p)}
        faulty, _ = two_steps(old)
    finally:
        torch.set_num_threads(threads)
    return {"fresh": fresh, "fresh_loss": losses, "faulty": faulty, "seconds": time.time() - t0}


def phase15a_check(rec, ref, snapshot_dir, device, model_config, env, plain_spread=None) -> dict:
    """15a: the resumed run started at the fabricated ndata (not at 0), its LR
    the schedule's absolute value, its final checkpoint holding Adam's count
    2 and the schedule's count step0 + 2; its state bit for bit
    :func:`study_reference`'s fresh AdamW's (or within ``plain_spread``,
    10a's plain runs' own spread, where 10a found them unequal), and the
    planted fault's state apart from it."""
    from climate2weather_tpu_torch.training.checkpoint import CheckpointIO, adam_count, load_snapshot
    from climate2weather_tpu_torch.training.lr import make_schedule

    t0 = time.time()
    step0, run = STUDY_NDATA // 64, rec["run"]
    sched = make_schedule({"func_name": "lr/linear", "ref_lr": 2e-4, "total_ndata": STUDY_TOTAL}, 64)
    net_kwargs = _study_net_kwargs(snapshot_dir, model_config)
    logged = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    logged = [r for r in logged if "train/loss" in r]
    child = _study_state(net_kwargs, load_snapshot(str(snapshot_dir))[0], device, 0)
    final = run / f"training-state-{(STUDY_NDATA + 128) // 1000:07d}.ckpt"
    CheckpointIO(state=child, meta={"batch_size": 0}).load(str(final), verbose=False)
    got, fresh = _flat_named(child), ref["fresh"]
    out = {"fabricate_printed": [ln for ln in rec["fabricate_out"].splitlines() if "lr(step)=" in ln],
           "resumed_from": [ln for ln in rec["train_out"].splitlines() if ln.startswith("Training from")],
           "logged_ndata": [r["train/ndata"] for r in logged], "logged_lr": [r["train/lr"] for r in logged],
           "logged_loss": [r["train/loss"] for r in logged], "fresh_loss": ref["fresh_loss"],
           "adam_count": adam_count(child.optimizer), "schedule_count": child.step,
           "bits_equal": bool(torch.equal(got, fresh)), "max_abs_diff": float((got - fresh).abs().max()),
           "plain_spread": plain_spread, "fault_max_abs_diff": float((got - ref["faulty"]).abs().max()),
           "launches": _process_launches(env, "climate2weather_tpu_torch/train.py", str(run.parent)),
           "fabricate_s": rec["fabricate_s"], "train_s": rec["train_s"], "reference_s": ref["seconds"]}
    want_launches = 2 * 2 * _attention_blocks(net_kwargs) if device.type == "cuda" else 0
    emit("15a", t0, **out)
    want_lr = f"lr(step)={sched(step0):.3e}"
    if len(out["fabricate_printed"]) != 1 or want_lr not in out["fabricate_printed"][0]:
        raise AssertionError(f"the fabricated LR is not the schedule's at step {step0} ({want_lr}): {out}")
    if out["resumed_from"] != [f"Training from {STUDY_NDATA // 1000} kdata to {(STUDY_NDATA + 128) // 1000} kdata:"]:
        raise AssertionError(f"the run did not resume at the fabricated ndata: {out}")
    if out["logged_ndata"] != [STUDY_NDATA + 64, STUDY_NDATA + 128] or \
            out["logged_lr"] != [sched(step0 + 1), sched(step0 + 2)]:
        raise AssertionError(f"the run's positions or LRs are not the schedule's absolute ones: {out}")
    if (out["adam_count"], out["schedule_count"]) != (2, step0 + 2):
        raise AssertionError(f"the resumed checkpoint's counts are not (2, {step0 + 2}): {out}")
    limit = plain_spread or 0.0
    if not (out["bits_equal"] or (plain_spread is not None and out["max_abs_diff"] <= limit)):
        raise AssertionError(f"the resumed updates are not a fresh AdamW's: {out}")
    if plain_spread is None and out["logged_loss"] != out["fresh_loss"]:
        raise AssertionError(f"the resumed run's losses are not the fresh AdamW run's: {out}")
    if not out["fault_max_abs_diff"] > limit:
        raise AssertionError(f"the old loader's updates are not told apart: {out}")
    if out["launches"] != {"attention_fwd": want_launches, "attention_bwd": want_launches}:
        raise AssertionError(f"attention launches {out['launches']}, want {want_launches} each way")
    return out


def phase15b_soak(root, data_path, device, model_config, res, seed, ref_dir, env) -> dict:
    """15b: ``scripts.soak_training.soak`` on 10a's plain command (the 72.1M
    net, 2,048 ndata, a checkpoint at 1,024, a loss every step) as one
    slice with every start killed past its checkpoint: start 1 SIGKILLed
    once it has written the checkpoint at 1,024 and logged beyond it, start
    2 resuming there and finishing before its condition can fire. Its losses
    at every logged ndata equal the uninterrupted run's in ``ref_dir`` bit
    for bit, and the killed start's replayed intervals their replays; the
    planted fault, one loss one float32 ulp off in a copy of the log, fails
    the check."""
    import shutil

    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.scripts import soak_training

    t0 = time.time()
    work = root / "b_soak"

    def cmd_fn(run_dir, run_id, slice_data=None):
        argv = _train_argv(run_dir, data_path, model_config, res, 64, 32, 2048, seed, device, snapshot=2048)
        argv[argv.index("--run-id") + 1] = run_id
        return [sys.executable, "-m", "climate2weather_tpu_torch.train"] + argv, env

    results = soak_training.soak(work, 2048, 1, 64, kill_every=1, kill_past_checkpoint=True, cmd_fn=cmd_fn,
                                 ref_dir=ref_dir, poll=0.05)
    fault_dir = root / "b_fault"
    fault_dir.mkdir()
    recs = [json.loads(ln) for ln in (work / "runs" / "soak" / "metrics.jsonl").read_text().splitlines()]
    last = max(i for i, r in enumerate(recs) if "train/loss" in r)
    recs[last]["train/loss"] = float(np.nextafter(np.float32(recs[last]["train/loss"]), np.float32(np.inf)))
    (fault_dir / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    try:
        soak_training.check({}, fault_dir, ref_dir)
        caught = False
    except AssertionError:
        caught = True
    resumed = [ln for ln in (work / "soak.log").read_text().splitlines() if ln.startswith("Training from")]
    clean = [r for r in _study_processes(env) if any(str(work) in a for a in r["argv"])]
    out = {**results, "resumed_from": resumed, "fault_caught": caught,
           "launches": clean[0]["launches"] if len(clean) == 1 else None}
    shutil.rmtree(fault_dir, ignore_errors=True)
    emit("15b", t0, **out)
    starts = out["restarts"]
    if [r["killed"] for r in starts] != [True, False] or not 1024 < starts[0].get("killed_at_ndata", 0) < 2048:
        raise AssertionError(f"start 1 was not killed mid-slice past its checkpoint: {out}")
    if resumed != ["Training from 0 kdata to 2 kdata:", "Training from 1 kdata to 2 kdata:"]:
        raise AssertionError(f"start 2 did not resume at the checkpoint: {out}")
    if out["common_log_points"] != 32 or out["replayed_log_points"] < 1 or not caught:
        raise AssertionError(f"the soak's loss parity did not cover the run or missed its fault: {out}")
    per_start = (2048 - 1024) // 64 * 2 * _attention_blocks(yaml_load_file(model_config)) \
        if device.type == "cuda" else 0
    if out["launches"] != {"attention_fwd": per_start, "attention_bwd": per_start}:
        raise AssertionError(f"the finishing start's attention launches {out['launches']}, want {per_start}")
    return out


def phase15c_sweep(root, paths, snapshot_dir, device, hours, n_attn, window) -> dict:
    """15c: ``scripts.likelihood_sweep`` (its ``main``, in this process) on
    ``s16_t6.yml`` cut to STUDY_STEPS steps and 2 samples: trial 0 (the COSMO
    point), trial 1 drawn from ``--base-seed`` 99, and ``--uncond``. Every
    row scored with finite numbers, trial 1 the draw of ``set_random_seed(99,
    1)`` (base seed 98, the planted fault, draws another), the ranked table,
    the control's floors, and the attention-forward launches forwards x
    attention blocks."""
    import contextlib
    import io

    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.scripts import likelihood_sweep
    from climate2weather_tpu_torch.utils.seeding import set_random_seed

    t0 = time.time()
    cfg = yaml_load_file(PREDICT_CONFIGS / "s16_t6.yml")
    cfg.update(model_path=str(snapshot_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], num_sampling_steps=STUDY_STEPS)
    config_path = root / "sweep_base.yml"
    yaml_dump_file(cfg, config_path)
    out_dir = root / "sweep"
    counts = _counts_zero()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        likelihood_sweep.main(["--out", str(out_dir), "--config", str(config_path), "--trials", "1",
                               "--num-samples", "2", "--uncond", "--uncond-samples", "2",
                               "--device", device.type])
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = counts["attention_fwd"]
    expect = 3 * n_attn * _expected_forwards(dict(cfg, num_samples=2), hours, window) if device.type == "cuda" else 0
    rows = [json.loads(ln) for ln in (out_dir / "sweep.jsonl").read_text().splitlines()]
    set_random_seed(99, 1)
    drawn = downscaling._draw_likelihood_hparams()
    set_random_seed(98, 1)
    other = downscaling._draw_likelihood_hparams()
    table = [ln for ln in (out_dir / "RANKING.md").read_text().splitlines() if ln[:3].strip("| ").isdigit()]
    floors = json.loads((out_dir / "uncond_metrics.json").read_text())
    rec = {"rows": [{k: r.get(k) for k in ("trial", "sigma", "gamma", "score", "w2_ratio", "melr_ratio",
                                           "calib_penalty", "error")} for r in rows],
           "ranked": table, "floors_finite": all(np.isfinite(x) for f in floors.values() for x in f.values()),
           "drawn_equal": [rows[1]["sigma"], rows[1]["gamma"]] == [list(drawn[0]), drawn[1]] if len(rows) > 1 else False,
           "fault_drawn_equal": [rows[1]["sigma"], rows[1]["gamma"]] == [list(other[0]), other[1]] if len(rows) > 1 else None,
           "attention_launches": launches, "expected_launches": expect, "dir": str(out_dir)}
    emit("15c", t0, **{k: v for k, v in rec.items() if k != "dir"})
    scored = [r for r in rows if all(np.isfinite(r.get(k, np.nan)) for k in ("score", "w2_ratio", "melr_ratio",
                                                                           "calib_penalty"))]
    if [r["trial"] for r in rows] != [0, 1] or len(scored) != 2:
        raise AssertionError(f"the sweep did not score trials 0 and 1: {rec}\n{printed.getvalue()[-3000:]}")
    if not rec["drawn_equal"] or rec["fault_drawn_equal"]:
        raise AssertionError(f"trial 1 is not the draw of base seed 99: {rec}")
    if len(table) != 2 or not rec["floors_finite"]:
        raise AssertionError(f"the ranking or the control's floors are missing: {rec}")
    if launches != expect:
        raise AssertionError(f"attention launches {launches} != {expect}")
    return rec


def phase15d_ablation(root, paths, snapshot_dir, device, n_attn, window, hours) -> dict:
    """15d: ``scripts.sampler_ablation`` with ``--only`` the rows
    STUDY_ABLATION at STUDY_STEPS steps and 2 samples: a table row and finite
    scores for each, each cell's ``FIDELITY.md``, and the launches."""
    import contextlib
    import io

    from climate2weather_tpu_torch.scripts import sampler_ablation

    t0 = time.time()
    out_dir = root / "ablation"
    counts = _counts_zero()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        sampler_ablation.main(["--snapshot", str(snapshot_dir), "--data-nc", paths["data"], "--quantiles",
                               paths["quantiles"], "--out", str(out_dir), "--start-time", STUDY_START,
                               "--num-samples", "2", "--steps", str(STUDY_STEPS), "--only", *STUDY_ABLATION,
                               "--device", device.type])
    if device.type == "cuda":
        torch.cuda.synchronize()
    matrix = dict(sampler_ablation.MATRIX)
    expect = 0
    if device.type == "cuda":
        for name in STUDY_ABLATION:  # the guided run and the control, each one group of 2 in one chunk
            run = {"batch_size": 128, "num_sampling_steps": STUDY_STEPS, "num_samples": 2, "ensemble_batch": 3,
                   "num_corrections": matrix[name].get("corrections", 0)}
            expect += 2 * n_attn * _expected_forwards(run, hours, window)
    summary = json.loads((out_dir / "ablation.json").read_text())
    table = (out_dir / "ABLATION.md").read_text().splitlines()
    rec = {"rows": [ln for ln in table if ln.startswith("| ") and ln.split("|")[1].strip() in STUDY_ABLATION],
           "finite": all(np.isfinite(x) for cell in summary.values() for kind in cell.values() for x in kind.values()),
           "reports": [(out_dir / n / "FIDELITY.md").exists() for n in STUDY_ABLATION],
           "attention_launches": counts["attention_fwd"], "expected_launches": expect}
    emit("15d", t0, **rec)
    if len(rec["rows"]) != 2 or set(summary) != set(STUDY_ABLATION) or not rec["finite"] or not all(rec["reports"]):
        raise AssertionError(f"the ablation's table or scores are incomplete: {rec}\n{printed.getvalue()[-3000:]}")
    if rec["attention_launches"] != expect:
        raise AssertionError(f"attention launches {rec['attention_launches']} != {expect}")
    return rec


def study_watch(root, paths, snapshot_dir, device, env) -> dict:
    """15e's process: ``scripts.probe_watcher`` on a run directory holding
    ``snapshot_dir`` under an on-cadence name (kdata 9,437: 9.0 Mi, every 3
    Mi) and an off-cadence one (9,961: 9.5 Mi), one poll at interval 0 and
    one idle poll; its probe is a process of its own."""
    run, probes = root / "watch", root / "probes"
    run.mkdir()
    for kdata in (9437, 9961):
        os.symlink(os.path.abspath(snapshot_dir), run / f"network-snapshot-{kdata:07d}-0.999900")
    cmd = [sys.executable, "-m", "climate2weather_tpu_torch.scripts.probe_watcher", str(run), str(probes),
           "--data-nc", paths["data"], "--quantiles", paths["quantiles"], "--start-time", STUDY_START,
           "--every-mi", "3", "--rate", "0.999900", "--num-samples", "2", "--steps", str(STUDY_STEPS),
           "--poll-sec", "0", "--max-idle-polls", "1", "--device", device.type]
    (out,), seconds, _ = _run_processes([cmd], [env], label="15e watcher")
    return {"out": out, "seconds": seconds, "run": run, "probes": probes}


def phase15e_check(rec, device, n_attn, window, hours, env) -> dict:
    """15e: exactly the due snapshot probed, in a process of its own, its
    ``FIDELITY.md`` written and ``progression_report`` tabulating it; the
    planted faults, a 2-Mi cadence and another EMA rate, find nothing due."""
    from climate2weather_tpu_torch.scripts import probe_watcher, progression_report

    t0 = time.time()
    lines = rec["out"].splitlines()
    rows = list(progression_report.progression_rows(rec["probes"]))
    table = progression_report.format_table(rows, ["w2", "melr", "ssim", "crps", "spread_skill", "rank_ri"])
    probe = _process_launches(env, "climate2weather_tpu_torch/exp/fidelity.py")
    run = {"batch_size": 128, "num_sampling_steps": STUDY_STEPS, "num_samples": 2, "ensemble_batch": 3,
           "num_corrections": 0}
    expect = 2 * n_attn * _expected_forwards(run, hours, window) if device.type == "cuda" else 0
    out = {"probed": [ln for ln in lines if "probing" in ln], "exits": [ln for ln in lines if " rc=" in ln],
           "idle_exit": any("idle limit reached" in ln for ln in lines),
           "probe_dirs": sorted(p.name for p in rec["probes"].iterdir()),
           "table_rows": [ln for ln in table.splitlines() if ln.startswith("| 9.44M")],
           "fault_cadence_2mi": probe_watcher.due_snapshots(rec["run"], "0.999900", 2),
           "fault_rate": probe_watcher.due_snapshots(rec["run"], "0.999000", 3),
           "launches": probe, "expected_launches": expect, "watcher_s": rec["seconds"]}
    emit("15e", t0, **out)
    if len(out["probed"]) != 1 or "network-snapshot-0009437-0.999900" not in out["probed"][0] or \
            out["exits"] != ["[probe_watcher] network-snapshot-0009437-0.999900 rc=0"] or not out["idle_exit"]:
        raise AssertionError(f"the watcher did not probe exactly the due snapshot once: {out}\n{rec['out'][-3000:]}")
    if out["probe_dirs"] != ["9437"] or [k for k, _ in rows] != [9437] or len(out["table_rows"]) != 6:
        raise AssertionError(f"the progression table does not hold the probe: {out}\n{table}")
    if out["fault_cadence_2mi"] or out["fault_rate"]:
        raise AssertionError(f"a planted cadence or rate found snapshots due: {out}")
    if probe["attention_fwd"] != expect:
        raise AssertionError(f"the probe's attention launches {probe}, want {expect}")
    return out


def study_design(root, paths, ablation_dir, env) -> dict:
    """15f's ``scripts.calibration_design_study`` on 15d's first guided run,
    a process of its own (host numpy, beside 15c); returns its table's rows
    and seconds."""
    guided = ablation_dir / STUDY_ABLATION[0] / "guided" / "001_config"
    cmd = [sys.executable, "-m", "climate2weather_tpu_torch.scripts.calibration_design_study", "--guided-dir",
           str(guided), "--train-h5", paths["train"], "--quantiles", paths["quantiles"], "--out",
           str(root / "design_study.md")]
    _, seconds, _ = _run_processes([cmd], [env], label="15f design study")
    rows = [ln for ln in (root / "design_study.md").read_text().splitlines()
            if ln.startswith("| ") and "---" not in ln and "variant" not in ln]
    return {"rows": rows, "seconds": seconds}


def phase15f_posthoc(root, sweep_dir, ablation_dir, design) -> dict:
    """15f: ``scripts.spectral_bands`` on 15d's cells, ``amplitude_ratio`` on
    15c's trials and 15d's guided runs, and ``design``, the rows of
    :func:`study_design`: every value finite; the planted fault, a NaN in
    one sample's copy, shows in ``amplitude_ratio``."""
    import contextlib
    import io
    import shutil

    from climate2weather_tpu_torch.data.grid import GridDataset, open_grid
    from climate2weather_tpu_torch.scripts import amplitude_ratio, spectral_bands

    t0 = time.time()
    cells = [ablation_dir / n for n in STUDY_ABLATION]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        spectral_bands.main([str(c) for c in cells])
    bands = [ln for ln in printed.getvalue().splitlines() if ln.startswith("| ") and "---" not in ln
             and "variable" not in ln]
    cfg_dirs = sorted(sweep_dir.glob("trials/t*/0*")) + [c / "guided" / "001_config" for c in cells]
    amp = [ln for ln in amplitude_ratio.report([str(d) for d in cfg_dirs]).splitlines()
           if ln.startswith("| ") and "---" not in ln and "variable" not in ln]
    design_rows = design["rows"]
    nan_dir = root / "nan_case"
    nan_dir.mkdir()
    shutil.copy(cfg_dirs[0] / "ground_truth.nc", nan_dir / "ground_truth.nc")
    smp = open_grid(str(cfg_dirs[0] / "gen_sample_000.nc"))
    planted = {k: v.copy() for k, v in smp.data_vars.items()}
    planted["uas"][0, 0, 0] = np.nan
    GridDataset(planted, smp.coords, smp.attrs).to_file(str(nan_dir / "gen_sample_000.nc"))
    fault = amplitude_ratio.amplitude_ratios(nan_dir)
    vals = {"bands": _numbers(bands), "amplitude": _numbers([ln.split("|", 2)[2] for ln in amp]),
            "design": _numbers([ln.split("|", 3)[3] for ln in design_rows])}
    out = {"band_rows": len(bands), "amplitude_rows": len(amp), "design_rows": len(design_rows),
           "design_s": design["seconds"],
           "values": {k: len(v) for k, v in vals.items()},
           "finite": {k: bool(v) and all(np.isfinite(v)) for k, v in vals.items()},
           "fault_finite": bool(np.isfinite(fault["uas"]).all()), "cfg_dirs": len(cfg_dirs)}
    emit("15f", t0, **out)
    # 4 variables x 3 sources x 3 bands per cell; 4 rows per directory; 8
    # variants + the baseline x 2 winds
    if (out["band_rows"], out["amplitude_rows"], out["design_rows"]) != (24, 4 * len(cfg_dirs), 18):
        raise AssertionError(f"the post-hoc tables are incomplete: {out}")
    if not all(out["finite"].values()) or out["fault_finite"]:
        raise AssertionError(f"a post-hoc value is not finite, or the NaN went unseen: {out}")
    return out


def phase15_study(snapshot_dir, device, model_config=MODEL_CONFIG, res=128, hours=49, frames=140, seed=0,
                  soak=None, plain_spread=None) -> dict:
    """Phase 15, 15a-15f (see the module docstring), in one scratch
    directory, with the packages of PHASE15_BLOCKED unimportable in this
    process and in every process the phase starts. 15a's ``train`` process
    and 15e's watcher (with its probe) run on threads while this process
    fabricates 15a's checkpoint and runs 15d, 15c and 15a's yardstick, and
    15f's design study (host numpy, a process) runs on a thread from the end
    of 15d. ``soak`` is 15b's record from phase 10
    (run beside 10e on 10a's plain run); without one, 15b runs here, after
    its own plain run of 10a's command on a thread. ``plain_spread`` is
    10a's.
    Returns each part's record."""
    import shutil
    import tempfile
    import threading

    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    loaded_before = sorted(m for m in PHASE15_BLOCKED if sys.modules.get(m) is not None)
    for name in PHASE15_BLOCKED:
        sys.modules[name] = None
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-study-"))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        env = _study_env(device, root)
        data_path = root / "train.h5"
        write_training_h5(data_path, synthetic_inputs(frames, res, res, 4, 1, seed)[0])
        paths = write_predict_inputs(root, res, hours, seed)
        snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
        window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
        n_attn = _attention_blocks(snap_cfg["network_kwargs"])
        done, threads = {}, []

        def start(name, fn):
            def run():
                try:
                    done[name] = fn()
                except BaseException as e:  # noqa: BLE001 - raised again on this thread
                    done[name + "_error"] = e
            th = threading.Thread(target=run, daemon=True)
            th.start()
            threads.append(th)

        def join():
            for th in threads:
                th.join()
            errors = [v for k, v in done.items() if k.endswith("_error")]
            if errors:
                raise errors[0]

        start("15e", lambda: study_watch(root, paths, snapshot_dir, device, env))
        fab = study_fabricate(root, snapshot_dir)
        start("15a", lambda: study_resume(fab, data_path, device, model_config, res, seed, env))
        if soak is None:
            def own_soak():
                argv = _train_argv(root / "a_plain", data_path, model_config, res, 64, 32, 2048, seed, device,
                                   snapshot=2048)
                _run_processes([[sys.executable, "-m", "climate2weather_tpu_torch.train"] + argv], [env],
                               label="15b reference")
                return root / "a_plain" / "r"
            start("15b_reference", own_soak)
        try:
            d = phase15d_ablation(root, paths, snapshot_dir, device, n_attn, window, hours)
            start("design", lambda: study_design(root, paths, root / "ablation", env))
            c = phase15c_sweep(root, paths, snapshot_dir, device, hours, n_attn, window)
            ref = study_reference(snapshot_dir, data_path, device, model_config, res, seed)
        finally:
            join()
        f = phase15f_posthoc(root, pathlib.Path(c["dir"]), root / "ablation", done["design"])
        a = phase15a_check(done["15a"], ref, snapshot_dir, device, model_config, env, plain_spread)
        del ref
        e = phase15e_check(done["15e"], device, n_attn, window, hours, env)
        b = soak if soak is not None else phase15b_soak(root, data_path, device, model_config, res, seed,
                                                        done["15b_reference"], env)
        leaked = [r for r in _study_processes(env) if r["leaked"]]
        if leaked:
            raise AssertionError(f"a phase-15 process imported a blocked package: {leaked}")
        processes = len(_study_processes(env))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"15a": a, "15b": b, "15c": c, "15d": d, "15e": e, "15f": f, "processes": processes,
            "loaded_before": loaded_before}


def phase15_summary(study: dict) -> dict:
    """Phase 15's line: the gates' readings, the kill's ndata and each part's
    launches."""
    a, b, c, d, e = (study[k] for k in ("15a", "15b", "15c", "15d", "15e"))
    return {"resume_bits_equal": a["bits_equal"], "resume_max_abs_diff": a["max_abs_diff"],
            "old_loader_fault_max_abs_diff": a["fault_max_abs_diff"], "resume_counts": [a["adam_count"],
                                                                                       a["schedule_count"]],
            "soak_killed_at_ndata": b["restarts"][0].get("killed_at_ndata"),
            "soak_common_log_points": b["common_log_points"], "soak_replayed": b["replayed_log_points"],
            "soak_fault_caught": b["fault_caught"], "sweep_scores": [r["score"] for r in c["rows"]],
            "ablation_rows": len(d["rows"]), "probed": e["probe_dirs"], "processes": study["processes"],
            "launches": study_launches(study)}


def study_launches(study: dict) -> dict:
    """The attention launches of each part of phase 15, by kernel."""
    a, b, c, d, e = (study[k] for k in ("15a", "15b", "15c", "15d", "15e"))
    return {"attention_fwd": {"15a": a["launches"]["attention_fwd"], "15b": (b["launches"] or {}).get("attention_fwd"),
                              "15c": c["attention_launches"], "15d": d["attention_launches"],
                              "15e": e["launches"]["attention_fwd"]},
            "attention_bwd": {"15a": a["launches"]["attention_bwd"],
                              "15b": (b["launches"] or {}).get("attention_bwd")}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:  # one process of phase 10 (see child_step, child_cli)
        sys.path.insert(0, str(REPO))
        sys.modules.setdefault("chip_smoke", sys.modules[__name__])
        if argv[1] == "step":  # --child step ARGS [-- train ARGS]: the step check, then a run
            rest = argv[2:]
            cut = rest.index("--") if "--" in rest else len(rest)
            out = {"step_check": child_step(rest[:cut])}
            out.update(child_cli("train", rest[cut + 1:]) if cut < len(rest) else {})
        elif argv[1] == "split":  # --child split SPEC: one rank of 10e
            out = child_split(argv[2:])
        else:
            out = child_cli(argv[1], argv[2:])
        print(CHILD_PREFIX + json.dumps(out), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--winograd-only", action="store_true",
                    help="phases 0 and 1, then phase 2's Winograd checks and timings, and stop "
                         "(a copy of this file run from another checkout's root times that "
                         "checkout's kernel by this method)")
    ap.add_argument("--checks-only", action="store_true",
                    help="phases 0 and 1, then phases 2, 3 and 3b (each kernel against its plain version and "
                         "float64, with the planted faults), each run even if one before it failed, and stop "
                         "(no device line); one call fits seeds 0-9")
    ap.add_argument("--attention-bwd-only", action="store_true",
                    help="phases 0 and 1, then phase 2's attention backward checks and timings, "
                         "and stop (likewise for another checkout's backward)")
    ap.add_argument("--multi-process-only", action="store_true",
                    help="phases 0 and 1, then phase 10 (multi-process training, striped and split predict, "
                         "the supervisor), and stop (no device line)")
    ap.add_argument("--data-only", action="store_true",
                    help="phases 0 and 1, then phase 11 (the offline data layer from the netCDF-C fixtures and a "
                         "raw archive to a guided predict), and stop (no device line)")
    ap.add_argument("--model-only", action="store_true",
                    help="phases 0 and 1, then phase 12 (the reference's pickle imported, the fused tail, the 1-D "
                         "and 3-D nets), and stop (no device line)")
    ap.add_argument("--store-only", action="store_true",
                    help="phases 0 and 1, then phase 13 (fill values, the zarr store and its codec, a predict from "
                         "zarr stores, the figure data), and stop (no device line)")
    ap.add_argument("--host-stream-only", action="store_true",
                    help="phases 0 and 1, then phase 14 (the host-streaming tier against the device path, its "
                         "memory bound, a host-streamed predict), and stop (no device line)")
    ap.add_argument("--study-only", action="store_true",
                    help="phases 0 and 1, then phase 15 (the study and operations drivers: fabricated resume, "
                         "soak, sweep, ablation, probe watcher, post-hoc diagnostics; 15b with its own plain "
                         "run), and stop (no device line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs on the card only",
              file=sys.stderr)
        return 2
    import shutil
    import tempfile

    # The card's host sets PYTHONDONTWRITEBYTECODE and ships torch without
    # bytecode, so every process would compile torch's sources anew, most
    # of a child's start. This run and the processes it starts share one
    # bytecode cache instead.
    pycache = tempfile.mkdtemp(prefix="c2w-pycache-")
    sys.pycache_prefix, sys.dont_write_bytecode = pycache, False
    os.environ["PYTHONPYCACHEPREFIX"] = pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    try:
        return _run(args)
    finally:
        shutil.rmtree(pycache, ignore_errors=True)


def _run(args) -> int:
    """The phases ``args`` select, on the card."""
    sys.path.insert(0, str(REPO))
    from climate2weather_tpu_torch.utils.device import set_reference_numerics

    set_reference_numerics()
    device = torch.device("cuda", 0)
    # the training phase names this script's classes by their dotted path
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    t_all = time.time()
    phase0_card()
    phase1_build()
    if args.winograd_only or args.attention_bwd_only:
        t0 = time.time()
        g = torch.Generator(device=device).manual_seed(args.seed)
        if args.winograd_only:
            checks, wino_rows = phase2_winograd(device, g)
            emit(2, t0, checks=checks, timing_winograd=wino_rows)
            _raise_failed("phase 2", checks)
        else:
            checks, bwd_row, bwd_long, bwd_exact = phase2_backward(device, g)
            emit(2, t0, checks=checks, timing=[bwd_row], timing_t256=[bwd_long], timing_exact_bwd=bwd_exact)
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    if args.checks_only:
        failed = []
        for phase, run in ((2, lambda: phase2_kernels(device, args.seed)),
                           (3, lambda: phase3_network(SNAPSHOT, device, seed=args.seed)),
                           ("3b", lambda: phase3b_winograd_blocks(SNAPSHOT, device, seed=args.seed))):
            try:
                run()
            except AssertionError as e:  # the next phase's readings are wanted all the same
                failed.append(f"phase {phase}: {e}")
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        if failed:
            raise AssertionError("\n".join(failed))
        return 0
    if args.multi_process_only:
        t10 = time.time()
        emit(10, t10, **phase10_summary(phase10_multi_process(SNAPSHOT, device, seed=args.seed)))
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    if args.data_only:
        t11 = time.time()
        emit(11, t11, **phase11_summary(phase11_data(SNAPSHOT, device, seed=args.seed)))
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    if args.model_only:
        t12 = time.time()
        emit(12, t12, **phase12_summary(phase12_model(SNAPSHOT, device, seed=args.seed)))
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    if args.store_only:
        t13 = time.time()
        emit(13, t13, **phase13_summary(phase13_store(SNAPSHOT, device, seed=args.seed)))
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    if args.host_stream_only:
        t14 = time.time()
        emit(14, t14, **phase14_summary(phase14_host_stream(SNAPSHOT, device, seed=args.seed)))
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    if args.study_only:
        t15 = time.time()
        emit(15, t15, **phase15_summary(phase15_study(SNAPSHOT, device, seed=args.seed)))
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    rows, year_fwd, exact_bwd = phase2_kernels(device, args.seed)
    phase3_network(SNAPSHOT, device, seed=args.seed)
    blocks = phase3b_winograd_blocks(SNAPSHOT, device, seed=args.seed)
    main_path = phase4_slice(SNAPSHOT, CONFIG, device, seed=args.seed)
    training = phase5_training(device, seed=args.seed)
    phase6_predict(SNAPSHOT, device, seed=args.seed)
    phase7_tiny_training(device, seed=args.seed)
    t8 = time.time()
    year = phase8_year(SNAPSHOT, device, seed=args.seed)
    emit(8, t8, launches=year["launches"])
    t9 = time.time()
    modes = phase9_modes(SNAPSHOT, device, seed=args.seed)
    emit(9, t9, launches={"9a": modes["9a"]["launches"], "9c": modes["9c"]["attention_launches"]})
    t10 = time.time()
    ranks = phase10_multi_process(SNAPSHOT, device, seed=args.seed, soak=True)
    emit(10, t10, **phase10_summary(ranks))
    t11 = time.time()
    data = phase11_data(SNAPSHOT, device, seed=args.seed)
    emit(11, t11, **phase11_summary(data))
    import shutil
    import tempfile

    kept = pathlib.Path(tempfile.mkdtemp(prefix="c2w-12c-"))
    try:
        t12 = time.time()
        model = phase12_model(SNAPSHOT, device, seed=args.seed, keep_predict=kept / "12c")
        emit(12, t12, **phase12_summary(model))
        t13 = time.time()
        store = phase13_store(SNAPSHOT, device, seed=args.seed, compare_dir=kept / "12c")
        emit(13, t13, **phase13_summary(store))
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    t14 = time.time()
    stream = phase14_host_stream(SNAPSHOT, device, seed=args.seed)
    emit(14, t14, **phase14_summary(stream))
    t15 = time.time()
    study = phase15_study(SNAPSHOT, device, seed=args.seed, soak=ranks["15b"],
                          plain_spread=ranks["10a"]["plain_spread"])
    emit(15, t15, **phase15_summary(study))
    # each kernel's launches on its own path: sampling for the forward (and
    # the year path's, at its own shape), training for the backward, the
    # ModResidualBlock composition for the Winograd conv
    rows["attention_fwd"]["launches"] = main_path["launches"]["attention_fwd"]
    rows["attention_fwd"]["year_path"] = {"launches": year["launches"], **{
        k: year_fwd[k] for k in ("shape", "max_abs_err", "ms", "graph_ms", "host_ms", "plain_ms", "bound_ms",
                                 "library_ms", "library_graph_ms")}}
    rows["attention_bwd"]["launches"] = training["launches"]["attention_bwd"]
    # exact guidance puts the backward on the sampling paths: its launches
    # there (phase 9a, and 9c's year chunks) and its times at 9a's shape
    rows["attention_bwd"]["exact_path"] = {
        "launches": modes["9a"]["launches"]["attention_bwd"],
        "year_path_launches": modes["9c"]["attention_launches"]["attention_bwd"], **{
            k: exact_bwd[k] for k in ("shape", "max_abs_err", "ms", "graph_ms", "host_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "library_graph_ms")}}
    # phase 10: the launches of each rank of the 2-rank training (10b), the
    # striped predict (10c) and the split samples (10e)
    split = ranks["10e"]["jobs"]
    for name in ("attention_fwd", "attention_bwd"):
        rows[name]["multi_process"] = {
            "10b_launches_per_rank": [lr[name] for lr in ranks["10b"]["launches_per_rank"]],
            "10c_launches_per_rank": [lr[name] for lr in ranks["10c"]["launches_per_rank"]],
            # 10e: one sample split over 2 ranks, against the one-process run
            **{f"10e_{k}_launches_per_rank": [lr[name] for lr in split[k]["launches_per_rank"]]
               for k in ("year", "short", "exact")},
            **{f"10e_{k}_launches_one_process": split[k]["launches_one"][name] for k in ("year", "short", "exact")}}
    # phase 11: the training on the drill's file (11b) and the guided
    # predict from the debiased file (11d)
    rows["attention_fwd"]["data_path"] = {"11b_launches": data["11b"]["train_launches"]["attention_fwd"],
                                          "11d_launches": data["11d"]["launches"]["attention_fwd"]}
    rows["attention_bwd"]["data_path"] = {"11b_launches": data["11b"]["train_launches"]["attention_bwd"]}
    # phase 12: the imported net's forward (12b) and predict (12c), and the
    # 1-D and 3-D nets' forward and backward (12e)
    nd = {f"12e_{s}d_launches": model["12e"][s]["launches"] for s in model["12e"]}
    rows["attention_fwd"]["model_path"] = {"12b_launches": model["12b"]["attention_fwd_launches"],
                                           "12c_launches": model["12c"]["attention_fwd_launches"],
                                           **{k: v["attention_fwd"] for k, v in nd.items()}}
    rows["attention_bwd"]["model_path"] = {k: v["attention_bwd"] for k, v in nd.items()}
    # phase 13: the guided predict from zarr stores
    rows["attention_fwd"]["store_path"] = {"13c_launches": store["13c"]["attention_fwd_launches"]}
    # phase 14: one host-streamed evaluation at 523 frames (14a), the
    # host tier's DPM-Solver++(2M) run there (14b) and its predict (14e)
    rows["attention_fwd"]["host_stream_path"] = {f"{k}_launches": stream[k]["attention_launches"]
                                                 for k in ("14a", "14b", "14e")}
    # phase 15: the fabricated resume (15a), the soak's finishing start
    # (15b), the sweep (15c), the ablation (15d) and the watcher's probe (15e)
    for name, by_part in study_launches(study).items():
        rows[name]["study_path"] = {f"{k}_launches": v for k, v in by_part.items()}
    rows["winograd_conv3x3"]["launches"] = blocks["launches"]
    # the channel norm's launches on the main paths (each gated against the
    # forwards and backwards of its phase): sampling (4), training (5, both
    # runs) and exact guidance's forwards and VJPs (9a)
    for name in ("channel_norm_fwd", "channel_norm_bwd"):
        rows[name]["launches"] = {"4": main_path["norm_launches"][name], "5": training["norm_launches"][name],
                                  "9a": modes["9a"]["norm_launches"][name]}
    print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
