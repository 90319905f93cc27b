"""ndata-driven training loop, one card per rank (port of
climate2weather_tpu/training/loop.py).

Kept from the JAX loop: the batch math and its asserts; status, EMA
snapshot, validation sampling, scalar logging and checkpoint blocks at the
same ndata multiples (with the ``done or`` clauses that write the final
snapshot, log and checkpoint at a stop that is not a multiple); always-on
resume through ``load_latest`` with the batch-size check; ``slice_ndata``;
the choice between a device-resident dataset (windows gathered on the card,
only indices cross per step) and the streaming loader under
``C2W_DEVICE_DATA_BUDGET``; ``C2W_REMAT``; ``C2W_PROFILE_DIR``, here a
``torch.profiler`` trace that carries the steps' spans (``utils/trace.py``).
Host copies for checkpoints and snapshots are made on the main thread; only
the file writes run on the writer thread.

Several ranks (a process group started by ``parallel.mesh``): the world
size is the group's, each rank takes its ``batch_size // world`` rows a step
from the rank-strided sampler, seeds Python's and numpy's streams with its
rank, and holds the dataset on its own card; the train step sums the
gradients over the ranks (``training/state.py``). Rank 0 alone prints the
status line, writes snapshots and checkpoints, samples for validation and
profiles, as in JAX; none of these holds a collective. Every rank resumes
from the same ``load_latest``, and after each checkpoint the ranks meet in
a barrier once rank 0's write is complete, so no rank goes on while the
file is half written.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from climate2weather_tpu_torch.convert import to_flax_params
from climate2weather_tpu_torch.data.dataset import InfiniteSampler, PrefetchLoader
from climate2weather_tpu_torch.diffusion import process as _process  # noqa: F401 (registers)
from climate2weather_tpu_torch.diffusion.sampler import sample as pc_sample
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
from climate2weather_tpu_torch.models.init import init_params
from climate2weather_tpu_torch.models.score_net import build_score_unet
from climate2weather_tpu_torch.parallel import mesh
from climate2weather_tpu_torch.training.checkpoint import (
    AsyncWriter,
    CheckpointIO,
    prune_checkpoints,
    save_snapshot,
    state_to_flax,
)
from climate2weather_tpu_torch.training.ema import rate_key
from climate2weather_tpu_torch.training.lr import make_schedule
from climate2weather_tpu_torch.training.state import (
    init_train_state,
    make_device_data_train_step,
    make_optimizer,
    make_train_step,
    step_generator,
    upload_dataset,
)
from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics
from climate2weather_tpu_torch.utils.easydict import EasyDict
from climate2weather_tpu_torch.utils.logging import (
    RunLogger,
    trajectory_to_imgrid,
    value_histogram_image,
)
from climate2weather_tpu_torch.utils.registry import construct_class_by_name
from climate2weather_tpu_torch.utils.seeding import derive_seed, set_random_seed
from climate2weather_tpu_torch.utils.summary import print_module_summary


def _device_data_dtype(device_data, data_nbytes: int, budget: int):
    """fp32 if the [T, C, H, W] store fits the budget, bf16 if half of it
    does, else None (stream from the host)."""
    if not device_data:
        return None
    if data_nbytes <= budget:
        return torch.float32
    if data_nbytes // 2 <= budget:
        return torch.bfloat16
    if device_data != "auto":
        print(
            f"WARNING: device_data requested but dataset ({data_nbytes / 2**30:.1f} GiB) "
            f"exceeds the device budget even in bf16; falling back to the streaming loader."
        )
    return None


def training_loop(
    run_dir,
    *,
    dataset_kwargs,
    network_kwargs,
    pipeline_kwargs,
    optimizer_kwargs,
    lr_kwargs,
    batch_size,
    batch_gpu,
    total_ndata,
    log_ndata,
    status_ndata,
    snapshot_ndata,
    checkpoint_ndata,
    valid_ndata,
    ema_kwargs=None,
    slice_ndata=None,
    seed=0,
    loss_scaling=1,
    logger: RunLogger | None = None,
    device="cuda",
    compute_dtype=torch.bfloat16,
    loader_threads=2,
    device_data="auto",
):
    dev = resolve_device(device)
    set_reference_numerics()
    prev_status_time = time.time()
    # interval == 0 disables the corresponding side effect
    norm = lambda v: None if not v else v  # noqa: E731
    log_ndata, status_ndata = norm(log_ndata), norm(status_ndata)
    snapshot_ndata, checkpoint_ndata = norm(snapshot_ndata), norm(checkpoint_ndata)
    valid_ndata, slice_ndata = norm(valid_ndata), norm(slice_ndata)
    rank, world_size = mesh.rank(), mesh.world_size()
    main_rank = rank == 0
    set_random_seed(seed, rank)

    # -- batch math (training_loop.py:58-72) -------------------------------
    batch_gpu_total = batch_size // world_size
    if batch_gpu is None or batch_gpu > batch_gpu_total:
        batch_gpu = batch_gpu_total
    num_accumulation_rounds = batch_gpu_total // batch_gpu
    assert batch_size == batch_gpu * num_accumulation_rounds * world_size
    assert total_ndata % batch_size == 0
    assert slice_ndata is None or slice_ndata % batch_size == 0
    assert log_ndata is None or log_ndata % batch_size == 0
    assert status_ndata is None or status_ndata % batch_size == 0
    assert snapshot_ndata is None or (snapshot_ndata % batch_size == 0 and snapshot_ndata % 1024 == 0)
    assert checkpoint_ndata is None or (
        checkpoint_ndata % batch_size == 0 and checkpoint_ndata % 1024 == 0
    )
    assert valid_ndata is None or valid_ndata % batch_size == 0

    # -- dataset -----------------------------------------------------------
    print("Setting up datasets...")
    dataset_kwargs = EasyDict.from_nested(dataset_kwargs)
    train_dataset = construct_class_by_name(**dataset_kwargs.train)
    if "valid" in dataset_kwargs:
        print("WARNING: Validation dataset provided but currently not supported.")

    # -- network: flax-style init from the seed, on the host, then moved ---
    print("Setting up network...")
    net = build_score_unet(network_kwargs, dtype=compute_dtype)
    print(f"Data shape: {train_dataset[0].shape}")
    init_params(net, torch.Generator().manual_seed(derive_seed(seed, "global-train-stream", "init")))
    net = net.to(dev)
    if main_rank:
        print_module_summary(net, name="score_unet")

    # -- process / optimizer / EMA / state ---------------------------------
    process = construct_class_by_name(**pipeline_kwargs)
    schedule = make_schedule(lr_kwargs, batch_size)
    optimizer = make_optimizer(net.parameters(), optimizer_kwargs)
    ema_rates = tuple((ema_kwargs or {}).get("rates", (0.9999,)))
    state = init_train_state(net, optimizer, ema_rates)

    # -- device-resident dataset decision ----------------------------------
    window = int(dataset_kwargs.train.window)
    data_nbytes = int(np.prod(train_dataset.raw_data_shape)) * 4
    budget = int(os.environ.get("C2W_DEVICE_DATA_BUDGET", 8 << 30))
    device_data_dtype = _device_data_dtype(device_data, data_nbytes, budget)
    use_device_data = device_data_dtype is not None
    remat = bool(int(os.environ.get("C2W_REMAT", "0")))
    if use_device_data:
        train_step = make_device_data_train_step(process, schedule, window, ema_rates,
                                                 loss_scaling, remat=remat)
    else:
        train_step = make_train_step(process, schedule, ema_rates, loss_scaling,
                                     channels_first=True, remat=remat)

    # -- resume ------------------------------------------------------------
    # cur_ndata = step * batch_size, so a checkpoint resumes only with the
    # batch size it was written with
    ckpt_io = CheckpointIO(state=state, meta={"batch_size": batch_size})
    loaded = ckpt_io.load_latest(run_dir)
    if loaded is not None:
        saved_bs = int(ckpt_io.state_objs["meta"]["batch_size"])
        if saved_bs != batch_size:
            raise ValueError(
                f"Checkpoint was written with --batch {saved_bs}; resuming "
                f"with --batch {batch_size} would corrupt the ndata/LR/data "
                f"stream accounting. Use the original batch size."
            )
    start_ndata = state.step * batch_size
    stop_at_ndata = total_ndata
    if slice_ndata is not None:
        granularity = (
            checkpoint_ndata if checkpoint_ndata is not None
            else snapshot_ndata if snapshot_ndata is not None
            else batch_size
        )
        slice_end = (start_ndata + slice_ndata) // granularity * granularity
        stop_at_ndata = min(stop_at_ndata, slice_end)
    assert stop_at_ndata > start_ndata or start_ndata >= total_ndata
    print(f"Training from {start_ndata // 1000} kdata to {stop_at_ndata // 1000} kdata:")
    print(
        f"Batch size: {batch_size} (per device: {batch_gpu}; "
        f"accumulation rounds: {num_accumulation_rounds})"
    )

    # -- input pipeline ----------------------------------------------------
    sampler = InfiniteSampler(dataset_size=len(train_dataset), rank=rank, num_replicas=world_size,
                              shuffle=True, seed=seed, start_idx=start_ndata)
    local_batch = batch_size // world_size
    if use_device_data:
        print(
            f"Uploading dataset to the device ({data_nbytes / 2**30:.2f} GiB fp32 as "
            f"{str(device_data_dtype).replace('torch.', '')}) ..."
        )
        source = train_dataset._cache if train_dataset._cache is not None else train_dataset._reader()
        device_data_arr = upload_dataset(source, train_dataset.raw_data_shape[0],
                                         dtype=device_data_dtype, device=dev)
        index_iter = iter(sampler)
        loader = None
        print("Dataset resident on device; per-step transfer is indices only.")
    else:
        loader = PrefetchLoader(train_dataset, sampler,
                                batch_size=local_batch // num_accumulation_rounds,
                                rounds=num_accumulation_rounds,
                                num_threads=loader_threads).start()

    # -- snapshot config (data only) ---------------------------------------
    snap_config = {
        "network_kwargs": EasyDict(network_kwargs).to_plain(),
        "dataset_kwargs": EasyDict(dataset_kwargs).to_plain(),
        "pipeline_kwargs": EasyDict(pipeline_kwargs).to_plain(),
    }

    writer = AsyncWriter()
    cur_ndata = start_ndata
    prev_status_ndata = cur_ndata
    total_elapsed_time = 0.0
    losses_accum = []  # device scalars; read only at log time
    last_loss = None
    valid_markov_order = dataset_kwargs.train.window // 2
    valid_net = None
    valid_gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, 0))
    profiler = None

    while True:
        done = cur_ndata >= stop_at_ndata

        # ---- status (training_loop.py:210-231)
        if (
            status_ndata is not None
            and (done or cur_ndata % status_ndata == 0)
            and (cur_ndata != start_ndata or start_ndata == 0)
            and main_rank
        ):
            if last_loss is not None:
                last_loss.item()  # the device has finished the tick's steps
            cur_time = time.time()
            total_elapsed_time += cur_time - prev_status_time
            denom = max(cur_ndata - prev_status_ndata, 1)
            print(
                " +++ ".join([
                    "Status:",
                    f"{cur_ndata} / {total_ndata} ({cur_ndata / total_ndata:.2%})",
                    f"{total_elapsed_time:.2f} sec total",
                    f"{cur_time - prev_status_time:.2f} sec/tick",
                    f"{(cur_time - prev_status_time) / denom * 1e3:.3f} sec/kdata",
                ]),
                flush=True,
            )
            prev_status_ndata = cur_ndata
            prev_status_time = cur_time

        # ---- EMA snapshot (training_loop.py:234-267), fp16 payload
        if (
            snapshot_ndata is not None
            and (done or cur_ndata % snapshot_ndata == 0)
            and cur_ndata != start_ndata
            and main_rank
        ):
            for rate in ema_rates:
                snap_host = to_flax_params(
                    {k: v.to(torch.float16) for k, v in state.emas[rate_key(rate)].items()}
                )
                writer.submit(
                    lambda nd=cur_ndata, rk=rate_key(rate), sp=snap_host: save_snapshot(
                        run_dir, nd // 1000, rk, sp, snap_config, half_precision=True
                    )
                )

        # ---- validation sampling (training_loop.py:270-325)
        if (
            valid_ndata is not None
            and logger is not None  # results are only consumed by the logger
            and cur_ndata % valid_ndata == 0
            and (cur_ndata != start_ndata or start_ndata == 0)
            and main_rank
        ):
            tr = dataset_kwargs.train
            noise = torch.randn((tr.window, tr.spatial_res, tr.spatial_res, tr.num_features),
                                generator=valid_gen, device=dev)
            if valid_net is None:
                valid_net = build_score_unet(network_kwargs, dtype=compute_dtype).to(dev).eval()
            for rate in ema_rates:
                valid_net.load_state_dict(state.emas[rate_key(rate)])
                sf = WindowScoreFn(valid_net, valid_markov_order)
                gen, nan_flag = pc_sample(process, sf, noise, steps=100)
                gen = gen.cpu().numpy()
                logger.log_image(f"gen_sample-{rate_key(rate)}", trajectory_to_imgrid(gen),
                                 cur_ndata // 1000)
                logger.log_image(f"value_histogram-{rate_key(rate)}", value_histogram_image(gen),
                                 cur_ndata // 1000)
                logger.log({
                    "train/kdata": cur_ndata // 1000,
                    f"valid/sample_nan-{rate_key(rate)}": bool(nan_flag),
                    f"valid/sample_nonfinite-{rate_key(rate)}": int((~np.isfinite(gen)).sum()),
                    f"valid/sample_mean-{rate_key(rate)}": float(np.mean(gen)),
                    f"valid/sample_std-{rate_key(rate)}": float(np.std(gen)),
                })

        # ---- scalar logging (training_loop.py:333-350)
        if log_ndata is not None and (done or cur_ndata % log_ndata == 0) and cur_ndata != start_ndata:
            if logger is not None:
                logger.log({
                    "train/loss": float(torch.stack(losses_accum).mean()) if losses_accum else None,
                    "train/kdata": cur_ndata // 1000,
                    "train/ndata": cur_ndata,
                    "train/elapsed_time": total_elapsed_time,
                    "train/lr": float(schedule(cur_ndata // batch_size)),
                })
            losses_accum = []

        # ---- checkpoint (training_loop.py:353-363): host copy here, write
        # on the writer thread; under a process group rank 0 waits for the
        # write, then every rank meets in the barrier
        if (
            checkpoint_ndata is not None
            and (done or cur_ndata % checkpoint_ndata == 0)
            and cur_ndata != start_ndata
        ):
            if main_rank:
                state_host = state_to_flax(state)
                ckpt_path = os.path.join(run_dir, f"training-state-{cur_ndata // 1000:07d}.ckpt")
                keep_last = int(os.environ.get("C2W_CKPT_KEEP", 0))

                def _write_ckpt(sc=state_host, path=ckpt_path, keep=keep_last):
                    CheckpointIO(state=sc, meta={"batch_size": batch_size}).save(path)
                    if keep > 0:
                        prune_checkpoints(run_dir, keep)

                writer.submit(_write_ckpt)
                if mesh.distributed():
                    writer.flush()
            mesh.barrier(dev)

        if done:
            break

        # ---- optional profiler trace over steps 2..5 of this run
        profile_dir = os.environ.get("C2W_PROFILE_DIR")
        if profile_dir and main_rank and cur_ndata == start_ndata + 2 * batch_size:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        if profiler is not None and cur_ndata == start_ndata + 6 * batch_size:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            profiler = None
            print(f"Profiler trace written to {profile_dir}")

        # ---- optimization step: the step index seeds its (t, eps) draws,
        # so they replay exactly across a resume
        generator = step_generator(seed, cur_ndata // batch_size, dev)
        if use_device_data:
            idx = np.fromiter((next(index_iter) for _ in range(local_batch)), np.int64,
                              count=local_batch).reshape(num_accumulation_rounds, -1)
            idx = torch.from_numpy(idx).to(dev)
            state, loss = train_step(state, device_data_arr, idx, generator)
        else:
            batch = torch.from_numpy(next(loader)).to(dev)  # [rounds, B_local, w*C, H, W]
            state, loss = train_step(state, batch, generator)
        last_loss = loss
        if log_ndata is not None:  # only the log block empties the list
            losses_accum.append(loss)
        cur_ndata += batch_size

    if profiler is not None:
        profiler.stop()
    writer.close()
    if loader is not None:
        loader.stop()
    print("Training complete.")
    return state
