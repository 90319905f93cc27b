"""The port's multi-process paths (``parallel.mesh``) on the CPU, each rank a
real process started as torchrun starts one (``tests/_torch_parallel_child.py``)
and joined over gloo:

- the index stream of each rank of ``training_loop`` against JAX's
  process-strided ``InfiniteSampler`` for worlds of 1, 2 and 3;
- a 2-rank train step with the global draws injected against the JAX
  package's single-process ``train_step`` on the rank-major global batch
  (rtol/atol 2e-4, as ``tests/test_torch_training.py``) and against the
  port's one-process step on that batch in 2 rounds (bit for bit: the two
  gradient sums add the same two terms), and a planted fault (rank 1 keeps
  its own gradients) that breaks both;
- 2-rank ``training_loop`` runs: the ranks agree bit for bit, rank 0 alone
  writes checkpoints and snapshots, and a 2-rank resume equals an
  uninterrupted 2-rank run;
- a striped ``exp.downscaling.run`` equal bit for bit to the one-process
  ``run``, and to the JAX package's ``run`` at the limit of
  ``tests/test_torch_predict.py``, with rank 0 alone writing the shared
  files; under ``host_streaming``, ``num_samples`` not a multiple of the
  world refused before any output;
- the mesh's refusals: a partial launch environment, a ``LOCAL_RANK``
  without a card, a backend that fails to start (no fallback), and the
  single-process commands under a world above one.

Every spawned process has its own timeout (``TIMEOUT``) and is killed at it,
and a rank that fails ends the others at once, so a deadlock fails one test.
"""

import itertools
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import close, jax_net_and_params, jax_split_normals, tiny_config, torch_net, write_snapshot
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu.training import state as jstate
from climate2weather_tpu_torch.parallel import mesh

REPO = pathlib.Path(__file__).resolve().parents[1]
CHILD = pathlib.Path(__file__).with_name("_torch_parallel_child.py")
TIMEOUT = 120.0  # seconds, for each spawned process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, work: pathlib.Path, spec: dict, world) -> list:
    """Run ``world`` ranks of ``mode`` (``world=None``: one process with no
    launch environment) and return their outputs; fails when a rank fails
    or outlives ``TIMEOUT``, killing the rest."""
    (work / f"{mode}.json").write_text(json.dumps(spec))
    base = {k: v for k, v in os.environ.items() if k not in mesh.LAUNCH_ENV}
    envs = [base] if world is None else [
        dict(base, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
             MASTER_PORT=str(port))
        for port in (_free_port(),) for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(CHILD), mode, str(work)], env=env, cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for env in envs]
    deadline = time.monotonic() + TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {mode} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def _loop_kwargs(path, batch=256, batch_gpu=64, total=1024, checkpoint=1024, snapshot=None,
                 device_data="auto"):
    window = 3
    return dict(
        dataset_kwargs={"train": {"class_name": "cosmo_dataset", "data_path": path, "num_features": 2,
                                  "spatial_res": 16, "cached": True, "window": window, "flatten": True}},
        network_kwargs={"channels": 2 * window, "embedding_dim": 16, "hidden_channels": [8, 16],
                        "hidden_blocks": [1, 1], "attention_levels": [1]},
        pipeline_kwargs={"class_name": "vp_cosine"},
        optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-3},
        lr_kwargs={"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": 2048},
        batch_size=batch, batch_gpu=batch_gpu, total_ndata=total, log_ndata=None, status_ndata=None,
        snapshot_ndata=snapshot, checkpoint_ndata=checkpoint, valid_ndata=None, seed=0, device="cpu",
        loader_threads=1, device_data=device_data,
    )


# ---------------------------------------------------------------------------
# the data stream


@pytest.mark.parametrize("world", [1, 2, 3])
def test_rank_index_streams_equal_jax_sampler(tiny_h5, tmp_path, world):
    """Each rank of the loop takes ``batch // world`` window indices a step
    from the rank-strided sampler, in ``rounds`` rows: JAX's stream of
    process ``rank`` of ``world``, taken as the JAX loop takes it."""
    from climate2weather_tpu.data.dataset import InfiniteSampler as JaxSampler

    path, x = tiny_h5
    batch, batch_gpu, steps = 12, 2, 3
    kwargs = _loop_kwargs(path, batch=batch, batch_gpu=batch_gpu, total=batch * steps, checkpoint=None)
    spawn("sampler", tmp_path, {"tag": world, "run_dir": str(tmp_path / "run"), "kwargs": kwargs}, world)
    local, rounds = batch // world, batch // world // batch_gpu
    for r in range(world):
        got = json.loads((tmp_path / f"sampler-{world}-{r}.json").read_text())
        stream = iter(JaxSampler(dataset_size=len(x) - 2, rank=r, num_replicas=world, shuffle=True, seed=0))
        want = [np.array(list(itertools.islice(stream, local))).reshape(rounds, -1).tolist()
                for _ in range(steps)]
        assert got == want, r


# ---------------------------------------------------------------------------
# the train step


def _jax_draws(key, b, shape):
    """JAX's (t, eps) for a one-round step on ``b`` rows (state.py:98,
    process.py:59-61)."""
    rt, re = jax.random.split(jax.random.split(key, 1)[0])
    return (np.asarray(jax.random.uniform(rt, (b, 1, 1, 1), dtype=jnp.float32)),
            np.asarray(jax.random.normal(re, shape, dtype=jnp.float32)))


@pytest.fixture
def step_inputs(tmp_path):
    """The tiny net (JAX params, the port's copy saved for the ranks), a
    global batch of 4 rows with JAX's draws, and the JAX step's loss and
    gradients on it, captured as tests/test_torch_training.py does."""
    import optax

    from climate2weather_tpu_torch.convert import to_state_dict

    # an optax transformation whose state after one update is the gradient
    grad_capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))

    cfg = tiny_config(channels=10, window=5)
    net, params = jax_net_and_params(cfg)
    shape = (4, 16, 16, 10)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    t, eps = _jax_draws(key, 4, shape)
    step = jax.jit(jstate.make_train_step(net.apply, JaxProcess(), grad_capture, (0.999,)))
    new_state, loss = step(jstate.init_train_state(params, grad_capture, (0.999,)), jnp.asarray(x[None]), key)
    torch.save(torch_net(cfg, params).state_dict(), tmp_path / "net.pt")
    np.savez(tmp_path / "inputs.npz", x=x, t=t, eps=eps)
    spec = {"network_kwargs": cfg["network_kwargs"], "lr": 1e-3,
            "optimizer_kwargs": {"weight_decay": 1e-3}}
    return spec, float(loss), to_state_dict(jax.tree.map(np.asarray, new_state.opt_state))


def _step_results(work, tag, ranks):
    return [dict(np.load(work / f"step-{tag}-{r}.npz")) for r in range(ranks)]


def test_two_rank_step_equals_jax_and_the_one_process_step(step_inputs, tmp_path):
    spec, want_loss, want_grads = step_inputs
    spawn("step", tmp_path, dict(spec, tag="ranks", rounds=1), 2)
    spawn("step", tmp_path, dict(spec, tag="one", rounds=2), None)
    ranks = _step_results(tmp_path, "ranks", 2)
    (one,) = _step_results(tmp_path, "one", 1)
    # the mean gradient over the global batch and its loss, as JAX computes them
    for res in ranks:
        close(res["loss"], want_loss)
        for name, g in want_grads.items():
            close(res[f"grad/{name}"], g)
    # the same two terms summed: the one-process step's bits, on both ranks
    for res in ranks:
        assert set(res) == set(one)
        for k in one:
            np.testing.assert_array_equal(res[k], one[k], err_msg=k)


def test_two_rank_step_draws_its_rows_of_the_global_draws(step_inputs, tmp_path):
    """Without injected draws each rank draws the round's global (t, eps)
    from the step's generator and keeps its rows: the 2-rank step equals
    the one-process step on the whole global batch in one round, whose
    draws come from the same generator (2e-4: one backward over 4 rows
    against two over 2, summed)."""
    spec, _, _ = step_inputs
    spawn("step", tmp_path, dict(spec, tag="gen_ranks", rounds=1, generator=True), 2)
    spawn("step", tmp_path, dict(spec, tag="gen_one", rounds=1, generator=True), None)
    ranks = _step_results(tmp_path, "gen_ranks", 2)
    (one,) = _step_results(tmp_path, "gen_one", 1)
    for res in ranks:
        close(res["loss"], one["loss"])
        for k in one:
            if k.startswith("grad/"):
                close(res[k], one[k])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_rank_that_skips_the_all_reduce_is_caught(step_inputs, tmp_path):
    """Rank 1 keeping its own gradient sum (it still joins the collective,
    so rank 0 is unaffected) breaks the rank agreement and lands outside
    JAX's gradients at 2e-4."""
    spec, _, want_grads = step_inputs
    spawn("step", tmp_path, dict(spec, tag="fault", rounds=1, fault=True), 2)
    good, bad = _step_results(tmp_path, "fault", 2)
    for name, g in want_grads.items():
        close(good[f"grad/{name}"], g)
    assert any(not np.array_equal(good[k], bad[k]) for k in good if k.startswith("param/"))
    errs = [np.abs(bad[f"grad/{k}"] - np.asarray(g)).max() / np.abs(np.asarray(g)).max()
            for k, g in want_grads.items()]
    assert max(errs) > 1e-2


# ---------------------------------------------------------------------------
# the loop


@pytest.mark.parametrize("device_data", ["auto", False])
def test_two_rank_training_agrees_writes_once_and_resumes(tiny_h5, tmp_path, device_data):
    """4 steps of batch 256 on 2 ranks (128 rows a rank in 2 rounds) to
    1024 ndata with a checkpoint and snapshot, resumed on 2 ranks to 2048,
    against an uninterrupted 2-rank run to 2048, on the device-resident and
    the streaming path."""
    path, _ = tiny_h5
    runs = {"first": (tmp_path / "resumed", 1024), "resumed": (tmp_path / "resumed", 2048),
            "full": (tmp_path / "full", 2048)}
    for tag, (run_dir, total) in runs.items():
        kwargs = _loop_kwargs(path, total=total, snapshot=1024, device_data=device_data)
        spawn("loop", tmp_path, {"tag": tag, "run_dir": str(run_dir), "kwargs": kwargs}, 2)
    res = {tag: [dict(np.load(tmp_path / f"loop-{tag}-{r}.npz")) for r in range(2)] for tag in runs}
    meta = {tag: [json.loads((tmp_path / f"loop-{tag}-{r}.json").read_text()) for r in range(2)]
            for tag in runs}
    for tag in runs:
        a, b = res[tag]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag}: the ranks differ at {k}")
        assert meta[tag][1]["saves"] == []  # rank 1 wrote nothing
        assert {kind for kind, _, rank in meta[tag][0]["saves"]} == {"checkpoint", "snapshot"}
    assert [m["step"] for m in meta["resumed"]] == [m["step"] for m in meta["full"]] == [8, 8]
    assert meta["resumed"][0]["saves"] == [["snapshot", 2, 0], ["checkpoint", "training-state-0000002.ckpt", 0]]
    for k in res["full"][0]:
        np.testing.assert_array_equal(res["resumed"][0][k], res["full"][0][k], err_msg=k)
    assert sorted(p.name for p in (tmp_path / "full").glob("training-state-*")) == [
        "training-state-0000001.ckpt", "training-state-0000002.ckpt"]


# ---------------------------------------------------------------------------
# striped predict

L, HW, C, WINDOW = 13, 32, 4, 5
VARS = ["psl", "tas", "uas", "vas"]
CONFIGS = REPO / "exp" / "configs" / "000_on-model-eval"


@pytest.fixture(scope="module")
def predict_inputs(tmp_path_factory):
    """A tiny snapshot and a 16-hour 32 x 32 grid, its quantiles and its
    training file, written by the JAX package's writers."""
    from climate2weather_tpu.data.grid import GridDataset
    from climate2weather_tpu.data.processing import compute_quantiles, merged_to_normed_h5

    tmp = tmp_path_factory.mktemp("striped")
    cfg_net = tiny_config(channels=C * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg_net, hw=HW)
    snap = write_snapshot(tmp, cfg_net, params)
    rng = np.random.RandomState(0)
    time_axis = np.datetime64("2014-04-07T04", "ns") + np.arange(L + 3) * np.timedelta64(1, "h")
    coords = {"time": time_axis, "rlat": np.linspace(-2, 2, HW), "rlon": np.linspace(0, 4, HW)}
    walk = np.cumsum(rng.randn(L + 3, HW, HW, C), axis=0) / 3
    offsets = {"psl": 101000.0, "tas": 285.0, "uas": 0.0, "vas": 0.0}
    ds = GridDataset({v: (walk[..., i] * 4 + offsets[v]).astype(np.float32) for i, v in enumerate(VARS)},
                     coords, {})
    paths = {k: str(tmp / f) for k, f in (("data", "merged.nc"), ("quantiles", "q.nc"),
                                         ("train", "train_normed.h5"))}
    ds.to_file(paths["data"])
    compute_quantiles(ds).to_file(paths["quantiles"])
    merged_to_normed_h5(paths["data"], paths["quantiles"], paths["train"])
    return snap, paths


def _predict_config(tmp, snap, paths, name, **overrides):
    cfg = yaml.safe_load((CONFIGS / "s16_t6_spectral.yml").read_text())
    cfg.update(model_path=snap, data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], spectral_calibrate=paths["train"], num_hours=L,
               batch_size=4, likelihood_gamma=1e-2, **overrides)
    path = tmp / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def _draws(cfg):
    """JAX ``_run_impl``'s initial noise and per-step draws, per sample id."""
    from climate2weather_tpu.utils.seeding import derive_seed

    steps, noises, zs = int(cfg["num_sampling_steps"]), [], []
    for sid in range(int(cfg["num_samples"])):
        nk, sk = jax.random.split(jax.random.PRNGKey(derive_seed(int(cfg["seed"]), "sample", sid)))
        noises.append(np.asarray(jax.random.normal(nk, (L, HW, HW, C), jnp.float32)))
        zs.append(jax_split_normals(sk, steps, (L, HW, HW, C)))
    return np.stack(noises), np.stack(zs)


def _normed_samples(out_dir, cfg, quantiles):
    from climate2weather_tpu.data.grid import open_grid
    from climate2weather_tpu.data.pipeline import ds_to_sorted_np, normalize_ds

    files = sorted(pathlib.Path(out_dir).glob("gen_sample_*.nc"))
    assert [f.name for f in files] == [f"gen_sample_{i:03d}.nc" for i in range(int(cfg["num_samples"]))]
    return np.stack([ds_to_sorted_np(normalize_ds(open_grid(str(f)), quantiles, cfg["data_norm_mode"]), VARS)
                     for f in files])


def test_striped_run_equals_one_process_and_jax(predict_inputs, tmp_path, monkeypatch):
    """4 samples (DPM-Solver++(2M), SDE, 16 steps, in groups of 2) on 2
    ranks, each rank one group of its block, against the one-process run
    (bit for bit, file by file) and JAX's ``run`` (2e-4 of the largest
    magnitude, as tests/test_torch_predict.py)."""
    from climate2weather_tpu.exp import downscaling as jax_downscaling
    from climate2weather_tpu.models.score_net import build_score_unet

    snap, paths = predict_inputs
    config_path, cfg = _predict_config(tmp_path, snap, paths, "striped", num_samples=4, ensemble_batch=2,
                                       num_sampling_steps=16)
    noise, z = _draws(cfg)
    np.savez(tmp_path / "draws.npz", noise=noise, z=z)
    for tag, world in (("ranks", 2), ("one", None)):
        spawn("predict", tmp_path, {"tag": tag, "save_path": str(tmp_path / tag),
                                    "config_path": str(config_path)}, world)
    got_dir, one_dir = tmp_path / "ranks" / "001_striped", tmp_path / "one" / "001_striped"
    names = sorted(p.name for p in one_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        assert (got_dir / name).read_bytes() == (one_dir / name).read_bytes(), name
    writes = [json.loads((tmp_path / f"predict-ranks-{r}.json").read_text()) for r in range(2)]
    assert writes == [["ground_truth.nc", "observation.nc", "gen_sample_000.nc", "gen_sample_001.nc"],
                      ["gen_sample_002.nc", "gen_sample_003.nc"]]

    monkeypatch.setattr(jax_downscaling, "build_score_unet", lambda kw, dtype=None: build_score_unet(
        kw, dtype=jnp.float32, use_pallas_attention=False))
    want_dir = jax_downscaling.run(str(tmp_path / "jax"), str(config_path))
    got = _normed_samples(got_dir, cfg, paths["quantiles"])
    want = _normed_samples(want_dir, cfg, paths["quantiles"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))


def test_striped_long_path_equals_one_process(predict_inputs, tmp_path):
    """The year path above a threshold lowered to 8 frames (one sample at a
    time, resume files every call) striped over 2 ranks, against one
    process, bit for bit."""
    snap, paths = predict_inputs
    config_path, cfg = _predict_config(tmp_path, snap, paths, "long", num_samples=2, ensemble_batch=2,
                                       num_sampling_steps=8, long_trajectory_threshold=8,
                                       sample_resume_every=1)
    noise, z = _draws(cfg)
    np.savez(tmp_path / "draws.npz", noise=noise, z=z)
    for tag, world in (("ranks", 2), ("one", None)):
        spawn("predict", tmp_path, {"tag": tag, "save_path": str(tmp_path / tag),
                                    "config_path": str(config_path)}, world)
    got_dir, one_dir = tmp_path / "ranks" / "001_long", tmp_path / "one" / "001_long"
    names = sorted(p.name for p in one_dir.iterdir())
    assert "gen_sample_001.nc" in names and not [n for n in names if n.startswith(".sample_resume")]
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        assert (got_dir / name).read_bytes() == (one_dir / name).read_bytes(), name


def test_num_samples_not_a_multiple_of_the_world_is_refused_before_output(predict_inputs, tmp_path,
                                                                            monkeypatch):
    """The host-streaming tier splits no sample over ranks (JAX's shards
    nothing), so there ``num_samples`` not a multiple of the world is still
    refused before any output; elsewhere such a run splits each sample's
    windows (tests/test_torch_window_split.py)."""
    from climate2weather_tpu_torch.exp import downscaling

    snap, paths = predict_inputs
    config_path, cfg = _predict_config(tmp_path, snap, paths, "odd", num_samples=3, num_sampling_steps=2)
    cfg.update(host_streaming=True, spectral_calibrate=None, t0_project="")
    config_path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="not a multiple of the 2 ranks: the host-streaming tier"):
        downscaling.run(str(tmp_path / "out"), str(config_path), device="cpu")
    assert not (tmp_path / "out").exists()
    with pytest.raises(ValueError, match="not a multiple of the 2 ranks: the host-streaming tier"):
        next(downscaling.iter_samples(None, {}, cfg, np.zeros((L, HW, HW, C), np.float32), device="cpu",
                                      groups=mesh.SampleGroups(count=1, size=2)))


# ---------------------------------------------------------------------------
# the mesh's refusals


def _launch_env(monkeypatch, **env):
    for k in mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def test_without_a_launch_environment_nothing_starts(monkeypatch):
    _launch_env(monkeypatch)
    assert mesh.maybe_init_distributed("cpu") == torch.device("cpu")
    assert not mesh.distributed() and mesh.rank() == 0 and mesh.world_size() == 1
    assert mesh.broadcast_int(7, "cpu") == 7
    mesh.barrier("cpu")


def test_partial_launch_environment_raises(monkeypatch):
    _launch_env(monkeypatch, RANK=0, WORLD_SIZE=2)
    with pytest.raises(RuntimeError, match="launch with torchrun"):
        mesh.maybe_init_distributed("cpu")


def _cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("local_rank,count", [(1, 1), (0, 0), (3, 2)])
def test_local_rank_without_a_card_raises(monkeypatch, local_rank, count):
    """``cuda:LOCAL_RANK`` must exist: never folded onto another card."""
    _launch_env(monkeypatch, RANK=local_rank, WORLD_SIZE=4, LOCAL_RANK=local_rank, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=1)
    _cards(monkeypatch, count)
    with pytest.raises(RuntimeError, match=f"LOCAL_RANK={local_rank}"):
        mesh.rank_device("cuda")


def test_rank_device_is_the_local_rank_card(monkeypatch):
    _launch_env(monkeypatch, RANK=5, WORLD_SIZE=8, LOCAL_RANK=1, MASTER_ADDR="127.0.0.1", MASTER_PORT=1)
    _cards(monkeypatch, 2)
    assert mesh.rank_device("cuda") == mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="LOCAL_RANK=1"):
        mesh.rank_device("cuda:0")


def test_backend_that_fails_to_start_raises_without_fallback(monkeypatch):
    """A failed NCCL start surfaces, and no gloo group takes its place: on a
    CPU build of torch NCCL is missing; where it is built in, its start is
    made to fail."""
    import torch.distributed as dist

    _launch_env(monkeypatch, RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=_free_port())
    if dist.is_nccl_available():
        def failing(backend, *args, **kwargs):
            raise RuntimeError(f"NCCL error: {backend} could not start")

        monkeypatch.setattr(dist, "init_process_group", failing)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh.maybe_init_distributed("cpu", "nccl")
    assert not mesh.distributed()


@pytest.mark.parametrize("argv", [["metrics", "load", "EXP"], ["hparam-sweep", "--save-path", "OUT",
                                                               "--config-path", "CFG.yml"]])
def test_single_process_commands_refuse_a_world_above_one(monkeypatch, argv):
    from climate2weather_tpu_torch import experiment

    _launch_env(monkeypatch, RANK=1, WORLD_SIZE=2, LOCAL_RANK=1, MASTER_ADDR="127.0.0.1", MASTER_PORT=1)
    with pytest.raises(SystemExit, match="runs in one process"):
        experiment.main(argv)
