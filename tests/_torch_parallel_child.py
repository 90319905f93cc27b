"""One rank of a tests/test_torch_parallel.py run, a process of its own:

    python _torch_parallel_child.py MODE WORKDIR

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set by the test, as torchrun sets them. The process group is
started by ``parallel.mesh`` (gloo, on the CPU); the mode reads its inputs
from ``WORKDIR/MODE.json`` (and files the test wrote there) and writes
``WORKDIR/MODE-TAG-RANK.npz`` or ``.json`` (``TAG`` from the spec):

- ``step``: one train step of the tiny net on the rank's rows of a global
  batch in ``rounds`` rounds, with the global draws injected (``fault``:
  rank 1 keeps its own gradients instead of the all-reduced sum, still
  joining the collective; ``generator``: the step draws from its own
  generator). Without ``RANK`` in the environment it runs single-process,
  with no process group;
- ``loop``: ``training_loop`` on an HDF5 file, recording which rank wrote
  checkpoints and snapshots, and the final parameters and EMAs;
- ``sampler``: ``training_loop`` with the train step replaced by one that
  records the window indices of each step;
- ``predict``: ``exp.downscaling.run`` with the JAX draws injected,
  recording the grid files this rank wrote (``fault``: as for ``window``;
  the run must then raise, and the error goes to ``.error``);
- ``window``: the tiny net's ``WindowScoreFn`` forward and VJP on each of
  the spec's cases, its windows split over the rank's sample group
  (``fault``: rank 1 sums a copy of its output and keeps its own share,
  still joining the collective);
- ``long``: ``sample_dpmpp2m_long`` (SDE, detached or exact guidance) with
  its windows split over the group, optionally with a resume file and a
  crash at a given score evaluation on every rank, recording which ranks
  read and wrote the file.
"""

import json
import os
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from climate2weather_tpu_torch.parallel import mesh  # noqa: E402


def _named(tensors):
    return {k: v.detach().cpu().numpy() for k, v in tensors}


def step(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.training import state as pstate

    net = build_score_unet(spec["network_kwargs"], dtype=torch.float32)
    net.load_state_dict(torch.load(work / "net.pt"))
    inputs = np.load(work / "inputs.npz")
    # round k of the global batch is rows [k W m, (k + 1) W m), the ranks'
    # m rows each in rank order; the draws are the round's global ones
    world, rounds = mesh.world_size(), spec["rounds"]
    gm = len(inputs["x"]) // rounds
    m = gm // world
    x = torch.from_numpy(inputs["x"]).reshape(rounds, world, m, *inputs["x"].shape[1:])[:, rank]
    draws = [(torch.from_numpy(inputs["t"][k * gm:(k + 1) * gm]),
              torch.from_numpy(inputs["eps"][k * gm:(k + 1) * gm])) for k in range(rounds)]
    generator = None
    if spec.get("generator"):  # the step's own draws instead
        draws, generator = None, pstate.step_generator(0, 0, "cpu")
    if spec.get("fault") and rank == 1:
        def keep_own(params, extra):  # joins the collective, keeps its own sum
            grads = [p.grad for p in params]
            bucket = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(1)])
            torch.distributed.all_reduce(bucket)
            return bucket[-1]

        mesh.all_reduce_grads = keep_own
    st = pstate.init_train_state(net, pstate.make_optimizer(net.parameters(), spec["optimizer_kwargs"]),
                                 (0.999,))
    train_step = pstate.make_train_step(VPCosineProcess(), lambda s: spec["lr"], (0.999,))
    _, loss = train_step(st, x, generator=generator, draws=draws)
    np.savez(work / f"step-{spec['tag']}-{rank}.npz", loss=float(loss),
             **{f"grad/{k}": v for k, v in _named((n, p.grad) for n, p in net.named_parameters()).items()},
             **{f"param/{k}": v for k, v in _named(net.named_parameters()).items()})


def _recording_saves(loop, rank: int, saves: list) -> None:
    """Record each checkpoint and snapshot write of this rank."""
    real_io, real_snapshot = loop.CheckpointIO, loop.save_snapshot

    class RecordingIO(real_io):
        def save(self, path, verbose=True):
            saves.append(("checkpoint", os.path.basename(path), rank))
            return super().save(path, verbose)

    def recording_snapshot(run_dir, kdata, *args, **kwargs):
        saves.append(("snapshot", kdata, rank))
        return real_snapshot(run_dir, kdata, *args, **kwargs)

    loop.CheckpointIO, loop.save_snapshot = RecordingIO, recording_snapshot


def run_loop(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.training import loop

    saves = []
    _recording_saves(loop, rank, saves)
    kwargs = dict(spec["kwargs"], compute_dtype=torch.float32)
    state = loop.training_loop(spec["run_dir"], **kwargs)
    tag = spec["tag"]
    (work / f"loop-{tag}-{rank}.json").write_text(json.dumps({"saves": saves, "step": state.step}))
    np.savez(work / f"loop-{tag}-{rank}.npz", **_named(state.net.named_parameters()),
             **{f"ema/{k}": v.numpy() for k, v in state.emas["0.999900"].items()})


def sampler(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.training import loop

    seen = []

    def recording_step(*args, **kwargs):
        def train_step(state, data, idx, generator=None, draws=None):
            seen.append(idx.tolist())
            state.step += 1
            return state, torch.zeros(())

        return train_step

    loop.make_device_data_train_step = recording_step
    loop.training_loop(spec["run_dir"], **dict(spec["kwargs"], compute_dtype=torch.float32))
    (work / f"sampler-{spec['tag']}-{rank}.json").write_text(json.dumps(seen))


def _keep_own_share(rank: int) -> None:
    """Rank 1's group sums a copy of each tensor and leaves its own as it
    was: it joins every collective, so its peers see nothing wrong."""
    if rank != 1:
        return
    real = mesh.SampleGroups.all_reduce

    def keep_own(self, tensor):
        real(self, tensor.clone())

    mesh.SampleGroups.all_reduce = keep_own


def predict(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.exp import downscaling

    writes, real_to_file = [], GridDataset.to_file

    def recording_to_file(self, path, *args, **kwargs):
        writes.append(os.path.basename(str(path)))
        return real_to_file(self, path, *args, **kwargs)

    GridDataset.to_file = recording_to_file
    if spec.get("fault"):
        _keep_own_share(rank)
    draws = np.load(work / "draws.npz")
    try:
        downscaling.run(spec["save_path"], spec["config_path"], device="cpu", compute_dtype=torch.float32,
                        noise=draws["noise"], z=draws["z"])
    except RuntimeError as e:
        if not spec.get("fault"):
            raise
        (work / f"predict-{spec['tag']}-{rank}.error").write_text(str(e))
    (work / f"predict-{spec['tag']}-{rank}.json").write_text(json.dumps(writes))


def _tiny_net(work: pathlib.Path, spec: dict):
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    net = build_score_unet(spec["network_kwargs"], dtype=torch.float32)
    net.load_state_dict(torch.load(work / "net.pt"))
    return net.eval().requires_grad_(False)


def _group():
    """The sample group of one sample over every rank (none single-process)."""
    groups = mesh.sample_groups(1, "cpu")
    return groups if groups.size > 1 else None


def window(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

    net = _tiny_net(work, spec)
    if spec.get("fault"):
        _keep_own_share(rank)
    group = _group()
    inputs = np.load(work / "window_inputs.npz")
    out = {}
    for name, (order, chunk) in spec["cases"].items():
        score = WindowScoreFn(net, order, chunk_size=chunk, group=group)
        x, co = torch.from_numpy(inputs[f"{name}/x"]), torch.from_numpy(inputs[f"{name}/co"])
        with torch.no_grad():
            out[f"{name}/eps"] = score(x, spec["t"]).numpy()
        out[f"{name}/vjp"] = score.vjp(x, spec["t"], co).numpy()
    np.savez(work / f"window-{spec['tag']}-{rank}.npz", **out)


class Crash(Exception):
    """A run stopped in the middle, on every rank at once."""


def long(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.diffusion import long_sampler
    from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance, SpatioTemporalCoarsening
    from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

    net = _tiny_net(work, spec)
    if spec.get("fault"):
        _keep_own_share(rank)
    inputs = np.load(work / "long_inputs.npz")
    files = []
    real_save, real_load = long_sampler._save_carry, long_sampler._load_carry

    def recording_save(path, *args, **kwargs):
        files.append(("save", rank))
        return real_save(path, *args, **kwargs)

    def recording_load(path, *args, **kwargs):
        files.append(("load", rank))
        return real_load(path, *args, **kwargs)

    long_sampler._save_carry, long_sampler._load_carry = recording_save, recording_load
    crash_at, calls = spec.get("crash_at"), []

    class Scored(WindowScoreFn):
        def __call__(self, x, t):
            if len(calls) == crash_at:
                raise Crash
            calls.append(t)
            return super().__call__(x, t)

    score = Scored(net, spec["order"], chunk_size=spec["chunk"], group=_group())
    guidance = GaussianGuidance(A=SpatioTemporalCoarsening(4, 3), y=torch.from_numpy(inputs["y"]),
                                std=torch.from_numpy(inputs["std"]), gamma=float(inputs["gamma"]),
                                exact_grad=spec["exact"])
    gen = torch.Generator().manual_seed(3)
    out = {"files": files}
    try:
        x, nan = long_sampler.sample_dpmpp2m_long(
            VPCosineProcess(), score, torch.from_numpy(inputs["noise"]), guidance=guidance, steps=6,
            sde_eta=0.3, rng=gen, frame_chunk=5, steps_per_call=2, denoise_final=True,
            resume_path=spec.get("resume_path"), resume_every=1)
        out.update(nan=bool(nan), evaluations=len(calls))
        np.save(work / f"long-{spec['tag']}-{rank}.npy", x.numpy())
    except Crash:
        out["crashed"] = len(calls)
    except RuntimeError as e:
        if not spec.get("fault"):
            raise
        out["error"] = str(e)
    (work / f"long-{spec['tag']}-{rank}.json").write_text(json.dumps(out))


MODES = {"step": step, "loop": run_loop, "sampler": sampler, "predict": predict, "window": window,
         "long": long}

if __name__ == "__main__":
    mode, work = sys.argv[1], pathlib.Path(sys.argv[2])
    torch.set_num_threads(1)
    spec = json.loads((work / f"{mode}.json").read_text())
    mesh.maybe_init_distributed("cpu", "gloo")
    try:
        MODES[mode](work, mesh.rank(), spec)
    finally:
        mesh.shutdown()
