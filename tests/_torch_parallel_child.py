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
  recording the grid files this rank wrote.
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


def predict(work: pathlib.Path, rank: int, spec: dict) -> None:
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.exp import downscaling

    writes, real_to_file = [], GridDataset.to_file

    def recording_to_file(self, path, *args, **kwargs):
        writes.append(os.path.basename(str(path)))
        return real_to_file(self, path, *args, **kwargs)

    GridDataset.to_file = recording_to_file
    draws = np.load(work / "draws.npz")
    downscaling.run(spec["save_path"], spec["config_path"], device="cpu", compute_dtype=torch.float32,
                    noise=draws["noise"], z=draws["z"])
    (work / f"predict-{spec['tag']}-{rank}.json").write_text(json.dumps(writes))


MODES = {"step": step, "loop": run_loop, "sampler": sampler, "predict": predict}

if __name__ == "__main__":
    mode, work = sys.argv[1], pathlib.Path(sys.argv[2])
    torch.set_num_threads(1)
    spec = json.loads((work / f"{mode}.json").read_text())
    mesh.maybe_init_distributed("cpu", "gloo")
    try:
        MODES[mode](work, mesh.rank(), spec)
    finally:
        mesh.shutdown()
