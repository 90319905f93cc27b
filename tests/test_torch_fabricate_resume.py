"""The fabricated-resume path in the port (``climate2weather_tpu_torch.scripts.
fabricate_resume_state`` and the repaired checkpoint counts) against the JAX
package's script and trainer.

A fabricated state holds Adam's count 0 (fresh moments) beside a schedule
count at the snapshot's step. The port keeps Adam's count as AdamW's
per-parameter ``"step"``, apart from ``TrainState.step``: a checkpoint
fabricated by the JAX script resumes in the port, the port's next update
matches JAX's at 2e-4, the port's fabricated checkpoint is JAX's leaf for
leaf and loads in JAX's trainer, and fabricate -> resume -> checkpoint ->
resume equals an uninterrupted continuation bit for bit.
"""

import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from _torch_parity import close, jax_net_and_params, t, tiny_config, torch_net, write_snapshot
from climate2weather_tpu.training import checkpoint as jckpt
from climate2weather_tpu.training import ema as jema
from climate2weather_tpu.training import lr as jlr
from climate2weather_tpu.training import state as jstate
from climate2weather_tpu_torch.convert import to_flax_params
from climate2weather_tpu_torch.scripts import fabricate_resume_state as port_fab
from climate2weather_tpu_torch.training import checkpoint as pckpt
from climate2weather_tpu_torch.training import lr as plr
from climate2weather_tpu_torch.training import state as pstate

REPO = pathlib.Path(__file__).resolve().parents[1]
BATCH, NDATA, TOTAL, LR = 8, 40, 120, 1e-2  # step 5 of a schedule over 15 steps
LR_KWARGS = {"func_name": "lr/linear", "ref_lr": LR, "total_ndata": TOTAL}
OPT_KWARGS = {"class_name": "adamw", "lr": LR, "weight_decay": 1e-3, "betas": [0.9, 0.999]}
RATES = (0.9999, 0.999)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_fabricate_resume_state",
                                                  REPO / "scripts" / "fabricate_resume_state.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(snap, out_dir, ndata=NDATA, batch=BATCH, lr=LR, total=TOTAL, rates="0.9999,0.999"):
    return ["--snapshot", str(snap), "--out-dir", str(out_dir), "--ndata", str(ndata), "--batch", str(batch),
            "--lr", str(lr), "--total-ndata", str(total), "--ema-rates", rates]


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["fabricate_resume_state.py"] + argv)
    _jax_script().main()


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    snap = write_snapshot(tmp_path_factory.mktemp("snap"), cfg, params)
    return cfg, snap


def _port_state(cfg, snap):
    params, _ = pckpt.load_snapshot(snap)
    net = torch_net(cfg, params).train()
    return pstate.init_train_state(net, pstate.make_optimizer(net.parameters(), OPT_KWARGS), RATES)


def _port_load(cfg, snap, path):
    st = _port_state(cfg, snap)
    pckpt.CheckpointIO(state=st, meta={"batch_size": 0}).load(str(path), verbose=False)
    return st


def _grads(st, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*p.shape).astype(np.float32) for k, p in st.net.named_parameters()}


def _port_update(st, grads):
    for k, p in st.net.named_parameters():
        p.grad = t(grads[k])
    pstate.apply_update(st, plr.make_schedule(LR_KWARGS, BATCH), RATES)


def _jax_load(snap, path):
    params, _ = jckpt.load_snapshot(snap)
    opt = jstate.make_optimizer(jlr.make_schedule(LR_KWARGS, BATCH), OPT_KWARGS)
    template = jstate.init_train_state(params, opt, RATES)
    restored = jckpt.CheckpointIO(state=template, meta={"batch_size": 0}).load(str(path), verbose=False)
    return opt, restored["state"]


def _jax_update(opt, st, grads_sd):
    grads = jax.tree.map(jnp.asarray, to_flax_params({k: t(v) for k, v in grads_sd.items()}))
    updates, opt_state = opt.update(grads, st.opt_state, st.params)
    params = optax.apply_updates(st.params, updates)
    return st.replace(step=st.step + 1, params=params, opt_state=opt_state,
                      emas=jema.ema_update(st.emas, params, RATES))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees(got: dict, want: dict, exact=True):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        if exact:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        else:
            close(got[k], want[k])


def test_jax_fabricated_checkpoint_resumes_in_port_and_steps_as_jax(snapshot, tmp_path, monkeypatch):
    """The JAX script's checkpoint (Adam count 0, schedule count 5) loads in
    the port with no optimizer state, and the port's next update matches
    JAX's at 2e-4, counts included."""
    cfg, snap = snapshot
    _run_jax(monkeypatch, _argv(snap, tmp_path))
    path = tmp_path / "training-state-0000000.ckpt"
    st = _port_load(cfg, snap, path)  # raised "optimizer counts [0, 5] differ from step 5" before
    assert st.step == NDATA // BATCH and len(st.optimizer.state) == 0  # fresh moments
    opt, jst = _jax_load(snap, path)
    assert int(jst.opt_state[0].count) == 0 and int(jst.opt_state[-1].count) == 5
    grads = _grads(st, 0)
    _port_update(st, grads)
    jst = _jax_update(opt, jst, grads)
    assert pckpt.adam_count(st.optimizer) == 1 and st.step == 6
    _assert_trees(pckpt.state_to_flax(st), jax.tree.map(np.asarray, serialization.to_state_dict(jst)),
                  exact=False)


def test_port_fabricated_checkpoint_is_jaxs_and_loads_in_jax(snapshot, tmp_path, monkeypatch, capsys):
    """The port's script writes JAX's checkpoint leaf for leaf, prints the
    same lines, and JAX's trainer restores it."""
    cfg, snap = snapshot
    _run_jax(monkeypatch, _argv(snap, tmp_path / "jax"))
    jax_out = capsys.readouterr().out
    port_fab.main(_argv(snap, tmp_path / "port"))
    port_out = capsys.readouterr().out
    assert port_out.replace("/port/", "/jax/") == jax_out
    name = "training-state-0000000.ckpt"
    _, jst_port = _jax_load(snap, tmp_path / "port" / name)
    _, jst_jax = _jax_load(snap, tmp_path / "jax" / name)
    _assert_trees(serialization.to_state_dict(jst_port), serialization.to_state_dict(jst_jax))
    assert int(jst_port.step) == 5 and int(jst_port.opt_state[0].count) == 0
    assert int(jst_port.opt_state[-1].count) == 5


def test_fabricate_resume_checkpoint_resume_equals_uninterrupted(snapshot, tmp_path):
    """Fabricate, 2 updates, checkpoint (Adam count 2, schedule count 7),
    resume, 2 more: bit for bit the 4 updates of one uninterrupted state."""
    cfg, snap = snapshot
    port_fab.main(_argv(snap, tmp_path))
    fab = tmp_path / "training-state-0000000.ckpt"
    a = _port_load(cfg, snap, fab)
    grads = [_grads(a, s) for s in range(4)]
    for g in grads[:2]:
        _port_update(a, g)
    mid = tmp_path / "mid.ckpt"
    pckpt.CheckpointIO(state=a, meta={"batch_size": BATCH}).save(str(mid), verbose=False)
    tree = pckpt.state_to_flax(a)
    assert int(tree["opt_state"]["0"]["count"]) == 2 and int(tree["opt_state"]["2"]["count"]) == 7
    b = _port_load(cfg, snap, mid)
    assert pckpt.adam_count(b.optimizer) == 2 and b.step == 7
    for g in grads[2:]:
        _port_update(b, g)
    c = _port_load(cfg, snap, fab)
    for g in grads:
        _port_update(c, g)
    _assert_trees(pckpt.state_to_flax(b), pckpt.state_to_flax(c))


def test_counted_checkpoint_reads_and_writes_as_before(snapshot, tmp_path):
    """A checkpoint whose counts equal its step (every one a run writes)
    loads and is written again byte for byte."""
    cfg, snap = snapshot
    st = _port_state(cfg, snap)
    for s in range(3):
        _port_update(st, _grads(st, s))
    first, second = tmp_path / "a.ckpt", tmp_path / "b.ckpt"
    pckpt.CheckpointIO(state=st, meta={"batch_size": BATCH}).save(str(first), verbose=False)
    tree = pckpt.state_to_flax(st)
    assert int(tree["opt_state"]["0"]["count"]) == int(tree["opt_state"]["2"]["count"]) == int(tree["step"]) == 3
    again = _port_load(cfg, snap, first)
    pckpt.CheckpointIO(state=again, meta={"batch_size": BATCH}).save(str(second), verbose=False)
    assert first.read_bytes() == second.read_bytes()


def test_schedule_count_must_equal_step(snapshot):
    cfg, snap = snapshot
    st = _port_state(cfg, snap)
    tree = pckpt.state_to_flax(st)
    tree["step"] = np.asarray(4, np.int32)
    tree["opt_state"]["2"]["count"] = np.asarray(5, np.int32)
    with pytest.raises(ValueError, match="schedule's count 5 differs from step 4"):
        pckpt.load_flax_state(st, tree)


def test_schedule_count_set_without_touching_adam_count():
    params = {"w": np.ones((3,), np.float32)}
    st = port_fab.set_schedule_count(port_fab.fresh_opt_state(params), 36864)
    assert int(st["0"]["count"]) == 0 and int(st["2"]["count"]) == 36864
    assert st["1"] == {} and not st["0"]["mu"]["w"].any() and not st["0"]["nu"]["w"].any()
    with pytest.raises(ValueError, match="adamw"):
        port_fab.set_schedule_count({"0": {}}, 1)


def _loop_kwargs(path, lr_total):
    window = 3
    return dict(
        dataset_kwargs={"train": {"class_name": "cosmo_dataset", "data_path": path, "num_features": 2,
                                  "spatial_res": 16, "cached": True, "window": window, "flatten": True}},
        network_kwargs={"channels": 2 * window, "embedding_dim": 16, "hidden_channels": [8],
                        "hidden_blocks": [1], "attention_levels": []},
        pipeline_kwargs={"class_name": "vp_cosine"},
        optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-3},
        lr_kwargs={"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": lr_total},
        batch_size=1024, batch_gpu=None, log_ndata=None, status_ndata=None, snapshot_ndata=1024,
        checkpoint_ndata=None, valid_ndata=None, seed=0, device="cpu", compute_dtype=torch.float32,
        loader_threads=1,
    )


def test_fabricate_then_resume(tiny_h5, tmp_path, capsys):
    """tests/test_fabricate_resume.py's drive in the port: a run that leaves
    only a snapshot, a state fabricated from it at ndata 1024, and the port's
    loop resuming there: snapshots at kdata 2 and 3, none at 1, and the LR at
    the schedule's absolute position."""
    from climate2weather_tpu_torch.training.loop import training_loop

    path, _ = tiny_h5
    run1 = tmp_path / "run1"
    os.makedirs(run1)
    training_loop(str(run1), total_ndata=2048, **_loop_kwargs(path, 2048))
    snap = run1 / "network-snapshot-0000001-0.999900"
    assert snap.is_dir(), os.listdir(run1)

    run2 = tmp_path / "run2"
    capsys.readouterr()
    port_fab.main(["--snapshot", str(snap), "--out-dir", str(run2), "--ndata", "1024", "--batch", "1024",
                   "--lr", "1e-3", "--total-ndata", "3072", "--ema-rates", "0.9999"])
    out = capsys.readouterr().out
    assert (run2 / "training-state-0000001.ckpt").exists()
    # 1e-3 * (1 - 1024/3072) = 6.667e-4: the new schedule's absolute position
    assert "lr(step)=6.667e-04" in out, out

    state = training_loop(str(run2), total_ndata=3072, **_loop_kwargs(path, 3072))
    assert state.step == 3 and pckpt.adam_count(state.optimizer) == 2
    snaps = sorted(d for d in os.listdir(run2) if d.startswith("network-snapshot-"))
    assert not any("-0000001-" in s for s in snaps), snaps
    assert any("-0000002-" in s for s in snaps), snaps
    assert any("-0000003-" in s for s in snaps), snaps
