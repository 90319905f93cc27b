"""The port's checkpoint and snapshot formats against the JAX package's:
its msgpack and YAML writers read back by flax and PyYAML, checkpoints that
resume across the two packages both ways, and snapshots that JAX loads."""

import copy
import os
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from _torch_parity import close, jax_net_and_params, t, tiny_config, torch_net
from climate2weather_tpu.training import checkpoint as jckpt
from climate2weather_tpu.training import ema as jema
from climate2weather_tpu.training import lr as jlr
from climate2weather_tpu.training import state as jstate
from climate2weather_tpu_torch.convert import to_flax_params, to_state_dict
from climate2weather_tpu_torch.io import snapshot as io
from climate2weather_tpu_torch.training import checkpoint as pckpt
from climate2weather_tpu_torch.training import lr as plr
from climate2weather_tpu_torch.training import state as pstate

REPO = pathlib.Path(__file__).resolve().parents[1]
LR_KWARGS = {"func_name": "lr/linear", "ref_lr": 1e-2, "total_ndata": 64}
OPT_KWARGS = {"class_name": "adamw", "lr": 1e-2, "weight_decay": 1e-3, "betas": [0.9, 0.999]}
RATES = (0.999, 0.9)


def _np(tree):
    """Host copy that keeps dict order (``jax.tree.map`` sorts keys)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _grads(net, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*p.shape).astype(np.float32) for k, p in net.named_parameters()}


def _port_state(cfg, params):
    net = torch_net(cfg, params).train()
    return pstate.init_train_state(net, pstate.make_optimizer(net.parameters(), OPT_KWARGS), RATES)


def _port_update(st, grads):
    for k, p in st.net.named_parameters():
        p.grad = t(grads[k])
    pstate.apply_update(st, plr.make_schedule(LR_KWARGS, 8), RATES)


def _jax_template(params):
    opt = jstate.make_optimizer(jlr.make_schedule(LR_KWARGS, 8), OPT_KWARGS)
    return opt, jstate.init_train_state(jax.tree.map(jnp.asarray, params), opt, RATES)


def _jax_update(opt, st, grads_sd):
    grads = jax.tree.map(jnp.asarray, to_flax_params({k: t(v) for k, v in grads_sd.items()}))
    updates, opt_state = opt.update(grads, st.opt_state, st.params)
    params = optax.apply_updates(st.params, updates)
    return st.replace(step=st.step + 1, params=params, opt_state=opt_state,
                      emas=jema.ema_update(st.emas, params, RATES))


def _assert_states_equal(port_st, jax_st, rtol=0.0, atol=0.0):
    """Every leaf of the port's state in the JAX layout against the JAX state."""
    got = pckpt.state_to_flax(port_st)
    want = jax.tree.map(np.asarray, serialization.to_state_dict(jax_st))
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert {p for p, _ in got_leaves} == set(want_leaves)
    for path, leaf in got_leaves:
        assert leaf.dtype == want_leaves[path].dtype, path
        np.testing.assert_allclose(leaf, want_leaves[path], rtol=rtol, atol=atol, err_msg=str(path))


def test_msgpack_dumps_writes_flax_bytes():
    """For the state dict of a JAX TrainState, ``msgpack_dumps`` writes the
    bytes flax's ``to_bytes`` writes; flax and the port read them back."""
    _, params = jax_net_and_params(tiny_config(channels=10, window=5))
    _, st = _jax_template(params)
    sd = _np(serialization.to_state_dict(st))
    blob = io.msgpack_dumps(sd)
    assert blob == serialization.to_bytes(st)
    for back in (serialization.msgpack_restore(blob), io.msgpack_loads(blob)):
        assert back["opt_state"]["1"] == {}
        assert back["step"].dtype == np.int32 and back["step"].shape == ()
        for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                  jax.tree_util.tree_flatten_with_path(sd)[0]):
            np.testing.assert_array_equal(a, b, err_msg=str(p))
    scalars = {"i": [0, 127, 128, -32, -33, 300, -200, 70000, -70000, 1 << 40], "f": 1.5,
               "s": "x" * 40, "n": None, "b": [True, False], "e": {}, "z": np.float32(2.5),
               "h": np.arange(17, dtype=np.float16), "l": np.zeros(20000, np.float32)}
    blob = io.msgpack_dumps(scalars)
    assert blob == serialization.msgpack_serialize(copy.deepcopy(scalars), in_place=True)
    assert io.msgpack_loads(blob)["i"] == scalars["i"]


@pytest.mark.parametrize("tree", [
    # scalars whose extension payload takes each fixext size and none, a
    # strided view, an empty array, booleans, and arrays past the 64 KiB at
    # which the parts hold the array's own memory
    {"f4": np.float32(2.5), "f2": np.float16(1.0), "f8": np.float64(3.0), "i1": np.int8(-3),
     "u8": np.uint64(7), "b": np.bool_(True)},
    {"view": np.arange(48, dtype=np.float32).reshape(6, 8)[::2, 1::3], "empty": np.zeros((0, 5), np.float32),
     "mask": np.arange(10) % 3 == 0, "big": np.arange(70000, dtype=np.float32).reshape(350, 200),
     "bigT": np.arange(40000, dtype=np.float16).reshape(200, 200).T, "n": [1, "x", None]},
])
def test_msgpack_dump_parts_join_to_flax_bytes(tree):
    """``msgpack_dump_parts``, which checkpoints and snapshots are written
    from, joins to the bytes of ``msgpack_dumps`` and of flax's serializer."""
    parts = io.msgpack_dump_parts(tree)
    joined = b"".join(bytes(p) for p in parts)
    assert joined == io.msgpack_dumps(tree) == serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    if "big" in tree:
        assert any(isinstance(p, memoryview) and len(p) == tree["big"].nbytes for p in parts)


YAML_FILES = sorted(str(p.relative_to(REPO)) for pattern in ("configs/*.yml", "exp/configs/**/*.yml")
                    for p in REPO.glob(pattern))


@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_dump_reads_back_in_pyyaml_and_the_port(rel):
    data = yaml.safe_load((REPO / rel).read_text())
    text = io.yaml_dump(data)
    assert yaml.safe_load(text) == data
    assert io.yaml_loads(text) == data


def test_yaml_dump_quotes_what_would_read_back_otherwise():
    data = {"a": 1e-3, "b": "1e-3", "c": "yes", "d": "null", "e": "2014-01-01", "f": "a: b",
            "g": "0.999900", "h": "", "i": [], "j": {}, "k": [[1, 2]], "l": float("inf"),
            "m": "it's", "n": "lr/linear", "o": None, "p": -3, "q": {"r": [0.9, 0.999]}}
    text = io.yaml_dump(data)
    assert yaml.safe_load(text) == data == io.yaml_loads(text)
    with pytest.raises(ValueError):
        io.yaml_dump({"a": [{"b": 1}]})


def test_to_flax_params_inverts_to_state_dict_exactly():
    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    back = to_flax_params(to_state_dict(params))
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    sd = torch_net(cfg, params).state_dict()
    assert all(torch.equal(a, sd[k]) for k, a in to_state_dict(to_flax_params(sd)).items())


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """A port checkpoint after 2 updates is restored by the JAX
    ``CheckpointIO`` into a JAX TrainState template: every leaf equal. Then
    both take a third update on the same gradients: equal at rtol/atol 1e-6
    (the two frameworks round the AdamW arithmetic in another order)."""
    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    st = _port_state(cfg, params)
    for seed in (1, 2):
        _port_update(st, _grads(st.net, seed))
    path = str(tmp_path / "training-state-0000000.ckpt")
    pckpt.CheckpointIO(state=st, meta={"batch_size": 8}).save(path, verbose=False)

    opt, template = _jax_template(params)
    io_ = jckpt.CheckpointIO(state=template, meta={"batch_size": 0})
    io_.load(path, verbose=False)
    restored = io_.state_objs["state"]
    assert int(io_.state_objs["meta"]["batch_size"]) == 8 and int(restored.step) == 2
    _assert_states_equal(st, restored)
    g = _grads(st.net, 3)
    _port_update(st, g)
    _assert_states_equal(st, _jax_update(opt, restored, g), rtol=1e-6, atol=1e-6)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The reverse: a JAX checkpoint after 2 updates, restored by the port's
    ``CheckpointIO``, equals the JAX state leaf for leaf, and a third update
    agrees at rtol/atol 1e-6."""
    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    opt, jst = _jax_template(params)
    net = torch_net(cfg, params)
    for seed in (1, 2):
        jst = _jax_update(opt, jst, _grads(net, seed))
    path = str(tmp_path / "training-state-0000000.ckpt")
    jckpt.CheckpointIO(state=jst, meta={"batch_size": 8}).save(path, verbose=False)

    st = _port_state(cfg, jax_net_and_params(cfg, seed=9)[1])  # other weights, overwritten
    io_ = pckpt.CheckpointIO(state=st, meta={"batch_size": 0})
    assert io_.load_latest(str(tmp_path), verbose=False) == path
    assert int(io_.state_objs["meta"]["batch_size"]) == 8 and st.step == 2
    _assert_states_equal(st, jst)
    g = _grads(net, 3)
    _port_update(st, g)
    _assert_states_equal(st, _jax_update(opt, jst, g), rtol=1e-6, atol=1e-6)


def test_port_snapshot_loads_in_jax_with_the_same_forward(tmp_path):
    """An fp16 EMA snapshot written by the port: JAX ``load_snapshot`` reads
    the same values and config, and the JAX net's forward on them equals
    the port's on its own reading (rtol/atol 2e-4)."""
    from climate2weather_tpu.models.score_net import build_score_unet as jax_build
    from climate2weather_tpu_torch.exp.downscaling import load_net

    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    st = _port_state(cfg, params)
    _port_update(st, _grads(st.net, 1))
    snap = pckpt.save_snapshot(str(tmp_path), 1, "0.999000", st.emas["0.999000"], cfg,
                               half_precision=True)
    jparams, jcfg = jckpt.load_snapshot(snap)
    assert jcfg == cfg
    for k, v in to_state_dict(jax.tree.map(np.asarray, jparams)).items():
        assert torch.equal(v, st.emas["0.999000"][k].half().float()), k
    x = np.random.RandomState(0).randn(2, 16, 16, 10).astype(np.float32)
    tt = np.array([0.3, 0.8], np.float32)
    jnet = jax_build(cfg["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    want = jnet.apply(jparams, jnp.asarray(x), jnp.asarray(tt))
    net, snap_cfg = load_net(snap, "cpu", compute_dtype=torch.float32)
    assert snap_cfg == cfg
    with torch.no_grad():
        close(net(t(x), t(tt)), want)


def test_load_latest_and_prune(tmp_path):
    cfg = tiny_config(channels=10, window=5)
    st = _port_state(cfg, jax_net_and_params(cfg)[1])
    for kdata in (3, 12, 7):
        st.step = kdata
        pckpt.CheckpointIO(state=st).save(str(tmp_path / f"training-state-{kdata:07d}.ckpt"),
                                          verbose=False)
    st.step = 0
    io_ = pckpt.CheckpointIO(state=st)
    assert io_.load_latest(str(tmp_path), verbose=False).endswith("0000012.ckpt")
    assert st.step == 12
    assert pckpt.CheckpointIO(state=st).load_latest(str(tmp_path / "absent")) is None
    pckpt.prune_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["training-state-0000007.ckpt",
                                            "training-state-0000012.ckpt"]


def test_async_writer_one_in_flight_and_error_surfacing():
    w = pckpt.AsyncWriter()
    running, peak, lock = [0], [0], threading.Lock()

    def job():
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.05)
        with lock:
            running[0] -= 1

    for _ in range(3):
        w.submit(job)
    w.flush()
    assert peak[0] == 1

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.flush()
    w.close()
