"""The port's training path against the JAX package: the train step's loss
and gradients, AdamW + LR + EMA, the data stream, flax-style init, the loop
with resume, and the CLI. Small nets in fp32 on the CPU; each test states
its tolerance (the default is rtol/atol 2e-4)."""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import close, jax_net_and_params, t, tiny_config, torch_net
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu.training import ema as jema
from climate2weather_tpu.training import lr as jlr
from climate2weather_tpu.training import state as jstate
from climate2weather_tpu_torch.convert import to_state_dict
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
from climate2weather_tpu_torch.training import ema, lr
from climate2weather_tpu_torch.training import state as pstate


def _jax_draws(key, rounds, b, shape):
    """The (t, eps) that JAX's train step draws for each microbatch:
    ``split(rng, rounds)``, then ``split`` into t and eps keys
    (state.py:98, process.py:59-61)."""
    out = []
    for r in jax.random.split(key, rounds):
        rt, re = jax.random.split(r)
        tt = jax.random.uniform(rt, (b, 1, 1, 1), dtype=jnp.float32)
        eps = jax.random.normal(re, shape, dtype=jnp.float32)
        out.append((np.asarray(tt), np.asarray(eps)))
    return out


def _grad_capture():
    """An optax transformation whose state after one update is the gradient
    it was given, so JAX's own train step hands its gradients out."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("rounds", [1, 2])
def test_train_step_loss_and_gradients_match_jax(rounds):
    """One train step on the tiny net, the (t, eps) JAX draws injected into
    the port: loss and every leaf's gradient at rtol/atol 2e-4."""
    cfg = tiny_config(channels=10, window=5)
    net, params = jax_net_and_params(cfg)
    b, shape = 2, (2, 16, 16, 10)
    rng = np.random.RandomState(rounds)
    batch = rng.randn(rounds, *shape).astype(np.float32)
    key = jax.random.PRNGKey(11)

    step = jax.jit(jstate.make_train_step(net.apply, JaxProcess(), _grad_capture(), (0.999,)))
    jstate_ = jstate.init_train_state(params, _grad_capture(), (0.999,))
    new_state, want_loss = step(jstate_, jnp.asarray(batch), key)
    want_grads = to_state_dict(jax.tree.map(np.asarray, new_state.opt_state))

    port = torch_net(cfg, params)
    opt = pstate.make_optimizer(port.parameters(), {"weight_decay": 0.0})
    st = pstate.init_train_state(port, opt, (0.999,))
    train_step = pstate.make_train_step(VPCosineProcess(), lambda s: 0.0, (0.999,))
    draws = [(t(a), t(e)) for a, e in _jax_draws(key, rounds, b, shape)]
    _, loss = train_step(st, t(batch), draws=draws)
    close(loss, want_loss)
    for name, p in port.named_parameters():
        close(p.grad, want_grads[name])
    assert st.step == 1


def test_device_data_step_gathers_the_jax_windows():
    """The device-resident step's window gather (frame-major NHWC channels)
    and loss against JAX's ``make_device_data_train_step`` with the same
    draws, rtol/atol 2e-4."""
    cfg = tiny_config(channels=10, window=5)
    net, params = jax_net_and_params(cfg)
    rng = np.random.RandomState(3)
    data = rng.randn(12, 2, 16, 16).astype(np.float32)
    idx = np.array([[0, 5], [7, 2]], np.int32)
    key = jax.random.PRNGKey(5)
    step = jax.jit(jstate.make_device_data_train_step(net.apply, JaxProcess(), _grad_capture(),
                                                      5, (0.999,)))
    _, want_loss = step(jstate.init_train_state(params, _grad_capture(), (0.999,)),
                        jnp.asarray(data), jnp.asarray(idx), key)

    windows = pstate.gather_windows(t(data), torch.from_numpy(idx[0]).long(), 5)
    for j, i in enumerate(idx[0]):
        for f in range(5):
            for c in range(2):
                np.testing.assert_array_equal(windows[j, :, :, f * 2 + c].numpy(), data[i + f, c])
    port = torch_net(cfg, params)
    st = pstate.init_train_state(port, pstate.make_optimizer(port.parameters(), {}), (0.999,))
    train_step = pstate.make_device_data_train_step(VPCosineProcess(), lambda s: 0.0, 5, (0.999,))
    draws = [(t(a), t(e)) for a, e in _jax_draws(key, 2, 2, (2, 16, 16, 10))]
    _, loss = train_step(st, t(data), torch.from_numpy(idx).long(), draws=draws)
    close(loss, want_loss)


def test_adamw_lr_ema_match_optax_over_three_updates():
    """The port's AdamW + LR schedule + EMA against ``optax.adamw`` +
    ``ema_update`` on identical gradients over 3 updates. The schedule
    (lr/linear over 4 steps of batch 1) changes by 25 % a step, so a wrong
    step count shows; weight decay is 0.1 so that ``lr wd p`` is ~1e-3, far
    above the 1e-6 tolerance; bias correction moves the first update by a
    factor of ~3."""
    rng = np.random.RandomState(0)
    w, b = rng.randn(4, 3).astype(np.float32), rng.randn(4).astype(np.float32)
    grads = [(rng.randn(4, 3).astype(np.float32), rng.randn(4).astype(np.float32))
             for _ in range(3)]
    lr_kwargs = {"func_name": "lr/linear", "ref_lr": 1e-2, "total_ndata": 4}
    opt_kwargs = {"class_name": "adamw", "lr": 1e-2, "weight_decay": 0.1, "betas": [0.9, 0.99],
                  "eps": 1e-6}

    jsched = jlr.make_schedule(lr_kwargs, 1)
    jopt = jstate.make_optimizer(jsched, opt_kwargs)
    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    jst = jstate.init_train_state(jparams, jopt, (0.9, 0.5))

    lin = torch.nn.Linear(3, 4)
    with torch.no_grad():
        lin.weight.copy_(t(w))
        lin.bias.copy_(t(b))
    st = pstate.init_train_state(lin, pstate.make_optimizer(lin.parameters(), opt_kwargs),
                                 (0.9, 0.5))
    sched = lr.make_schedule(lr_kwargs, 1)
    for gw, gb in grads:
        updates, opt_state = jopt.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                         jst.opt_state, jst.params)
        params = optax.apply_updates(jst.params, updates)
        jst = jst.replace(params=params, opt_state=opt_state,
                          emas=jema.ema_update(jst.emas, params, (0.9, 0.5)), step=jst.step + 1)
        lin.weight.grad, lin.bias.grad = t(gw), t(gb)
        pstate.apply_update(st, sched, (0.9, 0.5))
        close(lin.weight, jst.params["w"], rtol=1e-6, atol=1e-6)
        close(lin.bias, jst.params["b"], rtol=1e-6, atol=1e-6)
        for rk in ("0.900000", "0.500000"):
            close(st.emas[rk]["weight"], jst.emas[rk]["w"], rtol=1e-6, atol=1e-6)
            close(st.emas[rk]["bias"], jst.emas[rk]["b"], rtol=1e-6, atol=1e-6)
    assert st.step == int(jst.step) == 3


def test_lr_schedules_and_ema_algebra_match_jax():
    """Schedules at several ndata (rtol 1e-6) and the EMA lerp (exact
    algebra of the JAX test, rtol 1e-6)."""
    for step in (0, 3, 10, 99):
        close(lr.make_schedule({"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": 1000}, 10)(step),
              jlr.make_schedule({"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": 1000}, 10)(step),
              rtol=1e-6, atol=0)
        edm = {"func_name": "lr/edm2", "ref_lr": 1e-2, "ref_batches": 4, "rampup_Mdata": 1e-4,
               "batch_size": 32}
        close(lr.make_schedule(edm, 32)(step), jlr.make_schedule(edm, 32)(step), rtol=1e-6, atol=0)
    emas = ema.ema_init({"w": torch.ones(3) * 2.0}, rates=(0.9, 0.5))
    ema.ema_update(emas, {"w": torch.ones(3) * 4.0}, rates=(0.9, 0.5))
    close(emas[ema.rate_key(0.9)]["w"], np.full(3, 2.0 * 0.9 + 4.0 * 0.1), rtol=1e-6, atol=0)
    close(emas[ema.rate_key(0.5)]["w"], np.full(3, 3.0), rtol=1e-6, atol=0)


def test_ndata_registry_easydict_copies_match_jax():
    from climate2weather_tpu.utils import easydict as jez, ndata as jnd
    from climate2weather_tpu_torch.utils import easydict as pez, ndata as pnd, registry

    for s in ("7", "3Ki", "2Mi", "1Gi", 1536):
        assert pnd.parse_ndata(s) == jnd.parse_ndata(s)
    for v in (0, 1000, 1024, 3 << 20, 5 << 30):
        assert pnd.format_ndata(v) == jnd.format_ndata(v)
    nested = {"a": {"b": [1, {"c": 2}]}}
    assert pez.EasyDict.from_nested(nested).a.b[1].c == 2
    assert pez.EasyDict.from_nested(nested).to_plain() == jez.EasyDict.from_nested(nested).to_plain()
    assert registry.get_obj_by_name("lr/linear") is lr.linear_learning_rate_schedule
    assert registry.get_obj_by_name("climate2weather_tpu_torch.training.ema.rate_key") is ema.rate_key
    assert registry.construct_class_by_name(class_name="vp_cosine", eta=1e-2).eta == 1e-2


@pytest.mark.parametrize("rank,replicas,start", [(0, 1, 0), (0, 2, 0), (1, 2, 0), (0, 1, 7),
                                                 (1, 3, 13)])
def test_infinite_sampler_stream_equals_jax(rank, replicas, start):
    """Shards and resumes: the index stream is JAX's, element for element."""
    from climate2weather_tpu.data.dataset import InfiniteSampler as JaxSampler
    from climate2weather_tpu_torch.data.dataset import InfiniteSampler

    kw = dict(dataset_size=11, rank=rank, num_replicas=replicas, seed=5, start_idx=start)
    assert list(itertools.islice(iter(InfiniteSampler(**kw)), 40)) == \
        list(itertools.islice(iter(JaxSampler(**kw)), 40))


@pytest.mark.parametrize("channels_first", [True, False])
def test_window_dataset_and_loader_batches_equal_jax(tiny_h5, channels_first):
    """``WindowDataset`` items and ``PrefetchLoader`` batches (3 threads,
    resumed mid-stream) equal the JAX package's bit for bit."""
    from climate2weather_tpu.data import dataset as jds
    from climate2weather_tpu_torch.data import dataset as pds

    path, _ = tiny_h5
    kw = dict(num_features=2, spatial_res=16, window=5, cached=False)
    ds, jd = pds.WindowDataset(path, **kw), jds.WindowDataset(path, **kw)
    assert len(ds) == len(jd) == 16
    for i in (0, 7, 15):
        np.testing.assert_array_equal(ds[i], jd[i])

    def batches(mod, d, start):
        sampler = mod.InfiniteSampler(len(d), seed=3, start_idx=start)
        loader = mod.PrefetchLoader(d, sampler, batch_size=2, rounds=2, num_threads=3,
                                    channels_first=channels_first).start()
        out = list(itertools.islice(iter(loader), 5))
        loader.stop()
        return out

    for start in (0, 12):
        for a, b in zip(batches(pds, ds, start), batches(jds, jd, start)):
            np.testing.assert_array_equal(a, b)


def test_flax_style_init_statistics():
    """``init_params``: every conv and linear weight is a normal truncated at
    2 sigma with std sqrt(1 / fan_in) (flax's lecun_normal), biases zero.
    Against flax's own draws of the same net: per-leaf std within 5 % where
    the leaf has >= 4096 values, and no value beyond the truncation."""
    from climate2weather_tpu_torch.models.init import init_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    cfg = tiny_config(channels=52, window=13)["network_kwargs"]
    cfg = {**cfg, "hidden_channels": [32, 64], "embedding_dim": 64}
    _, flax_params = jax_net_and_params({"network_kwargs": cfg}, hw=16, seed=3)
    flax_sd = to_state_dict(flax_params)
    net = build_score_unet(cfg, dtype=torch.float32)
    init_params(net, torch.Generator().manual_seed(0))
    for name, p in net.named_parameters():
        p = p.detach()
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0, name
            continue
        fan_in = p[0].numel()
        limit = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(p.abs().max()) <= limit * (1 + 1e-6), name
        if p.numel() >= 4096:
            assert abs(float(p.std()) / np.sqrt(1.0 / fan_in) - 1) < 0.05, name
            assert abs(float(p.std()) / float(flax_sd[name].std()) - 1) < 0.05, name
    again = init_params(build_score_unet(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


def _loop_kwargs(path, window=3, batch=256, hidden=(8, 16), attention=(1,)):
    return dict(
        dataset_kwargs={"train": {"class_name": "cosmo_dataset", "data_path": path,
                                  "num_features": 2, "spatial_res": 16, "cached": True,
                                  "window": window, "flatten": True}},
        network_kwargs={"channels": 2 * window, "embedding_dim": 16,
                        "hidden_channels": list(hidden), "hidden_blocks": [1] * len(hidden),
                        "attention_levels": list(attention)},
        pipeline_kwargs={"class_name": "vp_cosine"},
        optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-3},
        lr_kwargs={"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": 2048},
        batch_size=batch, batch_gpu=batch // 2, log_ndata=None, status_ndata=None,
        snapshot_ndata=None, checkpoint_ndata=1024, valid_ndata=None, seed=0,
        device="cpu", compute_dtype=torch.float32, loader_threads=1,
    )


@pytest.mark.parametrize("device_data", ["auto", False])
def test_training_loop_resume_equals_uninterrupted(tiny_h5, tmp_path, device_data):
    """4 steps to 1024 ndata with a checkpoint, resumed to 2048, against an
    uninterrupted run to 2048 on the device-resident and streaming paths:
    the same draws, data and updates, so the final states are equal (exact:
    CPU kernels reduce in a fixed order)."""
    from climate2weather_tpu_torch.training.loop import training_loop

    path, _ = tiny_h5
    kw = _loop_kwargs(path)
    kw["device_data"] = device_data
    resumed_dir, full_dir = str(tmp_path / "resumed"), str(tmp_path / "full")
    os.makedirs(resumed_dir)
    os.makedirs(full_dir)
    first = training_loop(resumed_dir, total_ndata=1024, **kw)
    assert first.step == 4 and os.path.exists(os.path.join(resumed_dir, "training-state-0000001.ckpt"))
    resumed = training_loop(resumed_dir, total_ndata=2048, **kw)
    full = training_loop(full_dir, total_ndata=2048, **kw)
    assert resumed.step == full.step == 8
    for (name, a), b in zip(resumed.net.state_dict().items(), full.net.state_dict().values()):
        assert torch.equal(a, b), name
    for k, v in resumed.emas["0.999900"].items():
        assert torch.equal(v, full.emas["0.999900"][k]), k


def test_training_loop_rejects_another_batch_size_on_resume(tiny_h5, tmp_path):
    from climate2weather_tpu_torch.training.loop import training_loop

    path, _ = tiny_h5
    training_loop(str(tmp_path), total_ndata=1024, **_loop_kwargs(path))
    with pytest.raises(ValueError, match="--batch 256"):
        training_loop(str(tmp_path), total_ndata=2048, **{**_loop_kwargs(path, batch=512)})


def test_final_snapshot_written_at_nonaligned_stop(tiny_h5, tmp_path):
    """The case of tests/test_training.py:144 in the port: stopping at 3072,
    not a multiple of snapshot_ndata 2048, still writes the final snapshot."""
    from climate2weather_tpu_torch.training.loop import training_loop

    path, _ = tiny_h5
    kw = _loop_kwargs(path, batch=1024, hidden=(8,), attention=())
    kw.update(batch_gpu=None, snapshot_ndata=2048, checkpoint_ndata=None,
              lr_kwargs={"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": 3072})
    training_loop(str(tmp_path), total_ndata=3072, **kw)
    snaps = sorted(d for d in os.listdir(tmp_path) if d.startswith("network-snapshot-"))
    assert any("-0000002-" in s for s in snaps), snaps
    assert any("-0000003-" in s for s in snaps), snaps


def test_train_cli_config_matches_jax_and_runs(tiny_h5, tmp_path, monkeypatch):
    """``python -m climate2weather_tpu_torch.train`` on the tiny h5: its
    config.yaml equals the JAX CLI's for the same flags (read by PyYAML), its
    opts.yaml holds the same options plus ``device``, and a few steps run
    with a falling loss in metrics.jsonl and a resume."""
    import json

    import yaml
    from click.testing import CliRunner

    import train as jax_train
    from climate2weather_tpu_torch import train as port_train

    path, _ = tiny_h5
    argv = ["--run-dir", str(tmp_path / "runs"), "--run-id", "r", "--train-data", path,
            "--spatial-res", "16", "--num-features", "2", "--markov-order", "1",
            "--model-config", "configs/tiny_unet.yml", "--lr", "1e-3", "--total-ndata", "1Ki",
            "--batch", "128", "--batch-gpu", "64", "--status", "256", "--snapshot", "1Ki",
            "--checkpoint", "1Ki", "--logging", "256", "--valid", "0", "--seed", "1",
            "--devices", "8"]
    jax_dir = tmp_path / "jax"
    monkeypatch.setattr("climate2weather_tpu.training.loop.training_loop", lambda *a, **k: None)
    res = CliRunner().invoke(jax_train.main, [a if a != str(tmp_path / "runs") else str(jax_dir)
                                              for a in argv])
    assert res.exit_code == 0, res.output
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port_train.main(argv + ["--device", "cpu"])
    run = tmp_path / "runs" / "r"
    want_cfg = yaml.safe_load((jax_dir / "r" / "config.yaml").read_text())
    got_cfg = yaml.safe_load((run / "config.yaml").read_text())
    want_cfg.pop("run_dir"), got_cfg.pop("run_dir")
    assert got_cfg == want_cfg
    want_opts = yaml.safe_load((jax_dir / "r" / "opts.yaml").read_text())
    got_opts = yaml.safe_load((run / "opts.yaml").read_text())
    assert got_opts.pop("device") == "cpu"
    want_opts.pop("run_dir"), got_opts.pop("run_dir")
    assert got_opts == want_opts
    losses = [json.loads(line)["train/loss"] for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert (run / "network-snapshot-0000001-0.999900" / "params.msgpack").exists()
    port_train.main([a if a != "1Ki" or i != argv.index("--total-ndata") + 1 else "2Ki"
                     for i, a in enumerate(argv)] + ["--device", "cpu"])
    assert (run / "training-state-0000002.ckpt").exists()


def test_value_histogram_image_draws_the_finite_counts():
    """The validation histogram: one bar per bin, its height the bin's count
    over the largest count; non-finite values are left out of the bars."""
    from climate2weather_tpu_torch.utils.logging import value_histogram_image

    values = np.array([0.0, 0.1, 0.1, 0.9, 1.0, 1.0, 1.0, 1.0, np.nan, np.inf], np.float32)
    img = value_histogram_image(values, bins=2, height=8, width=3)
    assert img.shape == (8, 6)
    heights = img.sum(axis=0)
    # bins [0, 0.5) and [0.5, 1.0]: 3 and 5 finite values
    np.testing.assert_array_equal(heights, [5, 5, 5, 8, 8, 8])
    assert not value_histogram_image(np.full(4, np.nan)).any()
