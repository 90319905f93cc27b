"""climate2weather_tpu_torch.utils.summary against the JAX package's: the
per-module parameter groups and counts of the tiny and the 72.1M
architectures on the same parameters (carried across by ``convert``), the
printed table line for line, the hook-based tabulation, the memory report,
and the table at the start of training."""

import pathlib

import numpy as np
import pytest
import torch

from _torch_parity import jax_net_and_params, tiny_config
from climate2weather_tpu.utils import summary as jax_summary
from climate2weather_tpu_torch.convert import load_params
from climate2weather_tpu_torch.io.snapshot import load_snapshot
from climate2weather_tpu_torch.models.score_net import build_score_unet
from climate2weather_tpu_torch.training.state import init_train_state, make_optimizer
from climate2weather_tpu_torch.utils import summary

REPO = pathlib.Path(__file__).resolve().parents[1]
SNAPSHOT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"


@pytest.mark.parametrize("attention", [True, False])
def test_tiny_counts_and_table_equal_jax(attention, capsys):
    cfg = tiny_config(channels=20, window=5, attention=attention)
    _, params = jax_net_and_params(cfg, hw=16)
    net = load_params(build_score_unet(cfg["network_kwargs"]), params)
    got, want = summary.param_counts(net), jax_summary.param_counts(params)
    assert got == want and "unet/down0_block0" in got and "map_layer0/kernel" in got
    assert summary.print_module_summary(net, "score_unet") == jax_summary.print_module_summary(params, "score_unet")
    port_out, jax_out = capsys.readouterr().out.split("score_unet parameter summary")[1:]
    assert port_out == jax_out


def test_72m_counts_equal_jax_on_the_snapshot(capsys):
    params, cfg = load_snapshot(str(SNAPSHOT))
    net = load_params(build_score_unet(cfg["network_kwargs"]), params)
    got, want = summary.param_counts(net), jax_summary.param_counts({"params": params})
    assert got == want
    total = summary.print_module_summary(net, "score_unet")
    assert total == sum(p.numel() for p in net.parameters()) == sum(want.values())
    assert 72.0e6 < total < 72.2e6 and f"({total / 1e6:.2f}M)" in capsys.readouterr().out
    # the map layers' kernels and biases, a head, a tail and 3 + 3 blocks a level, 3 + 3 attention blocks
    assert len(got) == 4 + 5 + 5 + 2 * 3 * 5 + 2 * 3


def test_tabulate_lists_every_module_in_call_order():
    cfg = tiny_config(channels=20, window=5)
    net = build_score_unet(cfg["network_kwargs"])
    table = summary.tabulate_module(net, torch.zeros(2, 16, 16, 20), torch.ones(2))
    lines = table.splitlines()
    rows = {line.split()[0]: line.split() for line in lines[2:-2]}
    assert set(rows) == {name or "<root>" for name, _ in net.named_modules()}
    assert lines[-3].split()[:3] == ["<root>", "ScoreUNet", "[2,"]  # the root ends last
    assert rows["unet.down1_attn0.qkv"][2:5] == ["[2,", "64,", "48]"]
    own = {name or "<root>": sum(p.numel() for p in m.parameters(recurse=False)) for name, m in net.named_modules()}
    assert {k: int(r[-1].replace(",", "")) for k, r in rows.items()} == own
    assert lines[-1] == f"total parameters: {sum(p.numel() for p in net.parameters()):,}"


def test_memory_report_counts_every_tensor():
    cfg = tiny_config(channels=20, window=5)
    net = build_score_unet(cfg["network_kwargs"])
    state = init_train_state(net, make_optimizer(net.parameters(), {}), ema_rates=(0.999, 0.9999))
    n = sum(p.numel() for p in net.parameters())
    assert summary.tree_bytes(net) == 4 * n
    (net(torch.zeros(2, 16, 16, 20), torch.ones(2)) ** 2).mean().backward()
    state.optimizer.step()  # AdamW's moments: two fp32 tensors a parameter and a step count each
    rep = summary.training_memory_report(state)
    steps = sum(s["step"].numel() * s["step"].element_size() for s in state.optimizer.state.values())
    np.testing.assert_allclose(rep["params_MB"], 4 * n / 2**20)
    np.testing.assert_allclose(rep["opt_state_MB"], (8 * n + steps) / 2**20)
    np.testing.assert_allclose(rep["emas_MB"], 2 * 4 * n / 2**20)
    np.testing.assert_allclose(rep["total_MB"], rep["params_MB"] + rep["opt_state_MB"] + rep["emas_MB"])
    assert summary.tree_bytes([torch.zeros(3, dtype=torch.bfloat16), {"a": (torch.zeros(2),)}, "x"]) == 14


def test_training_prints_the_table_at_start(tiny_h5, tmp_path, capsys):
    from climate2weather_tpu_torch.training.loop import training_loop

    path, _ = tiny_h5
    kw = dict(
        dataset_kwargs={"train": {"class_name": "cosmo_dataset", "data_path": path, "num_features": 2,
                                  "spatial_res": 16, "cached": True, "window": 3, "flatten": True}},
        network_kwargs={"channels": 6, "embedding_dim": 16, "hidden_channels": [8, 16], "hidden_blocks": [1, 1],
                        "attention_levels": [1]},
        pipeline_kwargs={"class_name": "vp_cosine"}, optimizer_kwargs={"lr": 1e-3},
        lr_kwargs={"func_name": "lr/linear", "ref_lr": 1e-3, "total_ndata": 256},
        batch_size=256, batch_gpu=128, log_ndata=None, status_ndata=None, snapshot_ndata=None,
        checkpoint_ndata=None, valid_ndata=None, seed=0, device="cpu", compute_dtype=torch.float32,
        loader_threads=1)
    state = training_loop(str(tmp_path), total_ndata=256, **kw)
    out = capsys.readouterr().out
    table = out[out.index("score_unet parameter summary"):].splitlines()
    total = sum(p.numel() for p in state.net.parameters())
    groups = summary.param_counts(state.net)
    assert table[2:2 + len(groups)] == [f"{k:<{max(map(len, groups))}}  {groups[k]:>12,}" for k in sorted(groups)]
    assert table[3 + len(groups)].split()[:2] == ["TOTAL", f"{total:,}"]
