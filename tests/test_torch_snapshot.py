"""The port's snapshot readers (stdlib msgpack and YAML subset) against flax,
msgpack and PyYAML, and the parameter conversion's checks."""

import pathlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from climate2weather_tpu_torch.io import snapshot as port

REPO = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"
YAML_FILES = sorted(
    str(p.relative_to(REPO))
    for pattern in ("configs/*.yml", "exp/configs/**/*.yml", "docs/**/*.yml", "docs/**/*.yaml",
                    "artifacts/*/config.yaml")
    for p in REPO.glob(pattern)
)


def test_artifact_matches_jax_load_snapshot_leaf_for_leaf():
    from climate2weather_tpu.training.checkpoint import load_snapshot

    want_params, want_cfg = load_snapshot(str(ARTIFACT))
    got_params, got_cfg = port.load_snapshot(str(ARTIFACT))
    assert got_cfg == want_cfg
    want = dict(jax.tree_util.tree_flatten_with_path(want_params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(got_params)[0])
    assert len(got) == len(want) == 228
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_flax_tree_of_each_float_dtype_round_trips():
    rng = np.random.RandomState(0)
    tree = {
        "a": {"kernel": rng.randn(3, 4).astype(np.float16), "bias": rng.randn(4).astype(np.float32)},
        "b": np.asarray(jnp.asarray(rng.randn(2, 2, 3), jnp.bfloat16)),
        "empty": np.zeros((0, 5), np.float32),
    }
    got = port.msgpack_loads(serialization.to_bytes(tree))
    np.testing.assert_array_equal(got["a"]["kernel"], tree["a"]["kernel"])
    np.testing.assert_array_equal(got["a"]["bias"], tree["a"]["bias"])
    np.testing.assert_array_equal(got["b"], np.asarray(tree["b"], np.float32))
    assert got["empty"].shape == (0, 5)


@pytest.mark.parametrize("value", [
    0, 127, 128, -1, -32, -33, 255, 65535, 2**32, -(2**40), 1.5, 2.5e300, True, False, None,
    "x", "é" * 40, "s" * 300, b"\x00\x01", b"z" * 70000, [1, [2, "3"]], list(range(20)),
    {"k": {"n": [None, 1.0]}}, {str(i): i for i in range(20)},
])
def test_msgpack_scalars_and_containers(value):
    assert port.msgpack_loads(msgpack.packb(value, use_bin_type=True)) == value


@pytest.mark.parametrize("blob", [
    msgpack.packb(1) + b"\x00",                          # trailing bytes
    msgpack.packb("abc")[:-1],                           # truncated
    msgpack.packb(msgpack.ExtType(5, b"1234")),          # unknown extension
    serialization.to_bytes({"x": np.zeros(2, np.complex64)}),  # unsupported array dtype
])
def test_msgpack_rejects(blob):
    with pytest.raises(ValueError):
        port.msgpack_loads(blob)


@pytest.mark.parametrize("path", YAML_FILES)
def test_yaml_subset_matches_safe_load_on_repo_file(path):
    text = (REPO / path).read_text()
    assert port.yaml_loads(text) == yaml.safe_load(text)


def test_repo_yaml_files_found():
    assert len(YAML_FILES) >= 20
    assert "exp/configs/000_on-model-eval/s16_t6_spectral.yml" in YAML_FILES


@pytest.mark.parametrize("text", [
    "a: 1e-3", "a: 1.0e-3", "a: .5", "a: 1.", "a: +5", "a: -0", "a: 010", "a: 0x1F",
    "a: 0b101", "a: 1_000", "a: -.inf", "a: .NaN", "a: yes", "a: Off", "a: ~", "a:",
    "a: 2014-04-07-04", "a: 'x''y'", 'a: "q r"', "a: [psl, tas, 1, 2.5, null]", "a: []",
    "1: one", "a: b # note", "a: b#c", "a:\n  - 1\n  - [2, b]\nc: ~", "k:\n- x\n- y\nz: 3",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3", "# only a comment\n", "",
])
def test_yaml_subset_quirks(text):
    got = port.yaml_loads(text)
    want = yaml.safe_load(text)
    if isinstance(want, dict) and isinstance(want.get("a"), float) and want["a"] != want["a"]:
        assert got["a"] != got["a"]  # NaN
    else:
        assert got == want


@pytest.mark.parametrize("text", [
    "a: 2014-04-07", "a: &x 1", "a: *x", "a: !tag 1", "a: {b: 1}", "- a: 1", "a: b: c",
    "a: |\n  x", "a: [1, [2]]", "a: [1,]", "---\na: 1", "a:\n  - - 1", "a: 'x",
    'a: "esc\\n"', "a: 1:30", "a: 1\n   b: 2",
])
def test_yaml_subset_rejects(text):
    with pytest.raises(ValueError):
        port.yaml_loads(text)


def test_convert_rejects_missing_extra_and_misshapen_leaves():
    from _torch_parity import jax_net_and_params, tiny_config
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    net = build_score_unet(cfg["network_kwargs"], dtype=torch.float32)
    load_params(net, params)  # fits

    inner = params["params"]
    missing = {k: v for k, v in inner.items() if k != "map_layer1"}
    with pytest.raises(ValueError, match="missing"):
        load_params(net, missing)
    extra = {**inner, "spare": {"bias": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="extra"):
        load_params(net, extra)
    bad = jax.tree.map(lambda a: a, inner)
    bad["map_layer0"] = {**bad["map_layer0"], "bias": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_params(net, bad)
