"""The port's importer of the reference's released torch snapshots
(climate2weather_tpu_torch/import_reference_snapshot.py) against the
repository's script (scripts/import_reference_snapshot.py) and against the
reference's own outputs (tests/fixtures/torch_golden_{tiny,prod}.npz, made by
running the reference code), fp32, at rtol/atol 2e-4 (the bar of
tests/test_import_snapshot.py); and the test helper that writes the
reference's pickle format (tests/_reference_pickle.py) against the
committed fixtures."""

import importlib.util
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _reference_pickle
from _torch_parity import close

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
NAMES = ("tiny", "prod")
OUT_NAME = "network-snapshot-0186646-0.999900"

BLOCKED_RUN = r"""
import importlib.abc, runpy, sys

BLOCKED = {"jax", "flax", "yaml", "msgpack", "h5py", "scripts", "climate2weather_tpu"}


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Blocker())
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
sys.argv = [sys.argv[2]] + sys.argv[3:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)
print("LEAKED", leaked)
"""


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("import_reference_snapshot_script",
                                                  REPO / "scripts" / "import_reference_snapshot.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pkl(name):
    return str(FIXTURES / f"torch_snapshot_{name}.pkl")


def _golden_forward(net, name):
    golden = np.load(FIXTURES / f"torch_golden_{name}.npz")
    x = torch.from_numpy(np.transpose(golden["x"], (0, 2, 3, 1)))
    with torch.no_grad():
        out = net(x, torch.from_numpy(golden["t"])).permute(0, 3, 1, 2)
    return out, golden["out"]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape and np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_and_architecture_equal_the_script(script, name):
    """Unpickled tensors, metadata and inferred architecture as the
    script's; the renamed state dict equal, exactly, to the script's flax
    tree carried through ``convert.to_state_dict``."""
    from climate2weather_tpu_torch import import_reference_snapshot as port
    from climate2weather_tpu_torch.convert import to_state_dict

    sd, meta = port.load_reference_snapshot(_pkl(name))
    ssd, smeta = script.load_reference_snapshot(_pkl(name))
    assert meta == smeta and sd.keys() == ssd.keys()
    assert all(sd[k].dtype == np.float32 and np.array_equal(sd[k], ssd[k]) for k in sd)
    arch = port.infer_architecture(sd)
    assert arch == script.infer_architecture(ssd) and arch["norm_ddof"] == 1
    got = port.convert_state_dict(sd, arch)
    want = to_state_dict(script.convert_state_dict(ssd, arch))
    assert got.keys() == want.keys()
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_the_reference_golden(name):
    """The port's net on the imported weights (norm_ddof 1 through the
    block, attention and tail norms) against the reference's own output."""
    from climate2weather_tpu_torch import import_reference_snapshot as port
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    sd, _ = port.load_reference_snapshot(_pkl(name))
    arch = port.infer_architecture(sd)
    net = build_score_unet(arch, dtype=torch.float32)
    net.load_state_dict(port.convert_state_dict(sd, arch), strict=True)
    got, want = _golden_forward(net.eval(), name)
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_import_snapshot_read_by_both_packages(script, name, tmp_path, capsys):
    """The port's snapshot directory and the script's hold the same
    parameter tree and config, through the JAX package's ``load_snapshot``
    and the port's; ``load_net`` on the port's directory meets the golden."""
    from climate2weather_tpu.training.checkpoint import load_snapshot as jax_load
    from climate2weather_tpu_torch import import_reference_snapshot as port
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import load_snapshot

    a = port.import_snapshot(_pkl(name), str(tmp_path / "port" / OUT_NAME))
    b = script.import_snapshot(_pkl(name), str(tmp_path / "script" / OUT_NAME))
    assert a == str(tmp_path / "port" / OUT_NAME) and sorted(os.listdir(a)) == ["config.yaml", "params.msgpack"]
    assert "Converted" in capsys.readouterr().out
    for load in (jax_load, load_snapshot):
        (pa, ca), (pb, cb) = load(a), load(b)
        assert _same_tree(pa, pb) and ca == cb
    assert ca["imported_from"] == f"torch_snapshot_{name}.pkl" and ca["network_kwargs"]["norm_ddof"] == 1
    net, cfg = load_net(a, device="cpu", compute_dtype=torch.float32)
    got, want = _golden_forward(net, name)
    close(got, want)


def test_cli_without_jax_flax_yaml_msgpack(script, tmp_path):
    """``python -m climate2weather_tpu_torch.import_reference_snapshot`` with
    jax, flax, yaml, msgpack, h5py, ``scripts`` and the JAX package
    unimportable; its directory read by the JAX package to the script's
    parameters, and the port's forward from it against the golden."""
    from climate2weather_tpu.training.checkpoint import load_snapshot as jax_load
    from climate2weather_tpu_torch.exp.downscaling import load_net

    out = tmp_path / "cli" / OUT_NAME
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(REPO), "climate2weather_tpu_torch.import_reference_snapshot",
         "--snapshot", _pkl("prod"), "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Converted 0.3M parameters" in proc.stdout and "LEAKED []" in proc.stdout
    want = script.import_snapshot(_pkl("prod"), str(tmp_path / "script" / OUT_NAME))
    (pa, ca), (pb, cb) = jax_load(str(out)), jax_load(want)
    assert _same_tree(pa, pb) and ca == cb
    net, _ = load_net(str(out), device="cpu", compute_dtype=torch.float32)
    got, golden = _golden_forward(net, "prod")
    close(got, golden)


class _System:
    def __init__(self, cmd):
        self.cmd = cmd

    def __reduce__(self):
        return (os.system, (self.cmd,))


def test_non_allow_listed_global_loads_as_a_stub(tmp_path):
    """A pickle that calls ``posix.system`` gets a stub instance: nothing
    runs, and the importer finds no network in it."""
    from climate2weather_tpu_torch import import_reference_snapshot as port

    marker = tmp_path / "ran"
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"dataset_kwargs": {"window": 5}, "ema": _System(f"touch {marker}")}, f)
    assert b"posix" in path.read_bytes() and b"system" in path.read_bytes()
    with open(path, "rb") as f:
        snap = port._SnapshotUnpickler(f).load()
    assert isinstance(snap["ema"], port._Stub) and type(snap["ema"]).__module__ == "posix"
    sd, meta = port.load_reference_snapshot(str(path))
    assert sd == {} and meta["dataset_kwargs"] == {"window": 5}
    assert not marker.exists()


@pytest.mark.parametrize("name", NAMES)
def test_reference_pickle_writer_matches_the_fixture(script, name, tmp_path):
    """The fixture's own weights written back through the helper: the same
    module tree (classes, names, order, attributes, fp16 parameters without
    gradients), and the same state dict and architecture through the
    port's importer and through the script."""
    from climate2weather_tpu_torch import import_reference_snapshot as port

    sd, meta = port.load_reference_snapshot(_pkl(name))
    arch = port.infer_architecture(sd)
    path = tmp_path / f"{name}.pkl"
    nbytes = _reference_pickle.write_reference_pickle(path, port.convert_state_dict(sd, arch), arch,
                                                      meta["dataset_kwargs"], meta["eta"])
    assert nbytes == path.stat().st_size
    assert not any(m in sys.modules for m in ("model", "zuko", "thor", "util"))
    for imp in (port, script):
        sd2, meta2 = imp.load_reference_snapshot(str(path))
        assert meta2 == meta and sd2.keys() == sd.keys()
        assert all(np.array_equal(sd2[k], sd[k]) for k in sd)
        assert imp.infer_architecture(sd2) == arch
    with open(_pkl(name), "rb") as f:
        want = port._SnapshotUnpickler(f).load()
    with open(path, "rb") as f:
        got = port._SnapshotUnpickler(f).load()
    assert list(got) == list(want)
    assert _reference_pickle.module_tree(got["ema"]) == _reference_pickle.module_tree(want["ema"])
    assert type(got["pipeline"]).__module__ == "thor.pipelines" and got["pipeline"].__dict__ == {"eta": meta["eta"]}
    assert dict(got["dataset_kwargs"]) == dict(want["dataset_kwargs"])


def test_imported_snapshot_with_the_fused_tail_through_load_net(tmp_path):
    """An imported snapshot whose config switches ``fused_upsample`` on
    loads unchanged through ``load_net`` and still meets the golden."""
    from climate2weather_tpu_torch import import_reference_snapshot as port
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.models.unet import NearestUpConv2x

    snap = port.import_snapshot(_pkl("prod"), str(tmp_path / OUT_NAME))
    cfg = yaml_load_file(os.path.join(snap, "config.yaml"))
    cfg["network_kwargs"]["fused_upsample"] = True
    yaml_dump_file(cfg, os.path.join(snap, "config.yaml"))
    net, _ = load_net(snap, device="cpu", compute_dtype=torch.float32)
    assert sum(isinstance(m, NearestUpConv2x) for m in net.modules()) == 4
    got, want = _golden_forward(net, "prod")
    close(got, want)
