"""One sample's window evaluations split over the ranks of a sample group
(``parallel.mesh.sample_groups``, ``WindowScoreFn(group=...)``) on the CPU,
each rank a real process joined over gloo (``tests/_torch_parallel_child.py``):

- the group layout, G = gcd(num_samples, world) groups of world / G ranks,
  with every rank making every group's process group in order;
- the split forward and VJP on 2 and 3 ranks against JAX's ``WindowScoreFn``
  with its window batch sharded over conftest's 8 CPU devices and without it
  (rtol/atol 2e-4): whole chunks dealt round-robin, chunks cut into ranges
  that span members, and a rank with no windows; where whole chunks are
  dealt the split forward equals the one-process port's bit for bit;
- the same assembly in one process over every rank's share, for more
  shapes and group sizes;
- a split DPM-Solver++(2M) long-path sample (SDE, detached and exact
  guidance) against the one-process run, and a crashed split run resumed
  from the leader's file equal to an unbroken one;
- ``exp.downscaling.run`` of 1 and 3 samples on 2 ranks against JAX's run;
- the planted fault, a rank that sums a copy and keeps its own share while
  still joining the collective: its output leaves JAX's 2e-4, and a split
  run with it stops with the group's disagreement error on every rank.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import close, jax_net_and_params, tiny_config, torch_net
from climate2weather_tpu.diffusion import window as jwindow
from climate2weather_tpu.parallel.mesh import make_mesh, window_sharding
from climate2weather_tpu_torch.diffusion import window
from climate2weather_tpu_torch.parallel import mesh
from test_torch_parallel import _draws, _normed_samples, _predict_config, predict_inputs, spawn  # noqa: F401

HW, C, WINDOW, T = 16, 2, 5, 0.3
# name: (markov order, chunk, members, frames). Over 2 and 3 ranks: 4
# chunks dealt; 2 chunks dealt over 2 ranks, cut into ranges of 16 windows
# (spanning the 2 members) over 3; one chunk of 15 cut into ranges; 2
# windows over 3 ranks, one rank with none
CASES = {"dealt": (2, 4, 1, 19), "members": (2, 8, 2, 13), "one_chunk": (2, None, 3, 9), "few": (2, None, 1, 6)}
# JAX's VJP through an unchunked window batch sharded over more devices
# than it has windows is NaN (the padding's rows reach the gradient), so
# there the VJP is held to JAX's unsharded VJP alone
SHARDED_VJP_NAN = ("one_chunk", "few")


@pytest.fixture(scope="module")
def net_setup(tmp_path_factory):
    """The tiny net (JAX params; the port's copy saved for the ranks), each
    case's trajectory and cotangent, JAX's eps and VJP with the window batch
    sharded over the 8 CPU devices and without, and the ranks' results."""
    work = tmp_path_factory.mktemp("window_split")
    cfg = tiny_config(channels=C * WINDOW, window=WINDOW)
    jnet, params = jax_net_and_params(cfg, hw=HW)
    torch.save(torch_net(cfg, params).state_dict(), work / "net.pt")
    rng = np.random.RandomState(11)
    inputs, want = {}, {}
    eps_fn = jwindow.make_batched_eps_fn(jnet.apply)
    sharded = window_sharding(make_mesh())
    for name, (order, chunk, m, L) in CASES.items():
        x = rng.randn(m, L, HW, HW, C).astype(np.float32)
        co = rng.randn(m, L, HW, HW, C).astype(np.float32)
        inputs[f"{name}/x"], inputs[f"{name}/co"] = x, co
        for tag, ws in (("sharded", sharded), ("plain", None)):
            score = jwindow.WindowScoreFn(eps_fn, params, order, chunk_size=chunk, window_sharding=ws)
            f = jax.jit(lambda xx, s=score: s(xx, jnp.float32(T)))
            outs = [jax.vjp(f, jnp.asarray(xi)) for xi in x]
            want[f"{tag}/{name}/eps"] = np.stack([np.asarray(o) for o, _ in outs])
            want[f"{tag}/{name}/vjp"] = np.stack([np.asarray(pull(jnp.asarray(ci))[0])
                                                  for (_, pull), ci in zip(outs, co)])
    np.savez(work / "window_inputs.npz", **inputs)
    spec = {"network_kwargs": cfg["network_kwargs"], "t": T,
            "cases": {name: [order, chunk] for name, (order, chunk, _, _) in CASES.items()}}
    got = {}
    for tag, world in (("one", None), ("two", 2), ("three", 3), ("fault", 2)):
        spawn("window", work, dict(spec, tag=tag, fault=tag == "fault"), world)
        got[tag] = [dict(np.load(work / f"window-{tag}-{r}.npz")) for r in range(world or 1)]
    return cfg, params, want, got, work


# ---------------------------------------------------------------------------
# the layout


@pytest.mark.parametrize("num_samples,world,groups", [(1, 2, 1), (3, 2, 1), (6, 4, 2), (8, 4, 4), (2, 8, 2),
                                                      (5, 3, 1), (0, 3, 3)])
def test_sample_groups_layout(monkeypatch, num_samples, world, groups):
    """G = gcd(num_samples, world) groups of world / G consecutive ranks;
    where a group holds several ranks, every rank makes every group, in
    order, and keeps its own."""
    import torch.distributed as dist

    size = world // groups
    for r in range(world):
        made = []
        monkeypatch.setattr(mesh, "world_size", lambda: world)
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(ranks) or tuple(ranks))
        got = mesh.sample_groups(num_samples)
        assert (got.count, got.index, got.rank, got.size) == (groups, r // size, r % size, size)
        assert got.leader == (r % size == 0)
        if size > 1:
            assert made == [list(range(g * size, (g + 1) * size)) for g in range(groups)]
            assert got.process_group == tuple(range(r // size * size, (r // size + 1) * size))
        else:
            assert made == [] and got.process_group is None


@pytest.mark.parametrize("n_chunks,N,size,want", [
    (4, 8, 2, [[(0, 0, 8), (2, 0, 8)], [(1, 0, 8), (3, 0, 8)]]),
    (2, 16, 3, [[(0, 0, 5), (1, 0, 5)], [(0, 5, 10), (1, 5, 10)], [(0, 10, 16), (1, 10, 16)]]),
    (1, 2, 3, [[(0, 0, 0)], [(0, 0, 1)], [(0, 1, 2)]]),
    (3, 6, 1, [[(0, 0, 6), (1, 0, 6), (2, 0, 6)]]),
])
def test_work_is_dealt_in_chunks_or_cut_into_ranges(n_chunks, N, size, want):
    for r in range(size):
        group = None if size == 1 else mesh.SampleGroups(rank=r, size=size)
        assert window.WindowScoreFn(None, 2, group=group)._work(n_chunks, N) == want[r]


@pytest.mark.parametrize("a,b,B,want", [
    (0, 8, 8, [(0, 0, 8, 0)]),
    (5, 10, 8, [(0, 5, 8, 0), (1, 0, 2, 3)]),
    (0, 24, 8, [(0, 0, 8, 0), (1, 0, 8, 8), (2, 0, 8, 16)]),
    (3, 3, 8, []),
])
def test_member_pieces(a, b, B, want):
    assert window.member_pieces(a, b, B) == want


# ---------------------------------------------------------------------------
# the split forward and VJP


@pytest.mark.parametrize("world", ["two", "three"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_forward_and_vjp_equal_jax_sharded_and_plain(net_setup, world, name):
    _, _, want, got, _ = net_setup
    assert np.isfinite(want[f"sharded/{name}/vjp"]).all() == (name not in SHARDED_VJP_NAN)
    for res in got[world]:
        for part in ("eps", "vjp"):
            for tag in ("sharded", "plain"):
                if not (part, tag) == ("vjp", "sharded") or name not in SHARDED_VJP_NAN:
                    close(res[f"{name}/{part}"], want[f"{tag}/{name}/{part}"])
    for res in got[world][1:]:  # every rank holds the group's sum
        for k in res:
            np.testing.assert_array_equal(res[k], got[world][0][k], err_msg=k)


@pytest.mark.parametrize("world", ["two", "three"])
def test_whole_chunks_dealt_equal_the_one_process_forward(net_setup, world):
    """Each dealt chunk is the one-process batch, and a sum of one value with
    zeros is exact."""
    _, _, _, got, _ = net_setup
    (one,) = got["one"]
    cases = ["dealt"] + (["members"] if world == "two" else [])
    for res in got[world]:
        for name in cases:
            np.testing.assert_array_equal(res[f"{name}/eps"], one[f"{name}/eps"], err_msg=name)


def test_rank_that_keeps_its_own_share_is_caught(net_setup):
    """Rank 1 sums a copy of its output and keeps its own share, still
    joining the collective: rank 0 gets the whole sum, rank 1 leaves JAX's
    2e-4 in every case."""
    _, _, want, got, _ = net_setup
    good, bad = got["fault"]
    for name in CASES:
        for part in ("eps", "vjp"):
            close(good[f"{name}/{part}"], want[f"plain/{name}/{part}"])
            with pytest.raises(AssertionError):
                close(bad[f"{name}/{part}"], want[f"plain/{name}/{part}"])


class _SumGroup:
    """Rank ``rank`` of ``size`` in one process: keeps what it would sum."""

    def __init__(self, rank, size):
        self.rank, self.size, self.kept = rank, size, []

    def all_reduce(self, tensor):
        self.kept.append(tensor.clone())


@pytest.mark.parametrize("shape,chunk", [((19, 8, 8, 2), 8), ((2, 19, 8, 8, 2), 4), ((3, 13, 8, 8, 2), None),
                                         ((13, 8, 8, 2), 3), ((2, 9, 8, 8, 2), 2)])
@pytest.mark.parametrize("size", [2, 3, 5])
def test_ranks_shares_sum_to_the_one_process_result(shape, chunk, size):
    """Every rank's share of the forward and the VJP, summed, against the
    unsplit pass at 2e-4; bit for bit for the forward where whole chunks are
    dealt (the ranks then evaluate the one-process batches)."""
    cfg = tiny_config(channels=C * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg, hw=8)
    net = torch_net(cfg, params).requires_grad_(False)
    g = torch.Generator().manual_seed(size)
    x, co = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    plain = window.WindowScoreFn(net, 2, chunk_size=chunk)
    with torch.no_grad():
        want = plain(x, T)
    want_vjp = plain.vjp(x, T, co)
    eps, vjp = torch.zeros_like(x), torch.zeros_like(x)
    for r in range(size):
        group = _SumGroup(r, size)
        score = window.WindowScoreFn(net, 2, chunk_size=chunk, group=group)
        with torch.no_grad():
            score(x, T)
        score.vjp(x, T, co)
        eps, vjp = eps + group.kept[0].reshape(shape), vjp + group.kept[1].reshape(shape)
    close(eps, want)
    close(vjp, want_vjp)
    *_, n_chunks = plain._chunks(shape[-4])
    if n_chunks >= size:
        assert torch.equal(eps, want)


# ---------------------------------------------------------------------------
# the long path


L_LONG = 13


@pytest.fixture(scope="module")
def long_setup(net_setup):
    """The long-path inputs of tests/test_torch_long_sampler.py (13 frames,
    windows of 5 in chunks of 4, A with s = 4 and t = 3, frame chunks of 5)."""
    from climate2weather_tpu.diffusion.guidance import SpatioTemporalCoarsening as JaxCoarsening

    cfg, _, _, _, work = net_setup
    rng = np.random.RandomState(0)
    noise = rng.randn(L_LONG, HW, HW, C).astype(np.float32)
    gt = rng.randn(L_LONG, HW, HW, C).astype(np.float32)
    y = np.array(JaxCoarsening(4, 3)(jnp.asarray(gt)))
    np.savez(work / "long_inputs.npz", noise=noise, y=y, std=np.array([0.2, 0.3], np.float32),
             gamma=np.float32(7e-4))
    return {"network_kwargs": cfg["network_kwargs"], "order": WINDOW // 2, "chunk": 4}, work


def _long(work, spec, world):
    spawn("long", work, spec, world)
    tag = spec["tag"]
    meta = [json.loads((work / f"long-{tag}-{r}.json").read_text()) for r in range(world or 1)]
    xs = [np.load(work / f"long-{tag}-{r}.npy") for r in range(world or 1)] if "evaluations" in meta[0] else None
    return meta, xs


@pytest.mark.parametrize("exact", [False, True])
def test_split_long_sample_equals_one_process(long_setup, exact):
    """DPM-Solver++(2M), SDE, 6 steps in calls of 2 and the final denoise,
    3 chunks dealt over 2 ranks: the detached run bit for bit (each forward
    the one-process batch, the draws from one generator on every rank), the
    exact run at 2e-4 of the largest magnitude (the VJP's sums reordered)."""
    spec, work = long_setup
    tag = f"exact{int(exact)}"
    (one_meta,), (one,) = _long(work, dict(spec, exact=exact, tag=f"{tag}-one"), None)
    metas, xs = _long(work, dict(spec, exact=exact, tag=f"{tag}-two"), 2)
    assert np.isfinite(one).all() and not one_meta["nan"]
    for meta, x in zip(metas, xs):
        assert meta["evaluations"] == one_meta["evaluations"] == 7
        if exact:
            np.testing.assert_allclose(x, one, rtol=0, atol=2e-4 * float(np.abs(one).max()))
        else:
            np.testing.assert_array_equal(x, one)
    np.testing.assert_array_equal(xs[1], xs[0])


def test_split_resume_equals_the_unbroken_split_run(long_setup, tmp_path):
    """Both ranks stop in the fourth score evaluation (after the second
    call's file); the resumed run, the file read by the leader alone and
    its state passed to rank 1 (generator included), ends on the unbroken
    split run's bits, and the leader alone wrote the files."""
    spec, work = long_setup
    spec = dict(spec, exact=False, resume_path=str(tmp_path / ".sample_resume_000.npz"))
    want_meta, want = _long(work, dict(spec, tag="unbroken", resume_path=str(tmp_path / "unbroken.npz")), 2)
    crashed, _ = _long(work, dict(spec, tag="crashed", crash_at=5), 2)
    assert [m["crashed"] for m in crashed] == [5, 5]
    assert [m["files"] for m in crashed] == [[["load", 0], ["save", 0], ["save", 0]], []]
    with np.load(spec["resume_path"]) as f:
        assert int(f["step"]) == 4
    resumed, got = _long(work, dict(spec, tag="resumed"), 2)
    assert [m["files"] for m in resumed] == [[["load", 0]], []]  # its one call ends the run
    assert [m["evaluations"] for m in resumed] == [3, 3]  # 2 steps and the final denoise
    for x in got:
        np.testing.assert_array_equal(x, want[0])
    assert not pathlib.Path(spec["resume_path"]).exists()
    assert [m["files"] for m in want_meta] == [[["load", 0], ["save", 0], ["save", 0]], []]


def test_group_that_disagrees_stops_on_every_rank(long_setup):
    """Rank 1 keeping its own share makes the ranks' trajectories part: the
    check after the first call raises on both ranks, before any file."""
    spec, work = long_setup
    metas, _ = _long(work, dict(spec, exact=False, tag="disagree", fault=True), 2)
    for meta in metas:
        assert "disagree on the sampler state after step 2" in meta["error"]


# ---------------------------------------------------------------------------
# predict


@pytest.mark.parametrize("num_samples,batch_size", [(1, 4), (3, 16)])
def test_predict_of_samples_not_a_multiple_of_the_ranks_equals_jax(predict_inputs, tmp_path, monkeypatch,
                                                                   num_samples, batch_size):
    """``exp.downscaling.run`` on 2 ranks, one sample group: 1 sample in 3
    dealt chunks of 4 windows, or 3 samples in groups of 2 (one chunk of 9
    windows a member, cut into ranges across members), against JAX's
    ``run`` on 8 devices (2e-4 of the largest magnitude, at the 16 steps of
    ``test_striped_run_equals_one_process_and_jax``); rank 0 writes every
    file, rank 1 none."""
    from climate2weather_tpu.exp import downscaling as jax_downscaling
    from climate2weather_tpu.models.score_net import build_score_unet

    snap, paths = predict_inputs
    name = f"split{num_samples}"
    config_path, cfg = _predict_config(tmp_path, snap, paths, name, num_samples=num_samples, ensemble_batch=2,
                                       num_sampling_steps=16)
    cfg["batch_size"] = batch_size
    config_path.write_text(yaml.safe_dump(cfg))
    noise, z = _draws(cfg)
    np.savez(tmp_path / "draws.npz", noise=noise, z=z)
    spawn("predict", tmp_path, {"tag": "split", "save_path": str(tmp_path / "ranks"),
                                "config_path": str(config_path)}, 2)
    writes = [json.loads((tmp_path / f"predict-split-{r}.json").read_text()) for r in range(2)]
    assert writes == [["ground_truth.nc", "observation.nc"]
                      + [f"gen_sample_{i:03d}.nc" for i in range(num_samples)], []]
    monkeypatch.setattr(jax_downscaling, "build_score_unet", lambda kw, dtype=None: build_score_unet(
        kw, dtype=jnp.float32, use_pallas_attention=False))
    want_dir = jax_downscaling.run(str(tmp_path / "jax"), str(config_path))
    got = _normed_samples(tmp_path / "ranks" / f"001_{name}", cfg, paths["quantiles"])
    want = _normed_samples(want_dir, cfg, paths["quantiles"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))


def test_predict_whose_ranks_disagree_raises_on_both_before_its_samples(predict_inputs, tmp_path):
    snap, paths = predict_inputs
    config_path, cfg = _predict_config(tmp_path, snap, paths, "disagree", num_samples=1, num_sampling_steps=2)
    noise, z = _draws(cfg)
    np.savez(tmp_path / "draws.npz", noise=noise, z=z)
    spawn("predict", tmp_path, {"tag": "fault", "save_path": str(tmp_path / "ranks"),
                                "config_path": str(config_path), "fault": True}, 2)
    for r in range(2):
        assert "disagree on samples [0]" in (tmp_path / f"predict-fault-{r}.error").read_text()
        writes = json.loads((tmp_path / f"predict-fault-{r}.json").read_text())
        assert not [w for w in writes if w.startswith("gen_sample")]
