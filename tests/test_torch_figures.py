"""The port's figure modules (``exp/figures.py``, ``plotting_util.py``,
``windpower.py``, ``geodata.py``) and the ``figures``, ``animation`` and
``fidelity`` commands against the JAX package's.

- The numpy helpers (the turbine model, the vendored polylines, the
  rotated-pole and Mollweide projections, the overlay and sandwich
  composites) equal JAX's exactly.
- The port's Gaussian KDE equals ``scipy.stats.gaussian_kde`` and JAX's
  ``_kde`` at rtol 1e-10 in float64 (subsampled and degenerate cases too).
- Every figure kind is drawn on the CPU from one experiment directory by
  both packages' ``make``; each ``Figure`` is captured at ``savefig`` and
  compared by its artists: every line's data, image's array, collection's
  offsets, arrays and paths, patch's vertices, and the titles, labels,
  legends and scales, at rtol 1e-6.
- ``animation`` writes a GIF with the frame count and first frame of JAX's.
- ``fidelity.run`` with figures on a tiny config on the CPU writes the
  seven kinds beside the metrics.
"""

import os
import pathlib
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import scipy.stats

matplotlib.use("Agg")
import matplotlib.figure  # noqa: E402

from _torch_parity import jax_net_and_params, tiny_config, write_snapshot  # noqa: E402
from climate2weather_tpu.exp import exputil as jax_exputil  # noqa: E402
from climate2weather_tpu.exp import figures as jax_figures  # noqa: E402
from climate2weather_tpu.exp import geodata as jax_geodata  # noqa: E402
from climate2weather_tpu.exp import plotting_util as jax_pu  # noqa: E402
from climate2weather_tpu.exp import windpower as jax_wp  # noqa: E402
from climate2weather_tpu_torch import experiment  # noqa: E402
from climate2weather_tpu_torch.data.grid import GridDataset  # noqa: E402
from climate2weather_tpu_torch.data.processing import compute_quantiles  # noqa: E402
from climate2weather_tpu_torch.exp import exputil, fidelity, figures, geodata, windpower  # noqa: E402
from climate2weather_tpu_torch.exp import plotting_util as pu  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
VARS = ("psl", "tas", "uas", "vas")
PHYSICAL = {"psl": (101000.0, 800.0), "tas": (285.0, 5.0), "uas": (0.0, 6.0), "vas": (0.0, 6.0)}
RTOL = 1e-6


def _grid(rng, hours, hw, start="2014-04-07T04", step=1, rlat=(-2.0, 2.0), rlon=(-3.0, 3.0)):
    time = np.datetime64(start, "ns") + np.arange(hours) * np.timedelta64(step, "h")
    walk = np.cumsum(rng.standard_normal((hours, hw, hw, len(VARS))), axis=0) / 2
    return GridDataset({v: (off + sc * walk[..., i] / np.sqrt(hours)).astype(np.float32)
                        for i, (v, (off, sc)) in enumerate(PHYSICAL.items())},
                       {"time": time, "rlat": np.linspace(*rlat, hw), "rlon": np.linspace(*rlon, hw)}, {})


def write_experiment(root: pathlib.Path, seed: int, samples=3, hours=13, hw=32) -> pathlib.Path:
    """An experiment directory as ``predict`` writes it: ``ground_truth.nc``,
    ``observation.nc`` (16x block means every 6 hours) and ``samples``
    ``gen_sample_NNN.nc``."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    gt = _grid(rng, hours, hw)
    gt.to_file(str(root / "ground_truth.nc"))
    gt.coarsen_mean(16).isel_time(np.arange(0, hours, 6)).to_file(str(root / "observation.nc"))
    for sid in range(samples):
        _grid(rng, hours, hw).to_file(str(root / f"gen_sample_{sid:03d}.nc"))
    return root


@pytest.fixture(scope="module")
def exp_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("figures")
    return write_experiment(tmp / "run_a", seed=0), write_experiment(tmp / "run_b", seed=1)


# -- numpy helpers -----------------------------------------------------------


def test_windpower_equals_jax_exactly():
    rng = np.random.default_rng(0)
    u, v = rng.normal(0, 8, (50, 7)), rng.normal(0, 8, (50, 7))
    for name in ("wind_speed_at_hub", "wind_power"):
        np.testing.assert_array_equal(getattr(windpower, name)(u, v), getattr(jax_wp, name)(u, v))
    p = windpower.wind_power(u, v)
    np.testing.assert_array_equal(windpower.capacity_factor(p), jax_wp.capacity_factor(p))
    for a, b in zip(windpower.E115_3000_CURVE, jax_wp.E115_3000_CURVE):
        np.testing.assert_array_equal(a, b)
    gt = _grid(rng, 5, 8)
    np.testing.assert_array_equal(windpower.windpower_timeseries(gt), jax_wp.windpower_timeseries(gt))


@pytest.mark.parametrize("kind", ["coastlines", "borders", "both"])
@pytest.mark.parametrize("bbox", [None, (2.0, 12.0, 46.0, 55.0), (-2.0, 8.0, 43.0, 50.0)])
def test_geodata_equals_jax_exactly(kind, bbox):
    got, want = geodata.geography_segments(kind, bbox=bbox), jax_geodata.geography_segments(kind, bbox=bbox)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_projections_and_composites_equal_jax_exactly():
    rlon, rlat = np.linspace(-6, 3, 40), np.linspace(-5, 4, 30)
    for a, b in zip(pu.rotated_to_lonlat(rlon, rlat), jax_pu.rotated_to_lonlat(rlon, rlat)):
        np.testing.assert_array_equal(a, b)
    lon, lat = pu.rotated_to_lonlat(rlon, rlat)
    for lon0 in (0.0, 10.0):
        for a, b in zip(pu.mollweide_xy(lon, lat, lon0), jax_pu.mollweide_xy(lon, lat, lon0)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    fine, coarse = rng.standard_normal((32, 24)), rng.standard_normal((4, 3))
    for corner in (True, False):
        np.testing.assert_array_equal(pu.assign_overlapping_values(fine, coarse, corner),
                                      jax_pu.assign_overlapping_values(fine, coarse, corner))
    fields = [rng.standard_normal((8, 9)) for _ in range(3)]
    np.testing.assert_array_equal(pu.sandwich(fields), jax_pu.sandwich(fields))
    for v in VARS + ("other",):
        assert pu.var2name(v) == jax_pu.var2name(v)


# -- the KDE -----------------------------------------------------------------


KDE_CASES = {
    "normal": lambda rng: rng.standard_normal(5000),
    "bimodal": lambda rng: np.concatenate([rng.normal(-3, 0.5, 3000), rng.normal(2, 1.5, 1000)]),
    "float32_field": lambda rng: (285 + 5 * rng.standard_normal((6, 20, 20))).astype(np.float32),
    "subsampled": lambda rng: rng.gamma(2.0, 1.0, 45001),
}


@pytest.mark.parametrize("case", sorted(KDE_CASES))
def test_kde_equals_scipy_and_jax(case):
    rng = np.random.default_rng(2)
    vals = KDE_CASES[case](rng)
    flat = np.asarray(vals, np.float64).ravel()
    grid = np.linspace(flat.min() - 1, flat.max() + 1, 300)
    got = figures._kde(vals, grid)
    np.testing.assert_allclose(got, jax_figures._kde(vals, grid), rtol=1e-10, atol=0)
    if flat.size <= 20000:
        np.testing.assert_allclose(figures.gaussian_kde(flat, grid), scipy.stats.gaussian_kde(flat)(grid),
                                   rtol=1e-10, atol=0)
    sub = flat[:: -(-flat.size // 20000)]
    np.testing.assert_allclose(got, scipy.stats.gaussian_kde(sub)(grid), rtol=1e-10, atol=0)


def test_kde_degenerate_is_a_spike_as_in_jax():
    grid = np.linspace(0, 2, 21)
    got = figures._kde(np.full(100, 1.04), grid)
    np.testing.assert_array_equal(got, jax_figures._kde(np.full(100, 1.04), grid))
    assert got.sum() == 1.0 and got[10] == 1.0


# -- every kind, drawn by both packages --------------------------------------


def _xy(artist):
    return np.asarray(artist.get_xydata(), np.float64)


def _patch(p):
    return np.asarray(p.get_patch_transform().transform(p.get_path().vertices), np.float64)


def _artists(fig) -> list:
    """What a figure shows, axes by axes, in drawing order."""
    out = [("suptitle", fig._suptitle.get_text() if fig._suptitle else None)]
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append(("axes", [ax.get_title(loc) for loc in ("left", "center", "right")], ax.get_xlabel(),
                    ax.get_ylabel(), ax.get_xscale(), ax.get_yscale(),
                    [t.get_text() for t in legend.get_texts()] if legend else None))
        for line in ax.get_lines():
            out.append(("line", _xy(line), line.get_color(), line.get_linestyle(), line.get_marker(),
                        line.get_linewidth(), line.get_alpha(), line.get_label()))
        for im in ax.get_images():
            out.append(("image", np.asarray(im.get_array(), np.float64), im.get_clim(), im.get_cmap().name))
        for c in ax.collections:
            arr = c.get_array()
            coords = c.get_coordinates() if hasattr(c, "get_coordinates") else None
            out.append(("collection", type(c).__name__, np.asarray(c.get_offsets(), np.float64),
                        None if arr is None else np.asarray(arr, np.float64),
                        None if coords is None else np.asarray(coords, np.float64),
                        [np.asarray(p.vertices, np.float64) for p in c.get_paths()] if coords is None else None,
                        c.get_label()))
        for p in ax.patches:
            out.append(("patch", type(p).__name__, _patch(p), p.get_label()))
    return out


def _compare(got, want, where="figure"):
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        if np.ma.isMaskedArray(want) or np.ma.isMaskedArray(got):
            np.testing.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want), err_msg=where)
            got, want = np.ma.filled(got, 0.0), np.ma.filled(want, 0.0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=where)
    else:
        assert got == want, (where, got, want)


@pytest.fixture
def captured(monkeypatch):
    """Every Figure saved, in order."""
    figs = []
    real = matplotlib.figure.Figure.savefig

    def savefig(self, *args, **kwargs):
        figs.append(self)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return figs


ALL_KINDS = sorted(figures.KINDS) + ["downscaled_clim_dist"]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_figure_artists_equal_jax(kind, exp_dirs, captured, tmp_path):
    a, b = exp_dirs
    compare = [str(b)] if kind == "downscaled_clim_dist" else None
    got_path = figures.make(kind, str(a), str(tmp_path / "port"), compare=compare)
    want_path = jax_figures.make(kind, str(a), str(tmp_path / "jax"), compare=compare)
    assert pathlib.Path(got_path).name == pathlib.Path(want_path).name
    assert os.path.getsize(got_path) > 0
    got, want = (_artists(f) for f in captured)
    assert len(got) == len(want)
    _compare(got, want, kind)


def test_kind_data_is_finite_and_shaped(exp_dirs):
    """What the card computes: every kind's arrays, finite, with the shapes
    the drawing takes."""
    samples, gt, obs = exputil.setup(str(exp_dirs[0]))
    data = {k: figures.kind_data(k, samples, gt, obs) for k in figures.KINDS}
    data["downscaled_clim_dist"] = figures.figure_data("downscaled_clim_dist", str(exp_dirs[0]),
                                                       [str(exp_dirs[1])])

    def finite(x):
        if isinstance(x, dict):
            return all(finite(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(finite(v) for v in x)
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            return bool(np.isfinite(x).all())
        return True

    assert all(finite(d) for d in data.values())
    kp = data["kde_and_pmf"]["tas"]
    assert kp["kde_members"].shape == (3, 256) and kp["hist_gt"].shape == (79,)
    assert data["storm_grid"]["samples"].shape == (3, 6, 32, 32) and data["storm_grid"]["obs"].shape == (6, 2, 2)
    assert data["climate_grid"]["samples"].shape == (3, 3, 32, 32)
    assert data["big_grid"]["psl"]["gt"].shape == (8, 32, 32)
    assert data["windpower"]["ens"].shape == (3, 13)
    assert data["calibration"]["tas"]["freq"].shape == (4,)
    assert data["rapsd"]["uas"]["interp_obs"].shape == data["rapsd"]["uas"]["freq"].shape
    assert data["downscaled_clim_dist"]["vas"]["kde"].shape == (2, 256)


def test_unknown_kind_is_refused(exp_dirs):
    with pytest.raises(ValueError, match="Unknown figure kind"):
        figures.make("nope", str(exp_dirs[0]))


def test_figures_command_draws_every_kind(exp_dirs, tmp_path):
    out = tmp_path / "figs"
    for kind in sorted(figures.KINDS):
        assert experiment.main(["figures", kind, str(exp_dirs[0]), "--out-dir", str(out)]) == 0
    experiment.main(["figures", "downscaled_clim_dist", str(exp_dirs[0]), "--out-dir", str(out),
                     "--compare", str(exp_dirs[1])])
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["big_grid.png", "calibration.png", "climate_grid_tas.png", "kde_and_pmf.png", "rapsd.png",
         "storm_grid_uas.png", "timeseries.png", "windpower.png", "windpower_dist.png",
         "downscaled_clim_dist.png"])


def test_figures_without_matplotlib_refuse_and_write_nothing(exp_dirs, tmp_path):
    """With matplotlib unimportable the data still computes and the drawing
    refuses with an error naming matplotlib, before any file is written."""
    code = f"""
import sys
sys.modules["matplotlib"] = None
sys.path.insert(0, {str(REPO)!r})
from climate2weather_tpu_torch import experiment
from climate2weather_tpu_torch.exp import exputil, figures
s, g, o = exputil.setup({str(exp_dirs[0])!r})
print(sorted(figures.kind_data("kde_and_pmf", s, g, o)))
try:
    experiment.main(["figures", "kde_and_pmf", {str(exp_dirs[0])!r}, "--out-dir", {str(tmp_path / "f")!r}])
except ImportError as e:
    print("REFUSED", e)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REFUSED" in proc.stdout and "matplotlib" in proc.stdout.split("REFUSED")[1]
    assert "['psl', 'tas', 'uas', 'vas']" in proc.stdout
    assert not (tmp_path / "f").exists() and not (exp_dirs[0] / "figures").exists()


def test_animation_frames_equal_jax(exp_dirs, tmp_path):
    from PIL import Image

    got = tmp_path / "port.gif"
    experiment.main(["animation", str(exp_dirs[0]), "--var", "uas", "--out-path", str(got), "--max-frames", "5"])
    samples, gt, _ = jax_exputil.setup(str(exp_dirs[0]))
    want = jax_pu.create_animation([gt] + samples[:2], "uas", ["ground truth", "sample 0", "sample 1"],
                                   str(tmp_path / "jax.gif"), fps=6, max_frames=5)
    with Image.open(got) as g, Image.open(want) as w:
        assert g.n_frames == w.n_frames == 5
        np.testing.assert_array_equal(np.asarray(g.convert("RGB")), np.asarray(w.convert("RGB")))
    default = experiment.animation(str(exp_dirs[0]), max_frames=3)
    assert default == os.path.join(str(exp_dirs[0]), "figures", "animation_tas.gif")
    with Image.open(default) as g:
        assert g.n_frames == 3
    os.remove(default)
    os.rmdir(os.path.dirname(default))


def test_fidelity_with_figures_writes_the_seven_kinds(tmp_path):
    """``experiment fidelity`` on the CPU on a tiny snapshot and a 13-hour
    window: the runs, the metrics, FIDELITY.md and the guided run's seven
    figures."""
    cfg = tiny_config(channels=20, window=5)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    ds = _grid(np.random.default_rng(3), 25, 32)
    ds.to_file(str(tmp_path / "data.nc"))
    compute_quantiles(ds).to_file(str(tmp_path / "q.nc"))
    experiment.main(["fidelity", "--snapshot", snap, "--data-nc", str(tmp_path / "data.nc"), "--quantiles",
                     str(tmp_path / "q.nc"), "--out", str(tmp_path / "out"), "--start-time", "2014-04-07-04",
                     "--num-hours", "13", "--num-samples", "2", "--uncond-samples", "2",
                     "--num-sampling-steps", "2", "--device", "cpu"])
    (guided,) = [p for p in (tmp_path / "out" / "guided").iterdir() if p.is_dir()]
    assert sorted(p.name for p in (guided / "figures").iterdir()) == sorted(
        ["kde_and_pmf.png", "rapsd.png", "timeseries.png", "storm_grid_uas.png", "windpower_dist.png",
         "climate_grid_tas.png", "calibration.png"])
    assert (tmp_path / "out" / "FIDELITY.md").exists()
    assert list(fidelity.FIGURE_KINDS) == ["kde_and_pmf", "rapsd", "timeseries", "storm_grid", "windpower_dist",
                                           "climate_grid", "calibration"]
    assert (guided / "metrics" / "run").exists()
