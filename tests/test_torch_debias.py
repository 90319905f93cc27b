"""climate2weather_tpu_torch.data.debias against the JAX package's
data/debias.py (to 1e-6 relative, on seeded inputs with a bias, a scale
error and values beyond the fitted range), and the three properties of
tests/test_debias.py on the port's functions."""

import numpy as np
import pytest

from climate2weather_tpu.data import debias as jdebias
from climate2weather_tpu.data.grid import GridDataset as JGrid
from climate2weather_tpu_torch.data.debias import apply_quantile_mapping, debias, fit_quantile_mapping
from climate2weather_tpu_torch.data.grid import GridDataset


def mk(data, vars_=("tas",), grid=GridDataset):
    t = data.shape[0]
    return grid({v: data.astype(np.float32) for v in vars_},
                {"time": np.datetime64("2014-01-01", "ns") + np.arange(t) * np.timedelta64(1, "h"),
                 "rlat": np.arange(data.shape[1], dtype=float), "rlon": np.arange(data.shape[2], dtype=float)})


@pytest.mark.parametrize("n_quantiles", [199, 19])
@pytest.mark.parametrize("with_target", [False, True])
def test_debias_matches_jax(n_quantiles, with_target):
    rng = np.random.default_rng(0)
    names = ("psl", "tas", "uas")
    ref = rng.standard_normal((60, 6, 7)) * 3 + 280
    model = ref * 1.3 + 4 + rng.standard_normal(ref.shape)
    target = model[:20] + rng.standard_normal((20, 6, 7)) * 8  # reaches beyond the fitted range
    got = debias(mk(model, names), mk(ref, names), mk(target, names) if with_target else None, n_quantiles)
    want = jdebias.debias(mk(model, names, JGrid), mk(ref, names, JGrid),
                          mk(target, names, JGrid) if with_target else None, n_quantiles)
    for v in names:
        g, w = got.data_vars[v], want.data_vars[v]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    if with_target:
        assert got.data_vars["tas"].min() < mk(ref, names).data_vars["tas"].min()  # the linear tails


def test_fit_matches_jax_and_refuses_a_missing_variable():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((30, 4, 4)), rng.standard_normal((30, 4, 4)) * 2
    got = fit_quantile_mapping(mk(a), mk(b))
    want = jdebias.fit_quantile_mapping(mk(a, grid=JGrid), mk(b, grid=JGrid))
    for k in ("quantiles", "src", "ref"):
        np.testing.assert_array_equal(got["tas"][k], want["tas"][k])
    with pytest.raises(KeyError, match="psl"):
        fit_quantile_mapping(mk(a, ("psl",)), mk(b))


def test_qm_removes_bias_and_scale_error():
    rng = np.random.RandomState(0)
    ref = mk(rng.randn(200, 8, 8))
    biased = mk(rng.randn(200, 8, 8) * 2.0 + 3.0)  # wrong scale + offset
    v = debias(biased, ref).data_vars["tas"]
    assert abs(v.mean()) < 0.1, v.mean()
    assert abs(v.std() - 1.0) < 0.1, v.std()


def test_qm_identity_on_same_distribution():
    rng = np.random.RandomState(1)
    a = mk(rng.randn(500, 4, 4))
    out = debias(a, mk(rng.randn(500, 4, 4)))
    diff = out.data_vars["tas"] - a.data_vars["tas"]
    assert np.abs(diff).mean() < 0.15


def test_qm_monotone_and_tail_extension():
    rng = np.random.RandomState(2)
    ref = mk(rng.randn(300, 4, 4))
    src = mk(rng.randn(300, 4, 4) * 0.5)
    mapping = fit_quantile_mapping(src, ref)
    out = apply_quantile_mapping(mk(np.full((1, 4, 4), 10.0)), mapping)
    assert np.all(np.isfinite(out.data_vars["tas"]))
    assert out.data_vars["tas"].min() > 2.0  # maps far into the ref tail
    grid = np.linspace(-3, 3, 50)
    mapped = np.interp(grid, mapping["tas"]["src"], mapping["tas"]["ref"])
    assert np.all(np.diff(mapped) >= 0)
