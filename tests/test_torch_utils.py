"""Port parity for the utilities: ``gpquad_torch/utils/profiling.py``,
``utils/checkpoint.py``, ``utils/loaders.py`` and ``gpquad_torch/native.py``
against ``gpquad``'s, on the CPU.

Profiling: the stage names, the scopes a CPU fit opens under ``trace``
(gpquad's ``jax.named_scope`` names), ``StageTimer``'s table.  Checkpoint:
``tests/test_checkpoint.py`` on the port with equal bits, the sidecar's
keys against gpquad's ``save_efgp``, a PG classifier's state.  Loaders:
``tests/test_loaders_synthetic.py``'s six file formats read by both
packages from the same written file, the missing-file errors, and
``load_synthetic_gp`` against gpquad's draws.  Native: the C++ float64
oracles against the port's plain NUFFTs.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.models.model import EFGP as JaxEFGP
from gpquad.models.sampling import sample_gp_spectral as jax_spectral
from gpquad.utils import loaders as jload
from gpquad.utils import profiling as jprof
from gpquad.utils.checkpoint import save_efgp as jax_save_efgp
import gpquad_torch
from gpquad_torch import convert, native
from gpquad_torch.models import sampling
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.utils import checkpoint, loaders, profiling

torch.set_num_threads(1)

PACKAGES = {"gpquad": jload, "gpquad_torch": loaders}


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_stages_match_gpquad():
    assert profiling.STAGES == jprof.STAGES


def test_stage_is_a_null_context_without_a_profiler():
    assert profiling.stage("4_solve_cg") is profiling.stage("nufft_type1")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.stage("nufft_type1"),
                          torch.profiler.record_function)


def test_trace_names_gpquads_scopes(tmp_path):
    """A CPU fit on the CG tier, its mean and its gradient under ``trace``
    emit gpquad's scope names: the exact NUFFT's, the Toeplitz matvec's
    and the PCG's for one and for a batch of right-hand sides."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (300, 2))
    y = np.sin(4 * x[:, 0]) + 0.1 * rng.normal(size=300)
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    with profiling.trace(tmp_path) as log_dir:
        st = gpquad_torch.fit_with_grid(x, y, kern, 0.05, 0.4, 9,
                                        solver="cg", device="cpu")
        gpquad_torch.predict_mean(st, x[:20])
        gpquad_torch.gradient_with_grid(
            x, y, kern, 0.05, 0.4, torch.Generator().manual_seed(0),
            mtot=9, trace_samples=2, solver="cg", device="cpu")
    assert log_dir == tmp_path
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e["name"] for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"nufft_type1", "nufft_type2", "toeplitz_matvec", "4_solve_cg",
            "7_batch_cg_solve"} <= names, names


def test_stage_timer_table_layout():
    """The port's table is gpquad's, row for row, on the same records."""
    records = {"4_solve_cg": [0.5, 0.25], "7_batch_cg_solve": [1.0]}
    ours, theirs = profiling.StageTimer(), jprof.StageTimer()
    with ours.time("fit", sync=torch.zeros(2)):
        pass
    assert list(ours.records) == ["fit"] and len(ours.records["fit"]) == 1
    ours.records, theirs.records = dict(records), dict(records)
    assert ours.table() == theirs.table()


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_arrays(tmp_path):
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3))},
            "z": torch.arange(4) + 1j * torch.arange(4),
            "n": np.arange(3, dtype=np.int32)}
    checkpoint.save_checkpoint(tmp_path / "ck", tree, metadata={"note": "hi"})
    back = checkpoint.restore_checkpoint(tmp_path / "ck", device="cpu")
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["z"].dtype == torch.complex64
    assert torch.equal(back["z"], tree["z"])
    assert torch.equal(back["n"], torch.arange(3, dtype=torch.int32))
    assert back["__metadata__"]["note"] == "hi"
    # a second save without metadata replaces the sidecar
    checkpoint.save_checkpoint(tmp_path / "ck", {"a": torch.zeros(1)})
    again = checkpoint.restore_checkpoint(tmp_path / "ck", device="cpu")
    assert set(again) == {"a"}


def _facade_data():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 1, (80, 1)), rng.normal(size=80)


def test_efgp_resume(tmp_path):
    """tests/test_checkpoint.py:24 on the port: the restored facade has the
    same raw hypers and generator, predicts the same bits (mean and the
    stochastic variance), and trains on."""
    x, y = _facade_data()
    m = gpquad_torch.EFGP(x, y, "SE", sigmasq=0.1, eps=1e-3,
                          estimate_params=False, device="cpu")
    m.optimize_hyperparameters(max_iters=3, trace_samples=2,
                               generator=torch.Generator().manual_seed(0))
    checkpoint.save_efgp(m, tmp_path / "ck")

    m2 = gpquad_torch.EFGP(x, y, "SE", sigmasq=0.5, eps=1e-3,
                           estimate_params=False, device="cpu")
    checkpoint.restore_efgp(m2, tmp_path / "ck")
    assert torch.equal(m.params.raw, m2.params.raw)
    assert torch.equal(m._last_gradient_beta, m2._last_gradient_beta)
    assert m2.training_log["mean_cg_iters"] == m.training_log[
        "mean_cg_iters"]
    mean1, var1 = m.predict(x[:5], hutchinson_probes=16)
    mean2, var2 = m2.predict(x[:5], hutchinson_probes=16)
    assert torch.equal(mean1, mean2) and torch.equal(var1, var2)
    # resumed model continues training without error
    m2.optimize_hyperparameters(max_iters=1, trace_samples=2,
                                generator=torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(m2.params.raw).all())


def test_efgp_sidecar_keys_match_gpquad(tmp_path):
    """The port's sidecar has gpquad's keys for the same facade settings
    (gpquad saves through Orbax; its key becomes the generator's state)."""
    x, y = _facade_data()
    opts = {"cg_tolerance": 1e-5, "mean_cg_preconditioner": True}
    jm = JaxEFGP(jnp.asarray(x), jnp.asarray(y), "SE", sigmasq=0.1,
                 eps=1e-3, opts=opts, estimate_params=False)
    jm.optimize_hyperparameters(max_iters=2, trace_samples=2,
                                key=jax.random.PRNGKey(0))
    jax_save_efgp(jm, tmp_path / "jax")
    m = gpquad_torch.EFGP(x, y, "SE", sigmasq=0.1, eps=1e-3, opts=opts,
                          estimate_params=False, device="cpu")
    m.optimize_hyperparameters(max_iters=2, trace_samples=2)
    checkpoint.save_efgp(m, tmp_path / "torch")
    want = json.loads((tmp_path / "jax" / "gpquad_meta.json").read_text())
    got = json.loads((tmp_path / "torch" / "gpquad_meta.json").read_text())
    assert set(got) == set(want)
    assert got["names"] == want["names"] and got["eps"] == want["eps"]
    assert got["opts"] == want["opts"]
    assert set(got["training_log"]) == set(want["training_log"])
    tree = checkpoint.restore_checkpoint(tmp_path / "torch", device="cpu")
    assert set(tree["generator"]) == {"cpu"}


def test_efgp_restore_rejects_another_generator_kind(tmp_path):
    x, y = _facade_data()
    m = gpquad_torch.EFGP(x, y, "SE", sigmasq=0.1, eps=1e-3,
                          estimate_params=False, device="cpu")
    checkpoint.save_efgp(m, tmp_path / "ck")
    tree = checkpoint.restore_checkpoint(tmp_path / "ck", device="cpu")
    tree["generator"] = {"cuda": torch.zeros(16, dtype=torch.uint8)}
    checkpoint.save_checkpoint(tmp_path / "ck", tree,
                               metadata=tree.pop("__metadata__"))
    with pytest.raises(ValueError, match="cuda generator"):
        checkpoint.restore_efgp(m, tmp_path / "ck")


def test_pg_classifier_state_roundtrip(tmp_path):
    """A fitted PG classifier's state (``convert.pg_state_from_numpy``'s
    arrays) saved and restored predicts the same bits as the fitted
    estimator."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, size=(150, 2))
    y = (3 * X[:, 0] - 2 * X[:, 1] + 0.5 * rng.normal(size=150) > 0
         ).astype(int)
    est = gpquad_torch.PolyagammaGPClassifier(
        device="cpu", max_iter=3, random_state=0, dtype="float64",
        predictive_variance_method="exact").fit(X, y)
    sp = est._spectral_state_
    arrays = dict(X=X, delta=est.delta_, beta_mean=est.beta_mean_,
                  lengthscale=est.lengthscale_, variance=est.variance_,
                  h=float(sp.h), mtot=sp.mtot, hm=est._hm_,
                  kappa=est._kappa_t_.numpy(),
                  posterior_mean=est.posterior_mean_,
                  posterior_var_diag=est.posterior_var_diag_,
                  classes=est.classes_)
    tree = {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}
    checkpoint.save_checkpoint(tmp_path / "pg", tree,
                               metadata={"params": {
                                   k: v for k, v in est.get_params().items()
                                   if k != "device"}})
    back = checkpoint.restore_checkpoint(tmp_path / "pg", device="cpu")
    meta = back.pop("__metadata__")
    got = convert.pg_state_from_numpy(
        {k: v.numpy() for k, v in back.items()}, meta["params"],
        device="cpu")
    xq = rng.uniform(-1, 1, size=(30, 2))
    assert np.array_equal(got.predict_proba(xq), est.predict_proba(xq))
    assert np.array_equal(got.decision_function(xq),
                          est.decision_function(xq))


# ---------------------------------------------------------------------------
# loaders: tests/test_loaders_synthetic.py's files, read by both packages
# ---------------------------------------------------------------------------

def _both(pkg, fn_name, *args, **kw):
    """``fn_name`` of ``pkg``'s loaders and of gpquad's on the same call;
    the port's outputs equal gpquad's."""
    got = getattr(PACKAGES[pkg], fn_name)(*args, **kw)
    want = getattr(jload, fn_name)(*args, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g, w, equal_nan=True)
    return got


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_era5_parses_netcdf_bytes(tmp_path, pkg):
    h5py = pytest.importorskip("h5py")
    lat = np.linspace(90, -90, 7)
    lon = np.arange(0, 360, 30.0) + 15.0     # includes lon > 180
    t2m = 273.15 + np.arange(7 * 12, dtype=np.float64).reshape(1, 7, 12)
    p = tmp_path / "era5.nc"
    with h5py.File(p, "w") as f:
        f["t2m"] = t2m
        f["latitude"] = lat
        f["longitude"] = lon
    x, y = _both(pkg, "load_era5", path=p)
    assert x.shape == (84, 2) and y.shape == (84,)
    assert x[:, 0].min() >= -180 and x[:, 0].max() < 180  # wrapped
    assert np.isclose(y[0], 0.0)                          # Kelvin -> C
    xs, ys = _both(pkg, "load_era5", path=p, n_sub=10, seed=1)
    assert xs.shape == (10, 2)
    xk, yk = _both(pkg, "load_era5", path=p, celsius=False)
    assert np.isclose(yk[0], 273.15)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_oisst_parses_scaled_int16_raster(tmp_path, pkg):
    h5py = pytest.importorskip("h5py")
    lat = np.array([-10.0, 0.0, 10.0], np.float32)
    lon = np.array([10.0, 190.0, 350.0], np.float32)      # wraps to W
    raw = np.array([[[[100, -999, 300],
                      [400, 500, 600],
                      [700, 800, -999]]]], np.int16)
    p = tmp_path / "oisst.nc"
    with h5py.File(p, "w") as f:
        f["lat"] = lat
        f["lon"] = lon
        ds = f.create_dataset("sst", data=raw)
        ds.attrs["_FillValue"] = np.int16(-999)
        ds.attrs["scale_factor"] = np.float32(0.01)
        ds.attrs["add_offset"] = np.float32(0.0)
    LON, LAT, data = _both(pkg, "load_oisst_grid", path=p)
    assert LON.shape == (3, 3)
    assert np.all(np.diff(LON[0]) > 0) and LON[0, 0] < 0  # reordered west
    assert np.isnan(data).sum() == 2                      # fill masked
    x, y = _both(pkg, "load_oisst", path=p)
    assert x.shape == (7, 2) and np.all(np.isfinite(y))
    assert np.isclose(np.nanmax(data), 8.0)               # 800 * 0.01
    mod = PACKAGES[pkg]
    with pytest.raises(ValueError):
        mod.load_oisst(path=p, variable="nope")
    with pytest.raises(ValueError):
        mod.load_oisst(path=p, lon_range="bad")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_prism_parses_geotiff_tags(tmp_path, pkg):
    Image = pytest.importorskip("PIL.Image")
    from PIL import TiffImagePlugin
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    data[0, 0] = -9999.0                                  # nodata pixel
    ddir = tmp_path / "prism_test"
    ddir.mkdir()
    img = Image.fromarray(data, mode="F")
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[33550] = (0.5, 0.25, 0.0)                        # ModelPixelScale
    info[33922] = (0.0, 0.0, 0.0, -120.0, 49.0, 0.0)      # ModelTiepoint
    info[42113] = "-9999"                                 # GDAL nodata
    img.save(ddir / "raster.tif", tiffinfo=info)
    x, y = _both(pkg, "load_prism_dataset", str(ddir))
    assert x.shape == (11, 2) and y.shape == (11,)        # nodata dropped
    assert np.isclose(x[:, 0].min(), -120.0 + 0.5 * 0.5)  # geotransform
    assert np.isclose(x[:, 1].max(), 49.0 - 0.5 * 0.25)
    assert -9999.0 not in y


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_roads_parses_csv(tmp_path, pkg):
    rows = np.column_stack([np.arange(5), np.linspace(9, 10, 5),
                            np.linspace(57, 58, 5), np.arange(5) * 2.0])
    p = tmp_path / "3D_spatial_network.txt"
    np.savetxt(p, rows, delimiter=",")
    x, y = _both(pkg, "load_roads", path=p)
    assert x.shape == (5, 2)
    assert np.allclose(x[:, 0], np.linspace(9, 10, 5))
    assert np.allclose(y, np.arange(5) * 2.0)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_taxi_parses_currency_and_nans(tmp_path, pkg):
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({
        "Pickup Centroid Longitude": [-87.6, -87.7, None, -87.8],
        "Pickup Centroid Latitude": [41.8, 41.9, 41.7, 41.6],
        "Dropoff Centroid Longitude": [-87.5, -87.6, -87.7, -87.8],
        "Dropoff Centroid Latitude": [41.9, 41.8, 41.7, 41.6],
        "Trip Miles": [1.2, 3.4, 5.6, 7.8],
        "Trip Total": ["$10.50", "$2,000.00", "$5.00", "bad"],
    })
    p = tmp_path / "taxi_trips.csv"
    df.to_csv(p, index=False)
    x, y = _both(pkg, "load_taxi", path=p)                # trip_miles
    assert x.shape == (3, 2)                              # NaN row dropped
    x2, y2 = _both(pkg, "load_taxi", path=p, target="trip_total")
    assert y2.tolist() == [10.5, 2000.0]                  # $ and , stripped
    mod = PACKAGES[pkg]
    with pytest.raises(ValueError):
        mod.load_taxi(path=p, feature_set="nope")
    with pytest.raises(ValueError):
        mod.load_taxi(path=p, target="nope")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_co2_parses_matlab_binary_pair(tmp_path, pkg):
    n = 9
    lat = np.linspace(-60, 60, n)
    lon = np.linspace(-150, 150, n)
    meas = 400 + np.arange(n, dtype=np.float64)
    ddir = tmp_path / "co2_data"
    ddir.mkdir()
    meas.tofile(ddir / "co2_meas.bin")
    np.concatenate([lat, lon]).tofile(ddir / "co2_xs.bin")  # column-major
    x, y = _both(pkg, "load_co2", path=ddir)
    assert np.allclose(x[:, 0], lon) and np.allclose(x[:, 1], lat)
    assert np.allclose(y, meas)
    x2, _ = _both(pkg, "load_co2", path=ddir, lonlat=False)
    assert np.allclose(x2[:, 0], lat)
    xs, ys = _both(pkg, "load_co2", path=ddir, n_sub=4, seed=0)
    assert xs.shape == (4, 2)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_missing_files_raise(tmp_path, pkg):
    mod = PACKAGES[pkg]
    with pytest.raises(FileNotFoundError):
        mod.load_era5(path=tmp_path / "nope.nc")
    with pytest.raises(FileNotFoundError):
        mod.load_roads(path=tmp_path / "nope.txt")
    with pytest.raises(FileNotFoundError):
        mod.load_co2(path=tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        mod.load_prism_dataset(str(tmp_path / "no_prism"))
    # the .pt datasets: a file, or a directory holding the pair
    for name, path in (("load_usa_temp", tmp_path / "nope.pt"),
                       ("load_world_temp", tmp_path / "nope.pt"),
                       ("load_europe_pm25", tmp_path),
                       ("load_spatial_transcriptomics", tmp_path)):
        with pytest.raises(FileNotFoundError):
            getattr(mod, name)(path=path)


@pytest.mark.parametrize("spectral,n", [(True, 600), (False, 60)])
def test_load_synthetic_gp(spectral, n):
    """Shapes, the same bits on a second call, the inputs equal to
    gpquad's (numpy's draw), another seed another draw."""
    x, y = loaders.load_synthetic_gp(n=n, d=2, seed=3, spectral=spectral,
                                     device="cpu")
    assert x.shape == (n, 2) and y.shape == (n,) and y.dtype == np.float64
    x2, y2 = loaders.load_synthetic_gp(n=n, d=2, seed=3, spectral=spectral,
                                       device="cpu")
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    xj, _ = jload.load_synthetic_gp(n=n, d=2, seed=3, spectral=spectral)
    assert np.array_equal(x, xj)
    _, y4 = loaders.load_synthetic_gp(n=n, d=2, seed=4, spectral=spectral,
                                      device="cpu")
    assert not np.array_equal(y, y4)
    assert 0.3 < np.std(y) < 3.0


def test_load_synthetic_gp_noise_matches_gpquad(monkeypatch):
    """Given gpquad's latent draw, the port's targets are gpquad's: the
    same inputs and the same numpy noise after them."""
    n, d, seed = 400, 2, 5
    xj, yj = jload.load_synthetic_gp(n=n, d=d, seed=seed)
    fj = np.asarray(jax_spectral(jax.random.PRNGKey(seed), jnp.asarray(xj),
                                 lengthscale=0.5, variance=2.0))

    def gpquad_draw(generator, x, **kw):
        assert np.array_equal(x.numpy(), xj)
        return torch.as_tensor(fj.copy())

    monkeypatch.setattr(sampling, "sample_gp_spectral", gpquad_draw)
    x, y = loaders.load_synthetic_gp(n=n, d=d, seed=seed, device="cpu")
    assert np.array_equal(x, xj) and np.array_equal(y, yj)


# ---------------------------------------------------------------------------
# native: the C++ float64 oracles against the port's plain NUFFTs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_lib():
    if not native.available() and not native.build():
        pytest.skip("native library unavailable and build failed")
    return native


def _nufft_case(n=700, mtot=13, h=0.37, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 2))
    v = rng.normal(size=n) + 1j * rng.normal(size=n)
    f = rng.normal(size=(mtot, mtot)) + 1j * rng.normal(size=(mtot, mtot))
    return x, v, f, h, mtot


def test_direct_nufft1_2d_matches_the_plain_type1(native_lib):
    x, v, _, h, mtot = _nufft_case()
    want = native_lib.direct_nufft1_2d(x, v, h, mtot)
    got = cuda_nufft.nufft1_2d(torch.as_tensor(x), torch.as_tensor(v), h,
                               mtot=mtot).numpy()
    assert got.shape == want.shape == (mtot, mtot)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_direct_nufft2_2d_matches_the_plain_type2(native_lib):
    x, _, f, h, mtot = _nufft_case(seed=1)
    want = native_lib.direct_nufft2_2d(x, f, h, mtot)
    got = cuda_nufft.nufft2_2d(torch.as_tensor(x), torch.as_tensor(f), h,
                               mtot=mtot).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_bin_sort_matches_gpquads_binding(native_lib):
    from gpquad import native as jnative
    x = np.random.default_rng(2).uniform(0, 4, (3000, 2))
    perm, starts = native_lib.bin_sort_2d(x, lo=(0, 0), bin_size=(1, 1),
                                          nbins=(4, 4))
    jperm, jstarts = jnative.bin_sort_2d(x, lo=(0, 0), bin_size=(1, 1),
                                         nbins=(4, 4))
    assert np.array_equal(perm, jperm) and np.array_equal(starts, jstarts)
    assert sorted(perm.tolist()) == list(range(3000))
