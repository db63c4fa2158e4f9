"""Experiment dataset loaders; port of ``gpquad/utils/loaders.py``.

The reference's per-experiment loaders with the same ``load_*(n_sub,
seed) -> (x, y)`` contract:

  - ERA5 2m temperature (reference era5_experiment/load_era5.py:16-69)
  - OISST SST NetCDF raster (oisst_experiment/load_oisst.py)
  - PRISM GeoTIFF rasters (prism_experiment/load_prism.py)
  - 3D Road Network North Jutland (roads_experiment/load_roads.py)
  - Chicago taxi trips CSV (taxi_experiment/load_taxi.py)
  - OCO-2 satellite CO2 binary pair (co2_experiment/load_co2.py)
  - synthetic GP draws replacing the shipped ``data/gp_samples_*.pt``,
    drawn with the port's samplers on the CUDA device unless the caller
    passes ``device="cpu"``

Dataset files are located via an explicit ``path=`` argument or the
``GPQUAD_DATA_DIR`` environment variable (the ``.pt`` datasets also in the
repository's ``data/``); outputs are plain numpy arrays (convert with
``torch.as_tensor`` at the device boundary).  ``h5py``, ``pandas`` and
``PIL`` are imported by the loaders that need them.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = [
    "data_dir", "load_era5", "load_oisst", "load_oisst_grid",
    "load_prism_dataset", "load_prism", "load_roads", "load_taxi",
    "load_co2", "load_synthetic_gp", "load_usa_temp", "load_world_temp",
    "load_europe_pm25", "load_spatial_transcriptomics",
]


def data_dir() -> Path:
    return Path(os.environ.get("GPQUAD_DATA_DIR", "."))


def _resolve(path, default_name: str) -> Path:
    p = Path(path) if path is not None else data_dir() / default_name
    if not p.exists():
        raise FileNotFoundError(
            f"Dataset not found: {p} (set GPQUAD_DATA_DIR or pass path=)")
    return p


def _subsample(x, y, n_sub, seed):
    if n_sub is not None and n_sub < len(y):
        rng = np.random.default_rng(seed)
        inds = rng.choice(len(y), size=n_sub, replace=False)
        return x[inds], y[inds]
    return x, y


# ---------------------------------------------------------------------------
def load_era5(n_sub=None, seed=0, celsius=True, path=None):
    """ERA5 2m temperature: 721x1440 global raster -> (lon, lat), t2m.

    Parity: era5_experiment/load_era5.py:16-60 (longitude shifted to
    [-180, 180), optional Kelvin -> Celsius).
    """
    import h5py
    p = _resolve(path, "era5.nc")
    with h5py.File(p, "r") as ds:
        t2m = ds["t2m"][:].astype(np.float64)
        lat = ds["latitude"][:].astype(np.float64)
        lon = ds["longitude"][:].astype(np.float64)
    if t2m.ndim == 3:
        t2m = t2m[0]
    lon = np.where(lon > 180, lon - 360, lon)
    LON, LAT = np.meshgrid(lon, lat)
    x = np.column_stack([LON.ravel(), LAT.ravel()])
    y = t2m.ravel()
    if celsius:
        y = y - 273.15
    return _subsample(x, y, n_sub, seed)


# ---------------------------------------------------------------------------
def _oisst_open_variable(path, variable):
    import h5py
    grid_vars = {"sst", "anom", "err", "ice"}
    if variable not in grid_vars:
        raise ValueError(f"Unsupported OISST variable '{variable}'. "
                         f"Expected one of {sorted(grid_vars)}")
    with h5py.File(path, "r") as f:
        lat = np.array(f["lat"], dtype=np.float32)
        lon = np.array(f["lon"], dtype=np.float32)
        raw = np.array(f[variable][0, 0, :, :], dtype=np.int16)
        attrs = dict(f[variable].attrs)
    fill = float(np.asarray(attrs["_FillValue"]).reshape(-1)[0])
    scale = float(np.asarray(attrs.get("scale_factor", 1.0)).reshape(-1)[0])
    offset = float(np.asarray(attrs.get("add_offset", 0.0)).reshape(-1)[0])
    data = raw.astype(np.float32) * scale + offset
    data = np.where(raw == fill, np.nan, data)
    return lon, lat, data


def load_oisst_grid(variable="sst", path=None, lon_range="-180_180"):
    """OISST variable on its native grid (oisst_experiment/load_oisst.py)."""
    p = _resolve(path, "oisst.nc")
    lon, lat, data = _oisst_open_variable(p, variable)
    if lon_range == "-180_180":
        lon_w = ((lon + 180.0) % 360.0) - 180.0
        order = np.argsort(lon_w)
        lon, data = lon_w[order], data[:, order]
    elif lon_range != "0_360":
        raise ValueError("lon_range must be '-180_180' or '0_360'")
    LON, LAT = np.meshgrid(lon, lat)
    return LON, LAT, data


def load_oisst(n_sub=None, seed=0, variable="sst", path=None,
               lon_range="-180_180"):
    """OISST raster flattened to valid (lon, lat) points + values."""
    LON, LAT, data = load_oisst_grid(variable=variable, path=path,
                                     lon_range=lon_range)
    valid = np.isfinite(data)
    x = np.column_stack([LON[valid], LAT[valid]]).astype(np.float64)
    y = data[valid].astype(np.float64)
    return _subsample(x, y, n_sub, seed)


# ---------------------------------------------------------------------------
_MODEL_PIXEL_SCALE_TAG = 33550
_MODEL_TIEPOINT_TAG = 33922
_GDAL_NODATA_TAG = 42113


def load_prism_dataset(dataset, n_sub=None, seed=0):
    """PRISM GeoTIFF directory -> (lon, lat), raster values.

    Parity: prism_experiment/load_prism.py:65-110 (geotransform from
    ModelPixelScale/ModelTiepoint tags, GDAL nodata masking).
    """
    from PIL import Image
    ddir = Path(dataset)
    if not ddir.is_absolute():
        ddir = data_dir() / ddir
    if not ddir.exists():
        raise FileNotFoundError(f"PRISM dataset directory not found: {ddir}")
    tifs = sorted(ddir.glob("*.tif"))
    if not tifs:
        raise FileNotFoundError(f"No .tif file found in {ddir}")
    if len(tifs) > 1:
        raise ValueError(f"Expected one .tif file in {ddir}, found {len(tifs)}")
    img = Image.open(tifs[0])
    data = np.array(img, dtype=np.float32)
    nrows, ncols = data.shape
    pixel_scale = img.tag_v2.get(_MODEL_PIXEL_SCALE_TAG)
    tiepoint = img.tag_v2.get(_MODEL_TIEPOINT_TAG)
    if pixel_scale is None or tiepoint is None:
        raise ValueError(
            "Missing GeoTIFF geotransform tags needed to build coordinates")
    nodata = img.tag_v2.get(_GDAL_NODATA_TAG)
    if isinstance(nodata, bytes):
        nodata = nodata.decode()
    nodata = float(nodata) if nodata is not None else None

    lon = float(tiepoint[3]) + (np.arange(ncols) + 0.5) * float(pixel_scale[0])
    lat = float(tiepoint[4]) - (np.arange(nrows) + 0.5) * float(pixel_scale[1])
    LON, LAT = np.meshgrid(lon, lat)
    valid = np.isfinite(data) if nodata is None else data != nodata
    x = np.column_stack([LON[valid], LAT[valid]]).astype(np.float64)
    y = data[valid].astype(np.float64)
    return _subsample(x, y, n_sub, seed)


def load_prism(n_sub=None, seed=0, dataset="prism_tmean_us_30s_202602"):
    """Default PRISM mean-temperature dataset."""
    return load_prism_dataset(dataset, n_sub=n_sub, seed=seed)


# ---------------------------------------------------------------------------
def load_roads(n_sub=None, seed=0, path=None):
    """3D Road Network (North Jutland): (lon, lat) -> altitude.

    Parity: roads_experiment/load_roads.py:17-49.
    """
    p = _resolve(path, "3D_spatial_network.txt")
    data = np.loadtxt(p, delimiter=",")
    x = np.column_stack([data[:, 1], data[:, 2]])
    return _subsample(x, data[:, 3], n_sub, seed)


# ---------------------------------------------------------------------------
_TAXI_FEATURES = {
    "pickup": ("Pickup Centroid Longitude", "Pickup Centroid Latitude"),
    "dropoff": ("Dropoff Centroid Longitude", "Dropoff Centroid Latitude"),
}
_TAXI_TARGETS = {
    "trip_miles": "Trip Miles",
    "trip_seconds": "Trip Seconds",
    "trip_total": "Trip Total",
    "fare": "Fare",
}


def load_taxi(n_sub=None, seed=0, feature_set="pickup", target="trip_miles",
              path=None):
    """Chicago taxi trips: pickup/dropoff centroid -> trip target.

    Parity: taxi_experiment/load_taxi.py (currency symbols stripped,
    non-finite rows dropped).
    """
    import pandas as pd
    if feature_set not in _TAXI_FEATURES:
        raise ValueError(f"feature_set must be one of {sorted(_TAXI_FEATURES)}")
    if target not in _TAXI_TARGETS:
        raise ValueError(f"target must be one of {sorted(_TAXI_TARGETS)}")
    p = _resolve(path, "taxi_trips.csv")
    df = pd.read_csv(p)
    fcols = _TAXI_FEATURES[feature_set]
    tcol = _TAXI_TARGETS[target]

    def clean(s):
        return pd.to_numeric(
            s.astype(str).str.replace("$", "", regex=False)
            .str.replace(",", "", regex=False), errors="coerce")

    lon = clean(df[fcols[0]])
    lat = clean(df[fcols[1]])
    tv = clean(df[tcol])
    ok = lon.notna() & lat.notna() & tv.notna()
    x = np.column_stack([lon[ok].to_numpy(np.float64),
                         lat[ok].to_numpy(np.float64)])
    y = tv[ok].to_numpy(np.float64)
    return _subsample(x, y, n_sub, seed)


# ---------------------------------------------------------------------------
def load_co2(n_sub=None, seed=0, lonlat=True, path=None):
    """OCO-2 satellite CO2: binary (lat, lon) pair + ppm measurements.

    Parity: co2_experiment/load_co2.py (column-major MATLAB layout:
    all latitudes then all longitudes).
    """
    ddir = Path(path) if path is not None else data_dir() / "co2_data"
    meas_p, xs_p = ddir / "co2_meas.bin", ddir / "co2_xs.bin"
    if not meas_p.exists() or not xs_p.exists():
        raise FileNotFoundError(f"CO2 binaries not found under {ddir}")
    meas = np.fromfile(meas_p, dtype=np.float64)
    n = meas.shape[0]
    xs = np.fromfile(xs_p, dtype=np.float64).reshape(2, n)
    lat, lon = xs[0], xs[1]
    x = np.column_stack([lon, lat] if lonlat else [lat, lon])
    return _subsample(x, meas, n_sub, seed)


# ---------------------------------------------------------------------------
def load_synthetic_gp(n: int = 5000, d: int = 1, lengthscale: float = 0.5,
                      variance: float = 2.0, noise: float = 0.2,
                      seed: int = 0, spectral: bool = True, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic GP draw standing in for the reference's committed
    ``data/gp_samples_{n}_{l}_{var}_{noise}.pt`` files: same generative
    model (SE GP + iid noise on uniform inputs), regenerated on demand.
    ``spectral=True`` uses the O(n M) spectral sampler so n can be large.

    The inputs and the noise come from numpy's generator seeded ``seed``
    (gpquad's draws), the latent draw from the port's sampler on
    ``device`` with a ``torch.Generator`` seeded ``seed``, in float64."""
    import torch
    from ..kernels import SquaredExponential
    from ..models.efgp import resolve_device
    from ..models.sampling import sample_gp_dense, sample_gp_spectral
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, d))
    gen = torch.Generator(device=dev).manual_seed(seed)
    xt = torch.as_tensor(x, device=dev)
    if spectral:
        f = sample_gp_spectral(gen, xt, lengthscale=lengthscale,
                               variance=variance, device=dev)
    else:
        kern = SquaredExponential(lengthscale=lengthscale, variance=variance,
                                  dimension=d)
        f = sample_gp_dense(gen, xt, kern, noise_variance=0.0, device=dev)
    y = f.cpu().numpy() + np.sqrt(noise) * rng.normal(size=n)
    return x, y


# ---------------------------------------------------------------------------
def load_usa_temp(path=None, standardize=True):
    """USA temperature stations: (n, 2) locations + temperatures — the
    REAL dataset behind the reference's committed CG-preconditioning CSV
    (reference benchmark_cg_preconditioning_realdata.py:67-73, which
    min-max scales x to the unit square and standardizes y; same here).

    Reads the reference's ``usa_temp_data.pt`` (torch CPU): looks in
    ``$GPQUAD_DATA_DIR``, then the repository's ``data/``.
    """
    candidates = ([Path(path)] if path is not None else [
        data_dir() / "usa_temp_data.pt",
        Path(__file__).resolve().parents[2] / "data" / "usa_temp_data.pt",
    ])
    p = next((c for c in candidates if c.exists()), None)
    if p is None:
        raise FileNotFoundError(
            f"usa_temp_data.pt not found in {[str(c) for c in candidates]}")
    import torch
    data = torch.load(p, map_location="cpu", weights_only=False)
    x = np.asarray(data["x"], np.float64)
    y = np.asarray(data["y"], np.float64)
    if standardize:
        x = (x - x.min(axis=0)) / (x.max(axis=0) - x.min(axis=0))
        y = (y - y.mean()) / y.std()
    return x, y


def _find(candidates):
    return next((c for c in candidates if c.exists()), None)


def load_world_temp(path=None, standardize=True, n_sub=None, seed=0):
    """Worldwide station temperatures: (n, 2) lat/lon + temp °C, n=12396 —
    the REAL dataset behind the reference's world temperature map demo
    (reference "Weather Data/datapull.ipynb" cell 11 builds
    ``world_temp_data.pt`` = {x: [lat, lon], y: temp_c}; consumed by
    ``simple_temp_map.py``-style plots).  Same normalization contract as
    :func:`load_usa_temp`: x min-max scaled to the unit square, y
    standardized.
    """
    p = _find([Path(path)] if path is not None else [
        data_dir() / "world_temp_data.pt",
        Path(__file__).resolve().parents[2] / "data" / "world_temp_data.pt",
    ])
    if p is None:
        raise FileNotFoundError("world_temp_data.pt not found")
    import torch
    data = torch.load(p, map_location="cpu", weights_only=False)
    x = np.asarray(data["x"], np.float64)
    y = np.asarray(data["y"], np.float64)
    if standardize:
        x = (x - x.min(axis=0)) / (x.max(axis=0) - x.min(axis=0))
        y = (y - y.mean()) / y.std()
    return _subsample(x, y, n_sub, seed)


def load_europe_pm25(path=None, standardize=True, log_target=True,
                     n_sub=None, seed=0):
    """European PM2.5 air-quality readings: (n, 2) lon/lat + PM2.5,
    n=3762 — the REAL dataset the reference's Europe map demo pulls
    (reference "Weather Data/datapull.ipynb" cells 4-6: OpenAQ readings
    filtered to European bounds, saved as ``X_europe.pt``/``y_europe.pt``,
    visualized on a LogNorm scale).  PM2.5 is heavy-tailed, so the target
    defaults to standardized ``log1p(y)`` (the reference plots LogNorm for
    the same reason); pass ``log_target=False`` for raw readings.
    """
    roots = ([Path(path)] if path is not None else [
        data_dir(),
        Path(__file__).resolve().parents[2] / "data",
    ])
    root = next((r for r in roots if (r / "X_europe.pt").exists()
                 and (r / "y_europe.pt").exists()), None)
    if root is None:
        raise FileNotFoundError("X_europe.pt / y_europe.pt not found")
    import torch
    x = np.asarray(torch.load(root / "X_europe.pt", map_location="cpu",
                              weights_only=False), np.float64)
    y = np.asarray(torch.load(root / "y_europe.pt", map_location="cpu",
                              weights_only=False), np.float64)
    keep = y > 0  # a handful of non-physical non-positive readings
    x, y = x[keep], y[keep]
    if log_target:
        y = np.log1p(y)
    if standardize:
        x = (x - x.min(axis=0)) / (x.max(axis=0) - x.min(axis=0))
        y = (y - y.mean()) / y.std()
    return _subsample(x, y, n_sub, seed)


# ---------------------------------------------------------------------------
def load_spatial_transcriptomics(n_sub=None, seed=0, threshold=1e-3,
                                 path=None):
    """Spatial transcriptomics (Slc17a7 expression): (n, 2) spot
    coordinates in [-1, 1]^2 + binary labels ``expression > threshold``
    (~21% positive at the reference's 0.001 cut) — the REAL dataset the
    reference's PG classifier demo runs on (reference
    polyagamma_classification/PG_GP_classification.ipynb cell 3: loads
    ``x.pt`` / ``y_slc17a7.pt``, binarizes at >0.001).

    Returns ``(x, y)`` with y in {0., 1.}.  Looks for ``x.pt`` and
    ``y_slc17a7.pt`` in ``$GPQUAD_DATA_DIR``, then the repository's
    ``data/``.
    """
    roots = ([Path(path)] if path is not None else [
        data_dir(),
        Path(__file__).resolve().parents[2] / "data",
    ])
    root = next((r for r in roots if (r / "x.pt").exists()
                 and (r / "y_slc17a7.pt").exists()), None)
    if root is None:
        raise FileNotFoundError(
            f"x.pt / y_slc17a7.pt not found in {[str(r) for r in roots]}")
    import torch
    x = np.asarray(torch.load(root / "x.pt", map_location="cpu",
                              weights_only=False), np.float64)
    expr = np.asarray(torch.load(root / "y_slc17a7.pt", map_location="cpu",
                                 weights_only=False), np.float64)
    y = (expr > threshold).astype(np.float64)
    return _subsample(x, y, n_sub, seed)
