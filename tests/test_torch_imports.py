"""The PyTorch port (and its example ``examples/render_stl_torch.py``)
imports without JAX, Triton or the JAX package, and its config carries the
JAX package's config across."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.config import QuirkConfig as JaxQuirks
from levelsetfortran_tpu.config import REFERENCE_PARITY as JAX_PARITY
from levelsetfortran_tpu_torch.config import (REFERENCE_PARITY,
                                              LevelSetConfig, QuirkConfig)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "triton", "levelsetfortran_tpu"):
    sys.modules[name] = None
import levelsetfortran_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_every_module_imports_without_jax_or_triton():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 40


def test_render_example_imports_without_jax():
    code = ("import importlib.util, sys\n"
            "for name in ('jax', 'jaxlib', 'triton', 'levelsetfortran_tpu'):\n"
            "    sys.modules[name] = None\n"
            "spec = importlib.util.spec_from_file_location(\n"
            "    'ex', 'examples/render_stl_torch.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.split()[-1] == "ok", r.stderr


def test_reference_defaults_round_trip():
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(JaxConfig()))
    assert cfg == LevelSetConfig()
    ours = {f.name for f in dataclasses.fields(LevelSetConfig)} - {"device"}
    assert ours <= {f.name for f in dataclasses.fields(JaxConfig)}
    assert cfg.eps_floor == JaxConfig().eps_floor


def test_reference_parity_maps_dtype_and_quirks():
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(JAX_PARITY))
    assert cfg == REFERENCE_PARITY
    assert cfg.dtype == torch.float64 and cfg.eps_floor == 1e-99
    assert dataclasses.asdict(cfg.quirks) == dataclasses.asdict(
        JAX_PARITY.quirks)


def test_copies_every_field_and_ignores_use_pallas():
    j = JaxConfig(dx=0.07, pad_cells=3, reinit_iters=12, minmax_cfl=0.02,
                  narrow_band="off", nb_refresh_every=4, use_pallas="on",
                  quirks=JaxQuirks(deriv8_y_jp1=True), dtype=jnp.float64)
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(j),
                                               device="cpu")
    assert (cfg.dx, cfg.pad_cells, cfg.reinit_iters, cfg.minmax_cfl,
            cfg.narrow_band, cfg.nb_refresh_every, cfg.device) == (
        0.07, 3, 12, 0.02, "off", 4, "cpu")
    assert cfg.quirks == QuirkConfig(deriv8_y_jp1=True)
    assert cfg.dtype == torch.float64


@pytest.mark.parametrize("field", [
    dict(mesh_shape=(2, 2, 2)), dict(steps_per_exchange=2),
    dict(gather_results=False), dict(overlap=True),
    dict(mesh_shape="auto")])
def test_carries_the_sharding_fields_across(field):
    cfg = LevelSetConfig.from_reference_fields(
        dataclasses.asdict(JaxConfig(**field)))
    (name, value), = field.items()
    assert getattr(cfg, name) == value
    assert cfg == LevelSetConfig(**field)


@pytest.mark.parametrize("field", [
    dict(checkpoint_dir="/nonexistent"), dict(init_mode="reference"),
    dict(metrics_every=5), dict(checkpoint_chunk=7),
    dict(dtype=jnp.bfloat16)])
def test_carries_the_operations_fields_across(field):
    cfg = LevelSetConfig.from_reference_fields(
        dataclasses.asdict(JaxConfig(**field)))
    # a dtype maps by name (jnp.bfloat16 -> torch.bfloat16)
    ours = {k: getattr(torch, jnp.dtype(v).name) if k == "dtype" else v
            for k, v in field.items()}
    (name, value), = ours.items()
    assert getattr(cfg, name) == value
    assert cfg == LevelSetConfig(**ours)


@pytest.mark.parametrize("field", [
    dict(halo_width=2), dict(sign_eps=1e-9)])
def test_raises_on_fields_the_port_lacks(field):
    with pytest.raises(ValueError):
        LevelSetConfig.from_reference_fields(
            dataclasses.asdict(JaxConfig(**field)))


def test_rejects_an_unknown_init_mode():
    with pytest.raises(ValueError):
        LevelSetConfig(init_mode="nearest")
