"""Configuration schema for the PyTorch level-set engine.

Same fields, defaults and reference citations as the JAX package's
``levelsetfortran_tpu/config.py`` for everything the single-device pipeline
uses.  Dropped: the sharding and checkpoint fields, ``init_mode`` (only the
exact-distance init is ported), the in-loop metrics stream, the dead
``sign_eps`` literal, and the TPU-only ``use_pallas`` switch — here the
tensor's device decides whether a step runs its CUDA kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuirkConfig:
    """Switches replicating reference-as-written behaviors (defaults give the
    corrected math; see the JAX package for the cited lines)."""

    #: ``subs.f90:576``: y-direction WENO eps scaling uses p5 = 0.
    weno_y_p5_zero: bool = False
    #: ``subs.f90:346``: order-8 first derivative y-stencil uses ``jp1``.
    deriv8_y_jp1: bool = False
    #: ``subs.f90:227,233,239``: order-1 branch adds the neighbor.
    deriv1_plus_sign: bool = False


_DTYPES = {"float32": torch.float32, "float64": torch.float64}

#: Fields of the JAX config that the port lacks, with the JAX defaults they
#: must hold for a config to carry across (``use_pallas`` is ignored).
_DROPPED_DEFAULTS = {
    "init_mode": "distance",
    "metrics_every": 0,
    "sign_eps": 1e-13,
    "mesh_shape": None,
    "mesh_axis_names": ("x", "y", "z"),
    "halo_width": 4,
    "steps_per_exchange": 1,
    "overlap": False,
    "gather_results": True,
    "checkpoint_dir": None,
    "checkpoint_chunk": 500,
}


@dataclasses.dataclass(frozen=True)
class LevelSetConfig:
    """All solver hyper-parameters, mirroring reference literals."""

    # --- grid (reference set3d.f90:140-157) ---
    dx: float = 0.05                    # set3d.f90:140
    pad_cells: int = 10                 # set3d.f90:148 ("dd")
    #: Spatial candidate culling for the distance init ("auto"/"off").
    init_culling: str = "auto"
    #: Grid-points-per-side of a culling block.
    init_cull_block: int = 16

    # --- narrow band radii in units of dx (subs.f90:194,199) ---
    band_radius: float = 4.1
    stencil_band_radius: float = 8.1

    # --- initial reinitialization (set3d.f90:298-305) ---
    reinit_iters: int = 10000
    reinit_cfl: float = 0.1
    reinit_tol: float = 1e-5            # subs.f90:915

    # --- min/max curvature flow (set3d.f90:390-392, 448) ---
    minmax_iters: int = 10000
    minmax_cfl: float = 0.01
    minmax_tol: float = 1e-7
    minmax_threshold: float = 0.0       # subs.f90:471
    minmax_avg_halfwidth: int = 1       # subs.f90:467

    # --- node advection (set3d.f90:489) ---
    advect_iters: int = 1000
    advect_grad_order: int = 8          # set3d.f90:470
    advect_eps: float = 1e-13           # set3d.f90:493

    # --- final reinitialization (set3d.f90:576-580) ---
    final_reinit_iters: int = 2000
    final_reinit_cfl: float = 0.001

    # --- numerics ---
    dtype: torch.dtype = torch.float32  # the kernels' type; f64 for CPU parity
    weno_eps_scale: float = 1e-6        # subs.f90:533
    weno_eps_floor: float = 1e-99       # subs.f90:533 (clamped to dtype tiny)

    # --- execution ---
    #: "auto" (banded solvers), "on" (banded), "off" (dense solvers).
    narrow_band: str = "auto"
    #: Steps between reinit activity-mask refreshes.
    nb_refresh_every: int = 8
    #: Mask-refresh interval of the banded min/max stage.
    minmax_nb_refresh_every: int = 16
    #: "auto": the first CUDA device when there is one, else the CPU.
    device: str = "auto"

    quirks: QuirkConfig = dataclasses.field(default_factory=QuirkConfig)

    def __post_init__(self):
        if self.narrow_band not in ("auto", "on", "off"):
            raise ValueError("narrow_band must be 'auto', 'on' or 'off'; "
                             f"got {self.narrow_band!r}")
        if self.init_culling not in ("auto", "off"):
            raise ValueError("init_culling must be 'auto' or 'off'; "
                             f"got {self.init_culling!r}")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64; "
                             f"got {self.dtype}")

    def replace(self, **kw) -> "LevelSetConfig":
        return dataclasses.replace(self, **kw)

    @property
    def eps_floor(self) -> float:
        """WENO epsilon floor clamped so its square stays normal in dtype."""
        if self.dtype == torch.float64:
            return self.weno_eps_floor
        return 1e-18

    def torch_device(self) -> torch.device:
        if self.device == "auto":
            return torch.device("cuda" if torch.cuda.is_available()
                                else "cpu")
        return torch.device(self.device)

    @classmethod
    def from_reference_fields(cls, d: dict, **overrides) -> "LevelSetConfig":
        """Build from ``dataclasses.asdict()`` of the JAX package's config.

        Dtypes map by name; every field the slice uses is copied.  A JAX
        field the port lacks must hold its JAX default (``use_pallas`` is
        ignored: the tensor's device picks the kernel), else this raises.
        """
        ours = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for name, value in d.items():
            if name == "use_pallas":
                continue
            if name == "dtype":
                dname = np.dtype(value).name
                if dname not in _DTYPES:
                    raise ValueError(f"dtype {dname!r} is not ported")
                kw["dtype"] = _DTYPES[dname]
            elif name == "quirks":
                q = value if isinstance(value, dict) \
                    else dataclasses.asdict(value)
                kw["quirks"] = QuirkConfig(**q)
            elif name in ours:
                kw[name] = value
            elif name in _DROPPED_DEFAULTS:
                default = _DROPPED_DEFAULTS[name]
                v = tuple(value) if isinstance(value, list) else value
                if v != default:
                    raise ValueError(
                        f"{name}={value!r} is not ported (the port supports "
                        f"only the default {default!r})")
            else:
                raise ValueError(f"unknown config field {name!r}")
        kw.update(overrides)
        return cls(**kw)


#: Reference-parity configuration (all quirks on, float64, dense init).
REFERENCE_PARITY = LevelSetConfig(
    dtype=torch.float64,
    init_culling="off",
    quirks=QuirkConfig(weno_y_p5_zero=True, deriv8_y_jp1=True,
                       deriv1_plus_sign=True),
)
