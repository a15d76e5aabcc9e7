"""Configuration schema for the PyTorch level-set engine.

Same fields, defaults and reference citations as the JAX package's
``levelsetfortran_tpu/config.py``: the single-device and the
domain-decomposed pipelines (``mesh_shape``, ``steps_per_exchange``,
``overlap``, ``gather_results``), both init modes (``init_mode``), the
checkpointed solves (``checkpoint_dir``, ``checkpoint_chunk``) and the
in-loop metrics stream (``metrics_every``).  Dropped: ``mesh_axis_names``
and ``halo_width`` (nothing reads them), the dead ``sign_eps`` literal,
and the TPU-only ``use_pallas`` switch — here the field decides whether a
step runs its CUDA kernel: a float32 field on the card does, a bfloat16 or
float64 field runs the kernels' plain versions on the configured device
(the JAX package's ``pallas_supported``), the card by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}

#: Fields of the JAX config that the port lacks, with the JAX defaults they
#: must hold for a config to carry across (``use_pallas`` is ignored).
_DROPPED_DEFAULTS = {
    "sign_eps": 1e-13,
    "mesh_axis_names": ("x", "y", "z"),
    "halo_width": 4,
}


@dataclasses.dataclass(frozen=True)
class LevelSetConfig:
    """All solver hyper-parameters, mirroring reference literals."""

    # --- grid (reference set3d.f90:140-157) ---
    dx: float = 0.05                    # set3d.f90:140
    pad_cells: int = 10                 # set3d.f90:148 ("dd")
    #: "distance": exact signed-distance init; "reference": the reference's
    #: smeared +-1 nearest-centroid field (set3d.f90:196-268).
    init_mode: str = "distance"
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
    #: float32 (the kernels' type), float64 (reference parity) or bfloat16;
    #: the last two run the kernels' plain versions, on the card as on the CPU
    dtype: torch.dtype = torch.float32
    weno_eps_scale: float = 1e-6        # subs.f90:533
    weno_eps_floor: float = 1e-99       # subs.f90:533 (clamped to dtype tiny)

    # --- execution ---
    #: "auto" (banded solvers), "on" (banded), "off" (dense solvers).
    narrow_band: str = "auto"
    #: Steps between reinit activity-mask refreshes.
    nb_refresh_every: int = 8
    #: Mask-refresh interval of the banded min/max stage.
    minmax_nb_refresh_every: int = 16
    #: The torch device the pipeline runs on, taken as given: "cuda" (the
    #: kernels) or "cpu" (their plain versions); no fallback between them.
    device: str = "cuda"
    #: In-loop {iteration, rms, cells/s} events every N iterations (0 = off;
    #: the reference's per-iteration print, subs.f90:923).
    metrics_every: int = 0

    # --- domain decomposition ---
    #: (mx, my, mz) shards over (x, y, z); "auto": one shard per visible
    #: device (``parallel.mesh.factor3``); None: no decomposition.  There
    #: may be more shards than devices (placed round-robin).
    mesh_shape: Union[None, str, Tuple[int, ...]] = None
    steps_per_exchange: int = 1         # reinit steps per halo exchange (k)
    #: Run the halo exchange beside the interior launch.  Under a mesh it
    #: needs ``narrow_band="off"`` and ``steps_per_exchange=1`` (the
    #: pipeline raises otherwise); the "grid" log event says whether it is
    #: in effect (a block too small for an interior brick box has none).
    overlap: bool = False
    #: Gather the full fields to host numpy in PipelineResult (default).
    #: Under a mesh, False leaves them as lists of device blocks; a run
    #: without a mesh always returns host arrays.
    gather_results: bool = True

    # --- checkpoint/resume (absent in reference; SURVEY.md §5) ---
    #: Run the initial reinit and the min/max flow as chunked, resumable
    #: solves with checkpoints in ``<dir>/reinit`` and ``<dir>/minmax``.
    checkpoint_dir: Optional[str] = None
    checkpoint_chunk: int = 500         # iterations between checkpoints

    quirks: QuirkConfig = dataclasses.field(default_factory=QuirkConfig)

    def __post_init__(self):
        if self.narrow_band not in ("auto", "on", "off"):
            raise ValueError("narrow_band must be 'auto', 'on' or 'off'; "
                             f"got {self.narrow_band!r}")
        if self.init_mode not in ("distance", "reference"):
            raise ValueError("init_mode must be 'distance' or 'reference'; "
                             f"got {self.init_mode!r}")
        if self.init_culling not in ("auto", "off"):
            raise ValueError("init_culling must be 'auto' or 'off'; "
                             f"got {self.init_culling!r}")
        if self.dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be float32, float64 or bfloat16; "
                             f"got {self.dtype}")
        m = self.mesh_shape
        if isinstance(m, list):
            object.__setattr__(self, "mesh_shape", tuple(m))
        elif not (m is None or m == "auto" or (
                isinstance(m, tuple) and len(m) == 3)):
            raise ValueError("mesh_shape must be None, 'auto' or three "
                             f"ints; got {m!r}")

    def replace(self, **kw) -> "LevelSetConfig":
        return dataclasses.replace(self, **kw)

    @property
    def eps_floor(self) -> float:
        """WENO epsilon floor clamped so its square stays normal in dtype:
        float64 keeps ``weno_eps_floor``, float32 and bfloat16 take 1e-18
        (``config.py:170-176`` of the JAX package)."""
        if self.dtype == torch.float64:
            return self.weno_eps_floor
        return 1e-18

    def torch_device(self) -> torch.device:
        """Exactly the device asked for, never another one, in every
        dtype."""
        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the kernels' plain versions")
        return device

    @classmethod
    def from_reference_fields(cls, d: dict, **overrides) -> "LevelSetConfig":
        """Build from ``dataclasses.asdict()`` of the JAX package's config.

        Dtypes map by name (float32, float64, bfloat16); every field the
        slice uses is copied.  A JAX
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
            elif name in _DROPPED_DEFAULTS:
                default = _DROPPED_DEFAULTS[name]
                v = tuple(value) if isinstance(value, list) else value
                if v != default:
                    raise ValueError(
                        f"{name}={value!r} is not ported (the port supports "
                        f"only the default {default!r})")
            elif name in ours:
                kw[name] = value
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
