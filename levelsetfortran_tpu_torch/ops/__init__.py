"""Grid operators, the init, and the CUDA kernel wrappers; the JAX
package's ``ops`` names under the same names."""

from .band import narrow_band
from .derivs import first_derivative, laplacian, second_derivative
from .init_sign import (initialize_sign_field, nearest_centroid,
                        nearest_triangle, orientation_sign,
                        point_triangle_closest, signed_distance_init)
from .interp import sample_surface, trilinear
from .minmax import mean_curvature, minmax_rhs, seven_point_average
from .sign import hard_sign, smeared_sign
from .stencil import boundary_extrapolate, interior_mask, shift
from .weno import godunov_select, weno_derivatives, weno_godunov
