from . import (camera, fast, interp, linalg_small, lk, lk_block, lk_cell, lk_dense,
               lk_v1, lk_v2, match, orb, orb_pattern, patch, pnp, pyramid, roll, se3,
               select, stereo_sweep, triangulate)  # noqa: F401
from . import library  # noqa: E402,F401  (registers the svo custom ops)
