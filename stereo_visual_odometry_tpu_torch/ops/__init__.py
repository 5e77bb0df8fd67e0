from . import (camera, fast, interp, linalg_small, lk, lk_cell, lk_dense, lk_v1,
               match, orb, orb_pattern, patch, pnp, pyramid, se3, select,
               stereo_sweep, triangulate)  # noqa: F401
