from . import (camera, fast, linalg_small, lk, lk_dense, patch, pnp, pyramid,
               se3, select, stereo_sweep, triangulate)  # noqa: F401
