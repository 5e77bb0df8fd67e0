from . import bridge, config, synthetic, trajectory  # noqa: F401
