from . import frontend, system  # noqa: F401
