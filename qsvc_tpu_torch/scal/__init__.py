from . import extract, info  # noqa: F401
