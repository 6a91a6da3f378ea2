from . import distributed, mesh, transform  # noqa: F401
