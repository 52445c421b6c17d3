from .common import accuracy  # noqa: F401
