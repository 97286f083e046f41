from . import constants  # noqa: F401
from .naming import term_name  # noqa: F401
from .device import resolve_device  # noqa: F401
