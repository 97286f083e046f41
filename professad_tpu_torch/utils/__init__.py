from . import constants  # noqa: F401
from .naming import term_name  # noqa: F401
