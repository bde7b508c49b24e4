from .functional import *  # noqa: F401,F403
from .functional import __all__  # noqa: F401
