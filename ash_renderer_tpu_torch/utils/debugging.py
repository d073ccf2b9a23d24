"""``utils.debugging``: the port's top-level ``debugging`` module under the
reference's path (the same module object, so its names and state are
shared)."""

import sys

from .. import debugging

sys.modules[__name__] = debugging
