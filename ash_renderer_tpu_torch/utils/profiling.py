"""``utils.profiling``: the port's top-level ``profiling`` module under the
reference's path (the same module object, so its names and state are
shared)."""

import sys

from .. import profiling

sys.modules[__name__] = profiling
