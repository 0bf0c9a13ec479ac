"""Flat kernel namespace (counterpart of ``arrow_tpu/kernels.py``).

Every op is available here in both eager (``foo``) and pipelined (``foo_op``)
form, plus the ``*_dyn`` aliases of the reference's enum-dispatch functions,
and the extension API of ``ops.kernel`` (``AV``, ``register``, ``dispatch``).
"""

from __future__ import annotations

from .array.array import ArrowArrayBase  # noqa: F401
from .array.boolean import BooleanArray  # noqa: F401
from .array.scalar import Scalar  # noqa: F401
from .errors import OperationNotSupported  # noqa: F401
from .ops.aggregate import *  # noqa: F401,F403
from .ops.arithmetic import *  # noqa: F401,F403
from .ops.broadcast import *  # noqa: F401,F403
from .ops.cast import *  # noqa: F401,F403
from .ops.compare import *  # noqa: F401,F403
from .ops.kernel import AV, dispatch, merged_validity, register, scalar_av, scalar_data  # noqa: F401
from .ops.logical import *  # noqa: F401,F403
from .ops.math_ops import *  # noqa: F401,F403
from .ops.swizzle import *  # noqa: F401,F403
from .ops.trigonometry import *  # noqa: F401,F403
