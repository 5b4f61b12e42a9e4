"""Device kernels for the hot compute paths, and the choice among them.

``banded_dp`` holds the banded Gotoh DP kernel for the GPU and
``select_banded_dp``, the one backend-keyed choice between it and the
XLA twin (``alignment.batched``).  Models call ``banded_score`` and
``banded_directions``; the kernel's own functions take ``interpret=True``
so the CPU tests can run it.
"""

from .banded_dp import (banded_directions, banded_score,  # noqa: F401
                        select_banded_dp)
