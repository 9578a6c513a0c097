"""Built-in lint rules. Importing this package registers every rule —
the ``_load_builtins()`` hook in ``repro_torch.lint.core`` imports it
lazily, mirroring how ``repro_torch.core.registry`` loads its compression
methods."""
from . import contracts  # noqa: F401
from . import dtype_drift  # noqa: F401
from . import graph_leak  # noqa: F401
from . import host_sync  # noqa: F401
from . import kernel_abi  # noqa: F401
from . import rebuild  # noqa: F401
