"""Program keys of the port (``keys.py``).

The JAX package's ``compilecache/`` also owns the persistent XLA compile
cache, its tracker and the artifact store (ROADMAP.md A8); the port
copies only the stdlib key functions, which the process executor's
think-time precompile dedupes on.
"""

from distributed_machine_learning_tpu_torch.compilecache.keys import (
    NON_STRUCTURAL_KEYS,
    chunked_program_key,
    program_key,
    shape_class_fingerprint,
)

__all__ = ["NON_STRUCTURAL_KEYS", "chunked_program_key", "program_key",
           "shape_class_fingerprint"]
