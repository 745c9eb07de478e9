"""Host-side native code of the port.

:mod:`.batch_cache`: the minibatch cache with background read-ahead
(``batch_cache.cpp``, bound with ctypes) that the atlas builders take for
``dataloader_cache``.  The library is built with ``g++`` at first use into
``lagomorph_tpu_torch/_build/``; nothing is built at import.
"""
from .batch_cache import NativeBatchCache, build_library, native_available

__all__ = ["NativeBatchCache", "build_library", "native_available"]
