"""repro_torch — the PyTorch/CUDA port of ``repro``.

It imports ``torch``, ``numpy`` and the standard library, and nothing of
JAX or of the ``repro`` package: the NumPy TALP engine and the configs it
needs are copies (``repro_torch.core``, ``repro_torch.configs``), kept
identical by ``tests/test_torch_core_copy.py``. Module names follow the
JAX package's, so each module's counterpart is found by name.
"""
