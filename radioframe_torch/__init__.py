"""radioframe_torch — the PyTorch + CUDA (Hopper) port of the radioframe
receive chain and wideband channelizer.

The JAX package ``radioframe`` stays beside this one as the reference each
module is held against (``tests/test_torch_*.py``). This package imports
``torch`` and never ``jax``, and nothing of ``radioframe`` either: the host
modules it needs (configs, presets, filter design, fixtures, SNR scoring)
are its own copies under ``core/``, ``ops/``, ``io/`` and ``diag/``, held
equal to their originals by ``tests/test_torch_guards.py``.
"""

from radioframe_torch.device import pin_precision

pin_precision()
